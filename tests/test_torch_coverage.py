"""The port's functional-coverage model (``repro_torch/core/coverage.py``)
vs the JAX reference's: the same declared groups and bins, the same drift
guards, the same bucketing, and ``report()`` / ``summary()`` / sparse
counts equal for the same hits.  Coverage carries no tensor values, so
everything here must be equal exactly."""
import pickle
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import repro.core.coverage as ref_cov
import repro_torch.core.coverage as port_cov
from repro_torch.core.fuzz import DEFAULT_RATES
from repro_torch.core.topology import TOPOLOGY_KINDS

torch.set_num_threads(1)


def _both():
    return ref_cov.CoverageModel(), port_cov.CoverageModel()


def _seeded_hits(seed: int, n: int):
    """``n`` (group, bin, count) hits drawn from the declared bins."""
    rng = np.random.default_rng(seed)
    groups = sorted(port_cov.GROUPS)
    out = []
    for _ in range(n):
        g = groups[int(rng.integers(len(groups)))]
        bins = port_cov.GROUPS[g]
        out.append((g, bins[int(rng.integers(len(bins)))],
                    int(rng.integers(1, 5))))
    return out


def test_declared_bins_equal_reference_and_drift_guards():
    assert port_cov.GROUPS == ref_cov.GROUPS
    for name in ("PROTOCOL_BINS", "BURST_BUCKETS", "CONGESTION_BINS",
                 "FAULT_BINS", "FABRIC_BINS", "SERVING_BINS",
                 "ARRIVALS_BINS", "TOPOLOGY_BINS", "HOP_BINS",
                 "CREDIT_BINS"):
        assert getattr(port_cov, name) == getattr(ref_cov, name), name
    cov = port_cov.CoverageModel()
    for g, bins in port_cov.GROUPS.items():
        assert cov.percent(g) == 0.0 and not cov.covered(g)
        assert cov.holes(g) == [f"{g}.{b}" for b in bins]
    cov.hit("protocol", "doorbell_ok")
    assert cov.counts["protocol"]["doorbell_ok"] == 1
    msgs = []
    for model in _both():
        for call in (lambda: model.hit("protocol", "no_such_bin"),
                     lambda: model.hit("no_such_group", "doorbell_ok")):
            with pytest.raises(KeyError) as e:
                call()
            msgs.append(str(e.value))
    assert msgs[:2] == msgs[2:]


def test_bins_pinned_to_fault_taxonomy_and_topologies():
    assert set(port_cov.FAULT_BINS) == set(DEFAULT_RATES)
    assert port_cov.TOPOLOGY_BINS == ("crossbar",) + TOPOLOGY_KINDS


@pytest.mark.parametrize("nbytes,bucket", [
    (1, "le_64B"), (4, "le_64B"), (64, "le_64B"), (65, "le_1KB"),
    (1024, "le_1KB"), (1025, "le_4KB"), (4096, "le_4KB"),
    (4097, "gt_4KB"), (1 << 20, "gt_4KB")])
def test_burst_bucket_boundaries(nbytes, bucket):
    ref, port = _both()
    ref.hit_burst(nbytes)
    port.hit_burst(nbytes)
    assert port.counts == ref.counts
    assert port.counts["burst_size"][bucket] == 1


@pytest.mark.parametrize("stall,bucket", [(0.0, "free"), (-0.0, "free"),
                                          (1e-9, "stalled"),
                                          (12.5, "stalled")])
def test_congestion_and_hop_buckets(stall, bucket):
    ref, port = _both()
    for model in (ref, port):
        model.hit_congestion(stall)
        for hops in range(6):
            model.hit_hops(hops)
    assert port.counts == ref.counts
    assert port.counts["congestion"][bucket] == 1
    assert port.counts["hops"] == {"h0": 1, "h1": 1, "h2": 1, "h3plus": 3}


@pytest.mark.parametrize("seed,n,groups", [
    (0, 0, None), (1, 5, None), (2, 40, None), (3, 400, None),
    (4, 40, ["protocol"]), (5, 60, ["protocol", "fabric", "hops"])])
def test_report_summary_and_holes_equal_reference(seed, n, groups):
    ref, port = _both()
    for g, b, k in _seeded_hits(seed, n):
        ref.hit(g, b, k)
        port.hit(g, b, k)
    assert port.report(groups=groups) == ref.report(groups=groups)
    assert port.summary() == ref.summary()
    assert port.holes() == ref.holes()
    assert port.to_counts() == ref.to_counts()


def test_report_names_every_hole_and_closes():
    cov = port_cov.CoverageModel()
    for b in port_cov.PROTOCOL_BINS:
        if b not in ("poll_timeout", "doorbell_busy"):
            cov.hit("protocol", b)
    rep = cov.report(groups=["protocol"])
    assert "protocol.poll_timeout" in rep and "protocol.doorbell_busy" in rep
    assert "protocol.doorbell_ok" not in rep.split("UNCOVERED")[1]
    cov.hit("protocol", "poll_timeout")
    cov.hit("protocol", "doorbell_busy")
    assert "no uncovered bins" in cov.report(groups=["protocol"])
    assert cov.percent("protocol") == 100.0


def test_counts_roundtrip_merge_and_pickle_like_reference():
    got = []
    for mod in (ref_cov, port_cov):
        a = mod.CoverageModel()
        a.hit("protocol", "w1c_clear", 3)
        a.hit("burst_size", "le_64B", 7)
        counts = a.to_counts()
        b = mod.CoverageModel.from_counts(counts)
        assert b.counts == a.counts
        merged = mod.CoverageModel()
        merged.hit("protocol", "w1c_clear")
        new = merged.merge_counts(counts)
        with pytest.raises(KeyError):
            merged.merge_counts({"protocol": {"bogus": 1}})
        c = pickle.loads(pickle.dumps(a))
        c.hit("protocol", "poll_ok")
        d = mod.CoverageModel()
        d.hit("protocol", "w1c_clear", 2)
        d.merge(c)
        got.append((counts, new, merged.counts, c.counts, d.counts))
    assert got[0] == got[1]
    assert got[1][1] == ["burst_size.le_64B"]


def test_hit_is_thread_safe_under_a_pool():
    """A Python-level ``__getitem__`` that yields the GIL between the load
    and the store of ``counts[g][b] += n`` turns the lost-update race into
    a certain one; the per-model lock keeps the totals exact."""
    class PreemptingDict(dict):
        def __getitem__(self, k):
            v = dict.__getitem__(self, k)
            time.sleep(0)
            return v

    cov = port_cov.CoverageModel()
    cov.counts["protocol"] = PreemptingDict(cov.counts["protocol"])
    n_threads, n_hits = 8, 1_000

    def hammer(_):
        for _ in range(n_hits):
            cov.hit("protocol", "doorbell_ok")
    with ThreadPoolExecutor(max_workers=n_threads) as ex:
        list(ex.map(hammer, range(n_threads)))
    assert cov.counts["protocol"]["doorbell_ok"] == n_threads * n_hits
