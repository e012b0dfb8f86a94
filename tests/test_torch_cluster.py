"""The port's cluster serving engine (``repro_torch/serving/cluster.py``)
vs the JAX reference's, on the CPU.

The cluster's control plane carries no tensor values: its front log and
every device-local engine's log, the committed cluster golden traces,
recording and window digests, bisection reports, profiles and SLO rows in
modeled cycles must be EQUAL to the reference's.  Where token values
enter (the SLO digest hashes the generated streams), both sides serve the
same smoke llama3.2-1b weights in fp32 (the port's carried from the
reference), so the greedy streams are equal too.
"""
import hashlib
import math
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.core.replay as ref_rp
import repro.serving as ref_serving
import repro_torch.serving as port_serving
from repro.configs import get_config as ref_get_config
from repro.configs import smoke as ref_smoke
from repro.models import transformer as ref_tf
from repro_torch import goldens
from repro_torch.configs import get_config, smoke
from repro_torch.convert import params_from_reference
from repro_torch.core import CATEGORIES, DataMovementProfiler, FaultPlan
from repro_torch.core import replay as rp
from repro_torch.core import validate_trace
from repro_torch.core.topology import build_topology
from repro_torch.models import transformer as tf
from repro_torch.serving import (ClusterServingEngine, ServingEngine,
                                 poisson_trace)

sys.path.insert(0, str(Path(__file__).resolve().parent))

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "golden"
CLUSTER_GOLDENS = ["cluster_serving_storm", "cluster_open_loop_serving"]
FLAGS = dict(attn_impl="chunked", q_chunk=16, kv_chunk=16,
             compute_dtype="float32")
SLO_KW = dict(max_slots=2, max_len=32, prompt_pad=8, batching="continuous",
              kv_pages=4, kv_page_size=8)


# ---------------------------------------------------------------- goldens
@pytest.mark.parametrize("name", CLUSTER_GOLDENS)
def test_port_regenerates_cluster_golden(name):
    """The cluster storm (2 devices) and the open-loop run (4 ring-routed
    devices, KV paging, a fault plan on the host channel) regenerate the
    committed trace byte for byte."""
    target = goldens.PROGRAMS[name]("cpu")
    live = goldens.trace_lines(target)
    path = GOLDEN / f"{name}.trace"
    assert live == path.read_text().splitlines()
    assert hashlib.sha256(("\n".join(live) + "\n").encode()).hexdigest() == \
        hashlib.sha256(path.read_bytes()).hexdigest()
    assert not target.violations
    assert all(r.done for r in target.requests.values())


def _fold(cycles) -> float:
    s = 0.0
    for c in CATEGORIES:
        s += cycles[c]
    return s


@pytest.mark.parametrize("name", CLUSTER_GOLDENS)
def test_stall_attribution_closes_on_cluster_goldens(name):
    """tests/test_profiler.py's golden-run gate on the cluster programs:
    every channel closes (the left fold in taxonomy order), the export
    validates, and the open-loop run shows its ten request lifecycles
    (queue / prefill / decode tracks).  Its Perfetto bytes are held
    against the reference's in tests/test_torch_profiler.py."""
    prof = DataMovementProfiler(goldens.PROGRAMS[name]("cpu"), label=name)
    assert prof.channels
    for ch in prof.channels:
        assert _fold(ch.breakdown.cycles) == ch.horizon == ch.breakdown.total
        assert ch.residual < 1e-3, ch.name
    trace = prof.to_perfetto()
    assert validate_trace(trace) == []
    if name == "cluster_open_loop_serving":
        assert len(prof.requests) == 10
        assert len(prof.request_rows()) == 11
        cats = {e.get("cat") for e in trace["traceEvents"]}
        assert {"queue", "prefill", "decode"} <= cats


# ------------------------------------------------------ storm replay
def _cluster_factory():
    clu = goldens.cluster_serving_storm("cpu")

    def factory():
        clu.reset(None)
        return clu
    return factory


def test_cluster_storm_record_replay_and_bisect():
    """tests/test_replay.py's cluster storm check on the port: the
    recording is the reference's (digest, ops, log digest, every window
    digest); any window replays bit-identically with the recorded tokens;
    one submission's token budget perturbed is localized to that CSR
    write within ceil(log2(n_ops)) + 2 replays, as the reference's
    bisection localizes it."""
    import test_golden_traces as tgt
    sess = rp.DebugSession(_cluster_factory(), checkpoint_interval=0,
                           label="cluster_serving_storm")
    rec = rp.record_serving_storm(sess, goldens.storm_requests())
    ref = tgt.cluster_serving_storm_run()
    rrec = ref.recording
    assert rec.digest() == rrec.digest() and rec.n_ops == rrec.n_ops
    assert rec.log_digest == rrec.log_digest
    assert goldens.trace_lines(rec.target) == ref.lines
    for lo in range(0, rec.n_ops + 1, 5):
        assert rec.window_digest(lo, rec.n_ops) == \
            rrec.window_digest(lo, rrec.n_ops)
    tokens = {rid: list(r.out_tokens)
              for rid, r in rec.target.requests.items()}
    lo = rec.n_ops - 4
    w = sess.replay(rec, lo, rec.n_ops)
    assert w.lines == rec.window_lines(lo, rec.n_ops)
    assert w.digest() == rec.window_digest(lo, rec.n_ops)
    assert {rid: list(r.out_tokens)
            for rid, r in w.target.requests.items()} == tokens

    def perturbed(side_rp, recording):
        events = list(recording.events)
        k = next(i for i, ev in enumerate(events)
                 if ev.kind == "csr_write" and ev.args[0] == "SUBMIT_MAXNEW")
        events[k] = side_rp.TimelineEvent(
            "csr_write", ("SUBMIT_MAXNEW", events[k].args[1] + 1))
        return k, events

    k, events = perturbed(rp, rec)
    rb = sess.record(events)
    before = rec.replays + rb.replays
    rep = rp.bisect_divergence(sess, rec, sess, rb)
    used = rec.replays + rb.replays - before
    assert rep is not None and rep.op_index == k
    assert used == rep.n_replays <= \
        math.ceil(math.log2(max(2, rec.n_ops))) + 2
    _, revents = perturbed(ref_rp, rrec)
    rrb = ref.session.record(revents)
    rrep = ref_rp.bisect_divergence(ref.session, rrec, ref.session, rrb)
    assert (rrep.op_index, rrep.n_replays, rrep.kind) == \
        (rep.op_index, rep.n_replays, rep.kind)


def test_cluster_open_loop_restores_mid_decode():
    """A checkpointed recording of the open-loop golden program: restoring
    a checkpoint taken with requests in flight and replaying the rest
    regenerates the run's lines, tokens and final state fingerprint."""
    clu = goldens.cluster_open_loop_serving("cpu")

    def factory():
        clu.reset(FaultPlan(seed=goldens.OPEN_LOOP_SEED))
        return clu

    sess = rp.DebugSession(factory, checkpoint_interval=8,
                           label="cluster_open_loop")
    rec = rp.record_open_loop(sess, goldens.open_loop_trace())
    assert goldens.trace_lines(rec.target) == (
        GOLDEN / "cluster_open_loop_serving.trace").read_text().splitlines()
    tokens = {rid: list(r.out_tokens)
              for rid, r in rec.target.requests.items()}
    assert len(tokens) == 10
    mid = None
    for ck in rec.checkpoints:
        if not 0 < ck.op_index < rec.n_ops:
            continue
        t = sess.replay(rec, ck.op_index, ck.op_index).target
        if t._n_active() and any(0 < len(r.out_tokens) < r.max_new_tokens
                                 for r in t.requests.values()):
            mid = ck
            break
    assert mid is not None, "no checkpoint landed mid-decode"
    w = sess.replay(rec, mid.op_index, rec.n_ops)
    assert w.lines == rec.window_lines(mid.op_index, rec.n_ops)
    assert rp.state_fingerprint(w.target.get_state()) == \
        rec.final_fingerprint
    assert {rid: list(r.out_tokens)
            for rid, r in w.target.requests.items()} == tokens


# ----------------------------------------------------------- SLO digests
@pytest.fixture(scope="module")
def models():
    rcfg = ref_smoke(ref_get_config("llama3.2-1b"))
    cfg = smoke(get_config("llama3.2-1b"))
    rparams = ref_tf.init_params(rcfg, jax.random.PRNGKey(0))
    tparams = params_from_reference(jax.tree.map(np.asarray, rparams),
                                    device="cpu")
    return rcfg, cfg, rparams, tparams


def _slo(mod, target, trace):
    mod.run_open_loop(target, trace)
    return mod.SLOReport.from_run(trace, target, label="slo")


@pytest.mark.parametrize("n", [2, 4])
def test_cluster_slo_digests_equal_reference(models, n):
    """tests/test_serving_slo.py's scale check on the port: the SLO digest
    (rows in modeled cycles + token streams), the rows and the combined
    log digest at 2 and 4 devices equal the reference's; the tokens equal
    a single engine's; a rerun after ``reset`` repeats the rows."""
    rcfg, cfg, rparams, tparams = models
    trace = poisson_trace(5, n_requests=8, mean_gap=150.0,
                          prompt_lens=(3, 10), max_new=(1, 4))
    rtrace = ref_serving.poisson_trace(5, n_requests=8, mean_gap=150.0,
                                       prompt_lens=(3, 10), max_new=(1, 4))
    clu = ClusterServingEngine(cfg, tparams, n_devices=n,
                               flags=tf.RunFlags(**FLAGS), device="cpu",
                               **SLO_KW)
    ref = ref_serving.ClusterServingEngine(
        rcfg, rparams, n_devices=n, flags=ref_tf.RunFlags(**FLAGS), **SLO_KW)
    got, want = _slo(port_serving, clu, trace), _slo(ref_serving, ref, rtrace)
    assert got.to_rows() == want.to_rows()
    assert got.digest() == want.digest()
    assert got.deferrals == want.deferrals and got.completed == 8
    assert clu.digest() == ref.digest()
    assert str(clu.fabric_stats()) == str(ref.fabric_stats())
    assert [b.canonical() for b in clu.counter_banks()] == \
        [b.canonical() for b in ref.counter_banks()]
    one = ServingEngine(cfg, tparams, flags=tf.RunFlags(**FLAGS),
                        device="cpu", **SLO_KW)
    assert _slo(port_serving, one, trace).tokens_digest() == \
        got.tokens_digest()
    clu.reset(None)
    assert _slo(port_serving, clu, trace).to_rows() == got.to_rows()


def test_cluster_engines_share_callables_and_params(models):
    _, cfg, _, tparams = models
    clu = ClusterServingEngine(cfg, tparams, n_devices=3,
                               flags=tf.RunFlags(**FLAGS), device="cpu")
    first = clu.engines[0]
    assert all(e.jit_fns == first.jit_fns and e.params is tparams
               for e in clu.engines)
    assert clu.csr.hw_get("NDEV") == 3 and clu.rows == 3 * clu.max_slots


def test_cluster_refusals_and_duplicates_equal_reference(models):
    """The front end's refusals: no devices, a topology of another size,
    an unknown batching mode, and (as the reference) no CUDA device
    unless asked for the CPU; an in-flight duplicate SUBMIT_ID routed to
    another engine is a front-end violation, the same lines as the
    reference's."""
    rcfg, cfg, rparams, tparams = models
    kw = dict(flags=tf.RunFlags(**FLAGS), device="cpu")
    with pytest.raises(ValueError, match="at least one device"):
        ClusterServingEngine(cfg, tparams, n_devices=0, **kw)
    with pytest.raises(ValueError, match="describes"):
        ClusterServingEngine(cfg, tparams, n_devices=2,
                             topology=build_topology("ring", 4), **kw)
    with pytest.raises(ValueError, match="batching"):
        ClusterServingEngine(cfg, tparams, batching="eager", **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ClusterServingEngine(cfg, tparams)
    reqs = [(0, [5, 6, 7], 3), (1, [8, 9], 2), (0, [1, 2, 3, 4], 2)]
    clu = ClusterServingEngine(cfg, tparams, n_devices=2, max_slots=2,
                               max_len=32, prompt_pad=8, **kw)
    ref = ref_serving.ClusterServingEngine(
        rcfg, rparams, n_devices=2, max_slots=2, max_len=32, prompt_pad=8,
        flags=ref_tf.RunFlags(**FLAGS))
    for target in (clu, ref):
        goldens.drive_storm(target, reqs)
    assert clu.violations == ref.violations
    assert any("duplicate SUBMIT_ID 0" in v for v in clu.violations)
    assert clu.log.canonical() == ref.log.canonical()
    assert clu.placement == ref.placement
    assert {rid: r.out_tokens for rid, r in clu.requests.items()} == \
        {rid: r.out_tokens for rid, r in ref.requests.items()}
