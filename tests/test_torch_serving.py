"""The port's prefill / decode (dense, ssm, hybrid) and serving engine vs
the JAX reference, on the CPU.

Parameters come from the reference's ``init_params`` and go to the port
as numpy arrays (``convert.params_from_reference``); caches likewise
(``convert.cache_from_reference``).  Both sides compute in fp32
(``compute_dtype="float32"``), the reference under ``jax.jit``, the port
with ``device="cpu"``, where the scan kernels' wrappers take their plain
versions.  Tolerances: logits and every cache leaf within 1e-4 relative
(max error over max magnitude; fp32 on both sides, sums in other orders).
The serving control plane carries no values: transaction-log digests, CSR
logs and the three SLO row digests of BENCH_serving.json must be equal
byte for byte, and the greedy token streams equal.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke as ref_smoke
from repro.models import transformer as ref_tf
from repro.serving import ServingEngine as RefEngine
from repro_torch._tree import paths
from repro_torch.configs import get_config, smoke
from repro_torch.convert import cache_from_reference, params_from_reference
from repro_torch.kernels.mamba2_scan import kernel as SSD
from repro_torch.kernels.rwkv6_wkv import kernel as WKV
from repro_torch.models import inputs
from repro_torch.models import transformer as tf
from repro_torch.serving import (Request, ServingEngine, SLOReport,
                                 build_trace, run_open_loop)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["rwkv6-7b", "zamba2-2.7b"]
B, S, S0 = 2, 64, 48
FLAGS = dict(attn_impl="chunked", q_chunk=16, kv_chunk=16,
             compute_dtype="float32")


def _rel(got, want) -> float:
    g = got.float().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / max(1e-6, np.abs(w).max()))


def _models(arch, seed=7):
    rcfg, cfg = ref_smoke(ref_get_config(arch)), smoke(get_config(arch))
    rparams = ref_tf.init_params(rcfg, jax.random.PRNGKey(seed))
    tparams = params_from_reference(jax.tree.map(np.asarray, rparams),
                                    device="cpu")
    return rcfg, cfg, rparams, tparams


def _tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS + ["llama3.2-1b"])
def test_prefill_matches_reference(arch):
    """Last-position logits and every cache leaf (same paths, shapes and
    dtypes) within 1e-4 relative of the reference's ``make_prefill_fn``."""
    rcfg, cfg, rp, tp = _models(arch)
    toks = _tokens(cfg)
    want_lg, want_cache = jax.jit(ref_tf.make_prefill_fn(
        rcfg, ref_tf.RunFlags(**FLAGS), None, S))(
            rp, {"tokens": jnp.asarray(toks)})
    before = (WKV.launches, SSD.launches)
    lg, cache = tf.make_prefill_fn(cfg, tf.RunFlags(**FLAGS), None, S)(
        tp, {"tokens": torch.from_numpy(toks)})
    assert (WKV.launches, SSD.launches) == before     # plain versions on CPU
    assert tuple(lg.shape) == (B, tf.padded_vocab(cfg))
    assert _rel(lg, want_lg) < 1e-4
    want = dict(paths(jax.tree.map(np.asarray, want_cache)))
    got = dict(paths(cache))
    assert sorted(got) == sorted(want)
    for p, v in got.items():
        assert tuple(v.shape) == want[p].shape, p
        assert str(v.dtype).replace("torch.", "") == str(want[p].dtype), p
        assert _rel(v, want[p]) < 1e-4, p


@pytest.mark.parametrize("arch", ARCHS + ["llama3.2-1b"])
def test_decode_matches_reference_and_full_prefill(arch):
    """From the reference's prefill cache of the first S0 tokens, the
    port's decode steps give the reference's decode logits (1e-4
    relative); and the port's own prefill + decode reproduces its full
    prefill (tests/test_decode_consistency.py's check, on the port)."""
    rcfg, cfg, rp, tp = _models(arch)
    toks = _tokens(cfg, seed=1)
    rflags, tflags = ref_tf.RunFlags(**FLAGS), tf.RunFlags(**FLAGS)
    ref_prefill = jax.jit(ref_tf.make_prefill_fn(rcfg, rflags, None, S))
    ref_decode = jax.jit(ref_tf.make_decode_fn(rcfg, rflags, None))
    prefill = tf.make_prefill_fn(cfg, tflags, None, S)
    decode = tf.make_decode_fn(cfg, tflags)

    _, rcache = ref_prefill(rp, {"tokens": jnp.asarray(toks[:, :S0])})
    cache = cache_from_reference(jax.tree.map(np.asarray, rcache),
                                 device="cpu")
    _, own = prefill(tp, {"tokens": torch.from_numpy(toks[:, :S0])})
    for t in range(S0, S):
        rlg, rcache = ref_decode(rp, rcache, jnp.asarray(toks[:, t]))
        lg, cache = decode(tp, cache, torch.from_numpy(toks[:, t]))
        olg, own = decode(tp, own, torch.from_numpy(toks[:, t]))
        assert _rel(lg, rlg) < 1e-4, t
    full, _ = prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert _rel(olg, full.numpy()) < 1e-4
    # every leaf of the decoded cache matches the reference's
    want = dict(paths(jax.tree.map(np.asarray, rcache)))
    for p, v in paths(cache):
        assert str(v.dtype).replace("torch.", "") == str(want[p].dtype), p
        assert _rel(v, want[p]) < 1e-4, p


def _drive(eng, reqs):
    """Submit through the CSR doorbell protocol (tests/test_serving.py)."""
    for rid, prompt, mx in reqs:
        eng.mem.buffers["prompt_in"].array[:len(prompt)] = prompt
        eng.csr.fb_write_32(0x0C, rid)
        eng.csr.fb_write_32(0x10, len(prompt))
        eng.csr.fb_write_32(0x14, mx)
        eng.csr.fb_write_32(0x08, 1)             # doorbell
    eng.run_until_done()


@pytest.mark.parametrize("arch,congested", [("llama3.2-1b", False),
                                            ("llama3.2-1b", True),
                                            ("rwkv6-7b", False),
                                            ("zamba2-2.7b", False)])
def test_storm_engine_matches_reference(arch, congested):
    """The same request stream through both engines (storm batching, and
    once with the prompt/token DMA arbitrated on the congested link):
    transaction-log digest and canonical CSR/DMA log byte-identical,
    counters equal, and the same greedy token streams."""
    from repro.core.congestion import CongestionConfig as RefCongestion

    from repro_torch.core.congestion import CongestionConfig
    rcfg, cfg, rp, tp = _models(arch, seed=3)
    rng = np.random.default_rng(1)
    # prompt lengths are bucket multiples (no left pad into ssm/hybrid
    # state) and at least the smoke window of 32 (the reference's
    # cache_insert cannot take a shorter hybrid window)
    reqs = [(rid, rng.integers(1, cfg.vocab_size, int(rng.choice([32, 48])))
             .astype(np.int32), int(rng.integers(3, 7))) for rid in range(5)]
    kw = dict(max_slots=3, max_len=64, prompt_pad=16)
    cong = dict(dos_prob=0.05, seed=7)
    ref = RefEngine(rcfg, rp, flags=ref_tf.RunFlags(**FLAGS), **kw,
                    congestion=RefCongestion(**cong) if congested else None)
    eng = ServingEngine(cfg, tp, flags=tf.RunFlags(**FLAGS), device="cpu",
                        congestion=CongestionConfig(**cong) if congested
                        else None, **kw)
    _drive(ref, reqs)
    _drive(eng, reqs)
    assert eng.completed == ref.completed == len(reqs)
    assert not eng.mem.log.violations
    assert eng.mem.log.canonical() == ref.mem.log.canonical()
    assert eng.mem.log.digest() == ref.mem.log.digest()
    assert ({n: eng.csr.hw_get(n) for n in ("STATUS", "COMPLETED", "ACTIVE")}
            == {n: ref.csr.hw_get(n) for n in ("STATUS", "COMPLETED",
                                                "ACTIVE")})
    assert eng.counters.canonical() == ref.counters.canonical()
    for rid, r in ref.requests.items():
        assert eng.requests[rid].out_tokens == r.out_tokens, rid
        assert len(r.out_tokens) == r.max_new_tokens
    assert np.array_equal(eng.mem.buffers["tokens_out"].array,
                          ref.mem.buffers["tokens_out"].array)
    assert eng.mem.time == ref.mem.time
    if congested:
        assert str(eng.congestion_stats()) == str(ref.congestion_stats())


def test_bench_serving_rows_digests_reproduced():
    """The three cells of BENCH_serving.json (benchmarks/bench_serving.py's
    settings: smoke llama3.2-1b, bf16 weights, continuous batching, paged
    KV) through the port's build_trace + run_open_loop + SLOReport: the
    modeled-cycle SLO rows hash to the committed digests."""
    from benchmarks.bench_serving import CELLS, _rows_digest
    committed = json.loads((ROOT / "BENCH_serving.json").read_text())["cells"]
    cfg = smoke(get_config("llama3.2-1b"))
    params = tf.init_params(cfg, torch.Generator().manual_seed(0),
                            dtype=torch.bfloat16)
    eng = ServingEngine(cfg, params, max_slots=4, max_len=32, prompt_pad=8,
                        kv_pages=4, kv_page_size=8, batching="continuous",
                        flags=tf.RunFlags(attn_impl="chunked", q_chunk=16,
                                          kv_chunk=16), device="cpu")
    for name, spec, pool in CELLS:
        trace = build_trace(spec["kind"], spec["seed"], **spec["params"])
        eng.reset(batching="continuous", **pool)
        run_open_loop(eng, trace)
        slo = SLOReport.from_run(trace, eng)
        assert slo.completed == len(trace.arrivals), name
        assert eng.kv_pool.n_free == eng.kv_pool.n_pages, name
        assert _rows_digest(slo) == committed[name]["rows_digest"], name
        assert slo.deferrals == committed[name]["deferrals"], name


def test_hybrid_prompt_shorter_than_window():
    """A zamba2 prompt shorter than the attention window: the prefill's
    window is the prompt itself, which ``cache_insert`` writes into the
    leading ring slots of the serving cache's full window (the rest empty,
    position -1).  Decoding from there reproduces a full prefill of the
    whole sequence; decoding from the prefill's own short window does not
    (its ring evicts positions still inside the window).  The engine runs
    such a request to completion; the reference's ``cache_insert`` raises
    on it."""
    _, cfg, _, tp = _models("zamba2-2.7b", seed=3)
    flags = tf.RunFlags(**FLAGS)
    W = cfg.attn_window                                  # 32
    toks = _tokens(cfg, seed=2)[:1, :W]
    prefill = tf.make_prefill_fn(cfg, flags, None, 64)
    decode = tf.make_decode_fn(cfg, flags)
    _, short = prefill(tp, {"tokens": torch.from_numpy(toks[:, :16])})
    assert short["win_k"].shape[2] == 16
    big = tf.cache_insert(tf.init_cache(cfg, 2, 64, dtype=torch.float32,
                                        device="cpu"), short, 0)
    assert torch.equal(big["win_pos"][:, 0, :16],
                       torch.arange(16, dtype=torch.int32).expand(2, 16))
    assert (big["win_pos"][:, 0, 16:] == -1).all()
    full, _ = prefill(tp, {"tokens": torch.from_numpy(toks)})
    for t in range(16, W):
        lg, big = decode(tp, big, torch.tensor([toks[0, t], 0],
                                               dtype=torch.int32))
        lg_s, short = decode(tp, short, torch.from_numpy(toks[:, t]))
    assert _rel(lg[:1], full.numpy()) < 1e-4
    assert _rel(lg_s, full.numpy()) > 1e-3

    eng = ServingEngine(cfg, tp, max_slots=2, max_len=64, prompt_pad=16,
                        flags=flags, device="cpu")
    eng.submit(Request(0, toks[0, :16].copy(), 4))
    eng.run_until_done()
    assert eng.completed == 1 and not eng.mem.log.violations
    assert len(eng.requests[0].out_tokens) == 4


def test_cache_insert_writes_one_slot_in_place():
    cfg = smoke(get_config("rwkv6-7b"))
    big = tf.init_cache(cfg, 3, 32, device="cpu")
    state = big["wkv_state"]
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    _, single = tf.make_prefill_fn(cfg, tf.RunFlags(**FLAGS), None, 32)(
        params, inputs.make_prefill_batch(cfg, 1, 16,
                                          torch.Generator().manual_seed(1)))
    out = tf.cache_insert(big, single, 1)
    assert out is big and out["wkv_state"] is state
    assert torch.equal(out["wkv_state"][:, 1],
                       single["wkv_state"][:, 0].float())
    assert float(out["wkv_state"][:, [0, 2]].abs().max()) == 0.0
    assert out["tmix_shift"].dtype == torch.bfloat16     # the cache's type


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-2.7b"])
def test_engine_snapshot_restores_twice(arch):
    """Decode and cache_insert write the cache in place, so get_state copies
    it: a snapshot taken mid-run, restored twice, finishes the run twice
    with the tokens and transaction-log digest of the uninterrupted run."""
    _, cfg, _, tp = _models(arch, seed=5)
    rng = np.random.default_rng(4)
    eng = ServingEngine(cfg, tp, max_slots=2, max_len=64, prompt_pad=16,
                        flags=tf.RunFlags(**FLAGS), device="cpu")
    for rid in range(3):
        eng.submit(Request(rid, rng.integers(1, cfg.vocab_size, 32)
                           .astype(np.int32), 5))
    for _ in range(4):                   # two admissions, two decode steps
        eng.step()
    snap = eng.get_state()
    runs = []
    for _ in range(3):
        eng.run_until_done()
        runs.append(({rid: list(r.out_tokens)
                      for rid, r in eng.requests.items()},
                     eng.mem.log.digest()))
        eng.set_state(snap)
    assert runs[0] == runs[1] == runs[2]
    assert all(len(t) == 5 for t in runs[0][0].values())


def test_engine_refusals():
    cfg = smoke(get_config("rwkv6-7b"))
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    eng = ServingEngine(cfg, params, max_len=32, device="cpu")
    prof = eng.profiler()                    # a profile, no refusal
    assert [c.name for c in prof.channels] == ["ddr", "csr"]
    assert prof.serving_rows()[0] == "direction,transactions,bytes," \
        "stall_cycles"
    assert all(c.breakdown.total == c.horizon for c in prof.channels)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ServingEngine(cfg, params, max_len=32)       # device defaults
    assert callable(tf.make_loss_fn(cfg, tf.RunFlags()))  # ssm trains too
    eng.mem.buffers["prompt_in"].array[:4] = 1
    eng.csr.fb_write_32(0x10, 10_000)                    # absurd SUBMIT_LEN
    eng.csr.fb_write_32(0x08, 1)
    assert any("SUBMIT_LEN" in v for v in eng.csr.log.violations)


def test_dense_decode_past_max_len_drops_like_reference():
    """A slot whose position has run past ``max_len`` (an idle serving slot
    keeps counting): the reference's scatter drops that row's k / v /
    ``kv_pos`` writes, so the port leaves them as they are too; the rows
    still inside the cache decode as the reference's."""
    rcfg, cfg, rp, tp = _models("llama3.2-1b")
    toks = _tokens(cfg, seed=2)
    rflags, tflags = ref_tf.RunFlags(**FLAGS), tf.RunFlags(**FLAGS)
    _, rcache = jax.jit(ref_tf.make_prefill_fn(rcfg, rflags, None, S))(
        rp, {"tokens": jnp.asarray(toks)})
    # row 0 one step from the end, row 1 already at max_len
    rcache = dict(rcache, pos=jnp.asarray([S - 1, S], jnp.int32))
    cache = cache_from_reference(jax.tree.map(np.asarray, rcache),
                                 device="cpu")
    before = {p: v.clone() for p, v in paths(cache)}
    ref_decode = jax.jit(ref_tf.make_decode_fn(rcfg, rflags, None))
    decode = tf.make_decode_fn(cfg, tflags)
    for t in range(2):                       # then both rows are past it
        rlg, rcache = ref_decode(rp, rcache, jnp.asarray(toks[:, t]))
        lg, cache = decode(tp, cache, torch.from_numpy(toks[:, t]))
        if t == 0:
            assert _rel(lg[:1], np.asarray(rlg)[:1]) < 1e-4
    want = dict(paths(jax.tree.map(np.asarray, rcache)))
    for p, v in paths(cache):
        assert _rel(v, want[p]) < 1e-4, p
    assert torch.equal(cache["k"][:, 1], before["k"][:, 1])
    assert list(cache["pos"]) == [S + 1, S + 2]
