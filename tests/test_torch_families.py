"""The port's moe, vlm and audio families vs the JAX reference, on the CPU:
moonshot-v1-16b-a3b and phi3.5-moe-42b-a6.6b (moe), llama-3.2-vision-11b
(vlm: gated cross attention over patch embeddings) and hubert-xlarge
(audio: a bidirectional encoder over frame embeddings), at smoke size.

Weights come from the reference's ``init_params`` through
``convert.params_from_reference``; inputs are made with numpy.  The vlm's
gates are set to nonzero values and its patches are random: at init the
gates are zero, and with zero gates or zero patches the cross layers add
nothing, so such a case would not test them.  Both sides compute in fp32.

Tolerances: loss within 1e-5 relative and each gradient leaf within
5e-5 * max(1e-3, max|grad|) (tests/test_torch_models.py's, tighter than
the port's training gate of 5e-3 on the loss and 5e-2 on the gradient
norm); prefill logits, decode logits and every cache leaf within 1e-4 of
max magnitude (tests/test_torch_serving.py's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import smoke as ref_smoke
from repro.models import inputs as ref_inputs
from repro.models import transformer as ref_tf
from repro_torch._tree import leaves, paths
from repro_torch.configs import SHAPES, get_config, smoke
from repro_torch.convert import cache_from_reference, params_from_reference
from repro_torch.launch.steps import train_state_shape
from repro_torch.models import inputs
from repro_torch.models import transformer as tf

torch.set_num_threads(1)

MOE = ["moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b"]
VLM, AUDIO = "llama-3.2-vision-11b", "hubert-xlarge"
ARCHS = MOE + [VLM, AUDIO]
DECODERS = MOE + [VLM]              # hubert is encoder-only: no decode
B, S, S0 = 2, 32, 24


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(str(getattr(k, "key", k)) for k in path), leaf)
            for path, leaf in flat]


def _cfgs(arch, lift_capacity=False):
    rcfg, cfg = ref_smoke(ref_get_config(arch)), smoke(get_config(arch))
    if lift_capacity and cfg.moe is not None:
        # no token drops: a decode step (2 tokens) and a prefill (64) then
        # route every token alike (tests/test_decode_consistency.py)
        rcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=float(c.moe.n_experts)))
            for c in (rcfg, cfg))
    return rcfg, cfg


def _ref_params(rcfg, seed=3):
    p = ref_tf.init_params(rcfg, jax.random.PRNGKey(seed))
    if rcfg.family == "vlm":
        cross = dict(p["blocks"]["cross"])
        n = cross["gate"].shape[0]
        cross["gate"] = jnp.linspace(0.5, 1.2, n, dtype=jnp.float32)
        cross["gate_mlp"] = jnp.linspace(-0.8, 0.6, n, dtype=jnp.float32)
        p = dict(p, blocks=dict(p["blocks"], cross=cross))
    return p


def _models(arch, lift_capacity=False):
    rcfg, cfg = _cfgs(arch, lift_capacity)
    rp = _ref_params(rcfg)
    tp = params_from_reference(jax.tree.map(np.asarray, rp), device="cpu")
    return rcfg, cfg, rp, tp


def _batch(cfg, B=B, S=S, seed=0, labels=True):
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "frames":
        out["frames"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    if cfg.frontend == "tokens+patches":
        out["patches"] = rng.normal(
            size=(B, cfg.n_media_tokens, cfg.d_model)).astype(np.float32)
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    return out


def _rel(got, want) -> float:
    g = got.float().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / max(1e-6, np.abs(w).max()))


def _flags(impl="chunked", **kw):
    return dict(attn_impl=impl, q_chunk=16, kv_chunk=16,
                compute_dtype="float32", **kw)


# --------------------------------------------------------------- params
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch):
    """Leaf paths, shapes and dtypes (value-free) at smoke size and at full
    width (the port's tree on the ``meta`` device, the reference's through
    ``jax.eval_shape``); the frames frontend has no embedding and an
    lm_head, the vlm zero gates."""
    for reduce in (True, False):
        rcfg, cfg = ref_get_config(arch), get_config(arch)
        if reduce:
            rcfg, cfg = ref_smoke(rcfg), smoke(cfg)
        want = jax.eval_shape(lambda: ref_tf.init_params(
            rcfg, jax.random.PRNGKey(0)))
        want = [(p, tuple(x.shape), str(x.dtype))
                for p, x in _jax_paths(want)]
        got = [(p, tuple(x.shape), str(x.dtype).replace("torch.", ""))
               for p, x in paths(train_state_shape(cfg)["params"])]
        assert got == want
    real = tf.init_params(smoke(cfg), torch.Generator().manual_seed(0))
    assert all(torch.isfinite(x).all() for x in leaves(real))
    assert ("embed" in real) == (cfg.frontend != "frames")
    if cfg.family == "vlm":
        assert float(real["blocks"]["cross"]["gate"].abs().max()) == 0.0


def test_large_leaves_draw_one_slice_at_a_time():
    """A leaf past 2^31 elements is drawn one leading slice at a time (the
    fp32 draw holds one slice); smaller leaves keep their single draw, so
    the configs served so far keep their values."""
    from repro_torch.models import layers
    old = layers._WHOLE_DRAW_ELEMS
    try:
        whole = layers.normal(torch.Generator().manual_seed(1), (3, 4, 5),
                              0.5, torch.bfloat16)
        layers._WHOLE_DRAW_ELEMS = 20
        sliced = layers.normal(torch.Generator().manual_seed(1), (3, 4, 5),
                               0.5, torch.bfloat16)
        gen = torch.Generator().manual_seed(1)
        want = torch.stack([layers.normal(gen, (4, 5), 0.5, torch.bfloat16)
                            for _ in range(3)])
    finally:
        layers._WHOLE_DRAW_ELEMS = old
    assert sliced.dtype == torch.bfloat16 and torch.equal(sliced, want)
    # another stream than one whole draw: the threshold keeps every leaf
    # of the configs served so far on its single draw
    assert not torch.equal(whole, want)


# ---------------------------------------------------------- loss / grads
@pytest.mark.parametrize("impl", ["naive", "chunked", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, impl):
    """``make_loss_fn`` (loss + 0.01 aux) and every gradient leaf against
    the reference's ``value_and_grad``; the moe aux loss too."""
    rcfg, cfg, rp, tp = _models(arch)
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, raux), want_g = jax.jit(jax.value_and_grad(
        ref_tf.make_loss_fn(rcfg, ref_tf.RunFlags(**_flags(impl)), None),
        has_aux=True))(rp, jb)
    ts = leaves(tp)
    for t in ts:
        t.requires_grad_()
    got, aux = tf.make_loss_fn(cfg, tf.RunFlags(**_flags(impl)))(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    got_g = torch.autograd.grad(got, ts)
    got = float(got.detach())
    assert abs(got - float(want)) < 1e-5 * abs(float(want))
    assert abs(float(aux["aux"]) - float(raux["aux"])) <= \
        1e-5 * max(1.0, abs(float(raux["aux"])))
    assert (float(aux["aux"]) > 0) == (cfg.moe is not None)
    wg = dict(_jax_paths(jax.tree.map(np.asarray, want_g)))
    for (path, _), g in zip(paths(tp), got_g):
        w = wg[path]
        err = np.abs(g.numpy() - w).max()
        assert err < 5e-5 * max(1e-3, np.abs(w).max()), (path, err)
    if cfg.family == "vlm":          # the cross layers take part
        cross = [g for (p, _), g in zip(paths(tp), got_g)
                 if p.startswith("blocks/cross/w")]
        assert min(float(g.abs().max()) for g in cross) > 0


# -------------------------------------------------------------- prefill
@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, impl):
    """Last-position logits and every cache leaf (same paths, shapes and
    dtypes: ``cross_k`` / ``cross_v`` for the vlm) within 1e-4 relative of
    the reference's ``make_prefill_fn``."""
    rcfg, cfg, rp, tp = _models(arch)
    batch = _batch(cfg, labels=False)
    max_len = S + 8
    want_lg, want_cache = jax.jit(ref_tf.make_prefill_fn(
        rcfg, ref_tf.RunFlags(**_flags(impl)), None, max_len))(
            rp, {k: jnp.asarray(v) for k, v in batch.items()})
    lg, cache = tf.make_prefill_fn(cfg, tf.RunFlags(**_flags(impl)), None,
                                   max_len)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tuple(lg.shape) == (B, tf.padded_vocab(cfg))
    assert _rel(lg, want_lg) < 1e-4
    want = dict(paths(jax.tree.map(np.asarray, want_cache)))
    got = dict(paths(cache))
    assert sorted(got) == sorted(want)
    for p, v in got.items():
        assert tuple(v.shape) == want[p].shape, p
        assert str(v.dtype).replace("torch.", "") == str(want[p].dtype), p
        assert _rel(v, want[p]) < 1e-4, p


# --------------------------------------------------------------- decode
@pytest.mark.parametrize("arch", DECODERS)
def test_decode_matches_reference_and_full_prefill(arch):
    """From the reference's prefill cache of the first S0 tokens, the
    port's decode steps give the reference's logits (1e-4 relative), and
    the port's own prefill + decode reproduces its full prefill (capacity
    lifted for moe, as tests/test_decode_consistency.py does)."""
    rcfg, cfg, rp, tp = _models(arch, lift_capacity=True)
    batch = _batch(cfg, seed=1, labels=False)
    toks = batch["tokens"]
    rflags, tflags = ref_tf.RunFlags(**_flags()), tf.RunFlags(**_flags())
    ref_prefill = jax.jit(ref_tf.make_prefill_fn(rcfg, rflags, None, S))
    ref_decode = jax.jit(ref_tf.make_decode_fn(rcfg, rflags, None))
    prefill = tf.make_prefill_fn(cfg, tflags, None, S)
    decode = tf.make_decode_fn(cfg, tflags)
    head = dict(batch, tokens=toks[:, :S0])

    _, rcache = ref_prefill(rp, {k: jnp.asarray(v) for k, v in head.items()})
    cache = cache_from_reference(jax.tree.map(np.asarray, rcache),
                                 device="cpu")
    _, own = prefill(tp, {k: torch.from_numpy(v) for k, v in head.items()})
    for t in range(S0, S):
        rlg, rcache = ref_decode(rp, rcache, jnp.asarray(toks[:, t]))
        lg, cache = decode(tp, cache, torch.from_numpy(toks[:, t]))
        olg, own = decode(tp, own, torch.from_numpy(toks[:, t]))
        assert _rel(lg, rlg) < 1e-4, t
    full, _ = prefill(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert _rel(olg, full.numpy()) < 1e-4
    want = dict(paths(jax.tree.map(np.asarray, rcache)))
    for p, v in paths(cache):
        assert str(v.dtype).replace("torch.", "") == str(want[p].dtype), p
        assert _rel(v, want[p]) < 1e-4, p


def test_vlm_decode_reads_the_patches():
    """The cross k / v of the prefill cache enter every decode step: other
    patches, other logits."""
    _, cfg, _, tp = _models(VLM)
    batch = _batch(cfg, seed=1, labels=False)
    flags = tf.RunFlags(**_flags())
    prefill = tf.make_prefill_fn(cfg, flags, None, S)
    decode = tf.make_decode_fn(cfg, flags)
    out = []
    for scale in (1.0, 0.0):
        b = dict(batch, tokens=batch["tokens"][:, :S0],
                 patches=batch["patches"] * scale)
        _, cache = prefill(tp, {k: torch.from_numpy(v) for k, v in b.items()})
        lg, _ = decode(tp, cache, torch.from_numpy(batch["tokens"][:, S0]))
        out.append(lg)
    assert _rel(out[0], out[1].numpy()) > 1e-3


# --------------------------------------------------------------- serving
@pytest.mark.parametrize("arch", DECODERS)
def test_storm_engine_matches_reference(arch):
    """The same request stream through the reference's and the port's
    ``ServingEngine`` (the vlm prefill with the engine's zero patches):
    transaction-log digest and canonical log byte-identical, the same
    greedy tokens."""
    from repro.serving import ServingEngine as RefEngine

    from repro_torch.serving import ServingEngine
    rcfg, cfg, rp, tp = _models(arch)
    rng = np.random.default_rng(1)
    reqs = [(rid, rng.integers(1, cfg.vocab_size, int(rng.integers(5, 20)))
             .astype(np.int32), int(rng.integers(2, 5))) for rid in range(4)]
    kw = dict(max_slots=2, max_len=32, prompt_pad=8)
    ref = RefEngine(rcfg, rp, flags=ref_tf.RunFlags(**_flags()), **kw)
    eng = ServingEngine(cfg, tp, flags=tf.RunFlags(**_flags()), device="cpu",
                        **kw)
    for e in (ref, eng):
        for rid, prompt, mx in reqs:
            e.mem.buffers["prompt_in"].array[:len(prompt)] = prompt
            for addr, val in ((0x0C, rid), (0x10, len(prompt)), (0x14, mx),
                              (0x08, 1)):
                e.csr.fb_write_32(addr, val)
        e.run_until_done()
    assert eng.completed == ref.completed == len(reqs)
    assert not eng.mem.log.violations
    assert eng.mem.log.canonical() == ref.mem.log.canonical()
    for rid, r in ref.requests.items():
        assert eng.requests[rid].out_tokens == r.out_tokens, rid


# ------------------------------------------------------------ input specs
@pytest.mark.parametrize("arch", ARCHS + ["llama3.2-1b"])
def test_input_specs_match_reference(arch):
    """Keys, shapes and dtypes of the train, prefill and decode specs (on
    the ``meta`` device) at every shape of the reference's table."""
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    for name, shape in SHAPES.items():
        rshape = REF_SHAPES[name]
        for port_fn, ref_fn in ((inputs.train_input_specs,
                                 ref_inputs.train_input_specs),
                                (inputs.prefill_input_specs,
                                 ref_inputs.prefill_input_specs)):
            got, want = port_fn(cfg, shape), ref_fn(rcfg, rshape)
            assert sorted(got) == sorted(want)
            for k, v in got.items():
                assert v.device.type == "meta"
                assert tuple(v.shape) == want[k].shape, (name, k)
                assert str(v.dtype).replace("torch.", "") == \
                    str(want[k].dtype), (name, k)
        got = inputs.decode_token_specs(cfg, shape)
        want = ref_inputs.decode_token_specs(rcfg, rshape)
        assert tuple(got.shape) == want.shape and got.dtype == torch.int32
