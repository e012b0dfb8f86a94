"""The port's sort-based MoE layer (``repro_torch/models/moe.py``) vs the
JAX reference (``repro.models.moe``), on the CPU.

Weights come from the reference's ``moe_init`` and go to the port as numpy
arrays; inputs are made with numpy.  Tolerances: fp32 outputs within 1e-4
absolute (the reference's own bound in tests/test_moe.py) with the same
top-k indices and the same dropped tokens; bf16 outputs within 2e-2 of
max|out| (both sides round the expert products to bf16, in other orders).
The aux loss within 1e-6 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke as ref_smoke
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tf
from repro_torch.configs import get_config, smoke
from repro_torch.convert import params_from_reference
from repro_torch.models import moe
from repro_torch.models import transformer as tf

torch.set_num_threads(1)

ARCH = "phi3.5-moe-42b-a6.6b"


def _cfgs(arch=ARCH, capacity_factor=None):
    rcfg, cfg = ref_smoke(ref_get_config(arch)), smoke(get_config(arch))
    if capacity_factor is not None:
        rcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=capacity_factor)) for c in (rcfg, cfg))
    return rcfg, cfg


def _setup(capacity_factor, arch=ARCH, T=32, dtype=np.float32, seed=0):
    """One layer's weights from the reference's ``moe_init`` (both sides),
    and x (T, d) from numpy."""
    rcfg, cfg = _cfgs(arch, capacity_factor)
    w = ref_moe.moe_init(jax.random.PRNGKey(seed), rcfg, 1, jnp.float32)
    w = jax.tree.map(lambda a: np.asarray(a[0]), w)
    x = np.random.default_rng(seed + 1).normal(
        size=(T, cfg.d_model)).astype(np.float32)
    rw = {k: jnp.asarray(v, jnp.bfloat16 if dtype != np.float32 and
                         k != "router" else jnp.float32)
          for k, v in w.items()}
    tw = params_from_reference(jax.tree.map(np.asarray, rw), device="cpu")
    if dtype == np.float32:
        return rcfg, cfg, rw, tw, jnp.asarray(x), torch.from_numpy(x)
    return (rcfg, cfg, rw, tw, jnp.asarray(x, jnp.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _dense(cfg, w, x):
    """Every token through its top-k experts by dense one-hot maths (the
    port's side of tests/test_moe.py's reference)."""
    idx, cw, _ = moe.route(w["router"], x, cfg.moe.top_k)
    out = torch.zeros_like(x)
    for e in range(cfg.moe.n_experts):
        g = torch.nn.functional.silu(x @ w["w_gate"][e]) * (x @ w["w_up"][e])
        ye = g @ w["w_down"][e]
        weight = torch.where(idx == e, cw, torch.zeros_like(cw)).sum(1)
        out = out + ye * weight[:, None]
    return out


# ----------------------------------------- tests/test_moe.py, on the port
def test_dispatch_matches_dense_reference_no_drops():
    _, cfg, _, w, _, x = _setup(capacity_factor=16.0)     # no drops possible
    got, aux = moe.moe_apply(w, x, cfg)
    assert float((got - _dense(cfg, w, x)).abs().max()) < 1e-4
    assert float(aux) > 0


def test_capacity_drops_are_bounded():
    _, cfg, _, w, _, x = _setup(capacity_factor=1.0)
    got, _ = moe.moe_apply(w, x, cfg)
    diff = (got - _dense(cfg, w, x)).abs()
    diff_rows = (diff > 1e-4).any(dim=1)
    assert int(diff_rows.sum()) <= x.shape[0]
    # every undropped row matches
    assert float(diff[~diff_rows].max()) < 1e-4


def test_combine_weights_normalized():
    _, cfg, _, w, _, x = _setup(capacity_factor=4.0)
    _, cw, _ = moe.route(w["router"], x, cfg.moe.top_k)
    assert np.allclose(cw.sum(1).numpy(), 1.0, atol=1e-5)


# ------------------------------------------------- against the reference
@pytest.mark.parametrize("arch", [ARCH, "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("capacity_factor", [1.0, 1.25, 16.0])
def test_moe_apply_matches_reference_fp32(arch, capacity_factor):
    """Output within 1e-4, aux within 1e-6 relative, the same top-k
    indices, and the same rows short of their dense (no-drop) output,
    i.e. the same dropped tokens."""
    rcfg, cfg, rw, tw, rx, tx = _setup(capacity_factor, arch=arch, T=48)
    want, raux = ref_moe.moe_apply(rw, rx, rcfg)
    got, aux = moe.moe_apply(tw, tx, cfg)
    assert np.abs(_np(got) - _np(want)).max() < 1e-4
    assert abs(float(aux) - float(raux)) <= 1e-6 * abs(float(raux))
    ridx, _, _ = ref_moe.route(rw["router"], rx, rcfg.moe.top_k)
    idx, _, _ = moe.route(tw["router"], tx, cfg.moe.top_k)
    assert np.array_equal(idx.numpy(), np.asarray(ridx))
    if arch == ARCH:       # swiglu experts: the dense one-hot reference
        dense = _np(_dense(cfg, tw, tx))
        dropped = lambda out: np.abs(_np(out) - dense).max(1) > 1e-4
        assert np.array_equal(dropped(got), dropped(want))
        assert dropped(want).any() == (capacity_factor == 1.0)


@pytest.mark.parametrize("capacity_factor", [1.0, 16.0])
def test_moe_apply_matches_reference_bf16(capacity_factor):
    """bf16 experts and tokens, the router kept in fp32 (both sides take
    the routing logits in fp32 whatever the router's type)."""
    rcfg, cfg, rw, tw, rx, tx = _setup(capacity_factor, dtype="bf16", T=48)
    want, raux = ref_moe.moe_apply(rw, rx, rcfg)
    got, aux = moe.moe_apply(tw, tx, cfg)
    assert got.dtype == torch.bfloat16
    w = _np(want)
    assert np.abs(_np(got) - w).max() <= 2e-2 * np.abs(w).max()
    assert abs(float(aux) - float(raux)) <= 1e-6 * abs(float(raux))


def test_route_takes_the_lowest_index_among_ties():
    """``jax.lax.top_k`` order among equal probabilities: a router whose
    columns repeat ties every token's experts 0/1 and 2/3; a zero router
    ties all four."""
    _, cfg, rw, tw, rx, tx = _setup(capacity_factor=1.25)
    r = np.asarray(rw["router"]).copy()
    r[:, 1], r[:, 3] = r[:, 0], r[:, 2]
    for router in (r, np.zeros_like(r)):
        ridx, rcw, raux = ref_moe.route(jnp.asarray(router), rx, 2)
        idx, cw, aux = moe.route(torch.from_numpy(router), tx, 2)
        assert np.array_equal(idx.numpy(), np.asarray(ridx))
        assert np.abs(cw.numpy() - np.asarray(rcw)).max() < 1e-6
        assert abs(float(aux) - float(raux)) < 1e-5
    assert (idx.numpy() == [0, 1]).all()


def test_tied_router_drops_the_same_tokens():
    """A zero router sends every token to experts 0 and 1, far past their
    capacity: the stable sort keeps the first C tokens of each, as the
    reference does, and the rest add nothing."""
    rcfg, cfg, rw, tw, rx, tx = _setup(capacity_factor=1.0, T=48)
    rw = dict(rw, router=jnp.zeros_like(rw["router"]))
    tw = dict(tw, router=torch.zeros_like(tw["router"]))
    want, _ = ref_moe.moe_apply(rw, rx, rcfg)
    got, _ = moe.moe_apply(tw, tx, cfg)
    assert np.abs(_np(got) - _np(want)).max() < 1e-4
    C = moe.capacity(cfg, 48)
    assert C < 48
    assert float(got[C:].abs().max()) == 0.0
    assert float(got[:C].abs().sum(1).min()) > 0.0


def test_moe_apply_repeats_bitwise():
    _, cfg, _, tw, _, tx = _setup(capacity_factor=1.0, dtype="bf16", T=48)
    a, _ = moe.moe_apply(tw, tx, cfg)
    b, _ = moe.moe_apply(tw, tx, cfg)
    assert torch.equal(a, b)


@pytest.mark.parametrize("chunk", [0, 8, 16])
def test_moe_block_sequence_chunks_match_reference(chunk):
    """``moe_block`` over chunks of ``moe_seq_chunk`` positions (0: none;
    8 and 16 divide S = 32): output within 1e-4 and the chunks' mean aux
    within 1e-6 relative."""
    rcfg, cfg = _cfgs("moonshot-v1-16b-a3b")
    w = ref_moe.moe_init(jax.random.PRNGKey(4), rcfg, 1, jnp.float32)
    w = jax.tree.map(lambda a: a[0], w)
    tw = params_from_reference(jax.tree.map(np.asarray, w), device="cpu")
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    ln = (1 + 0.1 * rng.normal(size=(cfg.d_model,))).astype(np.float32)
    want, raux = ref_tf.moe_block(rcfg, ref_tf.RunFlags(moe_seq_chunk=chunk),
                                  None, w, jnp.asarray(ln), jnp.asarray(x),
                                  None)
    got, aux = tf.moe_block(cfg, tf.RunFlags(moe_seq_chunk=chunk), None, tw,
                            torch.from_numpy(ln), torch.from_numpy(x))
    assert np.abs(_np(got) - _np(want)).max() < 1e-4
    assert abs(float(aux) - float(raux)) <= 1e-6 * abs(float(raux))


def test_moe_block_refuses_sharding_context():
    """``moe_block`` takes a sharding context now (it refused one until the
    multi-device slice, and this test held it to that): under a one-rank
    context (mesh (1, 1), no process group) both ``moe_mode``s give what
    ``ctx=None`` gives, bit for bit.  What it still refuses is a context
    that is not a ``ShardCtx``."""
    from repro_torch.launch.mesh import make_ctx, make_test_mesh
    rcfg, cfg = _cfgs("moonshot-v1-16b-a3b")
    w = ref_moe.moe_init(jax.random.PRNGKey(4), rcfg, 1, jnp.float32)
    tw = params_from_reference(jax.tree.map(lambda a: np.asarray(a[0]), w),
                               device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(1, 16, cfg.d_model)).astype(np.float32))
    ln = torch.ones(cfg.d_model)
    y, aux = tf.moe_block(cfg, tf.RunFlags(), None, tw, ln, x)
    assert y.shape == x.shape and torch.isfinite(y).all()
    assert torch.isfinite(aux)
    ctx = make_ctx(make_test_mesh((1, 1)))
    for mode in ("pjit", "ep_shardmap"):
        y1, aux1 = tf.moe_block(cfg, tf.RunFlags(moe_mode=mode), ctx, tw, ln,
                                x)
        assert torch.equal(y1, y) and torch.equal(aux1, aux), mode
    with pytest.raises(TypeError, match="ShardCtx"):
        tf.moe_block(cfg, tf.RunFlags(), object(), tw, ln, x)
