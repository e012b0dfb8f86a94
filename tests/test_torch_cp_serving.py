"""The pieces that keep a rank's serving and MoE work to its shard, and
rwkv6's chunk-wise backward, against the plain whole computations and the
reference.

  * ``combine_partials`` over m in {1, 2, 4} slices of the cache's
    positions (``decode_attention_partial`` on each) against
    ``decode_attention`` on the whole cache: causal, a sliding window over
    a ring of slots, and the vlm's non-causal cross attention; fp32, each
    element within 1e-6 x max(1, |ref|).  No process group: the slices are
    stacked and reduced by plain sums.
  * The pjit MoE layer with its experts split over the model axis
    (``_moe_tokens`` under a context: ``moe_apply`` of a rank's experts) on 2 and 4 gloo
    ranks against the reference's ``repro.models.moe.moe_apply`` on the
    same numpy inputs, fp32: the output within 1e-5 x max(1, max|ref|),
    the same drops (the reference's routing, equal, with some tokens over
    the capacity, and the aux within 1e-6 relative), and the gradients
    of ``sum(out * gy) + aux`` with respect to the tokens, the router and
    this rank's experts within 1e-5 x max(1e-3, max|ref|) (data ranks'
    shares summed).
  * rwkv6's WKV backward by chunk-boundary states
    (``chunked_recompute_grads``) against the whole-sequence recompute
    through ``wkv_scan_twin`` and the reference's ``jax.grad`` of its
    lax-scan twin (``repro.models.rwkv6._wkv_chunk`` under ``lax.scan``):
    every gradient within 1e-5 x max(1e-3, max|ref|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as ref_get_config
from repro.configs import smoke as ref_smoke
from repro.models import moe as ref_moe
from repro.models import rwkv6 as ref_rwkv6
from repro_torch.configs import get_config, smoke
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.launch.mesh import make_ctx, make_test_mesh
from repro_torch.models import transformer as tf
from repro_torch.models.attention import (combine_partials, decode_attention,
                                          decode_attention_partial)
from torch_ranks import spawn

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the combine of context-parallel decode attention
# ---------------------------------------------------------------------------


def _decode_case(case, rng):
    B, S, H, KH, D = 3, 48, 8, 2, 16
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    q, k, v = t(B, 1, H, D), t(B, S, KH, D), t(B, S, KH, D)
    if case == "causal":
        # rows at positions 5, 30, 47; slots past a row's position empty
        qp = torch.tensor([[5], [30], [47]], dtype=torch.int32)
        kv = torch.arange(S, dtype=torch.int32).expand(B, S).clone()
        kv[kv > qp] = -1
        return q, k, v, qp, kv, 0
    if case == "window":
        # a ring of S slots holding positions p at p % S, window 20
        qp = torch.tensor([[40], [100], [17]], dtype=torch.int32)
        slots = torch.arange(S)
        kv = torch.stack([torch.where(
            slots <= int(p) % S, int(p) - int(p) % S + slots,
            int(p) - int(p) % S - S + slots) for p in qp[:, 0]]).int()
        kv[kv < 0] = -1
        return q, k, v, qp, kv, 20
    zero = torch.zeros((B, 1), dtype=torch.int32)         # cross
    return q, k, v, zero, torch.zeros((B, S), dtype=torch.int32), 0


@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("case", ["causal", "window", "cross"])
def test_combine_partials_equal_whole_cache_attention(case, m):
    rng = np.random.default_rng(10 * ("causal", "window", "cross")
                                .index(case) + m)
    q, k, v, qp, kvp, window = _decode_case(case, rng)
    want = decode_attention(q, k, v, q_pos=qp, kv_pos=kvp, window=window)
    n = k.shape[1] // m
    parts = [decode_attention_partial(
        q, k[:, i * n:(i + 1) * n], v[:, i * n:(i + 1) * n], q_pos=qp,
        kv_pos=kvp[:, i * n:(i + 1) * n], window=window) for i in range(m)]
    acc, mx, l = (torch.stack(p) for p in zip(*parts))
    got = combine_partials(acc, mx, l,
                           max_fn=lambda t: t.amax(0, keepdim=True),
                           sum_fn=lambda a, b: (a.sum(0), b.sum(0)))
    assert got.shape == want.shape
    assert ((got - want).abs() <= 1e-6 * want.abs().clamp(min=1)).all(), \
        float((got - want).abs().max())


# ---------------------------------------------------------------------------
# the pjit MoE layer with split experts, on gloo ranks
# ---------------------------------------------------------------------------

MOE_ARCH = "moonshot-v1-16b-a3b"
T = 32


def _moe_reference():
    rcfg = ref_smoke(ref_get_config(MOE_ARCH))
    rng = np.random.default_rng(5)
    w = ref_moe.moe_init(jax.random.PRNGKey(3), rcfg, 1, jnp.float32)
    w = {k: np.asarray(v[0]) for k, v in w.items()}
    # a shared direction skews the routing, so the capacity drops tokens
    x = (rng.normal(size=(T, rcfg.d_model))
         + 2.0 * rng.normal(size=(1, rcfg.d_model))).astype(np.float32)
    gy = rng.normal(size=(T, rcfg.d_model)).astype(np.float32)

    def loss(w, x):
        out, aux = ref_moe.moe_apply(w, x, rcfg)
        return jnp.sum(out * gy) + aux, (out, aux)
    (_, (out, aux)), (gw, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(w, x)
    return {"w": w, "x": x, "gy": gy, "out": np.asarray(out),
            "aux": float(aux), "gw": {k: np.asarray(v) for k, v in
                                      gw.items()}, "gx": np.asarray(gx)}


def _rank_moe(rank, world, store, mesh_shape, ref):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from repro_torch.sharding import comm
        cfg = smoke(get_config(MOE_ARCH))
        ctx = make_ctx(make_test_mesh(mesh_shape).bind("cpu"))
        E, m = cfg.moe.n_experts, ctx.msize
        El, e0 = E // m, ctx.model_rank * (E // m)
        w = {k: torch.from_numpy(v if k == "router" else v[e0:e0 + El])
             .requires_grad_() for k, v in ref["w"].items()}
        x = torch.from_numpy(ref["x"])
        split = ctx.splits_batch(T)
        lctx = tf.ShardCtx(ctx.mesh, ctx.data_axes, ctx.model_axis,
                           rows_split=split)
        xl = (comm.data_chunk(x, ctx) if split else x).clone() \
            .requires_grad_()
        gy = torch.from_numpy(ref["gy"])
        gyl = comm.data_chunk(gy, ctx) if split else gy
        flags = tf.RunFlags(moe_mode="pjit", compute_dtype="float32")
        out, aux = tf._moe_tokens(cfg, flags, lctx, w, xl)
        want = torch.from_numpy(ref["out"])
        wl = comm.data_chunk(want, ctx) if split else want
        tol = 1e-5 * max(1.0, float(want.abs().max()))
        assert (out - wl).abs().max() <= tol, float((out - wl).abs().max())
        assert abs(float(aux) - ref["aux"]) <= 1e-6 * abs(ref["aux"])
        # the same drops: the kept slots of the whole layer's dispatch
        idx, _, _ = tf.moe_lib.route(w["router"].detach(), x, cfg.moe.top_k)
        ridx, _, _ = ref_moe.route(jnp.asarray(ref["w"]["router"]),
                                   jnp.asarray(ref["x"]), cfg.moe.top_k)
        assert np.array_equal(idx.numpy(), np.asarray(ridx))
        counts = torch.bincount(idx.reshape(-1), minlength=E)
        assert int((counts - tf.moe_lib.capacity(cfg, T)).clamp(min=0)
                   .sum()) > 0                      # some tokens dropped
        # gradients: each data rank's loss is its share
        share = (out * gyl).sum() + aux / ctx.dsize
        grads = torch.autograd.grad(share, [xl] + [w[k] for k in sorted(w)])
        gx = grads[0]
        want_gx = torch.from_numpy(ref["gx"])
        want_gx = comm.data_chunk(want_gx, ctx) if split else want_gx
        if not split:
            gx = comm.sum_data(gx, ctx)
        assert (gx - want_gx).abs().max() <= 1e-5 * max(
            1e-3, float(want_gx.abs().max()))
        for k, g in zip(sorted(w), grads[1:]):
            g = comm.sum_data(g, ctx)
            rw = ref["gw"][k]
            want_g = torch.from_numpy(rw if k == "router"
                                      else rw[e0:e0 + El])
            assert (g - want_g).abs().max() <= 1e-5 * max(
                1e-3, float(np.abs(rw).max())), k
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2), (1, 4)])
def test_pjit_moe_with_split_experts_equals_reference(tmp_path, mesh_shape):
    """2 and 4 gloo ranks: model axis 2 or 4 (2 or 1 experts a rank of
    smoke moonshot's 4, top 2), and a data axis of 2 whose ranks route the
    data group's gathered tokens with one capacity, as the reference's
    whole layer does."""
    ref = _moe_reference()
    world = int(np.prod(mesh_shape))
    spawn(_rank_moe, (world, str(tmp_path / "store"), mesh_shape, ref),
          world)


# ---------------------------------------------------------------------------
# rwkv6's WKV backward by chunk-boundary states
# ---------------------------------------------------------------------------


def _reference_scan(r, k, v, w, u, chunk):
    """The reference's lax scan of ``_wkv_chunk`` over chunks from a zero
    state (``repro.models.rwkv6.time_mix``'s scan)."""
    B, L, H, K = r.shape
    nc = L // chunk
    split = lambda a: a.reshape(B, nc, chunk, H, K).transpose(1, 0, 2, 3, 4)

    def body(st, inp):
        return ref_rwkv6._wkv_chunk(st, *inp, u)
    st, ys = jax.lax.scan(body, jnp.zeros((B, H, K, K), jnp.float32),
                          tuple(split(a) for a in (r, k, v, w)))
    return ys.transpose(1, 0, 2, 3, 4).reshape(B, L, H, K), st


@pytest.mark.parametrize("use_state", [True, False])
def test_wkv_chunked_backward_equals_whole_recompute_and_reference(
        use_state):
    rng = np.random.default_rng(17)
    B, L, H, K, chunk = 2, 40, 3, 8, 8
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    args = [f(B, L, H, K), f(B, L, H, K), f(B, L, H, K),
            np.exp(-np.exp(f(B, L, H, K))).astype(np.float32),
            0.5 * f(H, K)]
    gy, gs = f(B, L, H, K), f(B, H, K, K) * use_state

    def ref_loss(*a):
        y, st = _reference_scan(*a, chunk)
        return jnp.sum(y * gy) + jnp.sum(st * gs)
    want = jax.jit(jax.grad(ref_loss, argnums=tuple(range(5))))(
        *map(jnp.asarray, args))
    grads = []
    for fn in (wkv_ops.wkv_scan, wkv_ops.wkv_scan_twin):
        ins = [torch.from_numpy(a).requires_grad_() for a in args]
        y, st = fn(*ins, chunk=chunk)
        loss = (y * torch.from_numpy(gy)).sum() + \
            (st * torch.from_numpy(gs)).sum()
        grads.append(torch.autograd.grad(loss, ins))
    got, whole = grads
    for g, h, w in zip(got, whole, want):
        w = np.asarray(w)
        tol = 1e-5 * max(1e-3, np.abs(w).max())
        assert np.abs(g.numpy() - h.numpy()).max() <= tol
        assert np.abs(g.numpy() - w).max() <= tol
