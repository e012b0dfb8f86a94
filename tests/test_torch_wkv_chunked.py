"""The WKV-6 kernel's chunked decomposition vs the JAX reference, on the CPU.

The CUDA kernel (``csrc/wkv_scan.cu``) does not run on the CPU, so its
three passes are modeled below in plain tensor ops (``chunked_model``):
each chunk's own state from zero and its total decay, the state pass, each
chunk's exact step walk from its incoming state.  Inputs are made with
numpy from a seed and handed to both sides; the reference runs its Pallas
kernel in interpret mode, as its own tests do.  Tolerance: **half** the
kernel's gate on the card, 0.5e-3 * max(1, max|reference|), for y and the
final state.  Decays are drawn as the kernel's callers draw them
(``exp(-exp(N(0, 1)))``), strong enough that the chunks' decay products
underflow to 0, and near 1, where the state grows with L.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_wkv import kernel as refWKV
from repro_torch.kernels.rwkv6_wkv import kernel as W

torch.set_num_threads(1)

HALF_GATE = 0.5e-3


def chunked_model(r, k, v, w, u, C: int):
    """The kernel's three passes at kernel chunk ``C``: each full chunk's own
    state ``S_c = sum_s (k_s prod_{t>s} w_t) v_s^T`` (walked backwards, the
    decays after s multiplied first) and its total decay ``W_c``; the pass
    ``S_in(c+1) = W_c S_in(c) + S_c``; each chunk's exact step walk from
    ``S_in(c)``, its output taken as ``sum_k r S + v sum_k r u k``, and the
    last chunk's state as the final state."""
    B, L, H, K = r.shape
    nc = -(-L // C)
    zero = torch.zeros((B, H, K, K), dtype=torch.float32)
    s_in = [zero]
    for c in range(nc - 1):                  # passes 1 and 2
        S, D = zero, torch.ones((B, H, K), dtype=torch.float32)
        for t in reversed(range(c * C, (c + 1) * C)):
            S = S + (k[:, t] * D)[..., None] * v[:, t, :, None, :]
            D = D * w[:, t]
        s_in.append(D[..., None] * s_in[-1] + S)
    y = torch.empty((B, L, H, K), dtype=torch.float32)
    for c in range(nc):                      # pass 3
        S = s_in[c]
        for t in range(c * C, min(L, (c + 1) * C)):
            rt, kt, vt = r[:, t], k[:, t], v[:, t]
            y[:, t] = torch.einsum("bhk,bhkv->bhv", rt, S) + \
                (rt * u * kt).sum(dim=-1)[..., None] * vt
            S = w[:, t, :, :, None] * S + kt[..., None] * vt[:, :, None, :]
    return y, S


def _inputs(B, L, H, K, decay, seed=8):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, L, H, K)).astype(np.float32)
               for _ in range(3))
    z = rng.normal(size=(B, L, H, K))
    if decay == "normal":
        w = np.exp(-np.exp(z))
    elif decay == "strong":        # reaches 1e-9 and below, down to 0
        w = np.exp(-np.exp(3.0 * z + 2.0))
    else:                          # "near_one": 1 - 1e-4
        w = np.full(z.shape, 1.0 - 1e-4)
    u = (rng.normal(size=(H, K)) * 0.5).astype(np.float32)
    return r, k, v, w.astype(np.float32), u


def _reference(arrs, L):
    cl = 16 if L % 16 == 0 else 4
    y, st = refWKV.wkv_scan(*map(jnp.asarray, arrs), chunk=cl, hb=2)
    return np.asarray(y), np.asarray(st)


def _check(B, L, H, K, decay, C):
    arrs = _inputs(B, L, H, K, decay)
    want_y, want_st = _reference(arrs, L)
    y, st = chunked_model(*(torch.from_numpy(a) for a in arrs), C=C)
    assert tuple(y.shape) == (B, L, H, K) and tuple(st.shape) == (B, H, K, K)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    for got, want in ((y, want_y), (st, want_st)):
        tol = HALF_GATE * max(1.0, float(np.abs(want).max()))
        assert np.abs(got.numpy() - want).max() < tol


@pytest.mark.parametrize("B,L,H,K,decay,C", [
    (2, 64, 4, 16, "normal", 16),     # the reference's rows, several chunks
    (1, 32, 8, 32, "normal", 16),
    (2, 64, 4, 16, "normal", 64),     # one chunk: the walk from zero
    (1, 100, 2, 16, "normal", 32),    # L no multiple of C: a short last chunk
    (1, 100, 2, 16, "normal", 64),
    (1, 40, 2, 32, "normal", 64),     # L < C
    (1, 96, 2, 16, "strong", 16),     # decay products underflow to 0
    (1, 96, 2, 16, "strong", 32),
    (1, 192, 2, 16, "near_one", 16),  # the state grows with L
    (1, 192, 2, 16, "near_one", 64),
])
def test_chunked_model_matches_reference(B, L, H, K, decay, C):
    _check(B, L, H, K, decay, C)


def test_strong_decays_underflow_the_chunk_products():
    """The strong rows do reach the regime they are there for: a chunk's
    product of decays is 0 in fp32 for most channels."""
    w = torch.from_numpy(_inputs(1, 96, 2, 16, "strong")[3])
    assert float(w.min()) < 1e-9
    assert float((w[:, :16].prod(dim=1) == 0).float().mean()) > 0.5


@pytest.mark.parametrize("B,L,H,K", [
    (1, 1536, 64, 64), (1, 1024, 64, 64), (1, 256, 64, 64),
    (2, 64, 4, 16), (1, 100, 2, 128), (1, 1, 1, 16),
])
def test_kernel_chunk_and_scratch(B, L, H, K):
    """The kernel's own chunk is a multiple of its 8-step run between 16
    and 128, and the scratch holds the own states and decays of every chunk
    but the last."""
    C = W.kernel_chunk(B, L, H, K)
    assert C % 8 == 0 and 16 <= C <= 128
    nc = -(-L // C)
    assert W.scratch_floats(B, L, H, K, C) == B * (nc - 1) * H * K * (K + 1)


def test_kernel_chunk_fills_the_card_at_short_prompts():
    """Short served prompts get smaller chunks (more blocks of the output
    launch); long ones the full 128 (fewer chunk states to move)."""
    assert W.kernel_chunk(1, 1536, 64, 64) == 128
    assert W.kernel_chunk(1, 256, 64, 64) == 32
    assert W.kernel_chunk(8, 256, 64, 64) == 128
