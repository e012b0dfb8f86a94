"""The arithmetic of the port's split-precision tensor-core bodies against
the JAX reference, on the CPU.

Two CUDA bodies trade one product in a wide type for several in a narrow
one (the kernels themselves run only on the card, where chip_smoke.py and
tests/test_torch_gpu.py hold them against their plain versions):

* the fp32 matmul (csrc/systolic_matmul_sm90.cuh) splits each operand into
  TF32 words x = hi + lo and sums three TF32 products (3xTF32);
* the bf16 attention dq (csrc/flash_dq_sm90.cuh) carries dS as a bf16 pair
  hi + lo and multiplies K twice.

Here the same arithmetic, written with numpy/torch on the CPU (TF32 and
bf16 rounding by bit manipulation, exact products, fp32 sums), is held
against the reference's Pallas kernels run in interpret mode, as the JAX
package's own tests run them.  The rule that keeps a split is that it stay
within HALF of the reference's gate (matmul 1e-4 max(1, max|ref|), dq
5e-4 max(1, max|ref|)); a single TF32 product is shown to miss it at long
K, which is why the matmul splits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as refK
from repro.kernels.systolic_matmul import kernel as refMM

torch.set_num_threads(1)

HALF = 0.5


def _tf32_np(x: np.ndarray) -> np.ndarray:
    """Round fp32 to 10 mantissa bits, to nearest, ties away from zero,
    on the sign-magnitude bit pattern, as the card's cvt.rna.tf32.f32."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split_tf32_matmul(a: np.ndarray, b: np.ndarray, terms: int):
    """A_hi.B_hi (+ A_hi.B_lo) (+ A_lo.B_hi) in float32 numpy matmuls; each
    product of two TF32 words is exact in fp32."""
    ah, bh = _tf32_np(a), _tf32_np(b)
    out = ah @ bh
    if terms >= 2:
        out = out + ah @ _tf32_np(b - bh)
    if terms >= 3:
        out = out + _tf32_np(a - ah) @ bh
    return out


def _matmul_case(M, N, K, bm, seed=5):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(M, K)).astype(np.float32)
    b = rng.normal(size=(K, N)).astype(np.float32)
    want = np.asarray(refMM.matmul(jnp.asarray(a), jnp.asarray(b), bm=bm,
                                   bn=bm, bk=bm))
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    return a, b, want, tol


# the reference's test_matmul_kernel shapes (in fp32), then a long K
MM_ROWS = [(256, 128, 128, 64), (128, 256, 512, 64), (128, 128, 128, 128),
           (64, 64, 4096, 64)]


def test_tf32_round_matches_bit_rule():
    """The model's bit rule (what the card's cvt.rna does) against its
    definition in float64 arithmetic: 11 significant bits, the magnitude
    rounded half away from zero; so at most 10 mantissa bits, within half
    an ulp of 2^-10 relative."""
    rng = np.random.default_rng(1)
    x = np.concatenate([(rng.normal(size=4096) * 10.0 **
                         rng.integers(-6, 6, 4096)).astype(np.float32),
                        np.float32([1 + 2 ** -11, -(1 + 2 ** -11), 0.0])])
    got = _tf32_np(x)
    _, e = np.frexp(x.astype(np.float64))          # |x| in [2^(e-1), 2^e)
    ulp = np.ldexp(1.0, e - 11)
    want = np.sign(x) * np.floor(np.abs(x.astype(np.float64)) / ulp + 0.5) * ulp
    assert np.array_equal(got.astype(np.float64), want)
    assert not np.any(got.view(np.uint32) & 0x1FFF)
    rel = np.abs(got - x) / np.maximum(np.abs(x), 1e-30)
    assert rel.max() <= 2.0 ** -11
    assert got[-3] == 1 + 2 ** -10 and got[-2] == -(1 + 2 ** -10)


@pytest.mark.parametrize("M,N,K,bm", MM_ROWS)
def test_3xtf32_within_half_gate_of_reference(M, N, K, bm):
    a, b, want, tol = _matmul_case(M, N, K, bm)
    got = _split_tf32_matmul(a, b, 3)
    assert float(np.abs(got - want).max()) < HALF * tol


def test_one_and_two_tf32_products_miss_half_gate_at_long_k():
    """Why the fp32 body splits: one TF32 product (and two, without
    A_lo.B_hi) is outside half the gate at K = 4096, three are not."""
    a, b, want, tol = _matmul_case(64, 64, 4096, 64)
    errs = [float(np.abs(_split_tf32_matmul(a, b, t) - want).max()) / tol
            for t in (1, 2, 3)]
    assert errs[0] > HALF and errs[1] > HALF and errs[2] < HALF, errs


def _bf16_np(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16() \
        .float().numpy()


def _dq_split_model(q, k, v, dout, lse, delta, causal, window):
    """dq as the bf16 tensor-core body computes it: s and dp from exact
    bf16 products in fp32, p = exp(s scale - lse) zeroed by the mask,
    ds = p (dp - delta) scale, then ds = hi + lo (two bf16 roundings) and
    dq = hi.k + lo.k, all sums fp32.  Arrays (B, H, S, D) / (B, KH, S, D)."""
    B, H, S, D = q.shape
    G = H // k.shape[1]
    scale = np.float32(1.0 / np.sqrt(D))
    kr = np.repeat(k, G, axis=1)
    vr = np.repeat(v, G, axis=1)
    pos = np.arange(S)
    m = np.ones((S, S), bool)
    if causal:
        m &= pos[None, :] <= pos[:, None]
    if window:
        m &= pos[None, :] > pos[:, None] - window
    s = np.einsum("bhqd,bhkd->bhqk", q, kr).astype(np.float32) * scale
    p = np.where(m, np.exp(np.where(m, s, -1e30) - lse[..., None]), 0.0)
    dp = np.einsum("bhqd,bhkd->bhqk", dout, vr).astype(np.float32)
    ds = (p * (dp - delta[..., None]) * scale).astype(np.float32)
    hi = _bf16_np(ds)
    lo = _bf16_np(ds - hi)
    return (np.einsum("bhqk,bhkd->bhqd", hi, kr)
            + np.einsum("bhqk,bhkd->bhqd", lo, kr)).astype(np.float32)


# SWEEP[:3] of tests/test_kernels_flash.py (the reference's gradient rows)
# and a GQA row with G=4, in bf16 as the tensor-core body takes them
DQ_ROWS = [
    (2, 4, 2, 128, 16, True, 0),
    (1, 4, 4, 64, 32, False, 0),
    (2, 8, 2, 128, 16, True, 48),
    (1, 8, 2, 128, 64, True, 0),
]


@pytest.mark.parametrize("B,H,KH,S,D,causal,window", DQ_ROWS)
def test_dq_with_split_ds_within_half_gate_of_reference(B, H, KH, S, D,
                                                        causal, window):
    rng = np.random.default_rng(B * 7 + H + KH + S + D)
    mk = lambda h: _bf16_np(rng.normal(size=(B, h, S, D)))
    q, k, v, dout = mk(H), mk(KH), mk(KH), mk(H)
    # lse and the fp32 output from the reference's forward on the same
    # (bf16-valued) inputs in fp32; delta from that output, as the port's
    # backward takes it
    out, lse = refK.flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window, bq=32, bk=32)
    out, lse = np.asarray(out), np.asarray(lse)
    delta = (dout * out).sum(-1).astype(np.float32)
    bf = lambda x: jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(refK.flash_dq(
        bf(q), bf(k), bf(v), bf(dout), jnp.asarray(lse), jnp.asarray(delta),
        causal=causal, window=window, bq=32, bk=32))
    got = _dq_split_model(q, k, v, dout, lse, delta, causal, window)
    tol = 5e-4 * max(1.0, float(np.abs(want).max()))
    assert np.isfinite(got).all() and got.shape == want.shape
    assert float(np.abs(got - want).max()) < HALF * tol
