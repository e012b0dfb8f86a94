"""The arithmetic of the port's split-precision tensor-core bodies against
the JAX reference, on the CPU.

Four CUDA bodies trade one product in a wide type for several in a narrow
one (the kernels themselves run only on the card, where chip_smoke.py and
tests/test_torch_gpu.py hold them against their plain versions):

* the fp32 matmul (csrc/systolic_matmul_sm90.cuh) splits each operand into
  TF32 words x = hi + lo and sums three TF32 products (3xTF32);
* the bf16 attention dq (csrc/flash_dq_sm90.cuh) carries dS as a bf16 pair
  hi + lo and multiplies K twice;
* the fp32 attention forward (csrc/flash_fwd_tf32_sm90.cuh) runs S = Q K^T
  and each kv tile's P V as 3xTF32, the tile's P V added to the running
  output in fp32 (the promotion);
* the SSD scan (csrc/ssd_scan.cu) multiplies on bf16 tensor cores, its
  fp32 operands (M, the weighted x, the incoming state; x, B and C too
  when they are fp32) as bf16 pairs hi + lo.

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
from repro.kernels.mamba2_scan import kernel as refSSD
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


def _split_tf32(x):
    hi = _tf32_np(x)
    return hi, _tf32_np(x - hi)


def _mm3(a, b):
    """a @ b over the last two axes as the 3xTF32 bodies run it: lo.hi +
    hi.lo + hi.hi, each product of TF32 words exact in fp32, fp32 sums."""
    ah, al = _split_tf32(a)
    bh, bl = _split_tf32(b)
    return (al @ bh + ah @ bl + ah @ bh).astype(np.float32)


def _flash_fwd_3xtf32_model(q, k, v, causal, window, bkv):
    """The fp32 tensor-core forward: S by 3xTF32, the online softmax over
    kv tiles of ``bkv`` (64, or 32 at D = 80), each tile's P V by 3xTF32
    into a fresh sum added to the rescaled output in fp32; l clamped at
    1e-30, lse = m + log l.  Arrays (B, H, S, D) / (B, KH, S, D)."""
    B, H, S, D = q.shape
    G = H // k.shape[1]
    kr = np.repeat(k, G, axis=1)
    vr = np.repeat(v, G, axis=1)
    scale = np.float32(1.0 / np.sqrt(D))
    s = _mm3(q, np.swapaxes(kr, -1, -2)) * scale
    pos = np.arange(S)
    mask = np.ones((S, S), bool)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    m = np.full((B, H, S, 1), -1e30, np.float32)
    l = np.zeros((B, H, S, 1), np.float32)
    o = np.zeros((B, H, S, D), np.float32)
    for j0 in range(0, S, bkv):
        mk = mask[:, j0:j0 + bkv]
        st = np.where(mk, s[..., j0:j0 + bkv], np.float32(-1e30))
        m_new = np.maximum(m, st.max(-1, keepdims=True))
        p = np.where(mk, np.exp(st - m_new), 0).astype(np.float32)
        corr = np.exp(m - m_new).astype(np.float32)
        l = l * corr + p.sum(-1, keepdims=True)
        o = o * corr + _mm3(p, vr[:, :, j0:j0 + bkv])
        m = m_new
    lc = np.maximum(l, np.float32(1e-30))
    return (o / lc).astype(np.float32), (m + np.log(lc))[..., 0]


# the reference's fp32 forward rows (SWEEP of tests/test_kernels_flash.py),
# a ragged length with a window, and zamba2's head dim
FWD32_ROWS = [
    (2, 4, 2, 128, 16, True, 0),
    (1, 4, 4, 64, 32, False, 0),
    (2, 8, 2, 128, 16, True, 48),
    (1, 2, 1, 96, 32, True, 8),
    (1, 4, 2, 128, 80, True, 48),
]


@pytest.mark.parametrize("B,H,KH,S,D,causal,window", FWD32_ROWS)
def test_fp32_forward_3xtf32_within_half_gate_of_reference(B, H, KH, S, D,
                                                          causal, window):
    rng = np.random.default_rng(B * 5 + H + KH + S + D)
    mk = lambda h: rng.normal(size=(B, h, S, D)).astype(np.float32)
    q, k, v = mk(H), mk(KH), mk(KH)
    want, want_lse = refK.flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    window=window, bq=32, bk=32)
    want, want_lse = np.asarray(want), np.asarray(want_lse)
    got, lse = _flash_fwd_3xtf32_model(q, k, v, causal, window,
                                       32 if D >= 80 else 64)
    assert np.isfinite(got).all() and got.shape == want.shape
    assert float(np.abs(got - want).max()) < HALF * 2e-5
    assert float(np.abs(lse - want_lse).max()) < HALF * 1e-4 * max(
        1.0, float(np.abs(want_lse).max()))


def test_fp32_forward_one_tf32_rounding_misses_half_gate():
    """Why the fp32 forward splits: one TF32 rounding of q, k, p and v
    (products exact, sums fp32) is outside half the 2e-5 gate at the
    coverify_flash width (D = 64), the three-product split is not."""
    rng = np.random.default_rng(9)
    q, k, v = (rng.normal(size=(1, 4, 256, 64)).astype(np.float32)
               for _ in range(3))
    want, _ = refK.flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, window=0, bq=32, bk=32)
    want = np.asarray(want)
    t = _tf32_np
    s = (t(q) @ np.swapaxes(t(k), -1, -2)) / np.float32(8.0)
    mask = np.tril(np.ones((256, 256), bool))
    s = np.where(mask, s, -1e30)
    p = np.where(mask, np.exp(s - s.max(-1, keepdims=True)), 0)
    one = (t(p.astype(np.float32)) @ t(v)) / p.sum(-1, keepdims=True)
    three, _ = _flash_fwd_3xtf32_model(q, k, v, True, 0, 64)
    assert float(np.abs(one - want).max()) > HALF * 2e-5
    assert float(np.abs(three - want).max()) < HALF * 2e-5


def _pair(x):
    """x as bf16 hi + lo (the kernel's pairs): hi, lo as fp32 values."""
    hi = _bf16_np(x)
    return hi, _bf16_np(x - hi)


def _mmb(a, b, a_pair=True, b_pair=False):
    """a @ b on bf16 tensor cores as the SSD body runs it: an fp32 operand
    as hi + lo (a_pair / b_pair), a bf16 one exact; lo.hi + hi.lo + hi.hi
    of what is split, products exact in fp32, fp32 sums."""
    ah, al = _pair(a) if a_pair else (_bf16_np(a), 0.0 * a)
    bh, bl = _pair(b) if b_pair else (_bf16_np(b), 0.0 * b)
    out = ah @ bh
    if a_pair:
        out = out + al @ bh
    if b_pair:
        out = out + ah @ bl
    return out.astype(np.float32)


def _ssd_split_model(x, dt, Bm, Cm, A, D, cl, fp32_inputs):
    """The SSD body's arithmetic, chunk by chunk: C B^T, M = C B^T exp(seg)
    dt on the causal triangle, y = exp(cum) (C state_in^T) + M x + D x,
    the chunk's own state (x w)^T B added to the decayed running state;
    x, B, C exact (bf16 values) or hi + lo pairs (fp32 inputs)."""
    Bz, L, H, P = x.shape
    st = np.zeros((Bz, H, P, Bm.shape[-1]), np.float32)
    y = np.zeros((Bz, L, H, P), np.float32)
    f = fp32_inputs
    tri = np.tril(np.ones((cl, cl), bool))
    for c in range(L // cl):
        r = slice(c * cl, (c + 1) * cl)
        xc, dc, bc, cc = x[:, r], dt[:, r], Bm[:, r], Cm[:, r]
        cum = np.cumsum(dc * A, axis=1).astype(np.float32)      # (B,cl,H)
        cb = _mmb(cc, np.swapaxes(bc, 1, 2), f, f)               # (B,cl,cl)
        seg = cum[:, :, None, :] - cum[:, None, :, :]
        M = np.where(tri[None, :, :, None],
                     cb[..., None] * np.exp(np.where(tri[None, :, :, None],
                                                     seg, 0))
                     * dc[:, None, :, :], 0).astype(np.float32)
        Mh = np.moveaxis(M, 3, 1)                                # (B,H,i,j)
        xh = np.moveaxis(xc, 2, 1)                               # (B,H,j,P)
        intra = _mmb(Mh, xh, True, f)
        inter = _mmb(cc[:, None], np.swapaxes(st, -1, -2), f, True)
        yc = np.exp(np.moveaxis(cum, 2, 1))[..., None] * inter + intra
        y[:, r] = np.moveaxis(yc, 1, 2) + D[None, None, :, None] * xc
        w = dc * np.exp(cum[:, -1:] - cum)
        xw = np.moveaxis(xc * w[..., None], 2, 1)                # (B,H,j,P)
        own = _mmb(np.swapaxes(xw, -1, -2), bc[:, None], True, f)
        st = st * np.exp(cum[:, -1])[..., None, None] + own
    return y, st


@pytest.mark.parametrize("inputs", ["fp32", "bf16"])
@pytest.mark.parametrize("B,L,H,P,N,chunk", [(2, 64, 8, 16, 8, 16),
                                             (1, 128, 4, 8, 16, 32)])
def test_ssd_bf16_pairs_within_half_gate_of_reference(B, L, H, P, N, chunk,
                                                     inputs):
    """The reference's test rows (tests/test_kernels_misc.py), with fp32
    inputs and with bf16-valued x, B, C (as served), against the
    reference's Pallas kernel in interpret mode on the same values."""
    rng = np.random.default_rng(L + H + P + N)
    x = rng.normal(size=(B, L, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.normal(size=(B, L, H)), 0).astype(np.float32)
    Bm = rng.normal(size=(B, L, N)).astype(np.float32)
    Cm = rng.normal(size=(B, L, N)).astype(np.float32)
    A = (-np.exp(rng.normal(size=(H,)) * 0.5)).astype(np.float32)
    D = np.ones((H,), np.float32)
    if inputs == "bf16":
        x, Bm, Cm = _bf16_np(x), _bf16_np(Bm), _bf16_np(Cm)
    want_y, want_st = refSSD.ssd_scan(*map(jnp.asarray, (x, dt, Bm, Cm, A, D)),
                                      chunk=chunk, hb=min(8, H))
    want_y, want_st = np.asarray(want_y), np.asarray(want_st)
    got_y, got_st = _ssd_split_model(x, dt, Bm, Cm, A, D, chunk,
                                     inputs == "fp32")
    tol = 1e-3 * max(1.0, float(np.abs(want_y).max()),
                     float(np.abs(want_st).max()))
    assert np.isfinite(got_y).all() and got_y.shape == want_y.shape
    assert float(np.abs(got_y - want_y).max()) < HALF * tol
    assert float(np.abs(got_st - want_st).max()) < HALF * tol
