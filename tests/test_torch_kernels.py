"""The port's two kernel packages vs the JAX reference, on the CPU.

Inputs are made with numpy from a seed and handed to both sides.  The JAX
side runs as its own tests run it here: the Pallas kernels in interpret
mode.  The port side is called with CPU tensors, where each wrapper takes
its kernel's plain PyTorch version (the CUDA kernels themselves are held
against these plain versions on the card by chip_smoke.py).

Tolerances are the reference's own (tests/test_kernels_misc.py,
tests/test_kernels_flash.py): matmul 1e-4 (fp32) / 1.0 (bf16) times
max(1, max|ref|); attention 2e-5 (fp32) / 3e-2 (bf16) absolute; attention
gradients 5e-4 absolute (fp32, as the reference tests them).  Both
sides accumulate in fp32 but sum in different orders, and bf16 rounds the
final cast, hence not bit-for-bit.  ``transactions()`` carries no values
and must be equal tuple for tuple.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as refK
from repro.kernels.flash_attention import ops as ref_fa_ops
from repro.kernels.flash_attention import ref as refR
from repro.kernels.systolic_matmul import kernel as refMM
from repro.kernels.systolic_matmul import ops as ref_mm_ops
from repro.kernels.systolic_matmul import ref as refMMref
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as R
from repro_torch.kernels.systolic_matmul import kernel as MM
from repro_torch.kernels.systolic_matmul import ops as mm_ops
from repro_torch.kernels.systolic_matmul import ref as MMref

torch.set_num_threads(1)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(arr: np.ndarray, dt: str):
    """The same fp32 numpy data as a JAX array and a CPU tensor of ``dt``
    (both round to bf16 to nearest-even, so the operands are identical)."""
    return jnp.asarray(arr).astype(JDT[dt]), torch.from_numpy(arr).to(TDT[dt])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


MM_ROWS = [
    (256, 128, 128, 64, "float32"),
    (128, 256, 512, 64, "bfloat16"),
    (128, 128, 128, 128, "float32"),
]


@pytest.mark.parametrize("fn", ["matmul_plain", "ops.matmul", "matmul_ref"])
@pytest.mark.parametrize("M,N,K,bm,dt", MM_ROWS)
def test_matmul_matches_reference(M, N, K, bm, dt, fn):
    rng = np.random.default_rng(5)
    a_np = rng.normal(size=(M, K)).astype(np.float32)
    b_np = rng.normal(size=(K, N)).astype(np.float32)
    (ja, ta), (jb, tb) = _pair(a_np, dt), _pair(b_np, dt)
    want = _np(refMM.matmul(ja, jb, bm=bm, bn=bm, bk=bm))
    oracle = _np(refMMref.matmul_ref(ja, jb))
    if fn == "matmul_plain":
        got = MM.matmul_plain(ta, tb, bm=bm, bn=bm, bk=bm)
    elif fn == "ops.matmul":
        got = mm_ops.matmul(ta, tb, bm=bm, bn=bm, bk=bm)
    else:
        got = MMref.matmul_ref(ta, tb)
    assert got.dtype == TDT[dt] and tuple(got.shape) == (M, N)
    tol = (1e-4 if dt == "float32" else 1.0) * max(1.0, np.abs(oracle).max())
    assert np.abs(_np(got) - want).max() < tol
    assert np.abs(_np(got) - oracle).max() < tol


def test_matmul_out_dtype_and_ragged_blocks():
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.normal(size=(60, 90)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(90, 30)).astype(np.float32))
    got = mm_ops.matmul(a.bfloat16(), b.bfloat16(), bm=20, bn=10, bk=30,
                        out_dtype=torch.float32)
    assert got.dtype == torch.float32
    want = a.bfloat16().float() @ b.bfloat16().float()
    assert (got - want).abs().max() < 1e-4 * max(1.0, want.abs().max())
    # blocks larger than the matrix clamp; blocks that do not divide assert
    mm_ops.matmul(a, b, bm=512, bn=512, bk=512)
    with pytest.raises(AssertionError):
        mm_ops.matmul(a, b, bm=50, bn=10, bk=30)


def test_matmul_launch_count_untouched_on_cpu():
    before = MM.launches
    mm_ops.matmul(torch.ones(8, 8), torch.ones(8, 8))
    assert MM.launches == before


SWEEP = [
    # B, H, KH, S, D, causal, window, dtype
    (2, 4, 2, 128, 16, True, 0, "float32"),
    (1, 4, 4, 64, 32, False, 0, "float32"),
    (2, 8, 2, 128, 16, True, 48, "float32"),
    (2, 4, 1, 256, 64, True, 0, "bfloat16"),
    (1, 2, 2, 64, 128, True, 0, "bfloat16"),
]


def _qkv(B, H, KH, S, D, dt):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(B, H, S, D)).astype(np.float32)
    k = rng.normal(size=(B, KH, S, D)).astype(np.float32)
    v = rng.normal(size=(B, KH, S, D)).astype(np.float32)
    return _pair(q, dt), _pair(k, dt), _pair(v, dt)


@pytest.mark.parametrize("fn", ["flash_fwd_plain", "flash_fwd"])
@pytest.mark.parametrize("B,H,KH,S,D,causal,window,dt", SWEEP)
def test_flash_fwd_matches_reference(B, H, KH, S, D, causal, window, dt, fn):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, H, KH, S, D, dt)
    want_out, want_lse = refK.flash_fwd(jq, jk, jv, causal=causal,
                                        window=window, bq=32, bk=32)
    out, lse = getattr(K, fn)(tq, tk, tv, causal=causal, window=window,
                              bq=32, bk=32)
    assert out.dtype == TDT[dt] and lse.dtype == torch.float32
    assert tuple(out.shape) == (B, H, S, D) and tuple(lse.shape) == (B, H, S)
    tol = 2e-5 if dt == "float32" else 3e-2
    assert np.abs(_np(out) - _np(want_out)).max() < tol
    # lse is fp32 on both sides whatever the input type
    assert np.abs(lse.numpy() - np.asarray(want_lse)).max() < 2e-5 * max(
        1.0, np.abs(np.asarray(want_lse)).max())
    assert np.isfinite(lse.numpy()).all()


@pytest.mark.parametrize("B,H,KH,S,D,causal,window,dt", SWEEP)
def test_attention_ref_matches_reference(B, H, KH, S, D, causal, window, dt):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, H, KH, S, D, dt)
    want = refR.attention_ref(jq, jk, jv, causal=causal, window=window)
    got = R.attention_ref(tq, tk, tv, causal=causal, window=window)
    plain, _ = K.flash_fwd_plain(tq, tk, tv, causal=causal, window=window,
                                 bq=32, bk=32)
    tol = 2e-5 if dt == "float32" else 3e-2
    assert got.dtype == TDT[dt]
    assert np.abs(_np(got) - _np(want)).max() < tol
    assert np.abs(_np(got) - _np(plain)).max() < tol


def test_flash_fwd_wholly_masked_rows_in_live_tile():
    """Window smaller than a tile: live tiles hold rows with no visible
    key, where m stays NEG and exp(s - m) = 1 — p must be zeroed by the
    mask, as in the reference body."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 2, 2, 128, 16, "float32")
    want, want_lse = refK.flash_fwd(jq, jk, jv, causal=True, window=8,
                                    bq=32, bk=32)
    out, lse = K.flash_fwd(tq, tk, tv, causal=True, window=8, bq=32, bk=32)
    assert np.abs(_np(out) - _np(want)).max() < 2e-5
    assert np.abs(lse.numpy() - np.asarray(want_lse)).max() < 2e-5
    # block sizes change the result only by rounding
    out64, _ = K.flash_fwd(tq, tk, tv, causal=True, window=8, bq=64, bk=16)
    assert (out - out64).abs().max() < 2e-5


def test_tile_predicates_match_reference():
    for causal in (False, True):
        for window in (0, 8, 48):
            for i in range(4):
                for j in range(4):
                    live = bool(refK._tile_live(i, j, 32, 16, causal, window))
                    mask = np.asarray(refK._tile_mask(i, j, 32, 16, causal,
                                                      window))
                    assert K._tile_live(i, j, 32, 16, causal, window) == live
                    got = K._tile_mask(i, j, 32, 16, causal, window, "cpu")
                    assert np.array_equal(got.numpy(), mask)
                    assert live == bool(mask.any())


def test_flash_attention_model_layout_matches_reference():
    rng = np.random.default_rng(9)
    q = rng.normal(size=(2, 64, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 64, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 64, 2, 16)).astype(np.float32)
    want = ref_fa_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=True, window=0,
                                      bq=32, bk=32)
    got = fa_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=True, window=0,
                                 bq=32, bk=32)
    assert tuple(got.shape) == (2, 64, 4, 16)
    assert np.abs(got.numpy() - np.asarray(want)).max() < 2e-5


def test_flash_attention_refuses_requires_grad():
    """(Name kept from the forward-only slice, which refused such inputs.)
    Inputs that require a gradient are accepted now and get one: the
    backward runs through ``flash_dkdv`` / ``flash_dq`` (their plain
    versions on CPU tensors) and only the inputs that asked for a gradient
    receive one, in their own dtype."""
    rng = np.random.default_rng(10)
    mk = lambda h: torch.from_numpy(rng.normal(size=(1, 32, h, 16))
                                    .astype(np.float32))
    q, kv = mk(2).requires_grad_(), mk(2)
    out = fa_ops.flash_attention(q, kv, kv, bq=16, bk=16)
    assert out.requires_grad
    (gq,) = torch.autograd.grad(out.square().sum(), (q,))
    qr = q.detach().requires_grad_()
    want = R.attention_ref(qr.transpose(1, 2), kv.transpose(1, 2),
                           kv.transpose(1, 2), causal=True).transpose(1, 2)
    (wq,) = torch.autograd.grad(want.square().sum(), (qr,))
    assert gq.dtype == q.dtype and (gq - wq).abs().max() < 5e-4
    k = kv.bfloat16().requires_grad_()
    out = fa_ops.flash_attention(q.detach().bfloat16(), k, kv.bfloat16())
    (gk,) = torch.autograd.grad(out.float().sum(), (k,))
    assert gk.dtype == torch.bfloat16 and torch.isfinite(gk.float()).all()


# the reference's gradient rows (SWEEP[:3]) and a GQA row with G = 4
BWD_SWEEP = SWEEP[:3] + [(1, 8, 2, 64, 16, True, 0, "float32")]


def _model_layout_inputs(B, H, KH, S, D):
    rng = np.random.default_rng(11)
    return [rng.normal(size=(B, S, h, D)).astype(np.float32)
            for h in (H, KH, KH)]


@pytest.mark.parametrize("B,H,KH,S,D,causal,window,dt", BWD_SWEEP)
def test_flash_backward_matches_reference(B, H, KH, S, D, causal, window, dt):
    """The port's ``ops.flash_attention`` under autograd against the
    reference's under ``jax.grad`` (Pallas in interpret mode), for the
    reference's own loss ``sum(out^2)``."""
    arrs = _model_layout_inputs(B, H, KH, S, D)
    kw = dict(causal=causal, window=window, bq=32, bk=32)

    def f_ref(q, k, v):
        return (ref_fa_ops.flash_attention(q, k, v, **kw).astype(jnp.float32)
                ** 2).sum()

    want = jax.grad(f_ref, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    out = fa_ops.flash_attention(*ts, **kw)
    got = torch.autograd.grad(out.float().square().sum(), ts)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g.numpy() - np.asarray(w)).max() < 5e-4


@pytest.mark.parametrize("B,H,KH,S,D,causal,window,dt", BWD_SWEEP)
def test_flash_bwd_plain_matches_autograd_of_oracle(B, H, KH, S, D, causal,
                                                    window, dt):
    """``flash_dkdv_plain`` / ``flash_dq_plain`` (the kernels' arithmetic)
    against autograd through the port's own oracle, and the wrappers' CPU
    route equal to them."""
    q, k, v = (torch.from_numpy(a).transpose(1, 2).contiguous()
               for a in _model_layout_inputs(B, H, KH, S, D))
    dout = torch.from_numpy(np.random.default_rng(12).normal(
        size=q.shape).astype(np.float32))
    kw = dict(causal=causal, window=window, bq=32, bk=32)
    out, lse = K.flash_fwd_plain(q, k, v, **kw)
    delta = (dout * out).sum(-1)
    dk, dv = K.flash_dkdv_plain(q, k, v, dout, lse, delta, **kw)
    dq = K.flash_dq_plain(q, k, v, dout, lse, delta, **kw)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    o = R.attention_ref(qa, ka, va, causal=causal, window=window)
    want = torch.autograd.grad(o, (qa, ka, va), dout)
    for g, w in zip((dq, dk, dv), want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert (g - w).abs().max() < 5e-4 * max(1.0, float(g.abs().max()))
    wk, wv = K.flash_dkdv(q, k, v, dout, lse, delta, **kw)
    assert torch.equal(wk, dk) and torch.equal(wv, dv)
    assert torch.equal(K.flash_dq(q, k, v, dout, lse, delta, **kw), dq)
    # the modeled blocks change the result only by rounding
    dq16 = K.flash_dq_plain(q, k, v, dout, lse, delta, causal=causal,
                            window=window, bq=16, bk=64)
    assert (dq16 - dq).abs().max() < 1e-5 * max(1.0, float(dq.abs().max()))


def test_bwd_launch_counts_untouched_on_cpu():
    q = torch.ones(1, 2, 32, 16)
    lse = torch.zeros(1, 2, 32)
    K.flash_dkdv(q, q, q, q, lse, lse, causal=True)
    K.flash_dq(q, q, q, q, lse, lse, causal=True)
    assert K.dkdv_launches == 0 and K.dq_launches == 0


def test_plain_versions_and_oracles_leave_tf32_switch_alone():
    """A plain version or oracle switches TF32 off only while it runs and
    restores the caller's setting."""
    q = torch.ones(1, 2, 32, 16)
    lse = torch.zeros(1, 2, 32)
    a = torch.ones(16, 16)
    calls = [lambda: MM.matmul_plain(a, a), lambda: MMref.matmul_ref(a, a),
             lambda: K.flash_fwd_plain(q, q, q, causal=True),
             lambda: R.attention_ref(q, q, q, causal=True),
             lambda: K.flash_dkdv_plain(q, q, q, q, lse, lse, causal=True),
             lambda: K.flash_dq_plain(q, q, q, q, lse, lse, causal=True)]
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        for setting in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = setting
            for call in calls:
                call()
                assert torch.backends.cuda.matmul.allow_tf32 is setting
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.parametrize("M,N,K,bm,bn,bk,nb", [
    (256, 128, 128, 64, 64, 64, 2),
    (160, 160, 160, 10, 10, 10, 4),
    (96, 64, 32, 32, 16, 8, 4),
    (64, 64, 64, 128, 128, 128, 2),         # blocks clamp to the dims
    (100, 60, 50, 30, 25, 20, 4),           # ragged: trailing part dropped
])
def test_matmul_transactions_equal(M, N, K, bm, bn, bk, nb):
    want = ref_mm_ops.transactions(M, N, K, bm=bm, bn=bn, bk=bk,
                                   dtype_bytes=nb)
    got = mm_ops.transactions(M, N, K, bm=bm, bn=bn, bk=bk, dtype_bytes=nb)
    assert got == want and len(got) > 0
    assert mm_ops.transactions(M, N, K) == ref_mm_ops.transactions(M, N, K)


@pytest.mark.parametrize("B,H,Sq,Sk,D,bq,bk,causal,nb", [
    (1, 8, 64, 64, 16, 32, 32, True, 4),
    (2, 4, 128, 128, 32, 32, 64, False, 2),
    (1, 2, 128, 256, 64, 64, 32, True, 2),
    (1, 2, 64, 64, 128, 512, 512, True, 4),     # blocks clamp to the dims
    (1, 3, 100, 90, 16, 32, 40, True, 4),       # ragged tiles
    (1, 3, 100, 90, 16, 32, 40, False, 2),
])
def test_flash_transactions_equal(B, H, Sq, Sk, D, bq, bk, causal, nb):
    want = ref_fa_ops.transactions(B, H, Sq, Sk, D, bq=bq, bk=bk,
                                   causal=causal, dtype_bytes=nb)
    got = fa_ops.transactions(B, H, Sq, Sk, D, bq=bq, bk=bk, causal=causal,
                              dtype_bytes=nb)
    assert got == want and len(got) > 0
    assert (fa_ops.transactions(B, H, Sq, Sk, D)
            == ref_fa_ops.transactions(B, H, Sq, Sk, D))


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        MM.matmul(torch.ones(2, 3, 4), torch.ones(4, 2))
    with pytest.raises(AssertionError):
        MM.matmul(torch.ones(4, 3), torch.ones(4, 2))
    q = torch.ones(1, 4, 32, 16)
    with pytest.raises(ValueError):
        K.flash_fwd(q, torch.ones(1, 3, 32, 16), torch.ones(1, 3, 32, 16),
                    causal=True)
    with pytest.raises(AssertionError):
        K.flash_fwd(torch.ones(1, 4, 48, 16), torch.ones(1, 4, 48, 16),
                    torch.ones(1, 4, 48, 16), causal=True, bq=32, bk=32)
    lse = torch.zeros(1, 4, 32)
    with pytest.raises(ValueError):                 # dout not shaped like q
        K.flash_dq(q, q, q, q[:, :2], lse, lse, causal=True)
    with pytest.raises(ValueError):                 # lse not (B, H, Sq)
        K.flash_dkdv(q, q, q, q, lse[:, :2], lse, causal=True)


# zamba2-2.7b's attention head dim (80 = 5 x 16), fp32 and bf16, causal with
# a window, GQA
D80_ROWS = [(1, 4, 2, 128, 80, True, 48, "float32"),
            (1, 4, 4, 64, 80, True, 0, "bfloat16")]


@pytest.mark.parametrize("B,H,KH,S,D,causal,window,dt", D80_ROWS)
def test_head_dim_80_forward_matches_reference(B, H, KH, S, D, causal,
                                               window, dt):
    """The kernels are built for D=80 (``_HEAD_DIMS``, one more template
    instance per dispatch in flash_fwd.cu / flash_bwd.cu); the wrapper's
    CPU route and the plain version match the reference's Pallas kernel
    there, as at the other head dims."""
    assert 80 in K._HEAD_DIMS
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, H, KH, S, D, dt)
    want_out, want_lse = refK.flash_fwd(jq, jk, jv, causal=causal,
                                        window=window, bq=32, bk=32)
    out, lse = K.flash_fwd(tq, tk, tv, causal=causal, window=window, bq=32,
                           bk=32)
    plain, _ = K.flash_fwd_plain(tq, tk, tv, causal=causal, window=window,
                                 bq=64, bk=32)
    tol = 2e-5 if dt == "float32" else 3e-2
    assert np.abs(_np(out) - _np(want_out)).max() < tol
    assert np.abs(_np(plain) - _np(want_out)).max() < tol
    assert np.abs(lse.numpy() - np.asarray(want_lse)).max() < 2e-5 * max(
        1.0, np.abs(np.asarray(want_lse)).max())


def test_head_dim_80_backward_matches_reference():
    """``ops.flash_attention`` under autograd at D=80 against the
    reference's under ``jax.grad`` (the backward plain versions on CPU)."""
    arrs = _model_layout_inputs(1, 4, 2, 64, 80)
    kw = dict(causal=True, window=48, bq=32, bk=32)

    def f_ref(q, k, v):
        return (ref_fa_ops.flash_attention(q, k, v, **kw).astype(jnp.float32)
                ** 2).sum()

    want = jax.grad(f_ref, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    got = torch.autograd.grad(
        fa_ops.flash_attention(*ts, **kw).float().square().sum(), ts)
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() < 5e-4


def test_build_target_follows_included_headers(tmp_path, monkeypatch):
    """A kernel library's name hashes its source and every ``csrc/`` header
    it includes, directly or through another header: editing ``sm90.cuh``
    (included by the attention and matmul sources through their
    ``*_sm90.cuh``, and by the SSD scan directly) renames those four
    libraries and no other; a file that no source includes renames
    nothing.  Nothing is compiled."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")

    def targets():
        return {n: _build._target(n)[1] for n in _build.sources()}

    before = targets()
    assert {"flash_fwd", "flash_bwd", "ssd_scan"} <= set(before)
    assert all(p.parent == tmp_path / "build" for p in before.values())
    hdr = csrc / "sm90.cuh"
    hdr.write_text(hdr.read_text() + "\n// an edit\n")
    after = targets()
    changed = {n for n in before if before[n] != after[n]}
    assert changed == {"flash_fwd", "flash_bwd", "systolic_matmul",
                       "ssd_scan"}
    (csrc / "notes.txt").write_text("not a source")
    (csrc / "unused.cuh").write_text("// included by nothing\n")
    assert targets() == after
    assert not (tmp_path / "build").exists()
