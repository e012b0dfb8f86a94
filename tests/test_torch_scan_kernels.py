"""The port's SSD (Mamba-2) and WKV-6 (RWKV-6) scan kernels vs the JAX
reference, on the CPU.

Inputs are made with numpy from a seed and handed to both sides.  The JAX
side runs as its own tests run it here (the Pallas kernels in interpret
mode, tests/test_kernels_misc.py); the port side is called with CPU
tensors, where ``ssd_scan`` / ``wkv_scan`` take their kernels' plain
PyTorch versions (the CUDA kernels themselves are held against these plain
versions on the card by chip_smoke.py and tests/test_torch_gpu.py).

Tolerances are the reference's own: 1e-3 absolute for both scans against
the Pallas kernels and the oracles, 1e-4 between the WKV-6 kernel route and
the model's ``_wkv_chunk``.  ``transactions()`` carries no values and must
be equal tuple for tuple.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba2_scan import kernel as refSSD
from repro.kernels.mamba2_scan import ops as ref_ssd_ops
from repro.kernels.mamba2_scan import ref as refSSDref
from repro.kernels.rwkv6_wkv import kernel as refWKV
from repro.kernels.rwkv6_wkv import ops as ref_wkv_ops
from repro.kernels.rwkv6_wkv import ref as refWKVref
from repro.models import mamba2 as ref_mamba2
from repro.models import rwkv6 as ref_rwkv6
from repro_torch.configs import get_config, smoke
from repro_torch.kernels.mamba2_scan import kernel as S
from repro_torch.kernels.mamba2_scan import ops as ssd_ops
from repro_torch.kernels.mamba2_scan import ref as Sref
from repro_torch.kernels.rwkv6_wkv import kernel as W
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.kernels.rwkv6_wkv import ref as Wref
from repro_torch.models import mamba2, rwkv6

torch.set_num_threads(1)

SSD_ROWS = [(2, 64, 8, 16, 8, 16), (1, 128, 4, 8, 16, 32)]   # B,L,H,P,N,chunk
WKV_ROWS = [(2, 64, 4, 16), (1, 32, 8, 32)]                  # B,L,H,K


def _ssd_inputs(B, L, H, P, N, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.normal(size=(B, L, H)), 0).astype(np.float32)
    Bm = rng.normal(size=(B, L, N)).astype(np.float32)
    Cm = rng.normal(size=(B, L, N)).astype(np.float32)
    A = (-np.exp(rng.normal(size=(H,)) * 0.5)).astype(np.float32)
    D = np.ones((H,), np.float32)
    return x, dt, Bm, Cm, A, D


def _wkv_inputs(B, L, H, K, seed=8):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, L, H, K)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.normal(size=(B, L, H, K)))).astype(np.float32)
    u = (rng.normal(size=(H, K)) * 0.5).astype(np.float32)
    return r, k, v, w, u


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("fn", ["ssd_scan_plain", "ops.ssd_scan",
                                "ssd_scan_ref"])
@pytest.mark.parametrize("B,L,H,P,N,chunk", SSD_ROWS)
def test_ssd_scan_matches_reference(B, L, H, P, N, chunk, fn):
    arrs = _ssd_inputs(B, L, H, P, N)
    want_y, want_st = refSSD.ssd_scan(*map(jnp.asarray, arrs), chunk=chunk,
                                      hb=4)
    oracle_y, _ = refSSDref.ssd_scan_ref(*map(jnp.asarray, arrs))
    if fn == "ssd_scan_plain":
        y, st = S.ssd_scan_plain(*_t(arrs), chunk=chunk, hb=4)
    elif fn == "ops.ssd_scan":
        y, st = ssd_ops.ssd_scan(*_t(arrs), chunk=chunk, hb=4)
    else:
        y, st = Sref.ssd_scan_ref(*_t(arrs))
    assert y.dtype == st.dtype == torch.float32
    assert tuple(y.shape) == (B, L, H, P) and tuple(st.shape) == (B, H, P, N)
    assert np.abs(y.numpy() - np.asarray(want_y)).max() < 1e-3
    assert np.abs(st.numpy() - np.asarray(want_st)).max() < 1e-3
    assert np.abs(y.numpy() - np.asarray(oracle_y)).max() < 1e-3


@pytest.mark.parametrize("fn", ["wkv_scan_plain", "ops.wkv_scan",
                                "wkv_scan_ref"])
@pytest.mark.parametrize("B,L,H,K", WKV_ROWS)
def test_wkv_scan_matches_reference(B, L, H, K, fn):
    arrs = _wkv_inputs(B, L, H, K)
    want_y, want_st = refWKV.wkv_scan(*map(jnp.asarray, arrs), chunk=16,
                                      hb=4)
    oracle_y, _ = refWKVref.wkv_scan_ref(*map(jnp.asarray, arrs))
    if fn == "wkv_scan_plain":
        y, st = W.wkv_scan_plain(*_t(arrs), chunk=16, hb=4)
    elif fn == "ops.wkv_scan":
        y, st = wkv_ops.wkv_scan(*_t(arrs), chunk=16, hb=4)
    else:
        y, st = Wref.wkv_scan_ref(*_t(arrs))
    assert y.dtype == st.dtype == torch.float32
    assert tuple(y.shape) == (B, L, H, K) and tuple(st.shape) == (B, H, K, K)
    assert np.abs(y.numpy() - np.asarray(want_y)).max() < 1e-3
    assert np.abs(st.numpy() - np.asarray(want_st)).max() < 1e-3
    assert np.abs(y.numpy() - np.asarray(oracle_y)).max() < 1e-3


def test_ssd_scan_bf16_inputs_upcast_as_the_reference():
    """bf16 x/B/C (the model's bf16 compute route): both sides upcast the
    same bf16 values and keep fp32 maths."""
    arrs = list(_ssd_inputs(1, 64, 8, 16, 8, seed=4))
    for i in (0, 2, 3):
        arrs[i] = np.array(jnp.asarray(arrs[i]).astype(jnp.bfloat16)
                             .astype(jnp.float32))
    want_y, want_st = refSSD.ssd_scan(*map(jnp.asarray, arrs), chunk=32, hb=8)
    ts = _t(arrs)
    for i in (0, 2, 3):
        ts[i] = ts[i].bfloat16()
    y, st = S.ssd_scan_plain(*ts, chunk=32, hb=8)
    assert np.abs(y.numpy() - np.asarray(want_y)).max() < 1e-3
    assert np.abs(st.numpy() - np.asarray(want_st)).max() < 1e-3


def test_wkv_kernel_route_matches_model_chunk():
    """The model's per-chunk recurrence (``_wkv_chunk``, the reference's
    lax twin) and the kernel route agree — the reference's
    ``test_model_wkv_matches_kernel_path`` at its 1e-4."""
    B, c, H, K = 2, 16, 4, 16
    r, k, v, w, u = _t(_wkv_inputs(B, c, H, K, seed=13))
    st_m, y_m = rwkv6._wkv_chunk(torch.zeros(B, H, K, K), r, k, v, w, u)
    y_k, st_k = W.wkv_scan_plain(r, k, v, w, u, chunk=16, hb=4)
    assert (y_m - y_k).abs().max() < 1e-4
    assert (st_m - st_k).abs().max() < 1e-4
    # and the port's _wkv_chunk equals the reference's
    ref_st, ref_y = ref_rwkv6._wkv_chunk(
        jnp.zeros((B, H, K, K)), *map(jnp.asarray, (r.numpy(), k.numpy(),
                                                    v.numpy(), w.numpy(),
                                                    u.numpy())))
    assert np.abs(y_m.numpy() - np.asarray(ref_y)).max() < 1e-5
    assert np.abs(st_m.numpy() - np.asarray(ref_st)).max() < 1e-5


def test_time_mix_routes_agree():
    """``time_mix`` with no state (the kernel route of prefill) against the
    same call from a zero state (the chunked route of decode)."""
    cfg = smoke(get_config("rwkv6-7b"))
    w = rwkv6.rwkv6_init(torch.Generator().manual_seed(0), cfg,
                         torch.float32)["tmix"]
    x = torch.randn(2, 32, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    shift = torch.zeros(2, 1, cfg.d_model)
    zero = torch.zeros(2, cfg.n_heads, cfg.rwkv.head_size,
                       cfg.rwkv.head_size)
    before = W.launches
    y0, sh0, st0 = rwkv6.time_mix(w, x, cfg, shift, None)
    y1, sh1, st1 = rwkv6.time_mix(w, x, cfg, shift, zero)
    assert W.launches == before          # CPU tensors: plain version only
    assert (y0 - y1).abs().max() < 1e-5 and (st0 - st1).abs().max() < 1e-5
    assert torch.equal(sh0, sh1)


def _close(got, want, tol) -> bool:
    """Within ``tol`` times max(1, max|want|): the state grows over the
    chunks, fp32 sums in another order."""
    w = np.asarray(want)
    return np.abs(got.numpy() - w).max() < tol * max(1.0, np.abs(w).max())


def test_ssd_kernel_route_matches_model_chunk():
    """The model's per-chunk SSD (``_ssd_chunk``, the reference's lax twin)
    scanned from a zero state plus the D skip — what the reference's
    ``mamba2_forward`` computes — against the kernel route, which adds the
    skip itself; and the port's ``_ssd_chunk`` against the reference's."""
    B, L, H, P, N, cl = 2, 64, 4, 8, 16, 16
    arrs = _ssd_inputs(B, L, H, P, N, seed=14)
    arrs[5][:] = np.linspace(0.5, 1.5, H)                 # D != 1
    x, dt, Bm, Cm, A, D = _t(arrs)
    state, ys = torch.zeros(B, H, P, N), []
    rstate, rys = jnp.zeros((B, H, P, N)), []
    for c in range(L // cl):
        rows = slice(c * cl, (c + 1) * cl)
        state, yc = mamba2._ssd_chunk(state, x[:, rows], dt[:, rows], A,
                                      Bm[:, rows], Cm[:, rows])
        rstate, ryc = ref_mamba2._ssd_chunk(
            rstate, *(jnp.asarray(a[:, rows]) for a in (arrs[0], arrs[1])),
            jnp.asarray(arrs[4]), *(jnp.asarray(a[:, rows])
                                    for a in (arrs[2], arrs[3])))
        assert _close(yc, ryc, 1e-5)
        ys.append(yc)
    y_m = torch.cat(ys, dim=1) + D[None, None, :, None] * x
    assert _close(state, rstate, 1e-5)
    y_k, st_k = S.ssd_scan_plain(x, dt, Bm, Cm, A, D, chunk=cl, hb=4)
    assert (y_m - y_k).abs().max() < 1e-4
    assert (state - st_k).abs().max() < 1e-4


@pytest.mark.parametrize("args,kw", [
    ((2, 256, 16, 32, 64), dict(chunk=128, hb=8)),        # test_scheduler
    ((1, 1536, 80, 64, 64), dict(chunk=128, hb=8)),       # zamba2 prefill
    ((2, 64, 8, 16, 8), dict(chunk=16, hb=4, dtype_bytes=2)),
    ((1, 100, 3, 8, 8), dict(chunk=128, hb=8)),           # chunk/hb clamp
])
def test_ssd_transactions_equal(args, kw):
    want = ref_ssd_ops.transactions(*args, **kw)
    assert ssd_ops.transactions(*args, **kw) == want and len(want) > 0


@pytest.mark.parametrize("args,kw", [
    ((2, 64, 16, 32), dict(chunk=16, hb=8)),              # test_scheduler
    ((1, 1536, 64, 64), dict(chunk=16, hb=8)),            # rwkv6 prefill
    ((2, 64, 4, 16, 32), dict(chunk=32, hb=2, dtype_bytes=2)),
    ((1, 20, 3, 8), dict(chunk=16, hb=8)),
])
def test_wkv_transactions_equal(args, kw):
    want = ref_wkv_ops.transactions(*args, **kw)
    assert wkv_ops.transactions(*args, **kw) == want and len(want) > 0


def test_ssd_shared_memory_at_served_width():
    """The kernel's operand tiles are sized for its largest chunk, P and N,
    which are zamba2-2.7b's served width (chunk 128, P = N = 64): a block
    of its output launch holds 73,728 bytes for bf16 operands (three
    blocks on one SM's 228 KB) and 131,072 for fp32 ones (their lo halves
    too, four heads a block), within the 227 KB a block may opt into on
    sm_90."""
    assert (S.CHUNK_MAX, S.P_MAX, S.N_MAX) == (128, 64, 64)
    assert S.smem_bytes(False) == 73728 and 3 * S.smem_bytes(False) <= 233472
    assert S.smem_bytes(True) == 131072 <= S.SMEM_MAX


def test_scan_wrappers_contract():
    """Launch counts stay untouched on the CPU; a tensor on another device
    never reaches a plain version; shapes and the chunk / head-block
    contract are checked before either route.  The scans are dispatcher
    ops (``repro_torch::wkv_scan`` / ``ssd_scan``) since the dry run: a
    meta tensor, which used to be refused, now gets the op's output shapes
    (its shape function; no kernel, no plain version runs), and operands
    on different devices are refused."""
    r, k, v, w, u = _t(_wkv_inputs(1, 32, 4, 16))
    W.wkv_scan(r, k, v, w, u)
    x, dt, Bm, Cm, A, D = _t(_ssd_inputs(1, 32, 8, 8, 8))
    S.ssd_scan(x, dt, Bm, Cm, A, D, chunk=16)
    assert W.launches == 0 and S.launches == 0
    meta = torch.ones(1, 32, 4, 16, device="meta")
    y, st = W.wkv_scan(meta, meta, meta, meta,
                       torch.ones(4, 16, device="meta"))
    assert y.is_meta and tuple(y.shape) == (1, 32, 4, 16)
    assert st.is_meta and tuple(st.shape) == (1, 4, 16, 16)
    assert W.launches == 0
    with pytest.raises(ValueError, match="different devices"):
        W.wkv_scan(meta, k, v, w, u)
    with pytest.raises(ValueError):
        W.wkv_scan(r, k, v, w, u[:2])                      # u not (H,K)
    with pytest.raises(ValueError):
        S.ssd_scan(x, dt[:, :16], Bm, Cm, A, D)            # dt not (B,L,H)
    with pytest.raises(AssertionError):
        S.ssd_scan(x, dt, Bm, Cm, A, D, chunk=24)          # 24 does not divide 32
    with pytest.raises(AssertionError):
        W.wkv_scan(r, k, v, w, u, chunk=16, hb=3)          # 3 does not divide 4
    # the dispatcher ops check shapes themselves, on every route
    wkv, ssd = torch.ops.repro_torch.wkv_scan, torch.ops.repro_torch.ssd_scan
    for dev in ("cpu", "meta"):
        r_, k_, v_, w_, u_ = (t.to(dev) for t in (r, k, v, w, u))
        for bad in ((r_, k_[:, :16], v_, w_, u_), (r_, k_, v_[..., :8], w_, u_),
                    (r_, k_, v_, w_[:, :, :2], u_), (r_, k_, v_, w_, u_[:2])):
            with pytest.raises(ValueError):
                wkv(*bad, 16, 8)
        x_, dt_, B_, C_, A_, D_ = (t.to(dev) for t in (x, dt, Bm, Cm, A, D))
        with pytest.raises(ValueError):
            ssd(x_, dt_[:, :16], B_, C_, A_, D_, 16, 8)
    assert W.launches == 0 and S.launches == 0
