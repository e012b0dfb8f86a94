"""The hand-written CUDA kernels on the card: each against its plain
PyTorch version and its oracle at the reference's test shapes.

These tests need an NVIDIA GPU and ``nvcc`` (a CUDA kernel has no
interpret mode); they carry the ``gpu`` marker and skip where there is no
card.  Run them on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

``python3 chip_smoke.py`` makes the same comparisons (and more shapes)
without pytest.  Tolerances are the reference's own: matmul 1e-4 (fp32) /
1.0 (bf16) times max(1, max|ref|), the fp32 (3xTF32) body held to half of
it; attention 2e-5 (fp32) / 3e-2 (bf16);
attention gradients 5e-4 times max(1, max|plain|) (both sides take the
same upcast inputs and accumulate in fp32); the SSD and WKV-6 scans the
reference's 1e-3 times max(1, max|plain|).
"""
import numpy as np
import pytest
import torch

from repro_torch._tree import leaves, tree_map
from repro_torch.configs import get_config, smoke
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref as R
from repro_torch.kernels.mamba2_scan import kernel as SSD
from repro_torch.kernels.mamba2_scan import ops as SSDops
from repro_torch.kernels.mamba2_scan import ref as SSDref
from repro_torch.kernels.rwkv6_wkv import kernel as WKV
from repro_torch.kernels.rwkv6_wkv import ops as WKVops
from repro_torch.kernels.rwkv6_wkv import ref as WKVref
from repro_torch.kernels.systolic_matmul import kernel as MM
from repro_torch.kernels.systolic_matmul import ref as MMref
from repro_torch.launch.steps import make_train_state, make_train_step
from repro_torch.models.transformer import RunFlags
from repro_torch.optim.adamw import AdamWConfig

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("M,N,K,tile,dt", [
    (256, 128, 128, 64, torch.float32),
    (128, 256, 512, 64, torch.bfloat16),
    (128, 128, 128, 128, torch.float32),
    (160, 160, 160, 10, torch.float32),         # ragged for the CUDA tile
    (130, 70, 50, 10, torch.bfloat16),
])
def test_matmul_kernel_on_card(card, M, N, K, tile, dt):
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(card, dt)
    b = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32)).to(card, dt)
    before = MM.launches
    got = MM.matmul(a, b, bm=tile, bn=tile, bk=tile)
    torch.cuda.synchronize()
    assert MM.launches == before + 1
    ref = MMref.matmul_ref(a, b).float()
    plain = MM.matmul_plain(a, b, bm=tile, bn=tile, bk=tile).float()
    tol = (1e-4 if dt == torch.float32 else 1.0) * max(1.0, float(ref.abs().max()))
    assert float((got.float() - ref).abs().max()) < tol
    assert float((got.float() - plain).abs().max()) < tol


@pytest.mark.parametrize("B,H,KH,S,D,causal,window,dt", [
    (2, 4, 2, 128, 16, True, 0, torch.float32),
    (1, 4, 4, 64, 32, False, 0, torch.float32),
    (2, 8, 2, 128, 16, True, 48, torch.float32),
    (2, 4, 1, 256, 64, True, 0, torch.bfloat16),
    (1, 2, 2, 64, 128, True, 0, torch.bfloat16),
    (1, 2, 1, 96, 32, True, 8, torch.float32),  # ragged for the CUDA tile
    (1, 4, 2, 128, 80, True, 48, torch.float32),  # zamba2's head dim
    (1, 4, 4, 256, 80, True, 0, torch.bfloat16),
    # the tensor-core body at every head dim, ragged for its 128-row tiles
    (2, 4, 2, 128, 16, True, 0, torch.bfloat16),
    (1, 4, 4, 64, 32, False, 0, torch.bfloat16),
    (1, 4, 1, 160, 64, True, 0, torch.bfloat16),
    (1, 4, 2, 96, 80, True, 48, torch.bfloat16),
])
def test_flash_fwd_kernel_on_card(card, B, H, KH, S, D, causal, window, dt):
    rng = np.random.default_rng(3)
    mk = lambda h: torch.from_numpy(
        rng.normal(size=(B, h, S, D)).astype(np.float32)).to(card, dt)
    q, k, v = mk(H), mk(KH), mk(KH)
    before = K.launches
    out, lse = K.flash_fwd(q, k, v, causal=causal, window=window, bq=32, bk=32)
    torch.cuda.synchronize()
    assert K.launches == before + 1
    ref = R.attention_ref(q, k, v, causal=causal, window=window).float()
    p_out, p_lse = K.flash_fwd_plain(q, k, v, causal=causal, window=window,
                                     bq=32, bk=32)
    tol = 2e-5 if dt == torch.float32 else 3e-2
    assert float((out.float() - ref).abs().max()) < tol
    assert float((out.float() - p_out.float()).abs().max()) < tol
    assert torch.isfinite(lse).all()
    assert float((lse - p_lse).abs().max()) < 1e-4


@pytest.mark.parametrize("B,H,KH,Sq,Skv,D,causal,bq,bk", [
    (1, 16, 16, 1536, 1536, 128, True, 512, 512),     # moonshot-v1-16b-a3b
    (1, 32, 8, 1536, 1536, 128, True, 512, 512),      # the vlm's self attn
    (1, 32, 8, 1536, 1600, 128, False, 512, 400),     # its cross attention
    (2, 16, 16, 1536, 1536, 80, False, 512, 512),     # hubert-xlarge
    (1, 4, 2, 96, 40, 128, False, 32, 40),            # Skv < Sq, ragged
])
def test_flash_fwd_bf16_on_the_moe_vlm_audio_shapes(card, B, H, KH, Sq, Skv,
                                                    D, causal, bq, bk):
    """The bf16 tensor-core body at head dim 128, non-causal with
    Sq != Skv (kv lengths no multiple of its tiles), and at head dim 80
    non-causal: within 3e-2 of the plain version and the oracle, and
    element by element within one bf16 ulp of |plain out| and of
    sum_j p_j |v_j| (the plain version on |v|; p rounded to bf16 moves out
    by at most half that); lse within 1e-4 * max(1, |lse|)."""
    rng = np.random.default_rng(Sq + Skv + D)
    mk = lambda h, n: torch.from_numpy(rng.normal(size=(B, h, n, D)).astype(
        np.float32)).to(card, torch.bfloat16)
    q, k, v = mk(H, Sq), mk(KH, Skv), mk(KH, Skv)
    kw = dict(causal=causal, window=0, bq=bq, bk=bk)
    before = K.launches
    out, lse = K.flash_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert K.launches == before + 1
    assert out.shape == q.shape and lse.shape == (B, H, Sq)
    p_out, p_lse = K.flash_fwd_plain(q, k, v, **kw)
    ref = R.attention_ref(q, k, v, causal=causal).float()
    assert float((out.float() - ref).abs().max()) < 3e-2
    assert float((out.float() - p_out.float()).abs().max()) < 3e-2
    tol = 2.0 ** -7 * (p_out.float().abs()
                       + K.flash_fwd_plain(q, k, v.abs(), **kw)[0].float())
    assert bool(((out.float() - p_out.float()).abs() <= tol).all())
    assert bool(((out.float() - ref).abs() <= tol).all())
    assert float((lse - p_lse).abs().max()) < \
        1e-4 * max(1.0, float(p_lse.abs().max()))


@pytest.mark.parametrize("M,N,K,tile", [
    (100, 300, 250, 50),        # K no multiple of 8, M, N ragged for 128x128
    (64, 48, 4096, 16),         # long K, one C tile
    (257, 131, 77, 1),
])
def test_matmul_fp32_split_body_on_card(card, M, N, K, tile):
    """The fp32 body (split pre-pass + 3xTF32) at shapes its tiles do not
    divide, within half the fp32 gate (the rule that keeps it), and with an
    operand that starts 4 bytes past a 16-byte boundary: the pre-pass copies
    it, so it runs like any other."""
    rng = np.random.default_rng(6)
    a_np = rng.normal(size=(M, K)).astype(np.float32)
    b_np = rng.normal(size=(K, N)).astype(np.float32)
    a = torch.from_numpy(a_np).to(card)
    b = torch.from_numpy(b_np).to(card)
    a_off = torch.empty(M * K + 1, device=card)[1:].view(M, K)
    a_off.copy_(a)
    assert a_off.data_ptr() % 16 == 4 and a_off.is_contiguous()
    ref = MMref.matmul_ref(a, b).float()
    plain = MM.matmul_plain(a, b, bm=tile, bn=tile, bk=tile)
    tol = 1e-4 * max(1.0, float(ref.abs().max()))
    for x in (a, a_off):
        before = MM.launches
        got = MM.matmul(x, b, bm=tile, bn=tile, bk=tile)
        torch.cuda.synchronize()
        assert MM.launches == before + 1
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        assert float((got - ref).abs().max()) < 0.5 * tol
        assert float((got - plain).abs().max()) < 0.5 * tol
    got16 = MM.matmul(a, b, bm=tile, bn=tile, bk=tile,
                      out_dtype=torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    assert float((got16.float() - plain.bfloat16().float()).abs().max()) \
        <= 2 ** -7 * float(plain.abs().max())


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    a = torch.ones(16, 16, device=card)
    with pytest.raises(TypeError):
        MM.matmul(a.half(), a.half())
    with pytest.raises(ValueError):
        MM.matmul(a.t(), a)                      # not contiguous
    q = torch.ones(1, 2, 32, 24, device=card)
    with pytest.raises(ValueError):
        K.flash_fwd(q, q, q, causal=True)        # head dim 24
    before = K.launches
    # contiguous, but 2 bytes past a 16-byte boundary: TMA cannot copy it
    qm = torch.ones(2 * 32 * 64 + 1, device=card,
                    dtype=torch.bfloat16)[1:].view(1, 2, 32, 64)
    with pytest.raises(ValueError, match="16-byte"):
        K.flash_fwd(qm, qm, qm, causal=True)
    assert K.launches == before


BWD_ROWS = [
    # B, H, KH, S, D, causal, window, dtype: the reference's backward rows
    # (SWEEP[:3]), a GQA row with G=4, bf16 at the model's head dim, D=128,
    # and a length that is no multiple of the kernels' 64-row tile
    (2, 4, 2, 128, 16, True, 0, torch.float32),
    (1, 4, 4, 64, 32, False, 0, torch.float32),
    (2, 8, 2, 128, 16, True, 48, torch.float32),
    (1, 8, 2, 256, 64, True, 0, torch.float32),
    (2, 8, 2, 256, 64, True, 0, torch.bfloat16),
    (1, 2, 1, 128, 128, True, 0, torch.bfloat16),
    (1, 4, 1, 96, 32, True, 8, torch.float32),
    (1, 4, 2, 128, 80, True, 48, torch.float32),
    (1, 4, 4, 128, 80, True, 0, torch.bfloat16),
    # the dk/dv tensor-core body: the reference's rows in bf16, G=4, D=80
    # with a window, a ragged length
    (2, 4, 2, 128, 16, True, 0, torch.bfloat16),
    (1, 4, 4, 64, 32, False, 0, torch.bfloat16),
    (2, 8, 2, 128, 16, True, 48, torch.bfloat16),
    (1, 8, 2, 256, 64, True, 0, torch.bfloat16),
    (1, 4, 2, 128, 80, True, 48, torch.bfloat16),
    (1, 4, 1, 96, 32, True, 8, torch.bfloat16),
    # the dq tensor-core body: a length ragged for its 192-row q tile, D=128
    # with G=4 and a window, D=80 without a mask
    (1, 8, 2, 224, 64, True, 0, torch.bfloat16),
    (1, 8, 2, 160, 128, True, 32, torch.bfloat16),
    (1, 4, 2, 96, 80, False, 0, torch.bfloat16),
]


@pytest.mark.parametrize("B,H,KH,S,D,causal,window,dt", BWD_ROWS)
def test_flash_bwd_kernels_on_card(card, B, H, KH, S, D, causal, window, dt):
    rng = np.random.default_rng(4)
    mk = lambda h: torch.from_numpy(
        rng.normal(size=(B, h, S, D)).astype(np.float32)).to(card, dt)
    q, k, v, dout = mk(H), mk(KH), mk(KH), mk(H)
    blk = 32
    kw = dict(causal=causal, window=window, bq=blk, bk=blk)
    _, lse = K.flash_fwd(q, k, v, **kw)
    # delta from the fp32 output on the upcast inputs, which is what
    # autograd through the oracle sees (a bf16-rounded ``out`` would shift
    # every ds by its rounding)
    qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
    o = R.attention_ref(qf, kf, vf, causal=causal, window=window)
    delta = (dout.float() * o.detach()).sum(-1)
    b_dkdv, b_dq = K.dkdv_launches, K.dq_launches
    dk, dv = K.flash_dkdv(q, k, v, dout, lse, delta, **kw)
    dq = K.flash_dq(q, k, v, dout, lse, delta, **kw)
    torch.cuda.synchronize()
    assert (K.dkdv_launches, K.dq_launches) == (b_dkdv + 1, b_dq + 1)
    assert dk.dtype == dv.dtype == dq.dtype == torch.float32
    p_dk, p_dv = K.flash_dkdv_plain(q, k, v, dout, lse, delta, **kw)
    p_dq = K.flash_dq_plain(q, k, v, dout, lse, delta, **kw)
    # autograd through the oracle on the same (upcast) inputs
    a_dq, a_dk, a_dv = torch.autograd.grad(o, (qf, kf, vf), dout.float())
    for got, plain, auto in ((dq, p_dq, a_dq), (dk, p_dk, a_dk),
                             (dv, p_dv, a_dv)):
        assert torch.isfinite(got).all()
        tol = 5e-4 * max(1.0, float(plain.abs().max()))
        assert float((got - plain).abs().max()) < tol
        assert float((got - auto).abs().max()) < tol


def test_bf16_dq_counts_one_launch_per_call(card):
    """The bf16 dq route adds one to ``dq_launches`` per call and nothing to
    the other counts."""
    rng = np.random.default_rng(9)
    mk = lambda h: torch.from_numpy(rng.normal(
        size=(1, h, 128, 64)).astype(np.float32)).to(card, torch.bfloat16)
    q, k, v, dout = mk(8), mk(2), mk(2), mk(8)
    lse = torch.zeros(1, 8, 128, device=card)
    delta = torch.zeros(1, 8, 128, device=card)
    before = (K.launches, K.dkdv_launches, K.dq_launches)
    for n in (1, 2):
        K.flash_dq(q, k, v, dout, lse, delta, causal=True)
        torch.cuda.synchronize()
        assert (K.launches, K.dkdv_launches, K.dq_launches) == (
            before[0], before[1], before[2] + n)


def test_bwd_wrappers_refuse_what_the_kernels_do_not_take(card):
    q = torch.ones(1, 2, 64, 16, device=card)
    lse = torch.zeros(1, 2, 64, device=card)
    with pytest.raises(ValueError):
        K.flash_dq(q, q, q, q[:, :1], lse, lse, causal=True)  # dout shape
    with pytest.raises(TypeError):
        K.flash_dkdv(q, q, q, q.bfloat16(), lse, lse, causal=True)
    with pytest.raises(TypeError):
        K.flash_dq(q, q, q, q, lse.double(), lse, causal=True)
    before = (K.dkdv_launches, K.dq_launches)
    qm = torch.ones(2 * 64 * 16 + 1, device=card,
                    dtype=torch.bfloat16)[1:].view(1, 2, 64, 16)
    with pytest.raises(ValueError, match="16-byte"):
        K.flash_dkdv(qm, qm, qm, qm, lse, lse, causal=True)    # misaligned
    assert (K.dkdv_launches, K.dq_launches) == before


def test_train_step_on_card_matches_cpu(card):
    """One ``make_train_step`` at smoke(llama3.2-1b) size, fp32 compute,
    ``attn_impl="pallas"``: the card (kernels, 2L forward and L of each
    backward launch under remat) against the CPU (plain versions), from the
    same state and batch; loss and gradient norm within 1e-4 relative."""
    cfg = smoke(get_config("llama3.2-1b"))
    flags = RunFlags(attn_impl="pallas", compute_dtype="float32")
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=3)
    cpu_state = make_train_state(cfg, torch.Generator().manual_seed(2))
    gpu_state = tree_map(lambda t: t.detach().to(card).requires_grad_(
        t.requires_grad), cpu_state)
    rng = np.random.default_rng(2)
    b = {k: rng.integers(0, cfg.vocab_size, (2, 128)).astype(np.int32)
         for k in ("tokens", "labels")}
    step = make_train_step(cfg, flags, None, opt)
    _, want = step(cpu_state, {k: torch.from_numpy(v) for k, v in b.items()})
    before = (K.launches, K.dkdv_launches, K.dq_launches)
    new, got = step(gpu_state, {k: torch.from_numpy(v).to(card)
                                for k, v in b.items()})
    torch.cuda.synchronize()
    L = cfg.n_layers
    assert (K.launches, K.dkdv_launches, K.dq_launches) == (
        before[0] + 2 * L, before[1] + L, before[2] + L)
    for key in ("loss", "grad_norm", "lr"):
        assert abs(float(got[key]) - float(want[key])) <= 1e-4 * abs(
            float(want[key])), key
    assert all(torch.isfinite(p).all() and p.device.type == "cuda"
               for p in leaves(new["params"]))


def _scan_tol(*plain):
    return 1e-3 * max(1.0, max(float(t.abs().max()) for t in plain))


def _wkv_row(B, L, H, K, scale=1.0, id=None):
    return pytest.param(B, L, H, K, scale, id=id or f"{B}-{L}-{H}-{K}")


@pytest.mark.parametrize("B,L,H,K,scale", [
    _wkv_row(2, 64, 4, 16), _wkv_row(1, 32, 8, 32),  # the reference's rows
    _wkv_row(1, 100, 2, 128),               # ragged against the staged run
    _wkv_row(1, 512, 64, 64),               # rwkv6-7b's heads
    _wkv_row(1, 256, 64, 64),               # the shortest served prompt
    # w = exp(-exp(3 N(0,1))): from ~1 - 5e-5 down to 0, so the chunks'
    # decay products underflow while some channels barely decay
    _wkv_row(1, 300, 4, 64, 3.0, id="1-300-4-64-extreme-decays"),
])
def test_wkv_kernel_on_card(card, B, L, H, K, scale):
    rng = np.random.default_rng(8)
    g = lambda *sh: torch.from_numpy(
        rng.normal(size=sh).astype(np.float32)).to(card)
    r, k, v = g(B, L, H, K), g(B, L, H, K), g(B, L, H, K)
    w, u = torch.exp(-torch.exp(g(B, L, H, K) * scale)), g(H, K) * 0.5
    chunk = 16 if L % 16 == 0 else 4
    before = WKV.launches
    y, st = WKV.wkv_scan(r, k, v, w, u, chunk=chunk, hb=min(8, H))
    torch.cuda.synchronize()
    assert WKV.launches == before + 1
    py, pst = WKV.wkv_scan_plain(r, k, v, w, u, chunk=chunk, hb=min(8, H))
    oy, ost = WKVref.wkv_scan_ref(r, k, v, w, u)
    tol = _scan_tol(py, pst)
    for got, plain, oracle in ((y, py, oy), (st, pst, ost)):
        assert torch.isfinite(got).all()
        assert float((got - plain).abs().max()) < tol
        assert float((got - oracle).abs().max()) < tol


def test_wkv_kernel_takes_v_off_a_16_byte_boundary(card):
    """A contiguous v whose data starts 4 bytes past a 16-byte boundary is
    staged with 4-byte copies; r/k/w must be aligned (refused otherwise)."""
    B, L, H, K = 1, 100, 2, 64
    rng = np.random.default_rng(9)
    g = lambda *sh: torch.from_numpy(
        rng.normal(size=sh).astype(np.float32)).to(card)
    r, k, v = g(B, L, H, K), g(B, L, H, K), g(B, L, H, K)
    w, u = torch.exp(-torch.exp(g(B, L, H, K))), g(H, K) * 0.5
    v_off = torch.empty(v.numel() + 1, device=card)[1:].view_as(v)
    v_off.copy_(v)
    assert v_off.is_contiguous() and v_off.data_ptr() % 16 == 4
    y, st = WKV.wkv_scan(r, k, v_off, w, u, chunk=4, hb=1)
    py, pst = WKV.wkv_scan_plain(r, k, v, w, u, chunk=4, hb=1)
    tol = _scan_tol(py, pst)
    assert float((y - py).abs().max()) < tol
    assert float((st - pst).abs().max()) < tol


@pytest.mark.parametrize("B,L,H,P,N,chunk,dt", [
    (2, 64, 8, 16, 8, 16, torch.float32),   # the reference's test rows
    (1, 128, 4, 8, 16, 32, torch.float32),
    (1, 256, 8, 64, 64, 128, torch.bfloat16),   # zamba2-2.7b's head
    (2, 96, 3, 12, 20, 48, torch.float32),  # odd head count, chunk < 128
])
def test_ssd_kernel_on_card(card, B, L, H, P, N, chunk, dt):
    rng = np.random.default_rng(3)
    g = lambda *sh: torch.from_numpy(
        rng.normal(size=sh).astype(np.float32)).to(card)
    x, Bm, Cm = g(B, L, H, P).to(dt), g(B, L, N).to(dt), g(B, L, N).to(dt)
    dtt = torch.nn.functional.softplus(g(B, L, H))
    A, D = -torch.exp(g(H) * 0.5), g(H)
    before = SSD.launches
    y, st = SSD.ssd_scan(x, dtt, Bm, Cm, A, D, chunk=chunk, hb=1)
    torch.cuda.synchronize()
    assert SSD.launches == before + 1
    py, pst = SSD.ssd_scan_plain(x, dtt, Bm, Cm, A, D, chunk=chunk, hb=1)
    oy, ost = SSDref.ssd_scan_ref(x, dtt, Bm, Cm, A, D)
    tol = _scan_tol(py, pst)
    for got, plain, oracle in ((y, py, oy), (st, pst, ost)):
        assert torch.isfinite(got).all()
        assert float((got - plain).abs().max()) < tol
        assert float((got - oracle).abs().max()) < tol


def test_scan_wrappers_refuse_what_the_kernels_do_not_take(card):
    before = (WKV.launches, SSD.launches)
    r = torch.ones(1, 16, 2, 16, device=card)
    u = torch.ones(2, 16, device=card)
    with pytest.raises(RuntimeError, match="backward"):
        WKV.wkv_scan(r.clone().requires_grad_(), r, r, r, u)
    with pytest.raises(TypeError):
        WKV.wkv_scan(r.bfloat16(), r, r, r, u)
    with pytest.raises(ValueError):
        WKV.wkv_scan(*(torch.ones(1, 16, 2, 24, device=card),) * 4,
                     torch.ones(2, 24, device=card))          # head size 24
    x = torch.ones(1, 16, 2, 8, device=card)
    dt = torch.ones(1, 16, 2, device=card)
    bc = torch.ones(1, 16, 8, device=card)
    a = torch.ones(2, device=card)
    with pytest.raises(RuntimeError, match="backward"):
        SSD.ssd_scan(x.clone().requires_grad_(), dt, bc, bc, a, a, chunk=16)
    with pytest.raises(TypeError):
        SSD.ssd_scan(x.bfloat16(), dt, bc, bc, a, a, chunk=16)  # mixed types
    with pytest.raises(ValueError):
        SSD.ssd_scan(x, dt, bc, bc, a, a, chunk=2)            # chunk % 4
    assert (WKV.launches, SSD.launches) == before


@pytest.mark.parametrize("B,H,KH,S,D,causal,window", [
    (1, 4, 2, 200, 64, True, 0),        # ragged for the 128-row q tile
    (1, 4, 4, 100, 80, False, 0),       # zamba2's head dim, 32-row kv tiles
    (2, 8, 2, 160, 32, True, 24),       # GQA with a window
    (1, 2, 2, 64, 16, True, 0),         # one 16-float slab
    (1, 2, 1, 96, 128, True, 8),        # D = 128: the FMA body
])
def test_flash_fwd_fp32_tensor_core_body_on_card(card, B, H, KH, S, D, causal,
                                                 window):
    """The 3xTF32 body (D <= 80) within HALF the fp32 gate of the plain
    version and the oracle (the rule that keeps the split), lse within its
    gate; an operand 4 bytes past a 16-byte boundary runs too (the
    pre-pass reads it, TMA reads the split copies)."""
    rng = np.random.default_rng(12)
    mk = lambda h: torch.from_numpy(
        rng.normal(size=(B, h, S, D)).astype(np.float32)).to(card)
    q, k, v = mk(H), mk(KH), mk(KH)
    q_off = torch.empty(q.numel() + 1, device=card)[1:].view(q.shape)
    q_off.copy_(q)
    ref = R.attention_ref(q, k, v, causal=causal, window=window)
    p_out, p_lse = K.flash_fwd_plain(q, k, v, causal=causal, window=window,
                                     bq=S, bk=S)
    gate = 2e-5 * (0.5 if D <= 80 else 1.0)
    for qq in (q, q_off):
        before = K.launches
        out, lse = K.flash_fwd(qq, k, v, causal=causal, window=window, bq=S,
                               bk=S)
        torch.cuda.synchronize()
        assert K.launches == before + 1
        assert torch.isfinite(out).all() and torch.isfinite(lse).all()
        assert float((out - ref).abs().max()) < gate
        assert float((out - p_out).abs().max()) < gate
        assert float((lse - p_lse).abs().max()) < 1e-4 * max(
            1.0, float(p_lse.abs().max()))


@pytest.mark.parametrize("B,L,H,P,N,chunk,dt", [
    (1, 300, 6, 12, 20, 100, torch.float32),    # chunk no multiple of 16
    (2, 64, 5, 64, 8, 16, torch.bfloat16),      # H no multiple of 4, N < 16
    (1, 384, 6, 64, 64, 128, torch.bfloat16),   # zamba2's head, 3 chunks
    (1, 256, 4, 64, 64, 128, torch.float32),
])
def test_ssd_chunked_body_within_half_gate_on_card(card, B, L, H, P, N, chunk,
                                                   dt):
    """The three-launch body within HALF the gate (its fp32 operands are
    bf16 hi + lo pairs), one wrapper launch a call."""
    rng = np.random.default_rng(13)
    g = lambda *sh: torch.from_numpy(
        rng.normal(size=sh).astype(np.float32)).to(card)
    x, Bm, Cm = g(B, L, H, P).to(dt), g(B, L, N).to(dt), g(B, L, N).to(dt)
    dtt = torch.nn.functional.softplus(g(B, L, H))
    A, D = -torch.exp(g(H) * 0.5), g(H)
    before = SSD.launches
    y, st = SSD.ssd_scan(x, dtt, Bm, Cm, A, D, chunk=chunk, hb=1)
    torch.cuda.synchronize()
    assert SSD.launches == before + 1
    py, pst = SSD.ssd_scan_plain(x, dtt, Bm, Cm, A, D, chunk=chunk, hb=1)
    tol = _scan_tol(py, pst)
    for got, plain in ((y, py), (st, pst)):
        assert torch.isfinite(got).all()
        assert float((got - plain).abs().max()) < 0.5 * tol
    with pytest.raises(ValueError):
        SSD.ssd_scan(g(B, L, H, 68), dtt, Bm.float(), Cm.float(), A, D,
                     chunk=chunk)                            # P > 64


@pytest.mark.parametrize("scan", ["wkv", "ssd"])
def test_scan_wrappers_differentiate_on_card(card, scan):
    """Under autograd the wrappers launch the kernel on the forward and
    differentiate by recompute through the twin of the reference's lax
    scan: gradients equal autograd through that twin on the card."""
    rng = np.random.default_rng(14)
    g = lambda *sh: torch.from_numpy(
        rng.normal(size=sh).astype(np.float32)).to(card)
    if scan == "wkv":
        args = [g(1, 64, 4, 16), g(1, 64, 4, 16), g(1, 64, 4, 16),
                torch.exp(-torch.exp(g(1, 64, 4, 16))), g(4, 16) * 0.5]
        op, twin, mod, kw = WKVops.wkv_scan, WKVops.wkv_scan_twin, WKV, {}
    else:
        args = [g(1, 128, 4, 16), torch.nn.functional.softplus(g(1, 128, 4)),
                g(1, 128, 8), g(1, 128, 8), -torch.exp(g(4) * 0.5), g(4)]
        op, twin, mod, kw = SSDops.ssd_scan, SSDops.ssd_scan_twin, SSD, dict(
            chunk=32)
    grads = []
    for fn in (op, twin):
        ins = [a.clone().requires_grad_() for a in args]
        before = mod.launches
        y, st = fn(*ins, **kw)
        assert mod.launches == before + (fn is op)
        gy = torch.ones_like(y)
        grads.append(torch.autograd.grad((y * gy).sum() + st.sum(), ins))
    for a, b in zip(*grads):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 1e-4 * max(
            1.0, float(b.abs().max()))


def test_fuzz_bridge_and_registers_on_card_match_cpu(card):
    """The fuzzer's bridge layer launches B1 on the card (32-64 cubed, tile
    16); every fault trace, log and digest is value-free, so the card's run
    equals the CPU's scenario for scenario."""
    from repro_torch.core import ProtocolFuzzer
    before = MM.launches
    got = ProtocolFuzzer(seed=7, layers=("bridge", "registers"),
                         device=card).run(12)
    assert MM.launches > before
    want = ProtocolFuzzer(seed=7, layers=("bridge", "registers"),
                          device="cpu").run(12)
    assert got.passed and got.digest == want.digest
    assert got.summary() == want.summary()


@pytest.mark.parametrize("cell", ["matmul", "flash"])
def test_sharded_launch_on_card_bit_identical_to_one_device(card, cell):
    """Row-sharded B1 and head-sharded B2 on 1, 2 and 4 modeled devices of
    the one card: the gathered result bit-identical to the 1-device run,
    the fabric digest equal to the CPU run's."""
    from repro_torch.core import CongestionConfig, FabricCluster
    from repro_torch.kernels.flash_attention.sweep import (
        flash_backends, flash_fabric_firmware)
    from repro_torch.kernels.systolic_matmul.sweep import (
        matmul_backends, matmul_fabric_firmware)
    if cell == "matmul":
        fw, cfg, out = matmul_fabric_firmware, dict(size=256, tile=32), "c"
        table = lambda dev: matmul_backends(tile=32, device=dev)  # noqa: E731
    else:
        fw, cfg, out = flash_fabric_firmware, dict(heads=8, seq=256,
                                                   dim=64), "o"
        table = lambda dev: flash_backends(device=dev)            # noqa: E731

    def run(n, dev):
        fab = FabricCluster(n, congestion=CongestionConfig(dos_prob=0.05,
                                                           seed=7))
        fab.register_op("op", **table(dev))
        fw(fab, "op", "interpret", **cfg)
        return fab

    one = run(1, card).outputs()[out]
    for n in (1, 2, 4):
        fab = run(n, card)
        assert np.array_equal(fab.outputs()[out], one), n
        assert fab.digest() == run(n, "cpu").digest()


def test_campaign_pool_on_card_equals_in_process(card, tmp_path):
    """A run-farm campaign of sweep units (B1 at 64 and 128, tile 16 and
    32) and one bridge-layer fuzz unit on the card: a 2-worker spawned
    pool gives the in-process lane's final digest, per-unit digests and
    merged coverage (a sweep digest hashes B1's output bytes, so the
    workers ran the same kernel to the same bits)."""
    from repro_torch.runfarm import CampaignManager, fuzz_units, sweep_units
    units = sweep_units(seed=3, configs=[{"size": 64, "tile": 16},
                                         {"size": 128, "tile": 32}],
                        configs_per_unit=1) + fuzz_units(
        seed=5, n_scenarios=3, batch=3, layers=("bridge",),
        bridge_ops=[2, 4], start_index=2)
    before = MM.launches
    seq = CampaignManager(tmp_path / "w0", units, seed=3,
                          device=card).run()
    assert MM.launches > before
    pool = CampaignManager(tmp_path / "w2", units, seed=3, workers=2,
                           device=card).run()
    assert seq.passed and pool.passed
    assert pool.digest == seq.digest
    assert {u: pool.records[u]["digest"] for u in pool.uids} == \
        {u: seq.records[u]["digest"] for u in seq.uids}
    assert pool.coverage.counts == seq.coverage.counts
