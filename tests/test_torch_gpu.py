"""The hand-written CUDA kernels on the card: each against its plain
PyTorch version and its oracle at the reference's test shapes.

These tests need an NVIDIA GPU and ``nvcc`` (a CUDA kernel has no
interpret mode); they carry the ``gpu`` marker and skip where there is no
card.  Run them on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

``python3 chip_smoke.py`` makes the same comparisons (and more shapes)
without pytest.  Tolerances are the reference's own: matmul 1e-4 (fp32) /
1.0 (bf16) times max(1, max|ref|); attention 2e-5 (fp32) / 3e-2 (bf16).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref as R
from repro_torch.kernels.systolic_matmul import kernel as MM
from repro_torch.kernels.systolic_matmul import ref as MMref

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


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    a = torch.ones(16, 16, device=card)
    with pytest.raises(TypeError):
        MM.matmul(a.half(), a.half())
    with pytest.raises(ValueError):
        MM.matmul(a.t(), a)                      # not contiguous
    q = torch.ones(1, 2, 32, 24, device=card)
    with pytest.raises(ValueError):
        K.flash_fwd(q, q, q, causal=True)        # head dim 24
