"""Flash-attention forward (online softmax) — hand-written CUDA kernel
(``csrc/flash_fwd.cu``) with its plain PyTorch version.

Layout: (B, H, S, D).  GQA is handled by index (kv head ``h // G``); no KV
repeat is ever materialised.  Causal / sliding-window tiles that are fully
masked are skipped (``_tile_live``), masked entries of a live tile are set
to ``NEG`` before the running max and zeroed again after the exponential
(``_tile_mask``), ``l`` is clamped at 1e-30 and ``lse = m + log(l)``.

``flash_fwd`` launches the kernel for CUDA tensors (or raises) and takes
``flash_fwd_plain`` only for tensors that lie on the CPU.  ``bq/bk`` keep
the reference's clamping and divisibility contract, since they define the
modeled burst list (``ops.transactions``); the CUDA kernel uses its own
tile, which changes the result only by fp32 rounding.  The backward
kernels (dk/dv and dq) are not ported yet.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels import _build

NEG = -1.0e30
_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (16, 32, 64, 128)

# number of CUDA kernel launches made by ``flash_fwd`` (plain integer; a
# caller that wants a per-run count sets it to 0 first)
launches = 0


def _tile_mask(i: int, j: int, bq: int, bk: int, causal: bool, window: int,
               device) -> torch.Tensor:
    """(bq, bk) bool mask for q block i, kv block j (positions are arange)."""
    qpos = i * bq + torch.arange(bq, device=device)[:, None]
    kpos = j * bk + torch.arange(bk, device=device)[None, :]
    m = torch.ones((bq, bk), dtype=torch.bool, device=device)
    if causal:
        m = m & (kpos <= qpos)
    if window:
        m = m & (kpos > qpos - window)
    return m


def _tile_live(i: int, j: int, bq: int, bk: int, causal: bool,
               window: int) -> bool:
    """Does tile (i, j) contain any unmasked element?"""
    live = True
    if causal:
        live = live and (j * bk <= i * bq + bq - 1)
    if window:
        live = live and ((j + 1) * bk - 1 > i * bq - window)
    return live


def _shapes(q, k, v, bq: int, bk: int):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_fwd takes q (B,H,Sq,D) and k/v (B,KH,Skv,D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Sq, D = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % KH:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do "
                         f"not match (batch, head dim, KH | H)")
    bq = min(bq, Sq)
    bk = min(bk, Skv)
    assert Sq % bq == 0 and Skv % bk == 0
    return B, H, KH, Sq, Skv, D, bq, bk


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int = 0, bq: int = 512,
                    bk: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in plain tensor ops: for every q block a
    sweep over the live kv blocks carrying ``m``, ``l`` and ``acc`` in
    fp32, batched over (B, KH, G).  Returns ``(out, lse)``."""
    B, H, KH, Sq, Skv, D, bq, bk = _shapes(q, k, v, bq, bk)
    torch.backends.cuda.matmul.allow_tf32 = False
    G = H // KH
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    qg = q.reshape(B, KH, G, Sq, D).float()
    kf, vf = k.float(), v.float()
    out = torch.empty((B, KH, G, Sq, D), dtype=torch.float32, device=dev)
    lse = torch.empty((B, KH, G, Sq), dtype=torch.float32, device=dev)
    for i in range(Sq // bq):
        qi = qg[:, :, :, i * bq:(i + 1) * bq]
        m_s = torch.full((B, KH, G, bq, 1), NEG, dtype=torch.float32,
                         device=dev)
        l_s = torch.zeros_like(m_s)
        acc = torch.zeros((B, KH, G, bq, D), dtype=torch.float32, device=dev)
        for j in range(Skv // bk):
            if not _tile_live(i, j, bq, bk, causal, window):
                continue
            kj = kf[:, :, j * bk:(j + 1) * bk]
            vj = vf[:, :, j * bk:(j + 1) * bk]
            s = torch.einsum("bkgqd,bksd->bkgqs", qi, kj) * scale
            mask = _tile_mask(i, j, bq, bk, causal, window, dev)
            s = torch.where(mask, s, torch.full_like(s, NEG))
            m_new = torch.maximum(m_s, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            p = torch.where(mask, p, torch.zeros_like(p))
            corr = torch.exp(m_s - m_new)
            l_s = l_s * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + torch.einsum("bkgqs,bksd->bkgqd", p, vj)
            m_s = m_new
        l = torch.clamp(l_s, min=1e-30)
        out[:, :, :, i * bq:(i + 1) * bq] = acc / l
        lse[:, :, :, i * bq:(i + 1) * bq] = (m_s + torch.log(l))[..., 0]
    return out.reshape(B, H, Sq, D).to(q.dtype), lse.reshape(B, H, Sq)


def _fn():
    fn = _build.load("flash_fwd").flash_fwd
    if not fn.argtypes:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, window: int = 0, bq: int = 512, bk: int = 512
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B,H,Sq,D); k/v (B,KH,Skv,D) -> (out (B,H,Sq,D) in q's dtype,
    lse (B,H,Sq) fp32).  CUDA tensors go through the hand-written kernel;
    CPU tensors through ``flash_fwd_plain``."""
    global launches
    B, H, KH, Sq, Skv, D, bq, bk = _shapes(q, k, v, bq, bk)
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v on different devices")
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal=causal, window=window, bq=bq,
                               bk=bk)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda or cpu tensors, not {q.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16 q/k/v of one type, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"kernel is built for head dims {_HEAD_DIMS}, got {D}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("kernel takes contiguous (B,H,S,D) tensors")
    fn = _fn()
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), B, H, KH, Sq, Skv, D, int(bool(causal)),
                 int(window), 1.0 / math.sqrt(D),
                 int(q.dtype == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch refused: CUDA error {err}")
    launches += 1
    return out, lse
