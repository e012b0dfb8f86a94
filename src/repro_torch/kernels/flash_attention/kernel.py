"""Flash attention — hand-written CUDA kernels for the forward
(``csrc/flash_fwd.cu``: online softmax) and the backward
(``csrc/flash_bwd.cu``: dk/dv and dq), each with its plain PyTorch version.
bf16 inputs run tensor-core bodies (``csrc/flash_fwd_sm90.cuh``,
``csrc/flash_dkdv_sm90.cuh``, ``csrc/flash_dq_sm90.cuh``: wgmma on TMA-fed
tiles); fp32 inputs run the forward's 3xTF32 tensor-core body
(``csrc/flash_fwd_tf32_sm90.cuh``, head dims up to 80, its split operands
in scratch the wrapper allocates) and fp32-FMA bodies otherwise.

Layout: (B, H, S, D).  GQA is handled by index (kv head ``h // G``); no KV
repeat is ever materialised.  Causal / sliding-window tiles that are fully
masked are skipped (``_tile_live``), masked entries of a live tile are set
to ``NEG`` before the exponential and zeroed again after it
(``_tile_mask``).  The forward clamps ``l`` at 1e-30 and returns
``lse = m + log(l)``; the backward recomputes ``p = exp(s - lse)`` from it
and takes ``delta = sum(dout * out)`` from the caller.

Each wrapper launches its kernel for CUDA tensors (or raises) and takes the
plain version only for tensors that lie on the CPU.  ``bq/bk`` keep the
reference's clamping and divisibility contract, since they define the
modeled burst list (``ops.transactions``); the CUDA kernels use their own
tile, which changes the result only by fp32 rounding.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Tuple

import torch

from repro_torch._device import on_cpu as _on_cpu
from repro_torch._device import true_fp32
from repro_torch.kernels import _build

NEG = -1.0e30
_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (16, 32, 64, 80, 128)

# numbers of CUDA kernel launches made by ``flash_fwd``, ``flash_dkdv`` and
# ``flash_dq`` (plain integers; a caller that wants a per-run count sets
# them to 0 first)
launches = 0
dkdv_launches = 0
dq_launches = 0
_count_lock = threading.Lock()     # cells of a sweep launch from threads


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


@true_fp32()
def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int = 0, bq: int = 512,
                    bk: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in plain tensor ops: for every q block a
    sweep over the live kv blocks carrying ``m``, ``l`` and ``acc`` in
    fp32, batched over (B, KH, G).  Returns ``(out, lse)``."""
    B, H, KH, Sq, Skv, D, bq, bk = _shapes(q, k, v, bq, bk)
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


def _plain_bwd_inputs(q, k, v, dout, lse, delta):
    """Upcast operands grouped as (B, KH, G, S, ...) for the plain
    backward versions."""
    B, H, Sq, D = q.shape
    KH = k.shape[1]
    G = H // KH
    return (q.reshape(B, KH, G, Sq, D).float(), k.float(), v.float(),
            dout.reshape(B, KH, G, Sq, D).float(),
            lse.reshape(B, KH, G, Sq).float(),
            delta.reshape(B, KH, G, Sq).float())


def _probs_and_ds(qi, kj, vj, doi, li, di, mask, scale):
    """Recomputed ``p`` and ``ds`` of one (q block, kv block) tile,
    batched over (B, KH, G) — the common body of ``_dkdv_kernel`` and
    ``_dq_kernel``."""
    s = torch.einsum("bkgqd,bksd->bkgqs", qi, kj) * scale
    p = torch.exp(torch.where(mask, s, torch.full_like(s, NEG))
                  - li[..., None])
    p = torch.where(mask, p, torch.zeros_like(p))
    dp = torch.einsum("bkgqd,bksd->bkgqs", doi, vj)
    return p, p * (dp - di[..., None]) * scale


@true_fp32()
def flash_dkdv_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     dout: torch.Tensor, lse: torch.Tensor,
                     delta: torch.Tensor, *, causal: bool, window: int = 0,
                     bq: int = 512, bk: int = 512
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel's arithmetic in plain tensor ops: for every kv block
    a sweep over the live q blocks of all G query heads of its kv head,
    with dk and dv carried in fp32.  Returns fp32 ``(dk, dv)`` of shape
    (B, KH, Skv, D)."""
    B, H, KH, Sq, Skv, D, bq, bk = _shapes(q, k, v, bq, bk)
    scale = 1.0 / math.sqrt(D)
    qg, kf, vf, dog, lg, dg = _plain_bwd_inputs(q, k, v, dout, lse, delta)
    dk = torch.zeros((B, KH, Skv, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for j in range(Skv // bk):
        kj = kf[:, :, j * bk:(j + 1) * bk]
        vj = vf[:, :, j * bk:(j + 1) * bk]
        for i in range(Sq // bq):
            if not _tile_live(i, j, bq, bk, causal, window):
                continue
            rows = slice(i * bq, (i + 1) * bq)
            mask = _tile_mask(i, j, bq, bk, causal, window, q.device)
            p, ds = _probs_and_ds(qg[:, :, :, rows], kj, vj,
                                  dog[:, :, :, rows], lg[..., rows],
                                  dg[..., rows], mask, scale)
            dv[:, :, j * bk:(j + 1) * bk] += torch.einsum(
                "bkgqs,bkgqd->bksd", p, dog[:, :, :, rows])
            dk[:, :, j * bk:(j + 1) * bk] += torch.einsum(
                "bkgqs,bkgqd->bksd", ds, qg[:, :, :, rows])
    return dk, dv


@true_fp32()
def flash_dq_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   dout: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                   *, causal: bool, window: int = 0, bq: int = 512,
                   bk: int = 512) -> torch.Tensor:
    """The dq kernel's arithmetic in plain tensor ops: for every q block a
    sweep over the live kv blocks with dq carried in fp32.  Returns fp32
    ``dq`` of shape (B, H, Sq, D)."""
    B, H, KH, Sq, Skv, D, bq, bk = _shapes(q, k, v, bq, bk)
    scale = 1.0 / math.sqrt(D)
    qg, kf, vf, dog, lg, dg = _plain_bwd_inputs(q, k, v, dout, lse, delta)
    dq = torch.zeros_like(qg)
    for i in range(Sq // bq):
        rows = slice(i * bq, (i + 1) * bq)
        for j in range(Skv // bk):
            if not _tile_live(i, j, bq, bk, causal, window):
                continue
            kj = kf[:, :, j * bk:(j + 1) * bk]
            mask = _tile_mask(i, j, bq, bk, causal, window, q.device)
            _, ds = _probs_and_ds(qg[:, :, :, rows], kj,
                                  vf[:, :, j * bk:(j + 1) * bk],
                                  dog[:, :, :, rows], lg[..., rows],
                                  dg[..., rows], mask, scale)
            dq[:, :, :, rows] += torch.einsum("bkgqs,bksd->bkgqd", ds, kj)
    return dq.reshape(B, H, Sq, D)


_ARGTYPES = {
    # pointers ..., B, H, KH, Sq, Skv, D, causal, window, scale, is_bf16, stream
    "flash_fwd": [ctypes.c_void_p] * 6,
    "flash_dkdv": [ctypes.c_void_p] * 8,
    "flash_dq": [ctypes.c_void_p] * 7,
}
_LIB = {"flash_fwd": "flash_fwd", "flash_dkdv": "flash_bwd",
        "flash_dq": "flash_bwd"}


def _fn(name: str):
    fn = getattr(_build.load(_LIB[name]), name)
    if not fn.argtypes:
        # argtypes last: a thread that sees them sees the restype too
        fn.restype = ctypes.c_int
        fn.argtypes = (_ARGTYPES[name] + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def _fp32_fwd_scratch(B, H, KH, Sq, Skv, D, device):
    """The fp32 tensor-core forward's split operands (written by its
    pre-pass), or None where the fp32 body needs none (D = 128)."""
    fn = _build.load("flash_fwd").flash_fwd_scratch
    if not fn.argtypes:
        fn.restype = ctypes.c_longlong
        fn.argtypes = [ctypes.c_int] * 7
    n = fn(B, H, KH, Sq, Skv, D, 0)
    return torch.empty(n, dtype=torch.float32, device=device) if n else None


def _check_kernel_operands(name: str, D: int, window: int, *ts: torch.Tensor
                           ) -> None:
    """What every attention kernel refuses: q/k/v(/dout) of mixed or other
    types, head dims it is not built for, a negative window, strided
    tensors, and bf16 tensors whose data does not start on a 16-byte
    boundary (the tensor-core bodies copy tiles with TMA)."""
    if len({t.dtype for t in ts}) != 1 or ts[0].dtype not in _DTYPES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16 q/k/v of "
                        f"one type, got {[t.dtype for t in ts]}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"kernel is built for head dims {_HEAD_DIMS}, got {D}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("kernel takes contiguous (B,H,S,D) tensors")
    if ts[0].dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in ts):
        raise ValueError("bf16 kernel takes tensors whose data starts on a "
                         "16-byte boundary (TMA), got a misaligned view")


def _launch(name: str, ptrs, B, H, KH, Sq, Skv, D, causal, window, bf16,
            device) -> None:
    """Launch on the current stream of ``device`` (made the current device
    only if it is not already: the switch and the stream object cost more
    host time than a small kernel takes on the card)."""
    args = (*ptrs, B, H, KH, Sq, Skv, D, int(bool(causal)), int(window),
            1.0 / math.sqrt(D), int(bf16))
    if device.index == torch.cuda.current_device():
        err = _fn(name)(*args,
                        torch._C._cuda_getCurrentRawStream(device.index))
    else:
        with torch.cuda.device(device):
            err = _fn(name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch refused: CUDA error {err}")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, window: int = 0, bq: int = 512, bk: int = 512
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B,H,Sq,D); k/v (B,KH,Skv,D) -> (out (B,H,Sq,D) in q's dtype,
    lse (B,H,Sq) fp32).  CUDA tensors go through the hand-written kernel;
    CPU tensors through ``flash_fwd_plain``."""
    global launches
    B, H, KH, Sq, Skv, D, bq, bk = _shapes(q, k, v, bq, bk)
    if _on_cpu("flash_fwd", q, k, v):
        return flash_fwd_plain(q, k, v, causal=causal, window=window, bq=bq,
                               bk=bk)
    _check_kernel_operands("flash_fwd", D, window, q, k, v)
    bf16 = q.dtype == torch.bfloat16
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    scratch = None if bf16 else _fp32_fwd_scratch(B, H, KH, Sq, Skv, D,
                                                  q.device)
    _launch("flash_fwd", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), lse.data_ptr(),
                          scratch.data_ptr() if scratch is not None else None),
            B, H, KH, Sq, Skv, D, causal, window, bf16, q.device)
    with _count_lock:
        launches += 1
    return out, lse


def _bwd_operands(name, q, k, v, dout, lse, delta, window, bq, bk):
    B, H, KH, Sq, Skv, D, bq, bk = _shapes(q, k, v, bq, bk)
    if dout.shape != q.shape or lse.shape != (B, H, Sq) \
            or delta.shape != (B, H, Sq):
        raise ValueError(f"{name}: dout must be shaped like q {tuple(q.shape)} "
                         f"and lse/delta (B,H,Sq), got {tuple(dout.shape)}, "
                         f"{tuple(lse.shape)}, {tuple(delta.shape)}")
    cpu = _on_cpu(name, q, k, v, dout, lse, delta)
    if not cpu:
        _check_kernel_operands(name, D, window, q, k, v, dout)
        if lse.dtype != torch.float32 or delta.dtype != torch.float32 \
                or not (lse.is_contiguous() and delta.is_contiguous()):
            raise TypeError(f"{name}: lse and delta must be contiguous "
                            f"float32, got {lse.dtype}, {delta.dtype}")
    return cpu, (B, H, KH, Sq, Skv, D, bq, bk)


def flash_dkdv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               dout: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, *,
               causal: bool, window: int = 0, bq: int = 512, bk: int = 512
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q/dout (B,H,Sq,D); k/v (B,KH,Skv,D); lse/delta (B,H,Sq) fp32 ->
    fp32 (dk, dv) of shape (B,KH,Skv,D), summed over the G query heads of
    each kv head.  CUDA tensors go through the hand-written kernel; CPU
    tensors through ``flash_dkdv_plain``."""
    global dkdv_launches
    cpu, (B, H, KH, Sq, Skv, D, bq, bk) = _bwd_operands(
        "flash_dkdv", q, k, v, dout, lse, delta, window, bq, bk)
    if cpu:
        return flash_dkdv_plain(q, k, v, dout, lse, delta, causal=causal,
                                window=window, bq=bq, bk=bk)
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty_like(dk)
    _launch("flash_dkdv", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                           dk.data_ptr(), dv.data_ptr()),
            B, H, KH, Sq, Skv, D, causal, window, q.dtype == torch.bfloat16,
            q.device)
    with _count_lock:
        dkdv_launches += 1
    return dk, dv


def flash_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             dout: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, *,
             causal: bool, window: int = 0, bq: int = 512, bk: int = 512
             ) -> torch.Tensor:
    """Same operands as ``flash_dkdv`` -> fp32 dq (B,H,Sq,D).  CUDA tensors
    go through the hand-written kernel; CPU tensors through
    ``flash_dq_plain``."""
    global dq_launches
    cpu, (B, H, KH, Sq, Skv, D, bq, bk) = _bwd_operands(
        "flash_dq", q, k, v, dout, lse, delta, window, bq, bk)
    if cpu:
        return flash_dq_plain(q, k, v, dout, lse, delta, causal=causal,
                              window=window, bq=bq, bk=bk)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch("flash_dq", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                         dq.data_ptr()),
            B, H, KH, Sq, Skv, D, causal, window, q.dtype == torch.bfloat16,
            q.device)
    with _count_lock:
        dq_launches += 1
    return dq
