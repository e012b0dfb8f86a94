"""The Mamba-2 SSD chunked scan — a hand-written CUDA kernel
(``csrc/ssd_scan.cu``) and its plain PyTorch version.

Layout: x (B, L, H, P) and B_/C_ (B, L, N) of one type (fp32 or bf16),
dt (B, L, H), A/D (H,) fp32; results y (B, L, H, P) fp32 — the ``D`` skip
included — and the final state (B, H, P, N) fp32, from a zero state.
``ssd_scan`` launches the kernel for CUDA tensors (or raises) and takes
``ssd_scan_plain`` only for tensors that lie on the CPU.  ``chunk`` sets
the chunk length of the chunked arithmetic on both routes; ``hb`` keeps
the reference's head-block contract, which defines the modeled burst list
(``ops.transactions``) and nothing numeric.  The kernel has no backward
(neither has the reference's): CUDA inputs that require a gradient are
refused.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch._device import on_cpu, true_fp32
from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)
SMEM_MAX = 232448        # bytes of shared memory a block may opt into

# number of CUDA kernel launches made by ``ssd_scan`` (a plain integer; a
# caller that wants a per-run count sets it to 0 first)
launches = 0


def _shapes(x, dt, B_, C_, A, D, chunk: int, hb: int):
    if x.dim() != 4:
        raise ValueError(f"ssd_scan takes x (B,L,H,P), got {tuple(x.shape)}")
    Bsz, L, H, P = x.shape
    N = B_.shape[-1]
    if (tuple(dt.shape) != (Bsz, L, H) or tuple(B_.shape) != (Bsz, L, N)
            or B_.shape != C_.shape or tuple(A.shape) != (H,)
            or tuple(D.shape) != (H,)):
        raise ValueError(
            f"ssd_scan: x {tuple(x.shape)} needs dt (B,L,H), B_/C_ (B,L,N), "
            f"A/D (H,); got {[tuple(t.shape) for t in (dt, B_, C_, A, D)]}")
    cl = min(chunk, L)
    hb = min(hb, H)
    assert L % cl == 0 and H % hb == 0
    return Bsz, L, H, P, N, cl, hb


def smem_bytes(cl: int, P: int, N: int) -> int:
    """Shared memory of one block of the kernel (``layout`` in the
    source): B and C transposed, x, the (cl, cl) M tile, the transposed
    state, and three vectors of cl floats; rows padded by 4 floats."""
    return 4 * (2 * N * (cl + 4) + cl * (P + 4) + cl * (cl + 4)
                + N * (P + 4) + 3 * cl)


@true_fp32()
def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor,
                   C_: torch.Tensor, A: torch.Tensor, D: torch.Tensor, *,
                   chunk: int = 128, hb: int = 8
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel body of the reference in plain tensor ops, chunk by
    chunk with the fp32 state carried across chunks, batched over (B, H):
    ``cum = cumsum(dt A)``, the causal ``C B^T exp(cum_i - cum_j) dt_j``
    product with ``x``, the incoming state's ``exp(cum) C state^T``, the
    ``D x`` skip, and the state update."""
    Bsz, L, H, P, N, cl, hb = _shapes(x, dt, B_, C_, A, D, chunk, hb)
    xf, dtf, Bf, Cf = (a.float() for a in (x, dt, B_, C_))
    Af, Df = A.float(), D.float()
    dev = x.device
    state = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=dev)
    y = torch.empty((Bsz, L, H, P), dtype=torch.float32, device=dev)
    causal = torch.tril(torch.ones((cl, cl), dtype=torch.bool,
                                   device=dev))[None, :, :, None]
    for c in range(L // cl):
        rows = slice(c * cl, (c + 1) * cl)
        xc, dtc, Bc, Cc = xf[:, rows], dtf[:, rows], Bf[:, rows], Cf[:, rows]
        cum = torch.cumsum(dtc * Af, dim=1)                    # (B,cl,H) <= 0
        CB = torch.einsum("bin,bjn->bij", Cc, Bc)              # (B,cl,cl)
        seg = cum[:, :, None, :] - cum[:, None, :, :]          # (B,cl,cl,H)
        M = CB[..., None] * torch.where(
            causal, torch.exp(torch.where(causal, seg, torch.zeros_like(seg))),
            torch.zeros_like(seg))
        M = M * dtc[:, None, :, :]                             # weight by dt_j
        y_intra = torch.einsum("bijh,bjhp->bihp", M, xc)
        y_inter = torch.einsum("bin,bhpn->bihp", Cc, state)
        y[:, rows] = (y_intra + y_inter * torch.exp(cum)[..., None]
                      + Df[None, None, :, None] * xc)
        w = dtc * torch.exp(cum[:, -1:] - cum)                 # (B,cl,H)
        state = (state * torch.exp(cum[:, -1])[..., None, None]
                 + torch.einsum("bjn,bjhp->bhpn", Bc, xc * w[..., None]))
    return y, state


def _fn():
    fn = _build.load("ssd_scan").ssd_scan
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor,
             C_: torch.Tensor, A: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 128, hb: int = 8
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,L,H,P); dt (B,L,H); B_/C_ (B,L,N); A/D (H,) -> (y (B,L,H,P)
    fp32, final state (B,H,P,N) fp32).  CUDA tensors go through the
    hand-written kernel; CPU tensors through ``ssd_scan_plain``."""
    global launches
    Bsz, L, H, P, N, cl, hb = _shapes(x, dt, B_, C_, A, D, chunk, hb)
    ts = (x, dt, B_, C_, A, D)
    if on_cpu("ssd_scan", *ts):
        return ssd_scan_plain(x, dt, B_, C_, A, D, chunk=chunk, hb=hb)
    if any(t.requires_grad for t in ts) and torch.is_grad_enabled():
        raise RuntimeError("ssd_scan has no backward kernel (nor has the "
                           "reference's): inputs must not require a gradient")
    if x.dtype not in _DTYPES or B_.dtype != x.dtype or C_.dtype != x.dtype \
            or any(t.dtype != torch.float32 for t in (dt, A, D)):
        raise TypeError(f"ssd_scan kernel takes x/B_/C_ of one type (float32 "
                        f"or bfloat16) and float32 dt/A/D, got "
                        f"{[t.dtype for t in ts]}")
    if cl % 4 or P % 4 or N % 4 or smem_bytes(cl, P, N) > SMEM_MAX:
        raise ValueError(f"kernel takes chunk, P and N in multiples of 4 "
                         f"within {SMEM_MAX} bytes of shared memory, got "
                         f"chunk={cl}, P={P}, N={N} "
                         f"({smem_bytes(cl, P, N)} bytes)")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("kernel takes contiguous tensors")
    with torch.cuda.device(x.device):
        y = torch.empty((Bsz, L, H, P), dtype=torch.float32, device=x.device)
        st = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
        err = _fn()(x.data_ptr(), dt.data_ptr(), B_.data_ptr(),
                    C_.data_ptr(), A.data_ptr(), D.data_ptr(), y.data_ptr(),
                    st.data_ptr(), Bsz, L, H, P, N, cl,
                    int(x.dtype == torch.bfloat16),
                    torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch refused: CUDA error {err}")
    launches += 1
    return y, st
