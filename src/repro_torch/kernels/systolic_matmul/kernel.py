"""Blocked matmul kernel — the port's counterpart of the paper's
representative systolic-array accelerator (paper §V-B, Fig. 4).

The paper's SoC streams A/B tiles through AXI DMAs into a weight-stationary
systolic array.  Here the "array" is a hand-written CUDA kernel
(``csrc/systolic_matmul.cu``): one thread block owns one C tile and sweeps
k with an fp32 accumulator in registers, C written once — the
output-stationary schedule of the reference.  fp32 operands run a
tensor-core body (``csrc/systolic_matmul_sm90.cuh``: 3xTF32 on ``wgmma``,
after a pre-pass that splits each operand into two TF32 words in scratch
this wrapper allocates); bf16 operands an fp32-FMA body.  ``bm/bn/bk``
keep the reference's clamping and divisibility contract because they
define the modeled DMA burst list (``ops.transactions``); the CUDA kernel
picks its own internal tile and masks ragged edges, so any M, N, K runs.

``matmul`` launches the kernel for CUDA tensors (or raises) and takes
``matmul_plain`` — the same blocked arithmetic in tensor ops — only for
tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from repro_torch._device import true_fp32
from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)

# number of CUDA kernel launches made by ``matmul`` (plain integer; a
# caller that wants a per-run count sets it to 0 first)
launches = 0
_count_lock = threading.Lock()     # cells of a sweep launch from threads


def _blocks(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int,
            bk: int) -> Tuple[int, int, int, int, int, int]:
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"matmul takes 2-D operands, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    M, K = a.shape
    K2, N = b.shape
    assert K == K2, (a.shape, b.shape)
    bm, bn, bk = min(bm, M), min(bn, N), min(bk, K)
    assert M % bm == 0 and N % bn == 0 and K % bk == 0, (a.shape, b.shape)
    return M, N, K, bm, bn, bk


@true_fp32()
def matmul_plain(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
                 bn: int = 128, bk: int = 128, out_dtype=None) -> torch.Tensor:
    """The kernel's arithmetic in plain tensor ops: inputs upcast to fp32,
    an fp32 accumulator swept over k in blocks of ``bk``, one cast at the
    end.  The (m, n) tiles are independent, so each k step updates all of
    them in one batched product over ``(M/bm, N/bn)`` tiles."""
    M, N, K, bm, bn, bk = _blocks(a, b, bm, bn, bk)
    at = a.float().view(M // bm, bm, K)              # (nm, bm, K)
    bt = b.float().view(K, N // bn, bn)              # (K, nn, bn)
    acc = torch.zeros(M // bm, N // bn, bm, bn, dtype=torch.float32,
                      device=a.device)
    for k0 in range(0, K, bk):
        acc += torch.einsum("mik,knj->mnij", at[:, :, k0:k0 + bk],
                            bt[k0:k0 + bk])
    out = acc.permute(0, 2, 1, 3).reshape(M, N)
    return out.to(out_dtype or a.dtype)


def _lib():
    lib = _build.load("systolic_matmul")
    if not lib.systolic_matmul.argtypes:
        # the argtypes tested above are bound last: a thread that sees them
        # sees every other binding too
        lib.systolic_matmul_scratch.argtypes = [ctypes.c_int] * 4
        lib.systolic_matmul_scratch.restype = ctypes.c_longlong
        lib.systolic_matmul.restype = ctypes.c_int
        lib.systolic_matmul.argtypes = ([ctypes.c_void_p] * 3
                                        + [ctypes.c_int] * 5
                                        + [ctypes.c_void_p] * 2)
    return lib


def matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128, bn: int = 128,
           bk: int = 128, out_dtype: Optional[torch.dtype] = None
           ) -> torch.Tensor:
    """a (M,K) @ b (K,N) -> (M,N), fp32 accumulation, cast to
    ``out_dtype or a.dtype``.  CUDA tensors go through the hand-written
    kernel; CPU tensors through ``matmul_plain``."""
    global launches
    M, N, K, bm, bn, bk = _blocks(a, b, bm, bn, bk)
    out_dtype = out_dtype or a.dtype
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device}, {b.device}")
    if a.device.type == "cpu":
        return matmul_plain(a, b, bm=bm, bn=bn, bk=bk, out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"matmul runs on cuda or cpu tensors, not {a.device}")
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise TypeError(f"kernel takes two float32 or two bfloat16 operands, "
                        f"got {a.dtype} and {b.dtype}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"kernel writes float32 or bfloat16, not {out_dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("kernel takes contiguous row-major operands")
    lib = _lib()
    in_bf16 = int(a.dtype == torch.bfloat16)
    with torch.cuda.device(a.device):
        c = torch.empty((M, N), dtype=out_dtype, device=a.device)
        # the fp32 body's split operands, written by its pre-pass
        n = lib.systolic_matmul_scratch(M, N, K, in_bf16)
        scratch = torch.empty(n, dtype=torch.float32, device=a.device) \
            if n else None
        err = lib.systolic_matmul(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K, in_bf16,
            int(out_dtype == torch.bfloat16),
            scratch.data_ptr() if n else None,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"systolic_matmul launch refused: CUDA error {err}")
    with _count_lock:
        launches += 1
    return c
