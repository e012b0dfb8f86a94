"""The Mamba-2 SSD chunked scan — a hand-written CUDA kernel
(``csrc/ssd_scan.cu``: three launches, the chunks in parallel, products on
the tensor cores) and its plain PyTorch version.

Layout: x (B, L, H, P) and B_/C_ (B, L, N) of one type (fp32 or bf16),
dt (B, L, H), A/D (H,) fp32; results y (B, L, H, P) fp32 — the ``D`` skip
included — and the final state (B, H, P, N) fp32, from a zero state.
``ssd_scan`` calls the dispatcher op ``repro_torch::ssd_scan``, whose CUDA
implementation launches the kernel (or raises) and whose CPU
implementation is ``ssd_scan_plain``: the dispatcher picks by the tensors'
device; on meta or fake tensors (the dry run) the op is one call of known
output shapes, and on any other device the dispatcher raises.  ``chunk``
sets the chunk length of the chunked arithmetic on both routes; ``hb`` keeps
the reference's head-block contract, which defines the modeled burst list
(``ops.transactions``) and nothing numeric.  The kernel has no backward
(neither has the reference's): called directly, it refuses inputs that
require a gradient; ``ops.ssd_scan`` differentiates it by recompute.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch._device import same_device, true_fp32
from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)
# the kernel's register fragments are sized for these (csrc/ssd_scan.cu)
CHUNK_MAX, P_MAX, N_MAX = 128, 64, 64
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


def smem_bytes(split: bool) -> int:
    """Shared memory of one block of the kernel's output launch
    (``chunk_out`` in the source): C and B row-major (chunk x N), x
    transposed (P x chunk), the incoming state as a bf16 hi + lo pair, each
    bf16 at the kernel's largest chunk, P and N with rows padded by 8, and
    two vectors of chunk floats for each head of the block; ``split`` (fp32
    x/B/C, four heads a block where bf16 operands take one) doubles the
    first three for their lo halves."""
    ldn, ldj = N_MAX + 8, CHUNK_MAX + 8
    tiles = 2 * CHUNK_MAX * ldn + P_MAX * ldj
    return ((2 if split else 1) * tiles + 2 * P_MAX * ldn) * 2 \
        + 2 * (4 if split else 1) * CHUNK_MAX * 4


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


def _lib():
    lib = _build.load("ssd_scan")
    if not lib.ssd_scan.argtypes:
        lib.ssd_scan.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        lib.ssd_scan.restype = ctypes.c_int
        lib.ssd_scan_scratch.argtypes = [ctypes.c_int] * 6
        lib.ssd_scan_scratch.restype = ctypes.c_longlong
    return lib


def _check_kernel_operands(ts, cl: int, P: int, N: int) -> None:
    """What the kernel takes (the data's alignment is checked at launch)."""
    x, dt, B_, C_, A, D = ts
    if x.dtype not in _DTYPES or B_.dtype != x.dtype or C_.dtype != x.dtype \
            or any(t.dtype != torch.float32 for t in (dt, A, D)):
        raise TypeError(f"ssd_scan kernel takes x/B_/C_ of one type (float32 "
                        f"or bfloat16) and float32 dt/A/D, got "
                        f"{[t.dtype for t in ts]}")
    if cl % 4 or P % 4 or N % 4 or cl > CHUNK_MAX or P > P_MAX \
            or N > N_MAX:
        raise ValueError(f"kernel takes chunk, P and N in multiples of 4 up "
                         f"to {CHUNK_MAX}, {P_MAX} and {N_MAX}, got "
                         f"chunk={cl}, P={P}, N={N}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("kernel takes contiguous tensors")


@torch.library.custom_op(
    "repro_torch::ssd_scan", mutates_args=(), device_types="cpu",
    schema="(Tensor x, Tensor dt, Tensor B_, Tensor C_, Tensor A, Tensor D, "
           "int chunk, int hb) -> (Tensor, Tensor)")
def _ssd_op(x, dt, B_, C_, A, D, chunk, hb):
    """The op's CPU implementation: the plain version."""
    return ssd_scan_plain(x, dt, B_, C_, A, D, chunk=chunk, hb=hb)


@_ssd_op.register_kernel("cuda")
def _ssd_launch(x, dt, B_, C_, A, D, chunk, hb):
    """The op's CUDA implementation: the kernel, or an error."""
    global launches
    Bsz, L, H, P, N, cl, hb = _shapes(x, dt, B_, C_, A, D, chunk, hb)
    ts = (x, dt, B_, C_, A, D)
    _check_kernel_operands(ts, cl, P, N)
    if any(t.data_ptr() % 16 for t in (x, B_, C_)):
        raise ValueError("kernel takes x, B_ and C_ whose data starts on a "
                         "16-byte boundary (vector loads)")
    lib = _lib()
    with torch.cuda.device(x.device):
        y = torch.empty((Bsz, L, H, P), dtype=torch.float32, device=x.device)
        st = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
        # the chunks' own states and cum_last, from the caching allocator
        scratch = torch.empty(lib.ssd_scan_scratch(Bsz, L, H, P, N, cl),
                              dtype=torch.float32, device=x.device)
        err = lib.ssd_scan(x.data_ptr(), dt.data_ptr(), B_.data_ptr(),
                           C_.data_ptr(), A.data_ptr(), D.data_ptr(),
                           y.data_ptr(), st.data_ptr(), scratch.data_ptr(),
                           Bsz, L, H, P, N, cl, int(x.dtype == torch.bfloat16),
                           torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch refused: CUDA error {err}")
    launches += 1
    return y, st


@_ssd_op.register_fake
def _ssd_shapes(x, dt, B_, C_, A, D, chunk, hb):
    """Output shapes and types (meta and fake tensors), with the kernel's
    contract on CUDA."""
    Bsz, L, H, P, N, cl, hb = _shapes(x, dt, B_, C_, A, D, chunk, hb)
    if x.device.type == "cuda":
        _check_kernel_operands((x, dt, B_, C_, A, D), cl, P, N)
    return (x.new_empty((Bsz, L, H, P), dtype=torch.float32),
            x.new_empty((Bsz, H, P, N), dtype=torch.float32))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor,
             C_: torch.Tensor, A: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 128, hb: int = 8
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,L,H,P); dt (B,L,H); B_/C_ (B,L,N); A/D (H,) -> (y (B,L,H,P)
    fp32, final state (B,H,P,N) fp32).  CUDA tensors go through the
    hand-written kernel; CPU tensors through ``ssd_scan_plain``."""
    _shapes(x, dt, B_, C_, A, D, chunk, hb)
    ts = (x, dt, B_, C_, A, D)
    same_device("ssd_scan", *ts)
    if any(t.requires_grad for t in ts) and torch.is_grad_enabled():
        raise RuntimeError("the raw ssd_scan kernel has no backward: call "
                           "ops.ssd_scan, which differentiates by recompute")
    return torch.ops.repro_torch.ssd_scan(x, dt, B_, C_, A, D, chunk, hb)
