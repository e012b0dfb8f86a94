"""The RWKV-6 WKV recurrence — a hand-written CUDA kernel
(``csrc/wkv_scan.cu``) and its plain PyTorch version.

Layout: r/k/v/w (B, L, H, K) with w the per-step decay in (0, 1), u (H, K);
results y (B, L, H, K) fp32 and the final state (B, H, K, K) fp32, the
recurrence starting from a zero state.  ``wkv_scan`` calls the dispatcher
op ``repro_torch::wkv_scan``, whose CUDA implementation launches the kernel
(or raises) and whose CPU implementation is ``wkv_scan_plain``: the
dispatcher picks by the tensors' device; on meta or fake tensors (the dry
run) the op is one call of known output shapes, and on any other device
the dispatcher raises.  ``chunk``/``hb`` keep the reference's clamping and
divisibility contract, since they define the modeled burst list
(``ops.transactions``).  The kernel cuts L into chunks of its own
(``kernel_chunk``): each chunk's own state in parallel, a short pass that
sums them into the state entering each chunk, then each chunk's exact step
walk from that state.  Only the incoming states are summed in another
order than the reference's, which changes nothing but fp32 rounding.  The
kernel has no backward (neither has the reference's): called directly, it
refuses inputs that require a gradient; ``ops.wkv_scan`` differentiates it
by recompute.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch._device import same_device, true_fp32
from repro_torch.kernels import _build

_HEAD_SIZES = (16, 32, 64, 128)

# number of calls of ``wkv_scan`` that launched the kernel (its one to three
# CUDA launches count once; a plain integer, a caller that wants a per-run
# count sets it to 0 first)
launches = 0

# blocks of the output launch below which the kernel's chunk is halved
_BLOCKS = 512


def _shapes(r, k, v, w, u, chunk: int, hb: int):
    if r.dim() != 4 or not (r.shape == k.shape == v.shape == w.shape):
        raise ValueError(f"wkv_scan takes r/k/v/w of one shape (B,L,H,K), got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    B, L, H, K = r.shape
    if tuple(u.shape) != (H, K):
        raise ValueError(f"u must be (H,K) = {(H, K)}, got {tuple(u.shape)}")
    cl = min(chunk, L)
    hb = min(hb, H)
    assert L % cl == 0 and H % hb == 0
    return B, L, H, K, cl, hb


@true_fp32()
def wkv_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, *, chunk: int = 16,
                   hb: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel body of the reference in plain tensor ops: chunk by
    chunk, the exact per-step recurrence (``kv = k v^T``,
    ``out = sum_k r (S + u kv)``, ``S = w S + kv``) on an fp32 state carried
    across chunks, batched over (B, H)."""
    B, L, H, K, cl, hb = _shapes(r, k, v, w, u, chunk, hb)
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()[None, :, :, None]                           # (1,H,K,1)
    state = torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device)
    y = torch.empty((B, L, H, K), dtype=torch.float32, device=r.device)
    for c in range(L // cl):
        for t in range(c * cl, (c + 1) * cl):
            kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]    # (B,H,K,V)
            y[:, t] = (rf[:, t, :, :, None] * (state + uf * kv)).sum(dim=2)
            state = wf[:, t, :, :, None] * state + kv
    return y, state


def kernel_chunk(B: int, L: int, H: int, K: int) -> int:
    """The kernel's own chunk (steps one block walks, a multiple of its
    8-step run; not the reference's ``chunk``): the largest of 128, 64, 32
    and 16 that still gives the output launch ``_BLOCKS`` blocks, so that
    long prompts move few chunk states and short ones still fill the
    card."""
    c = 128
    while c > 16 and B * H * max(1, K // 64) * -(-L // c) < _BLOCKS:
        c //= 2
    return c


def scratch_floats(B: int, L: int, H: int, K: int, C: int) -> int:
    """Floats of scratch the kernel needs at kernel chunk ``C``: the own
    states (B, nc-1, H, K, K) and total decays (B, nc-1, H, K) of every
    chunk but the last, nc = ceil(L / C)."""
    return B * (-(-L // C) - 1) * H * K * (K + 1)


def _lib():
    lib = _build.load("wkv_scan")
    if not lib.wkv_scan.argtypes:
        lib.wkv_scan.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        lib.wkv_scan.restype = ctypes.c_int
    return lib


def _check_kernel_operands(ts, K: int) -> None:
    """What the kernel takes (the data's alignment is checked at launch)."""
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"wkv_scan kernel takes float32 r/k/v/w/u, got "
                        f"{[t.dtype for t in ts]}")
    if K not in _HEAD_SIZES:
        raise ValueError(f"kernel is built for head sizes {_HEAD_SIZES}, "
                         f"got {K}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("kernel takes contiguous tensors, r/k/w 16-byte "
                         "aligned")


@torch.library.custom_op(
    "repro_torch::wkv_scan", mutates_args=(), device_types="cpu",
    schema="(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, int chunk, "
           "int hb) -> (Tensor, Tensor)")
def _wkv_op(r, k, v, w, u, chunk, hb):
    """The op's CPU implementation: the plain version."""
    return wkv_scan_plain(r, k, v, w, u, chunk=chunk, hb=hb)


@_wkv_op.register_kernel("cuda")
def _wkv_launch(r, k, v, w, u, chunk, hb):
    """The op's CUDA implementation: the kernel, or an error."""
    global launches
    B, L, H, K, _, _ = _shapes(r, k, v, w, u, chunk, hb)
    ts = (r, k, v, w, u)
    _check_kernel_operands(ts, K)
    if any(t.data_ptr() % 16 for t in (r, k, w)):
        raise ValueError("kernel takes contiguous tensors, r/k/w 16-byte "
                         "aligned")
    lib = _lib()
    C = kernel_chunk(B, L, H, K)
    with torch.cuda.device(r.device):
        y = torch.empty((B, L, H, K), dtype=torch.float32, device=r.device)
        st = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
        # the chunks' own states and decays, from the caching allocator
        scratch = torch.empty(scratch_floats(B, L, H, K, C),
                              dtype=torch.float32, device=r.device)
        err = lib.wkv_scan(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                           w.data_ptr(), u.data_ptr(), y.data_ptr(),
                           st.data_ptr(), scratch.data_ptr(), B, L,
                           H, K, C, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv_scan launch refused: CUDA error {err}")
    launches += 1
    return y, st


@_wkv_op.register_fake
def _wkv_shapes(r, k, v, w, u, chunk, hb):
    """Output shapes and types (meta and fake tensors), with the kernel's
    contract on CUDA."""
    B, L, H, K, _, _ = _shapes(r, k, v, w, u, chunk, hb)
    if r.device.type == "cuda":
        _check_kernel_operands((r, k, v, w, u), K)
    return (r.new_empty((B, L, H, K), dtype=torch.float32),
            r.new_empty((B, H, K, K), dtype=torch.float32))


def wkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, *, chunk: int = 16,
             hb: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w (B,L,H,K); u (H,K) -> (y (B,L,H,K) fp32, final state
    (B,H,K,K) fp32).  CUDA tensors go through the hand-written kernel; CPU
    tensors through ``wkv_scan_plain``."""
    _shapes(r, k, v, w, u, chunk, hb)
    ts = (r, k, v, w, u)
    same_device("wkv_scan", *ts)
    if any(t.requires_grad for t in ts) and torch.is_grad_enabled():
        raise RuntimeError("the raw wkv_scan kernel has no backward: call "
                           "ops.wkv_scan, which differentiates by recompute")
    return torch.ops.repro_torch.wkv_scan(r, k, v, w, u, chunk, hb)
