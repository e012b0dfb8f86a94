"""Shared CNN-through-the-bridge driver for the Fig. 8 / Fig. 9
reproductions (paper §V-D: CGRA accelerator + firmware-heavy ResNet-18),
on the PyTorch port (``repro_torch``).

The firmware does what the paper's firmware does: im2col tiling/retiling of
every conv (host NumPy = paper's C data transformations), double-buffered
("ping-pong") activation buffers, weight prefetch, and launches the matmul
on the accelerator backend through the bridge.  Three DMA engines match the
paper's CGRA: weights / input / output.

The backends run on ``device``: the oracle is the port's fp32 reference
matmul, ``interpret`` the hand-written systolic-matmul kernel (its plain
version on the CPU).  Each layer's operands go to the device and its
result comes back into DDR as numpy, as the firmware hands them over.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import numpy as np

from repro_torch._device import resolve_device, to_device
from repro_torch.core.bridge import FireBridge
from repro_torch.core.congestion import CongestionConfig
from repro_torch.kernels.systolic_matmul import ref as mm_ref


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    name: str
    cin: int
    cout: int
    k: int
    stride: int
    hw: int        # input spatial size (square)


def resnet18_specs(hw: int = 32) -> List[ConvSpec]:
    """ResNet-18 conv shapes at CIFAR-style resolution (~0.7 GOP at 36px)."""
    s: List[ConvSpec] = [ConvSpec("conv1", 3, 64, 3, 1, hw)]
    cfg = [(64, 64, 1), (64, 64, 1), (64, 128, 2), (128, 128, 1),
           (128, 256, 2), (256, 256, 1), (256, 512, 2), (512, 512, 1)]
    cur = hw
    for i, (cin, cout, stride) in enumerate(cfg):
        s.append(ConvSpec(f"block{i}a", cin, cout, 3, stride, cur))
        cur = cur // stride
        s.append(ConvSpec(f"block{i}b", cout, cout, 3, 1, cur))
    return s


def small_cnn_specs(hw: int = 16) -> List[ConvSpec]:
    return [ConvSpec("c0", 3, 16, 3, 1, hw),
            ConvSpec("c1", 16, 32, 3, 2, hw),
            ConvSpec("c2", 32, 32, 3, 1, hw // 2),
            ConvSpec("c3", 32, 64, 3, 2, hw // 2)]


def gops(specs: List[ConvSpec]) -> float:
    total = 0
    for c in specs:
        out_hw = c.hw // c.stride
        total += 2 * out_hw * out_hw * c.cout * c.cin * c.k * c.k
    return total / 1e9


def _im2col(x: np.ndarray, k: int, stride: int) -> np.ndarray:
    """x (H, W, C) -> (out_h*out_w, k*k*C).  Firmware-side retiling."""
    H, W, C = x.shape
    pad = k // 2
    xp = np.pad(x, ((pad, pad), (pad, pad), (0, 0)))
    oh, ow = H // stride, W // stride
    cols = np.empty((oh * ow, k * k * C), x.dtype)
    idx = 0
    for oi in range(oh):
        for oj in range(ow):
            i, j = oi * stride, oj * stride
            cols[idx] = xp[i:i + k, j:j + k].reshape(-1)
            idx += 1
    return cols


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def run_cnn(specs: List[ConvSpec], backend: str = "oracle",
            seed: int = 0, tile: int = 64,
            congestion: Optional[CongestionConfig] = None,
            profile: bool = False, device="cuda") -> FireBridge:
    """Run one inference through the bridge; returns the bridge with the
    full transaction log (3 DMA engines + CSRs).

    With `congestion` set the three DMA engines contend on the online
    shared link *while the layers run* (paper §IV-C) — stall statistics
    come from fb.congestion_stats(), no post-hoc replay.  With `profile`
    each layer's DMA batch is op-marked, so `fb.profiler()` reports
    per-layer attribution (core/profiler.py; examples/profile_cnn_torch.py).
    The matmul backends run on `device`."""
    dev = resolve_device(device)
    fb = FireBridge("cgra", congestion=congestion, profile=profile)
    fb.csr.define("CTRL", 0x0)
    fb.csr.define("STATUS", 0x4, access="ro")
    fb.csr.define("LAYER", 0x8)
    fb.register_op("matmul",
                   oracle=functools.partial(_mm_oracle, device=dev),
                   interpret=functools.partial(_mm_interp, device=dev))

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(specs[0].hw, specs[0].hw, specs[0].cin)) \
        .astype(np.float32) * 0.1
    # ping-pong activation buffers (paper Fig. 9 "alternating layers")
    for layer, c in enumerate(specs):
        cols = _im2col(x, c.k, c.stride)                 # firmware retiling
        M = _round_up(cols.shape[0], tile)
        K = _round_up(cols.shape[1], tile)
        N = _round_up(c.cout, tile)
        a = np.zeros((M, K), np.float32)
        a[:cols.shape[0], :cols.shape[1]] = cols
        w = (rng.normal(size=(K, N)).astype(np.float32) *
             (1.0 / np.sqrt(K)))
        ping = f"act_{layer % 2}"
        pong = f"act_{(layer + 1) % 2}"
        if ping not in fb.mem.buffers:
            fb.mem.alloc(ping, (2 ** 22,), np.float32)   # 16 MB arena
        if pong not in fb.mem.buffers:
            fb.mem.alloc(pong, (2 ** 22,), np.float32)
        wname = f"w_{layer}"
        fb.mem.alloc(wname, w.shape, np.float32)
        fb.mem.host_write(wname, w)

        fb.csr.fb_write_32(0x8, layer)
        fb.csr.fb_write_32(0x0, 1)                       # start layer
        out = fb._ops["matmul"][backend](a, w, tile)
        out = np.maximum(out, 0.0)                       # firmware ReLU
        # DMA bursts: weights prefetch, input read, output write — one
        # batch per layer, so the three engines contend on the shared link
        # (and priorities arbitrate) when congestion is enabled (§IV-C).
        with fb.mem.mark(c.name, "dma"):
            fb.mem.log_burst_list(
                [("dma_weights", "read", fb.mem.buffers[wname].addr + off,
                  tile * tile * 4)
                 for off in range(0, w.nbytes, tile * tile * 4)] +
                [("dma_input", "read", fb.mem.buffers[ping].addr + off,
                  tile * tile * 4)
                 for off in range(0, a.nbytes, tile * tile * 4)] +
                [("dma_output", "write", fb.mem.buffers[pong].addr + off,
                  tile * tile * 4)
                 for off in range(0, out[:cols.shape[0], :c.cout].nbytes,
                                  tile * tile * 4)])
        oh = c.hw // c.stride
        x = out[:oh * oh, :c.cout].reshape(oh, oh, c.cout)
        fb.csr.hw_set("STATUS", layer + 1)
    return fb


def _operand(x: np.ndarray, dev):
    """A float32 operand on ``dev``.  The firmware's scaled weights are
    float64 (a float32 array times a NumPy float64 scalar), and the
    reference's ``jnp.asarray`` makes them float32, as this does; the
    kernel takes float32 or bfloat16 operands only."""
    return to_device(np.asarray(x, np.float32), dev)


def _mm_oracle(a, w, tile, device="cuda"):
    dev = resolve_device(device)
    return mm_ref.matmul_ref(_operand(a, dev), _operand(w, dev)) \
        .cpu().numpy()


def _mm_interp(a, w, tile, device="cuda"):
    from repro_torch.kernels.systolic_matmul.kernel import matmul
    dev = resolve_device(device)
    return matmul(_operand(a, dev), _operand(w, dev), bm=tile, bn=tile,
                  bk=tile).cpu().numpy()
