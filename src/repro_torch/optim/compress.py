"""Error-feedback int8 gradient compression (beyond-paper distributed-
optimization trick), on trees of tensors.

Blockwise symmetric int8 quantization with a persistent error-feedback
buffer (EF21-style): the quantization residual is carried into the next
step, so compression bias vanishes in expectation.  The reference's
trainer reads ``grad_compression`` and applies nothing on one device; the
port's trainer gains that option with the multi-device gradient reduction
that applies it (ROADMAP queue A item 12).  ``torch.round`` rounds half to
even, as ``jnp.round`` does, and every other step is one IEEE operation,
so the values are the reference's bit for bit in fp32.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.nn.functional as F

from repro_torch._tree import leaves, tree_map, unflatten

BLOCK = 256


def _quantize_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = g.reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_leaf(q: torch.Tensor, scale: torch.Tensor, shape,
                     size: int) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)[:size]
    return flat.reshape(shape)


def compress_decompress(g: torch.Tensor) -> torch.Tensor:
    q, s = _quantize_leaf(g.to(torch.float32))
    return _dequantize_leaf(q, s, g.shape, g.numel()).to(g.dtype)


def ef_compress(grads: Any, error: Any) -> Tuple[Any, Any]:
    """Returns (compressed grads, new error buffers)."""
    def one(g, e):
        corrected = g.to(torch.float32) + e
        cq = compress_decompress(corrected)
        return cq.to(g.dtype), corrected - cq

    out = [one(g, e) for g, e in zip(leaves(grads), leaves(error))]
    return (unflatten(grads, [o[0] for o in out]),
            unflatten(grads, [o[1] for o in out]))


def init_error(grads_like: Any) -> Any:
    """Zero fp32 error buffers shaped like, and on the device of, the
    tensors of ``grads_like``."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)
