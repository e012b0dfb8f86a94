"""Shared neural-net building blocks (functions over dicts of tensors) —
the port of ``repro.models.layers``.

Conventions, as in the reference:
  * params are plain nested dicts of tensors; layer stacks carry a leading
    (L, ...) axis and the forward walks it layer by layer.
  * compute dtype is bf16 with fp32 maths for softmax/norm/loss; master
    params are fp32.
  * init draws from an explicit ``torch.Generator`` and makes its tensors
    on that generator's device; with ``gen=None`` it makes uninitialised
    tensors on the default device (shapes only, e.g. under
    ``torch.device("meta")``).  The draws differ from ``jax.random``'s, so
    tests hand both sides the same numpy parameters instead.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------


# a leaf of more elements than this is drawn one leading-axis slice at a
# time into its preallocated leaf, so the fp32 draw never holds more than
# one slice (moonshot-v1-16b-a3b's stacked expert leaves are 35 GB in fp32);
# every leaf below it is one draw, as it always was
_WHOLE_DRAW_ELEMS = 1 << 31


def normal(gen: Optional[torch.Generator], shape: Tuple[int, ...],
           std: float, dtype) -> torch.Tensor:
    """N(0, std^2) draws in fp32 from ``gen`` on its device, cast to
    ``dtype``."""
    if gen is None:
        return torch.empty(shape, dtype=dtype)
    if math.prod(shape) > _WHOLE_DRAW_ELEMS and len(shape) > 1:
        out = torch.empty(shape, dtype=dtype, device=gen.device)
        for sl in out:
            sl.copy_(normal(gen, tuple(sl.shape), std, dtype))
        return out
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return x.mul_(std).to(dtype)


def dense_init(gen: Optional[torch.Generator], d_in: int, d_out: int, dtype,
               scale: float = 1.0,
               shape_prefix: Tuple[int, ...] = ()) -> torch.Tensor:
    return normal(gen, shape_prefix + (d_in, d_out), scale / math.sqrt(d_in),
                  dtype)


def embed_init(gen: Optional[torch.Generator], vocab: int, d: int,
               dtype) -> torch.Tensor:
    return normal(gen, (vocab, d), 0.02, dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.float()).to(x.dtype)


def head_rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
                  ) -> torch.Tensor:
    """Per-head RMS norm; x (..., H, K), w (H, K)."""
    return rms_norm(x, w, eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, fraction: str, theta: float = 10_000.0,
               device=None) -> torch.Tensor:
    """Inverse frequencies for the rotary slice of the head dim ("full":
    the whole head dim; "half": the first half, chatglm-style)."""
    rot = head_dim if fraction == "full" else head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                         device=device) / rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, fraction: str,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int.  Rotates INTERLEAVED pairs
    (x[..., 0::2], x[..., 1::2]) and re-stacks them on the last axis, as
    the reference does — not the half-split layout."""
    if fraction == "none":
        return x
    d = x.shape[-1]
    rot = d if fraction == "full" else d // 2
    inv = rope_freqs(d, fraction, theta, device=x.device)     # (rot/2,)
    ang = positions[..., None].float() * inv                   # (B, S, rot/2)
    cos = torch.cos(ang)[:, :, None, :]                        # (B, S, 1, rot/2)
    sin = torch.sin(ang)[:, :, None, :]
    xr = x[..., :rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    if rot == d:
        return yr.to(x.dtype)
    return torch.cat([yr.to(x.dtype), x[..., rot:]], dim=-1)


def sinusoidal_positions(positions: torch.Tensor, d_model: int
                         ) -> torch.Tensor:
    """Fixed sin-cos position encoding; positions (B, S) -> (B, S, d_model)
    fp32 (the ``frames`` frontend's positions)."""
    half = d_model // 2
    inv = 1.0 / (10_000.0 ** (torch.arange(half, dtype=torch.float32,
                                           device=positions.device) / half))
    ang = positions[..., None].float() * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_init(gen: Optional[torch.Generator], d_model: int, d_ff: int,
             mlp_type: str, dtype, shape_prefix: Tuple[int, ...] = ()) -> dict:
    if mlp_type == "swiglu":
        return {
            "w_gate": dense_init(gen, d_model, d_ff, dtype, shape_prefix=shape_prefix),
            "w_up": dense_init(gen, d_model, d_ff, dtype, shape_prefix=shape_prefix),
            "w_down": dense_init(gen, d_ff, d_model, dtype, shape_prefix=shape_prefix),
        }
    return {
        "w_in": dense_init(gen, d_model, d_ff, dtype, shape_prefix=shape_prefix),
        "w_out": dense_init(gen, d_ff, d_model, dtype, shape_prefix=shape_prefix),
    }


def mlp_apply(w: dict, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    if mlp_type == "swiglu":
        g = x @ w["w_gate"]
        u = x @ w["w_up"]
        return (F.silu(g) * u) @ w["w_down"]
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ w["w_in"], approximate="tanh")
    return h @ w["w_out"]


# ---------------------------------------------------------------------------
# Cross-entropy without a (B, S, V) one-hot
# ---------------------------------------------------------------------------


def token_nll(logits: torch.Tensor, labels: torch.Tensor,
              z_loss: float = 0.0) -> torch.Tensor:
    """The negative log-likelihood of each position (..., V) -> (...)."""
    return _nll_lse(logits, labels, z_loss)[0]


def _nll_lse(logits, labels, z_loss):
    lf = logits.float()
    m = lf.amax(dim=-1, keepdim=True).detach()
    shifted = lf - m
    lse = torch.log(torch.exp(shifted).sum(dim=-1)) + m[..., 0]
    picked = lf.gather(-1, labels[..., None].long())[..., 0]
    nll = lse - picked
    if z_loss:
        nll = nll + z_loss * lse.square()
    return nll, lse


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          z_loss: float = 0.0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (..., V) bf16/f32; labels (...) int.  Returns (mean_loss, lse).

    The max is a constant of the gradient (stop-gradient, as in the
    reference) and the label logit is picked with a gather of one index per
    position: no (..., V) one-hot or index tensor is made."""
    nll, lse = _nll_lse(logits, labels, z_loss)
    if mask is not None:
        denom = torch.clamp(mask.sum(), min=1.0)
        loss = (nll * mask).sum() / denom
    else:
        loss = nll.mean()
    return loss, lse
