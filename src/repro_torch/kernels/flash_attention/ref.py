"""Pure-torch oracle for the flash-attention kernel (kernel layout B,H,S,D)."""
from __future__ import annotations

import math

import torch

from repro_torch._device import true_fp32


@true_fp32()
def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, window: int = 0) -> torch.Tensor:
    """q (B,H,Sq,D); k/v (B,KH,Skv,D); positions are arange.  GQA by
    reshape (no KV repeat), masked scores filled with -1e30, ``p``
    re-masked after the softmax, fp32 maths, result in q's dtype."""
    B, H, Sq, D = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    G = H // KH
    qg = q.reshape(B, KH, G, Sq, D).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) / math.sqrt(D)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    m = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        m = m & (kpos <= qpos)
    if window:
        m = m & (kpos > qpos - window)
    s = torch.where(m, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    p = torch.where(m, p, torch.zeros_like(p))
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(B, H, Sq, D).to(q.dtype)
