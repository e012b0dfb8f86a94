"""Attention with three interchangeable implementations — the port of
``repro.models.attention``.

  * ``naive``    — O(S^2) materialised scores; the oracle.
  * ``chunked``  — work-list-scheduled flash attention in plain tensor ops
                   with its own backward (FlashAttention-2 algebra): the
                   static list of (q_tile, kv_tile) pairs plays the role of
                   the kernel grid, as in the reference.
  * ``pallas``   — the name the reference gives its kernel route; here it
                   dispatches to the hand-written CUDA kernels through
                   ``kernels/flash_attention/ops.py`` (their plain versions
                   on CPU tensors).

``decode_attention`` is the one-query masked einsum of the decode step;
``decode_attention_partial`` / ``combine_partials`` split it over slices
of the cache's positions (context-parallel decode).

GQA is handled by grouping query heads over KV heads (no KV materialised
repeat).  Masking is position-based: callers pass q/kv position arrays;
invalid KV slots are marked with position -1.  Where the reference asks for
``preferred_element_type=float32`` on bf16 operands, the port upcasts the
operands: a bf16 product is exact in fp32, so the two agree up to the order
of the sums.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

_NEG = -1.0e30


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    causal: bool = True
    window: int = 0              # 0 = unbounded; else sliding window size
    q_chunk: int = 512
    kv_chunk: int = 512
    skip_masked_tiles: bool = False   # drop fully-masked tiles
    # static hint that q/kv positions are arange(0..S) (self-attention);
    # required for skip_masked_tiles work-list filtering.
    positions_are_arange: bool = False


def _tile_mask(spec: AttnSpec, q_pos: torch.Tensor, kv_pos: torch.Tensor
               ) -> torch.Tensor:
    """q_pos (B, cq), kv_pos (B, ck) -> bool (B, cq, ck)."""
    qp = q_pos[:, :, None]
    kp = kv_pos[:, None, :]
    m = kp >= 0
    if spec.causal:
        m = m & (kp <= qp)
    if spec.window:
        m = m & (kp > qp - spec.window)
    return m


def naive_attention(q, k, v, *, spec: AttnSpec, q_pos, kv_pos):
    """q (B,Sq,H,D), k/v (B,Skv,KH,D) -> (B,Sq,H,D)."""
    B, Sq, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    qg = q.reshape(B, Sq, KH, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) / np.sqrt(D)
    mask = _tile_mask(spec, q_pos, kv_pos)[:, None, None]      # (B,1,1,Sq,Skv)
    s = torch.where(mask, s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask, p, torch.zeros_like(p))
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def build_worklist(spec: AttnSpec, n_q: int, n_kv: int) -> np.ndarray:
    """Static (n_pairs, 2) array of (q_tile, kv_tile) indices."""
    pairs = []
    for qi in range(n_q):
        for kj in range(n_kv):
            if spec.skip_masked_tiles and spec.positions_are_arange:
                q_lo, q_hi = qi * spec.q_chunk, (qi + 1) * spec.q_chunk - 1
                k_lo, k_hi = kj * spec.kv_chunk, (kj + 1) * spec.kv_chunk - 1
                if spec.causal and k_lo > q_hi:
                    continue                       # entirely above diagonal
                if spec.window and k_hi <= q_lo - spec.window:
                    continue                       # entirely out of window
            pairs.append((qi, kj))
    return np.asarray(pairs, dtype=np.int32).reshape(-1, 2)


def _flash_fwd_impl(spec: AttnSpec, q, k, v, q_pos, kv_pos):
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = H // KH
    cq, ck = spec.q_chunk, spec.kv_chunk
    assert Sq % cq == 0 and Skv % ck == 0, (Sq, Skv, spec)
    scale = 1.0 / np.sqrt(D)
    dev = q.device
    # carried layout (B, S, KH, G), as in the reference's scan carry
    acc = torch.zeros((B, Sq, KH, G, D), dtype=torch.float32, device=dev)
    m = torch.full((B, Sq, KH, G), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, KH, G), dtype=torch.float32, device=dev)
    for qi, kj in build_worklist(spec, Sq // cq, Skv // ck):
        rq, rk = slice(qi * cq, (qi + 1) * cq), slice(kj * ck, (kj + 1) * ck)
        qc = q[:, rq].reshape(B, cq, KH, G, D)
        kc, vc = k[:, rk], v[:, rk]
        s = torch.einsum("bqkgd,bskd->bkgqs", qc.float(), kc.float()) * scale
        msk = _tile_mask(spec, q_pos[:, rq], kv_pos[:, rk])[:, None, None]
        s = torch.where(msk, s, torch.full_like(s, _NEG))
        mc_t = m[:, rq].permute(0, 2, 3, 1)                    # (B,KH,G,cq)
        m_new = torch.maximum(mc_t, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(msk, p, torch.zeros_like(p))
        corr = torch.exp(mc_t - m_new)
        l_new = l[:, rq].permute(0, 2, 3, 1) * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(),
                          vc.float())
        acc[:, rq] = acc[:, rq] * corr.permute(0, 3, 1, 2)[..., None] + pv
        m[:, rq] = m_new.permute(0, 3, 1, 2)
        l[:, rq] = l_new.permute(0, 3, 1, 2)
    l_safe = torch.clamp(l, min=1e-30)
    out = (acc / l_safe[..., None]).reshape(B, Sq, H, D).to(q.dtype)
    lse = (m + torch.log(l_safe)).reshape(B, Sq, H)
    return out, lse


def _flash_bwd_impl(spec: AttnSpec, q, k, v, q_pos, kv_pos, out, lse, dout):
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = H // KH
    cq, ck = spec.q_chunk, spec.kv_chunk
    scale = 1.0 / np.sqrt(D)
    delta = (dout.float() * out.float()).sum(-1)               # (B,Sq,H)
    lse_g = lse.reshape(B, Sq, KH, G)
    delta_g = delta.reshape(B, Sq, KH, G)
    dq = torch.zeros((B, Sq, KH, G, D), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, Skv, KH, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for qi, kj in build_worklist(spec, Sq // cq, Skv // ck):
        rq, rk = slice(qi * cq, (qi + 1) * cq), slice(kj * ck, (kj + 1) * ck)
        qc = q[:, rq].reshape(B, cq, KH, G, D).float()
        kc, vc = k[:, rk].float(), v[:, rk].float()
        doc = dout[:, rq].reshape(B, cq, KH, G, D).float()
        lsec = lse_g[:, rq].permute(0, 2, 3, 1)
        deltc = delta_g[:, rq].permute(0, 2, 3, 1)
        s = torch.einsum("bqkgd,bskd->bkgqs", qc, kc) * scale
        msk = _tile_mask(spec, q_pos[:, rq], kv_pos[:, rk])[:, None, None]
        p = torch.exp(torch.where(msk, s, torch.full_like(s, _NEG))
                      - lsec[..., None])
        p = torch.where(msk, p, torch.zeros_like(p))           # (B,KH,G,cq,ck)
        dv[:, rk] += torch.einsum("bkgqs,bqkgd->bskd", p, doc)
        dp = torch.einsum("bqkgd,bskd->bkgqs", doc, vc)
        ds = p * (dp - deltc[..., None]) * scale
        dq[:, rq] += torch.einsum("bkgqs,bskd->bqkgd", ds, kc)
        dk[:, rk] += torch.einsum("bkgqs,bqkgd->bskd", ds, qc)
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _ChunkedFlash(torch.autograd.Function):
    """The reference's ``custom_vjp`` pair ``_fa_fwd`` / ``_fa_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, spec):
        out, lse = _flash_fwd_impl(spec, q, k, v, q_pos, kv_pos)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, out, lse)
        ctx.spec = spec
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_pos, kv_pos, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_impl(ctx.spec, q, k, v, q_pos, kv_pos, out,
                                     lse, dout)
        return dq, dk, dv, None, None, None


def flash_attention(spec: AttnSpec, q, k, v, q_pos, kv_pos):
    return _ChunkedFlash.apply(q, k, v, q_pos, kv_pos, spec)


def decode_attention(q, k, v, *, q_pos, kv_pos, window: int = 0):
    """Decode attention (Sq == 1): a plain masked einsum — no S^2 term
    exists.  q (B,1,H,D); k/v (B,S,KH,D); q_pos (B,1); kv_pos (B,S)."""
    B, Sq, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    qg = q.reshape(B, Sq, KH, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) / np.sqrt(D)
    spec = AttnSpec(causal=True, window=window)
    mask = _tile_mask(spec, q_pos, kv_pos)[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask, p, torch.zeros_like(p))
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def decode_attention_partial(q, k, v, *, q_pos, kv_pos, window: int = 0):
    """``decode_attention`` over one slice of the cache's positions, for
    context-parallel decode: -> (acc (B,1,H,D) f32, m (B,1,H,1) f32,
    l (B,1,H,1) f32): the slice's running max of the scores, the sum of
    their exponentials relative to it, and the unnormalised output.  A
    slice with no valid position gives m = -1e30, l = 0, acc = 0.
    ``combine_partials`` turns the slices' triples into the output."""
    B, Sq, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    qg = q.reshape(B, Sq, KH, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) / np.sqrt(D)
    spec = AttnSpec(causal=True, window=window)
    mask = _tile_mask(spec, q_pos, kv_pos)[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, _NEG))
    m = s.amax(dim=-1, keepdim=True)                        # (B,KH,G,q,1)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    side = lambda t: t.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, 1)
    return acc.reshape(B, Sq, H, D), side(m), side(l)


def combine_partials(acc, m, l, *, max_fn, sum_fn):
    """The exact softmax output from the slices' ``decode_attention_
    partial`` triples: ``max_fn(m)`` is the max over the slices,
    ``sum_fn(a, b)`` the sums of ``a`` and of ``b`` over them (over a
    leading dim of stacked triples, or a collective over the ranks that
    hold the slices).  f32; a row with no valid position anywhere is 0."""
    mg = max_fn(m)
    scale = torch.exp(m - mg)
    num, den = sum_fn(acc * scale, l * scale)
    return torch.where(den > 0, num / torch.where(den > 0, den,
                                                  torch.ones_like(den)),
                       torch.zeros_like(num))


def _divisor_chunk(want: int, length: int) -> int:
    c = min(want, length)
    while length % c:
        c -= 1
    return c


def attention(q, k, v, *, impl: str, spec: AttnSpec, q_pos, kv_pos):
    if impl == "naive":
        return naive_attention(q, k, v, spec=spec, q_pos=q_pos, kv_pos=kv_pos)
    if impl == "chunked":
        # clamp chunk sizes to divisors of the sequence lengths
        spec = dataclasses.replace(
            spec,
            q_chunk=_divisor_chunk(spec.q_chunk, q.shape[1]),
            kv_chunk=_divisor_chunk(spec.kv_chunk, k.shape[1]),
        )
        return flash_attention(spec, q, k, v, q_pos, kv_pos)
    if impl == "pallas":
        from repro_torch.kernels.flash_attention import ops as fa_ops
        # the reference's 512-row blocks, clamped to divisors of the lengths
        # (the same blocks wherever the reference's contract holds); they
        # set the burst model and the plain version's tiling, while the
        # CUDA kernels tile on their own
        return fa_ops.flash_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                      causal=spec.causal, window=spec.window,
                                      bq=_divisor_chunk(512, q.shape[1]),
                                      bk=_divisor_chunk(512, k.shape[1]))
    raise ValueError(f"unknown attention impl {impl!r}")
