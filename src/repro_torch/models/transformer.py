"""Model assembly — the port of ``repro.models.transformer`` for training
the dense family.

Layer weights stay stacked on a leading ``L`` axis, exactly as the
reference's ``init_params`` makes them, so a parameter tree converted from
the reference is a leaf-for-leaf copy, checkpoint leaf paths are the same,
and gradients accumulate into the stacked leaves.  The reference's
``lax.scan`` over the stack becomes a loop over ``unbind(0)`` views (whose
backward stacks the per-layer gradients in one pass), and ``jax.checkpoint``
(``flags.remat``) becomes ``torch.utils.checkpoint`` around each layer body:
the forward of every layer runs again in the backward, so under
``attn_impl="pallas"`` one step launches the attention forward kernel 2·L
times and each backward kernel L times.

Single device: the reference's sharding context (``ShardCtx``) has no
counterpart yet, and ``ctx`` must be ``None``.  Families other than dense,
and the prefill / decode / cache entry points, are not ported yet
(ROADMAP queue A, items 9 and 10).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._tree import tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.attention import AttnSpec, attention


@dataclasses.dataclass(frozen=True)
class RunFlags:
    """The reference's run-time knobs that the dense training path reads
    (its MoE, RWKV and sharding knobs come with those items; remat is
    always of whole layers, the reference's ``remat_policy="full"``)."""
    attn_impl: str = "chunked"          # naive | chunked | pallas
    q_chunk: int = 512
    kv_chunk: int = 512
    skip_masked_tiles: bool = False     # causal tile skipping (chunked)
    microbatches: int = 1               # grad-accumulation microbatches
    remat: bool = True
    compute_dtype: str = "bfloat16"     # bfloat16 | float32 (oracle mode)


_NOT_PORTED = ("the port trains the dense family only; {what} waits for "
               "ROADMAP queue A item 9")


def _check(cfg: ModelConfig, ctx: Any = None) -> None:
    if ctx is not None:
        raise NotImplementedError(
            "the port runs on one device: ctx (a sharding context) must be "
            "None until the multi-device item of ROADMAP queue A item 12")
    if cfg.family != "dense" or cfg.moe is not None or cfg.frontend != "tokens":
        raise NotImplementedError(_NOT_PORTED.format(
            what=f"family {cfg.family!r} (arch {cfg.arch})"))


def padded_vocab(cfg: ModelConfig) -> int:
    return -(-cfg.vocab_size // 16) * 16


def cast_params(params, dtype=torch.bfloat16):
    """Compute-dtype cast inside the differentiated function, so fp32
    masters get fp32 gradients (the cast is part of the autograd graph)."""
    return tree_map(lambda a: a.to(dtype) if a.dtype == torch.float32 else a,
                    params)


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def _attn_init(gen, cfg: ModelConfig, dtype, pre=()):
    d = cfg.d_model
    return {
        "wq": layers.dense_init(gen, d, cfg.d_q, dtype, shape_prefix=pre),
        "wk": layers.dense_init(gen, d, cfg.d_kv, dtype, shape_prefix=pre),
        "wv": layers.dense_init(gen, d, cfg.d_kv, dtype, shape_prefix=pre),
        "wo": layers.dense_init(gen, cfg.d_q, d, dtype, shape_prefix=pre),
    }


def init_params(cfg: ModelConfig, gen: Optional[torch.Generator],
                dtype=torch.float32) -> dict:
    """The reference's parameter tree (same leaf paths, shapes, dtypes),
    drawn from ``gen`` on its device (``gen=None``: shapes only, on the
    default device)."""
    _check(cfg)
    d = cfg.d_model
    Vp = padded_vocab(cfg)
    dev = gen.device if gen is not None else None
    ones = lambda *shape: torch.ones(shape, dtype=torch.float32, device=dev)
    params: dict = {"final_norm": ones(d)}
    params["embed"] = layers.embed_init(gen, Vp, d, dtype)
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(gen, d, Vp, dtype)
    L = cfg.n_layers
    params["blocks"] = {
        "attn": _attn_init(gen, cfg, dtype, pre=(L,)),
        "ln1": ones(L, d),
        "ln2": ones(L, d),
        "mlp": layers.mlp_init(gen, d, cfg.d_ff, cfg.mlp_type, dtype,
                               shape_prefix=(L,)),
    }
    return params


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed_lookup(cfg: ModelConfig, params, ids: torch.Tensor,
                 ctx: Any = None) -> torch.Tensor:
    _check(cfg, ctx)
    return params["embed"][ids.long()]


def lm_logits(cfg: ModelConfig, params, x: torch.Tensor,
              ctx: Any = None) -> torch.Tensor:
    """Logits over the PADDED vocab: the padded rows of the (tied)
    embedding take part in the softmax, as in the reference."""
    _check(cfg, ctx)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].t().to(x.dtype)
    return x @ params["lm_head"].to(x.dtype)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _qkv(cfg, w, x, pos):
    B, S, _ = x.shape
    q = (x @ w["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = (x @ w["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ w["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    q = layers.apply_rope(q, pos, cfg.rope)
    k = layers.apply_rope(k, pos, cfg.rope)
    return q, k, v


def attn_block(cfg, flags: RunFlags, ctx, w, ln, x, pos, *, window=0):
    h = layers.rms_norm(x, ln, cfg.norm_eps)
    q, k, v = _qkv(cfg, w, h, pos)
    spec = AttnSpec(causal=cfg.causal, window=window, q_chunk=flags.q_chunk,
                    kv_chunk=flags.kv_chunk,
                    skip_masked_tiles=flags.skip_masked_tiles,
                    positions_are_arange=True)
    o = attention(q, k, v, impl=flags.attn_impl, spec=spec, q_pos=pos,
                  kv_pos=pos)
    B, S, _ = x.shape
    return x + o.reshape(B, S, cfg.d_q) @ w["wo"]


def mlp_block(cfg, w, ln, x):
    h = layers.rms_norm(x, ln, cfg.norm_eps)
    return x + layers.mlp_apply(w, h, cfg.mlp_type)


def _layer(cfg, flags, pos, x, wl):
    x = attn_block(cfg, flags, None, wl["attn"], wl["ln1"], x, pos)
    return mlp_block(cfg, wl["mlp"], wl["ln2"], x)


def _unstack(tree, L: int):
    """[tree of layer l] for l < L, from views of each stacked leaf."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, L) for k, v in tree.items()}
        return [{k: per[k][l] for k in per} for l in range(L)]
    return list(tree.unbind(0))


def forward(cfg: ModelConfig, params, batch: dict, flags: RunFlags,
            ctx: Any = None):
    """Returns (hidden (B,S,d), aux_losses, None)."""
    _check(cfg, ctx)
    cdt = getattr(torch, flags.compute_dtype)
    ids = batch["tokens"]
    B, S = ids.shape
    pos = torch.arange(S, dtype=torch.int32,
                       device=ids.device).expand(B, S)
    x = embed_lookup(cfg, params, ids).to(cdt)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for wl in _unstack(params["blocks"], cfg.n_layers):
        if flags.remat:
            x = checkpoint(_layer, cfg, flags, pos, x, wl, use_reentrant=False)
        else:
            x = _layer(cfg, flags, pos, x, wl)
    return x, aux, None


# ---------------------------------------------------------------------------
# Loss (train)
# ---------------------------------------------------------------------------


def make_loss_fn(cfg: ModelConfig, flags: RunFlags, ctx: Any = None):
    _check(cfg, ctx)

    def loss_fn(params, batch):
        params = cast_params(params, getattr(torch, flags.compute_dtype))
        x, aux, _ = forward(cfg, params, batch, flags, ctx)
        logits = lm_logits(cfg, params, x, ctx)
        loss, _ = layers.softmax_cross_entropy(logits, batch["labels"],
                                               batch.get("loss_mask"))
        return loss + 0.01 * aux, {"loss": loss, "aux": aux}
    return loss_fn
