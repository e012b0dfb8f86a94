"""Model assembly — the port of ``repro.models.transformer`` for all six
families: dense, moe, audio (an encoder over precomputed frames), vlm
(a text stack with gated cross attention over precomputed patches), ssm
(rwkv6) and hybrid (zamba2): training, prefill and decode.

Layer weights stay stacked on leading axes exactly as the reference's
``init_params`` makes them (``L`` for dense, moe, audio and ssm,
``(n_cross, per)`` for the vlm's self-attention layers, ``(n_super, per)``
for the hybrid's mamba layers), so a parameter tree converted from the
reference is a leaf-for-leaf copy, checkpoint leaf paths are the same, and
gradients accumulate into the stacked leaves.  The reference's
``lax.scan`` over the stack becomes a Python loop over the layers, and
``jax.checkpoint`` (``flags.remat``) becomes ``torch.utils.checkpoint``
around each attention layer and each rwkv6 layer of a training forward:
the forward of every such layer runs again in the backward, so under
``attn_impl="pallas"`` one dense step launches the attention forward
kernel 2·L times and each backward kernel L times, and an ssm step the
WKV-6 kernel 2·L times.

Three entry points, as in the reference: ``make_loss_fn``,
``make_prefill_fn`` -> (last logits, cache) and ``make_decode_fn`` (one
token with the cache).  The training forward and the prefill of an ssm /
hybrid model start every scan from no state, which routes them through
the WKV-6 / SSD scan kernels (``models/rwkv6.py``, ``models/mamba2.py``);
their wrappers differentiate by recompute through the reference's own
lax-scan arithmetic (``kernels/_recompute.py``).  The moe layer is
``models/moe.py``'s sort-based dispatch, over chunks of
``flags.moe_seq_chunk`` positions as in the reference.  Prefill and decode
run without autograd.  Decode writes the token's k / v (and a hybrid's
window entries) into the cache it was given, in place, and returns the
other state leaves as new tensors (see ``make_decode_fn``).

Sharding (``ctx``, a ``ShardCtx``): the reference partitions the same
programs with GSPMD; the port runs them as explicit SPMD on local tensors
(``sharding/comm.py``).  The state lives as DTensors in the reference's
layouts (``sharding/specs.py``); each entry point — training, prefill and
decode alike — turns every leaf into the form its use needs
(``_compute_params``), this rank's share of every leaf that the
reference's rule splits, in the dim it splits (``_split_dim``; Megatron
tensor parallelism, the kernels on the local heads): the heads of
``wq`` / ``wk`` / ``wv`` / ``wo`` of self- and the vlm's cross attention
and a share of a dense MLP's hidden dim; rwkv6's time-mix on its heads
(the WKV-6 scan sees them) and its channel-mix on a share of its hidden
dim; the mamba2 layers on their heads (the SSD scan sees them; the gated
norm over all of ``d_in`` sums the group's squares,
``comm.reduce_model``); its rows of the vocab (the embedding lookup and
the logits, vocab-parallel as in the reference); its experts where the
model axis divides them (the pjit layer: ``moe_apply`` of this rank's
experts over the routing of all the data group's tokens;
``moe_mode="ep_shardmap"``: ``sharding/ep.py``).  Every other leaf is
whole (norms, gates, routers, rwkv6's token-shift mixes and LoRAs, the
mamba2 layers' ``B`` / ``C`` projections), but rwkv6's ``decay_B``, cut
to the columns of this rank's heads.  Activations carry the batch rows
of this rank's data shard where the data axes divide the batch
(``batch_specs``' rule), else all of them; the model group computes the
rest alike.  With
``sequence_parallel`` the residual stream between the layers of a dense /
moe / audio stack keeps this rank's share of the sequence.  The serving
cache is this rank's shard in ``cache_specs``' layout (rows on the data
axes, positions on the model axis): the prefill returns it, the decode
attends over its positions and combines the partial softmax over the
model group (``make_decode_fn``).  Kernels never see a DTensor.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch._tree import paths, tree_map, unflatten
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, mamba2, rwkv6
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import (AttnSpec, attention,
                                          combine_partials, decode_attention,
                                          decode_attention_partial)
from repro_torch.sharding import comm, ep


@dataclasses.dataclass(frozen=True)
class RunFlags:
    """The reference's run-time knobs that the ported paths read."""
    attn_impl: str = "chunked"          # naive | chunked | pallas
    q_chunk: int = 512
    kv_chunk: int = 512
    skip_masked_tiles: bool = False     # causal tile skipping (chunked)
    microbatches: int = 1               # grad-accumulation microbatches
    remat: bool = True
    moe_mode: str = "pjit"              # pjit | ep_shardmap (with a ctx)
    moe_seq_chunk: int = 2048           # chunk S for the MoE dispatch
                                        # (0 = no chunking)
    compute_dtype: str = "bfloat16"     # bfloat16 | float32 (oracle mode)
    wkv_chunk: int = 16                 # RWKV WKV chunk length
    remat_policy: str = "full"          # full | save_block_io
    sequence_parallel: bool = False     # Megatron-SP residual stream


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """The reference's sharding context: a mesh (``launch/mesh.py``; bound
    to the process group wherever a path communicates), the data axes and
    the model axis."""
    mesh: Any
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    # set by the entry points, never by callers: the activations that this
    # context travels with hold only this data rank's batch rows
    rows_split: bool = False

    @property
    def data_spec(self):
        return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]

    @property
    def msize(self) -> int:
        return self.mesh.axis_sizes[self.model_axis]

    @property
    def dsize(self) -> int:
        return math.prod(self.mesh.axis_sizes[a] for a in self.data_axes)

    def _coord(self) -> dict:
        return dict(zip(self.mesh.axis_names, self.mesh.coordinate()))

    @property
    def model_rank(self) -> int:
        return self._coord()[self.model_axis] if self.msize > 1 else 0

    @property
    def data_rank(self) -> int:
        if self.dsize == 1:
            return 0
        c, sizes = self._coord(), self.mesh.axis_sizes
        r = 0
        for a in self.data_axes:                 # major to minor
            r = r * sizes[a] + c[a]
        return r

    @property
    def model_group(self):
        return self.mesh.group((self.model_axis,))

    @property
    def data_group(self):
        return self.mesh.group(tuple(self.data_axes))

    def splits_batch(self, n: int) -> bool:
        """Whether a leading dim of ``n`` is sharded over the data axes
        (``batch_specs``' rule)."""
        return n % self.dsize == 0 and n > 1 and self.dsize > 1


def _constrain(x, ctx: Optional[ShardCtx], *spec):
    """The reference's sharding constraint on an activation.  Values are
    never changed; the one layout the port moves is the sequence split of
    the residual stream (a ``model`` entry on dim 1 of a (B, S, d)
    activation: this rank keeps its share of S, see ``_seq_gather``).
    Batch entries describe the layout activations already have."""
    if ctx is None or len(spec) < 2 or spec[1] != ctx.model_axis:
        return x
    if ctx.msize == 1 or x.shape[1] % ctx.msize:
        return x
    return comm.split_model(x, ctx, 1)


def _seq_gather(x, ctx: Optional[ShardCtx], S: int):
    """The whole sequence of a residual stream that ``_constrain`` split."""
    if ctx is None or x.shape[1] == S:
        return x
    return comm.gather_model(x, ctx, 1)


_FAMILIES = ("dense", "audio", "moe", "vlm", "hybrid", "ssm")


def _check(cfg: ModelConfig, ctx: Any = None) -> None:
    if ctx is not None and not isinstance(ctx, ShardCtx):
        raise TypeError(f"ctx must be a ShardCtx or None, not {type(ctx)}")
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} (arch {cfg.arch})")


def padded_vocab(cfg: ModelConfig) -> int:
    return -(-cfg.vocab_size // 16) * 16


def cast_params(params, dtype=torch.bfloat16):
    """Compute-dtype cast inside the differentiated function, so fp32
    masters get fp32 gradients (the cast is part of the autograd graph)."""
    return tree_map(lambda a: a.to(dtype) if a.dtype == torch.float32 else a,
                    params)


def _at(tree, *idx):
    """The tree of views ``leaf[idx]`` (one layer of a stacked tree)."""
    return tree_map(lambda a: a[idx], tree)


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
    if cfg.frontend != "frames":
        params["embed"] = layers.embed_init(gen, Vp, d, dtype)
    if not cfg.tie_embeddings or cfg.frontend == "frames":
        params["lm_head"] = layers.dense_init(gen, d, Vp, dtype)
    L = cfg.n_layers
    if cfg.family in ("dense", "audio", "moe"):
        blocks = {
            "attn": _attn_init(gen, cfg, dtype, pre=(L,)),
            "ln1": ones(L, d),
            "ln2": ones(L, d),
        }
        if cfg.moe is not None:
            blocks["moe"] = moe_lib.moe_init(gen, cfg, L, dtype)
        else:
            blocks["mlp"] = layers.mlp_init(gen, d, cfg.d_ff, cfg.mlp_type,
                                            dtype, shape_prefix=(L,))
        params["blocks"] = blocks
    elif cfg.family == "vlm":
        n_cross = L // cfg.cross_attn_period
        per = cfg.cross_attn_period - 1
        assert n_cross * cfg.cross_attn_period == L
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                           device=dev)
        params["blocks"] = {
            "attn": _attn_init(gen, cfg, dtype, pre=(n_cross, per)),
            "mlp": layers.mlp_init(gen, d, cfg.d_ff, cfg.mlp_type, dtype,
                                   shape_prefix=(n_cross, per)),
            "ln1": ones(n_cross, per, d),
            "ln2": ones(n_cross, per, d),
            "cross": {
                **_attn_init(gen, cfg, dtype, pre=(n_cross,)),
                "ln_q": ones(n_cross, d),
                "gate": zeros(n_cross),
                "mlp": layers.mlp_init(gen, d, cfg.d_ff, cfg.mlp_type, dtype,
                                       shape_prefix=(n_cross,)),
                "ln2": ones(n_cross, d),
                "gate_mlp": zeros(n_cross),
            },
        }
    elif cfg.family == "hybrid":
        n_super = L // cfg.attn_period
        per = cfg.attn_period - 1
        assert n_super * cfg.attn_period == L
        params["blocks"] = {
            "mamba": mamba2.mamba2_init(gen, cfg, dtype,
                                        shape_prefix=(n_super, per)),
            "mamba_ln": ones(n_super, per, d),
            "shared": {
                "attn": _attn_init(gen, cfg, dtype),
                "mlp": layers.mlp_init(gen, d, cfg.d_ff, cfg.mlp_type, dtype),
                "ln1": ones(d),
                "ln2": ones(d),
            },
        }
    else:                                                       # ssm
        params["blocks"] = {
            "rwkv": rwkv6.rwkv6_init(gen, cfg, dtype, shape_prefix=(L,)),
            "ln1": ones(L, d),
            "ln2": ones(L, d),
        }
    return params


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed_lookup(cfg: ModelConfig, params, ids: torch.Tensor,
                 ctx: Any = None) -> torch.Tensor:
    """Vocab-parallel under ``ctx`` (the reference's shard_map): each rank
    looks up the ids that fall in its rows of the table, zeros the rest,
    and the model group sums."""
    _check(cfg, ctx)
    table = params["embed"]
    if ctx is None:
        return table[ids.long()]
    table = _compute_leaf(table, ctx, 0, padded_vocab(cfg))
    if table.shape[0] == padded_vocab(cfg):
        return table[ids.long()]
    rows = table.shape[0]
    loc = ids.long() - ctx.model_rank * rows
    ok = (loc >= 0) & (loc < rows)
    emb = table[loc.clamp(0, rows - 1)]
    emb = torch.where(ok[..., None], emb, torch.zeros((), dtype=emb.dtype,
                                                      device=emb.device))
    return comm.from_model_region(emb, ctx)


def lm_logits(cfg: ModelConfig, params, x: torch.Tensor,
              ctx: Any = None) -> torch.Tensor:
    """Logits over the PADDED vocab: the padded rows of the (tied)
    embedding take part in the softmax, as in the reference.  Under
    ``ctx`` each rank computes the logits of its rows of the vocab (the
    reference's vocab-on-``model`` constraint) and the model group
    gathers them."""
    _check(cfg, ctx)
    norm = params["final_norm"]
    if ctx is not None:
        norm = _compute_leaf(norm, ctx, None)
    x = layers.rms_norm(x, norm, cfg.norm_eps)
    Vp = padded_vocab(cfg)
    tied = cfg.tie_embeddings and cfg.frontend != "frames"
    if ctx is None:
        w = params["embed"].t() if tied else params["lm_head"]
        return x @ w.to(x.dtype)
    if tied:
        w = _compute_leaf(params["embed"], ctx, 0, Vp).t()
    else:
        w = _compute_leaf(params["lm_head"], ctx, -1, Vp)
    if w.shape[-1] == Vp:
        return x @ w.to(x.dtype)
    logits = comm.to_model_region(x, ctx) @ w.to(x.dtype)
    return comm.gather_model(logits, ctx, -1)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _kv_for_heads(cfg, ctx, k, v, Hl):
    """The k / v heads that this rank's ``Hl`` query heads read, from all
    KH of them: a contiguous run of whole groups where the heads split
    along group bounds, else one k / v head per query head."""
    G = cfg.n_heads // cfg.n_kv_heads
    q0 = ctx.model_rank * Hl
    lo, hi = q0 // G, (q0 + Hl - 1) // G + 1
    if (q0 % G == 0 and Hl % G == 0) or hi - lo == 1:
        return (k[:, :, lo:hi].contiguous(), v[:, :, lo:hi].contiguous())
    idx = torch.arange(q0, q0 + Hl, device=k.device) // G
    return k.index_select(2, idx), v.index_select(2, idx)


def _heads_in(cfg, ctx, w, h):
    """(h, wk, wv, Hl) of an attention block over ``h``: where ``w["wq"]``
    holds this rank's ``Hl`` heads, ``h`` — and ``wk`` / ``wv`` where they
    hold all KH heads on every rank — enter through
    ``comm.to_model_region``, so their gradients are the group's sums."""
    Hl = w["wq"].shape[-1] // cfg.head_dim
    wk, wv = w["wk"], w["wv"]
    if Hl < cfg.n_heads:
        h = comm.to_model_region(h, ctx)
        if wk.shape[-1] == cfg.d_kv:        # all KH heads on every rank
            wk = comm.to_model_region(wk, ctx)
            wv = comm.to_model_region(wv, ctx)
    return h, wk, wv, Hl


def _heads_kv(cfg, ctx, k, v, Hl, return_kv):
    """(k, v that this rank's ``Hl`` query heads read, the (k, v) of all
    KH heads that a cache keeps, or None without ``return_kv``), from k /
    v (B, S, KH or this rank's KH share, hd)."""
    tp = Hl < cfg.n_heads
    kv = (k, v)
    if tp and k.shape[2] == cfg.n_kv_heads:
        k, v = _kv_for_heads(cfg, ctx, k, v, Hl)
    elif tp and return_kv:                  # the cache holds all KH heads
        kv = (comm.gather_model(k, ctx, 2), comm.gather_model(v, ctx, 2))
    return k, v, kv if return_kv else None


def _heads_out(cfg, ctx, w, o):
    """o (B, S, Hl, hd) through ``w["wo"]``: where ``o`` is this rank's
    heads', the model group sums their shares of the projection."""
    B, S, Hl, hd = o.shape
    y = o.reshape(B, S, Hl * hd) @ w["wo"]
    return comm.from_model_region(y, ctx) if Hl < cfg.n_heads else y


def _attn_out(cfg, flags: RunFlags, ctx, w, ln, x, pos, *, window=0,
              return_kv=False):
    """The attention block's output projection (this rank's share of the
    sum where it runs on its own heads) and, with ``return_kv``, the
    layer's k / v (all KH heads)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    h, wk, wv, Hl = _heads_in(cfg, ctx, w,
                              layers.rms_norm(x, ln, cfg.norm_eps))
    q = (h @ w["wq"]).reshape(B, S, Hl, hd)
    k = (h @ wk).reshape(B, S, wk.shape[-1] // hd, hd)
    v = (h @ wv).reshape(B, S, wv.shape[-1] // hd, hd)
    q = layers.apply_rope(q, pos, cfg.rope)
    k = layers.apply_rope(k, pos, cfg.rope)
    k, v, kv = _heads_kv(cfg, ctx, k, v, Hl, return_kv)
    spec = AttnSpec(causal=cfg.causal, window=window, q_chunk=flags.q_chunk,
                    kv_chunk=flags.kv_chunk,
                    skip_masked_tiles=flags.skip_masked_tiles,
                    positions_are_arange=True)
    o = attention(q, k, v, impl=flags.attn_impl, spec=spec, q_pos=pos,
                  kv_pos=pos)
    y = o.reshape(B, S, Hl * hd) @ w["wo"]
    return (y, kv) if return_kv else y


def _heads_split(cfg, w) -> bool:
    return w["wq"].shape[-1] < cfg.d_q


def attn_block(cfg, flags: RunFlags, ctx, w, ln, x, pos, *, window=0,
               return_kv=False):
    """Under ``ctx``, where ``w["wq"]`` holds this rank's heads (see
    ``_compute_params``), the block runs on them: the kernels see the
    local heads (and their k / v heads, whole or picked from all KH where
    the model axis does not divide KH), and the model group sums the
    output projection."""
    y = _attn_out(cfg, flags, ctx, w, ln, x, pos, window=window,
                  return_kv=return_kv)
    y, kv = y if return_kv else (y, None)
    if _heads_split(cfg, w):
        y = comm.from_model_region(y, ctx)
    out = x + y
    return (out, kv) if return_kv else out


def _mlp_split(cfg, w) -> bool:
    up = w["w_up"] if cfg.mlp_type == "swiglu" else w["w_in"]
    return up.shape[-1] < cfg.d_ff


def _mlp_out(cfg, ctx, w, ln, x):
    """The mlp's output (this rank's share of the sum where the weights
    hold its share of the hidden dim)."""
    h = layers.rms_norm(x, ln, cfg.norm_eps)
    if _mlp_split(cfg, w):
        h = comm.to_model_region(h, ctx)
    return layers.mlp_apply(w, h, cfg.mlp_type)


def _mlp_sum(cfg, ctx, w, ln, x):
    """The mlp's output: under ``ctx``, where the weights hold this rank's
    share of the hidden dim, the model group sums the shares."""
    y = _mlp_out(cfg, ctx, w, ln, x)
    return comm.from_model_region(y, ctx) if _mlp_split(cfg, w) else y


def mlp_block(cfg, w, ln, x, ctx=None):
    return x + _mlp_sum(cfg, ctx, w, ln, x)


def _moe_tokens(cfg, flags: RunFlags, ctx, w_moe, ht):
    """(out, aux) of the moe layer over the tokens ``ht`` (T, d)."""
    if ctx is None:
        return moe_lib.moe_apply(w_moe, ht, cfg)
    if flags.moe_mode == "ep_shardmap":
        return ep.moe_apply_ep(w_moe, ht, cfg, ctx)
    if flags.moe_mode != "pjit":
        raise ValueError(f"unknown moe_mode {flags.moe_mode!r}")
    # the reference's pjit layer: global semantics over every data
    # shard's tokens (capacity and drops), as GSPMD runs it
    x = comm.gather_data(ht, ctx) if ctx.rows_split else ht
    up = w_moe["w_gate"] if cfg.mlp_type == "swiglu" else w_moe["w_in"]
    El = up.shape[-3]
    split = El < cfg.moe.n_experts
    # this rank's experts: the model group's shares of the output sum to
    # the layer's, and so do its shares of the gradient of the tokens and
    # of the combine weights (the router is whole)
    out, aux = moe_lib.moe_apply(
        w_moe, x, cfg, ctx.model_rank * El if split else 0,
        region=(lambda t: comm.to_model_region(t, ctx)) if split else None)
    if ctx.rows_split:
        out = comm.data_chunk(out, ctx)
    if split:                   # the sum of the shares, over its rows only
        out = comm.from_model_region(out, ctx)
    return out, aux


def moe_block(cfg, flags: RunFlags, ctx, w_moe, ln, x):
    """The moe layer over x (B, S, d): the dispatch runs over chunks of
    ``flags.moe_seq_chunk`` positions (all B rows of a chunk together)
    where that divides S, and the aux loss is their mean.  Under ``ctx``,
    ``flags.moe_mode`` picks the reference's pjit layer or its
    expert-parallel one (``sharding/ep.py``).  Returns (x + y, aux)."""
    _check(cfg, ctx)
    B, S, d = x.shape
    h = layers.rms_norm(x, ln, cfg.norm_eps)
    ch = flags.moe_seq_chunk
    if ch and S > ch and S % ch == 0:
        nc = S // ch
        hc = h.reshape(B, nc, ch, d)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        ys = []
        for i in range(nc):
            y, a = _moe_tokens(cfg, flags, ctx, w_moe,
                               hc[:, i].reshape(B * ch, d))
            aux = aux + a
            ys.append(y.reshape(B, ch, d))
        y = torch.stack(ys, dim=1).reshape(B, S, d)
        aux = aux / nc
    else:
        y, aux = _moe_tokens(cfg, flags, ctx, w_moe, h.reshape(B * S, d))
        y = y.reshape(B, S, d)
    return x + y, aux


def _layer(cfg, flags, ctx, pos, x, wl):
    """One attention layer and its mlp or moe -> (x, aux or None).  With
    ``sequence_parallel`` the layer takes and returns this rank's share of
    the sequence."""
    x = _seq_gather(x, ctx, pos.shape[1])
    x = attn_block(cfg, flags, ctx, wl["attn"], wl["ln1"], x, pos)
    if "moe" in wl:
        x, a = moe_block(cfg, flags, ctx, wl["moe"], wl["ln2"], x)
    else:
        x, a = mlp_block(cfg, wl["mlp"], wl["ln2"], x, ctx), None
    return _residual_split(x, flags, ctx), a


def _residual_split(x, flags, ctx):
    """The reference's constraint on the residual stream between layers:
    (data, model with ``sequence_parallel``, None)."""
    if ctx is None:
        return x
    return _constrain(x, ctx, ctx.data_spec,
                      ctx.model_axis if flags.sequence_parallel else None,
                      None)


def _layer_block_io(cfg, flags, ctx, pos, x, wl):
    """``_layer`` under ``remat_policy="save_block_io"``: the attention
    and the mlp (or moe) bodies are recomputed in the backward, their
    outputs after the model group's sum are kept (the reference saves
    ``attn_out`` and ``mlp_out``), so the recompute runs only local math.
    Selective checkpointing (``create_selective_checkpoint_contexts``)
    cannot say this: it replays every op of the function and only swaps
    in saved outputs, so the collectives before a saved output would run
    again."""
    x = _seq_gather(x, ctx, pos.shape[1])
    y = _ckpt(_attn_out, cfg, flags, ctx, wl["attn"], wl["ln1"], x, pos)
    if _heads_split(cfg, wl["attn"]):
        y = comm.from_model_region(y, ctx)
    x = x + y
    if "moe" in wl:
        x, a = _ckpt(moe_block, cfg, flags, ctx, wl["moe"], wl["ln2"], x)
    else:
        y = _ckpt(_mlp_out, cfg, ctx, wl["mlp"], wl["ln2"], x)
        if _mlp_split(cfg, wl["mlp"]):
            y = comm.from_model_region(y, ctx)
        x, a = x + y, None
    return _residual_split(x, flags, ctx), a


def _ckpt(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


def _remat_layer(cfg, flags, ctx, pos, x, wl):
    """A training layer under ``flags.remat`` and its policy."""
    if not flags.remat:
        return _layer(cfg, flags, ctx, pos, x, wl)
    if flags.remat_policy == "save_block_io":
        return _layer_block_io(cfg, flags, ctx, pos, x, wl)
    if flags.remat_policy != "full":
        raise ValueError(f"unknown remat_policy {flags.remat_policy!r}")
    return _ckpt(_layer, cfg, flags, ctx, pos, x, wl)


def _add_aux(aux, a):
    return aux if a is None else aux + a


def _unstack(tree, L: int):
    """[tree of layer l] for l < L, from views of each stacked leaf."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, L) for k, v in tree.items()}
        return [{k: per[k][l] for k in per} for l in range(L)]
    return list(tree.unbind(0))


# ---------------------------------------------------------------------------
# Full-sequence forward (train / prefill) per family
# ---------------------------------------------------------------------------


def _forward_dense(cfg, flags, ctx, bl, x, pos, aux, collect_cache,
                   kv_keep=None):
    """dense, audio and moe: one attention layer and its mlp or moe a
    layer."""
    kvs = []
    if not collect_cache:
        x = _residual_split(x, flags, ctx)
    for wl in _unstack(bl, cfg.n_layers):
        if collect_cache:
            x, kv = attn_block(cfg, flags, ctx, wl["attn"], wl["ln1"], x,
                               pos, return_kv=True)
            if "moe" in wl:
                x, a = moe_block(cfg, flags, ctx, wl["moe"], wl["ln2"], x)
                aux = aux + a
            else:
                x = mlp_block(cfg, wl["mlp"], wl["ln2"], x, ctx)
            kvs.append(kv_keep(*kv) if kv_keep else kv)
            continue
        x, a = _remat_layer(cfg, flags, ctx, pos, x, wl)
        aux = _add_aux(aux, a)
    if not collect_cache:
        return _seq_gather(x, ctx, pos.shape[1]), aux, None
    return x, aux, {"k": torch.stack([k for k, _ in kvs]),    # (L,B,S,KH,hd)
                    "v": torch.stack([v for _, v in kvs])}


def _cross_block(cfg, flags, ctx, cw, x, pos, patches, ppos,
                 return_kv=False):
    """The vlm's gated cross attention over the patches (non-causal) and
    its gated mlp -> (x, (k, v) of the patches, all KH heads, or None).
    Under ``ctx``, where ``cw["wq"]`` holds this rank's heads, the block
    runs on them as a self-attention block does (``_heads_in``,
    ``_heads_kv``: the patches' k / v of this rank's KV heads, or picked
    from all of them where ``wk`` / ``wv`` are whole; gathered over the
    model group for the cache), the model group sums ``wo``'s shares
    before the gate, and the gated mlp is split as a dense one is."""
    B, S, _ = x.shape
    M = patches.shape[1]
    hd = cfg.head_dim
    h, wk, wv, Hl = _heads_in(cfg, ctx, cw,
                              layers.rms_norm(x, cw["ln_q"], cfg.norm_eps))
    q = (h @ cw["wq"]).reshape(B, S, Hl, hd)
    k = (patches @ wk).reshape(B, M, wk.shape[-1] // hd, hd)
    v = (patches @ wv).reshape(B, M, wv.shape[-1] // hd, hd)
    k, v, kv = _heads_kv(cfg, ctx, k, v, Hl, return_kv)
    spec = AttnSpec(causal=False, q_chunk=flags.q_chunk,
                    kv_chunk=flags.kv_chunk)
    o = attention(q, k, v, impl=flags.attn_impl, spec=spec, q_pos=pos,
                  kv_pos=ppos)
    x = x + torch.tanh(cw["gate"]).to(x.dtype) * _heads_out(cfg, ctx, cw, o)
    x = x + torch.tanh(cw["gate_mlp"]).to(x.dtype) * \
        _mlp_sum(cfg, ctx, cw["mlp"], cw["ln2"], x)
    return x, kv


def _forward_vlm(cfg, flags, ctx, bl, x, pos, patches, collect_cache,
                 kv_keep=None):
    """Each super-layer: ``per`` self-attention layers, then the gated
    cross attention over the patch embeddings."""
    n_cross, per = bl["ln1"].shape[:2]
    M = patches.shape[1]
    ppos = torch.arange(M, dtype=torch.int32,
                        device=patches.device).expand(patches.shape[0], M)
    self_w = {n: bl[n] for n in ("attn", "mlp", "ln1", "ln2")}
    kvs, cross = [], []
    for ci in range(n_cross):
        for pi in range(per):
            wl = _at(self_w, ci, pi)
            if collect_cache:
                x, kv = attn_block(cfg, flags, ctx, wl["attn"], wl["ln1"], x,
                                   pos, return_kv=True)
                x = mlp_block(cfg, wl["mlp"], wl["ln2"], x, ctx)
                kvs.append(kv_keep(*kv) if kv_keep else kv)
            else:
                x, _ = _remat_layer(cfg, flags, ctx, pos, x, wl)
        x, ckv = _cross_block(cfg, flags, ctx, _at(bl["cross"], ci), x,
                              pos, patches, ppos, return_kv=collect_cache)
        cross.append(ckv)
    if not collect_cache:
        return x, None
    return x, {"k": torch.stack([k for k, _ in kvs]),     # (n_self,B,S,KH,hd)
               "v": torch.stack([v for _, v in kvs]),
               "cross_k": torch.stack([k for k, _ in cross]),
               "cross_v": torch.stack([v for _, v in cross])}


def _forward_hybrid(cfg, flags, ctx, bl, x, pos, collect_cache):
    shared = bl["shared"]
    n_super, per = bl["mamba_ln"].shape[:2]
    states, tails, win_k, win_v = [], [], [], []
    for si in range(n_super):
        for pi in range(per):
            h = layers.rms_norm(x, bl["mamba_ln"][si, pi], cfg.norm_eps)
            y, (st, tl) = mamba2.mamba2_forward(_at(bl["mamba"], si, pi), h,
                                                cfg, ctx)
            x = x + y
            if collect_cache:
                states.append(st)
                tails.append(tl)
        if collect_cache:
            x, (k, v) = attn_block(cfg, flags, ctx, shared["attn"],
                                   shared["ln1"], x, pos,
                                   window=cfg.attn_window, return_kv=True)
        else:
            x = attn_block(cfg, flags, ctx, shared["attn"], shared["ln1"], x,
                           pos, window=cfg.attn_window)
        x = mlp_block(cfg, shared["mlp"], shared["ln2"], x, ctx)
        if collect_cache:
            W = min(cfg.attn_window or x.shape[1], x.shape[1])
            # copies: views would keep each layer's whole k / v alive
            win_k.append(k[:, -W:].clone())
            win_v.append(v[:, -W:].clone())
    if not collect_cache:
        return x, None
    grid = lambda ts: torch.stack(ts).reshape((n_super, per) + ts[0].shape)
    return x, {"mamba_state": grid(states),
               "conv_tails": tuple(grid([t[i] for t in tails])
                                   for i in range(3)),
               "win_k": torch.stack(win_k), "win_v": torch.stack(win_v)}


def _cmix_ctx(cfg, w, ctx):
    """The context of a channel-mix whose ``w_k`` / ``w_v`` hold this
    rank's share of the hidden dim, else None."""
    return ctx if w["w_k"].shape[-1] < cfg.d_ff else None


def _ssm_layer(cfg, flags, ctx, w, ln1, ln2, x, collect_cache=False):
    """One rwkv6 layer from no state -> x, or (x, its cache parts: the
    WKV state of this rank's heads where ``w`` holds them)."""
    h = layers.rms_norm(x, ln1, cfg.norm_eps)
    shift0 = torch.zeros((h.shape[0], 1, h.shape[2]), dtype=h.dtype,
                         device=h.device)
    # state None: a zero state, through the WKV-6 kernel
    y, tshift, tstate = rwkv6.time_mix(w["tmix"], h, cfg, shift0, None,
                                       chunk=flags.wkv_chunk, ctx=ctx)
    x = x + y
    h = layers.rms_norm(x, ln2, cfg.norm_eps)
    y, cshift = rwkv6.channel_mix(w["cmix"], h, shift0,
                                  _cmix_ctx(cfg, w["cmix"], ctx))
    x = x + y
    return (x, (tshift, tstate, cshift)) if collect_cache else x


def _forward_ssm(cfg, flags, ctx, bl, x, collect_cache):
    """Training under ``flags.remat`` recomputes each layer in the
    backward, as the reference's ``jax.checkpoint`` of its scan body does
    (either policy: the body names no output to keep)."""
    parts = []
    for li in range(cfg.n_layers):
        args = (cfg, flags, ctx, _at(bl["rwkv"], li), bl["ln1"][li],
                bl["ln2"][li], x)
        if collect_cache:
            x, p = _ssm_layer(*args, collect_cache=True)
            parts.append(p)
        elif flags.remat:
            x = _ckpt(_ssm_layer, *args)
        else:
            x = _ssm_layer(*args)
    if not collect_cache:
        return x, None
    return x, {name: torch.stack([p[i] for p in parts]) for i, name in
               enumerate(("tmix_shift", "wkv_state", "cmix_shift"))}


def forward(cfg: ModelConfig, params, batch: dict, flags: RunFlags,
            ctx: Any = None, *, collect_cache: bool = False, kv_keep=None):
    """Returns (hidden (B,S,d), aux_losses, cache_parts or None).
    ``kv_keep`` maps each self-attention layer's collected (k, v) to what
    the cache keeps of them (a sharded prefill: its slice)."""
    _check(cfg, ctx)
    cdt = getattr(torch, flags.compute_dtype)
    if cfg.frontend == "frames":
        x = batch["frames"].to(cdt)
        B, S = x.shape[:2]
        pos = torch.arange(S, dtype=torch.int32,
                           device=x.device).expand(B, S)
        x = x + layers.sinusoidal_positions(pos, cfg.d_model).to(x.dtype)
    else:
        ids = batch["tokens"]
        B, S = ids.shape
        pos = torch.arange(S, dtype=torch.int32,
                           device=ids.device).expand(B, S)
        x = embed_lookup(cfg, params, ids, ctx).to(cdt)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    bl = params["blocks"]
    if cfg.family in ("dense", "audio", "moe"):
        x, aux, cache = _forward_dense(cfg, flags, ctx, bl, x, pos, aux,
                                       collect_cache, kv_keep)
    elif cfg.family == "vlm":
        x, cache = _forward_vlm(cfg, flags, ctx, bl, x, pos,
                                batch["patches"].to(cdt), collect_cache,
                                kv_keep)
    elif cfg.family == "hybrid":
        x, cache = _forward_hybrid(cfg, flags, ctx, bl, x, pos,
                                   collect_cache)
    else:
        x, cache = _forward_ssm(cfg, flags, ctx, bl, x, collect_cache)
    return x, aux, cache


# ---------------------------------------------------------------------------
# Loss (train), prefill, decode factories
# ---------------------------------------------------------------------------


_MAMBA_SPLIT = {"w_z": -1, "w_x": -1, "w_dt": -1, "conv_x": -1, "A_log": -1,
                "D": -1, "dt_bias": -1, "norm": -1, "w_out": -2}
_TMIX_SPLIT = {"w_r": -1, "w_k": -1, "w_v": -1, "w_g": -1, "decay_w": -1,
               "decay_B": -1, "w_o": -2, "u": -2, "ln": -2}
_CMIX_SPLIT = {"w_k": -1, "w_v": -2}


def _split_dim(cfg, flags: RunFlags, ctx: ShardCtx, path: str,
               ndim: int) -> Optional[int]:
    """The dim of a parameter leaf that stays split over the model axis
    in the form this rank computes with (None: the whole leaf).  It is
    the dim that the reference's ``_param_rule`` splits, under the rule's
    divisibility conditions, taken by whole blocks: a block's leaves are
    split where the model axis divides its heads (attention, the vlm's
    cross attention, rwkv6's time-mix, the mamba2 layer) or its hidden dim
    (a dense mlp, the cross block's mlp, rwkv6's channel-mix), else all
    whole.  One leaf more is cut than stored split: the time-mix's
    ``decay_B`` (whole in the reference's layout), to the columns of this
    rank's heads, so that each rank computes only its heads' decay; its
    gradient comes back whole, in its own layout (``_compute_leaf``: the
    model group gathers the columns' gradients)."""
    m = ctx.msize
    if m == 1:
        return None
    leaf = path.rsplit("/", 1)[-1]
    if path in ("embed", "lm_head"):
        return (0 if path == "embed" else ndim - 1) \
            if padded_vocab(cfg) % m == 0 else None
    cross_attn = path.startswith("blocks/cross/") and \
        leaf in ("wq", "wk", "wv", "wo")
    if ("/attn/" in f"/{path}" or cross_attn) and cfg.n_heads % m == 0:
        if leaf == "wq":
            return ndim - 1
        if leaf == "wo":
            return ndim - 2
        if leaf in ("wk", "wv") and cfg.n_kv_heads % m == 0:
            return ndim - 1
        return None
    if path.startswith(("blocks/mlp/", "blocks/shared/mlp/",
                        "blocks/cross/mlp/")) and cfg.d_ff % m == 0:
        if leaf in ("w_gate", "w_up", "w_in"):
            return ndim - 1
        if leaf in ("w_down", "w_out"):
            return ndim - 2
    if path.startswith("blocks/moe/") and leaf != "router":
        if flags.moe_mode == "ep_shardmap" and cfg.moe.n_experts % m:
            raise ValueError(f"ep_shardmap needs the model axis ({m}) to "
                             f"divide the {cfg.moe.n_experts} experts")
        # pjit: the reference's rule puts the experts on the model axis
        # where it divides them, else they stay whole
        return 1 if cfg.moe.n_experts % m == 0 else None
    rules, n = {}, 0
    if path.startswith("blocks/mamba/"):
        rules, n = _MAMBA_SPLIT, mamba2.dims(cfg)[1]
    elif path.startswith("blocks/rwkv/tmix/"):
        rules, n = _TMIX_SPLIT, cfg.n_heads
    elif path.startswith("blocks/rwkv/cmix/"):
        rules, n = _CMIX_SPLIT, cfg.d_ff
    if leaf in rules and n % m == 0:
        return ndim + rules[leaf]
    return None


def _compute_leaf(t, ctx: ShardCtx, dim: Optional[int],
                  full: Optional[int] = None):
    """``t`` in the form this rank computes with: this rank's chunk of
    dim ``dim`` along the model axis (``dim`` None: the whole tensor),
    whole along the data axes.  A DTensor is redistributed so that
    autograd brings its gradient back in its own layout (summed over the
    data axes, whose ranks hold shares of the loss); one stored whole on
    the model axis is cut by ``comm.split_model``, whose backward gathers
    the chunks' gradients; a plain tensor is narrowed (a view; a tensor
    whose ``dim`` is not ``full`` long is taken as already narrowed).
    Mesh dims of one rank are never moved."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if isinstance(t, DTensor):
        mesh, cur = t.device_mesh, t.placements
        want, grad, cut = [], [], False
        for i, name in enumerate(mesh.mesh_dim_names):
            if mesh.size(i) == 1:
                want.append(cur[i])
                grad.append(cur[i])
                continue
            keep = name == ctx.model_axis and dim is not None
            # a leaf stored whole on the model axis is cut by
            # comm.split_model below, outside DTensor's collectives
            cut = cut or (keep and isinstance(cur[i], Replicate))
            want.append(Shard(dim % t.dim()) if keep and not cut
                        else Replicate())
            grad.append(Partial() if name in ctx.data_axes else want[-1])
        if tuple(want) != tuple(cur):
            t = t.redistribute(mesh, want)
        t = t.to_local(grad_placements=grad)
        return comm.split_model(t, ctx, dim) if cut else t
    if dim is None or ctx.msize == 1:
        return t
    dim %= t.dim()
    if full is not None and t.shape[dim] != full:
        return t
    n = t.shape[dim] // ctx.msize
    return t.narrow(dim, ctx.model_rank * n, n)


def _compute_params(cfg, flags: RunFlags, params, ctx: Optional[ShardCtx]):
    """Every leaf in the form this rank computes with (see the module
    docstring), in training and serving alike."""
    if ctx is None:
        return params
    return unflatten(params, [
        _compute_leaf(t, ctx, _split_dim(cfg, flags, ctx, p, t.dim()))
        for p, t in paths(params)])


def make_loss_fn(cfg: ModelConfig, flags: RunFlags, ctx: Any = None):
    """``loss_fn(params, batch) -> (loss, {"loss", "aux"})``.  Under
    ``ctx`` the batch is the global one (every rank the same): each rank
    takes its data shard's rows where the data axes divide the batch, and
    the first value is this rank's share of the loss — the shares of the
    data group sum to the loss, so autograd's gradients are shares too and
    the DTensor parameters get their sum.  The metrics are global."""
    _check(cfg, ctx)

    def loss_fn(params, batch):
        params = cast_params(params, getattr(torch, flags.compute_dtype))
        if ctx is None:
            x, aux, _ = forward(cfg, params, batch, flags, ctx)
            logits = lm_logits(cfg, params, x, ctx)
            loss, _ = layers.softmax_cross_entropy(logits, batch["labels"],
                                                   batch.get("loss_mask"))
            return loss + 0.01 * aux, {"loss": loss, "aux": aux}
        params = _compute_params(cfg, flags, params, ctx)
        split = ctx.splits_batch(batch["labels"].shape[0])
        lctx = dataclasses.replace(ctx, rows_split=split)
        if split:
            batch = {k: comm.data_chunk(v, ctx) for k, v in batch.items()}
        x, aux, _ = forward(cfg, params, batch, flags, lctx)
        logits = lm_logits(cfg, params, x, lctx)
        mask = batch.get("loss_mask")
        if not split:                       # every data rank: all rows
            loss, _ = layers.softmax_cross_entropy(logits, batch["labels"],
                                                   mask)
            share = loss / ctx.dsize
        else:
            nll = layers.token_nll(logits, batch["labels"])
            if mask is None:
                share = nll.sum() / (nll.numel() * ctx.dsize)
            else:
                denom = torch.clamp(comm.sum_data(mask.sum().float(), ctx),
                                    min=1.0)
                share = (nll * mask).sum() / denom
        # aux: the global aux of the pjit layer (the same on every rank),
        # or ep.py's (data shard 0's value, the data group's gradient)
        total = share + 0.01 * aux / ctx.dsize
        return total, {"loss": comm.sum_data(share, ctx), "aux": aux.detach()}
    return loss_fn


# ---------------------------------------------------------------------------
# The serving cache: cache_specs' layout, one rank's shard (without a
# context every leaf is whole on the one rank: one chunk, no gathers)
# ---------------------------------------------------------------------------


def _whole_specs(tree) -> dict:
    """A spec of all-None entries for each leaf of a cache tree."""
    return {n: tuple((None,) * a.dim() for a in t) if isinstance(t, tuple)
            else (None,) * t.dim() for n, t in tree.items()}


@functools.lru_cache(maxsize=64)
def cache_layout(cfg: ModelConfig, ctx: Optional[ShardCtx], B: int,
                 max_len: int, S: Optional[int] = None):
    """(meta tree of the whole cache, its ``cache_specs`` tree) of the
    serving cache of ``B`` rows and ``max_len`` positions; ``S``: a
    prefill's prompt length (a hybrid prefill's window is
    ``min(attn_window, S)`` long).  Without a context no entry is split.
    Cached: serving asks for the same few layouts again and again; the
    trees are read, never written."""
    from torch.utils._python_dispatch import _disable_current_modes
    from repro_torch.sharding.specs import cache_specs
    # shapes only: meta tensors that no dispatch mode (the dry run's
    # counter) takes for the program's
    with _disable_current_modes():
        shape = init_cache(cfg, B, max_len, device="meta")
        if S is not None and cfg.family == "hybrid":
            W = min(cfg.attn_window or S, S)
            for name in ("win_k", "win_v", "win_pos"):
                t = shape[name]
                shape[name] = torch.empty(t.shape[:2] + (W,) + t.shape[3:],
                                          dtype=t.dtype, device="meta")
    if ctx is None:
        return shape, _whole_specs(shape)
    return shape, cache_specs(cfg, shape, ctx.mesh,
                              data_axes=tuple(ctx.data_axes),
                              model_axis=ctx.model_axis)


def _entry_chunk(ctx: Optional[ShardCtx], entry) -> Tuple[int, int]:
    """(this rank's index, the number of chunks) along a spec entry."""
    if entry is None:
        return 0, 1
    if entry == ctx.model_axis:
        return ctx.model_rank, ctx.msize
    return ctx.data_rank, ctx.dsize


def _leaf_items(tree, specs):
    """(name, index in a tuple leaf or None, leaf, spec) of a cache tree."""
    for name, t in tree.items():
        if isinstance(t, tuple):
            for i, (a, sp) in enumerate(zip(t, specs[name])):
                yield name, i, a, sp
        else:
            yield name, None, t, specs[name]


def _rebuild(tree, items):
    out = {}
    for name, i, t in items:
        if i is None:
            out[name] = t
        else:
            out[name] = out.get(name, ()) + (t,)
    return out


def _local_dims(t, spec, ctx: Optional[ShardCtx], skip=()):
    """``t`` (whole along its spec's split dims but ``skip``) narrowed to
    this rank's chunk of each of them."""
    for d, entry in enumerate(spec):
        if d in skip:
            continue
        r, n = _entry_chunk(ctx, entry)
        if n > 1:
            t = t.narrow(d, r * (t.shape[d] // n), t.shape[d] // n)
    return t


def _whole_dims(t, spec, ctx: Optional[ShardCtx], skip=()):
    """``t`` (this rank's shard) gathered along its spec's split dims but
    ``skip``."""
    for d, entry in enumerate(spec):
        if d in skip or _entry_chunk(ctx, entry)[1] == 1:
            continue
        t = comm.gather_model(t, ctx, d) if entry == ctx.model_axis \
            else comm.gather_data(t, ctx, d)
    return t


def _only(entry, d: int, ndim: int) -> tuple:
    """A spec that splits dim ``d`` as ``entry`` does, and no other."""
    return tuple(entry if j == d else None for j in range(ndim))


def _rows_skip(name: str, split: bool) -> tuple:
    """The dims of a cache leaf that the rows of this rank already are."""
    return (_CACHE_BATCH_AXIS[name],) if split else ()


# the SSM state leaves (name, index in a tuple leaf) that the layers leave
# at this rank's heads (or channels) where their weights hold its heads
_HEAD_STATES = {("wkv_state", None), ("mamba_state", None),
                ("conv_tails", 0)}


def _state_heads(cfg, bl) -> bool:
    """Whether the SSM layers of ``bl`` (blocks in compute form) run on
    this rank's heads."""
    if cfg.family == "ssm":
        return bl["rwkv"]["tmix"]["u"].shape[-2] < cfg.n_heads
    if cfg.family == "hybrid":
        return bl["mamba"]["A_log"].shape[-1] < mamba2.dims(cfg)[1]
    return False


def _kept(name: str, i, spec, ctx: Optional[ShardCtx], split: bool,
          heads: bool) -> tuple:
    """The dims of a cache leaf that a step's tensor already holds as this
    rank's shard: its rows where the rank computes only its data shard's,
    and the model axis's dim of an SSM state that the layers left at this
    rank's heads (``heads``: they ran on them)."""
    skip = _rows_skip(name, split)
    if heads and (name, i) in _HEAD_STATES:
        skip += tuple(d for d, e in enumerate(spec) if e == ctx.model_axis)
    return skip


def _positions(spec, ctx: Optional[ShardCtx], dim: int, n_local: int) -> int:
    """The first position of this rank's slice along ``dim`` of a cache
    leaf (0 where the dim is whole)."""
    r, _ = _entry_chunk(ctx, spec[dim])
    return r * n_local


def _row_ctx(ctx: Optional[ShardCtx], B: int):
    """(whether this rank computes only its data shard's rows of a batch
    of ``B``, the context that its activations travel with)."""
    if ctx is None:
        return False, None
    split = ctx.splits_batch(B)
    return split, dataclasses.replace(ctx, rows_split=split)


def make_prefill_fn(cfg: ModelConfig, flags: RunFlags, ctx: Any,
                    max_len: int):
    """Returns fn(params, batch) -> (last_logits (B,Vp), cache dict).
    Under ``ctx`` the batch is the global one (every rank the same): a
    rank computes its data shard's rows where the data axes divide the
    batch (``batch_specs``' rule), with the split weights of training
    (``_compute_params``: its heads, its share of a dense MLP's hidden
    dim, its experts), and returns its rows' logits and its shard of the
    cache in ``cache_specs``' layout (``cache_layout``): k / v and
    ``kv_pos`` with their positions on the model axis (each layer's k / v
    of all KV heads, gathered over the model group where the heads are
    split, then cut to this rank's positions), a vlm's patches and a
    hybrid's window slots likewise, the SSM states with their heads on
    it (the layers leave the WKV / SSD states and the ``conv_x`` tail at
    this rank's heads where they ran on them; the token shifts and the
    ``conv_B`` / ``conv_C`` tails are cut).  Without a context the one
    rank's shard is the whole cache."""
    _check(cfg, ctx)

    @torch.no_grad()
    def prefill(params, batch):
        params = _compute_params(
            cfg, flags, cast_params(params, getattr(torch, flags.compute_dtype)),
            ctx)
        lead = batch["frames" if cfg.frontend == "frames" else "tokens"]
        B, S = lead.shape[:2]
        split, lctx = _row_ctx(ctx, B)
        if split:
            batch = {k: comm.data_chunk(v, ctx) for k, v in batch.items()}
        _, specs = cache_layout(cfg, ctx, B, max_len, S)
        kv_keep = None
        if "k" in specs:
            assert S <= max_len, (S, max_len)
            # this rank's positions of each layer's k / v, padded to its
            # slice
            Sl = max_len // _entry_chunk(ctx, specs["k"][2])[1]
            lo = _positions(specs["k"], ctx, 2, Sl)
            n = max(0, min(S, lo + Sl) - lo)

            def kv_keep(k, v):
                return tuple(F.pad(t.narrow(1, min(lo, S), n),
                                   (0, 0, 0, 0, 0, Sl - n)) for t in (k, v))
        x, _, parts = forward(cfg, params, batch, flags, lctx,
                              collect_cache=True, kv_keep=kv_keep)
        logits = lm_logits(cfg, params, x[:, -1:], lctx)[:, 0]
        dev = x.device
        out = {}
        if "k" in specs:
            p = torch.arange(lo, lo + Sl, dtype=torch.int32, device=dev)
            out["kv_pos"] = torch.where(p < S, p, torch.full_like(p, -1)) \
                .expand(x.shape[0], Sl).contiguous()
        if cfg.family == "hybrid":
            _window_ring(parts, S)
        heads = _state_heads(cfg, params["blocks"])
        items = []
        for name, i, t, spec in _leaf_items(parts, specs):
            if name not in ("k", "v"):        # k / v are this rank's already
                t = _local_dims(t, spec, ctx,
                                _kept(name, i, spec, ctx, split, heads))
            items.append((name, i, t))
        out.update(_rebuild(parts, items))
        out["pos"] = torch.full((B,), S, dtype=torch.int32, device=dev)
        return logits, {k: out[k] for k in specs}
    return prefill


def _window_ring(parts: dict, S: int) -> None:
    """Align a prefill's window cache to the decode ring-slot convention
    slot = pos % W: the collected slice holds positions S-W..S-1 at
    indices 0..W-1, so roll by (S - W) % W to place p at p % W; adds
    ``win_pos``."""
    W = parts["win_k"].shape[2]
    shift = (S - W) % W
    parts["win_k"] = torch.roll(parts["win_k"], shift, dims=2)
    parts["win_v"] = torch.roll(parts["win_v"], shift, dims=2)
    parts["win_pos"] = torch.roll(
        torch.arange(S - W, S, dtype=torch.int32,
                     device=parts["win_k"].device)
        .expand(parts["win_k"].shape[:3]), shift, dims=2)


def init_cache(cfg: ModelConfig, B: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """Empty cache for serving."""
    _check(cfg)
    z = lambda shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)
    i32 = torch.int32
    pos = z((B,), i32)
    if cfg.family in ("dense", "audio", "moe"):
        L, KH, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        return {
            "k": z((L, B, max_len, KH, hd)),
            "v": z((L, B, max_len, KH, hd)),
            "kv_pos": torch.full((B, max_len), -1, dtype=i32, device=device),
            "pos": pos,
        }
    if cfg.family == "vlm":
        L, KH, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        n_cross = L // cfg.cross_attn_period
        n_self = L - n_cross
        M = cfg.n_media_tokens
        return {
            "k": z((n_self, B, max_len, KH, hd)),
            "v": z((n_self, B, max_len, KH, hd)),
            "kv_pos": torch.full((B, max_len), -1, dtype=i32, device=device),
            "cross_k": z((n_cross, B, M, KH, hd)),
            "cross_v": z((n_cross, B, M, KH, hd)),
            "pos": pos,
        }
    if cfg.family == "hybrid":
        n_super = cfg.n_layers // cfg.attn_period
        per = cfg.attn_period - 1
        d_in, H, Pd, N = mamba2.dims(cfg)
        cw = cfg.ssm.conv_width
        W = min(cfg.attn_window or max_len, max_len)
        return {
            "mamba_state": z((n_super, per, B, H, Pd, N), torch.float32),
            "conv_tails": (z((n_super, per, B, cw - 1, d_in)),
                           z((n_super, per, B, cw - 1, N)),
                           z((n_super, per, B, cw - 1, N))),
            "win_k": z((n_super, B, W, cfg.n_kv_heads, cfg.head_dim)),
            "win_v": z((n_super, B, W, cfg.n_kv_heads, cfg.head_dim)),
            "win_pos": torch.full((n_super, B, W), -1, dtype=i32,
                                  device=device),
            "pos": pos,
        }
    L, H, K = cfg.n_layers, cfg.n_heads, cfg.rwkv.head_size    # ssm
    d = cfg.d_model
    return {
        "tmix_shift": z((L, B, 1, d)),
        "wkv_state": z((L, B, H, K, K), torch.float32),
        "cmix_shift": z((L, B, 1, d)),
        "pos": pos,
    }


_CACHE_BATCH_AXIS = {
    "k": 1, "v": 1, "cross_k": 1, "cross_v": 1, "kv_pos": 0, "pos": 0,
    "mamba_state": 2, "conv_tails": 2, "win_k": 1, "win_v": 1, "win_pos": 1,
    "tmix_shift": 1, "wkv_state": 1, "cmix_shift": 1,
}
# what a window slot that the prefill left empty holds
_WINDOW_FILL = {"win_k": 0, "win_v": 0, "win_pos": -1}




def cache_insert(cache: dict, single: dict, slot: int, *, pad: int = 0,
                 ctx: Optional[ShardCtx] = None, specs=None) -> dict:
    """Insert a batch-1 cache (from prefill) into slot ``slot`` of a
    batched cache — the continuous-batching primitive of serving.  Writes
    the slot of ``cache`` in place (each leaf keeps its type) and returns
    ``cache``; the first ``pad`` positions of the row are marked invalid
    in ``kv_pos`` (a left-padded prompt).

    Under ``ctx`` both trees are this rank's shards and ``specs`` their
    layouts (the serving cache's and the one-row prefill's
    ``cache_layout`` specs): only the data shard that holds row ``slot``
    writes it; a dim that the two layouts split alike is copied slice to
    slice, any other is gathered over its group for the one row (a hybrid
    window shorter than the cache's, a state dim that a one-row prefill
    splits over the data axes)."""
    big, small = specs if specs is not None else (_whole_specs(cache),) * 2
    for name, i, dst, bspec in _leaf_items(cache, big):
        ax = _CACHE_BATCH_AXIS[name]
        src = single[name] if i is None else single[name][i]
        sspec = small[name] if i is None else small[name][i]
        for d, (be, se) in enumerate(zip(bspec, sspec)):
            if d == ax or (be == se and src.shape[d] == dst.shape[d]):
                continue
            src = _whole_dims(src, _only(se, d, src.dim()), ctx)
            full = dst.shape[d] * _entry_chunk(ctx, be)[1]
            if name in _WINDOW_FILL and src.shape[d] < full:
                # a prompt shorter than the window (and than max_len): its
                # prefill window holds positions 0..S-1 at indices 0..S-1
                # — the decode ring slots p % W for the serving cache's
                # longer window W, the rest empty; then this rank's slots
                # of it.  The reference's cache_insert cannot broadcast
                # the short window into the long one and fails here.
                fill = torch.full(src.shape[:d] + (full - src.shape[d],)
                                  + src.shape[d + 1:], _WINDOW_FILL[name],
                                  dtype=src.dtype, device=src.device)
                src = torch.cat([src, fill], dim=d)
            src = _local_dims(src, _only(be, d, src.dim()), ctx)
        # every rank took part in the gathers; the row's owners write
        r, _ = _entry_chunk(ctx, bspec[ax])
        Bl = dst.shape[ax]
        if slot // Bl != r:
            continue
        row = slot - r * Bl
        dst.select(ax, row).copy_(src.select(ax, 0).to(dst.dtype))
        if name == "kv_pos" and pad:
            lo = _positions(bspec, ctx, 1, dst.shape[1])
            dst[row, :max(0, min(pad - lo, dst.shape[1]))] = -1
    return cache


def make_decode_fn(cfg: ModelConfig, flags: RunFlags, ctx: Any = None,
                   max_len: Optional[int] = None):
    """Returns fn(params, cache, tokens (B,)) -> (logits (B,Vp), cache).
    The token's k/v (dense, moe, vlm) or window entries (hybrid) are
    written into the given cache in place; the per-layer states are new
    tensors, as in the reference (they take the compute type).  The vlm's
    cross k / v are read, never written.

    Under ``ctx`` the cache is this rank's shard of the serving cache of
    ``B`` rows and ``max_len`` positions in ``cache_specs``' layout (each
    leaf's local tensor; ``pos`` is whole; ``max_len`` may be left out
    where the context has no model axis, or for the ssm family),
    ``tokens`` the global batch's, and the logits are this rank's rows'.
    It computes with the split weights and never gathers the cache:
    context-parallel decode attention (``_CacheView``) over this rank's
    positions, every query head (the local heads' q gathered over the
    model group: a few KB a token, where a whole ``wq`` would hold every
    head's weights on every rank), its partial softmax combined over the
    model group (``combine_partials``); the token's k / v of all KV heads
    written by the rank that holds its position; the vlm's cross
    attention the same way over its patches.  The SSM layers run on this
    rank's heads and keep the WKV / SSD states and the ``conv_x`` tail at
    them; the token shifts and the ``conv_B`` / ``conv_C`` tails (split on
    ``d`` / ``N``, a few KB a row) are gathered for the step, as is a
    state dim that the data axes split where they do not divide the
    batch, and the new ones cut back to this rank's shard.  Without a
    context the same code runs on the whole cache: one slice, no
    gathers."""
    _check(cfg, ctx)
    if ctx is not None and max_len is None and ctx.msize > 1 and \
            cfg.family != "ssm":
        raise ValueError("make_decode_fn needs max_len under a context "
                         "with a model axis")

    @torch.no_grad()
    def decode(params, cache, tokens):
        cdt = getattr(torch, flags.compute_dtype)
        params = _compute_params(cfg, flags, cast_params(params, cdt), ctx)
        bl = params["blocks"]
        view = _CacheView(cfg, ctx, tokens.shape[0], max_len, cache,
                          _state_heads(cfg, bl))
        lctx = view.lctx
        pos_all = cache["pos"]                                # (B,)
        pos = view.rows(pos_all)
        tokens = view.rows(tokens)
        B = tokens.shape[0]
        qpos = pos[:, None]
        x = embed_lookup(cfg, params, tokens[:, None], ctx).to(cdt)
        barange = torch.arange(B, device=tokens.device)
        pos_l = pos.long()

        if cfg.family in ("dense", "audio", "moe"):
            kc, vc = cache["k"], cache["v"]                   # (L,B,S,KH,hd)
            kv_pos = cache["kv_pos"]
            at = pos_l - view.lo("k", kc.shape[2])
            _set_rows(kv_pos, barange, at, pos)
            for li, wl in enumerate(_unstack(bl, cfg.n_layers)):
                x = _decode_attn(cfg, wl["attn"], wl["ln1"], x, qpos, kc[li],
                                 vc[li], kv_pos, at, barange, view, "k")
                if "moe" in wl:
                    x, _ = moe_block(cfg, flags, lctx, wl["moe"], wl["ln2"],
                                     x)
                else:
                    x = mlp_block(cfg, wl["mlp"], wl["ln2"], x, lctx)
            new_cache = dict(cache, pos=pos_all + 1)

        elif cfg.family == "vlm":
            kc, vc = cache["k"], cache["v"]               # (n_self,B,S,KH,hd)
            kv_pos = cache["kv_pos"]
            at = pos_l - view.lo("k", kc.shape[2])
            _set_rows(kv_pos, barange, at, pos)
            n_cross, per = bl["ln1"].shape[:2]
            self_w = {n: bl[n] for n in ("attn", "mlp", "ln1", "ln2")}
            for ci in range(n_cross):
                for pi in range(per):
                    wl, li = _at(self_w, ci, pi), ci * per + pi
                    x = _decode_attn(cfg, wl["attn"], wl["ln1"], x, qpos,
                                     kc[li], vc[li], kv_pos, at, barange,
                                     view, "k")
                    x = mlp_block(cfg, wl["mlp"], wl["ln2"], x, lctx)
                cw = _at(bl["cross"], ci)
                h = layers.rms_norm(x, cw["ln_q"], cfg.norm_eps)
                q = (h @ cw["wq"]).reshape(B, 1, -1, cfg.head_dim)
                ck, cv = cache["cross_k"][ci], cache["cross_v"][ci]
                M = ck.shape[1]
                # non-causal cross attention: q_pos = kv_pos = 0 everywhere
                zero = lambda n: torch.zeros((B, n), dtype=torch.int32,
                                             device=x.device)
                y = _attend_heads(cfg, view, "cross_k", cw, q, ck, cv,
                                  zero(1), zero(M))
                x = x + torch.tanh(cw["gate"]).to(x.dtype) * y
                x = x + torch.tanh(cw["gate_mlp"]).to(x.dtype) * \
                    _mlp_sum(cfg, lctx, cw["mlp"], cw["ln2"], x)
            new_cache = dict(cache, pos=pos_all + 1)

        elif cfg.family == "hybrid":
            shared = bl["shared"]
            n_super, per = bl["mamba_ln"].shape[:2]
            mstate = view.whole("mamba_state", cache["mamba_state"])
            mtails = tuple(view.whole("conv_tails", t, i)
                           for i, t in enumerate(cache["conv_tails"]))
            wk, wv, wp = cache["win_k"], cache["win_v"], cache["win_pos"]
            slot = pos_l % (wk.shape[2] * view.chunks("win_k", 2))
            at = slot - view.lo("win_k", wk.shape[2])
            states, tails = [], []
            for si in range(n_super):
                for pi in range(per):
                    h = layers.rms_norm(x, bl["mamba_ln"][si, pi],
                                        cfg.norm_eps)
                    y, (st, tl) = mamba2.mamba2_decode(
                        _at(bl["mamba"], si, pi), h, cfg, mstate[si, pi],
                        tuple(t[si, pi] for t in mtails), lctx)
                    x = x + y
                    states.append(st)
                    tails.append(tl)
                # shared attention with the ring-buffer window cache
                _set_rows(wp[si], barange, at, pos)
                x = _decode_attn(cfg, shared["attn"], shared["ln1"], x, qpos,
                                 wk[si], wv[si], wp[si], at, barange, view,
                                 "win_k", cfg.attn_window)
                x = mlp_block(cfg, shared["mlp"], shared["ln2"], x, lctx)
            grid = lambda ts: torch.stack(ts).reshape((n_super, per)
                                                      + ts[0].shape)
            new_cache = dict(
                cache, pos=pos_all + 1,
                mamba_state=view.local("mamba_state", grid(states)),
                conv_tails=tuple(
                    view.local("conv_tails", grid([t[i] for t in tails]), i)
                    for i in range(3)))

        else:                                                 # ssm
            st = {n: view.whole(n, cache[n])
                  for n in ("tmix_shift", "wkv_state", "cmix_shift")}
            parts = []
            for li in range(cfg.n_layers):
                w = _at(bl["rwkv"], li)
                h = layers.rms_norm(x, bl["ln1"][li], cfg.norm_eps)
                y, tsh, wst = rwkv6.time_mix(w["tmix"], h, cfg,
                                             st["tmix_shift"][li],
                                             st["wkv_state"][li], ctx=lctx)
                x = x + y
                h = layers.rms_norm(x, bl["ln2"][li], cfg.norm_eps)
                y, csh = rwkv6.channel_mix(w["cmix"], h,
                                           st["cmix_shift"][li],
                                           _cmix_ctx(cfg, w["cmix"], lctx))
                x = x + y
                parts.append((tsh, wst, csh))
            new_cache = dict(cache, pos=pos_all + 1, **{
                name: view.local(name, torch.stack([p[i] for p in parts]))
                for i, name in enumerate(("tmix_shift", "wkv_state",
                                          "cmix_shift"))})

        logits = lm_logits(cfg, params, x, lctx)[:, 0]
        return logits, new_cache

    return decode


class _CacheView:
    """One decode step's view of the serving cache's layout: the rows of
    this rank, the first position of its slice of a leaf, and the moves
    of the SSM states between its shard and the whole (in their non-row
    dims) that the step computes with.  Without a context every leaf is
    whole: one chunk, position 0, no moves."""

    def __init__(self, cfg, ctx: Optional[ShardCtx], B: int,
                 max_len: Optional[int], cache: dict, heads: bool = False):
        self.ctx, self.heads = ctx, heads
        self.split, self.lctx = _row_ctx(ctx, B)
        if ctx is None:
            self.specs = _whole_specs(cache)
            return
        # with no model axis the cache's positions are whole: its length
        # is max_len (a hybrid's window: as long as max_len or shorter)
        ml = max_len if max_len is not None else (
            cache["kv_pos"].shape[1] if "kv_pos" in cache else
            cache["win_k"].shape[2] if "win_k" in cache else 1)
        self.specs = cache_layout(cfg, ctx, B, ml)[1]

    def rows(self, t):
        return comm.data_chunk(t, self.ctx) if self.split else t

    def _spec(self, name, i=None):
        sp = self.specs[name]
        return sp[i] if i is not None else sp

    def chunks(self, name, dim) -> int:
        return _entry_chunk(self.ctx, self._spec(name)[dim])[1]

    def lo(self, name, n_local: int) -> int:
        """The first position (slot) of this rank's slice of dim 2 of
        ``name`` (k, v, a window or the vlm's patches), ``n_local`` long."""
        return _positions(self._spec(name), self.ctx, 2, n_local)

    def _skip(self, name, i):
        return _kept(name, i, self._spec(name, i), self.ctx, self.split,
                     self.heads)

    def whole(self, name, t, i=None):
        return _whole_dims(t, self._spec(name, i), self.ctx,
                           self._skip(name, i))

    def local(self, name, t, i=None):
        return _local_dims(t, self._spec(name, i), self.ctx,
                           self._skip(name, i))


def _attend(view: _CacheView, name, q, k, v, q_pos, kv_pos, *, window=0):
    """``decode_attention`` of q (every head) over this rank's slice of
    the cache leaf ``name``'s positions, combined over the model group
    where the slices differ between its ranks."""
    if view.chunks(name, 2) == 1:
        return decode_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                window=window)
    ctx = view.ctx
    acc, m, l = decode_attention_partial(q, k, v, q_pos=q_pos,
                                         kv_pos=kv_pos, window=window)
    o = combine_partials(acc, m, l,
                         max_fn=lambda t: comm.max_model(t, ctx),
                         sum_fn=lambda a, b: comm.sum_model(a, b, sctx=ctx))
    return o.to(q.dtype)


def _set_rows(buf, barange, pos, val):
    """``buf[b, pos[b]] = val[b]`` for every row whose position lies inside
    ``buf``'s second dim; a row outside it is left as it is, as the
    reference's scatter drops out-of-bounds updates (an idle serving slot
    keeps counting past ``max_len``; under a context, a position on
    another rank's slice).  No host synchronisation: the row's nearest
    entry is rewritten with its own value."""
    inside = (pos >= 0) & (pos < buf.shape[1])
    idx = pos.clamp(0, buf.shape[1] - 1)
    mask = inside.view(-1, *([1] * (val.dim() - 1)))
    buf[barange, idx] = torch.where(mask, val, buf[barange, idx])



def _decode_attn(cfg, w, ln, x, qpos, kc, vc, kv_pos, at, barange,
                 view: _CacheView, name: str, window: int = 0):
    """One attention layer of a decode step: the token's k / v of all KV
    heads into this rank's slice of the layer's cache ``kc`` / ``vc``
    (views into the serving cache; ``at``: the token's index there,
    outside it on the other ranks), then ``_attend_heads``."""
    ctx = view.ctx
    h = layers.rms_norm(x, ln, cfg.norm_eps)
    B, hd = x.shape[0], cfg.head_dim
    wk, wv = w["wk"], w["wv"]
    k1 = (h @ wk).reshape(B, 1, wk.shape[-1] // hd, hd)
    v1 = (h @ wv).reshape(B, 1, wv.shape[-1] // hd, hd)
    k1 = layers.apply_rope(k1, qpos, cfg.rope)
    if k1.shape[2] < cfg.n_kv_heads:
        k1, v1 = comm.gather_model(k1, ctx, 2), comm.gather_model(v1, ctx, 2)
    _set_rows(kc, barange, at, k1[:, 0].to(kc.dtype))
    _set_rows(vc, barange, at, v1[:, 0].to(vc.dtype))
    q = (h @ w["wq"]).reshape(B, 1, -1, hd)
    q = layers.apply_rope(q, qpos, cfg.rope)
    return x + _attend_heads(cfg, view, name, w, q, kc, vc, qpos, kv_pos,
                             window=window)


def _attend_heads(cfg, view: _CacheView, name: str, w, q, k, v, q_pos,
                  kv_pos, window: int = 0):
    """The attention output projection of a decode step's q (B, 1, this
    rank's heads, hd) over this rank's slice of the cache leaf ``name``
    (``_attend``): where q holds this rank's heads, every query head's q
    is gathered over the model group (a few KB a token, where a whole
    ``wq`` would hold every head's weights on every rank), the output
    narrowed back to this rank's heads, and the model group sums their
    shares of ``wo``."""
    ctx = view.ctx
    Hl = q.shape[2]
    if Hl < cfg.n_heads:
        q = comm.gather_model(q, ctx, 2)
    o = _attend(view, name, q, k, v, q_pos, kv_pos, window=window)
    if Hl < cfg.n_heads:
        o = o.narrow(2, ctx.model_rank * Hl, Hl)
    return _heads_out(cfg, ctx, w, o)
