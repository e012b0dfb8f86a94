"""Config system of the PyTorch port: a copy of the reference's
``repro.configs.base`` (pure data, no framework import), kept here so the
port never imports the reference package.

Every assigned architecture is a frozen ``ModelConfig``; every assigned input
shape is a ``ShapeConfig``.  ``smoke(cfg)`` derives the reduced config used by
CPU tests; ``count_params`` is the analytic parameter count.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    expert_d_ff: int
    # capacity_factor bounds the sort-based dispatch buffers (dropless-ish).
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) settings."""

    d_state: int = 64
    head_dim: int = 64          # SSD head dim (P)
    expand: int = 2             # d_inner = expand * d_model
    chunk: int = 128            # SSD chunk length
    conv_width: int = 4


@dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    # RWKV-6 channel-mix hidden = d_ff from the arch spec.


@dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                 # dense | audio | hybrid | ssm | vlm | moe
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    mlp_type: str = "swiglu"    # swiglu | gelu
    rope: str = "full"          # full | half | none
    causal: bool = True
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # --- family extensions -------------------------------------------------
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # hybrid (zamba2): one *shared* attention block applied every
    # ``attn_period`` layers (weights shared across occurrences).
    attn_period: int = 0
    # sliding window for the hybrid shared-attention KV cache (sub-quadratic
    # long-context path); 0 = full attention.
    attn_window: int = 0
    # vlm: a cross-attention layer every ``cross_attn_period`` layers.
    cross_attn_period: int = 0
    n_media_tokens: int = 0     # patch-embedding count from the stub frontend
    # frontend stub kind: token ids ("tokens"), precomputed frame embeddings
    # ("frames"), tokens + precomputed patch embeddings ("tokens+patches").
    frontend: str = "tokens"

    # ------------------------------------------------------------------ util
    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run 500k-token decode? (SSM / hybrid-with-window.)"""
        if self.family == "ssm":
            return True
        if self.family == "hybrid" and self.attn_window > 0:
            return True
        return False

    @property
    def d_q(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def d_kv(self) -> int:
        return self.n_kv_heads * self.head_dim


# ---------------------------------------------------------------------------
# Shape config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> dict[str, str]:
    """Map shape-name -> "OK" or "SKIP(<reason>)" for this arch."""
    out: dict[str, str] = {}
    for name, sh in SHAPES.items():
        if sh.kind == "decode" and cfg.is_encoder_only:
            out[name] = "SKIP(encoder-only: no autoregressive decode step)"
        elif name == "long_500k" and not cfg.sub_quadratic:
            out[name] = "SKIP(pure full-attention arch: no sub-quadratic path)"
        else:
            out[name] = "OK"
    return out


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCHS: Tuple[str, ...] = (
    "mistral-nemo-12b",
    "granite-20b",
    "chatglm3-6b",
    "llama3.2-1b",
    "hubert-xlarge",
    "zamba2-2.7b",
    "rwkv6-7b",
    "llama-3.2-vision-11b",
    "moonshot-v1-16b-a3b",
    "phi3.5-moe-42b-a6.6b",
)

_MODULE_FOR_ARCH = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULE_FOR_ARCH:
        raise KeyError(f"unknown arch {arch!r}; known: {list(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR_ARCH[arch]}")
    return mod.CONFIG


def list_archs() -> Tuple[str, ...]:
    return ARCHS


# ---------------------------------------------------------------------------
# Smoke reduction
# ---------------------------------------------------------------------------


def smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (small layers/width/
    experts/tables), preserving every structural feature of the full arch."""
    kw: dict = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(4, max(1, cfg.n_kv_heads * 4 // cfg.n_heads)),
        head_dim=16,
        d_ff=128,
        vocab_size=512,
    )
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(n_experts=4, top_k=min(2, cfg.moe.top_k),
                              expert_d_ff=32,
                              capacity_factor=cfg.moe.capacity_factor)
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=8, head_dim=8, expand=2, chunk=16,
                              conv_width=cfg.ssm.conv_width)
    if cfg.rwkv is not None:
        kw["rwkv"] = RWKVConfig(head_size=16)
    if cfg.attn_period:
        kw["n_layers"] = 4
        kw["attn_period"] = 2
        if cfg.attn_window:
            kw["attn_window"] = 32
    if cfg.cross_attn_period:
        kw["n_layers"] = 4
        kw["cross_attn_period"] = 2
        kw["n_media_tokens"] = 16
    return replace(cfg, **kw)


# ---------------------------------------------------------------------------
# Parameter counting (for MODEL_FLOPS = 6*N*D; MoE uses N_active)
# ---------------------------------------------------------------------------


def _attn_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    return d * cfg.d_q + 2 * d * cfg.d_kv + cfg.d_q * d


def _mlp_params(d_model: int, d_ff: int, mlp_type: str) -> int:
    if mlp_type == "swiglu":
        return 3 * d_model * d_ff
    return 2 * d_model * d_ff


def _mamba2_params(cfg: ModelConfig) -> int:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    in_proj = cfg.d_model * (2 * d_in + 2 * s.d_state + nh)   # z,x,B,C,dt
    conv = s.conv_width * (d_in + 2 * s.d_state)
    out_proj = d_in * cfg.d_model
    return in_proj + conv + out_proj + nh + d_in              # + A_log, D... approx

def _rwkv6_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    tm = 4 * d * d + d * cfg.rwkv.head_size  # r,k,v,o (+g via lora, counted in misc)
    tm += 2 * (d * 64 + 64 * d)              # decay/ddlerp loras (approx)
    cm = cfg.d_model * cfg.d_ff + cfg.d_ff * cfg.d_model
    return tm + cm


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Analytic parameter count (embeddings included once; 6·N·D convention
    counts non-embedding params — we report both)."""
    d = cfg.d_model
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    per_layer = 0
    if cfg.family == "ssm":
        per_layer = _rwkv6_params(cfg)
        layers = per_layer * cfg.n_layers
    elif cfg.family == "hybrid":
        layers = _mamba2_params(cfg) * cfg.n_layers
        # one shared attn+mlp block
        layers += _attn_params(cfg) + _mlp_params(d, cfg.d_ff, cfg.mlp_type)
    else:
        per_layer = _attn_params(cfg)
        if cfg.moe is not None:
            n_used = cfg.moe.top_k if active_only else cfg.moe.n_experts
            per_layer += n_used * _mlp_params(d, cfg.moe.expert_d_ff, cfg.mlp_type)
            per_layer += d * cfg.moe.n_experts  # router
        else:
            per_layer += _mlp_params(d, cfg.d_ff, cfg.mlp_type)
        layers = per_layer * cfg.n_layers
        if cfg.cross_attn_period:
            n_cross = cfg.n_layers // cfg.cross_attn_period
            layers += n_cross * _attn_params(cfg)
    return layers + emb


def non_embedding_params(cfg: ModelConfig, active_only: bool = False) -> int:
    d = cfg.d_model
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    return count_params(cfg, active_only=active_only) - emb
