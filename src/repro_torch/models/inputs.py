"""Concrete example batches and abstract input specs — the port of
``repro.models.inputs``.

Batches are drawn from an explicit ``torch.Generator`` on its device.  The
specs are tensors on the ``meta`` device: shape and dtype, no storage (the
reference's ``jax.ShapeDtypeStruct``).  The modality frontends are stubs,
as in the reference: audio takes precomputed frame embeddings, vision
precomputed patch embeddings.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


def make_train_batch(cfg: ModelConfig, B: int, S: int,
                     gen: torch.Generator) -> dict:
    dev = gen.device
    batch = {}
    V = cfg.vocab_size
    if cfg.frontend == "frames":
        batch["frames"] = torch.randn((B, S, cfg.d_model), generator=gen,
                                      device=dev) * 0.02
    else:
        batch["tokens"] = torch.randint(0, V, (B, S), generator=gen,
                                        device=dev, dtype=torch.int32)
    if cfg.frontend == "tokens+patches":
        batch["patches"] = torch.randn((B, cfg.n_media_tokens, cfg.d_model),
                                       generator=gen, device=dev) * 0.02
    batch["labels"] = torch.randint(0, V, (B, S), generator=gen, device=dev,
                                    dtype=torch.int32)
    return batch


def make_prefill_batch(cfg: ModelConfig, B: int, S: int,
                       gen: torch.Generator) -> dict:
    b = make_train_batch(cfg, B, S, gen)
    b.pop("labels")
    return b


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    batch = {}
    if cfg.frontend == "frames":
        batch["frames"] = _spec((B, S, cfg.d_model), torch.float32)
    else:
        batch["tokens"] = _spec((B, S), torch.int32)
    if cfg.frontend == "tokens+patches":
        batch["patches"] = _spec((B, cfg.n_media_tokens, cfg.d_model),
                                 torch.float32)
    batch["labels"] = _spec((B, S), torch.int32)
    return batch


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b = train_input_specs(cfg, shape)
    b.pop("labels")
    return b


def decode_token_specs(cfg: ModelConfig, shape: ShapeConfig) -> torch.Tensor:
    return _spec((shape.global_batch,), torch.int32)
