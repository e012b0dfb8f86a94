"""Concrete example batches — the port of ``repro.models.inputs``.

Drawn from an explicit ``torch.Generator`` on its device.  The reference's
abstract input specs serve its dry-run and wait for the port's dry-run.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


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
