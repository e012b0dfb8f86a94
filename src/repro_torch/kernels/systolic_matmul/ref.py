"""Oracle for the systolic matmul kernel."""
from __future__ import annotations

import torch

from repro_torch._device import true_fp32


@true_fp32()
def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """fp32 product of the upcast inputs, cast to ``out_dtype or a.dtype``.
    A true fp32 product: TF32 is switched off for the card's matmuls."""
    out = torch.matmul(a.float(), b.float())
    return out.to(out_dtype or a.dtype)
