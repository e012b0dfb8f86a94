"""Explicit device resolution for the port's entry points.

Every entry point takes ``device`` (default ``"cuda"``) and runs there.
A CUDA device that is not present is an error, never a reason to carry on
on the CPU: callers that want the CPU say ``device="cpu"``.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Union

import numpy as np
import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if it names a CUDA device
    and this process has none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run on the CPU")
    return dev


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host numpy array as a tensor on ``device`` (the host-to-device
    copy a backend owns; on the CPU the tensor shares the array's memory)."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def on_cpu(name: str, *ts: torch.Tensor) -> bool:
    """The route of a kernel wrapper: True for CPU tensors (its plain
    version), False for CUDA tensors (its kernel); raises for any other
    device or for operands on different devices."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"{name}: operands on different devices")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {dev}")
    return False


@contextlib.contextmanager
def true_fp32() -> Iterator[None]:
    """Float32 matmuls on the card without TF32 inside the body; the
    caller's ``torch.backends.cuda.matmul.allow_tf32`` is restored on exit,
    so a plain version or oracle never changes the process-wide switch.
    Usable as a decorator."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
