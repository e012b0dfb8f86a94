"""Explicit device resolution for the port's entry points.

Every entry point takes ``device`` (default ``"cuda"``) and runs there.
A CUDA device that is not present is an error, never a reason to carry on
on the CPU: callers that want the CPU say ``device="cpu"``.
"""
from __future__ import annotations

import contextlib
import threading
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


def same_device(name: str, *ts: torch.Tensor) -> torch.device:
    """The one device of an op's operands; raises for operands on
    different devices."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"{name}: operands on different devices")
    return dev


def on_cpu(name: str, *ts: torch.Tensor) -> bool:
    """The route of a kernel wrapper: True for CPU tensors (its plain
    version), False for CUDA tensors (its kernel); raises for any other
    device or for operands on different devices."""
    dev = same_device(name, *ts)
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {dev}")
    return False


# ``true_fp32`` is entered from several threads at once (the cells of a
# sweep run on a thread pool): the flag is process-wide, so the first
# entrant saves it, every entrant clears it, and the last one out restores
# it, under one lock
_fp32_lock = threading.Lock()
_fp32_depth = 0
_fp32_saved = False


@contextlib.contextmanager
def true_fp32() -> Iterator[None]:
    """Float32 matmuls on the card without TF32 inside the body; the
    caller's ``torch.backends.cuda.matmul.allow_tf32`` is restored when the
    last context still open in any thread exits, so a plain version or
    oracle never changes the process-wide switch, and one thread's exit
    never turns TF32 back on under another thread's body.  Usable as a
    decorator."""
    global _fp32_depth, _fp32_saved
    with _fp32_lock:
        if _fp32_depth == 0:
            _fp32_saved = torch.backends.cuda.matmul.allow_tf32
        _fp32_depth += 1
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        with _fp32_lock:
            _fp32_depth -= 1
            if _fp32_depth == 0:
                torch.backends.cuda.matmul.allow_tf32 = _fp32_saved
