"""Async, atomic checkpointing — the port of ``repro.checkpoint.manager``.

Same on-disk layout and leaf paths as the reference (one directory per
step, atomic rename commit), so the two packages read each other's
checkpoints:

    ckpt_dir/step_00000123.tmp/ -> ckpt_dir/step_00000123/
        meta.json              # step, leaf paths/shapes/dtypes, extras
        shard_00000/leaves.npz # per-"host" shard files

``save`` copies every leaf to host memory synchronously (a consistent
point in time) and writes the files on a worker thread.  ``restore`` puts
each leaf on the target device with the dtype of the matching leaf of
``like`` (a tree of tensors, e.g. on the ``meta`` device), and with
``shardings`` places it in its TARGET layout (elastic reshard: train on
mesh A, restore on mesh B).  Sharded state: every rank calls ``save``
(a DTensor leaf is gathered whole, a collective) and rank 0 writes the
files; every rank reads them back in ``restore``.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._tree import paths, unflatten
from repro_torch.sharding.specs import place, whole


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return whole(leaf.detach()).cpu().numpy()
    return np.asarray(leaf)


def _writer() -> bool:
    """Whether this process writes checkpoint files (rank 0 of a
    distributed job, or a lone process)."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


class CheckpointManager:
    """Use as a context manager (``with CheckpointManager(...) as mgr:``)
    so the in-flight async write is always joined — and its error
    surfaced — before the process moves on; a bare instance must call
    ``wait()``/``close()`` itself.

    Failure contract: a checkpoint either commits completely (the atomic
    ``.tmp`` -> final rename) or leaves nothing visible — a write that
    dies mid-``npz`` removes its ``.tmp`` staging directory, and the
    exception is re-raised to the caller on the next ``save()``/``wait()``
    instead of dying silently on the worker thread."""

    def __init__(self, directory, keep: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.wait()                 # flush + surface any write error
        else:                           # already unwinding: join the
            self._join()                # writer but don't mask the error

    def close(self) -> None:
        self.wait()

    # ------------------------------------------------------------- save
    def save(self, step: int, state: Any, extras: Optional[dict] = None):
        host = [(p, _host(v)) for p, v in paths(state)]
        self.wait()
        if not _writer():
            return
        if self.async_save:
            self._pending = threading.Thread(
                target=self._write_guarded, args=(step, host, extras or {}))
            self._pending.start()
        else:
            self._write(step, host, extras or {})

    def _write_guarded(self, step: int, host, extras: dict):
        try:
            self._write(step, host, extras)
        except BaseException as e:      # surfaced on the next wait()/save()
            self._error = e

    def _write(self, step: int, host, extras: dict):
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        try:
            shard = tmp / "shard_00000"
            shard.mkdir(parents=True)
            np.savez(shard / "leaves.npz", **{p: v for p, v in host})
            meta = {
                "step": step,
                "leaves": {p: {"shape": list(v.shape),
                               "dtype": str(v.dtype)}
                           for p, v in host},
                "extras": extras,
            }
            (tmp / "meta.json").write_text(json.dumps(meta))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)   # nothing partial
            raise
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                                   # atomic commit
        self._gc()

    def _join(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def wait(self):
        self._join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(self.list_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ---------------------------------------------------------- restore
    def list_steps(self):
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                      if p.is_dir() and not p.name.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any,
                device: Union[str, torch.device] = "cuda",
                shardings: Any = None) -> Any:
        """Restore into the structure of ``like``: every leaf as a tensor
        of the matching leaf's dtype on ``device``; with ``shardings`` (a
        tree of ``sharding/specs.py`` ``Sharding``s) each leaf is placed in
        its TARGET layout, a DTensor on that sharding's mesh."""
        dev = resolve_device(device)
        path = self.dir / f"step_{step:08d}"
        with np.load(path / "shard_00000" / "leaves.npz") as data:
            out = [torch.from_numpy(data[p]).to(device=dev, dtype=proto.dtype)
                   for p, proto in paths(like)]
        tree = unflatten(like, out)
        return tree if shardings is None else place(tree, shardings)

    def extras(self, step: int) -> dict:
        meta = json.loads((self.dir / f"step_{step:08d}" / "meta.json")
                          .read_text())
        return meta.get("extras", {})


def load_checkpoint(directory, like: Any,
                    device: Union[str, torch.device] = "cuda",
                    step: Optional[int] = None, shardings: Any = None):
    mgr = CheckpointManager(directory)
    s = step if step is not None else mgr.latest_step()
    if s is None:
        return None, None
    return mgr.restore(s, like, device, shardings), s
