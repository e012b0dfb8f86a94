"""Builds the hand-written CUDA kernels under ``csrc/`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers, so
``nvcc`` takes seconds) and becomes its own shared library
``build/lib<name>-<hash>.so`` at the repository root, loaded with
``ctypes``.  The file name carries a hash of the source, of every header
under ``csrc/`` that it includes (directly or through another header) and
of the flags, so an edit rebuilds and a stale library is never loaded.
Nothing is compiled when a module is imported: ``load`` is called by a kernel's
wrapper right before its first launch.  ``build_all`` starts one ``nvcc``
per source, all at once, for callers that want every kernel up front.

A build that fails raises with the compiler's output; nothing here falls
back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
# src/repro_torch/kernels/_build.py -> repository root
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

# ``-Xptxas -v``: each kernel's registers, shared memory and spills go to
# the build log (``logs``)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
# held around every build-or-load: threads that reach a kernel for the
# first time at once (the cells of a sweep) build it once, and none loads
# a library another thread is still writing
_lock = threading.Lock()
# compiler output of each library built by this process
logs: Dict[str, str] = {}
_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def sources() -> List[str]:
    """Names of the kernels that have a source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            exe = str(cand)
    if exe is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the CUDA kernels cannot "
                           "be built on this machine")
    return exe


def _headers(src: Path) -> List[Path]:
    """The ``csrc/`` headers that ``src`` includes, directly or through
    another header, in a fixed order."""
    seen = set()
    todo = [src]
    while todo:
        for inc in _INCLUDE.findall(todo.pop().read_bytes()):
            hdr = CSRC / inc.decode()
            if hdr.exists() and hdr not in seen:
                seen.add(hdr)
                todo.append(hdr)
    return sorted(seen)


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(f"no kernel source {src}")
    h = hashlib.sha256(src.read_bytes())
    for hdr in _headers(src):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> Tuple[Path, Optional[subprocess.Popen], Path]:
    """Start the compile of one source unless its library already exists."""
    src, out = _target(name)
    if out.exists():
        return out, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return out, proc, tmp


def _finish(name: str, out: Path, proc: Optional[subprocess.Popen],
            tmp: Path) -> ctypes.CDLL:
    if proc is not None:
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)            # atomic: no half-written library
    lib = ctypes.CDLL(str(out))
    _libs[name] = lib
    return lib


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built if need be."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _finish(name, *_start(name))
    return lib


def build_all() -> Dict[str, ctypes.CDLL]:
    """Build every kernel, one ``nvcc`` per source, all started together."""
    with _lock:
        started = [(n, _start(n)) for n in sources() if n not in _libs]
        failure = None
        for n, job in started:
            try:
                _finish(n, *job)
            except RuntimeError as e:   # reap every compiler before raising
                failure = failure or e
        if failure is not None:
            raise failure
        return {n: _libs[n] for n in sources()}
