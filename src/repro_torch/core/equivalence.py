"""Three-way functional-equivalence checking with first-divergence
localization (the paper's "ensuring functional equivalence", §I/§IV-B).

oracle (ref.py torch) ≡ interpret (hand-written CUDA kernel) ≡ compiled
(deployment tier).
On mismatch the report pinpoints the leaf path, flat index, and values —
the co-verification analogue of dropping a waveform cursor on the first
diverging signal.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class Divergence:
    pair: Tuple[str, str]
    leaf_path: str
    index: Tuple[int, ...]
    lhs: float
    rhs: float
    max_abs_err: float
    rel_err: float


@dataclasses.dataclass
class EquivalenceReport:
    passed: bool
    tol: float
    backends: List[str]
    divergences: List[Divergence]

    def __str__(self) -> str:
        if self.passed:
            return f"EQUIVALENT across {self.backends} (tol={self.tol:g})"
        lines = [f"DIVERGENT (tol={self.tol:g}):"]
        for d in self.divergences:
            lines.append(
                f"  {d.pair[0]} vs {d.pair[1]} @ {d.leaf_path}{list(d.index)}"
                f": {d.lhs:.6g} vs {d.rhs:.6g} "
                f"(abs={d.max_abs_err:.3g}, rel={d.rel_err:.3g})")
        return "\n".join(lines)


def _flatten_with_path(tree: Any, path: Tuple[str, ...] = ()
                       ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """Depth-first (path, leaf) pairs over dict / list / tuple containers.
    Dict children are visited in sorted-key order and sequence children by
    index, so the ``a/b/0`` leaf-path strings and their order are stable
    whatever order a dict was built in.  ``None`` is an empty subtree;
    anything else (numpy array, tensor, scalar) is a leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_path(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_with_path(v, path + (str(i),))
    else:
        yield path, tree


def _as_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.numpy()
    return np.asarray(leaf)


def _leaf_paths(tree: Any) -> List[Tuple[str, np.ndarray]]:
    return [("/".join(path) or "<root>",
             _as_numpy(leaf).astype(np.float64))
            for path, leaf in _flatten_with_path(tree)]


def compare(a: Any, b: Any, names: Tuple[str, str], tol: float
            ) -> Optional[Divergence]:
    for (pa, la), (_, lb) in zip(_leaf_paths(a), _leaf_paths(b)):
        if la.shape != lb.shape:
            return Divergence(names, pa, (), float("nan"), float("nan"),
                              float("inf"), float("inf"))
        diff = np.abs(la - lb)
        if diff.size == 0:
            continue
        scale = max(np.max(np.abs(la)), 1e-9)
        if np.max(diff) > tol * max(1.0, scale):
            idx = np.unravel_index(int(np.argmax(diff)), diff.shape)
            return Divergence(names, pa, tuple(int(i) for i in idx),
                              float(la[idx]), float(lb[idx]),
                              float(np.max(diff)),
                              float(np.max(diff) / scale))
    return None


def compare_outputs(outs: Dict[str, Any],
                    tol: float = 1e-4) -> EquivalenceReport:
    """Compare already-computed per-backend outputs, all vs the first.

    This is the comparison consumed by the CoVerifySession sweep scheduler
    (core/scheduler.py): each sweep group hands in the final DDR state per
    backend and gets back one localized report per group.
    """
    names = list(outs)
    divs: List[Divergence] = []
    base = names[0]
    for other in names[1:]:
        d = compare(outs[base], outs[other], (base, other), tol)
        if d is not None:
            divs.append(d)
    return EquivalenceReport(passed=not divs, tol=tol, backends=names,
                             divergences=divs)


def check_equivalence(fns: Dict[str, Callable], args: tuple,
                      tol: float = 1e-4) -> EquivalenceReport:
    """Run every backend on identical inputs and compare all vs the first."""
    return compare_outputs({n: fn(*args) for n, fn in fns.items()}, tol)
