"""State carried across from the reference package into the port.

Every function takes only numpy arrays and plain Python objects: it is
handed what the reference produced, never the reference package itself.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_map
from repro_torch.core.transactions import Transaction

_TX_FIELDS = ("time", "engine", "kind", "addr", "nbytes", "tag", "stall",
              "complete", "dos", "fault_delay")


def bridge_state_from_reference(state: Dict[str, Any]) -> Dict[str, Any]:
    """Turn the dict the reference's ``FireBridge.get_state()`` returns
    (DDR arrays, allocation cursor, clock, log, link arbiter + RNG,
    counters, CSRs) into what the port's ``FireBridge.set_state`` accepts.

    Transaction records become the port's own ``Transaction`` objects; a
    record that the log and the link timeline share stays one shared
    object, as after a run of the port itself.  A snapshot taken under a
    fault plan is refused: the port has no fault plan yet.
    """
    mem = state["mem"]
    if mem.get("fault_plan") is not None:
        raise ValueError("snapshot carries fault-plan state; the port's "
                         "bridge has no fault plan to restore it into")
    memo: Dict[int, Transaction] = {}

    def tx(t: Any) -> Transaction:
        new = memo.get(id(t))
        if new is None:
            new = Transaction(*(getattr(t, f) for f in _TX_FIELDS))
            memo[id(t)] = new
        return new

    log = mem["log"]
    link = mem["link"]
    if link is not None:
        link = dict(copy.deepcopy({k: v for k, v in link.items()
                                   if k != "timeline"}),
                    timeline=[tx(t) for t in link["timeline"]])
    return {
        "mem": {
            "buffers": {n: (int(addr), np.array(arr, copy=True))
                        for n, (addr, arr) in mem["buffers"].items()},
            "next": mem["next"],
            "time": mem["time"],
            "log": {"txs": [tx(t) for t in log["txs"]],
                    "violations": list(log["violations"]),
                    "faults": list(log["faults"])},
            "link": link,
            "fault_plan": None,
            "counters": copy.deepcopy(mem.get("counters")),
        },
        "csr": {"vals": dict(state["csr"]["vals"]),
                "time": state["csr"]["time"]},
    }


def _tensor(arr: Any, dev: torch.device) -> torch.Tensor:
    """A copy of one numpy array as a tensor on ``dev``; bfloat16 arrays
    (numpy's ``ml_dtypes`` extension type, which ``torch.from_numpy``
    does not take) go over bit for bit as 16-bit words."""
    arr = np.array(arr)                                      # copies
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(arr).to(dev)


def params_from_reference(tree: Any,
                          device: Union[str, torch.device] = "cuda") -> Any:
    """A nested dict / list / tuple of numpy arrays as the same nesting of
    tensors on ``device`` (``ssm`` and ``hybrid`` trees included: the
    hybrid's stacked mamba leaves keep their ``(n_super, per)`` axes).
    Leaf paths are those of the port's equivalence flattener
    (``core/equivalence.py``), so a converted tree compares leaf for leaf
    against the arrays it came from."""
    dev = resolve_device(device)

    def walk(node: Any) -> Any:
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return _tensor(node, dev)

    return walk(tree)


def cache_from_reference(cache: Dict[str, Any],
                         device: Union[str, torch.device] = "cuda"
                         ) -> Dict[str, Any]:
    """The reference's prefill / decode cache (``make_prefill_fn``,
    ``init_cache``) as numpy arrays -> the port's cache on ``device``:
    the same keys, shapes and dtypes (``conv_tails`` stays a tuple), so
    the port's ``make_decode_fn`` continues from the reference's prefill."""
    return params_from_reference(cache, device)


def train_state_from_reference(state: Dict[str, Any],
                               device: Union[str, torch.device] = "cuda"
                               ) -> Dict[str, Any]:
    """The reference's ``make_train_state`` tree (``params``, ``m``, ``v``,
    ``step``) as numpy arrays -> the port's train state, leaf for leaf on
    ``device``: parameters as leaf tensors that require a gradient, moments
    as they are, ``step`` as an int32 scalar tensor."""
    out = params_from_reference(
        {k: state[k] for k in ("params", "m", "v")}, device)
    out["params"] = tree_map(lambda p: p.requires_grad_(), out["params"])
    out["step"] = torch.tensor(int(np.asarray(state["step"])),
                               dtype=torch.int32, device=resolve_device(device))
    return out
