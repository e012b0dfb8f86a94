"""State carried across from the reference package into the port.

Every function takes only numpy arrays and plain Python objects: it is
handed what the reference produced, never the reference package itself.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_map
from repro_torch.core.fuzz import FaultEvent
from repro_torch.core.transactions import Transaction

_TX_FIELDS = ("time", "engine", "kind", "addr", "nbytes", "tag", "stall",
              "complete", "dos", "fault_delay")


class _Carrier:
    """Converts one reference snapshot's records into the port's types.
    One carrier per snapshot: a transaction that several logs and link
    timelines share stays one shared object, as after a run of the port
    itself."""

    def __init__(self) -> None:
        self._memo: Dict[int, Transaction] = {}

    def tx(self, t: Any) -> Transaction:
        new = self._memo.get(id(t))
        if new is None:
            new = Transaction(*(getattr(t, f) for f in _TX_FIELDS))
            self._memo[id(t)] = new
        return new

    def link(self, link: Optional[Dict[str, Any]]
             ) -> Optional[Dict[str, Any]]:
        if link is None:
            return None
        return dict(copy.deepcopy({k: v for k, v in link.items()
                                   if k != "timeline"}),
                    timeline=[self.tx(t) for t in link["timeline"]])

    @staticmethod
    def plan(plan: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
        """A ``FaultPlan.get_state()``: the numpy bit-generator state as it
        is (a plain dict), each event as the port's ``FaultEvent``."""
        if plan is None:
            return None
        return {"rng": copy.deepcopy(plan["rng"]),
                "events": [FaultEvent(*ev.key()) for ev in plan["events"]]}

    def mem(self, mem: Dict[str, Any]) -> Dict[str, Any]:
        log = mem["log"]
        return {
            "buffers": {n: (int(addr), np.array(arr, copy=True))
                        for n, (addr, arr) in mem["buffers"].items()},
            "next": mem["next"],
            "time": mem["time"],
            "log": {"txs": [self.tx(t) for t in log["txs"]],
                    "violations": list(log["violations"]),
                    "faults": list(log["faults"])},
            "link": self.link(mem["link"]),
            "fault_plan": self.plan(mem.get("fault_plan")),
            "counters": copy.deepcopy(mem.get("counters")),
        }

    def bridge(self, state: Dict[str, Any]) -> Dict[str, Any]:
        return {"mem": self.mem(state["mem"]),
                "csr": {"vals": dict(state["csr"]["vals"]),
                        "time": state["csr"]["time"]}}


def bridge_state_from_reference(state: Dict[str, Any]) -> Dict[str, Any]:
    """Turn the dict the reference's ``FireBridge.get_state()`` returns
    (DDR arrays, allocation cursor, clock, log, link arbiter + RNG,
    fault plan, counters, CSRs) into what the port's
    ``FireBridge.set_state`` accepts.

    Transaction records become the port's own ``Transaction`` objects and
    fault events its ``FaultEvent``s; the fault plan's numpy bit-generator
    state carries over as it is, so the port's plan draws the reference's
    remaining fault stream.  The port's bridge must have been built with
    a fault plan when the snapshot carries one (as for the reference's own
    ``set_state``).
    """
    return _Carrier().bridge(state)


def fabric_state_from_reference(state: Dict[str, Any]) -> Dict[str, Any]:
    """Turn the reference's ``FabricCluster.get_state()`` (every device's
    bridge, the host staging DDR whose log is the fabric log, the host
    channel and port arbiters, the switch ports with their credit windows,
    the fabric clock, the fabric-link fault plan, the counter banks) into
    what the port's ``FabricCluster.set_state`` accepts."""
    c = _Carrier()
    switch = state.get("switch")
    if switch is not None:
        switch = {"ports": [
            {"link": c.link(p["link"]), "inflight": list(p["inflight"]),
             "credit_stall": p["credit_stall"],
             "credit_waits": p["credit_waits"],
             "credit_grants": p["credit_grants"]}
            for p in switch["ports"]]}
    return {
        "devices": [c.bridge(d) for d in state["devices"]],
        "host": c.mem(state["host"]),
        "host_link": c.link(state["host_link"]),
        "ports": [c.link(p) for p in state["ports"]],
        "switch": switch,
        "time": state["time"],
        "fault_plan": c.plan(state["fault_plan"]),
        "counters": copy.deepcopy(state.get("counters")),
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
    tensors on ``device`` (every family's tree: the hybrid's stacked mamba
    leaves keep their ``(n_super, per)`` axes, the vlm's self-attention
    leaves their ``(n_cross, per)`` axes beside ``blocks/cross/*``, the
    moe's ``blocks/moe/*`` their ``(L, E)`` axes).
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
    the same keys, shapes and dtypes (``conv_tails`` stays a tuple, a
    vlm's ``cross_k`` / ``cross_v`` come along), so the port's
    ``make_decode_fn`` continues from the reference's prefill."""
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


def _burst_list(fn: Any) -> Any:
    """A recorded launch's burst-list callable as the port's: the tuples
    the reference's callable returns (engine, kind, address, bytes: the
    static tile schedule, value-free) behind a callable of the port."""
    if fn is None:
        return None
    txs = tuple(tuple(t) for t in fn())
    return lambda: [tuple(t) for t in txs]


def recording_from_reference(rec: Any) -> Any:
    """Carry a reference bridge ``Recording`` (``repro.core.replay``) into
    the port, for replay in a port ``DebugSession`` whose factory builds
    the same bridge (ops registered, congestion and fault plan from the
    same seeds).

    Events become the port's ``TimelineEvent``s with the same plain-data
    arguments (numpy arrays copied; a launch's burst-list callable carried
    as the tuples it returns, ``_burst_list``); checkpoint states go
    through ``bridge_state_from_reference``, and their fingerprints are
    the port's own over the carried state.  The line stream, its marks and
    the log digest are value-free and carried as they are.  The live target
    stays behind: a replay rebuilds its own."""
    from repro_torch.core import replay as rp

    def arg(a: Any) -> Any:
        return np.array(a, copy=True) if isinstance(a, np.ndarray) else a

    out = rp.Recording(rec.label, rec.interval)
    for ev in rec.events:
        args = tuple(arg(a) for a in ev.args)
        if ev.kind == "launch":
            args = args[:5] + (_burst_list(args[5]),) + args[6:]
        out.events.append(rp.TimelineEvent(ev.kind, args))
    for ck in rec.checkpoints:
        state = bridge_state_from_reference(ck.state)
        out.checkpoints.append(rp.Checkpoint(
            ck.op_index, state, rp.state_fingerprint(state),
            rp.functional_fingerprint(state)))
    out.preamble = list(rec.preamble)
    out.lines = list(rec.lines)
    out.line_marks = list(rec.line_marks)
    out.tx_marks = [list(m) for m in rec.tx_marks]
    out.log_digest = rec.log_digest
    last = out.checkpoints[-1]
    if last.op_index == out.n_ops:
        out.final_fingerprint = last.fingerprint
        out.final_func_fingerprint = last.func_fingerprint
    return out
