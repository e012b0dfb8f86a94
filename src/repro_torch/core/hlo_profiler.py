"""The program profiler behind the dry run and the roofline tables — the
port of ``repro.core.hlo_profiler`` (the FireBridge "bus transaction
monitor" of a whole program).

The reference parses the post-SPMD HLO text of a compiled program.  The
port has no whole-program HLO: PyTorch runs eagerly, and its sharded paths
are explicit SPMD (``sharding/comm.py``).  Its counterpart of "the
compiled per-device program" is the stream of ATen ops that one rank sends
to PyTorch's dispatcher.  Two front ends produce the same ``Profile``:

  * ``profile_hlo(text, world_size)`` — the reference's text parser, copied
    unchanged (plain Python): the port reads an HLO dump with it, and the
    tests hold the cost formulas to the reference's bit for bit.
  * ``profile_program(fn, *args, world_size, **kwargs)`` — runs ``fn``
    under ``ProgramCounter``, a ``TorchDispatchMode``, and counts every op
    it dispatches (on real tensors, or on ``meta`` tensors at production
    sizes with no device: the dry run).  Python loops
    unroll, so layers, microbatches and scan chunks are counted once per
    run: there is no trip count, and every record's ``multiplier`` is the
    number of calls it stands for.

Cost models (the reference's documented methodology):
  * FLOPs: 2 * out_elems * contracted_elems for every ``mm``, ``addmm``,
    ``bmm``, ``baddbmm``, ``mv``, ``dot`` (what ``matmul``, ``linear`` and
    ``einsum`` decompose into) and ``convolution``.  Elementwise FLOPs are
    excluded; ``flop_counter_flops`` holds PyTorch's own count
    (``torch.utils.flop_counter``'s formulas) of the same ops beside it.
  * HBM traffic at op granularity — what eager PyTorch launches; XLA's
    fusion granularity does not apply, so a chain of elementwise ops
    counts each of its intermediates.  Views are free (``view``,
    ``_unsafe_view``, ``expand``, ``permute``, ``transpose``, ``t``,
    ``slice``, ``select``, ``as_strided``, ``unsqueeze``, ``squeeze``,
    ``alias``, ``detach``: every op whose schema returns an alias of an
    input), and so are allocations without a write (``empty*``) and the
    port's custom kernel ops (``repro_torch::*``, as the reference counts
    a ``custom-call``).  ``clone``, ``_to_copy`` and ``copy_`` count twice
    their result (``copy`` / ``convert``); in-place slice writes
    (``index_put_``, ``slice_scatter``, ``select_scatter``; a ``copy_``
    into a view) twice the update (``dynamic-update-slice``).  Every other
    op counts its tensor operands plus its results.
  * Collective bytes per device: the reference's ring formulas —
    all-reduce 2(g-1)/g * n, all-gather / reduce-scatter / all-to-all
    (g-1)/g * n, collective-permute (send / recv) and broadcast n — for
    the ``c10d.*`` ops of ``torch.distributed``'s eager API
    (``sharding/comm.py``) and the ``_c10d_functional.*`` ops of DTensor's
    redistribution; g is the size of the op's process group.

``DotRecord.jax_path`` keeps its name and holds the source attribution of
the call: the innermost frame of the port on the Python stack, as
``models/attention.py:_flash_fwd_impl``.  ``computation`` is
``forward`` or ``backward`` (an op the autograd engine runs).

The roofline constants are the card's, not the TPU's: see
``PEAK_FLOPS_BF16``, ``HBM_BW`` and ``NVLINK_BW``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
import re
import sys
import weakref
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e5m2": 1, "f8e4m3fn": 1, "f8e4m3": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_OP_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(\(.*?\)|\S+)\s+([\w\-]+)\((.*)$")
_COMP_HDR_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->")

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

_FREE_OPS = {
    "parameter", "constant", "get-tuple-element", "tuple", "bitcast",
    "reshape", "after-all", "partition-id", "replica-id", "iota",
    "while", "conditional", "call", "custom-call",
}


def _type_bytes_elems(type_str: str) -> Tuple[int, int]:
    total_b = total_e = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        elems = 1
        if dims:
            for d in dims.split(","):
                elems *= int(d)
        total_e += elems
        total_b += elems * _DTYPE_BYTES[dt]
    return total_b, total_e


@dataclasses.dataclass
class Op:
    name: str
    type_str: str
    opcode: str
    operands: List[str]
    attrs: str
    is_root: bool = False

    @property
    def result_bytes(self) -> int:
        return _type_bytes_elems(self.type_str)[0]

    @property
    def result_elems(self) -> int:
        return _type_bytes_elems(self.type_str)[1]

    def result_dims(self) -> List[int]:
        m = _SHAPE_RE.search(self.type_str)
        if not m:
            return []
        return [int(d) for d in m.group(2).split(",")] if m.group(2) else []


@dataclasses.dataclass
class CollectiveRecord:
    kind: str
    op_name: str
    computation: str
    shape: str
    bytes_full: int          # tensor bytes (per device view)
    bytes_moved: int         # ring-model bytes over the wire per device
    group_size: int
    multiplier: int

    @property
    def total_bytes(self) -> int:
        return self.bytes_moved * self.multiplier


@dataclasses.dataclass
class DotRecord:
    op_name: str
    computation: str
    shape: str
    flops: float             # per execution
    multiplier: int
    jax_path: str            # from metadata op_name (source attribution)

    @property
    def total_flops(self) -> float:
        return self.flops * self.multiplier


@dataclasses.dataclass
class Profile:
    flops: float
    traffic_bytes: float
    collective_bytes: float
    collectives: List[CollectiveRecord]
    dot_count: int
    warnings: List[str]
    per_comp_mult: Dict[str, int]
    dots: List[DotRecord] = dataclasses.field(default_factory=list)

    def top_dots(self, n: int = 15) -> List[DotRecord]:
        return sorted(self.dots, key=lambda d: -d.total_flops)[:n]

    def top_collectives(self, n: int = 15) -> List[CollectiveRecord]:
        return sorted(self.collectives, key=lambda c: -c.total_bytes)[:n]

    def collective_summary(self) -> Dict[str, Tuple[int, float]]:
        agg: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
        for c in self.collectives:
            agg[c.kind][0] += c.multiplier
            agg[c.kind][1] += c.total_bytes
        return {k: (int(v[0]), v[1]) for k, v in agg.items()}


def _parse_computations(text: str) -> Dict[str, Tuple[List[Op], bool]]:
    comps: Dict[str, Tuple[List[Op], bool]] = {}
    cur: Optional[str] = None
    ops: List[Op] = []
    is_entry = False
    for line in text.splitlines():
        if cur is None:
            if line.rstrip().endswith("{"):
                m = _COMP_HDR_RE.match(line.strip())
                if m:
                    cur = m.group(1)
                    is_entry = line.lstrip().startswith("ENTRY")
                    ops = []
            continue
        if line.strip() == "}":
            comps[cur] = (ops, is_entry)
            cur = None
            continue
        m = _OP_RE.match(line)
        if m:
            name, tstr, opcode, rest = m.groups()
            operand_refs = re.findall(r"%([\w.\-]+)", rest)
            ops.append(Op(name=name, type_str=tstr, opcode=opcode,
                          operands=operand_refs, attrs=rest,
                          is_root="ROOT" in line[:12]))
    return comps


def _trip_count(cond_ops: List[Op]) -> int:
    best = 1
    for op in cond_ops:
        if op.opcode == "constant":
            m = re.search(r"constant\((\d+)\)", op.attrs or "")
            # attrs holds text after "constant(" already split; reconstruct:
            if not m:
                m = re.search(r"^(\d+)\)", op.attrs)
            if m:
                best = max(best, int(m.group(1)))
    return best


def _group_size(attrs: str, world: int) -> int:
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]", attrs)
    if m:
        return int(m.group(2))
    m = re.search(r"replica_groups=\{\{([\d,]+)\}", attrs)
    if m:
        return len(m.group(1).split(","))
    return world


def _dot_flops(op: Op, by_name: Dict[str, Op], warnings: List[str]) -> float:
    out_elems = op.result_elems
    m = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", op.attrs)
    lhs = by_name.get(op.operands[0]) if op.operands else None
    if lhs is None or m is None:
        warnings.append(f"dot {op.name}: missing lhs shape; counted 2*out")
        return 2.0 * out_elems
    dims = lhs.result_dims()
    contracted = 1
    if m.group(1):
        for i in m.group(1).split(","):
            idx = int(i)
            if idx < len(dims):
                contracted *= dims[idx]
    return 2.0 * out_elems * contracted


def _op_traffic(op: Op, by_name: Dict[str, Op]) -> int:
    oc = op.opcode
    if oc in _FREE_OPS or oc in _COLLECTIVES:
        return 0
    if oc in ("dynamic-update-slice",):
        upd = by_name.get(op.operands[1]) if len(op.operands) > 1 else None
        return 2 * (upd.result_bytes if upd else 0)
    if oc in ("dynamic-slice", "copy", "transpose", "broadcast", "convert"):
        return 2 * op.result_bytes
    # general: operands + result
    total = op.result_bytes
    for o in op.operands:
        src = by_name.get(o)
        if src is not None:
            total += src.result_bytes
    return total


def profile_hlo(text: str, world_size: int) -> Profile:
    comps = _parse_computations(text)
    warnings: List[str] = []
    entry = None
    for name, (_, is_entry) in comps.items():
        if is_entry:
            entry = name
    if entry is None:
        raise ValueError("no ENTRY computation found")

    # call graph edges
    flops_mult: Dict[str, float] = defaultdict(float)
    bytes_mult: Dict[str, float] = defaultdict(float)
    flops_mult[entry] = 1.0
    bytes_mult[entry] = 1.0

    # process in BFS order from entry
    order = [entry]
    seen = {entry}
    i = 0
    while i < len(order):
        comp = order[i]
        i += 1
        ops, _ = comps.get(comp, ([], False))
        fm, bm = flops_mult[comp], bytes_mult[comp]
        for op in ops:
            a = op.attrs
            if op.opcode == "while":
                mb = re.search(r"body=%?([\w.\-]+)", a)
                mc = re.search(r"condition=%?([\w.\-]+)", a)
                if mb and mc:
                    trip = _trip_count(comps.get(mc.group(1), ([], False))[0])
                    for child, mult_f, mult_b in (
                            (mb.group(1), fm * trip, bm * trip),
                            (mc.group(1), 0.0, 0.0)):
                        flops_mult[child] += mult_f
                        bytes_mult[child] += mult_b
                        if child not in seen:
                            seen.add(child)
                            order.append(child)
            elif op.opcode == "fusion":
                mf = re.search(r"calls=%?([\w.\-]+)", a)
                if mf:
                    child = mf.group(1)
                    flops_mult[child] += fm     # dots inside fusions count
                    # bytes counted at the callsite, not inside
                    if child not in seen:
                        seen.add(child)
                        order.append(child)
            elif op.opcode in ("call", "async-start"):
                mf = re.search(r"(?:to_apply|calls)=%?([\w.\-]+)", a)
                if mf:
                    child = mf.group(1)
                    flops_mult[child] += fm
                    bytes_mult[child] += bm
                    if child not in seen:
                        seen.add(child)
                        order.append(child)
            elif op.opcode == "conditional":
                for mf in re.finditer(
                        r"(?:true_computation|false_computation|branch_computations=\{[^}]*)=?%?([\w.\-]+)", a):
                    child = mf.group(1)
                    if child in comps:
                        flops_mult[child] += fm
                        bytes_mult[child] += bm
                        if child not in seen:
                            seen.add(child)
                            order.append(child)

    total_flops = 0.0
    total_traffic = 0.0
    total_coll = 0.0
    dot_count = 0
    coll_records: List[CollectiveRecord] = []
    dot_records: List[DotRecord] = []

    for comp, (ops, _) in comps.items():
        fm = flops_mult.get(comp, 0.0)
        bm = bytes_mult.get(comp, 0.0)
        if fm == 0 and bm == 0:
            continue
        by_name = {op.name: op for op in ops}
        for op in ops:
            oc = op.opcode
            base = oc.replace("-start", "")
            if base in _COLLECTIVES and not oc.endswith("-done"):
                g = _group_size(op.attrs, world_size)
                if base == "all-gather":
                    nb = op.result_bytes
                    moved = nb * (g - 1) // max(g, 1)
                elif base == "reduce-scatter":
                    src = by_name.get(op.operands[0]) if op.operands else None
                    nb = src.result_bytes if src else op.result_bytes * g
                    moved = nb * (g - 1) // max(g, 1)
                elif base == "all-reduce":
                    nb = op.result_bytes
                    moved = 2 * nb * (g - 1) // max(g, 1)
                elif base == "all-to-all":
                    nb = op.result_bytes
                    moved = nb * (g - 1) // max(g, 1)
                else:  # collective-permute
                    nb = op.result_bytes
                    moved = nb
                rec = CollectiveRecord(
                    kind=base, op_name=op.name, computation=comp,
                    shape=op.type_str, bytes_full=nb, bytes_moved=moved,
                    group_size=g, multiplier=int(max(bm, fm)))
                coll_records.append(rec)
                total_coll += rec.total_bytes
                continue
            if oc in ("dot", "convolution"):
                dot_count += 1
                if fm:
                    fl = _dot_flops(op, by_name, warnings)
                    total_flops += fm * fl
                    mpath = re.search(r'op_name="([^"]*)"', op.attrs)
                    dot_records.append(DotRecord(
                        op_name=op.name, computation=comp, shape=op.type_str,
                        flops=fl, multiplier=int(fm),
                        jax_path=mpath.group(1) if mpath else ""))
                if bm:
                    total_traffic += bm * _op_traffic(op, by_name)
                continue
            if bm:
                total_traffic += bm * _op_traffic(op, by_name)

    return Profile(flops=total_flops, traffic_bytes=total_traffic,
                   collective_bytes=total_coll, collectives=coll_records,
                   dot_count=dot_count, warnings=warnings,
                   per_comp_mult={k: int(v) for k, v in flops_mult.items()},
                   dots=dot_records)




# ---------------------------------------------------------------------------
# The dispatcher front end: one rank's op stream
# ---------------------------------------------------------------------------

_THIS = os.path.abspath(__file__)
_PKG_DIR = os.path.dirname(os.path.dirname(_THIS)) + os.sep
_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__)) + os.sep
_FAKE_KEY = torch._C._TorchDispatchModeKey.FAKE

_HLO_DTYPE = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.float16: "f16", torch.bfloat16: "bf16",
    torch.int32: "s32", torch.float32: "f32", torch.int64: "s64",
    torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
    torch.float8_e5m2: "f8e5m2", torch.float8_e4m3fn: "f8e4m3fn",
}

_ATEN_DOTS = {"mm", "addmm", "bmm", "baddbmm", "mv", "dot", "vdot",
            "convolution", "_convolution", "convolution_backward"}
# ops whose schema marks no alias but whose result shares its input's
# storage
_ATEN_ALIASING = {"_unsafe_view", "_reshape_alias", "lift_fresh"}
# free besides the views: those, and allocations without a write
_ATEN_FREE = _ATEN_ALIASING | {
    "empty", "empty_like", "empty_strided", "empty_permuted", "new_empty",
    "new_empty_strided", "_local_scalar_dense"}
_ATEN_COPY = {"clone", "_to_copy", "copy_", "copy", "contiguous"}
_ATEN_UPDATE = {"index_put_", "index_put", "_index_put_impl_",
                 "slice_scatter", "select_scatter", "as_strided_scatter",
                 "diagonal_scatter"}
_COLLECTIVE_NS = ("c10d", "_c10d_functional", "_c10d_functional_autograd")
_COLLECTIVE_FREE = {"wait_tensor", "barrier", "monitored_barrier_",
                    "_wrap_tensor_autograd"}
# op name -> (kind, where the bytes are: "in" = the input, else the result)
_COLLECTIVE_KIND = {
    "allreduce_": ("all-reduce", "in"),
    "allreduce_coalesced_": ("all-reduce", "in"),
    "all_reduce": ("all-reduce", "in"), "all_reduce_": ("all-reduce", "in"),
    "all_reduce_coalesced": ("all-reduce", "in"),
    "all_reduce_coalesced_": ("all-reduce", "in"),
    "allgather_": ("all-gather", "out"),
    "_allgather_base_": ("all-gather", "out"),
    "allgather_coalesced_": ("all-gather", "out"),
    "allgather_into_tensor_coalesced_": ("all-gather", "out"),
    "all_gather_into_tensor": ("all-gather", "out"),
    "all_gather_into_tensor_out": ("all-gather", "out"),
    "all_gather_into_tensor_coalesced": ("all-gather", "out"),
    "reduce_scatter_": ("reduce-scatter", "in"),
    "_reduce_scatter_base_": ("reduce-scatter", "in"),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", "in"),
    "reduce_scatter_tensor": ("reduce-scatter", "in"),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", "in"),
    "alltoall_": ("all-to-all", "out"), "alltoall_base_": ("all-to-all", "out"),
    "all_to_all_single": ("all-to-all", "out"),
    "broadcast_": ("broadcast", "in"), "broadcast": ("broadcast", "in"),
    "send": ("collective-permute", "in"), "recv_": ("collective-permute", "in"),
    "recv_any_source_": ("collective-permute", "in"),
}
# c10d ops whose first argument is the result and whose second the input
# (the others take the tensors they work on first)
_C10D_OUT_FIRST = {"allgather_", "_allgather_base_", "allgather_coalesced_",
                   "allgather_into_tensor_coalesced_", "reduce_scatter_",
                   "_reduce_scatter_base_", "reduce_scatter_tensor_coalesced_",
                   "alltoall_", "alltoall_base_"}


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def type_str(t: torch.Tensor) -> str:
    """``t``'s type as HLO prints it (``bf16[2,4096,2048]``)."""
    return f"{_HLO_DTYPE.get(t.dtype, str(t.dtype))}" \
        f"[{','.join(str(d) for d in t.shape)}]"


def _aten_dot_flops(name: str, args, out) -> float:
    """2 * out_elems * contracted_elems (one ``dot`` / ``convolution``)."""
    if name in ("mm", "bmm", "mv"):
        return 2.0 * out.numel() * args[0].shape[-1]
    if name in ("addmm", "baddbmm"):
        return 2.0 * out.numel() * args[1].shape[-1]
    if name in ("dot", "vdot"):
        return 2.0 * args[0].numel()
    if name == "convolution_backward":
        grad_out, inp, w = args[0], args[1], args[2]
        per = _conv_flops(inp, w, grad_out, args[7])
        return per * (int(args[10][0]) + int(args[10][1]))
    return _conv_flops(args[0], args[1], out, args[6])


def _conv_flops(inp, w, out, transposed: bool) -> float:
    taps = math.prod(w.shape[2:])
    if transposed:                    # w (C_in, C_out / groups, k...)
        return 2.0 * inp.numel() * w.shape[1] * taps
    return 2.0 * out.numel() * w.shape[1] * taps


def _update_bytes(name: str, args) -> int:
    """Bytes an in-place slice write stores (the update's)."""
    if name in ("index_put_", "index_put", "_index_put_impl_"):
        dst, idx = args[0], args[1]
        shapes = [i.shape for i in idx if i is not None]
        n = math.prod(torch.broadcast_shapes(*shapes)) if shapes else 1
        rest = [d for i, d in enumerate(dst.shape)
                if i >= len(idx) or idx[i] is None]
        return n * math.prod(rest) * dst.element_size()
    return _nbytes(args[1])                               # the src


def _pg_size(func_name: str, ns: str, args) -> int:
    import torch.distributed as dist
    if ns == "c10d":
        for a in args:
            if isinstance(a, torch.ScriptObject) and \
                    a._type().qualified_name().endswith("ProcessGroup"):
                return dist.ProcessGroup.unbox(a).size()
        raise ValueError(f"c10d.{func_name}: no process group argument")
    if func_name in ("all_gather_into_tensor", "all_gather_into_tensor_out",
                     "all_gather_into_tensor_coalesced",
                     "reduce_scatter_tensor",
                     "reduce_scatter_tensor_coalesced"):
        return int(next(a for a in args if isinstance(a, int)
                        and not isinstance(a, bool)))
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = [a for a in args if isinstance(a, str)][-1]      # group_name
    return _resolve_process_group(name).size()


def _round_block(n: int) -> int:
    """Bytes the CUDA caching allocator sets aside for an ``n``-byte
    tensor (blocks of 512 bytes)."""
    return -(-n // 512) * 512


class ProgramCounter(TorchDispatchMode):
    """Counts the ops one rank dispatches, by the cost model of the module
    docstring, and the bytes of the tensors they keep alive: every storage
    an op returns is live until it is freed, and the largest sum is
    ``peak_bytes`` — with ``track()`` of the arguments first, the program's
    peak, rounded as the CUDA caching allocator rounds.  Ops on tensor subclasses (DTensor) are handed on; the ops on
    local tensors they turn into come back here.  Ops dispatched while a
    ``FakeTensorMode`` is active are DTensor's sharding propagation (it
    runs an op it has not met on global-shape fake tensors to learn its
    output's metadata) and are not counted, so the program itself runs on
    real or meta tensors, never under ``FakeTensorMode``.  ``log_ops``
    keeps one ``(op, shapes, flops, traffic)`` entry a counted op, to find
    where two runs part; ``reuse_shapes=False`` runs every op's shape
    function on meta tensors (see ``_run``), the reference the tests hold
    the reuse to.  ``peak_sites`` attributes the live bytes to where each
    storage was made (``"forward|backward file:function"`` of the port's
    innermost frame, ``"arguments"`` for ``track()``): ``peak_by_site``
    holds that split at the peak, to within 1 MiB."""

    def __init__(self, world_size: int = 1, *, log_ops: bool = False,
                 reuse_shapes: bool = True, peak_sites: bool = False):
        super().__init__()
        self._shapes: Optional[dict] = {} if reuse_shapes else None
        self._reuse: Dict[Any, str] = {}
        self._infos: Dict[Any, tuple] = {}
        self.world_size = world_size
        self.flops = 0.0
        self.traffic_bytes = 0.0
        self.flop_counter_flops = 0.0
        self.dot_count = 0
        self.custom_calls: Dict[str, int] = defaultdict(int)
        self.collectives: List[CollectiveRecord] = []
        self.comps: Dict[str, int] = {}
        self._dots: Dict[tuple, DotRecord] = {}
        self._where: Dict[Any, str] = {}
        self.ops: Optional[List[tuple]] = [] if log_ops else None
        self.live_bytes = self.peak_bytes = 0
        self._live: Dict[int, tuple] = {}
        self._site_bytes: Optional[Dict[str, int]] = \
            defaultdict(int) if peak_sites else None
        self.peak_by_site: Dict[str, int] = {}
        self._site_peak = 0

    # ------------------------------------------------------------ memory
    def track(self, *trees) -> int:
        """Counts the storages of ``trees``' tensors (DTensors: their local
        tensors) as live; returns their bytes."""
        before = self.live_bytes
        for t in _leaf_tensors(trees):
            self._hold(t, "arguments")
        return self.live_bytes - before

    def _hold(self, t: torch.Tensor, site: Optional[str] = None) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = _round_block(st.nbytes())
        if self._site_bytes is not None and site is None:
            comp = "backward" if torch._C._current_graph_task_id() >= 0 \
                else "forward"
            site = f"{comp} {self._caller()}"
        self._live[key] = (weakref.ref(st, functools.partial(
            self._release, key)), n, site)
        self.live_bytes += n
        if self._site_bytes is not None:
            self._site_bytes[site] += n
            if self.live_bytes > self._site_peak + (1 << 20):
                self._site_peak = self.live_bytes
                self.peak_by_site = {k: v for k, v in
                                     self._site_bytes.items() if v}
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _release(self, key: int, _ref) -> None:
        entry = self._live.pop(key, None)
        if entry is not None:
            self.live_bytes -= entry[1]
            if self._site_bytes is not None:
                self._site_bytes[entry[2]] -= entry[1]

    # ------------------------------------------------------------ counting
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if torch._C._get_dispatch_mode(_FAKE_KEY) is not None:
            # DTensor runs an op it has not met on global-shape fake
            # tensors to learn its output's metadata: not the rank's program
            return func(*args, **kwargs)
        for t in types:
            if t is not torch.Tensor:
                return NotImplemented
        out = self._run(func, args, kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _run(self, func, args, kwargs):
        """``func(*args, **kwargs)``; with ``reuse_shapes``, an op on meta
        tensors whose arguments' metadata it has met before returns fresh
        tensors of the outputs' recorded metadata (an op writing its first
        argument in place returns it) instead of running its shape
        function again."""
        if self._shapes is None:
            return func(*args, **kwargs)
        how = self._reuse.get(func)
        if how is None:
            how = self._reuse[func] = _reuse_kind(func)
        if not how:
            return func(*args, **kwargs)
        try:
            key = (func, _meta_key(args), _meta_key(kwargs))
            spec = self._shapes.get(key)
        except (_NotMeta, TypeError):          # a real tensor, unhashable
            return func(*args, **kwargs)
        if spec is not None:
            return args[0] if how == "inplace" else _from_spec(spec)
        out = func(*args, **kwargs)
        if how == "inplace":
            self._shapes[key] = True
        else:
            spec = _spec(out)
            if spec is not None:
                self._shapes[key] = spec
        return out

    def _caller(self) -> str:
        """The innermost frame outside torch: ``file:function``, the file
        relative to the port's package where it lies there."""
        f = sys._getframe(3)
        while f is not None:
            code = f.f_code
            hit = self._where.get(code)
            if hit is None:
                fn = os.path.abspath(code.co_filename)
                if fn.startswith(_TORCH_DIR) or fn == _THIS:
                    hit = ""
                else:
                    rel = fn[len(_PKG_DIR):] if fn.startswith(_PKG_DIR) \
                        else os.path.basename(fn)
                    hit = f"{rel}:{code.co_name}"
                self._where[code] = hit
            if hit:
                return hit
            f = f.f_back
        return "<no caller frame>"

    def _info(self, func) -> tuple:
        """(namespace, name, traffic rule, is a dot, PyTorch's FLOP
        formula or None) of ``func``, worked out once."""
        info = self._infos.get(func)
        if info is None:
            ns, name = func.namespace, func._schema.name.split("::")[-1]
            if ns in _COLLECTIVE_NS:
                rule = "free" if name in _COLLECTIVE_FREE else "collective"
            elif ns == "repro_torch":
                rule = "custom"
            elif ns != "aten":
                rule = "ignore"
            elif func.is_view or name in _ATEN_FREE:
                rule = "free"
            elif name in _ATEN_UPDATE:
                rule = "update"
            elif name in _ATEN_COPY:
                rule = "copy"
            else:
                rule = "operands+result"
            info = (ns, name, rule, ns == "aten" and name in _ATEN_DOTS,
                    _flop_registry().get(func._overloadpacket)
                    if ns == "aten" else None)
            self._infos[func] = info
        return info

    def _count(self, func, args, kwargs, out) -> None:
        ns, name, rule, dot, flop_fn = self._info(func)
        comp = "backward" if torch._C._current_graph_task_id() >= 0 \
            else "forward"
        self.comps.setdefault(comp, 1)
        flops = traffic = 0.0
        if rule == "collective":
            self._collective(ns, name, args, out, comp)
        elif rule == "custom":
            self.custom_calls[name] += 1          # custom-call: free
        elif ns == "aten":
            if dot:
                flops = _aten_dot_flops(name, args, out)
                self._dot(func, out, flops, self._caller(), comp)
            if flop_fn is not None:
                self.flop_counter_flops += flop_fn(*args, **kwargs,
                                                   out_val=out)
            if rule == "update":
                traffic = 2.0 * _update_bytes(name, args)
            elif rule == "copy":
                traffic = 2.0 * _nbytes(out)
            elif rule == "operands+result":
                traffic = float(_nbytes(args) + _nbytes(out))
            self.traffic_bytes += traffic
        for t in _tensors(out):
            self._hold(t)
        if self.ops is not None:
            self.ops.append((f"{ns}.{name}", tuple(
                tuple(t.shape) for t in _tensors(args)), flops, traffic))

    def _dot(self, func, out, flops: float, where: str, comp: str) -> None:
        self.dot_count += 1
        shape = type_str(out) if isinstance(out, torch.Tensor) else \
            ",".join(type_str(t) for t in _tensors(out))
        key = (str(func), shape, where, comp)
        rec = self._dots.get(key)
        if rec is None:
            self._dots[key] = DotRecord(op_name=str(func), computation=comp,
                                        shape=shape, flops=flops,
                                        multiplier=1, jax_path=where)
        else:
            rec.multiplier += 1
        self.flops += flops

    def _collective(self, ns: str, name: str, args, out, comp: str) -> None:
        if name not in _COLLECTIVE_KIND:
            raise NotImplementedError(f"{ns}.{name}: no cost formula")
        kind, side = _COLLECTIVE_KIND[name]
        if ns == "c10d":
            src = args[1 if side == "in" and name in _C10D_OUT_FIRST else 0]
        else:
            src = args[0] if side == "in" else out
        nb = _nbytes(src)
        g = _pg_size(name, ns, args)
        if g > self.world_size:
            raise ValueError(f"{ns}.{name}: a group of {g} ranks in a world "
                             f"of {self.world_size}")
        if kind == "all-reduce":
            moved = 2 * nb * (g - 1) // max(g, 1)
        elif kind in ("collective-permute", "broadcast"):
            moved = nb if g > 1 or kind == "collective-permute" else 0
        else:
            moved = nb * (g - 1) // max(g, 1)
        main = _tensors(src)
        self.collectives.append(CollectiveRecord(
            kind=kind, op_name=f"{ns}.{name}", computation=comp,
            shape=type_str(main[0]) if main else "", bytes_full=nb,
            bytes_moved=moved, group_size=g, multiplier=1))

    # ------------------------------------------------------------ result
    def profile(self) -> Profile:
        return Profile(
            flops=self.flops, traffic_bytes=self.traffic_bytes,
            collective_bytes=float(sum(c.total_bytes
                                       for c in self.collectives)),
            collectives=list(self.collectives), dot_count=self.dot_count,
            warnings=[], per_comp_mult=dict(self.comps),
            dots=list(self._dots.values()))


class _NotMeta(Exception):
    pass


def _meta_key(x):
    """A hashable key of ``x``'s metadata (tensors: shape, stride, type,
    offset); raises ``_NotMeta`` for a tensor that is not on meta."""
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            raise _NotMeta
        return (tuple(x.shape), x.stride(), x.dtype, x.storage_offset())
    if isinstance(x, (list, tuple)):
        return tuple(_meta_key(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _meta_key(v)) for k, v in x.items())
    return x


def _reuse_kind(func) -> str:
    """"functional" (fresh outputs), "inplace" (returns its first argument,
    written) or "" (views, other aliasing, non-aten ops: always run)."""
    if func.namespace != "aten" or func.is_view or \
            func._schema.name.split("::")[-1] in _ATEN_ALIASING:
        return ""
    sch = func._schema
    rets = sch.returns
    if not sch.is_mutable and all(r.alias_info is None for r in rets):
        return "functional"
    first = sch.arguments[0].alias_info if sch.arguments else None
    if len(rets) == 1 and rets[0].alias_info is not None and \
            rets[0].alias_info.is_write and first is not None and \
            first.is_write and not any(a.alias_info is not None and
                                       a.alias_info.is_write
                                       for a in sch.arguments[1:]):
        return "inplace"
    return ""


def _spec(out):
    """How to rebuild ``out`` (fresh meta tensors of its metadata), or
    None."""
    if isinstance(out, torch.Tensor):
        if not out.is_meta or out.storage_offset():
            return None
        return (tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (list, tuple)):
        parts = [_spec(v) for v in out]
        if any(p is None for p in parts):
            return None
        return (type(out), parts)
    return None


def _from_spec(spec):
    if isinstance(spec[0], type):
        return spec[0](_from_spec(p) for p in spec[1])
    shape, stride, dtype = spec
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


@functools.lru_cache(maxsize=None)
def _flop_registry() -> dict:
    from torch.utils.flop_counter import flop_registry
    return flop_registry


def _leaf_tensors(tree) -> List[torch.Tensor]:
    from torch.distributed.tensor import DTensor
    out = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, DTensor):
            out.append(x.to_local())
        elif isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    return out


def profile_program(fn: Callable, *args, world_size: int = 1,
                    **kwargs) -> Profile:
    """Runs ``fn(*args, **kwargs)`` once and counts what it dispatched:
    the port's counterpart of ``profile_hlo`` of its compiled program."""
    with ProgramCounter(world_size) as counter:
        fn(*args, **kwargs)
    return counter.profile()


# ---------------------------------------------------------------------------
# Roofline terms: one NVIDIA H100 SXM5 80GB HBM3 at its 700 W power limit
# (published dense peaks; the hopper-kernels table).  They replace the
# reference's TPU v5e constants.
# ---------------------------------------------------------------------------

PEAK_FLOPS_BF16 = 989e12        # bf16 tensor cores, dense, per card
HBM_BW = 3.35e12                # bytes/s per card
# NVLink, each way, to the other cards of one host.  A group wider than 8
# cards crosses hosts (InfiniBand, several times slower), so for the
# production meshes' groups of 16 and 32 this term under-states the time.
NVLINK_BW = 450e9               # bytes/s


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achievable if the program ran at
        the max(terms) bound: ideal_compute_time / bound_time."""
        ideal = self.model_flops / PEAK_FLOPS_BF16
        return ideal / self.bound_s if self.bound_s else 0.0


def roofline(profile: Profile, model_flops_per_device: float,
             n_links: int = 1) -> RooflineTerms:
    return RooflineTerms(
        compute_s=profile.flops / PEAK_FLOPS_BF16,
        memory_s=profile.traffic_bytes / HBM_BW,
        collective_s=profile.collective_bytes / (n_links * NVLINK_BW),
        model_flops=model_flops_per_device,
        hlo_flops=profile.flops,
    )
