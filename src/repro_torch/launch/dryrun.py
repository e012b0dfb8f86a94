"""The dry run — the port of ``repro.launch.dryrun``: every (arch, shape)
cell of the production meshes (16 x 16, and 2 x 16 x 16 with
``--multi-pod``) profiled at its full size, on no device.

It is the one entry point of the port that runs on no card, as the
reference's runs on forced host devices.  The reference lowers each cell
with ``jax.jit`` for 512 host devices and parses the compiled per-device
HLO.  The port's counterpart of that program is the stream of ATen ops
that rank 0 of the port's explicit-SPMD step sends to the dispatcher, and
it is counted the same way (``core/hlo_profiler.py``):

  * a fake process group (``torch.distributed``'s "fake" backend, which
    moves nothing) of ``mesh.size`` ranks, this process rank 0, with the
    mesh bound to it (``Mesh.bind("cpu")``);
  * rank 0's shards of the state and the inputs, in the layouts of
    ``train_shardings``, ``prefill_shardings`` or ``decode_shardings``, as
    DTensors over tensors on the ``meta`` device (shapes, types and
    strides, no storage);
  * the step run once under ``ProgramCounter``: FLOPs, traffic,
    collectives, and the bytes its live tensors hold at their peak;
  * the group destroyed, so that cells on 256 and 512 ranks share nothing.

The step is the port's, as its users call it: the train step of
``make_train_step`` (the batch whole on every rank, as the ``Trainer``
feeds it), the prefill of ``make_prefill_fn`` (the prompts whole; it
computes rank 0's rows and returns its shard of the cache) and the decode
of ``make_decode_fn`` on rank 0's shard of the cache, the new one kept as
the local shards of the same layout (as ``ServingEngine(ctx=...)`` holds
it).  Inputs that the port takes whole are handed in the reference's
layouts and gathered inside the step, so every cell's arguments are rank
0's shards.

Meta tensors rather than ``FakeTensorMode``: a fake tensor is a meta tensor
behind a Python wrapper that costs 0.1-0.6 ms an op on a CPU host, and a
train cell dispatches millions of ops (llama3.2-1b's train_4k took 1395 s
under ``FakeTensorMode``; the record is the same on meta tensors, where the
counter also reuses each op's output metadata, in some 120 s).  The ops
the port dispatches do not depend on the device: ``chip_smoke.py``'s
``dryrun`` phase holds the count of a step on meta tensors to the same
step's on the card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Optional

import torch

from repro_torch._tree import paths, unflatten
from repro_torch.configs import (SHAPES, applicable_shapes, get_config,
                                 list_archs, non_embedding_params)
from repro_torch.core import hlo_profiler
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_ctx, make_production_mesh
from repro_torch.models.transformer import (RunFlags, make_decode_fn,
                                            make_prefill_fn)
from repro_torch.sharding.specs import from_local_tree, local_tree, \
    whole_tree

ART_DIR = Path(__file__).resolve().parents[3] / "benchmarks" / "artifacts" \
    / "torch" / "dryrun"


def model_flops(cfg, shape, kind: str) -> float:
    """MODEL_FLOPS per the assignment: 6·N·D train (N active for MoE),
    2·N·D forward-only (prefill), 2·N per token (decode)."""
    n = non_embedding_params(cfg, active_only=cfg.moe is not None)
    if kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # decode: one token per seq


@contextlib.contextmanager
def fake_process_group(world: int):
    """A process group of ``world`` ranks on the fake backend, this
    process rank 0; destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run initialises a fake process group of "
                           "its own; one is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@dataclasses.dataclass
class Lowered:
    """One cell's step and rank 0's meta arguments: ``fn(*args)`` is the
    program; ``args[donated]`` is the argument its outputs replace (the
    state in training, the cache in decode; None: none)."""
    fn: Callable
    args: tuple
    donated: Optional[int]


def _materialise(shape_tree: Any, shardings: Any,
                 grad: bool = False) -> Any:
    """Rank 0's shard of every leaf of ``shape_tree`` (meta tensors) as a
    DTensor of ``shardings``' layout, its local tensor on ``meta``."""
    from torch.distributed.tensor import DTensor
    shs = [sh for _, sh in paths(shardings)]
    out = []
    for (_, t), sh in zip(paths(shape_tree), shs):
        idx = sh.local_index(tuple(t.shape), sh.mesh.coordinate())
        local = torch.empty([s.stop - s.start for s in idx], dtype=t.dtype,
                            device="meta")
        d = DTensor.from_local(local, sh.mesh.device_mesh, sh.placements,
                               run_check=False, shape=t.shape,
                               stride=t.stride())
        out.append(d.requires_grad_() if grad and t.is_floating_point()
                   else d)
    return unflatten(shape_tree, out)


def train_plan(cfg, shape, mesh, flags: RunFlags, zero_level: int = -1):
    """The reference's rule for a train cell: (ZeRO level, flags with the
    microbatch count)."""
    if zero_level < 0:      # auto: FSDP masters when ZeRO-1 won't fit
        zero_level = 1
        if steps_lib.train_state_bytes_per_device(cfg, mesh, 1) > 6e9:
            zero_level = 3
    # auto grad accumulation: bound activation live-set per microbatch
    # to ~4096 tokens/device (1M-token global batches always accumulate)
    ax = dict(zip(mesh.axis_names, mesh.devices.shape))
    dsize = mesh.devices.size // ax["model"]
    tok_dev = shape.global_batch * shape.seq_len // dsize
    want_nm = max(flags.microbatches, tok_dev // 4096)
    while shape.global_batch % want_nm:
        want_nm += 1
    if want_nm != flags.microbatches:
        flags = dataclasses.replace(flags, microbatches=want_nm)
    return zero_level, flags


def build_lowered(cfg, shape, mesh, ctx, flags: RunFlags,
                  zero_level: int = -1):
    """The cell's step and rank 0's arguments (``Lowered``), under a bound
    ``mesh``, on meta tensors; the ZeRO level and the
    microbatch count chosen by the reference's rule."""
    kind = shape.kind
    if kind == "train":
        zero_level, flags = train_plan(cfg, shape, mesh, flags, zero_level)
        st_shape, st_sh, b_shape, b_sh, gshard = steps_lib.train_shardings(
            cfg, shape, mesh, ctx, zero_level=zero_level)
        state = {"params": _materialise(st_shape["params"],
                                        st_sh["params"], grad=True),
                 **{k: _materialise(st_shape[k], st_sh[k])
                    for k in ("m", "v", "step")}}
        step = steps_lib.make_train_step(cfg, flags, ctx,
                                         grad_shardings=gshard)

        def train(state, batch):
            return step(state, whole_tree(batch))
        return Lowered(train, (state, _materialise(b_shape, b_sh)), 0), \
            zero_level, flags
    if kind == "prefill":
        p_shape, p_sh, b_shape, b_sh = steps_lib.prefill_shardings(
            cfg, shape, mesh, ctx)
        step = make_prefill_fn(cfg, flags, ctx, max_len=shape.seq_len)

        def prefill(params, batch):
            return step(params, whole_tree(batch))
        return Lowered(prefill, (_materialise(p_shape, p_sh),
                                 _materialise(b_shape, b_sh)), None), \
            0, flags
    # decode
    p_shape, p_sh, c_shape, c_sh, t_shape, t_sh = steps_lib.decode_shardings(
        cfg, shape, mesh, ctx)
    step = make_decode_fn(cfg, flags, ctx, max_len=shape.seq_len)

    def decode(params, cache, tokens):
        logits, new = step(params, local_tree(cache), whole_tree(tokens))
        return logits, from_local_tree(new, c_sh, c_shape)
    return Lowered(decode, (_materialise(p_shape, p_sh),
                            _materialise(c_shape, c_sh),
                            _materialise(t_shape, t_sh)), 1), 0, flags


def _local_bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in hlo_profiler._leaf_tensors(tree))


def mem_fields(counter: hlo_profiler.ProgramCounter, lowered: Lowered,
               out, held_args: int) -> dict:
    """The reference's ``memory_analysis`` fields from the meta run:
    arguments (rank 0's local inputs), outputs, the donated argument
    (``alias``), and the peak of the live tensors less what the arguments
    hold (``temp``; both rounded to the allocator's 512-byte blocks)."""
    return {
        "argument_size_in_bytes": _local_bytes(lowered.args),
        "output_size_in_bytes": _local_bytes(out),
        "temp_size_in_bytes": counter.peak_bytes - held_args,
        # eager PyTorch generates no code for the program
        "generated_code_size_in_bytes": 0,
        "alias_size_in_bytes": (0 if lowered.donated is None else
                                _local_bytes(lowered.args[lowered.donated])),
        # the reference subtracts XLA-CPU's bf16 -> f32 operand buffers; a
        # meta run has no such buffers
        "cpu_f32_convert_artifact_bytes": 0,
    }


def measure_cell(cfg, shape, mesh, flags: RunFlags,
                 save_ops: Optional[Path] = None, *,
                 reuse_shapes: bool = True, peak_sites: bool = False) -> dict:
    """The record of one cell on ``mesh`` (unbound; its size is the fake
    group's), without the arch / tag fields, written nowhere.
    ``reuse_shapes=False`` runs every op's shape function (the reference
    the tests hold the reuse to; see ``ProgramCounter``); ``peak_sites``
    adds ``memory_analysis["peak_by_site"]``, the live bytes at the peak
    by where they were made."""
    world = mesh.size
    with fake_process_group(world):
        bound = mesh.bind("cpu")
        t0 = time.time()
        lowered, zero_level, flags = build_lowered(cfg, shape, bound,
                                                   make_ctx(bound), flags)
        t_lower = time.time() - t0
        counter = hlo_profiler.ProgramCounter(
            world, log_ops=save_ops is not None, reuse_shapes=reuse_shapes,
            peak_sites=peak_sites)
        held = counter.track(lowered.args)
        t0 = time.time()
        with counter:
            out = lowered.fn(*lowered.args)
        t_compile = time.time() - t0
        mem = mem_fields(counter, lowered, out, held)
        if peak_sites:
            mem["peak_by_site"] = dict(sorted(
                counter.peak_by_site.items(), key=lambda kv: -kv[1]))
        del out, lowered
    prof = counter.profile()
    mf = model_flops(cfg, shape, shape.kind) / world
    rl = hlo_profiler.roofline(prof, mf)
    if save_ops is not None:
        save_ops.write_text("".join(f"{op} {shapes} {fl:.0f} {tb:.0f}\n"
                                    for op, shapes, fl, tb in counter.ops))
    return {
        "kind": shape.kind,
        "mesh": "x".join(str(n) for n in mesh.shape), "world": world,
        "zero_level": zero_level, "flags": dataclasses.asdict(flags),
        "lower_s": round(t_lower, 2), "compile_s": round(t_compile, 2),
        "memory_analysis": mem,
        # PyTorch's own count (torch.utils.flop_counter) of the same ops,
        # beside the parsed one, as the reference keeps XLA's
        "cost_analysis_raw": {"flops": counter.flop_counter_flops},
        "profile": {
            "hlo_flops_per_dev": prof.flops,
            "hbm_traffic_bytes_per_dev": prof.traffic_bytes,
            "collective_bytes_per_dev": prof.collective_bytes,
            "dot_count": prof.dot_count,
            "collective_summary": {k: {"count": c, "bytes": b}
                                   for k, (c, b) in
                                   prof.collective_summary().items()},
            "custom_calls": dict(counter.custom_calls),
            "warnings": prof.warnings[:20],
        },
        "roofline": {
            "compute_s": rl.compute_s,
            "memory_s": rl.memory_s,
            "collective_s": rl.collective_s,
            "dominant": rl.dominant,
            "model_flops_per_dev": mf,
            "useful_ratio": rl.useful_ratio,
            "roofline_fraction": rl.roofline_fraction,
        },
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             flags: RunFlags, tag: str = "baseline",
             save_text: bool = False, peak_sites: bool = False) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    pods = "2pod" if multi_pod else "1pod"
    stem = f"{arch}__{shape_name}__{pods}__{tag}"
    ART_DIR.mkdir(parents=True, exist_ok=True)
    m = measure_cell(cfg, shape, mesh, flags,
                     save_ops=ART_DIR / f"{stem}.ops.txt" if save_text
                     else None, peak_sites=peak_sites)
    rec = {"arch": arch, "shape": shape_name, "kind": m.pop("kind"),
           "mesh": m.pop("mesh"), "world": m.pop("world"), "tag": tag, **m}
    (ART_DIR / f"{stem}.json").write_text(json.dumps(rec, indent=1))
    return rec


def plan_cells(arch: Optional[str] = None, shape: Optional[str] = None):
    """([(arch, shape)] to run, [(arch, shape, reason)] skipped): every
    arch and shape, or the one named."""
    cells, skipped = [], []
    for a in [arch] if arch else list(list_archs()):
        app = applicable_shapes(get_config(a))
        for s in [shape] if shape else list(SHAPES):
            if app[s] != "OK":
                skipped.append((a, s, app[s]))
            else:
                cells.append((a, s))
    return cells, skipped


def flags_from_args(args) -> RunFlags:
    return RunFlags(
        attn_impl="chunked",
        q_chunk=args.q_chunk, kv_chunk=args.kv_chunk,
        skip_masked_tiles=args.skip_tiles,
        microbatches=args.microbatches,
        remat=not args.no_remat,
        moe_mode=args.moe_mode,
        wkv_chunk=args.wkv_chunk,
        remat_policy=args.remat_policy,
        sequence_parallel=args.seq_parallel,
    )


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Multi-pod dry run (no "
                                 "device: a fake process group)")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--save-hlo", action="store_true",
                    help="also write the op stream (<cell>.ops.txt: one "
                    "line an op, with its shapes, FLOPs and bytes)")
    ap.add_argument("--peak-sites", action="store_true",
                    help="split the live bytes at the peak by where they "
                    "were made (memory_analysis.peak_by_site)")
    ap.add_argument("--q-chunk", type=int, default=512)
    ap.add_argument("--kv-chunk", type=int, default=512)
    ap.add_argument("--skip-tiles", action="store_true")
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--moe-mode", default="pjit")
    ap.add_argument("--wkv-chunk", type=int, default=16)
    ap.add_argument("--remat-policy", default="full")
    ap.add_argument("--seq-parallel", action="store_true")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    flags = flags_from_args(args)

    cells, skipped = plan_cells(args.arch, args.shape)
    for a, s, why in skipped:
        print(f"SKIP  {a:24s} {s:12s} {why}")

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    n_ok = n_fail = 0
    for a, s in cells:
        for mp in meshes:
            name = f"{a:24s} {s:12s} {'2x16x16' if mp else '16x16'}"
            try:
                rec = run_cell(a, s, mp, flags, tag=args.tag,
                               save_text=args.save_hlo,
                               peak_sites=args.peak_sites)
                rl = rec["roofline"]
                print(f"OK    {name} compile={rec['compile_s']:7.1f}s "
                      f"dom={rl['dominant']:10s} "
                      f"comp={rl['compute_s']:.3e}s mem={rl['memory_s']:.3e}s "
                      f"coll={rl['collective_s']:.3e}s "
                      f"useful={rl['useful_ratio']:.2f}", flush=True)
                n_ok += 1
            except Exception as e:
                print(f"FAIL  {name} {type(e).__name__}: {e}", flush=True)
                traceback.print_exc(limit=4)
                n_fail += 1
    print(f"\n{n_ok} OK, {n_fail} FAIL")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
