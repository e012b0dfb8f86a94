#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``src/repro_torch/kernels/csrc`` into
``build/`` (one ``nvcc`` per source, all started together), holds each
kernel against its plain PyTorch version and its ``ref.py`` oracle on the
card, and drives the port's paths:

  * co-verification — ``coverify()`` over the oracle / interpret / compiled
    backends for the systolic matmul and the flash-attention forward,
    through the congestion-arbitrated bridge (``compiled``: the oracle's
    maths through ``torch.compile``, built once before the timed
    iterations, its build seconds on a line of their own), then every
    committed golden trace and counter stream of the single-device, fuzz
    and fabric programs (``repro_torch/goldens.py``) regenerated byte for
    byte;
  * fuzzing — ``ProtocolFuzzer`` over 24 scenarios of its four layers
    (bridge: the three backends on the systolic matmul at 32-64 cubed;
    registers; serving and arrivals: llama3.2-1b at full width, bf16
    weights from a seed), a same-seed rerun, and the planted-bug table
    caught and shrunk to one op;
  * fabric — the row-sharded matmul (4096, tile 128) and head-sharded
    attention (H=32, S=2048, D=64) firmwares on 4 modeled devices of the
    one card: three backends EQUIVALENT, bit-identical to 1 device, a
    ring-routed rerun with the same result and another timing, a
    same-seed rerun with the same digest;
  * sweep — ``CoVerifySession`` with four worker threads on the one card:
    the fabric cells (the matmul at 2048) at 1, 2 and 4 modeled devices
    and a 4-device ring, three backends, a fault plan (24 cells;
    EQUIVALENT, the same modeled
    rows at 4 workers and at 1, 2/4-device results bit-identical to 1
    device), the Fig. 5 batched lane against sequential ``coverify()``
    calls, the matmul cells again at 512 with the data-movement profiler
    on (attribution closing exactly, every Perfetto file valid), and a
    planted bug localized by replay bisection to its launch;
  * replay — the 4096 matmul recorded and replayed from checkpoints to
    its own digests and final state, the replay benchmark's 200-launch
    workload on B1 (window replay against a full re-run, the late-bug
    shrink with and without prefix replay), and a full-width llama3.2-1b
    serving storm recorded and replayed;
  * profile — the golden programs' Perfetto files on the card equal to
    the CPU's byte for byte, the 4-device matmul cell's fabric profile
    per port and per ring leg, and the storm's serving profile;
  * campaign — a run-farm campaign (every golden trace, sweep units at
    4096 / 1024 / 64, the docs' register-protocol fuzz campaign, bridge
    fuzz units, open-loop serving units at 1 and 2 devices) in process,
    on a 2-worker spawned pool, on a pool whose worker is SIGKILL'd, and
    resumed from its store: the same digests, coverage and counters in
    every lane, the docs' digest reproduced, a planted bug shrunk to one
    launch;
  * drivers — the twins of the examples and benchmarks
    (``examples/*_torch.py``, ``benchmarks/*_torch.py``) in process on the
    card: seven docs transcripts line for line (replay's but for the two
    hashes of its float buffer), ResNet-18 co-verified through the matmul
    kernel with its modeled lines equal to a CPU run's, the 102M
    quickstart trained 100 steps with one restart from its step-50
    checkpoint, ``benchmarks/run_torch.py``'s figures (Fig. 5 from this
    run's own Fig. 5 readings), the fabric benchmark in full, the two
    ``--check`` lanes, and the wall gates' readings beside their gates
    (printed, not failing the run);
  * training — llama3.2-1b at full width (16 layers, seq 2048, batch 2,
    bf16 compute, ``attn_impl="pallas"``): one loss + backward with the
    kernels against the naive attention, then three ``Trainer`` steps with
    checkpointing, counting the attention kernels' launches; then
    rwkv6-7b (2 layers) and zamba2-2.7b (6 layers) at full width, one
    sequence of 1024 tokens: one loss + backward with the scans' kernels
    on the forward against the same with the scans through the twins of
    the reference's lax scans, and one timed ``make_train_step`` step;
    then moonshot-v1-16b-a3b (4 of 48 layers), llama-3.2-vision-11b (5 of
    40: four self layers, one cross layer over 1600 patches) and
    hubert-xlarge (48 layers, two sequences) at full width, 1536 tokens a
    sequence: one fp32 ``make_train_step`` step at smoke width with the
    family's own head dim (128 / 128 / 80) on the card against the CPU
    (moonshot's routing decisions compared), one bf16 loss + backward on
    the pallas route against the naive one (the vlm's gates nonzero, its
    patches at unit scale and every cross weight's gradient nonzero,
    moonshot's aux above zero), and
    one timed ``make_train_step`` step with B2 / B3 / B4 and AdamW split
    out (``train_families``);
  * serving — rwkv6-7b and zamba2-2.7b at full width and depth (bf16
    weights) through ``ServingEngine``: eight requests rung in through the
    CSR doorbell, prefill on the WKV-6 (rwkv6) and SSD + attention
    (zamba2) kernels, batched decode; each served prefill's scan inputs
    re-run through the plain versions layer by layer, the kernel route's
    logits against the plain route's, and prefill + decode against a full
    prefill at smoke size in fp32;
  * cluster — ``ClusterServingEngine``: llama3.2-1b at full width on two
    modeled devices behind one CSR front end, the same eight requests,
    twice: the same tokens and log digest, every attention launch of the
    second run held against its plain version (the cluster goldens are
    regenerated in ``golden``);
  * the moe, vlm and audio families — hubert-xlarge (48 layers) encoding
    two sequences of 1536 frames through ``make_prefill_fn``
    (bidirectional attention at head dim 80); llama-3.2-vision-11b (40
    layers, 8 of them gated cross attention over 1600 patch embeddings)
    and moonshot-v1-16b-a3b (48 layers, 64 experts, top-6) served at full
    width and depth like rwkv6 and zamba2; their route checks as
    serving's (the vlm's with random patches and nonzero gates; the moe's
    fp32 route cut in depth to what fits beside the bf16 weights, its
    routing decisions compared), and one moe prefill repeated bit for
    bit;
  * sharded — the multi-device layer (``launch/mesh.py``, ``ShardCtx``,
    ``sharding/{specs,ep,comm}.py``) on the one card: llama3.2-1b at full
    width trained three steps through ``Trainer(mesh, ctx)`` on a one-rank
    NCCL group (state placed by ``train_shardings(zero_level=1)``) against
    the unsharded ``Trainer``'s three steps (losses and grad norms, B2 /
    B3 / B4 launches, step times, one more step of each profiled);
    moonshot-v1-16b-a3b at full width served under
    ``moe_mode="ep_shardmap"`` through ``ServingEngine(ctx=...)`` with
    ``serve_moe``'s tokens and routing decisions (its decode steps timed,
    one profiled beside an engine without a context); then two spawned
    ranks sharing ``cuda:0`` over gloo (mesh data 1 x model 2): the
    expert-parallel moonshot layer and the pjit layer with its experts
    split (32 a rank) against the unsplit one, and the vocab-parallel
    embedding bit for bit; then two more spawned ranks serving
    llama3.2-1b at full width and depth through ``ServingEngine(ctx)``
    (``serve_moe``'s options and eight requests, ``attn_impl="pallas"``)
    on mesh (1, 2) (heads and cache positions split) and (2, 1) (rows
    split), each decode step fed the unsharded engine's tokens (teacher
    forcing): every logits row within ``LOGIT_TOL`` x max|logit| of the
    unsharded row of the same step, its argmax the unsharded token unless
    the unsharded top-2 logit gap is under ``TOKEN_GAP_TOL``, 16 x 8
    attention launches a rank on its local heads, every cache leaf at its
    ``cache_specs`` local shape after every tick, half the cache's bytes
    a rank; then the same two ranks, on mesh (1, 2), run rwkv6-7b and
    zamba2-2.7b at ``train_ssm``'s depths (full width) on each rank's
    heads: two fp32 train steps from the unsharded steps' state and
    batches (each step's loss and grad norm within ``SSM_TWO_RANK_RTOL``,
    each leaf's norm of both moments after the first step within
    ``SSM_LEAF_RTOL``, the same B5 / B6 / B2-B4 launches a rank as the
    unsharded steps), one 1536-token request served through
    ``ServingEngine(ctx)`` with 8 teacher-forced decode steps (logits
    within ``LOGIT_TOL``, the ``TOKEN_GAP_TOL`` tie rule), half the cache's
    and of the split weights' bytes a rank, and the weights' compute form
    no larger than the rank's stored shard;
  * dryrun — the dry run (``launch/dryrun.py``, ``core/hlo_profiler.py``)
    against the card: llama3.2-1b's train step at train_llama's batch with
    the dry run's flags (``chunked``, one microbatch, remat) counted by
    ``ProgramCounter`` on the card and on meta tensors (FLOPs, traffic and
    dot count must be equal), timed (median of 5) against its roofline
    bound at the card's peaks, and the meta run's peak memory against
    ``torch.cuda.max_memory_allocated`` (it may not fall below 0.9 of it);
    then two production-size cells of the dry run (llama3.2-1b /
    train_4k and rwkv6-7b / prefill_32k on the 16 x 16 mesh, 256 fake
    ranks), run on no card in two processes started at the top of the
    script, with their wall times, and ``benchmarks/roofline_torch.py``'s
    tables over their records.

Every line of standard output is one JSON object; the last line is
``{"ok": true, "device": {...}}``.  Any failure (no CUDA device, a build or
launch error, a tolerance miss, a non-EQUIVALENT report, a golden mismatch,
a failed fuzz scenario, an open protocol bin, a digest that does not repeat,
a sweep that fails or whose rows depend on its worker count, an
attribution that does not close, a replay that does not repeat its
recording, a non-finite loss, a wrong launch count, a ``torch.compile``
recompile limit hit, a routing decision of a train step that flips off
a tie, a dry-run count that is not the card's, a memory
estimate below 0.9 of the card's peak, a dry-run cell that fails) ends the
run with a non-zero exit code and no last line.
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np
import torch
import torch.nn.functional as F

from benchmarks.bench_debug_iteration_torch import (
    CASES as FIG5_CASES, SWEEP_SIZES as FIG5_SWEEP_SIZES)
from repro_torch import goldens
from repro_torch._device import true_fp32
from repro_torch._tree import leaves, paths, tree_map
from repro_torch.configs import ShapeConfig, get_config, smoke
from repro_torch.core import (FABRIC_LINK, CATEGORIES, CongestionConfig,
                              CoVerifySession, DataMovementProfiler,
                              FabricCluster, FaultPlan, FireBridge,
                              FuzzReport, ProtocolFuzzer, compare_outputs,
                              coverify, validate_trace)
from repro_torch.core import hlo_profiler as hp
from repro_torch.core import replay as replay_mod
from repro_torch.core.fuzz import (Scenario, _default_engine,
                                   planted_bug_table)
from repro_torch.data.synthetic import SyntheticLMDataset
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as FAK
from repro_torch.kernels.flash_attention import ref as FAref
from repro_torch.kernels.flash_attention.sweep import (_inputs as fa_inputs,
                                                       flash_backends,
                                                       flash_fabric_firmware,
                                                       flash_firmware)
from repro_torch.kernels.mamba2_scan import kernel as SSDK
from repro_torch.kernels.mamba2_scan import ops as ssd_ops
from repro_torch.kernels.mamba2_scan import ref as SSDref
from repro_torch.kernels.rwkv6_wkv import kernel as WKVK
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.kernels.rwkv6_wkv import ref as WKVref
from repro_torch.kernels.systolic_matmul import kernel as MMK
from repro_torch.kernels.systolic_matmul import ref as MMref
from repro_torch.kernels.systolic_matmul.sweep import (matmul_backends,
                                                       matmul_fabric_firmware,
                                                       matmul_firmware)
from repro_torch.launch import dryrun
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.steps import make_train_state, make_train_step
from repro_torch.models import moe as moe_lib
from repro_torch.models.inputs import make_train_batch
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import RunFlags, make_loss_fn
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runfarm import (CampaignManager, ResultStore, fuzz_units,
                                 golden_units, serving_units, sweep_units)
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.serving import Request, ServingEngine

# Published dense peaks of one H100 SXM (NVIDIA data sheet): the fp32 rate
# outside the tensor cores bounds a true-fp32 product; bf16 operands could
# go through the tensor cores, so they are held to that rate; fp32 matmul
# operands could go through them as TF32, so the function's 2MNK is held
# to the TF32 rate.
PEAK_FLOPS = {"float32": ("fp32_fma_67_TFLOPs", 67e12),
              "bfloat16": ("bf16_tensor_989_TFLOPs", hp.PEAK_FLOPS_BF16),
              "tf32": ("tf32_tensor_494.7_TFLOPs", 494.7e12)}
PEAK_BYTES = ("hbm_3.35_TBps", hp.HBM_BW)

CONG = dict(dos_prob=0.05, seed=7)
MM_MAIN_CFG = dict(size=4096, tile=128)          # coverify_matmul
FA_MAIN_CFG = dict(batch=1, heads=32, seq=2048, dim=64, bq=128, bk=128)
# this run's Fig. 5 readings (the five cases of coverify_matmul and the
# batched lane of sweep), which the drivers phase turns into the figure's
# rows instead of running them twice
FIG5_READINGS: dict = {}
GOLDEN = ROOT / "tests" / "golden"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        out.append(t0.elapsed_time(t1))
    return statistics.median(out)


def device_ms_by_kernel(fn, reps: int = 5) -> dict:
    """Device time (ms) of each CUDA kernel that one call of ``fn``
    launches, from ``torch.profiler`` over ``reps`` calls: how a wrapper
    that launches several kernels (a pre-pass, a three-launch scan) spends
    its time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    out = {}
    # a window now and then comes back without kernel records; try again
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if ev.device_time_total > 0:
                name = re.sub(r"\(anonymous namespace\)::|^void ", "",
                              ev.key)
                name = re.match(r"[\w:]+(<[^()]*>)?", name).group(0)
                out[name] = out.get(name, 0.0) + \
                    ev.device_time_total / reps / 1e3
        if out:
            break
    return out


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def bound(ops: float, nbytes: float, dtype: str) -> dict:
    pname, peak = PEAK_FLOPS[dtype]
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES[1] * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "peak": pname if t_ops >= t_bytes else PEAK_BYTES[0],
            "ops": ops, "bytes": nbytes}


# ------------------------------------------------------------------ phase 1
def phase_env() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"nvidia-smi unavailable (rc={smi.returncode})"
    try:
        ver = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        nvcc_ver = ver.splitlines()[-2] if ver else "unknown"
    except (OSError, RuntimeError) as e:
        nvcc_ver = f"not found ({e})"
    emit({"phase": "env", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc_ver,
          "python": sys.version.split()[0],
          "capability": list(torch.cuda.get_device_capability(0))})
    return card


# ------------------------------------------------------------------ phase 2
def ptxas_resources(log: str) -> dict:
    """Registers, stack, spills and wgmma-serialisation notes of each
    kernel in one ``nvcc -Xptxas -v`` log, by demangled name."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, {})
        elif fn and "spill stores" in line:
            n = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            out[fn].update(stack=n[0], spill_stores=n[1], spill_loads=n[2])
        elif fn and "registers" in line:
            out[fn]["registers"] = int(re.search(r"Used (\d+) registers",
                                                 line).group(1))
        m = re.search(r"\((C75\d\d)\).*function '(\w+)", line)
        if m:
            out.setdefault(m.group(2), {}).setdefault("notes", []).append(
                m.group(1))
    if out and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(out), text=True,
                               capture_output=True).stdout.splitlines()
        if len(names) == len(out):
            out = {n.replace("(anonymous namespace)::", "").split("(")[0]: v
                   for n, v in zip(names, out.values())}
    return out


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = _build.build_all()
    emit({"phase": "build", "built": sorted(libs),
          "seconds": time.perf_counter() - t0,
          "dir": str(_build.BUILD_DIR.relative_to(ROOT)),
          # the tensor-core bodies' resources, when built here
          "ptxas": {k: v for lib in ("flash_fwd", "flash_bwd",
                                     "systolic_matmul", "ssd_scan",
                                     "wkv_scan")
                    for k, v in ptxas_resources(
                        _build.logs.get(lib, "")).items()
                    if any(ns in k for ns in ("fwd90::", "fwd32::",
                                              "dkdv90::", "dq90::", "mm90::",
                                              "chunk_state", "state_pass",
                                              "chunk_out"))}})


# ------------------------------------------------------------------ phase 3
# (M, N, K, tile, dtype); the first three are the reference test rows, then
# the largest Fig. 5 case, the full-size main-path shape, a shape ragged for
# the fp32 body (K no multiple of 8, M and N no multiple of its C tile), and
# a longer K, where the tensor core's accumulation error shows most; then
# the fuzzer's bridge-layer launches (32, 48, 64 cubed at tile 16), one
# device's row shard of the 4-device matmul fabric cell, the Fig. 5
# batched lane's cells (64-160 cubed at tile 32), the
# run-farm campaign's 1024 sweep unit, one device's launch of the
# devices sweep's 1-, 2- and 4-device matmul cells (2048), and one
# device's launch of the 2-device matmul fabric cell.
MM_SHAPES = [
    (256, 128, 128, 64, torch.float32),
    (128, 256, 512, 64, torch.bfloat16),
    (128, 128, 128, 128, torch.float32),
    (800, 800, 800, 50, torch.float32),
    (4096, 4096, 4096, 128, torch.float32),
    (4096, 4096, 4096, 128, torch.bfloat16),
    (100, 300, 250, 50, torch.float32),
    (2048, 2048, 8192, 128, torch.float32),
    (32, 32, 32, 16, torch.float32),
    (48, 48, 48, 16, torch.float32),
    (64, 64, 64, 16, torch.float32),
    (1024, 4096, 4096, 128, torch.float32),
    (64, 64, 64, 32, torch.float32),
    (96, 96, 96, 32, torch.float32),
    (128, 128, 128, 32, torch.float32),
    (160, 160, 160, 32, torch.float32),
    (1024, 1024, 1024, 32, torch.float32),
    (2048, 2048, 2048, 128, torch.float32),
    (1024, 2048, 2048, 128, torch.float32),
    (512, 2048, 2048, 128, torch.float32),
    (2048, 4096, 4096, 128, torch.float32),
]
MM_MAIN = 4          # index of the shape coverify_matmul runs
MM_FUZZ = (8, 9, 10)  # the fuzzer's bridge-layer launches
MM_SHARD = 11        # one device's launch of the 4-device matmul fabric cell
MM_FIG5_SWEEP = (12, 13, 14, 15)   # the Fig. 5 batched lane's cells
# the campaign's 1024 sweep unit (a sweep unit's table passes tile 32 at
# every size; the kernel's own tiling ignores it, the plain version not)
MM_CAMPAIGN = 16
# one device's launch of the devices sweep's 1-, 2- and 4-device cells
MM_DEVICES_SWEEP = (17, 18, 19)
MM_SHARD2 = 20       # one device's launch of the 2-device matmul fabric cell
# the fp32 body keeps 3xTF32 only while every fp32 row is within half its
# gate (the rule that chose hi + lo for the attention backward)
SPLIT_RULE = 0.5

# (B, H, KH, S, D, causal, window, dtype, bq=bk[, Skv]); five reference
# test rows, three rows at the llama3.2-1b attention width, the main-path
# shape of coverify_flash (flash_firmware is MHA fp32), the shape
# train_llama gives the kernel (the models call it with bq=bk=512),
# zamba2's, then the bf16 tensor-core body at head dims 16 and 32 and at a
# length that is no multiple of its 128-row tiles; one device's launch of
# the 4-device and of the 2-device head-sharded attention fabric cells;
# last, the shapes the moe, vlm and audio paths give the kernel at their
# longest served prompt: moonshot-v1-16b-a3b's and the vlm's self
# attention (D=128, causal), the vlm's cross attention over its 1600
# patches (non-causal, Sq != Skv; blocks (512, 400): the models clamp
# each block to a divisor of its length) and hubert-xlarge's encoder
# (D=80, non-causal, two sequences); then llama3.2-1b's local heads on one
# rank of a model axis of two (16 of 32 query heads, 4 of 8 k / v heads:
# the sharded phase's two-rank serving).
FA_SHAPES = [
    (2, 4, 2, 128, 16, True, 0, torch.float32, 32),
    (1, 4, 4, 64, 32, False, 0, torch.float32, 32),
    (2, 8, 2, 128, 16, True, 48, torch.float32, 32),
    (2, 4, 1, 256, 64, True, 0, torch.bfloat16, 32),
    (1, 2, 2, 64, 128, True, 0, torch.bfloat16, 32),
    (1, 32, 8, 2048, 64, True, 0, torch.float32, 128),
    (1, 32, 8, 2048, 64, True, 0, torch.bfloat16, 128),
    (1, 32, 8, 2048, 64, True, 512, torch.bfloat16, 128),
    (1, 32, 32, 2048, 64, True, 0, torch.float32, 128),
    (2, 32, 8, 2048, 64, True, 0, torch.bfloat16, 512),
    (1, 32, 32, 2048, 80, True, 4096, torch.bfloat16, 512),
    (2, 4, 2, 128, 16, True, 0, torch.bfloat16, 32),
    (1, 4, 4, 64, 32, False, 0, torch.bfloat16, 32),
    (1, 8, 2, 200, 64, True, 0, torch.bfloat16, 40),
    (1, 8, 8, 2048, 64, True, 0, torch.float32, 128),
    (1, 16, 16, 2048, 64, True, 0, torch.float32, 128),
    (1, 16, 16, 1536, 128, True, 0, torch.bfloat16, 512),
    (1, 32, 8, 1536, 128, True, 0, torch.bfloat16, 512),
    (1, 32, 8, 1536, 128, False, 0, torch.bfloat16, (512, 400), 1600),
    (2, 16, 16, 1536, 80, False, 0, torch.bfloat16, 512),
    (1, 16, 4, 1536, 64, True, 0, torch.bfloat16, 512),
]
FA_MAIN = 8
FA_TRAIN = 9
FA_ZAMBA = 10        # zamba2-2.7b's shared attention: head dim 80, window
FA_SHARD = 14        # one device's launch of the 4-device fabric cell
FA_SHARD2 = 15       # one device's launch of the 2-device sweep cell
FA_MOE = 16          # moonshot-v1-16b-a3b's attention (serve_moe)
FA_VLM = 17          # llama-3.2-vision-11b's self attention (serve_vlm)
FA_CROSS = 18        # its cross attention over the patches (serve_vlm)
FA_AUDIO = 19        # hubert-xlarge's encoder (encode_audio)
FA_LOCAL = 20        # llama3.2-1b's heads on one of two model ranks (sharded)

# Backward: the reference's gradient rows (SWEEP[:3] of
# tests/test_kernels_flash.py), a GQA row with G=4 (a missing head sum shows
# there), the shape train_llama gives the kernels, zamba2's head dim in
# fp32; then the bf16 tensor-core bodies (dk/dv and dq) at the reference's
# rows, G=4, D=80 with a window, D=128 and a ragged length; last, the
# shapes training the moe, vlm and audio families gives them (phase
# train_families): moonshot-v1-16b-a3b's and the vlm's self attention
# (D=128, causal), the vlm's cross attention over its 1600 patches
# (non-causal, Sq != Skv, blocks (512, 400): 1600 is no multiple of dk/dv's
# 128-row kv tile) and hubert-xlarge's encoder (D=80, non-causal).  The
# shape tuples read as FA_SHAPES'.
BWD_SHAPES = [
    (2, 4, 2, 128, 16, True, 0, torch.float32, 32),
    (1, 4, 4, 64, 32, False, 0, torch.float32, 32),
    (2, 8, 2, 128, 16, True, 48, torch.float32, 32),
    (1, 8, 2, 256, 64, True, 0, torch.float32, 32),
    (2, 32, 8, 2048, 64, True, 0, torch.bfloat16, 512),
    (1, 32, 32, 1024, 80, True, 4096, torch.float32, 512),
    (2, 4, 2, 128, 16, True, 0, torch.bfloat16, 32),
    (1, 4, 4, 64, 32, False, 0, torch.bfloat16, 32),
    (2, 8, 2, 128, 16, True, 48, torch.bfloat16, 32),
    (1, 8, 2, 256, 64, True, 0, torch.bfloat16, 32),
    (1, 4, 2, 256, 80, True, 48, torch.bfloat16, 32),
    (1, 2, 1, 128, 128, True, 0, torch.bfloat16, 32),
    (1, 4, 1, 200, 32, True, 0, torch.bfloat16, 40),
    (1, 16, 16, 1536, 128, True, 0, torch.bfloat16, 512),
    (1, 32, 8, 1536, 128, True, 0, torch.bfloat16, 512),
    (1, 32, 8, 1536, 128, False, 0, torch.bfloat16, (512, 400), 1600),
    (2, 16, 16, 1536, 80, False, 0, torch.bfloat16, 512),
]
BWD_MAIN = 4
BWD_FAMILIES = (13, 14, 15, 16)   # moonshot, vlm self, vlm cross, hubert
# the reference's gradient tolerance, times max(1, max|plain|); kernel,
# plain version and autograd through the oracle take the same upcast inputs
BWD_TOL = 5e-4


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32``: half of the 13 dropped bits is
    added to the magnitude, then they are cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@true_fp32()
def matmul_tf32_terms(a: torch.Tensor, b: torch.Tensor,
                      terms: int) -> torch.Tensor:
    """fp32 (M,K) @ (K,N) from TF32 splits x = hi + lo, hi = tf32(x),
    lo = tf32(x - hi): ``terms`` = 1 is A_hi.B_hi (one TF32 product), 2 adds
    A_hi.B_lo, 3 adds A_lo.B_hi (the fp32 kernel's body).  Each product of
    two TF32 words is exact in fp32; the sums are fp32."""
    a, b = a.float(), b.float()
    ah, bh = tf32_round(a), tf32_round(b)
    out = ah @ bh
    if terms >= 2:
        out = out + ah @ tf32_round(b - bh)
    if terms >= 3:
        out = out + tf32_round(a - ah) @ bh
    return out


def check_matmul(shape) -> dict:
    M, N, K, tile, dt = shape
    rng = np.random.default_rng(M * 31 + N * 17 + K)
    a = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).cuda().to(dt)
    b = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32)).cuda().to(dt)
    kw = dict(bm=tile, bn=tile, bk=tile)
    got = MMK.matmul(a, b, **kw)
    torch.cuda.synchronize()
    plain = MMK.matmul_plain(a, b, **kw)
    ref = MMref.matmul_ref(a, b)
    torch.cuda.synchronize()
    tol = (1e-4 if dt == torch.float32 else 1.0) * max(
        1.0, float(ref.float().abs().max()))
    e_plain, e_ref = max_err(got, plain), max_err(got, ref)
    big = M * N * K >= 1 << 30
    reps = 5 if big else 20
    row = {"shape": [M, N, K], "tile": tile, "dtype": str(dt).split(".")[1],
           "max_abs_err": e_plain, "max_abs_err_ref": e_ref, "tol": tol,
           "err_over_tol": max(e_plain, e_ref) / tol,
           "kernel_ms": time_ms(lambda: MMK.matmul(a, b, **kw), reps),
           "plain_ms": time_ms(lambda: MMK.matmul_plain(a, b, **kw),
                               3 if big else reps),
           "library_ms": time_ms(lambda: torch.matmul(a, b), reps)}
    flops = 2.0 * M * N * K
    nbytes = (M * K + K * N + M * N) * a.element_size()
    if dt == torch.float32:
        # the function's 2MNK at the TF32 rate; beside it (informational)
        # the fp32 FMA bound and the bound of the three TF32 products that
        # the body runs
        row.update(bound(flops, nbytes, "tf32"))
        row["bound_ms_fma"] = bound(flops, nbytes, "float32")["bound_ms"]
        row["bound_ms_3xtf32"] = bound(3 * flops, nbytes, "tf32")["bound_ms"]
        # what one and two TF32 products would give (the same arithmetic
        # in plain ops), and the three-product model itself
        for name, terms in (("one_tf32", 1), ("two_tf32", 2),
                            ("three_tf32_model", 3)):
            row[f"{name}_err_over_tol"] = max_err(
                matmul_tf32_terms(a, b, terms), plain) / tol
        # the sign of the error against the result's (a truncating
        # accumulator shows as a negative bias growing with K)
        sign = torch.sign(plain.float())
        row["signed_rel_bias"] = float(
            ((got.float() - plain.float()) * sign).mean()) / float(
                plain.float().abs().mean())
        del sign
    else:
        row.update(bound(flops, nbytes, row["dtype"]))
    if not (got.shape == (M, N) and torch.isfinite(got.float()).all()):
        fail(f"systolic_matmul {row['shape']}: non-finite or misshapen output")
    if not (e_plain < tol and e_ref < tol):
        fail(f"systolic_matmul {row}: outside tolerance")
    if dt == torch.float32 and row["err_over_tol"] >= SPLIT_RULE:
        fail(f"systolic_matmul {row}: the 3xTF32 body misses half its gate")
    return row


def live_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """Unmasked (q, k) pairs of one head — the work this mask needs."""
    q = np.arange(Sq)[:, None]
    k = np.arange(Skv)[None, :]
    m = np.ones((Sq, Skv), bool)
    if causal:
        m &= k <= q
    if window:
        m &= k > q - window
    return int(m.sum())


def sdpa(q, k, v, causal: bool, window: int):
    """One library call for the same function (a yardstick, unused by the
    port).  Returns a zero-argument callable."""
    G = q.shape[1] // k.shape[1]
    S = q.shape[2]
    mask = None
    if window:
        pos = torch.arange(S, device=q.device)
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    kw = dict(attn_mask=mask, is_causal=bool(causal and mask is None))
    if G == 1:
        return lambda: F.scaled_dot_product_attention(q, k, v, **kw)
    try:
        F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
        return lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
    except (TypeError, RuntimeError):
        # this PyTorch has no grouped-query flag: repeat the kv heads once,
        # outside the timed call
        kr, vr = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
        return lambda: F.scaled_dot_product_attention(q, kr, vr, **kw)


@true_fp32()
def attention_one_tf32(q, k, v, causal: bool, window: int) -> torch.Tensor:
    """The forward with one TF32 rounding of q, k, p and v before their
    products (each product of two TF32 words exact in fp32, fp32 sums and
    softmax): what a tensor-core body without the hi + lo split computes."""
    B, H, S, D = q.shape
    KH = k.shape[1]
    G = H // KH
    qg = tf32_round(q).reshape(B, KH, G, S, D)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, tf32_round(k)) / D ** 0.5
    pos = torch.arange(S, device=q.device)
    m = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        m &= pos[None, :] <= pos[:, None]
    if window:
        m &= pos[None, :] > pos[:, None] - window
    s = torch.where(m, s, torch.full_like(s, -1e30))
    mx = s.amax(-1, keepdim=True)
    p = torch.where(m, torch.exp(s - mx), torch.zeros_like(s))
    del s
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bkgqs,bksd->bkgqd", tf32_round(p), tf32_round(v))
    return (o / l).reshape(B, H, S, D)


def attn_shape(shape) -> tuple:
    """A row of FA_SHAPES or BWD_SHAPES as (B, H, KH, S, Skv, D, causal,
    window, dtype, block, bq, bk)."""
    B, H, KH, S, D, causal, window, dt, blk = shape[:9]
    bq, bk = blk if isinstance(blk, tuple) else (blk, blk)
    return (B, H, KH, S, shape[9] if len(shape) > 9 else S, D, causal,
            window, dt, blk, bq, bk)


def check_flash(shape) -> dict:
    B, H, KH, S, Skv, D, causal, window, dt, blk, bq, bk = attn_shape(shape)
    rng = np.random.default_rng(B * 7919 + H * 101 + KH * 13 + S + D
                                + (Skv - S) * 7)
    mk = lambda h, n: torch.from_numpy(
        rng.normal(size=(B, h, n, D)).astype(np.float32)).cuda().to(dt)
    q, k, v = mk(H, S), mk(KH, Skv), mk(KH, Skv)
    kw = dict(causal=causal, window=window, bq=bq, bk=bk)
    out, lse = FAK.flash_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    p_out, p_lse = FAK.flash_fwd_plain(q, k, v, **kw)
    ref = FAref.attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    tol = 2e-5 if dt == torch.float32 else 3e-2
    e_plain, e_ref = max_err(out, p_out), max_err(out, ref)
    e_lse = max_err(lse, p_lse)
    big = S >= 1024
    reps = 5 if big else 20
    lib = sdpa(q, k, v, causal, window)
    row = {"shape": [B, H, KH, S, D] + ([Skv] if Skv != S else []),
           "causal": causal, "window": window,
           "block": blk, "dtype": str(dt).split(".")[1],
           "max_abs_err": e_plain, "max_abs_err_ref": e_ref,
           "lse_max_abs_err": e_lse, "tol": tol,
           "err_over_tol": max(e_plain, e_ref) / tol,
           "lse_err_over_tol": e_lse / (1e-4 * max(1.0, float(p_lse.abs().max()))),
           "kernel_ms": time_ms(lambda: FAK.flash_fwd(q, k, v, **kw), reps),
           "plain_ms": time_ms(lambda: FAK.flash_fwd_plain(q, k, v, **kw),
                               3 if big else reps),
           "library_ms": time_ms(lib, reps)}
    es = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * es + lse.numel() * 4
    flops = 4.0 * D * live_pairs(S, Skv, causal, window) * B * H
    if dt == torch.float32:
        # as for the fp32 matmul: the function's work at the TF32 rate
        # (the tensor-core body); beside it the fp32 FMA bound and the
        # bound of the three TF32 products the body runs
        row.update(bound(flops, nbytes, "tf32"))
        row["bound_ms_fma"] = bound(flops, nbytes, "float32")["bound_ms"]
        row["bound_ms_3xtf32"] = bound(3 * flops, nbytes, "tf32")["bound_ms"]
        # what one TF32 rounding of every operand would give, and the
        # kernel's signed bias relative to |out|
        one = attention_one_tf32(q, k, v, causal, window)
        row["one_rounding_err_over_tol"] = max_err(one, p_out) / tol
        del one
        sign = torch.sign(p_out)
        row["signed_rel_bias"] = float(((out - p_out) * sign).mean()) / float(
            p_out.abs().mean())
        del sign
        if big and D <= 80:
            # the split pre-pass and the product, each on its own
            row["device_ms_by_kernel"] = device_ms_by_kernel(
                lambda: FAK.flash_fwd(q, k, v, **kw))
    else:
        row.update(bound(flops, nbytes, row["dtype"]))
        # element-wise, in bf16 ulps (BF16_ULP), against both references
        tol_e = attn_out_tol(q, k, v, p_out, FAK.flash_fwd_plain, **kw)
        row["ulp_err_over_tol"] = max(
            over_tol((out.float() - p_out.float()).abs(), tol_e),
            over_tol((out.float() - ref.float()).abs(), tol_e))
        row["ulp_tol_over_median_plain"] = float(tol_e.median()) / float(
            p_out.float().abs().median())
        del tol_e
    if not (out.shape == q.shape and lse.shape == (B, H, S)
            and torch.isfinite(lse).all() and torch.isfinite(out.float()).all()):
        fail(f"flash_fwd {row['shape']}: non-finite or misshapen output")
    # lse is O(log S) in fp32 whatever the input type: held to 1e-4
    if not (e_plain < tol and e_ref < tol and e_lse < 1e-4 * max(
            1.0, float(p_lse.abs().max()))
            and row.get("ulp_err_over_tol", 0.0) < 1.0):
        fail(f"flash_fwd {row}: outside tolerance")
    if dt == torch.float32 and D <= 80 and row["err_over_tol"] >= SPLIT_RULE:
        fail(f"flash_fwd {row}: the 3xTF32 body misses half its gate")
    return row


def sdpa_backward(q, k, v, dout, causal: bool, window: int):
    """The backward of one ``scaled_dot_product_attention`` call (dq, dk and
    dv together) on the same inputs: a yardstick for B3 + B4, unused by the
    port.  Returns a zero-argument callable."""
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    out = sdpa(qq, kk, vv, causal, window)()
    return lambda: torch.autograd.grad(out, (qq, kk, vv), dout,
                                       retain_graph=True)


def one_rounding(name, q, k, v, dout, lse, delta, causal: bool,
                 window: int):
    """The kernel's gradients with p and ds (``flash_dkdv``) or ds alone
    (``flash_dq``) rounded once to bf16 before their products, fp32
    otherwise: what a tensor-core body with a single bf16 rounding would
    compute.  Its distance from the plain version, against the gate, is why
    the bf16 bodies carry them as bf16 hi + lo pairs."""
    B, H, Sq, D = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    G = H // KH
    scale = 1.0 / D ** 0.5
    qg = q.reshape(B, KH, G, Sq, D).float()
    dog = dout.reshape(B, KH, G, Sq, D).float()
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    m = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        m &= kpos <= qpos
    if window:
        m &= kpos > qpos - window
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    p = torch.exp(torch.where(m, s, torch.full_like(s, -1e30))
                  - lse.reshape(B, KH, G, Sq)[..., None])
    p = torch.where(m, p, torch.zeros_like(p))
    del s
    dp = torch.einsum("bkgqd,bksd->bkgqs", dog, v.float())
    ds = p * (dp - delta.reshape(B, KH, G, Sq)[..., None]) * scale
    del dp
    ds = ds.bfloat16().float()
    if name == "flash_dq":
        return (torch.einsum("bkgqs,bksd->bkgqd", ds, k.float())
                .reshape(B, H, Sq, D),)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p.bfloat16().float(), dog)
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qg)
    return dk, dv


def check_flash_bwd(shape):
    """B3 and B4 at one shape against their plain versions and against
    autograd through the oracle.  ``delta`` comes from the oracle's fp32
    output on the upcast inputs, which is what autograd sees."""
    B, H, KH, S, Skv, D, causal, window, dt, blk, bq, bk = attn_shape(shape)
    rng = np.random.default_rng(B * 7919 + H * 101 + KH * 13 + S + D + 1
                                + (Skv - S) * 7)
    mk = lambda h, n: torch.from_numpy(
        rng.normal(size=(B, h, n, D)).astype(np.float32)).cuda().to(dt)
    q, k, v, dout = mk(H, S), mk(KH, Skv), mk(KH, Skv), mk(H, S)
    kw = dict(causal=causal, window=window, bq=bq, bk=bk)
    _, lse = FAK.flash_fwd(q, k, v, **kw)
    qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
    o = FAref.attention_ref(qf, kf, vf, causal=causal, window=window)
    delta = (dout.float() * o.detach()).sum(-1)
    dk, dv = FAK.flash_dkdv(q, k, v, dout, lse, delta, **kw)
    dq = FAK.flash_dq(q, k, v, dout, lse, delta, **kw)
    torch.cuda.synchronize()
    p_dk, p_dv = FAK.flash_dkdv_plain(q, k, v, dout, lse, delta, **kw)
    p_dq = FAK.flash_dq_plain(q, k, v, dout, lse, delta, **kw)
    a_dq, a_dk, a_dv = torch.autograd.grad(o, (qf, kf, vf), dout.float())
    del o, qf, kf, vf
    big = S >= 1024
    reps = 5 if big else 20
    lib_ms = time_ms(sdpa_backward(q, k, v, dout, causal, window), reps)
    pairs = live_pairs(S, Skv, causal, window) * B * H
    es = q.element_size()
    in_bytes = (2 * q.numel() + 2 * k.numel()) * es + 2 * lse.numel() * 4
    base = {"shape": [B, H, KH, S, D] + ([Skv] if Skv != S else []),
            "causal": causal, "window": window,
            "block": blk, "dtype": str(dt).split(".")[1],
            "library_ms": lib_ms, "library": "sdpa backward (dq, dk, dv)"}
    rows = []
    for name, got, plain, auto, fn, pfn, flops, out_bytes in (
            ("flash_dkdv", (dk, dv), (p_dk, p_dv), (a_dk, a_dv),
             lambda: FAK.flash_dkdv(q, k, v, dout, lse, delta, **kw),
             lambda: FAK.flash_dkdv_plain(q, k, v, dout, lse, delta, **kw),
             8.0 * D * pairs, 2 * dk.numel() * 4),
            ("flash_dq", (dq,), (p_dq,), (a_dq,),
             lambda: FAK.flash_dq(q, k, v, dout, lse, delta, **kw),
             lambda: FAK.flash_dq_plain(q, k, v, dout, lse, delta, **kw),
             6.0 * D * pairs, dq.numel() * 4)):
        tol = BWD_TOL * max(1.0, max(float(t.abs().max()) for t in plain))
        row = dict(base, name=name, tol=tol,
                   max_abs_err=max(max_err(g, t) for g, t in zip(got, plain)),
                   max_abs_err_ref=max(max_err(g, t)
                                       for g, t in zip(got, auto)),
                   kernel_ms=time_ms(fn, reps),
                   plain_ms=time_ms(pfn, 3 if big else reps))
        row["err_over_tol"] = max(row["max_abs_err"],
                                  row["max_abs_err_ref"]) / tol
        if dt == torch.bfloat16:
            one = one_rounding(name, q, k, v, dout, lse, delta, causal,
                               window)
            row["one_rounding_err_over_tol"] = max(
                max_err(g, t) for g, t in zip(one, plain)) / tol
            del one
        row.update(bound(flops, in_bytes + out_bytes, row["dtype"]))
        if not all(torch.isfinite(g).all() for g in got):
            fail(f"{name} {row['shape']}: non-finite output")
        if not (row["max_abs_err"] < tol and row["max_abs_err_ref"] < tol):
            fail(f"{name} {row}: outside tolerance")
        rows.append(row)
    return rows


# Scans: the reference's two test rows each (tests/test_kernels_misc.py),
# then the shapes one served prefill gives the kernels: rwkv6-7b (H=64,
# K=64) and zamba2-2.7b (H=80, P=N=64, chunk 128; x in bf16 as served, and
# in fp32) at a 1536-token prompt; for rwkv6-7b also the shortest served
# prompt (256) and train_ssm's sequence (1024); then each model's heads on
# one of two model ranks (phase sharded: H = 32 of 64, 40 of 80).
WKV_SHAPES = [(2, 64, 4, 16), (1, 32, 8, 32), (1, 1536, 64, 64),  # B,L,H,K
              (1, 256, 64, 64), (1, 1024, 64, 64), (1, 1536, 32, 64)]
WKV_MAIN = 2
WKV_LOCAL = 5        # rwkv6-7b's heads on one of two model ranks (sharded)
SSD_SHAPES = [  # B, L, H, P, N, chunk, x/B/C dtype
    (2, 64, 8, 16, 8, 16, torch.float32),
    (1, 128, 4, 8, 16, 32, torch.float32),
    (1, 1536, 80, 64, 64, 128, torch.bfloat16),
    (1, 1536, 80, 64, 64, 128, torch.float32),
    (1, 1536, 40, 64, 64, 128, torch.bfloat16),
]
SSD_MAIN = 2
SSD_LOCAL = 4        # zamba2-2.7b's heads on one of two model ranks
# the reference's 1e-3, times max(1, max|plain|) as for the gradients
SCAN_TOL = 1e-3


def scan_tol(plain) -> float:
    return SCAN_TOL * max(1.0, max(float(t.abs().max()) for t in plain))


def check_wkv(shape) -> dict:
    B, L, H, K = shape
    rng = np.random.default_rng(B * 31 + L + H * 7 + K)
    g = lambda *sh: torch.from_numpy(
        rng.normal(size=sh).astype(np.float32)).cuda()
    r, k, v = g(B, L, H, K), g(B, L, H, K), g(B, L, H, K)
    w = torch.exp(-torch.exp(g(B, L, H, K)))
    u = g(H, K) * 0.5
    kw = dict(chunk=16, hb=min(8, H))
    got = WKVK.wkv_scan(r, k, v, w, u, **kw)
    torch.cuda.synchronize()
    plain = WKVK.wkv_scan_plain(r, k, v, w, u, **kw)
    oracle = WKVref.wkv_scan_ref(r, k, v, w, u)
    tol = scan_tol(plain)
    row = {"shape": [B, L, H, K], "dtype": "float32", "tol": tol,
           "kernel_chunk": WKVK.kernel_chunk(B, L, H, K),
           "max_abs_err": max(max_err(a, b) for a, b in zip(got, plain)),
           "max_abs_err_ref": max(max_err(a, b) for a, b in zip(got, oracle)),
           "kernel_ms": time_ms(lambda: WKVK.wkv_scan(r, k, v, w, u, **kw),
                                20),
           "plain_ms": time_ms(lambda: WKVK.wkv_scan_plain(r, k, v, w, u,
                                                           **kw), 3),
           "library_ms": None}
    # 4 FLOPs per (step, head, k, v): r.S, the bonus, w S + k v
    row.update(bound(4.0 * B * L * H * K * K,
                     (5 * B * L * H * K + H * K + B * H * K * K) * 4,
                     "float32"))
    row["err_over_tol"] = max(row["max_abs_err"], row["max_abs_err_ref"]) / tol
    # the (up to) three launches of one call, each on its own, and what the
    # call spends beside them on the host (checks, allocations, launches)
    row["device_ms_by_kernel"] = device_ms_by_kernel(
        lambda: WKVK.wkv_scan(r, k, v, w, u, **kw))
    dev = row["device_ms_by_kernel"]
    row["host_ms"] = row["kernel_ms"] - sum(dev.values()) if dev else None
    if not all(torch.isfinite(t).all() for t in got):
        fail(f"wkv_scan {shape}: non-finite output")
    if not (row["max_abs_err"] < tol and row["max_abs_err_ref"] < tol):
        fail(f"wkv_scan {row}: outside tolerance")
    return row


def ssd_flops(B, L, H, P, N, cl) -> float:
    """C B^T once per (batch, chunk) and, per head, the product of M with x,
    both on the causal triangle only (cl (cl + 1) / 2 live (i, j) pairs);
    per head also the incoming state's C state^T and the state update."""
    nc = B * (L // cl)
    tri = cl * (cl + 1.0)               # 2 FLOPs per live pair
    return nc * (tri * N + H * (tri * P + 4.0 * cl * P * N))


@true_fp32()
def ssd_one_bf16(x, dt, B_, C_, A, D, cl):
    """``ssd_scan_plain``'s arithmetic with each fp32 operand of a product
    (M, x w, the incoming state; x, B and C where they are fp32) rounded
    once to bf16: what the tensor-core body would compute without its
    hi + lo pairs."""
    r = lambda t: t.float().bfloat16().float()
    Bsz, L, H, P = x.shape
    N = B_.shape[-1]
    xf, Bf, Cf = r(x), r(B_), r(C_)
    state = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    y = torch.empty((Bsz, L, H, P), dtype=torch.float32, device=x.device)
    causal = torch.tril(torch.ones((cl, cl), dtype=torch.bool,
                                   device=x.device))[None, :, :, None]
    for c in range(L // cl):
        rows = slice(c * cl, (c + 1) * cl)
        xc, dtc, Bc, Cc = xf[:, rows], dt[:, rows], Bf[:, rows], Cf[:, rows]
        cum = torch.cumsum(dtc * A, dim=1)
        seg = cum[:, :, None, :] - cum[:, None, :, :]
        M = torch.einsum("bin,bjn->bij", Cc, Bc)[..., None] * torch.where(
            causal, torch.exp(torch.where(causal, seg, torch.zeros_like(seg))),
            torch.zeros_like(seg)) * dtc[:, None, :, :]
        y[:, rows] = (torch.einsum("bijh,bjhp->bihp", r(M), xc)
                      + torch.einsum("bin,bhpn->bihp", Cc, r(state))
                      * torch.exp(cum)[..., None]
                      + D[None, None, :, None] * x[:, rows].float())
        w = dtc * torch.exp(cum[:, -1:] - cum)
        state = (state * torch.exp(cum[:, -1])[..., None, None]
                 + torch.einsum("bjn,bjhp->bhpn", Bc, r(xc * w[..., None])))
    return y, state


def check_ssd(shape) -> dict:
    B, L, H, P, N, cl, dt_ = shape
    rng = np.random.default_rng(B * 13 + L + H * 5 + P + N)
    g = lambda *sh: torch.from_numpy(
        rng.normal(size=sh).astype(np.float32)).cuda()
    x, B_, C_ = g(B, L, H, P).to(dt_), g(B, L, N).to(dt_), g(B, L, N).to(dt_)
    dt = F.softplus(g(B, L, H))
    A = -torch.exp(g(H) * 0.5)
    D = torch.ones(H, device="cuda")
    kw = dict(chunk=cl, hb=min(8, H))
    got = SSDK.ssd_scan(x, dt, B_, C_, A, D, **kw)
    torch.cuda.synchronize()
    plain = SSDK.ssd_scan_plain(x, dt, B_, C_, A, D, **kw)
    oracle = SSDref.ssd_scan_ref(x, dt, B_, C_, A, D)
    tol = scan_tol(plain)
    es = x.element_size()
    row = {"shape": [B, L, H, P, N], "chunk": cl,
           "dtype": str(dt_).split(".")[1], "tol": tol,
           "max_abs_err": max(max_err(a, b) for a, b in zip(got, plain)),
           "max_abs_err_ref": max(max_err(a, b) for a, b in zip(got, oracle)),
           "kernel_ms": time_ms(lambda: SSDK.ssd_scan(x, dt, B_, C_, A, D,
                                                      **kw), 20),
           "plain_ms": time_ms(lambda: SSDK.ssd_scan_plain(x, dt, B_, C_, A,
                                                           D, **kw), 3),
           "library_ms": None,
           "smem_bytes": SSDK.smem_bytes(dt_ == torch.float32)}
    nbytes = (B * L * H * P * es + B * L * H * 4 + 2 * B * L * N * es + 2 * H * 4
              + B * L * H * P * 4 + B * H * P * N * 4)
    flops = ssd_flops(B, L, H, P, N, cl)
    # the body's products run on the tensor cores in bf16: the function's
    # work at that rate (or its bytes); the fp32 FMA bound beside it
    row.update(bound(flops, nbytes, "bfloat16"))
    row["bound_ms_fma"] = bound(flops, nbytes, "float32")["bound_ms"]
    row["err_over_tol"] = max(row["max_abs_err"], row["max_abs_err_ref"]) / tol
    # what one bf16 rounding of the fp32 operands (M, x w, the incoming
    # state; x, B and C too for fp32 inputs) would give
    one = ssd_one_bf16(x, dt, B_, C_, A, D, cl)
    row["one_rounding_err_over_tol"] = max(
        max_err(a, b) for a, b in zip(one, plain)) / tol
    del one
    if L >= 1024:
        # the three launches of one call, each on its own
        row["device_ms_by_kernel"] = device_ms_by_kernel(
            lambda: SSDK.ssd_scan(x, dt, B_, C_, A, D, **kw))
    if not all(torch.isfinite(t).all() for t in got):
        fail(f"ssd_scan {shape}: non-finite output")
    if not (row["max_abs_err"] < tol and row["max_abs_err_ref"] < tol):
        fail(f"ssd_scan {row}: outside tolerance")
    if row["err_over_tol"] >= SPLIT_RULE:
        fail(f"ssd_scan {row}: the hi + lo body misses half its gate")
    return row


def phase_kernels():
    mm_rows = [check_matmul(s) for s in MM_SHAPES]
    fa_rows = [check_flash(s) for s in FA_SHAPES]
    bwd = [check_flash_bwd(s) for s in BWD_SHAPES]
    dkdv_rows = [r[0] for r in bwd]
    dq_rows = [r[1] for r in bwd]
    wkv_rows = [check_wkv(s) for s in WKV_SHAPES]
    ssd_rows = [check_ssd(s) for s in SSD_SHAPES]
    emit({"phase": "kernel_checks", "systolic_matmul": mm_rows,
          "flash_fwd": fa_rows, "flash_dkdv": dkdv_rows, "flash_dq": dq_rows,
          "wkv_scan": wkv_rows, "ssd_scan": ssd_rows})
    return mm_rows, fa_rows, dkdv_rows, dq_rows, wkv_rows, ssd_rows


# -------------------------------------------------------------- phases 4, 5
def timed_ops(table: dict, spent: dict) -> dict:
    """The backend table with each callable's wall time (copies to the
    card and back included; ``.cpu()`` synchronises) added to ``spent``."""
    def wrap(name, fn):
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
            return out
        return run
    return {name: wrap(name, fn) for name, fn in table.items()}


def copy_seconds(arrays, out_shape) -> float:
    """Wall time of the pageable host->card copies of ``arrays`` plus the
    card->host copy of one fp32 result of ``out_shape``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev = [torch.from_numpy(x).cuda() for x in arrays]
    torch.cuda.synchronize()
    res = torch.empty(out_shape, dtype=torch.float32, device="cuda")
    res.cpu().numpy()
    dt = time.perf_counter() - t0
    del dev, res
    return dt


def run_coverify(name: str, firmware, op: str, table: dict, backends,
                 congestion: CongestionConfig, counter) -> dict:
    """One ``coverify()`` call with the kernel's launch count read around
    it and the per-backend bridges kept for their log digests."""
    bridges, spent = {}, {}

    launch_s = {}

    def fw(fb, be):
        bridges[be] = fb
        launch = fb.launch

        def timed_launch(*a, **k):
            t = time.perf_counter()
            launch(*a, **k)
            launch_s[be] = time.perf_counter() - t
        fb.launch = timed_launch
        firmware(fb, op, be)

    before = counter()
    t0 = time.perf_counter()
    res = coverify(fw, {op: timed_ops(table, spent)}, backends=backends,
                   tol=1e-3, congestion=congestion)
    wall = time.perf_counter() - t0
    digests = {be: fb.log.digest() for be, fb in bridges.items()}
    row = {"report": str(res.equivalence), "passed": res.passed,
           "violations": res.protocol_violations,
           "launches": counter() - before, "wall_s": wall,
           "iteration_s": res.iteration_seconds, "launch_s": launch_s,
           "backend_call_s": spent,
           "n_txs": bridges[backends[-1]].log.n_txs,
           "modeled_cycles": bridges[backends[-1]].mem.time,
           "log_digest": digests[backends[0]]}
    if not res.passed or res.protocol_violations:
        fail(f"{name}: {res.equivalence} violations={res.protocol_violations}")
    if row["launches"] != 1:
        fail(f"{name}: kernel launched {row['launches']} times, expected 1")
    if len(set(digests.values())) != 1:
        fail(f"{name}: transaction log differs across backends: {digests}")
    return row


def split_interpret(row: dict, kernel_s: float, copies_s: float) -> dict:
    """Where one interpret-backend iteration went: the firmware's own data
    preparation (seeded inputs, alloc, host_write), the modeled-time
    substrate inside ``launch`` (burst splitting, burst list, arbitration,
    counters, DDR copies — host numpy), the copies to the card and back,
    and the kernel.  Kernel and copy times are measured on their own."""
    call = row["backend_call_s"]["interpret"]
    return {"firmware_data_prep": row["iteration_s"]["interpret"]
            - row["launch_s"]["interpret"],
            "substrate_host": row["launch_s"]["interpret"] - call,
            "copies_h2d_d2h": copies_s, "kernel": kernel_s,
            "backend_call_other": max(0.0, call - kernel_s - copies_s)}


def build_compiled(name: str, table: dict, inputs) -> dict:
    """The ``compiled`` tier of a ``jit=True`` table on the card: a callable
    of its own, built (``torch.compile``) by one call on the firmware's
    inputs before ``coverify()``, so that no iteration pays the compile."""
    if table["compiled"] is table["oracle"]:
        fail(f"{name}: the compiled backend is the oracle callable")
    t0 = time.perf_counter()
    table["compiled"](*inputs)
    return {"compiled_is_oracle": False,
            "compiled_build_s": time.perf_counter() - t0}


def phase_coverify_matmul(card: str, mm_rows) -> int:
    MMK.launches = 0
    FAK.launches = 0
    size, tile = MM_MAIN_CFG["size"], MM_MAIN_CFG["tile"]
    rng = np.random.default_rng(size)
    ab = [rng.normal(size=(size, size)).astype(np.float32) for _ in range(2)]
    table = matmul_backends(tile=tile, device="cuda", jit=True)
    tier = build_compiled("coverify_matmul", table, ab)
    emit({"phase": "coverify_matmul_compiled_tier", "card": card, **tier})
    row = run_coverify(
        "coverify_matmul",
        lambda fb, op, be: matmul_firmware(fb, op, be, size=size, tile=tile),
        "mm", table, ("oracle", "interpret", "compiled"),
        CongestionConfig(**CONG), lambda: MMK.launches)
    row.update(tier)
    copies = copy_seconds(ab, (size, size))
    kern = mm_rows[MM_MAIN]["kernel_ms"] / 1e3
    row["split_interpret_s"] = split_interpret(row, kern, copies)
    emit({"phase": "coverify_matmul", "card": card, "size": size,
          "tile": tile, **row})

    fig5 = []
    for pes, sz in FIG5_CASES:
        t = max(8, int(np.sqrt(pes)))
        r = run_coverify(
            f"fig5[{pes}]",
            lambda fb, op, be: matmul_firmware(fb, op, be, size=sz, tile=t),
            "mm", matmul_backends(tile=t, device="cuda"),
            ("oracle", "interpret"), CongestionConfig(dos_prob=0.05, seed=pes),
            lambda: MMK.launches)
        fig5.append({"pes": pes, "size": sz, "tile": t, "wall_s": r["wall_s"],
                     "iteration_s": r["iteration_s"], "n_txs": r["n_txs"],
                     "report": r["report"]})
    emit({"phase": "fig5_debug_iteration", "card": card, "cases": fig5})
    FIG5_READINGS["cases"] = fig5
    return MMK.launches


def phase_coverify_flash(card: str, fa_rows) -> int:
    FAK.launches = 0
    cfg = FA_MAIN_CFG
    qkv = fa_inputs(cfg["batch"], cfg["heads"], cfg["seq"], cfg["dim"])
    table = flash_backends(bq=cfg["bq"], bk=cfg["bk"], causal=True,
                           device="cuda", jit=True)
    tier = build_compiled("coverify_flash", table, qkv)
    emit({"phase": "coverify_flash_compiled_tier", "card": card, **tier})
    row = run_coverify(
        "coverify_flash",
        lambda fb, op, be: flash_firmware(fb, op, be, **cfg),
        "fa", table, ("oracle", "interpret", "compiled"),
        CongestionConfig(**CONG), lambda: FAK.launches)
    row.update(tier)
    copies = copy_seconds(list(qkv), qkv[0].shape)
    kern = fa_rows[FA_MAIN]["kernel_ms"] / 1e3
    row["split_interpret_s"] = split_interpret(row, kern, copies)
    emit({"phase": "coverify_flash", "card": card, **cfg, **row})
    return FAK.launches


# ------------------------------------------------------------------ phase 6
def phase_golden() -> None:
    """Every committed golden file the port's programs produce
    (``repro_torch/goldens.py``), regenerated on the card byte for byte."""
    out = {"phase": "golden"}
    for name, program in goldens.PROGRAMS.items():
        target = program("cuda")
        files = [("trace", goldens.trace_lines(target))]
        if name in goldens.COUNTER_TRACES:
            files.append(("counters", goldens.counter_lines(target)))
        for kind, live in files:
            path = GOLDEN / f"{name}.{kind}"
            want = path.read_text().splitlines()
            if live != want:
                first = next((i for i, (x, y) in enumerate(zip(live, want))
                              if x != y), min(len(live), len(want)))
                fail(f"golden {name}.{kind}: first divergent line "
                     f"{first + 1} (live {len(live)} lines, golden "
                     f"{len(want)})")
            sha = hashlib.sha256(("\n".join(live) + "\n").encode()
                                 ).hexdigest()
            if sha != hashlib.sha256(path.read_bytes()).hexdigest():
                fail(f"golden {name}.{kind}: lines equal but bytes differ")
            out[f"{name}.{kind}"] = {"sha256": sha, "lines": len(live)}
    emit(out)


# ------------------------------------------------------------ phases 6b, 6c
FUZZ_LAYERS = ("bridge", "registers", "serving", "arrivals")
FUZZ_SCENARIOS = 24
FABRIC_CELLS = {
    "matmul": dict(size=4096, tile=128),
    "flash": dict(batch=1, heads=32, seq=2048, dim=64, bq=128, bk=128),
}
FABRIC_DEVICES = 4
FABRIC_DOS = dataclasses.replace(FABRIC_LINK, dos_prob=0.05, seed=11)


def compiled_graphs() -> int:
    """Graphs ``torch.compile`` has built in this process so far."""
    from torch._dynamo.utils import counters
    return int(counters["stats"]["unique_graphs"])


def fuzz_layer_rows(results, wall: dict) -> dict:
    rows = {}
    for layer in FUZZ_LAYERS:
        mine = [r for r in results if r.layer == layer]
        faults: dict = {}
        for r in mine:
            for ev in r.faults:
                faults[ev.kind] = faults.get(ev.kind, 0) + 1
        rows[layer] = {"scenarios": len(mine), "wall_s": wall.get(layer, 0.0),
                       "faults": faults,
                       "transactions": sum(r.n_txs for r in mine)}
    return rows


def phase_fuzz(card: str) -> int:
    """``ProtocolFuzzer`` over all four layers on the card: the bridge
    layer's three backends (``interpret`` = B1 at 32-64 cubed, tile 16;
    ``compiled`` = ``torch.compile``), the serving and arrivals layers on
    llama3.2-1b at full width (16 layers, bf16 weights from a seeded
    generator, ``_default_engine``'s geometry).  Returns B1's launches in
    the main run."""
    t_phase = time.perf_counter()
    graphs0 = compiled_graphs()
    t0 = time.perf_counter()
    engine = _default_engine(device="cuda", cfg=get_config("llama3.2-1b"))
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    factory = lambda: engine                                  # noqa: E731
    fz = ProtocolFuzzer(seed=0, layers=FUZZ_LAYERS, engine_factory=factory,
                        device="cuda")
    table = fz._matmul_table()
    if table["compiled"] is table["oracle"]:
        fail("fuzz: the compiled backend is the oracle callable")
    compile_s = {}
    for size in fz.SIZES:                 # built before the timed run
        rng = np.random.default_rng(size)
        ab = [rng.normal(size=(size, size)).astype(np.float32)
              for _ in range(2)]
        t = time.perf_counter()
        table["compiled"](*ab)
        compile_s[str(size)] = time.perf_counter() - t
    emit({"phase": "fuzz_compiled_tier", "card": card,
          "compile_s": compile_s, "compiled_graphs": compiled_graphs()
          - graphs0})

    MMK.launches = 0
    wall: dict = {}
    results = []
    t0 = time.perf_counter()
    for i in range(FUZZ_SCENARIOS):
        scn = fz.scenario(i)
        t = time.perf_counter()
        results.append(fz.run_scenario(scn))
        wall[scn.layer] = wall.get(scn.layer, 0.0) + time.perf_counter() - t
    run_s = time.perf_counter() - t0
    launches = MMK.launches
    report = FuzzReport(fz.seed, results, coverage=fz.coverage)
    summary = report.summary()

    t = time.perf_counter()
    rerun = ProtocolFuzzer(seed=0, layers=FUZZ_LAYERS, engine_factory=factory,
                           mm_table=table, device="cuda").run(FUZZ_SCENARIOS)
    rerun_s = time.perf_counter() - t

    MMK.launches = 0
    t = time.perf_counter()
    bug = ProtocolFuzzer(seed=0, layers=("bridge",), device="cuda",
                         mm_table=planted_bug_table(device="cuda"))
    bug_report = bug.run(3)
    caught = bug_report.failures()
    shrunk = None
    if caught:
        scn = bug.scenario(caught[0].index)
        sub, res = bug.shrink(scn, use_replay=False)
        shrunk = {"scenario": scn.index, "ops": len(scn.ops),
                  "shrunk_ops": len(sub.ops), "still_fails": not res.ok,
                  "prefix": sub.ops == scn.ops[:len(sub.ops)],
                  "divergence": any("divergence" in f
                                    for f in caught[0].failures)}
    bug_s = time.perf_counter() - t
    bug_launches = MMK.launches

    row = {"phase": "fuzz", "card": card, "seed": fz.seed,
           "scenarios": FUZZ_SCENARIOS, "engine": "llama3.2-1b",
           "engine_build_s": engine_s, "run_s": run_s,
           "layers": fuzz_layer_rows(results, wall),
           "passed": report.passed, "digest": report.digest,
           "rerun_digest": rerun.digest, "rerun_s": rerun_s,
           "protocol_percent": report.coverage.percent("protocol"),
           "coverage": summary["coverage"],
           "violations_audited": summary["violations_audited"],
           "b1_launches": launches, "planted_bug": shrunk,
           "planted_bug_s": bug_s, "planted_bug_b1_launches": bug_launches,
           "compiled_graphs": compiled_graphs() - graphs0,
           "phase_s": time.perf_counter() - t_phase}
    emit(row)
    if not report.passed:
        fail(f"fuzz: scenarios failed: {summary['failures']}")
    if report.coverage.percent("protocol") != 100.0:
        fail(f"fuzz: protocol bins not closed: "
             f"{report.coverage.holes('protocol')}")
    if rerun.digest != report.digest:
        fail("fuzz: a same-seed rerun gave another digest")
    if not (shrunk and shrunk["divergence"] and shrunk["still_fails"]
            and shrunk["prefix"] and shrunk["shrunk_ops"] == 1):
        fail(f"fuzz: planted bug not caught and shrunk to 1 op: {shrunk}")
    if launches < 1:
        fail("fuzz: the bridge layer never launched B1")
    del engine, fz, rerun, bug
    gc.collect()                      # the engine's cycles hold its weights
    torch.cuda.empty_cache()
    return launches


def fabric_run(cell: str, table: dict, n: int, backend: str,
               topology=None) -> dict:
    """One sharded launch of a fabric cell on ``n`` modeled devices."""
    fab = FabricCluster(n, congestion=CongestionConfig(**CONG),
                        link_config=FABRIC_DOS, topology=topology)
    fab.register_op("op", **table)
    firmware = (matmul_fabric_firmware if cell == "matmul"
                else flash_fabric_firmware)
    mm0, fa0, graphs0 = MMK.launches, FAK.launches, compiled_graphs()
    t = time.perf_counter()
    firmware(fab, "op", backend, **FABRIC_CELLS[cell])
    wall = time.perf_counter() - t
    return {"outputs": fab.outputs(), "digest": fab.digest(),
            "time": fab.time, "wall_s": wall,
            "link_stall": fab.total_link_stall(),
            "transactions": fab.log.n_txs + sum(d.log.n_txs
                                                for d in fab.devices),
            "b1_launches": MMK.launches - mm0,
            "b2_launches": FAK.launches - fa0,
            "compiled_graphs": compiled_graphs() - graphs0}


def phase_fabric(card: str) -> dict:
    """The two fabric firmwares at full size on 4 modeled devices, all
    modeled on this one card: the three backends EQUIVALENT; the 4-device
    ``interpret`` result bit-identical to the 1- and the 2-device one; a
    ring-routed
    rerun with the same host result and another fabric timing; a
    same-seed rerun with the same digest.  Returns each kernel's launches
    in the phase."""
    t_phase = time.perf_counter()
    graphs0 = compiled_graphs()
    MMK.launches = 0
    FAK.launches = 0
    out = {"phase": "fabric", "card": card, "devices": FABRIC_DEVICES}
    for cell, cfg in FABRIC_CELLS.items():
        if cell == "matmul":
            table = matmul_backends(tile=cfg["tile"], device="cuda")
            rng = np.random.default_rng(cfg["size"])
            a = rng.normal(size=(cfg["size"], cfg["size"])).astype(np.float32)
            shard = (a[:cfg["size"] // FABRIC_DEVICES], a)
            oname = "c"
        else:
            table = flash_backends(bq=cfg["bq"], bk=cfg["bk"], causal=True,
                                   device="cuda")
            qkv = fa_inputs(cfg["batch"], cfg["heads"], cfg["seq"],
                            cfg["dim"])
            h = cfg["heads"] // FABRIC_DEVICES
            # a fresh C-ordered copy: numpy counts the B=1 slice as
            # contiguous and keeps its parent's batch stride, which the
            # compiled tier's guards would tell from a device buffer's
            shard = tuple(x[:, :h].copy() for x in qkv)
            oname = "o"
        t = time.perf_counter()
        table["compiled"](*shard)          # built before the timed runs
        build_s = time.perf_counter() - t
        t = time.perf_counter()
        table["compiled"](*shard)
        warm_s = time.perf_counter() - t
        runs = {be: fabric_run(cell, table, FABRIC_DEVICES, be)
                for be in ("oracle", "interpret", "compiled")}
        one = fabric_run(cell, table, 1, "interpret")
        two = fabric_run(cell, table, 2, "interpret")
        ring = fabric_run(cell, table, FABRIC_DEVICES, "interpret",
                          topology="ring")
        again = fabric_run(cell, table, FABRIC_DEVICES, "interpret")
        eq = compare_outputs({be: r["outputs"] for be, r in runs.items()},
                             tol=1e-3)
        got = runs["interpret"]["outputs"][oname]
        checks = {
            "equivalence": str(eq), "passed": eq.passed,
            "bit_identical_to_1dev": bool(np.array_equal(
                got, one["outputs"][oname])),
            "bit_identical_to_2dev": bool(np.array_equal(
                got, two["outputs"][oname])),
            "ring_same_result": bool(np.array_equal(
                got, ring["outputs"][oname])),
            "ring_other_timing": ring["time"] != runs["interpret"]["time"],
            "rerun_same_digest": again["digest"] == runs["interpret"]["digest"],
        }
        out[cell] = {
            **FABRIC_CELLS[cell], **checks, "compiled_build_s": build_s,
            "compiled_warm_call_s": warm_s,
            "cells": {name: {k: r[k] for k in ("wall_s", "link_stall",
                                               "transactions", "time",
                                               "b1_launches", "b2_launches",
                                               "compiled_graphs")}
                      for name, r in [*((f"{be}@{FABRIC_DEVICES}dev", r)
                                        for be, r in runs.items()),
                                      ("interpret@1dev", one),
                                      ("interpret@2dev", two),
                                      (f"interpret@{FABRIC_DEVICES}dev_ring",
                                       ring),
                                      (f"interpret@{FABRIC_DEVICES}dev_rerun",
                                       again)]},
            "digest": runs["interpret"]["digest"][:16]}
        if not all(v for k, v in checks.items() if k != "equivalence"):
            emit(out)
            fail(f"fabric {cell}: {checks}")
        del runs, one, two, ring, again
    launches = {"systolic_matmul": MMK.launches, "flash_fwd": FAK.launches}
    out["launches"] = launches
    out["compiled_graphs"] = compiled_graphs() - graphs0
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    if min(launches.values()) < 1:
        fail(f"fabric: a kernel was never launched: {launches}")
    gc.collect()                      # clusters' cycles hold GBs of buffers
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------- phases 6d, 6e, 6f
SWEEP_CELLS = {"mm": dict(size=4096, tile=128),
               "fa": dict(batch=1, heads=32, seq=2048, dim=64, bq=128,
                          bk=128)}
SWEEP_BACKENDS = ("oracle", "interpret", "compiled")
SWEEP_DEVICES = (1, 2, 4)
SWEEP_WORKERS = 4
REPLAY_OPS, REPLAY_INSPECT, REPLAY_EVERY = 200, 150, 8
SHRINK_OPS = 24
TRACE_DIR = ROOT / "build" / "sweep_traces"
# the profiled matmul cells' Perfetto files are written and validated at
# this size: the export holds a counter sample every 256 modeled cycles
# (most of a ring cell's events) and a slice a burst, so a ring cell's
# file grows with the modeled horizon, 4x a doubling of the size from 512
# to 1024 (66 -> 270 MB), and at 4096 would be GBs.  512: at 1024 the 12
# files took 117 s to write and read back on a slow machine (three 270 MB
# ring files), time the sharded phase's two-rank serving needs
TRACE_CELLS = {"mm": dict(size=512, tile=128)}
# the devices sweep (phase sweep (a)) runs its matmul cells at 2048: at
# 4096 its two passes took 320.6 s of a 1208.9 s script, over the 1200 s
# limit, on an NVIDIA H100 80GB HBM3 (700 W) whose host ran every phase
# 1.3-1.5x slower than most.  Both passes at 4096 would still read about
# 1177 s on that host with the split ssm run in the llama ranks' spawn,
# and only the 1-worker pass at 2048 (rows compared at 2048, a third pass)
# about 1140 s: neither leaves room for a slower host; at 2048 about 960.
# The 4096 matmul stays at 1, 2 and 4 devices in the fabric phase (bit
# for bit across them) and in phase 3's rows; the planted bug (d) and the
# replay and profile phases keep SWEEP_CELLS' 4096
DEVICES_SWEEP_CELLS = {"mm": dict(size=2048, tile=128),
                       "fa": SWEEP_CELLS["fa"]}


def sweep_firmware(fb, op, backend, **cfg):
    (matmul_firmware if op == "mm" else flash_firmware)(fb, op, backend,
                                                        **cfg)


def sweep_fabric_firmware(fab, op, backend, **cfg):
    (matmul_fabric_firmware if op == "mm" else flash_fabric_firmware)(
        fab, op, backend, **cfg)


def sweep_session(tables: dict, ops=("mm", "fa"), profile: bool = False,
                  cells: dict = SWEEP_CELLS) -> CoVerifySession:
    """``examples/cluster_coverify.py``'s devices sweep at the ``fabric``
    phase's sizes: each op on the three backends at 1, 2 and 4 devices on
    the crossbar (``add_sweep``), plus a 4-device ring cell a backend, all
    under ``FaultPlan(0)``."""
    sess = CoVerifySession(sweep_firmware,
                           fabric_firmware=sweep_fabric_firmware,
                           congestion=CongestionConfig(**CONG),
                           link_config=FABRIC_DOS, fault_plan=FaultPlan(0),
                           profile=profile)
    for op in ops:
        sess.register_op(op, **tables[op])
        sess.add_sweep(op, SWEEP_BACKENDS, [cells[op]],
                       devices=SWEEP_DEVICES)
        for be in SWEEP_BACKENDS:
            sess.add_cell(op, be, cells[op], devices=4, topology="ring")
    return sess


def build_sweep_tier(tables: dict, cells: dict = SWEEP_CELLS) -> dict:
    """The ``compiled`` tier of the sweep tables built for every shape a
    device of a 1-, 2- or 4-device cell gives it, before any timed run (a
    fresh C-ordered shard each, as a device buffer is)."""
    out = {}
    for op, cfg in cells.items():
        if op == "mm":
            rng = np.random.default_rng(cfg["size"])
            a, b = (rng.normal(size=(cfg["size"], cfg["size"]))
                    .astype(np.float32) for _ in range(2))
            shard = lambda n: (a[:cfg["size"] // n].copy(), b)  # noqa: E731
        else:
            qkv = fa_inputs(cfg["batch"], cfg["heads"], cfg["seq"],
                            cfg["dim"])
            shard = lambda n: tuple(x[:, :cfg["heads"] // n].copy()  # noqa
                                    for x in qkv)
        for n in SWEEP_DEVICES:
            t = time.perf_counter()
            tables[op]["compiled"](*shard(n))
            out[f"{op}{cfg.get('size', '')}@{n}dev"] = \
                time.perf_counter() - t
    return out


def without_profile_columns(rows):
    """``to_rows`` lines without the utilization column (index 7) and the
    stall-category columns after it."""
    def cut(parts):
        return parts[:7] + parts[8 + len(CATEGORIES):]
    return [",".join(cut(r.split(","))) for r in rows]


def closes(prof) -> bool:
    """Every channel's categories, folded left in taxonomy order (the sum
    the profiler closes; Python's ``sum`` of floats is compensated), add
    up bit-exactly to its horizon."""
    def fold(cycles):
        s = 0.0
        for c in CATEGORIES:
            s += cycles[c]
        return s
    return all(fold(ch.breakdown.cycles) == ch.horizon
               for ch in prof.channels)


def phase_sweep(card: str) -> dict:
    """``CoVerifySession`` on the card: (a) the 24-cell devices sweep
    (``DEVICES_SWEEP_CELLS``) at 4 workers with ``profile=True``, then at 1
    without (both pass;
    the rows, the profile columns left out, byte-identical; 2/4-device
    ``interpret`` bit-identical to 1 device; no counter mismatch; every
    profiled cell's attribution closes); (b) the Fig. 5 batched lane
    against the sequential ``coverify()`` lane; (c) (a)'s matmul cells at
    ``TRACE_CELLS``' size, every ``save_traces`` file valid; (d) the
    planted bug at 4096 localized to a ``launch`` op.  Returns each
    kernel's launches in the phase."""
    t_phase = time.perf_counter()
    graphs0 = compiled_graphs()
    tables = {"mm": matmul_backends(tile=SWEEP_CELLS["mm"]["tile"],
                                    device="cuda"),
              "fa": flash_backends(bq=SWEEP_CELLS["fa"]["bq"],
                                   bk=SWEEP_CELLS["fa"]["bk"], causal=True,
                                   device="cuda")}
    tier_s = build_sweep_tier(tables, DEVICES_SWEEP_CELLS)
    MMK.launches = 0
    FAK.launches = 0
    out = {"phase": "sweep", "card": card, "compiled_build_s": tier_s}

    # (a) the devices sweep, 4 workers profiled, then 1 unprofiled: one
    # comparison of rows holds both the worker count and the profiler to
    # the same modeled quantities
    runs = {}
    for workers in (SWEEP_WORKERS, 1):
        sess = sweep_session(tables, profile=workers > 1,
                             cells=DEVICES_SWEEP_CELLS)
        mm0, fa0 = MMK.launches, FAK.launches
        t = time.perf_counter()
        rep = sess.run(max_workers=workers)
        runs[workers] = {"report": rep, "wall_s": time.perf_counter() - t,
                         "b1_launches": MMK.launches - mm0,
                         "b2_launches": FAK.launches - fa0}
    rep4, rep1 = runs[SWEEP_WORKERS]["report"], runs[1]["report"]
    bit_identical = {}
    for op, oname in (("mm", "c"), ("fa", "o")):
        by = {r.cell.group_member: r.outputs[oname] for r in rep4.cells
              if r.cell.op == op}
        for member, arr in by.items():
            if member.startswith("interpret@"):
                bit_identical[f"{op}/{member}"] = bool(
                    np.array_equal(arr, by["interpret"]))
    rows = rep4.to_rows(wall=False)
    checks = {"passed_4_workers": rep4.passed, "passed_1_worker": rep1.passed,
              "rows_identical": without_profile_columns(rows)
              == without_profile_columns(rep1.to_rows(wall=False)),
              "bit_identical_to_1dev": all(bit_identical.values()),
              "no_counter_mismatch": not (rep4.counter_mismatches
                                          or rep1.counter_mismatches),
              "closes": all(closes(r.profile) for r in rep4.cells)}
    out["devices_sweep"] = {
        "cells": len(rep4.cells), "workers": SWEEP_WORKERS,
        "profiled": f"{SWEEP_WORKERS} workers", **checks,
        "channels": sum(len(r.profile.channels) for r in rep4.cells),
        "bit_identical": bit_identical,
        "equivalence": {g: str(e) for g, e in rep4.equivalence.items()},
        "rows_4_workers": rep4.to_rows(), "scaling_1_worker": rep1.scaling(),
        **{f"wall_s_{w}_worker{'s' if w > 1 else ''}": r["wall_s"]
           for w, r in runs.items()},
        **{f"{k}_{w}": r[k] for w, r in runs.items()
           for k in ("b1_launches", "b2_launches")},
        "summary": {k: v for k, v in rep4.summary().items()
                    if k != "divergences"}}
    if not all(checks.values()):
        emit(out)
        fail(f"sweep (a): {checks} {bit_identical} "
             f"{rep4.summary()['failures']} {rep1.summary()['failures']}")
    del rep4, rep1, runs
    gc.collect()

    # (b) the Fig. 5 batched lane (bench_debug_iteration.sweep_comparison)
    cong = CongestionConfig(dos_prob=0.02, seed=11)

    def sequential():
        t0, ok = time.perf_counter(), True
        for size in FIG5_SWEEP_SIZES:
            res = coverify(
                lambda fb, be, size=size: matmul_firmware(fb, "mm", be,
                                                          size=size),
                {"mm": matmul_backends(tile=32, device="cuda")},
                backends=SWEEP_BACKENDS, tol=1e-3, congestion=cong)
            ok &= res.passed
        return time.perf_counter() - t0, ok

    fig5 = CoVerifySession(matmul_firmware, congestion=cong)
    fig5.register_op("mm", **matmul_backends(tile=32, device="cuda"))
    fig5.add_sweep("mm", SWEEP_BACKENDS,
                   [{"size": s} for s in FIG5_SWEEP_SIZES])

    def batched():
        t0 = time.perf_counter()
        rep = fig5.run(max_workers=SWEEP_WORKERS)
        return time.perf_counter() - t0, rep.passed

    sequential()                          # warm: every shape compiled
    seq_s, seq_ok = sequential()
    batched()
    bat_s, bat_ok = batched()
    out["fig5_batched_lane"] = {
        "cells": len(fig5.cells), "sizes": list(FIG5_SWEEP_SIZES),
        "tile": 32, "workers": SWEEP_WORKERS, "sequential_s": seq_s,
        "batched_s": bat_s, "sequential_over_batched": seq_s / bat_s,
        "passed": seq_ok and bat_ok}
    FIG5_READINGS["sweep"] = out["fig5_batched_lane"]
    if not (seq_ok and bat_ok):
        emit(out)
        fail("sweep (b): the Fig. 5 lanes did not pass")

    # (c) (a)'s matmul cells at TRACE_CELLS' size: every save_traces file
    build_sweep_tier(tables, TRACE_CELLS)
    t = time.perf_counter()
    rep = sweep_session(tables, ops=("mm",), profile=True,
                        cells=TRACE_CELLS).run(max_workers=SWEEP_WORKERS)
    run_s = time.perf_counter() - t
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    t = time.perf_counter()
    paths = rep.save_traces(TRACE_DIR)
    save_s = time.perf_counter() - t
    t = time.perf_counter()
    invalid = {p.name: validate_trace(json.loads(p.read_text()))[:3]
               for p in paths}
    invalid = {k: v for k, v in invalid.items() if v}
    validate_s = time.perf_counter() - t
    trace_bytes = {p.name: p.stat().st_size for p in paths}
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    checks = {"passed": rep.passed,
              "closes": all(closes(r.profile) for r in rep.cells),
              "traces_valid": not invalid and len(paths) == len(rep.cells)}
    out["profiled_matmul_traces"] = {
        "cells": len(rep.cells), "trace_cells": TRACE_CELLS, **checks,
        "run_s": run_s, "invalid": invalid, "save_traces_s": save_s,
        "validate_s": validate_s, "trace_bytes": trace_bytes}
    if not all(checks.values()):
        emit(out)
        fail(f"sweep (c): {checks}")
    del rep
    gc.collect()

    # (d) the planted bug at full size
    bug = CoVerifySession(matmul_firmware, congestion=CongestionConfig(**CONG))
    bug.register_op("mm", **planted_bug_table(
        tile=SWEEP_CELLS["mm"]["tile"], device="cuda"))
    bug.add_sweep("mm", ("oracle", "interpret"), [SWEEP_CELLS["mm"]])
    t = time.perf_counter()
    rep = bug.run(max_workers=SWEEP_WORKERS)
    bug_s = time.perf_counter() - t
    divs = list(rep.divergences.values())
    d = divs[0] if len(divs) == 1 else None
    named = isinstance(d, replay_mod.DivergenceReport) and \
        d.event.startswith("launch")
    out["planted_bug"] = {
        "passed": rep.passed, "wall_s": bug_s,
        "divergences": rep.summary()["divergences"],
        "op_index": getattr(d, "op_index", None),
        "kind": getattr(d, "kind", None),
        "replays": getattr(d, "n_replays", None)}
    launches = {"systolic_matmul": MMK.launches, "flash_fwd": FAK.launches}
    out["launches"] = launches
    out["compiled_graphs"] = compiled_graphs() - graphs0
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    if rep.passed or not named:
        fail(f"sweep (d): planted bug not localized to a launch op: "
             f"{out['planted_bug']}")
    if min(launches.values()) < 1:
        fail(f"sweep: a kernel was never launched: {launches}")
    del rep, bug, fig5, sess, tables
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def combined_digest(target) -> str:
    h = hashlib.sha256()
    for log in replay_mod.target_logs(target):
        h.update(log.digest().encode())
    return h.hexdigest()


def late_bug_table() -> dict:
    """B1's table (tile 16) whose interpret lane diverges only for 64-row
    launches (``benchmarks/bench_replay.py``)."""
    table = matmul_backends(tile=ProtocolFuzzer.TILE, device="cuda")
    good = table["interpret"]

    def buggy(a, b):
        out = np.array(good(a, b))
        if a.shape[0] == 64:
            out[1, 2] += 1.0
        return out
    return dict(table, interpret=buggy)


def late_bug_scenario(table: dict):
    """A fuzzer and a scenario of ``SHRINK_OPS`` launches whose only
    64-row launch (where the bug fires) is at 3/4 of the list."""
    fz = ProtocolFuzzer(seed=0, layers=("bridge",),
                        backends=("oracle", "interpret"), mm_table=table,
                        bridge_ops=(SHRINK_OPS, SHRINK_OPS + 1),
                        device="cuda")
    bug_at = (3 * SHRINK_OPS) // 4
    sizes = [(32, 48)[j % 2] for j in range(SHRINK_OPS)]
    sizes[bug_at - 1] = 64
    return fz, Scenario(0, "bridge", [("launch", s) for s in sizes]), bug_at


def storm_requests(vocab: int):
    """Five requests of 3-11 prompt tokens and 2-5 new ones: within
    ``_default_engine``'s 32-position slots."""
    rng = np.random.default_rng(0)
    return [(rid, rng.integers(1, vocab, int(rng.integers(3, 12))).astype(
        np.int32), int(rng.integers(2, 6))) for rid in range(5)]


def phase_replay(card: str):
    """Time-travel replay on the card: the 4096 matmul recorded through
    ``RecordingBridge`` (full-range and window replays repeat its digests
    and final state); ``benchmarks/bench_replay.py``'s workload on B1
    (state at launch 150 by window replay against a full re-run; the
    late-bug shrink with and without prefix replay); a full-width
    llama3.2-1b serving storm recorded and replayed.  Returns B1's
    launches in the phase and the storm's engine."""
    t_phase = time.perf_counter()
    MMK.launches = 0
    out = {"phase": "replay", "card": card}

    # the full-size recording
    mm = SWEEP_CELLS["mm"]
    table = matmul_backends(tile=mm["tile"], device="cuda", jit=False)

    def factory():
        fb = FireBridge(congestion=CongestionConfig(**CONG))
        fb.register_op("mm", **table)
        return fb
    sess = replay_mod.DebugSession(factory, checkpoint_interval=2,
                                   label="matmul")
    t = time.perf_counter()
    rec = sess.record(lambda r: matmul_firmware(
        replay_mod.RecordingBridge(r), "mm", "interpret", **mm))
    record_s = time.perf_counter() - t
    n = rec.n_ops
    t = time.perf_counter()
    full = sess.replay(rec, 0, n)
    full_s = time.perf_counter() - t
    windows = {}
    for lo, hi in ((1, 4), (3, n), (n - 1, n)):
        w = sess.replay(rec, lo, hi)
        windows[f"{lo}-{hi}"] = (w.lines == rec.window_lines(lo, hi)
                                 and w.digest() == rec.window_digest(lo, hi))
    last = sess.replay(rec, n - 1, n).target
    checks = {"full_range_digest": combined_digest(full.target)
              == rec.log_digest,
              "full_range_lines": full.lines == rec.window_lines(0, n),
              "windows_identical": all(windows.values()),
              "final_fingerprint": replay_mod.state_fingerprint(
                  full.target.get_state()) == rec.final_fingerprint,
              "window_final_fingerprint": replay_mod.state_fingerprint(
                  last.get_state()) == rec.final_fingerprint}
    out["matmul_recording"] = {**mm, "ops": n, "checkpoints": [c.op_index for c in
                                                   rec.checkpoints],
                         "record_s": record_s, "full_replay_s": full_s,
                         "windows": windows, **checks,
                         "log_digest": rec.log_digest[:16]}
    del sess, rec, full, last
    if not all(checks.values()):
        emit(out)
        fail(f"replay (matmul recording): {checks}")

    # bench_replay's debug iteration: state at launch 150 of 200 on B1
    fz = ProtocolFuzzer(seed=0, layers=("bridge",), backends=("interpret",),
                        bridge_ops=(REPLAY_OPS, REPLAY_OPS + 1),
                        device="cuda")
    scn = fz.scenario(0)
    per_op = ProtocolFuzzer._BRIDGE_EVENTS_PER_OP
    t = time.perf_counter()
    sess, rec = fz._record_bridge_scenario(scn, "interpret", REPLAY_EVERY)
    sess0, rec0 = fz._record_bridge_scenario(scn, "interpret",
                                             REPLAY_OPS + 1)
    record_s = time.perf_counter() - t
    k = REPLAY_INSPECT * per_op
    sess0.ops_applied = sess.ops_applied = 0
    t = time.perf_counter()
    a = sess0.replay(rec0, k, k).target
    full_s = time.perf_counter() - t
    t = time.perf_counter()
    b = sess.replay(rec, k, k).target
    win_s = time.perf_counter() - t
    same = replay_mod.state_fingerprint(a.get_state()) == \
        replay_mod.state_fingerprint(b.get_state())
    out["debug_iteration"] = {
        "launches": len(scn.ops), "inspect_at": REPLAY_INSPECT,
        "checkpoint_every": REPLAY_EVERY, "record_two_s": record_s,
        "full_rerun_events": sess0.ops_applied, "full_rerun_s": full_s,
        "window_replay_events": sess.ops_applied, "window_replay_s": win_s,
        "speedup": full_s / win_s, "same_state": same}
    del sess, rec, sess0, rec0, a, b

    # bench_replay's shrink: a late-firing bug, with and without replay
    table = late_bug_table()
    for size in ProtocolFuzzer.SIZES:     # compiled outside the timed lanes
        x = np.zeros((size, size), np.float32)
        table["interpret"](x, x)
        table["compiled"](x, x)
    shrink = {}
    for lane, use_replay in (("linear", False), ("prefix_replay", True)):
        fzs, scn, bug_at = late_bug_scenario(table)
        t = time.perf_counter()
        sub, res = fzs.shrink(scn, use_replay=use_replay)
        dt = time.perf_counter() - t
        ops = (sum(n for n, _ in fzs.shrink_counts.values()) if use_replay
               else bug_at * (bug_at + 1) // 2 * per_op * 2)
        shrink[lane] = {"s": dt, "ops_applied": ops,
                        "prefix": len(sub.ops), "fails": not res.ok,
                        "digest": res.digest[:16]}
    shrink["bug_at"] = bug_at
    shrink["speedup"] = shrink["linear"]["s"] / shrink["prefix_replay"]["s"]
    out["shrink"] = shrink
    same_prefix = (shrink["linear"]["prefix"]
                   == shrink["prefix_replay"]["prefix"] == bug_at
                   and shrink["linear"]["digest"]
                   == shrink["prefix_replay"]["digest"]
                   and shrink["linear"]["fails"]
                   and shrink["prefix_replay"]["fails"])

    # a full-width serving storm, recorded and replayed
    t = time.perf_counter()
    eng = _default_engine(device="cuda", cfg=get_config("llama3.2-1b"))

    def storm_factory():
        eng.reset()
        return eng
    sess = replay_mod.DebugSession(storm_factory, checkpoint_interval=4,
                                   label="storm")
    rec = replay_mod.record_serving_storm(sess,
                                          storm_requests(eng.cfg.vocab_size))
    storm_record_s = time.perf_counter() - t
    tokens = {rid: list(r.out_tokens) for rid, r in rec.target.requests.items()}
    final = rec.final_fingerprint
    t = time.perf_counter()
    w = sess.replay(rec, 0, rec.n_ops)
    storm_replay_s = time.perf_counter() - t
    storm = {"ops": rec.n_ops, "checkpoints": len(rec.checkpoints),
             "record_s": storm_record_s, "replay_s": storm_replay_s,
             "tokens_out": sum(len(v) for v in tokens.values()),
             "lines": w.lines == rec.window_lines(0, rec.n_ops),
             "log_digest": combined_digest(w.target) == rec.log_digest,
             "final_fingerprint": replay_mod.state_fingerprint(
                 w.target.get_state()) == final,
             "tokens": {rid: list(r.out_tokens) for rid, r in
                        w.target.requests.items()} == tokens,
             "cache_on": str(next(iter(leaves(eng.cache))).device)}
    out["serving_storm"] = storm
    launches = MMK.launches
    out["b1_launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    if not (same and same_prefix):
        fail(f"replay: debug iteration same_state={same}, shrink {shrink}")
    if not all(storm[k] for k in ("lines", "log_digest",
                                  "final_fingerprint", "tokens")):
        fail(f"replay (serving storm): {storm}")
    if launches < 1:
        fail("replay: B1 was never launched")
    return launches, eng


def perfetto_bytes(prof) -> bytes:
    """``save_perfetto``'s bytes, without the file."""
    return (json.dumps(prof.to_perfetto(), sort_keys=True,
                       separators=(",", ":")) + "\n").encode()


def phase_profile(card: str, eng) -> int:
    """The data-movement profiler on the card: the golden programs'
    Perfetto bytes equal to the same programs run with ``device="cpu"``;
    the 4-device matmul cell's fabric profile (per port, per ring leg);
    the full-width storm's serving profile.  Returns B1's launches."""
    t_phase = time.perf_counter()
    MMK.launches = 0
    out = {"phase": "profile", "card": card, "goldens": {}}
    equal = {}
    for name, program in goldens.PROGRAMS.items():
        card_b = perfetto_bytes(DataMovementProfiler(program("cuda"),
                                                     label=name))
        cpu_b = perfetto_bytes(DataMovementProfiler(program("cpu"),
                                                    label=name))
        equal[name] = card_b == cpu_b
        out["goldens"][name] = {"sha256": hashlib.sha256(card_b).hexdigest(),
                                "bytes": len(card_b),
                                "equal_to_cpu": equal[name]}

    fab = FabricCluster(4, congestion=CongestionConfig(**CONG),
                        link_config=FABRIC_DOS, profile=True)
    mm = SWEEP_CELLS["mm"]
    fab.register_op("mm", **matmul_backends(tile=mm["tile"], device="cuda",
                                            jit=False))
    t = time.perf_counter()
    matmul_fabric_firmware(fab, "mm", "interpret", **mm)
    run_s = time.perf_counter() - t
    t = time.perf_counter()
    prof = fab.profiler("fabric_mm")
    build_s = time.perf_counter() - t
    fab_closes = closes(prof)
    out["fabric"] = {
        **mm, "devices": 4, "run_s": run_s, "profile_build_s": build_s,
        "closes": fab_closes, "channels": len(prof.channels),
        "port_rows": [r for r in prof.engine_rows()
                      if r.startswith(("channel,", "fabric/"))],
        "leg_rows": prof.op_rows(), "summary": prof.summary()}
    del fab, prof

    sprof = eng.profiler("serving_storm")
    out["serving"] = {"closes": closes(sprof),
                      "serving_rows": sprof.serving_rows(),
                      "summary": sprof.summary()}
    launches = MMK.launches
    out["b1_launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    if not all(equal.values()):
        fail(f"profile: card Perfetto bytes differ from the CPU's: {equal}")
    if not (fab_closes and out["serving"]["closes"]):
        fail("profile: an attribution does not close")
    if launches < 1:
        fail("profile: B1 was never launched")
    return launches


# ------------------------------------------------------------- phase 6f
CAMPAIGN_SEED = 42
# the docs' register-protocol campaign (docs/runfarm.md): seed 42, 600
# scenarios in batches of 150, 3 generations; its final digest
CAMPAIGN_DOCS = dict(seed=42, n_scenarios=600, batch=150)
CAMPAIGN_DOCS_DIGEST = "88fda7c259f1e6e7"
CAMPAIGN_SWEEP = [dict(size=4096, tile=128), dict(size=1024, tile=128),
                  dict(size=64, tile=16)]
CAMPAIGN_BRIDGE = dict(n_scenarios=6, batch=3, layers=("bridge",),
                       bridge_ops=[2, 4])
CAMPAIGN_SERVING = dict(
    traces=[{"kind": "bursty", "params": {"n_requests": 8, "burst_size": 4,
                                          "gap_between": 400.0}}],
    pools=[{"kv_pages": 3, "kv_page_size": 8}], devices=(1, 2))
CAMPAIGN_BUG = dict(seed=5, n_scenarios=2, batch=2, layers=("bridge",),
                    bridge_ops=[2, 4], mm_bug=(1, 2, 1.0))
CAMPAIGN_DIR = ROOT / "build" / "campaign"


def campaign_units() -> list:
    """Generation 0: the docs' register units first (uids g00/u00000-3,
    so their lineage is the docs campaign's), then every golden trace,
    the sweep units, the bridge fuzz units and the serving units."""
    units = fuzz_units(**CAMPAIGN_DOCS)
    units += golden_units(list(goldens.PROGRAMS), start_index=len(units))
    units += sweep_units(CAMPAIGN_SEED, CAMPAIGN_SWEEP, configs_per_unit=1,
                         start_index=len(units))
    units += fuzz_units(CAMPAIGN_SEED, start_index=len(units),
                        **CAMPAIGN_BRIDGE)
    units += serving_units(CAMPAIGN_SEED, start_index=len(units),
                           **CAMPAIGN_SERVING)
    return units


def run_campaign(lane: str, units, workers: int, **kw):
    """One lane of the campaign on the card; ``max_parents=1`` mutates only
    the first productive unit in uid order (g00/u00000, as in the docs
    campaign), so the farm re-runs no sweep or serving unit as a child."""
    mgr = CampaignManager(CAMPAIGN_DIR / lane, units, seed=CAMPAIGN_SEED,
                          workers=workers, generations=3,
                          children_per_parent=2, max_parents=1,
                          device="cuda", **kw)
    return mgr, mgr.run()


def campaign_view(res) -> tuple:
    """What every lane must reproduce: the final digest, the per-unit
    digests, the merged coverage and counters, ``deterministic_view``."""
    return (res.digest, {u: res.records[u]["digest"] for u in res.uids},
            res.coverage.counts, res.counters, res.report["deterministic"])


def phase_campaign(card: str) -> int:
    """The run farm (``repro_torch.runfarm``) on the card, every unit with
    ``device="cuda"``: the campaign in process (B1's launches counted
    there), on a 2-worker spawned pool, on a pool whose worker 0 SIGKILLs
    itself before its second unit, and resumed on the pool's directory;
    then the planted bug in process.  Workers load the kernels that phase
    2 built.  Returns B1's launches in the in-process lane."""
    t_phase = time.perf_counter()
    shutil.rmtree(CAMPAIGN_DIR, ignore_errors=True)
    units = campaign_units()
    docs_uids = [u.uid for u in units[:4]] + ["g01/u00000", "g01/u00001"]
    out = {"phase": "campaign", "card": card, "units_gen0": len(units),
           "kinds": {k: sum(u.kind == k for u in units)
                     for k in ("golden", "sweep", "fuzz_batch",
                               "serving")},
           "lanes": {}}
    lanes = {}
    MMK.launches = 0
    lanes["in_process"] = run_campaign("w0", units, 0)
    launches = MMK.launches
    lanes["pool"] = run_campaign("w2", units, 2)
    lanes["sigkill"] = run_campaign("kill", units, 2,
                                    kill_worker_after={0: 1})
    lanes["resume"] = run_campaign("w2", units, 2)
    want = campaign_view(lanes["in_process"][1])
    for lane, (mgr, res) in lanes.items():
        timing = res.report["timing"]
        out["lanes"][lane] = {
            "workers": timing["workers"],
            "wall_s": timing["wall_seconds"],
            "scenarios_per_s": timing["scenarios_per_sec"],
            "pool_utilization": timing["pool_utilization"],
            "busy_s": timing["busy_seconds_total"],
            "spawn_to_ready_s": mgr.ready_seconds,
            "respawned": timing["workers_respawned"],
            "resumed": timing["units_resumed_from_store"],
            "units": len(res.uids),
            "scenarios": res.report["deterministic"]["scenarios"],
            "digest": res.digest[:16],
            "docs_digest": ResultStore.final_digest(
                res.records, docs_uids)[:16],
            "passed": res.passed,
            "same_as_in_process": campaign_view(res) == want}
    res0 = lanes["in_process"][1]
    out["unit_seconds"] = {u: (res0.records[u]["kind"],
                               res0.records[u]["seconds"])
                           for u in res0.uids}
    out["goldens_ok"] = {u: res0.records[u]["ok"] for u in res0.uids
                         if res0.records[u]["kind"] == "golden"}
    out["coverage"] = res0.report["deterministic"]["coverage"]
    out["b1_launches"] = launches

    t = time.perf_counter()
    bug = CampaignManager(CAMPAIGN_DIR / "bug", fuzz_units(**CAMPAIGN_BUG),
                          seed=CAMPAIGN_BUG["seed"], device="cuda").run()
    harvest = [bug.records[u].get("harvest") for u in bug.uids]
    out["planted_bug"] = {"passed": bug.passed,
                          "bundles": [b.name for b in bug.bundles],
                          "harvest": harvest[0], "wall_s":
                          time.perf_counter() - t}
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    for lane, row in out["lanes"].items():
        if not (row["passed"] and row["same_as_in_process"]):
            fail(f"campaign: lane {lane} failed or differs from the "
                 f"in-process lane: {row}")
        if row["docs_digest"] != CAMPAIGN_DOCS_DIGEST:
            fail(f"campaign: lane {lane}: the docs campaign's digest is "
                 f"{row['docs_digest']}, not {CAMPAIGN_DOCS_DIGEST}")
    if not all(out["goldens_ok"].values()) or len(out["goldens_ok"]) != 7:
        fail(f"campaign: golden units not ok: {out['goldens_ok']}")
    if out["lanes"]["sigkill"]["respawned"] < 1:
        fail("campaign: the SIGKILL lane respawned no worker")
    if out["lanes"]["resume"]["resumed"] != len(res0.uids):
        fail("campaign: the resumed lane re-ran units")
    h = harvest[0]
    if bug.passed or not (h and h["layer"] == "bridge"
                          and h["shrunk_ops"] == 1
                          and "divergence" in h["failures"][0]):
        fail(f"campaign: planted bug not caught and shrunk to 1 launch: "
             f"{out['planted_bug']}")
    if launches < 1:
        fail("campaign: the in-process lane never launched B1")
    shutil.rmtree(CAMPAIGN_DIR, ignore_errors=True)
    return launches


# ------------------------------------------------------------- phase 6g
DRIVERS_DIR = ROOT / "build" / "drivers"
QUICKSTART_DIR = ROOT / "build" / "quickstart"
DOCS = ROOT / "docs"
MODELED = "prints (deterministic — modeled cycles only, no wall time):"
# (driver, arguments besides --device, docs page, sentinel of its block)
DRIVER_TRANSCRIPTS = [
    ("examples/profile_cnn_torch.py",
     ["--trace-out", str(DRIVERS_DIR / "profile_cnn.trace.json")],
     "profiling.md", MODELED),
    ("examples/counter_dashboard_torch.py", [], "instrumentation.md",
     MODELED),
    ("examples/topology_tour_torch.py", [], "topology.md", MODELED),
    ("examples/open_loop_serving_torch.py", [], "serving.md", MODELED),
    ("benchmarks/bench_simspeed_torch.py", ["--selftest"], "performance.md",
     MODELED),
    ("examples/campaign_torch.py", [], "runfarm.md",
     "prints (deterministic — digests, unit counts, and coverage only, no "
     "wall time):"),
    ("examples/time_travel_debug_torch.py", [], "replay.md",
     "prints (deterministic — modeled clocks and seeded faults, no wall "
     "time):"),
]
# the two places docs/replay.md's transcript hashes the float buffer c
C_LEAF = re.compile(r"^(  first differing state leaf: buffers/c = )"
                    r"'[0-9a-f]{12}' vs '[0-9a-f]{12}'$")
C_ENTRY = re.compile(r"'c': '[0-9a-f]{12}'")
RESNET_LAUNCHES = 17          # one B1 launch a conv of ResNet-18
QUICKSTART_ARGS = ["--steps", "100", "--inject-failure", "60",
                   "--ckpt-dir", str(QUICKSTART_DIR)]


def fenced(page: str, sentinel: str) -> list:
    doc = (DOCS / page).read_text().splitlines()
    i = doc.index(sentinel)
    start = doc.index("```", i) + 1
    return doc[start:doc.index("```", start)]


def mask_c(lines: list) -> list:
    out = []
    for ln in lines:
        if C_LEAF.match(ln):
            ln = C_LEAF.sub(r"\1<c> vs <c>", ln)
        elif ln.startswith("   *buffers: "):
            ln = C_ENTRY.sub("'c': <c>", ln)
        out.append(ln)
    return out


def load_driver(rel: str):
    """A driver of the checkout, loaded from its file."""
    import importlib.util
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location("driver_" + path.stem,
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_driver(mod, argv: list) -> tuple:
    """(exit code, stdout lines, wall s) of ``mod.main(argv)`` on the
    card, its standard output captured."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv + ["--device", "cuda"])
    return rc or 0, buf.getvalue().splitlines(), time.perf_counter() - t0


def drivers_transcripts() -> dict:
    out = {}
    for rel, argv, page, sentinel in DRIVER_TRANSCRIPTS:
        rc, got, wall = run_driver(load_driver(rel), argv)
        want = fenced(page, sentinel)
        masked = page == "replay.md"
        same = (mask_c(got) == mask_c(want)) if masked else got == want
        out[Path(rel).stem] = {"rc": rc, "lines": len(got), "equal": same,
                               "c_hashes_masked": masked, "wall_s": wall}
        if rc or not same:
            emit({"phase": "drivers", "transcript": Path(rel).stem,
                  "got": got, "want": want})
            fail(f"drivers: {rel} does not print docs/{page}'s transcript "
                 f"on the card")
    return out


def drivers_resnet18() -> dict:
    """The paper's §V-D workload at its own size through the port's
    coverify_cnn twin on the card, its modeled lines held against the same
    interpret run on the CPU; the host copies of the interpret run timed
    apart at each layer's shapes."""
    from benchmarks import cnn_driver_torch as cnn
    mod = load_driver("examples/coverify_cnn_torch.py")
    calls = []
    interp = cnn._mm_interp

    def recorded(a, w, tile, device="cuda"):
        t0 = time.perf_counter()
        out = interp(a, w, tile, device=device)
        calls.append((a.shape, w.shape, out.shape,
                      time.perf_counter() - t0))
        return out
    cnn._mm_interp = recorded
    before = MMK.launches
    try:
        rc, got, wall = run_driver(mod, ["--model", "resnet18"])
    finally:
        cnn._mm_interp = interp
    launches = MMK.launches - before
    cpu = cnn.run_cnn(cnn.resnet18_specs(36), "interpret",
                      congestion=mod.CONG, device="cpu")
    want = "\n".join(mod.congestion_report(cpu)).splitlines()
    tail = got[len(got) - len(want):]
    stalls = {ln.split()[0]: float(ln.split("stalls=")[1].split()[0])
              for ln in tail if ln.startswith("  dma_")}
    span = re.search(r"makespan: (\d+) cycles \(= bridge time (\d+)\)",
                     "\n".join(tail))
    rng = np.random.default_rng(0)
    copies = sum(copy_seconds([rng.normal(size=a).astype(np.float32),
                               rng.normal(size=w).astype(np.float32)], o)
                 for a, w, o, _ in calls)
    call_s = sum(c[3] for c in calls)
    row = {"rc": rc, "wall_s": wall, "b1_launches": launches,
           "layers": len(calls),
           "equivalence": [ln.strip() for ln in got if "DDR act_" in ln
                           or "functional equivalence" in ln],
           "modeled_lines_equal_cpu": tail == want, "stalls": stalls,
           "makespan_line": span.group(0) if span else None,
           "interpret_call_s": call_s, "host_copies_s": copies,
           "host_copy_share_of_interpret_calls": copies / call_s,
           "host_copy_share_of_wall": copies / wall}
    if rc or "  functional equivalence: PASS" not in got:
        fail(f"drivers: ResNet-18 co-verification failed: {row}")
    if launches != RESNET_LAUNCHES:
        fail(f"drivers: ResNet-18 launched B1 {launches} times, not "
             f"{RESNET_LAUNCHES}")
    if not row["modeled_lines_equal_cpu"]:
        emit({"phase": "drivers", "card": tail, "cpu": want})
        fail("drivers: ResNet-18's modeled lines differ from the CPU's")
    if len(stalls) != 3 or min(stalls.values()) <= 0 or not span or \
            span.group(1) != span.group(2):
        fail(f"drivers: ResNet-18 stalls or makespan wrong: {row}")
    return row


def drivers_quickstart() -> dict:
    """The 102M quickstart at full width for 100 steps, a failure injected
    at step 60 restoring the step-50 checkpoint."""
    shutil.rmtree(QUICKSTART_DIR, ignore_errors=True)
    graphs0 = compiled_graphs()
    rc, got, wall = run_driver(load_driver("examples/quickstart_torch.py"),
                               QUICKSTART_ARGS)
    log = [json.loads(ln) for ln in
           (QUICKSTART_DIR / "metrics.jsonl").read_text().splitlines()]
    steps = [r["step"] for r in log]
    after = steps[steps.index(59) + 1] if 59 in steps else None
    row = {"rc": rc, "wall_s": wall, "preflight": got[0], "model": got[1],
           "trained": next(ln for ln in got if ln.startswith("trained")),
           "first_loss": log[0]["loss"], "final_loss": log[-1]["loss"],
           "logged_steps": len(log), "step_after_59": after,
           "median_step_ms": 1e3 * statistics.median(
               r["step_time"] for r in log),
           "compiled_graphs": compiled_graphs() - graphs0}
    shutil.rmtree(QUICKSTART_DIR, ignore_errors=True)
    if rc or not got[0].endswith("-> PASS") or \
            "restarts=1;" not in row["trained"] or after != 50 or \
            not row["final_loss"] < row["first_loss"] or \
            not all(np.isfinite(r["loss"]) for r in log):
        fail(f"drivers: quickstart failed: {row}")
    return row


def drivers_figures() -> dict:
    """``benchmarks/run_torch.py``'s entries on the card (Fig. 5's two
    rows from the numbers of this run's own Fig. 5 phases), then the fabric
    scaling benchmark in full, the two ``--check`` lanes and the wall
    gates, each reading printed beside its gate."""
    import contextlib
    import io
    from benchmarks import (bench_debug_iteration_torch as fig5,
                            bench_fabric_scaling_torch, run_torch)
    out = {"rows": {}, "seconds": {}, "gates": {}}
    cases = FIG5_READINGS["cases"]
    out["rows"]["fig5_debug_iteration"] = [fig5.FIG5_HEADER] + [
        fig5.fig5_row(c["pes"], c["wall_s"]) for c in cases]
    lane = FIG5_READINGS["sweep"]
    out["rows"]["fig5_batched_sweep"] = [
        "case,cells,sequential_s,batched_s,speedup,passed",
        f"fig5_sweep,{lane['cells']},{lane['sequential_s']:.2f},"
        f"{lane['batched_s']:.2f},{lane['sequential_over_batched']:.2f}x,"
        f"{lane['passed']}"]
    for name, fn, gate in run_torch.entries("cuda"):
        if name.startswith("fig5_"):
            continue
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rows, held = run_torch._run(name, fn, gate)
        out["seconds"][name] = time.perf_counter() - t0
        out["rows"][name] = rows
        if gate is not None:
            out["gates"][name] = {"verdict": rows[-1], "held": held}
    fa0, graphs0 = FAK.launches, compiled_graphs()
    t0 = time.perf_counter()
    full = bench_fabric_scaling_torch.run(quick=False, device="cuda")
    out["fabric_full"] = {
        "seconds": time.perf_counter() - t0, "rows": full,
        "b2_launches": FAK.launches - fa0,
        "compiled_graphs": compiled_graphs() - graphs0,
        "cells": sum(r.startswith("fabric,") for r in full),
        "all_equivalent": all(r.endswith(",True") for r in full
                              if r.startswith("fabric,"))}
    if out["fabric_full"]["b2_launches"] < 1 or \
            not out["fabric_full"]["all_equivalent"]:
        fail(f"drivers: fabric scaling --full: {out['fabric_full']}")
    for rel in ("benchmarks/bench_serving_torch.py",
                "benchmarks/bench_simspeed_torch.py"):
        rc, got, wall = run_driver(load_driver(rel), ["--check"])
        out[Path(rel).stem + "_check"] = {"rc": rc, "lines": got,
                                          "wall_s": wall}
        if rc or not got[-1].endswith("check: PASS"):
            fail(f"drivers: {rel} --check failed: {got}")
    return out


def phase_drivers(card: str) -> dict:
    """The drivers (``examples/*_torch.py``, ``benchmarks/*_torch.py``) in
    process on the card: the docs' transcripts, ResNet-18 co-verified
    through B1, the 102M quickstart trained with one restart, the figures
    and the CI lanes.  Returns B1's and B2's launches in the phase."""
    t_phase = time.perf_counter()
    DRIVERS_DIR.mkdir(parents=True, exist_ok=True)
    MMK.launches = 0
    FAK.launches = 0
    out = {"phase": "drivers", "card": card}
    out["transcripts"] = drivers_transcripts()
    out["resnet18"] = drivers_resnet18()
    out["quickstart"] = drivers_quickstart()
    out["figures"] = drivers_figures()
    launches = {"systolic_matmul": MMK.launches, "flash_fwd": FAK.launches}
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------------ phase 7
LLAMA = dict(arch="llama3.2-1b", seq_len=2048, global_batch=2, steps=3,
             seed=0)
# pallas vs naive on the same weights and batch, bf16 compute: bf16 keeps 8
# significant bits (rounding 2^-9 ~ 2e-3 relative) and the two routes round
# at different places (naive rounds p to bf16 before p.v, the kernels keep
# p in fp32), so each layer's output differs by O(2^-8) relative; the mean
# loss over 4096 tokens averages that out, the gradient norm less so.
LOSS_RTOL, GNORM_RTOL = 5e-3, 5e-2
# smoke-size step on the card vs on the CPU (plain versions), fp32 compute:
# the same arithmetic in another summation order
SMOKE_RTOL = 1e-4


# a moe routing decision whose margin (its k-th minus its (k+1)-th router
# probability) is under this is at a tie: the card and the CPU sum the
# router's product in other orders, which moves a probability by about
# 1e-7 at smoke size
ROUTE_TIE = 1e-5


def train_batch(cfg, B: int, S: int, gen: torch.Generator) -> dict:
    """``make_train_batch``, with a vlm's patch embeddings scaled to unit
    variance, as ``route_batch`` draws them: it draws them at 0.02, where
    every cross-attention score is near zero and its softmax near uniform
    (the cross weights' gradients read about 1e-8 at full width)."""
    batch = make_train_batch(cfg, B, S, gen)
    if "patches" in batch:
        batch["patches"].mul_(50.0)
    return batch


def smoke_step_parity(arch: str = LLAMA["arch"], head_dim: int = 0) -> dict:
    """One train step at smoke(arch) size (its head dim set to ``head_dim``
    where given), fp32 compute, pallas attention: on the card (kernels)
    against the CPU (plain versions), from the same initial state and batch
    (``train_batch``; a vlm's gates nonzero).  A moe config's routing
    decisions are compared between the two sides (``route_flips``): a flip
    at a tie (margin under ``ROUTE_TIE``) is reported, and the card's step
    is run again on the CPU's decisions (``ForcedRoutes``) and held to the
    gate; any other flip fails."""
    cfg = smoke(get_config(arch))
    if head_dim:
        cfg = dataclasses.replace(cfg, head_dim=head_dim)
    flags = RunFlags(attn_impl="pallas", compute_dtype="float32")
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=3)
    init = make_train_state(cfg, torch.Generator(device="cpu").manual_seed(1))
    if cfg.family == "vlm":
        with torch.no_grad():
            vlm_gates(init["params"])
    init = tree_map(lambda t: t.detach(), init)

    def state_on(dev):
        st = tree_map(lambda t: t.to(dev, copy=True), init)
        st["params"] = tree_map(lambda t: t.requires_grad_(), st["params"])
        return st

    b = train_batch(cfg, 2, 128, torch.Generator().manual_seed(1))
    step = make_train_step(cfg, flags, None, opt)
    out = {}
    for name in ("cpu", "cuda"):
        batch = {k: v.to(name) for k, v in b.items()}
        with RouterLog() as log:
            st, m = step(state_on(name), batch)
        out[name] = (st, {k: float(v) for k, v in m.items()}, log)
    row = {"config": f"smoke({arch})", "head_dim": cfg.head_dim,
           "seq_len": 128, "batch": 2}
    if cfg.moe is not None:
        flips = route_flips(out["cpu"][2], out["cuda"][2])
        row["moe_routes"] = flips
        if not flips["same_calls"] or flips["max_flip_margin"] > ROUTE_TIE:
            fail(f"smoke step of {arch} on the card vs the CPU: routing "
                 f"decisions differ off a tie {flips}")
        if flips["flipped_tokens"]:
            with ForcedRoutes(out["cpu"][2]):
                st, m = step(state_on("cuda"),
                             {k: v.cuda() for k, v in b.items()})
            out["cuda"] = (st, {k: float(v) for k, v in m.items()}, None)
            row["card_on_cpu_routes"] = True
    (cs, cm, _), (gs, gm, _) = out["cpu"], out["cuda"]
    # AdamW's first update is lr * g / (|g| + eps) per element, which turns a
    # last-bit difference of a gradient near eps into a visible one: each
    # parameter whose gradient is above 100 * eps (the CPU's first moment is
    # (1 - b1) g) is held to 1e-3 * lr, the whole update to 1e-2 of its norm
    lr, sure_err, num, den = cm["lr"], 0.0, 0.0, 0.0
    for p0, pc, pg, m in zip(leaves(init["params"]), leaves(cs["params"]),
                             leaves(gs["params"]), leaves(cs["m"])):
        pc, pg = pc.detach(), pg.detach().cpu()
        sure = m.abs() / (1 - opt.b1) > 100 * opt.eps
        if sure.any():
            sure_err = max(sure_err, float((pg - pc).abs()[sure].max()))
        num += float(((pg - p0) - (pc - p0)).square().sum())
        den += float((pc - p0).square().sum())
    row.update({"cpu": cm, "cuda": gm, "rtol": SMOKE_RTOL,
                "params_max_abs_err_over_lr": sure_err / lr,
                "update_rel_err": (num / den) ** 0.5})
    for key in ("loss", "grad_norm"):
        if abs(gm[key] - cm[key]) > SMOKE_RTOL * abs(cm[key]):
            fail(f"smoke step on the card vs the CPU: {row}")
    if sure_err > 1e-3 * lr or num > 1e-4 * den:
        fail(f"smoke step on the card vs the CPU, parameters: {row}")
    return row


class EventTimer:
    """CUDA events around every call of some functions of a module while
    the timer is active (the module attributes are wrapped, so callers that
    look them up at call time — ``ops.py`` for the attention kernels,
    ``launch/steps.py`` for the optimizer — are timed)."""

    def __init__(self, module, names):
        self.module, self.names = module, names

    def __enter__(self):
        self.events = {n: [] for n in self.names}
        self.orig = {n: getattr(self.module, n) for n in self.names}
        for n in self.names:
            setattr(self.module, n, self._wrap(n, self.orig[n]))
        return self

    def _wrap(self, name, fn):
        def run(*a, **k):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out = fn(*a, **k)
            t1.record()
            self.events[name].append((t0, t1))
            return out
        return run

    def __exit__(self, *exc):
        for n in self.names:
            setattr(self.module, n, self.orig[n])

    def ms(self) -> dict:
        torch.cuda.synchronize()
        return {n: sum(a.elapsed_time(b) for a, b in ev)
                for n, ev in self.events.items()}


def phase_train_llama(card: str) -> dict:
    cfg = get_config(LLAMA["arch"])
    L = cfg.n_layers
    flags = RunFlags(attn_impl="pallas", microbatches=1)
    opt = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=LLAMA["steps"])
    dev = torch.device("cuda")
    parity = smoke_step_parity()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(LLAMA["seed"])
    state = make_train_state(cfg, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in leaves(state["params"]))
    data = SyntheticLMDataset(cfg.vocab_size, LLAMA["seq_len"],
                              LLAMA["global_batch"], seed=LLAMA["seed"])
    b0 = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(0).items()}

    # 1. one loss + backward with the kernels and with the naive attention
    routes = {}
    for impl in ("pallas", "naive"):
        loss_fn = make_loss_fn(cfg, dataclasses.replace(flags, attn_impl=impl))
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, _ = loss_fn(state["params"], b0)
        grads = torch.autograd.grad(loss, leaves(state["params"]))
        gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        routes[impl] = {"loss": float(loss.detach()), "grad_norm": float(gnorm),
                        "seconds": time.perf_counter() - t}
        del loss, grads, gnorm
    pl, nv = routes["pallas"], routes["naive"]
    if not all(np.isfinite([r["loss"], r["grad_norm"]]).all()
               for r in routes.values()):
        fail(f"train_llama: non-finite loss or gradient norm {routes}")
    if abs(pl["loss"] - nv["loss"]) > LOSS_RTOL * abs(nv["loss"]) or \
            abs(pl["grad_norm"] - nv["grad_norm"]) > GNORM_RTOL * nv["grad_norm"]:
        fail(f"train_llama: pallas and naive attention disagree {routes}")

    # 2. the Trainer, three steps, checkpoint at the end
    ckpt_dir = Path(tempfile.mkdtemp(prefix="ckpt_", dir=_build.BUILD_DIR))
    try:
        trainer = Trainer(cfg, TrainerConfig(
            seq_len=LLAMA["seq_len"], global_batch=LLAMA["global_batch"],
            steps=LLAMA["steps"], ckpt_dir=str(ckpt_dir), seed=LLAMA["seed"]),
            flags, opt, device=dev)
        ck = {"snapshot_s": 0.0, "write_s": 0.0}

        def timed(key, fn):
            def run(*a, **k):
                t = time.perf_counter()
                out = fn(*a, **k)
                ck[key] += time.perf_counter() - t
                return out
            return run
        trainer.ckpt.save = timed("snapshot_s", trainer.ckpt.save)
        trainer.ckpt._write = timed("write_s", trainer.ckpt._write)
        torch.cuda.reset_peak_memory_stats()
        FAK.launches = FAK.dkdv_launches = FAK.dq_launches = 0
        t = time.perf_counter()
        state, step = trainer.train(state=state)
        train_s = time.perf_counter() - t
        launches = attn_launches()
        peak = torch.cuda.max_memory_allocated()
        ck_files = [f for f in ckpt_dir.rglob("*") if f.is_file()]
        ck["bytes"] = sum(f.stat().st_size for f in ck_files)
        ck["steps_on_disk"] = trainer.ckpt.list_steps()
        meta = json.loads((ckpt_dir / f"step_{step:08d}" / "meta.json")
                          .read_text())
        ck["leaves"] = len(meta["leaves"])
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    log = trainer.metrics_log
    want = {"flash_fwd": 2 * L * LLAMA["steps"],
            "flash_dkdv": L * LLAMA["steps"], "flash_dq": L * LLAMA["steps"]}
    if launches != want:
        fail(f"train_llama: launches {launches}, expected {want} "
             f"(2L / L / L per step, L={L})")
    if step != LLAMA["steps"] or len(log) != LLAMA["steps"] or \
            not all(np.isfinite(r["loss"]) for r in log):
        fail(f"train_llama: {step} steps, log {log}")
    csr = {n: trainer.csr.hw_get(n) for n in ("STATUS", "STEP", "RESTARTS")}
    if csr["STATUS"] != 2 or csr["STEP"] != LLAMA["steps"] - 1:
        fail(f"train_llama: CSR {csr}")

    # 3. where one more step's time goes: the attention kernels (events
    # around every launch) and the optimizer (events around the update)
    # against the whole step (events around it)
    step_fn = make_train_step(cfg, flags, None, opt)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in data.batch(LLAMA["steps"]).items()}
    torch.cuda.synchronize()
    with EventTimer(FAK, ("flash_fwd", "flash_dkdv", "flash_dq")) as attn, \
            EventTimer(steps_lib, ("adamw_update",)) as optim:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        state, m = step_fn(state, batch)
        e1.record()
        attn_ms, optim_ms = attn.ms(), optim.ms()["adamw_update"]
    step_ms = e0.elapsed_time(e1)
    if not np.isfinite(float(m["loss"])):
        fail(f"train_llama: non-finite loss in the timed step {m}")
    split = {"step_ms": step_ms, "attention_kernels_ms": attn_ms,
             "attention_share": sum(attn_ms.values()) / step_ms,
             "optimizer_ms": optim_ms,
             "rest_ms": step_ms - sum(attn_ms.values()) - optim_ms}
    del state
    torch.cuda.empty_cache()
    row = {"phase": "train_llama", "card": card, **LLAMA,
           "config": {"n_layers": L, "d_model": cfg.d_model,
                      "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                      "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
                      "vocab_size": cfg.vocab_size, "params": n_params},
           "flags": dataclasses.asdict(flags), "reduced": [],
           "smoke_step_parity": parity, "init_s": init_s,
           "first_batch": routes, "tol": {"loss_rtol": LOSS_RTOL,
                                          "grad_norm_rtol": GNORM_RTOL},
           "steps_log": log, "train_s": train_s, "csr": csr,
           "launches": launches, "launches_per_step": {
               k: v // LLAMA["steps"] for k, v in launches.items()},
           "max_memory_allocated": peak, "checkpoint": ck,
           "timed_step": {**split, "loss": float(m["loss"])}}
    emit(row)
    return launches


# ------------------------------------------------------------------ phase 8
# ssm / hybrid training at full width, depth cut: rwkv6-7b to 2 of 32
# layers, zamba2-2.7b to 6 of 54 (five Mamba-2 layers and one pass of the
# shared attention block, attn_period 6); one sequence of 1024 tokens
TRAIN_SSM = {"rwkv6-7b": dict(n_layers=2), "zamba2-2.7b": dict(n_layers=6)}
TRAIN_SSM_SHAPE = dict(seq_len=1024, global_batch=1, seed=0)
SCAN_TWINS = {"wkv_scan": (wkv_ops, wkv_ops.wkv_scan_twin),
              "ssd_scan": (ssd_ops, ssd_ops.ssd_scan_twin)}


def attn_launches() -> dict:
    return {"flash_fwd": FAK.launches, "flash_dkdv": FAK.dkdv_launches,
            "flash_dq": FAK.dq_launches}


def ssm_launches() -> dict:
    return {"wkv_scan": WKVK.launches, "ssd_scan": SSDK.launches,
            **attn_launches()}


def phase_train_ssm(card: str) -> dict:
    """One loss + backward of each config with the scans' kernels on the
    forward (their wrappers' recompute backward) against the same with
    the scans routed through the twins of the reference's lax scans (plain
    autograd), then one ``make_train_step`` step, timed."""
    total = {k: 0 for k in ssm_launches()}
    dev = torch.device("cuda")
    for arch, cut in TRAIN_SSM.items():
        gc.collect()
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(get_config(arch), **cut)
        flags = RunFlags(attn_impl="pallas")
        opt = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=1)
        gen = torch.Generator(device=dev)
        gen.manual_seed(TRAIN_SSM_SHAPE["seed"])
        state = make_train_state(cfg, gen)
        n_params = sum(p.numel() for p in leaves(state["params"]))
        data = SyntheticLMDataset(cfg.vocab_size, TRAIN_SSM_SHAPE["seq_len"],
                                  TRAIN_SSM_SHAPE["global_batch"],
                                  seed=TRAIN_SSM_SHAPE["seed"])
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch(0).items()}
        routes = {}
        for route, swap in (("kernels", {}), ("twins", SCAN_TWINS)):
            before = ssm_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            with Swap(swap):
                loss, _ = make_loss_fn(cfg, flags)(state["params"], batch)
                grads = torch.autograd.grad(loss, leaves(state["params"]))
            gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads))
            routes[route] = {"loss": float(loss.detach()),
                             "grad_norm": float(gnorm),
                             "seconds": time.perf_counter() - t,
                             "launches": {k: v - before[k] for k, v in
                                          ssm_launches().items()}}
            del loss, grads, gnorm
        kr, tw = routes["kernels"], routes["twins"]
        if not all(np.isfinite([r["loss"], r["grad_norm"]]).all()
                   for r in routes.values()):
            fail(f"train_ssm {arch}: non-finite loss or gradient norm {routes}")
        if abs(kr["loss"] - tw["loss"]) > LOSS_RTOL * abs(tw["loss"]) or \
                abs(kr["grad_norm"] - tw["grad_norm"]) > \
                GNORM_RTOL * tw["grad_norm"]:
            fail(f"train_ssm {arch}: kernel and twin routes disagree {routes}")

        step_fn = make_train_step(cfg, flags, None, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = ssm_launches()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        state, m = step_fn(state, batch)
        e1.record()
        torch.cuda.synchronize()
        step = {k: v - before[k] for k, v in ssm_launches().items()}
        if cfg.family == "ssm":
            want = {"wkv_scan": cfg.n_layers}
        else:
            n_mamba = cfg.n_layers - cfg.n_layers // cfg.attn_period
            want = {"ssd_scan": n_mamba, "flash_fwd": 1, "flash_dkdv": 1,
                    "flash_dq": 1}
        for k, n in want.items():
            if kr["launches"][k] < n or step[k] < n:
                fail(f"train_ssm {arch}: {k} launched {kr['launches'][k]} / "
                     f"{step[k]} times, expected at least {n}")
        if not np.isfinite(float(m["loss"])):
            fail(f"train_ssm {arch}: non-finite loss in the step {m}")
        for k in total:
            total[k] += step[k]
        emit({"phase": "train_ssm", "card": card, "arch": arch,
              "config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                         "n_heads": cfg.n_heads, "head_dim": cfg.head_dim,
                         "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size,
                         "params": n_params},
              "reduced": [f"n_layers {get_config(arch).n_layers} -> "
                          f"{cfg.n_layers}"],
              **TRAIN_SSM_SHAPE, "flags": dataclasses.asdict(flags),
              "routes": routes, "tol": {"loss_rtol": LOSS_RTOL,
                                        "grad_norm_rtol": GNORM_RTOL},
              "step_ms": e0.elapsed_time(e1), "step_launches": step,
              "step_metrics": {k: float(v) for k, v in m.items()},
              "max_memory_allocated": torch.cuda.max_memory_allocated()})
        del state, m, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return total


# ------------------------------------------------------------------ phase 8b
# moe / vlm / audio training at full width, bf16 compute, pallas attention:
# B2 / B3 / B4 at the shapes these models give them (phase 3's FA_MOE ..
# FA_AUDIO and BWD_FAMILIES rows).  Depth cut so that the fp32 state
# (parameters, gradients, m and v: 16 B a parameter) fits the card:
# moonshot-v1-16b-a3b 4 of 48 layers (2.95 B parameters, 0.67 B of them
# embedding and head), llama-3.2-vision-11b 5 of 40 (four self layers and
# one cross layer: n_layers is a multiple of cross_attn_period); hubert-
# xlarge keeps its 48.  Every layer of these families runs one attention.
TRAIN_FAMILIES = {"moonshot-v1-16b-a3b": dict(n_layers=4, batch=1),
                  "llama-3.2-vision-11b": dict(n_layers=5, batch=1),
                  "hubert-xlarge": dict(n_layers=48, batch=2)}
TRAIN_FAMILIES_SHAPE = dict(seq_len=1536, seed=0)
FAMILY_PLAIN = "naive"           # the plain attention route of the check


def family_routes(cfg, params, batch, flags) -> dict:
    """One loss + backward on the pallas route and on the plain route, on
    the same weights and batch: loss (with 0.01 aux), its parts, gradient
    norm and launches; a vlm's smallest max |grad| over its cross
    weights; a moe model's routing decisions of the two routes compared
    (reported)."""
    routes, logs = {}, {}
    for impl in ("pallas", FAMILY_PLAIN):
        before = attn_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with RouterLog() as logs[impl]:
            loss, parts = make_loss_fn(cfg, dataclasses.replace(
                flags, attn_impl=impl))(params, batch)
            grads = torch.autograd.grad(loss, leaves(params))
        gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        r = {"loss": float(loss.detach()),
             "ce": float(parts["loss"].detach()),
             "aux": float(parts["aux"].detach()), "grad_norm": float(gnorm),
             "seconds": time.perf_counter() - t,
             "launches": {k: v - before[k]
                          for k, v in attn_launches().items()}}
        if cfg.family == "vlm":
            r["cross_w_min_max_abs_grad"] = min(
                float(g.abs().max()) for (p, _), g in zip(paths(params), grads)
                if p.startswith("blocks/cross/w"))
        routes[impl] = r
        del loss, grads, gnorm
    if cfg.moe is not None:
        routes["moe_routes_bf16"] = route_flips(logs["pallas"],
                                                logs[FAMILY_PLAIN])
    return routes


def phase_train_families(card: str) -> dict:
    """For each of moonshot-v1-16b-a3b, llama-3.2-vision-11b and
    hubert-xlarge: (a) one fp32 train step at smoke width with the
    family's own head dim, card against CPU (``smoke_step_parity``); (b)
    at full width in bf16, one loss + backward on the pallas route against
    the plain route (``LOSS_RTOL`` / ``GNORM_RTOL``; the vlm's gates
    nonzero, its patches at unit scale and every cross weight's gradient
    nonzero; moonshot's aux finite and above zero); (c) one
    ``make_train_step`` step, timed, with
    the attention kernels and AdamW split out, at least one B2, B3 and B4
    launch an attention layer, and its peak memory."""
    total = {k: 0 for k in attn_launches()}
    dev = torch.device("cuda")
    for arch, spec in TRAIN_FAMILIES.items():
        gc.collect()
        torch.cuda.empty_cache()
        full = get_config(arch)
        t0 = time.perf_counter()
        parity = smoke_step_parity(arch, head_dim=full.head_dim)
        parity_s = time.perf_counter() - t0

        cfg = dataclasses.replace(full, n_layers=spec["n_layers"])
        flags = RunFlags(attn_impl="pallas")
        opt = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=1)
        gen = torch.Generator(device=dev)
        gen.manual_seed(TRAIN_FAMILIES_SHAPE["seed"])
        t0 = time.perf_counter()
        state = make_train_state(cfg, gen)
        if cfg.family == "vlm":
            with torch.no_grad():
                vlm_gates(state["params"])
        batch = train_batch(cfg, spec["batch"],
                            TRAIN_FAMILIES_SHAPE["seq_len"], gen)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in leaves(state["params"]))
        n_attn = cfg.n_layers

        routes = family_routes(cfg, state["params"], batch, flags)
        pl, nv = routes["pallas"], routes[FAMILY_PLAIN]
        if not all(np.isfinite([r["loss"], r["aux"], r["grad_norm"]]).all()
                   for r in (pl, nv)):
            fail(f"train_families {arch}: non-finite loss, aux or gradient "
                 f"norm {routes}")
        if abs(pl["loss"] - nv["loss"]) > LOSS_RTOL * abs(nv["loss"]) or \
                abs(pl["grad_norm"] - nv["grad_norm"]) > \
                GNORM_RTOL * nv["grad_norm"]:
            fail(f"train_families {arch}: pallas and {FAMILY_PLAIN} "
                 f"attention disagree {routes}")
        if cfg.family == "vlm" and not min(
                r["cross_w_min_max_abs_grad"] for r in (pl, nv)) > 0:
            fail(f"train_families {arch}: a cross weight has no gradient "
                 f"{routes}")
        if cfg.moe is not None and not min(pl["aux"], nv["aux"]) > 0:
            fail(f"train_families {arch}: aux loss not above zero {routes}")
        if min(pl["launches"].values()) < n_attn:
            fail(f"train_families {arch}: the pallas route launched "
                 f"{pl['launches']}, fewer than {n_attn} a kernel")

        step_fn = make_train_step(cfg, flags, None, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = attn_launches()
        with EventTimer(FAK, ("flash_fwd", "flash_dkdv", "flash_dq")) as attn, \
                EventTimer(steps_lib, ("adamw_update",)) as optim:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            state, m = step_fn(state, batch)
            e1.record()
            attn_ms, optim_ms = attn.ms(), optim.ms()["adamw_update"]
        step = {k: v - before[k] for k, v in attn_launches().items()}
        step_ms = e0.elapsed_time(e1)
        peak = torch.cuda.max_memory_allocated()
        if min(step.values()) < n_attn:
            fail(f"train_families {arch}: the step launched {step}, fewer "
                 f"than one B2 / B3 / B4 in each of {n_attn} attention "
                 f"layers")
        if not np.isfinite(float(m["loss"])):
            fail(f"train_families {arch}: non-finite loss in the step {m}")
        for k in total:
            total[k] += step[k]
        emit({"phase": "train_families", "card": card, "arch": arch,
              "config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                         "n_heads": cfg.n_heads,
                         "n_kv_heads": cfg.n_kv_heads,
                         "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
                         "vocab_size": cfg.vocab_size, "params": n_params,
                         **({"n_experts": cfg.moe.n_experts,
                             "top_k": cfg.moe.top_k} if cfg.moe else {}),
                         **({"n_media_tokens": cfg.n_media_tokens}
                            if cfg.family == "vlm" else {})},
              "reduced": ([f"n_layers {full.n_layers} -> {cfg.n_layers}"]
                          if cfg.n_layers != full.n_layers else []),
              "batch": spec["batch"], **TRAIN_FAMILIES_SHAPE,
              "flags": dataclasses.asdict(flags),
              "smoke_step_parity": parity, "smoke_step_parity_s": parity_s,
              "init_s": init_s, "routes": routes,
              "tol": {"smoke_rtol": SMOKE_RTOL, "loss_rtol": LOSS_RTOL,
                      "grad_norm_rtol": GNORM_RTOL},
              "step_ms": step_ms, "attention_kernels_ms": attn_ms,
              "attention_share": sum(attn_ms.values()) / step_ms,
              "optimizer_ms": optim_ms,
              "rest_ms": step_ms - sum(attn_ms.values()) - optim_ms,
              "step_launches": step, "attention_layers": n_attn,
              "step_metrics": {k: float(v) for k, v in m.items()},
              "max_memory_allocated": peak})
        del state, m, step_fn, batch
    gc.collect()
    torch.cuda.empty_cache()
    return total


# ------------------------------------------------------------ phases 9, 10
SERVE = dict(max_slots=4, max_len=2048, prompt_pad=128, batching="storm",
             n_requests=8, seed=0)
# prompt lengths: every multiple of the 128-token bucket in 256-1536 (no
# left padding reaches a scan state); the first request is the longest,
# the shape phase 3 checks the scans at
PROMPT_LENS = tuple(range(256, 1537, 128))
SERVE_NEW = (16, 32)
# Kernel route vs plain route, last-position logits of one served prefill
# (1536-token prompt, the served weights).  The routes differ only in the
# fp32 summation order inside the kernels (~1e-7 relative per output).  In
# fp32 compute (the same weights upcast exactly) nothing else rounds
# differently: held to 1e-3 of max|logit|, which leaves four orders of
# magnitude for the amplification through 32 / 54 layers.  In bf16 compute,
# as served, those last-bit differences flip bf16 roundings that
# random-weight layers amplify to tens of percent of the logits, so the
# bf16 distances are reported, not gated: the per-layer checks and the
# fp32 route hold the kernels.  A moe model's fp32 routes must also make
# the same routing decisions (``route_flips``): a token sent to other
# experts fails the gate; the smallest margin between a token's k-th and
# (k+1)-th router probabilities is reported beside it.
ROUTE_RTOL_FP32 = 1e-3
# The attention forward's out against its plain version, element by
# element.  bf16: |out - plain| <= 2^-7 (|plain out| + sum_j p_j |v_j|),
# one bf16 ulp of each.  The kernel rounds p to bf16 (relative error at
# most 2^-8) before P.V, which moves out by at most 2^-8 sum_j p_j |v_j|,
# and both sides round out to bf16: a correct kernel stays within half the
# bound.  sum_j p_j |v_j| is the plain version run on |v|.  fp32: 2e-5.
# lse to 1e-4 times max(1, max|lse|).
BF16_ULP = 2.0 ** -7


def attn_out_tol(q, k, v, want, plain_fn, **kw) -> torch.Tensor:
    """Element-wise tolerance of a bf16 attention output (``BF16_ULP``)."""
    pv = plain_fn(q, k, v.abs(), **kw)[0]
    return BF16_ULP * (want.float().abs() + pv.float())


def over_tol(err: torch.Tensor, tol: torch.Tensor) -> float:
    """Largest err / tol, element by element (0 where err is 0)."""
    return float(torch.where(err == 0, torch.zeros_like(err),
                             err / tol).max())


def attn_err_over_tol(args, kw, got, want, plain_fn) -> list:
    """[out, lse]: one launch's worst error over its tolerance."""
    err = (got[0].float() - want[0].float()).abs()
    if got[0].dtype == torch.bfloat16:
        r_out = over_tol(err, attn_out_tol(*args, want[0], plain_fn, **kw))
    else:
        r_out = float(err.max()) / 2e-5
    return [r_out, max_err(got[1], want[1]) / (
        1e-4 * max(1.0, float(want[1].abs().max())))]


# the fp32 copy of the weights a route check makes leaves this much of the
# card free for the prefill; a deeper model is cut in depth to fit (full
# width; moonshot-v1-16b-a3b is 112 GB in fp32)
FP32_RESERVE = 8 << 30
# prefill + decode against a full prefill, smoke size, fp32 on the card:
# tests/test_decode_consistency.py's bound
DECODE_RTOL = 1e-4
SERVE_ARCHS = {
    "rwkv6-7b": dict(flags=RunFlags(), kernels={"wkv_scan": (WKVK, 32)},
                     phase="serve_rwkv6"),
    "zamba2-2.7b": dict(flags=RunFlags(attn_impl="pallas"),
                        kernels={"ssd_scan": (SSDK, 45),
                                 "flash_fwd": (FAK, 9)},
                        phase="serve_zamba2"),
    # 48 attention layers; 32 self- and 8 cross-attention layers
    "moonshot-v1-16b-a3b": dict(flags=RunFlags(attn_impl="pallas"),
                                kernels={"flash_fwd": (FAK, 48)},
                                phase="serve_moe"),
    "llama-3.2-vision-11b": dict(flags=RunFlags(attn_impl="pallas"),
                                 kernels={"flash_fwd": (FAK, 40)},
                                 phase="serve_vlm"),
}
# each served model's tokens by request id (phase ``sharded`` serves
# moonshot again under a sharding context and must give the same)
SERVED: dict = {}
PLAIN = {"wkv_scan": (WKVK, "wkv_scan_plain"),
         "ssd_scan": (SSDK, "ssd_scan_plain"),
         "flash_fwd": (FAK, "flash_fwd_plain")}


def serve_requests(cfg):
    rng = np.random.default_rng(SERVE["seed"])
    lens = [max(PROMPT_LENS)] + [int(x) for x in rng.choice(
        PROMPT_LENS, SERVE["n_requests"] - 1)]
    return [(rid, rng.integers(1, cfg.vocab_size, ln).astype(np.int32),
             int(rng.integers(SERVE_NEW[0], SERVE_NEW[1] + 1)))
            for rid, ln in enumerate(lens)]


def drive_doorbell(eng, reqs) -> None:
    """Submit through the CSR protocol (tests/test_serving.py), then run."""
    for rid, prompt, mx in reqs:
        eng.mem.buffers["prompt_in"].array[:len(prompt)] = prompt
        eng.csr.fb_write_32(eng.csr.addr_of("SUBMIT_ID"), rid)
        eng.csr.fb_write_32(eng.csr.addr_of("SUBMIT_LEN"), len(prompt))
        eng.csr.fb_write_32(eng.csr.addr_of("SUBMIT_MAXNEW"), mx)
        eng.csr.fb_write_32(eng.csr.addr_of("DOORBELL"), 1)
    eng.run_until_done()


class Swap:
    """Replace kernel wrappers by other callables while active (callers
    look the wrappers up at call time, as ``ops.py`` does)."""

    def __init__(self, repl: dict):
        self.repl = repl

    def __enter__(self):
        self.orig = {n: getattr(mod, n) for n, (mod, _) in self.repl.items()}
        for n, (mod, fn) in self.repl.items():
            setattr(mod, n, fn)
        return self

    def __exit__(self, *exc):
        for n, (mod, _) in self.repl.items():
            setattr(mod, n, self.orig[n])


def vlm_gates(params) -> None:
    """Nonzero cross-attention gates (they are zero at init, where the
    cross layers add nothing): tanh(gate) from 0.46 to 0.83 and tanh(gate_mlp)
    from -0.66 to 0.54 over the cross layers."""
    cross = params["blocks"]["cross"]
    n = cross["gate"].shape[0]
    cross["gate"].copy_(torch.linspace(0.5, 1.2, n))
    cross["gate_mlp"].copy_(torch.linspace(-0.8, 0.6, n))


def route_batch(cfg, prompt) -> dict:
    """One prompt as a prefill batch on the card; a vlm's patch embeddings
    random (seeded), so that its cross attention has something to read."""
    batch = {"tokens": torch.from_numpy(prompt[None]).cuda()}
    if cfg.frontend == "tokens+patches":
        gen = torch.Generator(device="cuda").manual_seed(11)
        batch["patches"] = torch.randn((1, cfg.n_media_tokens, cfg.d_model),
                                       generator=gen, device="cuda")
    return batch


def fp32_copy(cfg, params):
    """The weights in fp32 for the fp32 route, cut in depth (full width)
    only as far as the card's free memory forces: layer-stacked families
    keep the first n layers.  Returns (cfg, params, n_layers)."""
    L = cfg.n_layers
    blocks = leaves(params["blocks"])
    rest = sum(a.numel() for a in leaves(params)) - sum(
        a.numel() for a in blocks)
    per_layer = sum(a.numel() for a in blocks) * 4 / L
    free, _ = torch.cuda.mem_get_info()
    n = L
    if cfg.family in ("dense", "moe", "audio", "ssm"):
        n = min(L, int((free - FP32_RESERVE - rest * 4) // per_layer))
    if n < 1 or rest * 4 + n * per_layer > free - FP32_RESERVE:
        fail(f"fp32 route of {cfg.arch}: {free / 2**30:.1f} GiB free, "
             f"{per_layer / 2**30:.2f} GiB a layer")
    if n == L:
        return cfg, tree_map(lambda a: a.float(), params), n
    # a layer-stacked family: every block leaf has the L axis first
    out = {k: tree_map((lambda a: a[:n].float()) if k == "blocks"
                       else (lambda a: a.float()), v)
           for k, v in params.items()}
    return dataclasses.replace(cfg, n_layers=n), out, n


class RouterLog:
    """Records every moe routing decision (the top-k experts of each
    token, and the margin between its k-th and (k+1)-th probabilities)
    while active."""

    def __init__(self):
        self.calls = []
        self.raw = []            # each call's top-k experts in route's order

    def __enter__(self):
        self.orig = moe_lib.route

        def route(router_w, x, k):
            idx, w, aux = self.orig(router_w, x, k)
            with torch.no_grad():
                probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
                top = probs.topk(k + 1, dim=-1).values
            self.calls.append((idx.sort(dim=-1).values,
                               top[:, k - 1] - top[:, k]))
            self.raw.append(idx)
            return idx, w, aux
        moe_lib.route = route
        return self

    def __exit__(self, *exc):
        moe_lib.route = self.orig


def route_flips(a: RouterLog, b: RouterLog) -> dict:
    """Tokens whose expert sets differ between two runs of one prefill,
    the largest probability margin among them (and the first 32 margins,
    in call order), and the smallest margin of any decision of the first
    run."""
    flips, margin, least, each = 0, 0.0, float("inf"), []
    for (ia, ma), (ib, _) in zip(a.calls, b.calls):
        # the two runs may be on two devices (card and CPU)
        ia, ma, ib = ia.cpu(), ma.cpu(), ib.cpu()
        diff = (ia != ib).any(dim=-1)
        flips += int(diff.sum())
        least = min(least, float(ma.min()))
        if diff.any():
            margin = max(margin, float(ma[diff].max()))
            each += ma[diff].tolist()[:32 - len(each)]
    return {"decisions": sum(int(i.shape[0]) for i, _ in a.calls),
            "calls": len(a.calls), "same_calls": len(a.calls) == len(b.calls),
            "flipped_tokens": flips, "max_flip_margin": margin,
            "flip_margins": each, "min_margin": least}


class ForcedRoutes:
    """While active, each moe routing call takes its top-k experts from the
    same call of a recorded run (a ``RouterLog``), in route's order; the
    combine weights are this run's router probabilities of those experts,
    normalised as ``moe.route`` normalises them, and the aux loss is
    counted on them."""

    def __init__(self, log: RouterLog):
        self.raw = log.raw

    def __enter__(self):
        self.orig, calls = moe_lib.route, iter(self.raw)

        def route(router_w, x, k):
            probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
            idx = next(calls).to(x.device)
            w = probs.gather(-1, idx)
            w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
            E = probs.shape[-1]
            frac = F.one_hot(idx[:, 0], E).float().mean(dim=0)
            return idx, w, E * (frac * probs.mean(dim=0)).sum()
        moe_lib.route = route
        return self

    def __exit__(self, *exc):
        moe_lib.route = self.orig


class KernelChecks:
    """While ``swap()`` is active, every launch of the named kernels also
    runs its plain version on the same inputs and is held to the kernel's
    tolerance: the scans' y and state each to 1e-3 * max(1, max|plain|),
    attention as ``attn_err_over_tol``.  Keeps each kernel's worst error/tolerance
    and its number of checked launches."""

    def __init__(self, kernels):
        self.names = list(kernels)
        self.worst = {n: 0.0 for n in self.names}
        self.n_checked = {n: 0 for n in self.names}
        self.out_abs = [0.0, 0.0]    # attention: max |out - plain|, |plain|

    def _checked(self, name):
        mod, pname = PLAIN[name]
        kern, plain_fn = getattr(mod, name), getattr(mod, pname)

        def run(*a, **k):
            got = kern(*a, **k)
            want = plain_fn(*a, **k)
            pairs = list(zip(got, want))
            if name == "flash_fwd":
                worst = max(attn_err_over_tol(a, k, got, want, plain_fn))
                self.out_abs[0] = max(self.out_abs[0],
                                      max_err(got[0], want[0]))
                self.out_abs[1] = max(self.out_abs[1],
                                      float(want[0].float().abs().max()))
            else:
                worst = max(max_err(g, w) / scan_tol([w]) for g, w in pairs)
            self.worst[name] = max(self.worst[name], worst)
            self.n_checked[name] += 1
            return got
        return (mod, run)

    def swap(self) -> Swap:
        return Swap({n: self._checked(n) for n in self.names})


def route_checks(cfg, flags, prefill, params, batch, kernels) -> dict:
    """One served prefill through both routes, in bf16 as served and in
    fp32 on the same weights (cut in depth where memory forces,
    ``fp32_copy``).  Kernel route: every launch's inputs also go through
    the plain version, each layer held to the kernel's tolerance.  Plain
    route: every kernel wrapper replaced by its plain version.  Returns
    per-kernel worst error/tolerance, the logits' relative differences
    and, for a moe model, the fp32 routes' routing decisions compared."""
    chk = KernelChecks(kernels)
    plain = {n: (PLAIN[n][0], getattr(*PLAIN[n])) for n in kernels}
    rel = lambda a, b: max_err(a, b) / float(b.float().abs().max())
    with chk.swap():
        lg_k, _ = prefill(params, batch)
    with Swap(plain):
        lg_p, _ = prefill(params, batch)
    cfg32, params32, n32 = fp32_copy(cfg, params)
    prefill32 = tf.make_prefill_fn(
        cfg32, dataclasses.replace(flags, compute_dtype="float32"), None,
        int(next(iter(batch.values())).shape[1]))
    with RouterLog() as rk:
        lg32_k, _ = prefill32(params32, batch)
    with Swap(plain), RouterLog() as rp_:
        lg32_p, _ = prefill32(params32, batch)
    del params32
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    if cfg.moe is not None:
        out["moe_routes_fp32"] = route_flips(rk, rp_)
    if "flash_fwd" in kernels:
        out["attn_out_max_abs_err"], out["attn_out_max_abs_plain"] = \
            chk.out_abs
    return {"per_layer_err_over_tol": chk.worst,
            "layers_checked": chk.n_checked,
            "prompt_len": int(next(iter(batch.values())).shape[1]),
            "fp32_layers": n32, **out,
            "logits_route_rel_fp32": rel(lg32_k, lg32_p),
            "route_rtol_fp32": ROUTE_RTOL_FP32,
            # reported only (see ROUTE_RTOL_FP32); bf16 against fp32 only
            # where the fp32 copy has every layer
            "logits_route_rel_bf16": rel(lg_k, lg_p),
            "bf16_plain_vs_fp32_plain_rel": (rel(lg_p, lg32_p)
                                             if n32 == cfg.n_layers else None),
            "kernel_bf16_vs_fp32_plain_rel": (rel(lg_k, lg32_p)
                                              if n32 == cfg.n_layers
                                              else None)}


def smoke_decode_consistency(arch: str, flags: RunFlags) -> float:
    """tests/test_decode_consistency.py on the card: smoke config, fp32,
    B=2, prefill 48 tokens then decode 16, against a full prefill of 64
    (moe capacity lifted so that no token drops; a vlm with random patches
    and nonzero gates)."""
    cfg = smoke(get_config(arch))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    flags = dataclasses.replace(flags, compute_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = tf.init_params(cfg, gen)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32)).cuda()
    extra = {}
    if cfg.family == "vlm":
        vlm_gates(params)
        extra["patches"] = torch.randn((2, cfg.n_media_tokens, cfg.d_model),
                                       generator=gen, device="cuda")
    prefill = tf.make_prefill_fn(cfg, flags, None, 64)
    decode = tf.make_decode_fn(cfg, flags)
    full, _ = prefill(params, {"tokens": toks, **extra})
    lg, cache = prefill(params, {"tokens": toks[:, :48], **extra})
    for t in range(48, 64):
        lg, cache = decode(params, cache, toks[:, t])
    return max_err(lg, full) / float(full.abs().max())


def route_gate(checks) -> bool:
    """The fp32 route gate (see ROUTE_RTOL_FP32): a moe model's routes make
    the same decisions, and the logits agree."""
    flips = checks.get("moe_routes_fp32")
    if flips and (not flips["same_calls"] or flips["flipped_tokens"]):
        return False
    return checks["logits_route_rel_fp32"] < ROUTE_RTOL_FP32


def phase_serve(card: str, arch: str) -> dict:
    spec = SERVE_ARCHS[arch]
    cfg, flags = get_config(arch), spec["flags"]
    kernels = spec["kernels"]
    dev = torch.device("cuda")
    gc.collect()                      # what earlier phases left in cycles
    torch.cuda.empty_cache()
    decode_rel = smoke_decode_consistency(arch, flags)
    if not decode_rel < DECODE_RTOL:
        fail(f"serve {arch}: smoke prefill+decode vs full prefill "
             f"{decode_rel:.3e} >= {DECODE_RTOL}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dtype=torch.bfloat16)
    if cfg.family == "vlm":
        vlm_gates(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in leaves(params))
    eng = ServingEngine(cfg, params, flags=flags, device=dev,
                        **{k: SERVE[k] for k in ("max_slots", "max_len",
                                                 "prompt_pad", "batching")})
    reqs = serve_requests(cfg)

    # events around each prefill call, host clock around each decode step
    # (it ends in the argmax copy to the host, which synchronises)
    prefill_ev, decode_ms = [], []
    prefill_fn, decode_step = eng._prefill, eng._decode_step

    def timed_prefill(p, batch):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = prefill_fn(p, batch)
        e1.record()
        prefill_ev.append((int(batch["tokens"].shape[1]), e0, e1))
        return out

    def timed_decode():
        n = eng._n_active()
        t = time.perf_counter()
        decode_step()
        decode_ms.append(((time.perf_counter() - t) * 1e3, n))
    eng._prefill, eng._decode_step = timed_prefill, timed_decode

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated()
    timers = [EventTimer(mod, (name,)) for name, (mod, _) in kernels.items()]
    for mod, _ in kernels.values():
        setattr(mod, "launches", 0)
    t = time.perf_counter()
    for tm in timers:
        tm.__enter__()
    try:
        drive_doorbell(eng, reqs)
    finally:
        for tm in timers:
            tm.__exit__(None, None, None)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t
    launches = {name: mod.launches for name, (mod, _) in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    eng._prefill, eng._decode_step = prefill_fn, decode_step
    kernel_ms = {name: tm.ms()[name] for tm, name in zip(timers, kernels)}
    pre = [(n, a.elapsed_time(b)) for n, a, b in prefill_ev]
    n_pre = len(pre)

    out = {r.rid: r for r in eng.requests.values()}
    SERVED[arch] = {rid: list(r.out_tokens) for rid, r in out.items()}
    violations = list(eng.mem.log.violations)
    bad = [rid for rid, prompt, mx in reqs
           if rid not in out or not out[rid].done
           or len(out[rid].out_tokens) != mx]
    if eng.completed != len(reqs) or violations or bad:
        fail(f"serve {arch}: completed {eng.completed}/{len(reqs)}, "
             f"violations {violations}, wrong token counts {bad}")
    want = {name: per * n_pre for name, (_, per) in kernels.items()}
    if launches != want or n_pre != len(reqs):
        fail(f"serve {arch}: launches {launches} over {n_pre} prefills, "
             f"expected {want}")
    log_digest, n_txs = eng.mem.log.digest(), eng.mem.log.n_txs
    completed = eng.completed
    # the engine and its cache, before the fp32 copy
    del eng, decode_step, timed_decode
    gc.collect()
    torch.cuda.empty_cache()
    batch = route_batch(cfg, reqs[0][1])
    repeat = None
    if cfg.moe is not None:
        # the sort-based dispatch and its gather combine have no atomics:
        # one prefill twice gives the same bits
        a, ca = prefill_fn(params, batch)
        b, cb = prefill_fn(params, batch)
        repeat = torch.equal(a, b) and all(
            torch.equal(x, y) for x, y in zip(leaves(ca), leaves(cb)))
        del a, b, ca, cb
    checks = route_checks(cfg, flags, prefill_fn, params, batch, kernels)

    tokens_out = sum(len(r.out_tokens) for r in out.values())
    dec_tokens = sum(n for _, n in decode_ms)
    dec_total = sum(ms for ms, _ in decode_ms)
    pre_total = sum(ms for _, ms in pre)
    kern_total = sum(kernel_ms.values())
    reduced = []
    if checks["fp32_layers"] < cfg.n_layers:
        reduced.append(f"fp32 route check on the first "
                       f"{checks['fp32_layers']} of {cfg.n_layers} layers "
                       f"(full width): the fp32 copy of all of them does "
                       f"not fit beside the bf16 weights")
    row = {"phase": spec["phase"], "card": card, "arch": arch,
           "config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                      "n_heads": cfg.n_heads, "head_dim": cfg.head_dim,
                      "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size,
                      "params": n_params,
                      **({"n_experts": cfg.moe.n_experts,
                          "top_k": cfg.moe.top_k,
                          "expert_d_ff": cfg.moe.expert_d_ff}
                         if cfg.moe is not None else {}),
                      **({"cross_attn_period": cfg.cross_attn_period,
                          "n_media_tokens": cfg.n_media_tokens}
                         if cfg.family == "vlm" else {})},
           "flags": dataclasses.asdict(flags), "serve": SERVE,
           "reduced": reduced,
           "init_s": init_s, "completed": completed,
           "violations": len(violations), "tokens_out": tokens_out,
           "requests": [{"rid": rid, "prompt_len": len(p), "max_new": mx,
                         "tokens": out[rid].out_tokens[:4]}
                        for rid, p, mx in reqs],
           "prefill_ms": pre, "decode_steps": len(decode_ms),
           "decode_step_ms_median": statistics.median(
               ms for ms, _ in decode_ms),
           "decode_tokens_per_s": dec_tokens / (dec_total / 1e3),
           "launches": launches,
           "launches_per_prefill": {k: v // n_pre for k, v in launches.items()},
           "kernel_ms_per_launch": {k: kernel_ms[k] / max(1, launches[k])
                                    for k in kernel_ms},
           "split_ms": {"prefill": pre_total, "prefill_kernels": kern_total,
                        "prefill_rest": pre_total - kern_total,
                        "decode": dec_total,
                        "other_host": serve_s * 1e3 - pre_total - dec_total},
           "serve_s": serve_s, "max_memory_allocated": peak,
           "memory_allocated_before": mem_before,
           "log_digest": log_digest, "n_txs": n_txs,
           "route_checks": checks, "decode_consistency_rel": decode_rel,
           "decode_rtol": DECODE_RTOL,
           **({"prefill_repeats_bitwise": repeat} if repeat is not None
              else {})}
    emit(row)
    if max(checks["per_layer_err_over_tol"].values()) >= 1.0 or \
            checks["layers_checked"] != {n: per for n, (_, per)
                                         in kernels.items()}:
        fail(f"serve {arch}: per-layer kernel vs plain {checks}")
    if not route_gate(checks):
        fail(f"serve {arch}: kernel route vs plain route logits {checks}")
    if repeat is False:
        fail(f"serve {arch}: one prefill twice gave other bits")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ phase 11
AUDIO = dict(arch="hubert-xlarge", batch=2, frames=1536, calls=3, seed=0)


def phase_encode_audio(card: str) -> dict:
    """hubert-xlarge at full width and depth (48 layers, bf16 weights from
    a seed, ``attn_impl="pallas"``) through ``make_prefill_fn``, the entry
    point of its one applicable shape (an encoder: no decode): frames of
    two sequences of 1536 (about 31 s of audio at 50 frames/s), bf16
    compute, three timed calls; then the route checks of one call."""
    arch = AUDIO["arch"]
    cfg = get_config(arch)
    flags = RunFlags(attn_impl="pallas")
    kernels = {"flash_fwd": (FAK, cfg.n_layers)}
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(AUDIO["seed"])
    t0 = time.perf_counter()
    params = tf.init_params(cfg, gen, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B, S = AUDIO["batch"], AUDIO["frames"]
    batch = {"frames": torch.randn((B, S, cfg.d_model), generator=gen,
                                   device="cuda")}
    prefill = tf.make_prefill_fn(cfg, flags, None, S)
    lg, cache = prefill(params, batch)            # warm-up
    torch.cuda.synchronize()
    FAK.launches = 0
    with EventTimer(FAK, ("flash_fwd",)) as tm:
        ms = []
        for _ in range(AUDIO["calls"]):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            lg, cache = prefill(params, batch)
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
    launches = {"flash_fwd": FAK.launches}
    kern_ms = tm.ms()["flash_fwd"]
    ok = (tuple(lg.shape) == (B, tf.padded_vocab(cfg))
          and bool(torch.isfinite(lg.float()).all())
          and tuple(cache["k"].shape) == (cfg.n_layers, B, S, cfg.n_kv_heads,
                                          cfg.head_dim))
    del cache
    checks = route_checks(cfg, flags, prefill, params, batch, kernels)
    row = {"phase": "encode_audio", "card": card, "arch": arch,
           "config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                      "n_heads": cfg.n_heads, "head_dim": cfg.head_dim,
                      "d_ff": cfg.d_ff, "causal": cfg.causal,
                      "params": sum(p.numel() for p in leaves(params))},
           "flags": dataclasses.asdict(flags), "shape": AUDIO,
           "reduced": [], "init_s": init_s, "prefill_ms": ms,
           "prefill_ms_median": statistics.median(ms),
           "frames_per_s": B * S / (statistics.median(ms) / 1e3),
           "launches": launches,
           "kernel_ms_per_call": kern_ms / AUDIO["calls"],
           "kernel_ms_per_launch": kern_ms / max(1, launches["flash_fwd"]),
           "outputs_ok": ok, "route_checks": checks}
    emit(row)
    if not ok:
        fail(f"encode_audio: misshapen or non-finite outputs {row}")
    if launches["flash_fwd"] != cfg.n_layers * AUDIO["calls"]:
        fail(f"encode_audio: launches {launches}")
    if max(checks["per_layer_err_over_tol"].values()) >= 1.0 or \
            checks["layers_checked"] != {"flash_fwd": cfg.n_layers}:
        fail(f"encode_audio: per-layer kernel vs plain {checks}")
    if not route_gate(checks):
        fail(f"encode_audio: kernel route vs plain route logits {checks}")
    del params, prefill, lg
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ phase 12
CLUSTER = dict(arch="llama3.2-1b", n_devices=2, runs=2)


def phase_cluster(card: str) -> dict:
    """``ClusterServingEngine`` on the card: llama3.2-1b at full width and
    depth (bf16 weights from a seed, ``attn_impl="pallas"``) on two
    modeled devices sharing the weights and the prefill / decode
    callables, the serving phases' eight requests through the front CSR
    doorbell (prompt uploads and token writebacks contending on the
    modeled host channel).  Run twice: the first run counts B2's launches;
    the second, after ``reset``, holds every launch against the plain
    version; both give the same tokens and transaction-log digest.  The
    cluster goldens are regenerated in phase ``golden``."""
    from repro_torch.serving import ClusterServingEngine
    t_phase = time.perf_counter()
    cfg = get_config(CLUSTER["arch"])
    flags = RunFlags(attn_impl="pallas")
    gc.collect()
    torch.cuda.empty_cache()
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            dtype=torch.bfloat16)
    clu = ClusterServingEngine(cfg, params, n_devices=CLUSTER["n_devices"],
                               flags=flags, device="cuda",
                               **{k: SERVE[k] for k in ("max_slots",
                                                        "max_len",
                                                        "prompt_pad",
                                                        "batching")})
    reqs = serve_requests(cfg)
    runs, chk = [], KernelChecks(["flash_fwd"])
    for i in range(CLUSTER["runs"]):
        clu.reset(None)
        FAK.launches = 0
        t = time.perf_counter()
        if i == 0:
            drive_doorbell(clu, reqs)
        else:
            with chk.swap():
                drive_doorbell(clu, reqs)
        torch.cuda.synchronize()
        runs.append({"wall_s": time.perf_counter() - t,
                     "launches": FAK.launches, "digest": clu.digest(),
                     "completed": clu.completed,
                     "violations": len(clu.violations),
                     "tokens": {rid: list(r.out_tokens)
                                for rid, r in clu.requests.items()},
                     "placement": dict(clu.placement),
                     "host_channel": clu.fabric_stats().summary(),
                     "front_txs": clu.log.n_txs})
    launches = {"flash_fwd": runs[0]["launches"]}
    same = (runs[0]["digest"] == runs[1]["digest"]
            and runs[0]["tokens"] == runs[1]["tokens"])
    want_launches = cfg.n_layers * len(reqs)
    row = {"phase": "cluster", "card": card, "arch": CLUSTER["arch"],
           "n_devices": CLUSTER["n_devices"], "serve": SERVE,
           "flags": dataclasses.asdict(flags), "reduced": [],
           "runs": [{k: v for k, v in r.items() if k != "tokens"}
                    for r in runs],
           "tokens_out": sum(len(v) for v in runs[0]["tokens"].values()),
           "same_digest_and_tokens": same, "launches": launches,
           "launches_checked": chk.n_checked["flash_fwd"],
           "per_launch_err_over_tol": chk.worst["flash_fwd"],
           "attn_out_max_abs_err": chk.out_abs[0],
           "attn_out_max_abs_plain": chk.out_abs[1],
           "phase_s": time.perf_counter() - t_phase}
    emit(row)
    if not same or any(r["completed"] != len(reqs) or r["violations"]
                       for r in runs):
        fail(f"cluster: runs differ or incomplete {row}")
    if runs[0]["launches"] != want_launches or \
            chk.n_checked["flash_fwd"] != want_launches or \
            chk.worst["flash_fwd"] >= 1.0:
        fail(f"cluster: launches / per-launch checks {row}")
    del clu, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------- main
# ------------------------------------------------------------ phase 13
# The multi-device layer on the one card.  A one-rank NCCL group carries
# the sharded Trainer and ServingEngine (every mesh dim of one rank: the
# sharded code runs, nothing is split); two spawned ranks on cuda:0 over
# gloo (NCCL takes one rank a card) carry the two regions that split work
# over the model axis with all-reduces only: the expert-parallel layer and
# the vocab-parallel embedding.  Gloo reduces CUDA tensors only for a few
# ops and types: the collectives stage the bytes through host memory
# (``sharding/comm.py``; the row prints how many).
SHARDED_MOE_TOL = 2.0 ** -5       # bf16 MoE layer out, x max(1, max|plain|)


def host_profile(fn, top: int = 8) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (CPU and CUDA): the
    host's self time and op count, the device's kernel time, and the ops
    with the most host self time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    ka = prof.key_averages()
    dev = sum(getattr(e, "self_device_time_total", 0) for e in ka)
    ranked = sorted(ka, key=lambda e: -e.self_cpu_time_total)[:top]
    return {"wall_ms": wall * 1e3,
            "host_self_ms": sum(e.self_cpu_time_total for e in ka) / 1e3,
            "device_ms": dev / 1e3, "host_ops": sum(e.count for e in ka),
            "top_host": [[e.key, e.count, e.self_cpu_time_total / 1e3]
                         for e in ranked]}


def sharded_train(card: str) -> dict:
    """Three steps of llama3.2-1b (``LLAMA``) through the unsharded
    Trainer, then through ``Trainer(mesh (1, 1), ctx)``, from the same
    state and batches.  The checkpoint writes are train_llama's
    measurement: here they are left out."""
    from repro_torch.launch.mesh import make_ctx, make_test_mesh
    cfg = get_config(LLAMA["arch"])
    L = cfg.n_layers
    flags = RunFlags(attn_impl="pallas", microbatches=1)
    opt = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=LLAMA["steps"])
    mesh = make_test_mesh((1, 1)).bind("cuda")
    ckpt = Path(tempfile.mkdtemp(prefix="ckpt_", dir=_build.BUILD_DIR))
    runs = {}
    for name, kw in (("unsharded", {}),
                     ("sharded", {"mesh": mesh, "ctx": make_ctx(mesh)})):
        gc.collect()
        torch.cuda.empty_cache()
        tr = Trainer(cfg, TrainerConfig(
            seq_len=LLAMA["seq_len"], global_batch=LLAMA["global_batch"],
            steps=LLAMA["steps"], ckpt_dir=str(ckpt), seed=LLAMA["seed"]),
            flags, opt, device="cuda", **kw)
        tr.ckpt.save = lambda *a, **k: None
        state = tr.init_state()
        kinds = {type(x).__name__ for x in leaves(state)}
        torch.cuda.synchronize()
        FAK.launches = FAK.dkdv_launches = FAK.dq_launches = 0
        t = time.perf_counter()
        state, step = tr.train(state=state)
        torch.cuda.synchronize()
        runs[name] = {
            "train_s": time.perf_counter() - t, "leaf_types": sorted(kinds),
            "launches": attn_launches(),
            "loss": [r["loss"] for r in tr.metrics_log],
            "grad_norm": [r["grad_norm"] for r in tr.metrics_log],
            "step_ms": [r["step_time"] * 1e3 for r in tr.metrics_log]}
        # one more step, profiled: where the context's extra host time goes
        batch = {k: torch.from_numpy(v).cuda() for k, v in
                 tr.dataset.batch(LLAMA["steps"]).items()}
        runs[name]["profiled_step"] = host_profile(
            lambda: tr._step_fn(state, batch))
        del tr, state, batch
    shutil.rmtree(ckpt, ignore_errors=True)
    a, b = runs["unsharded"], runs["sharded"]
    bitwise = a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    close = all(abs(x - y) <= 1e-5 * abs(y) for key in ("loss", "grad_norm")
                for x, y in zip(b[key], a[key]))
    want = {"flash_fwd": 2 * L * LLAMA["steps"],
            "flash_dkdv": L * LLAMA["steps"], "flash_dq": L * LLAMA["steps"]}
    out = {"runs": runs, "bitwise": bitwise, "rtol": 1e-5,
           "zero_level": 1, "mesh": [1, 1]}
    if len(b["loss"]) != LLAMA["steps"] or not close or \
            a["launches"] != want or b["launches"] != want or \
            b["leaf_types"] != ["DTensor"]:
        fail(f"sharded train: {out}")
    return out


def sharded_serve(card: str) -> dict:
    """moonshot-v1-16b-a3b at full width and depth under
    ``moe_mode="ep_shardmap"`` through ``ServingEngine(ctx=...)`` on the
    one-rank group: serve_moe's eight requests give serve_moe's tokens;
    one prefill of the longest prompt makes the routing decisions of the
    unsharded pjit layer."""
    from repro_torch.launch.mesh import make_ctx, make_test_mesh
    arch = "moonshot-v1-16b-a3b"
    cfg = get_config(arch)
    ctx = make_ctx(make_test_mesh((1, 1)).bind("cuda"))
    flags = RunFlags(attn_impl="pallas", moe_mode="ep_shardmap")
    gc.collect()
    torch.cuda.empty_cache()
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            dtype=torch.bfloat16)
    opts = {k: SERVE[k] for k in ("max_slots", "max_len", "prompt_pad",
                                  "batching")}
    eng = ServingEngine(cfg, params, flags=flags, ctx=ctx, device="cuda",
                        **opts)
    reqs = serve_requests(cfg)
    decode_ms, decode_step = [], eng._decode_step

    def timed_decode():
        t = time.perf_counter()
        decode_step()
        decode_ms.append((time.perf_counter() - t) * 1e3)
    eng._decode_step = timed_decode
    FAK.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    drive_doorbell(eng, reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t
    launches = {"flash_fwd": FAK.launches}
    eng._decode_step = decode_step
    got = {r.rid: list(r.out_tokens) for r in eng.requests.values()}
    kinds = sorted({type(x).__name__ for x in leaves(eng.params)}
                   | {type(x).__name__ for x in leaves(eng.cache)})
    # decode steps of the idle batch (every slot computed) on three
    # engines over the same weights: without a context (the pjit layer,
    # serve_moe's), with the context and the pjit layer, with the context
    # and the expert-parallel layer: five timed (host clock to the argmax
    # on the host), then one profiled
    engines = {
        "unsharded": ServingEngine(cfg, params, flags=flags, device="cuda",
                                   **opts),
        "sharded_pjit": ServingEngine(
            cfg, params, flags=RunFlags(attn_impl="pallas"), ctx=ctx,
            device="cuda", **opts),
        "sharded_ep": eng}
    profiles = {}
    for name, e in engines.items():
        e._decode_step()                              # a first call
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            e._decode_step()
            times.append((time.perf_counter() - t0) * 1e3)
        profiles[name] = {"decode_ms": times,
                          "decode_ms_median": statistics.median(times),
                          **host_profile(e._decode_step)}
    del eng, engines, e
    gc.collect()
    torch.cuda.empty_cache()
    batch = route_batch(cfg, reqs[0][1])
    logs = []
    for f, c in ((RunFlags(attn_impl="pallas"), None), (flags, ctx)):
        with RouterLog() as log:
            tf.make_prefill_fn(cfg, f, c, SERVE["max_len"])(params, batch)
        logs.append(log)
    flips = route_flips(logs[0], logs[1])
    del params, batch, logs
    gc.collect()
    torch.cuda.empty_cache()
    same = got == SERVED.get(arch)
    out = {"arch": arch, "flags": dataclasses.asdict(flags), "mesh": [1, 1],
           "serve_s": serve_s, "decode_steps": len(decode_ms),
           "decode_step_ms_median": statistics.median(decode_ms),
           "decode_profile": profiles, "launches": launches,
           "tokens_equal_serve_moe": same, "routes": flips,
           "leaf_types": kinds}
    if not same or flips["flipped_tokens"] or not flips["same_calls"] or \
            launches["flash_fwd"] != cfg.n_layers * len(reqs) or \
            kinds != ["DTensor"]:
        fail(f"sharded serve: {out}")
    return out


def _two_rank_worker(rank: int, store: str, result: str) -> None:
    """One of the two ranks on cuda:0 (spawned): mesh (data 1, model 2)
    over gloo."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_ctx, make_test_mesh
    from repro_torch.sharding import comm
    from repro_torch.sharding.ep import moe_apply_ep
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    try:
        # the DeviceMesh (DTensor layouts) is not used by these two
        # regions: it lives on the host, the groups carry CUDA tensors
        ctx = make_ctx(make_test_mesh((1, 2)).bind("cpu"))
        cfg = get_config("moonshot-v1-16b-a3b")
        dev = torch.device("cuda", 0)
        gen = torch.Generator(device=dev).manual_seed(0)
        table = torch.randn((tf.padded_vocab(cfg), cfg.d_model), generator=gen,
                            device=dev).to(torch.bfloat16)
        w = moe_lib.moe_init(gen, cfg, 1, torch.bfloat16)
        w = {k: v[0] for k, v in w.items()}
        prompt = torch.from_numpy(serve_requests(cfg)[0][1]).to(dev)
        row = {"rank": rank, "tokens": int(prompt.numel())}
        with torch.no_grad():
            emb = tf.embed_lookup(cfg, {"embed": table}, prompt[None], ctx)
            row["embed_bitwise"] = bool(torch.equal(emb[0], table[prompt]))
            x = torch.nn.functional.rms_norm(emb[0].float(), (cfg.d_model,)
                                             ).to(torch.bfloat16)
            with RouterLog() as plain_log:
                want, want_aux = moe_lib.moe_apply(w, x, cfg)
            with RouterLog() as ep_log:
                got, aux = moe_apply_ep(w, x, cfg, ctx)
            # the pjit layer with this rank's experts (the reference's
            # rule puts them on the model axis)
            El = cfg.moe.n_experts // ctx.msize
            e0 = ctx.model_rank * El
            wl = {k: v if k == "router" else v[e0:e0 + El].contiguous()
                  for k, v in w.items()}
            with RouterLog() as pjit_log:
                got_p, aux_p = tf._moe_tokens(
                    cfg, RunFlags(moe_mode="pjit"), ctx, wl, x)
            torch.cuda.synchronize()
            err_p = float((got_p.float() - want.float()).abs().max())
            err = float((got.float() - want.float()).abs().max())
            ref = max(1.0, float(want.float().abs().max()))
            row.update(max_abs_err=err, err_over_tol=err / (
                SHARDED_MOE_TOL * ref), tol=SHARDED_MOE_TOL,
                exact_share=float((got == want).float().mean()),
                aux=float(aux), plain_aux=float(want_aux),
                routes=route_flips(plain_log, ep_log),
                pjit={"max_abs_err": err_p,
                      "err_over_tol": err_p / (SHARDED_MOE_TOL * ref),
                      "aux": float(aux_p),
                      "routes": route_flips(plain_log, pjit_log)},
                local_experts=cfg.moe.n_experts // ctx.msize,
                host_staged=dict(comm.HOST_STAGED),
                out_dtype=str(got.dtype), device=str(got.device))
        Path(result).write_text(json.dumps(row))
    finally:
        dist.destroy_process_group()


def sharded_two_ranks() -> dict:
    import torch.multiprocessing as mp
    work = Path(tempfile.mkdtemp(prefix="two_rank_", dir=_build.BUILD_DIR))
    t = time.perf_counter()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_two_rank_worker,
                         args=(r, str(work / "store"),
                               str(work / f"rank{r}.json")))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
        if p.is_alive():
            p.kill()
            p.join()
    rows = []
    for r, p in enumerate(procs):
        f = work / f"rank{r}.json"
        if p.exitcode != 0 or not f.exists():
            fail(f"sharded two ranks: rank {r} exit code {p.exitcode}")
        rows.append(json.loads(f.read_text()))
    shutil.rmtree(work, ignore_errors=True)
    out = {"note": "two ranks share one card (cuda:0) over gloo: this "
                   "checks the collectives on CUDA tensors, not scaling",
           "mesh": [1, 2], "wall_s": time.perf_counter() - t, "ranks": rows}
    for row in rows:
        if not row["embed_bitwise"] or row["err_over_tol"] >= 1.0 or \
                row["routes"]["flipped_tokens"] or \
                not row["routes"]["same_calls"] or \
                row["aux"] != row["plain_aux"] or \
                row["pjit"]["err_over_tol"] >= 1.0 or \
                row["pjit"]["routes"]["flipped_tokens"] or \
                not row["pjit"]["routes"]["same_calls"] or \
                row["pjit"]["aux"] != row["plain_aux"] or \
                not row["device"].startswith("cuda"):
            fail(f"sharded two ranks: {out}")
    return out


# the two-rank serving, fed the unsharded engine's tokens at every decode
# step (teacher forcing): each logits row within LOGIT_TOL x max|logit| of
# the unsharded row of the same step (bf16: the split sums round
# differently; 16 steps of bf16's 2^-8), its argmax the unsharded token
# unless the unsharded top-2 gap is under TOKEN_GAP_TOL of max|logit|
LOGIT_TOL = 2.0 ** -4
TOKEN_GAP_TOL = 2.0 ** -5
TWO_RANK_MESHES = ((1, 2), (2, 1))


def _local_shapes_ok(eng) -> bool:
    """Whether every cache leaf of a sharded engine holds its
    ``cache_specs`` local shape (``Sharding.local_index``)."""
    from repro_torch.sharding.specs import map_specs
    ok = []
    map_specs(lambda sh, t, w: ok.append(tuple(t.to_local().shape) == tuple(
        s.stop - s.start for s in sh.local_index(tuple(w.shape),
                                                 sh.mesh.coordinate()))),
              eng._cache_sh, eng.cache, eng._cache_shape)
    return all(ok)


def _serve_logged(eng, reqs, forced=None) -> dict:
    """Serves ``reqs`` through the CSR doorbell -> {rid: the logits row
    (on the host) of each token it emitted on this rank's rows}.  With
    ``forced`` = (tokens, logits rows) of another engine's run, each
    decode step is fed that run's tokens (teacher forcing), and each row
    is compared with that run's row of the same step instead: {rid:
    [|row - ref| max / max|ref|, whether the argmax is its token, ref's
    top-2 gap / max|ref|]}.  A sharded engine's cache leaves are held to
    their local shapes after every tick (``out["local_shapes_ok"]``)."""
    out = {rid: [] for rid, _, _ in reqs}
    shapes_ok = [True]
    prefill, decode = eng._prefill, eng._decode
    seen = {}

    def keep(rid, row):
        if forced is None:
            out[rid].append(row.cpu())
            return
        j = len(out[rid])
        ref = forced[1][rid][j].to(row.device).float()
        top = ref.topk(2).values
        mx = float(ref.abs().max())
        out[rid].append([float((row.float() - ref).abs().max()) / mx,
                         int(row.argmax()) == forced[0][rid][j],
                         float(top[0] - top[1]) / mx])

    def logged_prefill(p, batch):
        logits, single = prefill(p, batch)
        seen["prefill"] = logits
        return logits, single

    def logged_decode(p, cache, toks):
        if forced is not None:
            toks = torch.tensor(
                [forced[0][r.rid][len(r.out_tokens) - 1] % eng.cfg.vocab_size
                 if r is not None else 0 for r in eng.slots],
                dtype=toks.dtype, device=toks.device)
        logits, cache = decode(p, cache, toks)
        seen["decode"] = logits
        return logits, cache
    admit, step = eng._prefill_admit, eng._decode_step

    def check():
        if eng.ctx is not None:
            shapes_ok[0] = shapes_ok[0] and _local_shapes_ok(eng)

    def logged_admit(slot, req):
        admit(slot, req)
        keep(req.rid, seen["prefill"][0])
        check()

    def logged_step():
        rows = {i: r.rid for i, r in enumerate(eng.slots) if r is not None}
        step()
        lg = seen["decode"]
        lo = 0 if lg.shape[0] == eng.max_slots else \
            eng.ctx.data_rank * lg.shape[0]
        for i, rid in rows.items():
            if lo <= i < lo + lg.shape[0]:
                keep(rid, lg[i - lo])
        check()
    eng._prefill, eng._decode = logged_prefill, logged_decode
    eng._prefill_admit, eng._decode_step = logged_admit, logged_step
    drive_doorbell(eng, reqs)
    out["local_shapes_ok"] = shapes_ok[0]
    return out


def _cache_bytes(tree) -> dict:
    """Bytes of the leaves of ``tree`` (a cache or the weights) that the
    layout splits, whole and on this rank, and of the replicated ones (a
    cache's ``pos``; every leaf of a tree of plain tensors)."""
    out = {"split_whole": 0, "split_local": 0, "replicated": 0}
    for d in leaves(tree):
        loc = d.to_local() if hasattr(d, "to_local") else d
        nb = loc.numel() * loc.element_size()
        if tuple(loc.shape) == tuple(d.shape):
            out["replicated"] += nb
        else:
            out["split_local"] += nb
            out["split_whole"] += d.numel() * loc.element_size()
    return out


def _two_rank_serve_worker(rank: int, store: str, result: str,
                           unsharded: str) -> None:
    """One of two ranks on cuda:0 (spawned): llama3.2-1b served through
    ``ServingEngine(ctx)`` on each mesh of ``TWO_RANK_MESHES``, fed the
    tokens of the unsharded run saved in ``unsharded``; then the split ssm
    run on mesh (1, 2) (``_ssm_rows``)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_ctx, make_test_mesh
    from repro_torch.sharding import comm
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    try:
        cfg = get_config(LLAMA["arch"])
        want = torch.load(unsharded)
        forced = (want["tokens"], want["logits"])
        params = tf.init_params(cfg, torch.Generator(device="cuda")
                                .manual_seed(0), dtype=torch.bfloat16)
        opts = {k: SERVE[k] for k in ("max_slots", "max_len", "prompt_pad",
                                      "batching")}
        rows = []
        for shape in TWO_RANK_MESHES:
            # the DeviceMesh is CUDA's (DTensor.from_local moves a local
            # tensor to its mesh's device type) over gloo groups; no DTensor
            # collective runs: the steps communicate through
            # sharding/comm.py, which stages CUDA tensors through the host
            ctx = make_ctx(make_test_mesh(shape).bind("cuda"))
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            eng = ServingEngine(cfg, params, flags=RunFlags(
                attn_impl="pallas"), ctx=ctx, device="cuda", **opts)
            staged = dict(comm.HOST_STAGED)
            FAK.launches = 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            rows_ = _serve_logged(eng, serve_requests(cfg), forced)
            torch.cuda.synchronize()
            rows.append({
                "mesh": list(shape), "rank": rank,
                "serve_s": time.perf_counter() - t,
                "local_shapes_ok": rows_.pop("local_shapes_ok"),
                "flash_fwd": FAK.launches,
                "tokens": {r.rid: list(r.out_tokens)
                           for r in eng.requests.values()},
                "checks": rows_, "cache_bytes": _cache_bytes(eng.cache),
                "leaf_types": sorted({type(x).__name__
                                      for x in leaves(eng.cache)}),
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "host_staged_calls": comm.HOST_STAGED["calls"]
                - staged["calls"],
                "host_staged_bytes": comm.HOST_STAGED["bytes"]
                - staged["bytes"]})
            del eng
        del params
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        ctx = make_ctx(make_test_mesh((1, 2)).bind("cuda"))
        ssm, _ = _ssm_rows(ctx, want["ssm"])
        Path(result).write_text(json.dumps(
            {"llama": rows, "ssm": ssm,
             "ssm_s": time.perf_counter() - t}))
    finally:
        dist.destroy_process_group()


def forced_summary(checks: dict) -> dict:
    """A teacher-forced run's rows (``_serve_logged``): their count, the
    largest and the median |row - ref| / max|ref|, the steps whose argmax
    is not the unsharded token (with its gap), and the unsharded top-2
    gap / max|logit| at its 1st, 5th and 50th percentiles over the
    rows."""
    rows = [(rid, j, *c) for rid, cs in checks.items()
            for j, c in enumerate(cs)]
    errs = np.array([r[2] for r in rows])
    gaps = np.array([r[4] for r in rows])
    return {"rows": len(rows), "err_over_max": float(errs.max()),
            "err_over_max_median": float(np.median(errs)),
            "argmax_differs": [{"rid": r[0], "step": r[1], "err": r[2],
                                "gap_over_max": r[4]}
                               for r in rows if not r[3]],
            "gap_over_max_p1_p5_p50": [float(np.percentile(gaps, q))
                                       for q in (1, 5, 50)]}


def sharded_serve_two_ranks(card: str) -> dict:
    """llama3.2-1b served without a context here, then by two spawned
    ranks on cuda:0 through ``ServingEngine(ctx)`` on (1, 2) and (2, 1);
    the same two ranks then run the split ssm configs
    (``_ssm_rows``) against their unsharded run here, recorded under
    ``"ssm"``."""
    import torch.multiprocessing as mp
    cfg = get_config(LLAMA["arch"])
    reqs = serve_requests(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = tf.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(0), dtype=torch.bfloat16)
    opts = {k: SERVE[k] for k in ("max_slots", "max_len", "prompt_pad",
                                  "batching")}
    eng = ServingEngine(cfg, params, flags=RunFlags(attn_impl="pallas"),
                        device="cuda", **opts)
    FAK.launches = 0
    t = time.perf_counter()
    logits = _serve_logged(eng, reqs)
    logits.pop("local_shapes_ok")
    torch.cuda.synchronize()
    whole = {"serve_s": time.perf_counter() - t, "flash_fwd": FAK.launches,
             "max_memory_allocated": torch.cuda.max_memory_allocated()
             - base, "cache_bytes": sum(
                 x.numel() * x.element_size() for x in leaves(eng.cache))}
    want = {r.rid: list(r.out_tokens) for r in eng.requests.values()}
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    ssm_whole, ssm_saved = _ssm_rows()
    work = Path(tempfile.mkdtemp(prefix="two_rank_serve_",
                                 dir=_build.BUILD_DIR))
    torch.save({"tokens": want, "logits": {
        rid: torch.stack(rows) for rid, rows in logits.items()},
        "ssm": ssm_saved}, work / "unsharded.pt")
    del logits, ssm_saved
    t = time.perf_counter()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_two_rank_serve_worker,
                         args=(r, str(work / "store"),
                               str(work / f"rank{r}.json"),
                               str(work / "unsharded.pt")))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=900)
        if p.is_alive():
            p.kill()
            p.join()
    ranks = []
    for r, p in enumerate(procs):
        f = work / f"rank{r}.json"
        if p.exitcode != 0 or not f.exists():
            fail(f"sharded two-rank serving: rank {r} exit code "
                 f"{p.exitcode}")
        ranks.append(json.loads(f.read_text()))
    shutil.rmtree(work, ignore_errors=True)
    ssm = _ssm_verdict(ssm_whole, [rk["ssm"] for rk in ranks],
                       max(rk["ssm_s"] for rk in ranks))
    ranks = [rk["llama"] for rk in ranks]
    want_launches = cfg.n_layers * len(reqs)
    runs, bad = [], []
    for i, shape in enumerate(TWO_RANK_MESHES):
        rows = [rk[i] for rk in ranks]
        for row in rows:
            row["tokens"] = {int(k): v for k, v in row["tokens"].items()}
            row["forced"] = forced_summary(row.pop("checks"))
        run = {"mesh": list(shape),
               "ranks_agree": rows[0]["tokens"] == rows[1]["tokens"],
               "ranks": [{k: v for k, v in row.items() if k != "tokens"}
                         for row in rows]}
        runs.append(run)
        if not run["ranks_agree"] or any(
                r["forced"]["err_over_max"] > LOGIT_TOL or any(
                    d["gap_over_max"] >= TOKEN_GAP_TOL
                    for d in r["forced"]["argmax_differs"])
                for r in rows):
            bad.append(f"{shape}: logits or tokens")
        for row in rows:
            cb = row["cache_bytes"]
            if row["flash_fwd"] != want_launches or \
                    not row["local_shapes_ok"] or \
                    2 * cb["split_local"] != cb["split_whole"] or \
                    cb["split_whole"] + cb["replicated"] != \
                    whole["cache_bytes"] or row["leaf_types"] != ["DTensor"]:
                bad.append(f"{shape}: rank {row['rank']}")
    out = {"note": "two ranks share one card (cuda:0) over gloo: this "
                   "checks the sharded serving path, not scaling",
           "arch": LLAMA["arch"], "requests": len(reqs),
           "teacher_forced": True, "logit_tol": LOGIT_TOL,
           "token_gap_tol": TOKEN_GAP_TOL, "unsharded": whole,
           "flash_fwd_per_rank_want": want_launches, "runs": runs,
           "ssm": ssm, "wall_s": time.perf_counter() - t}
    if bad:
        fail(f"sharded two-rank serving {bad}: {out}")
    return out


# rwkv6-7b and zamba2-2.7b at train_ssm's depths (full width) on two ranks
# of mesh (1, 2) sharing cuda:0 over gloo: their ssm layers on each rank's
# heads (the WKV-6 / SSD scans see half of them), against the same state,
# batches and request without a context.  SSM_TRAIN_STEPS fp32 train steps
# (the comparison then sees the split, not bf16 rounding): each step's
# loss and grad norm within SSM_TWO_RANK_RTOL, as the sharded llama steps
# (the second step's loss reads the first update); after the first step,
# each leaf's norm of both moments (its clipped gradient g: m = (1 - b1) g,
# v = (1 - b2) g^2), summed over the ranks where the leaf is split, within
# SSM_LEAF_RTOL of the unsharded leaf's (a leaf whose unsharded norm is
# under 1e-3 of the largest leaf's is held to that floor).  One served
# request of serve_requests' 1536 tokens, its prefill and
# SSM_TWO_RANK_DECODE decode steps fed the unsharded engine's tokens, held
# to LOGIT_TOL / TOKEN_GAP_TOL.
SSM_TWO_RANK_RTOL = 1e-5
SSM_LEAF_RTOL = 1e-4
SSM_TRAIN_STEPS = 2
SSM_TWO_RANK_DECODE = 8


def _ssm_two_rank_cfg(arch: str):
    return dataclasses.replace(get_config(arch), **TRAIN_SSM[arch])


def _ssm_two_rank_inputs(cfg):
    """(train state on cuda, its batches, the bf16 serving weights, the
    one request) of ``cfg``, each drawn from its seed."""
    dev = torch.device("cuda")
    state = make_train_state(cfg, torch.Generator(device=dev).manual_seed(
        TRAIN_SSM_SHAPE["seed"]))
    data = SyntheticLMDataset(cfg.vocab_size, TRAIN_SSM_SHAPE["seq_len"],
                              TRAIN_SSM_SHAPE["global_batch"],
                              seed=TRAIN_SSM_SHAPE["seed"])
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in data.batch(i).items()}
               for i in range(SSM_TRAIN_STEPS)]
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dtype=torch.bfloat16)
    rid, prompt, _ = serve_requests(cfg)[0]
    return state, batches, params, [(rid, prompt, SSM_TWO_RANK_DECODE + 1)]


SSM_TRAIN_FLAGS = RunFlags(attn_impl="pallas", compute_dtype="float32")
SSM_OPT = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=1)


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _moment_sumsq(state: dict) -> dict:
    """{"m/<leaf>" and "v/<leaf>": [the sum of squares of this rank's part
    of the moment, whether that part is a split of the leaf]}."""
    out = {}
    for key in ("m", "v"):
        for path, t in paths(state[key]):
            loc = t.to_local() if hasattr(t, "to_local") else t
            out[f"{key}/{path}"] = [float(loc.double().square().sum()),
                                    tuple(loc.shape) != tuple(t.shape)]
    return out


def _ssm_rows(ctx=None, want: dict = None) -> tuple:
    """For each config of ``TRAIN_SSM``: ``SSM_TRAIN_STEPS`` fp32 train
    steps, then its request served; the scans' launches counted from 0
    around each.  Without ``ctx``, on this process's card: (rows, {arch:
    the tokens and logits rows of its request}).  With ``ctx`` (one rank
    of ``_two_rank_serve_worker``, mesh (1, 2)): the state placed by the
    context's layout and the request fed ``want``'s tokens; (rows,
    None)."""
    from repro_torch.sharding import comm
    from repro_torch.sharding.specs import place
    opts = {k: SERVE[k] for k in ("max_slots", "max_len", "prompt_pad",
                                  "batching")}
    rows, saved = [], {}
    for arch in TRAIN_SSM:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = _ssm_two_rank_cfg(arch)
        state, batches, params, reqs = _ssm_two_rank_inputs(cfg)
        gsh = None
        if ctx is not None:
            _, st_sh, _, _, gsh = steps_lib.train_shardings(
                cfg, ShapeConfig("t", TRAIN_SSM_SHAPE["seq_len"],
                                 TRAIN_SSM_SHAPE["global_batch"], "train"),
                ctx.mesh, ctx)
            state = place(state, st_sh)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step_fn = make_train_step(cfg, SSM_TRAIN_FLAGS, ctx, SSM_OPT,
                                  grad_shardings=gsh)
        staged = dict(comm.HOST_STAGED)
        WKVK.launches = SSDK.launches = 0
        FAK.launches = FAK.dkdv_launches = FAK.dq_launches = 0
        steps, moments = [], None
        for batch in batches:
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step_fn(state, batch)
            torch.cuda.synchronize()
            steps.append({"step_s": time.perf_counter() - t,
                          "loss": float(m["loss"]),
                          "grad_norm": float(m["grad_norm"])})
            if moments is None:
                moments = _moment_sumsq(state)
        train = {"steps": steps, "moments": moments,
                 "launches": ssm_launches(),
                 "max_memory_allocated": torch.cuda.max_memory_allocated(),
                 "host_staged_calls": comm.HOST_STAGED["calls"]
                 - staged["calls"]}
        del state, m, step_fn, batches
        gc.collect()
        torch.cuda.empty_cache()
        eng = ServingEngine(cfg, params, flags=SERVE_ARCHS[arch]["flags"],
                            ctx=ctx, device="cuda", **opts)
        with torch.no_grad():
            form = tf._compute_params(cfg, eng.flags, tf.cast_params(
                eng.params), ctx)
        staged = dict(comm.HOST_STAGED)
        WKVK.launches = SSDK.launches = 0
        FAK.launches = FAK.dkdv_launches = FAK.dq_launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        checks = _serve_logged(eng, reqs, None if want is None else (
            want[arch]["tokens"], want[arch]["logits"]))
        torch.cuda.synchronize()
        serve = {"serve_s": time.perf_counter() - t,
                 "local_shapes_ok": checks.pop("local_shapes_ok"),
                 "launches": ssm_launches(),
                 "tokens": {r.rid: list(r.out_tokens)
                            for r in eng.requests.values()},
                 "cache_bytes": _cache_bytes(eng.cache),
                 "weight_bytes": _cache_bytes(eng.params),
                 "compute_weight_bytes": _nbytes(leaves(form)),
                 "host_staged_calls": comm.HOST_STAGED["calls"]
                 - staged["calls"]}
        if ctx is None:
            saved[arch] = {"tokens": serve["tokens"],
                           "logits": {rid: torch.stack(rs).cpu()
                                      for rid, rs in checks.items()}}
        else:
            serve["checks"] = checks
        rows.append({"arch": arch, "rank": None if ctx is None
                     else ctx.model_rank, "train": train, "serve": serve})
        del eng, params, form, checks
    gc.collect()
    torch.cuda.empty_cache()
    return rows, (saved if ctx is None else None)


def _leaf_errors(whole: dict, ranks: list) -> dict:
    """{moment leaf: |its norm over the ranks - the unsharded norm| / the
    larger of the unsharded norm and 1e-3 of the largest leaf's of that
    moment}; a leaf that one rank holds split and the other whole, or whose
    whole copies differ between the ranks by more than ``SSM_LEAF_RTOL``,
    reads inf."""
    top = {k: max(math.sqrt(s) for name, (s, _) in whole.items()
                  if name.startswith(k)) for k in ("m/", "v/")}
    out = {}
    for name, (s, _) in whole.items():
        parts = [rk[name] for rk in ranks]
        split = {p[1] for p in parts}
        if split == {True}:
            got = sum(p[0] for p in parts)
        elif split == {False} and abs(math.sqrt(parts[0][0]) - math.sqrt(
                parts[1][0])) <= SSM_LEAF_RTOL * math.sqrt(parts[0][0]):
            got = parts[0][0]
        else:
            out[name] = math.inf
            continue
        ref = math.sqrt(s)
        out[name] = abs(math.sqrt(got) - ref) / max(ref, 1e-3 * top[name[:2]])
    return out


def _ssm_verdict(whole: list, ranks: list, seconds: float) -> dict:
    """The split ssm run's record from the unsharded rows (``whole``) and
    each rank's (``_ssm_rows``); fails the phase on a missed gate."""
    total = lambda b: b["split_whole"] + b["replicated"]  # noqa: E731
    runs, bad, launches = [], [], {k: 0 for k in ssm_launches()}
    for i, arch in enumerate(TRAIN_SSM):
        rows, w = [rk[i] for rk in ranks], whole[i]
        wt = w["train"]
        leaf = _leaf_errors(wt["moments"], [r["train"]["moments"]
                                            for r in rows])
        worst = max(leaf, key=leaf.get)
        for row in rows:
            tr, sv = row["train"], row["serve"]
            sv["tokens"] = {int(k): v for k, v in sv["tokens"].items()}
            sv["forced"] = forced_summary(sv.pop("checks"))
            for part in (tr, sv):
                for k, n in part["launches"].items():
                    launches[k] += n
            cb, wb = sv["cache_bytes"], sv["weight_bytes"]
            if len(tr["steps"]) != len(wt["steps"]) or any(
                    abs(s[k] - u[k]) > SSM_TWO_RANK_RTOL * abs(u[k])
                    for s, u in zip(tr["steps"], wt["steps"])
                    for k in ("loss", "grad_norm")) or \
                    tr["launches"] != wt["launches"] or \
                    sv["launches"] != w["serve"]["launches"] or \
                    sv["forced"]["err_over_max"] > LOGIT_TOL or any(
                        d["gap_over_max"] >= TOKEN_GAP_TOL
                        for d in sv["forced"]["argmax_differs"]) or \
                    not sv["local_shapes_ok"] or \
                    2 * cb["split_local"] != cb["split_whole"] or \
                    total(cb) != total(w["serve"]["cache_bytes"]) or \
                    2 * wb["split_local"] != wb["split_whole"] or \
                    total(wb) != total(w["serve"]["weight_bytes"]) or \
                    sv["compute_weight_bytes"] > \
                    wb["split_local"] + wb["replicated"]:
                bad.append(f"{arch}: rank {row['rank']}")
            tr["moments_split"] = sum(v[1] for v in tr.pop(
                "moments").values())
        if leaf[worst] > SSM_LEAF_RTOL:
            bad.append(f"{arch}: moment leaf {worst} {leaf[worst]}")
        wt["moments"] = len(wt["moments"])
        runs.append({"arch": arch, "reduced": [
            f"n_layers {get_config(arch).n_layers} -> "
            f"{TRAIN_SSM[arch]['n_layers']}"],
            "ranks_agree": rows[0]["serve"]["tokens"]
            == rows[1]["serve"]["tokens"],
            "leaf_err_max": leaf[worst], "leaf_err_max_at": worst,
            "unsharded": w, "ranks": rows})
        if not runs[-1]["ranks_agree"]:
            bad.append(f"{arch}: ranks disagree")
    out = {"note": "two ranks share one card (cuda:0) over gloo: this "
                   "checks the split ssm layers, not scaling",
           "mesh": [1, 2], "train_flags": dataclasses.asdict(SSM_TRAIN_FLAGS),
           "train_steps": SSM_TRAIN_STEPS, "train_rtol": SSM_TWO_RANK_RTOL,
           "leaf_rtol": SSM_LEAF_RTOL, "decode_steps":
           SSM_TWO_RANK_DECODE, "logit_tol": LOGIT_TOL,
           "token_gap_tol": TOKEN_GAP_TOL, **TRAIN_SSM_SHAPE,
           "runs": runs, "launches": launches, "ranks_s": seconds}
    if bad:
        fail(f"sharded two-rank ssm {bad}: {out}")
    return out


def phase_sharded(card: str) -> dict:
    import torch.distributed as dist
    t = time.perf_counter()
    store = Path(tempfile.mkdtemp(prefix="pg_", dir=_build.BUILD_DIR))
    dist.init_process_group("nccl", store=dist.FileStore(str(store / "s"), 1),
                            rank=0, world_size=1)
    try:
        train = sharded_train(card)
        serve = sharded_serve(card)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    two = sharded_two_ranks()
    print(f"sharded: two spawned ranks shared one card (cuda:0) over gloo; "
          f"their collectives staged "
          f"{two['ranks'][0]['host_staged']['calls']} calls through host "
          f"memory", file=sys.stderr)
    two_serve = sharded_serve_two_ranks(card)
    two_ssm = two_serve["ssm"]
    row = {"phase": "sharded", "card": card, "train": train, "serve": serve,
           "two_ranks": two, "two_rank_serve": two_serve,
           "seconds": time.perf_counter() - t}
    emit(row)
    return {**{k: v + two_ssm["launches"][k]
               for k, v in train["runs"]["sharded"]["launches"].items()},
            "serve_flash_fwd": serve["launches"]["flash_fwd"],
            "two_rank_serve_flash_fwd": sum(
                r["flash_fwd"] for run in two_serve["runs"]
                for r in run["ranks"]),
            "wkv_scan": two_ssm["launches"]["wkv_scan"],
            "ssd_scan": two_ssm["launches"]["ssd_scan"]}


# ----------------------------------------------------------------- dryrun
# the dry run (launch/dryrun.py) against the card: llama3.2-1b's train step
# at train_llama's batch with the dry run's flags, counted on the card and
# on meta tensors; the step timed against its roofline bound; the meta
# run's peak against the allocator's; and two production-size cells of the
# dry run, started in subprocesses at the top of the script (they need no
# card) and collected here
DRYRUN_FLAGS = RunFlags(attn_impl="chunked", microbatches=1, remat=True)
DRYRUN_CELLS = (("llama3.2-1b", "train_4k"), ("rwkv6-7b", "prefill_32k"))
DRYRUN_TAG = "chip_smoke"
DRYRUN_TIMED = 5
MEM_FLOOR = 0.9          # the estimate may not fall below 0.9 x the peak


def start_dryrun_cells() -> list:
    """The dry run's production cells, one process each, all at once; no
    card (CUDA_VISIBLE_DEVICES empty), one thread each."""
    import atexit
    import threading
    log_dir = _build.BUILD_DIR / "dryrun"
    log_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = []
    for arch, shape in DRYRUN_CELLS:
        log = open(log_dir / f"{arch}__{shape}.log", "w")
        p = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
             "--shape", shape, "--tag", DRYRUN_TAG],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
        cell = {"arch": arch, "shape": shape, "proc": p, "log": log,
                "t0": time.perf_counter()}
        # the moment the process ends (its wall time), whenever it is read
        cell["waiter"] = threading.Thread(
            target=lambda c=cell: (c["proc"].wait(),
                                   c.__setitem__("t1", time.perf_counter())),
            daemon=True)
        cell["waiter"].start()
        procs.append(cell)
    atexit.register(lambda: [c["proc"].kill() for c in procs
                             if c["proc"].poll() is None])
    return procs


def first_difference(a: list, b: list):
    """The first (index, entry of a, entry of b) where two op logs part,
    over the ops that cost FLOPs or bytes."""
    a = [e for e in a if e[2] or e[3]]
    b = [e for e in b if e[2] or e[3]]
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i, x, y
    return (min(len(a), len(b)), a[len(b):][:1], b[len(a):][:1]) \
        if len(a) != len(b) else None


def phase_dryrun(card: str, procs: list) -> dict:
    t_phase = time.perf_counter()
    gc.collect()                      # earlier phases' cycles hold tensors
    torch.cuda.empty_cache()
    cfg = get_config(LLAMA["arch"])
    shape = ShapeConfig("train_llama", LLAMA["seq_len"], LLAMA["global_batch"],
                        "train")
    opt = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=10)
    step = make_train_step(cfg, DRYRUN_FLAGS, None, opt)
    gen = torch.Generator(device="cuda").manual_seed(LLAMA["seed"])
    state = make_train_state(cfg, gen)
    data = SyntheticLMDataset(cfg.vocab_size, LLAMA["seq_len"],
                              LLAMA["global_batch"], seed=LLAMA["seed"])
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.batch(0).items()}

    # (a) the step on meta tensors, then on the card, both counted
    meta = lambda t: t.detach().to("meta").requires_grad_(t.requires_grad)
    m_state, m_batch = tree_map(meta, state), tree_map(meta, batch)
    t0 = time.perf_counter()
    est = hp.ProgramCounter(log_ops=True)
    est_args = est.track(m_state, m_batch)
    with est:
        step(m_state, m_batch)
    meta_s = time.perf_counter() - t0
    del m_state, m_batch
    args_bytes = hp.ProgramCounter().track(state, batch)
    # collected now, no earlier garbage is freed inside the measured step
    # (which would lower its peak against the base)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    real = hp.ProgramCounter(log_ops=True)
    with real:
        state, m = step(state, batch)
    torch.cuda.synchronize()
    measured_peak = torch.cuda.max_memory_allocated() - base + args_bytes
    pe, pr = est.profile(), real.profile()
    count = {"meta": {"flops": pe.flops, "traffic_bytes": pe.traffic_bytes,
                      "dot_count": pe.dot_count, "ops": len(est.ops),
                      "seconds": meta_s},
             "cuda": {"flops": pr.flops, "traffic_bytes": pr.traffic_bytes,
                      "dot_count": pr.dot_count, "ops": len(real.ops)},
             "flop_counter_flops": {"meta": est.flop_counter_flops,
                                    "cuda": real.flop_counter_flops}}
    emit({"phase": "dryrun", "part": "count", "card": card,
          "config": LLAMA["arch"], "seq_len": LLAMA["seq_len"],
          "batch": LLAMA["global_batch"],
          "flags": dataclasses.asdict(DRYRUN_FLAGS), **count})
    if (pe.flops, pe.traffic_bytes, pe.dot_count) != \
            (pr.flops, pr.traffic_bytes, pr.dot_count):
        fail(f"dryrun: the meta count is not the card's: {count}; first "
             f"difference {first_difference(est.ops, real.ops)}")
    if not np.isfinite(float(m["loss"])):
        fail(f"dryrun: non-finite loss {m}")

    # (b) the measured step against its roofline bound
    times = []
    for i in range(DRYRUN_TIMED + 1):
        b = {k: torch.from_numpy(v).cuda()
             for k, v in data.batch(i + 1).items()}
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        state, m = step(state, b)
        e1.record()
        torch.cuda.synchronize()
        if i:                                   # the first one warms up
            times.append(e0.elapsed_time(e1) / 1e3)
    terms = hp.roofline(pr, dryrun.model_flops(cfg, shape, "train"))
    step_s = statistics.median(times)
    emit({"phase": "dryrun", "part": "roofline", "card": card,
          "step_s_median": step_s, "step_s": times,
          "terms": dataclasses.asdict(terms), "dominant": terms.dominant,
          "bound_s": terms.bound_s, "measured_over_bound": step_s /
          terms.bound_s, "useful_ratio": terms.useful_ratio,
          "roofline_fraction": terms.roofline_fraction,
          "peaks": {"bf16_flops": hp.PEAK_FLOPS_BF16, "hbm_bytes_s": hp.HBM_BW,
                    "nvlink_bytes_s": hp.NVLINK_BW}})

    # (c) the meta run's peak against the allocator's
    memory = {"estimate_peak_bytes": est.peak_bytes,
              "estimate_args_bytes": est_args,
              "measured_peak_bytes": measured_peak, "args_bytes": args_bytes,
              "estimate_over_measured": est.peak_bytes / measured_peak,
              "floor": MEM_FLOOR}
    emit({"phase": "dryrun", "part": "memory", "card": card, **memory})
    if est.peak_bytes < MEM_FLOOR * measured_peak:
        fail(f"dryrun: the memory estimate under-counts: {memory}")
    del state, m
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the production cells, then the roofline twin over their records
    cells = []
    for c in procs:
        rc = c["proc"].wait(timeout=900)
        c["waiter"].join()
        c["log"].close()
        wall = c["t1"] - c["t0"]
        path = dryrun.ART_DIR / (f"{c['arch']}__{c['shape']}__1pod__"
                                 f"{DRYRUN_TAG}.json")
        if rc != 0 or not path.exists():
            fail(f"dryrun: cell {c['arch']}/{c['shape']} rc={rc}: "
                 f"{(_build.BUILD_DIR / 'dryrun').as_posix()}")
        rec = json.loads(path.read_text())
        cells.append(rec)
        emit({"phase": "dryrun", "part": "cell", "arch": c["arch"],
              "shape": c["shape"], "mesh": rec["mesh"], "world": rec["world"],
              "process_wall_s": wall, "lower_s": rec["lower_s"],
              "compile_s": rec["compile_s"], "zero_level": rec["zero_level"],
              "microbatches": rec["flags"]["microbatches"],
              "memory_analysis": rec["memory_analysis"],
              "profile": {k: v for k, v in rec["profile"].items()
                          if k != "warnings"},
              "roofline": rec["roofline"]})
    from benchmarks import roofline_torch
    emit({"phase": "dryrun", "part": "tables",
          "dryrun_table": roofline_torch.render_dryrun_table(cells),
          "roofline_table": roofline_torch.render_roofline_table(cells),
          "seconds": time.perf_counter() - t_phase})
    return {"cells": len(cells)}



def kernel_entry(name, sources, replaces, main_row, rows, launches,
                 path_rows=None) -> dict:
    """``sources`` names the file with the kernel's C entry point first,
    then every other file that implements it; ``launches`` maps each main
    path that runs the kernel to its count there, and the entry's
    ``launches`` is their sum; ``path_rows`` names the rows at the shapes
    another path launches."""
    sources = [sources] if isinstance(sources, str) else sources
    return {"name": name, "route": "cuda", "source": sources[0],
            "sources": sources,
            "replaces": replaces, "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": main_row["max_abs_err"],
            "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            **{k: main_row[k] for k in ("bound_ms_fma", "bound_ms_3xtf32",
                                        "one_rounding_err_over_tol",
                                        "signed_rel_bias",
                                        "device_ms_by_kernel", "host_ms")
               if k in main_row},
            "library_ms": main_row["library_ms"], "tol": main_row["tol"],
            **({"library": main_row["library"]} if "library" in main_row
               else {}),
            "peak": main_row["peak"],
            "main_path_shape": {k: main_row[k] for k in main_row
                                if k in ("shape", "tile", "block", "dtype",
                                         "causal", "window", "chunk",
                                         "kernel_chunk")},
            **({"path_rows": path_rows} if path_rows else {}),
            "shapes": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script measures on the card only",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    # past dynamo's recompile limit a frame would quietly run eagerly,
    # hiding the compiled tier: make that an error instead
    torch._dynamo.config.fail_on_recompile_limit_hit = True
    # every table compiles the one oracle body of its op (matmul or
    # attention) once a shape; with the sweep's shards and the Fig. 5
    # lane's sizes the smoke builds more than dynamo's default 8 graphs of
    # that frame, all of them wanted: raise the limit, keep the error
    for name in ("recompile_limit", "cache_size_limit"):
        if hasattr(torch._dynamo.config, name):
            setattr(torch._dynamo.config, name, 64)
    card = phase_env()
    dryrun_procs = start_dryrun_cells()
    phase_build()
    mm_rows, fa_rows, dkdv_rows, dq_rows, wkv_rows, ssd_rows = phase_kernels()
    mm_launches = phase_coverify_matmul(card, mm_rows)
    fa_launches = phase_coverify_flash(card, fa_rows)
    phase_golden()
    fuzz_launches = phase_fuzz(card)
    fabric = phase_fabric(card)
    sweep = phase_sweep(card)
    replay_launches, storm_engine = phase_replay(card)
    profile_launches = phase_profile(card, storm_engine)
    del storm_engine
    gc.collect()                      # the engine's cycles hold its weights
    torch.cuda.empty_cache()
    campaign_launches = phase_campaign(card)
    drivers = phase_drivers(card)
    train = phase_train_llama(card)
    ssm = phase_train_ssm(card)
    fam = phase_train_families(card)
    rwkv = phase_serve(card, "rwkv6-7b")
    zamba = phase_serve(card, "zamba2-2.7b")
    cluster = phase_cluster(card)
    audio = phase_encode_audio(card)
    vlm = phase_serve(card, "llama-3.2-vision-11b")
    moe = phase_serve(card, "moonshot-v1-16b-a3b")
    sharded = phase_sharded(card)
    phase_dryrun(card, dryrun_procs)
    if mm_launches < 1 or fa_launches < 1 or fuzz_launches < 1 or \
            min(fabric.values()) < 1 or min(sweep.values()) < 1 or \
            replay_launches < 1 or profile_launches < 1 or \
            campaign_launches < 1 or min(drivers.values()) < 1 or \
            min(train.values()) < 1 or \
            min(ssm.values()) < 1 or min(fam.values()) < 1 or \
            min(rwkv.values()) < 1 or \
            min(zamba.values()) < 1 or min(cluster.values()) < 1 or \
            min(audio.values()) < 1 or min(vlm.values()) < 1 or \
            min(moe.values()) < 1 or min(sharded.values()) < 1:
        fail(f"main path missed a kernel: matmul={mm_launches} "
             f"flash={fa_launches} fuzz={fuzz_launches} fabric={fabric} "
             f"sweep={sweep} replay={replay_launches} "
             f"profile={profile_launches} campaign={campaign_launches} "
             f"drivers={drivers} "
             f"train={train} train_ssm={ssm} train_families={fam} "
             f"serve_rwkv6={rwkv} "
             f"serve_zamba2={zamba} cluster={cluster} "
             f"encode_audio={audio} serve_vlm={vlm} serve_moe={moe} "
             f"sharded={sharded}")
    src = "src/repro_torch/kernels/csrc/"
    ref = "src/repro/kernels/"
    emit({"kernels": [
        kernel_entry("systolic_matmul", [src + "systolic_matmul.cu",
                                         src + "systolic_matmul_sm90.cuh",
                                         src + "sm90.cuh"],
                     ref + "systolic_matmul/kernel.py:52",
                     mm_rows[MM_MAIN], mm_rows,
                     {"coverify_matmul": mm_launches, "fuzz": fuzz_launches,
                      "fabric": fabric["systolic_matmul"],
                      "sweep": sweep["systolic_matmul"],
                      "replay": replay_launches, "profile": profile_launches,
                      "campaign": campaign_launches,
                      "drivers": drivers["systolic_matmul"]},
                     {"fuzz": [mm_rows[i] for i in MM_FUZZ],
                      "fabric": [mm_rows[MM_SHARD], mm_rows[MM_SHARD2]],
                      "sweep": [mm_rows[i] for i in
                                (MM_MAIN, *MM_DEVICES_SWEEP,
                                 *MM_FIG5_SWEEP)],
                      "replay": [mm_rows[i] for i in (MM_MAIN, *MM_FUZZ)],
                      "profile": mm_rows[MM_SHARD],
                      "campaign": [mm_rows[i] for i in
                                   (MM_MAIN, MM_CAMPAIGN, *MM_FUZZ)]}),
        kernel_entry("flash_fwd", [src + "flash_fwd.cu",
                                   src + "flash_fwd_tf32_sm90.cuh",
                                   src + "flash_fwd_sm90.cuh",
                                   src + "sm90.cuh"],
                     ref + "flash_attention/kernel.py:109",
                     fa_rows[FA_MAIN], fa_rows,
                     {"coverify_flash": fa_launches,
                      "fabric": fabric["flash_fwd"],
                      "sweep": sweep["flash_fwd"],
                      "drivers": drivers["flash_fwd"],
                      "train_llama": train["flash_fwd"],
                      "train_ssm": ssm["flash_fwd"],
                      "train_families": fam["flash_fwd"],
                      "serve_zamba2": zamba["flash_fwd"],
                      "cluster": cluster["flash_fwd"],
                      "encode_audio": audio["flash_fwd"],
                      "serve_vlm": vlm["flash_fwd"],
                      "serve_moe": moe["flash_fwd"],
                      "sharded": sharded["flash_fwd"]
                      + sharded["serve_flash_fwd"]
                      + sharded["two_rank_serve_flash_fwd"]},
                     {"fabric": fa_rows[FA_SHARD],
                      "sweep": [fa_rows[i] for i in
                                (FA_MAIN, FA_SHARD2, FA_SHARD)],
                      "serve_moe": fa_rows[FA_MOE],
                      "serve_vlm": [fa_rows[FA_VLM], fa_rows[FA_CROSS]],
                      "encode_audio": fa_rows[FA_AUDIO],
                      "train_families": [fa_rows[i] for i in
                                         (FA_MOE, FA_VLM, FA_CROSS,
                                          FA_AUDIO)],
                      "sharded": fa_rows[FA_LOCAL]}),
        kernel_entry("flash_dkdv", [src + "flash_bwd.cu",
                                    src + "flash_dkdv_sm90.cuh",
                                    src + "sm90.cuh"],
                     ref + "flash_attention/kernel.py:186",
                     dkdv_rows[BWD_MAIN], dkdv_rows,
                     {"train_llama": train["flash_dkdv"],
                      "train_ssm": ssm["flash_dkdv"],
                      "train_families": fam["flash_dkdv"],
                      "sharded": sharded["flash_dkdv"]},
                     {"train_families": [dkdv_rows[i]
                                         for i in BWD_FAMILIES]}),
        kernel_entry("flash_dq", [src + "flash_bwd.cu",
                                  src + "flash_dq_sm90.cuh",
                                  src + "sm90.cuh"],
                     ref + "flash_attention/kernel.py:256",
                     dq_rows[BWD_MAIN], dq_rows,
                     {"train_llama": train["flash_dq"],
                      "train_ssm": ssm["flash_dq"],
                      "train_families": fam["flash_dq"],
                      "sharded": sharded["flash_dq"]},
                     {"train_families": [dq_rows[i] for i in BWD_FAMILIES]}),
        kernel_entry("ssd_scan", src + "ssd_scan.cu",
                     ref + "mamba2_scan/kernel.py:84",
                     ssd_rows[SSD_MAIN], ssd_rows,
                     {"train_ssm": ssm["ssd_scan"],
                      "serve_zamba2": zamba["ssd_scan"],
                      "sharded": sharded["ssd_scan"]},
                     {"sharded": ssd_rows[SSD_LOCAL]}),
        kernel_entry("wkv_scan", src + "wkv_scan.cu",
                     ref + "rwkv6_wkv/kernel.py:62",
                     wkv_rows[WKV_MAIN], wkv_rows,
                     {"train_ssm": ssm["wkv_scan"],
                      "serve_rwkv6": rwkv["wkv_scan"],
                      "sharded": sharded["wkv_scan"]},
                     {"sharded": wkv_rows[WKV_LOCAL]}),
    ]})
    emit({"phase": "done", "card": card,
          "seconds": time.perf_counter() - t_start})
    emit({"nvidia_smi": card})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
