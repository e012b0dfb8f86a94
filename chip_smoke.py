#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``src/repro_torch/kernels/csrc`` into
``build/`` (one ``nvcc`` per source, all started together), holds each
kernel against its plain PyTorch version and its ``ref.py`` oracle on the
card, and drives the port's three paths:

  * co-verification — ``coverify()`` over the oracle / interpret / compiled
    backends for the systolic matmul and the flash-attention forward,
    through the congestion-arbitrated bridge (``compiled``: the oracle's
    maths through ``torch.compile``, built once before the timed
    iterations, its build seconds on a line of their own), then the
    committed single-device golden trace and counter stream regenerated
    byte for byte;
  * training — llama3.2-1b at full width (16 layers, seq 2048, batch 2,
    bf16 compute, ``attn_impl="pallas"``): one loss + backward with the
    kernels against the naive attention, then three ``Trainer`` steps with
    checkpointing, counting the attention kernels' launches; then
    rwkv6-7b (2 layers) and zamba2-2.7b (6 layers) at full width, one
    sequence of 1024 tokens: one loss + backward with the scans' kernels
    on the forward against the same with the scans through the twins of
    the reference's lax scans, and one timed ``make_train_step`` step;
  * serving — rwkv6-7b and zamba2-2.7b at full width and depth (bf16
    weights) through ``ServingEngine``: eight requests rung in through the
    CSR doorbell, prefill on the WKV-6 (rwkv6) and SSD + attention
    (zamba2) kernels, batched decode; each served prefill's scan inputs
    re-run through the plain versions layer by layer, the kernel route's
    logits against the plain route's, and prefill + decode against a full
    prefill at smoke size in fp32.

Every line of standard output is one JSON object; the last line is
``{"ok": true, "device": {...}}``.  Any failure (no CUDA device, a build or
launch error, a tolerance miss, a non-EQUIVALENT report, a golden mismatch,
a non-finite loss, a wrong launch count) ends the run with a non-zero exit
code and no last line.
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
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

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._device import true_fp32
from repro_torch._tree import leaves, tree_map
from repro_torch.configs import get_config, smoke
from repro_torch.core import CongestionConfig, FireBridge, coverify
from repro_torch.core.counters import counter_banks
from repro_torch.data.synthetic import SyntheticLMDataset
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as FAK
from repro_torch.kernels.flash_attention import ref as FAref
from repro_torch.kernels.flash_attention.sweep import (_inputs as fa_inputs,
                                                       flash_backends,
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
                                                       matmul_firmware)
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.steps import make_train_state, make_train_step
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import RunFlags, make_loss_fn
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.serving import Request, ServingEngine

# Published dense peaks of one H100 SXM (NVIDIA data sheet): the fp32 rate
# outside the tensor cores bounds a true-fp32 product; bf16 operands could
# go through the tensor cores, so they are held to that rate; fp32 matmul
# operands could go through them as TF32, so the function's 2MNK is held
# to the TF32 rate.
PEAK_FLOPS = {"float32": ("fp32_fma_67_TFLOPs", 67e12),
              "bfloat16": ("bf16_tensor_989_TFLOPs", 989e12),
              "tf32": ("tf32_tensor_494.7_TFLOPs", 494.7e12)}
PEAK_BYTES = ("hbm_3.35_TBps", 3.35e12)

CONG = dict(dos_prob=0.05, seed=7)
MM_MAIN_CFG = dict(size=4096, tile=128)          # coverify_matmul
FA_MAIN_CFG = dict(batch=1, heads=32, seq=2048, dim=64, bq=128, bk=128)
FIG5_CASES = [(100, 160), (400, 320), (900, 480), (1600, 640), (2500, 800)]
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
# a longer K, where the tensor core's accumulation error shows most.
MM_SHAPES = [
    (256, 128, 128, 64, torch.float32),
    (128, 256, 512, 64, torch.bfloat16),
    (128, 128, 128, 128, torch.float32),
    (800, 800, 800, 50, torch.float32),
    (4096, 4096, 4096, 128, torch.float32),
    (4096, 4096, 4096, 128, torch.bfloat16),
    (100, 300, 250, 50, torch.float32),
    (2048, 2048, 8192, 128, torch.float32),
]
MM_MAIN = 4          # index of the shape coverify_matmul runs
# the fp32 body keeps 3xTF32 only while every fp32 row is within half its
# gate (the rule that chose hi + lo for the attention backward)
SPLIT_RULE = 0.5

# (B, H, KH, S, D, causal, window, dtype, bq=bk); five reference test rows,
# three rows at the llama3.2-1b attention width, the main-path shape of
# coverify_flash (flash_firmware is MHA fp32), the shape train_llama gives
# the kernel (the models call it with bq=bk=512), zamba2's, then the bf16
# tensor-core body at head dims 16 and 32 and at a length that is no
# multiple of its 128-row tiles.
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
]
FA_MAIN = 8
FA_TRAIN = 9
FA_ZAMBA = 10        # zamba2-2.7b's shared attention: head dim 80, window

# Backward: the reference's gradient rows (SWEEP[:3] of
# tests/test_kernels_flash.py), a GQA row with G=4 (a missing head sum shows
# there), the shape train_llama gives the kernels, zamba2's head dim in
# fp32; then the bf16 tensor-core bodies (dk/dv and dq) at the reference's
# rows, G=4, D=80 with a window, D=128 and a ragged length.
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
]
BWD_MAIN = 4
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


def check_flash(shape) -> dict:
    B, H, KH, S, D, causal, window, dt, blk = shape
    rng = np.random.default_rng(B * 7919 + H * 101 + KH * 13 + S + D)
    mk = lambda h: torch.from_numpy(
        rng.normal(size=(B, h, S, D)).astype(np.float32)).cuda().to(dt)
    q, k, v = mk(H), mk(KH), mk(KH)
    kw = dict(causal=causal, window=window, bq=blk, bk=blk)
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
    row = {"shape": [B, H, KH, S, D], "causal": causal, "window": window,
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
    flops = 4.0 * D * live_pairs(S, S, causal, window) * B * H
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
    if not (out.shape == q.shape and lse.shape == (B, H, S)
            and torch.isfinite(lse).all() and torch.isfinite(out.float()).all()):
        fail(f"flash_fwd {row['shape']}: non-finite or misshapen output")
    # lse is O(log S) in fp32 whatever the input type: held to 1e-4
    if not (e_plain < tol and e_ref < tol and e_lse < 1e-4 * max(
            1.0, float(p_lse.abs().max()))):
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
    B, H, S, D = q.shape
    KH = k.shape[1]
    G = H // KH
    scale = 1.0 / D ** 0.5
    qg = q.reshape(B, KH, G, S, D).float()
    dog = dout.reshape(B, KH, G, S, D).float()
    pos = torch.arange(S, device=q.device)
    m = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        m &= pos[None, :] <= pos[:, None]
    if window:
        m &= pos[None, :] > pos[:, None] - window
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    p = torch.exp(torch.where(m, s, torch.full_like(s, -1e30))
                  - lse.reshape(B, KH, G, S)[..., None])
    p = torch.where(m, p, torch.zeros_like(p))
    del s
    dp = torch.einsum("bkgqd,bksd->bkgqs", dog, v.float())
    ds = p * (dp - delta.reshape(B, KH, G, S)[..., None]) * scale
    del dp
    ds = ds.bfloat16().float()
    if name == "flash_dq":
        return (torch.einsum("bkgqs,bksd->bkgqd", ds, k.float())
                .reshape(B, H, S, D),)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p.bfloat16().float(), dog)
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qg)
    return dk, dv


def check_flash_bwd(shape):
    """B3 and B4 at one shape against their plain versions and against
    autograd through the oracle.  ``delta`` comes from the oracle's fp32
    output on the upcast inputs, which is what autograd sees."""
    B, H, KH, S, D, causal, window, dt, blk = shape
    rng = np.random.default_rng(B * 7919 + H * 101 + KH * 13 + S + D + 1)
    mk = lambda h: torch.from_numpy(
        rng.normal(size=(B, h, S, D)).astype(np.float32)).cuda().to(dt)
    q, k, v, dout = mk(H), mk(KH), mk(KH), mk(H)
    kw = dict(causal=causal, window=window, bq=blk, bk=blk)
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
    pairs = live_pairs(S, S, causal, window) * B * H
    es = q.element_size()
    in_bytes = (2 * q.numel() + 2 * k.numel()) * es + 2 * lse.numel() * 4
    base = {"shape": [B, H, KH, S, D], "causal": causal, "window": window,
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
# prompt (256) and train_ssm's sequence (1024).
WKV_SHAPES = [(2, 64, 4, 16), (1, 32, 8, 32), (1, 1536, 64, 64),  # B,L,H,K
              (1, 256, 64, 64), (1, 1024, 64, 64)]
WKV_MAIN = 2
SSD_SHAPES = [  # B, L, H, P, N, chunk, x/B/C dtype
    (2, 64, 8, 16, 8, 16, torch.float32),
    (1, 128, 4, 8, 16, 32, torch.float32),
    (1, 1536, 80, 64, 64, 128, torch.bfloat16),
    (1, 1536, 80, 64, 64, 128, torch.float32),
]
SSD_MAIN = 2
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
    fb = FireBridge(congestion=CongestionConfig(**CONG))
    fb.register_op("mm", **matmul_backends(tile=16, device="cuda"))
    matmul_firmware(fb, "mm", "oracle", size=32, tile=16)
    trace = fb.log.canonical()
    counters = [ln for bank in counter_banks(fb) for ln in bank.canonical()]
    out = {"phase": "golden"}
    for kind, live in (("trace", trace), ("counters", counters)):
        path = GOLDEN / f"single_device_launch.{kind}"
        want = path.read_text().splitlines()
        if live != want:
            first = next((i for i, (x, y) in enumerate(zip(live, want))
                          if x != y), min(len(live), len(want)))
            fail(f"golden {kind}: first divergent line {first + 1} "
                 f"(live {len(live)} lines, golden {len(want)})")
        sha = hashlib.sha256(("\n".join(live) + "\n").encode()).hexdigest()
        if sha != hashlib.sha256(path.read_bytes()).hexdigest():
            fail(f"golden {kind}: lines equal but bytes differ")
        out[f"{kind}_sha256"] = sha
        out[f"{kind}_lines"] = len(live)
    emit(out)


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


def smoke_step_parity() -> dict:
    """One train step at smoke(llama3.2-1b) size, fp32 compute, pallas
    attention: on the card (kernels) against the CPU (plain versions), from
    the same initial state and batch."""
    cfg = smoke(get_config(LLAMA["arch"]))
    flags = RunFlags(attn_impl="pallas", compute_dtype="float32")
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=3)
    gen = torch.Generator(device="cpu").manual_seed(1)
    cpu_state = make_train_state(cfg, gen)
    gpu_state = tree_map(lambda t: t.detach().cuda().requires_grad_(
        t.requires_grad), cpu_state)
    before = tree_map(lambda t: t.detach().clone(), cpu_state["params"])
    b = SyntheticLMDataset(cfg.vocab_size, 128, 2, seed=1).batch(0)
    out = {}
    for name, st, dev in (("cpu", cpu_state, "cpu"), ("cuda", gpu_state, "cuda")):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        st, m = make_train_step(cfg, flags, None, opt)(st, batch)
        out[name] = (st, {k: float(v) for k, v in m.items()})
    (cs, cm), (gs, gm) = out["cpu"], out["cuda"]
    # AdamW's first update is lr * g / (|g| + eps) per element, which turns a
    # last-bit difference of a gradient near eps into a visible one: each
    # parameter whose gradient is above 100 * eps (the CPU's first moment is
    # (1 - b1) g) is held to 1e-3 * lr, the whole update to 1e-2 of its norm
    lr, sure_err, num, den = cm["lr"], 0.0, 0.0, 0.0
    for p0, pc, pg, m in zip(leaves(before), leaves(cs["params"]),
                             leaves(gs["params"]), leaves(cs["m"])):
        pc, pg = pc.detach(), pg.detach().cpu()
        sure = m.abs() / (1 - opt.b1) > 100 * opt.eps
        if sure.any():
            sure_err = max(sure_err, float((pg - pc).abs()[sure].max()))
        num += float(((pg - p0) - (pc - p0)).square().sum())
        den += float((pc - p0).square().sum())
    row = {"config": "smoke(llama3.2-1b)", "seq_len": 128, "batch": 2,
           "cpu": cm, "cuda": gm, "rtol": SMOKE_RTOL,
           "params_max_abs_err_over_lr": sure_err / lr,
           "update_rel_err": (num / den) ** 0.5}
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
        launches = {"flash_fwd": FAK.launches, "flash_dkdv": FAK.dkdv_launches,
                    "flash_dq": FAK.dq_launches}
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


def ssm_launches() -> dict:
    return {"wkv_scan": WKVK.launches, "ssd_scan": SSDK.launches,
            "flash_fwd": FAK.launches, "flash_dkdv": FAK.dkdv_launches,
            "flash_dq": FAK.dq_launches}


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
# fp32 route hold the kernels.
ROUTE_RTOL_FP32 = 1e-3
# prefill + decode against a full prefill, smoke size, fp32 on the card:
# tests/test_decode_consistency.py's bound
DECODE_RTOL = 1e-4
SERVE_ARCHS = {
    "rwkv6-7b": dict(flags=RunFlags(), kernels={"wkv_scan": (WKVK, 32)}),
    "zamba2-2.7b": dict(flags=RunFlags(attn_impl="pallas"),
                        kernels={"ssd_scan": (SSDK, 45),
                                 "flash_fwd": (FAK, 9)}),
}
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


def route_checks(cfg, flags, prefill, params, prompt, kernels) -> dict:
    """One served prefill through both routes, in bf16 as served and in
    fp32 on the same weights.  Kernel route: every launch's inputs also go
    through the plain version, each layer held to the kernel's tolerance.
    Plain route: every kernel wrapper replaced by its plain version.
    Returns per-kernel worst error/tolerance and the logits' relative
    differences."""
    worst = {n: 0.0 for n in kernels}
    n_checked = {n: 0 for n in kernels}
    batch = {"tokens": torch.from_numpy(prompt[None]).cuda()}

    def checked(name):
        mod, pname = PLAIN[name]
        kern, plain_fn = getattr(mod, name), getattr(mod, pname)

        def run(*a, **k):
            got = kern(*a, **k)
            want = plain_fn(*a, **k)
            pairs = list(zip(got, want))
            # the scans' y and state each to 1e-3 * max(1, max|plain|);
            # attention's out to its bf16 3e-2 and lse to 1e-4 * max(1, |lse|)
            if name == "flash_fwd":
                tols = [3e-2 if got[0].dtype == torch.bfloat16 else 2e-5,
                        1e-4 * max(1.0, float(want[1].abs().max()))]
            else:
                tols = [scan_tol([w]) for _, w in pairs]
            worst[name] = max(worst[name], max(
                max_err(g, w) / t for (g, w), t in zip(pairs, tols)))
            n_checked[name] += 1
            return got
        return (mod, run)

    plain = {n: (PLAIN[n][0], getattr(*PLAIN[n])) for n in kernels}
    rel = lambda a, b: max_err(a, b) / float(b.float().abs().max())
    with Swap({n: checked(n) for n in kernels}):
        lg_k, _ = prefill(params, batch)
    with Swap(plain):
        lg_p, _ = prefill(params, batch)
    params32 = tree_map(lambda a: a.float(), params)
    prefill32 = tf.make_prefill_fn(
        cfg, dataclasses.replace(flags, compute_dtype="float32"), None,
        SERVE["max_len"])
    lg32_k, _ = prefill32(params32, batch)
    with Swap(plain):
        lg32_p, _ = prefill32(params32, batch)
    del params32
    torch.cuda.empty_cache()
    return {"per_layer_err_over_tol": worst, "layers_checked": n_checked,
            "prompt_len": len(prompt),
            "logits_route_rel_fp32": rel(lg32_k, lg32_p),
            "route_rtol_fp32": ROUTE_RTOL_FP32,
            # reported only (see ROUTE_RTOL_FP32)
            "logits_route_rel_bf16": rel(lg_k, lg_p),
            "bf16_plain_vs_fp32_plain_rel": rel(lg_p, lg32_p),
            "kernel_bf16_vs_fp32_plain_rel": rel(lg_k, lg32_p)}


def smoke_decode_consistency(arch: str, flags: RunFlags) -> float:
    """tests/test_decode_consistency.py on the card: smoke config, fp32,
    B=2, prefill 48 tokens then decode 16, against a full prefill of 64."""
    cfg = smoke(get_config(arch))
    flags = dataclasses.replace(flags, compute_dtype="float32")
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(7))
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32)).cuda()
    prefill = tf.make_prefill_fn(cfg, flags, None, 64)
    decode = tf.make_decode_fn(cfg, flags)
    full, _ = prefill(params, {"tokens": toks})
    lg, cache = prefill(params, {"tokens": toks[:, :48]})
    for t in range(48, 64):
        lg, cache = decode(params, cache, toks[:, t])
    return max_err(lg, full) / float(full.abs().max())


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
    checks = route_checks(cfg, flags, prefill_fn, params, reqs[0][1],
                          kernels)

    tokens_out = sum(len(r.out_tokens) for r in out.values())
    dec_tokens = sum(n for _, n in decode_ms)
    dec_total = sum(ms for ms, _ in decode_ms)
    pre_total = sum(ms for _, ms in pre)
    kern_total = sum(kernel_ms.values())
    row = {"phase": f"serve_{arch.split('-')[0]}", "card": card, "arch": arch,
           "config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                      "n_heads": cfg.n_heads, "head_dim": cfg.head_dim,
                      "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size,
                      "params": n_params},
           "flags": dataclasses.asdict(flags), "serve": SERVE, "reduced": [],
           "init_s": init_s, "completed": eng.completed,
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
           "log_digest": eng.mem.log.digest(), "n_txs": eng.mem.log.n_txs,
           "route_checks": checks, "decode_consistency_rel": decode_rel,
           "decode_rtol": DECODE_RTOL}
    emit(row)
    if max(checks["per_layer_err_over_tol"].values()) >= 1.0 or \
            checks["layers_checked"] != {n: per for n, (_, per)
                                         in kernels.items()}:
        fail(f"serve {arch}: per-layer kernel vs plain {checks}")
    if not checks["logits_route_rel_fp32"] < ROUTE_RTOL_FP32:
        fail(f"serve {arch}: kernel route vs plain route logits {checks}")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------- main
def kernel_entry(name, sources, replaces, main_row, rows, launches) -> dict:
    """``sources`` names the file with the kernel's C entry point first,
    then every other file that implements it; ``launches`` maps each main
    path that runs the kernel to its count there, and the entry's
    ``launches`` is their sum."""
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
            "shapes": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script measures on the card only",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = phase_env()
    phase_build()
    mm_rows, fa_rows, dkdv_rows, dq_rows, wkv_rows, ssd_rows = phase_kernels()
    mm_launches = phase_coverify_matmul(card, mm_rows)
    fa_launches = phase_coverify_flash(card, fa_rows)
    phase_golden()
    train = phase_train_llama(card)
    ssm = phase_train_ssm(card)
    rwkv = phase_serve(card, "rwkv6-7b")
    zamba = phase_serve(card, "zamba2-2.7b")
    if mm_launches < 1 or fa_launches < 1 or min(train.values()) < 1 or \
            min(ssm.values()) < 1 or min(rwkv.values()) < 1 or \
            min(zamba.values()) < 1:
        fail(f"main path missed a kernel: matmul={mm_launches} "
             f"flash={fa_launches} train={train} train_ssm={ssm} "
             f"serve_rwkv6={rwkv} serve_zamba2={zamba}")
    src = "src/repro_torch/kernels/csrc/"
    ref = "src/repro/kernels/"
    emit({"kernels": [
        kernel_entry("systolic_matmul", [src + "systolic_matmul.cu",
                                         src + "systolic_matmul_sm90.cuh",
                                         src + "sm90.cuh"],
                     ref + "systolic_matmul/kernel.py:52",
                     mm_rows[MM_MAIN], mm_rows,
                     {"coverify_matmul": mm_launches}),
        kernel_entry("flash_fwd", [src + "flash_fwd.cu",
                                   src + "flash_fwd_tf32_sm90.cuh",
                                   src + "flash_fwd_sm90.cuh",
                                   src + "sm90.cuh"],
                     ref + "flash_attention/kernel.py:109",
                     fa_rows[FA_MAIN], fa_rows,
                     {"coverify_flash": fa_launches,
                      "train_llama": train["flash_fwd"],
                      "train_ssm": ssm["flash_fwd"],
                      "serve_zamba2": zamba["flash_fwd"]}),
        kernel_entry("flash_dkdv", [src + "flash_bwd.cu",
                                    src + "flash_dkdv_sm90.cuh",
                                    src + "sm90.cuh"],
                     ref + "flash_attention/kernel.py:186",
                     dkdv_rows[BWD_MAIN], dkdv_rows,
                     {"train_llama": train["flash_dkdv"],
                      "train_ssm": ssm["flash_dkdv"]}),
        kernel_entry("flash_dq", [src + "flash_bwd.cu",
                                  src + "flash_dq_sm90.cuh",
                                  src + "sm90.cuh"],
                     ref + "flash_attention/kernel.py:256",
                     dq_rows[BWD_MAIN], dq_rows,
                     {"train_llama": train["flash_dq"],
                      "train_ssm": ssm["flash_dq"]}),
        kernel_entry("ssd_scan", src + "ssd_scan.cu",
                     ref + "mamba2_scan/kernel.py:84",
                     ssd_rows[SSD_MAIN], ssd_rows,
                     {"train_ssm": ssm["ssd_scan"],
                      "serve_zamba2": zamba["ssd_scan"]}),
        kernel_entry("wkv_scan", src + "wkv_scan.cu",
                     ref + "rwkv6_wkv/kernel.py:62",
                     wkv_rows[WKV_MAIN], wkv_rows,
                     {"train_ssm": ssm["wkv_scan"],
                      "serve_rwkv6": rwkv["wkv_scan"]}),
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
