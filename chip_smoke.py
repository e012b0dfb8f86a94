#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``src/repro_torch/kernels/csrc`` into
``build/`` (one ``nvcc`` per source, all started together), holds each
kernel against its plain PyTorch version and its ``ref.py`` oracle on the
card, drives the port's main path — ``coverify()`` over the oracle /
interpret / compiled backends for the systolic matmul and the
flash-attention forward, through the congestion-arbitrated bridge — and
regenerates the committed single-device golden trace and counter stream.

Every earlier line of standard output is one JSON object; the last line is
``{"ok": true, "device": {...}}``.  Any failure (no CUDA device, a build or
launch error, a tolerance miss, a non-EQUIVALENT report, a golden mismatch)
ends the run with a non-zero exit code and no last line.
"""
from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import CongestionConfig, FireBridge, coverify
from repro_torch.core.counters import counter_banks
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as FAK
from repro_torch.kernels.flash_attention import ref as FAref
from repro_torch.kernels.flash_attention.sweep import (_inputs as fa_inputs,
                                                       flash_backends,
                                                       flash_firmware)
from repro_torch.kernels.systolic_matmul import kernel as MMK
from repro_torch.kernels.systolic_matmul import ref as MMref
from repro_torch.kernels.systolic_matmul.sweep import (matmul_backends,
                                                       matmul_firmware)

# Published dense peaks of one H100 SXM (NVIDIA data sheet): the fp32 rate
# outside the tensor cores bounds a true-fp32 product; bf16 operands could
# go through the tensor cores, so they are held to that rate.
PEAK_FLOPS = {"float32": ("fp32_fma_67_TFLOPs", 67e12),
              "bfloat16": ("bf16_tensor_989_TFLOPs", 989e12)}
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
def phase_build() -> None:
    t0 = time.perf_counter()
    libs = _build.build_all()
    emit({"phase": "build", "built": sorted(libs),
          "seconds": time.perf_counter() - t0,
          "dir": str(_build.BUILD_DIR.relative_to(ROOT))})


# ------------------------------------------------------------------ phase 3
# (M, N, K, tile, dtype); the first three are the reference test rows, then
# the largest Fig. 5 case and the full-size main-path shape.
MM_SHAPES = [
    (256, 128, 128, 64, torch.float32),
    (128, 256, 512, 64, torch.bfloat16),
    (128, 128, 128, 128, torch.float32),
    (800, 800, 800, 50, torch.float32),
    (4096, 4096, 4096, 128, torch.float32),
    (4096, 4096, 4096, 128, torch.bfloat16),
]
MM_MAIN = 4          # index of the shape coverify_matmul runs

# (B, H, KH, S, D, causal, window, dtype, bq=bk); five reference test rows,
# three rows at the llama3.2-1b attention width, and the main-path shape of
# coverify_flash (flash_firmware is MHA fp32).
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
]
FA_MAIN = 8


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
           "kernel_ms": time_ms(lambda: MMK.matmul(a, b, **kw), reps),
           "plain_ms": time_ms(lambda: MMK.matmul_plain(a, b, **kw),
                               3 if big else reps),
           "library_ms": time_ms(lambda: torch.matmul(a, b), reps)}
    row.update(bound(2.0 * M * N * K,
                     (M * K + K * N + M * N) * a.element_size(),
                     row["dtype"]))
    if not (got.shape == (M, N) and torch.isfinite(got.float()).all()):
        fail(f"systolic_matmul {row['shape']}: non-finite or misshapen output")
    if not (e_plain < tol and e_ref < tol):
        fail(f"systolic_matmul {row}: outside tolerance")
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
           "kernel_ms": time_ms(lambda: FAK.flash_fwd(q, k, v, **kw), reps),
           "plain_ms": time_ms(lambda: FAK.flash_fwd_plain(q, k, v, **kw),
                               3 if big else reps),
           "library_ms": time_ms(lib, reps)}
    es = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * es + lse.numel() * 4
    row.update(bound(4.0 * D * live_pairs(S, S, causal, window) * B * H,
                     nbytes, row["dtype"]))
    if not (out.shape == q.shape and lse.shape == (B, H, S)
            and torch.isfinite(lse).all() and torch.isfinite(out.float()).all()):
        fail(f"flash_fwd {row['shape']}: non-finite or misshapen output")
    # lse is O(log S) in fp32 whatever the input type: held to 1e-4
    if not (e_plain < tol and e_ref < tol and e_lse < 1e-4 * max(
            1.0, float(p_lse.abs().max()))):
        fail(f"flash_fwd {row}: outside tolerance")
    return row


def phase_kernels():
    mm_rows = [check_matmul(s) for s in MM_SHAPES]
    fa_rows = [check_flash(s) for s in FA_SHAPES]
    emit({"phase": "kernel_checks", "systolic_matmul": mm_rows,
          "flash_fwd": fa_rows})
    return mm_rows, fa_rows


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
    # oracle and compiled are one callable: wrap each name on its own
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


def phase_coverify_matmul(card: str, mm_rows) -> int:
    MMK.launches = 0
    FAK.launches = 0
    size, tile = MM_MAIN_CFG["size"], MM_MAIN_CFG["tile"]
    table = matmul_backends(tile=tile, device="cuda")
    row = run_coverify(
        "coverify_matmul",
        lambda fb, op, be: matmul_firmware(fb, op, be, size=size, tile=tile),
        "mm", table, ("oracle", "interpret", "compiled"),
        CongestionConfig(**CONG), lambda: MMK.launches)
    rng = np.random.default_rng(size)
    ab = [rng.normal(size=(size, size)).astype(np.float32) for _ in range(2)]
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
    cfg = FA_MAIN_CFG
    table = flash_backends(bq=cfg["bq"], bk=cfg["bk"], causal=True,
                           device="cuda")
    row = run_coverify(
        "coverify_flash",
        lambda fb, op, be: flash_firmware(fb, op, be, **cfg),
        "fa", table, ("oracle", "interpret", "compiled"),
        CongestionConfig(**CONG), lambda: FAK.launches)
    qkv = fa_inputs(cfg["batch"], cfg["heads"], cfg["seq"], cfg["dim"])
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


# --------------------------------------------------------------------- main
def kernel_entry(name, source, replaces, main_row, rows, launches) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": main_row["max_abs_err"],
            "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"], "tol": main_row["tol"],
            "peak": main_row["peak"],
            "main_path_shape": {k: main_row[k] for k in main_row
                                if k in ("shape", "tile", "block", "dtype",
                                         "causal", "window")},
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
    mm_rows, fa_rows = phase_kernels()
    mm_launches = phase_coverify_matmul(card, mm_rows)
    fa_launches = phase_coverify_flash(card, fa_rows)
    phase_golden()
    if mm_launches < 1 or fa_launches < 1:
        fail(f"main path missed a kernel: matmul={mm_launches} "
             f"flash={fa_launches}")
    emit({"kernels": [
        kernel_entry("systolic_matmul",
                     "src/repro_torch/kernels/csrc/systolic_matmul.cu",
                     "src/repro/kernels/systolic_matmul/kernel.py:52",
                     mm_rows[MM_MAIN], mm_rows, mm_launches),
        kernel_entry("flash_fwd",
                     "src/repro_torch/kernels/csrc/flash_fwd.cu",
                     "src/repro/kernels/flash_attention/kernel.py:109",
                     fa_rows[FA_MAIN], fa_rows, fa_launches),
    ]})
    emit({"phase": "done", "card": card,
          "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
