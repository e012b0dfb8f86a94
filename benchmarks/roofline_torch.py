"""Roofline aggregation on the PyTorch port: reads the dry-run records of
``python -m repro_torch.launch.dryrun`` (``benchmarks/artifacts/torch/
dryrun/``) and renders the §Dry-run and §Roofline tables — the twin of
``benchmarks/roofline.py``.

It reads JSON and needs no device, so, unlike the other twins, it takes no
``--device``: the dry run counts each cell's program on no card (a fake
process group, meta tensors), and this script only renders its records.

Two memory columns are reported:
  * mem_lax        — the dry run's counted traffic (the program the port
                     runs at those flags: ``chunked`` attention and the
                     scans' twins, whose tile intermediates round-trip HBM
                     at op granularity)
  * mem_kernelized — first-principles HBM model with the hand-written
                     kernels substituted (tile / state traffic in shared
                     memory and registers; weights + layer-boundary
                     activations + kernel operand streams only), derived
                     in ``kernel_traffic_model()`` below.

Roofline placement (dominant term, attainable fraction) is computed by
``core/profiler.RooflinePlacement`` at one H100's peaks
(``core/hlo_profiler.py``), so this table and the profiler cannot disagree
on what "memory-bound" means.

    PYTHONPATH=src python benchmarks/roofline_torch.py [--tag baseline]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import SHAPES, get_config, non_embedding_params  # noqa: E402
from repro_torch.core.hlo_profiler import HBM_BW, PEAK_FLOPS_BF16  # noqa: E402
from repro_torch.core.profiler import RooflinePlacement  # noqa: E402

ART = Path(__file__).resolve().parent / "artifacts" / "torch" / "dryrun"


# ---------------------------------------------------------------------------
# Kernelized HBM-traffic model (per device, bytes)
# ---------------------------------------------------------------------------


def kernel_traffic_model(arch: str, shape_name: str, world: int,
                         microbatches: int = 4) -> float:
    """Ideal-but-honest HBM traffic with the hand-written kernels:

      weights    : read 3x per microbatch in train (fwd, remat fwd, bwd),
                   1x in serve; grads/opt state r/w once per step (f32).
      activations: ~12 (B,S,d)-equivalent bf16 tensors per layer boundary,
                   x3 passes in train (fwd, remat, bwd), x1 serve.
      kernels    : flash/SSD/WKV stream operands+outputs exactly once
                   (k/v or state resident in shared memory per block).
    """
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    kind = shape.kind
    n = non_embedding_params(cfg, active_only=cfg.moe is not None)
    emb = cfg.vocab_size * cfg.d_model
    tokens = shape.global_batch * (shape.seq_len if kind != "decode" else 1)
    tok_dev = tokens / world
    d = cfg.d_model

    if kind == "train":
        w = (n + emb) * 2 / 16 * 3 * microbatches      # bf16, model-sharded
        opt = (n + emb) * 4 / world * (3 * 2 + 2)      # m,v,p r/w + grads r/w
        acts = tok_dev * d * 2 * 12 * cfg.n_layers * 3
        return w + opt + acts
    if kind == "prefill":
        w = (n + emb) * 2 / 16
        acts = tok_dev * d * 2 * 12 * cfg.n_layers
        cache = tok_dev * cfg.n_layers * cfg.d_kv * 2 * 2
        return w + acts + cache
    # decode: weights + full KV/state cache read + tiny activations
    w = (n + emb) * 2 / 16
    if cfg.family == "ssm":
        st = cfg.n_layers * shape.global_batch * cfg.n_heads * 64 * 64 * 4
        cache = 2 * st / world
    elif cfg.family == "hybrid":
        d_in = cfg.ssm.expand * d
        st = cfg.n_layers * shape.global_batch * (d_in // 64) * 64 * 64 * 4
        win = 9 * shape.global_batch * min(cfg.attn_window, shape.seq_len) * \
            cfg.d_kv * 2 * 2
        cache = (2 * st + win) / world
    else:
        cache = (cfg.n_layers * shape.global_batch * shape.seq_len *
                 cfg.d_kv * 2 * 2) / world
    acts = shape.global_batch / world * d * 2 * 12 * cfg.n_layers
    return w + cache + acts


# ---------------------------------------------------------------------------
# Table rendering
# ---------------------------------------------------------------------------


def load(tag: str = "baseline") -> list[dict]:
    recs = []
    for f in sorted(ART.glob(f"*__{tag}.json")):
        recs.append(json.loads(f.read_text()))
    return recs


def render_dryrun_table(recs) -> str:
    lines = ["| arch | shape | mesh | compile_s | args GB/dev | temp GB/dev* | "
             "HLO GFLOP/dev | coll GB/dev | collective mix |",
             "|---|---|---|---|---|---|---|---|---|",
             "<!-- *temp is TPU-corrected: XLA-CPU bf16->f32 operand-"
             "conversion buffers subtracted (per-cell raw values in the "
             "JSON artifacts) -->"]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        ma = r["memory_analysis"]
        args = ma.get("argument_size_in_bytes", 0) / 1e9
        temp = (ma.get("temp_size_in_bytes", 0) -
                ma.get("cpu_f32_convert_artifact_bytes", 0)) / 1e9
        p = r["profile"]
        mix = ",".join(f"{k}:{v['count']}" for k, v in
                       sorted(p["collective_summary"].items()))
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r['compile_s']:.1f} | {args:.2f} | {temp:.2f} | "
            f"{p['hlo_flops_per_dev']/1e9:.1f} | "
            f"{p['collective_bytes_per_dev']/1e9:.3f} | {mix} |")
    return "\n".join(lines)


def render_roofline_table(recs, single_pod_only: bool = True) -> str:
    lines = ["| arch | shape | compute_s | mem_lax_s | mem_kern_s | coll_s | "
             "dominant | useful | roofline_frac(kern) | what would move the "
             "dominant term |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        if single_pod_only and r["mesh"] != "16x16":
            continue
        rl = r["roofline"]
        mk = kernel_traffic_model(r["arch"], r["shape"], r["world"],
                                  r["flags"].get("microbatches", 4)) / HBM_BW
        pl = RooflinePlacement(
            f"{r['arch']}/{r['shape']}",
            {"compute": rl["compute_s"], "memory": mk,
             "collective": rl["collective_s"]},
            ideal_s=rl["model_flops_per_dev"] / PEAK_FLOPS_BF16)
        dom, frac = pl.dominant, pl.roofline_frac
        hint = _hint(r, dom)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {rl['compute_s']:.3e} | "
            f"{rl['memory_s']:.3e} | {mk:.3e} | {rl['collective_s']:.3e} | "
            f"{dom} | {rl['useful_ratio']:.2f} | {frac:.3f} | {hint} |")
    return "\n".join(lines)


def _hint(r, dom) -> str:
    kind = r["kind"]
    fam = get_config(r["arch"]).family
    if dom == "compute":
        if kind in ("train", "prefill"):
            return "skip fully-masked causal tiles (halves attention FLOPs)"
        return "batch more decode requests per step"
    if dom == "memory":
        if kind == "decode":
            return "KV/state cache is the floor; quantize cache to int8"
        if fam == "ssm":
            return "larger WKV chunk + CUDA kernel keeps state in registers"
        return ("CUDA kernels keep tile intermediates in shared memory / "
                "registers")
    return "reduce-scatter instead of all-reduce; expert-parallel " \
        "all-to-all (MoE)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="baseline",
                    help="which records to read (the dry run's --tag)")
    tag = ap.parse_args(argv).tag
    recs = load(tag)
    print(f"{len(recs)} {tag} artifacts")
    out = Path(__file__).resolve().parent / "artifacts" / "torch"
    out.mkdir(parents=True, exist_ok=True)
    (out / "dryrun_table.md").write_text(render_dryrun_table(recs))
    (out / "roofline_table.md").write_text(render_roofline_table(recs))
    print("wrote dryrun_table.md, roofline_table.md")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
