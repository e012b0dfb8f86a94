"""``benchmarks/roofline_torch.py`` against the reference's
``benchmarks/roofline.py``.

  * ``kernel_traffic_model``: every cell of the dry run, both meshes, two
    microbatch counts (exact);
  * ``render_dryrun_table``: byte for byte on the same synthetic records;
  * ``render_roofline_table``: with the reference's peaks, every column but
    the last equal; the last is the reference's hint translated for the
    card (CUDA kernels, shared memory and registers, expert-parallel
    all-to-all), chosen by the same (dominant term, kind, family).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

from repro_torch.launch.dryrun import plan_cells

ROOT = Path(__file__).resolve().parents[1]

# the reference's hint -> the port's
HINTS = {
    "skip fully-masked causal tiles (halves attention FLOPs)":
        "skip fully-masked causal tiles (halves attention FLOPs)",
    "batch more decode requests per step":
        "batch more decode requests per step",
    "KV/state cache is the floor; quantize cache to int8":
        "KV/state cache is the floor; quantize cache to int8",
    "larger WKV chunk + Pallas kernel keeps state in VMEM":
        "larger WKV chunk + CUDA kernel keeps state in registers",
    "Pallas kernels keep tile intermediates in VMEM":
        "CUDA kernels keep tile intermediates in shared memory / registers",
    "reduce-scatter instead of all-reduce; shard_map EP all-to-all (MoE)":
        "reduce-scatter instead of all-reduce; expert-parallel all-to-all "
        "(MoE)",
}


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def mods():
    return (_load("benchmarks/roofline.py", "roofline_reference"),
            _load("benchmarks/roofline_torch.py", "roofline_port"))


CELLS = plan_cells()[0]


def test_kernel_traffic_model_equals_reference(mods):
    ref, port = mods
    assert len(CELLS) == 31
    for arch, shape in CELLS:
        for world in (256, 512):
            for nm in (4, 16):
                assert port.kernel_traffic_model(arch, shape, world, nm) == \
                    ref.kernel_traffic_model(arch, shape, world, nm), \
                    (arch, shape, world, nm)


def _records(ref, seed: int = 0) -> list:
    """Synthetic dry-run records over every cell and both meshes, their
    compute and collective terms spread around the kernelized memory term
    so that each dominant term (and so each hint) occurs."""
    from repro.configs import SHAPES
    rng = np.random.default_rng(seed)
    recs = []
    for arch, shape in CELLS:
        for mesh, world in (("16x16", 256), ("2x16x16", 512)):
            nm = int(rng.choice([4, 8, 16]))
            mk = ref.kernel_traffic_model(arch, shape, world, nm) / ref.HBM_BW
            comp, coll = (mk * f for f in rng.choice([0.1, 3.0], size=2))
            kinds = sorted({"all-reduce", "all-gather", "reduce-scatter"}
                           & set(rng.choice(["all-reduce", "all-gather",
                                             "reduce-scatter", "x"], 3)))
            recs.append({
                "arch": arch, "shape": shape, "kind": SHAPES[shape].kind,
                "mesh": mesh, "world": world, "flags": {"microbatches": nm},
                "compile_s": float(rng.uniform(0, 300)),
                "memory_analysis": {
                    "argument_size_in_bytes": int(rng.integers(0, 9e10)),
                    "temp_size_in_bytes": int(rng.integers(0, 9e11)),
                    "cpu_f32_convert_artifact_bytes": 0},
                "profile": {
                    "hlo_flops_per_dev": float(rng.uniform(1e9, 1e15)),
                    "collective_bytes_per_dev": float(rng.uniform(0, 1e11)),
                    "collective_summary": {
                        k: {"count": int(rng.integers(1, 2000)),
                            "bytes": float(rng.uniform(0, 1e10))}
                        for k in kinds}},
                "roofline": {
                    "compute_s": comp, "memory_s": float(rng.uniform(0, 2)),
                    "collective_s": coll,
                    "useful_ratio": float(rng.uniform(0, 1)),
                    "model_flops_per_dev": comp * ref.PEAK_FLOPS_BF16 *
                    float(rng.uniform(0.1, 1))}})
    return recs


def test_render_dryrun_table_byte_identical(mods):
    ref, port = mods
    recs = _records(ref)
    assert port.render_dryrun_table(recs) == ref.render_dryrun_table(recs)
    assert port.render_dryrun_table([]) == ref.render_dryrun_table([])


@pytest.mark.parametrize("single_pod_only", [True, False])
def test_render_roofline_table_equals_reference_but_the_hint(
        mods, monkeypatch, single_pod_only):
    ref, port = mods
    monkeypatch.setattr(port, "HBM_BW", ref.HBM_BW)
    monkeypatch.setattr(port, "PEAK_FLOPS_BF16", ref.PEAK_FLOPS_BF16)
    recs = _records(ref, seed=1)
    got = port.render_roofline_table(recs, single_pod_only).splitlines()
    want = ref.render_roofline_table(recs, single_pod_only).splitlines()
    assert got[:2] == want[:2] and len(got) == len(want) > 2
    seen = set()
    for g, w in zip(got[2:], want[2:]):
        gc, wc = g.split(" | "), w.split(" | ")
        assert gc[:-1] == wc[:-1]
        assert gc[-1] == HINTS[wc[-1].rstrip(" |")] + " |"
        seen.add(wc[-1])
    assert len(seen) >= 4, seen               # the records cover the hints
