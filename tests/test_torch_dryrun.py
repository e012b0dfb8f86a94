"""The port's dry run (``launch/dryrun.py``) against the reference's
``repro.launch.dryrun``, and the repairs it needed in the paths it traces.

The reference's module forces 512 host devices when it is imported, so it
is imported only in a subprocess (``REFERENCE``), which prints its cells,
``model_flops`` and the ZeRO level and microbatch count of every train
cell by its rule (with its own ``train_state_bytes_per_device``).  Held:

  * ``model_flops`` for every arch x shape and the 31 cells (exact);
  * the ZeRO level and microbatch count of every train cell on both
    production meshes (exact);
  * two production-size cells through ``main``, each in a subprocess
    (llama3.2-1b / decode_32k and prefill_32k / 16 x 16): the reference's
    record keys, ``argument_size_in_bytes`` equal to rank 0's local shard
    bytes by the port's specs, nonzero FLOPs, and argument + temp within
    one H100's 80 GB;
  * a smoke train cell on a 2 x 2 fake mesh moves collective bytes, and
    its record is the same with and without the counter's reuse of
    output shapes;
  * the twin of ``tests/test_system.py::test_dryrun_artifacts_complete``
    over ``benchmarks/artifacts/torch/dryrun/`` (62 records, each within
    one NVIDIA H100 80GB HBM3's memory); it skips when they are absent;
  * the repairs: ``moe_apply`` (its expert counts now a static-shape
    ``scatter_add_``, equal to ``bincount``'s), ``moe_apply_ep`` on 2 gloo
    ranks, and the SSD / WKV-6 scans (dispatcher ops) run on meta and
    under ``FakeTensorMode`` with the shapes of the real call, each scan
    one op call.
"""
import ast
import json
import os
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch._tree import paths
from repro_torch.configs import SHAPES, ShapeConfig, get_config, list_archs, \
    smoke
from repro_torch.core import hlo_profiler as hp
from repro_torch.kernels.mamba2_scan import kernel as SSDK
from repro_torch.kernels.mamba2_scan import ops as ssd_ops
from repro_torch.kernels.rwkv6_wkv import kernel as WKVK
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_ctx, make_production_mesh, \
    make_test_mesh
from repro_torch.launch.steps import decode_shardings
from repro_torch.models import moe as moe_lib
from repro_torch.models.transformer import RunFlags
from torch_ranks import run, spawn

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
H100_HBM = 80e9                     # NVIDIA H100 80GB HBM3, bytes

REFERENCE = textwrap.dedent('''
    import json, os
    from repro.launch import dryrun          # forces 512 host devices
    os.environ["XLA_FLAGS"] += (" --xla_cpu_multi_thread_eigen=false"
                                " intra_op_parallelism_threads=1")
    from repro.configs import SHAPES, applicable_shapes, get_config, \\
        list_archs
    from repro.launch import steps as steps_lib
    from repro.launch.mesh import make_production_mesh
    out = {"cells": [], "model_flops": {}, "plan": {}}
    meshes = {mp: make_production_mesh(multi_pod=mp) for mp in (False, True)}
    for a in list_archs():
        cfg = get_config(a)
        app = applicable_shapes(cfg)
        for s, shape in SHAPES.items():
            out["model_flops"][f"{a}/{s}"] = dryrun.model_flops(
                cfg, shape, shape.kind)
            if app[s] != "OK":
                continue
            out["cells"].append([a, s])
            if shape.kind != "train":
                continue
            for mp, mesh in meshes.items():
                # dryrun.py's build_lowered, lines 40-54, flags' default 4
                zero_level = 1
                if steps_lib.train_state_bytes_per_device(cfg, mesh, 1) \\
                        > 6e9:
                    zero_level = 3
                ax = dict(zip(mesh.axis_names, mesh.devices.shape))
                dsize = mesh.devices.size // ax["model"]
                tok_dev = shape.global_batch * shape.seq_len // dsize
                want_nm = max(4, tok_dev // 4096)
                while shape.global_batch % want_nm:
                    want_nm += 1
                out["plan"][f"{a}/{s}/{mp}"] = [zero_level, want_nm]
    print(json.dumps(out))
''')


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = run([sys.executable, "-c", REFERENCE], env=env,
              cwd=ROOT, capture_output=True, text=True,
              timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cells_and_model_flops_equal_reference(reference):
    cells, skipped = dryrun.plan_cells()
    assert [list(c) for c in cells] == reference["cells"]
    assert len(cells) == 31 and len(skipped) == 9
    for a in list_archs():
        cfg = get_config(a)
        for s, shape in SHAPES.items():
            assert dryrun.model_flops(cfg, shape, shape.kind) == \
                reference["model_flops"][f"{a}/{s}"], (a, s)


def test_train_plan_equals_reference_rule(reference):
    flags = RunFlags(attn_impl="chunked", microbatches=4)
    n = 0
    for a, s in dryrun.plan_cells()[0]:
        if SHAPES[s].kind != "train":
            continue
        for mp in (False, True):
            zero, f = dryrun.train_plan(get_config(a), SHAPES[s],
                                        make_production_mesh(multi_pod=mp),
                                        flags)
            assert [zero, f.microbatches] == \
                reference["plan"][f"{a}/{s}/{mp}"], (a, s, mp)
            n += 1
    assert n == 20


def _reference_record_keys():
    """The keys of the reference's record (``rec = {...}`` in
    ``run_cell``), and of its nested dicts."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(
                node.targets[0], "id", "") == "rec":
            top = [k.value for k in node.value.keys]
            nested = {k.value: [kk.value for kk in v.keys]
                      for k, v in zip(node.value.keys, node.value.values)
                      if isinstance(v, ast.Dict)}
            return top, nested
    raise AssertionError("no rec = {...} in the reference's run_cell")


def _production_record(shape: str, timeout: int) -> dict:
    """llama3.2-1b / ``shape`` on the 16 x 16 mesh through ``main`` in a
    process of its own (a fake group of 256 ranks)."""
    with tempfile.TemporaryDirectory() as d:
        code = ("import sys\nfrom pathlib import Path\n"
                "from repro_torch.launch import dryrun\n"
                "dryrun.ART_DIR = Path(sys.argv[1])\n"
                "sys.exit(dryrun.main(['--arch', 'llama3.2-1b', '--shape', "
                f"'{shape}', '--tag', 'test']))\n")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        out = run([sys.executable, "-c", code, d], env=env,
                  cwd=ROOT, capture_output=True, text=True,
                  timeout=timeout)
        assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
        assert "1 OK, 0 FAIL" in out.stdout
        return json.loads((Path(d) / f"llama3.2-1b__{shape}__1pod__test"
                           ".json").read_text())


def _rank_bytes(rec) -> int:
    """What the artifacts check reads: argument + temp - artifact."""
    ma = rec["memory_analysis"]
    return ma["argument_size_in_bytes"] + ma["temp_size_in_bytes"] - \
        ma["cpu_f32_convert_artifact_bytes"]


def test_production_decode_cell_record():
    """llama3.2-1b / decode_32k on the 16 x 16 mesh through ``main`` in a
    process of its own (a fake group of 256 ranks): the reference's record
    keys, rank 0's argument bytes by the port's specs, and (since the
    decode keeps to its shard of the cache) within one H100's 80 GB —
    the step used to gather the whole cache on every rank: 280 GB."""
    rec = _production_record("decode_32k", 300)
    top, nested = _reference_record_keys()
    assert list(rec) == top
    for k, keys in nested.items():
        if k != "flags":
            assert set(keys) <= set(rec[k]), k
    assert set(rec["memory_analysis"]) >= {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes",
        "cpu_f32_convert_artifact_bytes"}
    assert (rec["mesh"], rec["world"], rec["kind"]) == ("16x16", 256,
                                                       "decode")
    # rank 0's local shard bytes, by the port's specs
    cfg, shape = get_config("llama3.2-1b"), SHAPES["decode_32k"]
    mesh = make_production_mesh()
    p_shape, p_sh, c_shape, c_sh, t_shape, t_sh = decode_shardings(
        cfg, shape, mesh, make_ctx(mesh))

    def local_bytes(tree, shardings):
        shs = [sh for _, sh in paths(shardings)]
        return sum(int(np.prod([s.stop - s.start for s in sh.local_index(
            tuple(t.shape), (0, 0))])) * t.element_size()
            for (_, t), sh in zip(paths(tree), shs))
    want = local_bytes(p_shape, p_sh) + local_bytes(c_shape, c_sh) + \
        local_bytes(t_shape, t_sh)
    assert rec["memory_analysis"]["argument_size_in_bytes"] == want
    assert rec["profile"]["hlo_flops_per_dev"] > 0
    assert rec["cost_analysis_raw"]["flops"] > 0
    assert _rank_bytes(rec) < H100_HBM, _rank_bytes(rec) / 1e9


def test_production_prefill_cell_record():
    """llama3.2-1b / prefill_32k on the 16 x 16 mesh in a process of its
    own: rank 0 computes its 2 of the 32 prompts with its heads and keeps
    its shard of the cache, within one H100's 80 GB (every rank used to
    compute the whole batch: 118 GB)."""
    rec = _production_record("prefill_32k", 900)
    assert (rec["mesh"], rec["world"], rec["kind"]) == ("16x16", 256,
                                                       "prefill")
    assert rec["profile"]["hlo_flops_per_dev"] > 0
    assert rec["profile"]["collective_bytes_per_dev"] > 0
    assert _rank_bytes(rec) < H100_HBM, _rank_bytes(rec) / 1e9


def _smoke_train(reuse: bool = True) -> dict:
    cfg = smoke(get_config("moonshot-v1-16b-a3b"))
    flags = RunFlags(attn_impl="chunked", q_chunk=16, kv_chunk=16,
                     microbatches=2)
    shape = ShapeConfig("smoke_train", 64, 8, "train")
    return dryrun.measure_cell(cfg, shape, make_test_mesh((2, 2)), flags,
                               reuse_shapes=reuse)


def test_smoke_train_cell_moves_collective_bytes():
    rec = _smoke_train()
    assert rec["world"] == 4 and rec["zero_level"] == 1
    assert rec["profile"]["collective_bytes_per_dev"] > 0
    assert rec["profile"]["hlo_flops_per_dev"] > 0
    assert rec["memory_analysis"]["alias_size_in_bytes"] > 0
    assert not dist.is_initialized()            # the fake group is gone
    plain = _smoke_train(reuse=False)
    for k in ("memory_analysis", "profile", "cost_analysis_raw", "roofline"):
        assert rec[k] == plain[k], k


def test_dryrun_artifacts_complete():
    """The twin of the reference's check over the port's records: all 31
    cells x 2 meshes, each within one card's memory, with nonzero FLOPs,
    and collective bytes in every train cell."""
    art = ROOT / "benchmarks" / "artifacts" / "torch" / "dryrun"
    recs = [json.loads(f.read_text())
            for f in art.glob("*__baseline.json")]
    if not recs:   # artifacts not generated in this checkout
        pytest.skip("dry-run artifacts not present; run "
                    "python -m repro_torch.launch.dryrun --all "
                    "--both-meshes")
    assert len(recs) == 62
    for r in recs:
        ma = r["memory_analysis"]
        used = ma.get("argument_size_in_bytes", 0) + \
            ma.get("temp_size_in_bytes", 0)
        used -= ma.get("cpu_f32_convert_artifact_bytes", 0)
        assert used < H100_HBM, f"{r['arch']}/{r['shape']}/{r['mesh']}: " \
            f"{used/1e9:.1f}GB exceeds one H100's 80 GB"
        assert r["profile"]["hlo_flops_per_dev"] > 0
        if r["kind"] == "train":
            assert r["profile"]["collective_bytes_per_dev"] > 0


# ---------------------------------------------------------------------------
# The repairs the dry run needed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_expert_counts_equal_bincount(seed):
    """The static-shape count of ``moe_apply`` / ``moe_apply_ep`` (a
    ``scatter_add_`` of ones into E zeros) equals ``bincount``'s, empty
    experts included."""
    rng = np.random.default_rng(seed)
    E = int(rng.integers(2, 70))
    e = torch.from_numpy(rng.integers(0, E, size=int(rng.integers(1, 400))))
    if seed == 0:
        e = e.clamp(max=E // 2)                       # idle experts
    got = torch.zeros(E, dtype=torch.long).scatter_add_(
        0, e, torch.ones_like(e))
    assert torch.equal(got, torch.bincount(e, minlength=E))


def _traced(mode: str, fn, *ts):
    """``fn(*ts)`` on meta tensors or under ``FakeTensorMode``."""
    if mode == "meta":
        return fn(*[t.to("meta") for t in ts])
    fm = FakeTensorMode()
    args = [fm.from_tensor(t) for t in ts]
    with fm:
        return fn(*args)


def _same_meta(got, want):
    got, want = (list(x) if isinstance(x, tuple) else [x]
                 for x in (got, want))
    assert [(tuple(g.shape), g.dtype) for g in got] == \
        [(tuple(w.shape), w.dtype) for w in want]


@pytest.mark.parametrize("mode", ["meta", "fake"])
def test_moe_apply_traces(mode):
    cfg = smoke(get_config("moonshot-v1-16b-a3b"))
    g = torch.Generator().manual_seed(0)
    w = {k: v[0] for k, v in moe_lib.moe_init(g, cfg, 1,
                                               torch.float32).items()}
    x = torch.randn(40, cfg.d_model, generator=g)
    names = sorted(w)
    fn = lambda x, *ws: moe_lib.moe_apply(dict(zip(names, ws)), x, cfg)
    _same_meta(_traced(mode, fn, x, *(w[n] for n in names)),
               moe_lib.moe_apply(w, x, cfg))


def _ep_rank(rank, world, store):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from repro_torch.sharding.ep import moe_apply_ep
        cfg = smoke(get_config("moonshot-v1-16b-a3b"))
        ctx = make_ctx(make_test_mesh((1, 2)).bind("cpu"))
        g = torch.Generator().manual_seed(0)
        w = {k: v[0] for k, v in moe_lib.moe_init(g, cfg, 1,
                                                   torch.float32).items()}
        x = torch.randn(32, cfg.d_model, generator=g)
        names = sorted(w)
        fn = lambda x, *ws: moe_apply_ep(dict(zip(names, ws)), x, cfg, ctx)
        want = moe_apply_ep(w, x, cfg, ctx)
        for mode in ("meta", "fake"):
            _same_meta(_traced(mode, fn, x, *(w[n] for n in names)), want)
    finally:
        dist.destroy_process_group()


def test_moe_apply_ep_traces_on_two_gloo_ranks(tmp_path):
    spawn(_ep_rank, (2, str(tmp_path / "store")), 2)


def _wkv_inputs(requires_grad=False):
    rng = np.random.default_rng(1)
    B, L, H, K = 1, 64, 4, 16
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    r, k, v = t(B, L, H, K), t(B, L, H, K), t(B, L, H, K)
    w = torch.sigmoid(t(B, L, H, K))
    u = t(H, K)
    return [a.requires_grad_(requires_grad) for a in (r, k, v, w, u)]


def _ssd_inputs(requires_grad=False):
    rng = np.random.default_rng(2)
    B, L, H, P, N = 1, 64, 4, 8, 8
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    x, Bm, Cm = t(B, L, H, P), t(B, L, N), t(B, L, N)
    dt = torch.nn.functional.softplus(t(B, L, H))
    A, D = -torch.exp(t(H)), t(H)
    return [a.requires_grad_(requires_grad) for a in (x, dt, Bm, Cm, A, D)]


@pytest.mark.parametrize("mode", ["meta", "fake"])
@pytest.mark.parametrize("scan", ["wkv", "ssd"])
def test_scans_are_one_op_with_the_real_shapes(scan, mode):
    """The kernel wrappers and the differentiable ``ops`` wrappers trace
    with the real call's output shapes and types; each call is one
    ``repro_torch::`` op (no per-step plain loop, no launch)."""
    if scan == "wkv":
        K, ops, ins, kw = WKVK, wkv_ops, _wkv_inputs, dict(chunk=16)
        raw, wrapped = K.wkv_scan, ops.wkv_scan
    else:
        K, ops, ins, kw = SSDK, ssd_ops, _ssd_inputs, dict(chunk=16)
        raw, wrapped = K.ssd_scan, ops.ssd_scan
    want = raw(*ins(), **kw)
    before = K.launches
    for fn, grad in ((raw, False), (wrapped, True)):
        # the counter counts the meta run (the dry run's); under
        # FakeTensorMode it stands aside, as it does for DTensor's
        # sharding propagation
        with hp.ProgramCounter() as counter:
            got = _traced(mode, lambda *a: fn(*a, **kw), *ins(grad))
        _same_meta(got, want)
        assert counter.custom_calls == ({f"{scan}_scan": 1}
                                        if mode == "meta" else {})
    assert K.launches == before
