"""The port's sharding rules against the reference's, with no devices.

The reference's spec functions read only a mesh's axis names and shape
(``mesh.axis_names``, ``mesh.devices.shape`` / ``.size``), so a stand-in
mesh (a namespace with those) gives its spec trees at the production
sizes.  For all ten configs on meshes 16 x 16 and 2 x 16 x 16 and on
(2, 2), (1, 4) and (4, 1), leaf by leaf: ``param_specs`` of the train
state's parameters and of the bf16 serve parameters, ``zero_specs``,
``batch_specs`` of the train and prefill inputs of every applicable shape,
``cache_specs`` of ``init_cache`` at every applicable decode shape, the
spec trees of ``train_shardings`` (zero levels 0 / 1 / 3),
``prefill_shardings`` and ``decode_shardings`` (the reference's
``NamedSharding`` is replaced by its spec for the stand-in, in this test
only), and ``train_state_bytes_per_device`` exactly.  Then
``to_shardings``: the slice each rank holds on a 2 x 2 and a 2 x 2 x 2
mesh equals the reference's ``NamedSharding.devices_indices_map`` for the
device at the same mesh coordinate, read in a subprocess that forces 8
host devices.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import applicable_shapes
from repro.configs import get_config as ref_get_config
from repro.configs import list_archs
from repro.launch import steps as ref_steps
from repro.launch.mesh import make_ctx as ref_make_ctx
from repro.models import inputs as ref_inputs
from repro.models.transformer import init_cache as ref_init_cache
from repro.sharding import specs as ref_specs
from repro_torch._tree import paths
from repro_torch.configs import SHAPES, get_config, smoke
from repro_torch.launch import steps
from repro_torch.launch.mesh import (Mesh, make_ctx, make_production_mesh,
                                     make_test_mesh)
from repro_torch.models import inputs
from repro_torch.models.transformer import init_cache
from repro_torch.sharding import specs
from repro_torch.sharding.specs import Sharding

ROOT = Path(__file__).resolve().parents[1]

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
          ((4, 1), ("data", "model"))]


def _stand_in(shape, axes):
    return SimpleNamespace(axis_names=axes, devices=np.empty(shape, object))


def _ref_flat(tree) -> dict:
    """{leaf path: tuple(spec)} of a reference spec tree (``P`` leaves)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, ref_specs.P))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(s) for path, s in flat}


def _flat(tree) -> dict:
    out = {}

    def walk(node, path):
        if isinstance(node, specs.PartitionSpec):
            out["/".join(path)] = tuple(node)
        elif isinstance(node, Sharding):
            out["/".join(path)] = tuple(node.spec)
        elif isinstance(node, dict):
            for k in node:
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
    walk(tree, ())
    return out


def _same(got, want, what):
    g, w = _flat(got), _ref_flat(want)
    assert g.keys() == w.keys(), what
    for k in w:
        assert g[k] == w[k], (what, k, g[k], w[k])


@pytest.fixture(scope="module")
def ref_shapes():
    """Each config's train state and bf16 serve params, as the
    reference's abstract arrays (one ``eval_shape`` a config)."""
    out = {}
    for arch in list_archs():
        rc = ref_get_config(arch)
        out[arch] = (ref_steps.train_state_shape(rc),
                     ref_steps.serve_params_shape(rc))
    return out


def _spec_only(monkeypatch):
    monkeypatch.setattr(ref_steps, "NamedSharding", lambda mesh, spec: spec)


@pytest.mark.parametrize("shape,axes", MESHES,
                         ids=["x".join(map(str, s)) for s, _ in MESHES])
def test_spec_trees_equal_reference(shape, axes, ref_shapes, monkeypatch):
    _spec_only(monkeypatch)
    rmesh, mesh = _stand_in(shape, axes), Mesh(shape, axes)
    rctx, ctx = ref_make_ctx(rmesh), make_ctx(mesh)
    for arch in list_archs():
        rc, cfg = ref_get_config(arch), get_config(arch)
        rst, rserve = ref_shapes[arch]
        st = steps.train_state_shape(cfg)
        pspec = specs.param_specs(cfg, st["params"], mesh)
        rpspec = ref_specs.param_specs(rc, rst["params"], rmesh)
        _same(pspec, rpspec, (arch, "params"))
        _same(specs.param_specs(cfg, steps.serve_params_shape(cfg), mesh),
              ref_specs.param_specs(rc, rserve, rmesh), (arch, "serve"))
        _same(specs.zero_specs(pspec, st["params"], mesh, ctx.data_axes),
              ref_specs.zero_specs(rpspec, rst["params"], rmesh,
                                   rctx.data_axes), (arch, "zero"))
        for name, kind in applicable_shapes(rc).items():
            if kind != "OK":
                continue
            rshape, sh = REF_SHAPES[name], SHAPES[name]
            if sh.kind == "train":
                for zl in (0, 1, 3):
                    got = steps.train_shardings(cfg, sh, mesh, ctx, zl)
                    want = ref_steps.train_shardings(rc, rshape, rmesh,
                                                     rctx, zl)
                    for i in (1, 3, 4):
                        if want[i] is None:
                            assert got[i] is None
                        else:
                            _same(got[i], want[i], (arch, name, zl, i))
                _same(specs.batch_specs(
                    cfg, inputs.train_input_specs(cfg, sh), mesh,
                    ctx.data_axes), ref_specs.batch_specs(
                        rc, ref_inputs.train_input_specs(rc, rshape), rmesh,
                        rctx.data_axes), (arch, name, "batch"))
            elif sh.kind == "prefill":
                got = steps.prefill_shardings(cfg, sh, mesh, ctx)
                want = ref_steps.prefill_shardings(rc, rshape, rmesh, rctx)
                _same(got[1], want[1], (arch, name, "p"))
                _same(got[3], want[3], (arch, name, "batch"))
            else:
                got = steps.decode_shardings(cfg, sh, mesh, ctx)
                want = ref_steps.decode_shardings(rc, rshape, rmesh, rctx)
                _same(got[1], want[1], (arch, name, "p"))
                _same(got[3], want[3], (arch, name, "cache"))
                assert tuple(got[5].spec) == tuple(want[5]), (arch, name)
                c = init_cache(cfg, sh.global_batch, sh.seq_len,
                               device="meta")
                rcache = jax.eval_shape(lambda: ref_init_cache(
                    rc, rshape.global_batch, rshape.seq_len))
                _same(specs.cache_specs(cfg, c, mesh, ctx.data_axes),
                      ref_specs.cache_specs(rc, rcache, rmesh,
                                            rctx.data_axes),
                      (arch, name, "cache_specs"))
        for zl in (0, 1, 3):
            assert steps.train_state_bytes_per_device(cfg, mesh, zl) == \
                ref_steps.train_state_bytes_per_device(rc, rmesh, zl), \
                (arch, zl)


def test_production_meshes_and_context():
    for multi in (False, True):
        m = make_production_mesh(multi_pod=multi)
        assert m.shape == ((2, 16, 16) if multi else (16, 16))
        ctx = make_ctx(m)
        assert ctx.data_spec == (("pod", "data") if multi else "data")
        assert ctx.dsize == (32 if multi else 16) and ctx.msize == 16
    assert make_test_mesh().shape == (1, 1) and not make_test_mesh().bound
    sh = Sharding(make_test_mesh((2, 2, 2), ("pod", "data", "model")),
                  specs.P(("pod", "data"), "model"))
    assert [type(p).__name__ for p in sh.placements] == ["Shard"] * 3
    with pytest.raises(ValueError, match="mesh order"):
        Sharding(make_test_mesh((2, 2, 2), ("pod", "data", "model")),
                 specs.P(("data", "pod"), None))


INDICES = textwrap.dedent('''
    import json, os, sys
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               "--xla_cpu_multi_thread_eigen=false "
                               "intra_op_parallelism_threads=1")
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax, numpy as np
    from jax.sharding import Mesh, NamedSharding
    from repro.configs import get_config, smoke
    from repro.launch import steps
    from repro.launch.mesh import make_ctx
    from repro.configs.base import ShapeConfig
    from repro.sharding import specs
    out = {}
    for shape, axes in (((2, 2), ("data", "model")),
                        ((2, 2, 2), ("pod", "data", "model"))):
        n = int(np.prod(shape))
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)
        ctx = make_ctx(mesh)
        coord = {d: c for c, d in np.ndenumerate(mesh.devices)}
        for arch in sys.argv[2:]:
            cfg = smoke(get_config(arch))
            st, st_sh, b, b_sh, _ = steps.train_shardings(
                cfg, ShapeConfig("t", 32, 8, "train"), mesh, ctx, 1)
            _, _, c, c_sh, _, _ = steps.decode_shardings(
                cfg, ShapeConfig("d", 32, 8, "decode"), mesh, ctx)
            for tree, sh in ((st, st_sh), (b, b_sh), (c, c_sh)):
                flat, _ = jax.tree_util.tree_flatten_with_path(tree)
                shs = jax.tree_util.tree_leaves(
                    sh, is_leaf=lambda x: isinstance(x, NamedSharding))
                for (path, leaf), s in zip(flat, shs):
                    p = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                                 for k in path)
                    m = s.devices_indices_map(leaf.shape)
                    out[f"{len(shape)}|{arch}|{p}"] = {
                        ",".join(map(str, coord[d])): [
                            [sl.start or 0, leaf.shape[i] if sl.stop is None
                             else sl.stop] for i, sl in enumerate(idx)]
                        for d, idx in m.items()}
    open(sys.argv[1], "w").write(json.dumps(out))
''')


def test_rank_slices_equal_reference_devices_indices_map(tmp_path):
    archs = ("llama3.2-1b", "moonshot-v1-16b-a3b")
    path = tmp_path / "indices.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", INDICES, str(path), *archs],
                   check=True, env=env, cwd=ROOT, timeout=600)
    want = json.loads(path.read_text())
    from repro_torch.configs.base import ShapeConfig
    seen = 0
    for shape, axes in (((2, 2), ("data", "model")),
                        ((2, 2, 2), ("pod", "data", "model"))):
        mesh = make_test_mesh(shape, axes)
        ctx = make_ctx(mesh)
        for arch in archs:
            cfg = smoke(get_config(arch))
            st, st_sh, b, b_sh, _ = steps.train_shardings(
                cfg, ShapeConfig("t", 32, 8, "train"), mesh, ctx, 1)
            _, _, c, c_sh, _, _ = steps.decode_shardings(
                cfg, ShapeConfig("d", 32, 8, "decode"), mesh, ctx)
            for tree, sh in ((st, st_sh), (b, b_sh), (c, c_sh)):
                shs = dict(paths(sh))
                for p, leaf in paths(tree):
                    ref = want[f"{len(shape)}|{arch}|{p}"]
                    for coord in np.ndindex(*shape):
                        idx = shs[p].local_index(tuple(leaf.shape), coord)
                        got = [[s.start, s.stop] for s in idx]
                        assert got == ref[",".join(map(str, coord))], (
                            shape, arch, p, coord)
                    seen += 1
    assert seen == len(want)
