"""The port's expert-parallel MoE layer (``sharding/ep.py``) on 4 gloo
ranks, mesh (data 2, model 2), against the reference's ``moe_apply_ep``
on a 4-device CPU mesh.

The reference runs in a subprocess that forces 4 host devices (this
process keeps its one device, ``tests/conftest.py``); arrays go both ways
through an ``.npz``.  Its inputs are drawn there from numpy seeds, fp32.
Held for smoke moonshot and smoke phi3.5-moe:

  * ``out`` within 1e-5 x max(1, max|ref|), at T = 32 (each data shard
    routes its 16 tokens, sizing its capacity from them) and at T = 31
    (the data axis does not divide T: every shard routes all of them);
  * aux equal (1e-6 relative) to the reference's EP aux — data shard 0's
    route aux, not the layer's over all tokens (the test asserts the two
    differ at T = 32, so the check can tell them apart) — on every rank;
  * the gradient of that aux with respect to the router (the data
    group's mean of each shard's, as the reference's) within 1e-5;
  * ``moe_block`` under ``moe_mode="ep_shardmap"`` with ``moe_seq_chunk``
    16 over (2, 32) inputs: two chunks, each through the layer.
"""
import os
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, smoke
from repro_torch.launch.mesh import make_ctx, make_test_mesh
from repro_torch.models import transformer as tf
from repro_torch.sharding import comm
from repro_torch.sharding.ep import moe_apply_ep
from torch_ranks import run, spawn

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b")

REFERENCE = textwrap.dedent('''
    import os, sys
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_cpu_multi_thread_eigen=false "
                               "intra_op_parallelism_threads=1")
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config, smoke
    from repro.launch.mesh import make_ctx, make_test_mesh
    from repro.models import moe as moe_lib
    from repro.models.transformer import RunFlags, moe_block
    from repro.sharding.ep import moe_apply_ep
    out = {}
    ctx = make_ctx(make_test_mesh((2, 2)))
    for a, arch in enumerate(sys.argv[2:]):
        cfg = smoke(get_config(arch))
        rng = np.random.default_rng(a)
        w = moe_lib.moe_init(jax.random.PRNGKey(a), cfg, 1, jnp.float32)
        w = {k: np.asarray(v[0]) for k, v in w.items()}
        for k, v in w.items():
            out[f"{arch}/w/{k}"] = v
        for T in (32, 31):
            x = rng.normal(size=(T, cfg.d_model)).astype(np.float32)
            o, aux = jax.jit(lambda w, x: moe_apply_ep(w, x, cfg, ctx))(w, x)
            out[f"{arch}/{T}/x"], out[f"{arch}/{T}/out"] = x, np.asarray(o)
            out[f"{arch}/{T}/aux"] = np.asarray(aux)
            out[f"{arch}/{T}/aux_all"] = np.asarray(
                moe_lib.route(w["router"], x, cfg.moe.top_k)[2])
            g = jax.jit(jax.grad(lambda r: moe_apply_ep(
                dict(w, router=r), x, cfg, ctx)[1]))(w["router"])
            out[f"{arch}/{T}/grad"] = np.asarray(g)
        xb = rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32)
        ln = rng.normal(size=(cfg.d_model,)).astype(np.float32)
        flags = RunFlags(moe_mode="ep_shardmap", moe_seq_chunk=16)
        y, aux = jax.jit(lambda w, ln, x: moe_block(
            cfg, flags, ctx, w, ln, x, None))(w, ln, xb)
        out[f"{arch}/block/x"], out[f"{arch}/block/ln"] = xb, ln
        out[f"{arch}/block/y"], out[f"{arch}/block/aux"] = (
            np.asarray(y), np.asarray(aux))
    np.savez(sys.argv[1], **out)
''')


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("ep") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run([sys.executable, "-c", REFERENCE, str(path), *ARCHS],
        check=True, env=env, cwd=ROOT, timeout=600)
    return str(path)


def _entry(rank, world, store, ref):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        _rank_ep(ref)
    finally:
        dist.destroy_process_group()


def _rank_ep(ref_path):
    ref = dict(np.load(ref_path))
    ctx = make_ctx(make_test_mesh((2, 2)).bind("cpu"))
    t = lambda a: torch.from_numpy(a)
    for arch in ARCHS:
        cfg = smoke(get_config(arch))
        w = {k.rsplit("/", 1)[-1]: t(v) for k, v in ref.items()
             if k.startswith(f"{arch}/w/")}
        for T in (32, 31):
            key = f"{arch}/{T}"
            router = w["router"].clone().requires_grad_()
            out, aux = moe_apply_ep(dict(w, router=router), t(ref[key + "/x"]),
                                    cfg, ctx)
            want = ref[key + "/out"]
            assert np.abs(out.detach().numpy() - want).max() <= 1e-5 * max(
                1.0, np.abs(want).max()), key
            raux = float(ref[key + "/aux"])
            assert abs(float(aux) - raux) <= 1e-6 * abs(raux), key
            if T == 32:      # data shard 0's aux, not the layer's
                assert abs(raux - float(ref[key + "/aux_all"])) > 1e-4, key
            # each rank's loss holds aux / dsize; the data group sums
            (aux / ctx.dsize).backward()
            g = comm.all_reduce(router.grad, ctx.data_group[0], ctx.dsize)
            rg = ref[key + "/grad"]
            assert np.abs(g.numpy() - rg).max() <= 1e-5 * max(
                1e-3, np.abs(rg).max()), key
        key = f"{arch}/block"
        flags = tf.RunFlags(moe_mode="ep_shardmap", moe_seq_chunk=16)
        y, aux = tf.moe_block(cfg, flags, ctx, w, t(ref[key + "/ln"]),
                              t(ref[key + "/x"]))
        want = ref[key + "/y"]
        assert np.abs(y.detach().numpy() - want).max() <= 1e-5 * max(
            1.0, np.abs(want).max()), key
        raux = float(ref[key + "/aux"])
        assert abs(float(aux) - raux) <= 1e-6 * abs(raux), key


def test_moe_apply_ep_matches_reference(reference, tmp_path):
    spawn(_entry, (4, str(tmp_path / "store"), reference), 4)
