"""rwkv6, zamba2 and the vlm under a sharding context compute with this
rank's share of every leaf that the reference's rule splits, and give the
results of the run without a context.

Ranks are spawned on gloo by ``tests/test_torch_sharded.py``'s harness
(one test at a time, ``tests/torch_ranks.py``) and meet through a
``FileStore`` under ``tmp_path``; each runs at
``torch.set_num_threads(1)``.  Batches, optimizer and tolerances are that
file's.  Meshes (data, model) (1, 2) on two ranks,
(2, 2) and (1, 4) on four.  Smoke sizes, fp32 compute; the vlm with its
gates open, and once more with 4 k / v heads, so that ``wk`` / ``wv`` of
its cross block are split too (smoke's one k / v head is picked whole).

For each config and mesh, on every rank:
  * the compute form (``_compute_params``) holds ``1/m`` of each leaf that
    the port's copy of the reference's ``_param_rule`` splits, along the
    rule's dim, and every other leaf whole but the time-mix's ``decay_B``
    (cut to this rank's heads' columns);
  * one train step from the same state and batch against the unsharded
    step, at ``tests/test_torch_sharded.py``'s tolerances: loss and grad
    norm 1e-5 relative, every ``m`` / ``v`` leaf 1e-5 x max(1e-3, max|m|)
    (rwkv6: 5e-5, see ``MOMENT_TOL``), the AdamW update through
    ``_update_close``;
  * the prefill of two prompts of 32 tokens and three decode steps fed the
    same tokens against the unsharded prefill and decode: every logits row
    of this rank's rows within 1e-4 x max|logit|, and every leaf of the
    prefill's cache shard (k / v, the vlm's patches, the SSM states at this
    rank's heads) within 1e-4 x max of the unsharded cache's same slice.
"""
import dataclasses
import json
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch._tree import paths
from repro_torch.configs import get_config, smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_ctx, make_test_mesh
from repro_torch.models import inputs
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import RunFlags
from repro_torch.sharding import specs
from repro_torch.sharding.specs import place, whole_tree
from test_torch_sharded import (B, OPT, S, _close, _flat, _spawn,
                                _update_close)

torch.set_num_threads(1)

PB, PS, MAX_LEN = 2, 32, 48       # prefill rows, prompt length, cache
ARCHS = ("rwkv6-7b", "zamba2-2.7b", "llama-3.2-vision-11b", "vlm-kv4")
SERVE_TOL = 1e-4
# rwkv6's backward magnifies fp32 rounding: the unsharded step against
# itself with one ulp of noise on its channel-mix output moves its moments
# by about as much as the split's reordered sums do.  Its moments are held to the ssm family's gradient
# tolerance against the reference (``tests/test_torch_ssm_train.py``:
# 5e-5 x max(1e-3, max|grad|)); the others to ``_train_steps``' 1e-5.
# ``python tests/test_torch_split_families.py`` prints both readings.
MOMENT_TOL = {"ssm": 5e-5}


def _cfg(arch):
    if arch == "vlm-kv4":
        base = smoke(get_config("llama-3.2-vision-11b"))
        return dataclasses.replace(base, n_kv_heads=4, arch="vlm-kv4")
    return smoke(get_config(arch))


def _open_gates(cfg, params):
    if cfg.family == "vlm":
        with torch.no_grad():
            for g in ("gate", "gate_mlp"):
                params["blocks"]["cross"][g].fill_(0.5)
    return params


def _state(cfg):
    st = steps.make_train_state(cfg, torch.Generator().manual_seed(5))
    _open_gates(cfg, st["params"])
    return st


def _model_dim(spec):
    dims = [d for d, e in enumerate(tuple(spec)) if e == "model"]
    return dims[0] if dims else None


def _compute_form(cfg, flags, ctx, params) -> int:
    """Holds the compute form's shapes to the rule; -> split leaves."""
    m = ctx.msize
    with torch.no_grad():
        form = tf._compute_params(cfg, flags, params, ctx)
    whole = dict(paths(whole_tree(params)))
    n = 0
    for p, t in paths(form):
        w = whole[p]
        dim = _model_dim(specs._param_rule(cfg, p, tuple(w.shape), m,
                                           "model"))
        if dim is None and p == "blocks/rwkv/tmix/decay_B":
            dim = w.dim() - 1
        want = list(w.shape)
        if dim is not None:
            want[dim] //= m
            n += 1
        assert list(t.shape) == want, (cfg.arch, p, tuple(t.shape), want)
    return n


def _batch(cfg):
    return inputs.make_train_batch(cfg, B, S,
                                   torch.Generator().manual_seed(1))


def _moment_gap(got: dict, want: dict) -> float:
    """The largest |got - want| over every ``m`` / ``v`` leaf, over
    max(1e-3, max|want|) of that leaf."""
    return max(float(np.abs(got[p] - want[p]).max()
                     / max(1e-3, np.abs(want[p]).max()))
               for p in want if p.startswith(("m/", "v/")))


def _train_step(cfg, flags, ctx, mesh) -> tuple:
    """-> (the compute form's split leaves, the moments' gap)."""
    batch = _batch(cfg)
    before = _flat(_state(cfg))
    rst, rm = steps.make_train_step(cfg, flags, None, OPT)(_state(cfg),
                                                           dict(batch))
    _, st_sh, _, _, gsh = steps.train_shardings(
        cfg, ShapeConfig("t", S, B, "train"), mesh, ctx)
    st = place(_state(cfg), st_sh)
    n_split = _compute_form(cfg, flags, ctx, st["params"])
    sst, sm = steps.make_train_step(cfg, flags, ctx, OPT,
                                    grad_shardings=gsh)(st, dict(batch))
    for key in ("loss", "lr", "grad_norm"):
        assert _close(sm[key], rm[key]), (cfg.arch, key, float(sm[key]),
                                          float(rm[key]))
    got, want = _flat(whole_tree(sst)), _flat(rst)
    gap = _moment_gap(got, want)
    assert gap <= MOMENT_TOL.get(cfg.family, 1e-5), (cfg.arch, gap)
    _update_close(got, want, before, float(rm["lr"]))
    return n_split, gap


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / max(1e-6, float(want.float().abs().max())))


def _serve(cfg, flags, ctx, mesh):
    """Prefill + 3 decode steps with and without ``ctx``."""
    params = _open_gates(cfg, tf.init_params(
        cfg, torch.Generator().manual_seed(11)))
    batch = inputs.make_prefill_batch(cfg, PB, PS,
                                      torch.Generator().manual_seed(2))
    want_l, want_c = tf.make_prefill_fn(cfg, flags, None, MAX_LEN)(
        params, batch)
    _, p_sh, _, _ = steps.prefill_shardings(
        cfg, ShapeConfig("p", PS, PB, "prefill"), mesh, ctx)
    sp = place(params, p_sh)
    got_l, got_c = tf.make_prefill_fn(cfg, flags, ctx, MAX_LEN)(sp, batch)
    split = ctx.splits_batch(PB)
    rows = slice(ctx.data_rank * (PB // ctx.dsize),
                 (ctx.data_rank + 1) * (PB // ctx.dsize)) if split \
        else slice(0, PB)
    worst = _rel(got_l, want_l[rows])
    _, cspecs = tf.cache_layout(cfg, ctx, PB, MAX_LEN, PS)
    for name, i, t, spec in tf._leaf_items(got_c, cspecs):
        w = want_c[name] if i is None else want_c[name][i]
        w = tf._local_dims(w, spec, ctx)
        assert t.shape == w.shape, (cfg.arch, name, i, t.shape, w.shape)
        if t.is_floating_point():
            assert _rel(t, w) <= SERVE_TOL, (cfg.arch, name, i, _rel(t, w))
        else:
            assert torch.equal(t, w), (cfg.arch, name, i)
    dec = tf.make_decode_fn(cfg, flags, ctx, MAX_LEN)
    dec0 = tf.make_decode_fn(cfg, flags, None, MAX_LEN)
    toks = torch.argmax(want_l[:, :cfg.vocab_size], dim=-1).to(torch.int32)
    for _ in range(3):
        want_l, want_c = dec0(params, want_c, toks)
        got_l, got_c = dec(sp, got_c, toks)
        worst = max(worst, _rel(got_l, want_l[rows]))
        toks = torch.argmax(want_l[:, :cfg.vocab_size], dim=-1).to(
            torch.int32)
    assert worst <= SERVE_TOL, (cfg.arch, worst)


def _rank(mshape, archs, kw, gaps=None):
    """One rank's checks; with ``gaps``, rank 0 writes each config's
    moments' gap there (JSON)."""
    mesh = make_test_mesh(mshape).bind("cpu")
    ctx = make_ctx(mesh)
    out = {}
    for arch in archs:
        cfg = _cfg(arch)
        flags = RunFlags(attn_impl="pallas", compute_dtype="float32", **kw)
        n_split, out[arch] = _train_step(cfg, flags, ctx, mesh)
        assert n_split > 0, arch
        _serve(cfg, flags, ctx, mesh)
    if gaps is not None and torch.distributed.get_rank() == 0:
        Path(gaps).write_text(json.dumps(out))


@pytest.mark.parametrize("mshape,kw", [
    ((1, 2), {}), ((2, 2), {}), ((1, 4), {"remat": False})],
    ids=["1x2", "2x2", "1x4-no-remat"])
def test_split_families_equal_unsharded(tmp_path, mshape, kw):
    """2 / 4 gloo ranks: each of ``ARCHS`` — its compute form's shapes, one
    train step, and a prefill with three decode steps — against the run
    without a context (see the module docstring)."""
    _spawn(tmp_path, int(np.prod(mshape)), _rank, mshape, ARCHS, kw)


def _ulp_gap(arch) -> float:
    """The unsharded step against itself with one ulp of relative noise
    (a seeded sign an element) on every channel-mix output: the moments'
    gap."""
    from repro_torch.models import rwkv6
    cfg, mix = _cfg(arch), rwkv6.channel_mix

    def noisy(*args, **kwargs):
        y, shift = mix(*args, **kwargs)
        sign = torch.randint(0, 2, y.shape, generator=torch.Generator()
                             .manual_seed(3)) * 2 - 1
        return y * (1 + sign * torch.finfo(y.dtype).eps), shift

    runs = []
    for fn in (mix, noisy):
        rwkv6.channel_mix = fn
        try:
            runs.append(_flat(steps.make_train_step(cfg, RunFlags(
                attn_impl="pallas", compute_dtype="float32"), None, OPT)(
                    _state(cfg), dict(_batch(cfg)))[0]))
        finally:
            rwkv6.channel_mix = mix
    return _moment_gap(*runs)


if __name__ == "__main__":
    # the readings behind MOMENT_TOL: rwkv6's unsharded step against
    # itself in another summation order, then every config's sharded
    # step against the unsharded one on each mesh of the test
    print(f"rwkv6-7b unsharded, one ulp on the channel-mix output: "
          f"{_ulp_gap('rwkv6-7b'):.3g}")
    for mshape, kw in (((1, 2), {}), ((2, 2), {}),
                       ((1, 4), {"remat": False})):
        with tempfile.TemporaryDirectory() as d:
            _spawn(Path(d), int(np.prod(mshape)), _rank, mshape, ARCHS, kw,
                   str(Path(d) / "gaps.json"))
            gaps = json.loads((Path(d) / "gaps.json").read_text())
        print(f"mesh {mshape}: " + ", ".join(
            f"{a} {g:.3g}" for a, g in gaps.items()))
