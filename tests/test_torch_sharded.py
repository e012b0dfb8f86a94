"""The port's sharded paths on ``torch.distributed`` (gloo, CPU), each
against the same path without a sharding context.

Every test spawns its ranks (``torch.multiprocessing``, spawn; one test at
a time across pytest's workers, ``tests/torch_ranks.py``), which meet
through a ``FileStore`` under ``tmp_path`` (no TCP port) and run at
``torch.set_num_threads(1)``; a rank's failure fails the test.  Smoke
sizes, fp32 compute unless said otherwise.  Tolerances are
``tests/test_torch_train.py``'s: loss and grad norm 1e-5 relative,
moments 1e-5 x max(1e-3, max|m|), the parameters' AdamW update through
``_update_close`` (elements whose gradient is above 100 eps to 1e-3 lr,
the whole update to 1e-2 of its norm); later Trainer losses 1e-4.

Cases of the train step: smoke llama3.2-1b (H 4, KH 1: the model axis
does not divide KH, so each rank picks its query heads' k / v head from
all of them) at zero levels 0 / 1 / 3, one and two microbatches, with and
without ``sequence_parallel``, both ``remat_policy`` values; smoke
moonshot (KH 4: k / v heads split) under both ``moe_mode``s — the
expert-parallel layer on a mesh whose data axis is one rank, where its
per-data-shard capacity and aux are the global ones (on a data axis of
two they are the reference's own, held by ``tests/test_torch_ep.py``);
and a config of 12 heads over 3 k / v heads, where two ranks' query heads
straddle a k / v group (one k / v head a query head).
"""
import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch._tree import paths
from repro_torch.configs import get_config, smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_ctx, make_test_mesh
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import RunFlags
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.sharding.specs import place, to_shardings, whole_tree
from torch_ranks import spawn

torch.set_num_threads(1)

OPT = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=3)
B, S = 4, 32


# ---------------------------------------------------------------------------
# harness
# ---------------------------------------------------------------------------


def _entry(rank, world, store, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, world, fn, *args):
    spawn(_entry, (world, str(tmp_path / "store"), fn, args), world)


def _close(a, b, rtol=1e-5):
    return abs(float(a) - float(b)) <= rtol * max(1e-6, abs(float(b)))


def _np(t):
    return t.detach().float().numpy()


def _update_close(got: dict, want: dict, before: dict, lr: float,
                  b1: float = 0.9, eps: float = 1e-8):
    num = den = 0.0
    for path in (p for p in want if p.startswith("params/")):
        g = np.abs(want["m/" + path[len("params/"):]]) / (1 - b1)
        d = np.abs(got[path] - want[path])
        sure = g > 100 * eps
        assert not sure.any() or d[sure].max() <= 1e-3 * lr, path
        num += float(np.square((got[path] - before[path])
                               - (want[path] - before[path])).sum())
        den += float(np.square(want[path] - before[path]).sum())
    assert num <= 1e-4 * den, (num / den) ** 0.5


def _flat(state) -> dict:
    return {p: _np(x) for p, x in paths(state)}


def _batch(cfg, seed=1):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                             dtype=torch.int32) for k in ("tokens", "labels")}


def _straddling_cfg():
    """12 query heads over 3 k / v heads (G = 4): on two model ranks each
    rank's 6 query heads straddle a k / v group."""
    base = smoke(get_config("llama3.2-1b"))
    return dataclasses.replace(base, n_heads=12, n_kv_heads=3,
                               arch="straddle-12q-3kv")


def _cfg(arch):
    return _straddling_cfg() if arch == "straddle" else smoke(get_config(arch))


# ---------------------------------------------------------------------------
# embedding, logits, train step
# ---------------------------------------------------------------------------

STEP_CASES = [
    ("llama3.2-1b", (2, 2), 0, {}),
    ("llama3.2-1b", (2, 2), 1, {"microbatches": 2}),
    ("llama3.2-1b", (2, 2), 3, {"sequence_parallel": True}),
    ("llama3.2-1b", (2, 2), 1, {"remat_policy": "save_block_io",
                                "sequence_parallel": True}),
    ("llama3.2-1b", (1, 4), 3, {"microbatches": 2,
                                "remat_policy": "save_block_io"}),
    ("llama3.2-1b", (4, 1), 1, {"remat": False}),
    ("moonshot-v1-16b-a3b", (2, 2), 1, {}),
    ("moonshot-v1-16b-a3b", (2, 2), 3, {"remat_policy": "save_block_io",
                                        "microbatches": 2}),
    ("moonshot-v1-16b-a3b", (1, 4), 1, {"moe_mode": "ep_shardmap"}),
    ("moonshot-v1-16b-a3b", (1, 4), 0, {"moe_mode": "ep_shardmap",
                                        "remat_policy": "save_block_io",
                                        "sequence_parallel": True}),
    ("straddle", (2, 2), 1, {}),
]


def _embed_logits(out):
    """embed_lookup / lm_logits with a context equal the plain ones (tied
    and untied heads, whole or DTensor parameters)."""
    for arch in ("llama3.2-1b", "moonshot-v1-16b-a3b"):
        cfg = smoke(get_config(arch))
        params = tf.init_params(cfg, torch.Generator().manual_seed(3))
        ids = _batch(cfg)["tokens"]
        x = torch.randn((B, S, cfg.d_model),
                        generator=torch.Generator().manual_seed(4))
        want_e = tf.embed_lookup(cfg, params, ids)
        want_l = tf.lm_logits(cfg, params, x)
        for shape in ((2, 2), (1, 4)):
            mesh = make_test_mesh(shape).bind("cpu")
            ctx = make_ctx(mesh)
            shard = place(params, to_shardings(steps.param_specs(
                cfg, params, mesh), mesh))
            for p in (params, shard):
                assert torch.equal(tf.embed_lookup(cfg, p, ids, ctx), want_e)
                got = tf.lm_logits(cfg, p, x, ctx)
                assert (got - want_l).abs().max() <= 1e-5 * float(
                    want_l.abs().max()), (arch, shape)
    out.append("embed_logits")


def _train_steps(cases, out):
    for arch, mshape, zl, kw in cases:
        cfg = _cfg(arch)
        flags = RunFlags(attn_impl="pallas", compute_dtype="float32", **kw)
        batch = _batch(cfg)
        before = _flat(steps.make_train_state(
            cfg, torch.Generator().manual_seed(5)))
        rst, rm = steps.make_train_step(cfg, flags, None, OPT)(
            steps.make_train_state(cfg, torch.Generator().manual_seed(5)),
            dict(batch))
        mesh = make_test_mesh(mshape).bind("cpu")
        ctx = make_ctx(mesh)
        _, st_sh, _, _, gsh = steps.train_shardings(
            cfg, ShapeConfig("t", S, B, "train"), mesh, ctx, zero_level=zl)
        st = place(steps.make_train_state(
            cfg, torch.Generator().manual_seed(5)), st_sh)
        sst, sm = steps.make_train_step(cfg, flags, ctx, OPT,
                                        grad_shardings=gsh)(st, dict(batch))
        case = (arch, mshape, zl, kw)
        for key in ("loss", "lr", "grad_norm"):
            assert _close(sm[key], rm[key]), (case, key)
        got, want = _flat(whole_tree(sst)), _flat(rst)
        for path in want:
            if path.startswith(("m/", "v/")):
                assert np.abs(got[path] - want[path]).max() <= 1e-5 * max(
                    1e-3, np.abs(want[path]).max()), (case, path)
        assert int(got["step"]) == 1
        _update_close(got, want, before, float(rm["lr"]))
        # the state keeps its layout, and its params their gradients
        assert all(p.requires_grad for _, p in paths(sst["params"]))
        assert all(type(x).__name__ == "DTensor" for _, x in paths(sst))
        out.append(case)


def _rank_embed_and_steps(cases, embed):
    out = []
    if embed:
        _embed_logits(out)
    _train_steps(cases, out)
    assert len(out) == len(cases) + embed


@pytest.mark.parametrize("part", [0, 1])
def test_embed_logits_and_train_steps_equal_unsharded(tmp_path, part):
    """4 gloo ranks: the vocab-parallel lookup and logits (part 0), then
    one train step per case of ``STEP_CASES`` (half of them a part)
    against the unsharded step from the same state and batch."""
    half = (len(STEP_CASES) + 1) // 2
    cases = STEP_CASES[:half] if part == 0 else STEP_CASES[half:]
    _spawn(tmp_path, 4, _rank_embed_and_steps, cases, part == 0)


# ---------------------------------------------------------------------------
# Trainer + rescale, checkpoint restore with shardings
# ---------------------------------------------------------------------------


def _tcfg(directory, steps_):
    from repro_torch.runtime import TrainerConfig
    return TrainerConfig(seq_len=S, global_batch=B, steps=steps_,
                         ckpt_every=100, ckpt_dir=str(directory), seed=2)


def _rank_trainer(tmp):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.runtime import Trainer
    cfg = smoke(get_config("llama3.2-1b"))
    flags = RunFlags(attn_impl="pallas", compute_dtype="float32")
    rank = dist.get_rank()
    plain = Trainer(cfg, _tcfg(f"{tmp}/plain{rank}", 4), flags, OPT,
                    device="cpu")
    want, _ = plain.train()
    m21 = make_test_mesh((2, 1)).bind("cpu")
    tr = Trainer(cfg, _tcfg(f"{tmp}/sharded", 2), flags, OPT, mesh=m21,
                 ctx=make_ctx(m21), device="cpu")
    st, step = tr.train()
    assert step == 2 and tr.ckpt.latest_step() == 2
    m12 = make_test_mesh((1, 2)).bind("cpu")
    st = tr.rescale(st, m12, make_ctx(m12))
    assert st["params"]["embed"].device_mesh is m12.device_mesh
    tr.tcfg.steps = 4
    st, step = tr.train(st, start_step=2)
    for a, b in zip(tr.metrics_log, plain.metrics_log):
        assert a["step"] == b["step"]
        assert _close(a["loss"], b["loss"], 1e-4), (a, b)
        assert _close(a["grad_norm"], b["grad_norm"], 1e-4), (a, b)
    got, ref = _flat(whole_tree(st)), _flat(want)
    for path in ref:
        tol = 1e-2 * OPT.lr if path.startswith("params") else 1e-4
        assert np.abs(got[path] - ref[path]).max() <= tol * max(
            1e-3, np.abs(ref[path]).max()), path
    # the port's twin of tests/test_runtime.py's reshard on restore:
    # written from (2, 1), read back into (1, 2)'s layouts
    mgr = CheckpointManager(f"{tmp}/ck", keep=2, async_save=False)
    state = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4),
             "step": torch.tensor(7, dtype=torch.int32)}
    dist.barrier()
    for s in (3, 5, 9):
        mgr.save(s, place(state, to_shardings(
            {"w": tf_spec("data", None), "step": tf_spec()}, m21)))
    dist.barrier()
    assert mgr.list_steps() == [5, 9]
    like = {k: torch.empty_like(v, device="meta") for k, v in state.items()}
    sh = to_shardings({"w": tf_spec(None, "model"), "step": tf_spec()}, m12)
    got = mgr.restore(9, like, "cpu", shardings=sh)
    assert torch.equal(got["w"].full_tensor(), state["w"])
    assert tuple(got["w"].placements) == sh["w"].placements
    assert got["w"].to_local().shape == (4, 2)
    assert int(got["step"].full_tensor()) == 7


def tf_spec(*axes):
    from repro_torch.sharding.specs import P
    return P(*axes)


def test_trainer_rescale_and_restore_with_shardings(tmp_path):
    """2 gloo ranks: a ``Trainer(mesh, ctx)`` on (data 2, model 1) trains
    two steps, ``rescale`` moves its state to (data 1, model 2), two more
    steps follow; losses, grad norms and the final state against an
    unsharded Trainer's four steps.  Then a checkpoint written from one
    mesh restores into another's layouts."""
    _spawn(tmp_path, 2, _rank_trainer, str(tmp_path))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


SERVE_CASES = [("llama3.2-1b", "pjit"), ("moonshot-v1-16b-a3b", "pjit"),
               ("zamba2-2.7b", "pjit"), ("llama-3.2-vision-11b", "pjit"),
               ("rwkv6-7b", "pjit")]


def _local_shapes(shardings, like) -> dict:
    """{leaf path: this rank's shard shape} of the whole tree ``like`` by
    its shardings."""
    out = {}
    for (p, t), (_, sh) in zip(paths(like), _sharding_paths(shardings)):
        idx = sh.local_index(tuple(t.shape), sh.mesh.coordinate())
        out[p] = tuple(s.stop - s.start for s in idx)
    return out


def _sharding_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _sharding_paths(v, f"{prefix}{k}/")
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from _sharding_paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _shapes_of(tree) -> dict:
    return {p: tuple(getattr(t, "to_local", lambda: t)().shape)
            for p, t in paths(tree)}


def _serve(cfg, params, flags, ctx, prompts, max_len=64):
    """Serves ``prompts`` (5 new tokens each) -> (tokens, the logits each
    token was taken from, the engine); under ``ctx`` each prefill's shard
    and, after every tick, each cache leaf's local shape are held to
    ``cache_specs``' local shapes."""
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.sharding.specs import to_shardings
    eng = ServingEngine(cfg, params, max_slots=4, max_len=max_len,
                        flags=flags, ctx=ctx, device="cpu")
    logits_of = {i: [] for i in range(len(prompts))}
    prefill, decode, admit = eng._prefill, eng._decode, eng._prefill_admit
    seen = {}

    def checked(p, batch):
        logits, single = prefill(p, batch)
        seen["prefill"] = logits[0]
        if ctx is not None:
            S = batch["tokens"].shape[1]
            shape, specs = tf.cache_layout(cfg, ctx, 1, max_len, S)
            assert _shapes_of(single) == _local_shapes(
                to_shardings(specs, ctx.mesh), shape), S
        return logits, single

    def logged_admit(slot, req):
        admit(slot, req)
        logits_of[req.rid].append(seen["prefill"])

    def logged_decode(p, cache, toks):
        # this rank's rows of the slots (all of them where rows are whole)
        logits, cache = decode(p, cache, toks)
        lo = 0 if logits.shape[0] == eng.max_slots else \
            ctx.data_rank * logits.shape[0]
        for i, r in enumerate(eng.slots):
            if r is not None and lo <= i < lo + logits.shape[0]:
                logits_of[r.rid].append(logits[i - lo])
        return logits, cache
    eng._prefill, eng._decode = checked, logged_decode
    eng._prefill_admit = logged_admit
    if ctx is not None:
        want = _local_shapes(eng._cache_sh, eng._cache_shape)
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, 5))
    while eng.pending or eng._n_active():
        eng.step()
        if ctx is not None:
            assert _shapes_of(eng.cache) == want
            assert all(type(t).__name__ == "DTensor"
                       for _, t in paths(eng.cache))
    return ({r.rid: list(r.out_tokens) for r in eng.requests.values()},
            logits_of, eng)


def _serve_case(arch, mode):
    """(cfg, params, flags) of a serving case (the vlm with its gates
    open)."""
    cfg = smoke(get_config(arch))
    params = tf.init_params(cfg, torch.Generator().manual_seed(11))
    if cfg.family == "vlm":
        for g in ("gate", "gate_mlp"):
            params["blocks"]["cross"][g] = torch.full_like(
                params["blocks"]["cross"][g], 0.5)
    return cfg, params, RunFlags(compute_dtype="float32", moe_mode=mode)


def _rank_serving(mshape, cases):
    ctx = make_ctx(make_test_mesh(mshape).bind("cpu"))
    for (arch, mode), prompts, want, want_logits in cases:
        cfg, params, flags = _serve_case(arch, mode)
        got, got_logits, eng = _serve(cfg, params, flags, ctx, prompts)
        assert got == want, (arch, mode, mshape)
        # every logits row this rank computed (the prefill's, and the
        # decode steps' where the request's slot is on this data shard),
        # against the unsharded one that gave the same token: within
        # 2^-5 x max|logit|.  The cache is bf16 and decode attention
        # rounds its weights to the cache's type: the split rounds each
        # slice's unnormalised weights, the whole path the normalised ones
        # (at most 0.0050 x max|logit| over these cases; 2.0e-6 for
        # rwkv6, whose split sums are only its row-parallel projections')
        for rid, rows in got_logits.items():
            assert len(rows) in (1, len(want[rid])), (rid, len(rows))
            for j, row in enumerate(rows):
                ref = want_logits[rid][j]
                err = float((row - ref).abs().max() / ref.abs().max())
                assert err <= 2.0 ** -5, (arch, mode, mshape, rid, j, err)
        if "k" in eng.cache:
            dsize, msize = ctx.mesh.shape
            assert eng.cache["k"].to_local().shape[1:3] == (4 // dsize,
                                                            64 // msize)


@pytest.mark.parametrize("mshape", [(2, 2), (1, 4)])
def test_serving_engine_with_a_context_gives_the_same_tokens(tmp_path,
                                                            mshape):
    """4 gloo ranks: ``ServingEngine(ctx=...)`` (parameters placed by
    ``prefill_shardings``, the cache as DTensors in ``decode_shardings``'
    layout) serves five requests with the tokens of the engine without a
    context, on mesh (2, 2) (rows and positions split) and (1, 4)
    (positions split four ways): smoke llama3.2-1b, moonshot (the pjit
    layer, its experts split), zamba2, the vlm (gates open) and rwkv6;
    and on (1, 4) moonshot's expert-parallel layer.  Each prefill's shard
    and, after every tick, each cache leaf hold ``cache_specs``' local
    shapes.  The checks changed with the layout: the engine used to hold
    the whole cache for each step, and the test read only the k leaf's
    shape.  On a data axis of two the expert-parallel layer sizes each
    data shard's capacity from its own tokens, as the reference's does,
    so its drops are not the global layer's (held against the reference
    in ``tests/test_torch_ep.py``).  The engine without a context runs once,
    in this process; each rank holds its tokens, and every logits row it
    computed to the unsharded row of the same token within 2^-5 x
    max|logit| (fp32 compute over the bf16 cache)."""
    rng = np.random.default_rng(7)
    cases = []
    for arch, mode in SERVE_CASES + (
            [("moonshot-v1-16b-a3b", "ep_shardmap")] if mshape == (1, 4)
            else []):
        cfg, params, flags = _serve_case(arch, mode)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in (5, 16, 9, 20, 3)]
        # the engine without a context, once, here
        cases.append(((arch, mode), prompts,
                      *_serve(cfg, params, flags, None, prompts)[:2]))
    _spawn(tmp_path, 4, _rank_serving, mshape, cases)


# ---------------------------------------------------------------------------
# one-rank context and mesh binding (no spawn)
# ---------------------------------------------------------------------------


def test_one_rank_context_runs_without_a_process_group():
    """Every size of a (1, 1) mesh is one: the sharded paths communicate
    nothing and equal ``ctx=None`` bit for bit, unbound."""
    cfg = smoke(get_config("moonshot-v1-16b-a3b"))
    params = tf.init_params(cfg, torch.Generator().manual_seed(3))
    ctx = make_ctx(make_test_mesh((1, 1)))
    batch = {"tokens": _batch(cfg)["tokens"]}
    for mode in ("pjit", "ep_shardmap"):
        flags = RunFlags(compute_dtype="float32", moe_mode=mode)
        want = tf.make_prefill_fn(cfg, flags, None, 40)(params, batch)
        got = tf.make_prefill_fn(cfg, flags, ctx, 40)(params, batch)
        assert torch.equal(got[0], want[0])
        for (p, a), (_, b) in zip(paths(got[1]), paths(want[1])):
            assert torch.equal(a, b), p


def test_bind_refuses_a_mesh_of_another_size():
    """``Mesh.bind`` needs a process group, of the mesh's size."""
    with pytest.raises(RuntimeError, match="process group"):
        make_test_mesh((2, 2)).bind("cpu")
    d = tempfile.mkdtemp()
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(d, "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="needs 4 ranks"):
            make_test_mesh((2, 2)).bind("cpu")
        m = make_test_mesh((1, 1)).bind("cpu")
        assert m.bound and m.coordinate() == (0, 0)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_two_card_train_step_equals_unsharded(tmp_path):
    """2 NCCL ranks, one card each, mesh (1, 2): one bf16 train step of
    smoke llama3.2-1b through the attention kernels, against the
    unsharded step (bf16: 1e-2 relative)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (a (1, 2) mesh over NCCL, one "
                    "card a rank)")
    _spawn_nccl(tmp_path, 2, _rank_nccl_step)


def _entry_nccl(rank, world, store, fn, args):
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def _spawn_nccl(tmp_path, world, fn, *args):
    spawn(_entry_nccl, (world, str(tmp_path / "store"), fn, args), world)


def _rank_nccl_step():
    cfg = smoke(get_config("llama3.2-1b"))
    flags = RunFlags(attn_impl="pallas")
    dev = torch.device("cuda", dist.get_rank())
    batch = {k: v.to(dev) for k, v in _batch(cfg).items()}
    rst, rm = steps.make_train_step(cfg, flags, None, OPT)(
        steps.make_train_state(cfg, torch.Generator(dev).manual_seed(5)),
        dict(batch))
    mesh = make_test_mesh((1, 2)).bind("cuda")
    ctx = make_ctx(mesh)
    _, st_sh, _, _, gsh = steps.train_shardings(
        cfg, ShapeConfig("t", S, B, "train"), mesh, ctx)
    st = place(steps.make_train_state(
        cfg, torch.Generator(dev).manual_seed(5)), st_sh)
    _, sm = steps.make_train_step(cfg, flags, ctx, OPT, gsh)(st, batch)
    assert _close(sm["loss"], rm["loss"], 1e-2)
