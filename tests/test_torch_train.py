"""The port's training stack vs the JAX reference, on the CPU: AdamW, one
train step, the Trainer (data, checkpoints, failure restart, CSR run
control).

The reference's state is made by its own ``make_train_state`` and handed
over as numpy (``convert.train_state_from_reference``), so both sides start
from the same parameters.  fp32 compute throughout.  Tolerances: scalars
(loss, lr, grad norm) 1e-5 relative, moments 1e-5 times max(1e-3, max|m|);
losses of later Trainer steps 1e-4 relative.  Parameters after an AdamW
step: the first update is lr * g / (|g| + eps) per element, which turns a
last-bit difference of a gradient near eps into a visible one, so each
element whose gradient is above 100 * eps is held to 1e-3 * lr and the
whole update to 1e-2 of its norm (``_assert_update_close``).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke as ref_smoke
from repro.core.transactions import TransactionLog as RefLog
from repro.data.pipeline import DataPipeline as RefPipeline
from repro.data.synthetic import SyntheticLMDataset as RefDataset
from repro.launch import steps as ref_steps
from repro.models.transformer import RunFlags as RefFlags
from repro.optim import adamw as ref_adamw
from repro.runtime import FailureInjector as RefInjector
from repro.runtime import Trainer as RefTrainer
from repro.runtime import TrainerConfig as RefTrainerConfig
from repro_torch._tree import leaves, paths
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, smoke
from repro_torch.convert import params_from_reference, train_state_from_reference
from repro_torch.core.transactions import TransactionLog
from repro_torch.data import DataPipeline, SyntheticLMDataset
from repro_torch.launch import steps
from repro_torch.models.transformer import RunFlags
from repro_torch.optim import adamw
from repro_torch.runtime import FailureInjector, Trainer, TrainerConfig

torch.set_num_threads(1)

ARCH = "llama3.2-1b"
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=3)


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in flat}


def _close(a, b, rtol=1e-5):
    return abs(float(a) - float(b)) <= rtol * max(1e-6, abs(float(b)))


def _assert_update_close(got: dict, want: dict, before: dict, lr: float,
                         b1: float = 0.9, eps: float = 1e-8):
    """``got``/``want``/``before``: leaf path -> array, with ``params/...``
    and ``m/...`` leaves.  The gradient is recovered from the first moment
    after one step (m = (1 - b1) g)."""
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


def test_lr_schedule_matches_reference():
    for cfg_kw in (dict(), OPT, dict(warmup_steps=0, total_steps=5)):
        rc = ref_adamw.AdamWConfig(**cfg_kw)
        tc = adamw.AdamWConfig(**cfg_kw)
        for step in (0, 1, 2, 3, 50, 150, 9_999, 20_000):
            want = ref_adamw.lr_schedule(rc, jnp.asarray(step))
            got = adamw.lr_schedule(tc, torch.tensor(step))
            assert _close(got, want), (cfg_kw, step)


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_adamw_update_matches_reference(scale):
    """Clip first (below and above the clip norm), moments, bias
    correction with t = step + 1, decay on every leaf — two updates."""
    rng = np.random.default_rng(4)
    tree = lambda: {"a": rng.normal(size=(5, 3)).astype(np.float32),
                    "b": {"c": rng.normal(size=(7,)).astype(np.float32)}}
    p = tree()
    grads = [jax.tree.map(lambda x: x * scale, tree()) for _ in range(2)]
    rc = ref_adamw.AdamWConfig(**OPT)
    jp, jopt = jax.tree.map(jnp.asarray, p), ref_adamw.adamw_init(p)
    tp = params_from_reference(p, device="cpu")
    topt = adamw.adamw_init(tp)
    for g in grads:
        jp, jopt, jinfo = ref_adamw.adamw_update(
            rc, jp, jax.tree.map(jnp.asarray, g), jopt)
        tp, topt, tinfo = adamw.adamw_update(
            adamw.AdamWConfig(**OPT), tp, params_from_reference(g, "cpu"),
            topt)
        assert _close(tinfo["lr"], jinfo["lr"])
        assert _close(tinfo["grad_norm"], jinfo["grad_norm"])
        assert int(topt["step"]) == int(jopt["step"])
    for name, got, want in (("params", tp, jp), ("m", topt["m"], jopt["m"]),
                            ("v", topt["v"], jopt["v"])):
        w = _jax_paths(want)
        for path, x in paths(got):
            assert np.abs(x.numpy() - w[path]).max() < 1e-5 * max(
                1e-3, np.abs(w[path]).max()), (name, path)


@pytest.fixture(scope="module")
def ref_state():
    """The reference's config and initial state as numpy (its Trainer
    donates the state it is given, so each test makes its own arrays)."""
    cfg = ref_smoke(ref_get_config(ARCH))
    st = ref_steps.make_train_state(cfg, jax.random.PRNGKey(0))
    return cfg, jax.tree.map(np.asarray, st)


def _batch(vocab, seed=0, B=4, S=32):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
def test_one_train_step_matches_reference(ref_state, impl):
    rcfg, st = ref_state
    cfg = smoke(get_config(ARCH))
    b = _batch(cfg.vocab_size)
    jst, jm = jax.jit(ref_steps.make_train_step(
        rcfg, RefFlags(attn_impl=impl, compute_dtype="float32"), None,
        ref_adamw.AdamWConfig(**OPT)))(jax.tree.map(jnp.asarray, st),
                                       {k: jnp.asarray(v)
                                        for k, v in b.items()})
    tst, tm = steps.make_train_step(
        cfg, RunFlags(attn_impl=impl, compute_dtype="float32"), None,
        adamw.AdamWConfig(**OPT))(
            train_state_from_reference(st, "cpu"),
            {k: torch.from_numpy(v) for k, v in b.items()})
    for key in ("loss", "lr", "grad_norm"):
        assert _close(tm[key], jm[key]), key
    assert int(tst["step"]) == int(jst["step"]) == 1
    want = _jax_paths(jst)
    got = {p: x.detach().numpy() for p, x in paths(tst)}
    for path in want:
        if not path.startswith(("params", "step")):
            assert np.abs(got[path] - want[path]).max() < 1e-5 * max(
                1e-3, np.abs(want[path]).max()), path
    assert all(p.requires_grad for p in leaves(tst["params"]))
    _assert_update_close(got, want, _jax_paths(st), float(jm["lr"]))


def test_microbatches_average_the_step():
    """Two microbatches of two rows give the step of one batch of four (the
    mean of the per-microbatch losses and gradients)."""
    cfg = smoke(get_config(ARCH))
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab_size, 5).items()}
    out = []
    for nm in (1, 2):
        st = steps.make_train_state(cfg, torch.Generator().manual_seed(5))
        fn = steps.make_train_step(cfg, RunFlags(
            attn_impl="pallas", compute_dtype="float32", microbatches=nm),
            None, adamw.AdamWConfig(**OPT))
        out.append(fn(st, b))
    (s1, m1), (s2, m2) = out
    assert _close(m2["loss"], m1["loss"]) and _close(m2["grad_norm"],
                                                     m1["grad_norm"], 1e-4)
    for a, c in zip(leaves(s1["m"]), leaves(s2["m"])):
        assert (a - c).abs().max() <= 1e-5 * max(1e-3, float(a.abs().max()))


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 2)])
def test_synthetic_batches_equal_reference(seed, step):
    want = RefDataset(512, 48, 4, seed=seed).batch(step)
    got = SyntheticLMDataset(512, 48, 4, seed=seed).batch(step)
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype
        assert want[k].tobytes() == got[k].tobytes()


def _trainers(tmp_path, ref_state):
    """The reference's Trainer and the port's, 3 steps from the same state,
    a transient failure injected at step 2, a checkpoint every 2 steps
    (written synchronously on both sides, so the restart point is
    deterministic)."""
    rcfg, st = ref_state
    common = dict(seq_len=32, global_batch=2, steps=3, ckpt_every=2)
    ref = RefTrainer(rcfg, RefTrainerConfig(ckpt_dir=str(tmp_path / "ref"),
                                            **common),
                     RefFlags(attn_impl="pallas", compute_dtype="float32"),
                     ref_adamw.AdamWConfig(**OPT),
                     failure_injector=RefInjector(fail_steps=[2]))
    port = Trainer(smoke(get_config(ARCH)),
                   TrainerConfig(ckpt_dir=str(tmp_path / "port"), **common),
                   RunFlags(attn_impl="pallas", compute_dtype="float32"),
                   adamw.AdamWConfig(**OPT),
                   failure_injector=FailureInjector(fail_steps=[2]),
                   device="cpu")
    ref.ckpt.async_save = port.ckpt.async_save = False
    ref_final, ref_step = ref.train(state=jax.tree.map(jnp.asarray, st))
    port_final, port_step = port.train(
        state=train_state_from_reference(st, "cpu"))
    assert ref_step == port_step == 3
    return ref, port, ref_final, port_final


def test_trainer_matches_reference(tmp_path, ref_state):
    ref, port, ref_final, port_final = _trainers(tmp_path, ref_state)
    # per-step losses, lr and grad norms; the same restart
    assert [r["step"] for r in port.metrics_log] == \
        [r["step"] for r in ref.metrics_log] == [0, 1, 2]
    for a, b in zip(port.metrics_log, ref.metrics_log):
        for key in ("loss", "lr", "grad_norm"):
            assert _close(a[key], b[key], 1e-4), (a, b)
    assert port.restarts == ref.restarts == 1
    for reg in ("STATUS", "STEP", "RESTARTS", "CTRL"):
        assert port.csr.hw_get(reg) == ref.csr.hw_get(reg), reg
    assert port.csr.hw_get("STATUS") == 2
    # checkpoints: same steps on disk, same leaf list, each side reads the
    # other's files
    assert port.ckpt.list_steps() == ref.ckpt.list_steps() == [2, 3]
    meta = [json.loads((t.ckpt.dir / "step_00000003" / "meta.json")
                       .read_text()) for t in (ref, port)]
    assert meta[0]["leaves"] == meta[1]["leaves"]
    like = steps.train_state_shape(smoke(get_config(ARCH)))
    from_ref = CheckpointManager(ref.ckpt.dir).restore(3, like, "cpu")
    mine = dict(paths(port_final))
    for path, x in paths(from_ref):
        tol = 1e-2 * OPT["lr"] if path.startswith("params") else 1e-4
        assert x.dtype == mine[path].dtype
        assert (x - mine[path].detach()).abs().max() <= tol * max(
            1.0, float(x.abs().max())), path


def test_trainer_resume_continues_from_checkpoint(tmp_path):
    cfg = smoke(get_config(ARCH))
    flags = RunFlags(attn_impl="pallas", compute_dtype="float32")
    mk = lambda n: Trainer(cfg, TrainerConfig(
        seq_len=32, global_batch=2, steps=n, ckpt_every=2,
        ckpt_dir=str(tmp_path)), flags, adamw.AdamWConfig(**OPT),
        device="cpu")
    mk(2).train()
    tr = mk(3)
    state, step = tr.train(resume=True)
    assert step == 3 and [r["step"] for r in tr.metrics_log] == [2]
    assert int(state["step"]) == 3
    assert all(p.requires_grad for p in leaves(state["params"]))


def test_trainer_gives_up_after_max_restarts(tmp_path):
    tr = Trainer(smoke(get_config(ARCH)), TrainerConfig(
        seq_len=32, global_batch=2, steps=4, ckpt_every=100, max_restarts=1,
        ckpt_dir=str(tmp_path)), RunFlags(attn_impl="naive"),
        failure_injector=FailureInjector(fail_steps=[0, 1]), device="cpu")
    with pytest.raises(Exception):
        tr.train()
    assert tr.csr.hw_get("STATUS") == 3 and tr.csr.hw_get("RESTARTS") == 2


def test_pipeline_transaction_log_equals_reference():
    """One logged host read per batch, the same canonical lines."""
    logs = []
    for pipe_cls, log_cls, kw in ((RefPipeline, RefLog, {}),
                                  (DataPipeline, TransactionLog,
                                   {"device": "cpu"})):
        log = log_cls()
        pipe = pipe_cls(SyntheticLMDataset(64, 32, 2, seed=4), start_step=5,
                        log=log, **kw)
        for _ in range(3):
            pipe.next()
        pipe.stop()
        logs.append(log)
    assert logs[1].canonical() == logs[0].canonical()
    assert len(logs[1].canonical()) == 3


def test_pipeline_places_batches_and_surfaces_worker_errors():
    pipe = DataPipeline(SyntheticLMDataset(64, 32, 2, seed=1), start_step=3,
                        device="cpu")
    step, batch = pipe.next()
    pipe.stop()
    assert step == 3 and isinstance(batch["tokens"], torch.Tensor)

    class Broken:
        def batch(self, step):
            raise ValueError("boom")
    pipe = DataPipeline(Broken(), device="cpu")
    with pytest.raises(RuntimeError, match="worker failed"):
        pipe.next()
    with pytest.raises(RuntimeError):
        pipe.next()
    pipe.stop()


def test_entry_points_refuse_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = smoke(get_config(ARCH))
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="cuda"):
        CheckpointManager(tmp_path).restore(0, {}, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        DataPipeline(SyntheticLMDataset(64, 32, 2))
    with pytest.raises(RuntimeError, match="cuda"):
        train_state_from_reference({"params": {}, "m": {}, "v": {},
                                    "step": np.int32(0)})
