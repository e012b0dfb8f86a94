"""One train step of the moe, vlm and audio families vs the JAX reference,
on the CPU: moonshot-v1-16b-a3b (moe), llama-3.2-vision-11b (vlm) and
hubert-xlarge (audio) at smoke size, fp32 compute, through
``launch/steps.py::make_train_step`` on both sides (loss + 0.01 aux,
backward, AdamW).

The reference's state is made by its own ``make_train_state`` and handed
over as numpy (``convert.train_state_from_reference``), so both sides start
from the same parameters; the batch is made with numpy.  The vlm's gates
are set nonzero and its patches are random, as in
``tests/test_torch_families.py``: at init the gates are zero, and the
cross layers would add nothing (nor see a gradient).  ``pallas`` runs the
reference's Pallas kernels in interpret mode (as its own tests run them on
the CPU) and the port's plain versions; ``chunked`` the two chunked
attentions.  moonshot also runs two microbatches, where the aux loss is
averaged through the microbatches with the loss.

Tolerances are ``tests/test_torch_train.py``'s for the step: loss, lr and
grad norm 1e-5 relative; every leaf of ``m`` and ``v`` within 1e-5 times
max(1e-3, max|leaf|); the parameters after the AdamW step each element
whose gradient is above 100 * eps within 1e-3 * lr, the whole update within
1e-2 of its norm (``_assert_update_close``: the first update is
lr * g / (|g| + eps), which magnifies a last-bit difference of a gradient
near eps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke as ref_smoke
from repro.launch import steps as ref_steps
from repro.models.transformer import RunFlags as RefFlags
from repro.optim import adamw as ref_adamw
from repro_torch._tree import leaves, paths
from repro_torch.configs import get_config, smoke
from repro_torch.convert import train_state_from_reference
from repro_torch.launch import steps
from repro_torch.models.transformer import RunFlags
from repro_torch.optim import adamw
from test_torch_train import _assert_update_close, _close, _jax_paths

torch.set_num_threads(1)

MOE, VLM, AUDIO = ("moonshot-v1-16b-a3b", "llama-3.2-vision-11b",
                   "hubert-xlarge")
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=3)
B, S = 4, 32


def _ref_state(arch):
    """The reference's smoke config and initial state as numpy; the vlm's
    gates set as tests/test_torch_families.py sets them."""
    rcfg = ref_smoke(ref_get_config(arch))
    st = jax.tree.map(np.asarray, ref_steps.make_train_state(
        rcfg, jax.random.PRNGKey(0)))
    if rcfg.family == "vlm":
        cross = st["params"]["blocks"]["cross"]
        n = cross["gate"].shape[0]
        cross["gate"] = np.linspace(0.5, 1.2, n, dtype=np.float32)
        cross["gate_mlp"] = np.linspace(-0.8, 0.6, n, dtype=np.float32)
    return rcfg, st


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "frames":
        out["frames"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    if cfg.frontend == "tokens+patches":
        out["patches"] = rng.normal(
            size=(B, cfg.n_media_tokens, cfg.d_model)).astype(np.float32)
    out["labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return out


def _flags(impl, microbatches):
    return dict(attn_impl=impl, q_chunk=16, kv_chunk=16,
                compute_dtype="float32", microbatches=microbatches)


def _check_step(arch, impl, microbatches=1):
    rcfg, st = _ref_state(arch)
    cfg = smoke(get_config(arch))
    b = _batch(cfg)
    jst, jm = jax.jit(ref_steps.make_train_step(
        rcfg, RefFlags(**_flags(impl, microbatches)), None,
        ref_adamw.AdamWConfig(**OPT)))(
            jax.tree.map(jnp.asarray, st),
            {k: jnp.asarray(v) for k, v in b.items()})
    tst, tm = steps.make_train_step(
        cfg, RunFlags(**_flags(impl, microbatches)), None,
        adamw.AdamWConfig(**OPT))(
            train_state_from_reference(st, "cpu"),
            {k: torch.from_numpy(v) for k, v in b.items()})
    for key in ("loss", "lr", "grad_norm"):
        assert _close(tm[key], jm[key]), (key, float(tm[key]), float(jm[key]))
    assert int(tst["step"]) == int(jst["step"]) == 1
    want = _jax_paths(jst)
    got = {p: x.detach().numpy() for p, x in paths(tst)}
    assert sorted(got) == sorted(want)
    for path in want:
        if path.startswith(("m/", "v/")):
            assert np.abs(got[path] - want[path]).max() < 1e-5 * max(
                1e-3, np.abs(want[path]).max()), path
    assert all(p.requires_grad for p in leaves(tst["params"]))
    _assert_update_close(got, want, _jax_paths(st), float(jm["lr"]))
    return got


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
@pytest.mark.parametrize("arch", [MOE, VLM, AUDIO])
def test_one_train_step_matches_reference(arch, impl):
    got = _check_step(arch, impl)
    if arch == VLM:
        # the cross layers took part: every one of their weights moved
        # its first moment
        cross = [x for p, x in got.items() if p.startswith("m/blocks/cross/w")]
        assert cross and min(float(np.abs(m).max()) for m in cross) > 0


def test_moe_microbatched_step_matches_reference():
    """Two microbatches of two rows: the loss, with its 0.01 aux, and the
    gradients averaged over them on both sides."""
    _check_step(MOE, "pallas", microbatches=2)
