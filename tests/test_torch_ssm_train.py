"""Training of the ssm (rwkv6) and hybrid (zamba2) families through the
port, against the JAX reference, on the CPU; the scan wrappers'
recompute backward; the ``jit`` switch of the co-verification tables.

The reference trains these families by ``jax.value_and_grad`` through
the lax scans of its ``_wkv_chunk`` / ``_ssd_chunk`` (its forward never
calls its Pallas scans).  The port's forward runs the scan kernels'
wrappers (here, on CPU tensors, their plain versions), whose backward
runs the forward again through the port's twins of those lax scans and
differentiates that (``kernels/_recompute.py``).  Tolerances are the
dense family's (``tests/test_torch_models.py``): loss 1e-5 relative,
every gradient leaf 5e-5 times max(1e-3, max|grad|), fp32 compute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke as ref_smoke
import repro.core as ref_core
from repro.kernels.systolic_matmul import sweep as ref_mm
from repro.models import transformer as ref_tf
from repro_torch._tree import leaves, paths
from repro_torch.configs import get_config, smoke
from repro_torch.convert import params_from_reference
import repro_torch.core as port_core
from repro_torch.kernels.flash_attention import sweep as fa_sweep
from repro_torch.kernels.mamba2_scan import ops as ssd_ops
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.kernels.systolic_matmul import sweep as mm_sweep
from repro_torch.models import transformer as tf

torch.set_num_threads(1)

B, S = 2, 64


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in flat}


def _batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


@pytest.mark.parametrize("arch,impl", [("rwkv6-7b", "chunked"),
                                       ("zamba2-2.7b", "chunked"),
                                       ("zamba2-2.7b", "pallas")])
def test_ssm_and_hybrid_loss_and_grads_match_reference(arch, impl):
    rcfg, cfg = ref_smoke(ref_get_config(arch)), smoke(get_config(arch))
    flags = dict(attn_impl=impl, q_chunk=16, kv_chunk=16,
                 compute_dtype="float32")
    batch = _batch(cfg.vocab_size)
    p = ref_tf.init_params(rcfg, jax.random.PRNGKey(0))
    (want, _), want_g = jax.jit(jax.value_and_grad(
        ref_tf.make_loss_fn(rcfg, ref_tf.RunFlags(**flags), None),
        has_aux=True))(p, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_reference(jax.tree.map(np.asarray, p), device="cpu")
    ts = leaves(tp)
    for t in ts:
        t.requires_grad_()
    got, _ = tf.make_loss_fn(cfg, tf.RunFlags(**flags))(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    got_g = torch.autograd.grad(got, ts)
    wg = _jax_paths(jax.tree.map(np.asarray, want_g))
    assert abs(float(got.detach()) - float(want)) < 1e-5 * abs(float(want))
    assert sorted(p for p, _ in paths(tp)) == sorted(wg)
    for (path, _), g in zip(paths(tp), got_g):
        w = wg[path]
        err = np.abs(g.numpy() - w).max()
        assert err < 5e-5 * max(1e-3, np.abs(w).max()), (path, err)


def _rand(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


def _wkv_args(rng, Bz=2, L=32, H=3, K=8):
    r, k, v = (_rand(rng, Bz, L, H, K) for _ in range(3))
    w = torch.exp(-torch.exp(_rand(rng, Bz, L, H, K)))
    return [r, k, v, w, _rand(rng, H, K) * 0.5], dict(chunk=8)


def _ssd_args(rng, Bz=2, L=32, H=3, P=8, N=4):
    x = _rand(rng, Bz, L, H, P)
    dt = torch.nn.functional.softplus(_rand(rng, Bz, L, H))
    Bm, Cm = _rand(rng, Bz, L, N), _rand(rng, Bz, L, N)
    A = -torch.exp(_rand(rng, H) * 0.5)
    return [x, dt, Bm, Cm, A, _rand(rng, H)], dict(chunk=16)


@pytest.mark.parametrize("use_state", [True, False])
@pytest.mark.parametrize("scan", ["wkv", "ssd"])
def test_scan_backward_is_autograd_through_the_twin(scan, use_state):
    """The wrapper's gradients equal autograd through the twin of the
    reference's lax scan (the wrapper's forward is the plain version here,
    its backward that twin); an unused final state counts as zero."""
    rng = np.random.default_rng(11)
    args, kw = (_wkv_args if scan == "wkv" else _ssd_args)(rng)
    op, twin = ((wkv_ops.wkv_scan, wkv_ops.wkv_scan_twin) if scan == "wkv"
                else (ssd_ops.ssd_scan, ssd_ops.ssd_scan_twin))
    gy = _rand(rng, *args[0].shape[:3], args[2 if scan == "wkv" else 0]
               .shape[-1])
    grads = []
    for fn in (op, twin):
        ins = [a.clone().requires_grad_() for a in args]
        y, st = fn(*ins, **kw)
        loss = (y * gy).sum() + (st.square().sum() if use_state else 0.0)
        grads.append(torch.autograd.grad(loss, ins))
    y_op, st_op = op(*args, **kw)
    y_tw, st_tw = twin(*args, **kw)
    assert torch.allclose(y_op, y_tw, atol=1e-4, rtol=1e-5)
    assert torch.allclose(st_op, st_tw, atol=1e-4, rtol=1e-5)
    for a, b in zip(*grads):
        assert a.shape == b.shape and torch.isfinite(a).all()
        assert torch.allclose(a, b, atol=1e-5, rtol=1e-5), \
            float((a - b).abs().max())


def test_scan_wrappers_without_grad_take_the_raw_route():
    """Under no_grad (prefill) the wrappers call the kernel module
    directly: no autograd graph, the same values."""
    rng = np.random.default_rng(3)
    args, kw = _ssd_args(rng)
    with torch.no_grad():
        y, st = ssd_ops.ssd_scan(*[a.requires_grad_() for a in args], **kw)
    assert y.grad_fn is None and st.grad_fn is None
    y2, _ = ssd_ops.ssd_scan(*args, **kw)
    assert y2.grad_fn is not None and torch.equal(y, y2.detach())


@pytest.mark.parametrize("table", ["matmul", "flash"])
def test_tables_take_jit_and_keep_the_oracle_without_it(table):
    """The reference's ``jit`` keyword: ``jit=False`` makes ``compiled``
    the oracle callable, as there; on CPU tensors it is the oracle with
    ``jit=True`` too (the compiled tier is built for the card only)."""
    make = (lambda **k: mm_sweep.matmul_backends(tile=16, **k)) \
        if table == "matmul" else fa_sweep.flash_backends
    for jit in (False, True):
        t = make(jit=jit, device="cpu")
        assert t["compiled"] is t["oracle"]
        assert sorted(t) == ["compiled", "interpret", "oracle"]


def _run(core, firmware, table):
    bridges = {}

    def fw(fb, be):
        bridges[be] = fb
        firmware(fb, be)

    res = core.coverify(fw, {"mm": table}, tol=1e-3,
                        congestion=core.CongestionConfig(dos_prob=0.05,
                                                         seed=7))
    return res, {be: fb.log.digest() for be, fb in bridges.items()}


def test_coverify_with_jit_tables_equivalent_and_log_equals_reference():
    """``coverify()`` over the ``jit=True`` tables on the CPU: EQUIVALENT
    across three backends, the same report and the same transaction log
    digests, backend by backend, as the reference's own ``jit=True`` run of
    the same firmware (the tier does not touch the burst list)."""
    r_res, r_dig = _run(
        ref_core,
        lambda fb, be: ref_mm.matmul_firmware(fb, "mm", be, size=32, tile=16),
        ref_mm.matmul_backends(tile=16, jit=True))
    p_res, p_dig = _run(
        port_core,
        lambda fb, be: mm_sweep.matmul_firmware(fb, "mm", be, size=32,
                                                tile=16),
        mm_sweep.matmul_backends(tile=16, device="cpu", jit=True))
    assert r_res.passed and p_res.passed
    assert "EQUIVALENT" in str(p_res.equivalence)
    assert str(p_res.equivalence) == str(r_res.equivalence)
    assert p_res.tx_summary == r_res.tx_summary
    assert p_dig == r_dig and list(p_dig) == ["oracle", "interpret",
                                              "compiled"]
