"""The port's model stack (dense family) vs the JAX reference, on the CPU.

Inputs and parameters are made once with numpy (or by the reference's
``init_params``) and handed to both sides as numpy arrays.  The JAX side
runs as its own tests run it here (the ``pallas`` route in interpret mode);
the port runs with ``device="cpu"``, where the attention kernels' wrappers
take their plain versions.

Tolerances: building blocks 1e-5 absolute (fp32 on both sides, another
summation order); loss 1e-5 relative and every gradient leaf 5e-5 times
max(1e-3, max|grad|) at ``compute_dtype="float32"``; at bf16 compute the
two frameworks round the same products at other places, so the loss is
held to 1e-2 relative and each gradient leaf to a cosine similarity of
0.99.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeConfig
from repro.configs import get_config as ref_get_config
from repro.configs import smoke as ref_smoke
from repro.models import inputs as ref_inputs
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tf
from repro_torch._tree import leaves, paths
from repro_torch.configs import get_config, smoke
from repro_torch.convert import params_from_reference
from repro_torch.launch.steps import train_state_shape
from repro_torch.models import inputs, layers
from repro_torch.models import transformer as tf

torch.set_num_threads(1)

ARCH = "llama3.2-1b"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


@pytest.mark.parametrize("shape", [(2, 8, 64), (3, 5, 16)])
def test_rms_norm_matches_reference(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32) * 3
    w = rng.normal(size=shape[-1:]).astype(np.float32)
    want = ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    got = layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    assert np.abs(_np(got) - _np(want)).max() < 1e-5


@pytest.mark.parametrize("fraction", ["full", "half", "none"])
def test_apply_rope_matches_reference(fraction):
    """Interleaved pairs (x[..., 0::2], x[..., 1::2]), as the reference."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 12, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32) * 7, (2, 12)).copy()
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), fraction)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            fraction)
    assert np.abs(_np(got) - _np(want)).max() < 1e-5
    if fraction == "full":      # a half-split rotation would not match
        half = np.concatenate([x[..., :8], x[..., 8:]], -1)
        assert not np.allclose(_np(got)[:, 1:], half[:, 1:], atol=1e-3)


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
def test_mlp_apply_matches_reference(mlp_type):
    rng = np.random.default_rng(2)
    w = ref_layers.mlp_init(jax.random.PRNGKey(0), 16, 32, mlp_type,
                            jnp.float32)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    want = ref_layers.mlp_apply(w, jnp.asarray(x), mlp_type)
    tw = params_from_reference(jax.tree.map(np.asarray, w), device="cpu")
    got = layers.mlp_apply(tw, torch.from_numpy(x), mlp_type)
    assert np.abs(_np(got) - _np(want)).max() < 1e-5


@pytest.mark.parametrize("masked,z_loss", [(False, 0.0), (True, 0.0),
                                           (False, 1e-4)])
def test_softmax_cross_entropy_matches_reference(masked, z_loss):
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, size=(2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) > 0.3).astype(np.float32) if masked else None

    def ref_loss(lg):
        return ref_layers.softmax_cross_entropy(
            lg, jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask), z_loss)[0]

    want, want_g = jax.value_and_grad(ref_loss)(jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_()
    got, lse = layers.softmax_cross_entropy(
        tl, torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask), z_loss)
    (g,) = torch.autograd.grad(got, (tl,))
    assert abs(float(got.detach()) - float(want)) < 1e-5
    assert np.abs(g.numpy() - np.asarray(want_g)).max() < 1e-6
    assert lse.shape == (2, 7)


@pytest.mark.parametrize("tie", [True, False])
def test_init_params_tree_matches_reference(tie):
    """Leaf paths, shapes and dtypes (value-free), at smoke size and at the
    full llama3.2-1b width (the port's tree on the ``meta`` device, the
    reference's through ``jax.eval_shape``)."""
    for reduce in (True, False):
        rcfg = dataclasses.replace(ref_get_config(ARCH), tie_embeddings=tie)
        cfg = dataclasses.replace(get_config(ARCH), tie_embeddings=tie)
        if reduce:
            rcfg, cfg = ref_smoke(rcfg), smoke(cfg)
        want = jax.eval_shape(lambda: ref_tf.init_params(
            rcfg, jax.random.PRNGKey(0)))
        want = [(p, tuple(x.shape), str(x.dtype))
                for p, x in _jax_paths(want)]
        got = [(p, tuple(x.shape), str(x.dtype).replace("torch.", ""))
               for p, x in paths(train_state_shape(cfg)["params"])]
        assert got == want
    gen = torch.Generator().manual_seed(0)
    real = tf.init_params(smoke(cfg), gen)
    assert all(x.device.type == "cpu" and torch.isfinite(x).all()
               for x in leaves(real))


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(str(getattr(k, "key", k)) for k in path), leaf)
            for path, leaf in flat]


def _batch(cfg, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


def _loss_and_grads(rcfg, cfg, flags_kw, batch, seed=0):
    p = ref_tf.init_params(rcfg, jax.random.PRNGKey(seed))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, _), want_g = jax.jit(jax.value_and_grad(
        ref_tf.make_loss_fn(rcfg, ref_tf.RunFlags(**flags_kw), None),
        has_aux=True))(p, jb)
    tp = params_from_reference(jax.tree.map(np.asarray, p), device="cpu")
    ts = leaves(tp)
    for t in ts:
        t.requires_grad_()
    got, aux = tf.make_loss_fn(cfg, tf.RunFlags(**flags_kw))(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    got_g = torch.autograd.grad(got, ts)
    wg = dict(_jax_paths(jax.tree.map(np.asarray, want_g)))
    return float(want), got.detach(), aux, [(p, g, wg[p]) for (p, _), g in
                                            zip(paths(tp), got_g)]


@pytest.mark.parametrize("impl", ["naive", "chunked", "pallas"])
def test_loss_and_grads_match_reference(impl):
    rcfg, cfg = ref_smoke(ref_get_config(ARCH)), smoke(get_config(ARCH))
    want, got, aux, grads = _loss_and_grads(
        rcfg, cfg, dict(attn_impl=impl, q_chunk=16, kv_chunk=16,
                        compute_dtype="float32"), _batch(cfg))
    assert abs(float(got) - want) < 1e-5 * abs(want)
    assert float(aux["aux"]) == 0.0
    for path, g, w in grads:
        assert g.dtype == torch.float32, path
        err = np.abs(g.numpy() - w).max()
        assert err < 5e-5 * max(1e-3, np.abs(w).max()), (path, err)


def test_padded_vocab_takes_part_in_the_softmax():
    """A vocab that is no multiple of 16: logits run over the padded vocab
    (the padded rows of the tied embedding too), as in the reference."""
    rcfg = dataclasses.replace(ref_smoke(ref_get_config(ARCH)), vocab_size=500)
    cfg = dataclasses.replace(smoke(get_config(ARCH)), vocab_size=500)
    assert tf.padded_vocab(cfg) == ref_tf.padded_vocab(rcfg) == 512
    want, got, _, grads = _loss_and_grads(
        rcfg, cfg, dict(attn_impl="chunked", compute_dtype="float32",
                        remat=False), _batch(cfg, seed=1))
    assert abs(float(got) - want) < 1e-5 * abs(want)
    emb = next(g for p, g, _ in grads if p == "embed")
    assert emb.shape[0] == 512 and emb[500:].abs().sum() > 0
    for path, g, w in grads:
        assert np.abs(g.numpy() - w).max() < 5e-5 * max(1e-3, np.abs(w).max())


def test_bf16_compute_grads_arrive_in_fp32():
    """Mixed precision: the cast to bf16 is inside the differentiated
    function, so fp32 masters get fp32 gradients."""
    rcfg, cfg = ref_smoke(ref_get_config(ARCH)), smoke(get_config(ARCH))
    want, got, _, grads = _loss_and_grads(
        rcfg, cfg, dict(attn_impl="pallas", compute_dtype="bfloat16"),
        _batch(cfg, seed=2))
    assert abs(float(got) - want) < 1e-2 * abs(want)
    for path, g, w in grads:
        assert g.dtype == torch.float32, path
        gv, wv = g.numpy().ravel().astype(np.float64), w.ravel()
        cos = gv @ wv / (np.linalg.norm(gv) * np.linalg.norm(wv))
        assert cos > 0.99, (path, cos)


def test_remat_does_not_change_gradients():
    cfg = smoke(get_config(ARCH))
    gen = torch.Generator().manual_seed(3)
    params = tf.init_params(cfg, gen)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, seed=3).items()}
    out = []
    for remat in (True, False):
        ps = leaves(params)
        for p in ps:
            p.requires_grad_()
        loss, _ = tf.make_loss_fn(cfg, tf.RunFlags(
            attn_impl="pallas", remat=remat, compute_dtype="float32"))(
                params, batch)
        out.append((loss.detach(), torch.autograd.grad(loss, ps)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert (a - b).abs().max() <= 1e-6 * max(1.0, float(b.abs().max()))


@pytest.mark.parametrize("S,window", [(640, 0), (1152, 512)])
def test_pallas_attention_off_the_512_row_grid(S, window):
    """Lengths above 512 that 512 does not divide (prompt buckets of
    serving): the ``pallas`` route clamps its blocks to a divisor of the
    length and matches the reference's naive attention (1e-5, fp32)."""
    from repro.models import attention as ref_attn

    from repro_torch.models import attention
    rng = np.random.default_rng(S)
    q, k, v = (rng.normal(size=(1, S, h, 16)).astype(np.float32)
               for h in (4, 2, 2))
    pos = np.arange(S, dtype=np.int32)[None]
    want = ref_attn.naive_attention(
        *map(jnp.asarray, (q, k, v)),
        spec=ref_attn.AttnSpec(causal=True, window=window),
        q_pos=jnp.asarray(pos), kv_pos=jnp.asarray(pos))
    got = attention.attention(
        *map(torch.from_numpy, (q, k, v)), impl="pallas",
        spec=attention.AttnSpec(causal=True, window=window),
        q_pos=torch.from_numpy(pos), kv_pos=torch.from_numpy(pos))
    assert np.abs(_np(got) - _np(want)).max() < 1e-5


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-7b",
                                  "moonshot-v1-16b-a3b", "hubert-xlarge",
                                  "llama-3.2-vision-11b"])
def test_families_not_ported_raise_naming_the_roadmap(arch):
    """Every family is ported now: parameters and a loss function build
    for the ssm and hybrid families (their training is held against the
    reference in tests/test_torch_ssm_train.py) and for the moe, audio and
    vlm families (tests/test_torch_families.py), and the loss runs; what
    the roadmap still names, a sharding context, is refused
    (test_sharding_context_refused_naming_item_12)."""
    cfg = smoke(get_config(arch))
    shapes = tf.init_params(cfg, None)
    assert leaves(shapes)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    loss_fn = tf.make_loss_fn(cfg, tf.RunFlags(compute_dtype="float32"))
    assert callable(loss_fn)
    batch = inputs.make_train_batch(cfg, 1, 16,
                                    torch.Generator().manual_seed(1))
    loss, aux = loss_fn(params, batch)
    assert torch.isfinite(loss) and torch.isfinite(aux["aux"])


def _one_rank_ctx():
    from repro_torch.launch.mesh import make_ctx, make_test_mesh
    return make_ctx(make_test_mesh((1, 1)))


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "hubert-xlarge",
                                  "llama-3.2-vision-11b"])
def test_sharding_context_refused_naming_item_12(arch):
    """Until the multi-device slice the three entry points refused any
    context, naming ROADMAP queue A item 12, and this test held them to
    that.  They take a ``ShardCtx`` now: under a one-rank context (mesh
    (1, 1), no process group) the loss, the prefill and a decode step are
    what they are without one, bit for bit.  What they refuse is a
    context that is not a ``ShardCtx``."""
    cfg = smoke(get_config(arch))
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    batch = inputs.make_train_batch(cfg, 2, 16,
                                    torch.Generator().manual_seed(1))
    flags = tf.RunFlags(compute_dtype="float32")
    ctx = _one_rank_ctx()
    want = tf.make_loss_fn(cfg, flags)(params, batch)
    got = tf.make_loss_fn(cfg, flags, ctx)(params, batch)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1]["loss"], want[1]["loss"])
    pre = {k: v for k, v in batch.items() if k != "labels"}
    if cfg.frontend != "frames":
        (lw, cw), (lg, cg) = (tf.make_prefill_fn(cfg, flags, c, 24)(params,
                                                                    pre)
                              for c in (None, ctx))
        assert torch.equal(lg, lw)
        tok = torch.tensor([3, 5], dtype=torch.int32)
        dw = tf.make_decode_fn(cfg, flags)(params, cw, tok)[0]
        dg = tf.make_decode_fn(cfg, flags, ctx)(params, cg, tok)[0]
        assert torch.equal(dg, dw)
    for build in (lambda: tf.make_loss_fn(cfg, tf.RunFlags(), ctx=object()),
                  lambda: tf.make_prefill_fn(cfg, tf.RunFlags(), object(), 32),
                  lambda: tf.make_decode_fn(cfg, tf.RunFlags(), object())):
        with pytest.raises(TypeError, match="ShardCtx"):
            build()


def test_sharding_context_is_refused():
    """The port ran on one device and refused any context until the
    multi-device slice; this test held it to that.  It refuses a context
    that is not a ``ShardCtx`` now, and takes a one-rank one."""
    cfg = smoke(get_config(ARCH))
    with pytest.raises(TypeError, match="ShardCtx"):
        tf.make_loss_fn(cfg, tf.RunFlags(), ctx=object())
    assert callable(tf.make_loss_fn(cfg, tf.RunFlags(), ctx=_one_rank_ctx()))


@pytest.mark.parametrize("arch", [ARCH, "hubert-xlarge",
                                  "llama-3.2-vision-11b"])
def test_make_train_batch_matches_reference_specs(arch):
    """Keys, shapes and dtypes of the reference's train input specs; values
    drawn from the generator, in range."""
    rcfg, cfg = ref_smoke(ref_get_config(arch)), smoke(get_config(arch))
    shape = ShapeConfig("t", 24, 3, "train")
    want = ref_inputs.train_input_specs(rcfg, shape)
    got = inputs.make_train_batch(cfg, 3, 24, torch.Generator().manual_seed(0))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape
        assert str(v.dtype).replace("torch.", "") == str(want[k].dtype)
    if "tokens" in got:
        assert 0 <= int(got["tokens"].min()) and \
            int(got["tokens"].max()) < cfg.vocab_size
