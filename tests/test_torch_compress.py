"""The port's error-feedback int8 compression (``repro_torch/optim/
compress.py``) vs the JAX reference's, on the CPU.

The cases are those of the reference's ``tests/test_property.py``: the
blockwise error bound over seeds and 1-4 blocks of 256, and the
error-feedback sum over 50 steps; then an all-zero block (its scale is
the 1e-12 floor) and lengths that ``BLOCK`` does not divide.  Each step is
one IEEE fp32 operation on both sides and both round half to even
(``torch.round`` and ``jnp.round``), so the values are asserted EQUAL bit
for bit, not within a tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compress as ref
from repro_torch.optim import compress as port

torch.set_num_threads(1)

SEEDS = [0, 1, 7, 42, 1234, 99991, 2 ** 20 + 3, 2 ** 31 - 1]


def _both(x: np.ndarray):
    return jnp.asarray(x), torch.from_numpy(np.array(x))


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def test_block_equals_reference():
    assert port.BLOCK == ref.BLOCK == 256


@pytest.mark.parametrize("nblocks", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", SEEDS)
def test_int8_compression_equals_reference(seed, nblocks):
    """``compress_decompress`` of a block-scaled normal draw: bit for bit
    the reference's, within the reference's blockwise bound
    |x - q(x)| <= max|block| / 254 (relative slack 1e-5, as there)."""
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(nblocks * port.BLOCK,)) *
         rng.uniform(1e-6, 10)).astype(np.float32)
    rg, pg = _both(g)
    want = np.asarray(ref.compress_decompress(rg))
    got = port.compress_decompress(pg).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    blocks = g.reshape(-1, port.BLOCK)
    bound = np.abs(blocks).max(axis=1, keepdims=True) / 127.0
    err = np.abs(got.reshape(-1, port.BLOCK) - blocks)
    assert (err <= bound * 0.5 * (1 + 1e-5) + 1e-9).all()


def test_error_feedback_sum_equals_reference():
    """50 error-feedback steps: every step's sent gradient and error
    buffer are the reference's bit for bit, and the cumulative sent
    stream tracks the true sum within two steps' quantization error."""
    rng = np.random.default_rng(0)
    g = rng.normal(size=(port.BLOCK * 2,)).astype(np.float32)
    rg = {"w": jnp.asarray(g)}
    rerr = {"w": jnp.zeros((port.BLOCK * 2,), jnp.float32)}
    pg = {"w": torch.from_numpy(g.copy())}
    perr = port.init_error(pg)
    assert perr["w"].dtype == torch.float32 and not perr["w"].any()
    total_sent = torch.zeros_like(pg["w"])
    total_true = torch.zeros_like(pg["w"])
    for _ in range(50):
        rsent, rerr = ref.ef_compress(rg, rerr)
        psent, perr = port.ef_compress(pg, perr)
        np.testing.assert_array_equal(_bits(psent["w"].numpy()),
                                      _bits(rsent["w"]))
        np.testing.assert_array_equal(_bits(perr["w"].numpy()),
                                      _bits(rerr["w"]))
        total_sent = total_sent + psent["w"]
        total_true = total_true + pg["w"]
    resid = float((total_sent - total_true).abs().max())
    one_step_bound = float(pg["w"].abs().max()) / 127.0 * 2
    assert resid <= one_step_bound * 2


@pytest.mark.parametrize("n", [256, 300, 513, 7])
def test_zero_block_and_ragged_lengths_equal_reference(n):
    """An all-zero block beside a live one (scale at its 1e-12 floor,
    zeros out) and lengths that 256 does not divide (the pad is cut
    off): bit for bit the reference's, for a 2-D leaf in a tree."""
    rng = np.random.default_rng(n)
    live = rng.normal(size=(n,)).astype(np.float32) * 3.0
    g = np.concatenate([np.zeros(port.BLOCK, np.float32), live])
    g = g.reshape(-1, 1) if g.size % 2 else g.reshape(-1, 2)
    rg, pg = _both(g)
    got = port.compress_decompress(pg).numpy()
    np.testing.assert_array_equal(_bits(got),
                                  _bits(ref.compress_decompress(rg)))
    assert got.shape == g.shape
    assert not got.reshape(-1)[:port.BLOCK].any()
    tree = {"b": [pg, torch.from_numpy(live.copy())], "a": pg[:1]}
    rtree = {"b": [rg, jnp.asarray(live)], "a": rg[:1]}
    psent, perr = port.ef_compress(tree, port.init_error(tree))
    rsent, rerr = ref.ef_compress(
        rtree, {"b": [jnp.zeros(g.shape), jnp.zeros(live.shape)],
                "a": jnp.zeros(g[:1].shape)})
    for p, r in ((psent, rsent), (perr, rerr)):
        assert list(p) == sorted(p)
        for pl, rl in ((p["a"], r["a"]), (p["b"][0], r["b"][0]),
                       (p["b"][1], r["b"][1])):
            np.testing.assert_array_equal(_bits(pl.numpy()), _bits(rl))


def test_compress_keeps_dtype_and_shape():
    """A bf16 leaf is quantized in fp32 and comes back as bf16, as in the
    reference."""
    x = torch.linspace(-2, 2, 600).reshape(20, 30).to(torch.bfloat16)
    out = port.compress_decompress(x)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    want = ref.compress_decompress(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(want, np.float32))


def test_ef_compress_bf16_leaf_equals_reference():
    """A bf16 gradient over 5 error-feedback steps: the sent gradient
    comes back in bf16 and the error buffer stays fp32, each bit for bit
    the reference's."""
    rng = np.random.default_rng(3)
    g = rng.normal(size=(3, 200)).astype(np.float32)
    pg = {"w": torch.from_numpy(g).to(torch.bfloat16)}
    rg = {"w": jnp.asarray(g).astype(jnp.bfloat16)}
    perr = port.init_error(pg)
    rerr = {"w": jnp.zeros(g.shape, jnp.float32)}
    for _ in range(5):
        psent, perr = port.ef_compress(pg, perr)
        rsent, rerr = ref.ef_compress(rg, rerr)
        assert psent["w"].dtype == torch.bfloat16
        assert perr["w"].dtype == torch.float32
        np.testing.assert_array_equal(
            _bits(psent["w"].float().numpy()),
            _bits(np.asarray(rsent["w"], np.float32)))
        np.testing.assert_array_equal(_bits(perr["w"].numpy()),
                                      _bits(rerr["w"]))
