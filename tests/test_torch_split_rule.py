"""The leaves that the port computes with split over the model axis
against the leaves that the reference's rule splits, with no devices.

For each of the ten configs at full size (parameters on the ``meta``
device) and model-axis sizes 2, 4 and 16: every leaf that
``repro.sharding.specs._param_rule`` splits is one that the port's
``models/transformer.py::_split_dim`` keeps split in the form a rank
computes with, in the same dim; and every leaf that ``_split_dim`` splits
is one the reference splits, but the time-mix's ``decay_B``, which the
port cuts to the columns of a rank's heads in its compute form only (it
stays whole in the stored layout, as in the reference).
"""
from types import SimpleNamespace

import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import list_archs
from repro.sharding import specs as ref_specs
from repro_torch._tree import paths
from repro_torch.configs import get_config
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import RunFlags

SIZES = (2, 4, 16)
# cut in the compute form only: (leaf path, dim from the end)
COMPUTE_ONLY = {("blocks/rwkv/tmix/decay_B", -1)}


def _ref_dim(spec) -> int | None:
    dims = [d for d, e in enumerate(tuple(spec)) if e == "model"]
    assert len(dims) <= 1, spec
    return dims[0] if dims else None


@pytest.mark.parametrize("arch", list_archs())
def test_split_dims_equal_the_reference_rule(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    with torch.device("meta"):
        params = tf.init_params(cfg, None)
    flags = RunFlags()
    n_split = 0
    for m in SIZES:
        ctx = SimpleNamespace(msize=m)
        for path, t in paths(params):
            want = _ref_dim(ref_specs._param_rule(ref_cfg, path,
                                                  tuple(t.shape), m,
                                                  "model"))
            got = tf._split_dim(cfg, flags, ctx, path, t.dim())
            if want is not None:
                n_split += 1
                assert got == want, (arch, m, path, got, want)
            elif got is not None:
                assert (path, got - t.dim()) in COMPUTE_ONLY, \
                    (arch, m, path, got)
    assert n_split > 0
