"""The port's example drivers held against the reference's, both in
process on the CPU at the smallest size each takes.

A twin's transcript must equal its reference's line for line after one
mask, ``mask()`` below, which covers wall-time fields (seconds, rates)
and fields computed from float output values (a max |error|, the values
of a divergent element).  No other field is masked.  The one other
difference a transcript may show is the script's own name in the
command it prints for a re-run (``fuzz_protocol_torch.py`` for
``fuzz_protocol.py``).  The serving examples serve the reference's bf16
weights, carried across through each twin's ``serving_params``.
"""
import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.convert import params_from_reference

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

_MASKS = [
    # wall time
    (re.compile(r"(\d+ cells, \d+ equivalence groups?(?:\(s\))?, )"
                r"[\d.]+s wall"), r"\1<s> wall"),
    (re.compile(r"^(fuzz: \d+ scenarios in )[\d.]+s \([\d.]+/s\)"),
     r"\1<s> (<rate>)"),
    (re.compile(r"^(  \w+,\w+,\d+,\d+,\d+,)[\d.]+$"), r"\1<wall_s>"),
    # float output values
    (re.compile(r"(max \|oracle - interpret\| = )\S+"), r"\1<err>"),
    (re.compile(r"(@ \w+\[[\d, ]+\]: )\S+ vs \S+ \(abs=\S+, rel=\S+\)"),
     r"\1<values>"),
]


def mask(text: str) -> list:
    out = []
    for line in text.splitlines():
        for pat, sub in _MASKS:
            line = pat.sub(sub, line)
        out.append(line)
    return out


def load(rel: str, prefix: str):
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(prefix + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def transcripts(name: str, argv: list, monkeypatch, twin_patch=None,
                ref_extra=(), twin_extra=()):
    """(reference stdout, twin stdout) of ``examples/<name>.py`` and its
    twin on the same arguments (the reference reads ``sys.argv``)."""
    ref = load(f"examples/{name}.py", "ref_")
    twin = load(f"examples/{name}_torch.py", "twin_")
    if twin_patch:
        twin_patch(twin)
    out = []
    for mod, args in ((ref, None),
                      (twin, argv + list(twin_extra) + ["--device", "cpu"])):
        monkeypatch.setattr(sys, "argv", [name] + argv + list(ref_extra))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = mod.main() if args is None else mod.main(args)
        assert rc in (None, 0), (name, rc)
        out.append(buf.getvalue())
    return out


@pytest.fixture(scope="module")
def ref_weights():
    """The reference examples' bf16 serving weights (smoke llama3.2-1b,
    ``PRNGKey(0)``) as the port's tensors on the CPU."""
    from repro.configs import get_config, smoke
    from repro.models import init_params
    cfg = smoke(get_config("llama3.2-1b"))
    rparams = init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    return params_from_reference(jax.tree.map(np.asarray, rparams), "cpu")


def carry(weights):
    def patch(twin):
        twin.serving_params = lambda cfg, device: weights
    return patch


def test_coverify_cnn_small(monkeypatch):
    """Stalls, busy cycles, link utilization, makespan and the heatmap of
    the small CNN (the max |oracle - interpret| lines masked)."""
    ref, twin = transcripts("coverify_cnn", [], monkeypatch)
    assert "functional equivalence: PASS" in twin
    assert mask(twin) == mask(ref)


@pytest.mark.parametrize("extra", [[], ["--inject-bug", "--shrink"]],
                         ids=["clean", "planted_bug"])
def test_fuzz_protocol(extra, monkeypatch):
    ref, twin = transcripts(
        "fuzz_protocol",
        ["--faults", "12", "--layers", "bridge,registers"] + extra,
        monkeypatch)
    twin = twin.replace("examples/fuzz_protocol_torch.py",
                        "examples/fuzz_protocol.py")
    assert mask(twin) == mask(ref)
    if extra:
        assert "  minimal repro: 1 op(s)" in twin.splitlines()
    else:
        assert "  result: PASS" in twin.splitlines()


def test_cluster_coverify_and_serving_storm(monkeypatch, ref_weights):
    """The 1/2-device sweep, digest reproducibility, fabric coverage and
    (``--serve``) the cluster storm on the reference's weights: token
    parity, placement and host-channel stalls equal."""
    ref, twin = transcripts(
        "cluster_coverify",
        ["--devices", "1,2", "--size", "64", "--backends",
         "oracle,interpret", "--serve"], monkeypatch,
        twin_patch=carry(ref_weights))
    assert "  token parity vs single engine: True" in twin.splitlines()
    assert mask(twin) == mask(ref)


def test_serve_registers(monkeypatch, ref_weights):
    """Two requests through the CSR protocol on the reference's weights:
    the same tokens, transaction summary and (no) violations."""
    ref, twin = transcripts("serve_registers", ["--requests", "2"],
                            monkeypatch, twin_patch=carry(ref_weights))
    assert twin == ref


def test_quickstart_smoke(monkeypatch, tmp_path):
    """The preflight line (its wall field masked), the model line, and one
    restart from an injected failure at step 2; each side checkpoints into
    a directory of its own."""
    args = ["--arch", "llama3.2-1b", "--smoke", "--steps", "3", "--batch",
            "2", "--seq-len", "32", "--inject-failure", "2"]
    ref, twin = transcripts(
        "quickstart", args, monkeypatch,
        ref_extra=["--ckpt-dir", str(tmp_path / "ref")],
        twin_extra=["--ckpt-dir", str(tmp_path / "twin")])
    ref_l, twin_l = mask(ref), mask(twin)
    assert twin_l[0].startswith("preflight co-verification: 6 cells, 2 "
                                "equivalence groups, <s> wall, ")
    assert twin_l[0].endswith("-> PASS")
    assert twin_l[:2] == ref_l[:2]
    restart = [ln.split("; stragglers")[0] for ln in ref_l + twin_l
               if ln.startswith("trained to step")]
    assert restart == ["trained to step 3; restarts=1"] * 2
