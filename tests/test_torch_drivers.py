"""The port's drivers (``examples/*_torch.py``, ``benchmarks/*_torch.py``)
print the docs' pinned transcripts on the CPU, and write only where the
reference's drivers may.

Each docs page pins a transcript with a "prints (deterministic ...)"
sentinel above a fenced block, read here as ``tests/test_docs.py`` reads
it.  Every line of ``docs/replay.md``'s block must be equal but for the
content hash of the float output buffer ``c``, which appears twice (the
``first differing state leaf`` line and the ``'c': ...`` entries of the
``*buffers:`` line): it hashes the bytes of a float matmul result, and
two matmul implementations agree on those bytes only within rounding.
The hashes of ``a`` and ``b`` hash numpy inputs and must match.
"""
import contextlib
import importlib.util
import io
import re
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DOCS = ROOT / "docs"
MODELED = "prints (deterministic — modeled cycles only, no wall time):"
REPLAY = ("prints (deterministic — modeled clocks and seeded faults, no "
          "wall time):")


def fenced_transcript(page: str, sentinel: str) -> list:
    doc = (DOCS / page).read_text().splitlines()
    i = doc.index(sentinel)
    start = doc.index("```", i) + 1
    end = doc.index("```", start)
    return doc[start:end]


def load(rel: str):
    """A driver loaded from its file under a module name of its own."""
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(
        "drivers_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stdout_of(fn, *args) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    assert rc in (None, 0), rc
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("rel,page,extra", [
    ("examples/profile_cnn_torch.py", "profiling.md", "trace"),
    ("examples/counter_dashboard_torch.py", "instrumentation.md", None),
    ("examples/topology_tour_torch.py", "topology.md", None),
    ("examples/open_loop_serving_torch.py", "serving.md", None),
    ("benchmarks/bench_simspeed_torch.py", "performance.md", "--selftest"),
], ids=lambda v: Path(v).stem if isinstance(v, str) and "/" in v else None)
def test_docs_transcript(rel, page, extra, tmp_path):
    argv = ["--device", "cpu"]
    if extra == "trace":
        argv += ["--trace-out", str(tmp_path / "profile_cnn.trace.json")]
    elif extra:
        argv.append(extra)
    got = stdout_of(load(rel).main, argv)
    assert got == fenced_transcript(page, MODELED)
    if extra == "trace":
        assert (tmp_path / "profile_cnn.trace.json").exists()


_C_LEAF = re.compile(r"^(  first differing state leaf: buffers/c = )"
                     r"'[0-9a-f]{12}' vs '[0-9a-f]{12}'$")
_C_ENTRY = re.compile(r"'c': '[0-9a-f]{12}'")


def mask_c_hashes(lines: list) -> list:
    """The two places that hash the float buffer ``c``, masked; every
    other character kept."""
    out = []
    for line in lines:
        if _C_LEAF.match(line):
            line = _C_LEAF.sub(r"\1<c> vs <c>", line)
        elif line.startswith("   *buffers: "):
            line = _C_ENTRY.sub("'c': <c>", line)
        out.append(line)
    return out


def test_replay_docs_transcript_but_for_c_hashes():
    expected = fenced_transcript("replay.md", REPLAY)
    got = stdout_of(load("examples/time_travel_debug_torch.py").main,
                    ["--device", "cpu"])
    masked = mask_c_hashes(expected)
    # the mask touches exactly the leaf line and the *buffers: line
    assert sum(a != b for a, b in zip(expected, masked)) == 2
    assert masked.count("  first differing state leaf: buffers/c = <c> "
                        "vs <c>") == 1
    assert mask_c_hashes(got) == masked


def test_profile_cnn_defaults_write_under_artifacts(tmp_path, monkeypatch):
    """The exporting twin run with its default trace path from a scratch
    cwd writes under artifacts/ there and touches nothing at the repo
    root."""
    before = {p.name for p in ROOT.iterdir()}
    mod = load("examples/profile_cnn_torch.py")
    monkeypatch.chdir(tmp_path)
    stdout_of(mod.main, ["--device", "cpu"])
    assert (tmp_path / "artifacts" / "torch" /
            "profile_cnn.trace.json").exists()
    assert {p.name for p in ROOT.iterdir()} == before
