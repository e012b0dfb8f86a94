"""The PyTorch port stands alone: neither it nor its examples import
``jax``, the JAX package or the tests; it imports cleanly on a machine with
no JAX, no CUDA compiler and no GPU (nothing is built at import time), and
refuses to run on the CPU when a CUDA device was asked for and there is
none."""
import ast
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_ranks import run

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
EXAMPLES = sorted((ROOT / "examples").glob("*_torch.py")) + sorted(
    (ROOT / "benchmarks").glob("*_torch.py"))
FORBIDDEN = ("jax", "jaxlib", "repro", "tests")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def test_port_files_exist():
    names = {p.relative_to(PKG).as_posix() for p in FILES[:-1]}
    for want in ("core/transactions.py", "core/congestion.py",
                 "core/counters.py", "core/registers.py",
                 "core/equivalence.py", "core/bridge.py", "core/coverify.py",
                 "kernels/_build.py", "kernels/systolic_matmul/kernel.py",
                 "kernels/flash_attention/kernel.py", "convert.py",
                 "configs/base.py", "configs/llama3_2_1b.py",
                 "models/layers.py", "models/attention.py",
                 "models/transformer.py", "models/inputs.py",
                 "optim/adamw.py", "launch/steps.py", "data/synthetic.py",
                 "data/pipeline.py", "checkpoint/manager.py",
                 "runtime/failures.py", "runtime/trainer.py",
                 "kernels/rwkv6_wkv/kernel.py", "kernels/rwkv6_wkv/ops.py",
                 "kernels/rwkv6_wkv/ref.py", "kernels/mamba2_scan/kernel.py",
                 "kernels/mamba2_scan/ops.py", "kernels/mamba2_scan/ref.py",
                 "models/rwkv6.py", "models/mamba2.py", "serving/engine.py",
                 "serving/kvpool.py", "serving/slo.py",
                 "serving/arrivals.py", "core/coverage.py", "core/fuzz.py",
                 "core/topology.py", "core/switch.py", "core/fabric.py",
                 "sharding/specs.py", "goldens.py", "core/scheduler.py",
                 "core/replay.py", "core/profiler.py", "models/moe.py",
                 "serving/cluster.py", "runfarm/__init__.py",
                 "runfarm/units.py", "runfarm/store.py",
                 "runfarm/manager.py", "runfarm/worker.py",
                 "runfarm/report.py", "runfarm/builtin.py",
                 "optim/compress.py", "launch/mesh.py", "sharding/ep.py",
                 "sharding/comm.py", "core/hlo_profiler.py",
                 "launch/dryrun.py"):
        assert want in names
    for src in ("systolic_matmul", "flash_fwd", "flash_bwd", "ssd_scan",
                "wkv_scan"):
        assert (PKG / f"kernels/csrc/{src}.cu").exists()


@pytest.mark.parametrize("path", FILES + EXAMPLES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_import_of_jax_or_reference_package(path):
    bad = [(ln, mod) for ln, mod in _imports(path)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path}: forbidden imports {bad}"


def test_every_driver_has_a_twin():
    """Every reference example and benchmark has a ``<name>_torch.py``
    beside it.  Until the port had its program profiler and dry run,
    ``benchmarks/roofline.py`` (which reads their records) was the one
    exception; with ``core/hlo_profiler.py`` and ``launch/dryrun.py``
    ported there is none."""
    refs = sorted(p for d in ("examples", "benchmarks")
                  for p in (ROOT / d).glob("*.py")
                  if not p.stem.endswith("_torch") and p.stem != "__init__")
    missing = [p.relative_to(ROOT).as_posix() for p in refs
               if not p.with_name(p.stem + "_torch.py").exists()]
    assert missing == []
    assert len(EXAMPLES) == len(refs)


@pytest.mark.parametrize("path", EXAMPLES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_twins_import_no_reference_driver(path):
    """A twin imports other drivers only as their ``_torch`` twins."""
    bad = [(ln, mod) for ln, mod in _imports(path)
           if mod.split(".")[0] in ("benchmarks", "examples")
           and not (mod.endswith("_torch") or mod in ("benchmarks",
                                                     "examples"))]
    assert not bad, f"{path}: imports a reference driver: {bad}"
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module in (
                "benchmarks", "examples"):
            names = [a.name for a in node.names]
            assert all(n.endswith("_torch") for n in names), (path, names)


@pytest.mark.parametrize("path", EXAMPLES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_twin_takes_device_and_argv(path):
    """Every twin has ``main(argv=None)`` and a ``--device`` flag whose
    default is ``cuda``.  Two stated exceptions: ``cnn_driver_torch`` is a
    library (no ``main``), and ``roofline_torch`` renders the dry run's
    JSON records and runs nothing on a device (``main(argv=None)``, no
    ``--device``)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    mains = [n for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name == "main"]
    if path.stem == "cnn_driver_torch":         # a library, not a driver
        assert not mains
        return
    (main,) = mains
    assert [a.arg for a in main.args.args] == ["argv"]
    assert [getattr(d, "value", "?") for d in main.args.defaults] == [None]
    devices = [kw.value.value for node in ast.walk(tree)
               if isinstance(node, ast.Call)
               and getattr(node.func, "attr", "") == "add_argument"
               and node.args and getattr(node.args[0], "value", "")
               == "--device"
               for kw in node.keywords if kw.arg == "default"]
    assert devices == ([] if path.stem == "roofline_torch" else ["cuda"])


def test_every_submodule_imports_with_jax_blocked():
    mods = ["repro_torch"] + sorted(
        "repro_torch." + p.relative_to(PKG).with_suffix("").as_posix()
        .replace("/", ".").removesuffix(".__init__")
        for p in PKG.rglob("*.py") if p.name != "__init__.py")
    mods += ["repro_torch.core", "repro_torch.kernels", "chip_smoke"]
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'repro'): sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from repro_torch.kernels import _build\n"
        "assert not _build._libs, 'a kernel was built at import time'\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in "
        "sys.modules.items() if v is not None)\n"
        "print('imported', len(" f"{mods!r}" "))\n")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = run([sys.executable, "-c", code], env=env, cwd=ROOT,
              capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == f"imported {len(mods)}"


def test_chip_smoke_fails_without_cuda():
    """The chip script prints no result and exits non-zero on a machine
    with no CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = run([sys.executable, str(ROOT / "chip_smoke.py")],
              cwd=ROOT, capture_output=True, text=True,
              timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _needs_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")


@pytest.mark.parametrize("rel", ["examples/coverify_cnn_torch.py",
                                 "examples/topology_tour_torch.py",
                                 "benchmarks/bench_simspeed_torch.py",
                                 "benchmarks/run_torch.py"])
def test_twins_raise_without_cuda(rel):
    """A twin run with its defaults on a machine with no card raises the
    device error; it never carries on on the CPU."""
    _needs_no_cuda()
    out = run([sys.executable, str(ROOT / rel)], cwd=ROOT,
              capture_output=True, text=True, timeout=300,
              env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    assert out.stdout == ""


def test_backends_raise_without_cuda_instead_of_running_on_cpu():
    _needs_no_cuda()
    from repro_torch.kernels.flash_attention.sweep import flash_backends
    from repro_torch.kernels.systolic_matmul.sweep import matmul_backends
    with pytest.raises(RuntimeError, match="cuda"):
        matmul_backends(tile=16)                     # device defaults to cuda
    with pytest.raises(RuntimeError, match="cuda"):
        flash_backends(device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        matmul_backends(tile=16, device="cuda:0")
    table = matmul_backends(tile=16, device="cpu")
    x = np.eye(16, dtype=np.float32)
    assert np.array_equal(table["interpret"](x, x), x)


def test_kernel_wrappers_do_not_fall_back_for_non_cpu_tensors():
    """A tensor that does not lie on the CPU never reaches the plain
    version: the wrapper launches its kernel or raises."""
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.systolic_matmul import kernel as MM
    a = torch.ones(8, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        MM.matmul(a, a)
    q = torch.ones(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        K.flash_fwd(q, q, q, causal=True)
    assert MM.launches == 0 and K.launches == 0


def test_build_raises_without_compiler(monkeypatch, tmp_path):
    """No nvcc means an error from the build step, never a silent fallback."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "_libs", {})
    assert _build.sources() == ["flash_bwd", "flash_fwd", "ssd_scan",
                                "systolic_matmul", "wkv_scan"]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("systolic_matmul")
    with pytest.raises(FileNotFoundError):
        _build.load("no_such_kernel")


def test_build_reports_compiler_failure(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: bad kernel' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: str(fake))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="bad kernel"):
        _build.build_all()
    assert not list((tmp_path / "build").glob("*.so"))
