"""The port's figure and benchmark drivers (``benchmarks/*_torch.py``) held
against the reference's, both in process on the CPU at the smallest size
each takes.

Rows must be equal after one mask, which covers wall-time columns
(seconds, ms, rates, speed-ups) and nothing else; a gate read from wall
time is held by its ``gate()`` on rows given here, never on a timing of
this machine.
"""
import json

import numpy as np
import pytest
import torch

import benchmarks.bench_access_patterns as ref_fig9
import benchmarks.bench_access_patterns_torch as fig9
import benchmarks.bench_bandwidth_profile as ref_fig8
import benchmarks.bench_bandwidth_profile_torch as fig8
import benchmarks.bench_debug_iteration_torch as fig5
import benchmarks.bench_fabric_scaling as ref_fabric
import benchmarks.bench_fabric_scaling_torch as fabric
import benchmarks.bench_fuzz as ref_fuzz
import benchmarks.bench_fuzz_torch as fuzz
import benchmarks.bench_hls4ml_scaling_torch as fig7
import benchmarks.bench_profiler as ref_profiler
import benchmarks.bench_profiler_torch as profiler
import benchmarks.bench_replay as ref_replay
import benchmarks.bench_replay_torch as replay
from benchmarks import cnn_driver_torch
from repro_torch.core import validate_trace

torch.set_num_threads(1)


def columns(rows, drop):
    """Each row split on commas with the columns in ``drop`` masked."""
    out = []
    for r in rows:
        f = r.split(",")
        out.append([("<wall>" if i in drop else v) for i, v in enumerate(f)])
    return out


@pytest.mark.parametrize("fig", ["fig8", "fig9"])
def test_fig8_fig9_rows_at_small_cnn(fig, monkeypatch, tmp_path):
    """Fig. 8's per-engine rows and timelines and Fig. 9's read / write
    counts with ResNet-18 replaced by ``small_cnn_specs(16)`` on both
    sides: every column equal (all are modeled)."""
    twin, ref = (fig8, ref_fig8) if fig == "fig8" else (fig9, ref_fig9)
    small = lambda hw=32: cnn_driver_torch.small_cnn_specs(16)
    monkeypatch.setattr(twin, "resnet18_specs", small)
    monkeypatch.setattr(ref, "resnet18_specs", small)
    if fig == "fig9":
        monkeypatch.setattr(twin, "ART", tmp_path / "twin")
        monkeypatch.setattr(ref, "ART", tmp_path / "ref")
    got, want = twin.run(device="cpu"), ref.run()
    assert got == want
    if fig == "fig9":
        for name in ("small_cnn", "resnet18"):
            f = f"fig9_heatmap_{name}.txt"
            assert (tmp_path / "twin" / f).read_text() == \
                (tmp_path / "ref" / f).read_text()


def test_fig5_and_fig7_pass_at_the_two_smallest_cases():
    for pes, size in fig5.CASES[:2]:
        assert fig5.one_iteration(pes, size, device="cpu") > 0
    for width in fig7.WIDTHS[:2]:
        dt, host_gb, dev_gb = fig7.verify_cascade(width, device="cpu")
        assert dt > 0 and host_gb > 0 and dev_gb == 0.0


def test_bench_fuzz_quick():
    """Scenario counts, faults and pass verdicts per layer equal; seconds
    and scenarios/s masked."""
    drop = {3, 4}
    assert columns(fuzz.run(device="cpu"), drop) == \
        columns(ref_fuzz.run(), drop)


def test_bench_fabric_scaling_quick():
    """Every cell's modeled cycles, link and hop stalls, per-port rows and
    equivalence verdict equal; wall_s masked."""
    got, want = fabric.run(device="cpu"), ref_fabric.run()
    assert columns(got, {9}) == columns(want, {9})
    assert any(r.startswith("hop,mm,") for r in got)


def test_bench_replay_quick_event_counts():
    """Ops and events columns equal (window replay 36 events against 900
    for the full re-run); ms and speed-up masked."""
    drop = {3, 4}
    got, want = replay.run(device="cpu"), ref_replay.run()
    assert columns(got, drop) == columns(want, drop)
    by = {r.split(",")[0]: r.split(",") for r in got[1:]}
    assert (by["full_rerun"][2], by["window_replay"][2]) == ("900", "36")


def test_bench_profiler_quick(monkeypatch):
    """The twin's rows: the attributed transactions and the exported
    trace's event count equal the reference's on the same workload, the
    stall attribution closes to the bridge's time on every channel, and
    the trace written under the twin's own artifact path is valid."""
    rows = profiler.run(device="cpu")
    by = {r.split(",")[0]: r.split(",") for r in rows[1:]}
    rfz = ref_profiler._fuzzer()
    rfb = ref_profiler._run_workload(rfz, rfz.scenario(0), profile=True)
    rprof = rfb.profiler("bench")
    assert int(by["profiler_build"][2]) == \
        sum(len(c.txs) for c in rprof.channels)
    assert int(by["perfetto_export"][2]) == \
        len(rprof.to_perfetto()["traceEvents"])
    fz = profiler._fuzzer("cpu")
    fb = profiler._run_workload(fz, fz.scenario(0), profile=True)
    for ch in fb.profiler("bench").channels:
        assert sum(ch.breakdown.cycles.values()) == ch.horizon
    path = profiler.ART / "profiler_trace.json"
    assert by["artifact"][4] == path.name
    assert validate_trace(json.loads(path.read_text())) == []


@pytest.mark.parametrize("reading,held", [(4.9, False), (5.0, True),
                                          (21.3, True)])
def test_replay_gate(reading, held):
    rows = ["case,ops,events,ms,speedup", "full_rerun,150,900,10.0,1.0",
            f"window_replay,150,36,1.0,{reading}"]
    ok, verdict = replay.gate(rows)
    assert ok is held
    assert verdict == (f"gate,window_replay_speedup,{reading},>=5.0,"
                       f"{'held' if held else 'FAILED'}")


@pytest.mark.parametrize("reading,held", [(-2.2, True), (9.9, True),
                                          (10.0, False)])
def test_profiler_gate(reading, held):
    rows = ["case,ops,events,ms,overhead_pct", "profile_off,200,-,1.0,-",
            f"profile_on,200,-,1.1,{reading}"]
    ok, verdict = profiler.gate(rows)
    assert ok is held and verdict.endswith("held" if held else "FAILED")


def test_cnn_driver_interpret_equals_oracle_on_cpu():
    """Both backends of the port's CNN firmware give the same activations
    within 1e-3, and the congestion statistics of the interpret run do not
    depend on the values it computes."""
    from repro_torch.core.congestion import CongestionConfig
    cong = CongestionConfig(link_bytes_per_cycle=64.0, dos_prob=0.02,
                            seed=7)
    specs = cnn_driver_torch.small_cnn_specs(16)
    fo = cnn_driver_torch.run_cnn(specs, "oracle", congestion=cong,
                                  device="cpu")
    fi = cnn_driver_torch.run_cnn(specs, "interpret", congestion=cong,
                                  device="cpu")
    for name in ("act_0", "act_1"):
        np.testing.assert_allclose(fi.mem.buffers[name].array,
                                   fo.mem.buffers[name].array, atol=1e-3)
    a, b = fo.congestion_stats(), fi.congestion_stats()
    assert (a.per_engine_stall, a.per_engine_busy, a.makespan) == \
        (b.per_engine_stall, b.per_engine_busy, b.makespan)


def test_bench_fabric_scaling_full_mode():
    """The full sweep runs to its end (the reference's stops on a 4-device
    fat tree, one switch with no port, and on attention sharded 16 ways
    over 8 heads): the matmul at 1/4/8/16 devices, the attention at the
    counts that divide its heads, every cell equivalent, switch ports
    wherever the topology has inter-switch links."""
    rows = fabric.run(quick=False, device="cpu")
    fab = [r.split(",") for r in rows if r.startswith("fabric,")]
    assert {int(r[3]) for r in fab if r[1] == "mm"} == {1, 4, 8, 16}
    assert {int(r[3]) for r in fab if r[1] == "fa"} == {1, 4, 8}
    assert all(r[-1] == "True" for r in fab)
    assert fabric.switch_links("fat_tree", 4) == 0 < \
        fabric.switch_links("fat_tree", 8)
    one_switch = [r for r in fab if r[3:5] == ["4", "fat_tree"]]
    assert one_switch and all(r[7] == "0" for r in one_switch)
    assert not [r for r in rows if r.startswith("hop,")
                and ",4,fat_tree," in r]
    for n, topo in (("8", "fat_tree"), ("16", "torus2d"), ("4", "ring")):
        assert [r for r in rows if r.startswith("hop,mm,")
                and f",{n},{topo}," in r]


def test_cnn_driver_hands_the_kernel_float32_operands(monkeypatch):
    """The firmware's scaled weights are float64 (NumPy 2 promotes a
    float32 array times a float64 scalar); the kernel takes float32 or
    bfloat16 operands only, so the backends convert as the reference's
    ``jnp.asarray`` does.  Without it the kernel refuses layer 0 on the
    card, while the CPU's plain version upcasts and hides it."""
    from repro_torch.kernels.systolic_matmul import kernel as mm_kernel
    seen = []
    real = mm_kernel.matmul

    def spy(a, b, **kw):
        seen.append((a.dtype, b.dtype))
        return real(a, b, **kw)
    monkeypatch.setattr(mm_kernel, "matmul", spy)
    specs = cnn_driver_torch.small_cnn_specs(16)
    fb = cnn_driver_torch.run_cnn(specs, "interpret", device="cpu")
    assert seen == [(torch.float32, torch.float32)] * len(specs)
    assert fb.mem.buffers["act_0"].array.dtype == np.float32
