"""Open-loop serving under load: continuous batching + KV paging + SLO, on
the PyTorch port (``repro_torch``).

Closed-loop demos (examples/serve_registers_torch.py) submit a burst and wait;
the engine sets the pace.  Open-loop load keeps arriving on its own
schedule — the traffic shape where queueing delay, deferred admission,
and latency-SLO percentiles become visible.  This walkthrough:

1. builds a seeded bursty arrival trace (pure function of the seed),
2. drives it through a continuously-batched `ServingEngine` whose KV
   cache is a paged pool smaller than the burst's aggregate demand,
3. reads back the per-request SLO table (modeled cycles only),
4. shows doorbell-time admission control rejecting an infeasible
   request loudly instead of livelocking the queue,
5. reruns the same seed and checks the SLO digest is bit-identical.

Every number below is a modeled cycle count (no wall time), so the
transcript is deterministic and the same on any device (the weights, bf16
from a seeded generator on the device, never reach a printed number): it
is the fenced transcript of docs/serving.md, line for line.

    PYTHONPATH=src python examples/open_loop_serving_torch.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, smoke
from repro_torch.models import init_params
from repro_torch.models.transformer import RunFlags
from repro_torch.serving import (ServingEngine, SLOReport, bursty_trace,
                           replayed_trace, run_open_loop)


def _engine(device="cuda"):
    dev = resolve_device(device)
    cfg = smoke(get_config("llama3.2-1b"))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16)
    return ServingEngine(cfg, params, max_slots=2, max_len=32,
                         prompt_pad=4, kv_pages=3, kv_page_size=8,
                         batching="continuous",
                         flags=RunFlags(attn_impl="chunked", q_chunk=16,
                                        kv_chunk=16), device=dev)


def _run(eng, trace):
    eng.reset(batching="continuous", kv_pages=3, kv_page_size=8)
    ticks = run_open_loop(eng, trace)
    return ticks, SLOReport.from_run(trace, eng, label="open-loop")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device the model runs on (cuda or cpu)")
    args = ap.parse_args(argv)
    trace = bursty_trace(23, n_requests=6, burst_size=6, gap_in_burst=10.0,
                         gap_between=500.0, prompt_lens=(3, 10),
                         max_new=(2, 4))
    print(f"arrival trace {trace.label} (digest {trace.digest()[:16]}):")
    for a in trace.arrivals:
        print(f"  rid {a.rid}: t={a.time:8.1f}  prompt[{len(a.prompt)}]"
              f"  max_new={a.max_new_tokens}")

    eng = _engine(args.device)
    ticks, slo = _run(eng, trace)
    pool = eng.kv_pool
    print(f"\nopen-loop run drained in {ticks} scheduler ticks "
          f"(2 slots, {pool.n_pages} KV pages x {pool.page_size} tokens):")
    for row in slo.to_rows():
        print(f"  {row}")
    print(f"  pool: peak {pool.peak_in_use}/{pool.n_pages} pages, "
          f"{pool.deferrals} deferred admissions, "
          f"{pool.n_free}/{pool.n_pages} free after drain")

    # a request whose padded footprint can NEVER fit the whole pool is
    # rejected at the doorbell with a logged violation — admission
    # control fails loudly up front instead of starving the queue
    eng.reset(batching="continuous", kv_pages=2, kv_page_size=4)
    hostile = replayed_trace([
        (0, 0.0, (5, 6, 7), 2),              # 2 pages: fits exactly
        (1, 10.0, tuple(range(1, 13)), 4),   # 4 pages: can never fit
        (2, 20.0, (8, 9), 2),                # fits behind the reject
    ])
    run_open_loop(eng, hostile)
    print("\ninfeasible-request demo (2 pages x 4 tokens):")
    for v in eng.csr.log.violations:
        print(f"  violation: {v}")
    done = sorted(r for r, q in eng.requests.items() if q.done)
    print(f"  completed: rids {done}; rid 1 rejected at the doorbell")

    _, again = _run(eng, trace)
    print(f"\nrerun of seed 23 -> SLO digest identical: "
          f"{again.digest() == slo.digest()}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
