"""Serve a small model with batched requests through the FireBridge
register-file protocol — the firmware's view of the inference accelerator —
on the PyTorch port (``repro_torch``).

Requests are submitted exactly like the paper's firmware drives hardware:
write the prompt to a DDR bridge buffer, program SUBMIT_* CSRs with
fb_write_32, ring the DOORBELL, poll COMPLETED.  Continuous batching with
slot reuse happens behind the CSR boundary.  The bf16 weights come from a
seeded generator on ``--device`` (``serving_params`` below).

    PYTHONPATH=src python examples/serve_registers_torch.py [--requests 8] \
        [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, smoke
from repro_torch.models import init_params
from repro_torch.models.transformer import RunFlags
from repro_torch.serving import ServingEngine


def serving_params(cfg, device):
    """The engine's bf16 weights, drawn from seed 0 on ``device``."""
    return init_params(cfg, torch.Generator(device=device).manual_seed(0),
                       dtype=torch.bfloat16)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="device the model runs on (cuda or cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = smoke(get_config(args.arch))
    params = serving_params(cfg, device)
    eng = ServingEngine(cfg, params, max_slots=args.slots, max_len=64,
                        flags=RunFlags(attn_impl="chunked", q_chunk=16,
                                       kv_chunk=16), device=device)

    rng = np.random.default_rng(0)
    print(f"submitting {args.requests} requests over the CSR protocol "
          f"({args.slots} cache slots)...")
    for rid in range(args.requests):
        ln = int(rng.integers(4, 24))
        eng.mem.buffers["prompt_in"].array[:ln] = \
            rng.integers(0, cfg.vocab_size, ln)
        eng.csr.fb_write_32(eng.csr.addr_of("SUBMIT_ID"), rid)
        eng.csr.fb_write_32(eng.csr.addr_of("SUBMIT_LEN"), ln)
        eng.csr.fb_write_32(eng.csr.addr_of("SUBMIT_MAXNEW"),
                            int(rng.integers(4, 12)))
        eng.csr.fb_write_32(eng.csr.addr_of("DOORBELL"), 1)

    eng.run_until_done()
    # firmware-style completion wait: poll STATUS for the done value (2).
    # poll() returns -1 on timeout (distinguishable from success), so a
    # hung engine is detected instead of read as "finished on last poll".
    polls = eng.csr.poll("STATUS", 0xFFFFFFFF, 2, max_reads=8)
    if polls < 0:
        sys.exit("engine never reached STATUS=done (poll timeout)")
    done = eng.csr.fb_read_32(eng.csr.addr_of("COMPLETED"))
    print(f"COMPLETED register: {done} (STATUS done after {polls} poll(s))")
    for rid, r in sorted(eng.requests.items()):
        print(f"  req {rid}: prompt[{len(r.prompt)}] -> {r.out_tokens}")
    print("\nregister/DMA transaction summary:")
    for eng_name, s in eng.mem.log.summary().items():
        print(f"  {eng_name:12s} {s['transactions']:4d} txs "
              f"{s['bytes']:9d} B  ({s['reads']}r/{s['writes']}w)")
    print(f"protocol violations: {eng.csr.log.violations or 'none'}")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
