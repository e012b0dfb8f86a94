"""End-to-end driver on the PyTorch port (``repro_torch``): co-verification
preflight + train a ~100M-parameter llama-family model on the synthetic
induction-LM dataset with the full production stack — fwd+bwd+AdamW step,
background data pipeline, async checkpoints, fault-tolerant restart,
straggler monitoring, register-file run control — on ``--device``.

Before training, a CoVerifySession sweep (paper Fig. 5 batched lane)
co-verifies the systolic-matmul accelerator across oracle/interpret/
compiled backends under online congestion — the paper's "verify before
deploy" flow.  Skip it with --skip-preflight.

    PYTHONPATH=src python examples/quickstart_torch.py [--steps 300] [--resume]
    PYTHONPATH=src python examples/quickstart_torch.py --arch llama3.2-1b --smoke

A few hundred steps on the default config drives loss well below the
unigram entropy (the dataset plants copy/induction structure).
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, smoke
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import RunFlags
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import FailureInjector, Trainer, TrainerConfig


def coverify_preflight(device="cuda") -> bool:
    """Batched co-verification sweep of the matmul accelerator (6 cells:
    2 sizes x {oracle, interpret, compiled}) under online congestion,
    through core/scheduler.CoVerifySession.  Returns True on pass."""
    from repro_torch.core import CongestionConfig, CoVerifySession
    from repro_torch.kernels.systolic_matmul.sweep import (matmul_backends,
                                                     matmul_firmware)

    sess = CoVerifySession(matmul_firmware,
                           congestion=CongestionConfig(dos_prob=0.02,
                                                       seed=5))
    sess.register_op("mm", **matmul_backends(device=device))
    sess.add_sweep("mm", ("oracle", "interpret", "compiled"),
                   [{"size": 64}, {"size": 96}])
    report = sess.run(max_workers=4)
    s = report.summary()
    stalls = sum(sum(r.congestion.per_engine_stall.values())
                 for r in report.cells if r.congestion)
    print(f"preflight co-verification: {s['cells']} cells, "
          f"{s['groups']} equivalence groups, "
          f"{s['wall_seconds']:.2f}s wall, "
          f"{stalls:.0f} congestion stall cycles -> "
          f"{'PASS' if report.passed else 'FAIL: ' + str(s['failures'])}")
    return report.passed

# ~102M parameters
CONFIG_100M = ModelConfig(
    arch="quickstart-100m", family="dense", n_layers=10, d_model=640,
    n_heads=8, n_kv_heads=4, head_dim=80, d_ff=2560, vocab_size=32000,
    mlp_type="swiglu", rope="full", causal=True, tie_embeddings=False,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--arch", default=None,
                    help="train a smoke-reduced assigned arch instead")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inject-failure", type=int, default=None,
                    help="inject a transient fault at this step "
                         "(demonstrates checkpoint/restart)")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_quickstart")
    ap.add_argument("--skip-preflight", action="store_true",
                    help="skip the co-verification sweep before training")
    ap.add_argument("--device", default="cuda",
                    help="device the preflight and the training run on "
                         "(cuda or cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if not args.skip_preflight and not coverify_preflight(device):
        sys.exit("preflight co-verification FAILED; not training on a "
                 "divergent accelerator (use --skip-preflight to override)")

    if args.arch:
        cfg = get_config(args.arch)
        if args.smoke:
            cfg = smoke(cfg)
    else:
        cfg = CONFIG_100M

    from repro_torch.configs import count_params
    print(f"model: {cfg.arch}  params={count_params(cfg)/1e6:.1f}M")

    tcfg = TrainerConfig(seq_len=args.seq_len, global_batch=args.batch,
                         steps=args.steps, ckpt_every=50,
                         ckpt_dir=args.ckpt_dir,
                         log_path=str(Path(args.ckpt_dir) / "metrics.jsonl"))
    inj = FailureInjector(fail_steps=[args.inject_failure]) \
        if args.inject_failure else None
    trainer = Trainer(
        cfg, tcfg,
        flags=RunFlags(attn_impl="chunked", q_chunk=128, kv_chunk=128,
                       microbatches=1),
        opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=20,
                            total_steps=args.steps),
        failure_injector=inj, device=device)

    state, step = trainer.train(resume=args.resume)
    log = trainer.metrics_log
    print(f"\ntrained to step {step}; restarts={trainer.restarts}; "
          f"stragglers={len(trainer.straggler.events)}")
    if log:
        for r in log[:: max(1, len(log) // 12)]:
            print(f"  step {r['step']:4d}  loss {r['loss']:.4f}  "
                  f"lr {r['lr']:.2e}  {r['step_time']*1e3:.0f} ms")
        print(f"  final loss: {log[-1]['loss']:.4f} "
              f"(first: {log[0]['loss']:.4f})")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
