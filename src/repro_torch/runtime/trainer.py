"""Trainer: train step + data pipeline + async checkpointing + failure
recovery + straggler monitoring — the port of ``repro.runtime.trainer``
on one device.

The control flow is deliberately firmware-shaped (FireBridge §IV-A): the
host loop reads/writes a RegisterFile for run control (CTRL/STATUS/STEP/
RESTARTS), so the register-protocol tests drive the trainer exactly like
the paper's firmware drives its accelerator.  The reference's mesh and
sharding context, elastic ``rescale`` and its ``grad_compression`` option
wait for the multi-device item (ROADMAP queue A item 12): the int8
error-feedback compression itself is ported (``optim/compress.py``), and
the option comes with the gradient reduction whose wire it compresses.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Optional, Union

import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_map
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.core.registers import RO, RegisterFile
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import SyntheticLMDataset
from repro_torch.launch import steps as steps_lib
from repro_torch.models.transformer import RunFlags
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.failures import (FailureInjector, SimulatedFailure,
                                          StragglerMonitor)


@dataclasses.dataclass
class TrainerConfig:
    seq_len: int = 256
    global_batch: int = 8
    steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = "artifacts/repro_torch_ckpt"
    ckpt_keep: int = 3
    seed: int = 0
    log_path: Optional[str] = None
    max_restarts: int = 3


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 flags: RunFlags = RunFlags(microbatches=1),
                 opt_cfg: AdamWConfig = AdamWConfig(),
                 failure_injector: Optional[FailureInjector] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tcfg = tcfg
        self.flags = flags
        self.injector = failure_injector
        self.straggler = StragglerMonitor()
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.ckpt_keep)
        self.metrics_log: list[dict] = []
        self.restarts = 0

        # control-plane registers (fb_read_32/fb_write_32 protocol)
        self.csr = RegisterFile("trainer.csr")
        self.csr.define("CTRL", 0x00)                  # bit0 = run
        self.csr.define("STATUS", 0x04, access=RO)     # 0 idle 1 run 2 done 3 err
        self.csr.define("STEP", 0x08, access=RO)
        self.csr.define("RESTARTS", 0x0C, access=RO)

        self._step_fn = steps_lib.make_train_step(cfg, flags, None, opt_cfg)

        self.dataset = SyntheticLMDataset(cfg.vocab_size, tcfg.seq_len,
                                          tcfg.global_batch, seed=tcfg.seed)

    # ------------------------------------------------------------------
    def init_state(self):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.tcfg.seed)
        return steps_lib.make_train_state(self.cfg, gen)

    def _resume_or_init(self):
        latest = self.ckpt.latest_step()
        if latest is None:
            return self.init_state(), 0
        like = steps_lib.train_state_shape(self.cfg)
        state = self.ckpt.restore(latest, like, self.device)
        tree_map(lambda p: p.requires_grad_(), state["params"])
        return state, latest

    # ------------------------------------------------------------------
    def train(self, state=None, start_step: int = 0, resume: bool = False):
        if resume:
            state, start_step = self._resume_or_init()
        elif state is None:
            state = self.init_state()
        self.csr.hw_set("STATUS", 1)
        self.csr.fb_write_32(self.csr.addr_of("CTRL"), 1)

        pipe = DataPipeline(self.dataset, start_step=start_step,
                            device=self.device)
        step = start_step
        try:
            while step < self.tcfg.steps:
                if not (self.csr.fb_read_32(self.csr.addr_of("CTRL")) & 1):
                    break                               # host requested stop
                t0 = time.perf_counter()
                try:
                    if self.injector is not None:
                        self.injector.check(step)
                    _, batch = pipe.next()
                    state, metrics = self._step_fn(state, batch)
                    loss = float(metrics["loss"])       # waits for the step
                except SimulatedFailure:
                    # fault tolerance: restore last checkpoint and continue
                    self.restarts += 1
                    self.csr.hw_set("RESTARTS", self.restarts)
                    if self.restarts > self.tcfg.max_restarts:
                        self.csr.hw_set("STATUS", 3)
                        raise
                    pipe.stop()
                    # join the in-flight checkpoint write first: restoring
                    # while it is still being written finds no committed
                    # step and restarts from init (the reference's race)
                    self.ckpt.wait()
                    state, step = self._resume_or_init()
                    pipe = DataPipeline(self.dataset, start_step=step,
                                        device=self.device)
                    continue
                dt = time.perf_counter() - t0
                ev = self.straggler.observe(step, dt)
                rec = {"step": step, "loss": loss,
                       "lr": float(metrics["lr"]),
                       "grad_norm": float(metrics["grad_norm"]),
                       "step_time": dt,
                       "straggler": bool(ev)}
                self.metrics_log.append(rec)
                self.csr.hw_set("STEP", step)
                step += 1
                if step % self.tcfg.ckpt_every == 0 or step == self.tcfg.steps:
                    self.ckpt.save(step, state)
        finally:
            pipe.stop()
            self.ckpt.wait()
            if self.tcfg.log_path:
                Path(self.tcfg.log_path).write_text(
                    "\n".join(json.dumps(r) for r in self.metrics_log))
        self.csr.hw_set("STATUS", 2)
        return state, step
