"""Trainer: train step + data pipeline + async checkpointing + failure
recovery + straggler monitoring + elastic rescale — the port of
``repro.runtime.trainer``.

The control flow is deliberately firmware-shaped (FireBridge §IV-A): the
host loop reads/writes a RegisterFile for run control (CTRL/STATUS/STEP/
RESTARTS), so the register-protocol tests drive the trainer exactly like
the paper's firmware drives its accelerator.

With a mesh and a sharding context (every rank of the job runs the same
Trainer) the state is placed by ``train_shardings(zero_level=1)`` and each
step takes the same global batch on every rank (``make_train_step``).
``rescale`` moves the state to another mesh over the same ranks.  The
reference's ``grad_compression`` option is accepted and changes nothing,
as in the reference (its step never applies ``optim/compress.py``).
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
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.registers import RO, RegisterFile
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import SyntheticLMDataset
from repro_torch.launch import steps as steps_lib
from repro_torch.models.transformer import RunFlags, ShardCtx
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.failures import (FailureInjector, SimulatedFailure,
                                          StragglerMonitor)
from repro_torch.sharding.specs import (P, Sharding, param_specs, place,
                                        to_shardings, whole_tree)


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
    grad_compression: str = "none"        # none | int8_ef (a no-op, as in
                                          # the reference)
    max_restarts: int = 3


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 flags: RunFlags = RunFlags(microbatches=1),
                 opt_cfg: AdamWConfig = AdamWConfig(),
                 mesh=None, ctx: Optional[ShardCtx] = None,
                 failure_injector: Optional[FailureInjector] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tcfg = tcfg
        self.flags = flags
        self.opt_cfg = opt_cfg
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

        self._set_mesh(mesh, ctx)

        self.dataset = SyntheticLMDataset(cfg.vocab_size, tcfg.seq_len,
                                          tcfg.global_batch, seed=tcfg.seed)

    def _set_mesh(self, mesh, ctx: Optional[ShardCtx],
                  state_shardings=None) -> None:
        """The step function and the state's layout for ``mesh``."""
        self.mesh, self.ctx = mesh, ctx
        self._state_sh, gshard = state_shardings, None
        if ctx is not None and state_shardings is None:
            shape = ShapeConfig("train", self.tcfg.seq_len,
                                self.tcfg.global_batch, "train")
            _, self._state_sh, _, _, gshard = steps_lib.train_shardings(
                self.cfg, shape, ctx.mesh, ctx, zero_level=1)
        self._step_fn = steps_lib.make_train_step(
            self.cfg, self.flags, ctx, self.opt_cfg, grad_shardings=gshard)

    # ------------------------------------------------------------------
    def init_state(self):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.tcfg.seed)
        state = steps_lib.make_train_state(self.cfg, gen)
        return state if self._state_sh is None else place(state,
                                                          self._state_sh)

    def _resume_or_init(self):
        if self.ctx is not None:
            import torch.distributed as dist
            dist.barrier()                  # rank 0's last write is in
        latest = self.ckpt.latest_step()
        if latest is None:
            return self.init_state(), 0
        like = steps_lib.train_state_shape(self.cfg)
        state = self.ckpt.restore(latest, like, self.device,
                                  shardings=self._state_sh)
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
        if self.ctx is not None:
            import torch.distributed as dist
            dist.barrier()                  # rank 0's last write is in
        return state, step

    # ------------------------------------------------------------------
    def rescale(self, state, new_mesh, new_ctx: ShardCtx):
        """Elastic rescale: checkpoint-free resharding onto a new mesh
        (bound over the same ranks).  DTensor moves no tensor between two
        meshes, so each leaf is gathered whole and placed again: params
        and moments in the new mesh's ``param_specs`` layout, as the
        reference does."""
        st_shape = steps_lib.train_state_shape(self.cfg)
        pspec = param_specs(self.cfg, st_shape["params"], new_mesh)
        sh = to_shardings(pspec, new_mesh)
        state = whole_tree(state)
        new_state = {
            "params": place(state["params"], sh),
            "m": place(state["m"], sh),
            "v": place(state["v"], sh),
            "step": Sharding(new_mesh, P()).place(state["step"]),
        }
        step_sh = {"params": sh, "m": sh, "v": sh,
                   "step": Sharding(new_mesh, P())}
        self._set_mesh(new_mesh, new_ctx, state_shardings=step_sh)
        return new_state
