"""Fault injection + straggler detection.

FailureInjector is the test harness for the trainer's checkpoint/restart
path (the software analogue of FireBridge's randomized denial-of-service:
deterministic, seeded, assertable).  StragglerMonitor is the per-host
step-time EWMA detector used at scale to trigger mitigation (re-balance /
hot-spare swap); here mitigation is recorded and surfaced in metrics.

Numpy only: the port's copy of ``repro.runtime.failures``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np


class SimulatedFailure(RuntimeError):
    pass


class FailureInjector:
    """Deterministic schedule of failures/delays keyed by step."""

    def __init__(self, fail_steps=(), delay_steps: Optional[Dict[int, float]] = None,
                 seed: int = 0, fail_prob: float = 0.0):
        self.fail_steps = set(fail_steps)
        self.delay_steps = delay_steps or {}
        self.rng = np.random.default_rng(seed)
        self.fail_prob = fail_prob
        self.injected: List[int] = []

    def check(self, step: int) -> None:
        if step in self.delay_steps:
            time.sleep(self.delay_steps.pop(step))
        if step in self.fail_steps or (
                self.fail_prob and self.rng.random() < self.fail_prob):
            # transient fault: fires once, then the retried step succeeds
            self.fail_steps.discard(step)
            self.injected.append(step)
            raise SimulatedFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class StragglerEvent:
    step: int
    step_time: float
    ewma: float
    ratio: float


class StragglerMonitor:
    """EWMA step-time monitor; flags steps slower than `threshold` x EWMA."""

    def __init__(self, alpha: float = 0.2, threshold: float = 2.0,
                 warmup: int = 3):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self.ewma: Optional[float] = None
        self.n = 0
        self.events: List[StragglerEvent] = []

    def observe(self, step: int, step_time: float) -> Optional[StragglerEvent]:
        self.n += 1
        if self.ewma is None:
            self.ewma = step_time
            return None
        ev = None
        if self.n > self.warmup and step_time > self.threshold * self.ewma:
            ev = StragglerEvent(step, step_time, self.ewma,
                                step_time / self.ewma)
            self.events.append(ev)
            # mitigation: do NOT fold the outlier into the EWMA
            return ev
        self.ewma = self.alpha * step_time + (1 - self.alpha) * self.ewma
        return ev
