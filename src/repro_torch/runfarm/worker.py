"""Worker-process entry point (spawn context only).

One worker = one process with a PRIVATE task queue; the manager assigns
units one at a time and tracks the assignment, FireSim
instance-deploy-manager style.  Private queues mean a SIGKILL'd worker
can never die holding a shared queue lock and wedge its peers — the
manager just notices the dead process, re-enqueues its assigned unit to
a fresh worker, and carries on.

Spawn (never fork) keeps workers clean of the parent's state: a parent
that holds a CUDA context cannot hand it to a forked child.  Each worker
imports ``torch``, opens its own CUDA context at its first tensor on the
card, and loads the kernels' libraries that the parent built under
``build/``; it builds nothing itself.  On the CPU a worker runs
single-threaded (``torch.set_num_threads(1)``): the farm's parallel axis
is its processes.  ``extra_sys_path`` re-creates the parent's import path.
Once its imports are done a worker sends ``("ready", id, time.time())``,
which the manager reads as its spawn-to-ready time.  ``kill_after`` is the
crash-recovery test hook: the worker SIGKILLs itself when it receives its
(N+1)-th unit — after the assignment, before any result — the worst-case
death point.
"""
from __future__ import annotations

import os
import signal
import sys
import time


def worker_main(worker_id: int, task_q, result_q, extra_sys_path,
                kill_after=None, device: str = "cuda") -> None:
    for p in reversed(list(extra_sys_path or [])):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    from repro_torch.runfarm.builtin import execute_unit
    from repro_torch.runfarm.units import WorkUnit

    result_q.put(("ready", worker_id, time.time()))
    done = 0
    while True:
        msg = task_q.get()
        if msg is None:                       # clean shutdown
            result_q.put(("bye", worker_id, None))
            return
        unit = WorkUnit.from_json(msg)
        if kill_after is not None and done >= kill_after:
            os.kill(os.getpid(), signal.SIGKILL)    # test hook: die dirty
        try:
            res = execute_unit(unit, device)
            res.worker = worker_id
            result_q.put(("done", worker_id,
                          res.record(unit.payload_hash())))
        except BaseException as e:            # unit execution error: the
            result_q.put(("error", worker_id,  # manager records + re-raises
                          {"uid": unit.uid,
                           "error": f"{type(e).__name__}: {e}"}))
        done += 1
