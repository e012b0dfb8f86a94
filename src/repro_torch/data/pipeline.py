"""Host data pipeline: background prefetch, placement on the device on the
consumer's side — the port of ``repro.data.pipeline``.

Double-buffers numpy batches on a worker thread (host-side "DMA engine");
``next()`` copies the batch to ``device`` (default ``"cuda"``) on the
calling thread, so the copy is ordered on the consumer's current CUDA
stream before the step that reads it.  Every produced batch is
transaction-logged when a log is attached, so data-path stalls show up in
the same Fig. 8-style profile as accelerator traffic.
"""
from __future__ import annotations

import queue
import threading
from typing import Optional, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.transactions import Transaction, TransactionLog


_WORKER_ERROR = object()        # queue sentinel: worker died with an error


class DataPipeline:
    def __init__(self, dataset, start_step: int = 0, prefetch: int = 2,
                 device: Union[str, torch.device] = "cuda",
                 log: Optional[TransactionLog] = None):
        self.dataset = dataset
        self.device = resolve_device(device)
        self.log = log
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        # An exception in the produce path is parked on the pipeline and a
        # sentinel is queued, so the consumer re-raises it on its next get
        # instead of blocking forever on a dead worker.
        step = self._step
        try:
            while not self._stop.is_set():
                batch = self.dataset.batch(step)
                try:
                    self._q.put((step, batch), timeout=1.0)
                except queue.Full:
                    if self._stop.is_set():
                        return
                    continue
                step += 1
        except BaseException as e:
            self._error = e
            while not self._stop.is_set():
                try:
                    self._q.put((_WORKER_ERROR, None), timeout=1.0)
                    return
                except queue.Full:
                    continue

    def next(self):
        step, batch = self._q.get()
        if step is _WORKER_ERROR:
            # put the sentinel back so every subsequent next() also raises
            try:
                self._q.put_nowait((_WORKER_ERROR, None))
            except queue.Full:
                pass
            raise RuntimeError(
                "data pipeline worker failed") from self._error
        if self.log is not None:
            nbytes = sum(np.asarray(v).nbytes for v in batch.values())
            self.log.log(Transaction(float(step), "host_data", "read", 0,
                                     nbytes, tag=f"step{step}"))
        return step, {k: torch.from_numpy(np.ascontiguousarray(v))
                      .to(self.device) for k, v in batch.items()}

    def stop(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
