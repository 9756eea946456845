"""Checkpointable batch delivery (counterpart of
``repro.data.pipeline.ShardedPipeline``).

``ShardedPipeline`` wraps a deterministic source (``batch_at(step)``) and
puts each batch on the trainer's device (the reference's ``sharding``
becomes a device here).  Its state is one integer step, so checkpoint and
restore are trivial: the same batch is regenerated identically.  A host
thread can keep ``depth`` batches in flight.
"""
from __future__ import annotations

import queue
import threading
from typing import Optional

import torch


def _to(batch, device):
    if device is None:
        return batch
    return {k: v.to(device) if torch.is_tensor(v) else v
            for k, v in batch.items()}


class ShardedPipeline:
    def __init__(self, source, device=None, start_step: int = 0,
                 prefetch_depth: int = 2):
        self.source = source
        self.device = None if device is None else torch.device(device)
        self.step = start_step
        self.depth = prefetch_depth
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- synchronous API ----------------------------------------------------
    def peek(self, step: Optional[int] = None):
        """The batch of ``step`` (default: the next one), made on the host
        and put on the device, so it does not depend on the device."""
        return _to(self.source.batch_at(self.step if step is None else step),
                   self.device)

    def next(self):
        batch = self.peek()
        self.step += 1
        return batch

    # -- checkpoint state ---------------------------------------------------
    def state_dict(self):
        return {"step": self.step}

    def load_state_dict(self, state):
        self.step = int(state["step"])

    # -- background prefetch ------------------------------------------------
    def start_prefetch(self):
        if self._thread is not None:
            return
        self._q = queue.Queue(maxsize=self.depth)
        self._stop.clear()

        def worker():
            s = self.step
            while not self._stop.is_set():
                try:
                    self._q.put((s, self.peek(s)), timeout=0.1)
                    s += 1
                except queue.Full:
                    continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def next_prefetched(self):
        if self._q is None:
            return self.next()
        s, batch = self._q.get()
        self.step = s + 1
        return batch

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None
            self._q = None
