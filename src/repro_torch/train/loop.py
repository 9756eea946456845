"""Fault-tolerant training loop (counterpart of ``repro.train.loop``).

Composes a step function, a checkpointable data pipeline, the
CheckpointManager and failure handling:

* periodic async checkpoints (state + pipeline step);
* resume from the newest *intact* checkpoint (``run`` is re-entrant: a
  preempted process restarts and continues bit-exactly; a corrupted newest
  checkpoint falls back to the previous verified one);
* a fault-injection hook (``health/inject.FaultInjector``, or any
  ``step -> None`` callable; one with an ``attach`` method is handed the
  loop);
* a circuit breaker on a non-finite loss or a ``RuntimeError``: restore
  the newest checkpoint or, when nothing has been checkpointed yet, the
  initial state.  The port's optimizers and update kernels return new
  tensors and never write into their inputs (nor does the fault
  injector), so the initial tree needs no copy to stay what it was: on
  the CPU it is held as it is, as the reference holds its immutable
  arrays; on a card its tensor leaves are held as host copies, so that
  the card does not carry a second model state until the first
  checkpoint releases it.  The pipeline's state dict is copied.

The restart budget is windowed: ``restart_window`` bounds how many
failures may land within any sliding span of that many steps (``None``:
``max_restarts`` over the run's lifetime).

Besides the reference's ``history`` (one entry per ``log_every`` steps,
with the window's mean ``step_ms``), ``run`` returns ``steps``: every
completed step's ``ms`` and metrics, trimmed on resume like the history;
and the host-clock seconds of its first resume (``resume_s``: restoring
a checkpoint, where there is one) and of its final blocking save
(``save_s``).
A step is timed from a synchronised card to a synchronised card (the
reference's ``block_until_ready``).  The reference's watchdog is not
ported yet.
"""
from __future__ import annotations

import copy
import dataclasses
import math
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import flatten, unflatten


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    checkpoint_every: int = 50
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    keep_checkpoints: int = 3
    log_every: int = 10
    max_restarts: int = 3
    # sliding step window the restart budget is counted over; None = the
    # run's lifetime
    restart_window: Optional[int] = None
    # grid or canonical spec name of packed checkpoint leaves (None: raw)
    checkpoint_fmt: Optional[str] = None
    # number of leaves.npz shard files per checkpoint
    checkpoint_shards: int = 4


def _tree_to(tree, device):
    """``tree`` with its tensor leaves on ``device`` (a leaf already there
    is kept, not copied)."""
    leaves, structure = flatten(tree)
    return unflatten(structure, [x.to(device) if torch.is_tensor(x) else x
                                 for x in leaves])


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class TrainLoop:
    def __init__(self, step_fn: Callable, pipeline, init_state,
                 config: TrainLoopConfig,
                 fault_hook: Optional[Callable[[int], None]] = None,
                 metrics_hook: Optional[Callable[[int, Dict], None]] = None,
                 device=None, watchdog=None):
        """``step_fn(state, batch) -> (state, metrics dict of scalars)``.
        ``device``: where restored tensor leaves go (the reference's
        ``state_sharding``; default the CPU)."""
        if watchdog is not None:
            raise NotImplementedError("the watchdog is not ported yet")
        self.step_fn = step_fn
        self.pipeline = pipeline
        self.state = init_state
        self.device = device
        self._init_state = _tree_to(init_state, "cpu")
        self._init_pipeline = copy.deepcopy(pipeline.state_dict())
        # until the first resume, self.state is the initial state itself
        self._fresh = True
        self.config = config
        self.fault_hook = fault_hook
        if fault_hook is not None and hasattr(fault_hook, "attach"):
            fault_hook.attach(self)
        self.metrics_hook = metrics_hook
        self.ckpt = CheckpointManager(config.checkpoint_dir,
                                      keep=config.keep_checkpoints,
                                      fmt=config.checkpoint_fmt,
                                      shards=config.checkpoint_shards)
        self.history: list = []
        self.steps: list = []

    # ------------------------------------------------------------------ io
    def _save(self, step: int, blocking=False):
        payload = {"state": self.state,
                   "pipeline": self.pipeline.state_dict()}
        self.ckpt.save(step, payload, blocking=blocking)

    def _try_resume(self) -> int:
        try:
            latest, payload, _ = self.ckpt.restore(device=self.device)
        except FileNotFoundError:
            # nothing restorable: the initial state, never the in-flight
            # self.state (it may be a corrupted half-step)
            if self._init_state is None:
                raise
            if not self._fresh:
                self.state = _tree_to(self._init_state,
                                      self.device or "cpu")
            self.pipeline.load_state_dict(
                copy.deepcopy(self._init_pipeline))
            resumed = 0
        else:
            self.state = payload["state"]
            self.pipeline.load_state_dict(payload["pipeline"])
            resumed = latest
        self._fresh = False
        # drop the records of the discarded run segment: the replayed
        # steps append fresh ones
        self.history = [h for h in self.history if h["step"] <= resumed]
        self.steps = [h for h in self.steps if h["step"] <= resumed]
        return resumed

    # ----------------------------------------------------------------- run
    def _charge_restart(self, restart_log: List[int], step: int) -> None:
        """Windowed restart budget; raises when exceeded."""
        window = self.config.restart_window
        if window:
            restart_log[:] = [s for s in restart_log if s > step - window]
        restart_log.append(step)
        if len(restart_log) > self.config.max_restarts:
            raise RuntimeError(
                f"restart budget exhausted: {len(restart_log)} failures "
                + (f"within {window} steps" if window else "this run")
                + f" (max_restarts={self.config.max_restarts})")

    def run(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        step = self._try_resume()
        resume_s = time.perf_counter() - t0
        restart_log: List[int] = []
        restarts_total = 0
        window_t, window_n = 0.0, 0
        total_t, total_n = 0.0, 0
        while step < cfg.total_steps:
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                batch = self.pipeline.next()
                _sync(self.device)
                t0 = time.perf_counter()
                self.state, metrics = self.step_fn(self.state, batch)
                _sync(self.device)
                dt = time.perf_counter() - t0
                window_t += dt
                window_n += 1
                total_t += dt
                total_n += 1
                values = {k: float(v) for k, v in metrics.items()}
                loss = values.get("loss", math.nan)
                if not math.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at {step}")
                step += 1
                self.steps.append({"step": step, "ms": 1e3 * dt, **values})
                if step % cfg.log_every == 0 or step == cfg.total_steps:
                    self.history.append({
                        "step": step,
                        "step_ms": 1e3 * window_t / max(window_n, 1),
                        **values})
                    window_t, window_n = 0.0, 0
                    if self.metrics_hook:
                        self.metrics_hook(step, metrics)
                if step % cfg.checkpoint_every == 0:
                    self._save(step)
                    if (self._init_state is not None
                            and self.ckpt.latest_step() is not None):
                        # a durable checkpoint now covers a restart:
                        # release the initial state
                        self._init_state = None
                        self._init_pipeline = None
            except (FloatingPointError, RuntimeError):
                restarts_total += 1
                self._charge_restart(restart_log, step)
                step = self._try_resume()
                # the interrupted window's timings belong to discarded steps
                window_t, window_n = 0.0, 0
                continue
        t0 = time.perf_counter()
        self._save(step, blocking=True)
        self.ckpt.wait()
        return {"final_step": step, "restarts": restarts_total,
                "history": self.history, "steps": self.steps,
                "mean_step_ms": 1e3 * total_t / max(total_n, 1),
                "resume_s": resume_s,
                "save_s": time.perf_counter() - t0}
