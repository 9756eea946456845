"""Deterministic, seed-keyed fault injection for chaos testing (counterpart
of ``repro.health.inject``).

A :class:`FaultInjector` is a schedule of :class:`FaultEvent`\\ s, each
keyed by (seed, step, event index) through a numpy PRNG, so the choices
left open (which leaf, which bit, which element) are the reference's for
the same seed and schedule, on a state whose float leaves correspond one
to one in flattening order.

Fault kinds:

* ``bitflip`` -- XOR one bit of one element of a float32 leaf of the live
  train state;
* ``nan`` / ``inf`` -- overwrite one element of a floating leaf;
* ``preempt`` -- raise ``RuntimeError`` from the hook (TrainLoop's restart
  path, in process);
* ``sigkill`` -- ``SIGKILL`` the current process;
* ``corrupt`` -- truncate or garble the newest checkpoint's
  ``leaves.npz`` (the checksum-verified restore fallback).

Each event fires once (``fired``), so steps replayed after a rollback do
not fire it again.  A tampered leaf is replaced by a modified copy: the
state's tensors are never written in place.
"""
from __future__ import annotations

import dataclasses
import os
import signal
from typing import Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.checkpoint.manager import flatten, unflatten

FAULT_KINDS = ("bitflip", "nan", "inf", "preempt", "sigkill", "corrupt")
CORRUPT_MODES = ("truncate", "garble")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``leaf``/``bit``/``index`` default to a
    seed-keyed draw when ``None``; ``mode`` applies to ``corrupt`` only."""

    step: int
    kind: str
    leaf: Optional[int] = None
    bit: Optional[int] = None
    index: Optional[int] = None
    mode: str = "truncate"

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"known: {FAULT_KINDS}")
        if self.mode not in CORRUPT_MODES:
            raise ValueError(f"unknown corrupt mode {self.mode!r}; "
                             f"known: {CORRUPT_MODES}")


def parse_fault_schedule(spec: str) -> Tuple[FaultEvent, ...]:
    """Parse the CLI schedule grammar: comma-separated
    ``kind@step[:key=value...]``, e.g.
    ``bitflip@20:leaf=0:bit=30,nan@35,preempt@40,corrupt@60:mode=garble``.
    """
    events: List[FaultEvent] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        try:
            kind, at = fields[0].split("@")
        except ValueError as exc:
            raise ValueError(
                f"fault event {part!r} must look like 'kind@step'") from exc
        kwargs = {}
        for f in fields[1:]:
            k, _, v = f.partition("=")
            if k not in ("leaf", "bit", "index", "mode"):
                raise ValueError(f"unknown fault field {k!r} in {part!r}")
            kwargs[k] = v if k == "mode" else int(v)
        events.append(FaultEvent(step=int(at), kind=kind, **kwargs))
    return tuple(sorted(events, key=lambda e: e.step))


# ------------------------------------------------------------- low level --
def flip_bit(arr: np.ndarray, index: int, bit: int) -> np.ndarray:
    """A copy of a float32 array with one bit of one element XOR-flipped
    (``index`` into the flattened array, ``bit`` in [0, 32))."""
    a = np.array(arr, dtype=np.float32, copy=True)
    flat = a.reshape(-1).view(np.uint32)
    flat[index % flat.size] ^= np.uint32(1) << np.uint32(bit % 32)
    return a


def corrupt_checkpoint(directory: str, step: Optional[int] = None,
                       mode: str = "truncate") -> int:
    """Corrupt a checkpoint's ``leaves.npz`` (the newest step when
    ``None``): ``truncate`` halves the file, ``garble`` XORs one byte mid
    file keeping its size (only the checksum catches it).  Returns the
    corrupted step."""
    if step is None:
        steps = [int(n[5:]) for n in os.listdir(directory)
                 if n.startswith("step_") and n[5:].isdigit()]
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {directory}")
        step = max(steps)
    path = os.path.join(directory, f"step_{step}", "leaves.npz")
    size = os.path.getsize(path)
    if mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(size // 2, 1))
    elif mode == "garble":
        with open(path, "r+b") as f:
            f.seek(size // 2)
            byte = f.read(1)
            f.seek(size // 2)
            f.write(bytes([byte[0] ^ 0xFF]))
    else:
        raise ValueError(f"unknown corrupt mode {mode!r}")
    return step


def _is_float(leaf, float32_only: bool) -> bool:
    if torch.is_tensor(leaf):
        ok = leaf.dtype == torch.float32 if float32_only \
            else leaf.is_floating_point()
        return ok and leaf.numel() > 0
    if isinstance(leaf, np.ndarray):
        ok = leaf.dtype == np.float32 if float32_only \
            else np.issubdtype(leaf.dtype, np.floating)
        return ok and leaf.size > 0
    return False


# -------------------------------------------------------------- injector --
class FaultInjector:
    """A ``TrainLoop`` fault hook driven by a schedule (events, or the CLI
    grammar string) and a seed.  The loop calls ``attach(loop)``, so state
    faults reach ``loop.state`` and checkpoint faults the loop's
    checkpoint directory.  ``log`` records every fired fault."""

    def __init__(self, schedule: Union[str, Iterable[FaultEvent]],
                 seed: int = 0):
        if isinstance(schedule, str):
            schedule = parse_fault_schedule(schedule)
        self.schedule: Tuple[FaultEvent, ...] = tuple(schedule)
        self.seed = int(seed)
        self.loop = None
        self.fired: set = set()
        self.log: List[dict] = []

    def attach(self, loop) -> None:
        self.loop = loop

    def __call__(self, step: int) -> None:
        for i, ev in enumerate(self.schedule):
            if ev.step == step and i not in self.fired:
                self.fired.add(i)
                self._fire(i, ev)

    # ------------------------------------------------------------ faults --
    def _rng(self, i: int, ev: FaultEvent) -> np.random.Generator:
        # keyed by (seed, step, event index), as in the reference
        return np.random.default_rng([self.seed, ev.step, i])

    def _fire(self, i: int, ev: FaultEvent) -> None:
        entry = {"step": ev.step, "kind": ev.kind}
        if ev.kind == "preempt":
            self.log.append(entry)
            raise RuntimeError(f"injected preemption at step {ev.step}")
        if ev.kind == "sigkill":
            self.log.append(entry)
            os.kill(os.getpid(), signal.SIGKILL)
        if ev.kind == "corrupt":
            # fence an async save in flight, so that "the newest
            # checkpoint" does not depend on the writer thread's timing
            self.loop.ckpt.wait()
            entry["ckpt_step"] = corrupt_checkpoint(
                self.loop.ckpt.directory, mode=ev.mode)
            entry["mode"] = ev.mode
            self.log.append(entry)
            return
        self._tamper_state(i, ev, entry)
        self.log.append(entry)

    def _tamper_state(self, i: int, ev: FaultEvent, entry: dict) -> None:
        leaves, structure = flatten(self.loop.state)
        candidates = [j for j, leaf in enumerate(leaves)
                      if _is_float(leaf, ev.kind == "bitflip")]
        if not candidates:
            raise ValueError(f"no float leaves to inject {ev.kind!r} into")
        rng = self._rng(i, ev)
        j = (candidates[ev.leaf % len(candidates)] if ev.leaf is not None
             else candidates[int(rng.integers(len(candidates)))])
        leaf = leaves[j]
        size = leaf.numel() if torch.is_tensor(leaf) else leaf.size
        idx = (ev.index if ev.index is not None
               else int(rng.integers(size))) % size
        if torch.is_tensor(leaf):
            new = leaf.clone(memory_format=torch.contiguous_format)
        else:
            new = np.array(leaf, copy=True)
        flat = new.reshape(-1)
        if ev.kind == "bitflip":
            bit = (ev.bit if ev.bit is not None
                   else int(rng.integers(32))) % 32
            words = flat.view(torch.int32) if torch.is_tensor(flat) \
                else flat.view(np.int32)
            old = np.asarray([int(words[idx])], np.int32).view(np.float32)
            words[idx] = int(flip_bit(old, 0, bit).view(np.int32)[0])
            entry["bit"] = bit
        else:
            flat[idx] = float("nan") if ev.kind == "nan" else float("inf")
        entry["leaf"] = j
        entry["index"] = idx
        leaves[j] = new
        self.loop.state = unflatten(structure, leaves)
