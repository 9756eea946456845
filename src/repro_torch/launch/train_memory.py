"""Device memory of a train run, step by step: ``train.setup`` of one of
``repro_torch.launch.train``'s target runs on the card, then ``--steps``
steps, printing after the set-up and after each step the memory held
(``torch.cuda.memory_allocated``) and the peak since the previous reading
(``torch.cuda.max_memory_allocated``, reset at each reading).  A peak that
grows from step to step is memory that a step keeps past its end.

  PYTHONPATH=src python -m repro_torch.launch.train_memory \\
      [--run GEMMA_TRAIN_RUN] [--steps 4]

It needs a card: without one it raises.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.launch import train

RUNS = ("PAPER_RUN", "ADAM_RUN", "GEMMA_TRAIN_RUN")
GIB = 2 ** 30


def measure(run: dict, steps: int) -> dict:
    """(bytes held, peak bytes) after the set-up and after each step."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: device memory is measured on "
                           "the card")
    torch.cuda.reset_peak_memory_stats()
    readings = []

    def read(tag):
        torch.cuda.synchronize()
        readings.append((tag, torch.cuda.memory_allocated(),
                         torch.cuda.max_memory_allocated()))
        torch.cuda.reset_peak_memory_stats()
    tr = train.setup(**run, device="cuda")
    read("set-up")
    for i in range(steps):
        tr.step(tr.batch(i))
        read(f"step {i + 1}")
    return {"device": torch.cuda.get_device_name(0), "readings": readings}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", default="GEMMA_TRAIN_RUN", choices=RUNS)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args(argv)
    res = measure(getattr(train, args.run), args.steps)
    print(f"{res['device']}: {args.run}")
    for tag, held, peak in res["readings"]:
        print(f"  {tag:8s} held {held / GIB:7.2f} GiB  peak {peak / GIB:7.2f} "
              "GiB")
    return res


if __name__ == "__main__":
    main()
