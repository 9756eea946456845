"""Where a serving step's time goes: ``torch.profiler`` over the serve
cells on the card: ``serve.SERVE_RUN`` (tinyllama-1.1b at full size, batch
4, prompt 32, gen 16, the seeded weights and prompts of ``serve.run``)
under ``binary8-paper`` and ``binary8-paper-attn``, then
``serve.MOE_SERVE_RUN`` (qwen3-moe-30b-a3b, the same batch) under
``binary8-paper``; with ``--engine`` only the engine cell instead,
``serve.ENGINE_RUN`` under ``serve.ENGINE_POLICY`` (per model call: the
engine's decode steps and prefill chunks).

  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      [--engine] [--out chiprun_out/profile_serve.json]

For each cell, after a warm-up batch, the cell's whole batch (32 prompt
tokens absorbed, 16 decoded, each a one-token ``decode_step``) runs under
the profiler; it prints per step the host-clock wall time, the device time
summed over kernels (one stream: their sum over the wall time is the
device busy share), the kernel launches and the host time inside PyTorch
operators, then the kernels by device time, and writes them as JSON.  It
needs a card: without one it raises.
"""
from __future__ import annotations

import argparse
import gc
import json
from pathlib import Path

import torch

from repro_torch.launch import serve
from repro_torch.launch.profile_train import kernel_rows

CELLS = ((serve.SERVE_RUN, "binary8-paper"),
         (serve.SERVE_RUN, "binary8-paper-attn"),
         (serve.MOE_SERVE_RUN, "binary8-paper"))


def profile(cell: dict, policy: str) -> dict:
    gc.collect()                  # the previous cell's weights
    torch.cuda.empty_cache()
    run = dict(cell)
    gen = run.pop("gen")
    _, model, params, prompts = serve.setup(**run, gemm_policy=policy)
    serve.serve_batch(model, params, prompts, 2)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = serve.serve_batch(model, params, prompts, gen)
    events = prof.key_averages()
    rows = kernel_rows(events)
    steps = prompts.shape[1] + gen
    wall_ms = 1e3 * (out["t_prefill"] + out["t_decode"])
    device_ms = sum(r["device_ms"] for r in rows)
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    host_ms = sum(e.self_cpu_time_total for e in events) / 1e3
    return {**cell, "policy": policy, "steps": steps,
            "device": torch.cuda.get_device_name(0),
            "wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": device_ms / steps,
            "busy_share": device_ms / wall_ms,
            "launches_per_step": launches / steps,
            "op_host_ms_per_step": host_ms / steps, "kernels": rows}


def profile_engine(built=None, **mix) -> dict:
    """The engine cell: one untraced run, then ``serve.ENGINE_RUN`` under
    the profiler; "steps" are its model calls.  ``built``: a (cfg, model,
    params) triple of ``serve.build`` already warm (no untraced run);
    ``mix``: ``ENGINE_RUN`` fields to replace (a shorter request mix)."""
    run = {k: v for k, v in serve.ENGINE_RUN.items() if k != "arch"}
    run.update(mix)
    if built is None:
        built = serve.build(serve.ENGINE_RUN["arch"],
                            gemm_policy=serve.ENGINE_POLICY)
        serve.run_engine(built=built, verbose=False, **run)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = serve.run_engine(built=built, verbose=False, **run)
    events = prof.key_averages()
    rows = kernel_rows(events)
    eng = out["engine"]
    steps = eng.decode_steps + eng.prefill_calls
    wall_ms = 1e3 * out["wall_s"]
    device_ms = sum(r["device_ms"] for r in rows)
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    host_ms = sum(e.self_cpu_time_total for e in events) / 1e3
    return {"arch": built[0].name, "policy": "ENGINE_POLICY",
            "steps": steps, "device": torch.cuda.get_device_name(0),
            "tokps": out["tokps"], "wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": device_ms / steps,
            "busy_share": device_ms / wall_ms,
            "launches_per_step": launches / steps,
            "op_host_ms_per_step": host_ms / steps, "kernels": rows}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/profile_serve.json")
    ap.add_argument("--engine", action="store_true",
                    help="trace the engine cell only")
    args = ap.parse_args(argv)
    if args.engine:
        res = [profile_engine()]
    else:
        res = [profile(cell, p) for cell, p in CELLS]
    for r in res:
        print(f"{r['device']} {r['arch']} {r['policy']}: {r['steps']} "
              "steps; per step "
              f"wall {r['wall_ms_per_step']:.1f} ms, device "
              f"{r['device_ms_per_step']:.1f} ms (busy share "
              f"{r['busy_share']:.3f}), {r['launches_per_step']:.0f} kernel "
              f"launches, host time in operators "
              f"{r['op_host_ms_per_step']:.1f} ms")
        for k in r["kernels"][:8]:
            print(f"  {k['device_ms']:10.3f} ms  {k['calls']:6d}x  "
                  f"{k['name'][:100]}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
