"""Serving drivers (counterpart of ``repro.launch.serve``): the fixed-batch
driver (prompt absorption + greedy decode with a contiguous KV cache) and
``run_engine``, which drives the continuous-batching engine over a paged
KV cache on a mixed-length request mix.

Example (on the card; add ``--device cpu --reduced`` for a CPU smoke run):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --batch 4 --prompt-len 32 --gen 16 --gemm-policy binary8-paper
(``--gemm-policy binary8-paper-attn`` also rounds the attention op and
stores the KV cache as packed e4m3 codes; ``--kv-cache-fmt e4m3-sr``
sets the cache's storage spec of any policy.)  The engine:
  PYTHONPATH=src python -m repro_torch.launch.serve --engine
serves ``ENGINE_RUN`` (16 requests, 4 slots, pages of 64) under
``ENGINE_POLICY``; add ``--reduced --device cpu`` for a CPU run, and
``--arch gemma-7b`` for gemma's.  The MoE decoder serves the same way:
``--arch qwen3-moe-30b-a3b`` (30.5 B parameters, 57 GiB of bf16 weights on
one 80 GB card); so do gemma-7b (GeGLU, head dim 256, tied embeddings) and
phi3-medium-14b.

As in the reference, the prompt is absorbed one token at a time with
``decode_step(compute_logits=False)`` (prompt absorption and decode are the
same code), and decode first feeds the prompt's last token again at
position ``prompt_len``.  Everything runs under ``torch.inference_mode()``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Union

import numpy as np

import torch

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.device import resolve_device
from repro_torch.kernels.tree_update import tree_leaves
from repro_torch.models import attention, build_model
from repro_torch.core.rounding import spec
from repro_torch.precision import PRESETS, QuantPolicy
from repro_torch.precision.policy import make_policy, policy_with_kv_fmt
from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                        EngineConfig, Request)

# a preset or spec name, or a QuantPolicy (the reference's resolve_policy)
Policy = Union[str, QuantPolicy]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def serve_batch(model, params, prompts: torch.Tensor, gen: int,
                forced: Optional[torch.Tensor] = None) -> Dict:
    """Greedy serving of ``prompts`` (B, P) for ``gen`` tokens.

    ``forced`` (B, gen): teacher forcing -- feed these tokens instead of
    the argmax (the tests hold both packages to the same inputs).
    Returns ``tokens`` (B, gen) argmax picks, ``logits`` (B, gen, V) as
    float32, the final ``caches``, and host-clock timings taken after a
    device synchronize.
    """
    batch, prompt_len = prompts.shape
    dev = prompts.device
    caches = model.init_decode_cache(batch, prompt_len + gen, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    for pos in range(prompt_len):
        _, caches = model.decode_step(params, caches,
                                      prompts[:, pos:pos + 1], pos,
                                      compute_logits=False)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tok = prompts[:, -1:]
    outs, logits_all = [], []
    t1 = time.perf_counter()
    for t in range(gen):
        logits, caches = model.decode_step(params, caches, tok,
                                           prompt_len + t)
        pick = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        outs.append(pick)
        logits_all.append(logits[:, -1, :].float())
        tok = pick if forced is None else forced[:, t:t + 1]
    toks = torch.cat(outs, dim=1)
    _sync(dev)
    t_decode = time.perf_counter() - t1
    return {"tokens": toks, "logits": torch.stack(logits_all, dim=1),
            "caches": caches, "t_prefill": t_prefill, "t_decode": t_decode,
            "prefill_tokps": batch * prompt_len / max(t_prefill, 1e-9),
            "decode_tokps": batch * gen / max(t_decode, 1e-9)}


# The full-size target runs: the serve cells that ``chip_smoke.py`` drives
# and ``profile_serve`` traces, for the dense and the MoE decoder.
SERVE_RUN = dict(arch="tinyllama-1.1b", batch=4, prompt_len=32, gen=16)
MOE_SERVE_RUN = dict(arch="qwen3-moe-30b-a3b", batch=4, prompt_len=32,
                     gen=16)
# gemma-7b (8.5 B parameters, 17.1 GB of bf16 weights: GeGLU through K4''s
# gelu instance, head dim 256) and phi3-medium-14b (14.7 B, 29.3 GB; a
# short run: its first decode steps show the path)
GEMMA_SERVE_RUN = dict(arch="gemma-7b", batch=4, prompt_len=32, gen=16)
PHI3_SERVE_RUN = dict(arch="phi3-medium-14b", batch=4, prompt_len=32, gen=4)


def build(arch: str, *, reduced: bool = False, seed: int = 0,
          gemm_policy: Optional[Policy] = None, device=None):
    """``arch`` with random weights from a seeded generator on the device:
    (cfg, model, params).  ``gemm_policy``: a preset or spec name, or a
    ``QuantPolicy``."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = reduce_cfg(cfg)
    if gemm_policy is not None:
        cfg = dataclasses.replace(cfg, gemm_policy=gemm_policy)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    return cfg, model, params


def setup(arch: str, *, reduced: bool = False, batch: int = 4,
          prompt_len: int = 32, seed: int = 0,
          gemm_policy: Optional[Policy] = None, device=None):
    """``build``'s model and one random prompt batch: (cfg, model, params,
    prompts)."""
    cfg, model, params = build(arch, reduced=reduced, seed=seed,
                               gemm_policy=gemm_policy, device=device)
    dev = params["embed"].device
    gen_p = torch.Generator(device=dev).manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen_p, device=dev)
    return cfg, model, params, prompts


def run(arch: str, *, reduced: bool = False, batch: int = 4,
        prompt_len: int = 32, gen: int = 16, seed: int = 0,
        gemm_policy: Optional[Policy] = None,
        kv_cache_fmt: Optional[str] = None, device=None) -> Dict:
    """Serve one random batch of ``setup``'s model, print a summary and
    return the serve_batch result.  ``kv_cache_fmt`` replaces the
    policy's KV-cache storage spec."""
    if kv_cache_fmt is not None:
        gemm_policy = policy_with_kv_fmt(gemm_policy, kv_cache_fmt)
    cfg, model, params, prompts = setup(
        arch, reduced=reduced, batch=batch, prompt_len=prompt_len,
        seed=seed, gemm_policy=gemm_policy, device=device)
    out = serve_batch(model, params, prompts, gen)
    out["n_params"] = sum(t.numel() for t in tree_leaves(params))
    out["cache_dtype"] = attention.cache_dtype(cfg)
    out["cache_bytes"] = 2 * cfg.n_layers * batch * (prompt_len + gen) \
        * cfg.n_kv_heads * cfg.resolved_head_dim \
        * out["cache_dtype"].itemsize
    print(f"arch={cfg.name} batch={batch} prompt={prompt_len} gen={gen} "
          f"policy={_policy_name(gemm_policy)} device={prompts.device}")
    print(f"parameters {out['n_params']}; kv cache {out['cache_dtype']} "
          f"{out['cache_bytes']} bytes")
    print(f"prefill {out['t_prefill']:.3f}s ({out['prefill_tokps']:.1f} "
          f"tok/s); decode {out['t_decode']:.3f}s "
          f"({out['decode_tokps']:.1f} tok/s)")
    print("sample:", out["tokens"][0].tolist())
    return out


def _policy_name(policy) -> str:
    if not isinstance(policy, QuantPolicy):
        return str(policy)
    return (f"QuantPolicy(fwd={policy.fwd}, act={policy.act}, "
            f"attn={policy.attn_qk}, kv_cache_fmt={policy.kv_cache_fmt}, "
            f"oracle={policy.oracle}, packed={policy.packed})")


# The engine's serving policy, the reference's (``tests/test_serving.py``,
# ``benchmarks/serve_bench.py``): rounded attention sites and an e4m3-SR
# KV cache, unrounded GEMMs -- the policy under which a request's stream
# does not depend on the schedule.
ENGINE_POLICY = make_policy(attn=spec("binary8", "sr"),
                            kv_cache_fmt="e4m3-sr")
# The engine's full-size run: ``serve_bench._workload``'s request mix (12
# short requests, prompt 4 + 2 generated, and 4 long, 48 + 32, a long one
# every 4th) on 4 slots over pages of 64 tokens.
ENGINE_RUN = dict(arch="tinyllama-1.1b", n_short=12, n_long=4, short=(4, 2),
                  long=(48, 32), long_every=4, workload_seed=7,
                  engine=EngineConfig(n_slots=4, page_size=64,
                                      total_pages=16,
                                      max_pages_per_request=4,
                                      prefill_chunk=8, token_budget=16))


def engine_workload(vocab: int, n_short: int = 6, n_long: int = 2,
                    short=(8, 3), long=(16, 12), seed: int = 7,
                    long_every: int = 0) -> List[Request]:
    """Mixed-length requests, many short and a few long (the reference's
    ``benchmarks/serve_bench._workload``, the same draws): with
    ``long_every=k`` the long ones come at every k-th place, else at the
    end.  Request i has seed 100 + i."""
    rng = np.random.default_rng(seed)
    n = n_short + n_long
    if long_every:
        is_long = [i % long_every == long_every - 1
                   and i // long_every < n_long for i in range(n)]
    else:
        is_long = [i >= n_short for i in range(n)]
    if sum(is_long) != n_long:
        raise ValueError(f"cannot place {n_long} long requests every "
                         f"{long_every} among {n}")
    reqs = []
    for i in range(n):
        p, g = long if is_long[i] else short
        reqs.append(Request(rid=i, prompt=rng.integers(1, vocab, p).tolist(),
                            max_new_tokens=g, seed=100 + i))
    return reqs


def _percentile(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def run_engine(arch: str = "tinyllama-1.1b", *, reduced: bool = False,
               gemm_policy: Optional[Policy] = ENGINE_POLICY,
               kv_cache_fmt: Optional[str] = None, seed: int = 0,
               device=None, n_short: int = 12, n_long: int = 4,
               short=(4, 2), long=(48, 32), long_every: int = 4,
               workload_seed: int = 7, engine: Optional[EngineConfig] = None,
               arrivals=None, built=None, verbose: bool = True) -> Dict:
    """Serve ``engine_workload``'s requests through the continuous-batching
    engine and return the streams and the run's numbers: ``tokens`` (rid
    -> generated tokens), the ``engine`` (its counters and allocator),
    generated tokens per second over the run's wall time, time to first
    token p50/p99 (from submission), the pool's bytes and the device's
    peak memory.  ``built``: a (cfg, model, params) triple of ``build`` to
    reuse; ``arrivals``: each request's arrival iteration."""
    if kv_cache_fmt is not None:
        gemm_policy = policy_with_kv_fmt(gemm_policy, kv_cache_fmt)
    if built is None:
        built = build(arch, reduced=reduced, seed=seed,
                      gemm_policy=gemm_policy, device=device)
    cfg, model, params = built
    dev = params["embed"].device
    reqs = engine_workload(cfg.vocab_size, n_short, n_long, short, long,
                           workload_seed, long_every)
    eng = ContinuousBatchingEngine(model, params, engine or EngineConfig())
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    t0 = time.perf_counter()
    results = eng.run(reqs, arrivals=arrivals)
    _sync(dev)
    wall = time.perf_counter() - t0
    ttft = [r.first_token_time - r.arrival_time for r in results.values()]
    out = dict(tokens={rid: r.tokens for rid, r in results.items()},
               engine=eng, wall_s=wall,
               tokps=sum(len(r.tokens) for r in results.values()) / wall,
               ttft_p50_s=_percentile(ttft, 50),
               ttft_p99_s=_percentile(ttft, 99),
               pool_bytes=eng.hbm_bytes, iterations=eng.iterations,
               decode_steps=eng.decode_steps,
               peak_bytes=(torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None))
    if verbose:
        print(f"engine arch={cfg.name} requests={len(reqs)} "
              f"policy={_policy_name(cfg.gemm_policy)} device={dev}")
        print(f"{eng.iterations} iterations, {eng.decode_steps} decode "
              f"steps, {out['tokps']:.1f} tok/s, ttft p50 "
              f"{out['ttft_p50_s'] * 1e3:.1f} ms p99 "
              f"{out['ttft_p99_s'] * 1e3:.1f} ms, pool "
              f"{out['pool_bytes']} bytes")
        print("sample:", out["tokens"][0])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--gemm-policy", default=None, choices=sorted(PRESETS),
                    help="quantized-GEMM precision policy (default: "
                         "unrounded bf16 GEMMs)")
    ap.add_argument("--kv-cache-fmt", default=None,
                    help="KV-cache storage spec (e.g. 'e4m3-sr'): appended "
                         "k/v round onto this grid and the cache holds "
                         "their code words; replaces the policy's")
    ap.add_argument("--engine", action="store_true",
                    help="serve ENGINE_RUN's request mix through the "
                         "continuous-batching engine (default policy: "
                         "ENGINE_POLICY) instead of one fixed batch")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)
    if args.engine:
        kw = {k: v for k, v in ENGINE_RUN.items() if k != "arch"}
        run_engine(args.arch, reduced=args.reduced,
                   gemm_policy=args.gemm_policy or ENGINE_POLICY,
                   kv_cache_fmt=args.kv_cache_fmt, device=args.device, **kw)
        return
    run(args.arch, reduced=args.reduced, batch=args.batch,
        prompt_len=args.prompt_len, gen=args.gen,
        gemm_policy=args.gemm_policy, kv_cache_fmt=args.kv_cache_fmt,
        device=args.device)


if __name__ == "__main__":
    main()
