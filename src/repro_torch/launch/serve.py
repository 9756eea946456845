"""Serving driver: fixed-batch prompt absorption + greedy decode with a KV
cache (counterpart of ``repro.launch.serve``).

Example (on the card; add ``--device cpu --reduced`` for a CPU smoke run):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --batch 4 --prompt-len 32 --gen 16 --gemm-policy binary8-paper
(``--gemm-policy binary8-paper-attn`` also rounds the attention op and
stores the KV cache as packed e4m3 codes.)  The MoE decoder serves the same
way: ``--arch qwen3-moe-30b-a3b`` (30.5 B parameters, 57 GiB of bf16
weights on one 80 GB card).

As in the reference, the prompt is absorbed one token at a time with
``decode_step(compute_logits=False)`` (prompt absorption and decode are the
same code), and decode first feeds the prompt's last token again at
position ``prompt_len``.  Everything runs under ``torch.inference_mode()``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional, Union

import torch

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.device import resolve_device
from repro_torch.kernels.tree_update import tree_leaves
from repro_torch.models import attention, build_model
from repro_torch.precision import PRESETS, QuantPolicy

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


def setup(arch: str, *, reduced: bool = False, batch: int = 4,
          prompt_len: int = 32, seed: int = 0,
          gemm_policy: Optional[Policy] = None, device=None):
    """``arch`` with random weights from a seeded generator on the device,
    and one random prompt batch: (cfg, model, params, prompts).
    ``gemm_policy``: a preset or spec name, or a ``QuantPolicy``."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = reduce_cfg(cfg)
    if gemm_policy is not None:
        cfg = dataclasses.replace(cfg, gemm_policy=gemm_policy)
    model = build_model(cfg)
    gen_w = torch.Generator(device=dev).manual_seed(seed)
    params = model.init(gen_w)
    gen_p = torch.Generator(device=dev).manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen_p, device=dev)
    return cfg, model, params, prompts


def run(arch: str, *, reduced: bool = False, batch: int = 4,
        prompt_len: int = 32, gen: int = 16, seed: int = 0,
        gemm_policy: Optional[Policy] = None, device=None) -> Dict:
    """Serve one random batch of ``setup``'s model, print a summary and
    return the serve_batch result."""
    cfg, model, params, prompts = setup(
        arch, reduced=reduced, batch=batch, prompt_len=prompt_len,
        seed=seed, gemm_policy=gemm_policy, device=device)
    out = serve_batch(model, params, prompts, gen)
    out["n_params"] = sum(t.numel() for t in tree_leaves(params))
    out["cache_dtype"] = attention.cache_dtype(cfg)
    out["cache_bytes"] = 2 * cfg.n_layers * batch * (prompt_len + gen) \
        * cfg.n_kv_heads * cfg.resolved_head_dim \
        * out["cache_dtype"].itemsize
    name = gemm_policy if not isinstance(gemm_policy, QuantPolicy) else (
        f"QuantPolicy(fwd={gemm_policy.fwd}, act={gemm_policy.act}, "
        f"oracle={gemm_policy.oracle}, packed={gemm_policy.packed})")
    print(f"arch={cfg.name} batch={batch} prompt={prompt_len} gen={gen} "
          f"policy={name} device={prompts.device}")
    print(f"parameters {out['n_params']}; kv cache {out['cache_dtype']} "
          f"{out['cache_bytes']} bytes")
    print(f"prefill {out['t_prefill']:.3f}s ({out['prefill_tokps']:.1f} "
          f"tok/s); decode {out['t_decode']:.3f}s "
          f"({out['decode_tokps']:.1f} tok/s)")
    print("sample:", out["tokens"][0].tolist())
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
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)
    run(args.arch, reduced=args.reduced, batch=args.batch,
        prompt_len=args.prompt_len, gen=args.gen,
        gemm_policy=args.gemm_policy, device=args.device)


if __name__ == "__main__":
    main()
