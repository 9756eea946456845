"""Training entry point (counterpart of ``repro.launch.train``): arch config ->
model -> paper-rounded QSGD -> synthetic tokens -> a plain step loop.

Example (on the card; add ``--device cpu --reduced`` for a CPU run):
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --steps 4 --batch 4 --seq 256 --gemm-policy binary8-paper \\
      --rounding signed_sr_eps --fmt binary8 --update-path fused
(``--gemm-policy binary8-paper-attn`` also rounds the attention op: its
forward and backward run the rounded flash kernels.)

It computes what ``repro.launch.train`` computes with the same flags: the
same parameter tree (its values drawn from ``torch.Generator`` seed 0),
QSGD with float32 momentum 0.9 and the optimizer key ``PRNGKey(1)``, the
batches of ``SyntheticTokens(seed=0)``, and the eq.-8 update.  The
reference's TrainLoop, checkpoints, mesh, gradient wire, accumulation,
loss scale, watchdog and QAdam are not ported yet, nor their flags.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional

import torch

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.core import gd, prng, rounding
from repro_torch.core.schemes import scheme_names
from repro_torch.data import SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.kernels.tree_update import flat_backed, tree_leaves
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.optim import base as optim_base, qsgd
from repro_torch.precision import PRESETS


def rounding_config(kind: str, fmt: str, eps: float) -> gd.GDRounding:
    """The CLI's eq.-8 rounding for ``--rounding kind`` (the reference's
    ``rounding_config``)."""
    if kind == "fp32":
        return gd.GDRounding()
    if kind == "rn":
        return gd.make_config(fmt, "rn", "rn", "rn")
    if kind == "sr":
        return gd.make_config(fmt, "rn", "sr", "sr")
    if kind == "sr_eps":
        return gd.GDRounding(grad=rounding.spec(fmt, "rn"),
                             mul=rounding.spec(fmt, "sr_eps", eps),
                             sub=rounding.spec(fmt, "sr"))
    if kind == "signed_sr_eps":
        return gd.GDRounding(grad=rounding.spec(fmt, "rn"),
                             mul=rounding.spec(fmt, "sr"),
                             sub=rounding.spec(fmt, "signed_sr_eps", eps),
                             sub_v="grad")
    # any other registered scheme: residual step RN, the scheme on the
    # mul/sub sites with its registry defaults
    scheme = rounding.get_scheme(kind)
    sp = rounding.spec(fmt, kind, scheme.default_eps,
                       scheme.default_rand_bits)
    if scheme.needs_v:
        return gd.GDRounding(grad=rounding.spec(fmt, "rn"),
                             mul=rounding.spec(fmt, "sr"), sub=sp,
                             sub_v="grad")
    return gd.GDRounding(grad=rounding.spec(fmt, "rn"), mul=sp, sub=sp)


def build_optimizer(optimizer: str, *, lr, momentum, cfg, update_path):
    """The CLI's optimizer factory (QSGD; QAdam is not ported yet)."""
    if optimizer != "sgd":
        raise NotImplementedError(f"optimizer {optimizer!r} is not ported "
                                  "yet (sgd only)")
    return qsgd(lr=lr, momentum=momentum, cfg=cfg, update_path=update_path)


# The run on the card that the port's training slice targets (the module
# docstring's example): tinyllama-1.1b at full size, batch 4 x 256 tokens.
PAPER_RUN = dict(arch="tinyllama-1.1b", batch=4, seq=256,
                 gemm_policy="binary8-paper", rounding_kind="signed_sr_eps",
                 fmt="binary8", eps=0.1, update_path="fused")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Trainer:
    """A run's state between steps: ``batch(i)`` is step i's data,
    ``step(data)`` advances the parameters and the optimizer state."""
    device: torch.device
    cfg: object
    pipe: SyntheticTokens
    train_step: object
    params: Dict
    opt_state: object

    def batch(self, i: int) -> Dict[str, torch.Tensor]:
        return self.pipe.batch_at(i, device=self.device)

    def step(self, data) -> Dict:
        self.params, self.opt_state, metrics = self.train_step(
            self.params, self.opt_state, data)
        return metrics


def setup(arch: str, *, reduced: bool = False, batch: int = 8,
          seq: int = 128, lr: float = 0.05,
          rounding_kind: str = "signed_sr_eps", fmt: str = "bfloat16",
          eps: float = 0.1, momentum: float = 0.9, update_path: str = "jnp",
          gemm_policy: Optional[str] = None, device=None,
          params=None) -> Trainer:
    """The model, optimizer, state and data of a run.  ``params``: float32
    master parameters to start from (default: drawn from
    ``torch.Generator(device).manual_seed(0)``)."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = reduce_cfg(cfg)
    if gemm_policy is not None:
        cfg = dataclasses.replace(cfg, gemm_policy=gemm_policy)
    model = build_model(cfg)
    opt = build_optimizer("sgd", lr=lr, momentum=momentum,
                          cfg=rounding_config(rounding_kind, fmt, eps),
                          update_path=update_path)
    if params is None:
        params = model.init_master(torch.Generator(device=dev).manual_seed(0))
    params = flat_backed(params)
    return Trainer(device=dev, cfg=cfg,
                   pipe=SyntheticTokens(cfg.vocab_size, seq, batch, seed=0),
                   train_step=make_train_step(model, opt), params=params,
                   opt_state=opt.init(params, prng.PRNGKey(1)))


def run(arch: str, *, steps: int = 50, batch: int = 8, seq: int = 128,
        gemm_policy: Optional[str] = None, update_path: str = "jnp",
        verbose: bool = True, **kw) -> Dict:
    """Train ``arch`` for ``steps`` steps; returns the per-step history
    (loss, ce, ms), the mean step time, tokens/s and the final params.
    ``kw``: the rest of ``setup``'s arguments."""
    tr = setup(arch, batch=batch, seq=seq, gemm_policy=gemm_policy,
               update_path=update_path, **kw)
    history = []
    for step in range(steps):
        data = tr.batch(step)
        _sync(tr.device)
        t0 = time.perf_counter()
        metrics = tr.step(data)
        _sync(tr.device)
        dt = time.perf_counter() - t0
        h = {"step": step + 1, "ms": 1e3 * dt,
             **{k: float(v) for k, v in metrics.items()}}
        history.append(h)
        if verbose:
            print(f"  step {h['step']:>5}  loss {h['loss']:.4f}  ce "
                  f"{h['ce']:.4f}  {h['ms']:.1f} ms  "
                  f"{batch * seq / dt:.1f} tok/s", flush=True)
    mean_ms = sum(h["ms"] for h in history) / max(len(history), 1)
    n_params = sum(p.numel() for p in tree_leaves(tr.params))
    if verbose:
        print(f"arch={tr.cfg.name} params={n_params / 1e6:.1f}M "
              f"steps={steps} policy={gemm_policy} update={update_path} "
              f"device={tr.device} mean {mean_ms:.1f} ms/step "
              f"{batch * seq / (mean_ms / 1e3):.1f} tok/s")
    return {"history": history, "mean_step_ms": mean_ms,
            "tokens_per_s": batch * seq / (mean_ms / 1e3),
            "params": tr.params, "opt_state": tr.opt_state,
            "n_params": n_params}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--rounding", default="signed_sr_eps",
                    choices=["fp32"] + list(scheme_names()))
    ap.add_argument("--fmt", default="bfloat16")
    ap.add_argument("--eps", type=float, default=0.1)
    ap.add_argument("--update-path", default="jnp",
                    choices=list(optim_base.UPDATE_PATHS),
                    help="parameter-update engine: per-leaf chain, "
                         "whole-tree fused kernel (in-kernel bits), or "
                         "whole-tree kernel with explicit bits")
    ap.add_argument("--gemm-policy", default=None, choices=sorted(PRESETS),
                    help="quantized-GEMM precision policy (eq. 8a) of every "
                         "forward/dgrad/wgrad GEMM; default: unrounded "
                         "bf16 GEMMs")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)
    return run(args.arch, reduced=args.reduced, steps=args.steps,
               batch=args.batch, seq=args.seq, lr=args.lr,
               rounding_kind=args.rounding, fmt=args.fmt, eps=args.eps,
               update_path=args.update_path, gemm_policy=args.gemm_policy,
               device=args.device)


if __name__ == "__main__":
    main()
