"""Training entry point (counterpart of ``repro.launch.train``): arch
config -> model -> paper-rounded optimizer (QSGD or QAdam) -> synthetic
token pipeline -> the fault-tolerant TrainLoop (periodic packed
checkpoints, resume from the newest intact one, restart on faults).

Examples (on the card; add ``--device cpu --reduced`` for a CPU run):
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --steps 4 --batch 4 --seq 256 --gemm-policy binary8-paper \\
      --rounding signed_sr_eps --fmt binary8 --update-path fused \\
      --ckpt-dir /tmp/run
  # QAdam with packed bf16 moments through K5, binary8-packed checkpoints
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --steps 4 --batch 4 --seq 256 --gemm-policy binary8-paper \\
      --rounding signed_sr_eps --fmt binary8 --update-path fused \\
      --optimizer adam --moments-spec bf16-sr --ckpt-fmt binary8 \\
      --lr 4e-4 --ckpt-dir /tmp/adam_run
Run again with a higher ``--steps`` and the same ``--ckpt-dir`` to resume;
``--fault-schedule 'preempt@3,corrupt@4'`` drills the restart path.
(``--gemm-policy binary8-paper-attn`` also rounds the attention op.)

It computes what ``repro.launch.train`` computes with the same flags: the
same parameter tree (its values drawn from ``torch.Generator`` seed 0),
QSGD with float32 momentum 0.9 or QAdam with ``--moments-spec`` carries,
the optimizer key ``PRNGKey(1)``, the batches of ``SyntheticTokens(seed=0)``
and the eq.-8 update, with ``checkpoint_every = max(10, steps // 5)``.
The reference's mesh, gradient wire, accumulation, loss scale and
watchdog are not ported yet: their flags raise.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Dict, Optional

import torch

from repro_torch.checkpoint.manager import resolve_ckpt_grid
from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.core import gd, prng, rounding
from repro_torch.core.schemes import scheme_names
from repro_torch.data import ShardedPipeline, make_token_pipeline
from repro_torch.device import resolve_device
from repro_torch.health.inject import FaultInjector
from repro_torch.kernels.tree_update import flat_backed, tree_leaves
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.optim import base as optim_base, qadam, qsgd
from repro_torch.precision import PRESETS, get_policy
from repro_torch.train import TrainLoop, TrainLoopConfig


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


def parse_moments_spec(name: str):
    """``'bf16-sr[-kahan]'`` -> (RoundingSpec, kahan flag); raises on
    unknown grids and schemes, so a bad ``--moments-spec`` dies at
    launch."""
    kahan = name.endswith("-kahan")
    if kahan:
        name = name[: -len("-kahan")]
    return rounding.parse_spec(name), kahan


def build_optimizer(optimizer: str, *, lr, momentum, cfg, update_path,
                    moments_spec=None):
    """The CLI's optimizer factory (the reference's)."""
    if optimizer == "sgd":
        return qsgd(lr=lr, momentum=momentum, cfg=cfg,
                    update_path=update_path)
    if optimizer != "adam":
        raise ValueError(f"unknown optimizer {optimizer!r}")
    spec, kahan = parse_moments_spec(moments_spec or "fp32")
    # the fully-fused path stores non-fp32 moments as packed grid codes
    packed = update_path == "fused" and not spec.is_identity
    return qadam(lr=lr, cfg=cfg, m_spec=spec, v_spec=spec, kahan=kahan,
                 update_path=update_path, moments_packed=packed)


# The runs on the card that the port's training slices target:
# tinyllama-1.1b at full size, batch 4 x 256 tokens, with QSGD (slice 2)
# and with QAdam over packed bf16 moments through K5 (slice 5).  QAdam
# takes TinyLlama's published peak learning rate, 4.0e-4 (Zhang et al.
# 2024, "TinyLlama: An Open-Source Small Language Model",
# arXiv:2401.02385); at QSGD's 0.05 Adam diverges.
PAPER_RUN = dict(arch="tinyllama-1.1b", batch=4, seq=256,
                 gemm_policy="binary8-paper", rounding_kind="signed_sr_eps",
                 fmt="binary8", eps=0.1, update_path="fused")
ADAM_RUN = dict(PAPER_RUN, optimizer="adam", moments_spec="bf16-sr",
                ckpt_fmt="binary8", lr=4e-4)
# gemma-7b trained at full width (GeGLU, 16 heads of 256, the tied 256000 x
# 3072 embedding) with PAPER_RUN's batch, QSGD and update, its depth cut
# from 28 layers to 4: 1,893,755,904 parameters, whose float32 masters,
# momentum, bf16 casts and gradients fit one 80 GB card (all 28 layers,
# 8.5 B parameters, would need ~170 GB)
GEMMA_TRAIN_RUN = dict(PAPER_RUN, arch="gemma-7b", n_layers=4)


@dataclasses.dataclass
class Trainer:
    """A run's state between steps: ``batch(i)`` is step i's data,
    ``step(data)`` advances the parameters and the optimizer state."""
    device: torch.device
    cfg: object
    pipe: ShardedPipeline
    train_step: object
    params: Dict
    opt_state: object
    ckpt_fmt: Optional[str] = None

    def batch(self, i: int) -> Dict[str, torch.Tensor]:
        return self.pipe.peek(i)

    def step_fn(self, state, data):
        """TrainLoop's ``step_fn`` over ``state = (params, opt_state)``;
        parameters restored leaf by leaf are made flat-backed again."""
        params, opt_state, metrics = self.train_step(
            flat_backed(state[0]), state[1], data)
        return (params, opt_state), metrics

    def step(self, data) -> Dict:
        (self.params, self.opt_state), metrics = self.step_fn(
            (self.params, self.opt_state), data)
        return metrics


def setup(arch: str, *, reduced: bool = False, batch: int = 8,
          seq: int = 128, lr: float = 0.05,
          rounding_kind: str = "signed_sr_eps", fmt: str = "bfloat16",
          eps: float = 0.1, momentum: float = 0.9, update_path: str = "jnp",
          gemm_policy=None, device=None, params=None,
          optimizer: str = "sgd", moments_spec: Optional[str] = None,
          ckpt_fmt: Optional[str] = None,
          n_layers: Optional[int] = None) -> Trainer:
    """The model, optimizer, state and data of a run; ``gemm_policy``: a
    preset or spec name, or a ``QuantPolicy``; ``moments_spec`` and
    ``ckpt_fmt`` are validated here, at launch.  ``params``: float32
    master parameters to start from (default: drawn from
    ``torch.Generator(device).manual_seed(0)``).  ``n_layers``: the depth
    cut, the architecture's first ``n_layers`` layers at full width (a
    run's dict sets it, as ``GEMMA_TRAIN_RUN``; the CLI has no flag)."""
    dev = resolve_device(device)
    if moments_spec is not None:
        parse_moments_spec(moments_spec)
    resolve_ckpt_grid(ckpt_fmt)
    cfg = get_config(arch)
    if reduced:
        cfg = reduce_cfg(cfg)
    if n_layers is not None:
        if not 0 < n_layers <= cfg.n_layers:
            raise ValueError(f"n_layers {n_layers} outside 1..{cfg.n_layers}")
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if gemm_policy is not None:
        cfg = dataclasses.replace(cfg, gemm_policy=gemm_policy)
    model = build_model(cfg)
    opt = build_optimizer(optimizer, lr=lr, momentum=momentum,
                          cfg=rounding_config(rounding_kind, fmt, eps),
                          update_path=update_path, moments_spec=moments_spec)
    if params is None:
        params = model.init_master(torch.Generator(device=dev).manual_seed(0))
    params = flat_backed(params)
    pipe = ShardedPipeline(make_token_pipeline(cfg.vocab_size, seq, batch,
                                               seed=0), device=dev)
    return Trainer(device=dev, cfg=cfg, pipe=pipe,
                   train_step=make_train_step(model, opt), params=params,
                   opt_state=opt.init(params, prng.PRNGKey(1)),
                   ckpt_fmt=ckpt_fmt)


def run(arch: str, *, ckpt_dir: str, steps: int = 50, batch: int = 8,
        seq: int = 128, log_every: int = 10, restart_window: int = 1000,
        checkpoint_every: Optional[int] = None,
        fault_schedule: Optional[str] = None, fault_seed: int = 0,
        verbose: bool = True, **kw) -> Dict:
    """Train ``arch`` for ``steps`` steps through the TrainLoop,
    checkpointing into ``ckpt_dir`` every ``checkpoint_every`` steps
    (default, as the reference: ``max(10, steps // 5)``) and at the end; a
    directory that already holds checkpoints of this run resumes it.
    Returns ``history``: every step this call ran, with its ``ms`` and
    metrics; ``log``: the loop's ``log_every`` history; the restarts, the
    fault log, tokens/s and the final state.  ``kw``: the rest of
    ``setup``'s arguments."""
    tr = setup(arch, batch=batch, seq=seq, **kw)
    full = get_config(arch)      # its depth, printed beside a cut one
    depth = (reduce_cfg(full) if kw.get("reduced") else full).n_layers
    injector = FaultInjector(fault_schedule, seed=fault_seed) \
        if fault_schedule else None
    # the loop holds the only reference to the state: the initial one goes
    # as soon as a step replaces it
    state = (tr.params, tr.opt_state)
    tr.params = tr.opt_state = None
    loop = TrainLoop(
        tr.step_fn, tr.pipe, state,
        TrainLoopConfig(total_steps=steps,
                        checkpoint_every=checkpoint_every
                        or max(10, steps // 5),
                        checkpoint_dir=ckpt_dir, log_every=log_every,
                        restart_window=restart_window or None,
                        checkpoint_fmt=tr.ckpt_fmt),
        fault_hook=injector, device=tr.device)
    del state
    out = loop.run()
    params, opt_state = loop.state
    history = out["steps"]
    if verbose and not history:
        print(f"{ckpt_dir} already holds step {out['final_step']} of this "
              f"run: no step to take (give a fresh --ckpt-dir, or a higher "
              f"--steps to resume)", flush=True)
    mean_ms = sum(h["ms"] for h in history) / max(len(history), 1)
    n_params = sum(p.numel() for p in tree_leaves(params))
    tok_s = batch * seq / (mean_ms / 1e3) if history else 0.0
    if verbose:
        for h in history:
            print(f"  step {h['step']:>5}  loss {h['loss']:.4f}  ce "
                  f"{h['ce']:.4f}  {h['ms']:.1f} ms  "
                  f"{batch * seq / (h['ms'] / 1e3):.1f} tok/s", flush=True)
        print(f"arch={tr.cfg.name} layers={tr.cfg.n_layers}/{depth} "
              f"params={n_params / 1e6:.1f}M "
              f"steps={out['final_step']} restarts={out['restarts']} "
              f"optimizer={kw.get('optimizer', 'sgd')} "
              f"update={kw.get('update_path', 'jnp')} device={tr.device} "
              f"mean {mean_ms:.1f} ms/step {tok_s:.1f} tok/s", flush=True)
    return {"history": history, "log": out["history"],
            "final_step": out["final_step"], "restarts": out["restarts"],
            "fault_log": injector.log if injector else [],
            "resume_s": out["resume_s"], "save_s": out["save_s"],
            "mean_step_ms": mean_ms, "tokens_per_s": tok_s,
            "params": params, "opt_state": opt_state, "n_params": n_params,
            "n_layers": tr.cfg.n_layers, "depth": depth}


DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_train_ckpt")
_NOT_PORTED = ("mesh", "wire_spec", "wire_topology", "accum_steps",
               "accum_spec", "loss_scale", "watchdog", "health_fmt")


def _gemm_policy(name: str) -> str:
    """``--gemm-policy``: a preset or a canonical spec name, resolved
    (``precision.get_policy``) so that an unknown name is a usage error."""
    get_policy(name)
    return name


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
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR,
                    help="checkpoint directory; one that holds this run's "
                         "checkpoints resumes it (default: "
                         "repro_train_ckpt under the temporary directory)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--update-path", default="jnp",
                    choices=list(optim_base.UPDATE_PATHS),
                    help="parameter-update engine: per-leaf chain, "
                         "whole-tree fused kernel (in-kernel bits), or "
                         "whole-tree kernel with explicit bits")
    ap.add_argument("--optimizer", default="sgd", choices=["sgd", "adam"],
                    help="qsgd (momentum) or qadam; adam honours "
                         "--moments-spec and, with --update-path fused, "
                         "carries packed moments inside K5")
    ap.add_argument("--moments-spec", default=None,
                    help="Adam moment-carry grid: a canonical spec name "
                         "with an optional -kahan suffix, e.g. 'bf16-sr', "
                         "'e4m3-sr-kahan', 'bf16-sr-bittrick'; default "
                         "fp32.  Validated at launch")
    ap.add_argument("--ckpt-fmt", default=None,
                    help="packed-checkpoint grid: float32 state leaves on "
                         "this grid are stored as uint8/uint16 codes "
                         "(self-validating per leaf, restore stays "
                         "bit-exact), e.g. 'binary8' or 'bf16-sr'; default "
                         "raw float32")
    ap.add_argument("--gemm-policy", default=None, type=_gemm_policy,
                    help="quantized-GEMM precision policy (eq. 8a) of every "
                         "forward/dgrad/wgrad GEMM: a preset ("
                         f"{', '.join(sorted(PRESETS))}) or any canonical "
                         "spec name, e.g. 'fxp16.8-sr2' or 'e4m3-sr2-r16' "
                         "(every GEMM and the act site); default: "
                         "unrounded bf16 GEMMs")
    ap.add_argument("--fault-schedule", default=None,
                    help="fault schedule, e.g. 'preempt@3,corrupt@4,"
                         "nan@6' (health/inject.py)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the schedule's open choices")
    ap.add_argument("--restart-window", type=int, default=1000,
                    help="sliding step window of the restart budget (0: "
                         "the run's lifetime)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch path)")
    for name in _NOT_PORTED:
        ap.add_argument("--" + name.replace("_", "-"), default=None,
                        nargs="?", const=True, help="not ported yet")
    args = ap.parse_args(argv)
    for name in _NOT_PORTED:
        if getattr(args, name) is not None:
            raise NotImplementedError(f"--{name.replace('_', '-')} is not "
                                      "ported yet")
    return run(args.arch, ckpt_dir=args.ckpt_dir, reduced=args.reduced,
               steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
               rounding_kind=args.rounding, fmt=args.fmt, eps=args.eps,
               log_every=args.log_every, update_path=args.update_path,
               gemm_policy=args.gemm_policy, device=args.device,
               optimizer=args.optimizer, moments_spec=args.moments_spec,
               ckpt_fmt=args.ckpt_fmt, fault_schedule=args.fault_schedule,
               fault_seed=args.fault_seed,
               restart_window=args.restart_window)


if __name__ == "__main__":
    main()
