"""Which operations make the card's train-step gradients differ from the
CPU's: rounded GEMM kernels (K3', K4'), or plain float32 ops.

  PYTHONPATH=src python -m repro_torch.launch.split_agreement \\
      [--lr 4e-4 0.05] [--out chiprun_out/split_agreement.json]

The run is the reduced tinyllama-1.1b agreement check of ``chip_smoke.py``
phase 20: ``train.ADAM_RUN``'s settings (QAdam over bf16-sr moments,
``binary8-paper`` GEMMs, the signed-SRε binary8 update) on the
``fused_bits`` path, batch 2 x 16, the master parameters of
``init_master(Generator().manual_seed(3))``.  For each learning rate:

1. both devices take step 1 on their own and compute step 2's gradients
   from their own state (the agreement run's reading);
2. both compute step 2's gradients from the CPU's state after step 1, so
   every input is the same; every K3'/K4' call of that computation is
   recorded on both sides (operands and results);
3. each recorded CPU call is replayed on the card with the CPU's operands:
   through the kernel, and through the kernel's plain twin on the card;
   each is compared with the CPU's result (differing elements, and whether
   every difference is one grid step);
4. the card computes the gradients once more with every K3'/K4' result
   replaced by the CPU's: what still differs then comes from the plain
   float32 ops (norms, attention, SiLU's pullback, the cross-entropy).

It needs a card: without one it raises (``--device cpu`` rehearses the
control flow on the CPU, where nothing can differ).
"""
from __future__ import annotations

import argparse
import contextlib
import json
from pathlib import Path
from typing import Dict, List

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.rounding import grid_flips
from repro_torch.device import resolve_device
from repro_torch.kernels import qmatmul as tq
from repro_torch.kernels.tree_update import flat_backed, tree_leaves
from repro_torch.launch import train
from repro_torch.models import build_model
from repro_torch.precision import fused, policy

_HOOKS = ((policy, "qmatmul_prng", tq.qmatmul_plain),
          (fused, "qmatmul_swiglu_prng", tq.qmatmul_swiglu_plain))
# the replayed calls' comparisons: (reference, compared) results
_PAIRS = {"kernel_vs_cpu": ("cpu", "kernel"),
          "card_twin_vs_cpu": ("cpu", "twin"),
          "kernel_vs_card_twin": ("twin", "kernel")}


def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, dev) for v in x)
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    return x


def _outs(out) -> List[torch.Tensor]:
    return list(out) if isinstance(out, tuple) else [out]


@contextlib.contextmanager
def _gemms(calls: List[Dict], replay: List[Dict] = None):
    """Record every K3'/K4' call (name, CPU copies of the arguments and
    results); with ``replay``, return call i's recorded result instead of
    computing it."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in _HOOKS]

    def hook(name, fn):
        def wrapped(*args, **kw):
            i = len(calls)
            if replay is not None:
                rec = replay[i]
                dev = args[0].device
                out = tuple(t.to(dev) for t in rec["out"])
                out = out if len(out) > 1 else out[0]
            else:
                out = fn(*args, **kw)
            calls.append(dict(name=name, args=_to(args, "cpu"), kw=kw,
                              out=[t.detach().cpu() for t in _outs(out)]))
            return out
        return wrapped
    for mod, name, fn in saved:
        setattr(mod, name, hook(name, fn))
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _differing(a, b) -> int:
    return sum(int((x.float().cpu().view(torch.int32)
                    != y.float().cpu().view(torch.int32)).sum())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _compare(ref: List[torch.Tensor], got: List[torch.Tensor]) -> Dict:
    """Differing elements of each result, and whether every difference is
    one binary8 grid step (the GEMM contract)."""
    n, adjacent = 0, True
    for r, g in zip(ref, got):
        k, adj = grid_flips(r.float().cpu(), g.float().cpu(), "binary8")
        n += k
        adjacent &= adj
    return dict(differing=n, one_step=bool(adjacent),
                elements=sum(r.numel() for r in ref))


def _grads(tr, params, state, batch):
    grads, metrics = tr.train_step.grads_and_metrics(params, state.key,
                                                     state.step, batch)
    return grads, float(metrics["loss"])


def split(lr: float, device) -> Dict:
    cfg = reduced(get_config("tinyllama-1.1b"))
    master = build_model(cfg).init_master(torch.Generator().manual_seed(3))
    kw = {k: train.ADAM_RUN[k] for k in ("optimizer", "moments_spec",
                                         "gemm_policy", "rounding_kind",
                                         "fmt", "eps")}
    cpu, card = (train.setup("tinyllama-1.1b", reduced=True, batch=2,
                             seq=16, update_path="fused_bits", device=d,
                             params=_to(master, d), lr=lr, **kw)
                 for d in ("cpu", device))
    res: Dict = dict(lr=lr)
    # 1. the agreement run: each device on its own
    g1, g2 = [], []
    for tr in (cpu, card):
        g, _ = _grads(tr, tr.params, tr.opt_state, tr.batch(0))
        g1.append(g)
        tr.params, tr.opt_state = tr.train_step.optimizer.apply(
            tr.params, g, tr.opt_state)
        g2.append(_grads(tr, tr.params, tr.opt_state, tr.batch(1))[0])
    res["step1_grads_differing"] = _differing(*g1)
    res["step1_params_differing"] = _differing(cpu.params, card.params)
    res["step2_grads_differing_own_state"] = _differing(*g2)
    # 2. step 2 from the CPU's state on both devices, every GEMM recorded
    batch = cpu.batch(1)
    with _gemms([]) as cpu_calls:
        g_cpu, loss_cpu = _grads(cpu, cpu.params, cpu.opt_state, batch)
    state = cpu.opt_state._replace(m=_to(cpu.opt_state.m, device),
                                   v=_to(cpu.opt_state.v, device))
    params = flat_backed(_to(cpu.params, device))
    with _gemms([]) as card_calls:
        g_card, loss_card = _grads(card, params, state, _to(batch, device))
    res["step2_grads_differing_same_inputs"] = _differing(g_cpu, g_card)
    res["step2_loss"] = dict(cpu=loss_cpu, card=loss_card)
    res["gemm_calls"] = len(cpu_calls)
    first = next((i for i, (a, b) in enumerate(zip(cpu_calls, card_calls))
                  if any(isinstance(x, torch.Tensor)
                         and not torch.equal(x, y)
                         for x, y in zip(a["args"], b["args"]))), None)
    res["first_call_with_differing_operands"] = first
    # 3. each CPU call replayed on the card: the kernel and its twin
    rows = {key: [] for key in _PAIRS}
    plain = {name: fn for _, name, fn in _HOOKS}
    for i, rec in enumerate(cpu_calls):
        args = _to(rec["args"], device)
        outs = dict(cpu=rec["out"],
                    kernel=_outs(getattr(tq, rec["name"])(*args,
                                                          **rec["kw"])),
                    twin=_outs(plain[rec["name"]](
                        *args, **_twin_kw(rec["name"], rec["kw"]))))
        for key, (a, b) in _PAIRS.items():
            rows[key].append(dict(call=i, name=rec["name"],
                                  **_compare(outs[a], outs[b])))
    for key in _PAIRS:
        res[key] = _summary(rows[key])
    # 4. the card's float32 ops alone: every GEMM result is the CPU's
    with _gemms([], replay=cpu_calls):
        g_sub, loss_sub = _grads(card, params, state, _to(batch, device))
    res["step2_grads_differing_cpu_gemm_results"] = _differing(g_cpu, g_sub)
    res["step2_loss"]["card_cpu_gemm_results"] = loss_sub
    return res


def _twin_kw(name: str, kw: Dict) -> Dict:
    """The wrapper's keywords as its plain twin takes them."""
    if name == "qmatmul_prng":
        return {k: v for k, v in kw.items()
                if k in ("a_fmt", "out_packed")}
    keep = ("act_spec", "residuals", "out_packed", "residuals_packed")
    out = {k: v for k, v in kw.items() if k in keep}
    if "rand_bits" in kw:
        out["rand_bits"] = kw["rand_bits"]
    return out


def _summary(rows: List[Dict]) -> Dict:
    bad = [r for r in rows if r["differing"]]
    return dict(calls=len(rows), calls_differing=len(bad),
                elements_differing=sum(r["differing"] for r in rows),
                elements=sum(r["elements"] for r in rows),
                all_one_step=all(r["one_step"] for r in rows),
                max_share=max((r["differing"] / r["elements"] for r in rows),
                              default=0.0),
                differing_calls=bad)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--lr", type=float, nargs="+", default=[4e-4, 0.05])
    ap.add_argument("--device", default=None,
                    help="the device held against the CPU (default: cuda)")
    ap.add_argument("--out", default="chiprun_out/split_agreement.json")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    torch.backends.cuda.matmul.allow_tf32 = False
    out = dict(device=name, runs=[split(lr, dev) for lr in args.lr])
    for r in out["runs"]:
        brief = {k: v for k, v in r.items() if k not in _PAIRS}
        print(json.dumps(brief))
        for key in _PAIRS:
            s = {k: v for k, v in r[key].items() if k != "differing_calls"}
            print(f"  {key}: {json.dumps(s)}")
            for row in r[key]["differing_calls"][:12]:
                print(f"    {row}")
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
