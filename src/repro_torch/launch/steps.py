"""The train step (counterpart of ``repro.launch.steps.make_train_step``
with one microbatch, no gradient wire, no loss scale and no health
telemetry; those options are not ported yet).

The loss is differentiated with respect to **bf16 casts** of the float32
master parameters, so the gradients are bf16 (rounded where the reference
rounds them), then widened to float32 for the optimizer.  The step's rng is
``fold_in(opt_state.key, opt_state.step)``.

Memory: the master parameters are views of one flat float32 buffer
(``tree_update.flat_backed``); the cast is one pass over it, and the
gradients are widened straight into one new flat buffer in the flat order,
so the optimizer sees flat-backed trees and copies nothing.  Layer-stacked
leaves are differentiated per layer (lists of per-layer slices).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.core import prng
from repro_torch.kernels.tree_update import (tree_flatten, tree_map,
                                             tree_ravel, tree_unflatten,
                                             tree_unravel)


def _grad_leaves(params, grad_dtype):
    """(cast tree, its leaves in flat order): every leaf a bf16 view of
    one cast of the flat master vector, block leaves split per layer,
    each an autograd leaf."""
    flat, spec = tree_ravel(params)
    cast = tree_unravel(flat.to(grad_dtype), spec)
    cast["blocks"] = tree_map(lambda a: list(a.unbind(0)), cast["blocks"])
    leaves, treedef = tree_flatten(cast)
    leaves = [a.detach().requires_grad_() for a in leaves]
    return tree_unflatten(treedef, leaves), leaves, spec


def make_train_step(model, optimizer):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with the reference's semantics (its ``grad_dtype`` bf16;
    the GEMM policy is the model config's)."""

    def grads_and_metrics(params, key: prng.Key, step: int, batch
                          ) -> Tuple[Any, Dict[str, torch.Tensor]]:
        cast, leaves, spec = _grad_leaves(params, torch.bfloat16)
        with torch.enable_grad():
            loss, metrics = model.loss_fn(cast, batch,
                                          rng=prng.fold_in(key, step))
            grads = torch.autograd.grad(loss, leaves)
        gflat = torch.empty(sum(spec[2]), dtype=torch.float32,
                            device=loss.device)
        off = 0
        for g in grads:
            gflat[off:off + g.numel()].copy_(g.reshape(-1))
            off += g.numel()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return tree_unravel(gflat, spec), metrics

    def train_step(params, opt_state, batch):
        grads, metrics = grads_and_metrics(params, opt_state.key,
                                           opt_state.step, batch)
        new_params, new_state = optimizer.apply(params, grads, opt_state)
        return new_params, new_state, metrics

    # its two halves, for checks that compare one without the other
    train_step.grads_and_metrics = grads_and_metrics
    train_step.optimizer = optimizer
    return train_step
