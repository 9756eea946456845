"""Mixture-of-Experts FFN: routed experts with top-k routing and capacity,
and optional shared experts (counterpart of ``repro.models.moe``).

The single-device dense path of the reference: router GEMM (``qdense``,
K3' under a policy), softmax, top-k, capacity scatter into an (E, C, D)
buffer, the three expert GEMMs as batched rounded contractions
(``qeinsum``, K8') with the post-SwiGLU hidden on the act site (``qact``,
K1'), then the weighted combine.  Capacity per expert C = max(1, int(T·k·cf
/ max(E, k))); overflowing tokens are dropped (combine weight zero), as in
GShard/Switch.  The Switch load-balance aux loss is returned alongside.
The reference's two expert-parallel shard_map layouts are not ported yet.

Expert stacks are kept as one (E, D, F) tensor per layer (a list over the
layers in the block tree), never as one (L, E, D, F) stack.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.qmatmul import silu
from repro_torch.models import layers as L
from repro_torch.models.ffn import ffn_apply, ffn_init
from repro_torch.precision import policy as QP


def moe_init(gen: torch.Generator, cfg, n: int,
             dtype: torch.dtype = torch.float32) -> Dict[str, object]:
    """The MoE parameters of ``n`` layers: the router stacked (n, D, E),
    each expert stack a list of ``n`` per-layer tensors, drawn one layer
    at a time."""
    m, d = cfg.moe, cfg.d_model

    def stacks(d_in, d_out):
        return [L.dense_init(gen, d_in, d_out, n=m.n_experts, dtype=dtype)
                for _ in range(n)]

    params: Dict[str, object] = {
        "router": L.dense_init(gen, d, m.n_experts, scale=0.02, n=n,
                               dtype=dtype),
        "w_gate": stacks(d, m.d_expert),
        "w_up": stacks(d, m.d_expert),
        "w_down": stacks(m.d_expert, d),
    }
    if m.n_shared:
        params["shared"] = ffn_init(gen, d, m.n_shared * m.d_expert,
                                    cfg.ffn_act, n=n, dtype=dtype)
    return params


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, ties broken toward the lower index (a stable
    descending sort; ``torch.topk`` makes no promise about ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _expert_compute(buf, w_gate, w_up, w_down, dtype, quant=None):
    """Batched SwiGLU over stacked experts: (E, C, D) -> (E, C, D); each
    expert GEMM one batched rounded contraction, the hidden on the act
    site (the reference's ``_expert_compute``)."""
    gate = silu(QP.qeinsum("ecd,edf->ecf", buf, w_gate.to(dtype), quant,
                           QP.TAG_MOE_GATE))
    up = QP.qeinsum("ecd,edf->ecf", buf, w_up.to(dtype), quant,
                    QP.TAG_MOE_UP)
    h = QP.qact(gate * up, quant, QP.TAG_MOE_ACT)
    return QP.qeinsum("ecf,efd->ecd", h, w_down.to(dtype), quant,
                      QP.TAG_MOE_DOWN)


def dispatch(topi: torch.Tensor, n_experts: int, capacity: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Capacity slots of the (T, k) routing choices, flattened token-major
    then by rank: (expert, position, keep) per slot.  Position = how many
    earlier slots chose the same expert; a slot at or past the capacity
    is dropped and parked at position C - 1."""
    e_flat = topi.reshape(-1)                                   # (T*k,)
    onehot = F.one_hot(e_flat, n_experts).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0) - onehot
    p_flat = torch.gather(pos, 1, e_flat[:, None])[:, 0]
    keep = p_flat < capacity
    return e_flat, torch.clamp(p_flat, max=capacity - 1), keep


def _dispatch_compute_combine(xt, topw, topi, w_gate, w_up, w_down,
                              n_experts: int, top_k_: int,
                              capacity_factor: float, dtype, quant=None):
    """Capacity scatter -> expert FFN -> weighted combine, one device."""
    T, D = xt.shape
    E = n_experts
    C = max(1, int(T * top_k_ * capacity_factor / max(E, top_k_)))
    e_flat, p_flat, keep = dispatch(topi, E, C)
    x_rep = torch.repeat_interleave(xt, top_k_, dim=0)          # (T*k, D)
    buf = torch.zeros((E, C, D), dtype=dtype, device=xt.device)
    src = torch.where(keep[:, None], x_rep, torch.zeros_like(x_rep))
    buf.index_put_((e_flat, p_flat), src.to(dtype), accumulate=True)
    out = _expert_compute(buf, w_gate, w_up, w_down, dtype, quant=quant)
    y_slots = out[e_flat, p_flat]                               # (T*k, D)
    w_flat = topw.reshape(-1) * keep.float()
    return (y_slots.float() * w_flat[:, None]).reshape(T, top_k_, D) \
        .sum(1).to(dtype)


def moe_apply(params, x: torch.Tensor, cfg,
              quant: Optional[QP.QuantCtx] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss).  ``quant`` routes the router GEMM,
    the shared expert and the routed experts through the rounded
    kernels."""
    m = cfg.moe
    B, S, D = x.shape
    dtype = x.dtype
    T = B * S
    xt = x.reshape(T, D)
    if m.router_noise:
        raise NotImplementedError("router noise is not ported yet")
    logits = L.qdense(xt, params["router"], quant, QP.TAG_ROUTER).float()
    probs = torch.softmax(logits, dim=-1)                       # (T, E)
    topw, topi = top_k(probs, m.top_k)                          # (T, k)
    topw = topw / (topw.sum(-1, keepdim=True) + 1e-9)
    E = m.n_experts
    y = _dispatch_compute_combine(xt, topw, topi, params["w_gate"],
                                  params["w_up"], params["w_down"], E,
                                  m.top_k, m.capacity_factor, dtype,
                                  quant=quant)
    if m.n_shared:
        y = y + ffn_apply(params["shared"], xt, cfg.ffn_act, quant=quant)
    # Switch-style load-balance loss
    frac_tokens = F.one_hot(topi[:, 0], E).float().mean(0)
    frac_probs = probs.mean(0)
    aux = E * torch.sum(frac_tokens * frac_probs)
    return y.reshape(B, S, D), aux
