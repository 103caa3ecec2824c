"""Top-k routed MoE (Mixtral / Phi-3.5 style) with sort-based dispatch
(``repro.layers.moe`` in torch).

Tokens sorted by expert, rank-within-expert = position minus the first
position of the expert, scattered into [E, C, D]; per-expert SwiGLU einsum;
weighted scatter back. Exact top-k with capacity-factor dropping (GShard
semantics). The reference's rules are kept: the top k breaks a tie of
probabilities toward the lower expert (``lax.top_k``; ``torch.topk``
promises no order), the sort by expert is stable, and an assignment past an
expert's capacity goes to a drop row ``E * cap`` that is cut off.
``repro``'s ``xe_sharding`` only pins a layout on a mesh, so the port takes
no such argument. Past world 1 the experts are tensor-parallel over
``F`` (``w1``/``w3`` columns, ``w2`` rows: ``lm_param_specs``), with no
expert parallelism: ``model`` is the ``"model"`` axis group, the
dispatched tokens enter the column products through ``spmd.copy_to`` and
the expert outputs are psum'd (``spmd.reduce_from``) before the combine,
so the router's gradient sees whole expert outputs. Decode keeps the
weights in place instead (``split``: every ``D`` contraction is this
rank's block over ``"data"``, psum'd, and the ``D`` outputs gathered).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.dist.compat import Group, psum
from repro_torch.dist.spmd import copy_to, gather_along, reduce_from
from repro_torch.layers.mlp import mixed_einsum, split_matmul


def top_k_lower_first(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest, a tie to the lower
    index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_dispatch(x: torch.Tensor, router_logits: torch.Tensor, n_experts: int,
                 top_k: int, capacity_factor: float = 1.25):
    """x: [N, D] -> (xe [E, C, D], (order, slot, tok, kept), gate [N, K], cap)."""
    n, d = x.shape
    probs = torch.softmax(router_logits.to(torch.float32), dim=-1)    # [N, E]
    gate, expert = top_k_lower_first(probs, top_k)                     # [N, K]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)   # renorm (Mixtral)

    cap = int(math.ceil(n * top_k / n_experts * capacity_factor))
    cap = max(8, min(cap, n))

    e_flat = expert.reshape(-1)                                        # [N*K]
    order = torch.sort(e_flat, stable=True).indices
    e_sorted = e_flat[order]
    # rank within expert among the sorted assignment list
    start = torch.searchsorted(e_sorted, e_sorted, side="left")
    rank = torch.arange(n * top_k, device=x.device) - start
    kept = rank < cap
    slot = torch.where(kept, e_sorted * cap + rank, n_experts * cap)

    tok = order // top_k                                               # token of each assignment
    xe = torch.zeros((n_experts * cap + 1, d), dtype=x.dtype, device=x.device)
    xe[slot] = x[tok]                                                  # row E * cap: dropped
    return xe[:-1].reshape(n_experts, cap, d), (order, slot, tok, kept), gate, cap


def moe_combine(ye: torch.Tensor, dispatch_info, gate: torch.Tensor, n: int,
                top_k: int) -> torch.Tensor:
    order, slot, tok, kept = dispatch_info
    e, cap, d = ye.shape
    flat = ye.reshape(e * cap, d)
    y_assign = flat[torch.clamp(slot, max=e * cap - 1)]
    y_assign = y_assign * kept[:, None].to(y_assign.dtype)
    g_sorted = gate.reshape(-1)[order]
    contrib = y_assign * g_sorted[:, None].to(y_assign.dtype)
    return torch.zeros((n, d), dtype=ye.dtype, device=ye.device).index_add_(0, tok, contrib)


def _experts(xe: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, w3: torch.Tensor,
             lead: str, model: Optional[Group] = None,
             split: Optional[Group] = None) -> torch.Tensor:
    if model is not None:
        xe = copy_to(xe, model)
    if split is not None:   # this rank's block of the D contraction
        n = w1.shape[-2]
        xe = xe.narrow(-1, split.rank * n, n)
    h = mixed_einsum(f"{lead}cd,edf->{lead}cf", xe, w1)
    g = mixed_einsum(f"{lead}cd,edf->{lead}cf", xe, w3)
    if split is not None:
        h, g = psum(h, split), psum(g, split)
    ye = mixed_einsum(f"{lead}cf,efd->{lead}cd", g * torch.sigmoid(g) * h, w2)
    if model is not None:
        ye = reduce_from(ye, model)
    return ye if split is None else gather_along(ye, split, -1)


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w1: torch.Tensor,
            w2: torch.Tensor, w3: torch.Tensor, top_k: int,
            capacity_factor: float = 1.25, groups: int = 1,
            model: Optional[Group] = None, split: Optional[Group] = None) -> torch.Tensor:
    """x: [N, D]; router_w: [D, E]; w1/w3: [E, D, F]; w2: [E, F, D] (with
    ``model``, this rank's ``F`` columns/rows; with ``split``, ``x`` whole
    on every rank and each weight this rank's block of ``D`` over
    ``split``: the contractions psum'd, the output gathered; no autograd).

    ``groups`` > 1 dispatches each of ``groups`` token groups alone (its own
    capacity), as the reference's ``vmap`` over the groups does.
    """
    n, d = x.shape
    e = router_w.shape[1]
    if groups <= 1 or n % groups:
        xe, info, gate, cap = moe_dispatch(x, split_matmul(x, router_w, split), e, top_k,
                                           capacity_factor)
        return moe_combine(_experts(xe, w1, w2, w3, "e", model, split), info, gate, n,
                           top_k)

    parts = [moe_dispatch(xl, split_matmul(xl, router_w, split), e, top_k, capacity_factor)
             for xl in x.reshape(groups, n // groups, d)]
    ye = _experts(torch.stack([p[0] for p in parts]), w1, w2, w3, "ge", model,
                  split)   # [G, E, C, D]
    out = [moe_combine(ye[i], p[1], p[2], n // groups, top_k) for i, p in enumerate(parts)]
    return torch.stack(out).reshape(n, d)
