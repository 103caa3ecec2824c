"""The side workloads' steps (``repro.launch.cells``'s ``make_lm_train_step``
and ``make_schnet_step`` in torch, at world 1), and the LM decode cell's
ring slot.

Each step composes the loss, its gradients and ``adam_update`` as the
reference's does, with its defaults. ``Cell``, the ``build_*_cell``
builders, the mesh shardings, ``launch/dryrun.py`` and ``roofline.py``
lower a step through XLA and wait for ROADMAP Queue 1 item 7b; so does any
group past world 1.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import LMConfig, SchNetConfig
from repro_torch.dist.compat import Group
from repro_torch.layers.transformer import lm_loss
from repro_torch.models.schnet import schnet_loss
from repro_torch.optim.optimizers import adam_update, tree_leaves, tree_unflatten

Step = Callable[[Dict, Dict, Any], Tuple[Dict, Dict, torch.Tensor]]


def _world1(group: Optional[Group]) -> None:
    if group is not None and int(group.world) > 1:
        raise NotImplementedError(
            "the side workloads past world 1 (the LM's TP/FSDP, SchNet's edge-sharded "
            "psum) are ROADMAP Queue 1 item 7b")


def value_and_grad(loss_fn: Callable[[Dict, Any], torch.Tensor]
                   ) -> Callable[[Dict, Any], Tuple[torch.Tensor, Dict]]:
    """``jax.value_and_grad`` of ``loss_fn(params, batch)`` over the
    parameter tree: ``(loss, grads)``, the gradients a tree like ``params``."""
    def vg(params: Dict, batch: Any) -> Tuple[torch.Tensor, Dict]:
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss = loss_fn(tree_unflatten(params, leaves), batch)
        return loss.detach(), tree_unflatten(params, list(torch.autograd.grad(loss, leaves)))

    return vg


def _adam_step(loss_fn: Callable[[Dict, Any], torch.Tensor], lr: float) -> Step:
    vg = value_and_grad(loss_fn)

    def step(params: Dict, opt: Dict, batch: Any) -> Tuple[Dict, Dict, torch.Tensor]:
        loss, grads = vg(params, batch)
        params2, opt2 = adam_update(params, grads, opt, lr)
        return params2, opt2, loss

    return step


def lm_loss_fn(cfg: LMConfig, attn_chunk: int = 512, loss_chunk: int = 512,
               remat: bool = True) -> Callable[[Dict, Any], torch.Tensor]:
    """The train step's loss, ``loss_fn(params, tokens)``."""
    return lambda p, tokens: lm_loss(cfg, p, tokens, attn_chunk=attn_chunk, remat=remat,
                                     loss_chunk=loss_chunk)


def make_lm_train_step(cfg: LMConfig, attn_chunk: int = 512, loss_chunk: int = 512,
                       remat: bool = True, lr: float = 1e-4,
                       group: Optional[Group] = None) -> Step:
    """``step(params, opt, tokens) -> (params, opt, loss)``: next-token CE
    (``lm_loss``) and one Adam update."""
    _world1(group)
    return _adam_step(lm_loss_fn(cfg, attn_chunk, loss_chunk, remat), lr)


def make_schnet_step(cfg: SchNetConfig, lr: float = 1e-3,
                     group: Optional[Group] = None) -> Step:
    """``step(params, opt, batch) -> (params, opt, loss)``: ``schnet_loss``
    and one Adam update (the reference's ``pmean`` is the identity at
    world 1)."""
    _world1(group)
    return _adam_step(lambda p, batch: schnet_loss(cfg, p, batch), lr)


def decode_cache_len(cfg: LMConfig, seq: int) -> int:
    """The decode cell's KV cache: ``seq`` positions, or a ring of the
    sliding window's when the window is shorter."""
    return min(seq, cfg.swa_window) if cfg.swa_window else seq


def ring_slot(length: Any, cache_len: int) -> Any:
    """The decode cell's write position for a fill of ``length``."""
    return length % cache_len
