"""The side workloads' steps (``repro.launch.cells``'s ``make_lm_train_step``
and ``make_schnet_step`` in torch, and the prefill and decode steps that
``build_lm_cell`` jits), with the LM decode cell's ring slot.

Each step composes the loss, its gradients and ``adam_update`` as the
reference's does, with its defaults. Past world 1 each takes the rank's
``group`` and the ``(data, model)`` mesh it lays out row-major
(``launch.mesh``), one process a rank:

* SchNet: each rank takes its block of the edge arrays (padded with
  zero-weight edges to a multiple of the world, as ``build_gnn_cell``'s
  ``_pad`` sizes them), the node arrays and targets whole; the gradients
  and the loss are pmean'd and Adam runs on replicated leaves;
* the LM: parameters laid out by ``lm_param_specs`` (``shard_mode``
  ``'fsdp'``, or ``'zero1'``: replicated over ``"data"``), tokens split
  over ``"data"``, the gradients reduce-scattered onto the moments' specs
  (always FSDP), Adam on the shards, and under ``'zero1'`` the new
  parameter shards gathered back over ``"data"``; ``moe_shard`` is the
  reference's ``_moe_exec`` (each data rank's tokens one MoE group);
* prefill and decode take the parameters as ``lm_param_specs`` lays them
  out and the cache as ``cache_specs`` does.

``Cell``, the ``build_*_cell`` builders, ``launch/dryrun.py`` and
``roofline.py`` lower a step through XLA and wait for ROADMAP Queue 1
item 7b.2.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import LMConfig, SchNetConfig
from repro_torch.dist.compat import WORLD1, Group, axis_groups, psum
from repro_torch.dist.spmd import gather_along, scatter_sum_along
from repro_torch.launch.mesh import AXES, mesh_world
from repro_torch.layers.transformer import (KVCache, LMMesh, lm_decode_step, lm_loss,
                                            lm_mesh, lm_param_specs, lm_prefill)
from repro_torch.models.schnet import schnet_loss
from repro_torch.optim.optimizers import adam_update, tree_leaves, tree_map, tree_unflatten

Step = Callable[[Dict, Dict, Any], Tuple[Dict, Dict, torch.Tensor]]

EDGE_KEYS = ("src", "dst", "dist", "edge_w")


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


def _mesh(group: Optional[Group], mesh_shape: Optional[Sequence[int]]
          ) -> Tuple[Group, Tuple[int, int]]:
    """The step's group and its ``(data, model)`` mesh (``(world, 1)`` when
    none is given)."""
    grp = WORLD1 if group is None else group
    shape = (grp.world, 1) if mesh_shape is None else tuple(int(x) for x in mesh_shape)
    if len(shape) != 2 or mesh_world(shape) != grp.world:
        raise ValueError(f"mesh {shape} for a group of world {grp.world}")
    return grp, shape


def lm_loss_fn(cfg: LMConfig, attn_chunk: int = 512, loss_chunk: int = 512,
               remat: bool = True, mesh: Optional[LMMesh] = None, moe_groups: int = 1
               ) -> Callable[[Dict, Any], torch.Tensor]:
    """The train step's loss, ``loss_fn(params, tokens)`` (with ``mesh``,
    the rank's share; ``moe_groups`` as ``lm_loss`` takes it)."""
    return lambda p, tokens: lm_loss(cfg, p, tokens, attn_chunk=attn_chunk, remat=remat,
                                     loss_chunk=loss_chunk, mesh=mesh, moe_groups=moe_groups)


def moe_exec(cfg: LMConfig, mesh_shape: Sequence[int], moe_shard: bool) -> bool:
    """The reference's ``_moe_exec``: whether the MoE dispatches each data
    shard's tokens as one group (``moe_shard`` with more than one data
    shard)."""
    return cfg.moe is not None and bool(moe_shard) and int(mesh_shape[0]) > 1


def data_block(x: torch.Tensor, data: Group) -> torch.Tensor:
    """This rank's block of ``x``'s dim 0 over the ``"data"`` axis."""
    if x.shape[0] % data.world:
        raise ValueError(f"a batch of {x.shape[0]} does not split over {data.world} "
                         "data ranks")
    n = x.shape[0] // data.world
    return x.narrow(0, data.rank * n, n)


def _onto(pspec, mspec) -> Tuple[Tuple[int, ...], bool]:
    """The dims a gradient laid out by ``pspec`` reduce-scatters over
    ``"data"`` to reach ``mspec``, and whether it is psum'd over
    ``"data"`` instead (a leaf replicated over ``"data"`` in both)."""
    dims = tuple(i for i, (a, b) in enumerate(zip(pspec, mspec))
                 if b == "data" and a != "data")
    return dims, "data" not in mspec


def make_lm_train_step(cfg: LMConfig, attn_chunk: int = 512, loss_chunk: int = 512,
                       remat: bool = True, lr: float = 1e-4,
                       group: Optional[Group] = None,
                       mesh_shape: Optional[Sequence[int]] = None,
                       shard_mode: str = "fsdp", moe_shard: bool = False) -> Step:
    """``step(params, opt, tokens) -> (params, opt, loss)``: next-token CE
    (``lm_loss``) and one Adam update.

    Past world 1 ``params`` are the rank's shards at ``lm_param_specs(cfg,
    mesh, fsdp=shard_mode == 'fsdp')``, ``opt``'s moments its shards at
    ``moment_specs``, and ``tokens`` the whole global batch; the loss is the
    global mean on every rank."""
    if shard_mode not in ("fsdp", "zero1"):
        raise ValueError(f"shard_mode {shard_mode!r}: 'fsdp' or 'zero1'")
    grp, shape = _mesh(group, mesh_shape)
    if grp.world == 1:
        return _adam_step(lm_loss_fn(cfg, attn_chunk, loss_chunk, remat), lr)
    axes = axis_groups(grp, shape, AXES)
    mshape = dict(zip(AXES, shape))
    pspecs = lm_param_specs(cfg, mshape, fsdp=shard_mode == "fsdp")
    mspecs = lm_param_specs(cfg, mshape, fsdp=True)
    mesh = lm_mesh(axes, pspecs, moe_local=moe_exec(cfg, shape, moe_shard))
    data = axes["data"]
    plan = [_onto(a, b) for a, b in zip(tree_leaves(pspecs), tree_leaves(mspecs))]
    vg = value_and_grad(lm_loss_fn(cfg, attn_chunk, loss_chunk, remat, mesh))

    def step(params: Dict, opt: Dict, tokens: torch.Tensor) -> Tuple[Dict, Dict, torch.Tensor]:
        share, grads = vg(params, data_block(tokens, data))
        loss = psum(share, data)
        gl = tree_leaves(grads)
        del grads
        ps, gs = [], []
        for i, (p, (dims, summed)) in enumerate(zip(tree_leaves(params), plan)):
            g, gl[i] = gl[i], None   # each whole gradient freed once reduced
            if summed:
                g = psum(g, data)
            for d in dims:
                g = scatter_sum_along(g, data, d)
                n = p.shape[d] // data.world
                p = p.narrow(d, data.rank * n, n)
            ps.append(p)
            gs.append(g)
        new, opt2 = adam_update(tree_unflatten(params, ps), tree_unflatten(params, gs),
                                opt, lr)
        del ps, gs
        nl, out = tree_leaves(new), []
        del new
        for i, (dims, _) in enumerate(plan):
            p, nl[i] = nl[i], None   # each new shard freed once gathered
            for d in dims:
                p = gather_along(p, data, d)
            out.append(p)
        return tree_unflatten(params, out), opt2, loss

    return step


def moment_specs(cfg: LMConfig, mesh_shape: Sequence[int]) -> Dict:
    """The layout of the Adam moments past world 1 (FSDP in both shard
    modes), as ``repro``'s ``mspecs``."""
    return lm_param_specs(cfg, dict(zip(AXES, mesh_shape)), fsdp=True)


def pad_edges(batch: Dict[str, torch.Tensor], world: int) -> Dict[str, torch.Tensor]:
    """``batch`` with its edge arrays padded to a multiple of ``world`` by
    edges of weight 0 from node 0 to node 0 at distance 0 (they add 0 to
    every node sum and to every gradient)."""
    e = batch["src"].shape[0]
    pad = -e % world
    if not pad:
        return batch
    out = dict(batch)
    for k in EDGE_KEYS:
        v = batch[k]
        out[k] = torch.cat([v, torch.zeros((pad,) + tuple(v.shape[1:]), dtype=v.dtype,
                                           device=v.device)])
    return out


def edge_block(batch: Dict[str, torch.Tensor], group: Group) -> Dict[str, torch.Tensor]:
    """Rank ``group.rank``'s block of the (padded) edge arrays; the node
    arrays and targets whole."""
    if group.world == 1:
        return batch
    padded = pad_edges(batch, group.world)
    n = padded["src"].shape[0] // group.world
    return {k: v.narrow(0, group.rank * n, n) if k in EDGE_KEYS else v
            for k, v in padded.items()}


def make_schnet_step(cfg: SchNetConfig, lr: float = 1e-3,
                     group: Optional[Group] = None) -> Step:
    """``step(params, opt, batch) -> (params, opt, loss)``: ``schnet_loss``
    and one Adam update. Past world 1 ``batch`` is the whole batch; each
    rank runs on its edge block, and the gradients and the loss are
    pmean'd over the group (the identity at world 1)."""
    grp = WORLD1 if group is None else group
    if grp.world == 1:
        return _adam_step(lambda p, batch: schnet_loss(cfg, p, batch), lr)
    vg = value_and_grad(lambda p, batch: schnet_loss(cfg, p, edge_block(batch, grp),
                                                     group=grp))

    def pmean(x: torch.Tensor) -> torch.Tensor:
        return psum(x, grp) / grp.world

    def step(params: Dict, opt: Dict, batch: Any) -> Tuple[Dict, Dict, torch.Tensor]:
        loss, grads = vg(params, batch)
        params2, opt2 = adam_update(params, tree_map(pmean, grads), opt, lr)
        return params2, opt2, pmean(loss)

    return step


def decode_cache_len(cfg: LMConfig, seq: int) -> int:
    """The decode cell's KV cache: ``seq`` positions, or a ring of the
    sliding window's when the window is shorter."""
    return min(seq, cfg.swa_window) if cfg.swa_window else seq


def ring_slot(length: Any, cache_len: int) -> Any:
    """The decode cell's write position for a fill of ``length``."""
    return length % cache_len


def cache_specs(batch: int, mesh_shape: Sequence[int]) -> Tuple[Optional[str], ...]:
    """The serving cells' KV cache layout ``[L, B, S, G, hd]`` (the
    reference's ``_cache_specs``): S over ``"model"``, B over ``"data"``
    when the data ranks divide it."""
    dpn = int(mesh_shape[0])
    b_ax = "data" if batch % dpn == 0 and batch >= dpn else None
    return (None, b_ax, "model", None, None)


def make_lm_prefill_step(cfg: LMConfig, attn_chunk: int = 512,
                         group: Optional[Group] = None,
                         mesh_shape: Optional[Sequence[int]] = None,
                         moe_shard: bool = False
                         ) -> Callable[[Dict, torch.Tensor], Tuple[torch.Tensor, KVCache]]:
    """The prefill cell's step, ``step(params, tokens) -> (logits,
    cache)``. Past world 1 ``params`` are the rank's shards
    (``lm_param_specs``, FSDP), ``tokens`` the whole batch; it returns the
    rank's block of the last position's logits (``P(data, model)``) and of
    the cache (``cache_specs``)."""
    grp, shape = _mesh(group, mesh_shape)
    if grp.world == 1:
        return lambda params, tokens: lm_prefill(cfg, params, tokens, attn_chunk=attn_chunk)
    axes = axis_groups(grp, shape, AXES)
    mesh = lm_mesh(axes, lm_param_specs(cfg, dict(zip(AXES, shape))),
                   moe_local=moe_exec(cfg, shape, moe_shard))

    def step(params: Dict, tokens: torch.Tensor) -> Tuple[torch.Tensor, KVCache]:
        return lm_prefill(cfg, params, data_block(tokens, axes["data"]),
                          attn_chunk=attn_chunk, mesh=mesh)

    return step


def make_lm_decode_step(cfg: LMConfig, cache_len: int, group: Optional[Group] = None,
                        mesh_shape: Optional[Sequence[int]] = None):
    """The decode cell's step, ``step(params, cache, tokens, length) ->
    (logits, cache)``: one token a sequence against a cache of
    ``cache_len`` positions, written at ``ring_slot(length)``, which the
    cell also passes as the fill (the reference's cell). Past world 1
    ``params`` are the rank's shards, ``cache`` its block (``cache_specs``)
    and ``tokens`` the whole batch ``[B, 1]``; the logits come back for the
    whole batch and the rank's vocab block (``P(None, "model")``)."""
    grp, shape = _mesh(group, mesh_shape)
    if grp.world == 1:
        def step1(params, cache, tokens, length):
            return lm_decode_step(cfg, params, cache, tokens, ring_slot(length, cache_len))
        return step1
    if cache_len % shape[1]:
        raise ValueError(f"a cache of {cache_len} positions does not split over "
                         f"{shape[1]} model ranks")
    axes = axis_groups(grp, shape, AXES)
    specs = lm_param_specs(cfg, dict(zip(AXES, shape)))

    def step(params, cache, tokens, length):
        split = cache_specs(tokens.shape[0], shape)[1] is not None
        return lm_decode_step(cfg, params, cache, tokens, ring_slot(length, cache_len),
                              mesh=lm_mesh(axes, specs, tokens_split=split))

    return step
