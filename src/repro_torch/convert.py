"""Carry a reference (JAX) serving or training state over to the port.

The caller fetches the reference state to the host as numpy arrays (for
example with ``jax.device_get``); nothing here imports JAX. The embedding
part is read by attribute (``w``, ``acc``, ``counts``, the tiers ``cache``
and ``l2`` as ``keys``/``rows``/``acc``, the projection ``proj`` as
``kernel``/``acc``; ``l2`` and ``proj`` may be ``None``), the dense part and
the Adam moments are nested dicts of arrays, of any depth, with the same
layout as ``WDLModel.init_dense`` (the sequence models' ``b{i}``/``ln_f``/
``attn`` blocks, ``s``, MMoE's ``e{i}``/``g{t}`` and ``task{t}`` towers
carry over leaf for leaf).

With a ``dist.Group`` past world 1 the reference state is the whole
(gathered) one, and each rank keeps its rows of ``w``/``acc``/``counts``
(``dist.sharding``), the rest whole.

The side workloads' parameters (``lm_params_from_jax``,
``schnet_params_from_jax``) and their Adam state (``opt_state_from_jax``)
carry over leaf for leaf at their dtypes: an ``ml_dtypes`` bfloat16 array
becomes a ``torch.bfloat16`` tensor through its ``uint16`` bits. Given a
``rank`` of a ``(data, model)`` mesh and the leaves' ``specs``
(``layers.transformer.lm_param_specs``; the moments' for the Adam state),
each returns that rank's shards of the whole (gathered) reference tree;
SchNet's leaves are replicated, so every rank holds them whole.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.packed_embedding import CacheState, ProjState
from repro_torch.core.packing import PicassoPlan
from repro_torch.dist.compat import Group, resolve_group
from repro_torch.dist.sharding import shard_emb_state
from repro_torch.embedding.state import EmbeddingState
from repro_torch.layers.transformer import shard_params


def _tensor(x: Any, device: torch.device) -> torch.Tensor:
    a = np.array(x, copy=True)
    if a.dtype.name == "bfloat16":  # ml_dtypes: no numpy dtype torch knows
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.as_tensor(a).to(device)


def _tree(x: Any, device: torch.device) -> Any:
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    return _tensor(x, device)


def state_from_jax(emb_np: Dict[str, Any], dense_np: Dict[str, Any], plan: PicassoPlan,
                   device: Union[str, torch.device] = "cuda",
                   group: Optional[Group] = None
                   ) -> Tuple[Dict[str, EmbeddingState], Dict[str, Any]]:
    """Reference ``state["emb"]``/``state["dense"]`` (host numpy) -> the
    port's ``emb`` dict and dense params on ``device`` (this rank's rows of
    the masters with ``group``)."""
    device = resolve_device(device)
    grp = resolve_group(plan.world, group)
    emb = {}
    for g in plan.groups:
        st = emb_np[str(g.gid)]
        w = _tensor(st.w, device)
        width = plan.narrow_width(g.gid)
        if tuple(w.shape) != (g.rows, width):
            raise ValueError(f"g{g.gid}: table {tuple(w.shape)} does not match the "
                             f"plan's {(g.rows, width)}")
        l2, proj = getattr(st, "l2", None), getattr(st, "proj", None)
        if (proj is not None) != (width < g.dim):
            raise ValueError(f"g{g.gid}: a projection is carried exactly when the plan "
                             f"narrows the master ({width} of {g.dim})")
        emb[str(g.gid)] = EmbeddingState(
            w=w, acc=_tensor(st.acc, device), counts=_tensor(st.counts, device),
            cache=CacheState(*(_tensor(x, device) for x in st.cache)),
            l2=None if l2 is None else CacheState(*(_tensor(x, device) for x in l2)),
            proj=None if proj is None else ProjState(*(_tensor(x, device) for x in proj)))
        emb[str(g.gid)] = shard_emb_state(emb[str(g.gid)], grp)
    return emb, _tree(dense_np, device)


def train_state_from_jax(state_np: Dict[str, Any], plan: PicassoPlan,
                         device: Union[str, torch.device] = "cuda",
                         group: Optional[Group] = None) -> Dict[str, Any]:
    """A reference train state (host numpy: ``emb``, ``dense``, ``opt`` with
    ``m``/``v``/``t``, ``step``) -> the port's train state on ``device``,
    with ``step`` a host int, so both sides can resume from one state."""
    device = resolve_device(device)
    emb, dense = state_from_jax(state_np["emb"], state_np["dense"], plan, device, group)
    return {"emb": emb, "dense": dense, "opt": opt_state_from_jax(state_np["opt"], device),
            "step": int(np.asarray(state_np["step"]))}


def _shards(tree: Any, rank: Optional[int], mesh_shape: Optional[Tuple[int, int]],
            specs: Optional[Dict]) -> Any:
    if rank is None:
        return tree
    if mesh_shape is None or specs is None:
        raise ValueError("a rank's shards need the mesh shape and the leaves' specs")
    return shard_params(tree, specs, mesh_shape, rank)


def lm_params_from_jax(params_np: Dict[str, Any],
                       device: Union[str, torch.device] = "cuda",
                       rank: Optional[int] = None,
                       mesh_shape: Optional[Tuple[int, int]] = None,
                       specs: Optional[Dict] = None) -> Dict[str, Any]:
    """A reference ``init_lm_params`` tree (host numpy; stacked ``[L, ...]``
    layers) -> the port's, each leaf at its dtype (with ``rank``, its
    shards at ``specs`` on a mesh of ``mesh_shape``)."""
    return _tree(_shards(params_np, rank, mesh_shape, specs), resolve_device(device))


def schnet_params_from_jax(params_np: Dict[str, Any],
                           device: Union[str, torch.device] = "cuda",
                           rank: Optional[int] = None,
                           mesh_shape: Optional[Tuple[int, int]] = None) -> Dict[str, Any]:
    """A reference ``init_schnet`` tree (host numpy) -> the port's (every
    rank of a mesh holds it whole)."""
    if rank is not None and not 0 <= int(rank) < int(np.prod(mesh_shape or (1,))):
        raise ValueError(f"rank {rank} outside a mesh of {mesh_shape}")
    return _tree(params_np, resolve_device(device))


def opt_state_from_jax(opt_np: Dict[str, Any],
                       device: Union[str, torch.device] = "cuda",
                       rank: Optional[int] = None,
                       mesh_shape: Optional[Tuple[int, int]] = None,
                       specs: Optional[Dict] = None) -> Dict[str, Any]:
    """A reference ``adam_init``/``adam_update`` state ``{m, v, t}`` (host
    numpy) -> the port's, the moments at their leaves' dtypes (with
    ``rank``, its shards of the moments at ``specs``; ``t`` whole)."""
    device = resolve_device(device)
    return {"m": _tree(_shards(opt_np["m"], rank, mesh_shape, specs), device),
            "v": _tree(_shards(opt_np["v"], rank, mesh_shape, specs), device),
            "t": _tensor(opt_np["t"], device).to(torch.int32)}
