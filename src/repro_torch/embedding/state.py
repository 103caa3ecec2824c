"""Per-group embedding state (table + adagrad acc + FCounter + cache tiers +
the narrow projection), ``repro.embedding.state`` in torch.

The state is built directly on the target device from a ``torch.Generator``
on that device: full-width deepfm's table is 187,780,711 x 10 float32
(7.5 GB) and is never staged through the host. ``l2`` is the optional
second cache tier behind the hot tier (``None`` when the plan budgets no L2
rows); ``proj`` is set exactly when the master is narrow (``picasso_narrow``
with ``narrow_dim < dim``). The port keeps the L2 tier in device memory;
the reference's pinned-host placement (``--pin-l2``) is not ported.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.packed_embedding import CacheState, ProjState, init_cache
from repro_torch.core.packing import PackedGroup, PicassoPlan


class EmbeddingState(NamedTuple):
    w: torch.Tensor       # [rows, D] (the NARROW width d for picasso_narrow)
    acc: torch.Tensor     # [rows, 1]   adagrad accumulator
    counts: torch.Tensor  # [rows]      FCounter (warm-up + running stats)
    cache: CacheState     # hot tier (L1), always at the model width
    l2: Optional[CacheState] = None   # second tier (L2), None = no tier
    proj: Optional[ProjState] = None  # learned [d, D] up-projection


def _np_proj_kernel(gid: int, nd: int, d: int) -> np.ndarray:
    """The reference's deterministic projection init, copied exactly so the
    port's projection is bitwise the reference's: orthonormal ROWS (QR of a
    seeded normal), so at init ``P @ P^T = I`` and the pseudo-inverse is
    ``P^T``. Seeded per (gid, d, D)."""
    rng = np.random.default_rng(
        np.random.SeedSequence(entropy=0x91CA550, spawn_key=(gid, nd, d)))
    a = rng.standard_normal((d, nd))
    q, _ = np.linalg.qr(a)            # [D, nd], orthonormal columns
    return np.ascontiguousarray(q.T.astype(np.float32))  # [nd, D]


def init_proj(gid: int, nd: int, d: int, device: torch.device,
              dtype=torch.float32) -> ProjState:
    return ProjState(kernel=torch.as_tensor(_np_proj_kernel(gid, nd, d)).to(device, dtype),
                     acc=torch.zeros((nd, 1), dtype=dtype, device=device))


def init_group_state(generator: torch.Generator, group: PackedGroup, hot_rows: int,
                     device: torch.device, dtype=torch.float32, l2_rows: int = 0,
                     narrow_dim: Optional[int] = None) -> EmbeddingState:
    """``narrow_dim`` below the group's dim makes the MASTER narrow (cold ids
    live at width ``d``, scaled ``1/sqrt(d)``, and are projected up at
    lookup); the tiers stay at the full width."""
    nd = group.dim if narrow_dim is None else int(narrow_dim)
    narrow = 0 < nd < group.dim
    width = nd if narrow else group.dim
    w = torch.randn((group.rows, width), generator=generator, dtype=dtype, device=device)
    w.mul_(1.0 / float(max(width, 1)) ** 0.5)
    return EmbeddingState(
        w=w,
        acc=torch.zeros((group.rows, 1), dtype=dtype, device=device),
        counts=torch.zeros((group.rows,), dtype=torch.int32, device=device),
        cache=init_cache(hot_rows, group.dim, group.rows, dtype, device=device),
        l2=(init_cache(l2_rows, group.dim, group.rows, dtype, device=device)
            if l2_rows > 0 else None),
        proj=init_proj(group.gid, width, group.dim, device, dtype) if narrow else None,
    )


def init_embedding_state(generator: torch.Generator, plan: PicassoPlan,
                         device: torch.device, dtype=torch.float32
                         ) -> Dict[int, EmbeddingState]:
    """Per-group state sized by the plan: hot tier ``cache_rows``, L2 tier
    ``l2_rows``, master width ``narrow_width`` (narrow only where the plan
    records a ``'picasso_narrow'`` assignment)."""
    return {g.gid: init_group_state(generator, g, plan.cache_rows.get(g.gid, 0), device,
                                    dtype, l2_rows=plan.l2_rows.get(g.gid, 0),
                                    narrow_dim=plan.narrow_width(g.gid))
            for g in plan.groups}


def tier_gates(plan: PicassoPlan, gid: int, *, use_cache: bool = True,
               use_l2: bool = True) -> Tuple[bool, bool]:
    """``(cache_on, l2_on)`` for one group: the engine's gating rule
    (strategy class attributes x plan budgets x engine flags), from the
    plan's recorded assignment. Groups without one default to
    ``'picasso'``."""
    # lazy import: engine.strategies imports this module (EmbeddingState)
    from repro_torch.engine.strategies import get_strategy

    cls = get_strategy(plan.strategy.get(gid, "picasso"))
    cache_on = bool(use_cache and cls.uses_cache and plan.cache_rows.get(gid, 0) > 0)
    l2_on = bool(use_l2 and cache_on and cls.uses_l2 and plan.l2_rows.get(gid, 0) > 0)
    return cache_on, l2_on
