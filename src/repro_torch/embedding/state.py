"""Per-group embedding state (table + adagrad acc + FCounter + hot tier),
``repro.embedding.state`` in torch.

The state is built directly on the target device from a ``torch.Generator``
on that device: full-width deepfm's table is 187,780,711 x 10 float32
(7.5 GB) and is never staged through the host. The L2 host tier and the
narrow projection leaves stay ``None`` in this slice.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.core.packed_embedding import CacheState, init_cache
from repro_torch.core.packing import PackedGroup, PicassoPlan


class EmbeddingState(NamedTuple):
    w: torch.Tensor       # [rows, D]
    acc: torch.Tensor     # [rows, 1]   adagrad accumulator
    counts: torch.Tensor  # [rows]      FCounter (warm-up + running stats)
    cache: CacheState     # hot tier (L1)
    l2: Optional[CacheState] = None
    proj: Optional[object] = None


def init_group_state(generator: torch.Generator, group: PackedGroup, hot_rows: int,
                     device: torch.device, dtype=torch.float32) -> EmbeddingState:
    w = torch.randn((group.rows, group.dim), generator=generator, dtype=dtype,
                    device=device)
    w.mul_(1.0 / float(max(group.dim, 1)) ** 0.5)
    return EmbeddingState(
        w=w,
        acc=torch.zeros((group.rows, 1), dtype=dtype, device=device),
        counts=torch.zeros((group.rows,), dtype=torch.int32, device=device),
        cache=init_cache(hot_rows, group.dim, group.rows, dtype, device=device),
    )


def init_embedding_state(generator: torch.Generator, plan: PicassoPlan,
                         device: torch.device, dtype=torch.float32
                         ) -> Dict[int, EmbeddingState]:
    for g in plan.groups:
        if plan.l2_rows.get(g.gid, 0) or plan.narrow_width(g.gid) < g.dim:
            raise NotImplementedError(
                f"g{g.gid}: L2 and narrow tiers belong to a later slice of the port")
    return {g.gid: init_group_state(generator, g, plan.cache_rows.get(g.gid, 0),
                                    device, dtype)
            for g in plan.groups}
