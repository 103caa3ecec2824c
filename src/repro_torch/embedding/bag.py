"""EmbeddingBag from torch primitives (``repro.embedding.bag`` in torch).

A gather and an ``index_add_``: the plain oracle of a sum-pooling bag, the
function the reference's Pallas ``embedding_bag`` is validated against. The
engine's own pooling runs the ``gather_pool`` kernel (``kernels.ops``).
"""
from __future__ import annotations

from typing import Optional

import torch


def embedding_bag(
    table: torch.Tensor,                      # [V, D]
    ids: torch.Tensor,                        # [N]
    seg: torch.Tensor,                        # [N] bag index, in any order
    n_bags: int,
    weights: Optional[torch.Tensor] = None,   # [N]
) -> torch.Tensor:
    """sum-pool EmbeddingBag: out[b] = sum_{i: seg[i]==b} w[i] * table[ids[i]].
    A position whose ``seg`` lies outside ``[0, n_bags)`` adds to no bag, as
    ``jax.ops.segment_sum`` drops it."""
    rows = table[ids.long()]
    if weights is not None:
        rows = rows * weights[:, None].to(rows.dtype)
    keep = (seg >= 0) & (seg < n_bags)
    out = torch.zeros((n_bags, table.shape[1]), dtype=rows.dtype, device=rows.device)
    return out.index_add_(0, seg[keep].long(), rows[keep])
