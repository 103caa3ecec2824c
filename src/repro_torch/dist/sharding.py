"""Per-rank placement for the hybrid MP/DP layout (``repro.dist.sharding``
in torch).

The reference's one convention, with each rank holding its share:

* embedding tables, Adagrad accumulators and FCounters (``w``, ``acc``,
  ``counts``) are row-sharded over the whole mesh: rank ``r`` holds rows
  ``[r*rps, (r+1)*rps)`` of the padded table, ``rps = rows // world``;
* the HybridHash tiers, the narrow projection, the dense parameters and
  the Adam moments are replicated: every rank holds all of them;
* batches are sharded on their leading dimension: rank ``r`` takes samples
  ``[r*B/W, (r+1)*B/W)`` of a global batch of ``B``, as ``batch_specs``
  shards them.
"""
from __future__ import annotations

from typing import Any, Tuple

from repro_torch.dist.compat import Group

ROW_SHARDED = ("w", "acc", "counts")   # EmbeddingState leaves split by rows


def row_sharded_leaf(path: str) -> bool:
    """Whether the flattened state path (``emb/<gid>/w``, the checkpoint's
    leaf names) names a row-sharded leaf; every other leaf is replicated."""
    parts = path.split("/")
    return len(parts) == 3 and parts[0] == "emb" and parts[2] in ROW_SHARDED


def row_range(rows: int, group: Group) -> Tuple[int, int]:
    """Rank ``group.rank``'s rows ``[lo, hi)`` of a table of ``rows``."""
    if rows % group.world:
        raise ValueError(f"{rows} rows do not split over {group.world} ranks")
    rps = rows // group.world
    return group.rank * rps, (group.rank + 1) * rps


def shard_emb_state(st: Any, group: Group) -> Any:
    """A full (world-1 layout) ``EmbeddingState`` -> this rank's: copies of
    its rows of ``w``/``acc``/``counts``, the tiers and projection as they
    are (replicated)."""
    if group.world == 1:
        return st
    lo, hi = row_range(st.w.shape[0], group)
    return st._replace(**{k: getattr(st, k)[lo:hi].clone() for k in ROW_SHARDED})


def batch_slice(batch: Any, group: Group) -> Any:
    """Rank ``group.rank``'s samples of a global host batch: every leaf's
    leading dimension sliced ``[r*B/W, (r+1)*B/W)``."""
    if group.world == 1:
        return batch
    if isinstance(batch, dict):
        return {k: batch_slice(v, group) for k, v in batch.items()}
    b = batch.shape[0]
    if b % group.world:
        raise ValueError(f"batch of {b} does not split over {group.world} ranks")
    per = b // group.world
    return batch[group.rank * per:(group.rank + 1) * per]
