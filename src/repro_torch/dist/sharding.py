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

A change of world moves a row-sharded leaf from one cut to the other
(``recut_rows``): the row blocks go from the ranks that held them to the
ranks that hold them next, the reference's ``jax.device_put`` onto a
submesh done as messages between processes.
"""
from __future__ import annotations

import math
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.dist.compat import Group, recv_rows, send_rows

ROW_SHARDED = ("w", "acc", "counts")   # EmbeddingState leaves split by rows
CHUNK_BYTES = 256 << 20  # bytes a rank moves at a time in recut_rows, as a checkpoint does


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


def recut_plan(rows_old: int, world_old: int, rows_new: int, world_new: int,
               row_bytes: int) -> List[Tuple[int, int, int, int]]:
    """The moves of a world change, ``(p, q, a, b)``: table rows ``[a, b)``
    that rank ``p`` of the old cut holds and rank ``q`` of the new cut
    needs, below both tables' rows (the rest is padding), in chunks of at
    most ``CHUNK_BYTES``, in one order every rank computes alike."""
    ro, rn = rows_old // world_old, rows_new // world_new
    top = min(rows_old, rows_new)
    step = max(1, CHUNK_BYTES // max(1, row_bytes))
    out = []
    for p in range(world_old):
        for q in range(world_new):
            lo, hi = max(p * ro, q * rn), min((p + 1) * ro, (q + 1) * rn, top)
            if p == q:  # a rank's own rows: one local copy
                if hi > lo:
                    out.append((p, q, lo, hi))
                continue
            out += [(p, q, a, min(hi, a + step)) for a in range(lo, hi, step)]
    return out


def recut_rows(x: Optional[torch.Tensor], out: Optional[torch.Tensor], rows_old: int,
               world_old: int, rows_new: int, world_new: int, root: Group,
               tag: int = 0) -> None:
    """Move one row-sharded leaf from the cut of ``world_old`` to that of
    ``world_new`` over ``root`` (whose first ranks both worlds are): rank
    ``p < world_old`` holds ``x``, rows ``[p*ro, (p+1)*ro)`` of a table of
    ``rows_old``; rank ``q < world_new`` fills ``out``, rows ``[q*rn,
    (q+1)*rn)`` of ``rows_new``, in place (its rows past ``min(rows_old,
    rows_new)`` stay as they are: the caller's zeros). A rank's own rows
    are one local copy; every other move is one blocking send and receive
    of at most ``CHUNK_BYTES`` on the root's ``ckpt_pg``, each rank taking
    its moves in ``recut_plan``'s order, so the first move not yet made
    always has both its ranks at it (no deadlock) and a rank holds one
    chunk in flight beside its old and new rows. A rank in neither world
    has nothing to do."""
    me = root.rank
    ref = x if x is not None else out
    if ref is None:
        return
    ro, rn = rows_old // world_old, rows_new // world_new
    row_bytes = math.prod(ref.shape[1:]) * ref.element_size()
    for p, q, a, b in recut_plan(rows_old, world_old, rows_new, world_new, row_bytes):
        if me == p == q:
            out[a - q * rn:b - q * rn].copy_(x[a - p * ro:b - p * ro])
        elif me == p:
            send_rows(x[a - p * ro:b - p * ro], q, root, tag)
        elif me == q:
            recv_rows(out[a - q * rn:b - q * rn], p, root, tag)
