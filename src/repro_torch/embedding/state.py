"""Per-group embedding state (table + adagrad acc + FCounter + cache tiers +
the narrow projection), ``repro.embedding.state`` in torch.

The state is built directly on the target device from a ``torch.Generator``
on that device: full-width deepfm's table is 187,780,711 x 10 float32
(7.5 GB) and is never staged through the host. A ``JaxKey`` in its place
draws the reference's numbers on the host (``core.jax_random``; small
tables). ``l2`` is the optional
second cache tier behind the hot tier (``None`` when the plan budgets no L2
rows); ``proj`` is set exactly when the master is narrow (``picasso_narrow``
with ``narrow_dim < dim``).

``--pin-l2`` places the cold side in pinned host memory, which the kernels
read and write over the bus (``kernels.host_memory``; ``kernels.ops``):
``pinned_leaves(plan)`` names every L2 tier leaf and the ``w``/``acc`` of
every group whose planned width is narrowed, the counterpart of the
reference's ``emb_shardings(plan, mesh, axes, pin_l2=True)``, and
``pin_to_host`` places exactly those (the train launcher, once, after
init; ``migrate_state`` keeps the placement across a replan, the replanner
pins what a new plan names for the first time, and the train step only
checks it with ``check_pinned``); ``pin_l2_to_host`` places the L2 leaves
alone, as the
reference's function of that name does for its serve launcher. Where torch
has no CUDA both return the state unchanged, as the reference's do on a
backend without a ``pinned_host`` memory kind; the math is the same either
way.

Past world 1 (one process per rank, ``dist.Group``) ``init_embedding_state``
gives rank ``r`` exactly rows ``[r*rps, (r+1)*rps)`` of the master,
accumulator and FCounter that the same ``rng`` draws for the whole table,
and the tiers and projection whole (``dist.sharding``). A ``JaxKey`` draws
only the rank's rows. A generator's numbers are not addressable by row, so
each rank draws every table whole and keeps its rows; on a card the ranks
share, they take turns, so at most one whole table is transient at a time.
A generator draws the live rows (the group's vocabularies) and leaves the
padding rows past them, which no packed id reaches, at zero: at world 1
there are none, and at any world the draws, and so the dense parameters
drawn after them, are the world-1 run's.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.jax_random import JaxKey, Rng, rng_normal, rng_split
from repro_torch.core.packed_embedding import CacheState, ProjState, init_cache
from repro_torch.core.packing import PackedGroup, PicassoPlan
from repro_torch.dist.compat import (WORLD1, Group, all_gather_tiled, barrier, psum,
                                     resolve_group)


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


def _draw_rank_rows(rng: Rng, group: PackedGroup, width: int, rows: Tuple[int, int],
                    device: torch.device, dtype, ranks: Group) -> torch.Tensor:
    """Rows ``[lo, hi)`` of the group's master draw (module docstring). A
    generator on a card the ranks share draws its table one rank at a time
    (a barrier between turns), and the cache returns the table's memory
    before the next turn."""
    if isinstance(rng, JaxKey):
        return rng_normal(rng, (group.rows, width), device, dtype, rows=rows)
    live = sum(t.vocab for t in group.tables)
    lo, hi = rows
    shared_card = device.type == "cuda"
    out = None
    for turn in range(ranks.world):
        if turn == ranks.rank:
            mine = rng_normal(rng, (live, width), device, dtype, rows=(min(lo, live),
                                                                         min(hi, live)))
            pad = torch.zeros((hi - lo - mine.shape[0], width), dtype=dtype, device=device)
            out = torch.cat([mine, pad]) if pad.shape[0] else mine
            if shared_card:
                torch.cuda.synchronize(device)
                torch.cuda.empty_cache()
        if shared_card:
            barrier(ranks)
    return out


def init_group_state(rng: Rng, group: PackedGroup, hot_rows: int,
                     device: torch.device, dtype=torch.float32, l2_rows: int = 0,
                     narrow_dim: Optional[int] = None, ranks: Group = WORLD1
                     ) -> EmbeddingState:
    """``narrow_dim`` below the group's dim makes the MASTER narrow (cold ids
    live at width ``d``, scaled ``1/sqrt(d)``, and are projected up at
    lookup); the tiers stay at the full width. ``ranks`` (a ``dist.Group``)
    keeps this rank's rows of the master, accumulator and FCounter."""
    nd = group.dim if narrow_dim is None else int(narrow_dim)
    narrow = 0 < nd < group.dim
    width = nd if narrow else group.dim
    rps = group.rows // ranks.world
    lo = ranks.rank * rps
    if ranks.world == 1:
        w = rng_normal(rng, (group.rows, width), device, dtype)
    else:
        w = _draw_rank_rows(rng, group, width, (lo, lo + rps), device, dtype, ranks)
    w.mul_(float(np.float32(1) / np.sqrt(np.float32(max(width, 1)))))
    return EmbeddingState(
        w=w,
        acc=torch.zeros((rps, 1), dtype=dtype, device=device),
        counts=torch.zeros((rps,), dtype=torch.int32, device=device),
        cache=init_cache(hot_rows, group.dim, group.rows, dtype, device=device),
        l2=(init_cache(l2_rows, group.dim, group.rows, dtype, device=device)
            if l2_rows > 0 else None),
        proj=init_proj(group.gid, width, group.dim, device, dtype) if narrow else None,
    )


def init_embedding_state(rng: Rng, plan: PicassoPlan,
                         device: torch.device, dtype=torch.float32,
                         group: Optional[Group] = None) -> Dict[int, EmbeddingState]:
    """Per-group state sized by the plan: hot tier ``cache_rows``, L2 tier
    ``l2_rows``, master width ``narrow_width`` (narrow only where the plan
    records a ``'picasso_narrow'`` assignment). Past world 1 ``group`` is
    this rank's ``dist.Group`` and the masters hold its rows (module
    docstring)."""
    ranks = resolve_group(plan.world, group)
    keys = rng_split(rng, len(plan.groups))
    return {g.gid: init_group_state(keys[i], g, plan.cache_rows.get(g.gid, 0), device,
                                    dtype, l2_rows=plan.l2_rows.get(g.gid, 0),
                                    narrow_dim=plan.narrow_width(g.gid), ranks=ranks)
            for i, g in enumerate(plan.groups)}


# ---------------------------------------------------------------------------
# --pin-l2: the cold side in pinned host memory
# ---------------------------------------------------------------------------


def pinned_leaves(plan: PicassoPlan) -> Dict[str, Tuple[str, ...]]:
    """``{gid: leaf names}`` that ``--pin-l2`` places in pinned host memory:
    ``l2.keys``/``l2.rows``/``l2.acc`` where the plan budgets L2 rows, and
    ``w``/``acc`` where its width for the group is narrowed. The reference's
    ``emb_shardings(pin_l2=True)`` gives exactly these leaves the
    ``pinned_host`` memory kind."""
    out: Dict[str, Tuple[str, ...]] = {}
    for g in plan.groups:
        names = []
        if plan.narrow_width(g.gid) < g.dim:
            names += ["w", "acc"]
        if plan.l2_rows.get(g.gid, 0) > 0:
            names += ["l2.keys", "l2.rows", "l2.acc"]
        if names:
            out[str(g.gid)] = tuple(names)
    return out


def l2_pinning_supported() -> bool:
    """True where pinned host memory the card maps exists: torch with CUDA
    and a card (the precondition for the pinning functions to do anything)."""
    return bool(torch.cuda.is_available())


_PIN_L2_WARNED = False


def warn_pin_l2_limits() -> None:
    """One-time ``--pin-l2`` caveat, printed by both launchers where the
    flag cannot take effect (the reference's text)."""
    global _PIN_L2_WARNED
    if _PIN_L2_WARNED:
        return
    _PIN_L2_WARNED = True
    if not l2_pinning_supported():
        print("[pin-l2] warning: this backend exposes no 'pinned_host' "
              "memory kind — --pin-l2 is a no-op here (see the --pin-l2 "
              "row in README.md for the flag's documented limits)")


# the leaves --pin-l2 can place: the master's, then the L2 tier's
_PINNABLE = ("w", "acc", "l2.keys", "l2.rows", "l2.acc")


def _leaf(st: EmbeddingState, name: str) -> Optional[torch.Tensor]:
    if name.startswith("l2."):
        return None if st.l2 is None else getattr(st.l2, name[3:])
    return getattr(st, name)


def _with_leaves(st: EmbeddingState, leaves: Dict[str, torch.Tensor]) -> EmbeddingState:
    l2 = {k[3:]: v for k, v in leaves.items() if k.startswith("l2.")}
    top = {k: v for k, v in leaves.items() if not k.startswith("l2.")}
    if l2:
        top["l2"] = st.l2._replace(**l2)
    return st._replace(**top)


def _host_resident(t: torch.Tensor, st: EmbeddingState) -> bool:
    """True for a leaf of ``st`` that lives off the state's compute device
    (``counts`` never leaves it): a pinned host leaf under ``--pin-l2``."""
    return t.device != st.counts.device


def _place(st: EmbeddingState, names: Sequence[str],
           reuse: Optional[EmbeddingState] = None) -> EmbeddingState:
    """``st`` with the named leaves in mapped pinned host memory. A leaf
    already there stays; another is copied into ``reuse``'s pinned leaf of
    the same name, shape and dtype where there is one, else into a new
    exact-size buffer."""
    from repro_torch.kernels import host_memory

    moved: Dict[str, torch.Tensor] = {}
    for name in names:
        t = _leaf(st, name)
        if t is None or host_memory.is_mapped(t):
            continue
        old = None if reuse is None else _leaf(reuse, name)
        if (old is not None and host_memory.is_mapped(old) and old.shape == t.shape
                and old.dtype == t.dtype):
            old.copy_(t)
            moved[name] = old
        else:
            moved[name] = host_memory.pinned_like(t)
    return _with_leaves(st, moved) if moved else st


def _map_emb(state: Any, fn) -> Any:
    if isinstance(state, dict) and "emb" in state:
        return {**state, "emb": _map_emb(state["emb"], fn)}
    return {gid: fn(gid, st) for gid, st in state.items()}


def pin_to_host(state: Any, plan: PicassoPlan) -> Any:
    """Place the leaves ``pinned_leaves(plan)`` names in mapped pinned host
    memory (a no-op for a leaf already there, and for the whole state where
    ``l2_pinning_supported`` is False). Takes the full state (``{"emb":
    ...}``) or the bare per-group emb dict and returns the same structure;
    the device copies are dropped from it."""
    if not l2_pinning_supported():
        return state
    names = pinned_leaves(plan)
    return _map_emb(state, lambda gid, st: _place(st, names.get(str(gid), ())))


def check_pinned(state: Any, plan: PicassoPlan) -> None:
    """Raise unless every leaf ``pinned_leaves(plan)`` names lies in mapped
    pinned host memory (nothing to check where ``l2_pinning_supported`` is
    False). The train step's guard under ``--pin-l2``: the placement is made
    once (``pin_to_host``) and kept in place by the flushes, the journal,
    ``migrate_state`` and checkpoint restore, so a leaf found elsewhere is a
    path that lost it, never silently re-pinned."""
    if not l2_pinning_supported():
        return
    from repro_torch.kernels import host_memory

    emb = state["emb"] if isinstance(state, dict) and "emb" in state else state
    lost = [f"g{gid}.{name} on {t.device}"
            for gid, names in pinned_leaves(plan).items() for name in names
            if (t := _leaf(emb[gid], name)) is not None and not host_memory.is_mapped(t)]
    if lost:
        raise RuntimeError(f"--pin-l2: leaves the plan pins are not in mapped pinned host "
                           f"memory: {', '.join(lost)} (place the state once with "
                           "embedding.state.pin_to_host)")


def pin_l2_to_host(state: Any) -> Any:
    """Place every L2 tier leaf in mapped pinned host memory (the
    reference's ``pin_l2_to_host``; its serve launcher's placement). A
    no-op where ``l2_pinning_supported`` is False."""
    if not l2_pinning_supported():
        return state
    return _map_emb(state, lambda gid, st: _place(st, _PINNABLE[2:]))


def _staged(st: EmbeddingState) -> EmbeddingState:
    """``st`` with every host-resident leaf copied to its compute device."""
    dev = st.counts.device
    leaves = {name: t.to(dev) for name in _PINNABLE
              if (t := _leaf(st, name)) is not None and _host_resident(t, st)}
    return _with_leaves(st, leaves) if leaves else st


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


# ---------------------------------------------------------------------------
# plan-revision state migration (the replanning loop, runtime.replanner)
# ---------------------------------------------------------------------------
#
# The reference migrates on host copies in numpy. The port migrates on the
# state's own device and in place where it can: the master ``w``/``acc`` of
# a migrated group take the tiers' write-back in place, so a full-width
# migration never copies the 7.5 GB table to the host. The old state's
# tensors are reused; use only the returned state afterwards.
#
# Past world 1 each rank migrates its cut of the master, rows ``[base, base
# + rps)``, with the flush's collectives (``core.packed_embedding``): it
# writes back the tier rows it owns, the ranking gathers every rank's
# candidates, and a new replicated tier is the psum of its owners' rows
# (exact: one owner adds its row to zeros). At world 1 every collective is
# the identity and the cut is the whole table.


def _np_write_back(w: torch.Tensor, acc: torch.Tensor, tier: CacheState,
                   pinv: Optional[torch.Tensor] = None, base: int = 0) -> None:
    """Owner write-back of a tier into this rank's master rows (``base``
    its first row), in place: authoritative tier rows (narrowed through
    ``pinv`` for a narrow master, one product over the whole tier) and
    adagrad slots land on their row ids; sentinel keys (empty slots) and
    other ranks' rows are skipped."""
    local = tier.keys.to(torch.int64) - base
    mine = (local >= 0) & (local < w.shape[0])
    rows = tier.rows if pinv is None else tier.rows.to(torch.float32) @ pinv
    w[local[mine]] = rows[mine].to(w.dtype)
    acc[local[mine]] = tier.acc[mine].to(acc.dtype)


def _rank_tier_keys(counts: torch.Tensor, h1: int, h2: int, rows_padded: int,
                    group: Group = WORLD1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-(h1+h2) row ids by measured frequency, split hottest-h1 / next-h2,
    each sorted; ties go to the lower row id (the flush's stable descending
    order, ``packed_embedding._top_k_stable``), and rows counted 0 take the
    sentinel instead. ``counts`` is this rank's cut: as the flush's
    ``_rank_tiers`` each rank keeps its top rows and a second stable top-k
    over the all_gathered candidates (rank-major, so a tie still goes to
    the lower row id) ranks them, but every rank keeps ``h1+h2`` candidates,
    so the keys are the whole table's ranking at any world."""
    from repro_torch.core.packed_embedding import _top_k_stable

    h = h1 + h2
    c = counts.reshape(-1).to(torch.int64)
    vals, order = _top_k_stable(c, min(h, c.shape[0]))
    if group.world > 1:
        gids = all_gather_tiled(order + group.rank * c.shape[0], group)
        vals, pick = _top_k_stable(all_gather_tiled(vals, group), min(h, gids.shape[0]))
        order = gids[pick]
    ranked = torch.where(vals > 0, order, torch.full_like(order, rows_padded))
    if ranked.shape[0] < h:  # a tier larger than the table (degenerate)
        ranked = torch.cat([ranked, torch.full((h - ranked.shape[0],), rows_padded,
                                               dtype=ranked.dtype, device=ranked.device)])
    keys1 = torch.sort(ranked[:h1]).values.to(torch.int32)
    keys2 = torch.sort(ranked[h1:]).values.to(torch.int32)
    return keys1, keys2


def _np_proj_pinv(kernel: torch.Tensor, ridge: float = 1e-6) -> torch.Tensor:
    """The reference's float64 pseudo-inverse ``P^T (P P^T + ridge I)^{-1}``
    of a ``[d, D]`` projection (``[D, d]``, float32), for migrations that
    narrow wide rows."""
    k = kernel.to(torch.float64)
    eye = torch.eye(k.shape[0], dtype=torch.float64, device=k.device)
    return (k.T @ torch.linalg.solve(k @ k.T + ridge * eye, eye)).to(torch.float32)


def _exact_rows(keys: torch.Tensor, old_tiers, rows_padded: int):
    """For each key, the row of the last old tier holding it: ``(found,
    rows)``; ``found`` is False where no old tier holds the key."""
    found = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    rows = None
    for tier in old_tiers:
        if tier.keys.shape[0] == 0:
            continue
        p = torch.clamp(torch.searchsorted(tier.keys, keys), 0, tier.keys.shape[0] - 1)
        hit = (tier.keys[p] == keys) & (keys < rows_padded)
        cand = tier.rows[p]
        rows = cand if rows is None else torch.where(hit[:, None], cand, rows)
        found = found | hit
    return found, rows


def _migrate_group(group: PackedGroup, st: EmbeddingState,
                   gates_old: Tuple[bool, bool], gates_new: Tuple[bool, bool],
                   h1_new: int, h2_new: int, cache_update: str,
                   nd_old: int, nd_new: int, ranks: Group = WORLD1) -> EmbeddingState:
    """Move one group's live state onto new tier budgets and gating, on the
    state's device (the reference's ``_migrate_group`` step for step);
    ``st`` holds the rows of rank ``ranks.rank`` (all of them at world 1):

    1. in ``'psum'`` mode the active tiers are authoritative for their rows:
       each rank writes back the rows it owns, in place (through the
       projection's pseudo-inverse for a narrow master);
    2. re-rank tier residency from the FCounter: the hottest ``h1_new`` rows
       seed L1, the next ``h2_new`` L2, loaded from the just-synced master
       at full width as the psum of the owners' rows (ids the old tiers
       held keep their exact wide rows in ``'psum'`` mode; other narrow rows
       are widened through the projection);
    3. a width change re-masters each rank's own rows (``w @ P`` to widen,
       a fresh deterministic projection's pseudo-inverse to narrow; the
       projection is replicated, so this is local); an unchanged narrow
       width keeps the learned projection and the master bitwise;
    4. adagrad slots and FCounter mass are preserved exactly.
    """
    cache_on_old, l2_on_old = gates_old
    cache_on_new, l2_on_new = gates_new
    dim = group.dim
    w, acc, counts = st.w, st.acc, st.counts
    dtype, dev = w.dtype, w.device
    rows_padded = group.rows
    rps = w.shape[0]
    base = ranks.rank * rps  # this rank's first row
    psum_mode = cache_update == "psum"

    narrow_old = st.proj is not None and w.shape[1] < dim
    proj_old = st.proj.kernel.to(torch.float32) if narrow_old else None

    old_tiers = []
    if cache_on_old:
        old_tiers.append(st.cache)
    if l2_on_old and st.l2 is not None:
        old_tiers.append(st.l2)
    if psum_mode:
        pinv_old = _np_proj_pinv(proj_old) if narrow_old else None
        for tier in old_tiers:
            _np_write_back(w, acc, tier, pinv_old, base)

    def widen(rows: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
        """Full-width rows of the synced master (the reference's
        ``w_wide``): ``rows`` are the master's rows at ``keys`` (global
        ids), widened through the projection for a narrow master."""
        if not narrow_old:
            return rows
        rows = (rows.to(torch.float32) @ proj_old).to(dtype)
        if psum_mode and old_tiers:
            found, exact = _exact_rows(keys, old_tiers, rows_padded)
            if exact is not None:
                rows = torch.where(found[:, None], exact.to(dtype), rows)
        return rows

    def load(keys: torch.Tensor) -> CacheState:
        """A fresh replicated tier holding ``keys``: the owners' rows and
        adagrad slots, psum'd at the master's width and then widened;
        sentinel slots stay exactly zero."""
        local = keys.to(torch.int64) - base
        own = ((local >= 0) & (local < rps))[:, None]
        idx = torch.clamp(local, 0, rps - 1)
        rows = psum(w[idx] * own.to(dtype), ranks)
        slots = psum(acc[idx] * own.to(acc.dtype), ranks)
        mine = (keys < rows_padded)[:, None]
        zero = torch.zeros((), dtype=dtype, device=dev)
        return CacheState(keys=keys, rows=torch.where(mine, widen(rows, keys), zero),
                          acc=torch.where(mine, slots.to(dtype), zero))

    def remaster(fn, width: int) -> torch.Tensor:
        """A new ``[rps, width]`` master cut, ``fn`` of this rank's wide
        rows, built in row chunks so no full-width temporary of the table
        exists."""
        out = torch.empty((rps, width), dtype=dtype, device=dev)
        step = max(1, (64 << 20) // (4 * max(dim, 1)))
        for r0 in range(0, rps, step):
            idx = torch.arange(r0, min(rps, r0 + step), device=dev)
            out[r0:r0 + idx.shape[0]] = fn(widen(w[idx], (idx + base).to(torch.int32))
                                           ).to(dtype)
        return out

    proj: Optional[ProjState] = None
    if 0 < nd_new < dim:
        if narrow_old and nd_new == nd_old:
            w_new = w  # exact narrow pass-through; the learned projection survives
            proj = ProjState(kernel=st.proj.kernel, acc=st.proj.acc)
        else:  # a widening round trip or a first narrowing: fresh projection
            kern = torch.as_tensor(_np_proj_kernel(group.gid, nd_new, dim)).to(dev)
            pinv = _np_proj_pinv(kern)
            w_new = remaster(lambda r: r.to(torch.float32) @ pinv, nd_new)
            proj = ProjState(kernel=kern.to(dtype),
                             acc=torch.zeros((nd_new, 1), dtype=dtype, device=dev))
    elif narrow_old:
        w_new = remaster(lambda r: r, dim)  # re-widened
    else:
        w_new = w  # never narrow

    keys1, keys2 = _rank_tier_keys(counts, h1_new if cache_on_new else 0,
                                   h2_new if l2_on_new else 0, rows_padded, ranks)
    if cache_on_new:
        cache = load(keys1)
    else:  # allocated (the plan budgets rows) but inert under the new strategy
        cache = init_cache(h1_new, dim, rows_padded, dtype, device=dev)
    l2: Optional[CacheState] = None
    if h2_new > 0:
        l2 = (load(keys2) if l2_on_new
              else init_cache(h2_new, dim, rows_padded, dtype, device=dev))
    return EmbeddingState(w=w_new, acc=acc, counts=counts, cache=cache, l2=l2, proj=proj)


# ---------------------------------------------------------------------------
# world-size recut (the elastic reshard, runtime.elastic)
# ---------------------------------------------------------------------------


def _recut_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """``t`` with ``rows`` leading rows: its first rows (a view) when it
    shrinks, zero-extended when it grows; a leaf in mapped pinned host
    memory stays there."""
    if rows <= t.shape[0]:
        return t[:rows]
    from repro_torch.kernels import host_memory

    shape = (rows,) + tuple(t.shape[1:])
    if host_memory.is_mapped(t):
        out = host_memory.pinned_empty(shape, t.dtype)
        out.zero_()
    else:
        out = torch.zeros(shape, dtype=t.dtype, device=t.device)
    out[:t.shape[0]] = t
    return out


def remap_sentinels(tier: Optional[CacheState], cut: int, rows: int) -> Optional[CacheState]:
    """``tier`` with every key ``>= cut`` set to ``rows``, the sentinel of a
    table padded to ``rows`` (the keys a new tensor, rows and slots as they
    are)."""
    if tier is None:
        return None
    keys = torch.where(tier.keys >= cut, torch.full_like(tier.keys, rows), tier.keys)
    return tier._replace(keys=keys)


def _reshard_group_state(group: PackedGroup, st: EmbeddingState) -> EmbeddingState:
    """Recut one group's world-1 layout state for a new padded row count, on
    the state's device (the reference's ``_reshard_group_state``, which
    does it in numpy on the host).

    A world-size change re-pads the packed table (``rows = _pad_to(logical,
    world)``) without touching the logical rows, so the recut is a pure
    permutation plus padding surgery:

    - the master ``w``, ``acc`` and the FCounter are zero-extended or
      truncated, only ever in padding rows, which no packed id reaches; a
      nonzero FCounter in the truncated tail would drop a real row, so it
      raises ``ValueError``;
    - every tier key ``>= min(r_old, r_new)`` is a sentinel (residents are
      logical rows, below both paddings), so each moves to the new sentinel
      ``r_new``; resident keys, rows and Adagrad slots carry bitwise;
    - the projection of a narrow master does not depend on the rows and
      carries bitwise.
    """
    r_old, r_new = int(st.w.shape[0]), int(group.rows)
    if r_new < r_old and bool(st.counts[r_new:].ne(0).any()):
        raise ValueError(f"g{group.gid}: resharding {r_old} -> {r_new} rows would drop "
                         "rows with nonzero FCounter mass: the truncated tail must be "
                         "pure padding")
    cut = min(r_old, r_new)
    return st._replace(w=_recut_rows(st.w, r_new), acc=_recut_rows(st.acc, r_new),
                       counts=_recut_rows(st.counts, r_new),
                       cache=remap_sentinels(st.cache, cut, r_new),
                       l2=remap_sentinels(st.l2, cut, r_new))


def reshard_state(new_plan: PicassoPlan, state: Any) -> Any:
    """Recut a world-1 layout state onto ``new_plan``'s padded row counts:
    the state-side half of ``core.packing.reshard_plan``. Per group, pad or
    truncate the padding rows and remap the tier sentinels
    (``_reshard_group_state``); a group whose rows already match passes
    through untouched. Takes the full train/serve state (``{"emb": ...}``)
    or the bare per-group emb dict and returns the same structure, its
    tensors on their devices (the reference returns host arrays and places
    them after). Past world 1 each rank holds a cut of the rows, and
    ``runtime.elastic.reshard_live`` moves them."""
    if isinstance(state, dict) and "emb" in state:
        return {**state, "emb": reshard_state(new_plan, state["emb"])}
    out = {}
    for g in new_plan.groups:
        key = str(g.gid) if str(g.gid) in state else g.gid
        st = state[key]
        out[key] = st if int(st.w.shape[0]) == g.rows else _reshard_group_state(g, st)
    return out


def migrate_state(old_plan: PicassoPlan, new_plan: PicassoPlan, state: Any, *,
                  use_cache: bool = True, use_l2: bool = True,
                  cache_update: str = "psum", group: Optional[Group] = None) -> Any:
    """Carry live embedding state from ``old_plan`` to ``new_plan``, two
    revisions of one structural plan (same gids and dims; what may differ is
    ``cache_rows``/``l2_rows``, the strategy assignment, the narrow widths
    and, across a world resize (``reshard_plan``), the padded rows).

    A change of rows is recut first (``_reshard_group_state``: padding and
    sentinels, exact for every logical row), as the reference's is. A group
    with identical tier shapes, gating and width then passes through (the
    same tensors where the rows did not change: a replan that recompiles
    to the same plan is a no-op); the others migrate on their device
    (``_migrate_group``), their master taking the tiers' write-back in
    place. Without ``group`` the state is the world-1 layout (every row in
    this process); past world 1 ``group`` is this rank's ``dist.Group``,
    the state holds its cut of each master, and every rank of the group
    calls this together (the plans' rows must then match: a change of world
    moves rows between ranks, ``runtime.elastic.reshard_live``). Each rank's
    cut is then the same rows of the world-1 migration of the same state.
    ``use_cache``/``use_l2``/``cache_update`` must mirror the engine flags
    the state was trained under. Takes the full train/serve state (``{"emb": ...}``) or the bare
    per-group emb dict and returns the same structure.

    A state with host-resident leaves (``--pin-l2``) keeps that placement: a
    migrating group is staged whole onto its compute device (its narrow
    master included), migrated there as any other, and its result placed
    back by ``pinned_leaves(new_plan)``, into the old pinned buffers where
    the shapes stayed.
    """
    if isinstance(state, dict) and "emb" in state:
        return {**state, "emb": migrate_state(old_plan, new_plan, state["emb"],
                                              use_cache=use_cache, use_l2=use_l2,
                                              cache_update=cache_update, group=group)}
    old_gids = sorted(g.gid for g in old_plan.groups)
    new_gids = sorted(g.gid for g in new_plan.groups)
    if old_gids != new_gids:
        raise ValueError(f"migrate_state needs revisions of one structural plan; group "
                         f"sets differ: {old_gids} vs {new_gids}")
    ranks = WORLD1 if group is None else group
    pinned = any(_host_resident(t, st) for st in state.values() for name in _PINNABLE
                 if (t := _leaf(st, name)) is not None)
    names = pinned_leaves(new_plan) if pinned else {}
    out: Dict[str, EmbeddingState] = {}
    for g in new_plan.groups:
        og = old_plan.group(g.gid)
        if og.dim != g.dim:
            raise ValueError(f"g{g.gid}: packed dim changed across revisions "
                             f"({og.rows}x{og.dim} -> {g.rows}x{g.dim}); only tier "
                             "budgets, strategy, and world padding may change")
        h_old = (old_plan.cache_rows.get(g.gid, 0), old_plan.l2_rows.get(g.gid, 0))
        h_new = (new_plan.cache_rows.get(g.gid, 0), new_plan.l2_rows.get(g.gid, 0))
        gates_old = tier_gates(old_plan, g.gid, use_cache=use_cache, use_l2=use_l2)
        gates_new = tier_gates(new_plan, g.gid, use_cache=use_cache, use_l2=use_l2)
        nd_old, nd_new = old_plan.narrow_width(g.gid), new_plan.narrow_width(g.gid)
        st = state[str(g.gid)]
        if og.rows != g.rows:  # a world resize: recut padding and sentinels first
            if ranks.world > 1:
                raise ValueError(f"g{g.gid}: rows {og.rows} -> {g.rows} across revisions "
                                 f"at world {ranks.world}: a change of world moves rows "
                                 "between ranks (runtime.elastic.reshard_live)")
            st = _reshard_group_state(g, st)
        if h_old == h_new and gates_old == gates_new and nd_old == nd_new:
            out[str(g.gid)] = st  # pass-through
        else:
            new = _migrate_group(g, _staged(st), gates_old, gates_new, h_new[0],
                                 h_new[1], cache_update, nd_old, nd_new, ranks)
            out[str(g.gid)] = _place(new, names.get(str(g.gid), ()), reuse=st)
    return out
