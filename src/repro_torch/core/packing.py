"""PICASSO Packing (paper §III-B): a numpy-only copy of ``make_plan`` and
the planners it calls from ``repro.core.packing``.

D-Packing: feature fields whose embedding tables share a dimension are packed
into one table / one lookup op. Groups whose estimated parameter volume
(``CalcVParam``, Eq. 1) exceeds the group mean are split into shards for load
balance, exactly as the paper prescribes ("for embedding tables with a
dimension of 32, create four shards, each with a quarter of these tables").

This module is pure planning (numpy / python): it maps a WDLConfig + optional
warm-up frequency statistics to a ``PicassoPlan`` the engine executes, and
``revise_plan`` recompiles a plan's tier budgets from measured statistics
(the replanning loop, ``repro_torch.runtime.replanner``).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import FeatureField, WDLConfig


@dataclass(frozen=True)
class TableSpec:
    """One logical embedding table (fields may share via shared_table)."""

    name: str
    vocab: int
    dim: int
    ids_per_sample: int  # expected lookups/sample across all fields reading it


@dataclass(frozen=True)
class FieldSlot:
    """Where a field's bags land inside its packed group's output."""

    field: FeatureField
    table: str
    bag_offset: int  # first bag index within the group (per sample)
    n_bags: int      # 1 if pooled, max_len if pooling == 'none'


@dataclass(frozen=True)
class PackedGroup:
    """One packed lookup op (paper: 'packed embedding')."""

    gid: int
    dim: int
    tables: Tuple[TableSpec, ...]
    table_offsets: Dict[str, int]   # table name -> row offset in packed space
    rows: int                       # padded total rows (multiple of world size)
    slots: Tuple[FieldSlot, ...]
    vparam: float                   # CalcVParam estimate (Eq. 1)

    @property
    def n_bags(self) -> int:
        return sum(s.n_bags for s in self.slots)

    @property
    def ids_per_sample(self) -> int:
        return sum(s.field.max_len for s in self.slots)


@dataclass
class PicassoPlan:
    groups: List[PackedGroup]
    world: int                       # total model-parallel shards
    capacity: Dict[int, int]         # gid -> all_to_all bucket capacity (per peer)
    interleave: List[List[int]]      # K-interleave groups: lists of gids
    microbatch: int                  # D-interleave micro-batch (per device)
    cache_rows: Dict[int, int]       # gid -> hot-storage rows (0 = no cache)
    flush_iters: int = 100
    warmup_iters: int = 100
    # ---- plan revision ----------------------------------------------------
    # A plan is a *versioned* artifact, not a compile-once constant: the
    # runtime Replanner (repro.runtime) recompiles tier budgets and the
    # strategy assignment from measured FCounter skew and hands live state
    # across revisions (embedding.state.migrate_state). ``rev`` counts
    # revisions of one structural plan (groups / capacity / interleave /
    # microbatch never change across revisions — only cache_rows, l2_rows,
    # and strategy do); ``hot_bytes``/``l2_bytes`` record the byte budgets
    # the current tier split was computed from, so a re-budget without an
    # explicit override re-splits the same envelope by measured mass.
    rev: int = 0
    hot_bytes: int = 0
    l2_bytes: int = 0
    # gid -> L2 host-memory tier rows (0 = no L2). The L2 tier sits *behind*
    # the hot tier: it only ever participates for groups that also have a
    # cache_rows budget, and the flush keeps the two key sets disjoint
    # (top-H1 rows device-resident, next-H2 host-resident).
    l2_rows: Dict[int, int] = field(default_factory=dict)
    # gid -> LookupStrategy registry name. Empty = unassigned: engines built
    # with a single strategy name broadcast it; engines built with
    # 'mixed'/'auto' compile an assignment (repro.core.assign) and record
    # it here so later engines/flushes see the same mixing.
    strategy: Dict[int, str] = field(default_factory=dict)
    # gid -> narrow master width d for the frequency-adaptive hot/cold split
    # (picasso_narrow): cold ids live at width d in the sharded master and
    # are projected up to the model dim at lookup; hot ids stay full-width
    # in the tiers. Only *engaged* for groups whose recorded strategy is
    # 'picasso_narrow' (see ``narrow_width``) — the budget can be planned
    # ahead for every group and only bites where the assignment routes.
    narrow_dim: Dict[int, int] = field(default_factory=dict)
    # Device-mesh shape the plan was compiled for, e.g. (4, 2) for 8 shards
    # on a data=4 x model=2 mesh. Empty = unrecorded (pre-elastic plans and
    # host-only tests). ``plan_meta`` persists it into the checkpoint sidecar
    # so a restore at a different world size is *detected* and routed through
    # ``reshard_plan`` + ``embedding.state.reshard_state`` instead of
    # shape-erroring against stale templates.
    mesh_shape: Tuple[int, ...] = ()
    _by_gid: Dict[int, PackedGroup] = field(init=False, repr=False)

    def __post_init__(self):
        self._by_gid = {g.gid: g for g in self.groups}

    @property
    def n_interleave(self) -> int:
        return len(self.interleave)

    def narrow_width(self, gid: int) -> int:
        """Master-table width for one group: the planned narrow dim when the
        recorded strategy is 'picasso_narrow' and the planned dim actually
        narrows, else the full model dim. This is THE gating rule — state
        init, sharding specs, migration, and the engine all consult it, so
        a plan whose assignment routes a group elsewhere keeps it wide even
        if a narrow budget was planned."""
        dim = self.group(gid).dim
        nd = int(self.narrow_dim.get(gid, dim))
        if self.strategy.get(gid) == "picasso_narrow" and 0 < nd < dim:
            return nd
        return dim

    def group(self, gid: int) -> PackedGroup:
        """Resolve a group by its gid (NOT by list position: plans sliced or
        re-planned per tower may hold non-contiguous gids)."""
        try:
            return self._by_gid[gid]
        except KeyError:
            raise KeyError(
                f"no packed group with gid={gid}; plan has "
                f"{sorted(self._by_gid)}") from None


def build_tables(cfg: WDLConfig) -> Tuple[Dict[str, TableSpec], Dict[str, str]]:
    """Resolve fields -> logical tables (handling shared_table)."""
    ids_per: Dict[str, int] = {}
    owner_field: Dict[str, FeatureField] = {}
    field_table: Dict[str, str] = {}
    for f in cfg.fields:
        tname = f.shared_table or f.name
        field_table[f.name] = tname
        ids_per[tname] = ids_per.get(tname, 0) + f.max_len
        if not f.shared_table:
            owner_field[tname] = f
    tables = {}
    for tname, f in owner_field.items():
        tables[tname] = TableSpec(name=tname, vocab=f.vocab, dim=f.dim, ids_per_sample=ids_per[tname])
    # sanity: shared fields must match dim
    for f in cfg.fields:
        if f.shared_table and tables[f.shared_table].dim != f.dim:
            raise ValueError(f"field {f.name} shares table {f.shared_table} with mismatched dim")
    return tables, field_table


def calc_vparam(tables: Sequence[TableSpec], freq_share: Optional[Dict[str, float]] = None) -> float:
    """Eq. 1: N * sum_t (t_dim * sum_{ID in t} ID_freq).

    With warm-up stats, ``freq_share[t]`` is the measured fraction of lookups
    hitting table t; without stats we use the structural expectation
    ids_per_sample_t / N (uniform-over-configured-lookups prior).
    """
    n_total = sum(t.ids_per_sample for t in tables)
    v = 0.0
    for t in tables:
        share = freq_share.get(t.name, 0.0) if freq_share else t.ids_per_sample / max(n_total, 1)
        v += t.dim * share
    return n_total * v


def _pad_to(x: int, mult: int) -> int:
    return int(math.ceil(x / mult) * mult) if mult > 1 else x


def plan_packing(
    cfg: WDLConfig,
    world: int,
    freq_share: Optional[Dict[str, float]] = None,
    split_factor: float = 2.0,
    enable_packing: bool = True,
) -> List[PackedGroup]:
    """D-Packing: group tables by dim; split oversized groups (Eq. 1)."""
    tables, field_table = build_tables(cfg)

    # ---- initial grouping --------------------------------------------------
    if enable_packing:
        by_dim: Dict[int, List[TableSpec]] = {}
        for t in tables.values():
            by_dim.setdefault(t.dim, []).append(t)
        raw_groups = [sorted(ts, key=lambda t: -t.vocab) for _, ts in sorted(by_dim.items())]
    else:
        # no packing: one table per group (the paper's fragmented baseline)
        raw_groups = [[t] for t in sorted(tables.values(), key=lambda t: t.name)]

    # ---- CalcVParam splitting ---------------------------------------------
    if enable_packing and len(raw_groups) > 0:
        vparams = [calc_vparam(g, freq_share) for g in raw_groups]
        mean_v = float(np.mean(vparams)) if vparams else 0.0
        split: List[List[TableSpec]] = []
        for g, v in zip(raw_groups, vparams):
            n_shards = 1
            if mean_v > 0 and v > split_factor * mean_v and len(g) > 1:
                n_shards = min(len(g), int(math.ceil(v / mean_v)))
            if n_shards == 1:
                split.append(g)
            else:
                # greedy balance tables into shards by vparam contribution
                buckets: List[List[TableSpec]] = [[] for _ in range(n_shards)]
                loads = [0.0] * n_shards
                for t in sorted(g, key=lambda t: -(t.dim * t.ids_per_sample)):
                    j = int(np.argmin(loads))
                    buckets[j].append(t)
                    loads[j] += t.dim * t.ids_per_sample
                split.extend(b for b in buckets if b)
        raw_groups = split

    # ---- materialize PackedGroups ------------------------------------------
    groups: List[PackedGroup] = []
    for gid, ts in enumerate(raw_groups):
        table_set = {t.name for t in ts}
        offsets, off = {}, 0
        for t in ts:
            offsets[t.name] = off
            off += t.vocab
        rows = _pad_to(off, world)
        slots: List[FieldSlot] = []
        bag_off = 0
        for f in cfg.fields:
            if field_table[f.name] in table_set:
                nb = 1 if f.pooling != "none" else f.max_len
                slots.append(FieldSlot(field=f, table=field_table[f.name], bag_offset=bag_off, n_bags=nb))
                bag_off += nb
        groups.append(
            PackedGroup(
                gid=gid,
                dim=ts[0].dim,
                tables=tuple(ts),
                table_offsets=offsets,
                rows=rows,
                slots=tuple(slots),
                vparam=calc_vparam(ts, freq_share),
            )
        )
    return groups


def plan_capacity(
    group: PackedGroup,
    local_ids: int,
    world: int,
    slack: float = 2.0,
    cache_hit_ratio: float = 0.0,
    exact: bool = False,
) -> int:
    """All-to-all bucket capacity per peer shard.

    Expected uniques routed to each peer ~= local_ids*(1-hit)/world; ``slack``
    covers residual skew (the zipf head is absorbed by the cache + scramble).
    ``exact`` mode uses capacity = local_ids (provably lossless; tests).
    """
    if exact:
        return max(1, local_ids)
    per_peer = local_ids * max(0.0, 1.0 - cache_hit_ratio) / max(world, 1)
    cap = int(math.ceil(slack * max(per_peer, 1.0)))
    return max(4, _pad_to(cap, 4))


def plan_microbatch(
    per_device_batch: int,
    act_bytes_per_sample: float,
    mem_budget_bytes: float = 8 * 2**30,
    n_micro: Optional[int] = None,
) -> int:
    """Eq. 2: BS_micro = min_op(RBound_op / RInstance_op).

    The dominant bound for the dense stage is device memory for activations;
    RInstance is activation bytes/sample. Explicit ``n_micro`` overrides.
    """
    if n_micro is not None:
        return max(1, per_device_batch // max(1, n_micro))
    if act_bytes_per_sample <= 0:
        return per_device_batch
    bs = int(mem_budget_bytes / act_bytes_per_sample)
    bs = max(1, min(per_device_batch, bs))
    # round down to a divisor of per_device_batch for a static scan
    while per_device_batch % bs:
        bs -= 1
    return bs


def plan_interleave(groups: Sequence[PackedGroup], n_groups: Optional[int] = None,
                    capacity_vparam: Optional[float] = None) -> List[List[int]]:
    """Eq. 3: bound each K-interleave group's parameter volume by Capacity_g.

    Greedy balance of packed groups into interleave groups so that each stays
    under Capacity_g (when given) or so that ``n_groups`` groups are balanced.
    """
    if not groups:
        return []
    if n_groups is None:
        if capacity_vparam is None:
            capacity_vparam = max(g.vparam for g in groups)
        n_groups = max(1, int(math.ceil(sum(g.vparam for g in groups) / capacity_vparam)))
    n_groups = min(n_groups, len(groups))
    buckets: List[List[int]] = [[] for _ in range(n_groups)]
    loads = [0.0] * n_groups
    for g in sorted(groups, key=lambda g: -g.vparam):
        j = int(np.argmin(loads))
        buckets[j].append(g.gid)
        loads[j] += g.vparam
    return [sorted(b) for b in buckets if b]


def _budget_weights(groups: Sequence[PackedGroup],
                    stats: Optional[Dict[int, np.ndarray]] = None
                    ) -> Dict[int, float]:
    """Per-group tier-budget weight: measured traffic volume when FCounter
    ``stats`` are given (total lookups served x dim — the byte volume the
    tier can actually absorb), else the structural ``vparam`` prior.

    Falls back to vparam wholesale when stats are missing or empty for every
    group (a cold counter carries no signal), so a warm-start replan before
    any step behaves exactly like the compile-time split.
    """
    if stats:
        w = {g.gid: float(np.asarray(stats[g.gid], np.float64).sum()) * g.dim
             for g in groups if g.gid in stats}
        if len(w) == len(list(groups)) and sum(w.values()) > 0:
            return w
    return {g.gid: g.vparam for g in groups}


def plan_cache(
    groups: Sequence[PackedGroup],
    hot_bytes: int,
    world: int,
    dtype_bytes: int = 4,
    stats: Optional[Dict[int, np.ndarray]] = None,
) -> Dict[int, int]:
    """Split the hot-storage budget across packed groups ∝ vparam share —
    or, with measured FCounter ``stats``, ∝ measured lookup mass x dim
    (the runtime re-budget path: skew the tier toward the groups that are
    actually being queried, not the ones the structural prior expected).

    Returns rows per group, padded to a multiple of 8 (sublane) with a small
    floor so tiny-but-hot tables (e.g. vocab<=64 fields queried every sample)
    are always resident. A non-positive ``hot_bytes`` drops the tier outright
    (no floor): that is how a runtime re-budget turns the cache path off.
    """
    if hot_bytes <= 0:
        return {g.gid: 0 for g in groups}
    weights = _budget_weights(groups, stats)
    total_v = sum(weights.values()) or 1.0
    out: Dict[int, int] = {}
    for g in groups:
        budget = hot_bytes * (weights[g.gid] / total_v)
        rows = int(budget / ((g.dim + 1) * dtype_bytes))  # +1 for adagrad acc
        tiny = sum(t.vocab for t in g.tables if t.vocab <= 64)
        rows = max(rows, tiny, 8)
        # a cache above ~1/8 of the table (or 4M rows) has no marginal hits
        # (paper Tab. VI: hit ratio saturates) and bloats the flush top-k.
        rows = min(rows, g.rows, max(g.rows // 8, 8), 4_194_304)
        out[g.gid] = _pad_to(rows, 8)
    return out


def plan_l2(
    groups: Sequence[PackedGroup],
    l2_bytes: int,
    cache_rows: Dict[int, int],
    dtype_bytes: int = 4,
    stats: Optional[Dict[int, np.ndarray]] = None,
) -> Dict[int, int]:
    """Split the L2 host-memory budget across packed groups ∝ vparam share —
    or ∝ measured lookup mass x dim when FCounter ``stats`` are given (the
    same re-budget rule as ``plan_cache``, so one replan re-splits both
    tiers consistently).

    The L2 tier backs the hot tier with host (CPU/pinned) memory, so its
    budget is typically 10-100x ``hot_bytes``. Per group the tier is capped
    at the rows *not* already covered by the hot tier (the flush assigns the
    top-H1 rows to L1 and the next H2 to L2, so overlapping budget would be
    dead memory), and rounded down to the 8-row sublane multiple. Groups
    without a hot-tier budget get no L2: the tier sits strictly behind L1.
    """
    weights = _budget_weights(groups, stats)
    total_v = sum(weights.values()) or 1.0
    out: Dict[int, int] = {}
    for g in groups:
        h1 = cache_rows.get(g.gid, 0)
        if l2_bytes <= 0 or h1 <= 0:
            out[g.gid] = 0
            continue
        budget = l2_bytes * (weights[g.gid] / total_v)
        rows = int(budget / ((g.dim + 1) * dtype_bytes))  # +1 for adagrad acc
        rows = min(rows, max(g.rows - h1, 0))
        out[g.gid] = (rows // 8) * 8
    return out


def plan_narrow(
    groups: Sequence[PackedGroup],
    narrow_dim: int,
    min_dim: int = 4,
) -> Dict[int, int]:
    """gid -> narrow master width for the picasso_narrow hot/cold split.

    Clamps the requested width per group: rounded down to the ``min_dim``
    (sublane) multiple with a floor of ``min_dim``, and groups whose model
    dim is already at or below the request keep their full dim (recording
    ``dim`` means "no narrowing" under ``PicassoPlan.narrow_width``). The
    budget is recorded for every group — it only engages where the strategy
    assignment routes a group to 'picasso_narrow'.
    """
    out: Dict[int, int] = {}
    for g in groups:
        nd = int(narrow_dim)
        if nd <= 0 or nd >= g.dim:
            out[g.gid] = g.dim
        else:
            out[g.gid] = min(g.dim, max(min_dim, (nd // min_dim) * min_dim))
    return out


def make_plan(
    cfg: WDLConfig,
    world: int,
    per_device_batch: int,
    *,
    enable_packing: bool = True,
    enable_cache: bool = True,
    n_interleave: Optional[int] = None,
    n_micro: Optional[int] = None,
    hot_bytes: int = 1 << 30,
    l2_bytes: int = 0,
    narrow_dim: Optional[int] = None,
    capacity_slack: float = 2.0,
    exact_capacity: bool = False,
    freq_share: Optional[Dict[str, float]] = None,
    flush_iters: int = 100,
    warmup_iters: int = 100,
    mem_budget_bytes: float = 8 * 2**30,
    mesh_shape: Optional[Sequence[int]] = None,
) -> PicassoPlan:
    if mesh_shape is not None and int(np.prod(mesh_shape)) != world:
        raise ValueError(
            f"mesh_shape {tuple(mesh_shape)} has {int(np.prod(mesh_shape))} "
            f"devices but world={world}")
    groups = plan_packing(cfg, world, freq_share=freq_share, enable_packing=enable_packing)
    cache_rows = plan_cache(groups, hot_bytes, world) if enable_cache else {g.gid: 0 for g in groups}
    l2_rows = plan_l2(groups, l2_bytes if enable_cache else 0, cache_rows)
    capacity = {}
    for g in groups:
        local_ids = per_device_batch * g.ids_per_sample
        hit = 0.2 if cache_rows.get(g.gid, 0) else 0.0  # paper: >=20% hit at 1GB
        capacity[g.gid] = plan_capacity(g, local_ids, world, slack=capacity_slack,
                                        cache_hit_ratio=hit, exact=exact_capacity)
    act_bytes = 4.0 * (sum(g.n_bags * g.dim for g in groups) + sum(cfg.mlp_dims) * 4)
    micro = plan_microbatch(per_device_batch, act_bytes, mem_budget_bytes=mem_budget_bytes, n_micro=n_micro)
    ilv = plan_interleave(groups, n_groups=n_interleave)
    return PicassoPlan(
        groups=groups,
        world=world,
        capacity=capacity,
        interleave=ilv,
        microbatch=micro,
        cache_rows=cache_rows,
        flush_iters=flush_iters,
        warmup_iters=warmup_iters,
        l2_rows=l2_rows,
        hot_bytes=hot_bytes if enable_cache else 0,
        l2_bytes=l2_bytes if enable_cache else 0,
        narrow_dim=(plan_narrow(groups, narrow_dim)
                    if narrow_dim is not None else {}),
        mesh_shape=tuple(int(x) for x in mesh_shape) if mesh_shape else (),
    )


def revise_plan(
    plan: PicassoPlan,
    stats: Optional[Dict[int, np.ndarray]] = None,
    *,
    hot_bytes: Optional[int] = None,
    l2_bytes: Optional[int] = None,
    enable_cache: bool = True,
) -> PicassoPlan:
    """Recompile the plan's *revisable* decisions into revision ``rev+1``.

    The structural plan — groups, all_to_all capacities, interleave waves,
    micro-batch — is carried over untouched (it derives from the config and
    mesh, which do not change at runtime). What gets recompiled is the tier
    split: ``cache_rows``/``l2_rows`` are re-budgeted by ``plan_cache``/
    ``plan_l2`` with the measured FCounter ``stats`` (∝ measured lookup
    mass) instead of the structural warm prior.

    ``hot_bytes``/``l2_bytes``: byte envelopes for the re-split; ``None``
    re-splits the envelope recorded on the plan (``plan.hot_bytes`` /
    ``plan.l2_bytes``) — pass an explicit value to retune tier *capacity*
    at runtime (HugeCTR-style), including 0 to drop a tier.

    ``enable_cache=False`` (the engine runs with ``use_cache=False``)
    zeroes both tiers like ``make_plan``.

    The returned plan carries **no strategy assignment**: callers re-run
    ``repro_torch.core.assign.compile_assignment(new_plan, stats=...)`` so the
    strategy mix is scored against the *new* budgets, then record it with
    ``apply_assignment``. ``repro_torch.runtime.Replanner`` packages that loop,
    plus the live-state migration between revisions.
    """
    hb = int(plan.hot_bytes if hot_bytes is None else hot_bytes)
    lb = int(plan.l2_bytes if l2_bytes is None else l2_bytes)
    if enable_cache:
        cache_rows = plan_cache(plan.groups, hb, plan.world, stats=stats)
        l2_rows = plan_l2(plan.groups, lb, cache_rows, stats=stats)
    else:
        cache_rows = {g.gid: 0 for g in plan.groups}
        l2_rows = {g.gid: 0 for g in plan.groups}
    # dataclasses.replace: any future PicassoPlan field is carried over by
    # construction instead of silently resetting to its default here
    return dataclasses.replace(
        plan,
        capacity=dict(plan.capacity),
        interleave=[list(w) for w in plan.interleave],
        cache_rows=cache_rows,
        l2_rows=l2_rows,
        rev=plan.rev + 1,
        hot_bytes=hb,
        l2_bytes=lb,
        strategy={},  # deliberately unassigned: callers re-compile vs stats
    )
