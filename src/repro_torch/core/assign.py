"""Per-group strategy assignment: the cost model behind 'mixed' engines
(``repro.core.assign`` in torch, on the constant or the calibrated model).

PICASSO's packing analysis (paper §III-B) treats every packed group the same
way, but embedding tables are wildly heterogeneous: a handful of huge skewed
tables dominate ``CalcVParam`` while hundreds of tiny tables cost more in
all_to_all routing overhead than MP sharding saves in memory. The winning
layout is *mixed* (HugeCTR hybrid embedding; Meta's DLRM efficiency study):
PS-replicate the tiny tables, model-parallel-shard the big ones, cache only
where the skew pays for the hot tier.

This module is pure planning (numpy / python, like ``core.packing``).
``compile_assignment`` scores each packed group's per-step communication
volume under every registered strategy and emits a ``StrategyAssignment``:

``ps``
    all_gather ids + psum partial rows: O(world * n * D) elements but no
    routing machinery — wins for tiny/replicable groups where n is small and
    the fixed Shuffle overhead dominates.
``picasso``
    MP routing with the HybridHash hot tier absorbing the skew head: misses
    only through the Shuffle, plus the per-step psum of hot-row grads — wins
    for large groups whose FCounter skew gives a real hit ratio.
``hybrid``
    MP routing, no cache — the middle ground when a group is too big to
    replicate but too flat (or unbudgeted) to cache.
``picasso_l2``
    The picasso path with an L2 host-memory tier behind the hot tier
    (HugeCTR-style hierarchical parameter cache). Scored only for groups the
    plan gives an ``l2_rows`` budget: the candidate wins over plain picasso
    when the frequency mass ranked just below the L1 set (the working set
    that *overflows* the device-resident budget) clears the same
    profitability gate as the hot tier itself — a host read is charged at
    ``L2_HOST_FACTOR`` of a network element, so L2 pays off exactly where
    skew extends past the constricted L1.
``picasso_narrow``
    The picasso_l2 path with a frequency-adaptive narrow master: cold ids
    (the lookup mass neither tier absorbs, ``estimate_narrow_gain``) are
    stored and routed at the planned narrow width ``d = plan.narrow_dim``
    and projected up to the model dim at lookup, so both the cold miss wire
    and the master's parameter bytes shrink ~``D/d``-fold. Scored only for
    groups the plan gives a narrow budget, and gated to vparam-dominated
    cold-heavy groups (``NARROW_MIN_ROWS`` rows, ``NARROW_COLD_MIN`` cold
    mass) — hot-headed groups keep full width everywhere.

The engine consumes the result through ``resolve_assignment``, which also
normalizes the user-facing spellings (the **assignment resolution order**):
an explicit ``StrategyAssignment`` / ``{gid: name}`` dict is taken as-is
(validated for exact coverage), ``'mixed'``/``'auto'`` uses the plan's
recorded assignment or compiles one and records it, and any other single
registry name broadcasts.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from fnmatch import fnmatchcase
from typing import Dict, Mapping, Optional, Union

import numpy as np

from repro_torch.core.packing import PackedGroup, PicassoPlan

# Fixed per-group cost (in "row elements") of launching the Shuffle machinery:
# unique/partition kernels plus two all_to_all dispatches. Tiny groups whose
# whole PS transfer is below this are cheaper off the routed path entirely.
ROUTE_OVERHEAD_ELEMS = 4096.0

# Cache hit ratio assumed for a budgeted group with no measured stats
# (paper Tab. VI: >=20% at a 1 GB hot tier on production skew).
DEFAULT_HIT_RATIO = 0.2

# A group is "replicable" (eligible for the PS path) only below this many
# packed rows: the PS pattern effectively replicates the lookup work on
# every shard, which is only acceptable for tiny tables.
PS_MAX_ROWS = 8192

# Minimum hot-tier hit ratio for the cache's psum/flush machinery to pay
# for itself; flatter groups stay on the plain routed path.
SKEW_MIN = 0.05

# Cost of serving one row element from the L2 host tier, relative to moving
# it over the network: a pinned-host DMA is cheaper than an all_to_all round
# trip but not free (PCIe/DMA bandwidth + the probe).
L2_HOST_FACTOR = 0.5

# The narrow (hot/cold heterogeneous width) master only pays off for groups
# whose parameter volume dominates the budget: below this many packed rows
# the k-fold vparam saving is noise while the projection still costs a
# matmul + psum per step.
NARROW_MIN_ROWS = 65536

# Minimum cold lookup mass (the share neither tier absorbs) for the narrow
# wire to matter: a hot-headed group serves almost everything full-width
# from the tiers, so narrowing its master mostly adds projection error.
NARROW_COLD_MIN = 0.3


@dataclass(frozen=True)
class GroupScore:
    """Cost-model inputs and per-candidate scores for one packed group."""

    gid: int
    vparam: float
    ids_per_shard: int          # expected ids per step per shard
    rows: int
    skew: float                 # estimated hot-tier hit ratio in [0, 1]
    costs: Dict[str, float]     # candidate name -> estimated cost / step
    choice: str
    reason: str
    units: str = "elems"        # "elems" (constants) | "us" (calibrated)


@dataclass(frozen=True)
class StrategyAssignment:
    """Plan-level strategy map plus the cost-model evidence behind it."""

    strategy: Dict[int, str]            # gid -> registry name
    scores: Dict[int, GroupScore] = field(default_factory=dict)

    def describe(self) -> str:
        """Human-readable per-group table (launchers print this)."""
        lines = []
        for gid in sorted(self.strategy):
            s = self.scores.get(gid)
            if s is None:
                lines.append(f"  g{gid}: {self.strategy[gid]}")
            else:
                lines.append(f"  g{gid}: {s.choice:8s} rows={s.rows:<9d} "
                             f"ids/shard={s.ids_per_shard:<6d} "
                             f"skew={s.skew:.2f}  ({s.reason})")
        return "\n".join(lines)


def _validate_name(name: str) -> str:
    # the registry lives with the engine, which imports this module; keep
    # this module importable without it except when a name needs resolving
    from repro_torch.engine.strategies import get_strategy

    get_strategy(name)  # raises with the registry menu on unknown names
    return name


def _ranked(counts: Optional[np.ndarray], ranked: bool) -> Optional[np.ndarray]:
    """Counts as a descending frequency ranking (sorted once per caller)."""
    if counts is None:
        return None
    c = np.asarray(counts, np.float64).reshape(-1)
    return c if ranked else np.sort(c)[::-1]


def estimate_skew(group: PackedGroup, cache_rows: int,
                  counts: Optional[np.ndarray] = None, *,
                  ranked: bool = False, cost_model=None) -> float:
    """Expected hot-tier hit ratio for ``group`` given ``cache_rows`` slots.

    With measured FCounter ``counts`` (the engine's per-row frequency stats,
    any shard layout — only the distribution matters), the hit ratio is the
    lookup share of the ``cache_rows`` hottest rows. Without stats we fall
    back to the paper's warm-skew prior for budgeted groups — except when
    the tier covers the whole table, where every lookup hits.
    ``ranked=True`` promises ``counts`` is already sorted descending (so a
    caller scoring several tiers sorts the multi-million-row array once).
    A calibrated ``cost_model`` replaces the structural prior with its
    measured ``hit_prior`` (``repro_torch.perf.CostModel``).
    """
    cache_rows = min(int(cache_rows), group.rows)
    if cache_rows <= 0:
        return 0.0
    c = _ranked(counts, ranked)
    if c is not None:
        total = float(c.sum())
        if total > 0:
            return float(c[:cache_rows].sum() / total)
    if cache_rows >= group.rows:
        return 1.0
    return float(cost_model.hit_prior) if cost_model is not None \
        else DEFAULT_HIT_RATIO


def estimate_l2_gain(group: PackedGroup, cache_rows: int, l2_rows: int,
                     counts: Optional[np.ndarray] = None, *,
                     ranked: bool = False, cost_model=None) -> float:
    """Extra hit ratio an L2 tier of ``l2_rows`` slots adds behind an L1 of
    ``cache_rows`` slots.

    With measured FCounter ``counts`` this is exact: the lookup share of the
    rows frequency-ranked in ``[cache_rows, cache_rows + l2_rows)`` — the
    band the two-tier flush actually loads into L2 (``ranked=True`` as in
    ``estimate_skew``). Without stats: full coverage (L1+L2 >= the whole
    table) absorbs everything L1 misses; else the warm-skew prior scaled by
    how much the host tier out-sizes the (constricted) device tier — an L2
    smaller than L1 adds proportionally less, matching the zipf tail
    flattening past the head.
    """
    cache_rows = min(int(cache_rows), group.rows)
    l2_rows = min(int(l2_rows), group.rows - cache_rows)
    if l2_rows <= 0:
        return 0.0
    c = _ranked(counts, ranked)
    if c is not None:
        total = float(c.sum())
        if total > 0:
            return float(c[cache_rows:cache_rows + l2_rows].sum() / total)
    l1 = estimate_skew(group, cache_rows, cost_model=cost_model)
    if cache_rows + l2_rows >= group.rows:
        return 1.0 - l1
    prior = (float(cost_model.hit_prior) if cost_model is not None
             else DEFAULT_HIT_RATIO)
    return (1.0 - l1) * prior * min(1.0, l2_rows / max(cache_rows, 1))


def estimate_narrow_gain(group: PackedGroup, cache_rows: int, l2_rows: int,
                         counts: Optional[np.ndarray] = None, *,
                         ranked: bool = False, cost_model=None) -> float:
    """Cold lookup mass: the fraction of lookups served by NEITHER tier —
    exactly the traffic (and, weighted by residency, the parameter bytes)
    that the picasso_narrow candidate moves to the narrow width. With
    measured FCounter ``counts`` this is the lookup share of the rows ranked
    below ``cache_rows + l2_rows``; without stats, the complement of the
    warm-skew priors. ``ranked=True`` as in ``estimate_skew``."""
    skew = estimate_skew(group, cache_rows, counts, ranked=ranked,
                         cost_model=cost_model)
    l2 = estimate_l2_gain(group, cache_rows, l2_rows, counts, ranked=ranked,
                          cost_model=cost_model)
    return float(max(0.0, 1.0 - skew - l2))


def _score_group(group: PackedGroup, world: int, ids_per_shard: int,
                 cache_rows: int, skew: float, *,
                 l2_rows: int = 0, l2_gain: float = 0.0,
                 narrow_dim: int = 0, narrow_gain: float = 0.0,
                 ps_max_rows: int = PS_MAX_ROWS,
                 skew_min: float = SKEW_MIN,
                 narrow_min_rows: int = NARROW_MIN_ROWS,
                 narrow_cold_min: float = NARROW_COLD_MIN,
                 cost_model=None) -> GroupScore:
    """Score one group: comm-volume estimates plus the replicability /
    skew gates that pick ps for tiny groups, picasso for large skewed
    ones, hybrid for the middle — picasso_l2 where an L2 budget captures
    working set that overflows the hot tier, and picasso_narrow where a
    vparam-dominated group's cold tail can ride the narrow wire.

    With a calibrated ``cost_model`` (``repro_torch.perf.CostModel``) the candidate
    prices come from measured per-op curves (microseconds) instead of the
    abstract element-volume constants below; the candidate set and every
    decision gate are identical either way — only the prices change."""
    n, d = float(max(ids_per_shard, 1)), float(group.dim)
    narrow_ok = (0 < narrow_dim < group.dim
                 and group.rows >= narrow_min_rows
                 and narrow_gain >= narrow_cold_min)
    if cost_model is not None:
        costs = cost_model.score_candidates(
            world=world, n=n, d=d, skew=skew,
            l2_rows=l2_rows, l2_gain=l2_gain,
            narrow_dim=narrow_dim if narrow_ok else 0,
            narrow_gain=narrow_gain)
        units = "us"
    else:
        # ps: all_gather n ids from every shard, psum [world*n, D] partials.
        ps = world * n * (d + 1.0)
        # hybrid: route ids out (n) and rows back (n*D), twice (fwd + bwd),
        # plus the fixed dispatch overhead of the Shuffle machinery.
        hybrid = 2.0 * n * (1.0 + d) + ROUTE_OVERHEAD_ELEMS
        # picasso: only misses ride the Shuffle; hit-grad handling is
        # amortized over flush_iters (psum mode) or rides a small second
        # a2a (stale mode).
        picasso = 2.0 * n * (1.0 - skew) * (1.0 + d) + ROUTE_OVERHEAD_ELEMS
        costs = {"ps": ps, "hybrid": hybrid, "picasso": picasso}
        l2_maint = 0.0
        if l2_rows > 0:
            # picasso_l2: L2 hits leave the network entirely but pay a
            # host-DMA read charged at L2_HOST_FACTOR of a network element,
            # plus the tier's exact-update maintenance in 'psum' mode — the
            # cheaper of the dense tier psum (O(H2*D)) and the gathered
            # hit-grad update (O((world-1)*n*D)); see
            # packed_embedding.apply_sparse_grads_l2.
            l2_maint = min((world - 1) * n * (1.0 + d), float(l2_rows) * d)
            costs["picasso_l2"] = (
                2.0 * n * (1.0 - skew - l2_gain) * (1.0 + d)
                + L2_HOST_FACTOR * 2.0 * n * l2_gain * (1.0 + d)
                + l2_maint
                + ROUTE_OVERHEAD_ELEMS)
        if narrow_ok:
            # picasso_narrow: the cold tail (neither tier) routes at width
            # nd instead of D — both back-a2a directions shrink — while tier
            # hits cost what they cost under picasso_l2; the learned
            # projection adds a per-step nd x D grad psum. Tier maintenance
            # matches picasso_l2 (the tiers themselves stay full-width).
            nd = float(narrow_dim)
            costs["picasso_narrow"] = (
                2.0 * n * narrow_gain * (1.0 + nd)
                + L2_HOST_FACTOR * 2.0 * n * l2_gain * (1.0 + d)
                + l2_maint
                + nd * d
                + ROUTE_OVERHEAD_ELEMS)
        units = "elems"
    if group.rows <= ps_max_rows and costs["ps"] <= costs["hybrid"]:
        choice, reason = "ps", "tiny/replicable: PS transfer under routing overhead"
    elif cache_rows > 0 and skew >= skew_min:
        if (narrow_ok and costs["picasso_narrow"]
                <= min(costs["picasso"], costs.get("picasso_l2", np.inf))):
            choice = "picasso_narrow"
            reason = (f"cold tail (~{narrow_gain:.2f} of lookups) rides the "
                      f"narrow wire at d={narrow_dim}")
        elif (l2_rows > 0 and l2_gain >= skew_min
                and costs["picasso_l2"] <= costs["picasso"]):
            choice = "picasso_l2"
            reason = (f"working set overflows L1 (hit~{skew:.2f}); host tier "
                      f"absorbs ~{l2_gain:.2f} more")
        else:
            choice, reason = "picasso", f"skew head (hit~{skew:.2f}) pays for the hot tier"
    else:
        choice, reason = "hybrid", "too big to replicate, too flat to cache"
    return GroupScore(gid=group.gid, vparam=group.vparam,
                      ids_per_shard=ids_per_shard, rows=group.rows, skew=skew,
                      costs=costs, choice=choice, reason=reason, units=units)


def _apply_overrides(plan: PicassoPlan, strategy: Dict[int, str],
                     overrides: Mapping[Union[int, str], str]) -> None:
    """User override path: keys are gids (int or digit-string) or fnmatch
    globs over the table names a group packs. Unknown strategy names and
    globs matching nothing fail fast."""
    for key, name in overrides.items():
        _validate_name(name)
        if isinstance(key, int) or (isinstance(key, str) and key.isdigit()):
            gid = int(key)
            plan.group(gid)  # KeyError on unknown gid
            strategy[gid] = name
            continue
        hit = False
        for g in plan.groups:
            if any(fnmatchcase(t.name, key) for t in g.tables):
                strategy[g.gid] = name
                hit = True
        if not hit:
            raise ValueError(
                f"strategy override {key!r} matches no table; tables: "
                f"{sorted(t.name for g in plan.groups for t in g.tables)}")


def compile_assignment(
    plan: PicassoPlan,
    stats: Optional[Dict[int, np.ndarray]] = None,
    world: Optional[int] = None,
    *,
    per_device_batch: Optional[int] = None,
    overrides: Optional[Mapping[Union[int, str], str]] = None,
    ps_max_rows: int = PS_MAX_ROWS,
    skew_min: float = SKEW_MIN,
    enable_cache: bool = True,
    cost_model=None,
) -> StrategyAssignment:
    """Score every packed group and pick its cheapest lookup strategy.

    Parameters
    ----------
    plan: the planner output; ``plan.cache_rows`` feeds the hot-tier terms,
        ``plan.l2_rows`` the host-tier (picasso_l2) candidate — groups
        without an L2 budget are never offered that candidate, so plans
        built with ``l2_bytes=0`` score exactly as before — and
        ``plan.microbatch`` sizes the default per-step id volume.
    stats: optional gid -> FCounter counts array (measured skew); groups
        without stats use the structural prior.
    world: mesh size override (defaults to ``plan.world``).
    per_device_batch: per-shard batch the id volume is scaled to (defaults
        to the plan's micro-batch, the unit the engine actually issues).
    overrides: ``{gid_or_table_glob: name}`` forced picks applied after the
        cost model (so a glob can pin e.g. ``"user_*": "picasso"``).
    ps_max_rows/skew_min: replicability and hot-tier profitability gates
        (see the module constants).
    enable_cache: pass False when the engine will run with the hot tier
        disabled (``use_cache=False``), so the model scores groups with
        skew=0 instead of crediting a tier that never participates.
    cost_model: optional calibrated ``repro_torch.perf.CostModel``; when set, the
        candidate prices come from measured per-op curves (in us) and the
        no-stats tier estimates use its measured ``hit_prior``. ``None``
        keeps the constant model byte-for-byte.
    """
    world = int(world if world is not None else plan.world)
    batch = int(per_device_batch if per_device_batch is not None
                else max(plan.microbatch, 1))
    strategy: Dict[int, str] = {}
    scores: Dict[int, GroupScore] = {}
    for g in plan.groups:
        cache_rows = plan.cache_rows.get(g.gid, 0) if enable_cache else 0
        # the L2 tier sits behind L1, so a disabled hot tier disables it too
        l2_rows = plan.l2_rows.get(g.gid, 0) if (enable_cache and cache_rows) else 0
        # rank the (potentially multi-million-row) stats once per group,
        # shared by both tier estimators
        counts = _ranked(stats.get(g.gid) if stats else None, False)
        skew = estimate_skew(g, cache_rows, counts, ranked=True,
                             cost_model=cost_model)
        l2_gain = estimate_l2_gain(g, cache_rows, l2_rows, counts, ranked=True,
                                   cost_model=cost_model)
        # the narrow candidate is only offered where the plan budgets an
        # actually-narrowing width (plan_narrow records dim = "no narrowing")
        nd = int(plan.narrow_dim.get(g.gid, g.dim))
        narrow_gain = (estimate_narrow_gain(g, cache_rows, l2_rows, counts,
                                            ranked=True, cost_model=cost_model)
                       if 0 < nd < g.dim else 0.0)
        sc = _score_group(g, world, batch * g.ids_per_sample, cache_rows, skew,
                          l2_rows=l2_rows, l2_gain=l2_gain,
                          narrow_dim=nd if nd < g.dim else 0,
                          narrow_gain=narrow_gain,
                          ps_max_rows=ps_max_rows, skew_min=skew_min,
                          cost_model=cost_model)
        strategy[g.gid] = sc.choice
        scores[g.gid] = sc
    if overrides:
        _apply_overrides(plan, strategy, overrides)
        scores = {gid: s for gid, s in scores.items()
                  if strategy[gid] == s.choice}
    return StrategyAssignment(strategy=strategy, scores=scores)


def apply_assignment(plan: PicassoPlan,
                     assignment: Union[StrategyAssignment, Dict[int, str]]
                     ) -> PicassoPlan:
    """Record an assignment on the plan (``plan.strategy``) and return it."""
    mapping = (assignment.strategy if isinstance(assignment, StrategyAssignment)
               else dict(assignment))
    plan.strategy = {int(k): _validate_name(v) for k, v in mapping.items()}
    return plan


# spellings accepted by resolve_assignment for "compile it for me"
AUTO_NAMES = ("mixed", "auto")


def maybe_compile(plan: PicassoPlan, spec: "StrategySpec", *,
                  stats: Optional[Dict[int, np.ndarray]] = None,
                  per_device_batch: Optional[int] = None,
                  use_cache: bool = True,
                  overrides: Optional[Mapping[Union[int, str], str]] = None,
                  cost_model=None,
                  log=None) -> "StrategySpec":
    """Launcher-side 'mixed'/'auto' handling: compile the assignment once,
    record it on the plan (so every engine built from the plan — train step,
    host flush, serve — sees the same mixing), and optionally log it.
    Any other spec passes through untouched.

    ``stats`` is the optional gid -> measured FCounter counts map: the
    compile-time call passes None (structural prior); the runtime Replanner
    passes the harvested live counters so the re-mix scores *measured* skew
    (the full stats path: harvest -> revise_plan -> maybe_compile(stats=)).
    ``per_device_batch`` must match the id volume the engine actually issues
    per step: leave it None (-> ``plan.microbatch``) for training, pass the
    per-shard batch for serving (no micro pipeline there). ``use_cache``
    must match the engine flag so the model never credits a disabled tier.
    ``overrides`` forwards user ``{gid_or_glob: name}`` pins. ``cost_model``
    forwards a calibrated ``repro_torch.perf.CostModel`` (None = constants).
    """
    if isinstance(spec, str) and spec in AUTO_NAMES:
        asg = compile_assignment(plan, stats=stats,
                                 per_device_batch=per_device_batch,
                                 overrides=overrides,
                                 enable_cache=use_cache,
                                 cost_model=cost_model)
        apply_assignment(plan, asg)
        if log is not None:
            src = "measured skew" if stats else "cost model"
            if cost_model is not None:
                src += f", calibrated curves ({cost_model.backend})"
            log(f"strategy assignment ({src}, plan rev {plan.rev}):\n"
                f"{asg.describe()}")
    return spec


StrategySpec = Union[str, Dict[int, str], StrategyAssignment]


def resolve_assignment(plan: PicassoPlan, spec: StrategySpec,
                       world: Optional[int] = None,
                       use_cache: bool = True) -> Dict[int, str]:
    """Normalize any user-facing strategy spelling into a full gid -> name map.

    - a registry name broadcasts to every group (single-strategy sugar); a
      ``'picasso_narrow'`` broadcast is additionally **recorded**
      on the plan, because the narrow master widths
      (``PicassoPlan.narrow_width``) gate on ``plan.strategy``;
    - ``'mixed'`` / ``'auto'`` uses ``plan.strategy`` when the plan carries
      one, else compiles a fresh assignment from the plan's own statistics
      (``plan.microbatch`` id volume — the training unit; callers issuing a
      different per-step volume, e.g. un-pipelined serving, should compile
      with the right ``per_device_batch`` and record it via
      ``maybe_compile``/``apply_assignment`` first) and **records it on the
      plan**, so every later engine built from the same plan — including the
      host-scheduled flush — sees one consistent mixing;
    - a ``StrategyAssignment`` or ``{gid: name}`` dict is taken as-is but
      must cover exactly the plan's gids (typos and gaps fail fast here,
      not deep inside a step).

    ``world``/``use_cache`` are the engine's actual world size and cache flag
    (defaults: ``plan.world``, on); they feed the fallback compile's PS cost
    term and hot-tier credit.
    """
    if isinstance(spec, StrategyAssignment):
        mapping = dict(spec.strategy)
    elif isinstance(spec, dict):
        mapping = {int(k): v for k, v in spec.items()}
    elif spec in AUTO_NAMES:
        if plan.strategy:
            mapping = dict(plan.strategy)
        else:
            mapping = compile_assignment(plan, world=world,
                                         enable_cache=use_cache).strategy
            apply_assignment(plan, mapping)
    else:
        _validate_name(spec)
        mapping = {g.gid: spec for g in plan.groups}
        if spec == "picasso_narrow":
            # narrow gating (PicassoPlan.narrow_width) reads plan.strategy:
            # record the broadcast so state init and the migration see the
            # narrow master widths this engine runs with.
            apply_assignment(plan, mapping)
        return mapping

    gids = {g.gid for g in plan.groups}
    missing = sorted(gids - set(mapping))
    extra = sorted(set(mapping) - gids)
    if missing or extra:
        raise ValueError(
            f"strategy assignment must cover exactly the plan's groups; "
            f"missing gids {missing}, unknown gids {extra}")
    for name in set(mapping.values()):
        _validate_name(name)
    return mapping
