"""Adaptive replanning runtime (``repro.runtime.replanner`` in torch): close
the measure -> recompile -> migrate loop, at any world.

Every ``--replan-iters`` steps the trainer calls ``Replanner.maybe_replan``:

1. **harvest** the engine's live FCounter counts (``engine.export_stats``)
   plus the window's ``overflow*``/``cache_hits*`` metric sums
   (``observe``);
2. **recompile**: ``revise_plan`` re-budgets ``cache_rows``/``l2_rows`` from
   the measured mass and ``compile_assignment(plan, stats=...)`` re-mixes
   the per-group strategy (for ``'mixed'``/``'auto'``) -> revision ``rev+1``;
3. **migrate**: if anything changed, ``embedding.state.migrate_state``
   carries the live state across revisions on its device (write-back,
   measured top-(H1+H2) tier re-split, master rows, adagrad slots and the
   FCounter preserved exactly). Each rank keeps its own rows, so placing
   the state onto the new plan's shardings is the identity.

The caller then rebuilds its train step against the new plan. A recompile
that lands on an identical plan returns ``None``: no migration, no rebuild,
and training is bitwise the run that never replanned.

Checkpoint contract: ``plan_meta(plan)`` is the JSON record of a revision
the trainer saves beside the state; on resume ``apply_plan_meta`` revises
the freshly compiled structural plan back to it before the restore
template is built.

With a calibrated ``cost_model`` (``repro_torch.perf``) every recompile
prices the candidates from its curves, and the feedback loop runs: step
times fed to ``observe_timing`` are compared at each replan against
``cost_model.predict_step_us``, and the ratio is blended into its
``correction`` (the reference's geometric EMA). ``pin_l2`` mirrors the
trainer's ``--pin-l2``: ``migrate_state`` keeps the leaves the old plan
pinned where they are, and the replanner pins what the new plan names and
the old one did not (``embedding.state.pin_to_host``, a no-op for a leaf
already placed).

Past world 1 (``group=``, one process per rank) every rank runs the loop
together and reaches the decision the reference reaches in its one
process: the harvest all_gathers the FCounter shards, so every rank
recompiles from the same stats; the feedback blends one agreed
measurement (each step's slowest rank, then the window's median), so the
cost models stay alike; the ranks agree on a digest of the new revision's
``plan_meta`` before anything moves, and a difference raises
``ReplanMismatch`` on every rank (ranks on different plans would deadlock
in the first collective one of them skips); and each rank migrates its
cut of the masters (``migrate_state(group=)``). An event's ``seconds`` are
the slowest rank's.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.assign import apply_assignment, compile_assignment, resolve_assignment
from repro_torch.core.packing import PicassoPlan, revise_plan
from repro_torch.dist.compat import (WORLD1, Group, agree, ckpt_broadcast_object,
                                     gather_floats)
from repro_torch.embedding.state import migrate_state, pin_to_host
from repro_torch.engine.engine import export_stats


# ---------------------------------------------------------------------------
# plan deltas + checkpoint meta
# ---------------------------------------------------------------------------


def plan_delta(old: PicassoPlan, new: PicassoPlan) -> Dict[int, str]:
    """gid -> what changed between two revisions; empty == a no-op revision
    (same tier budgets, strategies and master widths)."""
    changed: Dict[int, str] = {}
    for g in new.groups:
        h1o, h1n = old.cache_rows.get(g.gid, 0), new.cache_rows.get(g.gid, 0)
        h2o, h2n = old.l2_rows.get(g.gid, 0), new.l2_rows.get(g.gid, 0)
        so = old.strategy.get(g.gid, "picasso")
        sn = new.strategy.get(g.gid, "picasso")
        ndo, ndn = old.narrow_width(g.gid), new.narrow_width(g.gid)
        parts = []
        if so != sn:
            parts.append(f"{so}->{sn}")
        if h1o != h1n:
            parts.append(f"L1 {h1o}->{h1n}")
        if h2o != h2n:
            parts.append(f"L2 {h2o}->{h2n}")
        if ndo != ndn:
            parts.append(f"narrow {ndo}->{ndn}")
        if parts:
            changed[g.gid] = " ".join(parts)
    return changed


def plan_meta(plan: PicassoPlan) -> Dict[str, Any]:
    """JSON-serializable record of a plan revision (the checkpoint sidecar):
    the revisable decisions, and the world and mesh the state was written
    under. Field for field the reference's."""
    return {
        "world": int(plan.world),
        "mesh_shape": [int(x) for x in plan.mesh_shape],
        "plan_rev": int(plan.rev),
        "hot_bytes": int(plan.hot_bytes),
        "l2_bytes": int(plan.l2_bytes),
        "cache_rows": {str(gid): int(r) for gid, r in plan.cache_rows.items()},
        "l2_rows": {str(gid): int(r) for gid, r in plan.l2_rows.items()},
        "strategy": {str(gid): name for gid, name in plan.strategy.items()},
        "narrow_dim": {str(gid): int(d) for gid, d in plan.narrow_dim.items()},
    }


def apply_plan_meta(plan: PicassoPlan, meta: Mapping[str, Any]) -> PicassoPlan:
    """Revise a freshly compiled structural ``plan`` back to a checkpointed
    revision (tier budgets, strategy, narrow widths from ``meta``). Call
    before building the state template."""
    gids = {g.gid for g in plan.groups}
    meta_gids = {int(k) for k in meta.get("cache_rows", {})}
    if meta_gids and meta_gids != gids:
        raise ValueError(
            f"checkpoint plan meta covers gids {sorted(meta_gids)} but the compiled "
            f"plan has {sorted(gids)} — config/mesh changed under a resumed run")
    return dataclasses.replace(
        plan,
        capacity=dict(plan.capacity),
        interleave=[list(w) for w in plan.interleave],
        cache_rows={int(k): int(v) for k, v in meta["cache_rows"].items()},
        l2_rows={int(k): int(v) for k, v in meta["l2_rows"].items()},
        rev=int(meta.get("plan_rev", 0)),
        hot_bytes=int(meta.get("hot_bytes", plan.hot_bytes)),
        l2_bytes=int(meta.get("l2_bytes", plan.l2_bytes)),
        strategy={int(k): v for k, v in meta.get("strategy", {}).items()},
        narrow_dim=({int(k): int(v) for k, v in meta["narrow_dim"].items()}
                    if "narrow_dim" in meta else dict(plan.narrow_dim)),
    )


def plan_digest(plan: PicassoPlan) -> int:
    """A signed 64-bit digest of ``plan_meta(plan)`` (what the ranks agree on
    before a migration)."""
    raw = json.dumps(plan_meta(plan), sort_keys=True).encode()
    return int.from_bytes(hashlib.sha256(raw).digest()[:8], "big", signed=True)


class ReplanMismatch(RuntimeError):
    """The ranks of one run reached different replanning decisions (another
    plan revision, another count of step times). Raised on every rank
    together, before any state moves; the run cannot go on."""


# ---------------------------------------------------------------------------
# the Replanner
# ---------------------------------------------------------------------------


@dataclass
class ReplanEvent:
    """One replan attempt (kept in ``Replanner.events``). ``seconds`` holds
    the host time of its ``harvest``, ``compile`` and ``migrate`` phases."""

    step: int
    old_rev: int
    new_rev: int                  # == old_rev when the recompile was a no-op
    changed: Dict[int, str]       # gid -> delta description (empty = no-op)
    window: Dict[str, int]        # metric sums observed since the last replan
    seconds: Dict[str, float] = field(default_factory=dict)
    # cost-model feedback for this window (calibrated runs only): the
    # measured-vs-predicted sparse-path ratio and the correction factor the
    # NEXT recompile's scores were blended with (None = no cost model or no
    # timings observed this window)
    measured_us: Optional[float] = None
    predicted_us: Optional[float] = None
    correction: Optional[float] = None

    @property
    def migrated(self) -> bool:
        return bool(self.changed)

    def describe(self) -> str:
        w = " ".join(f"{k}={v}" for k, v in sorted(self.window.items()))
        if self.correction is not None:
            w = (f"measured={self.measured_us:.0f}us "
                 f"predicted={self.predicted_us:.0f}us "
                 f"corr={self.correction:.3f}" + (" " + w if w else ""))
        if not self.changed:
            return (f"step {self.step}: plan rev {self.old_rev} unchanged "
                    f"(recompile is a no-op){'  [' + w + ']' if w else ''}")
        ch = "; ".join(f"g{gid}: {d}" for gid, d in sorted(self.changed.items()))
        return (f"step {self.step}: plan rev {self.old_rev} -> {self.new_rev}, "
                f"migrated {len(self.changed)} group(s) [{ch}]"
                f"{'  [' + w + ']' if w else ''}")


def _sync(state: Dict[str, Any]) -> None:
    """Wait for the device work queued on the state's device, so a host
    clock read after it counts that work (``counts`` never leaves the
    device; ``w`` may be pinned in host memory)."""
    for es in state["emb"].values():
        if es.counts.is_cuda:
            torch.cuda.synchronize(es.counts.device)
        return


class Replanner:
    """Owns the adaptive replanning loop for one training run.

    plan: the live plan; without a recorded assignment the ``strategy`` spec
        is resolved and recorded (migration gating needs each group's class).
    strategy: ``'mixed'``/``'auto'`` re-mixes from measured skew at every
        replan; any other spec is re-resolved against each revision.
    hot_bytes/l2_bytes: byte envelopes of the re-budget (``None``: the ones
        recorded on the plan).
    rebudget: ``False`` keeps ``cache_rows``/``l2_rows`` exactly.
    use_cache/use_l2/cache_update: must mirror the train engine's flags.
    per_device_batch/overrides: forwarded to ``compile_assignment``.
    cost_model: optional calibrated ``repro_torch.perf.CostModel``: every
        recompile prices candidates from its curves, and the feedback loop
        (``observe_timing``) blends measured/predicted into its
        ``correction`` at each replan (the module docstring).
    pin_l2: mirrors the trainer's ``--pin-l2``: after the migration the
        leaves the new plan pins and the old one did not go to pinned host
        memory (``embedding.state.pin_to_host``).
    group: this rank's ``dist.Group`` past world 1 (the module docstring);
        ``None`` at world 1. After a change of world every rank of the new
        group calls ``adopt``.
    """

    def __init__(self, plan: PicassoPlan, *, strategy: Any = "auto",
                 hot_bytes: Optional[int] = None, l2_bytes: Optional[int] = None,
                 rebudget: bool = True, use_cache: bool = True, use_l2: bool = True,
                 cache_update: str = "psum", per_device_batch: Optional[int] = None,
                 overrides: Optional[Mapping[Union[int, str], str]] = None,
                 cost_model=None, pin_l2: bool = False,
                 log: Optional[Callable[[str], None]] = None,
                 group: Optional[Group] = None):
        self.plan = plan
        self.group = WORLD1 if group is None else group
        self.strategy = strategy
        self.hot_bytes = hot_bytes
        self.l2_bytes = l2_bytes
        self.rebudget = rebudget
        self.use_cache = use_cache
        self.use_l2 = use_l2
        self.cache_update = cache_update
        self.per_device_batch = per_device_batch
        self.overrides = overrides
        self.cost_model = cost_model
        self.pin_l2 = pin_l2
        self.log = log or (lambda s: None)
        self.events: List[ReplanEvent] = []
        self._window: Dict[str, Any] = {}  # device-scalar running sums
        self._timings_us: List[float] = []  # measured step wall times (host)
        self._auto = isinstance(strategy, str) and strategy in ("mixed", "auto")
        if not plan.strategy:
            apply_assignment(plan, resolve_assignment(plan, strategy, use_cache=use_cache))

    def adopt(self, plan: PicassoPlan, group: Optional[Group]) -> None:
        """Follow a change of world: the new plan and group, and on every
        rank of it rank 0's window, step times, events and cost-model
        correction (a spare that joins replans in step with the others).
        Every rank of ``group`` calls it together; no checkpoint may be in
        flight (it uses the group's ``ckpt_pg``)."""
        self.plan, self.group = plan, WORLD1 if group is None else group
        corr = None if self.cost_model is None else self.cost_model.correction
        window = {k: int(v) for k, v in self._window.items()}
        window, self._timings_us, self.events, corr = ckpt_broadcast_object(
            (window, self._timings_us, self.events, corr), self.group)
        self._window = window
        if self.cost_model is not None:
            self.cost_model.correction = corr

    def observe(self, metrics: Mapping[str, Any]) -> None:
        """Fold one step's ``overflow*``/``cache_hits*`` metrics into the
        window; the sums stay on the device until ``maybe_replan``."""
        for k, v in metrics.items():
            if k.startswith("overflow") or k.startswith("cache_hits"):
                self._window[k] = self._window.get(k, 0) + v

    def observe_timing(self, step_us: float) -> None:
        """Record one measured step wall time (host float, us) for the cost
        model's feedback loop; ignored without a calibrated cost model."""
        if self.cost_model is not None and step_us > 0.0:
            self._timings_us.append(float(step_us))

    def _close_window(self) -> Dict[str, int]:
        window = {k: int(v) for k, v in self._window.items()}
        self._window = {}
        return window

    def _measured(self) -> Optional[float]:
        """The window's agreed step time (us): each step's slowest rank (a
        step ends when its last rank ends), then the median over the
        window, the same float on every rank; at world 1 the median of this
        rank's times. ``None`` for a window without timings."""
        counts = {n for n, in agree([len(self._timings_us)], self.group)}
        if len(counts) != 1:
            raise ReplanMismatch(f"the ranks timed {sorted(counts)} steps this window")
        if not self._timings_us:
            return None
        slowest = np.max(np.asarray(gather_floats(self._timings_us, self.group)), axis=0)
        return float(np.median(slowest))

    def _feedback(self, stats: Dict[int, np.ndarray]
                  ) -> Tuple[Optional[float], Optional[float], Optional[float]]:
        """Blend this window's measured-vs-predicted ratio into the cost
        model's correction. The prediction uses the correction the window's
        scores used (before the update), so the EMA converges where the
        corrected prediction equals the measurement; the median ignores the
        window's slow first steps. Past world 1 the measurement is agreed
        (``_measured``), so every rank applies the same correction."""
        measured = None if self.cost_model is None else self._measured()
        self._timings_us = []
        if measured is None:
            return None, None, None
        predicted = self.cost_model.predict_step_us(
            self.plan, stats, per_device_batch=self.per_device_batch)
        corr = self.cost_model.observe_measured(measured, predicted)
        return measured, predicted, corr

    def _recompile(self, stats: Dict[int, np.ndarray]) -> PicassoPlan:
        """Measured stats -> candidate revision (budgets + assignment)."""
        new_plan = revise_plan(
            self.plan, stats if self.rebudget else None,
            hot_bytes=(self.hot_bytes if self.rebudget else self.plan.hot_bytes),
            l2_bytes=(self.l2_bytes if self.rebudget else self.plan.l2_bytes),
            enable_cache=self.use_cache)
        if not self.rebudget:
            new_plan.cache_rows = dict(self.plan.cache_rows)
            new_plan.l2_rows = dict(self.plan.l2_rows)
        if self._auto:
            apply_assignment(new_plan, compile_assignment(
                new_plan, stats=stats, per_device_batch=self.per_device_batch,
                overrides=self.overrides, enable_cache=self.use_cache,
                cost_model=self.cost_model))
        else:
            apply_assignment(new_plan, resolve_assignment(new_plan, self.strategy,
                                                          use_cache=self.use_cache))
        return new_plan

    def _agree_on(self, new_plan: PicassoPlan, step: int) -> None:
        """Every rank compiled the same revision, or every rank raises
        ``ReplanMismatch`` (one all_gather of a digest; never a hang)."""
        digests = [d for d, in agree([plan_digest(new_plan)], self.group)]
        if len(set(digests)) > 1:
            odd = [r for r, d in enumerate(digests) if d != digests[0]]
            raise ReplanMismatch(
                f"replan at step {step}: rank(s) {odd} compiled another plan revision "
                f"than rank 0 (plan_meta digests {digests})")

    def _slowest(self, seconds: Dict[str, float]) -> Dict[str, float]:
        """Each phase's seconds on the slowest rank."""
        keys = sorted(seconds)
        rows = gather_floats([seconds[k] for k in keys], self.group)
        return {k: max(r[i] for r in rows) for i, k in enumerate(keys)}

    def maybe_replan(self, state: Dict[str, Any], step: int = -1
                     ) -> Optional[Tuple[PicassoPlan, Dict[str, Any]]]:
        """Harvest -> recompile -> (maybe) migrate. ``None`` when the
        revision equals the live plan (state untouched), else ``(new_plan,
        new_state)``; the old state's tensors are reused by the new one
        (migration writes the tiers back into the master in place)."""
        _sync(state)  # the last step's queued work is not the harvest's
        t0 = time.perf_counter()
        stats = export_stats(self.plan, state["emb"], self.group)
        t1 = time.perf_counter()
        # feedback first: the correction lands in the cost model BEFORE the
        # recompile below prices this revision's candidates
        measured, predicted, corr = self._feedback(stats)
        new_plan = self._recompile(stats)
        self._agree_on(new_plan, step)
        changed = plan_delta(self.plan, new_plan)
        window = self._close_window()
        _sync(state)
        t2 = time.perf_counter()
        seconds = {"harvest": t1 - t0, "compile": t2 - t1}
        if not changed:
            seconds = self._slowest(seconds)
            ev = ReplanEvent(step=step, old_rev=self.plan.rev, new_rev=self.plan.rev,
                             changed={}, window=window, seconds=seconds,
                             measured_us=measured, predicted_us=predicted,
                             correction=corr)
            self.events.append(ev)
            self.log(ev.describe())
            return None
        new_state = migrate_state(self.plan, new_plan, state, use_cache=self.use_cache,
                                  use_l2=self.use_l2, cache_update=self.cache_update,
                                  group=self.group)
        if self.pin_l2:  # what the new plan pins and the old one did not
            new_state = pin_to_host(new_state, new_plan)
        _sync(new_state)  # the sort, the write-backs and the tier loads are queued
        seconds["migrate"] = time.perf_counter() - t2
        seconds = self._slowest(seconds)
        ev = ReplanEvent(step=step, old_rev=self.plan.rev, new_rev=new_plan.rev,
                         changed=changed, window=window, seconds=seconds,
                         measured_us=measured, predicted_us=predicted, correction=corr)
        self.events.append(ev)
        self.log(ev.describe())
        self.plan = new_plan
        return new_plan, new_state
