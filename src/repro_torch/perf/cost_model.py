"""Calibrated per-op cost curves + the CostModel the assignment queries
(``repro.perf.cost_model`` in the port, its float64 numpy arithmetic kept so
the numbers are bitwise the reference's).

The hand-tuned constants in ``repro_torch.core.assign`` (``ROUTE_OVERHEAD_ELEMS``,
``L2_HOST_FACTOR``, ...) price every candidate strategy in abstract "row
elements", which keeps the *relative* ordering plausible but means the system
cannot know whether its own decisions are right — the gap Lin et al.'s DLRM
performance model closes by predicting per-op kernel times from measured
cost curves. This module is the measured replacement:

* ``CostCurve`` — a monotone piecewise-linear fit over measured
  ``(work, microseconds)`` points for one op. Below the smallest measured
  point the curve clamps to the first measurement (the fixed launch
  overhead); past the largest it extrapolates along the last segment's
  slope. Monotonicity in the work size is *enforced* at fit time
  (``np.maximum.accumulate``), so a noisy microbench can never produce a
  model where more rows×dim is predicted cheaper.
* ``CostModel`` — the per-op curve table (one per priced op: the fused
  sparse kernels, bytes-on-wire collectives, dense matmul) plus the online
  ``correction`` factor the Replanner's feedback loop blends in, and the
  measured ``hit_prior`` that replaces ``DEFAULT_HIT_RATIO`` in the no-stats
  tier estimators. ``score_candidates`` prices exactly the same candidate
  set ``assign._score_group`` builds from constants — same keys, same
  gating inputs — but in *microseconds predicted from calibration* instead
  of abstract elements.

``repro_torch.perf.calibration`` produces fitted models from microbenches (or the
cached, backend-stamped calibration file); ``repro_torch.core.assign`` consumes
them via the optional ``cost_model=`` parameter (``None`` keeps the constant
model byte-for-byte, so current tests stay meaningful).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

# the ops the model prices; every calibration file must cover all of them.
# work units: "elems" ops are sized in rows*dim f32 elements touched, "wire"
# ops in bytes on the wire per shard, dense_matmul in multiply-accumulates.
PRICED_OPS = (
    "gather_pool",    # unique-row gather + segment pooling (fwd path)
    "dedup_adagrad",  # one-pass dedup + adagrad + scatter (sparse update)
    "tier_probe",     # sorted-key binary search + hit-masked row gather
    "gather_project", # narrow-row gather + learned up-projection stitch
    "wire_a2a",       # all_to_all bytes on wire (the Shuffle hops)
    "wire_ag",        # all_gather/psum bytes on wire (PS + tier maintenance)
    "dense_matmul",   # dense MACs (the narrow projection's [d,D] matmul)
)

# EMA weight for the online correction blend: high enough that a persistent
# 2x misprediction is mostly corrected within a handful of replan windows,
# low enough that one noisy window cannot whipsaw the scores.
CORRECTION_ALPHA = 0.3
# sanity clamp: a correction outside this band means the measurement is
# garbage (e.g. a stalled step), not that every kernel is 100x off
CORRECTION_BOUNDS = (0.05, 20.0)

_F32_BYTES = 4.0


@dataclass(frozen=True)
class CostCurve:
    """Monotone piecewise-linear cost fit: work size -> microseconds."""

    xs: np.ndarray  # measured work sizes, strictly increasing
    ys: np.ndarray  # fitted us per call, non-decreasing (enforced)

    @staticmethod
    def fit(samples: Sequence[Tuple[float, float]]) -> "CostCurve":
        """Fit from raw ``(work, us)`` measurements.

        Duplicate work sizes collapse to their median; the fitted values are
        then made non-decreasing (isotonic in the cheap direction: each point
        is raised to the running max), which is what makes downstream strategy
        scores provably monotone in rows and dim."""
        if not samples:
            raise ValueError("CostCurve.fit needs at least one sample")
        by_x: Dict[float, List[float]] = {}
        for x, y in samples:
            by_x.setdefault(float(x), []).append(float(y))
        xs = np.array(sorted(by_x), np.float64)
        ys = np.array([np.median(by_x[x]) for x in xs], np.float64)
        ys = np.maximum.accumulate(np.maximum(ys, 0.0))
        return CostCurve(xs=xs, ys=ys)

    def __call__(self, x: float) -> float:
        """us for ``x`` units of work (clamp left, extrapolate right)."""
        xs, ys = self.xs, self.ys
        x = float(max(x, 0.0))
        if x <= xs[0]:
            return float(ys[0])          # fixed launch overhead floor
        if x >= xs[-1]:
            if len(xs) == 1:
                return float(ys[-1])
            slope = (ys[-1] - ys[-2]) / max(xs[-1] - xs[-2], 1e-12)
            return float(ys[-1] + max(slope, 0.0) * (x - xs[-1]))
        return float(np.interp(x, xs, ys))

    def to_json(self) -> Dict[str, List[float]]:
        return {"xs": [float(v) for v in self.xs],
                "ys_us": [float(v) for v in self.ys]}

    @staticmethod
    def from_json(d: Mapping[str, Any]) -> "CostCurve":
        return CostCurve(xs=np.asarray(d["xs"], np.float64),
                         ys=np.asarray(d["ys_us"], np.float64))


@dataclass
class CostModel:
    """Fitted per-op cost curves + the online feedback state.

    ``correction`` is the multiplicative measured-vs-predicted blend the
    Replanner maintains (1.0 = trust the calibration); it scales every
    candidate score uniformly, so a systematic misprediction (untimed dense
    work, a drifted clock) self-corrects without re-ranking ops against each
    other. ``hit_prior`` replaces ``assign.DEFAULT_HIT_RATIO`` in the
    no-stats tier estimators once a measured value exists.
    """

    curves: Dict[str, CostCurve]
    backend: str = "unknown"
    interpret: bool = False
    hit_prior: float = 0.2  # assign.DEFAULT_HIT_RATIO; measured once observed
    correction: float = 1.0
    meta: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        missing = [op for op in PRICED_OPS if op not in self.curves]
        if missing:
            raise ValueError(f"cost model is missing curves for {missing}; "
                             f"priced ops are {list(PRICED_OPS)}")

    # ------------------------------------------------------------- queries
    def op_us(self, op: str, work: float) -> float:
        """Raw (uncorrected) predicted us for ``work`` units of ``op``."""
        return self.curves[op](work)

    def score_candidates(self, *, world: int, n: float, d: float,
                         skew: float = 0.0,
                         l2_rows: int = 0, l2_gain: float = 0.0,
                         narrow_dim: int = 0, narrow_gain: float = 0.0,
                         ) -> Dict[str, float]:
        """Predicted us/step for every candidate strategy of one group.

        Mirrors ``assign._score_group``'s constant formulas term by term —
        same candidate keys under the same conditions (``picasso_l2`` only
        when ``l2_rows > 0``, ``picasso_narrow`` only when
        ``0 < narrow_dim < d``) so the decision logic in ``assign`` is
        identical either way; only the prices change.
        """
        world, n, d = int(max(world, 1)), float(max(n, 1.0)), float(d)
        B = _F32_BYTES
        pool = self.op_us("gather_pool", n * d)
        upd = self.op_us("dedup_adagrad", n * d)
        probe = self.op_us("tier_probe", n * d)

        def miss_wire(frac: float, width: float) -> float:
            # ids out + rows back, fwd + bwd: two all_to_all dispatches
            return 2.0 * self.op_us("wire_a2a", n * frac * (1.0 + width) * B)

        costs: Dict[str, float] = {
            # ps: all_gather n ids from every shard, pool the world*n lookups
            # locally, psum the [world*n, D] partial rows
            "ps": (self.op_us("wire_ag", world * n * B)
                   + self.op_us("gather_pool", world * n * d)
                   + self.op_us("wire_ag", world * n * d * B)
                   + upd),
            "hybrid": pool + miss_wire(1.0, d) + upd,
            "picasso": pool + probe + miss_wire(1.0 - skew, d) + upd,
        }
        l2_maint = 0.0
        if l2_rows > 0:
            # exact-update maintenance: the cheaper of the dense tier psum
            # and the gathered hit-grad update (see apply_sparse_grads_l2)
            l2_maint = min(
                self.op_us("wire_ag", max(world - 1, 0) * n * (1.0 + d) * B),
                self.op_us("dedup_adagrad", float(l2_rows) * d))
            costs["picasso_l2"] = (
                pool + probe
                # the host tier is a second probe + a host-DMA row read,
                # priced by the same probe curve at the L2 hit volume
                + self.op_us("tier_probe", n * l2_gain * d)
                + miss_wire(1.0 - skew - l2_gain, d)
                + l2_maint + upd)
        if 0 < narrow_dim < d:
            nd = float(narrow_dim)
            costs["picasso_narrow"] = (
                pool + probe
                + self.op_us("tier_probe", n * l2_gain * d)
                + miss_wire(narrow_gain, nd)      # cold tail at narrow width
                + l2_maint
                + self.op_us("gather_project", n * d)
                + self.op_us("dense_matmul", n * nd * d)  # projection MACs
                + upd)
        c = self.correction
        return {k: v * c for k, v in costs.items()}

    # ------------------------------------------------------ step prediction
    def predict_step_us(self, plan, stats: Optional[Dict[int, np.ndarray]] = None,
                        *, world: Optional[int] = None,
                        per_device_batch: Optional[int] = None) -> float:
        """Predicted sparse-path us/step under the plan's recorded strategy.

        The Replanner compares this against measured step wall time to blend
        ``correction`` (dense compute and host overhead are deliberately in
        the measured side only — the uniform correction absorbs them)."""
        from repro_torch.core.assign import (estimate_l2_gain, estimate_narrow_gain,
                                             estimate_skew, _ranked)

        world = int(world if world is not None else plan.world)
        batch = int(per_device_batch if per_device_batch is not None
                    else max(plan.microbatch, 1))
        total = 0.0
        for g in plan.groups:
            cache_rows = plan.cache_rows.get(g.gid, 0)
            l2_rows = plan.l2_rows.get(g.gid, 0)
            counts = _ranked(stats.get(g.gid) if stats else None, False)
            skew = estimate_skew(g, cache_rows, counts, ranked=True,
                                 cost_model=self)
            l2_gain = estimate_l2_gain(g, cache_rows, l2_rows, counts,
                                       ranked=True, cost_model=self)
            nd = int(plan.narrow_dim.get(g.gid, g.dim))
            narrow_gain = (estimate_narrow_gain(
                g, cache_rows, l2_rows, counts, ranked=True, cost_model=self)
                if 0 < nd < g.dim else 0.0)
            costs = self.score_candidates(
                world=world, n=batch * g.ids_per_sample, d=g.dim, skew=skew,
                l2_rows=l2_rows, l2_gain=l2_gain,
                narrow_dim=nd if nd < g.dim else 0, narrow_gain=narrow_gain)
            name = plan.strategy.get(g.gid, "picasso")
            total += costs.get(name, min(costs.values()))
        return total

    # ------------------------------------------------------ online feedback
    def observe_measured(self, measured_us: float, predicted_us: float,
                         alpha: float = CORRECTION_ALPHA) -> float:
        """Blend one measured-vs-predicted window into ``correction``.

        ``predicted_us`` is the *corrected* prediction (what the scores used),
        so the update is a geometric EMA toward the fixed point where
        prediction matches measurement:
        ``corr <- corr * (measured / predicted) ** alpha``. Returns the new
        correction. Degenerate inputs (non-positive times) are ignored."""
        if measured_us <= 0.0 or predicted_us <= 0.0:
            return self.correction
        ratio = measured_us / predicted_us
        lo, hi = CORRECTION_BOUNDS
        self.correction = float(np.clip(
            self.correction * ratio ** float(alpha), lo, hi))
        return self.correction

    # -------------------------------------------------------- serialization
    def to_json(self) -> Dict[str, Any]:
        return {
            "backend": self.backend,
            "interpret": bool(self.interpret),
            "hit_prior": float(self.hit_prior),
            "ops": {op: c.to_json() for op, c in self.curves.items()},
            "meta": dict(self.meta),
        }

    @staticmethod
    def from_json(d: Mapping[str, Any]) -> "CostModel":
        return CostModel(
            curves={op: CostCurve.from_json(c)
                    for op, c in d.get("ops", {}).items()},
            backend=str(d.get("backend", "unknown")),
            interpret=bool(d.get("interpret", False)),
            hit_prior=float(d.get("hit_prior", 0.2)),
            meta=dict(d.get("meta", {})),
        )


def synthetic_cost_model(per_elem_us: Optional[Mapping[str, float]] = None,
                         fixed_us: float = 1.0, **kw) -> CostModel:
    """A fully-specified linear CostModel for tests and injection.

    Every op gets the curve ``us = fixed_us + per_elem * work`` sampled at
    two points (so interpolation/extrapolation are exact). ``per_elem_us``
    overrides the default 1e-3 us/unit per op — distorting one op's slope is
    how a test flips a known group's strategy choice."""
    per = {op: 1e-3 for op in PRICED_OPS}
    per.update(per_elem_us or {})
    curves = {op: CostCurve.fit([(1.0, fixed_us + s),
                                 (1e6, fixed_us + s * 1e6)])
              for op, s in per.items()}
    return CostModel(curves=curves, backend="synthetic", **kw)
