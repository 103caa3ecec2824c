"""Numeric anomaly guard (``repro.runtime.guard`` in torch): reject poisoned
steps before they become state.

1. **Detection** reads the step's loss and dense gradient norm on the host:
   a non-finite loss, a non-finite norm, or a norm above the spike threshold
   (``spike_factor`` x the EMA of accepted norms, armed after
   ``warmup_steps``) marks the step anomalous. That is one host sync a step.
2. **Rejection** keeps the prior state: the batch is consumed (skipped) and
   training goes on with the next one. The reference rejects by returning
   the prior state of a non-donating step. The port updates the embedding
   state in place and cannot copy the 7.5 GB table, so its train step
   judges itself once, after the chunk loop and before ``dense_update`` and
   the flush: ``rebind`` makes the guard that step's ``judge``, and a
   rejected step restores the rows its sparse updates wrote from a journal
   (``train.train_step``), which the step keeps only while judged. A guarded
   run on clean data is bitwise the unguarded run; a rejected step leaves
   every leaf bitwise as it was. A functional step (one without a
   ``judge``, such as a test's toy step) is judged after it returns and the
   prior state is returned, as in the reference.
3. **Rollback**: ``k_rollback`` consecutive rejections raise
   ``AnomalyRollback`` (the surviving state rides on it), which the
   ``Supervisor`` treats as transient: restore the last verified checkpoint
   and replay.

Past world 1 (``group=``) every rank runs a guard over its own step. The
judge reads the loss and the dense gradient norm after the step's psum,
which leaves the same bits on every rank, so every rank reaches the same
verdict; each judged step checks that with ``dist.agree`` and raises
``VerdictMismatch`` (fatal) on every rank if the verdicts differ. Each rank
journals and restores its own rows, so the events, counters and EMA are
the same on every rank and equal the reference's one guard's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np


class VerdictMismatch(RuntimeError):
    """The ranks' guards judged one step differently: their replicas of the
    loss or the gradient norm differ, which no replay repairs. Fatal."""


class AnomalyRollback(RuntimeError):
    """``k_rollback`` consecutive anomalous steps: the guard asks the
    supervisor for a checkpoint rollback. Classified transient."""

    def __init__(self, msg: str, rejects: int = 0, state: Any = None):
        super().__init__(msg)
        self.rejects = rejects
        # the surviving (rejection-preserved) state, for a supervisor with no
        # checkpoint on disk
        self.state = state


@dataclass(frozen=True)
class GuardConfig:
    """Static thresholds of the anomaly guard."""

    spike_factor: float = 10.0   # reject when grad_norm > factor * EMA
    ema_decay: float = 0.95      # EMA over accepted steps' grad norms
    warmup_steps: int = 10       # accepted steps before spike checks arm
    k_rollback: int = 3          # consecutive rejections -> AnomalyRollback
    metric: str = "grad_norm"    # metrics key carrying the norm (optional)


@dataclass
class GuardEvent:
    """One rejected step (kept in ``AnomalyGuard.events``)."""

    step: int            # accepted-step count when the rejection happened
    kind: str            # 'nonfinite' | 'spike'
    value: float         # the offending loss/grad-norm
    threshold: float     # the spike threshold in force (0 = not armed)
    consecutive: int     # consecutive rejections including this one

    def describe(self) -> str:
        return (f"guard: rejected step ({self.kind}: value={self.value:.4g}, "
                f"threshold={self.threshold:.4g}, consecutive={self.consecutive})")


class AnomalyGuard:
    """Wrap ``step(state, batch) -> (state, metrics)`` with anomaly detection
    and rejection, keeping its signature; ``metrics["anomalous"]`` (0/1) is
    added. Bind a port train step (it journals and judges itself once
    bound) or a functional step.

    ``rebind(step_fn)`` swaps the wrapped step (after a replan rebuild) and
    keeps the EMA, counters and event history. ``group`` (past world 1) is
    this rank's ``dist.Group``: each verdict is agreed (module docstring)."""

    def __init__(self, step_fn: Optional[Callable] = None,
                 cfg: GuardConfig = GuardConfig(),
                 log: Optional[Callable[[str], None]] = None, group: Any = None):
        self.cfg = cfg
        self.group = group
        self.log = log or (lambda s: None)
        self.ema: Optional[float] = None   # EMA of accepted grad norms
        self.accepted = 0                  # accepted steps (feeds warmup)
        self.rejected = 0                  # total rejections
        self.consecutive = 0               # current rejection streak
        self.events: List[GuardEvent] = []
        self._inner: Optional[Callable] = None
        self._verdict: Optional[Tuple[bool, Optional[GuardEvent]]] = None
        if step_fn is not None:
            self.rebind(step_fn)

    def rebind(self, step_fn: Callable) -> "AnomalyGuard":
        """(Re)bind the wrapped step; EMA/counters/events carry over. A step
        with a ``judge`` slot gets this guard as its judge. Returns self."""
        if hasattr(step_fn, "judge"):
            step_fn.judge = self._judge
        self._inner = step_fn
        return self

    @property
    def threshold(self) -> float:
        """Spike threshold currently in force (0 = disarmed)."""
        if self.ema is None or self.accepted < self.cfg.warmup_steps:
            return 0.0
        return self.cfg.spike_factor * self.ema

    def _judge(self, loss, gn) -> bool:
        """Decide one step from its loss and gradient norm (device scalars or
        floats; ``gn`` may be None). Records the verdict; True = accept."""
        thr = self.threshold
        loss = float(loss)  # the host sync
        gn = float(gn) if gn is not None else None
        nonfinite = not np.isfinite(loss) or (gn is not None and not np.isfinite(gn))
        spike = not nonfinite and gn is not None and thr > 0 and gn > thr
        if self.group is not None and self.group.world > 1:
            from repro_torch.dist.compat import agree

            every = agree([int(nonfinite), int(spike)], self.group)
            if any(v != every[0] for v in every):
                raise VerdictMismatch(
                    f"guard: the ranks judged step {self.accepted + self.rejected + 1} "
                    f"differently (nonfinite, spike by rank: {every}); rank "
                    f"{self.group.rank} read loss={loss!r} grad_norm={gn!r}")
        if not (nonfinite or spike):
            self.consecutive = 0
            self.accepted += 1
            if gn is not None:
                d = self.cfg.ema_decay
                self.ema = gn if self.ema is None else d * self.ema + (1 - d) * gn
            self._verdict = (True, None)
            return True
        if nonfinite:
            kind, value = "nonfinite", (loss if not np.isfinite(loss) else gn)
        else:
            kind, value = "spike", gn
        self.rejected += 1
        self.consecutive += 1
        ev = GuardEvent(step=self.accepted, kind=kind, value=value, threshold=thr,
                        consecutive=self.consecutive)
        self.events.append(ev)
        self.log(ev.describe())
        self._verdict = (False, ev)
        return False

    def __call__(self, state, batch) -> Tuple[Any, Dict[str, Any]]:
        if self._inner is None:
            raise RuntimeError("AnomalyGuard has no step bound; call rebind()")
        self._verdict = None
        new_state, metrics = self._inner(state, batch)
        if self._verdict is None:  # a functional step: judge it here
            self._judge(metrics["loss"], metrics.get(self.cfg.metric))
        accepted, ev = self._verdict
        if accepted:
            return new_state, {**metrics, "anomalous": 0}
        # rejected: a journaled step restored its rows in place and returns
        # the prior state; a functional step's new state is dropped
        prior = new_state if metrics.get("rejected") else state
        if self.consecutive >= self.cfg.k_rollback:
            streak, self.consecutive = self.consecutive, 0
            raise AnomalyRollback(
                f"guard: {streak} consecutive anomalous steps (last: {ev.kind} "
                f"value={ev.value:.4g}) — requesting checkpoint rollback",
                rejects=streak, state=prior)
        return prior, {**metrics, "anomalous": 1}
