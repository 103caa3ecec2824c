"""Deterministic fault injection (``repro.runtime.chaos`` in torch): prove
the recovery paths, don't hope.

A fault-tolerance subsystem that has never seen a fault is a comment, not a
feature. ``FaultPlan`` schedules four fault species at exact step indices so
CI can drive the *entire* train→checkpoint→publish→serve pipeline through
its failure matrix and assert each recovery end-to-end:

- ``nan@i``   — batch ``i``'s labels/dense features become NaN (the guard
                must reject the step, keep state, continue);
- ``crash@i`` — a ``ChaosFailure`` raised before step ``i`` (the Supervisor
                must classify transient, restore a verified checkpoint, and
                rewind the stream);
- ``ckpt@i``  — the newest checkpoint written at/after step ``i`` gets a
                leaf file truncated on disk (restore must detect the
                checksum mismatch, quarantine, fall back);
- ``torn@i``  — the published delta at/after step ``i`` is torn mid-file
                (the serve poller must keep the last good state).

Every fault is **one-shot**: it fires once at its configured index and never
again, *including after a rollback replays the same index*. That models
transient corruption (a flipped batch, a dying node) rather than a
deterministic poison pill — and it is what makes the recovery contract
testable: a guarded run through a ``FaultPlan`` must converge to the exact
state of a clean run, because every injected fault is either rejected
(state untouched) or rolled back and replayed clean.

Spec syntax (``--chaos``): comma-separated ``kind@step`` tokens, e.g.
``"nan@7,nan@8,crash@13,ckpt@20,torn@45"``.

Past world 1 every rank holds a controller with the same plan
(``ChaosController(plan, group=)``) and the faults stay one fault each, as
the reference's one process injects them: ``nan@`` poisons the *global*
batch, before the train step takes the rank's slice of it
(``dist.sharding.batch_slice``), so every rank's slice is poisoned;
``crash@`` raises on every rank at the same step, which the ranks'
``Supervisor`` turns into one agreed rollback; ``ckpt@`` waits for the
checkpoint every rank writes and then rank 0 alone mangles one leaf file
of it, once. ``torn@`` belongs to publishing, which runs at world 1 only.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, FrozenSet, Iterator, Optional, Set

import numpy as np

log = logging.getLogger("repro_torch.chaos")

_KINDS = ("nan", "crash", "ckpt", "torn")


class ChaosFailure(RuntimeError):
    """An injected crash; classified transient by the Supervisor."""


@dataclass(frozen=True)
class FaultPlan:
    """Step indices per fault species (empty plan = no-op)."""

    nan_batch: FrozenSet[int] = frozenset()
    crash: FrozenSet[int] = frozenset()
    corrupt_ckpt: FrozenSet[int] = frozenset()
    torn_publish: FrozenSet[int] = frozenset()

    def __bool__(self) -> bool:
        return bool(self.nan_batch or self.crash or self.corrupt_ckpt
                    or self.torn_publish)


def parse_fault_plan(spec: str) -> FaultPlan:
    """``"nan@7,crash@13,ckpt@20,torn@45"`` -> FaultPlan."""
    sets: Dict[str, Set[int]] = {k: set() for k in _KINDS}
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        try:
            kind, at = tok.split("@")
            sets[kind].add(int(at))
        except (ValueError, KeyError):
            raise ValueError(
                f"bad chaos token {tok!r}: want kind@step with kind in "
                f"{_KINDS}") from None
    return FaultPlan(nan_batch=frozenset(sets["nan"]),
                     crash=frozenset(sets["crash"]),
                     corrupt_ckpt=frozenset(sets["ckpt"]),
                     torn_publish=frozenset(sets["torn"]))


def poison_batch(batch: Dict) -> Dict:
    """NaN the numeric targets of one batch (labels + dense features).

    Works on host numpy batches (the port's streams yield them) and on
    tensors alike: a scalar multiply makes fresh buffers, so the poisoned
    batch never aliases the clean one.
    """
    out = dict(batch)
    keys = [k for k in ("labels", "dense") if k in batch]
    if not keys:  # non-WDL batch (toy harnesses): poison every float leaf
        keys = [k for k, v in batch.items()
                if (v.is_floating_point() if hasattr(v, "is_floating_point")
                    else hasattr(v, "dtype") and np.issubdtype(v.dtype, np.floating))]
    for k in keys:
        out[k] = batch[k] * float("nan")
    return out


def corrupt_checkpoint_file(ckpt_dir: str, step: Optional[int] = None) -> Optional[str]:
    """Truncate the first leaf file of a checkpoint to half its bytes —
    guaranteed checksum mismatch, i.e. a torn write / bad disk sector.
    Returns the mangled path, or None if there was nothing to corrupt."""
    from repro_torch.train.checkpoint import available_steps

    steps = available_steps(ckpt_dir)
    if not steps:
        return None
    s = step if step is not None else steps[-1]
    d = Path(ckpt_dir) / f"step_{s:08d}"
    leaves = sorted(p for p in d.iterdir() if p.name != "manifest.json")
    if not leaves:
        return None
    target = leaves[0]
    data = target.read_bytes()
    target.write_bytes(data[: max(1, len(data) // 2)])
    log.warning("[chaos] corrupted checkpoint leaf %s (%d -> %d bytes)",
                target, len(data), len(data) // 2)
    return str(target)


def tear_published(publish_dir: str) -> Optional[str]:
    """Tear the delta the LATEST pointer names (same truncation as
    ``corrupt_checkpoint_file`` but aimed at the publish dir)."""
    p = Path(publish_dir) / "LATEST"
    if not p.exists():
        return None
    try:
        step = int(p.read_text().strip())
    except (ValueError, OSError):
        return None
    return corrupt_checkpoint_file(publish_dir, step=step)


class ChaosStream:
    """Wrap a batch stream, poisoning the configured indices one-shot.

    Forwards ``seek``/``close``/``pos`` so it stacks transparently on a
    ``ReplayableStream`` under a ``Supervisor``. The fired-set is *not*
    reset by seek: a replay after rollback sees the clean batch.
    """

    def __init__(self, inner: Iterator, nan_batch: FrozenSet[int],
                 start: int = 0):
        self.inner = inner
        self.nan_batch = nan_batch
        self.pos = getattr(inner, "pos", start)
        self.fired: Set[int] = set()

    def __iter__(self):
        return self

    def __next__(self):
        i = self.pos
        batch = next(self.inner)
        self.pos = getattr(self.inner, "pos", i + 1)
        if i in self.nan_batch and i not in self.fired:
            self.fired.add(i)
            log.warning("[chaos] poisoning batch %d with NaN", i)
            return poison_batch(batch)
        return batch

    def seek(self, step: int) -> "ChaosStream":
        if hasattr(self.inner, "seek"):
            self.inner.seek(step)
        self.pos = step
        return self

    def rewrap(self, make_iter: Callable[[int], Iterator]) -> "ChaosStream":
        if hasattr(self.inner, "rewrap"):
            self.inner.rewrap(make_iter)
        return self

    def close(self):
        if hasattr(self.inner, "close"):
            self.inner.close()


class ChaosController:
    """One-stop wiring of a ``FaultPlan`` into a training launcher.

    - ``wrap_stream(stream)``: poison NaN-batch indices;
    - ``injector(step)``: raise ``ChaosFailure`` at crash indices (plug
      into ``Supervisor.run(fail_injector=...)``);
    - ``after_checkpoint(step, ckpt_dir, ckpt)``: once per configured
      ``ckpt@c`` with ``step >= c``, flush the async writer and mangle the
      newest checkpoint on disk (past world 1, on rank 0 of ``group``, once
      every rank's writer has finished, which ``ckpt.wait()`` implies);
    - ``after_publish(step, publish_dir)``: same pattern for ``torn@t``.

    All one-shot; ``fired`` survives rollback replays (see module doc).
    """

    def __init__(self, plan: FaultPlan, group: Any = None):
        self.plan = plan
        self.group = group
        self.fired: Set[str] = set()

    def wrap_stream(self, stream: Iterator) -> Iterator:
        if not self.plan.nan_batch:
            return stream
        return ChaosStream(stream, self.plan.nan_batch)

    def injector(self, step: int) -> None:
        if step in self.plan.crash and f"crash@{step}" not in self.fired:
            self.fired.add(f"crash@{step}")
            log.warning("[chaos] injecting crash at step %d", step)
            raise ChaosFailure(f"injected crash at step {step}")

    def after_checkpoint(self, step: int, ckpt_dir: str, ckpt=None) -> None:
        for c in sorted(self.plan.corrupt_ckpt):
            if step >= c and f"ckpt@{c}" not in self.fired:
                if ckpt is not None:
                    ckpt.wait()  # the file must exist before we can maul it
                if self.group is not None and self.group.world > 1:
                    # every rank sees the same renamed steps once its writer
                    # is done; rank 0 alone tears the newest
                    from repro_torch.train.checkpoint import available_steps

                    if available_steps(ckpt_dir):
                        if self.group.rank == 0:
                            corrupt_checkpoint_file(ckpt_dir)
                        self.fired.add(f"ckpt@{c}")
                    continue
                # armed until a checkpoint actually lands on disk: a
                # ``ckpt@c`` between two save intervals waits for the next one
                if corrupt_checkpoint_file(ckpt_dir) is not None:
                    self.fired.add(f"ckpt@{c}")

    def after_publish(self, step: int, publish_dir: str) -> None:
        for t in sorted(self.plan.torn_publish):
            if step >= t and f"torn@{t}" not in self.fired:
                log.warning("[chaos] tearing published delta at step %d", step)
                if tear_published(publish_dir) is not None:
                    self.fired.add(f"torn@{t}")
