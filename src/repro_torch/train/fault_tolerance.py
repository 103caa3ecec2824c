"""Fault tolerance for the training loop (``repro.train.fault_tolerance`` in
torch), at world 1 and, one process a rank, past it.

1. *Checkpoint/restart*: ``AsyncCheckpointer`` snapshots every N steps; on a
   transient step failure the supervisor restores the last *verified*
   checkpoint (per-leaf checksums; corrupt snapshots are quarantined and the
   walk falls back, ``checkpoint.restore_verified``) and rewinds the data
   stream to the restored step (``ReplayableStream``), so replay is exact.
   The port restores in place into the live state's tensors.
2. *Failure classification*: transient faults (node loss, I/O, injected
   chaos, guard rollback requests, a CUDA out-of-memory) restore and replay
   under capped exponential backoff; fatal ones re-raise at once. Beside the
   reference's fatal types the port classifies a sticky CUDA error fatal:
   it poisons the process's CUDA context, so no replay in this process can
   succeed (``torch.AcceleratorError`` where the installed torch has it,
   else a ``RuntimeError`` whose message starts with ``CUDA error``).

Past world 1 (``Supervisor(group=)``) the reference's one decision is made
by agreement: every rank runs the same loop over the same batches, and each
step's outcome on every rank (ok, the stream's end, a transient or a fatal
failure, and the step it was at) is all_gathered (``dist.agree``) twice a
step: at the step's first collective (the gate ``dist.arm_gate`` arms), or
from the error handler of a rank that failed before it, and after the
step's metrics hook and checkpoint. Every rank then takes the same verdict:
a fatal failure on any rank raises on every rank; a transient one on any
rank counts one failure against the same retry budget on every rank, backs
off alike and rolls every rank back to the same verified checkpoint
(``restore_verified(group=)``), each rank restoring its own rows in place.
That covers a failure raised outside a collective: an injected fault
(``runtime.chaos``), a guard rollback, an error in the metrics hook or the
checkpoint, an error before the step's first collective. A failure inside
the step after its first collective leaves the other ranks in a collective
this rank never joins: it ends the run when the process groups' timeout
(``dist.PG_TIMEOUT_S``) expires, as does a rank that dies, and a failed
collective (``dist.CollectiveFailure``) is never retried. Nothing more is
claimed.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.dist import compat
from repro_torch.dist.compat import WORLD1, CollectiveFailure, Group
from repro_torch.runtime.guard import VerdictMismatch
from repro_torch.train.checkpoint import AsyncCheckpointer, restore_verified

log = logging.getLogger("repro_torch.ft")


class StepFailure(RuntimeError):
    pass


# a step's outcome on one rank, as the ranks agree on it (past world 1)
OK, STOP, TRANSIENT, FATAL = 0, 1, 2, 3


class PeerFailure(RuntimeError):
    """Raised on a rank whose own step went well when the ranks' agreed
    verdict (``TRANSIENT`` or ``FATAL``) says another rank's failed."""

    def __init__(self, msg: str, verdict: int):
        super().__init__(msg)
        self.verdict = verdict


def _verdict(outcomes) -> int:
    """The one decision from every rank's (outcome, step)."""
    codes = [c for c, _ in outcomes]
    if FATAL in codes or len({st for _, st in outcomes}) > 1:
        return FATAL  # ranks out of step cannot be rolled back together
    if TRANSIENT in codes:
        return TRANSIENT
    if STOP in codes:  # every rank's stream must end at the same batch
        return STOP if all(c == STOP for c in codes) else FATAL
    return OK


#: exception types where a restore-and-replay retry cannot help: the same
#: code fails again (shape/type bugs, broken imports) or the process itself
#: is compromised (host OOM); past world 1 also ranks whose guards disagree
FATAL_TYPES = (TypeError, AttributeError, ImportError, NameError, MemoryError,
               VerdictMismatch)

#: a sticky device fault (an illegal address, a kernel's assert): the CUDA
#: context is poisoned for the rest of the process
_STICKY_CUDA = tuple(t for t in (getattr(torch, "AcceleratorError", None),) if t is not None)


def _sticky_cuda_error(e: BaseException) -> bool:
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return False  # the allocator recovers: transient, as in the reference
    if _STICKY_CUDA and isinstance(e, _STICKY_CUDA):
        return True
    return isinstance(e, RuntimeError) and str(e).startswith("CUDA error")


def classify_failure(e: BaseException) -> str:
    """'transient' (restore + replay may succeed) or 'fatal' (re-raise).

    Transient is the default: node loss, filesystem hiccups, injected chaos
    and ``AnomalyRollback`` all surface as ``RuntimeError``/``OSError``
    subclasses, and so does ``torch.cuda.OutOfMemoryError``. A sticky CUDA
    error is fatal (see the module docstring)."""
    if isinstance(e, FATAL_TYPES) or _sticky_cuda_error(e):
        return "fatal"
    return "transient"


class Supervisor:
    """Wraps a train loop with checkpoint/restart and classified, bounded
    retries. ``reset_after`` clean consecutive steps clear the failure
    counter (default: two checkpoint intervals), so the retry budget bounds
    failure density, not the total over a long run. ``salts`` (the plan's
    packing salts) go into every checkpoint's manifest; ``meta`` (the live
    plan revision) is refreshed by the trainer after each replan.
    ``shardings`` is accepted for the reference's signature: a restore lands
    in the live state's own tensors. ``group`` (past world 1) is this rank's
    ``dist.Group``: every rank runs the supervisor with it, and every
    decision is agreed (module docstring)."""

    def __init__(self, ckpt_dir: str, ckpt_every: int = 100, max_retries: int = 3,
                 keep: int = 3, backoff_s: float = 0.5, backoff_cap_s: float = 30.0,
                 reset_after: Optional[int] = None, shardings: Any = None,
                 salts: Optional[Dict[str, int]] = None, group: Optional[Group] = None):
        self.group = WORLD1 if group is None else group
        self.ckpt = AsyncCheckpointer(ckpt_dir, keep=keep, salts=salts, group=self.group)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.backoff_cap_s = backoff_cap_s
        self.reset_after = reset_after if reset_after is not None else 2 * ckpt_every
        self.failures = 0        # current failure density (resets on progress)
        self.total_failures = 0  # monotonic, for observability
        self.shardings = shardings
        self.meta: Optional[Dict[str, Any]] = None

    def _agree(self, outcome: int, step: int) -> int:
        """The ranks' verdict on this step (this rank's own at world 1)."""
        if self.group.world == 1:
            return outcome
        return _verdict(compat.agree([outcome, step], self.group))

    def _settle(self, step: int) -> None:
        """Past world 1, every rank's outcome of the step so far; raises
        ``PeerFailure`` unless all went well (the gate's agreement, and the
        one after the step)."""
        if self.group.world > 1:
            v = self._agree(OK, step)
            if v != OK:
                raise PeerFailure(f"another rank's step {step} failed "
                                  f"({'fatal' if v == FATAL else 'transient'})", v)

    def maybe_restore(self, template: Any, shardings: Any = None) -> Tuple[Any, int]:
        try:
            state, step = restore_verified(self.ckpt_dir, template, log=log.warning,
                                           group=self.group)
        except FileNotFoundError:
            return template, 0
        log.info("restored checkpoint at step %d", step)
        return state, step

    def run(self, state: Any, step_fn: Callable, batches: Iterator, n_steps: int,
            start_step: int = 0, on_metrics: Optional[Callable[[int, Dict], None]] = None,
            fail_injector: Optional[Callable[[int], None]] = None,
            shardings: Any = None) -> Any:
        """Run until step ``n_steps``; on a transient failure restore and
        replay, on a fatal one re-raise. ``fail_injector(step)`` is the hook
        that raises inside the loop to simulate node loss. A ``batches``
        with ``seek(step)`` is rewound to the restored step, so replay is
        exact; otherwise a warning notes the skipped batches.

        A rollback restores into the live state's tensors in place (the step
        updates the embedding state in place, and the 7.5 GB table is not
        copied): the state the failed step left is the template."""
        step = start_step
        stream = iter(batches)
        seekable = hasattr(batches, "seek")
        warned_no_seek = False
        clean = 0  # consecutive successful steps since the last failure
        while step < n_steps:
            try:
                # past world 1 the step's first collective agrees first, so a
                # rank that fails before it meets the others in that agreement
                compat.arm_gate(self.group, lambda at=step: self._settle(at))
                if fail_injector is not None:
                    fail_injector(step)
                batch = next(stream)
                state, metrics = step_fn(state, batch)
                gate = compat.take_gate(self.group)
                if gate is not None:  # the step made no collective
                    gate()
                step += 1
                clean += 1
                if self.failures and clean >= self.reset_after:
                    log.info("%d clean steps; resetting failure counter (was %d)",
                             clean, self.failures)
                    self.failures = 0
                if on_metrics is not None:
                    on_metrics(step, metrics)
                if step % self.ckpt_every == 0:
                    self.ckpt.save(step, state, meta=self.meta)
                self._settle(step)
            except StopIteration:
                compat.take_gate(self.group)
                if self._agree(STOP, step) == STOP:
                    break
                raise PeerFailure(f"the ranks' batch streams ended at different steps "
                                  f"(this rank's at {step})", FATAL) from None
            except CollectiveFailure:
                # the group is broken: no agreement can follow
                log.error("step %d: a collective failed; ending the run", step)
                raise
            except Exception as e:  # noqa: BLE001 — classified below
                compat.take_gate(self.group)
                own = FATAL if classify_failure(e) == "fatal" else TRANSIENT
                verdict = (e.verdict if isinstance(e, PeerFailure)
                           else self._agree(own, step))
                if verdict == FATAL:
                    if isinstance(e, PeerFailure) or own == FATAL:
                        log.error("step %d failed with fatal %s: %s — not retrying", step,
                                  type(e).__name__, e)
                        raise
                    raise PeerFailure(f"another rank's step {step} failed fatally "
                                      f"(this rank's: {type(e).__name__}: {e})",
                                      FATAL) from e
                self.failures += 1
                self.total_failures += 1
                clean = 0
                if self.failures > self.max_retries:
                    raise
                delay = min(self.backoff_s * (2 ** (self.failures - 1)), self.backoff_cap_s)
                log.warning("step %d failed (%s: %s); restoring after %.2fs backoff "
                            "(failure %d/%d)", step, type(e).__name__, e, delay,
                            self.failures, self.max_retries)
                if delay > 0:
                    time.sleep(delay)
                self.ckpt.wait()
                try:
                    state, step = restore_verified(self.ckpt_dir, state,
                                                   log=log.warning, group=self.group)
                    log.info("rolled back to step %d", step)
                except FileNotFoundError:
                    # no verifiable checkpoint yet: go on from the in-memory
                    # state (an AnomalyRollback carries the surviving one)
                    recovered = getattr(e, "state", None)
                    if recovered is not None:
                        state = recovered
                    log.warning("no verifiable checkpoint; continuing from in-memory "
                                "state at step %d", step)
                if seekable:
                    batches.seek(step)
                    stream = iter(batches)
                elif not warned_no_seek:
                    warned_no_seek = True
                    log.warning("batch stream is not seekable; batches between "
                                "checkpoint and failure steps will be skipped, replay "
                                "is NOT exact")
        self.ckpt.wait()
        return state
