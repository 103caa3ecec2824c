"""Fault tolerance for the training loop (``repro.train.fault_tolerance`` in
torch), at world 1.

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
"""
from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.train.checkpoint import AsyncCheckpointer, restore_verified

log = logging.getLogger("repro_torch.ft")


class StepFailure(RuntimeError):
    pass


#: exception types where a restore-and-replay retry cannot help: the same
#: code fails again (shape/type bugs, broken imports) or the process itself
#: is compromised (host OOM).
FATAL_TYPES = (TypeError, AttributeError, ImportError, NameError, MemoryError)

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
    ``shardings`` is accepted for the reference's signature: at world 1 a
    restore lands in the live state's own tensors."""

    def __init__(self, ckpt_dir: str, ckpt_every: int = 100, max_retries: int = 3,
                 keep: int = 3, backoff_s: float = 0.5, backoff_cap_s: float = 30.0,
                 reset_after: Optional[int] = None, shardings: Any = None,
                 salts: Optional[Dict[str, int]] = None):
        self.ckpt = AsyncCheckpointer(ckpt_dir, keep=keep, salts=salts)
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

    def maybe_restore(self, template: Any, shardings: Any = None) -> Tuple[Any, int]:
        try:
            state, step = restore_verified(self.ckpt_dir, template, log=log.warning)
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
                if fail_injector is not None:
                    fail_injector(step)
                batch = next(stream)
                state, metrics = step_fn(state, batch)
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
            except StopIteration:
                break
            except Exception as e:  # noqa: BLE001 — classified below
                if classify_failure(e) == "fatal":
                    log.error("step %d failed with fatal %s: %s — not retrying", step,
                              type(e).__name__, e)
                    raise
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
                                                   log=log.warning)
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
