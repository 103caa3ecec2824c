"""Minimal streaming driver (``repro.runtime.stream`` in torch): segments
over an unbounded batch stream.

The continuous-delivery loop PICASSO motivates (daily retrains racing the
clock) never sees a fixed ``--steps``: batches arrive indefinitely, the
trainer consumes them in *segments*, and at every segment boundary it

1. checkpoints incrementally (the segment is the failure/restart unit),
2. publishes a model delta (``publish_state``) a RUNNING serve process picks
   up without restart (``poll_published`` + ``load_published`` — the
   Merlin/HugeCTR train-to-serve handoff pattern), and
3. offers the caller a resize hook (``on_segment``) that may swap in a new
   ``(state, step_fn, stream)`` triple — the in-place elastic reshard
   (``runtime.elastic``) plugs in here, so a world-size change is just
   another segment boundary, not a restart.

The port's checkpointer snapshots the state to host before the next segment
runs (``train.checkpoint.AsyncCheckpointer``), and ``publish_state`` writes
synchronously, so neither reads a tensor a later step updates in place. A
delta loads in place into the serving state's tensors only after every leaf
has passed its checksum, header and shape checks, from files held open
until the load ends, so a torn, mis-shaped or concurrently pruned delta
never leaves the served state a mix of two deltas.
A delta shaped by another world is recut onto the consumer's plan
(``embedding.state.reshard_state``), as the reference's is; it differs from
the consumer's state only in the row-sharded leaves' rows, or it raises
before anything is written. Both run at world 1 (a serving process past
world 1 with ``--reload-dir`` is ROADMAP Queue 1 item 6.3).

Publication layout: ``publish_dir/step_<n>/`` is an ordinary checkpoint of
the serveable subset (``{"emb", "dense"}``) plus an atomically-renamed
``LATEST`` pointer file, so a poller never reads a half-written delta.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

from repro_torch.dist.sharding import row_sharded_leaf
from repro_torch.embedding.state import reshard_state
from repro_torch.train.checkpoint import (CheckpointCorrupt, SaltMismatch, WorldMismatch,
                                          _flatten, _read_manifest, _shape, available_steps,
                                          latest_step, restore_checkpoint, save_checkpoint)


def run_stream(state: Any, step_fn: Callable, batches: Iterable, *,
               segment_steps: int, n_segments: int, start_step: int = 0,
               checkpointer=None, meta_fn: Optional[Callable] = None,
               publisher: Optional[Callable] = None,
               on_metrics: Optional[Callable] = None,
               on_segment: Optional[Callable] = None,
               log: Optional[Callable] = None) -> Tuple[Any, int]:
    """Consume ``batches`` in ``n_segments`` segments of ``segment_steps``.

    Per segment boundary (in order): ``checkpointer.save(step, state,
    meta=meta_fn())`` (an ``AsyncCheckpointer`` or anything with its
    ``save`` signature), ``publisher(step, state)``, a ``[stream] segment``
    log line, then ``on_segment(seg, step, state)`` — which may return a
    replacement ``(state, step_fn, batches)`` triple to adopt (the elastic
    reshard path) or ``None`` to continue unchanged.

    A drained source ends the run early (graceful, like the launchers).
    Returns ``(state, final_step)``.
    """
    log = log or (lambda s: print(s, flush=True))
    it = iter(batches)
    step = start_step
    for seg in range(1, n_segments + 1):
        done = 0
        for _ in range(segment_steps):
            try:
                batch = next(it)
            except StopIteration:
                break
            state, m = step_fn(state, batch)
            step += 1
            done += 1
            if on_metrics is not None:
                on_metrics(step, m)
        if checkpointer is not None:
            checkpointer.save(step, state,
                              meta=meta_fn() if meta_fn is not None else None)
        if publisher is not None:
            publisher(step, state)
        log(f"[stream] segment {seg}/{n_segments}: +{done} steps -> "
            f"step {step}")
        if on_segment is not None:
            out = on_segment(seg, step, state)
            if out is not None:
                state, step_fn, batches = out
                it = iter(batches)
        if done < segment_steps:
            log(f"[stream] source drained at step {step}; stopping")
            break
    return state, step


def publish_state(publish_dir: str, step: int, state: Dict[str, Any],
                  meta: Optional[Dict[str, Any]] = None, keep: int = 2,
                  salts: Optional[Dict[str, int]] = None) -> str:
    """Publish the serveable subset of ``state`` as an atomic model delta.

    Writes ``publish_dir/step_<n>/`` ({"emb", "dense"} — no optimizer, no
    step counter) via ``save_checkpoint`` (atomic rename), then atomically
    replaces the ``LATEST`` pointer. ``meta`` is typically ``plan_meta(plan)``
    so a consumer can detect the revision/world the delta was shaped by;
    ``salts`` the plan's packing salts, which a loader checks.
    """
    doc = {"emb": state["emb"], "dense": state["dense"]}
    path = save_checkpoint(publish_dir, step, doc, keep=keep, meta=meta, salts=salts)
    d = Path(publish_dir)
    tmp = d / ".LATEST.tmp"
    tmp.write_text(f"{step}\n")
    os.replace(tmp, d / "LATEST")
    return path


def poll_published(publish_dir: str, last_step: int = -1) -> Optional[int]:
    """Newest published step strictly after ``last_step``, else ``None``.

    Cheap enough to call before every serve request: one small file read,
    no directory scan.
    """
    p = Path(publish_dir) / "LATEST"
    if not p.exists():
        return None
    try:
        s = int(p.read_text().strip())
    except (ValueError, OSError):
        s = None
    if s is not None and s > last_step:
        # LATEST may name a step whose directory was already pruned: the
        # publisher GCs old deltas (keep=) *then* swings the pointer, so a
        # poller racing a rapid double-publish can read a stale LATEST.
        if (Path(publish_dir) / f"step_{s:08d}" / "manifest.json").exists():
            return s
        s = None
    if s is None:
        # torn/stale pointer: fall back to the newest delta actually on disk
        fresh = [x for x in available_steps(publish_dir) if x > last_step]
        return fresh[-1] if fresh else None
    return None


def load_published(publish_dir: str, template: Any,
                   plan=None, step: Optional[int] = None) -> Tuple[Any, int]:
    """Load one published delta into ``template`` (the serve {"emb","dense"}
    subset), whole or not at all: every check (checksums, packing salts,
    shapes) passes before the first leaf is written (``restore_checkpoint``).
    A delta of the template's rows loads in place into its tensors.

    With ``plan``, a delta published at another world size is recut onto the
    consumer's padding (``reshard_state``: the cross-world train-to-serve
    handoff; its row-sharded leaves come back as new tensors, the tier keys
    remapped); a delta that differs in any other leaf's shape was shaped by
    another plan revision and raises ``ValueError`` before anything is
    written. Without ``plan`` a row mismatch raises ``WorldMismatch``."""
    step = step if step is not None else latest_step(publish_dir)
    if step is None:
        raise FileNotFoundError(f"no published delta under {publish_dir}")
    try:
        return restore_checkpoint(publish_dir, template, step=step, on_row_mismatch="error")
    except WorldMismatch:
        if plan is None:
            raise
    stored = _read_manifest(publish_dir, step)["leaves"]
    other = sorted(name for name, t in _flatten(template).items()
                   if name in stored and tuple(stored[name]["shape"]) != _shape(t)
                   and not row_sharded_leaf(name))
    if other:
        raise ValueError(f"published delta step {step}: {', '.join(other)} differ from this "
                         "server's plan beyond the world's rows: a delta of another plan "
                         "revision")
    state, s = restore_checkpoint(publish_dir, template, step=step, on_row_mismatch="keep")
    return reshard_state(plan, state), s


class PublishPoller:
    """Degraded-mode delta consumption for a serving process.

    ``poll(template)`` returns ``(host_state, step)`` when a *verified* new
    delta loaded cleanly, else ``None`` — and a serving loop that only swaps
    on a non-None result keeps answering from its last good state through
    every failure mode a publisher can throw at it: torn LATEST pointer,
    pruned step directory, corrupt/truncated leaf files, deltas shaped by
    another plan revision (or by another world when ``plan`` is None), or a
    publish stall. A delta packed under other salts
    (``SaltMismatch``) is not a transient fault: every later delta of that
    publisher would be too, so it raises.

    Failed loads back off by *skipping polls* (capped exponential: after f
    consecutive failures, ``min(2**f, max_backoff)`` calls return early
    without touching the filesystem), so a wedged publisher can't turn the
    request path into a disk-scan loop. A clean load resets the backoff. A
    corrupt delta's step is remembered so the poller re-considers the same
    LATEST only after the backoff window, not on every request.
    """

    def __init__(self, publish_dir: str, plan=None, *, max_backoff: int = 8,
                 log: Optional[Callable[[str], None]] = None):
        self.publish_dir = publish_dir
        self.plan = plan
        self.max_backoff = max_backoff
        self.log = log or (lambda s: None)
        self.last_step = -1      # newest step successfully swapped in
        self.failures = 0        # consecutive failed load attempts
        self.skips_left = 0      # polls to skip before retrying
        self.loads = 0           # successful hot-swaps (observability)

    def poll(self, template: Any) -> Optional[Tuple[Any, int]]:
        if self.skips_left > 0:
            self.skips_left -= 1
            return None
        step = poll_published(self.publish_dir, self.last_step)
        if step is None:
            return None
        try:
            state, s = load_published(self.publish_dir, template,
                                      plan=self.plan, step=step)
        except SaltMismatch:
            raise
        except (CheckpointCorrupt, ValueError, KeyError, FileNotFoundError) as e:
            self.failures += 1
            self.skips_left = min(2 ** self.failures, self.max_backoff)
            self.log(f"[serve] delta step {step} failed verification "
                     f"({type(e).__name__}: {e}); keeping last good state "
                     f"(step {self.last_step}), backing off "
                     f"{self.skips_left} polls")
            return None
        self.failures = 0
        self.skips_left = 0
        self.last_step = s
        self.loads += 1
        return state, s
