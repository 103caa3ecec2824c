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
before anything is written.

Past world 1 (``group=``, every rank at once) the trainer's ranks write one
delta together, the reference's files at the same mesh (the joint writer of
``train.checkpoint``), and rank 0 swings ``LATEST`` once every rank's rows
are in. The serving ranks load a delta of their own world each into its
rows in place, and a delta of another world each straight into its new cut
of the stored rows (``checkpoint.restore_resharded``; no rank holds the
whole table). ``PublishPoller`` keeps the ranks in lockstep: rank 0 alone
reads ``LATEST`` and one small agreement a poll (``dist.agree``) gives every
rank its step, and the load's own checks end alike on every rank, so the
ranks swap in the same delta or all keep their last good state, and their
backoff counters move together. ``run_stream`` takes a change of world at a
segment boundary (``on_segment``): the ranks a scale-down drops leave the
loop, and a spare joins at the boundary for the segments that remain
(``first_segment``).

Publication layout: ``publish_dir/step_<n>/`` is an ordinary checkpoint of
the serveable subset (``{"emb", "dense"}``) plus an atomically-renamed
``LATEST`` pointer file, so a poller never reads a half-written delta.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

from repro_torch.dist import compat
from repro_torch.dist.compat import Group
from repro_torch.dist.sharding import row_sharded_leaf
from repro_torch.embedding.state import reshard_state
from repro_torch.runtime.elastic import remap_tiers
from repro_torch.train.checkpoint import (CheckpointCorrupt, SaltMismatch,
                                          _flatten, _group, _on_rank0, _read_manifest, _shape,
                                          available_steps, check_salts, latest_step,
                                          restore_checkpoint, restore_resharded,
                                          save_checkpoint)


def run_stream(state: Any, step_fn: Callable, batches: Iterable, *,
               segment_steps: int, n_segments: int, start_step: int = 0,
               first_segment: int = 1,
               checkpointer=None, meta_fn: Optional[Callable] = None,
               publisher: Optional[Callable] = None,
               on_metrics: Optional[Callable] = None,
               on_segment: Optional[Callable] = None,
               log: Optional[Callable] = None) -> Tuple[Any, int]:
    """Consume ``batches`` in ``n_segments`` segments of ``segment_steps``.

    Per segment boundary (in order): ``checkpointer.save(step, state,
    meta=meta_fn())`` (an ``AsyncCheckpointer`` or anything with its
    ``save`` signature), ``publisher(step, state)`` (past world 1 after the
    checkpointer's writer thread has finished: both use the group's
    ``ckpt_pg``), a ``[stream] segment``
    log line, then ``on_segment(seg, step, state)`` — which may return a
    replacement ``(state, step_fn, batches)`` triple to adopt (the elastic
    reshard path), or ``(state, step_fn, batches, checkpointer)`` with a
    checkpointer rebuilt on the new world's group, or ``None`` to continue
    unchanged. A replacement state of ``None`` means this rank left the
    world (a scale-down): the loop ends here and returns ``(None, step)``.
    ``first_segment`` numbers the first segment run, for a spare that joins
    a stream at a boundary (``start_step`` its step). An ``on_segment`` that
    moves rows between ranks waits for the checkpointer first.

    A drained source ends the run early (graceful, like the launchers).
    Returns ``(state, final_step)``.
    """
    log = log or (lambda s: print(s, flush=True))
    it = iter(batches)
    step = start_step
    for seg in range(first_segment, n_segments + 1):
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
            grp = getattr(checkpointer, "group", None)
            if grp is not None and grp.world > 1:
                # the joint writer and the publish share the group's ckpt_pg
                checkpointer.wait()
            publisher(step, state)
        log(f"[stream] segment {seg}/{n_segments}: +{done} steps -> "
            f"step {step}")
        if on_segment is not None:
            out = on_segment(seg, step, state)
            if out is not None:
                state, step_fn, batches = out[:3]
                if len(out) > 3:
                    checkpointer = out[3]
                if state is None:  # this rank left the world
                    return None, step
                it = iter(batches)
        if done < segment_steps:
            log(f"[stream] source drained at step {step}; stopping")
            break
    return state, step


def publish_state(publish_dir: str, step: int, state: Dict[str, Any],
                  meta: Optional[Dict[str, Any]] = None, keep: int = 2,
                  salts: Optional[Dict[str, int]] = None,
                  group: Optional[Group] = None,
                  before_latest: Optional[Callable[[], None]] = None) -> str:
    """Publish the serveable subset of ``state`` as an atomic model delta.

    Writes ``publish_dir/step_<n>/`` ({"emb", "dense"} — no optimizer, no
    step counter) via ``save_checkpoint`` (atomic rename), then atomically
    replaces the ``LATEST`` pointer. ``meta`` is typically ``plan_meta(plan)``
    so a consumer can detect the revision/world the delta was shaped by;
    ``salts`` the plan's packing salts, which a loader checks.

    Past world 1 every rank of ``group`` calls it with its state: the ranks
    write one delta together (``save_checkpoint(group=)``, which uses the
    group's ``ckpt_pg``: a checkpoint writer thread on the same group must
    have finished first), rank 0 swings ``LATEST`` once the directory holds
    every rank's rows, and every rank returns after that. ``before_latest``
    runs on every rank between the two (``ChaosController.after_publish``
    tears the delta there, so no poller reads it whole).
    """
    doc = {"emb": state["emb"], "dense": state["dense"]}
    path = save_checkpoint(publish_dir, step, doc, keep=keep, meta=meta, salts=salts,
                           group=group)
    if before_latest is not None:
        before_latest()

    def swing() -> None:
        d = Path(publish_dir)
        tmp = d / ".LATEST.tmp"
        tmp.write_text(f"{step}\n")
        os.replace(tmp, d / "LATEST")

    grp = _group(group)
    if grp.world > 1:
        _on_rank0(swing, grp)
    else:
        swing()
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


def load_published(publish_dir: str, template: Any, plan=None, step: Optional[int] = None,
                   group: Optional[Group] = None) -> Tuple[Any, int]:
    """Load one published delta into ``template`` (the serve {"emb","dense"}
    subset), whole or not at all: every check (checksums, packing salts,
    shapes) passes before the first leaf is written (``restore_checkpoint``).
    A delta of the template's rows loads in place into its tensors.

    With ``plan``, a delta published at another world size is recut onto the
    consumer's padding (the cross-world train-to-serve handoff): at world 1
    by ``reshard_state``, past world 1 by each rank reading its new cut of
    the stored rows (``restore_resharded``); either way the tier keys are
    remapped to the new sentinels. A delta that differs in any other leaf's
    shape was shaped by another plan revision and raises ``ValueError``
    before anything is written. Without ``plan`` a row mismatch raises
    ``WorldMismatch``. Past world 1 every rank of ``group`` calls it with its
    share; rank 0 reads the manifest for all, so every rank raises alike."""
    grp = _group(group)

    def read() -> Tuple[int, Dict[str, Any]]:
        s = step if step is not None else latest_step(publish_dir)
        if s is None:
            raise FileNotFoundError(f"no published delta under {publish_dir}")
        return s, _read_manifest(publish_dir, s)

    s, doc = _on_rank0(read, grp) if grp.world > 1 else read()
    check_salts(doc.get("salts"), f"published delta step {s}")
    stored = doc["leaves"]
    tflat = _flatten(template)
    other, moved = [], False
    for name, t in tflat.items():
        if name not in stored:
            continue  # the restore raises KeyError
        shape, want = tuple(stored[name]["shape"]), _shape(t)
        if row_sharded_leaf(name):
            moved |= shape[:1] != (want[0] * grp.world,)
        if shape[1:] != want[1:] or (shape != want and not row_sharded_leaf(name)):
            other.append(name)
    if other:
        raise ValueError(f"published delta step {s}: {', '.join(sorted(other))} differ from "
                         "this server's plan beyond the world's rows: a delta of another "
                         "plan revision")
    world_pub = (doc.get("meta") or {}).get("world")
    if grp.world > 1 and world_pub is not None:
        moved |= int(world_pub) != grp.world  # the same rows, cut otherwise
    if not moved or plan is None:
        return restore_checkpoint(publish_dir, template, step=s, group=grp)
    if grp.world == 1:
        state, s = restore_checkpoint(publish_dir, template, step=s, on_row_mismatch="keep")
        return reshard_state(plan, state), s
    state, s = restore_resharded(publish_dir, template, step=s, group=grp)
    old_rows = {g.gid: int(stored[f"emb/{g.gid}/w"]["shape"][0]) for g in plan.groups}
    return remap_tiers(plan, state, old_rows), s


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

    Past world 1 every rank of ``group`` polls before every request: rank 0
    alone reads ``LATEST`` and one agreement (``dist.agree``, on the step's
    group) gives every rank its step, so a rank that sees a newer pointer
    than rank 0 never loads it alone; the load's checks end with the same
    verdict on every rank (``load_published``), so every rank swaps in the
    delta or keeps its last good state, and the backoff counters move in
    lockstep. A poll that skips makes no collective.
    """

    def __init__(self, publish_dir: str, plan=None, *, max_backoff: int = 8,
                 log: Optional[Callable[[str], None]] = None,
                 group: Optional[Group] = None):
        self.publish_dir = publish_dir
        self.plan = plan
        self.group = _group(group)
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
        grp = self.group
        step = (poll_published(self.publish_dir, self.last_step)
                if grp.rank == 0 else None)
        if grp.world > 1:
            got = compat.agree([-1 if step is None else step], grp)[0][0]
            step = None if got < 0 else got
        if step is None:
            return None
        try:
            state, s = load_published(self.publish_dir, template,
                                      plan=self.plan, step=step, group=grp)
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
