"""Elastic resharding (``repro.runtime.elastic`` in torch): move a live run,
or a checkpoint, between world sizes.

PICASSO's deployment story is continuous delivery: daily retrains racing
the clock on whatever slice of the fleet is free, so the world a run starts
at is not the world it finishes (or serves) at. The packed row space does
not depend on the world (the scramble and the table offsets derive from the
raw vocabularies; only the tail padding is ``_pad_to(logical, world)``), so
a W -> W' reshard moves rows and touches no value:

1. ``core.packing.reshard_plan`` recuts each group's padded ``rows`` and
   the per-peer capacities for the new shard count; every revisable
   decision (tier budgets, strategy mix, narrow widths, ``rev``) carries;
2. ``embedding.state.reshard_state`` is the padding and sentinel surgery:
   padding rows are zero-extended or truncated (a nonzero FCounter in a
   truncated tail raises), tier keys ``>= min(r_old, r_new)`` become the new
   sentinel, every logical row, Adagrad slot, counter and resident tier
   entry is kept bitwise;
3. the move itself. The reference re-lays its logical arrays over a submesh
   (``jax.device_put``) inside one process. The port runs a process a rank,
   and rank ``r`` holds rows ``[r*rows/W, (r+1)*rows/W)``, so ``reshard_live``
   moves row blocks between the processes (``dist.sharding.recut_rows``)
   and changes the process group (``make_submesh``).

Past world 1 the processes ``dist.init_ranks`` started are the *root*
group (``dist.compat.root_group``); the live world is its first W ranks.
Every process of the root takes part in a reshard, because
``torch.distributed.new_group`` is made by all of them: the live ranks
call ``reshard_live`` with their group and state, and a process outside
the live world (a spare, or a rank that left at an earlier scale-down)
waits in ``wait_for_reshard`` until the live ranks announce one and then
calls ``reshard_live`` with ``state=None``. The call returns ``(new_plan,
new_state, new_group)`` on the ranks of the new world and ``(new_plan,
None, None)`` on the others, which hold nothing and wait again.

``restore_elastic`` is the checkpoint side: ``plan_meta`` records the world
a checkpoint was written at, so a restore at another world is detected and
routed through the same permutation instead of failing against a template
of other rows (or, worse, re-padding the tier sentinels blindly).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.packing import PicassoPlan, reshard_plan
from repro_torch.dist import compat
from repro_torch.dist.compat import WORLD1, Group
from repro_torch.dist.sharding import ROW_SHARDED, recut_rows, shard_emb_state
from repro_torch.embedding.state import migrate_state, remap_sentinels, reshard_state
from repro_torch.train import checkpoint as ckpt


def parse_mesh_shape(spec: Union[str, Sequence[int]], n_axes: int = 2) -> Tuple[int, ...]:
    """``'4x2'`` -> ``(4, 2)``; a bare ``'4'`` pads with 1s to ``n_axes``."""
    if isinstance(spec, (tuple, list)):
        shape = tuple(int(x) for x in spec)
    else:
        shape = tuple(int(x) for x in str(spec).lower().split("x"))
    if not shape or any(s <= 0 for s in shape):
        raise ValueError(f"mesh shape must be positive ints, got {spec!r}")
    if len(shape) < n_axes:
        shape = shape + (1,) * (n_axes - len(shape))
    return shape


def make_submesh(shape: Sequence[int], *, group: Optional[Group] = None) -> Optional[Group]:
    """The group of the first ``prod(shape)`` ranks of ``group`` (default: the
    root group), the counterpart of the reference's mesh over the first
    ``prod(shape)`` devices: its step group on the run's backend, its own
    gloo ``ckpt_pg`` and a fresh gate. Every process of the root calls it,
    in the same order; the ranks outside get ``None``."""
    return compat.sub_group(math.prod(int(s) for s in shape), group)


def place_state(state: Any, plan: PicassoPlan, group: Optional[Group] = None) -> Any:
    """This rank's share of a whole (world-1 layout) state under ``plan``: its
    rows of every row-sharded leaf, everything else as it is (the
    reference's ``place_state`` re-lays the state over a mesh). Takes the
    train state (``{"emb", ...}``) or the bare per-group emb dict."""
    grp = compat.resolve_group(plan.world, group)

    def place(gid, st):
        g = plan.group(int(gid))
        if int(st.w.shape[0]) != g.rows:
            raise ValueError(f"g{g.gid}: {st.w.shape[0]} rows, the plan's {g.rows}: recut "
                             "it first (embedding.state.reshard_state)")
        return shard_emb_state(st, grp)

    if isinstance(state, dict) and "emb" in state:
        return {**state, "emb": {gid: place(gid, st) for gid, st in state["emb"].items()}}
    return {gid: place(gid, st) for gid, st in state.items()}


def wait_for_reshard(root: Optional[Group] = None) -> Optional[dict]:
    """On a process outside the live world: block until the live ranks
    announce the run's next event. A reshard comes back as ``{"kind":
    "reshard", "world": W', "mesh_shape": [...], "meta": plan_meta(plan),
    ...}`` (with the ``note`` the live ranks gave), and the process then
    calls ``reshard_live(apply_plan_meta(plan, meta), None, W', ...,
    mesh_shape=...)`` with the others; the end of the run (``end_run``)
    comes back as ``None``, and a failure of the live ranks raises."""
    ev = compat.next_event(root)
    if ev.get("kind") == "failed":
        raise RuntimeError(f"the live ranks failed: {ev.get('why', '')}")
    return ev if ev.get("kind") == "reshard" else None


def end_run(ok: bool = True, why: str = "", root: Optional[Group] = None) -> None:
    """Release the processes waiting in ``wait_for_reshard`` (every live
    rank calls it once, at the run's end or on its failure)."""
    compat.announce({"kind": "end" if ok else "failed", "why": why}, root)


class _Desc:
    """A tensor leaf described for a rank that joins: its shape and dtype."""

    def __init__(self, t: torch.Tensor):
        self.shape, self.dtype = tuple(t.shape), t.dtype


def _skeleton(state: Any, rows_of) -> Any:
    """``state`` with every tensor a ``_Desc`` (a row-sharded leaf at its
    rows in the new cut, ``rows_of(name)``), every host value as it is."""
    flat = ckpt._flatten(state)
    out = {}
    for name, v in flat.items():
        if isinstance(v, torch.Tensor):
            d = _Desc(v)
            if rows_of(name) is not None:
                d.shape = (rows_of(name),) + d.shape[1:]
            out[name] = d
        else:
            out[name] = v
    return ckpt._unflatten_into(state, out)


def _leaf_rows(plan: PicassoPlan, name: str) -> Optional[int]:
    """The padded rows of the group a row-sharded leaf ``emb/<gid>/<leaf>``
    belongs to, else ``None``."""
    parts = name.split("/")
    if len(parts) == 3 and parts[0] == "emb" and parts[2] in ROW_SHARDED:
        return plan.group(int(parts[1])).rows
    return None


def _check_tail(plan: PicassoPlan, new_plan: PicassoPlan, state: Any, group: Group) -> None:
    """The old ranks' agreement that no row a recut drops holds FCounter
    mass: each checks the dropped rows it holds; every rank raises alike."""
    bad = []
    for g in plan.groups:
        r_new = new_plan.group(g.gid).rows
        if r_new >= g.rows:
            continue
        counts = state["emb"][str(g.gid)].counts
        lo = group.rank * counts.shape[0]
        cut = max(r_new - lo, 0)
        if cut < counts.shape[0] and bool(counts[cut:].ne(0).any()):
            bad.append(g.gid)
    verdicts = compat.agree([len(bad), bad[0] if bad else -1], group)
    hit = [v for v in verdicts if v[0]]
    if hit:
        gid = hit[0][1]
        raise ValueError(f"g{gid}: resharding {plan.group(gid).rows} -> "
                         f"{new_plan.group(gid).rows} rows would drop rows with nonzero "
                         "FCounter mass: the truncated tail must be pure padding")


def reshard_live(plan: PicassoPlan, state: Any, new_world: int, per_device_batch: int, *,
                 group: Optional[Group] = None,
                 mesh_shape: Optional[Sequence[int]] = None, use_cache: bool = True,
                 use_l2: bool = True, cache_update: str = "psum",
                 exact_capacity: bool = False, device: Any = None,
                 note: Optional[dict] = None) -> Tuple[PicassoPlan, Any, Optional[Group]]:
    """One-call live reshard: recut the plan, recut the state, move it.

    In one process (no ranks started) the state is the whole table: it
    comes back recut to the new padding (``migrate_state``, as the
    reference's with ``mesh=None``), with ``WORLD1`` when ``new_world`` is 1
    and no group otherwise.

    Past world 1 every process of the root group calls it (module
    docstring): a live rank with its ``group`` and ``state``, a process
    outside the live world with ``state=None`` and the ``device`` its state
    goes to if it joins. In order:

    1. ``reshard_plan`` (``exact_capacity`` as ``make_plan``'s);
    2. the old ranks check that no dropped padding row holds FCounter mass
       and agree (``dist.agree``), raising alike before anything moves;
    3. the live ranks announce the reshard (the new world and mesh, the old
       plan's ``plan_meta`` and ``note``, what a waiting process needs to
       join) and every process makes the new group (``make_submesh``);
    4. the tiers' sentinels are remapped on the ranks that hold them, and a
       rank that joins receives the skeleton (shapes and host values) and
       then every replicated leaf from rank 0;
    5. each row-sharded leaf (``w``, ``acc``, ``counts``) moves from the old
       cut to the new one (``recut_rows``: at most ``CHUNK_BYTES`` at a time;
       no rank holds more than its old rows, its new rows and one chunk).

    Replicated leaves (tiers, projection, dense, Adam, ``step``) stay as
    they are on the ranks that keep them. The caller waits for any
    checkpoint in flight first (the moves use the root's ``ckpt_pg``).
    ``use_cache``/``use_l2``/``cache_update`` mirror the engine flags, as
    ``migrate_state``'s."""
    new_plan = reshard_plan(plan, new_world, per_device_batch, mesh_shape=mesh_shape,
                            exact_capacity=exact_capacity)
    root = compat.root_group()
    if root.world == 1:
        migrated = migrate_state(plan, new_plan, state, use_cache=use_cache, use_l2=use_l2,
                                 cache_update=cache_update)
        return new_plan, migrated, (WORLD1 if new_world == 1 else None)
    w_old, w_new = int(plan.world), int(new_world)
    live = group is not None
    if live:
        compat.resolve_group(w_old, group)
        if state is None:
            raise ValueError("reshard_live: a live rank passes its state")
        _check_tail(plan, new_plan, state, group)
        from repro_torch.runtime.replanner import plan_meta

        compat.announce({**(note or {}), "kind": "reshard", "world": w_new,
                         "mesh_shape": [int(x) for x in new_plan.mesh_shape],
                         "meta": plan_meta(plan)}, root)
    new_group = make_submesh((w_new,), group=root)
    me = root.rank

    # the tiers' sentinels, on every rank that holds them
    if live:
        state = remap_tiers(new_plan, state, {g.gid: g.rows for g in plan.groups})

    # a rank that joins: the skeleton from rank 0, then the replicated leaves
    joining = w_old <= me < w_new
    if w_new > w_old:
        skel = None
        if me == 0:
            skel = _skeleton(state, lambda n: (None if _leaf_rows(new_plan, n) is None
                                               else _leaf_rows(new_plan, n) // w_new))
        if new_group is not None:
            skel = compat.ckpt_broadcast_object(skel, new_group)
        if joining:
            if device is None:
                raise ValueError("reshard_live: a joining rank passes the device its state "
                                 "goes to")
            flat = {k: (torch.zeros(v.shape, dtype=v.dtype, device=device)
                        if isinstance(v, _Desc) else v)
                    for k, v in ckpt._flatten(skel).items()}
            state = ckpt._unflatten_into(skel, flat)
    names = sorted(ckpt._flatten(state).items()) if state is not None else []
    if w_new > w_old and (me == 0 or joining):
        for k, (name, t) in enumerate(names):
            if (_leaf_rows(new_plan, name) is not None or not isinstance(t, torch.Tensor)
                    or t.numel() == 0):
                continue
            flat_t = t.reshape(-1) if t.dim() == 0 else t
            row_bytes = math.prod(flat_t.shape[1:]) * t.element_size()
            step = max(1, ckpt.CHUNK_BYTES // max(1, row_bytes))
            for q in range(w_old, w_new):
                for a in range(0, flat_t.shape[0], step):
                    part = flat_t[a:a + step]
                    if me == 0:
                        compat.send_rows(part, q, root, k)
                    elif me == q:
                        compat.recv_rows(part, 0, root, k)

    # the row-sharded leaves, from the old cut to the new
    out_rows = {}
    if state is not None:
        for k, (name, t) in enumerate(names):
            rows = _leaf_rows(new_plan, name)
            if rows is None:
                continue
            src = t if me < w_old else None
            dst = None
            if me < w_new:
                dst = (t if joining else
                       torch.zeros((rows // w_new,) + tuple(t.shape[1:]), dtype=t.dtype,
                                   device=t.device))
            recut_rows(src, dst, _leaf_rows(plan, name), w_old, rows, w_new, root, k)
            out_rows[name] = dst
    if new_group is None:
        return new_plan, None, None
    flat = ckpt._flatten(state)
    flat.update(out_rows)
    return new_plan, ckpt._unflatten_into(state, flat), new_group


def remap_tiers(plan: PicassoPlan, state: Any, old_rows: Dict[int, int]) -> Any:
    """``state`` (``{"emb", ...}``, at ``plan``'s rows) with every tier key
    at or past ``min(old_rows[gid], rows)`` set to the new sentinel, the
    group's ``rows`` (``reshard_state``'s surgery of the tiers, for a state
    whose row-sharded leaves were recut elsewhere)."""
    emb = {}
    for g in plan.groups:
        st = state["emb"][str(g.gid)]
        cut = min(int(old_rows[g.gid]), g.rows)
        emb[str(g.gid)] = st._replace(cache=remap_sentinels(st.cache, cut, g.rows),
                                      l2=remap_sentinels(st.l2, cut, g.rows))
    return {**state, "emb": emb}


def restore_elastic(ckpt_dir: str, plan: PicassoPlan, template: Any, *,
                    group: Optional[Group] = None, step: Optional[int] = None,
                    log: Optional[Callable[[str], None]] = None) -> Tuple[Any, int]:
    """Restore a checkpoint whose recorded world may differ from ``plan``'s.

    - the recorded world matches (or the meta predates world recording): a
      plain ``restore_checkpoint``; a stale-meta checkpoint at another world
      still fails, with the row-mismatch diagnosis and the pointer here;
    - the recorded world differs: at world 1 the stored rows are pulled out
      as they are (``on_row_mismatch='keep'``) and recut by
      ``reshard_state``, as the reference does; past world 1 each rank reads
      its new cut straight from the stored rows, zero past them, the ranks
      agreeing before anything is written that no dropped row holds FCounter
      mass (``checkpoint.restore_resharded``; no rank holds the whole table),
      and the tier sentinels are remapped as ``reshard_state`` remaps them.

    ``template`` is shaped by the current plan (after ``apply_plan_meta``),
    this rank's share past world 1, and every rank of ``group`` calls it.
    Without a group the template is the whole table at ``plan``'s padding,
    whatever its world (the reference's restore with ``mesh=None``)."""
    log = log or (lambda s: None)
    grp = WORLD1 if group is None else compat.resolve_group(plan.world, group)
    meta = ckpt.load_checkpoint_meta(ckpt_dir, step, group=grp)
    world_ckpt = (meta or {}).get("world")
    if world_ckpt is None or int(world_ckpt) == plan.world:
        return ckpt.restore_checkpoint(ckpt_dir, template, step=step, group=grp)
    if grp.world == 1:
        state, s = ckpt.restore_checkpoint(ckpt_dir, template, step=step,
                                           on_row_mismatch="keep")
        state = reshard_state(plan, state)
    else:
        state, s = ckpt.restore_resharded(ckpt_dir, template, step=step, group=grp)
        old = reshard_plan(plan, int(world_ckpt), 1)
        state = remap_tiers(plan, state, {g.gid: old.group(g.gid).rows for g in plan.groups})
    log(f"restored world={int(world_ckpt)} checkpoint at world={plan.world} "
        f"(resharded step {s})")
    return state, s
