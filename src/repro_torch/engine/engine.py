"""EmbeddingEngine: the one owner of PICASSO's packed sparse path
(``repro.engine.engine`` in torch, with the L1 tier).

    EmbeddingEngine(plan, world=1, strategy=<name>, group=None)
        .forward(emb, packed)          -> (pooled, ctx)     # K-interleaved
        .backward(emb, ctx, g_pooled)  -> (emb', metrics)   # transposed path
        .flush(emb)                    -> emb'              # HybridHash flush
        .lookup_rows(emb, gid, ids)    -> rows              # raw per-id rows

``forward`` runs the planner's K-Interleaving waves and pools each packed
group into ``pooled[gid]: [B, n_bags, D]``. Strategy is a per-group
property: the engine owns a ``Dict[gid, LookupStrategy]``, and ``strategy=``
takes a registry name (broadcast to every group), ``'mixed'``/``'auto'``
(the plan's recorded assignment, else one compiled by ``core.assign`` and
recorded on the plan), or a ``{gid: name}`` dict or ``StrategyAssignment``
covering exactly the plan's gids. The HybridHash hot tier participates
only where ``use_cache`` is on, the strategy has ``uses_cache`` AND the plan
budgets ``cache_rows`` for that gid (``make_plan(enable_cache=False)``
budgets none). The L2 tier sits strictly behind it: on only where
``use_l2`` is on, L1 is active, the strategy has ``uses_l2`` and the plan
budgets ``l2_rows``. ``flush`` skips every group without an active L1 tier,
a ``ps`` group's budgeted tier among them. In ``'psum'`` mode the flush
writes the tiers back to the master first; in ``'stale'`` mode the master
is already exact and is not overwritten. ``backward`` and ``flush`` update
the state's tensors in place. A plan that narrows a group's master (a
recorded ``'picasso_narrow'`` assignment) can only be driven by
``'picasso_narrow'``. With more than one strategy class, the metrics add
per-class sums (``overflow/<name>``, ``cache_hits/<name>``).

Past world 1 the engine runs on one rank of a ``dist.Group`` (one process
per rank, the group where the reference passes ``axes``): the state holds
this rank's rows of each master, every collective spans the group, and the
metrics ``backward`` returns are this rank's sums, which the callers sum
over the ranks (``train.train_step``), as the reference's do.
"""
from __future__ import annotations

import functools
import operator
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import packed_embedding as pe
from repro_torch.core.assign import StrategySpec, resolve_assignment
from repro_torch.core.features import PackedBatch
from repro_torch.core.interleaving import wave_barrier
from repro_torch.core.packing import PicassoPlan
from repro_torch.dist.compat import WORLD1, Group, all_gather_tiled, resolve_group
from repro_torch.embedding.state import EmbeddingState
from repro_torch.engine.strategies import LookupStrategy, get_strategy
from repro_torch.kernels import ops
from repro_torch.optim import grad_compression as gcomp


def export_stats(plan: PicassoPlan, emb: Dict[str, EmbeddingState],
                 group: Optional[Group] = None) -> Dict[int, np.ndarray]:
    """Harvest the live FCounter: ``gid -> counts`` (host numpy, the full
    logical array). The measurement half of the replanning loop
    (``runtime.replanner``): the counts feed ``compile_assignment(plan,
    stats=...)`` and the stats-driven ``plan_cache``/``plan_l2`` re-budget.
    Past world 1 every rank of ``group`` (its ``dist.Group``; without one
    the state is the world-1 layout) calls it together: each group's
    counter shards are all_gathered in rank order into the logical array,
    so every rank holds the same stats. Call between steps; it copies each
    counter to the host (751 MB for full-width deepfm, on every rank)."""
    grp = WORLD1 if group is None else group
    return {g.gid: all_gather_tiled(emb[str(g.gid)].counts, grp).detach().cpu().numpy()
            for g in plan.groups}


class EngineContext(NamedTuple):
    """What a ``forward`` call leaves for statistics passes."""

    ctxs: Dict[int, Any]            # gid -> strategy lookup ctx
    packed: Dict[int, PackedBatch]  # gid -> the packed batch it served


class EmbeddingEngine:
    """Owns the sparse path for one PicassoPlan on one rank.

    strategy: a registry name (broadcast), ``'mixed'``/``'auto'`` (use or
        compile a per-group assignment), a ``{gid: name}`` dict or a
        ``StrategyAssignment`` (see ``core.assign``).
    use_cache / use_l2 / use_interleave: the HybridHash tier, the L2 tier
        behind it and K-Interleaving waves (False: no tier; one wave of
        every group).
    lr_emb / eps: the row-wise Adagrad of the sparse update.
    cache_update: ``'psum'`` (tier authoritative) or ``'stale'``.
    use_fused_kernels: ``'auto'`` (CUDA kernels for tensors on the card,
        plain versions on the CPU), ``'on'``/``True``, ``'off'``/``False``;
        resolved once here by ``kernels.ops.resolve_fused``.
    grad_compress: wire compression of the routed sparse-gradient payload
        (``'none' | 'fp16' | 'topk'``, see ``optim.grad_compression``),
        validated here and handed to every strategy.
    capacity: optional per-gid override of the bucket capacity (a
        retrieval candidate tower looks up a score chunk of ids, far more
        than the batch the plan was sized for); ``None`` takes the plan's.
    group: this rank's ``dist.Group``; required past world 1, ``None`` at
        world 1.
    """

    def __init__(self, plan: PicassoPlan, world: int = 1, *,
                 strategy: StrategySpec = "picasso",
                 use_cache: bool = True, use_l2: bool = True, use_interleave: bool = True,
                 lr_emb: float = 0.05, eps: float = 1e-8, cache_update: str = "psum",
                 use_fused_kernels: Any = "auto", grad_compress: str = "none",
                 capacity: Optional[Dict[int, int]] = None, group: Optional[Group] = None):
        if int(plan.world) != int(world):
            raise ValueError(
                f"plan was compiled for world={plan.world} but the engine is "
                f"built for world={world}")
        self.group = resolve_group(world, group)
        if cache_update not in ("psum", "stale"):
            raise ValueError(f"cache_update must be 'psum' or 'stale', got {cache_update!r}")
        self.plan = plan
        self.world = world
        self.cache_update = cache_update
        self.use_fused = ops.resolve_fused(use_fused_kernels)
        self.grad_compress = gcomp.validate_routed_mode(grad_compress)
        # gid -> registry name; a compiled 'mixed'/'auto' assignment is
        # recorded on the plan, so the host flush gates tiers identically
        self.assignment: Dict[int, str] = resolve_assignment(
            plan, strategy, world=world, use_cache=use_cache)
        # a narrow master is [rows, d]; every other strategy reads [rows, D]
        for g in plan.groups:
            if (plan.narrow_width(g.gid) < g.dim
                    and self.assignment.get(g.gid) != "picasso_narrow"):
                raise ValueError(
                    f"g{g.gid}: the plan narrows this group's master to width "
                    f"{plan.narrow_width(g.gid)} (< dim {g.dim}), but this engine "
                    f"assigns {self.assignment.get(g.gid)!r}; narrow state is only "
                    "readable through 'picasso_narrow'")
        names = tuple(sorted(set(self.assignment.values())))
        self.strategy_names = names
        self.strategy_name = names[0] if len(names) == 1 else "mixed"
        cap = dict(capacity if capacity is not None else plan.capacity)
        insts: Dict[str, LookupStrategy] = {
            name: get_strategy(name)(world=world, capacity=cap,
                                     lr=lr_emb, eps=eps, cache_update=cache_update,
                                     use_fused=self.use_fused,
                                     grad_compress=self.grad_compress, group=self.group)
            for name in names}
        self.strategies: Dict[int, LookupStrategy] = {
            gid: insts[name] for gid, name in self.assignment.items()}
        self.cache_on: Dict[int, bool] = {
            g.gid: bool(use_cache and self.strategies[g.gid].uses_cache
                        and plan.cache_rows.get(g.gid, 0) > 0)
            for g in plan.groups}
        # L2 sits strictly behind L1: an inactive hot tier turns it off too
        self.l2_on: Dict[int, bool] = {
            g.gid: bool(use_l2 and self.cache_on[g.gid]
                        and self.strategies[g.gid].uses_l2
                        and plan.l2_rows.get(g.gid, 0) > 0)
            for g in plan.groups}
        self.any_cache = any(self.cache_on.values())
        self._extra_keys = tuple(sorted(
            {k for n in names for k in get_strategy(n).extra_metric_keys}))
        self.waves = (plan.interleave if use_interleave
                      else [[g.gid for g in plan.groups]])

    def export_stats(self, emb: Dict[str, EmbeddingState]) -> Dict[int, np.ndarray]:
        """Module-level ``export_stats`` bound to this engine's plan and group."""
        return export_stats(self.plan, emb, self.group)

    @property
    def metric_keys(self) -> Tuple[str, ...]:
        """The metric keys ``backward`` emits: totals, per-class sums when
        the assignment mixes classes, and the strategies' per-tier keys
        (``cache_hits/l1``, ``cache_hits/l2``)."""
        keys = ["overflow", "cache_hits"]
        if len(self.strategy_names) > 1:
            keys += [f"overflow/{n}" for n in self.strategy_names]
            keys += [f"cache_hits/{n}" for n in self.strategy_names]
        return tuple(keys) + self._extra_keys

    # ------------------------------------------------------------- forward
    def _wave_lookups(self, emb: Dict[str, EmbeddingState],
                      packed: Dict[int, PackedBatch]
                      ) -> Tuple[Dict[int, torch.Tensor], Dict[int, Any]]:
        """Per-group lookups in K-Interleaving waves (Fig. 8c)."""
        rows: Dict[int, torch.Tensor] = {}
        ctxs: Dict[int, Any] = {}
        ids_in = {g.gid: packed[g.gid].ids for g in self.plan.groups}
        for wi, wave in enumerate(self.waves):
            if wi > 0:
                prev = self.waves[wi - 1]
                flat = wave_barrier([rows[g] for g in prev] + [ids_in[g] for g in wave])
                for g, v in zip(prev, flat[: len(prev)]):
                    rows[g] = v
                for j, g in enumerate(wave):
                    ids_in[g] = flat[len(prev) + j]
            for gid in wave:
                rows[gid], ctxs[gid] = self.strategies[gid].lookup(
                    emb[str(gid)], gid, ids_in[gid], cache_on=self.cache_on[gid],
                    l2_on=self.l2_on[gid])
        return rows, ctxs

    def forward(self, emb: Dict[str, EmbeddingState], packed: Dict[int, PackedBatch]
                ) -> Tuple[Dict[int, torch.Tensor], EngineContext]:
        """Packed batch -> pooled group outputs ``[B, n_bags, D]`` + ctx."""
        rows, ctxs = self._wave_lookups(emb, packed)
        pooled = {}
        for gid, pb in packed.items():
            g = self.plan.group(gid)
            b = pb.ids.shape[0] // g.ids_per_sample
            p = pe.pool(rows[gid], ctxs[gid].inv, pb.weights, pb.seg,
                        b * g.n_bags, fused=self.use_fused)
            pooled[gid] = p.reshape(b, g.n_bags, g.dim)
        return pooled, EngineContext(ctxs=ctxs, packed=dict(packed))

    def lookup_rows(self, emb: Dict[str, EmbeddingState], gid: int,
                    ids: torch.Tensor) -> torch.Tensor:
        """Raw per-id rows ``[n, D]`` for one group (retrieval towers)."""
        rows_u, ctx = self.strategies[gid].lookup(
            emb[str(gid)], gid, ids, cache_on=self.cache_on[gid], l2_on=self.l2_on[gid])
        return rows_u[ctx.inv.long()]

    # ------------------------------------------------------------ backward
    def backward(self, emb: Dict[str, EmbeddingState], ctx: EngineContext,
                 g_pooled: Dict[int, torch.Tensor]
                 ) -> Tuple[Dict[str, EmbeddingState], Dict[str, torch.Tensor]]:
        """Pooled grads -> sparse updates, in place. Returns (emb', metrics).

        The SegmentReduction of ``forward`` is linear in the looked-up rows,
        so its transpose is explicit: one ``ops.segment_grad`` pass, along
        the ctx's carried sort (no sort of its own), gives the
        ``[n_rows, D]`` row grads, which each group's strategy applies.
        With a mixed assignment, ``overflow/<name>`` and ``cache_hits/<name>``
        break the totals down per strategy class (see ``metric_keys``).
        """
        emb = dict(emb)
        dev = next(iter(g_pooled.values())).device
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        ovf = {n: zero for n in self.strategy_names}
        hits = {n: zero for n in self.strategy_names}
        extra = {k: zero for k in self._extra_keys}
        for gid, g_p in g_pooled.items():
            pb = ctx.packed[gid]
            gctx = ctx.ctxs[gid]
            name = self.assignment[gid]
            g_flat = g_p.reshape(-1, g_p.shape[-1]).contiguous()
            g_rows = ops.segment_grad(g_flat, pb.seg, pb.weights, gctx.inv,
                                      pb.ids.shape[0], fused=self.use_fused,
                                      order=gctx.order, sorted_inv=gctx.slot_sorted)
            st2, o, h = self.strategies[gid].apply_grads(
                emb[str(gid)], gid, gctx, g_rows, cache_on=self.cache_on[gid],
                l2_on=self.l2_on[gid])
            emb[str(gid)] = st2
            ovf[name] = ovf[name] + o
            hits[name] = hits[name] + h
            for k, v in self.strategies[gid].tier_metrics(gctx).items():
                extra[k] = extra[k] + v
        # a single class's sums are the totals as they are, with no extra add
        metrics = {"overflow": functools.reduce(operator.add, ovf.values()),
                   "cache_hits": functools.reduce(operator.add, hits.values())}
        if len(self.strategy_names) > 1:
            for n in self.strategy_names:
                metrics[f"overflow/{n}"] = ovf[n]
                metrics[f"cache_hits/{n}"] = hits[n]
        metrics.update(extra)
        return emb, metrics

    def journal(self, emb: Dict[str, EmbeddingState], ctx: EngineContext, j: Any) -> None:
        """Save into ``j`` every row ``backward(emb, ctx, ...)`` may write:
        each group's strategy journals its own writes (``journal`` beside
        its ``apply_grads``), under the flags ``backward`` passes it."""
        for gid, gctx in ctx.ctxs.items():
            self.strategies[gid].journal(j, emb[str(gid)], gctx, cache_on=self.cache_on[gid],
                                         l2_on=self.l2_on[gid])

    # --------------------------------------------------------------- flush
    def flush(self, emb: Dict[str, EmbeddingState]) -> Dict[str, EmbeddingState]:
        """HybridHash flush (Algorithm 1 L23-26) for every group with an
        active L1 tier. The master ``w``/``acc``/``counts`` are updated in
        place; the returned dict carries the new tiers. Narrow masters take
        the re-widening flush (``pe.flush_cache_narrow``; a missing L2 tier,
        or one switched off by ``use_l2``, flushes as an empty one and is
        carried on unchanged), groups with an active L2 the two-tier flush,
        the rest the L1 flush. The tiers are written
        back first only in ``'psum'`` mode."""
        out = dict(emb)
        wb = self.cache_update == "psum"
        for g in self.plan.groups:
            if not self.cache_on.get(g.gid, False):
                continue
            st = out[str(g.gid)]
            if st.proj is not None:
                # a tier training never maintained (switched off, or absent)
                # flushes as an empty tier and is carried on unchanged: its
                # stale rows must not overwrite the master rows trained since
                l2_live = st.l2 is not None and self.l2_on.get(g.gid, False)
                l2t = st.l2 if l2_live else pe.init_cache(
                    0, g.dim, g.rows, st.cache.rows.dtype, device=st.cache.rows.device)
                w2, acc2, counts2, cache2, l22 = pe.flush_cache_narrow(
                    st.w, st.acc, st.counts, st.cache, l2t, st.proj.kernel,
                    world=self.world, write_back=wb, group=self.group)
                out[str(g.gid)] = EmbeddingState(
                    w2, acc2, counts2, cache2, l22 if l2_live else st.l2, st.proj)
            elif self.l2_on.get(g.gid, False) and st.l2 is not None:
                w2, acc2, counts2, cache2, l22 = pe.flush_cache_l2(
                    st.w, st.acc, st.counts, st.cache, st.l2, world=self.world,
                    write_back=wb, group=self.group)
                out[str(g.gid)] = EmbeddingState(w2, acc2, counts2, cache2, l22)
            else:
                w2, acc2, counts2, cache2 = pe.flush_cache(
                    st.w, st.acc, st.counts, st.cache, world=self.world, write_back=wb,
                    group=self.group)
                out[str(g.gid)] = EmbeddingState(w2, acc2, counts2, cache2, st.l2)
        return out
