"""EmbeddingEngine: the one owner of PICASSO's packed sparse path
(``repro.engine.engine`` in torch, forward + L1 flush).

    EmbeddingEngine(plan, world=1, strategy=<name>)
        .forward(emb, packed)          -> (pooled, ctx)     # K-interleaved
        .flush(emb)                    -> emb'              # HybridHash flush
        .lookup_rows(emb, gid, ids)    -> rows              # raw per-id rows

``forward`` runs the planner's K-Interleaving waves and pools each packed
group into ``pooled[gid]: [B, n_bags, D]``. Strategy is a per-group
property: the engine owns a ``Dict[gid, LookupStrategy]``. The HybridHash
hot tier participates only where the strategy has ``uses_cache`` AND the
plan budgets ``cache_rows`` for that gid (``make_plan(enable_cache=False)``
budgets none), and ``flush`` skips every other group. The flush writes the
tier back to the master first (the reference's ``'psum'`` mode).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.core import packed_embedding as pe
from repro_torch.core.features import PackedBatch
from repro_torch.core.interleaving import wave_barrier
from repro_torch.core.packing import PicassoPlan
from repro_torch.embedding.state import EmbeddingState
from repro_torch.engine.strategies import LookupStrategy, get_strategy
from repro_torch.kernels import ops

AUTO_NAMES = ("mixed", "auto")


def resolve_assignment(plan: PicassoPlan, spec: Any) -> Dict[int, str]:
    """gid -> strategy name for a broadcast registry name, validated against
    the port's registry. The reference's per-group cost-model assignment
    (``'mixed'``/``'auto'``, explicit dicts) comes with a later slice."""
    if not isinstance(spec, str) or spec in AUTO_NAMES:
        raise NotImplementedError(
            f"strategy {spec!r}: only broadcast registry names are ported; "
            "'mixed'/'auto' and per-group assignments come with a later slice")
    get_strategy(spec)
    return {g.gid: spec for g in plan.groups}


class EngineContext(NamedTuple):
    """What a ``forward`` call leaves for statistics passes."""

    ctxs: Dict[int, Any]            # gid -> strategy lookup ctx
    packed: Dict[int, PackedBatch]  # gid -> the packed batch it served


class EmbeddingEngine:
    """Owns the sparse path for one PicassoPlan on one rank.

    strategy: a registry name, broadcast to every group.
    use_fused_kernels: ``'auto'`` (CUDA kernels for tensors on the card,
        plain versions on the CPU), ``'on'``/``True``, ``'off'``/``False``;
        resolved once here by ``kernels.ops.resolve_fused``.
    """

    def __init__(self, plan: PicassoPlan, world: int = 1, *, strategy: Any = "picasso",
                 use_fused_kernels: Any = "auto"):
        if int(plan.world) != int(world):
            raise ValueError(
                f"plan was compiled for world={plan.world} but the engine is "
                f"built for world={world}")
        pe._require_single_rank(world)
        self.plan = plan
        self.world = world
        self.use_fused = ops.resolve_fused(use_fused_kernels)
        self.assignment: Dict[int, str] = resolve_assignment(plan, strategy)
        names = sorted(set(self.assignment.values()))
        insts: Dict[str, LookupStrategy] = {
            name: get_strategy(name)(world=world, capacity=dict(plan.capacity),
                                     use_fused=self.use_fused)
            for name in names}
        self.strategies: Dict[int, LookupStrategy] = {
            gid: insts[name] for gid, name in self.assignment.items()}
        self.cache_on: Dict[int, bool] = {
            g.gid: bool(self.strategies[g.gid].uses_cache
                        and plan.cache_rows.get(g.gid, 0) > 0)
            for g in plan.groups}
        self.waves = plan.interleave

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
                    emb[str(gid)], gid, ids_in[gid], cache_on=self.cache_on[gid])
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
            emb[str(gid)], gid, ids, cache_on=self.cache_on[gid])
        return rows_u[ctx.inv.long()]

    # --------------------------------------------------------------- flush
    def flush(self, emb: Dict[str, EmbeddingState]) -> Dict[str, EmbeddingState]:
        """HybridHash flush (Algorithm 1 L23-26) for every cached group. The
        master ``w``/``acc``/``counts`` are updated in place (see
        ``pe.flush_cache``); the returned dict carries the new tiers."""
        out = dict(emb)
        for g in self.plan.groups:
            if not self.cache_on.get(g.gid, False):
                continue
            st = out[str(g.gid)]
            w2, acc2, counts2, cache2 = pe.flush_cache(
                st.w, st.acc, st.counts, st.cache, world=self.world)
            out[str(g.gid)] = EmbeddingState(w2, acc2, counts2, cache2, st.l2)
        return out
