"""Online scoring and two-tower retrieval for WDL models
(``repro.serve.serve_step`` in torch).

Same program shape as the reference minus its ``shard_map``: the shared
``EmbeddingEngine`` runs the packed lookups (HybridHash read path and
K-Interleaving waves) -> interactions -> sigmoid scores. Retrieval scores
one user against a million candidates: the user tower (sasrec / mind) runs
through the engine and ``user_repr``, the candidate rows come from a second
engine whose bucket capacity fits one score chunk, scores are a batched
dot, and a streaming top-k merges the chunks.

Past world 1 each rank runs in a process of its own with its
``dist.Group``: a scoring rank takes the global request and scores its
slice of it (``dist.sharding.batch_slice``; the probabilities it returns
are its rows, rank-major as the reference shards them), and a retrieval
rank runs the user tower on the whole (one-user) request, scores its
``n_candidates // world`` candidates, keeps a local top-k, all_gathers the
ranks' (scores, ids) and takes the global top-k with ``lax.top_k``'s tie
order (the lower gathered index first).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch import resolve_device
from repro_torch.core.features import field_index, pack_batch
from repro_torch.core.jax_random import Rng, rng_split
from repro_torch.core.packing import PicassoPlan
from repro_torch.dist.compat import Group, all_gather_tiled, resolve_group
from repro_torch.dist.sharding import batch_slice
from repro_torch.embedding.state import init_embedding_state
from repro_torch.engine import EmbeddingEngine, EngineContext
from repro_torch.models.wdl import WDLModel


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving-side engine knobs."""

    strategy: Any = "picasso"  # registry name | 'mixed' | 'auto' | {gid: name}
    use_cache: bool = True
    use_l2: bool = True   # the L2 tier (plan-budgeted, behind L1)
    # CUDA sparse and interaction kernels: 'auto' (for tensors on the card) | 'on' | 'off'
    use_fused_kernels: Any = "auto"


def init_state(model: WDLModel, plan: PicassoPlan, rng: Rng,
               device: Union[str, torch.device] = "cuda",
               group: Optional[Group] = None) -> Dict[str, Any]:
    """Serving state ``{"emb": {str(gid): EmbeddingState}, "dense": params}``
    made on ``device`` from ``rng``: a ``torch.Generator`` on that device, or
    a ``JaxKey`` for the reference's own draws from ``PRNGKey(seed)`` (on the
    host: small tables). The counterpart of the reference's
    ``train_step.init_state`` without the optimizer state (rank ``group``'s
    rows of the masters past world 1)."""
    device = resolve_device(device)
    k1, k2 = rng_split(rng, 2)
    emb = init_embedding_state(k1, plan, device, group=group)
    return {"emb": {str(g): s for g, s in emb.items()},
            "dense": model.init_dense(k2, device)}


class ServeStep:
    """Forward-only scoring: ``step(state, batch) -> probabilities [B, n_tasks]``.
    ``score`` also returns the engine context (tier hits, routing) for the
    FCounter warm-up and the hit metrics. It runs three named stages,
    ``pack`` -> ``sparse`` -> ``dense``, which a per-layer timing calls one
    by one."""

    def __init__(self, model: WDLModel, plan: PicassoPlan, global_batch: int,
                 scfg: ServeConfig, device: torch.device, group: Optional[Group] = None):
        self.model = model
        self.plan = plan
        self.global_batch = int(global_batch)
        self.device = device
        self.group = resolve_group(plan.world, group)
        self.engine = EmbeddingEngine(plan, plan.world, strategy=scfg.strategy,
                                      use_cache=scfg.use_cache, use_l2=scfg.use_l2,
                                      use_fused_kernels=scfg.use_fused_kernels,
                                      group=self.group)

    def pack(self, batch: Dict) -> Tuple[Dict[int, Any], Dict[str, torch.Tensor]]:
        """Host batch -> one ``PackedBatch`` per group and the side tensors
        ``model.apply`` reads (``dense`` when the config has dense features,
        the sequence fields' masks), on the device: of this rank's slice."""
        b = next(iter(batch["fields"].values()))["ids"].shape[0]
        if b != self.global_batch:
            raise ValueError(f"batch of {b} samples; this step serves {self.global_batch}")
        return pack_batch(self.model.cfg, self.plan, batch_slice(batch, self.group),
                          self.device)

    @torch.no_grad()
    def sparse(self, state: Dict[str, Any], packed: Dict[int, Any]):
        """Packed lookups + pooling -> (pooled field vectors, engine context)."""
        return self.engine.forward(state["emb"], packed)

    @torch.no_grad()
    def dense(self, state: Dict[str, Any], pooled,
              side: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """Interactions + MLP -> sigmoid probabilities."""
        logits = self.model.apply(state["dense"], pooled, side, fused=self.engine.use_fused)
        return torch.sigmoid(logits)

    def score(self, state: Dict[str, Any], batch: Dict) -> Tuple[torch.Tensor, EngineContext]:
        packed, side = self.pack(batch)
        pooled, ctx = self.sparse(state, packed)
        return self.dense(state, pooled, side), ctx

    def __call__(self, state: Dict[str, Any], batch: Dict) -> torch.Tensor:
        return self.score(state, batch)[0]


def make_serve_step(model: WDLModel, plan: PicassoPlan, global_batch: int,
                    scfg: ServeConfig = ServeConfig(),
                    device: Union[str, torch.device] = "cuda",
                    group: Optional[Group] = None) -> ServeStep:
    """Forward-only scoring step: batch -> sigmoid probabilities [B, n_tasks]
    (this rank's ``B / world`` rows past world 1)."""
    return ServeStep(model, plan, global_batch, scfg, resolve_device(device), group)


class RetrievalStep:
    """Two-tower retrieval, ``step(state, batch, cand_ids) -> (scores [k],
    ids [k])``: the top ``k = min(top_k, n_candidates)`` candidates by
    ``max_k <row, user_k>``, best first.

    The user tower packs ``batch`` (one user), runs the engine and
    ``model.user_repr``. The candidates are scored in chunks of
    ``score_chunk`` (``None``/0: one chunk) through a second engine whose
    item-group capacity is ``max(capacity, chunk)``, so memory scales with
    the chunk. ``cand_ids`` are rows of the item group's packed table, looked
    up as they are (no scramble, salt or table offset), as in the reference.
    A ragged last chunk is padded with the first id and its pad scored
    ``-inf``. The running best merges with each chunk by a stable
    descending sort, so ties keep the earlier candidate, as ``lax.top_k``
    does, and chunked and unchunked retrieval return the same result.
    Retrieval runs uncached: ``scfg.use_cache`` is ignored. Past world 1
    each rank scores its ``n_candidates // world`` candidates and the local
    top-k lists merge (module docstring)."""

    def __init__(self, model: WDLModel, plan: PicassoPlan, n_candidates: int, top_k: int,
                 scfg: ServeConfig, score_chunk: Optional[int], device: torch.device,
                 group: Optional[Group] = None):
        self.model, self.plan, self.device = model, plan, device
        self.group = resolve_group(plan.world, group)
        self.n_candidates = int(n_candidates)
        self.top_k = int(top_k)
        self.cand_local = self.n_candidates // self.group.world
        chunk = int(score_chunk) if score_chunk else self.cand_local
        self.chunk = max(1, min(chunk, self.cand_local))
        self.n_chunks = -(-self.cand_local // self.chunk)
        self.k = min(int(top_k), self.cand_local)
        item_field = next(f.name for f in model.cfg.fields
                          if f.pooling == "none" and f.max_len > 1)
        self.gid = field_index(model.plan)[item_field].gid
        kw = dict(strategy=scfg.strategy, use_cache=False,
                  use_fused_kernels=scfg.use_fused_kernels)
        self.engine = EmbeddingEngine(plan, plan.world, group=self.group, **kw)
        self.cand_engine = EmbeddingEngine(
            plan, plan.world, capacity={**plan.capacity,
                                        self.gid: max(plan.capacity[self.gid], self.chunk)},
            group=self.group, **kw)

    @torch.no_grad()
    def user(self, state: Dict[str, Any], batch: Dict) -> torch.Tensor:
        """The user tower's vectors ``[K, D]``."""
        packed, side = pack_batch(self.model.cfg, self.plan, batch, self.device)
        pooled, _ = self.engine.forward(state["emb"], packed)
        return self.model.user_repr(state["dense"], pooled, side)

    @torch.no_grad()
    def __call__(self, state: Dict[str, Any], batch: Dict, cand_ids: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        user = self.user(state, batch)
        ids = cand_ids.reshape(-1).to(self.device)
        if ids.shape[0] != self.n_candidates:
            raise ValueError(f"{ids.shape[0]} candidates; this step scores "
                             f"{self.n_candidates}")
        grp = self.group
        ids = ids[grp.rank * self.cand_local:(grp.rank + 1) * self.cand_local]
        best_v = torch.full((self.k,), float("-inf"), dtype=torch.float32, device=self.device)
        best_i = torch.zeros((self.k,), dtype=ids.dtype, device=self.device)
        for c in range(self.n_chunks):
            cids = ids[c * self.chunk:(c + 1) * self.chunk]
            n_valid = cids.shape[0]
            if n_valid < self.chunk:  # the ragged last chunk
                cids = torch.cat([cids, ids[:1].expand(self.chunk - n_valid)])
            rows = self.cand_engine.lookup_rows(state["emb"], self.gid, cids)
            sc = torch.amax(rows @ user.T, dim=-1).to(torch.float32)
            sc[n_valid:] = float("-inf")
            av, ai = torch.cat([best_v, sc]), torch.cat([best_i, cids])
            top = torch.sort(av, descending=True, stable=True).indices[:self.k]
            best_v, best_i = av[top], ai[top]
        if grp.world == 1:
            return best_v, best_i
        gv, gi = all_gather_tiled(best_v, grp), all_gather_tiled(best_i, grp)
        top = torch.sort(gv, descending=True, stable=True).indices[:self.top_k]
        return gv[top], gi[top]


def make_retrieval_step(model: WDLModel, plan: PicassoPlan, n_candidates: int,
                        top_k: int = 100, scfg: ServeConfig = ServeConfig(use_cache=False),
                        score_chunk: Optional[int] = None,
                        device: Union[str, torch.device] = "cuda",
                        group: Optional[Group] = None) -> RetrievalStep:
    """Two-tower retrieval: one user -> top-k of ``n_candidates``
    (``RetrievalStep``), on ``device`` (``cuda`` unless the caller asks for
    the CPU)."""
    return RetrievalStep(model, plan, n_candidates, top_k, scfg, score_chunk,
                         resolve_device(device), group)
