"""Online scoring for WDL models (``repro.serve.serve_step`` in torch).

Same program shape as the reference minus its ``shard_map``: the shared
``EmbeddingEngine`` runs the packed lookups (HybridHash read path and
K-Interleaving waves) -> interactions -> sigmoid scores. Retrieval comes
with a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch import resolve_device
from repro_torch.core.features import dense_features, pack_group
from repro_torch.core.packing import PicassoPlan
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


def init_state(model: WDLModel, plan: PicassoPlan, generator: torch.Generator,
               device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """Serving state ``{"emb": {str(gid): EmbeddingState}, "dense": params}``
    made on ``device`` from ``generator`` (which must live on that device).
    The counterpart of the reference's ``train_step.init_state`` without
    the optimizer state."""
    device = resolve_device(device)
    emb = init_embedding_state(generator, plan, device)
    return {"emb": {str(g): s for g, s in emb.items()},
            "dense": model.init_dense(generator, device)}


class ServeStep:
    """Forward-only scoring: ``step(state, batch) -> probabilities [B, n_tasks]``.
    ``score`` also returns the engine context (tier hits, routing) for the
    FCounter warm-up and the hit metrics. It runs three named stages,
    ``pack`` -> ``sparse`` -> ``dense``, which a per-layer timing calls one
    by one."""

    def __init__(self, model: WDLModel, plan: PicassoPlan, global_batch: int,
                 scfg: ServeConfig, device: torch.device):
        self.model = model
        self.plan = plan
        self.global_batch = int(global_batch)
        self.device = device
        self.engine = EmbeddingEngine(plan, plan.world, strategy=scfg.strategy,
                                      use_cache=scfg.use_cache, use_l2=scfg.use_l2,
                                      use_fused_kernels=scfg.use_fused_kernels)

    def pack(self, batch: Dict) -> Tuple[Dict[int, Any], Optional[torch.Tensor]]:
        """Host batch -> one ``PackedBatch`` per group and the dense
        features (``None`` when the config has none), on the device."""
        b = next(iter(batch["fields"].values()))["ids"].shape[0]
        if b != self.global_batch:
            raise ValueError(f"batch of {b} samples; this step serves {self.global_batch}")
        packed = {g.gid: pack_group(g, batch["fields"], self.device) for g in self.plan.groups}
        return packed, dense_features(self.model.cfg, batch, self.device)

    @torch.no_grad()
    def sparse(self, state: Dict[str, Any], packed: Dict[int, Any]):
        """Packed lookups + pooling -> (pooled field vectors, engine context)."""
        return self.engine.forward(state["emb"], packed)

    @torch.no_grad()
    def dense(self, state: Dict[str, Any], pooled,
              dense_x: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Interactions + MLP -> sigmoid probabilities."""
        logits = self.model.apply(state["dense"], pooled, {"dense": dense_x},
                                  fused=self.engine.use_fused)
        return torch.sigmoid(logits)

    def score(self, state: Dict[str, Any], batch: Dict) -> Tuple[torch.Tensor, EngineContext]:
        packed, dense_x = self.pack(batch)
        pooled, ctx = self.sparse(state, packed)
        return self.dense(state, pooled, dense_x), ctx

    def __call__(self, state: Dict[str, Any], batch: Dict) -> torch.Tensor:
        return self.score(state, batch)[0]


def make_serve_step(model: WDLModel, plan: PicassoPlan, global_batch: int,
                    scfg: ServeConfig = ServeConfig(),
                    device: Union[str, torch.device] = "cuda") -> ServeStep:
    """Forward-only scoring step: batch -> sigmoid probabilities [B, n_tasks]."""
    return ServeStep(model, plan, global_batch, scfg, resolve_device(device))
