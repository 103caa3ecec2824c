"""Wide-and-Deep-Learning model (``repro.models.wdl`` in torch), for the
``linear`` + ``fm`` + MLP wiring deepfm uses.

embedding layer (packed) -> feature-interaction modules -> MLP -> logits
(-> the BCE loss for training).
The model consumes the engine's packed group outputs
``pooled[gid]: [B, n_bags_g, D_g]`` and produces ``logits [B, n_tasks]``.
Dense parameters are a plain dict with the reference's layout, so
``repro_torch.convert`` can carry the reference's values over one to one.
Any other interaction kind raises until its slice is ported.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import WDLConfig
from repro_torch.core.features import FieldView, field_index
from repro_torch.core.packing import PicassoPlan
from repro_torch.layers import interactions as I
from repro_torch.layers.mlp import init_mlp, mlp

_PORTED = ("linear", "fm")


class WDLModel:
    def __init__(self, cfg: WDLConfig, plan: PicassoPlan):
        for it in cfg.interactions:
            if it.kind not in _PORTED:
                raise NotImplementedError(
                    f"interaction {it.kind!r} is not ported yet (this slice runs "
                    f"{', '.join(_PORTED)})")
        if cfg.n_dense or cfg.dense_arch or any(f.pooling == "none" for f in cfg.fields):
            raise NotImplementedError(
                "dense features and sequence fields are not ported yet")
        self.cfg = cfg
        self.plan = plan
        self.fidx: Dict[str, FieldView] = field_index(plan)
        self.pooled_fields = list(cfg.fields)
        self.deep_dim = sum(f.dim for f in self.pooled_fields)

    def field_emb(self, pooled: Dict[int, torch.Tensor], name: str) -> torch.Tensor:
        v = self.fidx[name]
        return pooled[v.gid][:, v.bag_offset, :]

    def init_dense(self, generator: torch.Generator, device: torch.device) -> Dict:
        cfg = self.cfg
        params: Dict[str, Dict] = {}
        for n, it in enumerate(cfg.interactions):
            if it.kind == "linear":
                params[f"i{n}_linear"] = {
                    f.name: torch.randn((f.dim, 1), generator=generator,
                                        device=device) * 0.01
                    for f in self.pooled_fields}
        params["top"] = init_mlp(generator, self.deep_dim,
                                 tuple(cfg.mlp_dims) + (cfg.n_tasks,), device)
        return params

    def apply(self, params: Dict, pooled: Dict[int, torch.Tensor],
              fused: Optional[bool] = None) -> torch.Tensor:
        """Logits ``[B, n_tasks]``; ``fused`` is the ``kernels.ops`` override
        for the FM kernel (the engine's resolved ``use_fused``)."""
        embs = [self.field_emb(pooled, f.name) for f in self.pooled_fields]
        base = torch.cat(embs, dim=-1)
        wide_logit = torch.zeros((base.shape[0], 1), dtype=base.dtype, device=base.device)
        for n, it in enumerate(self.cfg.interactions):
            if it.kind == "linear":
                # sum_f e_f @ w_f as one product over the concatenated fields
                w = torch.cat([params[f"i{n}_linear"][f.name] for f in self.pooled_fields])
                wide_logit = wide_logit + base @ w
            elif it.kind == "fm":
                by_dim: Dict[int, List[torch.Tensor]] = {}
                for f, e in zip(self.pooled_fields, embs):
                    by_dim.setdefault(f.dim, []).append(e)
                for es in by_dim.values():
                    if len(es) > 1:
                        wide_logit = wide_logit + I.fm_interaction(torch.stack(es, dim=1),
                                                                   fused=fused)
        return mlp(params["top"], base, final_act=False) + wide_logit

    def loss(self, params: Dict, pooled: Dict[int, torch.Tensor], batch: Dict,
             fused: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Summed binary cross-entropy with logits, and the logits. ``batch``
        carries ``labels`` as a tensor on the logits' device."""
        logits = self.apply(params, pooled, fused=fused)
        labels = batch["labels"]
        if labels.dim() == 1:
            labels = labels[:, None]
        labels = labels.expand(logits.shape).to(logits.dtype)
        ls = (torch.clamp(logits, min=0) - logits * labels
              + torch.log1p(torch.exp(-logits.abs())))
        return ls.sum(), logits
