"""Wide-and-Deep-Learning model (``repro.models.wdl`` in torch), for the
``linear`` + ``fm`` + MLP wiring deepfm uses, the cross network + MLP
wiring of dcn-v2 and DLRM's bottom MLP + pairwise dots + MLP.

embedding layer (packed) -> feature-interaction modules -> MLP -> logits
(-> the BCE loss for training).
The model consumes the engine's packed group outputs
``pooled[gid]: [B, n_bags_g, D_g]`` plus the batch's dense features (through
the bottom MLP ``dense_arch`` when the config has one), and produces
``logits [B, n_tasks]``. Dense parameters are a plain dict with the
reference's layout, so ``repro_torch.convert`` can carry the reference's
values over one to one. Any other interaction kind and sequence fields
raise until their slices are ported.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import WDLConfig
from repro_torch.core.features import FieldView, field_index
from repro_torch.core.packing import PicassoPlan
from repro_torch.layers import interactions as I
from repro_torch.layers.mlp import init_mlp, mlp

_PORTED = ("linear", "fm", "cross", "dot")


class WDLModel:
    def __init__(self, cfg: WDLConfig, plan: PicassoPlan):
        for it in cfg.interactions:
            if it.kind not in _PORTED:
                raise NotImplementedError(
                    f"interaction {it.kind!r} is not ported yet (the port runs "
                    f"{', '.join(_PORTED)})")
        if any(f.pooling == "none" for f in cfg.fields):
            raise NotImplementedError("sequence fields are not ported yet")
        self.cfg = cfg
        self.plan = plan
        self.fidx: Dict[str, FieldView] = field_index(plan)
        self.pooled_fields = list(cfg.fields)
        # the reference's wiring for the ported kinds: linear and fm add to
        # the wide logit; cross consumes ``base`` (fields + dense features,
        # through the bottom MLP when there is one); dot adds the pairwise
        # dots of the fields of the first field's width (and of the dense
        # side when it has that width); otherwise ``base`` feeds the MLP too
        dense_dim = cfg.dense_arch[-1] if cfg.dense_arch else cfg.n_dense
        self.base_dim = sum(f.dim for f in self.pooled_fields) + dense_dim
        d0 = self.pooled_fields[0].dim
        n_dot = (sum(f.dim == d0 for f in self.pooled_fields)
                 + (1 if dense_dim == d0 else 0))
        self.consumed_base = any(it.kind == "cross" for it in cfg.interactions)
        widths = {"cross": self.base_dim, "dot": n_dot * (n_dot - 1) // 2}
        self.deep_dim = (sum(widths.get(it.kind, 0) for it in cfg.interactions)
                         + (0 if self.consumed_base else self.base_dim))

    def field_emb(self, pooled: Dict[int, torch.Tensor], name: str) -> torch.Tensor:
        v = self.fidx[name]
        return pooled[v.gid][:, v.bag_offset, :]

    def init_dense(self, generator: torch.Generator, device: torch.device) -> Dict:
        cfg = self.cfg
        params: Dict[str, Dict] = {}
        if cfg.dense_arch:
            params["bottom"] = init_mlp(generator, cfg.n_dense, cfg.dense_arch, device)
        for n, it in enumerate(cfg.interactions):
            if it.kind == "linear":
                params[f"i{n}_linear"] = {
                    f.name: torch.randn((f.dim, 1), generator=generator,
                                        device=device) * 0.01
                    for f in self.pooled_fields}
            elif it.kind == "cross":
                params[f"i{n}_cross"] = I.init_cross(generator, self.base_dim,
                                                     it.kwargs.get("n_layers", 3), device)
        params["top"] = init_mlp(generator, self.deep_dim,
                                 tuple(cfg.mlp_dims) + (cfg.n_tasks,), device)
        return params

    def apply(self, params: Dict, pooled: Dict[int, torch.Tensor],
              batch: Optional[Dict] = None, fused: Optional[bool] = None) -> torch.Tensor:
        """Logits ``[B, n_tasks]``. ``batch["dense"]`` carries the dense
        features ``[B, n_dense]`` as a tensor on the logits' device when the
        config has any; ``fused`` is the ``kernels.ops`` override for the FM,
        dot and cross kernels (the engine's resolved ``use_fused``)."""
        cfg = self.cfg
        dense_proc = None
        if cfg.n_dense > 0:
            dense_proc = (mlp(params["bottom"], batch["dense"]) if cfg.dense_arch
                          else batch["dense"])
        embs = [self.field_emb(pooled, f.name) for f in self.pooled_fields]
        fields_cat = torch.cat(embs, dim=-1)
        base = (torch.cat([fields_cat, dense_proc], dim=-1) if dense_proc is not None
                else fields_cat)
        wide_logit = torch.zeros((base.shape[0], 1), dtype=base.dtype, device=base.device)
        deep_parts: List[torch.Tensor] = []
        for n, it in enumerate(cfg.interactions):
            if it.kind == "linear":
                # sum_f e_f @ w_f as one product over the concatenated fields
                w = torch.cat([params[f"i{n}_linear"][f.name] for f in self.pooled_fields])
                wide_logit = wide_logit + fields_cat @ w
            elif it.kind == "fm":
                by_dim: Dict[int, List[torch.Tensor]] = {}
                for f, e in zip(self.pooled_fields, embs):
                    by_dim.setdefault(f.dim, []).append(e)
                for es in by_dim.values():
                    if len(es) > 1:
                        wide_logit = wide_logit + I.fm_interaction(torch.stack(es, dim=1),
                                                                   fused=fused)
            elif it.kind == "dot":
                d0 = self.pooled_fields[0].dim
                es = [e for f, e in zip(self.pooled_fields, embs) if f.dim == d0]
                if dense_proc is not None and dense_proc.shape[-1] == d0:
                    es.append(dense_proc)
                deep_parts.append(I.dot_interaction(torch.stack(es, dim=1), fused=fused))
            elif it.kind == "cross":
                deep_parts.append(I.cross_net(params[f"i{n}_cross"], base, fused=fused))
        if not self.consumed_base:
            deep_parts = [base] + deep_parts
        deep_in = deep_parts[0] if len(deep_parts) == 1 else torch.cat(deep_parts, dim=-1)
        return mlp(params["top"], deep_in, final_act=False) + wide_logit

    def loss(self, params: Dict, pooled: Dict[int, torch.Tensor], batch: Dict,
             fused: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Summed binary cross-entropy with logits, and the logits. ``batch``
        carries ``labels`` (and ``dense`` when the config has dense
        features) as tensors on the logits' device."""
        logits = self.apply(params, pooled, batch, fused=fused)
        labels = batch["labels"]
        if labels.dim() == 1:
            labels = labels[:, None]
        labels = labels.expand(logits.shape).to(logits.dtype)
        # the reference's gradient conventions at a logit of exactly 0, where
        # a sample whose every hidden unit is dead lands: jnp.maximum splits
        # the gradient (0.5, as torch.maximum does; clamp gives 1) and
        # jnp.abs takes the positive branch (1; torch.abs gives 0)
        pos = torch.maximum(logits, torch.zeros_like(logits))
        mag = torch.where(logits >= 0, logits, -logits)
        ls = pos - logits * labels + torch.log1p(torch.exp(-mag))
        return ls.sum(), logits
