"""Generic Wide-and-Deep-Learning model (``repro.models.wdl`` in torch,
paper Fig. 2), for every interaction of the reference's ``InteractionSpec``
wiring: the four recommendation archs (deepfm, dcn-v2, sasrec, mind) and
the paper's W&D, DLRM, DIN, MMoE and CAN.

embedding layer (packed) -> feature-interaction modules -> MLP -> logits
(-> the BCE loss for training).
The model consumes the engine's packed group outputs
``pooled[gid]: [B, n_bags_g, D_g]`` plus the step's side tensors (the dense
features ``dense``, through the bottom MLP ``dense_arch`` when the config
has one, and each sequence field's validity mask under
``core.features.mask_key``), and produces ``logits [B, n_tasks]``. Dense
parameters are a plain dict with the reference's layout, so
``repro_torch.convert`` can carry the reference's values over one to one.
An unknown interaction kind raises ``ValueError``, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import WDLConfig
from repro_torch.core.features import FieldView, field_index, mask_key
from repro_torch.core.jax_random import Rng, rng_fold_in, rng_normal, rng_split
from repro_torch.core.packing import PicassoPlan
from repro_torch.layers import interactions as I
from repro_torch.layers.mlp import init_mlp, mlp


class WDLModel:
    def __init__(self, cfg: WDLConfig, plan: PicassoPlan):
        self.cfg = cfg
        self.plan = plan
        self.fidx: Dict[str, FieldView] = field_index(plan)
        self.pooled_fields = [f for f in cfg.fields if f.pooling != "none"]
        self._plan_wiring()

    # ------------------------------------------------------------------ views
    def field_emb(self, pooled: Dict[int, torch.Tensor], name: str) -> torch.Tensor:
        """``[B, D]`` for a pooled field, ``[B, n_bags, D]`` for a sequence."""
        v = self.fidx[name]
        if v.n_bags == 1 and self.cfg.field_by_name(name).pooling != "none":
            return pooled[v.gid][:, v.bag_offset, :]
        return pooled[v.gid][:, v.bag_offset:v.bag_offset + v.n_bags, :]

    def field_mask(self, batch: Dict, name: str) -> torch.Tensor:
        """``[B, L]`` validity (the reference's ``weights > 0``), which the
        steps put in ``batch`` (``core.features.seq_masks``)."""
        return batch[mask_key(name)]

    # ----------------------------------------------------------------- wiring
    def _plan_wiring(self) -> None:
        """The reference's ``_plan_wiring``: linear and fm add to the wide
        logit; cross consumes ``base`` (fields + dense features); every other
        kind appends its width to the deep input, which ``base`` joins when
        no cross consumes it; mmoe puts per-task towers on top."""
        cfg = self.cfg
        dense_dim = cfg.dense_arch[-1] if cfg.dense_arch else cfg.n_dense
        self.base_dim = sum(f.dim for f in self.pooled_fields) + dense_dim
        deep_dim, self.consumed_base, self.mmoe_spec = 0, False, None
        for it in cfg.interactions:
            if it.kind in ("linear", "fm"):
                continue
            if it.kind == "cross":
                deep_dim += self.base_dim
                self.consumed_base = True
            elif it.kind == "dot":
                d0 = self.pooled_fields[0].dim
                nf = (sum(f.dim == d0 for f in self.pooled_fields)
                      + (1 if dense_dim == d0 else 0))
                deep_dim += nf * (nf - 1) // 2
            elif it.kind == "self_attn_seq":
                deep_dim += 3 * self._dim(it)
            elif it.kind == "target_attn":
                hists = [f for f in it.fields if cfg.field_by_name(f).pooling == "none"]
                deep_dim += len(hists) * cfg.field_by_name(hists[0]).dim
            elif it.kind == "capsule":
                deep_dim += 2 * self._dim(it)
            elif it.kind == "gru":
                deep_dim += self._dim(it)
            elif it.kind == "coaction":
                deep_dim += it.kwargs.get("layers", (4, 4))[-1]
            elif it.kind == "mmoe":
                self.mmoe_spec = it
            else:
                raise ValueError(f"unknown interaction {it.kind}")
        self.deep_dim = deep_dim + (0 if self.consumed_base else self.base_dim)

    def _dim(self, it) -> int:
        return self.cfg.field_by_name(it.fields[0]).dim

    # ------------------------------------------------------------------- init
    def init_dense(self, rng: Rng, device: torch.device) -> Dict:
        """The dense parameters, drawn from a ``torch.Generator`` on
        ``device`` or, from a ``JaxKey``, as the reference's ``init_dense``
        draws them (its key tree, ``core.jax_random``)."""
        cfg = self.cfg
        params: Dict[str, Any] = {}
        key, *ks = rng_split(rng, len(cfg.interactions) + 2)
        ki = iter(ks)
        if cfg.dense_arch:
            params["bottom"] = init_mlp(next(ki), cfg.n_dense, cfg.dense_arch, device)
        for n, it in enumerate(cfg.interactions):
            name = f"i{n}_{it.kind}"
            if it.kind == "linear":
                k = next(ki)
                params[name] = {f.name: rng_normal(rng_fold_in(k, i), (f.dim, 1), device) * 0.01
                                for i, f in enumerate(self.pooled_fields)}
            elif it.kind == "cross":
                params[name] = I.init_cross(next(ki), self.base_dim,
                                            it.kwargs.get("n_layers", 3), device)
            elif it.kind == "self_attn_seq":
                params[name] = I.init_self_attn_seq(next(ki), self._dim(it),
                                                    it.kwargs.get("n_blocks", 2),
                                                    it.kwargs.get("n_heads", 1), device)
            elif it.kind == "target_attn":
                params[name] = I.init_target_attn(next(ki), self._dim(it), device)
            elif it.kind == "capsule":
                params[name] = I.init_capsule(next(ki), self._dim(it),
                                              it.kwargs.get("n_interests", 4), device)
            elif it.kind == "gru":
                params[name] = I.init_gru(next(ki), self._dim(it), device)
            elif it.kind == "mmoe":
                params[name] = I.init_mmoe(next(ki), self.deep_dim,
                                           it.kwargs.get("n_experts", 4),
                                           it.kwargs.get("expert_dim", 64), cfg.n_tasks,
                                           device)
        if self.mmoe_spec is not None:
            ed = self.mmoe_spec.kwargs.get("expert_dim", 64)
            for t in range(cfg.n_tasks):
                key, k2 = rng_split(key, 2)
                params[f"task{t}"] = init_mlp(k2, ed, tuple(cfg.mlp_dims) + (1,), device)
        else:
            key, k2 = rng_split(key, 2)
            params["top"] = init_mlp(k2, self.deep_dim,
                                     tuple(cfg.mlp_dims) + (cfg.n_tasks,), device)
        return params

    # ------------------------------------------------------------------ apply
    def _capsules(self, params: Dict, pooled, batch: Dict, n: int, it) -> torch.Tensor:
        hist_f = it.fields[0]
        return I.capsule_routing(params[f"i{n}_capsule"], self.field_emb(pooled, hist_f),
                                 self.field_mask(batch, hist_f),
                                 it.kwargs.get("routing_iters", 3), I.ROUTING_KEY,
                                 n_interests=it.kwargs.get("n_interests", 4))

    def _sasrec(self, params: Dict, pooled, batch: Dict, n: int, it) -> torch.Tensor:
        hist_f, pos_f = it.fields[:2]
        seq = self.field_emb(pooled, hist_f) + self.field_emb(pooled, pos_f)
        return I.self_attn_seq(params[f"i{n}_self_attn_seq"], seq,
                               self.field_mask(batch, hist_f),
                               n_heads=it.kwargs.get("n_heads", 1))

    def apply(self, params: Dict, pooled: Dict[int, torch.Tensor],
              batch: Optional[Dict] = None, fused: Optional[bool] = None) -> torch.Tensor:
        """Logits ``[B, n_tasks]``. ``batch`` carries the dense features
        ``[B, n_dense]`` under ``dense`` when the config has any and each
        sequence field's mask under ``mask_key(name)``, as tensors on the
        logits' device; ``fused`` is the ``kernels.ops`` override for the FM,
        dot and cross kernels (the engine's resolved ``use_fused``)."""
        cfg = self.cfg
        batch = batch or {}
        ref = next(iter(pooled.values()))
        b = ref.shape[0]
        dense_proc = None
        if cfg.n_dense > 0:
            dense_proc = (mlp(params["bottom"], batch["dense"]) if cfg.dense_arch
                          else batch["dense"])
        embs = [self.field_emb(pooled, f.name) for f in self.pooled_fields]
        fields_cat = (torch.cat(embs, dim=-1) if embs
                      else torch.zeros((b, 0), dtype=ref.dtype, device=ref.device))
        base = (torch.cat([fields_cat, dense_proc], dim=-1) if dense_proc is not None
                else fields_cat)
        wide_logit = torch.zeros((b, 1), dtype=ref.dtype, device=ref.device)
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
            elif it.kind == "self_attn_seq":
                r = self._sasrec(params, pooled, batch, n, it)
                tgt = self.field_emb(pooled, it.fields[2])
                wide_logit = wide_logit + torch.sum(r * tgt, dim=-1, keepdim=True)
                deep_parts += [r, tgt, r * tgt]
            elif it.kind == "target_attn":
                tgt = self.field_emb(pooled, it.fields[-1])
                for fn in it.fields[:-1]:
                    deep_parts.append(I.target_attn(params[f"i{n}_target_attn"],
                                                    self.field_emb(pooled, fn), tgt,
                                                    self.field_mask(batch, fn)))
            elif it.kind == "capsule":
                tgt = self.field_emb(pooled, it.fields[1])
                caps = self._capsules(params, pooled, batch, n, it)
                deep_parts += [I.label_aware_attn(caps, tgt), tgt]
            elif it.kind == "gru":
                fn = it.fields[0]
                deep_parts.append(I.gru(params[f"i{n}_gru"], self.field_emb(pooled, fn),
                                        self.field_mask(batch, fn)))
            elif it.kind == "coaction":
                hist_f, tgt_f = it.fields
                deep_parts.append(I.coaction(self.field_emb(pooled, hist_f),
                                             self.field_emb(pooled, tgt_f),
                                             self.field_mask(batch, hist_f),
                                             it.kwargs.get("layers", (4, 4))))
        if not self.consumed_base:
            deep_parts = [base] + deep_parts
        deep_in = deep_parts[0] if len(deep_parts) == 1 else torch.cat(deep_parts, dim=-1)
        if self.mmoe_spec is not None:
            n = list(cfg.interactions).index(self.mmoe_spec)
            towers = I.mmoe(params[f"i{n}_mmoe"], deep_in)
            logits = torch.cat([mlp(params[f"task{t}"], towers[t], final_act=False)
                                for t in range(cfg.n_tasks)], dim=-1)
        else:
            logits = mlp(params["top"], deep_in, final_act=False)
        return logits + wide_logit

    # -------------------------------------------------------------- retrieval
    def user_repr(self, params: Dict, pooled: Dict[int, torch.Tensor], batch: Dict
                  ) -> torch.Tensor:
        """User-tower vectors for two-tower retrieval: ``[B, D]`` from the
        SASRec encoder (``[1, D]`` for one user), MIND's first sample's
        ``[K, D]`` interests, else the mean of the pooled field vectors."""
        for n, it in enumerate(self.cfg.interactions):
            if it.kind == "self_attn_seq":
                return self._sasrec(params, pooled, batch, n, it)
            if it.kind == "capsule":
                return self._capsules(params, pooled, batch, n, it)[0]
        embs = [self.field_emb(pooled, f.name) for f in self.pooled_fields]
        return torch.mean(torch.stack(embs, 0), 0)

    # ------------------------------------------------------------------- loss
    def loss(self, params: Dict, pooled: Dict[int, torch.Tensor], batch: Dict,
             fused: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Summed binary cross-entropy with logits, and the logits. ``batch``
        carries ``labels`` (broadcast across the tasks) and the side tensors
        ``apply`` reads, on the logits' device."""
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
