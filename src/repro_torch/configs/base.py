"""Config dataclasses + arch/shape registry (copy of ``repro.configs.base``:
the WDL archs deepfm, dcn-v2, sasrec and mind, the five LM-family archs and
schnet).

Every registered architecture has a ``full()`` (exact public config) and a
``smoke()`` (reduced same-family config for CPU tests) plus its shape set.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class FeatureField:
    """One sparse categorical feature field.

    vocab:    number of rows in this field's embedding table
    dim:      embedding dimension
    max_len:  ids per sample (1 = one-hot; >1 = multi-hot/behaviour sequence)
    pooling:  'sum' | 'mean' | 'none' (none keeps the sequence)
    """

    name: str
    vocab: int
    dim: int
    max_len: int = 1
    pooling: str = "sum"
    group: str = "default"  # interaction-module group this field feeds
    shared_table: str = ""  # if set, this field reads another field's table


@dataclass(frozen=True)
class InteractionSpec:
    """One feature-interaction submodule (paper Fig. 2)."""

    kind: str  # 'linear' | 'fm' | 'cross' | 'dot' | 'self_attn_seq' | 'target_attn'
    #            | 'capsule' | 'gru' | 'coaction' | 'mmoe
    fields: Tuple[str, ...] = ()  # field names it consumes ('' = all)
    kwargs: Dict[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class WDLConfig:
    """Wide-and-Deep Learning model (the paper's target family)."""

    name: str
    fields: Tuple[FeatureField, ...]
    n_dense: int  # numeric features
    interactions: Tuple[InteractionSpec, ...]
    mlp_dims: Tuple[int, ...]
    dense_arch: Tuple[int, ...] = ()  # bottom MLP for numeric features
    n_tasks: int = 1
    dtype: str = "float32"

    @property
    def kind(self) -> str:
        return "wdl"

    def field_by_name(self, name: str) -> FeatureField:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(name)


@dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff: int


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    moe: Optional[MoESpec] = None
    swa_window: Optional[int] = None  # sliding-window attention (sub-quadratic)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False

    @property
    def kind(self) -> str:
        return "lm"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def _attn(self) -> int:
        d, h = self.d_model, self.head_dim
        return d * (self.n_heads * h) + 2 * d * (self.n_kv_heads * h) + (self.n_heads * h) * d

    def _emb(self) -> int:
        return self.vocab * self.d_model * (1 if self.tie_embeddings else 2)

    def param_count(self) -> int:
        """Total parameter count N (for 6*N*D model flops)."""
        d = self.d_model
        if self.moe is not None:
            ff = self.moe.n_experts * 3 * d * self.moe.d_ff + d * self.moe.n_experts
        else:
            ff = 3 * d * self.d_ff
        return self.n_layers * (self._attn() + ff + 2 * d) + self._emb() + d

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE top-k)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        ff = self.moe.top_k * 3 * d * self.moe.d_ff + d * self.moe.n_experts
        return self.n_layers * (self._attn() + ff + 2 * d) + self._emb() + d


@dataclass(frozen=True)
class SchNetConfig:
    name: str
    n_interactions: int
    d_hidden: int
    n_rbf: int
    cutoff: float
    d_feat: int = 0  # input node feature dim (0 -> learned species embedding)
    n_species: int = 100
    dtype: str = "float32"

    @property
    def kind(self) -> str:
        return "gnn"


@dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell. ``kind`` selects which step runs."""

    name: str
    kind: str  # 'train' | 'prefill' | 'decode' | 'serve' | 'retrieval' | 'graph_full'
    #            | 'graph_minibatch' | 'graph_batched'
    dims: Dict[str, int] = field(default_factory=dict)

    def __getitem__(self, k: str) -> int:
        return self.dims[k]


LM_SHAPES = (
    ShapeSpec("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    ShapeSpec("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    ShapeSpec("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    ShapeSpec("long_500k", "decode", {"seq_len": 524288, "global_batch": 1}),
)

RECSYS_SHAPES = (
    ShapeSpec("train_batch", "train", {"batch": 65536}),
    ShapeSpec("serve_p99", "serve", {"batch": 512}),
    ShapeSpec("serve_bulk", "serve", {"batch": 262144}),
    ShapeSpec("retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 1_000_000}),
)


GNN_SHAPES = (
    ShapeSpec("full_graph_sm", "graph_full", {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433}),
    ShapeSpec(
        "minibatch_lg",
        "graph_minibatch",
        {"n_nodes": 232965, "n_edges": 114615892, "batch_nodes": 1024, "fanout0": 15, "fanout1": 10},
    ),
    ShapeSpec("ogb_products", "graph_full", {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100}),
    ShapeSpec("molecule", "graph_batched", {"n_nodes": 30, "n_edges": 64, "batch": 128}),
)


_REGISTRY: Dict[str, Dict[str, Any]] = {}


def register_arch(arch_id: str, full: Callable[[], Any], smoke: Callable[[], Any],
                  shapes: Sequence[ShapeSpec], skip_shapes: Sequence[str] = (),
                  skip_reason: str = "") -> None:
    _REGISTRY[arch_id] = {"full": full, "smoke": smoke, "shapes": tuple(shapes),
                          "skip_shapes": tuple(skip_shapes), "skip_reason": skip_reason}


def get_config(arch_id: str, smoke: bool = False) -> Any:
    _ensure_loaded()
    try:
        entry = _REGISTRY[arch_id]
    except KeyError:
        raise ValueError(
            f"arch {arch_id!r} is not ported yet; available: "
            f"{', '.join(list_archs())}") from None
    return entry["smoke"]() if smoke else entry["full"]()


def get_shapes(arch_id: str, include_skipped: bool = False) -> Tuple[ShapeSpec, ...]:
    _ensure_loaded()
    entry = _REGISTRY[arch_id]
    if include_skipped:
        return entry["shapes"]
    return tuple(s for s in entry["shapes"] if s.name not in entry["skip_shapes"])


def skipped_shapes(arch_id: str) -> Tuple[Tuple[str, str], ...]:
    _ensure_loaded()
    e = _REGISTRY[arch_id]
    return tuple((s, e["skip_reason"]) for s in e["skip_shapes"])


def list_archs() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    # importing an arch module runs its register_arch call
    from repro_torch.configs import (dcn_v2, deepfm, mind, mistral_nemo_12b,  # noqa: F401
                                     mixtral_8x22b, phi35_moe, sasrec, schnet,
                                     stablelm_16b, yi_34b)
