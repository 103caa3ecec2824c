"""Config dataclasses + arch/shape registry (copy of ``repro.configs.base``,
WDL part only: deepfm, dcn-v2, sasrec and mind).

Every registered architecture has a ``full()`` (exact public config) and a
``smoke()`` (reduced same-family config for CPU tests) plus its shape set.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Sequence, Tuple


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

    def field_by_name(self, name: str) -> FeatureField:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(name)


@dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell. ``kind`` selects which step runs."""

    name: str
    kind: str  # 'train' | 'serve' | 'retrieval'
    dims: Dict[str, int] = field(default_factory=dict)

    def __getitem__(self, k: str) -> int:
        return self.dims[k]


RECSYS_SHAPES = (
    ShapeSpec("train_batch", "train", {"batch": 65536}),
    ShapeSpec("serve_p99", "serve", {"batch": 512}),
    ShapeSpec("serve_bulk", "serve", {"batch": 262144}),
    ShapeSpec("retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 1_000_000}),
)


_REGISTRY: Dict[str, Dict[str, Any]] = {}


def register_arch(arch_id: str, full: Callable[[], Any], smoke: Callable[[], Any],
                  shapes: Sequence[ShapeSpec]) -> None:
    _REGISTRY[arch_id] = {"full": full, "smoke": smoke, "shapes": tuple(shapes)}


def get_config(arch_id: str, smoke: bool = False) -> Any:
    _ensure_loaded()
    try:
        entry = _REGISTRY[arch_id]
    except KeyError:
        raise ValueError(
            f"arch {arch_id!r} is not ported yet; available: "
            f"{', '.join(list_archs())}") from None
    return entry["smoke"]() if smoke else entry["full"]()


def get_shapes(arch_id: str) -> Tuple[ShapeSpec, ...]:
    _ensure_loaded()
    return _REGISTRY[arch_id]["shapes"]


def list_archs() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    # importing an arch module runs its register_arch call
    from repro_torch.configs import dcn_v2, deepfm, mind, sasrec  # noqa: F401
