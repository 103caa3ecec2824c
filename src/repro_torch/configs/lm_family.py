"""Shared helpers for the five LM-family architectures (a copy of
``repro.configs.lm_family``)."""
from repro_torch.configs.base import LMConfig, MoESpec

FULL_ATTN_SKIP = (
    "long_500k requires sub-quadratic attention; this arch uses pure full "
    "(GQA) attention, so the 524288-token decode cell is skipped per the "
    "assignment note (see DESIGN.md §6)."
)


def smoke_of(cfg: LMConfig) -> LMConfig:
    """Reduced same-family config: tiny widths, few layers, same structure."""
    moe = None
    if cfg.moe is not None:
        moe = MoESpec(n_experts=min(4, cfg.moe.n_experts), top_k=min(2, cfg.moe.top_k), d_ff=64)
    return LMConfig(
        name=cfg.name + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=128,
        vocab=256,
        moe=moe,
        swa_window=16 if cfg.swa_window else None,
        rope_theta=cfg.rope_theta,
        dtype="float32",
    )
