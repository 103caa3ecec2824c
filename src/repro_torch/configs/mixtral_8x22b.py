"""mixtral-8x22b [arXiv:2401.04088]. A copy of
``repro.configs.mixtral_8x22b``.

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8 experts top-2,
sliding-window attention (sub-quadratic => long_500k supported).
"""
from repro_torch.configs.base import LM_SHAPES, LMConfig, MoESpec, register_arch
from repro_torch.configs.lm_family import smoke_of


def full() -> LMConfig:
    return LMConfig(
        name="mixtral-8x22b",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab=32768,
        moe=MoESpec(n_experts=8, top_k=2, d_ff=16384),
        swa_window=4096,
        rope_theta=1000000.0,
    )


def smoke() -> LMConfig:
    return smoke_of(full())


register_arch("mixtral-8x22b", full, smoke, LM_SHAPES)
