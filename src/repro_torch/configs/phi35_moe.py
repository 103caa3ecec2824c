"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct]. A copy of
``repro.configs.phi35_moe``.

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16 experts top-2.
"""
from repro_torch.configs.base import LM_SHAPES, LMConfig, MoESpec, register_arch
from repro_torch.configs.lm_family import FULL_ATTN_SKIP, smoke_of


def full() -> LMConfig:
    return LMConfig(
        name="phi3.5-moe-42b-a6.6b",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6400,
        vocab=32064,
        moe=MoESpec(n_experts=16, top_k=2, d_ff=6400),
        rope_theta=10000.0,
    )


def smoke() -> LMConfig:
    return smoke_of(full())


register_arch(
    "phi3.5-moe-42b-a6.6b", full, smoke, LM_SHAPES, skip_shapes=("long_500k",), skip_reason=FULL_ATTN_SKIP
)
