"""stablelm-1.6b [hf:stabilityai/stablelm-2-1_6b]. A copy of
``repro.configs.stablelm_16b``.

24L d_model=2048 32H (GQA kv=32 => MHA) d_ff=5632 vocab=100352, dense.
"""
from repro_torch.configs.base import LM_SHAPES, LMConfig, register_arch
from repro_torch.configs.lm_family import FULL_ATTN_SKIP, smoke_of


def full() -> LMConfig:
    return LMConfig(
        name="stablelm-1.6b",
        n_layers=24,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=5632,
        vocab=100352,
        rope_theta=10000.0,
    )


def smoke() -> LMConfig:
    return smoke_of(full())


register_arch("stablelm-1.6b", full, smoke, LM_SHAPES, skip_shapes=("long_500k",), skip_reason=FULL_ATTN_SKIP)
