"""yi-34b [arXiv:2403.04652] — llama-arch GQA. A copy of
``repro.configs.yi_34b``.

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000, dense.
"""
from repro_torch.configs.base import LM_SHAPES, LMConfig, register_arch
from repro_torch.configs.lm_family import FULL_ATTN_SKIP, smoke_of


def full() -> LMConfig:
    return LMConfig(
        name="yi-34b",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=20480,
        vocab=64000,
        rope_theta=5000000.0,
    )


def smoke() -> LMConfig:
    return smoke_of(full())


register_arch("yi-34b", full, smoke, LM_SHAPES, skip_shapes=("long_500k",), skip_reason=FULL_ATTN_SKIP)
