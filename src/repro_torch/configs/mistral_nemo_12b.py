"""mistral-nemo-12b [hf:mistralai/Mistral-Nemo-Base-2407]. A copy of
``repro.configs.mistral_nemo_12b``.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, dense, 128k ctx.
head_dim is 128 (explicit in HF config: 5120/32=160 but Nemo uses head_dim=128).
We keep head_dim = d_model // n_heads = 160 for internal consistency of the
generic stack; the deviation is noted here.
"""
from repro_torch.configs.base import LM_SHAPES, LMConfig, register_arch
from repro_torch.configs.lm_family import FULL_ATTN_SKIP, smoke_of


def full() -> LMConfig:
    return LMConfig(
        name="mistral-nemo-12b",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=131072,
        rope_theta=1000000.0,
    )


def smoke() -> LMConfig:
    return smoke_of(full())


register_arch("mistral-nemo-12b", full, smoke, LM_SHAPES, skip_shapes=("long_500k",), skip_reason=FULL_ATTN_SKIP)
