"""sasrec [arXiv:1808.09781], a copy of ``repro.configs.sasrec``.

embed_dim=50 n_blocks=2 n_heads=1 seq_len=50, self-attention over the user's
behaviour sequence. Industrial-scale item catalogue (10M items).
"""
from repro_torch.configs.base import (RECSYS_SHAPES, FeatureField, InteractionSpec,
                                      WDLConfig, register_arch)

ITEM_VOCAB = 10_000_000
SEQ_LEN = 50


def _cfg(item_vocab, dim, mlp, seq_len) -> WDLConfig:
    return WDLConfig(
        name="sasrec",
        fields=(
            # behaviour history: sequence kept un-pooled, consumed by self-attn
            FeatureField("hist_items", vocab=item_vocab, dim=dim, max_len=seq_len, pooling="none", group="seq"),
            # positional embedding for the sequence
            FeatureField("pos", vocab=seq_len, dim=dim, max_len=seq_len, pooling="none", group="seq"),
            # target item shares the item table
            FeatureField("target_item", vocab=item_vocab, dim=dim, max_len=1, pooling="sum",
                         group="target", shared_table="hist_items"),
        ),
        n_dense=0,
        interactions=(
            InteractionSpec(
                "self_attn_seq",
                fields=("hist_items", "pos", "target_item"),
                kwargs={"n_blocks": 2, "n_heads": 1, "seq_len": seq_len, "causal": True},
            ),
        ),
        mlp_dims=mlp,
    )


def full() -> WDLConfig:
    return _cfg(ITEM_VOCAB, 50, (64,), SEQ_LEN)


def smoke() -> WDLConfig:
    c = _cfg(5000, 16, (16,), 10)
    return WDLConfig(**{**c.__dict__, "name": "sasrec-smoke"})


register_arch("sasrec", full, smoke, RECSYS_SHAPES)
