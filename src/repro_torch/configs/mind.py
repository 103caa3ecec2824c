"""mind [arXiv:1904.08030], a copy of ``repro.configs.mind``.

embed_dim=64 n_interests=4 capsule_iters=3 — multi-interest extraction via
dynamic-routing capsules over the user behaviour sequence, then label-aware
attention against the target item. Industrial item catalogue (20M items).
"""
from repro_torch.configs.base import (RECSYS_SHAPES, FeatureField, InteractionSpec,
                                      WDLConfig, register_arch)

ITEM_VOCAB = 20_000_000
SEQ_LEN = 50


def _cfg(item_vocab, dim, seq_len, mlp) -> WDLConfig:
    return WDLConfig(
        name="mind",
        fields=(
            FeatureField("hist_items", vocab=item_vocab, dim=dim, max_len=seq_len, pooling="none", group="seq"),
            FeatureField("target_item", vocab=item_vocab, dim=dim, max_len=1, pooling="sum",
                         group="target", shared_table="hist_items"),
            # user profile fields (gender / age-bucket / city), concatenated to interests
            FeatureField("user_gender", vocab=4, dim=dim, max_len=1, pooling="sum", group="profile"),
            FeatureField("user_age", vocab=16, dim=dim, max_len=1, pooling="sum", group="profile"),
            FeatureField("user_city", vocab=2048, dim=dim, max_len=1, pooling="sum", group="profile"),
        ),
        n_dense=0,
        interactions=(
            InteractionSpec(
                "capsule",
                fields=("hist_items", "target_item"),
                kwargs={"n_interests": 4, "routing_iters": 3, "seq_len": seq_len},
            ),
        ),
        mlp_dims=mlp,
    )


def full() -> WDLConfig:
    return _cfg(ITEM_VOCAB, 64, SEQ_LEN, (256, 64))


def smoke() -> WDLConfig:
    c = _cfg(4000, 16, 8, (32,))
    return WDLConfig(**{**c.__dict__, "name": "mind-smoke"})


register_arch("mind", full, smoke, RECSYS_SHAPES)
