"""dcn-v2 [arXiv:2008.13535].

n_dense=13 n_sparse=26 embed_dim=16 n_cross_layers=3 mlp=1024-1024-512,
cross interaction (stacked structure: cross net -> deep net).
"""
from repro_torch.configs.base import (RECSYS_SHAPES, FeatureField, InteractionSpec,
                                      WDLConfig, register_arch)
from repro_torch.configs.criteo import CRITEO_VOCABS, N_DENSE, smoke_vocabs


def _fields(vocabs, dim):
    return tuple(
        FeatureField(name=f"cat_{i}", vocab=int(v), dim=dim, max_len=1, pooling="sum")
        for i, v in enumerate(vocabs)
    )


def full() -> WDLConfig:
    return WDLConfig(
        name="dcn-v2",
        fields=_fields(CRITEO_VOCABS, dim=16),
        n_dense=N_DENSE,
        interactions=(InteractionSpec("cross", kwargs={"n_layers": 3}),),
        mlp_dims=(1024, 1024, 512),
    )


def smoke() -> WDLConfig:
    return WDLConfig(
        name="dcn-v2-smoke",
        fields=_fields(smoke_vocabs(26), dim=16),
        n_dense=N_DENSE,
        interactions=(InteractionSpec("cross", kwargs={"n_layers": 3}),),
        mlp_dims=(64, 32),
    )


register_arch("dcn-v2", full, smoke, RECSYS_SHAPES)
