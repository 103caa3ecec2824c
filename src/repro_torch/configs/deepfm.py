"""deepfm [arXiv:1703.04247].

n_sparse=39 embed_dim=10 mlp=400-400-400, FM interaction. The 13 Criteo
numeric features are discretised into categorical fields, giving 39 sparse
fields total (26 categorical + 13 bucketised numeric).
"""
from repro_torch.configs.base import (RECSYS_SHAPES, FeatureField, InteractionSpec,
                                      WDLConfig, register_arch)
from repro_torch.configs.criteo import CRITEO_VOCABS, smoke_vocabs

_NUMERIC_BUCKETS = 1024  # bucketised numeric fields


def _fields(vocabs, num_buckets, dim):
    fields = [
        FeatureField(name=f"cat_{i}", vocab=int(v), dim=dim, max_len=1, pooling="sum")
        for i, v in enumerate(vocabs)
    ]
    fields += [
        FeatureField(name=f"numb_{i}", vocab=num_buckets, dim=dim, max_len=1, pooling="sum")
        for i in range(13)
    ]
    return tuple(fields)


def full() -> WDLConfig:
    return WDLConfig(
        name="deepfm",
        fields=_fields(CRITEO_VOCABS, _NUMERIC_BUCKETS, dim=10),
        n_dense=0,
        interactions=(
            InteractionSpec("fm"),           # FM 2nd-order over all 39 fields
            InteractionSpec("linear"),       # FM 1st-order (wide part)
        ),
        mlp_dims=(400, 400, 400),
    )


def smoke() -> WDLConfig:
    return WDLConfig(
        name="deepfm-smoke",
        fields=_fields(smoke_vocabs(26), 32, dim=10),
        n_dense=0,
        interactions=(InteractionSpec("fm"), InteractionSpec("linear")),
        mlp_dims=(32, 32),
    )


register_arch("deepfm", full, smoke, RECSYS_SHAPES)
