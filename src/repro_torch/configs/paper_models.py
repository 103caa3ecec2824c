"""The paper's own evaluation models (``repro.configs.paper_models`` in
torch), for the models the port runs so far: DLRM on Criteo.

Not registered as an arch, as in the reference: callers build the config
directly (``dlrm()`` at full width, ``dlrm(criteo=False, scale=0.01)`` as
the reference's throughput bench trains it). The other configs (W&D, DIN,
MMoE, CAN) come with the slices that port their interactions.
"""
from repro_torch.configs.base import FeatureField, InteractionSpec, WDLConfig
from repro_torch.configs.criteo import CRITEO_VOCABS, N_DENSE


def dlrm(criteo: bool = True, scale: float = 1.0) -> WDLConfig:
    """DLRM on Criteo, emb dim 128 (Tab. II)."""
    if criteo and scale >= 1:
        vocabs = CRITEO_VOCABS
        dim, mlp, bot = 128, (1024, 1024, 512, 256), (512, 256, 128)
    else:
        vocabs = tuple(int(500 + 61 * i) for i in range(26))
        dim, mlp, bot = 16, (64, 32), (32, 16)
    fields = tuple(
        FeatureField(f"cat_{i}", vocab=int(v), dim=dim, max_len=1, pooling="sum") for i, v in enumerate(vocabs)
    )
    return WDLConfig(
        name="dlrm",
        fields=fields,
        n_dense=N_DENSE,
        interactions=(InteractionSpec("dot"),),
        mlp_dims=mlp,
        dense_arch=bot,
    )
