"""schnet [arXiv:1706.08566]. A copy of
``repro.configs.schnet``.

n_interactions=3 d_hidden=64 rbf=300 cutoff=10.
"""
from repro_torch.configs.base import GNN_SHAPES, SchNetConfig, register_arch


def full() -> SchNetConfig:
    return SchNetConfig(
        name="schnet",
        n_interactions=3,
        d_hidden=64,
        n_rbf=300,
        cutoff=10.0,
    )


def smoke() -> SchNetConfig:
    return SchNetConfig(
        name="schnet-smoke",
        n_interactions=2,
        d_hidden=16,
        n_rbf=8,
        cutoff=5.0,
    )


register_arch("schnet", full, smoke, GNN_SHAPES)
