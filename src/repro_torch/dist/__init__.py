"""One process per rank (``repro.dist`` in torch): the ``Group`` and its
collectives and agreements (``compat``) and the per-rank placement
(``sharding``)."""
from repro_torch.dist.compat import (PG_TIMEOUT_S, WORLD1, CollectiveFailure, Group, agree,
                                     all_gather_tiled, all_to_all_tiled, arm_gate,
                                     axis_groups, axis_index, backend_for, barrier,
                                     gather_floats, init_ranks, psum, rank_device,
                                     reduce_scatter_tiled, reset_traffic, resolve_group,
                                     spawn_ranks, take_gate, traffic_snapshot)

__all__ = ["PG_TIMEOUT_S", "WORLD1", "CollectiveFailure", "Group", "agree",
           "all_gather_tiled", "all_to_all_tiled", "arm_gate", "axis_groups", "axis_index",
           "backend_for", "barrier", "gather_floats", "init_ranks", "psum", "rank_device",
           "reduce_scatter_tiled", "reset_traffic", "resolve_group", "spawn_ranks",
           "take_gate", "traffic_snapshot"]
