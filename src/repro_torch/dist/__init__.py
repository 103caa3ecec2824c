"""One process per rank (``repro.dist`` in torch): the ``Group`` and its
collectives (``compat``) and the per-rank placement (``sharding``)."""
from repro_torch.dist.compat import (WORLD1, Group, all_gather_tiled, all_to_all_tiled,
                                     axis_index, backend_for, barrier, init_ranks, psum,
                                     rank_device, reset_traffic,
                                     resolve_group, spawn_ranks, traffic_snapshot)

__all__ = ["WORLD1", "Group", "all_gather_tiled", "all_to_all_tiled", "axis_index",
           "backend_for", "barrier", "init_ranks", "psum", "rank_device",
           "reset_traffic", "resolve_group", "spawn_ranks", "traffic_snapshot"]
