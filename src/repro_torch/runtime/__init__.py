"""Runtime adaptation subsystem of the port (``repro.runtime`` in torch).
``replanner`` harvests the engine's live frequency statistics, recompiles
the plan's revisable decisions and migrates the live state, at any world
(every rank reaching the same decision);
``stream`` is the segmented streaming driver with the publish/pickup
train-to-serve handoff, at any world and across a change of world at a
segment boundary; ``guard`` detects and rejects numeric anomalies and
``chaos`` injects deterministic faults that prove the recovery paths, at
any world; ``elastic`` moves a live run, a checkpoint or a published delta
between world sizes (one process a rank: the rows move between processes).
"""
from repro_torch.runtime.chaos import (ChaosController, ChaosFailure, ChaosStream,
                                       FaultPlan, parse_fault_plan, tear_published_together)
from repro_torch.runtime.elastic import (end_run, make_submesh, parse_mesh_shape, place_state,
                                         reshard_live, restore_elastic, wait_for_reshard)
from repro_torch.runtime.guard import (AnomalyGuard, AnomalyRollback, GuardConfig,
                                       VerdictMismatch)
from repro_torch.runtime.replanner import (ReplanEvent, Replanner, ReplanMismatch,
                                           apply_plan_meta, plan_delta, plan_meta)
from repro_torch.runtime.stream import (PublishPoller, load_published, poll_published,
                                        publish_state, run_stream)

__all__ = [
    "AnomalyGuard",
    "AnomalyRollback",
    "ChaosController",
    "ChaosFailure",
    "ChaosStream",
    "FaultPlan",
    "GuardConfig",
    "PublishPoller",
    "ReplanEvent",
    "ReplanMismatch",
    "Replanner",
    "VerdictMismatch",
    "apply_plan_meta",
    "end_run",
    "load_published",
    "make_submesh",
    "parse_fault_plan",
    "parse_mesh_shape",
    "place_state",
    "plan_delta",
    "plan_meta",
    "poll_published",
    "publish_state",
    "reshard_live",
    "restore_elastic",
    "run_stream",
    "tear_published_together",
    "wait_for_reshard",
]
