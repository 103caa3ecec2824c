"""Runtime adaptation subsystem of the port (``repro.runtime`` in torch).
``replanner`` harvests the engine's live frequency statistics, recompiles
the plan's revisable decisions and migrates the live state, and ``stream``
is the segmented streaming driver with the publish/pickup train-to-serve
handoff, both at world 1; ``guard`` detects and rejects numeric anomalies
and ``chaos`` injects deterministic faults that prove the recovery paths,
at any fixed world. The reference's ``elastic`` (world-size resharding) is
ROADMAP Queue 1 item 6.2 and not exported here.
"""
from repro_torch.runtime.chaos import (ChaosController, ChaosFailure, ChaosStream,
                                       FaultPlan, parse_fault_plan)
from repro_torch.runtime.guard import (AnomalyGuard, AnomalyRollback, GuardConfig,
                                       VerdictMismatch)
from repro_torch.runtime.replanner import (ReplanEvent, Replanner, apply_plan_meta,
                                           plan_delta, plan_meta)
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
    "Replanner",
    "VerdictMismatch",
    "apply_plan_meta",
    "load_published",
    "parse_fault_plan",
    "plan_delta",
    "plan_meta",
    "poll_published",
    "publish_state",
    "run_stream",
]
