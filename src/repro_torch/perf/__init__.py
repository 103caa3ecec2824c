"""Measured cost model (``repro.perf`` in torch): calibrated per-op curves
replacing hand constants.

``CostModel`` prices the same candidate strategies
``repro_torch.core.assign`` scores, but in microseconds from curves fitted
to microbenches of the port's dispatched ops (``calibration.run_calibration``).
``get_cost_model`` is the launcher entry point behind ``--calibrate
{auto,force,off}``.
"""
from repro_torch.perf.cost_model import (
    CORRECTION_ALPHA,
    CORRECTION_BOUNDS,
    PRICED_OPS,
    CostCurve,
    CostModel,
    synthetic_cost_model,
)
from repro_torch.perf.calibration import (
    CALIB_VERSION,
    DEFAULT_CALIB_PATH,
    GRIDS,
    backend_stamp,
    fit_cost_model,
    get_cost_model,
    load_calibration,
    load_samples,
    run_calibration,
    save_calibration,
)

__all__ = [
    "CALIB_VERSION",
    "CORRECTION_ALPHA",
    "CORRECTION_BOUNDS",
    "DEFAULT_CALIB_PATH",
    "GRIDS",
    "PRICED_OPS",
    "CostCurve",
    "CostModel",
    "backend_stamp",
    "fit_cost_model",
    "get_cost_model",
    "load_calibration",
    "load_samples",
    "run_calibration",
    "save_calibration",
    "synthetic_cost_model",
]
