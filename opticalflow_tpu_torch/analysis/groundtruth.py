"""Hand-measured ground-truth displacement validation.

Counterpart of ``opticalflow_tpu.analysis.groundtruth``: hand-clicked
displacement endpoints (an xlsx or csv sheet with the columns
'x-position start/end' and 'y-position start/end'; the sheet's x/y are
swapped relative to the array axes, as the reference reads them) against
the inferred flow sampled at the click positions, as per-point relative
errors.  Host numpy; pandas only reads the sheet.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from opticalflow_tpu_torch.utils.device import to_host


def load_displacement_measurements(path: str) -> Dict[str, np.ndarray]:
    """Read a displacement-measurement sheet.  Its 'x-position' columns are
    the second array axis (and vice versa), as the reference reads them."""
    import pandas as pd

    if path.lower().endswith(".csv"):
        table = pd.read_csv(path)
    else:
        table = pd.read_excel(path)
    return {
        "y_start": table["x-position start"].values,
        "y_end": table["x-position end"].values,
        "x_start": table["y-position start"].values,
        "x_end": table["y-position end"].values,
    }


def compare_ground_truth_displacement(flow_result, measurements: Dict[str, np.ndarray],
                                      frame: int = 0) -> Dict[str, np.ndarray]:
    """Relative errors between measured displacements and the flow field
    sampled at the measurement start points.  The flow is read as
    displacement per frame interval (the reference validates with
    delta_x = delta_t = 1)."""
    xs = np.asarray(measurements["x_start"], dtype=int)
    ys = np.asarray(measurements["y_start"], dtype=int)
    true_dx = np.asarray(measurements["x_end"]) - np.asarray(measurements["x_start"])
    true_dy = np.asarray(measurements["y_end"]) - np.asarray(measurements["y_start"])

    inferred_dx = to_host(flow_result["v_x"])[frame, xs, ys]
    inferred_dy = to_host(flow_result["v_y"])[frame, xs, ys]

    error = np.sqrt((true_dy - inferred_dy) ** 2 + (true_dx - inferred_dx) ** 2)
    true_magnitude = np.sqrt(true_dx**2 + true_dy**2)
    with np.errstate(divide="ignore", invalid="ignore"):
        relative_errors = error / true_magnitude

    return {
        "relative_errors": relative_errors,
        "true_displacements": np.stack([true_dx, true_dy], axis=1),
        "inferred_displacements": np.stack([inferred_dx, inferred_dy], axis=1),
        "positions": np.stack([xs, ys], axis=1),
        "true_magnitudes": true_magnitude,
        "inferred_magnitudes": np.sqrt(inferred_dx**2 + inferred_dy**2),
    }
