"""OpenCV Farneback optical flow interop (host-side comparison baseline).

Counterpart of ``opticalflow_tpu.flow.farneback``: per-pair
``cv2.calcOpticalFlowFarneback`` with ``OPTFLOW_FARNEBACK_GAUSSIAN`` on the
host, the previous pair's (negated) flow carried into the next call, unit
scaling at the end.  The optional blur runs through the port's
``ops.blur`` on ``device`` (``None``: the CUDA device, which must exist;
``'cpu'``: the CPU).  As in the reference and the JAX package, the
*blurred* movie is stored under ``original_data``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from opticalflow_tpu_torch.core.types import FlowResult
from opticalflow_tpu_torch.ops.blur import blur_to_host
from opticalflow_tpu_torch.utils.device import resolve_device, to_host

_DEFAULTS = dict(
    pyr_scale=0.5, levels=5, winsize=10, iterations=40, poly_n=5, poly_sigma=10,
)


def conduct_opencv_flow(
    movie,
    delta_x: float = 1.0,
    delta_t: float = 1.0,
    smoothing_sigma: Optional[float] = None,
    device=None,
    **kwargs,
) -> FlowResult:
    """Farneback flow of every consecutive frame pair of a (T, X, Y) movie;
    ``kwargs`` override cv2's parameters.  Returns host arrays."""
    try:
        import cv2
    except ImportError as err:
        raise ImportError(
            "conduct_opencv_flow needs opencv-python (host-side interop path)"
        ) from err

    device = resolve_device(device)
    movie = to_host(movie)
    if smoothing_sigma is not None:
        movie_to_analyse = blur_to_host(movie, smoothing_sigma, device)
    else:
        movie_to_analyse = movie

    params = dict(_DEFAULTS)
    params.update(kwargs)
    flags = params.pop("flags", cv2.OPTFLOW_FARNEBACK_GAUSSIAN)

    n_pairs = movie.shape[0] - 1
    v_x = np.zeros((n_pairs, movie.shape[1], movie.shape[2]))
    v_y = np.zeros_like(v_x)
    flow = None
    for k in range(n_pairs):
        flow = cv2.calcOpticalFlowFarneback(
            movie_to_analyse[k].astype(np.float32),
            movie[k + 1].astype(np.float32),
            flow,
            flags=flags,
            **params,
        )
        v_x[k] = flow[:, :, 0]
        v_y[k] = flow[:, :, 1]
        flow = -flow  # the reference negates the carried flow

    scale = delta_x / delta_t
    v_x *= scale
    v_y *= scale
    return FlowResult(
        v_x=v_x,
        v_y=v_y,
        speed=np.sqrt(v_x**2 + v_y**2),
        original_data=movie_to_analyse,  # the reference stores the blurred stack here
        delta_x=delta_x,
        delta_t=delta_t,
    )
