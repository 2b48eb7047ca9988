"""PyTorch / CUDA port of the variational optical flow engine.

The port of ``opticalflow_tpu`` (JAX, TPU) to PyTorch on NVIDIA Hopper.
It mirrors the JAX package's layout (``core``, ``ops``, ``solve``,
``flow``, ``parallel``, ``analysis``, ``io``, ``viz``, ``utils``) and
imports no JAX.  Its hot matvec is a hand-written CUDA kernel
(``csrc/el_matvec.cu``, built with nvcc on first use).  The command line
is ``python -m opticalflow_tpu_torch.analysis.drivers``.
"""

from opticalflow_tpu_torch.core.types import (BoxFlowConfig, FlowResult, SolverConfig,
                                              VariationalConfig)
from opticalflow_tpu_torch.flow.boxflow import conduct_optical_flow
from opticalflow_tpu_torch.flow.variational import variational_optical_flow
from opticalflow_tpu_torch.ops.blur import blur_movie

__all__ = [
    "BoxFlowConfig",
    "FlowResult",
    "VariationalConfig",
    "SolverConfig",
    "conduct_optical_flow",
    "variational_optical_flow",
    "blur_movie",
]
