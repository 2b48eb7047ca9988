"""PyTorch / CUDA port of the variational optical flow engine.

The port of ``opticalflow_tpu`` (JAX, TPU) to PyTorch on NVIDIA Hopper.
It mirrors the JAX package's layout (``core``, ``ops``, ``solve``,
``flow``, ``parallel``, ``analysis``) and imports no JAX.  Its hot matvec
is a hand-written CUDA kernel (``csrc/el_matvec.cu``, built with nvcc on
first use).
"""

from opticalflow_tpu_torch.core.types import FlowResult, SolverConfig
from opticalflow_tpu_torch.flow.boxflow import conduct_optical_flow
from opticalflow_tpu_torch.flow.variational import variational_optical_flow

__all__ = ["FlowResult", "SolverConfig", "conduct_optical_flow", "variational_optical_flow"]
