"""Hand-written CUDA kernels of the port, their builds, wrappers and plain
versions.

One kernel so far: the fused reduced Euler-Lagrange matvec
(``csrc/el_matvec.cu``), the Hopper counterpart of the TPU kernel
``opticalflow_tpu/ops/pallas_kernels.py::_el_matvec_interior_kernel``.

* :func:`el_matvec_reduced_fused` is the wrapper.  On CPU tensors it runs
  the plain version; on CUDA tensors it checks device, dtype, shape and
  contiguity, launches the kernel on the current stream, and raises on any
  failure — there is no fallback.  It adds one to ``LAUNCHES`` per launch.
* :func:`el_matvec_reduced_fused_ref` is the plain PyTorch version of the
  same function (coefficients rebuilt, then ``elop.interior_apply`` of
  ``elop.extend_interior``).  It adds one to ``PLAIN_CALLS`` per call.
* :func:`load_library` builds the kernel with ``nvcc`` on first use into
  ``_build/`` beside the package (a plain C entry point loaded with
  ctypes), keyed by a hash of the source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

from opticalflow_tpu_torch.core import stencils
from opticalflow_tpu_torch.ops import elop

LAUNCHES = 0  # kernel launches by el_matvec_reduced_fused
PLAIN_CALLS = 0  # calls of the plain version el_matvec_reduced_fused_ref
BUILD_SECONDS = None  # wall time of this process's nvcc build, if it built
BUILD_LOG = ""  # nvcc's output of that build (-Xptxas -v: registers, smem)

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_HERE, "csrc", "el_matvec.cu")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc") or "")
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library."""
    global _LIB, BUILD_SECONDS, BUILD_LOG
    if _LIB is not None:
        return _LIB
    with open(SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = os.path.join(BUILD_DIR, f"libel_matvec_{digest}.so")
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        BUILD_SECONDS = time.perf_counter() - t0
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(lib_path)
    fn = lib.el_matvec_reduced_fused
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _LIB = lib
    return lib


def _check_shapes(I: torch.Tensor, scalars: torch.Tensor, u: torch.Tensor):
    """(B, K, m, n) of a call, or ValueError."""
    if u.dim() not in (4, 5) or u.shape[-3] != 3:
        raise ValueError(f"u must be (B, 3, m, n) or (B, K, 3, m, n), got {tuple(u.shape)}")
    B, m, n = u.shape[0], u.shape[-2], u.shape[-1]
    K = u.shape[1] if u.dim() == 5 else 1
    if tuple(I.shape) != (B, m + 2, n + 2):
        raise ValueError(f"I must be {(B, m + 2, n + 2)}, got {tuple(I.shape)}")
    if tuple(scalars.shape) != (B, 2):
        raise ValueError(f"scalars must be {(B, 2)}, got {tuple(scalars.shape)}")
    if m < 3 or n < 3:
        raise ValueError(f"the interior must be at least 3x3, got {m}x{n}")
    return B, K, m, n


def el_matvec_reduced_fused_ref(I: torch.Tensor, scalars: torch.Tensor, u: torch.Tensor,
                                compat: bool) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel: ``I`` (B, m+2, n+2),
    ``scalars`` (B, 2) = per-pair (alpha_s, alpha_r), ``u`` (B, 3, m, n) or
    (B, K, 3, m, n); returns y = A_reduced u of the same shape."""
    global PLAIN_CALLS
    _check_shapes(I, scalars, u)
    PLAIN_CALLS += 1
    dy_mode = stencils.DY_COMPAT if compat else stencils.DY_FIXED
    if u.dim() == 5:
        I, scalars = I[:, None], scalars[:, None]
    coeffs = elop.compute_coefficients(I, scalars[..., 0], scalars[..., 1], dy_mode)
    return elop.interior_apply(coeffs, elop.extend_interior(u))


def el_matvec_reduced_fused(I: torch.Tensor, scalars: torch.Tensor, u: torch.Tensor,
                            compat: bool) -> torch.Tensor:
    """y = A_reduced u with the coefficients rebuilt from ``I`` on the fly;
    arguments as :func:`el_matvec_reduced_fused_ref`.  CUDA tensors go
    through the hand-written kernel, CPU tensors through the plain
    version."""
    global LAUNCHES
    if u.device.type == "cpu" and I.device.type == "cpu" and scalars.device.type == "cpu":
        return el_matvec_reduced_fused_ref(I, scalars, u, compat)
    B, K, m, n = _check_shapes(I, scalars, u)
    for name, t in (("I", I), ("scalars", scalars), ("u", u)):
        if t.device != u.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; all operands must be on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if B * K > 65535:
        raise ValueError(f"B*K = {B * K} exceeds the grid's z limit 65535")
    lib = load_library()
    out = torch.empty_like(u)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = lib.el_matvec_reduced_fused(
            I.data_ptr(), scalars.data_ptr(), u.data_ptr(), out.data_ptr(),
            B, K, m, n, int(bool(compat)), stream,
        )
    if rc != 0:
        raise RuntimeError(f"el_matvec kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out
