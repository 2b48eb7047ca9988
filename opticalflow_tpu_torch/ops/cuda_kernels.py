"""Hand-written CUDA kernels of the port, their builds, wrappers and plain
versions.

Three kernels, all on the stencil of ``csrc/el_stencil.cuh``:

* the fused reduced Euler-Lagrange matvec (``csrc/el_matvec.cu``), the
  Hopper counterpart of the TPU kernel
  ``opticalflow_tpu/ops/pallas_kernels.py::_el_matvec_interior_kernel``:
  wrapper :func:`el_matvec_reduced_fused`, plain version
  :func:`el_matvec_reduced_fused_ref`, counters ``LAUNCHES`` and
  ``PLAIN_CALLS``;
* the plain stencil core (``csrc/el_matvec_plain.cu``), the counterpart of
  ``pallas_kernels.py::_el_matvec_plain_kernel``: wrapper
  :func:`el_matvec_plain_core`, plain version :func:`el_matvec_plain_core_ref`,
  counters ``CORE_LAUNCHES`` and ``CORE_PLAIN_CALLS``.  With the boundary
  ring overwritten by ``elop.ring_apply`` it is the hybrid matvec
  (:func:`el_matvec_hybrid`, the counterpart of ``make_hybrid_ops``), which
  equals the fused matvec;
* the stencil on pre-extended blocks (``csrc/el_matvec_ext.cu``), the
  counterpart of ``pallas_kernels.py::_el_matvec_kernel``, the kernel of the
  tiled matvec (parallel.spmd): wrapper :func:`el_matvec_extended`, plain
  version :func:`el_matvec_extended_ref`, counters ``EXT_LAUNCHES`` and
  ``EXT_PLAIN_CALLS``.

On CPU tensors a wrapper runs its plain version; on CUDA tensors it checks
device, dtype, shape and contiguity, launches its kernel on the current
stream, and raises on any failure — there is no fallback.  It adds one to
its launch counter per launch, and a plain version to its own counter per
call, under a lock, so the counts stay exact when several threads solve
at once (the sharded solve's workers, parallel.batch).  The first launch
of each kernel on each device, and of each block shape (K = 1 and K > 1),
holds a lock too: B1 sets its shared-memory limit and caches its resident
blocks per device on that launch.  :func:`load_library` builds each source of ``ENTRY_POINTS`` with
``nvcc`` on first use, one process per source, all started together, into
``_build/`` beside the package (plain C entry points loaded with ctypes),
keyed by a hash of every source and header under ``csrc/`` and the flags.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from opticalflow_tpu_torch.core import stencils
from opticalflow_tpu_torch.ops import elop

LAUNCHES = 0  # kernel launches by el_matvec_reduced_fused
PLAIN_CALLS = 0  # calls of the plain version el_matvec_reduced_fused_ref
CORE_LAUNCHES = 0  # kernel launches by el_matvec_plain_core
CORE_PLAIN_CALLS = 0  # calls of the plain version el_matvec_plain_core_ref
EXT_LAUNCHES = 0  # kernel launches by el_matvec_extended
EXT_PLAIN_CALLS = 0  # calls of the plain version el_matvec_extended_ref
BUILD_SECONDS = None  # wall time of this process's nvcc builds, if it built
BUILD_LOG = ""  # nvcc's output of those builds (-Xptxas -v: registers, smem)

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# C entry point of each source; all take (I, scalars, u, out, B, K, m, n,
# compat, stream)
ENTRY_POINTS = {"el_matvec.cu": "el_matvec_reduced_fused",
                "el_matvec_plain.cu": "el_matvec_plain_core",
                "el_matvec_ext.cu": "el_matvec_extended"}

# kernels whose grid puts B * K on its z axis (B1's grid is one-dimensional
# and has no such limit)
GRID_Z_LIMITED = ("el_matvec_plain_core", "el_matvec_extended")

_FUNCTIONS: Dict[str, ctypes._CFuncPtr] = {}
_LOAD_LOCK = threading.Lock()  # one build, however many threads load at once
_COUNT_LOCK = threading.Lock()
_FIRST_USE_LOCK = threading.Lock()
_LAUNCHED = set()  # (entry point, device index, K > 1) launched once already


def _count(name: str) -> None:
    """Add one to the module counter ``name``."""
    with _COUNT_LOCK:
        globals()[name] += 1


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc") or "")
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def build(source_dir: str = SOURCE_DIR) -> Dict[str, ctypes._CFuncPtr]:
    """Build (once per version of the sources under ``source_dir``) and load
    each source of ``ENTRY_POINTS`` that ``source_dir`` holds into
    ``BUILD_DIR``; returns the C entry points by name.  Another version's
    ``csrc`` builds beside this one's (the libraries are keyed by the
    sources' hash).  Sets ``BUILD_SECONDS`` and ``BUILD_LOG`` when it
    compiles."""
    global BUILD_SECONDS, BUILD_LOG
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(source_dir, "*.cu*"))):  # headers too
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + b"\0" + fh.read())
    digest = h.hexdigest()[:16]
    entry_points = {src: entry for src, entry in ENTRY_POINTS.items()
                    if os.path.exists(os.path.join(source_dir, src))}
    libs = {src: os.path.join(BUILD_DIR, f"lib{src[:-3]}_{digest}.so") for src in entry_points}
    missing = [src for src, lib in libs.items() if not os.path.exists(lib)]
    if missing:
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        procs = {src: subprocess.Popen(  # one nvcc per source, all at once
            [_nvcc(), *NVCC_FLAGS, "-o", f"{libs[src]}.{os.getpid()}.tmp",
             os.path.join(source_dir, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for src in missing}
        logs = {src: proc.communicate()[0] for src, proc in procs.items()}
        BUILD_SECONDS = time.perf_counter() - t0
        BUILD_LOG = "".join(f"== {src}\n{log}" for src, log in logs.items())
        failed = [f"{src} ({proc.returncode})" for src, proc in procs.items() if proc.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed: {', '.join(failed)}:\n{BUILD_LOG}")
        for src in missing:
            os.replace(f"{libs[src]}.{os.getpid()}.tmp", libs[src])
    functions = {}
    for src, entry in entry_points.items():
        fn = getattr(ctypes.CDLL(libs[src]), entry)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        functions[entry] = fn
    return functions


def load_library() -> Dict[str, ctypes._CFuncPtr]:
    """Build (once per version of the sources) and load every kernel of
    ``ENTRY_POINTS``; returns the C entry points by name."""
    with _LOAD_LOCK:
        if not _FUNCTIONS:
            _FUNCTIONS.update(build())
    return _FUNCTIONS


def _check_shapes(I: torch.Tensor, scalars: torch.Tensor, u: torch.Tensor,
                  extended: bool = False):
    """(B, K, m, n) of a call, or ValueError.  ``u`` is (B, [K,] 3, m, n),
    or with ``extended`` the pre-extended (B, [K,] 3, m+2, n+2), whose
    interior may be as small as 1x1 (it needs no mirror rows)."""
    halo = 2 if extended else 0
    if u.dim() not in (4, 5) or u.shape[-3] != 3:
        raise ValueError(f"u must be (B, 3, M, N) or (B, K, 3, M, N), got {tuple(u.shape)}")
    B, m, n = u.shape[0], u.shape[-2] - halo, u.shape[-1] - halo
    K = u.shape[1] if u.dim() == 5 else 1
    if tuple(I.shape) != (B, m + 2, n + 2):
        raise ValueError(f"I must be {(B, m + 2, n + 2)}, got {tuple(I.shape)}")
    if tuple(scalars.shape) != (B, 2):
        raise ValueError(f"scalars must be {(B, 2)}, got {tuple(scalars.shape)}")
    smallest = 1 if extended else 3
    if m < smallest or n < smallest:
        raise ValueError(f"the interior must be at least {smallest}x{smallest}, got {m}x{n}")
    return B, K, m, n


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _launch(entry: str, I: torch.Tensor, scalars: torch.Tensor, u: torch.Tensor,
            compat: bool, extended: bool = False,
            library: Optional[Dict[str, ctypes._CFuncPtr]] = None) -> torch.Tensor:
    """Check the operands of a kernel call and launch ``entry`` of
    ``library`` (a :func:`build`; this checkout's when ``None``) on the
    current stream; raises on anything the kernel does not take and on a
    failed launch."""
    B, K, m, n = _check_shapes(I, scalars, u, extended)
    for name, t in (("I", I), ("scalars", scalars), ("u", u)):
        if t.device != u.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; all operands must be on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if entry in GRID_Z_LIMITED and B * K > 65535:
        raise ValueError(f"B*K = {B * K} exceeds {entry}'s grid z limit 65535")
    fn = (library or load_library())[entry]
    out = u.new_empty(u.shape[:-2] + (m, n))
    first_use = (id(fn), u.device.index, K > 1)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        args = (I.data_ptr(), scalars.data_ptr(), u.data_ptr(), out.data_ptr(),
                B, K, m, n, int(bool(compat)), stream)
        if first_use in _LAUNCHED:
            rc = fn(*args)
        else:
            with _FIRST_USE_LOCK:
                rc = fn(*args)
                if rc == 0:
                    _LAUNCHED.add(first_use)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {rc}")
    return out


def _coefficients(I: torch.Tensor, scalars: torch.Tensor, u: torch.Tensor, compat: bool):
    """Coefficient planes rebuilt from ``I`` as the kernels do, with a probe
    axis when ``u`` is a (B, K, 3, m, n) stack."""
    dy_mode = stencils.DY_COMPAT if compat else stencils.DY_FIXED
    if u.dim() == 5:
        I, scalars = I[:, None], scalars[:, None]
    return elop.compute_coefficients(I, scalars[..., 0], scalars[..., 1], dy_mode)


def el_matvec_reduced_fused_ref(I: torch.Tensor, scalars: torch.Tensor, u: torch.Tensor,
                                compat: bool) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel: ``I`` (B, m+2, n+2),
    ``scalars`` (B, 2) = per-pair (alpha_s, alpha_r), ``u`` (B, 3, m, n) or
    (B, K, 3, m, n); returns y = A_reduced u of the same shape."""
    _check_shapes(I, scalars, u)
    _count("PLAIN_CALLS")
    return elop.interior_apply(_coefficients(I, scalars, u, compat), elop.extend_interior(u))


def el_matvec_reduced_fused(I: torch.Tensor, scalars: torch.Tensor, u: torch.Tensor,
                            compat: bool) -> torch.Tensor:
    """y = A_reduced u with the coefficients rebuilt from ``I`` on the fly;
    arguments as :func:`el_matvec_reduced_fused_ref`.  CUDA tensors go
    through the hand-written kernel, CPU tensors through the plain
    version."""
    if _on_cpu(I, scalars, u):
        return el_matvec_reduced_fused_ref(I, scalars, u, compat)
    out = _launch("el_matvec_reduced_fused", I, scalars, u, compat)
    _count("LAUNCHES")
    return out


def el_matvec_plain_core_ref(I: torch.Tensor, scalars: torch.Tensor, u: torch.Tensor,
                             compat: bool) -> torch.Tensor:
    """Plain PyTorch version of the plain-stencil kernel: the EL stencil
    with coefficients rebuilt from ``I``, applied to ``u`` extended by
    zeros (every output pixel, the boundary ring included); arguments as
    :func:`el_matvec_reduced_fused_ref`."""
    _check_shapes(I, scalars, u)
    _count("CORE_PLAIN_CALLS")
    return elop.interior_apply(_coefficients(I, scalars, u, compat), F.pad(u, (1, 1, 1, 1)))


def el_matvec_plain_core(I: torch.Tensor, scalars: torch.Tensor, u: torch.Tensor,
                         compat: bool) -> torch.Tensor:
    """The plain stencil of :func:`el_matvec_plain_core_ref`; CUDA tensors
    go through the hand-written kernel, CPU tensors through the plain
    version."""
    if _on_cpu(I, scalars, u):
        return el_matvec_plain_core_ref(I, scalars, u, compat)
    out = _launch("el_matvec_plain_core", I, scalars, u, compat)
    _count("CORE_LAUNCHES")
    return out


def el_matvec_hybrid(I: torch.Tensor, scalars: torch.Tensor, u: torch.Tensor, compat: bool,
                     ring: elop.RingCoeffs) -> torch.Tensor:
    """y = A_reduced u as the plain-stencil core plus the boundary ring
    overwritten by ``elop.ring_apply`` (the counterpart of
    ``pallas_kernels.make_hybrid_ops``); ``ring`` holds the strips of the
    coefficient planes of ``I`` (``elop.ring_coeffs``), with a probe axis
    when ``u`` is a (B, K, 3, m, n) stack."""
    return elop.ring_overwrite(el_matvec_plain_core(I, scalars, u, compat), ring, u)


def el_matvec_extended_ref(I: torch.Tensor, scalars: torch.Tensor, u: torch.Tensor,
                           compat: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernel on pre-extended blocks: ``I``
    (N, m+2, n+2) blocks of the true frame with their halo, ``scalars``
    (N, 2), ``u`` (N, 3, m+2, n+2) or (N, K, 3, m+2, n+2) field blocks
    already extended; returns the EL stencil (N, [K,] 3, m, n)."""
    _check_shapes(I, scalars, u, extended=True)
    _count("EXT_PLAIN_CALLS")
    return elop.interior_apply(_coefficients(I, scalars, u, compat), u)


def el_matvec_extended(I: torch.Tensor, scalars: torch.Tensor, u: torch.Tensor,
                       compat: bool) -> torch.Tensor:
    """The stencil on pre-extended blocks of :func:`el_matvec_extended_ref`;
    CUDA tensors go through the hand-written kernel, CPU tensors through
    the plain version."""
    if _on_cpu(I, scalars, u):
        return el_matvec_extended_ref(I, scalars, u, compat)
    out = _launch("el_matvec_extended", I, scalars, u, compat, extended=True)
    _count("EXT_LAUNCHES")
    return out
