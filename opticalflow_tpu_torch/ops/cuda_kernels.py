"""Hand-written CUDA kernels of the port, their builds, wrappers and plain
versions.

Six kernels, three of them on the stencil of ``csrc/el_stencil.cuh``:

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
* the stencil on the tiles of a mesh (``csrc/el_matvec_ext.cu``), the
  counterpart of ``pallas_kernels.py::_el_matvec_kernel``, the kernel of the
  tiled matvec (parallel.spmd): wrapper :func:`el_matvec_tiled` (every tile
  of a field read in place, or one tile and its four halo lines), plain
  version :func:`el_matvec_tiled_ref`; on the JAX kernel's own operands,
  pre-extended blocks, :func:`el_matvec_extended` (the same kernel, the
  block cut into its interior and halo lines) and its plain version
  :func:`el_matvec_extended_ref`; counters ``EXT_LAUNCHES`` and
  ``EXT_PLAIN_CALLS``;
* the df32 residual and operator of the refinement (``csrc/el_df32.cu``,
  B4), which has no Pallas counterpart: it replaces XLA's fusion of
  ``opticalflow_tpu/ops/elop.py::el_residual_df`` / ``el_matvec_df``.  Its
  operands are packed once per solve (:func:`pack_df32`); wrappers
  :func:`el_residual_df32` and :func:`el_matvec_df32`, plain versions
  :func:`el_residual_df32_ref` and :func:`el_matvec_df32_ref` (the
  ``elop`` functions on views into the packed tensors), counters
  ``DF_LAUNCHES`` and ``DF_PLAIN_CALLS``.  It is built with
  ``-fmad=false`` and equals its plain version bit for bit;
* the multigrid V-cycle's smoothing sweeps and stencil apply
  (``csrc/mg_smooth.cu``, B5) and its grid transfers
  (``csrc/mg_transfer.cu``, B6), which have no Pallas counterpart either:
  they replace XLA's fusion of ``opticalflow_tpu/solve/multigrid.py``'s
  ``jacobi_sweep``, ``apply_blocks``, ``stencil_matvec``, ``restrict``
  and ``prolong``.  Wrappers :func:`mg_smooth`, :func:`mg_smooth_fine`
  and :func:`mg_stencil_apply` (B5, counters ``MG_LAUNCHES`` and
  ``MG_PLAIN_CALLS``), :func:`mg_residual_restrict`, :func:`mg_prolong_add`
  and, at a probed level, the last pre-sweep fused into the
  residual-and-restrict (:func:`mg_smooth_restrict`) and the prolong-add
  fused into the first post-sweep (:func:`mg_prolong_smooth`) (B6,
  ``MGT_LAUNCHES`` and ``MGT_PLAIN_CALLS``); their plain versions
  (``*_ref``) are the stages of ``solve.multigrid``.
  Both are built with ``-fmad=false`` and equal their plain versions bit
  for bit.  A level's stencil and block inverse are checked once per
  hierarchy (:func:`mg_check_level`, from ``multigrid.setup`` and
  ``take``, whose calls pass ``checked=True``); each call checks its
  fields.

The three matvec kernels are instances of one tiled kernel
(``csrc/el_tiles.cuh``) with their staging rule as its parameter; none has
a limit on B * K.

On CPU tensors a wrapper runs its plain version; on CUDA tensors it checks
device, dtype, shape and layout, launches its kernel on the current
stream, and raises on any failure — there is no fallback.  It adds one to
its launch counter per launch, and a plain version to its own counter per
call, under a lock, so the counts stay exact when several threads solve
at once (the sharded solve's workers, parallel.batch).  A launch captured
into a CUDA graph (the Krylov loops, solve.krylov) is counted once per
replay of the graph, and not at its capture (:func:`recorded_counts`,
:func:`add_counts`); its host checks run once, at the capture.  The first launch
of each kernel on each device, and of each block shape (K = 1 and K > 1),
holds a lock too: the kernels set their shared-memory limit and cache
their resident blocks per device on that launch.  :func:`load_library` builds each source of ``ENTRY_POINTS`` with
``nvcc`` on first use, one process per source, all started together, into
``_build/`` beside the package (plain C entry points loaded with ctypes),
each keyed by a hash of every source and header under ``csrc/`` and of its
flags.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from opticalflow_tpu_torch.core import stencils
from opticalflow_tpu_torch.ops import elop

LAUNCHES = 0  # kernel launches by el_matvec_reduced_fused
PLAIN_CALLS = 0  # calls of the plain version el_matvec_reduced_fused_ref
CORE_LAUNCHES = 0  # kernel launches by el_matvec_plain_core
CORE_PLAIN_CALLS = 0  # calls of the plain version el_matvec_plain_core_ref
EXT_LAUNCHES = 0  # kernel launches by el_matvec_tiled (el_matvec_extended included)
EXT_PLAIN_CALLS = 0  # calls of the plain versions el_matvec_tiled_ref, el_matvec_extended_ref
DF_LAUNCHES = 0  # kernel launches by el_residual_df32 and el_matvec_df32
DF_PLAIN_CALLS = 0  # calls of the plain versions el_residual_df32_ref, el_matvec_df32_ref
MG_LAUNCHES = 0  # kernel launches by mg_smooth, mg_smooth_fine and mg_stencil_apply (B5)
MG_PLAIN_CALLS = 0  # calls of their plain versions (the *_ref functions)
MGT_LAUNCHES = 0  # launches by mg_residual_restrict, mg_prolong_add, mg_smooth_restrict and
# mg_prolong_smooth (B6)
MGT_PLAIN_CALLS = 0  # calls of their plain versions
BUILD_SECONDS = None  # wall time of this process's nvcc builds, if it built
BUILD_LOG = ""  # nvcc's output of those builds (-Xptxas -v: registers, smem)

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# argument types of the C entry points: B1 and B2 take (I, scalars, u, out,
# B, K, m, n, compat, stream); B3 (I, scalars, u, out, top, bottom, left,
# right, N, K, tx, ty, m, n, u_plane, u_row, out_plane, out_row, top_plane,
# bottom_plane, left_plane, right_plane, left_step, right_step, compat,
# stream)
_PAIRS_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_TILES_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
               + [ctypes.c_longlong, ctypes.c_int] * 2 + [ctypes.c_longlong] * 4
               + [ctypes.c_int] * 3 + [ctypes.c_void_p])
# B4 takes (planes, scalars, rhs_hi, rhs_lo, x_hi, x_lo, out, B, P, m, n,
# residual, stream)
_DF32_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# B5 takes (S, binv, x, b, y, out, B, K, M, N, damp, mode, stream); B6 (S,
# binv, x, b, y, e, out, out2, B, K, Mf, Nf, Mc, Nc, damp, mode, stream)
_MG_SMOOTH_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                                                 ctypes.c_void_p]
_MG_TRANSFER_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                                                  ctypes.c_void_p]
# C entry point of each source, its argument types and the flags it adds to
# NVCC_FLAGS: B4's error-free transforms are exact only if no product and
# sum are contracted into a fused multiply-add, and B5 and B6 equal their
# plain versions bit for bit only so
ENTRY_POINTS = {"el_matvec.cu": ("el_matvec_reduced_fused", _PAIRS_ARGS, ()),
                "el_matvec_plain.cu": ("el_matvec_plain_core", _PAIRS_ARGS, ()),
                "el_matvec_ext.cu": ("el_matvec_tiled", _TILES_ARGS, ()),
                "el_df32.cu": ("el_df32", _DF32_ARGS, ("-fmad=false",)),
                "mg_smooth.cu": ("mg_smooth", _MG_SMOOTH_ARGS, ("-fmad=false",)),
                "mg_transfer.cu": ("mg_transfer", _MG_TRANSFER_ARGS, ("-fmad=false",))}
# queries a source's library may export beside its entry point, loaded
# where it has them: B4's warps resident on one SM, (P, residual, int *out)
QUERIES = {"el_df32.cu": {"el_df32_warps_per_sm": [ctypes.c_int, ctypes.c_int,
                                                   ctypes.c_void_p]}}

_FUNCTIONS: Dict[str, ctypes._CFuncPtr] = {}
_LOAD_LOCK = threading.Lock()  # one build, however many threads load at once
_COUNT_LOCK = threading.Lock()
_FIRST_USE_LOCK = threading.Lock()
_LAUNCHED = set()  # (entry point, device index, K > 1) launched once already
_RECORDING = threading.local()  # .counts: the counts of a capture under way in this thread


def _count(name: str) -> None:
    """Add one to the module counter ``name``; while this thread captures a
    CUDA graph (:func:`recorded_counts`), to the capture's record instead."""
    recording = getattr(_RECORDING, "counts", None)
    if recording is not None:
        recording[name] = recording.get(name, 0) + 1
        return
    with _COUNT_LOCK:
        globals()[name] += 1


@contextlib.contextmanager
def recorded_counts():
    """Within the block this thread's wrapper calls count into the dict it
    yields, not into the module counters: a CUDA graph's capture launches
    nothing, and each replay of the graph adds the record back
    (:func:`add_counts`), so that the counters stay exact under replay."""
    counts = {}
    _RECORDING.counts = counts
    try:
        yield counts
    finally:
        _RECORDING.counts = None


def add_counts(counts: Dict[str, int]) -> None:
    """Add a capture's record (:func:`recorded_counts`) to the counters."""
    with _COUNT_LOCK:
        for name, n in counts.items():
            globals()[name] += n


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc") or "")
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def build(source_dir: str = SOURCE_DIR,
          entry_points: Optional[Dict[str, tuple]] = None) -> Dict[str, ctypes._CFuncPtr]:
    """Build (once per version of the sources under ``source_dir``) and load
    each source of ``entry_points`` (``ENTRY_POINTS`` when ``None``: source
    -> (C entry point, argument types, flags added to ``NVCC_FLAGS``)) that
    ``source_dir`` holds into ``BUILD_DIR``; returns the C entry points by
    name.  Another version's ``csrc`` builds beside this one's (each library
    is keyed by a hash of the sources and of its flags).  Sets
    ``BUILD_SECONDS`` and ``BUILD_LOG`` when it compiles."""
    global BUILD_SECONDS, BUILD_LOG
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(source_dir, "*.cu*"))):  # headers too
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + b"\0" + fh.read())
    entry_points = {src: entry for src, entry in (entry_points or ENTRY_POINTS).items()
                    if os.path.exists(os.path.join(source_dir, src))}

    def digest(flags) -> str:
        return hashlib.sha256(h.digest() + " ".join(flags).encode()).hexdigest()[:16]

    libs = {src: os.path.join(BUILD_DIR, f"lib{src[:-3]}_{digest(flags)}.so")
            for src, (_, _, flags) in entry_points.items()}
    missing = [src for src, lib in libs.items() if not os.path.exists(lib)]
    if missing:
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        procs = {src: subprocess.Popen(  # one nvcc per source, all at once
            [_nvcc(), *NVCC_FLAGS, *entry_points[src][2], "-o",
             f"{libs[src]}.{os.getpid()}.tmp", os.path.join(source_dir, src)],
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
    for src, (entry, argtypes, _) in entry_points.items():
        lib = ctypes.CDLL(libs[src])
        for name, types in {entry: argtypes, **QUERIES.get(src, {})}.items():
            if name != entry and not hasattr(lib, name):
                continue  # an older version's source without the query
            fn = getattr(lib, name)
            fn.argtypes = types
            fn.restype = ctypes.c_int
            functions[name] = fn
    return functions


def ptxas_usage(log: str) -> Dict[str, Dict[str, int]]:
    """Registers, shared memory and spills of each kernel in a build's
    ``BUILD_LOG`` (``-Xptxas -v``), by its mangled name."""
    usage, name = {}, None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            name = found.group(1)
            usage[name] = {"registers": None, "smem_bytes": 0, "spill_stores": 0,
                           "spill_loads": 0}
            continue
        if name is None:
            continue
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spills:
            usage[name]["spill_stores"], usage[name]["spill_loads"] = map(int, spills.groups())
        used = re.search(r"Used (\d+) registers", line)
        if used:
            usage[name]["registers"] = int(used.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            usage[name]["smem_bytes"] = int(smem.group(1)) if smem else 0
    return usage


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


def _check_operands(device: torch.device, **tensors: torch.Tensor) -> None:
    """ValueError / TypeError unless every tensor is float32 on ``device``,
    a CUDA device."""
    for name, t in tensors.items():
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; all operands must be on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def _check_contiguous(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _call(fn: ctypes._CFuncPtr, device: torch.device, K: int, args: tuple) -> int:
    """``fn(*args, stream)`` on the current stream of ``device``; the first
    launch of each kernel on each device and block shape (K = 1, K > 1)
    holds a lock (the kernels cache their resident blocks per device
    then)."""
    first_use = (id(fn), device.index, K > 1)
    with torch.cuda.device(device):
        args = args + (torch.cuda.current_stream(device).cuda_stream,)
        if first_use in _LAUNCHED:
            return fn(*args)
        with _FIRST_USE_LOCK:
            rc = fn(*args)
            if rc == 0:
                _LAUNCHED.add(first_use)
            return rc


def _launch(entry: str, I: torch.Tensor, scalars: torch.Tensor, u: torch.Tensor,
            compat: bool, library: Optional[Dict[str, ctypes._CFuncPtr]] = None) -> torch.Tensor:
    """Check the operands of a B1 or B2 call and launch ``entry`` of
    ``library`` (a :func:`build`; this checkout's when ``None``) on the
    current stream; raises on anything the kernel does not take and on a
    failed launch."""
    B, K, m, n = _check_shapes(I, scalars, u)
    _check_operands(u.device, I=I, scalars=scalars, u=u)
    _check_contiguous(I=I, scalars=scalars, u=u)
    fn = (library or load_library())[entry]
    out = u.new_empty(u.shape)
    rc = _call(fn, u.device, K, (I.data_ptr(), scalars.data_ptr(), u.data_ptr(), out.data_ptr(),
                                 B, K, m, n, int(bool(compat))))
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {rc}")
    return out


def _check_tiled(I: torch.Tensor, scalars: torch.Tensor, u: torch.Tensor, tiles, halo,
                 out: Optional[torch.Tensor]):
    """(N, K, m, n, tx, ty) of a B3 call, or ValueError: ``u`` (B, [K,] 3,
    tx m, ty n), N = B tx ty frame blocks, without ``halo``; one tile (N,
    [K,] 3, m, n) and its four halo lines with it (tiles (1, 1))."""
    if u.dim() not in (4, 5) or u.shape[-3] != 3:
        raise ValueError(f"u must be (B, 3, M, N) or (B, K, 3, M, N), got {tuple(u.shape)}")
    K = u.shape[1] if u.dim() == 5 else 1
    tx, ty = tiles
    M, Nn = u.shape[-2:]
    if halo is None:
        if tx < 1 or ty < 1 or M % tx or Nn % ty:
            raise ValueError(f"the field {M}x{Nn} does not tile evenly over ({tx}, {ty})")
        if M < 2 or Nn < 2:
            raise ValueError(f"the field must be at least 2x2 (its mirror rows), got {M}x{Nn}")
    else:
        if (tx, ty) != (1, 1):
            raise ValueError("a tile with halo lines is one tile: tiles must be (1, 1)")
        lead = tuple(u.shape[:-2])
        want = [lead + (Nn + 2,)] * 2 + [lead + (M,)] * 2
        got = [tuple(h.shape) for h in halo]
        if got != want:
            raise ValueError(f"halo lines (top, bottom, left, right) must be {want}, got {got}")
    N, m, n = u.shape[0] * tx * ty, M // tx, Nn // ty
    if m < 1 or n < 1:
        raise ValueError(f"tiles must be at least 1x1, got {m}x{n}")
    if tuple(I.shape) != (N, m + 2, n + 2):
        raise ValueError(f"I must be {(N, m + 2, n + 2)}, got {tuple(I.shape)}")
    if tuple(scalars.shape) != (N, 2):
        raise ValueError(f"scalars must be {(N, 2)}, got {tuple(scalars.shape)}")
    if out is not None and out.shape != u.shape:
        raise ValueError(f"out must be {tuple(u.shape)}, got {tuple(out.shape)}")
    return N, K, m, n, tx, ty


def _plane_pitches(name: str, t: torch.Tensor):
    """(plane, row) pitches in floats of a (N, [K,] 3, m, n) tensor whose
    flattened leading axes index whole (m, n) planes ``plane`` apart, each
    of rows ``row`` apart with unit stride along them (a contiguous tensor,
    or a window of one), or ValueError."""
    m, n = t.shape[-2:]
    plane, row = t.stride(-3), t.stride(-2)
    ok = (t.stride(-1) == 1 or n == 1) and row >= n and plane >= (m - 1) * row + n
    expected = plane
    for d in range(t.dim() - 3, -1, -1):
        ok &= t.shape[d] == 1 or t.stride(d) == expected
        expected *= t.shape[d]
    if not ok:
        raise ValueError(f"{name} must be planes of one pitch with unit-stride rows "
                         f"(contiguous, or a window of a contiguous field)")
    return plane, row


def _line_pitches(name: str, t: torch.Tensor):
    """(plane, step) pitches in floats of a (N, [K,] 3, L) halo line whose
    flattened leading axes index whole lines ``plane`` apart, its elements
    ``step`` apart (a contiguous line, or a row or column of a field), or
    ValueError."""
    plane, step = t.stride(-2), t.stride(-1)
    ok = step >= 1 and plane >= (t.shape[-1] - 1) * step + 1
    expected = plane
    for d in range(t.dim() - 2, -1, -1):
        ok &= t.shape[d] == 1 or t.stride(d) == expected
        expected *= t.shape[d]
    if not ok:
        raise ValueError(f"the {name} halo line must be lines of one pitch (contiguous, or a "
                         f"row or column of a contiguous field)")
    return plane, step


def _launch_tiled(I: torch.Tensor, scalars: torch.Tensor, u: torch.Tensor, compat: bool,
                  tiles=(1, 1), halo=None, out: Optional[torch.Tensor] = None,
                  library: Optional[Dict[str, ctypes._CFuncPtr]] = None) -> torch.Tensor:
    """Check the operands of a B3 call (:func:`el_matvec_tiled`) and launch
    it from ``library`` (this checkout's build when ``None``) on the
    current stream; returns ``out``; raises on anything the kernel does not
    take and on a failed launch."""
    N, K, m, n, tx, ty = _check_tiled(I, scalars, u, tiles, halo, out)
    lines = dict(zip(("top", "bottom", "left", "right"), halo or ()))
    _check_operands(u.device, I=I, scalars=scalars, u=u, **lines,
                    **({} if out is None else {"out": out}))
    _check_contiguous(I=I, scalars=scalars)
    if halo is None:
        _check_contiguous(u=u, **({} if out is None else {"out": out}))
        line_args = (None,) * 4 + (0,) * 6
    else:
        pitches = {name: _line_pitches(name, t) for name, t in lines.items()}
        if pitches["top"][1] != 1 or pitches["bottom"][1] != 1:
            raise ValueError("the top and bottom halo lines must have unit-stride elements")
        line_args = (*(t.data_ptr() for t in halo), *(pitches[k][0] for k in lines),
                     pitches["left"][1], pitches["right"][1])
    if out is None:
        out = u.new_empty(u.shape)
    u_plane, u_row = _plane_pitches("u", u)
    out_plane, out_row = _plane_pitches("out", out)
    fn = (library or load_library())["el_matvec_tiled"]
    rc = _call(fn, u.device, K, (I.data_ptr(), scalars.data_ptr(), u.data_ptr(), out.data_ptr(),
                                 *line_args[:4], N, K, tx, ty, m, n, u_plane, u_row, out_plane,
                                 out_row, *line_args[4:], int(bool(compat))))
    if rc != 0:
        raise RuntimeError(f"el_matvec_tiled kernel launch failed: cudaError {rc}")
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


def el_matvec_tiled_ref(I: torch.Tensor, scalars: torch.Tensor, u: torch.Tensor, compat: bool,
                        tiles=(1, 1), halo=None,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel on mesh tiles: the EL stencil on
    every (m, n) tile, coefficients rebuilt from its (m+2, n+2) frame block
    ``I[t]`` and its ``scalars[t]`` = (alpha_s, alpha_r), the field
    extended by its seams.

    Without ``halo``: ``u`` (B, [K,] 3, tx m, ty n) is the whole interior
    field of B pairs, ``tiles`` = (tx, ty), tile (p, q) of pair b is block
    t = b tx ty + p ty + q; a seam reads the neighbour tile, a global edge
    the reduced system's mirror values (``elop.extend_interior``).  With
    ``halo`` = (top, bottom, left, right): ``u`` (N, [K,] 3, m, n) is one
    tile per block, extended by its rows above and below (N, [K,] 3, n +
    2), corners included, and its columns left and right (N, [K,] 3, m).
    Returns the (B, [K,] 3, tx m, ty n) / (N, [K,] 3, m, n) result, written
    into ``out`` when given.
    """
    _, _, _, _, tx, ty = _check_tiled(I, scalars, u, tiles, halo, out)
    _count("EXT_PLAIN_CALLS")
    if halo is None:
        # spmd imports this module, so its layout helpers are imported here
        from opticalflow_tpu_torch.parallel.spmd import from_tiles, to_tiles

        u_ext = to_tiles(elop.extend_interior(u), tx, ty)
        y = elop.interior_apply(_coefficients(I, scalars, u_ext, compat), u_ext)
        y = from_tiles(y, u.shape[0], tx, ty)
    else:
        top, bottom, left, right = halo
        mid = torch.cat([left[..., None], u, right[..., None]], dim=-1)
        u_ext = torch.cat([top[..., None, :], mid, bottom[..., None, :]], dim=-2)
        y = elop.interior_apply(_coefficients(I, scalars, u_ext, compat), u_ext)
    return y if out is None else out.copy_(y)


def el_matvec_tiled(I: torch.Tensor, scalars: torch.Tensor, u: torch.Tensor, compat: bool,
                    tiles=(1, 1), halo=None, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The stencil on mesh tiles of :func:`el_matvec_tiled_ref`, reading
    each tile and its seams where they lie: CUDA tensors go through kernel
    B3 (``u`` and ``out`` contiguous without ``halo``; with it, any window
    of a contiguous field, and each halo line contiguous or a row / column
    of one), CPU tensors through the plain version."""
    tensors = (I, scalars, u, *(halo or ()), *(() if out is None else (out,)))
    if _on_cpu(*tensors):
        return el_matvec_tiled_ref(I, scalars, u, compat, tiles, halo, out)
    out = _launch_tiled(I, scalars, u, compat, tiles, halo, out)
    _count("EXT_LAUNCHES")
    return out


def halo_lines(u_ext: torch.Tensor):
    """(top, bottom, left, right) halo lines of extended blocks (..., m+2,
    n+2): rows 0 and -1 (corners included) and columns 0 and -1 of the
    interior rows, as views."""
    return u_ext[..., 0, :], u_ext[..., -1, :], u_ext[..., 1:-1, 0], u_ext[..., 1:-1, -1]


def el_matvec_extended_ref(I: torch.Tensor, scalars: torch.Tensor, u: torch.Tensor,
                           compat: bool) -> torch.Tensor:
    """Plain PyTorch version of kernel B3 on the JAX kernel's operands,
    pre-extended blocks: ``I`` (N, m+2, n+2) blocks of the true frame with
    their halo, ``scalars`` (N, 2), ``u`` (N, 3, m+2, n+2) or (N, K, 3,
    m+2, n+2) field blocks already extended; returns the EL stencil (N,
    [K,] 3, m, n)."""
    _check_shapes(I, scalars, u, extended=True)
    _count("EXT_PLAIN_CALLS")
    return elop.interior_apply(_coefficients(I, scalars, u, compat), u)


def el_matvec_extended(I: torch.Tensor, scalars: torch.Tensor, u: torch.Tensor,
                       compat: bool) -> torch.Tensor:
    """The stencil on pre-extended blocks of :func:`el_matvec_extended_ref`;
    CUDA tensors go through kernel B3, each contiguous block read as its
    interior and its halo lines (views, not copied); CPU tensors through
    the plain version."""
    if _on_cpu(I, scalars, u):
        return el_matvec_extended_ref(I, scalars, u, compat)
    _check_shapes(I, scalars, u, extended=True)
    _check_contiguous(u=u)
    return el_matvec_tiled(I, scalars, u[..., 1:-1, 1:-1], compat, halo=halo_lines(u))


# ---------------------------------------------------------------------------
# Kernel B4: the df32 residual and operator of the refinement.
# ---------------------------------------------------------------------------

# ELPairDataDF's coefficient planes in B4's order (dIdy only in fixed mode)
DF32_PLANES = ("diag_x", "diag_y", "cross", "adv_xm", "adv_xp", "adv_ym", "adv_yp", "gx", "gy",
               "quart", "half_I", "dIdx", "dIdy")
DF32_SCALARS = ("a_s", "a_r", "gD")


class DF32Operands(NamedTuple):
    """The df32 system data of a batch of pairs as kernel B4 reads it,
    packed once per solve by :func:`pack_df32`; every field has the pairs
    on its first axis, so a subset of pairs is an ``index_select`` of each
    (``flow.variational._take``)."""

    planes: torch.Tensor  # (B, P, m, n): hi, lo of each of DF32_PLANES; P = 24 compat, 26 fixed
    scalars: torch.Tensor  # (B, 6): hi, lo of each of DF32_SCALARS
    rhs_hi: torch.Tensor  # (B, 3, m, n)
    rhs_lo: torch.Tensor


def pack_df32(dfd: elop.ELPairDataDF) -> DF32Operands:
    """Pack ``elop.compute_frame_pair_data_df``'s (B, m, n) pairs and (B, 1,
    1) per-pair pairs into contiguous tensors.  In compat mode, where
    ``dfd.dIdy`` is ``dfd.dIdx``, the dIdy planes are not stored (P = 24)."""
    names = DF32_PLANES[:-1] if dfd.dIdy is dfd.dIdx else DF32_PLANES
    planes = torch.stack([t for name in names for t in getattr(dfd, name)], dim=1)
    B = planes.shape[0]
    scalars = torch.stack([t.reshape(B) for name in DF32_SCALARS for t in getattr(dfd, name)],
                          dim=1)
    return DF32Operands(planes, scalars, dfd.rhs_hi.contiguous(), dfd.rhs_lo.contiguous())


def _df32_views(ops: DF32Operands) -> elop.ELPairDataDF:
    """``ops`` as the ``ELPairDataDF`` the plain versions take: views into
    the packed tensors, no copy."""
    names = DF32_PLANES[: ops.planes.shape[1] // 2]
    data = {name: (ops.planes[:, 2 * k], ops.planes[:, 2 * k + 1]) for k, name in enumerate(names)}
    data.setdefault("dIdy", data["dIdx"])
    for k, name in enumerate(DF32_SCALARS):
        data[name] = (ops.scalars[:, 2 * k, None, None], ops.scalars[:, 2 * k + 1, None, None])
    return elop.ELPairDataDF(**data, rhs_hi=ops.rhs_hi, rhs_lo=ops.rhs_lo)


def _check_df32(ops: DF32Operands, *fields: torch.Tensor):
    """(B, P, m, n) of a B4 call, or ValueError."""
    if ops.planes.dim() != 4 or ops.planes.shape[1] not in (24, 26):
        raise ValueError(f"planes must be (B, 24 or 26, m, n), got {tuple(ops.planes.shape)}")
    B, P, m, n = ops.planes.shape
    if m < 2 or n < 2:
        raise ValueError(f"the interior must be at least 2x2, got {m}x{n}")
    if tuple(ops.scalars.shape) != (B, 6):
        raise ValueError(f"scalars must be {(B, 6)}, got {tuple(ops.scalars.shape)}")
    for name, t in (("rhs_hi", ops.rhs_hi), ("rhs_lo", ops.rhs_lo)) + tuple(
            (f"x ({k})", x) for k, x in enumerate(fields)):
        if tuple(t.shape) != (B, 3, m, n):
            raise ValueError(f"{name} must be {(B, 3, m, n)}, got {tuple(t.shape)}")
    return B, P, m, n


def _launch_df32(ops: DF32Operands, x_hi: torch.Tensor, x_lo: Optional[torch.Tensor],
                 library: Optional[Dict[str, ctypes._CFuncPtr]] = None):
    """Check the operands of a B4 call and launch it from ``library`` (a
    :func:`build`; this checkout's when ``None``) on the current stream
    (residual mode with ``x_lo``, operator mode without); raises on anything
    the kernel does not take and on a failed launch."""
    fields = (x_hi,) if x_lo is None else (x_hi, x_lo)
    B, P, m, n = _check_df32(ops, *fields)
    tensors = dict(planes=ops.planes, scalars=ops.scalars, x_hi=x_hi)
    if x_lo is not None:
        tensors.update(rhs_hi=ops.rhs_hi, rhs_lo=ops.rhs_lo, x_lo=x_lo)
    _check_operands(x_hi.device, **tensors)
    _check_contiguous(**tensors)
    out = x_hi.new_empty(x_hi.shape)
    ptr = {name: t.data_ptr() for name, t in tensors.items()}
    rc = _call((library or load_library())["el_df32"], x_hi.device, 1,
               (ptr["planes"], ptr["scalars"], ptr.get("rhs_hi"), ptr.get("rhs_lo"),
                ptr["x_hi"], ptr.get("x_lo"), out.data_ptr(), B, P, m, n,
                int(x_lo is not None)))
    if rc != 0:
        raise RuntimeError(f"el_df32 kernel launch failed: cudaError {rc}")
    return out


def df32_warps_per_sm(P: int, residual: bool, device: torch.device,
                      library: Optional[Dict[str, ctypes._CFuncPtr]] = None) -> Optional[int]:
    """Warps of kernel B4 resident on one SM of ``device`` at once (CUDA's
    occupancy calculator on the kernel's registers and shared memory), for
    P planes and the mode; ``None`` for a build without the query."""
    fn = (library or load_library()).get("el_df32_warps_per_sm")
    if fn is None:
        return None
    warps = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = fn(P, int(residual), ctypes.addressof(warps))
    if rc != 0:
        raise RuntimeError(f"el_df32_warps_per_sm failed: cudaError {rc}")
    return warps.value


def el_residual_df32_ref(ops: DF32Operands, x_hi: torch.Tensor,
                         x_lo: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel B4 in residual mode:
    ``elop.el_residual_df`` on views into ``ops``, ``b - A (x_hi + x_lo)``
    of the df32 system for (B, 3, m, n) fields."""
    _check_df32(ops, x_hi, x_lo)
    _count("DF_PLAIN_CALLS")
    return elop.el_residual_df(_df32_views(ops), x_hi, x_lo)


def el_residual_df32(ops: DF32Operands, x_hi: torch.Tensor, x_lo: torch.Tensor) -> torch.Tensor:
    """``b - A (x_hi + x_lo)`` of :func:`el_residual_df32_ref`: CUDA tensors
    go through kernel B4 (float32, contiguous), bitwise equal to the plain
    version; CPU tensors through the plain version."""
    if _on_cpu(*ops, x_hi, x_lo):
        return el_residual_df32_ref(ops, x_hi, x_lo)
    out = _launch_df32(ops, x_hi, x_lo)
    _count("DF_LAUNCHES")
    return out


def el_matvec_df32_ref(ops: DF32Operands, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel B4 in operator mode:
    ``elop.el_matvec_df`` on views into ``ops``, ``A x`` against the df32
    system data for (B, 3, m, n) fields."""
    _check_df32(ops, x)
    _count("DF_PLAIN_CALLS")
    return elop.el_matvec_df(_df32_views(ops), x)


def el_matvec_df32(ops: DF32Operands, x: torch.Tensor) -> torch.Tensor:
    """``A x`` of :func:`el_matvec_df32_ref`: CUDA tensors go through kernel
    B4 (float32, contiguous), bitwise equal to the plain version; CPU
    tensors through the plain version."""
    if _on_cpu(ops.planes, ops.scalars, x):
        return el_matvec_df32_ref(ops, x)
    out = _launch_df32(ops, x, None)
    _count("DF_LAUNCHES")
    return out


# ---------------------------------------------------------------------------
# Kernels B5 and B6: the multigrid V-cycle's smoothing sweeps, stencil
# apply, residual-and-restrict and prolong-and-add.
# ---------------------------------------------------------------------------

# B5's modes (csrc/mg_smooth.cu)
MG_ZERO_GUESS, MG_FINE, MG_SWEEP, MG_APPLY = 0, 1, 2, 3
# B6's modes (csrc/mg_transfer.cu): restriction with bit 0 = S x (else y),
# bit 1 = b minus it; prolongation with bit 0 = x plus it; the sweep fused
# into the residual-and-restrict, and the prolong-add into the sweep
MGT_RESTRICT, MGT_PROLONG, MGT_SWEEP_RESTRICT, MGT_PROLONG_SWEEP = 0, 4, 6, 7
# B6's grid: the pair is its z block index, at most 65,535; its index math
# within a field is 32-bit
MGT_MAX_PAIRS = 65535


def _level_shape(S: Optional[torch.Tensor], binv: Optional[torch.Tensor]):
    """(B, M, N) of a level's stencil S (B, 3, 3, 3, 3, M, N) and block
    inverse binv (B, 3, 3, M, N), either of them None, or ValueError."""
    if binv is not None:
        if binv.dim() != 5 or tuple(binv.shape[1:3]) != (3, 3):
            raise ValueError(f"binv must be (B, 3, 3, M, N), got {tuple(binv.shape)}")
        B, M, N = binv.shape[0], binv.shape[3], binv.shape[4]
        if S is not None and tuple(S.shape) != (B, 3, 3, 3, 3, M, N):
            raise ValueError(f"S must be {(B, 3, 3, 3, 3, M, N)}, got {tuple(S.shape)}")
        return B, M, N
    if S.dim() != 7 or tuple(S.shape[1:5]) != (3, 3, 3, 3):
        raise ValueError(f"S must be (B, 3, 3, 3, 3, M, N), got {tuple(S.shape)}")
    return S.shape[0], S.shape[5], S.shape[6]


def mg_check_level(S: Optional[torch.Tensor], binv: Optional[torch.Tensor]):
    """(B, M, N) of a level's operands (:func:`_level_shape`), checked for
    B5 and B6 as ``multigrid.setup`` and ``take`` check them, once per
    hierarchy: on CUDA, float32, contiguous and on one device, or
    ValueError / TypeError."""
    B, M, N = _level_shape(S, binv)
    tensors = {name: t for name, t in (("S", S), ("binv", binv)) if t is not None}
    if not _on_cpu(*tensors.values()):
        _check_operands(next(iter(tensors.values())).device, **tensors)
        _check_contiguous(**tensors)
    return B, M, N


def _field_k(name: str, t: torch.Tensor, B: int, M: int, N: int, k_axis: bool) -> int:
    """K of a (B, 3, M, N) field (1) or, with ``k_axis``, a (B, K, 3, M, N)
    stack, or ValueError."""
    if t.dim() == 4 and tuple(t.shape) == (B, 3, M, N):
        return 1
    if k_axis and t.dim() == 5 and t.shape[0] == B and tuple(t.shape[2:]) == (3, M, N):
        return t.shape[1]
    raise ValueError(f"{name} must be {(B, 3, M, N)}{' or (B, K, 3, M, N)' if k_axis else ''}, "
                     f"got {tuple(t.shape)}")


def _fields_k(B: int, M: int, N: int, k_axis: bool, **fields: Optional[torch.Tensor]) -> int:
    """The one K of the given fields (None skipped), or ValueError."""
    ks = {_field_k(name, t, B, M, N, k_axis) for name, t in fields.items() if t is not None}
    shapes = {t.dim() for t in fields.values() if t is not None}
    if len(ks) > 1 or len(shapes) > 1:
        raise ValueError(f"the fields must have one shape, got "
                         f"{[tuple(t.shape) for t in fields.values() if t is not None]}")
    return ks.pop()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_mg(entry: str, counter: str, device: torch.device, K: int, out: torch.Tensor,
               args: tuple) -> torch.Tensor:
    """Launch B5 or B6 (``entry``) on the current stream of ``device``;
    raises on a failed launch, else counts it."""
    rc = _call(load_library()[entry], device, K, args)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {rc}")
    _count(counter)
    return out


def _cuda_fields(device: torch.device, **fields: Optional[torch.Tensor]) -> None:
    """The per-call checks of B5's and B6's fields: float32, contiguous, on
    the level operands' CUDA ``device``."""
    given = {name: t for name, t in fields.items() if t is not None}
    _check_operands(device, **given)
    _check_contiguous(**given)


def _smooth_call(mode: int, S, binv, x, b, y, damp: float, checked: bool) -> torch.Tensor:
    """Check and launch one B5 sweep (``mode`` zero guess, fine or sweep)."""
    B, M, N = (_level_shape if checked else mg_check_level)(S, binv)
    _fields_k(B, M, N, False, x=x, b=b, y=y)
    _cuda_fields(binv.device, x=x, b=b, y=y)
    out = b.new_empty(b.shape)
    return _launch_mg("mg_smooth", "MG_LAUNCHES", b.device, 1, out,
                      (_ptr(S), binv.data_ptr(), _ptr(x), b.data_ptr(), _ptr(y), out.data_ptr(),
                       B, 1, M, N, damp, mode))


def mg_smooth_ref(S: Optional[torch.Tensor], binv: torch.Tensor, x: Optional[torch.Tensor],
                  b: torch.Tensor, damp: float) -> torch.Tensor:
    """Plain version of B5's sweep on a probed level:
    ``multigrid.smooth_level``, x + damp Binv (b - S x), or damp Binv b for
    ``x=None`` (then ``S`` may be None); fields (B, 3, M, N)."""
    from opticalflow_tpu_torch.solve import multigrid  # multigrid imports this module

    B, M, N = _level_shape(S, binv)
    _fields_k(B, M, N, False, x=x, b=b)
    _count("MG_PLAIN_CALLS")
    return multigrid.smooth_level(S, binv, x, b, damp)


def mg_smooth(S: Optional[torch.Tensor], binv: torch.Tensor, x: Optional[torch.Tensor],
              b: torch.Tensor, damp: float, checked: bool = False) -> torch.Tensor:
    """One damped block-Jacobi sweep of a probed level
    (:func:`mg_smooth_ref`): CUDA tensors go through kernel B5 (float32,
    contiguous; ``checked``: S and binv were checked by
    :func:`mg_check_level`, so only their shapes are compared here), bit for
    bit its plain version; CPU tensors through the plain version."""
    if _on_cpu(*(t for t in (S, binv, x, b) if t is not None)):
        return mg_smooth_ref(S, binv, x, b, damp)
    if x is None:
        return _smooth_call(MG_ZERO_GUESS, None, binv, None, b, None, damp, checked)
    if S is None:
        raise ValueError("a sweep from x needs the level's stencil S")
    return _smooth_call(MG_SWEEP, S, binv, x, b, None, damp, checked)


def mg_smooth_fine_ref(binv: torch.Tensor, x: Optional[torch.Tensor], b: torch.Tensor,
                       y: Optional[torch.Tensor], damp: float) -> torch.Tensor:
    """Plain version of B5's level-0 epilogue: ``multigrid.smooth_fine``, x +
    damp Binv (b - y) around the fine matvec's output y = A x, or damp Binv b
    for ``x=None``."""
    from opticalflow_tpu_torch.solve import multigrid

    B, M, N = _level_shape(None, binv)
    _fields_k(B, M, N, False, x=x, b=b, y=y)
    if (x is None) != (y is None):
        raise ValueError("x and y are given together (a sweep) or neither (the zero guess)")
    _count("MG_PLAIN_CALLS")
    return multigrid.smooth_fine(binv, x, b, y, damp)


def mg_smooth_fine(binv: torch.Tensor, x: Optional[torch.Tensor], b: torch.Tensor,
                   y: Optional[torch.Tensor], damp: float, checked: bool = False) -> torch.Tensor:
    """The level-0 sweep around the fine matvec of
    :func:`mg_smooth_fine_ref`: CUDA tensors go through kernel B5, bit for
    bit its plain version; CPU tensors through the plain version."""
    if _on_cpu(*(t for t in (binv, x, b, y) if t is not None)):
        return mg_smooth_fine_ref(binv, x, b, y, damp)
    if (x is None) != (y is None):
        raise ValueError("x and y are given together (a sweep) or neither (the zero guess)")
    mode = MG_ZERO_GUESS if x is None else MG_FINE
    return _smooth_call(mode, None, binv, x, b, y, damp, checked)


def mg_stencil_apply_ref(S: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Plain version of B5's stencil apply: ``multigrid.stencil_matvec``, S u
    for (B, 3, M, N) or (B, K, 3, M, N) fields, S broadcast over K."""
    from opticalflow_tpu_torch.solve import multigrid

    B, M, N = _level_shape(S, None)
    _field_k("u", u, B, M, N, True)
    _count("MG_PLAIN_CALLS")
    return multigrid.stencil_matvec(S, u)


def mg_stencil_apply(S: torch.Tensor, u: torch.Tensor, checked: bool = False) -> torch.Tensor:
    """S u of :func:`mg_stencil_apply_ref` (a probed level's operator, the
    probes' K = 27 and the coarsest operator's K = 3 m n included): CUDA
    tensors go through kernel B5, bit for bit its plain version; CPU tensors
    through the plain version."""
    if _on_cpu(S, u):
        return mg_stencil_apply_ref(S, u)
    B, M, N = (_level_shape if checked else mg_check_level)(S, None)
    K = _field_k("u", u, B, M, N, True)
    _cuda_fields(S.device, u=u)
    out = u.new_empty(u.shape)
    return _launch_mg("mg_smooth", "MG_LAUNCHES", u.device, K, out,
                      (S.data_ptr(), None, u.data_ptr(), None, None, out.data_ptr(), B, K, M, N,
                       0.0, MG_APPLY))


def mg_residual_restrict_ref(S: Optional[torch.Tensor], x: Optional[torch.Tensor],
                             b: Optional[torch.Tensor], y: Optional[torch.Tensor],
                             coarse_shape) -> torch.Tensor:
    """Plain version of B6's restriction: ``multigrid.residual_restrict``, R
    (b - S x) with ``S``, R (b - y) with ``y``, and without ``b`` R (S x) or
    R y; fields (B, [K,] 3, M, N), the result (B, [K,] 3, Mc, Nc)."""
    from opticalflow_tpu_torch.solve import multigrid

    _check_restrict(S, x, b, y, coarse_shape)
    _count("MGT_PLAIN_CALLS")
    return multigrid.residual_restrict(S, x, b, y, coarse_shape)


def _check_coarse(M: int, N: int, coarse_shape) -> None:
    if tuple(coarse_shape) != ((M + 1) // 2, (N + 1) // 2):
        raise ValueError(f"the coarse grid of {M}x{N} is {((M + 1) // 2, (N + 1) // 2)}, got "
                         f"{tuple(coarse_shape)}")


def _check_grid(B: int, K: int, M: int, N: int) -> None:
    """ValueError unless B6's grid takes B pairs of K probes on an M x N
    grid: B at most ``MGT_MAX_PAIRS``, the K probes' tiles and a level's 81
    stencil planes below 2^31 (32-bit index math)."""
    if B > MGT_MAX_PAIRS:
        raise ValueError(f"B6 takes at most {MGT_MAX_PAIRS} pairs, got {B}")
    if 81 * M * N >= 2**31 or K * M * N >= 2**31:
        raise ValueError(f"B6 takes grids of fewer than 2^31 / 81 pixels, got {M}x{N}")


def _check_restrict(S, x, b, y, coarse_shape, checked: bool = False):
    """(B, K, M, N, Mc, Nc, mode) of a B6 restriction, or ValueError."""
    if (S is None) == (y is None) or (S is None) != (x is None):
        raise ValueError("give S and x (R of S x) or y (R of y), not both")
    fine = x if S is not None else y
    if fine.dim() not in (4, 5):
        raise ValueError(f"fields must be (B, [K,] 3, M, N), got {tuple(fine.shape)}")
    B, M, N = fine.shape[0], fine.shape[-2], fine.shape[-1]
    if S is not None:
        B, M, N = (_level_shape if checked else mg_check_level)(S, None)
    K = _fields_k(B, M, N, True, x=x, b=b, y=y)
    _check_coarse(M, N, coarse_shape)
    mode = MGT_RESTRICT + int(S is not None) + 2 * int(b is not None)
    return B, K, M, N, coarse_shape[0], coarse_shape[1], mode


def _launch_mgt(device: torch.device, K: int, out: torch.Tensor, S=None, binv=None, x=None,
                b=None, y=None, e=None, out2=None, shape=(), damp: float = 0.0,
                mode: int = 0) -> torch.Tensor:
    """Launch one B6 instance (``shape`` = (B, K, Mf, Nf, Mc, Nc)) after
    checking its grid."""
    _check_grid(*shape[:4])
    return _launch_mg("mg_transfer", "MGT_LAUNCHES", device, K, out,
                      (_ptr(S), _ptr(binv), _ptr(x), _ptr(b), _ptr(y), _ptr(e), out.data_ptr(),
                       _ptr(out2), *shape, damp, mode))


def mg_residual_restrict(S: Optional[torch.Tensor], x: Optional[torch.Tensor],
                         b: Optional[torch.Tensor], y: Optional[torch.Tensor], coarse_shape,
                         checked: bool = False) -> torch.Tensor:
    """The restricted residual of :func:`mg_residual_restrict_ref`: CUDA
    tensors go through kernel B6 (one launch: each block computes the
    residual of its fine tile and restricts it), bit for bit its plain
    version; CPU tensors through the plain version."""
    tensors = [t for t in (S, x, b, y) if t is not None]
    if _on_cpu(*tensors):
        return mg_residual_restrict_ref(S, x, b, y, coarse_shape)
    B, K, M, N, Mc, Nc, mode = _check_restrict(S, x, b, y, coarse_shape, checked)
    fine = x if S is not None else y
    _cuda_fields((S if S is not None else fine).device, x=x, b=b, y=y)
    out = fine.new_empty(fine.shape[:-2] + (Mc, Nc))
    return _launch_mgt(fine.device, K, out, S=S, x=x, b=b, y=y, shape=(B, K, M, N, Mc, Nc),
                       mode=mode)


def _check_prolong(x, e, fine_shape):
    """(B, K, M, N, Mc, Nc, mode) of a B6 prolongation, or ValueError."""
    if e.dim() not in (4, 5) or e.shape[-3] != 3:
        raise ValueError(f"e must be (B, [K,] 3, Mc, Nc), got {tuple(e.shape)}")
    M, N = fine_shape
    Mc, Nc = e.shape[-2:]
    _check_coarse(M, N, (Mc, Nc))
    if x is not None and tuple(x.shape) != tuple(e.shape[:-2]) + (M, N):
        raise ValueError(f"x must be {tuple(e.shape[:-2]) + (M, N)}, got {tuple(x.shape)}")
    K = e.shape[1] if e.dim() == 5 else 1
    return e.shape[0], K, M, N, Mc, Nc, MGT_PROLONG + int(x is not None)


def mg_prolong_add_ref(x: Optional[torch.Tensor], e: torch.Tensor, fine_shape) -> torch.Tensor:
    """Plain version of B6's prolongation: ``multigrid.prolong_add``, x + P e,
    or P e with ``x=None``; e (B, [K,] 3, Mc, Nc)."""
    from opticalflow_tpu_torch.solve import multigrid

    _check_prolong(x, e, fine_shape)
    _count("MGT_PLAIN_CALLS")
    return multigrid.prolong_add(x, e, fine_shape)


def mg_prolong_add(x: Optional[torch.Tensor], e: torch.Tensor, fine_shape) -> torch.Tensor:
    """x + P e of :func:`mg_prolong_add_ref`: CUDA tensors go through kernel
    B6, bit for bit its plain version; CPU tensors through the plain
    version."""
    if _on_cpu(*(t for t in (x, e) if t is not None)):
        return mg_prolong_add_ref(x, e, fine_shape)
    B, K, M, N, Mc, Nc, mode = _check_prolong(x, e, fine_shape)
    _cuda_fields(e.device, x=x, e=e)
    out = e.new_empty(tuple(e.shape[:-2]) + (M, N))
    return _launch_mgt(e.device, K, out, x=x, e=e, shape=(B, K, M, N, Mc, Nc), mode=mode)


def _check_fused(S, binv, x, b, e=None, coarse_shape=None, checked: bool = False):
    """(B, M, N, Mc, Nc) of a fused B6 stage on a probed level: S and binv
    the level's, x and b (B, 3, M, N), e (B, 3, Mc, Nc); or ValueError."""
    if S is None or x is None:
        raise ValueError("a fused stage sweeps from x on a probed level: it needs S and x")
    B, M, N = (_level_shape if checked else mg_check_level)(S, binv)
    _fields_k(B, M, N, False, x=x, b=b)
    Mc, Nc = (M + 1) // 2, (N + 1) // 2
    if coarse_shape is not None:
        _check_coarse(M, N, coarse_shape)
    if e is not None and tuple(e.shape) != (B, 3, Mc, Nc):
        raise ValueError(f"e must be {(B, 3, Mc, Nc)}, got {tuple(e.shape)}")
    return B, M, N, Mc, Nc


def mg_smooth_restrict_ref(S: torch.Tensor, binv: torch.Tensor, x: torch.Tensor,
                           b: torch.Tensor, damp: float, coarse_shape):
    """Plain version of B6's sweep-residual-restrict:
    ``multigrid.smooth_restrict``, (x1, R (b - S x1)) with x1 = x + damp
    Binv (b - S x); fields (B, 3, M, N)."""
    from opticalflow_tpu_torch.solve import multigrid

    _check_fused(S, binv, x, b, coarse_shape=coarse_shape, checked=True)
    _count("MGT_PLAIN_CALLS")
    return multigrid.smooth_restrict(S, binv, x, b, damp, coarse_shape)


def mg_smooth_restrict(S: torch.Tensor, binv: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                       damp: float, coarse_shape, checked: bool = False):
    """The last pre-sweep of a probed level and its restricted residual
    (:func:`mg_smooth_restrict_ref`) in one launch of kernel B6 on CUDA
    tensors, S read once for both, bit for bit its plain version; CPU
    tensors through the plain version."""
    if _on_cpu(S, binv, x, b):
        return mg_smooth_restrict_ref(S, binv, x, b, damp, coarse_shape)
    B, M, N, Mc, Nc = _check_fused(S, binv, x, b, coarse_shape=coarse_shape, checked=checked)
    _cuda_fields(binv.device, x=x, b=b)
    x1 = x.new_empty(x.shape)
    out = x.new_empty(x.shape[:-2] + (Mc, Nc))
    _launch_mgt(x.device, 1, out, S=S, binv=binv, x=x, b=b, out2=x1,
                shape=(B, 1, M, N, Mc, Nc), damp=damp, mode=MGT_SWEEP_RESTRICT)
    return x1, out


def mg_prolong_smooth_ref(S: torch.Tensor, binv: torch.Tensor, x: torch.Tensor, e: torch.Tensor,
                          b: torch.Tensor, damp: float) -> torch.Tensor:
    """Plain version of B6's prolong-add-sweep: ``multigrid.prolong_smooth``,
    the sweep from xp = x + P e, xp + damp Binv (b - S xp)."""
    from opticalflow_tpu_torch.solve import multigrid

    _check_fused(S, binv, x, b, e=e, checked=True)
    _count("MGT_PLAIN_CALLS")
    return multigrid.prolong_smooth(S, binv, x, e, b, damp)


def mg_prolong_smooth(S: torch.Tensor, binv: torch.Tensor, x: torch.Tensor, e: torch.Tensor,
                      b: torch.Tensor, damp: float, checked: bool = False) -> torch.Tensor:
    """The prolong-add and the first post-sweep of a probed level
    (:func:`mg_prolong_smooth_ref`) in one launch of kernel B6 on CUDA
    tensors (x + P e never written), bit for bit its plain version; CPU
    tensors through the plain version."""
    if _on_cpu(S, binv, x, e, b):
        return mg_prolong_smooth_ref(S, binv, x, e, b, damp)
    B, M, N, Mc, Nc = _check_fused(S, binv, x, b, e=e, checked=checked)
    _cuda_fields(binv.device, x=x, e=e, b=b)
    out = x.new_empty(x.shape)
    return _launch_mgt(x.device, 1, out, S=S, binv=binv, x=x, b=b, e=e,
                       shape=(B, 1, M, N, Mc, Nc), damp=damp, mode=MGT_PROLONG_SWEEP)
