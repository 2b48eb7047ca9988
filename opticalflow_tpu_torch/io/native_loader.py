"""ctypes binding to the repository's native multithreaded movie loader.

Counterpart of ``opticalflow_tpu.io.native_loader``.  ``native/loader.cpp``
is a dependency-free C++ decoder for uncompressed grayscale TIFF stacks
(single/multi-page, 8/16/32-bit, II/MM) and PGM, decoding all frames of a
stack in parallel into one contiguous float32 buffer.  The port builds it
on first use with ``g++`` into ``_build/libofloader.so`` beside the package
(rebuilt when ``loader.cpp`` is newer, as make would), never into
``native/``; when neither the library nor a compiler is available, callers
fall back to the Python readers in ``io.sequences``.  Host file I/O: no
device is involved.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import List, Optional

import numpy as np

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PACKAGE), "native", "loader.cpp")
BUILD_DIR = os.path.join(_PACKAGE, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libofloader.so")
GXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared"]

_lib = None
_lib_lock = threading.Lock()


def _stale() -> bool:
    return (not os.path.exists(LIB_PATH)
            or (os.path.exists(SOURCE) and os.path.getmtime(SOURCE) > os.path.getmtime(LIB_PATH)))


def _build() -> bool:
    """Compile ``loader.cpp`` into ``LIB_PATH`` (written under a temporary
    name, then renamed, so concurrent builders never load a partial file);
    False without the source or a compiler, or when g++ fails."""
    gxx = shutil.which("g++")
    if gxx is None or not os.path.exists(SOURCE):
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, SOURCE], check=True, capture_output=True)
    except subprocess.CalledProcessError:
        return False
    os.replace(tmp, LIB_PATH)
    return True


def load_library() -> Optional[ctypes.CDLL]:
    """The loader library, building it on first use; None if unavailable."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _stale() and not _build() and not os.path.exists(LIB_PATH):
            return None
        lib = ctypes.CDLL(LIB_PATH)
        lib.ofl_version.argtypes = []
        lib.ofl_version.restype = ctypes.c_int
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.ofl_tiff_query.argtypes = [ctypes.c_char_p, i64p, i64p, i64p, i64p]
        lib.ofl_tiff_query.restype = ctypes.c_int
        lib.ofl_tiff_read.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.ofl_tiff_read.restype = ctypes.c_int
        lib.ofl_image_query.argtypes = [ctypes.c_char_p, i64p, i64p, i64p]
        lib.ofl_image_query.restype = ctypes.c_int
        lib.ofl_sequence_read.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ]
        lib.ofl_sequence_read.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


def read_tiff_movie_native(path: str, max_frames: Optional[int] = None) -> np.ndarray:
    """(T, X, Y) float32 stack from an uncompressed grayscale TIFF, pages
    decoded in parallel; ``ValueError`` for a TIFF it cannot parse."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native loader unavailable (no library and no compiler)")
    frames = ctypes.c_int64()
    height = ctypes.c_int64()
    width = ctypes.c_int64()
    bits = ctypes.c_int64()
    rc = lib.ofl_tiff_query(path.encode(), ctypes.byref(frames), ctypes.byref(height),
                            ctypes.byref(width), ctypes.byref(bits))
    if rc != 0:
        raise ValueError(f"not a parseable TIFF stack: {path} (code {rc})")
    n = frames.value if max_frames is None else min(frames.value, max_frames)
    out = np.empty((n, height.value, width.value), dtype=np.float32)
    rc = lib.ofl_tiff_read(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                           n, height.value, width.value)
    if rc != 0:
        raise ValueError(f"failed to decode TIFF stack: {path} (code {rc})")
    return out


def read_sequence_native(paths: List[str]) -> np.ndarray:
    """(T, X, Y) float32 stack from same-shaped single-frame TIFF/PGM files,
    decoded in parallel."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    if not paths:
        raise ValueError("empty path list")
    height = ctypes.c_int64()
    width = ctypes.c_int64()
    bits = ctypes.c_int64()
    rc = lib.ofl_image_query(paths[0].encode(), ctypes.byref(height),
                             ctypes.byref(width), ctypes.byref(bits))
    if rc != 0:
        raise ValueError(f"cannot parse {paths[0]} (code {rc})")
    out = np.empty((len(paths), height.value, width.value), dtype=np.float32)
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    rc = lib.ofl_sequence_read(arr, len(paths),
                               out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                               height.value, width.value)
    if rc != 0:
        raise ValueError(f"failed to decode sequence (code {rc})")
    return out
