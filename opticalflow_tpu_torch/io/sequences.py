"""Image-sequence and TIFF-stack loading (host-side).

Counterpart of ``opticalflow_tpu.io.sequences``: the reference's
numerically sorted sequence reader, its ``tifffile.imread`` of TIFF stacks,
and the file-renaming utilities.  Readers in the JAX package's order: the
native parallel decoder (``io.native_loader``) first, then cv2, tifffile
and PIL, whichever is installed.  Returns host numpy arrays.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import List

import numpy as np

from opticalflow_tpu_torch.io import native_loader

_NONDIGITS = re.compile(r"\D")


def numerical_sort_key(filename: str) -> int:
    """Sort key: the integer formed by every digit in the name."""
    digits = _NONDIGITS.sub("", filename)
    return int(digits) if digits else -1


def sort_filenames_numerically(filenames: List[str]) -> List[str]:
    return sorted(filenames, key=numerical_sort_key)


def list_file_paths_in_folder_numerically(path_to_folder: str) -> List[str]:
    paths = [
        os.path.join(path_to_folder, name)
        for name in os.listdir(path_to_folder)
        if os.path.isfile(os.path.join(path_to_folder, name))
    ]
    return sort_filenames_numerically(paths)


def _imread(path: str) -> np.ndarray:
    """Read one image preserving bit depth (cv2 IMREAD_UNCHANGED semantics),
    falling back from cv2 to tifffile to PIL depending on availability."""
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is not None:
            return img
    except ImportError:
        pass
    try:
        import tifffile

        return tifffile.imread(path)
    except (ImportError, ValueError, OSError):
        pass
    from PIL import Image

    return np.asarray(Image.open(path))


def read_image_sequence(path_to_images: str) -> List[np.ndarray]:
    """Numerically ordered list of frames from a folder."""
    return [_imread(p) for p in list_file_paths_in_folder_numerically(path_to_images)]


def read_image_sequence_as_movie(path_to_images: str, dtype=np.float64) -> np.ndarray:
    """(T, X, Y) stack from a folder of same-shaped single-channel images.

    TIFF/PGM sequences go through the native parallel decoder when
    available; anything else uses the per-file Python readers."""
    paths = list_file_paths_in_folder_numerically(path_to_images)
    if (paths and all(p.lower().endswith((".tif", ".tiff", ".pgm")) for p in paths)
            and native_loader.available()):
        try:
            return np.asarray(native_loader.read_sequence_native(paths), dtype=dtype)
        except ValueError:
            pass
    frames = read_image_sequence(path_to_images)
    return np.stack([np.asarray(f, dtype=dtype) for f in frames])


def read_tiff_movie(path: str, dtype=np.float64) -> np.ndarray:
    """A multi-page TIFF as a (T, X, Y) stack: the native loader for
    uncompressed grayscale stacks, else tifffile, else PIL."""
    if native_loader.available():
        try:
            return np.asarray(native_loader.read_tiff_movie_native(path), dtype=dtype)
        except ValueError:
            pass  # compressed / exotic TIFF -> the Python readers
    try:
        import tifffile

        data = tifffile.imread(path)
    except ImportError:
        from PIL import Image

        img = Image.open(path)
        frames = []
        for k in range(getattr(img, "n_frames", 1)):
            img.seek(k)
            frames.append(np.asarray(img))
        data = np.stack(frames)
    return np.asarray(data, dtype=dtype)


def rename_images(source_folder: str, target_folder: str,
                  remove_substring: str) -> List[str]:
    """Copy every file from ``source_folder`` to ``target_folder`` with
    ``remove_substring`` stripped from its name."""
    os.makedirs(target_folder, exist_ok=True)
    renamed = []
    for name in sorted(os.listdir(source_folder)):
        new_name = name.replace(remove_substring, "")
        shutil.copy2(os.path.join(source_folder, name),
                     os.path.join(target_folder, new_name))
        renamed.append(new_name)
    return renamed


def renumber_files(folder: str, offset: int, pattern: str = r"(\d+)",
                   dry_run: bool = False) -> List[str]:
    """Shift the numeric part of every filename by ``offset``."""
    renamed = []
    for name in sorted(os.listdir(folder)):
        match = re.search(pattern, name)
        if not match:
            continue
        number = int(match.group(1)) + offset
        new_name = name[: match.start(1)] + str(number) + name[match.end(1):]
        renamed.append(new_name)
        if not dry_run:
            os.rename(os.path.join(folder, name), os.path.join(folder, new_name))
    return renamed
