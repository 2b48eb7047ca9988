"""Result caching / checkpoint-resume.

Counterpart of ``opticalflow_tpu.utils.cache``: results are cached under a
content hash of (movie, config), so re-running an experiment with unchanged
inputs is a load.  The key is the JAX package's for the same numpy movie and
config, and the files are the same ``np.save`` of the result dict, so a
cache written by one package is read by the other.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Callable, Optional

import numpy as np

from opticalflow_tpu_torch.core.types import FlowResult
from opticalflow_tpu_torch.utils.device import to_host


def config_hash(movie, **config) -> str:
    """Stable hash of the movie contents (on the host: a tensor is copied
    there first) + the configuration values."""
    hasher = hashlib.sha256()
    arr = np.ascontiguousarray(to_host(movie))
    hasher.update(str(arr.shape).encode())
    hasher.update(str(arr.dtype).encode())
    hasher.update(arr.tobytes())
    hasher.update(json.dumps(config, sort_keys=True, default=repr).encode())
    return hasher.hexdigest()[:16]


class ResultCache:
    """Directory-backed cache of FlowResults keyed by config hash."""

    def __init__(self, cache_dir: str):
        self.cache_dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)

    def path_for(self, key: str) -> str:
        return os.path.join(self.cache_dir, f"flow_{key}.npy")

    def get(self, key: str) -> Optional[FlowResult]:
        path = self.path_for(key)
        if os.path.exists(path):
            return FlowResult.load(path)
        return None

    def put(self, key: str, result: FlowResult) -> str:
        path = self.path_for(key)
        tmp = path + ".tmp.npy"
        result.save(tmp)
        os.replace(tmp, path)
        return path

    def get_or_compute(self, movie, compute: Callable[[], FlowResult], **config) -> FlowResult:
        key = config_hash(movie, **config)
        cached = self.get(key)
        if cached is not None:
            return cached
        result = compute()
        self.put(key, result)
        return result
