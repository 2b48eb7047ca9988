"""Device meshes for the sharded solve.

Counterpart of ``opticalflow_tpu.parallel.mesh``: the same
``('frames', 'tx', 'ty')`` axes (frame-pair parallelism, then 2-D spatial
tiling of each image) and the same factoring rules and errors.  A
:class:`Mesh` is a (frames, tx, ty) array of ``torch.device`` objects of one
type and its ``shape`` dict; it places nothing by itself.

A mesh may name one device several times (``[torch.device('cuda', 0)] * 4``)
or give positions devices of their own.  The sharded solve
(parallel.batch) reads where each position lies: frames row ``f`` solves
its pairs on its home device ``mesh.device(f)``, the device of position
(f, 0, 0), with a worker thread per row when the mesh is
:attr:`Mesh.distinct`; a row whose tiles lie on distinct devices
exchanges one-pixel seams between them (parallel.spmd).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from opticalflow_tpu_torch.utils.device import resolve_device

AXES = ("frames", "tx", "ty")


class Mesh:
    """A (frames, tx, ty) array of devices of one type with its axis sizes;
    a mesh that mixes device types raises ``ValueError``."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != len(AXES):
            raise ValueError(f"a mesh is a {len(AXES)}-d array of devices, got {devices.shape}")
        types = sorted({d.type for d in devices.flat})
        if len(types) != 1:
            raise ValueError(f"a mesh holds devices of one type, got {types}")
        resolved = np.empty(devices.size, dtype=object)
        resolved[:] = [_resolve_index(d) for d in devices.flat]
        self.devices = resolved.reshape(devices.shape)
        self.shape: Dict[str, int] = dict(zip(AXES, devices.shape))

    def device(self, frames: int = 0, tx: int = 0, ty: int = 0) -> torch.device:
        """The device of position (frames, tx, ty): ``device(f)`` is frames
        row f's home device, where its pairs, Krylov vectors and V-cycle
        live, and ``device()`` the mesh's first device, where the sharded
        solve gathers its results."""
        return self.devices[frames, tx, ty]

    @property
    def distinct(self) -> bool:
        """Whether the positions lie on more than one device (by type and
        index: ``cuda`` and ``cuda:0`` are one device when 0 is current)."""
        return len(set(self.devices.flat)) > 1

    def row(self, frames: int) -> "Mesh":
        """The (1, tx, ty) mesh of frames row ``frames``."""
        return Mesh(self.devices[frames : frames + 1])


def _resolve_index(device: torch.device) -> torch.device:
    """``device`` with its index made explicit: a CUDA device without one is
    the current device, and ``cpu:0`` is ``cpu``."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    if device.type == "cpu" and device.index == 0:
        return torch.device("cpu")
    return device


def _factor(n: int) -> Tuple[int, int, int]:
    """Split n devices into (frames, tx, ty), preferring frame-pair
    parallelism (it needs no halo traffic), then near-square tiles: factors
    of 2 move from frames into the tile axes while frames exceeds 4."""
    frames, tx, ty = n, 1, 1
    while frames % 2 == 0 and frames > 4:
        if tx <= ty:
            tx *= 2
        else:
            ty *= 2
        frames //= 2
    return frames, tx, ty


def _near_square(n: int) -> Tuple[int, int]:
    """(tx, ty) with tx * ty == n, as square as n's divisors allow
    (tx >= ty, so the longer axis tiles image rows)."""
    ty = 1
    for d in range(int(np.sqrt(n)), 0, -1):
        if n % d == 0:
            ty = d
            break
    return n // ty, ty


def make_mesh(
    devices: Optional[Sequence[torch.device]] = None,
    frames: Optional[int] = None,
    tx: Optional[int] = None,
    ty: Optional[int] = None,
    workload: str = "movie",
) -> Mesh:
    """Build a ('frames', 'tx', 'ty') mesh over ``devices`` (``None``: the
    CUDA devices; it raises without one).  The same list may name one
    device several times, e.g. ``[torch.device('cpu')] * 8``, as the JAX
    package's tests use 8 virtual CPU devices.

    Unspecified axis sizes are inferred as in the JAX package: all three
    unspecified, ``workload`` decides (``'movie'`` prefers frame pairs,
    with modest tiling beyond 4 devices; ``'single_pair'`` pins frames=1
    and tiles near-square); some specified, the remaining device count goes
    to the unspecified axes (a lone one takes it all, an unspecified (tx,
    ty) pair splits it near-square, frames plus one tile axis gives it to
    frames).
    """
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    n = len(devices)
    spec = {"frames": frames, "tx": tx, "ty": ty}
    unspec = [k for k, v in spec.items() if v is None]
    if len(unspec) == 3:
        if workload == "single_pair":
            spec["frames"] = 1
            spec["tx"], spec["ty"] = _near_square(n)
        elif workload == "movie":
            spec["frames"], spec["tx"], spec["ty"] = _factor(n)
        else:
            raise ValueError(f"unknown workload {workload!r}")
    elif unspec:
        known = int(np.prod([v for v in spec.values() if v is not None]))
        if known <= 0 or n % known:
            raise ValueError(f"specified axes {spec} do not divide {n} devices")
        rem = n // known
        if len(unspec) == 1:
            spec[unspec[0]] = rem
        elif set(unspec) == {"tx", "ty"}:
            spec["tx"], spec["ty"] = _near_square(rem)
        else:
            # frames + one tile axis free: frames-first (no halo traffic)
            spec["frames"] = rem
            for k in unspec:
                if spec[k] is None:
                    spec[k] = 1
    frames, tx, ty = spec["frames"], spec["tx"], spec["ty"]
    if frames * tx * ty != n:
        raise ValueError(f"mesh {frames}x{tx}x{ty} != {n} devices")
    dev_array = np.empty(n, dtype=object)
    dev_array[:] = [torch.device(d) for d in devices]
    return Mesh(dev_array.reshape(frames, tx, ty))
