"""Multi-process execution: the frames axis across processes.

Counterpart of ``opticalflow_tpu.parallel.distributed``, on
``torch.distributed``.  Consecutive frame pairs are independent (cold
start), so the ``frames`` axis is the one that crosses processes: each
process solves its own pairs on its own devices, with no collective inside
the solve (the frames axis needs none), and the global batch is the
concatenation of the processes' pairs in rank order.  The only collective
is one ``all_gather_object`` that agrees the per-process counts.  A
process with several GPUs spreads its pairs and tiles over them as the
sharded solve does (:func:`multihost_mesh`, parallel.batch).

Run one process per GPU, or one per node (several processes with several
GPUs each set ``LOCAL_WORLD_SIZE``, see :func:`local_gpus`)::

    from opticalflow_tpu_torch.parallel import distributed
    distributed.initialize()          # env-driven, see below
    local_u, infos = distributed.distributed_variational_solve(local_pairs, ...)

Environment variables read by :func:`initialize` (the JAX package's):

* ``OFTPU_COORDINATOR``   — ``host:port`` of process 0 (``tcp://`` rendezvous;
  without it, ``torch.distributed``'s own ``env://`` variables);
* ``OFTPU_NUM_PROCESSES`` — world size;
* ``OFTPU_PROCESS_ID``    — this process's rank;
* ``OFTPU_CPU_DEVICES``   — the CPU test mode: gloo instead of NCCL.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from opticalflow_tpu_torch.core import stencils
from opticalflow_tpu_torch.core.types import SolverConfig
from opticalflow_tpu_torch.parallel import mesh as mesh_lib
from opticalflow_tpu_torch.parallel.batch import _mesh_solve
from opticalflow_tpu_torch.utils import observability
from opticalflow_tpu_torch.utils.device import resolve_device

INFO_KEYS = ("iterations", "residual_norm", "converged", "L1_functional", "speed_functional",
             "remodelling_functional")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    cpu_devices: Optional[int] = None,
) -> None:
    """Join the process group of a multi-process run.

    Arguments left ``None`` are read from the ``OFTPU_*`` variables.  The
    backend is NCCL, with this process's GPU (``LOCAL_RANK``, else the rank
    modulo the GPU count) made current; with ``cpu_devices`` set (the JAX
    package's per-process virtual CPU device count) it is gloo, the CPU
    test mode, and the count itself is not used.  With
    ``LOCAL_WORLD_SIZE`` set, the GPU made current is the first of
    :func:`local_gpus`.
    """
    coordinator_address = coordinator_address or os.environ.get("OFTPU_COORDINATOR")
    if num_processes is None and "OFTPU_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["OFTPU_NUM_PROCESSES"])
    if process_id is None and "OFTPU_PROCESS_ID" in os.environ:
        process_id = int(os.environ["OFTPU_PROCESS_ID"])
    if cpu_devices is None and "OFTPU_CPU_DEVICES" in os.environ:
        cpu_devices = int(os.environ["OFTPU_CPU_DEVICES"])

    if cpu_devices is not None:
        backend = "gloo"
    else:
        if "LOCAL_WORLD_SIZE" in os.environ:
            local = local_gpus()[0].index
        else:
            resolve_device(None)
            local = int(os.environ.get("LOCAL_RANK",
                                       (process_id or 0) % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend = "nccl"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    init_method = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(backend=backend, init_method=init_method, **kwargs)


def local_gpus():
    """This process's GPUs (it raises without CUDA).

    With ``LOCAL_WORLD_SIZE`` processes on this node (torchrun sets it),
    the visible GPUs split into that many equal blocks in order and the
    block of ``LOCAL_RANK``, which is one GPU with one process per GPU.
    Without it, one process of several (a process group of more than one,
    or ``OFTPU_NUM_PROCESSES`` > 1) owns the one GPU :func:`initialize`
    made current, the JAX package's rule of one process per device; a lone
    process owns every visible GPU.  A run of several processes, each over
    several GPUs of its node, sets ``LOCAL_WORLD_SIZE``.
    """
    resolve_device(None)
    count = torch.cuda.device_count()
    if "LOCAL_WORLD_SIZE" not in os.environ:
        world = (dist.get_world_size() if dist.is_initialized()
                 else int(os.environ.get("OFTPU_NUM_PROCESSES", 1)))
        if world > 1:
            return [torch.device("cuda", torch.cuda.current_device())]
        return [torch.device("cuda", k) for k in range(count)]
    per = count // int(os.environ["LOCAL_WORLD_SIZE"])
    if per < 1:
        raise ValueError(f"{os.environ['LOCAL_WORLD_SIZE']} processes on a node of {count} GPUs")
    first = int(os.environ.get("LOCAL_RANK", 0)) * per
    return [torch.device("cuda", k) for k in range(first, first + per)]


def multihost_mesh(tx: int = 1, ty: int = 1, device=None) -> mesh_lib.Mesh:
    """This process's (frames, tx, ty) mesh, by the JAX package's rule
    (``opticalflow_tpu/parallel/distributed.py:81-105``): the process's
    local devices split into (local // (tx * ty), tx, ty) in order,
    ``ValueError`` when tx * ty does not divide them.  ``device``: ``None``
    for this process's GPUs (:func:`local_gpus`; with one GPU per process,
    the layout of the ``OFTPU_*`` variables without ``LOCAL_WORLD_SIZE``,
    the (1, 1, 1) mesh of the GPU :func:`initialize` made current), a list
    of devices for those, or one device (``'cpu'``) for a (1, tx, ty) mesh
    with every tile on it."""
    if device is None:
        device = local_gpus()
    if not isinstance(device, (list, tuple)):
        return mesh_lib.make_mesh([torch.device(device)] * (tx * ty), frames=1, tx=tx, ty=ty)
    if len(device) % (tx * ty):
        raise ValueError(f"tx*ty={tx * ty} must divide local device count {len(device)}")
    return mesh_lib.make_mesh(list(device), frames=len(device) // (tx * ty), tx=tx, ty=ty)


def distributed_variational_solve(
    local_pairs: Tuple[np.ndarray, np.ndarray],
    mesh: Optional[mesh_lib.Mesh] = None,
    speed_alpha: float = 1.0,
    remodelling_alpha: float = 1000.0,
    dy_mode: str = stencils.DY_COMPAT,
    solver: Optional[SolverConfig] = None,
    dtype=None,
):
    """Solve this process's frame pairs as its part of a global batch.

    ``local_pairs`` is ``(prev_frames, cur_frames)``, each (n_local, X, Y):
    the pairs this process contributes; counts may differ between
    processes (zero included).  ``mesh``: this process's mesh,
    :func:`multihost_mesh` when ``None`` (its GPUs).  The pairs go through
    the routes of :func:`parallel.batch.sharded_variational_solve` on that
    mesh (on one device: ``'pallas'`` kernel B3 tile by tile, ``'auto'``
    kernel B1; over distinct devices a worker per frames row and the seam
    exchange between tiles).  Returns
    ``(local_u, infos)`` as numpy arrays: the (n_local, 3, X, Y) solutions
    of exactly this process's pairs and their (n_local,) infos.
    """
    solver = solver or SolverConfig()
    if mesh is None:
        mesh = multihost_mesh()
    dtype = dtype or torch.float32
    device = mesh.device()
    prev = torch.as_tensor(np.asarray(local_pairs[0])).to(device=device, dtype=dtype)
    cur = torch.as_tensor(np.asarray(local_pairs[1])).to(device=device, dtype=dtype)
    n_local, dim_x, dim_y = prev.shape

    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, (n_local, dim_x, dim_y))
    if len({c[1:] for c in counts}) != 1:
        raise ValueError(f"every process must contribute frames of one size, got {counts}")
    observability.logger.info("distributed solve: rank %d of %d, pairs per rank %s",
                              dist.get_rank(), len(counts), [c[0] for c in counts])
    if n_local == 0:
        return prev.new_zeros((0, 3, dim_x, dim_y)).cpu().numpy(), {
            key: np.zeros(0) for key in INFO_KEYS}

    u_init = prev.new_zeros((3, dim_x, dim_y))
    all_u, infos = _mesh_solve(prev, cur, u_init, speed_alpha, remodelling_alpha, solver,
                               dy_mode, mesh)
    return all_u.cpu().numpy(), {key: value.cpu().numpy() for key, value in infos.items()}
