"""The sharded solve: the frame pairs of a movie over a mesh's ``frames``
axis, each image tiled over its ``(tx, ty)`` axes.

Counterpart of ``opticalflow_tpu.parallel.batch`` (``sharded_box_flow``
waits for box flow).  Pairs start cold (``warm_start='cold'``), as there:
the reference's warm-start chain serialises pairs, so the batch trades a
few Krylov iterations per pair for data parallelism.

Every position of the mesh runs on one device in this slice
(parallel.mesh).  A mesh that tiles the image runs the fine-level matvec
tile by tile (parallel.spmd): kernel B3 with ``matvec='pallas'``, the
plain stencil with ``'xla'``; ``'auto'`` runs kernel B1 untiled, the
faster of the two on one device.  A frames-only mesh solves
each frames position's pairs as a batch of its own, one after another, as
the JAX package's per-device loops do.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from opticalflow_tpu_torch.core import stencils
from opticalflow_tpu_torch.core.types import SolverConfig
from opticalflow_tpu_torch.flow.variational import solve_frame_pair
from opticalflow_tpu_torch.parallel import mesh as mesh_lib
from opticalflow_tpu_torch.parallel import spmd


def _matvec_factory(matvec_impl: str, mesh: mesh_lib.Mesh, m: int, n: int):
    """The tiled-matvec factory of the pair solve on ``mesh`` for an (m, n)
    interior, or ``None`` where ``matvec_impl`` runs untiled.

    * ``'pallas'``: kernel B3, tile by tile, on any mesh ((1, 1, 1)
      included); an interior that does not tile raises ``ValueError``;
    * ``'auto'``: the fused kernel B1 untiled (in the port ``'auto'`` is
      the kernel).  With every tile on one device the tiled route is the
      same solve plus an extension and two copies per application, so it
      only loses there (which route ``'auto'`` takes when tiles have
      devices of their own is the multi-GPU slice's question);
    * ``'xla'``: the JAX package's mapping: the plain tiled stencil when
      the mesh tiles the image and the interior divides it, else the
      plain untiled solve;
    * ``'gspmd'``: the plain untiled solve;
    * ``'hybrid'``: kernel B2 plus the ring, untiled; on a mesh that tiles
      the image it raises ``ValueError`` (the JAX package silently runs
      ``'xla'`` there).
    """
    tx, ty = mesh.shape["tx"], mesh.shape["ty"]
    tiled = tx * ty > 1
    divisible = m % tx == 0 and n % ty == 0
    if matvec_impl == "pallas":
        return functools.partial(spmd.make_sharded_kernel_matvec, mesh)
    if matvec_impl == "xla" and tiled and divisible:
        return functools.partial(spmd.make_sharded_xla_matvec, mesh)
    if matvec_impl == "hybrid" and tiled:
        raise ValueError(f"matvec='hybrid' runs untiled; a mesh that tiles the image "
                         f"({tx}x{ty}) takes 'pallas', 'auto' or 'xla'")
    return None


def _batched_pair_solve(prev_frames, cur_frames, u_init, speed_alpha, remodelling_alpha,
                        solver: SolverConfig, dy_mode: str, mesh: mesh_lib.Mesh):
    """Solve the pairs (P, X, Y) as one batch from ``u_init`` (3, X, Y) with
    the matvec ``solver.matvec`` maps to on ``mesh``; returns the (P, 3, X,
    Y) solutions and a dict of (P,) infos."""
    m, n = prev_frames.shape[-2] - 2, prev_frames.shape[-1] - 2
    factory = _matvec_factory(solver.matvec, mesh, m, n)
    return solve_frame_pair(
        prev_frames, cur_frames, u_init, speed_alpha, remodelling_alpha, dy_mode=dy_mode,
        method=solver.method, preconditioner=solver.preconditioner, rtol=solver.rtol,
        max_iterations=solver.max_iterations,
        high_precision_reductions=solver.high_precision_reductions,
        refinement_restarts=solver.refinement_restarts, matvec_impl=solver.matvec,
        tol_floor=solver.dtype_tol_floor, refinement_rtol=solver.refinement_rtol,
        refinement_exit_factor=solver.refinement_exit_factor,
        gmres_restart=solver.gmres_restart, matvec_factory=factory,
    )


def _frames_sharded_solve(prev_frames, cur_frames, u_init, speed_alpha, remodelling_alpha,
                          solver: SolverConfig, dy_mode: str, mesh: mesh_lib.Mesh):
    """Frames-only meshes: the pairs split into ``frames`` equal blocks in
    order, each solved as an independent batch (its own loops, no
    straggler coupling across blocks), as the JAX package's per-device
    ``shard_map`` loops; the results concatenated in order."""
    blocks = [_batched_pair_solve(p, c, u_init, speed_alpha, remodelling_alpha, solver,
                                  dy_mode, mesh)
              for p, c in zip(prev_frames.chunk(mesh.shape["frames"]),
                              cur_frames.chunk(mesh.shape["frames"]))]
    all_u = torch.cat([u for u, _ in blocks])
    return all_u, {key: torch.cat([info[key] for _, info in blocks]) for key in blocks[0][1]}


def sharded_variational_solve(
    movie,
    mesh: Optional[mesh_lib.Mesh] = None,
    speed_alpha: float = 1.0,
    remodelling_alpha: float = 1000.0,
    dy_mode: str = stencils.DY_COMPAT,
    solver: Optional[SolverConfig] = None,
    dtype=torch.float32,
):
    """Solve all frame pairs of ``movie`` (T, X, Y), sharded pairs x tiles
    over ``mesh``, every pair from a zero initial guess.

    ``mesh``: where it runs; ``None`` is ``make_mesh()`` over the CUDA
    devices (it raises without one); a mesh over ``torch.device('cpu')``
    runs on the CPU.  Returns ``(all_u, infos)`` on the mesh's device: the
    (P, 3, X, Y) pixel-unit solutions and a dict of (P,) tensors
    (iterations, residual_norm, converged, the functionals), as the JAX
    package does; unit scaling and ``FlowResult`` packaging are the
    caller's.  The refinement options of ``solver`` apply as in
    ``variational_optical_flow``.
    """
    solver = solver or SolverConfig()
    if mesh is None:
        mesh = mesh_lib.make_mesh()
    movie = torch.as_tensor(movie).to(device=mesh.device(), dtype=dtype)
    prev, cur = movie[:-1], movie[1:]
    u_init = movie.new_zeros((3,) + tuple(movie.shape[1:]))
    args = (prev, cur, u_init, speed_alpha, remodelling_alpha, solver, dy_mode, mesh)
    frames_only = (mesh.shape["tx"] * mesh.shape["ty"] == 1 and mesh.shape["frames"] > 1
                   and prev.shape[0] % mesh.shape["frames"] == 0 and solver.matvec != "gspmd")
    if frames_only:
        return _frames_sharded_solve(*args)
    return _batched_pair_solve(*args)
