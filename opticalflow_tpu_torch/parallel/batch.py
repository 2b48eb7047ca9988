"""The sharded solve: the frame pairs of a movie over a mesh's ``frames``
axis, each image tiled over its ``(tx, ty)`` axes.

Counterpart of ``opticalflow_tpu.parallel.batch``, with
``sharded_box_flow``: the box-method flow of the movie's pairs over the
mesh's devices.  Pairs start cold (``warm_start='cold'``), as there: the
reference's warm-start chain serialises pairs, so the batch trades a few
Krylov iterations per pair for data parallelism.

Where the positions of the mesh lie (parallel.mesh) picks the route:

* **One device for every position.**  A mesh that tiles the image runs the
  fine-level matvec tile by tile (parallel.spmd's windows route): kernel
  B3 with ``matvec='pallas'``, the plain stencil with ``'xla'``;
  ``'auto'`` runs kernel B1 untiled, the faster of the two on one device.
  A frames-only mesh solves each frames position's pairs as a batch of its
  own, one after another.
* **Distinct devices.**  Each frames row solves its block of pairs on its
  home device in a worker thread of its own (the JAX package's
  independent per-device loops, with no collective), and a row whose tiles
  lie on distinct devices runs its matvec by parallel.spmd's exchange
  route.  The Krylov vectors, the V-cycle and the dots stay on the row's
  home device.  The results are gathered in pair order on the mesh's first
  device.  Each worker's Krylov solves capture their CUDA graphs
  thread-locally, on its own device and stream (solve.krylov), except on
  the exchange route, whose matvec copies between devices: its solves keep
  the eager Krylov loop.

The private ``_mesh_solve(..., as_distinct=True)`` forces the
distinct-device routes on a mesh that names one device several times,
which is how they run on a machine with one GPU and on the CPU; their
results are bitwise equal to the one-device routes'.
"""

from __future__ import annotations

import contextlib
import functools
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

from opticalflow_tpu_torch.core import stencils
from opticalflow_tpu_torch.core.types import SolverConfig
from opticalflow_tpu_torch.flow.variational import solve_frame_pair, solver_kwargs
from opticalflow_tpu_torch.parallel import mesh as mesh_lib
from opticalflow_tpu_torch.parallel import spmd


def _matvec_factory(matvec_impl: str, mesh: mesh_lib.Mesh, m: int, n: int,
                    as_distinct: bool = False):
    """The tiled-matvec factory of the pair solve on ``mesh`` (one frames
    row) for an (m, n) interior, or ``None`` where ``matvec_impl`` runs
    untiled on the row's home device.

    Tiles on one device (a mesh naming one device several times):

    * ``'pallas'``: kernel B3 over the windows of one extension, on any
      mesh ((1, 1, 1) included); an interior that does not tile raises
      ``ValueError``;
    * ``'auto'``: the fused kernel B1 untiled (in the port ``'auto'`` is the
      kernel).  With every tile on one device the tiled route is the same
      solve plus an extension and two copies per application, so it only
      loses there;
    * ``'xla'``: the JAX package's mapping: the plain tiled stencil when
      the mesh tiles the image and the interior divides it, else the plain
      untiled solve;
    * ``'gspmd'``: the plain untiled solve;
    * ``'hybrid'``: kernel B2 plus the ring, untiled; on a mesh that tiles
      the image it raises ``ValueError`` (the JAX package silently runs
      ``'xla'`` there).

    Tiles on distinct devices, or any tiling mesh with ``as_distinct=True``
    (parallel.spmd's exchange route, which ``spmd.exchange_route`` picks:
    seams handed between the tiles' devices, one kernel launch per tile on
    its device, the Krylov vectors and the V-cycle on the home device):

    * ``'auto'`` and ``'pallas'``: the exchange and kernel B3 (``'auto'``
      where the interior divides the mesh; else B1 untiled);
    * ``'xla'``: the exchange and the plain stencil (where the interior
      divides the mesh; else the plain untiled solve);
    * ``'gspmd'``: the plain untiled solve on the home device;
    * ``'hybrid'``: ``ValueError``, as above.
    """
    tx, ty = mesh.shape["tx"], mesh.shape["ty"]
    tiled = tx * ty > 1
    divisible = m % tx == 0 and n % ty == 0
    if matvec_impl == "hybrid" and tiled:
        raise ValueError(f"matvec='hybrid' runs untiled; a mesh that tiles the image "
                         f"({tx}x{ty}) takes 'pallas', 'auto' or 'xla'")
    if matvec_impl == "pallas" or (
            matvec_impl == "auto" and divisible and spmd.exchange_route(mesh, as_distinct)):
        return functools.partial(spmd.make_sharded_kernel_matvec, mesh, as_distinct=as_distinct)
    if matvec_impl == "xla" and tiled and divisible:
        return functools.partial(spmd.make_sharded_xla_matvec, mesh, as_distinct=as_distinct)
    return None


def _batched_pair_solve(prev_frames, cur_frames, u_init, speed_alpha, remodelling_alpha,
                        solver: SolverConfig, dy_mode: str, mesh: mesh_lib.Mesh,
                        as_distinct: bool = False):
    """Solve the pairs (P, X, Y) as one batch from ``u_init`` (3, X, Y) with
    the matvec ``solver.matvec`` maps to on ``mesh``, where the frames lie;
    returns the (P, 3, X, Y) solutions and a dict of (P,) infos."""
    m, n = prev_frames.shape[-2] - 2, prev_frames.shape[-1] - 2
    factory = _matvec_factory(solver.matvec, mesh, m, n, as_distinct)
    return solve_frame_pair(
        prev_frames, cur_frames, u_init, speed_alpha, remodelling_alpha, dy_mode=dy_mode,
        matvec_factory=factory, **solver_kwargs(solver),
    )


def _frames_sharded_solve(prev_frames, cur_frames, u_init, speed_alpha, remodelling_alpha,
                          solver: SolverConfig, dy_mode: str, mesh: mesh_lib.Mesh,
                          as_distinct: bool = False, workers: bool = False):
    """The pairs split into ``frames`` blocks in order (equal where they
    divide), block f solved as an independent batch (its own loops, no
    straggler coupling across blocks, as the JAX package's per-device
    ``shard_map`` loops) on frames row f's home device with that row's
    tiles; the results gathered in pair order on the mesh's first device.
    With ``workers`` each block is solved in a thread of its own, under its
    device; an exception in any of them reaches the caller once every
    thread has ended, and nothing is returned."""
    blocks = [(f, p, c) for f, (p, c) in enumerate(zip(
        prev_frames.tensor_split(mesh.shape["frames"]),
        cur_frames.tensor_split(mesh.shape["frames"]))) if p.shape[0]]

    def solve(f, prev, cur):
        home = mesh.device(f)  # made current for the row's CUDA work
        with torch.cuda.device(home) if home.type == "cuda" else contextlib.nullcontext():
            return _batched_pair_solve(prev.to(home), cur.to(home), u_init.to(home), speed_alpha,
                                       remodelling_alpha, solver, dy_mode, mesh.row(f),
                                       as_distinct)

    if workers:
        with ThreadPoolExecutor(len(blocks), thread_name_prefix="frames-row") as pool:
            futures = [pool.submit(solve, *block) for block in blocks]
            results = [future.result() for future in futures]
    else:
        results = [solve(*block) for block in blocks]
    first = mesh.device()
    all_u = torch.cat([u.to(first) for u, _ in results])
    return all_u, {key: torch.cat([info[key].to(first) for _, info in results])
                   for key in results[0][1]}


def _mesh_solve(prev, cur, u_init, speed_alpha, remodelling_alpha, solver: SolverConfig,
                dy_mode: str, mesh: mesh_lib.Mesh, as_distinct: bool = False):
    """The pairs (P, X, Y) solved from ``u_init`` (3, X, Y) on ``mesh`` by
    the route its placement takes (see :func:`sharded_variational_solve`);
    ``as_distinct=True`` takes the distinct-device routes on any mesh."""
    frames, tiles = mesh.shape["frames"], mesh.shape["tx"] * mesh.shape["ty"]
    distinct = as_distinct or mesh.distinct
    args = (prev, cur, u_init, speed_alpha, remodelling_alpha, solver, dy_mode)
    if frames > 1 and solver.matvec != "gspmd" and (
            distinct or (tiles == 1 and prev.shape[0] % frames == 0)):
        return _frames_sharded_solve(*args, mesh, as_distinct, workers=distinct)
    return _batched_pair_solve(*args, mesh, as_distinct)


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
    runs on the CPU.  On a mesh over one device the pairs of a frames-only
    mesh are solved block by block, one after another, and a tiling mesh
    solves every pair in one batch.  On a mesh over distinct devices each
    frames row solves its block of pairs in a worker thread of its own, on
    its home device, and a row whose tiles lie on distinct devices hands
    seams between them (``_matvec_factory`` gives the routes).  Returns
    ``(all_u, infos)`` on the mesh's first device: the (P, 3, X, Y)
    pixel-unit solutions and a dict of (P,) tensors (iterations,
    residual_norm, converged, the functionals), in pair order, as the JAX
    package does; unit scaling and ``FlowResult`` packaging are the
    caller's.  The refinement options of ``solver`` apply as in
    ``variational_optical_flow``.
    """
    solver = solver or SolverConfig()
    if mesh is None:
        mesh = mesh_lib.make_mesh()
    movie = torch.as_tensor(movie).to(device=mesh.device(), dtype=dtype)
    u_init = movie.new_zeros((3,) + tuple(movie.shape[1:]))
    return _mesh_solve(movie[:-1], movie[1:], u_init, speed_alpha, remodelling_alpha, solver,
                       dy_mode, mesh)


def sharded_box_flow(
    movie,
    box_size: int,
    mesh: Optional[mesh_lib.Mesh] = None,
    delta_x: float = 1.0,
    delta_t: float = 1.0,
    include_remodelling: bool = False,
    dtype=torch.float32,
):
    """Box-method flow of every frame pair of ``movie`` (T, X, Y) on
    ``mesh``; returns ``(v_x, v_y, speed, remodelling)``, each (T-1, X, Y),
    on the mesh's first device, in physical units, as
    ``flow.boxflow.box_flow``.  ``mesh``: ``None`` is ``make_mesh()`` over
    the CUDA devices (it raises without one).  The pairs are split in order
    over the mesh's distinct devices, each block of whole images a batch on
    its device (box sums need a box-sized halo, so images are not tiled;
    the JAX package leaves that halo to GSPMD), and the results gathered in
    order; a mesh over one device runs the whole movie as one batch
    there."""
    from opticalflow_tpu_torch.flow.boxflow import box_flow

    if mesh is None:
        mesh = mesh_lib.make_mesh()
    movie = torch.as_tensor(movie).to(device=mesh.device(), dtype=dtype)
    args = (int(box_size), float(delta_x), float(delta_t), include_remodelling)
    devices = list(dict.fromkeys(mesh.devices.flat))  # distinct, in mesh order
    if len(devices) == 1:
        return box_flow(movie, *args)
    parts = []
    for pairs, device in zip(torch.arange(movie.shape[0] - 1).tensor_split(len(devices)),
                             devices):
        if len(pairs):
            block = movie[int(pairs[0]) : int(pairs[-1]) + 2].to(device)
            parts.append(box_flow(block, *args))
    return tuple(torch.cat([part[k].to(mesh.device()) for part in parts]) for k in range(4))
