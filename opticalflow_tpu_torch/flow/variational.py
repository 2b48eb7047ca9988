"""Flagship variational optical flow (velocity + net remodelling).

Counterpart of ``opticalflow_tpu.flow.variational``.  Per batch of frame
pairs: normalise intensities, build the coefficient planes, solve the
reduced EL system with a right-preconditioned Krylov solver (BiCGStab
below 500 interior points on the longest axis, flexible GMRES at/above)
and the Galerkin multigrid V-cycle, refine against double-float system
data, embed the boundary and evaluate the functionals.  The fine-level
matvec — Krylov steps, V-cycle sweeps and the comb probes of the
multigrid setup — is a hand-written CUDA kernel on CUDA tensors
(ops.cuda_kernels): the fused matvec by default, the plain-stencil core
plus the boundary ring with ``matvec='hybrid'``, or the tiled matvec of a
mesh (parallel.spmd) that the sharded solve passes as ``matvec_factory``.
The refinement's df32 residual and correction operator are kernel B4 on
CUDA tensors (its operands packed once per solve), bit for bit the plain
``elop.el_residual_df`` / ``el_matvec_df``.

Where the JAX package uses ``vmap`` the port carries a leading pair axis,
and where it uses ``lax.scan`` the port loops in Python.  Each Krylov
solve, the main one and each correction solve of the refinement, is the
counterpart of a ``lax.while_loop``: on the card its step is replayed from
a CUDA graph captured once per solve (solve.krylov), except where the
matvec copies between devices (``spans_devices``, parallel.spmd's exchange
route), whose solves keep the eager loop.  The refinement loop itself
reads its active set from the device at every step.  Warm-start modes:

* ``'sequential'``: each pair starts from the previous pair's solution;
* ``'cold'``: every pair starts from the initial guess, all pairs batched;
* ``'two-pass'``: pair 0 alone, then the remaining pairs batched from its
  solution.

A batched pass runs in as few chunks as the device's memory allows
(:func:`batch_plan`): one on the CPU and wherever the batch fits.
"""

from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

from opticalflow_tpu_torch.core import stencils
from opticalflow_tpu_torch.core.types import FlowResult, SolverConfig
from opticalflow_tpu_torch.ops import cuda_kernels, df32, elop
from opticalflow_tpu_torch.ops.blur import blur_movie
from opticalflow_tpu_torch.solve import direct, krylov, multigrid
from opticalflow_tpu_torch.utils import observability
from opticalflow_tpu_torch.utils.device import resolve_device


def _functionals(u, pair: elop.FramePairData, speed_alpha, remodelling_alpha, dy_mode):
    """Data / regulariser functionals (B,) of solved pairs ``u`` (B, 3,
    Ni, Nj), evaluated with the dy rule the operator used."""
    v_x, v_y, g = u[:, 0], u[:, 1], u[:, 2]
    dvx_dx = stencils.ddx(v_x)
    dvx_dy = stencils.ddy(v_x, mode=dy_mode)
    dvy_dx = stencils.ddx(v_y)
    dvy_dy = stencils.ddy(v_y, mode=dy_mode)
    dg_dx = stencils.ddx(g)
    dg_dy = stencils.ddy(g, mode=dy_mode)
    I = pair.I_interior
    data_residual = (
        pair.dIdt
        + v_x[:, 1:-1, 1:-1] * pair.dIdx
        + v_y[:, 1:-1, 1:-1] * pair.dIdy
        + I * dvx_dx
        + I * dvy_dy
        - g[:, 1:-1, 1:-1]
    )
    area = (-2, -1)
    l1 = torch.sum(data_residual**2, dim=area)
    speed_f = speed_alpha * torch.sum(dvx_dx**2 + dvx_dy**2 + dvy_dx**2 + dvy_dy**2, dim=area)
    rem_f = remodelling_alpha * torch.sum(dg_dx**2 + dg_dy**2, dim=area)
    return l1, speed_f, rem_f


def resolve_method(method: str, m: int, n: int) -> str:
    """``'auto'`` -> BiCGStab below 500 interior points on the longest axis,
    FGMRES at/above (f32 BiCGStab is documented to collapse there)."""
    if method != "auto":
        return method
    return "bicgstab" if max(m, n) < 500 else "gmres"


def _make_matvec(matvec_impl: str, prev, speed_alpha, remodelling_alpha, dy_mode, coeffs):
    """The fine-level reduced matvec on (B, 3, m, n) / (B, K, 3, m, n)."""
    if matvec_impl in ("auto", "pallas", "hybrid"):
        I = prev.contiguous()
        scalars = torch.stack([speed_alpha, remodelling_alpha], dim=-1).contiguous()
        compat = dy_mode == stencils.DY_COMPAT
        if matvec_impl == "hybrid":
            # ring strips of the same planes, with a probe axis for the
            # (B, 27, 3, m, n) comb probes of the multigrid setup
            rings = {4: elop.ring_coeffs(coeffs),
                     5: elop.ring_coeffs(elop.with_probe_axis(coeffs))}

            def hybrid(u):
                return cuda_kernels.el_matvec_hybrid(I, scalars, u.contiguous(), compat,
                                                     rings[u.dim()])

            return hybrid

        def fused(u):
            return cuda_kernels.el_matvec_reduced_fused(I, scalars, u.contiguous(), compat)

        return fused
    if matvec_impl in ("xla", "gspmd"):
        # 'gspmd' is the plain stencil, as in the JAX package (its
        # _resolve_matvec_impl passes it to the XLA stencil); planes (B, m,
        # n) gain a probe axis to broadcast over (B, K, 3, m, n)
        stacked = elop.with_probe_axis(coeffs)

        def plain(u):
            return elop.el_matvec_reduced(coeffs if u.dim() == 4 else stacked, u)

        return plain
    raise ValueError(f"unknown matvec {matvec_impl!r}")


def mg_route(matvec_impl: str) -> str:
    """The multigrid route (``multigrid.ROUTES``) of a matvec, by its name:
    the plain ``'xla'`` and ``'gspmd'`` keep the plain stages (their solves
    may be float64, as the float64 oracles'), every kernel route (``'auto'``,
    ``'pallas'``, ``'hybrid'``, and so the sharded and distributed solves,
    whose factories keep the name) runs kernels B5 and B6."""
    return "torch" if matvec_impl in ("xla", "gspmd") else "kernels"


def solver_kwargs(solver: SolverConfig) -> dict:
    """The keyword arguments of :func:`solve_frame_pair` that a
    ``SolverConfig`` sets (``atol`` sets none, as in the JAX package)."""
    return dict(
        method=solver.method, preconditioner=solver.preconditioner, rtol=solver.rtol,
        max_iterations=solver.max_iterations,
        high_precision_reductions=solver.high_precision_reductions,
        refinement_restarts=solver.refinement_restarts, matvec_impl=solver.matvec,
        tol_floor=solver.dtype_tol_floor, refinement_rtol=solver.refinement_rtol,
        refinement_exit_factor=solver.refinement_exit_factor, gmres_restart=solver.gmres_restart,
    )


def _take(tree, idx: torch.Tensor):
    """The pairs ``idx`` of every tensor in a (nested) tuple of (B, ...)
    tensors, of the same structure."""
    if isinstance(tree, torch.Tensor):
        return tree.index_select(0, idx)
    parts = [_take(t, idx) for t in tree]
    return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)


def _norms(x: torch.Tensor) -> torch.Tensor:
    """Per-pair 2-norms (B,) in the working dtype."""
    return torch.sqrt(torch.sum(x * x, dim=(1, 2, 3)))


@contextlib.contextmanager
def _phase(phase_timer, name: str):
    """The span ``pair/<name>`` around a phase of :func:`solve_frame_pair`,
    with ``phase_timer(name)`` inside it where a timer is given."""
    with observability.span(f"pair/{name}"):
        if phase_timer is None:
            yield
        else:
            with phase_timer(name):
                yield


@krylov.full_f32_precision()
def solve_frame_pair(
    previous_frame: torch.Tensor,
    current_frame: torch.Tensor,
    u0: torch.Tensor,
    speed_alpha,
    remodelling_alpha,
    dy_mode: str = stencils.DY_COMPAT,
    method: str = "bicgstab",
    preconditioner: str = "multigrid",
    rtol: float = 1e-6,
    max_iterations: int = 1000,
    high_precision_reductions: bool = True,
    refinement_restarts: int = 8,
    matvec_impl: str = "auto",
    tol_floor: float = 300.0,
    refinement_rtol: float = 0.2,
    refinement_exit_factor=None,
    gmres_restart: int = 32,
    phase_timer=None,
    matvec_factory=None,
):
    """Solve the coupled EL systems of a batch of frame pairs (pixel units).

    ``previous_frame`` / ``current_frame``: (B, Ni, Nj); ``u0``: (B, 3, Ni,
    Nj) or (3, Ni, Nj).  Returns ``(u, info)``: the BC-fixed (B, 3, Ni, Nj)
    solutions and a dict of (B,) tensors (iterations, residual_norm,
    converged, the three functionals).  Each pair is normalised by its own
    intensity scale s (frames / s, alpha_s / s^2), which keeps the
    coefficients O(1); gamma is solved in units of I/s and scaled back.
    The call's five phases are the spans ``pair/pair_data``,
    ``pair/mg_setup``, ``pair/krylov_main``, ``pair/refinement`` and
    ``pair/finish`` (utils.observability), which add no sync.
    ``phase_timer``: ``None``, or a callable that takes a phase name
    (``pair_data``, ``mg_setup``, ``krylov_main``, ``refinement``) and
    returns a context manager wrapped around that phase, inside its span
    (:func:`profile_solve_phases`).  ``matvec_factory``: ``None``, or a
    callable ``(frames, alpha_s, alpha_r, dy_mode) -> matvec`` that takes
    the normalised (B, Ni, Nj) frames and the (B,) alphas and returns the
    fine-level matvec on (B, 3, m, n) and (B, K, 3, m, n) stacks in place
    of ``matvec_impl``'s (the tiled matvecs of parallel.spmd).  The comb
    probes of the multigrid setup go through it too; the df32 refinement
    stays global.
    """
    with _phase(phase_timer, "pair_data"):
        dtype = previous_frame.dtype
        B = previous_frame.shape[0]
        scale = torch.clamp(previous_frame.abs().flatten(1).amax(dim=1), min=1e-30)  # (B,)
        s3 = scale[:, None, None]
        raw_prev, raw_cur = previous_frame, current_frame
        with observability.host_wait():  # a Python scalar is copied to the card
            raw_speed_alpha = elop.per_pair(speed_alpha, previous_frame)
            a_r = elop.per_pair(remodelling_alpha, previous_frame)
        prev = previous_frame / s3
        cur = current_frame / s3
        a_s = raw_speed_alpha / scale**2
        u0 = u0.expand((B,) + u0.shape[-3:])
        u0 = torch.cat([u0[:, :2], u0[:, 2:] / s3[:, None]], dim=1)

        pair = elop.compute_frame_pair_data(prev, cur, a_s, a_r, dy_mode)
        # Solve the *reduced* system: boundary constraint rows folded into the
        # interior stencil, so Krylov and multigrid see a pure 9-point operator.
        b_red = pair.rhs[:, :, 1:-1, 1:-1].contiguous()
        u0_red = u0[:, :, 1:-1, 1:-1].contiguous()
        m, n = b_red.shape[-2:]
        method = resolve_method(method, m, n)
        solvers = {"bicgstab": krylov.bicgstab, "cg": krylov.cg,
                   "gmres": functools.partial(krylov.fgmres, restart=gmres_restart)}
        if method not in solvers:
            raise ValueError(f"unknown method {method!r}")

        def make_matvec(frames, alpha_s, alpha_r, coeffs):
            if matvec_factory is None:
                return _make_matvec(matvec_impl, frames, alpha_s, alpha_r, dy_mode, coeffs)
            return matvec_factory(frames, alpha_s, alpha_r, dy_mode)

        matvec = make_matvec(prev, a_s, a_r, pair.coeffs)

    # 2 damped block-Jacobi sweeps per half-cycle below 500 interior
    # points, 4 at/above.
    mg_sweeps = 2 if max(m, n) < 500 else 4
    with _phase(phase_timer, "mg_setup"):
        if preconditioner == "multigrid":
            hierarchy = multigrid.setup(matvec, elop.diag_blocks(pair.coeffs), m, n, dtype,
                                        route=mg_route(matvec_impl))
        elif preconditioner not in ("block_jacobi", "none"):
            raise ValueError(f"unknown preconditioner {preconditioner!r}")

    def precond_of(coeffs, h):
        """The preconditioner of the pairs of ``coeffs`` and hierarchy ``h``."""
        if preconditioner == "none":
            return None
        if preconditioner == "block_jacobi":
            return functools.partial(elop.block_jacobi_inverse_apply_interior, coeffs)
        return functools.partial(multigrid.v_cycle, h, sweeps=mg_sweeps)

    precond = precond_of(pair.coeffs, hierarchy if preconditioner == "multigrid" else None)

    def operators_of(idx, h=None, rows=None, coarse_in_batch=False):
        """The fine matvec, the preconditioner and the hierarchy of the
        pairs ``idx`` (indices into the batch), the hierarchy sliced from
        ``h`` (the batch's when None) at its rows ``rows`` (``idx`` when
        None) by ``multigrid.take``: no probing or factoring."""
        coeffs = _take(pair.coeffs, idx)
        fine = make_matvec(prev[idx], a_s[idx], a_r[idx], coeffs)
        if preconditioner != "multigrid":
            return fine, precond_of(coeffs, None), None
        h = multigrid.take(hierarchy if h is None else h, idx if rows is None else rows, fine,
                           coarse_in_batch)
        return fine, precond_of(coeffs, h), h

    def narrowing(subset):
        """FGMRES's columns narrow to the pairs still going, on operators
        from ``subset``, each pair's bits those it gets in the whole batch
        (solve.krylov.fgmres)."""
        return {"subset": subset} if method == "gmres" else {}

    # a matvec that copies between devices keeps the eager Krylov loop
    spans_devices = getattr(matvec, "spans_devices", False)
    graphs = krylov._uncaptured if spans_devices else contextlib.nullcontext

    def solve(*args, **kwargs):
        with graphs():
            return solvers[method](*args, max_iterations=max_iterations,
                                   high_precision_reductions=high_precision_reductions,
                                   tol_floor_eps_multiple=tol_floor, **kwargs)

    with _phase(phase_timer, "krylov_main"):
        res = solve(matvec, b_red, x0=u0_red, precond=precond, rtol=rtol,
                    **narrowing(lambda idx: operators_of(idx, coarse_in_batch=True)[:2]))

    # Mixed-precision iterative refinement: each step evaluates b - A x
    # against double-float system data with x carried as a hi + lo pair,
    # then solves the correction system to `refinement_rtol` with the df32
    # operator and the same f32 preconditioner.  Per pair, it stops once
    # the df32 true residual is `refinement_exit_factor` below tol, after
    # `refinement_restarts` steps, or when a step gains <0.1%; a correction
    # that does not reduce the true residual is rejected.  A step solves
    # and re-evaluates only its active pairs, with the operator and the
    # preconditioner of those pairs (sliced from the batch's when the
    # active set shrinks), so pairs that have stopped cost nothing while
    # others refine on; within a step, FGMRES's columns narrow the same way.
    iterations = res.iterations
    if refinement_restarts > 0:
        with _phase(phase_timer, "refinement"):
            # the df32 system data, packed once for kernel B4
            ops = cuda_kernels.pack_df32(elop.compute_frame_pair_data_df(
                raw_prev, raw_cur, raw_speed_alpha, a_r, dy_mode, scale))
            eff_rtol = max(rtol, tol_floor * torch.finfo(dtype).eps)
            tol_main = eff_rtol * _norms(b_red)
            if refinement_exit_factor is None:
                refinement_exit_factor = 0.1 if max(m, n) < 500 else 0.03
            exit_tol = refinement_exit_factor * tol_main

            x_hi = res.x
            x_lo = torch.zeros_like(x_hi)
            r_hi = cuda_kernels.el_residual_df32(ops, x_hi, x_lo)
            r_norm = _norms(r_hi)
            r_prev = torch.full_like(r_norm, float("inf"))
            step = torch.zeros(B, dtype=torch.int32, device=r_norm.device)
            # the df32 data, preconditioner and hierarchy of the active pairs
            subset = (tuple(range(B)), ops, precond,
                      hierarchy if preconditioner == "multigrid" else None)
            while True:
                active = ((step < refinement_restarts) & (r_norm > exit_tol)
                          & (r_norm < 0.999 * r_prev))
                observability.add_count("krylov/host_syncs")
                observability.add_count("refinement/steps")
                with observability.host_wait():
                    pairs = tuple(torch.nonzero(active.cpu()).flatten().tolist())
                if not pairs:
                    break
                with observability.host_wait():  # a copy from pageable host memory
                    idx = torch.tensor(pairs, device=x_hi.device)
                if pairs != subset[0]:
                    observability.add_count("refinement/retakes")
                    subset = (pairs, _take(ops, idx)) + operators_of(idx)[1:]
                _, ops_a, precond_a, h_a = subset

                def narrowed(rows, idx=idx, ops_a=ops_a, h_a=h_a):
                    """The correction operators of the rows ``rows`` of this
                    solve's batch."""
                    ops_n = _take(ops_a, rows)
                    precond_n = operators_of(idx[rows], h_a, rows, coarse_in_batch=True)[1]
                    return (lambda u: cuda_kernels.el_matvec_df32(ops_n, u.contiguous()),
                            precond_n)

                res_c = solve(lambda u: cuda_kernels.el_matvec_df32(ops_a, u.contiguous()),
                              r_hi[idx],
                              x0=torch.zeros_like(r_hi[idx]), precond=precond_a,
                              rtol=refinement_rtol, **narrowing(narrowed))
                s_, e = df32.two_sum(x_hi[idx], res_c.x)
                x_hi_n, x_lo_n = df32.fast_two_sum(s_, x_lo[idx] + e)
                r_hi_n = cuda_kernels.el_residual_df32(ops_a, x_hi_n, x_lo_n)
                r_new = _norms(r_hi_n)
                take = r_new < r_norm[idx]
                t4 = take[:, None, None, None]
                x_hi = x_hi.index_copy(0, idx, torch.where(t4, x_hi_n, x_hi[idx]))
                x_lo = x_lo.index_copy(0, idx, torch.where(t4, x_lo_n, x_lo[idx]))
                r_hi = r_hi.index_copy(0, idx, torch.where(t4, r_hi_n, r_hi[idx]))
                r_prev = torch.where(active, r_norm, r_prev)
                r_norm = r_norm.index_copy(0, idx, torch.where(take, r_new, r_norm[idx]))
                iterations = iterations.index_add(0, idx, res_c.iterations.to(iterations.dtype))
                step = torch.where(active, step + 1, step)
            residual_norm = r_norm
            converged = r_norm <= tol_main
            x_int = x_hi + x_lo
    else:
        residual_norm = res.residual_norm
        converged = res.converged
        x_int = res.x

    with observability.span("pair/finish"):
        # Embed + mirror-BC fix-up (corners take the single mirror value).
        u = elop.embed_interior(x_int)
        l1, speed_f, rem_f = _functionals(u, pair, a_s, a_r, dy_mode)
        s2 = scale**2
        u = torch.cat([u[:, :2], u[:, 2:] * s3[:, None]], dim=1)
        info = {
            "iterations": iterations,
            "residual_norm": residual_norm,
            "converged": converged,
            "L1_functional": l1 * s2,
            "speed_functional": speed_f * s2,
            "remodelling_functional": rem_f * s2,
        }
    return u, info


# Share of the device's memory a batched pass plans its chunks into.
MEMORY_SHARE = 0.9
# Device memory the caching allocator holds a pair at a batched solve's
# peak, over what the pair's tensors take (pair_bytes): free blocks inside
# segments that live tensors keep and the Krylov steps' graph memory pool.
# Peak reserved over peak allocated on an H100 at 8, 17 and 25 pairs of
# 1022^2: 1.55, 1.54, 1.43 (PERF.md §6); 49 pairs at 1.0 ran out of memory.
ALLOCATOR_SLACK = 1.55
# Three-field (3, m, n) temporaries alive at the solve's peak besides the
# basis: the Krylov loop's and the column step's vectors and the V-cycle's
# at the fine level (PERF.md §6 gives the phase peaks they were read from).
_SCRATCH_VECTORS = 16


def pair_bytes(m: int, n: int, gmres_restart: int = 32, dtype=torch.float32) -> int:
    """Device bytes one pair adds to a batched :func:`solve_frame_pair` at
    (m, n) interiors, at the solve's peak (the df32 refinement's first
    correction solve), summed from what the solve holds there:

    * the pair's planes: the frames, the guess and the right-hand side on
      the full grid (9 planes), the 13 coefficient planes, the reduced
      right-hand side, guess and main solution (9);
    * the multigrid hierarchy: the fine level's block inverses (9 planes),
      each coarser level's probed operator and block inverses (81 + 9
      planes of its size) and the coarsest level's LU factors;
    * the df32 system data (B4's packed planes, 26 with the fixed dy rule
      and 24 in compat mode: 26; its right-hand side's high and low parts,
      6) and the refinement's state (low part, residual, the correction's
      right-hand side and guess: 12);
    * FGMRES's bases V and Z, ``2 gmres_restart + 1`` three-field rows;
    * ``_SCRATCH_VECTORS`` three-field temporaries.

    An upper bound for BiCGStab and CG, whose vectors are fewer than the
    bases."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    full = (m + 2) * (n + 2)
    interior = 13 + 9 + 26 + 6 + 12 + 3 * (2 * gmres_restart + 1) + 3 * _SCRATCH_VECTORS
    hierarchy = 9 * m * n
    mc, nc = m, n
    while min(mc, nc) > 8:  # multigrid.setup's levels (min_size 8)
        mc, nc = multigrid.coarse_dims(mc, nc)
        hierarchy += 90 * mc * nc
    hierarchy += (3 * mc * nc) ** 2 + 3 * mc * nc  # the coarsest LU and its pivots
    return itemsize * (9 * full + interior * m * n + hierarchy)


def plan_chunks(pairs: int, per_pair: float, usable: float) -> list:
    """Chunk sizes of a batched pass over ``pairs`` pairs that needs
    ``per_pair`` bytes a pair within ``usable`` bytes: as many as fit, at
    least one, in ``ceil(pairs / fit)`` chunks whose sizes differ by at most
    one pair, the larger first."""
    fit = max(1, int(usable // per_pair))
    count = -(-pairs // fit)
    size, extra = divmod(pairs, count)
    return [size + 1] * extra + [size] * (count - extra)


def batch_plan(pairs: int, m: int, n: int, gmres_restart: int, dtype, device) -> list:
    """The chunks of a batched pass of ``pairs`` pairs of (m, n) interiors
    on ``device``: one on the CPU; on a CUDA device as many pairs a chunk
    as fit, at :func:`pair_bytes` times ``ALLOCATOR_SLACK`` a pair, in
    ``MEMORY_SHARE`` of the device's memory less what is allocated when
    the pass starts."""
    if device.type != "cuda":
        return [pairs]
    usable = (MEMORY_SHARE * torch.cuda.get_device_properties(device).total_memory
              - torch.cuda.memory_allocated(device))
    return plan_chunks(pairs, ALLOCATOR_SLACK * pair_bytes(m, n, gmres_restart, dtype), usable)


def _solve_batched(pair_solver, prev_frames, cur_frames, u0, gmres_restart):
    """One batched pass over the pairs of ``prev_frames`` / ``cur_frames``
    from ``u0``, in the chunks :func:`batch_plan` gives, each one
    ``solve_frame_pair`` call; the chunks' solutions and infos in pair
    order.  Each chunk counts one ``variational/batch_chunks``, records its
    pairs in the series ``variational/chunk_pairs`` and runs inside the span
    ``variational/chunk``.  No chunk is retried: a plan that does not fit
    fails with the device's out-of-memory error."""
    m, n = prev_frames.shape[-2] - 2, prev_frames.shape[-1] - 2
    plan = batch_plan(prev_frames.shape[0], m, n, gmres_restart, prev_frames.dtype,
                      prev_frames.device)
    us, infos, lo = [], [], 0
    for size in plan:
        observability.add_count("variational/batch_chunks")
        observability.record_value("variational/chunk_pairs", size)
        with observability.span("variational/chunk"):
            u, info = pair_solver(prev_frames[lo:lo + size], cur_frames[lo:lo + size], u0)
        us.append(u)
        infos.append(info)
        lo += size
    return us, infos


def _solve_movie(movie, u_init, speed_alpha, remodelling_alpha, dy_mode, warm_start, **solver_kw):
    """Solve every frame pair of ``movie`` (T, Ni, Nj) from ``u_init`` (3,
    Ni, Nj); returns (P, 3, Ni, Nj) solutions and a dict of (P,) infos.
    The sequential loop records each pair's host wall, from the previous
    pair's end (the loop's start for the first), in the series
    ``variational/pair_s``; the batched pass of ``'cold'`` and
    ``'two-pass'`` runs in chunks sized by the device's memory
    (:func:`_solve_batched`)."""
    prev_frames, cur_frames = movie[:-1], movie[1:]
    pair_solver = functools.partial(
        solve_frame_pair, speed_alpha=speed_alpha, remodelling_alpha=remodelling_alpha,
        dy_mode=dy_mode, **solver_kw,
    )
    restart = solver_kw.get("gmres_restart", 32)
    if warm_start == "sequential":
        us, infos, carry = [], [], u_init
        last = time.perf_counter()
        for k in range(prev_frames.shape[0]):
            u, info = pair_solver(prev_frames[k : k + 1], cur_frames[k : k + 1], carry)
            carry = u[0]
            us.append(u)
            infos.append(info)
            now = time.perf_counter()
            observability.record_value("variational/pair_s", now - last)
            last = now
    elif warm_start == "cold":
        us, infos = _solve_batched(pair_solver, prev_frames, cur_frames, u_init, restart)
    elif warm_start == "two-pass":
        # pair 0 from the caller's guess, then the rest batched from its
        # solution (consecutive frames are highly correlated)
        u_first, info_first = pair_solver(prev_frames[:1], cur_frames[:1], u_init)
        us, infos = [u_first], [info_first]
        if prev_frames.shape[0] > 1:
            u_rest, info_rest = _solve_batched(pair_solver, prev_frames[1:], cur_frames[1:],
                                               u_first[0], restart)
            us += u_rest
            infos += info_rest
    else:
        raise ValueError(f"unknown warm_start mode {warm_start!r}")
    all_u = torch.cat(us)
    return all_u, {key: torch.cat([i[key] for i in infos]) for key in infos[0]}


def _pair_coeffs(coeffs: elop.ELCoefficients, k: int) -> elop.ELCoefficients:
    return elop.ELCoefficients(*[field[k] for field in coeffs])


def _solve_movie_direct(movie, u_init, speed_alpha, remodelling_alpha, dy_mode, warm_start):
    """Host-side assembled spsolve path, float64 (CPU oracle / small
    images).  The direct solve ignores the initial guess and so the
    warm-start mode."""
    frames = torch.as_tensor(movie, dtype=torch.float64)
    n_pairs = frames.shape[0] - 1
    all_u = np.zeros((n_pairs, 3) + tuple(frames.shape[1:]))
    infos = {
        "iterations": np.zeros(n_pairs, dtype=np.int32),
        "residual_norm": np.zeros(n_pairs),
        "converged": np.ones(n_pairs, dtype=bool),
        "L1_functional": np.zeros(n_pairs),
        "speed_functional": np.zeros(n_pairs),
        "remodelling_functional": np.zeros(n_pairs),
    }
    for k in range(n_pairs):
        pair = elop.compute_frame_pair_data(
            frames[k : k + 1], frames[k + 1 : k + 2], speed_alpha, remodelling_alpha, dy_mode)
        u, _ = direct.direct_solve(_pair_coeffs(pair.coeffs, 0), pair.rhs[0].numpy())
        u = stencils.mirror_edges(torch.from_numpy(np.ascontiguousarray(u)))[None]
        l1, sf, rf = _functionals(u, pair, pair.coeffs.speed_alpha,
                                  pair.coeffs.remodelling_alpha, dy_mode)
        infos["L1_functional"][k] = float(l1[0])
        infos["speed_functional"][k] = float(sf[0])
        infos["remodelling_functional"][k] = float(rf[0])
        all_u[k] = u[0].numpy()
    return all_u, infos


def variational_optical_flow(
    movie,
    delta_x: float = 1.0,
    delta_t: float = 1.0,
    speed_alpha: float = 1.0,
    remodelling_alpha: float = 1000.0,
    smoothing_sigma: Optional[float] = None,
    initial_v_x: float = 0.0,
    initial_v_y: float = 0.0,
    initial_remodelling: float = 0.0,
    use_direct_solver: bool = False,
    dy_mode: str = stencils.DY_COMPAT,
    warm_start: str = "sequential",
    solver: Optional[SolverConfig] = None,
    dtype=None,
    device=None,
) -> FlowResult:
    """Same arguments and result contract as the JAX package's
    ``variational_optical_flow``, plus ``device``.

    ``movie``: (T, X, Y) numpy array or tensor.  ``device``: where the
    solve runs; ``None`` means the CUDA device (it raises without one),
    ``'cpu'`` the CPU.  ``dtype``: the working type, float32 when ``None`` (the
    fused kernel takes float32 only).  With ``dy_mode='compat'`` the
    reference's ``speed_functional`` key duplication is reproduced and the
    correct value is stored under ``'speed_functional_corrected'``.
    """
    solver = solver or SolverConfig()
    dtype = dtype or torch.float32
    device = resolve_device(device)
    with observability.host_wait():  # a host movie is copied from pageable memory
        movie = torch.as_tensor(movie).to(device=device, dtype=dtype)
    if smoothing_sigma is not None:
        movie_to_analyse = blur_movie(movie, smoothing_sigma=smoothing_sigma)
    else:
        movie_to_analyse = movie

    n_i, n_j = movie.shape[1], movie.shape[2]
    # initial guess in pixel units: physical -> pixel is * delta_t / delta_x
    u_init = torch.stack([
        torch.full((n_i, n_j), float(initial_v_x) * delta_t / delta_x, dtype=dtype, device=device),
        torch.full((n_i, n_j), float(initial_v_y) * delta_t / delta_x, dtype=dtype, device=device),
        torch.full((n_i, n_j), float(initial_remodelling), dtype=dtype, device=device),
    ])

    with observability.span("variational/solve"):
        if use_direct_solver:
            all_u, infos = _solve_movie_direct(
                movie_to_analyse.double().cpu().numpy(), u_init.double().cpu().numpy(),
                speed_alpha, remodelling_alpha, dy_mode, warm_start,
            )
        else:
            all_u, infos = _solve_movie(
                movie_to_analyse, u_init, speed_alpha, remodelling_alpha, dy_mode, warm_start,
                **solver_kwargs(solver),
            )
        with observability.span("variational/to_host"):  # every copy of the call to the host
            if not use_direct_solver:
                all_u = all_u.cpu().numpy()
                infos = {key: value.cpu().numpy() for key, value in infos.items()}
            original_data = movie.cpu().numpy()
            blurred_data = movie_to_analyse.cpu().numpy()

    scale = delta_x / delta_t
    all_v_x = all_u[:, 0] * scale
    all_v_y = all_u[:, 1] * scale
    all_remodelling = all_u[:, 2]
    all_speed = np.sqrt(all_v_x**2 + all_v_y**2)

    l1_sum = float(np.sum(infos["L1_functional"]))
    rem_sum = float(np.sum(infos["remodelling_functional"]))
    speed_sum = float(np.sum(infos["speed_functional"]))
    converged_all = np.asarray(infos["converged"])

    result = FlowResult(
        v_x=all_v_x,
        v_y=all_v_y,
        speed=all_speed,
        remodelling=all_remodelling,
        original_data=original_data,
        blurred_data=blurred_data,
        delta_x=delta_x,
        delta_t=delta_t,
        # the reference stores only the final pair's flag
        converged=bool(converged_all[-1]),
        L1_functional=l1_sum,
        remodelling_functional=rem_sum,
    )
    result["converged_all"] = converged_all
    result["iterations"] = np.asarray(infos["iterations"])
    result["residual_norms"] = np.asarray(infos["residual_norm"])
    observability.logger.info(
        "variational solve: %d pairs %dx%d, iterations min/median/max "
        "%d/%d/%d, residual max %.3e, converged %d/%d",
        all_u.shape[0], n_i, n_j,
        int(result["iterations"].min()),
        int(np.median(result["iterations"])),
        int(result["iterations"].max()),
        float(result["residual_norms"].max()),
        int(converged_all.sum()), converged_all.size,
    )
    if dy_mode == stencils.DY_COMPAT:
        # reference defect: 'speed_functional' holds the remodelling functional
        result["speed_functional"] = rem_sum
        result["speed_functional_corrected"] = speed_sum
    else:
        result["speed_functional"] = speed_sum
    return result


PHASES = ("pair_data", "mg_setup", "krylov_main", "refinement", "host_transfer", "total")


def profile_solve_phases(
    previous_frame,
    current_frame,
    speed_alpha=1000.0,
    remodelling_alpha=1000.0,
    dy_mode: str = stencils.DY_COMPAT,
    solver: Optional[SolverConfig] = None,
    reps: int = 3,
    device=None,
) -> dict:
    """Per-phase wall-clock breakdown of one production frame-pair solve.

    Same arguments, phase keys and spans as the JAX package's
    ``profile_solve_phases``: the pair data (normalisation, derivative and
    coefficient planes), the multigrid setup, the main Krylov loop, the
    df32 refinement, the device-to-host copy of the solution, and the
    total (the whole solve plus that copy).  Durations land in the span
    registry as ``solve/<phase>`` and are returned as a dict of seconds.

    The method differs.  The JAX package compiles cumulative prefixes of
    the solve and differences them; here nothing is compiled, so
    ``solve_frame_pair`` runs ``reps`` times and each phase is timed
    directly on the host clock between device synchronisations; each
    value is its phase's best over the runs.  ``previous_frame`` /
    ``current_frame`` are (Ni, Nj) arrays or tensors; the solve runs on
    ``device`` (``None``: the CUDA device; ``'cpu'``: the CPU) in the
    previous frame's dtype.
    """
    solver = solver or SolverConfig()
    prev = torch.as_tensor(previous_frame).to(resolve_device(device))
    cur = torch.as_tensor(current_frame).to(prev)
    u0 = torch.zeros((3,) + tuple(prev.shape), dtype=prev.dtype, device=prev.device)

    def sync():
        if prev.device.type == "cuda":
            torch.cuda.synchronize(prev.device)

    best = defaultdict(lambda: float("inf"))

    @contextlib.contextmanager
    def phase(name):
        sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sync()
            best[name] = min(best[name], time.perf_counter() - t0)

    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        u, _ = solve_frame_pair(
            prev[None], cur[None], u0, speed_alpha, remodelling_alpha, dy_mode=dy_mode,
            phase_timer=phase, **solver_kwargs(solver),
        )
        sync()
        t1 = time.perf_counter()
        u.cpu().numpy()
        t2 = time.perf_counter()
        best["host_transfer"] = min(best["host_transfer"], t2 - t1)
        best["total"] = min(best["total"], t2 - t0)

    phases = {name: best[name] if name in best else 0.0 for name in PHASES}
    for name, seconds in phases.items():
        observability.record_span(f"solve/{name}", seconds)
    return phases
