"""Batched matrix-free Krylov solvers: BiCGStab, CG and flexible GMRES.

Counterparts of ``opticalflow_tpu.solve.krylov`` for a batch of
independent systems: ``b`` is (B, ...), the matvec and preconditioner act
on the whole batch, and every scalar of a recurrence (BiCGStab's rho,
alpha, omega, the iteration count, the best and checkpoint norms, the
stagnation and breakdown flags) is a per-pair (B,) value.  A pair whose own
exit test has fired is frozen: the batch's step is still computed for it,
but its state is kept, exactly as under ``jax.vmap`` of the JAX
``lax.while_loop``.  The loops run on the host and read their exit flags
from the device once per iteration; those reads are counted as
``krylov/host_syncs`` (utils.observability).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from opticalflow_tpu_torch.utils import observability

MatVec = Callable[[torch.Tensor], torch.Tensor]
Precond = Callable[[torch.Tensor], torch.Tensor]


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iterations: torch.Tensor  # (B,) int32
    residual_norm: torch.Tensor  # (B,) final unpreconditioned ||b - Ax||
    converged: torch.Tensor  # (B,) bool


def acc_dtype(dtype, high_precision: bool):
    """float64 accumulation for float32 fields when requested.  Unlike the
    JAX package, where this needed x64 and so ran in float32 on the TPU,
    the port always honours the flag."""
    return torch.float64 if high_precision else dtype


def batch_dot(a: torch.Tensor, b: torch.Tensor, acc) -> torch.Tensor:
    """Per-pair dot products (B,) accumulated in ``acc``."""
    return (a.to(acc) * b.to(acc)).flatten(1).sum(dim=1)


def _bc(s: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (B,) tensor viewed to broadcast against ``like`` (B, ...)."""
    return s.reshape((-1,) + (1,) * (like.dim() - 1))


_PRECISION_LOCK = threading.Lock()
_PRECISION = {"depth": 0, "saved": None}  # blocks inside full_f32_precision, the flags before


@contextlib.contextmanager
def full_f32_precision():
    """No TF32 in matrix products or convolutions for the duration (the
    counterpart of the JAX package's HIGHEST matmul precision).  The flags
    are the process's: the first of several blocks open at once, in any
    thread, clears them and the last to close restores them."""
    with _PRECISION_LOCK:
        if _PRECISION["depth"] == 0:
            _PRECISION["saved"] = (torch.backends.cuda.matmul.allow_tf32,
                                   torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _PRECISION["depth"] += 1
    try:
        yield
    finally:
        with _PRECISION_LOCK:
            _PRECISION["depth"] -= 1
            if _PRECISION["depth"] == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _PRECISION["saved"]


def _host(t: torch.Tensor) -> np.ndarray:
    """Copy a small device tensor to the host, counted as a host sync."""
    observability.add_count("krylov/host_syncs")
    return t.detach().cpu().numpy()


def _mask(flags: np.ndarray, device) -> torch.Tensor:
    """A host (B,) bool mask on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(flags)).to(device)


def bicgstab(
    matvec: MatVec,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    precond: Optional[Precond] = None,
    rtol: float = 1e-6,
    atol: float = 0.0,
    max_iterations: int = 1000,
    high_precision_reductions: bool = True,
    tol_floor_eps_multiple: float = 300.0,
    stagnation_window: int = 100,
) -> KrylovResult:
    """Right-preconditioned BiCGStab on a batch of systems.

    Each pair stops at ``||b - A x|| <= max(rtol * ||b||, atol)``, with the
    tolerance floored at ``tol_floor_eps_multiple * eps(dtype) * ||b||``;
    on breakdown; at ``max_iterations``; or when the stagnation guard fires
    (every ``stagnation_window`` iterations: best norm within 4x of tol and
    <5% better than at the last checkpoint).  Returns each pair's *best*
    iterate and its recomputed true residual.
    """
    acc = acc_dtype(b.dtype, high_precision_reductions)

    def dot(u, v):
        return batch_dot(u, v, acc)

    if precond is None:
        precond = lambda r: r  # noqa: E731
    if x0 is None:
        x0 = torch.zeros_like(b)
    B = b.shape[0]
    dev = b.device

    r = b - matvec(x0)
    rhat = r
    b_norm = torch.sqrt(dot(b, b))
    eff_rtol = max(rtol, tol_floor_eps_multiple * torch.finfo(b.dtype).eps)
    tol = torch.clamp(eff_rtol * b_norm, min=atol)
    tiny = torch.finfo(b.dtype).tiny

    x = x0
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    rho = torch.ones(B, dtype=acc, device=dev)
    alpha = torch.ones(B, dtype=acc, device=dev)
    omega = torch.ones(B, dtype=acc, device=dev)
    k = torch.zeros(B, dtype=torch.int32, device=dev)
    res_norm = torch.sqrt(dot(r, r))
    breakdown = torch.zeros(B, dtype=torch.bool, device=dev)
    stagnated = torch.zeros(B, dtype=torch.bool, device=dev)
    best_x = x0
    best_norm = res_norm
    ckpt_norm = res_norm
    while True:
        active = (k < max_iterations) & ~stagnated & (res_norm > tol) & ~breakdown
        observability.add_count("krylov/host_syncs")
        if not bool(active.any()):
            break

        rho_new = dot(rhat, r)
        denom = rho * omega
        beta = (rho_new * alpha) / torch.where(denom.abs() > 0, denom, tiny)
        p_new = r + (_bc(beta, r) * (p.to(acc) - _bc(omega, r) * v.to(acc))).to(b.dtype)
        phat = precond(p_new)
        v_new = matvec(phat)
        rhat_v = dot(rhat, v_new)
        alpha_new = rho_new / torch.where(rhat_v.abs() > 0, rhat_v, tiny)
        sbreak = (rho_new.abs() == 0) | (rhat_v.abs() == 0)
        svec = r - (_bc(alpha_new, r) * v_new.to(acc)).to(b.dtype)
        shat = precond(svec)
        t = matvec(shat)
        tt = dot(t, t)
        omega_new = dot(t, svec) / torch.where(tt > 0, tt, tiny)
        x_new = (x + (_bc(alpha_new, x) * phat.to(acc)).to(b.dtype)
                 + (_bc(omega_new, x) * shat.to(acc)).to(b.dtype))
        r_new = svec - (_bc(omega_new, r) * t.to(acc)).to(b.dtype)
        res_new = torch.sqrt(dot(r_new, r_new))
        is_best = res_new < best_norm
        best_new = torch.where(is_best, res_new, best_norm)
        k_new = k + 1
        at_ckpt = (k_new % stagnation_window) == 0
        stall = (best_new <= 4.0 * tol) & (best_new > 0.95 * ckpt_norm)

        # commit the step for active pairs only (frozen pairs keep state)
        a = active
        av = _bc(a, b)
        best_x = torch.where(av & _bc(is_best, b), x_new, best_x)
        x = torch.where(av, x_new, x)
        r = torch.where(av, r_new, r)
        p = torch.where(av, p_new, p)
        v = torch.where(av, v_new, v)
        rho = torch.where(a, rho_new, rho)
        alpha = torch.where(a, alpha_new, alpha)
        omega = torch.where(a, omega_new, omega)
        res_norm = torch.where(a, res_new, res_norm)
        breakdown = torch.where(a, sbreak, breakdown)
        stagnated = torch.where(a, at_ckpt & stall, stagnated)
        ckpt_norm = torch.where(a & at_ckpt, best_new, ckpt_norm)
        best_norm = torch.where(a, best_new, best_norm)
        k = torch.where(a, k_new, k)

    # recompute the true residual once (guards against drift of the
    # recursively updated r)
    true_res = b - matvec(best_x)
    true_norm = torch.sqrt(dot(true_res, true_res))
    return KrylovResult(x=best_x, iterations=k, residual_norm=true_norm,
                        converged=true_norm <= tol)


def cg(
    matvec: MatVec,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    precond: Optional[Precond] = None,
    rtol: float = 1e-6,
    atol: float = 0.0,
    max_iterations: int = 1000,
    high_precision_reductions: bool = True,
    tol_floor_eps_multiple: float = 300.0,
) -> KrylovResult:
    """Preconditioned conjugate gradient on a batch of symmetric positive
    definite systems.  Each pair stops at the tolerance of :func:`bicgstab`
    or at ``max_iterations``; returns each pair's last iterate and its
    recomputed true residual."""
    acc = acc_dtype(b.dtype, high_precision_reductions)

    def dot(u, v):
        return batch_dot(u, v, acc)

    if precond is None:
        precond = lambda r: r  # noqa: E731
    if x0 is None:
        x0 = torch.zeros_like(b)

    r = b - matvec(x0)
    z = precond(r)
    b_norm = torch.sqrt(dot(b, b))
    eff_rtol = max(rtol, tol_floor_eps_multiple * torch.finfo(b.dtype).eps)
    tol = torch.clamp(eff_rtol * b_norm, min=atol)
    tiny = torch.finfo(b.dtype).tiny

    x, p = x0, z
    rz = dot(r, z)
    k = torch.zeros(b.shape[0], dtype=torch.int32, device=b.device)
    res_norm = torch.sqrt(dot(r, r))
    while True:
        active = (k < max_iterations) & (res_norm > tol)
        observability.add_count("krylov/host_syncs")
        if not bool(active.any()):
            break
        ap = matvec(p)
        pap = dot(p, ap)
        alpha = rz / torch.where(pap.abs() > 0, pap, tiny)
        x_new = x + (_bc(alpha, x) * p.to(acc)).to(b.dtype)
        r_new = r - (_bc(alpha, r) * ap.to(acc)).to(b.dtype)
        z_new = precond(r_new)
        rz_new = dot(r_new, z_new)
        beta = rz_new / torch.where(rz.abs() > 0, rz, tiny)
        p_new = z_new + (_bc(beta, p) * p.to(acc)).to(b.dtype)

        av = _bc(active, b)
        x = torch.where(av, x_new, x)
        r = torch.where(av, r_new, r)
        p = torch.where(av, p_new, p)
        rz = torch.where(active, rz_new, rz)
        res_norm = torch.where(active, torch.sqrt(dot(r_new, r_new)), res_norm)
        k = torch.where(active, k + 1, k)

    true_res = b - matvec(x)
    true_norm = torch.sqrt(dot(true_res, true_res))
    return KrylovResult(x=x, iterations=k, residual_norm=true_norm, converged=true_norm <= tol)


@full_f32_precision()
def fgmres(
    matvec: MatVec,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    precond: Optional[Precond] = None,
    rtol: float = 1e-6,
    atol: float = 0.0,
    max_iterations: int = 1000,
    restart: int = 32,
    high_precision_reductions: bool = True,
    tol_floor_eps_multiple: float = 300.0,
    truncation_guard: bool = True,
) -> KrylovResult:
    """Flexible GMRES(restart) on a batch of systems, right-preconditioned:
    the robust large-grid solver (why, and the guards below, are explained
    at ``opticalflow_tpu.solve.krylov.fgmres``).

    Kept from the JAX solver: classical Gram-Schmidt with one full
    reorthogonalisation (CGS2), Givens rotations with the running residual
    estimate, the Arnoldi breakdown guard (``hj1 <= 3e-4 ||A z_j||``) and
    the R-conditioning guard (``|r_jj| <= 1e-5 max|r_ii|``), the cap
    ``k + j < max_iterations`` inside a cycle, the true residual at every
    restart, the truncation guard (half and quarter cycles evaluated when
    the full cycle's true residual disagrees with the estimate), the stop
    on <1% progress per cycle, and keeping each pair's best iterate.

    Batching: the Arnoldi basis V (B, restart+1, N) and the flexible basis
    Z (B, restart, N) live on the device; every pair still in its cycle
    fills column j = the cycle's step, so the writes are one slice, masked
    to those pairs.  The Hessenberg column of each step (B, j+2) and the
    two norms come to the host in one read, where the Givens rotations, the
    estimate and the guards run in ``b.dtype`` as in the JAX solver, and the
    small triangular solves too.  The projections are batched products in
    the accumulation dtype (float64 for float32 fields by default; V is
    kept in it), independent of the caller's TF32 setting.
    """
    acc = acc_dtype(b.dtype, high_precision_reductions)

    def dot(u, v):
        return batch_dot(u, v, acc)

    if precond is None:
        precond = lambda r: r  # noqa: E731
    if x0 is None:
        x0 = torch.zeros_like(b)
    dt, dev = b.dtype, b.device
    npdt = torch.empty((), dtype=dt).numpy().dtype
    B, N, m = b.shape[0], b[0].numel(), int(restart)
    tiny = torch.finfo(dt).tiny
    np_tiny = npdt.type(tiny)

    b_norm = torch.sqrt(dot(b, b))
    eff_rtol = max(rtol, tol_floor_eps_multiple * torch.finfo(dt).eps)
    tol_dev = torch.clamp(eff_rtol * b_norm, min=atol)
    r0 = b - matvec(x0)
    tol, res_norm = _host(torch.stack([tol_dev, torch.sqrt(dot(r0, r0))]))
    x = x0
    k = np.zeros(B, np.int64)
    stalled = np.zeros(B, bool)

    while True:
        outer = (k < max_iterations) & (res_norm > tol) & ~stalled
        if not outer.any():
            break
        r = b - matvec(x)
        beta_dev = torch.sqrt(dot(r, r)).to(dt)
        V = torch.zeros((B, m + 1, N), dtype=acc, device=dev)
        V[:, 0] = (r.reshape(B, N) / torch.clamp(beta_dev, min=tiny)[:, None]).to(acc)
        Z = torch.zeros((B, m, N), dtype=dt, device=dev)
        beta = _host(beta_dev)

        R = np.zeros((B, m + 1, m), npdt)
        cs = np.zeros((B, m), npdt)
        sn = np.zeros((B, m), npdt)
        g = np.zeros((B, m + 1), npdt)
        g[:, 0] = beta
        j = np.zeros(B, np.int64)
        est = beta.copy()
        brk = np.zeros(B, bool)
        rmax = np.zeros(B, npdt)
        act = outer & (est > tol) & (k < max_iterations)
        t = 0
        while act.any():
            # every pair still in the cycle is at column t
            z = precond(V[:, t].to(dt).reshape(b.shape))
            w = matvec(z).reshape(B, N)
            w_entry = torch.sqrt(dot(w, w)).to(dt)
            Vt = V[:, : t + 1]
            h1 = torch.bmm(Vt, w.to(acc)[:, :, None])
            w = w - torch.bmm(Vt.transpose(1, 2), h1)[..., 0].to(dt)
            h2 = torch.bmm(Vt, w.to(acc)[:, :, None])
            w = w - torch.bmm(Vt.transpose(1, 2), h2)[..., 0].to(dt)
            h = (h1 + h2)[..., 0].to(dt)
            hj1 = torch.sqrt(dot(w, w)).to(dt)
            v_next = (w / torch.clamp(hj1, min=tiny)[:, None]).to(acc)
            if act.all():
                V[:, t + 1] = v_next
                Z[:, t] = z.reshape(B, N)
            else:
                idx = torch.from_numpy(np.flatnonzero(act)).to(dev)
                V[idx, t + 1] = v_next[idx]
                Z[idx, t] = z.reshape(B, N)[idx]
            col_host = _host(torch.cat([h, hj1[:, None], w_entry[:, None]], dim=1))

            with np.errstate(all="ignore"):  # frozen pairs may hold anything
                col = np.zeros((B, m + 1), npdt)
                col[:, : t + 2] = col_host[:, : t + 2]  # h[:t+1], then hj1 at t+1
                for i in range(t):  # the earlier rotations
                    ci, si = cs[:, i], sn[:, i]
                    hi, hi1 = col[:, i].copy(), col[:, i + 1].copy()
                    col[:, i] = ci * hi + si * hi1
                    col[:, i + 1] = -si * hi + ci * hi1
                a1, a2 = col[:, t].copy(), col[:, t + 1].copy()
                denom = np.sqrt(a1 * a1 + a2 * a2)
                safe = np.maximum(denom, np_tiny)
                c_new = np.where(denom > 0, a1 / safe, npdt.type(1))
                s_new = np.where(denom > 0, a2 / safe, npdt.type(0))
                rdd = c_new * a1 + s_new * a2
                col[:, t] = rdd
                col[:, t + 1] = 0
                gj = g[:, t].copy()
                rmax_new = np.maximum(rmax, np.abs(rdd))
                brk_new = ((col_host[:, t + 1] <= 3e-4 * col_host[:, t + 2])
                           | (np.abs(rdd) <= 1e-5 * rmax_new))
            a = act
            cs[a, t] = c_new[a]
            sn[a, t] = s_new[a]
            g[a, t] = (c_new * gj)[a]
            g[a, t + 1] = (-s_new * gj)[a]
            R[a, :, t] = col[a]
            est[a] = np.abs(g[a, t + 1])
            rmax[a] = rmax_new[a]
            brk[a] = brk_new[a]
            j[a] += 1
            act = act & (j < m) & (est > tol) & ~brk & (k + j < max_iterations)
            t += 1

        jmax = int(j.max())
        Z_acc = Z[:, :jmax].to(acc)
        del V, Z

        def solution_for(cols):
            # least squares over each pair's first `cols` columns (R is
            # triangular, so the truncated problem is exactly the shorter
            # Arnoldi least squares)
            used = np.arange(m)[None, :] < cols[:, None]
            unused = np.where(used, npdt.type(0), npdt.type(1))
            Rm = R[:, :m, :m] + unused[:, :, None] * np.eye(m, dtype=npdt)
            gm = np.where(used, g[:, :m], 0).astype(npdt)
            y = torch.linalg.solve_triangular(torch.from_numpy(Rm),
                                              torch.from_numpy(gm)[:, :, None], upper=True)
            y = torch.where(torch.from_numpy(used)[:, :, None], y, 0)
            y = y[:, :jmax, 0].to(device=dev, dtype=acc)
            xc = x + torch.bmm(y[:, None, :], Z_acc)[:, 0].to(dt).reshape(x.shape)
            rc = b - matvec(xc)
            return xc, torch.sqrt(dot(rc, rc))

        x_new, r_dev = solution_for(j)
        res_new = _host(r_dev)
        if truncation_guard:
            disagree = outer & (res_new > 2.0 * est) & (res_new > tol)
        else:
            disagree = outer.copy()
        if disagree.any():
            # evaluated for the whole batch, taken only where a pair disagrees
            x_h, r_h = solution_for((j + 1) // 2)
            x_q, r_q = solution_for((j + 3) // 4)
            for xc, rc in zip((x_h, x_q), _host(torch.stack([r_h, r_q]))):
                take = disagree & (rc < res_new)
                x_new = torch.where(_bc(_mask(take, dev), x), xc, x_new)
                res_new = np.where(take, rc, res_new)
        better = outer & (res_new < res_norm)
        x = torch.where(_bc(_mask(better, dev), x), x_new, x)
        stalled = np.where(outer, res_new > 0.99 * res_norm, stalled)
        res_norm = np.where(better, res_new, res_norm)
        k = np.where(outer, k + j, k)

    residual_norm = torch.from_numpy(res_norm).to(dev)
    return KrylovResult(x=x, iterations=torch.from_numpy(k.astype(np.int32)).to(dev),
                        residual_norm=residual_norm, converged=residual_norm <= tol_dev)
