"""Batched matrix-free BiCGStab.

Counterpart of ``opticalflow_tpu.solve.krylov.bicgstab`` for a batch of
independent systems: ``b`` is (B, ...), the matvec and preconditioner act
on the whole batch, and every scalar of the recurrence (rho, alpha, omega,
the iteration count, the best and checkpoint norms, the stagnation and
breakdown flags) is a per-pair (B,) tensor.  A pair whose own exit test has
fired is frozen: the batch's step is still computed for it, but its state
is kept, exactly as under ``jax.vmap`` of the JAX ``lax.while_loop``.  The
loop runs on the host and reads one flag from the device per iteration;
those reads are counted as ``krylov/host_syncs`` (utils.observability).

``fgmres`` and ``cg`` are not ported yet (ROADMAP A5).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

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
