"""Geometric-Galerkin multigrid preconditioner, batched over frame pairs.

Counterpart of ``opticalflow_tpu.solve.multigrid``: bilinear transfers,
Galerkin coarse operators recovered by period-3 comb probing (27 probes),
damped 3x3 block-Jacobi smoothing, and a dense LU solve on the coarsest
grid.  Fields are ``(B, 3, M, N)``, or ``(B, K, 3, M, N)`` for a stack of
K probes per pair; each pair has its own hierarchy (stencil tensors carry
the batch axis).

The fine level's matvec is whatever the caller passes — in the solve, the
fused CUDA kernel — and the same matvec is probed for the first coarse
operator, so probing also runs on the kernel (with K = 27).  With the
kernel at level 0, :func:`v_cycle` is the counterpart of both the JAX
``v_cycle`` and ``v_cycle_aligned`` (which its docstring calls identical).
``gs_sweep``, ``color_masks`` and ``v_cycle_padded`` are not ported: the
solve never calls them.

Precision: nothing here goes through a matrix product, so no TF32 path is
reachable.  The 3x3 contractions of the block inverse and its application
are unrolled plane multiply-adds, and the stencil apply is an elementwise
product summed over its 27 taps, all in the working dtype.
"""

from __future__ import annotations

import functools
from typing import Callable, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Transfer operators (separable bilinear; coarse point c sits at fine 2c)
# ---------------------------------------------------------------------------


def _prolong_last(c: torch.Tensor, m_fine: int) -> torch.Tensor:
    """Bilinear prolongation along the last axis: fine[2k] = c[k],
    fine[2k+1] = (c[k] + c[k+1]) / 2 (missing neighbour contributes 0)."""
    nxt = F.pad(c[..., 1:], (0, 1))
    odd = 0.5 * (c + nxt)
    inter = torch.stack([c, odd], dim=-1).reshape(c.shape[:-1] + (2 * c.shape[-1],))
    return inter[..., :m_fine]


def _restrict_last(y: torch.Tensor, m_coarse: int) -> torch.Tensor:
    """Adjoint of :func:`_prolong_last`: R(y)[k] = y[2k] + (y[2k-1] + y[2k+1]) / 2."""
    m_fine = y.shape[-1]
    ypad = F.pad(y, (1, 2 * m_coarse + 1 - m_fine))  # index k <-> fine k-1
    even = ypad[..., 1::2][..., :m_coarse]
    left = ypad[..., 0::2][..., :m_coarse]
    right = ypad[..., 2::2][..., :m_coarse]
    return even + 0.5 * (left + right)


def prolong(c: torch.Tensor, fine_shape: Tuple[int, int]) -> torch.Tensor:
    """(..., Mc, Nc) -> (..., Mf, Nf)."""
    out = _prolong_last(c.transpose(-1, -2), fine_shape[0]).transpose(-1, -2)
    return _prolong_last(out, fine_shape[1])


def restrict(y: torch.Tensor, coarse_shape: Tuple[int, int]) -> torch.Tensor:
    """(..., Mf, Nf) -> (..., Mc, Nc) (exact adjoint of :func:`prolong`)."""
    out = _restrict_last(y.transpose(-1, -2), coarse_shape[0]).transpose(-1, -2)
    return _restrict_last(out, coarse_shape[1])


def coarse_dims(m: int, n: int) -> Tuple[int, int]:
    return (m + 1) // 2, (n + 1) // 2


# ---------------------------------------------------------------------------
# Generic 9-point / 3-field stencil operator
# ---------------------------------------------------------------------------


def stencil_matvec(S: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """y[o,i,j] = sum_{q,di,dj} S[o,q,di,dj,i,j] * u[q,i+di-1,j+dj-1] with
    zero padding outside the grid.  S: (B, 3, 3, 3, 3, M, N); u: (B, 3, M,
    N) or (B, K, 3, M, N)."""
    B, M, N = S.shape[0], S.shape[-2], S.shape[-1]
    upad = F.pad(u, (1, 1, 1, 1))
    taps = torch.stack(
        [upad[..., di : di + M, dj : dj + N] for di in range(3) for dj in range(3)], dim=-3
    )  # (B, [K,] 3, 9, M, N)
    taps = taps.flatten(-4, -3)  # (B, [K,] 27, M, N), index q*9 + di*3 + dj
    lead = (B,) + (1,) * (u.dim() - 4)
    out = [(S[:, o].reshape(lead + (27, M, N)) * taps).sum(dim=-3) for o in range(3)]
    return torch.stack(out, dim=-3)


def probe_stencil(matvec: Callable, batch: int, m: int, n: int, dtype, device) -> torch.Tensor:
    """Recover the 9-point/3-field stencil tensor (B, 3, 3, 3, 3, m, n) of a
    batched black-box linear operator by period-3 comb probing: one call of
    ``matvec`` on a (B, 27, 3, m, n) stack."""
    ii = torch.arange(m, device=device)[:, None]
    jj = torch.arange(n, device=device)[None, :]
    combs = torch.zeros((27, 3, m, n), dtype=dtype, device=device)
    for q in range(3):
        for si in range(3):
            for sj in range(3):
                combs[q * 9 + si * 3 + sj, q] = ((ii % 3 == si) & (jj % 3 == sj)).to(dtype)
    ys = matvec(combs.expand(batch, 27, 3, m, n).contiguous())
    ys = ys.reshape(batch, 3, 3, 3, 3, m, n)  # [b, q, si, sj, o, i, j]

    # S[o,q,di,dj,i,j] = ys[q, (i+di-1)%3, (j+dj-1)%3, o, i, j]: offset
    # (di-1, dj-1) hits comb (si, sj) iff the residues match (one comb per
    # pixel), so each term below is an exact select by a 0/1 mask.
    offs = torch.arange(3, device=device)
    mask_i = ((ii.reshape(-1)[None, None, :] + offs[None, :, None] - 1) % 3
              == offs[:, None, None]).to(dtype)  # (si, di, i)
    mask_j = ((jj.reshape(-1)[None, None, :] + offs[None, :, None] - 1) % 3
              == offs[:, None, None]).to(dtype)  # (sj, dj, j)
    cols = []
    for d in range(3):
        rows = []
        for e in range(3):
            acc = None
            for s in range(3):
                for t in range(3):
                    term = mask_i[s, d][:, None] * mask_j[t, e][None, :] * ys[:, :, s, t]
                    acc = term if acc is None else acc + term
            rows.append(acc)  # (B, q, o, i, j)
        cols.append(torch.stack(rows, dim=1))  # (B, e, q, o, i, j)
    S = torch.stack(cols, dim=1)  # (B, d, e, q, o, i, j)
    return S.permute(0, 4, 3, 1, 2, 5, 6).contiguous()  # (B, o, q, d, e, i, j)


# ---------------------------------------------------------------------------
# Smoother: damped 3x3 block-Jacobi
# ---------------------------------------------------------------------------


def invert_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Invert (..., 3, 3) per-pixel blocks in closed form (adjugate /
    determinant) after the symmetric equilibration D A D with
    D = 1/sqrt(|diag|), which keeps the f32 determinant O(1)."""
    diag = torch.stack([blocks[..., k, k] for k in range(3)], dim=-1)
    s = 1.0 / torch.sqrt(torch.abs(diag) + 1e-30)
    scaled = blocks * s[..., :, None] * s[..., None, :]
    a, b, c = scaled[..., 0, 0], scaled[..., 0, 1], scaled[..., 0, 2]
    d, e, f = scaled[..., 1, 0], scaled[..., 1, 1], scaled[..., 1, 2]
    g, h, i = scaled[..., 2, 0], scaled[..., 2, 1], scaled[..., 2, 2]
    A = e * i - f * h
    Bc = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    Fc = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    Ic = a * e - b * d
    det = a * A + b * D + c * G
    inv_det = 1.0 / det
    X = torch.stack([
        torch.stack([A, Bc, C], dim=-1),
        torch.stack([D, E, Fc], dim=-1),
        torch.stack([G, H, Ic], dim=-1),
    ], dim=-2) * inv_det[..., None, None]
    return X * s[..., :, None] * s[..., None, :]  # inv(A) = D inv(D A D) D


def apply_blocks(binv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Per-pixel 3x3 blocks in planar layout (B, 3, 3, M, N) applied to a
    (B, 3, M, N) field, as unrolled plane multiply-adds."""
    return torch.stack([
        binv[:, o, 0] * r[:, 0] + binv[:, o, 1] * r[:, 1] + binv[:, o, 2] * r[:, 2]
        for o in range(3)
    ], dim=1)


def jacobi_sweep(matvec, binv, x, b, damp: float = 0.7, sweeps: int = 2):
    """Damped block-Jacobi smoothing: x += damp * Binv (b - A x); ``x=None``
    is a zero initial guess (its first residual is b itself, as A 0 = 0)."""
    for _ in range(sweeps):
        if x is None:
            x = damp * apply_blocks(binv, b)
        else:
            x = x + damp * apply_blocks(binv, b - matvec(x))
    return x


# ---------------------------------------------------------------------------
# Hierarchy setup + V-cycle
# ---------------------------------------------------------------------------


class MGLevel(NamedTuple):
    matvec: Callable
    binv: torch.Tensor  # (B, 3, 3, M, N), planar
    shape: Tuple[int, int]


class MGHierarchy(NamedTuple):
    levels: Tuple[MGLevel, ...]
    coarse_solve: Callable  # dense exact solve at the bottom


def _planar(blocks: torch.Tensor) -> torch.Tensor:
    """(B, M, N, 3, 3) -> (B, 3, 3, M, N), contiguous."""
    return blocks.permute(0, 3, 4, 1, 2).contiguous()


def setup(
    fine_matvec: Callable,
    fine_diag_blocks: torch.Tensor,
    m: int,
    n: int,
    dtype,
    min_size: int = 8,
    max_levels: int = 16,
) -> MGHierarchy:
    """Build the Galerkin hierarchy below a batched black-box fine operator.

    ``fine_matvec`` takes (B, 3, m, n) and (B, K, 3, m, n) stacks;
    ``fine_diag_blocks`` (B, m, n, 3, 3) are its diagonal blocks (known
    analytically, so the finest level is never probed).
    """
    B = fine_diag_blocks.shape[0]
    device = fine_diag_blocks.device
    levels: List[MGLevel] = [
        MGLevel(matvec=fine_matvec, binv=_planar(invert_blocks(fine_diag_blocks)), shape=(m, n))
    ]
    matvec = fine_matvec
    while min(m, n) > min_size and len(levels) < max_levels:
        mc, nc = coarse_dims(m, n)

        def coarse_mv(u_c, matvec_f=matvec, fshape=(m, n), cshape=(mc, nc)):
            return restrict(matvec_f(prolong(u_c, fshape)), cshape)

        S_c = probe_stencil(coarse_mv, B, mc, nc, dtype, device)
        matvec = functools.partial(stencil_matvec, S_c)
        blocks = S_c[:, :, :, 1, 1].permute(0, 3, 4, 1, 2)  # (B, mc, nc, 3, 3)
        m, n = mc, nc
        levels.append(MGLevel(matvec=matvec, binv=_planar(invert_blocks(blocks)), shape=(m, n)))

    # Materialise + LU-factor the coarsest operator (tiny), one per pair.
    n_unk = 3 * m * n
    eye = torch.eye(n_unk, dtype=dtype, device=device).reshape(n_unk, 3, m, n)
    cols = matvec(eye.expand(B, n_unk, 3, m, n).contiguous()).reshape(B, n_unk, n_unk)
    lu, piv = torch.linalg.lu_factor(cols.transpose(-1, -2))
    mm, nn = m, n

    def coarse_solve(b):
        x = torch.linalg.lu_solve(lu, piv, b.reshape(b.shape[0], -1, 1))
        return x.reshape(b.shape[0], 3, mm, nn)

    return MGHierarchy(levels=tuple(levels), coarse_solve=coarse_solve)


def _descend(h: MGHierarchy, lvl: int, b_l: torch.Tensor, n_smooth: int,
             damp: float, sweeps: int) -> torch.Tensor:
    """Recursive V-cycle descent from level ``lvl`` (zero initial guess)."""
    if lvl == len(h.levels) - 1:
        return h.coarse_solve(b_l)
    level = h.levels[lvl]
    x = None
    for _ in range(n_smooth):
        x = jacobi_sweep(level.matvec, level.binv, x, b_l, damp=damp, sweeps=sweeps)
    r = b_l - level.matvec(x)
    nxt = h.levels[lvl + 1]
    e = _descend(h, lvl + 1, restrict(r, nxt.shape), n_smooth, damp, sweeps)
    x = x + prolong(e, level.shape)
    for _ in range(n_smooth):
        x = jacobi_sweep(level.matvec, level.binv, x, b_l, damp=damp, sweeps=sweeps)
    return x


def v_cycle(h: MGHierarchy, b: torch.Tensor, n_smooth: int = 1, damp: float = 0.7,
            sweeps: int = 2) -> torch.Tensor:
    """One V(n,n)-cycle with block-Jacobi smoothing from a zero initial
    guess — a fixed linear operator usable as a Krylov preconditioner."""
    return _descend(h, 0, b, n_smooth, damp, sweeps)
