"""Geometric-Galerkin multigrid preconditioner, batched over frame pairs.

Counterpart of ``opticalflow_tpu.solve.multigrid``: bilinear transfers,
Galerkin coarse operators recovered by period-3 comb probing (27 probes),
damped 3x3 block-Jacobi smoothing, and a dense LU solve on the coarsest
grid.  Fields are ``(B, 3, M, N)``, or ``(B, K, 3, M, N)`` for a stack of
K probes per pair; each pair has its own hierarchy (stencil tensors carry
the batch axis).

The fine level's matvec is whatever the caller passes — in the solve, a
CUDA matvec kernel (B1, B2 or B3) — and the same matvec is probed for the
first coarse operator (with K = 27).  Below it the V-cycle and the probes
run in stages (:class:`Stages`): a probed level's sweep
(:func:`smooth_level`), the fine level's sweep around its matvec's output
(:func:`smooth_fine`), the residual restricted to the next level
(:func:`residual_restrict`), the correction prolonged and added
(:func:`prolong_add`), the stencil apply (:func:`stencil_matvec`) and, at
a probed level with the Jacobi smoother, the last pre-sweep with the
residual-and-restrict (:func:`smooth_restrict`) and the prolong-add with
the first post-sweep (:func:`prolong_smooth`).  A hierarchy carries its
route (:data:`ROUTES`): ``'kernels'``, kernels B5 and B6
(``ops.cuda_kernels.mg_*``: 22 launches a V-cycle of 5 levels in place of
~480 torch ops; the stages above are their plain versions, which they
equal bit for bit and which run on CPU tensors), or ``'torch'``, the
stages themselves (any dtype; the solve's float64 oracles).  With the
kernel at level 0, :func:`v_cycle` is the counterpart of both the JAX
``v_cycle`` and ``v_cycle_aligned`` (which its docstring calls identical).
The 4-colour block Gauss-Seidel smoother (``smoother='gs'``,
:func:`gs_sweep` over :func:`color_masks`) is JAX's too, torch ops around
the levels' operators; an unknown smoother name raises ``ValueError``
where JAX falls through to GS.  ``v_cycle_padded`` is not ported: there is
no container layout.

Precision: nothing here goes through a matrix product, so no TF32 path is
reachable.  The 3x3 contractions of the block inverse and its application
are unrolled plane multiply-adds, and the stencil apply sums its 27
products one at a time in JAX's order, every product and sum rounded
alone, in the working dtype: a fixed order, which the kernels reproduce.
"""

from __future__ import annotations

import functools
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from opticalflow_tpu_torch.ops import cuda_kernels
from opticalflow_tpu_torch.utils import observability


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
    N) or (B, K, 3, M, N), S broadcast over K.

    The 27 terms are summed one at a time in JAX's order (q, then di, then
    dj; ``opticalflow_tpu/solve/multigrid.py::stencil_matvec``), each
    product and sum rounded alone, the three output fields at once: a fixed
    order, which kernel B5 reproduces bit for bit."""
    M, N = S.shape[-2], S.shape[-1]
    upad = F.pad(u, (1, 1, 1, 1))
    Sk = S if u.dim() == 4 else S[:, None]  # (B, [1,] 3, 3, 3, 3, M, N)
    acc = None
    for q in range(3):
        for di in range(3):
            for dj in range(3):
                term = Sk[..., q, di, dj, :, :] * upad[..., q : q + 1, di : di + M, dj : dj + N]
                acc = term if acc is None else acc + term
    return acc


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
# Smoothers: damped 3x3 block-Jacobi, 4-colour (2x2) block Gauss-Seidel
# ---------------------------------------------------------------------------

SMOOTHERS = ("jacobi", "gs")


@functools.lru_cache(maxsize=64)
def color_masks(m: int, n: int, device=None) -> torch.Tensor:
    """(4, m, n) bool: colour c = 2 (i % 2) + (j % 2) of each pixel, on
    ``device``."""
    ii = torch.arange(m, device=device)[:, None]
    jj = torch.arange(n, device=device)[None, :]
    color = (ii % 2) * 2 + (jj % 2)
    return torch.stack([color == c for c in range(4)])


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


def smooth_level(S: Optional[torch.Tensor], binv: torch.Tensor, x: Optional[torch.Tensor],
                 b: torch.Tensor, damp: float) -> torch.Tensor:
    """One damped block-Jacobi sweep on a probed level, x + damp * Binv (b -
    S x); ``x=None`` is the zero initial guess, damp * Binv b (A 0 = 0, so
    ``S`` is not read).  The plain version of kernel B5's sweep."""
    return smooth_fine(binv, x, b, None if x is None else stencil_matvec(S, x), damp)


def smooth_fine(binv: torch.Tensor, x: Optional[torch.Tensor], b: torch.Tensor,
                y: Optional[torch.Tensor], damp: float) -> torch.Tensor:
    """The sweep of the fine level around its matvec's output y = A x: x +
    damp * Binv (b - y); ``x=None`` (and ``y=None``) is the zero initial
    guess.  The plain version of kernel B5's level-0 epilogue."""
    if x is None:
        return damp * apply_blocks(binv, b)
    return x + damp * apply_blocks(binv, b - y)


def residual_restrict(S: Optional[torch.Tensor], x: Optional[torch.Tensor],
                      b: Optional[torch.Tensor], y: Optional[torch.Tensor],
                      coarse_shape: Tuple[int, int]) -> torch.Tensor:
    """The residual restricted to the next level: R (b - S x) with ``S``,
    R (b - y) with the fine matvec's output ``y``; without ``b``, R (S x) or
    R y (the coarse operators' probes).  Fields (B, [K,] 3, M, N), S
    broadcast over K.  The plain version of kernel B6's restriction."""
    if S is not None:
        y = stencil_matvec(S, x)
    return restrict(y if b is None else b - y, coarse_shape)


def prolong_add(x: Optional[torch.Tensor], e: torch.Tensor,
                fine_shape: Tuple[int, int]) -> torch.Tensor:
    """The coarse correction prolonged and added, x + P e; P e with
    ``x=None`` (the coarse operators' probes).  The plain version of kernel
    B6's prolongation."""
    fine = prolong(e, fine_shape)
    return fine if x is None else x + fine


def smooth_restrict(S: torch.Tensor, binv: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                    damp: float, coarse_shape: Tuple[int, int]):
    """The last pre-sweep of a probed level and its restricted residual,
    (x1, R (b - S x1)) with x1 = :func:`smooth_level` from ``x``: the two
    plain stages in turn, the plain version of kernel B6's
    sweep-residual-restrict."""
    x1 = smooth_level(S, binv, x, b, damp)
    return x1, residual_restrict(S, x1, b, None, coarse_shape)


def prolong_smooth(S: torch.Tensor, binv: torch.Tensor, x: torch.Tensor, e: torch.Tensor,
                   b: torch.Tensor, damp: float) -> torch.Tensor:
    """The coarse correction added, x + P e, and the first post-sweep from
    it: the two plain stages in turn, the plain version of kernel B6's
    prolong-add-sweep."""
    return smooth_level(S, binv, prolong_add(x, e, tuple(x.shape[-2:])), b, damp)


def gs_sweep(matvec, binv, masks, x, b, reverse: bool = False):
    """One 4-colour block Gauss-Seidel sweep, colours 0..3 (3..0 with
    ``reverse``): x += Binv (b - A x) on the pixels of each colour in turn;
    ``x=None`` is a zero initial guess."""
    if x is None:
        x = torch.zeros_like(b)
    for c in (range(3, -1, -1) if reverse else range(4)):
        upd = apply_blocks(binv, b - matvec(x))
        x = x + torch.where(masks[c], upd, 0.0)
    return x


# ---------------------------------------------------------------------------
# Hierarchy setup + V-cycle
# ---------------------------------------------------------------------------


class MGLevel(NamedTuple):
    matvec: Callable
    binv: torch.Tensor  # (B, 3, 3, M, N), planar
    shape: Tuple[int, int]
    stencil: Optional[torch.Tensor] = None  # (B, 3, 3, 3, 3, M, N) of a probed level


class MGHierarchy(NamedTuple):
    levels: Tuple[MGLevel, ...]
    coarse_solve: Callable  # dense exact solve at the bottom
    coarse_lu: Tuple[torch.Tensor, torch.Tensor]  # its (LU, pivots), one per pair
    route: str = "kernels"  # which stages run the levels: a key of ROUTES


class Stages(NamedTuple):
    """The operations of a V-cycle and of the coarse operators' probes below
    the fine level's matvec (the plain functions above, or the kernels'
    wrappers, which run the same functions on CPU tensors)."""

    stencil_apply: Callable  # (S, u) -> S u, any K
    smooth: Callable  # (S, binv, x, b, damp): smooth_level
    smooth_fine: Callable  # (binv, x, b, y, damp): smooth_fine
    residual_restrict: Callable  # (S, x, b, y, coarse_shape)
    prolong_add: Callable  # (x, e, fine_shape)
    smooth_restrict: Callable  # (S, binv, x, b, damp, coarse_shape) -> (x1, r_c)
    prolong_smooth: Callable  # (S, binv, x, e, b, damp)


# 'torch': the plain functions (the route of matvec 'xla' and 'gspmd', whose
# solves may be float64); 'kernels': kernels B5 and B6 (cuda_kernels), whose
# S and binv setup and take have checked once (``checked=True``).
ROUTES = {
    "torch": Stages(stencil_matvec, smooth_level, smooth_fine, residual_restrict, prolong_add,
                    smooth_restrict, prolong_smooth),
    "kernels": Stages(
        functools.partial(cuda_kernels.mg_stencil_apply, checked=True),
        functools.partial(cuda_kernels.mg_smooth, checked=True),
        functools.partial(cuda_kernels.mg_smooth_fine, checked=True),
        functools.partial(cuda_kernels.mg_residual_restrict, checked=True),
        cuda_kernels.mg_prolong_add,
        functools.partial(cuda_kernels.mg_smooth_restrict, checked=True),
        functools.partial(cuda_kernels.mg_prolong_smooth, checked=True)),
}


def _planar(blocks: torch.Tensor) -> torch.Tensor:
    """(B, M, N, 3, 3) -> (B, 3, 3, M, N), contiguous."""
    return blocks.permute(0, 3, 4, 1, 2).contiguous()


def _probed_level(route: str, S: torch.Tensor, binv: torch.Tensor,
                  shape: Tuple[int, int]) -> MGLevel:
    """A probed level's operator and operands; a kernel route checks S and
    binv here, once for every call of the level's kernels."""
    if route == "kernels":
        cuda_kernels.mg_check_level(S, binv)
    return MGLevel(functools.partial(ROUTES[route].stencil_apply, S), binv, shape, S)


def setup(
    fine_matvec: Callable,
    fine_diag_blocks: torch.Tensor,
    m: int,
    n: int,
    dtype,
    min_size: int = 8,
    max_levels: int = 16,
    route: str = "kernels",
) -> MGHierarchy:
    """Build the Galerkin hierarchy below a batched black-box fine operator.

    ``fine_matvec`` takes (B, 3, m, n) and (B, K, 3, m, n) stacks;
    ``fine_diag_blocks`` (B, m, n, 3, 3) are its diagonal blocks (known
    analytically, so the finest level is never probed).  ``route``: which
    stages run below the fine matvec, here and in :func:`v_cycle`:
    ``'kernels'`` (kernels B5 and B6 on CUDA tensors, their plain versions
    on CPU tensors) or ``'torch'`` (the plain functions, any dtype).
    """
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; expected one of {tuple(ROUTES)}")
    stages = ROUTES[route]
    B = fine_diag_blocks.shape[0]
    device = fine_diag_blocks.device
    levels: List[MGLevel] = [
        MGLevel(matvec=fine_matvec, binv=_planar(invert_blocks(fine_diag_blocks)), shape=(m, n))
    ]
    if route == "kernels":
        cuda_kernels.mg_check_level(None, levels[0].binv)
    matvec, S = fine_matvec, None
    while min(m, n) > min_size and len(levels) < max_levels:
        mc, nc = coarse_dims(m, n)

        def coarse_mv(u_c, matvec_f=matvec, S_f=S, fshape=(m, n), cshape=(mc, nc)):
            u_f = stages.prolong_add(None, u_c, fshape)
            if S_f is None:  # below the fine level: its matvec, then R
                return stages.residual_restrict(None, None, None, matvec_f(u_f), cshape)
            return stages.residual_restrict(S_f, u_f, None, None, cshape)

        S = probe_stencil(coarse_mv, B, mc, nc, dtype, device)
        blocks = S[:, :, :, 1, 1].permute(0, 3, 4, 1, 2)  # (B, mc, nc, 3, 3)
        m, n = mc, nc
        levels.append(_probed_level(route, S, _planar(invert_blocks(blocks)), (m, n)))
        matvec = levels[-1].matvec

    # Materialise + LU-factor the coarsest operator (tiny), one per pair.
    n_unk = 3 * m * n
    eye = torch.eye(n_unk, dtype=dtype, device=device).reshape(n_unk, 3, m, n)
    cols = matvec(eye.expand(B, n_unk, 3, m, n).contiguous()).reshape(B, n_unk, n_unk)
    with observability.host_wait():  # lu_factor reads its error flags on the host
        lu, piv = torch.linalg.lu_factor(cols.transpose(-1, -2))
    return MGHierarchy(levels=tuple(levels), coarse_solve=functools.partial(_lu_solve, lu, piv),
                       coarse_lu=(lu, piv), route=route)


def _lu_solve(lu: torch.Tensor, piv: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The coarsest level's dense solve of (B, 3, m, n) right-hand sides."""
    x = torch.linalg.lu_solve(lu, piv, b.reshape(b.shape[0], -1, 1))
    return x.reshape(b.shape)


def take(h: MGHierarchy, idx: torch.Tensor, fine_matvec: Callable) -> MGHierarchy:
    """The hierarchy of the pairs ``idx`` of ``h`` alone, on ``fine_matvec``
    (the fine operator of those pairs) and ``h``'s route: the same levels,
    sliced, with no probing or factoring."""
    fine = h.levels[0]
    levels = [MGLevel(fine_matvec, fine.binv.index_select(0, idx), fine.shape)]
    if h.route == "kernels":
        cuda_kernels.mg_check_level(None, levels[0].binv)
    for level in h.levels[1:]:
        levels.append(_probed_level(h.route, level.stencil.index_select(0, idx),
                                    level.binv.index_select(0, idx), level.shape))
    lu, piv = (t.index_select(0, idx) for t in h.coarse_lu)
    return MGHierarchy(tuple(levels), functools.partial(_lu_solve, lu, piv), (lu, piv), h.route)


def _descend(h: MGHierarchy, lvl: int, b_l: torch.Tensor, n_smooth: int, smoother: str,
             damp: float, sweeps: int) -> torch.Tensor:
    """Recursive V-cycle descent from level ``lvl`` (zero initial guess).
    Level 0 runs the caller's matvec and the stages around its output; a
    probed level runs the stages on its stencil alone, and with the Jacobi
    smoother fuses its last pre-sweep into the residual-and-restrict (where
    that sweep starts from a guess) and its prolong-add into the first
    post-sweep (where there is one)."""
    if lvl == len(h.levels) - 1:
        return h.coarse_solve(b_l)
    level, stages = h.levels[lvl], ROUTES[h.route]
    S = level.stencil  # None at level 0
    nxt = h.levels[lvl + 1]

    def sweep(x):
        if S is not None:
            return stages.smooth(S, level.binv, x, b_l, damp)
        y = None if x is None else level.matvec(x)
        return stages.smooth_fine(level.binv, x, b_l, y, damp)

    def gs(x, reverse):
        masks = color_masks(*level.shape, device=b_l.device)
        return gs_sweep(level.matvec, level.binv, masks, x, b_l, reverse=reverse)

    n_gs = n_smooth if smoother == "gs" else 0
    n_sweeps = 0 if n_gs else n_smooth * sweeps  # Jacobi sweeps on each side
    fuse_down = S is not None and n_sweeps >= 2  # the last one starts from a guess
    fuse_up = S is not None and n_sweeps >= 1
    x = None
    for _ in range(n_gs):
        x = gs(x, reverse=False)
    for _ in range(n_sweeps - fuse_down):
        x = sweep(x)
    if fuse_down:
        x, r_c = stages.smooth_restrict(S, level.binv, x, b_l, damp, nxt.shape)
    elif S is not None:
        r_c = stages.residual_restrict(S, x, b_l, None, nxt.shape)
    else:
        r_c = stages.residual_restrict(None, None, b_l, level.matvec(x), nxt.shape)
    e = _descend(h, lvl + 1, r_c, n_smooth, smoother, damp, sweeps)
    if fuse_up:
        x = stages.prolong_smooth(S, level.binv, x, e, b_l, damp)
    else:
        x = stages.prolong_add(x, e, level.shape)
    for _ in range(n_sweeps - fuse_up):
        x = sweep(x)
    for _ in range(n_gs):
        x = gs(x, reverse=True)
    return x


def v_cycle(h: MGHierarchy, b: torch.Tensor, n_smooth: int = 1, smoother: str = "jacobi",
            damp: float = 0.7, sweeps: int = 2) -> torch.Tensor:
    """One V(n,n)-cycle from a zero initial guess — a fixed linear operator
    usable as a Krylov preconditioner.  ``smoother``: ``'jacobi'`` (damped
    block-Jacobi, ``sweeps`` of ``damp`` each) or ``'gs'`` (4-colour block
    Gauss-Seidel, colours reversed on the way up); anything else raises
    ``ValueError``.  On the ``'kernels'`` route a Jacobi V-cycle is, at
    level 0, one B5 launch a sweep (after the fine matvec but the first),
    one B6 residual-and-restrict and one B6 prolong-and-add; at a probed
    level, one B5 launch a sweep but the last before the restriction and
    the first after the prolongation, which B6 fuses with them; and the
    coarsest LU solve.  With sweeps 2 and 5 levels: 4 B1, 10 B5 and 8 B6
    launches."""
    if smoother not in SMOOTHERS:
        raise ValueError(f"unknown smoother {smoother!r}; expected one of {SMOOTHERS}")
    return _descend(h, 0, b, n_smooth, smoother, damp, sweeps)
