"""Plain float64 reference of the variational flow solve, in PyTorch.

It imports nothing of the program under test.  From the frames it is
handed it works out, per frame pair, the Euler-Lagrange system that the
program solves (the reduced interior system of velocity and net
remodelling, the mirror boundary rows folded into the stencil,
``dy_mode='compat'``'s rule), solves it exactly by block Gaussian
elimination over grid rows (a block-tridiagonal system, one dense block of
3 x n unknowns a row), and derives from the solution what the program
returns: the flow fields, and the per-cell statistics and functional of a
regularisation sweep.

The system, per pair, in the units the program states its tolerance in:
frames over their peak ``s`` (I), ``alpha_s / s**2`` and ``alpha_r``, the
unknowns (u_x, u_y) in pixels a frame and gamma / s.  Rows at interior
pixel (i, j) with the neighbours' values at (i+di, j+dj) as the equations
of the reference engine's `el_operator` give them; a neighbour outside the
interior reads its mirror (row -1 reads row 1, row m reads row m-2, and
columns alike) and one outside in both directions reads twice its mirror.

Everything here runs on any device in float64, on the card after the
program's state is freed.  Plain torch only: `torch.linalg.solve` and
matrix products in float64 (no TF32 applies to them).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

F64 = torch.float64


def _dx(m):
    return (m[..., 2:, 1:-1] - m[..., :-2, 1:-1]) * 0.5


def _dy_fixed(m):
    return (m[..., 1:-1, 2:] - m[..., 1:-1, :-2]) * 0.5


def _dy(m, compat):
    # dy_mode='compat' keeps the reference engine's defect: its "dy"
    # differentiates along x
    return _dx(m) if compat else _dy_fixed(m)


def _dxx(m):
    return m[..., 2:, 1:-1] + m[..., :-2, 1:-1] - 2.0 * m[..., 1:-1, 1:-1]


def _dyy(m):
    return m[..., 1:-1, 2:] + m[..., 1:-1, :-2] - 2.0 * m[..., 1:-1, 1:-1]


def _dxy(m):
    return (m[..., 2:, 2:] - m[..., 2:, :-2] - m[..., :-2, 2:] + m[..., :-2, :-2]) * 0.25


def pair_system(prev: torch.Tensor, cur: torch.Tensor, alpha_s, alpha_r, compat: bool = True):
    """The stencil and right-hand side of the normalised system of frame
    pairs ``prev``, ``cur`` (B, Ni, Nj).

    Returns ``(stencil, rhs, s, planes)``: ``stencil`` (B, 3, 3, 3, 3, m, n)
    indexed [b, out field, in field, di + 1, dj + 1, i, j]; ``rhs`` (B, 3,
    m, n); ``s`` (B,) the intensity peaks; ``planes`` what the functionals
    need (I, dI/dx, dI/dy, dI/dt of the interior, alpha_s / s**2, alpha_r).
    """
    prev = prev.to(F64)
    cur = cur.to(F64)
    B = prev.shape[0]
    s = prev.abs().flatten(1).amax(dim=1).clamp_min(1e-30)
    P = prev / s[:, None, None]
    C = cur / s[:, None, None]
    a_s = (torch.as_tensor(alpha_s, dtype=F64, device=prev.device).expand(B) / s**2)[:, None, None]
    a_r = torch.as_tensor(alpha_r, dtype=F64, device=prev.device).expand(B)[:, None, None]
    I = P[:, 1:-1, 1:-1]
    Ix, Iy = _dx(P), _dy(P, compat)
    m, n = I.shape[-2:]
    st = prev.new_zeros((B, 3, 3, 3, 3, m, n))

    def put(fo, fi, di, dj, value):
        st[:, fo, fi, di + 1, dj + 1] += value

    ones = torch.ones_like(I)
    # velocity x row
    put(0, 0, 0, 0, I * (_dxx(P) - 2.0 * I) - 4.0 * a_s)
    put(0, 1, 0, 0, I * _dxy(P))
    put(0, 0, -1, 0, I * (-Ix + I) + a_s)
    put(0, 0, 1, 0, I * (Ix + I) + a_s)
    put(0, 0, 0, -1, a_s * ones)
    put(0, 0, 0, 1, a_s * ones)
    put(0, 1, 0, 1, I * Ix * 0.5)
    put(0, 1, 0, -1, -I * Ix * 0.5)
    put(0, 1, 1, 0, I * Iy * 0.5)
    put(0, 1, -1, 0, -I * Iy * 0.5)
    for di, dj, sign in ((-1, -1, 1.0), (1, 1, 1.0), (-1, 1, -1.0), (1, -1, -1.0)):
        put(0, 1, di, dj, sign * I * I * 0.25)
        put(1, 0, di, dj, sign * I * I * 0.25)
    put(0, 2, -1, 0, I * 0.5)
    put(0, 2, 1, 0, -I * 0.5)
    # velocity y row
    put(1, 1, 0, 0, I * (_dyy(P) - 2.0 * I) - 4.0 * a_s)
    put(1, 0, 0, 0, I * _dxy(P))
    put(1, 1, 0, -1, I * (-Iy + I) + a_s)
    put(1, 1, 0, 1, I * (Iy + I) + a_s)
    put(1, 1, -1, 0, a_s * ones)
    put(1, 1, 1, 0, a_s * ones)
    put(1, 0, 1, 0, I * Iy * 0.5)
    put(1, 0, -1, 0, -I * Iy * 0.5)
    put(1, 0, 0, 1, I * Ix * 0.5)
    put(1, 0, 0, -1, -I * Ix * 0.5)
    put(1, 2, 0, -1, I * 0.5)
    put(1, 2, 0, 1, -I * 0.5)
    # remodelling row
    put(2, 2, 0, 0, (-1.0 - 4.0 * a_r) * ones)
    put(2, 0, 0, 0, Ix)
    put(2, 1, 0, 0, Iy)
    for di, dj in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        put(2, 2, di, dj, a_r * ones)
    put(2, 0, 1, 0, I * 0.5)
    put(2, 0, -1, 0, -I * 0.5)
    put(2, 1, 0, 1, I * 0.5)
    put(2, 1, 0, -1, -I * 0.5)

    rhs = torch.stack([-I * (_dx(C) - _dx(P)),
                       -I * (_dy_fixed(C) - _dy_fixed(P)),
                       -(C - P)[:, 1:-1, 1:-1]], dim=1)
    planes = {"I": I, "Ix": Ix, "Iy": Iy, "It": (C - P)[:, 1:-1, 1:-1],
              "a_s": a_s[:, 0, 0], "a_r": a_r[:, 0, 0]}
    return st, rhs, s, planes


def _extend(u: torch.Tensor, corner: float) -> torch.Tensor:
    """(..., m, n) -> (..., m+2, n+2): mirror rows and columns, each of the
    four corners ``corner`` times its mirror."""
    top, bottom = u[..., 1:2, :], u[..., -2:-1, :]
    ext = torch.cat([top, u, bottom], dim=-2)
    ext = torch.cat([ext[..., :, 1:2], ext, ext[..., :, -2:-1]], dim=-1)
    if corner != 1.0:
        for r in (0, -1):
            for c in (0, -1):
                ext[..., r, c] = ext[..., r, c] * corner
    return ext


def apply(stencil: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A x of the reduced system: ``x`` (B, 3, m, n) -> (B, 3, m, n)."""
    m, n = x.shape[-2:]
    ext = _extend(x, 2.0)
    y = torch.zeros_like(x)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            shifted = ext[:, :, 1 + di: 1 + di + m, 1 + dj: 1 + dj + n]  # (B, 3 in, m, n)
            y += torch.einsum("boimn,bimn->bomn", stencil[:, :, :, di + 1, dj + 1], shifted)
    return y


def _row_blocks(stencil: torch.Tensor, i: int):
    """The blocks (B, 3n, 3n) that couple row ``i`` to rows i-1, i and i+1,
    the mirror rules folded in (row 0 couples to row 1 alone, row m-1 to
    row m-2 alone)."""
    B, m, n = stencil.shape[0], stencil.shape[-2], stencil.shape[-1]
    blocks = {r: stencil.new_zeros((B, 3, n, 3, n)) for r in (-1, 0, 1)}
    for di in (-1, 0, 1):
        row = i + di
        row_mirrored = row < 0 or row >= m
        r = (1 if row < 0 else -1) if row_mirrored else di
        for dj in (-1, 0, 1):
            c = stencil[:, :, :, di + 1, dj + 1, i, :]  # (B, out, in, n)
            c = c.permute(0, 1, 3, 2)  # (B, out, j, in)
            blk = blocks[r]
            # interior columns: j' = j + dj
            lo, hi = max(0, -dj), n - max(0, dj)
            jj = torch.arange(lo, hi, device=c.device)
            blk[:, :, jj, :, jj + dj] += c[:, :, lo:hi, :].permute(2, 0, 1, 3)
            # a column that leaves the interior reads its mirror
            if dj != 0:
                j = 0 if dj < 0 else n - 1
                jm = 1 if dj < 0 else n - 2
                factor = 2.0 if row_mirrored else 1.0
                blk[:, :, j, :, jm] += factor * c[:, :, j, :]
    return {r: b.reshape(B, 3 * n, 3 * n) for r, b in blocks.items()}


def _band(block: torch.Tensor, n: int) -> torch.Tensor:
    """The three column diagonals of a row-coupling block (B, 3n, 3n), as
    (B, 3, n, 3, 3) indexed [b, out field, j, in field, k] for column
    j + k - 1: a block couples a pixel to its row neighbours' columns
    j - 1, j and j + 1 alone (a mirrored column folds into one of them)."""
    B = block.shape[0]
    full = block.reshape(B, 3, n, 3, n)
    band = block.new_zeros((B, 3, n, 3, 3))
    for k in range(3):
        diag = torch.diagonal(full, offset=k - 1, dim1=2, dim2=4)  # (B, out, in, j)
        lo = max(0, 1 - k)
        band[:, :, lo:lo + diag.shape[-1], :, k] = diag.permute(0, 1, 3, 2)
    return band


def _band_mul(band: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``block @ x`` for a block given by ``_band``; ``x`` (B, 3n, w)."""
    B, _, n = band.shape[:3]
    xp = torch.nn.functional.pad(x.reshape(B, 3, n, -1), (0, 0, 1, 1))
    y = sum(torch.einsum("bojc,bcjw->bojw", band[..., k], xp[:, :, k:k + n]) for k in range(3))
    return y.reshape(B, 3 * n, -1)


def solve(stencil: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """The exact solution (B, 3, m, n) of the reduced system, by block
    Gaussian elimination over rows (block Thomas)."""
    B, _, m, n = rhs.shape
    b = rhs.permute(0, 2, 1, 3).reshape(B, m, 3 * n)
    gains, zs = [], []
    for i in range(m):
        blocks = _row_blocks(stencil, i)
        D, U = blocks[0], blocks[1]
        if i == 0:
            S, y = D, b[:, 0]
        else:
            L = _band(blocks[-1], n)
            S = D - _band_mul(L, gains[-1])
            y = b[:, i] - _band_mul(L, zs[-1][..., None])[..., 0]
        sol = torch.linalg.solve(S, torch.cat([U, y[..., None]], dim=-1))
        gains.append(sol[..., :-1])
        zs.append(sol[..., -1])
    x = [None] * m
    x[m - 1] = zs[m - 1]
    for i in range(m - 2, -1, -1):
        x[i] = zs[i] - (gains[i] @ x[i + 1][..., None])[..., 0]
    return torch.stack(x, dim=1).reshape(B, m, 3, n).permute(0, 2, 1, 3)


def embed(x: torch.Tensor) -> torch.Tensor:
    """Interior solution to the full grid, corners the single mirror."""
    return _extend(x, 1.0)


def reference_flow(prev, cur, alpha_s, alpha_r, compat: bool = True):
    """Full-grid (B, 3, Ni, Nj) flow in pixels a frame and gamma in the
    frames' units, with the system's pieces."""
    st, rhs, s, planes = pair_system(prev, cur, alpha_s, alpha_r, compat)
    x = solve(st, rhs)
    u = embed(x)
    return u, s, planes, st, rhs, x


def functionals(u: torch.Tensor, planes: Dict[str, torch.Tensor], compat: bool = True):
    """(L1, speed, remodelling) functionals (B,) of normalised full-grid
    solutions ``u`` (B, 3, Ni, Nj), as the engine defines them."""
    vx, vy, g = u[:, 0], u[:, 1], u[:, 2]
    dvx_dx, dvx_dy = _dx(vx), _dy(vx, compat)
    dvy_dx, dvy_dy = _dx(vy), _dy(vy, compat)
    dg_dx, dg_dy = _dx(g), _dy(g, compat)
    I = planes["I"]
    data = (planes["It"] + vx[:, 1:-1, 1:-1] * planes["Ix"] + vy[:, 1:-1, 1:-1] * planes["Iy"]
            + I * dvx_dx + I * dvy_dy - g[:, 1:-1, 1:-1])
    area = (-2, -1)
    l1 = (data**2).sum(area)
    sf = planes["a_s"] * (dvx_dx**2 + dvx_dy**2 + dvy_dx**2 + dvy_dy**2).sum(area)
    rf = planes["a_r"] * (dg_dx**2 + dg_dy**2).sum(area)
    return l1, sf, rf


def sweep_statistics(prev, cur, alpha_s, alpha_r, scale: float = 1.0, compat: bool = True
                     ) -> Dict[str, torch.Tensor]:
    """Per-cell statistics of one-pair sweep cells: ``prev``, ``cur`` (B,
    Ni, Nj) (the pair repeated), ``alpha_s``, ``alpha_r`` (B,); ``scale``
    is delta_x / delta_t.  Keys as the engine's sweep returns them."""
    u, s, planes, *_ = reference_flow(prev, cur, alpha_s, alpha_r, compat)
    l1, sf, rf = functionals(u, planes, compat)
    speed = torch.sqrt((u[:, 0] * scale) ** 2 + (u[:, 1] * scale) ** 2)
    g = u[:, 2] * s[:, None, None]
    axes = (1, 2)
    return {
        "speed_means": speed.mean(axes),
        "speed_variances": speed.var(axes, correction=0),
        "remodelling_means": g.mean(axes),
        "remodelling_variances": g.var(axes, correction=0),
        "functional": (l1 + sf + rf) * s**2,
    }


def movie_fields(prev, cur, alpha_s, alpha_r, compat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference (B, 2, Ni, Nj) velocity in pixels a frame and (B, Ni, Nj)
    remodelling in the frames' units."""
    u, s, *_ = reference_flow(prev, cur, alpha_s, alpha_r, compat)
    return u[:, :2], u[:, 2] * s[:, None, None]
