"""Matrix-free Euler-Lagrange operator, batched over frame pairs.

Counterpart of ``opticalflow_tpu.ops.elop``.  Every plane carries the
leading batch axes of the frames it was built from: frames ``(B, Ni, Nj)``
give coefficient planes ``(B, Ni-2, Nj-2)``, per-pair scalars ``(B,)`` and
field stacks ``(B, 3, Ni, Nj)``.  Frames with one more leading axis,
``(B, 1, Ni, Nj)``, give planes that broadcast over a ``(B, K, 3, ...)``
stack of K fields per pair (the comb probes of the multigrid setup).

Row semantics are the JAX package's: interior rows are the coupled EL
equations for (u_x, u_y, gamma); the mirror boundary rows are folded into
the interior stencil ("reduced" system, :func:`extend_interior`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from opticalflow_tpu_torch.core import stencils
from opticalflow_tpu_torch.ops import df32
from opticalflow_tpu_torch.utils import observability


class ELCoefficients(NamedTuple):
    """Coefficient planes ``(..., Ni-2, Nj-2)`` and per-pair scalars
    ``(...)`` of the EL operator."""

    diag_x: torch.Tensor  # I*(dIdxx - 2I) - 4*alpha_s
    diag_y: torch.Tensor  # I*(dIdyy - 2I) - 4*alpha_s
    cross: torch.Tensor  # I*dIdxy
    adv_xm: torch.Tensor  # I*(-dIdx + I) + alpha_s
    adv_xp: torch.Tensor  # I*(+dIdx + I) + alpha_s
    adv_ym: torch.Tensor  # I*(-dIdy + I) + alpha_s
    adv_yp: torch.Tensor  # I*(+dIdy + I) + alpha_s
    gx: torch.Tensor  # I*dIdx/2
    gy: torch.Tensor  # I*dIdy/2
    quart: torch.Tensor  # I^2/4
    half_I: torch.Tensor  # I/2
    dIdx: torch.Tensor
    dIdy: torch.Tensor
    speed_alpha: torch.Tensor  # per pair
    remodelling_alpha: torch.Tensor  # per pair


class FramePairData(NamedTuple):
    """Everything derived from a batch of (previous, current) frame pairs."""

    coeffs: ELCoefficients
    rhs: torch.Tensor  # (..., 3, Ni, Nj)
    dIdx: torch.Tensor
    dIdy: torch.Tensor
    dIdt: torch.Tensor
    I_interior: torch.Tensor


def per_pair(value, like: torch.Tensor) -> torch.Tensor:
    """A scalar or per-pair value as a tensor of the frames' batch shape."""
    t = torch.as_tensor(value, dtype=like.dtype, device=like.device)
    return t.expand(like.shape[:-2]) if t.dim() == 0 else t.reshape(like.shape[:-2])


def compute_coefficients(
    previous_frame: torch.Tensor, speed_alpha, remodelling_alpha, dy_mode: str
) -> ELCoefficients:
    """Coefficient planes from the previous frames ``(..., Ni, Nj)``."""
    prev = previous_frame
    I = prev[..., 1:-1, 1:-1]
    dIdx = stencils.ddx(prev)
    dIdy = stencils.ddy(prev, mode=dy_mode)
    dIdxx = stencils.ddxx(prev)
    dIdyy = stencils.ddyy(prev)
    dIdxy = stencils.ddxy(prev)
    a_s = per_pair(speed_alpha, prev)
    a_r = per_pair(remodelling_alpha, prev)
    s = a_s[..., None, None]
    return ELCoefficients(
        diag_x=I * (dIdxx - 2.0 * I) - 4.0 * s,
        diag_y=I * (dIdyy - 2.0 * I) - 4.0 * s,
        cross=I * dIdxy,
        adv_xm=I * (-dIdx + I) + s,
        adv_xp=I * (dIdx + I) + s,
        adv_ym=I * (-dIdy + I) + s,
        adv_yp=I * (dIdy + I) + s,
        gx=I * dIdx * 0.5,
        gy=I * dIdy * 0.5,
        quart=I * I * 0.25,
        half_I=I * 0.5,
        dIdx=dIdx,
        dIdy=dIdy,
        speed_alpha=a_s,
        remodelling_alpha=a_r,
    )


def compute_frame_pair_data(
    previous_frame: torch.Tensor,
    current_frame: torch.Tensor,
    speed_alpha,
    remodelling_alpha,
    dy_mode: str = stencils.DY_COMPAT,
) -> FramePairData:
    """Derivative planes, coefficient planes and RHS of a batch of frame
    pairs ``(..., Ni, Nj)``.  ``dIdy_t`` always takes the fixed dy rule,
    in compat mode too, as in the JAX package."""
    prev, cur = previous_frame, current_frame
    coeffs = compute_coefficients(prev, speed_alpha, remodelling_alpha, dy_mode)
    I = prev[..., 1:-1, 1:-1]
    dIdx_t = stencils.ddx(cur) - stencils.ddx(prev)
    dIdy_t = stencils.ddy(cur, mode=stencils.DY_FIXED) - stencils.ddy(prev, mode=stencils.DY_FIXED)
    dIdt = (cur - prev)[..., 1:-1, 1:-1]
    rhs = prev.new_zeros(prev.shape[:-2] + (3,) + prev.shape[-2:])
    rhs[..., 0, 1:-1, 1:-1] = -I * dIdx_t
    rhs[..., 1, 1:-1, 1:-1] = -I * dIdy_t
    rhs[..., 2, 1:-1, 1:-1] = -dIdt
    return FramePairData(coeffs=coeffs, rhs=rhs, dIdx=coeffs.dIdx, dIdy=coeffs.dIdy,
                         dIdt=dIdt, I_interior=I)


def _shift(f: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """``f(i+di, j+dj)`` on the interior grid of a full ``(..., Ni, Nj)``
    plane; |di|, |dj| <= 1."""
    ni, nj = f.shape[-2:]
    return f[..., 1 + di : ni - 1 + di, 1 + dj : nj - 1 + dj]


def interior_apply(coeffs: ELCoefficients, u: torch.Tensor) -> torch.Tensor:
    """Interior EL equations on a full-grid stack ``(..., 3, Ni, Nj)``;
    returns ``(..., 3, Ni-2, Nj-2)``.  The term order is the JAX
    package's."""
    ux, uy, g = u[..., 0, :, :], u[..., 1, :, :], u[..., 2, :, :]
    c = coeffs
    a_s = c.speed_alpha[..., None, None]
    a_r = c.remodelling_alpha[..., None, None]

    y_ux = (
        c.diag_x * _shift(ux, 0, 0)
        + c.cross * _shift(uy, 0, 0)
        + c.adv_xm * _shift(ux, -1, 0)
        + c.adv_xp * _shift(ux, +1, 0)
        + a_s * (_shift(ux, 0, -1) + _shift(ux, 0, +1))
        + c.gx * (_shift(uy, 0, +1) - _shift(uy, 0, -1))
        + c.gy * (_shift(uy, +1, 0) - _shift(uy, -1, 0))
        + c.quart
        * (_shift(uy, -1, -1) + _shift(uy, +1, +1) - _shift(uy, -1, +1) - _shift(uy, +1, -1))
        + c.half_I * (_shift(g, -1, 0) - _shift(g, +1, 0))
    )
    y_uy = (
        c.diag_y * _shift(uy, 0, 0)
        + c.cross * _shift(ux, 0, 0)
        + c.adv_ym * _shift(uy, 0, -1)
        + c.adv_yp * _shift(uy, 0, +1)
        + a_s * (_shift(uy, -1, 0) + _shift(uy, +1, 0))
        + c.gy * (_shift(ux, +1, 0) - _shift(ux, -1, 0))
        + c.gx * (_shift(ux, 0, +1) - _shift(ux, 0, -1))
        + c.quart
        * (_shift(ux, -1, -1) + _shift(ux, +1, +1) - _shift(ux, -1, +1) - _shift(ux, +1, -1))
        + c.half_I * (_shift(g, 0, -1) - _shift(g, 0, +1))
    )
    y_g = (
        (-1.0 - 4.0 * a_r) * _shift(g, 0, 0)
        + c.dIdx * _shift(ux, 0, 0)
        + c.dIdy * _shift(uy, 0, 0)
        + a_r * (_shift(g, -1, 0) + _shift(g, +1, 0) + _shift(g, 0, -1) + _shift(g, 0, +1))
        + c.half_I * (_shift(ux, +1, 0) - _shift(ux, -1, 0))
        + c.half_I * (_shift(uy, 0, +1) - _shift(uy, 0, -1))
    )
    return torch.stack([y_ux, y_uy, y_g], dim=-3)


def _extend_with_corners(u_int: torch.Tensor, corner_factor: float) -> torch.Tensor:
    """Surround an interior stack ``(..., m, n)`` with mirror boundary
    values (row -1 reads row 1, row m reads row m-2, columns likewise);
    the four corners are scaled by ``corner_factor``.  Two ops: a reflect
    pad (its corner (-1, -1) reads (1, 1), the mirror of the mirror) and
    one in-place scale of the corners."""
    lead, (m, n) = u_int.shape[:-2], u_int.shape[-2:]
    flat = u_int.reshape((math.prod(lead), m, n))  # reflect pads 3-d tensors
    ext = F.pad(flat, (1, 1, 1, 1), mode="reflect").reshape(lead + (m + 2, n + 2))
    if corner_factor != 1.0:
        ext[..., :: m + 1, :: n + 1] *= corner_factor
    return ext


def extend_interior(u_int: torch.Tensor) -> torch.Tensor:
    """Extend an interior stack to the full grid with the reduced system's
    boundary constraints (edge mirror; corner = 2x the diagonal value)."""
    return _extend_with_corners(u_int, 2.0)


def embed_interior(u_int: torch.Tensor) -> torch.Tensor:
    """Interior solution into the full grid with the reference's post-solve
    mirror fix-up: corners take the *single* mirror value."""
    return _extend_with_corners(u_int, 1.0)


def el_matvec_reduced(coeffs: ELCoefficients, u_int: torch.Tensor) -> torch.Tensor:
    """y = A_reduced u on the interior grid, from precomputed planes (the
    plain operator; the solve's default is the fused kernel in
    ops.cuda_kernels)."""
    return interior_apply(coeffs, extend_interior(u_int))


# ---------------------------------------------------------------------------
# Boundary-ring application of the reduced operator on thin strips.
#
# The hybrid matvec (ops.cuda_kernels.el_matvec_hybrid) runs the plain
# stencil kernel, whose reads outside the interior are zero, and overwrites
# the one-pixel boundary ring of its output, the only pixels where the
# mirror semantics matter, with the values computed here from O(m+n) strips.
# Plain torch ops, as the ring is an XLA pass in the JAX package.
# ---------------------------------------------------------------------------


def _slice_coeffs(c: ELCoefficients, rs, cs) -> ELCoefficients:
    """Slice every coefficient plane ``(..., m, n)`` (scalars pass
    through)."""
    scalars = ("speed_alpha", "remodelling_alpha")
    return c._replace(**{name: getattr(c, name)[..., rs, cs]
                         for name in c._fields if name not in scalars})


class RingCoeffs(NamedTuple):
    """Coefficient strips of the four boundary-ring rows/cols, sliced once
    per batch of pairs (top/bottom planes are (..., 1, n); left/right
    (..., m, 1))."""

    top: ELCoefficients
    bottom: ELCoefficients
    left: ELCoefficients
    right: ELCoefficients


def ring_coeffs(c: ELCoefficients) -> RingCoeffs:
    sl = slice(None)
    return RingCoeffs(
        top=_slice_coeffs(c, slice(0, 1), sl),
        bottom=_slice_coeffs(c, slice(-1, None), sl),
        left=_slice_coeffs(c, sl, slice(0, 1)),
        right=_slice_coeffs(c, sl, slice(-1, None)),
    )


def with_probe_axis(c: ELCoefficients) -> ELCoefficients:
    """Planes (B, ...) and scalars (B,) viewed as (B, 1, ...) / (B, 1), to
    broadcast over a (B, K, 3, m, n) stack of K fields per pair."""
    return ELCoefficients(*[field[:, None] for field in c])


def ring_apply(rc: RingCoeffs, u_int: torch.Tensor):
    """Reduced-matvec values on the boundary ring of the interior grid.

    ``u_int``: (B, 3, m, n), or (B, K, 3, m, n) when ``rc`` was built from
    planes with a probe axis (:func:`with_probe_axis`).  Returns ``(top,
    bottom, left, right)`` of shapes (..., 3, n), (..., 3, n), (..., 3, m),
    (..., 3, m); the four corner pixels appear in both their strips with
    identical values.  Each strip is :func:`interior_apply` on a 3-row/3-col
    extended slab built from two interior strips, O(m+n) work in all.
    """
    x = u_int

    def ext(line, corner):
        # interior line (..., 3, L) -> extended (..., 3, L+2) with mirrors
        return torch.cat([corner * line[..., 1:2], line, corner * line[..., -2:-1]], dim=-1)

    # top slab: ext rows 0..2 (ext row i+1 = interior row i; ext row 0
    # mirrors interior row 1, global corners doubled)
    slab_top = torch.stack([ext(x[..., 1, :], 2.0), ext(x[..., 0, :], 1.0),
                            ext(x[..., 1, :], 1.0)], dim=-2)
    top = interior_apply(rc.top, slab_top)[..., 0, :]

    # bottom slab: ext rows m-1..m+1 (ext row m+1 mirrors interior m-2)
    slab_bot = torch.stack([ext(x[..., -2, :], 1.0), ext(x[..., -1, :], 1.0),
                            ext(x[..., -2, :], 2.0)], dim=-2)
    bottom = interior_apply(rc.bottom, slab_bot)[..., 0, :]

    # left slab: ext cols 0..2 over all ext rows
    slab_left = torch.stack([ext(x[..., :, 1], 2.0), ext(x[..., :, 0], 1.0),
                             ext(x[..., :, 1], 1.0)], dim=-1)
    left = interior_apply(rc.left, slab_left)[..., 0]

    # right slab: ext cols n-1..n+1
    slab_right = torch.stack([ext(x[..., :, -2], 1.0), ext(x[..., :, -1], 1.0),
                              ext(x[..., :, -2], 2.0)], dim=-1)
    right = interior_apply(rc.right, slab_right)[..., 0]

    return top, bottom, left, right


def ring_overwrite(y: torch.Tensor, rc: RingCoeffs, u_int: torch.Tensor) -> torch.Tensor:
    """Overwrite the boundary ring of ``y`` (same shape as ``u_int``) in
    place with :func:`ring_apply`, in the JAX package's order (top, bottom,
    left, right); returns ``y``."""
    top, bottom, left, right = ring_apply(rc, u_int)
    y[..., 0, :] = top
    y[..., -1, :] = bottom
    y[..., :, 0] = left
    y[..., :, -1] = right
    return y


def diag_blocks(coeffs: ELCoefficients) -> torch.Tensor:
    """Per-pixel 3x3 diagonal blocks of the interior operator,
    ``(..., Ni-2, Nj-2, 3, 3)`` (the JAX package's layout)."""
    c = coeffs
    z = torch.zeros_like(c.diag_x)
    gD = -1.0 - 4.0 * c.remodelling_alpha[..., None, None] + z
    row0 = torch.stack([c.diag_x, c.cross, z], dim=-1)
    row1 = torch.stack([c.cross, c.diag_y, z], dim=-1)
    row2 = torch.stack([c.dIdx, c.dIdy, gD], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def block_jacobi_inverse_apply_interior(coeffs: ELCoefficients, r: torch.Tensor) -> torch.Tensor:
    """Block-Jacobi preconditioner apply on an interior stack
    ``(..., 3, Ni-2, Nj-2)``."""
    c = coeffs
    r1, r2, r3 = r[..., 0, :, :], r[..., 1, :, :], r[..., 2, :, :]
    a, b, cc = c.diag_x, c.diag_y, c.cross
    det = a * b - cc * cc
    gD = -1.0 - 4.0 * c.remodelling_alpha[..., None, None]
    x1 = (b * r1 - cc * r2) / det
    x2 = (a * r2 - cc * r1) / det
    x3 = (r3 - c.dIdx * x1 - c.dIdy * x2) / gD
    return torch.stack([x1, x2, x3], dim=-3)


# ---------------------------------------------------------------------------
# Double-float (df32) system data + residual for iterative refinement.
#
# The f32 matvec is cancellative (terms O(alpha*u) cancel to a result ~1e3x
# smaller) and f32-computed coefficient planes perturb the system, so the
# refinement residual is evaluated against system data computed in
# compensated pair arithmetic (ops.df32).  Planes are (..., m, n) pairs;
# per-pair scalars are (..., 1, 1) pairs so that they broadcast.  On the
# card the refinement runs the residual and the operator through kernel B4
# (ops.cuda_kernels.el_residual_df32 / el_matvec_df32, csrc/el_df32.cu, the
# one place ops.df32's transforms are fused, built with -fmad=false); the
# two functions below are its plain versions.
# ---------------------------------------------------------------------------


class ELPairDataDF(NamedTuple):
    """Double-float system data of a batch of pairs (normalised units);
    every field is a ``(hi, lo)`` pair."""

    diag_x: tuple
    diag_y: tuple
    cross: tuple
    adv_xm: tuple
    adv_xp: tuple
    adv_ym: tuple
    adv_yp: tuple
    gx: tuple
    gy: tuple
    quart: tuple
    half_I: tuple
    dIdx: tuple
    dIdy: tuple
    a_s: tuple
    a_r: tuple
    gD: tuple
    rhs_hi: torch.Tensor  # (..., 3, m, n)
    rhs_lo: torch.Tensor


def compute_frame_pair_data_df(
    previous_frame_raw: torch.Tensor,
    current_frame_raw: torch.Tensor,
    speed_alpha_raw,
    remodelling_alpha,
    dy_mode: str,
    intensity_scale: torch.Tensor,
) -> ELPairDataDF:
    """The df32 data of the *normalised* system, built from the raw frames
    ``(..., Ni, Nj)`` and the per-pair ``intensity_scale`` ``(...)``: the
    normalisation division, every derivative and every coefficient product
    run in pair arithmetic."""
    s = intensity_scale[..., None, None]
    prev = df32.df_div(df32.df_from(previous_frame_raw), s)
    cur = df32.df_div(df32.df_from(current_frame_raw), s)

    def sl(p, rows, cols):
        return p[0][..., rows, cols], p[1][..., rows, cols]

    c_, lo_, hi_ = slice(1, -1), slice(None, -2), slice(2, None)

    def ddx_df(p):
        return df32.df_scale_pow2(df32.df_sub(sl(p, hi_, c_), sl(p, lo_, c_)), 0.5)

    def ddy_df(p):
        return df32.df_scale_pow2(df32.df_sub(sl(p, c_, hi_), sl(p, c_, lo_)), 0.5)

    I = sl(prev, c_, c_)
    dIdx = ddx_df(prev)
    dIdy = dIdx if dy_mode == stencils.DY_COMPAT else ddy_df(prev)
    two_I = df32.df_scale_pow2(I, 2.0)
    dIdxx = df32.df_sub(df32.df_add(sl(prev, hi_, c_), sl(prev, lo_, c_)), two_I)
    dIdyy = df32.df_sub(df32.df_add(sl(prev, c_, hi_), sl(prev, c_, lo_)), two_I)
    dIdxy = df32.df_scale_pow2(
        df32.df_add(
            df32.df_sub(sl(prev, hi_, hi_), sl(prev, hi_, lo_)),
            df32.df_sub(sl(prev, lo_, lo_), sl(prev, lo_, hi_)),
        ),
        0.25,
    )
    dIdx_t = df32.df_sub(ddx_df(cur), ddx_df(prev))
    dIdy_t = df32.df_sub(ddy_df(cur), ddy_df(prev))
    dIdt = df32.df_sub(sl(cur, c_, c_), I)

    a_s = df32.df_div(df32.df_div_f(per_pair(speed_alpha_raw, previous_frame_raw)[..., None, None], s), s)
    a_r = df32.df_from(per_pair(remodelling_alpha, previous_frame_raw)[..., None, None])
    four_a_s = df32.df_scale_pow2(a_s, 4.0)
    with observability.host_wait():  # a copy from pageable host memory
        minus_one = torch.tensor(-1.0, dtype=s.dtype, device=s.device)
    gD = df32.df_add_pf(df32.df_scale_pow2(a_r, -4.0), minus_one)

    diag_x = df32.df_sub(df32.df_mul(I, df32.df_sub(dIdxx, two_I)), four_a_s)
    diag_y = df32.df_sub(df32.df_mul(I, df32.df_sub(dIdyy, two_I)), four_a_s)
    cross = df32.df_mul(I, dIdxy)
    adv_xm = df32.df_add(df32.df_mul(I, df32.df_sub(I, dIdx)), a_s)
    adv_xp = df32.df_add(df32.df_mul(I, df32.df_add(dIdx, I)), a_s)
    adv_ym = df32.df_add(df32.df_mul(I, df32.df_sub(I, dIdy)), a_s)
    adv_yp = df32.df_add(df32.df_mul(I, df32.df_add(dIdy, I)), a_s)
    gx = df32.df_scale_pow2(df32.df_mul(I, dIdx), 0.5)
    gy = df32.df_scale_pow2(df32.df_mul(I, dIdy), 0.5)
    quart = df32.df_scale_pow2(df32.df_mul(I, I), 0.25)
    half_I = df32.df_scale_pow2(I, 0.5)

    r0 = df32.df_neg(df32.df_mul(I, dIdx_t))
    r1 = df32.df_neg(df32.df_mul(I, dIdy_t))
    r2 = df32.df_neg(dIdt)
    return ELPairDataDF(
        diag_x=diag_x, diag_y=diag_y, cross=cross,
        adv_xm=adv_xm, adv_xp=adv_xp, adv_ym=adv_ym, adv_yp=adv_yp,
        gx=gx, gy=gy, quart=quart, half_I=half_I,
        dIdx=dIdx, dIdy=dIdy, a_s=a_s, a_r=a_r, gD=gD,
        rhs_hi=torch.stack([r0[0], r1[0], r2[0]], dim=-3),
        rhs_lo=torch.stack([r0[1], r1[1], r2[1]], dim=-3),
    )


def el_residual_df(dfd: ELPairDataDF, x_hi: torch.Tensor, x_lo: torch.Tensor) -> torch.Tensor:
    """``b - A_reduced x`` of the df32 system for ``x = x_hi + x_lo``
    ``(..., 3, m, n)``, exact to ~eps^2.  The mirror extension only copies
    and doubles values (exact), so it applies to hi and lo apart.  ~1,200
    torch ops a call; on the card the refinement runs it as kernel B4
    (``cuda_kernels.el_residual_df32``), which equals it bit for bit."""
    u_hi = extend_interior(x_hi)
    u_lo = extend_interior(x_lo)

    def sh2(q, di, dj):
        return _shift(u_hi[..., q, :, :], di, dj), _shift(u_lo[..., q, :, :], di, dj)

    def acc_sub(acc, coef, plane):
        # acc -= coef * plane; the x_lo products stay plain (their rounding
        # is ~eps^2 of the term)
        c_hi, c_lo = coef
        p_hi, p_lo = plane
        p, e = df32.two_prod(c_hi, p_hi)
        small = e + c_lo * p_hi + c_hi * p_lo
        s, e2 = df32.two_sum(acc[0], -p)
        return s, acc[1] + (e2 - small)

    def neg(coef):
        return -coef[0], -coef[1]

    d = dfd
    UX, UY, G = 0, 1, 2

    def chan(q, terms):
        acc = (d.rhs_hi[..., q, :, :], d.rhs_lo[..., q, :, :])
        for coef, (f, di, dj) in terms:
            acc = acc_sub(acc, coef, sh2(f, di, dj))
        return df32.df_result(acc)

    r_ux = chan(UX, [
        (d.diag_x, (UX, 0, 0)), (d.cross, (UY, 0, 0)),
        (d.adv_xm, (UX, -1, 0)), (d.adv_xp, (UX, +1, 0)),
        (d.a_s, (UX, 0, -1)), (d.a_s, (UX, 0, +1)),
        (d.gx, (UY, 0, +1)), (neg(d.gx), (UY, 0, -1)),
        (d.gy, (UY, +1, 0)), (neg(d.gy), (UY, -1, 0)),
        (d.quart, (UY, -1, -1)), (d.quart, (UY, +1, +1)),
        (neg(d.quart), (UY, -1, +1)), (neg(d.quart), (UY, +1, -1)),
        (d.half_I, (G, -1, 0)), (neg(d.half_I), (G, +1, 0)),
    ])
    r_uy = chan(UY, [
        (d.diag_y, (UY, 0, 0)), (d.cross, (UX, 0, 0)),
        (d.adv_ym, (UY, 0, -1)), (d.adv_yp, (UY, 0, +1)),
        (d.a_s, (UY, -1, 0)), (d.a_s, (UY, +1, 0)),
        (d.gy, (UX, +1, 0)), (neg(d.gy), (UX, -1, 0)),
        (d.gx, (UX, 0, +1)), (neg(d.gx), (UX, 0, -1)),
        (d.quart, (UX, -1, -1)), (d.quart, (UX, +1, +1)),
        (neg(d.quart), (UX, -1, +1)), (neg(d.quart), (UX, +1, -1)),
        (d.half_I, (G, 0, -1)), (neg(d.half_I), (G, 0, +1)),
    ])
    r_g = chan(G, [
        (d.gD, (G, 0, 0)),
        (d.dIdx, (UX, 0, 0)), (d.dIdy, (UY, 0, 0)),
        (d.a_r, (G, -1, 0)), (d.a_r, (G, +1, 0)),
        (d.a_r, (G, 0, -1)), (d.a_r, (G, 0, +1)),
        (d.half_I, (UX, +1, 0)), (neg(d.half_I), (UX, -1, 0)),
        (d.half_I, (UY, 0, +1)), (neg(d.half_I), (UY, 0, -1)),
    ])
    return torch.stack([r_ux, r_uy, r_g], dim=-3)


def el_matvec_df(dfd: ELPairDataDF, x: torch.Tensor) -> torch.Tensor:
    """``A_reduced x`` against the df32 system data (the df32 residual
    with a zero RHS, negated); used only inside refinement, where on the
    card it runs as kernel B4 in operator mode
    (``cuda_kernels.el_matvec_df32``), bit for bit equal to this."""
    zero = torch.zeros_like(dfd.rhs_hi)
    dfd0 = dfd._replace(rhs_hi=zero, rhs_lo=zero)
    return -el_residual_df(dfd0, x, torch.zeros_like(x))
