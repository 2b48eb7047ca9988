"""Tiled matvecs of the sharded solve.

Counterpart of ``opticalflow_tpu.parallel.pallas_spmd``.  There each
device of a (tx, ty) mesh holds one (m/tx, n/ty) tile of the interior
field, exchanges one-pixel halos with its neighbours
(``_exchange_and_extend_u``, ``_exchange_frame``), restores the reduced
system's mirror values at the global edges and corners, and runs the
kernel on its halo-extended block.

Here every tile lies on one device (parallel.mesh), and then the halo
blocks need no exchange: **the blocks that ``_exchange_and_extend_u``
builds are exactly the overlapping (m/tx + 2, n/ty + 2) windows, at
strides (m/tx, n/ty), of ``elop.extend_interior(u)``**.  At a tile seam
the window reaches into the neighbour tile, as the exchanged halo does; at
a global edge it holds the extension's mirror row or column; at a global
corner the extension's doubled diagonal value, which the JAX package
restores by hand.  The blocks of ``_exchange_frame`` are likewise the
windows of the (m+2, n+2) frame itself.  So one application is one
extension, one strided copy of the windows into a leading tile axis, one
launch of kernel B3 over every tile of every pair
(``cuda_kernels.el_matvec_extended``) and one copy back.  The frame
blocks are built once per factory call; the JAX package rebuilds them on
every application only because a factory-time ``shard_map`` does not lower
inside its vmapped loops (``pallas_spmd.py:221-226``).  A halo exchange
between GPUs (peer copies or NCCL) belongs to the later multi-GPU slice.
"""

from __future__ import annotations

from typing import Callable

import torch

from opticalflow_tpu_torch.core import stencils
from opticalflow_tpu_torch.ops import cuda_kernels, elop
from opticalflow_tpu_torch.parallel.mesh import Mesh


def to_tiles(ext: torch.Tensor, tx: int, ty: int) -> torch.Tensor:
    """Overlapping windows of an extended stack (B, *L, m+2, n+2) as
    (B*tx*ty, *L, m/tx + 2, n/ty + 2), tile (p, q) of pair b at b*tx*ty +
    p*ty + q: one strided copy."""
    B, lead = ext.shape[0], tuple(ext.shape[1:-2])
    mt, nt = (ext.shape[-2] - 2) // tx, (ext.shape[-1] - 2) // ty
    windows = ext.unfold(-2, mt + 2, mt).unfold(-2, nt + 2, nt)  # (B, *L, tx, ty, mt+2, nt+2)
    k = len(lead)
    windows = windows.movedim((1 + k, 2 + k), (1, 2))  # (B, tx, ty, *L, mt+2, nt+2)
    return windows.reshape((B * tx * ty,) + lead + (mt + 2, nt + 2))


def from_tiles(y: torch.Tensor, batch: int, tx: int, ty: int) -> torch.Tensor:
    """Inverse layout of :func:`to_tiles` for interior tiles: (B*tx*ty, *L,
    mt, nt) -> (B, *L, tx*mt, ty*nt), one copy."""
    lead, (mt, nt) = tuple(y.shape[1:-2]), y.shape[-2:]
    k = len(lead)
    y = y.reshape((batch, tx, ty) + lead + (mt, nt)).movedim((1, 2), (1 + k, 2 + k))
    return y.transpose(-3, -2).reshape((batch,) + lead + (tx * mt, ty * nt))


def _tiled_operands(mesh, previous_frame, speed_alpha, remodelling_alpha):
    """Frame blocks (B*T, mt+2, nt+2), per-tile scalars (B*T, 2) and the
    tile counts of a batch of normalised frames (B, m+2, n+2); ValueError
    when the interior does not tile evenly (the solver images are
    pre-sized; no implicit padding)."""
    mesh.device()  # one device for every position, or NotImplementedError
    prev = previous_frame
    m, n = prev.shape[-2] - 2, prev.shape[-1] - 2
    tx, ty = mesh.shape["tx"], mesh.shape["ty"]
    if m % tx or n % ty:
        raise ValueError(f"interior {m}x{n} must tile evenly over (tx, ty)=({tx},{ty})")
    scalars = torch.stack([elop.per_pair(speed_alpha, prev),
                           elop.per_pair(remodelling_alpha, prev)], dim=-1)
    I_tiles = to_tiles(prev, tx, ty).contiguous()
    return I_tiles, scalars.repeat_interleave(tx * ty, dim=0).contiguous(), tx, ty


def make_sharded_kernel_matvec(
    mesh: Mesh,
    previous_frame: torch.Tensor,
    speed_alpha,
    remodelling_alpha,
    dy_mode: str = stencils.DY_COMPAT,
) -> Callable:
    """The reduced EL matvec, equal to ``elop.el_matvec_reduced``, applied
    tile by tile over the mesh's (tx, ty) axes through kernel B3.

    ``previous_frame``: the (B, m+2, n+2) normalised frames (as inside
    ``flow.variational.solve_frame_pair``); ``speed_alpha`` /
    ``remodelling_alpha``: scalars or (B,) per pair.  Requires m % tx == 0
    and n % ty == 0.  Returns a matvec on interior stacks (B, 3, m, n) and
    (B, K, 3, m, n).
    """
    I_tiles, scalars, tx, ty = _tiled_operands(mesh, previous_frame, speed_alpha,
                                               remodelling_alpha)
    compat = dy_mode == stencils.DY_COMPAT
    batch = previous_frame.shape[0]

    def matvec(u_int: torch.Tensor) -> torch.Tensor:
        u_tiles = to_tiles(elop.extend_interior(u_int), tx, ty).contiguous()
        y = cuda_kernels.el_matvec_extended(I_tiles, scalars, u_tiles, compat)
        return from_tiles(y, batch, tx, ty)

    return matvec


def make_sharded_xla_matvec(
    mesh: Mesh,
    previous_frame: torch.Tensor,
    speed_alpha,
    remodelling_alpha,
    dy_mode: str = stencils.DY_COMPAT,
) -> Callable:
    """The same tiled matvec as :func:`make_sharded_kernel_matvec` through
    the plain stencil (``elop.interior_apply`` on coefficient planes of the
    frame blocks, built once); the counterpart of the JAX package's
    portable sharded matvec."""
    I_tiles, scalars, tx, ty = _tiled_operands(mesh, previous_frame, speed_alpha,
                                               remodelling_alpha)
    coeffs = elop.compute_coefficients(I_tiles, scalars[:, 0], scalars[:, 1], dy_mode)
    stacked = elop.with_probe_axis(coeffs)  # broadcasts over (B*T, K, 3, mt+2, nt+2)
    batch = previous_frame.shape[0]

    def matvec(u_int: torch.Tensor) -> torch.Tensor:
        u_tiles = to_tiles(elop.extend_interior(u_int), tx, ty)
        y = elop.interior_apply(coeffs if u_int.dim() == 4 else stacked, u_tiles)
        return from_tiles(y, batch, tx, ty)

    return matvec
