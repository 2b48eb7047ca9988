"""Tiled matvecs of the sharded solve.

Counterpart of ``opticalflow_tpu.parallel.pallas_spmd``.  There each
device of a (tx, ty) mesh holds one (m/tx, n/ty) tile of the interior
field, exchanges one-pixel halos with its neighbours
(``_exchange_and_extend_u``, ``_exchange_frame``), restores the reduced
system's mirror values at the global edges and corners, and runs the
kernel on its halo-extended block.  The port has two routes to the same
blocks, and a factory takes one of them by where the tiles lie (the tiles
of the mesh's first frames row; the sharded solve gives each row a factory
of its own):

* **Windows, every tile on one device.**  The blocks that
  ``_exchange_and_extend_u`` builds are exactly the overlapping (m/tx + 2,
  n/ty + 2) windows, at strides (m/tx, n/ty), of
  ``elop.extend_interior(u)``: at a tile seam the window reaches into the
  neighbour tile, as the exchanged halo does; at a global edge it holds the
  extension's mirror row or column; at a global corner the extension's
  doubled diagonal value, which the JAX package restores by hand.  The
  blocks of ``_exchange_frame`` are likewise the windows of the (m+2, n+2)
  frame itself.  Kernel B3 reads those windows where they lie: one
  application is one launch over every tile of every pair
  (``cuda_kernels.el_matvec_tiled`` on the whole interior field), with no
  copy of the field in or out.
* **Exchange, tiles on distinct devices** (or forced with
  ``as_distinct=True``).  One application splits the interior field on the
  home device (the device of tile (0, 0)) into tiles, copies each tile to
  its device, hands the one-pixel seams between neighbours
  (:func:`exchange_halos`, the port of ``pallas_spmd.py:38-104``: columns
  first, then rows, so the corners ride along) as four halo lines per
  tile, and launches B3 once per tile on its device on the tile and its
  lines; each output is written into its window of the result on the home
  device (in place where the tile lies there, else copied back).  The
  Krylov vectors and the V-cycle stay on the home device.  The matvec
  carries ``spans_devices = True``: a CUDA graph of it would span the
  tiles' devices, so the solves on this route keep the eager Krylov loop
  (``flow.variational.solve_frame_pair``), the one route on the card that
  does.

Both routes build the frame blocks once per factory call (the exchange
route through :func:`exchange_frame`, the port of ``pallas_spmd.py:106-
133``); the JAX package rebuilds them on every application only because a
factory-time ``shard_map`` does not lower inside its vmapped loops
(``pallas_spmd.py:221-226``).  The two routes give bitwise equal results:
the same values reach the same per-block arithmetic.
"""

from __future__ import annotations

import threading
from typing import Callable, List

import numpy as np
import torch

from opticalflow_tpu_torch.core import stencils
from opticalflow_tpu_torch.ops import cuda_kernels, elop
from opticalflow_tpu_torch.parallel.mesh import Mesh

Blocks = List[List[torch.Tensor]]  # [p][q]: the block of tile (p, q), on its device

SEAM_COPIES = 0  # seam slices handed to a neighbouring tile by the exchange route
_SEAM_LOCK = threading.Lock()


def _count_seams(n: int) -> None:
    global SEAM_COPIES
    with _SEAM_LOCK:
        SEAM_COPIES += n


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


def edge_halo_1d(blocks: List[torch.Tensor], dim: int, lo_edge: torch.Tensor,
                 hi_edge: torch.Tensor):
    """The +-1 halos of a line of tile blocks along one mesh axis (the port
    of ``pallas_spmd._edge_halo_1d``).

    ``blocks``: the blocks of consecutive positions along the axis, each on
    its own device, tiling tensor dimension ``dim``.  Returns ``(lo, hi)``,
    one slice per block: block i's lo halo is block i-1's last slice along
    ``dim`` and its hi halo block i+1's first slice, each copied to block
    i's device; at the global edges the first block's lo halo is
    ``lo_edge`` and the last block's hi halo ``hi_edge``.
    """
    last = len(blocks) - 1
    lo = [lo_edge if i == 0 else blocks[i - 1].select(dim, -1).to(b.device)
          for i, b in enumerate(blocks)]
    hi = [hi_edge if i == last else blocks[i + 1].select(dim, 0).to(b.device)
          for i, b in enumerate(blocks)]
    _count_seams(2 * last)
    return lo, hi


def _extend_lines(blocks: Blocks, dim: int, edges) -> Blocks:
    """One phase of the exchange: each line of ``blocks`` along mesh axis
    ``dim`` (-1: a row of tiles, the ``ty`` axis; -2: a column, ``tx``)
    extended by its halos along ``dim``; ``edges(k, line)`` gives line k's
    global-edge values ``(lo, hi)``."""
    lines = blocks if dim == -1 else [list(col) for col in zip(*blocks)]
    out = []
    for k, line in enumerate(lines):
        lo, hi = edge_halo_1d(line, dim, *edges(k, line))
        out.append([torch.cat([a.unsqueeze(dim), b, c.unsqueeze(dim)], dim=dim)
                    for a, b, c in zip(lo, line, hi)])
    return out if dim == -1 else [list(row) for row in zip(*out)]


def exchange_halos(tiles: Blocks) -> List[List[tuple]]:
    """The one-pixel halo of every (..., mt, nt) interior tile as four
    lines on the tile's device, ``(top, bottom, left, right)``:
    the rows above and below (..., nt+2), corners included, and the columns
    left and right (..., mt) (the port of
    ``pallas_spmd._exchange_and_extend_u``): neighbour slices at tile seams,
    the reduced system's mirror values at global edges (the extension at -1
    mirrors interior index 1), exactly the four global corners doubled;
    equal to the borders of the tiles' windows of ``elop.extend_interior``
    of the whole field.  The rows are new tensors; a column is a view of
    its tile where it lies on the same device.  Tiles are at least 2 x 2."""
    tx, ty = len(tiles), len(tiles[0])
    # phase 1: columns (the ty axis); a global edge mirrors column 1 / -2
    left, right = zip(*[edge_halo_1d(row, -1, row[0][..., 1], row[-1][..., -2])
                        for row in tiles])

    def ext_row(p, q, i):
        """Row i of tile (p, q) extended by its column halos."""
        return torch.cat([left[p][q][..., i, None], tiles[p][q][..., i, :],
                          right[p][q][..., i, None]], dim=-1)

    # phase 2: rows (the tx axis) of the column-extended tiles, so the
    # corners ride along; a global edge mirrors row 1 / -2
    halos = [[None] * ty for _ in range(tx)]
    for q in range(ty):
        for p in range(tx):
            device = tiles[p][q].device
            top = ext_row(p - 1, q, -1).to(device) if p > 0 else ext_row(p, q, 1)
            bottom = ext_row(p + 1, q, 0).to(device) if p < tx - 1 else ext_row(p, q, -2)
            halos[p][q] = (top, bottom, left[p][q], right[p][q])
        _count_seams(2 * (tx - 1))
    # the two phases put 1x the diagonal value at the global corners,
    # extend_interior 2x
    for p, q, line, j in ((0, 0, 0, 0), (0, -1, 0, -1), (-1, 0, 1, 0), (-1, -1, 1, -1)):
        halos[p][q][line][..., j] *= 2.0
    return halos


def exchange_and_extend_u(tiles: Blocks) -> Blocks:
    """The (..., mt+2, nt+2) extension of every (..., mt, nt) interior tile
    by its :func:`exchange_halos` lines (the JAX package's block form,
    which the plain-stencil route takes); equal to the tiles' windows of
    ``elop.extend_interior`` of the whole field."""
    blocks = [[None] * len(row) for row in tiles]
    for p, row in enumerate(exchange_halos(tiles)):
        for q, (top, bottom, left, right) in enumerate(row):
            mid = torch.cat([left[..., None], tiles[p][q], right[..., None]], dim=-1)
            blocks[p][q] = torch.cat([top[..., None, :], mid, bottom[..., None, :]], dim=-2)
    return blocks


def exchange_frame(i_tiles: Blocks, top: torch.Tensor, bottom: torch.Tensor,
                   left: torch.Tensor, right: torch.Tensor) -> Blocks:
    """The (B, mt+2, nt+2) blocks of the true frame around every (B, mt, nt)
    interior tile (the port of ``pallas_spmd._exchange_frame``): halos from
    the neighbour tiles inside the image, the frame's own boundary rows
    ``top`` / ``bottom`` (B, n+2) and columns ``left`` / ``right`` (B, m+2)
    at global edges."""
    mt, nt = i_tiles[0][0].shape[-2:]

    def col_edges(p, line):  # frame columns 0 / n+1 of tile row p
        rows = slice(1 + p * mt, 1 + (p + 1) * mt)
        return left[:, rows].to(line[0].device), right[:, rows].to(line[-1].device)

    def row_edges(q, line):  # frame rows 0 / m+1 over tile column q and its halo columns
        cols = slice(q * nt, (q + 1) * nt + 2)
        return top[:, cols].to(line[0].device), bottom[:, cols].to(line[-1].device)

    return _extend_lines(_extend_lines(i_tiles, -1, col_edges), -2, row_edges)


def split_tiles(field: torch.Tensor, devices) -> Blocks:
    """The (..., m/tx, n/ty) tiles of ``field`` (..., m, n), tile (p, q)
    copied to ``devices[p, q]`` (a (tx, ty) array)."""
    tx, ty = devices.shape
    mt, nt = field.shape[-2] // tx, field.shape[-1] // ty
    return [[field[..., p * mt : (p + 1) * mt, q * nt : (q + 1) * nt].to(devices[p, q])
             for q in range(ty)] for p in range(tx)]


def assemble_tiles(blocks: Blocks, device: torch.device) -> torch.Tensor:
    """Inverse of :func:`split_tiles`: the tiles copied to ``device`` and
    joined."""
    return torch.cat([torch.cat([b.to(device) for b in row], dim=-1) for row in blocks], dim=-2)


def _tile_counts(mesh: Mesh, previous_frame: torch.Tensor):
    """(tx, ty) of ``mesh``, or ValueError when the interior of the frames
    (B, m+2, n+2) does not tile evenly (the solver images are pre-sized; no
    implicit padding)."""
    m, n = previous_frame.shape[-2] - 2, previous_frame.shape[-1] - 2
    tx, ty = mesh.shape["tx"], mesh.shape["ty"]
    if m % tx or n % ty:
        raise ValueError(f"interior {m}x{n} must tile evenly over (tx, ty)=({tx},{ty})")
    return tx, ty


def _pair_scalars(previous_frame, speed_alpha, remodelling_alpha) -> torch.Tensor:
    """(B, 2) per-pair (alpha_s, alpha_r)."""
    return torch.stack([elop.per_pair(speed_alpha, previous_frame),
                        elop.per_pair(remodelling_alpha, previous_frame)], dim=-1)


def _tiled_operands(mesh, previous_frame, speed_alpha, remodelling_alpha):
    """The windows route's frame blocks (B*T, mt+2, nt+2), per-tile scalars
    (B*T, 2) and tile counts of a batch of normalised frames (B, m+2,
    n+2)."""
    tx, ty = _tile_counts(mesh, previous_frame)
    scalars = _pair_scalars(previous_frame, speed_alpha, remodelling_alpha)
    I_tiles = to_tiles(previous_frame, tx, ty).contiguous()
    return I_tiles, scalars.repeat_interleave(tx * ty, dim=0).contiguous(), tx, ty


def _exchange_operands(mesh, previous_frame, speed_alpha, remodelling_alpha):
    """The exchange route's operands on the devices of the mesh's first
    frames row (a (tx, ty) array): the frame blocks (B, mt+2, nt+2) and the
    (B, 2) scalars of every tile, on its device."""
    _tile_counts(mesh, previous_frame)
    devices = mesh.devices[0]
    m, n = previous_frame.shape[-2] - 2, previous_frame.shape[-1] - 2
    if m // devices.shape[0] < 2 or n // devices.shape[1] < 2:
        raise ValueError(f"the exchange route needs tiles of at least 2x2, got "
                         f"{m // devices.shape[0]}x{n // devices.shape[1]}")
    prev = previous_frame
    blocks = exchange_frame(split_tiles(prev[:, 1:-1, 1:-1], devices), prev[:, 0], prev[:, -1],
                            prev[:, :, 0], prev[:, :, -1])
    scalars = _pair_scalars(prev, speed_alpha, remodelling_alpha).contiguous()
    tile_scalars = [[scalars.to(d) for d in row] for row in devices]
    return devices, blocks, tile_scalars


def exchange_route(mesh: Mesh, as_distinct: bool = False) -> bool:
    """Whether the factories take the exchange route on ``mesh``: it tiles
    the image, and the tiles of its first frames row lie on distinct
    devices or ``as_distinct`` forces the route.  A mesh of one tile has no
    seams and takes the windows route."""
    return mesh.shape["tx"] * mesh.shape["ty"] > 1 and (as_distinct or mesh.row(0).distinct)


def make_sharded_kernel_matvec(
    mesh: Mesh,
    previous_frame: torch.Tensor,
    speed_alpha,
    remodelling_alpha,
    dy_mode: str = stencils.DY_COMPAT,
    as_distinct: bool = False,
) -> Callable:
    """The reduced EL matvec, equal to ``elop.el_matvec_reduced``, applied
    tile by tile over the mesh's (tx, ty) axes through kernel B3.

    ``previous_frame``: the (B, m+2, n+2) normalised frames (as inside
    ``flow.variational.solve_frame_pair``), on the device of tile (0, 0);
    ``speed_alpha`` / ``remodelling_alpha``: scalars or (B,) per pair.
    Requires m % tx == 0 and n % ty == 0.  Tiles on one device take the
    windows route (one B3 launch over every tile), tiles on distinct
    devices, or any tiles with ``as_distinct=True``, the exchange route (one
    B3 launch per tile, on its device; :func:`exchange_route` decides).  Returns a matvec on interior stacks
    (B, 3, m, n) and (B, K, 3, m, n) on the device of tile (0, 0).
    """
    compat = dy_mode == stencils.DY_COMPAT
    if exchange_route(mesh, as_distinct):
        devices, blocks, scalars = _exchange_operands(mesh, previous_frame, speed_alpha,
                                                      remodelling_alpha)
        home = previous_frame.device

        def exchange_matvec(u_int: torch.Tensor) -> torch.Tensor:
            u_int = u_int.contiguous()
            tiles = split_tiles(u_int, devices)
            halos = exchange_halos(tiles)
            out = torch.empty_like(u_int)
            mt, nt = tiles[0][0].shape[-2:]
            for p, q in np.ndindex(devices.shape):
                window = out[..., p * mt : (p + 1) * mt, q * nt : (q + 1) * nt]
                here = devices[p, q] == home  # the tile's output goes straight into out
                y = cuda_kernels.el_matvec_tiled(blocks[p][q], scalars[p][q], tiles[p][q],
                                                 compat, halo=halos[p][q],
                                                 out=window if here else None)
                if not here:
                    window.copy_(y)
            return out

        exchange_matvec.spans_devices = True
        return exchange_matvec

    I_tiles, scalars, tx, ty = _tiled_operands(mesh, previous_frame, speed_alpha,
                                               remodelling_alpha)

    def matvec(u_int: torch.Tensor) -> torch.Tensor:
        return cuda_kernels.el_matvec_tiled(I_tiles, scalars, u_int.contiguous(), compat,
                                            (tx, ty))

    return matvec


def make_sharded_xla_matvec(
    mesh: Mesh,
    previous_frame: torch.Tensor,
    speed_alpha,
    remodelling_alpha,
    dy_mode: str = stencils.DY_COMPAT,
    as_distinct: bool = False,
) -> Callable:
    """The same tiled matvec as :func:`make_sharded_kernel_matvec`, by the
    same routes, through the plain stencil (``elop.interior_apply`` on
    coefficient planes of the frame blocks, built once); the counterpart of
    the JAX package's portable sharded matvec."""
    if exchange_route(mesh, as_distinct):
        devices, blocks, scalars = _exchange_operands(mesh, previous_frame, speed_alpha,
                                                      remodelling_alpha)
        coeffs = [[elop.compute_coefficients(I, s[:, 0], s[:, 1], dy_mode)
                   for I, s in zip(*row)] for row in zip(blocks, scalars)]
        stacked = [[elop.with_probe_axis(c) for c in row] for row in coeffs]
        home = previous_frame.device

        def exchange_matvec(u_int: torch.Tensor) -> torch.Tensor:
            u_ext = exchange_and_extend_u(split_tiles(u_int, devices))
            planes = coeffs if u_int.dim() == 4 else stacked
            return assemble_tiles([[elop.interior_apply(c, u) for c, u in zip(*row)]
                                   for row in zip(planes, u_ext)], home)

        exchange_matvec.spans_devices = True
        return exchange_matvec

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
