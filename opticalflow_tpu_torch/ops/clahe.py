"""CLAHE (contrast-limited adaptive histogram equalisation).

Counterpart of ``opticalflow_tpu.ops.clahe``: the reference runs cv2's
CLAHE on uint16 frames with a tile grid scaled by the image's aspect
ratio.  The standard pipeline on every frame at once: per-tile histograms
(one ``bincount`` over (frame, tile, bin)), clip-limit redistribution,
per-tile CDF lookup tables, and bilinear interpolation of the four
surrounding tiles' mappings per pixel.  cv2 parity is statistical, not
bitwise, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from opticalflow_tpu_torch.utils.device import resolve_device


def _clahe_frames(frames, clip_limit: float, tiles_x: int, tiles_y: int, n_bins: int,
                  max_value: float):
    """CLAHE of (T, ni, nj) float32 frames holding uint16 values."""
    T, ni, nj = frames.shape
    dev = frames.device
    # pad to a multiple of the tile grid, reflected without repeating the
    # edge (reflect-101, like cv2 and jnp.pad's 'reflect')
    th = -(-ni // tiles_x)
    tw = -(-nj // tiles_y)
    rows = torch.as_tensor(np.pad(np.arange(ni), (0, th * tiles_x - ni), mode="reflect"),
                           device=dev)
    cols = torch.as_tensor(np.pad(np.arange(nj), (0, tw * tiles_y - nj), mode="reflect"),
                           device=dev)
    fp = frames[:, rows][:, :, cols]

    # bin index per pixel (float32 product, truncated toward zero)
    bins = torch.clamp((fp * ((n_bins - 1) / max_value)).to(torch.int64), 0, n_bins - 1)

    # per-tile histograms of every frame: one bincount on (frame, tile, bin)
    n_tiles = tiles_x * tiles_y
    ti = torch.arange(th * tiles_x, device=dev) // th
    tj = torch.arange(tw * tiles_y, device=dev) // tw
    tile_id = ti[:, None] * tiles_y + tj[None, :]
    frame_tiles = torch.arange(T, device=dev)[:, None, None] * n_tiles + tile_id
    hist = torch.bincount((frame_tiles * n_bins + bins).flatten(),
                          minlength=T * n_tiles * n_bins).to(torch.float32)
    hist = hist.reshape(T, n_tiles, n_bins)

    # clip + redistribute (cv2: clip value = clipLimit * tileArea / histSize,
    # floored at 1), in float32 as the JAX package computes it
    tile_area = th * tw
    clip = torch.clamp(torch.tensor(clip_limit, dtype=torch.float32, device=dev) * tile_area
                       / n_bins, min=1.0)
    excess = torch.clamp(hist - clip, min=0.0).sum(-1, keepdim=True)
    hist = torch.minimum(hist, clip) + excess / n_bins

    # LUT per tile: the scaled CDF
    cdf = torch.cumsum(hist, dim=-1)
    luts = ((cdf - cdf[..., :1]) / torch.clamp(tile_area - cdf[..., :1], min=1.0)
            * max_value).clamp(0.0, max_value)  # (T, n_tiles, n_bins)

    # bilinear interpolation between the 4 surrounding tile LUTs
    def axis_weights(n_pix, tile, n_tile):
        c = (torch.arange(n_pix, device=dev, dtype=torch.float32) + 0.5) / tile - 0.5
        i0 = torch.clamp(torch.floor(c).to(torch.int64), 0, n_tile - 1)
        i1 = torch.clamp(i0 + 1, 0, n_tile - 1)
        w = torch.clamp(c - torch.floor(c), 0.0, 1.0)
        w = torch.where(c < 0, 0.0, torch.where(c > n_tile - 1, 1.0, w))
        return i0, i1, w

    i0, i1, wi = axis_weights(th * tiles_x, th, tiles_x)
    j0, j1, wj = axis_weights(tw * tiles_y, tw, tiles_y)
    flat_luts = luts.flatten()
    frame_base = torch.arange(T, device=dev)[:, None, None] * n_tiles

    def lookup(ti_idx, tj_idx):
        ids = frame_base + ti_idx[:, None] * tiles_y + tj_idx[None, :]
        return flat_luts[ids * n_bins + bins]

    wi2 = wi[:, None]
    wj2 = wj[None, :]
    out = ((1 - wi2) * ((1 - wj2) * lookup(i0, j0) + wj2 * lookup(i0, j1))
           + wi2 * ((1 - wj2) * lookup(i1, j0) + wj2 * lookup(i1, j1)))
    return out[:, :ni, :nj]


def apply_clahe(movie, clipLimit: float = 50000, tile_number: int = 10,
                n_bins: int = 4096, device=None) -> torch.Tensor:
    """CLAHE on every frame of a (T, X, Y) movie: frames are treated as
    uint16 data (truncated toward zero and saturated at 0 and 65535); the
    tile grid in the second image axis is scaled by the aspect ratio so
    tiles stay about square.  Runs on ``device`` (``None``: the CUDA device,
    which must exist; ``'cpu'``: the CPU); returns a float32 tensor there."""
    movie = torch.as_tensor(movie).to(resolve_device(device))
    converted = torch.trunc(movie.to(torch.float64)).clamp(0, 65535).to(torch.float32)
    aspect = movie.shape[2] / movie.shape[1]
    tiles_x = int(tile_number)
    tiles_y = int(round(tile_number * aspect))
    return _clahe_frames(converted, float(clipLimit), tiles_x, tiles_y, int(n_bins), 65535.0)
