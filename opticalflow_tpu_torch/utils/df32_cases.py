"""Operands of kernel B4 (``csrc/el_df32.cu``) for its checks and timings
on the card (chip_smoke.py phase 3, :mod:`kernel_ab`, the card tests):

* :func:`pack_pairs`: the operands as the refinement packs them, from raw
  frames and per-pair alphas;
* :func:`blob_operands`: those of a moving blob at one path shape (the
  sweep's shape, 150 cells of one pair, with the sweep's alphas);
* :func:`adversarial_operands`: operands made to catch a kernel that is
  not its plain version bit for bit: signed zeros in every tensor, heads of
  mixed exponents (2^-60 to 2^61), low parts subnormal here and there; with
  ``overflow``, some field heads of 2^126 whose Dekker split overflows, so
  that NaN reaches the outputs.

The work B4 does at a shape is :func:`cuda_timing.df32_work`.
"""

from __future__ import annotations

import numpy as np
import torch

from opticalflow_tpu_torch.ops import cuda_kernels as ck
from opticalflow_tpu_torch.ops import elop


def pack_pairs(prev, cur, alphas, dy_mode: str, device) -> ck.DF32Operands:
    """B4's operands as the refinement packs them: the df32 data of raw
    frames (B, m+2, n+2) and raw per-pair (alpha_s, alpha_r) (B, 2)."""
    prev = torch.as_tensor(prev, dtype=torch.float32).to(device)
    cur = torch.as_tensor(cur, dtype=torch.float32).to(device)
    alphas = torch.as_tensor(alphas, dtype=torch.float32).to(device)
    scale = prev.flatten(1).amax(1)
    return ck.pack_df32(elop.compute_frame_pair_data_df(prev, cur, alphas[:, 0], alphas[:, 1],
                                                        dy_mode, scale))


def sweep_alphas(cells: int) -> np.ndarray:
    """The first ``cells`` (alpha_s, alpha_r) of the sweep's grid."""
    from opticalflow_tpu_torch.utils.sweep_chunks import REMODELLING_ALPHAS, SPEED_ALPHAS

    return np.array([[a, b] for a in SPEED_ALPHAS for b in REMODELLING_ALPHAS][:cells])


def blob_operands(pairs: int, m: int, dy_mode: str, device, seed: int = 7):
    """(ops, x_hi, x_lo) at B4's path shape ``pairs`` x m x m: a moving
    blob (width 20 (m+2) / 256, sigma 3, v = (0.15, 0.1), x100) at alpha
    1000, or at ``pairs`` = 150 the sweep's chunk, one pair for every cell
    with the sweep's alphas; random fields, x_lo ~1e-8 of x_hi."""
    from opticalflow_tpu_torch.core.synth import make_translating_blob_movie

    sweep = pairs == 150
    movie, _ = make_translating_blob_movie(n_frames=2 if sweep else pairs + 1, dimension=m + 2,
                                           width=20.0 * (m + 2) / 256, sigma=3.0, v_x=0.15,
                                           v_y=0.1)
    movie = (movie * 100.0).astype(np.float32)
    if sweep:
        prev, cur = np.repeat(movie[:1], pairs, axis=0), np.repeat(movie[1:], pairs, axis=0)
        alphas = sweep_alphas(pairs)
    else:
        prev, cur, alphas = movie[:-1], movie[1:], np.full((pairs, 2), 1000.0)
    ops = pack_pairs(prev, cur, alphas, dy_mode, device)
    gen = torch.Generator(device).manual_seed(seed)
    x_hi = torch.randn((pairs, 3, m, m), device=device, generator=gen)
    x_lo = x_hi * 1e-8 * torch.randn((pairs, 3, m, m), device=device, generator=gen)
    return ops, x_hi, x_lo


def adversarial_operands(B: int, m: int, n: int, P: int, seed: int, device,
                         overflow: bool = False):
    """(ops, x_hi, x_lo) of B pairs of (m, n) with P = 24 or 26 planes, made
    from ``seed``: heads sign x [1, 2) x 2^e, e uniform in [-60, 60], a
    tenth of them signed zeros; low parts ~2^-25 of their head, a tenth
    subnormal (|lo| < 2^-127) and a tenth signed zeros.  No product, sum
    or split overflows, unless ``overflow`` puts 2^126 into one field
    value in fifty."""
    rng = np.random.default_rng(seed)

    def signs(shape):
        return rng.choice(np.array([-1.0, 1.0]), size=shape)

    def heads(shape):
        v = np.ldexp(rng.uniform(1.0, 2.0, shape), rng.integers(-60, 61, shape)) * signs(shape)
        zero = rng.random(shape) < 0.1
        v[zero] = 0.0 * signs(int(zero.sum()))
        return v.astype(np.float32)

    def tails(hi):
        lo = hi.astype(np.float64) * np.ldexp(rng.uniform(-1.0, 1.0, hi.shape), -25)
        kind = rng.random(hi.shape)
        sub = kind < 0.1
        lo[sub] = np.ldexp(rng.uniform(-1.0, 1.0, int(sub.sum())), -127)
        zero = kind > 0.9
        lo[zero] = 0.0 * signs(int(zero.sum()))
        return lo.astype(np.float32)

    planes = np.empty((B, P, m, n), np.float32)
    planes[:, 0::2] = heads((B, P // 2, m, n))
    planes[:, 1::2] = tails(planes[:, 0::2])
    scalars = np.empty((B, 6), np.float32)
    scalars[:, 0::2] = heads((B, 3))
    scalars[:, 1::2] = tails(scalars[:, 0::2])
    rhs_hi = heads((B, 3, m, n))
    x_hi = heads((B, 3, m, n))
    if overflow:
        big = rng.random(x_hi.shape) < 0.02
        x_hi[big] = np.float32(2.0**126) * signs(int(big.sum()))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    ops = ck.DF32Operands(t(planes), t(scalars), t(rhs_hi), t(tails(rhs_hi)))
    return ops, t(x_hi), t(tails(x_hi))


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values and equal bits (signed zeros, NaN)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))
