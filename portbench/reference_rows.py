"""The float64 reference of ``reference.py`` at frames too large for its memory.

``reference.solve`` keeps the gain of every grid row for the way back: m
blocks of (3n)^2 float64s a pair, 76.9 GB at a 1022^2 interior.  This copy
keeps the gain of the last row of every segment of ``segment`` rows and
recomputes one segment's gains at a time on the way back, from the
checkpoint before it: about ``m / segment + segment`` blocks alive at once
(2 sqrt(m) at the default segment of ceil(sqrt(m)) rows, ~4.8 GB a pair at
1022^2), for twice the forward work.  Each recomputed gain is solved
exactly as the forward pass solved it (the same right-hand sides, the
same order), so the solution is ``reference.solve``'s bit for bit.

The system, its blocks and their band products are ``reference.py``'s
own (``pair_system``, ``_row_blocks``, ``_band``, ``_band_mul``).  It
imports nothing of the program under test.  Plain torch, float64.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from portbench.reference import _band, _band_mul, _row_blocks, embed, pair_system


def _row_gain(stencil, b, i, n, gain_prev, z_prev):
    """Row ``i``'s gain (B, 3n, 3n) and its z (B, 3n): the solve of the
    row's Schur complement against [U, y], as ``reference.solve`` takes it,
    a pair at a time (a batch of large systems would go to batched routines
    made for small ones).  z is copied out of the solve, whose storage the
    gain keeps: a view would hold every row's solve alive."""
    blocks = _row_blocks(stencil, i)
    D, U = blocks[0], blocks[1]
    if i == 0:
        S, y = D, b[:, 0]
    else:
        L = _band(blocks[-1], n)
        S = D - _band_mul(L, gain_prev)
        y = b[:, i] - _band_mul(L, z_prev[..., None])[..., 0]
    rhs = torch.cat([U, y[..., None]], dim=-1)
    sol = torch.stack([torch.linalg.solve(S[k], rhs[k]) for k in range(S.shape[0])])
    return sol[..., :-1], sol[..., -1].clone()


def solve(stencil: torch.Tensor, rhs: torch.Tensor, segment: Optional[int] = None,
          stats: Optional[dict] = None) -> torch.Tensor:
    """The exact solution (B, 3, m, n) of the reduced system, by block
    Thomas over rows with the gains checkpointed every ``segment`` rows
    (``ceil(sqrt(m))`` when None).  ``stats``, when given, receives
    ``gains_alive``: the most gain blocks held at once."""
    B, _, m, n = rhs.shape
    k = math.isqrt(m - 1) + 1 if segment is None else int(segment)
    if k < 1:
        raise ValueError(f"segment must be at least 1, got {k}")
    b = rhs.permute(0, 2, 1, 3).reshape(B, m, 3 * n)
    most = 0
    # forward: every z, and the gain of each segment's last row
    zs, checkpoints, gain = [], {}, None
    for i in range(m):
        gain, z = _row_gain(stencil, b, i, n, gain, zs[-1] if zs else None)
        # the checkpoints, the row before (when not one) and this row's
        most = max(most, len(checkpoints) + (i > 0 and (i - 1) not in checkpoints) + 1)
        zs.append(z)
        if i % k == k - 1 or i == m - 1:
            checkpoints[i] = gain
    gain = None
    # back, a segment at a time, its gains recomputed from the checkpoint
    # before it (its last row's is a checkpoint itself)
    x = [None] * m
    x[m - 1] = zs[m - 1]
    for start in range(((m - 1) // k) * k, -1, -k):
        end = min(start + k, m)
        gains, prev = [], checkpoints.get(start - 1)
        for i in range(start, end - 1):
            prev, _ = _row_gain(stencil, b, i, n, prev, zs[i - 1] if i else None)
            gains.append(prev)
            most = max(most, len(checkpoints) + len(gains))
        gains.append(checkpoints.pop(end - 1))
        for i in range(end - 1, start - 1, -1):
            if i < m - 1:
                x[i] = zs[i] - (gains[i - start] @ x[i + 1][..., None])[..., 0]
        del gains
    if stats is not None:
        stats["gains_alive"] = most
    return torch.stack(x, dim=1).reshape(B, m, 3, n).permute(0, 2, 1, 3)


def pair_bytes(m: int, n: int) -> int:
    """Device bytes one pair takes in :func:`movie_fields` at the default
    segment: its stencil, its gains alive at once and a row's blocks."""
    k = math.isqrt(m - 1) + 1
    block = (3 * n) ** 2 * 8
    return 81 * m * n * 8 + (2 * k + 1) * block + 6 * block


def movie_fields(prev, cur, alpha_s, alpha_r, compat: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference (B, 2, Ni, Nj) velocity in pixels a frame and (B, Ni, Nj)
    remodelling in the frames' units: ``reference.movie_fields``' contract."""
    st, rhs, s, _ = pair_system(prev, cur, alpha_s, alpha_r, compat)
    x = solve(st, rhs)
    del st, rhs
    u = embed(x)
    return u[:, :2], u[:, 2] * s[:, None, None]
