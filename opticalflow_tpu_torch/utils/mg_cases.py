"""Cases of kernels B5 and B6 (``csrc/mg_smooth.cu``, ``csrc/mg_transfer.cu``)
for their checks and timings on the card (chip_smoke.py phase 3):

* :func:`level_shapes`: the grids of a hierarchy, as ``multigrid.setup``
  halves them;
* :data:`PATHS`: each path's pairs and fine interior, and :func:`path_cases`
  the launches its V-cycle makes: at level 0 the epilogue after the fine
  matvec, the zero guess, the residual-and-restrict of the matvec's output
  and the prolong-and-add; at each probed level the zero guess, the
  sweep-residual-restrict, the prolong-add-sweep and the sweep;
  :func:`transfer_cases` every B6 instance at a path's level 0 and level 1
  (K = 1), and :func:`probe_cases` the setup's transfers at K = 27;
* :func:`operands`: the wrapper, its plain version and random operands of
  one case (signed zeros among the field values);
* :func:`library_call`: the one PyTorch call that computes the same
  function as a B6 instance, where there is one: R y (``F.conv2d`` with
  the bilinear kernel) and P e (``F.conv_transpose2d``); the port never
  calls it.

The work of one call of a case is :func:`cuda_timing.mg_work` of it.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from opticalflow_tpu_torch.ops import cuda_kernels as ck

# each path's (pairs, fine interior): the 256x256 bench's 11 pairs batched,
# the sweep's chunk of 150 cells of 126x126, the command line's and the
# 1024x1024 pair one at a time
PATHS = {"bench": (11, 254, 254), "sweep": (150, 126, 126), "cli": (1, 510, 510),
         "1024": (1, 1022, 1022)}
# the probed levels each path's cases cover (the smaller ones of the CLI and
# the 1024x1024 pair are the other paths' shapes at fewer pairs)
PROBED_LEVELS = {"bench": 4, "sweep": 3, "cli": 2, "1024": 2}
DAMP = 0.7

# kernel of each kind
KINDS = {"sweep": "B5", "zero guess": "B5", "fine": "B5", "apply": "B5",
         "residual-restrict": "B6", "restrict y": "B6", "restrict b - y": "B6",
         "restrict S x": "B6", "prolong-add": "B6", "prolong": "B6",
         "sweep-residual-restrict": "B6", "prolong-add-sweep": "B6"}
# the kinds that sweep, at K = 1 only
SWEEPS = ("sweep", "zero guess", "fine", "sweep-residual-restrict", "prolong-add-sweep")
# the PyTorch call that computes the same function, by kind
LIBRARY = {"restrict y": "conv2d", "prolong": "conv_transpose2d"}


class Case(NamedTuple):
    kind: str  # a key of KINDS
    B: int
    K: int
    M: int  # the fine grid (B6) or the level's grid (B5)
    N: int


def level_shapes(m: int, n: int, min_size: int = 8) -> List[Tuple[int, int]]:
    """The grids of a hierarchy on an (m, n) interior, finest first, as
    ``multigrid.setup`` halves them (ceil) while the shorter side is above
    ``min_size``."""
    shapes = [(m, n)]
    while min(m, n) > min_size:
        m, n = (m + 1) // 2, (n + 1) // 2
        shapes.append((m, n))
    return shapes


def path_cases(path: str) -> List[Case]:
    """The V-cycle's B5 and B6 launches on ``path``'s level 0 and its first
    PROBED_LEVELS probed levels (the coarsest, an LU solve, excluded)."""
    B, m, n = PATHS[path]
    shapes = level_shapes(m, n)
    cases = [Case(kind, B, 1, *shapes[0]) for kind in
             ("fine", "zero guess", "restrict b - y", "prolong-add")]
    for M, N in shapes[1:-1][: PROBED_LEVELS[path]]:
        cases += [Case(kind, B, 1, M, N) for kind in
                  ("zero guess", "sweep-residual-restrict", "prolong-add-sweep", "sweep")]
    return cases


def transfer_cases(path: str) -> List[Case]:
    """Every B6 instance, the six standalone and the two fused, at
    ``path``'s level 0 and level 1 (pairs as the path's, K = 1)."""
    B, m, n = PATHS[path]
    return [Case(kind, B, 1, M, N) for M, N in level_shapes(m, n)[:2]
            for kind, label in KINDS.items() if label == "B6"]


def probe_cases(path: str) -> List[Case]:
    """The transfers of ``path``'s setup probes (K = 27): R y of the fine
    matvec's output and P e at level 0, P e and R (S x) at level 1."""
    B, m, n = PATHS[path]
    (m0, n0), (m1, n1) = level_shapes(m, n)[:2]
    return [Case("restrict y", B, 27, m0, n0), Case("prolong", B, 27, m0, n0),
            Case("prolong", B, 27, m1, n1), Case("restrict S x", B, 27, m1, n1)]


def operands(case: Case, device, seed: int):
    """(wrapper, plain version, arguments) of one case on random operands:
    a level's S and block inverse and (B, [K,] 3, M, N) fields, every
    seventh value of each field -0 and every eleventh +0."""
    kind, B, K, M, N = case
    gen = torch.Generator(device).manual_seed(seed)
    lead = (B,) if K == 1 else (B, K)

    def field(shape):
        t = torch.randn(lead + (3,) + shape, device=device, generator=gen)
        t.view(-1)[::7] = -0.0
        t.view(-1)[3::11] = 0.0
        return t

    coarse = ((M + 1) // 2, (N + 1) // 2)
    S = torch.randn((B, 3, 3, 3, 3, M, N), device=device, generator=gen)
    binv = torch.randn((B, 3, 3, M, N), device=device, generator=gen)
    x, b = field((M, N)), field((M, N))
    table = {
        "sweep": (ck.mg_smooth, ck.mg_smooth_ref, (S, binv, x, b, DAMP)),
        "zero guess": (ck.mg_smooth, ck.mg_smooth_ref, (None, binv, None, b, DAMP)),
        "fine": (ck.mg_smooth_fine, ck.mg_smooth_fine_ref, (binv, x, b, field((M, N)), DAMP)),
        "apply": (ck.mg_stencil_apply, ck.mg_stencil_apply_ref, (S, x)),
        "residual-restrict": (ck.mg_residual_restrict, ck.mg_residual_restrict_ref,
                              (S, x, b, None, coarse)),
        "restrict b - y": (ck.mg_residual_restrict, ck.mg_residual_restrict_ref,
                           (None, None, b, x, coarse)),
        "restrict y": (ck.mg_residual_restrict, ck.mg_residual_restrict_ref,
                       (None, None, None, x, coarse)),
        "restrict S x": (ck.mg_residual_restrict, ck.mg_residual_restrict_ref,
                         (S, x, None, None, coarse)),
        "prolong-add": (ck.mg_prolong_add, ck.mg_prolong_add_ref, (x, field(coarse), (M, N))),
        "prolong": (ck.mg_prolong_add, ck.mg_prolong_add_ref, (None, field(coarse), (M, N))),
        "sweep-residual-restrict": (ck.mg_smooth_restrict, ck.mg_smooth_restrict_ref,
                                    (S, binv, x, b, DAMP, coarse)),
        "prolong-add-sweep": (ck.mg_prolong_smooth, ck.mg_prolong_smooth_ref,
                              (S, binv, x, field(coarse), b, DAMP)),
    }
    return table[kind]


def library_call(case: Case, args) -> Optional[Callable[[], torch.Tensor]]:
    """The one PyTorch call that computes the same function as a B6 case,
    on the same field: R y as a convolution with the [0.5, 1, 0.5] x [0.5,
    1, 0.5] kernel, stride 2, padding 1, and P e as the transposed one;
    None for every other kind, which no single call computes (a residual, a
    sum or a sweep besides the transfer).  Run it under
    ``torch.backends.cudnn.allow_tf32 = False``."""
    kind, B, K, M, N = case
    if kind not in LIBRARY:
        return None
    field = args[1] if kind == "prolong" else args[3]
    line = torch.tensor([0.5, 1.0, 0.5], device=field.device)
    weight = (line[:, None] * line[None, :])[None, None]
    planes = field.reshape(-1, 1, *field.shape[-2:])
    if kind == "prolong":
        pad = (M + 1) % 2, (N + 1) % 2  # an even fine side is one longer than 2 Mc - 1
        return lambda: F.conv_transpose2d(planes, weight, stride=2, padding=1, output_padding=pad)
    return lambda: F.conv2d(planes, weight, stride=2, padding=1)
