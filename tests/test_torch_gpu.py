"""Tests of the port that need a CUDA device; they skip without one.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_gpu.py -q --noconftest

(``--noconftest`` skips tests/conftest.py, which configures JAX.)

Tolerances: a kernel and its plain version are both float32 on the same
card and differ only by rounding (multiply-add contraction and summation
order), a few ulps of the largest term: each field is held to
``max|a - b| <= 1e-5 * max|b|``; so is the hybrid matvec (plain-stencil
kernel plus the boundary ring) against the fused kernel's plain version.
Kernel B3 (``el_matvec_tiled``, and ``el_matvec_extended`` on
pre-extended blocks) and the tiled matvec of the sharded solve are held to
the same bound, against B3's plain versions and B1's; B3 in place and out
of place, and on the whole field against its blocks cut out, bitwise.
The solve on the card and the same solve on the CPU converge to the same
system to within the refinement exit (0.1 x tol), far inside 1e-4 px;
measured on the CPU the port and the JAX package agree to ~1e-5 px at this
size.  A small batched sweep on the card launches B1 with no plain call and
matches the CPU's sweep to 1e-4 relative; box flow on the card is held to
the CPU's own float32 accuracy against the CPU's float64 run.  The routes
of meshes over distinct devices, forced on the one card, and the meshes
over two GPUs (which skip on a machine with one) are held bitwise against
the one-device routes: the same per-block arithmetic.  Kernel B4 (the df32
residual and operator, built without contraction into fused multiply-adds)
is held to its plain version bit for bit: values and bits, signed zeros
included; so are the multigrid's kernels B5 and B6 (built the same way;
B6's six standalone instances and two fused stages at every level shape of
every path), and a hierarchy set up and applied through them equals the
same hierarchy through the plain stages bit for bit.  The card sweep
refines to 0.01 x tol (see its docstring).
"""

import numpy as np
import pytest
import torch

from opticalflow_tpu_torch import SolverConfig, variational_optical_flow
from opticalflow_tpu_torch.core import stencils
from opticalflow_tpu_torch.core.synth import make_translating_blob_movie
from opticalflow_tpu_torch.ops import cuda_kernels as ck
from opticalflow_tpu_torch.ops import elop

ALPHAS = [(0.08, 900.0), (0.1, 1000.0), (0.005, 3000.0)]  # normalised (alpha_s, alpha_r)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _assert_fields_close(y, y_ref):
    for q in range(3):
        err = (y[..., q, :, :] - y_ref[..., q, :, :]).abs().max().item()
        assert err <= 1e-5 * y_ref[..., q, :, :].abs().max().item(), (q, err)


def _frames(m, n, batch):
    movie, _ = make_translating_blob_movie(
        n_frames=batch, dimension=max(m, n) + 2, width=10.0, sigma=3.0, v_x=0.2, v_y=0.1)
    return np.ascontiguousarray(movie[:, : m + 2, : n + 2], dtype=np.float32)


# (pairs, (m, n), K) of kernel B1's cases: the bench's 254², the 1024²
# pair's 1022², ragged, the 3x3 minimum; the command line's 1 x 510² (K = 1
# and the probes' 27) and the sweep's chunk of 150 x 126²; widths n = 0, 1
# and 3 mod 4 (the staging's alignment; every path's n is 2 mod 4); an
# interior shorter than a thread's 4-row strip; one tile holding both
# mirror folds of both axes (32x16 at K = 1, 32x32 at K > 1); and B * K
# above 65,535 (B1's grid has no z limit).
B1_CASES = [(3, (254, 254), 1), (3, (254, 254), 27), (3, (1022, 1022), 1), (3, (61, 190), 1),
            (3, (3, 3), 5), (3, (33, 9), 2), (1, (510, 510), 1), (1, (510, 510), 27),
            (150, (126, 126), 1), (3, (40, 64), 1), (3, (37, 65), 3), (3, (45, 67), 1),
            (3, (3, 70), 1), (2, (14, 30), 1), (2, (20, 25), 3), (3, (3, 3), 21846)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,shape,K", B1_CASES)
@pytest.mark.parametrize("compat", [True, False])
def test_cuda_kernel_matches_plain_version(B, shape, K, compat):
    dev = _cuda()
    m, n = shape
    frames = torch.from_numpy(_frames(m, n, B)).to(dev)
    scalars = torch.tensor((ALPHAS * B)[:B], device=dev)
    u = torch.randn(B, K, 3, m, n, device=dev, generator=torch.Generator(dev).manual_seed(0))
    launches = ck.LAUNCHES
    y = ck.el_matvec_reduced_fused(frames, scalars, u, compat)
    assert ck.LAUNCHES == launches + 1
    _assert_fields_close(y, ck.el_matvec_reduced_fused_ref(frames, scalars, u, compat))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("shape,K", [((254, 254), 1), ((254, 254), 27), ((1022, 1022), 1),
                                     ((61, 190), 1), ((3, 3), 5), ((33, 9), 2)])
@pytest.mark.parametrize("compat", [True, False])
def test_plain_stencil_kernel_and_hybrid_match_plain_versions(shape, K, compat):
    dev = _cuda()
    m, n = shape
    B = len(ALPHAS)
    frames = torch.from_numpy(_frames(m, n, B)).to(dev)
    scalars = torch.tensor(ALPHAS, device=dev)
    u = torch.randn(B, K, 3, m, n, device=dev, generator=torch.Generator(dev).manual_seed(1))
    launches, fused_launches = ck.CORE_LAUNCHES, ck.LAUNCHES
    y = ck.el_matvec_plain_core(frames, scalars, u, compat)
    assert ck.CORE_LAUNCHES == launches + 1
    _assert_fields_close(y, ck.el_matvec_plain_core_ref(frames, scalars, u, compat))
    # the hybrid operator (core + ring) is the reduced matvec
    dy_mode = stencils.DY_COMPAT if compat else stencils.DY_FIXED
    coeffs = elop.compute_coefficients(frames, scalars[:, 0], scalars[:, 1], dy_mode)
    ring = elop.ring_coeffs(elop.with_probe_axis(coeffs))
    y_h = ck.el_matvec_hybrid(frames, scalars, u, compat, ring)
    assert ck.CORE_LAUNCHES == launches + 2 and ck.LAUNCHES == fused_launches
    _assert_fields_close(y_h, ck.el_matvec_reduced_fused_ref(frames, scalars, u, compat))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("wrapper,halo", [(ck.el_matvec_reduced_fused, 0),
                                          (ck.el_matvec_plain_core, 0),
                                          (ck.el_matvec_extended, 2)])
def test_cuda_wrapper_raises_instead_of_falling_back(wrapper, halo):
    dev = _cuda()
    m, n = 16, 16
    frames = torch.zeros(2, m + 2, n + 2, device=dev)
    scalars = torch.zeros(2, 2, device=dev)
    u = torch.zeros(2, 3, m + halo, n + halo, device=dev)
    plain = ck.PLAIN_CALLS, ck.CORE_PLAIN_CALLS, ck.EXT_PLAIN_CALLS
    with pytest.raises(TypeError):
        wrapper(frames.double(), scalars, u, True)
    with pytest.raises(ValueError):
        wrapper(frames, scalars, u.transpose(-1, -2), True)
    with pytest.raises(ValueError):
        wrapper(frames, scalars.cpu(), u, True)
    assert (ck.PLAIN_CALLS, ck.CORE_PLAIN_CALLS, ck.EXT_PLAIN_CALLS) == plain


@pytest.mark.gpu
def test_tiled_wrapper_raises_instead_of_falling_back():
    dev = _cuda()
    frames = torch.zeros(4, 10, 10, device=dev)
    scalars = torch.zeros(4, 2, device=dev)
    u = torch.zeros(1, 3, 16, 16, device=dev)
    plain = ck.EXT_PLAIN_CALLS
    with pytest.raises(TypeError):
        ck.el_matvec_tiled(frames.double(), scalars, u, True, (2, 2))
    with pytest.raises(ValueError):
        ck.el_matvec_tiled(frames, scalars, u.transpose(-1, -2), True, (2, 2))
    with pytest.raises(ValueError):
        ck.el_matvec_tiled(frames, scalars.cpu(), u, True, (2, 2))
    with pytest.raises(ValueError):  # a halo line of the wrong length
        halo = (torch.zeros(4, 3, 10, device=dev),) * 2 + (torch.zeros(4, 3, 8, device=dev),) * 2
        ck.el_matvec_tiled(frames, scalars, torch.zeros(4, 3, 8, 9, device=dev), True, halo=halo)
    assert ck.EXT_PLAIN_CALLS == plain


# (pairs, K, m, n, tx, ty): the shapes B3 takes in chip_smoke.py (the 1022²
# interior as one tile and as 2 x 2 tiles of 511², the bench's 254², ragged)
EXT_CASES = [(1, 1, 1022, 1022, 1, 1), (1, 27, 1022, 1022, 1, 1), (1, 1, 1022, 1022, 2, 2),
             (1, 27, 1022, 1022, 2, 2), (11, 1, 254, 254, 1, 1), (2, 1, 61, 190, 1, 1)]


def _tiled_operands(dev, pairs, K, m, n, tx, ty, seed):
    frames = torch.from_numpy(_frames(m, n, pairs)).to(dev)
    scalars = torch.tensor(ALPHAS * 4, device=dev)[:pairs]
    u = torch.randn(pairs, K, 3, m, n, device=dev, generator=torch.Generator(dev).manual_seed(seed))
    return frames, scalars, u


@pytest.mark.gpu
@pytest.mark.parametrize("case", EXT_CASES)
@pytest.mark.parametrize("compat", [True, False])
def test_extended_block_kernel_matches_plain_version(case, compat):
    from opticalflow_tpu_torch.parallel import spmd

    dev = _cuda()
    pairs, K, m, n, tx, ty = case
    frames, scalars, u = _tiled_operands(dev, pairs, K, m, n, tx, ty, seed=2)
    I_t = spmd.to_tiles(frames, tx, ty).contiguous()
    u_t = spmd.to_tiles(elop.extend_interior(u), tx, ty).contiguous()
    s_t = scalars.repeat_interleave(tx * ty, dim=0).contiguous()
    launches = ck.EXT_LAUNCHES
    y = ck.el_matvec_extended(I_t, s_t, u_t, compat)
    assert ck.EXT_LAUNCHES == launches + 1
    _assert_fields_close(y, ck.el_matvec_extended_ref(I_t, s_t, u_t, compat))
    torch.cuda.synchronize()


# (pairs, (m, n), K) of kernel B2's cases: the hybrid solve's 1022² (K = 1
# and 27), widths n = 0, 1 and 3 mod 4, an interior shorter than a thread's
# 4-row strip, ragged, and B * K above 65,535 (no grid limit since the
# tiled kernel)
B2_CASES = [(1, (1022, 1022), 1), (1, (1022, 1022), 27), (3, (40, 64), 1), (3, (37, 65), 3),
            (3, (45, 67), 1), (3, (3, 70), 1), (3, (61, 190), 1), (3, (3, 3), 21846)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,shape,K", B2_CASES)
@pytest.mark.parametrize("compat", [True, False])
def test_plain_stencil_kernel_at_every_layout(B, shape, K, compat):
    dev = _cuda()
    m, n = shape
    frames = torch.from_numpy(_frames(m, n, B)).to(dev)
    scalars = torch.tensor((ALPHAS * B)[:B], device=dev)
    u = torch.randn(B, K, 3, m, n, device=dev, generator=torch.Generator(dev).manual_seed(5))
    launches = ck.CORE_LAUNCHES
    y = ck.el_matvec_plain_core(frames, scalars, u, compat)
    assert ck.CORE_LAUNCHES == launches + 1
    _assert_fields_close(y, ck.el_matvec_plain_core_ref(frames, scalars, u, compat))
    torch.cuda.synchronize()


# (pairs, K, M, N, tx, ty) of kernel B3 on a whole field: 2 x 2 tiles of
# 511² (K = 1 and 27), tile widths 0, 1 and 3 mod 4, tiles shorter than a
# 4-row strip, tiles of 2 x 2, ragged, and blocks * K above 65,535
B3_CASES = [(1, 1, 1022, 1022, 2, 2), (1, 27, 1022, 1022, 2, 2), (2, 1, 64, 128, 2, 2),
            (2, 3, 66, 130, 2, 2), (1, 1, 6, 134, 2, 2), (3, 2, 4, 4, 2, 2),
            (2, 1, 61, 190, 1, 1), (1, 1, 122, 190, 2, 1), (3, 21846, 4, 4, 2, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", B3_CASES)
@pytest.mark.parametrize("compat", [True, False])
def test_tiled_kernel_on_the_field_and_on_halo_lines(case, compat):
    """Both operand forms of B3 against the plain version: every tile of
    the field in one launch, and each tile alone with the halo lines the
    seam exchange gives it, written into its window of one result (the
    exchange route on one device); the two bitwise equal."""
    from opticalflow_tpu_torch.parallel import mesh as pmesh
    from opticalflow_tpu_torch.parallel import spmd

    dev = _cuda()
    pairs, K, m, n, tx, ty = case
    frames, scalars, u = _tiled_operands(dev, pairs, K, m, n, tx, ty, seed=6)
    I_t = spmd.to_tiles(frames, tx, ty).contiguous()
    s_t = scalars.repeat_interleave(tx * ty, dim=0).contiguous()
    launches = ck.EXT_LAUNCHES
    y = ck.el_matvec_tiled(I_t, s_t, u, compat, (tx, ty))
    assert ck.EXT_LAUNCHES == launches + 1
    _assert_fields_close(y, ck.el_matvec_tiled_ref(I_t, s_t, u, compat, (tx, ty)))
    mt, nt = m // tx, n // ty
    devices = pmesh.make_mesh([dev] * (tx * ty), frames=1, tx=tx, ty=ty).devices[0]
    tiles = spmd.split_tiles(u, devices)
    halos = spmd.exchange_halos(tiles) if tx * ty > 1 else None
    u_ext = spmd.to_tiles(elop.extend_interior(u), tx, ty)
    by_tile = torch.full_like(u, float("nan"))
    for p in range(tx):
        for q in range(ty):
            t = torch.arange(pairs, device=dev) * tx * ty + p * ty + q
            halo = halos[p][q] if halos else ck.halo_lines(u_ext[t])
            rows, cols = slice(p * mt, (p + 1) * mt), slice(q * nt, (q + 1) * nt)
            ck.el_matvec_tiled(I_t[t].contiguous(), s_t[t].contiguous(), tiles[p][q], compat,
                               halo=halo, out=by_tile[..., rows, cols])
    assert ck.EXT_LAUNCHES == launches + 1 + tx * ty
    assert torch.equal(by_tile, y)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 27])
def test_windows_route_writes_in_place(K):
    """B3 on the whole field into a given buffer: the buffer itself comes
    back, bitwise equal to the kernel's out-of-place result and to its
    outputs on the pre-extended blocks laid back into the field."""
    from opticalflow_tpu_torch.parallel import spmd

    dev = _cuda()
    frames, scalars, u = _tiled_operands(dev, 2, K, 254, 254, 2, 2, seed=7)
    I_t = spmd.to_tiles(frames, 2, 2).contiguous()
    s_t = scalars.repeat_interleave(4, dim=0).contiguous()
    buffer = torch.full_like(u, float("nan"))
    y = ck.el_matvec_tiled(I_t, s_t, u, True, (2, 2), out=buffer)
    assert y.data_ptr() == buffer.data_ptr()
    assert torch.equal(buffer, ck.el_matvec_tiled(I_t, s_t, u, True, (2, 2)))
    blocks = ck.el_matvec_extended(I_t, s_t,
                                   spmd.to_tiles(elop.extend_interior(u), 2, 2).contiguous(), True)
    assert torch.equal(buffer, spmd.from_tiles(blocks, 2, 2, 2))


@pytest.mark.gpu
@pytest.mark.parametrize("tiles", [(1, 1), (2, 2)])
@pytest.mark.parametrize("K", [1, 27])
def test_tiled_matvec_matches_the_fused_plain_version(tiles, K):
    from opticalflow_tpu_torch.parallel import mesh as pmesh
    from opticalflow_tpu_torch.parallel import spmd

    dev = _cuda()
    frames, scalars, u = _tiled_operands(dev, 1, K, 1022, 1022, *tiles, seed=3)
    mesh = pmesh.make_mesh(frames=1, tx=tiles[0], ty=tiles[1],
                           devices=[dev] * (tiles[0] * tiles[1]))
    mv = spmd.make_sharded_kernel_matvec(mesh, frames, scalars[:, 0], scalars[:, 1], "compat")
    counts = ck.EXT_LAUNCHES, ck.LAUNCHES
    y = mv(u)
    assert (ck.EXT_LAUNCHES, ck.LAUNCHES) == (counts[0] + 1, counts[1])
    _assert_fields_close(y, ck.el_matvec_reduced_fused_ref(frames, scalars, u, True))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_sharded_solve_on_the_card_runs_b3_and_matches_the_cpu():
    from opticalflow_tpu_torch.parallel import mesh as pmesh
    from opticalflow_tpu_torch.parallel.batch import sharded_variational_solve

    dev = _cuda()
    movie, _ = make_translating_blob_movie(n_frames=3, dimension=42, width=20.0, sigma=3.0,
                                           v_x=0.15, v_y=0.1)
    movie = (movie * 100.0).astype(np.float32)
    kw = dict(speed_alpha=1000.0, remodelling_alpha=1000.0, solver=SolverConfig(matvec="pallas"))
    counts = ck.EXT_LAUNCHES, ck.EXT_PLAIN_CALLS, ck.LAUNCHES, ck.DF_PLAIN_CALLS
    df_launches = ck.DF_LAUNCHES
    u_card, info = sharded_variational_solve(movie, mesh=pmesh.make_mesh(frames=1, tx=2, ty=2,
                                                                         devices=[dev] * 4), **kw)
    assert ck.EXT_LAUNCHES > counts[0] and ck.DF_LAUNCHES > df_launches
    assert (ck.EXT_PLAIN_CALLS, ck.LAUNCHES, ck.DF_PLAIN_CALLS) == counts[1:]
    cpu = torch.device("cpu")
    u_cpu, info_cpu = sharded_variational_solve(movie, mesh=pmesh.make_mesh([cpu] * 4, 1, 2, 2),
                                                **kw)
    assert bool(info["converged"].all()) and bool(info_cpu["converged"].all())
    d = (u_card[:, :2].cpu() - u_cpu[:, :2]).square().sum(dim=1).sqrt()
    assert d[:, 1:-1, 1:-1].max().item() < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["sharded", "distributed"])
def test_default_sharded_and_distributed_solves_launch_b1(entry):
    """With the default solver ('auto') both entry points run B1 untiled on
    a mesh of the card, a tiling one included: no B3, no plain version."""
    import socket

    import torch.distributed as dist

    from opticalflow_tpu_torch.parallel import distributed
    from opticalflow_tpu_torch.parallel import mesh as pmesh
    from opticalflow_tpu_torch.parallel.batch import sharded_variational_solve

    dev = _cuda()
    movie, _ = make_translating_blob_movie(n_frames=3, dimension=42, width=20.0, sigma=3.0,
                                           v_x=0.15, v_y=0.1)
    movie = (movie * 100.0).astype(np.float32)
    kw = dict(speed_alpha=1000.0, remodelling_alpha=1000.0)
    counts = ck.LAUNCHES, ck.PLAIN_CALLS, ck.EXT_LAUNCHES, ck.EXT_PLAIN_CALLS
    if entry == "sharded":
        _, info = sharded_variational_solve(
            movie, mesh=pmesh.make_mesh(frames=1, tx=2, ty=2, devices=[dev] * 4), **kw)
    else:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        distributed.initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=1,
                               process_id=0, cpu_devices=1)
        try:
            _, info = distributed.distributed_variational_solve((movie[:-1], movie[1:]), **kw)
        finally:
            dist.destroy_process_group()
    assert ck.LAUNCHES > counts[0]
    assert (ck.PLAIN_CALLS, ck.EXT_LAUNCHES, ck.EXT_PLAIN_CALLS) == counts[1:]
    assert bool(torch.as_tensor(info["converged"]).all())


def _two_gpus():
    _cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs two GPUs (meshes over distinct devices); this machine has "
                    f"{torch.cuda.device_count()}")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


def _small_movie(n_frames=3):
    movie, _ = make_translating_blob_movie(n_frames=n_frames, dimension=42, width=20.0,
                                           sigma=3.0, v_x=0.15, v_y=0.1)
    return (movie * 100.0).astype(np.float32)


def _forced_solve(movie, mesh, solver=None, speed_alpha=1.0, remodelling_alpha=1000.0):
    """``sharded_variational_solve``'s solve with the distinct-device routes
    forced (``batch._mesh_solve(..., as_distinct=True)``)."""
    from opticalflow_tpu_torch.parallel.batch import _mesh_solve

    m = torch.as_tensor(movie).to(device=mesh.device(), dtype=torch.float32)
    return _mesh_solve(m[:-1], m[1:], m.new_zeros((3,) + tuple(m.shape[1:])), speed_alpha,
                       remodelling_alpha, solver or SolverConfig(), "compat", mesh,
                       as_distinct=True)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 27])
def test_exchange_route_on_the_card_equals_the_windows_route(K):
    """The distinct-device route forced on the card: four B3 launches, one
    per tile, and the windows route's output bitwise."""
    from opticalflow_tpu_torch.parallel import mesh as pmesh
    from opticalflow_tpu_torch.parallel import spmd

    dev = _cuda()
    frames, scalars, u = _tiled_operands(dev, 1, K, 1022, 1022, 1, 1, seed=4)
    mesh = pmesh.make_mesh([dev] * 4, frames=1, tx=2, ty=2)
    args = (mesh, frames, scalars[:, 0], scalars[:, 1], "compat")
    windows = spmd.make_sharded_kernel_matvec(*args)
    exchange = spmd.make_sharded_kernel_matvec(*args, as_distinct=True)
    launches = ck.EXT_LAUNCHES
    y = exchange(u)
    assert ck.EXT_LAUNCHES == launches + 4
    assert torch.equal(y, windows(u))


@pytest.mark.gpu
@pytest.mark.parametrize("matvec", ["pallas", "auto"])
def test_exchange_route_solve_on_the_card(matvec):
    """(1, 2, 2) on the card with the exchange route forced: 'pallas' and
    'auto' both run B3, four launches for each of the windows route's, and
    equal its solve bitwise."""
    from opticalflow_tpu_torch.parallel import mesh as pmesh
    from opticalflow_tpu_torch.parallel.batch import sharded_variational_solve

    dev = _cuda()
    mesh = pmesh.make_mesh([dev] * 4, frames=1, tx=2, ty=2)
    kw = dict(mesh=mesh, speed_alpha=1000.0, remodelling_alpha=1000.0)
    counts = ck.EXT_LAUNCHES, ck.LAUNCHES
    u, info = _forced_solve(_small_movie(), solver=SolverConfig(matvec=matvec), **kw)
    exchange = ck.EXT_LAUNCHES - counts[0]
    assert exchange > 0 and ck.LAUNCHES == counts[1]
    counts = ck.EXT_LAUNCHES
    u_w, info_w = sharded_variational_solve(_small_movie(), solver=SolverConfig(matvec="pallas"),
                                            **kw)
    assert exchange == 4 * (ck.EXT_LAUNCHES - counts)
    assert torch.equal(u, u_w) and torch.equal(info["iterations"], info_w["iterations"])


@pytest.mark.gpu
def test_frames_workers_on_the_card_equal_serial_blocks():
    from opticalflow_tpu_torch.parallel import mesh as pmesh
    from opticalflow_tpu_torch.parallel.batch import sharded_variational_solve

    dev = _cuda()
    kw = dict(mesh=pmesh.make_mesh([dev] * 2, frames=2, tx=1, ty=1), speed_alpha=1000.0,
              remodelling_alpha=1000.0)
    launches = ck.LAUNCHES
    u, info = _forced_solve(_small_movie(5), **kw)
    workers = ck.LAUNCHES - launches
    launches = ck.LAUNCHES
    u_s, info_s = sharded_variational_solve(_small_movie(5), **kw)
    assert workers == ck.LAUNCHES - launches > 0
    assert torch.equal(u, u_s)
    for key in info:
        assert torch.equal(info[key], info_s[key]), key


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 1, 1), (1, 2, 1)])
def test_meshes_over_two_gpus_equal_one_card(shape):
    """Frames over two GPUs (a worker each) and tiles over two GPUs (seams
    copied between them), each bitwise equal to the same mesh on one
    card."""
    from opticalflow_tpu_torch.parallel import mesh as pmesh
    from opticalflow_tpu_torch.parallel.batch import sharded_variational_solve

    two = _two_gpus()
    kw = dict(speed_alpha=1000.0, remodelling_alpha=1000.0, solver=SolverConfig(matvec="pallas"))
    u, info = sharded_variational_solve(_small_movie(5), mesh=pmesh.make_mesh(two, *shape), **kw)
    u_1, info_1 = sharded_variational_solve(_small_movie(5),
                                            mesh=pmesh.make_mesh([two[0]] * 2, *shape), **kw)
    assert u.device == two[0]
    assert torch.equal(u, u_1) and torch.equal(info["iterations"], info_1["iterations"])


@pytest.mark.gpu
def test_box_flow_over_two_gpus_equals_one_card():
    from opticalflow_tpu_torch.parallel import mesh as pmesh
    from opticalflow_tpu_torch.parallel.batch import sharded_box_flow

    two = _two_gpus()
    movie = _small_movie(5)
    got = sharded_box_flow(movie, 7, mesh=pmesh.make_mesh(two, frames=2))
    want = sharded_box_flow(movie, 7, mesh=pmesh.make_mesh([two[0]], frames=1))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_solve_on_the_card_runs_the_kernel_and_matches_the_cpu():
    dev = _cuda()
    movie, _ = make_translating_blob_movie(n_frames=4, dimension=40, width=20.0, sigma=3.0,
                                           v_x=0.15, v_y=0.1)
    movie = (movie * 100.0).astype(np.float32)
    kw = dict(speed_alpha=1000.0, remodelling_alpha=1000.0, warm_start="two-pass")
    launches, plain = ck.LAUNCHES, ck.PLAIN_CALLS
    df = ck.DF_LAUNCHES, ck.DF_PLAIN_CALLS
    on_card = variational_optical_flow(torch.from_numpy(movie).to(dev), **kw)
    assert ck.LAUNCHES > launches and ck.PLAIN_CALLS == plain
    # the refinement ran B4, never its plain version
    assert ck.DF_LAUNCHES > df[0] and ck.DF_PLAIN_CALLS == df[1]
    on_cpu = variational_optical_flow(movie, device="cpu", **kw)
    assert on_card["converged_all"].all() and on_cpu["converged_all"].all()
    epe = np.sqrt((on_card["v_x"] - on_cpu["v_x"]) ** 2 + (on_card["v_y"] - on_cpu["v_y"]) ** 2)
    assert epe[:, 1:-1, 1:-1].max() < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["bicgstab", "gmres"])
def test_hybrid_solve_on_the_card_runs_the_kernel_and_matches_the_cpu(method):
    dev = _cuda()
    movie, _ = make_translating_blob_movie(n_frames=3, dimension=40, width=20.0, sigma=3.0,
                                           v_x=0.15, v_y=0.1)
    movie = (movie * 100.0).astype(np.float32)
    kw = dict(speed_alpha=1000.0, remodelling_alpha=1000.0, warm_start="two-pass",
              solver=SolverConfig(matvec="hybrid", method=method))
    counts = ck.CORE_LAUNCHES, ck.CORE_PLAIN_CALLS, ck.LAUNCHES, ck.DF_PLAIN_CALLS
    df_launches = ck.DF_LAUNCHES
    on_card = variational_optical_flow(torch.from_numpy(movie).to(dev), **kw)
    assert ck.CORE_LAUNCHES > counts[0] and ck.DF_LAUNCHES > df_launches
    assert (ck.CORE_PLAIN_CALLS, ck.LAUNCHES, ck.DF_PLAIN_CALLS) == counts[1:]
    on_cpu = variational_optical_flow(movie, device="cpu", **kw)
    assert on_card["converged_all"].all() and on_cpu["converged_all"].all()
    epe = np.sqrt((on_card["v_x"] - on_cpu["v_x"]) ** 2 + (on_card["v_y"] - on_cpu["v_y"]) ** 2)
    assert epe[:, 1:-1, 1:-1].max() < 1e-4


@pytest.mark.gpu
def test_sweep_on_the_card_runs_the_kernel_and_matches_the_cpu():
    """A 2 x 2 grid on a 3-frame 40x40 movie, batched on the card: B1
    launched, no plain call; every statistic within 1e-4 relative of the
    same sweep on the CPU.  Both refine to 0.01 x tol: at the default 0.1
    x tol a float32 statistic may stop up to ~1.6e-4 from the float64
    sweep's on either device, so two float32 runs differ by as much,
    while at 0.01 x tol they agree within ~1e-5 (``utils/exit_band.py
    sweep``).  chip_smoke's sweep phase holds the default exit against
    the serial path."""
    from opticalflow_tpu_torch.analysis.sweeps import vary_regularisation

    dev = _cuda()
    movie, _ = make_translating_blob_movie(n_frames=3, dimension=40, width=20.0, sigma=3.0,
                                           v_x=0.15, v_y=0.1)
    movie = (movie * 100.0).astype(np.float32)
    grid = ([300.0, 3000.0], [500.0, 5000.0])
    solver = SolverConfig(refinement_exit_factor=0.01)
    counts = ck.LAUNCHES, ck.PLAIN_CALLS, ck.DF_LAUNCHES, ck.DF_PLAIN_CALLS
    on_card = vary_regularisation(movie, *grid, device=dev, solver=solver)
    assert ck.LAUNCHES > counts[0] and ck.PLAIN_CALLS == counts[1]
    assert ck.DF_LAUNCHES > counts[2] and ck.DF_PLAIN_CALLS == counts[3]
    on_cpu = vary_regularisation(movie, *grid, device="cpu", solver=solver)
    assert on_card["converged"].all() and on_cpu["converged"].all()
    for key in ("speed_means", "speed_variances", "remodelling_means", "functional"):
        np.testing.assert_allclose(on_card[key], on_cpu[key], rtol=1e-4, err_msg=key)


@pytest.mark.gpu
@pytest.mark.parametrize("include_remodelling", [False, True])
def test_box_flow_on_the_card_matches_the_cpu(include_remodelling):
    """float32 box flow on the card and on the CPU, NaNs in the same places.
    The closed-form solves lose ~1e-3 of the largest velocity in float32
    (far more for the 3x3 branch's remodelling), so the card is held to the
    CPU's own accuracy: against the CPU's float64 run, the card's error is
    at most twice the CPU's plus 1e-6 of the largest value."""
    from opticalflow_tpu_torch import conduct_optical_flow

    dev = _cuda()
    movie, delta_x = make_translating_blob_movie(n_frames=4, dimension=64, width=10.0,
                                                 sigma=2.0, v_x=0.15, v_y=0.1)
    kw = dict(boxsize=9, delta_x=delta_x, include_remodelling=include_remodelling,
              smoothing_sigma=1.0)
    on_card = conduct_optical_flow(movie * 100.0, device=dev, **kw)
    on_cpu = conduct_optical_flow(movie * 100.0, device="cpu", **kw)
    ref = conduct_optical_flow(movie * 100.0, device="cpu", dtype=torch.float64, **kw)
    for key in ("v_x", "v_y", "speed") + (("net_remodelling",) if include_remodelling else ()):
        np.testing.assert_array_equal(np.isnan(on_card[key]), np.isnan(on_cpu[key]))
        ok = np.isfinite(on_card[key] + on_cpu[key] + ref[key])
        scale = np.abs(ref[key][ok]).max()
        card_err = np.abs(on_card[key][ok] - ref[key][ok]).max() / scale
        cpu_err = np.abs(on_cpu[key][ok] - ref[key][ok]).max() / scale
        assert card_err <= 2.0 * cpu_err + 1e-6, (key, card_err, cpu_err)


def _tiny_tiff(path, n_frames=4, dim=40):
    """A 16-bit multi-page TIFF of integer counts (the bench movie's scale),
    written with chip_smoke's writer; returns the movie."""
    import chip_smoke

    movie, _ = make_translating_blob_movie(n_frames=n_frames, dimension=dim, width=20.0, sigma=3.0,
                                           v_x=0.15, v_y=0.1)
    movie = np.round(movie / movie.max() * 100.0).astype(np.uint16)
    chip_smoke.write_tiff_stack(path, movie)
    return movie.astype(np.float64)


@pytest.mark.gpu
def test_cli_variational_and_box_on_the_card(tmp_path):
    """The command line with no --device: the TIFF read by the native
    loader, ``variational`` launching B1 and no plain version, its saved
    result within 1e-4 px of the same command on the CPU; ``box`` under
    --profile equal to a direct ``conduct_optical_flow`` on the card."""
    from opticalflow_tpu_torch import FlowResult, conduct_optical_flow
    from opticalflow_tpu_torch.analysis import drivers
    from opticalflow_tpu_torch.io import native_loader

    _cuda()
    path = str(tmp_path / "stack.tif")
    movie = _tiny_tiff(path)
    np.testing.assert_array_equal(native_loader.read_tiff_movie_native(path), movie)
    counts = ck.LAUNCHES, ck.PLAIN_CALLS
    out = str(tmp_path / "card")
    drivers.compute_variational(path, out)  # the step the CLI runs before plotting
    assert ck.LAUNCHES > counts[0] and ck.PLAIN_CALLS == counts[1]
    drivers.compute_variational(path, str(tmp_path / "cpu"), device="cpu")
    on_card = FlowResult.load(out + "/variational_result.npy")
    on_cpu = FlowResult.load(str(tmp_path / "cpu" / "variational_result.npy"))
    assert on_card["converged_all"].all() and on_cpu["converged_all"].all()
    epe = np.hypot(on_card["v_x"] - on_cpu["v_x"], on_card["v_y"] - on_cpu["v_y"])
    assert epe[:, 1:-1, 1:-1].max() < 1e-4

    prof = str(tmp_path / "profile")
    box = drivers.main(["--profile", prof, "box", path, "--output-dir", str(tmp_path / "box"),
                        "--boxsize", "9"])
    want = conduct_optical_flow(movie, boxsize=9, smoothing_sigma=3.0)
    for key in ("v_x", "v_y", "speed"):
        np.testing.assert_array_equal(box[key], want[key])
    assert (tmp_path / "profile" / "trace.json").stat().st_size > 0


# (pairs, (m, n)) of kernel B4's cases: ragged shapes, widths n = 0, 1, 2
# and 3 mod 4, the 2x2 minimum (every pixel an edge, all four corners
# doubled), two columns, a block's worth of rows and one more, and the sweep's
# 126^2; fields with exact zeros in a third of their pixels (signed zeros).
# Against B4's tiles of 32 columns x 16 rows: one tile exactly, one pixel
# short and one over in both axes, and shapes that end mid-tile in rows and
# columns at once.
B4_CASES = [(3, (7, 9)), (3, (61, 190)), (2, (2, 2)), (2, (2, 37)), (1, (9, 2)), (2, (8, 32)),
            (2, (9, 33)), (3, (45, 67)), (1, (126, 126)), (2, (16, 32)), (2, (15, 31)),
            (2, (17, 33)), (1, (31, 95))]
# (pairs, (m, n), P, overflow) of B4's adversarial cases
# (``df32_cases.adversarial_operands``: signed zeros, subnormal low parts,
# heads of mixed exponents; with overflow, NaN in the outputs): ragged, the
# 2x2 minimum, and 70,000 pairs of 2x2, a grid of more than 65,535 blocks
B4_ADVERSARIAL = [(3, (61, 190), 24, False), (2, (17, 33), 26, False), (2, (2, 2), 24, False),
                  (2, (45, 67), 26, True), (70000, (2, 2), 26, False)]


def _df32_operands(dev, B, m, n, dy_mode, seed):
    """B4's operands, packed from the df32 data of B pairs on the card, and
    fields x_hi (with zeros) and x_lo."""
    frames = torch.from_numpy(_frames(m, n, B + 1)).to(dev) * 100.0
    prev, cur = frames[:-1], frames[1:]
    alphas = torch.tensor([(1000.0, 1000.0), (300.0, 2000.0), (50.0, 10.0)] * B, device=dev)[:B]
    dfd = elop.compute_frame_pair_data_df(prev, cur, alphas[:, 0], alphas[:, 1], dy_mode,
                                          prev.flatten(1).amax(1))
    gen = torch.Generator(dev).manual_seed(seed)
    x_hi = torch.randn(B, 3, m, n, device=dev, generator=gen)
    x_hi[..., ::3] = 0.0
    x_lo = x_hi * 1e-8 * torch.randn(B, 3, m, n, device=dev, generator=gen)
    return ck.pack_df32(dfd), x_hi, x_lo


def _bitwise_equal(a, b):
    """Equal values and equal bits (signed zeros, NaN payloads)."""
    return torch.equal(a, b) and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("B,shape", B4_CASES)
@pytest.mark.parametrize("dy_mode", ["compat", "fixed"])
def test_df32_kernel_equals_its_plain_version(B, shape, dy_mode):
    """Kernel B4 in residual and operator mode, bit for bit its plain
    version; also on a subset of pairs, as the refinement takes them."""
    from opticalflow_tpu_torch.flow.variational import _take

    dev = _cuda()
    ops, x_hi, x_lo = _df32_operands(dev, B, *shape, dy_mode, seed=4)
    launches, plain = ck.DF_LAUNCHES, ck.DF_PLAIN_CALLS
    r = ck.el_residual_df32(ops, x_hi, x_lo)
    y = ck.el_matvec_df32(ops, x_hi)
    assert (ck.DF_LAUNCHES, ck.DF_PLAIN_CALLS) == (launches + 2, plain)
    assert _bitwise_equal(r, ck.el_residual_df32_ref(ops, x_hi, x_lo))
    assert _bitwise_equal(y, ck.el_matvec_df32_ref(ops, x_hi))
    idx = torch.arange(B - 1, -1, -2, device=dev)
    sub = _take(ops, idx)
    assert _bitwise_equal(ck.el_residual_df32(sub, x_hi[idx], x_lo[idx]), r[idx])
    assert _bitwise_equal(ck.el_matvec_df32(sub, x_hi[idx]), y[idx])
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("B,shape,P,overflow", B4_ADVERSARIAL)
def test_df32_kernel_equals_its_plain_version_on_adversarial_operands(B, shape, P, overflow):
    """Kernel B4 in residual and operator mode on operands made to catch a
    kernel that is not its plain version bit for bit: compared by bits,
    so that -0 and NaN are checked too."""
    from opticalflow_tpu_torch.utils.df32_cases import adversarial_operands, bitwise_equal

    dev = _cuda()
    ops, x_hi, x_lo = adversarial_operands(B, *shape, P, seed=11, device=dev, overflow=overflow)
    r = ck.el_residual_df32(ops, x_hi, x_lo)
    y = ck.el_matvec_df32(ops, x_hi)
    r_ref = ck.el_residual_df32_ref(ops, x_hi, x_lo)
    y_ref = ck.el_matvec_df32_ref(ops, x_hi)
    assert bitwise_equal(r, r_ref) and bitwise_equal(y, y_ref)
    assert bool(torch.isnan(r_ref).any()) == overflow
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_df32_wrappers_raise_instead_of_falling_back():
    dev = _cuda()
    ops, x_hi, x_lo = _df32_operands(dev, 2, 16, 16, "compat", seed=5)
    plain = ck.DF_PLAIN_CALLS
    with pytest.raises(TypeError):  # float32 only on the card, as B1
        ck.el_matvec_df32(ops._replace(planes=ops.planes.double()), x_hi)
    with pytest.raises(TypeError):
        ck.el_residual_df32(ops, x_hi.double(), x_lo.double())
    with pytest.raises(ValueError):
        ck.el_matvec_df32(ops, x_hi.transpose(-1, -2))
    with pytest.raises(ValueError):
        ck.el_residual_df32(ops._replace(scalars=ops.scalars.cpu()), x_hi, x_lo)
    with pytest.raises(ValueError):
        ck.el_residual_df32(ops, x_hi, x_lo[:, :, :-1])
    assert ck.DF_PLAIN_CALLS == plain


@pytest.mark.gpu
@pytest.mark.parametrize("dy_mode", ["compat", "fixed"])
def test_solve_on_the_card_refines_through_b4_only(dy_mode):
    """A batched solve on the card: B4 launched in both modes' refinement,
    no plain version of any kernel; a float64 solve on the card raises at
    its first kernel, as it did before B4 (B1's float32 rule)."""
    dev = _cuda()
    movie, _ = make_translating_blob_movie(n_frames=3, dimension=40, width=20.0, sigma=3.0,
                                           v_x=0.15, v_y=0.1)
    movie = torch.from_numpy((movie * 100.0).astype(np.float32)).to(dev)
    kw = dict(speed_alpha=1000.0, remodelling_alpha=1000.0, warm_start="cold", dy_mode=dy_mode)
    counts = ck.DF_LAUNCHES, ck.DF_PLAIN_CALLS, ck.PLAIN_CALLS
    result = variational_optical_flow(movie, **kw)
    assert result["converged_all"].all()
    assert ck.DF_LAUNCHES > counts[0] and (ck.DF_PLAIN_CALLS, ck.PLAIN_CALLS) == counts[1:]
    with pytest.raises(TypeError):
        variational_optical_flow(movie, dtype=torch.float64, **kw)


# Kernels B5 and B6 (the multigrid V-cycle): (pairs, fine (M, N), K) at
# ragged shapes, both parities of M and N (127 -> 64, 63 -> 32, 255 -> 128),
# the smallest grids (2x2 -> 1x1, 1x1), the probes' K = 27 and the coarsest
# operator's K = 3 m n = 192 at 8x8; the sweeps and the epilogue at K = 1.
MG_CASES = [(2, (17, 22), 1), (3, (61, 190), 1), (2, (127, 127), 1), (2, (63, 64), 1),
            (1, (255, 255), 1), (2, (2, 2), 1), (2, (1, 1), 1), (2, (24, 31), 27),
            (3, (9, 9), 27), (1, (8, 8), 192), (2, (2, 2), 27)]


def _mg_operands(dev, B, M, N, K, seed):
    """A random level (S, binv) and fields x, b, y (B, [K,] 3, M, N) and a
    coarse e on the card, with signed zeros among the field values."""
    gen = torch.Generator(dev).manual_seed(seed)
    S = torch.randn((B, 3, 3, 3, 3, M, N), device=dev, generator=gen)
    binv = torch.randn((B, 3, 3, M, N), device=dev, generator=gen)
    lead = (B,) if K == 1 else (B, K)
    fields = [torch.randn(lead + (3, M, N), device=dev, generator=gen) for _ in range(3)]
    for f in fields:
        f.view(-1)[::7] = -0.0
        f.view(-1)[3::11] = 0.0
    e = torch.randn(lead + (3, (M + 1) // 2, (N + 1) // 2), device=dev, generator=gen)
    return S, binv, *fields, e


@pytest.mark.gpu
@pytest.mark.parametrize("B,shape,K", MG_CASES)
def test_mg_kernels_equal_their_plain_versions(B, shape, K):
    """B5 (sweep, zero guess, level-0 epilogue, stencil apply) and B6
    (the four restrictions, both prolongations and, at K = 1, the two
    fused stages) bit for bit against their plain versions, signed zeros
    included."""
    dev = _cuda()
    M, N = shape
    S, binv, x, b, y, e = _mg_operands(dev, B, M, N, K, seed=M * N + K)
    coarse = ((M + 1) // 2, (N + 1) // 2)
    cases = [(ck.mg_stencil_apply, ck.mg_stencil_apply_ref, (S, x)),
             (ck.mg_residual_restrict, ck.mg_residual_restrict_ref, (S, x, b, None, coarse)),
             (ck.mg_residual_restrict, ck.mg_residual_restrict_ref, (None, None, b, y, coarse)),
             (ck.mg_residual_restrict, ck.mg_residual_restrict_ref, (S, x, None, None, coarse)),
             (ck.mg_residual_restrict, ck.mg_residual_restrict_ref, (None, None, None, y, coarse)),
             (ck.mg_prolong_add, ck.mg_prolong_add_ref, (x, e, shape)),
             (ck.mg_prolong_add, ck.mg_prolong_add_ref, (None, e, shape))]
    if K == 1:
        cases += [(ck.mg_smooth, ck.mg_smooth_ref, (S, binv, x, b, 0.7)),
                  (ck.mg_smooth, ck.mg_smooth_ref, (S, binv, None, b, 0.7)),
                  (ck.mg_smooth_fine, ck.mg_smooth_fine_ref, (binv, x, b, y, 0.7)),
                  (ck.mg_smooth_fine, ck.mg_smooth_fine_ref, (binv, None, b, None, 0.7)),
                  (ck.mg_smooth_restrict, ck.mg_smooth_restrict_ref,
                   (S, binv, x, b, 0.7, coarse)),
                  (ck.mg_prolong_smooth, ck.mg_prolong_smooth_ref, (S, binv, x, e, b, 0.7))]
    _assert_mg_bitwise(cases)


def _assert_mg_bitwise(cases):
    """Each (kernel, plain version, arguments) of B5 or B6: one launch a
    call, no plain version run by it, every output bit for bit the plain
    version's."""
    from opticalflow_tpu_torch.utils.df32_cases import bitwise_equal

    launches = ck.MG_LAUNCHES + ck.MGT_LAUNCHES
    plain = ck.MG_PLAIN_CALLS, ck.MGT_PLAIN_CALLS
    outs = [kernel(*args) for kernel, _, args in cases]
    assert ck.MG_LAUNCHES + ck.MGT_LAUNCHES == launches + len(cases)
    # the kernel calls ran no plain version
    assert (ck.MG_PLAIN_CALLS, ck.MGT_PLAIN_CALLS) == plain
    for (kernel, ref, args), out in zip(cases, outs):
        want = ref(*args)
        pairs = zip(out, want) if isinstance(out, tuple) else [(out, want)]
        assert all(bitwise_equal(a, b) for a, b in pairs), (kernel.__name__,
                                                            [a is None for a in args])
    torch.cuda.synchronize()


# B6 at every fine level shape of every path's hierarchy (the bench's 254²,
# the sweep's 126², the command line's 510², the 1024² pair's 1022², and
# each level below them, of which the last transfer's fine grid is 16²), one
# pair; its standalone instances also at the probes' K = 27 and at K = 192
B6_LEVEL_SHAPES = [(1022, 1022), (511, 511), (510, 510), (256, 256), (255, 255), (254, 254),
                   (128, 128), (127, 127), (126, 126), (64, 64), (63, 63), (32, 32), (16, 16)]
B6_CASES = ([(1, shape, 1) for shape in B6_LEVEL_SHAPES]
            + [(2, (63, 63), 27), (1, (127, 127), 27), (2, (61, 190), 27), (1, (16, 16), 192),
               (1, (8, 8), 192)])


@pytest.mark.gpu
@pytest.mark.parametrize("B,shape,K", B6_CASES)
def test_b6_equals_its_plain_versions_at_every_level_shape(B, shape, K):
    """Every B6 instance, the six standalone (R y, R (S x), R (b - y),
    R (b - S x), P e, x + P e) and at K = 1 the two fused stages, bit for
    bit against its plain version at the level shapes the paths' V-cycles
    and probes give it."""
    dev = _cuda()
    M, N = shape
    S, binv, x, b, y, e = _mg_operands(dev, B, M, N, K, seed=7 * M + N + K)
    coarse = ((M + 1) // 2, (N + 1) // 2)
    cases = [(ck.mg_residual_restrict, ck.mg_residual_restrict_ref, (None, None, None, y, coarse)),
             (ck.mg_residual_restrict, ck.mg_residual_restrict_ref, (S, x, None, None, coarse)),
             (ck.mg_residual_restrict, ck.mg_residual_restrict_ref, (None, None, b, y, coarse)),
             (ck.mg_residual_restrict, ck.mg_residual_restrict_ref, (S, x, b, None, coarse)),
             (ck.mg_prolong_add, ck.mg_prolong_add_ref, (None, e, shape)),
             (ck.mg_prolong_add, ck.mg_prolong_add_ref, (x, e, shape))]
    if K == 1:
        cases += [(ck.mg_smooth_restrict, ck.mg_smooth_restrict_ref,
                   (S, binv, x, b, 0.7, coarse)),
                  (ck.mg_prolong_smooth, ck.mg_prolong_smooth_ref, (S, binv, x, e, b, 0.7))]
    _assert_mg_bitwise(cases)


@pytest.mark.gpu
def test_mg_wrappers_raise_instead_of_falling_back():
    dev = _cuda()
    S, binv, x, b, y, e = _mg_operands(dev, 2, 17, 22, 1, seed=9)
    plain = ck.MG_PLAIN_CALLS, ck.MGT_PLAIN_CALLS
    with pytest.raises(TypeError):  # float32 only on the card
        ck.mg_smooth(S.double(), binv, x, b, 0.7)
    with pytest.raises(TypeError):
        ck.mg_smooth_fine(binv, x.double(), b, y, 0.7, checked=True)
    with pytest.raises(ValueError):
        ck.mg_stencil_apply(S, x.transpose(-1, -2))
    with pytest.raises(ValueError):
        ck.mg_smooth(S, binv, x, b.cpu(), 0.7)
    with pytest.raises(ValueError):
        ck.mg_residual_restrict(S, x, b, None, (9, 10))
    with pytest.raises(ValueError):
        ck.mg_prolong_add(x[..., :-1], e, (17, 22))
    with pytest.raises(ValueError):
        ck.mg_check_level(S[..., 1:, :], binv)
    with pytest.raises(ValueError):  # the fused stages sweep from x
        ck.mg_smooth_restrict(S, binv, None, b, 0.7, (9, 11))
    with pytest.raises(ValueError):
        ck.mg_prolong_smooth(S, binv, x, e[..., :-1], b, 0.7)
    with pytest.raises(TypeError):
        ck.mg_prolong_smooth(S, binv, x, e.double(), b, 0.7, checked=True)
    with pytest.raises(ValueError):  # B6's grid takes at most 65,535 pairs
        ck.mg_prolong_add(None, e[:1].expand(70000, 3, 9, 11).contiguous(), (17, 22))
    assert (ck.MG_PLAIN_CALLS, ck.MGT_PLAIN_CALLS) == plain


@pytest.mark.gpu
@pytest.mark.parametrize("smoother", ["jacobi", "gs"])
def test_v_cycle_on_the_kernels_equals_the_torch_route(smoother):
    """A hierarchy on kernel B1 set up and applied through B5 and B6 equals
    the same hierarchy through the plain stages bit for bit: the probes,
    the coarse stencils, the block inverses and the V-cycle."""
    from opticalflow_tpu_torch.solve import multigrid

    dev = _cuda()
    m, n = 61, 94
    frames = torch.from_numpy(_frames(m, n, 4)).to(dev)
    a_s = torch.tensor([a for a, _ in ALPHAS], device=dev)
    a_r = torch.tensor([a for _, a in ALPHAS], device=dev)
    pair = elop.compute_frame_pair_data(frames[:-1], frames[1:], a_s, a_r, "compat")
    I, scalars = frames[:-1].contiguous(), torch.stack([a_s, a_r], dim=-1).contiguous()

    def matvec(u):
        return ck.el_matvec_reduced_fused(I, scalars, u.contiguous(), True)

    blocks = elop.diag_blocks(pair.coeffs)
    counts = ck.MG_LAUNCHES, ck.MGT_LAUNCHES, ck.MG_PLAIN_CALLS, ck.MGT_PLAIN_CALLS
    h = multigrid.setup(matvec, blocks, m, n, torch.float32, route="kernels")
    r = torch.randn((3, 3, m, n), device=dev, generator=torch.Generator(dev).manual_seed(6))
    counts = ck.MG_LAUNCHES, ck.MGT_LAUNCHES, ck.MG_PLAIN_CALLS, ck.MGT_PLAIN_CALLS
    z = multigrid.v_cycle(h, r, smoother=smoother)
    assert ck.MG_LAUNCHES > counts[0] and ck.MGT_LAUNCHES > counts[1]
    assert (ck.MG_PLAIN_CALLS, ck.MGT_PLAIN_CALLS) == counts[2:]
    if smoother == "jacobi":  # sweeps 2: a probed level fuses 2 of its 6 launches away
        probed = len(h.levels) - 2
        assert (ck.MG_LAUNCHES - counts[0], ck.MGT_LAUNCHES - counts[1]) == (
            4 + 2 * probed, 2 + 2 * probed)
    h_t = multigrid.setup(matvec, blocks, m, n, torch.float32, route="torch")
    for level, level_t in zip(h.levels, h_t.levels):
        assert torch.equal(level.binv, level_t.binv)
        if level.stencil is not None:
            assert torch.equal(level.stencil.view(torch.int32), level_t.stencil.view(torch.int32))
    z_t = multigrid.v_cycle(h_t, r, smoother=smoother)
    assert torch.equal(z.view(torch.int32), z_t.view(torch.int32))
    idx = torch.tensor([2, 0], device=dev)
    sub = multigrid.take(h, idx, lambda u: ck.el_matvec_reduced_fused(
        I[idx].contiguous(), scalars[idx].contiguous(), u.contiguous(), True))
    launches = ck.MG_LAUNCHES + ck.MGT_LAUNCHES
    z_sub = multigrid.v_cycle(sub, r[idx], smoother=smoother)
    assert sub.route == "kernels" and ck.MG_LAUNCHES + ck.MGT_LAUNCHES > launches
    torch.testing.assert_close(z_sub, z[idx], rtol=1e-5, atol=1e-5 * z.abs().max().item())
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("matvec", ["auto", "hybrid", "xla"])
def test_solve_on_the_card_runs_the_v_cycle_on_b5_and_b6(matvec):
    """A batched solve on the card: every kernel route's V-cycles launch B5
    and B6 and no plain version; 'xla' keeps the plain stages (its solve may
    be float64)."""
    dev = _cuda()
    movie, _ = make_translating_blob_movie(n_frames=3, dimension=40, width=20.0, sigma=3.0,
                                           v_x=0.15, v_y=0.1)
    movie = torch.from_numpy((movie * 100.0).astype(np.float32)).to(dev)
    counts = ck.MG_LAUNCHES, ck.MGT_LAUNCHES, ck.MG_PLAIN_CALLS, ck.MGT_PLAIN_CALLS
    result = variational_optical_flow(movie, speed_alpha=1000.0, remodelling_alpha=1000.0,
                                      warm_start="cold", solver=SolverConfig(matvec=matvec))
    assert result["converged_all"].all()
    launched = ck.MG_LAUNCHES > counts[0] and ck.MGT_LAUNCHES > counts[1]
    assert launched == (matvec != "xla")
    assert (ck.MG_PLAIN_CALLS, ck.MGT_PLAIN_CALLS) == counts[2:]


# The Krylov loops on the card (solve.krylov): each step replayed from a
# CUDA graph captured once per solve, the exit read once per chunk.


def _card_system(dev, m=46, n=46):
    """Three EL systems (the normalised alphas of ``ALPHAS``) on the card
    with the default solver's operators: kernel B1's matvec and the
    multigrid hierarchy on kernels B5 and B6."""
    import functools

    from opticalflow_tpu_torch.flow import variational
    from opticalflow_tpu_torch.solve import multigrid

    frames = torch.from_numpy(_frames(m, n, len(ALPHAS) + 1)).to(dev)
    frames = frames / frames.abs().max()
    prev, cur = frames[:-1].contiguous(), frames[1:].contiguous()
    a_s = torch.tensor([a for a, _ in ALPHAS], device=dev)
    a_r = torch.tensor([a for _, a in ALPHAS], device=dev)
    pair = elop.compute_frame_pair_data(prev, cur, a_s, a_r, "compat")
    matvec = variational._make_matvec("auto", prev, a_s, a_r, "compat", pair.coeffs)
    h = multigrid.setup(matvec, elop.diag_blocks(pair.coeffs), m, n, torch.float32,
                        route="kernels")
    return matvec, pair.rhs[:, :, 1:-1, 1:-1].contiguous(), functools.partial(multigrid.v_cycle, h)


def _laplacian_system(dev):
    """Symmetric positive definite systems for CG: (4 + s) u minus the four
    neighbours (zero outside), a shift per pair, and its Jacobi
    preconditioner."""
    import torch.nn.functional as F

    s = torch.tensor([0.05, 0.5, 0.005], device=dev)[:, None, None, None]

    def matvec(u):
        p = F.pad(u, (1, 1, 1, 1))
        return (4.0 + s) * u - (p[..., :-2, 1:-1] + p[..., 2:, 1:-1] + p[..., 1:-1, :-2]
                                + p[..., 1:-1, 2:])

    b = torch.randn(3, 3, 40, 50, device=dev, generator=torch.Generator(dev).manual_seed(3))
    return matvec, b, lambda r: r / (4.0 + s)


def _assert_same_result(res, ref):
    from opticalflow_tpu_torch.solve import krylov

    for field in krylov.KrylovResult._fields:
        assert torch.equal(getattr(res, field), getattr(ref, field)), field


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["bicgstab", "cg"])
def test_graphed_krylov_solve_equals_its_uncaptured_steps(method):
    """The solve replayed from its CUDA graph and the same steps run on the
    card without capture (``krylov._uncaptured``): the same bits, and the
    same kernel launches counted (a capture's counts added per replay)."""
    from opticalflow_tpu_torch.solve import krylov
    from opticalflow_tpu_torch.utils import observability

    dev = _cuda()
    if method == "bicgstab":
        matvec, b, precond = _card_system(dev)
    else:
        matvec, b, precond = _laplacian_system(dev)
    solve = getattr(krylov, method)
    kw = dict(precond=precond, rtol=1e-6, max_iterations=300)
    observability.reset()
    launches = ck.LAUNCHES, ck.MG_LAUNCHES, ck.MGT_LAUNCHES
    graphed = solve(matvec, b, **kw)
    graphed_launches = (ck.LAUNCHES - launches[0], ck.MG_LAUNCHES - launches[1],
                        ck.MGT_LAUNCHES - launches[2])
    counts = observability.counts()
    assert counts["krylov/graph_captures"] == 1 and counts["krylov/graph_replays"] > 0
    launches = ck.LAUNCHES, ck.MG_LAUNCHES, ck.MGT_LAUNCHES
    with krylov._uncaptured():
        eager = solve(matvec, b, **kw)
    assert (ck.LAUNCHES - launches[0], ck.MG_LAUNCHES - launches[1],
            ck.MGT_LAUNCHES - launches[2]) == graphed_launches
    assert observability.counts()["krylov/graph_captures"] == 1  # none more
    _assert_same_result(graphed, eager)
    assert (graphed.iterations > 1).all()


@pytest.mark.gpu
def test_launch_counters_are_exact_under_replay():
    """A V-cycle of the sweep's shape (126x126, 5 levels, Jacobi, 2 sweeps)
    captured as a Krylov step and replayed: 4 B1, 10 B5 and 8 B6 launches
    counted per replay (22), no plain call, the eager V-cycle's bits."""
    from opticalflow_tpu_torch.solve import krylov

    dev = _cuda()
    _, b, precond = _card_system(dev, 126, 126)
    out = torch.empty_like(b)
    step = krylov._Step(lambda: out.copy_(precond(b)), dev)
    step()  # runs once, then captures
    assert step.graph is not None and step.counts == {"LAUNCHES": 4, "MG_LAUNCHES": 10,
                                                      "MGT_LAUNCHES": 8}
    before = ck.LAUNCHES, ck.MG_LAUNCHES, ck.MGT_LAUNCHES, ck.MG_PLAIN_CALLS, ck.MGT_PLAIN_CALLS
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    after = ck.LAUNCHES, ck.MG_LAUNCHES, ck.MGT_LAUNCHES, ck.MG_PLAIN_CALLS, ck.MGT_PLAIN_CALLS
    assert tuple(a - c for a, c in zip(after, before)) == (12, 30, 24, 0, 0)
    assert torch.equal(out, precond(b))


@pytest.mark.gpu
@pytest.mark.parametrize("gpus", [1, 2])
def test_threads_capture_thread_locally(gpus):
    """Two threads solving at once, each capturing its graph on its own
    stream (one card, or a GPU each where the machine has two): the bits of
    the same solves one after another."""
    from concurrent.futures import ThreadPoolExecutor

    from opticalflow_tpu_torch.solve import krylov

    devices = [_cuda()] * 2 if gpus == 1 else _two_gpus()
    systems = [_card_system(d) for d in devices]

    def solve(i):
        with torch.cuda.device(devices[i]):
            matvec, b, precond = systems[i]
            return krylov.bicgstab(matvec, b, precond=precond, rtol=1e-6)

    serial = [solve(i) for i in range(2)]
    with ThreadPoolExecutor(2) as pool:
        threaded = list(pool.map(solve, range(2)))
    for res, ref in zip(threaded, serial):
        _assert_same_result(res, ref)


@pytest.mark.gpu
def test_refinement_subsets_each_capture_and_replay(monkeypatch):
    """A batch of four pairs whose refinement stops apart: the main solve
    and every correction solve, on the operators sliced to its active
    pairs, capture one graph and replay it; the whole solve equals the same
    solve with its steps uncaptured, bit for bit."""
    from opticalflow_tpu_torch.flow import variational
    from opticalflow_tpu_torch.solve import krylov
    from opticalflow_tpu_torch.utils import observability

    dev = _cuda()
    movie, _ = make_translating_blob_movie(n_frames=2, dimension=40, width=20.0, sigma=3.0,
                                           v_x=0.15, v_y=0.1)
    movie = torch.from_numpy((movie * 100.0).astype(np.float32)).to(dev)
    prev, cur = movie[:1].expand(4, 40, 40), movie[1:].expand(4, 40, 40)
    a_s = torch.tensor([100.0, 300.0, 3000.0, 1e5], device=dev)
    a_r = torch.tensor([300.0, 1000.0, 100.0, 1e5], device=dev)
    calls, bicgstab = [], krylov.bicgstab

    def counted(matvec, b, **kw):
        before = observability.counts()
        res = bicgstab(matvec, b, **kw)
        after = observability.counts()
        calls.append((b.shape[0], *(after.get(k, 0) - before.get(k, 0)
                                    for k in ("krylov/graph_captures", "krylov/graph_replays"))))
        return res

    monkeypatch.setattr(krylov, "bicgstab", counted)
    u, info = variational.solve_frame_pair(prev, cur, torch.zeros(3, 40, 40, device=dev), a_s,
                                           a_r)
    assert len(calls) >= 2 and min(batch for batch, _, _ in calls) < 4  # sliced subsets
    assert all(captures == 1 and replays > 0 for _, captures, replays in calls), calls
    with krylov._uncaptured():
        u_e, info_e = variational.solve_frame_pair(prev, cur, torch.zeros(3, 40, 40, device=dev),
                                                   a_s, a_r)
    assert torch.equal(u, u_e) and info["converged"].all()
    for key in info:
        assert torch.equal(info[key], info_e[key]), key
