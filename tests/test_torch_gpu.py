"""Tests of the port that need a CUDA device; they skip without one.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_gpu.py -q --noconftest

(``--noconftest`` skips tests/conftest.py, which configures JAX.)

Tolerances: a kernel and its plain version are both float32 on the same
card and differ only by rounding (multiply-add contraction and summation
order), a few ulps of the largest term: each field is held to
``max|a - b| <= 1e-5 * max|b|``; so is the hybrid matvec (plain-stencil
kernel plus the boundary ring) against the fused kernel's plain version.
Kernel B3 (``el_matvec_extended``) and the tiled matvec of the sharded
solve are held to the same bound, against B3's plain version and B1's.
The solve on the card and the same solve on the CPU converge to the same
system to within the refinement exit (0.1 x tol), far inside 1e-4 px;
measured on the CPU the port and the JAX package agree to ~1e-5 px at this
size.  A small batched sweep on the card launches B1 with no plain call and
matches the CPU's sweep to 1e-4 relative; box flow on the card is held to
the CPU's own float32 accuracy against the CPU's float64 run.  The routes
of meshes over distinct devices, forced on the one card, and the meshes
over two GPUs (which skip on a machine with one) are held bitwise against
the one-device routes: the same per-block arithmetic.
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
    counts = ck.EXT_LAUNCHES, ck.EXT_PLAIN_CALLS, ck.LAUNCHES
    u_card, info = sharded_variational_solve(movie, mesh=pmesh.make_mesh(frames=1, tx=2, ty=2,
                                                                         devices=[dev] * 4), **kw)
    assert ck.EXT_LAUNCHES > counts[0] and (ck.EXT_PLAIN_CALLS, ck.LAUNCHES) == counts[1:]
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
    on_card = variational_optical_flow(torch.from_numpy(movie).to(dev), **kw)
    assert ck.LAUNCHES > launches and ck.PLAIN_CALLS == plain
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
    counts = ck.CORE_LAUNCHES, ck.CORE_PLAIN_CALLS, ck.LAUNCHES
    on_card = variational_optical_flow(torch.from_numpy(movie).to(dev), **kw)
    assert ck.CORE_LAUNCHES > counts[0] and (ck.CORE_PLAIN_CALLS, ck.LAUNCHES) == counts[1:]
    on_cpu = variational_optical_flow(movie, device="cpu", **kw)
    assert on_card["converged_all"].all() and on_cpu["converged_all"].all()
    epe = np.sqrt((on_card["v_x"] - on_cpu["v_x"]) ** 2 + (on_card["v_y"] - on_cpu["v_y"]) ** 2)
    assert epe[:, 1:-1, 1:-1].max() < 1e-4


@pytest.mark.gpu
def test_sweep_on_the_card_runs_the_kernel_and_matches_the_cpu():
    """A 2 x 2 grid on a 3-frame 40x40 movie, batched on the card: B1
    launched, no plain call; every statistic within 1e-4 relative of the
    same sweep on the CPU (both refine to 0.1 x tol)."""
    from opticalflow_tpu_torch.analysis.sweeps import vary_regularisation

    dev = _cuda()
    movie, _ = make_translating_blob_movie(n_frames=3, dimension=40, width=20.0, sigma=3.0,
                                           v_x=0.15, v_y=0.1)
    movie = (movie * 100.0).astype(np.float32)
    grid = ([300.0, 3000.0], [500.0, 5000.0])
    counts = ck.LAUNCHES, ck.PLAIN_CALLS
    on_card = vary_regularisation(movie, *grid, device=dev)
    assert ck.LAUNCHES > counts[0] and ck.PLAIN_CALLS == counts[1]
    on_cpu = vary_regularisation(movie, *grid, device="cpu")
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
