"""The port's sharded solve (``opticalflow_tpu_torch.parallel``) against the
JAX package's (``opticalflow_tpu.parallel``), on the CPU.

The meshes here are lists of ``torch.device('cpu')``, one device named
several times, as the JAX tests use 8 virtual CPU devices (the routes for
distinct devices are forced on them or use two CPU indices, as in
tests/test_torch_multidevice.py); on the CPU kernel B3's wrapper runs its
plain version.

Tolerances:
* meshes: the same axis sizes and the same errors as JAX's ``make_mesh``;
* the tiled matvecs against the untiled ``elop.el_matvec_reduced`` of the
  JAX package, float64: max|a - b| <= 1e-12 * max|b| (the same arithmetic
  on the same values; only the order of a few sums may differ);
* the tiled kernel matvec against JAX's ``make_sharded_kernel_matvec``
  (Pallas in interpret mode), float32: 1e-5 * max|b| per field, a few
  ulps of the largest term, as in tests/test_torch_ext_kernel.py;
* the sharded solve against JAX's float64 solve on a (1, 1, 1) mesh (one
  compile serves both dtypes of the port): the port in float64 to rtol
  1e-3, atol 1e-4 (JAX's own bound between meshes,
  tests/test_parallel.py:73: solutions agree to the solve tolerance, not
  bitwise); the port in float32 to rtol 5e-3, atol 5e-4 (JAX's bound for
  its float32 sharded solve, tests/test_parallel.py:117).
"""

from torch_threads import one_intra_op_thread  # noqa: F401,I001 (autouse; first: see its module)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflow_tpu.core.synth import make_translating_blob_movie
from opticalflow_tpu.ops import elop as jelop
from opticalflow_tpu.ops import pallas_kernels as pk
from opticalflow_tpu.parallel import batch as jbatch
from opticalflow_tpu.parallel import mesh as jmesh
from opticalflow_tpu.parallel import pallas_spmd
from opticalflow_tpu_torch.core.types import SolverConfig
from opticalflow_tpu_torch.ops import cuda_kernels as ck
from opticalflow_tpu_torch.parallel import batch, spmd
from opticalflow_tpu_torch.parallel import mesh as pmesh

CPU = torch.device("cpu")
ALPHAS = dict(speed_alpha=500.0, remodelling_alpha=500.0)


def cpu_mesh(frames, tx, ty):
    return pmesh.make_mesh([CPU] * (frames * tx * ty), frames=frames, tx=tx, ty=ty)


@pytest.fixture(scope="module")
def movie():
    """tests/test_parallel.py's movie: 5 frames of 32x32 (4 pairs)."""
    movie, _ = make_translating_blob_movie(
        n_frames=5, dimension=32, width=10.0, sigma=2.0, v_x=0.1, v_y=0.05)
    return np.asarray(movie) * 100.0


@pytest.fixture(scope="module")
def jax_solution(movie):
    """JAX's sharded solve on a (1, 1, 1) mesh, float64 (one compile)."""
    single = jmesh.make_mesh(jax.devices()[:1], frames=1, tx=1, ty=1)
    u, infos = jbatch.sharded_variational_solve(movie, mesh=single, dtype=jnp.float64, **ALPHAS)
    assert np.asarray(infos["converged"]).all()
    return np.asarray(u)


# the cases of tests/test_parallel.py:28-55: (device count, make_mesh kwargs)
MESH_CASES = [
    (8, {}), (8, dict(frames=2, tx=2, ty=2)), (8, dict(frames=3, tx=2, ty=2)),
    (8, dict(frames=1)), (8, dict(frames=2, tx=2)), (8, dict(ty=2)),
    (8, dict(workload="single_pair")), (6, dict(workload="single_pair")), (8, dict(frames=3)),
    (8, dict(workload="nope")), (4, {}), (1, {}), (6, dict(tx=3)),
]


@pytest.mark.parametrize("n,kwargs", MESH_CASES)
def test_make_mesh_matches_jax(n, kwargs):
    try:
        want = dict(jmesh.make_mesh(jax.devices()[:n], **kwargs).shape)
    except ValueError:
        with pytest.raises(ValueError):
            pmesh.make_mesh([CPU] * n, **kwargs)
        return
    mesh = pmesh.make_mesh([CPU] * n, **kwargs)
    assert mesh.shape == want
    assert mesh.devices.shape == tuple(want.values()) and mesh.device() == CPU


def _frames_and_field(B, m, n, K, seed):
    rng = np.random.default_rng(seed)
    prev = rng.normal(size=(B, m + 2, n + 2))
    u = rng.normal(size=(B, K, 3, m, n))
    return prev, u


@pytest.mark.parametrize("tiles", [(2, 2), (1, 4), (4, 2), (1, 1)])
@pytest.mark.parametrize("factory", [spmd.make_sharded_kernel_matvec,
                                     spmd.make_sharded_xla_matvec])
def test_tiled_matvecs_equal_the_untiled_matvec(tiles, factory):
    """Tile seams, global edges and the doubled global corners: a halo
    fault gives O(1) errors there."""
    B, m, n, K = 2, 24, 24, 3
    prev, u = _frames_and_field(B, m, n, K, seed=5)
    a_s, a_r = np.array([700.0, 40.0]), np.array([800.0, 2000.0])
    mesh = cpu_mesh(1, *tiles)
    for dy_mode in ("compat", "fixed"):
        mv = factory(mesh, torch.from_numpy(prev), torch.from_numpy(a_s), torch.from_numpy(a_r),
                     dy_mode)
        y1 = mv(torch.from_numpy(u[:, 0])).numpy()
        yk = mv(torch.from_numpy(u)).numpy()
        for b in range(B):
            pair = jelop.compute_frame_pair_data(jnp.asarray(prev[b]), jnp.asarray(prev[b]),
                                                 a_s[b], a_r[b], dy_mode)
            for k in range(K):
                ref = np.asarray(jelop.el_matvec_reduced(pair.coeffs, jnp.asarray(u[b, k])))
                tol = 1e-12 * np.abs(ref).max()
                np.testing.assert_allclose(yk[b, k], ref, rtol=0, atol=tol)
                if k == 0:
                    np.testing.assert_allclose(y1[b], ref, rtol=0, atol=tol)


def test_tiled_kernel_matvec_matches_jax_pallas_spmd(monkeypatch):
    monkeypatch.setattr(pk, "INTERPRET", True)
    m = n = 24
    prev, u = _frames_and_field(1, m, n, 1, seed=11)
    prev = (1.0 + 0.3 * prev[0]).astype(np.float32)
    u = u[0, 0].astype(np.float32)
    a_s, a_r = np.float32(0.1), np.float32(1000.0)
    jax_mesh = jmesh.make_mesh(jax.devices()[:4], frames=1, tx=2, ty=2)
    want = np.asarray(jax.jit(pallas_spmd.make_sharded_kernel_matvec(
        jax_mesh, jnp.asarray(prev), a_s, a_r, "compat"))(jnp.asarray(u)))
    plain = ck.EXT_PLAIN_CALLS
    mv = spmd.make_sharded_kernel_matvec(cpu_mesh(1, 2, 2), torch.from_numpy(prev)[None],
                                         float(a_s), float(a_r), "compat")
    got = mv(torch.from_numpy(u)[None])[0].numpy()
    assert ck.EXT_PLAIN_CALLS == plain + 1
    for q in range(3):
        assert np.abs(got[q] - want[q]).max() <= 1e-5 * np.abs(want[q]).max(), q


def test_tiled_matvecs_raise_on_an_interior_that_does_not_tile():
    prev, _ = _frames_and_field(1, 24, 24, 1, seed=0)
    for factory in (spmd.make_sharded_kernel_matvec, spmd.make_sharded_xla_matvec):
        with pytest.raises(ValueError, match="tile evenly"):
            factory(cpu_mesh(1, 5, 1), torch.from_numpy(prev), 1.0, 1.0, "compat")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("matvec", ["pallas", "xla"])
@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 2, 2), (2, 2, 2), (4, 1, 1)])
def test_sharded_solve_matches_jax(movie, jax_solution, shape, matvec, dtype):
    plain = ck.EXT_PLAIN_CALLS, ck.PLAIN_CALLS, ck.CORE_PLAIN_CALLS
    u, infos = batch.sharded_variational_solve(
        movie, mesh=cpu_mesh(*shape), solver=SolverConfig(matvec=matvec), dtype=dtype, **ALPHAS)
    # 'pallas' runs B3 (here its plain version) and nothing else
    assert (ck.EXT_PLAIN_CALLS > plain[0]) == (matvec == "pallas")
    assert (ck.PLAIN_CALLS, ck.CORE_PLAIN_CALLS) == plain[1:]
    assert u.shape == (4, 3, 32, 32) and u.dtype == dtype and u.device == CPU
    assert bool(infos["converged"].all())
    rtol, atol = (1e-3, 1e-4) if dtype == torch.float64 else (5e-3, 5e-4)
    np.testing.assert_allclose(u.numpy(), jax_solution, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("matvec", ["pallas", "xla"])
@pytest.mark.parametrize("shape", [(1, 2, 2), (1, 3, 1)])
def test_exchange_route_matches_jax(movie, jax_solution, shape, matvec, dtype):
    """The distinct-device route (seams exchanged between tiles), forced on
    one device: bitwise the windows route's solve, and within the bounds of
    test_sharded_solve_matches_jax of JAX's (the 30x30 interior tiles over
    (1, 2, 2) and (1, 3, 1))."""
    kw = dict(mesh=cpu_mesh(*shape), solver=SolverConfig(matvec=matvec), dtype=dtype, **ALPHAS)
    m = torch.as_tensor(movie, dtype=dtype)
    u, infos = batch._mesh_solve(m[:-1], m[1:], m.new_zeros((3,) + tuple(m.shape[1:])),
                                 ALPHAS["speed_alpha"], ALPHAS["remodelling_alpha"],
                                 kw["solver"], "compat", kw["mesh"], as_distinct=True)
    u_w, infos_w = batch.sharded_variational_solve(movie, **kw)
    torch.testing.assert_close(u, u_w, rtol=0, atol=0)
    assert infos["iterations"].tolist() == infos_w["iterations"].tolist()
    assert bool(infos["converged"].all())
    rtol, atol = (1e-3, 1e-4) if dtype == torch.float64 else (5e-3, 5e-4)
    np.testing.assert_allclose(u.numpy(), jax_solution, rtol=rtol, atol=atol)


def test_frames_only_mesh_solves_each_block_alone(movie):
    """A (4, 1, 1) mesh solves its 4 pairs as 4 batches of one; each equals
    the same pair solved alone, bitwise (the same arithmetic)."""
    kw = dict(solver=SolverConfig(matvec="pallas"), dtype=torch.float64, **ALPHAS)
    u4, infos4 = batch.sharded_variational_solve(movie, mesh=cpu_mesh(4, 1, 1), **kw)
    for k in (0, 3):
        u1, infos1 = batch.sharded_variational_solve(movie[k : k + 2], mesh=cpu_mesh(1, 1, 1),
                                                     **kw)
        torch.testing.assert_close(u4[k : k + 1], u1, rtol=0, atol=0)
        assert int(infos4["iterations"][k]) == int(infos1["iterations"][0])


@pytest.mark.parametrize("matvec,shape,counter", [
    ("auto", (1, 2, 2), "PLAIN_CALLS"), ("auto", (1, 1, 1), "PLAIN_CALLS"),
    ("pallas", (1, 2, 2), "EXT_PLAIN_CALLS"), ("hybrid", (2, 1, 1), "CORE_PLAIN_CALLS"),
    ("gspmd", (1, 2, 2), None), ("xla", (1, 4, 1), None),
])
def test_matvec_routes(movie, matvec, shape, counter):
    """'auto' is B1 untiled on any mesh of one device, a tiling one
    included; 'pallas' is B3; 'hybrid' is B2 untiled; 'gspmd' and 'xla'
    where the interior does not tile are the plain untiled stencil."""
    names = ("EXT_PLAIN_CALLS", "PLAIN_CALLS", "CORE_PLAIN_CALLS")
    before = {name: getattr(ck, name) for name in names}
    u, infos = batch.sharded_variational_solve(movie[:2], mesh=cpu_mesh(*shape),
                                               solver=SolverConfig(matvec=matvec), **ALPHAS)
    assert bool(infos["converged"].all()) and bool(torch.isfinite(u).all())
    for name in names:
        assert (getattr(ck, name) > before[name]) == (name == counter), name


def test_hybrid_on_a_tiling_mesh_and_distinct_devices_raise(movie):
    """'hybrid' on a tiling mesh raises; so does a mesh whose devices are
    of distinct types (devices of one type may be distinct:
    test_distinct_devices_solve)."""
    with pytest.raises(ValueError, match="hybrid"):
        batch.sharded_variational_solve(movie[:2], mesh=cpu_mesh(1, 2, 2),
                                        solver=SolverConfig(matvec="hybrid"), **ALPHAS)
    with pytest.raises(ValueError, match="one type"):
        pmesh.make_mesh([CPU, torch.device("meta")], frames=1, tx=2, ty=1)


@pytest.mark.parametrize("shape", [(1, 2, 1), (2, 1, 1)])
def test_distinct_devices_solve(movie, shape):
    """A mesh over distinct devices solves: the tiles exchange seams, the
    frames rows run in workers, and the result equals the one-device mesh's
    bitwise.  The CPU has no distinct devices, so the mesh names two CPU
    indices; the mesh treats them as distinct, and tensors on either lie on
    the CPU."""
    distinct = pmesh.make_mesh([torch.device("cpu", 0), torch.device("cpu", 1)],
                               frames=shape[0], tx=shape[1], ty=1)
    assert distinct.distinct and not cpu_mesh(*shape).distinct
    kw = dict(solver=SolverConfig(matvec="pallas"), dtype=torch.float64, **ALPHAS)
    u, infos = batch.sharded_variational_solve(movie, mesh=distinct, **kw)
    u1, infos1 = batch.sharded_variational_solve(movie, mesh=cpu_mesh(*shape), **kw)
    torch.testing.assert_close(u, u1, rtol=0, atol=0)
    assert infos["iterations"].tolist() == infos1["iterations"].tolist()


def test_entry_points_run_on_the_card_or_raise(movie):
    """No device given means CUDA, for an array and for a CPU tensor alike:
    without a card every entry point raises instead of running on the
    CPU."""
    from opticalflow_tpu_torch import variational_optical_flow
    from opticalflow_tpu_torch.flow.variational import profile_solve_phases
    from opticalflow_tpu_torch.parallel import distributed

    if torch.cuda.is_available():
        assert pmesh.make_mesh().device().type == "cuda"
        return
    pair = movie[:2].astype(np.float32)
    calls = [
        lambda: pmesh.make_mesh(),
        lambda: batch.sharded_variational_solve(pair, **ALPHAS),
        lambda: distributed.multihost_mesh(),
        lambda: variational_optical_flow(pair, **ALPHAS),
        lambda: variational_optical_flow(torch.from_numpy(pair), **ALPHAS),
        lambda: profile_solve_phases(pair[0], pair[1], reps=1),
    ]
    # the analysis path's entry points, each for an array and a CPU tensor
    from opticalflow_tpu_torch import conduct_optical_flow
    from opticalflow_tpu_torch.analysis import hyperparams, statistics, sweeps, tuning
    from opticalflow_tpu_torch.flow.liushen import conduct_variational_optical_flow_deprecated
    from opticalflow_tpu_torch.ops import clahe, resize, threshold

    movie4 = movie[:4].astype(np.float32)
    entry_points = [
        lambda m: sweeps.vary_regularisation(m, [500.0], [500.0]),
        lambda m: sweeps.vary_regularisation(m, [500.0], [500.0], batched=False),
        lambda m: tuning.optimize_regularisation_parameters(m, shgo_kwargs={"n": 2}),
        lambda m: tuning.optimize_regularisation_parameters(m, use_direct_solver=False,
                                                            shgo_kwargs={"n": 2}),
        lambda m: conduct_optical_flow(m, boxsize=7),
        lambda m: hyperparams.vary_boxsize(m, boxsizes=[5, 7], frame_index=1),
        lambda m: hyperparams.vary_blursize(m, blur_sizes=[1.0], frame_index=1),
        lambda m: statistics.correct_intensity_change(m),
        lambda m: resize.area_resize_movie(m, 16, 16),
        lambda m: resize.downsample_movie(m, 0.5),
        lambda m: threshold.apply_adaptive_threshold(m, window_size=5),
        lambda m: clahe.apply_clahe(m, tile_number=2),
        lambda m: conduct_variational_optical_flow_deprecated(m, use_liu_shen=True),
    ]
    for entry in entry_points:
        calls += [lambda e=entry: e(movie4), lambda e=entry: e(torch.from_numpy(movie4))]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
