"""The port's meshes over distinct devices, on the CPU: the seam exchange
of parallel.spmd against the JAX package's ``pallas_spmd``, the exchange
route against the windows route, the frames workers against serial
blocks, ``multihost_mesh``'s shape rule against JAX's, and
``sharded_box_flow`` split over devices.

The CPU has one device, so these tests force the distinct-device routes
on meshes that name it several times (``as_distinct=True`` on the
factories and on the private ``batch._mesh_solve``), or build meshes over
two CPU indices (``torch.device('cpu', 0)`` and ``('cpu', 1)``), which the
mesh treats as distinct while every tensor lies on the CPU.  That second
form leans on release builds of PyTorch, which accept and ignore a CPU
index above 0 (c10 rejects it only in debug builds); the box flow's split
and the distributed solve have no forcing keyword and use it.  On the CPU
kernel B3's wrapper runs its plain version.

Tolerances:
* the exchanged blocks against JAX's under ``jax.shard_map`` (8 virtual
  CPU devices, tests/conftest.py), float32: equal, rtol = atol = 0 (the
  same copies, and one exact doubling at the global corners);
* the exchange route against the windows route, the workers against
  serial blocks, the box flow split over devices against one device:
  bitwise equal (the same arithmetic on the same values, per block);
* the tiled matvecs against ``elop.el_matvec_reduced``, float64: max|a -
  b| <= 1e-12 * max|b|, as tests/test_torch_parallel.py, which also holds
  the exchange route's solve against the JAX package's.
"""

from torch_threads import one_intra_op_thread  # noqa: F401,I001 (autouse; first: see its module)

import socket
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from opticalflow_tpu.core.synth import make_translating_blob_movie
from opticalflow_tpu.ops import pallas_kernels as pk
from opticalflow_tpu.parallel import distributed as jdistributed
from opticalflow_tpu.parallel import mesh as jmesh
from opticalflow_tpu.parallel import pallas_spmd
from opticalflow_tpu_torch.core import stencils
from opticalflow_tpu_torch.core.types import SolverConfig
from opticalflow_tpu_torch.ops import cuda_kernels as ck
from opticalflow_tpu_torch.ops import elop
from opticalflow_tpu_torch.parallel import batch, distributed, spmd
from opticalflow_tpu_torch.parallel import mesh as pmesh
from opticalflow_tpu_torch.solve import krylov
from opticalflow_tpu_torch.utils import observability

CPU = torch.device("cpu")
TWO_CPUS = [torch.device("cpu", 0), torch.device("cpu", 1)]
ALPHAS = dict(speed_alpha=500.0, remodelling_alpha=500.0)


def cpu_mesh(frames, tx, ty):
    return pmesh.make_mesh([CPU] * (frames * tx * ty), frames=frames, tx=tx, ty=ty)


def forced_solve(movie, mesh, solver=None, dtype=torch.float32, speed_alpha=1.0,
                 remodelling_alpha=1000.0):
    """``sharded_variational_solve``'s solve with the distinct-device routes
    forced (``batch._mesh_solve(..., as_distinct=True)``)."""
    m = torch.as_tensor(movie).to(device=mesh.device(), dtype=dtype)
    return batch._mesh_solve(m[:-1], m[1:], m.new_zeros((3,) + tuple(m.shape[1:])), speed_alpha,
                             remodelling_alpha, solver or SolverConfig(), stencils.DY_COMPAT,
                             mesh, as_distinct=True)


@pytest.fixture(scope="module")
def movie():
    """tests/test_parallel.py's movie at 34x34 (5 frames, 4 pairs): its
    32x32 interior tiles over (1, 2, 2) and (1, 4, 1)."""
    movie, _ = make_translating_blob_movie(
        n_frames=5, dimension=34, width=10.0, sigma=2.0, v_x=0.1, v_y=0.05)
    return np.asarray(movie) * 100.0


def _blocks_of(array, tx, ty):
    """The (p, q) blocks of a (..., tx * a, ty * b) array."""
    a, b = array.shape[-2] // tx, array.shape[-1] // ty
    return [[array[..., p * a : (p + 1) * a, q * b : (q + 1) * b] for q in range(ty)]
            for p in range(tx)]


@pytest.mark.parametrize("tiles", [(2, 2), (4, 1), (1, 4)])
def test_exchange_equals_jax_pallas_spmd(tiles):
    """Per-tile extended field and frame blocks, tile by tile, against
    ``_exchange_and_extend_u`` / ``_exchange_frame`` under shard_map."""
    tx, ty = tiles
    m = n = 16
    rng = np.random.default_rng(3)
    u = rng.normal(size=(3, m, n)).astype(np.float32)
    frame = rng.normal(size=(m + 2, n + 2)).astype(np.float32)

    def local(u_loc, i_loc, top, bottom, left, right):
        return (pallas_spmd._exchange_and_extend_u(u_loc),
                pallas_spmd._exchange_frame(i_loc, top, bottom, left, right))

    jax_mesh = jmesh.make_mesh(jax.devices()[: tx * ty], frames=1, tx=tx, ty=ty)
    fn = jax.jit(jax.shard_map(local, mesh=jax_mesh,
                               in_specs=(P(None, "tx", "ty"), P("tx", "ty"), P(), P(), P(), P()),
                               out_specs=(P(None, "tx", "ty"), P("tx", "ty")), check_vma=False))
    want_u, want_f = (np.asarray(x) for x in fn(
        jnp.asarray(u), jnp.asarray(frame[1:-1, 1:-1]), jnp.asarray(frame[0]),
        jnp.asarray(frame[-1]), jnp.asarray(frame[:, 0]), jnp.asarray(frame[:, -1])))

    devices = cpu_mesh(1, tx, ty).devices[0]
    seams = spmd.SEAM_COPIES
    got_u = spmd.exchange_and_extend_u(spmd.split_tiles(torch.from_numpy(u), devices))
    assert spmd.SEAM_COPIES - seams == 2 * tx * (ty - 1) + 2 * ty * (tx - 1)
    f = torch.from_numpy(frame)[None]
    got_f = spmd.exchange_frame(spmd.split_tiles(f[:, 1:-1, 1:-1], devices), f[:, 0], f[:, -1],
                                f[:, :, 0], f[:, :, -1])
    # the windows route's blocks are the same (the windows of one extension)
    windows = spmd.to_tiles(elop.extend_interior(torch.from_numpy(u)[None]), tx, ty)
    for p in range(tx):
        for q in range(ty):
            np.testing.assert_allclose(got_u[p][q].numpy(), _blocks_of(want_u, tx, ty)[p][q],
                                       rtol=0, atol=0)
            np.testing.assert_allclose(got_f[p][q][0].numpy(), _blocks_of(want_f, tx, ty)[p][q],
                                       rtol=0, atol=0)
            torch.testing.assert_close(got_u[p][q], windows[p * ty + q], rtol=0, atol=0)


@pytest.mark.parametrize("dy_mode", ["compat", "fixed"])
@pytest.mark.parametrize("factory", [spmd.make_sharded_kernel_matvec,
                                     spmd.make_sharded_xla_matvec])
@pytest.mark.parametrize("tiles", [(2, 2), (4, 1), (1, 4), (3, 2)])
def test_exchange_route_matvec_equals_the_windows_route(tiles, factory, dy_mode):
    """K = 1 and the probes' K = 27: bitwise equal to the windows route,
    both within float64 rounding of the untiled matvec; one kernel call
    per tile and the seams of one exchange per application."""
    B, m, n = 2, 24, 24
    rng = np.random.default_rng(7)
    prev = torch.from_numpy(rng.normal(size=(B, m + 2, n + 2)))
    a_s, a_r = torch.tensor([700.0, 40.0], dtype=torch.float64), torch.tensor([800.0, 2000.0],
                                                                              dtype=torch.float64)
    mesh = cpu_mesh(1, *tiles)
    windows = factory(mesh, prev, a_s, a_r, dy_mode)
    exchange = factory(mesh, prev, a_s, a_r, dy_mode, as_distinct=True)
    pair = elop.compute_frame_pair_data(prev, prev, a_s, a_r, dy_mode)
    T = tiles[0] * tiles[1]
    for K in (1, 27):
        u = torch.from_numpy(rng.normal(size=(B, 3, m, n) if K == 1 else (B, K, 3, m, n)))
        calls, seams = ck.EXT_PLAIN_CALLS, spmd.SEAM_COPIES
        got = exchange(u)
        if factory is spmd.make_sharded_kernel_matvec:
            assert ck.EXT_PLAIN_CALLS - calls == T
        assert spmd.SEAM_COPIES - seams == 2 * tiles[0] * (tiles[1] - 1) + 2 * tiles[1] * (
            tiles[0] - 1)
        torch.testing.assert_close(got, windows(u), rtol=0, atol=0)
        coeffs = pair.coeffs if K == 1 else elop.with_probe_axis(pair.coeffs)
        ref = elop.el_matvec_reduced(coeffs, u)
        assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


@pytest.mark.parametrize("route", ["windows", "exchange"])
@pytest.mark.parametrize("tiles", [(2, 2), (4, 1), (1, 4)])
def test_tiled_kernel_matvec_routes_match_jax_pallas_spmd(monkeypatch, tiles, route):
    """Both routes of the port's tiled matvec on kernel B3 (its plain
    version on the CPU: the whole field in one call, or each tile and its
    halo lines) against JAX's ``pallas_spmd.make_sharded_kernel_matvec``
    under ``jax.shard_map`` (the v2 kernel in interpret mode), float32,
    ``max|a - b| <= 1e-5 * max|b|`` per field (tests/test_torch_parallel.py's
    bound: the same term order, other rounding)."""
    monkeypatch.setattr(pk, "INTERPRET", True)
    tx, ty = tiles
    m = n = 16
    rng = np.random.default_rng(13)
    prev = (1.0 + 0.3 * rng.normal(size=(m + 2, n + 2))).astype(np.float32)
    u = rng.normal(size=(3, m, n)).astype(np.float32)
    a_s, a_r = np.float32(0.1), np.float32(1000.0)
    jax_mesh = jmesh.make_mesh(jax.devices()[: tx * ty], frames=1, tx=tx, ty=ty)
    want = np.asarray(jax.jit(pallas_spmd.make_sharded_kernel_matvec(
        jax_mesh, jnp.asarray(prev), a_s, a_r, "compat"))(jnp.asarray(u)))
    plain = ck.EXT_PLAIN_CALLS
    mv = spmd.make_sharded_kernel_matvec(cpu_mesh(1, tx, ty), torch.from_numpy(prev)[None],
                                         float(a_s), float(a_r), "compat",
                                         as_distinct=route == "exchange")
    got = mv(torch.from_numpy(u)[None])[0].numpy()
    assert ck.EXT_PLAIN_CALLS - plain == (1 if route == "windows" else tx * ty)
    for q in range(3):
        assert np.abs(got[q] - want[q]).max() <= 1e-5 * np.abs(want[q]).max(), q


def test_exchange_route_needs_tiles_of_two_pixels():
    prev = torch.zeros(1, 6, 6)
    with pytest.raises(ValueError, match="2x2"):
        spmd.make_sharded_kernel_matvec(cpu_mesh(1, 4, 1), prev, 1.0, 1.0, as_distinct=True)


@pytest.mark.parametrize("shape,matvec,dtype", [
    ((1, 2, 2), "pallas", torch.float32), ((1, 2, 2), "xla", torch.float64),
    ((1, 4, 1), "pallas", torch.float64), ((1, 4, 1), "xla", torch.float32)])
def test_sharded_solve_by_exchange_equals_windows(movie, shape, matvec, dtype):
    """The exchange route forced on one device: the windows route's solve,
    bitwise, with the same iterations (tests/test_torch_parallel.py holds
    both routes against the JAX package's solve)."""
    kw = dict(mesh=cpu_mesh(*shape), solver=SolverConfig(matvec=matvec), dtype=dtype, **ALPHAS)
    calls = ck.EXT_PLAIN_CALLS
    u, infos = forced_solve(movie, **kw)
    exchange_calls = ck.EXT_PLAIN_CALLS - calls
    calls = ck.EXT_PLAIN_CALLS
    u_w, infos_w = batch.sharded_variational_solve(movie, **kw)
    windows_calls = ck.EXT_PLAIN_CALLS - calls
    torch.testing.assert_close(u, u_w, rtol=0, atol=0)
    assert infos["iterations"].tolist() == infos_w["iterations"].tolist()
    assert bool(infos["converged"].all()) and u.shape == (4, 3, 34, 34)
    # 'pallas': one kernel call per tile on the exchange route, one for
    # every tile on the windows route
    tiles = shape[1] * shape[2] if matvec == "pallas" else 0
    assert exchange_calls == windows_calls * tiles, (exchange_calls, windows_calls)


@pytest.mark.parametrize("shape,matvec", [((2, 1, 1), "auto"), ((4, 1, 1), "pallas")])
def test_frames_workers_equal_serial_blocks(movie, shape, matvec):
    kw = dict(mesh=cpu_mesh(*shape), solver=SolverConfig(matvec=matvec), dtype=torch.float64,
              **ALPHAS)
    counts = ck.PLAIN_CALLS, ck.EXT_PLAIN_CALLS
    u, infos = forced_solve(movie, **kw)
    worker_calls = ck.PLAIN_CALLS - counts[0], ck.EXT_PLAIN_CALLS - counts[1]
    counts = ck.PLAIN_CALLS, ck.EXT_PLAIN_CALLS
    u_s, infos_s = batch.sharded_variational_solve(movie, **kw)
    assert worker_calls == (ck.PLAIN_CALLS - counts[0], ck.EXT_PLAIN_CALLS - counts[1])
    torch.testing.assert_close(u, u_s, rtol=0, atol=0)
    for key in infos:
        torch.testing.assert_close(infos[key], infos_s[key], rtol=0, atol=0)


def test_mixed_mesh_runs_a_worker_per_row_over_its_tiles(movie):
    """(2, 2, 1) over distinct devices: row f solves pairs 2f, 2f+1 by the
    exchange route, equal to those pairs on a (1, 2, 1) mesh of one
    device."""
    kw = dict(solver=SolverConfig(matvec="pallas"), dtype=torch.float64, **ALPHAS)
    u, _ = forced_solve(movie, mesh=cpu_mesh(2, 2, 1), **kw)
    for f in range(2):
        u_f, _ = batch.sharded_variational_solve(movie[2 * f : 2 * f + 3], mesh=cpu_mesh(1, 2, 1),
                                                 **kw)
        torch.testing.assert_close(u[2 * f : 2 * f + 2], u_f, rtol=0, atol=0)


def test_a_worker_exception_reaches_the_caller(movie, monkeypatch):
    solve = batch._batched_pair_solve
    failing = torch.as_tensor(movie[2], dtype=torch.float64)

    def fail_on_the_second_block(prev, *args, **kwargs):
        if torch.equal(prev[0], failing):
            raise RuntimeError("block 2 failed")
        return solve(prev, *args, **kwargs)

    monkeypatch.setattr(batch, "_batched_pair_solve", fail_on_the_second_block)
    with pytest.raises(RuntimeError, match="block 2 failed"):
        batch.sharded_variational_solve(movie, mesh=pmesh.make_mesh(TWO_CPUS, frames=2),
                                        dtype=torch.float64, **ALPHAS)


def test_meshes_of_mixed_device_types_raise():
    for other in ("meta", "cuda"):
        with pytest.raises(ValueError, match="one type"):
            pmesh.make_mesh([CPU, torch.device(other)], frames=2)
    assert pmesh.make_mesh(TWO_CPUS, frames=2).distinct
    assert not cpu_mesh(2, 1, 1).distinct


def test_a_mesh_resolves_device_indices(monkeypatch):
    """A CUDA device without an index is the current one, so ``cuda`` and
    ``cuda:0`` with 0 current are one device and take no distinct-device
    route; ``cpu:0`` is ``cpu``.  (No GPU is touched: the current device is
    faked.)"""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    same = pmesh.make_mesh([torch.device("cuda"), torch.device("cuda", 0)], frames=1, tx=2, ty=1)
    assert not same.distinct and not spmd.exchange_route(same)
    assert list(same.devices.flat) == [torch.device("cuda", 0)] * 2
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    two = pmesh.make_mesh([torch.device("cuda"), torch.device("cuda", 0)], frames=1, tx=2, ty=1)
    assert two.distinct and spmd.exchange_route(two) and two.device() == torch.device("cuda", 1)
    assert not pmesh.make_mesh([CPU, torch.device("cpu", 0)], frames=2).distinct
    assert not spmd.exchange_route(cpu_mesh(1, 2, 1)) and spmd.exchange_route(cpu_mesh(1, 2, 1),
                                                                              as_distinct=True)
    # a mesh of one tile has no seams to exchange, forced or not
    assert not spmd.exchange_route(cpu_mesh(2, 1, 1), as_distinct=True)


@pytest.mark.parametrize("tiles", [(1, 1), (2, 1), (1, 2), (2, 2), (4, 2), (8, 1), (3, 1)])
def test_multihost_mesh_follows_the_jax_rule(tiles):
    """This process's 8 local devices split into (8 // (tx ty), tx, ty), or
    ValueError, as JAX's ``multihost_mesh`` (one process, 8 virtual
    devices)."""
    try:
        want = dict(jdistributed.multihost_mesh(*tiles).shape)
    except ValueError:
        with pytest.raises(ValueError):
            distributed.multihost_mesh(*tiles, device=[CPU] * 8)
        return
    assert distributed.multihost_mesh(*tiles, device=[CPU] * 8).shape == want


def test_multihost_mesh_of_one_device_and_the_local_gpus(monkeypatch):
    """One device: the (1, tx, ty) mesh of the CPU form.  ``local_gpus``:
    the visible GPUs split by LOCAL_WORLD_SIZE, the block of LOCAL_RANK
    (the count of GPUs faked, as the CPU has none)."""
    assert distributed.multihost_mesh(2, 2, device="cpu").shape == {"frames": 1, "tx": 2, "ty": 2}
    monkeypatch.setattr(distributed, "resolve_device", lambda device: None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.delenv("OFTPU_NUM_PROCESSES", raising=False)
    assert [d.index for d in distributed.local_gpus()] == list(range(8))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert distributed.local_gpus() == [torch.device("cuda", 2), torch.device("cuda", 3)]
    assert distributed.multihost_mesh(2, 1).shape == {"frames": 1, "tx": 2, "ty": 1}
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    assert distributed.multihost_mesh().devices.flat[0] == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "16")
    with pytest.raises(ValueError, match="16 processes"):
        distributed.local_gpus()


@pytest.mark.parametrize("world", ["env", "group"])
def test_one_process_per_gpu_owns_its_gpu_alone(monkeypatch, world):
    """One process of several with no LOCAL_WORLD_SIZE (the ``OFTPU_*``
    launch, one process per GPU): its GPUs are the one that ``initialize``
    made current, so its default mesh is (1, 1, 1) there and a tiling mesh
    raises, as JAX's rule gives for one local device; the world of several
    is read from OFTPU_NUM_PROCESSES, or from the process group once
    initialised.  (The GPU count and the current GPU are faked.)"""
    monkeypatch.setattr(distributed, "resolve_device", lambda device: None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    if world == "env":
        monkeypatch.setenv("OFTPU_NUM_PROCESSES", "4")
    else:
        monkeypatch.delenv("OFTPU_NUM_PROCESSES", raising=False)
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    assert distributed.local_gpus() == [torch.device("cuda", 2)]
    mesh = distributed.multihost_mesh()
    assert mesh.shape == {"frames": 1, "tx": 1, "ty": 1} and not mesh.distinct
    assert mesh.device() == torch.device("cuda", 2)
    with pytest.raises(ValueError, match="divide"):
        distributed.multihost_mesh(2, 1)
    # a world of one owns every visible GPU
    if world == "env":
        monkeypatch.setenv("OFTPU_NUM_PROCESSES", "1")
    else:
        monkeypatch.setattr(dist, "get_world_size", lambda: 1)
    assert distributed.local_gpus() == [torch.device("cuda", k) for k in range(4)]


@pytest.mark.parametrize("n_frames,frames", [(5, 2), (4, 2), (4, 4)])
@pytest.mark.parametrize("remodelling", [False, True])
def test_sharded_box_flow_split_over_devices_equals_one_device(movie, n_frames, frames,
                                                               remodelling):
    """Pairs split in order over distinct devices (unevenly, and with an
    empty block: 3 pairs over 4 devices) equal the whole movie on one."""
    devices = [torch.device("cpu", k) for k in range(frames)]
    kw = dict(box_size=7, delta_x=0.5, delta_t=2.0, include_remodelling=remodelling)
    got = batch.sharded_box_flow(movie[:n_frames], mesh=pmesh.make_mesh(devices, frames=frames),
                                 **kw)
    want = batch.sharded_box_flow(movie[:n_frames], mesh=cpu_mesh(1, 1, 1), **kw)
    for g, w in zip(got, want):
        assert g.shape == (n_frames - 1, 34, 34)
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


def test_distributed_solve_on_distinct_devices(movie):
    """A world of one (gloo) whose mesh spans two devices: the sharded
    solve's routes, equal to it."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    distributed.initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=1,
                           process_id=0, cpu_devices=1)
    mesh = distributed.multihost_mesh(1, 1, device=TWO_CPUS)
    assert mesh.shape == {"frames": 2, "tx": 1, "ty": 1}
    kw = dict(mesh=mesh, solver=SolverConfig(matvec="pallas"), dtype=torch.float64, **ALPHAS)
    try:
        local_u, infos = distributed.distributed_variational_solve((movie[:-1], movie[1:]), **kw)
    finally:
        dist.destroy_process_group()
    u, infos_s = batch.sharded_variational_solve(movie, **kw)
    np.testing.assert_array_equal(local_u, u.numpy())
    np.testing.assert_array_equal(infos["iterations"], infos_s["iterations"].numpy())


@pytest.fixture
def fast_switching():
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(interval)


def _run_threads(target, n):
    threads = [threading.Thread(target=target) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)


def test_counters_stay_exact_under_threads(fast_switching):
    """More threads than cores bump the kernel counters and the
    observability counters at once; a lost update would show."""
    n_threads, per_thread = 32, 500
    calls = ck.EXT_PLAIN_CALLS
    syncs = observability.counts().get("test/threads", 0)

    def bump():
        for _ in range(per_thread):
            ck._count("EXT_PLAIN_CALLS")
            observability.add_count("test/threads")

    _run_threads(bump, n_threads)
    assert ck.EXT_PLAIN_CALLS - calls == n_threads * per_thread
    assert observability.counts()["test/threads"] - syncs == n_threads * per_thread


def test_the_library_is_built_once_whatever_the_threads(monkeypatch, fast_switching):
    builds = []

    def slow_build():
        builds.append(1)
        time.sleep(0.05)
        return {"el_matvec_extended": object()}

    monkeypatch.setattr(ck, "_FUNCTIONS", {})
    monkeypatch.setattr(ck, "build", slow_build)
    _run_threads(ck.load_library, 16)
    assert len(builds) == 1 and set(ck._FUNCTIONS) == {"el_matvec_extended"}


def test_full_f32_precision_is_restored_after_overlapping_threads(fast_switching):
    """Blocks opened and closed in many threads at once: TF32 is off
    inside every block, and the flags are restored once all have closed."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    seen = []

    def solve():
        for k in range(20):
            with krylov.full_f32_precision():
                time.sleep(0.0005 * (k % 3))
                seen.append((torch.backends.cuda.matmul.allow_tf32,
                             torch.backends.cudnn.allow_tf32))

    try:
        _run_threads(solve, 16)
        assert set(seen) == {(False, False)} and len(seen) == 16 * 20
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (
            True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
