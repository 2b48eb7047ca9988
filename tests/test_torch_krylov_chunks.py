"""The Krylov loops as chunks of steps (solve.krylov): the host reads a
loop's exit once per ``CHUNK`` steps, and a step past a pair's exit leaves
its state as it was, so the results equal those of a read after every
step (``CHUNK = 1``) bit for bit.  On the CPU the steps run uncaptured:
the same step functions that the card replays from a CUDA graph.

* BiCGStab and CG at chunks of 1, 3 and 8, on the EL systems of
  tests/test_torch_solve.py and the shifted Laplacians of
  tests/test_torch_fgmres.py: converged pairs that stop apart, a
  ``max_iterations`` that no chunk divides, a float32 solve whose pairs end
  on the stagnation window or on the recursive residual, and a breakdown
  (a rotation operator whose ``rhat . A p`` is exactly 0); every result
  compared with ``torch.equal``;
* the host reads of a BiCGStab call: at most ceil(iterations / CHUNK) + 2;
* FGMRES, built as the JAX solver is (full-size bases, per-pair column
  index, rotations and least squares on the device), against the vmapped
  JAX ``fgmres`` at restart 4 and 32, with the truncation guard on and off:
  equal iteration counts and convergence flags, the iterates within the
  1e-10 of their norm of tests/test_torch_fgmres.py (float64, the same
  algorithm step for step), the final residual norms within 1e-6 relative
  or 1e-10 of ||b|| (the iterates' own agreement carried through A: at
  restart 4 a converged pair's norm, ~1e-9 of ||b||, differs by ~5e-13 of
  it), and fewer host reads than Arnoldi columns;
* the kernel counters of a capture: recorded, not counted, and added back
  per replay (ops.cuda_kernels.recorded_counts / add_counts).
"""

from torch_threads import one_intra_op_thread  # noqa: F401,I001 (autouse; first: see its module)

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflow_tpu_torch.ops import cuda_kernels, elop
from opticalflow_tpu_torch.solve import krylov, multigrid
from opticalflow_tpu_torch.utils import observability
from test_torch_fgmres import X_TOL, _jax_fgmres, _laplacian_shift
from test_torch_solve import _fused, _systems

CHUNKS = [1, 3, 8]


def _solve_at(chunk, monkeypatch, solver, *args, **kw):
    monkeypatch.setattr(krylov, "CHUNK", chunk)
    observability.reset()
    res = solver(*args, **kw)
    return res, observability.counts().get("krylov/host_syncs", 0)


def _assert_equal(res, ref):
    for field in krylov.KrylovResult._fields:
        a, b = getattr(res, field), getattr(ref, field)
        assert a.dtype == b.dtype and torch.equal(a, b), field


def _el_system(dtype, preconditioner):
    m, n = 17, 15
    prev, a_s, a_r, ours, _ = _systems(m, n, "fixed")
    b = ours.rhs[:, :, 1:-1, 1:-1].contiguous().to(dtype)
    I = torch.from_numpy(np.ascontiguousarray(prev)).to(dtype)
    scalars = torch.from_numpy(np.stack([a_s, a_r], axis=-1)).to(dtype)

    def matvec(u):
        return cuda_kernels.el_matvec_reduced_fused(I, scalars, u.contiguous(), False)

    coeffs = elop.ELCoefficients(*[f.to(dtype) for f in ours.coeffs])
    if preconditioner == "multigrid":
        h = multigrid.setup(matvec, elop.diag_blocks(coeffs), m, n, dtype)
        return matvec, b, functools.partial(multigrid.v_cycle, h)
    return matvec, b, functools.partial(elop.block_jacobi_inverse_apply_interior, coeffs)


def _rotation_system():
    """Pair 0: (u, v, g) -> (-v, u, g) with b = (b0, 0, 0), so that
    rhat . A p = b0 . 0 + 0 . b0 + 0 = 0 exactly at the first step (a
    breakdown); pair 1: a shifted Laplacian, which converges."""
    rng = np.random.default_rng(5)
    b = torch.from_numpy(rng.standard_normal((2, 3, 6, 5)))
    b[0, 1:] = 0.0
    lap = _laplacian_shift(torch.tensor([0.3, 0.3], dtype=torch.float64), "torch")
    first = torch.tensor([True, False])[:, None, None, None]

    def matvec(u):
        return torch.where(first, torch.stack([-u[:, 1], u[:, 0], u[:, 2]], dim=1), lap(u))

    return matvec, b


BICGSTAB_CASES = {
    "multigrid, pairs stop apart": (torch.float64, "multigrid", dict(rtol=1e-9)),
    "max_iterations 7": (torch.float64, "block_jacobi", dict(rtol=1e-9, max_iterations=7)),
    "float32, stagnation window 10": (torch.float32, "block_jacobi",
                                      dict(rtol=1e-7, stagnation_window=10)),
}


@pytest.mark.parametrize("case", list(BICGSTAB_CASES))
@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_bicgstab_equals_the_step_by_step_loop(case, chunk, monkeypatch):
    dtype, preconditioner, kw = BICGSTAB_CASES[case]
    matvec, b, precond = _el_system(dtype, preconditioner)
    kw = dict(dict(max_iterations=400, tol_floor_eps_multiple=0.0), **kw)
    ref, _ = _solve_at(1, monkeypatch, krylov.bicgstab, matvec, b, precond=precond, **kw)
    res, syncs = _solve_at(chunk, monkeypatch, krylov.bicgstab, matvec, b, precond=precond, **kw)
    _assert_equal(res, ref)
    its = res.iterations.numpy()
    assert syncs <= math.ceil(its.max() / chunk) + 2
    if case.startswith("multigrid"):
        assert res.converged.all() and len(set(its.tolist())) == 3
    elif case.startswith("max_iterations"):
        assert (its == 7).all() and not res.converged.any()
    else:  # two pairs end on the recursive residual, one on the window
        assert not res.converged.any() and (its < 400).all()
        assert ((its % 10) == 0).sum() == 1


@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_bicgstab_breakdown(chunk, monkeypatch):
    matvec, b = _rotation_system()
    kw = dict(rtol=1e-10, max_iterations=50, tol_floor_eps_multiple=0.0)
    ref, _ = _solve_at(1, monkeypatch, krylov.bicgstab, matvec, b, **kw)
    res, _ = _solve_at(chunk, monkeypatch, krylov.bicgstab, matvec, b, **kw)
    _assert_equal(res, ref)
    assert res.iterations.tolist()[0] == 1 and not res.converged[0]  # broke down at once
    assert res.converged[1] and res.iterations[1] > 1


@pytest.mark.parametrize("max_iterations", [500, 7])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_cg_equals_the_step_by_step_loop(chunk, max_iterations, monkeypatch):
    s = torch.tensor([0.05, 0.5, 0.005], dtype=torch.float64)
    b = torch.from_numpy(np.random.default_rng(3).standard_normal((3, 3, 24, 30)))
    args = (krylov.cg, _laplacian_shift(s, "torch"), b)
    kw = dict(precond=lambda r: r / (4.0 + s[:, None, None, None]), rtol=1e-10,
              max_iterations=max_iterations, tol_floor_eps_multiple=0.0)
    ref, _ = _solve_at(1, monkeypatch, *args, **kw)
    res, syncs = _solve_at(chunk, monkeypatch, *args, **kw)
    _assert_equal(res, ref)
    its = res.iterations.numpy()
    assert syncs <= math.ceil(its.max() / chunk) + 2
    assert (its == 7).all() if max_iterations == 7 else len(set(its.tolist())) > 1


@pytest.mark.parametrize("restart", [4, 32])
@pytest.mark.parametrize("truncation_guard", [True, False])
def test_on_device_fgmres_matches_vmapped_jax(restart, truncation_guard):
    m = n = 40
    prev, a_s, a_r, ours, theirs = _systems(m, n)
    b_red = ours.rhs[:, :, 1:-1, 1:-1].contiguous()
    matvec = _fused(prev, a_s, a_r)
    h = multigrid.setup(matvec, elop.diag_blocks(ours.coeffs), m, n, torch.float64)
    kw = dict(rtol=1e-9, max_iterations=400, tol_floor_eps_multiple=0.0, restart=restart,
              truncation_guard=truncation_guard)
    observability.reset()
    res = krylov.fgmres(matvec, b_red, precond=functools.partial(multigrid.v_cycle, h), **kw)
    syncs = observability.counts()["krylov/host_syncs"]

    coeffs_j = jax.tree.map(lambda *xs: jnp.stack(xs), *[t.coeffs for t in theirs])
    res_j = _jax_fgmres(coeffs_j, jnp.asarray(b_red.numpy()), jnp.int32(400), restart=restart,
                        truncation_guard=truncation_guard)
    np.testing.assert_array_equal(res.iterations.numpy(), np.asarray(res_j.iterations))
    np.testing.assert_array_equal(res.converged.numpy(), np.asarray(res_j.converged))
    x, x_j = res.x.numpy(), np.asarray(res_j.x)
    for k in range(x.shape[0]):
        assert np.abs(x[k] - x_j[k]).max() <= X_TOL * np.abs(x_j[k]).max(), k
    b_norm = np.sqrt((b_red.numpy().reshape(3, -1) ** 2).sum(axis=1))
    np.testing.assert_allclose(res.residual_norm.numpy(), np.asarray(res_j.residual_norm),
                               rtol=1e-6, atol=X_TOL * b_norm.max())
    its, conv = res.iterations.numpy(), res.converged.numpy()
    assert syncs < its.max()  # no read per column
    if restart == 4:  # two pairs end on the <1% stall stop, as at restart 8
        assert (~conv & (its < 400)).sum() == 2 and conv.sum() == 1
    else:
        assert conv.all()


def test_a_capture_records_the_counts_that_each_replay_adds():
    I = torch.ones(2, 7, 6)
    scalars = torch.ones(2, 2)
    u = torch.zeros(2, 3, 5, 4)
    before = cuda_kernels.PLAIN_CALLS
    with cuda_kernels.recorded_counts() as counts:
        cuda_kernels.el_matvec_reduced_fused(I, scalars, u, True)
        cuda_kernels.el_matvec_reduced_fused(I, scalars, u, True)
    assert counts == {"PLAIN_CALLS": 2} and cuda_kernels.PLAIN_CALLS == before
    cuda_kernels.el_matvec_reduced_fused(I, scalars, u, True)  # counted again
    assert cuda_kernels.PLAIN_CALLS == before + 1
    for _ in range(3):
        cuda_kernels.add_counts(counts)
    assert cuda_kernels.PLAIN_CALLS == before + 7


def test_steps_run_uncaptured_on_the_cpu_and_inside_the_private_block():
    calls = []
    step = krylov._Step(lambda: calls.append(1), torch.device("cpu"))
    step()
    step()
    assert len(calls) == 2 and step.graph is None and not step.captures
    with krylov._uncaptured():
        with krylov._uncaptured():
            assert not krylov._Step(calls.clear, torch.device("cuda", 0)).captures
        assert not krylov._Step(calls.clear, torch.device("cuda", 0)).captures
    assert krylov._Step(calls.clear, torch.device("cuda", 0)).captures
