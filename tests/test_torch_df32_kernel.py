"""Kernel B4's operands and plain versions (ops.cuda_kernels: pack_df32,
el_residual_df32, el_matvec_df32) against the port's df32 functions
(ops.elop) and the JAX package's, its build flags, and the refinement's
use of it; on the CPU, where the wrappers run the plain versions.

Tolerances: none.  The plain versions are ``elop.el_residual_df`` /
``el_matvec_df`` on views into the packed tensors, so they must equal the
port's functions on the unpacked data bit for bit; and, as in
tests/test_torch_df32.py, the port's df32 arithmetic equals the JAX
package's bit for bit on the same float32 inputs, so the packed path is
held to that too.  Kernel B4 itself is held bitwise to these plain
versions on the card (tests/test_torch_gpu.py, chip_smoke.py phase 3).
"""

from torch_threads import one_intra_op_thread  # noqa: F401,I001 (autouse; first: see its module)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflow_tpu.ops import elop as jelop
from opticalflow_tpu_torch import SolverConfig, variational_optical_flow
from opticalflow_tpu_torch.core.synth import make_translating_blob_movie
from opticalflow_tpu_torch.flow import variational
from opticalflow_tpu_torch.ops import cuda_kernels as ck
from opticalflow_tpu_torch.ops import elop
from opticalflow_tpu_torch.utils import df32_cases

ALPHAS = [(1000.0, 1000.0), (300.0, 2000.0), (50.0, 10.0)]


def _inputs(B, m, n, dtype=np.float32, seed=1):
    """Frames (B, m+2, n+2) of a moving blob x100, per-pair scales and
    alphas, and fields x_hi, x_lo (B, 3, m, n), all numpy."""
    movie, _ = make_translating_blob_movie(n_frames=B + 1, dimension=max(m, n) + 2, width=6.0,
                                           sigma=2.0, v_x=0.2, v_y=0.1)
    movie = (movie[:, : m + 2, : n + 2] * 100.0).astype(dtype)
    prev, cur = movie[:-1], movie[1:]
    scale = prev.reshape(B, -1).max(axis=1)
    alphas = np.array(ALPHAS[:B], dtype=dtype)
    rng = np.random.default_rng(seed)
    x_hi = rng.standard_normal((B, 3, m, n)).astype(dtype)
    x_lo = (x_hi * 1e-8 * rng.standard_normal(x_hi.shape)).astype(dtype)
    return prev, cur, scale, alphas, x_hi, x_lo


def _port_data(prev, cur, scale, alphas, dy_mode):
    t = torch.from_numpy
    return elop.compute_frame_pair_data_df(t(prev), t(cur), t(alphas[:, 0]), t(alphas[:, 1]),
                                           dy_mode, t(scale))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("subset", [None, (2, 0)])
@pytest.mark.parametrize("dy_mode", ["compat", "fixed"])
def test_packed_plain_versions_equal_elop(dy_mode, subset, dtype):
    """On a ragged 3 x 7 x 9 batch, also after ``_take`` of a subset of
    pairs (as the refinement takes its active pairs): the wrappers' plain
    path equals ``elop.el_residual_df`` / ``el_matvec_df`` exactly, and
    runs no kernel."""
    prev, cur, scale, alphas, x_hi, x_lo = _inputs(3, 7, 9, dtype)
    dfd = _port_data(prev, cur, scale, alphas, dy_mode)
    ops = ck.pack_df32(dfd)
    assert ops.planes.shape == (3, 24 if dy_mode == "compat" else 26, 7, 9)
    assert ops.scalars.shape == (3, 6) and ops.planes.dtype == torch.from_numpy(x_hi).dtype
    x_hi, x_lo = torch.from_numpy(x_hi), torch.from_numpy(x_lo)
    if subset is not None:
        idx = torch.tensor(subset)
        dfd, ops = variational._take(dfd, idx), variational._take(ops, idx)
        x_hi, x_lo = x_hi[idx], x_lo[idx]
    assert isinstance(ops, ck.DF32Operands)
    launches, plain = ck.DF_LAUNCHES, ck.DF_PLAIN_CALLS
    r = ck.el_residual_df32(ops, x_hi, x_lo)
    y = ck.el_matvec_df32(ops, x_hi)
    assert (ck.DF_LAUNCHES, ck.DF_PLAIN_CALLS) == (launches, plain + 2)
    assert torch.equal(r, elop.el_residual_df(dfd, x_hi, x_lo))
    assert torch.equal(y, elop.el_matvec_df(dfd, x_hi))
    assert r.shape == y.shape == x_hi.shape and torch.isfinite(r).all()


@pytest.mark.parametrize("dy_mode", ["compat", "fixed"])
def test_packed_plain_versions_equal_jax(dy_mode):
    """The same numpy inputs through the JAX package's
    ``compute_frame_pair_data_df`` and ``el_residual_df`` / ``el_matvec_df``
    per pair: bit for bit, the tolerance of tests/test_torch_df32.py."""
    prev, cur, scale, alphas, x_hi, x_lo = _inputs(3, 7, 9)
    ops = ck.pack_df32(_port_data(prev, cur, scale, alphas, dy_mode))
    r = ck.el_residual_df32(ops, torch.from_numpy(x_hi), torch.from_numpy(x_lo)).numpy()
    y = ck.el_matvec_df32(ops, torch.from_numpy(x_hi)).numpy()
    for b, (a_s, a_r) in enumerate(alphas):
        theirs = jelop.compute_frame_pair_data_df(
            jnp.asarray(prev[b]), jnp.asarray(cur[b]), np.float32(a_s), np.float32(a_r), dy_mode,
            jnp.asarray(scale[b]))
        np.testing.assert_array_equal(
            r[b], np.asarray(jelop.el_residual_df(theirs, jnp.asarray(x_hi[b]),
                                                  jnp.asarray(x_lo[b]))))
        np.testing.assert_array_equal(
            y[b], np.asarray(jelop.el_matvec_df(theirs, jnp.asarray(x_hi[b]))))


def test_plain_versions_read_views_of_the_packed_tensors():
    """The refinement holds the df32 data once: the plain versions' planes
    and scalars are views into the packed tensors, not copies."""
    prev, cur, scale, alphas, _, _ = _inputs(2, 6, 5)
    ops = ck.pack_df32(_port_data(prev, cur, scale, alphas, "fixed"))
    views = ck._df32_views(ops)
    base = ops.planes.untyped_storage().data_ptr()
    for name in ck.DF32_PLANES:
        for t in getattr(views, name):
            assert t.untyped_storage().data_ptr() == base
    for name in ck.DF32_SCALARS:
        for t in getattr(views, name):
            assert t.shape == (2, 1, 1)
            assert t.untyped_storage().data_ptr() == ops.scalars.untyped_storage().data_ptr()


def test_wrappers_check_shapes():
    prev, cur, scale, alphas, x_hi, x_lo = _inputs(2, 6, 5)
    ops = ck.pack_df32(_port_data(prev, cur, scale, alphas, "compat"))
    x_hi, x_lo = torch.from_numpy(x_hi), torch.from_numpy(x_lo)
    with pytest.raises(ValueError):  # a field of another shape
        ck.el_matvec_df32(ops, x_hi[:, :, :-1])
    with pytest.raises(ValueError):
        ck.el_residual_df32(ops, x_hi, x_lo[:1])
    with pytest.raises(ValueError):  # neither 24 nor 26 planes
        ck.el_matvec_df32(ops._replace(planes=ops.planes[:, :22]), x_hi)
    with pytest.raises(ValueError):  # scalars of another batch
        ck.el_residual_df32(ops._replace(scalars=ops.scalars[:1]), x_hi, x_lo)
    with pytest.raises(ValueError):  # an interior narrower than its mirror rows
        small = ck.pack_df32(_port_data(prev[:, :3, :], cur[:, :3, :], scale, alphas, "compat"))
        ck.el_matvec_df32(small, x_hi[:, :, :1])


def test_only_b4_is_built_without_contraction(monkeypatch, tmp_path):
    """nvcc gets -fmad=false for the sources held to their plain versions
    bit for bit alone (B4's el_df32.cu, the multigrid's mg_smooth.cu and
    mg_transfer.cu (B5, B6) and FGMRES's column bookkeeping
    krylov_givens.cu (B8); B1-B3 and B7 may contract), no source gets fast
    math or flush-to-zero, and the flags enter each library's key."""
    commands = []

    class FailedNvcc:
        returncode = 1

        def __init__(self, args, **kwargs):
            commands.append(args)

        def communicate(self):
            return ("",)

    monkeypatch.setattr(ck, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(ck, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(ck.subprocess, "Popen", FailedNvcc)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ck.build()
    by_source = {args[-1].rsplit("/", 1)[-1]: args for args in commands}
    assert set(by_source) == set(ck.ENTRY_POINTS)
    for src, args in by_source.items():
        assert ("-fmad=false" in args) == (src in ("el_df32.cu", "mg_smooth.cu",
                                                   "mg_transfer.cu", "krylov_givens.cu"))
        assert not any("fast_math" in a or "ftz=true" in a for a in args)
    output = by_source["el_df32.cu"][by_source["el_df32.cu"].index("-o") + 1]

    commands.clear()
    entries = dict(ck.ENTRY_POINTS)
    entries["el_df32.cu"] = entries["el_df32.cu"][:2] + ((),)
    with pytest.raises(RuntimeError):
        ck.build(entry_points=entries)
    args = next(a for a in commands if a[-1].endswith("el_df32.cu"))
    assert "-fmad=false" not in args and args[args.index("-o") + 1] != output


def test_refinement_runs_through_the_wrappers():
    """A 2-pair 16x16 solve refines through el_residual_df32 and
    el_matvec_df32 (their plain versions on the CPU): at least the first
    residual, one correction solve and its residual."""
    movie, _ = make_translating_blob_movie(n_frames=3, dimension=16, width=6.0, sigma=2.0,
                                           v_x=0.15, v_y=0.1)
    launches, plain = ck.DF_LAUNCHES, ck.DF_PLAIN_CALLS
    result = variational_optical_flow((movie * 100.0).astype(np.float32), speed_alpha=1000.0,
                                      remodelling_alpha=1000.0, warm_start="cold",
                                      solver=SolverConfig(), device="cpu")
    assert result["converged_all"].all()
    assert ck.DF_LAUNCHES == launches and ck.DF_PLAIN_CALLS - plain >= 3
    # no refinement, no df32 call
    plain = ck.DF_PLAIN_CALLS
    variational_optical_flow((movie * 100.0).astype(np.float32), speed_alpha=1000.0,
                             remodelling_alpha=1000.0, warm_start="cold",
                             solver=SolverConfig(refinement_restarts=0), device="cpu")
    assert ck.DF_PLAIN_CALLS == plain


def _jax_data(ops, b):
    """Pair ``b`` of packed operands as the JAX package's ``ELPairDataDF``:
    the same float32 values, the per-pair scalars 0-d."""
    data = {}
    for name, value in ck._df32_views(ops)._asdict().items():
        if name in ("rhs_hi", "rhs_lo"):
            data[name] = jnp.asarray(value[b].numpy())
        else:
            data[name] = tuple(jnp.asarray(v[b].numpy().reshape(v.shape[1:] if v.dim() == 3
                                                                else ()))
                               for v in value)
    return jelop.ELPairDataDF(**data)


@pytest.mark.parametrize("P,overflow", [(24, False), (26, False), (26, True)])
def test_adversarial_operands_hold_what_they_promise(P, overflow):
    """The operands the card holds B4 to its plain versions on
    (``df32_cases.adversarial_operands``): zeros of both signs in every
    tensor, subnormal low parts, heads whose exponents span more than 100
    binades; the plain path on them equals the JAX package's
    ``el_residual_df`` / ``el_matvec_df`` pair by pair bit for bit (signed
    zeros and NaN included; the subnormal low parts give the same bits
    under XLA:CPU), with NaN in the residual exactly where an overflow was
    asked for."""
    ops, x_hi, x_lo = df32_cases.adversarial_operands(3, 9, 11, P, seed=11, device="cpu",
                                                      overflow=overflow)
    assert ops.planes.shape == (3, P, 9, 11) and ops.scalars.shape == (3, 6)
    for t in (ops.planes, ops.rhs_hi, ops.rhs_lo, x_hi, x_lo):
        zeros = t[t == 0]
        assert torch.signbit(zeros).any() and (~torch.signbit(zeros)).any()
    for lo in (ops.planes[:, 1::2], ops.rhs_lo, x_lo):
        assert ((lo != 0) & (lo.abs() < 2.0**-126)).any()
    exponents = torch.log2(x_hi[(x_hi != 0) & (x_hi.abs() < 2.0**100)].abs())
    assert exponents.max() - exponents.min() > 100
    r = ck.el_residual_df32(ops, x_hi, x_lo)
    y = ck.el_matvec_df32(ops, x_hi)
    for b in range(3):
        theirs = _jax_data(ops, b)
        r_jax = jelop.el_residual_df(theirs, jnp.asarray(x_hi[b].numpy()),
                                     jnp.asarray(x_lo[b].numpy()))
        y_jax = jelop.el_matvec_df(theirs, jnp.asarray(x_hi[b].numpy()))
        assert df32_cases.bitwise_equal(r[b], torch.from_numpy(np.array(r_jax)))
        assert df32_cases.bitwise_equal(y[b], torch.from_numpy(np.array(y_jax)))
    assert bool(torch.isnan(r).any()) == overflow


def test_ptxas_usage_reads_registers_and_spills():
    """The build log's -Xptxas -v report, as chip_smoke.py and kernel_ab
    print it: registers, shared memory and spills per kernel instance."""
    log = ("ptxas info    : 0 bytes gmem\n"
           "ptxas info    : Compiling entry function '_Z1kILb1EEvPf' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z1kILb1EEvPf\n"
           "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
           "ptxas info    : Used 128 registers, used 1 barriers, 29376 bytes smem, "
           "416 bytes cmem[0]\n"
           "ptxas info    : Compiling entry function '_Z1kILb0EEvPf' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 96 registers, 416 bytes cmem[0]\n")
    assert ck.ptxas_usage(log) == {
        "_Z1kILb1EEvPf": {"registers": 128, "smem_bytes": 29376, "spill_stores": 8,
                          "spill_loads": 12},
        "_Z1kILb0EEvPf": {"registers": 96, "smem_bytes": 0, "spill_stores": 0,
                          "spill_loads": 0}}


def test_occupancy_query_is_optional():
    """An older build of B4 has no occupancy query: the wrapper says so
    with None rather than raising."""
    assert ck.df32_warps_per_sm(24, False, torch.device("cpu"), library={"el_df32": None}) is None
