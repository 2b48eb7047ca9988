"""The port's core modules, interop and package boundary against the JAX
package.

Stencils are exact arithmetic on the same inputs (one subtraction, one
scaling by a power of two, or a short sum), so they are compared for
equality in float64 and to float32 rounding (rtol 1e-6) in float32.
"""

from torch_threads import one_intra_op_thread  # noqa: F401,I001 (autouse; first: see its module)

import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflow_tpu.core import stencils as jst
from opticalflow_tpu.core import synth as jsynth
from opticalflow_tpu.core import types as jtypes
from opticalflow_tpu.ops import elop as jelop
from opticalflow_tpu_torch import interop
from opticalflow_tpu_torch.core import stencils, synth, types
from opticalflow_tpu_torch.ops import elop
from opticalflow_tpu_torch.utils import observability


def test_solver_config_fields_and_defaults_match():
    ours = {f.name: f.default for f in dataclasses.fields(types.SolverConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(jtypes.SolverConfig)}
    assert ours == theirs


@pytest.mark.parametrize("name", ["VariationalConfig", "BoxFlowConfig"])
def test_presets_fields_and_defaults_match(name):
    ours, theirs = getattr(types, name), getattr(jtypes, name)
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(theirs)]
    for a, b in zip(dataclasses.fields(ours), dataclasses.fields(theirs)):
        if b.default_factory is not dataclasses.MISSING:  # the solver's SolverConfig
            assert dataclasses.asdict(a.default_factory()) == dataclasses.asdict(b.default_factory())
        else:
            assert a.default == b.default, a.name
    assert dataclasses.is_dataclass(ours) and ours.__dataclass_params__.frozen


def test_presets_run_the_direct_calls_on_the_cpu():
    """``.run`` is the direct call with the preset's fields, exactly (the
    same deterministic CPU arithmetic); ``dtype=None`` is float32."""
    import opticalflow_tpu_torch as port

    movie, dx = synth.make_translating_blob_movie(n_frames=3, dimension=20, width=8.0, sigma=2.0,
                                                  v_x=0.15, v_y=0.1)
    movie = movie * 100.0
    cfg = port.VariationalConfig(delta_x=dx, speed_alpha=500.0, remodelling_alpha=800.0,
                                 warm_start="two-pass", dy_mode="fixed")
    got = cfg.run(movie, device="cpu")
    want = port.variational_optical_flow(movie, delta_x=dx, speed_alpha=500.0,
                                         remodelling_alpha=800.0, warm_start="two-pass",
                                         dy_mode="fixed", device="cpu")
    assert got["v_x"].dtype == np.float32
    for key in ("v_x", "v_y", "remodelling", "iterations"):
        np.testing.assert_array_equal(got[key], want[key])
    box = port.BoxFlowConfig(boxsize=7, delta_x=dx, smoothing_sigma=1.0, include_remodelling=True)
    got = box.run(movie, device="cpu")
    want = port.conduct_optical_flow(movie, boxsize=7, delta_x=dx, smoothing_sigma=1.0,
                                     include_remodelling=True, device="cpu")
    for key in ("v_x", "v_y", "speed", "net_remodelling"):
        np.testing.assert_array_equal(got[key], want[key])
    assert set(port.__all__) == set(__import__("opticalflow_tpu").__all__)


def test_flow_result_contract_matches(tmp_path):
    assert types.FlowResult._STANDARD == jtypes.FlowResult._STANDARD
    res = types.FlowResult(v_x=np.ones((1, 4, 4)), v_y=torch.zeros(1, 4, 4), delta_x=0.5,
                           delta_t=2.0, converged=None)
    assert "converged" not in res and res.delta_x == 0.5
    path = str(tmp_path / "r.npy")
    res.save(path)
    back = types.FlowResult.load(path)
    assert isinstance(back["v_y"], np.ndarray) and back.v_x.shape == (1, 4, 4)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dy_mode", ["compat", "fixed"])
def test_stencils_match_jax(dtype, dy_mode):
    frames = np.random.default_rng(3).standard_normal((3, 11, 9)).astype(dtype)
    t = torch.from_numpy(frames)
    rtol = 0 if dtype == np.float64 else 1e-6
    pairs = [
        (stencils.ddx, jst.ddx),
        (lambda m: stencils.ddy(m, dy_mode), lambda m: jst.ddy(m, dy_mode)),
        (stencils.ddxx, jst.ddxx),
        (stencils.ddyy, jst.ddyy),
        (stencils.ddxy, jst.ddxy),
        (stencils.mirror_edges, jst.mirror_edges),
    ]
    for ours, theirs in pairs:
        got = ours(t).numpy()
        for b in range(frames.shape[0]):
            np.testing.assert_allclose(got[b], np.asarray(theirs(jnp.asarray(frames[b]))),
                                       rtol=rtol, atol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dy_mode", ["compat", "fixed"])
def test_neighbour_sums_and_rule_dispatch_match_jax(dtype, dy_mode):
    frames = np.random.default_rng(4).standard_normal((3, 10, 12)).astype(dtype)
    t = torch.from_numpy(frames)
    rtol = 0 if dtype == np.float64 else 1e-6
    for rule in ("dx", "dy", "dxx", "dyy", "dxy", "dyx", "bar_x", "bar_y", "bar"):
        got = stencils.interior_derivative(t, rule, dy_mode).numpy()
        for b in range(frames.shape[0]):
            want = np.asarray(jst.interior_derivative(jnp.asarray(frames[b]), rule, dy_mode))
            np.testing.assert_allclose(got[b], want, rtol=rtol, atol=0, err_msg=rule)
    for ours, theirs in ((stencils.bar_x, jst.bar_x), (stencils.bar_y, jst.bar_y),
                         (stencils.bar4, jst.bar4)):
        np.testing.assert_allclose(ours(t).numpy()[1], np.asarray(theirs(jnp.asarray(frames[1]))),
                                   rtol=rtol, atol=0)
    np.testing.assert_array_equal(stencils.mirror_edges_movie(t).numpy(),
                                  np.asarray(jst.mirror_edges_movie(jnp.asarray(frames))))
    with pytest.raises(ValueError, match="unknown derivative rule"):
        stencils.interior_derivative(t, "dz")


def test_analytic_synthetic_movies_match_jax():
    """Closed-form textures and fields in float64: numpy and XLA evaluate
    the same sums of sin, cos and exp, within a few ulps (rtol 1e-12)."""
    ii, jj = np.arange(20.0)[:, None], np.arange(17.0)[None, :]
    pairs = [
        (synth.random_fourier_texture(ii, jj, seed=3),
         jsynth.random_fourier_texture(jnp.asarray(ii), jnp.asarray(jj), seed=3)),
        (synth.make_translating_texture_movie(3, 30), jsynth.make_translating_texture_movie(3, 30)),
        (synth.make_remodelling_ramp_movie(3, 30), jsynth.make_remodelling_ramp_movie(3, 30)),
        (synth.make_remodelling_ramp_movie(2, 24, background="texture"),
         jsynth.make_remodelling_ramp_movie(2, 24, background="texture")),
        (synth.vortex_pair_velocity(32, peak_speed=0.7), jsynth.vortex_pair_velocity(32, peak_speed=0.7)),
        (synth.make_vortex_pair_movie(2, 32), jsynth.make_vortex_pair_movie(2, 32)),
    ]
    for ours, theirs in pairs:
        ours = ours if isinstance(ours, tuple) else (ours,)
        theirs = theirs if isinstance(theirs, tuple) else (theirs,)
        for a, b in zip(ours, theirs):
            if isinstance(b, float) or b is None:
                assert a == b
            else:
                np.testing.assert_allclose(a, np.asarray(b), rtol=1e-12, atol=1e-13)
    with pytest.raises(ValueError, match="background"):
        synth.make_remodelling_ramp_movie(background="stripes")


def test_noisy_synthetic_frames_match_jax_in_amplitude():
    """Noise bits differ (numpy Generator vs PRNGKey); both add uniform
    noise in [0, 1e-7) to the same noise-free frames."""
    kw = dict(n_frames=3, dimension=33, width=20.0, sigma=3.0, v_x=0.15, v_y=0.1)
    clean, _ = synth.make_translating_blob_movie(**kw)
    ours, dx = synth.make_translating_blob_movie(include_noise=True, **kw)
    theirs, jdx = jsynth.make_translating_blob_movie(include_noise=True, **kw)
    assert dx == jdx
    for noisy in (ours, np.asarray(theirs)):
        noise = noisy - clean
        assert noise.min() >= -1e-15 and noise.max() <= 1e-7
        assert noise.max() > 5e-8
    again, _ = synth.make_translating_blob_movie(include_noise=True, **kw)
    np.testing.assert_array_equal(ours, again)  # seeded per frame
    frame, _ = synth.make_fake_data_frame(1.0, 2.0, include_noise=True, dimension=9,
                                          rng=np.random.default_rng(5))
    assert frame.shape == (9, 9) and (frame >= 0).all()


def test_synthetic_movie_matches_jax():
    kw = dict(n_frames=3, dimension=33, width=20.0, sigma=3.0, v_x=0.15, v_y=0.1)
    ours, dx = synth.make_translating_blob_movie(**kw)
    theirs, jdx = jsynth.make_translating_blob_movie(**kw, dtype=jnp.float64)
    assert dx == jdx
    # exp of the same f64 argument in numpy and XLA: within a few ulps
    np.testing.assert_allclose(ours, np.asarray(theirs), rtol=1e-14, atol=1e-300)


def test_interop_carries_solver_config_and_coefficients():
    cfg = jtypes.SolverConfig(rtol=1e-7, matvec="pallas", refinement_restarts=3)
    assert interop.solver_config_from_jax(dataclasses.asdict(cfg)) == types.SolverConfig(
        rtol=1e-7, matvec="pallas", refinement_restarts=3)
    with pytest.raises(ValueError):
        interop.solver_config_from_jax({"no_such_field": 1})

    # JAX's coefficient planes through the port's operator must give JAX's
    # own matvec: the same float64 arithmetic, term for term (rtol 1e-12).
    frames = np.random.default_rng(5).random((2, 14, 12)) * 100.0
    pair = jelop.compute_frame_pair_data(jnp.asarray(frames[0]), jnp.asarray(frames[1]),
                                         800.0, 900.0, "fixed")
    u = np.random.default_rng(6).standard_normal((3, 12, 10))
    arrays = {k: np.asarray(v) for k, v in pair._asdict().items() if k != "coeffs"}
    arrays["coeffs"] = {k: np.asarray(v) for k, v in pair.coeffs._asdict().items()}
    ported = interop.coeffs_from_numpy(arrays)
    assert ported.rhs.shape == (1, 3, 14, 12) and ported.coeffs.speed_alpha.shape == (1,)
    got = elop.interior_apply(ported.coeffs, elop.extend_interior(torch.from_numpy(u)[None]))
    want = jelop.el_matvec_reduced(pair.coeffs, jnp.asarray(u))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-12, atol=1e-9)


_NO_JAX = (
    "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m); "
    "assert not any(m.startswith('opticalflow_tpu.') or m == 'opticalflow_tpu' "
    "for m in sys.modules)"
)


def test_port_imports_no_jax():
    code = (
        "import sys, opticalflow_tpu_torch, opticalflow_tpu_torch.interop, "
        "opticalflow_tpu_torch.solve.direct, opticalflow_tpu_torch.core.synth, "
        "opticalflow_tpu_torch.analysis.sweeps, opticalflow_tpu_torch.analysis.tuning, "
        "opticalflow_tpu_torch.analysis.hyperparams, opticalflow_tpu_torch.analysis.statistics, "
        "opticalflow_tpu_torch.flow.liushen, opticalflow_tpu_torch.ops.clahe, "
        "opticalflow_tpu_torch.ops.resize, opticalflow_tpu_torch.ops.threshold, "
        "opticalflow_tpu_torch.utils.sweep_chunks, opticalflow_tpu_torch.analysis.drivers, "
        "opticalflow_tpu_torch.analysis.workflows, opticalflow_tpu_torch.analysis.groundtruth, "
        "opticalflow_tpu_torch.io.sequences, opticalflow_tpu_torch.io.native_loader, "
        "opticalflow_tpu_torch.io.interop, opticalflow_tpu_torch.utils.cache, "
        "opticalflow_tpu_torch.flow.farneback, opticalflow_tpu_torch.parallel.batch; "
        "import importlib.util; "
        "importlib.util.find_spec('matplotlib') and __import__('opticalflow_tpu_torch.viz.plots'); "
        + _NO_JAX
    )
    subprocess.run([sys.executable, "-c", code], check=True)
    # the CLI's help loads no JAX either
    code = ("import runpy, sys; sys.argv = ['drivers', '--help']\n"
            "try:\n    runpy.run_module('opticalflow_tpu_torch.analysis.drivers', "
            "run_name='__main__')\nexcept SystemExit as e:\n    assert e.code == 0\n" + _NO_JAX)
    subprocess.run([sys.executable, "-c", code], check=True, capture_output=True)


def test_spans_and_counters_record():
    observability.add_count("test/events", 2)
    with observability.span("test/span"):
        pass
    assert observability.counts()["test/events"] >= 2
    assert observability.span_statistics()["test/span"]["count"] >= 1
