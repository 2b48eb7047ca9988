"""The port's core modules, interop and package boundary against the JAX
package.

Stencils are exact arithmetic on the same inputs (one subtraction, one
scaling by a power of two, or a short sum), so they are compared for
equality in float64 and to float32 rounding (rtol 1e-6) in float32.
"""

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


def test_port_imports_no_jax():
    code = (
        "import sys, opticalflow_tpu_torch, opticalflow_tpu_torch.interop, "
        "opticalflow_tpu_torch.solve.direct, opticalflow_tpu_torch.core.synth; "
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m); "
        "assert not any(m.startswith('opticalflow_tpu.') or m == 'opticalflow_tpu' "
        "for m in sys.modules)"
    )
    subprocess.run([sys.executable, "-c", code], check=True)


def test_spans_and_counters_record():
    observability.add_count("test/events", 2)
    with observability.span("test/span"):
        pass
    assert observability.counts()["test/events"] >= 2
    assert observability.span_statistics()["test/span"]["count"] >= 1
