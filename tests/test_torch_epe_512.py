"""The 512x512 and 1024x1024 pairs of the large-grid branch: the port's
and the JAX package's float32 default solves against one float64 oracle,
on the CPU.

Marked slow, so tier-1 leaves it out (512: about two minutes on 8 CPU
cores; 1024: see PERF.md section 7).  Run it alone and read the numbers it
prints:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_epe_512.py -m slow -s -q

The pair is ``bench.py::make_movie(2, dim)``, the 1024 one the embryo-scale
pair of tests/test_accuracy_1024.py: blob width 20 * dim / 256, sigma 3,
v = (0.15, 0.1), x100 and rounded through float32, so both dtypes see the
same frames.  max(m, n) >= 500 puts both solves in the FGMRES branch with
the 0.03 x tol refinement exit.  The oracle is the port's float64 FGMRES
at rtol 1e-10 with no refinement (the oracle of
tests/test_accuracy_1024.py).  Both float32 solves must converge and land
under the 1e-3 px gate, and the port no further than twice JAX's EPE from
the oracle (plus 1e-5 px): the question is whether the port's solve loses
accuracy that the JAX package's keeps at the same exit.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflow_tpu.flow.variational import solve_frame_pair as jax_solve_frame_pair
from opticalflow_tpu_torch.core.synth import make_translating_blob_movie
from opticalflow_tpu_torch.flow.variational import solve_frame_pair

ALPHA = 1000.0


def _epe(u, u_ref):
    d = np.asarray(u, np.float64) - np.asarray(u_ref, np.float64)
    return float(np.sqrt(d[0] ** 2 + d[1] ** 2)[1:-1, 1:-1].max())


@pytest.mark.slow
@pytest.mark.parametrize("dim", [512, 1024])
def test_epe_of_port_and_jax_against_the_f64_oracle(dim):
    movie, _ = make_translating_blob_movie(n_frames=2, dimension=dim,
                                           width=20.0 * dim / 256, sigma=3.0, v_x=0.15, v_y=0.1)
    movie = np.asarray(movie * 100.0, np.float32)

    t0 = time.perf_counter()
    f64 = torch.from_numpy(movie.astype(np.float64))
    u_ref, info_ref = solve_frame_pair(f64[:1], f64[1:], torch.zeros(3, dim, dim, dtype=f64.dtype),
                                       ALPHA, ALPHA, method="gmres", rtol=1e-10,
                                       refinement_restarts=0, matvec_impl="xla")
    assert bool(info_ref["converged"][0])
    print(f"\noracle (port, float64 FGMRES rtol 1e-10): {time.perf_counter() - t0:.1f} s, "
          f"iterations {int(info_ref['iterations'][0])}")

    f32 = torch.from_numpy(movie)
    t0 = time.perf_counter()
    u_port, info_port = solve_frame_pair(f32[:1], f32[1:], torch.zeros(3, dim, dim),
                                         ALPHA, ALPHA, method="auto")
    port_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    u_jax, info_jax = jax_solve_frame_pair(jnp.asarray(movie[0]), jnp.asarray(movie[1]),
                                           jnp.zeros((3, dim, dim), jnp.float32), ALPHA, ALPHA,
                                           method="auto")
    u_jax = np.asarray(u_jax)
    jax_s = time.perf_counter() - t0

    # the tolerance both float32 solves report against: eff_rtol * ||b||
    rows = []
    for name, u, its, res, conv, secs in (
            ("port", u_port[0].numpy(), int(info_port["iterations"][0]),
             float(info_port["residual_norm"][0]), bool(info_port["converged"][0]), port_s),
            ("jax", u_jax, int(info_jax["iterations"]), float(info_jax["residual_norm"]),
             bool(info_jax["converged"]), jax_s)):
        rows.append((name, _epe(u, u_ref[0].numpy()), res, its, conv))
        print(f"{name} float32 default: {secs:.1f} s, iterations {its}, converged {conv}, final "
              f"residual {res:.4e}, EPE {rows[-1][1]:.4e} px vs the oracle")
    print(f"port vs jax: {_epe(u_port[0].numpy(), u_jax):.4e} px")
    (_, port_epe, _, _, port_conv), (_, jax_epe, _, _, jax_conv) = rows
    assert port_conv and jax_conv
    assert port_epe < 1e-3 and jax_epe < 1e-3
    assert port_epe <= 2.0 * jax_epe + 1e-5
