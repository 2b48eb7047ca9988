"""The port's multi-process solve (``parallel.distributed``) in a real
two-process ``torch.distributed`` run on the CPU (gloo), against the JAX
package's single-process sharded solve.

The test spawns two processes running this module's ``__main__`` block,
as tests/test_distributed.py spawns its JAX workers.  Each joins a gloo
process group, contributes its share of the frame pairs of
tests/test_distributed.py's movie (24x24, 5 frames; rank 0 two pairs and
rank 1 one, as there, or rank 0 three and rank 1 none; pair 3 unused) on
a (1, 1, 2) mesh of the CPU, and saves its local block.  The blocks, concatenated in rank order, must match JAX's
``sharded_variational_solve`` on a (1, 1, 1) mesh (float64, block-Jacobi)
to rtol 1e-3, atol 1e-4: JAX's own bound for its two-process run (the
solutions agree to the solve tolerance, not bitwise).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALPHAS = dict(speed_alpha=500.0, remodelling_alpha=500.0)


def _movie():
    from opticalflow_tpu_torch.core.synth import make_translating_blob_movie

    movie, _ = make_translating_blob_movie(n_frames=5, dimension=24, width=10.0, sigma=2.5,
                                           v_x=0.2, v_y=0.1)
    return movie * 100.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("matvec,split", [("auto", (2, 1)), ("pallas", (2, 1)),
                                          ("auto", (3, 0))])
def test_two_process_solve_matches_jax(tmp_path, matvec, split):
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), "2", str(port), str(tmp_path),
         matvec, ",".join(map(str, split))],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {rank} failed:\n{out[-4000:]}"

    r0, r1 = np.load(tmp_path / "rank0.npz"), np.load(tmp_path / "rank1.npz")
    assert int(r0["world"]) == int(r1["world"]) == 2
    assert r0["converged"].all() and r1["converged"].all()
    # unequal contributions (none included) come back as exactly the local pairs
    assert r0["local_u"].shape == (split[0], 3, 24, 24)
    assert r1["local_u"].shape == (split[1], 3, 24, 24)
    # every process that had pairs ran the kernel its matvec maps to (its
    # plain version on the CPU): B3 for 'pallas', B1 for 'auto'
    for r, n in zip((r0, r1), split):
        assert (r["ext_plain_calls"] > 0) == (matvec == "pallas" and n > 0)
        assert (r["plain_calls"] > 0) == (matvec == "auto" and n > 0)

    import jax

    from opticalflow_tpu.core.types import SolverConfig
    from opticalflow_tpu.parallel import mesh as mesh_lib
    from opticalflow_tpu.parallel.batch import sharded_variational_solve

    single = mesh_lib.make_mesh(jax.devices()[:1], frames=1, tx=1, ty=1)
    u_ref, _ = sharded_variational_solve(
        _movie(), mesh=single, solver=SolverConfig(preconditioner="block_jacobi"),
        dtype=np.float64, **ALPHAS)
    all_u = np.concatenate([r0["local_u"], r1["local_u"]])
    np.testing.assert_allclose(all_u, np.asarray(u_ref)[:3], rtol=1e-3, atol=1e-4)


def _worker(rank: int, world: int, port: str, outdir: str, matvec: str, split: str):
    """One process of the two-process run (``python this_file.py rank world
    port outdir matvec split``, split = the pairs of each rank, e.g.
    ``2,1``)."""
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    from opticalflow_tpu_torch.core.types import SolverConfig
    from opticalflow_tpu_torch.ops import cuda_kernels as ck
    from opticalflow_tpu_torch.parallel import distributed

    distributed.initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=world,
                           process_id=rank, cpu_devices=1)
    movie = _movie()
    prev, cur = movie[:-1], movie[1:]
    counts = [int(c) for c in split.split(",")]
    local = slice(sum(counts[:rank]), sum(counts[: rank + 1]))
    local_u, infos = distributed.distributed_variational_solve(
        (prev[local], cur[local]), mesh=distributed.multihost_mesh(tx=1, ty=2, device="cpu"),
        solver=SolverConfig(preconditioner="block_jacobi", matvec=matvec), dtype=torch.float64,
        **ALPHAS)
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), local_u=local_u,
             converged=infos["converged"], world=dist.get_world_size(),
             ext_plain_calls=ck.EXT_PLAIN_CALLS, plain_calls=ck.PLAIN_CALLS)
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5],
            sys.argv[6])
