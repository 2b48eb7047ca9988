"""The regularisation sweep as the benchmark's cell ``sweep512_grid20``, on
the CPU: the port's batched float32 sweep against the benchmark's float64
reference, the ``sweep_pool`` entry on a tiny configuration, whole tiny
runs of the cell sound and with the timed path broken, the sweep's
per-chunk series and counter, and the three readers of them.

Tolerances of the float32 sweep against the float64 reference (2 frames
of 32x32, 3 x 2 alphas, every cell converged): the judged statistics
(speed mean, remodelling variance, functional) to rtol 2e-5, the speed
variance and the remodelling mean to rtol 3e-4.  Measured: at most
1.4e-7, 4.5e-7 and 2.1e-6 for the first three, 3.3e-5 and 8.8e-5 for the
other two (small quantities, the remodelling mean near zero, whose
relative errors the solve's stopping residual, under rtol 1e-6 of the
right-hand side, amplifies); each bound leaves ~10x above its reading.
This file imports no JAX.
"""

from torch_threads import one_intra_op_thread  # noqa: F401,I001 (autouse; first: see its module)

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from opticalflow_tpu_torch.analysis import sweeps
from opticalflow_tpu_torch.core.types import SolverConfig
from opticalflow_tpu_torch.utils import observability
from portbench import compare, files, synth

CELL, CONFIG, MIX = "sweep512_grid20", "sweep_512", "sweep_pool"
SEED = 2**31 + 29
TINY = dict(dimension=24, blob_width=20.0, speed_alphas=[100.0, 1000.0],
            remodelling_alphas=[100.0, 1000.0])
# (start index, alpha_s index, alpha_r index): cells 1 to 3 of every
# start, but cell 3 of start 2
TINY_JUDGED = [[s, i, j] for s in range(5) for i, j in ((0, 1), (1, 0), (1, 1))
               if (s, i, j) != (2, 1, 1)]
ALPHAS = dict(delta_x=0.0913, delta_t=10.0, device="cpu")


def tiny_checkout(tmp_path):
    """A checkout holding the cell at 24x24 and 2 x 2 alphas on the real
    entries and readers, its mix and limits (kernels run as their plain
    versions on the CPU, so ``plain_calls`` is not held to 0)."""
    here = tmp_path / "portbench"
    for sub in ("configs", "traffic", "limits"):
        (here / sub).mkdir(parents=True)
    for sub in ("entries", "metrics"):
        shutil.copytree(os.path.join(files.HERE, sub), here / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(files.HERE, "kernel_families.json"), here)
    bench = files.benchmark()
    w = files.workload(bench, CELL)
    (here / "configs" / f"{CONFIG}.json").write_text(json.dumps(dict(files.config(CONFIG), **TINY)))
    traffic = dict(files.traffic(w["traffic"]), check_cells=4, judged_cells=TINY_JUDGED)
    (here / "traffic" / f"{MIX}.json").write_text(json.dumps(traffic))
    (here / "limits" / f"{CELL}.json").write_text(json.dumps(dict(files.limits(CELL),
                                                                 plain_calls=1e12)))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(tmp_path), str(here)


# a whole run in a fresh interpreter: the harness refuses a process that
# has loaded JAX, as this suite's conftest does
RUNNER = """
import json, sys, time
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from portbench import harness
from opticalflow_tpu_torch.analysis import sweeps
from opticalflow_tpu_torch.solve import krylov

if {fault!r} == "state_unchanged":
    # every Krylov solve steps but hands back its start
    for name in ("bicgstab", "fgmres", "cg"):
        def frozen(matvec, b, x0=None, *a, _solver=getattr(krylov, name), **kw):
            res = _solver(matvec, b, x0=x0, *a, **kw)
            return res._replace(x=(torch.zeros_like(b) if x0 is None else x0).clone())
        setattr(krylov, name, frozen)
elif {fault!r}:
    # one statistic of every cell 1% off
    chunk_statistics = sweeps._chunk_statistics
    def altered(*a, **kw):
        out = chunk_statistics(*a, **kw)
        return dict(out, **{{{fault!r}: out[{fault!r}] * 1.01}})
    sweeps._chunk_statistics = altered
line = harness.run_cell({cell!r}, {seed}, 0.0, False, time.perf_counter(), device="cpu",
                        root={root!r}, here={here!r})
print(json.dumps(line))
"""


def run_tiny(tmp_path, fault=""):
    root, here = tiny_checkout(tmp_path)
    script = RUNNER.format(repo=files.ROOT, fault=fault, cell=CELL, seed=SEED, root=root,
                           here=here)
    done = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert done.returncode == 0, done.stderr[-4000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


def tiny_entry(tmp_path):
    root, here = tiny_checkout(tmp_path)
    config, traffic = files.config(CONFIG, here), files.traffic(MIX, here)
    return files.entry(traffic["entry"], here)(config, traffic, SEED, "cpu")


def test_batched_float32_sweep_matches_the_float64_reference():
    config = dict(frames=2, dimension=32, blob_width=20.0, blob_sigma=3.0, v_x=0.15, v_y=0.1,
                  intensity_scale=100.0, dy_mode="compat", **ALPHAS)
    a_s, a_r = np.array([100.0, 1000.0, 10000.0]), np.array([100.0, 10000.0])
    grid_s, grid_r = [a.ravel() for a in np.meshgrid(a_s, a_r, indexing="ij")]
    for offset in ([0.0, 0.0], [0.4, -0.3]):
        movie = synth.config_movie(config, offset)
        ours = sweeps.vary_regularisation(movie, a_s, a_r, **ALPHAS)
        ref = compare.sweep_reference(movie, grid_s, grid_r, config, "cpu")
        assert ours["converged"].all()
        for key in compare.SWEEP_STATS:
            rtol = 2e-5 if key in compare.JUDGED_STATS else 3e-4
            np.testing.assert_allclose(ours[key].ravel(), ref[key], rtol=rtol, err_msg=key)


def test_a_call_sweeps_each_movie_once_in_the_seeds_order(tmp_path, monkeypatch):
    seen = []
    sweep = sweeps.vary_regularisation

    def spy(movie, *a, **kw):
        seen.append(np.array(movie))
        return sweep(movie, *a, **kw)

    monkeypatch.setattr(sweeps, "vary_regularisation", spy)
    entry = tiny_entry(tmp_path)
    config = files.config(CONFIG, os.path.join(str(tmp_path), "portbench"))
    order = np.random.default_rng(SEED).permutation(len(config["start_offsets"]))
    result = entry(0)
    assert len(seen) == len(result["sweeps"]) == len(config["start_offsets"]) == 5
    for movie, start in zip(seen, order):
        np.testing.assert_array_equal(movie,
                                      synth.config_movie(config, config["start_offsets"][start]))
    assert result["pairs"] == 5 * 4 and result["iterations"] is None
    assert entry(1)["pairs"] == result["pairs"]  # every call the same work


def test_numbers_count_only_the_judged_cells_and_name_each_compared_cell(tmp_path, capsys):
    """Unconverged cells outside the judged set of their movie's start are
    not counted, those in it are, in every sweep of the window; each
    compared cell's line names its start, its alphas and its errors."""
    entry = tiny_entry(tmp_path)
    results = [entry(0), entry(1)]
    # the movies in the order of the sweeps: start 2 judges cells 1 and 2
    judged = [[cell for cell in (1, 2, 3) if (start, cell) != (2, 3)] for start in entry.order]
    assert [list(j) for j in entry.judged] == judged
    on_2 = int(np.flatnonzero(entry.order == 2)[0])
    other = (on_2 + 1) % 5
    results[0]["sweeps"][on_2]["converged"][[0, 1]] = False  # cell 0 is not judged
    results[1]["sweeps"][on_2]["converged"][[2, 3]] = False  # nor is cell 3 of start 2
    results[1]["sweeps"][other]["converged"][[0, 3]] = False  # but it is of every other start
    capsys.readouterr()
    numbers = entry.numbers(results, "cpu")
    assert numbers["unconverged_judged_cells"] == 3
    assert numbers["nonfinite_cells"] == 0
    assert set(numbers) == {"unconverged_judged_cells", "nonfinite_cells", "speed_means_rel",
                            "remodelling_variances_rel", "functional_rel"}
    lines = [line for line in capsys.readouterr().err.splitlines()
             if line.startswith("sweep_pool cell")]
    assert len(lines) == 4
    offsets = [str(o) for o in files.config(CONFIG)["start_offsets"]]
    for line in lines:
        start = [s for s, o in enumerate(offsets) if f"start {o} " in line]
        assert len(start) == 1, line
        a_s, a_r = (float(line.split(f"{a} ")[1].split()[0]) for a in ("alpha_s", "alpha_r"))
        assert [start[0], TINY["speed_alphas"].index(a_s),
                TINY["remodelling_alphas"].index(a_r)] in TINY_JUDGED
        for key in compare.JUDGED_STATS:
            assert float(line.split(f"{key}_rel ")[1].split()[0]) < 1e-3, line
    # a statistic that is not finite counts, judged or not
    results[0]["sweeps"][1]["functional"][0] = np.nan
    assert entry.numbers(results, "cpu")["nonfinite_cells"] == 1


def test_a_sound_tiny_run_is_correct(tmp_path):
    line = run_tiny(tmp_path)
    assert line["correct"], line["check"]
    assert line["attempted"] == 20 and line["failed"] == 0
    assert set(line["metrics"]) == {"pairs_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["state_unchanged", "speed_mean", "remodelling_var",
                                   "functional"])
def test_a_broken_timed_path_is_not_correct(tmp_path, fault):
    line = run_tiny(tmp_path, fault)
    assert not line["correct"], line["check"]


def _movie(frames):
    config = dict(frames=frames, dimension=20, blob_width=20.0, blob_sigma=3.0, v_x=0.15,
                  v_y=0.1, intensity_scale=100.0)
    return synth.config_movie(config, [0.0, 0.0])


@pytest.mark.parametrize("frames", [2, 3])
def test_each_chunk_records_its_cells_iterations_and_unconverged_cells(monkeypatch, frames):
    """Three cells in chunks of two cells and one: ``sweep/chunk_cells`` the
    chunk sizes, ``sweep/chunk_cell_iterations`` the sum over the chunk's
    cells of each cell's iterations (its pairs' mean), and the counter
    ``sweep/unconverged_cells`` the cells whose flag is false (one cell
    held to 2 iterations does not converge)."""
    infos = []
    solve = sweeps.solve_frame_pair

    def spy(*a, **kw):
        u, info = solve(*a, **kw)
        infos.append(info["iterations"].numpy().copy())
        return u, info

    monkeypatch.setattr(sweeps, "solve_frame_pair", spy)
    pairs = frames - 1
    observability.reset()
    out = sweeps.vary_regularisation(_movie(frames), [100.0, 1000.0, 1e4], [300.0],
                                     batch_chunk=2 * pairs, **ALPHAS)
    series, counts = observability.values(), observability.counts()
    assert series["sweep/chunk_cells"] == [2.0, 1.0]
    expected = [its.reshape(-1, pairs).mean(axis=1).sum() for its in infos]
    assert series["sweep/chunk_cell_iterations"] == pytest.approx(expected)
    assert series["sweep/chunk_max_iterations"] == [float(its.max()) for its in infos]
    assert counts["sweep/unconverged_cells"] == int(np.sum(~out["converged"])) == 0
    # the benchmark's readers on these readings
    slots = sum(its.max() * n for its, n in zip(infos, (2, 1)))
    readings = {"series": series, "counters": counts}
    assert files.metric_reader("sweep.cell_iterations")(readings) == pytest.approx(
        sum(expected) / 3)
    assert files.metric_reader("sweep.wasted_share")(readings) == pytest.approx(
        1.0 - sum(expected) / slots)
    assert files.metric_reader("sweep.unconverged_share")(readings) == 0.0

    observability.reset()
    out = sweeps.vary_regularisation(_movie(frames), [100.0, 1000.0, 1e4], [300.0],
                                     batch_chunk=2 * pairs,
                                     solver=SolverConfig(max_iterations=2, refinement_restarts=0),
                                     **ALPHAS)
    unconverged = int(np.sum(~out["converged"]))
    assert observability.counts()["sweep/unconverged_cells"] == unconverged > 0


READINGS = {"series": {"sweep/chunk_max_iterations": [10.0, 4.0],
                       "sweep/chunk_cell_iterations": [12.0, 4.0],
                       "sweep/chunk_cells": [2.0, 1.0]},
            "counters": {"sweep/unconverged_cells": 1, "krylov/host_syncs": 7}}


@pytest.mark.parametrize("stem, expected", [("sweep.wasted_share", 1.0 - 16.0 / 24.0),
                                            ("sweep.cell_iterations", 16.0 / 3.0),
                                            ("sweep.unconverged_share", 1.0 / 3.0)])
def test_the_sweep_readers_read_their_series_or_nothing(stem, expected):
    read = files.metric_reader(stem)
    assert read.__code__.co_filename.endswith(f"metrics/{stem}.py")
    assert read(READINGS) == pytest.approx(expected)
    # a program without the series and the counter (the parent's) reads nothing
    only_max = {"series": {"sweep/chunk_max_iterations": [10.0, 4.0]},
                "counters": {"krylov/host_syncs": 7}}
    assert read(only_max) is None and read({"series": {}, "counters": {}}) is None


def test_the_benchmark_lists_the_cell_and_its_metrics():
    bench = files.benchmark()
    w = files.workload(bench, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (CONFIG, MIX, 1)
    assert {m["name"] for m in files.end_to_end(bench, CELL)} == {"pairs_per_s", "setup_s"}
    assert {m["name"] for m in files.per_layer(bench, CELL)} == {
        "sweep.wasted_share", "sweep.cell_iterations", "sweep.unconverged_share",
        "multigrid.device_ms_per_pair", "matvec.device_ms_per_pair",
        "refinement.device_ms_per_pair", "kernels.launches_per_pair",
        "krylov.host_syncs_per_pair", "device.idle_share", "krylov.slot_columns_per_pair"}
    config = next(c for c in bench["configs"] if c["name"] == CONFIG)
    assert config["reduced"] == files.config(CONFIG)["reduced"]
    traffic = files.traffic(MIX)
    limits = files.limits(CELL)
    assert set(limits) == ({"unconverged_judged_cells", "nonfinite_cells", "plain_calls"}
                           | {f"{k}_rel" for k in compare.JUDGED_STATS})
    n_s = compare.config_alphas(files.config(CONFIG)["speed_alphas"]).size
    n_r = compare.config_alphas(files.config(CONFIG)["remodelling_alphas"]).size
    n_starts = len(files.config(CONFIG)["start_offsets"])
    judged = [tuple(c) for c in traffic["judged_cells"]]
    assert len(set(judged)) == len(judged)
    assert all(0 <= s < n_starts and 0 <= i < n_s and 0 <= j < n_r for s, i, j in judged)
