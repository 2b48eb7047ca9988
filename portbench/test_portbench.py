"""The benchmark's own tests: ``python -m pytest portbench -q``.

On the CPU: discovery by name, the window and busy arithmetic, the kernel
families, the frozen generator, the reference against the program's
float64 direct solve, the import rules, and whole runs of a tiny cell on
the CPU, sound and with the program's timed path broken underneath, which
must come out not correct.  Marked ``gpu`` (it skips without a card):
the control, the program with its df32 refinement switched off, on the
card at the two-pass cell's widths, which must come out not correct.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import busy, compare, files, harness, profiled, reference, synth, window

KEYS = ("correct", "attempted", "failed", "metrics", "device")
SEQ, TWOPASS = "actin512_seq", "actin512_twopass"
# the sweep's entry, configuration and mix, which no cell of BENCHMARK.json
# runs yet (PERF.md, Open questions), and limits for its tiny CPU runs
SWEEP_CONFIG, SWEEP_MIX = "sweep_512", "sweep_grid20"
SWEEP_LIMITS = {"unconverged_cells": 0, "nonfinite_cells": 0, "speed_means_rel": 1e-3,
                "remodelling_variances_rel": 1e-3, "functional_rel": 1e-3}


@pytest.fixture(autouse=True)
def one_thread():
    # threaded CPU LAPACK here has failed on the reference's block solves
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tiny_checkout(tmp_path, entry: str):
    """A checkout holding one tiny cell of ``entry`` on the real entries,
    metric readers and family map, with the two-pass cell's metrics and
    limits (the sweep's: ``SWEEP_LIMITS``)."""
    here = tmp_path / "portbench"
    for sub in ("configs", "traffic", "limits"):
        (here / sub).mkdir(parents=True)
    for sub in ("entries", "metrics"):
        shutil.copytree(os.path.join(files.HERE, sub), here / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(files.HERE, "kernel_families.json"), here)
    bench = files.benchmark()
    if entry == "movie":
        w = files.workload(bench, TWOPASS)
        config = dict(files.config(w["config"]), frames=4, dimension=40, blob_width=20.0)
        traffic = dict(files.traffic(w["traffic"]), warmup_frames=4, check_pairs=2)
        cell, limits = "tiny_movie", files.limits(TWOPASS)
    else:
        config = dict(files.config(SWEEP_CONFIG), dimension=40, blob_width=20.0,
                      speed_alphas=[100.0, 1000.0], remodelling_alphas=[100.0, 1000.0])
        traffic = dict(files.traffic(SWEEP_MIX), check_cells=4)
        cell, limits = "tiny_sweep", SWEEP_LIMITS
    (here / "configs" / "tiny.json").write_text(json.dumps(config))
    (here / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    # on the CPU every kernel runs as its plain version
    (here / "limits" / f"{cell}.json").write_text(json.dumps(dict(limits, plain_calls=1e12)))
    # the two-pass cell's metrics (the sweep's would name its own rate)
    e2e, per_layer = files.end_to_end(bench, TWOPASS), files.per_layer(bench, TWOPASS)
    bench["workloads"] = [{"name": cell, "config": "tiny", "traffic": "tiny", "chips": 1,
                           "why": "tiny"}]
    bench["end_to_end"] = [dict(m, workloads=[cell]) for m in e2e]
    bench["per_layer"] = [dict(m, workloads=[cell]) for m in per_layer]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell, str(tmp_path), str(here)


def run_tiny(tmp_path, entry, **kw):
    cell, root, here = tiny_checkout(tmp_path, entry)
    return harness.run_cell(cell, 2**31 + 17, 0.0, False, time.perf_counter(), device="cpu",
                            root=root, here=here, **kw)


# ---------------------------------------------------------------- discovery

def test_every_cell_finds_its_files():
    bench = files.benchmark()
    for w in bench["workloads"]:
        files.config(w["config"])
        files.traffic(w["traffic"])
        assert set(files.limits(w["name"])) >= {"plain_calls"}
        assert files.per_layer(bench, w["name"])
    for c in bench["configs"]:
        assert files.config(c["name"])["name"] == c["name"]
        assert c["file"] == f"portbench/configs/{c['name']}.json"
    for m in bench["per_layer"]:
        assert callable(files.metric_reader(m["name"]))


def test_a_new_metric_is_taken_from_its_own_file(tmp_path):
    here = tmp_path / "portbench"
    shutil.copytree(files.HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    (here / "metrics" / "calls.per_window.py").write_text(
        "def read(r):\n    return float(r['calls'])\n")
    bench = files.benchmark()
    bench["per_layer"].append({"name": "calls.per_window", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "device", "moves": "pairs_per_s"})
    # without a list of cells it goes to every cell that reports what it moves
    assert "calls.per_window" in [m["name"] for m in files.per_layer(bench, TWOPASS)]
    assert "calls.per_window" not in [m["name"] for m in files.per_layer(bench, SEQ)]
    assert files.metric_reader("calls.per_window", str(here))({"calls": 3}) == 3.0
    # and under the name of another cell's rate, by the same file
    assert files.metric_reader("calls.per_window.sequential", str(here))({"calls": 3}) == 3.0


def test_a_metric_is_read_by_the_longest_stem_that_has_a_file(tmp_path):
    read = files.metric_reader("krylov.host_syncs_per_pair.sequential")
    assert read.__code__.co_filename.endswith("metrics/krylov.host_syncs_per_pair.py")
    assert files.metric_reader("device.idle_share").__code__.co_filename.endswith(
        "metrics/device.idle_share.py")
    with pytest.raises(FileNotFoundError):
        files.metric_reader("nothing.of_the_kind")


ECHO_ENTRY = """
from portbench import synth  # an entry may use the benchmark's modules


class Entry:
    def __init__(self, config, traffic, seed, device, solver_overrides=None):
        self.pairs = traffic["pairs"]

    def warm_up(self):
        pass

    def __call__(self, k):
        return {"pairs": self.pairs, "iterations": 7 * self.pairs}

    def numbers(self, results, device):
        return {"echoed_pairs": sum(r["pairs"] for r in results) % self.pairs}

    @staticmethod
    def failed(numbers):
        return 0
"""


def test_a_new_entry_is_taken_from_its_own_file(tmp_path):
    """A mix whose entry is a new file of ``entries/`` runs with no other
    file of the benchmark edited: only new files and new lines of
    BENCHMARK.json."""
    here = tmp_path / "portbench"
    shutil.copytree(files.HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    (here / "entries" / "echo.py").write_text(ECHO_ENTRY)
    (here / "traffic" / "echo_mix.json").write_text(json.dumps({"entry": "echo", "pairs": 3,
                                                                 "trace_seconds": 1}))
    (here / "configs" / "echo_config.json").write_text(json.dumps({"name": "echo_config"}))
    (here / "limits" / "echo_cell.json").write_text(json.dumps({"echoed_pairs": 0,
                                                                "plain_calls": 1e12}))
    bench = files.benchmark()
    bench["workloads"].append({"name": "echo_cell", "config": "echo_config",
                               "traffic": "echo_mix", "chips": 1, "why": "echo"})
    bench["end_to_end"] = [dict(m, workloads=m.get("workloads", []) + ["echo_cell"])
                           if m["name"] in ("pairs_per_s", "setup_s") and "workloads" in m else m
                           for m in bench["end_to_end"]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    line = harness.run_cell("echo_cell", 3, 0.0, False, time.perf_counter(), device="cpu",
                            root=str(tmp_path), here=str(here))
    assert line["correct"] and line["attempted"] == 3, line
    assert {"pairs_per_s", "setup_s"} <= set(line["metrics"])


def test_per_layer_respects_workloads_lists():
    bench = files.benchmark()
    seq = [m["name"] for m in files.per_layer(bench, SEQ)]
    twopass = [m["name"] for m in files.per_layer(bench, TWOPASS)]
    assert "solve.iterations_per_pair.sequential" in seq and "solve.iterations_per_pair" in twopass
    assert not set(seq) & set(twopass)
    for cell in (SEQ, TWOPASS):
        rates = {m["name"] for m in files.end_to_end(bench, cell)} - {"setup_s"}
        assert len(rates) == 1 and all(m["moves"] in rates for m in files.per_layer(bench, cell))


@pytest.mark.parametrize("name", [m["name"] for m in files.benchmark()["per_layer"]]
                         + ["sweep.batch_iterations"])
def test_each_reader_reads_or_returns_none(name):
    full = {"pairs": 50, "calls": 2, "window_s": 10.0, "busy_s": 2.5,
            "family_s": {"matvec": 0.5, "refinement": 0.25, "multigrid": 1.0},
            "counters": {"krylov/host_syncs": 100, "LAUNCHES": 1000, "DF_LAUNCHES": 50,
                         "PLAIN_CALLS": 0},
            "span_s": {"krylov/capture": 0.2}, "series": {"sweep/chunk_max_iterations": [3, 5]},
            "iterations": 500}
    empty = dict(full, busy_s=0.0, family_s={}, counters={}, span_s={}, series={},
                 iterations=None)
    read = files.metric_reader(name)
    value = read(full)
    assert isinstance(value, float) and np.isfinite(value) and value >= 0
    assert read(empty) is None


# ---------------------------------------------------------------- arithmetic

def test_window_takes_whole_calls_and_the_whole_wall():
    ticks = iter([0.0, 0.5, 3.5, 3.5, 7.0, 7.2, 11.0])
    durations = []

    def call(k):
        durations.append(k)
        return 10 + k

    calls = window.run(call, lambda r: r, 7.0, clock=lambda: next(ticks))
    # the call ending at 7.0 ends the window: 7.0 - 0.0 >= 7.0; none cut
    assert [c.pairs for c in calls] == [10, 11]
    assert window.wall(calls) == pytest.approx(6.5)  # first start 0.5 to last end 7.0
    assert window.pairs_per_s(calls) == pytest.approx(21 / 6.5)


def test_window_runs_past_the_limit_to_the_end_of_a_call():
    ticks = iter([0.0, 0.0, 4.0, 4.0, 9.5])
    calls = window.run(lambda k: 5, lambda r: r, 6.0, clock=lambda: next(ticks))
    assert len(calls) == 2 and window.wall(calls) == pytest.approx(9.5)
    assert window.pairs_per_s(calls) == pytest.approx(10 / 9.5)


def test_busy_union_counts_overlaps_once_and_finds_gaps():
    covered, gaps = busy.union([(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 9)])
    assert covered == pytest.approx(5.0)
    assert gaps == [(3, 5), (6, 8)]
    covered, gaps = busy.union([(0, 2), (5, 6)], lo=1, hi=5.5)
    assert covered == pytest.approx(1.5) and gaps == [(2, 5)]
    assert busy.union([]) == (0.0, [])


def test_reduce_sums_families_and_names_gaps():
    device = [("void el_df32_kernel<true>(float const*)", 0.0, 10.0),
              ("void (anonymous namespace)::sweep_restrict_kernel<4, 16>(Args)", 10.0, 14.0),
              ("_Z24el_matvec_reduced_kernelILi1EEvPKf", 30.0, 31.0),
              ("Memcpy DtoH (Device -> Pinned)", 50.0, 51.0)]
    host = [("aten::nonzero", 12.0, 52.0), ("aten::item", 20.0, 25.0),
            ("cudaGraphLaunch", 40.0, 41.0)]
    red = profiled.reduce(device, host, files.families())
    assert red["busy_s"] == pytest.approx(16e-6)
    assert red["family_s"] == pytest.approx({"refinement": 10e-6, "multigrid": 4e-6,
                                             "matvec": 1e-6})
    assert red["idle_gaps"] == [["cudaGraphLaunch", pytest.approx(19e-6)],
                                ["aten::item", pytest.approx(16e-6)]]
    assert red["device_ops"][0] == ["void el_df32_kernel<true>(float const*)",
                                    pytest.approx(10e-6)]


@pytest.mark.parametrize("kernel,family", [
    ("el_matvec_reduced_kernel", "matvec"), ("el_matvec_tiles_kernel", "matvec"),
    ("el_df32_kernel", "refinement"), ("mg_smooth_kernel", "multigrid"),
    ("restrict_kernel", "multigrid"), ("sweep_restrict_kernel", "multigrid"),
    ("prolong_kernel", "multigrid"), ("prolong_sweep_kernel", "multigrid"),
    ("ampere_sgemm_128x64_nn", None), ("Memset (Device)", None)])
def test_kernel_family_map(kernel, family):
    assert files.family_of(f"void {kernel}<2>(Args)", files.families()) == family


def test_family_map_names_every_kernel_of_the_program():
    src = os.path.join(files.ROOT, "opticalflow_tpu_torch", "csrc")
    text = "".join(open(os.path.join(src, f)).read() for f in os.listdir(src))
    import re
    kernels = set(re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\(", text))
    assert kernels and all(files.family_of(k, files.families()) for k in kernels), kernels


# ---------------------------------------------------------------- generator

@pytest.mark.parametrize("name", [c["name"] for c in files.benchmark()["configs"]] + [SWEEP_CONFIG])
def test_frozen_generator_gives_the_stated_movie(name):
    config = files.config(name)
    movie = synth.config_movie(config, config["start_offsets"][1])
    n, dim = config["frames"], config["dimension"]
    assert movie.shape == (n, dim, dim) and movie.dtype == np.float32
    assert movie.max() == pytest.approx(config["intensity_scale"], rel=1e-3)
    coords = np.linspace(0.0, config["blob_width"], dim)

    def centre(frame):
        w = frame.astype(np.float64)
        return np.array([(w.sum(1) * coords).sum(), (w.sum(0) * coords).sum()]) / w.sum()

    step = (centre(movie[-1]) - centre(movie[0])) / (n - 1)
    assert step == pytest.approx([config["v_x"], config["v_y"]], abs=2e-3)
    start = np.array(config["start_offsets"][1]) + config["blob_width"] / 2
    assert centre(movie[0]) == pytest.approx(start, abs=2e-3)
    # a Gaussian hat exp(-r^2 / sigma^2): its second moment is sigma^2 / 2 an axis
    w = movie[0].astype(np.float64).sum(1)
    var = (w * (coords - centre(movie[0])[0]) ** 2).sum() / w.sum()
    assert np.sqrt(2 * var) == pytest.approx(config["blob_sigma"], rel=1e-2)
    again = synth.config_movie(config, config["start_offsets"][1])
    assert np.array_equal(movie, again)


def test_the_seed_orders_the_same_movies():
    config = files.config("actin_512")
    a = synth.config_movies(dict(config, frames=2, dimension=64), np.random.default_rng(1))
    b = synth.config_movies(dict(config, frames=2, dimension=64), np.random.default_rng(2))
    assert len(a) == len(config["start_offsets"])
    assert sorted(m.tobytes() for m in a) == sorted(m.tobytes() for m in b)
    assert [m.tobytes() for m in a] != [m.tobytes() for m in b]


# ---------------------------------------------------------------- reference

def _movie(dim, frames=3):
    config = dict(files.config("actin_512"), frames=frames, dimension=dim, blob_width=20.0)
    return config, synth.config_movie(config, (0.0, 0.0))


def test_reference_solves_its_system_and_matches_the_programs_direct_solve():
    from opticalflow_tpu_torch.flow.variational import variational_optical_flow

    config, movie = _movie(30)
    frames = torch.from_numpy(movie).double()
    u, s, planes, st, rhs, x = reference.reference_flow(frames[:-1], frames[1:], 1000.0, 1000.0)
    assert float((reference.apply(st, x) - rhs).norm() / rhs.norm()) < 1e-12
    direct = variational_optical_flow(movie, speed_alpha=1000.0, remodelling_alpha=1000.0,
                                      use_direct_solver=True, device="cpu")
    assert np.abs(direct["v_x"] - u[:, 0].numpy()).max() < 1e-10
    assert np.abs(direct["v_y"] - u[:, 1].numpy()).max() < 1e-10
    g = (u[:, 2] * s[:, None, None]).numpy()
    assert np.abs(direct["remodelling"] - g).max() < 1e-10 * np.abs(g).max()


def test_reference_operator_is_the_programs_operator():
    from opticalflow_tpu_torch.ops import elop

    _, movie = _movie(24)
    frames = torch.from_numpy(movie).double()
    st, rhs, s, _ = reference.pair_system(frames[:-1], frames[1:], 1000.0, 500.0)
    pair = elop.compute_frame_pair_data(frames[:-1] / s[:, None, None], frames[1:] / s[:, None, None],
                                        1000.0 / s**2, torch.full((2,), 500.0, dtype=torch.float64),
                                        "compat")
    x = torch.randn(2, 3, 22, 22, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    y = elop.el_matvec_reduced(pair.coeffs, x)
    assert float((reference.apply(st, x) - y).abs().max()) < 1e-12 * float(y.abs().max())
    assert torch.equal(rhs, pair.rhs[:, :, 1:-1, 1:-1])


def test_reference_sweep_statistics_are_the_programs_on_a_direct_solve():
    """The sweep's statistics and functional as the timed path defines them
    (``sweeps._chunk_statistics``), on the program's float64 direct solve,
    equal the reference's to rounding."""
    from opticalflow_tpu_torch.analysis import sweeps
    from opticalflow_tpu_torch.flow import variational

    config = dict(files.config(SWEEP_CONFIG), frames=2, dimension=24, blob_width=20.0)
    movie = synth.config_movie(config, (0.0, 0.0))
    a_s, a_r = (a.ravel() for a in np.meshgrid([100.0, 1000.0], [10.0, 1e4], indexing="ij"))
    solved = [variational._solve_movie_direct(torch.from_numpy(movie), None, s_, r_, "compat",
                                              None) for s_, r_ in zip(a_s, a_r)]
    u = torch.from_numpy(np.concatenate([u for u, _ in solved]))
    info = {k: torch.from_numpy(np.concatenate([i[k] for _, i in solved])) for k in solved[0][1]}
    stats = sweeps._chunk_statistics(u, info, a_s.size, 1, config["delta_x"] / config["delta_t"])
    ref = compare.sweep_reference(movie, a_s, a_r, config, "cpu")
    names = {"speed_means": "speed_mean", "speed_variances": "speed_var",
             "remodelling_means": "remodelling_mean", "remodelling_variances": "remodelling_var",
             "functional": "functional"}
    for key, name in names.items():
        assert np.abs(stats[name].numpy() - ref[key]).max() < 1e-9 * np.abs(ref[key]).max(), key


def test_sample_keeps_the_ends_and_draws_distinct_slots():
    sample = compare.sample_pairs([50, 50, 50], 12, np.random.default_rng(0))
    assert len(sample) == 12 and (0, 0) in sample and (2, 49) in sample
    assert len({p for _, p in sample}) == 12 and {c for c, _ in sample} == {0, 1, 2}
    assert sample == compare.sample_pairs([50, 50, 50], 12, np.random.default_rng(0))
    assert len(compare.sample_pairs([3, 3], 10, np.random.default_rng(0))) == 3
    assert compare.sample_pairs([1], 6, np.random.default_rng(0)) == [(0, 0)]


def test_reference_block_fits_its_budget():
    assert compare.reference_block((2, 512, 512), "cuda", 40e9) == 4
    assert compare.reference_block((2, 512, 512), "cuda", 1e9) == 1


def test_judge_needs_a_limit_for_every_number():
    out = compare.judge({"a": 1.0, "b": 3.0}, {"a": 1.0, "b": 2.0})
    assert out["a"]["ok"] and not out["b"]["ok"]
    with pytest.raises(KeyError):
        compare.judge({"c": 0.0}, {})


# ---------------------------------------------------------------- imports

def _modules_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, cwd=files.ROOT, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax_and_not_the_jax_package():
    code = ("import runpy, sys\nsys.argv = ['run.py']\n"
            "m = runpy.run_path('portbench/run.py', run_name='portbench_run')\n"
            "from portbench import harness, compare, profiled, files\n"
            "[files.entry(e) for e in ('movie', 'sweep')]\n"
            "import opticalflow_tpu_torch.flow.variational, opticalflow_tpu_torch.analysis.sweeps")
    loaded = _modules_after(code)
    assert "opticalflow_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "opticalflow_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    loaded = _modules_after("import portbench.reference, portbench.compare")
    assert not loaded & {"jax", "jaxlib", "flax", "opticalflow_tpu", "opticalflow_tpu_torch"}


def test_run_exits_without_a_card_and_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "actin512_seq",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=files.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_fails_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copytree(files.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(files.ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "actin512_seq",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


# ---------------------------------------------------------------- whole runs on the CPU

@pytest.mark.parametrize("entry", ["movie", "sweep"])
def test_a_sound_run_is_correct_and_has_the_five_keys(tmp_path, entry):
    line = run_tiny(tmp_path, entry)
    assert all(k in line for k in KEYS) and list(line)[-1] == "check"
    assert line["correct"], line["check"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in files.end_to_end(files.benchmark(), TWOPASS)}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    json.dumps(line)


def _broken(monkeypatch, fault):
    """Break the timed path underneath the harness."""
    from opticalflow_tpu_torch.analysis import sweeps
    from opticalflow_tpu_torch.flow import variational
    from opticalflow_tpu_torch.solve import krylov

    if fault == "state_unchanged":
        # every Krylov solve steps but hands back its start
        for name in ("bicgstab", "fgmres", "cg"):
            def frozen(matvec, b, x0=None, *a, _solver=getattr(krylov, name), **kw):
                res = _solver(matvec, b, x0=x0, *a, **kw)
                return res._replace(x=(torch.zeros_like(b) if x0 is None else x0).clone())

            monkeypatch.setattr(krylov, name, frozen)
        return
    if fault == "answer_altered":
        # a movie's velocity at one pixel of every pair, a sweep's speed mean
        chunk_statistics = sweeps._chunk_statistics

        def altered_stats(*a, **kw):
            out = chunk_statistics(*a, **kw)
            return dict(out, speed_mean=out["speed_mean"] * 1.01)

        monkeypatch.setattr(sweeps, "_chunk_statistics", altered_stats)
    original = variational.solve_frame_pair

    def broken(prev, cur, u0, *a, **kw):
        u, info = original(prev, cur, u0, *a, **kw)
        if fault == "half_batch" and u.shape[0] > 1:
            # the second half never solved: it returns the first half's answers
            half = u.shape[0] // 2
            u = torch.cat([u[:u.shape[0] - half], u[:half]])
            info = {k: torch.cat([v[:v.shape[0] - half], v[:half]]) for k, v in info.items()}
        elif fault == "answer_altered":
            u = u.clone()
            u[:, 0, u.shape[-2] // 2, u.shape[-1] // 2] += 0.01
        return u, info

    monkeypatch.setattr(variational, "solve_frame_pair", broken)
    monkeypatch.setattr(sweeps, "solve_frame_pair", broken)


@pytest.mark.parametrize("entry", ["movie", "sweep"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, entry, fault):
    _broken(monkeypatch, fault)
    line = run_tiny(tmp_path, entry)
    assert not line["correct"], line["check"]


# ---------------------------------------------------------------- on the card

def card_checkout(tmp_path):
    """The two-pass cell at its widths and limits, 6 frames of 512^2 for 51."""
    cell, root, here = tiny_checkout(tmp_path, "movie")
    here = tmp_path / "portbench"
    w = files.workload(files.benchmark(), TWOPASS)
    config = dict(files.config(w["config"]), frames=6)
    (here / "configs" / "tiny.json").write_text(json.dumps(config))
    (here / "traffic" / "tiny.json").write_text(json.dumps(files.traffic(w["traffic"])))
    (here / "limits" / f"{cell}.json").write_text(json.dumps(files.limits(TWOPASS)))
    return cell, root, str(here)


@pytest.mark.gpu
def test_on_the_card_sound_is_correct_and_the_control_is_not(tmp_path):
    """The control: the program with its df32 refinement switched off
    (float32 alone, below the configuration's precision)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell, root, here = card_checkout(tmp_path)
    for seed in (5, 6, 7):
        sound = harness.run_cell(cell, seed, 0.0, False, time.perf_counter(), root=root, here=here)
        control = harness.run_cell(cell, seed, 0.0, False, time.perf_counter(), root=root,
                                   here=here, solver_overrides={"refinement_restarts": 0})
        assert sound["correct"], sound["check"]
        assert not control["correct"], control["check"]


# ---------------------------------------------------------------- BENCHMARK.json

def test_benchmark_json_has_the_contract_shape():
    import re

    bench = files.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    assert bench["paths"] == ["portbench"] and bench["command"][1] == "portbench/run.py"
    assert 1 <= bench["run_seconds"] <= 51
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        reported = {m["name"] for m in files.end_to_end(bench, w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        assert files.per_layer(bench, w["name"])
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in files.end_to_end(bench, cell)}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and name.match(c["name"])
    assert len(json.dumps(bench)) < 64 * 1024
