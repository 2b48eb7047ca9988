"""The 1024^2 embryo movie as the benchmark's cells ``embryo1024_twopass``
and ``embryo1024_pair``, on the CPU: the batched pass's chunk plan, chunked
solves against the one-chunk solve, the chunks' counter, series and span and
their reader, the row-checkpointed float64 reference against the plain one,
and the cells' entries on a tiny checkout, sound and with the timed path
broken.

The chunked solves are held to the one-chunk solve to 1e-12 relative in
float64 (each pair's arithmetic is its own; measured: equal, or 5e-14 apart
where a chunk of one pair sums in another order).  The row-checkpointed
reference recomputes each gain exactly as the forward pass solved it, so it
equals the plain reference to 1e-12 relative (measured: bit for bit).
This file imports no JAX.
"""

from torch_threads import one_intra_op_thread  # noqa: F401,I001 (autouse; first: see its module)

import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from opticalflow_tpu_torch.core.types import SolverConfig
from opticalflow_tpu_torch.flow import variational
from opticalflow_tpu_torch.utils import observability
from portbench import files, reference, reference_rows, synth

CELLS = {"embryo1024_twopass": "embryo_twopass", "embryo1024_pair": "embryo_pair"}
CONFIG = "embryo_1024"
SEED = 2**31 + 23
TINY = dict(dimension=24, blob_width=20.0, frames=6)
F64 = dict(delta_x=0.1, delta_t=1.0, speed_alpha=1000.0, remodelling_alpha=1000.0,
           solver=SolverConfig(method="gmres", matvec="xla", refinement_restarts=0),
           dtype=torch.float64, device="cpu")


# --- the chunk plan ---------------------------------------------------------

@pytest.mark.parametrize("pairs, fit, expected", [
    (49, 49, [49]), (49, 1000, [49]), (49, 48, [25, 24]), (49, 33, [25, 24]),
    (49, 24, [17, 16, 16]), (7, 3, [3, 2, 2]), (6, 3, [3, 3]), (5, 0.5, [1] * 5),
    (1, 0, [1])])
def test_the_plan_fits_balanced_chunks_of_at_least_one_pair(pairs, fit, expected):
    per_pair = 1.5e9
    plan = variational.plan_chunks(pairs, per_pair, fit * per_pair)
    assert plan == expected
    assert sum(plan) == pairs and max(plan) - min(plan) <= 1 and min(plan) >= 1
    assert variational.plan_chunks(pairs, per_pair, fit * per_pair) == plan  # the same plan twice


def test_the_plan_is_one_chunk_on_the_cpu_and_reads_the_cards_memory(monkeypatch):
    assert variational.batch_plan(49, 1022, 1022, 32, torch.float32, torch.device("cpu")) == [49]

    class Props:
        total_memory = 85_017_493_504

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: Props)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device: 306_188_288)
    card = torch.device("cuda", 0)
    per_pair = variational.ALLOCATOR_SLACK * variational.pair_bytes(1022, 1022)
    fit = int((0.9 * Props.total_memory - 306_188_288) // per_pair)
    assert variational.batch_plan(49, 1022, 1022, 32, torch.float32, card) == \
        variational.plan_chunks(49, per_pair, fit * per_pair) == [25, 24]
    # the 512^2 stack fits whole
    assert variational.batch_plan(49, 510, 510, 32, torch.float32, card) == [49]


def test_pair_bytes_sums_the_solves_planes():
    """Each FGMRES column adds two three-field rows (V and Z), float64 twice
    float32, and at 1022^2 the total is 357 planes of the interior (the
    card's slope, PERF.md §6: 358)."""
    m, n = 1022, 1022
    base = variational.pair_bytes(m, n)
    assert variational.pair_bytes(m, n, 33) - base == 2 * 3 * m * n * 4
    assert variational.pair_bytes(m, n, dtype=torch.float64) == 2 * base
    assert base / (m * n * 4) == pytest.approx(357.1, abs=0.1)
    # one multigrid level more at 1022 than at 510: the same planes a pixel
    assert variational.pair_bytes(510, 510) / (510 * 510 * 4) == pytest.approx(357.3, abs=0.1)


# --- chunked solves ---------------------------------------------------------

def _movie():
    config = dict(frames=6, dimension=64, blob_width=20.0, blob_sigma=3.0, v_x=0.15, v_y=0.1,
                  intensity_scale=100.0)
    return synth.config_movie(config, (0.0, 0.0)).astype(np.float64)


def _forced(monkeypatch, chunks):
    plans = []

    def plan(pairs, *args):
        size, extra = divmod(pairs, chunks)
        plans.append([size + 1] * extra + [size] * (chunks - extra))
        return plans[-1]

    monkeypatch.setattr(variational, "batch_plan", plan)
    return plans


@pytest.fixture(scope="module")
def one_chunk():
    return {ws: variational.variational_optical_flow(_movie(), warm_start=ws, **F64)
            for ws in ("two-pass", "cold")}


@pytest.mark.parametrize("chunks", [1, 2, 3])
@pytest.mark.parametrize("warm_start", ["two-pass", "cold"])
def test_chunks_equal_the_one_chunk_solve(one_chunk, monkeypatch, warm_start, chunks):
    plans = _forced(monkeypatch, chunks)
    result = variational.variational_optical_flow(_movie(), warm_start=warm_start, **F64)
    assert len(plans) == 1 and len(plans[0]) == chunks
    assert sum(plans[0]) == (4 if warm_start == "two-pass" else 5)
    whole = one_chunk[warm_start]
    assert result["converged_all"].all()
    np.testing.assert_array_equal(result["iterations"], whole["iterations"])
    for key in ("v_x", "v_y", "remodelling"):
        scale = np.abs(whole[key]).max()
        assert np.abs(result[key] - whole[key]).max() <= 1e-12 * scale, key
    # a residual is b - A x, ~1e-7 of b: its rounding (1e-16 of b) is 1e-9 of it
    np.testing.assert_allclose(result["residual_norms"], whole["residual_norms"], rtol=1e-8)
    for key in ("L1_functional", "remodelling_functional", "speed_functional"):
        assert result[key] == pytest.approx(whole[key], rel=1e-12), key


@pytest.mark.parametrize("warm_start, pairs", [("two-pass", 4), ("cold", 5)])
def test_each_chunk_is_counted_recorded_and_spanned_once(monkeypatch, warm_start, pairs):
    """Three chunks: three ``variational/batch_chunks``, the series
    ``variational/chunk_pairs`` the plan, three ``variational/chunk`` spans
    inside the call's ``variational/solve``; two-pass's pair 0 is no chunk."""
    plans = _forced(monkeypatch, 3)
    calls = []
    solve = variational.solve_frame_pair

    def spy(prev, cur, u0, *a, **kw):
        calls.append(prev.shape[0])
        return solve(prev, cur, u0, *a, **kw)

    monkeypatch.setattr(variational, "solve_frame_pair", spy)
    observability.reset()
    variational.variational_optical_flow(_movie(), warm_start=warm_start, **F64)
    counts, stats = observability.counts(), observability.span_statistics()
    assert plans == [[2, 1, 1] if pairs == 4 else [2, 2, 1]]
    assert counts["variational/batch_chunks"] == 3
    assert observability.values()["variational/chunk_pairs"] == [float(c) for c in plans[0]]
    assert stats["variational/chunk"]["count"] == 3
    assert stats["variational/chunk"]["total"] <= stats["variational/solve"]["total"]
    assert calls == ([1] if warm_start == "two-pass" else []) + plans[0]
    read = files.metric_reader("solve.chunks_per_call")
    assert read({"counters": counts, "calls": 1}) == 3.0


def test_a_sequential_movie_has_no_chunks():
    observability.reset()
    variational.variational_optical_flow(_movie()[:3], warm_start="sequential", **F64)
    assert "variational/batch_chunks" not in observability.counts()
    assert "variational/chunk_pairs" not in observability.values()


def test_the_chunks_reader_reads_its_counter_or_nothing():
    read = files.metric_reader("solve.chunks_per_call")
    assert read.__code__.co_filename.endswith("metrics/solve.chunks_per_call.py")
    assert read({"calls": 4, "counters": {"variational/batch_chunks": 8}}) == 2.0
    assert read({"calls": 4, "counters": {"krylov/host_syncs": 8}}) is None
    m = {m["name"]: m for m in files.benchmark()["per_layer"]}["solve.chunks_per_call"]
    assert (m["workloads"], m["moves"], m["layer"], m["unit"], m["better"], m["source"]) == (
        ["embryo1024_twopass"], "pairs_per_s", "pair solve", "chunks/call", "lower",
        "program_counter")


# --- the row-checkpointed reference ------------------------------------------

def _system(m, n=5, batch=2, seed=0):
    g = torch.Generator().manual_seed(seed + m)
    stencil = torch.randn((batch, 3, 3, 3, 3, m, n), generator=g, dtype=torch.float64)
    stencil[:, range(3), range(3), 1, 1] += 30.0  # diagonally dominant
    return stencil, torch.randn((batch, 3, m, n), generator=g, dtype=torch.float64)


@pytest.mark.parametrize("m", [7, 16, 33])
@pytest.mark.parametrize("segment", [1, 3, "m", None])
def test_the_checkpointed_solve_equals_the_plain_one(m, segment):
    stencil, rhs = _system(m)
    k = m if segment == "m" else segment
    stats = {}
    ours = reference_rows.solve(stencil, rhs, k, stats)
    plain = reference.solve(stencil, rhs)
    assert (ours - plain).abs().max() <= 1e-12 * plain.abs().max()
    k = k or math.isqrt(m - 1) + 1
    # the checkpoints and one segment's gains at most
    assert stats["gains_alive"] <= math.ceil(m / k) + k
    if segment is None:
        assert stats["gains_alive"] <= 2 * math.ceil(math.sqrt(m)) + 1


def test_the_checkpointed_fields_keep_the_plain_contract():
    config = dict(frames=3, dimension=14, blob_width=20.0, blob_sigma=3.0, v_x=0.15, v_y=0.1,
                  intensity_scale=100.0)
    movie = torch.from_numpy(synth.config_movie(config, (0.0, 0.0))).double()
    args = (movie[:-1], movie[1:], 1000.0, 1000.0)
    for ours, plain in zip(reference_rows.movie_fields(*args), reference.movie_fields(*args)):
        assert ours.shape == plain.shape
        assert (ours - plain).abs().max() <= 1e-12 * plain.abs().max()


def test_a_1022_pair_needs_6_gb_of_the_checkpointed_reference():
    # 76.9 GB of gains in the plain reference
    assert 1022 * (3 * 1022) ** 2 * 8 == pytest.approx(76.9e9, rel=1e-3)
    assert reference_rows.pair_bytes(1022, 1022) == pytest.approx(6.0e9, rel=0.01)


# --- the cells ---------------------------------------------------------------

@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_cell_its_config_and_its_mix_are_found(cell):
    bench = files.benchmark()
    w = files.workload(bench, cell)
    assert (w["config"], w["traffic"], w["chips"]) == (CONFIG, CELLS[cell], 1)
    assert files.per_layer(bench, cell)
    assert {m["name"].split(".")[0] for m in files.end_to_end(bench, cell)} == {
        "pairs_per_s", "setup_s"}
    config = files.config(CONFIG)
    entry = next(c for c in bench["configs"] if c["name"] == CONFIG)
    assert entry["reduced"] == config["reduced"] == []
    assert (config["dimension"], config["frames"], config["blob_width"]) == (1024, 51, 80.0)
    assert config["delta_x"] == 105 / 1024 and config["delta_t"] == 10.0
    assert config["solver"] == files.config("actin_512")["solver"]
    assert set(files.limits(cell)) == {"unconverged_pairs", "nonfinite_pairs", "epe_px",
                                       "remodelling_rel", "plain_calls"}
    traffic = files.traffic(CELLS[cell])
    assert files.entry(traffic["entry"]) is not None


def tiny_checkout(tmp_path, cell):
    """A checkout holding the cell at 24x24 (6 frames) on the real entries
    and readers, its mix and limits (kernels run as their plain versions on
    the CPU, so ``plain_calls`` is not held to 0)."""
    here = tmp_path / "portbench"
    for sub in ("configs", "traffic", "limits"):
        (here / sub).mkdir(parents=True)
    for sub in ("entries", "metrics"):
        shutil.copytree(os.path.join(files.HERE, sub), here / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(files.HERE, "kernel_families.json"), here)
    bench = files.benchmark()
    w = files.workload(bench, cell)
    (here / "configs" / f"{CONFIG}.json").write_text(json.dumps(dict(files.config(CONFIG), **TINY)))
    traffic = dict(files.traffic(w["traffic"]), warmup_frames=min(TINY["frames"], 6))
    (here / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(traffic))
    (here / "limits" / f"{cell}.json").write_text(json.dumps(dict(files.limits(cell),
                                                                 plain_calls=1e12)))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(tmp_path), str(here)


# a whole run in a fresh interpreter: the harness refuses a process that
# has loaded JAX, as this suite's conftest does.  The batched pass runs in
# two chunks, as on the card.
RUNNER = """
import json, math, sys, time
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from portbench import harness
from opticalflow_tpu_torch.flow import variational
from opticalflow_tpu_torch.solve import krylov

variational.batch_plan = lambda pairs, *a: variational.plan_chunks(pairs, 1.0, math.ceil(pairs / 2))
if {fault!r} == "state_unchanged":
    # every Krylov solve steps but hands back its start
    for name in ("bicgstab", "fgmres", "cg"):
        def frozen(matvec, b, x0=None, *a, _solver=getattr(krylov, name), **kw):
            res = _solver(matvec, b, x0=x0, *a, **kw)
            return res._replace(x=(torch.zeros_like(b) if x0 is None else x0).clone())
        setattr(krylov, name, frozen)
elif {fault!r} == "chunks_swapped":
    # the batched pass's chunks handed back in the wrong order
    solve_batched = variational._solve_batched
    def swapped(*a, **kw):
        us, infos = solve_batched(*a, **kw)
        return us[::-1], infos[::-1]
    variational._solve_batched = swapped
elif {fault!r} == "flow_scaled":
    # every pair's velocity 5% off
    solve_frame_pair = variational.solve_frame_pair
    def scaled(*a, **kw):
        u, info = solve_frame_pair(*a, **kw)
        return torch.cat([u[:, :2] * 1.05, u[:, 2:]], dim=1), info
    variational.solve_frame_pair = scaled
line = harness.run_cell({cell!r}, {seed}, 0.0, False, time.perf_counter(), device="cpu",
                        root={root!r}, here={here!r})
print(json.dumps(line))
"""


def run_tiny(tmp_path, cell, fault=""):
    root, here = tiny_checkout(tmp_path, cell)
    script = RUNNER.format(repo=files.ROOT, fault=fault, cell=cell, seed=SEED, root=root,
                           here=here)
    done = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert done.returncode == 0, done.stderr[-4000:]
    return json.loads(done.stdout.strip().splitlines()[-1]), done.stderr


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_tiny_run_is_correct(tmp_path, cell):
    line, err = run_tiny(tmp_path, cell)
    assert line["correct"], line["check"]
    assert line["failed"] == 0
    assert line["attempted"] == (5 if cell == "embryo1024_twopass" else 1)
    assert set(line["metrics"]) == {"pairs_per_s", "setup_s"} or set(line["metrics"]) == {
        "pairs_per_s.sequential", "setup_s"}
    compared = [x for x in err.splitlines() if x.startswith("movie_rows call")]
    if cell == "embryo1024_twopass":
        # pair 0, the last pair, and a pair of the first chunk (1-2 of 1-4)
        pairs = sorted(int(x.split(" pair ")[1].split()[0]) for x in compared)
        assert pairs[0] == 0 and pairs[-1] == 4 and any(p in (1, 2) for p in pairs)
        assert len(pairs) == len(set(pairs)) == 5
        assert line["window"]["counters"]["variational/batch_chunks"] == 2
    else:
        assert len(compared) == 1


@pytest.mark.parametrize("cell, fault", [
    ("embryo1024_twopass", "state_unchanged"), ("embryo1024_twopass", "chunks_swapped"),
    ("embryo1024_twopass", "flow_scaled"), ("embryo1024_pair", "state_unchanged"),
    ("embryo1024_pair", "flow_scaled")])
def test_a_broken_timed_path_is_not_correct(tmp_path, cell, fault):
    line, _ = run_tiny(tmp_path, cell, fault)
    assert not line["correct"], line["check"]


def test_the_sample_holds_a_pair_of_every_solve():
    """Pair 0 of the first call, the last pair of the last call, a pair of
    every chunk, no two at the same pair index."""
    spec = importlib.util.spec_from_file_location(
        "movie_rows", os.path.join(files.HERE, "entries", "movie_rows.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    plan = module.solves("two-pass", 50, [17, 16, 16])
    assert plan == [(0, 1), (1, 18), (18, 34), (34, 50)]
    results = [{"pairs": 50, "solves": plan} for _ in range(3)]
    for seed in range(20):
        sample = module.sample_pairs(results, 6, np.random.default_rng(seed))
        pairs = [p for _, p in sample]
        assert len(sample) == 6 and len(set(pairs)) == 6
        assert (0, 0) in sample and (2, 49) in sample
        for lo, hi in plan:
            assert any(lo <= p < hi for p in pairs), (lo, hi, sample)
    assert module.solves("cold", 5, []) == [(0, 5)]
    assert module.solves("two-pass", 5, []) == [(0, 1), (1, 5)]
    assert module.solves("sequential", 5, [2, 3]) == [(0, 5)]


def test_a_rows_z_is_no_view_of_its_solve():
    """The forward pass keeps every row's z: a view would keep every row's
    solve, gain and all, alive (the plain reference's memory)."""
    stencil, rhs = _system(7)
    b = rhs.permute(0, 2, 1, 3).reshape(2, 7, 15)
    gain, z = reference_rows._row_gain(stencil, b, 0, 5, None, None)
    assert z.untyped_storage().data_ptr() != gain.untyped_storage().data_ptr()
    assert z.untyped_storage().nbytes() == z.numel() * 8
