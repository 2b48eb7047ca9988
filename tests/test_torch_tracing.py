"""The spans, counters and series inside the port's frame-pair solve
(utils.observability), and the benchmark's readers of them
(``portbench/metrics/``).

On the CPU: a 3-frame movie solved sequentially and two-pass records the
five ``pair/*`` phase spans once per ``solve_frame_pair`` call, the
sequential loop's per-pair series, a ``solve/host_wait`` span at every
counted read of the card, and the refinement's counters, each equal to what
it counts; under ``torch.profiler`` every span is also a
``record_function`` range that encloses its operations, and no range is
opened without a profile.  On the card (marked ``gpu``, skipped here):
every synchronising call of a sequential call, as the sync debug mode
reports them, lies inside a ``solve/host_wait`` or ``variational/to_host``
span.  This file imports no JAX.
"""

from torch_threads import one_intra_op_thread  # noqa: F401,I001 (autouse; first: see its module)

import contextlib
import statistics
import traceback
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from opticalflow_tpu_torch import variational_optical_flow
from opticalflow_tpu_torch.core.synth import make_translating_blob_movie
from opticalflow_tpu_torch.flow import variational
from opticalflow_tpu_torch.solve import krylov, multigrid
from opticalflow_tpu_torch.utils import observability
from portbench import files

PHASES = ("pair/pair_data", "pair/mg_setup", "pair/krylov_main", "pair/refinement",
          "pair/finish")
SYNC_SPANS = {observability.HOST_WAIT, "variational/to_host"}


def _movie(frames: int, dimension: int) -> np.ndarray:
    movie, _ = make_translating_blob_movie(n_frames=frames, dimension=dimension, width=20.0,
                                           sigma=3.0, v_x=0.15, v_y=0.1)
    return (movie * 100.0).astype(np.float32)


def _flow(movie, warm_start: str, device="cpu"):
    return variational_optical_flow(movie, speed_alpha=1000.0, remodelling_alpha=1000.0,
                                    warm_start=warm_start, device=device)


def _counting(monkeypatch, module, name: str) -> list:
    """A one-item list counting the calls of ``module.name`` from here on."""
    calls, fn = [0], getattr(module, name)

    def counted(*args, **kwargs):
        calls[0] += 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("warm_start", ["sequential", "two-pass"])
def test_a_movie_records_each_phase_per_pair_call(warm_start, monkeypatch):
    """Three frames: two ``solve_frame_pair`` calls either way (pair by pair,
    or pair 0 then the rest); each records the five phase spans once, the
    refinement loop one step per Krylov solve (the main solve and one
    correction solve per pass but the last), the sequential loop one
    ``variational/pair_s`` value per pair; every counted read of the card
    is inside a ``solve/host_wait`` span, and the copies to the host are one
    span a call."""
    pair_calls = _counting(monkeypatch, variational, "solve_frame_pair")
    solves = _counting(monkeypatch, krylov, "bicgstab")
    observability.reset()
    result = _flow(_movie(3, 24), warm_start)
    assert result["converged_all"].all()
    stats, counts = observability.span_statistics(), observability.counts()
    assert pair_calls[0] == 2
    for name in PHASES:
        assert stats[name]["count"] == pair_calls[0], name
    assert counts["refinement/steps"] == solves[0]
    assert "refinement/retakes" not in counts  # one pair a call: the active set never shrinks
    assert stats[observability.HOST_WAIT]["count"] >= counts["krylov/host_syncs"]
    assert stats["variational/to_host"]["count"] == stats["variational/solve"]["count"] == 1
    pair_s = observability.values().get("variational/pair_s", [])
    assert len(pair_s) == (2 if warm_start == "sequential" else 0)
    assert all(s > 0 for s in pair_s)


def test_refinement_counts_each_reslice_of_its_active_set(monkeypatch):
    """Four pairs whose refinement stops apart: every re-slice of the
    operators and hierarchy (one ``multigrid.take`` each) is a
    ``refinement/retakes``, and every pass of the loop a
    ``refinement/steps``."""
    movie = torch.from_numpy(_movie(2, 40))
    prev, cur = movie[:1].expand(4, 40, 40), movie[1:].expand(4, 40, 40)
    a_s = torch.tensor([100.0, 300.0, 3000.0, 1e5])
    a_r = torch.tensor([300.0, 1000.0, 100.0, 1e5])
    takes = _counting(monkeypatch, multigrid, "take")
    solves = _counting(monkeypatch, krylov, "bicgstab")
    observability.reset()
    _, info = variational.solve_frame_pair(prev, cur, torch.zeros(3, 40, 40), a_s, a_r)
    counts = observability.counts()
    assert info["converged"].all()
    assert counts["refinement/retakes"] == takes[0] > 0
    assert counts["refinement/steps"] == solves[0]


def test_spans_are_profiler_ranges_only_while_a_profile_runs(monkeypatch):
    """Without a profile no span opens a ``record_function`` range; under
    one every phase span is a range, and each encloses ``aten::`` ops."""
    opened, record_function = [], torch.profiler.record_function

    def spy(name):
        opened.append(name)
        return record_function(name)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    movie = _movie(3, 24)
    _flow(movie, "sequential")
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _flow(movie, "sequential")
    assert set(PHASES) | SYNC_SPANS <= set(opened)
    events = prof.events()
    ops = [(e.time_range.start, e.time_range.end) for e in events if e.name.startswith("aten::")]
    for name in PHASES + ("variational/to_host",):
        ranges = [e.time_range for e in events if e.name == name]
        assert ranges, name
        for r in ranges:
            assert any(r.start <= a and b <= r.end for a, b in ops), name


def test_a_sweep_chunk_keeps_its_own_span(monkeypatch):
    """``record_span`` callers that time from outside are unchanged: a
    recorded duration is kept as given, with no range opened."""
    opened = _counting(monkeypatch, torch.profiler, "record_function")
    observability.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        observability.record_span("sweep/chunk", 0.25)
    assert observability.span_statistics()["sweep/chunk"]["total"] == 0.25
    assert opened[0] == 0


READINGS = {
    "pairs": 4,
    "span_s": {"pair/pair_data": 0.004, "pair/mg_setup": 0.1, "pair/krylov_main": 0.2,
               "pair/refinement": 0.3, "pair/finish": 0.008, "solve/host_wait": 0.12,
               "variational/to_host": 0.02},
    "counters": {"refinement/steps": 10, "refinement/retakes": 2},
    "series": {"variational/pair_s": [0.1, 0.2, 0.15, 0.3, 0.12]},
}
SPAN_READERS = {
    "solve.pair_data_ms_per_pair": "pair/pair_data",
    "multigrid.setup_ms_per_pair": "pair/mg_setup",
    "krylov.main_ms_per_pair": "pair/krylov_main",
    "refinement.host_ms_per_pair": "pair/refinement",
    "solve.finish_ms_per_pair": "pair/finish",
    "solve.host_wait_ms_per_pair": "solve/host_wait",
    "entry.to_host_ms_per_pair": "variational/to_host",
}
EXPECTED = {
    **{stem: READINGS["span_s"][span] * 1e3 / 4 for stem, span in SPAN_READERS.items()},
    "refinement.steps_per_pair": 2.5,
    "refinement.retakes_per_pair": 0.5,
    "solve.pair_ms_p95": statistics.quantiles(READINGS["series"]["variational/pair_s"],
                                              n=20)[-1] * 1e3,
}


@pytest.mark.parametrize("stem", sorted(EXPECTED))
def test_readers_read_their_source_or_nothing(stem):
    """Each new reader: its value from the readings, None where its span,
    counter or series is absent (as at a program without them)."""
    for name in (stem, f"{stem}.sequential"):
        read = files.metric_reader(name)
        assert read.__code__.co_filename.endswith(f"metrics/{stem}.py")
        assert read(READINGS) == pytest.approx(EXPECTED[stem])
        assert read({"pairs": 4, "span_s": {}, "counters": {}, "series": {}}) is None


def test_retakes_read_zero_where_the_loop_never_reslices():
    """A window with refinement steps and no re-slice: 0 retakes a pair."""
    read = files.metric_reader("refinement.retakes_per_pair")
    assert read({"pairs": 4, "counters": {"refinement/steps": 8}}) == 0.0


def test_pair_latency_needs_two_pairs():
    read = files.metric_reader("solve.pair_ms_p95.sequential")
    assert read({"series": {"variational/pair_s": [0.1]}}) is None


def test_the_benchmark_lists_each_new_metric_in_its_cells():
    """Each new stem in ``BENCHMARK.json``: ``<stem>`` in the two-pass cell
    moving ``pairs_per_s``, ``<stem>.sequential`` in the sequential cell
    moving ``pairs_per_s.sequential``; the retakes in the two-pass cell alone
    (one pair a call never re-slices), the p95 in the sequential cell alone."""
    per_layer = {m["name"]: m for m in files.benchmark()["per_layer"]}
    two_pass_only, sequential_only = {"refinement.retakes_per_pair"}, {"solve.pair_ms_p95"}
    for stem in EXPECTED:
        if stem not in sequential_only:
            m = per_layer[stem]
            assert (m["workloads"], m["moves"]) == (["actin512_twopass"], "pairs_per_s"), stem
        if stem not in two_pass_only:
            m = per_layer[f"{stem}.sequential"]
            assert (m["workloads"], m["moves"]) == (["actin512_seq"],
                                                    "pairs_per_s.sequential"), stem
    assert sum(n.split(".sequential")[0] in EXPECTED for n in per_layer) == 18


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sync debug mode reports the card's syncs")
    return torch.device("cuda")


@pytest.mark.gpu
def test_every_sync_of_a_sequential_call_is_a_host_wait_or_the_copy_to_host(monkeypatch):
    """A sequential 2-pair call at 128x128 under
    ``torch.cuda.set_sync_debug_mode('warn')``: each synchronising call it
    reports is made inside a ``solve/host_wait`` or ``variational/to_host``
    span (the spans open at that moment are tracked by a wrapper of
    ``observability.span``)."""
    dev = _cuda()
    movie = _movie(3, 128)
    _flow(movie, "sequential", dev)  # builds and warms up
    torch.cuda.synchronize()
    open_spans, span = [], observability.span

    @contextlib.contextmanager
    def tracked(name):
        open_spans.append(name)
        try:
            with span(name):
                yield
        finally:
            open_spans.pop()

    monkeypatch.setattr(observability, "span", tracked)
    syncs = []

    def hook(message, *args, **kwargs):
        if "called a synchronizing CUDA operation" in str(message):
            syncs.append(tuple(open_spans))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result = _flow(movie, "sequential", dev)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert result["converged_all"].all()
    outside = [spans for spans in syncs if not SYNC_SPANS & set(spans)]
    assert syncs and not outside, outside


@pytest.mark.gpu
def test_a_sweep_chunk_copies_to_the_host_once_a_statistic_and_once_for_its_iterations(
        monkeypatch):
    """A 3-cell sweep of 64x64 in chunks of two cells and one under
    ``torch.cuda.set_sync_debug_mode('warn')``: of the synchronising calls
    made on ``analysis/sweeps.py``'s own lines (those of the chunk's solve
    are the sequential test's above), each chunk copies to the host once a
    statistic and once for its cells' iteration counts, as when it read
    only their maximum, and no line that records the chunk's series or
    counter synchronises."""
    from opticalflow_tpu_torch.analysis import sweeps

    dev = _cuda()
    movie = _movie(2, 64)
    grid = ([100.0, 1000.0, 1e4], [300.0])
    sweeps.vary_regularisation(movie, *grid, batch_chunk=2, device=dev)  # builds and warms up
    torch.cuda.synchronize()
    lines = []

    def hook(message, *args, **kwargs):
        if "called a synchronizing CUDA operation" in str(message):
            own = [f for f in traceback.extract_stack()
                   if f.filename.endswith("analysis/sweeps.py")]
            if own and own[-1].name == "_batched_sweep":
                lines.append(own[-1].line)

    observability.reset()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            sweeps.vary_regularisation(movie, *grid, batch_chunk=2, device=dev)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    info = {k: torch.zeros(1) for k in ("converged", "L1_functional", "speed_functional",
                                        "remodelling_functional")}
    n_stats = len(sweeps._chunk_statistics(torch.zeros(1, 3, 4, 4), info, 1, 1, 1.0))
    assert observability.values()["sweep/chunk_cells"] == [2.0, 1.0]
    assert sum(".cpu()" in line for line in lines) == 2 * (n_stats + 1), lines
    assert not [line for line in lines if "observability" in line], lines
