"""The port's plots, observability additions and result cache against the
JAX package.

The plot helpers with numeric outputs are held to the JAX package's
exactly (the same numpy indexing); every plot and movie writer must write
its file from a port ``FlowResult`` whose fields are tensors (they go to
the host first).  Without ffmpeg a movie is written as a GIF beside the
requested name, as in the JAX package.
"""

from torch_threads import one_intra_op_thread  # noqa: F401,I001 (autouse; first: see its module)

import os

import numpy as np
import pytest
import torch

from opticalflow_tpu.utils import cache as jcache
from opticalflow_tpu.utils import observability as jobs
from opticalflow_tpu_torch.core.types import FlowResult
from opticalflow_tpu_torch.utils import cache, observability

plots = pytest.importorskip("opticalflow_tpu_torch.viz.plots")
jplots = pytest.importorskip("opticalflow_tpu.viz.plots")


def _flow(seed=0, pairs=2, shape=(20, 24), tensors=True):
    rng = np.random.default_rng(seed)
    v_x, v_y = rng.normal(0.02, 0.02, (2, pairs) + shape)
    fields = dict(v_x=v_x, v_y=v_y, speed=np.hypot(v_x, v_y),
                  remodelling=rng.normal(size=(pairs,) + shape),
                  original_data=rng.random((pairs + 1,) + shape) * 200.0,
                  blurred_data=rng.random((pairs + 1,) + shape) * 200.0)
    if tensors:
        fields = {k: torch.from_numpy(v) for k, v in fields.items()}
    return FlowResult(delta_x=0.5, delta_t=2.0, **fields)


def _written(path):
    """The file a writer made: ``path``, or for a movie its GIF fallback."""
    gif = os.path.splitext(path)[0] + ".gif"
    assert os.path.exists(path) or (path.endswith(".mp4") and os.path.exists(gif)), path
    return True


@pytest.mark.parametrize("arrow_boxsize", [3, 5])
def test_subsampling_matches_jax(arrow_boxsize):
    flow = _flow()
    host = FlowResult(**flow.to_dict())
    ours = plots.subsample_velocities_for_visualisation(flow, arrow_boxsize=arrow_boxsize)
    theirs = jplots.subsample_velocities_for_visualisation(host, arrow_boxsize=arrow_boxsize)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, np.asarray(b))
    steps = dict(host.to_dict(), v_x_steps=np.stack([host["v_x"]] * 3, axis=1),
                 v_y_steps=np.stack([host["v_y"]] * 3, axis=1))
    for a, b in zip(plots.subsample_velocities_for_visualisation(steps, 1, arrow_boxsize),
                    jplots.subsample_velocities_for_visualisation(steps, 1, arrow_boxsize)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_tint_below_mask_matches_jax():
    movie = np.random.default_rng(1).random((3, 9, 11)) * 255.0
    mask = movie < 100.0
    ours = plots.tint_below_mask(torch.from_numpy(movie), torch.from_numpy(mask))
    np.testing.assert_array_equal(ours, jplots.tint_below_mask(movie, mask))


def _liu_shen_steps():
    from opticalflow_tpu_torch.flow.liushen import conduct_variational_optical_flow_deprecated

    movie = np.random.default_rng(2).random((2, 16, 16)) * 100.0
    return conduct_variational_optical_flow_deprecated(
        movie, use_liu_shen=True, max_iterations=4, return_iterations=True,
        iteration_stepsize=2, device="cpu")


def _sweep():
    rng = np.random.default_rng(3)
    return {"speed_alpha_values": torch.tensor([10.0, 100.0, 1000.0]),
            "remodelling_alpha_values": torch.tensor([10.0, 100.0]),
            **{k: torch.from_numpy(rng.random((3, 2)) + 0.1)
               for k in ("speed_means", "speed_variances", "remodelling_means",
                         "remodelling_variances")},
            "converged": torch.tensor([[True, True], [True, False], [True, True]])}


def _parameter_sweep():
    rng = np.random.default_rng(4)
    return {"boxsizes": np.arange(5, 13, 2), "mean_speeds": torch.from_numpy(rng.random(4)),
            "speed_stds": torch.from_numpy(rng.random(4)),
            "local_speeds": torch.from_numpy(rng.random((2, 4))),
            "test_locations": np.array([[1.0, 2.0], [3.0, 4.0]])}


_MEASUREMENTS = {"x_start": np.array([3, 8]), "x_end": np.array([4, 9]),
                 "y_start": np.array([5, 10]), "y_end": np.array([5, 12])}

# writer name -> (call writing into directory d, the file names it writes)
WRITERS = {
    "make_velocity_overlay_movie": (lambda d: plots.make_velocity_overlay_movie(
        _flow(), os.path.join(d, "v.mp4"), dpi=40), ["v.mp4"]),
    "make_joint_overlay_movie": (lambda d: plots.make_joint_overlay_movie(
        _flow(), os.path.join(d, "j.mp4"), autoscale=True, dpi=30), ["j.mp4"]),
    "make_convergence_plots": (lambda d: plots.make_convergence_plots(
        _liu_shen_steps(), os.path.join(d, "c_"), dpi=30),
        ["c_speed_convergence.pdf", "c_remodelling_convergence.pdf", "c_compound_figures.mp4"]),
    "plot_regularisation_variation": (lambda d: plots.plot_regularisation_variation(
        _sweep(), os.path.join(d, "s.pdf"), use_log_axes=True, use_log_colorbar=True), ["s.pdf"]),
    "plot_angle_histogram": (lambda d: plots.plot_angle_histogram(
        _flow(), os.path.join(d, "a.pdf"), weighted=True, dpi=30), ["a.pdf"]),
    "plot_polar_angle_histogram": (lambda d: plots.plot_polar_angle_histogram(
        _flow(), _flow(1), os.path.join(d, "p.pdf"), dpi=30), ["p.pdf"]),
    "plot_speed_correlation": (lambda d: plots.plot_speed_correlation(
        _flow(), _flow(1), os.path.join(d, "c.png"), threshold=0.0, dpi=30), ["c.png"]),
    "make_two_channel_overlay_movie": (lambda d: plots.make_two_channel_overlay_movie(
        _flow(), _flow(1), os.path.join(d, "t.mp4"), arrow_boxsize=5, dpi=30), ["t.mp4"]),
    "plot_joint_speed_and_angle_histograms": (
        lambda d: plots.plot_joint_speed_and_angle_histograms(
            _flow(), _flow(1), os.path.join(d, "h.pdf"), dpi=30), ["h.pdf"]),
    "plot_angle_between_histogram": (lambda d: plots.plot_angle_between_histogram(
        _flow(), _flow(1), os.path.join(d, "b.pdf"), weighted=True, dpi=30), ["b.pdf"]),
    "plot_ground_truth_validation": (lambda d: plots.plot_ground_truth_validation(
        _flow(), _MEASUREMENTS, os.path.join(d, "g.pdf"), frame=1, dpi=30), ["g.pdf"]),
    "plot_parameter_sweep_summary": (lambda d: plots.plot_parameter_sweep_summary(
        _parameter_sweep(), os.path.join(d, "box"), "boxsizes", dpi=30),
        ["box_velocities.pdf", "box_local_velocities.pdf"]),
    "plot_intensity_histograms": (lambda d: plots.plot_intensity_histograms(
        [torch.rand(2, 8, 8) * 255, np.random.default_rng(5).random((2, 8, 8)) * 255],
        ["A", "B"], os.path.join(d, "i.pdf"), thresholds=[10.0, None], xlim=(0, 100)),
        ["i.pdf"]),
    "make_channel_movie": (lambda d: plots.make_channel_movie(
        [plots.tint_below_mask(np.full((2, 8, 8), 50.0), np.eye(8, dtype=bool)[None].repeat(2, 0))],
        ["A"], 0.5, os.path.join(d, "ch.mp4"), dpi=30), ["ch.mp4"]),
    "make_coexpression_movie": (lambda d: plots.make_coexpression_movie(
        torch.rand(2, 8, 8) * 200, torch.rand(2, 8, 8) * 200, os.path.join(d, "co.mp4"),
        normalised=True, dpi=30), ["co.mp4"]),
    "plot_speed_histograms": (lambda d: plots.plot_speed_histograms(_flow(), d, label="Actin",
                                                                    dpi=30),
                              ["actin_global_speed_histogram.pdf", "speed_histograms.csv",
                               "actin_speed_histogram_frame_00.png",
                               "actin_speed_histogram_frame_01.png"]),
}


@pytest.mark.parametrize("name", sorted(WRITERS))
def test_each_writer_writes_its_file_from_a_port_flow_result(tmp_path, name):
    call, files = WRITERS[name]
    call(str(tmp_path))
    for f in files:
        assert _written(str(tmp_path / f))


def test_speed_histogram_table_matches_jax(tmp_path):
    flow = _flow(6)
    ours = plots.plot_speed_histograms(flow, str(tmp_path / "ours"), dpi=20)
    theirs = jplots.plot_speed_histograms(FlowResult(**flow.to_dict()), str(tmp_path / "theirs"),
                                          dpi=20)
    assert list(ours) == list(theirs)
    for key in ours:
        np.testing.assert_array_equal(ours[key], theirs[key])
    with open(tmp_path / "ours" / "speed_histograms.csv") as a, \
            open(tmp_path / "theirs" / "speed_histograms.csv") as b:
        assert a.read() == b.read()


def test_observability_additions_match_jax(tmp_path):
    for seconds in (125.25, 0.001, 3601.5):
        assert observability.format_elapsed_time(seconds) == jobs.format_elapsed_time(seconds)
    assert observability.format_elapsed_time(125.25) == (2, 5, 250)
    ours, theirs = observability.Timer("phase_b"), jobs.Timer("phase_b")
    ours.elapsed = theirs.elapsed = 125.25
    assert ours.report() == theirs.report() == "phase_b: 2 minutes, 5 seconds, 250 milliseconds"
    observability.reset_spans()
    observability.add_count("test/kept", 1)
    with observability.Timer("phase_b") as t:
        pass
    assert observability.span_statistics()["phase_b"]["count"] == 1 and t.elapsed >= 0.0
    observability.reset_spans()
    assert "phase_b" not in observability.span_statistics()
    assert observability.counts()["test/kept"] >= 1  # counters survive reset_spans

    log_dir = str(tmp_path / "trace")
    with observability.profile_trace(log_dir):
        torch.ones(8).sum()
    trace = os.path.join(log_dir, observability.TRACE_FILE)
    assert os.path.getsize(trace) > 0
    with open(trace) as f:
        assert '"traceEvents"' in f.read()


def test_config_hash_and_cache_are_shared_with_jax(tmp_path):
    movie = np.arange(24.0, dtype=np.float32).reshape(2, 3, 4)
    config = dict(method="box", boxsize=7, smoothing_sigma=None, delta_x=0.25)
    key = cache.config_hash(movie, **config)
    assert key == jcache.config_hash(movie, **config)
    assert cache.config_hash(torch.from_numpy(movie), **config) == key
    assert cache.config_hash(movie, **dict(config, boxsize=9)) != key

    # a cache written by the port is read by the JAX package, and back
    result = FlowResult(v_x=torch.ones(1, 3, 4), v_y=np.zeros((1, 3, 4)), delta_x=0.25,
                        delta_t=1.0)
    calls = []
    ours = cache.ResultCache(str(tmp_path))
    ours.get_or_compute(movie, lambda: calls.append(1) or result, **config)
    back = jcache.ResultCache(str(tmp_path)).get_or_compute(movie, lambda: calls.append(2),
                                                             **config)
    again = ours.get_or_compute(movie, lambda: calls.append(3), **config)
    assert calls == [1]
    for got in (back, again):
        np.testing.assert_array_equal(got["v_x"], np.ones((1, 3, 4)))
