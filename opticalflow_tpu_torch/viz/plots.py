"""Visualization / reporting (host-side matplotlib + ffmpeg).

Counterpart of ``opticalflow_tpu.viz.plots``: ``costum_imshow`` (the
reference's name, with a correctly spelled alias), arrow subsampling,
velocity overlay movies, the 6-panel joint overlay movie, convergence
plots, the regularisation sweep heatmaps and the comparison figures, on
the port's ``FlowResult``.  Every input that is a tensor is copied to the
host before plotting.  Without an ffmpeg writer a movie is saved as an
animated GIF beside the requested name, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

import matplotlib

if os.environ.get("DISPLAY", "") == "":
    matplotlib.use("Agg")
import matplotlib.colors
import matplotlib.pyplot as plt
import matplotlib.ticker
from matplotlib.animation import FuncAnimation

from opticalflow_tpu_torch.core.types import FlowResult
from opticalflow_tpu_torch.utils.device import to_host


def _on_host(result):
    """A flow result, or a dict of arrays such as a sweep's, with every
    tensor in it copied to the host."""
    host = {key: to_host(value) if isinstance(value, torch.Tensor) else value
            for key, value in result.items()}
    return FlowResult(**host) if isinstance(result, FlowResult) else host


def _save_animation(ani, filename, dpi):
    """Save an animation; if no ffmpeg writer is available, fall back to an
    animated GIF next to the requested name."""
    import matplotlib.animation as _anim

    try:
        ani.save(filename, dpi=dpi)
        return filename
    except (KeyError, ValueError, RuntimeError):
        if "ffmpeg" not in _anim.writers.list():
            fallback = os.path.splitext(filename)[0] + ".gif"
            ani.save(fallback, dpi=dpi, writer="pillow")
            return fallback
        raise


_FONT = {"size": 10, "sans-serif": "Arial"}
plt.rc("font", **_FONT)
plt.rc("axes", titlesize=10)
plt.rc("figure", titlesize=10)


def costum_imshow(image, delta_x, cmap="gray_r", autoscale=False, v_min=0.0,
                  v_max=255.0, unit=r"$\mathrm{\mu}$m"):
    """Show an image with physical-extent axes, inverted grayscale, no
    interpolation."""
    if autoscale:
        v_min = None
        v_max = None
    x_extent = image.shape[0] * delta_x
    y_extent = image.shape[1] * delta_x
    plt.imshow(image, cmap=cmap, extent=[0, y_extent, x_extent, 0],
               vmin=v_min, vmax=v_max, interpolation=None)
    plt.xlabel("y-position [" + unit + "]")
    plt.ylabel("x-position [" + unit + "]")


custom_imshow = costum_imshow  # correctly spelled alias


def subsample_velocities_for_visualisation(flow_result, iteration: Optional[int] = None,
                                           arrow_boxsize: int = 5):
    """Pick the velocity at the centre pixel of every ``arrow_boxsize`` box
    for quiver plotting.  Vectorized."""
    flow_result = _on_host(flow_result)
    v_x = flow_result["v_x_steps"] if iteration is not None else flow_result["v_x"]
    v_y = flow_result["v_y_steps"] if iteration is not None else flow_result["v_y"]
    if iteration is not None:
        v_x = v_x[:, iteration]
        v_y = v_y[:, iteration]
    n_pairs, xpix, ypix = v_x.shape
    x_extent = xpix * flow_result["delta_x"]
    y_extent = ypix * flow_result["delta_x"]
    nbx = xpix // arrow_boxsize
    nby = ypix // arrow_boxsize
    half = round(arrow_boxsize / 2)
    centres_x = np.arange(nbx) * arrow_boxsize + half
    centres_y = np.arange(nby) * arrow_boxsize + half
    sub_vx = np.asarray(v_x)[:, centres_x[:, None], centres_y[None, :]]
    sub_vy = np.asarray(v_y)[:, centres_x[:, None], centres_y[None, :]]
    x_positions = centres_x.astype(float) / xpix * x_extent
    y_positions = centres_y.astype(float) / ypix * y_extent
    return x_positions, y_positions, sub_vx, sub_vy


def make_velocity_overlay_movie(flow_result, filename, arrow_boxsize=5,
                                arrow_scale=1.0, cmap="gray_r", autoscale=False,
                                arrow_color="magenta", arrow_width=None,
                                v_min=0.0, v_max=255.0, dpi=600):
    """Image + quiver animation -> video file."""
    flow_result = _on_host(flow_result)
    movie = np.asarray(flow_result["original_data"])
    x_pos, y_pos, v_x, v_y = subsample_velocities_for_visualisation(
        flow_result, arrow_boxsize=arrow_boxsize
    )
    fig = plt.figure(figsize=(2.5, 2.5))

    def animate(i):
        plt.cla()
        costum_imshow(movie[i + 1], delta_x=flow_result["delta_x"], cmap=cmap,
                      autoscale=autoscale, v_min=v_min, v_max=v_max)
        # matplotlib's image coordinates flip the first axis for quiver
        plt.quiver(y_pos, x_pos, v_y[i], -v_x[i], color=arrow_color, headwidth=5,
                   scale=1.0 / arrow_scale, width=arrow_width)
        if i < 1:
            plt.tight_layout()

    ani = FuncAnimation(fig, animate, frames=movie.shape[0] - 1)
    _save_animation(ani, filename, dpi)
    plt.close(fig)


def make_joint_overlay_movie(flow_result, filename, arrow_boxsize=5, arrow_scale=1.0,
                             arrow_width=None, cmap="gray_r", autoscale=False,
                             arrow_color="magenta", v_min=0.0, v_max=255.0, dpi=600):
    """6-panel animation: original+quiver, blurred+quiver, speed,
    remodelling, v_x, v_y."""
    flow_result = _on_host(flow_result)
    original = np.asarray(flow_result["original_data"])
    blurred = np.asarray(flow_result["blurred_data"])
    x_pos, y_pos, v_x, v_y = subsample_velocities_for_visualisation(
        flow_result, arrow_boxsize=arrow_boxsize
    )
    delta_x = flow_result["delta_x"]
    fmt = matplotlib.ticker.StrMethodFormatter("{x:.2f}")
    fig = plt.figure(figsize=(6.5, 4.5), constrained_layout=True)

    panels = [
        ("speed", "viridis", r"Motion speed [$\mathrm{\mu m}$/s]"),
        ("remodelling", "plasma", "Net remodelling"),
        ("v_x", "plasma", r"x velocity [$\mathrm{\mu m}$/s]"),
        ("v_y", "plasma", r"y velocity [$\mathrm{\mu m}$/s]"),
    ]

    def animate(i):
        plt.clf()
        plt.subplot(231)
        costum_imshow(original[i], delta_x=delta_x, cmap=cmap, autoscale=autoscale,
                      v_min=v_min, v_max=v_max)
        plt.quiver(y_pos, x_pos, v_y[i], -v_x[i], color=arrow_color, headwidth=5,
                   scale=1.0 / arrow_scale, width=arrow_width)
        plt.title("Original data")
        plt.subplot(232)
        costum_imshow(blurred[i], delta_x=delta_x, cmap=cmap, autoscale=autoscale,
                      v_min=v_min, v_max=v_max)
        plt.quiver(y_pos, x_pos, v_y[i], -v_x[i], color=arrow_color, headwidth=5,
                   scale=1.0 / arrow_scale, width=arrow_width)
        plt.title("Blurred")
        for panel_index, (key, pcmap, title) in enumerate(panels):
            plt.subplot(233 + panel_index)
            field = np.asarray(flow_result[key])
            costum_imshow(field[i], delta_x=delta_x, autoscale=True, cmap=pcmap)
            plt.ylabel("")
            colorbar = plt.colorbar(shrink=0.6)
            plt.clim(field.min(), field.max())
            colorbar.formatter = fmt
            plt.title(title)

    ani = FuncAnimation(fig, animate, frames=original.shape[0] - 1)
    _save_animation(ani, filename, dpi)
    plt.close(fig)


def make_convergence_plots(result, filename_start, dpi=300):
    """Relative step-size vs iteration plots + compound animation; needs a
    result produced with ``return_iterations`` (the Liu-Shen path)."""
    result = _on_host(result)
    iterations = result["max_iterations"]
    step = result["iteration_stepsize"]
    delta_x = result["delta_x"]
    original = np.asarray(result["original_data"])
    stepsizes = np.arange(0, iterations + 0.5, step, dtype=int)

    def relative_steps(key):
        steps = np.asarray(result[key])[0]
        num = np.linalg.norm(steps[1:] - steps[:-1], axis=(1, 2))
        den = np.linalg.norm(steps[1:], axis=(1, 2))
        return num / np.where(den == 0, 1.0, den)

    speed_error = relative_steps("speed_steps")
    remodelling_error = relative_steps("remodelling_steps")

    for name, err in [("speed", speed_error), ("remodelling", remodelling_error)]:
        plt.figure(figsize=(2.5, 2.5), constrained_layout=True)
        plt.plot(stepsizes[1:], err)
        plt.title(f"{name.capitalize()} stepsize per {step}\niterations")
        plt.yscale("log")
        plt.xlabel("iterations")
        plt.ylabel("relative step size")
        plt.savefig(filename_start + f"{name}_convergence.pdf")
        plt.close()

    fig = plt.figure(figsize=(6.5, 4.5), constrained_layout=True)

    def animate(i):
        plt.clf()
        plt.suptitle("Iteration " + str(stepsizes[i]))
        x_pos, y_pos, v_x, v_y = subsample_velocities_for_visualisation(
            result, iteration=i, arrow_boxsize=4
        )
        plt.subplot(231)
        costum_imshow(original[0], delta_x=delta_x, v_min=original[0].min(),
                      v_max=original[0].max())
        plt.quiver(y_pos, x_pos, v_y[0], -v_x[0], color="magenta", headwidth=5, scale=None)
        plt.xlabel("")
        for panel_index, (key, pcmap, title) in enumerate([
            ("speed_steps", "viridis", r"Motion speed [$\mathrm{\mu m}$/s]"),
            ("remodelling_steps", "plasma", "Net remodelling"),
            ("v_x_steps", "viridis", r"x velocity [$\mathrm{\mu m}$/s]"),
            ("v_y_steps", "viridis", r"y velocity [$\mathrm{\mu m}$/s]"),
        ]):
            plt.subplot(232 + panel_index)
            steps = np.asarray(result[key])
            costum_imshow(steps[0, i], delta_x=delta_x, autoscale=True, cmap=pcmap)
            plt.colorbar(shrink=0.6)
            plt.clim(steps.min(), steps.max())
            plt.title(title)
        plt.subplot(236)
        plt.plot(stepsizes[1:], speed_error)
        idx = min(i, len(speed_error) - 1)
        plt.scatter(stepsizes[idx + 1], speed_error[idx])
        plt.title(f"Speed stepsize per {step}\niterations")
        plt.yscale("log")
        plt.xlabel("iterations")
        plt.ylabel("relative step size")

    ani = FuncAnimation(fig, animate, frames=np.asarray(result["speed_steps"]).shape[1])
    _save_animation(ani, filename_start + "compound_figures.mp4", dpi)
    plt.close(fig)


def plot_regularisation_variation(variation_result, filename, use_log_axes=False,
                                  use_log_colorbar=False):
    """4-panel sweep heatmaps: mean speed, speed COV, mean remodelling,
    remodelling COV; non-converged cells masked to NaN."""
    variation_result = _on_host(variation_result)
    speed_alphas = np.asarray(variation_result["speed_alpha_values"])
    rem_alphas = np.asarray(variation_result["remodelling_alpha_values"])
    rem_grid, speed_grid = np.meshgrid(rem_alphas, speed_alphas)
    if use_log_axes:
        extent_s = float(np.ptp(np.log(speed_alphas)))
        extent_r = float(np.ptp(np.log(rem_alphas)))
    else:
        extent_s = float(np.ptp(speed_alphas))
        extent_r = float(np.ptp(rem_alphas))
    aspect = extent_s / extent_r if extent_r else 1.0
    not_converged = np.logical_not(np.asarray(variation_result["converged"]))
    norm = matplotlib.colors.LogNorm() if use_log_colorbar else None

    def masked(key):
        data = np.array(variation_result[key], dtype=float, copy=True)
        data[not_converged] = np.nan
        return data

    speed_means = masked("speed_means")
    speed_cov = np.sqrt(masked("speed_variances")) / np.abs(speed_means)
    rem_means = masked("remodelling_means")
    rem_cov = np.sqrt(masked("remodelling_variances")) / np.abs(rem_means)

    plt.figure(figsize=(6.5, 4.5), constrained_layout=True)
    for k, (data, title) in enumerate([
        (speed_means, "Mean speed"),
        (speed_cov, "Speed COV"),
        (rem_means, "Mean remodelling"),
        (rem_cov, "Remodelling COV"),
    ]):
        plt.subplot(221 + k)
        plt.pcolormesh(speed_grid, rem_grid, data, cmap="viridis", norm=norm)
        plt.gca().set_aspect(aspect)
        if use_log_axes:
            plt.xscale("log")
            plt.yscale("log")
        plt.colorbar()
        plt.xlabel(r"$\alpha_{\mathrm{speed}}$")
        plt.ylabel(r"$\alpha_{\mathrm{remodelling}}$")
        plt.title(title)
    plt.savefig(filename)
    plt.close()


def plot_angle_histogram(flow_result, filename, weighted=False, dpi=300):
    """Histogram of velocity angles to the y axis (in units of pi),
    optionally speed-weighted."""
    from opticalflow_tpu_torch.analysis.statistics import velocity_angles

    flow_result = _on_host(flow_result)
    angles = velocity_angles(flow_result)
    finite = np.isfinite(angles)
    plt.figure(figsize=(2.5, 2.5), constrained_layout=True)
    if weighted:
        speed = np.asarray(flow_result["speed"])[finite]
        plt.hist(angles[finite].ravel() / np.pi, bins=50, weights=speed.ravel(),
                 density=True)
        plt.xlabel("Weighted angle to y axis")
        plt.ylabel("Density")
    else:
        plt.hist(angles[finite].ravel() / np.pi, bins=50, range=(-1, 1))
        plt.xlabel("Angle to y axis")
        plt.ylabel("Number of boxes")
    plt.gca().xaxis.set_major_formatter(
        matplotlib.ticker.FormatStrFormatter(r"%g$\mathrm{\pi}$"))
    plt.gca().xaxis.set_major_locator(matplotlib.ticker.MultipleLocator(base=0.5))
    plt.savefig(filename, dpi=dpi)
    plt.close()


def plot_polar_angle_histogram(flow_a, flow_b, filename, bins=20, dpi=300,
                               title="Angle between channels"):
    """Polar histogram of the angle between two channels' velocity vectors,
    0deg at the top, clockwise."""
    from opticalflow_tpu_torch.analysis.statistics import angles_between

    flow_a = _on_host(flow_a)
    flow_b = _on_host(flow_b)
    theta, _ = angles_between(flow_a, flow_b)
    theta = theta[np.isfinite(theta)]
    plt.figure(figsize=(2.5, 2.5), constrained_layout=True)
    ax = plt.subplot(projection="polar")
    ax.set_theta_direction(-1)
    ax.set_theta_offset(np.pi / 2.0)
    ax.set_thetalim((0.0, np.pi))
    ax.set_xticks(np.linspace(0, np.pi, 5))
    ax.set_xticklabels(["0\N{DEGREE SIGN}", "45\N{DEGREE SIGN}",
                        "90\N{DEGREE SIGN}", "135\N{DEGREE SIGN}",
                        "180\N{DEGREE SIGN}"])
    ax.hist(theta.ravel(), bins=bins)
    ax.text(-0.05, 0.5, "Number of boxes", rotation="vertical",
            va="center", ha="center", transform=ax.transAxes)
    plt.title(title)
    plt.savefig(filename, dpi=dpi)
    plt.close()


def plot_speed_correlation(flow_a, flow_b, filename, threshold=0.01, dpi=300,
                           label_a="Channel A speed", label_b="Channel B speed"):
    """2-D histogram of paired speeds where channel b exceeds ``threshold``."""
    from opticalflow_tpu_torch.analysis.statistics import speed_pairs

    flow_a = _on_host(flow_a)
    flow_b = _on_host(flow_b)
    a, b = speed_pairs(flow_a, flow_b, threshold=threshold)
    plt.figure(figsize=(3.5, 2.5), constrained_layout=True)
    plt.hist2d(a, b, bins=(50, 50))
    plt.xlabel(label_a)
    plt.ylabel(label_b)
    colorbar = plt.colorbar()
    colorbar.ax.set_ylabel("number of boxes")
    plt.savefig(filename, dpi=dpi)
    plt.close()


def make_two_channel_overlay_movie(flow_a, flow_b, filename, label_a="Channel A",
                                   label_b="Channel B", arrow_boxsize=15,
                                   arrow_scale=1.0, show_blurred=False,
                                   shared_movie=None, dpi=300):
    """Side-by-side overlay of two flow results' images + quivers (the
    joint overlay of two channels, and the PIV-vs-flow movie).

    ``shared_movie`` shows the same raw movie under both quiver sets (the
    PIV comparison case); otherwise each result's own data is shown.
    """
    flow_a = _on_host(flow_a)
    flow_b = _on_host(flow_b)
    key = "blurred_data" if show_blurred else "original_data"
    movie_a = to_host(shared_movie if shared_movie is not None else flow_a[key])
    movie_b = to_host(shared_movie if shared_movie is not None else flow_b[key])
    xa, ya, vxa, vya = subsample_velocities_for_visualisation(
        flow_a, arrow_boxsize=arrow_boxsize)
    xb, yb, vxb, vyb = subsample_velocities_for_visualisation(
        flow_b, arrow_boxsize=arrow_boxsize)
    n_frames = min(vxa.shape[0], vxb.shape[0], movie_a.shape[0] - 1)
    fig = plt.figure(figsize=(4.5, 2.5), constrained_layout=True)

    def animate(i):
        plt.clf()
        plt.subplot(121)
        plt.title(label_a)
        costum_imshow(movie_a[i], delta_x=flow_a["delta_x"])
        plt.quiver(ya, xa, vya[i], -vxa[i], color="magenta", headwidth=5,
                   scale=1.0 / arrow_scale if arrow_scale != 1.0 else None)
        plt.subplot(122)
        plt.title(label_b)
        costum_imshow(movie_b[i], delta_x=flow_b["delta_x"])
        plt.quiver(yb, xb, vyb[i], -vxb[i], color="magenta", headwidth=5,
                   scale=1.0 / arrow_scale if arrow_scale != 1.0 else None)

    ani = FuncAnimation(fig, animate, frames=n_frames)
    _save_animation(ani, filename, dpi)
    plt.close(fig)


def plot_joint_speed_and_angle_histograms(flow_a, flow_b, filename,
                                          label_a="Channel A", label_b="Channel B",
                                          speed_range=(0, 0.1), dpi=300):
    """4-panel figure: per-channel speed histograms (top) and angle-to-y
    histograms (bottom)."""
    from opticalflow_tpu_torch.analysis.statistics import velocity_angles

    flow_a = _on_host(flow_a)
    flow_b = _on_host(flow_b)
    plt.figure(figsize=(4.5, 4.5), constrained_layout=True)
    for k, (label, flow) in enumerate(((label_a, flow_a), (label_b, flow_b))):
        plt.subplot(2, 2, k + 1)
        plt.title(label)
        speed = np.asarray(flow["speed"])
        plt.hist(speed[np.isfinite(speed)].ravel(), bins=50, range=speed_range)
        plt.ylabel("Number of pixels")
        plt.xlabel(r"Speed [$\mathrm{\mu m}$/s]")
        plt.gca().ticklabel_format(scilimits=(-3, 3))

        plt.subplot(2, 2, k + 3)
        angles = velocity_angles(flow)
        angles = angles[np.isfinite(angles)]
        plt.hist(angles.ravel() / np.pi, bins=50, range=(-1, 1))
        plt.gca().ticklabel_format(scilimits=(-3, 3))
        plt.gca().xaxis.set_major_formatter(
            matplotlib.ticker.FormatStrFormatter(r"%g$\mathrm{\pi}$"))
        plt.gca().xaxis.set_major_locator(
            matplotlib.ticker.MultipleLocator(base=0.5))
        plt.xlabel("Angle to y axis")
        plt.ylabel("Number of pixels")
    plt.savefig(filename, dpi=dpi)
    plt.close()


def plot_angle_between_histogram(flow_a, flow_b, filename, weighted=False,
                                 bins=50, dpi=300):
    """Histogram of the per-pixel angle between two channels' velocity
    vectors, optionally weighted by the speed product."""
    from opticalflow_tpu_torch.analysis.statistics import angles_between

    flow_a = _on_host(flow_a)
    flow_b = _on_host(flow_b)
    theta, weights = angles_between(flow_a, flow_b)
    finite = np.isfinite(theta)
    plt.figure(figsize=(2.5, 2.5), constrained_layout=True)
    if weighted:
        plt.title("Weighted angles")
        plt.hist(theta[finite].ravel() / np.pi, bins=bins,
                 weights=weights[finite].ravel(), density=True)
        plt.ylabel("Density")
    else:
        plt.hist(theta[finite].ravel() / np.pi, bins=bins)
        plt.ylabel("Number of pixels")
    plt.xlabel(r"|$\mathrm{\theta}$|")
    plt.gca().xaxis.set_major_formatter(
        matplotlib.ticker.FormatStrFormatter(r"%g$\mathrm{\pi}$"))
    plt.gca().xaxis.set_major_locator(matplotlib.ticker.MultipleLocator(base=0.25))
    plt.savefig(filename, dpi=dpi)
    plt.close()


def plot_ground_truth_validation(flow_result, measurements, filename, frame=8,
                                 arrow_scale=0.05, dpi=600):
    """Validation quiver: hand-clicked displacements (blue) vs inferred
    flow at the click positions (magenta) over the raw frame."""
    flow_result = _on_host(flow_result)
    movie = np.asarray(flow_result["original_data"])
    xs = np.asarray(measurements["x_start"], dtype=int)
    ys = np.asarray(measurements["y_start"], dtype=int)
    xe = np.asarray(measurements["x_end"])
    ye = np.asarray(measurements["y_end"])
    pair_index = min(frame, np.asarray(flow_result["v_x"]).shape[0] - 1)
    v_x = np.asarray(flow_result["v_x"])[pair_index, xs, ys]
    v_y = np.asarray(flow_result["v_y"])[pair_index, xs, ys]

    plt.figure(figsize=(2.5, 2.5), constrained_layout=True)
    costum_imshow(movie[min(frame, movie.shape[0] - 1)],
                  delta_x=flow_result["delta_x"])
    plt.quiver(ys, xs, ye - ys, xs - xe, color="blue", headwidth=5,
               scale=1.0 / arrow_scale)
    plt.quiver(ys, xs, v_y, -v_x, color="magenta", headwidth=5,
               scale=1.0 / arrow_scale)
    plt.savefig(filename, dpi=dpi)
    plt.close()


def plot_parameter_sweep_summary(sweep, filename_start, parameter_key, dpi=300):
    """Summary figures of a box-size / blur-size sweep: mean speed and
    speed std vs the parameter, plus the per-location local speeds (the
    sweep itself runs batched, see analysis.hyperparams)."""
    sweep = _on_host(sweep)
    values = np.asarray(sweep[parameter_key])
    label = parameter_key.rstrip("s")

    plt.figure(figsize=(4.5, 2.5))
    plt.subplot(121)
    plt.plot(values, sweep["mean_speeds"])
    plt.xlabel(label)
    plt.ylabel(r"mean speed [$\mathrm{\mu m}$/s]")
    plt.subplot(122)
    plt.plot(values, sweep["speed_stds"])
    plt.xlabel(label)
    plt.ylabel(r"speed standard dev. [$\mathrm{\mu m}$/s]")
    plt.tight_layout()
    plt.savefig(filename_start + "_velocities.pdf", dpi=dpi)
    plt.close()

    plt.figure(figsize=(2.5, 2.5), constrained_layout=True)
    for location, trace in zip(np.asarray(sweep["test_locations"]),
                               np.asarray(sweep["local_speeds"])):
        plt.plot(values, trace, label=f"({location[0]:g}, {location[1]:g})")
    plt.xlabel(label)
    plt.ylabel(r"Local speed [$\mathrm{\mu m}$/s]")
    plt.legend(fontsize=6)
    plt.savefig(filename_start + "_local_velocities.pdf", dpi=dpi)
    plt.close()


def plot_intensity_histograms(movies, labels, filename, thresholds=None,
                              value_range=(0.0, 255.0), bins=255, xlim=None):
    """Side-by-side per-channel intensity histograms, optionally with the
    mode-separating threshold marked."""
    n = len(movies)
    plt.figure(figsize=(2.25 * n, 2.5), constrained_layout=True)
    for k, (movie, label) in enumerate(zip(movies, labels)):
        plt.subplot(1, n, k + 1)
        plt.hist(to_host(movie).ravel(), bins=bins, range=value_range)
        if thresholds is not None and thresholds[k] is not None:
            plt.axvline(thresholds[k], color="black",
                        label=f"Intensity = {thresholds[k]:g}")
            plt.legend()
        plt.xlabel(f"{label} intensity value")
        plt.ylabel("Number of pixels")
        if xlim is not None:
            plt.xlim(*xlim)
        plt.gca().ticklabel_format(scilimits=(-3, 3))
    plt.savefig(filename)
    plt.close()


def tint_below_mask(movie, mask):
    """(frames, X, Y) + boolean mask -> RGB movie on the reference's
    inverted-grayscale convention: unmasked pixels render green, masked
    pixels grayscale."""
    movie = to_host(movie)
    mask = to_host(mask)
    rgb = np.zeros(movie.shape + (3,), dtype=int)
    inv = 255 - movie
    keep = ~mask
    rgb[..., 1][keep] = inv[keep]
    for c in range(3):
        rgb[..., c][mask] = inv[mask]
    return rgb


def make_channel_movie(rgb_movies, labels, delta_x, filename, dpi=300):
    """N-panel animation of RGB channel movies (thresholded overlays)."""
    rgb_movies = [to_host(m) for m in rgb_movies]
    n = len(rgb_movies)
    fig = plt.figure(figsize=(2.25 * n, 2.5), constrained_layout=True)

    def animate(i):
        for k, (mov, label) in enumerate(zip(rgb_movies, labels)):
            plt.subplot(1, n, k + 1)
            plt.title(label)
            costum_imshow(mov[i], autoscale=False, cmap=None, delta_x=delta_x)

    ani = FuncAnimation(fig, animate, frames=rgb_movies[0].shape[0])
    _save_animation(ani, filename, dpi)
    plt.close(fig)


def make_coexpression_movie(movie_a, movie_b, filename, normalised=False,
                            dpi=300):
    """Joint two-channel RGB movie: channel A in red, channel B in green
    (the reference's ``normalised`` branch scales both channels by channel
    A's maximum, reproduced)."""
    movie_a = to_host(movie_a).astype(float)
    movie_b = to_host(movie_b).astype(float)
    if normalised:
        scale = np.max(movie_a)
        movie_a = movie_a / scale * 255.0
        movie_b = movie_b / scale * 255.0
    joint = np.zeros(movie_a.shape + (3,), dtype=int)
    joint[..., 0] = np.round(movie_a)
    joint[..., 1] = np.round(movie_b)
    joint = np.clip(joint, 0, 255)

    fig = plt.figure(figsize=(2.5, 2.5))

    def animate(i):
        plt.cla()
        plt.imshow(joint[i], interpolation=None)
        plt.gca().set_axis_off()
        if i < 1:
            plt.tight_layout()

    ani = FuncAnimation(fig, animate, frames=joint.shape[0])
    _save_animation(ani, filename, dpi)
    plt.close(fig)


def plot_speed_histograms(flow_result, output_dir, label="Actin", bins=50,
                          dpi=300):
    """Global + per-frame speed histograms of a flow result, with the
    binned table exported for downstream use (the reference writes xlsx
    through pandas and openpyxl; as in the JAX package the same table goes
    to CSV)."""
    flow_result = _on_host(flow_result)
    speed = np.asarray(flow_result["speed"])
    finite = speed[np.isfinite(speed)]
    os.makedirs(output_dir, exist_ok=True)
    slug = label.lower()

    plt.figure()
    plt.hist(finite.ravel(), bins=100, density=False)
    plt.xlabel(f"{label} Speed [$\\mathrm{{\\mu m}}$/s]")
    plt.ylabel("Number of Pixels")
    plt.tight_layout()
    plt.savefig(os.path.join(output_dir, f"{slug}_global_speed_histogram.pdf"))
    plt.close()

    hist0, bin_edges = np.histogram(
        np.nan_to_num(speed[0]).ravel(), bins=bins
    )
    centers = 0.5 * (bin_edges[:-1] + bin_edges[1:])
    columns = {"bin_center": centers, "frame_00": hist0}
    for k in range(speed.shape[0]):
        frame = np.nan_to_num(speed[k]).ravel()
        hist, _ = np.histogram(frame, bins=bin_edges)
        columns[f"frame_{k:02d}"] = hist
        plt.figure()
        plt.hist(frame, bins=bins, density=False)
        plt.xlabel(f"{label} Speed [$\\mathrm{{\\mu m}}$/s]")
        plt.ylabel("Number of Pixels")
        plt.title(f"{label} speed frame {k}")
        plt.tight_layout()
        plt.savefig(os.path.join(
            output_dir, f"{slug}_speed_histogram_frame_{k:02d}.png"), dpi=dpi)
        plt.close()

    table = np.column_stack(list(columns.values()))
    np.savetxt(
        os.path.join(output_dir, "speed_histograms.csv"), table,
        delimiter=",", header=",".join(columns), comments="",
    )
    return columns
