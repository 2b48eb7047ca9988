#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the device: ``torch.cuda.get_device_name`` and nvidia-smi's name and
   power limit (fails without a CUDA device);
2. build every kernel from ``opticalflow_tpu_torch/csrc`` (one nvcc per
   source, all started together);
3. each kernel against its plain PyTorch version on the card, with the
   time per call of each (CUDA events), at the shapes of both paths (the
   solves' K = 1 and the multigrid probes' K = 27, at 254x254 and
   1022x1022 interiors, and a ragged one): the fused matvec (B1) and the
   plain-stencil core (B2); and the hybrid matvec (B2 plus the boundary
   ring) against B1's plain version;
4. the 256x256 path once warm and once timed: ``variational_optical_flow``
   on the bench movie (13 frames of 256x256, 12 pairs, two-pass warm
   start, alpha_s = alpha_r = 1000), with every kernel's counters set to 0
   just before the timed run and read just after, and the flow of pairs 1
   and 11 held against the float64 assembled direct solve;
5. the 1024x1024 path (the large-grid branch: FGMRES(32), 4-sweep
   multigrid, refinement with FGMRES correction solves): one pair of the
   1024x1024 embryo-scale movie, first solved once in float64 as the
   oracle (FGMRES to rtol 1e-10, plain matvec), then in float32 with the
   defaults, once with ``matvec='hybrid'`` (B2) and once with the default
   fused matvec (B1), the counters set to 0 just before each and read just
   after, each held to EPE < 1e-3 px against the oracle; then the phase
   split (``profile_solve_phases``) of the hybrid solve.

The second-to-last line is a JSON object with one entry per kernel: its
launches in each path's run (``launches_by_path``) and their sum
(``launches``), its largest error and its time per call at 11 pairs of
254x254.  The last line is ``{"ok": true, "device": {...}}``.  Imports no
JAX.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REL_TOL = 1e-5  # per field: max|kernel - plain| <= REL_TOL * max|plain| (both f32)
EPE_LIMIT_PX = 1e-3  # flow endpoint error vs the f64 direct solve / f64 FGMRES oracle
N_FRAMES, DIM, ALPHA = 13, 256, 1000.0
ORACLE_PAIRS = (1, 11)
LARGE_DIM = 1024  # one pair; blob width 20 * 1024 / 256 as the bench scales it


def bench_movie():
    """The bench movie: blob width 20, sigma 3, v = (0.15, 0.1) per frame,
    x100 and rounded through float32 (integer-like microscopy data is
    exact in f32, so the f64 oracle sees the same frames)."""
    from opticalflow_tpu_torch.core.synth import make_translating_blob_movie

    movie, _ = make_translating_blob_movie(n_frames=N_FRAMES, dimension=DIM, width=20.0,
                                           sigma=3.0, v_x=0.15, v_y=0.1)
    return (movie * 100.0).astype(np.float32)


def embryo_pair():
    """The bench's 1024x1024 pair: blob width 80, sigma 3, v = (0.15, 0.1),
    x100 and rounded through float32."""
    from opticalflow_tpu_torch.core.synth import make_translating_blob_movie

    movie, _ = make_translating_blob_movie(n_frames=2, dimension=LARGE_DIM,
                                           width=20.0 * LARGE_DIM / 256, sigma=3.0, v_x=0.15,
                                           v_y=0.1)
    return (movie * 100.0).astype(np.float32)


def cuda_ms(fn, reps, rounds=5):
    """Milliseconds per call of ``fn()``: CUDA events around ``reps``
    back-to-back calls, the median of ``rounds`` such runs after warm-up.
    A call shorter than its host-side launch measures the launch."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _rel_errors(y, y_ref):
    """max|y - y_ref| / max|y_ref| per field, and the largest max|y - y_ref|."""
    rel, max_abs = [], 0.0
    for q in range(3):
        err = (y[..., q, :, :] - y_ref[..., q, :, :]).abs().max().item()
        rel.append(err / y_ref[..., q, :, :].abs().max().item())
        max_abs = max(max_abs, err)
    return rel, max_abs


def _normalised(movie, dev):
    frames = torch.from_numpy(movie).to(dev)
    scale = frames.flatten(1).amax(1)
    I = (frames / scale[:, None, None]).contiguous()  # normalised as the solve does
    return I, torch.stack([ALPHA / scale**2, torch.full_like(scale, ALPHA)], dim=-1)


# wrapper (its plain version is the wrapper's name + "_ref"): counter label,
# source, TPU kernel it replaces
KERNELS = {
    "el_matvec_reduced_fused": ("B1", "opticalflow_tpu_torch/csrc/el_matvec.cu",
                                "opticalflow_tpu/ops/pallas_kernels.py:398"),
    "el_matvec_plain_core": ("B2", "opticalflow_tpu_torch/csrc/el_matvec_plain.cu",
                             "opticalflow_tpu/ops/pallas_kernels.py:685"),
}


def check_kernels(movie, large, dev, card):
    """Each kernel vs its plain version, and the hybrid matvec vs the fused
    kernel's plain version, at the shapes of both paths; returns the JSON
    entry of each kernel (without the launch counts), timed at the first
    case."""
    from opticalflow_tpu_torch.core import stencils
    from opticalflow_tpu_torch.ops import cuda_kernels as ck
    from opticalflow_tpu_torch.ops import elop

    frames = {"bench": _normalised(movie, dev), "large": _normalised(large[:1], dev)}
    gen = torch.Generator(dev).manual_seed(1)
    cases = [  # (name, frames, B, K, m, n, compat, hybrid too)
        ("11 pairs 254x254 compat", "bench", 11, 1, 254, 254, True, True),
        ("11 pairs 254x254 fixed", "bench", 11, 1, 254, 254, False, False),
        ("11 pairs x 27 probes 254x254", "bench", 11, 27, 254, 254, True, False),
        ("1 pair 1022x1022", "large", 1, 1, 1022, 1022, True, True),
        ("1 pair x 27 probes 1022x1022", "large", 1, 27, 1022, 1022, True, False),
        ("2 pairs 61x190 ragged", "bench", 2, 1, 61, 190, True, False),
    ]
    entries = {name: {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                      "max_abs_err": 0.0}
               for name, (_, source, replaces) in KERNELS.items()}
    for name, which, B, K, m, n, compat, hybrid in cases:
        I_all, scalars_all = frames[which]
        I = I_all[:B, : m + 2, : n + 2].contiguous()
        scalars = scalars_all[:B].contiguous()
        shape = (B, 3, m, n) if K == 1 else (B, K, 3, m, n)
        u = torch.randn(shape, device=dev, generator=gen)
        reps = 50 if B * K * m * n < 3e7 else 10
        gbytes = 4 * (B * (m + 2) * (n + 2) + 6 * B * K * m * n) / 1e9
        ms = {}
        for kernel in KERNELS:
            kernel_fn, plain_fn = getattr(ck, kernel), getattr(ck, kernel + "_ref")
            y = kernel_fn(I, scalars, u, compat)
            y_ref = plain_fn(I, scalars, u, compat)
            torch.cuda.synchronize()
            rel, err = _rel_errors(y, y_ref)
            del y, y_ref
            k_ms = cuda_ms(lambda: kernel_fn(I, scalars, u, compat), reps)
            p_ms = cuda_ms(lambda: plain_fn(I, scalars, u, compat), 10)
            ms[kernel] = k_ms, p_ms
            print(f"{kernel} {name}: max rel err per field "
                  f"{', '.join(f'{r:.2e}' for r in rel)} (tol {REL_TOL:g}); kernel {k_ms:.4f} ms "
                  f"({gbytes / k_ms * 1e3:.0f} GB/s), plain {p_ms:.4f} ms  [{card}]", flush=True)
            if max(rel) > REL_TOL:
                raise AssertionError(f"{kernel} disagrees with its plain version: {name}")
            entry = entries[kernel]
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            if "ms" not in entry:
                entry["ms"], entry["plain_ms"] = k_ms, p_ms
        if hybrid:
            dy_mode = stencils.DY_COMPAT if compat else stencils.DY_FIXED
            ring = elop.ring_coeffs(elop.compute_coefficients(I, scalars[:, 0], scalars[:, 1],
                                                              dy_mode))
            y_h = ck.el_matvec_hybrid(I, scalars, u, compat, ring)
            y_ref = ck.el_matvec_reduced_fused_ref(I, scalars, u, compat)
            torch.cuda.synchronize()
            rel, _ = _rel_errors(y_h, y_ref)
            h_ms = cuda_ms(lambda: ck.el_matvec_hybrid(I, scalars, u, compat, ring), reps)
            print(f"el_matvec_hybrid {name}: max rel err per field vs the fused plain version "
                  f"{', '.join(f'{r:.2e}' for r in rel)} (tol {REL_TOL:g}); ms per call: "
                  f"B2 core {ms['el_matvec_plain_core'][0]:.4f}, hybrid {h_ms:.4f}, B1 fused "
                  f"{ms['el_matvec_reduced_fused'][0]:.4f}, plain "
                  f"{ms['el_matvec_reduced_fused'][1]:.4f}  [{card}]", flush=True)
            if max(rel) > REL_TOL:
                raise AssertionError(f"hybrid matvec disagrees with the plain version: {name}")
    return entries


def reset_counters():
    from opticalflow_tpu_torch.ops import cuda_kernels as ck
    from opticalflow_tpu_torch.utils import observability

    ck.LAUNCHES = ck.PLAIN_CALLS = ck.CORE_LAUNCHES = ck.CORE_PLAIN_CALLS = 0
    observability.reset()
    torch.cuda.synchronize()


def read_counters():
    from opticalflow_tpu_torch.ops import cuda_kernels as ck
    from opticalflow_tpu_torch.utils import observability

    return {"B1": ck.LAUNCHES, "B1 plain": ck.PLAIN_CALLS, "B2": ck.CORE_LAUNCHES,
            "B2 plain": ck.CORE_PLAIN_CALLS,
            "host syncs": observability.counts().get("krylov/host_syncs", 0)}


def large_grid_path(large, dev, card):
    """The 1024x1024 pair: f64 oracle, then the float32 solve with the
    hybrid matvec (B2) and with the fused one (B1); returns the counts of
    each of the two runs."""
    from opticalflow_tpu_torch import SolverConfig, variational_optical_flow
    from opticalflow_tpu_torch.flow.variational import profile_solve_phases

    movie_t = torch.from_numpy(large).to(dev)
    kw = dict(speed_alpha=ALPHA, remodelling_alpha=ALPHA)
    t0 = time.perf_counter()
    oracle = variational_optical_flow(
        movie_t, dtype=torch.float64, solver=SolverConfig(
            method="gmres", rtol=1e-10, refinement_restarts=0, matvec="xla"), **kw)
    print(f"1024 oracle (float64 FGMRES, rtol 1e-10, plain matvec): "
          f"{time.perf_counter() - t0:.3f} s, iterations {oracle['iterations'].tolist()}, converged "
          f"{oracle['converged_all'].tolist()}  [{card}]", flush=True)
    if not oracle["converged_all"].all():
        raise AssertionError("the float64 oracle did not converge")

    runs = {}
    for matvec, kernel in (("hybrid", "B2"), ("auto", "B1")):
        reset_counters()
        t0 = time.perf_counter()
        result = variational_optical_flow(movie_t, solver=SolverConfig(matvec=matvec), **kw)
        wall = time.perf_counter() - t0  # returns host arrays: synchronised
        counts = read_counters()
        d = np.sqrt((result["v_x"] - oracle["v_x"]) ** 2 + (result["v_y"] - oracle["v_y"]) ** 2)
        e = float(d[0, 1:-1, 1:-1].max())
        print(f"1024 float32 matvec={matvec!r}: {wall:.3f} s, iterations "
              f"{result['iterations'].tolist()}, converged {result['converged_all'].tolist()}, "
              f"counts {counts}, EPE {e:.3e} px vs the float64 oracle (limit "
              f"{EPE_LIMIT_PX:g})  [{card}]", flush=True)
        if not result["converged_all"].all():
            raise AssertionError(f"1024 matvec={matvec!r} did not converge")
        if counts[kernel] == 0 or counts["B1 plain"] or counts["B2 plain"]:
            raise AssertionError(f"1024 matvec={matvec!r} bypassed its kernel: {counts}")
        if result["v_x"].shape != (1, LARGE_DIM, LARGE_DIM) or not np.isfinite(result["v_x"]).all():
            raise AssertionError("1024: bad shape or non-finite values")
        if not e < EPE_LIMIT_PX:
            raise AssertionError(f"1024 matvec={matvec!r}: EPE {e} px")
        runs[f"{LARGE_DIM}x{LARGE_DIM} {matvec}"] = counts

    phases = profile_solve_phases(movie_t[0], movie_t[1], ALPHA, ALPHA,
                                  solver=SolverConfig(matvec="hybrid"), reps=1)
    print("1024 hybrid phases (s): " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
          + f"  [{card}]", flush=True)
    return runs


def oracle_epe(movie, result, k):
    """EPE (px) of pair k against the float64 assembled direct solve, its
    planes built in float64 on the CPU."""
    from opticalflow_tpu_torch.ops import elop
    from opticalflow_tpu_torch.solve import direct

    frames = torch.from_numpy(movie[k : k + 2].astype(np.float64))
    pair = elop.compute_frame_pair_data(frames[:1], frames[1:], ALPHA, ALPHA, "compat")
    u_ref, _ = direct.direct_solve(elop.ELCoefficients(*[f[0] for f in pair.coeffs]),
                                   pair.rhs[0].numpy())
    d = np.sqrt((result["v_x"][k] - u_ref[0]) ** 2 + (result["v_y"][k] - u_ref[1]) ** 2)
    return float(d[1:-1, 1:-1].max())


def main():
    # 1. the device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {name}, torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    from opticalflow_tpu_torch import variational_optical_flow
    from opticalflow_tpu_torch.ops import cuda_kernels as ck

    # 2. build
    t0 = time.perf_counter()
    ck.load_library()
    print(f"build: {', '.join(sorted(ck.ENTRY_POINTS))} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {ck.BUILD_SECONDS} s, one process per source)")
    for line in ck.BUILD_LOG.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. kernels vs plain versions
    movie = bench_movie()
    large = embryo_pair()
    entries = check_kernels(movie, large, dev, smi)

    # 4. the main path
    movie_t = torch.from_numpy(movie).to(dev)
    kw = dict(speed_alpha=ALPHA, remodelling_alpha=ALPHA, warm_start="two-pass")
    t0 = time.perf_counter()
    variational_optical_flow(movie_t, **kw)
    warm_s = time.perf_counter() - t0
    reset_counters()
    t0 = time.perf_counter()
    result = variational_optical_flow(movie_t, **kw)  # returns host arrays: synchronised
    solve_s = time.perf_counter() - t0
    counts = read_counters()
    launches, plain, syncs = counts["B1"], counts["B1 plain"], counts["host syncs"]

    n_pairs = N_FRAMES - 1
    conv = np.asarray(result["converged_all"])
    its = np.asarray(result["iterations"])
    print(f"main path: {n_pairs} pairs {DIM}x{DIM} in {solve_s:.3f} s (warm-up run "
          f"{warm_s:.3f} s) = {n_pairs / solve_s:.3f} pairs/s [{smi}]")
    print(f"  iterations per pair {its.tolist()}, converged {int(conv.sum())}/{conv.size}, "
          f"el_matvec launches {launches} ({launches / n_pairs:.1f} per pair), plain-version "
          f"calls {plain}, host syncs {syncs}", flush=True)
    if conv.shape != (n_pairs,) or not conv.all():
        raise AssertionError(f"not every pair converged: {conv.tolist()}")
    if launches == 0 or plain != 0 or counts["B2 plain"] != 0:
        raise AssertionError(f"main path bypassed the kernel: {counts}")
    for key in ("v_x", "v_y", "remodelling"):
        if result[key].shape != (n_pairs, DIM, DIM) or not np.isfinite(result[key]).all():
            raise AssertionError(f"{key}: bad shape or non-finite values")
    for k in ORACLE_PAIRS:
        e = oracle_epe(movie, result, k)
        print(f"  pair {k}: EPE {e:.3e} px vs the f64 direct solve (limit {EPE_LIMIT_PX:g})",
              flush=True)
        if not e < EPE_LIMIT_PX:
            raise AssertionError(f"pair {k}: EPE {e} px")

    # 5. the large-grid path
    runs = {f"{DIM}x{DIM} two-pass": counts, **large_grid_path(large, dev, smi)}

    for kernel, entry in entries.items():
        label = KERNELS[kernel][0]
        entry["launches_by_path"] = {path: c[label] for path, c in runs.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())
    print(json.dumps({"kernels": list(entries.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
