#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the device: ``torch.cuda.get_device_name`` and nvidia-smi's name and
   power limit (fails without a CUDA device);
2. build every kernel of the main path from ``opticalflow_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, with the time per call of each (CUDA
   events);
4. the main path once warm and once timed: ``variational_optical_flow`` on
   the bench movie (13 frames of 256x256, 12 pairs, two-pass warm start,
   alpha_s = alpha_r = 1000), with every kernel's launch counter set to 0
   just before the timed run and read just after, and the flow of pairs 1
   and 11 held against the float64 assembled direct solve.

The second-to-last line is a JSON object with one entry per kernel, the
last line ``{"ok": true, "device": {...}}``.  Imports no JAX.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REL_TOL = 1e-5  # per field: max|kernel - plain| <= REL_TOL * max|plain| (both f32)
EPE_LIMIT_PX = 1e-3  # flow endpoint error vs the f64 direct solve
N_FRAMES, DIM, ALPHA = 13, 256, 1000.0
ORACLE_PAIRS = (1, 11)


def bench_movie():
    """The bench movie: blob width 20, sigma 3, v = (0.15, 0.1) per frame,
    x100 and rounded through float32 (integer-like microscopy data is
    exact in f32, so the f64 oracle sees the same frames)."""
    from opticalflow_tpu_torch.core.synth import make_translating_blob_movie

    movie, _ = make_translating_blob_movie(n_frames=N_FRAMES, dimension=DIM, width=20.0,
                                           sigma=3.0, v_x=0.15, v_y=0.1)
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


def check_el_matvec(movie, dev, card):
    """Kernel vs plain version at the main path's shapes; returns the JSON
    entry (without the launch count)."""
    from opticalflow_tpu_torch.ops import cuda_kernels as ck

    frames = torch.from_numpy(movie).to(dev)
    scale = frames.flatten(1).amax(1)
    I_all = (frames / scale[:, None, None]).contiguous()  # normalised as the solve does
    scalars_all = torch.stack([ALPHA / scale**2, torch.full_like(scale, ALPHA)], dim=-1)
    gen = torch.Generator(dev).manual_seed(0)
    cases = [  # (name, B, K, m, n, compat)
        ("11 pairs 254x254 compat", 11, 1, 254, 254, True),
        ("11 pairs 254x254 fixed", 11, 1, 254, 254, False),
        ("11 pairs x 27 probes 254x254", 11, 27, 254, 254, True),
        ("2 pairs 61x190 ragged", 2, 1, 61, 190, True),
    ]
    max_abs = 0.0
    timed = {}
    for name, B, K, m, n, compat in cases:
        I = I_all[:B, : m + 2, : n + 2].contiguous()
        scalars = scalars_all[:B].contiguous()
        u = torch.randn((B, K, 3, m, n), device=dev, generator=gen)
        y = ck.el_matvec_reduced_fused(I, scalars, u, compat)
        y_ref = ck.el_matvec_reduced_fused_ref(I, scalars, u, compat)
        torch.cuda.synchronize()
        rel = []
        for q in range(3):
            err = (y[:, :, q] - y_ref[:, :, q]).abs().max().item()
            rel.append(err / y_ref[:, :, q].abs().max().item())
            max_abs = max(max_abs, err)
        k_ms = cuda_ms(lambda: ck.el_matvec_reduced_fused(I, scalars, u, compat), 50)
        p_ms = cuda_ms(lambda: ck.el_matvec_reduced_fused_ref(I, scalars, u, compat), 20)
        gbytes = 4 * (B * (m + 2) * (n + 2) + 6 * B * K * m * n) / 1e9
        print(f"el_matvec {name}: max rel err per field "
              f"{', '.join(f'{r:.2e}' for r in rel)} (tol {REL_TOL:g}); kernel {k_ms:.4f} ms "
              f"({gbytes / k_ms * 1e3:.0f} GB/s), plain {p_ms:.4f} ms  [{card}]", flush=True)
        if max(rel) > REL_TOL:
            raise AssertionError(f"el_matvec kernel disagrees with its plain version: {name}")
        timed[name] = (k_ms, p_ms)
    k_ms, p_ms = timed[cases[0][0]]
    return {"name": "el_matvec_reduced_fused", "route": "cuda",
            "source": "opticalflow_tpu_torch/csrc/el_matvec.cu",
            "replaces": "opticalflow_tpu/ops/pallas_kernels.py:398",
            "max_abs_err": max_abs, "ms": k_ms, "plain_ms": p_ms}


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
    from opticalflow_tpu_torch.utils import observability

    # 2. build
    t0 = time.perf_counter()
    ck.load_library()
    print(f"build: el_matvec.cu in {time.perf_counter() - t0:.2f} s (nvcc {ck.BUILD_SECONDS} s)")
    for line in ck.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. kernels vs plain versions
    movie = bench_movie()
    entry = check_el_matvec(movie, dev, smi)

    # 4. the main path
    movie_t = torch.from_numpy(movie).to(dev)
    kw = dict(speed_alpha=ALPHA, remodelling_alpha=ALPHA, warm_start="two-pass")
    t0 = time.perf_counter()
    variational_optical_flow(movie_t, **kw)
    warm_s = time.perf_counter() - t0
    ck.LAUNCHES = 0
    ck.PLAIN_CALLS = 0
    observability.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = variational_optical_flow(movie_t, **kw)  # returns host arrays: synchronised
    solve_s = time.perf_counter() - t0
    launches, plain = ck.LAUNCHES, ck.PLAIN_CALLS
    syncs = observability.counts().get("krylov/host_syncs", 0)

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
    if launches == 0 or plain != 0:
        raise AssertionError(f"main path bypassed the kernel: {launches} launches, {plain} plain")
    for key in ("v_x", "v_y", "remodelling"):
        if result[key].shape != (n_pairs, DIM, DIM) or not np.isfinite(result[key]).all():
            raise AssertionError(f"{key}: bad shape or non-finite values")
    for k in ORACLE_PAIRS:
        e = oracle_epe(movie, result, k)
        print(f"  pair {k}: EPE {e:.3e} px vs the f64 direct solve (limit {EPE_LIMIT_PX:g})",
              flush=True)
        if not e < EPE_LIMIT_PX:
            raise AssertionError(f"pair {k}: EPE {e} px")

    entry["launches"] = launches
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
