"""Batched matrix-free Krylov solvers: BiCGStab, CG and flexible GMRES.

Counterparts of ``opticalflow_tpu.solve.krylov`` for a batch of
independent systems: ``b`` is (B, ...), the matvec and preconditioner act
on the whole batch, and every scalar of a recurrence (BiCGStab's rho,
alpha, omega, the iteration count, the best and checkpoint norms, the
stagnation and breakdown flags; FGMRES's column index, Givens rotations,
residual estimate and guards) is a per-pair (B,) value.  A pair whose own
exit test has fired is frozen: the batch's step is still computed for it,
but its state is kept, exactly as under ``jax.vmap`` of the JAX
``lax.while_loop``.

The JAX solvers are one device program per solve.  Here a loop's step
(one BiCGStab or CG iteration, one FGMRES Arnoldi column) reads and writes
fixed state buffers, and on CUDA tensors it is captured once per call into
a CUDA graph and replayed (:class:`_Step`): the kernels and torch ops of a
step are launched as one graph, with no host work between them.  The host
reads the loop's exit from the device once per chunk of ``CHUNK`` steps;
every such read is counted as ``krylov/host_syncs``, every capture as
``krylov/graph_captures`` (its host time, the capture alone, as the span
``krylov/capture``) and every replay as ``krylov/graph_replays``
(utils.observability).  Steps past a pair's exit inside a chunk leave its
state as it was, so the results are those of a read after every step, bit
for bit, whatever ``CHUNK`` is.  On the CPU the same steps run uncaptured.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, NamedTuple, Optional

import torch

from opticalflow_tpu_torch.ops import cuda_kernels
from opticalflow_tpu_torch.utils import observability

MatVec = Callable[[torch.Tensor], torch.Tensor]
Precond = Callable[[torch.Tensor], torch.Tensor]

# Steps between two reads of a loop's exit.  A read costs a host sync, the
# card draining its queue before the host launches again; the steps a chunk
# runs past the last pair's exit cost their device time, and the
# refinement's correction solves stop after a few steps.  PERF.md (§6)
# gives the measurements this value was chosen on: 2 against 4 and 8.
CHUNK = 2


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iterations: torch.Tensor  # (B,) int32
    residual_norm: torch.Tensor  # (B,) final unpreconditioned ||b - Ax||
    converged: torch.Tensor  # (B,) bool


def acc_dtype(dtype, high_precision: bool):
    """float64 accumulation for float32 fields when requested.  Unlike the
    JAX package, where this needed x64 and so ran in float32 on the TPU,
    the port always honours the flag."""
    return torch.float64 if high_precision else dtype


def batch_dot(a: torch.Tensor, b: torch.Tensor, acc) -> torch.Tensor:
    """Per-pair dot products (B,) accumulated in ``acc``."""
    return (a.to(acc) * b.to(acc)).flatten(1).sum(dim=1)


def _bc(s: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (B,) tensor viewed to broadcast against ``like`` (B, ...)."""
    return s.reshape((-1,) + (1,) * (like.dim() - 1))


_PRECISION_LOCK = threading.Lock()
_PRECISION = {"depth": 0, "saved": None}  # blocks inside full_f32_precision, the flags before


@contextlib.contextmanager
def full_f32_precision():
    """No TF32 in matrix products or convolutions for the duration (the
    counterpart of the JAX package's HIGHEST matmul precision).  The flags
    are the process's: the first of several blocks open at once, in any
    thread, clears them and the last to close restores them."""
    with _PRECISION_LOCK:
        if _PRECISION["depth"] == 0:
            _PRECISION["saved"] = (torch.backends.cuda.matmul.allow_tf32,
                                   torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _PRECISION["depth"] += 1
    try:
        yield
    finally:
        with _PRECISION_LOCK:
            _PRECISION["depth"] -= 1
            if _PRECISION["depth"] == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _PRECISION["saved"]


# .uncaptured: this thread's steps run without graphs; .capture: its capture
# stream, graph memory pool and latest graph on each device
# (:func:`_capture_context`)
_LOCAL = threading.local()


@contextlib.contextmanager
def _uncaptured():
    """Within the block this thread's Krylov steps run on CUDA tensors as
    on the CPU, without capture: for a matvec that copies between devices
    (parallel.spmd's exchange route), whose graph would span them, and to
    hold the graphed solve against the same steps uncaptured."""
    before = getattr(_LOCAL, "uncaptured", False)
    _LOCAL.uncaptured = True
    try:
        yield
    finally:
        _LOCAL.uncaptured = before


def _capture_context(device: torch.device) -> list:
    """This thread's capture stream, graph memory pool and latest graph on
    ``device``, shared by all its captures there: a step captured after
    another's graph is gone takes the memory that graph held, where a pool
    of its own would allocate its scratch anew (cudaMalloc) at every
    capture.  Sharing is safe because a step's scratch is dead once the
    step ends (its results are copied into buffers allocated outside the
    pool) and this thread's replays run one after another on its current
    stream.  The latest graph is kept so that the pool stays in use between
    two solves: the allocator takes no new capture into a pool whose graphs
    are all gone."""
    contexts = getattr(_LOCAL, "capture", None)
    if contexts is None:
        contexts = _LOCAL.capture = {}
    if device.index not in contexts:
        contexts[device.index] = [torch.cuda.Stream(device), torch.cuda.graph_pool_handle(), None]
    return contexts[device.index]


def _any(flags: torch.Tensor) -> bool:
    """Whether any of the (B,) device ``flags`` is set: one host sync."""
    observability.add_count("krylov/host_syncs")
    return bool(flags.any())


class _Step:
    """One step of a loop, ``fn()``, which reads and writes fixed buffers in
    place.  On the CPU, or under :func:`_uncaptured`, each call runs it.  On
    a CUDA device the first call runs it on this thread's capture stream
    (which also takes each kernel's first launch and cuBLAS's workspace out
    of the capture) and then captures it on that stream into a CUDA graph,
    in this thread's memory pool (:func:`_capture_context`), thread-locally
    (several threads may capture at once, each on its own device and
    stream); every later call replays the graph on the current stream.  The
    kernel counters a capture records are added back at every replay.  A
    failed capture or replay raises."""

    def __init__(self, fn: Callable[[], None], device: torch.device):
        self.fn, self.device = fn, device
        self.captures = device.type == "cuda" and not getattr(_LOCAL, "uncaptured", False)
        self.graph, self.counts = None, None

    def __call__(self) -> None:
        if not self.captures:
            self.fn()
            return
        with torch.cuda.device(self.device):
            if self.graph is None:
                self._run_and_capture()
                return
            self.graph.replay()
        cuda_kernels.add_counts(self.counts)
        observability.add_count("krylov/graph_replays")

    def _run_and_capture(self) -> None:
        current = torch.cuda.current_stream(self.device)
        context = _capture_context(self.device)
        stream, pool, _ = context
        stream.wait_stream(current)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            self.fn()
            with observability.span("krylov/capture"), cuda_kernels.recorded_counts() as counts:
                graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    self.fn()
                finally:
                    graph.capture_end()
        current.wait_stream(stream)
        self.graph, self.counts, context[2] = graph, counts, graph
        observability.add_count("krylov/graph_captures")


def _run_chunks(step: _Step, active: Callable[[], torch.Tensor], max_steps: int) -> None:
    """Steps in chunks of ``CHUNK`` while ``active()`` (B,) has a pair set,
    read before each chunk; at most ``max_steps`` steps, after which no
    pair is active."""
    done = 0
    while done < max_steps and _any(active()):
        for _ in range(min(CHUNK, max_steps - done)):
            step()
        done += CHUNK


def _commit(buffers, values) -> None:
    for buf, value in zip(buffers, values):
        buf.copy_(value)


def bicgstab(
    matvec: MatVec,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    precond: Optional[Precond] = None,
    rtol: float = 1e-6,
    atol: float = 0.0,
    max_iterations: int = 1000,
    high_precision_reductions: bool = True,
    tol_floor_eps_multiple: float = 300.0,
    stagnation_window: int = 100,
) -> KrylovResult:
    """Right-preconditioned BiCGStab on a batch of systems.

    Each pair stops at ``||b - A x|| <= max(rtol * ||b||, atol)``, with the
    tolerance floored at ``tol_floor_eps_multiple * eps(dtype) * ||b||``;
    on breakdown; at ``max_iterations``; or when the stagnation guard fires
    (every ``stagnation_window`` iterations: best norm within 4x of tol and
    <5% better than at the last checkpoint).  Returns each pair's *best*
    iterate and its recomputed true residual.
    """
    acc = acc_dtype(b.dtype, high_precision_reductions)

    def dot(u, v):
        return batch_dot(u, v, acc)

    if precond is None:
        precond = lambda r: r  # noqa: E731
    if x0 is None:
        x0 = torch.zeros_like(b)
    B = b.shape[0]
    dev = b.device

    rhat = b - matvec(x0)
    b_norm = torch.sqrt(dot(b, b))
    eff_rtol = max(rtol, tol_floor_eps_multiple * torch.finfo(b.dtype).eps)
    tol = torch.clamp(eff_rtol * b_norm, min=atol)
    tiny = torch.finfo(b.dtype).tiny

    # the state buffers, in place across the loop
    res0 = torch.sqrt(dot(rhat, rhat))
    state = (x0.clone(), rhat.clone(), torch.zeros_like(b), torch.zeros_like(b),
             torch.ones(B, dtype=acc, device=dev), torch.ones(B, dtype=acc, device=dev),
             torch.ones(B, dtype=acc, device=dev), torch.zeros(B, dtype=torch.int32, device=dev),
             res0, torch.zeros(B, dtype=torch.bool, device=dev),
             torch.zeros(B, dtype=torch.bool, device=dev), x0.clone(), res0.clone(),
             res0.clone())

    def active():
        k, res_norm, breakdown, stagnated = state[7:11]
        return (k < max_iterations) & ~stagnated & (res_norm > tol) & ~breakdown

    def iteration():
        (x, r, p, v, rho, alpha, omega, k, res_norm, breakdown, stagnated, best_x, best_norm,
         ckpt_norm) = state
        a = active()
        rho_new = dot(rhat, r)
        denom = rho * omega
        beta = (rho_new * alpha) / torch.where(denom.abs() > 0, denom, tiny)
        p_new = r + (_bc(beta, r) * (p.to(acc) - _bc(omega, r) * v.to(acc))).to(b.dtype)
        phat = precond(p_new)
        v_new = matvec(phat)
        rhat_v = dot(rhat, v_new)
        alpha_new = rho_new / torch.where(rhat_v.abs() > 0, rhat_v, tiny)
        sbreak = (rho_new.abs() == 0) | (rhat_v.abs() == 0)
        svec = r - (_bc(alpha_new, r) * v_new.to(acc)).to(b.dtype)
        shat = precond(svec)
        t = matvec(shat)
        tt = dot(t, t)
        omega_new = dot(t, svec) / torch.where(tt > 0, tt, tiny)
        x_new = (x + (_bc(alpha_new, x) * phat.to(acc)).to(b.dtype)
                 + (_bc(omega_new, x) * shat.to(acc)).to(b.dtype))
        r_new = svec - (_bc(omega_new, r) * t.to(acc)).to(b.dtype)
        res_new = torch.sqrt(dot(r_new, r_new))
        is_best = res_new < best_norm
        best_new = torch.where(is_best, res_new, best_norm)
        k_new = k + 1
        at_ckpt = (k_new % stagnation_window) == 0
        stall = (best_new <= 4.0 * tol) & (best_new > 0.95 * ckpt_norm)

        # commit the step for active pairs only (frozen pairs keep state)
        av = _bc(a, b)
        _commit(state, (
            torch.where(av, x_new, x), torch.where(av, r_new, r), torch.where(av, p_new, p),
            torch.where(av, v_new, v), torch.where(a, rho_new, rho),
            torch.where(a, alpha_new, alpha), torch.where(a, omega_new, omega),
            torch.where(a, k_new, k), torch.where(a, res_new, res_norm),
            torch.where(a, sbreak, breakdown), torch.where(a, at_ckpt & stall, stagnated),
            torch.where(av & _bc(is_best, b), x_new, best_x), torch.where(a, best_new, best_norm),
            torch.where(a & at_ckpt, best_new, ckpt_norm)))

    _run_chunks(_Step(iteration, dev), active, max_iterations)
    best_x, k = state[11], state[7]
    # recompute the true residual once (guards against drift of the
    # recursively updated r)
    true_res = b - matvec(best_x)
    true_norm = torch.sqrt(dot(true_res, true_res))
    return KrylovResult(x=best_x, iterations=k, residual_norm=true_norm,
                        converged=true_norm <= tol)


def cg(
    matvec: MatVec,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    precond: Optional[Precond] = None,
    rtol: float = 1e-6,
    atol: float = 0.0,
    max_iterations: int = 1000,
    high_precision_reductions: bool = True,
    tol_floor_eps_multiple: float = 300.0,
) -> KrylovResult:
    """Preconditioned conjugate gradient on a batch of symmetric positive
    definite systems.  Each pair stops at the tolerance of :func:`bicgstab`
    or at ``max_iterations``; returns each pair's last iterate and its
    recomputed true residual."""
    acc = acc_dtype(b.dtype, high_precision_reductions)

    def dot(u, v):
        return batch_dot(u, v, acc)

    if precond is None:
        precond = lambda r: r  # noqa: E731
    if x0 is None:
        x0 = torch.zeros_like(b)

    r = b - matvec(x0)
    z = precond(r)
    b_norm = torch.sqrt(dot(b, b))
    eff_rtol = max(rtol, tol_floor_eps_multiple * torch.finfo(b.dtype).eps)
    tol = torch.clamp(eff_rtol * b_norm, min=atol)
    tiny = torch.finfo(b.dtype).tiny

    # the state buffers (x, r, p, rz, k, res_norm), in place across the loop
    state = (x0.clone(), r, z.clone(), dot(r, z),
             torch.zeros(b.shape[0], dtype=torch.int32, device=b.device),
             torch.sqrt(dot(r, r)))

    def active():
        k, res_norm = state[4:]
        return (k < max_iterations) & (res_norm > tol)

    def iteration():
        x, r, p, rz, k, res_norm = state
        a = active()
        ap = matvec(p)
        pap = dot(p, ap)
        alpha = rz / torch.where(pap.abs() > 0, pap, tiny)
        x_new = x + (_bc(alpha, x) * p.to(acc)).to(b.dtype)
        r_new = r - (_bc(alpha, r) * ap.to(acc)).to(b.dtype)
        z_new = precond(r_new)
        rz_new = dot(r_new, z_new)
        beta = rz_new / torch.where(rz.abs() > 0, rz, tiny)
        p_new = z_new + (_bc(beta, p) * p.to(acc)).to(b.dtype)

        av = _bc(a, b)
        _commit(state, (
            torch.where(av, x_new, x), torch.where(av, r_new, r), torch.where(av, p_new, p),
            torch.where(a, rz_new, rz), torch.where(a, k + 1, k),
            torch.where(a, torch.sqrt(dot(r_new, r_new)), res_norm)))

    _run_chunks(_Step(iteration, b.device), active, max_iterations)
    x, k = state[0], state[4]
    true_res = b - matvec(x)
    true_norm = torch.sqrt(dot(true_res, true_res))
    return KrylovResult(x=x, iterations=k, residual_norm=true_norm, converged=true_norm <= tol)


@full_f32_precision()
def fgmres(
    matvec: MatVec,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    precond: Optional[Precond] = None,
    rtol: float = 1e-6,
    atol: float = 0.0,
    max_iterations: int = 1000,
    restart: int = 32,
    high_precision_reductions: bool = True,
    tol_floor_eps_multiple: float = 300.0,
    truncation_guard: bool = True,
) -> KrylovResult:
    """Flexible GMRES(restart) on a batch of systems, right-preconditioned:
    the robust large-grid solver (why, and the guards below, are explained
    at ``opticalflow_tpu.solve.krylov.fgmres``).

    Kept from the JAX solver: classical Gram-Schmidt with one full
    reorthogonalisation (CGS2), Givens rotations with the running residual
    estimate, the Arnoldi breakdown guard (``hj1 <= 3e-4 ||A z_j||``) and
    the R-conditioning guard (``|r_jj| <= 1e-5 max|r_ii|``), the cap
    ``k + j < max_iterations`` inside a cycle, the true residual at every
    restart, the truncation guard (half and quarter cycles evaluated when
    the full cycle's true residual disagrees with the estimate), the stop
    on <1% progress per cycle, and keeping each pair's best iterate.

    Built as the JAX solver is: the Arnoldi basis V (B, restart+1, N) and
    the flexible basis Z (B, restart, N) are kept at full size, both in the
    accumulation dtype (float64 for float32 fields by default), and each
    pair's column index ``j`` is a device tensor.  CGS2 projects on the
    whole of V, whose rows not yet written are zero; the earlier rotations
    run over all ``restart`` positions, masked to those below ``j``; the new
    rotation, the guards, ``g``, the estimate and ``rmax`` are device ops in
    ``b.dtype``.  One Arnoldi column is one :class:`_Step`, replayed from a
    CUDA graph on the card, with the cycle's exit read once per chunk of
    columns.  The least squares of each restart (``solve_triangular`` over
    each pair's columns) and the truncation guard run on the device too;
    the restart reads the device once, twice where a pair's truncations
    are evaluated.  The products are batched in the accumulation dtype,
    independent of the caller's TF32 setting.
    """
    acc = acc_dtype(b.dtype, high_precision_reductions)

    def dot(u, v):
        return batch_dot(u, v, acc)

    if precond is None:
        precond = lambda r: r  # noqa: E731
    if x0 is None:
        x0 = torch.zeros_like(b)
    dt, dev = b.dtype, b.device
    B, N, m = b.shape[0], b[0].numel(), int(restart)
    tiny = torch.finfo(dt).tiny

    b_norm = torch.sqrt(dot(b, b))
    eff_rtol = max(rtol, tol_floor_eps_multiple * torch.finfo(dt).eps)
    tol = torch.clamp(eff_rtol * b_norm, min=atol)
    r0 = b - matvec(x0)
    x = x0
    res_norm = torch.sqrt(dot(r0, r0))
    k = torch.zeros(B, dtype=torch.int32, device=dev)
    stalled = torch.zeros(B, dtype=torch.bool, device=dev)

    # the cycle's buffers, in place across its columns and its restarts
    V = torch.zeros((B, m + 1, N), dtype=acc, device=dev)
    Z = torch.zeros((B, m, N), dtype=acc, device=dev)
    R = torch.zeros((B, m + 1, m), dtype=dt, device=dev)
    rot0 = torch.zeros((B, m, 2), dtype=dt, device=dev)  # rotation i: (c, -s) ...
    rot1 = torch.zeros((B, m, 2), dtype=dt, device=dev)  # ... and (s, c)
    g = torch.zeros((B, m + 1), dtype=dt, device=dev)
    j = torch.zeros(B, dtype=torch.int64, device=dev)
    est = torch.zeros(B, dtype=dt, device=dev)
    brk = torch.zeros(B, dtype=torch.bool, device=dev)
    rmax = torch.zeros(B, dtype=dt, device=dev)
    act = torch.zeros(B, dtype=torch.bool, device=dev)
    k_cycle = torch.zeros_like(k)  # k at the cycle's start
    pairs = torch.arange(B, device=dev)
    rows = torch.arange(m + 1, device=dev)

    def column():
        """Arnoldi column j of every pair, committed where ``act``."""
        vj = V[pairs, j]
        z = precond(vj.to(dt).reshape(b.shape))
        w = matvec(z).reshape(B, N)
        w_entry = torch.sqrt(dot(w, w)).to(dt)
        h1 = torch.bmm(V, w.to(acc)[:, :, None])
        w = w - torch.bmm(V.transpose(1, 2), h1)[..., 0].to(dt)
        h2 = torch.bmm(V, w.to(acc)[:, :, None])
        w = w - torch.bmm(V.transpose(1, 2), h2)[..., 0].to(dt)
        h = (h1 + h2)[..., 0].to(dt)  # (B, m+1)
        hj1 = torch.sqrt(dot(w, w)).to(dt)
        v_next = (w / torch.clamp(hj1, min=tiny)[:, None]).to(acc)
        j1, jz = torch.clamp(j + 1, max=m), torch.clamp(j, max=m - 1)  # in range when frozen
        a = act[:, None]
        V[pairs, j1] = torch.where(a, v_next, V[pairs, j1])
        Z[pairs, jz] = torch.where(a, z.reshape(B, N).to(acc), Z[pairs, jz])

        # the new column [h with position j+1 := hj1], the earlier rotations
        col = torch.where(rows == (j + 1)[:, None], hj1[:, None], h)
        applied = rows[None, :m] < j[:, None]
        for i in range(m):
            hi = col[:, i : i + 2]
            turned = rot0[:, i] * hi[:, :1] + rot1[:, i] * hi[:, 1:]
            col[:, i : i + 2] = torch.where(applied[:, i : i + 1], turned, hi)

        # the new rotation, eliminating col[j+1]
        a1, a2 = col[pairs, j], col[pairs, j1]
        denom = torch.sqrt(a1 * a1 + a2 * a2)
        safe = torch.clamp(denom, min=tiny)
        c_new = torch.where(denom > 0, a1 / safe, 1.0)
        s_new = torch.where(denom > 0, a2 / safe, 0.0)
        rdd = c_new * a1 + s_new * a2
        col[pairs, j] = rdd
        col[pairs, j1] = torch.zeros_like(a2)
        gj = g[pairs, j]
        rmax_new = torch.maximum(rmax, rdd.abs())
        brk_new = (hj1 <= 3e-4 * w_entry) | (rdd.abs() <= 1e-5 * rmax_new)

        rot0[pairs, jz] = torch.where(a, torch.stack([c_new, -s_new], dim=1), rot0[pairs, jz])
        rot1[pairs, jz] = torch.where(a, torch.stack([s_new, c_new], dim=1), rot1[pairs, jz])
        g_j1 = torch.where(act, -s_new * gj, g[pairs, j1])
        g[pairs, j] = torch.where(act, c_new * gj, gj)
        g[pairs, j1] = g_j1
        R[pairs, :, jz] = torch.where(a, col, R[pairs, :, jz])
        j_new = j + act
        est_new = torch.where(act, g_j1.abs(), est)
        brk_new = torch.where(act, brk_new, brk)
        _commit((est, rmax, brk, j), (est_new, torch.where(act, rmax_new, rmax), brk_new, j_new))
        act.copy_(act & (j_new < m) & (est_new > tol) & ~brk_new
                  & (k_cycle + j_new < max_iterations))

    step = _Step(column, dev)

    def solution_for(cols):
        # least squares over each pair's first `cols` columns (R is
        # triangular, so the truncated problem is exactly the shorter
        # Arnoldi least squares)
        used = rows[None, :m] < cols[:, None]
        Rm = R[:, :m, :m] + torch.diag_embed(torch.where(used, 0.0, 1.0).to(dt))
        gm = torch.where(used, g[:, :m], 0.0)
        y = torch.linalg.solve_triangular(Rm, gm[:, :, None], upper=True)
        y = torch.where(used[:, :, None], y, 0.0)
        xc = x + torch.bmm(y.to(acc).transpose(1, 2), Z)[:, 0].to(dt).reshape(x.shape)
        rc = b - matvec(xc)
        return xc, torch.sqrt(dot(rc, rc))

    def restarted(x_new, res_new):
        """The outer state after the cycle, and its exit."""
        better = outer & (res_new < res_norm)
        k_new = torch.where(outer, k + j.to(k.dtype), k)
        stalled_new = torch.where(outer, res_new > 0.99 * res_norm, stalled)
        res_keep = torch.where(better, res_new, res_norm)
        return ((torch.where(_bc(better, x), x_new, x), k_new, res_keep, stalled_new),
                (k_new < max_iterations) & (res_keep > tol) & ~stalled_new)

    outer = (k < max_iterations) & (res_norm > tol) & ~stalled
    going = _any(outer)
    while going:
        r = b - matvec(x)
        beta = torch.sqrt(dot(r, r)).to(dt)
        V.zero_()
        V[:, 0] = (r.reshape(B, N) / torch.clamp(beta, min=tiny)[:, None]).to(acc)
        for buf in (Z, R, rot0, rot1, g, j, brk, rmax):
            buf.zero_()
        g[:, 0] = beta
        est.copy_(beta)
        k_cycle.copy_(k)
        act.copy_(outer & (est > tol) & (k < max_iterations))
        t = 0
        while True:  # a cycle ends by its restart length at the latest
            for _ in range(min(CHUNK, m - t)):
                step()
            t += CHUNK
            if t >= m or not _any(act):
                break

        x_new, res_new = solution_for(j)
        if truncation_guard:
            disagree = outer & (res_new > 2.0 * est) & (res_new > tol)
        else:
            disagree = outer.clone()
        after, outer_next = restarted(x_new, res_new)
        observability.add_count("krylov/host_syncs")
        any_disagree, going = torch.stack([disagree.any(), outer_next.any()]).tolist()
        if any_disagree:
            # evaluated for the whole batch, taken only where a pair disagrees
            for xc, rc in (solution_for((j + 1) // 2), solution_for((j + 3) // 4)):
                take = disagree & (rc < res_new)
                x_new = torch.where(_bc(take, x), xc, x_new)
                res_new = torch.where(take, rc, res_new)
            after, outer_next = restarted(x_new, res_new)
            going = _any(outer_next)
        (x, k, res_norm, stalled), outer = after, outer_next

    return KrylovResult(x=x, iterations=k, residual_norm=res_norm, converged=res_norm <= tol)
