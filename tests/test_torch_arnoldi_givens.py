"""Kernel B8, FGMRES's Givens rotations and column bookkeeping
(``csrc/krylov_givens.cu``; wrapper ``cuda_kernels.arnoldi_givens``, plain
version ``arnoldi_givens_ref``).

On the CPU: the plain version against a per-pair NumPy transcription of the
JAX solver's column (``opticalflow_tpu/solve/krylov.py:398-437``: the
``rot`` loop, the new rotation, the guards, R, g, the estimate) and of the
port's exit of the column (``j < m``, ``est > tol`` in the accumulation
dtype, no breakdown, ``k_cycle + j < max_iterations``), bit for bit, in
float32 and float64 fields, on random states and on pairs at j = 0, at
j = m - 1, inactive (also at j = m, where the clamps of the rows take
effect), with ``denom`` = 0, with each guard firing, at the iteration cap
and at ``est <= tol``; ``fgmres`` runs it once a column step.

On the card (marked ``gpu``, skipped here; this file imports no JAX:
``python -m pytest tests/test_torch_arnoldi_givens.py -m gpu --noconftest``):
B8 against the plain version bit for bit (every output and every buffer it
updates) at B = 1, 2, 20, 49 with m = 32 and at m = 64, in each (storage,
accumulation) pair it takes; one launch counted a replay of a captured
step; the wrapper raising where the kernel does not take its operands;
and whole solves, ``solve_frame_pair`` with FGMRES on B8 against the same
solve with the plain bookkeeping patched in, bit for bit in ``x``, the
iterations and the residuals of every Krylov call: a main solve at one
and at 49 pairs, and a four-pair solve whose correction solves narrow,
with ``ARN_LAUNCHES`` equal to the column steps.
"""

from torch_threads import one_intra_op_thread  # noqa: F401,I001 (autouse; first: see its module)

import math

import numpy as np
import pytest
import torch

from opticalflow_tpu_torch.ops import cuda_kernels as ck
from opticalflow_tpu_torch.solve import krylov

TYPES = [(torch.float32, torch.float64), (torch.float32, torch.float32),
         (torch.float64, torch.float64)]
MAX_ITERATIONS = 1000
# the state's buffers in the order arnoldi_givens takes them, and its outputs
BUFFERS = ("R", "rot0", "rot1", "g", "j", "est", "rmax", "brk", "act")
OUTPUTS = ("hj1", "j1", "jz", "was")


def _state(B, m, dtype, acc, seed, special=True):
    """A column's inputs and state as numpy arrays: B7's dots hh (B, 2,
    m+1) and norms (B, 2) in ``acc``; R, rotations (c, -s) and (s, c) of
    random angles, g, est, rmax in ``dtype``; random j and act.  With
    ``special`` (B >= 10) pairs 0-9 are: j = 0; j = m - 1; inactive; denom
    = 0 (h_0 = hj1 = 0 at j = 0); the Arnoldi guard (hj1 = 1e-4 |w|); the
    R guard (rmax 1e12); at the iteration cap; at est <= tol; inactive at
    j = m; and j in the middle."""
    rng = np.random.default_rng(seed)
    dt, ac = np.dtype(str(dtype)[6:]), np.dtype(str(acc)[6:])
    theta = rng.uniform(0.0, 2.0 * np.pi, (B, m))
    c, s = np.cos(theta).astype(dt), np.sin(theta).astype(dt)
    h1 = rng.standard_normal((B, m + 1)) * 2.0
    st = {
        "hh": np.stack([h1, rng.standard_normal((B, m + 1)) * 1e-3], axis=1).astype(ac),
        "norms": np.stack([(h1 * h1).sum(1) + 5.0, rng.uniform(0.01, 2.0, B)], 1).astype(ac),
        "R": rng.standard_normal((B, m + 1, m)).astype(dt),
        "rot0": np.stack([c, -s], axis=2), "rot1": np.stack([s, c], axis=2),
        "g": rng.standard_normal((B, m + 1)).astype(dt),
        "j": rng.integers(0, m, B).astype(np.int64),
        "est": np.abs(rng.standard_normal(B)).astype(dt),
        "rmax": (np.abs(rng.standard_normal(B)) + 1.0).astype(dt),
        "brk": np.zeros(B, dtype=bool), "act": rng.random(B) < 0.8,
        "k_cycle": rng.integers(0, 200, B).astype(np.int32),
        "tol": rng.uniform(1e-8, 1e-6, B).astype(ac),
    }
    if special:
        st["act"][:10] = True
        st["j"][:10] = [0, m - 1, 3 % m, 0, m // 2, m // 2, m // 2, m // 2, m, m // 3]
        st["act"][2] = st["act"][8] = False
        st["hh"][3, :, 0] = 0.0
        st["norms"][3, 1] = 0.0
        st["norms"][4, 1] = st["norms"][4, 0] * 1e-8
        st["rmax"][5] = 1e12
        st["k_cycle"][6] = MAX_ITERATIONS - (m // 2 + 1)
        st["tol"][7] = 1e30
    return st


def _root(x):
    """The square root of a NumPy scalar as PyTorch takes it on the CPU,
    where it is not always the IEEE root: of float32 8.5800705 it gives
    2.9291756, where the IEEE root is 2.9291759 (the card's, in B8 and in
    torch on CUDA).  The port's CPU path has always
    taken this root, so the transcription does too."""
    return type(x)(torch.sqrt(torch.tensor(x)).item())


def _numpy_column(st, m, max_iterations):
    """The column per pair in NumPy scalars of the field dtype, as the JAX
    solver writes it (``cs``, ``sn`` its rotations; c_i, s_i here are rot0's
    and rot1's first entries), then the port's exit; returns the new state
    and the outputs (hj1, j1, jz, act as it was).  Square roots:
    :func:`_root`."""
    st = {k: v.copy() for k, v in st.items()}
    dt, ac = st["R"].dtype.type, st["hh"].dtype.type
    tiny = dt(np.finfo(dt).tiny)
    B = st["R"].shape[0]
    out = {"hj1": np.zeros(B, dt), "j1": np.zeros(B, np.int64), "jz": np.zeros(B, np.int64),
           "was": st["act"].copy()}
    for b in range(B):
        j = int(st["j"][b])
        w_entry, hj1 = dt(_root(st["norms"][b, 0])), dt(_root(st["norms"][b, 1]))
        out["hj1"][b], out["j1"][b], out["jz"][b] = hj1, min(j + 1, m), min(j, m - 1)
        if not st["act"][b]:
            continue
        cs, sn = st["rot0"][b, :, 0], st["rot1"][b, :, 0]
        col = (st["hh"][b, 0] + st["hh"][b, 1]).astype(dt)
        col[j + 1] = hj1
        for i in range(m):  # rot
            if i < j:
                hi, hi1 = col[i], col[i + 1]
                col[i] = cs[i] * hi + sn[i] * hi1
                col[i + 1] = -sn[i] * hi + cs[i] * hi1
        a1, a2 = col[j], col[j + 1]
        denom = _root(a1 * a1 + a2 * a2)
        safe = max(denom, tiny)
        c_new = a1 / safe if denom > 0 else dt(1.0)
        s_new = a2 / safe if denom > 0 else dt(0.0)
        rdd = c_new * a1 + s_new * a2
        col[j], col[j + 1] = rdd, dt(0.0)
        st["rot0"][b, j] = c_new, -s_new
        st["rot1"][b, j] = s_new, c_new
        gj = st["g"][b, j]
        st["g"][b, j], st["g"][b, j + 1] = c_new * gj, -s_new * gj
        est = np.abs(st["g"][b, j + 1])
        st["R"][b, :, j] = col
        rmax = np.maximum(st["rmax"][b], np.abs(rdd))
        brk = bool(hj1 <= dt(3e-4) * w_entry) or bool(np.abs(rdd) <= dt(1e-5) * rmax)
        j += 1
        st["est"][b], st["rmax"][b], st["brk"][b], st["j"][b] = est, rmax, brk, j
        st["act"][b] = (j < m and ac(est) > st["tol"][b] and not brk
                        and int(st["k_cycle"][b]) + j < max_iterations)
    return st, out


def _tensors(st, device="cpu"):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in st.items()}


def _call(fn, t, max_iterations=MAX_ITERATIONS):
    return fn(t["hh"], t["norms"], t["R"], t["rot0"], t["rot1"], t["g"], t["j"], t["est"],
              t["rmax"], t["brk"], t["act"], t["k_cycle"], t["tol"], max_iterations)


def _bits(t):
    """The tensor's bits: floats as integers of their width (-0.0 is not 0.0)."""
    t = t.cpu()
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t


def _assert_same(got, want):
    for name in want:
        a, b = got[name], want[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(_bits(a), _bits(b)), name


@pytest.mark.parametrize("B,m,special", [(10, 8, True), (16, 32, False), (12, 32, True)])
@pytest.mark.parametrize("dtype,acc", TYPES)
def test_plain_version_is_the_jax_column_bit_for_bit(B, m, special, dtype, acc):
    st = _state(B, m, dtype, acc, seed=B * m, special=special)
    want_state, want_out = _numpy_column(st, m, MAX_ITERATIONS)
    t = _tensors(st)
    calls = ck.ARN_PLAIN_CALLS
    outputs = _call(ck.arnoldi_givens, t)
    assert ck.ARN_PLAIN_CALLS == calls + 1
    _assert_same(dict(zip(OUTPUTS, outputs)), _tensors(want_out))
    _assert_same({k: t[k] for k in BUFFERS}, {k: _tensors(want_state)[k] for k in BUFFERS})
    if special:  # what each special pair exercises did happen
        act, brk = t["act"], t["brk"]
        assert t["j"][:2].tolist() == [1, m] and not act[1]  # j reached m
        assert torch.equal(t["j"][[2, 8]], torch.tensor([3 % m, m])) and not act[[2, 8]].any()
        assert outputs[1][8] == m and outputs[2][8] == m - 1
        assert t["rot0"][3, 0].tolist() == [1.0, -0.0] and t["R"][3, 0, 0] == 0  # denom = 0
        assert brk[3] and brk[4] and brk[5] and not act[3:8].any()
        assert not brk[6] and not brk[7]  # the cap and the estimate alone end 6 and 7
        assert act[0] and act[9]


def test_inactive_pairs_keep_their_state():
    """Every pair inactive: no buffer changes, the outputs still written."""
    st = _state(6, 8, torch.float32, torch.float64, seed=5, special=False)
    st["act"][:] = False
    t = _tensors(st)
    before = {k: v.clone() for k, v in t.items()}
    hj1, j1, jz, was = _call(ck.arnoldi_givens, t)
    _assert_same(t, before)
    assert not was.any() and torch.equal(hj1, torch.sqrt(t["norms"][:, 1]).float())
    assert torch.equal(j1, torch.clamp(t["j"] + 1, max=8))
    assert torch.equal(jz, torch.clamp(t["j"], max=7))


def test_fgmres_runs_the_bookkeeping_once_a_column_step(monkeypatch):
    """A small FGMRES solve (restart 4, so it restarts): one call of the
    wrapper per column step, a column step being ``krylov/slot_columns``
    over the batch (nothing narrows without ``subset``), each given the
    solve's restart and accumulation dtype."""
    import torch.nn.functional as F

    from opticalflow_tpu_torch.utils import observability

    seen = []
    arnoldi_givens = ck.arnoldi_givens

    def counted(*args):
        seen.append((tuple(args[2].shape), args[0].dtype, args[-1]))
        return arnoldi_givens(*args)

    monkeypatch.setattr(ck, "arnoldi_givens", counted)
    s = torch.tensor([1.0, 0.5, 0.1])[:, None, None, None]

    def matvec(u):
        p = F.pad(u, (1, 1, 1, 1))
        return (4.0 + s) * u - (p[..., :-2, 1:-1] + p[..., 2:, 1:-1] + p[..., 1:-1, :-2]
                                + p[..., 1:-1, 2:])

    b = torch.randn(3, 3, 9, 11, generator=torch.Generator().manual_seed(3))
    observability.reset()
    res = krylov.fgmres(matvec, b, rtol=1e-5, restart=4, max_iterations=200)
    assert res.converged.all() and (res.iterations > 4).all()
    assert len(seen) * 3 == observability.counts()["krylov/slot_columns"]
    assert set(seen) == {((3, 5, 4), torch.float64, 200)}


def test_arnoldi_givens_checks_its_operands():
    """Shapes and dtypes the kernel would not take raise on the CPU too (the
    plain version checks them)."""
    t = _tensors(_state(3, 4, torch.float32, torch.float64, seed=1, special=False))
    for name, bad in (("R", t["R"][:, :4]), ("rot0", t["rot0"][:, :3]), ("g", t["g"].double()),
                      ("j", t["j"].int()), ("act", t["act"][:2]), ("tol", t["tol"].float()),
                      ("k_cycle", t["k_cycle"].long()), ("hh", t["hh"][:, :, :4])):
        with pytest.raises(ValueError):
            _call(ck.arnoldi_givens, {**t, name: bad})


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,m", [(1, 32), (2, 32), (20, 32), (49, 32), (49, 64), (12, 64)])
@pytest.mark.parametrize("dtype,acc", TYPES)
def test_kernel_matches_its_plain_version_bit_for_bit(B, m, dtype, acc):
    """Random states (pairs at random columns, a fifth inactive), the ten
    special pairs where B >= 10, and the state after each of m + 1 column
    steps run on both (j walking to m): every output and every buffer the
    same bits."""
    dev = _cuda()
    st = _state(B, m, dtype, acc, seed=B + m, special=B >= 10)
    if B < 10:  # columns from the first on
        st["j"][0], st["act"][0] = 0, True
    kern, plain = _tensors(st, dev), _tensors(st, dev)
    for step in range(m + 1):
        launches, calls = ck.ARN_LAUNCHES, ck.ARN_PLAIN_CALLS
        got = _call(ck.arnoldi_givens, kern)
        assert (ck.ARN_LAUNCHES - launches, ck.ARN_PLAIN_CALLS - calls) == (1, 0)
        want = _call(ck.arnoldi_givens_ref, plain)
        torch.cuda.synchronize()
        _assert_same(dict(zip(OUTPUTS, got)), dict(zip(OUTPUTS, want)))
        _assert_same({k: kern[k] for k in BUFFERS}, {k: plain[k] for k in BUFFERS})
        # the next column: fresh dots, the same state
        gen = torch.Generator(dev).manual_seed(step)
        fresh = torch.randn(kern["hh"].shape, generator=gen, device=dev, dtype=torch.float64)
        for t in (kern, plain):
            t["hh"] = fresh.to(acc)
    assert kern["j"].max().item() <= m


@pytest.mark.gpu
def test_kernel_launches_are_exact_under_replay():
    """The bookkeeping captured as a Krylov step is (``krylov._Step``) and
    replayed: one launch counted a replay, no plain call, and the bits of
    the same steps run on the plain version."""
    dev = _cuda()
    st = _state(20, 32, torch.float32, torch.float64, seed=3)
    kern, plain = _tensors(st, dev), _tensors(st, dev)
    step = krylov._Step(lambda: _call(ck.arnoldi_givens, kern), dev)
    step()  # runs once, then captures
    assert step.graph is not None and step.counts == {"ARN_LAUNCHES": 1}
    before = ck.ARN_LAUNCHES, ck.ARN_PLAIN_CALLS
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    assert (ck.ARN_LAUNCHES - before[0], ck.ARN_PLAIN_CALLS - before[1]) == (3, 0)
    for _ in range(4):
        _call(ck.arnoldi_givens_ref, plain)
    _assert_same({k: kern[k] for k in BUFFERS}, {k: plain[k] for k in BUFFERS})


@pytest.mark.gpu
def test_arnoldi_givens_raises_instead_of_falling_back():
    """On CUDA tensors: a (storage, accumulation) pair the kernel does not
    take, a restart past 64, a non-contiguous buffer or operands on two
    devices raise; nothing runs the plain version."""
    dev = _cuda()
    t = _tensors(_state(3, 8, torch.float32, torch.float64, seed=2, special=False), dev)
    big = _tensors(_state(2, 65, torch.float32, torch.float64, seed=2, special=False), dev)
    plain = ck.ARN_PLAIN_CALLS
    with pytest.raises(TypeError):
        _call(ck.arnoldi_givens, {**t, "hh": t["hh"].float(), "norms": t["norms"].float(),
                                  "tol": t["tol"].float(), "R": t["R"].double(),
                                  "rot0": t["rot0"].double(), "rot1": t["rot1"].double(),
                                  "g": t["g"].double(), "est": t["est"].double(),
                                  "rmax": t["rmax"].double()})
    with pytest.raises(ValueError):
        _call(ck.arnoldi_givens, big)
    with pytest.raises(ValueError):
        _call(ck.arnoldi_givens, {**t, "R": t["R"].transpose(0, 1).contiguous().transpose(0, 1)})
    with pytest.raises(ValueError):
        _call(ck.arnoldi_givens, {**t, "j": t["j"].cpu()})
    assert ck.ARN_PLAIN_CALLS == plain


def _blob_pairs(dev, B):
    from opticalflow_tpu_torch.core.synth import make_translating_blob_movie

    movie, _ = make_translating_blob_movie(n_frames=2, dimension=40, width=20.0, sigma=3.0,
                                           v_x=0.15, v_y=0.1)
    movie = torch.from_numpy((movie * 100.0).astype(np.float32)).to(dev)
    return movie[:1].expand(B, 40, 40), movie[1:].expand(B, 40, 40)


def _solve_both_ways(monkeypatch, prev, cur, a_s, a_r, **kw):
    """``solve_frame_pair`` with FGMRES twice: on B8, then with the plain
    bookkeeping patched in.  Returns both runs' (u, info, the KrylovResult
    and krylov/compactions of every FGMRES call, the column steps, B8's
    launches, plain calls)."""
    from opticalflow_tpu_torch.flow import variational
    from opticalflow_tpu_torch.utils import observability

    fgmres, calls, steps = krylov.fgmres, [], [0]

    class Counted(krylov._Step):
        def __call__(self):
            steps[0] += 1
            super().__call__()

    def recorded(*args, **kwargs):
        before = observability.counts().get("krylov/compactions", 0)
        res = fgmres(*args, **kwargs)
        calls.append((res, observability.counts().get("krylov/compactions", 0) - before))
        return res

    monkeypatch.setattr(krylov, "_Step", Counted)
    monkeypatch.setattr(krylov, "fgmres", recorded)
    runs = []
    for bookkeeping in (ck.arnoldi_givens, ck.arnoldi_givens_ref):
        monkeypatch.setattr(ck, "arnoldi_givens", bookkeeping)
        calls.clear()
        steps[0] = 0
        launches, plain = ck.ARN_LAUNCHES, ck.ARN_PLAIN_CALLS
        u0 = torch.zeros(3, 40, 40, device=prev.device)
        u, info = variational.solve_frame_pair(prev, cur, u0, a_s, a_r, method="gmres", **kw)
        torch.cuda.synchronize()
        runs.append((u, info, list(calls), steps[0], ck.ARN_LAUNCHES - launches,
                     ck.ARN_PLAIN_CALLS - plain))
    return runs


def _assert_same_solves(runs):
    (u, info, calls, steps, launches, plain), (u_p, info_p, calls_p, steps_p, _, _) = runs
    assert launches == steps == steps_p and plain == 0 and steps > 0
    assert len(calls) == len(calls_p) > 1  # the main and the correction solves
    for (res, compactions), (res_p, compactions_p) in zip(calls, calls_p):
        assert compactions == compactions_p
        for field in krylov.KrylovResult._fields:
            assert torch.equal(getattr(res, field), getattr(res_p, field)), field
    assert torch.equal(u, u_p)
    for key in info:
        assert torch.equal(info[key], info_p[key]), key


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 49])
def test_fgmres_on_b8_is_the_plain_bookkeeping_bit_for_bit(B, monkeypatch):
    """A main solve (restart 32) at one pair and at 49 pairs of regularisation
    weights spread over four decades, and its correction solves."""
    dev = _cuda()
    prev, cur = _blob_pairs(dev, B)
    a_s = torch.logspace(2, 5, B, device=dev) if B > 1 else torch.tensor([1000.0], device=dev)
    a_r = torch.logspace(4, 1, B, device=dev) if B > 1 else torch.tensor([1000.0], device=dev)
    _assert_same_solves(_solve_both_ways(monkeypatch, prev, cur, a_s, a_r))


@pytest.mark.gpu
def test_fgmres_on_b8_keeps_the_bits_where_correction_solves_narrow(monkeypatch):
    """Four pairs that stop apart at restart 4: the correction solves narrow
    their columns (``krylov/compactions``), and every Krylov call still
    gives the plain bookkeeping's bits."""
    dev = _cuda()
    prev, cur = _blob_pairs(dev, 4)
    a_s = torch.tensor([100.0, 300.0, 3000.0, 1e5], device=dev)
    a_r = torch.tensor([300.0, 1000.0, 100.0, 1e5], device=dev)
    runs = _solve_both_ways(monkeypatch, prev, cur, a_s, a_r, gmres_restart=4)
    assert any(compactions for _, compactions in runs[0][2][1:]), runs[0][2]
    _assert_same_solves(runs)
    assert math.isfinite(runs[0][0].abs().max().item())
