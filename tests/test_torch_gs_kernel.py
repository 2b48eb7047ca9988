"""Kernel B7, FGMRES's Gram-Schmidt (CGS2) and solution update
(``csrc/krylov_gs.cu``; wrappers ``cuda_kernels.gram_schmidt`` and
``basis_update``), and the FGMRES that stores its bases in the field dtype.

On the CPU: the plain versions equal, bit for bit, the arithmetic FGMRES
ran before its bases were stored in the field dtype (``torch.bmm`` on V and
Z held in the accumulation dtype), for float32 and float64 fields, with and
without float64 reductions, at per-pair columns 0, a middle one and the
last, some pairs inactive; rows past a pair's column (V) or its columns
used (Z) are never read (NaN there changes no bit); ``fgmres`` hands both
wrappers bases of ``b``'s dtype.

On the card (marked ``gpu``, skipped here; this file imports no JAX:
``python -m pytest tests/test_torch_gs_kernel.py -m gpu --noconftest``):
the kernel against the plain version computed in float64, at the two-pass
cell's N = 3 x 510^2 for 1 and 3 pairs, at a 1022^2 pair, and at small
shapes for every row count it is built for, in each (storage,
accumulation) pair it takes.  The bound is the rounding the kernel's own
sums may add, propagated through the three passes: a sum of d terms in
order carries at most gamma_d = d u / (1 - d u) of the sum of the terms'
magnitudes (u the unit roundoff of the accumulation dtype, d the depth of
the kernel's sums: a thread's elements, the warp's five shuffle levels, the
eight warps, a lane's chunks and five more levels; R terms for a
projection), each cast to the field dtype and each subtraction rounds by u
of its field dtype, and the float64 reference carries gamma_N of its own;
held with a factor 2 for the second-order terms.  Rows past the column
filled with NaN give the same bits; two launches give the same bits; a
column captured in a CUDA graph counts six launches per replay.
"""

from torch_threads import one_intra_op_thread  # noqa: F401,I001 (autouse; first: see its module)

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from opticalflow_tpu_torch.ops import cuda_kernels as ck
from opticalflow_tpu_torch.solve import krylov

FIELD_ACC = [(torch.float32, True), (torch.float32, False), (torch.float64, True),
             (torch.float64, False)]


def _basis(B, R, N, j, dtype, device, seed, past=0.0):
    """V (B, R, N) of ``dtype``: rows 0..j[b] of each pair orthonormal (in
    float64, then cast), the rows past j[b] ``past``; and w (B, N)."""
    gen = torch.Generator(device).manual_seed(seed)
    q = torch.linalg.qr(torch.randn(B, N, R, generator=gen, device=device,
                                    dtype=torch.float64))[0]
    V = q.transpose(1, 2).to(dtype).contiguous()
    for b in range(B):
        V[b, int(j[b]) + 1:] = past
    w = (torch.randn(B, N, generator=gen, device=device, dtype=torch.float64) * 3.0).to(dtype)
    return V, w


def _column_as_before(V, w, acc):
    """The Arnoldi column's products as ``fgmres`` computed them with V
    stored in the accumulation dtype (every row, the unwritten ones zero)."""
    V = V.to(acc)
    dt = w.dtype
    w_entry = (w.to(acc) * w.to(acc)).flatten(1).sum(dim=1)
    h1 = torch.bmm(V, w.to(acc)[:, :, None])
    w = w - torch.bmm(V.transpose(1, 2), h1)[..., 0].to(dt)
    h2 = torch.bmm(V, w.to(acc)[:, :, None])
    w = w - torch.bmm(V.transpose(1, 2), h2)[..., 0].to(dt)
    hj1 = (w.to(acc) * w.to(acc)).flatten(1).sum(dim=1)
    return w, torch.stack([h1[..., 0], h2[..., 0]], dim=1), torch.stack([w_entry, hj1], dim=1)


def _assert_bits(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype,high_precision", FIELD_ACC)
def test_gram_schmidt_plain_version_is_the_arithmetic_before(dtype, high_precision):
    """Pairs at column 0, a middle one and the last (m = 8), one inactive:
    the plain version's w, h and norms are the bits of the products on V
    held in the accumulation dtype; NaN past each column changes none."""
    acc = krylov.acc_dtype(dtype, high_precision)
    j = torch.tensor([0, 4, 8, 6])
    act = torch.tensor([True, True, True, False])
    V, w = _basis(4, 9, 517, j, dtype, "cpu", seed=1)
    calls = ck.GS_PLAIN_CALLS
    out = ck.gram_schmidt(V, w, j, act, acc)
    assert ck.GS_PLAIN_CALLS == calls + 1
    assert [t.dtype for t in out] == [dtype, acc, acc]
    assert out[1].shape == (4, 2, 9) and out[2].shape == (4, 2)
    _assert_bits(out, _column_as_before(V, w, acc))
    assert (out[1][0, :, 1:] == 0).all() and (out[1][1, :, 5:] == 0).all()
    V_nan, _ = _basis(4, 9, 517, j, dtype, "cpu", seed=1, past=math.nan)
    _assert_bits(ck.gram_schmidt(V_nan, w, j, act, acc), out)


@pytest.mark.parametrize("dtype,high_precision", FIELD_ACC)
def test_basis_update_plain_version_reads_only_the_columns_used(dtype, high_precision):
    """x + sum_{i < cols} y_i Z_i at cols 0, 3 and m = 8: the bits of the
    product on all of Z held in the accumulation dtype with y zero from
    cols on, and the same bits with NaN in Z's rows from cols on."""
    acc = krylov.acc_dtype(dtype, high_precision)
    gen = torch.Generator().manual_seed(2)
    B, m, N = 3, 8, 301
    cols = torch.tensor([0, 3, 8])
    used = torch.arange(m)[None, :] < cols[:, None]
    Z = torch.randn(B, m, N, generator=gen, dtype=torch.float64).to(dtype)
    y = torch.where(used, torch.randn(B, m, generator=gen, dtype=torch.float64).to(dtype), 0.0)
    x = torch.randn(B, N, generator=gen, dtype=torch.float64).to(dtype)
    before = x + torch.bmm(y.to(acc)[:, :, None].transpose(1, 2), Z.to(acc))[:, 0].to(dtype)
    calls = ck.GS_PLAIN_CALLS
    got = ck.basis_update(x, y, Z, cols, acc)
    assert ck.GS_PLAIN_CALLS == calls + 1
    assert got.dtype == dtype and torch.equal(got, before)
    assert torch.equal(got[0], x[0])
    Z_nan = torch.where(used[:, :, None], Z, math.nan)
    assert torch.equal(ck.basis_update(x, y, Z_nan, cols, acc), got)


@pytest.mark.parametrize("dtype,high_precision", [(torch.float32, True), (torch.float64, True)])
def test_fgmres_stores_its_bases_in_the_field_dtype(dtype, high_precision, monkeypatch):
    """A small FGMRES solve (restart 4, so it restarts) hands the
    Gram-Schmidt V (B, 5, N) and the update Z (B, 4, N) of ``b``'s dtype and
    the accumulation dtype of the call, and converges."""
    seen = []
    gram_schmidt, basis_update = ck.gram_schmidt, ck.basis_update

    def column(V, w, j, act, acc):
        seen.append(("V", V.dtype, tuple(V.shape), acc))
        return gram_schmidt(V, w, j, act, acc)

    def update(x, y, Z, cols, acc):
        seen.append(("Z", Z.dtype, tuple(Z.shape), acc))
        return basis_update(x, y, Z, cols, acc)

    monkeypatch.setattr(ck, "gram_schmidt", column)
    monkeypatch.setattr(ck, "basis_update", update)
    s = torch.tensor([1.0, 0.5], dtype=dtype)[:, None, None, None]

    def matvec(u):
        p = F.pad(u, (1, 1, 1, 1))
        return (4.0 + s) * u - (p[..., :-2, 1:-1] + p[..., 2:, 1:-1] + p[..., 1:-1, :-2]
                                + p[..., 1:-1, 2:])

    b = torch.randn(2, 3, 9, 11, generator=torch.Generator().manual_seed(3), dtype=dtype)
    res = krylov.fgmres(matvec, b, rtol=1e-5, restart=4, max_iterations=200,
                        high_precision_reductions=high_precision)
    assert res.converged.all() and (res.iterations > 4).all()
    acc = krylov.acc_dtype(dtype, high_precision)
    assert {entry[0] for entry in seen} == {"V", "Z"}
    for kind, stored, shape, summed in seen:
        assert stored == dtype and summed == acc
        assert shape == ((2, 5, 297) if kind == "V" else (2, 4, 297))


def test_gs_wrappers_check_their_operands():
    """Shapes, dtypes and index types the kernel would not take raise on
    the CPU too (the plain versions check them)."""
    V, w = torch.zeros(2, 5, 10), torch.zeros(2, 10)
    j, act = torch.zeros(2, dtype=torch.int64), torch.ones(2, dtype=torch.bool)
    with pytest.raises(ValueError):
        ck.gram_schmidt(V, w[:, :9], j, act, torch.float64)
    with pytest.raises(ValueError):
        ck.gram_schmidt(V, w.double(), j, act, torch.float64)
    with pytest.raises(ValueError):
        ck.gram_schmidt(V, w, j.int(), act, torch.float64)
    with pytest.raises(ValueError):
        ck.gram_schmidt(V, w, j, act[:1], torch.float64)
    with pytest.raises(ValueError):
        ck.basis_update(w, torch.zeros(2, 5), V, j[:1], torch.float64)
    with pytest.raises(ValueError):
        ck.basis_update(w, torch.zeros(2, 4), V, j, torch.float64)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

TYPES = [(torch.float32, torch.float64), (torch.float32, torch.float32),
         (torch.float64, torch.float64)]
# (B, R, N, j, act): the two-pass cell's 3 x 510^2 at 1 and 3 pairs (columns
# 0, the last of restart 32 and a middle one, one pair inactive), a 1022^2
# pair, and each row count B7 is built for (9, 33, 65) at small and odd N
GS_CASES = [(1, 33, 3 * 510 * 510, [31], [True]),
            (3, 33, 3 * 510 * 510, [0, 32, 16], [True, True, False]),
            (1, 33, 3 * 1022 * 1022, [20], [True]),
            (3, 9, 1001, [0, 4, 8], [True, False, True]),
            (2, 65, 4099, [63, 7], [True, True]),
            (2, 13, 777, [12, 3], [True, True])]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _gamma(d, dtype):
    u = torch.finfo(dtype).eps / 2
    return d * u / (1 - d * u)


def _sum_depth(B, N, device):
    """The longest chain of additions in the kernel's sum over a pair's N
    elements (the module docstring)."""
    C, L = ck.gs_chunks(B, N, device)
    return -(-L // ck.GS_THREADS) + 5 + 7 + -(-C // 32) + 5


def _column_bounds(V, w, j, ref, acc, depth):
    """Per-element bounds on |kernel - float64 reference| of w2, h and the
    norms (the module docstring): float64 on the card."""
    B, R, N = V.shape
    used = torch.arange(R, device=V.device)[None, :] <= j[:, None]
    Va = torch.where(used[:, :, None], V, 0).double().abs()
    Vt = Va.transpose(1, 2)
    w2, h, norms = ref
    w0 = w.double().abs()
    u_dt = torch.finfo(w.dtype).eps / 2
    g_sum = _gamma(depth, acc) + _gamma(N, torch.float64)
    g_row = _gamma(R, acc) + _gamma(R, torch.float64)

    def mv(M, v):
        return torch.bmm(M, v[:, :, None])[..., 0]

    h1, h2 = h[:, 0].abs(), h[:, 1].abs()
    dh1 = g_sum * mv(Va, w0)
    T1 = mv(Vt, h1)
    w1 = (w.double() - mv(V.double().transpose(1, 2) * used[:, None, :], h[:, 0])).abs()
    dw1 = u_dt * (w1 + T1) + g_row * T1 + mv(Vt, dh1)
    dh2 = g_sum * mv(Va, w1) + mv(Va, dw1)
    T2 = mv(Vt, h2)
    dw2 = dw1 + u_dt * (w2.abs() + T2) + g_row * T2 + mv(Vt, dh2)
    dn_in = g_sum * (w0 * w0).sum(1)
    dn_out = g_sum * (w2 * w2).sum(1) + (2 * w2.abs() * dw2 + dw2 * dw2).sum(1)
    return 2 * dw2, 2 * torch.stack([dh1, dh2], 1), 2 * torch.stack([dn_in, dn_out], 1)


@pytest.mark.gpu
@pytest.mark.parametrize("B,R,N,j,act", GS_CASES)
@pytest.mark.parametrize("dtype,acc", TYPES)
def test_gram_schmidt_kernel_matches_its_plain_version(B, R, N, j, act, dtype, acc):
    dev = _cuda()
    j = torch.tensor(j, device=dev)
    act = torch.tensor(act, device=dev)
    V, w = _basis(B, R, N, j.cpu(), dtype, dev, seed=B * R)
    launches, plain = ck.GS_LAUNCHES, ck.GS_PLAIN_CALLS
    got = ck.gram_schmidt(V, w, j, act, acc)
    again = ck.gram_schmidt(V, w, j, act, acc)
    torch.cuda.synchronize()
    assert (ck.GS_LAUNCHES - launches, ck.GS_PLAIN_CALLS - plain) == (12, 0)
    assert [t.dtype for t in got] == [dtype, acc, acc]
    _assert_bits(again, got)  # deterministic
    ref = ck.gram_schmidt_ref(V.double(), w.double(), j, act, torch.float64)
    bounds = _column_bounds(V, w, j, ref, acc, _sum_depth(B, N, dev))
    on = act.cpu().numpy()
    for name, g, r, bound in zip(("w", "h", "norms"), got, ref, bounds):
        err = (g.double() - r).abs()[act]
        assert (err <= bound[act]).all(), (name, (err / bound[act]).max().item())
    # an inactive pair: its w back, zero dots
    off = ~act
    assert torch.equal(got[0][off], w[off])
    assert (got[1][off] == 0).all() and (got[2][off] == 0).all()
    for b in np.flatnonzero(on):  # zero past the column
        assert (got[1][b, :, int(j[b]) + 1:] == 0).all()
    # rows past each column never read: NaN there, the same bits
    V_nan = V.clone()
    for b in range(B):
        V_nan[b, int(j[b]) + 1:] = math.nan
    _assert_bits(ck.gram_schmidt(V_nan, w, j, act, acc), got)


UPDATE_CASES = [(3, 32, 3 * 510 * 510, [0, 16, 32]), (1, 32, 3 * 1022 * 1022, [31]),
                (2, 8, 1001, [8, 3]), (2, 64, 4099, [64, 1])]


@pytest.mark.gpu
@pytest.mark.parametrize("B,m,N,cols", UPDATE_CASES)
@pytest.mark.parametrize("dtype,acc", TYPES)
def test_basis_update_kernel_matches_its_plain_version(B, m, N, cols, dtype, acc):
    """x + sum_{i < cols} y_i Z_i against the float64 plain version: within
    the cast to the field dtype and the rounding of an m-term sum
    (gamma_m of the accumulation dtype, and of float64 for the reference) of
    sum |y_i Z_i|, twice; NaN from cols on, the same bits."""
    dev = _cuda()
    gen = torch.Generator(dev).manual_seed(m)
    cols = torch.tensor(cols, device=dev)
    used = torch.arange(m, device=dev)[None, :] < cols[:, None]
    Z = torch.randn(B, m, N, generator=gen, device=dev, dtype=torch.float64).to(dtype)
    y = torch.where(used, torch.randn(B, m, generator=gen, device=dev,
                                      dtype=torch.float64).to(dtype), 0.0)
    x = torch.randn(B, N, generator=gen, device=dev, dtype=torch.float64).to(dtype)
    launches = ck.GS_LAUNCHES
    got = ck.basis_update(x, y, Z, cols, acc)
    torch.cuda.synchronize()
    assert ck.GS_LAUNCHES - launches == 1 and got.dtype == dtype
    ref = ck.basis_update_ref(x.double(), y.double(), Z.double(), cols, torch.float64)
    terms = torch.bmm(y.double().abs()[:, None, :], Z.double().abs())[:, 0]
    u_dt = torch.finfo(dtype).eps / 2
    bound = 2 * (u_dt * (ref.abs() + terms)
                 + (_gamma(m, acc) + _gamma(m, torch.float64)) * terms)
    assert ((got.double() - ref).abs() <= bound).all()
    Z_nan = torch.where(used[:, :, None], Z, math.nan)
    assert torch.equal(ck.basis_update(x, y, Z_nan, cols, acc), got)


@pytest.mark.gpu
def test_gs_launches_are_exact_under_replay():
    """A column captured as a Krylov step is (``krylov._Step``) and replayed
    three times: six launches counted a replay, no plain call, the bits of
    the column run without capture."""
    dev = _cuda()
    j = torch.tensor([3, 0], device=dev)
    act = torch.tensor([True, True], device=dev)
    V, w = _basis(2, 33, 40000, j.cpu(), torch.float32, dev, seed=7)
    outs = [torch.empty(2, 40000, device=dev), torch.empty(2, 2, 33, device=dev,
                                                           dtype=torch.float64),
            torch.empty(2, 2, device=dev, dtype=torch.float64)]

    def column():
        for buf, value in zip(outs, ck.gram_schmidt(V, w, j, act, torch.float64)):
            buf.copy_(value)

    step = krylov._Step(column, dev)
    step()  # runs once, then captures
    assert step.graph is not None and step.counts == {"GS_LAUNCHES": 6}
    before = ck.GS_LAUNCHES, ck.GS_PLAIN_CALLS
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    assert (ck.GS_LAUNCHES - before[0], ck.GS_PLAIN_CALLS - before[1]) == (18, 0)
    _assert_bits(outs, ck.gram_schmidt(V, w, j, act, torch.float64))


@pytest.mark.gpu
def test_gs_wrappers_raise_instead_of_falling_back():
    """On CUDA tensors: a (storage, accumulation) pair the kernel does not
    take, more rows than its largest instance, a non-contiguous basis or
    operands on two devices raise; nothing runs the plain version."""
    dev = _cuda()
    j = torch.zeros(2, dtype=torch.int64, device=dev)
    act = torch.ones(2, dtype=torch.bool, device=dev)
    V, w = torch.zeros(2, 5, 64, device=dev), torch.zeros(2, 64, device=dev)
    plain = ck.GS_PLAIN_CALLS
    with pytest.raises(TypeError):
        ck.gram_schmidt(V.double(), w.double(), j, act, torch.float32)
    with pytest.raises(TypeError):
        ck.gram_schmidt(V.half(), w.half(), j, act, torch.float32)
    with pytest.raises(ValueError):
        ck.gram_schmidt(torch.zeros(2, 66, 64, device=dev), w, j, act, torch.float64)
    with pytest.raises(ValueError):
        ck.gram_schmidt(torch.zeros(2, 64, 5, device=dev).transpose(1, 2), w, j, act,
                        torch.float64)
    with pytest.raises(ValueError):
        ck.gram_schmidt(V, w, j.cpu(), act, torch.float64)
    with pytest.raises(ValueError):
        ck.basis_update(w, torch.zeros(2, 5, device=dev), V, j.cpu(), torch.float64)
    assert ck.GS_PLAIN_CALLS == plain


@pytest.mark.gpu
def test_fgmres_on_the_card_runs_b7_on_float32_bases(monkeypatch):
    """The default configuration's FGMRES on the card (float32 fields,
    float64 reductions): the Gram-Schmidt gets a float32 V, the update a
    float32 Z, B7 launches and no plain version runs."""
    dev = _cuda()
    seen = []
    gram_schmidt = ck.gram_schmidt

    def column(V, w, j, act, acc):
        seen.append((V.dtype, acc))
        return gram_schmidt(V, w, j, act, acc)

    monkeypatch.setattr(ck, "gram_schmidt", column)
    s = torch.tensor([1.0, 0.5], device=dev)[:, None, None, None]

    def matvec(u):
        p = F.pad(u, (1, 1, 1, 1))
        return (4.0 + s) * u - (p[..., :-2, 1:-1] + p[..., 2:, 1:-1] + p[..., 1:-1, :-2]
                                + p[..., 1:-1, 2:])

    b = torch.randn(2, 3, 40, 50, device=dev, generator=torch.Generator(dev).manual_seed(3))
    launches, plain = ck.GS_LAUNCHES, ck.GS_PLAIN_CALLS
    res = krylov.fgmres(matvec, b, precond=lambda r: r / (4.0 + s), rtol=1e-5, restart=8,
                        max_iterations=300)
    assert res.converged.all()
    assert seen and set(seen) == {(torch.float32, torch.float64)}
    assert ck.GS_LAUNCHES > launches and ck.GS_PLAIN_CALLS == plain
