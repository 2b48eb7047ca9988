"""The one account of each kernel's work (utils/cuda_timing.py) held to
fixed values: the bound of one launch of B1-B8 at the shapes the port's
paths launch, in microseconds (B7: milliseconds), and whether bytes or
operations set it.  chip_smoke.py's ``bound_ms`` and the kernel A/B's
bounds are these numbers; PERF.md's table of kernels quotes them.

Plain arithmetic on the card's data-sheet rates, so it runs on the CPU.
Tolerance: rel 1e-9, the values' ten printed digits.
"""

from torch_threads import one_intra_op_thread  # noqa: F401,I001 (autouse; first: see its module)

import pytest

from opticalflow_tpu_torch.utils import cuda_timing as ct

GS_N = 3 * 510 * 510  # B7's length at the two-pass cell's 512x512 pairs
MG_KINDS_150_63 = [  # B5 and B6 at the sweep's level 1: 150 cells of 63x63
    ("sweep", 70.37570150), ("zero guess", 10.66298507), ("fine", 14.92817910),
    ("apply", 61.84531343), ("residual-restrict", 62.39552239),
    ("restrict S x", 60.26292537), ("restrict y", 2.682805970), ("restrict b - y", 4.815402985),
    ("prolong", 2.682805970), ("prolong-add", 4.815402985),
    ("sweep-residual-restrict", 70.92591045), ("prolong-add-sweep", 70.92591045)]


def _bound_us(work):
    seconds, by = ct.bound(*work)
    return seconds * 1e6, by


def _bytes_ms(nbytes):
    seconds, by = ct.bound(nbytes, 0)
    return seconds * 1e3, by


CASES = [  # (id, thunk giving (value, bound_by), expected value, expected bound_by)
    ("B1 11 x 254^2 K=1", lambda: _bound_us(ct.el_matvec_work(11, 1, 254, 254)),
     5.945043582, "bytes"),
    ("B1 11 x 254^2 K=27", lambda: _bound_us(ct.el_matvec_work(11, 27, 254, 254)),
     138.1354388, "bytes"),
    ("B3 1022^2 one tile", lambda: _bound_us(ct.el_matvec_work(1, 1, 1022, 1022)),
     8.734903881, "bytes"),
    ("B3 1022^2 2 x 2 windows", lambda: _bound_us(ct.el_matvec_work(4, 1, 511, 511)),
     8.739806567, "bytes"),
    ("B3 511^2 tile with halo lines", lambda: _bound_us(ct.el_matvec_work(1, 1, 511, 511, True)),
     2.192287761, "bytes"),
    ("B4 11 x 254^2 operator P=24", lambda: _bound_us(ct.df32_work(11, 254, 254, 24, False)),
     25.42130866, "bytes"),
    ("B4 11 x 254^2 residual P=26", lambda: _bound_us(ct.df32_work(11, 254, 254, 26, True)),
     34.74242627, "bytes"),
    ("B4 11 x 254^2 issue ceiling",
     lambda: (ct.issue_ceiling(ct.df32_work(11, 254, 254, 24, False)[1]) * 1e6, "operations"),
     26.48044776, "operations"),
    *[(f"B5/B6 {kind} 150 x 63^2", lambda kind=kind: _bound_us(ct.mg_work(kind, 150, 1, 63, 63)),
       us, "bytes") for kind, us in MG_KINDS_150_63],
    ("B5 apply 11 x 127^2 K=27", lambda: _bound_us(ct.mg_work("apply", 11, 27, 127, 127)),
     51.47799045, "bytes"),
    ("B7 column 49 pairs rows 32 once",
     lambda: _bytes_ms(ct.gram_schmidt_work(49, GS_N, 32)[0]), 1.552214687, "bytes"),
    ("B7 column 49 pairs rows 32 three passes",
     lambda: _bytes_ms(ct.gram_schmidt_work(49, GS_N, 32)[1]), 4.610990687, "bytes"),
    ("B7 column 49 pairs rows 1 once",
     lambda: _bytes_ms(ct.gram_schmidt_work(49, GS_N, 1)[0]), 0.1369601194, "bytes"),
    ("B7 column 49 pairs rows 1 three passes",
     lambda: _bytes_ms(ct.gram_schmidt_work(49, GS_N, 1)[1]), 0.3652269851, "bytes"),
    ("B7 column 1 pair rows 32 once",
     lambda: _bytes_ms(ct.gram_schmidt_work(1, GS_N, 32)[0]), 0.03167785075, "bytes"),
    ("B7 column 1 pair rows 32 three passes",
     lambda: _bytes_ms(ct.gram_schmidt_work(1, GS_N, 32)[1]), 0.09410185075, "bytes"),
    ("B7 update 49 pairs rows 31",
     lambda: _bytes_ms(ct.gram_schmidt_work(49, GS_N, 31, False)[0]), 1.506561313, "bytes"),
    ("B8 49 pairs restart 32 column 31", lambda: _bound_us(ct.arnoldi_givens_work(49, 33, 31)),
     0.01848835821, "bytes"),
    ("B8 20 pairs restart 32 column 0", lambda: _bound_us(ct.arnoldi_givens_work(20, 33, 0)),
     0.004585074627, "bytes"),
    ("B8 1 pair restart 64 column 63", lambda: _bound_us(ct.arnoldi_givens_work(1, 65, 63)),
     0.0007211940299, "bytes"),
    # the conversion itself: one second of each rate, a tie going to bytes
    ("one second of operations", lambda: ct.bound(0, int(ct.F32_FLOPS_PER_S)), 1.0, "operations"),
    ("a tie", lambda: ct.bound(int(ct.HBM_BYTES_PER_S), int(ct.F32_FLOPS_PER_S)), 1.0, "bytes"),
]


@pytest.mark.parametrize("case, expected, by", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_kernel_bound_keeps_its_value(case, expected, by):
    value, bound_by = case()
    assert value == pytest.approx(expected, rel=1e-9)
    assert bound_by == by
