"""Double-float ("df32") compensated arithmetic for residual evaluation.

Counterpart of ``opticalflow_tpu.ops.df32``: the classical error-free
transforms (Dekker 1971, Knuth TAOCP v2) and head/tail pair arithmetic.
They are exact only if every operation is rounded on its own, which eager
PyTorch guarantees (one kernel per operation, no reassociation, no
contraction into fused multiply-adds).  Do not ``torch.compile`` these or
fuse them into a kernel without keeping that property.  The one place they
are fused is kernel B4 (``csrc/el_df32.cu``, the refinement's residual and
operator on the card), whose source is built with ``-fmad=false``, no fast
math and no flush-to-zero, and equals these functions bit for bit.

A value is carried as a pair ``(hi, lo)`` with |lo| <= ulp(hi)/2; the split
constant follows the dtype, so float64 inputs give double-double.
"""

from __future__ import annotations

from typing import Tuple

import torch

Pair = Tuple[torch.Tensor, torch.Tensor]


def _split_constant(dtype) -> float:
    # 2^ceil(p/2) + 1 where p = significand bits (24 for f32, 53 for f64)
    if dtype == torch.float64:
        return float(2**27 + 1)
    return float(2**12 + 1)


def two_sum(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """Knuth two-sum: s = fl(a+b), e = exact error, for any a, b."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """Dekker fast-two-sum; requires |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a: torch.Tensor) -> Pair:
    """Dekker split of a into hi + lo with half-width significands."""
    c = _split_constant(a.dtype) * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """p = fl(a*b), e = exact error: a*b = p + e."""
    p = a * b
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def df_add_f(acc: Pair, x: torch.Tensor) -> Pair:
    """acc + plain float x (growing accumulator)."""
    hi, lo = acc
    s, e = two_sum(hi, x)
    return s, lo + e


def df_add_prod(acc: Pair, a: torch.Tensor, b: torch.Tensor) -> Pair:
    """acc + a * b with the product's rounding error captured exactly."""
    p, e = two_prod(a, b)
    hi, lo = acc
    s, e2 = two_sum(hi, p)
    return s, lo + (e + e2)


def df_neg(acc: Pair) -> Pair:
    return -acc[0], -acc[1]


def df_result(acc: Pair) -> torch.Tensor:
    """Round the pair to a single float."""
    return acc[0] + acc[1]


def df_from(a: torch.Tensor) -> Pair:
    return a, torch.zeros_like(a)


def df_renorm(hi: torch.Tensor, lo: torch.Tensor) -> Pair:
    return fast_two_sum(hi, lo)


def df_add(x: Pair, y: Pair) -> Pair:
    """Pair + pair (Dekker add2, ~eps^2 relative error)."""
    s, e = two_sum(x[0], y[0])
    e = e + (x[1] + y[1])
    return fast_two_sum(s, e)


def df_add_pf(x: Pair, a: torch.Tensor) -> Pair:
    """Pair + plain float."""
    s, e = two_sum(x[0], a)
    return fast_two_sum(s, e + x[1])


def df_sub(x: Pair, y: Pair) -> Pair:
    return df_add(x, df_neg(y))


def df_mul(x: Pair, y: Pair) -> Pair:
    """Pair * pair (~eps^2 relative error)."""
    p, e = two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return fast_two_sum(p, e)


def df_mul_f(x: Pair, a: torch.Tensor) -> Pair:
    """Pair * plain float (a's value taken exactly)."""
    p, e = two_prod(x[0], a)
    return fast_two_sum(p, e + x[1] * a)


def df_scale_pow2(x: Pair, c: float) -> Pair:
    """Pair * a power of two (exact)."""
    return x[0] * c, x[1] * c


def df_div_f(a: torch.Tensor, s: torch.Tensor) -> Pair:
    """Plain / plain as a pair: q + rem/s, the remainder via an exact
    product."""
    q = a / s
    p, e = two_prod(q, s)
    rem = (a - p) - e
    return fast_two_sum(q, rem / s)


def df_div(x: Pair, s: torch.Tensor) -> Pair:
    """Pair / plain float."""
    q = x[0] / s
    p, e = two_prod(q, s)
    rem = ((x[0] - p) - e) + x[1]
    return fast_two_sum(q, rem / s)
