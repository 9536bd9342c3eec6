"""Double-float (compensated f32) arithmetic building blocks.

Error-free transformations (Knuth two-sum, Dekker split/two-prod) on pairs
(hi, lo) of f32 values give ~49 mantissa bits; the refinement residual of
the driver runs on them (parallel/driver.py).

The transforms require every intermediate product and sum to be rounded to
the working precision. Eager PyTorch runs each operation as its own kernel,
so nothing fuses a·b + c into one FMA; the JAX package needs optimization
barriers for the same guarantee. Do not ``torch.compile`` these functions:
a fusing compiler may contract them and silently fall back to f32 accuracy.
"""

from __future__ import annotations


def two_sum(a, b):
    """Error-free a+b: returns (s, err) with s+err == a+b exactly."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _split(a):
    """Dekker split: a = hi + lo with hi, lo having ≤12 significant bits."""
    c = 4097.0 * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free a*b: returns (p, err) with p+err == a*b exactly (f32)."""
    p = a * b
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    err = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, err


def df_add(x, y):
    """(hi,lo) + (hi,lo) -> (hi,lo)."""
    xh, xl = x
    yh, yl = y
    s, e = two_sum(xh, yh)
    e = e + xl + yl
    hi, lo = two_sum(s, e)
    return hi, lo
