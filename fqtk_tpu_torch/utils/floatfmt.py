"""Rust/ryu-compatible f64 formatting for the metrics TSV.

The port's own copy of ``fqtk_tpu/utils/floatfmt.py`` (host code, no device library):
the two packages share no Python module.

The reference writes ``demux-metrics.txt`` via the ``csv`` crate, which
formats f64 with ``ryu`` (shortest round-trip representation).  Python's
``repr`` produces the same shortest digits but differs in notation at the
margins (e.g. ``1e-05`` vs ``0.00001``, ``inf`` vs ``inf``, ``nan`` vs
``NaN``).  This module converts Python floats to ryu-style strings:

- NaN -> ``NaN``; infinities -> ``inf`` / ``-inf``.
- positional notation for decimal exponents in [-5, 15], scientific
  (``1.5e-7``-style, no ``+`` and no zero-padded exponent) outside.
"""

from __future__ import annotations

import math
from decimal import Decimal


def format_f64(x: float) -> str:
    if math.isnan(x):
        return "NaN"
    if math.isinf(x):
        return "inf" if x > 0 else "-inf"
    if x == 0.0:
        return "-0.0" if math.copysign(1.0, x) < 0 else "0.0"
    s = repr(float(x))
    if "e" not in s and "E" not in s:
        return s
    # Python chose scientific notation; re-decide using ryu's thresholds.
    d = Decimal(s)
    sign, digits, exp = d.as_tuple()
    # decimal exponent of the leading digit
    lead_exp = exp + len(digits) - 1
    if -5 <= lead_exp <= 15:
        return _positional(sign, digits, exp)
    mant_str = str(digits[0])
    if len(digits) > 1:
        mant_str += "." + "".join(str(d) for d in digits[1:])
    out = f"{mant_str}e{lead_exp}"
    return "-" + out if sign else out


def _positional(sign: int, digits: tuple, exp: int) -> str:
    s = "".join(str(d) for d in digits)
    if exp >= 0:
        s = s + "0" * exp + ".0"
    elif -exp < len(s):
        s = s[:exp] + "." + s[exp:]
    else:
        s = "0." + "0" * (-exp - len(s)) + s
    return "-" + s if sign else s
