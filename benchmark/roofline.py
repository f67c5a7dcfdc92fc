"""The work of barcode matching, defined by the inputs whatever implements
it.  A window of ``u`` distinct rows against ``k`` barcodes of ``length``
bases needs ``u * k * length`` position comparisons; each is charged 8 int8
operations (a multiply-add, 2 operations, for each of the 4 one-hot
classes of a base).  Bytes: each distinct row (2 bits a base), the
whitelist (2 bits a base) and each row's int32 result, once."""

from __future__ import annotations

OPS_PER_COMPARISON = 8


def matcher_ops(u: int, k: int, length: int) -> float:
    return float(OPS_PER_COMPARISON) * u * k * length


def matcher_bytes(u: int, k: int, length: int) -> float:
    width = -(-length // 4)
    return float(u * width + k * width + u * 4)


def least_seconds(ops: float, nbytes: float, ops_per_s: float, bytes_per_s: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / ops_per_s, nbytes / bytes_per_s)
