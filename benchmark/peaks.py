"""Published peaks of the cards the benchmark runs on, keyed by
``torch.cuda.get_device_name()``: NVIDIA's H100 SXM data sheet, dense
rates without sparsity, at the full 700 W power limit."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "int8_ops_per_s": 1978.9e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peak(kind: str, name: str):
    """The peak ``name`` of the card ``kind``, or ``None`` for a card the
    table does not hold."""
    return PEAKS.get(kind, {}).get(name)
