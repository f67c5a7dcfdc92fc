"""fqtk-tpu-torch: the PyTorch / CUDA port of fqtk-tpu.

A second package beside ``fqtk_tpu``: the same FASTQ demultiplexing, with
the device side of ``demux`` in PyTorch and its barcode-matcher kernel
written by hand in CUDA C++ for Hopper (``sm_90a``).  ``fqtk_tpu`` stays
the reference; the host side (native C++ I/O engine, read structures,
sample metadata, host matchers, metrics, subsample) is imported from it
unchanged, and none of that loads JAX.

Layers:

- ``fqtk_tpu_torch.ops``      — device compute: bit2 unpacking, the top-2
                                merge, the Hopper ``colmerge_top2`` kernel
                                with its plain PyTorch version.
- ``fqtk_tpu_torch.runtime``  — the device side of the demux pipeline and
                                its native driver loop.
- ``fqtk_tpu_torch.cli``      — flag-compatible command line
                                (``fqtk-tpu-torch``).

The package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"

#: public surface, lazy so that ``import fqtk_tpu_torch`` stays free of the
#: torch import cost (same pattern as ``fqtk_tpu/__init__.py``)
_LAZY = {
    "DemuxConfig": "fqtk_tpu_torch.runtime.demux",
    "run_demux": "fqtk_tpu_torch.runtime.demux",
    "make_hopper_assign_fn": "fqtk_tpu_torch.ops.hopper_matcher",
    "hopper_state_from_numpy": "fqtk_tpu_torch.ops.hopper_matcher",
}

__all__ = sorted(_LAZY) + ["__version__"]


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


def __dir__():
    return __all__
