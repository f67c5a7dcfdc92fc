"""fqtk-tpu-torch: the PyTorch / CUDA port of fqtk-tpu.

A second package beside ``fqtk_tpu``: the same FASTQ demultiplexing, with
the device side of ``demux`` in PyTorch and its barcode-matcher kernel
written by hand in CUDA C++ for Hopper (``sm_90a``).  ``fqtk_tpu`` stays
the reference and is never imported: the host side (the binding of the
native C++ I/O engine, read structures, sample metadata, the NumPy spec,
metrics, subsample, the shard merge) is this package's own copy, under the
JAX package's module names.

Layers:

- ``fqtk_tpu_torch.core``     — encoding, read structures, samples, headers.
- ``fqtk_tpu_torch.io``       — the ctypes binding of ``native/fqtk_io.cpp``
                                and the Python FASTQ / BGZF code.
- ``fqtk_tpu_torch.ops``      — device compute: bit2 unpacking, the NumPy
                                spec, the top-2 merge, the kernel plan, the
                                Hopper kernels ``colmerge_top2`` and
                                ``tile_top2`` with their plain PyTorch
                                versions, the lab's kernels.
- ``fqtk_tpu_torch.runtime``  — the demux pipeline with its native loop;
                                subsample.
- ``fqtk_tpu_torch.parallel`` — the shard merge (``concat-shards``).
- ``fqtk_tpu_torch.lab``      — the big-K kernel lab.
- ``fqtk_tpu_torch.cli``      — flag-compatible command line
                                (``fqtk-tpu-torch``).

The package imports ``torch``, never ``jax`` and nothing of ``fqtk_tpu``.
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
