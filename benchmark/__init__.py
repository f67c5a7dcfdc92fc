"""The benchmark of ``fqtk_tpu_torch`` on an NVIDIA GPU.

One run of one cell of ``BENCHMARK.json``::

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Every piece is found by the name ``BENCHMARK.json`` gives it: a
configuration is ``configs/<config>.json`` (which names its driver,
``drivers/<driver>.py``), a traffic mix is ``traffic/<traffic>.json``
(which names its generator, ``generators/<generator>.py``), a per-layer
metric is ``metrics/<metric>.py``.  A metric named ``<quantity>.<split>``
is that quantity with a bound or cell list of its own: its reader is
``metrics/<quantity>.py`` unless it has a file of its own, and an
end-to-end one reads its driver's ``<quantity>``.  The plain reference
that decides ``correct`` is ``reference/``; it imports nothing of the
program.
"""
