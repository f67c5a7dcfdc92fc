"""The repository's host measuring tools on the port, one module each under
the name of its counterpart in ``scripts/``: ``python -m
fqtk_tpu_torch.scripts.X`` for ``scripts/X.py``.  Each runs the port's
demux (:mod:`fqtk_tpu_torch.bench`, never the root ``bench.py``), takes
``--device {cuda,cpu}`` (default ``cuda``, which raises without a card)
and writes its record under ``build/fqtk_tpu_torch/``, never to a JSON
file at the repository's root."""
