"""Each cell at its own size on the card: a short sound run is correct and
the control is not.  Run on the card with
``python -m pytest benchmark/tests -m gpu``; skips without one."""

from __future__ import annotations

import pytest

from benchmark import run
from benchmark.tests.cells import cells

CELLS = cells()


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    run._prepare_env(run.common.ROOT)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(card, cell):
    assert run.run_cell(cell, 2**31 + 7, 3.0, False)["correct"] is True


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_card(card, cell):
    assert run.run_cell(cell, 2**31 + 8, 3.0, False, control=True)["correct"] is False
