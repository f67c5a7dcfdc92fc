"""The timing script of the two top-2 kernels
(``fqtk_tpu_torch/lab/time_top2.py``): each of its cases, built at a tiny K
and B, through the kernel's plain PyTorch version in the case's input form
(bit2 rows against a 4-class table, nib4 rows against a 16-class one),
equal to the JAX package's NumPy spec ``assign_batch_np`` (exact: the
outputs are integers).  On the card the script times the CUDA kernels on
the same cases; ``test_torch_kernels_gpu.py`` holds them to these plain
versions."""

import numpy as np
import pytest
import torch

from fqtk_tpu.core.encoding import ENCODE_LUT
from fqtk_tpu.ops.matcher import assign_batch_np
from fqtk_tpu_torch.lab import time_top2
from fqtk_tpu_torch.ops import hopper_matcher as hm
from fqtk_tpu_torch.ops.device_encoding import unpack_nib4


@pytest.mark.parametrize("shape", time_top2.SHAPES, ids=lambda s: time_top2.label(*s))
def test_case_plain_matches_spec(shape):
    name, k, length, b, classes = shape
    es, obs, rows = time_top2.case(min(k, 300), length, min(b, 257), classes)
    assert obs.shape == (min(b, 257), length) and set(np.unique(obs)) <= set(b"ACGT")
    state = hm.hopper_state_from_numpy(es, "cpu", name, classes=classes)
    kern = hm.ColmergeTop2() if name == "colmerge_top2" else hm.TileTop2()
    best, idx, nxt = kern(rows, state.table, es.count, length, classes)
    assert (kern.launches, kern.plain_calls) == (0, 1)
    s_idx, s_best, s_next = assign_batch_np(obs, es, 255, 0)  # every row passes the gates
    np.testing.assert_array_equal(best.numpy(), s_best)
    np.testing.assert_array_equal(idx.numpy(), np.where(s_idx < 0, es.count, s_idx))
    np.testing.assert_array_equal(nxt.numpy(), s_next)


def test_case_forms_hold_the_same_reads():
    """The 16-class case is the nib4 form of the bit2 case's reads."""
    es4, obs4, _ = time_top2.case(96, 16, 100, 4)
    es16, obs16, rows16 = time_top2.case(96, 16, 100, 16)
    np.testing.assert_array_equal(obs4, obs16)
    np.testing.assert_array_equal(es4.masks, es16.masks)
    np.testing.assert_array_equal(unpack_nib4(rows16, 16).numpy(), ENCODE_LUT[obs16])


def test_walk_info_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only refusal; the card's numbers are chip_smoke.py's")
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        hm.walk_info("colmerge_top2", 64)
    with pytest.raises(ValueError, match="no sliced walk"):
        hm.walk_info("colmerge_top2", 64, classes=8)
    with pytest.raises(ValueError, match="no sliced walk"):
        hm.walk_info("colmerge_top2", 32)  # KP 128: the main loop
