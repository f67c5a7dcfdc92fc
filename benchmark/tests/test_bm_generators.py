"""The traffic generators: the same seed gives the same inputs, and each
mix hits its stated shares."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import common
from benchmark.generators import barcodes, windows

CELLS8K = common.load_json(common.BENCH_DIR / "traffic/cells8k.json")
UNIFORM = common.load_json(common.BENCH_DIR / "traffic/uniform.json")
#: whitelist size of the window tests: background draws from it stay
#: distinct, as from the cells' 6,794,880
K = 1_000_000


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def test_seed_streams_take_large_seeds():
    a = common.seed_streams(2**40 + 3, 3)
    assert a == common.seed_streams(2**40 + 3, 3) and a != common.seed_streams(2**40 + 4, 3)
    assert all(0 <= s < 2**63 for s in a)


def test_whitelist_distinct_sorted_and_seeded():
    wl = barcodes.random_whitelist(20000, 16, _gen(1))
    assert wl.shape == (20000, 16) and wl.dtype == torch.uint8
    keys = [bytes(r) for r in barcodes.ascii_of_codes(wl.numpy())]
    assert keys == sorted(keys) and len(set(keys)) == len(keys)
    assert torch.equal(wl, barcodes.random_whitelist(20000, 16, _gen(1)))
    assert not torch.equal(wl, barcodes.random_whitelist(20000, 16, _gen(2)))
    strings = barcodes.strings_of_ascii(barcodes.ascii_of_codes(wl[:3].numpy()))
    assert [s.encode() for s in strings] == keys[:3]


def _window_keys(pool):
    return pool.view(np.uint32).reshape(pool.shape[0], -1).astype(np.int64)


@pytest.fixture(scope="module")
def whitelist():
    return barcodes.random_whitelist(K, 16, _gen(11))


@pytest.fixture(scope="module")
def cells_pool(whitelist):
    return windows.make_pool(whitelist, CELLS8K, 6, _gen(12))


def test_windows_seeded(whitelist, cells_pool):
    again = windows.make_pool(whitelist, CELLS8K, 6, _gen(12))
    np.testing.assert_array_equal(cells_pool, again)
    assert not np.array_equal(windows.make_pool(whitelist, CELLS8K, 6, _gen(13)), cells_pool)
    assert cells_pool.shape == (6, 131072, 4)


def test_cells8k_shares_and_dedup_bucket(whitelist, cells_pool):
    shifts = 2 * torch.arange(16, dtype=torch.int64)
    wl_keys = (whitelist.long() << shifts).sum(1).numpy()
    g = _gen(12)
    cells = torch.randperm(K, generator=g)[:CELLS8K["cells"]].numpy()
    keys = _window_keys(cells_pool)
    in_list = np.isin(keys, wl_keys)
    in_cells = np.isin(keys, wl_keys[cells])
    # substitutions leave the list (but for the rare landing on a neighbour)
    assert abs(1 - in_list.mean() - CELLS8K["substitution_share"]) < 0.003
    # 93% from the cells, 7% background drawn over the whole list
    share = in_cells.sum() / in_list.sum()
    assert abs(share - CELLS8K["cell_share"] - (1 - CELLS8K["cell_share"]) * 8000 / K) < 0.004
    # about 8,000 + 9,175 + 6,554 distinct rows: under the 32,768 bucket
    # with room, and under half the window, so the dedup engages
    distinct = [len(np.unique(w)) for w in keys]
    assert all(21000 < d < 26500 for d in distinct), distinct


def test_uniform_defeats_the_dedup(whitelist):
    pool = windows.make_pool(whitelist, UNIFORM, 2, _gen(14))
    distinct = [len(np.unique(w)) for w in _window_keys(pool)]
    assert all(d > 65536 for d in distinct), distinct


def test_pool_size_follows_the_rate():
    want = np.ceil(CELLS8K["pool_reads_per_s"] * 30 / CELLS8K["window_reads"])
    assert windows.pool_windows(CELLS8K, 30) == int(want) + CELLS8K["warmup_windows"]
