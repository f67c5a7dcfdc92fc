"""The port's device mesh (``fqtk_tpu_torch.parallel.mesh``) on eight CPU
"devices" (``[cpu] * 8``, the counterpart of conftest's 8 fake JAX CPU
devices) against the JAX package's ``make_sharded_assign_fn`` on those 8
devices and the NumPy spec ``assign_batch_np``.  Mirrors
``tests/test_parallel.py``: layouts 8x1, 4x2, 2x4 and 1x8; bit2, nib4 and raw
bytes (``N`` in barcodes and reads); both routes (``use_kernels``: the Hopper
kernels' plain versions on the CPU, else the chunked scan), against the JAX
XLA route and, for a few cases, Pallas in interpret mode; K not divisible by
the shards, K = 3 over 8 shards, K = 1, odd B, a first-index tie across
shards, the whole whitelist's no-call budget, L = 300 through the scan.
Results are integers: every comparison is exact.  The same mesh on the card
is in ``test_torch_kernels_gpu.py``."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from fqtk_tpu.core.encoding import ENCODE_LUT
from fqtk_tpu.ops.matcher import ExpectedSet as JaxExpectedSet
from fqtk_tpu.ops.matcher import assign_batch_np
from fqtk_tpu.parallel import mesh as jax_mesh
from fqtk_tpu_torch.ops import hopper_matcher as hm
from fqtk_tpu_torch.ops.device_encoding import pack_bit2
from fqtk_tpu_torch.ops.matcher import ExpectedSet, make_assign_fn
from fqtk_tpu_torch.parallel import mesh

CPU8 = [torch.device("cpu")] * 8
LAYOUTS = [(8, 1), (4, 2), (2, 4), (1, 8)]
FORMS = ["bit2", "nib4", "bytes"]
ACGTN = np.frombuffer(b"ACGTN", dtype=np.uint8)


def nib4_of(obs_bytes):
    """Two 4-bit masks per byte, low nibble = even position."""
    masks = ENCODE_LUT[obs_bytes]
    b, length = masks.shape
    padded = np.zeros((b, length + length % 2), dtype=np.uint8)
    padded[:, :length] = masks
    return (padded[:, 0::2] | (padded[:, 1::2] << 4)).astype(np.uint8)


def rows_of(obs_bytes, form):
    if form == "bit2":
        return pack_bit2(obs_bytes)
    return nib4_of(obs_bytes) if form == "nib4" else obs_bytes


def flags(form):
    return dict(packed2=form == "bit2", packed_masks=form == "nib4")


def random_case(seed, k, length, b, form):
    """``tests/test_parallel.py``'s case: distinct barcodes over ACGTN,
    reads over ACGTN with every third a copy of a barcode; for bit2 the
    reads are pure ACGT (the engine resolves the others), the whitelist
    keeps its N."""
    rng = np.random.default_rng(seed)
    barcodes = set()
    while len(barcodes) < k:
        barcodes.add(bytes(rng.choice(ACGTN, size=length)).decode())
    barcodes = sorted(barcodes)
    obs = rng.choice(ACGTN, size=(b, length)).astype(np.uint8)
    for i in range(0, b, 3):
        obs[i] = np.frombuffer(barcodes[i % k].encode(), dtype=np.uint8)
    if form == "bit2":
        obs[obs == ord("N")] = ord("T")
    return barcodes, obs


def spec(obs, barcodes, mm, delta):
    idx, _, _ = assign_batch_np(obs, JaxExpectedSet.from_barcodes(barcodes), mm, delta)
    k = len(barcodes)
    assigned = np.where(idx < 0, k, idx)
    return assigned, np.bincount(assigned, minlength=k + 1)


def port(barcodes, rows, mm, delta, layout, form, **kw):
    m = mesh.make_demux_mesh(*layout, devices=CPU8)
    fn = mesh.make_sharded_assign_fn(ExpectedSet.from_barcodes(barcodes), mm, delta, m,
                                     **flags(form), **kw)
    assigned, counts = fn(rows)
    return fn, assigned.numpy(), counts.numpy()


_JAX = {}


def jax_run(barcodes, rows, mm, delta, layout, form, **kw):
    """The JAX mesh on conftest's 8 devices (XLA route unless ``kw`` asks
    for Pallas), cached per case."""
    key = (tuple(barcodes), rows.tobytes(), rows.shape, mm, delta, layout, form,
           tuple(sorted(kw.items())))
    if key not in _JAX:
        m = jax_mesh.make_demux_mesh(*layout)
        fn = jax_mesh.make_sharded_assign_fn(JaxExpectedSet.from_barcodes(barcodes), mm,
                                             delta, m, **flags(form), **kw)
        assigned, counts = fn(rows)
        _JAX[key] = (fn, np.asarray(assigned), np.asarray(counts))
    return _JAX[key]


def check(barcodes, obs, mm, delta, layout, form, use_kernels, k_chunk=16384):
    rows = rows_of(obs, form)
    fn, assigned, counts = port(barcodes, rows, mm, delta, layout, form,
                                use_kernels=use_kernels, k_chunk=k_chunk)
    want, want_counts = spec(obs, barcodes, mm, delta)
    np.testing.assert_array_equal(assigned, want)
    np.testing.assert_array_equal(counts, want_counts)
    jfn, j_assigned, j_counts = jax_run(barcodes, rows, mm, delta, layout, form,
                                        k_chunk=k_chunk)
    np.testing.assert_array_equal(assigned, j_assigned)
    np.testing.assert_array_equal(counts, j_counts)
    assert counts.dtype == np.int64
    return fn, jfn


def test_local_devices(monkeypatch):
    assert mesh.local_devices("cpu") == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert mesh.local_devices("cuda") == [torch.device("cuda", i) for i in range(3)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert mesh.local_devices("cuda") == []
    with pytest.raises(ValueError, match="cuda or cpu"):
        mesh.local_devices("meta")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        mesh.make_demux_mesh()  # the default devices are the card's


@pytest.mark.parametrize("n_batch,n_k", LAYOUTS)
def test_make_demux_mesh_layouts(n_batch, n_k):
    m = mesh.make_demux_mesh(n_batch=n_batch, n_whitelist=n_k, devices=CPU8)
    assert m.shape == {"batch": n_batch, "whitelist": n_k}
    assert m.shape == dict(jax_mesh.make_demux_mesh(n_batch, n_k).shape)
    assert mesh.make_demux_mesh(n_whitelist=n_k, devices=CPU8).shape == m.shape
    with pytest.raises(AssertionError):
        mesh.make_demux_mesh(n_batch=n_batch + 1, n_whitelist=n_k, devices=CPU8)
    with pytest.raises(AssertionError):
        mesh.make_demux_mesh(n_whitelist=3, devices=CPU8)


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernels", "scan"])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("n_batch,n_k", LAYOUTS)
def test_sharded_assign_matches_jax_and_spec(n_batch, n_k, form, use_kernels):
    barcodes, obs = random_case(0, k=23, length=9, b=64, form=form)
    fn, jfn = check(barcodes, obs, 1, 2, (n_batch, n_k), form, use_kernels, k_chunk=8)
    assert (fn.n_k_shards, fn.batch_multiple) == (n_k, n_batch)
    assert fn.use_kernels is use_kernels and fn.form == form
    assert fn.macs_per_row == jfn.macs_per_row  # the XLA route's dense count
    assert fn.scheme == ("colmerge_top2" if use_kernels else "xla_scan")
    tiles = n_batch * min(n_k, -(-23 // -(-23 // n_k)))
    if use_kernels:  # each tile launched once: plain versions here
        assert (fn.launches, fn.plain_calls, fn.calls) == (0, tiles, 0)
        assert fn.kernels["colmerge_top2"].plain_calls == tiles
    else:
        assert (fn.launches, fn.plain_calls, fn.calls) == (0, 0, tiles)


@pytest.mark.parametrize(
    "n_batch,n_k,form", [(4, 2, "bytes"), (2, 4, "bytes"), (1, 8, "nib4"), (2, 4, "bit2")]
)
def test_sharded_kernels_match_pallas_interpret(n_batch, n_k, form):
    """The kernels' route against the JAX mesh's per-shard Pallas kernel in
    interpret mode (``tests/test_parallel.py:91-148``), odd B."""
    barcodes, obs = random_case(7, k=23, length=9, b=50, form=form)
    rows = rows_of(obs, form)
    _, assigned, counts = port(barcodes, rows, 1, 2, (n_batch, n_k), form)
    jfn, j_assigned, j_counts = jax_run(barcodes, rows, 1, 2, (n_batch, n_k), form,
                                        use_pallas=True, interpret=True, tile_b=8,
                                        tile_k=128)
    assert jfn.use_pallas
    np.testing.assert_array_equal(assigned, j_assigned)
    np.testing.assert_array_equal(counts, j_counts)
    np.testing.assert_array_equal(assigned, spec(obs, barcodes, 1, 2)[0])


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernels", "scan"])
@pytest.mark.parametrize("form", FORMS)
def test_k_not_divisible_by_shards(form, use_kernels):
    """``test_sharded_assign_large_k_sharded``: K 101 over 4 shards."""
    barcodes, obs = random_case(1, k=101, length=8, b=32, form=form)
    fn, _ = check(barcodes, obs, 2, 1, (2, 4), form, use_kernels, k_chunk=16)
    assert fn.k_per_shard == 26


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernels", "scan"])
@pytest.mark.parametrize("form", FORMS)
def test_tiny_k_leaves_trailing_shards_empty(form, use_kernels):
    """K 3 over 8 shards: shards 3-7 hold no column and are skipped, as the
    JAX package's all-ones pad columns there never win."""
    barcodes, obs = random_case(3, k=3, length=6, b=40, form=form)
    fn, _ = check(barcodes, obs, 1, 1, (1, 8), form, use_kernels)
    assert [t is None for t in fn.tiles[0]] == [False] * 3 + [True] * 5


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernels", "scan"])
@pytest.mark.parametrize("form", FORMS)
def test_k1_next_is_max_count(form, use_kernels):
    """K 1 over 2 x 4: ``next`` is 255 after the fold, whatever the shards
    report (``tests/test_parallel.py:150``'s second case)."""
    obs = np.frombuffer(b"ACGTACGAACTTAAAA", dtype=np.uint8).reshape(4, 4).copy()
    check(["ACGT"], obs, 1, 2, (2, 4), form, use_kernels)


@pytest.mark.parametrize("b", [50, 3, 0])
@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernels", "scan"])
def test_odd_batch_counts_exact(b, use_kernels):
    """No pad rows: any B, fewer rows than batch parts, none at all."""
    barcodes, obs = random_case(5, k=23, length=9, b=max(b, 1), form="bytes")
    obs = obs[:b]
    fn, assigned, counts = port(barcodes, obs, 1, 2, (8, 1), "bytes", use_kernels=use_kernels)
    want, want_counts = spec(obs, barcodes, 1, 2) if b else (np.zeros(0), np.zeros(24))
    assert fn.batch_multiple == 8 and assigned.shape == (b,)
    np.testing.assert_array_equal(assigned, want)
    np.testing.assert_array_equal(counts, want_counts)


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernels", "scan"])
@pytest.mark.parametrize("form", FORMS)
def test_first_index_tie_across_shards(form, use_kernels):
    """A read 1 mismatch from barcodes 0 and 4, in different shards at
    2 x 4: the earliest index wins (delta 0)."""
    barcodes = ["AAAA", "CCCC", "GGGG", "TTTT", "AAAT", "CCCG", "GGGA", "TTTC"]
    obs = np.frombuffer(b"AAAG", dtype=np.uint8)[None, :].repeat(8, axis=0).copy()
    fn, _ = check(barcodes, obs, 2, 0, (2, 4), form, use_kernels)
    _, assigned, _ = port(barcodes, rows_of(obs, form), 2, 0, (2, 4), form,
                          use_kernels=use_kernels)
    np.testing.assert_array_equal(assigned, np.zeros(8))


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernels", "scan"])
@pytest.mark.parametrize("form", ["nib4", "bytes"])
def test_nocall_budget_of_the_whole_whitelist(form, use_kernels):
    """Only the last shard's barcodes hold Ns (max 2): a read with two Ns
    matching that barcode is within ``max_mismatches + 2`` and assigned; a
    shard's own budget (``max_mismatches + 0`` for shard 0) would refuse
    it."""
    barcodes = ["AACCGG", "CCGGTT", "GGTTAA", "TTAACC", "ACGTAC", "CATGCA",
                "GTCAGT", "ACNNTG"]
    obs = np.frombuffer(b"ACNNTGACNNTGTTAACCNNNNTG", dtype=np.uint8).reshape(4, 6).copy()
    fn, _ = check(barcodes, obs, 1, 1, (2, 4), form, use_kernels)
    _, assigned, _ = port(barcodes, rows_of(obs, form), 1, 1, (2, 4), form,
                          use_kernels=use_kernels)
    assert assigned.tolist() == [7, 7, 3, 8]  # NNNN: 4 no-calls > 1 + 2
    assert fn.nocall_budget == 3


@pytest.mark.parametrize("form", ["bit2", "nib4", "bytes"])
@pytest.mark.parametrize("n_batch,n_k", [(2, 4), (1, 8)])
def test_long_barcodes_take_the_scan(n_batch, n_k, form):
    """L = 300: ``use_kernels`` defaults to the scan; the kernels refuse."""
    barcodes, obs = random_case(9, k=5, length=300, b=12, form=form)
    for i in range(1, 12, 4):  # a few mismatches away from a barcode
        obs[i] = obs[i - 1]
        obs[i, :2] = ord("A")
    fn, _ = check(barcodes, obs, 3, 1, (n_batch, n_k), form, None, k_chunk=2)
    assert not fn.use_kernels and fn.scheme == "xla_scan"
    with pytest.raises(ValueError, match="<= 255"):
        mesh.make_sharded_assign_fn(ExpectedSet.from_barcodes(barcodes), 3, 1,
                                    mesh.make_demux_mesh(2, 4, devices=CPU8),
                                    use_kernels=True)


@pytest.mark.parametrize("form", FORMS)
def test_shard_tables_are_built_one_shard_at_a_time(monkeypatch, form):
    """Each shard's state comes from its own slice of ``expected.masks``,
    once per shard (batch rows on one device share it); the scheme is
    ``hopper_scheme(k_per_shard, L)``."""
    built = []
    real = mesh.hopper_state_from_numpy

    def record(es, device, scheme=None, classes=4):
        built.append((es.count, scheme, classes, es.masks.base is not None))
        return real(es, device, scheme, classes)

    monkeypatch.setattr(mesh, "hopper_state_from_numpy", record)
    barcodes, obs = random_case(2, k=101, length=8, b=16, form=form)
    check(barcodes, obs, 1, 2, (2, 4), form, True)
    classes = 4 if form == "bit2" else 16
    assert built == [(26, "colmerge_top2", classes, True)] * 3 + [(23, "colmerge_top2", classes, True)]


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernels", "scan"])
@pytest.mark.parametrize("n_batch,n_k", [(4, 2), (2, 4)])
def test_distinct_devices_get_a_matcher_per_tile(n_batch, n_k, use_kernels):
    """Eight distinct devices (``cpu:0`` .. ``cpu:7``): every tile holds its
    own shard matcher and the rows and triples move between devices, with
    the results of the shared-device mesh."""
    barcodes, obs = random_case(10, k=23, length=9, b=64, form="bytes")
    es = ExpectedSet.from_barcodes(barcodes)
    m = mesh.make_demux_mesh(n_batch, n_k, devices=[torch.device("cpu", i) for i in range(8)])
    fn = mesh.make_sharded_assign_fn(es, 1, 2, m, k_chunk=8, use_kernels=use_kernels)
    assert len({id(t) for row in fn.tiles for t in row}) == n_batch * n_k
    assigned, counts = fn(obs)
    want, want_counts = spec(obs, barcodes, 1, 2)
    np.testing.assert_array_equal(assigned.numpy(), want)
    np.testing.assert_array_equal(counts.numpy(), want_counts)


def test_scheme_follows_the_shard_size(monkeypatch):
    """A shard over ``hopper_scheme``'s column-merge limit runs ``tile_top2``
    (checked through the plan only: the size is in the plan, not the data)."""
    k = 9_000_000
    assert hm.hopper_scheme(k, 16) == "tile_top2"
    assert hm.hopper_scheme(-(-k // 2), 16) == "tile_top2"
    assert hm.hopper_scheme(-(-k // 4), 16) == "colmerge_top2"
    seen = []
    monkeypatch.setattr(mesh, "hopper_scheme", lambda kk, ll: seen.append(kk) or "tile_top2")
    barcodes, obs = random_case(4, k=23, length=9, b=20, form="bit2")
    fn, _ = check(barcodes, obs, 1, 2, (1, 8), "bit2", True)
    assert seen == [3] and fn.scheme == "tile_top2"
    assert fn.kernels["tile_top2"].plain_calls == 8 and fn.kernels["colmerge_top2"].plain_calls == 0


@pytest.mark.parametrize("form", FORMS)
def test_top2_is_the_raw_triple_behind_the_call(form):
    """``HopperAssignFn.top2`` and ``ScanAssignFn.top2`` return the raw
    ``(best, idx, next)`` and no-call counts that their ``__call__`` gates."""
    barcodes, obs = random_case(6, k=23, length=9, b=40, form=form)
    es = ExpectedSet.from_barcodes(barcodes)
    rows = torch.from_numpy(rows_of(obs, form))
    for fn in (hm.make_hopper_assign_fn(es, 1, 2, device="cpu", **flags(form)),
               make_assign_fn(es, 1, 2, device="cpu", **flags(form))):
        best, idx, nxt, nocalls = fn.top2(rows)
        assigned, best2, nxt2 = fn(rows)
        assert torch.equal(best, best2) and torch.equal(nxt, nxt2)
        ok = (best <= 1) & (nxt - best >= 2)
        if form == "bit2":
            assert nocalls is None
        else:
            np.testing.assert_array_equal(nocalls.numpy(), (obs == ord("N")).sum(axis=1))
            ok &= nocalls <= 1 + es.max_ns_in_barcodes
        np.testing.assert_array_equal(torch.where(ok, idx, 23).numpy(), assigned.numpy())


def test_compact_output_and_no_counts():
    barcodes, obs = random_case(8, k=23, length=9, b=30, form="bit2")
    m = mesh.make_demux_mesh(4, 2, devices=CPU8)
    es = ExpectedSet.from_barcodes(barcodes)
    fn = mesh.make_sharded_assign_fn(es, 1, 2, m, packed2=True, compact_output=True,
                                     with_counts=False)
    assigned = fn(pack_bit2(obs))
    assert assigned.dtype == torch.uint8
    np.testing.assert_array_equal(assigned.numpy(), spec(obs, barcodes, 1, 2)[0])
    with pytest.raises(ValueError, match="mutually exclusive"):
        mesh.make_sharded_assign_fn(es, 1, 2, m, packed2=True, packed_masks=True)
