"""The read order of the CUDA ``node_search`` and ``node_search_prefix``
kernels, mirrored in plain Python (``kernels/node_search.py::
search_schedule`` and ``prefix_schedule``), on the CPU.

Each design's walk must give the plain versions' answers
(``ref.node_search_ref``, ``ref.node_search_prefix_ref``) on sorted rows of
every occupancy, all-KEY_MAX rows, KEY_MIN keys, runs of equal keys across
sector boundaries and KEY_MAX padding with random values, for queries on a
key, between keys, below the first key, KEY_MIN, KEY_MAX and -3; and the
default design must read no more key sectors than its budget: 7 for a live
query whose key is not repeated (and then one value), 1 for a KEY_MAX query
without values, 4 of a suffix row.  The mirror's constants are read out of
the CUDA sources, so the two cannot drift apart."""

import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.nodes import FANOUT, KEY_MAX, KEY_MIN  # noqa: E402
from repro_torch.kernels import node_search as ns  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from test_torch_cuda import prefix_case  # noqa: E402

CSRC = pathlib.Path(ns.__file__).resolve().parents[1] / "csrc"
DESIGNS = ("A", "B", "C")
# key sectors a live query's search and found check may read, per design
BUDGET = {"B": 7}
WRAP = 2**64


def _queries(rows, rng):
    """Per row: a key, one above it, below the first key, KEY_MIN, KEY_MAX
    and -3.  Returns ``(lane, q)``."""
    occ = np.maximum((rows != KEY_MAX).sum(1), 1)
    key = rows[np.arange(len(rows)), rng.integers(0, occ)]
    cols = [key, np.minimum(key, KEY_MAX - 1) + 1, rows[:, 0] - 1,
            np.full(len(rows), KEY_MIN), np.full(len(rows), KEY_MAX),
            np.full(len(rows), -3)]
    cols[2][rows[:, 0] == KEY_MIN] = KEY_MIN
    lane = np.tile(np.arange(len(rows)), len(cols))
    return lane, np.concatenate(cols).astype(np.int64)


def row_case(kind, seed):
    """Sorted rows with their values: ``occupancy`` (every occupancy 1-64,
    a fresh random row each), ``empty`` (all KEY_MAX, random values),
    ``key_min`` (KEY_MIN first, some runs of KEY_MIN), ``runs`` (a key
    repeated across one or more sector boundaries), ``padding`` (KEY_MAX
    padding with random values)."""
    rng = np.random.default_rng(seed)
    n = 64
    rows = np.sort(rng.integers(-(2**62), 2**62, size=(n, FANOUT)), axis=1)
    col = np.arange(FANOUT)[None, :]
    if kind == "occupancy":
        occ = np.arange(1, FANOUT + 1)
    else:
        occ = rng.integers(1, FANOUT + 1, size=n)
    if kind == "empty":
        occ[:] = 0
    if kind == "key_min":
        rows[col < 1 + np.arange(n)[:, None] % 5] = KEY_MIN
    if kind == "runs":
        for i in range(n):
            a = int(rng.integers(0, FANOUT - 1))
            b = int(rng.integers(a + 2, FANOUT + 1))
            rows[i, a:b] = rows[i, a]
        occ = np.maximum(occ, 1)
    rows = np.where(col < occ[:, None], rows, KEY_MAX)
    vals = rng.integers(-(2**62), 2**62, size=(n, FANOUT))
    if kind == "runs":
        vals[:8] = 2**62  # a run's values sum past 2**63: the sum wraps
    return rows, vals


def _lanes(kind, seed):
    rows, vals = row_case(kind, seed)
    lane, q = _queries(rows, np.random.default_rng(seed + 100))
    if kind == "runs":  # query each row's run
        starts = (rows[:, 1:] == rows[:, :-1]).argmax(1)
        run_q = rows[np.arange(len(rows)), starts]
        lane = np.concatenate([lane, np.arange(len(rows))])
        q = np.concatenate([q, run_q])
    return rows[lane], vals[lane], q


KINDS = ("occupancy", "empty", "key_min", "runs", "padding")


def _walk(rows, vals, q, design, with_values):
    slot, found, value, sectors = [], [], [], []
    for r, v, k in zip(rows, vals, q):
        count, lo, secs = ns.search_schedule(r, k, with_values, design)
        slot.append(max(count - 1, 0))
        found.append(count > 0 and int(r[count - 1]) == int(k))
        s = sum(int(x) for x in v[lo:count]) % WRAP
        value.append(s - WRAP if s >= 2**63 else s)
        sectors.append((secs, count - lo))
    return (np.asarray(slot, np.int32), np.asarray(found),
            np.asarray(value, np.int64), sectors)


@pytest.mark.parametrize("with_values", [True, False])
@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("kind", KINDS)
def test_schedule_matches_node_search_ref(kind, design, with_values):
    rows, vals, q = _lanes(kind, seed=KINDS.index(kind))
    slot, found, value, _ = _walk(rows, vals, q, design, with_values)
    want = ref.node_search_ref(
        torch.from_numpy(rows), torch.from_numpy(q),
        torch.from_numpy(vals) if with_values else None,
    )
    np.testing.assert_array_equal(slot, want[0].numpy())
    np.testing.assert_array_equal(found, want[1].numpy())
    np.testing.assert_array_equal(value, want[2].numpy())


@pytest.mark.parametrize("with_values", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_default_design_reads_within_its_budget(kind, with_values):
    rows, vals, q = _lanes(kind, seed=10 + KINDS.index(kind))
    *_, reads = _walk(rows, vals, q, ns.DESIGN, with_values)
    for r, k, (secs, n_values) in zip(rows, q, reads):
        repeated = int((r == k).sum()) > 1
        if k == KEY_MAX:
            if not with_values:
                assert secs == (15,) and n_values == 0
            elif r[0] == KEY_MAX:  # an all-KEY_MAX row: its whole value row
                assert secs == (15, 0) and n_values == FANOUT
            else:
                assert n_values == int((r == KEY_MAX).sum())
        elif not repeated:
            assert len(secs) <= BUDGET[ns.DESIGN]
            assert n_values == (1 if with_values and k in r else 0)
        else:  # a run: a second search, then the run's values
            assert n_values == (int((r == k).sum()) if with_values else 0)


def test_budget_is_met_at_every_count():
    """Every count 0-64 of a row of distinct keys, hit and missed: at most
    seven sectors under design B, at most five search sectors under A."""
    row = np.arange(FANOUT, dtype=np.int64) * 10
    for q in range(-5, 650, 5):
        count, lo, secs = ns.search_schedule(row, q, True, "B")
        assert count == int((row <= q).sum())
        assert len(secs) <= 7 and count - lo <= 1
        reads = []
        assert ns._count_row(row.tolist(), q, "A", reads) == count
        assert len(reads) <= 5 * 2  # five rounds of one sector (two pairs)
        assert len(set(reads)) <= 5
        reads = []
        assert ns._count_row(row.tolist(), q, "C", reads) == count
        assert len(set(reads)) <= 5


def _prefix_lanes(seed):
    return prefix_case(256, seed)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_schedule_matches_node_search_prefix_ref(seed):
    prefix, nbits, suffix, rows, q = _prefix_lanes(seed)
    got, s_reads, k_reads = [], [], []
    for lane in zip(prefix, nbits, suffix, rows, q):
        count, s, k = ns.prefix_schedule(*lane)
        got.append(max(count - 1, 0))
        s_reads.append(s)
        k_reads.append(k)
    want = ref.node_search_prefix_ref(
        *map(torch.from_numpy, (prefix, nbits, suffix, rows, q))
    )
    np.testing.assert_array_equal(np.asarray(got, np.int32), want.numpy())
    comp = nbits >= 0
    assert comp.any() and (~comp).any()
    assert ((rows[:, 0] == KEY_MAX) & comp).any()  # empty compressible rows
    for c, k, s, kr in zip(comp, q, s_reads, k_reads):
        assert len(s) <= 4 and (c or not s)
        assert len(kr) <= BUDGET[ns.DESIGN] and (not c or not kr)
        if not c and k == KEY_MAX:
            assert kr == ()


def test_prefix_reads_no_suffix_when_its_prefix_exceeds_the_query():
    suffix = np.full(FANOUT, ns.SUFFIX_SENTINEL, np.int32)
    suffix[:3] = [1, 5, 9]
    rows = np.full(FANOUT, KEY_MAX, np.int64)
    rows[:3] = [1025, 1029, 1033]
    assert ns.prefix_schedule(1024, 10, suffix, rows, 1000) == (0, (), ())
    count, s, _ = ns.prefix_schedule(1024, 10, suffix, rows, 1029)
    assert count == 2 and len(s) <= 4
    count, s, _ = ns.prefix_schedule(1024, 10, suffix, rows, 4096)
    assert count == 3 and len(s) <= 4


def _cu(name):
    return (CSRC / name).read_text()


def test_mirror_constants_match_the_cuda_sources():
    header = _cu("sector_search.cuh")
    design = re.search(r"constexpr char kDefaultDesign = '(\w)';", header)
    group = re.search(r"constexpr int kDefaultGroup = (\d+);", header)
    assert (design.group(1), int(group.group(1))) == (ns.DESIGN, ns.GROUP)
    table = _cu("node_search.cu").split("kVariants[] = {")[1].split("};")[0]
    first, rest = table.split(">,", 1)
    assert first.strip() == "launch<dex::kDefaultDesign, dex::kDefaultGroup"
    names = tuple(d + g for d, g in re.findall(r"launch<'(\w)', (\d+)>", rest))
    assert names == ns.VARIANTS
    assert f"{ns.DESIGN}{ns.GROUP}" in ns.VARIANTS
    prefix = _cu("node_search_prefix.cu")
    group = re.search(r"constexpr int kDefaultGroup = (\d+);", prefix)
    assert int(group.group(1)) == ns.PREFIX_GROUP
    table = prefix.split("kVariants[] = {")[1].split("};")[0]
    first, rest = table.split(",", 1)
    assert first.strip() == "launch<kDefaultGroup>"
    assert tuple(f"G{g}" for g in re.findall(r"launch<(\d+)>", rest)) \
        == ns.PREFIX_VARIANTS
    # the suffix search's first round, sectors 2 and 5, and B's splitters
    assert "8 + 12 * (j >> 2) + (j & 3)" in header
    assert "return 8 * j + 7;" in header


def test_unknown_variant_raises():
    with pytest.raises(ValueError):
        ns._variant("D4", ns.VARIANTS)
    assert ns._variant(None, ns.VARIANTS) == 0
    assert ns._variant("A1", ns.VARIANTS) == 1
