"""The sorted-row contract of ``node_search`` and ``node_search_prefix``.

The CUDA kernels search a row and read only the sectors the search needs,
so they are right only on rows sorted non-decreasing (and, for a
compressible lane of ``node_search_prefix``, its suffix row too).  The CPU
path checks this before it takes the plain version: an unsorted row raises
``ValueError`` naming its lane, and every row the port's callers build
passes.  Imports only torch, numpy and the port."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import btree as t_btree  # noqa: E402
from repro_torch.core import pool as t_pool  # noqa: E402
from repro_torch.core.nodes import FANOUT  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from test_torch_cuda import _rows, prefix_case  # noqa: E402


def _swap(a, lane, i=3, j=9):
    a = a.copy()
    a[lane, i], a[lane, j] = a[lane, j], a[lane, i]
    return a


@pytest.mark.parametrize("b,seed", [(1, 0), (17, 1), (300, 3), (4097, 4)])
def test_node_search_accepts_sorted_rows(b, seed):
    rows, q, vals = (torch.from_numpy(a) for a in _rows(b, seed))
    ops.node_search(rows, q, vals)
    ops.node_search(rows, q)


@pytest.mark.parametrize("with_values", [True, False])
def test_node_search_refuses_an_unsorted_row(with_values):
    rows, q, vals = _rows(40, 7)
    bad = rows.copy()
    bad[21] = bad[21, ::-1]
    args = (torch.from_numpy(bad), torch.from_numpy(q))
    if with_values:
        args += (torch.from_numpy(vals),)
    with pytest.raises(ValueError, match="lane 21"):
        ops.node_search(*args)


@pytest.mark.parametrize("b,seed", [(1, 0), (31, 1), (256, 2), (4097, 3)])
def test_node_search_prefix_accepts_sorted_rows(b, seed):
    case = [torch.from_numpy(a) for a in prefix_case(b, seed)]
    ops.node_search_prefix(*case)


def _compressible_case():
    prefix, nbits, suffix, rows, q = prefix_case(64, 5)
    comp = np.flatnonzero((nbits >= 0) & ((suffix != 0x7FFFFFFF).sum(1) > 10))
    return (prefix, nbits, suffix, rows, q), int(comp[0])


def test_node_search_prefix_refuses_an_unsorted_suffix_row():
    (prefix, nbits, suffix, rows, q), lane = _compressible_case()
    bad = _swap(suffix, lane)
    args = map(torch.from_numpy, (prefix, nbits, bad, rows, q))
    with pytest.raises(ValueError, match=f"suffix rows .*lane {lane} "):
        ops.node_search_prefix(*args)


def test_node_search_prefix_ignores_an_incompressible_lanes_suffix():
    """An incompressible lane's suffix row is never read, so its order is
    not part of the contract."""
    prefix, nbits, suffix, rows, q = prefix_case(64, 6)
    lane = int(np.flatnonzero(nbits < 0)[0])
    suffix = suffix.copy()
    suffix[lane] = np.arange(FANOUT, 0, -1)
    ops.node_search_prefix(*map(torch.from_numpy, (prefix, nbits, suffix, rows, q)))


def test_node_search_prefix_refuses_an_unsorted_key_row():
    (prefix, nbits, suffix, rows, q), lane = _compressible_case()
    bad = _swap(rows, lane)
    args = map(torch.from_numpy, (prefix, nbits, suffix, bad, q))
    with pytest.raises(ValueError, match=f"rows must be sorted.*lane {lane} "):
        ops.node_search_prefix(*args)


@pytest.mark.parametrize("level_m", [0, 1, 2])
def test_every_pool_and_top_row_is_sorted(level_m):
    """The rows the engine, the top walk and the SMO search: each pool row
    (inner, leaf and free rows) and each top-tree row, and their
    compressed suffix rows."""
    rng = np.random.default_rng(level_m)
    keys = np.sort(rng.choice(2**40, size=20_000, replace=False)) - 2**39
    pool, meta = t_pool.build_pool(keys, keys ^ 3, level_m=level_m, device="cpu")
    flat = pool.pool_keys.reshape(-1, FANOUT)
    q = torch.zeros(flat.shape[0], dtype=torch.int64)
    ops.node_search(flat, q, pool.pool_values.reshape(-1, FANOUT))
    top = pool.top_keys
    ops.node_search(top, torch.zeros(top.shape[0], dtype=torch.int64))
    sep = t_pool.compress_separators(pool, meta)
    ops.node_search_prefix(
        sep.prefix.reshape(-1), sep.nbits.reshape(-1),
        sep.suffix.reshape(-1, FANOUT), flat, q,
    )


def test_every_btree_row_is_sorted():
    """The page-table B+-tree's rows, inner and leaf, after a bulk build."""
    keys = np.arange(0, 3 * 10_000, 3, dtype=np.int64)
    tree, _ = t_btree.bulk_build(keys, keys * 7, device="cpu")
    rows = tree.keys
    ops.node_search(rows, torch.zeros(rows.shape[0], dtype=torch.int64), tree.values)
