"""The port's CUDA kernels against their plain PyTorch versions, bit for
bit, on an NVIDIA GPU.  Imports neither JAX nor the reference package, so it
runs where only PyTorch and the CUDA toolkit are installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a CUDA device every test skips with its reason."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import pool as t_pool  # noqa: E402
from repro_torch.core.nodes import FANOUT, KEY_MAX, KEY_MIN  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _rows(b, seed):
    rng = np.random.default_rng(seed)
    rows = np.sort(
        rng.integers(-(2**62), 2**62, size=(b, FANOUT), dtype=np.int64), axis=1
    )
    occ = rng.integers(1, FANOUT + 1, size=b)
    rows[np.arange(FANOUT)[None, :] >= occ[:, None]] = KEY_MAX
    rows[::5, 0] = KEY_MIN
    vals = rng.integers(-(2**62), 2**62, size=(b, FANOUT), dtype=np.int64)
    q = rows[np.arange(b), rng.integers(0, occ)].copy()
    q[1::4] += 1
    q[2::4] = rows[2::4, 0] - 1
    q[3::16] = KEY_MAX
    q[7::16] = KEY_MIN
    return rows, q, vals


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 31, 4097])
@pytest.mark.parametrize("with_values", [True, False])
def test_node_search_kernel_matches_plain(cuda, b, with_values):
    rows, q, vals = (torch.from_numpy(a).to(cuda) for a in _rows(b, b))
    vals = vals if with_values else None
    before = ops.LAUNCHES["node_search"]
    got = ops.node_search(rows, q, vals)
    assert ops.LAUNCHES["node_search"] == before + 1
    for g, w in zip(got, ref.node_search_ref(rows, q, vals)):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("level_m", [0, 1, 2])
def test_subtree_walk_kernel_matches_plain(cuda, level_m):
    rng = np.random.default_rng(level_m)
    keys = np.sort(rng.choice(2**40, size=20_000, replace=False).astype(np.int64))
    keys -= 2**39
    pool, meta = t_pool.build_pool(keys, keys * 3, level_m=level_m, device=cuda)
    q = torch.from_numpy(np.concatenate([keys[::7], keys[::11] + 1])).to(cuda)
    q[::13] = KEY_MAX
    q[::17] = KEY_MIN
    st = t_pool.top_walk(pool, meta, q)
    st = torch.where(torch.arange(q.numel(), device=cuda) % 3 == 0, 0, st)
    args = (pool.pool_keys, pool.pool_children, pool.pool_values, st.to(torch.int32), q)
    before = ops.LAUNCHES["subtree_walk"]
    got = ops.subtree_walk(*args, levels=meta.levels_in_subtree)
    assert ops.LAUNCHES["subtree_walk"] == before + 1
    want = ref.subtree_walk_ref(*args, levels=meta.levels_in_subtree)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_inputs(cuda):
    rows = torch.zeros((4, FANOUT), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        ops.node_search(rows, torch.zeros(4, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        ops.node_search(rows[:, :32], torch.zeros(4, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        ops.node_search(rows, torch.zeros(4, dtype=torch.int64))
