"""YCSB workload generation (paper §8.1): the scrambled Zipfian request
distribution (theta = 0.99, as YCSB) and the workload mixes.

Cooper et al., "Benchmarking Cloud Serving Systems with YCSB", SoCC 2010;
workload C (``workloads/workloadc``) is the ``read-only`` mix: 100% reads
of existing records, keys drawn from a scrambled Zipfian; workload E
(``workloads/workloade``) is ``ycsb-e``: 95% scans and 5% inserts, scan
lengths uniform in ``[1, maxscanlength]`` with ``scan_len_dist="uniform"``.
Host-side numpy, identical to ``repro.data.ycsb`` for the same seed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

OP_LOOKUP, OP_UPDATE, OP_INSERT, OP_SCAN, OP_DELETE = 0, 1, 2, 3, 4

#: mixes as (insert, lookup, update, scan) fractions
WORKLOADS: Dict[str, Tuple[float, float, float, float]] = {
    "read-only": (0.0, 1.0, 0.0, 0.0),
    "read-intensive": (0.0, 0.95, 0.05, 0.0),
    "write-intensive": (0.0, 0.50, 0.50, 0.0),
    "insert-intensive": (0.50, 0.50, 0.0, 0.0),
    "scan-intensive": (0.05, 0.0, 0.0, 0.95),
    "read-intensive-2": (0.05, 0.95, 0.0, 0.0),
    "insert-only": (1.0, 0.0, 0.0, 0.0),
    "ycsb-e": (0.05, 0.0, 0.0, 0.95),
    "ycsb-a": (0.0, 0.50, 0.50, 0.0),
    "ycsb-b": (0.0, 0.95, 0.05, 0.0),
    "ycsb-d": (0.05, 0.95, 0.0, 0.0),
    "ycsb-load": (1.0, 0.0, 0.0, 0.0),
    "ycsb-d95i": (0.95, 0.05, 0.0, 0.0),
}


@dataclasses.dataclass
class ZipfianGenerator:
    """YCSB's Zipfian over ``n`` items (Gray et al.'s rejection-free form,
    vectorised)."""

    n: int
    theta: float = 0.99
    seed: int = 0

    def __post_init__(self):
        n, theta = self.n, self.theta
        self._rng = np.random.default_rng(self.seed)
        if theta <= 0:
            self._uniform = True
            return
        self._uniform = False
        self.zetan = self._zeta(n, theta)
        self.zeta2 = self._zeta(2, theta)
        self.alpha = 1.0 / (1.0 - theta)
        self.eta = (1 - (2.0 / n) ** (1 - theta)) / (1 - self.zeta2 / self.zetan)

    @staticmethod
    def _zeta(n: int, theta: float) -> float:
        # exact for small n; integral tail approximation for large n
        if n <= 10_000_000:
            i = np.arange(1, n + 1, dtype=np.float64)
            return float(np.sum(i ** (-theta)))
        i = np.arange(1, 10_000_001, dtype=np.float64)
        head = float(np.sum(i ** (-theta)))
        tail = (n ** (1 - theta) - 10_000_000 ** (1 - theta)) / (1 - theta)
        return head + tail

    def draw_ranks(self, size: int) -> np.ndarray:
        """Zipfian ranks in [0, n): rank 0 is the hottest item."""
        if self._uniform:
            return self._rng.integers(0, self.n, size=size)
        u = self._rng.random(size)
        uz = u * self.zetan
        ranks = (self.n * (self.eta * u - self.eta + 1) ** self.alpha).astype(
            np.int64
        )
        ranks = np.where(uz < 1.0, 0, ranks)
        ranks = np.where((uz >= 1.0) & (uz < 1.0 + 0.5**self.theta), 1, ranks)
        return np.clip(ranks, 0, self.n - 1)


def scramble(ranks: np.ndarray, n: int) -> np.ndarray:
    """FNV-style hash spreading ranks over [0, n) (YCSB ScrambledZipfian)."""
    h = ranks.astype(np.uint64)
    h = (h * np.uint64(0xC6A4A7935BD1E995)) ^ (h >> np.uint64(29))
    h = (h * np.uint64(0xFF51AFD7ED558CCD)) ^ (h >> np.uint64(33))
    return (h % np.uint64(n)).astype(np.int64)


@dataclasses.dataclass
class Workload:
    ops: np.ndarray  # op codes
    keys: np.ndarray  # target keys (-1 when only a key count was given)
    idx: np.ndarray  # dataset index of each op's key (-1 for inserts)
    scan_len: int = 100
    #: per-op scan lengths (uniform in [1, scan_len]); None = all scan_len
    scan_lens: "np.ndarray | None" = None


def engine_lanes(wl: Workload, lo: int = 0, hi=None, *, update_xor: int = 0x5A5A):
    """Slice ``[lo, hi)`` of a workload as one mixed batch for the engine:
    ``(opcodes int32, keys int64, values int64)``.  The value plane carries
    ``key ^ update_xor`` on update lanes, the key on insert lanes, the
    record count on scan lanes (``scan_lens`` where drawn, else
    ``scan_len``) and 0 on lookups, as ``repro.data.ycsb.engine_lanes``
    does."""
    hi = wl.ops.size if hi is None else hi
    ops = wl.ops[lo:hi].astype(np.int32)
    keys = wl.keys[lo:hi].astype(np.int64)
    vals = np.zeros(ops.shape, np.int64)
    upd = ops == OP_UPDATE
    vals[upd] = keys[upd] ^ update_xor
    ins = ops == OP_INSERT
    vals[ins] = keys[ins]
    scn = ops == OP_SCAN
    if wl.scan_lens is not None:
        vals[scn] = wl.scan_lens[lo:hi][scn]
    else:
        vals[scn] = wl.scan_len
    return ops, keys, vals


def make_dataset(n_keys: int, *, key_space: int = None, seed: int = 0) -> np.ndarray:
    """Sorted unique int64 keys to bulk-load, drawn from ``[1, key_space]``
    (default ``max(4 * n_keys, 2**20)``), as ``repro.data.ycsb.make_dataset``
    draws them."""
    key_space = key_space or max(4 * n_keys, 1 << 20)
    rng = np.random.default_rng(seed)
    keys = rng.choice(key_space, size=n_keys, replace=False).astype(np.int64) + 1
    return np.sort(keys)


def generate(
    name: str,
    dataset,
    n_ops: int,
    *,
    theta: float = 0.99,
    seed: int = 1,
    scan_len: int = 100,
    scan_len_dist: str = "fixed",
    hotspot: "float | None" = None,
) -> Workload:
    """``n_ops`` operations of the named mix over ``dataset`` (sorted keys,
    or their count when only indices are wanted).  Reads, updates and scans
    target existing keys through scrambled-Zipfian ranks; inserts draw fresh
    keys next to existing ones.  ``scan_len_dist="fixed"`` gives every scan
    ``scan_len`` records; ``"uniform"`` draws per-op lengths in ``[1,
    scan_len]`` into ``scan_lens`` (YCSB workload E), after the ops and
    keys.  ``hotspot`` (a fraction in ``[0, 1)``) centres the Zipfian on that
    position of the sorted dataset without scrambling, rank 0 at the centre
    and the ranks fanning out to alternate sides, so the hot keys form one
    contiguous range (the localized skew that logical repartitioning
    answers).  Ops, keys and scan lengths equal ``repro.data.ycsb.generate``
    for the same arguments."""
    if name not in WORKLOADS:
        raise KeyError(f"unknown workload {name!r}; options: {list(WORKLOADS)}")
    if scan_len_dist not in ("fixed", "uniform"):
        raise ValueError(f"unknown scan_len_dist {scan_len_dist!r}")
    p_ins, p_look, p_upd, p_scan = WORKLOADS[name]
    rng = np.random.default_rng(seed)
    n = dataset if isinstance(dataset, int) else dataset.size
    zipf = ZipfianGenerator(n, theta=theta, seed=seed + 7)
    ops = rng.choice(
        np.array([OP_INSERT, OP_LOOKUP, OP_UPDATE, OP_SCAN]),
        size=n_ops,
        p=[p_ins, p_look, p_upd, p_scan],
    )
    ranks = zipf.draw_ranks(n_ops)
    if hotspot is None:
        idx = scramble(ranks, n)
    else:
        if not (0.0 <= hotspot < 1.0):
            raise ValueError(f"hotspot must be in [0, 1), got {hotspot!r}")
        offset = np.where(ranks % 2 == 0, ranks // 2, -(ranks // 2 + 1))
        idx = (int(hotspot * n) + offset) % n
    is_ins = ops == OP_INSERT
    if isinstance(dataset, int):
        keys = np.full(idx.shape, -1, np.int64)
    else:
        keys = dataset[idx].astype(np.int64)
        n_ins = int(is_ins.sum())
        if n_ins:
            keys[is_ins] = dataset[idx[is_ins]] + rng.integers(1, 3, size=n_ins)
    idx = np.where(is_ins, -1, idx)
    scan_lens = None
    if scan_len_dist == "uniform":
        scan_lens = rng.integers(1, scan_len + 1, size=n_ops).astype(np.int32)
    return Workload(
        ops=ops.astype(np.int32),
        keys=keys,
        idx=idx,
        scan_len=scan_len,
        scan_lens=scan_lens,
    )
