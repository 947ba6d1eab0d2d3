"""The byte bound of ``leaf_split`` (``roofline/analysis.py``, which
``chip_smoke.py`` imports for its bounds) against a hand count of what its
contract reads and writes."""

import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.core.nodes import KEY_MAX  # noqa: E402
from repro_torch.roofline import analysis  # noqa: E402


def test_leaf_split_bytes_charges_the_whole_contract():
    """Three rows, one that will split, one with nothing staged and one
    merge; three active staged keys, two of them spread out in their
    list.  A row reads its keys and all 64 staged keys (2 x 512 B) and
    writes left and right keys and values (4 x 512 B, the right ones empty
    unless it splits) and occ_l, occ_r, sep, did_split (4 + 4 + 8 + 4 B):
    3,092 B whatever its data.  Each live key's value adds 8 B: 64 + 0 + 10
    in the rows, 3 staged."""
    q = 3
    rows_k = torch.full((q, 64), KEY_MAX, dtype=torch.int64)
    rows_k[0] = torch.arange(64)
    rows_k[2, :10] = torch.arange(10)
    rows_v = torch.zeros((q, 64), dtype=torch.int64)
    ins_key = torch.full((q, 64), KEY_MAX, dtype=torch.int64)
    ins_key[0, 5], ins_key[0, 63] = 100, 200
    ins_key[2, 0] = 50
    ins_val = torch.zeros((q, 64), dtype=torch.int64)
    per_row = 6 * 512 + 20
    assert per_row == 3092
    assert chip_smoke.leaf_split_bytes is analysis.leaf_split_bytes
    got = analysis.leaf_split_bytes((rows_k, rows_v, ins_key, ins_val))
    assert got == q * per_row + (74 + 3) * 8 == 9_892
