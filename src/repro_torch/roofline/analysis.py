"""Roofline terms of a step, and the work of every hand-written kernel.

The port of ``repro.roofline.analysis``.  Per (arch x shape x mesh) cell:

    compute term    = flops_per_chip / PEAK_FLOPS
    memory term     = bytes_per_chip / HBM_BW
    collective term = collective_bytes_per_chip / ICI_BW

The reference reads flops and bytes from XLA's ``cost_analysis`` and the
collective bytes from the partitioned HLO text.  The port runs eager on
one card, so its flops and bytes come from a counted step on the ``meta``
device (``roofline/calibrate.py::StepCounter``): every aten op by
``torch.utils.flop_counter``'s formulas and its operands' bytes, every
hand-written kernel by the formulas below.  No partitioner runs on one
card, so no collective is counted: the port's collective term is null
(``COLLECTIVE_NOTE``).  ``collective_bytes`` is kept, a copy of the
reference's, for HLO text that a partitioner did write.

Hardware constants (NVIDIA H100 SXM): 989 bf16 TFLOP/s dense, 3.35 TB/s
HBM, 450 GB/s NVLink a direction.

The kernel formulas are the least work each kernel's function needs:
flops it must do and bytes it must move (each input read once, each output
written once), which ``chip_smoke.py``'s bounds divide by the card's rates
and the counter adds for each launch.  Where the work depends on the data
(a search that ends early, live keys), the functions take the data.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

PEAK_FLOPS = 989e12        # bf16 FLOP/s a card, dense tensor cores
HBM_BW = 3.35e12           # bytes/s a card
ICI_BW = 450e9             # bytes/s a card and direction (NVLink)

#: why the port's collective term is null
COLLECTIVE_NOTE = "no partitioner on one card"

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(tok_dtype: str, dims: str) -> int:
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(tok_dtype, 4)


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Sum result-shape bytes of every collective op in (post-SPMD) HLO.

    These are per-partition programs, so the result is bytes moved per chip
    per step (the roofline denominator is per-chip link bandwidth)."""
    out = {c: 0 for c in _COLLECTIVES}
    for line in hlo_text.splitlines():
        stripped = line.strip()
        if "=" not in stripped:
            continue
        m = re.search(r"=\s*(.+?)\s+([a-z0-9\-]+)\(", stripped)
        if not m:
            continue
        opcode = m.group(2)
        if opcode.endswith("-start"):
            opcode = opcode[: -len("-start")]
        if opcode not in out:
            continue
        shapes = _SHAPE_RE.findall(m.group(1))
        out[opcode] += sum(_shape_bytes(dt, dims) for dt, dims in shapes)
    return out


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_chip: float
    hlo_bytes_per_chip: float
    collective_bytes_per_chip: Optional[float]   # None: not counted
    collective_breakdown: Optional[Dict[str, int]]
    model_flops: float                 # 6*N*D (or 6*N_active*D for MoE)
    per_device_memory_bytes: float

    @property
    def compute_term(self) -> float:
        return self.hlo_flops_per_chip / PEAK_FLOPS

    @property
    def memory_term(self) -> float:
        return self.hlo_bytes_per_chip / HBM_BW

    @property
    def collective_term(self) -> Optional[float]:
        if self.collective_bytes_per_chip is None:
            return None
        return self.collective_bytes_per_chip / ICI_BW

    def _terms(self) -> Dict[str, float]:
        terms = {"compute": self.compute_term, "memory": self.memory_term}
        if self.collective_term is not None:
            terms["collective"] = self.collective_term
        return terms

    @property
    def dominant(self) -> str:
        terms = self._terms()
        return max(terms, key=lambda k: terms[k])

    @property
    def step_time_bound(self) -> float:
        """Lower bound on step time = max of the terms that were counted
        (perfect overlap assumption)."""
        return max(self._terms().values())

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / cluster counted FLOPs: how much counted compute is
        'useful' (catches remat/redundancy waste)."""
        total = self.hlo_flops_per_chip * self.chips
        return self.model_flops / total if total else float("nan")

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved at the step-time bound:
        useful model FLOPs / (chips * peak * bound)."""
        bound = self.step_time_bound
        if bound <= 0:
            return float("nan")
        return self.model_flops / (self.chips * PEAK_FLOPS * bound)

    def to_dict(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops_per_chip": self.hlo_flops_per_chip,
            "hlo_bytes_per_chip": self.hlo_bytes_per_chip,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "collective_breakdown": self.collective_breakdown,
            "model_flops": self.model_flops,
            "per_device_memory_bytes": self.per_device_memory_bytes,
            "compute_term_s": self.compute_term,
            "memory_term_s": self.memory_term,
            "collective_term_s": self.collective_term,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_for(cfg, shape_cell) -> float:
    """Analytic MODEL_FLOPS for the step: 6*N*D training, 2*N*D inference
    (forward only), with N_active for MoE."""
    n_active = cfg.active_param_count()
    tokens = shape_cell.global_batch * (
        shape_cell.seq_len if shape_cell.kind in ("train", "prefill") else 1
    )
    mult = 6.0 if shape_cell.kind == "train" else 2.0
    return mult * n_active * tokens


def build_terms(
    *, arch, shape_cell, mesh_name, chips, counts, argument_bytes, temp_bytes, cfg
) -> RooflineTerms:
    """The terms of a cell from its counted step: ``counts`` holds the
    ``flops`` and ``bytes`` a chip (``roofline/calibrate.py``);
    ``argument_bytes`` and ``temp_bytes`` a chip sum to its memory.  The
    collective term is null (``COLLECTIVE_NOTE``)."""
    return RooflineTerms(
        arch=arch,
        shape=shape_cell.name,
        mesh=mesh_name,
        chips=chips,
        hlo_flops_per_chip=float(counts["flops"]),
        hlo_bytes_per_chip=float(counts["bytes"]),
        collective_bytes_per_chip=None,
        collective_breakdown=None,
        model_flops=model_flops_for(cfg, shape_cell),
        per_device_memory_bytes=float(argument_bytes + temp_bytes),
    )


# ---------------------------------------------------------------------------
# the work of each hand-written kernel
# ---------------------------------------------------------------------------

# The least a search of one sorted 64-key row must read: a binary search
# over its sixteen 32-byte sectors (4 keys each), ceil(log2(16 + 1)) reads.
ROW_SEARCH_BYTES = 32 * 5
# The least leaf_write must move per row: its 64 keys and 64 values read and
# written once (4 x 512 B), its occupancy written (4 B), and one probe of each
# staged list (an update slot, 4 B, and an insert key, 8 B) to find it
# empty; each active staged update adds its slot and value (12 B), each
# active staged insert its key and value (16 B).
LEAF_ROW_BYTES = 4 * 64 * 8 + 4 + 4 + 8
STAGED_UPDATE_BYTES = 4 + 8
STAGED_INSERT_BYTES = 8 + 8
# leaf_split per row, as its contract has it: its keys and whole staged key
# list read (active staged keys may sit anywhere in the list) and its left
# and right key and value planes written, the right ones empty where the row
# does not split (6 x 512 B), and occ_l, occ_r, sep and did_split written
# (20 B); each live (not KEY_MAX) key's value is read, of the row's and of
# the staged list's (8 B each): an empty slot's value reaches no output.
SPLIT_ROW_BYTES = 6 * 64 * 8 + 20
SPLIT_VALUE_BYTES = 8
# node_search_prefix per lane: a compressible lane reads its prefix (8 B),
# nbits (4 B) and query (8 B) and writes its slot (4 B), plus a binary
# search of its 256-byte suffix row (ceil(log2(8 + 1)) = 4 of 8 sectors)
# unless its prefix already exceeds the query's; an incompressible lane
# reads nbits and query, writes the slot, and searches its canonical row.
PREFIX_LANE_BYTES = 8 + 4 + 8 + 4
SUFFIX_SEARCH_BYTES = 32 * 4
CANON_LANE_BYTES = 4 + 8 + 4 + ROW_SEARCH_BYTES
# node_search per lane: the query read (8 B), slot, found and value written
# (13 B); a live query searches its row (ROW_SEARCH_BYTES), a KEY_MAX query
# needs no search, every key being <= KEY_MAX, only the sector that holds
# row[63] for ``found``; with values, each matching slot's value (8 B), so
# a KEY_MAX query adds the values of its KEY_MAX run.
NS_LANE_BYTES = 8 + 4 + 1 + 8
KEYMAX_SEARCH_BYTES = 32
#: flops of the flash backward a kept (query, key) pair, head and head dim:
#: S = QK^T and dP = dO V^T recomputed or read (2 x 2 D), dV += P^T dO,
#: dK += dS^T Q and dQ += dS K (3 x 2 D)
FLASH_BWD_FLOPS = 10
#: flops of the selective scan a (batch, step, channel, state): the
#: reference's analytic count (``roofline/calibrate.py``), the backward
#: twice the forward
SCAN_FLOPS = 9
SCAN_BWD_FLOPS = 18


def node_search_bytes(rows, q, vals) -> int:
    """Least bytes ``node_search`` must move on these lanes
    (``NS_LANE_BYTES``, ``ROW_SEARCH_BYTES``, ``KEYMAX_SEARCH_BYTES``)."""
    from repro_torch.core.nodes import KEY_MAX

    n = q.numel()
    top = int((q == KEY_MAX).sum())
    nbytes = (
        n * NS_LANE_BYTES
        + (n - top) * ROW_SEARCH_BYTES
        + top * KEYMAX_SEARCH_BYTES
    )
    if vals is not None:
        nbytes += 8 * int((rows == q[:, None]).sum())
    return nbytes


def walk_bytes(pool, st, q, levels, found, active=None) -> int:
    """Least bytes a walk must move: a binary search of each distinct row its
    walked lanes read (``ROW_SEARCH_BYTES``), each distinct child id read
    (4 B), the matched values (8 B), a walked lane's inputs (subtree 4 B,
    query 8 B) and every lane's outputs (found, value, leaf: 13 B) and,
    where there is one, its mask byte (``active``)."""
    import torch

    n = q.numel()
    if active is not None:
        st, q, found = st[active], q[active], found[active]
    cap = pool.pool_keys.shape[1]
    local = torch.zeros_like(q)
    rows, kids = [], []
    stl = st.long()
    for _ in range(levels - 1):
        gid = stl * cap + local
        rows.append(gid)
        r = pool.pool_keys[stl, local]
        slot = ((r <= q[:, None]).sum(1) - 1).clamp(min=0)
        kids.append(gid * 64 + slot)
        local = pool.pool_children[stl, local, slot].long()
        local = torch.where(local < 0, local + cap, local)
    rows.append(stl * cap + local)
    n_rows = torch.unique(torch.cat(rows)).numel()
    n_kids = torch.unique(torch.cat(kids)).numel() if kids else 0
    return (
        ROW_SEARCH_BYTES * n_rows
        + 4 * n_kids
        + 8 * int(found.sum())
        + 12 * q.numel()
        + (13 + (active is not None)) * n
    )


def leaf_write_bytes(n_rows: int, n_upd: int, n_ins: int) -> int:
    """Least bytes ``leaf_write`` must move for ``n_rows`` rows with
    ``n_upd`` staged updates and ``n_ins`` staged inserts active."""
    return n_rows * LEAF_ROW_BYTES + n_upd * STAGED_UPDATE_BYTES + n_ins * STAGED_INSERT_BYTES


def leaf_scan_bytes(n_slots: int, max_count: int, n_active: int, n_sel: int) -> int:
    """Least bytes ``leaf_scan`` must move: every slot reads its start and
    count and writes its row and taken; an active one also searches its
    start row and reads each selected record."""
    return n_slots * (8 + 4 + 16 * max_count + 4) + n_active * ROW_SEARCH_BYTES + n_sel * 16


def leaf_split_bytes(args) -> int:
    """The bytes ``leaf_split``'s contract moves for ``args`` (rows_k,
    rows_v, ins_key, ins_val): ``SPLIT_ROW_BYTES`` a row and
    ``SPLIT_VALUE_BYTES`` for each live (not KEY_MAX) key's value, in the
    rows and in the staged lists."""
    from repro_torch.core.nodes import KEY_MAX

    rows_k, _, ins_key, _ = args
    n_live = int((rows_k != KEY_MAX).sum()) + int((ins_key != KEY_MAX).sum())
    return rows_k.shape[0] * SPLIT_ROW_BYTES + n_live * SPLIT_VALUE_BYTES


def prefix_search_bytes(prefix, nbits, queries) -> int:
    """Least bytes ``node_search_prefix`` must move for these lanes
    (``PREFIX_LANE_BYTES``, ``SUFFIX_SEARCH_BYTES``, ``CANON_LANE_BYTES``)."""
    import torch

    from repro_torch.core.nodes import KEY_MAX

    comp = nbits >= 0
    one = torch.ones_like(queries)
    low = torch.bitwise_left_shift(one, nbits.clamp(min=0).long()) - 1
    searched = comp & (prefix <= (queries & ~low))
    # an incompressible lane's KEY_MAX query needs no search (every key is
    # <= KEY_MAX): only its nbits, query and slot
    top = ~comp & (queries == KEY_MAX)
    return (
        int(comp.sum()) * PREFIX_LANE_BYTES
        + int(searched.sum()) * SUFFIX_SEARCH_BYTES
        + int((~comp).sum()) * CANON_LANE_BYTES
        - int(top.sum()) * ROW_SEARCH_BYTES
    )


def paged_bytes(q_shape, kv_heads: int, item: int, live_tokens: int, pages_used: int) -> int:
    """Least bytes ``paged_attention`` must move: the live K and V rows of
    each request's history, q read and the output written, the f32
    log-sum-exp written, and the page-table entries and lengths it reads."""
    b, h, d = q_shape
    return (
        live_tokens * kv_heads * d * 2 * item  # live K and V rows
        + 2 * b * h * d * item  # q in, output out
        + b * h * 4  # lse out
        + pages_used * 4
        + b * 4
    )


def kept_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs of one head that the mask keeps (causal offset
    ``Sk - Sq``): query ``i`` keeps ``min(Sk, max(0, i + Sk - Sq + 1))``
    keys."""
    if not causal:
        return sq * sk
    off = sk - sq
    first = max(0, -off)  # the rows before it keep no key
    if first >= sq:
        return 0
    # row i keeps i + off + 1 keys, from first + off + 1 up to sk at the last
    return (first + off + 1 + sk) * (sq - first) // 2


def flash_flops(b: int, h: int, sq: int, sk: int, dq: int, dv: int, causal: bool) -> int:
    """Flops of attention a kept pair and head: QK^T at ``dq`` and PV at
    ``dv``, 2 (Dq + Dv)."""
    return 2 * (dq + dv) * kept_pairs(sq, sk, causal) * b * h


def flash_bytes(q_numel: int, k_numel: int, v_numel: int, o_numel: int, item: int,
                lse_numel: int = 0) -> int:
    """Least bytes of a flash forward: q, k and v read and the output
    written once (``item`` bytes each), the f32 log-sum-exp written where
    it is kept."""
    return item * (q_numel + k_numel + v_numel + o_numel) + 4 * lse_numel


def flash_bwd_flops(b: int, h: int, sq: int, sk: int, d: int, causal: bool) -> int:
    """Flops of the flash backward: ``FLASH_BWD_FLOPS`` D a kept pair and
    head."""
    return FLASH_BWD_FLOPS * d * kept_pairs(sq, sk, causal) * b * h


def flash_bwd_bytes(q_numel: int, k_numel: int, lse_numel: int, item: int) -> int:
    """Least bytes of the flash backward: q, o, dO and dq like q, k, v, dk
    and dv like k (``item`` bytes each), lse in f32."""
    return item * (4 * q_numel + 4 * k_numel) + 4 * lse_numel


def mamba_bytes(b, l, d, n, item):
    """The least bytes of one scan: delta (f32), x (``item`` bytes) and y
    (f32) at [B, L, D], B and C at [B, L, N], A and h_last in f32."""
    return b * l * d * (4 + item + 4) + 2 * b * l * n * item + d * n * 4 + b * d * n * 4


def mamba_bwd_bytes(b, l, d, n, item, dh_last):
    """The least bytes of one backward: its inputs read once (delta, dy f32
    and x at [B, L, D], B and C at [B, L, N] of ``item`` bytes, A and, where
    given, dh_last f32) and its outputs written once in f32 (ddelta, dx,
    dB, dC, dA); not the forward's saved states, which another design may
    not need."""
    return (b * l * d * (4 + 4 + item + 4 + 4) + b * l * n * (2 * item + 8) + 2 * d * n * 4
            + (b * d * n * 4 if dh_last else 0))


def mamba_exps(b, l, d, n) -> int:
    """Exponentials of one scan, forward or backward: ``exp(delta A)`` a
    (batch, step, channel, state)."""
    return b * l * d * n


def mamba_flops(b, l, d, n, backward: bool = False) -> int:
    """Flops of one scan (``SCAN_FLOPS``) or of its backward
    (``SCAN_BWD_FLOPS``) a (batch, step, channel, state)."""
    return (SCAN_BWD_FLOPS if backward else SCAN_FLOPS) * b * l * d * n
