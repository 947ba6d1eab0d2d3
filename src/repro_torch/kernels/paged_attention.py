"""CUDA kernel: decode attention over KV pages through a page table.

Replaces the TPU kernel ``paged_attention`` in
``src/repro/kernels/paged_attention.py``, the data-plane consumer of the DEX
page table (``serve/kv_cache.py``): one query token per request attends over
the request's tokens, stored in fixed-size pages that ``page_table[b, p]``
names, with positions at or past ``seq_lens[b]`` masked.  The TPU kernel's
grid ran (request, kv head, page) with the table prefetched as scalars, so
each page's block index dereferenced the table, and carried the online
softmax across the page axis in VMEM scratch.  Hopper's blocks run in no
order, so the sequence is cut into splits that run side by side and are
merged at the end.

What bounds it: bytes.  The call must read the live tokens' K and V rows
(``sum_b seq_len_b * HKV * D * 2 * itemsize``), q, the table entries it uses
and ``seq_lens``, and write the output; the math is 4 flops per query head
per element read.  Design (bf16, ``csrc/paged_attention.cu``): a CTA a
(split of ``split_tokens`` positions, kv head, request), dead splits exit;
each warp stages its tiles of 16 positions with ``cp.async`` (all in flight
before the first product), runs ``S^T = K q^T`` and ``O^T = V^T P^T`` on
``mma.sync`` tensor cores (P split into bf16 hi + lo), an online softmax in
registers; the last CTA of each (request, kv head) merges the splits.
float32 keeps a CUDA-core token walk, one CTA a (request, kv head).
``plan`` is the launch's shape, computed here and checked by the C entry.

Contract (the TPU kernel's, plus the log-sum-exp): ``paged_attention(q
[B, H, D], k_pages [P, page, HKV, D], v_pages, page_table [B, ppr] int32,
seq_lens [B] int32) -> [B, H, D]`` in q's dtype (float32 or bfloat16), f32
inside; with ``with_lse`` also ``lse [B, H]`` f32, the log-sum-exp of the
scaled logits over the request's tokens; D a multiple of 8 up to 256, G up
to 16.  ``seq_len = 0`` gives zeros and ``lse = -inf`` (the plain version
gives NaN; the decode step's ``nan_to_num`` makes the two agree).

The plain version is ``repro_torch.kernels.ref.paged_attention_ref``;
``split_merge`` mirrors the bf16 kernel's decomposition for the CPU tests.
The dispatch, build and launch count are in ``kernels/ops.py``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from repro_torch.kernels.node_search import check
from repro_torch.kernels.ref import paged_attention_ref  # noqa: F401  (plain version)

_P = ctypes.c_void_p
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP = 16
MAX_HEAD_DIM = 256

# The bf16 kernel's constants (``csrc/paged_attention.cu``, read back by
# tests/test_torch_paged_plan.py).
TILE_TOKENS = 16  # positions a tile: mma.sync's M
ROW_PAD = 8  # bf16 elements after each staged row (bank groups)
MAX_WARPS = 4  # warps a CTA, a tile each
SMEM_LIMIT = 232_448  # shared bytes a CTA may use on an H100
#: head dims the bf16 kernel is built for (16 x its KD instantiations)
PADDED_D = (16, 32, 64, 96, 128, 192, 256)
#: positions a split, four tiles: a split's K and V (32 KB at D = 128) in
#: flight in one CTA, serving's 36-page table in 9 splits
SPLIT_TOKENS = MAX_WARPS * TILE_TOKENS


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one launch runs: the splits of the sequence and the positions
    each covers (a split ``s`` owns ``[s * split_tokens, (s + 1) *
    split_tokens)``), warps a CTA, n8 tiles of query heads (0: the float32
    walk), the head dim it computes at and its dynamic shared memory in
    bytes."""

    splits: int
    split_tokens: int
    warps: int
    n_tiles: int
    padded_d: int
    smem_bytes: int


def split_smem_bytes(dp: int, nt: int, warps: int) -> int:
    """The bf16 kernel's shared bytes: q ``[8 nt][dp + 8]`` bf16, then one
    region reused three times: the warps' staged K and V tiles ``[warps][2]
    [16][dp + 8]`` bf16; the warps' ``(m, l, acc)`` ``[warps][8 nt][dp + 2]``
    f32; the last CTA's running sums ``[8 nt][dp + 3]`` and at least one
    split's partial rows ``[8 nt][dp + 4]`` f32."""
    gn = 8 * nt
    staged = warps * 2 * TILE_TOKENS * (dp + ROW_PAD) * 2
    warps_merge = warps * gn * (dp + 2) * 4
    splits_merge = (gn * (2 * dp + 7) + 4) * 4
    return gn * (dp + ROW_PAD) * 2 + max(staged, warps_merge, splits_merge)


def plan(b: int, hkv: int, g: int, d: int, page: int, ppr: int, dtype) -> Plan:
    """The launch plan for ``b`` requests of ``hkv`` kv heads of ``g`` query
    heads of dim ``d`` over tables of ``ppr`` pages of ``page`` tokens.

    bfloat16: splits of ``SPLIT_TOKENS`` positions, cut to the table (in
    tiles of 16) where it is shorter; a warp a tile; D padded to the next
    built head dim.  float32: one
    CTA a (request, kv head), eight warps where their merge buffer fits the
    default 48 KB of shared memory, else fewer."""
    if dtype == torch.float32:
        nwarps = next(w for w in (8, 4, 2, 1) if w * g * (2 + d) * 4 <= 48 * 1024)
        return Plan(1, ppr * page, nwarps, 0, d, 4 * nwarps * g * (2 + d))
    dp = next(x for x in PADDED_D if x >= d)
    nt = 1 if g <= 8 else 2
    ctx = ppr * page
    tokens = min(SPLIT_TOKENS, max(TILE_TOKENS, -(-ctx // TILE_TOKENS) * TILE_TOKENS))
    warps = tokens // TILE_TOKENS
    return Plan(max(1, -(-ctx // tokens)), tokens, warps, nt, dp,
                split_smem_bytes(dp, nt, warps))


def bind(lib: ctypes.CDLL) -> None:
    lib.dex_paged_attention.argtypes = [_P] * 9 + [ctypes.c_int] * 12 + [
        ctypes.c_float,
        _P,
    ]
    lib.dex_paged_attention.restype = ctypes.c_int


def validate(q, k_pages, v_pages, page_table, seq_lens) -> None:
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError("paged_attention takes q [B, H, D] and pages [P, page, HKV, D]")
    b, h, d = q.shape
    n_pages, page, hkv, _ = k_pages.shape
    if q.dtype not in DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if d % 8 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be a multiple of 8 up to 256, got {d}")
    if hkv == 0 or h % hkv or not 0 < h // hkv <= MAX_GROUP:
        raise ValueError(
            f"{h} query heads over {hkv} kv heads: group must be 1-{MAX_GROUP}"
        )
    if b > 65_535 or hkv > 65_535:
        raise ValueError(f"requests and kv heads must be at most 65,535, got {b}, {hkv}")
    check(q, "q", q.dtype, (b, h, d), rows=True)
    check(k_pages, "k_pages", q.dtype, (n_pages, page, hkv, d), rows=True)
    check(v_pages, "v_pages", q.dtype, (n_pages, page, hkv, d), rows=True)
    check(page_table, "page_table", torch.int32, (b, page_table.shape[-1]))
    check(seq_lens, "seq_lens", torch.int32, (b,))
    for t in (k_pages, v_pages, page_table, seq_lens):
        if t.device != q.device:
            raise ValueError("paged_attention inputs must lie on one device")


#: per (device, stream): the int32 counters of the bf16 kernel's last-CTA
#: merge, one a (request, kv head), all 0 between calls (the last CTA resets
#: its own); calls on one stream run one after another, so never share them
_COUNTERS: dict = {}


def _counters(device, stream: int, n: int) -> torch.Tensor:
    c = _COUNTERS.get((device, stream))
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[device, stream] = c
    return c


def launch(lib: ctypes.CDLL, q, k_pages, v_pages, page_table, seq_lens, with_lse=False):
    """Launch the kernel on the current stream; the outputs and the merge
    scratch are allocated here.  Returns ``out``, or ``(out, lse)``."""
    validate(q, k_pages, v_pages, page_table, seq_lens)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention kernel needs CUDA tensors, got {q.device}")
    b, h, d = q.shape
    _, page, hkv, _ = k_pages.shape
    g = h // hkv
    ppr = page_table.shape[1]
    p = plan(b, hkv, g, d, page, ppr, q.dtype)
    out = torch.empty_like(q)
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device) if with_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
    part = counters = None
    if p.splits > 1:
        part = torch.empty((b, hkv, p.splits, g, d + 4), dtype=torch.float32,
                           device=q.device)
        counters = _counters(q.device, stream, b * hkv)
    err = lib.dex_paged_attention(
        q.data_ptr(),
        k_pages.data_ptr(),
        v_pages.data_ptr(),
        page_table.data_ptr(),
        seq_lens.data_ptr(),
        out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        None if part is None else part.data_ptr(),
        None if counters is None else counters.data_ptr(),
        DTYPES[q.dtype],
        b,
        hkv,
        g,
        d,
        page,
        ppr,
        p.warps,
        p.splits,
        p.split_tokens,
        p.padded_d,
        p.smem_bytes,
        1.0 / math.sqrt(d),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {err}")
    return (out, lse) if with_lse else out


def split_merge(q, k_pages, v_pages, page_table, seq_lens, *, p_parts=None, out_dtype=None):
    """The bf16 kernel's decomposition in torch, in its order (for the CPU
    tests; on no path): per split, each warp's tile of 16 positions through
    a softmax in base 2 (f32), the weights rounded as ``p_parts``
    says (2: bf16 hi + lo, the kernel's; 1: bf16 hi alone; 0: f32, the
    default for float32 inputs), the warps merged, then the live splits.
    Returns ``(out, lse)``: ``out`` in ``out_dtype`` (q's by default; f32
    shows it before the final rounding), ``lse`` f32, 0 and ``-inf`` at
    length 0, as the kernel writes them."""
    b, h, d = q.shape
    _, page, hkv, _ = k_pages.shape
    g = h // hkv
    ppr = page_table.shape[1]
    p = plan(b, hkv, g, d, page, ppr, torch.bfloat16)
    if p_parts is None:
        p_parts = 2 if q.dtype == torch.bfloat16 else 0
    ctx = ppr * page
    c = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32) * torch.tensor(
        1.4426950408889634, dtype=torch.float32
    )
    qf = q.float().reshape(b, hkv, g, d)
    tbl = page_table.long()
    k = k_pages[tbl].reshape(b, ctx, hkv, d).float()
    v = v_pages[tbl].reshape(b, ctx, hkv, d).float()
    lens = seq_lens.long().clamp(0, ctx)
    neg = torch.tensor(float("-inf"))
    split_state = []  # per split: (m, l, acc)
    for s in range(p.splits):
        end = torch.minimum(lens, torch.tensor((s + 1) * p.split_tokens))  # [b]
        warp_state = []
        for w in range(p.warps):
            tb = s * p.split_tokens + w * TILE_TOKENS
            pos = torch.arange(tb, tb + TILE_TOKENS)
            live = pos[None, :] < end[:, None]  # [b, 16]
            idx = pos.clamp(max=ctx - 1)
            x = torch.einsum("bngd,btnd->bngt", qf, k[:, idx]) * c
            x = torch.where(live[:, None, None, :], x, neg)
            m = x.amax(-1)  # -inf where the tile holds no live position
            pw = torch.exp2(x - torch.where(torch.isinf(m), 0.0, m)[..., None])
            if p_parts == 0:
                acc = torch.einsum("bngt,btnd->bngd", pw, v[:, idx])
            else:
                hi = pw.to(torch.bfloat16).float()
                acc = torch.einsum("bngt,btnd->bngd", hi, v[:, idx])
                if p_parts == 2:
                    lo = (pw - hi).to(torch.bfloat16).float()
                    acc = acc + torch.einsum("bngt,btnd->bngd", lo, v[:, idx])
            warp_state.append((m, pw.sum(-1), acc))
        split_state.append(_merge(warp_state))
    # a dead split (past the length) has m = -inf and weighs 0, as the
    # kernel's merge skips it
    m, l, acc = _merge(split_state)
    out = acc / l[..., None]
    lse = (m + torch.log2(l)) * math.log(2.0)
    empty = (lens == 0)[:, None, None]
    out = torch.where(empty[..., None], 0.0, out)
    lse = torch.where(empty, neg, lse)
    out = out.reshape(b, h, d).to(out_dtype or q.dtype)
    return out, lse.reshape(b, h)


def _merge(states):
    """``(m, l, acc)`` of several online-softmax states (base 2) merged, as
    the kernel merges its warps and its splits; a state with ``m = -inf``
    weighs 0."""
    mx = torch.stack([m for m, _, _ in states]).amax(0)
    safe = torch.where(torch.isinf(mx), 0.0, mx)
    l = sum(sl * torch.exp2(sm - safe) for sm, sl, _ in states)
    acc = sum(sa * torch.exp2(sm - safe)[..., None] for sm, _, sa in states)
    return mx, l, acc
