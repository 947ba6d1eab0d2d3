"""CUDA kernel: decode attention over KV pages through a page table.

Replaces the TPU kernel ``paged_attention`` in
``src/repro/kernels/paged_attention.py``, the data-plane consumer of the DEX
page table (``serve/kv_cache.py``): one query token per request attends over
the request's tokens, stored in fixed-size pages that ``page_table[b, p]``
names, with positions at or past ``seq_lens[b]`` masked.  The TPU kernel's
grid ran (request, kv head, page) with the table prefetched as scalars, so
each page's block index dereferenced the table, and carried the online
softmax across the page axis in VMEM scratch.  Hopper's blocks run in no
order, so one CTA owns one (request, kv head) and walks the pages itself.

What bounds it: bytes.  The call must read the live tokens' K and V rows
(``sum_b seq_len_b * HKV * D * 2 * itemsize``), q, the table entries it uses
and ``seq_lens``, and write the output; the math is 4 flops per query head
per element read.  Design: the G = H / HKV query heads of a kv head live in
one CTA, so a K or V row is read once for all of them; a subgroup of lanes
holds a row, 16 bytes a lane in bf16, and takes every n-th token (the next
token's rows loaded before the current one is used); an online softmax per
subgroup in f32, merged with shuffles and then through shared memory.  No
split over the sequence and no TMA yet, so a short request leaves most of
the card idle.

Contract (the TPU kernel's): ``paged_attention(q [B, H, D], k_pages
[P, page, HKV, D], v_pages, page_table [B, ppr] int32, seq_lens [B] int32)
-> [B, H, D]`` in q's dtype (float32 or bfloat16), f32 inside; D a multiple
of 8 up to 256, G up to 8.  ``seq_len = 0`` gives zeros (the plain version
gives NaN; the decode step's ``nan_to_num`` makes the two agree).

The plain version is ``repro_torch.kernels.ref.paged_attention_ref``; the
dispatch, build and launch count are in ``kernels/ops.py``; the source is
``csrc/paged_attention.cu``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.node_search import check
from repro_torch.kernels.ref import paged_attention_ref  # noqa: F401  (plain version)

_P = ctypes.c_void_p
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP = 8
MAX_HEAD_DIM = 256


def bind(lib: ctypes.CDLL) -> None:
    lib.dex_paged_attention.argtypes = [_P] * 6 + [ctypes.c_int] * 8 + [
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
        raise ValueError(f"{h} query heads over {hkv} kv heads: group must be 1-8")
    check(q, "q", q.dtype, (b, h, d), rows=True)
    check(k_pages, "k_pages", q.dtype, (n_pages, page, hkv, d), rows=True)
    check(v_pages, "v_pages", q.dtype, (n_pages, page, hkv, d), rows=True)
    check(page_table, "page_table", torch.int32, (b, page_table.shape[-1]))
    check(seq_lens, "seq_lens", torch.int32, (b,))
    for t in (k_pages, v_pages, page_table, seq_lens):
        if t.device != q.device:
            raise ValueError("paged_attention inputs must lie on one device")


def launch(lib: ctypes.CDLL, q, k_pages, v_pages, page_table, seq_lens):
    """Launch the kernel on the current stream; the output is allocated
    here."""
    validate(q, k_pages, v_pages, page_table, seq_lens)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention kernel needs CUDA tensors, got {q.device}")
    b, h, d = q.shape
    _, page, hkv, _ = k_pages.shape
    g = h // hkv
    # eight warps where the merge buffer fits the default 48 KB, else four
    nwarps = 8 if 8 * g * (2 + d) * 4 <= 48 * 1024 else 4
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib.dex_paged_attention(
        q.data_ptr(),
        k_pages.data_ptr(),
        v_pages.data_ptr(),
        page_table.data_ptr(),
        seq_lens.data_ptr(),
        out.data_ptr(),
        DTYPES[q.dtype],
        b,
        hkv,
        g,
        d,
        page,
        page_table.shape[1],
        nwarps,
        1.0 / math.sqrt(d),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {err}")
    return out
