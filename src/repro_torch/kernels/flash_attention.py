"""CUDA kernel: blocked prefill attention with an online softmax.

Replaces the TPU kernel ``flash_attention`` in
``src/repro/kernels/flash_attention.py``, the fused form of the model's
attention (``models/layers.py`` ``sdpa``, run by ``forward`` and by
``serve_step.prefill``).  The TPU kernel's grid ran (batch * head, q block,
kv block) with the running max, denominator and accumulator in VMEM scratch
across the sequential kv axis, skipped kv blocks wholly above the causal
diagonal, and pointed each query head at its kv head by an index map; it
asserted that the sequence lengths tile.

What bounds it: operations.  Per (query, key) pair the causal mask keeps,
``4 * D`` flops (QK^T and PV), against the card's dense bf16 peak.  Design:
one CTA of 256 threads per (batch * head, 64-row q tile); the q tile is
staged once in shared memory, pre-scaled; 64-row K and V tiles are staged
per step and tiles above the diagonal are never visited; each thread owns a
4 x 4 block of scores and a 4 x D/16 block of the output, in f32 on CUDA
cores.  The kv head is ``h // (H // HKV)``.  Any Sq and Sk are taken: the
tail tiles are masked.  No tensor cores yet (wgmma and TMA are later work),
so it runs far above its bound.

Contract (the TPU kernel's): ``flash_attention(q [B, H, Sq, D], k, v
[B, HKV, Sk, D], causal=True, scale=None) -> [B, H, Sq, D]`` in q's dtype
(float32 or bfloat16), f32 inside, causal offset ``Sk - Sq``; D a multiple
of 8 up to 256.  A row that no key may reach (causal with Sk < Sq) is 0
(NaN in the plain version).

The plain version is ``repro_torch.kernels.ref.flash_attention_ref``; the
dispatch, build and launch count are in ``kernels/ops.py``; the source is
``csrc/flash_attention.cu``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels.node_search import check
from repro_torch.kernels.paged_attention import DTYPES, MAX_HEAD_DIM
from repro_torch.kernels.ref import flash_attention_ref  # noqa: F401  (plain version)

_P = ctypes.c_void_p


def bind(lib: ctypes.CDLL) -> None:
    lib.dex_flash_attention.argtypes = [_P] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_float,
        ctypes.c_int,
        _P,
    ]
    lib.dex_flash_attention.restype = ctypes.c_int


def validate(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention takes q [B, H, Sq, D] and k, v [B, HKV, Sk, D]")
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if q.dtype not in DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if d % 8 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be a multiple of 8 up to 256, got {d}")
    if hkv == 0 or h % hkv:
        raise ValueError(f"{h} query heads are not a multiple of {hkv} kv heads")
    if b * h > 65_535:
        raise ValueError(f"batch x heads must be at most 65,535, got {b * h}")
    check(q, "q", q.dtype, (b, h, sq, d))
    check(k, "k", q.dtype, (b, hkv, sk, d))
    check(v, "v", q.dtype, (b, hkv, sk, d))
    for t in (k, v):
        if t.device != q.device:
            raise ValueError("flash_attention inputs must lie on one device")


def launch(lib: ctypes.CDLL, q, k, v, causal: bool, scale: Optional[float]):
    """Launch the kernel on the current stream; the output is allocated
    here."""
    validate(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got {q.device}")
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib.dex_flash_attention(
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        out.data_ptr(),
        DTYPES[q.dtype],
        b,
        h,
        hkv,
        sq,
        sk,
        d,
        1.0 / math.sqrt(d) if scale is None else float(scale),
        int(causal),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    return out
