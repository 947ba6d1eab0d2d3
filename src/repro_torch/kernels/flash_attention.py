"""CUDA kernels: blocked prefill attention with an online softmax.

Replaces the TPU kernel ``flash_attention`` in
``src/repro/kernels/flash_attention.py``, the fused form of the model's
attention (``models/layers.py`` ``sdpa``, run by ``forward`` and by
``serve_step.prefill``).  The TPU kernel's grid ran (batch * head, q block,
kv block) with the running max, denominator and accumulator in VMEM scratch
across the sequential kv axis, skipped kv blocks wholly above the causal
diagonal, and pointed each query head at its kv head by an index map; it
asserted that the sequence lengths tile.

What bounds it: operations.  Per (query, key) pair the causal mask keeps,
``4 * D`` flops (QK^T and PV); on this card only tensor cores reach the
bf16 rate, so the bf16 kernel is built on them.  Design (bf16,
``csrc/flash_attention.cu`` ``flash_attention_wgmma``): a persistent CTA of
three warpgroups on each SM walks (batch * head, 128-row q tile) items,
causal q tiles longest first; one producer thread brings K and V tiles by
TMA into rings (3 slots up to a padded 128, 2 above) with full and empty
mbarriers, K a tile ahead of V, and q once per item, so loads overlap the
products and the previous item's epilogue; two consumer warpgroups of 64
rows each start S_t = Q K_t^T and, behind it, O += P_{t-1} V_{t-1} as
``wgmma`` (f32 accumulators in registers, P fed from registers), run the
softmax of S_t (``ex2``, maxima by shuffles) while that product is in
flight, and take turns with each other to start them.  P is split into two
bf16 parts (hi and its rounding error) so that it keeps about 17 bits:
hi alone moved outputs of minitron-4b's prefill by a bf16 step beyond the
2e-2 tolerance.  The head dim is padded to a multiple of 64 by the tensor
maps' zero fill, not by a copy (D = 80 runs as 128: 37.5% of its products
are padding).  float32 stays on CUDA cores (``flash_attention_f32``: 64-row tiles staged in
shared memory, ``fmaf``): on tensor cores it would run as TF32, about
three decimal digits, which the f32 tolerance (1e-4) and the float32 gates
refuse.  ``plan`` picks the kernel and its tiles by dtype and head dim;
the C entry checks that the plan names a kernel it has.

Contract (the TPU kernel's): ``flash_attention(q [B, H, Sq, D], k, v
[B, HKV, Sk, D], causal=True, scale=None) -> [B, H, Sq, D]`` in q's dtype
(float32 or bfloat16), f32 accumulation inside, causal offset ``Sk - Sq``;
D a multiple of 8 up to 256; any Sq and Sk.  A row that no key may reach
(causal with Sk < Sq) is 0 (NaN in the plain version).  Asked for it,
either kernel also writes each row's natural log-sum-exp, ``lse [B, H,
Sq]`` f32 (``-inf`` for a row no key reaches): the bf16 kernel's softmax
runs in base 2, so it stores ``(m2 + log2 l) ln 2``; without the pointer
it writes nothing more, so serving does not pay for it.

The backward (``csrc/flash_attention_bwd.cu``, ``launch_bwd``) replaces no
TPU kernel: the reference has no backward Pallas kernel and trains through
its jnp ``sdpa``, which XLA differentiates, but here the attention is the
kernel, so its gradient is a kernel too.  What bounds it: operations,
``10 D`` flops a kept (query, key) pair and head (S recomputed, dV, dP,
dQ, dK); the design executes ``14 D`` (the dQ pass recomputes S and dP).
Design: a pre-pass writes ``Delta = rowsum(dO o O)`` and the base-2
log-sum-exp a row; then two persistent bf16 kernels of three warpgroups, in
the forward's style (``bwd_dkdv_wgmma``, ``bwd_dq_wgmma``).  A producer
warpgroup brings tiles by TMA into a ring of mbarrier-guarded slots; two
consumer warpgroups of 64 rows each run the products as ``wgmma`` (SS for
S and dP, RS with P or dS from registers for dV, dK and dQ).  dK / dV
takes (128-key tile, batch * kv head) items, holds K and V and streams the
group's G query heads' 64-row Q and dO tiles (with their lse and Delta);
dQ takes (128-row q tile, batch * head) items, holds Q and dO and streams
64-key K and V tiles up to the causal diagonal.  Each output element is
summed by one warpgroup in a fixed order, with no atomics, so two launches
are bit-equal (the remat recompute of a block relies on this).  float32
runs on CUDA cores.  Head dims 64, 80, 96 and 128 (80 and 96 padded to 128
in the dV, dK and dQ products by the tensor maps' zero fill); causal
(offset ``Sk - Sq``) or not; any G, Sq and Sk.  ``plan_bwd`` gives the
tiles; the C entry ``dex_flash_attention_bwd_plan`` checks that they name
a kernel it has.

The plain version is ``repro_torch.kernels.ref.flash_attention_ref``; the
dispatch, build and launch count are in ``kernels/ops.py``; the source is
``csrc/flash_attention.cu`` (with ``csrc/wgmma.cuh`` and ``csrc/tma.cuh``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import torch

from repro_torch.kernels.node_search import check
from repro_torch.kernels.paged_attention import DTYPES, MAX_HEAD_DIM
from repro_torch.kernels.ref import flash_attention_ref  # noqa: F401  (plain version)

_P = ctypes.c_void_p

#: q rows a CTA of the bf16 kernel: two consumer warpgroups of 64 (wgmma's M)
BLOCK_Q = 128
#: shared memory a CTA may use on an H100 (227 KB)
SMEM_LIMIT = 232_448
#: the bf16 kernel's shared bytes beyond its tiles: 1024-byte alignment of
#: the swizzled tiles, and the mbarriers
_SLACK = 1024 + 128
#: head dims the backward kernel is built for
BWD_HEAD_DIMS = (64, 80, 96, 128)
#: rows of a backward item (keys of a dK / dV CTA, q rows of a dQ CTA), of
#: each of its two consumer warpgroups (wgmma's M), and of a ring slot (q
#: rows for dK / dV, keys for dQ); the slots of the ring; the buffers of an
#: item's held tiles (K and V, or Q and dO), two so that the next item's
#: tiles load under this one's last products and epilogue
BWD_BLOCK, BWD_CONSUMER_ROWS, BWD_STEP, BWD_STAGES, BWD_HOLD = 128, 64, 64, 3, 2
#: the CPU path's dtypes: the kernel's, and float64 for ``gradcheck``
CPU_DTYPES = (*DTYPES, torch.float64)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one launch runs: the kernel (``route``), the head dim it computes
    at, the q and kv rows of a tile, the stages of its K / V ring and its
    dynamic shared memory in bytes."""

    route: str  # "wgmma" (bf16, tensor cores) or "cuda-cores" (float32)
    padded_d: int
    block_q: int
    block_kv: int
    stages: int
    smem_bytes: int


def plan(d: int, dtype: torch.dtype) -> Plan:
    """The launch plan for head dim ``d`` (a multiple of 8 up to 256).
    bfloat16: D padded to a multiple of 64 (TMA boxes of 128 bytes); up to a
    padded 128, kv tiles of 128 rows in three ring slots (three ran faster
    than two on the card, most at D = 80), above it 64 rows in two, so q,
    the K and V rings and the barriers fit in shared memory.  float32: the CUDA-core
    kernel's 64-row tiles staged in shared memory as f32."""
    if dtype == torch.float32:
        smem = 4 * (2 * 64 * (d + 1) + 64 * d + 64 * 65)
        return Plan("cuda-cores", d, 64, 64, 1, smem)
    dp = -(-d // 64) * 64
    bn, stages = (128, 3) if dp <= 128 else (64, 2)
    smem = BLOCK_Q * dp * 2 + 2 * stages * bn * dp * 2 + _SLACK
    return Plan("wgmma", dp, BLOCK_Q, bn, stages, smem)


@dataclasses.dataclass(frozen=True)
class PlanBwd:
    """How one backward launch runs: the kernels (``route``), the head dim
    their dV, dK and dQ products run at, the rows of an item and of each
    consumer warpgroup's tile, the rows of a ring slot, the slots, and each
    pass's dynamic shared memory in bytes.  ``padding`` is the share of the
    executed work spent on padded columns: S and dP in both passes run over
    the true D (``8 D`` a pair), dV, dK and dQ over ``padded_d`` (``6
    padded_d``)."""

    route: str  # "wgmma" (bf16, tensor cores) or "cuda-cores" (float32)
    padded_d: int
    block_rows: int
    consumer_rows: int
    step_rows: int
    stages: int
    smem_dkdv: int
    smem_dq: int
    padding: float


def plan_bwd(d: int, dtype: torch.dtype) -> PlanBwd:
    """The backward's launch plan at head dim ``d`` (one of
    ``BWD_HEAD_DIMS``).  bfloat16: D padded to a multiple of 64 (a TMA box
    is 128 bytes); dK / dV holds its 128 keys' K and V (two buffers) and a
    ring of Q, dO and 64 lse and Delta values a slot; dQ holds its 128
    rows' Q and dO (two buffers) and a ring of K and V.  float32: the CUDA-core kernels' 64-row tiles, staged
    in shared memory as f32."""
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd takes head dims {BWD_HEAD_DIMS}, got {d}")
    if dtype == torch.float32:
        dkdv = 4 * (4 * 64 * (d + 1) + 2 * 64 * 65 + 2 * 64)
        dq = 4 * (4 * 64 * (d + 1) + 64 * 65)
        return PlanBwd("cuda-cores", d, 64, 64, 64, 1, dkdv, dq, 0.0)
    dp = -(-d // 64) * 64
    big, small = BWD_BLOCK * dp * 2, BWD_STEP * dp * 2
    dkdv = BWD_HOLD * 2 * big + BWD_STAGES * (2 * small + 2 * BWD_STEP * 4) + _SLACK
    dq = BWD_HOLD * 2 * big + BWD_STAGES * 2 * small + _SLACK
    padding = 1 - 14 * d / (8 * d + 6 * dp)
    return PlanBwd("wgmma", dp, BWD_BLOCK, BWD_CONSUMER_ROWS, BWD_STEP, BWD_STAGES, dkdv, dq,
                   padding)


def bind(lib: ctypes.CDLL) -> None:
    lib.dex_flash_attention.argtypes = (
        [_P] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float] + [ctypes.c_int] * 5 + [_P]
    )
    lib.dex_flash_attention.restype = ctypes.c_int
    lib.dex_flash_attention_bwd.argtypes = (
        [_P] * 11 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, _P]
    )
    lib.dex_flash_attention_bwd.restype = ctypes.c_int
    lib.dex_flash_attention_bwd_plan.argtypes = [ctypes.c_int] * 8
    lib.dex_flash_attention_bwd_plan.restype = ctypes.c_int


def validate(q, k, v, dtypes=DTYPES) -> None:
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention takes q [B, H, Sq, D] and k, v [B, HKV, Sk, D]")
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if q.dtype not in dtypes:
        names = " or ".join(str(t).removeprefix("torch.") for t in dtypes)
        raise ValueError(f"q must be {names}, got {q.dtype}")
    if d % 8 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be a multiple of 8 up to 256, got {d}")
    if hkv == 0 or h % hkv:
        raise ValueError(f"{h} query heads are not a multiple of {hkv} kv heads")
    if b * h > 65_535:
        raise ValueError(f"batch x heads must be at most 65,535, got {b * h}")
    # the bf16 kernel's tensor maps need 16-byte aligned bases
    tma = q.dtype == torch.bfloat16
    check(q, "q", q.dtype, (b, h, sq, d), rows=tma)
    check(k, "k", q.dtype, (b, hkv, sk, d), rows=tma)
    check(v, "v", q.dtype, (b, hkv, sk, d), rows=tma)
    for t in (k, v):
        if t.device != q.device:
            raise ValueError("flash_attention inputs must lie on one device")


def _check_err(err: int, what: str) -> None:
    if err < 0:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled refused a map: {-err}")
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    with torch.cuda.device(t.device):
        return torch.cuda.current_stream().cuda_stream


def launch(lib: ctypes.CDLL, q, k, v, causal: bool, scale: Optional[float],
           with_lse: bool = False):
    """Launch the kernel on the current stream; the output (and, with
    ``with_lse``, the log-sum-exp ``[B, H, Sq]`` f32) is allocated here."""
    validate(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got {q.device}")
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    p = plan(d, q.dtype)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if with_lse else None
    err = lib.dex_flash_attention(
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        DTYPES[q.dtype],
        b,
        h,
        hkv,
        sq,
        sk,
        d,
        1.0 / math.sqrt(d) if scale is None else float(scale),
        int(causal),
        p.padded_d,
        p.block_kv,
        p.stages,
        p.smem_bytes,
        _stream(q),
    )
    _check_err(err, "flash_attention")
    return out if lse is None else (out, lse)


def validate_bwd(q, k, v, o, do, lse, dtypes=DTYPES) -> None:
    """The backward's operands: the forward's q, k, v (``validate``), its
    output ``o`` and the output's gradient ``do`` like q, and ``lse`` [B, H,
    Sq] (f32, or float64 beside float64 operands on the CPU)."""
    validate(q, k, v, dtypes)
    b, h, sq, d = q.shape
    tma = q.dtype == torch.bfloat16
    check(o, "o", q.dtype, (b, h, sq, d), rows=tma)
    check(do, "do", q.dtype, (b, h, sq, d), rows=tma)
    want = torch.float64 if q.dtype == torch.float64 else torch.float32
    check(lse, "lse", want, (b, h, sq))
    for t in (o, do, lse):
        if t.device != q.device:
            raise ValueError("flash_attention_bwd inputs must lie on one device")


def launch_bwd(lib: ctypes.CDLL, q, k, v, o, do, lse, causal: bool,
               scale: Optional[float]):
    """Launch the backward on the current stream: ``(dq, dk, dv)`` like q,
    k, v, and the pre-pass's scratch (Delta and the base-2 log-sum-exp, [B,
    H, Sq] f32 each), are allocated here.  Raises on a head dim outside
    ``BWD_HEAD_DIMS``, or where the library has no kernel for the plan."""
    validate_bwd(q, k, v, o, do, lse)
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    p = plan_bwd(d, q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd kernel needs CUDA tensors, got {q.device}")
    err = lib.dex_flash_attention_bwd_plan(
        DTYPES[q.dtype], d, p.padded_d, p.block_rows, p.step_rows, p.stages, p.smem_dkdv,
        p.smem_dq,
    )
    _check_err(err, "flash_attention_bwd plan")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    scratch = torch.empty((2, b, h, sq), dtype=torch.float32, device=q.device)
    err = lib.dex_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        scratch[0].data_ptr(), scratch[1].data_ptr(),
        DTYPES[q.dtype], b, h, hkv, sq, sk, d,
        1.0 / math.sqrt(d) if scale is None else float(scale), int(causal), _stream(q),
    )
    _check_err(err, "flash_attention_bwd")
    return dq, dk, dv
