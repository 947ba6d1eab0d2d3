"""CUDA kernel: the selective scan (Mamba-1 style, diagonal ``A``).

Replaces the TPU kernel ``mamba_scan`` in ``src/repro/kernels/mamba_scan.py``
(``_mamba_kernel``), whose grid ran (batch, 128-channel block) with a
``[block_d, N]`` state in VMEM and a sequential time loop.  The port's model
calls it where the reference's ``mamba_block`` calls its chunked jnp scan
(``models/layers.py``), so every Mamba layer of ``forward`` runs it.

What bounds it: the larger of bytes (``delta``, ``x`` and ``y`` at
``[B, L, D]``, ``B`` and ``C`` at ``[B, L, N]``, ``A`` and the final state)
and exponentials (``B * L * D * N`` on the special-function units).
Design: one CTA of ``32 * lanes`` threads per (32 channels, batch element);
a channel's ``N`` states sit in the registers of ``lanes`` adjacent threads
(4 unless the caller of ``launch`` asks for 1 or 16), summed for ``y_t``
with warp shuffles; 32 time steps of ``delta``, ``x``, ``B`` and ``C`` are
staged in shared memory at a time; the state update rounds as the plain
version's tensor operations do (``expf``, no fused multiply-add).  Any
``L`` and ``D`` are taken (tails masked), ``N`` up to 64.

Contract: ``mamba_scan(delta [B, L, D] f32, A [D, N] f32, Bmat, C
[B, L, N], x [B, L, D]) -> (y [B, L, D] f32, h_last [B, D, N] f32)``;
``Bmat``, ``C`` and ``x`` share one dtype, float32 or bfloat16, cast to f32
inside as the TPU kernel casts them.  The TPU kernel returned ``y`` alone;
``h_last`` is the state after the last step (zeros when ``L = 0``).

The plain version is ``repro_torch.kernels.ref.mamba_scan_ref``; the
dispatch, build and launch count are in ``kernels/ops.py``; the source is
``csrc/mamba_scan.cu``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.node_search import check
from repro_torch.kernels.paged_attention import DTYPES
from repro_torch.kernels.ref import mamba_scan_ref  # noqa: F401  (plain version)

_P = ctypes.c_void_p
MAX_STATE = 64
LANES = (1, 4, 16)
DEFAULT_LANES = 4


def bind(lib: ctypes.CDLL) -> None:
    lib.dex_mamba_scan.argtypes = [_P] * 7 + [ctypes.c_int] * 6 + [_P]
    lib.dex_mamba_scan.restype = ctypes.c_int


def validate(delta, A, Bmat, C, x) -> None:
    if delta.dim() != 3 or A.dim() != 2:
        raise ValueError("mamba_scan takes delta, x [B, L, D], A [D, N] and B, C [B, L, N]")
    b, l, d = delta.shape
    n = A.shape[1]
    if not 0 < n <= MAX_STATE:
        raise ValueError(f"state width must be 1-{MAX_STATE}, got {n}")
    if b > 65_535:
        raise ValueError(f"batch must be at most 65,535, got {b}")
    if x.dtype not in DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    check(delta, "delta", torch.float32, (b, l, d))
    check(A, "A", torch.float32, (d, n))
    check(Bmat, "Bmat", x.dtype, (b, l, n))
    check(C, "C", x.dtype, (b, l, n))
    check(x, "x", x.dtype, (b, l, d))
    for t in (A, Bmat, C, x):
        if t.device != delta.device:
            raise ValueError("mamba_scan inputs must lie on one device")


def launch(lib: ctypes.CDLL, delta, A, Bmat, C, x, lanes: Optional[int] = None):
    """Launch the kernel on the current stream with ``lanes`` threads a
    channel (``DEFAULT_LANES`` when None); the outputs are allocated
    here."""
    validate(delta, A, Bmat, C, x)
    if delta.device.type != "cuda":
        raise ValueError(f"mamba_scan kernel needs CUDA tensors, got {delta.device}")
    b, l, d = delta.shape
    n = A.shape[1]
    lanes = DEFAULT_LANES if lanes is None else lanes
    if lanes not in LANES or n > 16 * lanes:
        raise ValueError(f"lanes must be one of {LANES} with N <= 16 * lanes, got {lanes}")
    y = torch.empty((b, l, d), dtype=torch.float32, device=delta.device)
    h_last = torch.empty((b, d, n), dtype=torch.float32, device=delta.device)
    with torch.cuda.device(delta.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib.dex_mamba_scan(
        delta.data_ptr(),
        A.data_ptr(),
        Bmat.data_ptr(),
        C.data_ptr(),
        x.data_ptr(),
        y.data_ptr(),
        h_last.data_ptr(),
        DTYPES[x.dtype],
        b,
        l,
        d,
        n,
        lanes,
        stream,
    )
    if err != 0:
        raise RuntimeError(f"mamba_scan launch failed: CUDA error {err}")
    return y, h_last
