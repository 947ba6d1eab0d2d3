"""CUDA kernel: the selective scan (Mamba-1 style, diagonal ``A``).

Replaces the TPU kernel ``mamba_scan`` in ``src/repro/kernels/mamba_scan.py``
(``_mamba_kernel``), whose grid ran (batch, 128-channel block) with a
``[block_d, N]`` state in VMEM and a sequential time loop.  The port's model
calls it where the reference's ``mamba_block`` calls its chunked jnp scan
(``models/layers.py``), so every Mamba layer of ``forward`` runs it.

What bounds it: the larger of bytes (``delta``, ``x`` and ``y`` at
``[B, L, D]``, ``B`` and ``C`` at ``[B, L, N]``, ``A`` and the final state)
and exponentials (``B * L * D * N`` on the special-function units); above
both sits the issue rate of the state update's arithmetic, about 13
instructions a state and step (``csrc/mamba_scan.cu``).

Design, chosen per shape by ``plan``: every (channel, state) pair is a
chain of its own, ``states`` of them in each of ``lanes`` adjacent threads
of a channel (lane ``j`` holds states ``j * states .. + states - 1``), and
enough channels a CTA, and CTAs, that both prefill shapes hold about 31-39
warps an SM in one even wave.  Time runs in chunks of ``chunk`` steps:
while a CTA steps chunk k from shared memory in f32, its threads convert
chunk k + 1 into the other f32 buffer and ``cp.async`` copies chunk k + 2
into a landing slot.  Each lane keeps its partial ``y`` of 8 steps in
shared memory and its warp sums the channel's lanes once for the 8; the
state update rounds as the plain version's tensor operations do (``expf``,
no fused multiply-add).  Any ``L`` and ``D`` are taken (tails masked),
``N`` up to 64.

Contract: ``mamba_scan(delta [B, L, D] f32, A [D, N] f32, Bmat, C
[B, L, N], x [B, L, D]) -> (y [B, L, D] f32, h_last [B, D, N] f32)``;
``Bmat``, ``C`` and ``x`` share one dtype, float32 or bfloat16, cast to f32
inside as the TPU kernel casts them.  The TPU kernel returned ``y`` alone;
``h_last`` is the state after the last step (zeros when ``L = 0``).

The plain version is ``repro_torch.kernels.ref.mamba_scan_ref``;
``lane_scan`` is the kernel's decomposition written in torch, for the
tests.  The dispatch, build and launch count are in ``kernels/ops.py``; the
source is ``csrc/mamba_scan.cu``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import torch

from repro_torch.kernels.node_search import check
from repro_torch.kernels.paged_attention import DTYPES
from repro_torch.kernels.ref import mamba_scan_ref  # noqa: F401  (plain version)

_P = ctypes.c_void_p
MAX_STATE = 64

# The kernel's constants (``csrc/mamba_scan.cu``, read back by
# tests/test_torch_mamba_plan.py).
GROUP = 8  # steps a warp sums its lanes' partial y for at once
PART_STRIDE = 36  # floats a row of a warp's partial-y tile: 32 lanes + 4
MAX_CHUNK = 64  # steps a chunk holds at most
SMEM_LIMIT = 232_448  # shared bytes a CTA may use on an H100
#: states a lane -> (most threads a CTA, fewest CTAs an SM): the launch
#: bounds each instantiation is compiled with, so its registers a thread
BOUNDS = {1: (512, 2), 2: (512, 2), 4: (640, 2), 8: (384, 2)}
#: (states a lane, threads a channel) pairs the source instantiates: at
#: least four states a channel (a thread copies four elements at a time)
INSTANTIATED = frozenset(
    [(s, lp) for s in (1, 2, 4) for lp in (1, 2, 4, 8, 16) if s * lp >= 4] + [(8, 8)]
)

# An H100 SM (the card the plan sizes for).
SM_SMEM = 233_472  # shared bytes an SM, 1,024 of them reserved for each CTA
CTA_RESERVED = 1_024
SM_REGS = 65_536
SM_WARPS = 64
SM_CTAS = 32
#: the default plan takes the fewest threads a channel that still give the
#: card this many warps an SM (or, if none does, the most threads a channel)
TARGET_WARPS = 24
CHUNKS = tuple(range(MAX_CHUNK, GROUP, -GROUP))  # 64, 56, ..., 16


def regs(states: int) -> int:
    """Registers a thread that ``BOUNDS[states]`` leave: the SM's 65,536
    over the threads of the fewest CTAs an SM, in whole 8s."""
    threads, ctas = BOUNDS[states]
    return min(255, SM_REGS // (threads * ctas) // 8 * 8)


def smem_bytes(chunk: int, channels: int, padded: int, item: int, warps: int) -> int:
    """Dynamic shared bytes of a CTA, as ``csrc/mamba_scan.cu`` lays them
    out: the landing slot of a raw chunk (``delta`` f32 and ``x``
    ``[chunk][channels]``, ``B`` and ``C`` ``[chunk][padded]``, ``item``
    bytes an element; each part rounded up to 16 bytes), two buffers of a
    chunk in f32 (``(delta, delta * x)`` pairs ``[chunk][channels]``,
    ``(B, C)`` pairs ``[chunk][padded]``), and each warp's two partial-y
    tiles ``[GROUP][PART_STRIDE]``."""

    def r16(v):
        return -(-v // 16) * 16

    raw = r16(chunk * channels * 4) + r16(chunk * channels * item) + 2 * r16(chunk * padded * item)
    return (raw + 2 * (chunk * channels * 8 + chunk * padded * 8)
            + warps * 2 * GROUP * PART_STRIDE * 4)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one launch runs: ``lanes`` threads a channel with ``states``
    states each (``lanes * states >= N``; the states past ``N`` are
    zeros), ``channels`` channels of one batch element a CTA, ``ctas`` CTAs,
    ``chunk`` steps a chunk (one chunk steps while the next is converted
    to f32 and the one after lands); ``regs`` registers a
    thread (the instantiation's launch bounds), ``per_sm`` CTAs on the
    busiest SM and ``resident`` CTAs an SM can hold; ``smem`` the shared
    bytes a CTA needs with operands of ``item`` bytes (``x``, ``B``, ``C``:
    2 for bf16, 4 for float32)."""

    lanes: int
    states: int
    channels: int
    ctas: int
    chunk: int
    regs: int
    per_sm: int
    resident: int
    smem: int
    sms: int
    item: int

    @property
    def threads(self) -> int:
        return self.channels * self.lanes

    @property
    def warps(self) -> int:
        return self.threads // 32

    @property
    def one_wave(self) -> bool:
        return self.per_sm <= self.resident

    @property
    def warps_per_sm(self) -> float:
        """Mean warps an SM while every CTA is resident."""
        return self.ctas * self.warps / self.sms

    @property
    def max_warps_per_sm(self) -> int:
        return min(self.per_sm, self.resident) * self.warps

    def smem_bytes(self, item: int) -> int:
        return smem_bytes(self.chunk, self.channels, self.lanes * self.states, item,
                          self.warps)


def _resident(threads: int, reg: int, smem: int) -> int:
    return min(SM_WARPS // (threads // 32), SM_REGS // (threads * reg),
               SM_SMEM // (smem + CTA_RESERVED), SM_CTAS)


def plan(b: int, d: int, n: int, sms: int = 132, *, item: int = 2,
         states: Optional[int] = None, chunk: Optional[int] = None) -> Plan:
    """The launch plan for ``b`` batch elements of ``d`` channels of ``n``
    states on ``sms`` SMs, with ``x``, ``B`` and ``C`` of ``item`` bytes an
    element.

    States a lane: the largest of 4, 2, 1 (``states`` overrides) whose
    ``lanes = max(4, next_pow2(n)) / states`` (at most 16) gives ``TARGET_WARPS``
    warps an SM, else the most lanes.  Channels a CTA: a multiple of 8 and
    of a warp's channels, at most the instantiation's threads, that puts the
    fewest channels on the busiest SM (ties: the larger CTA, which stages
    ``B`` and ``C`` for more channels).  Chunk: the longest multiple of 8,
    64 down to 16 steps, whose shared memory still lets an SM hold the CTAs
    it gets."""
    if not 0 < n <= MAX_STATE:
        raise ValueError(f"state width must be 1-{MAX_STATE}, got {n}")
    padded = max(4, 1 << (n - 1).bit_length())
    if states is None:
        cands = [s for s in (4, 2, 1) if padded // s <= 16]
        states = next(
            (s for s in cands if b * d * (padded // s) >= TARGET_WARPS * 32 * sms), cands[-1]
        )
    lanes = max(1, padded // states)
    if (states, lanes) not in INSTANTIATED:
        raise ValueError(f"no kernel for {states} states a lane x {lanes} lanes")
    reg = regs(states)
    unit = max(32 // lanes, 8)
    cap = min(BOUNDS[states][0] // lanes, -(-d // unit) * unit)
    best = None
    for ch in range(unit, max(cap, unit) + 1, unit):
        ctas = b * -(-d // ch)
        key = (-(-ctas // sms) * ch, -ch)
        if best is None or key < best[0]:
            best = (key, ch, ctas)
    _, ch, ctas = best
    per_sm = -(-ctas // sms)
    threads = ch * lanes
    need = min(per_sm, _resident(threads, reg, 0))
    for t in (CHUNKS if chunk is None else (chunk,)):
        smem = smem_bytes(t, ch, lanes * states, item, threads // 32)
        if smem <= SMEM_LIMIT and _resident(threads, reg, smem) >= need:
            break
    return Plan(lanes, states, ch, ctas, t, reg, per_sm,
                _resident(threads, reg, smem), smem, sms, item)


def variants(b: int, d: int, n: int, sms: int = 132, item: int = 2) -> dict:
    """The default plan and the others worth timing at a shape: every
    states-a-lane choice with a kernel, and the shortest chunk."""
    out = {"default": plan(b, d, n, sms, item=item)}
    padded = max(4, 1 << (n - 1).bit_length())
    for s in (8, 4, 2, 1):
        if (s, max(1, padded // s)) in INSTANTIATED and padded // s <= 16:
            p = plan(b, d, n, sms, item=item, states=s)
            if p != out["default"]:
                out[f"states {s}"] = p
    if out["default"].chunk > CHUNKS[-1]:
        out[f"chunk {CHUNKS[-1]}"] = plan(b, d, n, sms, item=item, chunk=CHUNKS[-1])
    return out


def bind(lib: ctypes.CDLL) -> None:
    lib.dex_mamba_scan.argtypes = [_P] * 7 + [ctypes.c_int] * 10 + [_P]
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


_SMS: dict = {}


def device_sms(device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


def launch(lib: ctypes.CDLL, delta, A, Bmat, C, x, plan: Optional[Plan] = None):
    """Launch the kernel on the current stream with ``plan`` (the default
    ``plan`` for the shape and the card when None); the outputs are
    allocated here.  The CUDA entry checks the plan and refuses one it has
    no kernel for or that does not fit."""
    validate(delta, A, Bmat, C, x)
    if delta.device.type != "cuda":
        raise ValueError(f"mamba_scan kernel needs CUDA tensors, got {delta.device}")
    b, l, d = delta.shape
    n = A.shape[1]
    p = plan or globals()["plan"](b, d, n, device_sms(delta.device), item=x.element_size())
    if p.lanes * p.states < n:
        raise ValueError(f"plan holds {p.lanes * p.states} states a channel, fewer than N = {n}")
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
        p.lanes,
        p.states,
        p.channels,
        p.chunk,
        p.smem_bytes(x.element_size()),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"mamba_scan launch failed: CUDA error {err}")
    return y, h_last


def lane_scan(delta, A, Bmat, C, x, p: Plan):
    """The kernel's decomposition in torch: the states padded with zeros to
    ``lanes * states``, lane ``j`` holding states ``j * states + s``; time in
    chunks of ``p.chunk`` steps, the last one short; each step's state
    update rounded as the plain version's (``exp(delta * A)``, then the two
    products and their sum); each lane's partial y its states' terms
    summed in order; a channel's y its lanes' partials summed as the
    kernel's warp sums them (a ``GROUP`` of steps at once): at 16 lanes two
    halves of 8 lanes, else all lanes, each summed four lanes at a time
    pairwise, then the halves added.  Returns ``(y, h_last)``."""
    delta, A, Bmat, C, x = (t.float() for t in (delta, A, Bmat, C, x))
    b, l, d = delta.shape
    n = A.shape[1]
    lp, s = p.lanes, p.states
    pad = lp * s - n
    outs = GROUP * (32 // lp)
    split = 1 if outs >= 32 else 32 // outs  # lanes that sum one y
    vals = lp // split

    def lanes_of(t):  # [..., N] -> [..., lanes, states]
        return torch.nn.functional.pad(t, (0, pad)).unflatten(-1, (lp, s))

    def lanes_sum(acc):  # [..., lanes] -> [...], in the kernel's order
        parts = []
        for sp in range(split):
            seg = acc[..., sp * vals:(sp + 1) * vals]
            tot = torch.zeros_like(seg[..., 0])
            if vals >= 4:
                for v in range(0, vals, 4):
                    tot = tot + ((seg[..., v] + seg[..., v + 1]) + (seg[..., v + 2] + seg[..., v + 3]))
            else:
                for v in range(vals):
                    tot = tot + seg[..., v]
            parts.append(tot)
        m = split // 2
        while m:
            parts = [parts[i] + parts[i ^ m] for i in range(split)]
            m //= 2
        return parts[0]

    a = lanes_of(A)  # [D, lanes, states]
    bb, cc = lanes_of(Bmat), lanes_of(C)  # [B, L, lanes, states]
    h = torch.zeros((b, d, lp, s), dtype=torch.float32, device=delta.device)
    y = torch.empty((b, l, d), dtype=torch.float32, device=delta.device)
    for t0 in range(0, l, p.chunk):
        for t in range(t0, min(t0 + p.chunk, l)):
            dt = delta[:, t, :, None, None]
            dx = dt * x[:, t, :, None, None]
            h = torch.exp(dt * a) * h + dx * bb[:, t, None]
            part = h * cc[:, t, None]
            acc = part[..., 0]
            for k in range(1, s):
                acc = acc + part[..., k]
            y[:, t] = lanes_sum(acc)
    return y, h.flatten(-2)[..., :n].contiguous()
