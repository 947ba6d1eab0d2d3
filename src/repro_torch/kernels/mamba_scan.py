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

With ``with_states`` the forward also writes the state before every
``SAVE_EVERY``-th step, ``[B, ceil(L / SAVE_EVERY), D, N]`` f32, for the
backward.

The backward (``csrc/mamba_scan_bwd.cu``; no TPU kernel: the reference
trains through a jnp chunked scan): ``mamba_scan_bwd(delta, A, Bmat, C, x,
dy, dh_last, states) -> (ddelta [B, L, D], dA [D, N], dB, dC [B, L, N],
dx [B, L, D])``, all f32, from the output gradient ``dy`` [B, L, D] f32,
the final state's ``dh_last`` [B, D, N] f32 (or none) and the forward's
saved states.  What bounds it: the larger of bytes (the forward's
operands, ``dy``, ``dh_last`` and the five gradients) and ``B * L * D *
N`` exponentials; above both, the issue rate of the arithmetic.  It
computes each exponential once: every sub-block of ``BWD_SUB`` steps is
refilled from the state the forward kept before it.  Its plan is
``plan_bwd``: the lanes and states the forward's rule picks,
``BWD_THREADS`` threads a CTA, the CTAs along ``D`` in clusters of up to
``BWD_CLUSTER`` that add their ``dB`` and ``dC`` through distributed
shared memory, so that only one partial a cluster leaves the chip.

The plain versions are ``repro_torch.kernels.ref.mamba_scan_ref`` and
``mamba_scan_bwd_ref``; ``lane_scan`` and ``lane_scan_bwd`` are the
kernels' decompositions written in torch, for the tests.  The dispatch,
build and launch counts are in ``kernels/ops.py``; the sources are
``csrc/mamba_scan.cu`` and ``csrc/mamba_scan_bwd.cu``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import torch

from repro_torch.kernels.node_search import check
from repro_torch.kernels.paged_attention import DTYPES
from repro_torch.kernels.ref import mamba_scan_bwd_ref, mamba_scan_ref  # noqa: F401

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
#: operand dtypes the CPU path takes: float64 too, for ``gradcheck``
CPU_DTYPES = (*DTYPES, torch.float64)

# The backward's constants (``csrc/mamba_scan_bwd.cu``; the forward's
# ``kSaveEvery`` and the backward's ``kBwdSub`` are ``SAVE_EVERY``), read
# back by tests/test_torch_mamba_bwd.py.
SAVE_EVERY = 8  # steps between the states the forward keeps: a sub-block of the backward
BWD_SUB = 8  # steps a sub-block, held in registers
BWD_THREADS = 256  # threads a CTA
BWD_CTAS = 2  # fewest CTAs an SM (launch bounds)
BWD_CLUSTER = 8  # most CTAs a cluster along D
BWD_STAGES = 3  # landing slots of sub-blocks in flight
SUM_THREADS = 256  # threads a CTA of the second launch, which adds the partials
#: clusters of each size that an H100 SXM holds at once at two backward CTAs
#: an SM (``cudaOccupancyMaxActiveClusters``, printed by chip_smoke.py phase
#: 3): a cluster's CTAs share a GPC, and 8-CTA clusters leave some of each
#: GPC's CTA slots empty.  The plan's model where it is not given the card's.
H100_ACTIVE_CLUSTERS = {1: 264, 2: 132, 4: 62, 8: 30, 16: 14}
#: (states a lane, threads a channel) pairs of the backward: at most 4
#: states a lane, at least 4 lanes a channel
BWD_INSTANTIATED = frozenset((s, lp) for s in (1, 2, 4) for lp in (4, 8, 16))


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
    lib.dex_mamba_scan.argtypes = [_P] * 8 + [ctypes.c_int] * 10 + [_P]
    lib.dex_mamba_scan.restype = ctypes.c_int
    lib.dex_mamba_scan_bwd.argtypes = [_P] * 16 + [ctypes.c_int] * 10 + [_P]
    lib.dex_mamba_scan_bwd.restype = ctypes.c_int
    lib.dex_mamba_scan_bwd_active_clusters.argtypes = [ctypes.c_int] * 4
    lib.dex_mamba_scan_bwd_active_clusters.restype = ctypes.c_int


def validate(delta, A, Bmat, C, x, dtypes=DTYPES) -> None:
    """The forward's operands; ``delta`` and ``A`` are f32 (float64 beside
    float64 operands, which only the CPU path takes)."""
    if delta.dim() != 3 or A.dim() != 2:
        raise ValueError("mamba_scan takes delta, x [B, L, D], A [D, N] and B, C [B, L, N]")
    b, l, d = delta.shape
    n = A.shape[1]
    if not 0 < n <= MAX_STATE:
        raise ValueError(f"state width must be 1-{MAX_STATE}, got {n}")
    if b > 65_535:
        raise ValueError(f"batch must be at most 65,535, got {b}")
    if x.dtype not in dtypes:
        names = " or ".join(str(t).removeprefix("torch.") for t in dtypes)
        raise ValueError(f"x must be {names}, got {x.dtype}")
    ct = state_dtype(x)
    check(delta, "delta", ct, (b, l, d))
    check(A, "A", ct, (d, n))
    check(Bmat, "Bmat", x.dtype, (b, l, n))
    check(C, "C", x.dtype, (b, l, n))
    check(x, "x", x.dtype, (b, l, d))
    for t in (A, Bmat, C, x):
        if t.device != delta.device:
            raise ValueError("mamba_scan inputs must lie on one device")


def state_dtype(x) -> torch.dtype:
    """The dtype of ``delta``, ``A``, the outputs and the gradients:
    float64 beside float64 operands, else float32."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def saves(l: int) -> int:
    """States the forward keeps for the backward: one before every
    ``SAVE_EVERY``-th step."""
    return -(-l // SAVE_EVERY)


def validate_bwd(delta, A, Bmat, C, x, dy, dh_last=None, states=None, dtypes=DTYPES) -> None:
    """The backward's operands: the forward's (``validate``), ``dy`` like
    ``delta``, ``dh_last`` [B, D, N] like it or None, and the forward's
    saved ``states`` [B, ceil(L / SAVE_EVERY), D, N] f32 or None."""
    validate(delta, A, Bmat, C, x, dtypes)
    b, l, d = delta.shape
    n = A.shape[1]
    ct = state_dtype(x)
    check(dy, "dy", ct, (b, l, d))
    if dh_last is not None:
        check(dh_last, "dh_last", ct, (b, d, n))
    if states is not None:
        check(states, "states", torch.float32, (b, saves(l), d, n))
    for t in (dy, dh_last, states):
        if t is not None and t.device != delta.device:
            raise ValueError("mamba_scan_bwd inputs must lie on one device")


_SMS: dict = {}


def device_sms(device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


def launch(lib: ctypes.CDLL, delta, A, Bmat, C, x, plan: Optional[Plan] = None, *,
           with_states: bool = False):
    """Launch the kernel on the current stream with ``plan`` (the default
    ``plan`` for the shape and the card when None); the outputs are
    allocated here.  The CUDA entry checks the plan and refuses one it has
    no kernel for or that does not fit.  ``(y, h_last)``, and with
    ``with_states`` the states kept for the backward."""
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
    states = (
        torch.empty((b, saves(l), d, n), dtype=torch.float32, device=delta.device)
        if with_states else None
    )
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
        None if states is None else states.data_ptr(),
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
    return (y, h_last, states) if with_states else (y, h_last)


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


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------


def smem_bytes_bwd(channels: int, padded: int, item: int) -> int:
    """Dynamic shared bytes of a backward CTA, as ``csrc/mamba_scan_bwd.cu``
    lays them out: ``BWD_STAGES`` landing slots of a sub-block (``delta``
    and ``dy`` f32 and ``x`` ``[BWD_SUB][channels]``, ``B`` and ``C``
    ``[BWD_SUB][padded]`` at ``item`` bytes an element, the saved states
    ``[channels][padded]`` f32; each part rounded up to 16 bytes), two f32
    buffers (``(delta, delta * x, dy, x)`` a step and channel, ``(B, C)`` a
    step and state), two of each warp's ``(dB, dC)`` tiles
    ``[BWD_SUB][2][padded]`` f32, and two buffers of the shares of a CTA's
    tile that the cluster's ranks store (a tile and ``BWD_CLUSTER``
    float4s)."""

    def r16(v):
        return -(-v // 16) * 16

    t = BWD_SUB
    slot = (2 * r16(t * channels * 4) + r16(t * channels * item) + 2 * r16(t * padded * item)
            + r16(channels * padded * 4))
    buf = t * channels * 16 + t * padded * 8
    tile = t * 2 * padded * 4
    return (BWD_STAGES * slot + 2 * buf + 2 * (BWD_THREADS // 32) * tile
            + 2 * (tile + 16 * BWD_CLUSTER))


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How one backward launch runs: ``lanes`` threads a channel with
    ``states`` states each (the states past ``N`` zeros), ``channels =
    BWD_THREADS / lanes`` channels of one batch element a CTA, ``blocks``
    CTAs along ``D`` that hold a channel, in ``clusters`` clusters of
    ``cluster`` CTAs (the last may hold CTAs with no live channel), and
    ``ctas`` CTAs in all; ``most`` the largest cluster the plan allowed,
    ``active`` the clusters of its size that the card holds at once and
    ``rounds`` the turns of them the launch takes; ``regs`` registers a
    thread (the launch bounds), ``per_sm`` CTAs on the busiest SM,
    ``resident`` CTAs an SM can hold, ``smem`` shared bytes a CTA with
    operands of ``item`` bytes."""

    lanes: int
    states: int
    channels: int
    blocks: int
    cluster: int
    clusters: int
    ctas: int
    most: int
    active: int
    rounds: int
    regs: int
    per_sm: int
    resident: int
    smem: int
    sms: int
    item: int

    @property
    def mean_per_sm(self) -> float:
        """CTAs an SM on the mean."""
        return self.ctas / self.sms

    @property
    def imbalance(self) -> float:
        """The busiest SM's CTAs over the mean's: the share of the kernel's
        SM-time a launch whose CTAs take equal time leaves idle, plus one."""
        return self.per_sm / self.mean_per_sm

    def partial_bytes(self, b: int, l: int, n: int) -> int:
        """Bytes of the ``dB`` and ``dC`` partials that leave the chip: one
        a cluster, ``[B, L, clusters, N]`` f32 each (``dA``'s ``[B, D, N]``
        come beside them)."""
        return 4 * 2 * b * l * self.clusters * n


def regs_bwd() -> int:
    """Registers a thread of the backward: the SM's 65,536 over the threads
    of its fewest CTAs, in whole 8s."""
    return min(255, SM_REGS // (BWD_THREADS * BWD_CTAS) // 8 * 8)


def bwd_clusters(d: int, channels: int, most: int = BWD_CLUSTER) -> tuple:
    """``(cluster size, clusters)`` along ``D`` for CTAs of ``channels``
    channels: as few clusters of at most ``most`` CTAs as cover the
    channels, all of one size (``csrc/mamba_scan_bwd.cu::bwd_clusters``)."""
    blocks = -(-d // channels)
    clusters = -(-blocks // most)
    return -(-blocks // clusters), clusters


def plan_bwd(b: int, d: int, n: int, sms: int = 132, *, item: int = 2,
             states: Optional[int] = None, cluster: Optional[int] = None,
             active: Optional[dict] = None) -> BwdPlan:
    """The backward's plan for ``b`` batch elements of ``d`` channels of
    ``n`` states on ``sms`` SMs, operands of ``item`` bytes: states a lane
    by the forward's rule (the largest of 4, 2, 1 that still gives
    ``TARGET_WARPS`` warps an SM, else the most lanes; ``states``
    overrides), among the pairs ``BWD_INSTANTIATED`` holds.  Clusters of at
    most ``BWD_CLUSTER``, 8, 4, 2 or 1 CTAs (``bwd_clusters``; ``cluster``
    fixes the most): the largest that takes the fewest rounds of the
    clusters the card holds at once (``active``: size -> clusters,
    ``H100_ACTIVE_CLUSTERS`` when None), since a cluster's CTAs must share a
    GPC and larger clusters leave CTA slots empty, and smaller ones write
    more partials (the tie-break toward the largest is what holds
    zamba2-2.7b's training shape to 168 MB of partials; clusters of 2 ran
    13% faster there, on an H100 SXM at 700 W).  Each SM is modelled by
    the CTAs it runs: the busiest holds ``ceil(ctas / sms)``."""
    if not 0 < n <= MAX_STATE:
        raise ValueError(f"state width must be 1-{MAX_STATE}, got {n}")
    padded = max(4, 1 << (n - 1).bit_length())
    if states is None:
        cands = [s for s in (4, 2, 1) if (s, padded // s) in BWD_INSTANTIATED]
        states = next(
            (s for s in cands if b * d * (padded // s) >= TARGET_WARPS * 32 * sms), cands[-1]
        )
    lanes = max(1, padded // states)
    if (states, lanes) not in BWD_INSTANTIATED:
        raise ValueError(f"no backward kernel for {states} states a lane x {lanes} lanes")
    ch = BWD_THREADS // lanes
    active = H100_ACTIVE_CLUSTERS if active is None else active
    best = None
    sizes = [c for c in (16, 8, 4, 2, 1) if c <= BWD_CLUSTER]
    for most in (cluster,) if cluster else sizes:
        size, clusters = bwd_clusters(d, ch, most)
        held = max(1, active.get(size, sms * BWD_CTAS // size))
        rounds = -(-b * clusters // held)
        if best is None or rounds < best[0]:
            best = (rounds, most, size, clusters, held)
    rounds, most, size, clusters, held = best
    ctas = b * size * clusters
    smem = smem_bytes_bwd(ch, lanes * states, item)
    reg = regs_bwd()
    return BwdPlan(lanes, states, ch, -(-d // ch), size, clusters, ctas, most, held, rounds,
                   reg, -(-ctas // sms), _resident(BWD_THREADS, reg, smem), smem, sms, item)


_ACTIVE: dict = {}


def device_active_clusters(lib: ctypes.CDLL, device, dtype: int, lanes: int, states: int) -> dict:
    """Clusters of each size up to ``BWD_CLUSTER`` that the card holds at
    once for ``lib``'s backward kernel of (``dtype``, ``lanes``,
    ``states``), asked of the card once."""
    key = (lib._name, device, dtype, lanes, states, BWD_CLUSTER)
    if key not in _ACTIVE:
        with torch.cuda.device(device):
            got = {c: lib.dex_mamba_scan_bwd_active_clusters(dtype, lanes, states, c)
                   for c in (1, 2, 4, 8, 16) if c <= BWD_CLUSTER}
        if min(got.values()) < 1:
            raise RuntimeError(f"mamba_scan_bwd: the card holds no cluster: {got}")
        _ACTIVE[key] = got
    return _ACTIVE[key]


def device_plan_bwd(lib: ctypes.CDLL, device, b: int, d: int, n: int, item: int,
                    cluster: Optional[int] = None) -> BwdPlan:
    """``plan_bwd`` on this card: its SMs and the clusters it holds at once
    (``cluster`` fixes the most CTAs a cluster)."""
    sms = device_sms(device)
    first = plan_bwd(b, d, n, sms, item=item)
    held = device_active_clusters(lib, device, int(item == 2), first.lanes, first.states)
    return plan_bwd(b, d, n, sms, item=item, cluster=cluster, active=held)


def launch_bwd(lib: ctypes.CDLL, delta, A, Bmat, C, x, dy, dh_last, states,
               plan: Optional[BwdPlan] = None):
    """Launch the backward on the current stream with ``plan`` (when None,
    ``plan_bwd`` with the clusters this card holds at once, asked of it
    once): ``(ddelta, dA, dB, dC, dx)``, all f32,
    allocated here with the scratch partials.  ``states`` are the ones the
    forward kept (``launch(..., with_states=True)``).  The CUDA entry
    refuses a plan it has no kernel for or that does not fit."""
    validate_bwd(delta, A, Bmat, C, x, dy, dh_last, states)
    if delta.device.type != "cuda":
        raise ValueError(f"mamba_scan_bwd kernel needs CUDA tensors, got {delta.device}")
    if states is None:
        raise ValueError("mamba_scan_bwd needs the states the forward kept (with_states=True)")
    b, l, d = delta.shape
    n = A.shape[1]
    dev = delta.device
    p = plan or device_plan_bwd(lib, dev, b, d, n, x.element_size())
    f32 = dict(dtype=torch.float32, device=dev)
    ddelta, dx = torch.empty((b, l, d), **f32), torch.empty((b, l, d), **f32)
    dB, dC = torch.empty((b, l, n), **f32), torch.empty((b, l, n), **f32)
    dA = torch.zeros((d, n), **f32)
    if b == 0 or d == 0:
        return ddelta, dA, dB, dC, dx
    da_part = torch.empty((b, d, n), **f32)
    db_part, dc_part = (torch.empty((b, l, p.clusters, n), **f32) for _ in range(2))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (delta, A, Bmat, C, x, dy)]
    ptrs += [None if dh_last is None else dh_last.data_ptr(), states.data_ptr()]
    ptrs += [t.data_ptr() for t in (ddelta, dA, dB, dC, dx, da_part, db_part, dc_part)]
    err = lib.dex_mamba_scan_bwd(
        *ptrs, DTYPES[x.dtype], b, l, d, n, p.lanes, p.states,
        smem_bytes_bwd(p.channels, p.lanes * p.states, x.element_size()), p.most, p.clusters,
        stream,
    )
    if err != 0:
        raise RuntimeError(f"mamba_scan_bwd launch failed: CUDA error {err}")
    return ddelta, dA, dB, dC, dx


def _tree(t):
    """Sum over the last dim as a butterfly of shuffles sums it: adjacent
    pairs, then pairs of pairs."""
    while t.shape[-1] > 1:
        t = t[..., 0::2] + t[..., 1::2]
    return t[..., 0]


def _in_order(t, dim):
    """Sum over ``dim`` one element after another, from the first."""
    parts = t.unbind(dim)
    acc = parts[0]
    for v in parts[1:]:
        acc = acc + v
    return acc


def lane_scan_bwd(delta, A, Bmat, C, x, dy, dh_last, p: BwdPlan):
    """The backward kernel's decomposition in torch: channels padded with
    zeros to ``clusters * cluster * channels`` and states to ``lanes *
    states``; the states each step recomputed with the forward's rounding;
    every product and sum rounded on its own as the kernel's are; the time
    loop from the last step back.  A channel's ``dx`` sum: a lane's states
    in order, then the lanes as a butterfly (the kernel's reduce-scatter
    adds the same pairs); its ``ddelta`` sum: a lane's ``g A a h`` terms in
    order plus ``x`` times the lane's ``dx`` sum, then the lanes as a
    butterfly; a state's ``dB`` and ``dC`` sums:
    the warp's channels as a butterfly, then the CTA's warps in order, then
    the cluster's CTAs in rank order, then the clusters in order; ``dA``:
    each thread's sum from the last step back, then the batch in order.
    Returns ``(ddelta, dA, dB, dC, dx)``."""
    delta, A, Bmat, C, x, dy = (t.float() for t in (delta, A, Bmat, C, x, dy))
    b, l, d = delta.shape
    n = A.shape[1]
    lp, s, ch = p.lanes, p.states, p.channels
    cpw, warps = 32 // lp, BWD_THREADS // 32
    dp, npad = p.clusters * p.cluster * ch, lp * s
    pad = torch.nn.functional.pad
    dlt, xx, gy = (pad(t, (0, dp - d)) for t in (delta, x, dy))  # [B, L, Dp]
    am = pad(A, (0, npad - n, 0, dp - d))  # [Dp, NP]
    bb, cc = pad(Bmat, (0, npad - n)), pad(C, (0, npad - n))  # [B, L, NP]
    carry = torch.zeros((b, dp, npad), dtype=torch.float32, device=delta.device)
    if dh_last is not None:
        carry = pad(dh_last.float(), (0, npad - n, 0, dp - d))
    hs = [torch.zeros_like(carry)]
    for t in range(l):
        dt = dlt[:, t, :, None]
        hs.append(torch.exp(dt * am) * hs[-1] + (dt * xx[:, t, :, None]) * bb[:, t, None])
    da = torch.zeros_like(carry)
    ddelta, dx = (torch.empty((b, l, d), dtype=torch.float32, device=delta.device)
                  for _ in range(2))
    dB, dC = (torch.empty((b, l, n), dtype=torch.float32, device=delta.device)
              for _ in range(2))

    def lane_sum(v):  # [B, Dp, NP] -> [B, Dp, lanes]
        return _in_order(v.unflatten(-1, (lp, s)), -1)

    def state_sum(v):  # [B, Dp, NP] -> [B, NP]
        # [B, clusters, ranks, warps, NP]
        warp = _tree(v.unflatten(1, (p.clusters, p.cluster, warps, cpw)).movedim(4, -1))
        return _in_order(_in_order(_in_order(warp, 3), 2), 1)

    for t in reversed(range(l)):
        dt, xt, dyt = dlt[:, t, :, None], xx[:, t, :, None], gy[:, t, :, None]
        bt, ct = bb[:, t, None], cc[:, t, None]
        a = torch.exp(dt * am)
        g = dyt * ct + carry
        dcv = dyt * hs[t + 1]
        dbv = g * (dt * xt)
        gah = g * (a * hs[t])
        da = da + gah * dt
        lane_dx = lane_sum(g * bt)
        lane_dd = lane_sum(gah * am) + xt * lane_dx
        carry = a * g
        ddelta[:, t] = _tree(lane_dd)[:, :d]
        dx[:, t] = delta[:, t] * _tree(lane_dx)[:, :d]
        dB[:, t] = state_sum(dbv)[:, :n]
        dC[:, t] = state_sum(dcv)[:, :n]
    dA = _in_order(da, 0)[:d, :n].contiguous()
    return ddelta, dA, dB, dC, dx
