"""Analytic throughput model: counters -> ops/s (Plane A).

The simulator (core/sim.py) is single-threaded and mechanistic; this module
converts its per-op verb counts and critical-section counts into cluster
throughput under N compute threads, using a closed-system model with explicit
bottleneck caps:

  X(N) = min(  N / L_op                      -- thread-limited
             , n_servers * NIC_BW / B_op     -- NIC bandwidth (paper Fig. 8:
                                                "network bandwidth becomes the
                                                bottleneck again")
             , n_servers * MSG_RATE / M_op   -- NIC message rate
             , MEM_CPU / S_op                -- memory-side compute (Fig. 5/13)
             , 1 / (t_cs * C_op^max-bucket)  -- cooling-structure serialization
                                                (Fig. 4/9: FIFO queue collapse)
             , 1 / (t_retry * H_op)          -- hot-leaf optimistic-lock retries
                                                (Fig. 12b NUMA collapse)
            )

All constants are calibrated to the paper's §2.3 measurements (RDMA READ
2 µs, cached 1KB access 400 ns, 100 Gbps NICs) and are overridable.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core.sim import Simulator


@dataclasses.dataclass
class HardwareModel:
    nic_bw: float = 12.5e9            # bytes/s per server (100 Gbps)
    nic_msg_rate: float = 60e6        # verbs/s per NIC
    t_bucket_cs: float = 120e-9       # cooling bucket lock+shift critical section
    #: cache-line ping-pong: each waiter adds a coherence transfer to the
    #: critical section (the Fig. 4 FIFO-queue collapse mechanism) — the
    #: effective section is t_cs * (1 + coherence_factor * contenders)
    coherence_factor: float = 0.05
    t_hot_retry: float = 250e-9       # optimistic-lock retry on a hot cached leaf
    op_cpu_overhead: float = 250e-9   # per-op application logic
    numa_penalty: float = 2.0         # cross-socket amplification of hot-lock cost


@dataclasses.dataclass
class ThroughputReport:
    ops_per_sec: float
    bottleneck: str
    caps: Dict[str, float]
    latency_per_op: float

    def mops(self) -> float:
        return self.ops_per_sec / 1e6


def analyze(
    sim: Simulator,
    *,
    threads_total: Optional[int] = None,
    hw: Optional[HardwareModel] = None,
    hot_leaf_write_fraction: float = 0.0,
    threads_per_socket: int = 18,
) -> ThroughputReport:
    """Convert a finished simulation into a throughput estimate.

    ``hot_leaf_write_fraction``: fraction of ops that contend on the single
    hottest leaf lock (drives the Fig. 12b local-contention collapse under
    skew; computed by the benchmark from the workload distribution).
    """
    hw = hw or HardwareModel()
    cfg = sim.cfg
    tot = sim.totals()
    n = max(tot.ops, 1)
    threads = (
        threads_total
        if threads_total is not None
        else cfg.n_compute * cfg.threads_per_compute
    )

    # --- per-op demand -------------------------------------------------------
    latency = sim.op_clock.sum() / n + hw.op_cpu_overhead
    bytes_op = tot.bytes / n
    msgs_op = (
        tot.rdma_read
        + tot.rdma_small_read
        + tot.rdma_write
        + tot.rdma_cas
        + 2.0 * tot.two_sided
    ) / n
    mem_cpu_op = sim.mem_busy.sum() / n      # seconds of memory-side CPU per op

    caps: Dict[str, float] = {}
    caps["threads"] = threads / latency

    n_srv = cfg.n_compute
    caps["nic_bandwidth"] = np.inf if bytes_op == 0 else n_srv * hw.nic_bw / bytes_op
    caps["nic_messages"] = np.inf if msgs_op == 0 else n_srv * hw.nic_msg_rate / msgs_op

    mem_capacity = cfg.n_mem_servers * cfg.mem_threads_per_server
    if mem_cpu_op > 0:
        caps["memory_cpu"] = mem_capacity / mem_cpu_op
        if not cfg.offload_always:
            # cost-aware offloading self-regulates (moving averages see the
            # queueing delay and stop offloading): the cap softens into extra
            # one-sided reads instead of a hard ceiling.
            caps["memory_cpu"] = max(
                caps["memory_cpu"], 0.85 * min(caps["threads"], caps["nic_messages"])
            )
    else:
        caps["memory_cpu"] = np.inf

    # --- cooling-structure serialization (Fig. 4 / Fig. 9) --------------------
    # The busiest bucket's acquire rate serializes; contending threads add
    # cache-line coherence transfers to every acquisition (ping-pong).
    worst = 0.0
    for cache, ctr in zip(sim.caches, sim.counters):
        if ctr.ops == 0:
            continue
        acq = cache.cooling.lock_acquires
        per_op = float(acq.max()) / ctr.ops if acq.size else 0.0
        worst = max(worst, per_op)
    if worst > 0:
        threads_per_srv = max(threads // max(cfg.n_compute, 1), 1)
        # contenders on the busiest bucket ~ threads * (its share of acquires)
        share = worst / max(
            sum(
                float(c.cooling.lock_acquires.sum()) / max(ct.ops, 1)
                for c, ct in zip(sim.caches, sim.counters)
            ) / max(cfg.n_compute, 1),
            1e-9,
        )
        contenders = min(threads_per_srv, max(1.0, threads_per_srv * share))
        t_eff = hw.t_bucket_cs * (1 + hw.coherence_factor * contenders)
        caps["cooling_lock"] = n_srv / (worst * t_eff)
    else:
        caps["cooling_lock"] = np.inf

    # --- hot-leaf optimistic lock (Fig. 12b) ----------------------------------
    if hot_leaf_write_fraction > 0:
        t = hw.t_hot_retry
        if threads > threads_per_socket:
            t *= hw.numa_penalty
        caps["hot_leaf_lock"] = 1.0 / (hot_leaf_write_fraction * t)
    else:
        caps["hot_leaf_lock"] = np.inf

    x = min(caps.values())
    bottleneck = min(caps, key=lambda k: caps[k])
    return ThroughputReport(
        ops_per_sec=float(x), bottleneck=bottleneck, caps=caps, latency_per_op=latency
    )


def throughput_curve(
    make_sim,
    workload,
    thread_counts: Sequence[int],
    *,
    threads_per_compute: int = 36,
    hw: Optional[HardwareModel] = None,
    hot_leaf_write_fraction: float = 0.0,
) -> Dict[int, ThroughputReport]:
    """Scalability curve: run the simulator once, then scale the thread count
    analytically (the verb mix per op does not depend on thread count; adding
    compute servers as threads exhaust existing ones, per §8.2)."""
    ops, keys = workload
    sim = make_sim()
    sim.run(ops, keys)
    out = {}
    for t in thread_counts:
        out[t] = analyze(
            sim,
            threads_total=t,
            hw=hw,
            hot_leaf_write_fraction=hot_leaf_write_fraction,
        )
    return out
