"""The port's telemetry plane (``repro_torch/obs``) against the reference's
(``repro/obs``): the registry's schema, views and markdown table; the latency
ledger's helpers on seeded histograms; ``BatchTimeline`` summaries (equal
apart from wall times) and their Chrome trace events (equal in structure
and names); ``drift.compare`` reports.  On the port's engine: an
instrumented run equals a bare one (lanes, stats, collective counts), no
collective is counted under ``dex/lat``, the profiler ranges carry the
reference's labels, ``collectives_per_batch`` leaves the state untouched,
and ``run_smo`` / ``maybe_repartition`` record their phases."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import drift as ref_drift  # noqa: E402
from repro.obs import latency as ref_latency  # noqa: E402
from repro.obs import registry as ref_registry  # noqa: E402
from repro.obs import timeline as ref_timeline  # noqa: E402
from repro.obs import trace as ref_trace  # noqa: E402
from repro_torch.core import dex as t_dex  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.core import mesh as t_mesh  # noqa: E402
from repro_torch.core import pool as t_pool  # noqa: E402
from repro_torch.core import sim as t_sim  # noqa: E402
from repro_torch.core import smo as t_smo  # noqa: E402
from repro_torch.core import write as t_write  # noqa: E402
from repro_torch.core.partition import LogicalPartitions  # noqa: E402
from repro_torch.core.repartition import (  # noqa: E402
    RepartitionConfig,
    RepartitionController,
)
from repro_torch.obs import drift as t_drift  # noqa: E402
from repro_torch.obs import latency as t_latency  # noqa: E402
from repro_torch.obs import registry as t_registry  # noqa: E402
from repro_torch.obs import timeline as t_timeline  # noqa: E402
from repro_torch.obs import trace as t_trace  # noqa: E402

KEY_MIN = np.iinfo(np.int64).min
KEY_MAX = np.iinfo(np.int64).max
MIXED = ("lookup", "update", "insert")


def _stats(seed, n_dev=8):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1000, size=(n_dev, t_registry.N_STATS)).astype(np.int64)


def _hist(seed):
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 50, size=(t_latency.N_CLASSES, t_latency.N_PATHS,
                                  t_latency.N_BUCKETS)).astype(np.int64)
    h[3] = 0  # an empty class
    h[1, 2] = 0
    return h


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def test_registry_schema_and_markdown_table_match_reference():
    assert t_registry.markdown_table() == ref_registry.markdown_table()
    for a, b in zip(ref_registry.METRICS, t_registry.METRICS, strict=True):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        assert (da.pop("compute") is None) == (db.pop("compute") is None)
        assert da == db
    for name in ("N_STATS", "SLOT_OF", "KINDS"):
        assert getattr(t_registry, name) == getattr(ref_registry, name), name
    assert [m.name for m in t_registry.PAIRED] == [m.name for m in ref_registry.PAIRED]
    assert sorted(t_registry.SIM_FIELDS) == sorted(ref_registry.SIM_FIELDS)
    for name, slot in ref_registry.stat_constants().items():
        assert getattr(t_registry, name) == slot


def test_snapshot_delta_and_sim_view_match_reference():
    before, after = _stats(1), _stats(1) + _stats(2)
    for stats in (after, torch.from_numpy(after), after[0]):
        a = ref_registry.snapshot(np.asarray(stats))
        b = t_registry.snapshot(stats)
        assert a.as_dict() == b.as_dict() and a.n_devices == b.n_devices
    a = ref_registry.delta(ref_registry.snapshot(after), ref_registry.snapshot(before))
    b = t_registry.delta(t_registry.snapshot(torch.from_numpy(after)),
                         t_registry.snapshot(before))
    assert a.as_dict() == b.as_dict()
    for k in a.per_device:
        np.testing.assert_array_equal(a.per_device[k], b.per_device[k])
    c = t_sim.Counters(ops=10, rdma_read=3, local_accesses=6, bytes=4096, peer_hits=2)
    assert ref_registry.sim_view(c) == t_registry.sim_view(c)


# ---------------------------------------------------------------------------
# latency ledger
# ---------------------------------------------------------------------------


def test_latency_helpers_match_reference():
    np.testing.assert_array_equal(ref_latency.bucket_edges(), t_latency.bucket_edges())
    for seed in (3, 4):
        h = _hist(seed)
        assert ref_latency.latency_section(h) == t_latency.latency_section(h)
        assert ref_latency.ledger(h) == t_latency.ledger(h)
        assert ref_latency.class_percentiles(h) == t_latency.class_percentiles(h)
        assert ref_latency.class_percentiles(h.sum(1), (10.0, 90.0)) == \
            t_latency.class_percentiles(h.sum(1), (10.0, 90.0))
        for cls in (t_latency.OP_CLASSES, ("update",)):
            assert ref_latency.percentile_gauges(h, cls) == \
                t_latency.percentile_gauges(h, cls)
        for q in (0.0, 1.0, 50.0, 99.0, 100.0):
            assert ref_latency.percentile(h[0, 1], q) == t_latency.percentile(h[0, 1], q)
    rng = np.random.default_rng(5)
    pred = rng.random((4, 2)) * 1e6
    real = rng.random((4, 2)) * 1e6
    real[1, 0] = pred[2, 1] = real[2, 1] = 0
    assert ref_latency.audit_report(pred, real) == t_latency.audit_report(pred, real)


def test_bucket_index_on_host_numbers_is_the_reference_formula():
    """The simulator bins float64 latencies with the reference's own
    formula: the same bucket for every Python float and numpy array, edges
    included."""
    edges = ref_latency.bucket_edges()
    x = np.concatenate([edges, np.nextafter(edges, 0), np.nextafter(edges, 1),
                        np.geomspace(1e-10, 1.0, 5000), [0.0, 1e-300, 1e300]])
    np.testing.assert_array_equal(ref_latency.bucket_index(x), t_latency.bucket_index(x))
    for v in x[::97].tolist():
        assert int(ref_latency.bucket_index(v)) == int(t_latency.bucket_index(v))


def test_bucket_floors_are_kept_once_a_device():
    x = torch.tensor([1e-7, 4e-6, 1.0], dtype=torch.float32)
    t_latency.bucket_index(x)
    kept = t_latency._FLOORS_ON[x.device]
    assert t_latency.bucket_index(x).tolist() == [0, 4, 15]
    assert t_latency._FLOORS_ON[x.device] is kept


# ---------------------------------------------------------------------------
# timeline, trace and drift
# ---------------------------------------------------------------------------


class _State:
    """A ``DexState`` stand-in: stats and the latency planes."""

    def __init__(self, stats, hist, audit):
        self.stats, self.lat_hist, self.lat_audit = stats, hist, audit


def _timeline(mod, wrap):
    """The same recorded run on either package's ``BatchTimeline``: a primed
    baseline, three instrumented batches (one with a retry and an inner
    phase), an open / closed pipelined batch and the latency capture."""
    rng = np.random.default_rng(9)
    hist = rng.integers(0, 9, size=(8, 4, 6, 16)).astype(np.int64)
    audit = rng.random((8, 2, 4, 2)).astype(np.float32)
    tl = mod.BatchTimeline("run", meta={"mesh": "2x4", "seed": 3})
    tl.prime(wrap(_stats(10)))
    tl.prime_latency(_State(wrap(_stats(10)), wrap(hist), wrap(audit)))
    step = [0]

    def engine(x):
        step[0] += 1
        return _State(wrap(_stats(10) + step[0] * _stats(11)), wrap(hist * (1 + step[0])),
                      wrap(audit * (1 + step[0]))), x

    eng = tl.instrument(engine, label="ycsb-a")
    for i in range(3):
        eng(i)
    with tl.batch("smo") as b:
        with b.phase("smo/round0") as ph:
            ph.fence(wrap(_stats(12)))
        b.retry("insert", 2)
        b.counters(wrap(_stats(10) + 4 * _stats(11)))
    pb = tl.open_batch("pipe")
    pb.add_span("pipe/front", tl.epoch + 0.001, 0.002)
    pb.close()
    last, _ = engine(0)
    tl.capture_latency(last)
    return tl


def _untimed(x):
    """``x`` with every wall time (keys ending ``_s`` or named ``ts`` /
    ``dur``) set to 0."""
    if isinstance(x, dict):
        return {k: 0 if (k.endswith("_s") or k in ("ts", "dur")) and
                isinstance(v, (int, float)) else _untimed(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_untimed(v) for v in x]
    return x


def test_timeline_summary_and_trace_match_reference(tmp_path):
    a = _timeline(ref_timeline, np.asarray)
    b = _timeline(t_timeline, torch.from_numpy)
    sa, sb = a.summary(), b.summary()
    assert sa.keys() == sb.keys() and "latency" in sb and "cost_audit" in sb
    assert _untimed(sa) == _untimed(sb)
    assert _untimed(a.to_json()) == _untimed(b.to_json())
    ta, tb = ref_trace.to_trace_events(a), t_trace.to_trace_events(b)
    assert _untimed(ta) == _untimed(tb)
    assert [(e["ph"], e["name"]) for e in ta["traceEvents"]] == \
        [(e["ph"], e["name"]) for e in tb["traceEvents"]]
    path = t_trace.write_trace(b, str(tmp_path / "traces" / "run.json"))
    assert json.load(open(path))["traceEvents"] == json.loads(json.dumps(tb))["traceEvents"]
    with t_trace.profiler_annotations("outer"), t_trace.profiler_annotations("x", False):
        pass


def test_drift_reports_match_reference():
    mesh = _stats(20).sum(0)
    sim = t_sim.Counters(ops=int(mesh[0]), rdma_read=float(mesh[2]) * 1.1,
                         local_accesses=float(mesh[1]) * 0.5, two_sided=float(mesh[3]),
                         rdma_write=3.0)
    tols = {
        "fetches": ref_drift.rel(0.05, per_op=True),
        "hits": ref_drift.ratio(0.6, 2.5),
        "offloads": ref_drift.ratio(0.9, 1.1, min_count=10),
        "writes": ref_drift.rel(0.5, min_count=10_000),
        "moved_fraction": ref_drift.absolute(0.1),
    }
    t_tols = {k: t_drift.Tolerance(**dataclasses.asdict(v)) for k, v in tols.items()}
    ra = ref_drift.compare(ref_registry.snapshot(_stats(20)), sim, tols, label="x")
    rb = t_drift.compare(t_registry.snapshot(_stats(20)), sim, t_tols, label="x")
    assert ra.format() == rb.format() and ra.ok == rb.ok
    assert [dataclasses.asdict(e) for e in ra.entries] == \
        [dataclasses.asdict(e) for e in rb.entries]
    with pytest.raises(t_drift.PlaneDriftError):
        t_drift.assert_plane_agreement({"hits": 1.0}, {"hits": 5.0},
                                       {"hits": t_drift.ratio(0.9, 1.1)}, verbose=False)


# ---------------------------------------------------------------------------
# on the port's engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(0)
    keys = np.sort(rng.choice(80_000, 4000, replace=False).astype(np.int64) + 1)
    return keys


def _engine_state(keys, ops=MIXED):
    pool, meta = t_pool.build_pool(keys, keys * 7, n_shards=4, device="cpu")
    cfg = t_dex.DexMeshConfig(n_route=2, n_memory=4, cache_sets=64, policy="auto",
                              route_capacity_factor=1.0)
    state = t_dex.init_state(pool, meta, cfg, [KEY_MIN, 40_000, KEY_MAX], device="cpu")
    return meta, cfg, state, t_engine.make_dex_engine(meta, cfg, ops=ops, device="cpu")


def _batches(keys, n=3):
    rng = np.random.default_rng(1)
    out = []
    for _ in range(n):
        opc = rng.integers(0, 3, size=512).astype(np.int32)
        kk = rng.choice(keys, 512) + (opc == 2)
        out.append((opc, kk, kk * 3))
    return out


def test_instrumented_engine_equals_a_bare_one(index):
    """Lanes, stats and collective counts of an instrumented run equal a
    bare run's; the histogram's total equals the ``STAT_OPS`` delta; no
    collective is counted under ``dex/lat``."""
    runs = []
    for instrumented in (False, True):
        _, _, state, eng = _engine_state(index)
        tl = t_timeline.BatchTimeline("engine")
        if instrumented:
            eng = tl.instrument(eng, label="mixed")
            tl.prime(state)
            tl.prime_latency(state)
        ops0 = state.stats[:, t_registry.STAT_OPS].sum().item()
        res, counts = [], []
        for b in _batches(index):
            t_mesh.reset_counts()
            state, r = eng(state, *b)
            counts.append(t_mesh.collective_counts(by_phase=True))
            res.append(r)
        if instrumented:
            hist = tl.capture_latency(state)
            assert hist.sum() == state.stats[:, t_registry.STAT_OPS].sum().item() - ops0
            s = tl.summary()
            assert s["n_batches"] == 3 and s["counters"]["ops"] == hist.sum()
            assert s["latency"]["total"] == hist.sum()
        runs.append((res, counts, t_dex.state_to_numpy(state)))
    (ra, ca, sa), (rb, cb, sb) = runs
    assert ca == cb
    assert all("dex/lat" not in c["phases"] for c in cb)
    for x, y in zip(ra, rb):
        for k in x._fields:
            assert (getattr(x, k) is None) == (getattr(y, k) is None)
            if getattr(x, k) is not None:
                assert torch.equal(getattr(x, k), getattr(y, k)), k
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


def test_engine_profiler_ranges_carry_the_reference_labels(index):
    _, _, state, eng = _engine_state(index, ops=("lookup", "update", "insert", "scan"))
    opc, kk, vv = _batches(index, 1)[0]
    opc[::5] = 3
    vv = np.where(opc == 3, 5, vv)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng(state, opc, kk, vv)
    names = {e.key for e in prof.key_averages()}
    for label in ("dex/route", "dex/descent/l0", "dex/descent/l1", "dex/scan/h1",
                  "dex/fused_a2a/request", "dex/apply", "dex/fused_a2a/response",
                  "dex/lat/offload", "dex/lat/write_through", "dex/lat/bin",
                  "dex/route_back"):
        assert label in names, label


def test_collectives_per_batch_leaves_the_state_untouched(index):
    _, _, state, eng = _engine_state(index)
    before = t_dex.state_to_numpy(state)
    b = _batches(index, 1)[0]
    t_mesh.reset_counts()
    counts = t_registry.collectives_per_batch(eng, state, *b, by_phase=True)
    assert t_mesh.collective_counts() == {"all_to_all": 0, "route_exchange": 0}
    for k, v in t_dex.state_to_numpy(state).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    t_mesh.reset_counts()
    eng(state, *b)
    assert counts == t_mesh.collective_counts(by_phase=True)


def test_smo_and_repartition_record_their_phases(index):
    meta, cfg, state, _ = _engine_state(index)
    tl = t_timeline.BatchTimeline("smo")
    ins = t_write.make_dex_insert(meta, cfg, device="cpu")
    lo, hi = index[440], index[483]
    kk = np.full(512, KEY_MAX, np.int64)
    kk[np.arange(30) * 17] = np.setdiff1d(np.arange(lo + 1, hi), index)[:30]
    state, st = ins(state, kk, kk * 3)
    shed = st.numpy() == t_write.STATUS_SPLIT
    assert shed.sum() == 30
    host = t_sim.HostBTree(index, index * 7)
    smo = t_smo.make_dex_smo(meta, cfg, device="cpu")
    with tl.batch("settle") as b:
        state, meta2, info = t_smo.settle_splits(
            state, meta, cfg, smo, host, np.where(shed, kk, KEY_MAX),
            np.where(shed, kk * 3, 0), [KEY_MIN, 40_000, KEY_MAX], obs=b,
        )
    assert info["onmesh"] == 30 and not info["drained"] and meta2 is meta
    assert host.get(int(kk[17])) == int(kk[17]) * 3
    assert [p.name for p in tl.batches[0].phases] == [
        f"smo/round{i}" for i in range(info["rounds"])
    ]
    ctl = RepartitionController(
        LogicalPartitions(np.array([KEY_MIN, 40_000, KEY_MAX])), n_memory=4,
        cfg=RepartitionConfig(imbalance_threshold=1.1, min_ops=10, cooldown_batches=0),
    )
    ctl.observe(state.stats.numpy(), index[:2000], demand=np.array([[2000, 10]] * 8))
    with tl.batch("repart") as b:
        state, report = ctl.maybe_repartition(state, meta, obs=b)
    assert report is not None
    assert [p.name for p in tl.batches[1].phases] == ["repartition/install"]


def test_fence_returns_its_tree_on_the_cpu():
    tree = {"a": (torch.zeros(3), [torch.ones(2)]), "b": 4}
    assert t_timeline.fence(tree) is tree
    out, secs = t_timeline.timed_call(lambda: tree)
    assert out is tree and secs >= 0
