"""Reference side of the port's 2x4 mesh parity check.

Runs ``repro``'s engine on a forced 8-device CPU mesh (route 2 x memory 4)
for each configuration in ``CONFIGS``, three batches each, and saves the
initial state, every state plane and lane result after each batch, and the
traced collective counts to one ``.npz``.  The lookup configurations run
``ops=("lookup",)`` on lookup batches; the ``mixed_*`` ones run
``ops=("lookup", "update", "insert")`` on mixed batches with hot keys
written in every other batch and one leaf driven past its slack.
``tests/test_torch_engine.py`` runs this in a subprocess (the device count
locks when JAX starts) and replays the same batches through the port's
virtual mesh.

    python tests/torch_mesh_ref.py OUT.npz
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from repro.compat import make_mesh_compat  # noqa: E402
from repro.core import dex as dex_mod  # noqa: E402
from repro.core import engine as engine_mod  # noqa: E402
from repro.core import pool as pool_mod  # noqa: E402
from repro.core import routing  # noqa: E402
from repro.core.nodes import KEY_MAX, KEY_MIN  # noqa: E402

N_KEYS = 6000
LANES = 512
BATCHES = 3
MIXED_OPS = ("lookup", "update", "insert")
#: (name, policy, route_capacity_factor, ops); auto_tight sheds lanes
CONFIGS = (
    ("fetch", "fetch", 4.0, ("lookup",)),
    ("offload", "offload", 4.0, ("lookup",)),
    ("auto", "auto", 4.0, ("lookup",)),
    ("auto_tight", "auto", 0.75, ("lookup",)),
    ("mixed_fetch", "fetch", 4.0, MIXED_OPS),
    ("mixed_offload", "offload", 4.0, MIXED_OPS),
    ("mixed_auto", "auto", 4.0, MIXED_OPS),
)


def dataset():
    rng = np.random.default_rng(0)
    keys = np.sort(rng.choice(300_000, size=N_KEYS, replace=False).astype(np.int64))
    return keys + 1, (keys + 1) * 7


def batches():
    keys, _ = dataset()
    rng = np.random.default_rng(1)
    out = []
    for _ in range(BATCHES):
        q = rng.choice(keys, size=LANES).astype(np.int64)
        q[::13] += 1
        q[::29] = KEY_MAX
        out.append(q)
    return out


def mixed_batches():
    """``(opcodes, keys, values)`` per batch: random lookups, updates and
    inserts of fresh keys; eight hot keys updated on even batches and read on
    odd ones; in batch 1, 30 fresh keys into one leaf (its slack is 20)."""
    keys, _ = dataset()
    hot = keys[40:48]
    rng = np.random.default_rng(2)
    out = []
    for bi in range(BATCHES):
        opc = rng.integers(0, 3, size=LANES).astype(np.int32)
        kk = rng.choice(keys, size=LANES).astype(np.int64)
        ins = opc == engine_mod.OP_INSERT
        fresh = kk + rng.integers(1, 4, size=LANES)
        ok = ~np.isin(fresh, keys)
        kk[ins & ok] = fresh[ins & ok]
        vals = np.where(opc == engine_mod.OP_UPDATE, kk ^ 0x5A5A, kk * 7)
        opc[:8] = engine_mod.OP_LOOKUP if bi % 2 else engine_mod.OP_UPDATE
        kk[:8] = hot
        vals[:8] = hot ^ (100 + bi)
        if bi == 1:
            opc[8:38] = engine_mod.OP_INSERT
            kk[8:38] = keys[1980:2010] + 1
        kk[::29] = KEY_MAX
        out.append((opc, kk, vals.astype(np.int64)))
    return out


def flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(p.name for p in path): np.asarray(x) for path, x in leaves}


def config(policy, factor):
    return dex_mod.DexMeshConfig(
        route_axes=("data",),
        memory_axis="model",
        n_route=2,
        n_memory=4,
        cache_sets=64,
        cache_ways=4,
        policy=policy,
        route_capacity_factor=factor,
    )


def main(out_path):
    mesh = make_mesh_compat((2, 4), ("data", "model"))
    keys, vals = dataset()
    pool, meta = pool_mod.build_pool(keys, vals, level_m=1, fill=0.7, n_shards=4)
    bounds = np.array([KEY_MIN, 150_000, KEY_MAX], np.int64)
    lanes = NamedSharding(mesh, P(("data", "model")))
    out = {"keys": keys, "values": vals}
    for i, q in enumerate(batches()):
        out[f"batch/{i}"] = q
    for i, planes in enumerate(mixed_batches()):
        for field, a in zip(("opcodes", "keys", "values"), planes):
            out[f"mixed/{i}/{field}"] = a
    for name, policy, factor, ops in CONFIGS:
        out[f"{name}/policy"] = np.array(policy)
        out[f"{name}/factor"] = np.array(factor)
        cfg = config(policy, factor)
        state = dex_mod.init_state(pool, meta, cfg, bounds)
        state = jax.tree.map(
            lambda x,
            s: jax.device_put(x, s),
            state,
            dex_mod.state_shardings(mesh, cfg),
        )
        for k, v in flat(state).items():
            out[f"{name}/init/{k}"] = v
        fn = engine_mod.make_dex_engine(meta, cfg, mesh, ops=ops)
        eng = jax.jit(fn)
        if ops == MIXED_OPS:
            trace = mixed_batches()
        else:
            trace = [(np.zeros(q.shape, np.int32), q, np.zeros(q.shape, np.int64))
                     for q in batches()]
        for i, planes in enumerate(trace):
            args = tuple(jax.device_put(jnp.asarray(a), lanes) for a in planes)
            if i == 0:
                counts = routing.trace_collective_counts(fn, state, *args)
                out[f"{name}/counts"] = np.array(
                    [counts["all_to_all"], counts["route_exchange"]]
                )
            state, res = eng(state, *args)
            for k, v in flat(state).items():
                out[f"{name}/{i}/{k}"] = v
            for k in ("found", "values", "status", "shed"):
                out[f"{name}/{i}/result.{k}"] = np.asarray(getattr(res, k))
    np.savez(out_path, **out)
    print("MESH_REF_OK")


if __name__ == "__main__":
    main(sys.argv[1])
