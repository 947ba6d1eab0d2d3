"""Reference side of the port's 1x4 and 4x2 mesh checks.

Runs ``repro``'s scan engine (``ops=ALL_OPS``, ``max_count=32``) on the
``scan`` group's batches of ``tests/torch_mesh_ref.py`` (lookups, updates,
inserts of fresh keys and scans, one leaf driven past its slack) on two
more layouts of a forced 8-device CPU mesh, and saves what that file's
``run_engines`` saves: the initial state, every state plane and lane
result after each batch, and the traced collective counts.

* ``scan_auto_1x4``: one route row over four memory columns (the first
  four devices), under ``auto``: the disaggregated layout, one memory
  server a device;
* ``scan_fetch_4x2``: four route rows over two memory columns, under
  ``fetch``.

``tests/test_torch_ranks.py`` runs this in a subprocess and holds the
port's rank backend to the saved arrays.

    python tests/torch_mesh_ref_layouts.py OUT.npz
"""

import sys

import torch_mesh_ref as R  # sets the forced 8-device CPU mesh first

import numpy as np  # noqa: E402
import jax  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from repro.core import pool as pool_mod  # noqa: E402
from repro.core.nodes import KEY_MAX, KEY_MIN  # noqa: E402

#: name: (n_route, n_memory, policy, route_capacity_factor)
CASES = {
    "scan_auto_1x4": (1, 4, "auto", 4.0),
    "scan_fetch_4x2": (4, 2, "fetch", 4.0),
}


def main(out_path):
    keys, vals = R.dataset()
    out = {"keys": keys, "values": vals}
    for i, planes in enumerate(R.scan_batches()):
        for field, a in zip(("opcodes", "keys", "values"), planes):
            out[f"scanmix/{i}/{field}"] = a
    for name, (nr, nm, policy, factor) in CASES.items():
        layout = f"{nr}x{nm}"
        R.LAYOUTS[layout] = (("data",), (nr, nm), nm)
        R.LAYOUT[0] = layout
        devices = np.asarray(jax.devices()[: nr * nm]).reshape(nr, nm)
        try:
            mesh = Mesh(devices, ("data", "model"),
                        axis_types=(jax.sharding.AxisType.Auto,) * 2)
        except (AttributeError, TypeError):
            mesh = Mesh(devices, ("data", "model"))
        pool, meta = pool_mod.build_pool(keys, vals, level_m=1, fill=0.7, n_shards=nm)
        inner = [300_000 * i // nr for i in range(1, nr)]
        bounds = np.array([KEY_MIN] + inner + [KEY_MAX], np.int64)
        lanes = NamedSharding(mesh, P(("data", "model")))
        R.run_engines(out, ((name, policy, factor, R.ALL_OPS),), pool, meta, bounds,
                      mesh, lanes)
    np.savez(out_path, **out)
    print("MESH_REF_OK")


if __name__ == "__main__":
    main(*sys.argv[1:2])
