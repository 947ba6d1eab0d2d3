"""One group of ``tests/torch_mesh_ref.py`` (the reference on a forced
8-device CPU mesh), or another reference script that takes ``OUT.npz``
first, in a subprocess, run once for a test module through a
module-scoped fixture; ``arrays`` waits for it and loads what it saved.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np

HERE = pathlib.Path(__file__).parent


class MeshGroup:
    """``script OUT *args`` started at construction; use as a context
    manager, which stops the process at exit if it still runs."""

    def __init__(self, tmp_path_factory, *args, timeout=600, script="torch_mesh_ref.py"):
        base = tmp_path_factory.mktemp("mesh_ref")
        self.out = base / "ref.npz"
        self.timeout = timeout
        self._script = script
        env = dict(os.environ)
        env["PYTHONPATH"] = str(HERE.parent / "src") + os.pathsep + env.get("PYTHONPATH", "")
        env.pop("XLA_FLAGS", None)
        self._log = open(base / "ref.log", "w+")
        self._proc = subprocess.Popen(
            [sys.executable, str(HERE / script), str(self.out), *args],
            env=env, stdout=self._log, stderr=subprocess.STDOUT, text=True,
        )
        self._arrays = None

    def arrays(self) -> dict:
        """The group's saved arrays, waiting for it to end."""
        if self._arrays is None:
            rc = self._proc.wait(timeout=self.timeout)
            self._log.seek(0)
            assert rc == 0, f"{self._script} exited {rc}:\n{self._log.read()}"
            with np.load(self.out) as z:
                self._arrays = dict(z)
        return self._arrays

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait()
        self._log.close()
