"""Root pytest config: make ``src/`` importable without an install and
register custom markers (also declared in pyproject.toml for installed
runs)."""

import pathlib
import sys

_SRC = str(pathlib.Path(__file__).parent / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running multi-device subprocess tests "
        "(deselect with -m 'not slow')",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; skips with a reason where there is none",
    )
