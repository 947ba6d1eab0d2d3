"""repro_torch: the DEX mesh plane on PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper.

A second package beside ``repro``: module names mirror it one to one, and
every public function gives the same answers on the same inputs.  It imports
``torch`` and ``numpy`` only.  Entry points take ``device=None``, which means
``"cuda"``; they raise when CUDA is missing rather than fall back to the CPU.
"""

__version__ = "0.1.0"
