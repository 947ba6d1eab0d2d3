"""llama3-405b [dense] — 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256.  [arXiv:2407.21783; unverified]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab=128256,
    rope_theta=500_000.0,
)
