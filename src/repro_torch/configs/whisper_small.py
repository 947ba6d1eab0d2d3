"""whisper-small [audio] — 12L d_model=768 12H (kv=12) d_ff=3072 vocab=51865;
enc-dec with conv frontend STUB (input_specs provides precomputed frame
embeddings).  [arXiv:2212.04356]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    encdec=True,
    enc_layers=12,
    max_source_positions=1500,
    act="gelu",
    norm="layernorm",
    tie_embeddings=True,
)
