"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000,
ssm_state=64; Mamba2 blocks + weight-shared attention block applied
periodically (the Zamba2 global shared block).  [arXiv:2411.15242; hf]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    ssm=True,
    ssm_state=64,
    ssm_expand=2,
    mamba_version=2,
    hybrid_attn_every=6,
    sub_quadratic=True,
    tie_embeddings=True,
)
