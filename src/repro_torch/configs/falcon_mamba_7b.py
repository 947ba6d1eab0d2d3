"""falcon-mamba-7b [ssm] — 64L d_model=4096 (attention-free) vocab=65024,
ssm_state=16, mamba1 architecture.  [arXiv:2410.05355; unverified]

DEX paging note (DESIGN.md §Arch-applicability): attention-free — decode
carries a fixed-size recurrent state, so the paged-KV index does not apply
to this arch's decode path."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab=65024,
    attention="none",
    ssm=True,
    ssm_state=16,
    ssm_expand=2,
    mamba_version=1,
    sub_quadratic=True,
    tie_embeddings=True,
)
