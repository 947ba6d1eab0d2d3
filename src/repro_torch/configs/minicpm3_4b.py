"""minicpm3-4b [dense] — 62L d_model=2560 40H (kv=40) d_ff=6400 vocab=73448,
MLA (multi-head latent attention).  [hf:openbmb/MiniCPM3-4B; hf]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab=73448,
    attention="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
)
