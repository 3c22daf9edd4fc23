"""qwen3-4b: 36L d2560 32H (GQA kv=8, head_dim=128) ff9728 v151936 — qk_norm.
The reference's ``repro.configs.qwen3_4b`` (Qwen/Qwen3 family card)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b", family="dense", num_layers=36, d_model=2560,
    num_heads=32, num_kv_heads=8, head_dim=128, d_ff=9728,
    vocab_size=151936, qk_norm=True, rope_theta=1e6, tie_embeddings=True)
