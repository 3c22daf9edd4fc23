"""minitron-4b: 32L d3072 24H (kv=8, head_dim=128) ff9216 v256000 — pruned
nemotron, untied embedding and head.  The reference's
``repro.configs.minitron_4b`` [arXiv:2407.14679; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b", family="dense", num_layers=32, d_model=3072,
    num_heads=24, num_kv_heads=8, head_dim=128, d_ff=9216, vocab_size=256000,
    rope_theta=1e4)
