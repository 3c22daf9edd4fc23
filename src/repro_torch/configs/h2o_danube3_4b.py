"""h2o-danube-3-4b: 24L d3840 32H (kv=8, head_dim=120) ff10240 v32000 —
llama+mistral mix with sliding-window attention (window 4096); the only
registered config whose head dim is not a power of two.  The reference's
``repro.configs.h2o_danube3_4b`` [arXiv:2401.16818; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b", family="dense", num_layers=24, d_model=3840,
    num_heads=32, num_kv_heads=8, head_dim=120, d_ff=10240, vocab_size=32000,
    window=4096, rope_theta=1e4, sub_quadratic=True)
