"""mamba2-130m: 24L d768 attention-free SSD, ssm_state=128, d_inner=1536
(24 heads x 64), v50280, tied embeddings; it runs without a model axis
(pure data parallel).  The reference's ``repro.configs.mamba2_130m``
[arXiv:2405.21060]."""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.ssm import SSMCfg

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm", num_layers=24, d_model=768,
    num_heads=1, num_kv_heads=1, head_dim=64, d_ff=0, vocab_size=50280,
    tie_embeddings=True, sub_quadratic=True,
    ssm=SSMCfg(d_state=128, head_dim=64, expand=2, conv_width=4, chunk=256))
