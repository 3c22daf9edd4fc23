"""jamba-v0.1-52b: 32L d4096; hybrid period-8 [m,m,m,a,m,m,m,m] (1:7
attn:mamba), attention 32H (kv=8, head_dim=128); MoE 16 experts top-2 every
other layer (expert ff=14336), dense ff=14336 otherwise; v65536.  Jamba
v0.1 uses Mamba-1 mixers; the reference uses Mamba-2/SSD blocks.  The
reference's ``repro.configs.jamba_v01_52b`` [arXiv:2403.19887; hf]."""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.moe import MoECfg
from repro_torch.models.ssm import SSMCfg

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=65536,
    attn_every=8, attn_offset=3, sub_quadratic=True,
    moe=MoECfg(num_experts=16, top_k=2, d_ff_expert=14336, every_n=2),
    ssm=SSMCfg(d_state=16, head_dim=64, expand=2, conv_width=4, chunk=256))
