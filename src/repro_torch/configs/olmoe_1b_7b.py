"""olmoe-1b-7b: 16L d2048 16H (kv=16, head_dim=128) v50304; 64 experts
top-8, expert ff=1024.  The reference's ``repro.configs.olmoe_1b_7b``
[arXiv:2409.02060; hf]."""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.moe import MoECfg

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe", num_layers=16, d_model=2048,
    num_heads=16, num_kv_heads=16, head_dim=128, d_ff=1024, vocab_size=50304,
    moe=MoECfg(num_experts=64, top_k=8, d_ff_expert=1024))
