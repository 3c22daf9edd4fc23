"""qwen2-moe-a2.7b: 24L d2048 16H (kv=16, head_dim=128) v151936; 60 routed
experts top-4, expert ff=1408, plus 4 shared experts (one dense ff=5632
MLP).  The reference's ``repro.configs.qwen2_moe_a2_7b``
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf].  The reference pads the routed experts to
64 for 16 model shards; at tp = 1 there are 60."""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.moe import MoECfg

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe", num_layers=24, d_model=2048,
    num_heads=16, num_kv_heads=16, head_dim=128, d_ff=1408, vocab_size=151936,
    moe=MoECfg(num_experts=60, top_k=4, d_ff_expert=1408,
               num_shared=4, d_ff_shared=5632))
