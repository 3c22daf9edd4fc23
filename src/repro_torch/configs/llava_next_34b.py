"""llava-next-34b: 60L d7168 56H (kv=8, head_dim=128) ff20480 v64000 — VLM;
the anyres patch frontend is a stub: a batch carries 1152 patch embeddings,
projected by ``patch_proj`` and prepended to the token stream.  The
reference's ``repro.configs.llava_next_34b`` [hf: llava-hf family]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b", family="vlm", num_layers=60, d_model=7168,
    num_heads=56, num_kv_heads=8, head_dim=128, d_ff=20480, vocab_size=64000,
    rope_theta=5e6, num_patches=1152)
