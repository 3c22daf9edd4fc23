"""whisper-medium: encoder–decoder, 24 + 24 layers, d1024, 16 heads (MHA,
kv 16, head_dim 64), ff4096 (GELU), v51865, tied embeddings; the conv/mel
frontend is a stub: a batch carries 1500 frame embeddings, padded to 1536.
The reference's ``repro.configs.whisper_medium`` [arXiv:2212.04356]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="encdec", num_layers=24, d_model=1024,
    num_heads=16, num_kv_heads=16, head_dim=64, d_ff=4096, vocab_size=51865,
    encoder_layers=24, encoder_seq=1500, tie_embeddings=True)
