"""Gemma3-12B: 5:1 local:global attention, head_dim 256, 262k vocab.

[hf:google/gemma-3-12b-pt; unverified] 48L d_model=3840 16H (GQA kv=8)
d_ff=15360 vocab=262144, sliding window 1024, pre+post RMSNorm, GEGLU.
Single rope_theta=1e6 is used for both local and global layers (the released
model uses 1e4 local / 1e6 global), as in the reference's config.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15360, vocab_size=262144,
    pattern=("local", "local", "local", "local", "local", "attn"),
    window=1024, tie_embeddings=True, mlp="geglu", post_norm=True, rope_theta=1e6,
    source="hf:google/gemma-3-12b-pt; unverified",
))
