"""RecurrentGemma-9B (Griffin): RG-LRU + local attention, 2:1 pattern.

[arXiv:2402.19427; unverified] 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000.  Pattern (rglru, rglru, local-attn) x 12 + (rglru, rglru) tail
= 38 blocks; window 2048.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256000,
    pattern=("rglru", "rglru", "local"), tail=("rglru", "rglru"),
    window=2048, tie_embeddings=True, mlp="geglu", lru_width=4096, rope_theta=1e4,
    source="arXiv:2402.19427; hf:google/recurrentgemma-9b; unverified",
))
