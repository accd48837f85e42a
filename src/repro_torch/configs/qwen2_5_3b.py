"""Qwen2.5-3B: dense GQA transformer, QKV bias, tied embeddings.

[hf:Qwen/Qwen2.5-3B] 36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, head_dim=128,
    d_ff=11008, vocab_size=151936, pattern=("attn",), mlp="swiglu",
    qkv_bias=True, tie_embeddings=True, rope_theta=1e6,
    source="hf:Qwen/Qwen2.5-3B (assignment: qwen2.5 family)",
))
