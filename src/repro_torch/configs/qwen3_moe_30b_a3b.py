"""Qwen3-MoE-30B-A3B: 128 experts top-8, fine-grained (d_ff=768/expert).

[hf:Qwen/Qwen3-30B-A3B] 48L d_model=2048 32H (GQA kv=4) vocab=151936.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab_size=151936, pattern=("moe",), mlp="swiglu",
    n_experts=128, top_k=8, rope_theta=1e6,
    source="hf:Qwen/Qwen3-30B-A3B",
))
