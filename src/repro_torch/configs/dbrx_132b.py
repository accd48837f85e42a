"""DBRX-132B: fine-grained MoE, 16 experts top-4.

[hf:databricks/dbrx-base; unverified] 40L d_model=6144 48H (GQA kv=8)
d_ff=10752/expert vocab=100352, MoE every layer.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=10752, vocab_size=100352, pattern=("moe",), mlp="swiglu",
    n_experts=16, top_k=4, rope_theta=5e5,
    source="hf:databricks/dbrx-base; unverified",
))
