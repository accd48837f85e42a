"""Mamba2-370M: attention-free SSD (state-space duality) stack.

[arXiv:2405.21060; unverified] 48L d_model=1024 vocab=50280, ssm_state=128,
headdim=64, expand=2 (d_inner=2048, 32 SSD heads), no FFN.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab_size=50280, pattern=("ssd",), mlp="none",
    ssm_state=128, ssm_headdim=64, ssm_expand=2, tie_embeddings=True,
    source="arXiv:2405.21060; hf:state-spaces/mamba2-370m; unverified",
))
