"""LLaVA-NeXT (Mistral-7B backbone): sliding-window attention + vision stub.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified] 32L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=32000, window 4096.  The anyres vision tower is a
STUB per assignment: input_specs feed precomputed patch embeddings (1024-d
CLIP features projected into the LM).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000, pattern=("local",), window=4096,
    mlp="swiglu", rope_theta=1e4,
    frontend="vision", frontend_dim=1024,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
))
