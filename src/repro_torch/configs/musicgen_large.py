"""MusicGen-large: decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284; hf] 48L d_model=2048 32H (MHA) d_ff=8192 vocab=2048.
Audio frontend (EnCodec + codebook interleaving) is a STUB per assignment:
input_specs feed precomputed frame embeddings.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=2048, pattern=("attn",), mlp="gelu", rope_theta=1e4,
    frontend="audio", frontend_dim=128,
    source="arXiv:2306.05284; hf:facebook/musicgen-large",
))
