"""The paper's own demonstrator scale: a ~110M LM whose every projection runs
through the IMC fabric (exact digital-equivalent path) — used by the
end-to-end training example and the IMC energy-projection benchmarks.
"""
from repro_torch.configs.base import ModelConfig, register
from repro_torch.core.fabric import FabricSpec

CONFIG = register(ModelConfig(
    name="imc-paper-110m", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab_size=32000, pattern=("attn",), mlp="gelu",
    fabric=FabricSpec(mode="exact"),
    source="paper demonstrator (8T SRAM IMC, exact path)",
))
