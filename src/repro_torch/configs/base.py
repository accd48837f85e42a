"""Config system: ModelConfig dataclass, shape suite, and the arch registry
(port of ``repro/configs/base.py``; the fields and their validation are the
reference's, except that ``attn_impl`` takes the port's engine words)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.core.fabric import FabricSpec

ATTN_IMPLS = ("auto", "torch", "cuda")


# ---------------------------------------------------------------- model config
@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # Layer pattern: period repeated n_groups times (+ optional tail).
    # kinds: "attn" (global), "local" (sliding window), "moe", "rglru", "ssd"
    pattern: Tuple[str, ...] = ("attn",)
    tail: Tuple[str, ...] = ()
    window: int = 0
    mlp: str = "swiglu"  # swiglu | geglu | gelu | none
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e4
    post_norm: bool = False  # extra post-block RMSNorm (gemma3)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_combine_dtype: str = "bf16"  # "f32" = pre-optimization baseline
    kv_dtype: str = "bf16"  # "int8" = quantized decode cache (§Perf)
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    # RG-LRU
    lru_width: int = 0  # 0 -> d_model
    # modality frontend (STUB: precomputed embeddings in, per assignment)
    frontend: str = "none"  # none | audio | vision
    frontend_dim: int = 0
    # IMC integration (the paper's technique as an execution mode).  Two
    # channels, read through the `imc_fabric` property: the typed `fabric`
    # field (authoritative when set), else the deprecated imc_mode/imc_bits
    # pair.  Neither field is rewritten, so dataclasses.replace on either
    # channel behaves predictably; setting both to conflicting values raises.
    fabric: Optional[FabricSpec] = None
    imc_mode: str = "off"  # off | exact | sim (deprecated spelling)
    imc_bits: int = 8
    # numerics / execution
    q_chunk: int = 512
    ssd_chunk: int = 128
    remat: bool = True
    chunk_remat: bool = True  # False = pre-optimization baseline (§Perf iter 1)
    native_dtype_dots: bool = True  # False = f32-cast attention dots (baseline)
    # Prefill attention: True = the hand-written flash-attention kernel on a
    # CUDA tensor, its plain dense version on a CPU tensor.
    use_flash_kernel: bool = False
    # Paged-decode attention engine: "cuda" = the hand-written flash-decode
    # kernel reading the pools through the block table, "torch" = its plain
    # dense-gather version (CPU tensors only), "auto" = by the tensor's device.
    attn_impl: str = "auto"
    # source provenance
    source: str = ""

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(
                f"{self.name}: attn_impl must be one of {ATTN_IMPLS}, "
                f"got {self.attn_impl!r}")
        period = len(self.pattern)
        if (self.n_layers - len(self.tail)) % period != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} incompatible with "
                f"pattern period {period} + tail {len(self.tail)}")
        if (self.fabric is not None and self.imc_mode != "off"
                and (self.imc_mode != self.fabric.mode
                     or self.imc_bits != self.fabric.bits_a)):
            # Both channels set to different things: undecidable intent —
            # raise instead of silently picking one.  (Writes to one channel
            # alone always behave: fabric= governs when set, the legacy pair
            # governs otherwise; see the imc_fabric property.)
            raise ValueError(
                f"{self.name}: ambiguous IMC config — fabric={self.fabric} "
                f"disagrees with legacy imc_mode={self.imc_mode!r}/"
                f"imc_bits={self.imc_bits}; the typed fabric field is "
                "authoritative: clear the legacy channel (imc_mode='off') "
                "or replace fabric= itself (fabric=None turns IMC off)")

    @property
    def imc_fabric(self) -> Optional[FabricSpec]:
        """The active fabric: the typed field, else the legacy pair, else off.

        Model code reads THIS (never the raw fields), so both config
        spellings drive the same spec-typed path.
        """
        if self.fabric is not None:
            return self.fabric
        if self.imc_mode != "off":
            return FabricSpec(bits_a=self.imc_bits, bits_w=self.imc_bits,
                              mode=self.imc_mode)
        return None

    @property
    def n_groups_layers(self) -> int:
        return (self.n_layers - len(self.tail)) // len(self.pattern)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def lru_w(self) -> int:
        return self.lru_width or self.d_model

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.hd
        attn = d * hd * (self.n_heads * 2) + d * hd * (self.n_kv_heads * 2)
        mlp = {"swiglu": 3 * d * f, "geglu": 3 * d * f, "gelu": 2 * d * f,
               "none": 0}[self.mlp]
        moe = self.n_experts * 3 * d * f + d * self.n_experts
        d_in = self.ssm_expand * d
        heads_ssd = d_in // self.ssm_headdim if self.ssm_headdim else 0
        ssd = (d * (2 * d_in + 2 * self.ssm_state + heads_ssd)
               + d_in * d + 3 * heads_ssd + d_in)
        w = self.lru_w
        rglru = 2 * d * w + 2 * w * w + w * d + w * 3
        per_kind = {"attn": attn + mlp, "local": attn + mlp,
                    "moe": attn + moe, "rglru": rglru + mlp, "ssd": ssd}
        total = 0
        layers = list(self.pattern) * self.n_groups_layers + list(self.tail)
        for kind in layers:
            total += per_kind[kind] + 2 * d  # + norms
        total += v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.n_experts == 0:
            return self.n_params()
        full = self.n_params()
        d, f = self.d_model, self.d_ff
        layers = list(self.pattern) * self.n_groups_layers + list(self.tail)
        n_moe = sum(1 for k in layers if k == "moe")
        inactive = n_moe * (self.n_experts - self.top_k) * 3 * d * f
        return full - inactive


# ---------------------------------------------------------------- shape suite
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# Archs allowed to run long_500k (sub-quadratic decode structure); pure
# full-attention archs skip it.
LONG_CONTEXT_ARCHS = {"mamba2-370m", "recurrentgemma-9b", "gemma3-12b"}


# ------------------------------------------------------------------- registry
_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def list_configs():
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    import importlib

    for mod in ("musicgen_large", "qwen2_72b", "deepseek_coder_33b",
                "qwen2_5_3b", "gemma3_12b", "dbrx_132b", "qwen3_moe_30b_a3b",
                "llava_next_mistral_7b", "mamba2_370m",
                "recurrentgemma_9b", "imc_paper"):
        importlib.import_module(f"repro_torch.configs.{mod}")


def reduce_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests."""
    period = len(cfg.pattern)
    small = dict(
        n_layers=period + len(cfg.tail),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) or 2,
        head_dim=16,
        d_ff=96 if cfg.d_ff else 0,
        vocab_size=256,
        window=min(cfg.window, 16) if cfg.window else 0,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_headdim=16 if cfg.ssm_state else cfg.ssm_headdim,
        lru_width=32 if cfg.lru_width or "rglru" in cfg.pattern + cfg.tail else 0,
        frontend_dim=32 if cfg.frontend != "none" else 0,
        q_chunk=16,
        ssd_chunk=8,
        name=cfg.name + "-smoke",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
