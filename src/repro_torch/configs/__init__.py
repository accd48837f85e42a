from repro_torch.configs.base import (ATTN_IMPLS, LONG_CONTEXT_ARCHS, SHAPES,
                                      ModelConfig, ShapeConfig, get_config,
                                      list_configs, reduce_config, register)
