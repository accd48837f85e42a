from repro_torch.configs.base import (ATTN_IMPLS, ModelConfig, get_config,
                                      list_configs, reduce_config, register)
