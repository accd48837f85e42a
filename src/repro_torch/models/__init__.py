from repro_torch.models.model import (decode_step, forward_logits,
                                      init_params, prefill)
from repro_torch.models.transformer import StackCache, stack_forward
