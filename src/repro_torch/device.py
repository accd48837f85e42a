"""The port's one device rule: run on the card unless the CPU is asked for.

Entry points take ``device=None`` and resolve it here.  ``None`` means
``"cuda"``, and asking for CUDA on a machine without a card raises instead of
quietly running on the CPU: a serving number taken on the CPU must never pass
for a card number.  Tests pass ``device="cpu"``.

Resolving a CUDA device also pins float32 matmul precision: TF32 is turned
off for matmuls and cuDNN, so an f32 product on the card is a full f32
product, as in the reference.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {dev}")
    return dev


def device_of(tree) -> Optional[torch.device]:
    """Device of the first tensor found in a (nested dict/list) tree."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            d = device_of(v)
            if d is not None:
                return d
    return None
