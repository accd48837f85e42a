"""The port's one device rule: run on the card unless the CPU is asked for.

Entry points take ``device=None`` and resolve it here.  ``None`` means
``"cuda"``, and asking for CUDA on a machine without a card raises instead of
quietly running on the CPU: a serving number taken on the CPU must never pass
for a card number.  Tests pass ``device="cpu"``.

Resolving a CUDA device also pins float32 matmul precision: TF32 is turned
off for matmuls and cuDNN, so an f32 product on the card is a full f32
product, as in the reference.  It sets ``CUBLAS_WORKSPACE_CONFIG`` to
``:4096:8`` unless the caller set it: PyTorch sizes cuBLAS's workspace from
it when the process first uses cuBLAS, and its deterministic-algorithms
mode refuses cuBLAS products without it.

:func:`deterministic` runs a block with PyTorch's deterministic algorithms
(the trainer runs its steps under it, so a run resumed from a checkpoint
repeats an uninterrupted one bit for bit).
"""
from __future__ import annotations

import contextlib
import os
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
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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


@contextlib.contextmanager
def deterministic():
    """Run the block under ``torch.use_deterministic_algorithms(True)``
    (restored after): an op without a deterministic implementation raises
    instead of running.  The mode's NaN fill of every new uninitialized
    tensor (a check for reads of garbage, not a source of determinism) is
    turned off inside."""
    import torch.utils.deterministic as det

    prev = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    fill = det.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        det.fill_uninitialized_memory = fill
        torch.use_deterministic_algorithms(prev, warn_only=warn)
