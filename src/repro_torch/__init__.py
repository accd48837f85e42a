"""PyTorch/CUDA port of the 8T SRAM IMC system (serving slice).

Mirrors the layout of the JAX package ``repro`` (``repro/models/attention.py``
<-> ``repro_torch/models/attention.py``) and imports nothing from it.  Every
kernel on the serving path is a hand-written CUDA C++ kernel for Hopper
(``csrc/``, built with ``nvcc`` at first use); each keeps a plain PyTorch
version beside it, which runs only for tensors that lie on the CPU.

Entry points (:class:`repro_torch.launch.server.Server`,
:func:`repro_torch.models.model.init_params`,
``python -m repro_torch.launch.serve``) run on the card unless the caller
passes ``device="cpu"``; see :mod:`repro_torch.device`.
"""
