"""Kernel autotuner: measured, cached launch plans of the port's CUDA
kernels (port of ``repro.kernels.autotune``).

See :mod:`repro_torch.kernels.autotune.tuner` for the design.  The committed
``tuned.json`` beside this file holds the ``cuda-sm90`` winners measured on
an H100; point ``REPRO_TORCH_AUTOTUNE_CACHE`` elsewhere to tune without
touching it, and pin a kernel's geometry outright with
``REPRO_TORCH_TUNE_<KERNEL>="tc_cluster=4,tc_target=264"``.
"""
from repro_torch.kernels.autotune.tuner import (BOUNDS, DEFAULTS,
                                                KERNEL_DTYPES, LEFT_OUT,
                                                SPACES, STANDARD_CELLS,
                                                AutotuneCache, backend_key,
                                                candidates, check_geometry,
                                                default_cache_path, env_pins,
                                                geometry_token, get_cache,
                                                lookup, set_cache,
                                                shape_bucket, tune,
                                                tune_standard)

__all__ = [
    "DEFAULTS", "SPACES", "AutotuneCache", "backend_key",
    "default_cache_path", "env_pins", "geometry_token", "get_cache",
    "lookup", "set_cache", "shape_bucket", "tune", "tune_standard",
    # the port's own: the sources' bounds, the operand dtype of each
    # kernel's cache key, the cells tune_standard measures and those it
    # leaves out, and the helpers the wrappers and the card check use
    "BOUNDS", "KERNEL_DTYPES", "STANDARD_CELLS", "LEFT_OUT",
    "candidates", "check_geometry",
]
