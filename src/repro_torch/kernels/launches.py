"""Every kernel wrapper's launch counters, read and written together.

A wrapper adds one to its counter in Python where it launches its kernel
(``paged_attention``'s context-split path launches two, the kernel and its
merge, and counts each).
A CUDA graph replays launches without running that Python, so
:class:`~repro_torch.launch.engine.Engine` takes the counters' difference
over a capture (:func:`snapshot`), takes it back (:func:`restore`: a capture
launches nothing) and adds it on every replay (:func:`add`).  The counters
then go on counting launches on the device.

:data:`KERNELS` is the one table of the counters: the wrapper of each
kernel, its plain version, its counters and the ``__global__`` functions
each counts.  The
``launches`` counter counts every launch of the wrapper; the others count
one kernel each (a variant, named ``<kernel>_<counter without
_launches>``).  :func:`device_counts` counts a profiler's kernel names into
the same keys as :func:`read`, so what a graph launched on the device can be
held against what its capture recorded.
"""
from __future__ import annotations

import importlib
import re
from typing import Dict, Iterable, List, Tuple

# kernel -> (module under repro_torch.kernels, wrapper, {counter: the
# __global__ functions whose launches it counts}, the plain version: a
# function of the same module).  The imc_mac kernels
# serve both entries; their DEQUANT template argument tells them apart.
KERNELS = {
    "imc_mac": ("imc_mac.ops", "imc_mac", {
        "split_launches": ("imc_mac_splitk_kernel",),
        "tiled_launches": ("imc_mac_mma_kernel",)},
        "imc_mac_torch"),
    "imc_mac_dequant": ("imc_mac.ops", "imc_mac_dequant", {
        "split_launches": ("imc_mac_splitk_kernel",),
        "tiled_launches": ("imc_mac_mma_kernel",)},
        "imc_mac_dequant_torch"),
    "paged_attn": ("paged_attn.ops", "paged_attention", {
        "split_launches": ("paged_split_kernel",),
        "ctx_launches": ("paged_ctx_kernel",),
        "merge_launches": ("paged_ctx_merge_kernel",),
        "staged_launches": ("paged_decode_kernel",)},
        "paged_decode_torch"),
    "bitplane_mac": ("bitplane_mac.ops", "bitplane_mac", {
        "launches": ("bitplane_mac_kernel", "bitplane_mac_r8_kernel"),
        "mma_launches": ("bitplane_mac_mma_kernel",)},
        "bitplane_mac_torch"),
    "flash_attn": ("flash_attn.ops", "flash_attention", {
        "tc_launches": ("flash_attn_tc_kernel",),
        "simt_launches": ("flash_attn_kernel",)},
        "flash_attention_torch"),
    "bitplane_mac_noisy": ("bitplane_mac.ops", "bitplane_mac_noisy", {
        "launches": ("bitplane_mac_noisy_kernel",),
        "mma_launches": ("bitplane_mac_noisy_mma_kernel",)},
        "bitplane_mac_noisy_torch"),
    "rbl_decode_mac": ("rbl_decode.ops", "rbl_decode_mac", {
        "launches": ("rbl_decode_mac_kernel",)},
        "rbl_decode_mac_torch"),
}

_WRAPPERS: Dict[str, object] = {}


def wrappers() -> Dict[str, object]:
    """kernel name -> its wrapper (whose ``launches`` counts it)."""
    if not _WRAPPERS:
        for name, (module, attr, _, _) in KERNELS.items():
            mod = importlib.import_module(f"repro_torch.kernels.{module}")
            _WRAPPERS[name] = getattr(mod, attr)
    return _WRAPPERS


def plains() -> Dict[str, Tuple[object, str]]:
    """kernel name -> (its module, the name of its plain version there).
    The wrappers and the fabric engines look the plain version up as the
    module's attribute at call time."""
    return {name: (importlib.import_module(f"repro_torch.kernels.{module}"),
                   plain)
            for name, (module, _, _, plain) in KERNELS.items()}


def variants() -> Dict[str, Tuple[str, str]]:
    """variant name -> (kernel name, counter) of every per-kernel counter
    besides ``launches``."""
    return {f"{name}_{attr[:-len('_launches')]}": (name, attr)
            for name, (_, _, attrs, _) in KERNELS.items()
            for attr in attrs if attr != "launches"}


def counters() -> List[Tuple[object, str]]:
    """(wrapper, attribute) of every launch counter of every kernel."""
    w = wrappers()
    return [(w[name], attr) for name, (_, _, attrs, _) in KERNELS.items()
            for attr in dict.fromkeys(("launches",) + tuple(attrs))]


def read() -> Dict[str, int]:
    """Every counter by name: each kernel's ``launches`` under its name,
    each variant's counter under the variant's."""
    w = wrappers()
    out = {name: w[name].launches for name in KERNELS}
    out.update({v: getattr(w[name], attr)
                for v, (name, attr) in variants().items()})
    return out


def zero() -> None:
    for fn, attr in counters():
        setattr(fn, attr, 0)


def device_counts(kernels: Iterable[Tuple[str, int]]) -> Dict[str, int]:
    """:func:`read`'s keys counted from device kernels: ``kernels`` holds
    (name, launches) pairs as a profiler reports them (demangled, e.g.
    ``void (anonymous namespace)::imc_mac_splitk_kernel<4, false>(...)``);
    names of no kernel in :data:`KERNELS` are left out."""
    owner = {}
    for name, (_, _, attrs, _) in KERNELS.items():
        for attr, fns in attrs.items():
            for f in fns:
                owner.setdefault(f, []).append((name, attr))
    out = dict.fromkeys(read(), 0)
    var = {key: v for v, key in variants().items()}
    for full, n in kernels:
        m = re.search(r"(\w+_kernel)(?:<([^>]*)>)?\(", full)
        if m is None or m.group(1) not in owner:
            continue
        cands = owner[m.group(1)]
        if len(cands) > 1:  # the imc_mac kernels: DEQUANT is the last
            # template argument
            dq = (m.group(2) or "").replace(" ", "").split(",")[-1] == "true"
            cands = [c for c in cands if (c[0] == "imc_mac_dequant") == dq]
        (name, attr), = cands
        out[name] += n
        if attr != "launches":
            out[var[(name, attr)]] += n
    return out


def snapshot() -> Tuple[int, ...]:
    return tuple(getattr(fn, attr) for fn, attr in counters())


def restore(values: Tuple[int, ...]) -> None:
    for (fn, attr), v in zip(counters(), values):
        setattr(fn, attr, v)


def add(delta: Tuple[int, ...]) -> None:
    for (fn, attr), d in zip(counters(), delta):
        if d:
            setattr(fn, attr, getattr(fn, attr) + d)


def diff(after: Tuple[int, ...], before: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple(a - b for a, b in zip(after, before))
