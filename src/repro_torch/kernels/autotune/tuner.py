"""Kernel autotuner: measured, cached launch plans for the port's CUDA
kernels (port of ``repro/kernels/autotune/tuner.py``).

The kernels choose their launch at run time by rules sized by hand for a
132-SM H100: how far ``imc_mac``'s split-K kernel splits K, the tensor-core
kernel's cluster size, the blocks ``bitplane_mac`` and ``rbl_decode_mac``
aim at.  Each choice only splits work across blocks, and every split sums
integers, so every candidate gives the same output bit for bit; the choice
moves only time.  This module replaces the hand-sized choices with
measurements:

  * :func:`tune` times real launches of one kernel at one shape over a
    candidate space (each candidate first checked bit for bit against the
    default geometry's output; a difference raises, it is a fault, not a
    loser), as ``graph_ms``: a run of the call captured in one CUDA graph,
    timed with CUDA events, best of a few replays.  It caches the winner
    per ``(kernel, shape-bucket, dtype, backend)``; a cell already cached
    costs zero trials.  A CPU device has no kernel to time: there it
    raises unless a ``measure`` function is handed in.
  * :func:`lookup` is what the kernel wrappers call, on CUDA tensors only,
    at every eager call (a captured graph replays the plan it captured):
    :data:`DEFAULTS` <- cached winner <- ``REPRO_TORCH_TUNE_<KERNEL>`` pin,
    most specific wins, partial pins merge.  It never measures.  Resolved
    geometries are memoised per (kernel, shape, dtype, backend, cache
    version, pin), and it reads only its own kernel's pin, so an eager call
    pays a few dictionary lookups.
  * the cache is a JSON file committed beside this module (``tuned.json``,
    entries keyed by backend ``cuda-sm90`` on an H100, measured there by
    :func:`tune_standard`); ``REPRO_TORCH_AUTOTUNE_CACHE`` points elsewhere
    without touching it.  The format is the reference's (``{"format": 1,
    "entries": {key: {"geometry", "us", "trials"}}}``), plus a top-level
    ``"measured_on"`` (the card's name and power limit), which the
    reference's loader ignores.
  * :func:`geometry_token` is a hashable snapshot of what lookups resolve
    to right now: the cache version (bumped by every load, store and
    :func:`set_cache`) and the pins.  The Engine folds it into its step
    key, so a re-tune or a pin change makes the next step a new one,
    captured anew once, and a stable cache keeps steady state at zero
    captures.

What is tuned (each parameter a runtime argument of the C entry points,
bounded by the sources' compile-time sizes, :data:`BOUNDS`):

  * ``imc_mac`` and ``imc_mac_dequant`` (``csrc/imc_mac.cu``): at M <= 16
    the split-K kernel's ``sk_gmax`` (quads a lane prefetches, at most;
    its register array holds 4) and ``sk_target`` (blocks a launch aims
    at); above, the tensor-core kernel's ``tc_cluster`` (its K splits, one
    thread-block cluster, at most; 8 is the portable cluster size) and
    ``tc_target``.
  * ``bitplane_mac`` and ``bitplane_mac_noisy``: ``target``, the blocks
    ``bitplane_common.cuh``'s ``plan()`` aims at.  Their tensor-core
    kernels (rows 8, 8 x 8 bits; ``bitplane_mac`` at M > 8,
    ``bitplane_mac_noisy`` at M >= 9: the prefill buckets and training)
    read no target, so the wrappers look nothing up there and a pin or
    cache entry at such a shape is ignored.
  * ``rbl_decode_mac``: ``cluster`` and ``target``, as the tensor-core
    ``imc_mac``'s.

Not tuned, with nothing to tune at run time: ``paged_attn`` (the split
kernel's grid is one block per (KV head, slot), ``csrc/paged_attn.cu``; the
reference's ``bps``, pool panels per Pallas grid step, has no counterpart)
and ``flash_attn`` (its tiles ``BQ``/``BK`` are compile-time constants of
``csrc/flash_attn.cu``).

Telemetry: every measured candidate increments ``autotune.trials`` and
lands in the ``autotune.trial_us`` histogram; each :func:`tune` call runs
under an ``autotune.tune`` span.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.telemetry import get_registry, span

# The hand-sized plans of the sources, so a missing cache entry (or an empty
# cache) changes no launch: csrc/imc_mac.cu SK_GMAX, SK_TARGET,
# TC_MAX_SPLITS, TC_TARGET; bitplane_mac.cu 264 and bitplane_mac_noisy.cu
# 480 blocks; rbl_decode_mac.cu MAX_SPLITS, TARGET.
_IMC = {"sk_gmax": 4, "sk_target": 264, "tc_cluster": 8, "tc_target": 264}
DEFAULTS: Dict[str, Dict[str, int]] = {
    "imc_mac": dict(_IMC),
    "imc_mac_dequant": dict(_IMC),
    "bitplane_mac": {"target": 264},
    "bitplane_mac_noisy": {"target": 480},
    "rbl_decode_mac": {"cluster": 8, "target": 264},
}

MAX_TARGET = 1 << 20  # the sources' MAX_TARGET
# (least, most, power of two only) of each parameter, as the sources check
BOUNDS: Dict[str, Tuple[int, int, bool]] = {
    "sk_gmax": (1, 4, False),
    "sk_target": (1, MAX_TARGET, False),
    "tc_cluster": (1, 8, True),
    "tc_target": (1, MAX_TARGET, False),
    "target": (1, MAX_TARGET, False),
    "cluster": (1, 8, True),
}

_TARGETS = (132, 264, 528)  # one, two and four blocks per SM of an H100
SPACES: Dict[str, List[Dict[str, int]]] = {
    "imc_mac": [{"sk_gmax": g, "sk_target": t} for g in (1, 2, 4)
                for t in _TARGETS] +
               [{"tc_cluster": c, "tc_target": t} for c in (2, 4, 8)
                for t in _TARGETS],
    "bitplane_mac": [{"target": t} for t in _TARGETS],
    "bitplane_mac_noisy": [{"target": t} for t in (264, 480, 792)],
    "rbl_decode_mac": [{"cluster": c, "target": t} for c in (2, 4, 8)
                       for t in _TARGETS],
}
SPACES["imc_mac_dequant"] = [dict(g) for g in SPACES["imc_mac"]]

_ENV_CACHE = "REPRO_TORCH_AUTOTUNE_CACHE"
_ENV_PIN_PREFIX = "REPRO_TORCH_TUNE_"  # REPRO_TORCH_TUNE_IMC_MAC="tc_cluster=4"
_COMMITTED = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tuned.json")

# Bumped on every cache mutation (construction, load, store, set_cache): the
# cheap global the geometry token and the lookup memo watch.
_VERSION = 0
_MEMO: Dict[Tuple, Dict[str, int]] = {}
_MEMO_VERSION = -1
_BACKENDS: Dict[torch.device, str] = {}


def _bump() -> None:
    global _VERSION
    _VERSION += 1


def default_cache_path() -> str:
    return os.environ.get(_ENV_CACHE) or _COMMITTED


def _pow2_bucket(v: int) -> int:
    p = 1
    while p < v:
        p *= 2
    return p


def shape_bucket(shapes: Dict[str, int]) -> str:
    """Canonical bucket string: each dim rounded up to a power of two, the
    keys sorted (the reference's)."""
    return "_".join(f"{k}{_pow2_bucket(int(v))}"
                    for k, v in sorted(shapes.items()))


def backend_key(device=None) -> str:
    """Cache axis for the hardware: ``cuda-sm{major}{minor}`` for a CUDA
    device (``cuda-sm90`` on an H100), ``cpu`` for the CPU.  ``device`` is
    a tensor, a device or None (the current CUDA device, or the CPU where
    there is none)."""
    if isinstance(device, torch.Tensor):
        device = device.device
    if device is None:
        if not torch.cuda.is_available():
            return "cpu"
        device = torch.device("cuda", torch.cuda.current_device())
    key = _BACKENDS.get(device)
    if key is None:
        dev = torch.device(device)
        if dev.type != "cuda":
            key = dev.type
        else:
            idx = dev.index if dev.index is not None \
                else torch.cuda.current_device()
            major, minor = torch.cuda.get_device_capability(idx)
            key = f"cuda-sm{major}{minor}"
        _BACKENDS[device] = key
    return key


def _parse_pin(text: str) -> Dict[str, int]:
    out = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition("=")
        out[k.strip()] = int(v)
    return out


def check_geometry(kernel: str, geometry: Dict[str, int],
                   source: str) -> Dict[str, int]:
    """``geometry`` if every parameter is one of ``kernel``'s and within
    :data:`BOUNDS`; raises ``ValueError`` naming ``source`` otherwise."""
    if kernel not in DEFAULTS:
        raise ValueError(f"{source}: {kernel!r} is not a tuned kernel; "
                         f"tuned: {sorted(DEFAULTS)}")
    for name, v in geometry.items():
        if name not in DEFAULTS[kernel]:
            raise ValueError(f"{source}: {kernel} has no parameter "
                             f"{name!r}; its parameters: "
                             f"{sorted(DEFAULTS[kernel])}")
        lo, hi, pow2 = BOUNDS[name]
        if not isinstance(v, int) or not lo <= v <= hi or \
                (pow2 and v & (v - 1)):
            raise ValueError(f"{source}: {name}={v!r} is outside its bounds "
                             f"[{lo}, {hi}]" +
                             (", a power of two" if pow2 else ""))
    return geometry


def _pin(name: str, text: str) -> Dict[str, int]:
    """The checked pin of environment variable ``name``."""
    kernel = name[len(_ENV_PIN_PREFIX):].lower()
    try:
        pin = _parse_pin(text)
    except ValueError:
        raise ValueError(
            f"malformed {name}={text!r}; expected 'k=v,k=v' ints") from None
    return check_geometry(kernel, pin, f"{name}={text!r}")


def env_pins() -> Dict[str, Dict[str, int]]:
    """{kernel: geometry} pinned via ``REPRO_TORCH_TUNE_<KERNEL>``; raises
    ``ValueError`` naming the variable for a malformed pin, an unknown
    kernel or parameter, or a value outside its bounds."""
    return {name[len(_ENV_PIN_PREFIX):].lower(): _pin(name, val)
            for name, val in os.environ.items()
            if name.startswith(_ENV_PIN_PREFIX)}


class AutotuneCache:
    """Persistent JSON store of tuned geometries.

    Entries: ``{key: {"geometry": {...}, "us": float, "trials": int}}`` with
    ``key = kernel|bucket|dtype|backend``.  ``store`` persists at once and
    bumps the global geometry version; ``measured_on`` (the card a run
    measured on) is kept beside the entries.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path or default_cache_path()
        self.entries: Dict[str, Dict] = {}
        self.measured_on: Optional[str] = None
        _bump()
        if os.path.exists(self.path):
            self.load()

    @staticmethod
    def key(kernel: str, bucket: str, dtype: str, backend: str) -> str:
        return "|".join((kernel, bucket, dtype, backend))

    def load(self) -> None:
        with open(self.path) as f:
            text = f.read()
        rec = json.loads(text) if text.strip() else {}
        self.entries = rec.get("entries", {})
        self.measured_on = rec.get("measured_on")
        _bump()

    def save(self) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        rec = {"format": 1, "entries": self.entries}
        if self.measured_on is not None:
            rec["measured_on"] = self.measured_on
        with open(self.path, "w") as f:
            json.dump(rec, f, indent=1, sort_keys=True)
            f.write("\n")

    def lookup(self, kernel: str, bucket: str, dtype: str,
               backend: str) -> Optional[Dict[str, int]]:
        e = self.entries.get(self.key(kernel, bucket, dtype, backend))
        return dict(e["geometry"]) if e else None

    def store(self, kernel: str, bucket: str, dtype: str, backend: str,
              geometry: Dict[str, int], us: float, trials: int) -> None:
        self.entries[self.key(kernel, bucket, dtype, backend)] = {
            "geometry": dict(geometry), "us": round(float(us), 2),
            "trials": int(trials)}
        self.save()
        _bump()


_CACHE: Optional[AutotuneCache] = None


def get_cache() -> AutotuneCache:
    """The process cache, loaded from :func:`default_cache_path` (again
    whenever that path changes)."""
    global _CACHE
    if _CACHE is None or _CACHE.path != default_cache_path():
        _CACHE = AutotuneCache()
    return _CACHE


def set_cache(cache: Optional[AutotuneCache]) -> None:
    """Swap the process cache (``None`` re-resolves from the environment)."""
    global _CACHE
    _CACHE = cache
    _bump()


def geometry_token() -> Tuple:
    """Hashable snapshot of the ambient tuning state.

    Equal tokens guarantee every :func:`lookup` resolves identically, so
    steps keyed on the token are built anew exactly when a re-tune (or a
    pin change) could alter a kernel's plan, and never otherwise.
    """
    get_cache()
    pins = tuple(sorted((k, tuple(sorted(v.items())))
                        for k, v in env_pins().items()))
    return (_VERSION, pins)


def lookup(kernel: str, shapes: Dict[str, int], *, dtype: str = "int8",
           device=None,
           cache: Optional[AutotuneCache] = None) -> Dict[str, int]:
    """Resolve the geometry of one kernel call (never measures).

    Precedence: :data:`DEFAULTS` <- cached winner for ``(kernel,
    shape_bucket(shapes), dtype, backend_key(device))`` <- the
    ``REPRO_TORCH_TUNE_<KERNEL>`` pin.  A cache entry or pin with a
    parameter the kernel lacks, or a value outside :data:`BOUNDS`, raises.
    """
    global _MEMO_VERSION
    c = cache if cache is not None else get_cache()
    backend = backend_key(device)
    pin = os.environ.get(_ENV_PIN_PREFIX + kernel.upper())
    if _MEMO_VERSION != _VERSION:
        _MEMO.clear()
        _MEMO_VERSION = _VERSION
    memo = (kernel, tuple(shapes.items()), dtype, backend, id(c), pin)
    geom = _MEMO.get(memo)
    if geom is None:
        if kernel not in DEFAULTS:
            raise ValueError(f"autotune.lookup: {kernel!r} is not a tuned "
                             f"kernel; tuned: {sorted(DEFAULTS)}")
        geom = dict(DEFAULTS[kernel])
        bucket = shape_bucket(shapes)
        hit = c.lookup(kernel, bucket, dtype, backend)
        if hit:
            geom.update(check_geometry(kernel, hit, f"{c.path}: "
                        f"{c.key(kernel, bucket, dtype, backend)}"))
        if pin:
            geom.update(_pin(_ENV_PIN_PREFIX + kernel.upper(), pin))
        _MEMO[memo] = geom
    return dict(geom)


def candidates(kernel: str, shapes: Dict[str, int]) -> List[Dict[str, int]]:
    """The candidates of :data:`SPACES` that ``kernel``'s plan reads at
    ``shapes``: for ``imc_mac``/``imc_mac_dequant`` the split-K kernel's
    parameters at M <= 16, the tensor-core kernel's above."""
    space = SPACES[kernel]
    if kernel in ("imc_mac", "imc_mac_dequant"):
        from repro_torch.kernels.imc_mac.ops import SPLIT_MAX_M

        prefix = "sk_" if shapes["m"] <= SPLIT_MAX_M else "tc_"
        space = [g for g in space if all(p.startswith(prefix) for p in g)]
    return [dict(g) for g in space]


# ------------------------------------------------------------- measurement
def _inputs(kernel: str, shapes: Dict[str, int], device):
    """``call(geometry) -> output`` of ``kernel`` on operands of ``shapes``
    made from seed 0 on ``device`` (uniform codes; {0, 1} bits for
    ``rbl_decode_mac``; calibrated mismatch under one seed for the noisy
    kernel)."""
    g = torch.Generator(device=device).manual_seed(0)
    m, k, n = shapes["m"], shapes["k"], shapes["n"]

    def codes(lo, hi, *shape, dtype=torch.uint8):
        return torch.randint(lo, hi, shape, generator=g, device=device,
                             dtype=dtype)

    if kernel in ("imc_mac", "imc_mac_dequant"):
        from repro_torch.kernels.imc_mac.ops import imc_mac, imc_mac_dequant

        qa = codes(-128, 128, m, k, dtype=torch.int8)
        qw = codes(-128, 128, k, n, dtype=torch.int8)
        if kernel == "imc_mac":
            return lambda geom: imc_mac(qa, qw, geometry=geom)
        sa = torch.rand((1,), generator=g, device=device) * 1e-2
        sw = torch.rand((n,), generator=g, device=device) * 1e-2
        return lambda geom: imc_mac_dequant(qa, qw, sa, sw, geometry=geom)
    if kernel in ("bitplane_mac", "bitplane_mac_noisy"):
        from repro_torch.kernels.bitplane_mac.ops import (bitplane_mac,
                                                          bitplane_mac_noisy)
        from repro_torch.kernels.common import seed_row

        ba, bw, rows = shapes["ba"], shapes["bw"], shapes["rows"]
        ua, uw = codes(0, 1 << ba, m, k), codes(0, 1 << bw, k, n)
        kw = dict(bits_a=ba, bits_w=bw, rows=rows)
        if kernel == "bitplane_mac":
            return lambda geom: bitplane_mac(ua, uw, geometry=geom, **kw)
        from repro_torch.core.fabric import NoiseSpec

        seed = seed_row(7, device)
        sigma = NoiseSpec.calibrated().mismatch_sigma
        return lambda geom: bitplane_mac_noisy(
            ua, uw, seed, mismatch_sigma=sigma, geometry=geom, **kw)
    from repro_torch.kernels.rbl_decode.ops import rbl_decode_mac

    a, w = codes(0, 2, m, k), codes(0, 2, k, n)
    return lambda geom: rbl_decode_mac(a, w, rows=shapes["rows"],
                                       geometry=geom)


def graph_us(call: Callable[[], object], launches: int, repeats: int) -> float:
    """Device time of one ``call()`` in µs: ``launches`` calls captured in one
    CUDA graph, replayed ``repeats`` times, each replay timed with CUDA
    events, the best replay over ``launches``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            call()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(repeats):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best * 1e3 / launches


def card_measure(kernel: str, shapes: Dict[str, int], device=None, *,
                 launches: int = 20, repeats: int = 5
                 ) -> Callable[[Dict[str, int]], float]:
    """``measure(geometry) -> µs`` on the card: the output under
    ``geometry`` checked equal, bit for bit, to the default geometry's
    (raises ``RuntimeError`` where it differs), then :func:`graph_us`.  The
    launches it makes are taken back off the wrappers' counters."""
    from repro_torch.kernels import launches as counters

    dev = torch.device(device) if device is not None else None
    if backend_key(dev) == "cpu":
        raise RuntimeError(f"autotune: no {kernel} kernel to time on the "
                           "CPU (tune on the card, or hand tune() a "
                           "measure function)")
    dev = dev or torch.device("cuda", torch.cuda.current_device())
    call = _inputs(kernel, shapes, dev)
    before = counters.snapshot()
    want = call(DEFAULTS[kernel]).clone()
    counters.restore(before)

    def measure(geom: Dict[str, int]) -> float:
        before = counters.snapshot()
        try:
            got = call(geom)
            if not torch.equal(got, want):
                raise RuntimeError(
                    f"autotune: {kernel} at {shape_bucket(shapes)} under "
                    f"{geom} differs from the default geometry's output")
            return graph_us(lambda: call(geom), launches, repeats)
        finally:
            counters.restore(before)

    return measure


def tune(kernel: str, shapes: Dict[str, int],
         space: Optional[List[Dict[str, int]]] = None, *,
         dtype: Optional[str] = None, device=None,
         measure: Optional[Callable[[Dict[str, int]], float]] = None,
         launches: int = 20, repeats: int = 5,
         cache: Optional[AutotuneCache] = None, registry=None,
         timings: Optional[List[Tuple[Dict[str, int], float]]] = None
         ) -> Dict[str, int]:
    """Measure every candidate and cache the winner; returns its geometry.

    ``space`` defaults to :func:`candidates`; ``measure(geometry) -> µs``
    to :func:`card_measure` (which raises on the CPU).  ``timings``, if
    given, gets each trial's (geometry, µs).  An already cached (kernel,
    bucket, dtype, backend) cell returns at once with ZERO trials: delete
    its entry (or point ``REPRO_TORCH_AUTOTUNE_CACHE`` at a fresh file) to
    tune it again.
    """
    c = cache if cache is not None else get_cache()
    reg = registry if registry is not None else get_registry()
    dtype = dtype or KERNEL_DTYPES[kernel]
    bucket = shape_bucket(shapes)
    backend = backend_key(device)
    cached = c.lookup(kernel, bucket, dtype, backend)
    if cached is not None:
        return cached
    space = space if space is not None else candidates(kernel, shapes)
    if not space:
        raise ValueError(f"empty candidate space for {kernel!r}")
    if measure is None:
        measure = card_measure(kernel, shapes, device, launches=launches,
                               repeats=repeats)
    trials = reg.counter("autotune.trials")
    hist = reg.histogram("autotune.trial_us")
    best_geom, best_us = None, float("inf")
    with span("autotune.tune", kernel=kernel, bucket=bucket,
              backend=backend):
        for cand in space:
            geom = check_geometry(kernel, {**DEFAULTS[kernel], **cand},
                                  "autotune.tune")
            us = measure(geom)
            trials.inc()
            hist.observe(us)
            if timings is not None:
                timings.append((geom, us))
            if us < best_us:
                best_geom, best_us = geom, us
    c.store(kernel, bucket, dtype, backend, best_geom, best_us, len(space))
    return dict(best_geom)


# The operand dtype each wrapper looks its kernel up under.
KERNEL_DTYPES = {"imc_mac": "int8", "imc_mac_dequant": "int8",
                 "bitplane_mac": "uint8", "bitplane_mac_noisy": "uint8",
                 "rbl_decode_mac": "uint8"}

# The shapes the served and macro paths launch, each a cell where the
# candidates give more than one plan (K, N: imc-paper-110m's projections).
_PAPER = ((768, 768), (768, 3072), (3072, 768))
_PLANES = {"ba": 8, "bw": 8, "rows": 8}
STANDARD_CELLS: List[Tuple[str, Dict[str, int]]] = (
    [("imc_mac", {"m": 4, "k": k, "n": n}) for k, n in _PAPER] +
    [("imc_mac", {"m": 4, "k": 29568, "n": 8192})] +  # qwen2-72b: gmax binds
    [("imc_mac", {"m": 64, "k": k, "n": n}) for k, n in _PAPER] +
    [("imc_mac_dequant", {"m": 64, "k": 768, "n": 3072})] +
    [("bitplane_mac", {"m": 4, "k": k, "n": n, **_PLANES})
     for k, n in _PAPER] +
    [("bitplane_mac_noisy", {"m": 4, "k": 768, "n": 3072, **_PLANES})] +
    [("rbl_decode_mac", {"m": 64, "k": 768, "n": 3072, "rows": 8}),
     ("rbl_decode_mac", {"m": 4, "k": 768, "n": 3072, "rows": 8})])
# Shapes a path launches that tune_standard leaves out: every candidate
# gives them the same plan, so there is nothing to measure.
LEFT_OUT: List[Tuple[str, Dict[str, int], str]] = [
    ("imc_mac", {"m": 2048, "k": 768, "n": 3072},
     "training's M = 2048: 3,072 tiles of 64 x 32 exceed every target, one "
     "split under each candidate"),
    ("bitplane_mac", {"m": 512, "k": 768, "n": 3072, **_PLANES},
     "training's sim M = 512 takes the tensor-core kernel, whose plan "
     "reads no target"),
]


def tune_standard(smoke: bool = True, registry=None,
                  device=None) -> List[Dict]:
    """Tune :data:`STANDARD_CELLS` on the card (``chip_smoke.py
    --autotune`` runs it with ``smoke=True``: fewer launches a graph and
    fewer replays; ``smoke=False`` made the committed ``tuned.json``).
    Returns one row per cell: kernel, bucket, backend, the winning
    geometry and its µs, the default geometry's µs (None for a cached cell,
    which runs no trial) and the trials run."""
    launches, repeats = (10, 3) if smoke else (50, 10)
    rows = []
    for kernel, shapes in STANDARD_CELLS:
        timings: List[Tuple[Dict[str, int], float]] = []
        geom = tune(kernel, shapes, device=device, launches=launches,
                    repeats=repeats, registry=registry, timings=timings)
        by_geom = {tuple(sorted(g.items())): us for g, us in timings}
        default = tuple(sorted(DEFAULTS[kernel].items()))
        rows.append({
            "kernel": kernel, "shapes": dict(shapes),
            "bucket": shape_bucket(shapes), "backend": backend_key(device),
            "geometry": geom, "us": by_geom.get(tuple(sorted(geom.items()))),
            "default_us": by_geom.get(default), "trials": len(timings)})
    return rows
