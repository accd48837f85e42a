"""Engine: the step runtime of the served path (port of
``repro/launch/engine.py``).

The reference's Engine owns a mesh, a cache of jitted steps and the noise
keys; the port's owns what running one H100 needs:

  * **step cache** — :meth:`Engine.prefill_step` (one per prefill bucket),
    :meth:`Engine.decode_step`, :meth:`Engine.admit_step` and
    :meth:`Engine.train_step` (one per ``AdamWConfig``) are memoized on
    ``(ModelConfig, kind, extras, FabricSpec, autotune.geometry_token())``:
    equal keys return the same step.  The token moves when the kernels'
    launch plans could (a cache store or load, a pin change:
    :mod:`repro_torch.kernels.autotune`), so a graph that captured one plan
    is never replayed under another: the next step asked for is a new one,
    captured anew once.  :attr:`Engine.stats` counts cache hits and distinct steps
    (``compiles``).  The train step runs eagerly (a captured train step is
    ROADMAP work); the serving steps are :class:`Step` objects.
  * **CUDA graphs** — a :class:`Step` binds its inputs to static buffers
    the first time it sees an argument set (the objects it reads by
    reference, such as the params and the serving state, and the shapes of
    what it copies in).  On the card it then warms up on a side stream,
    captures the step with ``torch.cuda.graph`` and, on every call, copies
    its inputs in and replays: the hand-written kernels run from inside the
    graph.  A failed capture raises; nothing falls back to eager.  With
    ``graphs=False``, or on the CPU (where CUDA graphs do not exist), the
    same static-buffer protocol runs with the step function called in place
    of the replay: copy-in, seed table, in-place state, copy-out into the
    binding's output buffers.  ``stats.captures`` counts bindings (each one
    graph captured when graphs run) and ``stats.replays`` runs from them.
  * **launch counts** — kernel wrappers count their launches in Python,
    which a replay does not run: each binding records the launches of its
    capture and adds them to the wrappers' counters on every replay
    (:mod:`repro_torch.kernels.launches`), so the counters still count
    launches on the device.
  * **noise seeds** — one base seed per Engine; :meth:`Engine.noise_seed`
    mixes in the step and the slot (the reference's ``noise_key``).  A
    noisy step's call writes ``seed_words(mix_seed(step_seed, n))`` for
    each of its ``dense`` calls ``n`` into its seed table, in the same one
    host-to-device copy as its inputs, before the replay.
  * **serving state** — :meth:`Engine.serve_state` allocates a serving
    geometry's batch cache once; graphs hold its addresses, so a Server
    resets it in place (:meth:`ServeState.take`) when it starts and after a
    fault instead of allocating anew: neither causes a capture.  A warm-up
    before a capture runs on the real state, never on a copy of it: the
    decode step is bound while the state is still to be zeroed
    (:meth:`Step.bind`).
  * **runtime hooks** — an optional :class:`StragglerMonitor` fed by
    :meth:`Engine.observe_step_time`; flagged hosts accumulate in
    :attr:`Engine.swap_requests`.
  * **telemetry** — ``engine.compiles``, ``engine.cache_hits``,
    ``engine.captures`` and ``engine.replays`` counters, and per kind the
    ``engine.step_s.<kind>`` histogram of a call's host time (no sync is
    added: a replay returns once it is queued).

Not ported: ``activate``, ``shard_params``, ``shard_batch`` and
``aot_compile`` exist for XLA's meshes, SPMD partitioning and ahead-of-time
lowering; one H100 runs none of them.
"""
from __future__ import annotations

import gc
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import autotune, launches
from repro_torch.kernels.common import mix_seed, seed_table
from repro_torch.launch import steps
from repro_torch.models.transformer import dense_calls
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.telemetry import Registry, clock, get_registry


@dataclass
class EngineStats:
    """Step-cache and graph counters (the serve tests' recapture detector)."""

    compiles: int = 0  # distinct steps built
    captures: int = 0  # static-buffer bindings: one CUDA graph each, on
    # the card with graphs on
    replays: int = 0  # runs from a binding: graph replays with graphs on
    hits: int = 0  # step-cache hits


def _tensors(tree) -> List[torch.Tensor]:
    """Every tensor of ``tree`` (tuples, NamedTuples, lists and dicts), in
    order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (tuple, list)):
        return []
    return [t for sub in tree for t in _tensors(sub)]


class _Binding:
    """One argument set of a :class:`Step`: its objects read by reference,
    one int32 arena holding every input it copies in and its seed table (on
    the device, filled from a host arena by one copy), its outputs and, when
    graphs run, its CUDA graph and the launches the graph makes."""

    def __init__(self, step: "Step", refs: Tuple, inputs: Dict[str, np.ndarray]):
        self.step = step
        self.refs = refs  # held: the graph reads their memory
        dev = step.engine.device
        cuda = dev.type == "cuda"
        shapes = {k: np.shape(v) for k, v in inputs.items()}
        sizes = [int(np.prod(s)) for s in shapes.values()]
        total = sum(sizes) + 2 * step.calls
        self.host = torch.empty((total,), dtype=torch.int32, pin_memory=cuda)
        self.arena = torch.empty((total,), dtype=torch.int32, device=dev)
        host_np = self.host.numpy()
        self.host_views, self.views = {}, {}
        o = 0
        for (name, shape), n in zip(shapes.items(), sizes):
            self.host_views[name] = host_np[o:o + n].reshape(shape)
            self.views[name] = self.arena[o:o + n].view(shape)
            o += n
        if step.calls:
            self.host_seeds = host_np[o:].reshape(step.calls, 2)
            self.views["seeds"] = self.arena[o:].view(step.calls, 2)
        self.copied = torch.cuda.Event() if cuda else None
        self.graph = None
        self.outputs = None
        self.delta: Tuple[int, ...] = ()

    def fill(self, inputs: Dict[str, np.ndarray], seed: Optional[int]):
        """Copy-in: the inputs and the seed table, one host-to-device copy
        (the host arena is rewritten only once the last copy has read it)."""
        if self.copied is not None:
            self.copied.synchronize()
        for name, arr in inputs.items():
            self.host_views[name][...] = arr
        if self.step.calls:
            if seed is None:
                raise ValueError(f"{self.step.kind} step of a noisy fabric "
                                 "needs a seed")
            self.host_seeds[...] = seed_table(seed, self.step.calls)
        self.arena.copy_(self.host, non_blocking=True)
        if self.copied is not None:
            self.copied.record()

    def call(self, refs):
        return self.step.fn(*refs, **self.views)

    def capture(self):
        """Warm up on a side stream, then capture.  The warm-up runs the
        step for real on its own refs (see :meth:`Step.bind`)."""
        cur = torch.cuda.current_stream(self.arena.device)
        side = torch.cuda.Stream(self.arena.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.call(self.refs)
        cur.wait_stream(side)
        before = launches.snapshot()
        graph = torch.cuda.CUDAGraph()
        # No cyclic garbage collection inside the capture: an earlier
        # Engine's graph or event collected there frees CUDA resources
        # mid-capture, which invalidates it (CUDA error 901 at the next
        # launch; seen in gemma3-12b's 9b capture after 9a's serves).
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                out = self.call(self.refs)
        finally:
            if collecting:
                gc.enable()
        self.delta = launches.diff(launches.snapshot(), before)
        launches.restore(before)
        self.graph, self.outputs = graph, out

    def run(self):
        if self.graph is not None:
            self.graph.replay()
            launches.add(self.delta)
            return self.outputs
        out = self.call(self.refs)
        if self.outputs is None:
            self.outputs = out  # the first run's outputs are the buffers
        else:  # copy-out into them
            for dst, src in zip(_tensors(self.outputs), _tensors(out)):
                dst.copy_(src)
        return self.outputs


class Step:
    """One cached step: ``fn`` bound to static buffers per argument set.

    ``step(refs, inputs, seed)`` runs ``fn(*refs, **inputs_on_device,
    seeds=seed_table)``: ``refs`` are read (and written, for a step that
    updates a state) in place, ``inputs`` are int32 numpy arrays copied
    in.  Returns the step's outputs: static buffers, rewritten by the next
    call of the same binding, so read them before it.

    ``bind_first`` marks a step whose call is not idempotent in its state
    (decode advances the positions): its bindings are made by :meth:`bind`
    while the state is disposable, and a call with a new argument set
    raises.
    """

    def __init__(self, engine: "Engine", kind: str, fn: Callable,
                 calls: int = 0, bind_first: bool = False):
        self.engine, self.kind, self.fn = engine, kind, fn
        self.calls, self.bind_first = calls, bind_first
        self._bindings: Dict[Tuple, _Binding] = {}
        self._hist = engine.registry.histogram(f"engine.step_s.{kind}")

    @staticmethod
    def _key(refs: Tuple, inputs: Dict[str, np.ndarray]) -> Tuple:
        return (tuple(id(r) for r in refs),
                tuple((k, np.shape(v)) for k, v in inputs.items()))

    def bind(self, refs: Sequence, inputs: Dict[str, np.ndarray],
             seed: Optional[int] = 0) -> _Binding:
        """The binding of ``refs`` and of ``inputs``' shapes, made if it is
        new: its buffers filled from ``inputs`` and ``seed`` and, when
        graphs run, the step warmed up and captured.

        The warm-up runs the step for real on ``refs``, so it must leave
        them as the replay that follows will: a prefill writes none of its
        refs, and an admission's scatter writes the same bytes to the same
        rows twice.  A decode step would advance its state twice; the Server
        binds it when it takes the state, before zeroing it
        (:meth:`ServeState.take`).  No state is copied for the warm-up.
        """
        refs = tuple(refs)
        key = self._key(refs, inputs)
        b = self._bindings.get(key)
        if b is None:
            eng = self.engine
            with torch.inference_mode():
                b = _Binding(self, refs, inputs)
                b.fill(inputs, seed)
                if eng.graphs:
                    b.capture()
            self._bindings[key] = b
            eng.stats.captures += 1
            eng.registry.counter("engine.captures").inc()
        return b

    def __call__(self, refs: Sequence, inputs: Dict[str, np.ndarray],
                 seed: Optional[int] = None):
        eng = self.engine
        t0 = clock()
        refs = tuple(refs)
        b = self._bindings.get(self._key(refs, inputs))
        if b is None:
            if self.bind_first:
                raise RuntimeError(
                    f"the {self.kind} step updates its state: bind it "
                    "(Step.bind) while that state is disposable")
            b = self.bind(refs, inputs, seed)
        with torch.inference_mode():
            b.fill(inputs, seed)
            out = b.run()
        eng.stats.replays += 1
        eng.registry.counter("engine.replays").inc()
        if eng.registry.enabled:
            self._hist.observe(clock() - t0)
        return out


class ServeState:
    """One serving geometry's batch cache (paged pools or per-slot rings,
    and ``pos``), allocated once per Engine.  Graphs hold its addresses, so
    a Server takes it with :meth:`take`, which zeroes it in place (a fresh
    cache is zeros); one Server holds it at a time."""

    def __init__(self, cache):
        self.cache = cache
        self.owner = None

    def take(self, owner) -> None:
        with torch.inference_mode():
            for t in _tensors(self.cache):
                t.zero_()
        self.owner = owner


class Engine:
    """One step cache, one noise-seed stream, one device.

    ``device`` resolves through :func:`repro_torch.device.resolve_device`:
    the card unless the CPU is asked for.  ``graphs=False`` asks for eager
    steps on the card (the oracle and the A/B of ``chip_smoke.py``); on the
    CPU steps always run eagerly.
    """

    def __init__(self, device: DeviceLike = None, noise_seed: int = 0,
                 monitor: Optional[StragglerMonitor] = None,
                 registry: Optional[Registry] = None, graphs: bool = True):
        self.device = resolve_device(device)
        self.base_seed = noise_seed
        self.monitor = monitor
        self.registry = registry if registry is not None else get_registry()
        self.graphs = bool(graphs) and self.device.type == "cuda"
        self.stats = EngineStats()
        self.swap_requests: List[int] = []
        self._steps: Dict[Tuple, Step] = {}
        self._states: Dict[Tuple, ServeState] = {}

    # ---------------------------------------------------------- noise seeds
    def noise_seed(self, step: int, slot: int = 0) -> int:
        """Per-(step, slot) 64-bit seed ``mix_seed(noise_seed, step, slot)``:
        two Engines with one ``noise_seed`` replay identical noise."""
        return mix_seed(self.base_seed, step, slot)

    # ----------------------------------------------------------- step cache
    def _cached_step(self, cfg: ModelConfig, kind: str, extras: Tuple,
                     build: Callable[[], Callable]) -> Callable:
        key = (cfg, kind, extras, cfg.imc_fabric, autotune.geometry_token())
        step = self._steps.get(key)
        if step is None:
            step = self._steps[key] = build()
            self.stats.compiles += 1
            self.registry.counter("engine.compiles").inc()
        else:
            self.stats.hits += 1
            self.registry.counter("engine.cache_hits").inc()
        return step

    @staticmethod
    def _noise_calls(cfg: ModelConfig) -> int:
        spec = cfg.imc_fabric
        return dense_calls(cfg) if spec is not None and spec.noisy else 0

    def prefill_step(self, cfg: ModelConfig, max_new_tokens: int = 0,
                     bucket: Optional[int] = None) -> Step:
        """``step((params,), {"tokens": (1, S)[, "length": ()]}, seed) ->
        (last_logits, cache)``; one step (one graph) per prompt bucket."""
        extras = (max_new_tokens,) if bucket is None \
            else (max_new_tokens, bucket)
        return self._cached_step(cfg, "prefill", extras, lambda: Step(
            self, "prefill", steps.make_prefill_step(cfg, max_new_tokens),
            calls=self._noise_calls(cfg)))

    def decode_step(self, cfg: ModelConfig) -> Step:
        """``step((params, cache), {"token": (B, 1)[, "block_table": (B,
        MB)]}, seed) -> logits``; the cache (ring or paged) is updated in
        place.  Bound with :meth:`Step.bind` before the cache holds
        anything."""
        return self._cached_step(cfg, "decode", (), lambda: Step(
            self, "decode", steps.make_serve_step(cfg),
            calls=self._noise_calls(cfg), bind_first=True))

    def admit_step(self, cfg: ModelConfig) -> Step:
        """``step((cache, one), {"slot": ()[, "table_row": (MB,)]})``:
        scatter one request's prefilled cache into the batch cache; one
        binding (one graph) per prefill step whose output it reads."""
        return self._cached_step(cfg, "admit", (), lambda: Step(
            self, "admit", steps.admit_step))

    def train_step(self, cfg: ModelConfig,
                   opt_cfg: AdamWConfig = AdamWConfig()) -> Callable:
        """``step(params, opt_state, batch, seed) -> (params, opt_state,
        metrics)`` (:func:`~repro_torch.launch.steps.make_train_step`), run
        eagerly; ``seed`` is :meth:`noise_seed` of the step (read only by a
        noisy fabric).  Each call's host time lands in
        ``engine.step_s.train``."""
        def build():
            fn = steps.make_train_step(cfg, opt_cfg)
            hist = self.registry.histogram("engine.step_s.train")

            def train_step(params, opt_state, batch, seed=None):
                t0 = clock()
                out = fn(params, opt_state, batch, seed)
                if self.registry.enabled:
                    hist.observe(clock() - t0)
                return out

            return train_step

        return self._cached_step(cfg, "train", (opt_cfg,), build)

    # -------------------------------------------------------------- state
    def serve_state(self, cfg: ModelConfig, geometry: Tuple,
                    build: Callable[[], object]) -> ServeState:
        """The :class:`ServeState` of ``(cfg, geometry)``, built once."""
        key = (cfg, cfg.imc_fabric, geometry)
        st = self._states.get(key)
        if st is None:
            with torch.inference_mode():
                st = self._states[key] = ServeState(build())
        return st

    # --------------------------------------------------------------- hooks
    def observe_step_time(self, dt: float, host: int = 0) -> List[int]:
        """Feed one step's wall time to the straggler monitor (if any).

        Returns hosts newly flagged for a hot-spare swap; they also
        accumulate in :attr:`swap_requests`.
        """
        self.registry.histogram("engine.observed_step_s").observe(dt)
        if self.monitor is None:
            return []
        flagged = self.monitor.record_step({host: dt})
        self.swap_requests.extend(flagged)
        return flagged

    def observe_step_times(self, times: Dict[int, float]) -> List[int]:
        """Feed ONE step's per-host wall times (fleet path): one
        ``record_step`` call with the whole dict, so the monitor's strike
        cadence does not scale with the fleet size."""
        for dt in times.values():
            self.registry.histogram("engine.observed_step_s").observe(dt)
        if self.monitor is None:
            return []
        flagged = self.monitor.record_step(dict(times))
        self.swap_requests.extend(flagged)
        return flagged
