"""Typed serving API: ``Server.submit(Request) -> Handle``, ``poll``, ``drain``
(port of ``repro/launch/server.py``).

An admission queue over a **paged KV cache** (see
:mod:`repro_torch.models.kv_cache`):

  * :class:`Request` carries per-request ``prompt``, ``max_new_tokens``,
    ``eos_id``, ``seed`` and ``temperature``.
  * :meth:`Server.submit` does **block budgeting**: a request is admitted
    only when the allocator can hand it ``ceil(len / block_size)`` blocks now
    and *reserve* the worst-case remainder, so an admitted request never runs
    dry mid-decode.  Requests that can never fit are rejected at submit.
  * ragged admission: each prompt is right-padded to the smallest configured
    **bucket** and prefilled with its true ``length``.
  * decode runs all active slots in lockstep; the per-slot block table rides
    along, so growing, finishing and re-admitting requests is data-only.
  * finished slots release their blocks at once (``eos_id`` or
    ``max_new_tokens``), and fault injection (``fail_at``) re-queues
    in-flight requests (greedy decode replays identical streams).

``kv="ring"`` keeps the fixed-ring geometry (one ring per slot, uniform
prompt length) behind the same API — the oracle the paged path is tested
against.

Every model invocation is a step of an :class:`~repro_torch.launch.engine
.Engine`: one prefill step per bucket, one admission step and one decode
step, each bound to static buffers and, on the card, captured once as a CUDA
graph and replayed (``engine=`` shares an Engine between servers; by default
each Server builds its own).  The batch cache is the Engine's
:class:`~repro_torch.launch.engine.ServeState`, taken (zeroed in place) when
a server starts and after a fault, so neither a new server nor a recovery
captures anew.  Each invocation takes the Engine's noise seed
``mix_seed(noise_seed, tick, slot)`` (the reference's ``_next_key``), so a
noisy fabric replays the same token streams under the same ``noise_seed``.
Sampling stays on the host: the logits are copied out after each step.
Each decode step's device-complete wall time feeds
:meth:`Engine.observe_step_time` under ``host``.

Serving SLOs are host-side telemetry in the server's registry:
``server.ttft_s``, ``server.tpot_s``, ``server.admitted`` /
``server.rejected`` / ``server.recoveries``, ``server.queue_depth``,
``server.block_occupancy``, ``server.decode_tokens``,
``server.decode_step_s`` and ``server.decode_tokens_per_s``.  Every timed
region ends in a device-to-host copy of the logits, so the times are
device-complete.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, device_of, resolve_device
from repro_torch.launch.engine import Engine, ServeState
from repro_torch.models.kv_cache import (BlockAllocator, broadcast_slots,
                                         init_paged_cache)
from repro_torch.models.transformer import StackCache, check_supported
from repro_torch.runtime.fault_tolerance import InjectedFailure
from repro_torch.telemetry import Registry, clock, get_registry, span


@dataclass(frozen=True)
class Request:
    """One generation request (immutable; results live on the Handle)."""

    prompt: np.ndarray  # (S,) int32 token ids
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    seed: int = 0
    temperature: float = 0.0  # 0 -> greedy argmax


@dataclass
class Handle:
    """Mutable view of one submitted request's progress."""

    rid: int
    request: Request
    status: str = "queued"  # queued | active | done | rejected
    tokens: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    reason: str = ""  # set when rejected
    _next_pos: int = 0  # next KV position this slot writes (host-side)
    _rng: Optional[np.random.Generator] = None
    _t_submit: float = 0.0  # telemetry clock at submit (TTFT start)
    _t_first: float = 0.0  # telemetry clock at first token (TPOT start)

    @property
    def done(self) -> bool:
        return self.status == "done"


class Server:
    """Continuous-batching server over a paged (or ring) KV cache.

    Parameters
    ----------
    engine: the :class:`~repro_torch.launch.engine.Engine` whose steps serve
        every prefill, admission and decode; ``None`` builds one on the
        server's device with the server's ``noise_seed`` and registry.
    slots: max concurrent requests (the lockstep decode batch).
    kv: ``"paged"`` (block tables, ragged admission) or ``"ring"`` (the
        fixed-ring oracle; uniform ``len(prompt)`` and ``max_new_tokens``).
    block_size / num_blocks: paged pool geometry.  ``num_blocks`` defaults
        to ``slots * ceil(max_seq_len / block_size)``.
    buckets: padded prompt lengths to prefill at (ascending).
    max_seq_len: hard per-request cap on ``len(prompt) + max_new_tokens``;
        fixes the decode step's logical attention span.
    attn_impl: paged decode attention, in the port's words (``auto``,
        ``torch`` or ``cuda``, :mod:`repro_torch.kernels.paged_attn.ops`);
        ``None`` keeps the config's.  Ignored for ``kv="ring"``.
    host: this server's fleet host index; decode-step wall times feed the
        Engine's straggler monitor under it.
    fail_at: decode tick indices at which to inject a crash (chaos drill).
    registry: telemetry registry (default: the engine's, else the
        process-global one).
    device: where ``params`` live; ``None`` means the engine's device, else
        the card (raising without one).  Pass ``"cpu"`` to serve on the CPU.
    noise_seed: the seed of a noisy fabric's noise (default 0); one seed per
        model invocation is mixed from it, the tick and the slot.  With
        ``engine=`` the engine's seed is used, and a different one raises.
    """

    def __init__(self, cfg, params, *, engine: Optional[Engine] = None,
                 slots: int = 4, kv: str = "paged", block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 buckets: Sequence[int] = (16, 32, 64),
                 max_seq_len: Optional[int] = None,
                 attn_impl: Optional[str] = None, host: int = 0,
                 fail_at: Optional[Sequence[int]] = None,
                 registry: Optional[Registry] = None,
                 device: DeviceLike = None,
                 noise_seed: Optional[int] = None):
        if kv not in ("paged", "ring"):
            raise ValueError(f"kv must be 'paged' or 'ring', got {kv!r}")
        if engine is not None and device is None:
            device = engine.device
        self.device = resolve_device(device)
        pdev = device_of(params)
        if pdev is not None and pdev.type != self.device.type:
            raise ValueError(f"params live on {pdev}, the server was asked "
                             f"to run on {self.device}")
        check_supported(cfg)
        if cfg.frontend != "none":
            raise ValueError(
                f"{cfg.name}: the Server serves token prompts, as the "
                f"reference's does; drive a {cfg.frontend} frontend's "
                "embeddings through models.model.prefill and decode_step")
        if attn_impl is not None and attn_impl != cfg.attn_impl:
            cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
        reg = registry or (engine.registry if engine is not None
                           else get_registry())
        if engine is None:
            engine = Engine(self.device, noise_seed=noise_seed or 0,
                            registry=reg)
        elif engine.device != self.device:
            raise ValueError(f"the engine runs on {engine.device}, the "
                             f"server on {self.device}")
        elif noise_seed is not None and noise_seed != engine.base_seed:
            raise ValueError(f"noise_seed={noise_seed} differs from the "
                             f"engine's {engine.base_seed}")
        self.engine = engine
        self.attn_impl = cfg.attn_impl if kv == "paged" else "ring"
        self.cfg, self.params = cfg, params
        self.slots = slots
        self.kv = kv
        self.host = host
        self.buckets = tuple(sorted(buckets))
        self.max_seq_len = max_seq_len or (max(self.buckets) + 64)
        self.block_size = block_size
        self.max_blocks = -(-self.max_seq_len // block_size)
        self.num_blocks = num_blocks or slots * self.max_blocks
        self.alloc = BlockAllocator(self.num_blocks, block_size, slots,
                                    max_blocks_per_slot=self.max_blocks)
        self._state: Optional[ServeState] = None  # taken at first admission
        self.active: List[Optional[Handle]] = [None] * slots
        self.queued: List[Handle] = []
        self.handles: List[Handle] = []
        self.recoveries = 0
        self.decode_ticks = 0
        self.decode_s = 0.0  # accumulated lockstep-decode wall time
        self._tick = 0  # one noise seed per model invocation
        self._fail_at = set(fail_at or ())
        self._ring_shape: Optional[Tuple[int, int]] = None
        self._decode = engine.decode_step(cfg)
        self._admit_step = engine.admit_step(cfg)
        self._prefills: Dict[Optional[int], object] = {}
        self.registry = reg
        self._m_admitted = reg.counter("server.admitted")
        self._m_rejected = reg.counter("server.rejected")
        self._m_recoveries = reg.counter("server.recoveries")
        self._m_decode_tokens = reg.counter("server.decode_tokens")
        self._m_queue = reg.gauge("server.queue_depth")
        self._m_occupancy = reg.gauge("server.block_occupancy")
        self._m_tok_s = reg.gauge("server.decode_tokens_per_s")
        self._m_ttft = reg.histogram("server.ttft_s")
        self._m_tpot = reg.histogram("server.tpot_s")
        self._m_step = reg.histogram("server.decode_step_s")

    @property
    def cache(self) -> Optional[StackCache]:
        """The batch cache (the engine's state), None before the first
        admission and after a fault."""
        return None if self._state is None else self._state.cache

    def _feed_gauges(self):
        """Occupancy from the allocator's free list + queue depth."""
        self._m_queue.set(len(self.queued))
        if self.kv == "paged":
            used = self.num_blocks - self.alloc.num_free
            self._m_occupancy.set(used / self.num_blocks)
        if self.decode_s > 0:
            self._m_tok_s.set(self._m_decode_tokens.value / self.decode_s)

    # ----------------------------------------------------------- public API
    def submit(self, request: Request) -> Handle:
        """Queue a request; returns its Handle (possibly already rejected)."""
        h = Handle(len(self.handles), request)
        h._t_submit = clock()
        self.handles.append(h)
        plen = int(len(request.prompt))
        worst = plen + request.max_new_tokens
        if self.kv == "paged":
            if plen > max(self.buckets):
                h.status, h.reason = "rejected", (
                    f"prompt length {plen} exceeds the largest prefill "
                    f"bucket {max(self.buckets)}")
                self._m_rejected.inc()
                return h
            if worst > self.max_seq_len or \
                    self.alloc.blocks_for(worst) > self.num_blocks:
                h.status, h.reason = "rejected", (
                    f"worst case {worst} tokens can never fit "
                    f"(max_seq_len={self.max_seq_len}, "
                    f"pool={self.num_blocks}x{self.block_size})")
                self._m_rejected.inc()
                return h
        else:
            if self._ring_shape is None:  # first request pins the geometry
                self._ring_shape = (plen, request.max_new_tokens)
            if (plen, request.max_new_tokens) != self._ring_shape:
                h.status, h.reason = "rejected", (
                    f"kv='ring' serves one uniform shape "
                    f"{self._ring_shape}, got {(plen, request.max_new_tokens)}"
                    " — use kv='paged' for ragged traffic")
                self._m_rejected.inc()
                return h
        self.queued.append(h)
        self._m_admitted.inc()
        self._m_queue.set(len(self.queued))
        return h

    def poll(self) -> List[Handle]:
        """Advance one tick (admit + one lockstep decode); returns handles
        that finished on this tick."""
        with torch.inference_mode():
            self._pump()
            self._feed_gauges()
            if not any(self.active):
                return []
            try:
                if self.decode_ticks in self._fail_at:
                    self._fail_at.discard(self.decode_ticks)
                    self.decode_ticks += 1
                    raise InjectedFailure(
                        f"injected failure at decode tick "
                        f"{self.decode_ticks - 1}")
                return self._step()
            except InjectedFailure:
                self._recover()
                return []

    def drain(self) -> List[Handle]:
        """Serve every queued/active request to completion; returns all
        handles in submit order."""
        while self.queued or any(self.active):
            self.poll()
        return list(self.handles)

    # ------------------------------------------------------------ admission
    def _bucket_for(self, plen: int) -> int:
        for b in self.buckets:
            if plen <= b:
                return b
        raise ValueError(f"no bucket holds a length-{plen} prompt")

    def _next_seed(self, slot: int = 0) -> int:
        s = self.engine.noise_seed(self._tick, slot)
        self._tick += 1
        return s

    def _pump(self):
        """Admit queued requests into free slots while blocks allow."""
        for slot in range(self.slots):
            if not self.queued:
                return
            if self.active[slot] is not None:
                continue
            h = self.queued[0]
            plen = len(h.request.prompt)
            if self.kv == "paged":
                need = self.alloc.blocks_for(plen)
                reserve = self.alloc.blocks_for(
                    plen + h.request.max_new_tokens) - need
                if not self.alloc.can_admit(need + reserve):
                    return  # FIFO: wait for blocks instead of starving h
                self.alloc.alloc(slot, need, reserve=reserve)
            self.queued.pop(0)
            self._admit(h, slot)

    def _check_state(self):
        if self._state is not None and self._state.owner is not self:
            raise RuntimeError("another Server took this engine's serving "
                               "state; serve one Server at a time")

    def _take_state(self, one: StackCache):
        """Take the engine's batch cache for this geometry (built after
        ``one``, the first prefilled cache), zeroed as a fresh cache, with
        the decode step bound to it."""
        if self.kv == "paged":
            geometry = ("paged", self.slots, self.num_blocks,
                        self.block_size)

            def build():
                return init_paged_cache(one, self.slots, self.num_blocks,
                                        self.block_size)
        else:
            geometry = ("ring", self.slots, self._ring_shape)

            def build():
                return StackCache(
                    [broadcast_slots(c, self.slots) for c in one.layers],
                    torch.zeros((self.slots,), dtype=torch.int32,
                                device=self.device))
        self._state = self.engine.serve_state(self.cfg, geometry, build)
        # the decode step's warm-up steps the state it runs on: bind (and
        # capture) it now, before take() zeroes the state
        inputs = {"token": np.zeros((self.slots, 1), np.int32)}
        if self.kv == "paged":
            inputs["block_table"] = self.alloc.table()
        self._decode.bind((self.params, self.cache), inputs)
        self._state.take(self)

    def _prefill(self, h: Handle, slot: int) -> np.ndarray:
        """Prefill ``h``'s prompt and scatter it into ``slot``; returns the
        last-token logits on the host."""
        plen = len(h.request.prompt)
        prompt = np.asarray(h.request.prompt, np.int32)
        if self.kv == "paged":
            bucket = self._bucket_for(plen)
            tokens = np.zeros((1, bucket), np.int32)
            tokens[0, :plen] = prompt
            inputs = {"tokens": tokens, "length": np.int32(plen)}
            max_new = 0
        else:
            bucket, inputs = None, {"tokens": prompt[None]}
            max_new = self._ring_shape[1]
        step = self._prefills.get(bucket)
        if step is None:
            step = self._prefills[bucket] = self.engine.prefill_step(
                self.cfg, max_new_tokens=max_new, bucket=bucket)
        with span("server.prefill", rid=h.rid, len=plen, bucket=bucket):
            self._check_state()
            logits, one = step((self.params,), inputs, self._next_seed(slot))
            if self._state is None:
                self._take_state(one)
            admit = {"slot": np.int32(slot)}
            if self.kv == "paged":
                admit["table_row"] = self.alloc.table_row(slot)
            self._admit_step((self.cache, one), admit)
            return logits[0].cpu().numpy()

    def _admit(self, h: Handle, slot: int):
        req = h.request
        logits_row = self._prefill(h, slot)
        h._rng = np.random.default_rng(req.seed)
        h.tokens = [self._sample(h, logits_row)]
        h._t_first = clock()
        self._m_ttft.observe(h._t_first - h._t_submit)
        h._next_pos = len(req.prompt)
        h.status, h.slot = "active", slot
        self.active[slot] = h
        if self._finished(h):
            self._retire(h)

    # --------------------------------------------------------------- decode
    def _sample(self, h: Handle, logits_row: np.ndarray) -> int:
        if h.request.temperature <= 0:
            return int(np.argmax(logits_row))
        z = logits_row.astype(np.float64) / h.request.temperature
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(h._rng.choice(len(p), p=p))

    def _finished(self, h: Handle) -> bool:
        if len(h.tokens) >= h.request.max_new_tokens:
            return True
        return h.request.eos_id is not None and \
            h.tokens[-1] == h.request.eos_id

    def _retire(self, h: Handle):
        h.status = "done"
        if len(h.tokens) > 1:  # TPOT covers decode tokens only
            self._m_tpot.observe(
                (clock() - h._t_first) / (len(h.tokens) - 1))
        if self.kv == "paged":
            self.alloc.release(h.slot)
        self.active[h.slot] = None

    def _step(self) -> List[Handle]:
        toks = np.zeros((self.slots, 1), np.int32)
        for i, h in enumerate(self.active):
            if h is not None:
                toks[i, 0] = h.tokens[-1]
                if self.kv == "paged":  # grow the table across a boundary
                    while self.alloc.blocks_for(h._next_pos + 1) > \
                            len(self.alloc.slot_blocks(i)):
                        self.alloc.append(i)
        return self._decode_tick(self._decode_logits(toks))

    def _decode_logits(self, toks: np.ndarray) -> np.ndarray:
        """One lockstep decode step; its logits on the host."""
        self._check_state()
        inputs = {"token": toks}
        if self.kv == "paged":
            inputs["block_table"] = self.alloc.table()
        t0 = clock()
        with span("server.decode", tick=self.decode_ticks):
            logits = self._decode((self.params, self.cache), inputs,
                                  self._next_seed())
            logits = logits.cpu().numpy()  # waits for the step: times are
            # device-complete
        dt = clock() - t0
        self.decode_s += dt
        self._m_step.observe(dt)
        self.engine.observe_step_time(dt, host=self.host)
        self.decode_ticks += 1
        return logits

    def _decode_tick(self, logits: np.ndarray) -> List[Handle]:
        finished = []
        n_active = 0
        for i, h in enumerate(self.active):
            if h is None:
                continue
            n_active += 1
            h.tokens.append(self._sample(h, logits[i]))
            h._next_pos += 1
            if self._finished(h):
                self._retire(h)
                finished.append(h)
        self._m_decode_tokens.inc(n_active)
        self._feed_gauges()
        return finished

    # -------------------------------------------------------------- faults
    def _recover(self):
        """Re-queue in-flight requests from scratch (streams replay
        deterministically: per-request rngs reset with the request seed)."""
        requeued = []
        for i, h in enumerate(self.active):
            if h is not None:
                h.tokens = []
                h.status, h.slot, h._rng = "queued", None, None
                requeued.append(h)
            self.active[i] = None
            if self.kv == "paged":
                self.alloc.release(i)
        self._state = None  # the next admission takes it back, zeroed
        self.queued = requeued + self.queued
        self.recoveries += 1
        self._m_recoveries.inc()
        self._feed_gauges()
        self.alloc.check()
