"""The port's Engine (``repro_torch.launch.engine``) on the CPU.

The reference's Engine path does not run on the installed jax (ROADMAP queue
3), so the Engine-driven Server is held to today's eager serving instead:
:class:`EagerServer` below calls the model functions directly, with the host
seeds, int lengths and slots and the fresh caches the port's Server used
before the Engine, on the same admission schedule.  Those eager streams are
themselves held against the reference by ``tests/test_torch_server.py`` and
``tests/test_torch_model.py``.  On the CPU the Engine runs its static-buffer
protocol without graphs (copy-in, seed table, in-place state, copy-out), so
every comparison here is bit for bit.  Around that, mirroring
``tests/test_engine.py``: the step cache's identity and counters, zero new
compiles or captures after warm-up and through a fault drill, noisy seeds
through the seed table equal to the eager per-call seeds, the straggler
hook; and the two mask-free paged scatters against masked references, and
the noisy engines given a seed-table row against the integer seed.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.core.fabric import FabricSpec, NoiseSpec, fabric_matmul
from repro_torch.kernels.bitplane_mac.ops import bitplane_mac_noisy_torch
from repro_torch.kernels.common import (mix_seed, seed_int, seed_row,
                                        seed_table, seed_words)
from repro_torch.launch.engine import Engine
from repro_torch.launch.server import Request, Server
from repro_torch.models import attention as tatt
from repro_torch.models.kv_cache import (BlockAllocator, broadcast_slots,
                                         init_paged_cache,
                                         merge_prefill_cache)
from repro_torch.models.model import decode_step, init_params, prefill
from repro_torch.models.transformer import StackCache, dense_calls
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.telemetry import Registry

LENGTHS = (7, 16, 33, 12, 5)  # straddles the 16/48 buckets and block edges
MAX_NEW = 6
NOISE = NoiseSpec(mismatch_sigma=0.3)  # flips decodes at these widths
# noisy sim at 2x2 bits, as tests/test_engine.py serves it: 4 plane pairs
# where 8x8 bits draw 64, so the plain noisy engine stays quick
MODES = {"exact": (FabricSpec(), False),
         "sim_flash": (FabricSpec(mode="sim"), True),
         "noisy": (FabricSpec(bits_a=2, bits_w=2, mode="sim", noise=NOISE),
                   True)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Serving reduced models is many tiny ops: one intra-op thread per
    test worker keeps parallel workers from starving each other's spinning
    threads (the results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def base():
    out = {}
    for arch in ("qwen2.5-3b", "imc-paper-110m"):
        cfg = reduce_config(get_config(arch))
        out[arch] = (cfg, init_params(cfg, torch.Generator().manual_seed(0),
                                      "cpu"))
    return out


def _cfg(base, arch, mode):
    cfg, params = base[arch]
    spec, flash = MODES[mode]
    return dataclasses.replace(cfg, fabric=spec,
                               use_flash_kernel=flash), params


def _prompts(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in lengths]


class EagerServer(Server):
    """Today's eager serving: the Server's scheduling, its model calls made
    directly, as before the Engine (host seeds, an int length and slot, a
    fresh cache at the first admission and after a fault)."""

    _eager = None

    def _prefill(self, h, slot):
        plen = len(h.request.prompt)
        prompt = np.asarray(h.request.prompt, np.int32)
        if self.kv == "paged":
            padded = np.zeros((1, self._bucket_for(plen)), np.int32)
            padded[0, :plen] = prompt
            batch = {"tokens": torch.from_numpy(padded), "length": plen}
            max_new = 0
        else:
            batch = {"tokens": torch.from_numpy(prompt[None])}
            max_new = self._ring_shape[1]
        logits, one = prefill(self.params, batch, self.cfg,
                              max_new_tokens=max_new,
                              noise_seed=self._next_seed(slot))
        if self._eager is None:
            if self.kv == "paged":
                self._eager = init_paged_cache(one, self.slots,
                                               self.num_blocks,
                                               self.block_size)
            else:
                self._eager = StackCache(
                    [broadcast_slots(c, self.slots) for c in one.layers],
                    torch.zeros((self.slots,), dtype=torch.int32))
        merge_prefill_cache(self._eager, one,
                            torch.from_numpy(self.alloc.table_row(slot)), slot)
        return logits[0].numpy()

    def _decode_logits(self, toks):
        table = torch.from_numpy(self.alloc.table()) \
            if self.kv == "paged" else None
        logits, self._eager = decode_step(
            self.params, self._eager, torch.from_numpy(toks), self.cfg,
            block_table=table, noise_seed=self._next_seed())
        self.decode_ticks += 1
        return logits.numpy()

    def _recover(self):
        super()._recover()
        self._eager = None


def _serve(cls, cfg, params, prompts, kv, engine=None, **kw):
    geo = dict(slots=2, block_size=8, buckets=(16, 48),
               max_seq_len=48 + MAX_NEW) if kv == "paged" else dict(slots=2)
    server = cls(cfg, params, kv=kv, engine=engine, registry=Registry(),
                 device="cpu", noise_seed=None if engine else 5,
                 **geo, **kw)
    handles = [server.submit(Request(p, max_new_tokens=MAX_NEW))
               for p in prompts]
    server.drain()
    assert all(h.done and len(h.tokens) == MAX_NEW for h in handles)
    return server, [h.tokens for h in handles]


# ---------------------------------------------------------- step cache
def test_step_cache_returns_same_step(base):
    cfg, _ = base["qwen2.5-3b"]
    eng = Engine("cpu")
    d1 = eng.decode_step(cfg)
    assert eng.decode_step(cfg) is d1
    assert eng.stats.compiles == 1 and eng.stats.hits == 1
    # equal-but-distinct ModelConfig values hit the same entry
    cfg_copy = dataclasses.replace(cfg)
    assert cfg_copy is not cfg
    assert eng.decode_step(cfg_copy) is d1
    assert eng.stats.compiles == 1 and eng.stats.hits == 2
    # a different FabricSpec is a different step
    other = dataclasses.replace(cfg, fabric=FabricSpec(mode="exact"))
    assert eng.decode_step(other) is not d1
    assert eng.stats.compiles == 2
    # kinds, prefill extras and buckets are distinct entries, stable per key
    p1 = eng.prefill_step(cfg, max_new_tokens=4)
    assert eng.prefill_step(cfg, max_new_tokens=4) is p1
    assert eng.prefill_step(cfg, max_new_tokens=8) is not p1
    b16 = eng.prefill_step(cfg, 0, bucket=16)
    assert eng.prefill_step(cfg, 0, bucket=16) is b16
    assert eng.prefill_step(cfg, 0, bucket=32) is not b16
    assert eng.admit_step(cfg) is eng.admit_step(cfg)
    assert eng.stats.captures == 0 and eng.stats.replays == 0
    assert eng.registry.counter("engine.compiles").value >= eng.stats.compiles


def test_decode_step_is_bound_before_its_state_holds_anything(base):
    cfg, params = base["qwen2.5-3b"]
    eng = Engine("cpu", registry=Registry())
    server = Server(cfg, params, engine=eng, slots=2, kv="paged",
                    block_size=8, buckets=(16,), registry=Registry())
    server.submit(Request(_prompts(cfg, (7,))[0], max_new_tokens=3))
    server.poll()  # the first admission takes the state: decode is bound
    # prefill, decode (bound at take, before the zeroing) and admission
    assert eng.stats.captures == 3
    decode = eng.decode_step(cfg)
    inputs = {"token": np.zeros((2, 1), np.int32),
              "block_table": server.alloc.table()}
    b = decode.bind((params, server.cache), inputs)
    assert decode.bind((params, server.cache), inputs) is b
    assert eng.stats.captures == 3, "a bound argument set binds once"
    # a decode call on a state it was not bound to would warm up on live
    # state: it raises instead
    other = StackCache(list(server.cache.layers), server.cache.pos.clone())
    with pytest.raises(RuntimeError, match="bind it"):
        decode((params, other), inputs)
    server.drain()
    assert eng.stats.captures == 3


def test_noise_seed_and_unported_parts():
    eng = Engine("cpu", noise_seed=7)
    assert eng.noise_seed(3, 1) == mix_seed(7, 3, 1)
    assert eng.noise_seed(3, 1) != Engine("cpu", noise_seed=8).noise_seed(3, 1)
    assert not eng.graphs, "the CPU has no CUDA graphs"


# ------------------------------------------- engine vs today's eager serving
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "imc-paper-110m"])
@pytest.mark.parametrize("kv", ["paged", "ring"])
def test_engine_streams_equal_eager_serving(base, arch, mode, kv):
    cfg, params = _cfg(base, arch, mode)
    prompts = _prompts(cfg, LENGTHS if kv == "paged" else (16, 16, 16))
    eng = Engine("cpu", noise_seed=5, registry=Registry())
    server, streams = _serve(Server, cfg, params, prompts, kv, engine=eng)
    _, eager = _serve(EagerServer, cfg, params, prompts, kv)
    assert streams == eager
    # one prefill and one admission binding per bucket used, one decode
    buckets = {server._bucket_for(len(p)) for p in prompts} \
        if kv == "paged" else {None}
    assert eng.stats.captures == 2 * len(buckets) + 1
    assert eng.stats.compiles == len(buckets) + 2
    if kv == "paged":
        server.alloc.check()
        assert server.alloc.num_free == server.num_blocks


def test_noisy_streams_follow_the_seed(base):
    cfg, params = _cfg(base, "imc-paper-110m", "noisy")
    prompts = _prompts(cfg, LENGTHS[:3])

    def streams(seed):
        eng = Engine("cpu", noise_seed=seed, registry=Registry())
        return _serve(Server, cfg, params, prompts, "paged", engine=eng)[1]

    assert streams(5) == streams(5)
    assert streams(5) != streams(6)


# ----------------------------------------------- no recapture in steady state
def test_steady_state_no_new_compiles_or_captures(base):
    cfg, params = _cfg(base, "qwen2.5-3b", "exact")
    eng = Engine("cpu", registry=Registry())
    server = Server(cfg, params, engine=eng, slots=2, kv="ring",
                    device="cpu")
    server.submit(Request(_prompts(cfg, (16,))[0], max_new_tokens=MAX_NEW))
    server.drain()  # warm every step (prefill, admission, decode)
    warm = dataclasses.replace(eng.stats)
    for p in _prompts(cfg, (16,) * 4, seed=1):
        server.submit(Request(p, max_new_tokens=MAX_NEW))
    handles = server.drain()
    assert all(len(h.tokens) == MAX_NEW for h in handles)
    assert eng.stats.compiles == warm.compiles, "no new steps"
    assert eng.stats.captures == warm.captures, "no new bindings"
    assert eng.stats.replays > warm.replays
    # a second server on the same engine and geometry reuses everything
    again = Server(cfg, params, engine=eng, slots=2, kv="ring",
                   device="cpu")
    again.submit(Request(_prompts(cfg, (16,))[0], max_new_tokens=MAX_NEW))
    again.drain()
    assert eng.stats.compiles == warm.compiles
    assert eng.stats.captures == warm.captures
    assert again.cache is server.cache, "the engine's state, taken anew"
    with pytest.raises(RuntimeError, match="took this engine's"):
        server.submit(Request(_prompts(cfg, (16,))[0],
                              max_new_tokens=MAX_NEW))
        server.drain()


@pytest.mark.parametrize("mode", ["exact", "noisy"])
@pytest.mark.parametrize("kv", ["ring", "paged"])
def test_fault_drill_replays_identical_streams_without_capture(base, kv,
                                                               mode):
    cfg, params = _cfg(base, "imc-paper-110m", mode)
    prompts = _prompts(cfg, (7, 16, 33) if kv == "paged" else (16,) * 3)
    eng = Engine("cpu", noise_seed=5, registry=Registry())
    _, baseline = _serve(Server, cfg, params, prompts, kv, engine=eng)
    warm = dataclasses.replace(eng.stats)
    crashed, recovered = _serve(Server, cfg, params, prompts, kv, engine=eng,
                                fail_at=(1,))
    assert crashed.recoveries == 1
    assert eng.stats.compiles == warm.compiles
    assert eng.stats.captures == warm.captures, \
        "a recovery must reset the state in place, not capture anew"
    _, eager = _serve(EagerServer, cfg, params, prompts, kv, fail_at=(1,))
    assert recovered == eager
    if mode == "exact":  # greedy and noise-free: the drill changes nothing
        assert recovered == baseline, "streams changed across the fault"


# ------------------------------------------------------- noisy seed table
def test_seed_table_rows_are_the_per_call_seeds():
    for seed in (0, 7, 2**63 + 5, 2**64 - 1):
        table = seed_table(seed, 9)
        assert table.dtype == np.int32 and table.shape == (9, 2)
        for n in range(9):
            words = tuple(int(w) for w in table[n].view(np.uint32))
            assert words == seed_words(mix_seed(seed, n))
            assert seed_int(torch.from_numpy(table[n])) == mix_seed(seed, n)


def test_noisy_steps_draw_the_eager_per_call_seeds(base):
    cfg, params = _cfg(base, "qwen2.5-3b", "noisy")
    eng = Engine("cpu", noise_seed=3, registry=Registry())
    prompt = np.zeros((1, 16), np.int32)
    prompt[0, :11] = _prompts(cfg, (11,))[0]
    pf = eng.prefill_step(cfg, 0, bucket=16)
    assert pf.calls == dense_calls(cfg) == 7
    for step in (0, 1):
        s = eng.noise_seed(step)
        logits, one = pf((params,), {"tokens": prompt,
                                     "length": np.int32(11)}, s)
        ref, ref_one = prefill(params, {"tokens": torch.from_numpy(prompt),
                                        "length": 11}, cfg, noise_seed=s)
        assert torch.equal(logits, ref)
        for a, b in zip(one.layers, ref_one.layers):
            assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v)
    other = pf((params,), {"tokens": prompt, "length": np.int32(11)},
               eng.noise_seed(2))[0]
    assert not torch.equal(other, ref), "the seed is read, not baked in"
    with pytest.raises(ValueError, match="needs a seed"):
        pf((params,), {"tokens": prompt, "length": np.int32(11)})


def test_noisy_engines_take_a_seed_table_row():
    rng = np.random.default_rng(4)
    ua = torch.from_numpy(rng.integers(0, 256, (3, 40)))
    uw = torch.from_numpy(rng.integers(0, 256, (40, 9)))
    kw = dict(mismatch_sigma=0.3, comparator_offset_sigma=0.03)
    for seed in (11, 2**63 + 1):
        row = seed_row(seed)
        assert row.dtype == torch.int32 and row.shape == (2,)
        assert torch.equal(bitplane_mac_noisy_torch(ua, uw, row, **kw),
                           bitplane_mac_noisy_torch(ua, uw, seed, **kw))
    x = torch.from_numpy(rng.standard_normal((3, 40)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((40, 9)).astype(np.float32))
    spec = FabricSpec(mode="sim", noise=NOISE)
    assert torch.equal(fabric_matmul(x, w, spec, seed=seed_row(9)),
                       fabric_matmul(x, w, spec, seed=9))


# ---------------------------------------------------------- launch counters
def test_launch_table_names_every_counter_and_kernel():
    """``launches.KERNELS`` is the one list of counters (the Engine adds
    replays to them; ``chip_smoke.py`` reads them): every counter a wrapper
    ticks is in it, and every ``__global__`` function and plain version it
    names exists."""
    import pathlib
    import re

    from repro_torch.kernels import launches

    root = pathlib.Path(launches.__file__).parent
    ticked = set()
    for ops in root.glob("*/ops.py"):
        ticked |= set(re.findall(r"(\w+)\.(\w*launches) \+= 1",
                                 ops.read_text()))
    w = launches.wrappers()
    table = {(w[name].__name__, attr) for name, (_, _, attrs, _)
             in launches.KERNELS.items()
             for attr in ("launches",) + tuple(attrs)}
    # imc_mac's launcher, shared by its two entries, ticks wrapper.<counter>
    imc = {(n, a) for n, a in ticked if n == "wrapper"}
    assert imc and ticked - imc and ticked - imc <= table
    assert {a for _, a in imc} <= set(launches.KERNELS["imc_mac"][2]) | {
        "launches"}
    for fn, attr in launches.counters():
        assert isinstance(getattr(fn, attr), int)
    globals_ = set(re.findall(r"__global__ void(?: __launch_bounds__\([^)]*"
                              r"\))?\s+(\w+)\(",
                              "".join(p.read_text() for p in
                                      (root.parent / "csrc").glob("*.cu"))))
    named = {f for _, _, attrs, _ in launches.KERNELS.values()
             for fns in attrs.values() for f in fns}
    assert named == globals_
    for mod, plain in launches.plains().values():  # each plain version
        assert callable(getattr(mod, plain))
    assert set(launches.variants()) | set(launches.KERNELS) == \
        set(launches.read())


def test_device_counts_read_profiler_kernel_names():
    from repro_torch.kernels import launches

    traced = [
        ("void (anonymous namespace)::imc_mac_splitk_kernel<4, false>"
         "(signed char const*, signed char const*, int*)", 72),
        ("void (anonymous namespace)::imc_mac_mma_kernel<true>(signed char"
         " const*)", 2),
        ("void (anonymous namespace)::paged_split_kernel<__nv_bfloat16, "
         "__nv_bfloat16, 1>(__nv_bfloat16 const*)", 12),
        ("void (anonymous namespace)::bitplane_mac_r8_kernel<4>(unsigned "
         "char const*)", 3),
        ("void (anonymous namespace)::bitplane_mac_noisy_kernel<4>("
         "unsigned char const*)", 5),
        ("(anonymous namespace)::bitplane_mac_noisy_mma_kernel(unsigned char"
         " const*)", 7),
        ("void at::native::elementwise_kernel<128, 2, at::native::"
         "gpu_kernel_impl_nocast<float>>(int)", 40),
        ("Memcpy HtoD (Pinned -> Device)", 2)]
    got = launches.device_counts(traced)
    want = dict.fromkeys(launches.read(), 0)
    want.update(imc_mac=72, imc_mac_split=72, imc_mac_dequant=2,
                imc_mac_dequant_tiled=2, paged_attn=12, paged_attn_split=12,
                bitplane_mac=3, bitplane_mac_noisy=12,
                bitplane_mac_noisy_mma=7)
    assert got == want


# -------------------------------------------------------------- straggler
def test_straggler_hook_flags_slow_host():
    mon = StragglerMonitor()
    eng = Engine("cpu", monitor=mon, registry=Registry())
    for _ in range(mon.cfg.patience + 3):
        eng.observe_step_time(0.1, host=0)
        eng.observe_step_time(0.1, host=1)
        eng.observe_step_time(1.0, host=2)  # 10x the median
    assert eng.swap_requests == [2]
    fleet = Engine("cpu", monitor=StragglerMonitor(), registry=Registry())
    for _ in range(6):
        fleet.observe_step_times({0: 0.1, 1: 0.1, 2: 0.1, 3: 0.5})
    assert fleet.swap_requests == [3]


def test_server_feeds_the_monitor_under_its_host(base):
    cfg, params = _cfg(base, "imc-paper-110m", "exact")
    mon = StragglerMonitor()
    eng = Engine("cpu", monitor=mon, registry=Registry())
    server = Server(cfg, params, engine=eng, slots=2, kv="paged",
                    block_size=8, buckets=(16,), host=3, device="cpu")
    server.submit(Request(_prompts(cfg, (9,))[0], max_new_tokens=4))
    server.drain()
    assert list(mon.hosts) == [3]
    assert eng.registry.histogram("engine.observed_step_s").count == 3
    with pytest.raises(ValueError, match="differs from the engine"):
        Server(cfg, params, engine=eng, device="cpu", noise_seed=1)


def test_attn_impl_takes_the_ports_words(base):
    cfg, params = _cfg(base, "qwen2.5-3b", "exact")
    server = Server(cfg, params, attn_impl="torch", device="cpu")
    assert server.attn_impl == "torch" and server.cfg.attn_impl == "torch"
    with pytest.raises(ValueError, match="attn_impl"):
        Server(cfg, params, attn_impl="pallas", device="cpu")


# --------------------------------------------------- mask-free scatters
def _masked_rows(flat, dest, keep, rows):
    flat[dest[keep]] = rows[keep].to(flat.dtype)


@pytest.mark.parametrize("seed", range(6))
def test_scatter_rows_equals_masked_scatter(seed):
    rng = np.random.default_rng(seed)
    n_flat, n = 40, 12
    flat = torch.from_numpy(rng.standard_normal((n_flat, 3)).astype(
        np.float32)).to(torch.bfloat16)
    dest = torch.from_numpy(rng.permutation(n_flat)[:n])
    keep = torch.from_numpy(rng.random(n) < [0.0, 0.5, 1.0][seed % 3])
    dest = torch.where(keep, dest, torch.from_numpy(
        rng.integers(-50, 100, n)))  # dropped rows point anywhere
    rows = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32))
    want = flat.clone()
    _masked_rows(want, dest, keep, rows)
    got = flat.clone()
    tatt.scatter_rows(got, dest, keep, rows)
    assert torch.equal(got, want)


def _masked_scatter_ring(pool, ring, table_row):
    nb, bs = pool.k.shape[0], pool.k.shape[1]
    kp = ring.key_pos[0].to(torch.int64)
    tbl = table_row.to(torch.int64)
    blk = tbl[torch.clamp(kp, 0, None).div(bs, rounding_mode="floor")
              .clamp_max(tbl.shape[0] - 1)]
    keep = (kp >= 0) & (blk >= 0)
    for p_arr, r_arr in zip(pool, ring[:2] + ring[3:]):
        if p_arr is not None:
            flat = p_arr.view((nb * bs,) + tuple(p_arr.shape[2:]))
            _masked_rows(flat, blk * bs + kp % bs, keep, r_arr[0])


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("seed", range(4))
def test_mask_free_admission_scatter_equals_masked(kv_dtype, seed):
    """Padded prompt tails (key_pos -1) and unallocated blocks (-1 table
    entries) are dropped; the pools are bit-identical to a masked scatter."""
    rng = np.random.default_rng(seed)
    d, H, KV, hd, bs, nb, mb, slots = 32, 4, 2, 8, 4, 12, 6, 3
    p = tatt.init_attention(torch.Generator().manual_seed(seed), d, H, KV, hd)
    kw = dict(n_heads=H, n_kv_heads=KV, head_dim=hd, rope_theta=1e4)
    alloc = BlockAllocator(nb, bs, slots, max_blocks_per_slot=mb)
    batch = want = None
    for slot, (bucket, plen) in enumerate(((16, 9), (16, 16), (24, 5))):
        x = torch.from_numpy(rng.standard_normal((1, bucket, d)).astype(
            np.float32)).to(torch.bfloat16)
        _, ring = tatt.attn_prefill(p, x, cache_len=bucket, true_len=plen,
                                    kv_dtype=kv_dtype, **kw)
        one = StackCache([ring], torch.tensor(plen, dtype=torch.int32))
        # fewer blocks than the bucket covers: the rest of the row is -1
        alloc.alloc(slot, alloc.blocks_for(plen) - (slot == 1))
        row = torch.from_numpy(alloc.table_row(slot))
        if batch is None:
            batch = init_paged_cache(one, slots, nb, bs)
            for t in batch.layers[0]:
                if t is not None:  # stale data the drop must not touch
                    t.copy_(torch.from_numpy(rng.integers(
                        -9, 9, t.shape)).to(t.dtype))
            want = StackCache([tatt.PagedAttnCache(*[
                None if t is None else t.clone() for t in batch.layers[0]])],
                batch.pos.clone())
        merge_prefill_cache(batch, one, row, torch.tensor([slot]))
        _masked_scatter_ring(want.layers[0], ring, row)
        want.pos[slot] = plen
    for a, b in zip(batch.layers[0], want.layers[0]):
        if a is not None:
            assert torch.equal(a, b)
    assert torch.equal(batch.pos, want.pos)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("seed", range(4))
def test_mask_free_decode_scatter_equals_masked(kv_dtype, seed):
    """Inactive slots (an all -1 table row) and positions past a slot's
    blocks drop their new K/V; the pools are bit-identical to a masked
    scatter of the same projections."""
    rng = np.random.default_rng(10 + seed)
    d, H, KV, hd, bs, nb, mb, B = 32, 4, 2, 8, 4, 10, 3, 4
    p = tatt.init_attention(torch.Generator().manual_seed(seed), d, H, KV, hd)
    kw = dict(n_heads=H, n_kv_heads=KV, head_dim=hd, rope_theta=1e4)

    def pools():
        r = np.random.default_rng(seed)
        f = [torch.from_numpy(r.standard_normal((nb, bs, KV, hd)).astype(
            np.float32)).to(torch.bfloat16) for _ in range(2)]
        if kv_dtype == "bf16":
            return tatt.PagedAttnCache(*f)
        (kq, ks), (vq, vs) = tatt._kv_quant(f[0]), tatt._kv_quant(f[1])
        return tatt.PagedAttnCache(kq, vq, ks, vs)

    perm = rng.permutation(nb)
    tbl = np.full((B, mb), -1, np.int32)
    pos = np.array([3, 9, 0, 5], np.int32)
    tbl[0, :1] = perm[:1]
    tbl[1, :3] = perm[1:4]
    tbl[3, :1] = perm[4:5]  # pos 5 lies past its one block: dropped
    if seed % 2:
        tbl[:] = -1  # every slot inactive: nothing is written
    x = torch.from_numpy(rng.standard_normal((B, 1, d)).astype(
        np.float32)).to(torch.bfloat16)
    cache = pools()
    tatt.attn_decode(p, x, cache, torch.from_numpy(pos),
                     block_table=torch.from_numpy(tbl), **kw)
    # the masked reference: the same new K/V, written only where kept
    q, k_new, v_new = tatt._project_qkv(p, x, H, KV, hd, torch.from_numpy(
        pos).to(torch.int64)[:, None], 1e4)
    want = pools()
    t64 = torch.from_numpy(tbl).to(torch.int64)
    t64 = torch.where(t64 < 0, nb, t64)
    p64 = torch.from_numpy(pos).to(torch.int64)
    widx = t64[torch.arange(B), torch.clamp(p64 // bs, 0, mb - 1)] * bs \
        + p64 % bs
    keep = widx < nb * bs
    news = [k_new[:, 0], v_new[:, 0]]
    if kv_dtype == "int8":
        (kq, ks), (vq, vs) = tatt._kv_quant(k_new), tatt._kv_quant(v_new)
        news = [kq[:, 0], vq[:, 0], ks[:, 0], vs[:, 0]]
    for arr, new in zip([a for a in want if a is not None], news):
        _masked_rows(arr.view((nb * bs,) + tuple(arr.shape[2:])), widx,
                     keep, new)
    for a, b in zip(cache, want):
        if a is not None:
            assert torch.equal(a, b)
