"""The port's Server (``repro_torch.launch.server``) on the CPU.

The reference's Engine/Server path does not run on the installed jax (see
ROADMAP queue 3), so the port's Server is held against its own ring-mode
oracle, as the reference's ``tests/test_paged_kv.py`` holds the paged path
against sequential ring decode: mixed-length paged serving must give the
same greedy streams, bit for bit, as serving each request alone through
``kv="ring"``.  Around that: admission control, block budgeting, per-request
termination, fault re-queue, telemetry and the device rule.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.launch import serve
from repro_torch.launch.server import Request, Server
from repro_torch.models.model import init_params
from repro_torch.telemetry import Registry

LENGTHS = (7, 16, 33, 12, 5)  # straddles the 16/48 buckets and block edges
MAX_NEW = 6


@pytest.fixture(scope="module")
def cfg():
    return reduce_config(get_config("qwen2.5-3b"))


@pytest.fixture(scope="module")
def params(cfg):
    return init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _prompts(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in lengths]


def _server(cfg, params, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("block_size", 8)
    kw.setdefault("buckets", (16, 48))
    kw.setdefault("max_seq_len", 48 + MAX_NEW)
    kw.setdefault("registry", Registry())
    return Server(cfg, params, device="cpu", **kw)


def _ring_alone(cfg, params, prompt, max_new=MAX_NEW):
    """One request served alone by a one-slot ring server (the oracle)."""
    server = Server(cfg, params, slots=1, kv="ring", registry=Registry(),
                    device="cpu")
    h = server.submit(Request(prompt, max_new_tokens=max_new))
    server.drain()
    return h.tokens


def test_paged_mix_bit_identical_to_ring(cfg, params):
    prompts = _prompts(cfg, LENGTHS)
    server = _server(cfg, params)
    handles = [server.submit(Request(p, max_new_tokens=MAX_NEW))
               for p in prompts]
    server.drain()
    assert all(h.done for h in handles)
    for h in handles:
        assert h.tokens == _ring_alone(cfg, params, h.request.prompt), (
            f"len-{len(h.request.prompt)} stream diverged from ring mode")
    server.alloc.check()
    assert server.alloc.num_free == server.num_blocks, \
        "finished requests must return every block"


def test_submit_rejects_impossible_requests(cfg, params):
    server = _server(cfg, params)
    too_long = server.submit(Request(_prompts(cfg, [49])[0],
                                     max_new_tokens=1))
    assert too_long.status == "rejected" and "bucket" in too_long.reason
    too_greedy = server.submit(Request(_prompts(cfg, [48])[0],
                                       max_new_tokens=100))
    assert too_greedy.status == "rejected" and "never fit" in too_greedy.reason
    assert not server.queued, "rejected requests must not queue"


def test_block_exhaustion_queues_then_admits_on_release(cfg, params):
    prompts = _prompts(cfg, (16, 16, 16))
    # pool sized for ONE worst-case request (16+6 tokens -> 3 blocks)
    server = _server(cfg, params, num_blocks=3, buckets=(16,),
                     max_seq_len=16 + MAX_NEW)
    handles = [server.submit(Request(p, max_new_tokens=MAX_NEW))
               for p in prompts]
    server.poll()
    assert sum(h.status == "active" for h in handles) == 1
    assert sum(h.status == "queued" for h in handles) == 2
    server.drain()
    assert [h.tokens for h in handles] == \
        [_ring_alone(cfg, params, p) for p in prompts]
    server.alloc.check()


def test_per_request_termination_and_early_release(cfg, params):
    base = _prompts(cfg, (16,))[0]
    ref = _ring_alone(cfg, params, base, max_new=8)
    eos = ref[2]
    stop = ref.index(eos) + 1  # first occurrence wins
    server = _server(cfg, params)
    short = server.submit(Request(base, max_new_tokens=3))
    eosed = server.submit(Request(base, max_new_tokens=8, eos_id=eos))
    server.drain()
    assert short.tokens == ref[:3]
    assert eosed.tokens == ref[:stop], "stream must stop AT the eos token"
    assert server.alloc.num_free == server.num_blocks


def test_fault_requeue_replays_identical_streams(cfg, params):
    prompts = _prompts(cfg, (7, 16, 33))
    baseline = _server(cfg, params)
    crashed = _server(cfg, params, fail_at=(1,))
    for s in (baseline, crashed):
        for p in prompts:
            s.submit(Request(p, max_new_tokens=MAX_NEW))
        s.drain()
    assert crashed.recoveries == 1
    for b, c in zip(baseline.handles, crashed.handles):
        assert b.tokens == c.tokens
    crashed.alloc.check()


def test_ring_mode_rejects_ragged_traffic(cfg, params):
    server = Server(cfg, params, slots=2, kv="ring", registry=Registry(),
                    device="cpu")
    handles = [server.submit(Request(p, max_new_tokens=MAX_NEW))
               for p in _prompts(cfg, (16, 16))]
    ragged = server.submit(Request(_prompts(cfg, [7])[0],
                                   max_new_tokens=MAX_NEW))
    server.drain()
    assert ragged.status == "rejected" and "uniform" in ragged.reason
    for h in handles:
        assert h.tokens == _ring_alone(cfg, params, h.request.prompt)


def test_sampling_is_seeded_and_telemetry_counts(cfg, params):
    reg = Registry()
    server = _server(cfg, params, registry=reg)
    p = _prompts(cfg, (12,))[0]
    a = server.submit(Request(p, max_new_tokens=5, seed=3, temperature=1.0))
    b = server.submit(Request(p, max_new_tokens=5, seed=3, temperature=1.0))
    server.drain()
    assert a.tokens == b.tokens and len(a.tokens) == 5
    snap = reg.snapshot()
    assert snap["counters"]["server.admitted"] == 2
    assert snap["counters"]["server.decode_tokens"] == 8  # 2 x (5 - 1)
    assert snap["histograms"]["server.ttft_s"]["count"] == 2
    assert snap["histograms"]["server.tpot_s"]["count"] == 2
    assert snap["gauges"]["server.block_occupancy"]["hwm"] > 0


def test_entry_points_need_the_card_unless_cpu_is_asked(cfg, params):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Server(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--reduce"])


def test_unported_paths_raise_up_front(cfg, params):
    import dataclasses

    from repro_torch.core.fabric import FabricSpec, NoiseSpec

    sim = dataclasses.replace(cfg, fabric=FabricSpec(mode="sim"))
    with pytest.raises(NotImplementedError, match="not ported"):
        Server(sim, params, device="cpu")
    noisy = dataclasses.replace(cfg, fabric=FabricSpec(
        mode="sim", noise=NoiseSpec.calibrated()))
    with pytest.raises(NotImplementedError, match="not ported"):
        Server(noisy, params, device="cpu")
    moe = dataclasses.replace(cfg, pattern=("moe",))
    with pytest.raises(NotImplementedError, match="not ported"):
        Server(moe, params, device="cpu")


def test_serve_cli_on_cpu(capsys):
    serve.main(["--arch", "imc-paper-110m", "--reduce", "--device", "cpu",
                "--requests", "2", "--max-new", "3", "--prompt-len", "8"])
    out = capsys.readouterr().out
    assert "req1: 3 tokens" in out and '"device": "cpu"' in out
