"""The port's telemetry export (``repro_torch.telemetry.export``) against the
reference's (``repro.telemetry.export``): the same observations fed to a
registry of each package give equal snapshot dicts, equal markdown text and
equal serving SLOs; ``write_json`` round-trips, byte for byte the
reference's file; ``merge_into_bench`` attaches the snapshot.  Pure Python
on both sides: every comparison is exact.
"""
import json

import numpy as np
import pytest

from repro import telemetry as jtel
from repro_torch import telemetry as ttel


def _feed(regs, seed, server=True):
    """The same observations into every registry of ``regs``: the Server's
    SLO metrics (when ``server``) and a spread of others, one empty
    histogram among them."""
    rng = np.random.default_rng(seed)
    for reg in regs:
        reg.histogram("engine.empty_s")
    for v in rng.uniform(5e-4, 2.0, size=int(rng.integers(5, 60))):
        for reg in regs:
            reg.histogram("engine.step_s.decode").observe(float(v))
            reg.counter("engine.replays").inc()
    for v in rng.uniform(0.0, 1.0, size=7):
        for reg in regs:
            reg.gauge("server.queue_depth").set(float(v))
    if not server:
        return
    for ttft, tpot in rng.uniform(1e-3, 0.5, size=(int(rng.integers(2, 20)),
                                                   2)):
        for reg in regs:
            reg.histogram("server.ttft_s").observe(float(ttft))
            reg.histogram("server.tpot_s").observe(float(tpot))
            reg.counter("server.admitted").inc()
            reg.counter("server.decode_tokens").inc(3)
    for v in (0.25, 0.75, 0.5, 0.0):
        for reg in regs:
            reg.gauge("server.block_occupancy").set(v)


def _pair(seed, server=True):
    j, t = jtel.Registry(), ttel.Registry()
    _feed((j, t), seed, server)
    return j, t


def test_exports_are_public():
    for name in ("snapshot", "write_json", "to_markdown", "serving_slos",
                 "merge_into_bench"):
        assert name in ttel.__all__ and callable(getattr(ttel, name))


@pytest.mark.parametrize("server", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snapshot_and_markdown_equal_the_reference(seed, server):
    j, t = _pair(seed, server)
    snap = ttel.snapshot(t)
    assert snap == jtel.snapshot(j)
    assert json.dumps(snap) == json.dumps(jtel.snapshot(j))
    md = ttel.to_markdown(registry=t)
    assert md == jtel.to_markdown(registry=j)
    assert ttel.to_markdown(snap) == md  # from a snapshot as from its registry
    assert "| engine.empty_s | 0 | — | — | — | — |" in md


def test_snapshot_and_markdown_of_the_global_registry():
    """``registry=None`` reads the process-global registry, as the
    reference's does."""
    assert ttel.snapshot() == ttel.get_registry().snapshot()
    assert ttel.to_markdown() == ttel.to_markdown(
        registry=ttel.get_registry())
    empty = {"counters": {}, "gauges": {}, "histograms": {}}
    assert ttel.to_markdown(empty) == jtel.to_markdown(empty) == ""
    assert ttel.to_markdown(ttel.Registry().snapshot()) == ""


@pytest.mark.parametrize("attn_impl", [None, "cuda", "ring"])
@pytest.mark.parametrize("n_hosts", [None, 1, 2])
@pytest.mark.parametrize("seed", [0, 3])
def test_serving_slos_equal_the_reference(seed, n_hosts, attn_impl):
    j, t = _pair(seed)
    got = ttel.serving_slos(t, attn_impl=attn_impl, n_hosts=n_hosts)
    assert got == jtel.serving_slos(j, attn_impl=attn_impl, n_hosts=n_hosts)
    assert got["ttft_ms"] > 0 and got["tpot_ms"] > 0
    assert got["occupancy_peak"] == 0.75
    assert ("attn_impl" in got) == (attn_impl is not None)
    assert got.get("n_hosts") == n_hosts


def test_serving_slos_are_none_without_a_server():
    j, t = _pair(4, server=False)
    got = ttel.serving_slos(t)
    assert got == jtel.serving_slos(j) == {
        "ttft_ms": None, "tpot_ms": None, "occupancy_peak": None}


@pytest.mark.parametrize("seed", [0, 5])
def test_write_json_round_trips(tmp_path, seed):
    j, t = _pair(seed)
    path = str(tmp_path / "port.json")
    assert ttel.write_json(path, t) == path
    with open(path) as f:
        assert json.load(f) == ttel.snapshot(t)
    ref = str(tmp_path / "ref.json")
    jtel.write_json(ref, j)
    with open(path, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


def test_merge_into_bench_attaches_the_snapshot():
    j, t = _pair(6)
    rec = {"tokens_per_s": 10.0}
    out = ttel.merge_into_bench(rec, t)
    assert out is rec and rec["tokens_per_s"] == 10.0
    assert rec["telemetry"] == ttel.snapshot(t)
    assert rec == jtel.merge_into_bench({"tokens_per_s": 10.0}, j)
