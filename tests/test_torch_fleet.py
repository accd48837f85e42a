"""The port's fleet (``repro_torch.fleet``) on the CPU.

The reference's own fleet serve and train tests skip below two JAX devices,
run the reference's Engine path (which fails on the installed jax) and are
flaky under their forced-device subprocess, so they cannot be the oracle
here.  The pure parts are held to the reference directly: device
partitioning and the tagged-snapshot merge.  The fleet paths are held to the
port's own single-host ``Server`` and ``train`` (themselves held to the
reference by ``tests/test_torch_engine.py``, ``test_torch_server.py`` and
``test_torch_train.py``), as the reference's fleet tests hold its fleet:
each virtual host over ``["cpu", "cpu"]`` serves the token streams of one
Server fed its requests (and, with the fabric off, the fleet serves those
of one Server fed every request), and a straggler drill ends bit for bit
where one host's run of the same steps ends.  A two-process gloo group runs the ``DistributedCoordinator``.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.fleet import merge_tagged as jmerge_tagged
from repro.fleet import tagged_snapshot as jtagged_snapshot
from repro.launch.mesh import partition_devices as jpartition_devices
from repro.telemetry import Registry as JRegistry
from repro_torch import fleet as tfleet
from repro_torch.configs import get_config, reduce_config
from repro_torch.core.fabric import FabricSpec
from repro_torch.fleet import (DistributedCoordinator, FleetEngine,
                               FleetServer, LocalCoordinator, fleet_slos,
                               merge_registries, merge_tagged,
                               tagged_snapshot)
from repro_torch.launch.engine import Engine
from repro_torch.launch.mesh import partition_devices
from repro_torch.launch.server import Request, Server
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import train, train_fleet
from repro_torch.models.model import init_params
from repro_torch.runtime.elastic import plan_for_fleet, shrink_after_failure
from repro_torch.runtime.straggler import StragglerConfig
from repro_torch.telemetry import Registry, get_registry
from repro_torch.tree import tree_leaves

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
LENGTHS = (7, 16, 33, 12, 5)  # the ragged schedule of the paged-KV tests
MAX_NEW = 6
CPU2 = ["cpu", "cpu"]
FLEET_SLOW_FROM = 3  # the drill's straggler: host 1 from this step on


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many tiny ops: one intra-op thread per test worker keeps parallel
    workers from starving each other (the results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def served():
    cfg = reduce_config(get_config("imc-paper-110m"))
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def test_fleet_exports_the_reference_names():
    from repro import fleet as jfleet

    assert tfleet.__all__ == jfleet.__all__
    for name in tfleet.__all__:
        assert hasattr(tfleet, name)


# ------------------------------------------------------------- coordinator
@pytest.mark.parametrize("n_hosts", [1, 2, 4, 8, 0, 3, 5, -1])
def test_partition_devices_matches_the_reference(n_hosts):
    fake = [f"d{i}" for i in range(8)]
    try:
        want = jpartition_devices(n_hosts, devices=fake)
    except ValueError:
        with pytest.raises(ValueError, match="equal virtual hosts"):
            partition_devices(n_hosts, devices=fake)
        return
    assert partition_devices(n_hosts, devices=fake) == want
    assert len(want) == n_hosts and sum(want, ()) == tuple(fake)


def test_local_coordinator_over_named_devices():
    coord = LocalCoordinator(2, devices=["cpu"] * 4)
    hosts = coord.hosts()
    assert [h.index for h in hosts] == [0, 1]
    for h in hosts:
        assert h.n_devices == 2 and h.device == torch.device("cpu")
        assert h.devices == (torch.device("cpu"),) * 2
    assert coord.is_controller() and coord.controller == 0
    assert coord.process_count == 1 and coord.model_parallel == 2
    coord.barrier("test")  # no-op, must not raise
    assert coord.all_gather({0: "x"}) == {0: "x"}
    assert coord.drop_host(1).index == 1 and len(coord.hosts()) == 1
    with pytest.raises(KeyError):
        coord.drop_host(1)
    with pytest.raises(ValueError, match="equal virtual hosts"):
        LocalCoordinator(3, devices=CPU2)


def test_fleet_devices_never_fall_back_to_the_cpu():
    """No card: a fleet over every visible card, or over named cards,
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalCoordinator(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalCoordinator(2, devices=["cuda:0", "cuda:0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedCoordinator()


def test_distributed_coordinator_without_a_group_is_one_process():
    coord = DistributedCoordinator(device="cpu")
    assert coord.process_count == 1 and coord.is_controller()
    assert [(h.index, h.device) for h in coord.hosts()] == \
        [(0, torch.device("cpu"))]
    coord.barrier("test")
    assert coord.all_gather({0: {"a": 1}}) == {0: {"a": 1}}
    coord.close()  # created no group: nothing to destroy


# -------------------------------------------------------- telemetry merge
def _samples(seed, n=200):
    return np.random.default_rng(seed).uniform(5e-4, 2.0, size=n)


@pytest.mark.parametrize("n_hosts", [2, 3])
def test_merged_fleet_percentiles_match_single_registry(n_hosts):
    """Percentiles off the merged per-host registries equal one registry fed
    the same samples — exact, not averaged — and equal the reference's
    ``merge_tagged`` of the same samples."""
    samples = _samples(3)
    per_host = {h: Registry() for h in range(n_hosts)}
    jper_host = {h: JRegistry() for h in range(n_hosts)}
    ref = Registry()
    for i, v in enumerate(samples):
        for reg in (per_host[i % n_hosts], jper_host[i % n_hosts], ref):
            reg.histogram("server.tpot_s").observe(float(v))
            reg.counter("server.admitted").inc()
    merged, by_host = merge_tagged(
        [tagged_snapshot(reg, h) for h, reg in per_host.items()])
    assert sorted(by_host) == list(range(n_hosts))
    m = merged.snapshot()["histograms"]["server.tpot_s"]
    r = ref.snapshot()["histograms"]["server.tpot_s"]
    for q in ("p50", "p95", "p99"):
        assert m[q] == r[q], f"{q}: fleet {m[q]} != as-if-one {r[q]}"
    assert merged.snapshot()["counters"]["server.admitted"] == len(samples)
    jmerged, _ = jmerge_tagged(
        [jtagged_snapshot(reg, h) for h, reg in reversed(jper_host.items())])
    assert merged.snapshot() == jmerged.snapshot()
    assert merge_registries(per_host).snapshot() == merged.snapshot()
    slos = fleet_slos(per_host, attn_impl="cuda")
    assert slos["n_hosts"] == n_hosts and slos["attn_impl"] == "cuda"
    assert slos["tpot_ms"] == round(r["p50"] * 1e3, 3)


# ----------------------------------------------- fleet serving vs oracle
def _serve(cfg, params, waves, kw):
    """One single-host Server fed ``waves`` (lists of prompts), drained
    after each; its handles, wave by wave."""
    srv = Server(cfg, params, engine=Engine("cpu", noise_seed=0,
                                            registry=Registry()), **kw)
    out = []
    for prompts in waves:
        out.append([srv.submit(Request(p, max_new_tokens=MAX_NEW))
                    for p in prompts])
        srv.drain()
    return out


@pytest.mark.parametrize("fabric", ["off", "exact", "sim_flash"])
def test_fleet_serve_is_bit_identical_to_single_host(served, fabric):
    """Mixed-length decode through a 2-host virtual fleet: each host's token
    streams equal those of one Server fed that host's requests, wave by
    wave, and steady-state waves build and bind nothing on any host.

    Under a fabric, a decode step quantizes its activations per tensor, so
    a request's stream depends on the requests it shares a decode batch
    with, and routing changes the batches; with the fabric off the slots
    are independent, and the fleet's streams also equal one Server's fed
    every request (the reference's own oracle)."""
    cfg, params = served
    cfg = dataclasses.replace(cfg, **{
        "off": dict(fabric=None, imc_mode="off"),
        "exact": dict(fabric=FabricSpec()),
        "sim_flash": dict(fabric=FabricSpec(mode="sim"),
                          use_flash_kernel=True)}[fabric])
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in LENGTHS]
    kw = dict(slots=3, kv="paged", block_size=8, buckets=(16, 48),
              max_seq_len=48 + MAX_NEW)

    fleet = FleetEngine(LocalCoordinator(2, devices=CPU2), noise_seed=0)
    fsrv = FleetServer(cfg, params, fleet, **kw)
    waves = []
    for wave in range(3):
        waves.append([fsrv.submit(Request(p, max_new_tokens=MAX_NEW))
                      for p in prompts])
        fsrv.drain()
        if wave == 1:
            # an odd wave size over 2 hosts alternates which host gets which
            # bucket, so warm-up takes 2 waves; wave 3 builds nothing
            warm = fleet.traces_by_host()
    assert {h.host for h in waves[0]} == {0, 1}, \
        "round-robin must actually use both hosts"
    assert fleet.traces_by_host() == warm, \
        f"steady-state rebuild: {warm} -> {fleet.traces_by_host()}"
    assert all(h.done and len(h.tokens) == MAX_NEW for w in waves for h in w)

    for host in (0, 1):
        mine = [[h for h in w if h.host == host] for w in waves]
        oracle = _serve(cfg, params, [[h.request.prompt for h in w]
                                      for w in mine], kw)
        for w, ow in zip(mine, oracle):
            for fh, oh in zip(w, ow):
                assert fh.tokens == oh.tokens, \
                    f"host {host} req{fh.rid}: {fh.tokens} != {oh.tokens}"
    if fabric == "off":
        (one,) = _serve(cfg, params, [prompts], kw)
        for w in waves:
            assert [h.tokens for h in w] == [h.tokens for h in one]

    slos = fsrv.slos()
    assert slos["n_hosts"] == 2 and slos["attn_impl"] == fsrv.attn_impl
    assert slos["ttft_ms"] > 0 and slos["tpot_ms"] > 0
    merged = fleet.merged_registry().snapshot()
    assert merged["counters"]["server.admitted"] == 3 * len(prompts)
    assert merged["histograms"]["server.ttft_s"]["count"] == 3 * len(prompts)
    assert fsrv.total_decode_s() > 0
    # per-host decode times reach the fleet monitor
    assert set(fleet.monitor.hosts) == {0, 1}


# --------------------------------------- straggler -> shrink -> resume
@pytest.mark.parametrize("devices", [CPU2, ["cpu"] * 4])
def test_fleet_straggler_shrinks_plan_and_resumes_from_checkpoint(tmp_path,
                                                                  devices):
    """An injected slow host is flagged from per-host times, the plan
    shrinks in whole-host units with per-replica batch preserved, the loop
    resumes from the latest checkpoint with nothing new built on the
    survivor, and the run ends bit for bit where one host's ``train`` of
    the same steps ends."""
    tcfg = reduce_config(get_config("imc-paper-110m"))
    kw = dict(steps=8, global_batch=4, seq_len=32, seed=0)
    resumes0 = get_registry().snapshot()["counters"].get("fault.resumes", 0)
    state, hist, fleet, loop = train_fleet(
        tcfg, n_hosts=2, ckpt_root=str(tmp_path), ckpt_every=2,
        devices=devices,
        # host 1 turns into a straggler from step 3 on (observed-time skew
        # only: no real sleeping)
        delay=lambda h, s: 5.0 if (h == 1 and s >= FLEET_SLOW_FROM) else 0.0,
        **kw)

    # flagged from per-host entries -> removed from fleet AND monitor
    assert fleet.removed == [1] and fleet.active_hosts() == [0]
    assert 1 not in fleet.monitor.hosts
    assert get_registry().gauge("straggler.ewma_s.host1").value == 0.0

    # the shrink re-planned in whole-host device units, per-replica batch
    # preserved
    assert len(loop.shrinks) == 1
    shrunk, per_host = loop.shrinks[0], fleet.host(0).n_devices
    assert per_host == len(devices) // 2
    assert shrunk is loop.plan and shrunk.n_devices == per_host
    mp = 2 if per_host % 2 == 0 else 1
    orig = plan_for_fleet(2, per_host, model_parallel=mp, base_batch=4)
    assert shrunk == shrink_after_failure(orig, per_host, model_parallel=mp)
    assert orig.global_batch // (orig.n_devices // mp) == \
        shrunk.global_batch // (shrunk.n_devices // mp), \
        "per-replica batch must survive the shrink"

    # resumed from the latest committed checkpoint, replaying some steps
    resumes = get_registry().snapshot()["counters"]["fault.resumes"]
    assert resumes == resumes0 + 1
    assert len(hist) > 8, "resume must replay post-checkpoint steps"
    # the survivor replays from its step cache: one train step built, none
    # by the resume
    assert fleet.traces_by_host()[0] == 1

    whole, whole_hist = train(tcfg, device="cpu", **kw)
    # the resume replays steps up to the last: steps 6 and 7 close both runs
    assert [m["loss"] for m in hist[-2:]] == \
        [m["loss"] for m in whole_hist[-2:]]
    counts = {h: fleet.engine(h).registry.snapshot()["histograms"][
        "fleet.step_s"]["count"] for h in (0, 1)}
    assert counts[0] == len(hist) and FLEET_SLOW_FROM < counts[1] < 8
    assert int(state[1].step) == 8
    for a, b in zip(tree_leaves(state), tree_leaves(whole)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_fleet_engine_observe_step_times_feeds_monitor_once():
    """record_step must see the FULL per-host dict once per step — per-host
    calls would multiply the strike cadence by the fleet size."""
    fleet = FleetEngine(LocalCoordinator(2, devices=CPU2),
                        straggler_cfg=StragglerConfig(patience=3))
    for _ in range(3):
        flagged = fleet.observe_step_times({0: 0.1, 1: 0.9})
    assert flagged == [1]
    assert fleet.monitor.hosts[1].strikes == 3, \
        "strikes must advance once per fleet step, not once per host"
    assert [fleet.engine(h).device for h in (0, 1)] == [torch.device("cpu")] * 2
    snaps = fleet.snapshots()
    assert [s["process_index"] for s in snaps.values()] == [0, 1]


# ----------------------------------------------- two-process gloo group
WORKER = r"""
import json, sys
from repro_torch.fleet import DistributedCoordinator, merge_registries
from repro_torch.telemetry import Registry

rank, url, inp, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
coord = DistributedCoordinator(initialize=True, coordinator_address=url,
                               num_processes=2, process_id=rank,
                               device="cpu")
try:
    reg = Registry()
    for v in json.load(open(inp))[str(rank)]:
        reg.histogram("server.tpot_s").observe(v)
        reg.counter("server.admitted").inc()
    reg.gauge(f"straggler.ewma_s.host{rank}").set(0.5 + rank)
    merged = merge_registries({rank: reg}, coord)
    coord.barrier("done")
    with open(out, "w") as f:
        json.dump({"count": coord.process_count,
                   "hosts": [h.index for h in coord.hosts()],
                   "controller": coord.is_controller(),
                   "merged": merged.snapshot()}, f)
finally:
    coord.close()
"""


def test_distributed_coordinator_two_process_gloo(tmp_path):
    """Two processes in one gloo group (``file://`` rendezvous): each
    gathers the tagged snapshots and merges them into the view a local
    merge of the same two registries gives."""
    samples = {str(r): [float(v) for v in _samples(r, 50 + 10 * r)]
               for r in range(2)}
    inp = tmp_path / "samples.json"
    inp.write_text(json.dumps(samples))
    url = f"file://{tmp_path / 'rendezvous'}"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (SRC, os.environ.get("PYTHONPATH")) if p),
        OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), url, str(inp),
         str(tmp_path / f"out{r}.json")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=60)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs

    local = {}
    for r in range(2):
        reg = local[r] = Registry()
        for v in samples[str(r)]:
            reg.histogram("server.tpot_s").observe(v)
            reg.counter("server.admitted").inc()
        reg.gauge(f"straggler.ewma_s.host{r}").set(0.5 + r)
    want = merge_registries(local).snapshot()
    for r in range(2):
        got = json.loads((tmp_path / f"out{r}.json").read_text())
        assert got["count"] == 2 and got["hosts"] == [r]
        assert got["controller"] == (r == 0)
        assert got["merged"] == json.loads(json.dumps(want))
    assert want["counters"]["server.admitted"] == 110


# ------------------------------------------------------------------- CLIs
@pytest.mark.parametrize("fleet", [False, True])
def test_serve_batched_cli(capsys, tmp_path, fleet):
    from repro_torch import serve_batched

    trace = tmp_path / "trace.json"
    argv = ["--arch", "imc-paper-110m", "--lengths", "7,16,33", "--max-new",
            "4", "--telemetry", "--trace-out", str(trace)]
    if fleet:  # the default --waves (3) checks the third wave
        argv += ["--fleet-hosts", "2", "--fleet-devices", "cpu,cpu"]
    else:
        argv += ["--device", "cpu"]
    serve_batched.main(argv)
    out = capsys.readouterr().out
    assert out.rstrip().endswith("serve_batched OK (fleet)" if fleet
                                 else "serve_batched OK")
    assert "| server.admitted |" in out
    assert f"(n_hosts={2 if fleet else 1}): ttft p50" in out
    assert f"waves {3 if fleet else 2}+ capture-free" in out
    assert json.loads(trace.read_text())["traceEvents"]


@pytest.mark.parametrize("hosts,waves", [(1, 1), (2, 2)])
def test_serve_batched_cli_needs_a_wave_after_warm_up(capsys, hosts, waves):
    """The first ``--fleet-hosts`` waves warm up: a run with no wave after
    them would check nothing, so the CLI refuses it."""
    from repro_torch import serve_batched

    with pytest.raises(SystemExit):
        serve_batched.main(["--arch", "imc-paper-110m", "--fleet-hosts",
                            str(hosts), "--fleet-devices",
                            ",".join(["cpu"] * hosts), "--waves",
                            str(waves)])
    assert "steady-state check needs" in capsys.readouterr().err


def test_train_fleet_cli(capsys, tmp_path):
    train_main(["--arch", "imc-paper-110m", "--reduce", "--fleet-hosts",
                "2", "--fleet-devices", "cpu,cpu", "--steps", "3",
                "--batch", "2", "--seq", "16", "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert "fleet: 2 hosts" in out and "final loss" in out
