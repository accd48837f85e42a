"""The port's autotuner (``repro_torch.kernels.autotune``) on the CPU.

Held against the reference (``repro.kernels.autotune``): the shape buckets,
the pin parser, the cache file both ways (the port reads the reference's
committed ``tuned.json``, the reference reads a file the port writes).  The
reference's own cases mirrored: a cold tune then a warm one costs zero
trials (through an injected measure: the CPU has no kernel to time), the
file round-trips, precedence DEFAULTS <- cache <- pin with a partial pin,
the geometry token, and the Engine building a new step after a store.  And
the port's own: with the defaults the plan twins are today's rules (copied
here as the oracle), every candidate's plan covers K within its bounds, bad
pins and geometries raise, the module imports neither ``jax`` nor
``repro``, and the committed ``tuned.json`` holds a measured ``cuda-sm90``
entry for every standard cell.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.kernels.autotune import tuner as ref_tuner
from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import autotune
from repro_torch.kernels.autotune import tuner
from repro_torch.kernels.bitplane_mac.ops import (bitplane_kernel,
                                                  bitplane_mma_plan,
                                                  bitplane_plan)
from repro_torch.kernels.imc_mac.ops import (imc_mac, imc_mac_dequant,
                                             imc_mac_dequant_torch,
                                             imc_mac_plan, imc_mac_torch)
from repro_torch.kernels.rbl_decode.ops import rbl_decode_mac_plan
from repro_torch.launch.engine import Engine
from repro_torch.launch.server import Request, Server
from repro_torch.models.model import init_params
from repro_torch.telemetry import Registry, get_registry

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
REF_TUNED = os.path.join(SRC, "repro", "kernels", "autotune", "tuned.json")
PORT_TUNED = os.path.join(SRC, "repro_torch", "kernels", "autotune",
                          "tuned.json")
SHAPES = {"m": 4, "k": 768, "n": 768}
BUCKET = autotune.shape_bucket(SHAPES)


@pytest.fixture(autouse=True)
def _own_cache(tmp_path, monkeypatch):
    """Each test on a cache file of its own, no pins, the process cache
    re-resolved from the environment afterwards."""
    for name in list(os.environ):
        if name.startswith("REPRO_TORCH_TUNE_"):
            monkeypatch.delenv(name)
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "t.json"))
    autotune.set_cache(None)
    yield
    autotune.set_cache(None)


def _trials():
    return get_registry().counter("autotune.trials").value


def plan(kernel, shapes, geometry=None):
    """``kernel``'s launch plan at ``shapes`` under ``geometry`` (merged over
    the defaults), from the Python twins of the C plans."""
    geom = {**autotune.DEFAULTS[kernel], **(geometry or {})}
    m, k, n = shapes["m"], shapes["k"], shapes["n"]
    if kernel.startswith("imc_mac"):
        return tuple(imc_mac_plan(m, n, k, geom))
    if kernel.startswith("bitplane"):
        granule = 8 if kernel == "bitplane_mac" else 1
        return tuple(bitplane_plan(m, n, k, shapes["rows"], geom["target"],
                                   granule))
    return tuple(rbl_decode_mac_plan(m, n, k, shapes["rows"], geom))


# ------------------------------------------------------ parity: reference
def test_shape_bucket_matches_reference():
    rng = np.random.default_rng(0)
    names = ["m", "k", "n", "ba", "bw", "rows", "b", "hd"]
    for _ in range(200):
        keys = rng.choice(names, size=rng.integers(1, 6), replace=False)
        shapes = {str(k): int(rng.integers(1, 40000)) for k in keys}
        assert autotune.shape_bucket(shapes) == ref_tuner.shape_bucket(shapes)


def _pin_text(rng) -> str:
    parts = []
    for _ in range(rng.integers(0, 5)):
        key = rng.choice(["tc_cluster", "sk_target", " target ", "bm", ""])
        kind = rng.integers(0, 5)
        val = (str(int(rng.integers(-5, 600))) if kind < 3 else
               rng.choice(["big", "", "4.5", "0x10"]))
        parts.append(f"{key}={val}" if kind != 4 else key)
    return rng.choice([",", ", ", " ,"]).join(parts)


def test_pin_parsing_matches_reference():
    rng = np.random.default_rng(1)
    raised = parsed = 0
    for _ in range(300):
        text = _pin_text(rng)
        try:
            want = ref_tuner._parse_pin(text)
        except ValueError:
            with pytest.raises(ValueError):
                tuner._parse_pin(text)
            raised += 1
            continue
        assert tuner._parse_pin(text) == want
        parsed += 1
    assert raised > 20 and parsed > 20  # both sides of the parser ran


def test_port_cache_reads_the_reference_file():
    port = autotune.AutotuneCache(path=REF_TUNED)
    ref = ref_tuner.AutotuneCache(path=REF_TUNED)
    assert port.entries and port.entries.keys() == ref.entries.keys()
    for key in ref.entries:
        assert port.lookup(*key.split("|")) == ref.lookup(*key.split("|"))


def test_reference_cache_reads_a_port_file(tmp_path):
    path = str(tmp_path / "port.json")
    port = autotune.AutotuneCache(path=path)
    port.measured_on = "NVIDIA H100 80GB HBM3, 700.00 W"
    for kernel, shapes in autotune.STANDARD_CELLS[:6]:
        geom = {**autotune.DEFAULTS[kernel],
                **autotune.candidates(kernel, shapes)[0]}
        port.store(kernel, autotune.shape_bucket(shapes),
                   autotune.KERNEL_DTYPES[kernel], "cuda-sm90", geom, 12.345,
                   9)
    ref = ref_tuner.AutotuneCache(path=path)
    assert ref.entries.keys() == port.entries.keys()
    for key in port.entries:
        assert ref.lookup(*key.split("|")) == port.lookup(*key.split("|"))
    assert json.loads(open(path).read())["measured_on"].startswith("NVIDIA")


# ------------------------------------------- the reference's cases, mirrored
def test_cold_tune_then_warm_is_trial_free(tmp_path):
    cache = autotune.AutotuneCache(path=str(tmp_path / "tuned.json"))
    space = autotune.candidates("imc_mac", SHAPES)
    times = {tuple(sorted(g.items())): 10.0 + i for i, g in enumerate(space)}
    measured = []

    def measure(geom):
        measured.append(geom)
        return times[tuple(sorted((k, geom[k]) for k in ("sk_gmax",
                                                         "sk_target")))]

    timings = []
    before = _trials()
    geom = autotune.tune("imc_mac", SHAPES, measure=measure, device="cpu",
                         cache=cache, timings=timings)
    assert _trials() - before == len(space) == len(measured) == 9
    assert geom == {**autotune.DEFAULTS["imc_mac"], **space[0]}
    assert [g for g, _ in timings] == measured
    rec = json.loads((tmp_path / "tuned.json").read_text())
    assert rec["format"] == 1
    (key, entry), = rec["entries"].items()
    assert key == f"imc_mac|{BUCKET}|int8|cpu"
    assert entry == {"geometry": geom, "us": 10.0, "trials": 9}
    # warm: the cell resolves from the cache with zero further trials
    before = _trials()
    assert autotune.tune("imc_mac", SHAPES, measure=measure, device="cpu",
                         cache=cache) == geom
    reloaded = autotune.AutotuneCache(path=str(tmp_path / "tuned.json"))
    assert autotune.tune("imc_mac", SHAPES, measure=measure, device="cpu",
                         cache=reloaded) == geom
    assert _trials() == before and len(measured) == 9


def test_tune_on_the_cpu_needs_a_measure():
    with pytest.raises(RuntimeError, match="CPU"):
        autotune.tune("imc_mac", SHAPES, device="cpu")
    with pytest.raises(RuntimeError, match="CPU"):
        autotune.tune_standard(device="cpu")


def test_file_round_trips(tmp_path):
    path = str(tmp_path / "rt.json")
    a = autotune.AutotuneCache(path=path)
    a.measured_on = "card, 1.00 W"
    a.store("rbl_decode_mac", "k1024_m4_n4096_rows8", "uint8", "cuda-sm90",
            {"cluster": 4, "target": 132}, 3.14159, 9)
    a.store("bitplane_mac", "x", "uint8", "cuda-sm90", {"target": 528}, 1.0,
            3)
    b = autotune.AutotuneCache(path=path)
    assert b.entries == a.entries and b.measured_on == a.measured_on
    assert b.entries["rbl_decode_mac|k1024_m4_n4096_rows8|uint8|cuda-sm90"][
        "us"] == 3.14
    b.save()
    assert json.loads(open(path).read()) == {
        "format": 1, "entries": a.entries, "measured_on": "card, 1.00 W"}


def test_lookup_defaults_cache_pin_precedence(tmp_path, monkeypatch):
    cache = autotune.AutotuneCache(path=str(tmp_path / "p.json"))
    # nothing known: the hand-sized plans of the sources
    assert autotune.lookup("imc_mac", SHAPES, device="cpu", cache=cache) == \
        {"sk_gmax": 4, "sk_target": 264, "tc_cluster": 8, "tc_target": 264}
    assert autotune.lookup("bitplane_mac_noisy", SHAPES, dtype="uint8",
                           device="cpu", cache=cache) == {"target": 480}
    # a cached winner beats the defaults, at its own backend only
    cache.store("imc_mac", BUCKET, "int8", "cpu",
                {**autotune.DEFAULTS["imc_mac"], "sk_gmax": 2,
                 "sk_target": 132}, 1.0, 9)
    got = autotune.lookup("imc_mac", {"m": 3, "k": 700, "n": 1000},
                          device="cpu", cache=cache)  # the same bucket
    assert got == {"sk_gmax": 2, "sk_target": 132, "tc_cluster": 8,
                   "tc_target": 264}
    assert autotune.lookup("imc_mac", SHAPES, device="cpu", dtype="uint8",
                           cache=cache) == autotune.DEFAULTS["imc_mac"]
    # a pin beats both, and a partial pin merges
    monkeypatch.setenv("REPRO_TORCH_TUNE_IMC_MAC", "sk_gmax=1, tc_cluster=4")
    assert autotune.lookup("imc_mac", SHAPES, device="cpu", cache=cache) == \
        {"sk_gmax": 1, "sk_target": 132, "tc_cluster": 4, "tc_target": 264}
    # another kernel's pin is not this one's
    monkeypatch.delenv("REPRO_TORCH_TUNE_IMC_MAC")
    monkeypatch.setenv("REPRO_TORCH_TUNE_IMC_MAC_DEQUANT", "sk_gmax=1")
    assert autotune.lookup("imc_mac", SHAPES, device="cpu",
                           cache=cache)["sk_gmax"] == 2
    # the reference's variable names are not read
    monkeypatch.setenv("REPRO_TUNE_IMC_MAC", "sk_gmax=1")
    assert autotune.lookup("imc_mac", SHAPES, device="cpu",
                           cache=cache)["sk_gmax"] == 2


@pytest.mark.parametrize("pin,match", [
    ("tc_cluster=big", "malformed REPRO_TORCH_TUNE_IMC_MAC"),
    ("bm=64", "REPRO_TORCH_TUNE_IMC_MAC.*no parameter 'bm'"),
    ("tc_cluster=16", "REPRO_TORCH_TUNE_IMC_MAC.*tc_cluster=16.*bounds"),
    ("tc_cluster=3", "REPRO_TORCH_TUNE_IMC_MAC.*power of two"),
    ("sk_gmax=5", "REPRO_TORCH_TUNE_IMC_MAC.*sk_gmax=5"),
    ("sk_target=0", "REPRO_TORCH_TUNE_IMC_MAC.*sk_target=0"),
])
def test_bad_pin_raises_naming_the_variable(monkeypatch, pin, match):
    monkeypatch.setenv("REPRO_TORCH_TUNE_IMC_MAC", pin)
    with pytest.raises(ValueError, match=match):
        autotune.env_pins()
    with pytest.raises(ValueError, match=match):
        autotune.lookup("imc_mac", SHAPES, device="cpu")
    with pytest.raises(ValueError, match=match):
        autotune.geometry_token()


def test_pin_of_an_unknown_kernel_raises(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_PAGED_ATTN", "bps=2")
    with pytest.raises(ValueError, match="REPRO_TORCH_TUNE_PAGED_ATTN.*"
                                         "not a tuned kernel"):
        autotune.env_pins()


def test_cache_entry_out_of_bounds_raises(tmp_path):
    cache = autotune.AutotuneCache(path=str(tmp_path / "bad.json"))
    cache.store("rbl_decode_mac", "k1024_m4_n1024_rows8", "uint8", "cpu",
                {"cluster": 16, "target": 264}, 1.0, 1)
    with pytest.raises(ValueError, match="cluster=16"):
        autotune.lookup("rbl_decode_mac", {"m": 4, "k": 768, "n": 768,
                                           "rows": 8},
                        dtype="uint8", device="cpu", cache=cache)


def test_geometry_token_tracks_stores_and_pins(monkeypatch):
    t0 = autotune.geometry_token()
    assert autotune.geometry_token() == t0  # stable while nothing changes
    autotune.get_cache().store("imc_mac", BUCKET, "int8", "cuda-sm90",
                               autotune.DEFAULTS["imc_mac"], 1.0, 1)
    t1 = autotune.geometry_token()
    assert t1 != t0 and autotune.geometry_token() == t1
    monkeypatch.setenv("REPRO_TORCH_TUNE_RBL_DECODE_MAC", "cluster=4")
    t2 = autotune.geometry_token()
    assert t2 != t1 and ("rbl_decode_mac", (("cluster", 4),)) in t2[1]


def test_lookup_memo_follows_stores_and_pins(monkeypatch):
    cache = autotune.get_cache()
    assert autotune.lookup("bitplane_mac", SHAPES, dtype="uint8",
                           device="cpu") == {"target": 264}
    cache.store("bitplane_mac", BUCKET, "uint8", "cpu", {"target": 132},
                1.0, 3)
    assert autotune.lookup("bitplane_mac", SHAPES, dtype="uint8",
                           device="cpu") == {"target": 132}
    monkeypatch.setenv("REPRO_TORCH_TUNE_BITPLANE_MAC", "target=528")
    assert autotune.lookup("bitplane_mac", SHAPES, dtype="uint8",
                           device="cpu") == {"target": 528}
    monkeypatch.delenv("REPRO_TORCH_TUNE_BITPLANE_MAC")
    got = autotune.lookup("bitplane_mac", SHAPES, dtype="uint8",
                          device="cpu")
    got["target"] = 1  # a caller's copy: the memo is not touched
    assert autotune.lookup("bitplane_mac", SHAPES, dtype="uint8",
                           device="cpu") == {"target": 132}


def _serve(cfg, params, eng, lengths, seed):
    server = Server(cfg, params, engine=eng, slots=2, kv="paged",
                    block_size=8, buckets=(16,), registry=Registry())
    rng = np.random.default_rng(seed)
    handles = [server.submit(Request(rng.integers(0, cfg.vocab_size, n)
                                     .astype(np.int32), max_new_tokens=4))
               for n in lengths]
    server.drain()
    return [h.tokens for h in handles]


def test_engine_builds_a_new_step_after_a_store_then_reuses_it():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = reduce_config(get_config("imc-paper-110m"))
        assert cfg.imc_fabric is not None and cfg.imc_fabric.mode == "exact"
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        eng = Engine("cpu", registry=Registry())
        streams = _serve(cfg, params, eng, (7, 12, 5), 0)
        d1 = eng.decode_step(cfg)
        warm = dataclasses.replace(eng.stats)
        assert warm.compiles == 3  # prefill (bucket 16), decode, admission
        assert _serve(cfg, params, eng, (7, 12, 5), 0) == streams
        assert (eng.stats.compiles, eng.stats.captures) == \
            (warm.compiles, warm.captures)
        # a store moves the token: the next steps are new ones, each bound
        # (on the card: captured) once, and serve the same streams
        autotune.get_cache().store(
            "imc_mac", BUCKET, "int8", "cuda-sm90",
            {**autotune.DEFAULTS["imc_mac"], "sk_gmax": 1}, 1.0, 9)
        assert _serve(cfg, params, eng, (7, 12, 5), 0) == streams
        d2 = eng.decode_step(cfg)
        assert d2 is not d1 and len(d2._bindings) == 1
        assert eng.stats.compiles == warm.compiles + 3
        assert eng.stats.captures == 2 * warm.captures
        # and nothing more across a further wave
        after = dataclasses.replace(eng.stats)
        assert _serve(cfg, params, eng, (9, 3), 1)
        assert eng.decode_step(cfg) is d2
        assert (eng.stats.compiles, eng.stats.captures) == \
            (after.compiles + 0, after.captures)
    finally:
        torch.set_num_threads(n)


# -------------------------------------------------------- the port's own
def old_imc_mac_plan(m, n, k):
    """``ops.imc_mac_plan`` before the tuner: its constants inlined."""
    if m > 16:
        gx, gz = -(-n // 32), -(-m // 64)
        steps = -(-k // 32)
        splits = 1
        while splits < 8 and gx * gz * splits * 2 <= 264 and \
                steps >= 2 * splits:
            splits *= 2
        return (0, gx, splits, gz, splits, 32 * -(-steps // splits))
    tiles = -(-n // 256)
    quads = -(-k // 4)
    g = min(max(-(-quads * tiles // (4 * 264)), 1), 4)
    kps = 16 * g
    splits = -(-k // kps) if k > 0 else 1
    return (4 if m <= 4 else 16, tiles, splits, 1, splits, kps)


def old_rbl_decode_mac_plan(m, n, k, rows):
    """``ops.rbl_decode_mac_plan`` before the tuner: its constants
    inlined."""
    groups = -(-k // rows) if k > 0 else 0
    rm = 4 if m <= 4 else 8
    wm = 1 if m <= 8 else 4
    gz = -(-m // (rm * wm))
    ln = 32
    while wm == 1 and ln > 8 and -(-n // (8 * ln)) * gz * 8 < 132:
        ln //= 2
    gx = -(-n // (8 * ln))
    splits = 1
    while splits < 8 and gx * gz * splits * 2 <= 264 and \
            groups >= 2 * splits:
        splits *= 2
    return (rm, wm, ln, gx, splits, gz, -(-groups // splits),
            (45056 - 16) // (rows * (4 * rm * wm + 8 * ln)))


MS = (1, 3, 4, 5, 9, 16, 17, 32, 33, 64, 65, 130, 512, 2048)
NS = (1, 31, 129, 768, 3072, 8192, 29568)
KS = (0, 3, 4, 100, 768, 1030, 3072, 29568)


def test_default_plans_are_todays_rules():
    for m in MS:
        for n in NS:
            for k in KS:
                assert tuple(imc_mac_plan(m, n, k)) == \
                    old_imc_mac_plan(m, n, k), (m, n, k)
                assert imc_mac_plan(m, n, k, autotune.DEFAULTS["imc_mac"]) \
                    == imc_mac_plan(m, n, k)
                for rows in (2, 8, 9, 32):
                    assert tuple(rbl_decode_mac_plan(m, n, k, rows)) == \
                        old_rbl_decode_mac_plan(m, n, k, rows), \
                        (m, n, k, rows)


@pytest.mark.parametrize("kernel", sorted(autotune.SPACES))
def test_every_candidate_covers_k_within_its_bounds(kernel):
    for m in MS:
        for n in NS[:6]:
            for k in KS:
                shapes = {"m": m, "k": k, "n": n, "rows": 8, "ba": 8,
                          "bw": 8}
                for cand in autotune.candidates(kernel, shapes):
                    geom = {**autotune.DEFAULTS[kernel], **cand}
                    p = plan(kernel, shapes, cand)
                    if kernel.startswith("imc_mac"):
                        assert p[4] * p[5] >= k and p[2] == p[4]
                        if m > 16:
                            assert p[4] <= geom["tc_cluster"] and \
                                p[4] & (p[4] - 1) == 0 and p[5] % 32 == 0
                            assert p[4] == 1 or \
                                p[1] * p[3] * p[4] <= geom["tc_target"]
                        else:
                            assert p[5] % 16 == 0 and \
                                p[5] <= 16 * geom["sk_gmax"]
                    elif kernel.startswith("bitplane"):
                        groups = -(-k // 8)
                        granule = 8 if kernel == "bitplane_mac" else 1
                        assert p[2] * p[3] >= groups and p[3] % granule == 0
                        assert p[2] == 1 or (p[2] - 1) * p[3] < groups
                    else:
                        groups = -(-k // 8)
                        assert p[4] * p[6] >= groups and p[4] <= \
                            geom["cluster"] and p[4] & (p[4] - 1) == 0


def test_bitplane_plan_twin_is_the_header_rule():
    """``bitplane_plan`` against the header's arithmetic written out with
    its C clamps, over a grid of shapes, targets and granules."""
    for m in MS:
        for n in NS:
            for k in KS:
                for target in (1, 132, 264, 480, 528, 792):
                    for granule in (1, 8):
                        groups = (k + 7) // 8
                        tiles = ((n + 31) // 32) * ((m + 7) // 8)
                        s = max((target + tiles - 1) // tiles, 1)
                        most = (groups + granule - 1) // granule
                        s = max(min(s, most), 1)
                        per = (groups + s - 1) // s
                        per = (per + granule - 1) // granule * granule
                        s = 1 if groups == 0 else (groups + per - 1) // per
                        assert tuple(bitplane_plan(m, n, k, 8, target,
                                                   granule)) == \
                            ((n + 31) // 32, (m + 7) // 8, s, per,
                             int(s > 1 or groups == 0))


def test_standard_cells_differ_by_candidate_and_left_out_ones_do_not():
    for kernel, shapes in autotune.STANDARD_CELLS:
        plans = {plan(kernel, shapes, c)
                 for c in autotune.candidates(kernel, shapes)}
        assert len(plans) > 1, (kernel, shapes)
        # the defaults are one of the candidates, so every cell times them
        assert any({**autotune.DEFAULTS[kernel], **c} ==
                   autotune.DEFAULTS[kernel]
                   for c in autotune.candidates(kernel, shapes))
    for kernel, shapes, why in autotune.LEFT_OUT:
        # the plan of the kernel the launcher takes there: bitplane_mac's
        # tensor-core kernel (M > 8) plans from the shapes alone
        tc = kernel == "bitplane_mac" and bitplane_kernel(
            shapes["m"], shapes["ba"], shapes["bw"], shapes["rows"]) == \
            "bitplane_mac_mma_kernel"
        plans = {tuple(bitplane_mma_plan(shapes["m"], shapes["n"],
                                         shapes["k"])) if tc
                 else plan(kernel, shapes, c)
                 for c in autotune.candidates(kernel, shapes)}
        assert len(plans) == 1 and why, (kernel, shapes)
    imc_m4 = [s for k, s in autotune.STANDARD_CELLS
              if k == "imc_mac" and s["m"] == 4]
    assert {"m": 4, "k": 29568, "n": 8192} in imc_m4
    # one cache entry each: no two cells share a bucket
    keys = [(k, autotune.shape_bucket(s)) for k, s in autotune.STANDARD_CELLS]
    assert len(set(keys)) == len(keys) == 14


def test_split_candidates_are_the_split_kernels_parameters():
    for kernel in ("imc_mac", "imc_mac_dequant"):
        assert all(set(c) == {"sk_gmax", "sk_target"} for c in
                   autotune.candidates(kernel, {"m": 16, "k": 8, "n": 8}))
        assert all(set(c) == {"tc_cluster", "tc_target"} for c in
                   autotune.candidates(kernel, {"m": 17, "k": 8, "n": 8}))
        assert len(autotune.SPACES[kernel]) == 18


def test_cpu_wrappers_ignore_geometry():
    rng = np.random.default_rng(2)
    qa = torch.from_numpy(rng.integers(-128, 128, (5, 40)).astype(np.int8))
    qw = torch.from_numpy(rng.integers(-128, 128, (40, 9)).astype(np.int8))
    sa = torch.tensor([0.01])
    sw = torch.from_numpy(rng.uniform(0.001, 0.01, 9).astype(np.float32))
    assert torch.equal(imc_mac(qa, qw, geometry={"sk_gmax": 1}),
                       imc_mac_torch(qa, qw))
    assert torch.equal(imc_mac_dequant(qa, qw, sa, sw,
                                       geometry={"tc_cluster": 2}),
                       imc_mac_dequant_torch(qa, qw, sa, sw))


def test_explicit_plan_geometry_is_checked():
    with pytest.raises(ValueError, match="tc_cluster=16"):
        imc_mac_plan(64, 768, 768, {"tc_cluster": 16})
    with pytest.raises(ValueError, match="no parameter 'target'"):
        imc_mac_plan(64, 768, 768, {"target": 264})
    with pytest.raises(ValueError, match="cluster=0"):
        rbl_decode_mac_plan(4, 768, 768, 8, {"cluster": 0})
    assert imc_mac_plan(64, 768, 768, {"tc_cluster": 4}).splits == 4
    assert imc_mac_plan(64, 768, 768).splits == 8


def test_backend_key_of_the_cpu():
    assert autotune.backend_key("cpu") == "cpu"
    assert autotune.backend_key(torch.zeros(1)) == "cpu"
    if not torch.cuda.is_available():
        assert autotune.backend_key() == "cpu"


def test_module_imports_neither_jax_nor_repro():
    code = ("import sys\n"
            "import repro_torch.kernels.autotune\n"
            "import repro_torch.kernels.imc_mac.ops\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {**os.environ, "PYTHONPATH": SRC}
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_committed_cache_covers_every_standard_cell_on_the_h100():
    with open(PORT_TUNED) as f:
        rec = json.load(f)
    assert rec["format"] == 1
    assert rec.get("measured_on"), "the card's name and power limit"
    cache = autotune.AutotuneCache(path=PORT_TUNED)
    for kernel, shapes in autotune.STANDARD_CELLS:
        key = cache.key(kernel, autotune.shape_bucket(shapes),
                        autotune.KERNEL_DTYPES[kernel], "cuda-sm90")
        entry = rec["entries"][key]
        assert entry["us"] > 0 and \
            entry["trials"] == len(autotune.candidates(kernel, shapes))
        assert any(entry["geometry"] == {**autotune.DEFAULTS[kernel], **c}
                   for c in autotune.candidates(kernel, shapes)), key
    for key, entry in rec["entries"].items():
        kernel = key.split("|")[0]
        autotune.check_geometry(kernel, entry["geometry"], key)
