"""Batched serving on the typed Server API (submit / poll / drain), waves of
ragged requests (port of ``examples/serve_batched.py``).

Ragged prompts are right-padded to per-bucket prefill steps, KV lives in a
paged block pool with per-slot block tables, and decode runs all slots in
lockstep through ONE step — on the card each step is a CUDA graph, captured
once and replayed.  Runs a reduced config of ``--arch`` (default
qwen2.5-3b), so it finishes in seconds.

Every run serves through a :class:`repro_torch.fleet.FleetServer`: one
host on ``--device`` by default, or ``--fleet-hosts N`` hosts over
``--fleet-devices`` (default every visible card), with round-robin routing,
one Engine per host and SLOs off the merged registry.  It serves
``--waves`` waves of mixed-length requests (default N + 1) and checks that
every wave after the first N builds no step and captures no graph on any
host (``Engine.stats.compiles`` and ``captures``): round-robin rotates which
host sees which bucket, so warm-up takes N waves, and the step cache plus
block-table-as-data design means steady-state traffic never recaptures.

    python -m repro_torch.serve_batched                  # on the card
    python -m repro_torch.serve_batched --device cpu --lengths 7,16,33
    python -m repro_torch.serve_batched --fleet-hosts 2 \\
        --fleet-devices cuda:0,cuda:0                    # two hosts, one card
    python -m repro_torch.serve_batched --fleet-hosts 2 --fleet-devices cpu,cpu

``--imc sim --imc-noise-sigma 0.05`` serves a noisy fabric, ``--kv ring``
the fixed-ring geometry (uniform lengths only).  ``--trace-out trace.json``
exports the run's prefill/decode spans as Chrome trace-event JSON (load it
in https://ui.perfetto.dev); ``--telemetry`` prints the metric snapshot as
markdown.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_configs, reduce_config
from repro_torch.core.fabric import add_fabric_cli, apply_fabric_cli
from repro_torch.fleet import FleetEngine, FleetServer, LocalCoordinator
from repro_torch.launch.server import Request
from repro_torch.models.model import init_params
from repro_torch.telemetry import export_chrome_trace, to_markdown


def _wave(server, cfg, rng, lengths, max_new):
    """Submit one request per length, drain; returns the wave's tokens."""
    handles = [server.submit(Request(
        prompt=rng.integers(0, cfg.vocab_size, size=n).astype(np.int32),
        max_new_tokens=max_new)) for n in lengths]
    server.drain()
    if not all(h.done and len(h.tokens) == max_new for h in handles):
        raise RuntimeError(f"unfinished requests: "
                           f"{[(h.status, h.reason) for h in handles]}")
    return sum(len(h.tokens) for h in handles)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b", choices=list_configs())
    ap.add_argument("--lengths", default="7,16,33",
                    help="comma-separated ragged prompt lengths; one request "
                         "per length per wave")
    ap.add_argument("--waves", type=int, default=None,
                    help="request waves (default: --fleet-hosts + 1); the "
                         "first --fleet-hosts waves warm up, every later "
                         "one must build and capture nothing")
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=10)
    ap.add_argument("--kv", default="paged", choices=["paged", "ring"])
    ap.add_argument("--attn-impl", default=None,
                    choices=["auto", "torch", "cuda"],
                    help="paged-decode attention (default: the config's, "
                         "auto: the kernel on the card, plain on the CPU)")
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the fabric noise")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (single host)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write prefill/decode spans as Chrome trace-event "
                         "JSON (loadable in Perfetto / chrome://tracing)")
    ap.add_argument("--telemetry", action="store_true",
                    help="print the telemetry snapshot as markdown tables")
    ap.add_argument("--fleet-hosts", type=int, default=1,
                    help="virtual fleet: split --fleet-devices into N hosts "
                         "(the device count must divide by N), route "
                         "requests round-robin, report merged-registry SLOs")
    ap.add_argument("--fleet-devices", default=None,
                    help="comma-separated devices of the fleet (default: "
                         "every visible card); cuda:0,cuda:0 is two hosts "
                         "on one card, cpu,cpu two on the CPU")
    add_fabric_cli(ap)
    args = ap.parse_args(argv)

    cfg = apply_fabric_cli(args, reduce_config(get_config(args.arch)))
    lengths = [int(x) for x in args.lengths.split(",")]
    if args.kv == "ring":  # the ring geometry serves ONE uniform shape
        lengths = [lengths[0]] * len(lengths)
    buckets = sorted({-(-n // 16) * 16 for n in lengths})
    rng = np.random.default_rng(0)
    # round-robin rotates which host sees which bucket: warm-up takes
    # n_hosts waves, and the check needs a wave after them
    n_hosts = args.fleet_hosts
    waves = n_hosts + 1 if args.waves is None else args.waves
    if waves <= n_hosts:
        ap.error(f"--waves {waves}: the first {n_hosts} waves warm up, so "
                 f"the steady-state check needs at least {n_hosts + 1}")
    if args.fleet_devices:
        devices = args.fleet_devices.split(",")
    elif n_hosts == 1:
        devices = [args.device]  # None: the card
    else:
        devices = None  # every visible card

    fleet = FleetEngine(LocalCoordinator(n_hosts, devices=devices),
                        noise_seed=args.seed)
    dev = fleet.host(fleet.controller).device
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    server = FleetServer(cfg, params, fleet, slots=args.slots, kv=args.kv,
                         block_size=args.block_size, buckets=buckets,
                         attn_impl=args.attn_impl,
                         max_seq_len=max(buckets) + args.max_new)
    warm = None
    total_tokens, t0 = 0, time.perf_counter()
    for wave in range(waves):
        total_tokens += _wave(server, cfg, rng, lengths, args.max_new)
        if wave == n_hosts - 1:
            warm = fleet.traces_by_host()
        elif wave >= n_hosts and fleet.traces_by_host() != warm:
            raise RuntimeError(
                f"steady-state recapture: builds + captures by host went "
                f"{warm} -> {fleet.traces_by_host()} on wave {wave}")
    dt = time.perf_counter() - t0

    for h in server.handles:
        print(f"req{h.rid}@host{h.host} (len={len(h.request.prompt)}): "
              f"generated {h.tokens}")
    hosts = ", ".join(str(fleet.host(h).device) for h in server.servers)
    print(f"{len(server.handles)} requests ({waves} waves, lengths "
          f"{lengths}) over {n_hosts} host(s) ({hosts}) through "
          f"{args.slots} slots each [{args.kv}, attn={server.attn_impl}]; "
          f"{total_tokens / dt:.1f} tok/s end-to-end; builds + captures "
          f"{fleet.total_traces()} (per host {fleet.traces_by_host()}), "
          f"waves {n_hosts + 1}+ capture-free")
    slos = server.slos()
    print(f"SLOs off the merged registry (n_hosts={slos['n_hosts']}): ttft "
          f"p50 {slos['ttft_ms']} ms, tpot p50 {slos['tpot_ms']} ms, peak "
          f"block occupancy {slos['occupancy_peak']}")
    if args.telemetry:
        print(to_markdown(registry=fleet.merged_registry()))
    if args.trace_out:
        print(f"chrome trace -> {export_chrome_trace(args.trace_out)} "
              f"(open in https://ui.perfetto.dev)")
    print("serve_batched OK (fleet)" if n_hosts > 1 else "serve_batched OK")

if __name__ == "__main__":
    main()
