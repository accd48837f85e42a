"""Serving CLI — drives :class:`repro_torch.launch.server.Server` from the
shell (port of ``repro/launch/serve.py``).

    python -m repro_torch.launch.serve --arch imc-paper-110m --requests 6
    python -m repro_torch.launch.serve --arch imc-paper-110m --imc sim --flash
    python -m repro_torch.launch.serve --imc sim --imc-noise-sigma 0.05 --seed 7
    python -m repro_torch.launch.serve --arch qwen2.5-3b --reduce --device cpu

Runs on the card by default and exits with an error without one; pass
``--device cpu`` to serve on the CPU.  Weights are random, drawn from
``--seed``, which also seeds the fabric's noise.  The ``--imc*`` flags set
the fabric (``--imc sim`` is the paper's analog pipeline;
``--imc-noise-sigma`` / ``--imc-comparator-sigma`` add its device mismatch
and comparator offset) and ``--flash`` runs prefill attention through the
flash-attention kernel.
The server runs on an :class:`~repro_torch.launch.engine.Engine` with a
straggler monitor, as the reference's launcher builds it: on the card every
step is a CUDA graph, captured once per bucket and step kind and then
replayed (``--eager``: eager steps, for comparison).
Prints each request's first tokens, then TTFT, TPOT and decode
tokens/s from the server's telemetry, with the device they were taken on,
and the engine's captures and replays.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch.configs import get_config, list_configs, reduce_config
from repro_torch.core.fabric import add_fabric_cli, apply_fabric_cli
from repro_torch.device import resolve_device
from repro_torch.launch.engine import Engine
from repro_torch.launch.server import Request, Server
from repro_torch.models.model import init_params
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.telemetry import Registry, clock


def slo_summary(server: Server) -> dict:
    """TTFT / TPOT percentiles (ms) and decode tokens/s of a drained server."""
    snap = server.registry.snapshot()
    hist = snap["histograms"]

    def ms(name):
        h = hist.get(name, {})
        return {q: (h[q] * 1e3 if h.get(q) is not None else None)
                for q in ("p50", "p95", "max")} if h.get("count") else {}

    toks = snap["counters"].get("server.decode_tokens", 0)
    return {"ttft_ms": ms("server.ttft_s"), "tpot_ms": ms("server.tpot_s"),
            "decode_tokens": toks,
            "decode_tokens_per_s": (toks / server.decode_s
                                    if server.decode_s > 0 else None)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="imc-paper-110m", choices=list_configs())
    ap.add_argument("--reduce", action="store_true",
                    help="tiny same-family config (CPU smoke runs)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--kv", default="paged", choices=["paged", "ring"])
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights, the prompts and the "
                         "fabric noise (a noisy serve is reproducible in it)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--flash", action="store_true",
                    help="prefill attention through the flash-attention "
                         "kernel (use_flash_kernel)")
    ap.add_argument("--eager", action="store_true",
                    help="eager steps instead of CUDA graph replays")
    add_fabric_cli(ap)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduce_config(cfg)
    cfg = apply_fabric_cli(args, cfg)
    if args.flash:
        cfg = dataclasses.replace(cfg, use_flash_kernel=True)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, dev)
    bucket = max(16, args.prompt_len)
    reg = Registry()
    engine = Engine(dev, noise_seed=args.seed, monitor=StragglerMonitor(),
                    registry=reg, graphs=not args.eager)
    server = Server(cfg, params, engine=engine, slots=args.slots,
                    kv=args.kv, block_size=args.block_size,
                    buckets=(bucket,), max_seq_len=bucket + args.max_new)
    rng = np.random.default_rng(args.seed)
    t0 = clock()
    handles = [server.submit(Request(
        rng.integers(0, cfg.vocab_size, size=args.prompt_len).astype(np.int32),
        max_new_tokens=args.max_new)) for _ in range(args.requests)]
    server.drain()
    dt = clock() - t0
    for h in handles:
        print(f"req{h.rid}: {len(h.tokens)} tokens -> {h.tokens[:8]}...")
    ntok = sum(len(h.tokens) for h in handles)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    fabric = cfg.imc_fabric.label if cfg.imc_fabric else "off"
    print(f"throughput: {ntok / max(dt, 1e-9):.1f} tok/s ({args.kv}, "
          f"attn={server.attn_impl}, fabric={fabric}, "
          f"flash={cfg.use_flash_kernel}, device={kind})")
    st = engine.stats
    print(json.dumps({"device": kind, **slo_summary(server),
                      "graphs": engine.graphs, "captures": st.captures,
                      "replays": st.replays,
                      "swap_requests": engine.swap_requests}))


if __name__ == "__main__":
    main()
