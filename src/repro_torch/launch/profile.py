"""Where a decode step's time goes on the card: a torch.profiler window over
the port's Server.

    python -m repro_torch.launch.profile --arch imc-paper-110m --steps 8

Admits ``--slots`` requests of mixed prompt lengths (random weights and
prompts from ``--seed``), runs a few warm-up ticks, then profiles ``--steps``
lockstep decode ticks with CPU and CUDA activity.  Prints one JSON object:
the step's wall time (host clock; each tick ends in a device-to-host copy of
the logits, so it is device-complete), the device's busy time per step (the
sum of CUDA kernel and memcpy times the profiler saw), the idle share, the
kernel launches per step, the busiest device ops and the most frequent CUDA
runtime calls per step.  ``--trace-out`` also writes the Chrome trace.
Runs on the card only.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config, list_configs
from repro_torch.device import resolve_device
from repro_torch.launch.server import Request, Server
from repro_torch.models.model import init_params
from repro_torch.telemetry import Registry, clock

PROMPTS = (33, 40, 16, 12)


def _self_device_us(e) -> float:
    t = getattr(e, "self_device_time_total", None)
    return float(t if t is not None else e.self_cuda_time_total)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="imc-paper-110m", choices=list_configs())
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-out", default=None)
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    cfg = get_config(args.arch)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), dev)
    server = Server(cfg, params, slots=args.slots, kv="paged",
                    block_size=16, buckets=(16, 32, 64), registry=Registry(),
                    device=dev)
    rng = np.random.default_rng(args.seed)
    budget = args.warmup + args.steps + 2
    for i in range(args.slots):
        n = PROMPTS[i % len(PROMPTS)]
        server.submit(Request(rng.integers(0, cfg.vocab_size, n).astype(
            np.int32), max_new_tokens=budget))
    for _ in range(args.warmup):
        server.poll()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = clock()
        for _ in range(args.steps):
            server.poll()
        torch.cuda.synchronize()
        wall = clock() - t0
    if args.trace_out:
        prof.export_chrome_trace(args.trace_out)

    steps = args.steps
    ka = prof.key_averages()
    on_dev = [e for e in ka if e.device_type == DeviceType.CUDA]
    busy_us = sum(_self_device_us(e) for e in on_dev)
    kernels = sum(e.count for e in on_dev)
    top_dev = sorted(on_dev, key=_self_device_us, reverse=True)[:12]
    runtime = sorted((e for e in ka if e.device_type == DeviceType.CPU
                      and e.key.startswith("cuda")),
                     key=lambda e: e.count, reverse=True)[:8]
    step_ms = wall / steps * 1e3
    busy_ms = busy_us / steps / 1e3
    out = {
        "device": torch.cuda.get_device_name(dev),
        "arch": cfg.name, "slots": args.slots, "steps": steps,
        "step_ms": step_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": (max(0.0, 1.0 - busy_ms / step_ms)
                              if busy_ms > 0 else None),
        "device_ops_per_step": kernels / steps,
        "top_device_ops": [
            {"name": e.key[:80], "ms_per_step": _self_device_us(e) / steps
             / 1e3, "per_step": e.count / steps} for e in top_dev],
        "top_runtime_calls": [
            {"name": e.key, "per_step": e.count / steps,
             "cpu_ms_per_step": e.self_cpu_time_total / steps / 1e3}
            for e in runtime],
    }
    if busy_ms == 0:
        out["note"] = "the profiler saw no device time: not measured"
    print(json.dumps(out))


if __name__ == "__main__":
    main()
