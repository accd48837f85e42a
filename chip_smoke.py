#!/usr/bin/env python3
"""Quickest proof that the PyTorch/H100 port starts and is right on the card.

    python3 chip_smoke.py          # from the root of a checkout, one card

Drives the port (``src/repro_torch``) only; imports nothing of JAX or of the
JAX package.  Phases, in order; any failure exits nonzero and prints no
result:

1. Build every kernel of the serving path from ``src/repro_torch/csrc`` with
   nvcc for sm_90a, one nvcc per source, all started together.
2. ``imc_mac`` against its plain version on the card, bit for bit: the
   demonstrator's shapes M in {4, 16, 64} x (K, N) in {(768, 768),
   (768, 3072), (3072, 768)}, a ragged shape, and the deep-K int32 case.
3. ``paged_attn`` against its plain version on the card: f32, bf16 and int8
   pools, window 0 and 16, rep 1 (the demonstrator) and rep 8 (qwen2.5-3b),
   sentinel blocks and an inactive slot; bounds f32 5e-6, bf16 1.6e-2 (one
   output ulp), int8 1e-2.
4. ``Server`` on full-width ``imc-paper-110m`` (random weights from a fixed
   seed): exact fabric, 4 slots, paged KV, block 16, buckets (16, 32, 64),
   six requests of 7/16/33/12/5/40 prompt tokens and 16 new tokens each.
   Both kernels' launch counters are zeroed just before and read just
   after; each must be above 0.  The first request's prefill logits on the
   card are held against the same weights run through the plain path on the
   CPU (bound: 2e-2 of the largest |logit|).
5. Each kernel timed at the main path's decode shapes (CUDA events), beside
   its bound on an H100 SXM (3.35 TB/s, 1979 TOP/s int8, 989 TFLOP/s bf16),
   its plain version and one library call computing the same function.

It prints the ``kernels`` JSON line, the card's name and power limit as
nvidia-smi gives them, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
ATTN_ATOL = {"f32": 5e-6, "bf16": 1.6e-2, "int8": 1e-2}
LOGIT_RTOL = 2e-2
PROMPTS = (7, 16, 33, 12, 5, 40)
MAX_NEW = 16


def log(*a):
    print(*a, flush=True)


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, ops: float, peak_ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phases
def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    text = build.build_all(["imc_mac", "paged_attn"])
    build.load("imc_mac")
    build.load("paged_attn")
    dt = time.perf_counter() - t0
    log(text)
    log(f"[1] kernels built and loaded in {dt:.2f} s")
    return dt


def phase_imc_mac(torch, dev):
    from repro_torch.kernels.imc_mac.ops import imc_mac, imc_mac_torch

    g = torch.Generator(device=dev).manual_seed(1)
    cases = [(m, k, n) for m in (4, 16, 64)
             for k, n in ((768, 768), (768, 3072), (3072, 768))]
    cases.append((33, 1030, 129))  # ragged in M, K and N
    for m, k, n in cases:
        qa = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                           dtype=torch.int8)
        qw = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                           dtype=torch.int8)
        out = imc_mac(qa, qw)
        torch.cuda.synchronize()
        if not torch.equal(out, imc_mac_torch(qa, qw)):
            raise AssertionError(f"imc_mac differs from its plain version "
                                 f"at {(m, k, n)}")
    qa = torch.full((8, 2048), 127, dtype=torch.int8, device=dev)
    qw = torch.full((2048, 8), -127, dtype=torch.int8, device=dev)
    if not bool((imc_mac(qa, qw) == -127 * 127 * 2048).all()):
        raise AssertionError("imc_mac int32 accumulation case failed")
    log(f"[2] imc_mac bit-exact on {len(cases) + 1} shapes")
    return 0.0


def _ragged_table(rng, pos, mb, nb, bs):
    import numpy as np

    tbl = np.full((len(pos), mb), -1, np.int32)
    perm = iter(rng.permutation(nb))
    for i, p in enumerate(pos):
        for j in range(p // bs + 1):
            tbl[i, j] = next(perm)
    return tbl


def attn_inputs(torch, dev, dtype, B, H, KV, hd, pos, bs=16, mb=8, seed=0,
                inactive_last=False):
    import numpy as np

    from repro_torch.models.attention import _kv_quant

    rng = np.random.default_rng(seed)
    nb = B * mb
    qdt = torch.float32 if dtype == "f32" else torch.bfloat16
    pdt = torch.float32 if dtype in ("f32", "int8") else torch.bfloat16
    q = torch.tensor(rng.standard_normal((B, 1, H, hd)), dtype=qdt, device=dev)
    k = torch.tensor(rng.standard_normal((nb, bs, KV, hd)), dtype=pdt,
                     device=dev)
    v = torch.tensor(rng.standard_normal((nb, bs, KV, hd)), dtype=pdt,
                     device=dev)
    kw = {}
    if dtype == "int8":
        k, ks = _kv_quant(k)
        v, vs = _kv_quant(v)
        kw = dict(k_scale=ks, v_scale=vs)
    tbl = _ragged_table(rng, pos, mb, nb, bs)
    if inactive_last:
        tbl[-1] = -1
    return (q, k, v, torch.tensor(tbl, device=dev),
            torch.tensor(pos, dtype=torch.int32, device=dev), kw)


def phase_paged_attn(torch, dev):
    from repro_torch.kernels.paged_attn.ops import (paged_attention,
                                                    paged_decode_torch)

    worst = {}
    n = 0
    for dtype in ("f32", "bf16", "int8"):
        for window in (0, 16):
            for B, H, KV, hd in ((4, 12, 12, 64), (3, 16, 2, 128)):
                pos = [5, 47, 100, 0][:B]  # the last slot gets an empty table
                q, k, v, tbl, p, kw = attn_inputs(
                    torch, dev, dtype, B, H, KV, hd, pos, seed=n,
                    inactive_last=True)
                out = paged_attention(q, k, v, tbl, p, window=window, **kw)
                torch.cuda.synchronize()
                ref = paged_decode_torch(q, k, v, tbl, p, window=window, **kw)
                if not bool(torch.isfinite(out).all()):
                    raise AssertionError("paged_attn output is not finite")
                err = (out[:B - 1].float() - ref[:B - 1].float()
                       ).abs().max().item()
                worst[dtype] = max(worst.get(dtype, 0.0), err)
                if err > ATTN_ATOL[dtype]:
                    raise AssertionError(
                        f"paged_attn {dtype} window={window} rep={H // KV}: "
                        f"max err {err} > {ATTN_ATOL[dtype]}")
                n += 1
    log(f"[3] paged_attn within bounds on {n} cases; worst {worst}")
    return max(worst.values()), worst


def phase_server(torch, dev):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.imc_mac.ops import imc_mac
    from repro_torch.kernels.paged_attn.ops import paged_attention
    from repro_torch.launch.serve import slo_summary
    from repro_torch.launch.server import Request, Server
    from repro_torch.models.model import decode_step, init_params, prefill
    from repro_torch.telemetry import Registry

    cfg = get_config("imc-paper-110m")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    log(f"[4] imc-paper-110m params ({cfg.n_params() / 1e6:.1f} M) on "
        f"{dev} in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPTS]
    server = Server(cfg, params, slots=4, kv="paged", block_size=16,
                    buckets=(16, 32, 64), registry=Registry(), device=dev)

    imc_mac.launches = 0
    paged_attention.launches = 0
    t0 = time.perf_counter()
    handles = [server.submit(Request(p, max_new_tokens=MAX_NEW))
               for p in prompts]
    server.drain()
    wall = time.perf_counter() - t0
    launches = {"imc_mac": imc_mac.launches,
                "paged_attn": paged_attention.launches}

    if not all(h.done and len(h.tokens) == MAX_NEW for h in handles):
        raise AssertionError("not every request finished with its tokens")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"the main path launched {name} no time")
    server.alloc.check()
    slos = slo_summary(server)
    log(f"[4] served {len(handles)} requests in {wall:.2f} s, "
        f"{server.decode_ticks} decode ticks; launches {launches}")
    log(f"[4] TTFT p50 {slos['ttft_ms']['p50']:.2f} ms, TPOT p50 "
        f"{slos['tpot_ms']['p50']:.2f} ms, decode "
        f"{slos['decode_tokens_per_s']:.1f} tok/s")

    # launches in one decode step at the server's shapes (4 slots, idle)
    with torch.inference_mode():
        imc_mac.launches = paged_attention.launches = 0
        tok = torch.zeros((4, 1), dtype=torch.int32, device=dev)
        table = torch.from_numpy(server.alloc.table()).to(dev)
        decode_step(params, server.cache, tok, cfg, block_table=table)
        torch.cuda.synchronize()
        per_step = {"imc_mac": imc_mac.launches,
                    "paged_attn": paged_attention.launches}

    # the first request's prefill logits: card vs the plain path on the CPU
    with torch.inference_mode():
        bucket = 16
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :PROMPTS[0]] = prompts[0]
        batch = {"tokens": torch.from_numpy(padded).to(dev),
                 "length": PROMPTS[0]}
        card, _ = prefill(params, batch, cfg)
        card = card.float().cpu()
        cpu_params = _to_cpu(params)
        plain, _ = prefill(cpu_params, {"tokens": batch["tokens"].cpu(),
                                        "length": PROMPTS[0]}, cfg)
    err = (card - plain).abs().max().item()
    scale = plain.abs().max().item()
    if not err <= LOGIT_RTOL * scale:
        raise AssertionError(f"prefill logits card vs CPU: max err {err} > "
                             f"{LOGIT_RTOL} x {scale}")
    if handles[0].tokens[0] != int(card[0].argmax()):
        raise AssertionError("the server's first token is not the argmax of "
                             "its prefill logits")
    log(f"[4] prefill logits card vs CPU plain path: max err {err:.3g} "
        f"(largest |logit| {scale:.3g}); top-1 "
        f"{'equal' if int(card.argmax()) == int(plain.argmax()) else 'DIFFERS'}")
    return {"launches": launches, "per_step": per_step, "slos": slos,
            "wall_s": wall, "decode_ticks": server.decode_ticks,
            "logit_err": err, "logit_scale": scale}


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


def time_imc_mac(torch, dev):
    """One decode step's imc_mac work: 12 layers x 6 projections at M = 4
    (4 slots), cycling 12 distinct weight sets (85 MB, more than L2)."""
    from repro_torch.kernels.imc_mac.ops import imc_mac, imc_mac_torch

    g = torch.Generator(device=dev).manual_seed(2)
    shapes = [(768, 768)] * 4 + [(768, 3072), (3072, 768)]
    m, layers = 4, 12
    a = {k: torch.randint(-127, 128, (m, k), generator=g, device=dev,
                          dtype=torch.int8) for k in (768, 3072)}
    a_pad = {k: torch.cat([v, v.new_zeros((32 - m, k))]) for k, v in a.items()}
    ws = [[torch.randint(-127, 128, s, generator=g, device=dev,
                         dtype=torch.int8) for s in shapes]
          for _ in range(layers)]

    def step(fn, act):
        for lw in ws:
            for w in lw:
                fn(act[w.shape[0]], w)

    ms = cuda_ms(torch, lambda: step(imc_mac, a), iters=20)
    plain = cuda_ms(torch, lambda: step(imc_mac_torch, a), iters=5)
    lib = cuda_ms(torch, lambda: step(torch._int_mm, a_pad), iters=20)
    nbytes = layers * sum(m * k + k * n + 4 * m * n for k, n in shapes)
    ops = layers * sum(2 * m * k * n for k, n in shapes)
    b_ms, by = bound(nbytes, ops, INT8_OPS_PER_S)
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=by,
                shape="one decode step: 12 layers x {4x (768,768), "
                      "(768,3072), (3072,768)} at M=4; library: "
                      "torch._int_mm with M padded to 32")


def time_paged_attn(torch, dev):
    """One decode step's attention: 12 layers, 4 slots, 12 heads (rep 1),
    hd 64, bf16 pools, block 16, 8 table blocks, positions 22/31/48/27."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attn.ops import (paged_attention,
                                                    paged_decode_torch)

    B, H, KV, hd, bs, mb, layers = 4, 12, 12, 64, 16, 8, 12
    pos = [22, 31, 48, 27]
    ins = [attn_inputs(torch, dev, "bf16", B, H, KV, hd, pos, bs=bs, mb=mb,
                       seed=100 + i) for i in range(layers)]
    # the library yardstick attends over the gathered span, dense
    dense = []
    for q, k, v, tbl, p, _ in ins:
        nb = k.shape[0]
        ctx = torch.arange(mb * bs, device=dev)
        t = torch.where(tbl < 0, 0, tbl).long()
        gidx = t[:, ctx // bs] * bs + ctx % bs
        valid = (ctx[None] <= p.long()[:, None]) & (tbl[:, ctx // bs] >= 0)
        kd = k.reshape(nb * bs, KV, hd)[gidx].permute(0, 2, 1, 3)
        vd = v.reshape(nb * bs, KV, hd)[gidx].permute(0, 2, 1, 3)
        dense.append((q.permute(0, 2, 1, 3).contiguous(), kd.contiguous(),
                      vd.contiguous(), valid[:, None, None, :]))

    ms = cuda_ms(torch, lambda: [paged_attention(q, k, v, t, p)
                                 for q, k, v, t, p, _ in ins], iters=50)
    plain = cuda_ms(torch, lambda: [paged_decode_torch(q, k, v, t, p)
                                    for q, k, v, t, p, _ in ins], iters=20)
    lib = cuda_ms(torch, lambda: [F.scaled_dot_product_attention(
        q, k, v, attn_mask=msk) for q, k, v, msk in dense], iters=50)
    live = sum(p_ + 1 for p_ in pos)
    nbytes = layers * (live * KV * hd * 2 * 2 + 2 * B * H * hd * 2
                       + 4 * (B * mb + B))
    ops = layers * live * H * hd * 2 * 2
    b_ms, by = bound(nbytes, ops, BF16_FLOPS_PER_S)
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=by,
                shape="one decode step: 12 layers x (B=4, H=KV=12, hd=64, "
                      "bf16, block 16, 8 blocks/slot, pos 22/31/48/27); "
                      "library: F.scaled_dot_product_attention over the "
                      "pre-gathered span")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: {src}/repro_torch not found; run from the root "
              "of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.device import resolve_device

    dev = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()

    build_s = phase_build()
    mac_err = phase_imc_mac(torch, dev)
    attn_err, attn_worst = phase_paged_attn(torch, dev)
    served = phase_server(torch, dev)
    t_mac = time_imc_mac(torch, dev)
    t_attn = time_paged_attn(torch, dev)

    kernels = [
        dict(name="imc_mac", route="cuda",
             source="src/repro_torch/csrc/imc_mac.cu",
             replaces="src/repro/kernels/imc_mac/imc_mac.py:65",
             launches=served["launches"]["imc_mac"],
             launches_per_decode_step=served["per_step"]["imc_mac"],
             max_abs_err=mac_err, **t_mac),
        dict(name="paged_attn", route="cuda",
             source="src/repro_torch/csrc/paged_attn.cu",
             replaces="src/repro/kernels/paged_attn/paged_attn.py:131",
             launches=served["launches"]["paged_attn"],
             launches_per_decode_step=served["per_step"]["paged_attn"],
             max_abs_err=attn_err, max_abs_err_by_dtype=attn_worst, **t_attn),
    ]
    for k in kernels:
        log(f"[5] {k['name']}: {k['ms']:.4f} ms (bound {k['bound_ms']:.4f} ms"
            f" by {k['bound_by']}; plain {k['plain_ms']:.4f} ms; library "
            f"{k['library_ms']:.4f} ms); {k['launches_per_decode_step']} "
            f"launches per decode step, {k['launches']} in the run")
    log(f"[6] build {build_s:.2f} s; server {json.dumps(served)}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
