"""End-to-end driver: train the ~110M-parameter paper-demonstrator LM with
EVERY projection running through the IMC fabric's exact digital-equivalent
path (the ``imc_mac`` int8 GEMM on the card, its straight-through backward
in float32), the fault-tolerant loop and checkpoints included (port of
``examples/train_tiny_lm.py``).

    PYTHONPATH=src python -m repro_torch.train_tiny_lm [--steps 300]
    PYTHONPATH=src python -m repro_torch.train_tiny_lm --small --device cpu

``--small`` trains a width-reduced variant in seconds; the default is the
full 110M, on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.configs import get_config, reduce_config
from repro_torch.launch.train import train
from repro_torch.tree import tree_leaves


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true",
                    help="width-reduced variant (CI-speed)")
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config("imc-paper-110m")
    if args.small:
        cfg = reduce_config(cfg)
    batch = args.batch or (8 if args.small else 4)
    seq = args.seq or (64 if args.small else 512)

    with tempfile.TemporaryDirectory() as ckpt:
        (params, _), hist = train(cfg, steps=args.steps, global_batch=batch,
                                  seq_len=seq, ckpt_root=ckpt,
                                  ckpt_every=max(args.steps // 4, 1),
                                  lr=1e-3, device=args.device)
    losses = [m["loss"] for m in hist]
    n = sum(x.numel() for x in tree_leaves(params))
    fab = cfg.imc_fabric
    print(f"params: {n/1e6:.1f}M  (fabric={fab.label}, "
          f"{fab.bits_a}x{fab.bits_w}-bit)" if fab else
          f"params: {n/1e6:.1f}M  (fabric off)")
    print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"over {args.steps} steps")
    if not losses[-1] < losses[0]:
        raise SystemExit("training must reduce loss")
    print("train_tiny_lm OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
