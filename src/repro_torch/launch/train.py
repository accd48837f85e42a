"""End-to-end trainer: data -> train step -> checkpoints, fault-tolerant (port
of ``repro/launch/train.py``).

:func:`train` is one process on one device: the card unless
``device="cpu"`` (``--device cpu``) is asked for.  The step cache, the noise
seeds and the step-time telemetry live in
:class:`repro_torch.launch.engine.Engine`; this file is just the loop.

    python -m repro_torch.launch.train --arch imc-paper-110m --steps 200 \\
        --ckpt /tmp/ckpt --batch 8 --seq 256
    python -m repro_torch.launch.train --arch imc-paper-110m --reduce \\
        --device cpu --steps 5

With ``ckpt_root`` the steps run in a
:class:`~repro_torch.runtime.fault_tolerance.FaultTolerantLoop`: a
``fail_at`` step raises :class:`InjectedFailure` out of :func:`train`, and
calling :func:`train` again with the same root resumes from the latest
committed checkpoint.

:func:`train_fleet` (``--fleet-hosts N``) trains on a virtual fleet
(:mod:`repro_torch.fleet`): N hosts over a device list
(``--fleet-devices``, default every visible card; ``cuda:0,cuda:0`` is two
hosts on one card, ``cpu,cpu`` two on the CPU), one Engine each, every host
stepping its own replica of the whole state; a host the straggler monitor
flags leaves the fleet and the survivors resume from the latest checkpoint.

    python -m repro_torch.launch.train --arch imc-paper-110m --reduce \\
        --fleet-hosts 2 --fleet-devices cpu,cpu --steps 5
"""
from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.core.fabric import add_fabric_cli, apply_fabric_cli
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.device import DeviceLike, deterministic
from repro_torch.launch.engine import Engine
from repro_torch.models.model import init_params
from repro_torch.optim.adamw import AdamWConfig, init_adamw
from repro_torch.runtime.fault_tolerance import FaultTolerantLoop
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.telemetry import clock
from repro_torch.tree import tree_leaves


def _opt_cfg(steps: int, lr: float) -> AdamWConfig:
    return AdamWConfig(lr=lr, warmup_steps=min(20, steps // 10 + 1),
                       total_steps=steps)


def _stream(cfg, seq_len: int, global_batch: int, seed: int):
    return SyntheticStream(DataConfig(
        cfg.vocab_size, seq_len, global_batch, seed=seed,
        frontend_dim=cfg.frontend_dim if cfg.frontend != "none" else 0))


def _make_step_fn(engine: Engine, cfg, opt_cfg: AdamWConfig,
                  metrics_hist: list):
    """``(state, batch, step) -> state`` on ``engine``'s device: the batch
    copied in, one cached train step, its metrics read back (which waits for
    the step) into ``metrics_hist`` with ``step_s``, its wall time."""
    dev = engine.device
    step_fn_ = engine.train_step(cfg, opt_cfg)

    def step_fn(state, batch, step):
        t0 = clock()
        params, opt_state = state
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        params, opt_state, metrics = step_fn_(params, opt_state, batch,
                                              engine.noise_seed(step))
        m = {k: float(v) for k, v in metrics.items()}  # waits for the step
        m["step_s"] = clock() - t0
        metrics_hist.append(m)
        return (params, opt_state)

    return step_fn


def train(cfg, *, steps: int, global_batch: int, seq_len: int,
          ckpt_root: str | None = None, ckpt_every: int = 50,
          lr: float = 3e-4, seed: int = 0, engine: Engine | None = None,
          log_every: int = 10, fail_at=None, device: DeviceLike = None):
    """Train ``cfg`` from random weights (``init_params(cfg, seed=seed)``)
    on the synthetic stream of ``seed``.  Returns ((params, opt_state),
    metrics per step run: the step's loss, ce, grad_norm and lr, and
    ``step_s``, its wall time from the batch's copy-in to the metrics read
    back).  ``engine`` (default: a new one on ``device``) sets the device
    and the noise seeds.  The steps run under deterministic algorithms
    (:func:`repro_torch.device.deterministic`), so a run resumed from a
    checkpoint repeats an uninterrupted one bit for bit."""
    engine = engine or Engine(device=device, noise_seed=seed,
                              monitor=StragglerMonitor())
    stream = _stream(cfg, seq_len, global_batch, seed)
    params = init_params(cfg, device=engine.device, seed=seed)
    # the loop holds the state only through ``state``: a step's old params
    # and optimizer state are freed once the next ones replace them
    state = (params, init_adamw(params))
    del params
    metrics_hist = []
    step_fn = _make_step_fn(engine, cfg, _opt_cfg(steps, lr), metrics_hist)

    with deterministic():
        if ckpt_root:
            loop = FaultTolerantLoop(
                ckpt_root, step_fn, lambda s: stream.batch(s),
                ckpt_every=ckpt_every, fail_at=fail_at,
                monitor=engine.monitor or StragglerMonitor())
            state = loop.run(state, steps)
        else:
            for s in range(steps):
                t0 = clock()
                state = step_fn(state, stream.batch(s), s)
                engine.observe_step_time(clock() - t0)
                if s % log_every == 0:
                    m = metrics_hist[-1]
                    print(f"step {s:5d} loss={m['loss']:.4f} "
                          f"ce={m['ce']:.4f} gnorm={m['grad_norm']:.2f} "
                          f"({clock()-t0:.2f}s)", flush=True)
    return state, metrics_hist


def train_fleet(cfg, *, n_hosts: int, steps: int, global_batch: int,
                seq_len: int, ckpt_root: str, ckpt_every: int = 10,
                lr: float = 3e-4, seed: int = 0, delay=None, devices=None):
    """Virtual-fleet trainer: one Engine per coordinator host, fleet monitor,
    straggler shrink + checkpoint resume (see :mod:`repro_torch.fleet`).

    ``devices`` lists the fleet's devices (default: every visible card),
    split into ``n_hosts`` equal groups.  Every host steps a replica of the
    full state, made by :func:`train`'s init and step, on its own device;
    the controller's replica is what gets checkpointed and returned, so a
    run equals :func:`train` of the same steps bit for bit.  ``delay``
    injects synthetic per-host skew into observed times (chaos drills).
    Returns ((params, opt_state), the controller's metrics per step run,
    the :class:`FleetEngine`, the :class:`FleetTrainLoop`).
    """
    from repro_torch.fleet import FleetEngine, FleetTrainLoop, LocalCoordinator
    from repro_torch.runtime.elastic import plan_for_fleet

    coord = LocalCoordinator(n_hosts, devices=devices)
    fleet = FleetEngine(coord, noise_seed=seed)
    per_host = coord.hosts()[0].n_devices
    mp = coord.model_parallel if per_host % coord.model_parallel == 0 else 1
    plan = plan_for_fleet(n_hosts, per_host, model_parallel=mp,
                          base_batch=global_batch)
    opt_cfg = _opt_cfg(steps, lr)
    stream = _stream(cfg, seq_len, global_batch, seed)
    params = init_params(cfg, device=fleet.host(fleet.controller).device,
                         seed=seed)
    init_state = (params, init_adamw(params))
    del params
    metrics_hist = {}

    def make_step(engine, host):
        hist = metrics_hist.setdefault(host, [])
        step_fn = _make_step_fn(engine, cfg, opt_cfg, hist)

        def logged(state, batch, step):
            state = step_fn(state, batch, step)
            if host == fleet.controller and step % 10 == 0:
                print(f"[fleet {len(fleet.active_hosts())}h] step {step:5d} "
                      f"loss={hist[-1]['loss']:.4f}", flush=True)
            return state

        return logged

    loop = FleetTrainLoop(fleet, ckpt_root, make_step,
                          lambda s: stream.batch(s), plan,
                          model_parallel=mp, ckpt_every=ckpt_every,
                          delay=delay)
    with deterministic():
        state = loop.run(init_state, steps)
    return state, metrics_hist.get(fleet.controller, []), fleet, loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="imc-paper-110m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--reduce", action="store_true",
                    help="use the smoke-scale config variant")
    ap.add_argument("--fleet-hosts", type=int, default=1,
                    help="virtual fleet: split --fleet-devices into N hosts "
                         "and train via repro_torch.fleet (the device count "
                         "must divide by N)")
    ap.add_argument("--fleet-devices", default=None,
                    help="comma-separated devices of the fleet (default: "
                         "every visible card); cuda:0,cuda:0 is two hosts "
                         "on one card, cpu,cpu two on the CPU")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (single host)")
    add_fabric_cli(ap)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduce_config(cfg)
    cfg = apply_fabric_cli(args, cfg)
    if args.fleet_hosts > 1:
        devices = args.fleet_devices.split(",") if args.fleet_devices \
            else None
        # without --ckpt the fleet's checkpoints live only as long as the run
        with tempfile.TemporaryDirectory(prefix="fleet_ckpt_") as tmp:
            (params, _), hist, fleet, _ = train_fleet(
                cfg, n_hosts=args.fleet_hosts, steps=args.steps,
                global_batch=args.batch, seq_len=args.seq,
                ckpt_root=args.ckpt or tmp, lr=args.lr, seed=args.seed,
                devices=devices)
        print(f"fleet: {len(fleet.active_hosts())} hosts, "
              f"{fleet.total_traces()} traces total")
    else:
        (params, _), hist = train(
            cfg, steps=args.steps, global_batch=args.batch,
            seq_len=args.seq, ckpt_root=args.ckpt, lr=args.lr,
            seed=args.seed, device=args.device)
    losses = [m["loss"] for m in hist]
    print(f"\nfinal loss {losses[-1]:.4f} (start {losses[0]:.4f}); "
          f"params = {sum(x.numel() for x in tree_leaves(params)):,}")


if __name__ == "__main__":
    main()
