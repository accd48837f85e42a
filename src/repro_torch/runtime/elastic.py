"""Elastic scaling: rebuild the mesh after node loss/gain and re-shard state
(a copy of ``repro/runtime/elastic.py``: pure host-side policy, kept here so
the port imports nothing of the JAX package).

Strategy (hierarchical, matches the sharding design in launch/sharding.py):
the TP ('model') extent is fixed by the model's head/ffn divisibility, so
elasticity happens on the DP axes: after a failure we snap the surviving chip
count to the largest usable (pod x data x model) grid, reload the latest
committed checkpoint (full-replica npz — resharding is a no-op at the host
level), and resume with a re-scaled global batch.

Pure host-side policy + a re-mesh helper; exercised in tests with fake
device counts.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    global_batch: int

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def plan_mesh(n_devices: int, *, model_parallel: int, base_batch: int,
              batch_per_replica: Optional[int] = None,
              multi_pod_threshold: int = 512) -> MeshPlan:
    """Largest (data, model) or (pod, data, model) grid using <= n_devices.

    - 'model' extent is fixed (architecture divisibility constraint).
    - remaining devices go to 'data'; if the fleet spans pods (>= threshold),
      a leading 'pod' axis of 2 is split off (hierarchical collectives).
    - global batch scales with the DP extent so per-replica batch is constant.
    """
    if n_devices < model_parallel:
        raise ValueError(f"need >= {model_parallel} devices for TP")
    dp = n_devices // model_parallel
    if batch_per_replica is None:
        batch_per_replica = max(base_batch // dp, 1)
    if n_devices >= multi_pod_threshold and dp % 2 == 0:
        plan = MeshPlan((2, dp // 2, model_parallel), ("pod", "data", "model"),
                        batch_per_replica * dp)
    else:
        plan = MeshPlan((dp, model_parallel), ("data", "model"),
                        batch_per_replica * dp)
    return plan


def shrink_after_failure(plan: MeshPlan, lost_devices: int,
                         *, model_parallel: int) -> MeshPlan:
    """Re-plan after losing ``lost_devices`` chips (drop whole DP replicas)."""
    survivors = plan.n_devices - lost_devices
    dp_old = plan.n_devices // model_parallel
    per_replica = plan.global_batch // dp_old
    return plan_mesh(survivors, model_parallel=model_parallel,
                     base_batch=plan.global_batch,
                     batch_per_replica=per_replica)


def plan_for_fleet(n_hosts: int, devices_per_host: int, *,
                   model_parallel: int, base_batch: int,
                   batch_per_replica: Optional[int] = None) -> MeshPlan:
    """Fleet-shaped entry point: plan over ``n_hosts x devices_per_host``.

    Thin sugar over :func:`plan_mesh` used by the fleet coordinator so a
    straggler shrink can re-plan in whole-host units
    (``shrink_after_failure(plan, devices_per_host * len(flagged), ...)``).
    """
    return plan_mesh(n_hosts * devices_per_host,
                     model_parallel=model_parallel, base_batch=base_batch,
                     batch_per_replica=batch_per_replica)
