"""Sharded checkpointing: atomic publish, async save, keep-last-k GC, restore
(port of ``repro/checkpoint/checkpoint.py``, same on-disk layout).

Layout (one directory per step):
    <root>/step_000000123/
        meta.json            {"step": 123, "n_leaves": N, "n_shards": S,
                              "treedef": <tree_structure text>,
                              "dtypes": [<leaf dtype name>, ...]}
        shard_00000.npz      leaves leaf_<i>, i in [i0, i1), in leaf order
        ...
        COMMITTED            sentinel written last (atomic publish)

Leaves are numbered in :mod:`repro_torch.tree`'s order (dicts by sorted
key, NamedTuples by field, lists in order), which is also the order in
which ``restore`` fills the structure of its ``tree_like``.  bfloat16
leaves are stored as their uint16 bit patterns (npz has no bfloat16), so a
restore is bit-exact.  ``meta.json`` also lists each leaf's dtype (a key
the reference's reader ignores), and a leaf is restored in its saved dtype:
a trainer's first state holds float32 norm scales, which every step casts
to bf16, and the reference, which takes the dtype from ``tree_like``,
reads those scales' bf16 bits back as integers (16256.0 for 1.0).  A
checkpoint without the list (the reference's) takes ``tree_like``'s
dtypes, as the reference does.

  * atomicity — readers only trust directories containing COMMITTED; a crash
    mid-save leaves a ``.tmp`` directory, never a half-readable checkpoint;
    the directory is published by one ``os.rename``.
  * async — ``save_async`` snapshots to host memory on the caller's thread,
    then writes on a background thread; the train loop keeps stepping.
  * sharded files — leaves are partitioned into ~``shard_mb`` chunks.
  * GC — ``keep_last`` prunes old steps after each successful publish.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_structure, tree_unflatten

_SENTINEL = "COMMITTED"


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:09d}")


def to_host(x) -> np.ndarray:
    """A leaf as a host numpy array; bfloat16 as its uint16 bit view."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).cpu().numpy().view(np.uint16)
        return x.cpu().numpy()
    return np.asarray(x)


def dtype_name(x) -> str:
    """A leaf's dtype as ``meta.json`` lists it (``bfloat16``,
    ``float32``, ...)."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return np.asarray(x).dtype.name


def _from_storable(arr: np.ndarray, like, dtype: Optional[str]) -> Any:
    """A stored array as a leaf like ``like``: a tensor on its device in
    the saved ``dtype`` (default: like's; bf16 from the uint16 view), else a
    numpy array."""
    if isinstance(like, torch.Tensor):
        dtype = dtype or dtype_name(like)
        if dtype == "bfloat16" and arr.dtype == np.uint16:
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr, copy=True)).to(
                getattr(torch, dtype))
        return t.reshape(like.shape).to(like.device)
    return np.asarray(arr, dtype=dtype or np.asarray(like).dtype).reshape(
        np.shape(like))


def save(root: str, step: int, tree: Any, *, shard_mb: int = 256,
         keep_last: int = 3, dtypes: Optional[list] = None) -> str:
    """Write ``tree`` as step ``step`` under ``root`` and publish it.
    ``dtypes`` names the leaves' dtypes when ``tree`` is a host snapshot
    (whose bf16 leaves are already uint16)."""
    leaves = tree_leaves(tree)
    dtypes = dtypes or [dtype_name(x) for x in leaves]
    host = [to_host(x) for x in leaves]
    tmp = _step_dir(root, step) + ".tmp"
    final = _step_dir(root, step)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    budget = shard_mb * 1024 * 1024
    shards, cur, cur_bytes = [], [], 0
    for i, arr in enumerate(host):
        cur.append(i)
        cur_bytes += arr.nbytes
        if cur_bytes >= budget:
            shards.append(cur)
            cur, cur_bytes = [], 0
    if cur:
        shards.append(cur)

    for si, idxs in enumerate(shards):
        np.savez(os.path.join(tmp, f"shard_{si:05d}.npz"),
                 **{f"leaf_{i}": host[i] for i in idxs})
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "n_leaves": len(host),
                   "n_shards": len(shards),
                   "treedef": tree_structure(tree), "dtypes": dtypes}, f)
    with open(os.path.join(tmp, _SENTINEL), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _gc(root, keep_last)
    return final


class AsyncCheckpointer:
    """Background-thread saver; at most one outstanding save (newer wins)."""

    def __init__(self, root: str, *, keep_last: int = 3):
        self.root = root
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save_async(self, step: int, tree: Any):
        self.wait()  # serialize: the snapshot happens on the caller's thread
        leaves = tree_leaves(tree)
        dtypes = [dtype_name(x) for x in leaves]
        # a copy: a CPU tensor's numpy view would share the live memory
        host = tree_unflatten(tree, [np.array(to_host(x)) for x in leaves])

        def _run():
            try:
                save(self.root, step, host, keep_last=self.keep_last,
                     dtypes=dtypes)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    best = None
    for name in os.listdir(root):
        if name.startswith("step_") and not name.endswith(".tmp"):
            d = os.path.join(root, name)
            if os.path.exists(os.path.join(d, _SENTINEL)):
                best = max(best or -1, int(name[5:]))
    return best


def restore(root: str, tree_like: Any, step: Optional[int] = None):
    """Restore into the structure of ``tree_like``, each leaf on its
    device, in its saved dtype (see the module docstring). Returns (tree,
    step)."""
    step = latest_step(root) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint under {root}")
    d = _step_dir(root, step)
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    leaves_like = tree_leaves(tree_like)
    if meta["n_leaves"] != len(leaves_like):
        raise ValueError(f"leaf count mismatch: ckpt {meta['n_leaves']} vs "
                         f"expected {len(leaves_like)}")
    host = [None] * meta["n_leaves"]
    for si in range(meta["n_shards"]):
        with np.load(os.path.join(d, f"shard_{si:05d}.npz")) as z:
            for k in z.files:
                host[int(k[5:])] = z[k]
    dtypes = meta.get("dtypes") or [None] * len(host)
    leaves = [_from_storable(h, like, dt)
              for h, like, dt in zip(host, leaves_like, dtypes)]
    return tree_unflatten(tree_like, leaves), step


def _gc(root: str, keep_last: int):
    steps = sorted(
        int(n[5:]) for n in os.listdir(root)
        if n.startswith("step_") and not n.endswith(".tmp")
        and os.path.exists(os.path.join(root, n, _SENTINEL)))
    for s in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(_step_dir(root, s), ignore_errors=True)
