"""Deterministic, shardable synthetic data pipeline (port of
``repro/data/pipeline.py``).

Produces reproducible token streams keyed by (seed, step, host_shard) so that
  * every data-parallel host draws a disjoint batch slice,
  * restart-from-checkpoint resumes the exact stream position (the cursor is
    just the step counter — no iterator state to persist),
  * elastic re-sharding (host count change) re-partitions the same global
    stream deterministically.

The generator is counter-based and random-access: numpy's Philox4x32-10
keyed by ``(seed, step << 32 | shard)``, where the reference uses threefry
through ``jax.random``.  The two draw different streams; the drift
transform, ``(base + cumsum(base % 7)) % V``, is the reference's.  Batches
are numpy arrays, as the reference hands its loop host arrays; the trainer
moves them to the device.  With ``frontend_dim > 0`` (a modality stub) a
batch carries "embeddings" (per, seq, frontend_dim) in place of "tokens":
standard normals drawn after the tokens from the same generator, rounded to
bf16 values (the reference draws them in bf16) and held in a float32 array,
which the model casts to bf16 exactly.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MASK64 = (1 << 64) - 1


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend_dim: int = 0  # >0: emit precomputed embeddings (modality stub)


def drift_tokens(base: np.ndarray, vocab_size: int) -> np.ndarray:
    """The reference's drift: ``(base + cumsum(base % 7)) % V``.  The
    reference calls it a learnable Markov-ish signal, but ``b -> b + b % 7``
    is one to one on each block of seven values, so on a uniform ``base``
    the next token stays uniform given the past (but for the blocks cut by
    the wrap at V): what a model can learn is the uniform prediction, loss
    ln V, which random weights start above."""
    drift = np.cumsum(base % 7, axis=1) % vocab_size
    return ((base + drift) % vocab_size).astype(np.int32)


def round_to_bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bf16 (ties to even), still
    float32 (finite inputs)."""
    bits = x.astype(np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return bits.view(np.float32)


class SyntheticStream:
    """Random-access LM batches: ``batch(step, shard, n_shards)``."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def _rng(self, step: int, shard: int) -> np.random.Generator:
        if not (0 <= step < 1 << 32 and 0 <= shard < 1 << 32):
            raise ValueError(f"step {step} and shard {shard} must lie in "
                             "[0, 2**32)")
        key = [self.cfg.seed & MASK64, (step << 32) | shard]
        return np.random.Generator(np.random.Philox(key=key))

    def batch(self, step: int, shard: int = 0, n_shards: int = 1):
        cfg = self.cfg
        if cfg.global_batch % n_shards:
            raise ValueError(f"global_batch {cfg.global_batch} not divisible "
                             f"by {n_shards} shards")
        per = cfg.global_batch // n_shards
        rng = self._rng(step, shard)
        base = rng.integers(0, cfg.vocab_size, (per, cfg.seq_len + 1),
                            dtype=np.int32)
        toks = drift_tokens(base, cfg.vocab_size)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.frontend_dim:
            out["embeddings"] = round_to_bf16(rng.standard_normal(
                (per, cfg.seq_len, cfg.frontend_dim), dtype=np.float32))
            del out["tokens"]
        return out

    def host_iterator(self, start_step: int, shard: int, n_shards: int):
        step = start_step
        while True:
            yield step, self.batch(step, shard, n_shards)
            step += 1


def batch_for_shape(cfg_model, shape, seed: int = 0):
    """Convenience: a synthetic batch for a shape (any object with
    ``seq_len`` and ``global_batch``, as the reference's ``ShapeConfig``)."""
    dc = DataConfig(cfg_model.vocab_size, shape.seq_len, shape.global_batch,
                    seed=seed,
                    frontend_dim=(cfg_model.frontend_dim
                                  if cfg_model.frontend != "none" else 0))
    return SyntheticStream(dc).batch(0)


def validate_determinism(cfg: DataConfig) -> bool:
    s1, s2 = SyntheticStream(cfg), SyntheticStream(cfg)
    a = s1.batch(7, 1, 4)
    b = s2.batch(7, 1, 4)
    return all(bool(np.array_equal(a[k], b[k])) for k in a)
