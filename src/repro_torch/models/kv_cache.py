"""Paged KV cache: fixed-size blocks, a free-list allocator, block tables
(port of ``repro/models/kv_cache.py``).

A pool of ``num_blocks`` fixed-size blocks per attention layer is shared by
all slots, and a per-slot **block table** maps logical block ``j`` (positions
``[j*block_size, (j+1)*block_size)``) to a physical block id.

  * :class:`BlockAllocator` — host-side free-list bookkeeping with
    ``alloc`` / ``append`` / ``release`` per slot, worst-case
    *reservations*, and :meth:`check` invariants.  Pure Python, copied from
    the reference.
  * :func:`init_paged_cache` builds an empty paged
    :class:`~repro_torch.models.transformer.StackCache` shaped after one
    request's ring cache, and :func:`merge_prefill_cache` scatters a freshly
    prefilled (B=1, possibly padded) ring cache into the pools at the
    positions its ``key_pos`` names.  Both write the batch cache in place.
    Recurrent layers (``SsdCache``, ``RgLruCache``) keep their state dense,
    one row per slot beside the pools (it is O(1) in sequence length, so
    paging buys nothing there), written at the slot on admission.

The ring path in :mod:`repro_torch.models.attention` remains the oracle.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.models.attention import (AttnCache, PagedAttnCache,
                                          scatter_rows)

__all__ = [
    "BlockAllocator", "OutOfBlocks", "PagedAttnCache",
    "init_paged_cache", "merge_prefill_cache", "broadcast_slots",
]


class OutOfBlocks(RuntimeError):
    """The free list (minus outstanding reservations) cannot cover a request."""


class BlockAllocator:
    """Free-list allocator over ``num_blocks`` KV blocks with per-slot tables.

    ``alloc(slot, n, reserve=m)`` hands ``n`` physical blocks to ``slot`` now
    and *reserves* ``m`` more from the shared budget (admission control: a
    request that may grow to ``n+m`` blocks is admitted only if all of them
    are guaranteed).  ``append(slot)`` materializes one block — drawing from
    the slot's reservation first — when decode crosses a block boundary.
    ``release(slot)`` returns everything to the free list (early, when a
    request finishes before its ``max_new_tokens`` budget).
    """

    def __init__(self, num_blocks: int, block_size: int, slots: int,
                 max_blocks_per_slot: Optional[int] = None):
        if num_blocks < 1 or block_size < 1 or slots < 1:
            raise ValueError(
                f"invalid paged geometry: {num_blocks} blocks x "
                f"{block_size} tokens, {slots} slots")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.slots = slots
        self.max_blocks_per_slot = max_blocks_per_slot or num_blocks
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._tables: List[List[int]] = [[] for _ in range(slots)]
        self._reserved: List[int] = [0] * slots

    # ------------------------------------------------------------- queries
    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` KV rows."""
        return -(-n_tokens // self.block_size)

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def available(self) -> int:
        """Free blocks not promised to anyone (the admission budget)."""
        return len(self._free) - sum(self._reserved)

    def can_admit(self, n_blocks: int) -> bool:
        return n_blocks <= self.available

    def slot_blocks(self, slot: int) -> List[int]:
        return list(self._tables[slot])

    # ------------------------------------------------------------ mutation
    def alloc(self, slot: int, n: int, reserve: int = 0) -> List[int]:
        """Assign ``n`` blocks to ``slot`` and reserve ``reserve`` more."""
        if len(self._tables[slot]) + self._reserved[slot] + n + reserve \
                > self.max_blocks_per_slot:
            raise OutOfBlocks(
                f"slot {slot}: {n}+{reserve} blocks exceed the per-slot "
                f"table width {self.max_blocks_per_slot}")
        if n + reserve > self.available:
            raise OutOfBlocks(
                f"need {n}+{reserve} blocks, only {self.available} of "
                f"{self.num_blocks} available (free={self.num_free}, "
                f"reserved={sum(self._reserved)})")
        got = [self._free.pop() for _ in range(n)]
        self._tables[slot].extend(got)
        self._reserved[slot] += reserve
        return got

    def append(self, slot: int) -> int:
        """One more block for ``slot`` (reservation-first, else free budget)."""
        if len(self._tables[slot]) >= self.max_blocks_per_slot:
            raise OutOfBlocks(f"slot {slot}: block table full "
                              f"({self.max_blocks_per_slot})")
        if self._reserved[slot] > 0:
            self._reserved[slot] -= 1
        elif self.available < 1:
            raise OutOfBlocks(f"slot {slot}: free list dry on append")
        blk = self._free.pop()
        self._tables[slot].append(blk)
        return blk

    def release(self, slot: int) -> List[int]:
        """Return all of ``slot``'s blocks (and reservation) to the pool."""
        blks = self._tables[slot]
        self._free.extend(blks)
        self._tables[slot] = []
        self._reserved[slot] = 0
        return blks

    # ----------------------------------------------------------- the table
    def table(self) -> np.ndarray:
        """(slots, max_blocks_per_slot) int32 block table; -1 = empty."""
        t = np.full((self.slots, self.max_blocks_per_slot), -1, np.int32)
        for s, blks in enumerate(self._tables):
            t[s, :len(blks)] = blks
        return t

    def table_row(self, slot: int) -> np.ndarray:
        return self.table()[slot]

    def check(self) -> None:
        """Assert the allocator invariants (tests and chaos drills call this).

        * partition: free list + all slot tables = exactly ``num_blocks``
          distinct ids — no block is double-assigned or leaked;
        * tables are dense prefixes (block ``j`` of a slot covers logical
          positions ``[j*bs, (j+1)*bs)`` — compaction is never needed);
        * reservations are non-negative and covered by the free list.
        """
        owned = [b for t in self._tables for b in t]
        allb = self._free + owned
        assert len(set(owned)) == len(owned), "block double-assigned"
        assert sorted(allb) == list(range(self.num_blocks)), \
            "free+assigned is not a partition of the pool"
        for s, t in enumerate(self._tables):
            assert len(t) <= self.max_blocks_per_slot, f"slot {s} overfull"
        assert all(r >= 0 for r in self._reserved), "negative reservation"
        assert sum(self._reserved) <= len(self._free), \
            "reservations exceed the free list"


# ------------------------------------------------------------ device caches
def broadcast_slots(one, slots: int):
    """A zero-filled layer cache with ``slots`` rows, shaped after a B=1 one
    (a ring ``AttnCache``, an ``SsdCache`` or an ``RgLruCache``)."""
    return type(one)(*[None if o is None else
                       o.new_zeros((slots,) + tuple(o.shape[1:]))
                       for o in one])


def _empty_pool_like(one: AttnCache, num_blocks: int,
                     block_size: int) -> PagedAttnCache:
    """Zeroed paged pools shaped after one ring cache (keeps the KV/hd
    geometry; drops the per-slot (1, T) window)."""

    def pool(ring):
        if ring is None:
            return None
        return ring.new_zeros((num_blocks, block_size) + tuple(ring.shape[2:]))

    return PagedAttnCache(k=pool(one.k), v=pool(one.v),
                          k_scale=pool(one.k_scale),
                          v_scale=pool(one.v_scale))


def init_paged_cache(one, slots: int, num_blocks: int, block_size: int):
    """Empty batched paged cache shaped after one request's ring StackCache:
    attention layers become shared pools, recurrent layers ``slots`` rows of
    state, ``pos`` a per-slot vector."""
    from repro_torch.models.transformer import StackCache

    layers = [_empty_pool_like(c, num_blocks, block_size)
              if isinstance(c, AttnCache) else broadcast_slots(c, slots)
              for c in one.layers]
    return StackCache(layers, torch.zeros((slots,), dtype=torch.int32,
                                          device=one.pos.device))


def _scatter_ring(pool: PagedAttnCache, ring: AttnCache,
                  table_row: torch.Tensor) -> None:
    """Scatter a (B=1) ring cache's valid rows into the paged pools.

    Ring row ``j`` goes where its own ``key_pos[j]`` says: position ``p``
    lands at flat pool row ``table_row[p // bs] * bs + p % bs``.  Rows with
    ``key_pos == -1`` (the padded tail of a bucketed prefill) and rows whose
    logical block is unallocated are dropped, as the reference's
    ``mode="drop"`` scatter drops them (:func:`~repro_torch.models.attention
    .scatter_rows`, without a mask).
    """
    nb, bs = pool.k.shape[0], pool.k.shape[1]
    kp = ring.key_pos[0].to(torch.int64)  # (T,)
    tbl = table_row.to(device=kp.device, dtype=torch.int64)
    blk = tbl[torch.clamp(kp, 0, None).div(bs, rounding_mode="floor")
              .clamp_max(tbl.shape[0] - 1)]
    keep = (kp >= 0) & (blk >= 0)
    dest = blk * bs + kp % bs
    for p_arr, r_arr in zip(pool, ring[:2] + ring[3:]):
        if p_arr is None:
            continue
        scatter_rows(p_arr.view((nb * bs,) + tuple(p_arr.shape[2:])), dest,
                     keep, r_arr[0])


def merge_prefill_cache(batch, one, table_row, slot):
    """Merge one request's freshly prefilled (B=1) ring cache into the batch
    cache at ``slot``, in place; returns ``batch``.

    Paged layers scatter into the shared pools through ``table_row`` (the
    slot's (max_blocks,) block table row); ring and recurrent layers write
    row ``slot``.
    ``slot`` is an int or a one-element integer tensor on the cache's device
    (a captured admission step takes it so).
    """
    at = torch.as_tensor(slot, device=batch.pos.device).reshape(1).to(
        torch.int64)
    for b, o in zip(batch.layers, one.layers):
        if isinstance(b, PagedAttnCache):
            _scatter_ring(b, o, table_row)
        else:
            for bb, oo in zip(b, o):
                if bb is not None:
                    bb.index_copy_(0, at, oo.to(bb.dtype))
    batch.pos.index_copy_(0, at, one.pos.reshape(1).to(batch.pos.dtype))
    return batch
