"""Paged slot state (port of ``repro.serving.paged``): a block pool
behind the :class:`~repro_torch.serving.slotstate.SlotManager` seam.

The dense manager commits ``max_batch x max_len`` cache columns up
front.  The paged one keeps the KV ring leaves (``k``/``v``/``pos`` and
the int8 scales, as :meth:`repro_torch.models.lm.LM.cache_page_axes`
names them) in a pool of fixed-size blocks with a block table per slot,
one pool a ring length; rwkv state and ``lengths`` stay one column a
slot.  Every signature, schedule and logit is the dense manager's:

* **A fixed dense view.**  ``cache`` is a dense tree at the dense
  shapes, allocated once: the tensors the engine's decode graph captured
  (:class:`repro_torch.serving.decode_graph.DecodeLoop`), so nothing here
  rebinds it.  The pool leaves ``(periods, capacity x block, ...)`` and a
  flat index a ring length (``max_batch x S``, every (slot, ring
  position) through the block table) are allocated once as well; a
  table change rewrites the index in place.
* **The pool is authoritative**, as in the JAX package, whose ``cache``
  property builds the view afresh at every read.  :meth:`materialize`
  gathers pool -> view in place; it runs before every reader of the view
  (the chunk, through :meth:`ensure_chunk`; :meth:`snapshot_many`; the
  engine's guard scan and fault scribble).  :meth:`repage` scatters
  view -> pool and then rewrites the null block with the empty pattern;
  it runs after every writer (the chunk, from the engine, before any
  release; :meth:`insert_from_prefill`; :meth:`restore`; ``scrub``; the
  scribble).  Ring positions a slot has no block for route to the
  null block (``pos = -1``, zero k/v), which attention masks, so the
  scatter's colliding writes there are harmless only because the null
  block is rewritten after them.
* **Freed blocks are wiped** to the empty pattern, so a recycled block
  never shows its previous owner's live positions.
* **Allocation is on the host and deterministic**: lowest free id first;
  a slot's pages are a prefix of its ring; :meth:`ensure_chunk` covers
  ``length + budget + 1`` tokens a slot before a chunk.  The pool holds
  every slot's worst case plus a null block a ring length, so allocation
  never fails; what paging saves is what :meth:`bytes_resident` reports,
  the bytes a planner can give to more slots.

The block-table gather is not fused into ``flash_decode``: the decode
kernel reads the dense view, as the JAX package's does.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models.lm import LM
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.serving.slotstate import SlotManager, SlotSnapshot, _paths

NULL_BLOCK = 0   # reserved block id a pool: the shared empty pattern


class BlockPool:
    """Host bookkeeping of one ring length: a block table a slot and a
    sorted free list over ``capacity`` block ids (id 0 is the null block,
    never allocated)."""

    def __init__(self, ring_len: int, block_size: int, max_batch: int):
        self.ring_len = ring_len
        self.block = min(block_size, ring_len)
        self.n_pages = -(-ring_len // self.block)        # ceil a slot
        self.capacity = 1 + max_batch * self.n_pages     # + null block
        self.table = np.zeros((max_batch, self.n_pages), np.int32)
        self.pages = np.zeros((max_batch,), np.int32)    # allocated prefix
        self.free_list: List[int] = list(range(1, self.capacity))

    def cover(self, slot: int, tokens: int) -> bool:
        """Extend ``slot``'s page prefix to cover ``tokens`` ring positions
        (capped at the ring).  Never shrinks; lowest free ids first.
        Returns True if the table changed."""
        need = -(-min(self.ring_len, max(0, tokens)) // self.block)
        have = int(self.pages[slot])
        if need <= have:
            return False
        for p in range(have, need):
            self.table[slot, p] = self.free_list.pop(0)
        self.pages[slot] = need
        return True

    def release(self, slot: int) -> List[int]:
        """Return ``slot``'s blocks to the free list; returns their ids, for
        the manager to wipe (free blocks always hold the empty pattern)."""
        n = int(self.pages[slot])
        if n == 0:
            return []
        freed = [int(b) for b in self.table[slot, :n]]
        self.free_list.extend(freed)
        self.free_list.sort()
        self.table[slot, :n] = NULL_BLOCK
        self.pages[slot] = 0
        return freed

    def flat_index(self) -> np.ndarray:
        """Pool position of every (slot, ring position) through the block
        table: ``(max_batch * ring_len,)`` into a pool leaf whose second
        axis is ``capacity * block`` long."""
        pos = np.arange(self.ring_len)
        off = pos % self.block
        page = pos // self.block
        return (self.table[:, page] * self.block + off[None, :]).reshape(-1)

    def check(self, occupied: Sequence[int]) -> None:
        """Raise AssertionError unless: no entry past a slot's page count,
        unoccupied slots own nothing, the null block is never allocated,
        no block is allocated twice or both free and allocated, the free
        list is sorted, and free + allocated = capacity - 1."""
        occ = set(occupied)
        allocated: List[int] = []
        for slot in range(self.table.shape[0]):
            n = int(self.pages[slot])
            row = self.table[slot]
            if not np.all(row[n:] == NULL_BLOCK):
                raise AssertionError(f"slot {slot}: table entries beyond "
                                     f"page count {n}: {row}")
            if slot not in occ and n:
                raise AssertionError(f"unoccupied slot {slot} owns {n} "
                                     f"blocks")
            allocated.extend(int(b) for b in row[:n])
        if NULL_BLOCK in allocated:
            raise AssertionError("null block was allocated")
        if len(set(allocated)) != len(allocated):
            raise AssertionError(f"block double-allocated: "
                                 f"{sorted(allocated)}")
        if self.free_list != sorted(set(self.free_list)):
            raise AssertionError(f"free list unsorted or duplicated: "
                                 f"{self.free_list}")
        if set(self.free_list) & set(allocated):
            raise AssertionError("block both free and allocated")
        if len(self.free_list) + len(allocated) != self.capacity - 1:
            raise AssertionError(
                f"block leak: {len(self.free_list)} free + "
                f"{len(allocated)} allocated != capacity-1 = "
                f"{self.capacity - 1}")


class _PagedLeaf:
    """One pageable leaf: its dense view flattened to ``(P, max_batch *
    S, ...)`` (a view of the ``cache`` leaf), its pool ``(P, capacity *
    block, ...)`` and one block of the empty pattern ``(P, block,
    ...)``."""

    def __init__(self, view: torch.Tensor, pool: BlockPool):
        P, B, S = view.shape[:3]
        tail = tuple(view.shape[3:])
        self.ring_len = S
        self.view = view.view((P, B * S) + tail)
        self.empty = view[:, 0, :pool.block].clone()
        self.pool = self.empty.repeat((1, pool.capacity) + (1,) * len(tail))


class PagedSlotManager(SlotManager):
    """A :class:`SlotManager` whose KV rings live in block pools.  Every
    public method keeps the dense manager's signature and meaning."""

    def __init__(self, model: LM, max_batch: int, max_len: int, *,
                 block_size: int, device,
                 registry: Optional[MetricsRegistry] = None):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.block_size = block_size
        super().__init__(model, max_batch, max_len, device=device,
                         registry=registry)

    # ----------------------------------------------------------- storage
    def _init_storage(self, model: LM, max_batch: int, max_len: int,
                      device) -> None:
        # the view: the dense manager's cache, which the decode graph
        # captures and nothing rebinds
        super()._init_storage(model, max_batch, max_len, device)
        device = self.cache["lengths"].device
        self._pools: Dict[int, BlockPool] = {}       # ring length -> pool
        self._leaves: List[_PagedLeaf] = []
        for (path, leaf), (_, bax), (_, pax) in zip(
                _paths(self.cache), _paths(self.axes),
                _paths(self.page_axes)):
            if pax is None:
                continue
            if bax != 1 or pax != 2 or leaf.dim() < 3:
                raise ValueError(
                    f"pageable leaf {path} must carry slots on axis 1 and "
                    f"its ring on axis 2, got batch axis {bax}, page axis "
                    f"{pax}, shape {tuple(leaf.shape)}")
            s = int(leaf.shape[2])
            if s not in self._pools:
                self._pools[s] = BlockPool(s, self.block_size, max_batch)
            self._leaves.append(_PagedLeaf(leaf, self._pools[s]))
        self._index = {s: torch.zeros((max_batch * s,), dtype=torch.long,
                                      device=device)
                       for s in self._pools}
        self._refresh_indices()

    def _refresh_indices(self) -> None:
        """Rewrite each flat index in place from its block table.  The
        copy is asynchronous from pageable memory: it returns once CUDA
        has staged the bytes and never waits for the device's queue.
        (Pinning would allocate page-locked memory whenever queued
        copies still hold the cached blocks, a slow call.)  Host to
        device copies of freed block ids in ``_wipe_blocks`` alike."""
        for s, pool in self._pools.items():
            self._index[s].copy_(torch.from_numpy(pool.flat_index()),
                                 non_blocking=True)

    def materialize(self) -> None:
        """Gather every pool leaf through its flat index into the view, in
        place: the dense view the JAX package's ``cache`` getter builds."""
        for pl in self._leaves:
            torch.index_select(pl.pool, 1, self._index[pl.ring_len],
                               out=pl.view)

    def repage(self) -> None:
        """Scatter the view into the pool, then rewrite the null block
        with the empty pattern: positions without a block of their own,
        and every column of a slot without blocks, land in it (colliding
        writes included)."""
        for pl in self._leaves:
            pl.pool.index_copy_(1, self._index[pl.ring_len], pl.view)
            pl.pool[:, :pl.empty.shape[1]].copy_(pl.empty)

    # -------------------------------------------------------- allocation
    def _cover(self, covers) -> None:
        """Extend coverage for each (slot, tokens) of ``covers``; the flat
        indices are rewritten once, if a table changed."""
        changed = False
        for slot, tokens in covers:
            for pool in self._pools.values():
                changed |= pool.cover(slot, tokens)
        if changed:
            self._refresh_indices()

    def ensure_chunk(self, budget: int) -> None:
        """Cover each occupied slot's ring writes of a chunk of up to
        ``budget`` ticks, then materialize the view the chunk reads.  The
        +1: an overlapped admission's first token is not in
        ``req.output`` yet, so the host's length can lag the device's by
        one."""
        self._cover([(slot, self._slot_tokens(slot) + int(budget) + 1)
                     for slot in self.occupied()])
        self.materialize()

    def insert_from_prefill(self, slots: Sequence[int], rows: Sequence[int],
                            cacheN) -> None:
        slots = list(slots)
        for slot in slots:
            if self.slots[slot] is None:
                raise ValueError(f"prefill insert into ungranted slot {slot}")
        self._cover([(slot, min(self.max_len, len(self.slots[slot].prompt)))
                     for slot in slots])
        super().insert_from_prefill(slots, rows, cacheN)
        self.repage()

    def snapshot_many(self, slots: Sequence[int]) -> List[SlotSnapshot]:
        slots = list(slots)
        if slots:
            self.materialize()
        return super().snapshot_many(slots)

    def restore(self, slot: int, snap: SlotSnapshot, req) -> None:
        # every check first: a refused snapshot must not touch the tables
        if self.slots[slot] is not None:
            raise ValueError(f"restore into occupied slot {slot}")
        self.check_snapshot_compat(snap)
        tokens = int(snap.cache_col["lengths"].reshape(-1)[0])
        self._cover([(slot, min(self.max_len, tokens))])
        super().restore(slot, snap, req)
        self.repage()

    def release(self, slot: int) -> None:
        super().release(slot)
        changed = False
        for s, pool in self._pools.items():
            freed = pool.release(slot)
            if freed:
                changed = True
                self._wipe_blocks(s, freed)
        if changed:
            self._refresh_indices()

    def _wipe_blocks(self, ring_len: int, block_ids: Sequence[int]) -> None:
        """Reset freed blocks of a pool to the empty pattern."""
        block = self._pools[ring_len].block
        pos = (np.asarray(block_ids, np.int64)[:, None] * block
               + np.arange(block)[None, :]).reshape(-1)
        leaves = [pl for pl in self._leaves if pl.ring_len == ring_len]
        idx = torch.from_numpy(pos).to(leaves[0].pool.device,
                                       non_blocking=True)
        for pl in leaves:
            tail = (1,) * (pl.empty.dim() - 2)
            pl.pool.index_copy_(1, idx, pl.empty.repeat(
                (1, len(block_ids)) + tail))

    # --------------------------------------------------------- integrity
    def check_invariants(self) -> None:
        """Every pool's block accounting (:meth:`BlockPool.check`)."""
        occ = self.occupied()
        for pool in self._pools.values():
            pool.check(occ)

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor the paged store holds (each pool leaf and flat
        index), for checks that they keep their addresses."""
        return [pl.pool for pl in self._leaves] + list(self._index.values())

    # ------------------------------------------------------------ gauges
    def blocks_free(self) -> int:
        return sum(len(p.free_list) for p in self._pools.values())

    def bytes_resident(self) -> int:
        """Bytes committed to live state: allocated blocks, one null block
        and the int32 block table a pool, and the per-slot columns of
        occupied slots."""
        total = self.n_active() * self._per_slot_bytes
        for s, pool in self._pools.items():
            tok_b = self._ring_token_bytes[s]
            total += (int(pool.pages.sum()) + 1) * pool.block * tok_b
            total += 4 * pool.table.size
        return total


def canonicalize_cache(cache):
    """``cache`` with every KV-ring entry whose ``pos`` is negative zeroed
    (``pos`` itself, ``lengths`` and per-slot leaves as they are), so a
    dense and a paged column, which differ only where attention masks,
    are bit-equal exactly when their live state is."""
    def canon(entry):
        if not (isinstance(entry, dict) and "pos" in entry):
            return dict(entry) if isinstance(entry, dict) else entry
        pos = entry["pos"]                               # (P, B, S)
        valid = pos >= 0
        out = {}
        for name, leaf in entry.items():
            if name == "pos" or tuple(leaf.shape[:3]) != tuple(pos.shape):
                out[name] = leaf
                continue
            mask = valid.reshape(tuple(valid.shape)
                                 + (1,) * (leaf.dim() - 3))
            out[name] = torch.where(mask, leaf, torch.zeros_like(leaf))
        return out

    return {"blocks": {k: canon(v) for k, v in cache["blocks"].items()},
            "lengths": cache["lengths"]}


def paged_cache_bytes(model: LM, max_batch: int, max_len: int,
                      block_size: int, tokens_per_slot: float) -> int:
    """What :meth:`PagedSlotManager.bytes_resident` reports with every
    slot occupied at ``tokens_per_slot`` tokens, from the cache specs
    alone (nothing allocated): the planner's model of paged bytes."""
    specs = model.cache_specs(max_batch, max_len)
    per_slot = 0
    ring_tok: Dict[int, int] = {}
    for (_, spec), (_, ax) in zip(_paths(specs),
                                  _paths(model.cache_page_axes(specs))):
        if ax is None:
            per_slot += spec.nbytes // max_batch
        else:
            s = int(spec.shape[ax])
            ring_tok[s] = ring_tok.get(s, 0) + spec.nbytes // (max_batch * s)
    total = max_batch * per_slot
    for s, tok_b in ring_tok.items():
        block = min(block_size, s)
        n_pages = math.ceil(min(s, tokens_per_slot) / block)
        total += max_batch * n_pages * block * tok_b
        total += block * tok_b                             # null block
        total += 4 * max_batch * math.ceil(s / block)      # int32 table
    return total


__all__ = ["PagedSlotManager", "BlockPool", "canonicalize_cache",
           "paged_cache_bytes", "NULL_BLOCK"]
