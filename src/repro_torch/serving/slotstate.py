"""Slot-state manager (port of ``repro.serving.slotstate``: the dense
layout's ``SlotManager`` and the gather/scatter pair).

The engine's serving state is a cache tree (layer-stacked rwkv
``wkv_state``/shift leaves or attention ``k``/``v``/``pos`` leaves, plus
``k_scale``/``v_scale`` for an int8 KV cache; per-slot ``lengths``) plus
host-side per-slot control vectors (next token, active mask, EOS id,
remaining budget).  Every leaf under ``blocks`` carries its slot on
axis 1, so the dense gathers and scatters move a KV cache's slot columns
the same way as rwkv state.
:class:`SlotManager` keeps both behind gathers and scatters keyed on the
batch-axis tree that :meth:`repro_torch.models.lm.LM.cache_batch_axes`
declares for every leaf.  Snapshot and restore (preemption) and the
paged layout (``serving/paged.py``) arrive with later slices.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models.lm import LM
from repro_torch.models.params import tree_map
from repro_torch.obs.registry import MetricsRegistry


def _index(device, slots: Sequence[int]) -> torch.Tensor:
    return torch.as_tensor(list(slots), dtype=torch.long, device=device)


def gather_slots(cache, axes, slots: Sequence[int]):
    """The given slot columns of every cache leaf, as new tensors with a
    slot axis of size ``len(slots)``."""
    return tree_map(lambda a, ax: a.index_select(ax, _index(a.device, slots)),
                    cache, axes)


def scatter_slots(cache, axes, slots: Sequence[int], sub):
    """Copy slot columns (one per entry of ``slots``) into the cache, in
    place; the inverse of :func:`gather_slots`.  Returns ``cache``."""
    def put(a, s, ax):
        a.index_copy_(ax, _index(a.device, slots), s.to(a.dtype))
        return a
    return tree_map(put, cache, sub, axes)


class SlotManager:
    """Owns the decode-slot state: the cache tree and its host mirrors.

    The engine asks it where things go (free/occupied slots) and moves
    state through it (prefill insertion, post-chunk refresh); it never
    touches the cache layout directly.  Policy stays in
    :mod:`repro_torch.serving.scheduler`."""

    def __init__(self, model: LM, max_batch: int, max_len: int, *,
                 device, registry: Optional[MetricsRegistry] = None):
        self.max_batch = max_batch
        self.max_len = max_len
        self.cache = model.init_cache(max_batch, max_len, device)
        self.axes = model.cache_batch_axes(self.cache)
        self.slots: List[Optional[object]] = [None] * max_batch
        # host mirrors of the per-slot control vectors
        self.next_token = np.zeros((max_batch,), np.int32)
        self.active = np.zeros((max_batch,), bool)
        self.eos = np.full((max_batch,), -1, np.int32)
        self.remaining = np.zeros((max_batch,), np.int32)
        self.metrics = registry if registry is not None else MetricsRegistry()
        self._prefill_inserts = self.metrics.counter(
            "slots.prefill_inserts", "prefill rows scattered into slots")
        self.metrics.gauge("slots.active", "occupied decode slots",
                           fn=lambda: float(self.n_active()))
        self.metrics.gauge("slots.free", "free decode slots",
                           fn=lambda: float(self.max_batch - self.n_active()))

    # ------------------------------------------------------------ occupancy
    def free(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def occupied(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is not None]

    def n_active(self) -> int:
        return sum(r is not None for r in self.slots)

    # ------------------------------------------------------------ grant/free
    def grant(self, slot: int, req, next_token: int) -> None:
        """Mark a slot occupied by ``req`` whose next decode input is
        ``next_token`` (its prefill token)."""
        if self.slots[slot] is not None:
            raise ValueError(f"grant into occupied slot {slot}")
        self.slots[slot] = req
        self.active[slot] = True
        self.eos[slot] = -1 if req.eos_id is None else req.eos_id
        self.remaining[slot] = req.max_new_tokens - len(req.output)
        self.next_token[slot] = next_token

    def release(self, slot: int) -> None:
        if self.slots[slot] is None:
            raise ValueError(f"release of already-free slot {slot}")
        self.slots[slot] = None
        self.active[slot] = False

    # ------------------------------------------------------- prefill insert
    def insert_from_prefill(self, slots: Sequence[int], rows: Sequence[int],
                            cacheN) -> None:
        """Copy prefill-cache rows into engine slots, one scatter per leaf
        for the whole admitted group.  The cache never aliases the
        prefill tensors."""
        self._prefill_inserts.inc(len(list(slots)))
        scatter_slots(self.cache, self.axes, slots,
                      gather_slots(cacheN, self.axes, rows))

    # ------------------------------------------------------ post-chunk sync
    def refresh_after_chunk(self, last_tokens: np.ndarray) -> None:
        """Re-derive the host mirrors from the slot table after a decode
        chunk's readback."""
        self.next_token = np.asarray(last_tokens, np.int32).copy()
        self.active = np.array([r is not None for r in self.slots])
        self.remaining = np.array(
            [r.max_new_tokens - len(r.output) if r is not None else 0
             for r in self.slots], np.int32)

    def stats(self) -> Dict[str, int]:
        return {"active": self.n_active(),
                "free": self.max_batch - self.n_active()}


__all__ = ["gather_slots", "scatter_slots", "SlotManager"]
