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
declares for every leaf.

Preemption is the symmetric half: :meth:`SlotManager.snapshot_many`
gathers the victims' slot columns and brings them to the host in one
device-to-host copy (:class:`SlotSnapshot`), and :meth:`SlotManager.
restore` writes a snapshot back into any free slot.  Every write into
the cache (prefill insertion, restore) goes through
:func:`scatter_slots`, which copies into the cache's own tensors: the
engine's decode graph captured their addresses, so nothing here ever
rebinds ``cache`` or one of its leaves.  The round trip is bit-exact, so
under greedy decoding an evicted request resumes the tokens it would
have produced uninterrupted, in whichever slot it lands.

Storage is a seam: the dense manager owns the cache tree outright; the
paged one (:class:`repro_torch.serving.paged.PagedSlotManager`, built by
:func:`make_slot_manager` for a ``paged:<block>`` layout) keeps the KV
rings in a block pool and serves ``cache`` as a fixed dense view of it.
Both report the same fragmentation gauges (``slots.blocks_free``,
``slots.bytes_resident``, ``slots.padding_waste``) from byte factors
read off the model's cache specs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.lm import LM
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.plan.plan import parse_cache_layout


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
        a.index_copy_(ax, _index(a.device, slots),
                      s.to(device=a.device, dtype=a.dtype))
        return a
    return tree_map(put, cache, sub, axes)


def _paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) of every leaf, paths as ``blocks/p0/wkv_state``."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items()
                for pl in _paths(v, f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``bfloat16`` (numpy's name, as JAX prints)."""
    return str(dtype).replace("torch.", "")


@dataclasses.dataclass
class SlotSnapshot:
    """One slot's complete decode state, on the host.

    ``cache_col`` holds every cache leaf's slot column as a CPU tensor
    (slot axis kept, size 1); ``next_token`` is the slot's next decode
    input.  With the request's own host state (``output``,
    ``max_new_tokens``, ``eos_id``) this is all a resume needs."""

    cache_col: Any
    next_token: int

    def nbytes(self) -> int:
        return int(sum(t.numel() * t.element_size()
                       for t in tree_leaves(self.cache_col)))


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
        self._init_storage(model, max_batch, max_len, device)
        self._init_byte_accounting(model)
        # what a restorable snapshot holds: leaf path -> (shape with the
        # slot axis at 1, dtype), from the model's cache specs
        self._col_specs: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
        for (path, spec), (_, ax) in zip(
                _paths(model.cache_specs(max_batch, max_len)),
                _paths(self.axes)):
            shape = list(spec.shape)
            shape[ax] = 1
            self._col_specs[path] = (tuple(shape), spec.dtype)
        self.slots: List[Optional[object]] = [None] * max_batch
        # host mirrors of the per-slot control vectors
        self.next_token = np.zeros((max_batch,), np.int32)
        self.active = np.zeros((max_batch,), bool)
        self.eos = np.full((max_batch,), -1, np.int32)
        self.remaining = np.zeros((max_batch,), np.int32)
        self.metrics = registry if registry is not None else MetricsRegistry()
        self._snapshots = self.metrics.counter(
            "slots.snapshots", "slot columns gathered to host (evictions)")
        self._restores = self.metrics.counter(
            "slots.restores", "snapshots scattered back into slots")
        self._snapshot_bytes = self.metrics.counter(
            "slots.snapshot_bytes", "host bytes held by eviction snapshots")
        self._prefill_inserts = self.metrics.counter(
            "slots.prefill_inserts", "prefill rows scattered into slots")
        self.metrics.gauge("slots.active", "occupied decode slots",
                           fn=lambda: float(self.n_active()))
        self.metrics.gauge("slots.free", "free decode slots",
                           fn=lambda: float(self.max_batch - self.n_active()))
        # one vocabulary for both layouts; under dense the whole cache is
        # committed up front, so every byte not backing a live token is
        # padding
        self.metrics.gauge(
            "slots.blocks_free", "free cache-pool blocks (0 under dense)",
            fn=lambda: float(self.blocks_free()))
        self.metrics.gauge(
            "slots.bytes_resident", "cache bytes committed to slot state",
            fn=lambda: float(self.bytes_resident()))
        self.metrics.gauge(
            "slots.padding_waste",
            "committed cache bytes not backing live tokens",
            fn=lambda: float(self.padding_waste()))

    # ----------------------------------------------------------- storage
    def _init_storage(self, model: LM, max_batch: int, max_len: int,
                      device) -> None:
        """Allocate the backing store: under dense, the cache tree
        itself."""
        self.cache = model.init_cache(max_batch, max_len, device)
        self.axes = model.cache_batch_axes(self.cache)
        self.page_axes = model.cache_page_axes(self.cache)

    def ensure_chunk(self, budget: int) -> None:
        """Called by the engine before a decode chunk of up to ``budget``
        ticks reads and writes ``cache``.  Dense: nothing to do (every
        slot's whole column is committed)."""

    def repage(self) -> None:
        """Called by the engine right after a decode chunk wrote
        ``cache``, and by every other writer of ``cache``.  Dense: nothing
        to do (``cache`` is the store)."""

    def materialize(self) -> None:
        """Called before a reader of ``cache`` (the engine's guard scan,
        a fault's scribble).  Dense: nothing to do."""

    # --------------------------------------------------- byte accounting
    def _init_byte_accounting(self, model: LM) -> None:
        """Bytes a token of each ring length S (the pageable leaves,
        grouped by their ring axis's length), bytes of a slot's
        per-slot state, and the whole dense cache, from the cache
        specs.  Both layouts share them, so their gauges compare."""
        self._ring_token_bytes: Dict[int, int] = {}
        self._per_slot_bytes = 0
        self._dense_cache_bytes = 0
        for (_, spec), (_, ax) in zip(
                _paths(model.cache_specs(self.max_batch, self.max_len)),
                _paths(self.page_axes)):
            self._dense_cache_bytes += spec.nbytes
            if ax is None:
                self._per_slot_bytes += spec.nbytes // self.max_batch
            else:
                s = int(spec.shape[ax])
                self._ring_token_bytes[s] = (
                    self._ring_token_bytes.get(s, 0)
                    + spec.nbytes // (self.max_batch * s))

    def _slot_tokens(self, slot: int) -> int:
        """The host's estimate of a slot's sequence length (prompt +
        tokens so far), capped at ``max_len``: gauge precision."""
        req = self.slots[slot]
        if req is None:
            return 0
        return min(self.max_len, len(req.prompt) + len(req.output))

    def useful_bytes(self) -> int:
        """Bytes backing the live tokens and state of occupied slots."""
        total = 0
        for slot in self.occupied():
            toks = self._slot_tokens(slot)
            total += self._per_slot_bytes
            total += sum(min(s, toks) * tok_b
                         for s, tok_b in self._ring_token_bytes.items())
        return total

    def tokens_in_flight(self) -> int:
        return sum(self._slot_tokens(s) for s in self.occupied())

    def blocks_free(self) -> int:
        return 0

    def bytes_resident(self) -> int:
        return self._dense_cache_bytes

    def padding_waste(self) -> int:
        return self.bytes_resident() - self.useful_bytes()

    # ------------------------------------------------------------ occupancy
    def free(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def occupied(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is not None]

    def running(self) -> List[Tuple[int, object]]:
        return [(i, r) for i, r in enumerate(self.slots) if r is not None]

    def n_active(self) -> int:
        return sum(r is not None for r in self.slots)

    # ------------------------------------------------------------ grant/free
    def grant(self, slot: int, req, next_token: Optional[int]) -> None:
        """Mark a slot occupied by ``req`` whose next decode input is
        ``next_token`` (its prefill token).  ``next_token`` is None when
        that token is still on the device (overlapped admission): the
        budget then counts it as produced, and the decode chunk brings it
        home."""
        if self.slots[slot] is not None:
            raise ValueError(f"grant into occupied slot {slot}")
        self.slots[slot] = req
        self.active[slot] = True
        self.eos[slot] = -1 if req.eos_id is None else req.eos_id
        self.remaining[slot] = req.max_new_tokens - len(req.output) - (
            1 if next_token is None else 0)
        if next_token is not None:
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

    # --------------------------------------------------- preempt / resume
    def snapshot_compat_errors(self, snap: SlotSnapshot) -> List[str]:
        """Field-naming compatibility report for restoring ``snap`` into
        this manager, in the JAX package's words: empty means compatible;
        each entry names a cache leaf and how it diverges (missing, extra,
        slot-column shape, dtype), so a hand-off between engines whose
        arch, max_len or cache dtypes differ fails with a readable
        diagnosis, not a scatter error.  Leaves are named by the port's
        path form (``blocks/p0/wkv_state``, where JAX writes the pytree
        keystr ``['blocks']['p0']['wkv_state']``); dtypes by their numpy
        names."""
        got = {path: (tuple(t.shape), t.dtype)
               for path, t in _paths(snap.cache_col)}
        want = self._col_specs
        errs: List[str] = []
        for name in sorted(set(want) - set(got)):
            errs.append(f"{name}: required by this engine's cache spec but "
                        f"missing from the snapshot (different architecture?)")
        for name in sorted(set(got) - set(want)):
            errs.append(f"{name}: present in the snapshot but not in this "
                        f"engine's cache spec (different architecture?)")
        for name in sorted(set(want) & set(got)):
            (w_shape, w_dtype), (g_shape, g_dtype) = want[name], got[name]
            if g_shape != w_shape:
                errs.append(
                    f"{name}: slot-column shape {g_shape} != expected "
                    f"{w_shape} (origin engine's arch/max_len differs)")
            elif g_dtype != w_dtype:
                errs.append(f"{name}: dtype {_dtype_name(g_dtype)} != "
                            f"expected {_dtype_name(w_dtype)}")
        return errs

    def check_snapshot_compat(self, snap: SlotSnapshot) -> None:
        """Raise ``ValueError`` naming every incompatible cache leaf if
        ``snap`` cannot be restored into this manager.  The router calls
        this before every hand-off; :meth:`restore` calls it every time,
        so a bad snapshot never reaches the scatter."""
        errs = self.snapshot_compat_errors(snap)
        if errs:
            raise ValueError(
                "snapshot incompatible with this engine's cache spec "
                f"({len(errs)} field(s)):\n  - " + "\n  - ".join(errs))

    def column_template(self):
        """A zero slot column on the host, every leaf at its snapshot shape
        and dtype: the target a checkpoint's columns restore into."""
        return tree_map(lambda a, ax: torch.zeros(
            a.shape[:ax] + (1,) + a.shape[ax + 1:], dtype=a.dtype),
            self.cache, self.axes)

    def snapshot(self, slot: int) -> SlotSnapshot:
        return self.snapshot_many([slot])[0]

    def snapshot_many(self, slots: Sequence[int]) -> List[SlotSnapshot]:
        """The victims' slot columns on the host: one gather a leaf, the
        gathered leaves packed into one byte buffer on the device, and
        one device-to-host copy (one blocking read) for all of them, split
        on the host into one snapshot a slot.  Bit-exact.  An empty list
        reads nothing; a duplicate or an empty slot raises."""
        slots = list(slots)
        if not slots:
            return []
        if len(set(slots)) != len(slots):
            raise ValueError(f"duplicate slots in snapshot_many: {slots}")
        for s in slots:
            if self.slots[s] is None:
                raise ValueError(f"snapshot of unoccupied slot {s}")
        cols = gather_slots(self.cache, self.axes, slots)
        leaves = tree_leaves(cols)
        host = torch.cat([t.contiguous().view(-1).view(torch.uint8)
                          for t in leaves]).cpu()   # the one read
        parts = iter(part.clone().view(t.dtype).view(t.shape)
                     for part, t in zip(host.split(
                         [t.numel() * t.element_size() for t in leaves]),
                         leaves))
        tree = tree_map(lambda _: next(parts), cols)
        out = []
        for k, slot in enumerate(slots):
            col = tree_map(lambda a, ax, k=k: a.narrow(ax, k, 1).clone(),
                           tree, self.axes)
            snap = SlotSnapshot(cache_col=col,
                                next_token=int(self.next_token[slot]))
            self._snapshots.inc()
            self._snapshot_bytes.inc(snap.nbytes())
            out.append(snap)
        return out

    def restore(self, slot: int, snap: SlotSnapshot, req) -> None:
        """Write a snapshot into a free slot (not necessarily its old one)
        and re-arm the control mirrors: no model call, no draw from the
        sampler.  The cache's tensors are written in place
        (:func:`scatter_slots`), never replaced."""
        if self.slots[slot] is not None:
            raise ValueError(f"restore into occupied slot {slot}")
        self.check_snapshot_compat(snap)
        self._restores.inc()
        scatter_slots(self.cache, self.axes, [slot], snap.cache_col)
        self.slots[slot] = req
        self.active[slot] = True
        self.eos[slot] = -1 if req.eos_id is None else req.eos_id
        self.remaining[slot] = req.max_new_tokens - len(req.output)
        self.next_token[slot] = snap.next_token

    def scrub(self, slots: Sequence[int]) -> None:
        """Zero-wipe slot columns (fault quarantine), in place: no poisoned
        value survives for the guard scan or the slot's next tenant.  On
        the device only (no host read).  Under paging the wiped view is
        repaged, and the ``release`` that follows wipes the freed blocks
        to the empty pattern."""
        slots = list(slots)
        if not slots:
            return
        self.materialize()
        scatter_slots(self.cache, self.axes, slots,
                      tree_map(torch.zeros_like,
                               gather_slots(self.cache, self.axes, slots)))
        self.repage()

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


def make_slot_manager(model: LM, max_batch: int, max_len: int, *,
                      layout: str = "dense", device=None,
                      registry: Optional[MetricsRegistry] = None
                      ) -> SlotManager:
    """The slot manager of a ``ServingPlan.cache_layout``: ``"dense"`` ->
    :class:`SlotManager`, ``"paged:<block>"`` ->
    :class:`repro_torch.serving.paged.PagedSlotManager` (imported here:
    it imports this module)."""
    block = parse_cache_layout(layout)
    if block is None:
        return SlotManager(model, max_batch, max_len, device=device,
                           registry=registry)
    from repro_torch.serving.paged import PagedSlotManager

    return PagedSlotManager(model, max_batch, max_len, block_size=block,
                            device=device, registry=registry)


__all__ = ["gather_slots", "scatter_slots", "SlotSnapshot", "SlotManager",
           "make_slot_manager"]
