"""Request schedulers (port of ``repro.serving.scheduler``, the whole
file): all admission and preemption policy in one place.

The :class:`~repro_torch.serving.engine.ServingEngine` keeps mechanism
(prefill, the decode ticks, slot state) and asks a :class:`Scheduler`
which queued requests to admit (:meth:`Scheduler.pick`) and, for a
preemptive policy, which running requests to evict
(:meth:`Scheduler.victims`).

Policies
--------
``fcfs``
    First-come-first-served: admit in arrival order.
``spf``
    Shortest-prompt-first (FIFO among equal lengths).
``edf``
    Earliest-deadline-first over the optional per-request ``deadline``;
    requests without one sort last, FIFO among themselves.  With
    ``preempt=True`` it names victims when a strictly earlier deadline
    waits, and the engine evicts them to the host
    (:meth:`~repro_torch.serving.engine.ServingEngine.preempt_many`).

The queue lives in the scheduler; all state is host-side and
deterministic, so a policy is a pure function of the submission and
completion sequence, and the port picks in the same order as the JAX
package.  Counters live in a
:class:`repro_torch.obs.registry.MetricsRegistry` (``scheduler.submitted``,
``scheduler.picked``, ``scheduler.requeued``, the ``scheduler.queue_depth``
gauge and the ``scheduler.peak_queued`` high-water mark), surfaced by
:meth:`Scheduler.stats`.
"""

from __future__ import annotations

import math
from collections import deque
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple, Type

from repro_torch.obs.registry import MetricsRegistry

if TYPE_CHECKING:  # pragma: no cover - import cycle (engine imports us)
    from repro_torch.serving.engine import Request


def _deadline(req: "Request") -> float:
    """EDF sort key: an absent deadline is infinitely late."""
    return math.inf if req.deadline is None else float(req.deadline)


class Scheduler:
    """Base policy: owns the pending queue, decides admission order.

    Subclasses override :meth:`pick` (and :meth:`victims` if preemptive).
    ``pick(n)`` must *remove* the returned requests from the queue; a
    request that could not be admitted after all (no capacity left in the
    same engine tick) is handed back via :meth:`requeue_front`.
    """

    name: str = "base"
    preemptive: bool = False

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        self.queue: deque = deque()
        self.metrics = registry if registry is not None else MetricsRegistry()
        self._submitted = self.metrics.counter(
            "scheduler.submitted", "requests enqueued")
        self._picked = self.metrics.counter(
            "scheduler.picked", "requests handed to the engine for admission")
        self._requeued = self.metrics.counter(
            "scheduler.requeued", "requests handed back (no capacity / "
            "preemption victims)")
        self._peak = self.metrics.gauge(
            "scheduler.peak_queued", "high-water mark of the pending queue")
        self.metrics.gauge("scheduler.queue_depth",
                           "current pending-queue length",
                           fn=lambda: float(len(self.queue)))

    # ------------------------------------------------------------- queue ops
    def submit(self, req: "Request") -> None:
        """Enqueue a new request."""
        self.queue.append(req)
        self._submitted.inc()
        self._peak.set(max(self._peak.value, float(len(self.queue))))

    def requeue_front(self, req: "Request") -> None:
        """Hand back a request the engine could not place this tick (or a
        just-evicted victim): it keeps its original submission order
        (``uid``, assigned monotonically at submit) and goes to the queue
        front so FIFO-style policies retry it first."""
        self.queue.appendleft(req)
        self._requeued.inc()
        self._peak.set(max(self._peak.value, float(len(self.queue))))

    def __len__(self) -> int:
        return len(self.queue)

    def stats(self) -> Dict[str, float]:
        """Counter snapshot under stable keys (a registry view)."""
        return self.metrics.view({
            "submitted": "scheduler.submitted",
            "picked": "scheduler.picked",
            "requeued": "scheduler.requeued",
            "queue_depth": "scheduler.queue_depth",
            "peak_queued": "scheduler.peak_queued",
        })

    # --------------------------------------------------------------- policy
    def pick(self, n: int) -> List["Request"]:
        """Remove and return up to ``n`` requests to admit, in order.

        Wraps the subclass :meth:`_select` with counter bookkeeping, so
        every policy counts picks identically."""
        picked = self._select(n)
        self._picked.inc(len(picked))
        return picked

    def _select(self, n: int) -> List["Request"]:
        """Policy hook: remove and return up to ``n`` requests."""
        raise NotImplementedError

    def victims(self, running: Sequence[Tuple[int, "Request"]],
                n_free: int) -> List[int]:
        """Slots to evict so more urgent queued requests can run.

        ``running`` is ``[(slot, request), ...]``; ``n_free`` is how many
        slots are already free.  Non-preemptive policies never evict."""
        return []

    def _pop_indices(self, order: Sequence[int]) -> List["Request"]:
        picked = [self.queue[j] for j in order]
        for j in sorted(order, reverse=True):
            del self.queue[j]
        return picked


class FCFS(Scheduler):
    """First-come-first-served (arrival order)."""

    name = "fcfs"

    def _select(self, n: int) -> List["Request"]:
        n = min(n, len(self.queue))
        return [self.queue.popleft() for _ in range(n)]


class SPF(Scheduler):
    """Shortest-prompt-first (FIFO among equal prompt lengths)."""

    name = "spf"

    def _select(self, n: int) -> List["Request"]:
        n = min(n, len(self.queue))
        order = sorted(range(len(self.queue)),
                       key=lambda j: (len(self.queue[j].prompt), j))[:n]
        return self._pop_indices(order)


class EDF(Scheduler):
    """Earliest-deadline-first; optionally preemptive.

    Admission: queued requests sorted by (deadline, submission order) —
    deadline-less requests run last, FIFO among themselves.  Preemption
    (``preempt=True``): pairs the most urgent waiters against the
    latest-deadline runners and evicts a runner only when the waiter's
    deadline is *strictly* earlier — equal deadlines never thrash, and a
    deadline-less waiter never preempts anything.
    """

    name = "edf"

    def __init__(self, preempt: bool = False,
                 registry: Optional[MetricsRegistry] = None) -> None:
        super().__init__(registry)
        self.preemptive = bool(preempt)

    def _key(self, req: "Request") -> Tuple[float, int]:
        # uid is assigned monotonically at engine.submit, so it IS the
        # submission order — an evicted request keeps its original rank
        return (_deadline(req), req.uid)

    def _select(self, n: int) -> List["Request"]:
        n = min(n, len(self.queue))
        order = sorted(range(len(self.queue)),
                       key=lambda j: self._key(self.queue[j]))[:n]
        return self._pop_indices(order)

    def victims(self, running: Sequence[Tuple[int, "Request"]],
                n_free: int) -> List[int]:
        if not self.preemptive or not self.queue:
            return []
        waiting = sorted(self.queue, key=self._key)
        runners = sorted(running, key=lambda sr: self._key(sr[1]),
                         reverse=True)          # latest deadline first
        out: List[int] = []
        for w in waiting:
            if n_free > 0:        # a slot is free anyway: no eviction needed
                n_free -= 1
                continue
            if not runners:
                break
            slot, victim = runners[0]
            if _deadline(w) < _deadline(victim):
                out.append(slot)
                runners.pop(0)
            else:                 # waiters only get less urgent from here
                break
        return out


SCHEDULERS: Dict[str, Type[Scheduler]] = {
    FCFS.name: FCFS,
    SPF.name: SPF,
    EDF.name: EDF,
}

POLICIES: Tuple[str, ...] = tuple(SCHEDULERS)


def make_scheduler(policy: str, *, preempt: bool = False,
                   registry: Optional[MetricsRegistry] = None) -> Scheduler:
    """Instantiate a registered policy.  ``preempt`` is only meaningful
    for preemption-capable policies (EDF); requesting it elsewhere is an
    error rather than a silent no-op.  ``registry`` shares the caller's
    :class:`~repro_torch.obs.registry.MetricsRegistry` (the engine passes its
    own, so one ``reset()`` covers scheduler counters too)."""
    cls = SCHEDULERS.get(policy)
    if cls is None:
        raise ValueError(f"unknown policy {policy!r}; known: {POLICIES}")
    if cls is EDF:
        return EDF(preempt=preempt, registry=registry)
    if preempt:
        raise ValueError(f"policy {policy!r} is non-preemptive; "
                         f"preempt=True requires one of: "
                         f"{[n for n, c in SCHEDULERS.items() if c is EDF]}")
    return cls(registry)
