"""Multi-replica serving tier (port of ``repro.serving.router``): a router
over N plan-driven engines.

A :class:`Router` owns N replicas, each built ``from_plan`` with its own
design point (and, on CUDA, its own decode graph, captured when the
engine is built), and routes arriving requests across them behind a
routing-policy registry (:data:`ROUTER_POLICIES`, as scheduling policies
live behind ``scheduler.SCHEDULERS``).

Two placement modes, selected by ``FleetPlan.n_prefill``:

* **colocated** (``n_prefill=0``): every replica admits, prefills and
  decodes; the router only chooses where each request lands.
* **disaggregated** (``n_prefill=k``): the first ``k`` replicas run
  admission and prefill only.  After a replica's step, every slot holding
  a prefilled request is snapshotted (``SlotManager.snapshot_many``: one
  device-to-host read for the replica's whole sweep), released, and
  shipped to a decode replica as a :class:`TransitJob`.  The transit is
  charged a modeled latency per snapshot byte (``hw.dcn_bw`` against the
  modeled decode-tick time, :func:`repro_torch.plan.planner.
  modeled_tick_seconds`); an rwkv slot is an O(1) state column and
  rounds to the 1-tick floor.  On delivery the request is re-submitted
  to the decode replica carrying ``req.saved``; the engine's resume path
  restores it (``SlotManager.restore``, written through ``scatter_slots``
  into the cache's own tensors, which the decode graph holds) without a
  model call, so a decode replica never prefills.

The tier runs in one process on one shared virtual clock:
:func:`drive_fleet` grows :func:`~repro_torch.serving.workload.drive`'s
arrival-bounded loop with transit events, and for a fleet of one
colocated replica it reduces exactly to ``drive()`` (the same skips,
budgets and submission ticks), so that fleet is the bare engine:
schedule, outputs and metrics.  The schedule, the routing and the
transits are the JAX router's, branch for branch.

Tick domains: each engine's tick counter lags the clock while idle, as
under ``drive()``.  Colocated replicas never exchange stamps.  A
disaggregated fleet does (TTFT on the prefill replica, completion on the
decode replica), so ``step_all`` first aligns every engine's idle
counter to the shared clock (``ServingEngine.align_clock``).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple, Type

from repro_torch.models.lm import build_served
from repro_torch.plan.plan import FleetPlan
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.slotstate import SlotSnapshot
from repro_torch.serving.workload import VirtualClock, WorkloadItem

# ---------------------------------------------------------------------------
# routing policies
# ---------------------------------------------------------------------------


class RoutingPolicy:
    """Chooses which replica an event goes to.  ``choose`` gets the
    eligible engines (the admission set for fresh requests, the decode set
    for hand-offs; the router keeps one policy instance a role, so
    round-robin cursors do not interleave) and returns an index into that
    list.  Deterministic: the same calls give the same choices."""

    name = "?"

    def choose(self, engines: Sequence[ServingEngine]) -> int:
        raise NotImplementedError


class RoundRobin(RoutingPolicy):
    """Cycle through the eligible replicas in order."""

    name = "round_robin"

    def __init__(self):
        self._next = 0

    def choose(self, engines: Sequence[ServingEngine]) -> int:
        k = self._next % len(engines)
        self._next += 1
        return k


def _queue_depth(e: ServingEngine) -> int:
    return len(e.scheduler) + e.sm.n_active()


class LeastQueue(RoutingPolicy):
    """Join the shortest queue (pending + in-slot requests), ties to the
    lowest replica index."""

    name = "least_queue"

    def choose(self, engines: Sequence[ServingEngine]) -> int:
        return min(range(len(engines)),
                   key=lambda k: (_queue_depth(engines[k]), k))


class SLOFeedback(RoutingPolicy):
    """Prefer the replica with the lowest rolling p95 TTFT of its
    ``LiveMetrics`` window (``Router.from_plan`` turns the windows on for
    this policy).  A replica with no completed request in its window, or
    a NaN p95, scores 0; ties fall to the queue depth, then to the
    lowest index."""

    name = "slo_feedback"

    def choose(self, engines: Sequence[ServingEngine]) -> int:
        def score(k: int):
            e = engines[k]
            ttft = 0.0
            if e.live is not None:
                s = e.live.snapshot()
                v = s["ttft_p95"]
                if s["completed"] and not math.isnan(v):
                    ttft = float(v)
            return (ttft, _queue_depth(e), k)

        return min(range(len(engines)), key=score)


ROUTER_POLICIES: Dict[str, Type[RoutingPolicy]] = {
    p.name: p for p in (RoundRobin, LeastQueue, SLOFeedback)}
ROUTING_POLICIES = tuple(ROUTER_POLICIES)   # CLI choices, registry order


def make_routing_policy(name: str,
                        registry: Optional[Dict[str, Type[RoutingPolicy]]]
                        = None) -> RoutingPolicy:
    registry = ROUTER_POLICIES if registry is None else registry
    if name not in registry:
        raise ValueError(f"unknown routing policy {name!r} "
                         f"(known: {sorted(registry)})")
    return registry[name]()


# ---------------------------------------------------------------------------
# transit
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TransitJob:
    """One prefill -> decode hand-off in flight: the request, its slot
    snapshot (on the host), and when the modeled transfer completes
    (absolute clock units)."""

    req: Request
    snap: SlotSnapshot
    src: int         # prefill replica index
    dst: int         # decode replica index
    due: float       # clock time the snapshot finishes arriving
    nbytes: int
    ticks: int       # charged transit latency in clock ticks


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------


class Router:
    """Load balancer and transit broker over a fleet of serving engines.

    Owns the replica engines, the routing-policy instances (one for
    admission, one for disaggregated dispatch) and the in-flight
    :class:`TransitJob` queue; driven by :func:`drive_fleet`.  Every
    submitted request is in exactly one place: a replica's queue, slot
    or finished list, or one transit job (:meth:`conservation_census`)."""

    def __init__(self, fleet: FleetPlan, engines: Sequence[ServingEngine]):
        if not isinstance(fleet, FleetPlan):
            raise TypeError(f"Router needs a FleetPlan, "
                            f"got {type(fleet).__name__}")
        fleet.validate()
        if len(engines) != len(fleet.replicas):
            raise ValueError(f"fleet names {len(fleet.replicas)} replicas "
                             f"but {len(engines)} engines were supplied")
        self.fleet = fleet
        self.engines: List[ServingEngine] = list(engines)
        self.policy = make_routing_policy(fleet.routing)
        self._dispatch = make_routing_policy(fleet.routing)
        self.requests: List[Request] = []        # arrival order
        self.assigned: List[List[Request]] = [[] for _ in self.engines]
        self.transits: List[TransitJob] = []     # sorted by due
        self.n_handoffs = 0
        self.n_delivered = 0
        self.transit_bytes_total = 0
        self.transit_ticks_total = 0
        self._bytes_per_tick: Optional[float] = None

    # ------------------------------------------------------------ construction
    @classmethod
    def from_plan(cls, fleet: FleetPlan, *, seed: int = 0,
                  tracers: Optional[Sequence] = None, device=None,
                  _built=None) -> "Router":
        """Build the fleet from its plan, one engine after another (on
        CUDA each captures its decode graph as it is built).  Replica
        ``i`` gets engine seed ``seed + i``, so a one-replica fleet seeds
        as a bare engine.  One model and one parameter tree serve every
        replica of the same ``(arch, reduced)``:
        :func:`repro_torch.models.lm.build_served` on ``device`` (default:
        the current CUDA device; without one this raises), as
        ``launch/serve.py`` builds them.  ``_built`` (a
        ``{(arch, reduced): (model, params)}`` dict) supplies or collects
        those builds, which must lie on ``device``.  ``tracers``: one
        :class:`repro_torch.obs.Tracer` a replica (merge them with
        ``obs.trace.merge_traces``)."""
        from repro_torch.kernels.dispatch import resolve_device

        fleet.validate()
        if tracers is not None and len(tracers) != len(fleet.replicas):
            raise ValueError(f"need one tracer per replica: got "
                             f"{len(tracers)} for {len(fleet.replicas)}")
        dev = resolve_device(device)
        built = _built if _built is not None else {}
        engines = []
        for i, plan in enumerate(fleet.replicas):
            key = (plan.arch, plan.reduced)
            if key not in built:
                built[key] = build_served(plan.arch, plan.reduced, dev)
            model, params = built[key]
            on = params["embedding"].device
            if on.type != dev.type or dev.index not in (None, on.index):
                raise ValueError(f"the parameters of {key} lie on {on}, "
                                 f"the fleet serves on {dev}")
            eng = ServingEngine.from_plan(
                plan, params, model=model, seed=seed + i,
                tracer=None if tracers is None else tracers[i])
            if fleet.routing == "slo_feedback":
                eng.enable_live_metrics()
            engines.append(eng)
        return cls(fleet, engines)

    # ------------------------------------------------------------ replica sets
    @property
    def n_prefill(self) -> int:
        return self.fleet.n_prefill

    def admit_set(self) -> List[int]:
        """Replica indices eligible for fresh submissions: the prefill
        replicas when disaggregated, every replica when colocated."""
        if self.n_prefill:
            return list(range(self.n_prefill))
        return list(range(len(self.engines)))

    def decode_set(self) -> List[int]:
        return list(range(self.n_prefill, len(self.engines)))

    def _route(self, policy: RoutingPolicy, idxs: Sequence[int]) -> int:
        cands = [self.engines[i] for i in idxs]
        return idxs[policy.choose(cands)]

    # -------------------------------------------------------------- admission
    def submit(self, item: WorkloadItem) -> Request:
        """Route one arrival to a replica and submit it there, with
        ``drive()``'s argument mapping."""
        idx = self._route(self.policy, self.admit_set())
        req = self.engines[idx].submit(
            list(item.prompt), item.max_new_tokens, item.eos_id,
            deadline=item.deadline)
        self.requests.append(req)
        self.assigned[idx].append(req)
        return req

    # ---------------------------------------------------------------- driving
    def engines_have_work(self) -> bool:
        return any(e.has_work() for e in self.engines)

    def has_work(self) -> bool:
        return self.engines_have_work() or bool(self.transits)

    @property
    def ticks(self) -> int:
        return max(e.ticks for e in self.engines)

    def step_all(self, budget: Optional[int], now: Optional[float] = None
                 ) -> int:
        """One fleet round: step every replica with the tick budget
        (prefill replicas at most 1 tick: they admit, not decode) and
        return the widest tick advance, which is how far the shared clock
        moves.  A disaggregated fleet first aligns the engines' idle
        counters to the clock."""
        if self.n_prefill and now is not None:
            for e in self.engines:
                e.align_clock(int(now))
        delta = 0
        for i, e in enumerate(self.engines):
            cap = 1 if i < self.n_prefill else budget
            before = e.ticks
            e.step(max_ticks=cap)
            delta = max(delta, e.ticks - before)
        return delta

    # ----------------------------------------------------------- transit side
    @property
    def bytes_per_tick(self) -> float:
        """Modeled transit bytes a clock tick: ``hw.dcn_bw`` x
        ``modeled_tick_seconds`` of the fleet's first replica, unless the
        plan pins ``transit_bytes_per_tick``.  ``dcn_bw <= 0`` gives
        ``inf``: every transit then takes the 1-tick floor."""
        if self._bytes_per_tick is None:
            if self.fleet.transit_bytes_per_tick is not None:
                self._bytes_per_tick = float(
                    self.fleet.transit_bytes_per_tick)
            else:
                from repro_torch import hw
                from repro_torch.plan.planner import modeled_tick_seconds

                spec = hw.get_spec(self.fleet.hw)
                ref = self.fleet.replicas[0]
                if spec.dcn_bw > 0:
                    self._bytes_per_tick = spec.dcn_bw * \
                        modeled_tick_seconds(ref.arch, ref.max_batch, spec)
                else:
                    self._bytes_per_tick = math.inf
        return self._bytes_per_tick

    def transit_ticks(self, nbytes: int) -> int:
        """Clock ticks charged to ship one snapshot: the ceiling over the
        modeled bytes a tick, at least one tick."""
        bpt = self.bytes_per_tick
        if not math.isfinite(bpt) or bpt <= 0:
            return 1
        return max(1, int(math.ceil(nbytes / bpt)))

    def collect_handoffs(self, now: float) -> int:
        """Sweep the prefill replicas: every occupied slot whose request
        already has its first token on the host is snapshotted (one read a
        replica), released, and put in transit to a policy-chosen decode
        replica.  A slot whose overlapped first token is still on the
        device waits for the next sweep; a request that finished inside
        the prefill step never transits.  Compatibility is checked against
        the destination before the job is queued."""
        if not self.n_prefill:
            return 0
        moved = 0
        for src in range(self.n_prefill):
            eng = self.engines[src]
            ready = [(slot, req) for slot, req in eng.sm.running()
                     if len(req.output) >= 1]
            if not ready:
                continue
            snaps = eng.sm.snapshot_many([slot for slot, _ in ready])
            for (slot, req), snap in zip(ready, snaps):
                eng.sm.release(slot)
                dst = self._route(self._dispatch, self.decode_set())
                self.engines[dst].sm.check_snapshot_compat(snap)
                nbytes = snap.nbytes()
                ticks = self.transit_ticks(nbytes)
                self.transits.append(TransitJob(
                    req=req, snap=snap, src=src, dst=dst,
                    due=now + ticks, nbytes=nbytes, ticks=ticks))
                self.n_handoffs += 1
                self.transit_bytes_total += nbytes
                self.transit_ticks_total += ticks
                moved += 1
        if moved:
            self.transits.sort(key=lambda t: t.due)   # stable: FIFO on ties
        return moved

    def next_transit_due(self) -> float:
        return self.transits[0].due

    def deliver_due(self, now: float) -> int:
        """Deliver every transit whose modeled transfer has completed:
        re-check compatibility, attach the snapshot as ``req.saved`` and
        submit to the decode replica's scheduler (its resume path restores
        the slot: no model call)."""
        n = 0
        while self.transits and self.transits[0].due <= now + 1e-9:
            job = self.transits.pop(0)
            dst = self.engines[job.dst]
            dst.sm.check_snapshot_compat(job.snap)
            job.req.saved = job.snap
            dst.scheduler.submit(job.req)
            self.n_delivered += 1
            n += 1
        return n

    # -------------------------------------------------------------- reporting
    def parts(self) -> List[Tuple[List[Request], int, List[float]]]:
        """Per-replica ``(requests, ticks, util_history)`` for
        :func:`repro_torch.serving.metrics.aggregate_fleet`: a request
        counts on the replica that admitted it."""
        return [(list(self.assigned[i]), e.ticks, list(e.util_history))
                for i, e in enumerate(self.engines)]

    def fleet_aggregate(self, *, tick_seconds: float = 1.0
                        ) -> Dict[str, object]:
        from repro_torch.serving.metrics import aggregate_fleet

        return aggregate_fleet(self.parts(), tick_seconds=tick_seconds)

    def transit_stats(self) -> Dict[str, object]:
        bpt = self.bytes_per_tick if self.n_handoffs else None
        return {
            "handoffs": int(self.n_handoffs),
            "delivered": int(self.n_delivered),
            "in_flight": len(self.transits),
            "bytes": int(self.transit_bytes_total),
            "ticks": int(self.transit_ticks_total),
            "bytes_per_tick": (float(bpt) if bpt is not None
                               and math.isfinite(bpt) else None),
        }

    def conservation_census(self) -> Dict[str, int]:
        """Where every submitted request lives now; ``total`` must equal
        the arrivals submitted, with no request counted twice."""
        queued = sum(len(e.scheduler) for e in self.engines)
        in_slot = sum(e.sm.n_active() for e in self.engines)
        finished = sum(len(e.finished) for e in self.engines)
        shed = sum(1 for r in self.requests if r.shed)
        return {"queued": queued, "in_slot": in_slot,
                "in_transit": len(self.transits), "finished": finished,
                "shed": shed,
                "total": queued + in_slot + len(self.transits)
                + finished + shed}


# ---------------------------------------------------------------------------
# the fleet drive loop
# ---------------------------------------------------------------------------


def drive_fleet(router: Router, items: Sequence[WorkloadItem],
                clock=None, max_ticks: int = 1_000_000,
                sync_every: Optional[int] = None,
                on_tick=None) -> List[Request]:
    """Replay a workload against a fleet on one shared clock: ``drive()``
    grown with transit events.  Idle skips jump to the next arrival or
    transit completion, whichever comes first; a round's tick budget
    never steps the fleet past either; the clock advances by the widest
    replica's tick delta each round.  For a one-replica colocated fleet
    every branch is ``drive()``'s.

    Returns the submitted :class:`Request` objects in arrival order (all
    done or shed once the fleet drains)."""
    if clock is None:
        clock = VirtualClock()
    pending = sorted(items, key=lambda it: it.t)
    i = 0
    busy = 0.0
    for _ in range(max_ticks):
        if not router.engines_have_work():
            horizons = []
            if i < len(pending):
                horizons.append(pending[i].t)
            if router.transits:
                horizons.append(router.next_transit_due())
            if horizons:
                clock.skip_to(min(horizons))   # idle: jump to next event
        router.deliver_due(clock.now)
        while i < len(pending) and pending[i].t <= clock.now:
            router.submit(pending[i])
            i += 1
        if not router.has_work() and i >= len(pending):
            clock.busy_seconds = busy
            return list(router.requests)
        budget = sync_every
        if isinstance(clock, VirtualClock):
            # never step past the next arrival or transit completion
            horizons = []
            if i < len(pending):
                horizons.append(pending[i].t)
            if router.transits:
                horizons.append(router.next_transit_due())
            if horizons:
                gap = min(horizons) - clock.now
                due = max(1, math.ceil(gap / clock.tick_cost)) \
                    if gap > 0 else 1
                budget = due if budget is None else min(budget, due)
        t0 = time.perf_counter()
        delta = router.step_all(budget, now=clock.now)
        busy += time.perf_counter() - t0
        for _ in range(delta):
            clock.tick()
        router.collect_handoffs(clock.now)
        if on_tick is not None and delta:
            on_tick(router.ticks)
    raise RuntimeError(f"fleet workload did not drain within {max_ticks} "
                       f"rounds ({i}/{len(pending)} submitted, "
                       f"{len(router.transits)} transits in flight)")


__all__ = ["ROUTER_POLICIES", "ROUTING_POLICIES", "RoutingPolicy",
           "RoundRobin", "LeastQueue", "SLOFeedback",
           "make_routing_policy", "Router", "TransitJob", "drive_fleet"]
