"""Deterministic fault injection and the crash-restartable serving driver
(port of ``repro.serving.faults``: the same fault plans, JSON both ways,
the same storms for the same arguments, the same recovery schedule).

Every fault is scheduled on the virtual clock, so a run under a
:class:`FaultPlan` is reproducible: the same plan against the same
seeded workload gives the same faults, recoveries and final schedule.

* :class:`FaultSpec` / :class:`FaultPlan`: which faults fire when, on the
  JAX package's ``fault_plan/v1`` schema: poison a slot's cache column
  (NaN or garbage), drop a decode chunk's readback, fail a prefill call,
  stall a slot (the watchdog's trigger), kill the engine at a tick.
* :class:`FaultInjector`: the one-shot ledger.  Each spec fires at the
  first host intervention at or after its tick and never again; the
  ledger outlives engine restarts (the driver attaches the same injector
  to the restored engine), so a kill cannot kill its successor.
* :func:`drive_resilient`: :func:`repro_torch.serving.workload.drive`
  with a checkpoint cadence and a restart loop.  It journals the engine
  through :class:`repro_torch.checkpoint.CheckpointManager` every
  ``checkpoint_every`` ticks, catches :class:`EngineKilled`, releases the
  dead engine's decode graph and cache, builds a new engine with
  :meth:`ServingEngine.restore` (on CUDA with its own graph), rewinds the
  clock to the checkpoint and re-submits the arrivals it had not seen.
  The restarted run's schedule is an uninterrupted run's.

The recovery half (the guard scan, quarantine, rollback and shedding,
the watchdog, ``checkpoint()`` and ``restore()``) lives in
:class:`repro_torch.serving.engine.ServingEngine`; this module decides
when to hurt it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.serving.engine import EngineKilled, Request, \
    ServingEngine
from repro_torch.serving.workload import VirtualClock, WorkloadItem

FAULT_SCHEMA = "fault_plan/v1"

# every fault class the injector can schedule; the engine's recovery
# layer (engine._apply_due_faults and friends) must handle each one
FAULT_KINDS = (
    "poison_slot",     # scribble NaN/garbage into a slot's cache column
    "drop_readback",   # lose one decode chunk's device->host readback
    "fail_prefill",    # fail the next prefill call (requests retry)
    "stall_slot",      # wedge a slot: no progress until the watchdog fires
    "kill_engine",     # raise EngineKilled out of step() — crash-restart
)
POISON_MODES = ("nan", "garbage")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.

    ``tick`` is the virtual-clock engine tick the fault becomes *due*; it
    fires at the first host intervention at or after that tick (slot
    faults wait, still one-shot, until the target can be hit: a poison
    or stall aimed at a free slot stays armed until any slot is
    occupied).  ``slot`` picks the victim for ``poison_slot`` /
    ``stall_slot`` — when that slot is free, the lowest occupied slot is
    hit instead, so the fault lands deterministically on real work.
    ``mode`` selects the poison pattern (``nan`` or ``garbage``: a
    seeded scribble of huge values and ±Inf — both trip the engine's
    finiteness guard; *finite* silent corruption is out of scope, the
    guard is a poison detector, not an ECC).  ``seed`` seeds the
    garbage pattern only."""

    kind: str
    tick: int
    slot: int = 0
    mode: str = "nan"
    seed: int = 0

    def validate(self) -> "FaultSpec":
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"known: {FAULT_KINDS}")
        if self.tick < 0:
            raise ValueError(f"fault tick must be >= 0, got {self.tick}")
        if self.slot < 0:
            raise ValueError(f"fault slot must be >= 0, got {self.slot}")
        if self.mode not in POISON_MODES:
            raise ValueError(f"unknown poison mode {self.mode!r}; "
                             f"known: {POISON_MODES}")
        return self

    def to_json(self) -> Dict[str, object]:
        return {"kind": self.kind, "tick": int(self.tick),
                "slot": int(self.slot), "mode": self.mode,
                "seed": int(self.seed)}

    @staticmethod
    def from_json(d: Mapping[str, object]) -> "FaultSpec":
        known = {"kind", "tick", "slot", "mode", "seed"}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown FaultSpec fields {sorted(unknown)}; "
                             f"known: {sorted(known)}")
        if "kind" not in d or "tick" not in d:
            raise ValueError(f"FaultSpec needs at least 'kind' and 'tick', "
                             f"got {sorted(d)}")
        return FaultSpec(kind=str(d["kind"]), tick=int(d["tick"]),
                         slot=int(d.get("slot", 0)),
                         mode=str(d.get("mode", "nan")),
                         seed=int(d.get("seed", 0))).validate()


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A whole chaos scenario: the ordered fault schedule, JSON-round-
    trippable like :class:`repro_torch.plan.ServingPlan` (schema tag,
    ``from_dict(to_dict(p)) == p``), so a recorded storm can be
    replayed."""

    faults: Tuple[FaultSpec, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(self.faults))

    def validate(self) -> "FaultPlan":
        for f in self.faults:
            f.validate()
        return self

    @property
    def kinds(self) -> Tuple[str, ...]:
        return tuple(sorted({f.kind for f in self.faults}))

    def needs_watchdog(self) -> bool:
        """Stall faults only recover when the engine's watchdog evicts
        the wedged slot — serving one without a watchdog would hang."""
        return any(f.kind == "stall_slot" for f in self.faults)

    def needs_checkpoints(self) -> bool:
        """Kill faults only recover through a checkpoint restore."""
        return any(f.kind == "kill_engine" for f in self.faults)

    def to_dict(self) -> Dict[str, object]:
        return {"schema": FAULT_SCHEMA,
                "faults": [f.to_json() for f in self.faults]}

    @staticmethod
    def from_dict(d: Mapping[str, object]) -> "FaultPlan":
        d = dict(d)
        schema = d.pop("schema", FAULT_SCHEMA)
        if schema != FAULT_SCHEMA:
            raise ValueError(f"unsupported fault-plan schema {schema!r}; "
                             f"this build reads {FAULT_SCHEMA!r}")
        unknown = set(d) - {"faults"}
        if unknown:
            raise ValueError(f"unknown FaultPlan fields {sorted(unknown)}")
        return FaultPlan(tuple(FaultSpec.from_json(f)
                               for f in d.get("faults", ()))).validate()

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)
            f.write("\n")

    @staticmethod
    def load(path: str) -> "FaultPlan":
        with open(path) as f:
            return FaultPlan.from_dict(json.load(f))


class FaultInjector:
    """One-shot consumption ledger over a :class:`FaultPlan`.

    The engine polls :meth:`due` at each host intervention and calls
    :meth:`fire` for every spec it actually applied; a fired spec never
    fires again.  The ledger lives *outside* the engine on purpose:
    :func:`drive_resilient` re-attaches the same injector to a restored
    engine, so a consumed kill fault stays consumed across the restart
    it caused."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan.validate()
        self._fired: set = set()
        self.log: List[Dict[str, object]] = []   # (spec, fired-at tick)

    def due(self, tick: int) -> List[Tuple[int, FaultSpec]]:
        """Unfired specs whose scheduled tick has arrived, with their
        plan indices (pass the index back to :meth:`fire`)."""
        return [(i, f) for i, f in enumerate(self.plan.faults)
                if i not in self._fired and f.tick <= tick]

    def fire(self, index: int, tick: int) -> None:
        if index in self._fired:
            raise ValueError(f"fault {index} already fired")
        self._fired.add(index)
        self.log.append({**self.plan.faults[index].to_json(),
                         "fired_at": int(tick)})

    def pending(self) -> int:
        return len(self.plan.faults) - len(self._fired)


@dataclasses.dataclass
class FaultReport:
    """What :func:`drive_resilient` hands back: the final per-uid request
    set (one entry per submitted uid — restored runs replace the dead
    engine's Request objects), restart/fault accounting, and the final
    engine for stats/metrics aggregation."""

    requests: List[Request]
    engine: ServingEngine
    n_restarts: int = 0
    restart_ticks_lost: int = 0   # sum of (kill tick - restore tick)
    fault_events: List[Dict[str, object]] = dataclasses.field(
        default_factory=list)

    @property
    def completed(self) -> List[Request]:
        return [r for r in self.requests if r.done]

    @property
    def shed_uids(self) -> List[int]:
        return [r.uid for r in self.requests if r.shed]

    def lost_uids(self) -> List[int]:
        """Requests that neither finished nor were accountably shed —
        the invariant the whole fault layer exists to keep empty."""
        return [r.uid for r in self.requests if not r.done and not r.shed]


def drive_resilient(engine: ServingEngine, items: Sequence[WorkloadItem],
                    clock: Optional[VirtualClock] = None, *,
                    injector: Optional[FaultInjector] = None,
                    manager=None, checkpoint_every: int = 8,
                    max_ticks: int = 1_000_000,
                    sync_every: Optional[int] = None,
                    on_tick=None) -> FaultReport:
    """Fault-aware workload replay: :func:`repro_torch.serving.workload.
    drive`'s arrival-bounded loop, plus a checkpoint cadence and a
    kill-restart path.

    ``manager`` (a :class:`repro_torch.checkpoint.CheckpointManager`)
    enables journaling: the engine state is checkpointed at tick 0 and
    then every ``checkpoint_every`` ticks, always *between* steps.  When a
    ``kill_engine`` fault raises :class:`EngineKilled`, the dead engine is
    closed (its decode graph and cache released) and a new one restored
    from the latest checkpoint, the clock rewinds to the
    checkpoint's instant, arrivals the checkpoint had not seen are
    re-submitted (same order, same uids — submission is deterministic),
    and the loop continues.  Requests are tracked per-uid, so the report
    always describes the *final* engine's view of every submitted uid.
    The dead engine's tracer records on in the restored one, so a trace
    spans the restart.

    Restricted to :class:`VirtualClock` — faults are scheduled in ticks
    and the restart path rewinds time, neither of which a wall clock can
    honor."""
    if clock is None:
        clock = VirtualClock()
    if not isinstance(clock, VirtualClock):
        raise ValueError("drive_resilient requires a VirtualClock: faults "
                         "are tick-scheduled and restarts rewind the clock")
    if injector is not None:
        if injector.plan.needs_checkpoints() and manager is None:
            raise ValueError("the fault plan kills the engine but no "
                             "CheckpointManager was given: pass manager= "
                             "or the kill is unrecoverable")
        engine.attach_injector(injector)
    pending = sorted(items, key=lambda it: it.t)
    by_uid: Dict[int, Request] = {}
    i = 0
    busy = 0.0
    n_restarts = 0
    ticks_lost = 0
    next_ckpt = engine.ticks if manager is not None else None
    for _ in range(max_ticks):
        if i < len(pending) and not engine.has_work():
            clock.skip_to(pending[i].t)
        while i < len(pending) and pending[i].t <= clock.now:
            it = pending[i]
            req = engine.submit(list(it.prompt), it.max_new_tokens,
                                it.eos_id, deadline=it.deadline)
            by_uid[req.uid] = req
            i += 1
        # checkpoint AFTER the submission block: the journal then holds
        # every arrival with t <= clock_now, which is exactly what the
        # restart path's cursor rewind assumes
        if manager is not None and engine.ticks >= next_ckpt:
            engine.checkpoint(manager, clock_now=clock.now)
            next_ckpt = engine.ticks + max(1, int(checkpoint_every))
        if not engine.has_work() and i >= len(pending):
            if injector is not None and any(
                    k != "kill_engine" for _, s in injector.due(engine.ticks)
                    for k in [s.kind]):
                # drained with armed non-kill faults left: they can never
                # fire (nothing to hit) — record them as expired, loudly
                # in the log rather than silently vanishing
                for idx, spec in injector.due(engine.ticks):
                    if spec.kind != "kill_engine":
                        injector.fire(idx, engine.ticks)
                        injector.log[-1]["expired"] = True
            clock.busy_seconds = busy
            return FaultReport(
                requests=[by_uid[u] for u in sorted(by_uid)],
                engine=engine, n_restarts=n_restarts,
                restart_ticks_lost=ticks_lost,
                fault_events=list(engine.fault_events))
        budget = sync_every
        if i < len(pending):
            gap = pending[i].t - clock.now
            due = max(1, math.ceil(gap / clock.tick_cost)) if gap > 0 else 1
            budget = due if budget is None else min(budget, due)
        t0 = time.perf_counter()
        before = engine.ticks
        try:
            engine.step(max_ticks=budget)
        except EngineKilled as kill:
            busy += time.perf_counter() - t0
            n_restarts += 1
            dead = engine
            # at most one decode graph and one cache alive: the dead
            # engine's go before its successor captures its own
            dead.close()
            engine = ServingEngine.restore(manager, dead.params,
                                           model=dead.model,
                                           tracer=dead.tracer)
            engine.fault_events.extend(dead.fault_events)
            # the kill fired after the last checkpoint, so the restored
            # counters do not include it — yet the restart it caused is
            # part of the surviving timeline (unlike other post-checkpoint
            # faults, which roll back and never re-fire)
            engine._c_f_injected.inc()
            if injector is not None:
                engine.attach_injector(injector)
            ticks_lost += max(0, kill.tick - engine.ticks)
            clock.now = float(engine.restored_from["clock_now"])
            # arrivals the checkpoint had already seen live inside the
            # restored engine; rewind the submission cursor to the rest.
            # Re-submission is deterministic (same order, same uid
            # counter state), so uids line up with the dead run's.
            i = 0
            while i < len(pending) and pending[i].t <= clock.now:
                i += 1
            for req in engine.all_requests():
                by_uid[req.uid] = req
            next_ckpt = engine.ticks + max(1, int(checkpoint_every))
            continue
        busy += time.perf_counter() - t0
        for _ in range(engine.ticks - before):
            clock.tick()
        if on_tick is not None and engine.ticks != before:
            on_tick(engine.ticks)
    raise RuntimeError(f"workload did not drain within {max_ticks} steps "
                       f"({i}/{len(pending)} submitted, "
                       f"{n_restarts} restarts)")


def make_storm(*, duration: int, seed: int = 0,
               kinds: Sequence[str] = FAULT_KINDS,
               n_faults: int = 4, max_batch: int = 4) -> FaultPlan:
    """A seeded fault storm: ``n_faults`` specs spread over ``duration``
    ticks, cycling through ``kinds`` (at most one ``kill_engine``, placed
    mid-run so there is state worth losing).  Pure function of the
    arguments: storm cells are as replayable as the
    serving ones."""
    import numpy as np

    rng = np.random.default_rng(seed)
    kinds = tuple(kinds)
    for k in kinds:
        if k not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {k!r}; "
                             f"known: {FAULT_KINDS}")
    specs: List[FaultSpec] = []
    killed = False
    for j in range(n_faults):
        kind = kinds[j % len(kinds)]
        if kind == "kill_engine":
            if killed:
                kind = "poison_slot"
            killed = True
            tick = max(2, duration // 2)
        else:
            tick = int(rng.integers(1, max(2, duration)))
        specs.append(FaultSpec(
            kind=kind, tick=tick,
            slot=int(rng.integers(0, max_batch)),
            mode="garbage" if (kind == "poison_slot" and j % 2) else "nan",
            seed=seed + j))
    return FaultPlan(tuple(sorted(specs, key=lambda s: (s.tick, s.kind))))


__all__ = ["FAULT_KINDS", "FAULT_SCHEMA", "POISON_MODES", "FaultSpec",
           "FaultPlan", "FaultInjector", "FaultReport", "EngineKilled",
           "drive_resilient", "make_storm"]
