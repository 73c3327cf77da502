"""Structured event tracing on the deterministic virtual clock (port of
``repro.obs.trace``, the whole file; torch-free).

:class:`Tracer` records a serving engine's per-request timeline:

* **request lifecycle** (cat ``request``, one Perfetto track per request
  uid): a ``queued`` span (submit -> admit), a ``run`` span (admit ->
  completion; occupancy includes the prefill tick, matching the TTFT
  convention), and instant events ``submit`` / ``first_token`` /
  ``preempt`` / ``resume`` / ``shed``, and under faults ``fault`` /
  ``retry`` and the ``quarantine`` span;
* **engine events** (cat ``engine``, one track): ``decode_chunk`` spans
  (the multi-tick decode chunk, one CUDA graph launch on the card),
  ``prefill`` instants (bucket length, rows, admitted count),
  ``host_sync`` instants (blocking device-to-host reads) and ``compile``
  instants (a prefill shape's first call, the decode program's first
  chunk), and ``fault`` instants;
* **counter tracks** (ph ``C``): per-tick slot ``util`` and per-schedule
  ``queue_depth``, and for paged layouts ``blocks_free``,
  ``bytes_resident`` and ``padding_waste``.

Timestamps are engine *ticks* scaled by :data:`TICK_US` (one tick
renders as 1 ms), never wall time, so a trace is a pure function of the
workload and the seed: two same-seed virtual-clock runs serialize to
byte-identical files (:meth:`Tracer.dumps` is canonical JSON), and the
port's engine writes the bytes the JAX engine writes for the same
schedule.  :data:`TRACE_SCHEMA` is the JAX package's, so a trace of
either package loads into the other.  Open an exported file at
https://ui.perfetto.dev (or chrome://tracing): it is standard Chrome
``trace_event`` JSON.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Mapping, Optional

TRACE_SCHEMA = "repro.obs.trace/v1"
TICK_US = 1000          # one virtual-clock tick rendered as 1 ms
ENGINE_PID = 1          # the engine's event track
REQUEST_PID = 2         # one thread (track) per request uid

CATS = ("request", "engine")
PHASES = ("X", "i", "C", "M")
# "quarantine" / "fault" / "retry" events are emitted only when the fault
# layer actually fires (injected fault or watchdog eviction), so every
# no-fault trace stays byte-identical to the pre-fault-tolerance engine
REQUEST_SPANS = ("queued", "run", "quarantine")
REQUEST_INSTANTS = ("submit", "first_token", "preempt", "resume", "shed",
                    "fault", "retry")
ENGINE_SPANS = ("decode_chunk",)
ENGINE_INSTANTS = ("prefill", "host_sync", "compile", "fault")
ENGINE_COUNTERS = ("util", "queue_depth",
                   # fragmentation tracks, emitted by paged-layout engines
                   # only (dense traces carry the first two exactly as
                   # before — byte-stable)
                   "blocks_free", "bytes_resident", "padding_waste")


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One Chrome ``trace_event``; ``ts``/``dur`` are in the scaled tick
    units (:data:`TICK_US`), already multiplied."""

    name: str
    cat: str
    ph: str                       # "X" span | "i" instant | "C" counter
    ts: int
    pid: int
    tid: int
    dur: Optional[int] = None     # spans only
    args: Mapping[str, object] = dataclasses.field(default_factory=dict)

    def to_json(self) -> Dict[str, object]:
        d: Dict[str, object] = {"name": self.name, "cat": self.cat,
                                "ph": self.ph, "ts": self.ts,
                                "pid": self.pid, "tid": self.tid}
        if self.dur is not None:
            d["dur"] = self.dur
        if self.ph == "i":
            d["s"] = "t"          # instant scope: thread
        if self.args:
            d["args"] = dict(self.args)
        return d


class Tracer:
    """Collects :class:`TraceEvent`\\ s from the serving engine.

    Attach one via ``ServingEngine.from_plan(..., tracer=Tracer())`` (or
    the kwargs constructor); the engine calls the ``request_*`` /
    engine-event hooks below at the host points where it learns each
    fact, stamped with the *tick* the fact logically happened at.  All
    hooks are cheap appends — tracing never syncs the device and never
    perturbs the schedule.  No hook takes a tensor: every value it records
    is a Python ``int``, ``float``, ``bool``, ``str`` or ``None`` the
    engine already holds on the host.
    """

    def __init__(self) -> None:
        self.events: List[TraceEvent] = []

    def __len__(self) -> int:
        return len(self.events)

    def reset(self) -> None:
        """Drop all recorded events (``engine.reset_telemetry()`` calls
        this so a post-warmup trace restarts empty at tick 0)."""
        self.events.clear()

    # ------------------------------------------------------------ low level
    def _add(self, name: str, cat: str, ph: str, tick: int, tid: int, *,
             dur_ticks: Optional[int] = None, **args) -> None:
        pid = ENGINE_PID if cat == "engine" else REQUEST_PID
        self.events.append(TraceEvent(
            name=name, cat=cat, ph=ph, ts=int(tick) * TICK_US,
            pid=pid, tid=tid,
            dur=None if dur_ticks is None else int(dur_ticks) * TICK_US,
            args={k: v for k, v in args.items() if v is not None}))

    # ------------------------------------------------------ request lifecycle
    def request_submit(self, req, tick: int) -> None:
        self._add("submit", "request", "i", tick, req.uid,
                  uid=req.uid, prompt_len=len(req.prompt),
                  max_new=req.max_new_tokens, deadline=req.deadline)

    def request_shed(self, req, tick: int) -> None:
        self._add("shed", "request", "i", tick, req.uid,
                  uid=req.uid, deadline=req.deadline)

    def request_preempt(self, req, tick: int, slot: int,
                        evicted_tokens: int) -> None:
        self._add("preempt", "request", "i", tick, req.uid,
                  uid=req.uid, slot=slot, evicted_tokens=evicted_tokens)

    def request_resume(self, req, tick: int, slot: int) -> None:
        self._add("resume", "request", "i", tick, req.uid,
                  uid=req.uid, slot=slot)

    def request_done(self, req, tick: int) -> None:
        """Emit the request's lifecycle spans at completion, when every
        stamp is known: the ``queued`` wait span and the ``run``
        occupancy span (admit → done+1, the TTFT convention's prefill-
        inclusive interval), plus the ``first_token`` instant."""
        self._add("queued", "request", "X", req.t_submit, req.uid,
                  dur_ticks=req.t_admit - req.t_submit, uid=req.uid,
                  prompt_len=len(req.prompt))
        self._add("run", "request", "X", req.t_admit, req.uid,
                  dur_ticks=tick + 1 - req.t_admit, uid=req.uid,
                  n_tokens=len(req.output), n_preempts=req.n_preempts,
                  deadline=req.deadline)
        self._add("first_token", "request", "i", req.t_first, req.uid,
                  uid=req.uid)

    # ------------------------------------------------------- fault lifecycle
    def request_fault(self, req, tick: int, kind: str,
                      slot: Optional[int]) -> None:
        """A fault hit this request (poisoned/dropped/stalled slot, failed
        prefill): the moment the engine pulled it out of service."""
        self._add("fault", "request", "i", tick, req.uid,
                  uid=req.uid, kind=kind, slot=slot)

    def request_retry(self, req, tick: int, retries: int) -> None:
        """The faulted request was rolled back to its last good snapshot
        (or to scratch) and re-queued, charged one retry."""
        self._add("retry", "request", "i", tick, req.uid,
                  uid=req.uid, retries=retries,
                  tokens_kept=len(req.output))

    def request_quarantine(self, req, t_fault: int, t_recovered: int) -> None:
        """Span from the fault to the request being back in a slot (or
        shed) — the per-request recovery time the chaos benchmark plots."""
        self._add("quarantine", "request", "X", t_fault, req.uid,
                  dur_ticks=t_recovered - t_fault, uid=req.uid,
                  retries=req.retries)

    def engine_fault(self, tick: int, kind: str, **args) -> None:
        """Engine-scope fault instant (kill/drop_readback/fail_prefill and
        the slot-fault injection points)."""
        self._add("fault", "engine", "i", tick, 0, kind=kind, **args)

    # ---------------------------------------------------------- engine events
    def decode_chunk(self, tick: int, n_ticks: int, n_slots: int) -> None:
        self._add("decode_chunk", "engine", "X", tick, 0,
                  dur_ticks=max(1, n_ticks), n_ticks=n_ticks,
                  n_slots=n_slots)

    def prefill(self, tick: int, bucket: int, rows: int, n_reqs: int,
                overlap: bool) -> None:
        self._add("prefill", "engine", "i", tick, 0, bucket=bucket,
                  rows=rows, n_reqs=n_reqs, overlap=overlap)

    def host_sync(self, tick: int) -> None:
        self._add("host_sync", "engine", "i", tick, 0)

    def compile(self, tick: int, what: str, rows: int, length: int) -> None:
        self._add("compile", "engine", "i", tick, 0, what=what,
                  rows=rows, length=length)

    def counter(self, tick: int, name: str, value: float) -> None:
        self._add(name, "engine", "C", tick, 0, **{name: value})

    # -------------------------------------------------------------- export
    def to_chrome(self) -> Dict[str, object]:
        """The Chrome ``trace_event`` document: metadata naming the two
        process tracks, then every recorded event in emission order."""
        meta = [
            TraceEvent("process_name", "engine", "M", 0, ENGINE_PID, 0,
                       args={"name": "serving engine"}),
            TraceEvent("process_name", "request", "M", 0, REQUEST_PID, 0,
                       args={"name": "requests"}),
        ]
        return {
            "traceEvents": [e.to_json() for e in meta + self.events],
            "displayTimeUnit": "ms",
            "otherData": {"schema": TRACE_SCHEMA, "tick_us": TICK_US},
        }

    def dumps(self) -> str:
        """Canonical serialization: sorted keys, fixed separators — two
        tracers with equal event sequences produce equal bytes."""
        return json.dumps(self.to_chrome(), sort_keys=True,
                          separators=(",", ":")) + "\n"

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.dumps())


def load_trace_doc(path: str) -> Dict[str, object]:
    """Read an exported trace back (for :mod:`repro_torch.obs.observe`
    and :func:`check_trace`)."""
    with open(path) as f:
        return json.load(f)


def merge_traces(tracers, labels=None) -> Dict[str, object]:
    """Merge per-replica tracers into one Chrome document with replica-
    tagged tracks: replica ``r``'s engine events land on pid ``2r+1``
    and its request tracks on pid ``2r+2``, each named by ``process_name``
    metadata (``"replica 0 engine"`` / ``"replica 0 requests"`` …) so a
    fleet run opens in Perfetto as one timeline with the replicas stacked.
    Event content is untouched — ticks already share the fleet's virtual
    clock — so the merged document passes :func:`check_trace` and, like a
    single tracer, serializes byte-identically across same-seed runs
    (:func:`dumps_trace_doc`)."""
    tracers = list(tracers)
    if labels is None:
        labels = [f"replica {r}" for r in range(len(tracers))]
    if len(labels) != len(tracers):
        raise ValueError(f"need one label per tracer: "
                         f"{len(labels)} labels for {len(tracers)} tracers")
    events: List[TraceEvent] = []
    for r, (tr, label) in enumerate(zip(tracers, labels)):
        e_pid, q_pid = 2 * r + 1, 2 * r + 2
        events.append(TraceEvent("process_name", "engine", "M", 0,
                                 e_pid, 0, args={"name": f"{label} engine"}))
        events.append(TraceEvent("process_name", "request", "M", 0,
                                 q_pid, 0,
                                 args={"name": f"{label} requests"}))
        for e in tr.events:
            events.append(dataclasses.replace(
                e, pid=e_pid if e.pid == ENGINE_PID else q_pid))
    return {
        "traceEvents": [e.to_json() for e in events],
        "displayTimeUnit": "ms",
        "otherData": {"schema": TRACE_SCHEMA, "tick_us": TICK_US,
                      "replicas": len(tracers)},
    }


def dumps_trace_doc(doc: Mapping[str, object]) -> str:
    """Canonical serialization for an assembled trace document (same
    byte contract as :meth:`Tracer.dumps`)."""
    return json.dumps(doc, sort_keys=True, separators=(",", ":")) + "\n"


def check_trace(doc: Mapping[str, object]) -> None:
    """Validate a Chrome-trace document against the documented schema;
    raises ``ValueError`` on the first violation, with the JAX
    package's message."""
    for key in ("traceEvents", "displayTimeUnit", "otherData"):
        if key not in doc:
            raise ValueError(f"trace document missing {key!r}")
    other = doc["otherData"]
    if other.get("schema") != TRACE_SCHEMA:
        raise ValueError(f"trace schema {other.get('schema')!r} != "
                         f"{TRACE_SCHEMA!r}")
    known = {
        "request": {"X": set(REQUEST_SPANS), "i": set(REQUEST_INSTANTS)},
        "engine": {"X": set(ENGINE_SPANS), "i": set(ENGINE_INSTANTS),
                   "C": set(ENGINE_COUNTERS)},
    }
    for i, ev in enumerate(doc["traceEvents"]):
        where = f"traceEvents[{i}]"
        for key in ("name", "cat", "ph", "ts", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"{where} missing {key!r}: {ev}")
        if ev["ph"] not in PHASES:
            raise ValueError(f"{where} unknown phase {ev['ph']!r}")
        if ev["ph"] == "M":
            continue
        if ev["cat"] not in CATS:
            raise ValueError(f"{where} unknown category {ev['cat']!r}")
        if not isinstance(ev["ts"], int) or ev["ts"] < 0:
            raise ValueError(f"{where} ts must be a non-negative int, "
                             f"got {ev['ts']!r}")
        if ev["ts"] % TICK_US:
            raise ValueError(f"{where} ts {ev['ts']} is not tick-aligned "
                             f"(TICK_US={TICK_US})")
        allowed = known[ev["cat"]].get(ev["ph"])
        if allowed is None or ev["name"] not in allowed:
            raise ValueError(f"{where} unknown event "
                             f"{ev['cat']}/{ev['ph']}/{ev['name']!r}")
        if ev["ph"] == "X":
            if not isinstance(ev.get("dur"), int) or ev["dur"] < 0:
                raise ValueError(f"{where} span needs int dur >= 0: {ev}")
        if ev["cat"] == "request" and ev["ph"] != "C" \
                and ev["tid"] != ev.get("args", {}).get("uid", ev["tid"]):
            raise ValueError(f"{where} request event tid/uid mismatch: {ev}")


__all__ = ["Tracer", "TraceEvent", "check_trace", "load_trace_doc",
           "TRACE_SCHEMA", "TICK_US"]
