"""Serving-load workloads: arrival processes, traces, and the load driver
(port of ``repro.serving.workload``, the whole file: the same seeded
draws give the same items, and the trace files share one JSONL schema).

The paper's headline scenario is real-time serving — batch-of-1 requests
arriving *asynchronously*, where queueing and utilization (not raw BLAS
throughput) decide the win over the V100/Brainwave baselines.  This module
generates those arrival patterns and replays them against the
continuous-batching :class:`~repro_torch.serving.engine.ServingEngine`:

* :func:`poisson_arrivals` — memoryless arrivals at a fixed rate (the
  paper's serving experiment, and the standard open-loop load model);
* :func:`mmpp_arrivals` — a two-state Markov-modulated Poisson process
  (bursty traffic: a quiet state and a burst state with exponentially
  distributed dwell times), the classic model for flash-crowd load;
* :func:`load_trace` / :func:`save_trace` — replayable JSON trace files,
  so a production arrival log can be re-served bit-for-bit.

Time is *virtual* by default: one engine tick is one unit of a
:class:`VirtualClock`, so a workload run is a pure function of
``(workload, seed)`` — tests never depend on wall time.
:class:`WallClock` swaps real time in for live measurement
(``repro_torch.launch.serve --clock wall``); the engine itself only ever
sees tick stamps, so its telemetry stays deterministic either way.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.plan.plan import WorkloadProfile
from repro_torch.serving.engine import Request, ServingEngine

ARRIVAL_KINDS = ("poisson", "mmpp", "trace")


@dataclasses.dataclass(frozen=True)
class WorkloadItem:
    """One request in an arrival schedule (times in clock units).

    ``deadline`` is an optional *absolute* completion deadline in the same
    clock units as ``t`` (so slack = deadline - t).  It feeds the EDF
    scheduler and the SLO-attainment metric; absent means no deadline —
    the request sorts last under EDF and contributes no SLO sample.  The
    JSONL trace schema mirrors this: the ``deadline`` field is optional
    and traces written before it existed load unchanged.
    """

    t: float
    prompt: Tuple[int, ...]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    deadline: Optional[float] = None

    def to_json(self) -> dict:
        d = {"t": self.t, "prompt": list(self.prompt),
             "max_new_tokens": self.max_new_tokens}
        if self.eos_id is not None:
            d["eos_id"] = self.eos_id
        if self.deadline is not None:
            d["deadline"] = self.deadline
        return d

    @staticmethod
    def from_json(d: dict) -> "WorkloadItem":
        """Parse one trace record, naming the offending field on bad input
        (a malformed line in a multi-MB JSONL trace is otherwise a bare
        ``KeyError: 't'`` with no hint of where or what)."""
        if not isinstance(d, dict):
            raise ValueError(f"trace record must be a JSON object, "
                             f"got {type(d).__name__}")
        for field in ("t", "prompt"):
            if field not in d:
                raise ValueError(f"trace record missing required field "
                                 f"{field!r} (has: {sorted(d)})")
        unknown = set(d) - {"t", "prompt", "max_new_tokens", "eos_id",
                            "deadline"}
        if unknown:
            raise ValueError(f"trace record has unknown fields "
                             f"{sorted(unknown)}")
        try:
            t = float(d["t"])
        except (TypeError, ValueError):
            raise ValueError(f"field 't' must be a number, got {d['t']!r}")
        if not isinstance(d["prompt"], (list, tuple)):
            raise ValueError(f"field 'prompt' must be a list of token ids, "
                             f"got {type(d['prompt']).__name__}")
        try:
            prompt = tuple(int(x) for x in d["prompt"])
        except (TypeError, ValueError):
            raise ValueError(f"field 'prompt' must contain integer token "
                             f"ids, got {d['prompt']!r}")
        try:
            max_new = int(d.get("max_new_tokens", 16))
        except (TypeError, ValueError):
            raise ValueError(f"field 'max_new_tokens' must be an int, "
                             f"got {d['max_new_tokens']!r}")
        dl = d.get("deadline")
        try:
            dl = None if dl is None else float(dl)
        except (TypeError, ValueError):
            raise ValueError(f"field 'deadline' must be a number, "
                             f"got {dl!r}")
        return WorkloadItem(t, prompt, max_new, d.get("eos_id"), dl)


# ---------------------------------------------------------------------------
# Arrival processes
# ---------------------------------------------------------------------------


def poisson_arrivals(rate: float, duration: float,
                     rng: np.random.Generator) -> List[float]:
    """Arrival times of a homogeneous Poisson process on ``[0, duration)``
    (i.i.d. exponential inter-arrival gaps at ``rate`` per time unit)."""
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    times, t = [], 0.0
    while True:
        t += rng.exponential(1.0 / rate)
        if t >= duration:
            return times
        times.append(t)


def mmpp_arrivals(rates: Tuple[float, float], dwell: Tuple[float, float],
                  duration: float, rng: np.random.Generator) -> List[float]:
    """Two-state Markov-modulated Poisson process: the arrival rate
    switches between ``rates[0]`` (quiet) and ``rates[1]`` (burst), holding
    each state for an Exp(1/dwell[s]) time — bursty open-loop load."""
    if min(rates) <= 0 or min(dwell) <= 0:
        raise ValueError(f"rates/dwell must be > 0, got {rates}, {dwell}")
    times: List[float] = []
    t, state = 0.0, 0
    t_switch = rng.exponential(dwell[0])
    while t < duration:
        gap = rng.exponential(1.0 / rates[state])
        if t + gap >= t_switch:
            # state flips before the next arrival lands: restart the
            # (memoryless) arrival clock from the switch point
            t = t_switch
            state = 1 - state
            t_switch = t + rng.exponential(dwell[state])
            continue
        t += gap
        if t < duration:
            times.append(t)
    return times


PROMPT_DISTS = ("uniform", "fixed", "lognormal", "bimodal")

# bimodal long-mode weight: a long-TAIL mixture, rare enough that p95
# latencies reflect the short mode (the requests a deadline scheduler can
# actually help) while the occasional giant prompt still clogs slots
BIMODAL_LONG_FRAC = 0.08


def _prompt_length(rng: np.random.Generator, dist: str,
                   lo: int, hi: int, long_hi: int) -> int:
    """One prompt length draw under the named distribution.

    ``uniform`` draws exactly as the pre-distribution code did (same rng
    call sequence, so seeded default workloads are unchanged).  ``fixed``
    is the range midpoint every time.  ``lognormal`` has its median at
    the midpoint with a long right tail clipped to ``long_hi``.
    ``bimodal`` mixes the short uniform range with a long mode on
    ``[3*hi, long_hi]`` at ``BIMODAL_LONG_FRAC`` weight — the
    long-tail-prompt regime where preemptive scheduling pays."""
    if dist == "uniform":
        return int(rng.integers(lo, hi + 1))
    if dist == "fixed":
        return (lo + hi) // 2
    if dist == "lognormal":
        x = rng.lognormal(mean=math.log((lo + hi) / 2.0), sigma=0.6)
        return int(min(max(int(round(x)), lo), long_hi))
    if dist == "bimodal":
        if rng.uniform() >= BIMODAL_LONG_FRAC:
            return int(rng.integers(lo, hi + 1))
        return int(rng.integers(min(3 * hi, long_hi), long_hi + 1))
    raise ValueError(f"unknown prompt_dist {dist!r}; known: {PROMPT_DISTS}")


def synthesize(times: Sequence[float], rng: np.random.Generator, *,
               vocab_size: int, prompt_len: Tuple[int, int] = (4, 12),
               max_new_tokens: Tuple[int, int] = (8, 16),
               eos_id: Optional[int] = None,
               prompt_dist: str = "uniform",
               prompt_len_long: Optional[int] = None,
               heavy_decode: Optional[Tuple[float, int, int]] = None,
               deadline_slack: Optional[float] = None,
               deadline_frac: float = 1.0) -> List[WorkloadItem]:
    """Attach seeded random prompts/lengths to a list of arrival times.

    ``prompt_dist`` selects the prompt-length distribution (see
    :func:`_prompt_length`); ``prompt_len_long`` caps the long tail
    (default ``4 * prompt_len[1]``).  ``heavy_decode=(frac, lo, hi)``
    turns a seeded ``frac`` of requests into heavy-decode jobs with
    ``max_new_tokens`` drawn from ``[lo, hi]`` — on the virtual clock a
    request's slot-occupancy *is* its decode length, so this is the
    long-tail *service-time* mixture (the overload regime where
    preempting a slot-hogging job pays).  ``deadline_slack``, when set,
    stamps each request with the decode-proportional absolute deadline
    ``t + deadline_slack * max_new_tokens`` (finish within ``slack``
    times your own decode length — the SLO-scale convention, in the same
    tick units the engine serves in).  ``deadline_frac`` < 1 leaves a
    seeded random fraction of requests deadline-less (best-effort
    traffic mixed into the SLO stream)."""
    long_hi = prompt_len_long if prompt_len_long is not None \
        else 4 * prompt_len[1]
    items = []
    for t in times:
        n = _prompt_length(rng, prompt_dist, prompt_len[0], prompt_len[1],
                           long_hi)
        m = int(rng.integers(max_new_tokens[0], max_new_tokens[1] + 1))
        if heavy_decode is not None and rng.uniform() < heavy_decode[0]:
            m = int(rng.integers(heavy_decode[1], heavy_decode[2] + 1))
        prompt = tuple(int(x) for x in rng.integers(0, vocab_size, size=n))
        deadline = None
        if deadline_slack is not None:
            if deadline_frac >= 1.0 or rng.uniform() < deadline_frac:
                deadline = float(t) + deadline_slack * m
        items.append(WorkloadItem(float(t), prompt, m, eos_id, deadline))
    return items


def make_workload(kind: str, *, rate: float, duration: float, seed: int,
                  vocab_size: int,
                  prompt_len: Tuple[int, int] = (4, 12),
                  max_new_tokens: Tuple[int, int] = (8, 16),
                  burst_factor: float = 4.0,
                  dwell: Tuple[float, float] = (16.0, 4.0),
                  prompt_dist: str = "uniform",
                  prompt_len_long: Optional[int] = None,
                  heavy_decode: Optional[Tuple[float, int, int]] = None,
                  deadline_slack: Optional[float] = None,
                  deadline_frac: float = 1.0,
                  trace_path: Optional[str] = None) -> List[WorkloadItem]:
    """One-stop workload builder for the CLI and the serving cells.

    ``kind``: "poisson" | "mmpp" | "trace".  For "mmpp" the quiet rate is
    ``rate`` and the burst rate is ``rate * burst_factor``.  The result is
    a pure function of the arguments (seeded ``numpy`` generator).
    ``prompt_dist`` / ``deadline_slack`` / ``deadline_frac`` are forwarded
    to :func:`synthesize` (deadlines stamp an absolute, service-
    proportional SLO per request; traces carry their own deadlines).
    """
    if kind == "trace":
        if not trace_path:
            raise ValueError("kind='trace' requires trace_path")
        return load_trace(trace_path)
    rng = np.random.default_rng(seed)
    if kind == "poisson":
        times = poisson_arrivals(rate, duration, rng)
    elif kind == "mmpp":
        times = mmpp_arrivals((rate, rate * burst_factor), dwell, duration,
                              rng)
    else:
        raise ValueError(f"unknown arrival kind {kind!r}; "
                         f"known: {ARRIVAL_KINDS}")
    return synthesize(times, rng, vocab_size=vocab_size,
                      prompt_len=prompt_len, max_new_tokens=max_new_tokens,
                      prompt_dist=prompt_dist, prompt_len_long=prompt_len_long,
                      heavy_decode=heavy_decode,
                      deadline_slack=deadline_slack,
                      deadline_frac=deadline_frac)


def profile_items(profile: "WorkloadProfile", *, vocab_size: int, seed: int,
                  duration: Optional[float] = None) -> List[WorkloadItem]:
    """Materialize a :class:`repro_torch.plan.WorkloadProfile` into
    arrival items — the declarative half of a serving cell turned into
    the exact seeded draw sequence of :func:`make_workload`.  ``duration`` fills in a profile whose own duration is
    None."""
    span = profile.duration if profile.duration is not None else duration
    if span is None and profile.kind != "trace":
        raise ValueError("workload profile has no duration and none was "
                         "provided")
    return make_workload(
        profile.kind, rate=profile.rate, duration=span, seed=seed,
        vocab_size=vocab_size, prompt_len=profile.prompt_len,
        max_new_tokens=profile.max_new_tokens,
        burst_factor=profile.burst_factor, dwell=profile.dwell,
        prompt_dist=profile.prompt_dist,
        prompt_len_long=profile.prompt_len_long,
        heavy_decode=profile.heavy_decode,
        deadline_slack=profile.deadline_slack,
        deadline_frac=profile.deadline_frac,
        trace_path=profile.trace_path)


# ---------------------------------------------------------------------------
# Trace files
# ---------------------------------------------------------------------------


def save_trace(path: str, items: Sequence[WorkloadItem]) -> None:
    """Write a workload as JSON lines (one request per line, sorted by t)."""
    with open(path, "w") as f:
        for it in sorted(items, key=lambda it: it.t):
            f.write(json.dumps(it.to_json()) + "\n")


def load_trace(path: str) -> List[WorkloadItem]:
    """Load a JSONL arrival trace; a malformed line (truncated JSON, bad
    field type, missing field) raises one ValueError naming the file,
    line number, and problem rather than a bare decode/KeyError."""
    items = []
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            if not line.strip():
                continue
            try:
                d = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"{path}:{lineno}: not valid JSON ({e.msg} at column "
                    f"{e.colno}) — truncated write?") from None
            try:
                items.append(WorkloadItem.from_json(d))
            except ValueError as e:
                raise ValueError(f"{path}:{lineno}: {e}") from None
    return sorted(items, key=lambda it: it.t)


# ---------------------------------------------------------------------------
# Clocks + driver
# ---------------------------------------------------------------------------


class VirtualClock:
    """Deterministic clock: one engine tick advances time by ``tick_cost``
    units, and idle gaps fast-forward to the next arrival instantly."""

    def __init__(self, tick_cost: float = 1.0):
        self.tick_cost = tick_cost
        self.now = 0.0
        self.busy_seconds = 0.0   # filled by drive()

    def tick(self) -> None:
        self.now += self.tick_cost

    def skip_to(self, t: float) -> None:
        self.now = max(self.now, t)


class WallClock:
    """Real time (seconds since construction); idle gaps are slept away."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self.busy_seconds = 0.0   # filled by drive()

    @property
    def now(self) -> float:
        return time.perf_counter() - self._t0

    def tick(self) -> None:
        pass

    def skip_to(self, t: float) -> None:
        dt = t - self.now
        if dt > 0:
            time.sleep(dt)


def drive(engine: ServingEngine, items: Sequence[WorkloadItem],
          clock=None, max_ticks: int = 1_000_000,
          sync_every: Optional[int] = None,
          on_tick=None) -> List[Request]:
    """Replay a workload against an engine: submit each item when the clock
    reaches its arrival time, run the engine until fully drained.  Returns
    the Request objects (all done) in arrival order.

    Each ``engine.step()`` may run a multi-tick on-device chunk (the
    engine's ``sync_every``); the clock advances once per *engine tick*,
    and ``sync_every`` here caps the per-step tick budget on top of the
    engine's own setting.  On a :class:`VirtualClock` the budget is also
    bounded by the next pending arrival, so admission lands on exactly the
    tick a per-tick loop would use — tick stamps are then independent of
    ``sync_every`` (exact for the default ``tick_cost=1.0``).  On a
    :class:`WallClock` arrivals can be admitted up to a chunk late; that
    is the latency/throughput trade the knob exposes.

    Sets ``clock.busy_seconds`` to the wall time spent inside
    ``engine.step()`` (idle waits for arrivals excluded), so wall-clock
    callers can derive an honest per-tick cost even at low arrival rates.
    On CUDA that time is honest because ``step`` returns only after its
    chunk's blocking read: no step leaves device work unread.

    ``on_tick`` (optional) is called as ``on_tick(engine.ticks)`` after
    every step that advanced the clock.
    """
    if clock is None:
        clock = VirtualClock()
    pending = sorted(items, key=lambda it: it.t)
    reqs: List[Request] = []
    i = 0
    busy = 0.0
    for _ in range(max_ticks):
        if i < len(pending) and not engine.has_work():
            clock.skip_to(pending[i].t)  # idle: jump/sleep to next arrival
        while i < len(pending) and pending[i].t <= clock.now:
            it = pending[i]
            reqs.append(engine.submit(list(it.prompt), it.max_new_tokens,
                                      it.eos_id, deadline=it.deadline))
            i += 1
        if not engine.has_work() and i >= len(pending):
            clock.busy_seconds = busy
            return reqs
        budget = sync_every
        if i < len(pending) and isinstance(clock, VirtualClock):
            # never decode past the next arrival: ticks until it lands
            gap = pending[i].t - clock.now
            due = max(1, math.ceil(gap / clock.tick_cost)) if gap > 0 else 1
            budget = due if budget is None else min(budget, due)
        t0 = time.perf_counter()
        before = engine.ticks
        engine.step(max_ticks=budget)
        busy += time.perf_counter() - t0
        for _ in range(engine.ticks - before):
            clock.tick()
        if on_tick is not None and engine.ticks != before:
            on_tick(engine.ticks)
    raise RuntimeError(f"workload did not drain within {max_ticks} steps "
                       f"({i}/{len(pending)} submitted)")


def offered_load(items: Sequence[WorkloadItem],
                 duration: Optional[float] = None) -> float:
    """Offered tokens per clock unit (prompt + decode), for sizing sweeps.
    ``duration`` is the workload span; when omitted (e.g. a replayed trace
    with no declared span) the last arrival time stands in for it."""
    if not items:
        return 0.0
    span = duration if duration else max(it.t for it in items)
    if span <= 0:
        return math.inf
    toks = sum(len(it.prompt) + it.max_new_tokens for it in items)
    return toks / span
