"""Typed metrics registry and windowed live metrics for the serving stack
(port of ``repro.obs.registry``, the whole file: ``Counter``, ``Gauge``,
``Histogram``, ``MetricsRegistry`` and ``LiveMetrics``).

* every counter, gauge and histogram is *registered* under a dotted name
  (``engine.host_syncs``, ``scheduler.submitted``, ``slots.snapshots``),
  so ``registry.reset()`` resets all of them by construction;
* :meth:`MetricsRegistry.view` renders a dict under the keys a
  ``stats()`` method has always used, :meth:`MetricsRegistry.snapshot`
  every metric by name;
* gauges can be *derived* (backed by a callable), so occupancy-style
  values (active slots, queue depth) are always live and never stale.

:class:`LiveMetrics` is the windowed half: a rolling view over the last
``window`` engine ticks (p95 TTFT/TPOT, SLO attainment, mean
utilization) computed with the tick conventions of
:mod:`repro_torch.serving.metrics` (it reuses ``request_metrics``), so a
window spanning the whole run reproduces the end-of-run aggregate
exactly.

Everything here is host-side and deterministic and touches no device:
observability must never perturb the virtual-clock schedule.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple


class Counter:
    """A monotonically increasing count (resettable)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value: int = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """A point-in-time value.  Backed either by :meth:`set` or by a
    callable (``fn``) for derived/occupancy-style values that must never
    go stale; derived gauges ignore :meth:`reset`."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.help = help
        self._fn = fn
        self._value: float = 0.0

    def set(self, v: float) -> None:
        if self._fn is not None:
            raise ValueError(f"gauge {self.name!r} is derived (fn-backed); "
                             f"it cannot be set")
        self._value = v

    @property
    def value(self) -> float:
        return self._fn() if self._fn is not None else self._value

    def reset(self) -> None:
        if self._fn is None:
            self._value = 0.0


class Histogram:
    """A stream of observations with nearest-rank percentile summaries
    (same method as :mod:`repro_torch.serving.metrics` — deterministic, no
    interpolation)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.values: List[float] = []

    def observe(self, v: float) -> None:
        self.values.append(float(v))

    @property
    def value(self) -> int:
        """Registered-value view: the observation count."""
        return len(self.values)

    def summary(self) -> Dict[str, float]:
        from repro_torch.serving.metrics import percentile

        out = {f"p{q}": percentile(self.values, q) for q in (50, 95, 99)}
        out["mean"] = (float(sum(self.values) / len(self.values))
                       if self.values else math.nan)
        out["n"] = len(self.values)
        return out

    def reset(self) -> None:
        self.values = []


class MetricsRegistry:
    """Name → metric store with get-or-create registration.

    Registration is idempotent per (name, kind): asking for an existing
    name returns the existing metric, asking for it under a different
    kind is an error (two subsystems silently sharing a name under
    different semantics is exactly the drift this registry exists to
    prevent)."""

    def __init__(self) -> None:
        self._metrics: Dict[str, object] = {}

    def _register(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{m.kind}, requested {cls.kind}")
            return m
        m = cls(name, help, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name: str, help: str = "",
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        return self._register(Gauge, name, help, fn=fn)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._register(Histogram, name, help)

    def get(self, name: str):
        return self._metrics.get(name)

    def __getitem__(self, name: str):
        return self._metrics[name]

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def reset(self) -> None:
        """Reset every registered metric — the one-call telemetry reset:
        a counter added anywhere in the stack is covered by construction,
        so warmup runs can never leak counts into measured stats."""
        for m in self._metrics.values():
            m.reset()

    def snapshot(self) -> Dict[str, float]:
        """Flat name → value dict (sorted keys; histograms report their
        observation count — use :meth:`Histogram.summary` for shape)."""
        return {name: self._metrics[name].value for name in self.names()}

    def view(self, mapping: "Dict[str, str]") -> Dict[str, float]:
        """A compat dict: ``{out_key: metric_name}`` rendered in mapping
        order with the *caller's* key names — how ``stats()`` surfaces
        preserve their historical keys over the registry."""
        return {out: self._metrics[name].value
                for out, name in mapping.items()}


class LiveMetrics:
    """Rolling serving metrics over the last ``window`` engine ticks.

    The engine feeds it per tick (:meth:`observe_tick` with that tick's
    utilization) and per retired request (:meth:`observe_request` at the
    completion/shed tick); :meth:`snapshot` then answers "how is serving
    *right now*": p95 TTFT/TPOT over requests that finished inside the
    window, rolling SLO attainment, and mean utilization — the windowed
    analogue of :func:`repro_torch.serving.metrics.aggregate`, sharing its
    tick conventions via ``request_metrics``.  With ``window`` at least
    the run length nothing is ever evicted and the snapshot equals the
    end-of-run aggregate.
    """

    def __init__(self, window: int = 64):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = int(window)
        self._util: Deque[float] = deque(maxlen=self.window)
        # (tick retired, per-request metrics or None, slo_met or None)
        self._reqs: Deque[Tuple[int, Optional[Dict[str, float]],
                                Optional[bool]]] = deque()
        self._tick = 0

    def reset(self) -> None:
        self._util.clear()
        self._reqs.clear()
        self._tick = 0

    # ------------------------------------------------------------- feeding
    def observe_tick(self, tick: int, util: float) -> None:
        """One engine tick's utilization; evicts request samples that
        retired before the window's left edge."""
        self._tick = max(self._tick, int(tick))
        self._util.append(float(util))
        edge = self._tick - self.window
        while self._reqs and self._reqs[0][0] <= edge:
            self._reqs.popleft()

    def observe_request(self, req, tick: int) -> None:
        """A request retired at ``tick`` — completed (latency samples +
        SLO verdict) or shed/unfinished-with-deadline (SLO miss, no
        latency samples)."""
        from repro_torch.serving.metrics import request_metrics

        m = request_metrics(req)
        met: Optional[bool] = None
        if req.deadline is not None:
            met = (req.done and req.t_done is not None
                   and req.t_done + 1 <= req.deadline)
        self._reqs.append((int(tick), m, met))

    # ------------------------------------------------------------ reporting
    def snapshot(self) -> Dict[str, object]:
        from repro_torch.serving.metrics import percentile

        per = [m for _, m, _ in self._reqs if m is not None]
        ttft = [m["ttft"] for m in per]
        tpot = [m["tpot"] for m in per if "tpot" in m]
        slo = [met for _, _, met in self._reqs if met is not None]
        util = list(self._util)
        out: Dict[str, object] = {
            "window": self.window,
            "tick": self._tick,
            "completed": len(per),
            "ttft_p95": percentile(ttft, 95),
            "tpot_p95": percentile(tpot, 95),
            "mean_util": (sum(util) / len(util)) if util else math.nan,
            "slo_attainment": (sum(slo) / len(slo)) if slo else None,
        }
        return out

    def line(self) -> str:
        """One monitoring line for the serve CLI (``--live-metrics``)."""
        s = self.snapshot()
        slo = (f" slo={s['slo_attainment']:.2f}"
               if s["slo_attainment"] is not None else "")
        return (f"[t={s['tick']:>6}] last {s['window']}t: "
                f"ttft_p95={s['ttft_p95']:6.1f}t "
                f"tpot_p95={s['tpot_p95']:5.2f}t "
                f"util={s['mean_util']:.2f} "
                f"done={s['completed']}" + slo)


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "LiveMetrics"]
