"""Typed metrics registry for the serving stack (port of
``repro.obs.registry``: ``Counter``, ``Gauge``, ``MetricsRegistry``).

Every serving counter is registered under a dotted name
(``engine.host_syncs``, ``scheduler.submitted``), so ``reset()`` covers
all of them; :meth:`MetricsRegistry.view` renders a dict under the keys a
``stats()`` method has always used; gauges may be derived from a
callable.  ``Histogram`` and ``LiveMetrics`` arrive with the metrics
slice.  Host-side and deterministic: nothing here touches a device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional


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
    """A point-in-time value, backed by :meth:`set` or by a callable
    (``fn``) for derived values; derived gauges ignore :meth:`reset`."""

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


class MetricsRegistry:
    """Name -> metric store with get-or-create registration.  Asking for
    an existing name under another kind is an error."""

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

    def reset(self) -> None:
        """Reset every registered metric."""
        for m in self._metrics.values():
            m.reset()

    def view(self, mapping: Dict[str, str]) -> Dict[str, float]:
        """``{out_key: metric_name}`` rendered in mapping order with the
        caller's key names."""
        return {out: self._metrics[name].value
                for out, name in mapping.items()}


__all__ = ["Counter", "Gauge", "MetricsRegistry"]
