"""`repro_torch.obs`: observability for the serving stack (port of
``repro.obs``, with its exports).

* :mod:`repro_torch.obs.registry` — the typed counters, gauges and
  histograms registry (:class:`MetricsRegistry`) that owns every
  serving-stack counter, and :class:`LiveMetrics`, a rolling window over
  the last N engine ticks (p95 TTFT/TPOT, SLO attainment, utilization);
* :mod:`repro_torch.obs.trace` — :class:`Tracer`, a structured event
  tracer on the virtual clock (request lifecycle spans, engine events,
  counter tracks) exported as Chrome ``trace_event`` JSON, byte-identical
  across same-seed virtual-clock runs and to the JAX package's trace of
  the same schedule;
* :mod:`repro_torch.obs.observe` — :func:`fit_profile`, a
  :class:`repro_torch.plan.WorkloadProfile` fitted from a recorded trace
  (``WorkloadProfile.from_trace``).

All three are host-side and import no torch.
"""

from repro_torch.obs.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    LiveMetrics,
    MetricsRegistry,
)
from repro_torch.obs.trace import (  # noqa: F401
    TraceEvent,
    Tracer,
    check_trace,
    dumps_trace_doc,
    merge_traces,
)
from repro_torch.obs.observe import fit_profile  # noqa: F401
