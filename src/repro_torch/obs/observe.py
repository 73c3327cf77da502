"""Fit a :class:`repro_torch.plan.WorkloadProfile` from observed traffic
(port of ``repro.obs.observe``, the whole file).

:func:`fit_profile` reads a recorded :class:`repro_torch.obs.trace.Tracer`
trace (live object, exported Chrome JSON document, or file path; a JAX
package's trace loads alike) and fits the workload half of a serving
cell from its ``submit`` events:

* **arrival rate** — submissions per observed tick of span (the
  maximum-likelihood Poisson rate for the observed count);
* **prompt lengths** — the observed ``[min, max]`` range (the uniform
  fit the workload generator draws from);
* **decode lengths** — the observed ``max_new`` range, with a long-tail
  split: observations above ``2 x p90`` are fitted as a separate
  ``heavy_decode`` mixture component (fraction, lo, hi), matching the
  generator's heavy-tail service-time model;
* **deadlines** — the median decode-proportional slack
  ``(deadline - t_submit) / max_new`` plus the fraction of requests
  carrying any deadline.

The fit is a pure function of the trace, surfaced as
``WorkloadProfile.from_trace``; the planner that replans from it
(``autotune_from_trace``) comes with the router slice.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple, Union

from repro_torch.obs.trace import TICK_US, Tracer, load_trace_doc

# heavy-decode split: observations above HEAVY_FACTOR x p90 of the
# max_new stream are a separate long-tail mixture component
HEAVY_FACTOR = 2.0

TraceLike = Union[Tracer, Mapping[str, object], str]


def _submit_records(trace: TraceLike) -> List[Dict[str, object]]:
    """The ``submit`` events of a trace as ``{t(tick), prompt_len,
    max_new, deadline}`` records, in submission order."""
    if isinstance(trace, Tracer):
        return [{"t": ev.ts // TICK_US, **dict(ev.args)}
                for ev in trace.events
                if ev.cat == "request" and ev.name == "submit"]
    doc = load_trace_doc(trace) if isinstance(trace, str) else trace
    return [{"t": ev["ts"] // TICK_US, **ev.get("args", {})}
            for ev in doc["traceEvents"]
            if ev.get("cat") == "request" and ev.get("name") == "submit"]


def _percentile(xs: List[float], q: float) -> float:
    from repro_torch.serving.metrics import percentile

    return percentile(xs, q)


def _split_heavy(max_news: List[int]) -> Tuple[
        Tuple[int, int], Optional[Tuple[float, int, int]]]:
    """Split the observed decode-length stream into its base range and an
    optional heavy-tail mixture component (fraction, lo, hi)."""
    thr = HEAVY_FACTOR * _percentile([float(v) for v in max_news], 90)
    heavy = [v for v in max_news if v > thr]
    base = [v for v in max_news if v <= thr]
    if not heavy or not base:
        return (min(max_news), max(max_news)), None
    frac = len(heavy) / len(max_news)
    return ((min(base), max(base)), (frac, min(heavy), max(heavy)))


def fit_profile(trace: TraceLike, *,
                kind: str = "poisson",
                duration: Optional[float] = None):
    """Fit a :class:`repro_torch.plan.WorkloadProfile` from a recorded trace.

    ``trace`` is a live :class:`~repro_torch.obs.trace.Tracer`, an exported
    Chrome-trace document (dict), or a path to one.  ``duration``
    overrides the observed span (last submission tick + 1) when the
    caller knows the true recording window — e.g. a quiet tail after the
    last arrival, which would otherwise inflate the fitted rate.
    """
    from repro_torch.plan.plan import WorkloadProfile

    subs = _submit_records(trace)
    if not subs:
        raise ValueError("trace contains no request submit events; "
                         "nothing to fit a workload profile from")
    span = duration if duration is not None \
        else float(max(s["t"] for s in subs) + 1)
    if span <= 0:
        raise ValueError(f"non-positive observed span {span}")

    prompts = [int(s["prompt_len"]) for s in subs]
    max_news = [int(s["max_new"]) for s in subs]
    base_range, heavy = _split_heavy(max_news)

    slacks = [(float(s["deadline"]) - s["t"]) / s["max_new"]
              for s in subs if s.get("deadline") is not None]
    deadline_slack = _percentile(slacks, 50) if slacks else None
    deadline_frac = len(slacks) / len(subs) if slacks else 1.0

    return WorkloadProfile(
        kind=kind,
        rate=len(subs) / span,
        duration=span,
        prompt_len=(min(prompts), max(prompts)),
        max_new_tokens=base_range,
        heavy_decode=heavy,
        deadline_slack=deadline_slack,
        deadline_frac=deadline_frac,
    )


def observed_span_ticks(trace: TraceLike) -> int:
    """Last submission tick + 1 — the span :func:`fit_profile` assumes
    when no explicit duration is given."""
    subs = _submit_records(trace)
    return int(max(s["t"] for s in subs)) + 1 if subs else 0


def summarize(trace: TraceLike) -> Dict[str, object]:
    """A quick human-readable summary of a trace's observed traffic (the
    fit's inputs — handy for logs and notebooks)."""
    subs = _submit_records(trace)
    if not subs:
        return {"submits": 0}
    max_news = [float(s["max_new"]) for s in subs]
    return {
        "submits": len(subs),
        "span_ticks": observed_span_ticks(trace),
        "rate": len(subs) / max(1, observed_span_ticks(trace)),
        "prompt_len_p50": _percentile(
            [float(s["prompt_len"]) for s in subs], 50),
        "max_new_p50": _percentile(max_news, 50),
        "max_new_max": max(max_news),
        "with_deadline": sum(1 for s in subs
                             if s.get("deadline") is not None),
    }


__all__ = ["fit_profile", "observed_span_ticks", "summarize",
           "HEAVY_FACTOR"]
