"""Per-request latency metrics for the serving engine (port of
``repro.serving.metrics``, the whole file, pure Python on the port's
``Request``: the same stamps give the same dicts in both packages).

The engine stamps every request with *tick* timestamps (``t_submit`` /
``t_admit`` / ``t_first`` / ``t_done``) and keeps a per-tick utilization
history; this module turns a drained run into the serving numbers the
paper's real-time scenario is judged on:

* **queue-wait** — ticks between submission and admission to a slot (the
  scheduling delay the paper's §6 latency breakdown charges to batching);
* **TTFT** — time to first token, inclusive of the prefill tick: a request
  admitted on its submission tick has TTFT 1, not 0;
* **TPOT** — time per output token over the decode phase (first token
  excluded, so a one-token request has no TPOT sample);
* **tokens/sec** and mean utilization over the active span;
* **SLO attainment** — for requests carrying a ``deadline`` (absolute
  clock units): the fraction whose completion tick ended by the deadline
  (``(t_done + 1) * tick_seconds <= deadline``, consistent with TTFT
  counting the prefill tick as 1; on the virtual clock one tick is one
  clock unit and the scaling is a no-op);
* **preemption counters** — evictions, resumes, and how many requests
  were ever preempted (EDF ``--preempt``).

The ``slo`` block appears only when some request carries a deadline, and
the ``preemption`` block only when some request was actually preempted —
so aggregates of deadline-less FCFS/SPF runs carry neither block.

Everything is computed in ticks and scaled by ``tick_seconds`` at the end,
so the same aggregation serves both the deterministic virtual-clock mode
(``tick_seconds=1.0`` — "seconds" are tick units) and wall-clock runs
(``tick_seconds = measured wall time / ticks``).  Percentiles use the
nearest-rank method: exact, deterministic, no interpolation.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.serving.engine import Request

PERCENTILES = (50, 95, 99)


def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); NaN on empty input."""
    if not xs:
        return math.nan
    xs = sorted(xs)
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return float(xs[min(rank, len(xs)) - 1])


def _summary(xs: Sequence[float]) -> Dict[str, float]:
    out = {f"p{q}": percentile(xs, q) for q in PERCENTILES}
    out["mean"] = float(sum(xs) / len(xs)) if xs else math.nan
    out["n"] = len(xs)
    return out


def request_metrics(req: Request) -> Optional[Dict[str, float]]:
    """Tick-domain latency numbers for one *completed* request (None if the
    request never finished — it carries no valid stamps to aggregate)."""
    if not req.done or req.t_done is None:
        return None
    out: Dict[str, float] = {
        "queue_wait": float(req.t_admit - req.t_submit),
        "ttft": float(req.t_first - req.t_submit + 1),
        "n_tokens": float(len(req.output)),
    }
    if len(req.output) > 1:
        out["tpot"] = (req.t_done - req.t_first) / (len(req.output) - 1)
    return out


def aggregate(reqs: Sequence[Request], *, ticks: int,
              util_history: Sequence[float] = (),
              tick_seconds: float = 1.0) -> Dict[str, object]:
    """Aggregate a drained run into the benchmark's metric dict.

    With ``tick_seconds=1.0`` (virtual clock) every field is a pure
    function of the workload and the engine seed — two identical runs
    produce an identical dict.
    """
    per = [m for m in (request_metrics(r) for r in reqs) if m is not None]
    tokens = int(sum(m["n_tokens"] for m in per))

    def scaled(key: str) -> Dict[str, float]:
        xs = [m[key] * tick_seconds for m in per if key in m]
        return _summary(xs)

    span = ticks * tick_seconds
    util = list(util_history)
    out: Dict[str, object] = {
        "completed": len(per),
        "submitted": len(reqs),
        "tokens": tokens,
        "ticks": int(ticks),
        "tick_seconds": tick_seconds,
        "queue_wait": scaled("queue_wait"),
        "ttft": scaled("ttft"),
        "tpot": scaled("tpot"),
        "tokens_per_sec": tokens / span if span > 0 else math.nan,
        "mean_util": (float(sum(util) / len(util)) if util else math.nan),
    }
    # deadline / preemption blocks: emitted only when the feature was in
    # play.  Deadlines are absolute *clock* units, so the tick-domain completion
    # is scaled by tick_seconds before the comparison (a no-op on the
    # virtual clock, where one tick is one clock unit).
    with_dl = [r for r in reqs if r.deadline is not None]
    if with_dl:
        met = sum(1 for r in with_dl
                  if r.done and r.t_done is not None
                  and (r.t_done + 1) * tick_seconds <= r.deadline)
        out["slo"] = {
            "n": len(with_dl),
            "met": met,
            "violations": len(with_dl) - met,
            "attainment": met / len(with_dl),
        }
        # admission control (plan.shed_late): requests rejected at submit
        # as provably late.  They count as violations above (never done);
        # the key appears only when shedding actually happened.
        n_shed = sum(1 for r in with_dl if getattr(r, "shed", False))
        if n_shed:
            out["slo"]["shed"] = n_shed
    n_preempts = sum(r.n_preempts for r in reqs)
    if n_preempts:
        out["preemption"] = {
            "preemptions": n_preempts,
            "resumes": sum(len(r.t_resumes) for r in reqs),
            "preempted_requests": sum(1 for r in reqs if r.n_preempts),
        }
    return out


def aggregate_fleet(parts: Sequence[Tuple[Sequence[Request], int,
                                          Sequence[float]]], *,
                    tick_seconds: float = 1.0) -> Dict[str, object]:
    """Merge per-replica runs into one fleet-level metrics block.

    ``parts`` is one ``(requests, ticks, util_history)`` triple per
    replica.  The merge pools the *raw per-request samples* and recomputes
    every percentile over the pooled population — never an average of
    per-replica percentiles, which has no distributional meaning (a p95
    averaged across a fast and a slow replica reports a latency no actual
    request experienced; see the skewed-fleet unit test).  The fleet span
    is the widest replica span — replicas share one virtual clock, so the
    busiest replica's tick count is the fleet's serving window and
    ``tokens_per_sec`` is true fleet throughput, not a per-replica mean.
    Utilization histories concatenate: mean_util weights each replica by
    the ticks it actually ran.

    For a single-replica fleet this is byte-identical to
    :func:`aggregate` on that replica's run — the reduction the fleet
    equivalence tests pin."""
    parts = list(parts)
    if not parts:
        raise ValueError("aggregate_fleet of an empty fleet")
    reqs = [r for rs, _, _ in parts for r in rs]
    ticks = max(int(t) for _, t, _ in parts)
    util = [u for _, _, us in parts for u in us]
    return aggregate(reqs, ticks=ticks, util_history=util,
                     tick_seconds=tick_seconds)


def scale_latencies(agg: Dict[str, object],
                    tick_seconds: float) -> Dict[str, object]:
    """Map a tick-domain aggregate to milliseconds with a measured wall
    cost per tick (e.g. from a warmed-up closed-loop calibration run).

    This is the bridge between the deterministic virtual-clock schedule
    and real time: the tick-domain ``agg`` stays seed-exact, and this view
    is derived, host-noisy, and reported separately."""
    out: Dict[str, object] = {"tick_seconds": tick_seconds}
    for key in ("queue_wait", "ttft", "tpot"):
        s = agg[key]
        out[f"{key}_ms"] = {q: s[q] * tick_seconds * 1e3
                            for q in ("p50", "p95", "p99", "mean")}
    span_s = agg["ticks"] * tick_seconds
    out["tokens_per_sec"] = agg["tokens"] / span_s if span_s > 0 else math.nan
    return out


def format_summary(agg: Dict[str, object]) -> str:
    """Human-readable one-block summary for the serve CLI."""

    def line(name: str) -> str:
        s = agg[name]
        return (f"  {name:<10} p50={s['p50']:8.3f}  p95={s['p95']:8.3f}  "
                f"p99={s['p99']:8.3f}  mean={s['mean']:8.3f}  (n={s['n']})")

    lines = [
        f"completed {agg['completed']}/{agg['submitted']} requests, "
        f"{agg['tokens']} tokens in {agg['ticks']} ticks "
        f"({agg['tokens_per_sec']:.2f} tok/s, "
        f"mean util {agg['mean_util']:.2f})",
        line("queue_wait"), line("ttft"), line("tpot"),
    ]
    if "slo" in agg:
        s = agg["slo"]
        shed = f", {s['shed']} shed at submit" if "shed" in s else ""
        lines.append(f"  slo        {s['met']}/{s['n']} met "
                     f"({s['attainment']:.1%} attainment, "
                     f"{s['violations']} violations{shed})")
    if "preemption" in agg:
        p = agg["preemption"]
        lines.append(f"  preempt    {p['preemptions']} evictions / "
                     f"{p['resumes']} resumes over "
                     f"{p['preempted_requests']} requests")
    return "\n".join(lines)
