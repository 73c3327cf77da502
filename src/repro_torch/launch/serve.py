"""Serving launcher (port of ``repro.launch.serve``): requests through the
continuous-batching engine, submitted up front or under an open-loop
arrival process.  Every design parameter lives in a
:class:`repro_torch.plan.ServingPlan`; the engine is built from one.

  # batch mode: submit N requests up front, drain (on the card, full width)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
      --requests 8 --max-new 16
  # open loop: Poisson arrivals on the virtual clock, latency percentiles
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
      --reduced --arrival poisson --rate 0.5 --duration 16 --device cpu
  # a saved plan (from --save-plan, or a JAX serving_plan/v1 file)
  PYTHONPATH=src python -m repro_torch.launch.serve --plan plan.json \\
      --arrival poisson --rate 0.8 --duration 64
  # int8 weights (every dot of a block on the matmul_w8a16 kernel on CUDA)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \\
      --int8 --requests 8 --max-new 16 --max-len 1024

``--plan`` loads a plan JSON; ``--autotune`` runs the serving-level
design-space search (:func:`repro_torch.plan.planner.autotune`, its
probes on ``--device``) against the CLI-described workload.  A knob flag
given as well overrides its field and is recorded in
``plan.provenance``.  Without either the flags build a plan over the CLI
defaults (``max_len`` 64).  An override of arch, max_batch or max_len
rescores the plan's kernel tiles
(:func:`repro_torch.plan.planner.tile_plans_for`) on ``h100-sxm``::

  # search, save and serve the winner on the CPU (drop --device cpu to
  # probe and serve on the card; drop --reduced too for full width)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
      --reduced --autotune --arrival poisson --rate 0.8 --duration 32 \\
      --deadline-slack 3 --save-plan tuned.json --device cpu

``--arrival {poisson,mmpp,trace}`` replays a workload from
:mod:`repro_torch.serving.workload` and prints the queue-wait, TTFT and
TPOT percentile summary (:func:`repro_torch.serving.metrics.
format_summary`) and the ``engine stats`` line.  ``--clock virtual``
(the default) is deterministic: the metrics are a pure function of the
workload and the seed; ``--clock wall`` paces arrivals in real time
after a warm-up and scales the latencies by the measured seconds a tick.

Prompts of the batch mode are drawn as in the JAX launcher (``numpy``
generator from ``--seed``, 4 to 11 tokens), the parameters from a
``torch.Generator`` seeded with 0 on the serving device, built leaf by
leaf as served (``LM.init_serving``, so qwen2.5-14b's ~29.5 GB of bf16
weights fit the card); ``--int8`` serves ``quantize_tree`` of that tree
(not for an MoE arch, which has no int8 expert path, nor for
hymba-1.5b, whose int8 path is not ported yet: it raises).  Any arch the
port serves works (rwkv6-1.6b, qwen2.5-14b, qwen3-moe-30b-a3b,
granite-moe-1b-a400m, hymba-1.5b; qwen3-moe's ~61 GB of bf16 weights at
full width with ``--max-len 1024``, built a layer slice at a time).  Without
``--device`` it runs on the current CUDA device and raises where there
is none.
``--cache-layout paged:<block>`` serves from the paged slot manager
(block pools behind a fixed dense view).

``--replicas N`` serves an open-loop workload through a fleet of N
replicas of the resolved plan behind :class:`repro_torch.serving.router.
Router` on one virtual clock (``--routing``, choices from the router
registry; ``--prefill-replicas K`` disaggregates: the first K replicas
prefill and hand their slots to the others), and prints the JAX
launcher's fleet lines: the pooled summary, one line a replica, the
transit line and the conservation check.  With ``--trace-out`` the file
is ``merge_traces`` of one tracer a replica, byte-equal to the JAX
launcher's for the same arguments::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
      --reduced --arrival poisson --rate 1.0 --duration 16 --device cpu \\
      --replicas 3 --prefill-replicas 1 --routing least_queue

``--trace-out PATH`` records the engine's event trace
(:class:`repro_torch.obs.Tracer`) and writes it as Chrome
``trace_event`` JSON (open it at https://ui.perfetto.dev); on the
virtual clock the file is a pure function of the arguments, byte-equal
to the JAX launcher's for the same ones.  ``--live-metrics [N]`` prints
a rolling line (p95 TTFT/TPOT, SLO attainment, utilization over the
last N ticks) every N ticks (N = 32 when not given)::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
      --reduced --arrival poisson --rate 0.5 --duration 16 --device cpu \\
      --trace-out trace.json --live-metrics 4

``--fault-spec PATH`` serves an open-loop workload under a
:class:`repro_torch.serving.faults.FaultPlan` through ``drive_resilient``
(virtual clock only), with ``--retry-budget``, ``--watchdog-ticks``
(needed by ``stall_slot``), ``--checkpoint-dir`` (needed by
``kill_engine``) and ``--checkpoint-every``, and prints the JAX
launcher's ``faults:`` and ``recovery:`` lines::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
      --reduced --arrival poisson --rate 0.8 --duration 32 --device cpu \\
      --fault-spec storm.json --watchdog-ticks 4 --checkpoint-dir ckpt
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import hw
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.lm import build_served
from repro_torch.obs.trace import Tracer
from repro_torch.plan import ServingPlan, WorkloadProfile
from repro_torch.plan import io as plan_io
from repro_torch.plan import planner
from repro_torch.plan.plan import tiles_summary
from repro_torch.serving import metrics as smetrics
from repro_torch.serving import workload as wl
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.router import ROUTING_POLICIES
from repro_torch.serving.scheduler import POLICIES

# CLI flag -> plan field, for flags that map 1:1 (None = not given)
_PLAN_FLAGS = (
    ("arch", "arch"),
    ("reduced", "reduced"),
    ("max_batch", "max_batch"),
    ("max_len", "max_len"),
    ("cache_layout", "cache_layout"),
    ("temperature", "temperature"),
    ("sync_every", "sync_every"),
    ("policy", "policy"),
    ("preempt", "preempt"),
    ("shed_late", "shed_late"),
    ("truncate_prompts", "truncate_prompts"),
    ("retry_budget", "retry_budget"),
    ("watchdog_ticks", "watchdog_ticks"),
)

_CLI_DEFAULT_MAX_LEN = 64


def build_parser() -> argparse.ArgumentParser:
    """The CLI surface.  Plan-covered knobs default to None (not given):
    their defaults live in :class:`ServingPlan`."""
    ap = argparse.ArgumentParser(
        description="serve requests through the port's engine")
    ap.add_argument("--arch", default=None,
                    help="architecture id (required unless --plan names one)")
    ap.add_argument("--reduced", action="store_true", default=None,
                    help="the reduced (CPU-sized) configuration")
    ap.add_argument("--plan", default=None, metavar="PATH",
                    help="load a ServingPlan JSON (serving_plan/v1); knob "
                         "flags given as well become recorded overrides")
    ap.add_argument("--autotune", action="store_true",
                    help="search the serving design space (bucket set x "
                         "sync_every x max_batch x policy x cache layout) "
                         "for the CLI-described workload and serve the "
                         "winning plan (repro_torch.plan.planner.autotune; "
                         "its probes run on --device)")
    ap.add_argument("--save-plan", default=None, metavar="PATH",
                    help="write the resolved plan as JSON before serving")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=None,
                    help="decode slots (plan default 4)")
    ap.add_argument("--max-len", type=int, default=None,
                    help=f"cache length (CLI default {_CLI_DEFAULT_MAX_LEN})")
    ap.add_argument("--cache-layout", default=None, metavar="LAYOUT",
                    help="'dense' or 'paged:<block_size>' (plan default "
                         "dense)")
    ap.add_argument("--sync-every", type=int, default=None,
                    help="decode ticks per host intervention (plan default "
                         "1)")
    ap.add_argument("--policy", default=None, choices=POLICIES,
                    help="admission order (scheduler registry; plan "
                         "default fcfs)")
    ap.add_argument("--preempt", action="store_true", default=None,
                    help="EDF only: evict a running request to host memory "
                         "when a strictly tighter deadline waits")
    ap.add_argument("--shed-late", action="store_true", default=None,
                    help="reject at submit a request that provably cannot "
                         "meet its deadline")
    ap.add_argument("--no-bucketed-prefill", action="store_true",
                    default=None,
                    help="one exact-length batch-1 prefill a request")
    ap.add_argument("--no-overlap-prefill", action="store_true",
                    default=None,
                    help="read each admission's first tokens at once "
                         "instead of on the next decode chunk's read")
    ap.add_argument("--truncate-prompts", action="store_true", default=None,
                    help="drop the tail of prompts longer than max_len-1 "
                         "instead of rejecting them")
    ap.add_argument("--seed", type=int, default=0,
                    help="workload + sampler seed")
    ap.add_argument("--temperature", type=float, default=None)
    # the serving tier (repro_torch.serving.router)
    ap.add_argument("--replicas", type=int, default=None, metavar="N",
                    help="serve through a fleet of N replicas of the plan "
                         "behind the router; arrival process required, "
                         "virtual clock only")
    ap.add_argument("--routing", default=None, choices=ROUTING_POLICIES,
                    help="fleet routing policy (router registry; default "
                         "round_robin)")
    ap.add_argument("--prefill-replicas", type=int, default=None,
                    metavar="K",
                    help="disaggregate: the first K replicas only admit "
                         "and prefill, and hand their slots to the decode "
                         "replicas over a modeled transit (needs "
                         "--replicas > K)")
    ap.add_argument("--arrival", default="batch",
                    choices=("batch",) + wl.ARRIVAL_KINDS,
                    help="'batch' submits --requests up front; "
                         "poisson/mmpp/trace replay an arrival process")
    ap.add_argument("--rate", type=float, default=0.5,
                    help="arrival rate, requests per clock unit")
    ap.add_argument("--duration", type=float, default=64.0,
                    help="workload span in clock units")
    ap.add_argument("--prompt-dist", default="uniform",
                    choices=wl.PROMPT_DISTS,
                    help="prompt-length distribution of generated workloads")
    ap.add_argument("--deadline-slack", type=float, default=None,
                    help="deadline = arrival + SLACK * max_new clock units")
    ap.add_argument("--deadline-frac", type=float, default=1.0,
                    help="fraction of generated requests with a deadline")
    ap.add_argument("--trace-file", default=None,
                    help="JSONL trace for --arrival trace")
    ap.add_argument("--clock", default="virtual",
                    choices=("virtual", "wall"),
                    help="virtual: deterministic tick clock; wall: pace "
                         "arrivals in real time")
    # fault tolerance (repro_torch.serving.faults)
    ap.add_argument("--retry-budget", type=int, default=None,
                    help="recoveries per request before it is shed "
                         "(plan default 3)")
    ap.add_argument("--watchdog-ticks", type=int, default=None,
                    help="evict a slot after this many ticks without "
                         "progress (plan default 0 = watchdog off; "
                         "required to serve a fault plan with stall_slot)")
    ap.add_argument("--fault-spec", default=None, metavar="PATH",
                    help="inject faults from a FaultPlan JSON and serve "
                         "through the crash-restartable driver; virtual "
                         "clock only (faults are tick-scheduled and "
                         "restarts rewind time)")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="journal engine state here every "
                         "--checkpoint-every ticks under --fault-spec "
                         "(required when the plan contains kill_engine)")
    ap.add_argument("--checkpoint-every", type=int, default=8,
                    help="ticks between engine checkpoints under "
                         "--checkpoint-dir (default 8)")
    # observability (repro_torch.obs)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record a structured event trace (request "
                         "lifecycle spans + engine events on the virtual "
                         "clock) and write Chrome trace_event JSON here — "
                         "open it at https://ui.perfetto.dev; same-seed "
                         "virtual-clock runs write byte-identical files")
    ap.add_argument("--live-metrics", type=int, nargs="?", const=32,
                    default=None, metavar="N",
                    help="print a rolling serving line (p95 TTFT/TPOT, "
                         "SLO attainment, utilization over the last N "
                         "ticks) every N engine ticks (default N=32)")
    ap.add_argument("--int8", action="store_true",
                    help="serve int8 weights (quantize_tree)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="per-chunk engine lines (repro_torch DEBUG)")
    return ap


def _workload_profile(args) -> WorkloadProfile:
    kind = args.arrival if args.arrival != "batch" else "poisson"
    return WorkloadProfile(
        kind=kind, rate=args.rate, duration=args.duration,
        max_new_tokens=(args.max_new, args.max_new),
        prompt_dist=args.prompt_dist,
        deadline_slack=args.deadline_slack,
        deadline_frac=args.deadline_frac,
        trace_path=args.trace_file)


def resolve_plan(args, parser: argparse.ArgumentParser) -> ServingPlan:
    """The parsed CLI as one validated plan: the ``--plan`` file or the
    ``--autotune`` result (or the CLI defaults) as the base, then every
    given knob flag that changes it, recorded under
    ``provenance["cli_overrides"]``.  Tile plans are rescored when an
    override of arch, max_batch or max_len leaves them stale."""
    overrides = {}
    for flag, field in _PLAN_FLAGS:
        v = getattr(args, flag)
        if v is not None:
            overrides[field] = v
    if args.no_bucketed_prefill:
        overrides["bucketed_prefill"] = False
    if args.no_overlap_prefill:
        overrides["overlap_prefill"] = False
    if args.plan and args.autotune:
        parser.error("--plan and --autotune are mutually exclusive")
    if args.plan:
        base = plan_io.load_plan(args.plan)
        source = f"file:{args.plan}"
    elif args.autotune:
        if not args.arch:
            parser.error("--autotune requires --arch")
        base = planner.autotune(
            args.arch, _workload_profile(args), seed=args.seed,
            reduced=bool(args.reduced),
            max_len=args.max_len or _CLI_DEFAULT_MAX_LEN,
            device=args.device)
        source = "autotune"
    else:
        if not args.arch:
            parser.error("--arch is required (or pass --plan)")
        base = ServingPlan(arch=args.arch, reduced=bool(args.reduced),
                           max_len=_CLI_DEFAULT_MAX_LEN)
        source = "cli"
    # a typed flag only overrides when it changes the base plan's value
    # (--autotune requires --arch, which the autotuned plan carries)
    overrides = {k: v for k, v in overrides.items()
                 if getattr(base, k) != v}
    new_len = overrides.get("max_len")
    if (new_len is not None and base.buckets is not None
            and base.buckets[-1] != new_len - 1):
        overrides["buckets"] = None
    # tile plans are scored at (arch, max_batch, max_len): overriding any
    # of those leaves them stale, so rescore
    stale = {"arch", "max_batch", "max_len"} & set(overrides)
    if base.tile_plans and stale:
        tp = planner.tile_plans_for(
            overrides.get("arch", base.arch),
            overrides.get("max_batch", base.max_batch), hw.DEFAULT,
            max_len=overrides.get("max_len", base.max_len))
        if tp != dict(base.tile_plans):
            overrides["tile_plans"] = tp
    plan = dataclasses.replace(base, **overrides) if overrides else base
    prov = dict(plan.provenance)
    prov["source"] = source
    if overrides:
        prov["cli_overrides"] = dict(overrides)
    return dataclasses.replace(plan, provenance=prov).validate()


def _serve_fleet(args, parser, plan: ServingPlan, dev) -> None:
    """Serve through a homogeneous fleet (every replica runs the resolved
    plan) behind the router, on one virtual clock: the schedule is a pure
    function of the arguments."""
    from repro_torch.obs.trace import dumps_trace_doc, merge_traces
    from repro_torch.plan.plan import FleetPlan
    from repro_torch.serving.router import Router, drive_fleet

    n = int(args.replicas or 1)
    k = int(args.prefill_replicas or 0)
    if n < 1:
        parser.error("--replicas must be >= 1")
    if not 0 <= k < n:
        parser.error("--prefill-replicas must leave at least one decode "
                     "replica (need 0 <= K < --replicas)")
    if args.arrival == "batch":
        parser.error("the fleet router needs an arrival process "
                     "(--arrival poisson/mmpp/trace): requests are routed "
                     "on the shared replay clock")
    if args.clock != "virtual":
        parser.error("--replicas requires --clock virtual: the fleet "
                     "replicas share one deterministic clock")
    if args.fault_spec:
        parser.error("--fault-spec does not compose with --replicas: "
                     "fault injection drives a single engine")
    fleet = FleetPlan.replicated(
        plan, n, routing=args.routing or "round_robin", n_prefill=k,
        provenance={"source": "launch.serve"}).validate()
    print(f"fleet: {fleet.summary()}")
    model, params = build_served(plan.arch, plan.reduced, dev,
                                 int8=args.int8)
    tracers = [Tracer() for _ in range(n)] if args.trace_out else None
    router = Router.from_plan(fleet, seed=args.seed, tracers=tracers,
                              device=dev,
                              _built={(plan.arch, plan.reduced):
                                      (model, params)})
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name})")

    items = wl.profile_items(_workload_profile(args),
                             vocab_size=model.cfg.vocab_size, seed=args.seed)
    span = None if args.arrival == "trace" else args.duration
    shown = span if span is not None else max((it.t for it in items),
                                              default=0.0)
    print(f"replaying {len(items)} {args.arrival} arrivals over "
          f"{shown:g} virtual-clock units across {n} replicas "
          f"(offered {wl.offered_load(items, span):.2f} tok/unit)")
    t0 = time.time()
    reqs = drive_fleet(router, items, wl.VirtualClock())
    dt = time.time() - t0
    print(smetrics.format_summary(router.fleet_aggregate()))
    for i, eng in enumerate(router.engines):
        role = "prefill" if i < k else "decode"
        s = eng.stats()
        print(f"  replica[{i}] ({role}): {len(router.assigned[i])} routed, "
              f"{s['ticks']} ticks, {s['prefill_calls']} prefill calls, "
              f"{s['host_syncs']} host syncs")
    if k:
        ts = router.transit_stats()
        print(f"transit: {ts['handoffs']} handoffs, {ts['delivered']} "
              f"delivered, {ts['bytes']} bytes over {ts['ticks']} transit "
              f"ticks (bytes/tick {ts['bytes_per_tick']})")
    census = router.conservation_census()
    if census["total"] != len(reqs):
        raise RuntimeError(f"request conservation violated: {census}")
    print(f"wall: {dt:.2f}s ({len(reqs)} requests conserved)")
    if tracers is not None:
        with open(args.trace_out, "w") as f:
            f.write(dumps_trace_doc(merge_traces(tracers)))
        print(f"wrote merged fleet trace ({n} replicas) to "
              f"{args.trace_out} (open at https://ui.perfetto.dev)")


def main(argv: Optional[List[str]] = None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    if args.verbose:
        logging.getLogger("repro_torch").setLevel(logging.DEBUG)
    dev = resolve_device(args.device)
    plan = resolve_plan(args, parser)
    if args.replicas is not None or args.prefill_replicas:
        _serve_fleet(args, parser, plan, dev)
        return
    if args.routing:
        parser.error("--routing only applies to a fleet; pass --replicas N")
    fault_plan = None
    if args.fault_spec:
        from repro_torch.serving.faults import FaultPlan

        if args.arrival == "batch":
            parser.error("--fault-spec needs an arrival process "
                         "(--arrival poisson/mmpp/trace): faults are "
                         "scheduled on the replay clock")
        if args.clock != "virtual":
            parser.error("--fault-spec requires --clock virtual: faults "
                         "are tick-scheduled and restarts rewind time")
        fault_plan = FaultPlan.load(args.fault_spec)
        if fault_plan.needs_watchdog() and plan.watchdog_ticks <= 0:
            parser.error("the fault plan stalls slots but the watchdog is "
                         "off; pass --watchdog-ticks N (stalled slots only "
                         "recover by watchdog eviction)")
        if fault_plan.needs_checkpoints() and not args.checkpoint_dir:
            parser.error("the fault plan kills the engine; pass "
                         "--checkpoint-dir DIR so it can restart from a "
                         "checkpoint")
    print(f"plan: {plan.summary()}")
    if plan.tile_plans:
        print(f"kernel tiles: {tiles_summary(plan.tile_plans)}")
    if args.save_plan:
        plan_io.save_plan(plan.resolve(), args.save_plan)
        print(f"wrote plan to {args.save_plan}")
    model, params = build_served(plan.arch, plan.reduced, dev,
                                 int8=args.int8)
    tracer = Tracer() if args.trace_out else None
    engine = ServingEngine.from_plan(plan, params, model=model,
                                     seed=args.seed, tracer=tracer)
    live = (engine.enable_live_metrics(args.live_metrics)
            if args.live_metrics else None)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name})")

    def _save_trace() -> None:
        if tracer is not None:
            tracer.save(args.trace_out)
            print(f"wrote {len(tracer)} trace events to {args.trace_out} "
                  f"(open at https://ui.perfetto.dev)")

    if args.arrival == "batch":
        rng = np.random.default_rng(args.seed)
        reqs = []
        for _ in range(args.requests):
            prompt = rng.integers(0, model.cfg.vocab_size,
                                  size=rng.integers(4, 12)).tolist()
            reqs.append(engine.submit(prompt, max_new_tokens=args.max_new))
        t0 = time.perf_counter()
        engine.run()
        dt = time.perf_counter() - t0
        total = sum(len(r.output) for r in reqs)
        print(f"served {len(reqs)} requests, {total} tokens in {dt:.2f}s "
              f"({total / dt:.1f} tok/s)")
        print(f"engine stats: {engine.stats()}")
        for r in reqs[:3]:
            print(f"  req {r.uid}: prompt[:6]={r.prompt[:6]} -> "
                  f"{r.output[:8]}")
        if not all(r.done for r in reqs):
            raise RuntimeError("requests left unfinished")
        if live is not None:
            print(live.line())
        _save_trace()
        return

    items = wl.profile_items(_workload_profile(args),
                             vocab_size=model.cfg.vocab_size, seed=args.seed)
    span = None if args.arrival == "trace" else args.duration
    shown = span if span is not None else max((it.t for it in items),
                                              default=0.0)
    print(f"replaying {len(items)} {args.arrival} arrivals over "
          f"{shown:g} {args.clock}-clock units "
          f"(offered {wl.offered_load(items, span):.2f} tok/unit)")
    if args.clock == "wall":
        # one request a prefill bucket the workload will hit, so the
        # ticks timed exclude first calls
        for n in sorted({engine.bucket(len(it.prompt)) for it in items}):
            engine.submit([1] * n, max_new_tokens=2)
        engine.run()
        engine.reset_telemetry()
    clock = wl.WallClock() if args.clock == "wall" else wl.VirtualClock()
    on_tick = None
    if live is not None:
        period = args.live_metrics
        last_print = [0]

        def on_tick(tick: int) -> None:
            if tick - last_print[0] >= period:
                last_print[0] = tick
                print(live.line())
    t0 = time.perf_counter()
    report = None
    if fault_plan is not None:
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.serving.faults import FaultInjector, drive_resilient

        manager = (CheckpointManager(args.checkpoint_dir)
                   if args.checkpoint_dir else None)
        report = drive_resilient(engine, items, clock,
                                 injector=FaultInjector(fault_plan),
                                 manager=manager,
                                 checkpoint_every=args.checkpoint_every,
                                 on_tick=on_tick)
        engine = report.engine   # a kill_engine fault swaps the instance
        reqs = report.requests
    else:
        reqs = wl.drive(engine, items, clock, on_tick=on_tick)
    dt = time.perf_counter() - t0
    # a tick's cost from busy time only: idle waits for arrivals excluded
    tick_s = (clock.busy_seconds / max(1, engine.ticks)
              if args.clock == "wall" else 1.0)
    agg = smetrics.aggregate(reqs, ticks=engine.ticks,
                             util_history=engine.util_history,
                             tick_seconds=tick_s)
    print(smetrics.format_summary(agg))
    s = engine.stats()
    print(f"hot path: {s['host_syncs']} host syncs / {s['ticks']} ticks "
          f"({s['host_syncs'] / max(1, s['ticks']):.2f}/tick, "
          f"sync_every={engine.sync_every}), {s['prefill_calls']} prefill "
          f"calls ({s['overlap_prefills']} overlapped) over "
          f"{s['prefill_shapes']} shapes, {s['instant_admits']} instant "
          f"admits")
    if s["preemptions"] or s["shed"]:
        print(f"scheduler: {s['preemptions']} preemptions / "
              f"{s['resumes']} resumes, {s['evicted_tokens']} tokens "
              f"evicted to host, {s['shed']} requests shed at submit")
    if report is not None:
        fs = engine.fault_stats()
        print(f"faults: {fs['injected']:.0f} injected, "
              f"{fs['quarantined']:.0f} quarantined "
              f"({fs['watchdog_evictions']:.0f} by watchdog), "
              f"{fs['retries']:.0f} retries, {fs['shed']:.0f} shed; "
              f"{report.n_restarts} engine restarts "
              f"({report.restart_ticks_lost} ticks replayed)")
        lost = report.lost_uids()
        if lost:
            raise RuntimeError(f"lost requests (neither done nor shed): "
                               f"{lost}")
        print(f"recovery: {len(report.completed)} completed, "
              f"{len(report.shed_uids)} shed, 0 lost")
    print(f"engine stats: {s}")
    if args.clock == "wall":
        print(f"wall: {dt:.2f}s, {agg['tokens'] / dt:.1f} tok/s measured")
    _save_trace()


if __name__ == "__main__":
    main()
