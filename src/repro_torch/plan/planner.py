"""Serving-level design-space search (port of the engine half of
``repro.plan.planner``): ``autotune(arch, workload, hw_spec)``.

The serving analogue of :func:`repro_torch.core.dse.best_plan`.  The
kernel DSE searches tile geometry per problem size against a latency
model of the Hopper kernels; this planner searches the serving design
space

    bucket set x sync_every x max_batch x (policy, preempt) x cache layout

per (architecture, workload profile) against two oracles, as the JAX
package does:

* the **roofline cost model** (:class:`repro_torch.hw.HardwareSpec`)
  scores what the virtual clock cannot see: the host cost of a chunk
  against ``sync_every``, prefill padding and the one-time cost of a new
  prefill bucket (bucket set), and whether weights and cache fit the
  card (the *full-size* config's spec trees, nothing allocated, even
  when the probe runs reduced; the weights in the dtypes the port
  serves, bf16 where the JAX package counts f32);
* a short seeded **virtual-clock probe** scores queueing: each feasible
  (max_batch, policy, preempt) candidate replays the workload through a
  real engine (:meth:`ServingEngine.from_plan` and ``drive``) and is
  ranked by (SLO attainment, p95 TTFT, p95 queue-wait, tokens/tick).

On CUDA every probe is a graph engine (one tick captured, then chunks
replayed); ``device="cpu"`` runs the same probes eagerly.  Virtual-clock
schedules depend only on lengths, budgets and deadlines, so the probes'
scores, and the plan, are the same on both.  Deterministic for a fixed
(hw_spec, seed); ties go to the earlier candidate.

:func:`tile_plans_for` embeds the Hopper DSE's tile for each layer kind.
A recurrent kind is marked ``persistent`` where the grid-resident kernel
can hold W_h (:func:`repro_torch.core.dse.persistent_eligible`), where
the JAX package marks it when one VMEM tile holds the weights.
:func:`modeled_tick_seconds` is also what the router charges a hand-off
with.  The fleet search (``autotune_fleet``, ``fleet_shard_modes``,
``load_collectives``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch import hw
from repro_torch.plan.plan import (
    MIN_BUCKET,
    ServingPlan,
    WorkloadProfile,
    default_buckets,
    parse_cache_layout,
)

log = logging.getLogger("repro_torch.plan")

# cost-model constants, measured by chip_smoke.py phase 4l at rwkv6-1.6b
# full width on an "NVIDIA H100 80GB HBM3, 700.00 W" card (nvidia-smi
# name, power.limit), late in a whole smoke run.  HOST_SYNC_S: a 1-tick
# chunk of the graph engine at B=4 (the inputs' upload, the graph
# launch, the blocking read; 8.061 ms) less one tick of an 8-tick chunk
# (50.071 / 8 ms), medians of 7.
# COMPILE_S: what a new prefill bucket costs the port once: the first
# prefill call at a (rows, length) the process had not run less a warm
# call at it, median over 7 such shapes (the prefill is eager: nothing
# is compiled).  They steer relative choices, never absolute claims.
HOST_SYNC_S = 1.802e-3
COMPILE_S = 5.554e-3
HBM_FRACTION = 0.9        # usable device memory after runtime slack
SYNC_GAIN_MIN = 0.01      # keep growing the chunk while gain >= 1%
# paged-layout gather/launch overhead, as extra tokens' worth of bytes per
# allocated page: smaller blocks fragment less but cost more table
# indirection, so the layout search has a real block-size trade-off
PAGE_OVERHEAD_TOKENS = 2.0

# recurrent layer kinds that map onto the paper's RNN-cell tile search
_RECURRENT_KINDS = ("rwkv", "swa_ssm")


# ---------------------------------------------------------------------------
# Memory + per-tick cost model (full-size config: the deployment target)
# ---------------------------------------------------------------------------


def _spec_bytes(specs) -> int:
    from repro_torch.models.params import tree_leaves

    return int(sum(s.nbytes for s in tree_leaves(specs)))


def _served_bytes(specs) -> int:
    """Bytes of a parameter spec tree as ``LM.serving_params`` serves it:
    every ``DOT_LEAVES`` leaf in bf16, every other leaf in its own dtype."""
    import torch

    from repro_torch.models.lm import DOT_LEAVES
    from repro_torch.models.params import tree_leaves, tree_map_named

    bf16 = torch.bfloat16.itemsize
    return int(sum(tree_leaves(tree_map_named(
        lambda name, s: s.size * bf16 if name in DOT_LEAVES else s.nbytes,
        specs))))


@functools.lru_cache(maxsize=None)
def _full_model(arch: str):
    """The full-size (deployment-target) model: a config and its spec
    trees, no tensor.  Cached by arch."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model

    return build_model(get_config(arch))


@functools.lru_cache(maxsize=None)
def serving_memory_bytes(arch: str, max_batch: int,
                         max_len: int) -> Tuple[int, int]:
    """(weight_bytes, cache_bytes) of the *full-size* config at the given
    slot count, from the parameter and cache spec trees: the weights as
    the port serves them (``_served_bytes``: bf16 matmul leaves, where
    the JAX package scores its f32 leaves), the cache in its own leaf
    dtypes (int8 KV, f32 state)."""
    model = _full_model(arch)
    weights = _served_bytes(model.param_specs())
    cache = _spec_bytes(model.cache_specs(max_batch, max_len))
    return weights, cache


@functools.lru_cache(maxsize=None)
def _full_param_count(arch: str) -> int:
    return int(_full_model(arch).n_params())


def modeled_tick_seconds(arch: str, max_batch: int,
                         spec: hw.HardwareSpec) -> float:
    """Roofline cost of one batched decode tick on ``spec``: the larger of
    streaming every bf16 weight once and 2 FLOPs per (param, slot)."""
    n_params = _full_param_count(arch)
    weight_bytes = 2 * n_params  # bf16 deployment weights
    t_compute = spec.matmul_time(2.0 * n_params * max_batch)
    t_stream = spec.hbm_time(weight_bytes)
    return max(t_compute, t_stream)


def pick_sync_every(arch: str, max_batch: int, spec: hw.HardwareSpec,
                    candidates: Sequence[int], preempt: bool) -> int:
    """Largest chunk whose modeled throughput still gains >= 1% over the
    previous candidate.  Preemptive plans pin ``sync_every=1``: eviction
    happens at host syncs, so a victim would wait out the whole chunk."""
    if preempt:
        return 1
    t_tick = modeled_tick_seconds(arch, max_batch, spec)
    cands = sorted(set(int(c) for c in candidates))
    best = cands[0]
    best_thr = 1.0 / (t_tick + HOST_SYNC_S / best)
    for c in cands[1:]:
        thr = 1.0 / (t_tick + HOST_SYNC_S / c)
        if thr < best_thr * (1.0 + SYNC_GAIN_MIN):
            break
        best, best_thr = c, thr
    return best


def _pad_bucket(n: int, limit: int) -> int:
    return min(limit, -(-n // MIN_BUCKET) * MIN_BUCKET)


def candidate_bucket_sets(prompt_lengths: Sequence[int], max_len: int
                          ) -> List[Optional[Tuple[int, ...]]]:
    """Bucket-set candidates: the pow2 default plus a quantile set fitted
    to the workload's prompt lengths (p50/p90/max, padded to MIN_BUCKET
    granularity, always ending at max_len-1)."""
    limit = max_len - 1
    out: List[Optional[Tuple[int, ...]]] = [None]
    if prompt_lengths:
        ls = sorted(prompt_lengths)
        qs = {ls[min(len(ls) - 1, math.ceil(q * len(ls)) - 1)]
              for q in (0.5, 0.9, 1.0)}
        fitted = tuple(sorted({_pad_bucket(q, limit) for q in qs} | {limit}))
        if fitted != default_buckets(max_len):
            out.append(fitted)
    return out


def bucket_set_cost(buckets: Optional[Tuple[int, ...]],
                    prompt_lengths: Sequence[int], max_len: int,
                    arch: str, spec: hw.HardwareSpec) -> float:
    """Modeled prefill seconds per admitted request: padded-token compute
    plus each bucket's one-time cost amortized over the admissions."""
    bs = buckets if buckets is not None else default_buckets(max_len)
    limit = max_len - 1

    def pad(n: int) -> int:
        for b in bs:
            if b >= n:
                return b
        return bs[-1]

    n_params = _full_param_count(arch)
    t_tok = spec.matmul_time(2.0 * n_params)
    mean_padded = (sum(pad(min(n, limit)) for n in prompt_lengths)
                   / max(1, len(prompt_lengths)))
    return mean_padded * t_tok + COMPILE_S * len(bs) / max(
        1, len(prompt_lengths))


# ---------------------------------------------------------------------------
# Cache layout (dense vs. paged block pool)
# ---------------------------------------------------------------------------


def expected_tokens_per_slot(items, max_len: int) -> float:
    """Resident tokens a slot is provisioned for: the p95 of each
    request's footprint (prompt + decode budget, capped at the cache
    length), so a paged pool does not undershoot the tail."""
    if not items:
        return float(max_len)
    toks = sorted(min(max_len, len(it.prompt) + it.max_new_tokens)
                  for it in items)
    return float(toks[min(len(toks) - 1, math.ceil(0.95 * len(toks)) - 1)])


@functools.lru_cache(maxsize=None)
def cache_layout_bytes(arch: str, max_batch: int, max_len: int,
                       layout: str, tokens_per_slot: float) -> int:
    """Modeled resident cache bytes of the *full-size* config under a
    cache layout at the expected per-slot load.  Dense commits the whole
    ``max_batch x max_len`` cache; paged commits per-slot state plus the
    expected tokens rounded up to blocks
    (:func:`repro_torch.serving.paged.paged_cache_bytes`) plus a per-page
    charge (:data:`PAGE_OVERHEAD_TOKENS`) for the block-table gather."""
    block = parse_cache_layout(layout)
    if block is None:
        return serving_memory_bytes(arch, max_batch, max_len)[1]
    from repro_torch.serving.paged import paged_cache_bytes

    model = _full_model(arch)
    base = paged_cache_bytes(model, max_batch, max_len, block,
                             tokens_per_slot)
    n_pages = math.ceil(min(max_len, tokens_per_slot) / block)
    # ring bytes per covered token (per-slot state excluded: paging it
    # costs nothing, so a pool-less arch carries no overhead and ties
    # with dense)
    floor = paged_cache_bytes(model, max_batch, max_len, block, 0.0)
    one_page = paged_cache_bytes(model, max_batch, max_len, block,
                                 float(block))
    per_tok = (one_page - floor) // max(1, max_batch * block)
    overhead = int(PAGE_OVERHEAD_TOKENS * per_tok * n_pages * max_batch)
    return base + overhead


def candidate_cache_layouts(max_len: int,
                            block_sizes: Sequence[int]) -> List[str]:
    """Dense first (the tie-break winner), then one paged candidate per
    admissible block size."""
    return ["dense"] + [f"paged:{b}" for b in sorted(set(int(b)
                        for b in block_sizes)) if 1 <= b <= max_len]


# ---------------------------------------------------------------------------
# Per-kernel tile plans
# ---------------------------------------------------------------------------


def tile_plans_for(arch: str, max_batch: int, spec: hw.HardwareSpec,
                   max_len: int = 2048) -> Dict[str, Dict[str, object]]:
    """The Hopper DSE's tile plan for each layer kind, scored at the
    serving batch (the kernel-level half of the design point).

    Recurrent kinds score the 3-gate cell at the model width in bf16.
    Where W_h can stay resident in the shared memory of a grid the card
    holds at once (:func:`dse.persistent_eligible`), the entry is the
    persistent kernel's best tile and carries ``persistent: true`` with
    its residency evidence; otherwise it is the streaming best.  Attention
    kinds (attn/local) get a bq/bk tile of the ``wgmma`` prefill kernel
    scored at the plan's cache length.  Every entry is the compact
    :func:`dse.plan_dict` form, the JAX package's key set."""
    from repro_torch.core import dse
    from repro_torch.core.cells import RNNCellConfig

    cfg = _full_model(arch).cfg
    out: Dict[str, Dict[str, object]] = {}
    for kind in sorted(set(cfg.layer_pattern)):
        if kind in _RECURRENT_KINDS:
            cell = RNNCellConfig("gru", hidden=cfg.d_model,
                                 features=cfg.d_model,
                                 batch=1, precision="bf16")
            pers = dse.persistent_eligible(cell, spec, max_batch=max_batch)
            out[kind] = dse.plan_dict(dse.best_plan(
                cell, spec, max_batch=max_batch, persistent=pers))
        elif kind in ("attn", "local"):
            seq = max(int(max_len), dse.SUBLANE)
            window = cfg.local_window if kind == "local" else 0
            seq_kv = min(seq, window) if window else seq
            best = dse.best_attn_plan(seq, seq_kv, cfg.head_dim_, spec,
                                      n_heads=cfg.n_heads, batch=max_batch)
            out[kind] = dse.plan_dict(best)
    return out


# ---------------------------------------------------------------------------
# The probe + search
# ---------------------------------------------------------------------------


def _probe_metrics(plan: ServingPlan, model, params, items,
                   seed: int) -> Dict[str, object]:
    """One seeded drive of ``items`` under ``plan`` on the virtual clock,
    scored by ``aggregate``.  The engine (and its decode graph on CUDA)
    is closed after."""
    from repro_torch.serving import metrics as smetrics
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.workload import drive

    engine = ServingEngine.from_plan(plan, params, model=model, seed=seed)
    try:
        reqs = drive(engine, items)
        return smetrics.aggregate(reqs, ticks=engine.ticks,
                                  util_history=engine.util_history)
    finally:
        engine.close()


def _score(agg: Dict[str, object]) -> Tuple[float, float, float, float]:
    """Rank key, larger is better: (SLO attainment, -p95 TTFT,
    -p95 queue-wait, tokens/tick).  NaN percentiles (nothing completed)
    rank worst."""

    def neg(x: float) -> float:
        return -1e18 if (x is None or math.isnan(x)) else -float(x)

    slo = agg.get("slo", {}).get("attainment", 0.0)
    return (float(slo), neg(agg["ttft"]["p95"]),
            neg(agg["queue_wait"]["p95"]), float(agg["tokens_per_sec"]))


def autotune(arch: str, workload: WorkloadProfile,
             hw_spec: hw.HardwareSpec = hw.DEFAULT, *,
             seed: int = 0, reduced: bool = True, max_len: int = 64,
             max_batches: Sequence[int] = (2, 4, 8),
             sync_everys: Sequence[int] = (1, 2, 4, 8),
             block_sizes: Sequence[int] = (8, 16, 32),
             probe_duration: float = 32.0,
             device=None) -> ServingPlan:
    """Search the serving design space for one (arch, workload) cell.

    Returns the winning validated :class:`ServingPlan` with the search
    recorded under ``provenance["autotune"]`` (the JAX package's keys).
    The probes serve the tree the launcher serves
    (:func:`repro_torch.models.lm.build_served`, seeded 0) on ``device``:
    the current CUDA device unless ``device`` is given; without a card
    and without ``device="cpu"`` this raises.

    The cache layout is chosen *after* the scheduling probe:
    virtual-clock schedules are layout-invariant (the paged manager is
    bit-exact behind the slot-manager seam), so only the memory check
    and the final resident-bytes comparison see the layouts.  A slot
    count is feasible when *any* candidate layout fits."""
    from repro_torch.kernels.dispatch import resolve_device
    from repro_torch.models.lm import build_served
    from repro_torch.serving.workload import profile_items

    dev = resolve_device(device)
    model, params = build_served(arch, reduced, dev)

    span = workload.duration if workload.duration is not None \
        else probe_duration
    # probe on a capped span: replace the profile's own duration, because
    # profile_items prefers it over the duration argument
    probe_span = min(span, probe_duration)
    probe_wl = dataclasses.replace(workload, duration=probe_span)
    items = profile_items(probe_wl, vocab_size=model.cfg.vocab_size,
                          seed=seed)
    deadlines = any(it.deadline is not None for it in items)

    # --- candidate slot counts: memory feasibility on the full-size
    # config; a slot count qualifies when its cheapest layout fits
    budget = hw_spec.hbm_bytes * HBM_FRACTION
    layouts = candidate_cache_layouts(max_len, block_sizes)
    t_slot = expected_tokens_per_slot(items, max_len)
    feasible, overcommitted = [], False
    for mb in sorted(set(int(b) for b in max_batches)):
        weights, _ = serving_memory_bytes(arch, mb, max_len)
        cheapest = min(cache_layout_bytes(arch, mb, max_len, lay, t_slot)
                       for lay in layouts)
        if weights + cheapest <= budget:
            feasible.append(mb)
    if not feasible:   # weights alone exceed one card: rank anyway, flag it
        overcommitted = True
        feasible = sorted(set(int(b) for b in max_batches))

    policies = ([("fcfs", False), ("edf", False), ("edf", True)]
                if deadlines else [("fcfs", False), ("spf", False)])

    # --- probe: queueing per (max_batch, policy) on the virtual clock
    # (sync_every and buckets do not move virtual-clock schedules, so one
    # probe per scheduling candidate covers the whole plane)
    best_key, best, probed = None, None, []
    for mb in feasible:
        for policy, preempt in policies:
            cand = ServingPlan(arch=arch, reduced=reduced, max_len=max_len,
                               max_batch=mb, policy=policy, preempt=preempt)
            agg = _probe_metrics(cand, model, params, items, seed)
            key = _score(agg)
            probed.append({"max_batch": mb, "policy": policy,
                           "preempt": preempt, "score": list(key)})
            log.debug("probe b%d %s%s -> %s", mb, policy,
                      "+p" if preempt else "", key)
            if best_key is None or key > best_key:
                best_key, best = key, cand

    # --- cost-model dimensions the virtual clock cannot see
    sync = pick_sync_every(arch, best.max_batch, hw_spec, sync_everys,
                           best.preempt)
    lengths = [len(it.prompt) for it in items]
    bsets = candidate_bucket_sets(lengths, max_len)
    costs = [bucket_set_cost(bs, lengths, max_len, arch, hw_spec)
             for bs in bsets]
    buckets = bsets[min(range(len(costs)), key=costs.__getitem__)]

    # --- cache layout: schedules are layout-invariant, so pick by modeled
    # resident bytes at the winning slot count; dense is enumerated first
    # and wins ties, so paging has to save memory to be chosen
    layout_bytes = [(lay, cache_layout_bytes(arch, best.max_batch, max_len,
                                             lay, t_slot))
                    for lay in layouts]
    cache_layout = min(layout_bytes, key=lambda kv: kv[1])[0]

    plan = dataclasses.replace(
        best, sync_every=sync, buckets=buckets, cache_layout=cache_layout,
        tile_plans=tile_plans_for(arch, best.max_batch, hw_spec,
                                  max_len=max_len),
        provenance={"autotune": {
            "hw": hw_spec.name, "seed": seed,
            "probe_duration": probe_span,
            "workload": workload.to_json(),
            "memory_overcommitted": overcommitted,
            "probes": probed,
            "best_score": list(best_key),
            "expected_tokens_per_slot": t_slot,
            "cache_layouts": [
                {"layout": lay, "modeled_bytes": b}
                for lay, b in layout_bytes],
            "bucket_costs": [
                {"buckets": None if b is None else list(b), "cost_s": c}
                for b, c in zip(bsets, costs)],
        }})
    return plan.validate()


def autotune_from_trace(arch: str, trace,
                        hw_spec: hw.HardwareSpec = hw.DEFAULT, *,
                        duration: Optional[float] = None,
                        **kwargs) -> ServingPlan:
    """Re-autotune from *observed* traffic: fit a
    :class:`WorkloadProfile` from a recorded trace (a live
    :class:`repro_torch.obs.Tracer`, a Chrome-trace document, or a file
    path) and search against it: the drift-recovery loop.  Accepts every
    :func:`autotune` keyword (``device`` too); the fit's inputs and
    result are recorded under ``provenance["observed_traffic"]``."""
    from repro_torch.obs.observe import fit_profile, summarize

    profile = fit_profile(trace, duration=duration)
    plan = autotune(arch, profile, hw_spec, **kwargs)
    prov = dict(plan.provenance)
    prov["observed_traffic"] = {
        "fitted_profile": profile.to_json(),
        "trace_summary": summarize(trace),
    }
    return dataclasses.replace(plan, provenance=prov)


__all__ = ["autotune", "autotune_from_trace",
           "serving_memory_bytes",
           "modeled_tick_seconds", "pick_sync_every",
           "candidate_bucket_sets", "bucket_set_cost",
           "cache_layout_bytes", "candidate_cache_layouts",
           "expected_tokens_per_slot",
           "tile_plans_for", "HOST_SYNC_S", "COMPILE_S",
           "PAGE_OVERHEAD_TOKENS"]
