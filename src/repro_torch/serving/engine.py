"""Slot-based continuous-batching serving engine (port of
``repro.serving.engine``).

The batched decode step runs every tick over all occupied slots; requests
join by prefilling into a free slot and leave on EOS or length without
disturbing the others.  The engine is mechanism only:

* :mod:`repro_torch.serving.scheduler` owns policy (FCFS / SPF / EDF, and
  for preemptive EDF which running request to evict);
* :mod:`repro_torch.serving.slotstate` owns state (the cache tree, the
  per-slot host mirrors, slot snapshots), dense or, for a
  ``cache_layout="paged:<block>"`` plan, in block pools
  (:mod:`repro_torch.serving.paged`) behind a fixed dense view;
* :mod:`repro_torch.plan` owns the design point: every constructor knob
  lives in one frozen :class:`~repro_torch.plan.ServingPlan`; build
  engines with :meth:`ServingEngine.from_plan` (the kwargs constructor
  assembles a plan and behaves identically);
* this module runs prefill and the decode ticks and keeps the counters.

A decode chunk runs up to ``sync_every`` ticks: decode step, sample,
EOS / cache-full / budget done-mask and token writeback, exiting when no
slot is active or, with ``stop_on_free``, after the first tick that frees
a slot.  As in the JAX package (a jitted ``lax.while_loop`` over a
donated cache), the chunk runs on the device with one blocking host read
at its end, counted in ``host_syncs``, and the cache is updated in place:
:class:`repro_torch.serving.decode_graph.DecodeLoop` captures the tick
once, when the engine is built on CUDA, and a chunk is one CUDA graph
launch; on the CPU the same tick runs in a Python loop.  ``step`` returns
only after that read, so no device work is left unread between steps.

Admission is bucketed batched prefill: prompts are right-padded to the
smallest bucket of the plan's set (the pow2 set capped at ``max_len - 1``
by default), and same-bucket admissions prefill in one call of
``max_batch`` rows (dummy rows have one valid token); the first tokens
are sampled for the whole batch and the granted rows copied into their
slots in one scatter.  ``bucketed_prefill=False`` is one exact-length
batch-1 call a request.  With ``overlap_prefill`` an admission round
keeps its sampled first tokens on the device: the slots are granted at
once, and the tokens ride home on the next decode chunk's one read
(:meth:`DecodeLoop.run`'s ``first``).  A round in which a request has an
``eos_id`` or a one-token budget takes the synchronous path, whose
instant retirement needs the token on the host.  The schedule is the
same either way; only ``host_syncs`` drops.

Preemptive EDF evicts running requests to the host
(:meth:`ServingEngine.preempt_many`: one read for the whole burst) and
restores them, in place, into whatever slot frees; ``shed_late``
rejects at submit a request that cannot meet its deadline;
``truncate_prompts`` drops a long prompt's tail.

Requests without an ``eos_id`` have a schedule that depends only on
lengths, budgets and deadlines, so it equals the JAX engine's tick for
tick, ``host_syncs`` included, under every policy.  One deliberate
difference: the kwargs constructor defaults to ``overlap_prefill=False``
(the synchronous admission the port had before overlapped admission),
where a plan, as in the JAX package, defaults to True.

Observability (:mod:`repro_torch.obs`): a :class:`~repro_torch.obs.Tracer`
given to the constructor, :meth:`ServingEngine.from_plan` or
:meth:`ServingEngine.restore` records the JAX engine's events at the
JAX engine's call sites, stamped with the same ticks, so a trace's bytes
equal the JAX engine's for the same schedule; :meth:`ServingEngine.
enable_live_metrics` attaches a rolling :class:`~repro_torch.obs.
LiveMetrics` window.  Every hook runs on the host after the chunk's one
read, from values already there (the block tables too, for the paged
counters): tracing adds no device read, no launch and no host sync.
One event is stamped where the JAX engine stamps it rather than where
the work happens: the decode program's ``compile`` instant comes at the
first chunk (where XLA builds it), though on CUDA the decode graph is
captured when the engine is built.  The recovery refresh's read and
``checkpoint()``'s read count in ``host_syncs`` but, as in the JAX
engine, emit no ``host_sync`` instant.

Fault tolerance (inert unless a :class:`repro_torch.serving.faults.
FaultInjector` is attached or the plan's ``watchdog_ticks`` is on, so a
plain engine keeps its schedule, ``stats()`` and ``host_syncs``): a
poisoned slot is caught by a non-finite guard over its cache column
after the chunk, scrubbed and quarantined; its request rolls back to its
last good snapshot (taken after every chunk) or re-prefills, and is shed
once it has spent ``retry_budget`` retries; a dropped readback rolls
back every slot that decoded; a failed prefill re-queues its group; the
watchdog evicts a slot that made no progress for ``watchdog_ticks``.
:meth:`ServingEngine.checkpoint` journals the whole engine between steps
through a :class:`repro_torch.checkpoint.CheckpointManager`, and
:meth:`ServingEngine.restore` builds a new engine (and decode graph)
that replays the rest of the schedule exactly.  Every fault-path writer
of the cache (the scribble, the scrub, a restore) writes the cache's own
tensors in place, as the decode graph holds their addresses; under
paging the view is re-gathered from the pool before it is read and
repaged after it is written.  Fault counters live under ``faults.*`` and
show in :meth:`ServingEngine.fault_stats`, never in ``stats()``.

Under a paged layout the decode graph reads and writes the manager's
fixed view; around each chunk the engine has the manager cover the
chunk's ring writes and gather the view from its pool
(``ensure_chunk``), and scatter the written view back (``repage``)
before any release frees a block.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.models.lm import LM
from repro_torch.models.params import tree_leaves
from repro_torch.obs.registry import LiveMetrics, MetricsRegistry
from repro_torch.obs.trace import Tracer
from repro_torch.plan.plan import MIN_BUCKET, ServingPlan, default_buckets
from repro_torch.serving.decode_graph import DecodeLoop
from repro_torch.serving.sampler import SamplerConfig, split_and_sample
from repro_torch.serving.scheduler import Scheduler, make_scheduler
from repro_torch.serving.slotstate import SlotSnapshot, gather_slots, \
    make_slot_manager, scatter_slots

log = logging.getLogger("repro_torch.serving")


class EngineKilled(RuntimeError):
    """Raised by ``step()`` when the attached fault injector schedules a
    ``kill_engine`` fault at the current tick: the stand-in for a crashed
    process.  ``faults.drive_resilient`` catches it and restores a new
    engine from the last checkpoint."""

    def __init__(self, tick: int):
        super().__init__(f"engine killed by fault injector at tick {tick}")
        self.tick = tick


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    deadline: Optional[float] = None   # absolute, clock units (EDF + SLO)
    # filled by the engine
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    shed: bool = False            # rejected at submit: provably past its
    #                               deadline (plan.shed_late)
    truncated: bool = False       # prompt tail dropped (truncate_prompts)
    capped: bool = False          # cache can't hold max_new_tokens
    retries: int = 0              # fault recoveries spent (rollback or
    #                               re-prefill); shed past plan.retry_budget
    # tick stamps (engine tick counter; see serving.metrics)
    t_submit: int = 0             # tick at submission
    t_admit: Optional[int] = None   # tick the prefill ran (slot granted)
    t_first: Optional[int] = None   # tick the first token was produced
    t_done: Optional[int] = None    # tick the request completed
    # preemption (EDF with preempt): evict-to-host and resume stamps
    n_preempts: int = 0
    t_preempts: List[int] = dataclasses.field(default_factory=list)
    t_resumes: List[int] = dataclasses.field(default_factory=list)
    saved: Optional[SlotSnapshot] = dataclasses.field(
        default=None, repr=False)   # host state while evicted


#: Request fields journaled by ``ServingEngine.checkpoint()``: all but
#: ``saved``, whose cache column travels in the array tree (its
#: ``next_token`` as ``saved_next_token``).
_REQ_FIELDS = ("uid", "prompt", "max_new_tokens", "eos_id", "deadline",
               "output", "done", "shed", "truncated", "capped", "retries",
               "t_submit", "t_admit", "t_first", "t_done",
               "n_preempts", "t_preempts", "t_resumes")


def _req_to_json(req: Request) -> Dict[str, Any]:
    d = {f: getattr(req, f) for f in _REQ_FIELDS}
    if req.saved is not None:
        d["saved_next_token"] = int(req.saved.next_token)
    return d


def _req_from_json(d: Dict[str, Any]) -> Request:
    d = dict(d)
    d.pop("saved_next_token", None)
    return Request(**d)


@dataclasses.dataclass
class _PendingAdmit:
    """An overlapped admission group: first tokens still on the device,
    their host bookkeeping left to the decode chunk's read."""

    reqs: List[Request]
    slots: List[int]
    first: torch.Tensor         # (len(slots),) the granted rows' tokens


def _sorted_leaves(tree) -> List[Any]:
    """A nested dict's leaves in the JAX package's leaf order (keys sorted
    at every level)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _sorted_leaves(tree[k])]
    return [tree]


def _is_reduced(cfg) -> bool:
    """For the kwargs shim: a config that differs from the registry entry
    of its own name is a reduced (or otherwise changed) one."""
    from repro_torch.configs import ARCHS

    return ARCHS.get(cfg.name) != cfg


def _decode_many(model: LM, sampler: SamplerConfig, max_len: int, k: int,
                 params, cache, tokens: np.ndarray, gen, active: np.ndarray,
                 eos: np.ndarray, remaining: np.ndarray, limit: int,
                 stop_on_free: bool, first=None):
    """One decode chunk of up to ``min(k, limit)`` ticks, run eagerly (a
    Python loop over the tick, no graph) on ``cache`` in place: the JAX
    package's ``_decode_many`` with its arguments.  The engine keeps a
    :class:`DecodeLoop` instead; this is the plain chunk function the
    tests and the card's smoke run hold it to.  ``first`` as in
    :meth:`DecodeLoop.run`.

    Returns (n_ticks, cache, gen, toks (k,B), acts (k,B), dones (k,B));
    rows >= n_ticks of the buffers are zero.
    """
    loop = DecodeLoop(model, params, cache, sampler, max_len, k, gen,
                      graph=False)
    n, toks, acts, dones = loop.run(tokens, active, eos, remaining, limit,
                                    stop_on_free, first=first)
    return n, cache, gen, toks, acts, dones


class ServingEngine:
    """Continuous-batching engine over a :class:`repro_torch.models.lm.LM`,
    on the device the parameters lie on.  Plan-driven: every design
    parameter lives in ``engine.plan``; build with :meth:`from_plan`.  The
    kwargs constructor assembles a plan from its arguments (``tile_plans``
    included: e.g. ``{"rwkv": {"impl": "plain"}}``); without an entry the
    rwkv decode step and the attention prefill and decode run their CUDA
    kernels on the card."""

    def __init__(self, model: LM, params, *, max_batch: int = 4,
                 max_len: int = 128,
                 sampler: SamplerConfig = SamplerConfig(), seed: int = 0,
                 truncate_prompts: bool = False, sync_every: int = 1,
                 policy: str = "fcfs", preempt: bool = False,
                 bucketed_prefill: bool = True,
                 overlap_prefill: bool = False, shed_late: bool = False,
                 cache_layout: str = "dense",
                 tile_plans: Optional[Dict[str, dict]] = None,
                 plan: Optional[ServingPlan] = None,
                 tracer: Optional[Tracer] = None):
        if plan is None:   # kwargs shim: capture the knobs as a plan
            plan = ServingPlan(
                arch=model.cfg.name, reduced=_is_reduced(model.cfg),
                max_batch=max_batch, max_len=max_len,
                cache_layout=cache_layout, sync_every=sync_every,
                policy=policy, preempt=preempt,
                bucketed_prefill=bucketed_prefill,
                overlap_prefill=overlap_prefill, shed_late=shed_late,
                temperature=sampler.temperature, top_k=sampler.top_k,
                truncate_prompts=truncate_prompts,
                tile_plans=tile_plans or {},
                provenance={"source": "engine-kwargs"})
        plan.validate()
        if plan.tile_plans:
            model = model.with_tile_plans(plan.tile_plans)
        self.plan = plan
        self.model = model
        self.params = params
        self.device = params["embedding"].device
        self.max_batch = plan.max_batch
        self.max_len = plan.max_len
        self.sampler = SamplerConfig(temperature=plan.temperature,
                                     top_k=plan.top_k)
        self.truncate_prompts = plan.truncate_prompts
        self.sync_every = int(plan.sync_every)
        self.policy = plan.policy
        self.bucketed_prefill = plan.bucketed_prefill
        self.overlap_prefill = plan.overlap_prefill
        self.shed_late = plan.shed_late
        self.cache_layout = plan.cache_layout
        self._paged = plan.cache_layout != "dense"
        self._buckets = plan.resolved_buckets()
        # one registry for the stack: scheduler and slot counters too
        self.metrics = MetricsRegistry()
        self.scheduler: Scheduler = make_scheduler(
            plan.policy, preempt=plan.preempt, registry=self.metrics)
        self.sm = make_slot_manager(model, self.max_batch, self.max_len,
                                    layout=plan.cache_layout,
                                    device=self.device,
                                    registry=self.metrics)
        c = self.metrics.counter
        self._c_completed = c("engine.completed",
                              "requests finished since construction")
        self._c_total_tokens = c("engine.total_tokens",
                                 "tokens generated (prefill + decode)")
        self._c_instant_admits = c("engine.instant_admits",
                                   "requests done at their prefill token")
        self._c_host_syncs = c("engine.host_syncs",
                               "blocking device->host readbacks")
        self._c_decode_chunks = c("engine.decode_chunks",
                                  "decode chunks (one graph launch each "
                                  "on CUDA)")
        self._c_decode_ticks = c("engine.decode_ticks",
                                 "decode ticks run (one decode_step each)")
        self._c_prefill_calls = c("engine.prefill_calls",
                                  "prefill calls")
        self._c_overlap_prefills = c(
            "engine.overlap_prefills",
            "prefill calls whose first tokens rode on a chunk's read")
        self._c_preemptions = c("engine.preemptions",
                                "slots evicted to host")
        self._c_preempt_bursts = c("engine.preempt_bursts",
                                   "eviction bursts (one read each)")
        self._c_resumes = c("engine.resumes",
                            "evicted requests restored to a slot")
        self._c_evicted_tokens = c("engine.evicted_tokens",
                                   "tokens already generated at eviction")
        self._c_shed = c("engine.shed",
                         "requests rejected at submit (admission control)")
        # fault counters: registered always (reset_telemetry covers them)
        # but shown by fault_stats(), never by stats()
        self._c_f_injected = c("faults.injected",
                               "faults fired by the attached injector")
        self._c_f_quarantined = c("faults.quarantined",
                                  "slots quarantined (poison, dropped "
                                  "readback, watchdog)")
        self._c_f_retries = c("faults.retries",
                              "request rollbacks (re-queued from the last "
                              "good snapshot or re-prefilled)")
        self._c_f_shed = c("faults.shed",
                           "requests shed after spending retry_budget")
        self._c_f_watchdog = c("faults.watchdog_evictions",
                               "stuck slots evicted by the watchdog")
        self.finished: List[Request] = []
        self.util_history: List[float] = []  # per-tick (active+instant)/max
        self.prefill_shapes: Set[Tuple[int, int]] = set()  # (rows, S) seen
        self.tracer = tracer          # optional structured event tracer
        self.live: Optional[LiveMetrics] = None   # enable_live_metrics()
        self._decode_compile_traced = False  # the decode compile instant
        self._pending: List[_PendingAdmit] = []  # overlapped admissions
        self._tick = 0
        self._uid_next = 0   # journaled: a restored engine mints the uids
        #                      the dead one would have
        # ---- fault tolerance (inert unless _fault_mode) -----------------
        self.retry_budget = int(plan.retry_budget)
        self.watchdog_ticks = int(plan.watchdog_ticks)
        self._injector = None                   # faults.FaultInjector
        self.fault_events: List[Dict[str, Any]] = []
        self._awaiting: Dict[int, Dict[str, Any]] = {}  # uid -> open event
        # uid -> (last good snapshot or None, outputs it vouches for)
        self._recovery: Dict[int, Tuple[Optional[SlotSnapshot], int]] = {}
        self._stalled: Set[int] = set()         # slots frozen by stall_slot
        self._poison_outstanding: Set[int] = set()  # scribbled, not yet seen
        self._last_progress = np.zeros((self.max_batch,), np.int64)
        self._drop_readback = False   # armed: drop the next chunk's read
        self._fail_prefill = False    # armed: fail the next prefill call
        self._prefill_blocked = False   # a prefill failed this tick
        self.restored_from: Optional[Dict[str, Any]] = None
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # the chunk: on CUDA its tick is captured here, with no slot
        # occupied; the cache is updated in place from now on
        self._loop = DecodeLoop(model, params, self.sm.cache, self.sampler,
                                self.max_len, self.sync_every, self._gen)

    @classmethod
    def from_plan(cls, plan: ServingPlan, params, *,
                  model: Optional[LM] = None,
                  seed: int = 0,
                  tracer: Optional[Tracer] = None) -> "ServingEngine":
        """Build an engine from a plan.  ``model`` defaults to what the
        plan's ``arch`` and ``reduced`` describe; ``shard_mode`` acts on
        nothing (one device).  A plan the port cannot serve yet raises
        ``ValueError`` naming the missing slice."""
        plan.validate()
        if model is None:
            from repro_torch.configs import ARCHS, get_config
            from repro_torch.models.lm import build_model
            from repro_torch.testing import reduced_config

            if plan.arch not in ARCHS:
                raise ValueError(
                    f"plan.arch {plan.arch!r}: the port serves "
                    f"{sorted(ARCHS)} so far; the other archs wait for "
                    f"their slices (ROADMAP Queue 1)")
            cfg = (reduced_config(plan.arch) if plan.reduced
                   else get_config(plan.arch))
            model = build_model(cfg)
        return cls(model, params, seed=seed, plan=plan, tracer=tracer)

    # ------------------------------------------------------ read-only views
    @property
    def queue(self):
        return self.scheduler.queue

    @property
    def ticks(self) -> int:
        return self._tick

    def align_clock(self, tick: int) -> None:
        """Advance the idle tick counter to a shared external clock (never
        rewinds).  Under a solo ``drive()`` the engine's ticks may lag the
        clock while idle, harmlessly: every stamp lives in its one domain.
        A disaggregated fleet exchanges stamps across engines (TTFT on the
        prefill replica, completion on the decode replica), so the router
        aligns every replica to the fleet clock before each round
        (:mod:`repro_torch.serving.router`)."""
        self._tick = max(self._tick, int(tick))

    @property
    def completed(self) -> int:
        return self._c_completed.value

    @property
    def total_tokens(self) -> int:
        return self._c_total_tokens.value

    @property
    def instant_admits(self) -> int:
        return self._c_instant_admits.value

    @property
    def host_syncs(self) -> int:
        return self._c_host_syncs.value

    @property
    def decode_chunks(self) -> int:
        return self._c_decode_chunks.value

    @property
    def prefill_calls(self) -> int:
        return self._c_prefill_calls.value

    @property
    def preemptions(self) -> int:
        return self._c_preemptions.value

    @property
    def resumes(self) -> int:
        return self._c_resumes.value

    @property
    def evicted_tokens(self) -> int:
        return self._c_evicted_tokens.value

    @property
    def shed(self) -> int:
        return self._c_shed.value

    def enable_live_metrics(self, window: int = 64) -> LiveMetrics:
        """Attach a rolling :class:`repro_torch.obs.LiveMetrics` window
        (the last ``window`` ticks); the engine feeds it every tick and
        every retired request.  Returns the window for polling
        (``snapshot()`` / ``line()``)."""
        self.live = LiveMetrics(window)
        return self.live

    # --------------------------------------------------------------- API
    def submit(self, prompt: List[int], max_new_tokens: int = 16,
               eos_id: Optional[int] = None,
               deadline: Optional[float] = None) -> Request:
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}: the prefill always emits "
                             f"one token")
        limit = self.max_len - 1  # >= 1 cache slot left for generation
        truncated = False
        if len(prompt) > limit:
            if not self.truncate_prompts:
                raise ValueError(
                    f"prompt length {len(prompt)} exceeds max_len-1 = "
                    f"{limit}; raise max_len or construct the engine with "
                    f"truncate_prompts=True to drop the tail")
            log.warning("truncating prompt from %d to %d tokens "
                        "(max_len=%d)", len(prompt), limit, self.max_len)
            prompt, truncated = prompt[:limit], True
        req = Request(self._uid_next, prompt, max_new_tokens, eos_id,
                      deadline=deadline, truncated=truncated,
                      t_submit=self._tick)
        self._uid_next += 1
        cap = max(2, self.max_len - len(prompt))
        if max_new_tokens > cap:
            req.capped = True
            log.warning("request %d: max_new_tokens=%d exceeds cache room "
                        "for a %d-token prompt (max_len=%d); output stops "
                        "at %d tokens", req.uid, max_new_tokens,
                        len(prompt), self.max_len, cap)
        if self.tracer is not None:
            # every submission, shed ones too: fit_profile sees the
            # offered load
            self.tracer.request_submit(req, self._tick)
        if (self.shed_late and deadline is not None
                and self._provably_late(req)):
            req.shed = True
            self._c_shed.inc()
            if self.tracer is not None:
                self.tracer.request_shed(req, self._tick)
            if self.live is not None:
                self.live.observe_request(req, self._tick)
            log.debug("shed req %d at tick %d: deadline %.1f < earliest "
                      "completion", req.uid, self._tick, deadline)
            return req
        self.scheduler.submit(req)
        return req

    def _provably_late(self, req: Request) -> bool:
        """True when the request cannot meet its deadline even with a slot
        granted now: the prefill tick plus the remaining decode ticks
        (none with an ``eos_id``: it could stop at the prefill token),
        under the SLO convention ``t_done + 1 <= deadline``.  Exact on the
        virtual clock, where one tick is one deadline unit; a heuristic
        on the wall clock."""
        if req.eos_id is not None:
            min_decode = 0
        else:
            cap = max(2, self.max_len - len(req.prompt))
            min_decode = min(req.max_new_tokens, cap) - 1
        return req.deadline < self._tick + 1 + min_decode

    def has_work(self) -> bool:
        """True while any request is queued or occupying a slot."""
        return bool(len(self.scheduler)) or self.sm.n_active() > 0

    def run(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.step():
                break

    def bucket(self, n: int) -> int:
        """Padded prefill length for an n-token prompt: the smallest
        bucket that fits it (n itself without bucketed prefill)."""
        if not self.bucketed_prefill:
            return n
        for b in self._buckets:
            if b >= n:
                return b
        return self._buckets[-1]

    @property
    def bucket_lengths(self) -> List[int]:
        return list(self._buckets)

    # ------------------------------------------------------------- ticks
    def step(self, max_ticks: Optional[int] = None) -> bool:
        """One host intervention: apply due faults, preempt and admit, run
        up to ``min(sync_every, max_ticks)`` decode ticks, record the
        ticks.  Returns after the chunk's read; False when idle."""
        budget = self.sync_every if max_ticks is None \
            else max(1, min(int(max_ticks), self.sync_every))
        if self._injector is not None:
            self._apply_due_faults()   # may raise EngineKilled
        n_instant = self._schedule()
        if self.tracer is not None:
            self.tracer.counter(self._tick, "queue_depth",
                                len(self.scheduler))
        active_idx = self.sm.occupied()
        if not active_idx:
            if n_instant:
                # prefill-only tick: every admit finished at its first
                # token.  Real work happened, so time still advances.
                self._observe_tick(self._tick, n_instant / self.max_batch)
                self._tick += 1
                return True
            return bool(len(self.scheduler))
        # with requests waiting, stop the chunk as soon as a slot frees
        stop_on_free = bool(len(self.scheduler))
        if self.tracer is not None and not self._decode_compile_traced:
            # stamped where XLA builds the JAX engine's decode program
            # (its first chunk); the graph here was captured at build
            self.tracer.compile(self._tick, "decode", self.max_batch,
                                self.sync_every)
            self._decode_compile_traced = True
        first = None
        if self._pending:
            first = ([s for p in self._pending for s in p.slots],
                     torch.cat([p.first for p in self._pending]))
        tokens_in = self.sm.next_token
        # paged: cover the chunk's ring writes and gather the view it
        # reads; after it, the view back into the pool before a release
        # frees a block (dense: neither does anything)
        self.sm.ensure_chunk(budget)
        n, toks, acts, dones = self._loop.run(
            tokens_in, self.sm.active, self.sm.eos, self.sm.remaining,
            budget, stop_on_free, first=first)
        self.sm.repage()
        self._c_decode_chunks.inc()
        self._c_decode_ticks.inc(n)
        self._c_host_syncs.inc()   # the chunk's one read
        # a dropped readback loses the whole chunk, the overlapped first
        # tokens on it included: every slot that decoded rolls back
        dropped = self._drop_readback and n > 0
        self._drop_readback = False
        if not dropped:
            # overlapped admissions' first tokens came home on that read
            for p in self._pending:
                for req, slot in zip(p.reqs, p.slots):
                    req.output.append(int(tokens_in[slot]))
                    self._c_total_tokens.inc()
        self._pending = []
        if dropped:
            bad = [i for i in active_idx if self.sm.slots[i] is not None
                   and self.sm.active[i]]
        elif self._injector is not None and n > 0:
            bad = self._scan_poisoned(active_idx)
        else:
            bad = []
        bad_set = set(bad)
        progressed: Set[int] = set()
        base = self._tick
        if self.tracer is not None:
            self.tracer.decode_chunk(base, n, len(active_idx))
        for j in range(n):
            n_active = 0
            for i in active_idx:
                req = self.sm.slots[i]
                if req is None or not acts[j, i] or i in bad_set:
                    continue
                n_active += 1
                progressed.add(i)
                req.output.append(int(toks[j, i]))
                self._c_total_tokens.inc()
                if dones[j, i]:
                    self._finish(req, base + j)
                    self.sm.release(i)
            # after tick j's releases: the paged counters read the host
            # block tables as they stand then
            self._observe_tick(
                base + j,
                (n_active + (n_instant if j == 0 else 0)) / self.max_batch)
        self._tick += n
        if self.tracer is not None:
            self.tracer.host_sync(self._tick)
        if n > 0:
            self.sm.refresh_after_chunk(toks[n - 1])
        else:
            # fault mode only: every occupied slot is stalled, so the
            # chunk ran no tick.  Time still advances one tick, so that
            # the watchdog reaches its threshold.
            self._observe_tick(self._tick, n_instant / self.max_batch)
            self._tick += 1
        if self._fault_mode:
            self._fault_epilogue(bad, dropped, progressed)
        log.debug("chunk of %d ticks -> tick %d: util=%.2f queued=%d "
                  "completed=%d total_tokens=%d syncs=%d", n, self._tick,
                  self.util_history[-1], len(self.scheduler),
                  self.completed, self.total_tokens, self.host_syncs)
        return True

    def _finish(self, req: Request, tick: int) -> None:
        req.done = True
        req.t_done = tick
        if self._fault_mode:
            self._recovery.pop(req.uid, None)
        self._c_completed.inc()
        self.finished.append(req)
        if self.tracer is not None:
            self.tracer.request_done(req, tick)
        if self.live is not None:
            self.live.observe_request(req, tick)

    def _observe_tick(self, tick: int, util: float) -> None:
        """One tick's utilization to every observer: the history, the
        live window, the trace's ``util`` track and, for a paged layout,
        the fragmentation tracks (from the host block tables)."""
        self.util_history.append(util)
        if self.live is not None:
            self.live.observe_tick(tick, util)
        if self.tracer is not None:
            self.tracer.counter(tick, "util", util)
            if self._paged:
                self.tracer.counter(tick, "blocks_free",
                                    self.sm.blocks_free())
                self.tracer.counter(tick, "bytes_resident",
                                    self.sm.bytes_resident())
                self.tracer.counter(tick, "padding_waste",
                                    self.sm.padding_waste())

    # --------------------------------------------------- fault tolerance
    @property
    def _fault_mode(self) -> bool:
        """True when the recovery machinery runs: an injector is attached
        or the plan's watchdog is on.  Everything in this section is gated
        on it."""
        return self._injector is not None or self.watchdog_ticks > 0

    def attach_injector(self, injector) -> None:
        """Attach a :class:`repro_torch.serving.faults.FaultInjector`; its
        due faults are applied at the top of every :meth:`step`."""
        if injector.plan.needs_watchdog() and self.watchdog_ticks <= 0:
            raise ValueError(
                "fault plan contains stall_slot faults but the engine's "
                "watchdog is off; set plan.watchdog_ticks > 0 so stalled "
                "requests can be evicted and retried")
        self._injector = injector

    def fault_stats(self) -> Dict[str, float]:
        """The fault counters, apart from :meth:`stats`."""
        return self.metrics.view({
            "injected": "faults.injected",
            "quarantined": "faults.quarantined",
            "retries": "faults.retries",
            "shed": "faults.shed",
            "watchdog_evictions": "faults.watchdog_evictions",
        })

    def _apply_due_faults(self) -> None:
        """Fire every fault due at or before the current tick.  A slot
        fault (poison, stall) stays armed while no slot is occupied, and
        hits the lowest occupied slot when its own slot is free."""
        for idx, spec in self._injector.due(self._tick):
            if spec.kind == "kill_engine":
                self._injector.fire(idx, self._tick)
                self._c_f_injected.inc()
                self.fault_events.append(
                    {"kind": "kill_engine", "tick": self._tick,
                     "uid": None, "slot": None, "recovered_at": None})
                if self.tracer is not None:
                    self.tracer.engine_fault(self._tick, "kill_engine")
                raise EngineKilled(self._tick)
            if spec.kind == "drop_readback":
                self._injector.fire(idx, self._tick)
                self._c_f_injected.inc()
                self._drop_readback = True
                if self.tracer is not None:
                    self.tracer.engine_fault(self._tick, "drop_readback")
            elif spec.kind == "fail_prefill":
                self._injector.fire(idx, self._tick)
                self._c_f_injected.inc()
                self._fail_prefill = True
            else:   # poison_slot / stall_slot need an occupied victim
                occ = self.sm.occupied()
                if not occ:
                    continue   # not fired: stays due for a later tick
                slot = spec.slot if spec.slot in occ else occ[0]
                self._injector.fire(idx, self._tick)
                self._c_f_injected.inc()
                if self.tracer is not None:
                    self.tracer.engine_fault(self._tick, spec.kind,
                                             slot=slot)
                if spec.kind == "poison_slot":
                    self._poison(slot, spec)
                else:
                    self._stalled.add(slot)
                    self.sm.active[slot] = False

    def _poison(self, slot: int, spec) -> None:
        """Overwrite every float leaf of ``slot``'s cache column, in place:
        NaN (``mode="nan"``) or seeded garbage of magnitude ~1e30 salted
        with +Inf and one -Inf (``mode="garbage"``), drawn leaf by leaf in
        the JAX package's leaf order (sorted keys), so the scribble is the
        JAX one.  Both trip the guard scan after the next chunk."""
        self.sm.materialize()
        col = gather_slots(self.sm.cache, self.sm.axes, [slot])
        rng = np.random.default_rng(spec.seed)
        for leaf in _sorted_leaves(col):
            if not leaf.is_floating_point():
                continue
            if spec.mode == "nan":
                leaf.fill_(float("nan"))
                continue
            g = (rng.standard_normal(tuple(leaf.shape)) * 1e30).astype(
                np.float32)
            g[rng.uniform(size=tuple(leaf.shape)) < 0.25] = np.inf
            g.reshape(-1)[0] = -np.inf   # at least one non-finite value
            leaf.copy_(torch.from_numpy(g))
        scatter_slots(self.sm.cache, self.sm.axes, [slot], col)
        self.sm.repage()
        self._poison_outstanding.add(slot)

    def _scan_poisoned(self, active_idx: List[int]) -> List[int]:
        """The non-finite guard: over every float cache leaf, reduced on
        the device to one (max_batch,) flag vector and read once (not
        counted in ``host_syncs``, as in the JAX engine); runs only while
        a poison is outstanding."""
        self._poison_outstanding = {
            s for s in self._poison_outstanding
            if self.sm.slots[s] is not None}
        if not self._poison_outstanding:
            return []
        self.sm.materialize()
        checks = []
        for leaf, ax in zip(tree_leaves(self.sm.cache),
                            tree_leaves(self.sm.axes)):
            if leaf.is_floating_point():
                bad = ~torch.isfinite(leaf.movedim(ax, 0))
                checks.append(bad.reshape(bad.shape[0], -1).any(dim=1))
        flags = torch.stack(checks).any(dim=0).cpu().numpy()
        caught = [i for i in active_idx
                  if flags[i] and self.sm.slots[i] is not None]
        self._poison_outstanding -= set(caught)
        return caught

    def _quarantine(self, slot: int, tick: int, kind: str) -> None:
        """Pull a bad slot out of service: scrub its column (nothing left
        for the next tenant), release the slot, roll the request back."""
        req = self.sm.slots[slot]
        self._c_f_quarantined.inc()
        if kind == "watchdog":
            self._c_f_watchdog.inc()
        self.sm.scrub([slot])
        self.sm.release(slot)
        self._stalled.discard(slot)
        self._poison_outstanding.discard(slot)
        self._rollback(req, tick, kind, slot)

    def _rollback(self, req: Request, tick: int, kind: str,
                  slot: Optional[int] = None) -> None:
        """Re-queue ``req`` from its last good recovery point (from scratch
        when it has none), charging one retry; past the budget the request
        is shed: the engine never emits a token it cannot vouch for."""
        event = {"kind": kind, "tick": tick, "uid": req.uid, "slot": slot,
                 "recovered_at": None}
        self.fault_events.append(event)
        self._awaiting[req.uid] = event
        if self.tracer is not None:
            self.tracer.request_fault(req, tick, kind, slot)
        req.retries += 1
        rp = self._recovery.get(req.uid)
        if req.retries > self.retry_budget:
            req.shed = True
            event["shed"] = True
            event["recovered_at"] = tick
            self._awaiting.pop(req.uid, None)
            self._recovery.pop(req.uid, None)
            self._c_f_shed.inc()
            if self.tracer is not None:
                self.tracer.request_quarantine(req, tick, tick)
                self.tracer.request_shed(req, tick)
            if self.live is not None:
                self.live.observe_request(req, tick)
            log.debug("shed req %d at tick %d: retry budget %d spent (%s)",
                      req.uid, tick, self.retry_budget, kind)
            return
        self._c_f_retries.inc()   # re-queues, not the shedding try
        if rp is not None:
            snap, n_out = rp
            del req.output[n_out:]
            req.saved = snap
        else:
            del req.output[:]
            req.saved = None
        self.scheduler.requeue_front(req)
        if self.tracer is not None:
            self.tracer.request_retry(req, tick, req.retries)
        log.debug("rolled back req %d at tick %d (%s, retry %d/%d, %d "
                  "tokens kept)", req.uid, tick, kind, req.retries,
                  self.retry_budget, len(req.output))

    def _mark_recovered(self, req: Request) -> None:
        """A rolled-back request is back in a slot: close its fault
        event and emit the quarantine span (fault tick -> now)."""
        event = self._awaiting.pop(req.uid, None)
        if event is None:
            return
        event["recovered_at"] = self._tick
        if self.tracer is not None:
            self.tracer.request_quarantine(req, event["tick"], self._tick)

    def _fault_epilogue(self, bad: List[int], dropped: bool,
                        progressed: Set[int]) -> None:
        """After a chunk: quarantine the flagged slots, run the watchdog,
        re-freeze the stalled slots over the refreshed mirrors, and take
        every survivor's recovery point."""
        for i in progressed:
            self._last_progress[i] = self._tick
        for i in bad:
            if self.sm.slots[i] is not None:
                self._quarantine(i, self._tick,
                                 "drop_readback" if dropped else "poison")
        # refresh_after_chunk made every occupied slot active again
        for i in list(self._stalled):
            if self.sm.slots[i] is None:
                self._stalled.discard(i)
            else:
                self.sm.active[i] = False
        if self.watchdog_ticks > 0:
            for i in self.sm.occupied():
                if self._tick - self._last_progress[i] >= self.watchdog_ticks:
                    self._quarantine(i, self._tick, "watchdog")
        self._refresh_recovery()

    def _refresh_recovery(self) -> None:
        """Snapshot every occupied slot as its request's last good recovery
        point (one read for all, counted in ``host_syncs``).  Stalled slots
        are skipped: the chunk advances every lane's device state, so a
        stalled slot's column drifts from its frozen outputs and its
        recovery point must stay the one from before the stall."""
        occ = [i for i in self.sm.occupied() if i not in self._stalled]
        if not occ:
            return
        snaps = self.sm.snapshot_many(occ)
        self._c_host_syncs.inc()
        for slot, snap in zip(occ, snaps):
            req = self.sm.slots[slot]
            self._recovery[req.uid] = (snap, len(req.output))

    # -------------------------------------------------------- scheduling
    def preempt(self, slot: int) -> Request:
        """Evict the request in ``slot`` to the host and requeue it."""
        return self.preempt_many([slot])[0]

    def preempt_many(self, slots: List[int]) -> List[Request]:
        """Evict running requests to host memory and requeue them, in
        ``slots`` order, with one device-to-host read for the whole burst
        (:meth:`SlotManager.snapshot_many`).  A victim resumes where it
        left off once the scheduler grants it a slot again (bit-exactly
        under greedy decoding)."""
        if not slots:
            return []
        reqs: List[Request] = []
        for slot in slots:
            if self.sm.slots[slot] is None:
                raise ValueError(f"slot {slot} is empty")
            reqs.append(self.sm.slots[slot])
        snaps = self.sm.snapshot_many(slots)
        self._c_host_syncs.inc()
        self._c_preempt_bursts.inc()
        if self.tracer is not None:
            self.tracer.host_sync(self._tick)
        for slot, req, snap in zip(slots, reqs, snaps):
            req.saved = snap
            req.n_preempts += 1
            req.t_preempts.append(self._tick)
            self._c_preemptions.inc()
            self._c_evicted_tokens.inc(len(req.output))
            self.sm.release(slot)
            self.scheduler.requeue_front(req)
            if self.tracer is not None:
                self.tracer.request_preempt(req, self._tick, slot,
                                            len(req.output))
            log.debug("preempted req %d from slot %d at tick %d "
                      "(%d tokens evicted to host)", req.uid, slot,
                      self._tick, len(req.output))
        return reqs

    def _schedule(self) -> int:
        """Preempt (if the policy does), then admit.  Returns how many
        admits finished at their prefill token."""
        if self.scheduler.preemptive and len(self.scheduler):
            victims = self.scheduler.victims(self.sm.running(),
                                             len(self.sm.free()))
            if victims:
                self.preempt_many(victims)
        return self._admit()

    def _admit(self) -> int:
        """Admit queued requests into free slots: evicted ones restored
        from their snapshots (no model call), fresh ones through prefill.
        Returns how many finished at their prefill token (those never
        occupy a slot, so further queued requests are tried in the same
        tick)."""
        n_instant = 0
        while len(self.scheduler):
            free = self.sm.free()
            if not free:
                break
            picked = self.scheduler.pick(len(free))
            fresh = [r for r in picked if r.saved is None]
            for req in (r for r in picked if r.saved is not None):
                slot = free.pop(0)
                self.sm.restore(slot, req.saved, req)
                req.saved = None
                req.t_resumes.append(self._tick)
                self._c_resumes.inc()
                if self._fault_mode:
                    self._last_progress[slot] = self._tick
                    self._mark_recovered(req)
                if self.tracer is not None:
                    self.tracer.request_resume(req, self._tick, slot)
                log.debug("resumed req %d into slot %d at tick %d",
                          req.uid, slot, self._tick)
            if not fresh:
                continue
            if self.bucketed_prefill:
                groups: Dict[int, List[Request]] = {}
                for req in fresh:
                    groups.setdefault(self.bucket(len(req.prompt)),
                                      []).append(req)
                grouped = sorted(groups.items())
            else:
                # one exact-length batch-1 prefill a request
                grouped = [(len(r.prompt), [r]) for r in fresh]
            # instant retirement needs the sampled token on the host
            overlap = (self.overlap_prefill
                       and not any(r.eos_id is not None
                                   or r.max_new_tokens == 1 for r in fresh))
            for S, reqs in grouped:
                n_instant += self._prefill_group(S, reqs, free, overlap)
            if self._prefill_blocked:
                # a fault failed a prefill call and re-queued its group:
                # stop admitting this tick, or the same requests would be
                # picked again in an endless loop
                self._prefill_blocked = False
                break
        return n_instant

    def _prefill_group(self, S: int, reqs: List[Request],
                       free: List[int], overlap: bool) -> int:
        """One padded batched prefill for same-bucket admissions: sample
        every first token in one call, copy all granted rows into their
        slots in one scatter.  Mutates ``free`` as slots are granted.
        Without ``overlap`` the tokens are read at once (one blocking
        read); with it they stay on the device until the next chunk's."""
        if self._fail_prefill:
            # injected fault: the prefill call fails before its launch.
            # The whole group rolls back (a fresh request re-prefills,
            # charged one retry) and admission stops this tick.
            self._fail_prefill = False
            self._prefill_blocked = True
            self.fault_events.append(
                {"kind": "fail_prefill", "tick": self._tick, "uid": None,
                 "slot": None, "recovered_at": None})
            if self.tracer is not None:
                self.tracer.engine_fault(self._tick, "fail_prefill",
                                         rows=len(reqs))
            for req in reqs:
                self._rollback(req, self._tick, "fail_prefill")
            return 0
        rows = self.max_batch if self.bucketed_prefill else len(reqs)
        tokens = np.zeros((rows, S), np.int32)
        lengths = np.ones((rows,), np.int32)   # dummy rows: 1 valid token
        for r_i, req in enumerate(reqs):
            tokens[r_i, :len(req.prompt)] = req.prompt
            lengths[r_i] = len(req.prompt)
        batch = {"tokens": torch.as_tensor(tokens, device=self.device),
                 "lengths": torch.as_tensor(lengths, device=self.device)}
        if self.tracer is not None:
            if (rows, S) not in self.prefill_shapes:
                self.tracer.compile(self._tick, "prefill", rows, S)
            self.tracer.prefill(self._tick, S, rows, len(reqs), overlap)
        cacheN, logitsN = self.model.prefill(self.params, batch,
                                             max_len=self.max_len)
        self._c_prefill_calls.inc()
        self.prefill_shapes.add((rows, S))
        self._gen, first = split_and_sample(self._gen, logitsN, self.sampler)
        if overlap:
            slots = [free.pop(0) for _ in reqs]
            for req, slot in zip(reqs, slots):
                self.sm.grant(slot, req, None)
                req.t_admit = req.t_first = self._tick
                if self._fault_mode:
                    self._last_progress[slot] = self._tick
                    self._mark_recovered(req)
            self.sm.insert_from_prefill(slots, range(len(reqs)), cacheN)
            self._pending.append(_PendingAdmit(list(reqs), slots,
                                               first[:len(reqs)]))
            self._c_overlap_prefills.inc()
            return 0
        first = first.cpu().numpy()
        self._c_host_syncs.inc()
        if self.tracer is not None:
            self.tracer.host_sync(self._tick)
        n_instant = 0
        grant_rows, grant_slots = [], []
        for r_i, req in enumerate(reqs):
            tok = int(first[r_i])
            req.output.append(tok)
            self._c_total_tokens.inc()
            req.t_admit = req.t_first = self._tick
            if self._fault_mode:
                self._mark_recovered(req)
            if ((req.eos_id is not None and tok == req.eos_id)
                    or len(req.output) >= req.max_new_tokens):
                # done at the prefill token: never occupies a slot
                self._finish(req, self._tick)
                n_instant += 1
                self._c_instant_admits.inc()
                continue
            slot = free.pop(0)
            self.sm.grant(slot, req, tok)
            if self._fault_mode:
                self._last_progress[slot] = self._tick
            grant_rows.append(r_i)
            grant_slots.append(slot)
        if grant_rows:
            self.sm.insert_from_prefill(grant_slots, grant_rows, cacheN)
        return n_instant

    # ------------------------------------------------------ crash restart
    def all_requests(self) -> List[Request]:
        """Every request the engine tracks: finished, in a slot, queued (in
        that order).  Requests shed at submit are in none of them."""
        out: List[Request] = list(self.finished)
        out.extend(r for r in self.sm.slots if r is not None)
        out.extend(self.scheduler.queue)
        return out

    def checkpoint(self, manager, *, clock_now: Optional[float] = None,
                   blocking: bool = True) -> int:
        """Journal the whole engine through a :class:`repro_torch.
        checkpoint.CheckpointManager` step named by the current tick: the
        generator's state (under the JAX package's ``key``), the slot
        mirrors, every occupied slot's cache column (one read for all,
        counted in ``host_syncs``) and every evicted snapshot's as the
        array tree; requests, queue order, tick, uid counter, fault state
        and counters as JSON ``extra``, the JAX engine's fields.  Between
        steps only (no overlapped admission in flight)."""
        if self._pending:
            raise RuntimeError("checkpoint() with overlapped admissions "
                               "in flight; call between steps")
        from repro_torch.plan import io as plan_io

        occ = self.sm.occupied()
        slot_cols: Dict[str, Any] = {}
        slots_json: Dict[str, Any] = {}
        if occ:
            snaps = self.sm.snapshot_many(occ)
            self._c_host_syncs.inc()
            for slot, snap in zip(occ, snaps):
                slot_cols[f"s{slot}"] = snap.cache_col
                slots_json[str(slot)] = _req_to_json(self.sm.slots[slot])
        saved_cols: Dict[str, Any] = {}
        queue_json: List[Dict[str, Any]] = []
        for req in self.scheduler.queue:
            queue_json.append(_req_to_json(req))
            if req.saved is not None:
                saved_cols[f"u{req.uid}"] = req.saved.cache_col
        state = {
            "key": self._gen.get_state(),
            "next_token": np.asarray(self.sm.next_token),
            "active": np.asarray(self.sm.active),
            "eos": np.asarray(self.sm.eos),
            "remaining": np.asarray(self.sm.remaining),
            "slot_cols": slot_cols,
            "saved_cols": saved_cols,
        }
        extra = {"engine": {
            "plan": plan_io.to_dict(self.plan.resolve()),
            "tick": self._tick,
            "uid_next": self._uid_next,
            "clock_now": clock_now,
            "slots": slots_json,
            "queue": queue_json,
            "finished": [_req_to_json(r) for r in self.finished],
            "stalled": sorted(self._stalled),
            "last_progress": [int(x) for x in self._last_progress],
            "util_history": list(self.util_history),
            "counters": {
                "total_tokens": self.total_tokens,
                "instant_admits": self.instant_admits,
                "shed": self.shed,
                "faults": {k: int(v) for k, v in self.fault_stats().items()},
            },
        }}
        manager.save(self._tick, state, extra=extra, blocking=blocking)
        return self._tick

    @classmethod
    def restore(cls, manager, params, *, model: Optional[LM] = None,
                step: Optional[int] = None,
                tracer: Optional[Tracer] = None) -> "ServingEngine":
        """A new engine from a :meth:`checkpoint` step (the latest when
        ``step`` is None).  Built by :meth:`from_plan` (on CUDA with its
        own decode graph, captured on its empty cache), then every
        journaled column is written into its slot in place and the rest
        of the state set, so its remaining schedule (tick stamps,
        outputs, the uids of replayed submissions) is the uninterrupted
        engine's.  ``tracer`` goes on recording on the new engine (a
        trace across a crash restart)."""
        if step is None:
            step = manager.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoint steps under {manager.directory}")
        extra = manager.manifest(step).get("extra") or {}
        if "engine" not in extra:
            raise ValueError(
                f"checkpoint step {step} was not written by "
                f"ServingEngine.checkpoint(): no 'engine' extra")
        ex = extra["engine"]
        from repro_torch.plan import io as plan_io

        eng = cls.from_plan(plan_io.from_dict(ex["plan"]), params,
                            model=model, tracer=tracer)
        occ = sorted(int(k) for k in ex["slots"])
        saved_uids = [d["uid"] for d in ex["queue"]
                      if "saved_next_token" in d]
        col = eng.sm.column_template()
        template = {
            "key": eng._gen.get_state(),
            "next_token": np.asarray(eng.sm.next_token),
            "active": np.asarray(eng.sm.active),
            "eos": np.asarray(eng.sm.eos),
            "remaining": np.asarray(eng.sm.remaining),
            "slot_cols": {f"s{i}": col for i in occ},
            "saved_cols": {f"u{u}": col for u in saved_uids},
        }
        st = manager.restore(template, step=step)
        # slot-resident requests first, through the slot manager's own
        # restore (in place; under paging it covers the slot's tokens,
        # then repages)
        for i in occ:
            req = _req_from_json(ex["slots"][str(i)])
            snap = SlotSnapshot(st["slot_cols"][f"s{i}"],
                                int(st["next_token"][i]))
            eng.sm.restore(i, snap, req)
            eng._recovery[req.uid] = (snap, len(req.output))
        # then the mirrors as journaled (restore derived them: stalled
        # slots and mid-flight budgets need the exact values)
        eng.sm.next_token[:] = st["next_token"]
        eng.sm.active[:] = st["active"]
        eng.sm.eos[:] = st["eos"]
        eng.sm.remaining[:] = st["remaining"]
        eng._gen.set_state(st["key"])
        for d in ex["queue"]:
            nt = d.get("saved_next_token")
            req = _req_from_json(d)
            if nt is not None:
                req.saved = SlotSnapshot(st["saved_cols"][f"u{req.uid}"],
                                         int(nt))
            eng.scheduler.submit(req)
        for d in ex["finished"]:
            eng.finished.append(_req_from_json(d))
            eng._c_completed.inc()
        c = ex.get("counters", {})
        eng._c_total_tokens.inc(int(c.get("total_tokens", 0)))
        eng._c_instant_admits.inc(int(c.get("instant_admits", 0)))
        eng._c_shed.inc(int(c.get("shed", 0)))
        fc = c.get("faults", {})
        for ctr, key in ((eng._c_f_injected, "injected"),
                         (eng._c_f_quarantined, "quarantined"),
                         (eng._c_f_retries, "retries"),
                         (eng._c_f_shed, "shed"),
                         (eng._c_f_watchdog, "watchdog_evictions")):
            ctr.inc(int(fc.get(key, 0)))
        eng._tick = int(ex["tick"])
        eng._uid_next = int(ex["uid_next"])
        eng.util_history = list(ex.get("util_history", []))
        eng._stalled = set(int(s) for s in ex.get("stalled", []))
        eng._last_progress[:] = np.asarray(ex["last_progress"],
                                           dtype=np.int64)
        eng.restored_from = {"step": step, "clock_now": ex["clock_now"]}
        return eng

    def close(self) -> None:
        """Release the decode graph and drop the cache (the engine serves
        no more): a killed engine's, before its successor captures."""
        if self._loop is not None:
            self._loop.close()
        self._loop = None
        self.sm = None

    # --------------------------------------------------------- telemetry
    def reset_telemetry(self) -> None:
        """Zero the counters and histories (e.g. after a warm-up run, so
        wall-clock tick timings exclude the first calls' costs).  The
        engine must be drained.  ``prefill_shapes`` survives; the live
        window and an attached tracer restart empty at tick 0."""
        if self.has_work():
            raise RuntimeError("reset_telemetry() on a busy engine")
        self.metrics.reset()
        self.finished = []
        self.util_history = []
        self._tick = 0
        if self.live is not None:
            self.live.reset()
        if self.tracer is not None:
            self.tracer.reset()

    def stats(self) -> Dict[str, float]:
        util = self.util_history
        out: Dict[str, float] = {
            "active": self.sm.n_active(),
            "queued": len(self.scheduler),
        }
        out.update(self.metrics.view({
            "completed": "engine.completed",
            "total_tokens": "engine.total_tokens",
        }))
        out["ticks"] = self._tick
        out["mean_util"] = sum(util) / len(util) if util else 0.0
        out.update(self.metrics.view({
            "instant_admits": "engine.instant_admits",
            "host_syncs": "engine.host_syncs",
            "decode_chunks": "engine.decode_chunks",
            "decode_ticks": "engine.decode_ticks",
            "prefill_calls": "engine.prefill_calls",
            "overlap_prefills": "engine.overlap_prefills",
        }))
        out["prefill_shapes"] = len(self.prefill_shapes)
        out.update(self.metrics.view({
            "preemptions": "engine.preemptions",
            "preempt_bursts": "engine.preempt_bursts",
            "resumes": "engine.resumes",
            "evicted_tokens": "engine.evicted_tokens",
            "shed": "engine.shed",
        }))
        return out


__all__ = ["Request", "ServingEngine", "EngineKilled", "MIN_BUCKET",
           "default_buckets"]
