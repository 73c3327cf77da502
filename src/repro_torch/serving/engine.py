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
where a plan, as in the JAX package, defaults to True.  Left for later
slices: faults, checkpoints, the tracer and the live metrics.

Under a paged layout the decode graph reads and writes the manager's
fixed view; around each chunk the engine has the manager cover the
chunk's ring writes and gather the view from its pool
(``ensure_chunk``), and scatter the written view back (``repage``)
before any release frees a block.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.models.lm import LM
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.plan.plan import MIN_BUCKET, ServingPlan, default_buckets
from repro_torch.serving.decode_graph import DecodeLoop
from repro_torch.serving.sampler import SamplerConfig, split_and_sample
from repro_torch.serving.scheduler import Scheduler, make_scheduler
from repro_torch.serving.slotstate import SlotSnapshot, make_slot_manager

log = logging.getLogger("repro_torch.serving")


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


@dataclasses.dataclass
class _PendingAdmit:
    """An overlapped admission group: first tokens still on the device,
    their host bookkeeping left to the decode chunk's read."""

    reqs: List[Request]
    slots: List[int]
    first: torch.Tensor         # (len(slots),) the granted rows' tokens


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
                 plan: Optional[ServingPlan] = None):
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
        self.finished: List[Request] = []
        self.util_history: List[float] = []  # per-tick (active+instant)/max
        self.prefill_shapes: Set[Tuple[int, int]] = set()  # (rows, S) seen
        self._pending: List[_PendingAdmit] = []  # overlapped admissions
        self._tick = 0
        self._uid_next = 0
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # the chunk: on CUDA its tick is captured here, with no slot
        # occupied; the cache is updated in place from now on
        self._loop = DecodeLoop(model, params, self.sm.cache, self.sampler,
                                self.max_len, self.sync_every, self._gen)

    @classmethod
    def from_plan(cls, plan: ServingPlan, params, *,
                  model: Optional[LM] = None,
                  seed: int = 0) -> "ServingEngine":
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
        return cls(model, params, seed=seed, plan=plan)

    # ------------------------------------------------------ read-only views
    @property
    def queue(self):
        return self.scheduler.queue

    @property
    def ticks(self) -> int:
        return self._tick

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
        if (self.shed_late and deadline is not None
                and self._provably_late(req)):
            req.shed = True
            self._c_shed.inc()
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
        """One host intervention: preempt and admit, run up to
        ``min(sync_every, max_ticks)`` decode ticks, record the ticks.
        Returns after the chunk's read; False when idle."""
        budget = self.sync_every if max_ticks is None \
            else max(1, min(int(max_ticks), self.sync_every))
        n_instant = self._schedule()
        active_idx = self.sm.occupied()
        if not active_idx:
            if n_instant:
                # prefill-only tick: every admit finished at its first
                # token.  Real work happened, so time still advances.
                self.util_history.append(n_instant / self.max_batch)
                self._tick += 1
                return True
            return bool(len(self.scheduler))
        # with requests waiting, stop the chunk as soon as a slot frees
        stop_on_free = bool(len(self.scheduler))
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
        # overlapped admissions' first tokens came home on that read
        for p in self._pending:
            for req, slot in zip(p.reqs, p.slots):
                req.output.append(int(tokens_in[slot]))
                self._c_total_tokens.inc()
        self._pending = []
        base = self._tick
        for j in range(n):
            n_active = 0
            for i in active_idx:
                req = self.sm.slots[i]
                if req is None or not acts[j, i]:
                    continue
                n_active += 1
                req.output.append(int(toks[j, i]))
                self._c_total_tokens.inc()
                if dones[j, i]:
                    self._finish(req, base + j)
                    self.sm.release(i)
            self.util_history.append(
                (n_active + (n_instant if j == 0 else 0)) / self.max_batch)
        self._tick += n
        if n > 0:
            self.sm.refresh_after_chunk(toks[n - 1])
        log.debug("chunk of %d ticks -> tick %d: util=%.2f queued=%d "
                  "completed=%d total_tokens=%d syncs=%d", n, self._tick,
                  self.util_history[-1], len(self.scheduler),
                  self.completed, self.total_tokens, self.host_syncs)
        return True

    def _finish(self, req: Request, tick: int) -> None:
        req.done = True
        req.t_done = tick
        self._c_completed.inc()
        self.finished.append(req)

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
        for slot, req, snap in zip(slots, reqs, snaps):
            req.saved = snap
            req.n_preempts += 1
            req.t_preempts.append(self._tick)
            self._c_preemptions.inc()
            self._c_evicted_tokens.inc(len(req.output))
            self.sm.release(slot)
            self.scheduler.requeue_front(req)
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
        return n_instant

    def _prefill_group(self, S: int, reqs: List[Request],
                       free: List[int], overlap: bool) -> int:
        """One padded batched prefill for same-bucket admissions: sample
        every first token in one call, copy all granted rows into their
        slots in one scatter.  Mutates ``free`` as slots are granted.
        Without ``overlap`` the tokens are read at once (one blocking
        read); with it they stay on the device until the next chunk's."""
        rows = self.max_batch if self.bucketed_prefill else len(reqs)
        tokens = np.zeros((rows, S), np.int32)
        lengths = np.ones((rows,), np.int32)   # dummy rows: 1 valid token
        for r_i, req in enumerate(reqs):
            tokens[r_i, :len(req.prompt)] = req.prompt
            lengths[r_i] = len(req.prompt)
        batch = {"tokens": torch.as_tensor(tokens, device=self.device),
                 "lengths": torch.as_tensor(lengths, device=self.device)}
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
            self.sm.insert_from_prefill(slots, range(len(reqs)), cacheN)
            self._pending.append(_PendingAdmit(list(reqs), slots,
                                               first[:len(reqs)]))
            self._c_overlap_prefills.inc()
            return 0
        first = first.cpu().numpy()
        self._c_host_syncs.inc()
        n_instant = 0
        grant_rows, grant_slots = [], []
        for r_i, req in enumerate(reqs):
            tok = int(first[r_i])
            req.output.append(tok)
            self._c_total_tokens.inc()
            req.t_admit = req.t_first = self._tick
            if ((req.eos_id is not None and tok == req.eos_id)
                    or len(req.output) >= req.max_new_tokens):
                # done at the prefill token: never occupies a slot
                self._finish(req, self._tick)
                n_instant += 1
                self._c_instant_admits.inc()
                continue
            slot = free.pop(0)
            self.sm.grant(slot, req, tok)
            grant_rows.append(r_i)
            grant_slots.append(slot)
        if grant_rows:
            self.sm.insert_from_prefill(grant_slots, grant_rows, cacheN)
        return n_instant

    # --------------------------------------------------------- telemetry
    def reset_telemetry(self) -> None:
        """Zero the counters and histories (e.g. after a warm-up run, so
        wall-clock tick timings exclude the first calls' costs).  The
        engine must be drained.  ``prefill_shapes`` survives."""
        if self.has_work():
            raise RuntimeError("reset_telemetry() on a busy engine")
        self.metrics.reset()
        self.finished = []
        self.util_history = []
        self._tick = 0

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


__all__ = ["Request", "ServingEngine", "MIN_BUCKET", "default_buckets"]
