"""Slot-based continuous-batching serving engine (port of
``repro.serving.engine``).

The batched decode step runs every tick over all occupied slots; requests
join by prefilling into a free slot and leave on EOS or length without
disturbing the others.  The engine is mechanism only:

* :mod:`repro_torch.serving.scheduler` owns policy (FCFS / SPF / EDF);
* :mod:`repro_torch.serving.slotstate` owns state (the cache tree and the
  per-slot host mirrors);
* this module runs prefill and the decode ticks and keeps the counters.

A decode chunk runs up to ``sync_every`` ticks: decode step, sample,
EOS / cache-full / budget done-mask and token writeback, exiting when no
slot is active or, with ``stop_on_free``, after the first tick that frees
a slot.  As in the JAX package (a jitted ``lax.while_loop`` over a
donated cache), the chunk runs on the device with one blocking host read
at its end, counted in ``host_syncs``, and the cache is updated in place:
:class:`repro_torch.serving.decode_graph.DecodeLoop` captures the tick
once, when the engine is built on CUDA, and a chunk is one CUDA graph
launch; on the CPU the same tick runs in a Python loop.  So the tick
stamps and every counter, ``host_syncs`` included, equal the JAX
engine's synchronous admission path (``overlap_prefill=False``) at any
``sync_every``.

Admission is bucketed batched prefill: prompts are right-padded to the
smallest bucket of the pow2 set (capped at ``max_len - 1``), and
same-bucket admissions prefill in one call of ``max_batch`` rows (dummy
rows have one valid token); the first tokens are sampled for the whole
batch and the granted rows copied into their slots in one scatter.

The tick-stamp schedule depends only on lengths when requests carry no
``eos_id``, so it equals the JAX engine's tick for tick.  Left for later
slices: ``ServingPlan``/``from_plan``, preemption, ``shed_late``,
``overlap_prefill``, ``truncate_prompts``, the exact-length (unbucketed)
prefill path, paging, faults, checkpoints and the tracer.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.models.lm import LM
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.serving.decode_graph import DecodeLoop
from repro_torch.serving.sampler import SamplerConfig, split_and_sample
from repro_torch.serving.scheduler import SCHEDULERS, Scheduler, \
    make_scheduler
from repro_torch.serving.slotstate import SlotManager

log = logging.getLogger("repro_torch.serving")

MIN_BUCKET = 8   # smallest prefill length bucket (pow2 upward, cap max_len-1)


def default_buckets(max_len: int) -> Tuple[int, ...]:
    """The pow2 bucket set: MIN_BUCKET doubling up to, and capped at,
    ``max_len - 1`` (copied from ``repro.plan.plan``)."""
    limit = max_len - 1
    out: List[int] = []
    b = MIN_BUCKET
    while b < limit:
        out.append(b)
        b *= 2
    out.append(limit)
    return tuple(out)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    deadline: Optional[float] = None   # absolute, clock units (EDF)
    # filled by the engine
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    capped: bool = False          # cache can't hold max_new_tokens
    # tick stamps (engine tick counter)
    t_submit: int = 0             # tick at submission
    t_admit: Optional[int] = None   # tick the prefill ran (slot granted)
    t_first: Optional[int] = None   # tick the first token was produced
    t_done: Optional[int] = None    # tick the request completed


def _decode_many(model: LM, sampler: SamplerConfig, max_len: int, k: int,
                 params, cache, tokens: np.ndarray, gen, active: np.ndarray,
                 eos: np.ndarray, remaining: np.ndarray, limit: int,
                 stop_on_free: bool):
    """One decode chunk of up to ``min(k, limit)`` ticks, run eagerly (a
    Python loop over the tick, no graph) on ``cache`` in place: the JAX
    package's ``_decode_many`` with its arguments.  The engine keeps a
    :class:`DecodeLoop` instead; this is the plain chunk function the
    tests and the card's smoke run hold it to.

    Returns (n_ticks, cache, gen, toks (k,B), acts (k,B), dones (k,B));
    rows >= n_ticks of the buffers are zero.
    """
    loop = DecodeLoop(model, params, cache, sampler, max_len, k, gen,
                      graph=False)
    n, toks, acts, dones = loop.run(tokens, active, eos, remaining, limit,
                                    stop_on_free)
    return n, cache, gen, toks, acts, dones


class ServingEngine:
    """Continuous-batching engine over a :class:`repro_torch.models.lm.LM`.

    Runs on the device the parameters lie on.  ``tile_plans`` (one entry
    per layer kind, e.g. ``{"rwkv": {"impl": "plain"}}`` or
    ``{"attn": {"impl": "plain"}}``) rebinds the model's kernel dispatch;
    without an entry the rwkv decode step and the attention prefill and
    decode run their CUDA kernels on the card."""

    def __init__(self, model: LM, params, *, max_batch: int = 4,
                 max_len: int = 128,
                 sampler: SamplerConfig = SamplerConfig(), seed: int = 0,
                 sync_every: int = 1, policy: str = "fcfs",
                 tile_plans: Optional[Dict[str, dict]] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2 (one prompt token + one "
                             f"generated), got {max_len}")
        if sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, got {sync_every}")
        if sampler.temperature < 0 or sampler.top_k < 0:
            raise ValueError(f"bad sampler {sampler}")
        if policy not in SCHEDULERS:
            raise ValueError(f"policy {policy!r} is not in the scheduler "
                             f"registry {sorted(SCHEDULERS)}")
        if tile_plans:
            model = model.with_tile_plans(tile_plans)
        self.model = model
        self.params = params
        self.device = params["embedding"].device
        self.max_batch = max_batch
        self.max_len = max_len
        self.sampler = sampler
        self.sync_every = int(sync_every)
        self.policy = policy
        self._buckets = default_buckets(max_len)
        # one registry for the stack: scheduler and slot counters too
        self.metrics = MetricsRegistry()
        self.scheduler: Scheduler = make_scheduler(policy,
                                                   registry=self.metrics)
        self.sm = SlotManager(model, max_batch, max_len, device=self.device,
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
        self.finished: List[Request] = []
        self.util_history: List[float] = []  # per-tick (active+instant)/max
        self.prefill_shapes: Set[Tuple[int, int]] = set()  # (rows, S) seen
        self._tick = 0
        self._uid_next = 0
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # the chunk: on CUDA its tick is captured here, with no slot
        # occupied; the cache is updated in place from now on
        self._loop = DecodeLoop(model, params, self.sm.cache, sampler,
                                max_len, self.sync_every, self._gen)

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
        if len(prompt) > limit:
            raise ValueError(f"prompt length {len(prompt)} exceeds "
                             f"max_len-1 = {limit}; raise max_len")
        req = Request(self._uid_next, prompt, max_new_tokens, eos_id,
                      deadline=deadline, t_submit=self._tick)
        self._uid_next += 1
        cap = max(2, self.max_len - len(prompt))
        if max_new_tokens > cap:
            req.capped = True
            log.warning("request %d: max_new_tokens=%d exceeds cache room "
                        "for a %d-token prompt (max_len=%d); output stops "
                        "at %d tokens", req.uid, max_new_tokens,
                        len(prompt), self.max_len, cap)
        self.scheduler.submit(req)
        return req

    def run(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.step():
                break

    def bucket(self, n: int) -> int:
        """Padded prefill length for an n-token prompt: the smallest
        bucket that fits it."""
        for b in self._buckets:
            if b >= n:
                return b
        return self._buckets[-1]

    @property
    def bucket_lengths(self) -> List[int]:
        return list(self._buckets)

    # ------------------------------------------------------------- ticks
    def step(self, max_ticks: Optional[int] = None) -> bool:
        """One host intervention: admit queued requests, run up to
        ``min(sync_every, max_ticks)`` decode ticks, record the ticks.
        Returns False when idle."""
        budget = self.sync_every if max_ticks is None \
            else max(1, min(int(max_ticks), self.sync_every))
        n_instant = self._admit()
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
        n, toks, acts, dones = self._loop.run(
            self.sm.next_token, self.sm.active, self.sm.eos,
            self.sm.remaining, budget, stop_on_free)
        self._c_decode_chunks.inc()
        self._c_decode_ticks.inc(n)
        self._c_host_syncs.inc()   # the chunk's one read
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
                  self._c_completed.value, self._c_total_tokens.value,
                  self._c_host_syncs.value)
        return True

    def _finish(self, req: Request, tick: int) -> None:
        req.done = True
        req.t_done = tick
        self._c_completed.inc()
        self.finished.append(req)

    # -------------------------------------------------------- admission
    def _admit(self) -> int:
        """Admit queued requests into free slots through bucketed batched
        prefill.  Returns how many finished at their prefill token
        (max_new_tokens=1 / instant EOS): those never occupy a slot, so
        further queued requests are retried in the same tick."""
        n_instant = 0
        while len(self.scheduler):
            free = self.sm.free()
            if not free:
                break
            groups: Dict[int, List[Request]] = {}
            for req in self.scheduler.pick(len(free)):
                groups.setdefault(self.bucket(len(req.prompt)),
                                  []).append(req)
            for S, reqs in sorted(groups.items()):
                n_instant += self._prefill_group(S, reqs, free)
        return n_instant

    def _prefill_group(self, S: int, reqs: List[Request],
                       free: List[int]) -> int:
        """One padded batched prefill for same-bucket admissions: sample
        every first token in one call (one blocking read), copy all
        granted rows into their slots in one scatter.  Mutates ``free``
        as slots are granted."""
        rows = self.max_batch
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
        }))
        out["prefill_shapes"] = len(self.prefill_shapes)
        return out


__all__ = ["Request", "ServingEngine", "MIN_BUCKET", "default_buckets"]
