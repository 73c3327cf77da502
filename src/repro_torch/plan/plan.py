"""``ServingPlan``: every serving design parameter behind one frozen object
(port of ``repro.plan.plan``).

* :class:`ServingPlan` — a frozen, JSON-round-trippable dataclass that is
  the single source of truth for the engine's design parameters.  Its
  fields and defaults are the JAX package's, field for field, so a JAX
  ``serving_plan/v1`` dict loads here unchanged and the port's loads
  there.  :meth:`repro_torch.serving.engine.ServingEngine.from_plan`
  builds an engine from one.
* :class:`WorkloadProfile` — the workload half of a serving cell (arrival
  process, prompt and decode length distributions, deadlines);
  :func:`repro_torch.serving.workload.profile_items` materializes it.
* :class:`FleetPlan` — N replica plans behind the router
  (:class:`repro_torch.serving.router.Router`), a routing policy and the
  prefill/decode split, field for field the JAX package's but for one
  default: ``hw`` names a spec of :data:`repro_torch.hw.SPECS`
  (``"h100-sxm"``), so a JAX fleet dict that names ``"tpu-v5e"`` loads
  and is refused by ``validate``.

``tile_plans`` entries take the port's vocabulary on top of the JAX
package's: the impls of :mod:`repro_torch.kernels.dispatch` (``plain``
and ``kernel`` besides ``auto``/``jnp``/``pallas``) and the port-only
``splits`` key of ``matmul_int8`` (K splits of the decode kernel, 0 =
the default).  A persistent entry's ``vmem_bytes`` is held to the
card's shared-memory budget (:func:`repro_torch.hw.smem_budget`).

Stdlib only at import: the scheduler and router registries, the
dispatch impls and the hardware specs are imported where they are
checked.  ``WorkloadProfile.from_trace`` fits a profile from a recorded
trace (:func:`repro_torch.obs.observe.fit_profile`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

MIN_BUCKET = 8   # smallest prefill length bucket (pow2 upward, cap max_len-1)


def parse_cache_layout(layout: str) -> Optional[int]:
    """``"dense"`` -> None; ``"paged:<block_size>"`` -> the positive int
    block size.  Raises ``ValueError`` on anything else."""
    if layout == "dense":
        return None
    if isinstance(layout, str) and layout.startswith("paged:"):
        tail = layout[len("paged:"):]
        try:
            block = int(tail)
        except ValueError:
            block = 0
        if block >= 1 and str(block) == tail:
            return block
    raise ValueError(
        f"cache_layout must be 'dense' or 'paged:<block_size>' with a "
        f"positive integer block size, got {layout!r}")


def default_buckets(max_len: int) -> Tuple[int, ...]:
    """The pow2 bucket set: MIN_BUCKET doubling up to, and capped at,
    ``max_len - 1``."""
    limit = max_len - 1
    out: List[int] = []
    b = MIN_BUCKET
    while b < limit:
        out.append(b)
        b *= 2
    out.append(limit)
    return tuple(out)


def _jsonify(x):
    """Nested containers as plain JSON types, so a plan that round-trips
    through JSON compares equal to the original."""
    if isinstance(x, Mapping):
        return {str(k): _jsonify(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonify(v) for v in x]
    if isinstance(x, bool) or x is None or isinstance(x, (int, float, str)):
        return x
    return str(x)


@dataclasses.dataclass(frozen=True)
class WorkloadProfile:
    """What arrives, how long it is and what SLO it carries.  Every field
    mirrors the :func:`repro_torch.serving.workload.make_workload`
    argument of its name; ``duration=None`` means the caller decides."""

    kind: str = "poisson"                    # workload.ARRIVAL_KINDS
    rate: float = 0.5                        # requests per clock unit
    duration: Optional[float] = None         # span in clock units
    prompt_len: Tuple[int, int] = (4, 12)
    max_new_tokens: Tuple[int, int] = (8, 16)
    prompt_dist: str = "uniform"             # workload.PROMPT_DISTS
    prompt_len_long: Optional[int] = None    # long-tail cap
    heavy_decode: Optional[Tuple[float, int, int]] = None
    deadline_slack: Optional[float] = None   # decode-proportional SLO
    deadline_frac: float = 1.0
    burst_factor: float = 4.0                # mmpp only
    dwell: Tuple[float, float] = (16.0, 4.0)  # mmpp only
    trace_path: Optional[str] = None         # kind == "trace"

    def __post_init__(self):
        object.__setattr__(self, "prompt_len", tuple(self.prompt_len))
        object.__setattr__(self, "max_new_tokens",
                           tuple(self.max_new_tokens))
        object.__setattr__(self, "dwell", tuple(self.dwell))
        if self.heavy_decode is not None:
            f, lo, hi = self.heavy_decode
            object.__setattr__(self, "heavy_decode",
                               (float(f), int(lo), int(hi)))

    @property
    def has_deadlines(self) -> bool:
        return self.deadline_slack is not None and self.deadline_frac > 0

    def mean_decode(self) -> float:
        """Expected decode length of a request (its slot-occupancy ticks on
        the virtual clock)."""
        lo, hi = self.max_new_tokens
        mean = (lo + hi) / 2.0
        if self.heavy_decode is not None:
            f, hlo, hhi = self.heavy_decode
            mean = (1 - f) * mean + f * (hlo + hhi) / 2.0
        return mean

    def to_json(self) -> Dict[str, object]:
        return _jsonify(dataclasses.asdict(self))

    @staticmethod
    def from_json(d: Mapping[str, object]) -> "WorkloadProfile":
        return WorkloadProfile(**dict(d))

    @staticmethod
    def from_trace(trace, *, kind: str = "poisson",
                   duration: Optional[float] = None) -> "WorkloadProfile":
        """Fit a profile from *observed* traffic: a recorded
        :class:`repro_torch.obs.Tracer` (live object, exported Chrome-trace
        document, or file path).  See
        :func:`repro_torch.obs.observe.fit_profile` for the estimators."""
        from repro_torch.obs.observe import fit_profile

        return fit_profile(trace, kind=kind, duration=duration)


@dataclasses.dataclass(frozen=True)
class ServingPlan:
    """One serving design point.  Field groups, in order: model identity
    (``arch``, ``reduced``, ``shard_mode`` — kept for the round trip; the
    port serves on one device and reads it nowhere); capacity
    (``max_batch`` slots over a ``max_len`` cache, ``cache_layout``);
    admission (``bucketed_prefill``, ``buckets``; None = the pow2 set);
    the decode hot path (``sync_every`` ticks a chunk,
    ``overlap_prefill``); scheduling (``policy``, ``preempt``,
    ``shed_late``); sampling (``temperature``, ``top_k``);
    ``truncate_prompts``; fault tolerance (``retry_budget``: recoveries
    a request may spend before it is shed; ``watchdog_ticks``: evict a
    slot after that many ticks without progress, 0 = off); per-kernel
    ``tile_plans``; ``provenance``, which never affects behavior."""

    # --- model identity --------------------------------------------------
    arch: str
    reduced: bool = True
    shard_mode: str = "decode"
    # --- capacity --------------------------------------------------------
    max_batch: int = 4
    max_len: int = 128
    cache_layout: str = "dense"   # or "paged:<block_size>"
    # --- admission -------------------------------------------------------
    bucketed_prefill: bool = True
    buckets: Optional[Tuple[int, ...]] = None
    # --- decode hot path -------------------------------------------------
    sync_every: int = 1
    overlap_prefill: bool = True
    # --- scheduling ------------------------------------------------------
    policy: str = "fcfs"
    preempt: bool = False
    shed_late: bool = False
    # --- sampling --------------------------------------------------------
    temperature: float = 0.0
    top_k: int = 0
    # --- misc engine behavior -------------------------------------------
    truncate_prompts: bool = False
    # --- fault tolerance (serialized only away from their defaults) -----
    retry_budget: int = 3
    watchdog_ticks: int = 0
    # --- per-kernel tile plans + provenance ------------------------------
    tile_plans: Mapping[str, Mapping[str, object]] = dataclasses.field(
        default_factory=dict)
    provenance: Mapping[str, object] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        if self.buckets is not None:
            object.__setattr__(self, "buckets",
                               tuple(int(b) for b in self.buckets))
        object.__setattr__(self, "tile_plans", _jsonify(self.tile_plans))
        object.__setattr__(self, "provenance", _jsonify(self.provenance))

    # ------------------------------------------------------------ validation
    def validate(self) -> "ServingPlan":
        """Structural validation; raises ``ValueError`` on the first
        problem and returns ``self``.  The policy is checked against the
        port's scheduler registry."""
        if not self.arch or not isinstance(self.arch, str):
            raise ValueError(f"plan.arch must be a non-empty string, "
                             f"got {self.arch!r}")
        if self.max_batch < 1:
            raise ValueError(f"plan.max_batch must be >= 1, "
                             f"got {self.max_batch}")
        if self.max_len < 2:
            raise ValueError(f"plan.max_len must be >= 2 (one prompt token "
                             f"+ one generated), got {self.max_len}")
        block = parse_cache_layout(self.cache_layout)
        if block is not None and block > self.max_len:
            raise ValueError(
                f"plan.cache_layout block size {block} exceeds max_len "
                f"{self.max_len}: a block never covers more than one ring")
        if self.sync_every < 1:
            raise ValueError(f"plan.sync_every must be >= 1, "
                             f"got {self.sync_every}")
        if self.temperature < 0:
            raise ValueError(f"plan.temperature must be >= 0, "
                             f"got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"plan.top_k must be >= 0, got {self.top_k}")
        if self.retry_budget < 0:
            raise ValueError(f"plan.retry_budget must be >= 0, "
                             f"got {self.retry_budget}")
        if self.watchdog_ticks < 0:
            raise ValueError(f"plan.watchdog_ticks must be >= 0 "
                             f"(0 disables the watchdog), "
                             f"got {self.watchdog_ticks}")
        from repro_torch.serving.scheduler import SCHEDULERS, make_scheduler
        if self.policy not in SCHEDULERS:
            raise ValueError(f"plan.policy {self.policy!r} is not in the "
                             f"scheduler registry {sorted(SCHEDULERS)}")
        make_scheduler(self.policy, preempt=self.preempt)  # preempt support
        if self.buckets is not None:
            bs = self.buckets
            if not bs:
                raise ValueError("plan.buckets must be non-empty or None")
            if list(bs) != sorted(set(bs)):
                raise ValueError(f"plan.buckets must be strictly "
                                 f"increasing, got {bs}")
            if bs[0] < 1:
                raise ValueError(f"plan.buckets must be >= 1, got {bs}")
            if bs[-1] != self.max_len - 1:
                raise ValueError(
                    f"plan.buckets must end at max_len-1 = "
                    f"{self.max_len - 1} so every admissible prompt has a "
                    f"bucket, got {bs}")
        _validate_tile_plans(self.tile_plans)
        return self

    # ------------------------------------------------------------ resolution
    def resolved_buckets(self) -> Tuple[int, ...]:
        """The bucket set this plan serves with (the pow2 default when
        ``buckets`` is None)."""
        if self.buckets is not None:
            return self.buckets
        return default_buckets(self.max_len)

    def resolve(self) -> "ServingPlan":
        """A copy with the defaulted bucket set made explicit."""
        if not self.bucketed_prefill or self.buckets is not None:
            return self
        return dataclasses.replace(self, buckets=self.resolved_buckets())

    def summary(self) -> str:
        """One-line identity for CLI banners and logs."""
        b = ("exact" if not self.bucketed_prefill
             else "pow2" if self.buckets is None
             else ",".join(map(str, self.buckets)))
        bits = [self.arch + ("(reduced)" if self.reduced else ""),
                f"b{self.max_batch}", f"len{self.max_len}",
                f"sync{self.sync_every}",
                self.policy + ("+p" if self.preempt else ""),
                f"buckets={b}"]
        if self.cache_layout != "dense":
            bits.append(self.cache_layout)
        if self.shed_late:
            bits.append("shed")
        if not self.overlap_prefill:
            bits.append("no-overlap")
        if self.temperature > 0:
            bits.append(f"T={self.temperature:g}")
        if self.retry_budget != 3:
            bits.append(f"retry{self.retry_budget}")
        if self.watchdog_ticks > 0:
            bits.append(f"wd{self.watchdog_ticks}")
        return " ".join(bits)


@dataclasses.dataclass(frozen=True)
class FleetPlan:
    """One multi-replica serving design point: N per-replica
    :class:`ServingPlan`\\ s (possibly heterogeneous), a routing policy
    from the router registry, and the prefill/decode split; the router
    is built from it (``Router.from_plan``).

    ``n_prefill = 0`` is the colocated mode: every replica admits,
    prefills and decodes.  ``n_prefill = k > 0`` disaggregates: the first
    ``k`` replicas run admission and prefill only and hand finished slot
    state to the decode replicas over a modeled transit (cost per
    snapshot byte from :mod:`repro_torch.hw`: ``hw`` names the spec;
    ``transit_bytes_per_tick`` overrides the derived rate)."""

    replicas: Tuple[ServingPlan, ...]
    routing: str = "round_robin"
    n_prefill: int = 0
    transit_bytes_per_tick: Optional[float] = None
    hw: str = "h100-sxm"
    provenance: Mapping[str, object] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "replicas", tuple(self.replicas))
        object.__setattr__(self, "provenance", _jsonify(self.provenance))

    @staticmethod
    def replicated(plan: ServingPlan, n: int, *,
                   routing: str = "round_robin", n_prefill: int = 0,
                   **kw) -> "FleetPlan":
        """Homogeneous fleet: ``n`` copies of one replica plan."""
        return FleetPlan(replicas=(plan,) * int(n), routing=routing,
                         n_prefill=n_prefill, **kw)

    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    def validate(self) -> "FleetPlan":
        """Structural validation with the JAX package's messages; raises
        ``ValueError`` on the first problem, returns ``self``.  A
        disaggregated fleet's replicas must share arch, reduced and
        max_len, or a hand-off could never restore."""
        if not self.replicas:
            raise ValueError("fleet.replicas must name at least one replica")
        if not (0 <= self.n_prefill < len(self.replicas)):
            raise ValueError(
                f"fleet.n_prefill must leave at least one decode replica: "
                f"got n_prefill={self.n_prefill} of "
                f"{len(self.replicas)} replicas")
        if self.transit_bytes_per_tick is not None \
                and self.transit_bytes_per_tick <= 0:
            raise ValueError(
                f"fleet.transit_bytes_per_tick must be > 0 when set, "
                f"got {self.transit_bytes_per_tick}")
        from repro_torch import hw
        if self.hw not in hw.SPECS:
            raise ValueError(f"fleet.hw {self.hw!r} is not a known "
                             f"hardware spec {sorted(hw.SPECS)}")
        from repro_torch.serving.router import ROUTER_POLICIES
        if self.routing not in ROUTER_POLICIES:
            raise ValueError(
                f"fleet.routing {self.routing!r} is not in the router "
                f"registry {sorted(ROUTER_POLICIES)}")
        for i, plan in enumerate(self.replicas):
            if not isinstance(plan, ServingPlan):
                raise ValueError(f"fleet.replicas[{i}] must be a "
                                 f"ServingPlan, got {type(plan).__name__}")
            try:
                plan.validate()
            except ValueError as e:
                raise ValueError(f"fleet.replicas[{i}]: {e}") from e
        if self.n_prefill > 0:
            ref = self.replicas[0]
            for i, plan in enumerate(self.replicas):
                for field in ("arch", "reduced", "max_len"):
                    if getattr(plan, field) != getattr(ref, field):
                        raise ValueError(
                            f"disaggregated fleets need snapshot-compatible "
                            f"replicas: replicas[{i}].{field}="
                            f"{getattr(plan, field)!r} differs from "
                            f"replicas[0].{field}={getattr(ref, field)!r}")
        return self

    def resolve(self) -> "FleetPlan":
        """A copy with every replica plan resolved (explicit buckets)."""
        return dataclasses.replace(
            self, replicas=tuple(p.resolve() for p in self.replicas))

    def summary(self) -> str:
        # plans hold dict fields, so collapse a homogeneous fleet by
        # equality, not by hashing
        homogeneous = all(p == self.replicas[0] for p in self.replicas[1:])
        parts = [f"{len(self.replicas)}x[{self.replicas[0].summary()}]"
                 if homogeneous else
                 " | ".join(p.summary() for p in self.replicas),
                 f"routing={self.routing}"]
        if self.n_prefill:
            parts.append(f"prefill={self.n_prefill}/"
                         f"{len(self.replicas)}")
        return " ".join(parts)


# ---------------------------------------------------------------------------
# tile_plans validation
# ---------------------------------------------------------------------------

# kernel kinds a tile_plans entry may target: the model's layer kinds plus
# the two standalone kernels (fused_rnn cell serving, W8A16 matmul)
TILE_PLAN_KINDS = ("rwkv", "swa_ssm", "attn", "local",
                   "fused_rnn", "matmul_int8")
_TILE_FIELDS = ("bh", "bq", "bk", "bm", "bn")
# port-only: a count where 0 means the kernel's default
_COUNT_FIELDS = ("splits",)
_META_FIELDS = ("n_tiles", "vmem_bytes", "resident", "step_latency_s",
                "util", "bound")


def _validate_tile_plans(tile_plans) -> None:
    """Structural validation of ``ServingPlan.tile_plans``: a malformed
    entry fails at plan time, not as a refused launch mid-serving."""
    from repro_torch.kernels.dispatch import VALID_IMPLS

    for kind, entry in (tile_plans or {}).items():
        if kind not in TILE_PLAN_KINDS:
            raise ValueError(
                f"plan.tile_plans[{kind!r}]: unknown kernel kind "
                f"(known: {sorted(TILE_PLAN_KINDS)})")
        if not isinstance(entry, Mapping):
            raise ValueError(
                f"plan.tile_plans[{kind!r}] must be a dict, got "
                f"{type(entry).__name__}")
        for field, value in entry.items():
            if field in _TILE_FIELDS or field in _COUNT_FIELDS:
                least = 1 if field in _TILE_FIELDS else 0
                if isinstance(value, bool) or not isinstance(value, int) \
                        or value < least:
                    raise ValueError(
                        f"plan.tile_plans[{kind!r}][{field!r}] must be an "
                        f"int >= {least}, got {value!r}")
            elif field == "persistent":
                if not isinstance(value, bool):
                    raise ValueError(
                        f"plan.tile_plans[{kind!r}]['persistent'] must be "
                        f"a bool, got {value!r}")
            elif field == "impl":
                if value not in VALID_IMPLS:
                    raise ValueError(
                        f"plan.tile_plans[{kind!r}]['impl'] must be one of "
                        f"{VALID_IMPLS}, got {value!r}")
            elif field not in _META_FIELDS:
                raise ValueError(
                    f"plan.tile_plans[{kind!r}][{field!r}]: unknown field "
                    f"(tiles: {_TILE_FIELDS}; counts: {_COUNT_FIELDS}; "
                    f"metadata: {_META_FIELDS}; plus 'persistent'/'impl')")
        if entry.get("persistent"):
            # persistent keeps the weights resident for the whole token
            # loop: only with recorded DSE residency evidence, and never
            # past the card's shared-memory budget
            if not entry.get("resident"):
                raise ValueError(
                    f"plan.tile_plans[{kind!r}]: persistent=true requires "
                    f"resident=true (DSE evidence the weights fit on chip)")
            vmem = entry.get("vmem_bytes")
            if vmem is not None:
                from repro_torch import hw
                budget = hw.smem_budget()
                if int(vmem) > budget:
                    raise ValueError(
                        f"plan.tile_plans[{kind!r}]: persistent=true but "
                        f"vmem_bytes={vmem} exceeds a CTA's shared-memory "
                        f"budget {budget}")


def tiles_summary(tile_plans) -> str:
    """Compact banner fragment: ``rwkv[bh512] attn[bq256,bk1024]``."""
    bits = []
    for kind in sorted(tile_plans or {}):
        entry = tile_plans[kind]
        tiles = [f"{f}{entry[f]}" for f in _TILE_FIELDS + _COUNT_FIELDS
                 if entry.get(f)]
        if entry.get("persistent"):
            tiles.append("persist")
        if entry.get("impl"):
            tiles.append(str(entry["impl"]))
        bits.append(f"{kind}[{','.join(tiles)}]" if tiles else kind)
    return " ".join(bits)


__all__ = ["ServingPlan", "FleetPlan", "WorkloadProfile", "MIN_BUCKET",
           "TILE_PLAN_KINDS", "default_buckets", "parse_cache_layout",
           "tiles_summary"]
