"""Configurations of the port.

The paper's own workload: Baidu DeepBench RNN inference tasks (Table 6),
copied from ``repro.configs``.  ``get_config(arch_id)`` resolves the LM
architectures the port serves so far (rwkv6-1.6b, qwen2.5-14b,
qwen3-moe-30b-a3b, granite-moe-1b-a400m, hymba-1.5b).  ``SERVING_LOAD_SWEEP`` equals
the JAX package's sweep cell for cell (21 cells, by the JAX names): each
a :class:`ServingPlan` served under a :class:`WorkloadProfile`, paged
cells included (``PAGED_BLOCK``).  ``FLEET_SERVING_SWEEP`` holds the JAX
package's six fleet cells (:class:`FleetLoadCell`: a :class:`FleetPlan`
under a workload), all rwkv6-1.6b, with the same names, plans and
workloads, the fleet's ``hw`` aside (the port's ``"h100-sxm"``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.configs import (granite_moe_1b, hymba_1_5b, qwen2_5_14b,
                                 qwen3_moe_30b, rwkv6_1_6b)
from repro_torch.configs.base import ModelConfig
from repro_torch.plan.plan import FleetPlan, ServingPlan, WorkloadProfile

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (rwkv6_1_6b, qwen2_5_14b, granite_moe_1b, qwen3_moe_30b,
              hymba_1_5b)}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; the port serves "
                       f"{sorted(ARCHS)} so far")
    return ARCHS[arch]


@dataclasses.dataclass(frozen=True)
class DeepBenchTask:
    cell: str            # "lstm" | "gru"
    hidden: int          # H (== input features D in DeepBench)
    timesteps: int       # T
    # Paper-reported latencies in ms (Table 6) for comparison columns.
    ms_cpu: float = 0.0
    ms_v100: float = 0.0
    ms_brainwave: float = 0.0
    ms_plasticine: float = 0.0

    @property
    def name(self) -> str:
        return f"{self.cell}-h{self.hidden}-t{self.timesteps}"


DEEPBENCH_TASKS = (
    DeepBenchTask("lstm", 256, 150, 15.75, 1.69, 0.425, 0.0419),
    DeepBenchTask("lstm", 512, 25, 11.50, 0.60, 0.077, 0.0139),
    DeepBenchTask("lstm", 1024, 25, 107.65, 0.71, 0.074, 0.0292),
    DeepBenchTask("lstm", 1536, 50, 411.00, 4.38, 0.145, 0.1224),
    DeepBenchTask("lstm", 2048, 25, 429.36, 1.55, 0.074, 0.1060),
    DeepBenchTask("gru", 512, 1, 0.91, 0.39, 0.013, 0.0004),
    DeepBenchTask("gru", 1024, 1500, 3810.00, 33.77, 3.792, 1.4430),
    DeepBenchTask("gru", 1536, 375, 2730.00, 13.12, 0.951, 0.7463),
    DeepBenchTask("gru", 2048, 375, 5040.00, 17.70, 0.954, 1.2833),
    DeepBenchTask("gru", 2560, 375, 7590.00, 23.57, 0.993, 1.9733),
)


# ---------------------------------------------------------------------------
# Serving-load cells (copied from ``repro.configs``)
# ---------------------------------------------------------------------------


class ServingLoadCell:
    """One serving-load cell: a design point (:class:`ServingPlan`)
    serving a workload (:class:`WorkloadProfile`).  ``family`` tags the
    model class; an optional ``tag`` marks derived cells.  Built either
    from the historical field names (``ServingLoadCell(arch, family,
    max_batch, rate, policy=..., ...)``) or from a plan and a profile;
    the name is the JAX package's for the same cell."""

    MAX_LEN = 64
    PROMPT_LEN = (4, 12)
    MAX_NEW = (6, 10)

    def __init__(self, arch: Optional[str] = None, family: str = "",
                 max_batch: Optional[int] = None,
                 rate: Optional[float] = None, *,
                 policy: str = "fcfs", preempt: bool = False,
                 cache_layout: str = "dense",
                 prompt_dist: str = "uniform",
                 heavy_decode: Optional[Tuple[float, int, int]] = None,
                 deadline_slack: Optional[float] = None,
                 duration: Optional[float] = None,
                 plan: Optional[ServingPlan] = None,
                 workload: Optional[WorkloadProfile] = None,
                 tag: str = ""):
        if plan is None:
            if arch is None or max_batch is None:
                raise ValueError("ServingLoadCell needs (arch, max_batch) "
                                 "or an explicit plan")
            plan = ServingPlan(arch=arch, max_batch=max_batch,
                               max_len=self.MAX_LEN, policy=policy,
                               preempt=preempt, cache_layout=cache_layout)
        if workload is None:
            if rate is None:
                raise ValueError("ServingLoadCell needs rate or an "
                                 "explicit workload profile")
            workload = WorkloadProfile(
                kind="poisson", rate=rate, duration=duration,
                prompt_len=self.PROMPT_LEN, max_new_tokens=self.MAX_NEW,
                prompt_dist=prompt_dist,
                prompt_len_long=plan.max_len - 1,
                heavy_decode=heavy_decode, deadline_slack=deadline_slack)
        self.family = family
        self.plan = plan
        self.workload = workload
        self.tag = tag

    # ----------------------------------------------- historical field names
    @property
    def arch(self) -> str:
        return self.plan.arch

    @property
    def max_batch(self) -> int:
        return self.plan.max_batch

    @property
    def policy(self) -> str:
        return self.plan.policy

    @property
    def preempt(self) -> bool:
        return self.plan.preempt

    @property
    def cache_layout(self) -> str:
        return self.plan.cache_layout

    @property
    def rate(self) -> float:
        return self.workload.rate

    @property
    def prompt_dist(self) -> str:
        return self.workload.prompt_dist

    @property
    def heavy_decode(self) -> Optional[Tuple[float, int, int]]:
        return self.workload.heavy_decode

    @property
    def deadline_slack(self) -> Optional[float]:
        return self.workload.deadline_slack

    @property
    def duration(self) -> Optional[float]:
        return self.workload.duration

    def with_duration(self, duration: float) -> "ServingLoadCell":
        """A copy with the workload span replaced."""
        return ServingLoadCell(
            family=self.family, plan=self.plan, tag=self.tag,
            workload=dataclasses.replace(self.workload, duration=duration))

    def __eq__(self, other) -> bool:
        return (isinstance(other, ServingLoadCell)
                and (self.family, self.plan, self.workload, self.tag)
                == (other.family, other.plan, other.workload, other.tag))

    def __hash__(self) -> int:
        return hash((self.family, self.tag, self.name))

    def __repr__(self) -> str:
        return (f"ServingLoadCell({self.name!r}, family={self.family!r}, "
                f"plan={self.plan.summary()!r})")

    @property
    def name(self) -> str:
        n = f"{self.arch}/b{self.max_batch}/r{self.rate:g}"
        if self.prompt_dist != "uniform":
            n += f"/{self.prompt_dist}"
        if self.heavy_decode is not None:
            n += "/heavy"
        if self.policy != "fcfs" or self.preempt:
            n += f"/{self.policy}" + ("+p" if self.preempt else "")
        if self.cache_layout != "dense":
            n += "/" + self.cache_layout.replace(":", "")
        if self.tag:
            n += f"/{self.tag}"
        return n


# One under-loaded and one saturating rate per (arch, max_batch): the
# requests average ~16 tokens (prompt 4-12 + 6-10 new), so rate 0.1
# offers ~1.6 tokens a clock unit and rate 1.0 ~16, past max_batch=4's
# ceiling of 4 tokens a tick (queue-growth regime).
_SERVING_BASE_GRID: Tuple[ServingLoadCell, ...] = tuple(
    ServingLoadCell(arch, family, mb, rate)
    for arch, family in (("qwen2.5-14b", "dense"),
                         ("qwen3-moe-30b-a3b", "moe"),
                         ("rwkv6-1.6b", "rwkv"))
    for mb in (2, 4)
    for rate in (0.1, 1.0)
)

# The saturating rwkv cell under fixed / lognormal / bimodal prompt
# lengths.
_SERVING_PROMPT_DIST_GRID: Tuple[ServingLoadCell, ...] = tuple(
    ServingLoadCell("rwkv6-1.6b", "rwkv", 4, 1.0, prompt_dist=dist)
    for dist in ("fixed", "lognormal", "bimodal")
)

# Overload: rate 0.8 x ~9.3 decode ticks against 4 slots (~1.9x), 3 % of
# requests heavy-decode jobs of 32-48 ticks, every request due at
# arrival + 3 x max_new ticks; one seeded workload under FCFS, EDF and
# preemptive EDF.
OVERLOAD_DEADLINE_SLACK = 3.0
OVERLOAD_HEAVY_DECODE = (0.03, 32, 48)
_SERVING_OVERLOAD_GRID: Tuple[ServingLoadCell, ...] = tuple(
    ServingLoadCell("rwkv6-1.6b", "rwkv", 4, 0.8, policy=policy,
                    preempt=preempt, heavy_decode=OVERLOAD_HEAVY_DECODE,
                    deadline_slack=OVERLOAD_DEADLINE_SLACK, duration=128.0)
    for policy, preempt in (("fcfs", False), ("edf", False), ("edf", True))
)

# Paged cells: the first is the byte-exact twin of the dense
# qwen2.5-14b/b4/r1 (the same plan but for cache_layout, so the same
# stamps and aggregate); the other two admit twice the slots under
# heavy-tail prompts, which the paged pool affords because its resident
# bytes follow the tokens in flight, not max_batch x max_len.
PAGED_BLOCK = 16
_SERVING_PAGED_GRID: Tuple[ServingLoadCell, ...] = tuple(
    [ServingLoadCell("qwen2.5-14b", "dense", 4, 1.0,
                     cache_layout=f"paged:{PAGED_BLOCK}")]
    + [ServingLoadCell("qwen2.5-14b", "dense", 8, 1.0, prompt_dist=dist,
                       cache_layout=f"paged:{PAGED_BLOCK}")
       for dist in ("lognormal", "bimodal")]
)

SERVING_LOAD_SWEEP: Tuple[ServingLoadCell, ...] = (
    _SERVING_BASE_GRID + _SERVING_PROMPT_DIST_GRID + _SERVING_OVERLOAD_GRID
    + _SERVING_PAGED_GRID
)


def serving_cell(name: str) -> ServingLoadCell:
    """The cell of ``SERVING_LOAD_SWEEP`` with this name."""
    for cell in SERVING_LOAD_SWEEP:
        if cell.name == name:
            return cell
    raise KeyError(f"no serving cell {name!r}; known: "
                   f"{[c.name for c in SERVING_LOAD_SWEEP]}")


# ---------------------------------------------------------------------------
# Fleet serving cells (copied from ``repro.configs``)
# ---------------------------------------------------------------------------


class FleetLoadCell:
    """One fleet cell: a :class:`FleetPlan` (N replicas behind the router,
    colocated or disaggregated into prefill and decode roles) serving a
    :class:`WorkloadProfile` on one shared virtual clock.  The name is the
    JAX package's for the same cell."""

    def __init__(self, family: str, fleet: FleetPlan,
                 workload: WorkloadProfile, tag: str = ""):
        self.family = family
        self.fleet = fleet
        self.workload = workload
        self.tag = tag

    @property
    def name(self) -> str:
        ref = self.fleet.replicas[0]
        n = (f"fleet/{ref.arch}/x{self.fleet.n_replicas}"
             f"b{ref.max_batch}/{self.fleet.routing}")
        if self.fleet.n_prefill:
            n += f"/p{self.fleet.n_prefill}"
        n += f"/r{self.workload.rate:g}"
        if self.tag:
            n += f"/{self.tag}"
        return n

    def __eq__(self, other) -> bool:
        return (isinstance(other, FleetLoadCell)
                and (self.family, self.fleet, self.workload, self.tag)
                == (other.family, other.fleet, other.workload, other.tag))

    def __repr__(self) -> str:
        return (f"FleetLoadCell({self.name!r}, family={self.family!r}, "
                f"fleet={self.fleet.summary()!r})")


def _fleet_sweep() -> Tuple[FleetLoadCell, ...]:
    """The fleet grid, three scenarios:

    * ``twin``: a one-replica colocated fleet serving the
      rwkv6-1.6b/b2/r1 base cell's plan and workload, whose metrics must
      equal the bare engine's;
    * ``capacity``: the overload workload (deadlines and a heavy-decode
      tail, Poisson 0.75 over 192 units: ~7 offered slot-ticks a tick,
      1.75x one b4 replica) served by 1, 2 and 4 colocated replicas
      under least_queue;
    * the ``colocated`` / ``disagg`` pair: a deadline workload (Poisson
      1.9 over 128 units) served by four colocated edf+preempt b4
      replicas and by one b4 prefill replica with three b8 decode
      replicas.
    """
    base_b2 = ServingLoadCell("rwkv6-1.6b", "rwkv", 2, 1.0)
    twin = FleetLoadCell(
        "rwkv", FleetPlan.replicated(base_b2.plan, 1), base_b2.workload,
        tag="twin")

    cap_plan = ServingPlan(arch="rwkv6-1.6b", max_batch=4,
                           max_len=ServingLoadCell.MAX_LEN)
    cap_workload = WorkloadProfile(
        kind="poisson", rate=0.75, duration=192.0,
        prompt_len=ServingLoadCell.PROMPT_LEN,
        max_new_tokens=ServingLoadCell.MAX_NEW,
        prompt_len_long=ServingLoadCell.MAX_LEN - 1,
        heavy_decode=OVERLOAD_HEAVY_DECODE,
        deadline_slack=OVERLOAD_DEADLINE_SLACK)
    capacity = tuple(
        FleetLoadCell("rwkv",
                      FleetPlan.replicated(cap_plan, n,
                                           routing="least_queue"),
                      cap_workload, tag="capacity")
        for n in (1, 2, 4))

    dis_workload = WorkloadProfile(
        kind="poisson", rate=1.9, duration=128.0,
        prompt_len=ServingLoadCell.PROMPT_LEN,
        max_new_tokens=(6, 16),
        prompt_len_long=ServingLoadCell.MAX_LEN - 1,
        heavy_decode=(0.03, 32, 48),
        deadline_slack=OVERLOAD_DEADLINE_SLACK)
    colo_plan = ServingPlan(arch="rwkv6-1.6b", max_batch=4,
                            max_len=ServingLoadCell.MAX_LEN,
                            policy="edf", preempt=True)
    pre_plan = ServingPlan(arch="rwkv6-1.6b", max_batch=4,
                           max_len=ServingLoadCell.MAX_LEN)
    dec_plan = ServingPlan(arch="rwkv6-1.6b", max_batch=8,
                           max_len=ServingLoadCell.MAX_LEN)
    disagg = (
        FleetLoadCell("rwkv", FleetPlan.replicated(colo_plan, 4,
                                                   routing="least_queue"),
                      dis_workload, tag="colocated"),
        FleetLoadCell("rwkv",
                      FleetPlan(replicas=(pre_plan, dec_plan, dec_plan,
                                          dec_plan),
                                routing="least_queue", n_prefill=1),
                      dis_workload, tag="disagg"),
    )
    return (twin,) + capacity + disagg


FLEET_SERVING_SWEEP: Tuple[FleetLoadCell, ...] = _fleet_sweep()

