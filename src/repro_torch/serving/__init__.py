from repro_torch.serving.engine import (  # noqa: F401
    EngineKilled,
    Request,
    ServingEngine,
)
from repro_torch.serving.faults import (  # noqa: F401
    FAULT_KINDS,
    FaultInjector,
    FaultPlan,
    FaultReport,
    FaultSpec,
    drive_resilient,
    make_storm,
)
from repro_torch.serving.metrics import (  # noqa: F401
    aggregate,
    aggregate_fleet,
    format_summary,
    scale_latencies,
)
from repro_torch.serving.router import (  # noqa: F401
    ROUTER_POLICIES,
    ROUTING_POLICIES,
    LeastQueue,
    RoundRobin,
    Router,
    RoutingPolicy,
    SLOFeedback,
    TransitJob,
    drive_fleet,
    make_routing_policy,
)
from repro_torch.serving.scheduler import (  # noqa: F401
    EDF,
    FCFS,
    POLICIES,
    SCHEDULERS,
    SPF,
    Scheduler,
    make_scheduler,
)
from repro_torch.serving.paged import (  # noqa: F401
    BlockPool,
    PagedSlotManager,
    canonicalize_cache,
    paged_cache_bytes,
)
from repro_torch.serving.slotstate import (  # noqa: F401
    SlotManager,
    SlotSnapshot,
    gather_slots,
    make_slot_manager,
    scatter_slots,
)
from repro_torch.serving.workload import (  # noqa: F401
    VirtualClock,
    WallClock,
    WorkloadItem,
    drive,
    load_trace,
    make_workload,
    profile_items,
    save_trace,
)
from repro_torch.plan.plan import (  # noqa: F401
    ServingPlan,
    WorkloadProfile,
)
