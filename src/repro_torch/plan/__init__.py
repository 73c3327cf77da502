"""Plan-centric serving API (port of ``repro.plan``): ``ServingPlan``
holds every serving design parameter, ``WorkloadProfile`` the workload it
serves, and ``io`` round-trips plans through the JAX package's JSON
schema.  The planner (``autotune``) and ``FleetPlan`` wait for their
slices."""

from repro_torch.plan.io import (  # noqa: F401
    PLAN_SCHEMA,
    from_dict,
    load_plan,
    save_plan,
    to_dict,
)
from repro_torch.plan.plan import (  # noqa: F401
    MIN_BUCKET,
    ServingPlan,
    WorkloadProfile,
    default_buckets,
    parse_cache_layout,
)

__all__ = ["ServingPlan", "WorkloadProfile", "MIN_BUCKET",
           "default_buckets", "parse_cache_layout", "PLAN_SCHEMA",
           "to_dict", "from_dict", "save_plan", "load_plan"]
