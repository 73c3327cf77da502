"""Plan-centric serving API (port of ``repro.plan``): ``ServingPlan``
holds every serving design parameter, ``WorkloadProfile`` the workload it
serves, ``FleetPlan`` a fleet of replica plans behind the router, and
``io`` round-trips plans and fleets through the JAX package's JSON
schemas.  ``planner`` holds the serving-level search (``autotune``,
``autotune_from_trace``, ``tile_plans_for`` on the Hopper DSE) and the
cost model the router reads; the fleet search waits for its slice."""

from repro_torch.plan.io import (  # noqa: F401
    FLEET_SCHEMA,
    PLAN_SCHEMA,
    fleet_from_dict,
    fleet_to_dict,
    from_dict,
    load_fleet_plan,
    load_plan,
    save_fleet_plan,
    save_plan,
    to_dict,
)
from repro_torch.plan.plan import (  # noqa: F401
    MIN_BUCKET,
    FleetPlan,
    ServingPlan,
    WorkloadProfile,
    default_buckets,
    parse_cache_layout,
)

__all__ = ["ServingPlan", "FleetPlan", "WorkloadProfile", "MIN_BUCKET",
           "default_buckets", "parse_cache_layout", "PLAN_SCHEMA",
           "FLEET_SCHEMA", "to_dict", "from_dict", "save_plan", "load_plan",
           "fleet_to_dict", "fleet_from_dict", "save_fleet_plan",
           "load_fleet_plan"]
