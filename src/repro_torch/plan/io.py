"""Plan (de)serialization (port of ``repro.plan.io``): the same
``serving_plan/v1`` and ``fleet_plan/v1`` JSON schemas, so plans and
fleets move between the two packages in both directions (a fleet's
``hw`` aside: each package validates it against its own specs).

``from_dict(to_dict(plan)) == plan`` for every valid plan.  The
fault-tolerance fields are omitted at their defaults, as the JAX package
omits them, so a default plan's dict is the same in both.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Mapping

from repro_torch.plan.plan import FleetPlan, ServingPlan

PLAN_SCHEMA = "serving_plan/v1"
FLEET_SCHEMA = "fleet_plan/v1"

# omitted from the JSON when at their default value; from_dict fills the
# defaults back in
_OMIT_AT_DEFAULT = ("retry_budget", "watchdog_ticks")


def to_dict(plan: ServingPlan) -> Dict[str, object]:
    """Plain-JSON dict of a plan, tagged with the schema id."""
    d = dataclasses.asdict(plan)
    if d["buckets"] is not None:
        d["buckets"] = list(d["buckets"])
    defaults = {f.name: f.default for f in dataclasses.fields(ServingPlan)}
    for name in _OMIT_AT_DEFAULT:
        if d[name] == defaults[name]:
            del d[name]
    return {"schema": PLAN_SCHEMA, **d}


def from_dict(d: Mapping[str, object]) -> ServingPlan:
    """Inverse of :func:`to_dict`; a missing schema tag is taken as this
    schema, a wrong one raises, and so does an unknown field."""
    d = dict(d)
    schema = d.pop("schema", PLAN_SCHEMA)
    if schema != PLAN_SCHEMA:
        raise ValueError(f"unsupported plan schema {schema!r}; "
                         f"this build reads {PLAN_SCHEMA!r}")
    known = {f.name for f in dataclasses.fields(ServingPlan)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"unknown plan fields {sorted(unknown)}; "
                         f"known: {sorted(known)}")
    return ServingPlan(**d)


def save_plan(plan: ServingPlan, path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_dict(plan), f, indent=1)
        f.write("\n")


def load_plan(path: str) -> ServingPlan:
    with open(path) as f:
        return from_dict(json.load(f)).validate()


def fleet_to_dict(fleet: FleetPlan) -> Dict[str, object]:
    """Plain-JSON dict of a fleet plan: the replica plans through
    :func:`to_dict`, the fleet's fields beside them, under the fleet
    schema tag."""
    d = {f.name: getattr(fleet, f.name)
         for f in dataclasses.fields(FleetPlan)}
    d["replicas"] = [to_dict(p) for p in fleet.replicas]
    d["provenance"] = dict(fleet.provenance)
    return {"schema": FLEET_SCHEMA, **d}


def fleet_from_dict(d: Mapping[str, object]) -> FleetPlan:
    """Inverse of :func:`fleet_to_dict`; a missing schema tag is taken as
    this schema, a wrong one raises, and so does an unknown field."""
    d = dict(d)
    schema = d.pop("schema", FLEET_SCHEMA)
    if schema != FLEET_SCHEMA:
        raise ValueError(f"unsupported fleet schema {schema!r}; "
                         f"this build reads {FLEET_SCHEMA!r}")
    known = {f.name for f in dataclasses.fields(FleetPlan)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"unknown fleet fields {sorted(unknown)}; "
                         f"known: {sorted(known)}")
    if "replicas" in d:
        d["replicas"] = tuple(from_dict(p) for p in d["replicas"])
    return FleetPlan(**d)


def save_fleet_plan(fleet: FleetPlan, path: str) -> None:
    with open(path, "w") as f:
        json.dump(fleet_to_dict(fleet), f, indent=1)
        f.write("\n")


def load_fleet_plan(path: str) -> FleetPlan:
    with open(path) as f:
        return fleet_from_dict(json.load(f)).validate()


__all__ = ["PLAN_SCHEMA", "FLEET_SCHEMA", "to_dict", "from_dict",
           "save_plan", "load_plan", "fleet_to_dict", "fleet_from_dict",
           "save_fleet_plan", "load_fleet_plan"]
