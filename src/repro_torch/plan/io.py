"""Plan (de)serialization (port of ``repro.plan.io``): the same
``serving_plan/v1`` JSON schema, so plans move between the two packages
in both directions.

``from_dict(to_dict(plan)) == plan`` for every valid plan.  The
fault-tolerance fields are omitted at their defaults, as the JAX package
omits them, so a default plan's dict is the same in both.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Mapping

from repro_torch.plan.plan import ServingPlan

PLAN_SCHEMA = "serving_plan/v1"

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


__all__ = ["PLAN_SCHEMA", "to_dict", "from_dict", "save_plan", "load_plan"]
