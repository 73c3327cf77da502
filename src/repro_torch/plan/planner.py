"""The planner's cost model, as far as the serving tier reads it (port of
the cost-model half of ``repro.plan.planner``).

:func:`modeled_tick_seconds` is the roofline cost of one batched decode
tick of the *full-size* model on the target card: a decode step touches
every weight once and does ~2 FLOPs per (parameter, slot).  The router
(:mod:`repro_torch.serving.router`) multiplies it by the spec's
``dcn_bw`` to charge a disaggregated hand-off its transit ticks.  The
parameter count comes from the spec tree (:meth:`LM.param_specs`), so
nothing is allocated.

The search itself (``autotune``, ``autotune_fleet``,
``autotune_from_trace``, ``tile_plans_for``, ``fleet_shard_modes``) and
the CLI's ``--autotune`` / ``--hw-spec`` wait for the planner's slice.
"""

from __future__ import annotations

import functools

from repro_torch import hw


def _full_model(arch: str):
    """The full-size (deployment-target) model, specs only."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model

    return build_model(get_config(arch))


@functools.lru_cache(maxsize=None)
def _full_param_count(arch: str) -> int:
    return int(_full_model(arch).n_params())


def modeled_tick_seconds(arch: str, max_batch: int,
                         spec: hw.HardwareSpec) -> float:
    """Roofline cost of one batched decode tick on ``spec``: the larger of
    streaming every bf16 weight once and 2 FLOPs per (param, slot)."""
    n_params = _full_param_count(arch)
    weight_bytes = 2 * n_params  # bf16 deployment weights
    t_compute = spec.matmul_time(2.0 * n_params * max_batch)
    t_stream = spec.hbm_time(weight_bytes)
    return max(t_compute, t_stream)


__all__ = ["modeled_tick_seconds"]
