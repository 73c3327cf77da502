"""Port parity of the plan layer: ``ServingPlan`` validation, the
``serving_plan/v1`` JSON round trip in both directions, the serving
cells, and ``ServingEngine.from_plan`` (the kwargs constructor is a shim
over it, tick for tick; a paged plan builds a paged slot manager; a plan
the port cannot serve yet raises)."""

import dataclasses
import json

import pytest

from repro.configs import SERVING_LOAD_SWEEP as J_SWEEP
from repro.plan import ServingPlan as JPlan
from repro.plan import WorkloadProfile as JProfile
from repro.plan import io as jio
from repro.serving import workload as jwl
from repro_torch import hw
from repro_torch.configs import SERVING_LOAD_SWEEP as T_SWEEP
from repro_torch.configs import PAGED_BLOCK, serving_cell
from repro_torch.plan import ServingPlan as TPlan
from repro_torch.plan import WorkloadProfile as TProfile
from repro_torch.plan import io as tio
from repro_torch.plan.plan import default_buckets, tiles_summary
from repro_torch.serving import workload as twl
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.paged import PagedSlotManager
from repro_torch.serving.slotstate import SlotManager
from test_torch_engine import _models

# (kwargs, accepted): both packages must agree on each
PLANS = [
    (dict(), True),
    (dict(max_batch=8, max_len=64, sync_every=4, policy="spf"), True),
    (dict(policy="edf", preempt=True, shed_late=True), True),
    (dict(buckets=(8, 16, 127)), True),
    (dict(max_len=64, buckets=[4, 63]), True),
    (dict(cache_layout="paged:16"), True),
    (dict(retry_budget=0, watchdog_ticks=5), True),
    (dict(temperature=0.7, top_k=5), True),
    (dict(tile_plans={"rwkv": {"bh": 4, "impl": "jnp"},
                      "attn": {"bq": 128, "bk": 512, "impl": "pallas"},
                      "matmul_int8": {"bm": 256, "bn": 128, "bk": 512}}),
     True),
    (dict(tile_plans={"fused_rnn": {"bh": 64, "persistent": True,
                                    "resident": True}}), True),
    (dict(tile_plans={"rwkv": {"n_tiles": 2, "util": 0.5, "bound": "x"}}),
     True),
    (dict(arch=""), False),
    (dict(max_batch=0), False),
    (dict(max_len=1), False),
    (dict(sync_every=0), False),
    (dict(temperature=-1.0), False),
    (dict(top_k=-2), False),
    (dict(retry_budget=-1), False),
    (dict(watchdog_ticks=-1), False),
    (dict(policy="lifo"), False),
    (dict(policy="fcfs", preempt=True), False),
    (dict(cache_layout="paged"), False),
    (dict(cache_layout="paged:0"), False),
    (dict(cache_layout="paged:256"), False),
    (dict(cache_layout="ring"), False),
    (dict(buckets=()), False),
    (dict(buckets=(16, 8, 127)), False),
    (dict(buckets=(0, 127)), False),
    (dict(buckets=(8, 64)), False),
    (dict(tile_plans={"bogus": {"bh": 8}}), False),
    (dict(tile_plans={"rwkv": {"bh": 0}}), False),
    (dict(tile_plans={"rwkv": {"bh": True}}), False),
    (dict(tile_plans={"rwkv": {"impl": "cuda"}}), False),
    (dict(tile_plans={"rwkv": {"colour": 1}}), False),
    (dict(tile_plans={"rwkv": ["bh", 8]}), False),
    (dict(tile_plans={"rwkv": {"persistent": 1}}), False),
    (dict(tile_plans={"fused_rnn": {"persistent": True}}), False),
]


def _accepts(cls, kw):
    kw = dict(kw)
    arch = kw.pop("arch", "rwkv6-1.6b")
    try:
        cls(arch=arch, **kw).validate()
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("kw,ok", PLANS)
def test_plan_validation_agrees_with_jax(kw, ok):
    assert _accepts(JPlan, kw) is ok
    assert _accepts(TPlan, kw) is ok


ROUND_TRIP = [
    dict(),
    dict(max_len=64, buckets=(8, 16, 63), sync_every=4, policy="edf",
         preempt=True, retry_budget=5, overlap_prefill=False,
         provenance={"source": "test", "nested": {"a": [1, 2]}}),
    dict(reduced=False, shard_mode="tp", cache_layout="paged:16",
         watchdog_ticks=6, bucketed_prefill=False, temperature=0.5,
         tile_plans={"rwkv": {"bh": 64, "impl": "auto"},
                     "attn": {"bq": 128, "bk": 512, "impl": "jnp"},
                     "matmul_int8": {"bm": 256, "bn": 256, "bk": 512,
                                     "impl": "pallas"}}),
]


@pytest.mark.parametrize("kw", ROUND_TRIP)
def test_plan_dicts_round_trip_between_packages(kw, tmp_path):
    jplan = JPlan(arch="rwkv6-1.6b", **kw).validate()
    jd = json.loads(json.dumps(jio.to_dict(jplan)))
    tplan = tio.from_dict(jd).validate()
    assert tio.to_dict(tplan) == jd
    assert tplan.summary() == jplan.summary()
    assert tplan.resolved_buckets() == jplan.resolved_buckets()
    assert tio.to_dict(tplan.resolve()) == jio.to_dict(jplan.resolve())
    # and back: the port's file loads in the JAX package
    path = tmp_path / "plan.json"
    tio.save_plan(tplan, str(path))
    assert jio.load_plan(str(path)) == jplan
    assert tio.load_plan(str(path)) == tplan
    if kw.get("retry_budget") is None:
        assert "retry_budget" not in jd


def test_port_only_plan_keys_pass_port_validation():
    tp = {"matmul_int8": {"splits": 4, "impl": "kernel"},
          "rwkv": {"impl": "plain"}, "attn": {"splits": 0}}
    plan = TPlan(arch="qwen2.5-14b", tile_plans=tp).validate()
    assert tio.from_dict(tio.to_dict(plan)) == plan
    assert tiles_summary(plan.tile_plans) == \
        "attn matmul_int8[splits4,kernel] rwkv[plain]"
    with pytest.raises(ValueError):
        JPlan(arch="qwen2.5-14b", tile_plans=tp).validate()
    with pytest.raises(ValueError, match="splits"):
        TPlan(arch="qwen2.5-14b",
              tile_plans={"matmul_int8": {"splits": -1}}).validate()
    with pytest.raises(ValueError, match="unknown plan fields"):
        tio.from_dict({"arch": "rwkv6-1.6b", "colour": 1})
    with pytest.raises(ValueError, match="schema"):
        tio.from_dict({"schema": "serving_plan/v0", "arch": "rwkv6-1.6b"})


def test_persistent_vmem_is_held_to_the_card_shared_memory():
    entry = {"bh": 64, "persistent": True, "resident": True}
    budget = hw.smem_budget()
    TPlan(arch="rwkv6-1.6b", tile_plans={
        "fused_rnn": dict(entry, vmem_bytes=budget)}).validate()
    with pytest.raises(ValueError, match="shared-memory budget"):
        TPlan(arch="rwkv6-1.6b", tile_plans={
            "fused_rnn": dict(entry, vmem_bytes=budget + 1)}).validate()


def test_workload_profiles_materialize_as_in_jax():
    for kw in (dict(rate=0.8, duration=32.0, heavy_decode=(0.1, 8, 12),
                    deadline_slack=2.0),
               dict(kind="mmpp", rate=0.3, duration=48.0,
                    prompt_dist="lognormal", deadline_slack=1.5,
                    deadline_frac=0.5)):
        jp, tp = JProfile(**kw), TProfile(**kw)
        assert tp.to_json() == jp.to_json()
        assert TProfile.from_json(json.loads(json.dumps(tp.to_json()))) \
            == tp
        assert tp.mean_decode() == jp.mean_decode()
        ji = jwl.profile_items(jp, vocab_size=503, seed=5)
        ti = twl.profile_items(tp, vocab_size=503, seed=5)
        assert [i.to_json() for i in ti] == [i.to_json() for i in ji]


def test_serving_cells_are_the_jax_cells_of_the_ported_archs():
    jcells = {c.name: c for c in J_SWEEP}
    assert len(T_SWEEP) == 21
    for cell in T_SWEEP:
        j = jcells[cell.name]
        assert tio.to_dict(cell.plan) == jio.to_dict(j.plan)
        assert cell.workload.to_json() == j.workload.to_json()
        assert (cell.family, cell.tag) == (j.family, j.tag)
        assert cell.with_duration(8.0).duration == 8.0
    ported = {"rwkv6-1.6b", "qwen2.5-14b", "qwen3-moe-30b-a3b"}
    assert {c.name for c in T_SWEEP} == {
        n for n, c in jcells.items() if c.arch in ported}
    assert serving_cell("rwkv6-1.6b/b4/r0.8/heavy/edf+p").preempt
    assert serving_cell("qwen2.5-14b/b8/r1/lognormal/paged16"
                        ).cache_layout == f"paged:{PAGED_BLOCK}"
    with pytest.raises(KeyError):
        serving_cell("hymba-1.5b/b4/r1")


def test_paged_and_unported_plans_raise_in_from_plan():
    """A malformed paged layout and an arch the port lacks raise; a
    well-formed paged plan builds (``from_plan`` and the kwargs shim) an
    engine on a paged slot manager."""
    _, _, tm, tp = _models("rwkv6-1.6b")
    for bad in ("paged:0", "paged", "paged:08"):
        with pytest.raises(ValueError, match="paged"):
            TEngine.from_plan(TPlan(arch="rwkv6-1.6b", cache_layout=bad),
                              tp, model=tm)
    with pytest.raises(ValueError, match="exceeds max_len"):
        TEngine(tm, tp, max_len=32, cache_layout="paged:64")
    eng = TEngine.from_plan(TPlan(arch="rwkv6-1.6b", cache_layout="paged:16"),
                            tp, model=tm)
    assert isinstance(eng.sm, PagedSlotManager) and eng.sm.block_size == 16
    assert isinstance(TEngine(tm, tp, cache_layout="paged:8").sm,
                      PagedSlotManager)
    assert type(TEngine(tm, tp).sm) is SlotManager
    with pytest.raises(ValueError, match="the port serves"):
        TEngine.from_plan(TPlan(arch="gemma2-9b"), tp)
    with pytest.raises(ValueError, match="policy"):
        TEngine.from_plan(TPlan(arch="rwkv6-1.6b", policy="lifo"), tp)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "qwen2.5-14b"])
def test_kwargs_shim_equals_from_plan_tick_for_tick(arch):
    """The kwargs constructor assembles the plan ``from_plan`` is given;
    ``from_plan`` without a model builds it from the plan's arch."""
    _, _, tm, tp = _models(arch)
    kw = dict(max_batch=2, max_len=32, sync_every=4, policy="edf",
              preempt=True, overlap_prefill=True)
    shim = TEngine(tm, tp, **kw)
    plan = TPlan(arch=arch, provenance={"source": "test"}, **kw)
    built = TEngine.from_plan(plan, tp)
    assert built.model.cfg == tm.cfg
    assert dataclasses.replace(shim.plan, provenance={}) == \
        dataclasses.replace(plan, provenance={})
    assert shim.plan.reduced and shim.plan.provenance == {
        "source": "engine-kwargs"}
    assert shim.bucket_lengths == list(default_buckets(32))
    items = twl.make_workload("poisson", rate=0.8, duration=20.0, seed=1,
                              vocab_size=503, max_new_tokens=(2, 8),
                              heavy_decode=(0.2, 12, 16),
                              deadline_slack=2.0)
    a = twl.drive(shim, items, twl.VirtualClock())
    b = twl.drive(built, items, twl.VirtualClock())
    stamps = lambda r: (r.t_admit, r.t_first, r.t_done, r.output,
                        r.t_preempts, r.t_resumes)
    assert [stamps(r) for r in a] == [stamps(r) for r in b]
    assert shim.util_history == built.util_history
    assert shim.stats() == built.stats()
