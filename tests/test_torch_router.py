"""Port parity of the serving tier (``repro_torch.serving.router``,
``FleetPlan``, the planner's tick model, the fleet CLI) against the JAX
package's router.

Fleets of reduced rwkv6-1.6b at ``max_len`` 32 run through a live JAX
``Router``/``drive_fleet`` and through the port's, on the same items and
the converted weights of tests/test_torch_engine.py, colocated and
disaggregated under every routing policy, with ``overlap_prefill`` on.
Requests carry no ``eos_id``, so the schedule depends only on lengths,
budgets, deadlines and the routing: stamps, replica assignment, shed
flags, the pooled aggregate, the transit stats, the census, every
replica's ``stats()`` and the merged trace must be equal.  Greedy tokens
must be equal too, except at the near-ties that
tests/test_torch_engine.py exempts.  The snapshot-compatibility report
must give the JAX package's messages, leaf names aside (the port writes
``blocks/p0/k`` where JAX writes ``['blocks']['p0']['k']``).
"""

import dataclasses
import json
import math
import re
import sys
import types

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import FLEET_SERVING_SWEEP as J_FLEET_SWEEP
from repro.obs import Tracer as JTracer
from repro.obs import dumps_trace_doc as j_dumps_doc
from repro.obs import merge_traces as j_merge
from repro.plan import io as jio
from repro.plan import planner as jplanner
from repro.plan.plan import FleetPlan as JFleet
from repro.plan.plan import ServingPlan as JPlan
from repro.plan.plan import WorkloadProfile as JProfile
from repro.serving import ServingEngine as JEngine
from repro.serving import SlotSnapshot as JSnapshot
from repro.serving import workload as jwl
from repro.serving.router import Router as JRouter
from repro.serving.router import SLOFeedback as JSLOFeedback
from repro.serving.router import drive_fleet as j_drive_fleet
from repro_torch import hw
from repro_torch.configs import FLEET_SERVING_SWEEP, get_config
from repro_torch.models.lm import build_model
from repro_torch.obs import Tracer, dumps_trace_doc, merge_traces
from repro_torch.plan import io as tio
from repro_torch.plan import planner
from repro_torch.plan.plan import FleetPlan, ServingPlan, WorkloadProfile
from repro_torch.serving import ServingEngine, SlotSnapshot
from repro_torch.serving import metrics as tmet
from repro_torch.serving import workload as twl
from repro_torch.serving.router import (ROUTER_POLICIES, ROUTING_POLICIES,
                                        Router, SLOFeedback, drive_fleet,
                                        make_routing_policy)
from test_torch_engine import NOSH, TIE_REL, _jax_margin, _models

ARCH = "rwkv6-1.6b"
MAX_LEN = 32
VOCAB = 503
PINNED_BPT = 1e5       # transit bytes a tick, pinned in both packages


@pytest.fixture(scope="module")
def models():
    """One JAX build and its converted port tree, shared by every test."""
    return _models(ARCH)


def _built(pkg, models):
    jm, jp, tm, tp = models
    return {(ARCH, True): (jm, jp) if pkg == "jax" else (tm, tp)}


def _fleet(F, P, routing, n, n_prefill, **kw):
    """``n`` b2 replicas, or with ``n_prefill`` a b2 prefill replica in
    front of b4 decode replicas."""
    if n_prefill:
        pre = P(arch=ARCH, max_batch=2, max_len=MAX_LEN)
        dec = P(arch=ARCH, max_batch=4, max_len=MAX_LEN)
        return F(replicas=(pre,) * n_prefill + (dec,) * (n - n_prefill),
                 routing=routing, n_prefill=n_prefill, **kw).validate()
    return F.replicated(P(arch=ARCH, max_batch=2, max_len=MAX_LEN), n,
                        routing=routing, **kw).validate()


def _items(mod, P, *, rate=0.8, duration=12.0, seed=0, **kw):
    return mod.profile_items(P(kind="poisson", rate=rate, duration=duration,
                               **kw), vocab_size=VOCAB, seed=seed)


def _schedule(reqs):
    return [(r.uid, r.t_submit, r.t_admit, r.t_first, r.t_done,
             len(r.output), r.done, r.shed, tuple(r.t_resumes))
            for r in reqs]


def _assigned(router):
    return [[r.uid for r in rs] for rs in router.assigned]


def _stats(eng):
    """``stats()`` under the JAX engine's keys (the port counts
    ``prefill_shapes`` where JAX counts ``prefill_compiles``, and adds
    three counters JAX lacks)."""
    s = dict(eng.stats())
    if "prefill_shapes" in s:
        s["prefill_compiles"] = s.pop("prefill_shapes")
        for k in ("preempt_bursts", "decode_ticks", "overlap_prefills"):
            s.pop(k)
    return s


def _same_tokens_or_tie(models, jreqs, treqs):
    jm, jp, _, _ = models
    for jr, tr in zip(jreqs, treqs):
        diff = [i for i, (a, b) in enumerate(zip(jr.output, tr.output))
                if a != b]
        if diff:
            margin, scale = _jax_margin(jm, jp, jr.prompt,
                                        jr.output[:diff[0]])
            assert margin < TIE_REL[ARCH] * scale, (
                f"request {jr.uid}: token {diff[0]} differs at a JAX top-2 "
                f"margin {margin:.3g} >= {TIE_REL[ARCH] * scale:.3g}")


# ---------------------------------------------------------------------------
# the anchor: a one-replica colocated fleet is the bare engine
# ---------------------------------------------------------------------------


def test_single_replica_fleet_is_bare_engine(models):
    _, _, tm, tp = models
    plan = ServingPlan(arch=ARCH, max_batch=2, max_len=MAX_LEN)
    items = _items(twl, WorkloadProfile, duration=16.0)
    engine = ServingEngine.from_plan(plan, tp, model=tm, seed=0)
    bare = twl.drive(engine, items, twl.VirtualClock())
    bare_agg = tmet.aggregate(bare, ticks=engine.ticks,
                              util_history=engine.util_history)

    router = Router.from_plan(FleetPlan.replicated(plan, 1), seed=0,
                              device="cpu", _built=_built("torch", models))
    freqs = drive_fleet(router, items, twl.VirtualClock())
    assert [(s, r.output) for s, r in zip(_schedule(freqs), freqs)] == \
        [(s, r.output) for s, r in zip(_schedule(bare), bare)]
    assert json.dumps(router.fleet_aggregate(), sort_keys=True) == \
        json.dumps(bare_agg, sort_keys=True)
    assert router.engines[0].stats() == engine.stats()
    assert router.engines[0].util_history == engine.util_history


# ---------------------------------------------------------------------------
# the port's fleet against a live JAX fleet
# ---------------------------------------------------------------------------


def _run_fleet(pkg, models, routing, n, n_prefill, items_kw):
    if pkg == "jax":
        fleet = _fleet(JFleet, JPlan, routing, n, n_prefill,
                       transit_bytes_per_tick=PINNED_BPT)
        tracers = [JTracer() for _ in range(n)]
        router = JRouter.from_plan(fleet, seed=3, tracers=tracers,
                                   _built=_built("jax", models))
        reqs = j_drive_fleet(router, _items(jwl, JProfile, **items_kw))
        trace = j_dumps_doc(j_merge(tracers))
    else:
        fleet = _fleet(FleetPlan, ServingPlan, routing, n, n_prefill,
                       transit_bytes_per_tick=PINNED_BPT)
        tracers = [Tracer() for _ in range(n)]
        router = Router.from_plan(fleet, seed=3, tracers=tracers,
                                  device="cpu",
                                  _built=_built("torch", models))
        reqs = drive_fleet(router, _items(twl, WorkloadProfile, **items_kw))
        trace = dumps_trace_doc(merge_traces(tracers))
    return router, reqs, trace


@pytest.mark.parametrize("routing,n,n_prefill", [
    ("round_robin", 2, 0),
    ("least_queue", 3, 0),
    ("slo_feedback", 2, 0),
    ("least_queue", 3, 1),
])
def test_fleet_matches_live_jax_fleet(models, routing, n, n_prefill):
    # deadlines and shed_late off: the shed flags are all False here, the
    # hypothesis test below sheds
    items_kw = dict(rate=1.0, duration=14.0, seed=5)
    jr, jreqs, jtrace = _run_fleet("jax", models, routing, n, n_prefill,
                                   items_kw)
    tr, treqs, ttrace = _run_fleet("torch", models, routing, n, n_prefill,
                                   items_kw)
    assert len(treqs) >= 10
    assert _schedule(treqs) == _schedule(jreqs)
    assert _assigned(tr) == _assigned(jr)
    assert json.dumps(tr.fleet_aggregate(), sort_keys=True) == \
        json.dumps(jr.fleet_aggregate(), sort_keys=True)
    assert tr.transit_stats() == jr.transit_stats()
    assert tr.conservation_census() == jr.conservation_census()
    assert [_stats(e) for e in tr.engines] == [_stats(e) for e in jr.engines]
    assert [e.util_history for e in tr.engines] == \
        [e.util_history for e in jr.engines]
    assert ttrace == jtrace
    _same_tokens_or_tie(models, jreqs, treqs)
    if n_prefill:
        ts = tr.transit_stats()
        done = [r for r in treqs if not r.shed]
        assert ts["handoffs"] == ts["delivered"] == len(done) > 0
        assert all(tr.engines[i].prefill_calls == 0
                   for i in range(n_prefill, n))
        assert all(r.t_resumes for r in done)
        assert tr.engines[0].sm.n_active() == 0
    if routing == "slo_feedback":
        assert all(e.live is not None for e in tr.engines)


def test_slo_feedback_scores_like_jax():
    """Both packages' ``SLOFeedback`` pick the same replica over the same
    engines: an empty window and a NaN p95 score 0, ties fall to the
    queue depth, then the index."""
    def eng(queued, active, live):
        return types.SimpleNamespace(
            scheduler=[None] * queued,
            sm=types.SimpleNamespace(n_active=lambda: active),
            live=None if live is None else types.SimpleNamespace(
                snapshot=lambda: {"completed": live[0],
                                  "ttft_p95": live[1]}))

    cases = [
        [eng(2, 1, (3, 4.0)), eng(0, 1, (0, float("nan"))), eng(0, 0, None)],
        [eng(1, 1, (2, float("nan"))), eng(1, 0, (1, 0.0))],
        [eng(0, 2, (1, 2.0)), eng(0, 2, (1, 1.0)), eng(0, 1, (1, 1.0))],
        [eng(3, 0, (0, 9.0)), eng(3, 0, (0, 9.0))],
    ]
    for engines in cases:
        assert SLOFeedback().choose(engines) == \
            JSLOFeedback().choose(engines)
    assert SLOFeedback().choose(cases[0]) == 2
    assert SLOFeedback().choose(cases[2]) == 2


def test_routing_registry():
    assert set(ROUTER_POLICIES) == {"round_robin", "least_queue",
                                    "slo_feedback"}
    assert ROUTING_POLICIES == ("round_robin", "least_queue",
                                "slo_feedback")
    for name in ROUTER_POLICIES:
        assert make_routing_policy(name).name == name
    with pytest.raises(ValueError, match="unknown routing policy"):
        make_routing_policy("bogus")


def test_align_clock_never_rewinds(models):
    _, _, tm, tp = models
    eng = ServingEngine.from_plan(ServingPlan(arch=ARCH, max_batch=2,
                                              max_len=MAX_LEN), tp, model=tm)
    eng.align_clock(7)
    assert eng.ticks == 7
    eng.align_clock(3)
    assert eng.ticks == 7


# ---------------------------------------------------------------------------
# conservation under random interleavings (the port alone)
# ---------------------------------------------------------------------------


@settings(max_examples=10, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**16),
       n=st.integers(1, 3),
       n_prefill=st.integers(0, 2),
       routing=st.sampled_from(sorted(ROUTER_POLICIES)),
       rate=st.sampled_from([0.4, 0.9, 1.4]),
       shed=st.booleans())
def test_fleet_conserves_requests(seed, n, n_prefill, routing, rate, shed):
    models = _models(ARCH)
    n_prefill = min(n_prefill, n - 1)
    fleet = FleetPlan.replicated(
        ServingPlan(arch=ARCH, max_batch=2, max_len=MAX_LEN, shed_late=shed),
        n, routing=routing, n_prefill=n_prefill).validate()
    router = Router.from_plan(fleet, seed=seed, device="cpu",
                              _built=_built("torch", models))
    items = _items(twl, WorkloadProfile, rate=rate, duration=8.0, seed=seed,
                   deadline_slack=1.0 if shed else None)
    seen = []

    def on_tick(_):
        census = router.conservation_census()
        seen.append(census["total"] == len(router.requests))

    reqs = drive_fleet(router, items, on_tick=on_tick)
    assert all(seen) and (seen or not items)
    assert len(reqs) == len(items)
    census = router.conservation_census()
    assert census["total"] == len(items), census
    assert census["queued"] == census["in_slot"] == \
        census["in_transit"] == 0, census
    assert census["finished"] + census["shed"] == len(items), census
    assert all(r.shed or r.done for r in reqs)
    ts = router.transit_stats()
    assert ts["delivered"] == ts["handoffs"] and ts["in_flight"] == 0, ts
    assert sorted(r.uid for rs in router.assigned for r in rs) == \
        sorted(r.uid for r in reqs)
    if n_prefill:
        assert all(router.engines[i].prefill_calls == 0
                   for i in range(n_prefill, n))


# ---------------------------------------------------------------------------
# the transit model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "qwen2.5-14b"])
def test_full_param_count_equals_jax(arch):
    assert planner._full_param_count(arch) == jplanner._full_param_count(arch)


def test_bytes_per_tick_is_dcn_bw_times_the_modeled_tick(models):
    spec = hw.get_spec("h100-sxm")
    assert spec is hw.H100_SXM and spec.dcn_bw == 50e9
    fleet = _fleet(FleetPlan, ServingPlan, "least_queue", 3, 1)
    router = Router.from_plan(fleet, seed=0, device="cpu",
                              _built=_built("torch", models))
    n = get_config(ARCH)
    n_params = build_model(n).n_params()
    # the decode replicas' b4 aside, the first replica (b2) sets the tick
    tick = max(2.0 * n_params * 2 / spec.peak_bf16_flops,
               2 * n_params / spec.hbm_bw)
    assert planner.modeled_tick_seconds(ARCH, 2, spec) == tick
    assert router.bytes_per_tick == spec.dcn_bw * tick
    # rwkv6-1.6b streams ~3.2 GB of bf16 weights a tick: ~0.955 ms at
    # 3.35 TB/s, so ~47.75 MB a tick at 50 GB/s
    assert 0.9e-3 < tick < 1.0e-3
    assert 47e6 < router.bytes_per_tick < 48.5e6
    # a pinned rate wins, and the ceiling is floored at one tick
    pinned = Router.from_plan(
        dataclasses.replace(fleet, transit_bytes_per_tick=100.0), seed=0,
        device="cpu", _built=_built("torch", models))
    assert pinned.bytes_per_tick == 100.0
    assert pinned.transit_ticks(1) == 1
    assert pinned.transit_ticks(250) == 3


def test_no_dcn_floors_every_transit(models, monkeypatch):
    no_dcn = dataclasses.replace(hw.H100_SXM, name="no-dcn", dcn_bw=0.0)
    monkeypatch.setitem(hw.SPECS, "no-dcn", no_dcn)
    fleet = _fleet(FleetPlan, ServingPlan, "round_robin", 2, 1, hw="no-dcn")
    router = Router.from_plan(fleet, seed=0, device="cpu",
                              _built=_built("torch", models))
    assert router.bytes_per_tick == math.inf
    assert router.transit_ticks(10**12) == 1
    items = _items(twl, WorkloadProfile, rate=1.0, duration=8.0)
    drive_fleet(router, items)
    ts = router.transit_stats()
    assert ts["ticks"] == ts["handoffs"] > 0
    assert ts["bytes_per_tick"] is None


def test_full_width_rwkv_column_rounds_to_one_tick(models):
    """An rwkv6-1.6b slot column at full width (24 layers x 32 heads x
    64 x 64 f32 state, plus the shift states and the length) is ~12.8 MB,
    under the H100 spec's ~47.75 MB a tick: every full-width hand-off
    takes the 1-tick floor."""
    model = build_model(get_config(ARCH))
    specs = model.cache_specs(1, 64)
    column = sum(int(np.prod(s.shape)) * s.dtype.itemsize
                 for s in _leaves(specs))
    assert 12.5e6 < column < 13.5e6
    fleet = _fleet(FleetPlan, ServingPlan, "least_queue", 2, 1)
    router = Router.from_plan(fleet, seed=0, device="cpu",
                              _built=_built("torch", models))
    assert router.transit_ticks(column) == 1
    assert router.transit_ticks(3 * column) == 1
    assert router.transit_ticks(int(router.bytes_per_tick) + 1) == 2


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# snapshot compatibility: JAX's messages
# ---------------------------------------------------------------------------


def _port_name(keystr: str) -> str:
    """JAX's ``['blocks']['p0']['k']`` as the port's ``blocks/p0/k``."""
    return "/".join(re.findall(r"\['([^']*)'\]", keystr))


def _as_port(errs):
    out = []
    for e in errs:
        name, rest = e.split(":", 1)
        out.append(_port_name(name) + ":" + rest)
    return out


def _live_snapshot(engine):
    req = engine.submit([1, 2, 3], max_new_tokens=8)
    for _ in range(8):
        engine.step()
        if any(r.uid == req.uid and len(r.output) >= 1
               for _, r in engine.sm.running()):
            break
    slot = next(s for s, r in engine.sm.running() if r.uid == req.uid)
    return engine.sm.snapshot_many([slot])[0], req


def _engines(pkg, arch, lens):
    jm, jp, tm, tp = _models(arch)
    if pkg == "jax":
        return [JEngine.from_plan(JPlan(arch=arch, max_batch=2, max_len=L),
                                  jp, model=jm, sharder=NOSH, seed=0)
                for L in lens]
    return [ServingEngine.from_plan(ServingPlan(arch=arch, max_batch=2,
                                                max_len=L), tp, model=tm,
                                    seed=0) for L in lens]


def test_snapshot_compat_messages_equal_jax():
    jsrc, jdst = _engines("jax", "qwen2.5-14b", (MAX_LEN, 64))
    tsrc, tdst = _engines("torch", "qwen2.5-14b", (MAX_LEN, 64))
    jsnap, _ = _live_snapshot(jsrc)
    tsnap, treq = _live_snapshot(tsrc)

    jerrs = jdst.sm.snapshot_compat_errors(jsnap)
    terrs = tdst.sm.snapshot_compat_errors(tsnap)
    assert terrs and all("max_len differs" in e for e in terrs)
    assert terrs == _as_port(jerrs)
    assert {e.split(":")[0] for e in terrs} <= set(tdst.sm._col_specs)
    with pytest.raises(ValueError) as te:
        tdst.sm.check_snapshot_compat(tsnap)
    with pytest.raises(ValueError) as je:
        jdst.sm.check_snapshot_compat(jsnap)
    assert str(te.value).splitlines()[0] == str(je.value).splitlines()[0]
    # restore re-checks every time: a bad hand-off never scatters
    with pytest.raises(ValueError, match="snapshot incompatible"):
        tdst.sm.restore(0, tsnap, treq)
    assert tdst.sm.n_active() == 0
    assert tsrc.sm.snapshot_compat_errors(tsnap) == []

    # another pytree: missing and extra leaves, both sides named
    jerrs = jsrc.sm.snapshot_compat_errors(
        JSnapshot(cache_col={"bogus": jsnap.cache_col}, next_token=0))
    terrs = tsrc.sm.snapshot_compat_errors(
        SlotSnapshot(cache_col={"bogus": tsnap.cache_col}, next_token=0))
    assert any("missing from the snapshot" in e for e in terrs)
    assert any("not in this engine's cache spec" in e for e in terrs)
    assert sorted(terrs) == sorted(_as_port(jerrs))

    # a dtype mismatch, in numpy's names as JAX prints them
    col = dict(tsnap.cache_col)
    col["lengths"] = col["lengths"].to(dtype=__import__("torch").int64)
    terrs = tsrc.sm.snapshot_compat_errors(
        SlotSnapshot(cache_col=col, next_token=0))
    assert terrs == ["lengths: dtype int64 != expected int32"]


def test_rwkv_snapshot_restores_into_any_max_len(models):
    tsrc, tdst = _engines("torch", ARCH, (MAX_LEN, 64))
    snap, req = _live_snapshot(tsrc)
    assert tdst.sm.snapshot_compat_errors(snap) == []
    tsrc.sm.release(next(s for s, r in tsrc.sm.running() if r is req))
    tdst.sm.restore(1, snap, req)
    assert tdst.sm.n_active() == 1


# ---------------------------------------------------------------------------
# FleetPlan, its JSON and the fleet grid
# ---------------------------------------------------------------------------


def _bad_fleets(F, P):
    a, b = P(arch=ARCH, max_batch=2, max_len=MAX_LEN), \
        P(arch=ARCH, max_batch=2, max_len=64)
    return [
        lambda: F(replicas=(a, b), n_prefill=1),
        lambda: F.replicated(a, 2, routing="bogus"),
        lambda: F.replicated(a, 2, n_prefill=2),
        lambda: F(replicas=()),
        lambda: F.replicated(a, 2, transit_bytes_per_tick=0.0),
        lambda: F.replicated(P(arch=ARCH, max_batch=0), 2),
        lambda: F(replicas=(a, dataclasses.replace(b, reduced=False),
                            a), n_prefill=2),
    ]


def _error(fn):
    try:
        fn().validate()
    except ValueError as e:
        return str(e)
    return None


def test_fleet_plan_validate_messages_equal_jax():
    jerrs = [_error(f) for f in _bad_fleets(JFleet, JPlan)]
    terrs = [_error(f) for f in _bad_fleets(FleetPlan, ServingPlan)]
    assert all(jerrs)
    # the registries' listings are each package's (the same names)
    assert terrs == jerrs
    a = ServingPlan(arch=ARCH, max_batch=2, max_len=MAX_LEN)
    FleetPlan(replicas=(a, dataclasses.replace(a, max_len=64))).validate()


def test_fleet_plan_round_trips_through_json(tmp_path):
    fleet = FleetPlan.replicated(
        ServingPlan(arch=ARCH, max_batch=4, max_len=MAX_LEN), 3,
        routing="least_queue", n_prefill=1, transit_bytes_per_tick=1e6,
        provenance={"source": "test"}).validate()
    d = tio.fleet_to_dict(fleet)
    assert d["schema"] == tio.FLEET_SCHEMA == jio.FLEET_SCHEMA
    assert d["hw"] == "h100-sxm"
    assert tio.fleet_from_dict(json.loads(json.dumps(d))) == fleet
    path = tmp_path / "fleet.json"
    tio.save_fleet_plan(fleet, str(path))
    assert tio.load_fleet_plan(str(path)) == fleet
    with pytest.raises(ValueError, match="unsupported fleet schema"):
        tio.fleet_from_dict({**d, "schema": "fleet_plan/v0"})
    with pytest.raises(ValueError, match="unknown fleet fields"):
        tio.fleet_from_dict({**d, "bogus": 1})


def test_fleet_dicts_cross_packages_with_only_hw_replaced(tmp_path):
    jfleet = _fleet(JFleet, JPlan, "slo_feedback", 3, 1,
                    transit_bytes_per_tick=5e5, provenance={"k": [1, 2]})
    jd = json.loads(json.dumps(jio.fleet_to_dict(jfleet)))
    # JAX's default hw is its TPU spec: refused here by name
    with pytest.raises(ValueError, match=r"fleet\.hw 'tpu-v5e' is not a "
                                         r"known hardware spec"):
        tio.fleet_from_dict(jd).validate()
    tfleet = tio.fleet_from_dict({**jd, "hw": "h100-sxm"}).validate()
    td = json.loads(json.dumps(tio.fleet_to_dict(tfleet)))
    assert td == {**jd, "hw": "h100-sxm"}
    with pytest.raises(ValueError, match=r"fleet\.hw 'h100-sxm'"):
        jio.fleet_from_dict(td).validate()
    assert jio.fleet_from_dict({**td, "hw": "tpu-v5e"}).validate() == jfleet
    path = tmp_path / "f.json"
    jio.save_fleet_plan(jfleet, str(path))
    with pytest.raises(ValueError, match="fleet.hw"):
        tio.load_fleet_plan(str(path))


def test_fleet_sweep_equals_jax():
    assert [c.name for c in FLEET_SERVING_SWEEP] == \
        [c.name for c in J_FLEET_SWEEP]
    assert len(FLEET_SERVING_SWEEP) == 6
    for t, j in zip(FLEET_SERVING_SWEEP, J_FLEET_SWEEP):
        td, jd = tio.fleet_to_dict(t.fleet), jio.fleet_to_dict(j.fleet)
        assert (td.pop("hw"), jd.pop("hw")) == ("h100-sxm", "tpu-v5e")
        assert td == jd
        assert t.workload.to_json() == j.workload.to_json()
        assert (t.family, t.tag) == (j.family, j.tag)
        t.fleet.validate()
    assert FLEET_SERVING_SWEEP[0].fleet.summary() == \
        J_FLEET_SWEEP[0].fleet.summary()


# ---------------------------------------------------------------------------
# the fleet CLI
# ---------------------------------------------------------------------------


def test_fleet_cli_equals_jax(capsys, tmp_path, monkeypatch):
    """Both launchers serve a disaggregated fleet of reduced rwkv6 on the
    virtual clock: the merged trace files are byte-equal, and so are the
    summary and the per-replica lines.  The transit line's bytes a tick
    is each package's hardware model's."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve

    args = ["--arch", "rwkv6-1.6b", "--reduced", "--arrival", "poisson",
            "--rate", "1.2", "--duration", "10", "--replicas", "3",
            "--prefill-replicas", "1", "--routing", "least_queue"]
    tserve.main(args + ["--device", "cpu", "--trace-out",
                        str(tmp_path / "t.json")])
    tout = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve"] + args + [
        "--trace-out", str(tmp_path / "j.json")])
    jserve.main()
    jout = capsys.readouterr().out
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()

    def lines(out):
        keep = ("fleet:", "replaying", "completed", "  queue_wait",
                "  ttft", "  tpot", "  replica[")
        return [ln for ln in out.splitlines() if ln.startswith(keep)]

    assert len(lines(tout)) == 9 and lines(tout) == lines(jout)
    transit = lambda out: [ln.split(" (bytes/tick")[0]
                           for ln in out.splitlines()
                           if ln.startswith("transit:")]
    assert len(transit(tout)) == 1 and transit(tout) == transit(jout)
    assert "(bytes/tick 47752818.6" in tout
    conserved = lambda out: [ln.split(" (")[1] for ln in out.splitlines()
                             if ln.startswith("wall:")]
    assert conserved(tout) == conserved(jout)


def test_fleet_cli_refuses_what_jax_refuses(capsys):
    from repro_torch.launch import serve as tserve

    base = ["--arch", "rwkv6-1.6b", "--reduced", "--device", "cpu"]
    for extra, msg in (
            (["--routing", "least_queue"], "--routing only applies"),
            (["--replicas", "2"], "needs an arrival process"),
            (["--replicas", "2", "--prefill-replicas", "2", "--arrival",
              "poisson"], "--prefill-replicas must leave"),
            (["--replicas", "2", "--arrival", "poisson", "--clock",
              "wall"], "requires --clock virtual")):
        with pytest.raises(SystemExit):
            tserve.main(base + extra)
        assert msg in capsys.readouterr().err
