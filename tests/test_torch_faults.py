"""Port parity of fault injection and crash restart
(``repro_torch.serving.faults``, the engine's recovery layer,
``checkpoint()``/``restore()``) against a live JAX engine.

The same seeded workload under the same :class:`FaultPlan` goes through
the JAX package's ``drive_resilient`` and the port's, on reduced rwkv6
and reduced qwen2.5-14b (dense and ``paged:8``), with the weights of
tests/test_torch_engine.py.  Requests carry no ``eos_id``, so the
schedule depends only on lengths, budgets, deadlines and the faults:
tick stamps, output lengths, retries, ``fault_events``, ``fault_stats()``,
the JAX keys of ``stats()`` (``host_syncs`` included), restarts, ticks
replayed, utilization and ``aggregate`` must be equal.  Greedy tokens
must be equal but where JAX's top-2 margin at a request's first
differing token is under the LM tolerance (as in
tests/test_torch_engine.py).  Each fault kind runs alone on rwkv6
(``max_batch`` 2, ``max_len`` 32, the workload of tests/test_faults.py;
the stall and the failed prefill with synchronous admission), a poison
then a kill, one poison and one dropped readback at ``sync_every=4``
too; then three
storm cells at reduced width, planned as the chaos cells are
(``max_batch`` 4, ``max_len`` 64, ``retry_budget`` 3, ``watchdog_ticks``
4, Poisson 0.8 over 24 units, prompts 4-12, 6-10 new, deadline slack
1.5, a checkpoint every 8 ticks, storm seed = its size).

Within the port: completed requests of a storm have the fault-free
run's tokens; a kill and restore at temperature 0.7 equals the
uninterrupted run; every cache, view, pool and index tensor keeps its
``data_ptr`` through poison, scrub, rollback, resume and restore.
"""

import functools
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.plan.plan import ServingPlan as JPlan
from repro.plan.plan import WorkloadProfile as JProfile
from repro.serving import FaultInjector as JInjector
from repro.serving import FaultPlan as JFaultPlan
from repro.serving import FaultSpec as JSpec
from repro.serving import ServingEngine as JEngine
from repro.serving import drive_resilient as j_drive_resilient
from repro.serving import metrics as jmet
from repro.serving import workload as jwl
from repro.serving import faults as jfaults
from repro.serving.faults import make_storm as j_make_storm
from repro_torch.checkpoint import CheckpointManager
from repro_torch.models.params import tree_leaves
from repro_torch.plan.plan import ServingPlan as TPlan
from repro_torch.plan.plan import WorkloadProfile as TProfile
from repro_torch.serving import (FaultInjector, FaultPlan, FaultSpec,
                                 ServingEngine, VirtualClock,
                                 drive_resilient, make_storm)
from repro_torch.serving import faults as tfaults
from repro_torch.serving import metrics as tmet
from repro_torch.serving import workload as twl
from repro_torch.serving.paged import PagedSlotManager
from test_torch_engine import NOSH, TIE_REL, _jax_margin, _models
from test_torch_workload import _same

VOCAB = 503
# the JAX keys of stats() the two engines share
STAT_KEYS = ["completed", "total_tokens", "prefill_calls", "instant_admits",
             "decode_chunks", "ticks", "mean_util", "active", "queued",
             "host_syncs", "preemptions", "resumes", "evicted_tokens",
             "shed"]
SMALL = dict(max_batch=2, max_len=32)
CHAOS = dict(max_batch=4, max_len=64, retry_budget=3, watchdog_ticks=4)
CHAOS_DURATION = 24.0
KEEP = 100          # every checkpoint step stays, for the comparison


def _small_items(mod):
    return mod.make_workload("poisson", rate=0.8, duration=20.0, seed=7,
                             vocab_size=VOCAB, prompt_len=(3, 8),
                             max_new_tokens=(4, 10))


def _chaos_items(mod, profile_cls):
    prof = profile_cls(kind="poisson", rate=0.8, duration=CHAOS_DURATION,
                       prompt_len=(4, 12), max_new_tokens=(6, 10),
                       deadline_slack=1.5)
    return mod.profile_items(prof, vocab_size=VOCAB, seed=0)


def _spec(kind, tick, **kw):
    return dict(kind=kind, tick=tick, **kw)


# name -> (arch, plan knobs, faults: spec dicts or ("storm", n), items,
#          checkpoint_every or None)
CASES = {
    "poison_nan": ("rwkv6-1.6b", SMALL,
                   [_spec("poison_slot", 4, mode="nan", seed=9)],
                   "small", None),
    "poison_garbage": ("rwkv6-1.6b", SMALL,
                       [_spec("poison_slot", 4, mode="garbage", seed=9)],
                       "small", None),
    "retry_exhausted": ("rwkv6-1.6b", dict(SMALL, retry_budget=0),
                        [_spec("poison_slot", 4)], "small", None),
    # these two admit synchronously (the storms overlap their admissions)
    "stall_watchdog": ("rwkv6-1.6b", dict(SMALL, watchdog_ticks=3,
                                          overlap_prefill=False),
                       [_spec("stall_slot", 5, slot=1)], "small", None),
    "fail_prefill": ("rwkv6-1.6b", dict(SMALL, overlap_prefill=False),
                     [_spec("fail_prefill", 2)], "small", None),
    "drop_readback": ("rwkv6-1.6b", SMALL, [_spec("drop_readback", 6)],
                      "small", None),
    "kill_restart": ("rwkv6-1.6b", SMALL, [_spec("kill_engine", 9)],
                     "small", 4),
    # the checkpoint the kill restores from (tick 5) holds the rolled-back
    # request's snapshot in the queue (saved_cols)
    "poison_kill": ("rwkv6-1.6b", SMALL,
                    [_spec("poison_slot", 4), _spec("kill_engine", 5)],
                    "small", 5),
    "poison_sync4": ("rwkv6-1.6b", dict(SMALL, sync_every=4),
                     [_spec("poison_slot", 5, slot=1, mode="garbage",
                            seed=3)], "small", None),
    "drop_sync4": ("rwkv6-1.6b", dict(SMALL, sync_every=4),
                   [_spec("drop_readback", 6)], "small", None),
    "rwkv6-1.6b/dense/storm8": ("rwkv6-1.6b", dict(CHAOS), ("storm", 8),
                                "chaos", 8),
    "qwen2.5-14b/dense/storm4": ("qwen2.5-14b", dict(CHAOS), ("storm", 4),
                                 "chaos", 8),
    "qwen2.5-14b/paged:8/storm4": ("qwen2.5-14b",
                                   dict(CHAOS, cache_layout="paged:8"),
                                   ("storm", 4), "chaos", 8),
}
KINDS = [n for n in CASES if "/" not in n]
CELLS = [n for n in CASES if "/" in n]


def _fault_plan(pkg, faults):
    """The case's fault plan in package ``pkg`` ("jax" or "torch"),
    built from one JSON dict."""
    if faults[0] == "storm":
        n = faults[1]
        mk = j_make_storm if pkg == "jax" else make_storm
        return mk(duration=int(CHAOS_DURATION), seed=n, n_faults=n,
                  max_batch=CHAOS["max_batch"])
    cls = JFaultPlan if pkg == "jax" else FaultPlan
    return cls.from_dict({"schema": "fault_plan/v1", "faults": faults})


def _run(pkg, name, tmpdir, **plan_extra):
    """One case through ``pkg``'s ``drive_resilient``.  Returns (report,
    requests, checkpoint manager or None)."""
    arch, knobs, faults, items, every = CASES[name]
    jm, jp, tm, tp = _models(arch)
    knobs = dict(knobs, **plan_extra)
    if pkg == "jax":
        plan = JPlan(arch=arch, reduced=True, **knobs).resolve()
        eng = JEngine.from_plan(plan, jp, model=jm, sharder=NOSH)
        its = _small_items(jwl) if items == "small" else \
            _chaos_items(jwl, JProfile)
        mgr = JManager(str(tmpdir), keep=KEEP) if every else None
        rep = j_drive_resilient(eng, its, jwl.VirtualClock(),
                                injector=JInjector(_fault_plan(pkg, faults)),
                                manager=mgr, checkpoint_every=every or 8)
    else:
        plan = TPlan(arch=arch, reduced=True, **knobs).resolve()
        eng = ServingEngine.from_plan(plan, tp, model=tm)
        its = _small_items(twl) if items == "small" else \
            _chaos_items(twl, TProfile)
        mgr = CheckpointManager(str(tmpdir), keep=KEEP) if every else None
        rep = drive_resilient(eng, its, VirtualClock(),
                              injector=FaultInjector(_fault_plan(pkg,
                                                                 faults)),
                              manager=mgr, checkpoint_every=every or 8)
    return rep, mgr


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case's JAX and port runs, made once for the module."""
    cache = {}

    def get(pkg, name):
        if (pkg, name) not in cache:
            d = tmp_path_factory.mktemp(f"{pkg}_{name.replace('/', '_')}")
            cache[(pkg, name)] = _run(pkg, name, d)
        return cache[(pkg, name)]
    return get


def _stamps(r):
    return (r.uid, r.t_submit, r.t_admit, r.t_first, r.t_done,
            len(r.output), r.done, r.shed, r.retries, r.n_preempts,
            list(r.t_preempts), list(r.t_resumes))


def _view(rep, met):
    """The deterministic view of a run: every integer of its schedule,
    its fault record and its aggregate."""
    eng = rep.engine
    st = eng.stats()
    stats = {k: st[k] for k in STAT_KEYS}
    stats["shapes"] = st.get("prefill_compiles", st.get("prefill_shapes"))
    return dict(
        stamps=[_stamps(r) for r in rep.requests],
        events=rep.fault_events, faults=eng.fault_stats(), stats=stats,
        restarts=[rep.n_restarts, rep.restart_ticks_lost],
        util=list(eng.util_history), lost=rep.lost_uids(),
        agg=met.aggregate(rep.requests, ticks=eng.ticks,
                          util_history=eng.util_history))


@functools.lru_cache(maxsize=None)
def _margin(arch, prompt, prefix):
    jm, jp, _, _ = _models(arch)
    return _jax_margin(jm, jp, prompt, prefix)


def _check_tokens(arch, jreqs, treqs):
    """Equal greedy tokens, up to a request's first token where JAX's
    top-2 margin is under the LM tolerance."""
    for jr, tr in zip(jreqs, treqs):
        diff = [i for i, (a, b) in enumerate(zip(jr.output, tr.output))
                if a != b]
        if diff:
            margin, scale = _margin(arch, tuple(jr.prompt),
                                    tuple(jr.output[:diff[0]]))
            assert margin < TIE_REL[arch] * scale, (
                f"request {jr.uid}: token {diff[0]} differs at a JAX top-2 "
                f"margin {margin:.3g} >= {TIE_REL[arch] * scale:.3g}")


def _compare(runs, name):
    (jrep, _), (trep, _) = runs("jax", name), runs("torch", name)
    jv, tv = _view(jrep, jmet), _view(trep, tmet)
    for key in jv:
        assert _same(tv[key], jv[key]), key
    assert not tv["lost"]
    _check_tokens(CASES[name][0], jrep.requests, trep.requests)
    return jrep, trep


@pytest.mark.parametrize("name", KINDS)
def test_fault_kind_matches_live_jax(runs, name):
    jrep, trep = _compare(runs, name)
    fs = trep.engine.fault_stats()
    assert fs["injected"] == len(CASES[name][2])
    want = {"poison_kill": ("quarantined", 1),
            "poison_nan": ("quarantined", 1), "poison_garbage":
            ("quarantined", 1), "retry_exhausted": ("shed", 1),
            "stall_watchdog": ("watchdog_evictions", 1),
            "fail_prefill": ("retries", 1), "drop_readback":
            ("quarantined", 2), "kill_restart": ("injected", 1),
            "poison_sync4": ("quarantined", 1), "drop_sync4":
            ("quarantined", 2)}[name]
    assert fs[want[0]] == want[1]
    if name == "kill_restart":
        assert trep.n_restarts == 1
        assert [e["kind"] for e in trep.fault_events] == ["kill_engine"]
    if name == "poison_kill":
        assert trep.n_restarts == 1 and trep.engine.restored_from[
            "step"] == 5 == jrep.engine.restored_from["step"]
    if name == "retry_exhausted":
        assert len(trep.shed_uids) == 1 and fs["retries"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_storm_cell_matches_live_jax(runs, name):
    jrep, trep = _compare(runs, name)
    kinds = {e["kind"] for e in trep.fault_events}
    assert len(kinds) >= 3, kinds
    if name.endswith("storm8"):
        assert trep.n_restarts == 1
    if "paged" in name:
        trep.engine.sm.check_invariants()
        jrep.engine.sm.check_invariants()
        assert trep.engine.sm.blocks_free() == jrep.engine.sm.blocks_free()


def test_stall_without_watchdog_refused():
    _, _, tm, tp = _models("rwkv6-1.6b")
    eng = ServingEngine.from_plan(TPlan(arch="rwkv6-1.6b", reduced=True,
                                        **SMALL).resolve(), tp, model=tm)
    inj = FaultInjector(FaultPlan((FaultSpec("stall_slot", tick=5),)))
    with pytest.raises(ValueError, match="watchdog"):
        eng.attach_injector(inj)
    with pytest.raises(ValueError, match="CheckpointManager"):
        drive_resilient(eng, _small_items(twl), VirtualClock(),
                        injector=FaultInjector(FaultPlan(
                            (FaultSpec("kill_engine", tick=3),))))
    with pytest.raises(ValueError, match="VirtualClock"):
        drive_resilient(eng, _small_items(twl), twl.WallClock())


@pytest.mark.parametrize("seed", [0, 1, 5, 11])
def test_plans_and_storms_equal_jax(seed):
    for n, b in ((2, 2), (4, 4), (8, 4), (8, 2)):
        for kinds in (tfaults.FAULT_KINDS, ("poison_slot", "kill_engine"),
                      ("stall_slot", "drop_readback", "fail_prefill")):
            t = make_storm(duration=30, seed=seed, n_faults=n, max_batch=b,
                           kinds=kinds)
            j = j_make_storm(duration=30, seed=seed, n_faults=n,
                             max_batch=b, kinds=kinds)
            assert t.to_dict() == j.to_dict()
            assert JFaultPlan.from_dict(json.loads(json.dumps(
                t.to_dict()))) == j
            assert FaultPlan.from_dict(json.loads(json.dumps(
                j.to_dict()))) == t
    spec = FaultSpec("poison_slot", tick=7, slot=2, mode="garbage", seed=3)
    assert spec.to_json() == JSpec("poison_slot", tick=7, slot=2,
                                   mode="garbage", seed=3).to_json()
    for bad in ({"kind": "melt", "tick": 1}, {"kind": "poison_slot"},
                {"kind": "poison_slot", "tick": 1, "wat": 2}):
        with pytest.raises(ValueError) as te:
            FaultSpec.from_json(bad)
        with pytest.raises(ValueError) as je:
            JSpec.from_json(bad)
        assert str(te.value) == str(je.value)
    assert (tfaults.FAULT_SCHEMA, tfaults.FAULT_KINDS,
            tfaults.POISON_MODES) == (jfaults.FAULT_SCHEMA,
                                      jfaults.FAULT_KINDS,
                                      jfaults.POISON_MODES)


def test_injector_one_shot():
    inj = FaultInjector(FaultPlan((FaultSpec("poison_slot", tick=2),)))
    assert inj.due(1) == []
    (idx, spec), = inj.due(5)
    inj.fire(idx, 5)
    assert inj.due(5) == [] and inj.pending() == 0
    assert inj.log[0]["fired_at"] == 5
    with pytest.raises(ValueError, match="already fired"):
        inj.fire(idx, 6)


def _npy_leaves(step_dir):
    return {p.stem: np.load(p) for p in step_dir.glob("*.npy")}


@pytest.mark.parametrize("name", ["poison_kill", "kill_restart",
                                  "rwkv6-1.6b/dense/storm8",
                                  "qwen2.5-14b/paged:8/storm4"])
def test_checkpoint_extra_equals_jax(runs, name):
    """Every checkpoint step of a faulted run, in both packages: the JSON
    ``extra["engine"]`` equal (outputs by length; their tokens as
    above), the same leaf names, every leaf but ``key`` of one shape and
    dtype, the integer leaves equal."""
    (jrep, jmgr), (trep, tmgr) = runs("jax", name), runs("torch", name)
    steps = tmgr.all_steps()
    assert steps and steps == jmgr.all_steps()
    if name == "poison_kill":
        assert any("saved_cols" in leaf for leaf in
                   tmgr.manifest(5)["leaves"])
    for step in steps:
        je = jmgr.manifest(step)["extra"]["engine"]
        te = tmgr.manifest(step)["extra"]["engine"]
        reqs = {k: (je[k], te[k]) for k in ("finished", "queue")}
        reqs["slots"] = (list(je["slots"].values()),
                         list(te["slots"].values()))
        for jl, tl in reqs.values():
            _check_tokens(CASES[name][0],
                          [JRequestView(d) for d in jl],
                          [JRequestView(d) for d in tl])
        strip = lambda e: json.loads(json.dumps(e), object_hook=lambda d: {
            k: (len(v) if k == "output" else v) for k, v in d.items()})
        assert strip(te) == strip(je)
        assert jmgr.manifest(step)["leaves"] == tmgr.manifest(step)["leaves"]
        jl = _npy_leaves(Path(jmgr.directory) / f"step_{step:010d}")
        tl = _npy_leaves(Path(tmgr.directory) / f"step_{step:010d}")
        assert jl.keys() == tl.keys()
        same_tokens = all(
            a.output == b.output for a, b in zip(jrep.requests,
                                                 trep.requests))
        for leaf in jl:
            if leaf == "key":
                continue
            assert (jl[leaf].shape, jl[leaf].dtype) == \
                (tl[leaf].shape, tl[leaf].dtype), leaf
            if jl[leaf].dtype.kind in "iub" and (
                    leaf != "next_token" or same_tokens):
                assert np.array_equal(jl[leaf], tl[leaf]), leaf


class JRequestView:
    """A journaled request as ``_check_tokens`` reads it."""

    def __init__(self, d):
        self.uid, self.prompt, self.output = d["uid"], d["prompt"], \
            d["output"]


def test_storm_keeps_fault_free_tokens(runs):
    """Recovery is clean: every request a storm completes has the tokens
    of the port's fault-free drive of the same workload."""
    for name in ("rwkv6-1.6b/dense/storm8", "qwen2.5-14b/paged:8/storm4"):
        arch, knobs = CASES[name][:2]
        _, _, tm, tp = _models(arch)
        eng = ServingEngine.from_plan(TPlan(arch=arch, reduced=True,
                                            **knobs).resolve(), tp, model=tm)
        base = {r.uid: r.output for r in twl.drive(
            eng, _chaos_items(twl, TProfile), VirtualClock())}
        rep, _ = runs("torch", name)
        done = rep.completed
        assert len(done) >= len(base) - len(rep.shed_uids) > 0
        assert all(r.output == base[r.uid] for r in done)


def test_kill_restore_at_temperature_equals_uninterrupted(tmp_path):
    """The generator's state rides in the checkpoint: at temperature 0.7
    a killed and restored run is the uninterrupted run, tokens and
    all."""
    _, _, tm, tp = _models("rwkv6-1.6b")
    plan = TPlan(arch="rwkv6-1.6b", reduced=True, temperature=0.7,
                 **SMALL).resolve()
    items = _small_items(twl)
    plain = drive_resilient(ServingEngine.from_plan(plan, tp, model=tm,
                                                    seed=4),
                            items, VirtualClock())
    killed = drive_resilient(
        ServingEngine.from_plan(plan, tp, model=tm, seed=4), items,
        VirtualClock(),
        injector=FaultInjector(FaultPlan((FaultSpec("kill_engine",
                                                    tick=11),))),
        manager=CheckpointManager(str(tmp_path)), checkpoint_every=4)
    assert killed.n_restarts == 1 and killed.restart_ticks_lost > 0
    assert [(_stamps(r), r.output) for r in killed.requests] == \
        [(_stamps(r), r.output) for r in plain.requests]
    assert len({t for r in plain.requests for t in r.output}) > 10


def _cache_tensors(eng):
    out = tree_leaves(eng.sm.cache)
    if isinstance(eng.sm, PagedSlotManager):
        out = out + eng.sm.tensors()
    return out


def test_cache_tensors_keep_their_addresses(tmp_path, monkeypatch):
    """A paged qwen storm with every kind, the kill included: each
    engine's view, pool and index tensors keep the addresses they had
    when it was built (its decode loop's) through poison, scrub,
    rollback, resume and the restore's writes."""
    watched = []
    real = ServingEngine.from_plan.__func__

    def from_plan(cls, *a, **k):
        eng = real(cls, *a, **k)
        ptrs = [t.data_ptr() for t in _cache_tensors(eng)]
        step = eng.step

        def checked(*sa, **sk):
            try:
                return step(*sa, **sk)
            finally:
                if eng.sm is not None:
                    assert [t.data_ptr() for t in _cache_tensors(eng)] \
                        == ptrs
                    assert all(a is b for a, b in zip(
                        tree_leaves(eng._loop.cache),
                        tree_leaves(eng.sm.cache)))
                    eng.sm.check_invariants()
                    watched[-1][1] += 1
        eng.step = checked
        watched.append([eng, 0])
        return eng

    monkeypatch.setattr(ServingEngine, "from_plan", classmethod(from_plan))
    arch = "qwen2.5-14b"
    _, _, tm, tp = _models(arch)
    plan = TPlan(arch=arch, reduced=True, cache_layout="paged:8",
                 **CHAOS).resolve()
    rep = drive_resilient(
        ServingEngine.from_plan(plan, tp, model=tm),
        _chaos_items(twl, TProfile), VirtualClock(),
        injector=FaultInjector(make_storm(duration=24, seed=8, n_faults=8,
                                          max_batch=4)),
        manager=CheckpointManager(str(tmp_path)), checkpoint_every=8)
    fs = rep.engine.fault_stats()
    assert rep.n_restarts == 1 and len(watched) == 2
    assert all(n > 0 for _, n in watched)
    assert fs["quarantined"] > 0 and fs["retries"] > 0
    assert rep.engine.resumes > 0 and not rep.lost_uids()
    assert watched[0][0].sm is None        # the dead engine was closed


def _column_bytes(cache, slot):
    """Every leaf's slot column (slot axis 1; ``lengths`` 0) as raw
    bytes, by path; from JAX arrays or torch tensors."""
    out = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], path + (k,))
            return
        if isinstance(tree, torch.Tensor):
            a = (tree.view(torch.int16) if tree.dtype == torch.bfloat16
                 else tree).numpy()
        else:
            a = np.asarray(tree)
            a = a.view(np.int16) if a.dtype.name == "bfloat16" else a
        col = np.take(a, [slot], axis=0 if path == ("lengths",) else 1)
        out[path] = (col.dtype.str, col.tobytes())
    walk(cache, ())
    return out


@pytest.mark.parametrize("arch,layout", [("rwkv6-1.6b", "dense"),
                                         ("qwen2.5-14b", "paged:8")])
def test_scribble_and_scrub_equal_jax(arch, layout):
    """``_poison`` writes the JAX engine's scribble and ``scrub`` its
    wipe: after one admission in both engines, the slot's whole column
    (as the pool holds it, under paging) is bit-equal to the JAX one
    after a garbage poison, a NaN poison and a scrub."""
    jm, jp, tm, tp = _models(arch)
    plan = dict(arch=arch, reduced=True, cache_layout=layout, **SMALL)
    jeng = JEngine.from_plan(JPlan(**plan).resolve(), jp, model=jm,
                             sharder=NOSH)
    teng = ServingEngine.from_plan(TPlan(**plan).resolve(), tp, model=tm)
    for eng in (jeng, teng):
        eng.submit(list(range(5, 14)), max_new_tokens=4)
        eng.submit(list(range(5, 9)), max_new_tokens=4)
        eng.step()

    def same(float_check):
        teng.sm.materialize()        # the pool's state, as JAX reads it
        jc = _column_bytes(jeng.sm.cache, 1)
        tc = _column_bytes(teng.sm.cache, 1)
        assert jc == tc
        floats = [t for t in tree_leaves(teng.sm.cache)
                  if t.is_floating_point()]
        assert all(float_check(t[:, 1]) for t in floats)

    for mode, seed in (("garbage", 5), ("nan", 0)):
        spec = JSpec("poison_slot", tick=0, slot=1, mode=mode, seed=seed)
        jeng._poison(1, spec)
        teng._poison(1, spec)
        same(lambda t: not bool(torch.isfinite(t.float()).all()))
    jeng.sm.scrub([1])
    teng.sm.scrub([1])
    same(lambda t: not bool(t.any()))


def test_no_fault_engine_shows_no_faults():
    _, _, tm, tp = _models("rwkv6-1.6b")
    eng = ServingEngine.from_plan(TPlan(arch="rwkv6-1.6b", reduced=True,
                                        **SMALL).resolve(), tp, model=tm)
    twl.drive(eng, _small_items(twl), VirtualClock())
    assert not any(k.startswith("fault") for k in eng.stats())
    assert eng.fault_events == []
    assert eng.fault_stats() == {"injected": 0, "quarantined": 0,
                                 "retries": 0, "shed": 0,
                                 "watchdog_evictions": 0}


def test_serve_cli_fault_lines_equal_jax(tmp_path, capsys, monkeypatch):
    """Both launchers on reduced rwkv6 under one storm file (every kind,
    the kill included): the ``faults:`` and ``recovery:`` lines equal."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve

    storm = tmp_path / "storm.json"
    make_storm(duration=16, seed=3, n_faults=5, max_batch=4).save(str(storm))
    args = ["--arch", "rwkv6-1.6b", "--reduced", "--arrival", "poisson",
            "--rate", "0.8", "--duration", "16", "--max-new", "6",
            "--fault-spec", str(storm), "--watchdog-ticks", "3",
            "--retry-budget", "2", "--checkpoint-every", "4"]
    tserve.main(args + ["--device", "cpu", "--checkpoint-dir",
                        str(tmp_path / "t")])
    tout = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve"] + args + [
        "--checkpoint-dir", str(tmp_path / "j")])
    jserve.main()
    jout = capsys.readouterr().out
    lines = lambda out, tag: [ln for ln in out.splitlines()
                              if ln.startswith(tag)]
    for tag in ("faults:", "recovery:"):
        assert len(lines(tout, tag)) == 1
        assert lines(tout, tag) == lines(jout, tag)
    assert "1 engine restarts" in lines(tout, "faults:")[0]


@pytest.mark.parametrize("bad,msg", [
    (["--arrival", "batch"], "needs an arrival process"),
    (["--clock", "wall"], "requires --clock virtual"),
    (["--no-watchdog"], "watchdog is off"),
    (["--no-dir"], "--checkpoint-dir"),
])
def test_serve_cli_fault_flag_errors(tmp_path, capsys, bad, msg):
    from repro_torch.launch import serve as tserve

    storm = tmp_path / "storm.json"
    make_storm(duration=16, seed=3, n_faults=5, max_batch=4).save(str(storm))
    args = ["--arch", "rwkv6-1.6b", "--reduced", "--arrival", "poisson",
            "--device", "cpu", "--fault-spec", str(storm)]
    if bad != ["--no-watchdog"]:
        args += ["--watchdog-ticks", "3"]
    if bad != ["--no-dir"]:
        args += ["--checkpoint-dir", str(tmp_path / "c")]
    if bad[0].startswith("--arrival") or bad[0] == "--clock":
        args += bad
    with pytest.raises(SystemExit):
        tserve.main(args)
    assert msg in capsys.readouterr().err
