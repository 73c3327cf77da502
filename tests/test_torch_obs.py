"""Port parity of observability (``repro_torch.obs``: the registry with
``Histogram`` and ``LiveMetrics``, the ``Tracer`` and ``check_trace``,
``fit_profile``) and of the engine's trace hooks, against the JAX
package's ``repro.obs`` and a live JAX engine.

Units first: the same operations on both packages' registries, live
windows and tracers give equal snapshots, summaries, errors and bytes,
and ``check_trace`` passes and fails the same documents with the same
message.  Then traced drives, with the weights of
tests/test_torch_engine.py: reduced rwkv6-1.6b (``max_batch`` 2,
``max_len`` 32, the Poisson 0.6 profile of tests/test_obs.py under
preemptive EDF), reduced qwen2.5-14b under ``paged:8`` (the
fragmentation counters), and the rwkv6 storm8 cell of
tests/test_torch_faults.py through ``drive_resilient`` (checkpoints and a
crash restart).  Requests carry no ``eos_id``, so the schedule, and with
it every trace event, depends only on lengths, budgets, deadlines and
faults: the two engines' ``dumps()`` must be byte-equal, and a traced
port engine's stamps, ``stats()``, ``fault_stats()`` and ``host_syncs``
must equal the untraced engine's.
"""

import json

import pytest

from repro.obs import LiveMetrics as JLive
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import Tracer as JTracer
from repro.obs import check_trace as j_check_trace
from repro.obs import dumps_trace_doc as j_dumps_doc
from repro.obs import fit_profile as j_fit
from repro.obs import merge_traces as j_merge
from repro.obs.observe import summarize as j_summarize
from repro.plan.plan import ServingPlan as JPlan
from repro.plan.plan import WorkloadProfile as JProfile
from repro.serving import ServingEngine as JEngine
from repro.serving import FaultInjector as JInjector
from repro.serving import drive_resilient as j_drive_resilient
from repro.serving import metrics as jmet
from repro.serving import workload as jwl
from repro.serving.engine import Request as JRequest
from repro.checkpoint import CheckpointManager as JManager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.obs import (LiveMetrics, MetricsRegistry, Tracer,
                             check_trace, dumps_trace_doc, fit_profile,
                             merge_traces)
from repro_torch.obs.observe import observed_span_ticks, summarize
from repro_torch.obs.trace import TICK_US
from repro_torch.plan.plan import ServingPlan as TPlan
from repro_torch.plan.plan import WorkloadProfile as TProfile
from repro_torch.serving import FaultInjector, ServingEngine, drive_resilient
from repro_torch.serving import metrics as tmet
from repro_torch.serving import workload as twl
from repro_torch.serving.engine import Request as TRequest
from test_torch_engine import NOSH, _models
from test_torch_faults import CASES, _chaos_items, _fault_plan

VOCAB = 503
PKGS = {
    "jax": dict(Registry=JRegistry, Live=JLive, Tracer=JTracer,
                Request=JRequest, check=j_check_trace, merge=j_merge,
                dumps_doc=j_dumps_doc),
    "torch": dict(Registry=MetricsRegistry, Live=LiveMetrics, Tracer=Tracer,
                  Request=TRequest, check=check_trace, merge=merge_traces,
                  dumps_doc=dumps_trace_doc),
}


def _both(fn):
    """``fn`` run on each package's classes: (jax result, torch result)."""
    return fn(PKGS["jax"]), fn(PKGS["torch"])


def _err(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


# ---------------------------------------------------------------------------
# registry and live window
# ---------------------------------------------------------------------------


def _registry_ops(p):
    reg = p["Registry"]()
    c = reg.counter("a.count", "help")
    c.inc()
    c.inc(4)
    reg.gauge("a.level").set(2.5)
    state = {"v": 1.0}
    reg.gauge("a.derived", fn=lambda: state["v"])
    h = reg.histogram("a.lat")
    for v in (1.0, 2.0, 3.0, 10.0, 7):
        h.observe(v)
    empty = reg.histogram("b.empty")
    out = dict(snap=reg.snapshot(), summary=h.summary(),
               empty=json.dumps(empty.summary()), names=reg.names(),
               get=reg.get("a.count").value, missing=reg.get("nope"),
               item=reg["a.lat"].kind, contains=("a.level" in reg,
                                                  "x" in reg),
               same=reg.counter("a.count") is c,
               view=reg.view({"lat": "a.lat", "count": "a.count"}),
               derived_set=_err(lambda: reg["a.derived"].set(0.0)))
    for kind in ("counter", "gauge", "histogram"):
        for name in ("a.count", "a.level", "a.lat"):
            out[f"clash {kind} {name}"] = _err(
                lambda: getattr(reg, kind)(name))
    state["v"] = 7.0
    reg.reset()
    out["after_reset"] = reg.snapshot()
    out["histogram_after_reset"] = json.dumps(h.summary())
    return out


def test_registry_operations_equal_jax():
    j, t = _both(_registry_ops)
    assert t == j
    assert t["snap"] == {"a.count": 5, "a.derived": 1.0, "a.lat": 5,
                         "a.level": 2.5, "b.empty": 0}
    assert "already registered" in t["clash gauge a.count"]
    assert t["clash counter a.count"] is None


def _request(p, uid=0, t_submit=0, t_admit=1, t_first=1, t_done=4,
             n_tokens=4, deadline=None, done=True):
    r = p["Request"](uid, [1, 2, 3], max_new_tokens=n_tokens,
                     deadline=deadline, t_submit=t_submit)
    r.t_admit, r.t_first = t_admit, t_first
    r.t_done = t_done if done else None
    r.output = list(range(n_tokens))
    r.done = done
    return r


def _live_ops(p):
    """Eviction, SLO, shed and reset of a live window, as text after
    each operation (NaN compares equal as text)."""
    out = []
    snap = lambda lm: out.append(json.dumps(lm.snapshot(), sort_keys=True)
                                 + " | " + lm.line())
    lm = p["Live"](window=4)
    lm.observe_request(_request(p, t_done=0), 0)
    snap(lm)
    for t in range(8):
        lm.observe_tick(t, (t % 3) / 2)
        snap(lm)
    lm.observe_request(_request(p, uid=1, t_done=7, t_submit=2,
                                deadline=9.0), 7)
    lm.observe_request(_request(p, uid=2, t_done=7, deadline=2.0), 7)
    lm.observe_request(_request(p, uid=3, n_tokens=1, t_done=1), 7)
    lm.observe_request(_request(p, uid=4, done=False, deadline=5.0), 7)
    snap(lm)
    lm.observe_tick(12, 1.0)
    snap(lm)
    lm.reset()
    snap(lm)
    out.append(_err(lambda: p["Live"](window=0)))
    return out


def test_live_metrics_equal_jax():
    j, t = _both(_live_ops)
    assert t == j
    assert "slo=0.33" in t[9] and t[-1] == "window must be >= 1, got 0"


# ---------------------------------------------------------------------------
# tracer and check_trace
# ---------------------------------------------------------------------------


def _every_hook(p):
    """One call of every hook, with a request of the package."""
    tr = p["Tracer"]()
    req = _request(p, uid=3, deadline=9.0)
    req.n_preempts, req.retries = 1, 2
    tr.request_submit(req, 0)
    tr.compile(1, "prefill", rows=2, length=8)
    tr.prefill(1, bucket=8, rows=2, n_reqs=1, overlap=True)
    tr.compile(1, "decode", rows=2, length=4)
    tr.counter(1, "queue_depth", 0)
    tr.decode_chunk(1, n_ticks=3, n_slots=1)
    tr.counter(2, "util", 0.5)
    tr.counter(2, "blocks_free", 12)
    tr.counter(2, "bytes_resident", 4096)
    tr.counter(2, "padding_waste", 1024)
    tr.host_sync(4)
    tr.request_preempt(req, 2, slot=1, evicted_tokens=3)
    tr.request_resume(req, 3, slot=0)
    tr.engine_fault(3, "poison_slot", slot=0)
    tr.engine_fault(3, "fail_prefill", rows=2)
    tr.request_fault(req, 3, "poison", 0)
    tr.request_retry(req, 3, 2)
    tr.request_quarantine(req, 3, 5)
    tr.request_shed(req, 6)
    tr.request_done(req, 4)
    return tr


def test_tracer_hooks_write_the_jax_bytes(tmp_path):
    jt, tt = _both(_every_hook)
    assert tt.dumps() == jt.dumps()
    doc = tt.to_chrome()
    check_trace(doc)
    assert doc["otherData"] == {"schema": "repro.obs.trace/v1",
                                "tick_us": TICK_US} and TICK_US == 1000
    assert len(tt) == len(jt) == 22
    tt.save(str(tmp_path / "t.json"))
    assert (tmp_path / "t.json").read_text() == jt.dumps()
    # a port trace file validates and fits in the JAX package, and back
    j_check_trace(json.loads((tmp_path / "t.json").read_text()))
    assert j_fit(str(tmp_path / "t.json")) == j_fit(jt)
    assert fit_profile(str(tmp_path / "t.json")).to_json() == \
        j_fit(jt).to_json()
    tt.reset()
    assert len(tt) == 0 and tt.dumps() == Tracer().dumps()


def test_merge_traces_equal_jax():
    def merged(p):
        a, b = _every_hook(p), p["Tracer"]()
        b.host_sync(2)
        doc = p["merge"]([a, b], labels=["prefill", "decode"])
        p["check"](doc)
        return (p["dumps_doc"](doc), p["dumps_doc"](p["merge"]([b, a])),
                _err(lambda: p["merge"]([a], labels=["x", "y"])))
    j, t = _both(merged)
    assert t == j and t[2].startswith("need one label per tracer")


def _drifts():
    """Documents to hold ``check_trace`` to: (name, edit of a valid
    document's JSON)."""
    def ev(i, **kw):
        def edit(d):
            d["traceEvents"][i].update(kw)
        return edit

    def drop(key):
        return lambda d: d.pop(key)

    def drop_ev(i, key):
        return lambda d: d["traceEvents"][i].pop(key)

    return [
        ("valid", lambda d: None),
        ("no events key", drop("traceEvents")),
        ("no unit", drop("displayTimeUnit")),
        ("no other data", drop("otherData")),
        ("schema", lambda d: d["otherData"].update(schema="nope")),
        ("event without ts", drop_ev(3, "ts")),
        ("event without pid", drop_ev(3, "pid")),
        ("phase", ev(3, ph="B")),
        ("category", ev(3, cat="device")),
        ("negative ts", ev(3, ts=-1000)),
        ("float ts", ev(3, ts=1000.0)),
        ("ts off a tick", ev(3, ts=1500)),
        ("unknown name", ev(3, name="mystery")),
        ("counter as instant", ev(8, ph="i")),
        ("span without dur", drop_ev(7, "dur")),
        ("negative dur", ev(7, dur=-1)),
        ("tid and uid", ev(2, tid=99)),
        ("metadata passes", ev(0, cat="other", name="anything")),
    ]


@pytest.mark.parametrize("name,edit", _drifts(), ids=lambda x: x
                         if isinstance(x, str) else "")
def test_check_trace_same_verdict_as_jax(name, edit):
    doc = json.loads(_every_hook(PKGS["torch"]).dumps())
    edit(doc)
    got, want = _err(lambda: check_trace(doc)), _err(
        lambda: j_check_trace(doc))
    assert got == want
    assert (got is None) == (name in ("valid", "metadata passes"))


def test_fit_profile_units_equal_jax():
    def fits(p):
        out = []
        specs = [(t, 4 + t % 8, 6 + t % 5, float(t + 3 * (6 + t % 5)))
                 for t in range(0, 40, 2)]
        heavy = [(t, 8, 30 + t % 11, None) for t in range(0, 40, 10)]
        for sp in (specs, specs[:3] + heavy, heavy):
            tr = p["Tracer"]()
            for uid, (t, plen, mnew, dl) in enumerate(sp):
                r = p["Request"](uid, list(range(plen)), max_new_tokens=mnew,
                                 deadline=dl, t_submit=t)
                tr.request_submit(r, t)
            doc = json.loads(tr.dumps())
            fit = j_fit if p["Tracer"] is JTracer else fit_profile
            summ = j_summarize if p["Tracer"] is JTracer else summarize
            for kw in ({}, {"duration": 100.0}, {"kind": "mmpp"}):
                out.append(json.dumps(fit(tr, **kw).to_json()))
                out.append(json.dumps(fit(doc, **kw).to_json()))
            out.append(json.dumps(summ(tr)))
        out.append(_err(lambda: fit(p["Tracer"]())))
        return out
    j, t = _both(fits)
    assert t == j
    assert t[-1] == ("trace contains no request submit events; nothing to "
                     "fit a workload profile from")
    assert summarize(Tracer()) == {"submits": 0}
    assert observed_span_ticks(Tracer()) == 0


# ---------------------------------------------------------------------------
# traced engines
# ---------------------------------------------------------------------------

# tests/test_obs.py's profile; qwen's prompts stay under max_len 32
PROFILE = dict(kind="poisson", rate=0.6, duration=24.0, deadline_slack=3.0)
# name -> (arch, plan knobs, profile)
DRIVES = {
    "rwkv6/edf+p": ("rwkv6-1.6b", dict(max_batch=2, max_len=32,
                                       policy="edf", preempt=True), PROFILE),
    "qwen/paged:8": ("qwen2.5-14b", dict(max_batch=2, max_len=32,
                                         cache_layout="paged:8"), PROFILE),
}
STORM = "rwkv6-1.6b/dense/storm8"
FRAG = ("blocks_free", "bytes_resident", "padding_waste")


def _drive(pkg, name, traced=True):
    """A drive of ``DRIVES[name]`` through package ``pkg``'s engine (traced:
    a tracer and a live window over the whole run).  Returns (tracer or
    None, engine, requests, live window or None)."""
    arch, knobs, prof = DRIVES[name]
    jm, jp, tm, tp = _models(arch)
    tracer = (JTracer() if pkg == "jax" else Tracer()) if traced else None
    if pkg == "jax":
        eng = JEngine.from_plan(JPlan(arch=arch, reduced=True,
                                      **knobs).resolve(), jp, model=jm,
                                sharder=NOSH, tracer=tracer)
        items = jwl.profile_items(JProfile(**prof), vocab_size=VOCAB, seed=0)
        drive, clock = jwl.drive, jwl.VirtualClock()
    else:
        eng = ServingEngine.from_plan(TPlan(arch=arch, reduced=True,
                                            **knobs).resolve(), tp, model=tm,
                                      tracer=tracer)
        items = twl.profile_items(TProfile(**prof), vocab_size=VOCAB, seed=0)
        drive, clock = twl.drive, twl.VirtualClock()
    live = eng.enable_live_metrics(window=100_000) if traced else None
    reqs = drive(eng, items, clock)
    return tracer, eng, reqs, live


def _storm(pkg, tmpdir, traced=True, checkpoints=True):
    """The storm8 cell of tests/test_torch_faults.py (reduced rwkv6,
    ``max_batch`` 4, ``max_len`` 64, a checkpoint every 8 ticks: one
    crash restart) through ``pkg``'s ``drive_resilient``."""
    arch, knobs, faults, _, every = CASES[STORM]
    jm, jp, tm, tp = _models(arch)
    tracer = (JTracer() if pkg == "jax" else Tracer()) if traced else None
    if pkg == "jax":
        eng = JEngine.from_plan(JPlan(arch=arch, reduced=True,
                                      **knobs).resolve(), jp, model=jm,
                                sharder=NOSH, tracer=tracer)
        rep = j_drive_resilient(
            eng, _chaos_items(jwl, JProfile), jwl.VirtualClock(),
            injector=JInjector(_fault_plan("jax", faults)),
            manager=JManager(str(tmpdir)), checkpoint_every=every)
    else:
        eng = ServingEngine.from_plan(TPlan(arch=arch, reduced=True,
                                            **knobs).resolve(), tp, model=tm,
                                      tracer=tracer)
        rep = drive_resilient(
            eng, _chaos_items(twl, TProfile), twl.VirtualClock(),
            injector=FaultInjector(_fault_plan("torch", faults)),
            manager=CheckpointManager(str(tmpdir)) if checkpoints else None,
            checkpoint_every=every)
    return tracer, rep


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each traced run, made once for the module: ``get(pkg, name,
    traced)``."""
    cache = {}

    def get(pkg, name, traced=True):
        key = (pkg, name, traced)
        if key not in cache:
            if name == STORM:
                d = tmp_path_factory.mktemp(f"{pkg}_storm_{int(traced)}")
                cache[key] = _storm(pkg, d, traced)
            else:
                cache[key] = _drive(pkg, name, traced)
        return cache[key]
    return get


def _dumps(run):
    return run[0].dumps()


def _stamps(reqs):
    return [(r.uid, r.t_submit, r.t_admit, r.t_first, r.t_done,
             len(r.output), r.done, r.shed, r.retries, r.n_preempts,
             list(r.t_preempts), list(r.t_resumes)) for r in reqs]


@pytest.mark.parametrize("name", list(DRIVES) + [STORM])
def test_engine_trace_bytes_equal_live_jax(runs, name):
    """The port engine's trace is the JAX engine's, byte for byte, and
    valid in both packages; every recorded value is a plain Python
    scalar (no hook took a tensor or a numpy scalar)."""
    jt, tt = runs("jax", name)[0], runs("torch", name)[0]
    assert tt.dumps() == jt.dumps()
    doc = tt.to_chrome()
    check_trace(doc)
    j_check_trace(doc)
    names = {e.name for e in tt.events}
    assert {"submit", "queued", "run", "first_token", "prefill",
            "decode_chunk", "host_sync", "compile", "util",
            "queue_depth"} <= names
    for e in tt.events:
        assert all(type(v) in (int, float, bool, str)
                   for v in e.args.values()), e
    if name == STORM:
        assert {"fault", "retry", "quarantine"} <= names
        assert runs("torch", name)[1].n_restarts == 1
    if "paged" in name:
        utils = [e.ts for e in tt.events if e.name == "util"]
        for c in FRAG:
            assert [e.ts for e in tt.events if e.name == c] == utils
    else:
        assert not names & set(FRAG)
    if name == "rwkv6/edf+p":
        assert {"preempt", "resume"} <= names


@pytest.mark.parametrize("name", list(DRIVES) + [STORM])
def test_tracing_changes_nothing_else(runs, name):
    """A traced port engine: the untraced engine's stamps, utilization,
    ``stats()``, ``fault_stats()`` and ``host_syncs``."""
    if name == STORM:
        (_, a), (_, b) = runs("torch", name), runs("torch", name, False)
        ea, eb, ra, rb = a.engine, b.engine, a.requests, b.requests
        assert (a.n_restarts, a.restart_ticks_lost, a.fault_events) == \
            (b.n_restarts, b.restart_ticks_lost, b.fault_events)
    else:
        (_, ea, ra, _), (_, eb, rb, _) = (runs("torch", name),
                                          runs("torch", name, False))
    assert _stamps(ra) == _stamps(rb)
    assert ea.util_history == eb.util_history
    assert ea.stats() == eb.stats() and ea.host_syncs == eb.host_syncs
    assert ea.fault_stats() == eb.fault_stats()
    assert [r.output for r in ra] == [r.output for r in rb]


@pytest.mark.parametrize("name", list(DRIVES))
def test_live_window_equals_aggregate_and_jax(runs, name):
    """A window longer than the run evicts nothing: its snapshot is the
    end-of-run aggregate in ticks, and the JAX engine's snapshot."""
    _, eng, reqs, live = runs("torch", name)
    agg = tmet.aggregate(reqs, ticks=eng.ticks,
                         util_history=eng.util_history)
    snap = live.snapshot()
    assert snap["completed"] == agg["completed"]
    assert snap["ttft_p95"] == agg["ttft"]["p95"]
    assert snap["tpot_p95"] == agg["tpot"]["p95"]
    assert snap["mean_util"] == pytest.approx(agg["mean_util"])
    assert snap["slo_attainment"] == agg["slo"]["attainment"]
    jlive = runs("jax", name)[3]
    assert json.dumps(snap, sort_keys=True) == json.dumps(
        jlive.snapshot(), sort_keys=True)
    assert live.line() == jlive.line()
    jeng, jreqs = runs("jax", name)[1], runs("jax", name)[2]
    assert agg == jmet.aggregate(jreqs, ticks=jeng.ticks,
                                 util_history=jeng.util_history)


@pytest.mark.parametrize("name", list(DRIVES) + [STORM])
def test_fit_profile_of_an_engine_trace_equals_jax(runs, name, tmp_path):
    """``fit_profile``, ``summarize`` and ``WorkloadProfile.from_trace``
    of one trace agree across the packages, from the live tracer, its
    document and its file; the JAX fit of the port's document is the
    port's fit."""
    jt, tt = runs("jax", name)[0], runs("torch", name)[0]
    path = str(tmp_path / "trace.json")
    tt.save(path)
    doc = json.loads(tt.dumps())
    for src in (tt, doc, path):
        for kw in ({}, {"duration": 24.0}):
            want = j_fit(jt, **kw).to_json()
            assert fit_profile(src, **kw).to_json() == want
            assert TProfile.from_trace(src, **kw).to_json() == want
            assert JProfile.from_trace(doc, **kw).to_json() == want
        assert summarize(src) == j_summarize(jt)
    assert j_fit(doc).to_json() == fit_profile(tt).to_json()
    assert fit_profile(tt).deadline_frac == 1.0


def test_host_sync_instants_are_not_host_syncs(tmp_path):
    """Deliberate, as in the JAX engine: the recovery refresh's read and
    ``checkpoint()``'s read count in ``host_syncs`` but emit no
    ``host_sync`` instant, so in a faulted run with checkpoints the
    instants fall short of ``host_syncs`` by exactly those reads (the
    chunks', synchronous prefills' and preemption bursts' reads)."""
    from test_torch_faults import _small_items

    arch = "rwkv6-1.6b"
    _, _, tm, tp = _models(arch)
    tracer = Tracer()
    eng = ServingEngine.from_plan(TPlan(arch=arch, reduced=True, max_batch=2,
                                        max_len=32).resolve(), tp, model=tm,
                                  tracer=tracer)
    reads = {"recovery": 0, "checkpoint": 0}
    refresh, ckpt = eng._refresh_recovery, eng.checkpoint

    def counted_refresh():
        before = eng.host_syncs
        refresh()
        reads["recovery"] += eng.host_syncs - before

    def counted_checkpoint(*a, **k):
        before = eng.host_syncs
        out = ckpt(*a, **k)
        reads["checkpoint"] += eng.host_syncs - before
        return out
    eng._refresh_recovery = counted_refresh
    eng.checkpoint = counted_checkpoint
    plan = _fault_plan("torch", CASES["poison_nan"][2])
    rep = drive_resilient(eng, _small_items(twl), twl.VirtualClock(),
                          injector=FaultInjector(plan),
                          manager=CheckpointManager(str(tmp_path)),
                          checkpoint_every=4)
    assert rep.engine is eng and rep.n_restarts == 0
    st = eng.stats()
    instants = sum(e.name == "host_sync" for e in tracer.events)
    assert reads["recovery"] > 0 and reads["checkpoint"] > 0
    assert instants == st["host_syncs"] - reads["recovery"] \
        - reads["checkpoint"]
    assert instants == st["decode_chunks"] + st["prefill_calls"] \
        - st["overlap_prefills"] + st["preempt_bursts"]


def test_reset_telemetry_empties_tracer_and_window():
    """After a drained run ``reset_telemetry()`` restarts the tracer and
    the live window at tick 0; the next run's events are a fresh
    engine's, stamp for stamp, but for the ``compile`` instants (emitted
    once an engine and shape, as the JAX engine builds each program
    once) and the uids, which go on counting."""
    _, _, tm, tp = _models("rwkv6-1.6b")
    plan = TPlan(arch="rwkv6-1.6b", reduced=True, max_batch=2,
                 max_len=32).resolve()
    items = twl.profile_items(TProfile(**PROFILE), vocab_size=VOCAB, seed=0)
    runs = []
    for _ in range(2):
        tracer = Tracer()
        eng = ServingEngine.from_plan(plan, tp, model=tm, tracer=tracer)
        live = eng.enable_live_metrics(100_000)
        twl.drive(eng, items, twl.VirtualClock())
        runs.append((tracer, eng, live))
    tracer, eng, live = runs[0]
    eng.reset_telemetry()
    assert len(tracer) == 0 and live.snapshot()["completed"] == 0
    twl.drive(eng, items, twl.VirtualClock())
    stamps = lambda evs: [(e.name, e.cat, e.ph, e.ts, e.dur) for e in evs
                          if e.name != "compile"]
    assert not any(e.name == "compile" for e in tracer.events)
    assert stamps(tracer.events) == stamps(runs[1][0].events)
    check_trace(tracer.to_chrome())
    assert json.dumps(live.snapshot()) == json.dumps(runs[1][2].snapshot())
