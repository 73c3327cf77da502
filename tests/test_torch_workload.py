"""Port parity of the open-loop serving path: workloads, traces, latency
metrics and ``drive`` against the JAX package.

``make_workload`` draws from a seeded numpy generator in both packages,
so the items must be equal; trace files share one JSONL schema in both
directions.  The metrics are pure Python over request stamps: the same
stamps must give equal dicts (NaN compared as NaN).  ``drive`` replays
one workload through a live JAX engine and through the port's engine on
reduced rwkv6 and qwen2.5-14b: requests carry no ``eos_id``, so tick
stamps, ``util_history``, the counters (``host_syncs`` included, with
``overlap_prefill`` on and off) and the aggregate must be equal under
every policy, preemptive EDF, ``shed_late``, ``truncate_prompts`` and
the exact-length prefill.
"""

import json
import math

import numpy as np
import pytest

from repro.serving import ServingEngine as JEngine
from repro.serving import metrics as jmet
from repro.serving import workload as jwl
from repro.serving.engine import Request as JRequest
from repro_torch.serving import metrics as tmet
from repro_torch.serving import workload as twl
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine
from test_torch_engine import NOSH, _models

VOCAB = 503
MAX_LEN = 32


def _items(mod, **kw):
    base = dict(kind="poisson", rate=0.8, duration=24.0, seed=3,
                vocab_size=VOCAB, prompt_len=(4, 12),
                max_new_tokens=(2, 8), prompt_len_long=MAX_LEN - 1)
    base.update(kw)
    return mod.make_workload(**base)


def _json(items):
    return [it.to_json() for it in items]


@pytest.mark.parametrize("dist", ["uniform", "fixed", "lognormal",
                                  "bimodal"])
@pytest.mark.parametrize("kind", ["poisson", "mmpp"])
def test_make_workload_items_equal_jax(kind, dist):
    kw = dict(kind=kind, prompt_dist=dist, heavy_decode=(0.2, 16, 24),
              deadline_slack=3.0, deadline_frac=0.6, duration=64.0)
    j, t = _items(jwl, **kw), _items(twl, **kw)
    assert len(t) > 10
    assert _json(t) == _json(j)
    assert [type(x.deadline) for x in t] == [type(x.deadline) for x in j]
    assert twl.offered_load(t, 64.0) == jwl.offered_load(j, 64.0)


def test_traces_load_across_packages(tmp_path):
    items = _items(jwl, deadline_slack=2.0, deadline_frac=0.5)
    jpath, tpath = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    jwl.save_trace(str(jpath), items)
    assert _json(twl.load_trace(str(jpath))) == _json(items)
    twl.save_trace(str(tpath), twl.load_trace(str(jpath)))
    assert tpath.read_bytes() == jpath.read_bytes()
    assert _json(jwl.load_trace(str(tpath))) == _json(items)
    assert _json(twl.make_workload("trace", rate=1.0, duration=1.0, seed=0,
                                   vocab_size=VOCAB,
                                   trace_path=str(jpath))) == _json(items)


@pytest.mark.parametrize("bad", [
    '{"t": 1.0, "prompt": [1, 2]',                      # truncated JSON
    '{"prompt": [1, 2]}',                               # no t
    '{"t": "soon", "prompt": [1]}',                     # t not a number
    '{"t": 1.0, "prompt": 7}',                          # prompt not a list
    '{"t": 1.0, "prompt": [1, "x"]}',                   # not token ids
    '{"t": 1.0, "prompt": [1], "max_new_tokens": "a"}',
    '{"t": 1.0, "prompt": [1], "deadline": "late"}',
    '{"t": 1.0, "prompt": [1], "colour": 3}',           # unknown field
    '[1, 2]',                                           # not an object
])
def test_malformed_trace_line_names_file_and_line(tmp_path, bad):
    path = tmp_path / "bad.jsonl"
    path.write_text('{"t": 0.5, "prompt": [3, 4]}\n\n' + bad + "\n")
    with pytest.raises(ValueError) as te:
        twl.load_trace(str(path))
    with pytest.raises(ValueError) as je:
        jwl.load_trace(str(path))
    assert str(te.value).startswith(f"{path}:3: ")
    assert str(te.value) == str(je.value)


def _stamped(cls, rng, n):
    """n requests with random stamps: done or not, with and without
    deadlines, shed, one-token outputs (no TPOT), preempted."""
    out = []
    for uid in range(n):
        r = cls(uid, [1] * int(rng.integers(1, 9)),
                max_new_tokens=int(rng.integers(1, 9)))
        r.t_submit = int(rng.integers(0, 40))
        if rng.uniform() < 0.85:
            r.t_admit = r.t_submit + int(rng.integers(0, 6))
            r.t_first = r.t_admit
            r.output = [0] * int(rng.integers(1, 9))
            r.t_done = r.t_first + len(r.output) - 1 + int(rng.integers(0, 3))
            r.done = True
        if rng.uniform() < 0.6:
            r.deadline = float(r.t_submit + rng.integers(1, 20))
        r.shed = not r.done and rng.uniform() < 0.5
        if r.done and rng.uniform() < 0.2:
            r.n_preempts = int(rng.integers(1, 3))
            r.t_preempts = list(range(r.n_preempts))
            r.t_resumes = list(range(r.n_preempts))
        out.append(r)
    return out


def _same(a, b):
    """Equal, with NaN equal to NaN, through nested dicts."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b and type(a) is type(b)


@pytest.mark.parametrize("n,seed", [(0, 0), (1, 1), (3, 2), (40, 3),
                                    (40, 4)])
def test_metrics_equal_jax_on_the_same_stamps(n, seed):
    jr = _stamped(JRequest, np.random.default_rng(seed), n)
    tr = _stamped(TRequest, np.random.default_rng(seed), n)
    util = list(np.random.default_rng(seed).uniform(0, 1, 30))
    for ts in (1.0, 0.0123):
        ja = jmet.aggregate(jr, ticks=70, util_history=util, tick_seconds=ts)
        ta = tmet.aggregate(tr, ticks=70, util_history=util, tick_seconds=ts)
        assert _same(ta, ja)
        assert _same(tmet.scale_latencies(ta, 0.004),
                     jmet.scale_latencies(ja, 0.004))
        assert tmet.format_summary(ta) == jmet.format_summary(ja)
    if n:
        parts_j = [(jr[:n // 2], 50, util[:10]), (jr[n // 2:], 70, util)]
        parts_t = [(tr[:n // 2], 50, util[:10]), (tr[n // 2:], 70, util)]
        assert _same(tmet.aggregate_fleet(parts_t),
                     jmet.aggregate_fleet(parts_j))
    for q in (0, 50, 95, 99, 100):
        xs = [float(r.t_submit) for r in tr]
        assert _same(tmet.percentile(xs, q), jmet.percentile(xs, q))


# (arch, workload overrides, engine kwargs): every policy, preemptive EDF,
# overlap on and off, sync_every 1 and 4, b2 and b4, shed_late,
# truncate_prompts and the exact-length prefill
OVERLOAD = dict(heavy_decode=(0.15, 16, 22), deadline_slack=2.0)
# exact-length prefill: one JAX compile a distinct prompt length
SHORT = dict(duration=12.0, prompt_len=(4, 7))
CASES = [
    ("rwkv6-1.6b", {}, dict(max_batch=2, sync_every=1)),
    ("rwkv6-1.6b", dict(max_new_tokens=(1, 8)),
     dict(max_batch=4, sync_every=4)),
    ("rwkv6-1.6b", {}, dict(max_batch=4, sync_every=1,
                            overlap_prefill=False)),
    ("rwkv6-1.6b", dict(prompt_dist="bimodal"),
     dict(max_batch=4, sync_every=4, policy="spf")),
    ("rwkv6-1.6b", OVERLOAD, dict(max_batch=4, policy="edf")),
    ("rwkv6-1.6b", OVERLOAD, dict(max_batch=2, policy="edf", preempt=True)),
    ("rwkv6-1.6b", OVERLOAD, dict(max_batch=2, sync_every=4, policy="edf",
                                  preempt=True, overlap_prefill=False)),
    ("rwkv6-1.6b", dict(OVERLOAD, deadline_slack=0.8),
     dict(max_batch=2, policy="edf", shed_late=True)),
    ("rwkv6-1.6b", dict(prompt_len=(20, 40)),
     dict(max_batch=4, truncate_prompts=True)),
    ("rwkv6-1.6b", SHORT, dict(max_batch=2, bucketed_prefill=False)),
    ("qwen2.5-14b", {}, dict(max_batch=4, sync_every=4)),
    ("qwen2.5-14b", OVERLOAD, dict(max_batch=2, policy="edf", preempt=True)),
    ("qwen2.5-14b", SHORT, dict(max_batch=2, bucketed_prefill=False,
                                overlap_prefill=False)),
]

STAT_KEYS = ["completed", "total_tokens", "prefill_calls", "instant_admits",
             "decode_chunks", "ticks", "mean_util", "active", "queued",
             "host_syncs", "preemptions", "resumes", "evicted_tokens",
             "shed"]


def _stamps(r):
    return (r.uid, r.t_submit, r.t_admit, r.t_first, r.t_done,
            len(r.output), r.done, r.shed, r.truncated, r.capped,
            r.n_preempts, r.t_preempts, r.t_resumes)


@pytest.mark.parametrize("arch,wkw,ekw", CASES)
def test_drive_matches_live_jax_engine(arch, wkw, ekw):
    jm, jp, tm, tp = _models(arch)
    ekw = dict(dict(overlap_prefill=True), **ekw)
    jitems, titems = _items(jwl, **wkw), _items(twl, **wkw)
    jeng = JEngine(jm, jp, NOSH, max_len=MAX_LEN, **ekw)
    teng = TEngine(tm, tp, max_len=MAX_LEN, **ekw)
    jreqs = jwl.drive(jeng, jitems, jwl.VirtualClock())
    treqs = twl.drive(teng, titems, twl.VirtualClock())
    assert [_stamps(r) for r in treqs] == [_stamps(r) for r in jreqs]
    assert teng.util_history == jeng.util_history
    js, ts = jeng.stats(), teng.stats()
    assert {k: ts[k] for k in STAT_KEYS} == {k: js[k] for k in STAT_KEYS}
    assert ts["prefill_shapes"] == js["prefill_compiles"]
    # one read a chunk, a synchronous prefill and a preemption burst
    assert ts["host_syncs"] == (ts["decode_chunks"] + ts["prefill_calls"]
                                - ts["overlap_prefills"]
                                + ts["preempt_bursts"])
    if not ekw["overlap_prefill"]:
        assert ts["overlap_prefills"] == 0
    ja = jmet.aggregate(jreqs, ticks=jeng.ticks,
                        util_history=jeng.util_history)
    ta = tmet.aggregate(treqs, ticks=teng.ticks,
                        util_history=teng.util_history)
    assert _same(ta, ja)
    assert tmet.format_summary(ta) == jmet.format_summary(ja)
    if ekw.get("preempt"):
        assert ts["preemptions"] > 0 and ts["resumes"] == ts["preemptions"]
    if ekw.get("shed_late"):
        assert ts["shed"] > 0
    if ekw.get("truncate_prompts"):
        assert any(r.truncated for r in treqs)


def test_overlap_changes_only_the_host_syncs():
    """The same workload through the port's engine with overlap_prefill on
    and off: equal stamps, tokens and aggregate; the overlapped run reads
    once less for every prefill call whose tokens rode on a chunk."""
    _, _, tm, tp = _models("rwkv6-1.6b")
    items = _items(twl, max_new_tokens=(1, 8), **OVERLOAD)
    runs = []
    for overlap in (True, False):
        eng = TEngine(tm, tp, max_batch=2, max_len=MAX_LEN, policy="edf",
                      preempt=True, overlap_prefill=overlap)
        reqs = twl.drive(eng, items, twl.VirtualClock())
        runs.append((eng, reqs))
    (on, r_on), (off, r_off) = runs
    assert [_stamps(r) for r in r_on] == [_stamps(r) for r in r_off]
    assert [r.output for r in r_on] == [r.output for r in r_off]
    s_on, s_off = on.stats(), off.stats()
    assert s_on["overlap_prefills"] > 0
    assert s_off["host_syncs"] == s_on["host_syncs"] + s_on[
        "overlap_prefills"]
    assert _same(tmet.aggregate(r_on, ticks=on.ticks),
                 tmet.aggregate(r_off, ticks=off.ticks))


def test_serve_cli_open_loop_prints_summary(capsys, tmp_path):
    """The launcher's open-loop mode on the CPU: a Poisson workload on the
    virtual clock, format_summary and the engine stats line; the plan it
    saves loads back and serves the same run."""
    from repro_torch.launch import serve

    plan_path = tmp_path / "plan.json"
    args = ["--arch", "rwkv6-1.6b", "--reduced", "--arrival", "poisson",
            "--rate", "0.5", "--duration", "12", "--device", "cpu",
            "--policy", "edf", "--deadline-slack", "3", "--save-plan",
            str(plan_path)]
    serve.main(args)
    first = capsys.readouterr().out
    assert "completed" in first and "ttft" in first and "slo" in first
    assert "engine stats: {" in first
    saved = json.loads(plan_path.read_text())
    assert saved["schema"] == "serving_plan/v1" and saved["policy"] == "edf"
    serve.main(["--plan", str(plan_path), "--arrival", "poisson", "--rate",
                "0.5", "--duration", "12", "--device", "cpu",
                "--deadline-slack", "3"])
    again = capsys.readouterr().out
    summary = lambda out: out[out.index("completed"):out.index("engine")]
    assert summary(again) == summary(first)


def test_serve_cli_trace_out_and_live_metrics_equal_jax(capsys, tmp_path,
                                                        monkeypatch):
    """Both launchers on reduced rwkv6 under preemptive EDF, the virtual
    clock: ``--trace-out`` writes the same bytes, a document that passes
    both packages' ``check_trace``, and ``--live-metrics 4`` prints the
    same rolling lines."""
    import sys

    from repro.launch import serve as jserve
    from repro.obs import check_trace as j_check_trace
    from repro_torch.launch import serve as tserve
    from repro_torch.obs import check_trace

    args = ["--arch", "rwkv6-1.6b", "--reduced", "--arrival", "poisson",
            "--rate", "0.5", "--duration", "12", "--policy", "edf",
            "--preempt", "--deadline-slack", "2", "--live-metrics", "4"]
    tserve.main(args + ["--device", "cpu", "--trace-out",
                        str(tmp_path / "t.json")])
    tout = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve"] + args + [
        "--trace-out", str(tmp_path / "j.json")])
    jserve.main()
    jout = capsys.readouterr().out
    port = (tmp_path / "t.json").read_bytes()
    assert port == (tmp_path / "j.json").read_bytes()
    doc = json.loads(port)
    check_trace(doc)
    j_check_trace(doc)
    live = lambda out: [ln for ln in out.splitlines()
                        if ln.startswith("[t=")]
    assert len(live(tout)) >= 2 and live(tout) == live(jout)
    wrote = lambda out: [ln for ln in out.splitlines()
                         if ln.startswith("wrote ")]
    n = len(doc["traceEvents"]) - 2           # the two metadata events
    assert wrote(tout) == [f"wrote {n} trace events to {tmp_path / 't.json'}"
                           f" (open at https://ui.perfetto.dev)"]


# the paged cells of SERVING_LOAD_SWEEP at reduced width: the b4 twin of
# the dense qwen2.5-14b/b4/r1 and a b8 heavy-tail cell
PAGED_CELLS = ["qwen2.5-14b/b4/r1/paged16",
               "qwen2.5-14b/b8/r1/bimodal/paged16"]


@pytest.mark.parametrize("name", PAGED_CELLS)
def test_paged_cell_drive_matches_jax_and_its_dense_twin(name):
    """A paged cell through ``from_plan`` + ``drive`` + ``aggregate`` equals
    a live JAX drive of the same cell (stamps, utilization, counters, the
    block accounting, the aggregate) and the port's own dense twin (the
    same plan but for the layout): stamps, tokens, stats and aggregate."""
    import dataclasses

    from repro.configs import SERVING_LOAD_SWEEP as J_SWEEP
    from repro_torch.configs import serving_cell as t_cell

    jm, jp, tm, tp = _models("qwen2.5-14b")
    jc, tc = {c.name: c for c in J_SWEEP}[name], t_cell(name)
    jplan = dataclasses.replace(jc.plan, reduced=True)
    tplan = dataclasses.replace(tc.plan, reduced=True)
    jitems = jwl.profile_items(jc.workload, vocab_size=VOCAB, seed=0,
                               duration=32.0)
    titems = twl.profile_items(tc.workload, vocab_size=VOCAB, seed=0,
                               duration=32.0)
    assert _json(titems) == _json(jitems)
    jeng = JEngine.from_plan(jplan, jp, model=jm, sharder=NOSH)
    teng = TEngine.from_plan(tplan, tp, model=tm)
    dense = TEngine.from_plan(dataclasses.replace(tplan,
                                                  cache_layout="dense"),
                              tp, model=tm)
    jreqs = jwl.drive(jeng, jitems, jwl.VirtualClock())
    treqs = twl.drive(teng, titems, twl.VirtualClock())
    dreqs = twl.drive(dense, titems, twl.VirtualClock())
    assert [_stamps(r) for r in treqs] == [_stamps(r) for r in jreqs]
    assert [_stamps(r) for r in treqs] == [_stamps(r) for r in dreqs]
    assert [r.output for r in treqs] == [r.output for r in dreqs]
    assert teng.util_history == jeng.util_history == dense.util_history
    js, ts = jeng.stats(), teng.stats()
    assert {k: ts[k] for k in STAT_KEYS} == {k: js[k] for k in STAT_KEYS}
    assert ts == dense.stats()
    assert ts["overlap_prefills"] > 0
    assert (teng.sm.blocks_free(), teng.sm.bytes_resident()) == (
        jeng.sm.blocks_free(), jeng.sm.bytes_resident())
    assert teng.sm.blocks_free() == sum(
        p.capacity - 1 for p in teng.sm._pools.values())
    teng.sm.check_invariants()
    ja = jmet.aggregate(jreqs, ticks=jeng.ticks,
                        util_history=jeng.util_history)
    ta = tmet.aggregate(treqs, ticks=teng.ticks,
                        util_history=teng.util_history)
    da = tmet.aggregate(dreqs, ticks=dense.ticks,
                        util_history=dense.util_history)
    assert _same(ta, ja) and _same(ta, da)
