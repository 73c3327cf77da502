"""Port parity of the planner's engine half (``repro_torch.plan.planner``:
the cost model, ``tile_plans_for``, ``autotune``, ``autotune_from_trace``)
and of the serve CLI's ``--autotune``, against the JAX
package's ``repro.plan.planner``.

Both sides get the same inputs.  JAX's planner is handed a
``repro.hw.HardwareSpec`` named ``h100-sxm`` with the port's peak rates,
device memory size and bandwidth, and its ``HOST_SYNC_S`` / ``COMPILE_S``
are patched to the port's values (measured on the card) for the test.
The search's probes run on the virtual clock, where a schedule depends
only on lengths, budgets and deadlines, so every field of an autotuned
plan (the search record in ``provenance`` included) must be equal, with
no tolerance: ranks compare float tuples, so the scores must be JAX's
floats exactly.  ``tile_plans`` is the one field that differs by design:
the port embeds the Hopper DSE's tiles, JAX the TPU DSE's; it is held to
the port's own DSE calls instead.  The memory and layout models work from
the full-size spec trees (nothing allocated) and must give JAX's bytes,
but for one deliberate difference: the port scores its weights as it
serves them (bf16 matmul leaves), JAX its f32 leaves.  JAX's planner is
handed that byte rule, applied to its own spec tree, for the searches;
its f32 figure is held leaf for leaf to the port's spec tree apart.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.hw as jhw
from repro.obs import Tracer as JTracer
from repro.obs import fit_profile as j_fit
from repro.plan import io as jio
from repro.plan import planner as jp
from repro.plan.plan import ServingPlan as JPlan
from repro.plan.plan import WorkloadProfile as JProfile
from repro.serving import workload as jwl
from repro_torch import hw
from repro_torch.core import dse
from repro_torch.core.cells import RNNCellConfig
from repro_torch.launch import serve
from repro_torch.models.lm import DOT_LEAVES, build_model
from repro_torch.models.params import tree_leaves
from repro_torch.obs import fit_profile
from repro_torch.plan import io as tio
from repro_torch.plan import planner as tp
from repro_torch.plan.plan import ServingPlan as TPlan
from repro_torch.plan.plan import WorkloadProfile as TProfile
from repro_torch.serving import workload as twl
from repro_torch.testing import reduced_config

ARCHS = ("rwkv6-1.6b", "qwen2.5-14b", "qwen3-moe-30b-a3b",
         "granite-moe-1b-a400m", "hymba-1.5b")
# tests/test_plan.py's autotune settings and workload
AUTOTUNE_WL = dict(rate=0.8, duration=10.0, max_new_tokens=(6, 10),
                   deadline_slack=2.0)
AUTOTUNE_KW = dict(seed=3, max_len=64, max_batches=(2, 4),
                   sync_everys=(1, 2, 4), probe_duration=10.0)
# tests/test_plan.py's layout-choice settings: one probe each
LAYOUT_WL = dict(rate=0.3, duration=6.0, prompt_len=(2, 6),
                 max_new_tokens=(2, 4))
LAYOUT_KW = dict(seed=1, max_len=64, max_batches=(2,), sync_everys=(1,),
                 probe_duration=6.0)
# benchmarks/serving_load.py's drifted workload, on a shorter span
DRIFT_WL = dict(kind="poisson", rate=0.9, duration=24.0,
                prompt_len=(4, 12), max_new_tokens=(4, 12),
                prompt_len_long=63, heavy_decode=(0.05, 24, 40),
                deadline_slack=3.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The probes run many small CPU ops: one intra-op thread each, as
    the test workers already share the host's cores.  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_served_bytes(specs, name=""):
    """JAX's parameter spec tree scored with the port's byte rule: a leaf
    named in ``DOT_LEAVES`` in bf16, any other in its own dtype."""
    if isinstance(specs, dict):
        return sum(_jax_served_bytes(v, k) for k, v in specs.items())
    size = int(np.prod(specs.shape))
    return size * (2 if name in DOT_LEAVES
                   else np.dtype(specs.dtype).itemsize)


@pytest.fixture(scope="module")
def jax_spec():
    """JAX's planner at the port's spec figures, constants and weight
    bytes."""
    h = hw.H100_SXM
    spec = dataclasses.replace(
        jhw.TPU_V5E, name=h.name, peak_bf16_flops=h.peak_bf16_flops,
        peak_int8_ops=h.peak_int8_ops, hbm_bytes=h.hbm_bytes,
        hbm_bw=h.hbm_bw)
    f32_memory = jp.serving_memory_bytes

    def served_memory(arch, max_batch, max_len):
        cache = f32_memory(arch, max_batch, max_len)[1]
        return _jax_served_bytes(jp._full_model(arch).param_specs()), cache

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jp, "HOST_SYNC_S", tp.HOST_SYNC_S)
        mp.setattr(jp, "COMPILE_S", tp.COMPILE_S)
        mp.setattr(jp, "serving_memory_bytes", served_memory)
        yield spec


def _no_tiles(d):
    d = dict(d)
    d.pop("tile_plans")
    return d


def _same_but_tiles(port_plan, jax_plan):
    a = _no_tiles(tio.to_dict(port_plan))
    b = _no_tiles(jio.to_dict(jax_plan))
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------


def test_ratio_constants_are_jax_and_time_constants_the_cards():
    """The ratios and token counts are JAX's; the two times are the
    card's own, never JAX's TPU/XLA figures."""
    for name in ("HBM_FRACTION", "SYNC_GAIN_MIN", "PAGE_OVERHEAD_TOKENS"):
        assert getattr(tp, name) == getattr(jp, name), name
    assert tp.HOST_SYNC_S != 50e-6 and tp.COMPILE_S != 2.0
    assert 0 < tp.HOST_SYNC_S < 1 and 0 <= tp.COMPILE_S < 1
    assert tp._RECURRENT_KINDS == jp._RECURRENT_KINDS
    assert hw.DEFAULT.name == "h100-sxm"


@pytest.mark.parametrize("arch", ARCHS)
def test_memory_and_layout_bytes_equal_jax(arch):
    """Weights and cache bytes of the full-size config from its spec
    trees, and the modeled bytes of dense, paged:8 and paged:16 at a
    light and a full per-slot load: JAX's, exactly.  The weights are
    JAX's tree under the port's serving byte rule; the f32 spec trees'
    bytes are JAX's weights too."""
    specs = tp._full_model(arch).param_specs()
    for mb, ml in ((4, 64), (8, 2048)):
        w, cache = tp.serving_memory_bytes(arch, mb, ml)
        jw, jcache = jp.serving_memory_bytes(arch, mb, ml)
        assert cache == jcache
        assert w == _jax_served_bytes(jp._full_model(arch).param_specs())
        assert tp._spec_bytes(specs) == jw
        assert jw // 2 <= w < jw
        for lay in ("dense", "paged:8", "paged:16"):
            for load in (8.0, float(ml)):
                assert tp.cache_layout_bytes(arch, mb, ml, lay, load) == \
                    jp.cache_layout_bytes(arch, mb, ml, lay, load), \
                    (mb, ml, lay, load)
    assert tp._full_param_count(arch) == jp._full_param_count(arch)


def test_memory_model_allocates_nothing_and_caches_by_arch():
    """The full-size model is a spec tree: qwen3-moe-30b-a3b's weights
    are scored without one tensor, and the model is built once an arch.
    Served in bf16 they fit one card with the cache of 2 slots (its f32
    leaves would not), so its search is not overcommitted."""
    before = tp._full_model.cache_info()
    arch = "qwen3-moe-30b-a3b"
    w, _ = tp.serving_memory_bytes(arch, 2, 64)
    budget = hw.H100_SXM.hbm_bytes * tp.HBM_FRACTION
    cheapest = min(tp.cache_layout_bytes(arch, 2, 64, lay, 16.0)
                   for lay in tp.candidate_cache_layouts(64, (8, 16)))
    assert 60e9 < w and w + cheapest <= budget
    assert tp._spec_bytes(tp._full_model(arch).param_specs()) > budget
    assert tp._full_model(arch) is tp._full_model(arch)
    assert tp._full_model.cache_info().currsize <= before.currsize + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_served_bytes_follow_the_served_tree(arch):
    """The byte rule is ``LM.init_serving``'s: each leaf of the reduced
    served tree has the itemsize the planner counts for its spec."""
    model = build_model(reduced_config(arch))
    specs = model.param_specs()
    served = model.init_serving(torch.Generator().manual_seed(0), "cpu")
    want = sum(s.size * t.element_size()
               for s, t in zip(tree_leaves(specs), tree_leaves(served)))
    assert tp._served_bytes(specs) == want
    assert tp._served_bytes(specs) < tp._spec_bytes(specs)
    assert any(t.dtype == torch.bfloat16 for t in tree_leaves(served))


def test_cost_model_units_equal_jax(jax_spec):
    spec = hw.H100_SXM
    for arch in ARCHS:
        for mb in (1, 4, 8):
            assert tp.modeled_tick_seconds(arch, mb, spec) == \
                jp.modeled_tick_seconds(arch, mb, jax_spec)
            for cands in ((1, 2, 4, 8), (1,), (2, 8, 4)):
                for pre in (False, True):
                    assert tp.pick_sync_every(arch, mb, spec, cands, pre) \
                        == jp.pick_sync_every(arch, mb, jax_spec, cands,
                                              pre), (arch, mb, cands, pre)
    assert tp.pick_sync_every("rwkv6-1.6b", 4, spec, (1, 2, 4, 8),
                              preempt=True) == 1
    for lengths in ([4, 5, 6, 30], [], [63] * 5, list(range(1, 70, 3)),
                    [9, 9, 17, 40]):
        for ml in (64, 128):
            sets = tp.candidate_bucket_sets(lengths, ml)
            assert sets == jp.candidate_bucket_sets(lengths, ml)
            for bs in sets:
                assert tp.bucket_set_cost(bs, lengths, ml, "rwkv6-1.6b",
                                          spec) == \
                    jp.bucket_set_cost(bs, lengths, ml, "rwkv6-1.6b",
                                       jax_spec)
    for ml, blocks in ((64, (32, 8, 8, 100, 0)), (16, (8, 16, 32)),
                       (2048, (16,))):
        assert tp.candidate_cache_layouts(ml, blocks) == \
            jp.candidate_cache_layouts(ml, blocks)
    for seed in range(3):
        t_items = twl.make_workload("poisson", rate=0.8, duration=24.0,
                                    seed=seed, vocab_size=503,
                                    heavy_decode=(0.1, 24, 40))
        j_items = jwl.make_workload("poisson", rate=0.8, duration=24.0,
                                    seed=seed, vocab_size=503,
                                    heavy_decode=(0.1, 24, 40))
        for ml in (16, 64):
            assert tp.expected_tokens_per_slot(t_items, ml) == \
                jp.expected_tokens_per_slot(j_items, ml)
    assert tp.expected_tokens_per_slot([], 64) == 64.0


# ---------------------------------------------------------------------------
# tile_plans_for on the Hopper DSE
# ---------------------------------------------------------------------------


def _dse_entries(arch, mb, ml):
    """What tile_plans_for must give, from the port's DSE calls."""
    cfg = tp._full_model(arch).cfg
    out = {}
    for kind in sorted(set(cfg.layer_pattern)):
        if kind in ("rwkv", "swa_ssm"):
            cell = RNNCellConfig("gru", hidden=cfg.d_model,
                                 features=cfg.d_model, batch=1,
                                 precision="bf16")
            pers = dse.persistent_eligible(cell, max_batch=mb)
            out[kind] = dse.plan_dict(dse.best_plan(cell, max_batch=mb,
                                                    persistent=pers))
        else:
            seq = max(ml, dse.SUBLANE)
            out[kind] = dse.plan_dict(dse.best_attn_plan(
                seq, seq, cfg.head_dim_, n_heads=cfg.n_heads, batch=mb))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_tile_plans_for_each_arch_is_the_hopper_dse(arch):
    for mb, ml in ((1, 64), (4, 64), (8, 1024)):
        got = tp.tile_plans_for(arch, mb, hw.DEFAULT, max_len=ml)
        assert got == _dse_entries(arch, mb, ml)
        assert set(got) == set(jp._full_model(arch).cfg.layer_pattern)
        for entry in got.values():
            # the JAX key set, no empty field
            assert set(entry) <= {"bh", "n_tiles", "vmem_bytes", "resident",
                                  "step_latency_s", "util", "bound", "bq",
                                  "bk", "persistent"}
            assert all(v or k == "resident" for k, v in entry.items())
        TPlan(arch=arch, max_batch=mb, max_len=ml,
              tile_plans=got).validate()


def test_tile_plans_for_hybrid_marks_persistent():
    """hymba's SSD half: W_h fits a co-resident grid, so the entry is the
    persistent kernel's tile with the evidence validate demands, as JAX
    marks it persistent; its attention half gets a bq/bk tile."""
    for mb in (1, 4, 8):
        got = tp.tile_plans_for("hymba-1.5b", mb, hw.DEFAULT, max_len=1024)
        assert set(got) == {"attn", "swa_ssm"}
        ssm = got["swa_ssm"]
        assert ssm["persistent"] is True and ssm["resident"] is True
        assert ssm["vmem_bytes"] <= hw.smem_budget()
        assert got["attn"]["bq"] > 0 and got["attn"]["bk"] > 0
        TPlan(arch="hymba-1.5b", max_batch=mb, tile_plans=got).validate()
    j = jp.tile_plans_for("hymba-1.5b", 8, jhw.DEFAULT, max_len=1024)
    assert j["swa_ssm"]["persistent"] is True


def test_tile_plans_for_rwkv_streams_and_is_batch_aware():
    """rwkv6-1.6b's W_h cannot stay resident on the card: the streaming
    best, never marked persistent (JAX's n_tiles 4 is not persistent
    either); scored at the plan's batch, so 1 and 256 slots differ."""
    tp1 = tp.tile_plans_for("rwkv6-1.6b", 1, hw.DEFAULT)
    tp256 = tp.tile_plans_for("rwkv6-1.6b", 256, hw.DEFAULT)
    assert tp1["rwkv"] != tp256["rwkv"]
    for got in (tp1, tp256):
        assert "persistent" not in got["rwkv"]
    assert "persistent" not in jp.tile_plans_for("rwkv6-1.6b", 8,
                                                 jhw.DEFAULT)["rwkv"]


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def autotuned(jax_spec):
    j = jp.autotune("rwkv6-1.6b", JProfile(**AUTOTUNE_WL), jax_spec,
                    **AUTOTUNE_KW)
    t = [tp.autotune("rwkv6-1.6b", TProfile(**AUTOTUNE_WL), hw.DEFAULT,
                     device="cpu", **AUTOTUNE_KW) for _ in range(2)]
    return j, t


def test_autotune_equals_jax_but_tiles(autotuned):
    j, (t, _) = autotuned
    _same_but_tiles(t, j)
    prov = t.provenance["autotune"]
    assert set(prov) == set(j.provenance["autotune"])
    assert prov["hw"] == "h100-sxm" and len(prov["probes"]) >= 4
    assert t.tile_plans == tp.tile_plans_for("rwkv6-1.6b", t.max_batch,
                                             hw.DEFAULT, max_len=64)
    assert t.tile_plans["rwkv"]["bh"] >= 8


def test_autotune_is_deterministic_and_round_trips(autotuned, tmp_path):
    j, (a, b) = autotuned
    assert a == b
    a.validate()
    assert tio.from_dict(json.loads(json.dumps(tio.to_dict(a)))) == a
    tio.save_plan(a, str(tmp_path / "plan.json"))
    assert tio.load_plan(str(tmp_path / "plan.json")) == a
    # the JAX plan loads in the port; with the port's tiles it is the plan
    loaded = tio.from_dict(jio.to_dict(j))
    assert dataclasses.replace(loaded, tile_plans=a.tile_plans) == a


def test_autotune_layout_choice_equals_jax(jax_spec):
    """The layout choice of tests/test_plan.py: paged for qwen2.5-14b
    under light per-slot load, dense for rwkv6-1.6b (nothing to page)."""
    for arch, want in (("qwen2.5-14b", "paged:"), ("rwkv6-1.6b", "dense")):
        t = tp.autotune(arch, TProfile(**LAYOUT_WL), device="cpu",
                        **LAYOUT_KW)
        j = jp.autotune(arch, JProfile(**LAYOUT_WL), jax_spec, **LAYOUT_KW)
        _same_but_tiles(t, j)
        assert t.cache_layout.startswith(want)
        recorded = {e["layout"]: e["modeled_bytes"]
                    for e in t.provenance["autotune"]["cache_layouts"]}
        assert t.cache_layout == min(recorded, key=recorded.get)


def test_autotune_from_trace_equals_jax(jax_spec):
    """A JAX engine's trace of the drifted workload: the fitted profile,
    and the plan searched against it, equal to JAX's (but tiles)."""
    from repro.dist.sharding import Sharder
    from repro.models.lm import build_model
    from repro.serving import ServingEngine as JEngine
    from repro.testing import reduced_config
    import jax

    jm = build_model(reduced_config("rwkv6-1.6b"))
    params = jm.init(jax.random.PRNGKey(0))
    tracer = JTracer()
    eng = JEngine.from_plan(JPlan(arch="rwkv6-1.6b", reduced=True,
                                  max_len=64, max_batch=2), params,
                            model=jm, sharder=Sharder(None, {}), seed=0,
                            tracer=tracer)
    jwl.drive(eng, jwl.profile_items(JProfile(**DRIFT_WL), vocab_size=503,
                                     seed=0))
    doc = json.loads(tracer.dumps())
    assert fit_profile(doc, duration=24.0).to_json() == \
        j_fit(doc, duration=24.0).to_json()
    kw = dict(seed=0, max_len=64, max_batches=(2,), probe_duration=12.0,
              duration=24.0)
    t = tp.autotune_from_trace("rwkv6-1.6b", doc, device="cpu", **kw)
    j = jp.autotune_from_trace("rwkv6-1.6b", doc, jax_spec, **kw)
    _same_but_tiles(t, j)
    obs = t.provenance["observed_traffic"]
    assert obs["trace_summary"]["with_deadline"] > 0
    assert t.policy != "spf"     # the deadlines were seen: edf probed


# ---------------------------------------------------------------------------
# CLI: --autotune and the staleness recompute
# ---------------------------------------------------------------------------


def _resolve(argv):
    parser = serve.build_parser()
    return serve.resolve_plan(parser.parse_args(argv), parser)


def test_cli_override_recomputes_stale_tile_plans(tmp_path):
    """A --plan file's tiles were scored at its own max_batch; a
    --max-batch override makes them stale, so they are rescored."""
    old = tp.tile_plans_for("rwkv6-1.6b", 1, hw.DEFAULT, max_len=128)
    base = TPlan(arch="rwkv6-1.6b", max_batch=1, max_len=128,
                 tile_plans=old)
    path = str(tmp_path / "plan.json")
    tio.save_plan(base, path)
    plan = _resolve(["--plan", path, "--max-batch", "256"])
    assert dict(plan.tile_plans) == tp.tile_plans_for(
        "rwkv6-1.6b", 256, hw.DEFAULT, max_len=128)
    assert dict(plan.tile_plans) != old
    # an override that leaves them fresh keeps them
    plan = _resolve(["--plan", path, "--policy", "spf"])
    assert dict(plan.tile_plans) == old


def test_cli_plan_and_autotune_flags_are_checked(tmp_path, capsys):
    path = str(tmp_path / "plan.json")
    tio.save_plan(TPlan(arch="rwkv6-1.6b"), path)
    with pytest.raises(SystemExit):
        _resolve(["--plan", path, "--autotune"])
    assert "mutually exclusive" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        _resolve(["--autotune", "--reduced", "--device", "cpu"])
    assert "--autotune requires --arch" in capsys.readouterr().err


def test_cli_autotune_serves_and_saves_the_plan(tmp_path, capsys):
    """The CLI's search is ``planner.autotune`` on the CLI's workload:
    --arch and a --max-len equal to the plan's are not overrides."""
    path = str(tmp_path / "tuned.json")
    serve.main(["--arch", "rwkv6-1.6b", "--reduced", "--autotune",
                "--arrival", "poisson", "--rate", "0.8", "--duration", "12",
                "--deadline-slack", "3", "--max-len", "64", "--save-plan",
                path, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "slo" in out and "engine stats:" in out
    saved = tio.load_plan(path)
    assert saved.provenance["source"] == "autotune"
    assert "cli_overrides" not in saved.provenance
    wl = TProfile(kind="poisson", rate=0.8, duration=12.0,
                  max_new_tokens=(16, 16), deadline_slack=3.0)
    want = tp.autotune("rwkv6-1.6b", wl, seed=0, reduced=True, max_len=64,
                       device="cpu")
    prov = dict(saved.provenance)
    prov.pop("source")
    assert dataclasses.replace(saved, provenance=prov) == want.resolve()


def test_probe_engine_is_closed(monkeypatch):
    """Each probe releases its engine (on CUDA, its decode graph)."""
    from repro_torch.serving.engine import ServingEngine

    built = []
    real = ServingEngine.from_plan.__func__

    def from_plan(cls, *a, **k):
        eng = real(cls, *a, **k)
        built.append(eng)
        return eng

    monkeypatch.setattr(ServingEngine, "from_plan", classmethod(from_plan))
    plan = tp.autotune("rwkv6-1.6b", TProfile(rate=0.3, duration=4.0),
                       device="cpu", max_batches=(2,), probe_duration=4.0)
    assert len(built) == len(plan.provenance["autotune"]["probes"]) == 2
    assert all(e.sm is None for e in built)
    assert torch.device("cpu") == built[0].device
