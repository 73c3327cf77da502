"""Port parity of hymba (the SSD mixer of ``repro_torch.models.ssm``, the
"swa_ssm" block with its sliding-window ring cache, the reduced LM and
its serving paths) against the JAX package, at
``reduced_config("hymba-1.5b")``: d_model 64, 4/2 heads of 16, window
16, SSD heads of 16 with d_state 4, conv width 4, chunk 8, and the
pattern ``("attn", "swa_ssm") * 2`` over 8 layers.  The JAX model's
parameters, with seeded noise on the zero-initialised leaves (norm
scales, ``conv_bias``, ``ssm_norm``), are carried across through numpy
from one module-scoped JAX build.

Tolerances:

* the SSD mixer and one block, fed the same bf16 input (the JAX side
  under ``jax.jit``): both packages round the conv's adds, ``silu`` and
  the bf16 ``dot`` results at the same places; the f32 ``w_dt``
  product, ``softplus`` and the chunked recurrence's sums differ in f32
  ulps, and XLA's fused block rounds fewer bf16 intermediates (the two
  halves' norms and their sum), so outputs may differ by bf16 ulps:
  within BLOCK_REL = 1e-2 of the largest magnitude (7.2e-3 measured on
  the block, 0 on the mixer), ``ssd_state`` within STATE_REL = 1e-5,
  ``conv_state``, ``k``, ``v`` and ``pos`` exact;
* the LM (logits, k/v, conv and ssd state after 8 layers): REL = 4e-2
  of the largest magnitude, as for rwkv6 and qwen2.5-14b (2.8e-2
  measured); positions and lengths exact;
* engines (live JAX engines, the storm cells, paging): tick stamps,
  counters, ``stats()``, fault records and aggregates exact; greedy
  tokens exact except at a request's first differing token where JAX's
  top-2 logit margin is under REL of its largest logit (the rule of
  tests/test_torch_engine.py); within the port (dense against paged,
  snapshots, checkpoints, scribbles) every float leaf bit for bit.
"""

import dataclasses
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.configs import ARCHS as J_ARCHS
from repro.models import blocks as jblocks
from repro.models import ssm as jssm
from repro.models.lm import build_model as j_build
from repro.plan.plan import ServingPlan as JPlan
from repro.plan.plan import WorkloadProfile as JProfile
from repro.serving import FaultInjector as JInjector
from repro.serving import ServingEngine as JEngine
from repro.serving import drive_resilient as j_drive_resilient
from repro.serving import metrics as jmet
from repro.serving import workload as jwl
from repro.serving.faults import FaultSpec as JSpec
from repro.serving.faults import make_storm as j_make_storm
from repro.serving.paged import paged_cache_bytes as j_paged_bytes
from repro.testing import reduced_config as j_reduced
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import _flatten, _leaf_name
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.models import blocks as tblocks
from repro_torch.models import ssm as tssm
from repro_torch.models.lm import DOT_LEAVES, build_served
from repro_torch.models.lm import build_model as t_build
from repro_torch.models.params import (tree_from_numpy, tree_leaves,
                                       tree_map)
from repro_torch.plan.plan import ServingPlan as TPlan
from repro_torch.plan.plan import WorkloadProfile as TProfile
from repro_torch.serving import (FaultInjector, PagedSlotManager,
                                 VirtualClock, drive_resilient, make_storm,
                                 paged_cache_bytes)
from repro_torch.serving import metrics as tmet
from repro_torch.serving import workload as twl
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.slotstate import _paths, gather_slots
from repro_torch.testing import reduced_config as t_reduced
from test_torch_engine import NOSH, _jax_margin
from test_torch_faults import (CHAOS, CHAOS_DURATION, KEEP, STAT_KEYS,
                               _chaos_items, _column_bytes, _npy_leaves,
                               _view)
from test_torch_paged import (_accounting, _addresses,
                              _assert_free_blocks_clean,
                              _assert_trees_bit_equal, _live_columns,
                              _schedule, _script)
from test_torch_workload import _same

ARCH = "hymba-1.5b"
REL = 4e-2
BLOCK_REL = 1e-2
STATE_REL = 1e-5
MAX_LEN = 40          # above the reduced window of 16: two ring lengths
# prompts across the 8 / 16 / 32 buckets, three longer than the window
WORKLOAD = [(3, 5), (22, 6), (5, 1), (30, 8), (7, 3), (18, 5), (9, 2),
            (12, 7)]


def _perturbed(params, seed):
    """Numpy copy of JAX params with seeded noise on the zero-init leaves
    (block norms, the fused halves' norms, ``conv_bias``, ``ssm_norm``,
    the final norm)."""
    p = jax.tree.map(lambda a: np.array(a, np.float32), params)
    rng = np.random.default_rng(seed)
    noise = lambda a: (a + rng.standard_normal(a.shape) * 0.3).astype(
        np.float32)
    for blk in p["blocks"].values():
        for name in ("norm1", "norm2", "attn_out_norm", "ssm_out_norm"):
            if name in blk:
                blk[name] = noise(blk[name])
        if "ssm" in blk:
            for name in ("conv_bias", "ssm_norm"):
                blk["ssm"][name] = noise(blk["ssm"][name])
    p["final_norm"] = noise(p["final_norm"])
    return p


@functools.lru_cache(maxsize=None)
def _models():
    """(JAX LM, its params, port LM, port params): one JAX build."""
    jm = j_build(j_reduced(ARCH))
    p = _perturbed(jm.init(jax.random.PRNGKey(2)), seed=2)
    return (jm, jax.tree.map(jnp.asarray, p), t_build(t_reduced(ARCH)),
            tree_from_numpy(p, "cpu"))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(a, b, rel):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max()) / (float(np.abs(a).max()) + 1e-30)
    assert err < rel, f"relative error {err:.3g} >= {rel}"
    return err


def _exact(a, b):
    assert np.array_equal(_np(a), _np(b))


def _layer(tree, key):
    """Layer 0 of period entry ``key``, as numpy f32."""
    return jax.tree.map(lambda a: np.array(a[0], np.float32),
                        tree["blocks"][key])


def _bf16(x):
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(
        torch.bfloat16)


# ---------------------------------------------------------------------------
# configs, parameters, caches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_config_and_param_count_match_jax(reduced):
    j = j_reduced(ARCH) if reduced else J_ARCHS[ARCH]
    t = t_reduced(ARCH) if reduced else T_ARCHS[ARCH]
    for f in dataclasses.fields(t):
        got, want = getattr(t, f.name), getattr(j, f.name)
        if f.name == "ssm":
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f.name
    assert t.param_count() == j.param_count()
    if not reduced:
        assert t.param_count() == 1_557_704_000
        assert t.layer_pattern == ("attn",) + ("swa_ssm",) * 15
    else:
        assert (t.layer_pattern, t.n_layers, t.local_window) == (
            ("attn", "swa_ssm") * 2, 8, 16)


@pytest.mark.parametrize("batch,max_len,reduced", [(3, MAX_LEN, True),
                                                   (2, 12, True),
                                                   (4, 2048, False)])
def test_cache_specs_match_jax(batch, max_len, reduced):
    """Shapes and dtypes of every cache leaf; the ring lengths (max_len
    on "attn", min(window, max_len) on "swa_ssm"); the page axes (the
    SSM state one column a slot); the paged bytes model."""
    cfg = (j_reduced if reduced else J_ARCHS.__getitem__)(ARCH)
    jm = j_build(cfg)
    tm = t_build(t_reduced(ARCH) if reduced else T_ARCHS[ARCH])
    jspec, tspec = jm.cache_specs(batch, max_len), tm.cache_specs(batch,
                                                                  max_len)
    flat_j = {jax.tree_util.keystr(p): (tuple(s.shape), jnp.dtype(s.dtype).name)
              for p, s in jax.tree_util.tree_flatten_with_path(
                  jspec, is_leaf=lambda x: hasattr(x, "shape"))[0]}
    flat_t = {"".join(f"[{k!r}]" for k in path.split("/")):
              (tuple(s.shape), str(s.dtype).split(".")[1])
              for path, s in _paths(tspec)}
    assert flat_t == flat_j
    window = tm.cfg.local_window
    p1 = tspec["blocks"]["p1"]
    assert p1["k"].shape[2] == min(window, max_len)
    assert tspec["blocks"]["p0"]["k"].shape[2] == max_len
    assert p1["conv_state"].dtype == torch.bfloat16
    assert p1["ssd_state"].dtype == torch.float32
    axes = tm.cache_page_axes(tspec)["blocks"]["p1"]
    assert axes == {"k": 2, "v": 2, "pos": 2, "conv_state": None,
                    "ssd_state": None}
    if reduced:
        for block, tokens in ((8, 20), (5, 0), (16, 33.5)):
            assert paged_cache_bytes(tm, batch, max_len, block, tokens) == \
                j_paged_bytes(jm, batch, max_len, block, tokens)


def test_served_leaves_and_logits_bit_equal_to_f32_params():
    """``w_in``, ``w_bc`` and ``w_out`` are stored in bf16, every other
    SSM leaf in f32 (the JAX package's f32 and cast-at-use reads), and
    the served tree gives the f32 tree's logits bit for bit;
    ``init_serving`` equals ``serving_params(init)``."""
    _, _, tm, tp = _models()
    served = tm.serving_params(tp)
    ssm = served["blocks"]["p1"]["ssm"]
    assert {k for k, v in ssm.items() if v.dtype == torch.bfloat16} == {
        "w_in", "w_bc", "w_out"} == set(ssm) & DOT_LEAVES
    assert ssm["dt_bias"].shape == ssm["a_log"].shape == (2,)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 503, (2, 20)).astype(np.int32))
    lens = torch.tensor([20, 11], dtype=torch.int32)
    ca, la = tm.prefill(tp, {"tokens": toks, "lengths": lens}, max_len=32)
    cb, lb = tm.prefill(served, {"tokens": toks, "lengths": lens},
                        max_len=32)
    assert torch.equal(la, lb)
    step = torch.argmax(la, -1).to(torch.int32)
    assert torch.equal(tm.decode_step(tp, ca, step)[1],
                       tm.decode_step(served, cb, step)[1])
    a = tm.init_serving(torch.Generator().manual_seed(4), "cpu")
    b = tm.serving_params(tm.init(torch.Generator().manual_seed(4), "cpu"))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    with pytest.raises(ValueError, match="int8"):
        build_served(ARCH, True, "cpu", int8=True)


# ---------------------------------------------------------------------------
# the SSD mixer and the block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", ["full", "padded", "ragged"])
def test_ssm_mixer_prefill_matches_jax(rows):
    """Full rows (T = 16, two chunks), right-padded rows with ``lengths``
    (the conv tail gathered at each row's last valid steps, a row shorter
    than the conv), and T = 13, not a multiple of the chunk."""
    jm, jp, tm, tp = _models()
    pj, pt = jax.tree.map(jnp.asarray, _layer(jp, "p1")["ssm"]), \
        tree_from_numpy(_layer(jp, "p1")["ssm"], "cpu")
    T = 13 if rows == "ragged" else 16
    x = np.random.default_rng(3).standard_normal((3, T, 64)).astype(
        np.float32)
    xj, xt = _bf16(x)
    lens = np.array([16, 9, 2], np.int32) if rows == "padded" else None
    jo, jc = jax.jit(lambda p, x, n: jssm.ssm_mixer(
        p, x, jm.cfg, NOSH, mode="prefill", lengths=n))(
            pj, xj, None if lens is None else jnp.asarray(lens))
    to, tc = tssm.ssm_mixer(pt, xt, tm.cfg, mode="prefill",
                            lengths=None if lens is None else
                            torch.from_numpy(lens))
    assert to.dtype == torch.bfloat16 and tuple(to.shape) == (3, T, 64)
    if lens is not None:   # only the valid steps are the function's
        for i, n in enumerate(lens):
            _close(jo[i, :n], to[i, :n], BLOCK_REL)
    else:
        _close(jo, to, BLOCK_REL)
    _exact(jc["conv_state"], tc["conv_state"])
    _close(jc["ssd_state"], tc["ssd_state"], STATE_REL)
    if rows == "padded":   # the 2-step row's tail: a zero, then its steps
        assert not tc["conv_state"][2, 0].any()


def test_ssm_mixer_decode_chain_matches_jax():
    """Six decode steps carrying ``conv_state`` and ``ssd_state`` from a
    padded prefill; the port writes both into the cache's own tensors."""
    jm, jp, tm, tp = _models()
    pj, pt = jax.tree.map(jnp.asarray, _layer(jp, "p1")["ssm"]), \
        tree_from_numpy(_layer(jp, "p1")["ssm"], "cpu")
    rng = np.random.default_rng(4)
    xj, xt = _bf16(rng.standard_normal((2, 12, 64)).astype(np.float32))
    lens = np.array([12, 5], np.int32)
    _, jc = jax.jit(lambda p, x, n: jssm.ssm_mixer(
        p, x, jm.cfg, NOSH, mode="prefill", lengths=n))(
            pj, xj, jnp.asarray(lens))
    jstep = jax.jit(lambda p, x, c: jssm.ssm_mixer(p, x, jm.cfg, NOSH,
                                                   mode="decode", cache=c))
    _, tc = tssm.ssm_mixer(pt, xt, tm.cfg, mode="prefill",
                           lengths=torch.from_numpy(lens))
    ptrs = {k: v.data_ptr() for k, v in tc.items()}
    for _ in range(6):
        xj, xt = _bf16(rng.standard_normal((2, 1, 64)).astype(np.float32))
        jo, jc = jstep(pj, xj, jc)
        to, tc2 = tssm.ssm_mixer(pt, xt, tm.cfg, mode="decode", cache=tc)
        assert tc2 is tc and {k: v.data_ptr() for k, v in tc.items()} == ptrs
        _close(jo, to, BLOCK_REL)
        _exact(jc["conv_state"], tc["conv_state"])
        _close(jc["ssd_state"], tc["ssd_state"], STATE_REL)


def test_swa_ssm_block_matches_jax():
    """One "swa_ssm" block: a right-padded prefill of 20 steps (beyond
    the window of 16: the ring holds the last 16 positions at pos % 16),
    then four decode steps, each over the wrapped ring."""
    jm, jp, tm, tp = _models()
    pj = jax.tree.map(jnp.asarray, _layer(jp, "p1"))
    pt = tree_from_numpy(_layer(jp, "p1"), "cpu")
    rng = np.random.default_rng(5)
    xj, xt = _bf16(rng.standard_normal((3, 20, 64)).astype(np.float32))
    lens = np.array([20, 13, 2], np.int32)
    pos = np.where(np.arange(20)[None] < lens[:, None], np.arange(20)[None],
                   -1).astype(np.int32)
    jo, jc, _ = jax.jit(lambda p, x, q, n: jblocks.apply_block(
        p, x, jm.cfg, "swa_ssm", NOSH, positions=q, lengths=n,
        mode="prefill", max_len=MAX_LEN))(pj, xj, jnp.asarray(pos),
                                          jnp.asarray(lens))
    jstep = jax.jit(lambda p, x, n, c: jblocks.apply_block(
        p, x, jm.cfg, "swa_ssm", NOSH, lengths=n, mode="decode", cache=c))
    to, tc = tblocks.apply_block(
        pt, xt, tm.cfg, "swa_ssm", positions=torch.from_numpy(pos),
        lengths=torch.from_numpy(lens), mode="prefill", max_len=MAX_LEN)
    assert set(tc) == set(jc) == {"k", "v", "pos", "conv_state",
                                  "ssd_state"}
    for i, n in enumerate(lens):
        _close(jo[i, :n], to[i, :n], BLOCK_REL)

    def same_cache():
        for name in ("k", "v", "pos", "conv_state"):
            _exact(jc[name], tc[name])
        _close(jc["ssd_state"], tc["ssd_state"], STATE_REL)

    same_cache()
    assert tc["pos"][0].tolist() == list(range(16, 20)) + list(range(4, 16))
    for i in range(4):
        xj, xt = _bf16(rng.standard_normal((3, 1, 64)).astype(np.float32))
        ln = lens + i
        jo, jc, _ = jstep(pj, xj, jnp.asarray(ln), jc)
        lt = torch.from_numpy(ln)
        to, _ = tblocks.apply_block(pt, xt, tm.cfg, "swa_ssm", lengths=lt,
                                    positions=lt[:, None], mode="decode",
                                    cache=tc)
        _close(jo, to, BLOCK_REL)
        same_cache()


# ---------------------------------------------------------------------------
# the reduced LM
# ---------------------------------------------------------------------------


def test_lm_prefill_and_decode_across_ring_wrap():
    """A right-padded 3-row prefill (20, 13 and 5 tokens), then 12 decode
    steps fed the same tokens: row 0 runs from 20 to 32 tokens, row 1
    crosses the window of 16, and every swa ring slot is written over."""
    jm, jp, tm, tp = _models()
    rng = np.random.default_rng(6)
    toks = rng.integers(0, tm.cfg.vocab_size, (3, 20)).astype(np.int32)
    lens = np.array([20, 13, 5], np.int32)
    for i, n in enumerate(lens):
        toks[i, n:] = 0
    jc, jl = jax.jit(lambda p, b: jm.prefill(p, b, NOSH, max_len=MAX_LEN))(
        jp, {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(lens)})
    jstep = jax.jit(lambda p, c, t: jm.decode_step(p, c, t, NOSH))
    tc, tl = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                             "lengths": torch.from_numpy(lens)},
                        max_len=MAX_LEN)
    _close(jl, tl, REL)
    for step_i in range(13):
        for key in ("p0", "p1"):
            jb, tb = jc["blocks"][key], tc["blocks"][key]
            assert set(tb) == set(jb)
            for name in tb:
                if name == "pos":
                    _exact(jb[name], tb[name])
                else:
                    _close(jb[name], tb[name], REL)
        _exact(jc["lengths"], tc["lengths"])
        if step_i == 12:
            break
        step = np.asarray(jl).argmax(-1).astype(np.int32)
        jc, jl = jstep(jp, jc, jnp.asarray(step))
        tc, tl = tm.decode_step(tp, tc, torch.from_numpy(step))
        _close(jl, tl, REL)
    assert tc["lengths"].tolist() == [32, 25, 17]
    assert sorted(tc["blocks"]["p1"]["pos"][0, 0].tolist()) == list(
        range(16, 32))


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, L).tolist(), n) for L, n in WORKLOAD]


def _check_tokens(jreqs, treqs):
    """Equal greedy tokens, up to a request's first token where JAX's
    top-2 margin is under REL of its largest logit."""
    jm, jp, _, _ = _models()
    for jr, tr in zip(jreqs, treqs):
        diff = [i for i, (a, b) in enumerate(zip(jr.output, tr.output))
                if a != b]
        if diff:
            margin, scale = _jax_margin(jm, jp, jr.prompt,
                                        jr.output[:diff[0]])
            assert margin < REL * scale, (
                f"request {jr.uid}: token {diff[0]} differs at a JAX top-2 "
                f"margin {margin:.3g} >= {REL * scale:.3g}")


@pytest.mark.parametrize("overlap,sync_every", [(False, 4), (True, 1)])
def test_engine_matches_live_jax_engine(overlap, sync_every):
    jm, jp, tm, tp = _models()
    prompts = _prompts(tm.cfg.vocab_size)
    kw = dict(max_batch=3, max_len=MAX_LEN, sync_every=sync_every,
              overlap_prefill=overlap)
    jeng, teng = JEngine(jm, jp, NOSH, **kw), TEngine(tm, tp, **kw)
    jreqs = [jeng.submit(list(p), max_new_tokens=n) for p, n in prompts]
    treqs = [teng.submit(list(p), max_new_tokens=n) for p, n in prompts]
    jeng.run()
    teng.run()
    stamps = lambda r: (r.uid, r.t_submit, r.t_admit, r.t_first, r.t_done,
                        len(r.output), r.done)
    assert [stamps(r) for r in treqs] == [stamps(r) for r in jreqs]
    js, ts = jeng.stats(), teng.stats()
    keys = ["completed", "total_tokens", "prefill_calls", "instant_admits",
            "decode_chunks", "ticks", "mean_util", "active", "queued",
            "host_syncs"]
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
    assert teng.util_history == jeng.util_history
    assert ts["prefill_shapes"] == js["prefill_compiles"]
    _check_tokens(jreqs, treqs)


def _bits(t):
    return t.contiguous().view(-1).view(torch.uint8)


def test_preempted_snapshot_restores_bit_equal_under_jax_leaf_names():
    """A snapshot carries JAX's leaf names (the port's path form of
    them); restored into another slot it is bit-equal and written in
    place; a request preempted mid-decode resumes its uninterrupted
    greedy tokens."""
    jm, jp, tm, tp = _models()
    prompt, n = list(range(3, 24)), 9
    solo = TEngine(tm, tp, max_batch=1, max_len=MAX_LEN)
    base = solo.submit(list(prompt), max_new_tokens=n)
    solo.run()
    eng = TEngine(tm, tp, max_batch=3, max_len=MAX_LEN)
    jeng = JEngine(jm, jp, NOSH, max_batch=3, max_len=MAX_LEN)
    for e in (eng, jeng):
        e.submit(list(prompt), max_new_tokens=n)
        e.submit([4, 4, 1], max_new_tokens=n)
        for _ in range(3):
            e.step()
    sm = eng.sm
    ptrs = [t.data_ptr() for t in tree_leaves(sm.cache)]
    col = [t.clone() for t in tree_leaves(gather_slots(sm.cache, sm.axes,
                                                       [0]))]
    snap, jsnap = sm.snapshot(0), jeng.sm.snapshot(0)
    names = sorted("/".join(str(getattr(k, "key", k)) for k in path)
                   for path, _ in jax.tree_util.tree_flatten_with_path(
                       jsnap.cache_col)[0])
    assert sorted(p for p, _ in _paths(snap.cache_col)) == names
    assert "blocks/p1/ssd_state" in names
    assert sm.snapshot_compat_errors(snap) == []
    victim = sm.slots[0]
    sm.release(0)
    sm.restore(2, snap, victim)
    assert [t.data_ptr() for t in tree_leaves(sm.cache)] == ptrs
    got = tree_leaves(gather_slots(sm.cache, sm.axes, [2]))
    assert all(torch.equal(_bits(g), _bits(w)) for g, w in zip(got, col))

    eng = TEngine(tm, tp, max_batch=1, max_len=MAX_LEN)
    a = eng.submit(list(prompt), max_new_tokens=n)
    for _ in range(3):
        eng.step()
    eng.preempt(0)
    assert a.saved is not None and not a.done
    eng.run()
    assert a.done and a.output == base.output
    assert (eng.preemptions, eng.resumes) == (1, 1)


@pytest.mark.parametrize("seed,sync_every,overlap", [(2, 1, False),
                                                     (5, 3, True)])
def test_dense_and_paged_engines_in_lockstep(seed, sync_every, overlap):
    """One seeded script of submits, steps and preemption bursts through a
    dense and a ``paged:8`` engine whose pool holds two ring lengths (40
    on the "attn" layers, 16 on the "swa_ssm" layers): occupied columns
    canonicalized and bit-equal after every op, every pool's invariants,
    clean free blocks, fixed addresses, schedules and ``stats()``
    equal."""
    _, _, tm, tp = _models()
    make = lambda layout: TEngine(
        tm, tp, max_batch=3, max_len=MAX_LEN, seed=11, sync_every=sync_every,
        overlap_prefill=overlap, cache_layout=layout)
    dense, paged = make("dense"), make("paged:8")
    assert isinstance(paged.sm, PagedSlotManager)
    assert sorted(paged.sm._pools) == [16, MAX_LEN]
    ptrs = _addresses(paged.sm)

    def check(what):
        assert dense.sm.occupied() == paged.sm.occupied(), what
        occ, cols_d = _live_columns(dense)
        _, cols_p = _live_columns(paged)
        if occ:
            _assert_trees_bit_equal(cols_d, cols_p, what)
        paged.sm.check_invariants()
        _assert_free_blocks_clean(paged.sm, what)
        assert _addresses(paged.sm) == ptrs, f"{what}: a tensor moved"
        assert paged.sm.bytes_resident() <= dense.sm.bytes_resident(), what

    reqs_d, reqs_p = _script([dense, paged], seed, tm.cfg.vocab_size, 20,
                             check)
    assert _schedule(reqs_d) == _schedule(reqs_p)
    assert dense.stats() == paged.stats()
    assert paged.preemptions > 0


# ---------------------------------------------------------------------------
# the chaos grid's two hybrid storm cells, and checkpoints
# ---------------------------------------------------------------------------

CELLS = {"hymba-1.5b/dense/storm4": "dense",
         "hymba-1.5b/paged:8/storm4": "paged:8"}


def _run(pkg, name, tmpdir):
    """One storm cell through ``pkg``'s ``drive_resilient`` (the chaos
    plan at reduced width, storm seed 4, a checkpoint every 8 ticks)."""
    jm, jp, tm, tp = _models()
    knobs = dict(CHAOS, cache_layout=CELLS[name])
    storm = dict(duration=int(CHAOS_DURATION), seed=4, n_faults=4,
                 max_batch=CHAOS["max_batch"])
    if pkg == "jax":
        plan = JPlan(arch=ARCH, reduced=True, **knobs).resolve()
        eng = JEngine.from_plan(plan, jp, model=jm, sharder=NOSH)
        mgr = JManager(str(tmpdir), keep=KEEP)
        rep = j_drive_resilient(eng, _chaos_items(jwl, JProfile),
                                jwl.VirtualClock(),
                                injector=JInjector(j_make_storm(**storm)),
                                manager=mgr, checkpoint_every=8)
    else:
        plan = TPlan(arch=ARCH, reduced=True, **knobs).resolve()
        eng = TEngine.from_plan(plan, tp, model=tm)
        mgr = CheckpointManager(str(tmpdir), keep=KEEP)
        rep = drive_resilient(eng, _chaos_items(twl, TProfile),
                              VirtualClock(),
                              injector=FaultInjector(make_storm(**storm)),
                              manager=mgr, checkpoint_every=8)
    return rep, mgr


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache = {}

    def get(pkg, name):
        if (pkg, name) not in cache:
            d = tmp_path_factory.mktemp(f"{pkg}_{name.replace('/', '_')}")
            cache[(pkg, name)] = _run(pkg, name, d)
        return cache[(pkg, name)]
    return get


@pytest.mark.parametrize("name", sorted(CELLS))
def test_storm_cell_matches_live_jax(runs, name):
    """Stamps, retries, events, fault stats, restarts, utilization and
    aggregate equal to JAX's ``drive_resilient``; nothing lost."""
    (jrep, _), (trep, _) = runs("jax", name), runs("torch", name)
    jv, tv = _view(jrep, jmet), _view(trep, tmet)
    for key in jv:
        assert _same(tv[key], jv[key]), key
    assert not tv["lost"] and not jrep.lost_uids()
    assert trep.engine.fault_stats()["injected"] == 4
    assert len({e["kind"] for e in trep.fault_events}) >= 2
    _check_tokens(jrep.requests, trep.requests)
    if "paged" in name:
        trep.engine.sm.check_invariants()
        assert _accounting(trep.engine.sm) == _accounting(jrep.engine.sm)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_checkpoint_leaves_equal_and_read_both_ways(runs, name):
    """Every checkpoint step of a storm cell: the same steps and leaf
    names in both packages, every leaf but the generator ``key`` of one
    shape and dtype, the integer leaves equal; each package's manager
    reads the other's slot columns (``conv_state`` and ``k`` as bf16
    records, ``ssd_state`` f32, ``pos`` int32) bit for bit."""
    (jrep, jmgr), (trep, tmgr) = runs("jax", name), runs("torch", name)
    steps = tmgr.all_steps()
    assert steps and steps == jmgr.all_steps()
    same_tokens = all(a.output == b.output for a, b in zip(jrep.requests,
                                                           trep.requests))
    for step in steps:
        assert jmgr.manifest(step)["leaves"] == tmgr.manifest(step)["leaves"]
        jl = _npy_leaves(Path(jmgr.directory) / f"step_{step:010d}")
        tl = _npy_leaves(Path(tmgr.directory) / f"step_{step:010d}")
        assert jl.keys() == tl.keys()
        for leaf in jl:
            if leaf == "key":
                continue
            assert (jl[leaf].shape, jl[leaf].dtype) == \
                (tl[leaf].shape, tl[leaf].dtype), leaf
            if jl[leaf].dtype.kind in "iub" and (
                    leaf != "next_token" or same_tokens):
                assert np.array_equal(jl[leaf], tl[leaf]), leaf
    assert any(leaf.endswith("ssd_state") for leaf in tl)
    # the last step's slot columns, each package reading the other's files
    last = steps[-1]
    cols = {m.group(1) for m in map(re.compile(r"^slot_cols_(s\d+)_").match,
                                    tl) if m}
    assert cols
    tmpl = trep.engine.sm.column_template()
    t_like = {"slot_cols": {c: tmpl for c in cols}}
    got = CheckpointManager(jmgr.directory).restore(t_like, step=last)
    j_like = jax.tree.map(
        lambda t: jnp.zeros(t.shape, ml_dtypes.bfloat16
                            if t.dtype == torch.bfloat16 else
                            t.numpy().dtype), t_like)
    jgot = JManager(tmgr.directory).restore(j_like, step=last)
    jflat = dict(_flatten(jgot))
    for path, t in _flatten(got):
        name = _leaf_name(path)
        a = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        assert a.numpy().tobytes() == jl[name].tobytes(), name
        assert np.asarray(jflat[path]).tobytes() == tl[name].tobytes(), name


@pytest.mark.parametrize("layout", ["dense", "paged:8"])
def test_scribble_and_scrub_equal_jax(layout):
    """``_poison`` draws its garbage leaf by leaf in JAX's sorted order
    (``conv_state``, ``k``, ``pos``, ``ssd_state``, ``v``): after one
    admission in both engines the slot's whole column is bit-equal to
    the JAX one after a garbage poison, a NaN poison and a scrub; the
    guard scan catches a NaN in ``ssd_state`` alone."""
    jm, jp, tm, tp = _models()
    plan = dict(arch=ARCH, reduced=True, cache_layout=layout, max_batch=2,
                max_len=32)
    jeng = JEngine.from_plan(JPlan(**plan).resolve(), jp, model=jm,
                             sharder=NOSH)
    teng = TEngine.from_plan(TPlan(**plan).resolve(), tp, model=tm)
    for eng in (jeng, teng):
        eng.submit(list(range(5, 14)), max_new_tokens=4)
        eng.submit(list(range(5, 9)), max_new_tokens=4)
        eng.step()

    def same():
        teng.sm.materialize()
        assert _column_bytes(jeng.sm.cache, 1) == _column_bytes(
            teng.sm.cache, 1)

    for mode, seed in (("garbage", 5), ("nan", 0)):
        spec = JSpec("poison_slot", tick=0, slot=1, mode=mode, seed=seed)
        jeng._poison(1, spec)
        teng._poison(1, spec)
        same()
    jeng.sm.scrub([1])
    teng.sm.scrub([1])
    same()
    # a NaN in one ssd_state element of slot 1 alone trips the guard
    teng.sm.materialize()
    teng.sm.cache["blocks"]["p1"]["ssd_state"][1, 1, 0, 0, 0] = float("nan")
    teng.sm.repage()
    teng._poison_outstanding.add(1)
    assert teng._scan_poisoned(teng.sm.occupied()) == [1]
