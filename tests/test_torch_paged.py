"""Port parity of the paged slot state (``repro_torch.serving.paged``)
against the JAX package's, and the dense ≡ paged contract in the port.

* ``BlockPool``: one seeded script of covers and releases through both
  packages' pools; tables, page counts, free lists and ``flat_index``
  exactly equal after every op, ``check`` holding throughout.
* Lockstep: a dense and a ``paged:8`` port engine through one seeded
  script of submits, steps and preemption bursts (fixed seeds, not an
  unseeded ``hypothesis``).  After every op the occupied columns,
  canonicalized (masked ring entries zeroed), are bit-equal, the pool
  invariants hold and every view, pool and index tensor keeps its
  ``data_ptr``; at the end schedules and ``stats()`` are equal.  With
  the bf16 KV cache and the int8 one (``k_scale``/``v_scale`` page too).
* The port's paged engine against a live JAX paged engine on the same
  script: stamps exact, greedy tokens exact but where the two packages'
  logits sit within the LM parity tolerance of a tie (as in
  tests/test_torch_engine.py: JAX's top-2 margin under 4e-2 of the
  largest logit at the first differing token), ``stats()`` equal, and the
  block accounting (tables, free lists, ``blocks_free``,
  ``bytes_resident``, ``padding_waste``, ``useful_bytes``) equal
  integers after every op; ``paged_cache_bytes`` equal.
* ``canonicalize_cache`` bit-equal to the JAX one; snapshot/restore
  round trips bit-exact within a layout and across layouts, into
  another slot.

Within the port every comparison is exact: integers, and float leaves
compared bit for bit (tolerance 0), since paging moves bytes and
computes nothing.
"""

import jax
import numpy as np
import pytest
import torch

from repro.models.lm import build_model as j_build
from repro.serving import ServingEngine as JEngine
from repro.serving.paged import BlockPool as JBlockPool
from repro.serving.paged import canonicalize_cache as j_canonicalize
from repro.serving.paged import paged_cache_bytes as j_paged_bytes
from repro.testing import reduced_config as j_reduced
from repro_torch.models.lm import build_model as t_build
from repro_torch.models.params import tree_from_numpy, tree_leaves
from repro_torch.serving import (BlockPool, PagedSlotManager, SlotManager,
                                 canonicalize_cache, gather_slots,
                                 make_slot_manager, paged_cache_bytes)
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.testing import reduced_config as t_reduced
from test_torch_engine import NOSH, TIE_REL, _jax_margin, _models

MAX_LEN = 32
BLOCK = 8
KINDS = [("rwkv6-1.6b", "bf16"), ("qwen2.5-14b", "bf16"),
         ("qwen2.5-14b", "int8")]


def _port(arch, kv="bf16"):
    """(port model, port params) of reduced ``arch`` with ``kv`` KV cache;
    the parameters are test_torch_engine's (they do not depend on the
    KV cache's dtype)."""
    _, _, tm, tp = _models(arch)
    if kv != "bf16":
        tm = t_build(t_reduced(arch, kv_cache_dtype=kv))
    return tm, tp


def _jax(arch, kv="bf16"):
    jm, jp, _, _ = _models(arch)
    if kv != "bf16":
        jm = j_build(j_reduced(arch, kv_cache_dtype=kv))
    return jm, jp


def _bits(t):
    return t.contiguous().view(-1).view(torch.uint8)


def _assert_trees_bit_equal(a, b, what):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, f"{what}: leaf {i}"
        assert torch.equal(_bits(x), _bits(y)), f"{what}: leaf {i} differs"


# ---------------------------------------------------------------------------
# (a) BlockPool against the JAX one
# ---------------------------------------------------------------------------


def _same_pools(tp, jp, what):
    np.testing.assert_array_equal(tp.table, jp.table, err_msg=what)
    np.testing.assert_array_equal(tp.pages, jp.pages, err_msg=what)
    assert tp.free_list == jp.free_list, what
    np.testing.assert_array_equal(tp.flat_index(), jp.flat_index(),
                                  err_msg=what)


@pytest.mark.parametrize("ring,block,seed", [(32, 8, 0), (24, 5, 1),
                                             (8, 40, 2), (64, 16, 3),
                                             (33, 1, 4)])
def test_block_pool_matches_jax_on_a_seeded_script(ring, block, seed):
    rng = np.random.default_rng(seed)
    tp, jp = BlockPool(ring, block, 4), JBlockPool(ring, block, 4)
    assert (tp.block, tp.n_pages, tp.capacity) == (jp.block, jp.n_pages,
                                                   jp.capacity)
    occupied = set()
    for op in range(60):
        slot = int(rng.integers(0, 4))
        if rng.random() < 0.65:
            tokens = int(rng.integers(0, 2 * ring))
            assert tp.cover(slot, tokens) == jp.cover(slot, tokens)
            occupied.add(slot)
        else:
            assert tp.release(slot) == jp.release(slot)
            occupied.discard(slot)
        _same_pools(tp, jp, f"op {op}")
        tp.check(sorted(occupied))
        jp.check(sorted(occupied))


@pytest.mark.parametrize("fault", ["leak", "double", "null", "unoccupied",
                                   "beyond", "unsorted"])
def test_block_pool_check_names_each_fault(fault):
    pool = BlockPool(32, 8, 3)
    pool.cover(0, 20)
    pool.cover(1, 9)
    pool.check([0, 1])
    if fault == "leak":
        pool.free_list.pop()
        msg = "leak"
    elif fault == "double":
        pool.table[1, 0] = pool.table[0, 0]
        msg = "double-allocated"
    elif fault == "null":
        pool.table[1, 1] = 0
        msg = "null block"
    elif fault == "unoccupied":
        occupied = [0]
        msg = "unoccupied slot 1"
    elif fault == "beyond":
        pool.table[2, 1] = 7
        msg = "beyond page count"
    else:
        pool.free_list.reverse()
        msg = "unsorted"
    with pytest.raises(AssertionError, match=msg):
        pool.check(occupied if fault == "unoccupied" else [0, 1])


# ---------------------------------------------------------------------------
# (b) dense ≡ paged lockstep in the port
# ---------------------------------------------------------------------------


def _live_columns(eng):
    """Canonicalized occupied columns of the engine's live state: for the
    paged manager the view gathered from its pool first (what the JAX
    package's ``cache`` getter returns; a no-op for the pool)."""
    occ = eng.sm.occupied()
    if not occ:
        return occ, None
    if isinstance(eng.sm, PagedSlotManager):
        eng.sm.materialize()
    return occ, canonicalize_cache(gather_slots(eng.sm.cache, eng.sm.axes,
                                                occ))


def _assert_free_blocks_clean(sm, what):
    """The null block and every free block of every pool leaf hold the
    empty pattern (``pos = -1``, zero k/v, unit scales)."""
    for pl in sm._leaves:
        pool = sm._pools[pl.ring_len]
        for b in [0] + pool.free_list:
            blk = pl.pool[:, b * pool.block:(b + 1) * pool.block]
            assert torch.equal(_bits(blk), _bits(pl.empty)), \
                f"{what}: block {b} is not clean"


def _addresses(sm):
    ptrs = [t.data_ptr() for t in tree_leaves(sm.cache)]
    if isinstance(sm, PagedSlotManager):
        ptrs += [t.data_ptr() for t in sm.tensors()]
    return ptrs


def _script(engines, seed, vocab, n_ops, check, preempt=True):
    """Apply one seeded op script to every engine alike: submits, steps
    and preemption bursts (victims drawn from the first engine's
    occupancy); ``check(what)`` after every op.  Returns each engine's
    requests."""
    rng = np.random.default_rng(seed)
    reqs = [[] for _ in engines]
    ops = ("submit", "step", "step", "preempt") if preempt else (
        "submit", "step", "step")
    for op_i in range(n_ops):
        op = rng.choice(ops)
        if op == "submit":
            n = int(rng.integers(1, 13))
            prompt = [int(t) for t in rng.integers(0, vocab, n)]
            max_new = int(rng.integers(1, 7))
            for r, e in zip(reqs, engines):
                r.append(e.submit(list(prompt), max_new_tokens=max_new))
        elif op == "step":
            for e in engines:
                e.step()
        else:
            occ = engines[0].sm.occupied()
            k = int(rng.integers(1, len(occ) + 1)) if occ else 0
            victims = [int(s) for s in rng.choice(occ, size=k,
                                                  replace=False)] if k else []
            for e in engines:
                e.preempt_many(list(victims))
        check(f"seed={seed} op[{op_i}]={op}")
    for e in engines:
        e.run()
    check(f"seed={seed} drained")
    return reqs


def _schedule(reqs):
    return [(r.output, r.t_submit, r.t_admit, r.t_first, r.t_done,
             r.n_preempts, r.t_preempts, r.t_resumes) for r in reqs]


# seeds whose scripts preempt (the schedule depends only on lengths and
# budgets, so it is the same for every arch)
@pytest.mark.parametrize("seed,sync_every,overlap", [(2, 1, False),
                                                     (5, 3, True)])
@pytest.mark.parametrize("arch,kv", KINDS)
def test_dense_and_paged_engines_in_lockstep(arch, kv, seed, sync_every,
                                             overlap):
    tm, tp = _port(arch, kv)
    make = lambda layout: TEngine(
        tm, tp, max_batch=3, max_len=MAX_LEN, seed=11, sync_every=sync_every,
        overlap_prefill=overlap, cache_layout=layout)
    dense, paged = make("dense"), make(f"paged:{BLOCK}")
    assert isinstance(paged.sm, PagedSlotManager)
    ptrs = _addresses(paged.sm)

    def check(what):
        assert dense.sm.occupied() == paged.sm.occupied(), what
        occ, cols_d = _live_columns(dense)
        _, cols_p = _live_columns(paged)
        if occ:
            _assert_trees_bit_equal(cols_d, cols_p, what)
        np.testing.assert_array_equal(dense.sm.next_token,
                                      paged.sm.next_token, err_msg=what)
        paged.sm.check_invariants()
        _assert_free_blocks_clean(paged.sm, what)
        assert _addresses(paged.sm) == ptrs, f"{what}: a tensor moved"
        assert paged.sm.bytes_resident() <= dense.sm.bytes_resident(), what
        assert paged.sm.useful_bytes() == dense.sm.useful_bytes(), what

    reqs_d, reqs_p = _script([dense, paged], seed, tm.cfg.vocab_size, 24,
                             check)
    assert _schedule(reqs_d) == _schedule(reqs_p)
    assert dense.stats() == paged.stats()
    assert paged.preemptions > 0 and paged.resumes == paged.preemptions
    assert paged.sm.blocks_free() == sum(
        p.capacity - 1 for p in paged.sm._pools.values())


# ---------------------------------------------------------------------------
# (c) the port's paged engine against a live JAX paged engine
# ---------------------------------------------------------------------------

STAT_KEYS = ["completed", "total_tokens", "prefill_calls", "instant_admits",
             "decode_chunks", "ticks", "mean_util", "active", "queued",
             "host_syncs", "preemptions", "resumes", "evicted_tokens"]


def _accounting(sm):
    pools = {s: (p.table.tolist(), p.pages.tolist(), list(p.free_list))
             for s, p in getattr(sm, "_pools", {}).items()}
    return (pools, sm.blocks_free(), sm.bytes_resident(),
            sm.padding_waste(), sm.useful_bytes(), sm.tokens_in_flight())


# block 2 crosses a block boundary at most chunks, so coverage that is
# one token short or long shows in the tables
@pytest.mark.parametrize("arch,kv,seed,sync_every,overlap,block", [
    ("rwkv6-1.6b", "bf16", 2, 2, True, BLOCK),
    ("qwen2.5-14b", "bf16", 5, 3, True, 2),
    ("qwen2.5-14b", "bf16", 2, 1, True, BLOCK),
    ("qwen2.5-14b", "int8", 2, 1, False, 2),
])
def test_paged_engine_matches_live_jax_paged_engine(arch, kv, seed,
                                                    sync_every, overlap,
                                                    block):
    jm, jp = _jax(arch, kv)
    tm, tp = _port(arch, kv)
    kw = dict(max_batch=3, max_len=MAX_LEN, seed=11, sync_every=sync_every,
              overlap_prefill=overlap, cache_layout=f"paged:{block}")
    jeng, teng = JEngine(jm, jp, NOSH, **kw), TEngine(tm, tp, **kw)

    def check(what):
        assert teng.sm.occupied() == jeng.sm.occupied(), what
        assert _accounting(teng.sm) == _accounting(jeng.sm), what
        names = ("slots.blocks_free", "slots.bytes_resident",
                 "slots.padding_waste")
        assert teng.metrics.view({n: n for n in names}) == {
            n: jeng.sm.metrics[n].value for n in names}, what
        teng.sm.check_invariants()

    treqs, jreqs = _script([teng, jeng], seed, tm.cfg.vocab_size, 24, check)
    stamps = lambda reqs: [(r.uid, len(r.output)) + s[1:]
                           for r, s in zip(reqs, _schedule(reqs))]
    assert stamps(treqs) == stamps(jreqs)
    for jr, tr in zip(jreqs, treqs):
        diff = [i for i, (a, b) in enumerate(zip(jr.output, tr.output))
                if a != b]
        if diff:   # only at a near-tie of the two packages' logits
            margin, scale = _jax_margin(jm, jp, jr.prompt,
                                        jr.output[:diff[0]])
            assert margin < TIE_REL[arch] * scale, (
                f"request {jr.uid}: token {diff[0]} differs at a JAX top-2 "
                f"margin {margin:.3g} >= {TIE_REL[arch] * scale:.3g}")
    ts, js = teng.stats(), jeng.stats()
    assert {k: ts[k] for k in STAT_KEYS} == {k: js[k] for k in STAT_KEYS}
    assert teng.util_history == jeng.util_history
    assert ts["preemptions"] > 0 and ts["resumes"] == ts["preemptions"]


@pytest.mark.parametrize("max_batch,max_len,block,tokens", [
    (4, 64, 16, 20), (8, 64, 16, 0), (3, 32, 8, 31.5), (2, 33, 5, 40),
    (4, 1024, 16, 300)])
@pytest.mark.parametrize("arch,kv", KINDS)
def test_paged_cache_bytes_equal_jax(arch, kv, max_batch, max_len, block,
                                     tokens):
    jm, _ = _jax(arch, kv)
    tm, _ = _port(arch, kv)
    assert paged_cache_bytes(tm, max_batch, max_len, block, tokens) == \
        j_paged_bytes(jm, max_batch, max_len, block, tokens)


@pytest.mark.parametrize("arch,kv", KINDS)
def test_cache_page_axes_and_dense_gauges_equal_jax(arch, kv):
    jm, _ = _jax(arch, kv)
    tm, _ = _port(arch, kv)
    for live in (False, True):
        t = tm.init_cache(3, MAX_LEN, "cpu") if live \
            else tm.cache_specs(3, MAX_LEN)
        j = jm.init_cache(3, MAX_LEN) if live else jm.cache_specs(3,
                                                                  MAX_LEN)
        got = jax.tree_util.tree_leaves(tm.cache_page_axes(t),
                                        is_leaf=lambda x: x is None)
        want = jax.tree_util.tree_leaves(jm.cache_page_axes(j),
                                         is_leaf=lambda x: x is None)
        assert got == want
    from repro.serving.slotstate import make_slot_manager as j_make

    for layout in ("dense", f"paged:{BLOCK}"):
        tsm = make_slot_manager(tm, 3, MAX_LEN, layout=layout, device="cpu")
        jsm = j_make(jm, 3, MAX_LEN, layout=layout)
        assert isinstance(tsm, SlotManager)
        assert isinstance(tsm, PagedSlotManager) == (layout != "dense")
        assert (tsm._ring_token_bytes, tsm._per_slot_bytes,
                tsm._dense_cache_bytes) == (jsm._ring_token_bytes,
                                            jsm._per_slot_bytes,
                                            jsm._dense_cache_bytes)
        assert _accounting(tsm)[1:] == _accounting(jsm)[1:]


# ---------------------------------------------------------------------------
# (d) canonicalize_cache, snapshots across layouts, fixed addresses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,kv", KINDS)
def test_canonicalize_cache_bit_equal_to_jax(arch, kv):
    jm, _ = _jax(arch, kv)
    rng = np.random.default_rng(5)

    def fill(a):
        a = np.asarray(a)
        if a.dtype == np.int32:
            return rng.integers(-1, MAX_LEN, a.shape).astype(np.int32)
        if a.dtype == np.int8:
            return rng.integers(-127, 128, a.shape).astype(np.int8)
        return rng.standard_normal(a.shape).astype(a.dtype)

    cache = jax.tree.map(fill, jm.init_cache(3, MAX_LEN))
    want = jax.tree.map(np.asarray, j_canonicalize(cache))
    got = canonicalize_cache(tree_from_numpy(cache, "cpu"))
    _assert_trees_bit_equal(got, tree_from_numpy(want, "cpu"), arch)


def _run_and_snap(arch, kv, layout):
    tm, tp = _port(arch, kv)
    eng = TEngine(tm, tp, max_batch=3, max_len=MAX_LEN, seed=3,
                  cache_layout=layout)
    req = eng.submit([7, 3, 9, 2, 8, 4, 4, 1, 6, 5], max_new_tokens=12)
    for _ in range(4):
        eng.step()
    _, before = _live_columns(eng)
    (snap,) = eng.sm.snapshot_many([0])
    eng.sm.release(0)
    return eng, req, snap, before


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_snapshots_restore_bit_exact_across_layouts_and_slots(kv):
    arch = "qwen2.5-14b"
    eng_d, req_d, snap_d, before_d = _run_and_snap(arch, kv, "dense")
    eng_p, req_p, snap_p, before_p = _run_and_snap(arch, kv,
                                                   f"paged:{BLOCK}")
    _assert_trees_bit_equal(before_d, before_p, "before the snapshots")
    ptrs = _addresses(eng_p.sm)
    # within a layout, into another slot, then across layouts
    eng_p.sm.restore(2, snap_p, req_p)
    eng_p.sm.check_invariants()
    eng_p.sm.materialize()
    same = canonicalize_cache(gather_slots(eng_p.sm.cache, eng_p.sm.axes,
                                           [2]))
    _assert_trees_bit_equal(before_p, same, "paged round trip")
    eng_p.sm.release(2)
    eng_p.sm.restore(1, snap_d, req_p)
    eng_d.sm.restore(2, snap_p, req_d)
    eng_p.sm.check_invariants()
    eng_p.sm.materialize()
    cross_p = canonicalize_cache(gather_slots(eng_p.sm.cache, eng_p.sm.axes,
                                              [1]))
    cross_d = canonicalize_cache(gather_slots(eng_d.sm.cache, eng_d.sm.axes,
                                              [2]))
    _assert_trees_bit_equal(cross_d, cross_p, "cross-layout restore")
    _assert_trees_bit_equal(before_d, cross_d, "dense after the crossing")
    assert _addresses(eng_p.sm) == ptrs
    # both resume the same tokens as one run uninterrupted would
    eng_d.run()
    eng_p.run()
    assert req_d.output == req_p.output and len(req_d.output) == 12


def test_freed_blocks_are_wiped_and_refused_restores_leave_tables():
    tm, tp = _port("qwen2.5-14b")
    eng = TEngine(tm, tp, max_batch=2, max_len=MAX_LEN, seed=1,
                  cache_layout=f"paged:{BLOCK}")
    eng.submit(list(range(1, 12)), max_new_tokens=6)
    eng.step()
    eng.step()
    sm = eng.sm
    (pool,) = sm._pools.values()
    owned = [int(b) for b in pool.table[0, :pool.pages[0]]]
    assert owned
    (snap,) = sm.snapshot_many([0])
    before = _accounting(sm)
    with pytest.raises(ValueError, match="occupied"):
        sm.restore(0, snap, eng.sm.slots[0])
    assert _accounting(sm) == before
    req = sm.slots[0]
    sm.release(0)
    assert set(owned) <= set(pool.free_list)
    _assert_free_blocks_clean(sm, "after the release")
    for pl in sm._leaves:
        if pl.empty.dim() == 2:                           # the pos leaf
            assert bool((pl.empty == -1).all())
    bad = dict(snap.cache_col)
    bad["lengths"] = torch.zeros((2,), dtype=torch.int32)
    from repro_torch.serving.slotstate import SlotSnapshot

    with pytest.raises(ValueError, match="incompatible"):
        sm.restore(1, SlotSnapshot(bad, snap.next_token), req)
    sm.check_invariants()
    assert sm.blocks_free() == pool.capacity - 1
    with pytest.raises(ValueError, match="cache_layout"):
        make_slot_manager(tm, 2, MAX_LEN, layout="paged:0", device="cpu")
    with pytest.raises(ValueError, match="block_size"):
        PagedSlotManager(tm, 2, MAX_LEN, block_size=0, device="cpu")
