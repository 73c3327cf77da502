"""Preempt -> evict to the host -> resume in the port (after
tests/test_preemption.py), and the slot state the decode graph relies
on: a snapshot restored into any slot is bit-equal on every cache leaf
and is written into the cache's own tensors (every ``data_ptr`` kept);
``snapshot_many`` brings any number of victims home in one read; an
evicted greedy request resumes the tokens it would have produced
uninterrupted; overlapped admission hands its first tokens to the chunk
on the device.  The port alone: no JAX here."""

import numpy as np
import pytest
import torch

from repro_torch.models.lm import build_model
from repro_torch.models.params import tree_leaves
from repro_torch.serving.decode_graph import DecodeLoop
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.serving.slotstate import gather_slots
from repro_torch.testing import reduced_config

ARCHS = ("rwkv6-1.6b", "qwen2.5-14b")
_CACHE = {}


def _setup(arch):
    if arch not in _CACHE:
        model = build_model(reduced_config(arch))
        params = model.init_serving(torch.Generator().manual_seed(0), "cpu")
        _CACHE[arch] = (model, params)
    return _CACHE[arch]


def _engine(arch, **kw):
    model, params = _setup(arch)
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_len", 32)
    return ServingEngine(model, params, **kw)


def _solo(arch, prompt, max_new, **kw):
    eng = _engine(arch, max_batch=1, **kw)
    r = eng.submit(list(prompt), max_new_tokens=max_new)
    eng.run()
    return r.output


def _bits(t):
    return t.contiguous().view(-1).view(torch.uint8)


@pytest.mark.parametrize("arch", ARCHS)
def test_restore_into_another_slot_is_bit_equal_and_in_place(arch):
    eng = _engine(arch, max_batch=3)
    a = eng.submit([5, 9, 3, 7, 2], max_new_tokens=12)
    eng.submit([4, 4, 1], max_new_tokens=12)
    for _ in range(3):
        eng.step()
    sm = eng.sm
    leaves = tree_leaves(sm.cache)
    ptrs = [t.data_ptr() for t in leaves]
    col0 = [t.clone() for t in tree_leaves(gather_slots(sm.cache, sm.axes,
                                                        [0]))]
    other = [t.clone() for t in tree_leaves(gather_slots(sm.cache, sm.axes,
                                                         [1]))]
    snap = sm.snapshot(0)
    assert all(t.device.type == "cpu" for t in tree_leaves(snap.cache_col))
    assert snap.nbytes() == sum(t.numel() * t.element_size() for t in col0)
    sm.release(0)
    sm.restore(2, snap, a)
    assert [t.data_ptr() for t in tree_leaves(sm.cache)] == ptrs
    assert all(x is y for x, y in zip(tree_leaves(sm.cache), leaves))
    got = tree_leaves(gather_slots(sm.cache, sm.axes, [2]))
    assert all(torch.equal(_bits(g), _bits(w)) for g, w in zip(got, col0))
    kept = tree_leaves(gather_slots(sm.cache, sm.axes, [1]))
    assert all(torch.equal(_bits(g), _bits(w)) for g, w in zip(kept, other))
    assert sm.slots[2] is a and sm.active[2]
    assert sm.next_token[2] == snap.next_token
    assert sm.remaining[2] == a.max_new_tokens - len(a.output)


def test_snapshot_many_is_one_read(monkeypatch):
    eng = _engine("rwkv6-1.6b", max_batch=3)
    for p in ([1, 2, 3], [4, 5], [6, 7, 8, 9]):
        eng.submit(p, max_new_tokens=10)
    eng.step()
    singles = [eng.sm.snapshot(s) for s in (2, 0, 1)]
    reads = []
    real_cpu = torch.Tensor.cpu

    def counted(self, *a, **k):
        reads.append(self.numel())
        return real_cpu(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    many = eng.sm.snapshot_many([2, 0, 1])
    assert len(reads) == 1
    for x, y in zip(many, singles):
        assert x.next_token == y.next_token
        assert all(torch.equal(_bits(a), _bits(b)) for a, b in
                   zip(tree_leaves(x.cache_col), tree_leaves(y.cache_col)))
    reads.clear()
    syncs = eng.host_syncs
    victims = eng.preempt_many([0, 2])
    assert len(reads) == 1 and eng.host_syncs == syncs + 1
    assert [r.n_preempts for r in victims] == [1, 1]
    assert list(eng.queue)[:2] == victims[::-1]   # requeued front, in order
    assert eng.preempt_many([]) == [] and eng.host_syncs == syncs + 1
    with pytest.raises(ValueError, match="duplicate"):
        eng.sm.snapshot_many([1, 1])
    with pytest.raises(ValueError, match="unoccupied"):
        eng.sm.snapshot_many([0])
    with pytest.raises(ValueError, match="empty"):
        eng.preempt(0)


def test_incompatible_snapshot_raises_naming_the_leaf():
    eng = _engine("qwen2.5-14b")
    eng.submit([1, 2, 3], max_new_tokens=8)
    eng.step()
    snap = eng.sm.snapshot(0)
    short = _engine("qwen2.5-14b", max_len=16)
    with pytest.raises(ValueError, match="blocks/p0/k: slot-column shape"):
        short.sm.restore(0, snap, eng.sm.slots[0])
    rwkv = _engine("rwkv6-1.6b")
    with pytest.raises(ValueError, match="wkv_state: required"):
        rwkv.sm.check_snapshot_compat(snap)
    assert rwkv.sm.slots == [None, None]      # nothing was written


@pytest.mark.parametrize("arch", ARCHS)
def test_preempted_request_resumes_bit_exact(arch):
    """Evict mid-decode, serve another request through the same slot
    (overwriting the state the victim used), resume: the victim's greedy
    tokens equal an uninterrupted run's."""
    prompt = [5, 9, 3, 7, 2]
    base = _solo(arch, prompt, 10)
    eng = _engine(arch, max_batch=1)
    a = eng.submit(list(prompt), max_new_tokens=10)
    for _ in range(3):
        eng.step()
    n_at_evict = len(a.output)
    assert not a.done and n_at_evict >= 3
    eng.preempt(0)
    assert a.saved is not None and a.n_preempts == 1
    held = eng.scheduler.queue.popleft()
    assert held is a
    b = eng.submit([2, 4, 6, 8], max_new_tokens=6)
    eng.run()
    assert b.done and not a.done
    eng.scheduler.requeue_front(a)
    eng.run()
    assert a.done and a.saved is None and a.output == base
    s = eng.stats()
    assert (s["preemptions"], s["resumes"], s["evicted_tokens"]) == (
        1, 1, n_at_evict)


def test_resume_lands_in_a_different_slot():
    prompt = [3, 1, 4, 1, 5]
    base = _solo("rwkv6-1.6b", prompt, 12)
    eng = _engine("rwkv6-1.6b")
    a = eng.submit(list(prompt), max_new_tokens=12)
    b = eng.submit([2, 7, 1, 8], max_new_tokens=6)
    for _ in range(2):
        eng.step()
    assert eng.sm.slots[0] is a and eng.sm.slots[1] is b
    eng.preempt(0)
    held = eng.scheduler.queue.popleft()
    c = eng.submit([9, 9, 2], max_new_tokens=12)
    while not b.done:
        eng.step()
    eng.scheduler.requeue_front(held)
    eng.step()
    assert eng.sm.slots[1] is a
    eng.run()
    assert a.done and c.done and a.output == base


@pytest.mark.parametrize("overlap", [False, True])
def test_immediate_resume_is_a_schedule_noop(overlap):
    """Preempt between steps and let the scheduler re-grant the slot at the
    next step: tokens and stamps equal the uninterrupted run's, sampling
    at temperature > 0 included (same slot, same ticks, same draws)."""
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8]]
    hot = SamplerConfig(temperature=0.8, top_k=5)

    def serve(preempt_at):
        eng = _engine("rwkv6-1.6b", seed=7, sampler=hot,
                      overlap_prefill=overlap)
        reqs = [eng.submit(list(p), max_new_tokens=8) for p in prompts]
        for k in range(3):
            eng.step()
            if k == preempt_at:
                eng.preempt(0)
        eng.run()
        return [(r.output, r.t_submit, r.t_admit, r.t_first, r.t_done)
                for r in reqs], eng.util_history

    assert serve(preempt_at=1) == serve(preempt_at=None)


def test_edf_preempts_running_for_tighter_deadline():
    slow_prompt, fast_prompt = [5, 9, 3, 7, 2], [8, 6, 4]
    base_slow = _solo("rwkv6-1.6b", slow_prompt, 10)
    base_fast = _solo("rwkv6-1.6b", fast_prompt, 4)
    eng = _engine("rwkv6-1.6b", max_batch=1, policy="edf", preempt=True)
    slow = eng.submit(list(slow_prompt), max_new_tokens=10, deadline=500.0)
    for _ in range(3):
        eng.step()
    urgent = eng.submit(list(fast_prompt), max_new_tokens=4, deadline=10.0)
    eng.run()
    assert slow.done and urgent.done
    assert slow.n_preempts == 1 and urgent.n_preempts == 0
    assert urgent.t_done < slow.t_done
    assert slow.output == base_slow and urgent.output == base_fast
    s = eng.stats()
    assert s["preemptions"] == s["resumes"] == s["preempt_bursts"] == 1
    eng.reset_telemetry()
    assert eng.stats()["preemptions"] == 0 and eng.ticks == 0


@pytest.mark.parametrize("temperature", [0.0, 0.9])
@pytest.mark.parametrize("arch", ARCHS)
def test_overlap_gives_the_synchronous_tokens(arch, temperature):
    """overlap_prefill on and off: the same stamps and tokens (greedy, and
    seeded stochastic: the prefill's draw and each chunk's k x B uniforms
    come off the generator in the same order), fewer host reads."""
    sampler = SamplerConfig(temperature=temperature)
    rng = np.random.default_rng(2)
    work = [(rng.integers(0, 503, L).tolist(), n) for L, n in
            [(3, 5), (12, 4), (20, 6), (7, 3), (1, 5), (9, 2), (5, 7)]]
    runs = []
    for overlap in (True, False):
        eng = _engine(arch, sync_every=4, sampler=sampler, seed=3,
                      overlap_prefill=overlap)
        reqs = [eng.submit(list(p), max_new_tokens=n) for p, n in work]
        eng.run()
        runs.append((eng.stats(), [(r.output, r.t_admit, r.t_done)
                                   for r in reqs]))
    (on, r_on), (off, r_off) = runs
    assert r_on == r_off
    assert on["overlap_prefills"] == on["prefill_calls"] > 0
    assert off["host_syncs"] == on["host_syncs"] + on["prefill_calls"]


def test_decode_loop_first_tokens_ride_the_chunk():
    """``DecodeLoop.run(first=...)``: tokens given on the device for some
    slots replace the host's at those slots, the chunk decodes from them,
    and the one read writes them into the host array."""
    model, params = _setup("rwkv6-1.6b")
    outs = []
    for given in (False, True):
        cache = model.init_cache(3, 32, "cpu")
        loop = DecodeLoop(model, params, cache, SamplerConfig(), 32, 4)
        tokens = np.array([7, 11, 13], np.int32)
        first = None
        if given:
            first = ([2, 0], torch.tensor([13, 7], dtype=torch.int32))
            tokens = np.array([0, 11, 0], np.int32)
        active = np.array([1, 1, 1], bool)
        got = loop.run(tokens, active, np.full(3, -1, np.int32),
                       np.full(3, 4, np.int32), 4, False, first=first)
        assert list(tokens) == [7, 11, 13]
        outs.append(got)
    assert outs[0][0] == outs[1][0] == 4
    for a, b in zip(outs[0][1:], outs[1][1:]):
        assert (a == b).all()
