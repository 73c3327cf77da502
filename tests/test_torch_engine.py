"""Port parity of the serving engine on reduced rwkv6 and reduced
qwen2.5-14b: the same requests go through a live JAX ``ServingEngine``
and through the port's.

Requests carry no ``eos_id``, so the schedule depends only on prompt
lengths and budgets: tick stamps, output lengths and the counters must
match exactly.  The JAX engine runs its synchronous admission path
(``overlap_prefill=False``, the one the port has).  Both engines run a
decode chunk on the device and read it back once (the JAX package's
``lax.while_loop``, the port's decode loop), so the host-sync counts
match at every ``sync_every`` too.

Greedy token ids must match as well, except where the two packages'
logits sit within the LM parity tolerance of a tie: at a request's first
differing token the test shows that JAX's top-2 logit margin there is
under that tolerance (REL of tests/test_torch_rwkv_lm.py and
tests/test_torch_dense_lm.py, both 4e-2, times the largest logit), and
compares no further tokens of that request.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist.sharding import Sharder
from repro.models.lm import build_model as j_build
from repro.serving import ServingEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.scheduler import make_scheduler as j_make_scheduler
from repro.testing import reduced_config as j_reduced
from repro_torch.models.lm import build_model as t_build
from repro_torch.models.params import tree_from_numpy
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.engine import default_buckets
from repro_torch.serving.sampler import SamplerConfig, sample
from repro_torch.serving.scheduler import make_scheduler as t_make_scheduler
from repro_torch.testing import reduced_config as t_reduced
from test_torch_dense_lm import REL as DENSE_REL
from test_torch_dense_lm import perturbed_params as dense_perturbed
from test_torch_rwkv_lm import REL, perturbed_params

NOSH = Sharder(None, {})
MAX_LEN = 32
# prompt lengths across the 8 / 16 / 31 buckets; one one-token budget
# finishes at its prefill token (an instant admit)
WORKLOAD = [(3, 5), (12, 4), (5, 1), (20, 6), (7, 3), (1, 5), (9, 2),
            (16, 7)]


ARCHS = ("rwkv6-1.6b", "qwen2.5-14b")
TIE_REL = {"rwkv6-1.6b": REL, "qwen2.5-14b": DENSE_REL}


@functools.lru_cache(maxsize=None)
def _models(arch):
    jm = j_build(j_reduced(arch))
    tm = t_build(t_reduced(arch))
    perturb = perturbed_params if arch == "rwkv6-1.6b" else dense_perturbed
    p = perturb(jm.init(jax.random.PRNGKey(1)), seed=1)
    return jm, jax.tree.map(jnp.asarray, p), tm, tree_from_numpy(p, "cpu")


@pytest.fixture(scope="module")
def models():
    return _models("rwkv6-1.6b")


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, L).tolist(), n) for L, n in WORKLOAD]


def _serve(engine, prompts):
    reqs = [engine.submit(list(p), max_new_tokens=n) for p, n in prompts]
    engine.run()
    return reqs


def _jax_margin(jm, jp, prompt, prefix):
    """JAX's top-1 minus top-2 logit, and its largest |logit|, for the
    token after ``prompt + prefix`` (batch-1 exact-length prefill)."""
    toks = jnp.asarray([list(prompt) + list(prefix)], jnp.int32)
    _, logits = jm.prefill(jp, {"tokens": toks}, NOSH)
    top = np.sort(np.asarray(logits[0], np.float32))[::-1]
    return float(top[0] - top[1]), float(np.abs(top).max())


@pytest.mark.parametrize("max_batch,sync_every", [(2, 1), (2, 4), (4, 1),
                                                  (4, 4), (4, 8)])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_live_jax_engine(arch, max_batch, sync_every):
    jm, jp, tm, tp = _models(arch)
    prompts = _prompts(tm.cfg.vocab_size)
    jeng = JEngine(jm, jp, NOSH, max_batch=max_batch, max_len=MAX_LEN,
                   sync_every=sync_every, overlap_prefill=False)
    teng = TEngine(tm, tp, max_batch=max_batch, max_len=MAX_LEN,
                   sync_every=sync_every)
    assert teng.bucket_lengths == jeng.bucket_lengths == list(
        default_buckets(MAX_LEN))
    jreqs, treqs = _serve(jeng, prompts), _serve(teng, prompts)

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
    # one read a decode chunk, one a prefill call
    assert ts["host_syncs"] == ts["decode_chunks"] + ts["prefill_calls"]

    for (prompt, _), jr, tr in zip(prompts, jreqs, treqs):
        diff = [i for i, (a, b) in enumerate(zip(jr.output, tr.output))
                if a != b]
        if diff:
            margin, scale = _jax_margin(jm, jp, prompt, jr.output[:diff[0]])
            assert margin < TIE_REL[arch] * scale, (
                f"request {jr.uid}: token {diff[0]} differs at a JAX top-2 "
                f"margin {margin:.3g} >= {TIE_REL[arch] * scale:.3g}")


def test_scheduler_pick_orders_match_jax():
    rng = np.random.default_rng(3)
    specs = [(int(rng.integers(1, 30)),
              None if i % 4 == 3 else float(rng.integers(5, 40)))
             for i in range(12)]
    for policy, preempt in (("fcfs", False), ("spf", False), ("edf", False),
                            ("edf", True)):
        js = j_make_scheduler(policy, preempt=preempt)
        ts = t_make_scheduler(policy, preempt=preempt)
        for uid, (L, dl) in enumerate(specs):
            js.submit(JRequest(uid, [1] * L, deadline=dl))
            ts.submit(TRequest(uid, [1] * L, deadline=dl))
        running_j = [(0, JRequest(100, [1], deadline=30.0)),
                     (1, JRequest(101, [1], deadline=None))]
        running_t = [(0, TRequest(100, [1], deadline=30.0)),
                     (1, TRequest(101, [1], deadline=None))]
        assert ts.victims(running_t, 0) == js.victims(running_j, 0)
        order_j, order_t = [], []
        for n in (1, 3, 2, 4, 5):
            order_j += [r.uid for r in js.pick(n)]
            order_t += [r.uid for r in ts.pick(n)]
        assert order_t == order_j, policy
        assert ts.stats() == js.stats()


def test_sampling_greedy_is_argmax_and_seeded_runs_repeat(models):
    _, _, tm, tp = models
    logits = torch.randn((3, 50), generator=torch.Generator().manual_seed(0))
    assert torch.equal(sample(logits, None, SamplerConfig()),
                       torch.argmax(logits, -1).to(torch.int32))
    hot = SamplerConfig(temperature=0.8, top_k=5)
    toks = sample(logits, torch.Generator().manual_seed(1), hot)
    assert all(int(t) in torch.topk(logits[i], 5).indices.tolist()
               for i, t in enumerate(toks))

    def run(seed):
        eng = TEngine(tm, tp, max_batch=2, max_len=MAX_LEN, sampler=hot,
                      seed=seed)
        return [r.output for r in _serve(eng, _prompts(tm.cfg.vocab_size))]

    assert run(7) == run(7)
    assert run(7) != run(8)


def test_engine_refuses_bad_arguments(models):
    _, _, tm, tp = models
    with pytest.raises(ValueError, match="policy"):
        TEngine(tm, tp, policy="lifo")
    with pytest.raises(ValueError, match="sync_every"):
        TEngine(tm, tp, sync_every=0)
    eng = TEngine(tm, tp, max_len=8)
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit([1] * 8)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit([])
