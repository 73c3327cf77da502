"""Port parity of the engine's decode loop and of the in-place decode step.

The loop's control (token writeback, EOS / cache-full / budget done-mask,
the exit test) is held to the JAX engine's ``lax.while_loop`` itself:
``repro.serving.engine._decode_many`` and the port's chunk run a stub
model, written the same way in both frameworks, whose greedy token is a
fixed function of (token, length), so EOS ids and full caches are hit at
ticks the cases choose.  Over 60 seeded cases of active masks, EOS ids,
budgets, lengths, limits and ``stop_on_free`` the tick count, the token,
active and done rows and the final lengths must be equal.

``LM.decode_step_`` (in place) is held to ``LM.decode_step`` (a copy) on
reduced rwkv6 and qwen2.5-14b with bf16 and int8 KV caches: equal
logits and caches, every cache leaf at its old address after the
in-place step, and the copying step's input left as it was.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist.sharding import Sharder
from repro.serving.engine import _decode_many as j_decode_many
from repro.serving.sampler import SamplerConfig as JSampler
from repro_torch.kernels.decode_loop import decode_loop as dl
from repro_torch.models.lm import build_model
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.serving.decode_graph import DecodeLoop
from repro_torch.serving.engine import _decode_many as t_decode_many
from repro_torch.serving.sampler import SamplerConfig as TSampler
from repro_torch.testing import reduced_config

V = 11          # the stub's vocabulary
B = 5
MAX_LEN = 12


def _next(tokens, lengths):
    return (tokens * 7 + lengths * 3 + 1) % V


class JStub:
    """The JAX engine's model interface: decode_step returns a new cache."""

    def decode_step(self, params, cache, tokens, sharder=None):
        lengths = cache["lengths"]
        logits = jax.nn.one_hot(_next(tokens, lengths), V, dtype=jnp.float32)
        return {"lengths": lengths + 1}, logits


class TStub:
    """The port's: decode_step_ advances the cache in place."""

    def decode_step_(self, params, cache, tokens):
        lengths = cache["lengths"]
        nxt = _next(tokens.long(), lengths.long())
        logits = torch.nn.functional.one_hot(nxt, V).float()
        lengths.add_(1)
        return logits


@partial(jax.jit, static_argnums=0)
def _j_chunk(k, cache, tokens, active, eos, remaining, limit, stop):
    return j_decode_many(JStub(), Sharder(None, {}), JSampler(), MAX_LEN, k,
                         None, cache, tokens, jax.random.PRNGKey(0), active,
                         eos, remaining, limit, stop)


def _case(rng, k):
    tokens = rng.integers(0, V, B).astype(np.int32)
    lengths = np.where(rng.random(B) < 0.25,
                       rng.integers(MAX_LEN - 3, MAX_LEN, B),
                       rng.integers(0, MAX_LEN - 3, B)).astype(np.int32)
    active = rng.random(B) < (0.0 if rng.random() < 0.08 else 0.7)
    # an EOS that the stub reaches within the chunk, at a chosen tick
    eos = np.full(B, -1, np.int32)
    for b in range(B):
        if rng.random() < 0.5:
            t, L = int(tokens[b]), int(lengths[b])
            hit = int(rng.integers(0, k))
            for _ in range(hit + 1):
                t, L = _next(t, L), L + 1
            eos[b] = t
    remaining = rng.integers(0, 7, B).astype(np.int32)
    limit = 0 if rng.random() < 0.1 else int(rng.integers(1, k + 1))
    return tokens, lengths, active, eos, remaining, limit, bool(
        rng.integers(0, 2))


@pytest.mark.parametrize("block", range(6))
@pytest.mark.parametrize("k", [1, 4])
def test_decode_chunk_matches_jax_while_loop(k, block):
    rng = np.random.default_rng(100 * k + block)
    for _ in range(5):
        tokens, lengths, active, eos, remaining, limit, stop = _case(rng, k)
        jn, jc, _, jt, ja, jd = _j_chunk(
            k, {"lengths": jnp.asarray(lengths)}, jnp.asarray(tokens),
            jnp.asarray(active), jnp.asarray(eos), jnp.asarray(remaining),
            np.int32(limit), np.bool_(stop))
        cache = {"lengths": torch.from_numpy(lengths.copy())}
        before = dl.LAUNCHES["decode_loop"]
        tn, tc, _, tt, ta, td = t_decode_many(
            TStub(), TSampler(), MAX_LEN, k, None, cache, tokens, None,
            active, eos, remaining, limit, stop)
        assert dl.LAUNCHES["decode_loop"] == before   # the plain version
        assert tn == int(jn)
        np.testing.assert_array_equal(tt, np.asarray(jt))
        np.testing.assert_array_equal(ta, np.asarray(ja))
        np.testing.assert_array_equal(td, np.asarray(jd))
        np.testing.assert_array_equal(tc["lengths"].numpy(),
                                      np.asarray(jc["lengths"]))
        assert tc is cache


def test_decode_chunk_refuses_bad_buffers():
    with pytest.raises(ValueError, match="slots"):
        dl.buffers(0, 4, "cpu")
    with pytest.raises(ValueError, match="ticks"):
        dl.buffers(2, 0, "cpu")
    # off the CPU the wrapper launches the kernel or raises
    inp, out, ctl = dl.buffers(2, 4, "meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        dl.epilogue(inp[:2], inp[2:4], inp, out, ctl, k=4, max_len=8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        DecodeLoop(TStub(), None, {"lengths": torch.zeros(2, dtype=torch.int32)},
                   TSampler(), 8, 4, graph=True)


LMS = [("rwkv6-1.6b", "bf16"), ("qwen2.5-14b", "bf16"),
       ("qwen2.5-14b", "int8")]


@pytest.mark.parametrize("arch,kv", LMS)
def test_decode_step_in_place_matches_copying_step(arch, kv):
    cfg = reduced_config(arch, kv_cache_dtype=kv)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(3)
    params = model.serving_params(model.init(gen, "cpu"))
    for leaf in ("bonus", "mu", "ln1") if arch.startswith("rwkv") else ():
        params["blocks"]["p0"][leaf].normal_(0, 0.3, generator=gen)
    toks = torch.randint(0, cfg.vocab_size, (3, 9), generator=gen,
                         dtype=torch.int32)
    lens = torch.tensor([9, 4, 1], dtype=torch.int32)
    cache, logits = model.prefill(params, {"tokens": toks, "lengths": lens},
                                  max_len=16)
    live = tree_map(torch.clone, cache)
    ptrs = [t.data_ptr() for t in tree_leaves(live)]
    t = torch.argmax(logits, -1).to(torch.int32)
    for _ in range(4):
        kept = tree_map(torch.clone, cache)
        new, l_copy = model.decode_step(params, cache, t)
        l_live = model.decode_step_(params, live, t)
        assert torch.equal(l_copy, l_live)
        for a, b in zip(tree_leaves(kept), tree_leaves(cache)):
            assert torch.equal(a, b)          # decode_step left its input
        for a, b in zip(tree_leaves(new), tree_leaves(live)):
            assert torch.equal(a, b)
        assert [x.data_ptr() for x in tree_leaves(live)] == ptrs
        assert not any(x.data_ptr() in ptrs for x in tree_leaves(new))
        cache, t = new, torch.argmax(l_live, -1).to(torch.int32)
    assert torch.equal(live["lengths"], lens + 4)


@pytest.mark.parametrize("arch,kv", LMS)
def test_reset_cache_puts_a_used_cache_back_to_init(arch, kv):
    """``reset_cache_`` (how a captured decode graph puts the cache back
    after its warm-up tick) gives ``init_cache``'s tree in place."""
    cfg = reduced_config(arch, kv_cache_dtype=kv)
    model = build_model(cfg)
    params = model.serving_params(model.init(torch.Generator().manual_seed(1),
                                             "cpu"))
    cache = model.init_cache(2, 16, "cpu")
    ptrs = [t.data_ptr() for t in tree_leaves(cache)]
    t = torch.tensor([3, 5], dtype=torch.int32)
    for _ in range(3):
        t = torch.argmax(model.decode_step_(params, cache, t), -1).to(
            torch.int32)
    assert int(cache["lengths"].sum()) == 6
    model.reset_cache_(cache, 16)
    for a, b in zip(tree_leaves(cache), tree_leaves(model.init_cache(
            2, 16, "cpu"))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert [x.data_ptr() for x in tree_leaves(cache)] == ptrs
    if not arch.startswith("rwkv"):      # its cache does not hold max_len
        with pytest.raises(ValueError, match="max_len"):
            model.reset_cache_(cache, 32)


def test_launch_registry_counts_graph_nodes_by_device_function():
    """Kernel nodes map to the counters their modules registered, by their
    device functions' (mangled) names; counters that registered no names
    (the RNN cells') take none; ``add`` and ``since`` work on every
    registered counter."""
    from repro_torch.kernels import launches
    from repro_torch.kernels.flash_attention import flash_decode  # noqa
    from repro_torch.kernels.fused_rnn import fused_rnn  # noqa
    from repro_torch.kernels.matmul_int8 import matmul_int8  # noqa
    from repro_torch.kernels.rwkv_step import rwkv_step  # noqa

    names = ["_ZN12_GLOBAL__N_117rwkv6_step_kernelILi64ELi64EEEvPK13__nv_"
             "bfloat16S3_S3_PKfS5_S5_PfPS1_iiiiii",
             "_ZN12_GLOBAL__N_126matmul_w8a16_decode_kernelENS_7DecArgsE14CU"
             "tensorMap_stS1_",
             "_ZN12_GLOBAL__N_126matmul_w8a16_reduce_kernelEPKfS1_S1_P13__nv"
             "_bfloat16iiii",
             "_ZN12_GLOBAL__N_127flash_decode_partial_kernelILi128ELi1EEEvNS"
             "_7DecArgsE",
             "_ZN12_GLOBAL__N_127flash_decode_combine_kernelEPKfS1_S1_Pfii",
             "_ZN12_GLOBAL__N_118decode_loop_kernelEPKiS1_PiS2_S2_iiiiy",
             "_ZN12_GLOBAL__N_117rnn_stream_kernelILi4ELb0EEEvNS_8StepArgsEi",
             "void at::native::vectorized_elementwise_kernel<4>"]
    per = launches.by_counter(names)
    assert per == {"rwkv6_step": 1, "matmul_w8a16": 1, "flash_decode": 1,
                   "decode_loop": 1}
    mark = launches.counters()
    assert set(mark) >= {"rwkv6_step", "flash_attention", "flash_decode",
                         "matmul_w8a16", "matmul_w8a16_prefill",
                         "decode_loop", "fused_lstm", "fused_gru"}
    try:
        launches.add(per, 3)
        assert launches.since(mark) == {k: 3 for k in per}
        assert rwkv_step.LAUNCHES["rwkv6_step"] == mark["rwkv6_step"] + 3
    finally:
        launches.restore(mark)
    assert launches.since(mark) == {}
    with pytest.raises(ValueError, match="unknown counters"):
        launches.register({"a": 0}, {"b": ("b_kernel",)})


def test_sampler_draws_from_the_generator_by_inverting_the_cdf():
    """One sampler: without ``u`` it draws ``u`` from the generator and
    inverts the CDF as it does with ``u`` given; greedy is argmax."""
    from repro_torch.serving.sampler import sample

    logits = torch.randn((6, 40), generator=torch.Generator().manual_seed(0))
    hot = TSampler(temperature=0.8, top_k=5)
    got = sample(logits, torch.Generator().manual_seed(4), hot)
    u = torch.rand((6,), generator=torch.Generator().manual_seed(4))
    assert torch.equal(got, sample(logits, None, hot, u=u))
    top5 = torch.topk(logits, 5, dim=-1).indices
    assert all(int(t) in top5[i].tolist() for i, t in enumerate(got))
    assert torch.equal(sample(logits, None, TSampler()),
                       torch.argmax(logits, -1).to(torch.int32))
