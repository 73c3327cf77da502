"""Port parity on reduced qwen2.5-14b: the port's config, rope, MLP,
prefill and decode against the JAX package, with the JAX model's own
parameters carried across by ``tree_from_numpy``.

The zero-initialised leaves (the qkv biases, the norm scales) are
perturbed with seeded noise before both sides get them, so the biases
and the norm scales do real work.

Tolerance (logits, k/v caches): both packages round activations to bf16
at the same places, but their f32 sums (matmuls, the online softmax) run
in other orders and rope's cos/sin may differ in the last f32 ulp; where
a value lands on a bf16 rounding boundary one side rounds up and the
other down, a one-ulp (2^-8 relative) flip that later layers carry
forward.  So values are compared relative to the largest magnitude of
the tensor: REL = 4e-2, as for rwkv6 (tests/test_torch_rwkv_lm.py).
Integer results (positions, lengths) are exact.  int8 KV codes are
exact wherever the bf16 k/v they quantize are equal; their scales
(amax / 127) are within one f32 ulp, because XLA under ``jit`` computes
the division by the constant 127 as a product with its rounded
reciprocal, while the port (like eager JAX) divides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.dist.sharding import Sharder
from repro.models import layers as jlayers
from repro.models.lm import build_model as j_build
from repro.testing import reduced_config as j_reduced
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.quant import quantize_kv
from repro_torch.models import layers as tlayers
from repro_torch.models.lm import build_model as t_build
from repro_torch.models.params import tree_from_numpy, tree_leaves, tree_map
from repro_torch.testing import reduced_config as t_reduced

NOSH = Sharder(None, {})
REL = 4e-2
ARCH = "qwen2.5-14b"
ZERO_INIT = ("norm1", "norm2")
ZERO_INIT_ATTN = ("bq", "bk", "bv")


def perturbed_params(params, seed=0, scale=0.3):
    """Numpy copy of JAX params with seeded noise on the zero-init leaves."""
    p = jax.tree.map(lambda a: np.array(a, np.float32), params)
    rng = np.random.default_rng(seed)
    noise = lambda a: (a + rng.standard_normal(a.shape) * scale).astype(
        np.float32)
    blk = p["blocks"]["p0"]
    for name in ZERO_INIT:
        blk[name] = noise(blk[name])
    for name in ZERO_INIT_ATTN:
        blk["attn"][name] = noise(blk["attn"][name])
    p["final_norm"] = noise(p["final_norm"])
    return p


def _setup(kv_cache_dtype="bf16"):
    jcfg = j_reduced(ARCH, kv_cache_dtype=kv_cache_dtype)
    tcfg = t_reduced(ARCH, kv_cache_dtype=kv_cache_dtype)
    jm, tm = j_build(jcfg), t_build(tcfg)
    p = perturbed_params(jm.init(jax.random.PRNGKey(0)))
    return dict(jm=jm, tm=tm, jp=jax.tree.map(jnp.asarray, p),
                tp=tree_from_numpy(p, "cpu"), cfg=tcfg,
                jprefill=jax.jit(lambda p, b: jm.prefill(p, b, NOSH,
                                                         max_len=32)),
                jdecode=jax.jit(lambda p, c, t: jm.decode_step(p, c, t,
                                                               NOSH)))


@pytest.fixture(scope="module")
def setup():
    return _setup()


@pytest.fixture(scope="module")
def setup_int8():
    return _setup("int8")


def close(a, b, rel=REL):
    a = np.asarray(a, np.float32)
    b = b.float().numpy() if isinstance(b, torch.Tensor) else b
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = float(np.abs(a).max()) + 1e-9
    err = float(np.abs(a - b).max()) / scale
    assert err < rel, f"relative error {err:.3g} >= {rel}"
    return err


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_jax(reduced):
    j = j_reduced(ARCH) if reduced else j_get_config(ARCH)
    t = t_reduced(ARCH) if reduced else t_get_config(ARCH)
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    for prop in ("padded_vocab", "n_periods", "head_dim_", "q_dim",
                 "kv_dim"):
        assert getattr(t, prop) == getattr(j, prop)
    if not reduced:
        assert (t.n_layers, t.d_model, t.n_heads, t.n_kv_heads, t.d_ff,
                t.padded_vocab, t.rope_theta, t.qkv_bias) == (
            48, 5120, 40, 8, 13824, 152064, 1e6, True)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_param_and_cache_specs_match_jax(setup, setup_int8, kv):
    s = setup if kv == "bf16" else setup_int8
    jspecs, tspecs = s["jm"].param_specs(), s["tm"].param_specs()
    assert tree_map(lambda x: tuple(x.shape), tspecs) == jax.tree.map(
        lambda x: tuple(x.shape), jspecs,
        is_leaf=lambda x: hasattr(x, "shape"))
    jc, tc = s["jm"].cache_specs(3, 32), s["tm"].cache_specs(3, 32)
    assert tree_map(lambda x: (tuple(x.shape), str(x.dtype).split(".")[-1]),
                    tc) == jax.tree.map(
        lambda x: (tuple(x.shape), str(np.dtype(x.dtype))), jc,
        is_leaf=lambda x: hasattr(x, "shape"))
    assert s["tm"].n_params() == s["jm"].n_params()
    # the initial cache: empty slots at position -1, unit int8 scales
    j0 = s["jm"].init_cache(3, 32)
    t0 = s["tm"].init_cache(3, 32, "cpu")
    tree_map(lambda b, a: np.testing.assert_array_equal(
        np.asarray(a).astype(np.float32), b.float().numpy()), t0,
        jax.tree.map(np.asarray, j0))


def test_rope_and_mlp_match_jax(setup):
    cfg = setup["cfg"]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 1024, (2, 9)).astype(np.int32)
    for theta in (1e4, 1e6):
        jo = jlayers.apply_rope(jnp.asarray(x).astype(jnp.bfloat16),
                                jnp.asarray(pos), theta)
        to = tlayers.apply_rope(torch.from_numpy(x).to(torch.bfloat16),
                                torch.from_numpy(pos), theta)
        # angles up to ~1e3 rad: XLA's and torch's cos/sin may differ in
        # the last f32 ulp, which can flip one bf16 ulp of the output
        np.testing.assert_allclose(to.float().numpy(),
                                   np.asarray(jo, np.float32),
                                   atol=2 ** -7, rtol=2 ** -7)
    np.testing.assert_allclose(
        tlayers.rope_frequencies(16, 1e6).numpy(),
        np.asarray(jlayers.rope_frequencies(16, 1e6)), rtol=1e-6)
    jb = jax.tree.map(lambda a: a[0], setup["jp"]["blocks"]["p0"]["mlp"])
    tb = tree_map(lambda a: a[0], setup["tp"]["blocks"]["p0"]["mlp"])
    h = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    jo = jlayers.mlp(jb, jnp.asarray(h).astype(jnp.bfloat16),
                     setup["jm"].cfg, NOSH)
    to = tlayers.mlp(tb, torch.from_numpy(h).to(torch.bfloat16), cfg)
    close(jo, to, rel=1e-2)


def _prompts(cfg, lens, S, seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), S), np.int32)
    for i, L in enumerate(lens):
        toks[i, :L] = rng.integers(0, cfg.vocab_size, L)
    return toks, np.asarray(lens, np.int32)


def _compare_cache(jc, tc, cfg):
    jb, tb = jc["blocks"]["p0"], tc["blocks"]["p0"]
    np.testing.assert_array_equal(np.asarray(jb["pos"]), tb["pos"].numpy())
    np.testing.assert_array_equal(np.asarray(jc["lengths"]),
                                  tc["lengths"].numpy())
    if cfg.kv_cache_dtype == "int8":
        for name in ("k", "v"):
            assert tb[name].dtype == torch.int8
            deq = lambda q, s: np.asarray(q, np.float32) * np.asarray(
                s, np.float32)[..., None]
            close(deq(jb[name], jb[name + "_scale"]),
                  deq(tb[name].numpy(), tb[name + "_scale"].numpy()))
        return
    for name in ("k", "v"):
        assert tb[name].dtype == torch.bfloat16
        close(jb[name], tb[name])


def test_prefill_matches_jax(setup):
    toks, lens = _prompts(setup["cfg"], [11, 6, 1], S=16)
    jc, jl = setup["jprefill"](setup["jp"], {"tokens": jnp.asarray(toks),
                                             "lengths": jnp.asarray(lens)})
    tc, tl = setup["tm"].prefill(setup["tp"],
                                 {"tokens": torch.from_numpy(toks),
                                  "lengths": torch.from_numpy(lens)},
                                 max_len=32)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (3, 512)
    close(jl, tl)
    _compare_cache(jc, tc, setup["cfg"])
    assert tuple(tc["blocks"]["p0"]["k"].shape) == (2, 3, 32, 2, 16)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_decode_steps_match_jax(setup, setup_int8, kv):
    """k decode steps from the same prefill, fed the same tokens."""
    s = setup if kv == "bf16" else setup_int8
    toks, lens = _prompts(s["cfg"], [9, 4], S=16, seed=1)
    jc, jl = s["jprefill"](s["jp"], {"tokens": jnp.asarray(toks),
                                     "lengths": jnp.asarray(lens)})
    tc, tl = s["tm"].prefill(s["tp"], {"tokens": torch.from_numpy(toks),
                                       "lengths": torch.from_numpy(lens)},
                             max_len=32)
    t = np.asarray(jnp.argmax(jl, -1), np.int32)
    for _ in range(4):
        jc, jl = s["jdecode"](s["jp"], jc, jnp.asarray(t))
        tc, tl = s["tm"].decode_step(s["tp"], tc, torch.from_numpy(t.copy()))
        close(jl, tl)
        _compare_cache(jc, tc, s["cfg"])
        t = np.asarray(jnp.argmax(jl, -1), np.int32)


def test_int8_kv_codes_and_scales_exact(setup_int8):
    """Layer 0's k/v are the same bf16 values in both packages (embedding,
    norm, projection, bias and rope round alike), so the int8 codes the
    prefill stores are bit-equal and the scales within one f32 ulp (the
    jitted JAX prefill multiplies by 1/127; see the module note); eager
    ``quantize_kv`` is bit-equal in codes and scales."""
    s = setup_int8
    toks, lens = _prompts(s["cfg"], [12, 5], S=16, seed=4)
    jc, _ = s["jprefill"](s["jp"], {"tokens": jnp.asarray(toks),
                                    "lengths": jnp.asarray(lens)})
    tc, _ = s["tm"].prefill(s["tp"], {"tokens": torch.from_numpy(toks),
                                      "lengths": torch.from_numpy(lens)},
                            max_len=32)
    jb, tb = jc["blocks"]["p0"], tc["blocks"]["p0"]
    for name in ("k", "v"):
        np.testing.assert_array_equal(np.asarray(jb[name])[0],
                                      tb[name][0].numpy())
        np.testing.assert_array_max_ulp(np.asarray(jb[name + "_scale"])[0],
                                        tb[name + "_scale"][0].numpy(),
                                        maxulp=1)
    from repro.core.quant import quantize_kv as j_quantize_kv
    x = np.random.default_rng(2).standard_normal((3, 7, 2, 16))
    xb = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    jq, js = j_quantize_kv(xb)
    tq, ts = quantize_kv(torch.from_numpy(x.astype(np.float32)).to(
        torch.bfloat16))
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())


def test_bucketed_prefill_equals_batch1(setup):
    """One right-padded batched prefill == per-prompt exact-length
    prefills, and the next decode step from the copied rows, as
    tests/test_decode_hotpath.py holds the JAX package (2e-2)."""
    tm, tp = setup["tm"], setup["tp"]
    toks, lens = _prompts(setup["cfg"], [3, 5, 9], S=16, seed=2)
    cB, lB = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                             "lengths": torch.from_numpy(lens)}, max_len=32)
    for i, L in enumerate(lens):
        c1, l1 = tm.prefill(tp, {"tokens": torch.from_numpy(
            toks[i:i + 1, :L])}, max_len=32)
        assert int(cB["lengths"][i]) == L
        scale = float(l1.abs().max())
        assert float((lB[i] - l1[0]).abs().max()) / scale < 2e-2
        row = {"blocks": tree_map(lambda a: a[:, i:i + 1], cB["blocks"]),
               "lengths": cB["lengths"][i:i + 1]}
        t = torch.argmax(l1, dim=-1).to(torch.int32)
        _, dB = tm.decode_step(tp, row, t)
        _, d1 = tm.decode_step(tp, c1, t)
        assert float((dB - d1).abs().max()) / scale < 2e-2


def test_served_tree_built_leaf_by_leaf_is_bit_equal(setup):
    tm = setup["tm"]
    two_step = tm.serving_params(tm.init(torch.Generator().manual_seed(5),
                                         device="cpu"))
    one_leaf = tm.init_serving(torch.Generator().manual_seed(5),
                               device="cpu")
    names = lambda t: tree_map(lambda a: (tuple(a.shape), a.dtype), t)
    assert names(one_leaf) == names(two_step)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(one_leaf),
                                                 tree_leaves(two_step)))
    blk = one_leaf["blocks"]["p0"]
    for leaf in ("wq", "wk", "wv", "wo", "bq", "bk", "bv"):
        assert blk["attn"][leaf].dtype == torch.bfloat16
    for leaf in ("w_up", "w_gate", "w_down"):
        assert blk["mlp"][leaf].dtype == torch.bfloat16
    assert blk["norm1"].dtype == one_leaf["final_norm"].dtype == \
        torch.float32
    # the bf16-stored tree gives the same logits as the f32 one
    toks, lens = _prompts(setup["cfg"], [7, 2], S=8, seed=3)
    batch = {"tokens": torch.from_numpy(toks),
             "lengths": torch.from_numpy(lens)}
    tp = setup["tp"]
    c32, l32 = tm.prefill(tp, batch)
    c16, l16 = tm.prefill(tm.serving_params(tp), batch)
    assert torch.equal(l32, l16)
    t = torch.argmax(l32, -1).to(torch.int32)
    assert torch.equal(tm.decode_step(tp, c32, t)[1],
                       tm.decode_step(tm.serving_params(tp), c16, t)[1])


@pytest.mark.parametrize("n_slots", [8, 16, 24])
def test_cache_helpers_match_jax(n_slots):
    """``fill_cache_from_prefill`` (ring layout when n_slots < S) and
    ``update_cache`` (ring and linear) move the same values to the same
    slots as the JAX package's: exact."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn

    rng = np.random.default_rng(n_slots)
    B, S, K, hd = 3, 16, 2, 4
    k = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    lens = np.array([16, 9, 1], np.int32)
    pos = np.where(np.arange(S)[None, :] < lens[:, None],
                   np.arange(S)[None, :], -1).astype(np.int32)
    jout = jattn.fill_cache_from_prefill(jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(pos), n_slots)
    tout = tattn.fill_cache_from_prefill(torch.from_numpy(k),
                                         torch.from_numpy(v),
                                         torch.from_numpy(pos), n_slots)
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    kn = rng.standard_normal((B, K, hd)).astype(np.float32)
    for ring in (True, False):
        if not ring and n_slots <= int(lens.max()):
            continue                 # a linear cache needs room for lengths
        j = jattn.update_cache(*jout, jnp.asarray(kn), jnp.asarray(kn),
                               jnp.asarray(lens), n_slots=n_slots, ring=ring)
        t = tattn.update_cache(*tout, torch.from_numpy(kn),
                               torch.from_numpy(kn), torch.from_numpy(lens),
                               n_slots=n_slots, ring=ring)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert tout[2].dtype == torch.int32
