"""Port parity on reduced rwkv6: the port's config, recurrence, prefill
and decode against the JAX package, with the JAX model's own parameters
carried across by ``tree_from_numpy``.

The zero-initialised leaves (bonus, mu*, norm scales) are perturbed with
seeded noise before both sides get them, so the bonus term and the norm
scales are exercised.

Tolerance (logits, caches): both packages round activations to bf16 at
the same places (``tests`` below hold single layers bit-equal), but their
f32 sums (matmul, einsum, the chunk chain) run in other orders.  Where a
sum lands on a bf16 rounding boundary one side rounds up and the other
down: a one-ulp (2^-8 relative) flip that later layers carry forward.
So values are compared relative to the largest magnitude of the tensor:
REL = 4e-2.  Within the port, bucketed and batch-1 prefill run the same
code on the same values and are held to 2e-2, as in
tests/test_decode_hotpath.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.dist.sharding import Sharder
from repro.models import recurrence as jrec
from repro.models import rwkv as jrwkv
from repro.models.lm import build_model as j_build
from repro.testing import reduced_config as j_reduced
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import recurrence as trec
from repro_torch.models import rwkv as trwkv
from repro_torch.models.lm import build_model as t_build
from repro_torch.models.params import tree_from_numpy, tree_leaves, tree_map
from repro_torch.testing import reduced_config as t_reduced

NOSH = Sharder(None, {})
REL = 4e-2
ZERO_INIT = ("bonus", "mu", "mu_base", "mu_ck", "mu_cr", "ln1", "ln2",
             "wkv_norm")


def perturbed_params(params, seed=0, scale=0.3):
    """Numpy copy of JAX params with seeded noise on the zero-init leaves."""
    p = jax.tree.map(lambda a: np.array(a, np.float32), params)
    rng = np.random.default_rng(seed)
    for name in ZERO_INIT:
        a = p["blocks"]["p0"][name]
        p["blocks"]["p0"][name] = (a + rng.standard_normal(a.shape) * scale
                                   ).astype(np.float32)
    p["final_norm"] = (p["final_norm"] + rng.standard_normal(
        p["final_norm"].shape) * scale).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = j_reduced("rwkv6-1.6b"), t_reduced("rwkv6-1.6b")
    jm, tm = j_build(jcfg), t_build(tcfg)
    p = perturbed_params(jm.init(jax.random.PRNGKey(0)))
    jp = jax.tree.map(jnp.asarray, p)
    return dict(jm=jm, tm=tm, jp=jp, tp=tree_from_numpy(p, "cpu"),
                cfg=tcfg, jprefill=jax.jit(
                    lambda p, b: jm.prefill(p, b, NOSH, max_len=32)),
                jdecode=jax.jit(lambda p, c, t: jm.decode_step(p, c, t,
                                                               NOSH)))


def close(a, b, rel=REL):
    a = np.asarray(a, np.float32)
    b = b.float().numpy() if isinstance(b, torch.Tensor) else b
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = float(np.abs(a).max()) + 1e-9
    err = float(np.abs(a - b).max()) / scale
    assert err < rel, f"relative error {err:.3g} >= {rel}"
    return err


@pytest.mark.parametrize("arch,reduced", [("rwkv6-1.6b", False),
                                          ("rwkv6-1.6b", True)])
def test_config_matches_jax(arch, reduced):
    j = j_reduced(arch) if reduced else j_get_config(arch)
    t = t_reduced(arch) if reduced else t_get_config(arch)
    for f in dataclasses.fields(t):
        if f.name == "rwkv":
            assert dataclasses.asdict(t.rwkv) == dataclasses.asdict(j.rwkv)
        else:
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    for prop in ("padded_vocab", "n_periods", "head_dim_"):
        assert getattr(t, prop) == getattr(j, prop)
    if not reduced:
        assert (t.n_layers, t.d_model, t.d_ff, t.padded_vocab) == (
            24, 2048, 7168, 65536)


def test_param_and_cache_specs_match_jax(setup):
    jspecs = setup["jm"].param_specs()
    tspecs = setup["tm"].param_specs()
    j_shapes = jax.tree.map(lambda s: tuple(s.shape), jspecs,
                            is_leaf=lambda x: hasattr(x, "shape"))
    assert tree_map(lambda s: tuple(s.shape), tspecs) == j_shapes
    # ``_decay_init`` reads spec.shape[0], the layer count once stacked,
    # so both packages initialise decay_base as one scalar per layer
    t_init = setup["tm"].init(torch.Generator().manual_seed(0), device="cpu")
    assert tree_map(lambda a: tuple(a.shape), t_init) == tree_map(
        lambda a: tuple(a.shape), setup["tp"])
    assert tuple(t_init["blocks"]["p0"]["decay_base"].shape) == (2,)
    jc = setup["jm"].cache_specs(3, 32)
    tc = setup["tm"].cache_specs(3, 32)
    assert tree_map(lambda s: (tuple(s.shape), str(s.dtype).split(".")[-1]),
                    tc) == jax.tree.map(
        lambda s: (tuple(s.shape), str(np.dtype(s.dtype))), jc,
        is_leaf=lambda x: hasattr(x, "shape"))
    assert setup["tm"].n_params() == setup["jm"].n_params()


def test_tree_init_distributions(setup):
    """The port draws its own numbers, with the JAX package's laws."""
    tm = setup["tm"]
    p = tm.init(torch.Generator().manual_seed(3), device="cpu")
    b = p["blocks"]["p0"]
    for name in ZERO_INIT:
        assert not b[name].any()
    np.testing.assert_array_equal(
        b["decay_base"].numpy(),
        np.asarray(setup["jm"].init(jax.random.PRNGKey(0))
                   ["blocks"]["p0"]["decay_base"]))
    d = tm.cfg.d_model
    assert float(b["wr"].abs().max()) <= 3.0 / d ** 0.5 + 1e-6
    assert float(b["lora_b"].abs().max()) <= 3e-2 + 1e-6
    assert float(p["embedding"].abs().max()) <= 3.0 + 1e-6
    assert 0.7 < float(p["embedding"].std()) * 1.0 < 1.0
    assert all(t.dtype == torch.float32 for t in tree_leaves(p))


def test_chunked_linear_attention_matches_jax():
    rng = np.random.default_rng(2)
    B, H, T, K = 2, 3, 13, 8
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = mk(B, H, T, K), mk(B, H, T, K), mk(B, H, T, K)
    w = -np.exp(rng.uniform(-8.0, 3.0, (B, H, T, K))).astype(np.float32)
    u, s0 = mk(H, K), mk(B, H, K, K)
    kw = dict(chunk=4, convention="exclusive")
    yj, sj = jrec.chunked_linear_attention(
        *[jnp.asarray(a) for a in (q, k, v, w)], u=jnp.asarray(u),
        initial_state=jnp.asarray(s0), **kw)
    yt, st = trec.chunked_linear_attention(
        *[torch.from_numpy(a) for a in (q, k, v, w)], u=torch.from_numpy(u),
        initial_state=torch.from_numpy(s0), **kw)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-3,
                               rtol=1e-3)


@pytest.mark.parametrize("convention", ["exclusive", "inclusive"])
def test_linear_attention_step_matches_jax(convention):
    rng = np.random.default_rng(4)
    B, H, K = 3, 2, 16
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    s0, q, k, v = mk(B, H, K, K), mk(B, H, K), mk(B, H, K), mk(B, H, K)
    w = -np.exp(rng.uniform(-8.0, 3.0, (B, H, K))).astype(np.float32)
    u = mk(H, K) if convention == "exclusive" else None
    yj, sj = jrec.linear_attention_step(
        *[jnp.asarray(a) for a in (s0, q, k, v, w)], convention=convention,
        u=None if u is None else jnp.asarray(u))
    yt, st = trec.linear_attention_step(
        *[torch.from_numpy(a) for a in (s0, q, k, v, w)],
        convention=convention, u=None if u is None else torch.from_numpy(u))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6,
                               rtol=1e-6)
    # the planned step with no plan is the plain step on the CPU
    yp, sp = trec.linear_attention_step_planned(
        *[torch.from_numpy(a) for a in (s0, q, k, v, w)],
        u=torch.from_numpy(mk(H, K)))
    assert yp.dtype == sp.dtype == torch.float32


def test_one_block_is_bit_equal_to_jax(setup):
    """Time mix and channel mix of one layer, same bf16 input: the port
    rounds at the same places as XLA, so every bf16 output is equal."""
    cfg = setup["cfg"]
    jb = jax.tree.map(lambda a: a[0], setup["jp"]["blocks"]["p0"])
    tb = tree_map(lambda a: a[0], setup["tp"]["blocks"]["p0"])
    x = np.random.default_rng(6).standard_normal((2, 9, cfg.d_model))
    jx = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    tx = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    jcfg = setup["jm"].cfg
    jo = jrwkv.channel_mix(jb, jx, jcfg, NOSH)
    to = trwkv.channel_mix(tb, tx, cfg)
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())
    jo = jrwkv.time_mix(jb, jx, jcfg, NOSH)
    to = trwkv.time_mix(tb, tx, cfg)
    close(jo[0], to[0], rel=1e-2)        # one wkv sum order apart
    np.testing.assert_array_equal(np.asarray(jo[1], np.float32),
                                  to[1].float().numpy())
    np.testing.assert_allclose(to[2].numpy(), np.asarray(jo[2]), atol=1e-5,
                               rtol=1e-5)


def _prompts(cfg, lens, S, seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), S), np.int32)
    for i, L in enumerate(lens):
        toks[i, :L] = rng.integers(0, cfg.vocab_size, L)
    return toks, np.asarray(lens, np.int32)


def _compare_cache(jc, tc):
    close(jc["blocks"]["p0"]["wkv_state"], tc["blocks"]["p0"]["wkv_state"])
    for name in ("tm_shift", "cm_shift"):
        close(jc["blocks"]["p0"][name], tc["blocks"]["p0"][name])
    np.testing.assert_array_equal(np.asarray(jc["lengths"]),
                                  tc["lengths"].numpy())
    assert tc["blocks"]["p0"]["tm_shift"].dtype == torch.bfloat16
    assert tc["blocks"]["p0"]["wkv_state"].dtype == torch.float32


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
    _compare_cache(jc, tc)


def test_decode_steps_match_jax(setup):
    """k decode steps from the same prefill, fed the same tokens."""
    toks, lens = _prompts(setup["cfg"], [9, 4], S=16, seed=1)
    jc, jl = setup["jprefill"](setup["jp"], {"tokens": jnp.asarray(toks),
                                             "lengths": jnp.asarray(lens)})
    tc, tl = setup["tm"].prefill(setup["tp"],
                                 {"tokens": torch.from_numpy(toks),
                                  "lengths": torch.from_numpy(lens)})
    t = np.asarray(jnp.argmax(jl, -1), np.int32)
    for _ in range(4):
        jc, jl = setup["jdecode"](setup["jp"], jc, jnp.asarray(t))
        tc, tl = setup["tm"].decode_step(setup["tp"], tc,
                                         torch.from_numpy(t.copy()))
        close(jl, tl)
        _compare_cache(jc, tc)
        t = np.asarray(jnp.argmax(jl, -1), np.int32)


def test_bucketed_prefill_equals_batch1(setup):
    """One right-padded batched prefill == per-prompt exact-length
    prefills, and the next decode step from the copied rows, as
    tests/test_decode_hotpath.py holds the JAX package."""
    tm, tp = setup["tm"], setup["tp"]
    toks, lens = _prompts(setup["cfg"], [3, 5, 9], S=16, seed=2)
    cB, lB = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                             "lengths": torch.from_numpy(lens)})
    for i, L in enumerate(lens):
        c1, l1 = tm.prefill(tp, {"tokens": torch.from_numpy(toks[i:i + 1,
                                                                 :L])})
        assert int(cB["lengths"][i]) == L
        scale = float(l1.abs().max())
        assert float((lB[i] - l1[0]).abs().max()) / scale < 2e-2
        row = {"blocks": tree_map(lambda a: a[:, i:i + 1], cB["blocks"]),
               "lengths": cB["lengths"][i:i + 1]}
        t = torch.argmax(l1, dim=-1).to(torch.int32)
        _, dB = tm.decode_step(tp, row, t)
        _, d1 = tm.decode_step(tp, c1, t)
        assert float((dB - d1).abs().max()) / scale < 2e-2


def test_bf16_stored_weights_give_the_same_logits(setup):
    """``serving_params`` stores the dot-only leaves in bf16; the matmuls
    see the same bf16 values, so prefill and decode are bit-equal."""
    tm, tp = setup["tm"], setup["tp"]
    sp = tm.serving_params(tp)
    assert sp["embedding"].dtype == sp["blocks"]["p0"]["wr"].dtype \
        == torch.bfloat16
    for name in ("decay_b", "lora_b", "bonus", "ln1", "mu", "decay_base"):
        assert sp["blocks"]["p0"][name].dtype == torch.float32
    assert sp["final_norm"].dtype == torch.float32
    toks, lens = _prompts(setup["cfg"], [7, 2], S=8, seed=3)
    batch = {"tokens": torch.from_numpy(toks),
             "lengths": torch.from_numpy(lens)}
    c32, l32 = tm.prefill(tp, batch)
    c16, l16 = tm.prefill(sp, batch)
    assert torch.equal(l32, l16)
    t = torch.argmax(l32, -1).to(torch.int32)
    assert torch.equal(tm.decode_step(tp, c32, t)[1],
                       tm.decode_step(sp, c16, t)[1])
