"""Port parity of int8 weight serving: the port's ``quantize_tree`` and
``serving_specs`` against the JAX package's, and the port's LM and engine
on an int8 tree against the JAX LM and a live JAX engine on
``quantize_tree(params)``.

The reduced configurations are 64 wide, where only ``lm_head`` is
eligible (``shape[-1] >= 256``), so both packages' configs are widened
through ``reduced_config(..., **overrides)``: qwen2.5-14b to d_model 256,
8 query / 4 KV heads of 64, d_ff 512 (all seven projections and the head
come out int8); rwkv6-1.6b to d_model 128, d_ff 512 (``wk_c`` and the
head).  rwkv stays under 256 wide for the JAX comparison because the JAX
package's ``_time_mix_inputs`` reads ``decay_b.astype(F32)``, which fails
on the int8 dict that d_model >= 256 makes of it; the port dequantizes
it in f32 (tested here on its own).  Each test asserts which leaves came
out int8, so none passes vacuously.

On the CPU a missing ``"matmul_int8"`` plan entry is "auto": the plain
path, ``wcast`` + ``torch.matmul``, the JAX package's own arithmetic.  So
the LM and engine are held as the bf16 LM is
(tests/test_torch_dense_lm.py, tests/test_torch_rwkv_lm.py): logits and
caches within REL = 4e-2 of the largest magnitude (one-ulp bf16 flips
that later layers carry), integer fields and greedy tokens exactly
(tokens up to a JAX top-2 tie inside that tolerance, as
tests/test_torch_engine.py).  Codes and scales of ``quantize_tree`` are
bit-equal to eager JAX's.  int8 against bf16 logits: 0.15 relative, the
bound of tests/test_int8_serving.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import quantize_tree as j_quantize_tree
from repro.core.quant import serving_specs as j_serving_specs
from repro.dist.sharding import Sharder
from repro.models.lm import build_model as j_build
from repro.serving import ServingEngine as JEngine
from repro.testing import reduced_config as j_reduced
from repro_torch.core import quant as tquant
from repro_torch.kernels.matmul_int8 import matmul_int8 as tmm
from repro_torch.models import layers as tlayers
from repro_torch.models.lm import build_model as t_build
from repro_torch.models.params import tree_from_numpy, tree_map
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.testing import reduced_config as t_reduced
from test_torch_dense_lm import perturbed_params as dense_perturbed
from test_torch_engine import _jax_margin, _prompts as engine_prompts
from test_torch_engine import _serve
from test_torch_rwkv_lm import perturbed_params as rwkv_perturbed

NOSH = Sharder(None, {})
REL = 4e-2
INT8_VS_BF16 = 0.15
WIDE = {"qwen2.5-14b": dict(d_model=256, n_heads=8, n_kv_heads=4,
                            head_dim=64, d_ff=512),
        "rwkv6-1.6b": dict(d_model=128, d_ff=512)}
INT8_LEAVES = {
    "qwen2.5-14b": {"lm_head", "blocks/p0/attn/wq", "blocks/p0/attn/wk",
                    "blocks/p0/attn/wv", "blocks/p0/attn/wo",
                    "blocks/p0/mlp/w_up", "blocks/p0/mlp/w_gate",
                    "blocks/p0/mlp/w_down"},
    "rwkv6-1.6b": {"lm_head", "blocks/p0/wk_c"},
}
ARCHS = tuple(WIDE)


def int8_leaves(tree, path=()):
    """Paths of the {q, scale} leaves of a served tree."""
    out = set()
    for k, v in tree.items():
        if isinstance(v, dict) and set(v) == {"q", "scale"}:
            out.add("/".join(path + (k,)))
        elif isinstance(v, dict):
            out |= int8_leaves(v, path + (k,))
    return out


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jm = j_build(j_reduced(arch, **WIDE[arch]))
    tm = t_build(t_reduced(arch, **WIDE[arch]))
    perturb = dense_perturbed if arch == "qwen2.5-14b" else rwkv_perturbed
    p = perturb(jm.init(jax.random.PRNGKey(2)), seed=2)
    jq = j_quantize_tree(jax.tree.map(jnp.asarray, p))
    tq = tquant.quantize_tree(tree_from_numpy(p, "cpu"))
    return dict(jm=jm, tm=tm, p=p, jq=jq, tq=tq,
                jprefill=jax.jit(lambda p, b: jm.prefill(p, b, NOSH,
                                                         max_len=32)),
                jdecode=jax.jit(lambda p, c, t: jm.decode_step(p, c, t,
                                                               NOSH)))


def close(a, b, rel=REL):
    a = np.asarray(a, np.float32)
    b = b.float().numpy() if isinstance(b, torch.Tensor) else b
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.isfinite(b).all()
    err = float(np.abs(a - b).max()) / (float(np.abs(a).max()) + 1e-9)
    assert err < rel, f"relative error {err:.3g} >= {rel}"
    return err


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, path + (key,)).items()}
    return {"/".join(path): tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_tree_codes_and_scales_exact(arch):
    """Same leaves, same dtypes, int8 codes and f32 scales bit-equal to
    eager JAX, the bf16 casts of the other leaves too."""
    s = _setup(arch)
    assert int8_leaves(s["tq"]) == INT8_LEAVES[arch]
    jf = _flat(jax.tree.map(np.asarray, s["jq"]))
    tf = _flat(s["tq"])
    assert set(jf) == set(tf)
    for name, a in jf.items():
        t = tf[name]
        assert str(a.dtype) == str(t.dtype).split(".")[-1], name
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                a.view(np.int16), t.view(torch.int16).numpy(), err_msg=name)
        else:
            np.testing.assert_array_equal(a, t.numpy(), err_msg=name)
    # ineligible float leaves are bf16 (norm scales, and rwkv's mu*,
    # decay_base and bonus), unlike LM.serving_params, which keeps them f32
    blk = s["tq"]["blocks"]["p0"]
    names = (("ln1", "mu", "decay_base", "bonus") if arch == "rwkv6-1.6b"
             else ("norm1", "norm2"))
    assert all(blk[n].dtype == torch.bfloat16 for n in names)
    assert s["tq"]["embedding"].dtype == torch.bfloat16


def test_quantize_tree_layerwise_and_consume():
    """A stacked leaf is quantized one layer at a time: bit-equal to the
    whole-stack call.  ``consume=True`` empties the input tree as it goes
    and gives the same result."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((3, 96, 256)).astype(
        np.float32)).to(torch.bfloat16)
    q, sc = tquant.quantize_int8(w, axis=-2)
    leaf = tquant.quantize_tree({"w": w})["w"]
    assert torch.equal(leaf["q"], q) and torch.equal(leaf["scale"], sc)
    assert leaf["scale"].shape == (3, 1, 256)
    tree = {"a": {"w": w.clone(), "norm": torch.ones(3, 256)},
            "embedding": w.clone(), "n": torch.arange(3)}
    kept = tquant.quantize_tree(tree)
    eaten = tquant.quantize_tree(tree, consume=True)
    assert tree == {}
    for k, v in _flat(kept).items():
        assert torch.equal(_flat(eaten)[k], v), k
    assert int8_leaves(eaten) == {"a/w"}
    assert eaten["n"].dtype == torch.int64
    assert eaten["embedding"].dtype == torch.bfloat16


def test_should_quantize_rule_matches_jax():
    from repro.core.quant import should_quantize as j_should
    cases = [("['blocks']['w']", (64, 256)), ("['blocks']['w']", (63, 256)),
             ("['blocks']['w']", (64, 255)), ("['x']['embedding']", (512, 512)),
             ("['lm_head']", (4, 64, 4096)), ("['b']", (4096,)),
             ("['blocks']['norm']", (48, 5120)), ("['a']", (100, 100, 300))]
    for path, shape in cases:
        for jd, td in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16),
                       (jnp.int8, torch.int8)):
            assert tquant.should_quantize(path, shape, td) == \
                j_should(path, shape, jd), (path, shape, td)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_specs_structure_matches_jax(arch, int8):
    s = _setup(arch)
    jspec = j_serving_specs(s["jm"].param_specs(), int8=int8)
    tspec = tquant.serving_specs(s["tm"].param_specs(), int8=int8)
    jf = _flat(jax.tree.map(lambda x: (tuple(x.shape),
                                       str(np.dtype(x.dtype)), x.init),
                            jspec, is_leaf=lambda x: hasattr(x, "shape")))
    tf = _flat(tree_map(lambda x: (tuple(x.shape),
                                   str(x.dtype).split(".")[-1], x.init),
                        tspec))
    assert tf == jf
    leaves = {k.rsplit("/", 1)[0] for k in tf if k.endswith("/q")}
    assert leaves == (INT8_LEAVES[arch] if int8 else set())
    # the served tree of quantize_tree has the layout serving_specs names
    served = _flat(tree_map(lambda x: (tuple(x.shape),
                                       str(x.dtype).split(".")[-1]),
                            s["tq"]))
    if int8:
        # decay_base is built (n_layers,) by the reference's _decay_init
        # (ROADMAP Queue 3), not at its spec's shape: skip its shape
        want = {k: v[:2] for k, v in tf.items()}
        for k in [k for k in want if k.endswith("decay_base")]:
            assert served.pop(k)[1] == want.pop(k)[1]
        assert served == want


def _tokens(cfg, lens, S, seed):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), S), np.int32)
    for i, L in enumerate(lens):
        toks[i, :L] = rng.integers(0, cfg.vocab_size, L)
    return toks, np.asarray(lens, np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_lm_prefill_and_decode_match_jax(arch):
    """A bucketed prefill and three decode steps of the port's LM on its
    int8 tree against the jitted JAX LM on ``quantize_tree(params)``."""
    s = _setup(arch)
    toks, lens = _tokens(s["tm"].cfg, [11, 6, 1], S=16, seed=3)
    batch = {"tokens": toks, "lengths": lens}
    jc, jl = s["jprefill"](s["jq"], jax.tree.map(jnp.asarray, batch))
    tc, tl = s["tm"].prefill(s["tq"], tree_map(torch.from_numpy, batch),
                             max_len=32)
    close(jl, tl)
    t = np.asarray(jnp.argmax(jl, -1), np.int32)
    for _ in range(3):
        jc, jl = s["jdecode"](s["jq"], jc, jnp.asarray(t))
        tc, tl = s["tm"].decode_step(s["tq"], tc, torch.from_numpy(t.copy()))
        close(jl, tl)
        np.testing.assert_array_equal(np.asarray(jc["lengths"]),
                                      tc["lengths"].numpy())
        t = np.asarray(jnp.argmax(jl, -1), np.int32)
    jb, tb = jc["blocks"]["p0"], tc["blocks"]["p0"]
    for name in (("k", "v") if arch == "qwen2.5-14b"
                 else ("wkv_state", "tm_shift", "cm_shift")):
        close(jb[name], tb[name])
    if arch == "qwen2.5-14b":
        np.testing.assert_array_equal(np.asarray(jb["pos"]),
                                      tb["pos"].numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_engine_matches_live_jax_engine(arch):
    """The port's engine on the int8 tree against a live JAX engine on
    ``quantize_tree(params)``, synchronous admission as in
    tests/test_torch_engine.py: tick stamps, counters and utilization
    exactly; greedy tokens exactly up to a JAX top-2 tie inside REL."""
    s = _setup(arch)
    prompts = engine_prompts(s["tm"].cfg.vocab_size, seed=4)
    jeng = JEngine(s["jm"], s["jq"], NOSH, max_batch=4, max_len=32,
                   overlap_prefill=False)
    teng = TEngine(s["tm"], s["tq"], max_batch=4, max_len=32)
    jreqs, treqs = _serve(jeng, prompts), _serve(teng, prompts)
    stamps = lambda r: (r.uid, r.t_submit, r.t_admit, r.t_first, r.t_done,
                        len(r.output), r.done)
    assert [stamps(r) for r in treqs] == [stamps(r) for r in jreqs]
    js, ts = jeng.stats(), teng.stats()
    keys = ["completed", "total_tokens", "prefill_calls", "ticks",
            "mean_util", "host_syncs"]
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
    assert teng.util_history == jeng.util_history
    for (prompt, _), jr, tr in zip(prompts, jreqs, treqs):
        diff = [i for i, (a, b) in enumerate(zip(jr.output, tr.output))
                if a != b]
        if diff:
            margin, scale = _jax_margin(s["jm"], s["jq"], prompt,
                                        jr.output[:diff[0]])
            assert margin < REL * scale, (jr.uid, diff[0], margin)


@pytest.mark.parametrize("arch", ARCHS + ("rwkv6-1.6b-d256",))
def test_int8_logits_close_to_bf16(arch):
    """The int8 tree's prefill and next-step logits stay within 0.15 of
    the f32 tree's, the bound tests/test_int8_serving.py holds the JAX
    package to.  "rwkv6-1.6b-d256" is rwkv at d_model 256, where decay_b
    is int8 too (the port dequantizes it in f32; the JAX package's rwkv
    cannot run that tree)."""
    if arch == "rwkv6-1.6b-d256":
        tm = t_build(t_reduced("rwkv6-1.6b", d_model=256, d_ff=512))
        p = tm.init(torch.Generator().manual_seed(3), "cpu")
        q = tquant.quantize_tree(p)
        assert "blocks/p0/decay_b" in int8_leaves(q)
    else:
        s = _setup(arch)
        tm, q = s["tm"], s["tq"]
        p = tree_from_numpy(s["p"], "cpu")
    toks, _ = _tokens(tm.cfg, [8, 8], S=8, seed=6)
    batch = {"tokens": torch.from_numpy(toks)}
    cache, logits = tm.prefill(p, batch, max_len=12)
    qcache, qlogits = tm.prefill(q, batch, max_len=12)
    nxt = logits.argmax(-1).to(torch.int32)
    _, logits2 = tm.decode_step(p, cache, nxt)
    _, qlogits2 = tm.decode_step(q, qcache, nxt)
    for a, b in ((logits, qlogits), (logits2, qlogits2)):
        close(a.numpy(), b, rel=INT8_VS_BF16)


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_route_on_the_cpu_runs_the_plain_version(arch, monkeypatch):
    """``{"matmul_int8": {"impl": "kernel"}}`` sends every int8 leaf of a
    block through ``ops.qdot``; on CPU tensors the wrapper runs the plain
    version (scale after the exact int8 sums) and launches nothing.  It
    agrees with the JAX-exact dequantize-then-multiply path within REL.
    ``{"impl": "plain"}`` is the auto path on the CPU, bit for bit."""
    s = _setup(arch)
    toks, lens = _tokens(s["tm"].cfg, [9, 5], S=16, seed=7)
    batch = {"tokens": torch.from_numpy(toks),
             "lengths": torch.from_numpy(lens)}
    before = dict(tmm.LAUNCHES)
    calls = []
    orig = tlayers.resolve_impl
    kern = s["tm"].with_tile_plans({"matmul_int8": {"impl": "kernel"}})
    with monkeypatch.context() as m:
        m.setattr(tlayers, "resolve_impl",
                  lambda e, d: calls.append(e) or orig(e, d))
        kc, kl = kern.prefill(s["tq"], batch, max_len=32)
    # one routing decision per int8 leaf of a block, for each layer
    n_block = len(INT8_LEAVES[arch]) - 1
    assert calls == [{"impl": "kernel"}] * (n_block * s["tm"].cfg.n_layers)
    pc, pl = s["tm"].prefill(s["tq"], batch, max_len=32)
    close(pl.numpy(), kl)
    plain = s["tm"].with_tile_plans({"matmul_int8": {"impl": "plain"}})
    assert torch.equal(plain.prefill(s["tq"], batch, max_len=32)[1], pl)
    t = pl.argmax(-1).to(torch.int32)
    close(s["tm"].decode_step(s["tq"], pc, t)[1].numpy(),
          kern.decode_step(s["tq"], kc, t)[1])
    assert tmm.LAUNCHES == before


def test_kernel_route_takes_bf16_activations_only():
    leaf = tquant.quantize_tree({"w": torch.randn(64, 256)})["w"]
    x = torch.randn(2, 64)
    plan = {"impl": "kernel"}
    with pytest.raises(ValueError, match="bf16"):
        tlayers.dot(x, leaf, plan)
    out = tlayers.dot(x.to(torch.bfloat16), leaf, plan)
    assert out.shape == (2, 256) and out.dtype == torch.bfloat16
    # the plain route takes any dtype, as the JAX package's dot does
    assert tlayers.dot(x, leaf).dtype == torch.float32


def test_serving_params_leaves_int8_leaves_alone():
    s = _setup("qwen2.5-14b")
    again = s["tm"].serving_params(s["tq"])
    for k, v in _flat(s["tq"]).items():
        assert _flat(again)[k] is v or torch.equal(_flat(again)[k], v), k
        assert _flat(again)[k].dtype == v.dtype, k


def test_serve_cli_int8_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "qwen2.5-14b", "--reduced", "--requests", "3",
                "--max-new", "3", "--device", "cpu", "--int8"])
    out = capsys.readouterr().out
    assert "served 3 requests, 9 tokens" in out
    assert "engine stats:" in out
