"""Port parity of the MoE MLP and the two MoE archs (qwen3-moe-30b-a3b,
granite-moe-1b-a400m) against the JAX package, on reduced configs (8
experts, top 2, capacity factor 1.5, token groups of 16, d_ff 32), with
the JAX model's own parameters carried across by ``tree_from_numpy``.
The zero-initialised leaves (norm scales, qk-norm scales) get seeded
noise first, so they do real work.

Tolerances:

* routing is exact: top-k experts (ties to the lower index, as
  ``jax.lax.top_k``), and which (token, expert) pairs are kept and which
  dropped past capacity, against a numpy replay of the capacity rule on
  JAX's own ``lax.top_k``; a token whose every expert was dropped has a
  zero output on both sides;
* ``moe_mlp``'s y: both sides round to bf16 at the same places (dispatch,
  h, out_e, combine, y) but sum in f32 in other orders, so a value on a
  bf16 rounding boundary can flip one ulp (2^-8 relative) and carry to
  y: held within Y_REL = 2e-2 of the largest |y|; the aux loss (f32 all
  the way) within AUX_REL = 1e-5 relative;
* LM logits and k/v caches: REL = 4e-2 of the largest magnitude, as for
  rwkv6 and qwen2.5-14b (tests/test_torch_dense_lm.py);
* the served cell: tick stamps, counters and the aggregate exact (no
  request has an ``eos_id``, so the schedule does not depend on the
  tokens); greedy tokens exact, except where JAX's own logits for the
  first differing token (recorded inside its engine) sit within REL of a
  tie: the top-2 margin under REL times the largest logit.  In an MoE
  model the rows of a group share expert capacity, so once one token
  differs every later tick may; no token after that tick is compared.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SERVING_LOAD_SWEEP as J_SWEEP
from repro.dist.sharding import Sharder
from repro.models import moe as jmoe
from repro.models.lm import LM as JLM
from repro.serving import ServingEngine as JEngine
from repro.serving import metrics as jmet
from repro.serving import workload as jwl
from repro.testing import reduced_config as j_reduced
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import SERVING_LOAD_SWEEP as T_SWEEP
from repro_torch.configs import serving_cell
from repro_torch.core.quant import quantize_int8
from repro_torch.models import moe as tmoe
from repro_torch.models.lm import build_model as t_build
from repro_torch.models.lm import build_served
from repro_torch.models.params import tree_from_numpy, tree_leaves, tree_map
from repro_torch.serving import metrics as tmet
from repro_torch.serving import workload as twl
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.testing import reduced_config as t_reduced

MOE_ARCHS = ("qwen3-moe-30b-a3b", "granite-moe-1b-a400m")
Y_REL = 2e-2
AUX_REL = 1e-5
REL = 4e-2
MAX_LEN = 32
CELL = "qwen3-moe-30b-a3b/b4/r1"


class _RecLM(JLM):
    """The JAX LM, recording on the host every prefill's and decode
    step's inputs and logits (``jax.debug.callback``, inside the engine's
    jitted programs): where a served token differs, its JAX logits."""

    def __init__(self, cfg, log):
        super().__init__(cfg)
        self._log = log

    def prefill(self, params, batch, sharder, max_len=0):
        cache, logits = super().prefill(params, batch, sharder,
                                        max_len=max_len)
        jax.debug.callback(
            lambda t, n, g: self._log.append(
                ("p", np.asarray(t), np.asarray(n), np.asarray(g))),
            batch["tokens"], batch["lengths"], logits)
        return cache, logits

    def decode_step(self, params, cache, tokens, sharder):
        new, logits = super().decode_step(params, cache, tokens, sharder)
        jax.debug.callback(
            lambda t, n, g: self._log.append(
                ("d", np.asarray(t), np.asarray(n), np.asarray(g))),
            tokens, cache["lengths"], logits)
        return new, logits


def _perturbed(params, seed):
    """Numpy copy of JAX params with seeded noise on the zero-init leaves
    (block norms, qk norms, the final norm)."""
    p = jax.tree.map(lambda a: np.array(a, np.float32), params)
    rng = np.random.default_rng(seed)
    noise = lambda a: (a + rng.standard_normal(a.shape) * 0.3).astype(
        np.float32)
    blk = p["blocks"]["p0"]
    for name in ("norm1", "norm2"):
        blk[name] = noise(blk[name])
    for name in ("q_norm", "k_norm"):
        if name in blk["attn"]:
            blk["attn"][name] = noise(blk["attn"][name])
    p["final_norm"] = noise(p["final_norm"])
    return p


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(JAX recording LM, its params, its log, port LM, port params): one
    JAX build an arch, shared by the module."""
    log = []
    jm = _RecLM(j_reduced(arch), log)
    p = _perturbed(jm.init(jax.random.PRNGKey(3)), seed=3)
    return (jm, jax.tree.map(jnp.asarray, p), log, t_build(t_reduced(arch)),
            tree_from_numpy(p, "cpu"))


def _close(a, b, rel):
    a = np.asarray(a, np.float32)
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = float(np.abs(a).max()) + 1e-9
    err = float(np.abs(a - b).max()) / scale
    assert err < rel, f"relative error {err:.3g} >= {rel}"
    return err


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", sorted(T_ARCHS))
def test_configs_and_param_counts_match_jax(arch, reduced):
    j = j_reduced(arch) if reduced else J_ARCHS[arch]
    t = t_reduced(arch) if reduced else T_ARCHS[arch]
    for f in dataclasses.fields(t):
        got, want = getattr(t, f.name), getattr(j, f.name)
        if f.name == "moe" and want is not None:
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        elif f.name in ("rwkv", "ssm") and want is not None:
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f.name
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    if arch == "qwen3-moe-30b-a3b" and not reduced:
        assert t.param_count() == 30_532_634_624


def test_serving_sweep_equals_jax_and_every_cell_builds():
    assert [c.name for c in T_SWEEP] == [c.name for c in J_SWEEP]
    assert len(T_SWEEP) == 21
    built = {}
    for cell in T_SWEEP:
        plan = dataclasses.replace(cell.plan, reduced=True)
        if plan.arch not in built:
            built[plan.arch] = build_served(plan.arch, True, "cpu")
        model, params = built[plan.arch]
        eng = TEngine.from_plan(plan, params)
        assert eng.model.cfg == model.cfg and eng.plan == plan
        assert eng.max_batch == cell.max_batch


def test_int8_moe_tree_is_refused():
    with pytest.raises(ValueError, match="int8 expert path"):
        build_served("granite-moe-1b-a400m", True, "cpu", int8=True)
    # an expert leaf quantized by hand reaches moe_mlp, which refuses it
    model, params = build_served("granite-moe-1b-a400m", True, "cpu")
    moe = params["blocks"]["p0"]["moe"]
    q, scale = quantize_int8(moe["w_up"], axis=-2)
    moe["w_up"] = {"q": q, "scale": scale}
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="int8 expert path"):
        model.prefill(params, {"tokens": toks})


def test_jax_moe_leaves_carry_across_unchanged():
    jm, _, _, tm, tp = _models("qwen3-moe-30b-a3b")
    p = jm.init(jax.random.PRNGKey(5))
    jmoe_p = p["blocks"]["p0"]["moe"]
    tmoe_p = tree_from_numpy(jax.tree.map(np.asarray, p), "cpu")[
        "blocks"]["p0"]["moe"]
    m, cfg = tm.cfg.moe, tm.cfg
    L = cfg.n_layers
    shapes = {"router": (L, cfg.d_model, m.n_experts),
              "w_up": (L, m.n_experts, cfg.d_model, cfg.d_ff),
              "w_gate": (L, m.n_experts, cfg.d_model, cfg.d_ff),
              "w_down": (L, m.n_experts, cfg.d_ff, cfg.d_model)}
    assert set(tmoe_p) == set(jmoe_p) == set(shapes)
    for name, shape in shapes.items():
        assert tuple(tmoe_p[name].shape) == shape
        assert tmoe_p[name].dtype == torch.float32
        assert np.array_equal(tmoe_p[name].numpy(), np.asarray(jmoe_p[name]))
    spec = tm.param_specs()["blocks"]["p0"]["moe"]
    assert tree_map(lambda s: tuple(s.shape), spec) == shapes
    # served: the experts in bf16, the router in f32
    served = tm.serving_params(tp)["blocks"]["p0"]["moe"]
    assert {k: v.dtype for k, v in served.items()} == {
        "router": torch.float32, "w_up": torch.bfloat16,
        "w_gate": torch.bfloat16, "w_down": torch.bfloat16}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_serving_equals_serving_params_of_init(arch):
    """The MoE leaves are drawn a layer slice at a time by both forms."""
    tm = t_build(t_reduced(arch))
    a = tm.init_serving(torch.Generator().manual_seed(4), "cpu")
    b = tm.serving_params(tm.init(torch.Generator().manual_seed(4), "cpu"))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    assert tree_map(lambda t: t.dtype, a) == tree_map(lambda t: t.dtype, b)


# ---------------------------------------------------------------------------
# the MoE MLP
# ---------------------------------------------------------------------------


def _capacity_oracle(top_idx, E, C):
    """JAX's capacity rule replayed in numpy over JAX's ``lax.top_k``
    picks: slot j of every token in order, each assignment counted, kept
    while its position is under C.  Returns kept[g, s, e] (bool)."""
    G, gs, K = top_idx.shape
    kept = np.zeros((G, gs, E), bool)
    for g in range(G):
        count = np.zeros(E, int)
        for j in range(K):
            for s in range(gs):
                e = int(top_idx[g, s, j])
                kept[g, s, e] = count[e] < C
                count[e] += 1
    return kept


def _x(B, S, d, seed, zero_row=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    if zero_row is not None:
        x[zero_row] = 0.0
    return x


@pytest.mark.parametrize("router", ["random", "forced"])
@pytest.mark.parametrize("B,S", [(2, 16), (2, 1), (4, 1)])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_mlp_matches_jax(arch, B, S, router, nosharder):
    """y and aux against JAX ``moe_mlp``; with the router zeroed every
    token ties on every expert and goes to experts 0..K-1, far past their
    capacity, so most assignments are dropped."""
    jm, _, _, tm, _ = _models(arch)
    jcfg, tcfg = jm.cfg, tm.cfg
    p = jax.tree.map(lambda a: np.asarray(a[0], np.float32),
                     jm.init(jax.random.PRNGKey(7))["blocks"]["p0"]["moe"])
    if router == "forced":
        p["router"] = np.zeros_like(p["router"])
    x = _x(B, S, tcfg.d_model, seed=11 + B * S)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    yj, auxj = jmoe.moe_mlp(jax.tree.map(jnp.asarray, p), xj, jcfg, nosharder)
    yt, auxt = tmoe.moe_mlp(tree_from_numpy(p, "cpu"), xt, tcfg)
    assert yt.dtype == torch.bfloat16 and tuple(yt.shape) == (B, S,
                                                              tcfg.d_model)
    _close(yj, yt, Y_REL)
    _close(auxj, auxt, AUX_REL)
    # routing: the port's kept pairs are the capacity rule on JAX's top_k
    m = tcfg.moe
    gs = tmoe._group_size(tcfg, B * S)
    assert gs == jmoe._group_size(jcfg, B * S, nosharder)
    C = max(1, int(np.ceil(gs * m.top_k * m.capacity_factor / m.n_experts)))
    logits = jnp.asarray(x.reshape(-1, gs, tcfg.d_model), jnp.bfloat16
                         ).astype(jnp.float32) @ jnp.asarray(p["router"])
    _, jidx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), m.top_k)
    want = _capacity_oracle(np.asarray(jidx), m.n_experts, C)
    got = tmoe._route(tree_from_numpy(p, "cpu"), xt, tcfg)
    assert np.array_equal(got["top_idx"].numpy(), np.asarray(jidx))
    assert np.array_equal(got["dispatch"].ne(0).any(-1).numpy(), want)
    dropped = ~want.any(-1).reshape(B, S)
    yj_np = np.asarray(yj.astype(jnp.float32))
    assert np.array_equal(np.all(yj_np == 0, -1), dropped)
    assert np.array_equal(np.all(yt.float().numpy() == 0, -1), dropped)
    if router == "forced":
        assert dropped.sum() > 0 or B * S * m.top_k <= 2 * C
        assert np.all(np.asarray(jidx)[..., 0] == 0)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_tie_row_keeps_the_lower_index_experts(arch, nosharder):
    """A zero input row has equal logits on every expert: both packages
    pick experts 0..K-1, in order."""
    jm, _, _, tm, _ = _models(arch)
    p = jax.tree.map(lambda a: np.asarray(a[0], np.float32),
                     jm.init(jax.random.PRNGKey(8))["blocks"]["p0"]["moe"])
    x = _x(1, 16, tm.cfg.d_model, seed=5, zero_row=(0, 3))
    got = tmoe._route(tree_from_numpy(p, "cpu"),
                      torch.from_numpy(x).to(torch.bfloat16), tm.cfg)
    K = tm.cfg.moe.top_k
    assert got["top_idx"][0, 3].tolist() == list(range(K))
    probs = jax.nn.softmax(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)
                           @ jnp.asarray(p["router"]), axis=-1)
    _, jidx = jax.lax.top_k(probs, K)
    assert np.asarray(jidx)[0, 3].tolist() == list(range(K))
    # ties inside a row of unequal probabilities: torch.sort(stable) and
    # lax.top_k agree element for element
    pr = np.array([[0.1, 0.3, 0.1, 0.3, 0.2, 0.0, 0.3, 0.1]], np.float32)
    _, want = jax.lax.top_k(jnp.asarray(pr), 4)
    assert tmoe._top_k(torch.from_numpy(pr), 4)[1].tolist() == \
        np.asarray(want).tolist() == [[1, 3, 6, 4]]


# ---------------------------------------------------------------------------
# the reduced LMs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_lm_prefill_and_decode_match_jax(arch, nosharder):
    """A right-padded 3-row prefill (padding tokens and rows compete for
    capacity), then three decode steps fed the same tokens: logits and
    the k/v caches within REL, positions and lengths exact."""
    jm, jp, _, tm, tp = _models(arch)
    rng = np.random.default_rng(21)
    toks = rng.integers(0, tm.cfg.vocab_size, (3, 16)).astype(np.int32)
    lens = np.array([16, 9, 1], np.int32)
    toks[1, 9:] = 0
    toks[2, 1:] = 0
    jc, jl = JLM.prefill(jm, jp, {"tokens": jnp.asarray(toks),
                                  "lengths": jnp.asarray(lens)}, nosharder,
                         max_len=MAX_LEN)
    tc, tl = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                             "lengths": torch.from_numpy(lens)},
                        max_len=MAX_LEN)
    _close(jl, tl, REL)
    for _ in range(3):
        for name in ("k", "v"):
            _close(jc["blocks"]["p0"][name].astype(jnp.float32),
                   tc["blocks"]["p0"][name], REL)
        assert np.array_equal(np.asarray(jc["blocks"]["p0"]["pos"]),
                              tc["blocks"]["p0"]["pos"].numpy())
        assert np.array_equal(np.asarray(jc["lengths"]),
                              tc["lengths"].numpy())
        step = np.asarray(jl).argmax(-1).astype(np.int32)
        jc, jl = JLM.decode_step(jm, jp, jc, jnp.asarray(step), nosharder)
        tc, tl = tm.decode_step(tp, tc, torch.from_numpy(step))
        _close(jl, tl, REL)


# ---------------------------------------------------------------------------
# a served cell through both engines
# ---------------------------------------------------------------------------


def _token_tick(req, k):
    """The tick token ``k`` of a request was produced at (no
    preemption): the prefill token and the first decode token at
    admission, then one a tick."""
    return req.t_admit + max(0, k - 1)


def _jax_margin(log, prompt, prefix, token):
    """JAX's top-2 margin and largest |logit| for the step that produced
    ``token`` after ``prompt + prefix``, from the recorded engine calls:
    the prefill row of that prompt, or the decode row whose input token
    and cache length are the previous token's."""
    L, cands = len(prompt), []
    for kind, toks, lens, logits in log:
        for i in range(toks.shape[0]):
            if kind == "p" and not prefix and lens[i] == L and \
                    toks[i, :L].tolist() == list(prompt):
                cands.append(logits[i])
            elif kind == "d" and prefix and lens[i] == L + len(prefix) - 1 \
                    and toks[i] == prefix[-1]:
                cands.append(logits[i])
    cands = [c for c in cands if int(np.argmax(c)) == token]
    assert cands, "the differing token's JAX step was not recorded"
    top = [np.sort(c.astype(np.float32))[::-1] for c in cands]
    return min(float(t[0] - t[1]) for t in top), max(
        float(np.abs(t).max()) for t in top)


def test_served_cell_matches_live_jax_engine():
    """``qwen3-moe-30b-a3b/b4/r1`` at reduced width through ``drive`` on
    a live JAX engine and on the port's, from the same plan and items."""
    jm, jp, log, tm, tp = _models("qwen3-moe-30b-a3b")
    cell = serving_cell(CELL)
    plan = dataclasses.replace(cell.plan, reduced=True)
    jplan = next(c for c in J_SWEEP if c.name == CELL).plan
    jplan = dataclasses.replace(jplan, reduced=True)
    items_t = twl.profile_items(cell.workload, vocab_size=tm.cfg.vocab_size,
                                seed=0, duration=16.0)
    items_j = jwl.profile_items(next(c for c in J_SWEEP
                                     if c.name == CELL).workload,
                                vocab_size=jm.cfg.vocab_size, seed=0,
                                duration=16.0)
    assert [i.to_json() for i in items_t] == [i.to_json() for i in items_j]
    del log[:]
    jeng = JEngine.from_plan(jplan, jp, model=jm, sharder=Sharder(None, {}))
    jreqs = jwl.drive(jeng, items_j, jwl.VirtualClock())
    teng = TEngine.from_plan(plan, tp, model=tm)
    treqs = twl.drive(teng, items_t, twl.VirtualClock())

    stamps = lambda r: (r.uid, r.t_submit, r.t_admit, r.t_first, r.t_done,
                        len(r.output), r.done)
    assert [stamps(r) for r in treqs] == [stamps(r) for r in jreqs]
    assert teng.util_history == jeng.util_history
    ja = jmet.aggregate(jreqs, ticks=jeng.ticks,
                        util_history=jeng.util_history)
    ta = tmet.aggregate(treqs, ticks=teng.ticks,
                        util_history=teng.util_history)
    assert ta == ja
    js, ts = jeng.stats(), teng.stats()
    for k in ("completed", "total_tokens", "prefill_calls", "decode_chunks",
              "ticks", "host_syncs", "instant_admits"):
        assert ts[k] == js[k], k
    # ticks with free slots while others decode
    assert any(0 < u < 1 for u in teng.util_history)

    diffs = [(_token_tick(jr, k), jr, k)
             for jr, tr in zip(jreqs, treqs)
             for k, (a, b) in enumerate(zip(jr.output, tr.output)) if a != b]
    first = min((t for t, _, _ in diffs), default=None)
    for t, jr, k in diffs:
        if t != first:
            continue
        margin, scale = _jax_margin(log, jr.prompt, jr.output[:k],
                                    jr.output[k])
        assert margin < REL * scale, (
            f"request {jr.uid}: token {k} differs at a JAX top-2 margin "
            f"{margin:.3g} >= {REL * scale:.3g}")
    compared = sum(1 for jr in jreqs for k in range(len(jr.output))
                   if first is None or _token_tick(jr, k) < first)
    assert compared >= sum(len(r.output) for r in jreqs) // 2
