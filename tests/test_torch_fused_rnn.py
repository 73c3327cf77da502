"""Port parity: repro_torch.kernels.fused_rnn against the JAX package's
``ref.py`` oracle and its Pallas kernels in interpret mode.

On the CPU the wrappers run the kernel's plain version; the CUDA kernels
themselves are held against it in tests/test_torch_cuda_kernels.py and
by chip_smoke.py.  Tolerance: both
sides sum exact bf16 x int8/bf16 products in f32, in different orders;
a last-bit difference can flip one bf16 ulp of y or of the h fed back,
hence 2e-2 as in tests/test_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dse as jdse
from repro.core.cells import RNNCellConfig as JCfg
from repro.kernels.fused_rnn import fused_rnn as jk
from repro.kernels.fused_rnn import ops as jops
from repro.kernels.fused_rnn import ref as jref
from repro_torch import hw
from repro_torch.configs import DEEPBENCH_TASKS
from repro_torch.core import dse as tdse
from repro_torch.core.cells import RNNCellConfig as TCfg
from repro_torch.kernels.fused_rnn import fused_rnn as tk
from repro_torch.kernels.fused_rnn import ops as tops
from repro_torch.kernels.fused_rnn import ref as tref

TOL = dict(atol=2e-2, rtol=2e-2)


def _operands(cell, H, D, B, T, wdtype, seed):
    """Numpy operands: int8 codes with (G, H) scales, or bf16-valued
    weights with unit scales; nonzero biases and initial state."""
    G = 4 if cell == "lstm" else 3
    rng = np.random.default_rng(seed)
    s = (H + D) ** -0.5
    if wdtype == "int8":
        wx = rng.integers(-127, 128, (D, G, H)).astype(np.int8)
        wh = rng.integers(-127, 128, (H, G, H)).astype(np.int8)
        sx = (rng.random((G, H)) * s / 127 + s / 254).astype(np.float32)
        sh = (rng.random((G, H)) * s / 127 + s / 254).astype(np.float32)
    else:
        wx = rng.uniform(-s, s, (D, G, H)).astype(np.float32)
        wh = rng.uniform(-s, s, (H, G, H)).astype(np.float32)
        sx = sh = np.ones((G, H), np.float32)
    return dict(
        x=rng.standard_normal((T, B, D)).astype(np.float32),
        w_x=wx, w_h=wh, s_x=sx, s_h=sh,
        b=(rng.standard_normal((G, H)) * 0.1).astype(np.float32),
        b_h=(rng.standard_normal((G, H)) * 0.1).astype(np.float32),
        h0=(rng.standard_normal((B, H)) * 0.5).astype(np.float32),
        c0=(rng.standard_normal((B, H)) * 0.5).astype(np.float32))


def _jax(o, wdtype):
    j = {k: jnp.asarray(v) for k, v in o.items()}
    j["x"] = j["x"].astype(jnp.bfloat16)
    if wdtype == "bf16":
        j["w_x"] = j["w_x"].astype(jnp.bfloat16)
        j["w_h"] = j["w_h"].astype(jnp.bfloat16)
    return j


def _torch(o, wdtype, device="cpu"):
    t = {k: torch.from_numpy(v).to(device) for k, v in o.items()}
    t["x"] = t["x"].to(torch.bfloat16)
    if wdtype == "bf16":
        t["w_x"] = t["w_x"].to(torch.bfloat16)
        t["w_h"] = t["w_h"].to(torch.bfloat16)
    return t


def _lstm(m, o, **kw):
    return m(o["x"], o["w_x"], o["w_h"], o["s_x"], o["s_h"], o["b"],
             o["h0"], o["c0"], **kw)


def _gru(m, o, **kw):
    return m(o["x"], o["w_x"], o["w_h"], o["s_x"], o["s_h"], o["b"],
             o["b_h"], o["h0"], **kw)


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **TOL)


CASES = [("lstm", 64, 64, 1, 6, "int8"), ("lstm", 128, 96, 3, 4, "bf16"),
         ("gru", 64, 64, 3, 5, "int8"), ("gru", 128, 128, 1, 3, "bf16")]


@pytest.mark.parametrize("cell,H,D,B,T,wdtype", CASES)
def test_ref_matches_jax_ref(cell, H, D, B, T, wdtype):
    """y, h_T and c_T of the plain version equal the JAX oracle, with a
    nonzero initial state carried in."""
    o = _operands(cell, H, D, B, T, wdtype, seed=H + B)
    j, t = _jax(o, wdtype), _torch(o, wdtype)
    if cell == "lstm":
        got, want = _lstm(tref.fused_lstm_ref, t), _lstm(jref.fused_lstm_ref, j)
    else:
        got, want = _gru(tref.fused_gru_ref, t), _gru(jref.fused_gru_ref, j)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("persistent", [False, True])
@pytest.mark.parametrize("cell,H,D,B,T,wdtype", CASES)
def test_wrapper_cpu_matches_pallas_interpret(cell, H, D, B, T, wdtype,
                                              persistent):
    """The wrapper on CPU tensors equals the Pallas kernel (interpret mode)
    in both modes, state carry included."""
    o = _operands(cell, H, D, B, T, wdtype, seed=7 * H + B)
    j, t = _jax(o, wdtype), _torch(o, wdtype)
    bh = H // 2
    if cell == "lstm":
        got = _lstm(tk.fused_lstm, t, bh=bh, persistent=persistent)
        want = _lstm(jk.fused_lstm, j, bh=bh, interpret=True,
                     persistent=persistent)
    else:
        got = _gru(tk.fused_gru, t, bh=bh, persistent=persistent)
        want = _gru(jk.fused_gru, j, bh=bh, interpret=True,
                    persistent=persistent)
    _close(got, want)


def test_persistent_parity_cpu():
    """Persistent and streaming are the same math: on the CPU both run the
    plain version, bit for bit."""
    o = _torch(_operands("gru", 64, 64, 2, 5, "int8", seed=3), "int8")
    a = _gru(tk.fused_gru, o, bh=16, persistent=False)
    b = _gru(tk.fused_gru, o, bh=64, persistent=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_smem_bytes_formula():
    """The CTA working set the wrapper asks for matches its parts: the
    persistent kernel's resident slice (512-byte blocks of a k-step x 16
    units), h_{t-1} staged in bf16 and its warps' f32 partials; the
    streaming step kernel's h_{t-1} in bf16 (H per batch row of a pass)
    and its row splits' f32 partials."""
    G, D, H = 3, 2048, 2048
    for wbytes, bh, cs, B in ((1, 16, 1, 1), (1, 20, 3, 4), (2, 64, 2, 9)):
        mt = -(-G * bh // 16)
        kstep = 32 if wbytes == 1 else 16
        ksr = -(-(-(-H // kstep)) // cs)
        words = tk.persist_hs_words(ksr, wbytes)
        assert words >= ksr * kstep // 2 and words % 32 == 4
        bch = min(B, tk.PERSIST_N)
        assert tk.smem_bytes(G, D, H, bh, B, wbytes, True, cs) == (
            mt * ksr * 512 + bch * words * 4 + 8 * bch * mt * 16 * 4)
    for wbytes, bh in ((1, 64), (2, 64), (1, 16)):
        vec = 16 // wbytes
        ks = tk.stream_k_split(G, bh, wbytes)
        assert ks == tk.THREADS // (G * bh // vec)
        for B in (1, 3, 9):
            bch = min(B, tk.BCH)
            assert tk.smem_bytes(G, D, H, bh, B, wbytes, False) == (
                H * 2 * bch + ks * bch * G * bh * 4)


@pytest.mark.parametrize("batch", [1, 4])
def test_persist_geometry_fits_every_deepbench_task(batch):
    """The persistent grid at the DSE's tile, for every DeepBench task on
    the port's H100 spec: the tile covers H (bh | H, at most 128 outputs),
    the cluster's k-steps cover H's rows, a CTA's shared memory at this
    batch and at a full pass is within the budget, and the cs x H/bh CTAs
    are co-resident (the modelled cluster slots, two CTAs an SM at most).
    The cluster size does not follow the batch."""
    spec = hw.H100_SXM
    budget = hw.smem_budget(spec)
    for task in DEEPBENCH_TASKS:
        G, H = (4 if task.cell == "lstm" else 3), task.hidden
        cfg = TCfg(task.cell, H, timesteps=task.timesteps)
        p = tdse.best_plan(cfg, max_batch=batch, persistent=True)
        bh = p.bh
        assert H % bh == 0 and G * bh <= tk.PERSIST_MAX_UNITS, task.name
        assert tk.legal_bh(G, H, bh, 1, True) == bh
        cs, smem_full = tk.persist_geometry(G, H, bh, 1, spec)
        kstep = tk.persist_kstep(1)
        assert cs * tk.persist_ksteps(H, cs, 1) * kstep >= H
        smem = tk.persist_smem_bytes(G, H, bh, cs, batch, 1)
        assert p.vmem_bytes == smem <= smem_full <= budget, task.name
        per_sm = tk.persist_ctas_per_sm(smem_full, spec)
        assert 1 <= per_sm <= 2
        tiles = H // bh
        assert tiles <= tk.persist_cluster_slots(cs, per_sm, spec)
        assert cs * tiles <= per_sm * spec.sms, task.name
        # a smaller cluster would not fit
        for c in range(1, cs):
            m = tk.persist_smem_bytes(G, H, bh, c, tk.PERSIST_N, 1)
            assert (m > budget or tiles > tk.persist_cluster_slots(
                c, tk.persist_ctas_per_sm(m, spec), spec))


@pytest.mark.parametrize("wdtype", ["int8", "bf16"])
@pytest.mark.parametrize("cell,H,D,B,T", [("gru", 96, 80, 1, 7),
                                          ("lstm", 64, 128, 3, 5),
                                          ("gru", 128, 48, 3, 2)])
def test_xproj_ref_matches_jax_zx(cell, H, D, B, T, wdtype):
    """The streaming call's input half for all T*B rows at once equals the
    JAX oracle's zx (its ``_z`` on each step's x) plus the bias, within
    1e-5 of the largest magnitude (f32 sums of exact products, in
    another order)."""
    o = _operands(cell, H, D, B, T, wdtype, seed=5 * H + D + B)
    j, t = _jax(o, wdtype), _torch(o, wdtype)
    got = tref.xproj_ref(t["x"], t["w_x"], t["s_x"], t["b"])
    G = got.shape[2]
    assert got.shape == (T, B, G, H) and got.dtype == torch.float32
    zero = jnp.zeros((B, H), jnp.float32)
    want = np.stack([np.asarray(jref._z(j["x"][i], zero, j["w_x"], j["w_h"],
                                        j["s_x"], j["s_h"])[0] + j["b"][None])
                     for i in range(T)])
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("cell,H,D,B,T,wdtype", CASES)
def test_hoisted_composition_matches_jax_ref(cell, H, D, B, T, wdtype):
    """zx first for all T (``xproj_ref``), then the recurrence on W_h
    alone (``lstm_steps_ref``/``gru_steps_ref``), as the streaming and
    persistent kernels compute it: y, h_T and c_T equal the JAX oracle at
    TOL."""
    o = _operands(cell, H, D, B, T, wdtype, seed=3 * H + B + 1)
    j, t = _jax(o, wdtype), _torch(o, wdtype)
    zx = tref.xproj_ref(t["x"], t["w_x"], t["s_x"], t["b"])
    if cell == "lstm":
        got = tref.lstm_steps_ref(zx, t["w_h"], t["s_h"], t["h0"], t["c0"])
        want = _lstm(jref.fused_lstm_ref, j)
    else:
        got = tref.gru_steps_ref(zx, t["w_h"], t["s_h"], t["b_h"], t["h0"])
        want = _gru(jref.fused_gru_ref, j)
    _close(got, want)


def test_step_wrappers_cpu_run_the_plain_parts():
    """On CPU tensors ``xproj`` and ``gru_steps``/``lstm_steps`` are their
    plain versions, and their composition stays within TOL of the
    function's definition."""
    o = _torch(_operands("lstm", 64, 32, 2, 4, "int8", seed=9), "int8")
    zx = tk.xproj(o["x"], o["w_x"], o["s_x"], o["b"])
    assert torch.equal(zx, tref.xproj_ref(o["x"], o["w_x"], o["s_x"],
                                          o["b"]))
    got = tk.lstm_steps(zx, o["w_h"], o["s_h"], o["h0"], o["c0"], bh=16)
    want = _lstm(tref.fused_lstm_ref, o)
    _close(got, [w.float().numpy() for w in want])


def _legal_tiles(G, H, wbytes):
    return [d for d in range(1, H + 1) if tk.stream_tile_ok(G, H, d, wbytes)]


@pytest.mark.parametrize("batch", [1, 4, 64])
def test_legal_bh_makes_every_plan_tile_streamable(batch):
    """Every DeepBench task's tile from the JAX DSE (whole H for lstm-1536,
    gru-1536 and gru-2048, which the step kernel cannot run), from the
    port's DSE, and plan tiles 8, 24 and H, become a tile the streaming
    step kernel runs: a divisor of H that ``stream_tile_ok`` accepts, the
    largest at or below the request, else the smallest; persistent takes
    the largest divisor at or below the request and 128 / G."""
    for task in DEEPBENCH_TASKS:
        G, H = (4 if task.cell == "lstm" else 3), task.hidden
        jbh = jdse.best_plan(JCfg(task.cell, H, timesteps=task.timesteps),
                             max_batch=batch).bh
        tbh = tdse.best_plan(TCfg(task.cell, H, timesteps=task.timesteps),
                             max_batch=batch).bh
        legal = _legal_tiles(G, H, 1)
        for ask in {jbh, tbh, 8, 24, H}:
            bh = tk.legal_bh(G, H, ask, 1, False)
            assert H % bh == 0 and tk.stream_tile_ok(G, H, bh, 1), (task, ask)
            below = [d for d in legal if d <= ask]
            assert bh == (below[-1] if below else legal[0]), (task, ask)
            assert tk.legal_bh(G, H, ask, 1, True) == tdse.snap_tile(
                H, min(ask, tk.PERSIST_MAX_UNITS // G))
        assert tk.legal_bh(G, H, tbh, 1, False) == tbh


def test_legal_bh_examples_and_refusal():
    """The cases the JAX plans reach: whole-H tiles over the step kernel's
    256 threads halve, a tile below the smallest legal one rises to it,
    bf16 weights take 8-unit loads; an H with no legal tile raises."""
    assert tk.legal_bh(4, 1536, 1536, 1, False) == 768
    assert tk.legal_bh(3, 1536, 1536, 1, False) == 768
    assert tk.legal_bh(3, 2048, 2048, 1, False) == 1024
    assert tk.legal_bh(3, 2560, 24, 1, False) == 16
    assert tk.legal_bh(4, 1024, 8, 1, False) == 16
    assert tk.legal_bh(4, 1024, 1024, 1, False) == 1024
    assert tk.legal_bh(3, 96, 96, 2, False) == 96
    assert tk.legal_bh(3, 96, 4, 2, False) == 8
    assert tk.legal_bh(3, 2560, 2560, 1, True) == 40
    assert tk.legal_bh(4, 2048, 2048, 1, True) == 32
    assert tk.legal_bh(3, 2560, 24, 1, True) == 20
    with pytest.raises(ValueError, match="no streaming tile"):
        tk.legal_bh(3, 90, 90, 1, False)


@pytest.mark.parametrize("cell,H,B", [("lstm", 96, 1), ("gru", 64, 3)])
def test_serve_with_a_jax_whole_h_plan_matches_jax(cell, H, B):
    """``ops.serve`` on the CPU under a JAX plan's whole-H tile (the tile
    the JAX DSE picks for lstm-1536, gru-1536 and gru-2048) equals the JAX
    package's ``ops.serve`` (Pallas in interpret mode) at TOL: on the CPU
    the plain version runs whatever the tile."""
    T, G = 5, (4 if cell == "lstm" else 3)
    o = _operands(cell, H, H, B, T, "int8", seed=H + B)
    w = dict(w_x=o["w_x"], w_h=o["w_h"], w_x_scale=o["s_x"],
             w_h_scale=o["s_h"], b=o["b"])
    if cell == "gru":
        w["b_h"] = o["b_h"]
    plan = {"bh": H}
    want = jops.serve(JCfg(cell, H, timesteps=T, batch=B),
                      {k: jnp.asarray(v) for k, v in w.items()},
                      jnp.asarray(o["x"]).astype(jnp.bfloat16),
                      interpret=True, plan=plan)
    got = tops.serve(TCfg(cell, H, timesteps=T, batch=B),
                     {k: torch.from_numpy(v) for k, v in w.items()},
                     torch.from_numpy(o["x"]).to(torch.bfloat16), plan=plan)
    assert got.shape == (T, B, H) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL)


def test_xproj_tile_is_legal_and_its_k_order_ignores_m():
    """The int8 projection's tile at every task's N and K over many M
    (each task's T at B 1, 4 and 64 among them) and two SM counts: bm is
    a kernel tile whose ring fits a CTA (two an SM up to bm 128), the
    row tiles fit the grid, and the K splits, which set an output's sum
    order, are one count per (N, K, SMs) whatever M is, at most one a K
    step."""
    budget = hw.smem_budget(hw.H100_SXM)
    assert tk.xproj_smem_bytes(256) == 205_824
    for bm in tk.XPROJ_BMS:
        assert tk.xproj_smem_bytes(bm) <= budget
        if bm <= 128:
            assert 2 * (tk.xproj_smem_bytes(bm) + 1024) <= hw.H100_SXM.smem_per_sm
    for task in DEEPBENCH_TASKS:
        G, H = (4 if task.cell == "lstm" else 3), task.hidden
        N, K = G * H, H
        for sms in (132, 114):
            splits = set()
            for M in sorted({1, 2, 5, 16, 17, 20, 25, 33, 64, 100, 150, 375,
                             1500, task.timesteps, 4 * task.timesteps,
                             64 * task.timesteps}):
                bm, S = tk.xproj_tile(M, N, K, sms)
                assert bm in tk.XPROJ_BMS and -(-M // bm) <= 65535
                assert 1 <= S <= min(tk.XPROJ_MAX_SPLIT, tk.xproj_k_steps(K))
                splits.add(S)
            assert len(splits) == 1, (task, sms, splits)
        # the split fills the card at one row tile without outgrowing it
        S = tk.xproj_splits(N, K, 132)
        assert S * -(-N // tk.XPROJ_BN) <= 132 or S == 1
