"""Port parity and invariants: repro_torch.core.dse (Hopper) against
repro.core.dse (TPU).  The tiling helpers and the Fig. 4 arithmetic are
identical; the chosen tiles differ by design, so the Hopper search is
held to its invariants instead."""

import pytest

from repro.core import dse as jdse
from repro.core.cells import RNNCellConfig as JCfg
from repro_torch import hw
from repro_torch.configs import DEEPBENCH_TASKS
from repro_torch.core import dse
from repro_torch.core.cells import RNNCellConfig
from repro_torch.kernels.fused_rnn import fused_rnn as tk
from repro_torch.kernels.fused_rnn import ops

HS = [1, 6, 8, 64, 96, 100, 128, 256, 512, 1000, 1024, 1536, 2048, 2560,
      4096]


def test_snap_tile_identical():
    for dim in HS:
        for tile in (0, 1, 3, 7, 8, 24, 48, 64, 100, 128, 256, 513, 5000):
            assert dse.snap_tile(dim, tile) == jdse.snap_tile(dim, tile)


def test_candidate_tiles_identical():
    for H in HS:
        assert dse.candidate_tiles(H) == jdse.candidate_tiles(H)


def test_fragmentation_identical():
    for H in HS:
        for D in (None, 80, H):
            assert dse.fragmentation(H, D) == jdse.fragmentation(H, D)
        assert dse.utilization_loop(H, 2 * H) == jdse.utilization_loop(H, 2 * H)
        assert dse.utilization_mvm(H, 2 * H) == jdse.utilization_mvm(H, 2 * H)


def test_plan_dict_key_set_matches_jax():
    task = DEEPBENCH_TASKS[2]
    p = dse.best_plan(RNNCellConfig(task.cell, task.hidden))
    pj = jdse.best_plan(JCfg(task.cell, task.hidden))
    assert set(dse.plan_dict(p)) == set(jdse.plan_dict(pj))
    pp = dse.best_plan(RNNCellConfig(task.cell, task.hidden), persistent=True)
    assert dse.plan_dict(pp)["persistent"] is True


@pytest.mark.parametrize("batch", [1, 4])
def test_best_plan_fits_h100(batch):
    budget = hw.smem_budget(hw.H100_SXM)
    for task in DEEPBENCH_TASKS:
        cfg = RNNCellConfig(task.cell, task.hidden, timesteps=task.timesteps)
        p = dse.best_plan(cfg, max_batch=batch)
        # the streaming step kernel reads W_h in 16-byte loads of one
        # (row, gate): bh a multiple of 16 int8 units, one load a thread
        assert cfg.hidden % p.bh == 0 and p.bh % 16 == 0
        assert cfg.n_gates * p.bh // 16 <= tk.THREADS
        assert p.n_tiles == cfg.hidden // p.bh
        assert p.vmem_bytes <= budget
        assert p.vmem_bytes == dse.tile_smem_bytes(cfg, p.bh,
                                                   max_batch=batch)
        assert 0 < p.util <= 1 and p.step_latency_s > 0
        assert ops.default_bh(cfg, batch) == p.bh


def test_streaming_grid_fills_the_card():
    """The streaming step grid (cs x H/bh CTAs, cs the CTAs of a cluster
    sharing a tile's rows of W_h) never exceeds the SMs where H allows,
    and at gru-2560 covers at least 120 of the 132 (80 before the
    cluster split).  The W_h bound is the weight bound less W_x."""
    spec = hw.H100_SXM
    for task in DEEPBENCH_TASKS:
        cfg = RNNCellConfig(task.cell, task.hidden, timesteps=task.timesteps)
        p = dse.best_plan(cfg)
        cs = tk.cluster_size(cfg.n_gates, cfg.hidden, p.bh, 1, spec.sms)
        assert 1 <= cs <= tk.MAX_CLUSTER
        assert cs * p.n_tiles <= spec.sms or cs == 1
        if task.name == "gru-h2560-t375":
            assert cs * p.n_tiles >= 120
        wh = dse.wh_stream_bound_s(cfg, task.timesteps)
        w = dse.weight_stream_bound_s(cfg, task.timesteps)
        assert wh == pytest.approx(w * cfg.hidden / (cfg.hidden + cfg.d))
        assert dse.xproj_latency_s(cfg, task.timesteps) > 0


def test_persistent_eligibility_on_h100():
    """With the input projection hoisted, a persistent grid holds only
    W_h: all ten DeepBench tasks fit the H100 (0.3-19.7 MB of int8 W_h
    against 132 SMs x 227 KB ~ 30.7 MB), at batch 1 and 4.  The plan is
    resident, within a CTA's shared memory, holds W_h across its CTAs and
    models the projection apart; a GRU at H=4096 (50.3 MB of W_h) fits at
    no tile."""
    for batch in (1, 4):
        for task in DEEPBENCH_TASKS:
            cfg = RNNCellConfig(task.cell, task.hidden,
                                timesteps=task.timesteps)
            assert dse.persistent_eligible(cfg, max_batch=batch), task.name
            p = dse.best_plan(cfg, max_batch=batch, persistent=True)
            assert p.persistent and p.resident
            assert p.vmem_bytes <= hw.smem_budget()
            cs, _ = tk.persist_geometry(cfg.n_gates, cfg.hidden, p.bh, 1)
            wh = cfg.n_gates * cfg.hidden ** 2
            assert p.vmem_bytes * cs * p.n_tiles >= wh
            assert cs * p.n_tiles <= dse.coresident_ctas(p.vmem_bytes)
            assert p.step_latency_s > 0
    big = RNNCellConfig("gru", 4096)
    assert not dse.persistent_eligible(big)
    with pytest.raises(ValueError):
        dse.best_plan(big, persistent=True)
    assert not any(dse.plan_metrics(big, bh).resident
                   for bh in dse.persist_candidate_tiles(3, 4096))


def test_fewer_sms_shrink_residency():
    """A card with fewer SMs (an H100 PCIe has 114) holds fewer CTAs."""
    import dataclasses
    pcie = dataclasses.replace(hw.H100_SXM, sms=114, hbm_bw=2.0e12)
    cfg = RNNCellConfig("gru", 2048)
    assert dse.coresident_ctas(100_000, pcie) < dse.coresident_ctas(100_000)
    assert (dse.best_plan(cfg, pcie).step_latency_s
            > dse.best_plan(cfg).step_latency_s)


def test_latency_monotone_in_hidden():
    """Bigger problems are never modeled faster (as tests/test_cells.py
    asks of the JAX model)."""
    for e in range(5, 12):
        small = dse.best_plan(RNNCellConfig("lstm", 2 ** e))
        big = dse.best_plan(RNNCellConfig("lstm", 2 ** (e + 1)))
        assert big.step_latency_s >= small.step_latency_s * 0.99


# ---------------------------------------------------------------------------
# flash_attention tile search
# ---------------------------------------------------------------------------

ATTN_SHAPES = [(8, 8, 16), (100, 100, 64), (512, 512, 128),
               (1023, 1023, 128), (256, 4096, 64), (4096, 4096, 128)]


def test_candidate_attn_tiles_identical():
    for sq in (1, 8, 100, 128, 512, 1023, 1024, 4096):
        for skv in (8, 100, 512, 1023, 4096):
            assert dse.candidate_attn_tiles(sq, skv) == \
                jdse.candidate_attn_tiles(sq, skv)


@pytest.mark.parametrize("sq,skv,hd", ATTN_SHAPES)
def test_best_attn_plan_fits_h100_and_beats_naive(sq, skv, hd):
    """The chosen tile is one the kernel runs, fits a CTA's shared memory,
    and models no slower than the naive (smallest) tile, the guard
    benchmarks/kernel_tiles.py applies to the JAX search."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    budget = hw.smem_budget(hw.H100_SXM)
    for heads, batch in ((1, 1), (40, 4)):
        p = dse.best_attn_plan(sq, skv, hd, n_heads=heads, batch=batch)
        assert p.bq in (fa.WG_ROWS, fa.MAX_BQ) and p.bk in (fa.SUB, fa.MAX_BK)
        assert p.vmem_bytes == fa.smem_bytes(p.bq, p.bk, hd) <= budget
        assert p.resident and 0 < p.util <= 1 and p.step_latency_s > 0
        assert p.n_tiles == batch * heads * -(-sq // p.bq)
        assert fa.kernel_tiles(p.bq, p.bk, sq, skv) == (p.bq, p.bk)
        naive = dse.attn_plan_metrics(sq, skv, hd,
                                      *dse.attn_kernel_tiles(sq, skv)[0],
                                      n_heads=heads, batch=batch)
        assert p.step_latency_s <= naive.step_latency_s
        assert set(dse.plan_dict(p)) >= {"bq", "bk"}


def test_best_attn_plan_is_the_adapters_default_at_qwen_prefill():
    """At qwen2.5-14b's 4-row bucket-512 prefill (40 heads of 128) the
    search picks the tile the adapter launches by default."""
    from repro_torch.kernels.flash_attention import ops
    p = dse.best_attn_plan(512, 512, 128, n_heads=40, batch=4)
    assert (p.bq, p.bk) == (ops.DEFAULT_BQ, ops.DEFAULT_BK)


def test_attn_model_counts_only_the_causal_tiles():
    """Under a causal mask a warpgroup computes the 64-key tiles up to
    its last row: half the square plus the diagonal, and fewer modeled
    seconds than the same shape unmasked."""
    counts = dse.attn_tile_counts(512, 512, 128)
    assert counts == [[1, 2], [3, 4], [5, 6], [7, 8]]
    assert dse.attn_tile_counts(512, 512, 128, causal=False) == [[8, 8]] * 4
    assert dse.attn_tile_counts(100, 300, 64) == [[1], [2]]
    c = dse.attn_plan_metrics(512, 512, 128, 128, 128, n_heads=40, batch=4)
    f = dse.attn_plan_metrics(512, 512, 128, 128, 128, n_heads=40, batch=4,
                              causal=False)
    assert c.step_latency_s < f.step_latency_s


def test_attn_search_drops_tiles_over_the_budget():
    """A smaller shared-memory budget removes the large staged tiles; a
    budget no tile fits raises."""
    import dataclasses
    small = dataclasses.replace(hw.H100_SXM, smem_per_block_optin=100_000)
    plans = dse.attn_search(1024, 1024, 128, small)
    assert plans and all(p.vmem_bytes <= 100_000 for p in plans)
    assert len(plans) < len(dse.attn_search(1024, 1024, 128))
    none = dataclasses.replace(hw.H100_SXM, smem_per_block_optin=1_000)
    with pytest.raises(ValueError, match="fits"):
        dse.best_attn_plan(512, 512, 128, none)


# ---------------------------------------------------------------------------
# matmul_w8a16 tile search
# ---------------------------------------------------------------------------

# (M, N, K): qwen2.5-14b's decode projections at M = 1 and 4, its 4-row
# bucket-512 prefill, and ragged shapes
MM_SHAPES = [(1, 5120, 5120), (4, 1024, 5120), (4, 13824, 5120),
             (4, 5120, 13824), (2048, 13824, 5120), (96, 384, 256),
             (3, 300, 200), (17, 33, 1)]


def test_candidate_mm_tiles_identical():
    for M in (1, 4, 8, 96, 100, 2048):
        for N in (33, 256, 384, 1024, 13824):
            for K in (1, 200, 256, 5120):
                assert dse.candidate_mm_tiles(M, N, K) == \
                    jdse.candidate_mm_tiles(M, N, K)


@pytest.mark.parametrize("M,N,K", MM_SHAPES)
def test_best_matmul_plan_fits_h100_and_beats_naive(M, N, K):
    """The chosen geometry is one the kernel runs at this shape (the
    tiled kernel's clamped tile above M = 16, the decode kernel's split
    count at and below), fits a CTA's shared memory, and models no slower
    than the naive (first) candidate, the guard
    benchmarks/kernel_tiles.py applies to the JAX search."""
    from repro_torch.kernels.matmul_int8 import matmul_int8 as mm
    budget = hw.smem_budget(hw.H100_SXM)
    p = dse.best_matmul_plan(M, N, K)
    decode = M <= mm.DECODE_M

    def legal(t):
        if decode:
            geo = mm.decode_geometry(M, N, K, t[3])
            return t == (geo.bm, geo.bn, geo.kstep, geo.splits)
        return t[3] == 1 and mm.kernel_tiles(*t[:3], M, N, K) == t[:3]

    assert legal((p.bm, p.bn, p.bk, p.splits or 1))
    assert p.vmem_bytes == dse.matmul_tile_vmem_bytes(p.bm, p.bn, p.bk,
                                                      decode) <= budget
    if decode:
        assert p.vmem_bytes == mm.decode_smem_bytes(M)
        assert p.n_tiles == mm.decode_geometry(M, N, K, p.splits).ctas
    else:
        assert p.vmem_bytes == mm.smem_bytes(p.bm, p.bn, p.bk)
        assert p.n_tiles == -(-M // p.bm) * -(-N // p.bn)
    assert p.resident and 0 < p.util <= 1 and p.step_latency_s > 0
    naive = dse.matmul_plan_metrics(M, N, K, *dse.mm_kernel_tiles(M, N, K)[0])
    assert p.step_latency_s <= naive.step_latency_s
    assert set(dse.plan_dict(p)) >= {"bm", "bn", "bk"}
    # every candidate is a geometry the kernel runs, none listed twice
    tiles = dse.mm_kernel_tiles(M, N, K)
    assert len(set(tiles)) == len(tiles)
    assert all(legal(t) for t in tiles)


# qwen2.5-14b's decode projections (N, K): wq/wo, wk/wv, w_gate/w_up, w_down
QWEN_DECODE = [(5120, 5120), (1024, 5120), (13824, 5120), (5120, 13824)]


@pytest.mark.parametrize("M", [1, 2, 4])
@pytest.mark.parametrize("N,K", QWEN_DECODE)
def test_best_decode_plan_fills_the_card(M, N, K):
    """At qwen2.5-14b's decode shapes the modeled-fastest split gives at
    least 2 CTAs per SM, splits K (S > 1) wherever the 128-column strips
    alone are fewer than the SMs, and is the split the adapter runs by
    default."""
    from repro_torch.kernels.matmul_int8 import matmul_int8 as mm
    spec = hw.H100_SXM
    p = dse.best_matmul_plan(M, N, K)
    assert p.n_tiles >= 2 * spec.sms
    if -(-N // mm.DECODE_BN) < spec.sms:
        assert p.splits > 1
    assert p.splits == mm.decode_geometry(M, N, K).splits
    assert dse.plan_dict(p)["splits"] == p.splits


def test_matmul_model_reads_the_weight_at_least_once():
    """No tile is modeled faster than reading the int8 weight once at the
    data sheet's rate (the decode bound), nor than the padded products at
    the bf16 peak (the prefill bound)."""
    spec = hw.H100_SXM
    for M, N, K in MM_SHAPES:
        for t in dse.mm_kernel_tiles(M, N, K):
            p = dse.matmul_plan_metrics(M, N, K, *t)
            assert p.step_latency_s >= K * N / spec.hbm_bw
            assert p.step_latency_s >= 2.0 * M * N * K / spec.peak_bf16_flops


def test_matmul_search_drops_tiles_over_the_budget():
    import dataclasses
    small = dataclasses.replace(hw.H100_SXM, smem_per_block_optin=150_000)
    plans = dse.matmul_search(2048, 13824, 5120, small)
    assert plans and all(p.vmem_bytes <= 150_000 for p in plans)
    assert len(plans) < len(dse.matmul_search(2048, 13824, 5120))
    none = dataclasses.replace(hw.H100_SXM, smem_per_block_optin=1_000)
    with pytest.raises(ValueError, match="fits"):
        dse.best_matmul_plan(4, 5120, 5120, none)


# qwen2.5-14b's prefill projections (N, K): wq/wo, wk/wv, w_gate/w_up, w_down
QWEN_PREFILL = [(5120, 5120), (1024, 5120), (13824, 5120), (5120, 13824)]


@pytest.mark.parametrize("M", [128, 2048])
@pytest.mark.parametrize("N,K", QWEN_PREFILL)
def test_best_prefill_plan_is_the_adapter_default(M, N, K):
    """At qwen2.5-14b's prefill shapes (a 4-row prefill at bucket 32 and
    at bucket 512) the modeled-fastest prefill tile is the one the
    adapter runs by default, and it fits a CTA."""
    from repro_torch.kernels.matmul_int8 import matmul_int8 as mm
    from repro_torch.kernels.matmul_int8 import ops as mops
    p = dse.best_matmul_plan(M, N, K)
    assert mops.default_tiles(M, N, K) == (p.bm, p.bn, p.bk)
    assert mm.kernel_tiles(p.bm, p.bn, p.bk, M, N, K) == (p.bm, p.bn, p.bk)
    assert p.vmem_bytes == mm.smem_bytes(p.bm, p.bn, p.bk) <= \
        hw.smem_budget(hw.H100_SXM)


def test_prefill_model_ranks_tiles_as_the_card_does():
    """The prefill model's order at M = 2048 (the 4 x 512 prefill): the
    256-row tile first at qwen's wide projections, the 128-row tile at
    wk/wv (N 1024), where 256-row tiles would leave half the SMs idle;
    the 64-row tile last; a deeper K or a wider N never models faster."""
    def t(N, K, bm):
        return dse.matmul_plan_metrics(2048, N, K, bm, 128, 64).step_latency_s
    for N, K in QWEN_PREFILL:
        want = 128 if N == 1024 else 256
        assert dse.best_matmul_plan(2048, N, K).bm == want
        assert t(N, K, 64) > max(t(N, K, 128), t(N, K, 256))
    best = [dse.best_matmul_plan(2048, N, K).step_latency_s
            for N, K in QWEN_PREFILL]
    assert best[1] < best[0] < best[2] < best[3]


def test_xproj_model_is_at_or_above_its_bounds():
    """The streaming projection's model (the int8 ``wgmma`` kernel at the
    tile it runs, and at every tile it can run) is never below the
    card's bounds for the same work: 2 M K N operations at the bf16 peak,
    and x, W, the scale and bias read once and the f32 zx written once at
    the memory rate."""
    spec = hw.H100_SXM
    for task in DEEPBENCH_TASKS:
        cfg = RNNCellConfig(task.cell, task.hidden, timesteps=task.timesteps)
        N, K = cfg.n_gates * cfg.hidden, cfg.d
        for B in (1, 4, 64):
            M = task.timesteps * B
            bound = max(2.0 * M * K * N / spec.peak_bf16_flops,
                        (M * K * 2 + K * N + 2 * N * 4 + M * N * 4)
                        / spec.hbm_bw)
            t = dse.xproj_latency_s(cfg, task.timesteps, spec, max_batch=B)
            assert t >= bound
            bm, S = tk.xproj_tile(M, N, K, spec.sms)
            assert t == dse.xproj_plan_metrics(M, N, K, bm, S,
                                               spec).step_latency_s
            for bm in tk.XPROJ_BMS:
                for S in range(1, min(tk.XPROJ_MAX_SPLIT,
                                      tk.xproj_k_steps(K)) + 1):
                    p = dse.xproj_plan_metrics(M, N, K, bm, S, spec)
                    assert p.step_latency_s >= bound
                    assert p.n_tiles == -(-M // bm) * -(-N // 128) * S
                    assert 0 < p.util <= 1
