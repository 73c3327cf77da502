"""Port parity of the W8A16 matmul's plain version: the port's
``matmul_w8a16_plain`` and the ``qdot`` adapter (which runs it on the
CPU) against the JAX package's Pallas ``matmul_w8a16`` in interpret mode,
as tests/test_kernels.py runs it, and against ``matmul_w8a16_ref``, on
the same numpy inputs.  Shapes the Pallas kernel cannot tile (ragged M,
K, N) are held against the ref only.

Tolerance: both sides widen the int8 codes exactly, multiply exact bf16
values and sum the exact products in f32; only the order of the f32 sums
(and the last f32 ulp of exp/tanh in the epilogue) differs.  Where an
output lands on a bf16 rounding boundary the two round apart by one ulp
(2^-8 relative), so outputs are held to one ulp of the output's scale:
|port - jax| <= 2^-7 * max|jax|.  The decode kernel's split-K order of
sums (``ref.matmul_w8a16_split_plain`` over ``decode_geometry``'s
ranges) is held to the same bound.

The decode kernel's geometry (``decode_geometry``, ``split_ranges``) is
plain Python and is checked here; the kernel itself only on the card
(tests/test_torch_cuda_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import quantize_int8 as j_quantize_int8
from repro.kernels.matmul_int8 import ops as jops
from repro.kernels.matmul_int8.matmul_int8 import matmul_w8a16 as j_matmul
from repro.kernels.matmul_int8.ref import matmul_w8a16_ref as j_ref
from repro_torch import hw
from repro_torch.kernels.dispatch import tile_arg as dispatch_tile_arg
from repro_torch.kernels.matmul_int8 import matmul_int8 as tmm
from repro_torch.kernels.matmul_int8 import ops as tops
from repro_torch.kernels.matmul_int8 import ref as tref

TOL = 2.0 ** -7
ACTS = ("none", "silu", "gelu", "relu")


def _operands(seed, M, K, N, with_bias):
    """Seeded numpy operands: x (M, K), int8 codes with a scale per
    column from quantizing a random weight, a bias (or None)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    wq, sc = j_quantize_int8(jnp.asarray(w), axis=0)
    b = (rng.standard_normal(N) * 0.5).astype(np.float32) if with_bias \
        else None
    return x, np.array(wq), np.array(sc)[0], b


def _jax_args(x, wq, sc, b):
    return (jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(wq),
            jnp.asarray(sc), None if b is None else jnp.asarray(b))


def _torch_args(x, wq, sc, b):
    return (torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(wq),
            torch.from_numpy(sc), None if b is None else torch.from_numpy(b))


def _close(j_out, t_out):
    a = np.asarray(j_out, np.float32)
    b = t_out.float().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    assert t_out.dtype == torch.bfloat16 and np.isfinite(b).all()
    err = float(np.abs(a - b).max())
    assert err <= TOL * float(np.abs(a).max()), (err, TOL)
    return err


# M, K, N, bm, bn, bk: Pallas-legal (every tile divides)
LEGAL = [(16, 256, 256, 8, 128, 128), (8, 128, 384, 8, 128, 128)]


@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", LEGAL, ids=lambda s: "x".join(map(str, s[:3])))
def test_plain_matches_pallas_interpret(shape, act, with_bias):
    M, K, N, bm, bn, bk = shape
    ops = _operands(LEGAL.index(shape) * 10 + ACTS.index(act), M, K, N,
                    with_bias)
    j_out = j_matmul(*_jax_args(*ops), act=act, bm=bm, bn=bn, bk=bk,
                     interpret=True)
    t_out = tref.matmul_w8a16_plain(*_torch_args(*ops), act=act)
    _close(j_out, t_out)
    # the wrapper runs the plain version on CPU tensors, whatever the tile
    w_out = tmm.matmul_w8a16(*_torch_args(*ops), act=act, bm=bm, bn=bn,
                             bk=bk)
    assert torch.equal(w_out, t_out)
    _close(j_ref(*_jax_args(*ops), act=act), t_out)


RAGGED = [(3, 200, 300), (1, 77, 129), (33, 96, 40)]


@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", RAGGED, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_ref_on_ragged_shapes(shape, act, with_bias):
    M, K, N = shape
    ops = _operands(100 + RAGGED.index(shape), M, K, N, with_bias)
    _close(j_ref(*_jax_args(*ops), act=act),
           tref.matmul_w8a16_plain(*_torch_args(*ops), act=act))


def test_gelu_is_the_tanh_form_jax_uses():
    """``jax.nn.gelu`` defaults to ``approximate=True``; the erf form
    differs by up to ~1e-3, which the plain version must not."""
    v = np.linspace(-6, 6, 1001).astype(np.float32)
    j = np.asarray(jax.nn.gelu(jnp.asarray(v)))
    t = tref.EPILOGUES["gelu"](torch.from_numpy(v)).numpy()
    assert np.abs(j - t).max() <= 1e-6
    erf = torch.nn.functional.gelu(torch.from_numpy(v)).numpy()
    assert np.abs(j - erf).max() > 1e-4


PLANS = (None, {"bm": 256, "bn": 256, "bk": 512},
         {"bm": 100, "bn": 130, "bk": 70}, {"bm": 16, "bn": 32, "bk": 32})


@pytest.mark.parametrize("plan", PLANS, ids=lambda p: str(p))
def test_qdot_plan_tiles(plan):
    """qdot under a tile plan (including tiles that divide nothing) on the
    quantized leaf convention, against the Pallas qdot under the same
    plan (which snaps the tiles to divisors) and the ref, as
    tests/test_kernels.py::test_qdot_plan_tiles does."""
    M, K, N = 96, 256, 384
    x, wq, sc, _ = _operands(7, M, K, N, False)
    j_leaf = {"q": jnp.asarray(wq), "scale": jnp.asarray(sc)[None]}
    t_leaf = {"q": torch.from_numpy(wq), "scale": torch.from_numpy(sc)[None]}
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    t_out = tops.qdot(torch.from_numpy(x).to(torch.bfloat16), t_leaf,
                      plan=plan)
    _close(jops.qdot(xj, j_leaf, interpret=True, plan=plan), t_out)
    _close(j_ref(xj, jnp.asarray(wq), jnp.asarray(sc)), t_out)


def test_qdot_keeps_leading_dims_and_casts_x():
    """(..., K) in, (..., N) out; like the JAX adapter, x is taken in
    bf16 whatever its dtype."""
    x, wq, sc, b = _operands(8, 6, 64, 256, True)
    leaf = {"q": torch.from_numpy(wq), "scale": torch.from_numpy(sc)[None]}
    xt = torch.from_numpy(x).reshape(2, 3, 64)
    out = tops.qdot(xt, leaf, torch.from_numpy(b), act="silu")
    assert out.shape == (2, 3, 256) and out.dtype == torch.bfloat16
    flat = tref.matmul_w8a16_plain(torch.from_numpy(x), leaf["q"],
                                   leaf["scale"][0], torch.from_numpy(b),
                                   act="silu")
    assert torch.equal(out.reshape(6, 256), flat)


@pytest.mark.parametrize("M,N,K", [(1, 5120, 5120), (4, 1024, 5120),
                                   (4, 13824, 5120), (4, 5120, 13824),
                                   (2048, 13824, 5120), (3, 300, 200),
                                   (17, 33, 1), (129, 7, 4097)])
def test_kernel_tiles_are_legal_and_clamped(M, N, K):
    """Any requested tile becomes one the prefill kernel is built for, no
    larger than the shape needs, at its one K step; the adapter's
    defaults are decode tiles for M <= 16 and the DSE's pick above."""
    for req in ((0, 0, 0), (1, 1, 1), (16, 64, 128), (100, 130, 70),
                (256, 256, 512), (4096, 4096, 4096)):
        bm, bn, bk = tmm.kernel_tiles(*req, M, N, K)
        assert bm in tmm.BMS and bn in tmm.BNS and bk == tmm.BK
        assert bm == tmm.BMS[0] or bm // 2 < M
        assert bn == tmm.BNS[0] or bn // 2 < N
        assert bm <= max(req[0], tmm.BMS[0])
        assert tmm.smem_bytes(bm, bn, bk) <= 232448
    want = tops.DECODE_TILES if M <= 16 else tops.prefill_tiles(M, N, K)
    assert tops.default_tiles(M, N, K) == want
    assert tmm.kernel_tiles(*want, M, N, K) == want


@pytest.mark.parametrize("bm", tmm.BMS)
@pytest.mark.parametrize("bn", tmm.BNS)
def test_prefill_smem_fits_a_cta(bm, bn):
    """Every prefill tile's ring fits the 232,448 bytes a CTA may hold
    (csrc ``Pre::kSmem``: 5 stages of x and int8 w, 1 KB of alignment),
    and the staged bf16 output tile fits the ring."""
    smem = tmm.smem_bytes(bm, bn, tmm.BK)
    assert smem <= 232448
    assert smem == tmm.PREFILL_STAGES * (bm * tmm.BK * 2
                                         + tmm.BK * bn) + 1024
    assert bm * (bn * 2 + 16) <= smem - 1024
    if (bm, bn) == (256, 128):
        assert smem == 205824


# qwen2.5-14b's decode projections (K, N): wq/wo, wk/wv, w_gate/w_up, w_down
QWEN_DECODE = [(5120, 5120), (5120, 1024), (5120, 13824), (13824, 5120)]


@pytest.mark.parametrize("K,N", QWEN_DECODE + [(4097, 300), (200, 300),
                                              (1, 7), (64, 128), (65, 129)])
def test_decode_geometry_partitions_k(K, N):
    """At every split count the decode kernel takes, every K row lies in
    exactly one split, splits start on a K step, none is empty, and the
    CTA's shared memory fits; the default split gives qwen2.5-14b's decode
    shapes at least 2 CTAs per SM; a split count outside [1, K steps] or
    an M over 16 is refused."""
    steps = tmm.k_steps(K)
    assert steps == -(-K // tmm.DECODE_KSTEP)
    for S in sorted({1, 2, 3, 7, 33, steps} & set(range(1, steps + 1))):
        for M in (1, 4, 9, 16):
            geo = tmm.decode_geometry(M, N, K, S)
            assert geo.splits == S and len(geo.ranges) == S
            assert geo.bm == (8 if M <= 8 else 16) >= M
            assert (geo.bn, geo.kstep) == (tmm.DECODE_BN, tmm.DECODE_KSTEP)
            assert geo.ctas == -(-N // tmm.DECODE_BN) * S
            rows = [k for k0, k1 in geo.ranges for k in range(k0, k1)]
            assert rows == list(range(K))
            assert all(k0 % tmm.DECODE_KSTEP == 0 and k1 > k0
                       for k0, k1 in geo.ranges)
            assert 1 <= geo.steps_per_cta <= -(-steps // S)
            assert tmm.decode_smem_bytes(M) <= 232448
    geo = tmm.decode_geometry(4, N, K)
    assert geo.splits == tmm.default_splits(N, K)
    if (K, N) in QWEN_DECODE:
        assert geo.ctas >= 2 * hw.H100_SXM.sms
        assert geo.splits > 1
    for bad in (0, steps + 1):
        with pytest.raises(ValueError, match="splits"):
            tmm.decode_geometry(4, N, K, bad)
    with pytest.raises(ValueError, match="M <= 16"):
        tmm.decode_geometry(17, N, K)


@pytest.mark.parametrize("M", [1, 4])
@pytest.mark.parametrize("K", [5120, 13824, 4097])
def test_split_sums_match_pallas_interpret(K, M):
    """The decode kernel's arithmetic order (an f32 partial product per K
    range of the default geometry, the partials added in split order,
    then scale, bias, act, one rounding) against the Pallas
    ``matmul_w8a16`` in interpret mode (through the JAX qdot, which snaps
    its tiles to the shape) and against the port's one-range plain
    version."""
    N = 256
    x, wq, sc, b = _operands(200 + K + M, M, K, N, True)
    geo = tmm.decode_geometry(M, N, K)
    assert geo.splits > 1
    t_args = _torch_args(x, wq, sc, b)
    split = tref.matmul_w8a16_split_plain(*t_args, ranges=geo.ranges,
                                          act="silu")
    j_leaf = {"q": jnp.asarray(wq), "scale": jnp.asarray(sc)[None]}
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    _close(jops.qdot(xj, j_leaf, jnp.asarray(b), act="silu",
                     interpret=True), split)
    _close(tref.matmul_w8a16_plain(*t_args, act="silu").float().numpy(),
           split)


DECODE_PLANS = (None, {"splits": 3}, {"splits": 0}, {"splits": -2},
                {"splits": 10 ** 6}, {"bm": 256, "bn": 256, "bk": 512,
                                      "splits": 2})


@pytest.mark.parametrize("plan", DECODE_PLANS, ids=lambda p: str(p))
def test_qdot_decode_plan_splits(plan):
    """qdot at a decode M under plans that carry ``splits`` (including
    values the kernel refuses, which the adapter clamps or drops),
    against the Pallas qdot under the same plan and the ref."""
    M, K, N = 4, 1024, 384
    x, wq, sc, _ = _operands(9, M, K, N, False)
    want = tops.legal_splits(dispatch_tile_arg(plan, "splits", 0), K)
    if want is not None:
        assert 1 <= want <= tmm.k_steps(K)
        assert tmm.decode_geometry(M, N, K, want).splits == want
    j_leaf = {"q": jnp.asarray(wq), "scale": jnp.asarray(sc)[None]}
    t_leaf = {"q": torch.from_numpy(wq), "scale": torch.from_numpy(sc)[None]}
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    t_out = tops.qdot(torch.from_numpy(x).to(torch.bfloat16), t_leaf,
                      plan=plan)
    _close(jops.qdot(xj, j_leaf, interpret=True, plan=plan), t_out)
    _close(j_ref(xj, jnp.asarray(wq), jnp.asarray(sc)), t_out)


def test_legal_splits_clamps_to_the_k_steps():
    assert tops.legal_splits(0, 5120) is None
    assert tops.legal_splits(-5, 5120) is None
    assert tops.legal_splits(7, 5120) == 7
    assert tops.legal_splits(10 ** 6, 5120) == tmm.k_steps(5120) == 80
    assert tops.legal_splits(3, 1) == 1


def test_wrapper_refuses_other_devices():
    """Off the CPU the wrapper launches the kernel or raises: a tensor on
    a device that is neither gets an error, never the plain version."""
    x = torch.zeros((4, 64), device="meta", dtype=torch.bfloat16)
    w = torch.zeros((64, 256), device="meta", dtype=torch.int8)
    s = torch.zeros((256,), device="meta")
    before = dict(tmm.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tmm.matmul_w8a16(x, w, s)
    assert tmm.LAUNCHES == before
    assert set(tmm.LAUNCHES) == {"matmul_w8a16", "matmul_w8a16_prefill"}
