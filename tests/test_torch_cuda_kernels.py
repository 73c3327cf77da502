"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports only torch, numpy and the port, so it runs where JAX is absent:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_cuda_kernels.py

Where there is no CUDA card every test skips.  Tolerance: both sides sum
exact bf16 x int8/bf16 products in f32 in different orders, so a bf16 ulp
of y (or of the h fed back) may flip: 2e-2.  ``rwkv6_step`` runs the
same f32 recurrence as its plain version with another sum order (and
fused multiply-adds): its state agrees to 1e-4 relative to the state's
magnitude, y (bf16) to 2e-2.  ``flash_attention`` and ``flash_decode``
compute the same f32 scores, exponentials and sums as their plain
versions in another order (tensor-core sums for the prefill), so a bf16
ulp of p or of the output may flip: 2e-2 as well, with every output
finite, padding rows included.  ``matmul_w8a16`` sums the same exact
products in f32 as its plain version, in another order, and rounds once
to bf16: within 1e-2 of the output's largest magnitude (a bf16 ulp of
it, 2^-8, plus the f32 order difference).  Above M = 16 the prefill
kernel's tiles change no sum order, so every tile gives the same bits;
at M <= 16 the split-K decode kernel changes the f32 order with the
split count on purpose, so there each geometry is held to the plain
version and to its own bits over repeated calls.  The RNN input
projection (``xproj``) sums the same exact products in f32 on tensor
cores: within 1e-4 of its largest |zx|.  The decode loop's control
kernel computes integers: bit-equal to its plain version.  A decode
chunk replayed from its CUDA graph runs the same kernels on the same
inputs as the eager chunk: its ticks, tokens and caches are bit-equal.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import cells
from repro_torch.kernels.decode_loop import decode_loop as dl
from repro_torch.kernels.decode_loop import ref as dref
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import flash_decode as fd
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.kernels.fused_rnn import fused_rnn as tk
from repro_torch.kernels.fused_rnn import ref as tref
from repro_torch.kernels.matmul_int8 import matmul_int8 as mm
from repro_torch.kernels.matmul_int8 import ref as mref
from repro_torch.kernels.rwkv_step import ref as rref
from repro_torch.kernels.rwkv_step import rwkv_step as rk

TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(cell, H, D, B, T, wdtype, device, seed):
    G = 4 if cell == "lstm" else 3
    rng = np.random.default_rng(seed)
    s = (H + D) ** -0.5
    if wdtype == "int8":
        wx = torch.from_numpy(rng.integers(-127, 128, (D, G, H)).astype(np.int8))
        wh = torch.from_numpy(rng.integers(-127, 128, (H, G, H)).astype(np.int8))
        scale = s / 127
    else:
        wx = torch.from_numpy(rng.uniform(-s, s, (D, G, H))).to(torch.bfloat16)
        wh = torch.from_numpy(rng.uniform(-s, s, (H, G, H))).to(torch.bfloat16)
        scale = 1.0

    def f32(*shape, mul=1.0, add=0.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * mul + add).astype(np.float32))

    o = dict(x=f32(T, B, D).to(torch.bfloat16), w_x=wx, w_h=wh,
             s_x=f32(G, H).abs() * scale + scale / 2,
             s_h=f32(G, H).abs() * scale + scale / 2,
             b=f32(G, H, mul=0.1), b_h=f32(G, H, mul=0.1),
             h0=f32(B, H, mul=0.5), c0=f32(B, H, mul=0.5))
    return {k: v.to(device) for k, v in o.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("persistent", [False, True])
@pytest.mark.parametrize("cell,H,D,B,T,wdtype,bh", [
    ("lstm", 128, 128, 1, 6, "int8", 16), ("lstm", 96, 80, 5, 4, "int8", 48),
    ("gru", 256, 256, 3, 5, "int8", 32), ("gru", 64, 48, 2, 4, "bf16", 16),
    ("gru", 96, 80, 6, 3, "bf16", 24)])
def test_kernel_matches_plain(cuda_device, cell, H, D, B, T, wdtype, bh,
                              persistent):
    """Streaming (one projection, then T step launches on W_h) and
    persistent (the projection, then one launch for all T with W_h
    resident) against the function's plain version, state included."""
    o = _operands(cell, H, D, B, T, wdtype, cuda_device, seed=11)
    if persistent:  # the tile as ops.serve makes it legal (G * bh <= 128)
        bh = tk.legal_bh(4 if cell == "lstm" else 3, H, bh,
                         o["w_h"].element_size(), True)
    key = f"fused_{cell}" + ("_persistent" if persistent else "")
    before = tk.LAUNCHES[key]
    before_x = tk.LAUNCHES[f"fused_{cell}_xproj"]
    args = [o["x"], o["w_x"], o["w_h"], o["s_x"], o["s_h"], o["b"]]
    if cell == "lstm":
        got = tk.fused_lstm(*args, o["h0"], o["c0"], bh=bh,
                            persistent=persistent)
        want = tref.fused_lstm_ref(*args, o["h0"], o["c0"])
    else:
        got = tk.fused_gru(*args, o["b_h"], o["h0"], bh=bh,
                           persistent=persistent)
        want = tref.fused_gru_ref(*args, o["b_h"], o["h0"])
    torch.cuda.synchronize()
    assert tk.LAUNCHES[key] == before + (1 if persistent else T)
    assert tk.LAUNCHES[f"fused_{cell}_xproj"] == before_x + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float().cpu(), w.float().cpu(), **TOL)


# The projection against xproj_ref: both sum the same exact bf16 products
# in f32 (the kernel on tensor cores), in another order; within 1e-4 of
# the largest |zx| (K up to 2560 terms of either sign).
XPROJ_REL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("cell,H,D,B,T,wdtype", [
    ("gru", 96, 80, 5, 7, "int8"),      # T*B 35, G*H 288: ragged tiles
    ("gru", 90, 75, 1, 3, "int8"),      # N 270, K 75: no vector loads
    ("gru", 64, 200, 6, 5, "bf16"),     # bf16, K not a multiple of 32
    ("lstm", 256, 256, 4, 25, "int8"),
    ("gru", 2560, 2560, 1, 375, "int8")])   # gru-2560's main-path shape
def test_fused_xproj_kernel_matches_plain(cuda_device, cell, H, D, B, T, wdtype):
    o = _operands(cell, H, D, B, T, wdtype, cuda_device, seed=H + T)
    before = tk.LAUNCHES[f"fused_{cell}_xproj"]
    got = tk.xproj(o["x"], o["w_x"], o["s_x"], o["b"])
    want = tref.xproj_ref(o["x"], o["w_x"], o["s_x"], o["b"])
    torch.cuda.synchronize()
    assert tk.LAUNCHES[f"fused_{cell}_xproj"] == before + 1
    assert got.shape == want.shape and got.dtype == torch.float32
    err = float((got - want).abs().max())
    assert err <= XPROJ_REL * float(want.abs().max()), err
    again = tk.xproj(o["x"], o["w_x"], o["s_x"], o["b"])
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("cell,H,D,B,T", [("lstm", 2048, 2048, 4, 75),
                                          ("gru", 96, 80, 5, 7)])
def test_fused_xproj_tiles_and_unaligned_rows_are_bit_exact(cuda_device, cell,
                                                          H, D, B, T):
    """The int8 projection sums an output in one order at every bm (the
    tile follows M), and x and W off a 16-byte boundary (element-wise
    loads) give the bits of the aligned copies (TMA loads)."""
    o = _operands(cell, H, D, B, T, "int8", cuda_device, seed=31)
    x, w, sx, b = o["x"], o["w_x"], o["s_x"], o["b"]
    xu = torch.empty(x.numel() + 1, dtype=x.dtype,
                     device=cuda_device)[1:].view(x.shape)
    wu = torch.empty(w.numel() + 1, dtype=w.dtype,
                     device=cuda_device)[1:].view(w.shape)
    xu.copy_(x)
    wu.copy_(w)
    assert xu.data_ptr() % 16 and wu.data_ptr() % 16
    outs = [tk.xproj(x, w, sx, b, bm=bm) for bm in tk.XPROJ_BMS]
    assert all(torch.equal(z, outs[0]) for z in outs[1:])
    for bm, z in zip(tk.XPROJ_BMS, outs):
        assert torch.equal(tk.xproj(xu, wu, sx, b, bm=bm), z)
    want = tref.xproj_ref(x, w, sx, b)
    assert float((outs[0] - want).abs().max()) <= XPROJ_REL * float(
        want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("cell,H", [("lstm", 512), ("gru", 2560)])
def test_fused_xproj_batch_rows_equal_requests_alone(cuda_device, cell, H):
    """A B = 4, T = 5 batch (M = 20: a 32-row tile, or two 16-row ones) and
    each row alone (M = 5) take different bm and the same K splits, so
    every zx row is bit-equal."""
    o = _operands(cell, H, H, 4, 5, "int8", cuda_device, seed=33)
    args = (o["w_x"], o["s_x"], o["b"])
    batch = tk.xproj(o["x"], *args)
    for i in range(4):
        alone = tk.xproj(o["x"][:, i:i + 1].contiguous(), *args)
        assert torch.equal(batch[:, i:i + 1], alone)


@pytest.mark.cuda
def test_fused_xproj_refuses_a_tile_it_was_not_built_for(cuda_device):
    o = _operands("gru", 256, 256, 1, 3, "int8", cuda_device, seed=35)
    args = (o["x"], o["w_x"], o["s_x"], o["b"])
    before = tk.LAUNCHES["fused_gru_xproj"]
    for tile in (dict(bm=48), dict(bm=512), dict(splits=0),
                 dict(splits=tk.XPROJ_MAX_SPLIT + 1), dict(splits=5)):
        with pytest.raises(ValueError, match="tile"):
            tk.xproj(*args, **tile)   # K = 256: four steps, so 5 splits too
    ob = _operands("gru", 64, 48, 1, 3, "bf16", cuda_device, seed=36)
    with pytest.raises(ValueError, match="bf16"):
        tk.xproj(ob["x"], ob["w_x"], ob["s_x"], ob["b"], bm=16)
    assert tk.LAUNCHES["fused_gru_xproj"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("cell,H,ask", [("lstm", 1536, 1536),
                                        ("gru", 2048, 2048),
                                        ("gru", 1536, 1536),
                                        ("lstm", 1024, 8), ("gru", 2560, 24)])
def test_serve_runs_jax_plan_tiles(cuda_device, cell, H, ask):
    """``ops.serve`` on the card under a plan tile the step kernel cannot
    run as asked (the JAX DSE's whole-H tiles, plan tiles 8 and 24) makes
    it legal and serves, equal to the plain version."""
    cfg = cells.RNNCellConfig(cell, H, timesteps=6, precision="int8")
    gen = torch.Generator().manual_seed(H + ask)
    w = cells.quantize_weights(cfg, cells.init_weights(cfg, gen,
                                                       device=cuda_device))
    x = torch.randn((6, 1, H), generator=gen).to(cuda_device, torch.bfloat16)
    before = tk.LAUNCHES[f"fused_{cell}"]
    y = cells.serve(cfg, w, x, impl="kernel", plan={"bh": ask})
    want = cells.serve(cfg, w, x, impl="kernel", plan={"impl": "plain"})
    torch.cuda.synchronize()
    assert tk.LAUNCHES[f"fused_{cell}"] == before + 6
    torch.testing.assert_close(y.float().cpu(), want.float().cpu(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("cell,H,B,T,wdtype,bh", [
    ("lstm", 512, 4, 25, "int8", 16), ("gru", 1024, 1, 40, "int8", 16),
    ("gru", 2560, 1, 20, "int8", 64), ("lstm", 256, 3, 9, "bf16", 32)])
def test_fused_stream_steps_match_plain_and_repeat(cuda_device, cell, H, B, T,
                                             wdtype, bh):
    """The step kernel alone on one zx, against the plain recurrence over
    all T, and bit-equal over three calls."""
    o = _operands(cell, H, H, B, T, wdtype, cuda_device, seed=3)
    zx = tref.xproj_ref(o["x"], o["w_x"], o["s_x"], o["b"])
    if cell == "lstm":
        def run():
            return tk.lstm_steps(zx, o["w_h"], o["s_h"], o["h0"], o["c0"],
                                 bh=bh)
        want = tref.lstm_steps_ref(zx, o["w_h"], o["s_h"], o["h0"], o["c0"])
    else:
        def run():
            return tk.gru_steps(zx, o["w_h"], o["s_h"], o["b_h"], o["h0"],
                                bh=bh)
        want = tref.gru_steps_ref(zx, o["w_h"], o["s_h"], o["b_h"], o["h0"])
    runs = [run() for _ in range(3)]
    torch.cuda.synchronize()
    for g, w in zip(runs[0], want):
        torch.testing.assert_close(g.float().cpu(), w.float().cpu(), **TOL)
    for r in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], r))


@pytest.mark.cuda
@pytest.mark.parametrize("cell,bh", [("lstm", 16), ("gru", 64)])
def test_fused_stream_batch_rows_equal_requests_alone(cuda_device, cell, bh):
    """Neither kernel's sum order depends on the batch: each row of a
    6-row call (two passes of the step kernel) is bit-equal to that row
    served alone, through the projection and the steps."""
    H, T, B = 512, 7, 6
    o = _operands(cell, H, H, B, T, "int8", cuda_device, seed=21)
    args = [o["w_x"], o["w_h"], o["s_x"], o["s_h"], o["b"]]
    if cell == "lstm":
        def run(x, h0, c0):
            return tk.fused_lstm(x, *args, h0, c0, bh=bh)
    else:
        def run(x, h0, c0):
            return tk.fused_gru(x, *args, o["b_h"], h0, bh=bh) + (None,)
    batch = run(o["x"], o["h0"], o["c0"])
    for i in range(B):
        alone = run(o["x"][:, i:i + 1].contiguous(), o["h0"][i:i + 1],
                    o["c0"][i:i + 1])
        assert torch.equal(batch[0][:, i:i + 1], alone[0])
        assert torch.equal(batch[1][i:i + 1], alone[1])
        if cell == "lstm":
            assert torch.equal(batch[2][i:i + 1], alone[2])


@pytest.mark.cuda
def test_fused_stream_refuses_tiles_it_was_not_built_for(cuda_device):
    """The step kernel reads 16-byte chunks of one (row, gate): an int8
    tile of 8 units, or one that does not divide H, is refused."""
    o = _operands("gru", 96, 96, 1, 2, "int8", cuda_device, seed=2)
    for bh in (8, 40):
        with pytest.raises(ValueError, match="bh"):
            tk.fused_gru(o["x"], o["w_x"], o["w_h"], o["s_x"], o["s_h"],
                         o["b"], o["b_h"], o["h0"], bh=bh)


@pytest.mark.cuda
def test_persistent_refuses_a_grid_that_cannot_be_resident(cuda_device):
    """GRU at H=4096 holds 50.3 MB of int8 W_h, more than the shared memory
    of every CTA the card can hold at once (132 x 227 KB ~ 30.7 MB), so at
    any tile and cluster size the wrapper raises before launching
    anything, the projection included."""
    o = _operands("gru", 4096, 64, 1, 1, "int8", cuda_device, seed=1)
    before = dict(tk.LAUNCHES)
    for bh in (16, 32):
        with pytest.raises(ValueError, match="co-resident"):
            tk.fused_gru(o["x"], o["w_x"], o["w_h"], o["s_x"], o["s_h"],
                         o["b"], o["b_h"], o["h0"], bh=bh, persistent=True)
    assert tk.LAUNCHES == before


def _persistent_run(cell, o, bh):
    args = [o["w_x"], o["w_h"], o["s_x"], o["s_h"], o["b"]]
    if cell == "lstm":
        def run(x, h0, c0):
            return tk.fused_lstm(x, *args, h0, c0, bh=bh, persistent=True)
    else:
        def run(x, h0, c0):
            return tk.fused_gru(x, *args, o["b_h"], h0, bh=bh,
                                persistent=True) + (None,)
    return run


@pytest.mark.cuda
@pytest.mark.parametrize("cell,H,B,T,wdtype,bh", [
    ("lstm", 2048, 1, 6, "int8", 16), ("gru", 2560, 1, 6, "int8", 20),
    ("gru", 2560, 4, 4, "int8", 40), ("lstm", 512, 10, 5, "int8", 8),
    ("gru", 96, 3, 7, "bf16", 12), ("lstm", 100, 2, 5, "int8", 20)])
def test_fused_persistent_matches_plain_and_repeats(cuda_device, cell, H, B,
                                                    T, wdtype, bh):
    """The persistent kernel at full width (lstm-2048, gru-2560 at a lone
    CTA a tile and in clusters of 2), two batch passes (B = 10), bf16
    weights and H off the 32-row k-step, against the plain version over
    all T, and bit-equal over three calls."""
    o = _operands(cell, H, H, B, T, wdtype, cuda_device, seed=H + B)
    run = _persistent_run(cell, o, bh)
    want = (tref.fused_lstm_ref if cell == "lstm" else tref.fused_gru_ref)(
        *([o["x"], o["w_x"], o["w_h"], o["s_x"], o["s_h"], o["b"]]
          + ([o["h0"], o["c0"]] if cell == "lstm" else [o["b_h"], o["h0"]])))
    runs = [run(o["x"], o["h0"], o["c0"]) for _ in range(3)]
    torch.cuda.synchronize()
    for g, w in zip(runs[0], want):
        torch.testing.assert_close(g.float().cpu(), w.float().cpu(), **TOL)
    for r in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], r)
                   if a is not None)


@pytest.mark.cuda
@pytest.mark.parametrize("cell,H,B,bh", [("lstm", 512, 10, 16),
                                         ("gru", 2560, 4, 40)])
def test_fused_persistent_batch_rows_equal_requests_alone(cuda_device, cell,
                                                          H, B, bh):
    """The persistent kernel's sum order depends on the tile and the card,
    never on the batch: each row of a 10-row call (two passes) or of a
    4-row call in clusters of 2 is bit-equal to that row served alone."""
    T = 4
    o = _operands(cell, H, H, B, T, "int8", cuda_device, seed=5)
    run = _persistent_run(cell, o, bh)
    batch = run(o["x"], o["h0"], o["c0"])
    for i in range(B):
        alone = run(o["x"][:, i:i + 1].contiguous(), o["h0"][i:i + 1],
                    o["c0"][i:i + 1])
        assert torch.equal(batch[0][:, i:i + 1], alone[0])
        assert torch.equal(batch[1][i:i + 1], alone[1])
        if cell == "lstm":
            assert torch.equal(batch[2][i:i + 1], alone[2])


@pytest.mark.cuda
def test_serve_kernel_matches_blas(cuda_device):
    cfg = cells.RNNCellConfig("lstm", 256, timesteps=8, precision="int8")
    gen = torch.Generator().manual_seed(0)
    w = cells.quantize_weights(cfg, cells.init_weights(cfg, gen,
                                                       device=cuda_device))
    x = torch.randn((8, 2, 256), generator=gen).to(cuda_device, torch.bfloat16)
    y = cells.serve(cfg, w, x, impl="kernel")
    ref = cells.serve(cfg, w, x, impl="blas")
    assert y.is_cuda and y.dtype == torch.bfloat16
    assert float((y.float() - ref).abs().max()) < 5e-2


def _rwkv_operands(T, B, H, K, V, device, seed):
    """bf16 r/k/v, f32 log-decays spanning the model's clip range, a
    nonzero bonus and state."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(device)
    w = -np.exp(rng.uniform(-8.0, 3.0, (T, B, H, K))).astype(np.float32)
    return [f32(T, B, H, K).to(torch.bfloat16),
            f32(T, B, H, K).to(torch.bfloat16),
            f32(T, B, H, V).to(torch.bfloat16),
            torch.from_numpy(w).to(device), f32(H, K), f32(B, H, K, V)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H,K,V,bh", [
    (1, 1, 32, 64, 64, 1), (1, 4, 32, 64, 64, 4), (16, 2, 32, 64, 64, 32),
    (3, 3, 4, 16, 16, 1), (2, 2, 4, 16, 64, 2), (2, 1, 6, 64, 16, 3)])
def test_rwkv6_step_matches_plain(cuda_device, T, B, H, K, V, bh):
    o = _rwkv_operands(T, B, H, K, V, cuda_device, seed=T * 100 + B)
    before = rk.LAUNCHES["rwkv6_step"]
    y, s = rk.rwkv6_step(*o, bh=bh)
    y_p, s_p = rref.rwkv6_step_ref(*o)
    torch.cuda.synchronize()
    assert rk.LAUNCHES["rwkv6_step"] == before + 1
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    torch.testing.assert_close(y.float().cpu(), y_p.float().cpu(), **TOL)
    scale = float(s_p.abs().max())
    assert float((s - s_p).abs().max()) <= 1e-4 * scale
    assert torch.equal(o[5], _rwkv_operands(T, B, H, K, V, cuda_device,
                                            seed=T * 100 + B)[5])


@pytest.mark.cuda
def test_rwkv6_step_head_tiles_are_bit_exact(cuda_device):
    o = _rwkv_operands(5, 2, 32, 64, 64, cuda_device, seed=9)
    y0, s0 = rk.rwkv6_step(*o, bh=32)
    for bh in (1, 2, 4, 8, 16):
        y, s = rk.rwkv6_step(*o, bh=bh)
        assert torch.equal(y, y0) and torch.equal(s, s0)


@pytest.mark.cuda
def test_rwkv6_step_refuses_what_it_was_not_built_for(cuda_device):
    o = _rwkv_operands(1, 1, 2, 32, 32, cuda_device, seed=1)
    with pytest.raises(ValueError, match="built"):
        rk.rwkv6_step(*o)
    o = _rwkv_operands(1, 1, 4, 16, 16, cuda_device, seed=1)
    with pytest.raises(ValueError, match="divide"):
        rk.rwkv6_step(*o, bh=3)
    with pytest.raises(ValueError, match="bf16"):
        rk.rwkv6_step(o[0].float(), *o[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("K,V", [(64, 64), (16, 64)])
def test_rwkv6_step_every_slab_is_bit_exact(cuda_device, K, V):
    """Every legal column slab bv, at head tiles 1 and 4, gives the
    default geometry's bits: a column's sums run in an order fixed by K."""
    o = _rwkv_operands(5, 2, 32, K, V, cuda_device, seed=11)
    y0, s0 = rk.rwkv6_step(*o)
    for bh in (1, 4):
        for bv in (4, 8, 16, 32, 64):
            y, s = rk.rwkv6_step(*o, bh=bh, bv=bv)
            assert torch.equal(y, y0) and torch.equal(s, s0), (bh, bv)


@pytest.mark.cuda
@pytest.mark.parametrize("bv", [0, 4, 64])
def test_rwkv6_step_carries_sixteen_tokens_in_registers(cuda_device, bv):
    o = _rwkv_operands(16, 2, 32, 64, 64, cuda_device, seed=16)
    y, s = rk.rwkv6_step(*o, bv=bv)
    y_p, s_p = rref.rwkv6_step_ref(*o)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float().cpu(), y_p.float().cpu(), **TOL)
    assert float((s - s_p).abs().max()) <= 1e-4 * float(s_p.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("bv", [0, 4, 16, 64])
def test_rwkv6_step_leaves_the_input_state_unchanged(cuda_device, bv):
    o = _rwkv_operands(3, 4, 32, 64, 64, cuda_device, seed=21)
    before = o[5].clone()
    _, s = rk.rwkv6_step(*o, bv=bv)
    torch.cuda.synchronize()
    assert torch.equal(o[5], before)
    assert s.data_ptr() != o[5].data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("bv", [2, 3, 12, 128])
def test_rwkv6_step_refuses_an_illegal_slab(cuda_device, bv):
    o = _rwkv_operands(1, 1, 32, 64, 64, cuda_device, seed=1)
    before = rk.LAUNCHES["rwkv6_step"]
    with pytest.raises(ValueError, match="bv"):
        rk.rwkv6_step(*o, bv=bv)
    assert rk.LAUNCHES["rwkv6_step"] == before


@pytest.mark.cuda
def test_reduced_lm_decode_kernel_matches_plain(cuda_device):
    from repro_torch.models.lm import build_model
    from repro_torch.testing import reduced_config

    model = build_model(reduced_config("rwkv6-1.6b"))
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = model.serving_params(model.init(gen, cuda_device))
    params["blocks"]["p0"]["bonus"].normal_(0, 0.5, generator=gen)
    toks = torch.randint(0, 503, (3, 8), device=cuda_device,
                         generator=gen).to(torch.int32)
    cache, logits = model.prefill(params, {"tokens": toks})
    t = torch.argmax(logits, -1).to(torch.int32)
    plain = model.with_tile_plans({"rwkv": {"impl": "plain"}})
    before = rk.LAUNCHES["rwkv6_step"]
    c_k, l_k = model.decode_step(params, cache, t)
    c_p, l_p = plain.decode_step(params, cache, t)
    torch.cuda.synchronize()
    assert rk.LAUNCHES["rwkv6_step"] == before + model.cfg.n_layers
    scale = float(l_p.abs().max())
    assert float((l_k - l_p).abs().max()) <= 4e-2 * scale


def _bf16(rng, *shape, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device, torch.bfloat16)


def _prefill_positions(B, S, n_valid, device):
    """Right-padded rows: position i for i < n_valid[b], else -1."""
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    pos[np.arange(S)[None, :] >= np.asarray(n_valid)[:, None]] = -1
    return torch.from_numpy(pos).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,S,d,causal,window,cap,bq,bk,pad", [
    (2, 4, 2, 100, 64, True, 0, 0.0, 64, 64, True),     # ragged, GQA, padding
    (1, 2, 2, 256, 128, True, 64, 0.0, 64, 128, False),  # window
    (1, 2, 1, 77, 16, False, 0, 30.0, 64, 64, False),   # softcap, non-causal
    (4, 40, 8, 512, 128, True, 0, 0.0, 128, 128, True),  # qwen2.5-14b prefill
    (1, 40, 8, 1023, 128, True, 0, 0.0, 128, 64, False),
    (2, 8, 2, 300, 128, True, 100, 50.0, 128, 128, True),  # window + cap, skipped tiles
    (2, 4, 4, 200, 32, True, 0, 0.0, 128, 64, True),    # d 32
    (4, 32, 4, 512, 128, True, 0, 0.0, 64, 64, True),   # qwen3-moe, G=8
    (4, 16, 8, 512, 64, True, 0, 0.0, 64, 64, True),    # granite-moe, G=2
    (4, 25, 5, 2048, 64, True, 1024, 0.0, 64, 64, True),  # hymba swa, G=5
    (4, 25, 5, 2048, 64, True, 0, 0.0, 64, 64, True),   # hymba attn
    (1, 6, 2, 130, 16, True, 0, 0.0, 64, 128, True),    # d 16, one padding row
])
def test_flash_attention_matches_plain(cuda_device, B, H, Hkv, S, d, causal,
                                       window, cap, bq, bk, pad):
    rng = np.random.default_rng(S + d)
    q = _bf16(rng, B, H, S, d, device=cuda_device)
    k = _bf16(rng, B, Hkv, S, d, device=cuda_device)
    v = _bf16(rng, B, Hkv, S, d, device=cuda_device)
    n_valid = [S - 7 * b if pad else S for b in range(B)]
    pos = _prefill_positions(B, S, n_valid, cuda_device)
    kw = dict(causal=causal, window=window, softcap=cap)
    before = fa.LAUNCHES["flash_attention"]
    out = fa.flash_attention(q, k, v, pos, pos, bq=bq, bk=bk, **kw)
    want = fref.flash_attention_plain(q, k, v, pos, pos, bk=fa.SUB, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (B, H, S, d)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float().cpu(), want.float().cpu(), **TOL)
    # neither tile changes a bit (the softmax steps by SUB keys, skipped
    # tiles add exactly 0), and a repeated call gives the same bits
    for bq2, bk2 in ((bq, bk), (fa.WG_ROWS, fa.SUB), (fa.MAX_BQ, fa.MAX_BK)):
        out2 = fa.flash_attention(q, k, v, pos, pos, bq=bq2, bk=bk2, **kw)
        assert torch.equal(out, out2), (bq2, bk2)


@pytest.mark.cuda
@pytest.mark.parametrize("bq", [64, 128])
def test_flash_attention_rows_that_see_no_key_are_the_mean_of_v(
        cuda_device, bq):
    """Causal padding rows (q_pos = -1): a batch row of length 0, query
    tiles of real and padding rows, and tiles of padding alone.  Their
    output is the mean of V over all keys, as the plain version's."""
    rng = np.random.default_rng(bq)
    B, H, Hkv, S, d = 4, 8, 2, 320, 128
    q = _bf16(rng, B, H, S, d, device=cuda_device)
    k = _bf16(rng, B, Hkv, S, d, device=cuda_device)
    v = _bf16(rng, B, Hkv, S, d, device=cuda_device)
    pos = _prefill_positions(B, S, [0, 100, 64, 300], cuda_device)
    out = fa.flash_attention(q, k, v, pos, pos, bq=bq, bk=128)
    want = fref.flash_attention_plain(q, k, v, pos, pos, bk=fa.SUB)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float().cpu(), want.float().cpu(), **TOL)
    mean = v.float().mean(dim=2).repeat_interleave(H // Hkv, dim=1)
    pad = (pos < 0).cpu()
    for b in range(B):
        got = out[b].float().cpu()[:, pad[b]]
        torch.testing.assert_close(
            got, mean[b].cpu()[:, None].expand_as(got), **TOL)


@pytest.mark.cuda
def test_flash_attention_queries_after_a_cached_prefix(cuda_device):
    """Sq != Skv: bucket-padded queries at the end of longer key rows."""
    rng = np.random.default_rng(3)
    B, H, Hkv, Sq, Skv, d = 3, 8, 2, 96, 320, 128
    q = _bf16(rng, B, H, Sq, d, device=cuda_device)
    k = _bf16(rng, B, Hkv, Skv, d, device=cuda_device)
    v = _bf16(rng, B, Hkv, Skv, d, device=cuda_device)
    kv_len, q_len = [320, 250, 40], [96, 70, 5]
    kv_pos = _prefill_positions(B, Skv, kv_len, cuda_device)
    qp = np.full((B, Sq), -1, dtype=np.int32)
    for b in range(B):
        qp[b, :q_len[b]] = np.arange(kv_len[b] - q_len[b], kv_len[b])
    q_pos = torch.from_numpy(qp).to(cuda_device)
    for bq, bk in ((64, 64), (128, 128)):
        out = fa.flash_attention(q, k, v, q_pos, kv_pos, bq=bq, bk=bk)
        want = fref.flash_attention_plain(q, k, v, q_pos, kv_pos, bk=fa.SUB)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(out).all())
        torch.testing.assert_close(out.float().cpu(), want.float().cpu(),
                                   **TOL)


@pytest.mark.cuda
def test_flash_attention_iota_path_matches_naive_oracle(cuda_device):
    rng = np.random.default_rng(5)
    q, k, v = (_bf16(rng, 2, 2, 128, 64, device=cuda_device)
               for _ in range(3))
    out = fa.flash_attention(q, k, v, causal=True)
    want = fref.attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(out.float().cpu(), want.float().cpu(), **TOL)


def _decode_positions(B, S, holes, device):
    """kv_pos (B, S), q_pos (B,) of a decode case: iota (holes False);
    every 5th slot and the second half empty (True); or a wrapped ring
    cache ("ring") whose slot s holds the last position congruent to s,
    with every 7th slot empty, so slot order is not position order."""
    kvp = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    qp = np.full((B,), S // 2 - 1, np.int32)
    if holes == "ring":
        last = np.asarray([S + 300 + 211 * b for b in range(B)], np.int32)
        kvp = last[:, None] - (last[:, None] - np.arange(S)[None]) % S
        kvp[:, np.arange(S) % 7 == 5] = -1
        qp = last
    elif holes:
        kvp[:, np.arange(S) % 5 == 3] = -1
        kvp[:, S // 2:] = -1        # an unfilled tail: whole empty chunks
    return (torch.from_numpy(kvp.astype(np.int32)).to(device),
            torch.from_numpy(qp.astype(np.int32)).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,S,d,bk,causal,window,cap,holes", [
    (4, 40, 8, 1024, 128, 128, True, 0, 0.0, True),   # qwen2.5-14b decode
    (2, 4, 2, 300, 64, 128, True, 64, 0.0, False),    # ragged chunk, window
    (1, 2, 2, 77, 16, 32, False, 0, 30.0, True),      # softcap, tiny dim
    (3, 16, 1, 200, 32, 512, True, 0, 0.0, True),     # one chunk, G=16
    (4, 40, 8, 1024, 128, 64, True, 0, 0.0, True),    # bk 64
    (4, 40, 8, 1024, 128, 256, True, 0, 0.0, True),   # bk 256
    (2, 40, 8, 1024, 128, 512, True, 0, 0.0, True),   # bk 512 (Pallas default)
    (1, 8, 2, 2100, 64, 1024, True, 0, 0.0, True),    # the largest chunk
    (2, 32, 2, 600, 128, 128, True, 0, 0.0, True),    # G=16 at d 128
    (4, 32, 4, 1024, 128, 128, True, 0, 0.0, True),   # qwen3-moe decode, G=8
    (4, 16, 8, 1024, 64, 128, True, 0, 0.0, True),    # granite-moe, G=2
    (2, 40, 8, 1024, 128, 128, True, 300, 0.0, "ring"),  # ring + window
    (2, 8, 2, 512, 64, 100, True, 0, 20.0, "ring"),   # ring, ragged tiles
    (4, 25, 5, 1024, 64, 128, True, 1024, 0.0, "ring"),  # hymba swa ring
    (4, 25, 5, 2048, 64, 128, True, 0, 0.0, True),    # hymba attn, G=5
])
def test_flash_decode_matches_plain(cuda_device, B, H, Hkv, S, d, bk,
                                    causal, window, cap, holes):
    rng = np.random.default_rng(S + B)
    q = _bf16(rng, B, H, d, device=cuda_device)
    k = _bf16(rng, B, Hkv, S, d, device=cuda_device)
    v = _bf16(rng, B, Hkv, S, d, device=cuda_device)
    kv_pos, q_pos = _decode_positions(B, S, holes, cuda_device)
    kw = dict(causal=causal, window=window, softcap=cap, bk=bk)
    before = fd.LAUNCHES["flash_decode"]
    out = fd.flash_decode(q, k, v, kv_pos, q_pos, **kw)
    want = fref.flash_decode_plain(q, k, v, kv_pos, q_pos, **kw)
    torch.cuda.synchronize()
    assert fd.LAUNCHES["flash_decode"] == before + 1
    assert out.dtype == torch.float32 and tuple(out.shape) == (B, H, d)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.cpu(), want.cpu(), **TOL)
    # no atomics: three calls, one set of bits
    for _ in range(2):
        assert torch.equal(out, fd.flash_decode(q, k, v, kv_pos, q_pos,
                                                **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("bk", [64, 128])
def test_flash_decode_rows_that_see_no_key_are_the_mean_of_v(cuda_device,
                                                             bk):
    """A row with q_pos = -1 and a row whose kv_pos is all -1 see no key:
    the kernel computes their chunks in full and gives the mean of V over
    all slots, as the plain version does; the third row sees keys."""
    rng = np.random.default_rng(bk)
    B, H, Hkv, S, d = 3, 40, 8, 1024, 128
    q = _bf16(rng, B, H, d, device=cuda_device)
    k = _bf16(rng, B, Hkv, S, d, device=cuda_device)
    v = _bf16(rng, B, Hkv, S, d, device=cuda_device)
    kvp = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    kvp[1] = -1
    kvp[2, 300:] = -1
    kv_pos = torch.from_numpy(kvp).to(cuda_device)
    q_pos = torch.tensor([-1, 50, 299], dtype=torch.int32,
                         device=cuda_device)
    out = fd.flash_decode(q, k, v, kv_pos, q_pos, bk=bk)
    want = fref.flash_decode_plain(q, k, v, kv_pos, q_pos, bk=bk)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.cpu(), want.cpu(), **TOL)
    mean = v.float().mean(dim=2).repeat_interleave(H // Hkv, dim=1).cpu()
    torch.testing.assert_close(out[:2].cpu(), mean[:2], **TOL)


@pytest.mark.cuda
def test_flash_decode_adapter_makes_a_plan_chunk_legal(cuda_device):
    """The model adapter runs any plan's chunk (made legal by
    ``decode_bk``: 2048 becomes 1024 over 1500 slots), against the plain
    version at the same legal chunk; caches off a 16-byte boundary are
    copied; the wrapper refuses a chunk past ``MAX_BK``."""
    from repro_torch.kernels.flash_attention import ops as aops

    rng = np.random.default_rng(9)
    B, H, Hkv, S, d = 2, 8, 2, 1500, 64
    q = _bf16(rng, B, H, d, device=cuda_device)
    flat = _bf16(rng, 2 * B * S * Hkv * d + 1, device=cuda_device)
    kc = flat[1:1 + B * S * Hkv * d].view(B, S, Hkv, d)     # misaligned
    vc = flat[-B * S * Hkv * d:].view(B, S, Hkv, d)
    kv_pos = torch.arange(S, dtype=torch.int32,
                          device=cuda_device).repeat(B, 1)
    q_pos = torch.tensor([S - 1, 700], dtype=torch.int32, device=cuda_device)
    for ask in (2048, 5):
        bk = fd.decode_bk(ask, S)
        assert bk == (fd.MAX_BK if ask > fd.MAX_BK else ask)
        out = aops.decode(q, kc, vc, kv_pos, q_pos, plan={"bk": ask})
        want = fref.flash_decode_plain(q, kc.transpose(1, 2),
                                       vc.transpose(1, 2), kv_pos, q_pos,
                                       bk=bk)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float().cpu(),
                                   want.to(torch.bfloat16).float().cpu(),
                                   **TOL)
    with pytest.raises(ValueError, match="chunk"):
        fd.flash_decode(q, kc.transpose(1, 2), vc.transpose(1, 2), kv_pos,
                        q_pos, bk=2048)


@pytest.mark.cuda
def test_flash_kernels_refuse_what_they_were_not_built_for(cuda_device):
    rng = np.random.default_rng(1)
    q = _bf16(rng, 1, 2, 8, 48, device=cuda_device)
    with pytest.raises(ValueError, match="built"):
        fa.flash_attention(q, q, q)
    q = _bf16(rng, 1, 2, 8, 64, device=cuda_device)
    for bq, bk in ((24, 64), (32, 64), (64, 192), (256, 128)):
        with pytest.raises(ValueError, match="tile"):
            fa.flash_attention(q, q, q, bq=bq, bk=bk)
    with pytest.raises(ValueError, match="bf16"):
        fa.flash_attention(q.float(), q, q)
    qd = _bf16(rng, 1, 34, 64, device=cuda_device)
    kc = _bf16(rng, 1, 2, 8, 64, device=cuda_device)
    pos = torch.zeros((1, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="at most"):
        fd.flash_decode(qd, kc, kc, pos, pos[:, 0])


@pytest.mark.cuda
def test_reduced_qwen_kernel_path_matches_plain(cuda_device):
    from repro_torch.models.lm import build_model
    from repro_torch.testing import reduced_config

    model = build_model(reduced_config("qwen2.5-14b"))
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = model.init_serving(gen, cuda_device)
    for name in ("bq", "bk", "bv"):
        params["blocks"]["p0"]["attn"][name].normal_(0, 0.5, generator=gen)
    toks = torch.randint(0, 503, (3, 16), device=cuda_device,
                         generator=gen).to(torch.int32)
    lens = torch.tensor([16, 9, 1], dtype=torch.int32, device=cuda_device)
    plain = model.with_tile_plans({"attn": {"impl": "plain"}})
    n_pre = fa.LAUNCHES["flash_attention"]
    cache, logits = model.prefill(params, {"tokens": toks, "lengths": lens},
                                  max_len=32)
    cache_p, logits_p = plain.prefill(params, {"tokens": toks,
                                               "lengths": lens}, max_len=32)
    assert fa.LAUNCHES["flash_attention"] == n_pre + model.cfg.n_layers
    scale = float(logits_p.abs().max())
    assert float((logits - logits_p).abs().max()) <= 4e-2 * scale
    t = torch.argmax(logits_p, -1).to(torch.int32)
    n_dec = fd.LAUNCHES["flash_decode"]
    c_k, l_k = model.decode_step(params, cache_p, t)
    c_p, l_p = plain.decode_step(params, cache_p, t)
    torch.cuda.synchronize()
    assert fd.LAUNCHES["flash_decode"] == n_dec + model.cfg.n_layers
    scale = float(l_p.abs().max())
    assert float((l_k - l_p).abs().max()) <= 4e-2 * scale


MM_REL = 1e-2


def _mm_operands(M, K, N, device, seed, with_bias=True):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8))
    sc = torch.from_numpy(rng.uniform(0.5, 1.5, N).astype(np.float32)
                          / (127 * np.sqrt(K)))
    b = torch.from_numpy(rng.standard_normal(N).astype(np.float32) * 0.5)
    return (x.to(device, torch.bfloat16), w.to(device), sc.to(device),
            b.to(device) if with_bias else None)


def _mm_close(got, want):
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    err = float((got.float() - want.float()).abs().max())
    assert err <= MM_REL * float(want.float().abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("act", ["none", "silu", "gelu", "relu"])
def test_matmul_w8a16_epilogues_match_plain(cuda_device, act, with_bias):
    o = _mm_operands(4, 512, 768, cuda_device, seed=20, with_bias=with_bias)
    before = mm.LAUNCHES["matmul_w8a16"]
    got = mm.matmul_w8a16(*o, act=act)
    torch.cuda.synchronize()
    assert mm.LAUNCHES["matmul_w8a16"] == before + 1
    _mm_close(got, mref.matmul_w8a16_plain(*o, act=act))


# qwen2.5-14b's prefill projections (K, N): wq/wo, wk/wv, w_gate/w_up, w_down
MM_PREFILL = [(5120, 5120), (5120, 1024), (5120, 13824), (13824, 5120)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(1, 5120, 5120), (4, 5120, 1024),
                                   (4, 13824, 5120), (300, 512, 1040),
                                   (3, 200, 300), (33, 96, 40), (5, 7, 3)]
                         + [(2048, K, N) for K, N in MM_PREFILL]
                         + [(128, 5120, 13824)])
def test_matmul_w8a16_shapes_match_plain(cuda_device, M, K, N):
    """qwen2.5-14b's decode shapes, its prefill projections at M = 2048
    (a 4-row bucket-512 prefill) and w_gate at M = 128, a multi-tile
    prefill, and ragged shapes (rows not 16-byte aligned take the
    element-wise loads), each at the adapter's default tile."""
    from repro_torch.kernels.matmul_int8.ops import default_tiles
    o = _mm_operands(M, K, N, cuda_device, seed=M + N)
    tiles = mm.kernel_tiles(*default_tiles(M, N, K), M, N, K)
    _mm_close(mm.matmul_w8a16(*o, act="silu", bm=tiles[0], bn=tiles[1],
                              bk=tiles[2]),
              mref.matmul_w8a16_plain(*o, act="silu"))


@pytest.mark.cuda
def test_matmul_w8a16_tiles_are_bit_exact(cuda_device):
    """Every prefill tile sums each output's products in the same k order
    (k16 slices, then K steps, in order), so all (bm, bn) give the same
    bits, on repeated calls too; so do the aligned and the element-wise
    loads."""
    x, w, sc, b = _mm_operands(40, 320, 300, cuda_device, seed=21)
    outs = [mm.matmul_w8a16(x, w, sc, b, bm=bm, bn=bn, bk=mm.BK)
            for bm in mm.BMS for bn in mm.BNS for _ in range(2)]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    _mm_close(outs[0], mref.matmul_w8a16_plain(x, w, sc, b))
    # N = 300 takes the element-wise path, its first 288 columns the TMA one
    part = mm.matmul_w8a16(x, w[:, :288].contiguous(), sc[:288], b[:288])
    assert torch.equal(part, outs[0][:, :288])


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("act", ["none", "silu", "gelu", "relu"])
def test_matmul_w8a16_prefill_epilogues_match_plain(cuda_device, act,
                                                    with_bias):
    o = _mm_operands(300, 1024, 768, cuda_device, seed=26,
                     with_bias=with_bias)
    before = dict(mm.LAUNCHES)
    got = mm.matmul_w8a16(*o, act=act)
    torch.cuda.synchronize()
    assert mm.LAUNCHES == {k: v + 1 for k, v in before.items()}
    _mm_close(got, mref.matmul_w8a16_plain(*o, act=act))


@pytest.mark.cuda
def test_matmul_w8a16_prefill_repeats_and_unaligned_rows(cuda_device):
    """At a multi-wave prefill shape three calls give the same bits, and
    x and w that start off a 16-byte boundary (element-wise loads) give
    the bits of the aligned copies (TMA loads), at every tile."""
    x, w, sc, b = _mm_operands(2048, 5120, 1024, cuda_device, seed=27)
    outs = [mm.matmul_w8a16(x, w, sc, b) for _ in range(3)]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    _mm_close(outs[0], mref.matmul_w8a16_plain(x, w, sc, b))
    x, w, sc, b = _mm_operands(72, 512, 384, cuda_device, seed=28)
    xu = torch.empty(x.numel() + 1, dtype=x.dtype,
                     device=cuda_device)[1:].view(x.shape)
    wu = torch.empty(w.numel() + 1, dtype=w.dtype,
                     device=cuda_device)[1:].view(w.shape)
    xu.copy_(x)
    wu.copy_(w)
    assert xu.data_ptr() % 16 and wu.data_ptr() % 16
    for bm in mm.BMS:
        for bn in mm.BNS:
            got = mm.matmul_w8a16(xu, wu, sc, b, bm=bm, bn=bn)
            assert torch.equal(got, mm.matmul_w8a16(x, w, sc, b, bm=bm,
                                                    bn=bn))
    _mm_close(got, mref.matmul_w8a16_plain(x, w, sc, b))


@pytest.mark.cuda
def test_matmul_w8a16_prefill_refuses_a_tile_it_was_not_built_for(
        cuda_device):
    x, w, sc, b = _mm_operands(256, 512, 512, cuda_device, seed=29)
    before = mm.LAUNCHES["matmul_w8a16"]
    for tile in (dict(bm=32), dict(bm=512), dict(bn=64), dict(bn=256),
                 dict(bk=32)):
        with pytest.raises(ValueError, match="tile"):
            mm.matmul_w8a16(x, w, sc, b, **tile)
    assert mm.LAUNCHES["matmul_w8a16"] == before


# qwen2.5-14b's decode projections (K, N), a ragged K and N, and small
# shapes; every M the decode kernel takes up to one n8 tile and past it
MM_DECODE = [(5120, 5120), (5120, 1024), (5120, 13824), (13824, 5120),
             (4097, 300), (200, 300), (7, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 2, 4, 9, 16])
@pytest.mark.parametrize("K,N", MM_DECODE)
def test_matmul_w8a16_decode_matches_plain(cuda_device, K, N, M):
    """The split-K decode kernel at S = 1, the default S and the largest
    S, against the plain version; each geometry gives the same bits on
    three calls; one launch count a call, reduction pass included."""
    o = _mm_operands(M, K, N, cuda_device, seed=K + N + M)
    want = mref.matmul_w8a16_plain(*o, act="silu")
    for S in sorted({1, mm.decode_geometry(M, N, K).splits, mm.k_steps(K)}):
        before = mm.LAUNCHES["matmul_w8a16"]
        outs = [mm.matmul_w8a16(*o, act="silu", splits=S) for _ in range(3)]
        torch.cuda.synchronize()
        assert mm.LAUNCHES["matmul_w8a16"] == before + 3
        _mm_close(outs[0], want)
        assert all(torch.equal(x, outs[0]) for x in outs[1:]), S


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("act", ["none", "silu", "gelu", "relu"])
def test_matmul_w8a16_decode_epilogues_match_plain(cuda_device, act,
                                                   with_bias):
    o = _mm_operands(4, 5120, 1024, cuda_device, seed=23,
                     with_bias=with_bias)
    want = mref.matmul_w8a16_plain(*o, act=act)
    for S in (1, None):
        _mm_close(mm.matmul_w8a16(*o, act=act, splits=S), want)


@pytest.mark.cuda
def test_matmul_w8a16_decode_unaligned_rows(cuda_device):
    """x and w that start off a 16-byte boundary take the element-wise
    loads and give the bits of the aligned copies' 16-byte path at the
    same geometry."""
    x, w, sc, b = _mm_operands(4, 1024, 512, cuda_device, seed=24)
    xb = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda_device)
    wb = torch.empty(w.numel() + 1, dtype=w.dtype, device=cuda_device)
    xu = xb[1:].view(x.shape)
    wu = wb[1:].view(w.shape)
    xu.copy_(x)
    wu.copy_(w)
    assert xu.data_ptr() % 16 and wu.data_ptr() % 16
    for S in (1, 5):
        got = mm.matmul_w8a16(xu, wu, sc, b, splits=S)
        assert torch.equal(got, mm.matmul_w8a16(x, w, sc, b, splits=S))
    _mm_close(got, mref.matmul_w8a16_plain(x, w, sc, b))


@pytest.mark.cuda
def test_matmul_w8a16_decode_refuses_a_split_it_cannot_run(cuda_device):
    x, w, sc, b = _mm_operands(4, 640, 256, cuda_device, seed=25)
    before = mm.LAUNCHES["matmul_w8a16"]
    for bad in (0, -1, mm.k_steps(640) + 1):
        with pytest.raises(ValueError, match="splits"):
            mm.matmul_w8a16(x, w, sc, b, splits=bad)
    assert mm.LAUNCHES["matmul_w8a16"] == before


@pytest.mark.cuda
def test_matmul_w8a16_refuses_what_it_was_not_built_for(cuda_device):
    x, w, sc, b = _mm_operands(4, 64, 256, cuda_device, seed=22)
    with pytest.raises(ValueError, match="bf16"):
        mm.matmul_w8a16(x.float(), w, sc)
    with pytest.raises(ValueError, match="tile"):
        mm.matmul_w8a16(x, w, sc, bm=24)
    with pytest.raises(ValueError, match="act"):
        mm.matmul_w8a16(x, w, sc, act="tanh")
    with pytest.raises(ValueError, match="agree"):
        mm.matmul_w8a16(x, w, sc[:10])


@pytest.mark.cuda
def test_reduced_qwen_int8_kernel_path_matches_plain(cuda_device):
    """A widened reduced qwen2.5-14b (every projection int8) on the card:
    the kernel path launches matmul_w8a16 7 times a layer per prefill and
    per decode step, and agrees with the plain path within 4e-2."""
    from repro_torch.core.quant import quantize_tree
    from repro_torch.models.lm import build_model
    from repro_torch.testing import reduced_config

    model = build_model(reduced_config("qwen2.5-14b", d_model=256, n_heads=8,
                                       n_kv_heads=4, head_dim=64, d_ff=512))
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = quantize_tree(model.init_serving(gen, cuda_device))
    toks = torch.randint(0, 503, (3, 16), device=cuda_device,
                         generator=gen).to(torch.int32)
    lens = torch.tensor([16, 9, 1], dtype=torch.int32, device=cuda_device)
    plain = model.with_tile_plans({"matmul_int8": {"impl": "plain"}})
    n0 = mm.LAUNCHES["matmul_w8a16"]
    cache, logits = model.prefill(params, {"tokens": toks, "lengths": lens},
                                  max_len=32)
    cache_p, logits_p = plain.prefill(params, {"tokens": toks,
                                               "lengths": lens}, max_len=32)
    assert mm.LAUNCHES["matmul_w8a16"] == n0 + 7 * model.cfg.n_layers
    assert float((logits - logits_p).abs().max()) <= \
        4e-2 * float(logits_p.abs().max())
    t = torch.argmax(logits_p, -1).to(torch.int32)
    _, l_k = model.decode_step(params, cache_p, t)
    _, l_p = plain.decode_step(params, cache_p, t)
    torch.cuda.synchronize()
    assert mm.LAUNCHES["matmul_w8a16"] == n0 + 14 * model.cfg.n_layers
    assert float((l_k - l_p).abs().max()) <= 4e-2 * float(l_p.abs().max())


# ---------------------------------------------------------------------------
# The decode loop: its control kernel, rwkv6_step in place, the chunk graph
# ---------------------------------------------------------------------------


def _loop_state(B, k, max_len, seed, device, *, limit, stop, n):
    """Random loop buffers at tick n: a mix of active slots, EOS ids that
    the sampled tokens hit, lengths at the cache's end, spent budgets."""
    rng = np.random.default_rng(seed)
    V = 12
    sampled = rng.integers(0, V, B)
    inp = np.concatenate([
        rng.integers(0, V, B), rng.integers(0, 2, B),
        np.where(rng.random(B) < 0.4, sampled, rng.integers(-1, V, B)),
        rng.integers(-1, 4, B), [limit, stop]]).astype(np.int32)
    out = np.zeros(1 + 3 * k * B, np.int32)
    out[0] = n
    out[1:1 + 3 * n * B] = rng.integers(0, 2, 3 * n * B)
    lengths = np.where(rng.random(B) < 0.3, max_len - 1,
                       rng.integers(1, max_len - 1, B))
    ctl = np.array([rng.integers(0, 2), 1], np.int32)
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(device)
    return t(sampled), t(lengths), t(inp), t(out), t(ctl)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4, 16])
def test_decode_loop_kernel_matches_plain(cuda_device, B):
    """The control kernel against its plain version on random states,
    bit-equal: every limit below, at and past the tick, stop_on_free on
    and off, EOS hits, full caches and spent budgets; then the init."""
    k, max_len, case = 4, 32, 0
    for n in range(k):
        for limit in (n, n + 1, k):
            for stop in (0, 1):
                case += 1
                got = _loop_state(B, k, max_len, 1000 * B + case,
                                  cuda_device, limit=limit, stop=stop, n=n)
                want = [t.clone() for t in got]
                before = dl.LAUNCHES["decode_loop"]
                dl.epilogue(*got, k=k, max_len=max_len)
                dref.epilogue_plain(*want, k=k, max_len=max_len)
                assert dl.LAUNCHES["decode_loop"] == before + 1
                for a, b in zip(got, want):
                    assert torch.equal(a, b), (B, n, limit, stop)
                dl.epilogue(None, None, *got[2:], k=k, max_len=max_len,
                            init=True)
                dref.init_plain(*want[2:], B=B, k=k)
                for a, b in zip(got, want):
                    assert torch.equal(a, b), (B, n, limit, stop, "init")


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H,K,V", [(1, 1, 32, 64, 64), (1, 4, 32, 64, 64),
                                       (3, 2, 4, 16, 16), (2, 2, 4, 16, 64)])
def test_rwkv6_step_in_place_is_bit_equal(cuda_device, T, B, H, K, V):
    """``out=state`` (the cache's own state, as the in-place decode step
    passes it) gives the out-of-place call's y and state bits at every
    head tile and column slab."""
    o = _rwkv_operands(T, B, H, K, V, cuda_device, seed=7 * T + B)
    for bh in [d for d in range(1, H + 1) if H % d == 0]:
        for bv in rk._legal_bv(V):
            y0, s0 = rk.rwkv6_step(*o, bh=bh, bv=bv)
            state = o[5].clone()
            y1, s1 = rk.rwkv6_step(*o[:5], state, bh=bh, bv=bv, out=state)
            torch.cuda.synchronize()
            assert s1.data_ptr() == state.data_ptr()
            assert torch.equal(y0, y1) and torch.equal(s0, s1), (bh, bv)
    with pytest.raises(ValueError, match="out must be"):
        rk.rwkv6_step(*o, out=o[5][:, :, :, :V // 2])


LOOP_LMS = ("rwkv", "qwen", "qwen-int8-kv", "qwen-int8", "qwen3-moe",
            "hymba")


def _loop_lm(kind, device):
    from repro_torch.core.quant import quantize_tree
    from repro_torch.models.lm import build_model
    from repro_torch.testing import reduced_config

    if kind == "rwkv":
        cfg = reduced_config("rwkv6-1.6b")
    elif kind == "qwen3-moe":     # the MoE MLP inside the captured tick
        cfg = reduced_config("qwen3-moe-30b-a3b")
    elif kind == "hymba":         # the SSD mixer and the swa ring
        cfg = reduced_config("hymba-1.5b")
    elif kind == "qwen-int8":     # widened: every projection int8
        cfg = reduced_config("qwen2.5-14b", d_model=256, n_heads=8,
                             n_kv_heads=4, head_dim=64, d_ff=512)
    else:
        cfg = reduced_config("qwen2.5-14b", kv_cache_dtype=(
            "int8" if kind == "qwen-int8-kv" else "bf16"))
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init_serving(gen, device)
    if kind == "rwkv":
        params["blocks"]["p0"]["bonus"].normal_(0, 0.5, generator=gen)
    elif kind == "hymba":         # the zero-initialised leaves do work
        for blk in params["blocks"].values():
            zero = [blk[n] for n in ("norm1", "norm2", "attn_out_norm",
                                     "ssm_out_norm") if n in blk]
            if "ssm" in blk:
                zero += [blk["ssm"]["conv_bias"], blk["ssm"]["ssm_norm"]]
            for t in zero:
                t.normal_(0, 0.5, generator=gen)
    else:
        attn = params["blocks"]["p0"]["attn"]
        for name in ("bq", "bk", "bv", "q_norm", "k_norm"):
            if name in attn:
                attn[name].normal_(0, 0.5, generator=gen)
    if kind == "qwen-int8":
        params = quantize_tree(params)
    return model, params


def _prefill_into(model, params, cache, slots, lens, seed, max_len):
    """Prefill prompts of ``lens`` tokens and scatter them into ``slots``
    of ``cache`` (in place, as the engine admits); their first tokens."""
    from repro_torch.serving.slotstate import gather_slots, scatter_slots

    dev = cache["lengths"].device
    g = torch.Generator(device=dev).manual_seed(seed)
    S = max(lens)
    toks = torch.randint(0, 503, (len(lens), S), device=dev,
                         generator=g).to(torch.int32)
    cacheN, logits = model.prefill(params, {"tokens": toks, "lengths":
                                            torch.tensor(lens, dtype=torch.int32,
                                                         device=dev)},
                                   max_len=max_len)
    axes = model.cache_batch_axes(cache)
    scatter_slots(cache, axes, slots,
                  gather_slots(cacheN, axes, range(len(lens))))
    return torch.argmax(logits, -1).to(torch.int32).cpu().numpy()


def _leaves(cache):
    from repro_torch.models.params import tree_leaves
    return tree_leaves(cache)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("kind", LOOP_LMS)
def test_decode_graph_matches_eager_chunks(cuda_device, kind, k):
    """The engine's chunk as one graph launch against the same chunk run
    eagerly on a copy of the cache: the same n, tokens, acts, dones and
    caches, bit-equal, over several chunks, across a prefill inserted
    between them, with an EOS hit and a budget running out; the graph's
    cache keeps its addresses throughout."""
    from repro_torch.models.params import tree_map
    from repro_torch.serving.decode_graph import DecodeLoop
    from repro_torch.serving.engine import _decode_many
    from repro_torch.serving.sampler import SamplerConfig

    model, params = _loop_lm(kind, cuda_device)
    B, max_len = 4, 32
    cache = model.init_cache(B, max_len, cuda_device)
    ref_cache = model.init_cache(B, max_len, cuda_device)
    greedy = SamplerConfig()
    graph = DecodeLoop(model, params, cache, greedy, max_len, k)
    eager = DecodeLoop(model, params, ref_cache, greedy, max_len, k,
                       graph=False)
    assert graph.graph and not eager.graph and graph.capture_s > 0
    for a, b in zip(_leaves(cache), _leaves(ref_cache)):
        assert torch.equal(a, b)     # capture left the cache as it found it
    ptrs = [t.data_ptr() for t in _leaves(cache)]
    first = _prefill_into(model, params, cache, [0, 1, 2], [9, 3, 14], 1,
                          max_len)
    _prefill_into(model, params, ref_cache, [0, 1, 2], [9, 3, 14], 1,
                  max_len)
    with pytest.raises(ValueError, match="empty cache"):
        DecodeLoop(model, params, cache, greedy, max_len, k)  # live slots
    tokens = np.zeros(B, np.int32)
    tokens[:3] = first
    active = np.array([1, 1, 1, 0], bool)
    remaining = np.array([6, 2, 9, 0], np.int32)
    eos = np.full(B, -1, np.int32)
    # the token slot 2 would produce at its third tick becomes its EOS
    probe = tree_map(torch.clone, cache)
    _, _, _, ptoks, _, _ = _decode_many(
        model, greedy, max_len, 3, params, probe, tokens, None, active, eos,
        remaining, 3, False)
    eos[2] = ptoks[2, 2]
    for chunk in range(6):
        if chunk == 3:       # admit into the free slot between chunks
            for c in (cache, ref_cache):
                t0 = _prefill_into(model, params, c, [3], [5], 2, max_len)
            tokens[3], active[3], remaining[3] = t0[0], True, 5
        stop = chunk % 2 == 1
        got = graph.run(tokens, active, eos, remaining, k, stop)
        want = eager.run(tokens, active, eos, remaining, k, stop)
        assert got[0] == want[0] and got[0] >= 1
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(_leaves(cache), _leaves(ref_cache)):
            assert torch.equal(a, b), (kind, k, chunk)
        assert [t.data_ptr() for t in _leaves(cache)] == ptrs
        n, toks, acts, dones = got
        tokens = toks[n - 1].copy()
        remaining = remaining - acts[:n].sum(0).astype(np.int32)
        active = active & ~dones[:n].any(0)
        if not active.any():
            break
    graph.close()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rwkv", "qwen-int8"])
def test_decode_graph_counts_launches_per_tick(cuda_device, kind):
    """Under replay the launch counters grow by the kernel nodes the
    instantiated graph holds, a tick's times the ticks run, plus the
    chunk's init; those nodes are the launches the wrappers counted at
    capture; the warm-up's and the capture's launches are not counted;
    and a chunk counts what the same chunk run eagerly (every launch
    through its wrapper) counts."""
    from repro_torch.kernels import launches
    from repro_torch.models.params import tree_map
    from repro_torch.serving.decode_graph import DecodeLoop
    from repro_torch.serving.sampler import SamplerConfig

    model, params = _loop_lm(kind, cuda_device)
    L = model.cfg.n_layers
    B, max_len, k = 2, 32, 4
    cache = model.init_cache(B, max_len, cuda_device)
    before = launches.counters()
    loop = DecodeLoop(model, params, cache, SamplerConfig(), max_len, k)
    assert launches.counters() == before
    per = loop.per_tick_launches()
    want = ({"rwkv6_step": L} if kind == "rwkv" else
            {"flash_decode": L, "matmul_w8a16": 7 * L})
    assert per == dict(want, decode_loop=1)
    assert loop.per_chunk_launches() == {"decode_loop": 1}
    assert loop.chunk_nodes["kernel"] == 1
    assert loop.tick_nodes["kernel"] > sum(per.values())
    assert loop.pool_bytes > 0          # the tick's tensors' own pool
    first = _prefill_into(model, params, cache, [0, 1], [4, 6], 3, max_len)
    args = (np.ones(B, bool), np.full(B, -1, np.int32),
            np.array([3, 9], np.int32), k, False)
    mark = launches.counters()
    n, toks, _, _ = loop.run(first, *args)
    assert n == k               # slot 1 stays active through the chunk
    grown = launches.since(mark)
    assert grown == {key: m * n + (key == "decode_loop") for key, m in
                     per.items()}
    eager = DecodeLoop(model, params, tree_map(torch.clone, cache),
                       SamplerConfig(), max_len, k, graph=False)
    again = (toks[n - 1], np.array([False, True]), *args[1:])
    mark = launches.counters()
    n_e = eager.run(*again)[0]
    counted = launches.since(mark)
    mark = launches.counters()
    assert loop.run(*again)[0] == n_e == k
    assert launches.since(mark) == counted
    loop.close()


@pytest.mark.cuda
@pytest.mark.parametrize("sync_every", [1, 3])
@pytest.mark.parametrize("kind", ["qwen", "qwen-int8-kv"])
def test_paged_graph_engine_equals_dense_graph_engine(cuda_device, kind,
                                                      sync_every):
    """A ``paged:8`` engine on the card (the decode graph over the paged
    manager's fixed view) against the dense one through one seeded
    script of submits, steps and preemption bursts: the same stamps,
    greedy tokens (bit-equal logits: masked ring entries weigh exactly 0)
    and stats; after every op the pool invariants hold, the null and free
    blocks hold the empty pattern, and every view, pool and index tensor
    keeps its address (the graph captured the view's)."""
    from repro_torch.models.params import tree_leaves
    from repro_torch.serving.engine import ServingEngine

    model, params = _loop_lm(kind, cuda_device)
    make = lambda layout: ServingEngine(
        model, params, max_batch=3, max_len=32, sync_every=sync_every,
        overlap_prefill=True, cache_layout=layout)
    dense, paged = make("dense"), make("paged:8")
    sm = paged.sm
    ptrs = [t.data_ptr() for t in tree_leaves(sm.cache) + sm.tensors()]
    rng = np.random.default_rng(1)      # a script that preempts
    reqs = ([], [])
    for _ in range(40):
        op = rng.choice(("submit", "step", "step", "preempt"))
        if op == "submit":
            prompt = rng.integers(0, 503, int(rng.integers(1, 13))).tolist()
            n = int(rng.integers(1, 9))
            for r, e in zip(reqs, (dense, paged)):
                r.append(e.submit(list(prompt), max_new_tokens=n))
        elif op == "step":
            dense.step()
            paged.step()
        elif dense.sm.occupied():
            occ = dense.sm.occupied()
            victims = [int(v) for v in rng.choice(
                occ, size=int(rng.integers(1, len(occ) + 1)), replace=False)]
            dense.preempt_many(list(victims))
            paged.preempt_many(list(victims))
        sm.check_invariants()
        for pl in sm._leaves:
            pool = sm._pools[pl.ring_len]
            for b in [0] + pool.free_list:
                blk = pl.pool[:, b * pool.block:(b + 1) * pool.block]
                assert torch.equal(blk, pl.empty)
        assert ptrs == [t.data_ptr() for t in tree_leaves(sm.cache)
                        + sm.tensors()]
    dense.run()
    paged.run()
    sched = lambda rs: [(r.output, r.t_admit, r.t_first, r.t_done,
                         r.t_preempts, r.t_resumes) for r in rs]
    assert sched(reqs[0]) == sched(reqs[1])
    assert dense.stats() == paged.stats()
    assert paged.preemptions > 0
    assert sm.blocks_free() == sum(p.capacity - 1
                                   for p in sm._pools.values())


@pytest.mark.cuda
@pytest.mark.parametrize("sync_every", [1, 4])
def test_graph_engine_schedule_matches_cpu_engine(cuda_device, sync_every):
    """The engine on the card (a graph launch a chunk) schedules as the
    CPU engine does, with one host read a chunk and a prefill; sampling
    at temperature > 0 draws fresh numbers every tick."""
    from repro_torch.models.params import tree_map
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.sampler import SamplerConfig

    model, params = _loop_lm("rwkv", cuda_device)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    rng = np.random.default_rng(0)
    work = [(rng.integers(0, 503, L).tolist(), n) for L, n in
            [(3, 5), (12, 4), (5, 1), (20, 6), (7, 3), (1, 5), (9, 2)]]

    def serve(p, **kw):
        eng = ServingEngine(model, p, max_batch=2, max_len=32,
                            sync_every=sync_every, **kw)
        reqs = [eng.submit(list(t), max_new_tokens=n) for t, n in work]
        eng.run()
        return eng, reqs

    eng, reqs = serve(params)
    eng_c, reqs_c = serve(cpu_params)
    stamps = lambda rs: [(r.t_admit, r.t_first, r.t_done, len(r.output))
                         for r in rs]
    assert stamps(reqs) == stamps(reqs_c)
    st = eng.stats()
    assert st == eng_c.stats()
    assert st["host_syncs"] == st["decode_chunks"] + st["prefill_calls"]
    hot = SamplerConfig(temperature=1.0)
    outs = [[r.output for r in serve(params, sampler=hot, seed=s)[1]]
            for s in (5, 5, 6)]
    assert outs[0] == outs[1] and outs[0] != outs[2]
    long = [t for r in outs[0] for t in r[1:]]
    assert len(set(long)) > 3      # not one token repeated every tick


@pytest.mark.cuda
@pytest.mark.parametrize("sync_every", [1, 3])
@pytest.mark.parametrize("layout", ["dense", "paged:8"])
def test_hymba_graph_engine_equals_cpu_engine(cuda_device, layout,
                                              sync_every):
    """Reduced hymba (window 16, max_len 48: two ring lengths, 48 and 16)
    on the card's graph engine and on the port's CPU engine, same
    weights: the same tick stamps, ``stats()`` and utilization, one host
    read a chunk and a prefill; prompts past the window wrap the swa
    rings at prefill and every decode step writes over their oldest
    slot; paged, the pool invariants hold after the run and every block
    is free."""
    from repro_torch.models.params import tree_map
    from repro_torch.serving.engine import ServingEngine

    model, params = _loop_lm("hymba", cuda_device)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    rng = np.random.default_rng(2)
    work = [(rng.integers(0, 503, L).tolist(), n) for L, n in
            [(3, 5), (22, 6), (5, 1), (30, 8), (7, 3), (18, 5), (9, 2)]]

    def serve(p):
        eng = ServingEngine(model, p, max_batch=3, max_len=48,
                            sync_every=sync_every, cache_layout=layout)
        reqs = [eng.submit(list(t), max_new_tokens=n) for t, n in work]
        eng.run()
        return eng, reqs

    eng, reqs = serve(params)
    eng_c, reqs_c = serve(cpu_params)
    assert eng._loop.graph
    stamps = lambda rs: [(r.t_admit, r.t_first, r.t_done, len(r.output))
                         for r in rs]
    assert stamps(reqs) == stamps(reqs_c)
    st = eng.stats()
    assert st == eng_c.stats()
    assert eng.util_history == eng_c.util_history
    assert st["host_syncs"] == st["decode_chunks"] + st["prefill_calls"]
    if layout != "dense":
        sm = eng.sm
        assert sorted(sm._pools) == [16, 48]
        sm.check_invariants()
        assert sm.blocks_free() == sum(p.capacity - 1
                                       for p in sm._pools.values())


@pytest.mark.cuda
@pytest.mark.parametrize("kind,layout", [("rwkv", "dense"),
                                         ("qwen", "paged:8"),
                                         ("hymba", "paged:8")])
def test_storm_on_graph_engine_equals_cpu_engine(cuda_device, kind, layout,
                                                 tmp_path):
    """Reduced rwkv6 (dense), qwen2.5-14b and hymba (``paged:8``) under
    ``make_storm(n_faults=8)`` (every kind, the kill included) through
    ``drive_resilient``: the CUDA graph engine and the port's CPU engine on
    the same weights give the same tick stamps, ``fault_events``,
    ``fault_stats()`` and restarts, and the restored engine runs its own
    decode graph."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models.params import tree_map
    from repro_torch.plan.plan import ServingPlan, WorkloadProfile
    from repro_torch.serving import workload as wl
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.faults import (FaultInjector, drive_resilient,
                                            make_storm)

    model, params = _loop_lm(kind, cuda_device)
    plan = ServingPlan(arch=model.cfg.name, reduced=True, max_batch=4,
                       max_len=64, cache_layout=layout, retry_budget=3,
                       watchdog_ticks=4).resolve()
    items = wl.profile_items(WorkloadProfile(
        kind="poisson", rate=0.8, duration=32.0, prompt_len=(4, 12),
        max_new_tokens=(6, 10), deadline_slack=1.5),
        vocab_size=model.cfg.vocab_size, seed=0)
    storm = make_storm(duration=32, seed=8, n_faults=8, max_batch=4)

    def run(p, d):
        rep = drive_resilient(
            ServingEngine.from_plan(plan, p, model=model), items,
            wl.VirtualClock(), injector=FaultInjector(storm),
            manager=CheckpointManager(str(tmp_path / d)), checkpoint_every=8)
        view = ([(r.uid, r.t_admit, r.t_first, r.t_done, len(r.output),
                  r.done, r.shed, r.retries) for r in rep.requests],
                rep.fault_events, rep.engine.fault_stats(), rep.n_restarts,
                rep.restart_ticks_lost)
        return rep, view

    rep, view = run(params, "cuda")
    _, view_cpu = run(tree_map(lambda t: t.cpu(), params), "cpu")
    assert view == view_cpu
    assert rep.n_restarts == 1 and not rep.lost_uids()
    assert rep.engine._loop.graph
    if layout != "dense":
        rep.engine.sm.check_invariants()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,layout,storm", [("rwkv", "dense", False),
                                               ("qwen", "paged:8", False),
                                               ("rwkv", "dense", True)])
def test_traced_graph_engine_trace_equals_cpu_trace(cuda_device, kind, layout,
                                                    storm, tmp_path):
    """A traced drive on the CUDA graph engine (reduced rwkv6 under
    preemptive EDF, reduced qwen2.5-14b ``paged:8``, and rwkv6 under
    ``make_storm(n_faults=8)`` through ``drive_resilient``, a crash
    restart included) writes the CPU engine's trace byte for byte, and
    changes nothing of the untraced graph drive: stamps, ``stats()``,
    ``fault_stats()``, ``host_syncs``, the launch counters and every
    cache tensor's address."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels import launches
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.obs import Tracer, check_trace
    from repro_torch.plan.plan import ServingPlan, WorkloadProfile
    from repro_torch.serving import workload as wl
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.faults import (FaultInjector, drive_resilient,
                                            make_storm)

    model, params = _loop_lm(kind, cuda_device)
    knobs = (dict(max_batch=4, max_len=64, retry_budget=3, watchdog_ticks=4)
             if storm else dict(max_batch=2, max_len=32, policy="edf",
                                preempt=kind == "rwkv"))
    plan = ServingPlan(arch=model.cfg.name, reduced=True,
                       cache_layout=layout, **knobs).resolve()
    items = wl.profile_items(WorkloadProfile(
        kind="poisson", rate=0.8 if storm else 0.6,
        duration=32.0 if storm else 24.0, deadline_slack=1.5 if storm
        else 3.0, max_new_tokens=(6, 10) if storm else (4, 12),
        prompt_len=(4, 12) if storm else (4, 24)),
        vocab_size=model.cfg.vocab_size, seed=0)

    def run(p, traced, d):
        tracer = Tracer() if traced else None
        eng = ServingEngine.from_plan(plan, p, model=model, tracer=tracer)
        ptrs = [t.data_ptr() for t in tree_leaves(eng.sm.cache)]
        before = launches.counters()
        if storm:
            rep = drive_resilient(
                eng, items, wl.VirtualClock(),
                injector=FaultInjector(make_storm(duration=32, seed=8,
                                                  n_faults=8, max_batch=4)),
                manager=CheckpointManager(str(tmp_path / d)),
                checkpoint_every=8)
            final, reqs = rep.engine, rep.requests
            assert rep.n_restarts == 1
        else:
            reqs = wl.drive(eng, items, wl.VirtualClock())
            final = eng
            assert [t.data_ptr() for t in tree_leaves(eng.sm.cache)] == ptrs
        torch.cuda.synchronize()
        counts = launches.since(before)
        view = ([(r.uid, r.t_submit, r.t_admit, r.t_first, r.t_done,
                  list(r.output), r.done, r.shed, r.retries,
                  list(r.t_preempts), list(r.t_resumes)) for r in reqs],
                final.stats(), final.fault_stats(), final.util_history,
                counts)
        return tracer, view, final

    tr, view, eng = run(params, True, "traced")
    assert eng._loop.graph
    _, plain_view, _ = run(params, False, "untraced")
    assert view == plain_view
    assert view[4] and min(view[4].values()) > 0
    tr_cpu, _, _ = run(tree_map(lambda t: t.cpu(), params), True, "cpu")
    assert tr.dumps() == tr_cpu.dumps()
    check_trace(tr.to_chrome())
    names = {e.name for e in tr.events}
    if storm:
        assert {"fault", "retry", "quarantine"} <= names
    if layout != "dense":
        assert "bytes_resident" in names


@pytest.mark.cuda
def test_disaggregated_fleet_on_graph_engines_equals_cpu_fleet(cuda_device):
    """Reduced rwkv6 in a 2-replica disaggregated fleet (one b2 prefill
    replica, one b4 decode replica, each engine on its own decode graph)
    through ``drive_fleet``: the same tick stamps, resumes, shed flags,
    transit stats, census and per-replica stats as the same fleet on the
    CPU; ``rwkv6_step`` and ``decode_loop`` launched in both replicas, the
    decode replica never prefilling, and every cache tensor of every
    replica at the address its graph captured."""
    import dataclasses

    from repro_torch.kernels import launches
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.plan.plan import FleetPlan, ServingPlan, WorkloadProfile
    from repro_torch.serving import workload as wl
    from repro_torch.serving.router import Router, drive_fleet

    model, params = _loop_lm("rwkv", cuda_device)
    pre = ServingPlan(arch=model.cfg.name, reduced=True, max_batch=2,
                      max_len=32)
    fleet = FleetPlan(replicas=(pre, dataclasses.replace(pre, max_batch=4)),
                      routing="least_queue", n_prefill=1).validate()
    items = wl.profile_items(WorkloadProfile(
        kind="poisson", rate=1.0, duration=16.0, deadline_slack=3.0),
        vocab_size=model.cfg.vocab_size, seed=0)

    def run(p, device):
        router = Router.from_plan(fleet, seed=0, device=device,
                                  _built={(model.cfg.name, True):
                                          (model, p)})
        ptrs = [[t.data_ptr() for t in tree_leaves(e.sm.cache)]
                for e in router.engines]
        before = launches.counters()
        reqs = drive_fleet(router, items, wl.VirtualClock())
        view = ([(r.uid, r.t_submit, r.t_admit, r.t_first, r.t_done,
                  len(r.output), r.done, r.shed, list(r.t_resumes))
                 for r in reqs], router.transit_stats(),
                router.conservation_census(),
                [e.stats() for e in router.engines],
                [[x.uid for x in a] for a in router.assigned])
        same = ptrs == [[t.data_ptr() for t in tree_leaves(e.sm.cache)]
                        for e in router.engines]
        return router, view, same, launches.since(before)

    router, view, same, counts = run(params, cuda_device)
    assert all(e._loop.graph for e in router.engines)
    assert same
    _, view_cpu, _, _ = run(tree_map(lambda t: t.cpu(), params), "cpu")
    assert view == view_cpu
    ts = view[1]
    assert ts["handoffs"] == ts["delivered"] > 0 and ts["in_flight"] == 0
    st_pre, st_dec = view[3]
    assert st_dec["prefill_calls"] == 0 and st_pre["decode_ticks"] > 0
    n_layers = model.cfg.n_layers
    ticks = st_pre["decode_ticks"] + st_dec["decode_ticks"]
    assert counts["rwkv6_step"] == n_layers * ticks
    assert counts["decode_loop"] == ticks + st_pre["decode_chunks"] + \
        st_dec["decode_chunks"]
