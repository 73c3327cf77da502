"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports only torch, numpy and the port, so it runs where JAX is absent:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_cuda_kernels.py

Where there is no CUDA card every test skips.  Tolerance: both sides sum
exact bf16 x int8/bf16 products in f32 in different orders, so a bf16 ulp
of y (or of the h fed back) may flip: 2e-2.  ``rwkv6_step`` runs the
same f32 recurrence as its plain version with another sum order (and
fused multiply-adds): its state agrees to 1e-4 relative to the state's
magnitude, y (bf16) to 2e-2.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import cells
from repro_torch.kernels.fused_rnn import fused_rnn as tk
from repro_torch.kernels.fused_rnn import ref as tref
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
    ("lstm", 128, 128, 1, 6, "int8", 8), ("lstm", 96, 80, 5, 4, "int8", 24),
    ("gru", 256, 256, 3, 5, "int8", 32), ("gru", 64, 48, 2, 4, "bf16", 16)])
def test_kernel_matches_plain(cuda_device, cell, H, D, B, T, wdtype, bh,
                              persistent):
    o = _operands(cell, H, D, B, T, wdtype, cuda_device, seed=11)
    key = f"fused_{cell}" + ("_persistent" if persistent else "")
    before = tk.LAUNCHES[key]
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
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float().cpu(), w.float().cpu(), **TOL)


@pytest.mark.cuda
def test_persistent_refuses_a_grid_that_cannot_be_resident(cuda_device):
    """gru-2560 at the smallest tile needs 320 CTAs of ~141 KB: more than
    the card holds at once, so the wrapper raises before launching."""
    o = _operands("gru", 2560, 2560, 1, 1, "int8", cuda_device, seed=1)
    with pytest.raises(ValueError, match="co-resident"):
        tk.fused_gru(o["x"], o["w_x"], o["w_h"], o["s_x"], o["s_h"], o["b"],
                     o["b_h"], o["h0"], bh=8, persistent=True)


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
