"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports only torch, numpy and the port, so it runs where JAX is absent:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_cuda_kernels.py

Where there is no CUDA card every test skips.  Tolerance: both sides sum
exact bf16 x int8/bf16 products in f32 in different orders, so a bf16 ulp
of y (or of the h fed back) may flip: 2e-2.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import cells
from repro_torch.kernels.fused_rnn import fused_rnn as tk
from repro_torch.kernels.fused_rnn import ref as tref

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
