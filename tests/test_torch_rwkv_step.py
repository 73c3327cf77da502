"""Port parity: repro_torch.kernels.rwkv_step against the JAX package's
Pallas kernel (interpret mode) and its ``ref.py`` oracle.

On the CPU the wrapper runs the kernel's plain version; the CUDA kernel
itself is held against that plain version in
tests/test_torch_cuda_kernels.py and by chip_smoke.py.

Tolerances: both sides take the same f32 values and run the same
recurrence in f32; only the order of the f32 sums differs (einsum here,
the kernel's or XLA's elsewhere).  The state agrees to 1e-4 (as in
tests/test_rwkv_kernel.py); y is rounded to bf16, where such a sum
difference can flip one bf16 ulp (2^-8 relative), hence 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv_step import ops as jops
from repro.kernels.rwkv_step.ref import rwkv6_step_ref as j_ref
from repro.kernels.rwkv_step.rwkv_step import rwkv6_step as j_kernel
from repro_torch.kernels.rwkv_step import ops as tops
from repro_torch.kernels.rwkv_step import rwkv_step as tk
from repro_torch.kernels.rwkv_step.ref import rwkv6_step_ref as t_ref

Y_TOL = dict(atol=2e-2, rtol=2e-2)
S_TOL = dict(atol=1e-4, rtol=1e-4)

SWEEP = [
    (1, 2, 8, 8, 3),     # B, H, K, V, T (tests/test_rwkv_kernel.py)
    (2, 4, 16, 16, 5),
    (1, 8, 64, 64, 2),
    (3, 4, 16, 16, 1),   # decode shape, reduced rwkv6
]


def _inputs(B, H, K, V, T, seed=0):
    """Numpy operands with a nonzero bonus u and decays that span the
    model's clip range exp(-e^3) .. exp(-e^-8)."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    log_w = -np.exp(rng.uniform(-8.0, 3.0, (T, B, H, K))).astype(np.float32)
    return dict(r=mk(T, B, H, K), k=mk(T, B, H, K), v=mk(T, B, H, V),
                w=log_w, u=mk(H, K), s0=mk(B, H, K, V))


def _order(o):
    return [o[n] for n in ("r", "k", "v", "w", "u", "s0")]


@pytest.mark.parametrize("B,H,K,V,T", SWEEP)
def test_plain_matches_pallas_and_oracle(B, H, K, V, T):
    o = _inputs(B, H, K, V, T)
    y_t, s_t = t_ref(*[torch.from_numpy(a) for a in _order(o)])
    j_in = [jnp.asarray(a) for a in _order(o)]
    for y_j, s_j in (j_kernel(*j_in, interpret=True), j_ref(*j_in)):
        np.testing.assert_allclose(y_t.float().numpy(),
                                   np.asarray(y_j, np.float32), **Y_TOL)
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **S_TOL)
    assert y_t.dtype == torch.bfloat16 and s_t.dtype == torch.float32


@pytest.mark.parametrize("bh", [0, 16, 32, 64])
def test_head_tile_matches_jax_for_plans(bh):
    """A plan's ``bh`` counts hidden units; both packages turn it into
    the same number of heads.  Without one the JAX package takes all
    heads in one grid step and the port one head per CTA."""
    for H, hd in ((4, 16), (32, 64), (6, 16)):
        plan = {"bh": bh} if bh else None
        want = jops.head_tile(H, hd, plan) if bh else 1
        assert tops.head_tile(H, hd, plan) == want


@pytest.mark.parametrize("plan", [None, {"bh": 16}, {"bh": 64}])
def test_serve_wkv_matches_jax(plan):
    B, T, H, hd = 2, 3, 4, 16
    d = H * hd
    rng = np.random.default_rng(5)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    r, k, v = mk(B, T, d), mk(B, T, d), mk(B, T, d)
    w = -np.exp(rng.uniform(-8.0, 3.0, (B, T, d))).astype(np.float32)
    u, s0 = mk(d), mk(B, H, hd, hd)
    args = (r, k, v, w, u, s0)
    y_j, s_j = jops.serve_wkv(*[jnp.asarray(a) for a in args], head_dim=hd,
                              interpret=True, plan=plan)
    y_t, s_t = tops.serve_wkv(*[torch.from_numpy(a) for a in args],
                              head_dim=hd, plan=plan)
    assert tuple(y_t.shape) == (B, T, d)
    np.testing.assert_allclose(y_t.float().numpy(),
                               np.asarray(y_j, np.float32), **Y_TOL)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **S_TOL)


def test_every_head_tile_gives_the_same_bits():
    B, H, K, V, T = 2, 4, 16, 16, 5
    o = [torch.from_numpy(a) for a in _order(_inputs(B, H, K, V, T, 1))]
    y0, s0 = tk.rwkv6_step(*o, bh=H)
    for bh in (1, 2, 4):
        y, s = tk.rwkv6_step(*o, bh=bh)
        assert torch.equal(y, y0) and torch.equal(s, s0)


def test_cpu_tensors_never_count_a_launch():
    before = dict(tk.LAUNCHES)
    o = [torch.from_numpy(a) for a in _order(_inputs(1, 2, 16, 16, 2))]
    tk.rwkv6_step(*o, bh=1)
    tops.serve_wkv(torch.zeros(1, 1, 32), torch.zeros(1, 1, 32),
                   torch.zeros(1, 1, 32), torch.zeros(1, 1, 32),
                   torch.zeros(32), torch.zeros(1, 2, 16, 16), head_dim=16)
    assert tk.LAUNCHES == before == {"rwkv6_step": before["rwkv6_step"]}


def test_wrapper_refuses_other_devices_and_shapes():
    m = lambda *s, dt=torch.float32: torch.zeros(s, device="meta", dtype=dt)
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.rwkv6_step(m(1, 1, 2, 16, dt=bf), m(1, 1, 2, 16, dt=bf),
                      m(1, 1, 2, 16, dt=bf), m(1, 1, 2, 16), m(2, 16),
                      m(1, 2, 16, 16))
