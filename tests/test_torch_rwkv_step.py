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


def _tiles(geo, H):
    """(head, first row, first column) of every thread's ROWS x COLS block
    of one batch row's state: the kernel's own index arithmetic
    (csrc/rwkv_step.cu: the column groups lowest in the thread index, the
    row groups above them, then the head slot)."""
    groups, ncg = geo.K // tk.ROWS, geo.bv // tk.COLS
    slabs = geo.V // geo.bv
    for x in range(geo.grid[0]):
        h_begin = x // slabs * geo.bh
        for tid in range(geo.threads):
            cg, rg = tid % ncg, tid // ncg % groups
            for h in range(h_begin + tid // (groups * ncg), h_begin + geo.bh,
                           geo.hpc):
                yield h, rg * tk.ROWS, x % slabs * geo.bv + cg * tk.COLS


GEOMETRY_SHAPES = [  # B, H, K, V, bh
    (1, 32, 64, 64, 1), (4, 32, 64, 64, 1), (1, 32, 64, 64, 4),
    (2, 32, 64, 64, 32), (3, 4, 16, 16, 1), (1, 6, 64, 16, 3),
    (2, 4, 16, 64, 2), (8, 32, 64, 64, 1)]


@pytest.mark.parametrize("B,H,K,V,bh", GEOMETRY_SHAPES)
def test_geometry_covers_every_column_of_every_head_once(B, H, K, V, bh):
    """Every legal slab, and the default: each state element (head, row,
    column) of a batch row belongs to one thread, each column's y to one
    writer (row group 0), and a CTA holds at most MAX_THREADS threads."""
    for bv in [0] + tk._legal_bv(V):
        geo = tk.geometry(B, H, K, V, bh, 132, bv)
        assert geo.grid == ((H // bh) * (V // geo.bv), B)
        assert geo.threads <= tk.MAX_THREADS and geo.bh % geo.hpc == 0
        owned, writers = {}, {}
        for h, row0, col0 in _tiles(geo, H):
            for i in range(tk.ROWS):
                for c in range(tk.COLS):
                    key = (h, row0 + i, col0 + c)
                    owned[key] = owned.get(key, 0) + 1
            if row0 == 0:
                for c in range(tk.COLS):
                    writers[(h, col0 + c)] = writers.get((h, col0 + c), 0) + 1
        assert owned == {(h, i, c): 1 for h in range(H) for i in range(K)
                         for c in range(V)}
        assert writers == {(h, c): 1 for h in range(H) for c in range(V)}


@pytest.mark.parametrize("B,H,K,V,bh", GEOMETRY_SHAPES)
def test_geometry_slab_divides_v_and_is_at_least_four(B, H, K, V, bh):
    for sms in (1, 114, 132, 10_000):
        geo = tk.geometry(B, H, K, V, bh, sms)
        assert geo.bv >= 4 and geo.bv % 4 == 0 and V % geo.bv == 0
        assert tk.geometry(B, H, K, V, bh, sms, geo.bv) == geo


def test_geometry_fills_the_card_at_the_decode_shape():
    """rwkv6-1.6b's decode shape at B=1 (32 heads of 64, one head a CTA):
    at least 128 CTAs on 132 SMs, where one CTA a head gave 32."""
    assert tk.geometry(1, 32, 64, 64, 1, 132).ctas >= 128
    assert tk.geometry(4, 32, 64, 64, 1, 132).ctas >= 128


@pytest.mark.parametrize("bv", [2, 3, 12, 128])
def test_geometry_refuses_other_slabs_and_head_tiles(bv):
    with pytest.raises(ValueError, match="bv"):
        tk.geometry(1, 32, 64, 64, 1, 132, bv)
    with pytest.raises(ValueError, match="divide"):
        tk.geometry(1, 32, 64, 64, 3, 132)
