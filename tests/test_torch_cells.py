"""Port parity: repro_torch.core.cells against repro.core.cells.

Weights are made by the JAX package and carried over through numpy
(``weights_from_numpy``); inputs come from a numpy seed.  The f32
execution models agree at 1e-5.  ``impl="kernel"`` on the CPU runs the
kernel's plain version and is held against the JAX Pallas kernel in
interpret mode at 2e-2, the bf16 tolerance of tests/test_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cells as jc
from repro.kernels.fused_rnn import ops as jops
from repro_torch.core import cells as tc


def _weights(cfg_j, seed):
    return jc.init_weights(cfg_j, jax.random.PRNGKey(seed))


def _to_np(w):
    return {k: np.asarray(v) for k, v in w.items()}


def _x(T, B, D, seed):
    return np.random.default_rng(seed).standard_normal(
        (T, B, D)).astype(np.float32)


def _cfgs(cell, H, B, T, precision):
    return (jc.RNNCellConfig(cell, H, timesteps=T, batch=B,
                             precision=precision),
            tc.RNNCellConfig(cell, H, timesteps=T, batch=B,
                             precision=precision))


@pytest.mark.parametrize("impl", ["blas", "fused"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("H,B,T", [(64, 1, 6), (128, 3, 5)])
def test_serve_f32_matches_jax(impl, cell, H, B, T):
    cj, ct = _cfgs(cell, H, B, T, "f32")
    wj = _weights(cj, 0)
    x = _x(T, B, H, 1)
    yj = np.asarray(jc.serve(cj, wj, jnp.asarray(x), impl=impl))
    yt = tc.serve(ct, tc.weights_from_numpy(_to_np(wj), "cpu"),
                  torch.from_numpy(x), impl=impl)
    assert yt.shape == (T, B, H) and yt.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), yj, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("precision", ["int8", "bf16", "blocked_fp"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_quantize_weights_matches_jax(precision, cell):
    cj, ct = _cfgs(cell, 64, 1, 1, precision)
    wj = _weights(cj, 2)
    qj = _to_np(jc.quantize_weights(cj, wj))
    qt = tc.quantize_weights(ct, tc.weights_from_numpy(_to_np(wj), "cpu"))
    assert sorted(qt) == sorted(qj)
    for k in qj:
        assert tuple(qt[k].shape) == qj[k].shape, k
        np.testing.assert_array_equal(qt[k].float().numpy(),
                                      qj[k].astype(np.float32), err_msg=k)
    dj = _to_np(jc.dequantize_weights(jc.quantize_weights(cj, wj)))
    dt = tc.dequantize_weights(qt)
    for k in dj:
        np.testing.assert_array_equal(dt[k].numpy(), dj[k], err_msg=k)


@pytest.mark.parametrize("precision", ["int8", "bf16"])
@pytest.mark.parametrize("cell,H,B,T,bh", [("lstm", 64, 1, 4, 32),
                                           ("gru", 128, 3, 3, 64)])
def test_serve_kernel_cpu_matches_pallas_interpret(precision, cell, H, B, T,
                                                   bh):
    cj, ct = _cfgs(cell, H, B, T, precision)
    wq = jc.quantize_weights(cj, _weights(cj, 3))
    x = _x(T, B, H, 4)
    yj = jops.serve(cj, wq, jnp.asarray(x, jnp.bfloat16), bh=bh,
                    interpret=True)
    wt = tc.weights_from_numpy(_to_np(wq), "cpu")
    xt = torch.from_numpy(x).to(torch.bfloat16)
    for plan in (None, {"bh": bh}, {"persistent": True}, {"impl": "jnp"}):
        yt = tc.serve(ct, wt, xt, impl="kernel", plan=plan)
        assert yt.dtype == torch.bfloat16 and yt.shape == (T, B, H)
        np.testing.assert_allclose(yt.float().numpy(),
                                   np.asarray(yj, np.float32),
                                   atol=2e-2, rtol=2e-2, err_msg=str(plan))


def test_serve_state_carry_matches_jax():
    """A request resumed from a carried (h, c) state matches JAX."""
    cj, ct = _cfgs("lstm", 64, 2, 4, "f32")
    wj = _weights(cj, 5)
    x = _x(4, 2, 64, 6)
    rng = np.random.default_rng(7)
    h0, c0 = (rng.standard_normal((2, 64)).astype(np.float32) * 0.5
              for _ in range(2))
    yj = np.asarray(jc.serve(cj, wj, jnp.asarray(x), impl="fused",
                             state=(jnp.asarray(h0), jnp.asarray(c0))))
    yt = tc.serve(ct, tc.weights_from_numpy(_to_np(wj), "cpu"),
                  torch.from_numpy(x), impl="fused",
                  state=(torch.from_numpy(h0), torch.from_numpy(c0)))
    np.testing.assert_allclose(yt.numpy(), yj, atol=1e-5, rtol=1e-5)


def test_init_weights_seeded_shapes():
    cfg = tc.RNNCellConfig("gru", 64, features=48)
    a = tc.init_weights(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = tc.init_weights(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        "w_x": (48, 3, 64), "w_h": (64, 3, 64), "b": (3, 64), "b_h": (3, 64)}
    bound = 1.0 / np.sqrt(64 + 48)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert float(a["w_x"].abs().max()) <= bound


def test_weights_from_numpy_keeps_bf16():
    cj, _ = _cfgs("lstm", 64, 1, 1, "bf16")
    wq = _to_np(jc.quantize_weights(cj, _weights(cj, 8)))
    wt = tc.weights_from_numpy(wq, "cpu")
    assert wt["w_x"].dtype == torch.bfloat16
    np.testing.assert_array_equal(wt["w_x"].float().numpy(),
                                  wq["w_x"].astype(np.float32))
