"""Port parity: repro_torch.core.quant against repro.core.quant on the same
numpy inputs.  Quantization is exact: same int8 codes, same f32 scales."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro_torch.core import quant as tq


def _data(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x.flat[0] = 0.0                       # an exact zero
    x.flat[-1] = 127.5 * np.abs(x).max() / 127.0   # a value near a .5 code
    return x


@pytest.mark.parametrize("shape,axis", [((64, 3, 64), 0), ((5, 17), -1),
                                        ((128, 4, 128), 0), ((2, 8, 16), 1)])
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_int8_exact(shape, axis, seed):
    x = _data(shape, seed)
    qj, sj = jq.quantize_int8(jnp.asarray(x), axis=axis)
    qt, st = tq.quantize_int8(torch.from_numpy(x), axis=axis)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_dequantize_int8_matches():
    x = _data((64, 3, 64), 2)
    qj, sj = jq.quantize_int8(jnp.asarray(x), axis=0)
    qt, st = tq.quantize_int8(torch.from_numpy(x), axis=0)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        dj = np.asarray(jq.dequantize_int8(qj, sj, jdt), np.float32)
        dt = tq.dequantize_int8(qt, st, tdt).float().numpy()
        np.testing.assert_array_equal(dt, dj)


def test_quantize_kv_matches():
    x = _data((2, 6, 4, 32), 3)
    qj, sj = jq.quantize_kv(jnp.asarray(x))
    qt, st = tq.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(
        tq.dequantize_kv(qt, st).float().numpy(),
        np.asarray(jq.dequantize_kv(qj, sj), np.float32))


@pytest.mark.parametrize("shape,axis,block", [((64, 3, 64), 0, 16),
                                              ((5, 37), -1, 16),
                                              ((33, 8), 0, 8)])
def test_blocked_fp_matches(shape, axis, block):
    x = _data(shape, 4)
    bj = np.asarray(jq.blocked_fp(jnp.asarray(x), block=block, axis=axis))
    bt = tq.blocked_fp(torch.from_numpy(x), block=block, axis=axis).numpy()
    np.testing.assert_array_equal(bt, bj)
