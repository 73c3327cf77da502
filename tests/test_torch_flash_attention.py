"""Port parity of the flash attention kernels' plain versions: the port's
``flash_attention_plain``/``flash_decode_plain`` (and the ``ops``
adapters, which run them on the CPU) against the JAX package's Pallas
``flash_attention``/``flash_decode`` in interpret mode, as
tests/test_kernels.py runs them, on the same numpy inputs.

Tolerance: both sides take bf16 operands, sum exact products in f32 and
round p to bf16 before the AV product; only the order of the f32 sums
(and the last ulp of exp) differs.  Where a p or an output lands on a
bf16 rounding boundary the two round apart by one ulp (2^-8 relative),
so bf16 outputs are held to one ulp of the output's scale:
|port - jax| <= 2^-7 * max|jax|, and the f32 decode outputs (the
combine itself is f32) to 2^-8 * max|jax|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention.flash_attention import \
    flash_attention as j_flash
from repro.kernels.flash_attention.flash_decode import flash_decode as j_decode
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro_torch.kernels.flash_attention import flash_attention as tfa
from repro_torch.kernels.flash_attention import flash_decode as tfd
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention import ref as tref

BF16_TOL = 2.0 ** -7
F32_TOL = 2.0 ** -8


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _j(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _t(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _close(j_out, t_out, tol):
    a = np.asarray(j_out, np.float32)
    b = t_out.float().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.isfinite(b).all()
    err = float(np.abs(a - b).max())
    assert err <= tol * float(np.abs(a).max()), (err, tol)
    return err


def _positions(B, S, n_valid):
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    pos[np.arange(S)[None, :] >= np.asarray(n_valid)[:, None]] = -1
    return pos


# B, H, S, d, causal, window, softcap, bq, bk, n_valid (None: iota, no
# position arrays)
PREFILL = {
    "causal": (1, 2, 256, 64, True, 0, 0.0, 128, 128, None),
    "window": (2, 1, 256, 64, True, 64, 0.0, 128, 128, None),
    "softcap": (1, 2, 256, 128, True, 0, 50.0, 128, 64, None),
    "non_causal": (1, 1, 128, 64, False, 0, 0.0, 64, 64, None),
    "padding_rows": (2, 2, 256, 64, True, 0, 0.0, 128, 128, [200, 37]),
    "padding_window": (2, 2, 128, 32, True, 48, 0.0, 64, 64, [128, 90]),
}


@pytest.mark.parametrize("case", list(PREFILL), ids=list(PREFILL))
def test_flash_attention_plain_matches_pallas(case):
    B, H, S, d, causal, window, cap, bq, bk, n_valid = PREFILL[case]
    q, k, v = _inputs(list(PREFILL).index(case), *[(B, H, S, d)] * 3)
    kw = dict(causal=causal, window=window, softcap=cap)
    if n_valid is None:
        jo = j_flash(_j(q), _j(k), _j(v), bq=bq, bk=bk, interpret=True, **kw)
        pos_t = tfa.iota_positions(B, S, "cpu")
    else:
        pos = _positions(B, S, n_valid)
        jo = j_flash(_j(q), _j(k), _j(v), jnp.asarray(pos), jnp.asarray(pos),
                     bq=bq, bk=bk, interpret=True, **kw)
        pos_t = torch.from_numpy(pos)
    # the plain version over the Pallas kernel's own bk tiles ...
    to = tref.flash_attention_plain(_t(q), _t(k), _t(v), pos_t, pos_t,
                                    bk=bk, **kw)
    _close(jo, to, BF16_TOL)
    # ... and the wrapper, which on the CPU steps by SUB keys as the CUDA
    # kernel does
    tw = tfa.flash_attention(_t(q), _t(k), _t(v),
                             None if n_valid is None else pos_t,
                             None if n_valid is None else pos_t, **kw)
    _close(jo, tw, BF16_TOL)
    assert tfa.LAUNCHES["flash_attention"] == 0


def test_flash_attention_gqa_through_ops_matches_pallas():
    """Model layout (B, S, H, hd) with 2 KV heads for 4 query heads: the
    port reads KV head h // 2 where the JAX adapter repeats K and V."""
    B, S, H, K, d = 2, 128, 4, 2, 32
    q, k, v = _inputs(7, (B, S, H, d), (B, S, K, d), (B, S, K, d))
    pos = _positions(B, S, [128, 70])
    jo = jops.attention(_j(q), _j(k), _j(v), q_pos=jnp.asarray(pos),
                        kv_pos=jnp.asarray(pos), plan={"bq": 64, "bk": 64},
                        interpret=True)
    to = tops.attention(_t(q), _t(k), _t(v), q_pos=torch.from_numpy(pos),
                        kv_pos=torch.from_numpy(pos),
                        plan={"bq": 64, "bk": 64})
    assert tuple(to.shape) == (B, S, H, d)
    _close(jo, to, BF16_TOL)


def test_attention_ref_matches_jax():
    q, k, v = _inputs(3, *[(2, 2, 64, 32)] * 3)
    for kw in (dict(causal=True), dict(causal=True, window=16),
               dict(causal=False, softcap=20.0)):
        jo = j_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             **kw)
        to = tref.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), **kw)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5,
                                   rtol=1e-5)


# B, H, K, S, bk, causal, window, softcap, holes
DECODE = {
    "one_chunk": (2, 2, 2, 128, 128, True, 0, 0.0, False),
    "gqa_window": (1, 4, 2, 256, 64, True, 64, 0.0, False),
    "ring_holes": (2, 2, 2, 256, 128, True, 0, 0.0, True),
    "eight_chunks": (2, 4, 1, 512, 64, True, 0, 0.0, True),
    "softcap_non_causal": (1, 2, 2, 128, 32, False, 0, 30.0, False),
}


@pytest.mark.parametrize("case", list(DECODE), ids=list(DECODE))
def test_flash_decode_plain_matches_pallas(case):
    B, H, K, S, bk, causal, window, cap, holes = DECODE[case]
    q, kc, vc = _inputs(100 + list(DECODE).index(case), (B, H, 64),
                        (B, S, K, 64),
                        (B, S, K, 64))
    kv_pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    if holes:
        kv_pos[:, np.arange(S) % 5 == 3] = -1
        kv_pos[:, 3 * S // 4:] = -1            # unfilled: empty chunks
    q_pos = np.full((B,), S // 2, np.int32)
    kw = dict(causal=causal, window=window, softcap=cap)
    # the kernel itself, on head-expanded (B, H, S, d) caches
    ke, ve = jops._expand_kv(_j(kc), _j(vc), H)
    jo = j_decode(_j(q), ke.transpose(0, 2, 1, 3), ve.transpose(0, 2, 1, 3),
                  jnp.asarray(kv_pos), jnp.asarray(q_pos), bk=bk,
                  interpret=True, **kw)
    to = tref.flash_decode_plain(
        _t(q), _t(kc).transpose(1, 2), _t(vc).transpose(1, 2),
        torch.from_numpy(kv_pos), torch.from_numpy(q_pos), bk=bk, **kw)
    assert to.dtype == torch.float32
    _close(jo, to, F32_TOL)
    # the model-layout adapters (bf16 out)
    jo = jops.decode(_j(q), _j(kc), _j(vc), jnp.asarray(kv_pos),
                     jnp.asarray(q_pos), plan={"bk": bk}, interpret=True,
                     **kw)
    to = tops.decode(_t(q), _t(kc), _t(vc), torch.from_numpy(kv_pos),
                     torch.from_numpy(q_pos), plan={"bk": bk}, **kw)
    assert to.dtype == torch.bfloat16
    _close(jo, to, BF16_TOL)
    assert tfd.LAUNCHES["flash_decode"] == 0


def test_fully_masked_rows_stay_finite():
    """Padding query rows (q_pos = -1) see no key: -1e30, not -inf, keeps
    them finite (the mean of V), in both packages alike."""
    B, H, S, d = 1, 2, 64, 16
    q, k, v = _inputs(11, *[(B, H, S, d)] * 3)
    pos = _positions(B, S, [0])                   # every row padding
    jo = j_flash(_j(q), _j(k), _j(v), jnp.asarray(pos), jnp.asarray(pos),
                 bq=64, bk=64, interpret=True)
    to = tfa.flash_attention(_t(q), _t(k), _t(v), torch.from_numpy(pos),
                             torch.from_numpy(pos))
    assert bool(torch.isfinite(to).all())
    _close(jo, to, BF16_TOL)
    mean_v = torch.from_numpy(v).to(torch.bfloat16).float().mean(dim=2)
    np.testing.assert_allclose(to.float()[:, :, 0].numpy(), mean_v.numpy(),
                               atol=2e-2)


@pytest.mark.parametrize("bq,bk,Sq,Skv,want", [
    (128, 128, 512, 512, (128, 128)),    # the adapter's default at qwen's prefill
    (64, 64, 512, 512, (64, 64)),
    (100, 200, 512, 512, (64, 128)),     # down to a legal tile
    (256, 512, 4096, 4096, (128, 128)),  # capped
    (1, 1, 512, 512, (64, 64)),          # raised to the smallest
    (128, 128, 17, 30, (64, 64)),        # clamped to short lengths
    (128, 128, 100, 1000, (128, 128)),   # Sq != Skv
    (128, 128, 1, 65, (64, 128)),
])
def test_kernel_tiles_are_legal_clamped_and_fit_a_cta(bq, bk, Sq, Skv, want):
    """``kernel_tiles`` makes any plan tile one the kernel runs (bq 64 or
    128, bk 64 or 128, no larger than the lengths rounded up), idempotent,
    and every such tile fits a CTA's 232,448 bytes of shared memory with
    the kernel's static ~1 KB beside it, at every head dim."""
    got = tfa.kernel_tiles(bq, bk, Sq, Skv)
    assert got == want
    assert tfa.kernel_tiles(*got, Sq, Skv) == got
    assert got[0] in (tfa.WG_ROWS, tfa.MAX_BQ) and got[1] in (tfa.SUB,
                                                             tfa.MAX_BK)
    assert got[0] <= max(64, -(-Sq // 64) * 64)
    assert got[1] <= max(64, -(-Skv // 64) * 64)
    for d in tfa.DIMS:
        assert tfa.smem_bytes(*got, d) + 2048 <= 232_448
