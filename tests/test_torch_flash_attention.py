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


# B, H, K, S, bk, causal, window, softcap, layout ("iota", "holes": every
# 5th slot and the last quarter empty, "ring": a wrapped ring cache whose
# slot s holds the last position congruent to s, so slot != position)
DECODE = {
    "one_chunk": (2, 2, 2, 128, 128, True, 0, 0.0, False),
    "gqa_window": (1, 4, 2, 256, 64, True, 64, 0.0, False),
    "ring_holes": (2, 2, 2, 256, 128, True, 0, 0.0, True),
    "eight_chunks": (2, 4, 1, 512, 64, True, 0, 0.0, True),
    "softcap_non_causal": (1, 2, 2, 128, 32, False, 0, 30.0, False),
    "ring_window": (2, 4, 2, 256, 64, True, 100, 0.0, "ring"),
}


def _decode_positions(B, S, layout):
    """(kv_pos (B, S), q_pos (B,)) int32 of a DECODE case."""
    kv_pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    q_pos = np.full((B,), S // 2, np.int32)
    if layout == "ring":
        last = np.asarray([S + 37 + 50 * b for b in range(B)], np.int32)
        kv_pos = last[:, None] - (last[:, None] - np.arange(S)[None]) % S
        kv_pos[:, np.arange(S) % 7 == 5] = -1      # holes in the ring
        q_pos = last.copy()
    elif layout:
        kv_pos[:, np.arange(S) % 5 == 3] = -1
        kv_pos[:, 3 * S // 4:] = -1            # unfilled: empty chunks
    return kv_pos.astype(np.int32), q_pos


def _j_decode(q, kc, vc, kv_pos, q_pos, H, bk, kw):
    """The Pallas kernel itself, on head-expanded (B, H, S, d) caches."""
    ke, ve = jops._expand_kv(_j(kc), _j(vc), H)
    return j_decode(_j(q), ke.transpose(0, 2, 1, 3), ve.transpose(0, 2, 1, 3),
                    jnp.asarray(kv_pos), jnp.asarray(q_pos), bk=bk,
                    interpret=True, **kw)


@pytest.mark.parametrize("case", list(DECODE), ids=list(DECODE))
def test_flash_decode_plain_matches_pallas(case):
    B, H, K, S, bk, causal, window, cap, layout = DECODE[case]
    q, kc, vc = _inputs(100 + list(DECODE).index(case), (B, H, 64),
                        (B, S, K, 64),
                        (B, S, K, 64))
    kv_pos, q_pos = _decode_positions(B, S, layout)
    kw = dict(causal=causal, window=window, softcap=cap)
    jo = _j_decode(q, kc, vc, kv_pos, q_pos, H, bk, kw)
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


def _no_key_batch(S):
    """A batch of three rows: q_pos = -1 (causal: no slot is seen), a row
    whose kv_pos is all -1, and a row with holes that sees keys."""
    kv_pos = np.tile(np.arange(S, dtype=np.int32), (3, 1))
    kv_pos[1] = -1
    kv_pos[2, np.arange(S) % 3 == 1] = -1
    kv_pos[2, S // 2:] = -1
    q_pos = np.asarray([-1, 10, S // 2 - 1], np.int32)
    return kv_pos, q_pos


def test_flash_decode_rows_that_see_no_key_are_the_mean_of_v():
    """A decode row that sees no key (q_pos = -1, or every slot empty)
    gets the untiled softmax's answer, the mean of V over all S slots, in
    the Pallas kernel, the plain version and the adapter alike; every
    output is finite."""
    B, H, K, S, d, bk = 3, 4, 2, 256, 64, 64
    q, kc, vc = _inputs(21, (B, H, d), (B, S, K, d), (B, S, K, d))
    kv_pos, q_pos = _no_key_batch(S)
    jo = _j_decode(q, kc, vc, kv_pos, q_pos, H, bk, {})
    to = tref.flash_decode_plain(
        _t(q), _t(kc).transpose(1, 2), _t(vc).transpose(1, 2),
        torch.from_numpy(kv_pos), torch.from_numpy(q_pos), bk=bk)
    _close(jo, to, F32_TOL)
    ta = tops.decode(_t(q), _t(kc), _t(vc), torch.from_numpy(kv_pos),
                     torch.from_numpy(q_pos), plan={"bk": bk})
    ja = jops.decode(_j(q), _j(kc), _j(vc), jnp.asarray(kv_pos),
                     jnp.asarray(q_pos), plan={"bk": bk}, interpret=True)
    _close(ja, ta, BF16_TOL)
    mean_v = _t(vc).float().mean(dim=1).repeat_interleave(H // K, dim=1)
    for row in (0, 1):
        np.testing.assert_allclose(to[row].numpy(), mean_v[row].numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(jo)[row], mean_v[row].numpy(),
                                   rtol=1e-5, atol=1e-6)
    assert not np.allclose(to[2].numpy(), mean_v[2].numpy(), atol=1e-2)


def _chunk_partials(q, k, v, kv_pos, q_pos, bk):
    """Per-chunk (m, l, acc) as ``flash_decode_plain`` builds them, from
    ``ref._scores`` and ``ref._mask``, and whether each (row, chunk) holds
    a slot the query sees: (B, H, nk) x 2, (B, H, nk, d), (B, nk)."""
    B, H, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, 1, d)
    ms, ls, accs, seen = [], [], [], []
    for s0 in range(0, S, bk):
        s1 = min(s0 + bk, S)
        s = tref._scores(qg, k[:, :, s0:s1], 1.0 / np.sqrt(d), 0.0)[..., 0, :]
        ok = tref._mask(q_pos[:, None], kv_pos[:, s0:s1], True, 0)[:, 0]
        s = torch.where(ok[:, None, None], s,
                        torch.full((), tref.NEG_INF))
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.matmul(p.to(torch.bfloat16).float()[..., None, :],
                                 v[:, :, None, s0:s1].float())[..., 0, :])
        seen.append(ok.any(dim=-1))
    return (torch.stack(ms, -1).reshape(B, H, -1),
            torch.stack(ls, -1).reshape(B, H, -1),
            torch.stack(accs, -2).reshape(B, H, -1, d),
            torch.stack(seen, -1))


def test_skipping_chunks_no_slot_of_which_is_seen_is_exact():
    """The kernel reads no K or V of a chunk that holds no slot the query
    sees and hands the combine (m, l, acc) = (-1e30, 0, 0) for it: every
    row that sees a key gets the same bits from ``lse_combine`` (its
    weight exp(-1e30 - M) is exactly 0), and equals the Pallas kernel.  A
    row that sees no key does not (its answer is the mean of V over every
    slot), which is why the kernel computes such a row's chunks in
    full."""
    B, H, K, S, d, bk = 3, 4, 2, 256, 64, 32
    q, kc, vc = _inputs(23, (B, H, d), (B, S, K, d), (B, S, K, d))
    kv_pos, q_pos = _no_key_batch(S)
    kv_pos[2, 40:100] = -1          # a gap of whole chunks inside the row
    k, v = _t(kc).transpose(1, 2), _t(vc).transpose(1, 2)
    m, l, acc, seen = _chunk_partials(_t(q), k, v, torch.from_numpy(kv_pos),
                                      torch.from_numpy(q_pos), bk)
    full = tref.lse_combine(m, l, acc)
    assert torch.equal(full, tref.flash_decode_plain(
        _t(q), k, v, torch.from_numpy(kv_pos), torch.from_numpy(q_pos),
        bk=bk))
    skip = ~seen[:, None, :].expand_as(m)
    assert int(skip[2].sum()) > 0 and not bool(skip[2].all())
    m2 = torch.where(skip, torch.full((), tref.NEG_INF), m)
    l2 = torch.where(skip, torch.zeros(()), l)
    acc2 = torch.where(skip[..., None], torch.zeros(()), acc)
    skipped = tref.lse_combine(m2, l2, acc2)
    assert torch.equal(skipped[2], full[2])
    jo = _j_decode(q, kc, vc, kv_pos, q_pos, H, bk, {})
    _close(np.asarray(jo)[2:], skipped[2:], F32_TOL)
    for row in (0, 1):              # no key: every chunk skipped gives 0
        assert not torch.allclose(skipped[row], full[row], atol=1e-3)


@pytest.mark.parametrize("S", [1, 77, 128, 1024, 4096])
def test_decode_bk_is_legal_clamped_and_fits_a_cta(S):
    """``decode_bk`` turns any plan's chunk into one the kernel runs: 1 to
    ``MAX_BK`` slots and no more than the cache, idempotent; the largest
    chunk's shared memory fits a CTA's 232,448 bytes at every head dim
    and group size."""
    for bk in list(range(1, 1025)) + [2048, 4096, 0, -5]:
        got = tfd.decode_bk(bk, S)
        assert 1 <= got <= min(S, tfd.MAX_BK)
        assert tfd.decode_bk(got, S) == got
        if 1 <= bk <= min(S, tfd.MAX_BK):
            assert got == bk
    assert tfd.decode_bk(512, S) == min(512, S)
    for d in tfa.DIMS:
        for g in (1, 5, 8, 16):
            assert tfd.smem_bytes(tfd.MAX_BK, d, g) <= 232_448


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
