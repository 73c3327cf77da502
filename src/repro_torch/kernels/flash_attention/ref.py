"""Plain PyTorch versions of the flash attention kernels (port of
``repro.kernels.flash_attention.ref`` and of what the two Pallas kernels
compute).

* :func:`attention_ref` — the naive oracle (full score matrix in f32,
  iota masks), copied from the JAX package; small shapes only.
* :func:`flash_attention_plain` — what ``flash_attention``'s
  position-array body (``_kernel_pos``) computes: bf16 q/k/v, scores
  ``q.k * scale`` summed in f32, soft-cap, the masks (``kv_pos >= 0``,
  causal, window) set to ``NEG_INF = -1e30`` (not -inf: a fully masked
  row stays finite), an online softmax over ``bk``-key tiles with p
  rounded to bf16 before the AV product, and ``acc / max(l, 1e-30)``
  rounded to the output dtype.
* :func:`flash_decode_plain` — what ``flash_decode`` computes: per
  ``bk``-slot chunk the partials (m, l, acc) with the *unnormalised* p
  rounded to bf16 before the AV product, then the log-sum-exp combine
  over the chunks, in f32.

Both take the KV heads un-expanded (``H % Hkv == 0``; query head h reads
KV head ``h // (H // Hkv)``), which equals the JAX package's expanded
form.  A ragged last tile or chunk is simply shorter: keys past the end
take no part, where a masked key inside the range counts as ``NEG_INF``.
"""

from __future__ import annotations

import math

import torch

F32 = torch.float32
BF16 = torch.bfloat16
NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0):
    """q, k, v (B, H, S, d), heads already expanded.  Returns q's dtype."""
    B, H, Sq, d = q.shape
    Skv = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(F32), k.to(F32))
    s = s / math.sqrt(d)
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.to(F32)).to(q.dtype)


def _mask(qp, kvp, causal: bool, window: int):
    """(B, [1, 1,] Sq, n) validity from q positions (B, Sq) and key
    positions (B, n)."""
    m = (kvp >= 0)[:, None, :]
    if causal:
        m = m & (kvp[:, None, :] <= qp[:, :, None])
    if window > 0:
        m = m & ((qp[:, :, None] - kvp[:, None, :]) < window)
    return m


def _scores(qg, kb, scale: float, softcap: float):
    """f32 scores of bf16 operands: qg (B, Hkv, G, Sq, d), kb
    (B, Hkv, n, d) -> (B, Hkv, G, Sq, n)."""
    s = torch.matmul(qg.to(BF16).to(F32),
                     kb.to(BF16).to(F32).transpose(-1, -2)[:, :, None])
    s = s * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    return s


def flash_attention_plain(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                          window: int = 0, softcap: float = 0.0,
                          bk: int = 512):
    """q (B, H, Sq, d); k, v (B, Hkv, Skv, d); q_pos (B, Sq), kv_pos
    (B, Skv) int32 (-1 masks).  Returns (B, H, Sq, d) in q's dtype."""
    B, H, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(B, Hkv, G, Sq, d)
    neg = torch.full((), NEG_INF, device=q.device)
    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=F32, device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), dtype=F32, device=q.device)
    acc = torch.zeros((B, Hkv, G, Sq, d), dtype=F32, device=q.device)
    bk = max(1, int(bk))
    for s0 in range(0, Skv, bk):
        s1 = min(s0 + bk, Skv)
        s = _scores(qg, k[:, :, s0:s1], scale, softcap)
        ok = _mask(q_pos, kv_pos[:, s0:s1], causal, window)
        s = torch.where(ok[:, None, None], s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.matmul(p.to(BF16).to(F32),
                          v[:, :, None, s0:s1].to(BF16).to(F32))
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, H, Sq, d).to(q.dtype)


def flash_decode_plain(q, k, v, kv_pos, q_pos, *, causal: bool = True,
                       window: int = 0, softcap: float = 0.0,
                       bk: int = 512):
    """q (B, H, d); k, v (B, Hkv, S, d); kv_pos (B, S) (-1 = empty
    slot); q_pos (B,).  Returns (B, H, d) f32."""
    B, H, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(B, Hkv, G, 1, d)
    neg = torch.full((), NEG_INF, device=q.device)
    ms, ls, accs = [], [], []
    bk = max(1, int(bk))
    for s0 in range(0, S, bk):
        s1 = min(s0 + bk, S)
        s = _scores(qg, k[:, :, s0:s1], scale, softcap)[..., 0, :]
        ok = _mask(q_pos[:, None], kv_pos[:, s0:s1], causal, window)[:, 0]
        s = torch.where(ok[:, None, None], s, neg)       # (B, Hkv, G, n)
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.matmul(p.to(BF16).to(F32)[..., None, :],
                                 v[:, :, None, s0:s1].to(BF16).to(F32)
                                 )[..., 0, :])
    m_p, l_p, acc_p = (torch.stack(ms, -1), torch.stack(ls, -1),
                       torch.stack(accs, -2))
    return lse_combine(m_p.reshape(B, H, -1), l_p.reshape(B, H, -1),
                       acc_p.reshape(B, H, -1, d))


def lse_combine(m_p, l_p, acc_p):
    """Merge per-chunk partials: m_p, l_p (B, H, nk), acc_p (B, H, nk, d)
    -> (B, H, d) f32, as ``flash_decode.py`` combines outside its kernel."""
    m_g = m_p.amax(dim=2)
    alpha = torch.exp(m_p - m_g[:, :, None])
    l_g = (alpha * l_p).sum(dim=2)
    out = (alpha[..., None] * acc_p).sum(dim=2)
    return out / torch.clamp(l_g, min=1e-30)[..., None]


__all__ = ["NEG_INF", "attention_ref", "flash_attention_plain",
           "flash_decode_plain", "lse_combine"]
