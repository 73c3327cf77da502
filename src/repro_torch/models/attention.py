"""Attention (port of ``repro.models.attention``): projections, blockwise
flash attention for prefill, decode attention over a KV cache, and the
KV-cache helpers.

Each of the two attention call sites is routed by the ``"attn"`` tile
plan entry through :func:`repro_torch.kernels.dispatch.resolve_impl`; a
missing entry (None) resolves as ``{"impl": "auto"}``: on a CUDA device
the hand-written kernels run (``flash_attention`` for prefill,
``flash_decode`` for decode), on the CPU the plain paths below.  (The JAX
package takes its jnp path whenever the entry is missing.)

The plain paths copy the JAX package's jnp paths, so the CPU parity tests
hold them to JAX:

* :func:`flash_attention` — the online softmax over ``kv_block_size``
  blocks, unrolled the same way, so the block partition (and with it the
  rounding) is JAX's; the GQA grouped form (B, K, G, S, hd), which gives
  the same values as repeating the KV heads.
* :func:`decode_attention` — one softmax over the whole cache with the
  *normalised* p rounded to bf16 before the AV product.  The
  ``flash_decode`` kernel rounds the unnormalised p of each chunk and
  divides at the end, as the TPU kernel does, so the two decode paths
  differ by bf16 ulps by construction.

There is no sharder: the port runs on one card.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.dispatch import resolve_impl
from repro_torch.models.layers import apply_rope, dot
from repro_torch.models.params import ParamSpec

F32 = torch.float32
BF16 = torch.bfloat16
NEG_INF = -1e30

# Maximum number of unrolled KV blocks; the block size grows with sequence
# length so the unrolled loop stays bounded.
MAX_KV_BLOCKS = 8
MIN_KV_BLOCK = 512


def kv_block_size(skv: int) -> int:
    block = max(MIN_KV_BLOCK, -(-skv // MAX_KV_BLOCKS))
    return -(-block // 128) * 128


# ---------------------------------------------------------------------------
# Parameter specs and projections
# ---------------------------------------------------------------------------


def attention_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    specs = {
        "wq": ParamSpec((d, qd), F32),
        "wk": ParamSpec((d, kvd), F32),
        "wv": ParamSpec((d, kvd), F32),
        "wo": ParamSpec((qd, d), F32),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((qd,), F32, init="zeros")
        specs["bk"] = ParamSpec((kvd,), F32, init="zeros")
        specs["bv"] = ParamSpec((kvd,), F32, init="zeros")
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((cfg.head_dim_,), F32, init="zeros")
        specs["k_norm"] = ParamSpec((cfg.head_dim_,), F32, init="zeros")
    return specs


def _headnorm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    dtype = x.dtype
    x = x.to(F32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * (1.0 + scale.to(F32))).to(dtype)


def project_qkv(params, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, rope: bool = True, mm_plan=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> q (B, S, H, hd), k/v (B, S, K, hd), rope applied.
    The bias is added in bf16 after the matmul's rounding, as in JAX (so
    it stays out of the W8A16 kernel's f32 epilogue).  ``mm_plan`` routes
    int8 weights (``layers.dot``)."""
    B, S, _ = x.shape
    hd, H, K = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    q = dot(x, params["wq"], mm_plan)
    k = dot(x, params["wk"], mm_plan)
    v = dot(x, params["wv"], mm_plan)
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, K, hd)
    v = v.reshape(B, S, K, hd)
    if cfg.qk_norm:
        q = _headnorm(q, params["q_norm"], cfg.norm_eps)
        k = _headnorm(k, params["k_norm"], cfg.norm_eps)
    if rope:
        if cfg.m_rope_sections:
            raise NotImplementedError("m-rope is not ported yet")
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# Blockwise flash attention (prefill)
# ---------------------------------------------------------------------------


def flash_attention(q, k, v, q_pos, kv_pos, *, cfg: ModelConfig,
                    causal: bool = True, window: int = 0, block: int = 0,
                    tile_plan=None) -> torch.Tensor:
    """Online-softmax attention.  q: (B, Sq, H, hd); k, v: (B, Skv, K, hd);
    positions (B, S) int32 (-1 masks).  Returns (B, Sq, H, hd) in q's
    dtype.  Routed by ``tile_plan`` (a missing entry is "auto")."""
    if resolve_impl(tile_plan, q.device) == "kernel":
        from repro_torch.kernels.flash_attention import ops as flash_ops

        out = flash_ops.attention(
            q, k, v, causal=causal, window=window, softcap=cfg.attn_softcap,
            q_pos=q_pos, kv_pos=kv_pos, plan=tile_plan)
        return out.to(q.dtype)
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    softcap = cfg.attn_softcap
    dev = q.device

    # grouped views: q (B, K, G, Sq, hd); kv (B, K, Skv, hd)
    qf = q.reshape(B, Sq, K, G, hd).permute(0, 2, 3, 1, 4).to(BF16).to(F32)
    kg = k.permute(0, 2, 1, 3)
    vg = v.permute(0, 2, 1, 3)
    block = block or (cfg.attn_block or kv_block_size(Skv))
    neg = torch.full((), NEG_INF, dtype=F32, device=dev)

    m = torch.full((B, K, G, Sq), NEG_INF, dtype=F32, device=dev)
    l = torch.zeros((B, K, G, Sq), dtype=F32, device=dev)
    acc = torch.zeros((B, K, G, Sq, hd), dtype=F32, device=dev)
    qp = q_pos[:, None, None, :, None]
    for s0 in range(0, Skv, block):
        s1 = min(s0 + block, Skv)
        kb = kg[:, :, s0:s1].to(BF16).to(F32)[:, :, None]
        vb = vg[:, :, s0:s1].to(BF16).to(F32)[:, :, None]
        pb = kv_pos[:, s0:s1][:, None, None, None, :]           # (B,1,1,1,bk)
        logits = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        if softcap > 0.0:
            logits = softcap * torch.tanh(logits / softcap)
        mask = pb >= 0
        if causal:
            mask = mask & (pb <= qp)
        if window > 0:
            mask = mask & ((qp - pb) < window)
        logits = torch.where(mask, logits, neg)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p.to(BF16).to(F32), vb)
        m = m_new

    out = acc / torch.clamp(l[..., None], min=1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Decode attention (one token against a cache)
# ---------------------------------------------------------------------------


def decode_attention(q, k_cache, v_cache, kv_pos, q_pos, *,
                     cfg: ModelConfig, causal: bool = True, window: int = 0,
                     tile_plan=None) -> torch.Tensor:
    """q: (B, H, hd); caches: (B, S, K, hd); kv_pos: (B, S) absolute
    positions (-1 = empty slot); q_pos: (B,).  Returns (B, H, hd) bf16.
    Routed by ``tile_plan`` (a missing entry is "auto")."""
    if resolve_impl(tile_plan, q.device) == "kernel":
        from repro_torch.kernels.flash_attention import ops as flash_ops

        return flash_ops.decode(
            q, k_cache, v_cache, kv_pos, q_pos, causal=causal,
            window=window, softcap=cfg.attn_softcap, plan=tile_plan)
    B, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)

    qg = q.reshape(B, K, G, hd).to(BF16).to(F32)
    kc = k_cache.to(BF16).to(F32).permute(0, 2, 3, 1)           # (B,K,hd,S)
    logits = torch.matmul(qg, kc) * scale                        # (B,K,G,S)
    if cfg.attn_softcap > 0.0:
        c = cfg.attn_softcap
        logits = c * torch.tanh(logits / c)

    mask = kv_pos >= 0
    if causal:
        mask = mask & (kv_pos <= q_pos[:, None])
    if window > 0:
        mask = mask & ((q_pos[:, None] - kv_pos) < window)
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.full((), NEG_INF, device=q.device))

    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    vc = v_cache.to(BF16).to(F32).permute(0, 2, 1, 3)           # (B,K,S,hd)
    out = torch.matmul(p.to(BF16).to(F32), vc)                   # (B,K,G,hd)
    return out.reshape(B, H, hd).to(BF16)


# ---------------------------------------------------------------------------
# KV-cache helpers
# ---------------------------------------------------------------------------


def cache_slot_count(cfg: ModelConfig, kind: str, max_len: int) -> int:
    if kind == "local" or (kind == "swa_ssm" and cfg.local_window):
        return min(cfg.local_window, max_len)
    return max_len


def update_cache(k_cache, v_cache, kv_pos, k_new, v_new, lengths, *,
                 n_slots: int, ring: bool):
    """Insert one token per sequence, in place (the JAX package returns
    updated copies; its donated serving cache is updated in place too).
    k_new/v_new: (B, K, hd); lengths: (B,) current lengths (the new
    token's absolute position).  Returns the three cache tensors."""
    B = k_new.shape[0]
    idx = (lengths % n_slots if ring else lengths).long()
    b = torch.arange(B, device=k_new.device)
    k_cache[b, idx] = k_new.to(k_cache.dtype)
    v_cache[b, idx] = v_new.to(v_cache.dtype)
    kv_pos[b, idx] = lengths.to(kv_pos.dtype)
    return k_cache, v_cache, kv_pos


def fill_cache_from_prefill(k, v, positions, n_slots: int):
    """Build (cache, cache_pos) from prefill-computed k/v (B, S, K, hd).

    ``positions`` (B, S) carries each token's absolute position, -1 for
    padding (right-padded bucketed prefill).  Per example, the last
    ``n_slots`` valid tokens are kept at their ring slots (slot = pos %
    n_slots); unfilled slots get pos -1."""
    lengths = (positions >= 0).to(torch.int32).sum(dim=1)           # (B,)
    s = torch.arange(n_slots, dtype=torch.int32,
                     device=k.device)[None, :]                      # (1, n)
    last = lengths[:, None] - 1                                     # (B, 1)
    p = last - torch.remainder(last - s, n_slots)                   # (B, n)
    idx = torch.clamp(p, min=0).long()[:, :, None, None].expand(
        -1, -1, k.shape[2], k.shape[3])
    kc = torch.gather(k, 1, idx)
    vc = torch.gather(v, 1, idx)
    pos = torch.where(p >= 0, p, torch.full_like(p, -1)).to(torch.int32)
    return kc, vc, pos


__all__ = ["NEG_INF", "kv_block_size", "attention_specs",
           "project_qkv", "flash_attention", "decode_attention",
           "cache_slot_count", "update_cache", "fill_cache_from_prefill"]
