"""Block assembly (port of ``repro.models.blocks``): one function per
layer kind.  The port serves

* "rwkv" — rwkv6 time mix + channel mix (handles its own norms);
* "attn" — global attention + a dense MLP, or the MoE MLP when
  ``cfg.moe`` is set (``repro_torch.models.moe``), with a bf16 or int8 KV
  cache (``cfg.kv_cache_dtype``);
* "swa_ssm" — hymba's hybrid: sliding-window attention (``local_window``,
  a ring cache of ``min(window, max_len)`` slots) and the SSD heads
  (``repro_torch.models.ssm``) run in parallel on the same normed input,
  their outputs mean-fused after a norm each, then the MLP.

"local" (gemma's sliding-window layers) and cross attention arrive with
their slices and raise until then.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant import dequantize_kv, quantize_kv
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import dot, mlp, mlp_specs, rmsnorm
from repro_torch.models.params import ParamSpec

F32 = torch.float32
SERVED_KINDS = ("rwkv", "attn", "swa_ssm")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet; the port serves the kinds "
        f"{SERVED_KINDS}, attention with a dense or an MoE MLP")


def block_specs(cfg: ModelConfig, kind: str) -> Dict[str, object]:
    if kind == "rwkv":
        return rwkv_lib.rwkv_specs(cfg)
    if kind not in ("attn", "swa_ssm"):
        raise _not_ported(f"layer kind {kind!r}")
    norm = lambda: ParamSpec((cfg.d_model,), F32, init="zeros")
    specs = {"norm1": norm(), "norm2": norm(),
             "attn": attn.attention_specs(cfg)}
    if cfg.moe is not None:
        specs["moe"] = moe_lib.moe_specs(cfg)
    else:
        specs["mlp"] = mlp_specs(cfg)
    if kind == "swa_ssm":
        specs["ssm"] = ssm_lib.ssm_specs(cfg)
        specs["attn_out_norm"] = norm()
        specs["ssm_out_norm"] = norm()
    return specs


# ---------------------------------------------------------------------------
# KV-cache entry helpers (bf16 or int8 storage)
# ---------------------------------------------------------------------------


def _kv_store_dtype(cfg: ModelConfig):
    return torch.int8 if cfg.kv_cache_dtype == "int8" else torch.bfloat16


def _encode_kv(cfg: ModelConfig, k, v):
    """(B, S, K, hd) -> cache tensors (+ scales when int8)."""
    if cfg.kv_cache_dtype == "int8":
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        return {"k": kq, "v": vq, "k_scale": ks[..., 0],
                "v_scale": vs[..., 0]}
    return {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}


def _decode_kv(cfg: ModelConfig, entry):
    if cfg.kv_cache_dtype == "int8":
        return (dequantize_kv(entry["k"], entry["k_scale"][..., None]),
                dequantize_kv(entry["v"], entry["v_scale"][..., None]))
    return entry["k"], entry["v"]


def attn_cache_entry(cfg: ModelConfig, kind: str, batch: int,
                     max_len: int) -> Dict[str, ParamSpec]:
    """ParamSpec tree of one attention cache entry (before stacking)."""
    n = attn.cache_slot_count(cfg, kind, max_len)
    K, hd = cfg.n_kv_heads, cfg.head_dim_
    dt = _kv_store_dtype(cfg)
    entry = {
        "k": ParamSpec((batch, n, K, hd), dt, init="zeros"),
        "v": ParamSpec((batch, n, K, hd), dt, init="zeros"),
        "pos": ParamSpec((batch, n), torch.int32, init="custom",
                         custom_init=lambda s, dev: torch.full(
                             s.shape, -1, dtype=s.dtype, device=dev)),
    }
    if cfg.kv_cache_dtype == "int8":
        entry["k_scale"] = ParamSpec((batch, n, K), F32, init="ones")
        entry["v_scale"] = ParamSpec((batch, n, K), F32, init="ones")
    return entry


# ---------------------------------------------------------------------------
# Attention sub-block
# ---------------------------------------------------------------------------


def _attn_seq(params, x, cfg: ModelConfig, positions, *, window: int,
              causal: bool = True, max_len: int = 0, tile_plan=None,
              mm_plan=None):
    """Full-sequence attention (prefill).  Returns (out, cache entry)."""
    B, S, _ = x.shape
    q, k, v = attn.project_qkv(params, x, cfg, positions, mm_plan=mm_plan)
    out = attn.flash_attention(
        q, k, v, positions, positions, cfg=cfg, causal=causal,
        window=window, tile_plan=tile_plan)
    out = dot(out.reshape(B, S, cfg.q_dim), params["wo"], mm_plan)
    n_slots = min(window, max_len or S) if window else (max_len or S)
    kc, vc, pc = attn.fill_cache_from_prefill(k, v, positions, n_slots)
    entry = _encode_kv(cfg, kc, vc)
    entry["pos"] = pc
    return out, entry


def _attn_step(params, x, cfg: ModelConfig, lengths, cache, *,
               window: int, positions=None, tile_plan=None, mm_plan=None):
    """One-token attention over the cache.  x: (B, 1, d).  Writes the new
    token at ``min(lengths, n_slots - 1)`` (``lengths % n_slots`` for a
    ring) into the cache tensors in place, so a CUDA graph of the tick
    keeps their addresses; returns (out, cache)."""
    B = x.shape[0]
    pos = positions if positions is not None else lengths[:, None]
    q, k, v = attn.project_qkv(params, x, cfg, pos, mm_plan=mm_plan)
    n_slots = cache["k"].shape[1]
    ring = window > 0 and n_slots <= window
    new_kv = _encode_kv(cfg, k, v)
    idx = (lengths % n_slots if ring
           else torch.clamp(lengths, max=n_slots - 1)).long()
    b = torch.arange(B, device=x.device)
    for name in ("k", "v", "k_scale", "v_scale"):
        if name in cache:
            cache[name][b, idx] = new_kv[name][:, 0]
    cache["pos"][b, idx] = lengths.to(torch.int32)
    kc, vc = _decode_kv(cfg, cache)
    out = attn.decode_attention(
        q[:, 0], kc, vc, cache["pos"], lengths, cfg=cfg, causal=True,
        window=window, tile_plan=tile_plan)
    out = dot(out.reshape(B, 1, cfg.q_dim).to(x.dtype), params["wo"],
              mm_plan)
    return out, cache


def _ffn(params, h, cfg: ModelConfig, mm_plan=None):
    """The block's MLP.  Serving discards the MoE MLP's auxiliary loss
    (the JAX block returns it for training)."""
    if cfg.moe is not None:
        return moe_lib.moe_mlp(params["moe"], h, cfg)[0]
    return mlp(params["mlp"], h, cfg, mm_plan)


def apply_block(params, x, cfg: ModelConfig, kind: str, *, positions=None,
                lengths=None, mode: str = "prefill",
                cache: Optional[Dict] = None, max_len: int = 0,
                tile_plan=None, mm_plan=None):
    """Returns (x, cache entry).  Decode writes the step into ``cache``
    in place and returns it; prefill returns a new entry.

    In prefill mode ``lengths`` (when not None) marks each example's true
    prompt length within a right-padded batch: recurrent state updates are
    the identity on padded steps, and attention masks padding through the
    -1 entries of ``positions`` (B, S).  In decode mode ``lengths`` is the
    cache's (the new token's position).  ``max_len`` sizes the attention
    cache a prefill fills.  ``tile_plan`` is this kind's ``tile_plans``
    entry (or None); for "swa_ssm" the model passes the ``"attn"`` entry,
    which routes its attention half (the JAX package keeps that half on
    jnp).  ``mm_plan`` is the ``"matmul_int8"`` entry, passed to every
    ``dot`` of the block (it routes int8 weights only)."""
    if kind == "rwkv":
        return rwkv_lib.rwkv_block(
            params, x, cfg, mode=mode, cache=cache,
            lengths=lengths if mode == "prefill" else None,
            tile_plan=tile_plan, mm_plan=mm_plan)
    if kind == "swa_ssm":
        return _swa_ssm_block(params, x, cfg, positions=positions,
                              lengths=lengths, mode=mode, cache=cache,
                              max_len=max_len, tile_plan=tile_plan,
                              mm_plan=mm_plan)
    if kind != "attn":
        raise _not_ported(f"layer kind {kind!r}")
    h = rmsnorm(x, params["norm1"], cfg.norm_eps)
    if mode == "decode":
        a_out, new_cache = _attn_step(params["attn"], h, cfg, lengths, cache,
                                      window=0, positions=positions,
                                      tile_plan=tile_plan, mm_plan=mm_plan)
    else:
        a_out, new_cache = _attn_seq(params["attn"], h, cfg, positions,
                                     window=0, max_len=max_len,
                                     tile_plan=tile_plan, mm_plan=mm_plan)
    x = x + a_out
    h = rmsnorm(x, params["norm2"], cfg.norm_eps)
    return x + _ffn(params, h, cfg, mm_plan), new_cache


def _swa_ssm_block(params, x, cfg: ModelConfig, *, positions, lengths,
                   mode: str, cache, max_len: int, tile_plan, mm_plan):
    """hymba's hybrid block: windowed attention and the SSD mixer on the
    same normed input, ``x + 0.5 * (rmsnorm(a) + rmsnorm(s))``, then the
    MLP.  Decode writes both halves' state into ``cache`` in place."""
    window = cfg.local_window
    h = rmsnorm(x, params["norm1"], cfg.norm_eps)
    if mode == "decode":
        a_out, _ = _attn_step(params["attn"], h, cfg, lengths, cache,
                              window=window, positions=positions,
                              tile_plan=tile_plan, mm_plan=mm_plan)
        s_out, _ = ssm_lib.ssm_mixer(params["ssm"], h, cfg, mode=mode,
                                     cache=cache, mm_plan=mm_plan)
        new_cache = cache
    else:
        a_out, new_cache = _attn_seq(params["attn"], h, cfg, positions,
                                     window=window, max_len=max_len,
                                     tile_plan=tile_plan, mm_plan=mm_plan)
        s_out, s_cache = ssm_lib.ssm_mixer(params["ssm"], h, cfg, mode=mode,
                                           lengths=lengths, mm_plan=mm_plan)
        new_cache.update(s_cache)
    fused = 0.5 * (rmsnorm(a_out, params["attn_out_norm"], cfg.norm_eps)
                   + rmsnorm(s_out, params["ssm_out_norm"], cfg.norm_eps))
    x = x + fused
    h = rmsnorm(x, params["norm2"], cfg.norm_eps)
    return x + _ffn(params, h, cfg, mm_plan), new_cache
