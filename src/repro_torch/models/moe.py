"""Mixture-of-experts MLP (port of ``repro.models.moe``): top-k routing,
GShard dispatch and combine.

Capacity is counted per token *group* of ``gs`` tokens, the (B, S) tokens
flattened row-major, so one row's output depends on the other rows of its
group: a token past its expert's capacity ``C`` is dropped (its combine
weight is zero), as in GShard/Switch.  Every rounding is the JAX
package's:

* the router runs in f32 on the f32 ``router`` leaf;
* top-k keeps the lower expert index among equal probabilities, as
  ``jax.lax.top_k`` does (a stable descending sort; ``torch.topk`` does
  not promise an order among ties);
* the slot one-hot is a comparison with ``arange(C)``, so a position past
  ``C`` gives a zero row as ``jax.nn.one_hot`` does, where
  ``torch.nn.functional.one_hot`` raises;
* dispatch is accumulated in bf16; ``expert_in`` is a bf16 product (one
  nonzero term a sum, so exact); ``up`` and ``gate`` are f32 sums of
  bf16 products; ``h`` is rounded to bf16; ``out_e`` is an f32 sum rounded
  to bf16; ``combine`` is rounded to bf16 and the final sum, in f32, is
  rounded to ``x.dtype``.

The expert products are plain batched matmuls (cuBLAS on the card), as
the JAX package leaves them to XLA: no Pallas kernel is involved.  The
dispatch is dense, as in JAX: every expert's weights are read whatever
the routing.  Nothing here reads a value back to the host or sizes a
tensor by data, so the decode step of an MoE model captures into the
engine's CUDA graph; the group size and ``C`` come from static shapes.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import silu
from repro_torch.models.params import ParamSpec

F32 = torch.float32
BF16 = torch.bfloat16
EXPERT_LEAVES = ("w_up", "w_gate", "w_down")


def moe_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """The JAX package's MoE leaves (before layer stacking), each drawn
    one layer at a time (``by_layer``): a full-width qwen3-moe expert leaf
    (48, 128, 2048, 768) would need a 38.7 GB f32 temporary whole."""
    d, f, m = cfg.d_model, cfg.d_ff, cfg.moe
    specs = {
        "router": ParamSpec((d, m.n_experts), F32, scale=0.02, by_layer=True),
        "w_up": ParamSpec((m.n_experts, d, f), F32, by_layer=True),
        "w_down": ParamSpec((m.n_experts, f, d), F32, by_layer=True),
    }
    if cfg.mlp_gated:
        specs["w_gate"] = ParamSpec((m.n_experts, d, f), F32, by_layer=True)
    return specs


def _group_size(cfg: ModelConfig, n_tokens: int) -> int:
    """The JAX package's token group with no mesh (one data shard): the
    largest divisor of ``n_tokens`` up to ``cfg.moe.group_size``."""
    gs = min(cfg.moe.group_size, max(1, n_tokens))
    while n_tokens % gs:
        gs -= 1
    return gs


def _bmm(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    """Batched a @ b of bf16 operands, the exact products summed in f32
    and the sum returned in ``out_dtype``: bf16 is one rounding of the f32
    sum (cuBLAS and the CPU's bf16 matmul accumulate in f32), f32 keeps
    it (one cuBLAS call with an f32 output on the card; the bf16 values
    multiplied in f32 on the CPU)."""
    if out_dtype == BF16:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=F32)
    return torch.bmm(a.to(F32), b.to(F32))


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest, ties to the
    lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_mlp(params, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d) in x.dtype, the auxiliary loss, an f32
    scalar).  An int8 expert leaf raises: the JAX package's MoE MLP has
    no int8 path (it casts each leaf to bf16)."""
    for name in EXPERT_LEAVES + ("router",):
        if isinstance(params.get(name), dict):
            raise ValueError(
                f"moe_mlp: the {name!r} leaf is int8; the MoE MLP has no "
                f"int8 expert path (the JAX package casts each expert "
                f"leaf to bf16), so an MoE arch serves bf16 weights")
    B, S, d = x.shape
    r = _route(params, x, cfg)
    G, gs, E, C = r["G"], r["gs"], cfg.moe.n_experts, r["C"]
    xg = x.reshape(G, gs, d)

    # ---- dispatch -> expert compute -> combine --------------------------
    # expert_in[e, g, c] = sum_s dispatch[g, s, e, c] x[g, s]: one nonzero
    # term, so the bf16 product is exact
    disp = r["dispatch"].permute(0, 2, 3, 1).reshape(G, E * C, gs)
    expert_in = torch.bmm(disp, xg.to(BF16))                     # (G, E*C, d)
    expert_in = expert_in.reshape(G, E, C, d).transpose(0, 1).reshape(
        E, G * C, d)
    up = _bmm(expert_in, params["w_up"].to(BF16), F32)           # (E, G*C, f)
    if cfg.mlp_gated:
        gate = _bmm(expert_in, params["w_gate"].to(BF16), F32)
        h = silu(gate) * up
    else:
        h = torch.nn.functional.gelu(up, approximate="tanh")
    h = h.to(BF16)
    out_e = _bmm(h, params["w_down"].to(BF16), BF16)             # (E, G*C, d)
    out_e = out_e.reshape(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)
    y = _bmm(r["combine"].to(BF16).reshape(G, gs, E * C), out_e,
             BF16 if x.dtype == BF16 else F32)
    y = y.reshape(B, S, d).to(x.dtype)

    # ---- aux losses -------------------------------------------------------
    # load balance: E * sum_e f_e * P_e  (f from top-1 assignment)
    experts = torch.arange(E, device=x.device)
    f_e = (r["top_idx"][..., 0, None] == experts).to(F32).mean(dim=(0, 1))
    p_e = r["probs"].mean(dim=(0, 1))
    balance = E * torch.sum(f_e * p_e)
    router_z = torch.mean(torch.square(torch.logsumexp(r["logits"], dim=-1)))
    aux = cfg.moe.router_aux_coef * balance + 1e-3 * router_z
    return y, aux


def _route(params, x: torch.Tensor, cfg: ModelConfig) -> Dict[str, object]:
    """Routing and the dispatch / combine tensors of ``x`` (B, S, d):
    router logits and probabilities (G, gs, E), the top-k picks, and
    dispatch (bf16) / combine (f32) of shape (G, gs, E, C), with the
    group count G, group size gs and capacity C."""
    m = cfg.moe
    B, S, d = x.shape
    n_tokens = B * S
    gs = _group_size(cfg, n_tokens)
    G = n_tokens // gs
    E, K = m.n_experts, m.top_k
    C = max(1, int(math.ceil(gs * K * m.capacity_factor / E)))
    dev = x.device
    xg = x.reshape(G, gs, d)

    # ---- routing (f32) --------------------------------------------------
    logits = torch.matmul(xg.to(F32), params["router"].to(F32))  # (G, gs, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_idx = _top_k(probs, K)                             # (G, gs, K)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # ---- position-in-expert, slot by slot -------------------------------
    experts = torch.arange(E, device=dev)
    slots = torch.arange(C, device=dev, dtype=torch.int32)
    dispatch = torch.zeros((G, gs, E, C), dtype=BF16, device=dev)
    combine = torch.zeros((G, gs, E, C), dtype=F32, device=dev)
    counts = torch.zeros((G, E), dtype=F32, device=dev)
    for j in range(K):
        oh = (top_idx[..., j, None] == experts).to(F32)           # (G, gs, E)
        pos = counts[:, None, :] + torch.cumsum(oh, dim=1) - oh
        keep = (pos < C).to(F32) * oh
        slot = (pos.to(torch.int32)[..., None] == slots).to(F32)  # (G,gs,E,C)
        dj = keep[..., None] * slot
        dispatch = dispatch + dj.to(BF16)
        combine = combine + dj * top_p[..., j][..., None, None]
        counts = counts + oh.sum(dim=1)
    return dict(logits=logits, probs=probs, top_idx=top_idx,
                dispatch=dispatch, combine=combine, G=G, gs=gs, C=C)


__all__ = ["EXPERT_LEAVES", "moe_specs", "moe_mlp"]
