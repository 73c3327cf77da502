"""The LM wrapper (port of ``repro.models.lm``): parameters, cache,
prefill and decode.

Parameters and caches keep the JAX package's trees: per-layer leaves are
stacked on a leading layer axis under ``blocks["p<i>"]`` (one entry per
kind of the layer pattern), and the serving cache is
``{"blocks": {"p0": {...}}, "lengths"}`` with ``wkv_state``/``tm_shift``/
``cm_shift`` for rwkv, ``k``/``v``/``pos`` (+ ``k_scale``/``v_scale``
for an int8 KV cache) for attention, and ``k``/``v``/``pos`` +
``conv_state``/``ssd_state`` for hymba's "swa_ssm" layers.  Where the
JAX package scans over the stack with ``lax.scan``, the port loops over
layers in Python and indexes the stacked tensors as views.

Entry points that create tensors (``init``, ``init_serving``,
``init_cache``) run on the current CUDA device unless given
``device="cpu"``, and raise without a GPU otherwise.  ``loss`` and the
encoder arrive with later slices.

An int8-weight tree is ``repro_torch.core.quant.quantize_tree(params)``,
as in the JAX package; every ``dot`` of a block gets the
``tile_plans["matmul_int8"]`` entry, which sends its int8 leaves to the
``matmul_w8a16`` kernel on CUDA (``{"impl": "plain"}`` keeps the JAX
package's dequantize-then-multiply).  The head stays on that plain path.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import params as pspec
from repro_torch.models.blocks import (apply_block, attn_cache_entry,
                                       block_specs)
from repro_torch.models.layers import embed, embed_specs, rmsnorm, unembed
from repro_torch.models.params import ParamSpec, tree_map, tree_map_named
from repro_torch.models.rwkv import DOT_LEAVES as RWKV_DOT_LEAVES
from repro_torch.models.ssm import _d_inner, _n_ssm_heads

F32 = torch.float32
BF16 = torch.bfloat16
# leaves read only through ``dot``/``wcast``/``embed``/``unembed``, added
# to a ``dot`` result in bf16 (the qkv biases) or cast to bf16 where read
# (the MoE expert leaves, by the dense MLP's names): rwkv's, attention's,
# the MLP's and the experts', the SSD mixer's three projections, and the
# embedding and head.  The MoE ``router`` is read in f32 and stays f32,
# as do the SSD mixer's ``w_dt`` (an f32 product), ``conv_kernel`` and
# ``conv_bias`` (cast at their use) and its scalars and norm.
DOT_LEAVES = RWKV_DOT_LEAVES | frozenset({
    "wq", "wk", "wv", "wo", "bq", "bk", "bv", "w_up", "w_gate", "w_down",
    "w_in", "w_bc", "w_out", "embedding", "lm_head"})


def build_model(cfg: ModelConfig, tile_plans=None) -> "LM":
    return LM(cfg, tile_plans=tile_plans)


def build_served(arch: str, reduced: bool, device, *, int8: bool = False):
    """``(model, params)`` as the launcher and the router serve ``arch``
    (its reduced config with ``reduced``): ``init_serving`` from a
    ``torch.Generator`` seeded 0 on ``device``, and ``quantize_tree`` of
    that tree with ``int8``.  An MoE arch refuses ``int8`` whatever its
    width: its MLP has no int8 expert path (``repro_torch.models.moe``),
    and at reduced width ``quantize_tree`` leaves its narrow expert
    leaves in bf16.  An SSM arch (hymba) refuses it too: int8 hymba is
    not ported yet."""
    from repro_torch.configs import get_config
    from repro_torch.core.quant import quantize_tree
    from repro_torch.testing import reduced_config

    model = build_model(reduced_config(arch) if reduced else get_config(arch))
    if int8 and model.cfg.moe is not None:
        raise ValueError(
            f"{arch}: int8 weights are not served for an MoE arch: the MoE "
            f"MLP has no int8 expert path (the JAX package casts each "
            f"expert leaf to bf16); serve it with bf16 weights")
    if int8 and model.cfg.ssm is not None:
        raise ValueError(
            f"{arch}: int8 weights are not served for an SSM arch yet; "
            f"serve it with bf16 weights")
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init_serving(gen, device)
    if int8:
        params = quantize_tree(params, consume=True)
    return model, params


class LM:
    def __init__(self, cfg: ModelConfig, tile_plans=None):
        self.cfg = cfg
        # per-kind kernel plan entries (ServingPlan.tile_plans); each
        # reaches the apply_block call of its kind
        self.tile_plans = dict(tile_plans or {})

    def with_tile_plans(self, tile_plans) -> "LM":
        """A copy of this model whose blocks run under ``tile_plans``."""
        return type(self)(self.cfg, tile_plans=tile_plans)

    # ------------------------------------------------------------ params
    def param_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        specs: Dict[str, Any] = dict(embed_specs(cfg))
        specs["final_norm"] = ParamSpec((cfg.d_model,), F32, init="zeros")
        period = {f"p{i}": block_specs(cfg, kind)
                  for i, kind in enumerate(cfg.layer_pattern)}
        specs["blocks"] = pspec.tree_stack_specs(period, cfg.n_periods)
        return specs

    def init(self, gen: torch.Generator, device=None):
        """Random parameters (f32, as in the JAX package) from ``gen``,
        which must live on ``device``."""
        return pspec.tree_init(self.param_specs(), gen, device)

    def init_serving(self, gen: torch.Generator, device=None):
        """``serving_params(init(gen, device))`` built one leaf at a time:
        each leaf is drawn in f32 from ``gen`` in the same order, cast,
        and its f32 copy released before the next, so the peak is the
        served tree plus one f32 leaf (qwen2.5-14b: ~29.5 GB served; the
        whole f32 tree would be ~59 GB).  An MoE leaf is drawn one layer
        slice at a time (``ParamSpec.by_layer``, as ``init`` draws it), so
        its f32 temporary is one slice (qwen3-moe-30b-a3b: 128 x 2048 x
        768).  Bit-identical to the two-step form."""
        dev = resolve_device(device)
        return tree_map_named(
            lambda name, s: s.initialize(
                gen, dev, BF16 if name in DOT_LEAVES else None),
            self.param_specs())

    def n_params(self) -> int:
        return pspec.tree_size(self.param_specs())

    @staticmethod
    def serving_params(params) -> Dict[str, Any]:
        """``params`` with every leaf in ``DOT_LEAVES`` (read only through
        ``dot``/``wcast``/``embed``, or a qkv bias added in bf16) stored
        in bf16, cast once here.  The JAX package keeps f32 leaves and
        rounds them to bf16 at each use; the values the matmuls see are
        the same bits, but a decode step no longer makes a bf16 copy of
        every weight.  Leaves read in f32 (norm scales, ``mu*``,
        ``lora_b``, ``decay_base``, ``decay_b``, ``bonus``) stay f32."""
        return tree_map_named(_serve_leaf, params)

    # ------------------------------------------------------- layer stack
    def _layers(self, blocks, x, *, positions=None, lengths=None, mode: str,
                cache=None, max_len: int = 0):
        """Apply every layer in order.  Prefill returns (x, the stacked
        new cache); decode writes each layer's step into its views of the
        stacked ``cache`` in place and returns (x, cache)."""
        cfg = self.cfg
        mm_plan = self.tile_plans.get("matmul_int8")
        per_layer: List[Dict[str, Any]] = []
        for layer in range(cfg.n_periods):
            p_params = tree_map(lambda a: a[layer], blocks)
            p_cache = (tree_map(lambda a: a[layer], cache)
                       if cache is not None else None)
            new: Dict[str, Any] = {}
            for i, kind in enumerate(cfg.layer_pattern):
                key = f"p{i}"
                x, new[key] = apply_block(
                    p_params[key], x, cfg, kind, positions=positions,
                    lengths=lengths, mode=mode,
                    cache=p_cache[key] if p_cache is not None else None,
                    max_len=max_len, tile_plan=self.tile_plans.get(
                        _PLAN_KIND.get(kind, kind)),
                    mm_plan=mm_plan)
            per_layer.append(new)
        if mode == "decode":
            return x, cache
        return x, tree_map(lambda *xs: torch.stack(xs), *per_layer)

    def final_hidden_to_logits(self, params, x) -> torch.Tensor:
        x = rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
        return unembed(params, x, self.cfg)

    # ------------------------------------------------------------- cache
    def cache_specs(self, batch: int, max_len: int) -> Dict[str, Any]:
        """ParamSpec tree of the serving cache (decode input).  ``max_len``
        sizes the attention caches (k/v/pos slots; a "swa_ssm" layer's
        ring holds ``min(local_window, max_len)``)."""
        cfg = self.cfg
        period: Dict[str, Any] = {}
        for i, kind in enumerate(cfg.layer_pattern):
            if kind != "rwkv":
                entry = attn_cache_entry(cfg, kind, batch, max_len)
                if kind == "swa_ssm":
                    s = cfg.ssm
                    di, nh = _d_inner(cfg), _n_ssm_heads(cfg)
                    entry["conv_state"] = ParamSpec(
                        (batch, s.conv_width - 1, di), BF16, init="zeros")
                    entry["ssd_state"] = ParamSpec(
                        (batch, nh, s.d_state, s.head_dim), F32,
                        init="zeros")
                period[f"p{i}"] = entry
                continue
            H, hd = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
            period[f"p{i}"] = {
                "wkv_state": ParamSpec((batch, H, hd, hd), F32, init="zeros"),
                "tm_shift": ParamSpec((batch, cfg.d_model), BF16,
                                      init="zeros"),
                "cm_shift": ParamSpec((batch, cfg.d_model), BF16,
                                      init="zeros"),
            }
        return {"blocks": pspec.tree_stack_specs(period, cfg.n_periods),
                "lengths": ParamSpec((batch,), torch.int32, init="zeros")}

    def init_cache(self, batch: int, max_len: int, device=None):
        dev = resolve_device(device)
        return tree_map(lambda s: s.initialize(None, dev),
                        self.cache_specs(batch, max_len))

    def reset_cache_(self, cache, max_len: int) -> None:
        """Put every leaf of ``cache`` (from :meth:`init_cache` with this
        ``max_len``) back to its initial value, in place."""
        specs = self.cache_specs(int(cache["lengths"].shape[0]), max_len)

        def reset(t, s):
            if tuple(t.shape) != tuple(s.shape) or t.dtype != s.dtype:
                raise ValueError(f"reset_cache_: a {t.dtype} "
                                 f"{tuple(t.shape)} leaf where the cache of "
                                 f"max_len {max_len} has {s.dtype} {s.shape}")
            if s.init == "zeros":
                t.zero_()
            elif s.init == "ones":
                t.fill_(1)
            else:
                t.copy_(s.initialize(None, t.device))

        tree_map(reset, cache, specs)

    def cache_batch_axes(self, cache) -> Dict[str, Any]:
        """Batch (= slot) axis of every cache leaf: 1 under ``blocks``
        (axis 0 is the layer), 0 for ``lengths``.  The slot-state manager
        keys its gathers and scatters on this tree."""
        return {"blocks": tree_map(lambda _: 1, cache["blocks"]),
                "lengths": 0}

    # the KV-ring leaves, paged along their ring axis by the paged slot
    # manager; rwkv state, the SSD mixer's conv and ssd state and
    # ``lengths`` stay one column a slot
    PAGEABLE_LEAVES = frozenset({"k", "v", "pos", "k_scale", "v_scale"})

    def cache_page_axes(self, cache) -> Dict[str, Any]:
        """Ring axis of every pageable cache leaf (2: after the layer and
        slot axes), None for per-slot state: the tree the paged slot
        manager (:mod:`repro_torch.serving.paged`) splits the cache by.
        Takes a live cache or a :meth:`cache_specs` tree (leaves are told
        apart by name, not by value)."""
        return {"blocks": tree_map_named(
            lambda name, _: 2 if name in self.PAGEABLE_LEAVES else None,
            cache["blocks"]), "lengths": None}

    # ----------------------------------------------------------- prefill
    def prefill(self, params, batch, max_len: int = 0):
        """Full-sequence prefill.  Returns (cache, last-token logits f32).

        ``batch["lengths"]`` (B,) int32, when present, marks each
        example's true prompt length within a right-padded batch: the
        recurrent state is left as it was on padded steps, the logits are
        read at each example's last valid token, attention masks the
        padded positions (position -1) and the cache records the true
        lengths, so one padded batched call equals per-example
        exact-length prefills.  ``max_len`` (default S) sizes the attention
        caches."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        max_len = max_len or S
        lengths = batch.get("lengths")
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
        if lengths is not None:
            lengths = lengths.to(torch.int32)
            positions = torch.where(positions < lengths[:, None], positions,
                                    torch.full_like(positions, -1))
        x = embed(params, tokens, self.cfg)
        x, caches = self._layers(params["blocks"], x, positions=positions,
                                 lengths=lengths, mode="prefill",
                                 max_len=max_len)
        if lengths is None:
            h_last = x[:, -1:, :]
            cache_lengths = torch.full((B,), S, dtype=torch.int32,
                                       device=tokens.device)
        else:
            idx = torch.clamp(lengths.long() - 1, min=0)
            h_last = x[torch.arange(B, device=x.device), idx][:, None]
            cache_lengths = lengths
        logits = self.final_hidden_to_logits(params, h_last)
        return {"blocks": caches, "lengths": cache_lengths}, logits[:, 0]

    # ------------------------------------------------------------ decode
    def decode_step_(self, params, cache, tokens) -> torch.Tensor:
        """One decode step, in place.  tokens: (B,) int.  Writes every
        layer's new K/V (and scales), ``pos``, ``wkv_state`` and shifts,
        ``conv_state`` and ``ssd_state`` into its views of the stacked
        ``cache`` and advances ``cache["lengths"]``, as the JAX engine's
        donated cache is
        updated in place; nothing is cloned or restacked, so a CUDA graph
        of the step keeps the cache's addresses.  Returns the logits
        (B, V) f32."""
        lengths = cache["lengths"]
        x = embed(params, tokens[:, None], self.cfg)
        x, _ = self._layers(params["blocks"], x, positions=lengths[:, None],
                            lengths=lengths, mode="decode",
                            cache=cache["blocks"])
        logits = self.final_hidden_to_logits(params, x)
        lengths.add_(1)
        return logits[:, 0]

    def decode_step(self, params, cache, tokens):
        """One decode step.  tokens: (B,) int.  Returns (new cache,
        logits (B, V) f32); the input cache is left as it was: the step
        runs :meth:`decode_step_` on a copy of the tree."""
        new = tree_map(torch.clone, cache)
        return new, self.decode_step_(params, new, tokens)


# the tile_plans entry each kind's blocks read where it is not the kind's
# own: hymba's attention half runs under the "attn" entry (the
# "swa_ssm" entry is the planner's, for the SSD recurrence)
_PLAN_KIND = {"swa_ssm": "attn"}


def _serve_leaf(name: str, leaf):
    # an int8 leaf's "q"/"scale" are not in DOT_LEAVES: left as they are
    return leaf.to(BF16) if name in DOT_LEAVES else leaf


__all__ = ["DOT_LEAVES", "LM", "build_model"]
