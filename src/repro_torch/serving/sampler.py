"""Token samplers (port of ``repro.serving.sampler``).

Randomness comes from a ``torch.Generator`` on the logits' device.  It
cannot give the bits of ``jax.random`` from the same seed, so sampled
tokens match the JAX package only under greedy decoding (temperature 0,
argmax, first index on ties as in ``jnp.argmax``).

A row is sampled by inverting its CDF at a uniform ``u``.  The engine's
decode loop passes its own uniforms (one a row, drawn from the engine's
generator once a chunk): a tick inside the loop's CUDA graph repeats the
same kernels with the same random offsets, so it cannot draw fresh
numbers itself.  Without ``u`` the uniforms are drawn from ``gen``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0      # 0 -> greedy
    top_k: int = 0                # 0 -> disabled


def sample(logits: torch.Tensor, gen: Optional[torch.Generator],
           cfg: SamplerConfig = SamplerConfig(),
           u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (B, V) -> tokens (B,) int32, on the logits' device.  ``u``
    (B,) in [0, 1), if given, replaces the draw from ``gen``."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / cfg.temperature
    if cfg.top_k > 0:
        kth = torch.topk(logits, cfg.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)
    if u is None:
        u = torch.rand((logits.shape[0],), generator=gen,
                       device=logits.device)
    # the first token whose CDF exceeds u: a token of probability 0 never
    # is (its CDF equals its predecessor's)
    cdf = torch.cumsum(probs, dim=-1)
    at = (u.to(cdf.dtype) * cdf[:, -1])[:, None].contiguous()
    tok = torch.searchsorted(cdf, at, right=True)[:, 0]
    return torch.clamp(tok, max=logits.shape[-1] - 1).to(torch.int32)


def split_and_sample(gen: Optional[torch.Generator], logits: torch.Tensor,
                     cfg: SamplerConfig = SamplerConfig()
                     ) -> Tuple[Optional[torch.Generator], torch.Tensor]:
    """The engine's convention, kept from the JAX package: one sampling
    event per call, returning (generator, tokens).  A generator advances
    in place, so it comes back as it went in."""
    return gen, sample(logits, gen, cfg)
