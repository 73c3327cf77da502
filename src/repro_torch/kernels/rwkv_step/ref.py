"""Plain PyTorch version of the fused RWKV6 step kernel (port of
``repro.kernels.rwkv_step.ref``): the model's own
``linear_attention_step`` looped over the tokens, y rounded to bf16 and
the state kept in f32."""

from __future__ import annotations

import torch

from repro_torch.models.recurrence import linear_attention_step

F32 = torch.float32


def rwkv6_step_ref(r, k, v, w_log, u, state):
    """r/k/w_log (T, B, H, K); v (T, B, H, V); u (H, K); state (B, H, K, V).
    Returns (y (T, B, H, V) bf16, state' (B, H, K, V) f32)."""
    S = state.to(F32)
    ys = []
    for rt, kt, vt, wt in zip(r, k, v, w_log):
        y, S = linear_attention_step(S, rt, kt, vt, wt,
                                     convention="exclusive", u=u)
        ys.append(y.to(torch.bfloat16))
    if not ys:
        return v.to(torch.bfloat16), S
    return torch.stack(ys), S
