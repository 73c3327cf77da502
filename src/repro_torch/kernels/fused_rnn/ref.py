"""Plain PyTorch versions of the fused RNN kernels (port of
``repro.kernels.fused_rnn.ref``).

Same numerics as the kernels: x and h rounded to bf16 before the
product, int8 (or bf16) weights widened exactly to f32, f32
accumulation, the per-(gate, unit) scale applied after the sum, y in
bf16 and h_T/c_T in f32.  ``fused_lstm_ref``/``fused_gru_ref`` define the
functions; the streaming kernels compute them in two parts, and
``xproj_ref`` (the input half for all T at once) and
``lstm_steps_ref``/``gru_steps_ref`` (the recurrence on it) are those
parts' plain versions.  Products of bf16 by int8/bf16 values are exact
in f32, so the f32 matmul here differs from the kernel only in the order
of the f32 sum.  On a GPU the caller must keep TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``, the default).
"""

from __future__ import annotations

import torch

F32 = torch.float32


def _proj(v, w, s):
    """(N, R) x (R, G, H) -> (N, G, H): bf16 operand, f32 sums, the scale
    after the sum."""
    R, G, H = w.shape
    z = (v.to(torch.bfloat16).to(F32) @ w.to(F32).reshape(R, G * H)
         ).reshape(-1, G, H)
    return z if s is None else z * s[None]


def _lstm_cell(z, c):
    """Gates (i, j, f, o) from z (B, 4, H): returns (h, c)."""
    i = torch.sigmoid(z[:, 0])
    j = torch.tanh(z[:, 1])
    f = torch.sigmoid(z[:, 2])
    o = torch.sigmoid(z[:, 3])
    c = f * c + i * j
    return o * torch.tanh(c), c


def _gru_cell(zx, zh, h):
    """Gates (r, z, n) from zx and zh (B, 3, H), biases included."""
    r = torch.sigmoid(zx[:, 0] + zh[:, 0])
    z = torch.sigmoid(zx[:, 1] + zh[:, 1])
    n = torch.tanh(zx[:, 2] + r * zh[:, 2])
    return (1 - z) * n + z * h


def fused_lstm_ref(x_seq, w_x, w_h, s_x, s_h, b, h0, c0):
    """x_seq (T, B, D) -> (y (T, B, H) bf16, h_T f32, c_T f32)."""
    wxf = w_x.to(torch.bfloat16) if s_x is None else w_x
    whf = w_h.to(torch.bfloat16) if s_h is None else w_h
    h, c = h0.to(F32), c0.to(F32)
    ys = []
    for x in x_seq:
        zx, zh = _proj(x, wxf, s_x), _proj(h, whf, s_h)
        h, c = _lstm_cell(zx + zh + b[None], c)
        ys.append(h.to(torch.bfloat16))
    return torch.stack(ys), h, c


def fused_gru_ref(x_seq, w_x, w_h, s_x, s_h, b_x, b_h, h0):
    """x_seq (T, B, D) -> (y (T, B, H) bf16, h_T f32)."""
    h = h0.to(F32)
    ys = []
    for x in x_seq:
        zx, zh = _proj(x, w_x, s_x), _proj(h, w_h, s_h)
        h = _gru_cell(zx + b_x[None], zh + b_h[None], h)
        ys.append(h.to(torch.bfloat16))
    return torch.stack(ys), h


def xproj_ref(x_seq, w_x, s_x, b):
    """The input half for all T at once: x_seq (T, B, D) -> zx (T, B, G, H)
    f32 = s_x * (bf16(x) . w_x) + b (the LSTM bias, or the GRU's b_x)."""
    T, B, D = x_seq.shape
    G, H = w_x.shape[1], w_x.shape[2]
    zx = _proj(x_seq.reshape(T * B, D), w_x, s_x) + b[None]
    return zx.reshape(T, B, G, H)


def lstm_steps_ref(zx, w_h, s_h, h0, c0):
    """The LSTM recurrence on zx (T, B, 4, H) from :func:`xproj_ref`."""
    h, c = h0.to(F32), c0.to(F32)
    ys = []
    for zxt in zx:
        h, c = _lstm_cell(zxt + _proj(h, w_h, s_h), c)
        ys.append(h.to(torch.bfloat16))
    return torch.stack(ys), h, c


def gru_steps_ref(zx, w_h, s_h, b_h, h0):
    """The GRU recurrence on zx (T, B, 3, H) from :func:`xproj_ref`."""
    h = h0.to(F32)
    ys = []
    for zxt in zx:
        h = _gru_cell(zxt, _proj(h, w_h, s_h) + b_h[None], h)
        ys.append(h.to(torch.bfloat16))
    return torch.stack(ys), h
