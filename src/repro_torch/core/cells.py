"""RNN cell implementations (port of ``repro.core.cells``): the paper's
loop-based fused form and the BLAS-based baselines it argues against.

  "blas"      — BasicLSTM style: one GEMV per (gate x input), every
                intermediate materialized.
  "semifused" — CudnnLSTM style: one concatenated [Wx|Wh] GEMV over [x;h].
  "fused"     — the same math as one contraction plus the elementwise tail;
                ``impl="kernel"`` runs the hand-written CUDA kernel
                (:mod:`repro_torch.kernels.fused_rnn`).

Weights layout (all implementations share it, as in the JAX package):
  LSTM: w_x (D, 4, H), w_h (H, 4, H), b (4, H)   gate order (i, j, f, o)
  GRU:  w_x (D, 3, H), w_h (H, 3, H), b_x/b_h (3, H)  gate order (r, z, n)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.quant import blocked_fp, quantize_int8
from repro_torch.kernels.dispatch import resolve_device

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class RNNCellConfig:
    cell: str                 # "lstm" | "gru"
    hidden: int               # H
    features: int = 0         # D (DeepBench: D == H)
    timesteps: int = 1        # T
    batch: int = 1            # real-time serving: batch of 1
    precision: str = "int8"   # "int8" | "bf16" | "f32" | "blocked_fp"

    @property
    def d(self) -> int:
        return self.features or self.hidden

    @property
    def n_gates(self) -> int:
        return 4 if self.cell == "lstm" else 3

    def flops_per_step(self) -> float:
        """MACs x2: the gate matvecs dominate (paper §4.2: 2N^2 per N)."""
        g = self.n_gates
        return 2.0 * g * self.hidden * (self.hidden + self.d) * self.batch

    def weight_bytes(self) -> float:
        itemsize = {"int8": 1, "bf16": 2, "f32": 4, "blocked_fp": 1}[
            self.precision]
        g = self.n_gates
        return g * self.hidden * (self.hidden + self.d) * itemsize


def init_weights(cfg: RNNCellConfig, generator: torch.Generator,
                 device=None) -> Dict[str, torch.Tensor]:
    """Uniform(-1/sqrt(H+D), 1/sqrt(H+D)) weights, zero biases.  The
    numbers differ from the JAX package's ``jax.random`` draw; to compute
    the same thing in both, carry JAX weights over with
    :func:`weights_from_numpy`."""
    device = resolve_device(device)
    g, H, D = cfg.n_gates, cfg.hidden, cfg.d
    s = 1.0 / float(np.sqrt(H + D))

    def uni(*shape):
        u = torch.rand(shape, generator=generator, dtype=F32)
        return (u * (2 * s) - s).to(device)

    w = {
        "w_x": uni(D, g, H),
        "w_h": uni(H, g, H),
        "b": torch.zeros((g, H), dtype=F32, device=device),
    }
    if cfg.cell == "gru":
        w["b_h"] = torch.zeros((g, H), dtype=F32, device=device)
    return w


def weights_from_numpy(w: Mapping[str, np.ndarray],
                       device=None) -> Dict[str, torch.Tensor]:
    """Carry a weight dict made by the JAX package (``np.asarray`` of each
    leaf: int8 codes, (g, H) scales, f32/bf16 weights and biases) into
    the port, dtypes unchanged."""
    device = resolve_device(device)
    out = {}
    for k, v in w.items():
        a = np.asarray(v)
        if a.dtype.name == "bfloat16":      # ml_dtypes bf16 from JAX
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))      # a writable copy
        out[k] = t.to(device)
    return out


# ---------------------------------------------------------------------------
# Single-step cell math — three execution models
# ---------------------------------------------------------------------------


def lstm_step_blas(w, x, h, c):
    """BasicLSTM: one GEMV per (gate x input) — 8 kernels + adds."""
    outs = []
    for g in range(4):
        zx = x @ w["w_x"][:, g, :]
        zh = h @ w["w_h"][:, g, :]
        outs.append(zx + zh + w["b"][g])
    i, j, f, o = outs
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(j)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_step_fused(w, x, h, c):
    """Loop-based/fused semantics: concatenated weights, single
    contraction, elementwise tail."""
    B = x.shape[0]
    H = w["w_h"].shape[0]
    xh = torch.cat([x, h], dim=-1)                           # (B, D+H)
    w_cat = torch.cat([w["w_x"], w["w_h"]], dim=0)           # (D+H, 4, H)
    z = (xh @ w_cat.reshape(-1, 4 * H)).reshape(B, 4, H) + w["b"]
    i, j, f, o = z[:, 0], z[:, 1], z[:, 2], z[:, 3]
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(j)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def gru_step_blas(w, x, h):
    zx = [x @ w["w_x"][:, g, :] + w["b"][g] for g in range(3)]
    zh = [h @ w["w_h"][:, g, :] + w["b_h"][g] for g in range(3)]
    r = torch.sigmoid(zx[0] + zh[0])
    z = torch.sigmoid(zx[1] + zh[1])
    n = torch.tanh(zx[2] + r * zh[2])
    return (1 - z) * n + z * h


def gru_step_fused(w, x, h):
    B = x.shape[0]
    H = w["w_h"].shape[0]

    def mm(a, ww):
        return (a @ ww.reshape(ww.shape[0], 3 * H)).reshape(B, 3, H)

    zx = mm(x, w["w_x"]) + w["b"]
    zh = mm(h, w["w_h"]) + w["b_h"]
    r = torch.sigmoid(zx[:, 0] + zh[:, 0])
    z = torch.sigmoid(zx[:, 1] + zh[:, 1])
    n = torch.tanh(zx[:, 2] + r * zh[:, 2])
    return (1 - z) * n + z * h


# ---------------------------------------------------------------------------
# Precision transforms
# ---------------------------------------------------------------------------


def quantize_weights(cfg: RNNCellConfig, w: Dict[str, torch.Tensor]) -> Dict:
    """Storage transform per cfg.precision (math still runs wide)."""
    if cfg.precision == "f32":
        return w
    if cfg.precision == "bf16":
        return {k: v.to(torch.bfloat16) for k, v in w.items()}
    if cfg.precision == "blocked_fp":
        return {k: (blocked_fp(v, block=16, mantissa_bits=4, axis=0)
                    if k.startswith("w_") else v) for k, v in w.items()}
    # int8: per-(gate, unit) symmetric scales over the contraction dim
    out = {}
    for k, v in w.items():
        if k.startswith("w_"):
            q, scale = quantize_int8(v, axis=0)
            out[k] = q
            out[k + "_scale"] = scale[0]                      # (g, H)
        else:
            out[k] = v
    return out


def dequantize_weights(w: Dict) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in w.items():
        if k.endswith("_scale"):
            continue
        if k + "_scale" in w:
            out[k] = v.to(F32) * w[k + "_scale"][None]
        else:
            out[k] = v.to(F32)
    return out


# ---------------------------------------------------------------------------
# Serving: loop over time, weights stationary
# ---------------------------------------------------------------------------


def serve(cfg: RNNCellConfig, w: Dict, x_seq: torch.Tensor,
          impl: str = "fused",
          state: Optional[Tuple[torch.Tensor, ...]] = None,
          plan: Optional[Dict] = None) -> torch.Tensor:
    """Run the full T-step sequence.  x_seq: (T, B, D) -> y (T, B, H).

    Runs on the device the tensors lie on.  ``impl``: "blas" |
    "semifused"/"fused" (plain PyTorch, f32) | "kernel" (the CUDA kernel
    through :mod:`repro_torch.kernels.fused_rnn.ops`, bf16 y).  ``plan``
    is a ``tile_plans`` entry forwarded to the kernel path."""
    if impl == "kernel":
        from repro_torch.kernels.fused_rnn import ops as kernel_ops
        return kernel_ops.serve(cfg, w, x_seq, state=state, plan=plan)
    if impl not in ("blas", "semifused", "fused"):
        raise ValueError(f"unknown impl {impl!r}")
    wd = dequantize_weights(w) if cfg.precision == "int8" else \
        {k: v.to(F32) for k, v in w.items()}
    B, H = x_seq.shape[1], cfg.hidden
    if state is None:
        h = torch.zeros((B, H), dtype=F32, device=x_seq.device)
        c = torch.zeros((B, H), dtype=F32, device=x_seq.device)
    else:
        h, c = state[0], (state[1] if len(state) > 1 else None)

    ys = []
    if cfg.cell == "lstm":
        step_fn = lstm_step_blas if impl == "blas" else lstm_step_fused
        for x in x_seq:
            h, c = step_fn(wd, x.to(F32), h, c)
            ys.append(h)
    else:
        step_fn = gru_step_blas if impl == "blas" else gru_step_fused
        for x in x_seq:
            h = step_fn(wd, x.to(F32), h)
            ys.append(h)
    return torch.stack(ys)
