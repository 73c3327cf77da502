#!/usr/bin/env python3
"""On-chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100) and ``nvcc``; imports nothing of JAX or of
the JAX package.  Phases, each fatal on failure:

1. device: name, power limit, the properties the DSE reads; TF32 off;
2. build ``csrc/fused_rnn.cu`` with nvcc for sm_90a (seconds, ptxas report);
3. hold each kernel (``fused_lstm``/``fused_gru``, streaming and
   persistent) against its plain PyTorch version on the card, at a few
   shapes including a ragged tile, D != H, bf16 weights and B > 4;
4. main path: all ten DeepBench tasks at full H and full T, batch 1,
   through ``cells.serve(impl="kernel")`` (streaming, and persistent where
   the weights can be resident), each compared with the plain version
   over all T; then four requests served as one batch, each row held
   against that request served alone.  Launch counters are set to 0
   just before and read just after; timings come after, in their own
   calls: the kernel (CUDA events, median), the plain version, and
   ``torch.nn.LSTM``/``GRU`` (cuDNN, bf16) as the library yardstick;
5. every launch counter > 0; one ``{"kernels": [...]}`` line;
6. last line ``{"ok": true, "device": {...}}``.

Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Kernel vs plain version on the card.  Both sum exact bf16 x int8/bf16
# products in f32, in different orders; a last-bit difference in h can
# flip one bf16 ulp of y (2^-8 relative, |y| < 1) and feeds the next step.
ATOL = 2e-2
REPS_KERNEL = 7
REPS_PLAIN = 3
# The JAX package's reference tables name the Pallas function each CUDA
# kernel replaces.
REPLACES = {"lstm": "src/repro/kernels/fused_rnn/fused_rnn.py:238",
            "gru": "src/repro/kernels/fused_rnn/fused_rnn.py:299"}
SOURCE = "src/repro_torch/csrc/fused_rnn.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median ms of one ``fn()`` call between CUDA events, after a warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def operands(cell, H, D, B, T, wdtype, device, seed):
    """Random kernel operands on the card, from a seed."""
    import torch

    G = 4 if cell == "lstm" else 3
    gen = torch.Generator().manual_seed(seed)
    s = (H + D) ** -0.5

    def w(rows):
        if wdtype == torch.int8:
            return torch.randint(-127, 128, (rows, G, H), generator=gen,
                                 dtype=torch.int8)
        return (torch.rand((rows, G, H), generator=gen) * 2 * s - s).to(
            torch.bfloat16)

    scale = (s / 127 if wdtype == torch.int8 else 1.0)
    ops = dict(
        x=torch.randn((T, B, D), generator=gen).to(torch.bfloat16),
        w_x=w(D), w_h=w(H),
        s_x=torch.rand((G, H), generator=gen) * scale + scale / 2,
        s_h=torch.rand((G, H), generator=gen) * scale + scale / 2,
        b=torch.randn((G, H), generator=gen) * 0.1,
        b_h=torch.randn((G, H), generator=gen) * 0.1,
        h0=torch.randn((B, H), generator=gen) * 0.5,
        c0=torch.randn((B, H), generator=gen) * 0.5)
    return {k: v.to(device) for k, v in ops.items()}


def call(fr, cell, o, bh, persistent, plain=False):
    """(y, h_T, c_T or None) from the kernel wrapper or its plain version."""
    from repro_torch.kernels.fused_rnn import ref

    if cell == "lstm":
        if plain:
            return ref.fused_lstm_ref(o["x"], o["w_x"], o["w_h"], o["s_x"],
                                      o["s_h"], o["b"], o["h0"], o["c0"])
        return fr.fused_lstm(o["x"], o["w_x"], o["w_h"], o["s_x"], o["s_h"],
                             o["b"], o["h0"], o["c0"], bh=bh,
                             persistent=persistent)
    if plain:
        y, hT = ref.fused_gru_ref(o["x"], o["w_x"], o["w_h"], o["s_x"],
                                  o["s_h"], o["b"], o["b_h"], o["h0"])
    else:
        y, hT = fr.fused_gru(o["x"], o["w_x"], o["w_h"], o["s_x"], o["s_h"],
                             o["b"], o["b_h"], o["h0"], bh=bh,
                             persistent=persistent)
    return y, hT, None


def kernel_name(cell: str, persistent: bool) -> str:
    return f"fused_{cell}" + ("_persistent" if persistent else "")


def library_module(cfg, w, device):
    """torch.nn.LSTM/GRU in bf16 holding the dequantized weights; LSTM
    gates permuted from (i, j, f, o) to PyTorch's (i, f, g, o)."""
    import torch

    from repro_torch.core.cells import dequantize_weights

    wd = dequantize_weights(w)
    H, D = cfg.hidden, cfg.d
    perm = [0, 2, 1, 3] if cfg.cell == "lstm" else [0, 1, 2]
    mod = (torch.nn.LSTM if cfg.cell == "lstm" else torch.nn.GRU)(D, H)
    with torch.no_grad():
        mod.weight_ih_l0.copy_(wd["w_x"][:, perm].permute(1, 2, 0)
                               .reshape(-1, D))
        mod.weight_hh_l0.copy_(wd["w_h"][:, perm].permute(1, 2, 0)
                               .reshape(-1, H))
        mod.bias_ih_l0.copy_(wd["b"][perm].reshape(-1))
        mod.bias_hh_l0.copy_(wd["b_h"][perm].reshape(-1) if "b_h" in wd
                             else torch.zeros(cfg.n_gates * H))
    # PyTorch keeps bf16 RNN weights unflattened, so cuDNN compacts them
    # in every call: that copy is part of the yardstick's time
    warnings.filterwarnings("ignore", message="RNN module weights are not")
    return mod.to(device=device, dtype=torch.bfloat16)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 1
    if not (SRC / "repro_torch").is_dir():
        log(f"chip_smoke: {SRC / 'repro_torch'} not found")
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch import hw
    from repro_torch.configs import DEEPBENCH_TASKS
    from repro_torch.core import cells, dse
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_rnn import fused_rnn as fr
    from repro_torch.kernels.fused_rnn.ops import (_weights_for_kernel,
                                                   default_bh)
    from repro_torch.launch.deepbench import task_inputs

    dev = torch.device("cuda", 0)
    report = {}

    # ---- 1. device ------------------------------------------------------
    smi = nvidia_smi()
    spec = hw.from_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1] device: {torch.cuda.get_device_name(0)}")
    log(f"[1] nvidia-smi: {smi}")
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"[1] dse spec: sms={spec.sms} smem_per_block_optin="
        f"{spec.smem_per_block_optin} smem_per_sm={spec.smem_per_sm} "
        f"hbm_bytes={spec.hbm_bytes:.0f} l2_bytes={spec.l2_bytes:.0f} "
        f"regs_per_sm={spec.regs_per_sm} (hbm_bw {spec.hbm_bw:.3g} B/s and "
        f"peaks from the data sheet)")
    log(f"[1] allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    report["device"] = dict(name=torch.cuda.get_device_name(0), smi=smi,
                            sms=spec.sms, torch=torch.__version__)

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build("fused_rnn")
    build_s = time.perf_counter() - t0
    log(f"[2] built {lib_path.name} in {build_s:.1f} s")
    ptxas = lib_path.with_suffix(".log").read_text().splitlines() \
        if lib_path.with_suffix(".log").is_file() else []
    for line in ptxas:
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log(f"[2] {line.strip()}")
    report["build_s"] = build_s

    # ---- 3. kernels vs plain version ------------------------------------
    log(f"[3] tolerance: max abs error <= {ATOL}; kernel and plain version "
        f"sum the same exact bf16 x int8/bf16 products in f32 in another "
        f"order, so one bf16 ulp of y (or of the h fed back) may flip")
    errs = {kernel_name(c, p): 0.0 for c in ("lstm", "gru")
            for p in (False, True)}
    shapes = [  # cell, H, D, B, T, weights, bh, persistent
        ("lstm", 256, 256, 1, 8, torch.int8, 8, False),
        ("lstm", 256, 256, 1, 8, torch.int8, 8, True),
        ("gru", 512, 512, 3, 5, torch.int8, 64, False),
        ("gru", 512, 512, 3, 5, torch.int8, 16, True),
        ("lstm", 96, 80, 5, 6, torch.int8, 24, False),      # ragged tile, B > 4
        ("lstm", 96, 80, 5, 6, torch.int8, 24, True),
        ("gru", 96, 80, 2, 6, torch.bfloat16, 12, False),   # bf16 weights
        ("gru", 96, 80, 2, 6, torch.bfloat16, 12, True),
        ("lstm", 1024, 1024, 1, 12, torch.int8, 8, True),   # main-path widths
        ("gru", 2560, 2560, 1, 4, torch.int8, 32, False),
    ]
    for i, (cell, H, D, B, T, wdt, bh, pers) in enumerate(shapes):
        o = operands(cell, H, D, B, T, wdt, dev, seed=100 + i)
        got = call(fr, cell, o, bh, pers)
        want = call(fr, cell, o, bh, pers, plain=True)
        torch.cuda.synchronize()
        e = max(max_err(g, w_) for g, w_ in zip(got, want) if g is not None)
        name = kernel_name(cell, pers)
        errs[name] = max(errs[name], e)
        log(f"[3] {name:22s} H={H} D={D} B={B} T={T} {str(wdt)[6:]:8s} "
            f"bh={bh}: max|kernel-plain| over y,h_T,c_T = {e:.3e} "
            f"(atol {ATOL})")
        if not e <= ATOL:
            raise AssertionError(f"{name} disagrees with its plain version")

    # ---- 4. main path ---------------------------------------------------
    inputs = [(task,) + task_inputs(task, dev, seed=7) for task in
              DEEPBENCH_TASKS]
    for k in fr.LAUNCHES:
        fr.LAUNCHES[k] = 0
    outs = {}
    for task, cfg, w, x in inputs:
        outs[(task.name, False)] = cells.serve(cfg, w, x, impl="kernel")
        if dse.persistent_eligible(cfg):
            outs[(task.name, True)] = cells.serve(
                cfg, w, x, impl="kernel", plan={"persistent": True})
    btask, bcfg, bw, _ = inputs[1]
    gen = torch.Generator().manual_seed(11)
    xb = torch.randn((btask.timesteps, 4, bcfg.d), generator=gen).to(
        dev, torch.bfloat16)
    bh_b = default_bh(bcfg, 4)
    y_batch = cells.serve(bcfg, bw, xb, impl="kernel")
    y_alone = [cells.serve(bcfg, bw, xb[:, i:i + 1], impl="kernel",
                           plan={"bh": bh_b}) for i in range(4)]
    torch.cuda.synchronize()
    launches = dict(fr.LAUNCHES)
    log(f"[4] main-path launches: {launches}")

    # agreement with the plain version, all of T
    rows = []
    for task, cfg, w, x in inputs:
        y_plain = cells.serve(cfg, w, x, impl="kernel",
                              plan={"impl": "plain"})
        for pers in (False, True):
            if (task.name, pers) not in outs:
                continue
            e = max_err(outs[(task.name, pers)], y_plain)
            name = kernel_name(cfg.cell, pers)
            errs[name] = max(errs[name], e)
            rows.append(dict(task=task.name, kernel=name, T=x.shape[0],
                             max_abs_err=e))
            log(f"[4] {task.name:16s} {name:22s} y over all T={x.shape[0]}: "
                f"max|kernel-plain| = {e:.3e} (atol {ATOL})")
            if not e <= ATOL:
                raise AssertionError(f"{task.name}: {name} disagrees")
    # at the same tile the kernel runs each row's arithmetic in the same
    # order whatever the batch, so the rows must be bit-equal
    for i in range(4):
        same = bool(torch.equal(y_batch[:, i:i + 1], y_alone[i]))
        log(f"[4] batch row {i} of {btask.name} (B=4, bh={bh_b}) equals the "
            f"request alone: {same}")
        if not same:
            raise AssertionError("a batch row differs from its request alone")

    # timings: kernel wrapper, plain version, cuDNN yardstick
    for row in rows:
        task, cfg, w, x = next(t for t in inputs if t[0].name == row["task"])
        pers = row["kernel"].endswith("persistent")
        wx, wh, s_x, s_h = _weights_for_kernel(cfg, w)
        o = dict(x=x, w_x=wx, w_h=wh, s_x=s_x, s_h=s_h, b=w["b"],
                 b_h=w.get("b_h"), h0=torch.zeros((1, cfg.hidden), device=dev),
                 c0=torch.zeros((1, cfg.hidden), device=dev))
        bh = default_bh(cfg, 1, pers)
        row["bh"] = bh
        row["ms"] = cuda_ms(lambda: call(fr, cfg.cell, o, bh, pers), REPS_KERNEL)
        row["serve_ms"] = cuda_ms(
            lambda: cells.serve(cfg, w, x, impl="kernel",
                                plan={"persistent": True} if pers else None),
            REPS_KERNEL)
        row["plain_ms"] = cuda_ms(
            lambda: call(fr, cfg.cell, o, bh, pers, plain=True), REPS_PLAIN)
        mod = library_module(cfg, w, dev)
        with torch.no_grad():
            row["library_ms"] = cuda_ms(lambda: mod(x), REPS_KERNEL)
            row["library_vs_kernel_err"] = max_err(mod(x)[0],
                                                   outs[(task.name, pers)])
        T, G, H, R = x.shape[0], cfg.n_gates, cfg.hidden, cfg.d + cfg.hidden
        nbytes = (G * H * R * 1 + 4 * G * H * 4 + T * cfg.d * 2 + T * H * 2)
        ops = 2.0 * G * H * R * T
        row["bound_bytes_ms"] = nbytes / spec.hbm_bw * 1e3
        row["bound_ops_ms"] = ops / spec.peak_bf16_flops * 1e3
        row["bound_ms"] = max(row["bound_bytes_ms"], row["bound_ops_ms"])
        row["weight_stream_ms"] = dse.weight_stream_bound_s(cfg, T, spec) * 1e3
        row["grid_sync_model_ms"] = dse.grid_sync_bound_s(T) * 1e3
        row["dse_model_ms"] = dse.best_plan(
            cfg, spec, persistent=pers).step_latency_s * T * 1e3
        row["launches_one_request"] = 1 if pers else T
        log(f"[4] {row['task']:16s} {row['kernel']:22s} bh={bh:<4d} "
            f"kernel {row['ms']:.4f} ms | serve {row['serve_ms']:.4f} | "
            f"plain {row['plain_ms']:.4f} | cuDNN {row['library_ms']:.4f} "
            f"(|cuDNN-kernel| {row['library_vs_kernel_err']:.2e}) | bound "
            f"{row['bound_ms']:.5f} ("
            f"{'bytes' if row['bound_bytes_ms'] >= row['bound_ops_ms'] else 'operations'}"
            f") | weights/step "
            f"{row['weight_stream_ms']:.4f} | dse model "
            f"{row['dse_model_ms']:.4f}")
    report["tasks"] = rows

    # ---- 5. counters and the kernels line ---------------------------------
    kernels = []
    for name in fr.LAUNCHES:
        cell = name.split("_")[1]
        sel = [r for r in rows if r["kernel"] == name]
        if launches[name] <= 0:
            raise AssertionError(f"{name} was never launched on the main path")
        b_bytes = sum(r["bound_bytes_ms"] for r in sel)
        b_ops = sum(r["bound_ops_ms"] for r in sel)
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[cell],
            launches=launches[name], max_abs_err=errs[name],
            ms=sum(r["ms"] for r in sel),
            plain_ms=sum(r["plain_ms"] for r in sel),
            bound_ms=max(b_bytes, b_ops),
            bound_by="bytes" if b_bytes >= b_ops else "operations",
            library_ms=sum(r["library_ms"] for r in sel)))
    report["kernels"] = kernels
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(nvidia_smi())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
