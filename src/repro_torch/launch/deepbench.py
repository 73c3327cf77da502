"""Real-time RNN serving over the DeepBench task list: the port's entry
point for the paper's own scenario (batch-1 requests, strict latency).

  PYTHONPATH=src python -m repro_torch.launch.deepbench [--tasks N]
      [--timesteps T] [--reps R] [--persistent] [--device cuda|cpu]
      [--xproj]

For each task: build int8 weights from a seed, serve one request through
``cells.serve(impl="kernel")``, check it against ``impl="blas"`` (f32,
dequantized weights), and print the measured ms per sequence on the
device it ran on (CUDA events on a GPU, median of ``--reps``) next to the
Hopper DSE model's ms and the paper-reported Plasticine, Brainwave and
V100 latencies.  Runs on the GPU unless ``--device cpu`` is given.

``--xproj`` (GPU only) times the streaming call's input projection
alone, at each task's T: the device time of one call (a CUDA graph of 10
calls replayed ``--reps`` times, median), the host time of a call (wall
clock over 1,000 calls) and ``torch.matmul`` on bf16 weights made
beforehand.  It calls only ``fused_rnn.xproj(x, w_x, s_x, b)``, so the
script can time another checkout's package put first on ``PYTHONPATH``
(``python src/repro_torch/launch/deepbench.py --xproj``).
"""

from __future__ import annotations

import argparse
import statistics
import time
from typing import List, Optional

import torch

from repro_torch.configs import DEEPBENCH_TASKS, DeepBenchTask
from repro_torch.core import dse
from repro_torch.core.cells import (RNNCellConfig, init_weights,
                                    quantize_weights, serve)
from repro_torch.kernels.dispatch import resolve_device

# y is bf16 and the blas reference f32 with dequantized weights: the
# JAX example's agreement bound (examples/serve_rnn_deepbench.py).
AGREE_ATOL = 5e-2


def task_inputs(task: DeepBenchTask, device, *, seed: int = 0,
                timesteps: Optional[int] = None, batch: int = 1):
    """(cfg, int8 weights, x (T, batch, D) bf16) for one task, from a seed."""
    T = task.timesteps if timesteps is None else min(timesteps,
                                                     task.timesteps)
    cfg = RNNCellConfig(task.cell, task.hidden, timesteps=T, batch=batch,
                        precision="int8")
    gen = torch.Generator().manual_seed(seed)
    w = quantize_weights(cfg, init_weights(cfg, gen, device=device))
    x = torch.randn((T, batch, cfg.d), generator=gen).to(
        device=device, dtype=torch.bfloat16)
    return cfg, w, x


def time_ms(fn, device: torch.device, reps: int) -> float:
    """Median ms of ``fn()``: CUDA events on a GPU, the host clock on
    the CPU.  One warm-up call first."""
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run(tasks: List[DeepBenchTask], device, *, timesteps: Optional[int]
        = None, reps: int = 5, persistent: bool = False) -> List[dict]:
    device = resolve_device(device)
    plan = {"persistent": True} if persistent else None
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    rows = []
    print(f"{'task':18s} {'mode':10s} {'agree':>5s} {'max_err':>8s} "
          f"{'ms (' + where + ')':>24s} {'dse_model_ms':>12s} "
          f"{'paper_plast':>11s} {'paper_bw':>8s} {'paper_v100':>10s}")
    for task in tasks:
        cfg, w, x = task_inputs(task, device, timesteps=timesteps)
        if persistent and not dse.persistent_eligible(cfg):
            print(f"{task.name:18s} persistent: weights cannot be resident")
            continue
        y = serve(cfg, w, x, impl="kernel", plan=plan)
        err = float((y.float() - serve(cfg, w, x, impl="blas")).abs().max())
        ms = time_ms(lambda: serve(cfg, w, x, impl="kernel", plan=plan),
                     device, reps)
        model = dse.best_plan(cfg, persistent=persistent)
        model_ms = (model.step_latency_s * x.shape[0] + (
            0 if persistent else dse.xproj_latency_s(cfg, x.shape[0]))) * 1e3
        row = dict(task=task.name, mode="persistent" if persistent
                   else "streaming", bh=model.bh, agree=err < AGREE_ATOL,
                   max_abs_err=err, ms=ms, device=where, dse_model_ms=model_ms,
                   timesteps=x.shape[0])
        rows.append(row)
        print(f"{task.name:18s} {row['mode']:10s} {str(row['agree']):>5s} "
              f"{err:8.2e} {ms:24.4f} {model_ms:12.4f} "
              f"{task.ms_plasticine:11.4f} {task.ms_brainwave:8.3f} "
              f"{task.ms_v100:10.2f}")
    return rows


def graph_ms(fn, calls: int = 10, reps: int = 7) -> float:
    """Device ms of one ``fn()``: ``calls`` calls captured in a CUDA graph
    after a warm-up, the graph replayed ``reps`` times between CUDA
    events; the median replay over ``calls``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def xproj_times(tasks: List[DeepBenchTask], device, *, reps: int = 7,
                timesteps: Optional[int] = None) -> List[dict]:
    """The streaming projection alone at each task's T (batch 1): device
    ms of a call, host ms of a call, ``torch.matmul``'s device ms."""
    from repro_torch.kernels.fused_rnn import fused_rnn
    from repro_torch.kernels.fused_rnn.ops import _weights_for_kernel

    device = resolve_device(device)
    if device.type != "cuda":
        raise SystemExit("--xproj times the kernel: it needs a CUDA device")
    rows = []
    print(f"{'task':18s} {'xproj_us':>9s} {'host_us':>8s} {'matmul_us':>9s} "
          f"({torch.cuda.get_device_name(device)})")
    for task in tasks:
        cfg, w, x = task_inputs(task, device, timesteps=timesteps)
        wx, _, s_x, _ = _weights_for_kernel(cfg, w)
        T, D, N = x.shape[0], cfg.d, cfg.n_gates * cfg.hidden

        def call():
            return fused_rnn.xproj(x, wx, s_x, w["b"])
        us = graph_ms(call, reps=reps) * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            call()
        host_us = (time.perf_counter() - t0) / 1000 * 1e6
        torch.cuda.synchronize()
        xm = x.reshape(T, D)
        wm = (wx.float() * s_x[None]).reshape(D, N).to(torch.bfloat16)
        mm_us = graph_ms(lambda: torch.matmul(xm, wm), reps=reps) * 1e3
        rows.append(dict(task=task.name, xproj_us=us, host_us=host_us,
                         matmul_us=mm_us))
        print(f"{task.name:18s} {us:9.3f} {host_us:8.2f} {mm_us:9.3f}")
    print(f"{'sum':18s} {sum(r['xproj_us'] for r in rows):9.3f} "
          f"{'':8s} {sum(r['matmul_us'] for r in rows):9.3f}")
    return rows


def main(argv: Optional[List[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tasks", type=int, default=len(DEEPBENCH_TASKS))
    ap.add_argument("--timesteps", type=int, default=None,
                    help="cap T (default: each task's full T)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--persistent", action="store_true",
                    help="serve through the weights-resident kernel")
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA device")
    ap.add_argument("--xproj", action="store_true",
                    help="time the streaming input projection alone (GPU)")
    args = ap.parse_args(argv)
    if args.xproj:
        return xproj_times(list(DEEPBENCH_TASKS[:args.tasks]), args.device,
                           reps=args.reps, timesteps=args.timesteps)
    rows = run(list(DEEPBENCH_TASKS[:args.tasks]), args.device,
               timesteps=args.timesteps, reps=args.reps,
               persistent=args.persistent)
    if not all(r["agree"] for r in rows):
        raise SystemExit("kernel and blas disagree")
    return rows


if __name__ == "__main__":
    main()
