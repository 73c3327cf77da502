"""Real-time RNN serving over the DeepBench task list: the port's entry
point for the paper's own scenario (batch-1 requests, strict latency).

  PYTHONPATH=src python -m repro_torch.launch.deepbench [--tasks N]
      [--timesteps T] [--reps R] [--persistent] [--device cuda|cpu]

For each task: build int8 weights from a seed, serve one request through
``cells.serve(impl="kernel")``, check it against ``impl="blas"`` (f32,
dequantized weights), and print the measured ms per sequence on the
device it ran on (CUDA events on a GPU, median of ``--reps``) next to the
Hopper DSE model's ms and the paper-reported Plasticine, Brainwave and
V100 latencies.  Runs on the GPU unless ``--device cpu`` is given.
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
    args = ap.parse_args(argv)
    rows = run(list(DEEPBENCH_TASKS[:args.tasks]), args.device,
               timesteps=args.timesteps, reps=args.reps,
               persistent=args.persistent)
    if not all(r["agree"] for r in rows):
        raise SystemExit("kernel and blas disagree")
    return rows


if __name__ == "__main__":
    main()
