"""``rwkv6_step`` alone at rwkv6-1.6b's decode shape, on the GPU.

  python src/repro_torch/launch/rwkv_bench.py [--batch 1 4] [--bv 4 8 ...]
      [--reps 7] [--profile] [--tag LABEL]

The operands: T=1, 32 heads, K = V = 64, B rows; 24 distinct operand
sets, one for each layer of a decode tick, random from a seed (bf16 r, k,
v; f32 log-decays over the model's clip range, bonus and state).  For
each B: the device time of one call (a CUDA graph of 24 calls, one on
each set, replayed ``--reps`` times, median), the time of a call back to
back with the host in (CUDA events over the 24 calls, median of
``--reps``) and the host time of a call (wall clock over 1,000 calls, no
synchronize).  Beside it, two yardsticks from the same graph timing:
PyTorch's ``copy_`` of each set's state into a tensor made beforehand
(the same state bytes read and written once, no arithmetic) and
``zero_`` of a one-element tensor (the floor of one launch).  ``--bv``
adds the graph time at each column slab; ``--profile`` each kernel's
device µs a launch from ``torch.profiler`` over the 24 calls, the
yardsticks' too.  Prints one JSON line.

It calls only ``rwkv_step.rwkv6_step(r, k, v, w, u, state)`` (with
``bv=`` for ``--bv`` alone), so run with another checkout's ``src`` first
on ``PYTHONPATH`` it times that checkout's kernel with the same code.
"""

from __future__ import annotations

import argparse
import itertools
import json
from typing import List, Optional

import torch

from repro_torch.kernels.rwkv_step import rwkv_step as rk
from repro_torch.launch.decode_bench import (events_ms, graph_ms, host_ms,
                                             kernel_us)

H, K, LAYERS = 32, 64, 24


def operand_sets(B: int, device, seed: int = 0):
    """``LAYERS`` operand sets at (T=1, B, H, K, K)."""
    gen = torch.Generator().manual_seed(seed)
    randn = lambda *s: torch.randn(s, generator=gen)
    sets = []
    for _ in range(LAYERS):
        w = -torch.exp(torch.rand((1, B, H, K), generator=gen) * 11.0 - 8.0)
        sets.append([t.to(device) for t in (
            randn(1, B, H, K).bfloat16(), randn(1, B, H, K).bfloat16(),
            randn(1, B, H, K).bfloat16(), w, randn(H, K),
            randn(B, H, K, K))])
    return sets


def cycling(sets, **kw):
    """A call that takes the next operand set each time, so ``LAYERS``
    calls in a row cover every set once."""
    it = itertools.cycle(sets)
    return lambda: rk.rwkv6_step(*next(it), **kw)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--bv", type=int, nargs="*", default=[])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--tag", default="", help="a label for the JSON line")
    ap.add_argument("--profile", action="store_true",
                    help="the kernel's device µs a launch (torch.profiler)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("rwkv_bench times the kernel: it needs a CUDA "
                         "device")
    dev = torch.device("cuda")
    rows = []
    for B in args.batch:
        sets = operand_sets(B, dev, seed=B)
        call = cycling(sets)
        pairs = itertools.cycle([(torch.empty_like(o[5]), o[5]) for o in sets])
        copy = lambda: torch.Tensor.copy_(*next(pairs))
        launch = torch.zeros(1, device=dev).zero_
        row = dict(B=B, graph_us=graph_ms(call, args.reps, LAYERS) * 1e3,
                   events_us=events_ms(call, args.reps, LAYERS) * 1e3,
                   host_us=host_ms(call) * 1e3,
                   copy_graph_us=graph_ms(copy, args.reps, LAYERS) * 1e3,
                   launch_graph_us=graph_ms(launch, args.reps, LAYERS) * 1e3)
        row["bv_graph_us"] = {
            bv: graph_ms(cycling(sets, bv=bv), args.reps, LAYERS) * 1e3
            for bv in args.bv}
        if args.profile:
            row["kernel_us"] = kernel_us(call, LAYERS)
            row["copy_kernel_us"] = kernel_us(copy, LAYERS)
            row["launch_kernel_us"] = kernel_us(launch, LAYERS)
        rows.append(row)
    out = dict(tag=args.tag, device=torch.cuda.get_device_name(dev),
               shape=dict(T=1, H=H, K=K, V=K, sets=LAYERS), rows=rows)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
