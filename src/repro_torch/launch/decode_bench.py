"""``flash_decode`` alone at qwen2.5-14b's decode shape, on the GPU.

  python src/repro_torch/launch/decode_bench.py [--bk 64 128 ...] [--reps 7]

The operands: B=4 rows, 40 query and 8 KV heads of 128, 1,024 cache
slots filled as ``chip_smoke.py``'s phase 4c fills them (the first four
requests mid-decode: 516, 340, 279 and 162 positions), random from a
seed.  For each chunk ``bk``: the device time of one call (a CUDA graph
of 20 calls replayed ``--reps`` times, median), the time of a call back
to back with the host in (CUDA events over 50 calls, median of
``--reps``), and the host time of a call (wall clock over 1,000 calls,
no synchronize).  Then B=1 with all 1,024 slots filled, at the first
chunk.  ``--profile`` adds each kernel's device µs a call from
``torch.profiler`` over 20 calls at the first chunk (the partials and the
combine apart).  Prints one JSON line.

It calls only ``flash_decode.flash_decode(q, k, v, kv_pos, q_pos,
bk=...)``, so run with another checkout's ``src`` first on
``PYTHONPATH`` it times that checkout's kernel with the same code.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import List, Optional

import torch

from repro_torch.kernels.flash_attention import flash_decode as fd

B, H, HKV, D, SLOTS = 4, 40, 8, 128, 1024
FILLED = (516, 340, 279, 162)


def _median_ms(run, reps: int, per: int) -> float:
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times)


def graph_ms(call, reps: int, calls: int = 20) -> float:
    """Device ms of one call: ``calls`` calls captured in a CUDA graph
    after a warm-up, the replay timed between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            call()
    g.replay()
    torch.cuda.synchronize()
    return _median_ms(g.replay, reps, calls)


def events_ms(call, reps: int, calls: int = 50) -> float:
    """ms of a call back to back, the host's launch cost in."""
    call()

    def run():
        for _ in range(calls):
            call()
    return _median_ms(run, reps, calls)


def host_ms(call, calls: int = 1000) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return wall / calls * 1e3


def kernel_us(call, calls: int = 20) -> dict:
    """Device µs a call of each kernel ``call`` launches, by name, from
    ``torch.profiler`` over ``calls`` calls after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / calls)
    return by_name


def operands(device, seed: int = 0):
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(device, torch.bfloat16)

    q = randn(B, H, D)
    k, v = randn(B, HKV, SLOTS, D), randn(B, HKV, SLOTS, D)
    pos = torch.arange(SLOTS, dtype=torch.int32).repeat(B, 1)
    pos[pos >= torch.tensor(FILLED, dtype=torch.int32)[:, None]] = -1
    q_pos = torch.tensor(FILLED, dtype=torch.int32) - 1
    return q, k, v, pos.to(device), q_pos.to(device)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bk", type=int, nargs="+", default=[128])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--tag", default="", help="a label for the JSON line")
    ap.add_argument("--profile", action="store_true",
                    help="each kernel's device µs a call (torch.profiler)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_bench times the kernel: it needs a CUDA "
                         "device")
    dev = torch.device("cuda")
    q, k, v, kv_pos, q_pos = operands(dev)
    rows = []
    for bk in args.bk:
        call = lambda: fd.flash_decode(q, k, v, kv_pos, q_pos, bk=bk)
        rows.append(dict(bk=bk, graph_us=graph_ms(call, args.reps) * 1e3,
                         events_us=events_ms(call, args.reps) * 1e3,
                         host_us=host_ms(call) * 1e3))
    full = torch.arange(SLOTS, dtype=torch.int32, device=dev)[None]
    last = torch.tensor([SLOTS - 1], dtype=torch.int32, device=dev)
    b1 = graph_ms(lambda: fd.flash_decode(q[:1], k[:1], v[:1], full, last,
                                          bk=args.bk[0]), args.reps) * 1e3
    out = dict(tag=args.tag, device=torch.cuda.get_device_name(dev),
               filled=list(FILLED), rows=rows, b1_full_graph_us=b1)
    if args.profile:
        out["kernel_us"] = kernel_us(lambda: fd.flash_decode(
            q, k, v, kv_pos, q_pos, bk=args.bk[0]))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
