"""Serving launcher (port of ``repro.launch.serve``, batch mode): submit
N requests up front to the continuous-batching engine and drain it.

  # on the card, full width
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
      --requests 8 --max-new 16
  # on the CPU, reduced
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
      --reduced --requests 6 --max-new 5 --device cpu
  # int8 weights (every dot of a block on the matmul_w8a16 kernel on CUDA)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \\
      --int8 --requests 8 --max-new 16 --max-len 1024

Prompts are drawn as in the JAX launcher (``numpy`` generator from
``--seed``, 4 to 11 tokens), the parameters from a ``torch.Generator``
seeded with 0 on the serving device, built leaf by leaf as served
(``LM.init_serving``, so qwen2.5-14b's ~29.5 GB of bf16 weights fit the
card).  ``--int8`` serves ``quantize_tree`` of that tree instead, made
leaf by leaf as the bf16 leaves are released.  Any arch the port serves
works (rwkv6-1.6b, qwen2.5-14b); the JAX package's rwkv cannot run an
int8 tree at full width (its ``decay_b`` read), the port's can.
The run ends with the same ``engine stats: {...}`` line as the JAX
launcher.  Without ``--device`` it runs on the current CUDA device and
raises where there is none.  Open-loop arrivals, plans, fleets and faults
arrive with later slices.
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.quant import quantize_tree
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.lm import build_model
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.serving.scheduler import POLICIES
from repro_torch.testing import reduced_config


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="serve N requests through the port's engine")
    ap.add_argument("--arch", required=True, help="architecture id")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced (CPU-sized) configuration")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4, help="decode slots")
    ap.add_argument("--max-len", type=int, default=64, help="cache length")
    ap.add_argument("--sync-every", type=int, default=1,
                    help="decode ticks per host intervention")
    ap.add_argument("--policy", default="fcfs", choices=POLICIES,
                    help="admission order (scheduler registry)")
    ap.add_argument("--seed", type=int, default=0,
                    help="workload + sampler seed")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--int8", action="store_true",
                    help="serve int8 weights (quantize_tree)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="per-chunk engine lines (repro_torch DEBUG)")
    return ap


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    if args.verbose:
        logging.getLogger("repro_torch").setLevel(logging.DEBUG)
    dev = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init_serving(gen, dev)
    if args.int8:
        params = quantize_tree(params, consume=True)
    engine = ServingEngine(
        model, params, max_batch=args.max_batch, max_len=args.max_len,
        sampler=SamplerConfig(temperature=args.temperature),
        seed=args.seed, sync_every=args.sync_every, policy=args.policy)
    rng = np.random.default_rng(args.seed)
    reqs = []
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=rng.integers(4, 12)).tolist()
        reqs.append(engine.submit(prompt, max_new_tokens=args.max_new))
    t0 = time.perf_counter()
    engine.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total = sum(len(r.output) for r in reqs)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name})")
    print(f"served {len(reqs)} requests, {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s)")
    print(f"engine stats: {engine.stats()}")
    for r in reqs[:3]:
        print(f"  req {r.uid}: prompt[:6]={r.prompt[:6]} -> {r.output[:8]}")
    if not all(r.done for r in reqs):
        raise RuntimeError("requests left unfinished")


if __name__ == "__main__":
    main()
