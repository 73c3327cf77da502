"""The engine's decode chunk (port of the JAX engine's on-device loop,
``repro.serving.engine._decode_many``).

A chunk runs up to ``min(k, limit)`` ticks.  A tick is the model's
in-place decode step (:meth:`repro_torch.models.lm.LM.decode_step_`), the
sampler, then the loop's control (:func:`repro_torch.kernels.decode_loop.
decode_loop.epilogue`: token writeback, EOS / cache-full / budget
done-mask, the next tick's predicate ``go``).  The chunk exits when no
slot is active, or, with ``stop_on_free``, after the first tick that
frees a slot.  Its state lives in fixed device buffers and the cache is
updated in place, as the JAX package's donated cache is.

On CUDA the chunk is one graph launch: the tick is captured once, when
the loop is built on an empty cache (as ``init_cache`` made it: a
warm-up tick runs first, and the cache is then reset in place), and sits
in the body of a while node whose condition the control kernel sets, so
no tick runs after the exit.  A chunk is the
inputs' upload, the launch and one blocking read of the packed outputs.
There is no eager fallback: a capture or a launch that fails raises.

Elsewhere (``graph=False``; the CPU always) the same tick function runs
in a Python loop that reads ``go`` after each tick: on CPU tensors that
read is free, on CUDA it is the eager reference the card tests and
``chip_smoke.py`` hold the graph to.

Admissions whose first tokens are still on the device (the engine's
``overlap_prefill``) hand them to :meth:`DecodeLoop.run` as ``first``:
they are written into the chunk's input tokens at their slots on the
device, after the upload and before the launch, on the same stream, and
come home in the chunk's one read (the input tokens are read back beside
``out``, from one buffer).

A tick inside the graph cannot draw fresh random numbers: it repeats the
same kernels with the same generator offsets.  With ``temperature > 0``
the chunk therefore draws k x B uniforms from the engine's generator
before it starts, and tick i samples with row i (:func:`repro_torch.
serving.sampler.sample`).

Launch counters (:mod:`repro_torch.kernels.launches`): the warm-up's and
the capture's wrapper calls are taken back out.  The loop then reads,
from the instantiated graph itself, which kernel nodes run once a chunk
(the control kernel's init) and once a tick, and must find in a tick
exactly the launches the wrappers counted while it was captured.  After
each chunk it adds those nodes' counts, the tick's times the ticks the
device ran (``n``, read back), at the launch.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import launches
from repro_torch.kernels.decode_loop import decode_loop
from repro_torch.models.lm import LM
from repro_torch.serving.sampler import SamplerConfig, sample


class DecodeLoop:
    """Decode chunks over one cache tree (``cache`` is updated in place;
    its tensors, ``params`` and the loop's buffers keep their addresses
    for the loop's life).  With a graph, ``cache`` must be empty (as
    ``init_cache`` made it, every length 0) when the loop is built."""

    def __init__(self, model: LM, params, cache, sampler: SamplerConfig,
                 max_len: int, k: int, gen: Optional[torch.Generator] = None,
                 *, graph: Optional[bool] = None):
        self.model, self.params, self.cache = model, params, cache
        self.sampler, self.max_len, self.k = sampler, int(max_len), int(k)
        self.gen = gen
        self.device = cache["lengths"].device
        self.B = int(cache["lengths"].shape[0])
        self.graph = self.device.type == "cuda" if graph is None else graph
        if self.graph and self.device.type != "cuda":
            raise ValueError(f"a decode graph needs CUDA tensors, got "
                             f"{self.device}")
        self.inp, out, self.ctl = decode_loop.buffers(self.B, self.k,
                                                      self.device)
        # one read-back buffer: ``out`` at its head, then a copy of the
        # chunk's input tokens (B)
        self._rb = torch.zeros((out.numel() + self.B,), dtype=out.dtype,
                               device=self.device)
        self.out = self._rb[:out.numel()]
        self._first = self._rb[out.numel():]
        self.tokens = self.inp[:self.B]
        self.u = (torch.zeros((self.k, self.B), dtype=torch.float32,
                              device=self.device)
                  if sampler.temperature > 0 else None)
        self._host = torch.zeros((4 * self.B + 2,), dtype=torch.int32,
                                 pin_memory=self.device.type == "cuda")
        self.capture_s = 0.0
        self.pool_bytes = 0          # the tick's graph pool's segments
        self.tick_nodes: Dict[str, int] = {}    # nodes a tick, by kind
        self.chunk_nodes: Dict[str, int] = {}   # once a launch, by kind
        self._loop: Optional[decode_loop.LoopGraph] = None
        self._tick_graph = None
        self._per_tick: Dict[str, int] = {}
        self._per_chunk: Dict[str, int] = {}
        if self.graph:
            self._capture()

    # ------------------------------------------------------------ a tick
    def tick(self, handle: int = 0) -> None:
        """One decode tick on the loop's buffers, in place."""
        logits = self.model.decode_step_(self.params, self.cache,
                                         self.tokens)
        u = (None if self.u is None
             else self.u.index_select(0, self.out[:1])[0])
        sampled = sample(logits, self.gen, self.sampler, u=u)
        decode_loop.epilogue(sampled, self.cache["lengths"], self.inp,
                             self.out, self.ctl, k=self.k,
                             max_len=self.max_len, handle=handle)

    def _init(self) -> None:
        decode_loop.epilogue(None, None, self.inp, self.out, self.ctl,
                             k=self.k, max_len=self.max_len, init=True)

    # ----------------------------------------------------------- capture
    def _capture(self) -> None:
        """Warm up one tick, capture it, build the loop graph and read its
        kernel nodes; the cache, the buffers and the launch counters come
        back as they were."""
        if bool((self.cache["lengths"] != 0).any()):
            raise ValueError("decode graph: the tick is captured on an empty "
                             "cache (every length 0), never on live slots")
        t0 = time.perf_counter()
        before = launches.counters()
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._init()
            self.tick()
        cur.wait_stream(side)
        torch.cuda.synchronize(self.device)
        self._loop = decode_loop.LoopGraph(self.device)
        g = torch.cuda.CUDAGraph(keep_graph=True)
        mark = launches.counters()
        with torch.cuda.graph(g):
            self.tick(self._loop.handle)
        captured = launches.since(mark)
        pool = tuple(g.pool())
        self.pool_bytes = sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) == pool)
        launches.restore(before)
        self._tick_graph = g        # its pool holds the tick's tensors
        self._loop.finish(g.raw_cuda_graph(), self.inp, self.out, self.ctl,
                          k=self.k, max_len=self.max_len)
        (chunk, self.chunk_nodes), (tick, self.tick_nodes) = \
            self._loop.kernels()
        self._per_chunk = launches.by_counter(chunk)
        self._per_tick = launches.by_counter(tick)
        if self._per_tick != captured:
            raise RuntimeError(
                f"decode graph: a tick's kernel nodes {self._per_tick} are "
                f"not the launches its wrappers counted at capture "
                f"{captured}")
        self.model.reset_cache_(self.cache, self.max_len)
        for t in (self.inp, self._rb, self.ctl):
            t.zero_()
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0

    def per_tick_launches(self) -> Dict[str, int]:
        """Kernel launches a tick of the graph runs, by counter, from its
        kernel nodes."""
        return dict(self._per_tick)

    def per_chunk_launches(self) -> Dict[str, int]:
        """Kernel launches a graph launch runs once (the control kernel's
        init), by counter, from its kernel nodes."""
        return dict(self._per_chunk)

    # ------------------------------------------------------------ a chunk
    def run(self, tokens: np.ndarray, active: np.ndarray, eos: np.ndarray,
            remaining: np.ndarray, limit: int, stop_on_free: bool,
            first: Optional[Tuple[Sequence[int], torch.Tensor]] = None
            ) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray]:
        """Up to ``min(k, limit)`` ticks from the host's per-slot mirrors.
        Returns (n_ticks, toks (k, B) int32, acts (k, B) bool, dones
        (k, B) bool); rows >= n_ticks are zero.  One blocking read.

        ``first`` = (slots, tokens on the device): input tokens the host
        has not seen, written over ``tokens`` at those slots on the
        device; they come back in the same read and are written into the
        host array ``tokens`` at those slots."""
        B, k = self.B, self.k
        h = self._host.numpy()
        h[:B], h[B:2 * B] = tokens, active
        h[2 * B:3 * B], h[3 * B:4 * B] = eos, remaining
        h[4 * B], h[4 * B + 1] = min(int(limit), k), bool(stop_on_free)
        self.inp.copy_(self._host, non_blocking=True)
        if first is not None:
            slots = torch.as_tensor(list(first[0]), dtype=torch.long,
                                    device=self.device)
            self.tokens.index_copy_(0, slots, first[1].to(self.tokens.dtype))
            self._first.copy_(self.tokens)
        if self.u is not None:
            torch.rand((k, B), generator=self.gen, out=self.u)
        if self.graph:
            self._loop.launch()
        else:
            self._init()
            while bool(self.ctl[1]):
                self.tick()
        rb = (self._rb if first is not None else self.out).cpu().numpy()
        host = rb[:self.out.numel()]           # the chunk's one read
        if first is not None:
            sl = list(first[0])
            tokens[sl] = rb[self.out.numel():][sl]
        n = int(host[0])
        if self.graph:        # the launch ran its nodes, a tick's n times
            launches.add(self._per_chunk)
            launches.add(self._per_tick, n)
        toks, acts, dones = host[1:].reshape(3, k, B)
        return n, toks.copy(), acts.astype(bool), dones.astype(bool)

    def close(self) -> None:
        if self._loop is not None:
            self._loop.close()
            self._loop = None
        self._tick_graph = None


__all__ = ["DecodeLoop"]
