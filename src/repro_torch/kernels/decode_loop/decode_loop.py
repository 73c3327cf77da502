"""The serving engine's decode-loop control kernel and the CUDA graph of
a decode chunk (``csrc/decode_loop.cu``; its head note says what it
replaces and what bounds it).

The loop's state lives in three int32 device buffers of fixed address
(:func:`buffers`), so one capture of a tick serves every chunk:

* ``inp`` — tokens | active | eos | remaining (B each) | limit |
  stop_on_free: the chunk's inputs, uploaded by the host, then the
  loop's running tokens, active mask and budgets;
* ``out`` — n | toks (k, B) | acts (k, B) | dones (k, B): what the host
  reads back, once a chunk;
* ``ctl`` — freed | go.

:func:`epilogue` is one tick's control (``init=True``: the chunk's start).
On CPU tensors it runs the plain version (:mod:`.ref`); on CUDA tensors
it launches the kernel or raises.  :class:`LoopGraph` builds the outer
graph (init kernel, then a while node whose body is the captured tick),
launches it and lists the kernel nodes it runs once a chunk and once a
tick (:func:`graph_kernels`, read from the graph through the CUDA driver API).
``LAUNCHES`` counts the kernel's launches by :func:`epilogue`; the graph's
launch site counts those it replays (see :mod:`repro_torch.kernels.
launches`).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import launches
from repro_torch.kernels.decode_loop import ref

I32 = torch.int32
MAX_SLOTS = 1024     # B at most: one thread a slot (csrc: kMaxSlots)

# Kernel launches: one a tick, one a chunk's init.
LAUNCHES: Dict[str, int] = launches.register(
    {"decode_loop": 0}, {"decode_loop": ("decode_loop_kernel",)})


def buffers(B: int, k: int, device):
    """Zeroed (inp, out, ctl) for B slots and chunks of up to k ticks."""
    if not 1 <= B <= MAX_SLOTS:
        raise ValueError(f"decode_loop: B={B} slots; the kernel takes 1 to "
                         f"{MAX_SLOTS}")
    if k < 1:
        raise ValueError(f"decode_loop: k={k} ticks a chunk must be >= 1")
    z = lambda n: torch.zeros((n,), dtype=I32, device=device)
    return z(4 * B + 2), z(1 + 3 * k * B), z(2)


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("decode_loop")
    p, i, h = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
    lib.decode_loop_epilogue.argtypes = [p] * 5 + [i] * 4 + [h, p]
    lib.decode_graph_create.argtypes = [ctypes.POINTER(p),
                                        ctypes.POINTER(h)]
    lib.decode_graph_finish.argtypes = [p, h, p, p, p, p, i, i, i,
                                        ctypes.POINTER(p), ctypes.POINTER(p)]
    lib.decode_graph_kernels.argtypes = [p, ctypes.c_char_p, h,
                                         ctypes.POINTER(h),
                                         ctypes.POINTER(i)]
    lib.decode_graph_launch.argtypes = [p, p]
    lib.decode_graph_destroy.argtypes = [p, p]
    for fn in (lib.decode_loop_epilogue, lib.decode_graph_create,
               lib.decode_graph_finish, lib.decode_graph_kernels,
               lib.decode_graph_launch, lib.decode_graph_destroy):
        fn.restype = i
    return lib


def _check(what: str, err: int) -> None:
    if err != 0:
        why = ("bad arguments" if err < 0 else
               f"CUresult {err - 100000}" if err >= 100000 else "cudaError")
        raise RuntimeError(f"decode_loop: {what} failed: error {err} "
                           f"({why})")


def graph_kernels(graph: int) -> Tuple[List[str], Dict[str, int]]:
    """The kernel nodes of ``graph`` (a ``cudaGraph_t``) and of the child
    graphs it holds, not inside conditional nodes' bodies: their device
    functions' names (mangled), one a node, and the count of each kind of
    node (kernel, memcpy, memset, other)."""
    lib = _lib()
    need, counts = ctypes.c_ulonglong(), (ctypes.c_int * 4)()
    _check("graph walk", lib.decode_graph_kernels(
        graph, None, 0, ctypes.byref(need), counts))
    buf = ctypes.create_string_buffer(max(int(need.value), 1))
    _check("graph walk", lib.decode_graph_kernels(
        graph, buf, len(buf), ctypes.byref(need), counts))
    names = buf.raw[:int(need.value)].decode().splitlines()
    kinds = dict(zip(("kernel", "memcpy", "memset", "other"), counts))
    if len(names) != kinds["kernel"]:
        raise RuntimeError(f"decode_loop: graph walk listed {len(names)} "
                           f"names for {kinds['kernel']} kernel nodes")
    return names, kinds


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def epilogue(sampled, lengths, inp, out, ctl, *, k: int, max_len: int,
             init: bool = False, handle: int = 0) -> None:
    """One tick's loop control in place (see the module note); with
    ``init`` the chunk's start (``sampled`` and ``lengths`` unused, may
    be None).  ``handle`` (CUDA only) is the graph's while condition the
    kernel sets to go; 0 sets none."""
    B = (inp.numel() - 2) // 4
    if inp.device.type == "cpu":
        if init:
            ref.init_plain(inp, out, ctl, B=B, k=k)
        else:
            ref.epilogue_plain(sampled, lengths, inp, out, ctl, k=k,
                               max_len=max_len)
        return
    dev = inp.device
    if dev.type != "cuda":
        raise ValueError(f"decode_loop: the kernel runs on CUDA tensors, "
                         f"got {dev}")
    tensors = [inp, out, ctl] + ([] if init else [sampled, lengths])
    if any(t.device != dev or t.dtype != I32 or not t.is_contiguous()
           for t in tensors):
        raise ValueError(f"decode_loop: every buffer must be a contiguous "
                         f"int32 tensor on {dev}")
    if (out.numel() != 1 + 3 * k * B or ctl.numel() != 2
            or (not init and (sampled.numel() != B or lengths.numel() != B))):
        raise ValueError(f"decode_loop: buffer sizes inp {inp.numel()} out "
                         f"{out.numel()} ctl {ctl.numel()} do not fit B={B}, "
                         f"k={k}")
    ptr = lambda t: None if init else t.data_ptr()
    with torch.cuda.device(dev):
        err = _lib().decode_loop_epilogue(
            ptr(sampled), ptr(lengths), inp.data_ptr(), out.data_ptr(),
            ctl.data_ptr(), B, k, max_len, int(bool(init)), handle,
            _stream(dev))
    _check("launch", err)
    LAUNCHES["decode_loop"] += 1


class LoopGraph:
    """The outer graph of a chunk on CUDA: [init kernel] -> while (go)
    { tick }.  Create it, capture the tick with :attr:`handle` passed to
    :func:`epilogue`, then :meth:`finish` with the captured graph."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._lib = _lib()
        graph, handle = ctypes.c_void_p(), ctypes.c_ulonglong()
        with torch.cuda.device(self.device):
            _check("graph creation", self._lib.decode_graph_create(
                ctypes.byref(graph), ctypes.byref(handle)))
        self._graph, self._exec, self._body = graph, None, None
        self.handle = int(handle.value)

    def finish(self, tick_graph: int, inp, out, ctl, *, k: int,
               max_len: int) -> None:
        """Build the loop around ``tick_graph`` (a ``cudaGraph_t``, e.g.
        ``torch.cuda.CUDAGraph.raw_cuda_graph()``) and instantiate it."""
        B = (inp.numel() - 2) // 4
        exec_, body = ctypes.c_void_p(), ctypes.c_void_p()
        with torch.cuda.device(self.device):
            _check("graph instantiation", self._lib.decode_graph_finish(
                self._graph, self.handle, tick_graph, inp.data_ptr(),
                out.data_ptr(), ctl.data_ptr(), B, k, max_len,
                ctypes.byref(exec_), ctypes.byref(body)))
        self._exec, self._body = exec_, body

    def kernels(self) -> Tuple[Tuple[List[str], Dict[str, int]],
                               Tuple[List[str], Dict[str, int]]]:
        """(:func:`graph_kernels` of what a launch runs once, of what it
        runs once a tick: the while node's body), read from the graph
        that was instantiated."""
        if self._exec is None:
            raise RuntimeError("decode_loop: the graph is not finished")
        with torch.cuda.device(self.device):
            return (graph_kernels(self._graph.value),
                    graph_kernels(self._body.value))

    def launch(self) -> None:
        """One chunk, on the current stream."""
        if self._exec is None:
            raise RuntimeError("decode_loop: the graph is not finished")
        with torch.cuda.device(self.device):
            _check("graph launch", self._lib.decode_graph_launch(
                self._exec, _stream(self.device)))

    def close(self) -> None:
        if self._graph is not None:
            torch.cuda.synchronize(self.device)
            self._lib.decode_graph_destroy(self._exec, self._graph)
            self._graph = self._exec = self._body = None

    def __del__(self):
        try:
            self.close()
        except Exception:   # interpreter shutdown: CUDA may be gone
            pass


__all__ = ["MAX_SLOTS", "LAUNCHES", "buffers", "epilogue", "graph_kernels",
           "LoopGraph"]
