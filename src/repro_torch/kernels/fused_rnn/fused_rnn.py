"""Fused LSTM/GRU serving kernels for Hopper (port of
``repro.kernels.fused_rnn.fused_rnn``).

The CUDA source is ``repro_torch/csrc/fused_rnn.cu``; its head note says
what it replaces, what bounds it and how it is laid out.  This module
checks the operands, allocates the outputs and scratch and launches the
kernels through a plain C interface (``ctypes``), on PyTorch's current
stream.

On a CPU tensor the wrappers run the plain PyTorch version
(:mod:`.ref`); on a CUDA tensor they launch the kernels or raise.

Streaming mode (``persistent=False``, the serving path) is two kernels:
:func:`xproj` computes the input half of the gates for all T steps at
once (``wgmma`` for int8 weights, over the tile :func:`xproj_tile` picks,
into an f32 scratch buffer), then :func:`lstm_steps` / :func:`gru_steps`
launch one step kernel per time step that reads only W_h.  A step's grid
is ``cs`` x H/bh CTAs: ``bh`` units across all G
gates per tile, the tile's H rows of W_h split over the ``cs`` CTAs of a
thread block cluster (:func:`cluster_size`); the steps are chained by
programmatic dependent launch (:data:`PDL`).  Persistent mode launches
one cooperative kernel for all T with each CTA's weight slice in shared
memory, H/bh CTAs, and raises if they cannot be co-resident.

Weight layout: w_x (D, G, H), w_h (H, G, H) int8 or bf16; gate order
(i, j, f, o) for LSTM, (r, z, n) for GRU; scales (G, H) f32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch import hw
from repro_torch.kernels.fused_rnn import ref

F32 = torch.float32
THREADS = 256     # threads per CTA (csrc: kThreads)
VEC = 4           # persistent: units per thread slot (csrc: kVec)
BCH = 4           # batch rows per pass (csrc: kBch)
LOAD_BYTES = 16   # streaming: bytes of W_h per load (csrc: kLoad)
MAX_CLUSTER = 8   # streaming: CTAs of a cluster at most (csrc: kMaxCluster)
MIN_ROWS = 2      # streaming: rows of W_h a thread reads at least
XPROJ_BMS = (16, 32, 64, 128, 256)   # int8 projection: rows of M a CTA (wgmma n)
XPROJ_BN = 128        # int8 projection: output columns a CTA (csrc: kXN)
XPROJ_BK = 64         # int8 projection: K a step (csrc: kXK)
XPROJ_MAX_SPLIT = 8   # int8 projection: K splits, the CTAs of a cluster, at most
XPROJ_THREADS = 288   # int8 projection: 2 math warpgroups + a loader warp
XPROJ_BF16_TILE = (64, 128, 32)   # bf16 projection (mma.sync): rows, columns, k-step
XPROJ_STEP_ROWS = 64  # int8 projection: a CTA's fixed cost of a K step, in rows
#                       of wgmma work (fitted to chip_smoke.py's projection sweep)

# Programmatic dependent launch between step kernels (chip_smoke.py times
# the steps with it off as well).
PDL = True

# Kernel launches by kernel: a streaming call counts one ``*_xproj`` and T
# steps, a persistent call one.
LAUNCHES: Dict[str, int] = {"fused_lstm": 0, "fused_lstm_xproj": 0,
                            "fused_lstm_persistent": 0,
                            "fused_gru": 0, "fused_gru_xproj": 0,
                            "fused_gru_persistent": 0}


def k_split(n_gates: int, bh: int) -> int:
    """Persistent kernel: ways the D+H contraction rows are split across
    a CTA's threads."""
    return max(1, THREADS // (n_gates * bh // VEC))


def stream_vec(wbytes: int) -> int:
    """Streaming: units of one (row, gate) in a 16-byte load of W_h."""
    return LOAD_BYTES // wbytes


def stream_k_split(n_gates: int, bh: int, wbytes: int) -> int:
    """Streaming: ways a CTA's rows of W_h are split across its threads,
    one 16-byte column chunk (of G * bh / :func:`stream_vec`) a thread."""
    return max(1, THREADS // max(1, n_gates * bh // stream_vec(wbytes)))


def stream_tile_ok(n_gates: int, H: int, bh: int, wbytes: int) -> bool:
    """Can the step kernel run this tile: bh | H, whole 16-byte loads,
    at most one column chunk per thread?"""
    vec = stream_vec(wbytes)
    return (0 < bh <= H and H % bh == 0 and bh % vec == 0
            and n_gates * bh // vec <= THREADS)


def legal_bh(n_gates: int, H: int, bh: int, wbytes: int,
             persistent: bool) -> int:
    """The tile a requested ``bh`` (a plan's, or the JAX DSE's) becomes in
    the mode it runs on the card.  Streaming: the largest divisor of H at
    or below the request that :func:`stream_tile_ok` accepts, else the
    smallest such divisor; raises when H has none.  Persistent: the
    largest divisor of H at or below the request (its residency is
    checked at launch)."""
    H = int(H)
    bh = max(1, min(int(bh), H))
    if persistent:
        while H % bh:
            bh -= 1
        return bh
    legal = [d for d in range(stream_vec(wbytes), H + 1, stream_vec(wbytes))
             if stream_tile_ok(n_gates, H, d, wbytes)]
    if not legal:
        raise ValueError(
            f"{_cell(n_gates)}: no streaming tile divides H={H} in whole "
            f"{LOAD_BYTES}-byte loads with G*bh/{stream_vec(wbytes)} <= "
            f"{THREADS}")
    below = [d for d in legal if d <= bh]
    return below[-1] if below else legal[0]


def xproj_stages(bm: int) -> int:
    """Ring stages of the int8 projection kernel at ``bm`` rows (csrc:
    ``XP<BM>::kStages``): ~96 KB of ring up to bm 128, two CTAs an SM."""
    return 8 if bm <= 32 else 6 if bm == 64 else 4 if bm == 128 else 5


def xproj_smem_bytes(bm: int) -> int:
    """Dynamic shared memory of one int8 projection CTA (csrc:
    ``XP<BM>::kSmem``): the ring of x (bm x 64 bf16) and int8 W (64 x 128)
    steps and 1 KB to align it."""
    return xproj_stages(bm) * (bm * XPROJ_BK * 2 + XPROJ_BK * XPROJ_BN) + 1024


def xproj_k_steps(K: int) -> int:
    """K steps of :data:`XPROJ_BK` rows that cover K."""
    return -(-int(K) // XPROJ_BK)


def xproj_splits(N: int, K: int, sms: int) -> int:
    """K splits of the int8 projection, the CTAs of a cluster that sum an
    output in order: a function of (N, K, SMs) alone, never of M, so that
    a batch row sums its K in the order its request alone does.  Two
    where two splits of the 128-column tiles still fit the SMs and K has
    two steps, else one: at small M a CTA's time follows its K steps, so
    splitting fills the card (lstm-2048 at M = 25: 19.6 -> 12.6 us); at
    M >= 375 the row tiles fill it already and each split costs 10-26 %
    (more splits cost more: PERF.md section 6, the projection sweep)."""
    tiles = -(-int(N) // XPROJ_BN)
    return 2 if 2 * tiles <= int(sms) and xproj_k_steps(K) >= 2 else 1


def xproj_bm(M: int, N: int, K: int, sms: int) -> int:
    """Rows of M an int8 projection CTA takes: the bm of
    :data:`XPROJ_BMS` with the fewest rounds of CTAs over the SMs times
    (bm + :data:`XPROJ_STEP_ROWS`), ties to the larger.  A CTA widens its
    whole 64 x 128 weight tile each step whatever bm, so fewer, taller
    CTAs win once the SMs are covered.  Every bm sums an output in the
    same order, so the choice may follow M."""
    ctas = -(-int(N) // XPROJ_BN) * xproj_splits(N, K, sms)
    return min(reversed(XPROJ_BMS),
               key=lambda bm: -(-(-(-int(M) // bm) * ctas) // int(sms))
               * (bm + XPROJ_STEP_ROWS))


@functools.lru_cache(maxsize=4096)
def xproj_tile(M: int, N: int, K: int, sms: int) -> Tuple[int, int]:
    """(bm, splits) of the int8 projection at (M, N, K) on a card with
    ``sms`` SMs: :func:`xproj_bm` and :func:`xproj_splits`."""
    return xproj_bm(M, N, K, sms), xproj_splits(N, K, sms)


def cluster_size(n_gates: int, H: int, bh: int, wbytes: int,
                 sms: int) -> int:
    """CTAs of a cluster that split one tile's H rows of W_h: as many as
    keep the grid (cs x H/bh CTAs) within the card's SMs, at most
    ``MAX_CLUSTER``, each thread keeping ``MIN_ROWS`` rows.  A function
    of the tile alone, so a batch and its rows served alone sum alike."""
    ks = stream_k_split(n_gates, bh, wbytes)
    return max(1, min(MAX_CLUSTER, sms // (H // bh), H // (ks * MIN_ROWS)))


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def smem_bytes(n_gates: int, D: int, H: int, bh: int, batch: int,
               wbytes: int, persistent: bool) -> int:
    """Dynamic shared memory of one CTA (csrc: ``layout`` and
    ``stream_smem``).  Persistent: the weight slice, x_t|h_{t-1} staged in
    bf16 and the f32 partial sums of the x and h products.  Streaming:
    h_{t-1} staged in bf16 and the f32 partials of the W_h product."""
    bch = min(batch, BCH)
    if persistent:
        R = D + H
        red = k_split(n_gates, bh) * bch * n_gates * bh * 4
        return (_align16(R * n_gates * bh * wbytes) + _align16(bch * R * 2)
                + 2 * red)
    return (_align16(bch * H * 2)
            + stream_k_split(n_gates, bh, wbytes) * bch * n_gates * bh * 4)


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("fused_rnn")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fused_rnn_persistent.argtypes = [i] + [p] * 10 + [i] * 7 + [ll, p]
    lib.fused_rnn_persistent.restype = i
    lib.fused_rnn_xproj.argtypes = [p] * 5 + [i] * 6 + [p]
    lib.fused_rnn_xproj.restype = i
    lib.fused_rnn_stream.argtypes = [i] + [p] * 7 + [i] * 7 + [ll, i, p]
    lib.fused_rnn_stream.restype = i
    lib.fused_rnn_max_blocks_per_sm.argtypes = [i] * 4 + [
        ll, ctypes.POINTER(i)]
    lib.fused_rnn_max_blocks_per_sm.restype = i
    return lib


def _check_cuda(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: error {err} "
                           f"({'bad arguments' if err < 0 else 'cudaError'})")


def _blocks_per_sm(n_gates: int, persistent: bool, wbytes: int, batch: int,
                   smem: int, device) -> int:
    lib = _lib()
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        _check_cuda(lib.fused_rnn_max_blocks_per_sm(
            n_gates, int(persistent), int(wbytes == 2), batch, smem,
            ctypes.byref(n)), "cudaOccupancyMaxActiveBlocksPerMultiprocessor")
    return n.value


def max_coresident_ctas(n_gates: int, smem: int, device) -> int:
    """CTAs of the persistent kernel the card can hold at once."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return _blocks_per_sm(n_gates, True, 1, 1, smem, device) * sms


def stream_blocks_per_sm(n_gates: int, wbytes: int, batch: int, smem: int,
                         device) -> int:
    """CTAs of the step kernel one SM holds: 2 lets step t+1's CTAs wait
    beside step t's under programmatic dependent launch."""
    return _blocks_per_sm(n_gates, False, wbytes, batch, smem, device)


def stream_geometry(n_gates: int, H: int, bh: int, wbytes: int,
                    device) -> Tuple[int, int]:
    """(cs, CTAs a step) of the step kernel on this device."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    cs = cluster_size(n_gates, H, bh, wbytes, sms)
    return cs, cs * (H // bh)


def _cell(n_gates: int) -> str:
    return "fused_lstm" if n_gates == 4 else "fused_gru"


def _on_cuda(name: str, tensors) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel runs on CUDA tensors, got {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all operands must be on {dev}")
    return dev


def _check_weight(name: str, w, rows: int, G: int, H: int) -> None:
    if tuple(w.shape) != (rows, G, H):
        raise ValueError(f"{name}: weight {tuple(w.shape)} is not "
                         f"({rows}, {G}, {H})")
    if w.dtype not in (torch.int8, torch.bfloat16):
        raise ValueError(f"{name}: weights must be int8 or bf16, got {w.dtype}")


def _vecs(name: str, vecs, G: int, H: int):
    if any(tuple(v.shape) != (G, H) for v in vecs):
        raise ValueError(f"{name}: scales and biases must be ({G}, {H})")
    return [v.to(F32).contiguous() for v in vecs]


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def xproj(x_seq, w_x, s_x, b, *, bm: Optional[int] = None,
          splits: Optional[int] = None) -> torch.Tensor:
    """The input half of the gates for all T steps at once: x_seq (T, B,
    D), w_x (D, G, H) int8/bf16, s_x and b (G, H) -> zx (T, B, G, H) f32
    = s_x * (bf16(x) . w_x) + b (b: the LSTM bias, or the GRU's b_x).

    int8 weights run the ``wgmma`` kernel at :func:`xproj_tile`'s (bm,
    splits) for M = T*B unless ``bm`` / ``splits`` override them; bf16
    weights the ``mma.sync`` kernel at :data:`XPROJ_BF16_TILE`."""
    if x_seq.device.type == "cpu":
        return ref.xproj_ref(x_seq, w_x, s_x, b)
    T, B, D = x_seq.shape
    G, H = w_x.shape[1], w_x.shape[2]
    name = _cell(G) + "_xproj"
    dev = _on_cuda(name, [x_seq, w_x, s_x, b])
    _check_weight(name, w_x, D, G, H)
    sx, bb = _vecs(name, [s_x, b], G, H)
    zx = torch.empty((T, B, G, H), dtype=F32, device=dev)
    M, N = T * B, G * H
    if M == 0:
        return zx
    if w_x.dtype == torch.bfloat16:
        if bm is not None or splits is not None:
            raise ValueError(f"{name}: bf16 weights run one tile "
                             f"{XPROJ_BF16_TILE}; bm/splits are int8's")
        tile = (XPROJ_BF16_TILE[0], 1)
    else:
        index = torch.cuda.current_device() if dev.index is None \
            else dev.index
        dbm, dsp = xproj_tile(M, N, D, _sms(index))
        tile = (dbm if bm is None else int(bm),
                dsp if splits is None else int(splits))
        most = min(XPROJ_MAX_SPLIT, xproj_k_steps(D))
        if tile[0] not in XPROJ_BMS or not 1 <= tile[1] <= most:
            raise ValueError(
                f"{name}: tile bm={tile[0]}, splits={tile[1]}: bm in "
                f"{XPROJ_BMS}, splits in [1, {most}]")
    x = x_seq.to(torch.bfloat16).contiguous()
    wx = w_x.contiguous()
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_rnn_xproj(
            x.data_ptr(), wx.data_ptr(), sx.data_ptr(), bb.data_ptr(),
            zx.data_ptr(), M, D, N, int(wx.element_size() == 2), tile[0],
            tile[1], stream)
    _check_cuda(err, f"{name} launch")
    LAUNCHES[name] += 1
    return zx


def _steps(G: int, zx, w_h, s_h, b_h, h0, c0, bh: int):
    """T step launches on zx (T, B, G, H) f32; returns (y, h_T, c_T)."""
    name = _cell(G)
    T, B = zx.shape[0], zx.shape[1]
    H = w_h.shape[0]
    state = [h0] + ([c0] if c0 is not None else [])
    vecs = [s_h] + ([b_h] if b_h is not None else [])
    dev = _on_cuda(name, [zx, w_h, *vecs, *state])
    _check_weight(name, w_h, H, G, H)
    if tuple(zx.shape) != (T, B, G, H) or zx.dtype != F32:
        raise ValueError(f"{name}: zx must be ({T}, {B}, {G}, {H}) f32")
    if any(tuple(v.shape) != (B, H) for v in state):
        raise ValueError(f"{name}: state must be ({B}, {H})")
    wbytes = w_h.element_size()
    bh = min(int(bh), H)
    if not stream_tile_ok(G, H, bh, wbytes):
        raise ValueError(
            f"{name}: needs bh | H, {stream_vec(wbytes)} | bh and "
            f"G*bh/{stream_vec(wbytes)} <= {THREADS} (H={H}, bh={bh})")
    sh, *rest = _vecs(name, vecs, G, H)
    bhb = rest[0] if rest else None
    zx = zx.contiguous()
    wh = w_h.contiguous()
    hbuf = torch.empty((2, B, H), dtype=F32, device=dev)
    hbuf[0].copy_(h0)
    c = c0.to(F32).clone() if c0 is not None else None
    y = torch.empty((T, B, H), dtype=torch.bfloat16, device=dev)
    if T == 0:
        return y, hbuf[0], c
    smem = smem_bytes(G, 0, H, bh, B, wbytes, False)   # no x staged: D unused
    optin = hw.smem_budget(hw.from_device(dev))
    if smem > optin:
        raise ValueError(f"{name}: bh={bh} needs {smem} B of shared memory "
                         f"per CTA, the card allows {optin}")
    cs, _ = stream_geometry(G, H, bh, wbytes, dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_rnn_stream(
            G, zx.data_ptr(), wh.data_ptr(), sh.data_ptr(),
            bhb.data_ptr() if bhb is not None else None, hbuf.data_ptr(),
            c.data_ptr() if c is not None else None, y.data_ptr(),
            T, B, H, bh, cs, stream_k_split(G, bh, wbytes),
            int(wbytes == 2), smem, int(PDL), stream)
    _check_cuda(err, f"{name} launch")
    LAUNCHES[name] += T
    return y, hbuf[T % 2], c


def lstm_steps(zx, w_h, s_h, h0, c0, *, bh: int = 256):
    """The LSTM recurrence on a precomputed zx (T, B, 4, H) f32 (bias
    included): one step kernel per time step.  Returns (y, h_T, c_T)."""
    if zx.device.type == "cpu":
        return ref.lstm_steps_ref(zx, w_h, s_h, h0, c0)
    return _steps(4, zx, w_h, s_h, None, h0, c0, bh)


def gru_steps(zx, w_h, s_h, b_h, h0, *, bh: int = 256):
    """The GRU recurrence on a precomputed zx (T, B, 3, H) f32 (b_x
    included).  Returns (y, h_T)."""
    if zx.device.type == "cpu":
        return ref.gru_steps_ref(zx, w_h, s_h, b_h, h0)
    y, hT, _ = _steps(3, zx, w_h, s_h, b_h, h0, None, bh)
    return y, hT


def _persistent(name: str, G: int, x_seq, w_x, w_h, s_x, s_h, b, b_h, h0,
                c0, bh: int):
    T, B, D = x_seq.shape
    H = w_h.shape[0]
    bh = min(int(bh), H)
    if H % bh or bh % VEC or H % VEC:
        raise ValueError(f"{name}: needs bh | H and 4 | bh, 4 | H "
                         f"(H={H}, bh={bh})")
    vecs = [s_x, s_h, b] + ([b_h] if b_h is not None else [])
    state = [h0] + ([c0] if c0 is not None else [])
    dev = _on_cuda(name, [x_seq, w_x, w_h, *vecs, *state])
    _check_weight(name, w_x, D, G, H)
    _check_weight(name, w_h, H, G, H)
    if w_x.dtype != w_h.dtype:
        raise ValueError(f"{name}: weights must both be int8 or bf16, got "
                         f"{w_x.dtype}, {w_h.dtype}")
    if any(tuple(v.shape) != (B, H) for v in state):
        raise ValueError(f"{name}: state must be ({B}, {H})")
    sx, sh, bb, *rest = _vecs(name, vecs, G, H)
    bhb = rest[0] if rest else None
    x = x_seq.to(torch.bfloat16).contiguous()
    wx, wh = w_x.contiguous(), w_h.contiguous()
    hbuf = torch.empty((2, B, H), dtype=F32, device=dev)
    hbuf[0].copy_(h0)
    c = c0.to(F32).clone() if c0 is not None else None
    y = torch.empty((T, B, H), dtype=torch.bfloat16, device=dev)
    if T == 0:
        return y, hbuf[0], c
    wbytes = wx.element_size()
    smem = smem_bytes(G, D, H, bh, B, wbytes, True)
    optin = hw.smem_budget(hw.from_device(dev))
    if smem > optin:
        raise ValueError(f"{name}: bh={bh} needs {smem} B of shared memory "
                         f"per CTA, the card allows {optin}")
    cap = max_coresident_ctas(G, smem, dev)
    if H // bh > cap:
        raise ValueError(
            f"{name}: persistent grid of {H // bh} CTAs ({smem} B shared "
            f"memory each) cannot be co-resident; the card holds {cap}")
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_rnn_persistent(
            G, x.data_ptr(), wx.data_ptr(), wh.data_ptr(),
            sx.data_ptr(), sh.data_ptr(), bb.data_ptr(),
            bhb.data_ptr() if bhb is not None else None, hbuf.data_ptr(),
            c.data_ptr() if c is not None else None, y.data_ptr(),
            T, B, D, H, bh, k_split(G, bh), int(wbytes == 2), smem, stream)
    _check_cuda(err, f"{name} launch")
    LAUNCHES[name + "_persistent"] += 1
    return y, hbuf[T % 2], c


def fused_lstm(x_seq, w_x, w_h, s_x, s_h, b, h0, c0, *,
               bh: int = 256, persistent: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x_seq (T, B, D); w_x (D, 4, H) int8/bf16; s_* (4, H) f32; b (4, H);
    h0/c0 (B, H).  Returns (y (T, B, H) bf16, h_T (B, H) f32, c_T).

    ``bh`` is the number of units one tile owns across all gates;
    streaming (the default) projects x for all T (:func:`xproj`), then
    runs the steps on W_h (:func:`lstm_steps`); ``persistent=True`` keeps
    each CTA's weight slice in shared memory for all T steps (one
    cooperative launch of H/bh CTAs)."""
    if x_seq.device.type == "cpu":
        return ref.fused_lstm_ref(x_seq, w_x, w_h, s_x, s_h, b, h0, c0)
    if persistent:
        return _persistent("fused_lstm", 4, x_seq, w_x, w_h, s_x, s_h, b,
                           None, h0, c0, bh)
    return lstm_steps(xproj(x_seq, w_x, s_x, b), w_h, s_h, h0, c0, bh=bh)


def fused_gru(x_seq, w_x, w_h, s_x, s_h, b_x, b_h, h0, *,
              bh: int = 256, persistent: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_seq (T, B, D); w_x (D, 3, H); s_* (3, H); b_* (3, H); h0 (B, H).
    Returns (y (T, B, H) bf16, h_T (B, H) f32).  See ``fused_lstm`` for
    the ``bh``/``persistent`` contract."""
    if x_seq.device.type == "cpu":
        return ref.fused_gru_ref(x_seq, w_x, w_h, s_x, s_h, b_x, b_h, h0)
    if persistent:
        y, hT, _ = _persistent("fused_gru", 3, x_seq, w_x, w_h, s_x, s_h,
                               b_x, b_h, h0, None, bh)
        return y, hT
    return gru_steps(xproj(x_seq, w_x, s_x, b_x), w_h, s_h, b_h, h0, bh=bh)
