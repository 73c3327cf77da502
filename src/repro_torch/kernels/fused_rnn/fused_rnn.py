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
programmatic dependent launch (:data:`PDL`).

Persistent mode (``persistent=True``, what a plan's ``persistent: true``
asks for) is the same projection, then one launch for all T steps: a
tile of bh units (G * bh <= :data:`PERSIST_MAX_UNITS`) split by rows of
W_h over a cluster of ``cs`` CTAs, each CTA's slice of W_h copied into
its shared memory once and read there at every step (``mma.sync``,
int8 widened exactly in registers), each step handing h_t to the next
through y's own slot (filled with an empty mark, 0xFFFF, before the
launch; the next step reloads its rows until none is empty).  ``cs`` is the smallest
cluster whose grid the card holds at once (:func:`persist_geometry_on_card`,
by the card's occupancy count; :func:`persist_geometry` models it for the
DSE); a grid that cannot be resident raises before anything is launched.

Weight layout: w_x (D, G, H), w_h (H, G, H) int8 or bf16; gate order
(i, j, f, o) for LSTM, (r, z, n) for GRU; scales (G, H) f32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch import hw
from repro_torch.kernels import launches
from repro_torch.kernels.fused_rnn import ref

F32 = torch.float32
THREADS = 256     # threads per CTA (csrc: kThreads)
BCH = 4           # streaming: batch rows per pass (csrc: kBch)
LOAD_BYTES = 16   # streaming: bytes of W_h per load (csrc: kLoad)
MAX_CLUSTER = 8   # CTAs of a cluster at most (csrc: kMaxCluster)
PERSIST_MAX_UNITS = 128   # persistent: a tile's G * bh outputs at most (csrc:
#                           16 x kPMaxM), the m16 tiles a warp's sums hold
PERSIST_N = 8             # persistent: batch rows a pass, mma.sync's n (csrc: kPBatch)
PERSIST_WARPS = 8         # persistent: row splits of a CTA, one a warp (csrc: kPWarps)
PERSIST_BLOCK = 512       # persistent: bytes of one (k-step, m16 tile) block
PERSIST_REGS = 128        # persistent: registers a thread at most
#                           (__launch_bounds__(256, 2)): two CTAs an SM
GPCS = 8                  # H100: graphics processing clusters; a thread block
#                           cluster never spans two (132 SMs: 16 or 18 each)
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
# steps, a persistent call one ``*_xproj`` and one ``*_persistent``.
# Not counted inside a CUDA graph (no device function names registered:
# the cells share their kernels).
LAUNCHES: Dict[str, int] = launches.register(
    {"fused_lstm": 0, "fused_lstm_xproj": 0, "fused_lstm_persistent": 0,
     "fused_gru": 0, "fused_gru_xproj": 0, "fused_gru_persistent": 0}, {})


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
    largest divisor of H at or below the request and at most
    :data:`PERSIST_MAX_UNITS` / G (:func:`persist_tile_ok`; its residency
    is checked at launch)."""
    H = int(H)
    bh = max(1, min(int(bh), H))
    if persistent:
        bh = min(bh, PERSIST_MAX_UNITS // n_gates)
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


def persist_tile_ok(n_gates: int, H: int, bh: int) -> bool:
    """Can the persistent kernel run this tile: bh | H and at most
    :data:`PERSIST_MAX_UNITS` outputs (G * bh)?"""
    return 0 < bh <= H and H % bh == 0 and n_gates * bh <= PERSIST_MAX_UNITS


def persist_kstep(wbytes: int) -> int:
    """Persistent: rows of W_h a k-step covers, 16 bytes a lane of a warp:
    two k16 tiles of int8 codes, or one of bf16 values."""
    return 32 if wbytes == 1 else 16


def persist_ksteps(H: int, cs: int, wbytes: int) -> int:
    """Persistent: k-steps one CTA of a cluster of ``cs`` holds at most
    (H's ceil(H / kstep) k-steps split evenly over the cluster)."""
    return -(-(-(-int(H) // persist_kstep(wbytes))) // int(cs))


def persist_hs_words(ksr: int, wbytes: int) -> int:
    """Persistent: 32-bit words of one batch row of staged h_{t-1} (bf16):
    the CTA's rows, padded to 4 past a multiple of 32 words so that the
    eight batch rows of a B fragment load fall on distinct banks."""
    base = ksr * persist_kstep(wbytes) // 2
    return base + (4 - base) % 32


def persist_smem_bytes(n_gates: int, H: int, bh: int, cs: int, batch: int,
                       wbytes: int) -> int:
    """Dynamic shared memory of one persistent CTA (csrc: ``persist_smem``):
    its slice of W_h (mt x ksr blocks of 512 bytes, mt = ceil(G * bh / 16)
    unit tiles, ksr k-steps), h_{t-1} staged in bf16 for the batch rows of
    a pass, and the warps' f32 partials."""
    mt = -(-n_gates * int(bh) // 16)
    ksr = persist_ksteps(H, cs, wbytes)
    bch = min(int(batch), PERSIST_N)
    return (mt * ksr * PERSIST_BLOCK + bch * persist_hs_words(ksr, wbytes) * 4
            + PERSIST_WARPS * bch * mt * 16 * 4)


def smem_bytes(n_gates: int, D: int, H: int, bh: int, batch: int,
               wbytes: int, persistent: bool, cs: int = 1) -> int:
    """Dynamic shared memory of one CTA (csrc: ``persist_smem`` and
    ``stream_smem``).  Persistent: :func:`persist_smem_bytes` at a cluster
    of ``cs``.  Streaming: h_{t-1} staged in bf16 and the f32 partials of
    the W_h product.  D is not read: neither mode stages x."""
    if persistent:
        return persist_smem_bytes(n_gates, H, bh, cs, batch, wbytes)
    return (_align16(min(batch, BCH) * H * 2)
            + stream_k_split(n_gates, bh, wbytes) * min(batch, BCH)
            * n_gates * bh * 4)


def persist_ctas_per_sm(smem: int, spec: hw.HardwareSpec = hw.DEFAULT) -> int:
    """Persistent CTAs of ``smem`` bytes one SM holds: shared memory (the
    runtime reserves 1 KB a CTA), threads and :data:`PERSIST_REGS`."""
    return min(spec.smem_per_sm // (int(smem) + 1024),
               spec.max_threads_per_sm // THREADS,
               spec.regs_per_sm // (THREADS * PERSIST_REGS))


def persist_cluster_slots(cs: int, per_sm: int,
                          spec: hw.HardwareSpec = hw.DEFAULT) -> int:
    """Clusters of ``cs`` CTAs the card holds at once, modelled: pairs
    fill every SM (an SM pair is a TPC); larger clusters pack into each of
    the :data:`GPCS` GPCs apart, counted at the smallest GPC's SMs."""
    if cs <= 2:
        return per_sm * spec.sms // cs
    return GPCS * (per_sm * (spec.sms // GPCS) // cs)


@functools.lru_cache(maxsize=4096)
def persist_geometry(n_gates: int, H: int, bh: int, wbytes: int,
                     spec: hw.HardwareSpec = hw.DEFAULT
                     ) -> Optional[Tuple[int, int]]:
    """(cs, shared memory a CTA at a full pass of :data:`PERSIST_N` batch
    rows) of the persistent grid at tile ``bh``: the smallest cluster
    whose H/bh x cs CTAs fit a CTA's shared memory and are all resident at
    once on ``spec`` (:func:`persist_cluster_slots`), or None.  A function
    of the tile and the card, never of the batch: the cluster sets the
    order in which an output's rows are summed, so a batch row and its
    request alone get the same bits.  The card's own count decides at
    launch (:func:`persist_geometry_on_card`)."""
    if not persist_tile_ok(n_gates, H, bh):
        return None
    tiles = H // bh
    nks = -(-int(H) // persist_kstep(wbytes))
    for cs in range(1, min(MAX_CLUSTER, nks) + 1):
        smem = persist_smem_bytes(n_gates, H, bh, cs, PERSIST_N, wbytes)
        if smem > hw.smem_budget(spec):
            continue
        per_sm = persist_ctas_per_sm(smem, spec)
        if per_sm and tiles <= persist_cluster_slots(cs, per_sm, spec):
            return cs, smem
    return None


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("fused_rnn")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fused_rnn_persistent.argtypes = [i] + [p] * 8 + [i] * 7 + [ll, p]
    lib.fused_rnn_persistent.restype = i
    lib.fused_rnn_persist_clusters.argtypes = [i] * 3 + [ll, ctypes.POINTER(i)]
    lib.fused_rnn_persist_clusters.restype = i
    lib.fused_rnn_xproj.argtypes = [p] * 5 + [i] * 6 + [p]
    lib.fused_rnn_xproj.restype = i
    lib.fused_rnn_stream.argtypes = [i] + [p] * 7 + [i] * 7 + [ll, i, p]
    lib.fused_rnn_stream.restype = i
    lib.fused_rnn_max_blocks_per_sm.argtypes = [i] * 3 + [
        ll, ctypes.POINTER(i)]
    lib.fused_rnn_max_blocks_per_sm.restype = i
    return lib


def _check_cuda(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: error {err} "
                           f"({'bad arguments' if err < 0 else 'cudaError'})")


def stream_blocks_per_sm(n_gates: int, wbytes: int, batch: int, smem: int,
                         device) -> int:
    """CTAs of the step kernel one SM holds: 2 lets step t+1's CTAs wait
    beside step t's under programmatic dependent launch."""
    lib = _lib()
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        _check_cuda(lib.fused_rnn_max_blocks_per_sm(
            n_gates, int(wbytes == 2), batch, smem, ctypes.byref(n)),
            "cudaOccupancyMaxActiveBlocksPerMultiprocessor")
    return n.value


@functools.lru_cache(maxsize=4096)
def persist_clusters(n_gates: int, wbytes: int, cs: int, smem: int,
                     index: int) -> int:
    """Clusters of ``cs`` persistent CTAs of ``smem`` bytes that device
    ``index`` holds at once (``cudaOccupancyMaxActiveClusters``; for cs 1
    the CTAs, from the blocks an SM holds)."""
    lib = _lib()
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        _check_cuda(lib.fused_rnn_persist_clusters(
            n_gates, int(wbytes == 2), cs, smem, ctypes.byref(n)),
            "cudaOccupancyMaxActiveClusters")
    return n.value


def persist_geometry_on_card(n_gates: int, H: int, bh: int, wbytes: int,
                             device) -> int:
    """The cluster size ``cs`` of the persistent grid on this card: the
    smallest whose H/bh clusters the card holds at once, by its own
    occupancy count, at a full pass of :data:`PERSIST_N` batch rows (a
    smaller batch needs less shared memory and stays resident), so that
    the batch never changes an output's sum order.  Raises ``ValueError``
    naming the shortfall when none does: a step waits on every CTA's part
    of the last one, which CTAs that are not all resident never finish."""
    name = _cell(n_gates) + "_persistent"
    if not persist_tile_ok(n_gates, H, bh):
        raise ValueError(f"{name}: needs bh | H and G*bh <= "
                         f"{PERSIST_MAX_UNITS} (H={H}, bh={bh})")
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    optin = _smem_optin(index)
    tiles = H // bh
    nks = -(-int(H) // persist_kstep(wbytes))
    short = []
    for cs in range(1, min(MAX_CLUSTER, nks) + 1):
        smem = persist_smem_bytes(n_gates, H, bh, cs, PERSIST_N, wbytes)
        if smem > optin:
            short.append(f"cs={cs}: {smem} B a CTA > {optin}")
            continue
        n = persist_clusters(n_gates, wbytes, cs, smem, index)
        if n >= tiles:
            return cs
        short.append(f"cs={cs}: {n} of {tiles} clusters ({smem} B a CTA)")
    raise ValueError(f"{name}: a grid of {tiles} tiles (bh={bh}) cannot be "
                     f"co-resident on this card: {'; '.join(short)}")


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


@functools.lru_cache(maxsize=None)
def _smem_optin(index: int) -> int:
    return hw.smem_budget(hw.from_device(torch.device("cuda", index)))


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
    """The projection (:func:`xproj`), then one launch for all T steps
    with each CTA's slice of W_h resident in shared memory."""
    T, B, D = x_seq.shape
    H = w_h.shape[0]
    bh = min(int(bh), H)
    vecs = [s_x, s_h, b] + ([b_h] if b_h is not None else [])
    state = [h0] + ([c0] if c0 is not None else [])
    dev = _on_cuda(name, [x_seq, w_x, w_h, *vecs, *state])
    _check_weight(name, w_x, D, G, H)
    _check_weight(name, w_h, H, G, H)
    if any(tuple(v.shape) != (B, H) for v in state):
        raise ValueError(f"{name}: state must be ({B}, {H})")
    wbytes = w_h.element_size()
    # residency is proven before anything is launched
    cs = persist_geometry_on_card(G, H, bh, wbytes, dev)
    smem = persist_smem_bytes(G, H, bh, cs, B, wbytes)
    sh, *rest = _vecs(name, [s_h] + ([b_h] if b_h is not None else []), G, H)
    bhb = rest[0] if rest else None
    zx = xproj(x_seq, w_x, s_x, b)
    wh = w_h.contiguous()
    # slot 0: bf16(h0); slots 1..T: y, empty (0xFFFF, csrc: kPEmpty) until
    # the kernel writes them, which is how a step hands h_t to the next
    yb = torch.empty((T + 1, B, H), dtype=torch.bfloat16, device=dev)
    yb[0].copy_(h0)
    yb[1:].view(torch.int16).fill_(-1)
    h = h0.to(F32).clone(memory_format=torch.contiguous_format)
    c = (c0.to(F32).clone(memory_format=torch.contiguous_format)
         if c0 is not None else None)
    if T == 0:
        return yb[1:], h, c
    abort = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_rnn_persistent(
            G, zx.data_ptr(), wh.data_ptr(), sh.data_ptr(),
            bhb.data_ptr() if bhb is not None else None, yb.data_ptr(),
            h.data_ptr(), c.data_ptr() if c is not None else None,
            abort.data_ptr(), T, B, H, bh, cs, int(wbytes == 2),
            persist_hs_words(persist_ksteps(H, cs, wbytes), wbytes), smem,
            stream)
    _check_cuda(err, f"{name} launch")
    LAUNCHES[name + "_persistent"] += 1
    return yb[1:], h, c


def fused_lstm(x_seq, w_x, w_h, s_x, s_h, b, h0, c0, *,
               bh: int = 256, persistent: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x_seq (T, B, D); w_x (D, 4, H) int8/bf16; s_* (4, H) f32; b (4, H);
    h0/c0 (B, H).  Returns (y (T, B, H) bf16, h_T (B, H) f32, c_T).

    ``bh`` is the number of units one tile owns across all gates;
    streaming (the default) projects x for all T (:func:`xproj`), then
    runs the steps on W_h (:func:`lstm_steps`); ``persistent=True``
    projects x the same way, then runs all T steps in one launch with
    each CTA's slice of W_h resident in its shared memory."""
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
