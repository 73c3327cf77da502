"""Design-space exploration for the fused RNN kernel and the flash
attention kernel, retargeted to Hopper (port of the RNN and attention
searches of ``repro.core.dse``).

The paper's claim (§3.3, Table 7): exposing the loop tiling parameters
and searching them per problem size keeps utilization high across
DeepBench.  On Hopper the kernel's one tiling parameter is ``bh``, the
number of H units one CTA owns, so the grid is H/bh CTAs
(``repro_torch/csrc/fused_rnn.cu``).  The search scores each candidate
``bh`` with an analytic latency model built from :mod:`repro_torch.hw`:

  * streaming (the input projection once a call, then one launch per
    step): a step reads only W_h, g*H*H bytes, from L2 where it fits
    (else device memory), split over cs x H/bh CTAs (``cs`` the CTAs of
    a cluster that share a tile's rows, :func:`fused_rnn.cluster_size`).
    A step is a fixed cost that programmatic dependent launch leaves
    (the wait, the h_{t-1} read, the sums, the gates, the hand-off),
    a cost per further CTA of a cluster, and a CTA's share of the stream
    (chunks under a 32-byte sector cost part of the sector's other half)
    plus its widen-and-FMA issue, which add up on the card.  These
    constants were fitted to the step-tile sweep ``chip_smoke.py``'s
    phase 4 measures (PERF.md section 6).  The projection is
    modelled once a call (:func:`xproj_latency_s`): the ``wgmma``
    kernel's mainloop as the matmul search below scores it, over its
    (bm, splits) tile (:func:`fused_rnn.xproj_tile`), the f32 output's
    bytes, and the cluster's in-order sum of the K splits.
  * persistent (the same projection, then one launch for all T steps):
    only W_h is resident, each CTA's slice of it in its shared memory; a
    tile of bh units (at most 128 outputs) split by rows over a cluster of
    cs CTAs, cs the smallest whose grid the card holds at once
    (:func:`fused_rnn.persist_geometry`, at a full pass of 8 batch rows).
    A step is a fixed chain (the hand-off through y's slots, the sums,
    the gates), a cost a CTA of the grid and a further CTA of a cluster,
    the staging of the rank's rows of h_{t-1}, and the resident slice at
    the SM's shared-memory rate times the cost of a byte's widening and
    products.  These five constants were fitted (least squares on the
    relative error: 4.5 % rms, at most 17 %, over 43 points) to the
    persistent tile sweep ``chip_smoke.py``'s phase 4 measures: every
    resident tile of every DeepBench task, 100 steps at batch 1 (PERF.md
    section 6).  The ``resident`` field says
    the persistent grid fits at that tile.

``Plan`` and ``plan_dict`` keep the JAX package's fields and key set so
plans move between the packages; ``vmem_bytes`` carries the CTA's
shared-memory working set.  ``snap_tile``, ``candidate_tiles``,
``candidate_attn_tiles`` and the Fig. 4 fragmentation functions are the
JAX package's, unchanged.

The attention search scores ``flash_attention``'s (bq, bk)
(``repro_torch/csrc/flash_attention.cu``): a CTA of bq // 64 ``wgmma``
warpgroups of 64 query rows and a loader warp, K and V staged bk keys at
a time on a 2-slot TMA ring.  The JAX package's VMEM budget becomes the
shared memory one CTA may hold (``hw.smem_budget``); the CTAs an SM
holds follow from it, from the threads and from the registers.  Under a
causal mask a warpgroup computes only the 64-key tiles up to its last
row (the kernel skips the tiles no row sees), so the model counts those
tiles, the stages that carry them, and each CTA's time: a fixed
prologue and epilogue, a hand-off a stage, and its warpgroups' tiles side
by side, a tile's step mostly the softmax (slower where two warpgroups
share an SM's issue slots).  The CTAs spread over the SMs' slots (the
kernel launches the heaviest first), and no call is faster than its
tensor work or its bytes.  The constants were fitted so that the model
gives the tile sweep ``chip_smoke.py`` measures at qwen2.5-14b's 4 x 512
prefill (PERF.md section 6); the model counts iota rows, so there it
stands for a bucket with padding rows.  The candidates are the kernel's own tiles clamped to the
lengths, which need not divide them.

The matmul search scores ``matmul_w8a16``'s geometry
(``repro_torch/csrc/matmul_int8.cu``).  Above M = 16, the prefill
kernel's bm (token rows per CTA; bn is its 128 columns, bk its 64-row
step): the padded tiles' tensor-core work at the bf16 ``wgmma`` rate, in
waves of the CTAs an SM holds (one at bm 128 and 256: 288 threads whose
registers are granted by whole warpgroups, and up to 201 KB of shared
memory); a K step's shared-memory traffic (the TMA writes of x and the
int8 tile, the fragment loads of the weight, x read once by each math
warpgroup as ``wgmma``'s B) at the SM's shared-memory rate when it is the
longer, plus a fixed cost a step; the int8 weight streamed once per row
tile and x once per column tile from L2, and each read once from device
memory.  At M <= 16, the split-K decode kernel's S (``splits``; bn 128,
bk the 64-row step): its ceil(N / 128) x S CTAs and their waves, the
bytes they keep in flight (3 steps of 8 KB a CTA), a rate that needs 2
CTAs an SM (one streams while another waits at its step barrier), the
steps of the longest split (their issue overlaps the stream), the
stream's fill and drain, and the reduction pass (a second launch that
reads and the first that writes S x M x N f32).  ``candidate_mm_tiles``
is the JAX package's, unchanged; the kernel's own candidates come from
its tile sets, clamped to the shape, and at decode from S = 1 .. the K
steps.

The launch, barrier and tile intervals below are model constants, not
measurements: the card's times are in PERF.md.  The streaming step's and
the persistent step's constants were fitted to ``chip_smoke.py``'s tile
sweeps, the projection's and the attention and matmul searches' to
their sweeps; ``_LAUNCH_S``, ``_SECTOR`` and ``_PASS_S``
are not fitted.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

from repro_torch import hw
from repro_torch.core.cells import RNNCellConfig
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.fused_rnn import fused_rnn as fr
from repro_torch.kernels.fused_rnn.fused_rnn import (
    BCH, THREADS, cluster_size, smem_bytes, stream_k_split, stream_tile_ok,
    stream_vec)
from repro_torch.kernels.matmul_int8 import matmul_int8 as mm

MXU = 128       # the JAX package's lane width; kept for Fig. 4's rv default
SUBLANE = 8     # smallest candidate tile, as in the JAX package

_LAUNCH_S = 3e-6         # modeled interval between back-to-back launches
_SECTOR = 32             # bytes per L2 sector
_HANDOFF_S = 1.93e-6     # persistent: a step's fixed chain (the owners' y
#                          stores reaching L2, the next step's poll of them,
#                          the sums, the gates)
_PERSIST_BYTE = 4.84     # persistent: a resident W_h byte's cost over the
#                          SM's shared-memory byte time (read, widening,
#                          products)
_PERSIST_CTA_S = 3.05e-9 # persistent: a step's cost of each CTA of the grid
_PERSIST_H_BW = 5.39e9   # persistent: bytes/s a CTA stages h_{t-1} at (L2
#                          round trips, polling its rows)
_PERSIST_CLUSTER_S = 0.53e-6  # persistent: each further CTA of a cluster
#                          (two cluster barriers, distributed reads)
_PASS_S = 0.5e-6         # persistent: each further 8-row batch pass beyond
#                          its staging and slice (not fitted: the sweep is B=1)
_STEP_S = 4.0e-6         # modeled fixed cost of a streaming step under
#                          programmatic dependent launch (the wait, h read,
#                          sums, gates, hand-off)
_CLUSTER_S = 0.2e-6      # modeled cost of each further CTA of a cluster
_STEP_BW = 22.8e9        # modeled W_h read rate of one step CTA (from L2)
_STEP_ISSUE = 0.88       # modeled share of an SM's lane issue the widen+FMA gets
_XPROJ_STEP_S = 2.5e-7   # modeled fixed cost of a projection K step (barrier
#                          hand-offs, fragment loads, wgmma issue)
_XPROJ_TILE_S = 2e-6     # modeled fill of a projection CTA's ring + its epilogue
_XPROJ_SPLIT_S = 1e-6    # modeled cluster sum of each further K split of a
#                          64-row tile (distributed shared memory reads)
_SMEM_RESERVED = 1024    # shared memory the runtime reserves per CTA
_ATTN_TILE_S = 1.3e-7    # modeled hand-off of one K/V stage of a CTA
_ATTN_SUB_S = 1.6e-6     # modeled 64-key tile of a warpgroup, two on an SM
_ATTN_SUB_ALONE_S = 1.19e-6  # the same, a warpgroup alone on its SM
_ATTN_CTA_S = 1.0e-6     # modeled prologue (position scan, Q, first stage)
#                          and epilogue of a CTA, beyond what others hide
_ATTN_MEAN_S = 4.5e-6    # modeled mean-of-V pass launched first (any tile)
_ATTN_REGS = 168         # registers a thread of flash_fwd_kernel<128, NW> (ptxas)
_MM_STEP_S = 2e-7        # modeled K step of the matmul_w8a16 decode kernel
_MM_LATENCY_S = 1e-6     # modeled device-memory latency (bytes in flight / rate)
_MM_THREADS = 128        # threads of a matmul_w8a16 decode CTA
_MM_FILL_S = 2e-6        # modeled fill and drain of a decode launch's stream
#                          (and of its reduction pass)
_MM_PRE_STEP_S = 3e-7    # modeled fixed cost of a prefill K step (barrier
#                          hand-offs, fragment loads, wgmma issue)
_MM_TILE_S = 4e-6        # modeled fill of a prefill CTA's ring + its epilogue
_MM_L2_BW = 10e12        # modeled L2 read rate, all SMs (no data sheet figure)


@dataclasses.dataclass(frozen=True)
class Plan:
    bh: int                   # H units per CTA
    n_tiles: int              # CTAs (H / bh)
    vmem_bytes: int           # shared-memory working set of one CTA
    resident: bool            # weight slice fits a CTA and the grid co-resides
    step_latency_s: float     # modeled per-timestep latency
    util: float               # busy thread share x busy SM share
    bound: str                # "compute" | "smem" | "hbm" | "latency"
    # --- per-kernel tile fields (zero = unused by this kernel) ----------
    bq: int = 0
    bk: int = 0
    bm: int = 0
    bn: int = 0
    persistent: bool = False  # scored as the persistent (weights-resident) kernel
    splits: int = 0           # matmul_w8a16 decode: K splits (port-only key)


_OPTIONAL_PLAN_FIELDS = ("bq", "bk", "bm", "bn", "persistent", "splits")


def plan_dict(plan: Plan) -> Dict[str, object]:
    """Compact JSON form of a Plan, with the JAX package's key set:
    optional tile fields at their unused defaults are dropped."""
    d = dataclasses.asdict(plan)
    for name in _OPTIONAL_PLAN_FIELDS:
        if not d[name]:
            del d[name]
    if not d["bh"]:
        del d["bh"]
    return d


def snap_tile(dim: int, tile: int) -> int:
    """Largest divisor of ``dim`` that is <= ``tile`` (always >= 1)."""
    dim, tile = int(dim), int(tile)
    tile = max(1, min(tile, dim))
    while dim % tile:
        tile -= 1
    return tile


def _pad(n: int, m: int) -> int:
    return -(-n // m) * m


def _wbytes(cfg: RNNCellConfig) -> int:
    return 1 if cfg.precision == "int8" else 2


def tile_smem_bytes(cfg: RNNCellConfig, bh: int, *,
                    max_batch: Optional[int] = None,
                    persistent: bool = False) -> int:
    """Shared memory one CTA of the kernel claims at this tile (persistent:
    at the cluster :func:`fused_rnn.persist_geometry` picks, else at a
    lone CTA a tile).

    ``max_batch`` overrides ``cfg.batch``: the h staging and partial sums
    scale with the batch rows served together."""
    B = cfg.batch if max_batch is None else max_batch
    cs = 1
    if persistent:
        geo = fr.persist_geometry(cfg.n_gates, cfg.hidden, bh, _wbytes(cfg))
        cs = geo[0] if geo else 1
    return smem_bytes(cfg.n_gates, cfg.d, cfg.hidden, bh, B, _wbytes(cfg),
                      persistent, cs)


def coresident_ctas(smem: int, spec: hw.HardwareSpec = hw.DEFAULT) -> int:
    """Persistent CTAs of ``smem`` bytes each the whole card holds at once."""
    return fr.persist_ctas_per_sm(smem, spec) * spec.sms


def _persist_metrics(cfg: RNNCellConfig, bh: int, spec: hw.HardwareSpec,
                     B: int) -> Plan:
    """The persistent kernel at tile ``bh``: the projection once a call
    (not in the step, :func:`xproj_latency_s`), then a step of a fixed
    chain (:data:`_HANDOFF_S`), a cost a CTA of the grid, a cost a further
    CTA of a cluster, the staging of the rank's rows of h_{t-1}, and the
    resident slice read at the SM's shared-memory rate, each byte costing
    :data:`_PERSIST_BYTE` of that for its widening and products (bf16
    weights are scored alike: not measured), a pass of 8 batch rows at a
    time."""
    g, H, wb = cfg.n_gates, cfg.hidden, _wbytes(cfg)
    n_tiles = H // bh
    geo = fr.persist_geometry(g, H, bh, wb, spec)
    cs = geo[0] if geo else 1
    smem = fr.persist_smem_bytes(g, H, bh, cs, B, wb)
    ctas = cs * n_tiles
    ctas_per_sm = -(-ctas // spec.sms)
    mt = -(-g * bh // 16)
    ksr = fr.persist_ksteps(H, cs, wb)
    n_pass = -(-B // fr.PERSIST_N)
    slice_b = mt * ksr * fr.PERSIST_BLOCK
    mem_s = (n_pass * ctas_per_sm * slice_b / spec.smem_bw_per_sm
             * _PERSIST_BYTE)
    h_s = ksr * fr.persist_kstep(wb) * min(B, fr.PERSIST_N) * 2 / _PERSIST_H_BW
    overhead_s = (_HANDOFF_S + _PERSIST_CTA_S * ctas
                  + _PERSIST_CLUSTER_S * (cs - 1) + n_pass * h_s
                  + (n_pass - 1) * _PASS_S)
    util = (g * bh / (16 * mt) * min(ksr, fr.PERSIST_WARPS)
            / fr.PERSIST_WARPS * min(ctas, spec.sms) / spec.sms)
    bound = "smem" if mem_s >= overhead_s else "latency"
    return Plan(bh=bh, n_tiles=n_tiles, vmem_bytes=smem,
                resident=geo is not None, step_latency_s=overhead_s + mem_s,
                util=util, bound=bound, persistent=True)


def plan_metrics(cfg: RNNCellConfig, bh: int,
                 spec: hw.HardwareSpec = hw.DEFAULT, *,
                 max_batch: Optional[int] = None,
                 persistent: bool = False) -> Plan:
    """Score one tile choice in one kernel mode, at the served batch.
    ``resident``: the persistent grid at this tile can be held at once."""
    g, H = cfg.n_gates, cfg.hidden
    B = cfg.batch if max_batch is None else max_batch
    if persistent:
        return _persist_metrics(cfg, bh, spec, B)
    wb = _wbytes(cfg)
    n_tiles = H // bh
    resident = fr.persist_geometry(g, H, bh, wb, spec) is not None
    smem = tile_smem_bytes(cfg, bh, max_batch=B)

    n_pass = -(-B // BCH)                       # weight passes per step
    vec = stream_vec(wb)
    items = stream_k_split(g, bh, wb) * max(1, g * bh // vec)
    cs = cluster_size(g, H, bh, wb, spec.sms)
    ctas = cs * n_tiles
    ctas_per_sm = -(-ctas // spec.sms)
    rows = -(-H // cs)                          # rows of W_h a CTA reads
    cta_elems = rows * g * bh * n_pass
    # a (row, gate) chunk under a 32-byte sector costs part of the
    # sector's other half; W_h from L2 where it fits, else HBM
    chunk = bh * wb
    waste = (1 + _pad(chunk, _SECTOR) / chunk) / 2
    cta_bw = (_STEP_BW if g * H * H * wb <= spec.l2_bytes / 2
              else min(_STEP_BW, spec.hbm_bw / min(ctas, spec.sms)))
    mem_s = cta_elems * wb * waste / cta_bw
    # a weight costs a widen (byte permute + add) and an FMA, and each
    # further batch row ~5 lane-instructions (its h, FMA, predicates)
    lane_ops = spec.peak_fp32_flops / 2 / spec.sms * _STEP_ISSUE
    compute_s = cta_elems * (3 + 5 * (min(B, BCH) - 1)) / lane_ops
    # the stream and the FMAs of a CTA add up (measured: one does not
    # hide the other); a second CTA on an SM half overlaps the first
    mem_s *= 1 + (ctas_per_sm - 1) / 2
    compute_s *= 1 + (ctas_per_sm - 1) / 2
    overhead_s = _STEP_S + _CLUSTER_S * (cs - 1) + compute_s
    thread_util = items / _pad(items, THREADS)
    waves = -(-ctas // spec.sms)
    util = thread_util * ctas / (waves * spec.sms)
    slowest = max(compute_s, mem_s)
    bound = "compute" if slowest == compute_s else "hbm"
    if overhead_s > slowest:
        bound = "latency"
    return Plan(bh=bh, n_tiles=n_tiles, vmem_bytes=smem, resident=resident,
                step_latency_s=slowest + overhead_s, util=util, bound=bound,
                persistent=persistent)


def candidate_tiles(H: int) -> List[int]:
    c = []
    bh = SUBLANE
    while bh <= H:
        if H % bh == 0:
            c.append(bh)
        bh *= 2
    if H not in c and H % SUBLANE == 0:
        c.append(H)
    return c or [H]


@functools.lru_cache(maxsize=256)
def persist_candidate_tiles(n_gates: int, H: int) -> Tuple[int, ...]:
    """The persistent kernel's tiles: every divisor of H with at most
    :data:`fused_rnn.PERSIST_MAX_UNITS` outputs (its unit tiles are padded
    to 16, so the tile need not be a power of two)."""
    return tuple(bh for bh in range(1, H + 1)
                 if fr.persist_tile_ok(n_gates, H, bh))


def search(cfg: RNNCellConfig, spec: hw.HardwareSpec = hw.DEFAULT, *,
           max_batch: Optional[int] = None,
           persistent: bool = False) -> List[Plan]:
    """Scored plans of every candidate tile the kernel can run: all that
    fit a CTA's shared memory, and for ``persistent`` only resident ones."""
    if persistent:
        tiles = persist_candidate_tiles(cfg.n_gates, cfg.hidden)
    else:
        tiles = [bh for bh in candidate_tiles(cfg.hidden)
                 if stream_tile_ok(cfg.n_gates, cfg.hidden, bh,
                                   _wbytes(cfg))]
    plans = [plan_metrics(cfg, bh, spec, max_batch=max_batch,
                          persistent=persistent) for bh in tiles]
    plans = [p for p in plans if p.vmem_bytes <= hw.smem_budget(spec)]
    if persistent:
        plans = [p for p in plans if p.resident]
    return plans


def persistent_eligible(cfg: RNNCellConfig,
                        spec: hw.HardwareSpec = hw.DEFAULT, *,
                        max_batch: Optional[int] = None) -> bool:
    """Can W_h stay in the shared memory of a grid the card holds at once?"""
    return bool(search(cfg, spec, max_batch=max_batch, persistent=True))


def best_plan(cfg: RNNCellConfig, spec: hw.HardwareSpec = hw.DEFAULT, *,
              max_batch: Optional[int] = None,
              persistent: bool = False) -> Plan:
    """The modeled-fastest tile; ties go to the smaller tile (more CTAs).
    Raises when no tile can run in the asked mode."""
    plans = search(cfg, spec, max_batch=max_batch, persistent=persistent)
    if not plans:
        mode = "persistent" if persistent else "streaming"
        raise ValueError(f"no {mode} tile of {cfg} fits {spec.name}")
    return min(plans, key=lambda p: p.step_latency_s)


# ---------------------------------------------------------------------------
# Fig. 4: fragmentation of MVM-tiled vs loop-based designs
# ---------------------------------------------------------------------------


def utilization_loop(H: int, R: int, rv: int = MXU, ru: int = 1) -> float:
    """Loop-based design: 1-D fragmentation on the reduction dim only."""
    return R / _pad(R, rv * ru)


def utilization_mvm(H: int, R: int, hv: int = 400, rv: int = 40,
                    ru: int = 6) -> float:
    """Brainwave-style tiled MVM: 2-D fragmentation on H and R
    (hv/rv/ru defaults = BW's Stratix-10 configuration, Table 7)."""
    return (H / _pad(H, hv)) * (R / _pad(R, rv * ru))


def fragmentation(H: int, D: Optional[int] = None) -> dict:
    R = H + (D if D is not None else H)
    return {
        "H": H, "R": R,
        "util_loop": utilization_loop(H, R),
        "util_mvm_bw": utilization_mvm(H, R),
    }


def weight_stream_bound_s(cfg: RNNCellConfig, timesteps: int,
                          spec: hw.HardwareSpec = hw.DEFAULT) -> float:
    """Least time to read the weights once a step from device memory for
    ``timesteps`` steps: the streaming kernel's bound."""
    return cfg.weight_bytes() * timesteps / spec.hbm_bw


def wh_stream_bound_s(cfg: RNNCellConfig, timesteps: int,
                      spec: hw.HardwareSpec = hw.DEFAULT) -> float:
    """Least time to read W_h alone once a step from device memory for
    ``timesteps`` steps: what the streaming step kernel reads, the input
    half having been projected beforehand."""
    return cfg.n_gates * cfg.hidden ** 2 * _wbytes(cfg) * timesteps / spec.hbm_bw


def xproj_plan_metrics(M: int, N: int, K: int, bm: int, splits: int,
                       spec: hw.HardwareSpec = hw.DEFAULT) -> Plan:
    """Score the streaming projection's int8 ``wgmma`` kernel at one tile:
    bm rows of M and 128 columns a CTA, ``splits`` K splits in a cluster.
    As :func:`_prefill_plan_metrics` (the same mainloop): a K step is the
    tensor work at the SM's share of the bf16 peak or its shared-memory
    traffic, plus a fixed cost; a CTA walks its split's steps, fills its
    ring and stores its tile (the splits summed in order over the
    cluster), in waves of the CTAs the SMs hold; the weight streamed once
    per row tile and x once per column tile from L2; each read once and
    the f32 output written once in device memory."""
    ntm, ntn, nk = -(-M // bm), -(-N // fr.XPROJ_BN), fr.xproj_k_steps(K)
    bn, bk = fr.XPROJ_BN, fr.XPROJ_BK
    n_ctas = ntm * ntn * splits
    smem = fr.xproj_smem_bytes(bm)
    resident = smem <= hw.smem_budget(spec)
    regs = min(255, bm // 2 + 16 + 24)         # accumulators, A fragments
    per_sm = _ctas_per_sm(spec, smem, regs, -(-fr.XPROJ_THREADS // 128) * 128)
    slots = per_sm * spec.sms
    waves = -(-n_ctas // slots)
    steps = -(-nk // splits)
    share = min(per_sm, -(-n_ctas // spec.sms))
    tensor_s = 2.0 * bm * bn * bk / (spec.peak_bf16_flops / spec.sms)
    smem_step = bm * bk * 2 + bk * bn + bk * bn + (bn // 64) * bm * bk * 2
    smem_s = smem_step / spec.smem_bw_per_sm
    step_s = share * (max(tensor_s, smem_s) + _XPROJ_STEP_S)
    tile_s = (steps * step_s + _XPROJ_TILE_S
              + (splits - 1) * _XPROJ_SPLIT_S * bm / 64)
    compute_s = waves * tile_s
    l2_s = (ntm * K * N + ntn * M * K * 2) / _MM_L2_BW
    hbm_s = (K * N + M * K * 2 + 2 * N * 4 + M * N * 4) / spec.hbm_bw
    slowest = max(compute_s, l2_s, hbm_s)
    bound = ("compute" if slowest == compute_s else
             "l2" if slowest == l2_s else "hbm")
    util = M * N * K / (ntm * bm * ntn * bn * nk * bk) * min(
        1.0, n_ctas / (waves * slots))
    return Plan(bh=0, n_tiles=n_ctas, vmem_bytes=smem, resident=resident,
                step_latency_s=_LAUNCH_S + slowest, util=util, bound=bound,
                bk=bk, bm=bm, bn=bn, splits=splits)


def xproj_latency_s(cfg: RNNCellConfig, timesteps: int,
                    spec: hw.HardwareSpec = hw.DEFAULT, *,
                    max_batch: Optional[int] = None) -> float:
    """Modeled time of the streaming call's input projection (M = T*B,
    N = G*H, K = D) at the tile the kernel runs there
    (:func:`fused_rnn.xproj_tile`; bf16 weights are scored alike)."""
    B = cfg.batch if max_batch is None else max_batch
    M, N, K = timesteps * B, cfg.n_gates * cfg.hidden, cfg.d
    bm, splits = fr.xproj_tile(M, N, K, spec.sms)
    return xproj_plan_metrics(M, N, K, bm, splits, spec).step_latency_s


def handoff_bound_s(timesteps: int) -> float:
    """The persistent kernel's floor: one modeled hand-off a step."""
    return _HANDOFF_S * timesteps



# ---------------------------------------------------------------------------
# flash_attention tile search (bq x bk)
# ---------------------------------------------------------------------------


def candidate_attn_tiles(seq_q: int, seq_kv: int) -> List[Tuple[int, int]]:
    """(bq, bk) grid: power-of-two divisors, bq from the sublane count up,
    bk from one lane row (128) up (the JAX package's candidates)."""
    bqs = [t for t in (8, 16, 32, 64, 128, 256)
           if t <= seq_q and seq_q % t == 0] or [snap_tile(seq_q, 256)]
    bks = [t for t in (128, 256, 512, 1024)
           if t <= seq_kv and seq_kv % t == 0] or [snap_tile(seq_kv, 512)]
    return [(bq, bk) for bq in bqs for bk in bks]


def attn_kernel_tiles(seq_q: int, seq_kv: int) -> List[Tuple[int, int]]:
    """The tiles the CUDA kernel runs at these lengths, smallest first:
    bq in {64, 128} and bk in {64, 128}, each clamped to the lengths by
    ``flash_attention.kernel_tiles`` (a ragged last tile is
    bounds-checked)."""
    tiles = []
    for bq in (fa.WG_ROWS, fa.MAX_BQ):
        for bk in (fa.SUB, fa.MAX_BK):
            t = fa.kernel_tiles(bq, bk, seq_q, seq_kv)
            if t not in tiles:
                tiles.append(t)
    return tiles


def attn_tile_counts(seq_q: int, seq_kv: int, bq: int,
                     causal: bool = True) -> List[List[int]]:
    """For each query tile of bq rows, the 64-key tiles each of its
    warpgroups computes (iota positions; under a causal mask, up to the
    warpgroup's last row)."""
    nkt = -(-seq_kv // fa.SUB)
    counts = []
    for q0 in range(0, seq_q, bq):
        wg = []
        for r0 in range(q0, q0 + bq, fa.WG_ROWS):
            last = min(r0 + fa.WG_ROWS, seq_q) - 1
            wg.append(0 if r0 >= seq_q else
                      min(nkt, last // fa.SUB + 1) if causal else nkt)
        counts.append(wg)
    return counts


def attn_plan_metrics(seq_q: int, seq_kv: int, head_dim: int,
                      bq: int, bk: int,
                      spec: hw.HardwareSpec = hw.DEFAULT, *,
                      n_heads: int = 1, batch: int = 1,
                      causal: bool = True) -> Plan:
    """Score one flash_attention tile choice."""
    counts = attn_tile_counts(seq_q, seq_kv, bq, causal)
    n_ctas = batch * n_heads * len(counts)
    smem = fa.smem_bytes(bq, bk, head_dim)
    resident = smem <= hw.smem_budget(spec)
    threads = 128 * (bq // fa.WG_ROWS) + 32
    per_sm = _ctas_per_sm(spec, smem, _ATTN_REGS, -(-threads // 32) * 32)
    slots = per_sm * spec.sms

    # one CTA: its prologue and epilogue, a hand-off a stage, and its
    # warpgroups' tiles side by side (a warpgroup's step is mostly its
    # softmax, slower where two warpgroups share the SM's issue slots)
    tile_s = 4.0 * fa.SUB * fa.WG_ROWS * head_dim / (
        spec.peak_bf16_flops / spec.sms)
    step_s = (_ATTN_SUB_S if per_sm * (bq // fa.WG_ROWS) >= 2
              else _ATTN_SUB_ALONE_S)
    cta_s = [_ATTN_CTA_S + -(-max(wg) * fa.SUB // bk) * _ATTN_TILE_S
             + max(wg) * step_s for wg in counts]
    tiles = batch * n_heads * sum(map(sum, counts))
    work_s = batch * n_heads * sum(cta_s) / slots
    compute_s = tiles * tile_s / spec.sms
    # q, out, k and v once each per query head (GQA heads share K and V:
    # an upper bound)
    hbm_s = (2 * batch * n_heads * seq_q * head_dim * 2
             + 2 * batch * n_heads * seq_kv * head_dim * 2) / spec.hbm_bw
    slowest = max(work_s, max(cta_s), compute_s, hbm_s)
    bound = ("hbm" if slowest == hbm_s else
             "compute" if slowest == compute_s else "latency")
    pairs = (sum(min(seq_kv, q + 1) for q in range(seq_q)) if causal
             else seq_q * seq_kv)
    util = pairs / (sum(map(sum, counts)) * fa.SUB * fa.WG_ROWS) * min(
        1.0, n_ctas / slots)
    return Plan(bh=0, n_tiles=n_ctas, vmem_bytes=smem, resident=resident,
                step_latency_s=_LAUNCH_S + _ATTN_MEAN_S + slowest, util=util,
                bound=bound, bq=bq, bk=bk)


def attn_search(seq_q: int, seq_kv: int, head_dim: int,
                spec: hw.HardwareSpec = hw.DEFAULT, *, n_heads: int = 1,
                batch: int = 1) -> List[Plan]:
    """Scored plans of every kernel tile that fits a CTA's shared memory."""
    plans = [attn_plan_metrics(seq_q, seq_kv, head_dim, bq, bk, spec,
                               n_heads=n_heads, batch=batch)
             for bq, bk in attn_kernel_tiles(seq_q, seq_kv)]
    return [p for p in plans if p.resident]


def best_attn_plan(seq_q: int, seq_kv: int, head_dim: int,
                   spec: hw.HardwareSpec = hw.DEFAULT, *,
                   n_heads: int = 1, batch: int = 1) -> Plan:
    """The modeled-fastest kernel tile; ties go to the first (smaller)
    candidate.  Raises when none fits."""
    plans = attn_search(seq_q, seq_kv, head_dim, spec, n_heads=n_heads,
                        batch=batch)
    if not plans:
        raise ValueError(f"no flash_attention tile for ({seq_q}, {seq_kv}, "
                         f"{head_dim}) fits {spec.name}")
    return min(plans, key=lambda p: p.step_latency_s)


# ---------------------------------------------------------------------------
# matmul_w8a16 tile search (bm x bn x bk)
# ---------------------------------------------------------------------------


def candidate_mm_tiles(M: int, N: int, K: int) -> List[Tuple[int, int, int]]:
    """The JAX package's (bm, bn, bk) grid, unchanged."""
    bms = [t for t in (8, 32, 64, 128, 256)
           if t <= M and M % t == 0] or [snap_tile(M, 256)]
    bns = [t for t in (128, 256, 512)
           if t <= N and N % t == 0] or [snap_tile(N, 256)]
    bks = [t for t in (128, 256, 512)
           if t <= K and K % t == 0] or [snap_tile(K, 512)]
    return [(bm, bn, bk) for bm in bms for bn in bns for bk in bks]


def mm_kernel_tiles(M: int, N: int, K: int) -> List[Tuple[int, int, int, int]]:
    """The geometries the CUDA kernel runs at this shape, smallest first,
    as (bm, bn, bk, splits).  M <= 16: the decode kernel's (bm, 128, 64)
    with every S from 1 to the K steps.  Above: the prefill kernel's bm
    and bn sets at its one bk, each clamped to the shape by
    ``matmul_int8.kernel_tiles`` (a ragged last tile is bounds-checked,
    so nothing has to divide), with splits 1."""
    if M <= mm.DECODE_M:
        bm = mm.decode_bm(M)
        return [(bm, mm.DECODE_BN, mm.DECODE_KSTEP, s)
                for s in range(1, mm.k_steps(K) + 1)]
    tiles = []
    for bm in mm.BMS:
        for bn in mm.BNS:
            t = mm.kernel_tiles(bm, bn, mm.BK, M, N, K) + (1,)
            if t not in tiles:
                tiles.append(t)
    return tiles


def matmul_tile_vmem_bytes(bm: int, bn: int, bk: int,
                           decode: bool = False) -> int:
    """Shared memory one CTA of ``matmul_w8a16`` claims at this tile (the
    JAX package's VMEM working set becomes per-CTA shared memory): the
    ring of x and int8 w steps and the ring of widened bf16 B tiles;
    ``decode``: the decode kernel's ring of x and int8 w steps (bm rows
    of M)."""
    return mm.decode_smem_bytes(bm) if decode else mm.smem_bytes(bm, bn, bk)


def _ctas_per_sm(spec: hw.HardwareSpec, smem: int, regs: int,
                 threads: int = _MM_THREADS) -> int:
    return max(1, min(spec.smem_per_sm // (smem + _SMEM_RESERVED),
                      spec.max_threads_per_sm // threads,
                      spec.regs_per_sm // (threads * regs)))


def _decode_plan_metrics(M: int, N: int, K: int, splits: int,
                         spec: hw.HardwareSpec) -> Plan:
    geo = mm.decode_geometry(M, N, K, splits, spec.sms)
    smem = matmul_tile_vmem_bytes(geo.bm, geo.bn, geo.kstep, decode=True)
    resident = smem <= hw.smem_budget(spec)
    slots = _ctas_per_sm(spec, smem, 8 * geo.bm // 2 + 64) * spec.sms
    n_ctas = geo.ctas
    waves = -(-n_ctas // slots)
    sm_share = min(n_ctas, spec.sms) / spec.sms
    padded_macs = geo.bm * geo.strips * geo.bn * K
    util = M * N * K / padded_macs * sm_share
    compute_s = 2.0 * padded_macs / (spec.peak_bf16_flops * sm_share)
    stage = geo.kstep * geo.bn
    in_flight = min(n_ctas, slots) * (mm.DECODE_STAGES - 1) * stage
    # a CTA's ring refills only after its step barrier: the card's rate
    # needs CTAS_PER_SM CTAs an SM, so that one streams while another waits
    fill = min(1.0, n_ctas / (mm.CTAS_PER_SM * spec.sms))
    rate = min(spec.hbm_bw * fill, in_flight / _MM_LATENCY_S)
    hbm_s = (K * N + geo.strips * M * K * 2 + M * N * 2) / rate
    issue_s = waves * geo.steps_per_cta * _MM_STEP_S
    reduce_s = 0.0
    if geo.splits > 1:   # the partials written, then read by a second launch
        reduce_s = _MM_FILL_S + 2 * geo.splits * M * N * 4 / spec.hbm_bw
    slowest = max(compute_s, hbm_s, issue_s)
    bound = ("hbm" if slowest == hbm_s else
             "compute" if slowest == compute_s else "latency")
    return Plan(bh=0, n_tiles=n_ctas, vmem_bytes=smem, resident=resident,
                step_latency_s=_LAUNCH_S + _MM_FILL_S + slowest + reduce_s,
                util=util, bound=bound, bk=geo.kstep, bm=geo.bm, bn=geo.bn,
                splits=geo.splits)


def _prefill_plan_metrics(M: int, N: int, K: int, bm: int, bn: int,
                          bk: int, spec: hw.HardwareSpec) -> Plan:
    ntm, ntn, nk = -(-M // bm), -(-N // bn), -(-K // bk)
    n_ctas = ntm * ntn
    smem = matmul_tile_vmem_bytes(bm, bn, bk)
    resident = smem <= hw.smem_budget(spec)
    regs = min(255, bm // 2 + 16 + 24)         # accumulators, A fragments
    # registers go to whole warpgroups: the card refused a 288-thread CTA
    # at 200 a thread, which 9 warps alone would have held
    per_sm = _ctas_per_sm(spec, smem, regs, -(-mm.PREFILL_THREADS // 128) * 128)
    slots = per_sm * spec.sms
    waves = -(-n_ctas // slots)
    sm_share = n_ctas / (waves * slots)
    padded_macs = ntm * bm * ntn * bn * nk * bk
    util = M * N * K / padded_macs * sm_share

    # one K step of one CTA: wgmma at the SM's share of the bf16 peak, or
    # the step's shared-memory traffic if longer (the TMA writes of x and
    # int8 w, the fragment loads of w, x read once by each math warpgroup
    # as wgmma's B), plus a fixed cost a step.  The CTAs an SM runs at once
    # share it.
    share = min(per_sm, -(-n_ctas // spec.sms))
    tensor_s = 2.0 * bm * bn * bk / (spec.peak_bf16_flops / spec.sms)
    smem_step = (bm * bk * 2 + bk * bn + bk * bn
                 + (bn // 64) * bm * bk * 2)
    smem_s = smem_step / spec.smem_bw_per_sm
    step_s = share * (max(tensor_s, smem_s) + _MM_PRE_STEP_S)
    compute_s = waves * (nk * step_s + _MM_TILE_S)
    # the weight once per row tile and x once per column tile from L2;
    # each read once from device memory, the output written once
    l2_s = (ntm * K * N + ntn * M * K * 2) / _MM_L2_BW
    hbm_s = (K * N + M * K * 2 + N * 4 + M * N * 2) / spec.hbm_bw
    slowest = max(compute_s, l2_s, hbm_s)
    bound = ("compute" if slowest == compute_s else
             "l2" if slowest == l2_s else "hbm")
    return Plan(bh=0, n_tiles=n_ctas, vmem_bytes=smem, resident=resident,
                step_latency_s=_LAUNCH_S + slowest, util=util, bound=bound,
                bk=bk, bm=bm, bn=bn)


def matmul_plan_metrics(M: int, N: int, K: int,
                        bm: int, bn: int, bk: int, splits: int = 1,
                        spec: hw.HardwareSpec = hw.DEFAULT) -> Plan:
    """Score one W8A16 matmul geometry.  The kernel widens int8 weights to
    bf16 before the tensor-core product, so compute runs at the bf16
    peak; the gain of int8 is the halved weight stream.  M <= 16 scores
    the decode kernel at ``splits`` (its bm, bn, bk are fixed), above the
    prefill kernel at (bm, bn, bk)."""
    if M <= mm.DECODE_M:
        return _decode_plan_metrics(M, N, K, splits, spec)
    return _prefill_plan_metrics(M, N, K, bm, bn, bk, spec)


def matmul_search(M: int, N: int, K: int,
                  spec: hw.HardwareSpec = hw.DEFAULT) -> List[Plan]:
    """Scored plans of every kernel tile that fits a CTA's shared memory."""
    plans = [matmul_plan_metrics(M, N, K, *t, spec=spec)
             for t in mm_kernel_tiles(M, N, K)]
    return [p for p in plans if p.resident]


def best_matmul_plan(M: int, N: int, K: int,
                     spec: hw.HardwareSpec = hw.DEFAULT) -> Plan:
    """The modeled-fastest kernel tile; ties go to the first (smaller)
    candidate.  Raises when none fits."""
    plans = matmul_search(M, N, K, spec)
    if not plans:
        raise ValueError(f"no matmul_w8a16 tile for ({M}, {N}, {K}) fits "
                         f"{spec.name}")
    return min(plans, key=lambda p: p.step_latency_s)
