"""Hardware model of the port's target: one NVIDIA H100.

All DSE cost models in :mod:`repro_torch.core.dse` read their constants
from here.  ``H100_SXM`` holds NVIDIA's data-sheet figures (SXM part,
dense rates); :func:`from_device` replaces the capacities that differ
between H100 parts (SM count, shared memory, HBM size) with what
``torch.cuda.get_device_properties`` reports, since the card may be a
PCIe H100 (114 SMs, ~2.0 TB/s) rather than an SXM.

The JAX package's VMEM budget becomes a shared-memory budget per CTA:
a CTA is the unit that owns an H tile (``bh`` units) of the recurrent
cell, and its weight slice must fit that CTA's shared memory for the
weights to stay on chip across time steps.

``dcn_bw`` and the roofline helpers ``matmul_time``/``hbm_time`` feed the
serving tier's transit model (:mod:`repro_torch.serving.router`,
:func:`repro_torch.plan.planner.modeled_tick_seconds`); ``SPECS`` names
the specs a ``FleetPlan`` may cite.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """One GPU: compute peaks, memory hierarchy, SM resources."""

    name: str
    # --- compute ---------------------------------------------------------
    peak_bf16_flops: float      # FLOP/s, tensor cores, dense
    peak_int8_ops: float        # OP/s, tensor cores, dense
    peak_fp32_flops: float      # FLOP/s, CUDA-core FMA (the RNN kernels' path)
    # --- memory ----------------------------------------------------------
    hbm_bytes: float            # device memory capacity
    hbm_bw: float               # bytes/s device memory
    l2_bytes: float             # L2 cache capacity
    # --- streaming multiprocessors ---------------------------------------
    sms: int                    # SM count
    smem_per_block_optin: int   # max dynamic shared memory one CTA can opt in to
    smem_per_sm: int            # shared memory per SM (all resident CTAs)
    smem_bw_per_sm: float       # bytes/s shared memory -> registers, one SM
    # --- interconnect ----------------------------------------------------
    dcn_bw: float               # bytes/s per card to other replicas' cards
    # --- streaming multiprocessors, with defaults ------------------------
    regs_per_sm: int = 65536    # 32-bit registers per SM
    max_threads_per_sm: int = 2048

    def matmul_time(self, flops: float, dtype_bits: int = 16) -> float:
        """Roofline tensor-core time for ``flops`` at the given precision."""
        peak = self.peak_int8_ops if dtype_bits <= 8 else self.peak_bf16_flops
        return flops / peak

    def hbm_time(self, nbytes: float) -> float:
        return nbytes / self.hbm_bw


# NVIDIA H100 SXM5 80 GB data sheet + Hopper tuning guide: 132 SMs,
# 227 KB opt-in shared memory per block out of 228 KB per SM, 50 MB L2,
# 3.35 TB/s HBM3, 989 TFLOP/s bf16, 1979 TOP/s int8, 67 TFLOP/s fp32.
# Shared memory moves 128 B/clk/SM; at the 1.98 GHz boost clock that is
# ~253 GB/s per SM.  ``dcn_bw`` is a modeled figure, not a measurement:
# one 400 Gb/s ConnectX-7 NIC per GPU, as the DGX H100 data sheet gives
# it (50 GB/s), the rate the router charges a hand-off between replicas
# on different hosts.
H100_SXM = HardwareSpec(
    name="h100-sxm",
    peak_bf16_flops=989e12,
    peak_int8_ops=1979e12,
    peak_fp32_flops=67e12,
    hbm_bytes=80e9,
    hbm_bw=3.35e12,
    l2_bytes=50 * 2**20,
    sms=132,
    smem_per_block_optin=232448,
    smem_per_sm=233472,
    smem_bw_per_sm=128 * 1.98e9,
    dcn_bw=50e9,
)

DEFAULT = H100_SXM

# name -> spec, for plan provenance (``FleetPlan.hw``)
SPECS = {spec.name: spec for spec in (H100_SXM,)}


def get_spec(name: str) -> HardwareSpec:
    if name not in SPECS:
        raise KeyError(f"unknown hardware spec {name!r}; "
                       f"known: {sorted(SPECS)}")
    return SPECS[name]


def from_device(device=None) -> HardwareSpec:
    """``DEFAULT`` with the SM count, shared-memory sizes, L2 and HBM size
    read from the CUDA device.  Peak rates and bandwidth stay the data
    sheet's: the CUDA runtime does not report them."""
    import torch

    base = DEFAULT
    p = torch.cuda.get_device_properties(device)
    optin = getattr(p, "shared_memory_per_block_optin",
                    base.smem_per_block_optin)
    per_sm = getattr(p, "shared_memory_per_multiprocessor", base.smem_per_sm)
    return dataclasses.replace(
        base, name=p.name, sms=p.multi_processor_count,
        smem_per_block_optin=int(optin), smem_per_sm=int(per_sm),
        hbm_bytes=float(p.total_memory),
        l2_bytes=float(getattr(p, "L2_cache_size", base.l2_bytes)),
        regs_per_sm=int(getattr(p, "regs_per_multiprocessor",
                                base.regs_per_sm)),
        max_threads_per_sm=int(getattr(p, "max_threads_per_multi_processor",
                                       base.max_threads_per_sm)))


def smem_budget(hw: HardwareSpec = DEFAULT) -> int:
    """Shared memory one CTA may hold (the opt-in maximum)."""
    return int(hw.smem_per_block_optin)
