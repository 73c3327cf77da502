"""Plan-driven kernel dispatch (port of ``repro.kernels.dispatch``).

A ``tile_plans`` entry may carry an ``impl`` field:

  * ``"auto"`` (default) — the hand-written kernel on a CUDA device, the
    plain PyTorch version on the CPU;
  * ``"plain"`` — force the plain PyTorch version;
  * ``"kernel"`` — force the kernel.  Its wrapper runs the plain version
    only for tensors that lie on the CPU; on a CUDA tensor it launches
    the kernel or raises.

The JAX package's names ``"jnp"`` and ``"pallas"`` are aliases for
``"plain"`` and ``"kernel"``, so a JAX plan entry means the same here.
There is no interpret mode: a CUDA kernel runs only on the card.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

VALID_IMPLS = ("auto", "plain", "kernel", "jnp", "pallas")
_ALIASES = {"jnp": "plain", "pallas": "kernel"}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    current CUDA device.  Without a GPU and without an explicit device
    this raises; nothing carries on silently on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' explicitly to run the plain "
            "PyTorch versions on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_impl(entry: Optional[Mapping[str, object]],
                 device) -> str:
    """Collapse a tile-plan entry's ``impl`` field to "plain" | "kernel"."""
    impl = str((entry or {}).get("impl", "auto"))
    if impl not in VALID_IMPLS:
        raise ValueError(f"tile plan impl {impl!r} not in {VALID_IMPLS}")
    impl = _ALIASES.get(impl, impl)
    if impl == "auto":
        return "kernel" if torch.device(device).type == "cuda" else "plain"
    return impl


def tile_arg(entry: Optional[Mapping[str, object]], name: str,
             default: int) -> int:
    """Read one tile field from a plan entry, falling back to the
    kernel's documented default when absent or zero."""
    val = int((entry or {}).get(name, 0) or 0)
    return val if val > 0 else default


__all__ = ["VALID_IMPLS", "resolve_device", "resolve_impl", "tile_arg"]
