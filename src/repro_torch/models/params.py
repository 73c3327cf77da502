"""Parameter specs and trees of nested dicts (port of
``repro.models.params``).

A model describes its parameters as a nested dict of :class:`ParamSpec`
(shape, dtype, initializer).  ``tree_init`` draws every leaf from an
explicit ``torch.Generator`` with the JAX package's distributions:
truncated normal at +-3 sigma scaled by 1/sqrt(fan-in) unless a scale is
given, zeros, ones, or a custom function (the kinds the rwkv and
attention paths use).  A ``by_layer`` leaf (the MoE leaves) is drawn one
slice of its leading (layer) axis at a time, so its f32 temporary is one
slice.  The generator gives
other numbers than ``jax.random`` from the same seed, so parity tests
carry the JAX parameters across with :func:`tree_from_numpy`.

Trees are plain nested dicts; :func:`tree_map` and :func:`tree_leaves`
walk them in insertion order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.dispatch import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"        # normal | zeros | ones | custom
    scale: Optional[float] = None
    custom_init: Optional[Callable[["ParamSpec", torch.device],
                                   torch.Tensor]] = None
    by_layer: bool = False      # stacked: draw one leading slice at a time

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def nbytes(self) -> int:
        return self.size * self.dtype.itemsize

    def initialize(self, gen: torch.Generator, device,
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The leaf, drawn from ``gen`` and stored in ``dtype`` (default
        the spec's).  A ``by_layer`` leaf draws each slice of its leading
        axis in turn and casts it into place: the same bits as drawing
        that slice alone, with one slice's f32 copy alive."""
        if self.by_layer and self.init == "normal" and self.shape:
            one = dataclasses.replace(self, shape=self.shape[1:],
                                      by_layer=False)
            out = torch.empty(self.shape, dtype=dtype or self.dtype,
                              device=device)
            for i in range(self.shape[0]):
                out[i].copy_(one.initialize(gen, device))
            return out
        leaf = self._draw(gen, device)
        return leaf if dtype is None else leaf.to(dtype)

    def _draw(self, gen: torch.Generator, device) -> torch.Tensor:
        if self.custom_init is not None:
            return self.custom_init(self, device)
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        x = torch.empty(self.shape, dtype=torch.float32, device=device)
        if self.scale is not None:
            std = self.scale
        else:
            fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
            std = 1.0 / math.sqrt(max(1, fan_in))
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -3.0, 3.0, generator=gen)
        return x.mul_(std).to(self.dtype)      # in place: no second f32 copy


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to corresponding leaves of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_map_named(fn, tree, name: str = ""):
    """Apply ``fn(leaf_name, leaf)`` to every leaf; the name is the key the
    leaf sits under in its innermost dict."""
    if isinstance(tree, dict):
        return {k: tree_map_named(fn, v, k) for k, v in tree.items()}
    return fn(name, tree)


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_init(specs, gen: torch.Generator, device=None) -> Dict[str, Any]:
    """Initialize every leaf, in tree order, from ``gen``.  ``device``
    defaults to the current CUDA device (raises without one unless
    ``device="cpu"`` is given); ``gen`` must live on that device."""
    dev = resolve_device(device)
    return tree_map(lambda s: s.initialize(gen, dev), specs)


def tree_size(specs) -> int:
    return sum(s.size for s in tree_leaves(specs))


def stack_specs(spec: ParamSpec, n: int) -> ParamSpec:
    """Prepend a stacking dimension (layer-stacked parameters)."""
    return dataclasses.replace(spec, shape=(n,) + tuple(spec.shape))


def tree_stack_specs(specs, n: int):
    return tree_map(lambda s: stack_specs(s, n), specs)


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes, as JAX hands it out
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def tree_from_numpy(tree, device=None):
    """A tree of numpy arrays (e.g. JAX parameters or caches passed
    through ``np.asarray``) as torch tensors on ``device``, dtypes kept
    (bfloat16 included).  ``device`` defaults as in :func:`tree_init`."""
    dev = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a).to(dev), tree)


__all__ = ["ParamSpec", "tree_map", "tree_map_named", "tree_leaves",
           "tree_init", "tree_size", "stack_specs", "tree_stack_specs",
           "tree_from_numpy"]
