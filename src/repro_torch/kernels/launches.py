"""The port's kernel launch counters, in one registry.

Each kernel module keeps a ``LAUNCHES`` dict of counters and registers it
here (:func:`register`) with, for each counter, the device functions whose
launches it counts (fragments of their names).  A wrapper adds one to its
counter where it launches its kernel, and nowhere else.

A CUDA graph launches kernels without their wrappers.  Where the port
launches one (the engine's decode chunk), it reads the kernel nodes the
graph holds (their device functions' names, from the graph itself),
turns them into counts with :func:`by_counter` and adds those, times the
number of times the device ran them, at that launch (:func:`add`).
Counters whose module gave no device function names (the RNN cells') are
not counted in a graph: a tick that launched one at capture makes
:func:`by_counter` disagree with the wrappers' own count, and the capture
raises.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

_REGISTRY: List[Tuple[Dict[str, int], Dict[str, Tuple[str, ...]]]] = []


def register(launches: Dict[str, int],
             kernels: Dict[str, Sequence[str]]) -> Dict[str, int]:
    """Register a module's counters; ``kernels`` maps a counter to the
    name fragments of the device functions one of its launches runs (a
    kernel node whose function's name holds one counts once).  Returns
    ``launches``.  A module imported again replaces its entry."""
    if set(kernels) - set(launches):
        raise ValueError(f"device functions for unknown counters: "
                         f"{sorted(set(kernels) - set(launches))}")
    _REGISTRY[:] = [e for e in _REGISTRY if not set(e[0]) & set(launches)]
    _REGISTRY.append((launches, {k: tuple(v) for k, v in kernels.items()}))
    return launches


def counters() -> Dict[str, int]:
    """Every registered counter's value, by name."""
    return {key: n for c, _ in _REGISTRY for key, n in c.items()}


def restore(snap: Dict[str, int]) -> None:
    """Set every counter in ``snap`` (from :func:`counters`) back."""
    for c, _ in _REGISTRY:
        for key in c:
            if key in snap:
                c[key] = snap[key]


def since(snap: Dict[str, int]) -> Dict[str, int]:
    """The counters that grew since ``snap``, by how much."""
    return {key: n - snap.get(key, 0) for key, n in counters().items()
            if n != snap.get(key, 0)}


def by_counter(names: Iterable[str]) -> Dict[str, int]:
    """Kernel launches by counter for kernel nodes running the device
    functions ``names`` (one name a node); counters with none are left
    out."""
    out: Dict[str, int] = {}
    for name in names:
        for _, kernels in _REGISTRY:
            for key, frags in kernels.items():
                if any(f in name for f in frags):
                    out[key] = out.get(key, 0) + 1
    return out


def add(counts: Dict[str, int], times: int = 1) -> None:
    """Add ``counts`` (from :func:`by_counter`) ``times`` over."""
    for c, _ in _REGISTRY:
        for key in c:
            if key in counts:
                c[key] += counts[key] * times


__all__ = ["register", "counters", "restore", "since", "by_counter", "add"]
