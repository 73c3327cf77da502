"""Checkpointing (port of ``repro.checkpoint.manager``): atomic,
async-capable, with retention, on the JAX package's on-disk format.

* **Atomicity**: a checkpoint is written into ``step_<k>.tmp`` and
  renamed to ``step_<k>`` only after every leaf and the manifest are on
  disk; a crash mid-save never corrupts the latest step.
* **Format**: one ``.npy`` a leaf and a ``manifest.json`` with ``step``,
  ``leaves`` and ``extra``.  A tree is nested dicts of torch tensors or
  numpy arrays, flattened as JAX flattens a dict (sorted keys); a leaf's
  file name is its ``jax.tree_util.keystr`` path, sanitised, so either
  package restores the other's files.  numpy has no
  bfloat16: a bf16 tensor is written as raw 2-byte records (``V2``), as
  the JAX manager writes its extension dtypes, and bit-viewed back on
  restore, never cast through float32.
* **Async**: ``save(..., blocking=False)`` copies the tree to host memory
  and writes it on a thread; :meth:`CheckpointManager.wait` joins it.
* **Retention**: keeps the newest ``keep`` steps.

One device: :meth:`CheckpointManager.restore` puts each leaf on its
target leaf's device, and there is no ``shardings`` argument.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_BF16_RECORD = np.dtype("V2")


def _flatten(tree, path: str = "") -> List[Tuple[str, Any]]:
    """(keystr path, leaf) of a nested dict in JAX's order (keys sorted)."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _flatten(tree[k], f"{path}[{k!r}]")]
    return [(path, tree)]


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves replaced, in :func:`_flatten`'s
    order, from the iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def _leaf_name(path: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", path).strip("_")


def _to_numpy(x) -> np.ndarray:
    """A host copy of a leaf; bf16 as raw 2-byte records."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_RECORD)
        return t.numpy()
    return np.array(x, copy=True)


def _numpy_dtype(t: torch.Tensor) -> Optional[np.dtype]:
    return None if t.dtype == torch.bfloat16 else \
        torch.empty((), dtype=t.dtype).numpy().dtype


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -------------------------------------------------------------- save
    def save(self, step: int, state: Any, extra: Optional[Dict] = None,
             blocking: bool = True) -> None:
        self.wait()   # one save in flight at a time
        host = [(_leaf_name(path), _to_numpy(x))
                for path, x in _flatten(state)]

        def _write():
            final = os.path.join(self.directory, f"step_{step:010d}")
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            for name, arr in host:
                np.save(os.path.join(tmp, name + ".npy"), arr)
            manifest = {"step": step, "leaves": [n for n, _ in host],
                        "extra": extra or {}}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)

    # ----------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _validate_step(self, step: int, need_names=None) -> str:
        """Check a step before any leaf is loaded: its directory, its
        manifest and every leaf file the manifest (and the caller's target
        tree) names must exist, or one ``FileNotFoundError`` lists all
        that is absent."""
        d = os.path.join(self.directory, f"step_{step:010d}")
        if not os.path.isdir(d):
            have = self.all_steps()
            raise FileNotFoundError(
                f"checkpoint step {step} not found under {self.directory}"
                + (f"; available steps: {have}" if have
                   else "; no steps saved yet"))
        mpath = os.path.join(d, "manifest.json")
        if not os.path.exists(mpath):
            raise FileNotFoundError(
                f"checkpoint step {step} at {d} has no manifest.json — "
                f"the save was interrupted before the atomic rename; "
                f"delete the directory and restore an older step")
        with open(mpath) as f:
            manifest = json.load(f)
        declared = list(manifest.get("leaves", []))
        missing = [n for n in declared
                   if not os.path.exists(os.path.join(d, n + ".npy"))]
        extra_needed = [n for n in (need_names or []) if n not in declared]
        problems = []
        if missing:
            problems.append(f"manifest-declared leaf files missing on "
                            f"disk: {missing}")
        if extra_needed:
            problems.append(f"target structure needs leaves the manifest "
                            f"never saved: {extra_needed}")
        if problems:
            raise FileNotFoundError(
                f"checkpoint step {step} at {d} is incomplete: "
                + "; ".join(problems))
        return d

    @staticmethod
    def _load_leaf(path: str, like):
        """The file at ``path`` as ``like`` is: a tensor of its dtype on its
        device, or a numpy array of its dtype."""
        arr = np.load(path)
        if not isinstance(like, torch.Tensor):
            want = np.asarray(like).dtype
            return arr if arr.dtype == want else arr.astype(want)
        want = _numpy_dtype(like)
        if want is None:                       # bf16: a bit-view, never a cast
            if arr.dtype.itemsize != 2 or arr.dtype.kind not in "Vui":
                raise ValueError(f"{path}: {arr.dtype} cannot hold bfloat16")
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
            t = t.view(torch.bfloat16)
        else:
            if arr.dtype != want:
                arr = arr.astype(want)
            t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.to(like.device)

    def restore(self, state_like: Any, step: Optional[int] = None) -> Any:
        """Restore into the structure of ``state_like`` (a tree of tensors
        or numpy arrays): each leaf comes back with its target's dtype, on
        its target's device.  The step (latest when None) is validated up
        front, so a partial checkpoint fails with one error naming what
        is absent, before any leaf is loaded."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        leaves = _flatten(state_like)
        d = self._validate_step(step, need_names=[_leaf_name(p)
                                                  for p, _ in leaves])
        out = [self._load_leaf(os.path.join(d, _leaf_name(p) + ".npy"), like)
               for p, like in leaves]
        return _unflatten(state_like, iter(out))

    def manifest(self, step: int) -> Dict:
        d = self._validate_step(step)
        with open(os.path.join(d, "manifest.json")) as f:
            return json.load(f)


__all__ = ["CheckpointManager"]
