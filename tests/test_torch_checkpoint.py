"""The port's checkpoint manager (``repro_torch.checkpoint``): the JAX
manager's cases (tests/test_checkpoint.py) on torch trees, and files that
cross between the two packages both ways.

Across packages every comparison is bit for bit: a tree of float32,
bfloat16, int32, uint8 and bool leaves written by one manager restores in
the other with the same bits, dtypes and shapes; the leaf names and the
manifest are equal.
"""

import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro_torch.checkpoint import CheckpointManager


def _tree(seed=0):
    """A nested tree with every leaf dtype the engine journals."""
    g = torch.Generator().manual_seed(seed)
    return {
        "key": torch.randint(0, 255, (16,), generator=g, dtype=torch.uint8),
        "next_token": torch.randint(-5, 500, (4,), generator=g,
                                    dtype=torch.int32),
        "active": torch.tensor([True, False, True, True]),
        "slot_cols": {
            "s1": {"blocks": {"p0": {
                "wkv_state": torch.randn((2, 1, 4, 16, 16), generator=g),
                "tm_shift": torch.randn((2, 1, 64), generator=g).to(
                    torch.bfloat16)}},
                "lengths": torch.tensor([7], dtype=torch.int32)},
            "s0": {"lengths": torch.tensor([3], dtype=torch.int32)}},
        "saved_cols": {},
    }


def _bits(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().tobytes(), "bfloat16", \
                tuple(t.shape)
        return t.numpy().tobytes(), str(t.dtype).split(".")[1], tuple(t.shape)
    a = np.asarray(t)
    return a.tobytes(), str(a.dtype), a.shape


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree)
                for k2, v2 in _flat(tree[k], f"{prefix}/{k}").items()}
    return {prefix: tree}


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def _same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert _bits(fa[k]) == _bits(fb[k]), k


def test_roundtrip(tmp_path):
    tree = _tree()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, tree, extra={"data_step": 7})
    _same(mgr.restore(_zeros_like(tree)), tree)
    assert mgr.manifest(7)["extra"]["data_step"] == 7


def test_async_save_then_restore(tmp_path):
    tree = _tree()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree, blocking=False)
    tree["next_token"].zero_()        # the save copied the tree first
    mgr.wait()
    assert mgr.latest_step() == 1
    _same(mgr.restore(_zeros_like(tree))["slot_cols"], _tree()["slot_cols"])
    assert mgr.restore(_zeros_like(tree))["next_token"].tolist() == \
        _tree()["next_token"].tolist()


def test_retention_keeps_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.ones(3) * s})
    assert mgr.all_steps() == [3, 4]


def test_no_tmp_dirs_left_behind(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, {"x": torch.arange(4)})
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


def test_restore_latest_picks_max(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    for s in (3, 11, 7):
        mgr.save(s, {"x": torch.ones(2) * s})
    assert float(mgr.restore({"x": torch.zeros(2)})["x"][0]) == 11


def test_restore_missing_step_lists_available(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"x": torch.ones(2)})
    with pytest.raises(FileNotFoundError, match=r"step 42 not found.*\[3\]"):
        mgr.restore({"x": torch.zeros(2)}, step=42)


def test_restore_empty_dir(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no checkpoints under"):
        mgr.restore({"x": torch.zeros(2)})
    with pytest.raises(FileNotFoundError, match="no steps saved yet"):
        mgr.restore({"x": torch.zeros(2)}, step=0)


def test_restore_partial_step_names_missing_leaves(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.ones(2), "y": torch.zeros(3)})
    os.remove(os.path.join(tmp_path, "step_0000000001", "x.npy"))
    with pytest.raises(FileNotFoundError,
                       match=r"incomplete.*missing on disk.*'x'"):
        mgr.restore({"x": torch.zeros(2), "y": torch.zeros(3)}, step=1)


def test_restore_missing_manifest_explains(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.ones(2)})
    os.remove(os.path.join(tmp_path, "step_0000000001", "manifest.json"))
    with pytest.raises(FileNotFoundError, match="no manifest.json"):
        mgr.restore({"x": torch.zeros(2)}, step=1)
    with pytest.raises(FileNotFoundError, match="no manifest.json"):
        mgr.manifest(1)


def test_restore_template_wants_unsaved_leaf(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.ones(2)})
    with pytest.raises(FileNotFoundError, match="manifest never saved.*'z'"):
        mgr.restore({"x": torch.zeros(2), "z": torch.zeros(1)}, step=1)


def test_bf16_roundtrip_bit_exact(tmp_path):
    """bf16 goes to disk as raw 2-byte records and comes back by a bit
    view: every pattern, NaN and Inf included, keeps its bits."""
    x = torch.arange(0, 1 << 16, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, {"x": x})
    out = mgr.restore({"x": torch.zeros(x.shape, dtype=torch.bfloat16)},
                      step=2)
    assert out["x"].dtype == torch.bfloat16
    assert torch.equal(out["x"].view(torch.int16), x.view(torch.int16))


def _jax_tree(tree):
    """The same tree as JAX arrays (bf16 through ml_dtypes, bits kept)."""
    def conv(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.view(torch.int16).numpy().view(
                ml_dtypes.bfloat16))
        return jnp.asarray(t.numpy())
    return {k: _jax_tree(v) if isinstance(v, dict) else conv(v)
            for k, v in tree.items()}


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:010d}", "manifest.json")) as f:
        return json.load(f)


def test_jax_files_restore_in_the_port(tmp_path):
    tree = _tree(1)
    extra = {"engine": {"tick": 9, "queue": [{"uid": 1}]}}
    JManager(str(tmp_path / "j")).save(9, _jax_tree(tree), extra=extra)
    CheckpointManager(str(tmp_path / "t")).save(9, tree, extra=extra)
    assert _manifest(tmp_path / "j", 9) == _manifest(tmp_path / "t", 9)
    assert sorted(os.listdir(tmp_path / "j" / "step_0000000009")) == \
        sorted(os.listdir(tmp_path / "t" / "step_0000000009"))
    out = CheckpointManager(str(tmp_path / "j")).restore(_zeros_like(tree))
    _same(out, tree)


def test_port_files_restore_in_jax(tmp_path):
    tree = _tree(2)
    CheckpointManager(str(tmp_path)).save(4, tree, extra={"a": 1})
    like = _jax_tree(_zeros_like(tree))
    out = JManager(str(tmp_path)).restore(like, step=4)
    flat_t, flat_j = _flat(tree), _flat(out)
    assert flat_t.keys() == flat_j.keys()
    for k, t in flat_t.items():
        a = np.asarray(flat_j[k])
        if t.dtype == torch.bfloat16:
            assert a.dtype == ml_dtypes.bfloat16
            assert a.view(np.int16).tobytes() == \
                t.view(torch.int16).numpy().tobytes(), k
        else:
            assert a.dtype == t.numpy().dtype and a.shape == tuple(t.shape)
            assert a.tobytes() == t.numpy().tobytes(), k
    assert JManager(str(tmp_path)).manifest(4)["extra"] == {"a": 1}
