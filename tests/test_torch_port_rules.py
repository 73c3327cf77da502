"""Rules of the PyTorch port: it imports neither JAX nor the JAX package,
its entry points never fall back to the CPU on their own, a missing
compiler is a clear error, and kernel counters move only on the card."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import cells
from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.flash_attention import flash_attention as tfa
from repro_torch.kernels.flash_attention import flash_decode as tfd
from repro_torch.kernels.fused_rnn import fused_rnn as tk
from repro_torch.kernels.matmul_int8 import matmul_int8 as tmm
from repro_torch.launch import deepbench
from repro_torch.launch import serve
from repro_torch.models import recurrence
from repro_torch.models.lm import build_model
from repro_torch.models.params import tree_from_numpy
from repro_torch.testing import reduced_config

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def forbidden_imports(source: str):
    """Absolute imports of ``jax``/``repro`` (or a submodule) in ``source``."""
    bad = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(name)
    return bad


def test_scanner_tells_repro_from_repro_torch():
    assert forbidden_imports("import repro") == ["repro"]
    assert forbidden_imports("from repro import hw") == ["repro"]
    assert forbidden_imports("from repro.core.dse import snap_tile") == [
        "repro.core.dse"]
    assert forbidden_imports("import jax.numpy as jnp") == ["jax.numpy"]
    assert forbidden_imports("import repro_torch.hw\n"
                             "from repro_torch.core import dse\n"
                             "from . import ref") == []


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_repro(path):
    assert forbidden_imports(path.read_text()) == []


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_gpu_or_device(no_cuda):
    cfg = cells.RNNCellConfig("lstm", 64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dispatch.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cells.init_weights(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cells.weights_from_numpy({"b": np.zeros((4, 64), np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepbench.main(["--tasks", "1", "--timesteps", "1"])
    # an explicit CPU device is honoured
    w = cells.init_weights(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert w["w_x"].device.type == "cpu"


def test_lm_and_serve_entry_points_raise_without_gpu_or_device(no_cuda):
    model = build_model(reduced_config("rwkv6-1.6b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(2, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tree_from_numpy({"a": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "rwkv6-1.6b", "--reduced", "--requests", "1",
                    "--max-new", "1"])
    # an explicit CPU device is honoured
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    assert params["embedding"].device.type == "cpu"
    assert model.init_cache(2, 16, "cpu")["lengths"].device.type == "cpu"


def test_fleet_entry_points_raise_without_gpu_or_device(no_cuda):
    from repro_torch.plan.plan import FleetPlan, ServingPlan
    from repro_torch.serving.router import Router

    fleet = FleetPlan.replicated(ServingPlan(arch="rwkv6-1.6b", max_batch=2,
                                             max_len=32), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Router.from_plan(fleet)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "rwkv6-1.6b", "--reduced", "--arrival",
                    "poisson", "--duration", "4", "--replicas", "2"])
    # parameters on another device than the fleet's are refused, never
    # served where they lie
    model = build_model(reduced_config("rwkv6-1.6b"))
    params = model.init_serving(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="the fleet serves on meta"):
        Router.from_plan(fleet, device="meta",
                         _built={("rwkv6-1.6b", True): (model, params)})
    router = Router.from_plan(fleet, device="cpu",
                              _built={("rwkv6-1.6b", True): (model, params)})
    assert all(e.device.type == "cpu" for e in router.engines)
    # without ``_built`` the router builds the tree the launcher serves,
    # once for both replicas
    router = Router.from_plan(fleet, device="cpu")
    assert router.engines[0].params is router.engines[1].params
    for name, leaf in router.engines[0].params["blocks"]["p0"].items():
        assert torch.equal(leaf, params["blocks"]["p0"][name]), name


def test_planner_entry_points_raise_without_gpu_or_device(no_cuda):
    """``autotune`` and ``autotune_from_trace`` probe on the card unless
    given ``device="cpu"``; the CLI's ``--autotune`` likewise."""
    from repro_torch.obs import Tracer
    from repro_torch.plan import WorkloadProfile
    from repro_torch.plan import planner
    from repro_torch.serving.engine import Request

    wl = WorkloadProfile(rate=0.3, duration=4.0)
    kw = dict(max_batches=(2,), probe_duration=4.0)
    tracer = Tracer()
    for uid in range(3):
        tracer.request_submit(Request(uid, [1, 2, 3], max_new_tokens=4,
                                      t_submit=uid), uid)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        planner.autotune("rwkv6-1.6b", wl, **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        planner.autotune_from_trace("rwkv6-1.6b", tracer, **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "rwkv6-1.6b", "--reduced", "--autotune",
                    "--arrival", "poisson", "--duration", "4"])
    # an explicit CPU device is honoured
    plan = planner.autotune_from_trace("rwkv6-1.6b", tracer, device="cpu",
                                       **kw)
    assert plan.provenance["observed_traffic"]["trace_summary"][
        "submits"] == 3
    assert planner.autotune("rwkv6-1.6b", wl, device="cpu",
                            **kw).max_batch == 2


def test_missing_rwkv_plan_entry_runs_the_kernel_on_cuda():
    """The JAX package decodes with jnp when the plan has no rwkv entry;
    the port resolves a missing entry as "auto": the kernel on CUDA."""
    model = build_model(reduced_config("rwkv6-1.6b"))
    entry = model.tile_plans.get("rwkv")
    assert entry is None
    assert recurrence.step_impl(entry, torch.device("cuda")) == "kernel"
    assert recurrence.step_impl(entry, torch.device("cpu")) == "plain"
    for impl in ("plain", "jnp"):
        assert recurrence.step_impl({"impl": impl}, "cuda") == "plain"
    assert recurrence.step_impl({"bh": 64}, "cuda") == "kernel"


def test_build_without_nvcc_is_a_clear_error(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_DEFAULT", tmp_path / "none")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert _build.find_nvcc() is None
    for name in ("fused_rnn", "rwkv_step", "flash_attention"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build(name)
    assert not (tmp_path / "build").exists()


def test_library_path_keyed_by_source():
    p = _build.library_path("fused_rnn")
    assert p.parent == _build.BUILD_DIR and p.suffix == ".so"
    assert p.name.startswith("fused_rnn-")
    assert _build.library_path("rwkv_step").name.startswith("rwkv_step-")
    assert _build.library_path("flash_attention").name.startswith(
        "flash_attention-")
    assert _build.BUILD_DIR.relative_to(ROOT).parts[0] == "build"


def test_launch_counters_stay_zero_on_cpu():
    before = dict(tk.LAUNCHES)
    cfg = cells.RNNCellConfig("gru", 64, timesteps=3, precision="int8")
    w = cells.quantize_weights(cfg, cells.init_weights(
        cfg, torch.Generator().manual_seed(1), device="cpu"))
    x = torch.randn((3, 2, 64)).to(torch.bfloat16)
    cells.serve(cfg, w, x, impl="kernel")
    cells.serve(cfg, w, x, impl="kernel", plan={"persistent": True})
    assert tk.LAUNCHES == before
    assert set(tk.LAUNCHES) == {"fused_lstm", "fused_lstm_xproj",
                                "fused_lstm_persistent", "fused_gru",
                                "fused_gru_xproj", "fused_gru_persistent"}


def test_wrapper_refuses_other_devices():
    """Off the CPU the wrapper launches the kernel or raises: a tensor on
    a device that is neither gets an error, never the plain version."""
    m = torch.zeros((2, 1, 8), device="meta", dtype=torch.bfloat16)
    w = torch.zeros((8, 3, 8), device="meta", dtype=torch.int8)
    s = torch.zeros((3, 8), device="meta")
    h = torch.zeros((1, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.fused_gru(m, w, w, s, s, s, s, h)


def test_resolve_impl():
    assert dispatch.resolve_impl(None, "cpu") == "plain"
    assert dispatch.resolve_impl(None, "cuda") == "kernel"
    assert dispatch.resolve_impl({"impl": "auto"}, torch.device("cuda")) \
        == "kernel"
    assert dispatch.resolve_impl({"impl": "jnp"}, "cuda") == "plain"
    assert dispatch.resolve_impl({"impl": "pallas"}, "cpu") == "kernel"
    assert dispatch.resolve_impl({"impl": "plain"}, "cuda") == "plain"
    with pytest.raises(ValueError):
        dispatch.resolve_impl({"impl": "triton"}, "cpu")
    assert dispatch.tile_arg({"bh": 0}, "bh", 64) == 64
    assert dispatch.tile_arg({"bh": 32}, "bh", 64) == 32


def test_qwen_entry_points_raise_without_gpu_or_device(no_cuda):
    model = build_model(reduced_config("qwen2.5-14b"))
    gen = torch.Generator().manual_seed(0)
    for call in (lambda: model.init(gen), lambda: model.init_serving(gen),
                 lambda: model.init_cache(2, 16),
                 lambda: serve.main(["--arch", "qwen2.5-14b", "--reduced",
                                     "--requests", "1", "--max-new", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    params = model.init_serving(gen, device="cpu")
    assert params["blocks"]["p0"]["attn"]["wq"].device.type == "cpu"
    assert model.init_cache(2, 16, "cpu")["blocks"]["p0"]["pos"].device.type \
        == "cpu"


def test_missing_attn_plan_entry_runs_the_kernels_on_cuda(monkeypatch):
    """As for rwkv: the JAX package takes its jnp attention whenever the
    plan has no "attn" entry; the port resolves it as "auto".  Both
    attention call sites ask ``resolve_impl`` with the model's entry."""
    from repro_torch.models import attention

    model = build_model(reduced_config("qwen2.5-14b"))
    entry = model.tile_plans.get("attn")
    assert entry is None
    assert dispatch.resolve_impl(entry, torch.device("cuda")) == "kernel"
    assert dispatch.resolve_impl(entry, torch.device("cpu")) == "plain"
    for impl in ("plain", "jnp"):
        assert dispatch.resolve_impl({"impl": impl}, "cuda") == "plain"
    assert dispatch.resolve_impl({"bq": 64, "bk": 128}, "cuda") == "kernel"
    asked = []
    monkeypatch.setattr(attention, "resolve_impl",
                        lambda e, d: asked.append(e) or "plain")
    params = model.init_serving(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, 503, (2, 8), dtype=torch.int32)
    cache, logits = model.prefill(params, {"tokens": toks}, max_len=16)
    model.decode_step(params, cache, logits.argmax(-1).to(torch.int32))
    assert asked == [None] * (2 * model.cfg.n_layers)


def test_flash_counters_stay_zero_on_cpu():
    before = (dict(tfa.LAUNCHES), dict(tfd.LAUNCHES))
    model = build_model(reduced_config("qwen2.5-14b"))
    params = model.init_serving(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, 503, (2, 8), dtype=torch.int32)
    cache, logits = model.prefill(params, {"tokens": toks}, max_len=16)
    model.decode_step(params, cache, logits.argmax(-1).to(torch.int32))
    kernel = model.with_tile_plans({"attn": {"impl": "kernel"}})
    kernel.decode_step(params, cache, logits.argmax(-1).to(torch.int32))
    assert (tfa.LAUNCHES, tfd.LAUNCHES) == before
    assert set(tfa.LAUNCHES) == {"flash_attention"}
    assert set(tfd.LAUNCHES) == {"flash_decode"}


def test_flash_wrappers_refuse_other_devices():
    q = torch.zeros((1, 2, 8, 64), device="meta", dtype=torch.bfloat16)
    pos = torch.zeros((1, 8), device="meta", dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_attention(q, q, q, pos, pos)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfd.flash_decode(q[:, :, 0], q, q, pos, pos[:, 0])


# the modules this slice added: the int8 tree helpers and the W8A16 kernel
INT8_MODULES = ["src/repro_torch/core/quant.py",
                "src/repro_torch/kernels/matmul_int8/__init__.py",
                "src/repro_torch/kernels/matmul_int8/ref.py",
                "src/repro_torch/kernels/matmul_int8/matmul_int8.py",
                "src/repro_torch/kernels/matmul_int8/ops.py"]


@pytest.mark.parametrize("rel", INT8_MODULES)
def test_int8_modules_import_no_jax_and_no_repro(rel):
    path = ROOT / rel
    assert path in PORT_FILES
    assert forbidden_imports(path.read_text()) == []


# the observability modules: torch-free, as the JAX ones are JAX-free
OBS_MODULES = ["src/repro_torch/obs/__init__.py",
               "src/repro_torch/obs/registry.py",
               "src/repro_torch/obs/trace.py",
               "src/repro_torch/obs/observe.py"]


@pytest.mark.parametrize("rel", OBS_MODULES)
def test_obs_modules_import_no_jax_no_repro_and_no_torch(rel):
    path = ROOT / rel
    assert path in PORT_FILES
    source = path.read_text()
    assert forbidden_imports(source) == []
    tops = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add((node.module or "").split(".")[0])
    assert tops <= {"__future__", "dataclasses", "json", "math",
                    "collections", "typing", "repro_torch"}


def test_matmul_int8_library_and_missing_nvcc(monkeypatch, tmp_path):
    """The new source builds like the others: a library keyed by its
    source, and a clear error where nvcc is missing."""
    p = _build.library_path("matmul_int8")
    assert p.parent == _build.BUILD_DIR and p.name.startswith("matmul_int8-")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_DEFAULT", tmp_path / "none")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("matmul_int8")
    assert not (tmp_path / "build").exists()


def test_every_cuda_source_is_built_by_chip_smoke():
    """Each csrc/*.cu is a library ``_build`` can make, and chip_smoke.py
    builds every one of them (one nvcc each, started together)."""
    import re
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert "matmul_int8" in sources
    text = (ROOT / "chip_smoke.py").read_text()
    names = re.search(r"names = \(([^)]*)\)", text).group(1)
    assert sorted(re.findall(r'"(\w+)"', names)) == sources


def test_missing_matmul_int8_plan_entry_runs_the_kernel_on_cuda(monkeypatch):
    """As for rwkv and attention: a missing "matmul_int8" entry resolves
    as "auto", the kernel on CUDA.  Every dot of a block asks with the
    model's entry; plain leaves never ask."""
    from repro_torch.core.quant import quantize_tree
    from repro_torch.models import layers

    model = build_model(reduced_config("qwen2.5-14b", d_model=256,
                                       n_heads=8, n_kv_heads=4, head_dim=64,
                                       d_ff=512))
    assert model.tile_plans.get("matmul_int8") is None
    assert dispatch.resolve_impl(None, torch.device("cuda")) == "kernel"
    asked = []
    monkeypatch.setattr(layers, "resolve_impl",
                        lambda e, d: asked.append(e) or "plain")
    params = model.init_serving(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, 503, (2, 8), dtype=torch.int32)
    model.prefill(params, {"tokens": toks}, max_len=16)
    assert asked == []
    model.prefill(quantize_tree(params), {"tokens": toks}, max_len=16)
    assert asked == [None] * (7 * model.cfg.n_layers)


def test_matmul_counter_stays_zero_on_cpu():
    from repro_torch.core.quant import quantize_tree

    before = dict(tmm.LAUNCHES)
    model = build_model(reduced_config("qwen2.5-14b", d_model=256,
                                       n_heads=8, n_kv_heads=4, head_dim=64,
                                       d_ff=512))
    params = quantize_tree(model.init(torch.Generator().manual_seed(0),
                                      "cpu"))
    toks = torch.randint(0, 503, (2, 8), dtype=torch.int32)
    for plans in (None, {"matmul_int8": {"impl": "kernel"}}):
        m = model.with_tile_plans(plans)
        cache, logits = m.prefill(params, {"tokens": toks}, max_len=16)
        m.decode_step(params, cache, logits.argmax(-1).to(torch.int32))
    assert tmm.LAUNCHES == before
    assert set(tmm.LAUNCHES) == {"matmul_w8a16", "matmul_w8a16_prefill"}


def test_build_key_covers_the_shared_headers(tmp_path, monkeypatch):
    """A kernel library is rebuilt when a shared header under csrc/
    changes, not only when its own source does."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("k")
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build.library_path("k") != before
