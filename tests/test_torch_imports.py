"""The port stands alone: no import of ``jax``, of the reference package
``repro``, of ``triton`` or of any package of finished kernels, anywhere in
``src/repro_torch``, ``chip_smoke.py`` or the port's examples
(``examples/torch_*.py``, which ``chip_smoke.py`` runs); the device rule
never turns into the CPU on its own; the CPU path never touches the CUDA
build."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(ROOT, "src", "repro_torch")

FORBIDDEN = {"jax", "jaxlib", "repro", "triton", "flash_attn", "xformers",
             "apex", "cutlass", "cupy", "numba", "transformer_engine",
             "flashinfer", "vllm", "bitsandbytes", "deepspeed"}


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    ex = os.path.join(ROOT, "examples")
    out += [os.path.join(ex, f) for f in os.listdir(ex)
            if f.startswith("torch_") and f.endswith(".py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno


def test_sources_exist():
    names = {os.path.relpath(p, ROOT) for p in _sources()}
    for must in ("chip_smoke.py", "src/repro_torch/device.py",
                 "examples/torch_closed_loop.py",
                 "examples/torch_dse_sweep.py",
                 "src/repro_torch/sim/engine.py",
                 "src/repro_torch/sim/control.py",
                 "src/repro_torch/convert.py",
                 "src/repro_torch/core/dse.py",
                 "src/repro_torch/sim/batch.py",
                 "src/repro_torch/kernels/tick_sim.py",
                 "src/repro_torch/kernels/build.py",
                 "src/repro_torch/configs/base.py",
                 "src/repro_torch/configs/h2o_danube_1_8b.py",
                 "src/repro_torch/core/monitor.py",
                 "src/repro_torch/models/params.py",
                 "src/repro_torch/models/layers.py",
                 "src/repro_torch/models/transformer.py",
                 "src/repro_torch/kernels/flash_attention.py",
                 "src/repro_torch/kernels/flash_decode.py",
                 "src/repro_torch/kernels/fused_mlp.py",
                 "src/repro_torch/kernels/ssd_scan.py",
                 "src/repro_torch/kernels/ops.py",
                 "src/repro_torch/configs/mamba2_370m.py",
                 "src/repro_torch/models/mamba2.py",
                 "src/repro_torch/models/moe.py",
                 "src/repro_torch/configs/granite_moe_1b_a400m.py",
                 "src/repro_torch/runtime/serve.py",
                 "src/repro_torch/launch/serve.py"):
        assert must in names, must
    for cu in CUDA_SOURCES:
        assert os.path.exists(os.path.join(PKG, "kernels", "csrc", cu)), cu


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_import(path):
    """AST walk, every import statement at any depth (so not at module
    level, and not inside a function either)."""
    bad = [(m, ln) for m, ln in _imports(path) if m in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


CUDA_SOURCES = {"tick_sim.cu": ("tick_sim_launch",),
                "flash_attention.cu": ("flash_attention_launch",),
                "flash_decode.cu": ("flash_decode_launch",),
                "fused_mlp.cu": ("fused_mlp_launch",),
                "ssd_scan.cu": ("ssd_scan_launch",)}


def test_every_kernel_source_is_listed():
    on_disk = {f for f in os.listdir(os.path.join(PKG, "kernels", "csrc"))
               if f.endswith(".cu")}
    assert on_disk == set(CUDA_SOURCES)


def test_kernel_source_is_plain_cuda():
    """Every csrc/*.cu: no PyTorch headers (the build is nvcc + ctypes), no
    library kernels; a plain C entry point that returns the launch's CUDA
    error; a source note naming the TPU kernel it replaces."""
    for name, fns in CUDA_SOURCES.items():
        src = open(os.path.join(PKG, "kernels", "csrc", name)).read()
        for needle in ("torch/extension.h", "ATen/", "cublas", "cudnn",
                       "cutlass/", "cute/", "thrust/", "cub/",
                       "scaled_dot_product"):
            assert needle not in src, (name, needle)
        for fn in fns:
            assert f'extern "C" int {fn}' in src, name
        assert "cudaGetLastError" in src, name
        assert "Replaces: src/repro/kernels/" in src, name


def test_importing_every_submodule_leaves_jax_and_repro_out():
    code = textwrap.dedent("""
        import importlib, os, pkgutil, sys
        import repro_torch
        mods = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in mods:
            importlib.import_module(name)
        import repro_torch.core as c, repro_torch.sim as s
        for pkg in (c, s):
            for name in pkg.__all__:
                getattr(pkg, name)
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "repro", "triton")]
        assert not bad, bad
        assert len(mods) >= 44, mods
        build_dir = os.path.join(%r, "build")
        print("imported", len(mods), os.path.exists(build_dir))
    """ % ROOT)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    existed = os.path.exists(os.path.join(ROOT, "build"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("imported")
    # importing builds nothing
    assert proc.stdout.split()[-1] == str(existed)


def test_device_rule():
    from repro_torch import device
    assert device.resolve("cpu") == torch.device("cpu")
    assert device.resolve(torch.device("cpu")).type == "cpu"
    if torch.cuda.is_available():
        assert device.resolve(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            device.resolve(None)
        with pytest.raises(RuntimeError, match="CUDA"):
            device.resolve("cuda")
    device.require_single(None)
    device.require_single(1)
    with pytest.raises(NotImplementedError):
        device.require_single("auto")


def test_chip_smoke_stops_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, os.path.join(ROOT,
                                                        "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""            # prints no result
    assert "no CUDA device" in proc.stderr


def test_lazy_package_exports():
    import repro_torch
    assert repro_torch.core.grid_sweep is \
        repro_torch.core.dse.grid_sweep
    assert repro_torch.sim.BatchSimEngine is \
        repro_torch.sim.batch.BatchSimEngine
    with pytest.raises(AttributeError):
        repro_torch.core.no_such_name
    with pytest.raises(AttributeError):
        repro_torch.no_such_subpackage


def test_build_key_covers_the_shared_headers(tmp_path, monkeypatch):
    """A library's file name hashes its source, every csrc/*.cuh and the
    flags: an edit to a shared header builds anew instead of loading a
    stale library.  The shared headers hold no PyTorch or library code."""
    from repro_torch.kernels import build
    for hdr in sorted(Path(PKG, "kernels", "csrc").glob("*.cuh")):
        text = hdr.read_text()
        for needle in ("torch/extension.h", "ATen/", "cublas", "cudnn",
                       "cutlass/", "cute/", "thrust/", "cub/"):
            assert needle not in text, (hdr.name, needle)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "out"))
    src, flags = tmp_path / "k.cu", build.NVCC_FLAGS
    first = build._target(src, flags)
    assert build._target(src, flags) == first
    (tmp_path / "h.cuh").write_text("// v2\n")
    second = build._target(src, flags)
    assert second != first and second.parent == tmp_path / "out"
    assert build._target(src, flags + ("-Xptxas", "-v")) != second
