"""The port stands alone: no import of ``jax``, of the reference package
``repro``, of ``triton`` or of any package of finished kernels, anywhere in
``src/repro_torch`` or ``chip_smoke.py``; the device rule never turns into
the CPU on its own; the CPU path never touches the CUDA build."""
import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(ROOT, "src", "repro_torch")

FORBIDDEN = {"jax", "jaxlib", "repro", "triton", "flash_attn", "xformers",
             "apex", "cutlass", "cupy", "numba", "transformer_engine",
             "flashinfer", "vllm", "bitsandbytes", "deepspeed"}


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
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
                 "src/repro_torch/convert.py",
                 "src/repro_torch/core/dse.py",
                 "src/repro_torch/sim/batch.py",
                 "src/repro_torch/kernels/tick_sim.py",
                 "src/repro_torch/kernels/build.py"):
        assert must in names, must
    assert os.path.exists(os.path.join(PKG, "kernels", "csrc",
                                       "tick_sim.cu"))


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_import(path):
    """AST walk, every import statement at any depth (so not at module
    level, and not inside a function either)."""
    bad = [(m, ln) for m, ln in _imports(path) if m in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_kernel_source_is_plain_cuda():
    """No PyTorch headers (the build is nvcc + ctypes), no library kernels."""
    src = open(os.path.join(PKG, "kernels", "csrc", "tick_sim.cu")).read()
    for needle in ("torch/extension.h", "ATen/", "cublas", "cudnn",
                   "cutlass/gemm/device", "thrust/"):
        assert needle not in src, needle
    assert 'extern "C" int tick_sim_launch' in src
    assert "cudaGetLastError" in src


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
        assert len(mods) >= 18, mods
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
