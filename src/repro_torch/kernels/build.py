"""Builds the port's CUDA sources into one shared library, at first use.

``nvcc`` compiles each ``csrc/<name>.cu`` of this package for ``sm_90a``
into ``build/kernels/lib<name>_<hash>.so`` (plain C interface, loaded with
``ctypes``; no PyTorch headers, so a build takes seconds; all sources are
compiled side by side, one ``nvcc`` each).  The directory is ``build/``
under the repository root (override with ``REPRO_TORCH_BUILD_DIR``) and the
file name carries a hash of the source, of every shared header
``csrc/*.cuh`` and of the flags, so a changed source or header builds anew
and an unchanged one is loaded as it is.  A failed build
raises with the compiler's output.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# tick_sim: products and sums round separately, as its plain PyTorch version
# does, so its integer outputs (swaps, guard) can be compared exactly.
SOURCE_FLAGS = {"tick_sim": ("-fmad=false",)}

_lock = threading.Lock()
# one entry per csrc/*.cu source of the checkout ("absent" in the seconds:
# loaded from the on-disk cache)
_libs: Dict[str, ctypes.CDLL] = {}  # repro: noqa[TPR003] one loaded library per csrc/*.cu source, bounded by the checkout
last_build_seconds: Dict[str, float] = {}  # repro: noqa[TPR003] one entry per csrc/*.cu source, rewritten by each build
last_build_log: Dict[str, str] = {}  # repro: noqa[TPR003] one entry per csrc/*.cu source, rewritten by each build


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # <root>/src/repro_torch/kernels/build.py -> <root>/build/kernels
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked at $NVCC, PATH and /usr/local/cuda/bin): "
        "the CUDA kernels of repro_torch are built from source at first use")


def _target(src: Path, flags) -> Path:
    h = hashlib.sha256()
    h.update(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):      # any source may include it
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(" ".join(flags).encode())
    return build_dir() / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def _start(src: Path, so: Path, flags):
    """Start one nvcc; build beside the target and rename when done, so a
    reader never sees a half-written library."""
    nvcc = _find_nvcc()
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    cmd = [nvcc, *flags, "-o", tmp, str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, cmd, time.perf_counter()


def _finish(name: str, so: Path, started) -> None:
    proc, tmp, cmd, t0 = started
    log, _ = proc.communicate()
    last_build_log[name] = log
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError("nvcc failed (exit %d): %s\n%s"
                           % (proc.returncode, " ".join(cmd), log))
    os.replace(tmp, so)
    last_build_seconds[name] = time.perf_counter() - t0


def build_all(verbose: bool = False) -> Dict[str, ctypes.CDLL]:
    """Build (all sources at once, one nvcc each) and load every kernel
    library that this source state has not built yet.  ``verbose`` adds
    ``-Xptxas -v`` (registers, spills) to the compiler's log."""
    extra = ("-Xptxas", "-v") if verbose else ()
    with _lock:
        srcs = sources()
        if not srcs:
            raise RuntimeError(f"no CUDA sources under {CSRC}")
        pending = {}
        for src in srcs:
            if src.stem in _libs:
                continue
            flags = NVCC_FLAGS + SOURCE_FLAGS.get(src.stem, ()) + extra
            so = _target(src, flags)
            pending[src.stem] = (so, None if so.exists()
                                 else _start(src, so, flags))
        errors = []
        for name, (so, started) in pending.items():
            try:
                if started is not None:
                    _finish(name, so, started)
                _libs[name] = ctypes.CDLL(str(so))
            except RuntimeError as e:       # let the other builds end first
                errors.append(e)
        if errors:
            raise errors[0]
        return dict(_libs)


def library(name: str, verbose: bool = False) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _libs:
        build_all(verbose=verbose)
    return _libs[name]


def function(name: str, symbol: str, argtypes):
    """``symbol`` of ``csrc/<name>.cu`` with its ctypes argument types set
    (pointers and the stream as ``c_void_p``, so they are not cut to 32
    bits) and an ``int`` (``cudaError_t``) result."""
    fn = getattr(library(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
