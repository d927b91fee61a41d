"""Async, atomic checkpointing, mirroring ``repro/checkpoint/store.py``
with only the standard library beside NumPy and PyTorch: the manifest is
JSON and the data is compressed with ``zlib`` (the reference writes msgpack
and zstd, and falls back to zlib itself).

Layout (one directory per step)::

    <dir>/step_000120/
        manifest.json        # step, and per leaf: path, shape, dtype,
                             # host, offset, length (its bytes' place in
                             # the uncompressed sequence), zoffset, zlength
        shard_00000.bin.zlib # one zlib stream per leaf, concatenated

Each leaf is compressed on its own, the leaves on a pool of threads
(``zlib`` lets go of the GIL), so a save is not one core's deflate of the
whole state.

* **Async**: ``save_async`` copies the tensors to host memory at once (the
  only wait for the card) and serialises and writes on a worker thread, so
  the training loop keeps stepping while bytes reach the disk.
* **Atomic**: a save goes to ``<dir>.tmp`` and is renamed into place; a
  crash mid-save never corrupts the latest complete checkpoint.
* **Restore** takes a tree of the wanted structure (``like``) and casts each
  leaf to its dtype and device (or to ``device=``, for a template of
  ``meta`` tensors).
* **Placed trees** (DTensor leaves on a ``ProcessMesh``): a save gathers
  each leaf whole on every rank (explicit all-gathers, one leaf at a time)
  and rank 0 alone writes the single shard file, the reference's one
  writer; every rank of the save waits for the write before it goes on
  (``save`` at once, ``save_async`` at ``wait``).  ``restore(...,
  shardings=)`` lays every leaf out anew on the target mesh, whatever mesh
  saved it (the reference's elastic restore): each rank reads the file and
  keeps its block, bit for bit.

bfloat16 leaves (NumPy has no bfloat16) are written as their raw 2-byte
words with ``"dtype": "bfloat16"``.  Reading the reference's msgpack
checkpoints is out of scope.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import warnings
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.params import tree_unflatten
from repro_torch.parallel.placement import (from_block, full_tensor,
                                            is_placed, local_block)

SHARD = "shard_00000.bin.zlib"
MANIFEST = "manifest.json"


def _flatten_with_paths(tree, prefix="", is_leaf=torch.is_tensor):
    """(path, leaf) pairs in the reference's flattening order: dict keys
    sorted, list / tuple items and NamedTuple fields in order; paths join
    keys, indices and field names with ``/``."""
    if is_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    elif tree is None:
        return []
    else:
        raise TypeError(f"checkpoint leaf of type {type(tree).__name__}")
    out = []
    for k, v in items:
        out += _flatten_with_paths(v, f"{prefix}/{k}" if prefix else k,
                                   is_leaf)
    return out


def _is_sharding(x) -> bool:
    return hasattr(x, "spec") and hasattr(x, "mesh")


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist
    dist.barrier()


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor's bytes as a NumPy array (bfloat16 as int16
    words).  Always a copy, also for a tensor already on the CPU: the
    optimizer writes its moments in place while a save is in flight."""
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _place_block(full: torch.Tensor, sharding, dtype, device):
    """``full`` (host) placed by ``sharding``: this rank's block copied to
    ``device`` (the mesh's by default) as a DTensor."""
    mesh = sharding.mesh
    blk = local_block(full, sharding.spec, mesh).to(
        device=device if device is not None else mesh.device, dtype=dtype,
        memory_format=torch.contiguous_format, copy=True)
    return from_block(blk, sharding.spec, mesh, tuple(full.shape))


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


@dataclass
class SaveResult:
    step: int
    path: str
    seconds: float
    nbytes: int


def _pool_map(fn, items):
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        return list(ex.map(fn, items))


class CheckpointStore:
    def __init__(self, root: str, *, keep: int = 3, level: int = 1):
        self.root = root
        self.keep = keep
        self.level = level
        self._thread: Optional[threading.Thread] = None
        self._last: Optional[SaveResult] = None
        self._err: Optional[BaseException] = None
        self._placed_pending = False
        os.makedirs(root, exist_ok=True)

    # ------------------------------------------------------------------ save
    def _snapshot(self, tree):
        """``(snapshot or None, placed)``: the leaves' host copies, taken
        now; a placed tree's leaves gathered whole first (every rank takes
        part), the copies kept on rank 0 alone (``None`` elsewhere)."""
        pairs = _flatten_with_paths(tree)
        placed = any(is_placed(t) for _, t in pairs)
        writer = not placed or _rank() == 0
        snap = []
        for p, t in pairs:
            if is_placed(t):
                t = full_tensor(t)
            if writer:
                snap.append((p, _dtype_name(t), _to_host(t)))
        return (snap if writer else None), placed

    def _write(self, step: int, snap, t0: float) -> SaveResult:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest: Dict[str, Any] = {"step": step, "leaves": []}
        level = min(self.level, 9)
        blobs = _pool_map(
            lambda e: zlib.compress(np.ascontiguousarray(e[2]).data, level),
            snap)
        offset = zoffset = 0
        with open(os.path.join(tmp, SHARD), "wb") as f:
            for (path, dtype, a), blob in zip(snap, blobs):
                manifest["leaves"].append({
                    "path": path, "shape": list(a.shape), "dtype": dtype,
                    "host": 0, "offset": offset, "length": a.nbytes,
                    "zoffset": zoffset, "zlength": len(blob)})
                f.write(blob)
                offset += a.nbytes
                zoffset += len(blob)
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()
        res = SaveResult(step, final, time.monotonic() - t0, offset)
        self._last = res
        return res

    def save(self, step: int, tree: Any) -> SaveResult:
        """Synchronous save; ``seconds`` counts the copy to the host too
        (a placed tree: the gathers too; ``nbytes`` 0 on the ranks that do
        not write)."""
        t0 = time.monotonic()
        snap, placed = self._snapshot(tree)
        if snap is not None:
            res = self._write(step, snap, t0)
        else:
            res = SaveResult(step, self._step_dir(step),
                             time.monotonic() - t0, 0)
        if placed:
            _barrier()                     # the file is there for every rank
        return res

    def save_async(self, step: int, tree: Any) -> None:
        """Snapshot now, write in the background (overlaps the next steps)."""
        self.wait()                                  # one in flight at a time
        t0 = time.monotonic()
        snap, self._placed_pending = self._snapshot(tree)   # host copies
        if snap is None:
            return

        def work():
            try:
                self._write(step, snap, t0)
            except BaseException as e:                # pragma: no cover
                self._err = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> Optional[SaveResult]:
        """Wait for the save in flight (of a placed tree: on every rank,
        until rank 0 has written it)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._placed_pending:
            self._placed_pending = False
            _barrier()
        if self._err is not None:
            err, self._err = self._err, None
            raise err
        return self._last

    # --------------------------------------------------------------- restore
    def _steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None,
                device=None, shardings: Any = None) -> Any:
        """Restore into the structure of ``like``, each leaf cast to its
        dtype and placed on its device (or on ``device`` when given).
        ``shardings``: a tree like ``like`` whose ``Sharding`` leaves (on a
        ``ProcessMesh``) place those leaves there, each rank keeping its
        block (on the mesh's device unless ``device`` is given); ``None``
        leaves and a missing tree leave the leaves whole."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self._step_dir(step)
        with open(os.path.join(d, MANIFEST)) as f:
            manifest = json.load(f)
        with open(os.path.join(d, SHARD), "rb") as f:
            shard = f.read()
        by_path = {leaf["path"]: leaf for leaf in manifest["leaves"]}
        sh = dict(_flatten_with_paths(shardings, is_leaf=_is_sharding)
                  if shardings is not None else [])
        pairs = [(by_path[path], leaf, sh.get(path))
                 for path, leaf in _flatten_with_paths(like)]

        view = memoryview(shard)

        def load(pair):
            meta, leaf, sharding = pair
            z = meta["zoffset"]
            raw = zlib.decompress(view[z:z + meta["zlength"]])
            bf16 = meta["dtype"] == "bfloat16"
            arr = np.frombuffer(raw, dtype=np.int16 if bf16
                                else np.dtype(meta["dtype"]))
            arr = arr.reshape(meta["shape"])
            if sharding is None:
                arr = arr.copy()                      # torch wants it writable
            with warnings.catch_warnings():           # a placed leaf copies
                warnings.simplefilter("ignore", UserWarning)   # its block
                t = torch.from_numpy(arr)
            if bf16:
                t = t.view(torch.bfloat16)
            if sharding is not None:
                return _place_block(t, sharding, leaf.dtype, device)
            return t.to(device=device if device is not None
                        else leaf.device, dtype=leaf.dtype)
        return tree_unflatten(like, _pool_map(load, pairs))

    # ------------------------------------------------------------------ misc
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:06d}")

    def _gc(self) -> None:
        for s in self._steps()[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
