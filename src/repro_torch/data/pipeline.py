"""Deterministic, resumable, sharded synthetic data pipeline (the IO tile),
mirroring ``repro/data/pipeline.py`` bit for bit.

Batch ``i`` is a pure function of the config (a NumPy generator seeded
from (seed, step, shard)), so any host regenerates any step: resume after a
failure is exact and every data-parallel shard draws its own slice.  The
batches are NumPy arrays on the host; :func:`to_device` copies them to the
card from pinned memory without waiting, and :func:`device_put_batch`
gives one rank of a mesh its slice of the data axes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab_size: int = 32_000
    seq_len: int = 1024
    global_batch: int = 8
    modality: str = "text"        # text | vision | audio
    d_model: int = 0              # for embedding-input modalities


class SyntheticLM:
    """Markov-ish synthetic LM stream: tokens have local structure (so the
    loss actually decreases) but are cheap to generate on the fly."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int, *, shard: int = 0, n_shards: int = 1
                 ) -> Dict[str, np.ndarray]:
        """The canonical contract: batch for ``step``, host-shard ``shard``."""
        cfg = self.cfg
        assert cfg.global_batch % n_shards == 0
        b_local = cfg.global_batch // n_shards
        rng = np.random.default_rng(
            np.uint64(cfg.seed) * np.uint64(1_000_003)
            + np.uint64(step) * np.uint64(65_537) + np.uint64(shard))
        # structured stream: token_{t+1} = (a*token_t + noise) % V
        base = rng.integers(0, cfg.vocab_size, size=(b_local, 1))
        steps = rng.integers(0, 17, size=(b_local, cfg.seq_len))
        toks = (base + np.cumsum(steps, axis=1)) % cfg.vocab_size
        toks = toks.astype(np.int32)
        out: Dict[str, np.ndarray] = {
            "tokens": toks[:, :-1].copy() if cfg.seq_len > 1 else toks,
            "labels": toks[:, 1:].copy() if cfg.seq_len > 1 else toks,
        }
        if cfg.modality in ("vision", "audio") and cfg.d_model:
            # stub frontend: precomputed patch/frame embeddings
            emb = rng.standard_normal(
                (b_local, out["tokens"].shape[1], cfg.d_model)
            ).astype(np.float32)
            out["embeds"] = (emb * 0.02).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def for_arch(arch: ArchConfig, shape: ShapeConfig, seed: int = 0
             ) -> SyntheticLM:
    return SyntheticLM(DataConfig(
        seed=seed, vocab_size=arch.vocab_size,
        seq_len=shape.seq_len + 1, global_batch=shape.global_batch,
        modality=arch.modality, d_model=arch.d_model))


def to_device(batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """A host batch on ``device``: to a CUDA device from pinned memory with
    ``non_blocking=True`` (the copy does not wait for the card); on the CPU
    the arrays are taken as they are."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def device_put_batch(batch: Dict[str, np.ndarray], mesh, data_axes
                     ) -> Dict[str, torch.Tensor]:
    """This rank's part of a host batch sharded over the data axes of
    ``mesh`` (a :class:`~repro_torch.launch.mesh.ProcessMesh`): the leading
    axis of every array split into ``axis_size(data_axes)`` equal slices,
    row-major over a tuple of axes, the rank's slice on its device; rank-0
    arrays replicated (the reference's ``NamedSharding(mesh, P(data_axes))``
    seen from one device)."""
    from repro_torch.parallel.collectives import axis_index, axis_size
    n, i = axis_size(data_axes, mesh), axis_index(data_axes, mesh)
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if v.ndim >= 1:
            if v.shape[0] % n:
                raise ValueError(f"{k}: leading axis {v.shape[0]} does not "
                                 f"split over {n} data shards")
            step = v.shape[0] // n
            v = v[i * step:(i + 1) * step]
        # to_device's contiguous copy makes a rank-0 array rank 1
        out[k] = to_device({k: v}, mesh.device)[k].reshape(v.shape)
    return out
