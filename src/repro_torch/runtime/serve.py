"""Serving runtime: prefill/decode engine + slot scheduler with RTT.

Mirrors ``repro/runtime/serve.py``: a slot-based continuous-batching
scheduler whose per-request dispatch->first-token time feeds the C3 ``rtt``
counter (the analogue of the paper's DMA round-trip counter).

The reference ``vmap``s one decode step over a per-slot cache whose position
is a per-slot scalar.  Here that batch dimension is written out: the cache is
one ``(L, slots, W, KV, hd)`` pair with a ``(slots,)`` position vector (for
the ``ssm`` family: the stacked conv buffers and states, ``(L, slots, ...)``
each; the ``hybrid`` family adds the shared tile's ``(n_apps, slots, W, KV,
hd)`` pair), and one batched ``decode_step`` serves every slot, each row at
its own position (dense: its query position ``pos[b]``, its ring of key
positions, its new K/V written at ``pos[b] % W`` in place; ssm: its new conv
buffers and state written over its old ones in place).  As in the
reference, empty slots decode too and their positions advance.  Prefill
runs per admitted request with B=1 and ``cache_len=window``; its cache is
copied into the request's slot leaf by leaf (:func:`write_slot`).

Besides the tick counts of the reference, every request carries host-clock
stamps (``t_submit``, ``t_first``, ``t_done``; the device is synchronised
by reading the token) and ``timings`` sums the host-clock seconds spent in
prefill and in decode.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import monitor as mon
from repro_torch.core.tiles import TilePlan, default_plan
from repro_torch.device import DeviceSpec, resolve
from repro_torch.models.params import tree_leaves
from repro_torch.models.transformer import LM


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (S,) int32
    max_new: int = 16
    submitted_tick: int = 0
    first_token_tick: Optional[int] = None
    done_tick: Optional[int] = None
    out: List[int] = field(default_factory=list)
    t_submit: Optional[float] = None    # host clock (time.perf_counter)
    t_first: Optional[float] = None
    t_done: Optional[float] = None

    @property
    def rtt(self) -> Optional[int]:
        """Dispatch->first-data ticks (the paper's round-trip-time)."""
        if self.first_token_tick is None:
            return None
        return self.first_token_tick - self.submitted_tick


def write_slot(cache, slot: int, one) -> None:
    """Copy a B=1 prefill cache ``one`` into row ``slot`` of the batched
    ``cache``, leaf by leaf (every leaf's batch axis is 1, ``pos``'s 0),
    casting to the cache's dtypes."""
    for key, stacks in cache.items():
        if key == "pos":
            stacks[slot] = one["pos"][0]
            continue
        for stack, new in zip(tree_leaves(stacks, torch.is_tensor),
                              tree_leaves(one[key], torch.is_tensor)):
            stack[:, slot] = new[:, 0]


class ServeEngine:
    """Batched decode over fixed slots (continuous-batching-lite).

    ``device=None`` is the CUDA card (raises without one); the weights are
    random, drawn from ``torch.Generator(device).manual_seed(seed)``."""

    def __init__(self, cfg: ArchConfig, *, batch_slots: int = 4,
                 window: int = 256, lm_kwargs: Optional[Dict] = None,
                 plan: Optional[TilePlan] = None, seed: int = 0,
                 device: DeviceSpec = None):
        self.device = resolve(device)
        self.cfg = cfg
        self.lm = LM(cfg, **(lm_kwargs or {}))
        self.plan = plan or default_plan(cfg)
        self.counters = mon.init_counters(self.plan, self.device)
        self.slots = batch_slots
        self.window = window
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = self.lm.init(gen)

        self.tick = 0
        self.queue: List[Request] = []
        self.active: Dict[int, Request] = {}      # slot -> request
        self.cache = self.lm.init_cache(self.slots, window,
                                        device=self.device)
        self.tokens = torch.zeros((self.slots, 1), dtype=torch.long,
                                  device=self.device)
        self.done: List[Request] = []
        self.timings = {"prefill_s": 0.0, "prefill_tokens": 0,
                        "decode_s": 0.0, "decode_steps": 0}

    # ------------------------------------------------------------- lifecycle
    def submit(self, req: Request) -> None:
        req.submitted_tick = self.tick
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    def _admit(self) -> None:
        for slot in range(self.slots):
            if slot in self.active or not self.queue:
                continue
            req = self.queue.pop(0)
            t0 = time.perf_counter()
            prompt = torch.as_tensor(np.asarray(req.prompt)[None, :],  # repro: noqa[TPR001] a request's prompt onto the card at its admission: once a request
                                     dtype=torch.long, device=self.device)
            logits, cache1 = self.lm.prefill(self.params, prompt,
                                             cache_len=self.window)
            tok = int(torch.argmax(logits[0]))  # repro: noqa[TPR001] a prefill's first token goes to its request: the time to first token ends here
            req.t_first = time.perf_counter()
            self.timings["prefill_s"] += req.t_first - t0
            self.timings["prefill_tokens"] += int(prompt.shape[1])
            req.out.append(tok)
            req.first_token_tick = self.tick + 1
            self.counters = mon.charge(
                self.counters, "mem",
                rtt=float(self.tick + 1 - req.submitted_tick))
            write_slot(self.cache, slot, cache1)
            self.tokens[slot, 0] = tok
            self.active[slot] = req

    def step(self) -> None:
        """One decode tick for every slot (empty ones included), under
        ``torch.inference_mode()``: given a trainer's parameters (which
        may require grad) the engine builds no graph and launches its
        kernels as with its own."""
        with torch.inference_mode():
            self._tick()

    def _tick(self) -> None:
        self.tick += 1
        self._admit()
        if not self.active:
            return
        t0 = time.perf_counter()
        logits, self.cache = self.lm.decode_step(self.params, self.cache,
                                                 self.tokens)
        self.tokens = torch.argmax(logits, dim=-1, keepdim=True)  # (slots, 1)
        ntok_host = self.tokens[:, 0].tolist()  # repro: noqa[TPR001] the step's tokens go to their requests: the server's one read a decode step
        now = time.perf_counter()
        self.timings["decode_s"] += now - t0
        self.timings["decode_steps"] += 1
        self.counters = mon.charge(self.counters, "io",
                                   exec_time=float(len(self.active)))
        for slot, req in list(self.active.items()):
            req.out.append(int(ntok_host[slot]))
            if len(req.out) >= req.max_new:
                req.done_tick = self.tick
                req.t_done = now
                self.done.append(req)
                del self.active[slot]

    def run(self, ticks: int) -> List[Request]:
        for _ in range(ticks):
            self.step()
        return self.done

    # -------------------------------------------------------------- metrics
    def stats(self) -> Dict[str, float]:
        rtts = [r.rtt for r in self.done if r.rtt is not None]
        lat = [r.done_tick - r.submitted_tick for r in self.done
               if r.done_tick is not None]
        toks = sum(len(r.out) for r in self.done)
        return {
            "completed": float(len(self.done)),
            "tokens": float(toks),
            "mean_rtt_ticks": float(np.mean(rtts)) if rtts else 0.0,
            "mean_latency_ticks": float(np.mean(lat)) if lat else 0.0,
            "tokens_per_tick": toks / max(self.tick, 1),
        }
