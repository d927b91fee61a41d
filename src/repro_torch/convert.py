"""Carrying state across: plain NumPy values -> the port's objects.

The "parameters" of this system are the stacked platform arrays, the sweep's
objective arrays and the controller state, and for the LLM stack the model
weights and the KV cache.  These functions take **NumPy
arrays and plain Python values only** (a dict per object) and build the
port's objects from them, so state produced elsewhere — by the reference
package, a file, another process — can be replayed through the port.  Nothing
here imports the reference package; whoever holds its objects reads the
fields off them into the dict (the tests carry that small helper).
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.dse import SweepResult
from repro_torch.core.islands import IslandConfig, IslandSpec, RateLadder
from repro_torch.core.noc import NocConfig
from repro_torch.core.perfmodel import AccelWorkload, SoCPerfModel
from repro_torch.device import DeviceSpec, resolve
from repro_torch.sim.batch import BatchSimPlatform
from repro_torch.sim.control import BatchControllerHarness, ControllerHarness
from repro_torch.sim.engine import SimPlatform
from repro_torch.sim.flows import FlowPattern


def model_from_numpy(d: Mapping) -> SoCPerfModel:
    """``d["noc"]`` holds the ``NocConfig`` fields; the other keys are the
    model scalars of ``SoCPerfModel`` (all optional, defaults apply)."""
    noc = dict(d.get("noc", {}))
    for key in ("rows", "cols"):
        if key in noc:
            noc[key] = int(noc[key])
    if "torus" in noc:
        noc["torus"] = bool(noc["torus"])
    kw = {k: float(d[k]) for k in
          ("mem_service", "tg_demand", "tg_demand_fig4", "own_demand",
           "hop_latency_share") if k in d}
    if "mem_pos" in d:
        kw["mem_pos"] = tuple(int(x) for x in d["mem_pos"])
    return SoCPerfModel(noc=NocConfig(**noc), **kw)


def islands_from_numpy(d: Mapping) -> IslandConfig:
    """``d["islands"]``: a sequence of dicts with ``name``, ``tiles``,
    ``ladder`` (``f_min_mhz, f_max_mhz, f_step_mhz``), ``rate``, ``fixed``;
    ``d["version"]`` optional."""
    specs = tuple(
        IslandSpec(name=str(i["name"]),
                   tiles=tuple(str(t) for t in i["tiles"]),
                   ladder=RateLadder(*(int(x) for x in i["ladder"])),
                   rate=float(i.get("rate", 1.0)),
                   fixed=bool(i.get("fixed", False)))
        for i in d["islands"])
    return IslandConfig(specs, version=int(d.get("version", 0)))


def flows_from_numpy(d: Optional[Mapping]) -> Optional[FlowPattern]:
    """``stages`` / ``dests`` / ``demand`` of a flow pattern, or ``None``."""
    if d is None:
        return None
    return FlowPattern(
        stages=tuple(tuple(str(t) for t in s) for s in d.get("stages", ())),
        dests=tuple((str(a), str(b)) for a, b in d.get("dests", ())),
        demand=tuple((str(a), float(v)) for a, v in d.get("demand", ())))


def platform_from_numpy(d: Mapping) -> BatchSimPlatform:
    """Stacked platform: ``names``, the island structure (see
    :func:`islands_from_numpy`), ``base_mbps/wire_share/k/pos_idx/req_mb``
    ``(B, A)``, ``rates`` ``(B, I)``, ``f_tg`` ``(B,)``, ``n_tg``, ``model``
    (see :func:`model_from_numpy`) and optional ``flows``."""
    f64 = np.float64

    def arr(key, dtype=f64):
        return np.array(d[key], dtype=dtype)

    plat = BatchSimPlatform(
        model=model_from_numpy(d["model"]), islands=islands_from_numpy(d),
        names=tuple(str(n) for n in d["names"]),
        base_mbps=arr("base_mbps"), wire_share=arr("wire_share"),
        k=arr("k"), pos_idx=arr("pos_idx", np.int64), req_mb=arr("req_mb"),
        rates=arr("rates"), f_tg=arr("f_tg"), n_tg=int(d["n_tg"]),
        flows=flows_from_numpy(d.get("flows")))
    if plat.k.ndim != 2:
        raise ValueError(f"k must be (B, A), got shape {plat.k.shape}")
    B, A = plat.k.shape
    want = {"base_mbps": (B, A), "wire_share": (B, A), "pos_idx": (B, A),
            "req_mb": (B, A), "rates": (B, len(plat.islands.islands)),
            "f_tg": (B,)}
    for name, shape in want.items():
        if getattr(plat, name).shape != shape:
            raise ValueError(f"{name} has shape {getattr(plat, name).shape},"
                             f" expected {shape}")
    if len(plat.names) != A:
        raise ValueError(f"{len(plat.names)} tile names for {A} tiles")
    return plat


def sim_platform_from_numpy(d: Mapping) -> SimPlatform:
    """One design: ``names``, the island structure and rates (see
    :func:`islands_from_numpy`), ``base_mbps/wire_share/k/pos_idx/req_mb``
    ``(A,)``, ``f_tg`` and ``n_tg`` (scalars), ``model`` (see
    :func:`model_from_numpy`) and optional ``flows``."""
    def arr(key, dtype=np.float64):
        return np.array(d[key], dtype=dtype)

    plat = SimPlatform(
        model=model_from_numpy(d["model"]), islands=islands_from_numpy(d),
        names=tuple(str(n) for n in d["names"]),
        base_mbps=arr("base_mbps"), wire_share=arr("wire_share"),
        k=arr("k"), pos_idx=arr("pos_idx", np.int64), req_mb=arr("req_mb"),
        n_tg=int(d["n_tg"]), f_tg=float(d["f_tg"]),
        flows=flows_from_numpy(d.get("flows")))
    A = len(plat.names)
    for name in ("base_mbps", "wire_share", "k", "pos_idx", "req_mb"):
        if getattr(plat, name).shape != (A,):
            raise ValueError(f"{name} has shape {getattr(plat, name).shape},"
                             f" expected {(A,)}")
    return plat


def sweep_result_from_numpy(d: Mapping) -> SweepResult:
    """Dense sweep result: ``axes`` (sequence of ``(name, values)``),
    ``shape``, ``workloads`` (sequence of ``(name, base_mbps, ai)``),
    ``n_tg`` and the flat objective arrays."""
    def values(name, vals):
        if name.startswith("pos:"):
            return tuple(tuple(int(x) for x in p) for p in vals)
        if name == "tech":
            return tuple((int(n), str(v)) for n, v in vals)
        if name.startswith("K:"):
            return tuple(int(v) for v in vals)
        return tuple(float(v) for v in vals)

    axes = tuple((str(n), values(str(n), v)) for n, v in d["axes"])
    shape = tuple(int(x) for x in d["shape"])
    if shape != tuple(len(v) for _, v in axes):
        raise ValueError(f"shape {shape} does not match the axes' lengths")
    n = int(np.prod(shape, dtype=np.int64))
    out = {}
    for key in ("throughput", "area", "energy_per_unit", "mem_traffic"):
        out[key] = np.array(d[key], dtype=np.float64).ravel()
        if out[key].shape != (n,):
            raise ValueError(f"{key} has {out[key].size} entries for a "
                             f"grid of {n} points")
    return SweepResult(
        axes=axes, shape=shape,
        workloads=tuple(AccelWorkload(str(nm), float(b), float(ai))
                        for nm, b, ai in d["workloads"]),
        n_tg=int(d["n_tg"]), valid=np.array(d["valid"], dtype=bool).ravel(),
        elapsed_s=float(d.get("elapsed_s", 0.0)),
        backend=str(d.get("backend", "numpy")), **out)


def controller_state_from_numpy(harness: BatchControllerHarness,
                                d: Mapping) -> BatchControllerHarness:
    """Load carried controller state into ``harness`` (in place): ``rates``,
    ``guard_active``, ``swaps``, ``versions`` and the policy's own state —
    PID ``integral`` / ``prev_err``, EWMA ``ewma`` (absent or ``None`` = the
    policy has not sampled yet)."""
    B, I = harness.rates.shape
    rates = np.array(d["rates"], dtype=np.float64)
    if rates.shape != (B, I):
        raise ValueError(f"rates has shape {rates.shape}, the harness "
                         f"controls {(B, I)}")
    harness.rates = rates
    harness._guard_active = np.array(d["guard_active"], dtype=bool)
    harness.swaps = np.array(d["swaps"], dtype=np.int64)
    harness.versions = np.array(d["versions"], dtype=np.int64)
    pol = harness.policy

    def opt(key):
        v = d.get(key)
        return None if v is None else np.array(v, dtype=np.float64)

    if hasattr(pol, "_integral"):
        pol._integral, pol._prev_err = opt("integral"), opt("prev_err")
    if hasattr(pol, "_ewma"):
        pol._ewma = opt("ewma")
    return harness


def harness_state_from_numpy(harness: ControllerHarness,
                             d: Mapping) -> ControllerHarness:
    """Load one design's carried controller state into the scalar
    ``harness`` (in place): the actuator's live config ``live`` (the
    :func:`islands_from_numpy` form, its ``version`` included), ``swaps``,
    ``history`` (a sequence of ``(version, {island: rate})``, oldest first,
    kept within the actuator's bound), ``guard_active`` (island names) and
    the policy's own state — :class:`~repro_torch.core.dfs.PIDRatePolicy`'s
    ``integral`` / ``prev_err`` (``{island: value}``; absent = none yet)."""
    live = islands_from_numpy(d["live"])
    if live.names() != harness.live().names():
        raise ValueError(f"islands {live.names()} do not match the "
                         f"harness's {harness.live().names()}")
    st = harness.actuator._st
    st.live, st.shadow = live, None
    st.swaps = int(d["swaps"])
    st.history.clear()
    st.history.extend((int(v), {str(k): float(r) for k, r in rates.items()})
                      for v, rates in d.get("history", ()))
    harness._guard_active = {str(n) for n in d.get("guard_active", ())}
    pol = harness.policy
    if hasattr(pol, "_integral"):
        pol._integral = {str(k): float(v)
                         for k, v in (d.get("integral") or {}).items()}
        pol._prev_err = {str(k): float(v)
                         for k, v in (d.get("prev_err") or {}).items()}
    return harness


def _tensor(a, device: torch.device) -> torch.Tensor:
    """One array -> tensor in the same dtype.  bfloat16 arrays (NumPy sees
    them as ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses) go
    through float32, which holds every bfloat16 value exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def lm_params_from_numpy(tree: Any, device: DeviceSpec = None):
    """The reference's LM parameter pytree, as NumPy arrays (nested dicts /
    lists), -> the port's parameter dict (same keys, same stacked layout,
    same dtypes) on ``device``."""
    dev = resolve(device)
    if isinstance(tree, Mapping):
        return {k: lm_params_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(lm_params_from_numpy(v, dev) for v in tree)
    return _tensor(tree, dev)


def adamw_state_from_numpy(state: Any, device: DeviceSpec = None):
    """The reference's ``AdamWState(step, mu, nu)``, its arrays as NumPy,
    -> the port's ``optim.adamw.AdamWState`` on ``device``: ``step`` an
    int32 scalar tensor, ``mu`` / ``nu`` leaf for leaf in float32."""
    from repro_torch.optim.adamw import AdamWState
    dev = resolve(device)
    step, mu, nu = state
    return AdamWState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=dev),
        mu=lm_params_from_numpy(mu, dev), nu=lm_params_from_numpy(nu, dev))


def lm_cache_from_numpy(d: Mapping, device: DeviceSpec = None):
    """A reference LM cache ``{"pos": scalar or (B,), "blocks": ...}`` -> the
    port's cache, whose ``pos`` is one int32 position per batch row.
    ``blocks`` is ``(k, v)`` with ``k``/``v`` ``(L, B, W, KV, hd)`` (dense
    and moe), or a dict of leaves ``(L, B, ...)`` (ssm and hybrid:
    ``conv_x``, ``conv_B``, ``conv_C``, ``state``); a hybrid cache also has
    ``shared_attn``, ``(k, v)`` of shape ``(n_apps, B, W, KV, hd)``.  A moe
    cache with dense prelude layers has ``prelude``, a list of one ``(k, v)``
    of shape ``(B, W, KV, hd)`` per prelude layer; the port keeps no list:
    the prelude's layers are folded in front of ``blocks``, which then
    covers all ``n_layers``.  Leaves are carried one by one in their
    dtypes."""
    dev = resolve(device)

    def leaves(tree):
        if isinstance(tree, Mapping):
            return {k: _tensor(a, dev) for k, a in tree.items()}
        return tuple(_tensor(a, dev) for a in tree)

    out = {k: leaves(d[k]) for k in ("blocks", "shared_attn") if k in d}
    if d.get("prelude"):
        pre = [leaves(c) for c in d["prelude"]]
        out["blocks"] = tuple(
            torch.cat([torch.stack([c[j] for c in pre]), out["blocks"][j]])
            for j in range(2))
    blocks = out["blocks"]
    B = (next(iter(blocks.values())) if isinstance(blocks, dict)
         else blocks[0]).shape[1]
    out["pos"] = torch.tensor(np.asarray(d["pos"]), dtype=torch.int32,
                              device=dev).expand(B).contiguous()
    return out
