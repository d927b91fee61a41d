"""Closed-loop SoC simulation of the port: batched traffic replay + online
DFS.

engine.py    — the shared numeric core: SimPlatform (one design in array
               form), TickState/StepConsts/tick_step on tensors, latency
               percentile reconstruction (per design and batched), and
               SimEngine/SimResult: one design replayed with the scalar DFS
               controller and the load balancer in the loop
batch.py     — B design points co-simulated as ONE tensor program
               ((B, A) state, stacked incidence, vectorized DFS commits);
               backends "torch" (float64 ground truth) and "fused" (the
               hand-written CUDA tick kernel)
flows.py     — FlowPattern: tile-to-tile streams + accelerator chains,
               compiled per design into incidence/hop/forward arrays
traffic.py   — composable arrival-trace generators (constant, Poisson,
               diurnal, MMPP-bursty, replay); BatchTrace per-design tensors
control.py   — ControllerHarness (scalar policies through the dual-buffer
               DFSActuator), the vectorized multi-design
               BatchControllerHarness, and the LoadBalancer (admission
               across replicated tiles, split on the engine's device)
faults.py    — FaultSchedule (tile/island kills, link degradation, stuck
               actuators) compiled to per-tick availability/scale masks
               the tick loop consumes on its device, plus SLOConfig
               (deadline drops, bounded retry of stranded work)

Names are re-exported lazily (imported on first use).
"""
from repro_torch._lazy import lazy_exports

_EXPORTS = {
    **dict.fromkeys(("SimConfig", "SimEngine", "SimPlatform", "SimResult",
                     "StepConsts", "TickOut", "TickState",
                     "latency_percentiles",
                     "latency_percentiles_batch", "percentile_samples",
                     "tick_step", "weighted_percentiles"), "engine"),
    **dict.fromkeys(("BatchSimEngine", "BatchSimPlatform",
                     "BatchSimResult"), "batch"),
    **dict.fromkeys(("BatchControllerHarness", "BatchSample",
                     "ControlAction", "ControllerHarness", "IslandTopology",
                     "LoadBalancer"), "control"),
    **dict.fromkeys(("CompiledFaults", "FaultSchedule", "IslandKill",
                     "LinkDegrade", "SLOConfig", "StuckRate", "TileKill",
                     "compile_faults", "respill_stranded"), "faults"),
    **dict.fromkeys(("CompiledFlows", "FlowPattern", "compile_flows"),
                    "flows"),
    **dict.fromkeys(("BatchTelemetry", "RingBuffer", "Telemetry",
                     "TelemetrySchema"), "telemetry"),
    **dict.fromkeys(("BatchTrace", "Trace", "constant_trace",
                     "diurnal_trace", "mmpp_trace", "poisson_trace",
                     "replay_trace", "superpose", "with_total"), "traffic"),
}

__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
