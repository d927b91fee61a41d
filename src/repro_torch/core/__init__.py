"""Vespa core: the paper's three contributions as composable modules.

C1 multi-replica tiles   -> tiles.py + replication.py
C2 DFS frequency islands -> islands.py + dfs.py + voltage.py
C3 run-time monitoring   -> monitor.py
supporting models        -> noc.py + perfmodel.py, the sweep -> dse.py

Names are re-exported lazily: ``from repro_torch.core import grid_sweep``
imports ``core/dse.py`` then, not when the package is imported.
"""
from repro_torch._lazy import lazy_exports

_EXPORTS = {
    **dict.fromkeys(("TilePlan", "TileSpec", "MONITOR_KINDS", "default_plan",
                     "validate_plan"), "tiles"),
    **dict.fromkeys(("init_counters", "charge", "charge_boundary",
                     "manual_reset", "MonitorClient"), "monitor"),
    **dict.fromkeys(("replication_area_model",
                     "replication_throughput_model", "TILE_LOGICAL_AXES",
                     "make_mra_mesh", "mra_rules", "merged_rules",
                     "data_axes"), "replication"),
    **dict.fromkeys(("IslandConfig", "IslandSpec", "RateLadder",
                     "TILE_LADDER", "NOC_LADDER", "default_islands",
                     "validate_islands", "resync_boundaries"), "islands"),
    **dict.fromkeys(("TechModel", "tech_axis_coeffs", "dvfs_bounds",
                     "TECH_NODES", "TECH_VARIANTS"), "voltage"),
    **dict.fromkeys(("ActuatorState", "DFSActuator", "TileTelemetry",
                     "policy_memory_bound", "policy_straggler",
                     "PIDRatePolicy", "policy_energy_per_token",
                     "policy_energy_per_token_sweep",
                     "BatchMemoryBoundPolicy", "BatchPIDRatePolicy",
                     "BatchEWMAUtilizationPolicy"), "dfs"),
    **dict.fromkeys(("NocConfig", "NocModel", "Flow", "RoutingTables",
                     "routing_tables", "hops_batch", "stacked_incidence",
                     "flow_incidence", "link_loads_batch",
                     "route_max_utilization", "contention_slowdown",
                     "positions_to_indices"), "noc"),
    **dict.fromkeys(("SoCPerfModel", "AccelWorkload", "chip_power",
                     "chip_power_coeffs", "DeviceSpec", "H100_SXM",
                     "RooflineTerms", "roofline_from_counts", "model_flops",
                     "PEAK_FLOPS", "HBM_BW", "ICI_BW"), "perfmodel"),
    **dict.fromkeys(("ChunkedSweepResult", "ClosedLoopScore", "DesignPoint",
                     "SweepResult", "closed_loop_score", "grid_sweep",
                     "pareto_front", "pareto_front_bruteforce",
                     "pareto_front_indices", "sweep_replication_roofline",
                     "sweep_soc", "summarize", "summarize_result"), "dse"),
}

__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
