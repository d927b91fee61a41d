"""The paper's own evaluation configuration, in the port's terms.

The ICCD'24 paper evaluates 4x4 tile-based SoCs: 1 CVA6 CPU tile, 1 DDR MEM
tile, 1 auxiliary I/O tile, 11 traffic-generator (TG, dfadd) tiles, and 2
accelerator tiles A1 (near memory) / A2 (far from memory), split into 5
frequency islands (A1, A2, NoC+MEM, TG, CPU+I/O... the paper lists: A1, A2,
NoC interconnect + memory controller, TG cores, CPU, I/O as five islands).

The NoC island DFS range is 10-100 MHz; the other islands 10-50 MHz, in
5 MHz steps.  We keep those numbers verbatim: the perf model treats them as
normalized rate ladders (f / f_max).

This config drives the paper-claims benchmarks (Table I / Fig. 3 / Fig. 4).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple


@dataclass(frozen=True)
class SoCTile:
    name: str
    kind: str                   # cpu | mem | io | tg | acc
    pos: Tuple[int, int]        # 4x4 grid position
    workload: str = ""          # adpcm | dfadd | dfmul | dfsin | gsm
    replication: int = 1        # the paper's K


@dataclass(frozen=True)
class SoCIsland:
    name: str
    tiles: Tuple[str, ...]
    f_min_mhz: int
    f_max_mhz: int
    f_step_mhz: int = 5


# CHStone accelerator characterization used by the perf model.  Arithmetic
# intensity (flops/byte proxy) distinguishes compute-bound (adpcm, dfsin)
# from memory-bound (dfadd, dfmul) accelerators, matching the paper's
# empirical observation; baseline throughputs are Table I's MB/s.
CHSTONE = {
    # name: (baseline_mbps, arithmetic_intensity)
    "adpcm": (1.40, 24.0),     # compute-bound
    "dfadd": (9.22, 0.9),      # memory-bound (paper: empirically memory-bound)
    "dfmul": (8.70, 1.1),      # memory-bound
    "dfsin": (0.33, 60.0),     # strongly compute-bound
    "gsm":   (4.61, 12.0),
}

# Table I resource/throughput data (for validating the replication model).
TABLE_I = {
    # accel: {K: (LUT, FF, BRAM, DSP, thr_mbps)}
    "adpcm": {1: (10899, 11720, 25, 81, 1.40), 2: (16455, 15158, 48, 162, 2.76), 4: (27313, 21780, 94, 324, 5.41)},
    "dfadd": {1: (11268, 11199, 2, 9, 9.22), 2: (16988, 14090, 2, 18, 16.88), 4: (28599, 19614, 2, 36, 26.06)},
    "dfmul": {1: (8435, 10222, 2, 25, 8.70), 2: (11352, 12136, 2, 50, 15.07), 4: (17382, 15706, 2, 100, 26.06)},
    "dfsin": {1: (16627, 14997, 2, 52, 0.33), 2: (27770, 21686, 2, 104, 0.65), 4: (50043, 34804, 2, 208, 1.24)},
    "gsm":   {1: (9900, 11418, 18, 62, 4.61), 2: (14304, 14520, 34, 124, 8.90), 4: (22927, 20473, 66, 248, 16.67)},
}


def paper_soc(replication_a: int = 4) -> Tuple[List[SoCTile], List[SoCIsland]]:
    """The paper's 4x4 SoC instance (Fig. 2 floorplan, Sec. III)."""
    tiles: List[SoCTile] = [
        SoCTile("CPU", "cpu", (0, 0)),
        SoCTile("MEM", "mem", (1, 0)),
        SoCTile("IO", "io", (0, 3)),
        SoCTile("A1", "acc", (1, 1), workload="dfsin", replication=replication_a),
        SoCTile("A2", "acc", (3, 3), workload="gsm", replication=replication_a),
    ]
    # 11 TG tiles (dfadd, memory-bound) fill the remaining positions.
    taken = {t.pos for t in tiles}
    i = 0
    for r in range(4):
        for c in range(4):
            if (r, c) in taken:
                continue
            tiles.append(SoCTile(f"TG{i}", "tg", (r, c), workload="dfadd"))
            i += 1
    islands = [
        SoCIsland("A1", ("A1",), 10, 50),
        SoCIsland("A2", ("A2",), 10, 50),
        SoCIsland("NOC_MEM", ("NOC", "MEM"), 10, 100),
        SoCIsland("TG", tuple(f"TG{j}" for j in range(11)), 10, 50),
        SoCIsland("CPU_IO", ("CPU", "IO"), 10, 50),
    ]
    return tiles, islands
