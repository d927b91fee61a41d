#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --quick    # device, build, kernel parity only
    python3 chip_smoke.py --serve-only   # ... and the five serving paths
    python3 chip_smoke.py --train-only   # ... and the training paths
    python3 chip_smoke.py --shard-only   # ... the sweep, the main path and
                                         # the two multi-device phases
    python3 chip_smoke.py --mesh-only    # ... train_mesh
    python3 chip_smoke.py --families-only  # ... mesh_families
    python3 chip_smoke.py --analysis-only  # ... the moe / MLA serving
                                           # paths, mesh_families, analysis
    python3 chip_smoke.py --ptxas    # also nvcc's registers / spills

Builds the port's CUDA kernels from the sources in this checkout, holds each
kernel against its plain PyTorch version on the card, and drives the port's
main path through its public entry points at the size its users run:

1. ``device``    — the card (``nvidia-smi``), torch / CUDA versions.
2. ``build``     — compiles ``src/repro_torch/kernels/csrc/*.cu`` into
                   ``build/``; seconds.
3. ``kernels``   — ``fused_tick_sim`` (kernel) vs ``fused_tick_sim_plain``
                   over the control kinds and options at small shapes with
                   ragged batch sizes, A = 1, 2, 3, 5, 12, 16 (every lane
                   group of the kernel); floats rtol/atol 1e-4, swaps and
                   guard exact.  Then ``llm_kernels`` (each LLM kernel vs
                   its plain version at edge shapes) and ``card_tests``
                   (every case of every gpu-marked pytest test, which
                   cannot run here: this machine has no jax).
4. ``sweep``     — the dense 1.73 M-point joint sweep on the card, checked
                   against the host NumPy float64 evaluation of the same grid
                   (objectives <= 1e-9 rel, same Pareto set); the Pareto
                   prefilter's time on the card (``prefilter_s``), the exact
                   scan over its candidates (``pareto_host_s``) and, as a
                   yardstick, over every valid point (``pareto_exact_scan_s``,
                   which must give the same set).
   ``sweep_chunked`` — the chunked streaming sweep on the card: the
                   20,194,758-point independent-islands grid of
                   ``benchmarks/bench_dse.py`` (chunk 2,000,000) against the
                   host NumPy chunked sweep (n_valid, Pareto set, top-10 of
                   each tracked objective), then the 242,337,096-point soak
                   of ``tests/test_dse_islands.py`` (chunk 4,000,000) alone:
                   points/s, chunks, ``peak_chunk_bytes``, the device's own
                   peak, the top survivor against the scalar model (1e-9)
                   and the same Pareto set at chunk 3,000,000.
5. ``main_path`` — ``closed_loop_score`` on the sweep's top 4,096 survivors,
                   an 8,700-tick diurnal trace, PID controllers in the loop,
                   ``backend="fused"``; again under the 45 nm tech model; a
                   64-design cross-check against the float64 ``"torch"``
                   backend, whose telemetry must equal the same run's on the
                   CPU (rel <= 1e-12) with no host sync inside a row; the
                   percentiles of 64 designs bit for bit against NumPy
                   (``percentiles_ms``); the float32 ``"torch"`` loop at the
                   full size beside ``"fused"`` (rtol 2e-3 / atol 1e-2) and
                   on the 64 designs (the float64 ranking, swaps exact); the
                   kernel against its plain version at exactly these shapes,
                   with times and cycles per tick.
6. ``main_path_a12`` — 1,024 stacked twelve-tile platforms with a two-stage
                   chain and memory-bound DFS, 5,000 ticks, ``"fused"``; the
                   kernel against its plain version at these shapes.
   ``shard_main_path`` — ``devices=`` on the main path with the forced
                   device count at 4, every shard on this card (the wall
                   times at N = 1 and 4 are the split's price on one card,
                   not a multi-GPU speed): the 1.73 M dense and 20.2 M
                   chunked sweeps, rerank-A2 (``closed_loop_score``) and
                   the A12 chain at ``devices=4`` against ``devices=1``,
                   bit for bit (sets, top-k, completed, energy, swaps,
                   p50 / p99), ``tick_sim`` launched once a shard; a
                   63-design float64 loop with the plane (stall counts
                   exact, the rest within 1e-12), the syncs of each
                   shard's tick loop the unsharded loop's; two planted
                   faults (shards out of order, a pad left on) that the
                   check must reject.
   ``collectives`` — 4 gloo ranks spawned on this card (``--collectives-
                   rank``, a file store, each with a time limit):
                   ``pipeline_apply`` forward and gradient against the
                   sequential composition, ``compressed_allreduce`` against
                   the exact sum, one granite-moe-1b-a400m MoE layer at full
                   width on a (data 2, model 2) mesh, expert-TP and EP, f32
                   and bf16, against the one-rank layer (and EP's drops
                   where the buckets overflow against a plain count),
                   ``device_put_batch``; the backend and device of every
                   collective call, which must all be CUDA tensors.
   ``closed_loop`` — ``examples/torch_closed_loop.py``'s default scenario
                   through the sequential ``SimEngine``: the 12-tile
                   platform, 1,000,000 requests over 8,700 ticks of 5 ms,
                   fixed-max / membound / PID; the example's gates (>= 10 %
                   energy per request at matched p99); fixed-max and
                   membound against the same runs on the CPU (energy,
                   completed, dropped <= 1e-12; p50, p99, swaps and commits
                   exact); the fixed-max tick loop under sync-debug "error",
                   the controlled runs' syncs counted (at most one per
                   control tick); ticks/s and requests/s of wall time.
   ``closed_loop_pipeline`` — ``--pipeline``: the chained 3+3 platform,
                   fixed / DFS-only / LB-only / LB+DFS, the scenario gate;
                   LB+DFS against the CPU; syncs in the four tick loops at
                   most the two controlled runs' control ticks.
   ``closed_loop_dse`` — ``--dse``: ``closed_loop_score`` through
                   ``controller_factory=`` (one ``SimEngine`` per survivor),
                   the ranking equal to the CPU run's; the example's six
                   survivors all score the same, so a wider re-rank (24
                   survivors, 300 ticks) whose scores differ is held to the
                   CPU's too.
   ``closed_loop_b1_fused`` — membound and PID at B = 1 through
                   ``BatchSimEngine("fused")`` (the tick_sim kernel) against
                   the sequential float64 runs: energy per request and p99
                   within rtol 2e-3, swaps printed.
   ``closed_loop_faults`` — ``--faults``: the replica-kill scenario (3+3
                   pipeline, 2,000 ticks, be1 dead on [900, 1,300), 50 ms
                   deadline), five runs, the example's gate; each against
                   the CPU (ledgers within 1e-15, p99 / events / detection
                   tick exact); no sync in an open-loop tick loop, one per
                   control tick with DFS; ticks/s and launches per tick
                   against the fault-free runs.
   ``rerank_faults`` — ``closed_loop_score`` on the float64 ``"torch"``
                   loop at the main path's size with a stuck island, a
                   degraded MEM link, a 20 ms deadline and a 2 % drop
                   budget, beside the fault-free call; 64 designs' drop
                   rate, p99 and order equal to the CPU's; the float32
                   loop at that size within the float32 limits.
   ``fused_refuses_faults`` — ``"fused"`` refuses faults / SLO on the card
                   and launches nothing.
   ``observe``   — the monitoring plane (``observe=``) on those paths:
                   closed-loop-12tile-1M (membound, its first 2,900 ticks)
                   at off / ``"counters"`` / ``"full"`` in turns — outputs
                   bit for bit equal, syncs in the
                   tick loop unchanged, ticks/s and kernels per tick, the
                   plane's reconstruction and ``export_metrics`` timed, the
                   plane within 1e-12 of the CPU run's (stall counts exact;
                   a check that must reject planted faults) and the trace
                   the CPU's JSONL; the faults pipeline (DFS + recovery +
                   detector, and open loop with no sync at all) the same
                   way; rerank-A2 with ``observe="counters"`` on the
                   float64 and float32 ``"torch"`` loops beside the
                   unobserved calls (loop s, finalize s, device peak
                   memory), 64 designs' planes against the CPU's;
                   ``"fused"`` refusing; the chunked sweep's
                   ``sweep_chunk`` phases timed by CUDA events.
7. ``serve``     — the dense LLM serving path: ``ServeEngine`` on
                   h2o-danube-1.8b at full width (random bf16 weights from a
                   seed), 4 slots, a 4,096 window, 8 requests of 128-4,608
                   prompt tokens and 32 new tokens each, through the
                   ``flash_attention`` / ``flash_decode`` /
                   ``fused_rmsnorm_mlp`` kernels; TTFT per request, prefill
                   and decode tokens/s, peak memory; then the run held
                   against the plain path on the card (teacher-forced
                   logits), and each kernel against its plain version at the
                   path's shapes, with times beside the bound and SDPA
                   (both graph-timed) and, for the MLP, cuBLAS on the same
                   products; the prefill kernels must run their Hopper
                   (``wgmma_tma``) variant there, the decode MLP its
                   ``gemv_tma`` kernel (timed beside the ``rows`` kernel)
                   and decode its ``cp_async`` sweep (timed beside the
                   ``cuda_cores`` sweep; at one slot, its rule's split
                   beside ``kv_block``).
                   Attention is held per output row as well, relative to the
                   row's scale, and that check must reject planted faults
                   (zero output, a dropped split or key tile, a window one
                   key short) made with the plain version; the bf16 MLP
                   within max(5e-2, one bf16 ulp of |ref|), which must
                   reject its planted faults (a dropped k range of a strip,
                   a strip left at zero, gate and up swapped) and pass the
                   inputs on which the constant limit once failed.
8. ``serve_ssm`` — the Mamba-2 serving path: ``ServeEngine`` on mamba2-370m
                   at full width and depth (random bf16 weights from a
                   seed), 4 slots, 8 requests of 2-16,384 prompt tokens (a
                   2-token prompt, a ragged single chunk, chunk padding, a
                   64-chunk prompt; two waves) and 32 new tokens each,
                   through the ``ssd_scan`` kernel (``ssm_backend="fused"``);
                   TTFT per request, prefill and decode tokens/s, peak
                   memory, launches; the run held against the plain path
                   (``ssm_backend="torch"``, teacher forced); a profile of a
                   decode step and of the 16,384-token prefill
                   (``serve_ssm_profile``); and ``ssd_scan`` against its
                   plain version at the path's shapes (``serve_ssm_kernels``:
                   per element and per (batch, head) within 1e-4, times by
                   kernel, both bounds, the ``cuda_cores`` kernels beside; the
                   ``tf32x3`` kernels must run), a check that must reject
                   planted faults (the
                   state carry dropped at one chunk boundary, the D term
                   left out, the decay shifted by one position, the first
                   super-diagonal let through the mask).
9. ``serve_hybrid`` — the hybrid serving path: ``ServeEngine`` on zamba2-7b
                   at full width and depth (81 Mamba-2 blocks, the shared
                   attention + MLP tile at 14 sites, head dim 112; random
                   bf16 weights from a seed), 4 slots, a 4,096 window, 8
                   requests of 1-4,608 prompt tokens (one token, shorter
                   than the conv, a ragged chunk, padded chunks, the
                   window exactly, across it) and 32 new each, through all
                   four LLM kernels (attention and ``ssm_backend``
                   ``"fused"``), each of which must launch at least once
                   per block or site and prefill or step; TTFT, tokens/s,
                   peak memory; teacher forced against the plain path;
                   ``serve_hybrid_profile``; ``serve_hybrid_kernels`` (the
                   attention kernels at head dim 112 beside SDPA, the
                   ``wmma`` kernel and the bound, which must run
                   ``wgmma_tma`` / ``cp_async``; the MLP at d 3,584 and F
                   14,336, ``gelu``; each attention check must also reject
                   a head dim's tail lost) and ``serve_hybrid_ssd_kernels``
                   (``ssd_scan`` at nh 112, st 64).
10. ``serve_moe`` — the moe serving path: ``ServeEngine`` on
                   granite-moe-1b-a400m at full width and depth (24 layers,
                   d 1,024, 32 experts, top 8, expert width 512, head dim
                   64, G 2, causal; random bf16 weights from a seed), 4
                   slots, a 4,096 window, 8 requests of 1-4,608 prompt
                   tokens (one token: 8 of 32 experts hit; one short of the
                   window, the window, across it) and 32 new each, through
                   ``flash_attention`` / ``flash_decode`` (at least once per
                   layer and prefill or step), the expert products through
                   ``torch._grouped_mm`` (``grouped_variant``); TTFT,
                   tokens/s, memory; syncs per decode step (``SyncCount``'s
                   way, the whole step and ``LM.decode_step`` alone, beside
                   the plain path's); teacher forced against the plain path
                   (attention ``naive``, the experts through the per-expert
                   loop); ``serve_moe_profile`` (the MoE's grouped products
                   and its other passes as groups of their own);
                   ``serve_moe_kernels`` (both attention kernels at head dim
                   64 beside SDPA, the older kernels and the bound; they
                   must run ``wgmma_tma`` / ``cp_async``) and
                   ``serve_moe_experts`` (``grouped_matmul`` against the
                   per-expert loop at 36,864, 32 and 8 rows, each product
                   within max(5e-2, one bf16 ulp) and 2e-2 of the largest
                   output, timed beside the loop and the bound; the check
                   must reject two experts' weights swapped and a group end
                   shifted by one row; ``top_k`` on the card equal to the
                   CPU's on tied rows).
11. ``serve_mla`` — the MLA serving path: ``ServeEngine`` on
                   deepseek-v2-lite-16b at full width and depth (27 layers
                   of MLA: latent 512, rope 64, qk head dim 192, v 128; a
                   dense first layer of width 10,944, then 64 experts top 6
                   plus 2 shared; 15.7 B parameters; random bf16 weights
                   from a seed), 4 slots, a 4,096 window, the moe phase's 8
                   prompts (1-4,608 tokens) and 32 new each, through
                   ``flash_attention`` (the expanded prefill, at least once
                   per layer and prefill) and ``fused_rmsnorm_mlp`` (the
                   dense layer, once per prefill and step); decode is the
                   absorbed einsums over the latent cache (no kernel,
                   ``flash_decode`` must not launch); TTFT, tokens/s, held /
                   serving / draw peaks, the latent cache's size; syncs per
                   decode step (0 inside ``LM.decode_step`` or it fails);
                   teacher forced against the plain path; the int8 latent
                   cache (``quant_kv`` on the card equal to the CPU's, an
                   int8 run's logits finite, its tokens' agreement with the
                   bf16 run); ``serve_mla_profile``; ``serve_mla_kernels``
                   (attention at q (1,4608,16,1,192), v 128, causal: the
                   ``wmma`` kernel against its plain version, the planted
                   faults plus the rope's 64 qk columns dropped and a v
                   tail lost, beside the bound and every SDPA backend that
                   takes hd_qk != hd_v; the MLP at d 2,048 / F 10,944 and
                   N 4,608 / 4, ``wgmma_tma`` / ``gemv_tma``, beside cuBLAS
                   and the bound).
12. ``train_mesh`` — danube at full width, cut to 4 layers, through
                   ``Trainer(mesh=)`` on (data 2, model 2), 4 gloo ranks on
                   this card, against the same cut on one device.
13. ``mesh_families`` — every family from placed parameters on (data 2,
                   model 2), 4 gloo ranks on this card: ``flash_decode``
                   with the lse timed at the rank slices; zamba2 (7
                   blocks) and deepseek (3 layers) 2 training steps, and
                   the five families' prefill of 4 slots and 16 decode
                   steps over the window-split cache, each held to the
                   same run on one device (``--families-only``: build, the
                   LLM kernels' parity and this phase).
    ``mesh_mra`` — the paper's multi-replica tile on the LLM stack: danube
                   cut as ``train_mesh`` on (data 1, replica 2, shard 2),
                   the attention tile replicated twice (each replica rank
                   on its own rows, the MLP on its group's over (replica,
                   shard)): 2 training steps against the same cut on one
                   device, the rows each tile ran on, step 1's collectives
                   against the fake mesh's count, a prefill and 8 decode
                   steps against one device, two planted faults
                   (``--mra-only``: build and this phase).
    ``analysis`` — ``repro_torch.analysis`` linted in-process (AST only,
                   against ``analysis/baseline_torch.json``; a new finding
                   fails), then held to the host syncs this run observed:
                   the ``SyncCount(stacks=True)`` blocks of the moe and MLA
                   decode steps, ``mesh_families``' step 1 on each rank, a
                   100-tick sequential PID replay, a chunked sweep (10.1 M
                   points, blocks of 10^6) and the batched ``"torch"`` loop
                   under PID (3 designs, 200 ticks).  Every sync whose
                   innermost ``src/repro_torch`` frame lies in a function
                   the hot scope marks must lie on a line TPR001 flags
                   (new, baselined or noqa'd); the others are counted as
                   ``outside_scope``; one observed site dropped from the
                   flagged lines must come back missed
                   (``--analysis-only``: build, ``serve_moe``,
                   ``serve_mla``, ``mesh_families`` and this phase).
14. ``train_kernels`` — the autograd Functions of ``kernels.ops`` (forward:
                   the kernel; backward: the oracle's autograd) at reduced
                   shapes in bf16 and f32: forward equal to the raw
                   kernel's output, one launch, every input's gradient
                   against autograd through the plain version (f32 within
                   the forward's atol times max(1, max |ref|), bf16 per row
                   within 2e-2), one backward call; planted faults that must
                   be rejected (a backward that zeroes ``dk``, a forward
                   without a launch), the raw wrappers refusing a CUDA input
                   that requires grad, and ``torch._grouped_mm``'s
                   gradients against the per-expert loop's at a granite
                   microbatch (65,536 rows), which must reject one expert's
                   rows zeroed.  At the path's shapes each Function's
                   backward bound (``backward_bound``: the products its
                   gradients need over the live pairs, at 989.4 TFLOP/s
                   bf16, or for the f32 scan the lesser of 3xTF32 tensor
                   cores and 67 TFLOP/s, against its bytes over HBM; the
                   oracle backward's counted FLOPs beside it) and, for
                   attention, SDPA's backward
                   (``sdpa_backward_ms``: forward + backward captured in a
                   CUDA graph less the forward's, causal, ``enable_gqa``).
    ``train`` / ``train_moe`` / ``train_ssm`` — h2o-danube-1.8b,
                   granite-moe-1b-a400m and mamba2-370m at full width and
                   depth (random bf16 weights from a seed) through
                   ``Trainer``: sequences of 4,096, global batch 4 in two
                   microbatches, 6 AdamW steps (lr 6e-4, warm-up 2), remat;
                   the losses, step seconds, tokens/s, MFU (6 N tokens over
                   989.4 TFLOP/s), peak memory, launches and backward calls
                   a step, host syncs inside each step (must be 0), step 1's
                   loss, grad norm and gradient against the plain path's on
                   the same weights and batch, one more step under the
                   profiler (idle share, each Function's backward beside its
                   forward kernel), and the first AdamW step from zero
                   moments on the first microbatch checked as a descent
                   step (``fit_one_batch``), its zero, reversed and
                   misdirected versions rejected, and the step of the
                   reversed gradient rejected by the line.
    ``train_resume`` — the reduced danube in float32 through the kernels:
                   8 steps saving every 5, the state lost,
                   ``FaultSupervisor.recover()`` and 5 more, against an
                   uninterrupted run (1e-5 relative).
15. ``costing`` — the cost model beside the measured paths, re-running
                   none of them: each training step and each serving
                   path's longest prefill and decode step counted on meta
                   inputs (``launch.costing.flops_of_fn``, total and dot),
                   ``model_flops``, ``hbm_bytes``, the roofline terms on
                   ``H100_SXM`` at one card, the measured seconds,
                   ``t_bound / measured``, MFU (the training phase's own,
                   equal to 1e-9) and counted-FLOP utilisation; counting a
                   ``flash_attention`` launch on the card must raise and
                   launch nothing; the dry run's single-pod cells
                   (``launch.dryrun.run_cell``, abstract, every assigned
                   architecture; in a process of its own, started after
                   the main path) must all pass.

Each phase prints one JSON line, with ``t_s``: the seconds since the
script started.  The line before the last but one is
``{"kernels": [...]}`` with, per kernel, its launches on its main path, its
error against the plain version, its time, the plain version's time, the
library call's time where one PyTorch call computes the same function, and
the least time the card could take for the same work (the larger of bytes
over 3.35 TB/s and operations over the peak for their type: 67 TFLOP/s
float32 for ``tick_sim``, 989.4 TFLOP/s bf16 for the attention and MLP
kernels; for ``ssd_scan`` the lesser of its products on TF32 tensor cores,
three passes at 494 TFLOP/s, with the rest at 67 (``bound_tc_ms``), and
all of it at 67 (``bound_f32_ms``); published H100 SXM figures); each LLM
kernel's row carries the hybrid path's as ``hybrid``, the attention
rows the moe path's as ``moe``, and the attention and MLP rows the MLA
path's as ``mla``, each with its own launches, and the attention, MLP and
SSD rows the training paths' as ``train`` (launches, backward calls, each
run's forward ms a launch and backward ms a call beside the backward's
bound and, for attention, SDPA's backward; the row's ``launches`` are the
sum over the serving and training paths and the two mesh phases, each
also apart), and ``flash_decode``'s its calls with the lse as ``lse``
(their launches in ``mesh_families``, times at the rank slices).  The
line before the last is the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Any failure exits with a non-zero code; without a CUDA device the
script stops at once.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

try:        # the card's published rates, one source for every bound
    from repro_torch.core.perfmodel import H100_SXM
except ImportError as e:
    print(f"chip_smoke: the repository's src/repro_torch is missing ({e}); "
          "run from the root of a checkout", file=sys.stderr)
    sys.exit(2)

H100_BYTES_PER_S = H100_SXM.hbm_bw      # HBM3
H100_FP32_PER_S = H100_SXM.fp32_flops   # float32 outside the tensor cores
H100_BF16_PER_S = H100_SXM.peak_flops   # bf16 tensor cores, dense
RTOL = ATOL = 1e-4              # kernel vs plain version (same float32 math)
SEED = 1234
DEV = "cuda"

# kernel_T: the ticks of each tick_sim parity case (10 control intervals;
# cut from 500 for the script's 1,200 s limit: the plain version's Python
# loop over the ticks is most of the kernels phase)
SIZES = {"kernel_T": 250, "kernel_big_B": 1000,
         "main_B": 4096, "main_T": 8700, "check_T": 2000,
         "a12_B": 1024, "a12_T": 5000, "reps": 5}

# The serving phase: h2o-danube-1.8b at full width (src/repro_torch/configs/
# h2o_danube_1_8b.py); the 4,608-token prompts cross the 4,096 window.
SERVE = {"arch": "h2o-danube-1.8b", "slots": 4, "window": 4096,
         "prompts": (128, 512, 1024, 2048, 3072, 4608, 256, 4608),
         "max_new": 32, "reps": 10}
# kernel vs plain version, abs error (tests/test_kernels.py: f32 2e-5;
# bf16 3e-2 attention, 5e-2 MLP)
LLM_ATOL = {("attention", torch.float32): 2e-5,
            ("attention", torch.bfloat16): 3e-2,
            ("mlp", torch.float32): 2e-5, ("mlp", torch.bfloat16): 5e-2}
# The MLP's bf16 outputs are rounded to bf16 by both versions, and one ulp
# of an output of 8 or more (2^-4 at 8-16) is more than 5e-2: two right
# answers a rounding apart differ by that ulp.  So an MLP output in bf16 is
# held to max(5e-2, one bf16 ulp of |ref|) (``mlp_limit``): the same 5e-2
# below 8, one ulp above.
ULP_AWARE = {("mlp", torch.bfloat16)}
# attention kernel vs plain version, per output row (one query head of one
# query, over its head dim): max |out - ref| over max |ref| of the row.  The
# absolute limits hold rows of O(1) outputs; a row over n live keys of unit
# values outputs about sqrt(e / n), ~0.03 at n = 4,096, as small as the bf16
# limit itself.  bf16: a few ulps (an ulp is 2^-8..2^-7 of the row's top).
LLM_ROW_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the kernel path against the plain path (teacher forced): largest logit
# error over the largest plain logit, and the share of equal greedy tokens.
# The plain path rounds the MLP to bf16 at every product, the fused kernel
# once, so they differ by a few bf16 ulps of the residual stream.
LOGIT_REL_TOL = 5e-2
AGREE_MIN = 0.9

# The SSM serving phase: mamba2-370m at full width and depth (src/repro_torch/
# configs/mamba2_370m.py).  Prompts: 2 tokens (shorter than the conv), a
# ragged single chunk (100), chunk padding (1,000, 3,000), 64 chunks
# (16,384); 4 slots, so two waves.
SERVE_SSM = {"arch": "mamba2-370m", "slots": 4,
             "prompts": (2, 100, 1000, 4096, 16384, 256, 3000, 8192),
             "max_new": 32, "reps": 10}
# The hybrid serving phase: zamba2-7b at full width and depth (src/
# repro_torch/configs/zamba2_7b.py): 81 Mamba-2 blocks and the shared tile
# at 14 sites, head dim 112.  Prompts: one token (S == B at the engine's
# B = 1 prefill), two (shorter than the conv), a ragged single chunk (100),
# chunk padding (1,000, 3,000), exactly the window (4,096), across it
# (4,608: each site's history rotated into its ring), a second wave (256).
SERVE_HYBRID = {"arch": "zamba2-7b", "slots": 4, "window": 4096,
                "prompts": (1, 2, 100, 1000, 3000, 4096, 4608, 256),
                "max_new": 32, "reps": 10}
# The MoE serving phase: granite-moe-1b-a400m at full width and depth (src/
# repro_torch/configs/granite_moe_1b_a400m.py): 24 layers, d 1,024, 32
# experts, top 8, expert width 512, head dim 64, G 2, causal attention with
# no window.  Prompts: one token (8 of the 32 experts hit), two, a ragged
# hundred, 1,000, 2,048, one short of the window (4,095), the window exactly
# (4,096) and across it (4,608: the history rotated into its ring); 4 slots,
# so two waves.
SERVE_MOE = {"arch": "granite-moe-1b-a400m", "slots": 4, "window": 4096,
             "prompts": (1, 2, 100, 1000, 2048, 4095, 4096, 4608),
             "max_new": 32, "reps": 10}
# The MLA serving phase: deepseek-v2-lite-16b at full width and depth (src/
# repro_torch/configs/deepseek_v2_lite_16b.py): 27 layers (a dense first
# layer of width 10,944, then 26 of 64 experts top 6 plus 2 shared), d
# 2,048, 16 heads of MLA (latent 512, rope 64: qk head dim 192, v 128),
# causal, vocab 102,400.  The prompts of the moe phase: one token, two, a
# ragged hundred, 1,000, 2,048, one short of the window, the window exactly
# and across it (4,608: the latent history rotated into its ring).
SERVE_MLA = {"arch": "deepseek-v2-lite-16b", "slots": 4, "window": 4096,
             "prompts": (1, 2, 100, 1000, 2048, 4095, 4096, 4608),
             "max_new": 32, "reps": 10}
# The int8 latent cache's run: these prompts, 8 new tokens each, beside the
# bf16 cache's run of the same requests (agreement reported, not gated).
MLA_INT8 = {"prompts": (100, 1000, 4095, 4608), "max_new": 8}
# ssd_scan vs its plain version, float32 both (tests/test_kernels.py:68):
# |err| <= SSD_TOL + SSD_TOL * |ref| per element, and per (batch, head)
# max |err| / max |ref| <= SSD_TOL.
SSD_TOL = 1e-4


def sync() -> None:
    torch.cuda.synchronize()


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also says when it was written
    (``t_s``, seconds since the script started)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        return out.splitlines()[0] if out else "unknown, unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown, unknown"


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# kernel vs plain version
# ---------------------------------------------------------------------------

FLOAT_KEYS = ("adm", "served", "queue", "busy", "rtt", "rates", "dropped",
              "energy")


def compare_outputs(out_k, out_p):
    """Max abs / rel error over the float outputs, count of designs whose
    integer outputs (swaps, guard) differ, and whether floats are within
    tolerance."""
    max_abs = max_rel = 0.0
    ok = True
    pairs = [(out_k[n], out_p[n]) for n in FLOAT_KEYS]
    pairs += [(a, b) for a, b in zip(out_k["pol"], out_p["pol"])
              if a.dtype.is_floating_point]
    for a, b in pairs:
        a64, b64 = a.double(), b.double()
        if not bool(torch.isfinite(a64).all()):
            ok = False
        diff = (a64 - b64).abs()
        if diff.numel():
            max_abs = max(max_abs, float(diff.max()))
            max_rel = max(max_rel, float(
                (diff / b64.abs().clamp(min=1e-30))[b64.abs() > ATOL]
                .max()) if bool((b64.abs() > ATOL).any()) else 0.0)
            ok = ok and bool((diff <= ATOL + RTOL * b64.abs()).all())
    swaps_bad = int((out_k["swaps"] != out_p["swaps"]).sum())
    guard_bad = int((out_k["guard"] != out_p["guard"]).any(dim=-1).sum())
    flags_bad = sum(int((a != b).sum())
                    for a, b in zip(out_k["pol"], out_p["pol"])
                    if a.dtype == torch.bool)
    return {"max_abs_err": max_abs, "max_rel_err": max_rel,
            "floats_ok": ok, "swaps_mismatch": swaps_bad,
            "guard_mismatch": guard_bad, "flag_mismatch": flags_bad}


def dfmul_platforms(n, A, *, rng, flows=None):
    """``n`` platforms of ``A`` dfmul tiles: fixed placement, K in
    {1,2,4,8}, mixed NoC rates (the layout of the reference's
    batched-simulation tests at A = 12); past 13 tiles the mesh has a fifth
    row (62 links)."""
    from repro_torch.core.noc import NocConfig
    from repro_torch.core.perfmodel import AccelWorkload, SoCPerfModel
    from repro_torch.sim.engine import SimPlatform
    model = SoCPerfModel() if A <= 13 else SoCPerfModel(noc=NocConfig(5, 4))
    pos = [(r, c) for r in range(model.noc.rows) for c in range(4)
           if (r, c) not in {(1, 0), (0, 0), (0, 3)}][:A]
    plats = []
    for _ in range(n):
        k = int(rng.choice([1, 2, 4, 8]))
        wls = [AccelWorkload("dfmul", 8.70, 1.1, replication=k) for _ in pos]
        plats.append(SimPlatform.build(
            model, wls, pos, noc_rate=float(rng.choice([0.5, 0.75, 1.0])),
            n_tg=2, req_mb=0.005, flows=flows))
    return plats


def two_tile_platforms(n, *, rng):
    from repro_torch.core.perfmodel import AccelWorkload, SoCPerfModel
    from repro_torch.sim.engine import SimPlatform
    model = SoCPerfModel()
    spots = [(r, c) for r in range(4) for c in range(4) if (r, c) != (1, 0)]
    plats = []
    for _ in range(n):
        i, j = rng.choice(len(spots), size=2, replace=False)
        wls = [AccelWorkload("dfsin", 0.33, 60.0,
                             replication=int(rng.choice([1, 2, 4]))),
               AccelWorkload("gsm", 4.61, 12.0,
                             replication=int(rng.choice([1, 2, 4])))]
        plats.append(SimPlatform.build(
            model, wls, [spots[i], spots[j]], names=["dfsin", "gsm"],
            rates={"dfsin": float(rng.choice([0.4, 0.8, 1.0])),
                   "gsm": float(rng.choice([0.4, 0.8, 1.0]))},
            noc_rate=float(rng.choice([0.5, 1.0])), n_tg=4, req_mb=0.002))
    return plats


def make_policy(kind):
    from repro_torch.core.dfs import (BatchEWMAUtilizationPolicy,
                                      BatchMemoryBoundPolicy,
                                      BatchPIDRatePolicy)
    return {"none": None, "guard": None,
            "membound": BatchMemoryBoundPolicy(threshold=0.5, low_rate=0.3),
            "pid": BatchPIDRatePolicy(target=0.7),
            "ewma": BatchEWMAUtilizationPolicy(alpha=0.4, target=0.65),
            }[kind]


def make_engine(plats, kind, *, tech=None, max_queue=float("inf"), ci=25,
                backend="fused", guard=3.0):
    from repro_torch.sim.batch import BatchSimEngine, BatchSimPlatform
    from repro_torch.sim.control import BatchControllerHarness
    from repro_torch.sim.engine import SimConfig
    bp = BatchSimPlatform.stack(plats)
    ctl = None
    if kind != "none":
        ctl = BatchControllerHarness(bp.islands, bp.rates, make_policy(kind),
                                     tile_names=bp.names,
                                     queue_guard_ticks=guard)
    return BatchSimEngine(
        bp, config=SimConfig(control_interval=ci, max_queue=max_queue),
        controller=ctl, backend=backend, tech=tech)


def kernel_vs_plain(engine, trace):
    """Run the kernel and its plain version on the inputs the engine packs
    for this trace; returns (comparison, inputs)."""
    from repro_torch.kernels.tick_sim import (fused_tick_sim,
                                              fused_tick_sim_plain)
    arr, consts, scalars, init, plan, _ = engine.fused_inputs(trace)
    out_k = fused_tick_sim(arr, consts, scalars, init, plan=plan)
    sync()
    out_p = fused_tick_sim_plain(arr, consts, scalars, init, plan=plan)
    sync()
    return compare_outputs(out_k, out_p), (arr, consts, scalars, init, plan)


def edge_chain(A):
    """A two-stage chain over the first tiles of an A-tile dfmul platform:
    1 -> 2 tiles at A = 3, 2 -> 3 at A = 5, 3 -> 3 beyond."""
    from repro_torch.sim.flows import FlowPattern
    k, m = {3: (1, 2), 5: (2, 3)}.get(A, (3, 3))
    names = [f"dfmul{i}" for i in range(k + m)]
    demand = {"dfmul0": 0.3, **({"dfmul7": 0.05} if A > 7 else {})}
    return FlowPattern.chain(tuple(names[:k]), tuple(names[k:]),
                             demand=demand)


# tick_sim's cases: A, B.  A = 2 and 12 are the main paths' widths; A = 1, 3,
# 5 and 16 give the G = 2, 4, 8 and 16 lanes a design of the kernel, with
# ragged batches (B = 37: not a multiple of any warp's designs)
TICK_CASES = ((2, 1), (2, 67), (12, 67), (12, SIZES["kernel_big_B"]),
              (2, SIZES["kernel_big_B"]), (1, 37), (3, 37), (5, 37), (16, 37))


def phase_kernels():
    from repro_torch.sim.traffic import BatchTrace, diurnal_trace, mmpp_trace
    rng = np.random.default_rng(SEED)
    chain = edge_chain(12)
    cases = []
    T = SIZES["kernel_T"]
    big = SIZES["kernel_big_B"]
    worst = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    bad = []
    for A, B in TICK_CASES:
        for kind in ("none", "guard", "membound", "pid", "ewma"):
            for variant in ("base", "maxq", "tech", "flows"):
                if variant == "flows" and A in (1, 2):
                    continue
                if B == big and variant not in ("base", "flows"):
                    continue
                flows = ((chain if A == 12 else edge_chain(A))
                         if variant == "flows" else None)
                plats = (two_tile_platforms(B, rng=rng) if A == 2
                         else dfmul_platforms(B, A, rng=rng, flows=flows))
                eng = make_engine(
                    plats, kind,
                    tech=(16, "cons") if variant == "tech" else None,
                    max_queue=4.0 if variant == "maxq" else float("inf"))
                cap = eng.capacity_rps().mean(axis=0)
                if variant == "maxq":
                    tr = mmpp_trace(cap * 0.2, cap * 1.5, T, A, dt=1e-3,
                                    seed=SEED)
                else:
                    tr = diurnal_trace(cap * 0.6, T, A, dt=1e-3, depth=0.6,
                                       seed=SEED)
                if B == 67 and variant == "base":
                    # per-design (T, B, A) arrivals: the non-shared read path
                    scale = rng.uniform(0.5, 1.5, size=B)
                    tr = BatchTrace.broadcast(tr, B).scaled(scale)
                cmp, _ = kernel_vs_plain(eng, tr)
                case = dict(A=A, B=B, kind=kind, variant=variant, **cmp)
                cases.append(case)
                for key in worst:
                    worst[key] = max(worst[key], cmp[key])
                if (not cmp["floats_ok"] or cmp["swaps_mismatch"]
                        or cmp["guard_mismatch"] or cmp["flag_mismatch"]):
                    bad.append(case)
    div = div_check()
    emit({"phase": "kernels", "cases": len(cases), "failed": len(bad),
          "T": T, "rtol": RTOL, "atol": ATOL, **worst, "div_check": div,
          "first_failures": bad[:5]})
    if bad:
        raise SystemExit("kernel disagrees with its plain version")
    if div["mismatches"] or not div["quotients"]:
        raise SystemExit("tick_sim's fast division differs from the IEEE one")
    return worst


def div_check():
    """tick_sim's fast division (csrc/tick_sim.cu div_fast) against the
    IEEE division on the card: every b significand times 384 dividends
    (random significands, exponents inside the fast path's range, and a
    few plain values) at four scales of b; the quotients compared and the
    count whose bits differ (the kernel's exactness rests on none)."""
    import ctypes
    from repro_torch.kernels import build
    fn = build.function("tick_sim", "tick_div_check",
                        [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                         ctypes.c_void_p, ctypes.c_void_p])
    rng = np.random.default_rng(SEED)
    counts = torch.zeros(2, dtype=torch.int64, device=DEV)
    for bscale in (1.0, 2.0 ** -40, 2.0 ** 40, 2.0 ** -60):
        e = rng.integers(64, 191, size=384)
        a = ((e << 23) | rng.integers(0, 1 << 23, size=384)).astype(
            np.uint32).view(np.float32).copy()
        a[:8] = [0.0, 1.0, 0.5, 0.999, 2.0, 3.0, 1e-3, 7.0]
        at = torch.from_numpy(a).to(DEV)
        rc = fn(at.data_ptr(), len(a), bscale, counts.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"tick_div_check launch failed ({rc})")
    sync()
    return {"quotients": int(counts[0]), "mismatches": int(counts[1])}


# ---------------------------------------------------------------------------
# bound
# ---------------------------------------------------------------------------


def tick_sim_bound(arr, consts, scalars, init, plan):
    """Least milliseconds an H100 could take for one ``fused_tick_sim`` call
    on these inputs: bytes (every input read once, every output written
    once) over the memory rate, and float32 operations over the float32
    peak; returns (ms, "bytes" | "operations", bytes, operations)."""
    T = arr.shape[0]
    B, A = consts["base"].shape
    L = consts["inc"].shape[-1]
    I = init["rates"].shape[1]
    n_in = arr.numel() + sum(v.numel() for v in consts.values()) \
        + init["rates"].numel() + sum(p.numel() for p in init["pol"])
    byts = 4 * n_in + init["guard"].numel()
    byts += 4 * (2 * T * B * A + 3 * B * A + B * I + 3 * B) + B * I
    byts += 4 * sum(p.numel() for p in init["pol"])
    # per tile per tick: admit (3), capacity (7), serve (4), rtt (2), energy
    # (4), window (1) ~ 21, drops (3) when bounded, forwarding (2 A) when
    # chained
    per_tile = 21.0
    if float(scalars["max_q"]) != float("inf"):
        per_tile += 3
    if scalars.get("forward") is not None:
        per_tile += 2 * A
    ops = T * B * A * per_tile
    if scalars["dyn_on"]:
        # contention, from this run's incidence: per tile the demand product
        # and the slowdown (7), and for each link of its own route one add
        # per tile whose route shares the link plus one max
        on = (consts["inc"] > 0.5).double()                    # (B, A, L)
        sharers = on.sum(dim=1, keepdim=True)                  # (B, 1, L)
        walk = float((on * (sharers + 1.0)).sum())
        ops += T * (7.0 * B * A + walk)
    ci = int(scalars["ci"])
    if plan.kind != "none" and ci:
        lmax = np.asarray(plan.levels).shape[1]
        ops += (T // ci) * B * (I * (5 * A + 3 * lmax + 16) + 6 * A)
    t_bytes = byts / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", byts, ops)


def sm_clock_mhz(fn, reps: int) -> float:
    """The SM clock (MHz, ``nvidia-smi``) read while ``reps`` calls of
    ``fn`` queued on the card run; NaN where it cannot be read."""
    for _ in range(reps):
        fn()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
             "nounits"], capture_output=True, text=True, timeout=30).stdout
        mhz = float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        mhz = float("nan")
    sync()
    return mhz


def time_kernel_and_plain(inputs):
    """The kernel's time (CUDA events, mean of SIZES["reps"] calls after a
    warm one), the SM clock while it runs and so its cycles per tick, the
    plain version's time and the bound."""
    from repro_torch.kernels.tick_sim import (fused_tick_sim,
                                              fused_tick_sim_plain)
    arr, consts, scalars, init, plan = inputs
    fused_tick_sim(arr, consts, scalars, init, plan=plan)      # warm
    ms = cuda_ms(lambda: fused_tick_sim(arr, consts, scalars, init,
                                        plan=plan), SIZES["reps"])
    mhz = sm_clock_mhz(lambda: fused_tick_sim(arr, consts, scalars, init,
                                              plan=plan), 40)
    plain_ms = cuda_ms(lambda: fused_tick_sim_plain(arr, consts, scalars,
                                                    init, plan=plan), 1)
    bound_ms, bound_by, byts, ops = tick_sim_bound(arr, consts, scalars,
                                                   init, plan)
    return {"ms": ms, "sm_mhz": mhz,
            "cycles_per_tick": ms * 1e-3 * mhz * 1e6 / arr.shape[0],
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": byts, "operations": ops}


# ---------------------------------------------------------------------------
# sweep
# ---------------------------------------------------------------------------


def phase_sweep():
    from repro_torch.configs.vespa_soc import CHSTONE
    from repro_torch.core.dse import grid_sweep, pareto_front_indices
    from repro_torch.core.islands import NOC_LADDER, TILE_LADDER
    from repro_torch.core.perfmodel import AccelWorkload, SoCPerfModel
    model = SoCPerfModel()
    wls = [AccelWorkload("dfsin", *CHSTONE["dfsin"]),
           AccelWorkload("gsm", *CHSTONE["gsm"])]
    axes = dict(ks=(1, 2, 4), acc_rates=TILE_LADDER.levels(),
                noc_rates=NOC_LADDER.levels(),
                tg_rates=TILE_LADDER.levels()[::2], n_tg=4)
    on_card = dict(device=None, backend="torch")        # device=None: card
    grid_sweep(model, wls, **axes, **on_card)           # warm the card
    sync()
    t0 = time.perf_counter()
    res = grid_sweep(model, wls, **axes, **on_card)
    sync()
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = grid_sweep(model, wls, device="cpu", **axes)  # host NumPy f64
    host_s = time.perf_counter() - t0

    worst = 0.0
    for name in ("throughput", "area", "energy_per_unit", "mem_traffic"):
        a, b = getattr(res, name), getattr(ref, name)
        worst = max(worst, float(np.max(np.abs(a - b)
                                        / np.maximum(np.abs(b), 1e-300))))
    valid_same = bool(np.array_equal(res.valid, ref.valid))
    # the prefilter ran inside grid_sweep on the card (res.prefilter_s);
    # pareto_indices() is the exact scan over its candidates only
    t0 = time.perf_counter()
    pf_dev = res.pareto_indices()
    pareto_s = time.perf_counter() - t0
    # yardstick: the exact scan alone over every valid point
    flat = np.nonzero(res.valid)[0]
    t0 = time.perf_counter()
    pf_scan = flat[pareto_front_indices(res.throughput[flat], res.area[flat],
                                        res.energy_per_unit[flat])]
    scan_s = time.perf_counter() - t0
    pf_ref = ref.pareto_indices()
    sym = np.setxor1d(pf_dev, pf_ref)
    gap = 0.0
    if sym.size:
        # a last-ulp tie may fall differently; it is a fault only when the
        # objectives of an offending point differ by more than the tolerance
        for name in ("throughput", "energy_per_unit"):
            a, b = getattr(res, name)[sym], getattr(ref, name)[sym]
            gap = max(gap, float(np.max(np.abs(a - b)
                                        / np.maximum(np.abs(b), 1e-300))))
    out = {"phase": "sweep", "points": len(res), "valid": res.n_valid,
           "device_s": dev_s, "points_per_s": len(res) / dev_s,
           "host_numpy_s": host_s, "max_rel_err": worst,
           "valid_equal": valid_same, "pareto_size": int(pf_dev.size),
           "pareto_symdiff": int(sym.size), "pareto_gap": gap,
           "pareto_host_s": pareto_s, "prefilter_s": res.prefilter_s,
           "prefilter_candidates": int(res.front_candidates.size),
           "pareto_exact_scan_s": scan_s,
           "prefilter_equals_exact_scan": bool(np.array_equal(pf_dev,
                                                              pf_scan)),
           "backend": res.backend}
    emit(out)
    if worst > 1e-9 or not valid_same or (sym.size and gap > 1e-9):
        raise SystemExit("sweep on the card disagrees with the host")
    if not out["prefilter_equals_exact_scan"]:
        raise SystemExit("the prefiltered Pareto set differs from the exact "
                         "scan's on the same objectives")
    return model, res, out


# ---------------------------------------------------------------------------
# sweep_chunked: the streaming sweep at 2.02e7 and 2.42e8 points
# ---------------------------------------------------------------------------

# benchmarks/bench_dse.py:soc_dse_islands (20,194,758 points) and the soak
# of tests/test_dse_islands.py:254-275 (242,337,096 points, 1.35e8 valid)
ISLANDS = {"accels": ("dfadd", "dfmul", "dfsin"), "chunk": 2_000_000,
           "positions": ((1, 1), (3, 3), (0, 2)), "tg_rates": (0.5, 1.0)}
SOAK = {"chunk": 4_000_000, "chunk2": 3_000_000,
        "positions": ((1, 1), (3, 3), (0, 2), (2, 2), (1, 2), (0, 1)),
        "tg_rates": (0.5, 0.75, 1.0)}


def chunked_axes(spec):
    from repro_torch.core.islands import NOC_LADDER, TILE_LADDER
    return dict(ks=(1, 2, 4), acc_rates=TILE_LADDER.levels(),
                noc_rates=NOC_LADDER.levels(), tg_rates=spec["tg_rates"],
                positions=spec["positions"], n_tg=4,
                island_rates="independent")


def objectives_at(model, wls, axes, idx, device):
    """The four objectives of flat points ``idx`` of the sweep ``axes``
    describes, evaluated one at a time by the flat evaluator on
    ``device`` (float64)."""
    from repro_torch.core import dse
    lay, ax, vals = dse._prepare_axes(
        model, tuple(wls), axes["ks"], axes["acc_rates"],
        axes["noc_rates"], axes["tg_rates"], axes["positions"],
        axes["island_rates"])
    shape = tuple(len(v) for _, v in ax)
    rows = [dse._eval_flat_points(model, tuple(wls), axes["n_tg"], lay, vals,
                                  shape, int(i), int(i) + 1, device=device)
            for i in idx]
    return {o: np.asarray([r[o][0] for r in rows])
            for o in ("throughput", "area", "energy_per_unit", "mem_traffic")}


def set_gap(a, b, model, wls, axes, names):
    """Indices in one of the sets ``a``, ``b`` only, and the largest
    relative difference between the card's and the host's objectives
    ``names`` at those points (the last-ulp rule of phase sweep)."""
    sym = np.setxor1d(a, b)
    if not sym.size:
        return 0, 0.0
    card = objectives_at(model, wls, axes, sym, DEV)
    host = objectives_at(model, wls, axes, sym, "cpu")
    return int(sym.size), max(
        float(np.max(np.abs(card[n] - host[n])
                     / np.maximum(np.abs(host[n]), 1e-300))) for n in names)


def timed_sweep(model, wls, axes, **kw):
    """A chunked sweep on the card: result, host seconds (synchronised) and
    the device memory it took above what was allocated before it."""
    from repro_torch.core.dse import grid_sweep
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sync()
    t0 = time.perf_counter()
    res = grid_sweep(model, wls, **axes, **kw)
    sync()
    return res, time.perf_counter() - t0, \
        torch.cuda.max_memory_allocated() - base


def chunk_report(res, seconds, peak):
    return {"points": len(res), "valid": res.n_valid, "seconds": seconds,
            "points_per_s": len(res) / seconds, "n_chunks": res.n_chunks,
            "chunk_points": res.chunk_points,
            "peak_chunk_bytes": res.peak_chunk_bytes,
            "device_peak_bytes": int(peak),
            "pareto_size": int(res.pareto_indices().size)}


def phase_sweep_chunked(model):
    """The chunked streaming sweep on the card (mask, prefilter and top-k
    there, exact front and merges on the host), held against the host
    NumPy chunked sweep at 2.02e7 points and run alone at 2.42e8."""
    from repro_torch.configs.vespa_soc import CHSTONE
    from repro_torch.core.dse import _TRACKED_OBJECTIVES, grid_sweep
    from repro_torch.core.perfmodel import AccelWorkload
    wls = [AccelWorkload(n, *CHSTONE[n]) for n in ISLANDS["accels"]]
    on_card = dict(device=None, backend="torch")
    out = {"phase": "sweep_chunked"}

    axes = chunked_axes(ISLANDS)
    card, card_s, peak = timed_sweep(model, wls, axes,
                                     chunk_points=ISLANDS["chunk"], **on_card)
    t0 = time.perf_counter()
    host = grid_sweep(model, wls, **axes, device="cpu",
                      chunk_points=ISLANDS["chunk"])
    host_s = time.perf_counter() - t0
    pf_sym, pf_gap = set_gap(card.pareto_indices(), host.pareto_indices(),
                             model, wls, axes,
                             ("throughput", "energy_per_unit"))
    top = {}
    for o, _ in _TRACKED_OBJECTIVES:
        n, g = set_gap(card.topk_indices(10, o), host.topk_indices(10, o),
                       model, wls, axes, (o,))
        top[o] = {"equal": bool(np.array_equal(card.topk_indices(10, o),
                                               host.topk_indices(10, o))),
                  "symdiff": n, "gap": g}
    out["islands"] = {**chunk_report(card, card_s, peak),
                      "host_numpy_s": host_s, "host_valid": host.n_valid,
                      "host_n_chunks": host.n_chunks,
                      "pareto_symdiff": pf_sym, "pareto_gap": pf_gap,
                      "top10": top}
    bad = (card.n_valid != host.n_valid or (pf_sym and pf_gap > 1e-9)
           or any(not t["equal"] and t["gap"] > 1e-9 for t in top.values()))
    if bad:
        emit(out)
        raise SystemExit("the chunked sweep on the card disagrees with the "
                         "host's at 2.02e7 points")

    axes = chunked_axes(SOAK)
    soak, soak_s, peak = timed_sweep(model, wls, axes,
                                     chunk_points=SOAK["chunk"], **on_card)
    again, again_s, peak2 = timed_sweep(model, wls, axes,
                                        chunk_points=SOAK["chunk2"],
                                        **on_card)
    dp = soak.design_point(int(soak.topk_indices(1)[0]))
    scalar = sum(
        model.accel_throughput(
            AccelWorkload(w.name, w.base_mbps, w.ai,
                          replication=dp.replication[w.name]),
            dp.placement[w.name],
            {"acc": dp.rates[w.name], "noc_mem": dp.rates["noc_mem"],
             "tg": dp.rates["tg"]}, soak.n_tg)
        for w in wls)
    scalar_rel = abs(dp.throughput - scalar) / abs(scalar)
    same = bool(np.array_equal(soak.pareto_indices(), again.pareto_indices()))
    out["soak"] = {**chunk_report(soak, soak_s, peak),
                   "top_throughput": dp.throughput,
                   "scalar_rel_err": scalar_rel,
                   "second_chunk": chunk_report(again, again_s, peak2),
                   "pareto_equal_across_chunks": same}
    emit(out)
    if len(soak) < 100_000_000 or scalar_rel > 1e-9 or not same:
        raise SystemExit("the 2.42e8-point chunked sweep failed its checks")
    return out


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


def pid_factory(guard=3.0):
    from repro_torch.core.dfs import BatchPIDRatePolicy
    from repro_torch.sim.control import BatchControllerHarness

    def factory(platform):
        return BatchControllerHarness(
            platform.islands, platform.rates, BatchPIDRatePolicy(),
            tile_names=platform.names, queue_guard_ticks=guard)
    return factory


def check_result(r, label, *, chained=False):
    """Finite, and work conserved: offered = completed + dropped + residual
    (under a chain the forward carry in flight is not in any queue, so the
    chained check only reports the gap)."""
    for name in ("completed", "dropped", "residual", "energy_j",
                 "throughput_rps"):
        if not np.all(np.isfinite(getattr(r, name))):
            raise SystemExit(f"{label}: non-finite {name}")
    if not np.all(np.isfinite(r.p99_latency_s[r.completed > 0])):
        raise SystemExit(f"{label}: non-finite p99")
    total = r.completed + r.dropped + r.residual
    off = np.asarray(r.offered, dtype=np.float64)
    err = float(np.max(np.abs(total - off) / np.maximum(off, 1e-9)))
    if not chained and err > 1e-3:
        raise SystemExit(f"{label}: work not conserved (rel {err:.3e})")
    return err


def kernel_failed(cmp) -> bool:
    return bool(not cmp["floats_ok"] or cmp["swaps_mismatch"]
                or cmp["guard_mismatch"] or cmp["flag_mismatch"])


def drive_main_path(model, res):
    """The port's main path through its public entry point:
    ``closed_loop_score`` on the sweep's survivors, linear then 45 nm."""
    from repro_torch.core.dse import closed_loop_score
    from repro_torch.kernels.tick_sim import fused_tick_sim
    from repro_torch.sim.batch import BatchSimEngine, BatchSimPlatform
    from repro_torch.sim.engine import SimConfig
    from repro_torch.sim.traffic import diurnal_trace

    B, T, dt, req_mb = SIZES["main_B"], SIZES["main_T"], 1e-3, 0.002
    survivors = np.resize(res.topk_indices(B), B)
    cfg = SimConfig(control_interval=50)
    plat = BatchSimPlatform.from_design_points(model, res, survivors,
                                               req_mb=req_mb)
    cap = BatchSimEngine(plat, config=cfg,
                         ).capacity_rps().mean(axis=0)
    trace = diurnal_trace(cap * 0.35, T, 2, dt=dt, depth=0.5, seed=SEED)

    report = {"phase": "main_path", "B": B, "T": T, "A": 2}
    scores = {}
    for label, tech in (("linear", None), ("tech45", 45)):
        before = fused_tick_sim.launches
        t0 = time.perf_counter()
        score = closed_loop_score(
            res, trace, model=model, indices=survivors, req_mb=req_mb,
            sim_config=cfg, batch_controller_factory=pid_factory(),
            backend="fused", tech=tech)
        sync()
        wall = time.perf_counter() - t0
        if fused_tick_sim.launches != before + 1:
            raise SystemExit("closed_loop_score did not launch the kernel "
                             "exactly once")
        scores[label] = score
        r = score.results[0]
        cons = check_result(r, f"main_path[{label}]")
        report[label] = {
            "wall_s": wall, "survivors_per_s": B / wall,
            "kernel_ms": r.timings["loop"] * 1e3,
            "percentiles_ms": r.timings["percentiles"] * 1e3,
            "copies_ms": r.timings["copies"] * 1e3,
            "conservation_rel_err": cons,
            "swaps_total": int(r.swaps.sum()),
            "p99_ms_range": [float(np.nanmin(r.p99_latency_s)) * 1e3,
                             float(np.nanmax(r.p99_latency_s)) * 1e3],
            "best_index": int(score.ranked_indices()[0])}
    ctx = dict(model=model, res=res, survivors=survivors, cfg=cfg, plat=plat,
               cap=cap, trace=trace, dt=dt, req_mb=req_mb, scores=scores)
    return report, ctx


class NoSyncPerRow:
    """While active, every telemetry row the ``"torch"`` engine records runs
    under ``torch.cuda.set_sync_debug_mode("error")`` — an operation that
    waits for the card inside it raises — and is counted."""

    def __enter__(self):
        from repro_torch.sim.batch import TelemetryRings
        self.cls, self.orig, self.rows = TelemetryRings, \
            TelemetryRings.record, 0

        def guarded(rings, **kw):
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                self.orig(rings, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
            self.rows += 1

        TelemetryRings.record = guarded
        return self

    def __exit__(self, *exc):
        self.cls.record = self.orig
        return False


def telemetry_gap(a, b):
    """Largest relative difference between two BatchTelemetry recordings
    (inf when their shapes, row counts or events differ)."""
    if a.scalars.total_appended != b.scalars.total_appended \
            or a.events != b.events:
        return float("inf")
    worst = 0.0
    for ring in ("scalars", "island_rates", "queue_depth", "busy"):
        x, y = getattr(a, ring).array(), getattr(b, ring).array()
        if x.shape != y.shape:
            return float("inf")
        if x.size:
            worst = max(worst, float(np.max(
                np.abs(x - y) / np.maximum(np.abs(y), 1e-300))))
    return worst


def device_ms_by_kernel(fn, top=8):
    """Device milliseconds of one warm call of ``fn()`` by kernel name
    (``torch.profiler``; the ``top`` largest, the rest summed)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    per = {}
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0.0))
        if dev > 0:
            k = e.key.split("<")[0].split("(")[0].replace("void ", "")
            per[k] = per.get(k, 0.0) + dev / 1e3
    ranked = sorted(per.items(), key=lambda kv: -kv[1])
    out = dict(ranked[:top])
    out["other"] = sum(v for _, v in ranked[top:])
    return out


def percentile_check(ctx, report):
    """The main path's percentiles against the NumPy per-design function
    on 64 of its designs, bit for bit; a replay of the linear run (not
    counted: its launch is a comparison's) gives the histories."""
    from repro_torch.sim.batch import BatchSimEngine
    from repro_torch.sim.engine import (latency_percentiles,
                                        latency_percentiles_batch)
    plat, cfg, dt = ctx["plat"], ctx["cfg"], ctx["dt"]
    eng = BatchSimEngine(plat, config=cfg, controller=pid_factory()(plat),
                         backend="fused")
    r = eng.run(ctx["trace"])
    main = ctx["scores"]["linear"].results[0]
    adm, srv = eng.last_histories
    B = adm.shape[1]
    pick = np.arange(0, B, max(1, B // 64))[:64]
    a_h = adm[:, pick].double().cpu().numpy()
    s_h = srv[:, pick].double().cpu().numpy()
    want = np.asarray([latency_percentiles(a_h[:, j], s_h[:, j], dt)
                       for j in range(pick.size)])
    got = np.stack([r.p50_latency_s[pick], r.p99_latency_s[pick]], axis=-1)
    ms = cuda_ms(lambda: latency_percentiles_batch(adm, srv, dt), 3)
    by_kernel = device_ms_by_kernel(
        lambda: latency_percentiles_batch(adm, srv, dt))
    report.update(
        percentiles_ms_by_kernel=by_kernel,
        percentiles_redone_on_host=latency_percentiles_batch.last_redone,
        percentiles_ms=main.timings["percentiles"] * 1e3,
        percentiles_event_ms=ms,
        percentiles_designs_checked=int(pick.size),
        percentiles_bit_equal=bool(np.array_equal(got, want,
                                                  equal_nan=True)),
        percentiles_replay_equal=bool(
            np.array_equal(r.p99_latency_s, main.p99_latency_s,
                           equal_nan=True)
            and np.array_equal(r.p50_latency_s, main.p50_latency_s,
                               equal_nan=True)))
    if not (report["percentiles_bit_equal"]
            and report["percentiles_replay_equal"]):
        emit(report)
        raise SystemExit("the batched percentiles differ from the NumPy "
                         "per-design function")


def float32_torch_check(ctx, report, pair):
    """The float32 ``"torch"`` loop: at the main path's size against
    ``"fused"`` (rtol 2e-3 / atol 1e-2 on p99 and energy per request), and
    on the 64 check designs against the float64 loop (same ranking, swaps
    exact)."""
    from repro_torch.core.dse import closed_loop_score
    model, res, cfg = ctx["model"], ctx["res"], ctx["cfg"]
    common = dict(model=model, req_mb=ctx["req_mb"], sim_config=cfg,
                  batch_controller_factory=pid_factory(), backend="torch",
                  dtype=torch.float32)
    sync()
    t0 = time.perf_counter()
    f32 = closed_loop_score(res, ctx["trace"], indices=ctx["survivors"],
                            **common)
    sync()
    wall = time.perf_counter() - t0
    fused = ctx["scores"]["linear"]
    ok = True
    gaps = {}
    for name in ("p99_latency_s", "energy_per_request_j"):
        a, b = getattr(f32, name), getattr(fused, name)
        ok = ok and bool(np.allclose(a, b, rtol=2e-3, atol=1e-2,
                                     equal_nan=True))
        fin = np.isfinite(b)
        gaps[name] = float(np.max(np.abs(a[fin] - b[fin])
                                  / np.maximum(np.abs(b[fin]), 1e-300)))
    t64 = pair["torch"]
    f32s = closed_loop_score(res, pair["short"], indices=t64.indices,
                             **common)
    r32 = f32s.results[0]
    report["float32_torch"] = {
        "wall_s": wall, "fused_wall_s": report["linear"]["wall_s"],
        "loop_s": f32.results[0].timings["loop"],
        "max_rel_vs_fused": gaps, "within_tol": ok,
        "swaps_total": int(f32.results[0].swaps.sum()),
        "telemetry": f32.results[0].telemetry is not None,
        "check64_same_ranking": bool(np.array_equal(f32s.ranked_indices(),
                                                    t64.ranked_indices())),
        "check64_swaps_equal": bool(np.array_equal(r32.swaps,
                                                   t64.results[0].swaps))}
    f = report["float32_torch"]
    if not (ok and f["check64_same_ranking"] and f["check64_swaps_equal"]
            and not f["telemetry"]):
        emit(report)
        raise SystemExit("the float32 torch loop disagrees")


def verify_main_path(report, ctx):
    """After the drive: the 64-design cross-check against the float64 tick
    loop, and the kernel against its plain version at the drive's shapes."""
    from repro_torch.core.dse import closed_loop_score
    from repro_torch.sim.batch import BatchSimEngine
    from repro_torch.sim.traffic import diurnal_trace
    model, res, cfg, plat = ctx["model"], ctx["res"], ctx["cfg"], ctx["plat"]
    survivors, dt, req_mb = ctx["survivors"], ctx["dt"], ctx["req_mb"]

    # shortened trace: the float64 loop launches ~100 kernels per tick
    sub = survivors[:: max(1, len(survivors) // 64)][:64]
    short = diurnal_trace(ctx["cap"] * 0.35, SIZES["check_T"], 2, dt=dt,
                          depth=0.5, seed=SEED)
    pair = {"short": short}
    guard = NoSyncPerRow()
    for backend in ("fused", "torch"):
        t0 = time.perf_counter()
        with guard:
            pair[backend] = closed_loop_score(
                res, short, model=model, indices=sub, req_mb=req_mb,
                sim_config=cfg, batch_controller_factory=pid_factory(),
                backend=backend)
            sync()
        report[f"check64_{backend}_s"] = time.perf_counter() - t0
    # the float64 loop's telemetry: recorded on the card without a host
    # sync per row, equal to the same run on the CPU
    t0 = time.perf_counter()
    on_cpu = closed_loop_score(
        res, short, model=model, indices=sub, req_mb=req_mb, sim_config=cfg,
        batch_controller_factory=pid_factory(), backend="torch",
        device="cpu")
    tel_card = pair["torch"].results[0].telemetry
    report["telemetry"] = {
        "rows": tel_card.scalars.total_appended, "rows_guarded": guard.rows,
        "events": len(tel_card.events), "cpu_s": time.perf_counter() - t0,
        "max_rel_vs_cpu": telemetry_gap(tel_card,
                                        on_cpu.results[0].telemetry)}
    if report["telemetry"]["max_rel_vs_cpu"] > 1e-12 or guard.rows != \
            tel_card.scalars.total_appended or guard.rows == 0:
        emit(report)
        raise SystemExit("telemetry on the card disagrees with the CPU's")
    f, t = pair["fused"], pair["torch"]
    rel = 0.0
    for name in ("energy_per_request_j", "throughput_rps"):
        a, b = getattr(f, name), getattr(t, name)
        rel = max(rel, float(np.max(np.abs(a - b)
                                    / np.maximum(np.abs(b), 1e-300))))
    p99_abs = float(np.max(np.abs(f.p99_latency_s - t.p99_latency_s)))
    same_rank = bool(np.array_equal(f.ranked_indices(), t.ranked_indices()))
    # where the orders differ, the float64 scores taken in the fused order
    # must still be sorted within the tolerance (near-ties may swap)
    e_in_f_order = t.energy_per_request_j[f.order]
    tie_ok = bool(np.all(np.diff(e_in_f_order)
                         >= -2e-3 * np.abs(e_in_f_order[:-1])))
    swaps_same = bool(np.array_equal(f.results[0].swaps, t.results[0].swaps))
    report.update(check64_T=SIZES["check_T"], check64_max_rel=rel,
                  check64_p99_abs_s=p99_abs, check64_same_ranking=same_rank,
                  check64_ranking_within_ties=tie_ok,
                  check64_swaps_equal=swaps_same)
    if rel > 2e-3 or p99_abs > 2 * dt or not (same_rank or tie_ok):
        emit(report)
        raise SystemExit("fused and float64 backends disagree on the "
                         "64-design subset")
    percentile_check(ctx, report)
    float32_torch_check(ctx, report, pair)

    shapes = {}
    for label, tech in (("linear", None), ("tech45", 45)):
        eng = BatchSimEngine(plat, config=cfg,
                             controller=pid_factory()(plat),
                             backend="fused", tech=tech)
        cmp, inputs = kernel_vs_plain(eng, ctx["trace"])
        shapes[label] = {**cmp, **(time_kernel_and_plain(inputs)
                                   if label == "linear" else {})}
        if kernel_failed(cmp):
            emit({**report, "kernel_vs_plain": shapes})
            raise SystemExit("kernel disagrees with its plain version at "
                             "the main path's shapes")
    report["kernel_vs_plain"] = shapes
    emit(report)
    return report


def a12_engine(plat, cfg):
    from repro_torch.core.dfs import BatchMemoryBoundPolicy
    from repro_torch.sim.batch import BatchSimEngine
    from repro_torch.sim.control import BatchControllerHarness
    ctl = BatchControllerHarness(
        plat.islands, plat.rates,
        BatchMemoryBoundPolicy(threshold=0.5, low_rate=0.3),
        tile_names=plat.names, queue_guard_ticks=3.0)
    return BatchSimEngine(plat, config=cfg, controller=ctl, backend="fused")


def drive_main_path_a12():
    """The second main-path shape: stacked twelve-tile platforms with a
    two-stage chain over 3-replica stages and memory-bound DFS."""
    from repro_torch.kernels.tick_sim import fused_tick_sim
    from repro_torch.sim.batch import BatchSimPlatform
    from repro_torch.sim.engine import SimConfig
    from repro_torch.sim.flows import FlowPattern
    from repro_torch.sim.traffic import diurnal_trace

    B, T, dt = SIZES["a12_B"], SIZES["a12_T"], 1e-3
    rng = np.random.default_rng(SEED + 1)
    chain = FlowPattern.chain(("dfmul0", "dfmul1", "dfmul2"),
                              ("dfmul3", "dfmul4", "dfmul5"))
    plat = BatchSimPlatform.stack(
        dfmul_platforms(B, 12, rng=rng, flows=chain))
    cfg = SimConfig(control_interval=50)
    cap = a12_engine(plat, cfg).capacity_rps().mean(axis=0)
    trace = diurnal_trace(cap * 0.35, T, 12, dt=dt, depth=0.5, seed=SEED)
    before = fused_tick_sim.launches
    t0 = time.perf_counter()
    r = a12_engine(plat, cfg).run(trace)
    sync()
    wall = time.perf_counter() - t0
    if fused_tick_sim.launches != before + 1:
        raise SystemExit("the A=12 run did not launch the kernel once")
    gap = check_result(r, "main_path_a12", chained=True)
    report = {"phase": "main_path_a12", "B": B, "T": T, "A": 12,
              "wall_s": wall, "designs_per_s": B / wall,
              "kernel_ms": r.timings["loop"] * 1e3,
              "percentiles_ms": r.timings["percentiles"] * 1e3,
              "copies_ms": r.timings["copies"] * 1e3,
              "offered_minus_accounted_rel": gap,
              "swaps_total": int(r.swaps.sum())}
    return report, dict(plat=plat, cfg=cfg, trace=trace)


def verify_main_path_a12(report, ctx):
    cmp, inputs = kernel_vs_plain(a12_engine(ctx["plat"], ctx["cfg"]),
                                  ctx["trace"])
    report["L"] = int(inputs[1]["inc"].shape[-1])
    report["kernel_vs_plain"] = {**cmp, **time_kernel_and_plain(inputs)}
    emit(report)
    if kernel_failed(cmp):
        raise SystemExit("kernel disagrees with its plain version at the "
                         "A=12 shapes")
    return report


# ---------------------------------------------------------------------------
# serve: the dense LLM serving path
# ---------------------------------------------------------------------------
# The sequential closed-loop engine: examples/torch_closed_loop.py's
# scenarios at full size on the card
# ---------------------------------------------------------------------------

# The sequential float64 engine on the card against the same engine on the
# CPU: reductions may add in another order there, so not bit for bit.
SEQ_RTOL = 1e-12                # energy, completed, dropped (relative)
# the float32 kernel at B = 1 against the float64 sequential engine (ROADMAP
# ground rules: f32 kernel vs f64 reference)
B1_FUSED_RTOL = 2e-3
CLOSED_LOOP_CI = 25             # control interval of the example's runs


def closed_loop_example():
    """``examples/torch_closed_loop.py`` as a module: the platform, trace,
    controllers and gates a user of the example gets."""
    import importlib.util
    path = os.path.join(ROOT, "examples", "torch_closed_loop.py")
    spec = importlib.util.spec_from_file_location("torch_closed_loop", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class SyncCount:
    """Counts the operations that wait for the card (torch's sync debug
    mode "warn") over a whole call (``total``) and, apart, inside the tick
    loops of the ``"torch"`` engines (``BatchSimEngine._ticks``, which the
    sequential engine runs at B = 1: ``in_ticks``, ``loops``).  With
    ``strict`` every tick loop runs under mode "error" instead: an
    operation that waits there raises.  With ``stacks`` each record keeps
    the Python stack it was raised from (``self.stacks``, None for
    warnings that are not syncs)."""

    def __init__(self, strict: bool = False, stacks: bool = False):
        self.strict = strict
        self.keep_stacks = stacks

    @staticmethod
    def _syncs(records) -> int:
        return sum("synchroniz" in str(r.message) for r in records)

    def __enter__(self):
        import warnings
        from repro_torch.sim.batch import BatchSimEngine
        self.in_ticks = self.loops = 0
        self._catch = warnings.catch_warnings(record=True)
        self.records = self._catch.__enter__()
        warnings.simplefilter("always")
        self.stacks = []
        if self.keep_stacks:
            import traceback
            append = warnings._showwarnmsg_impl        # the records' list

            def keep(msg):
                self.stacks.append(
                    traceback.extract_stack()[:-1]
                    if "synchroniz" in str(msg.message) else None)
                append(msg)
            warnings._showwarnmsg_impl = keep
        self._prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        # what turning the mode on said (the first time in a process it
        # says "synchronizing" itself) is not the block's
        self.records.clear()
        self.stacks.clear()
        self._cls, self._orig = BatchSimEngine, BatchSimEngine._ticks
        count = self

        def ticks(engine, lp, trace):
            n0 = len(count.records)
            if count.strict:
                torch.cuda.set_sync_debug_mode("error")
            try:
                count._orig(engine, lp, trace)
            finally:
                torch.cuda.set_sync_debug_mode("warn")
            count.in_ticks += count._syncs(count.records[n0:])
            count.loops += 1

        BatchSimEngine._ticks = ticks
        return self

    def __exit__(self, *exc):
        self._cls._ticks = self._orig
        torch.cuda.set_sync_debug_mode(self._prev)
        self.total = self._syncs(self.records)
        self._catch.__exit__(*exc)
        return False


def seq_gap(card, host) -> dict:
    """The card's sequential run against the CPU's: the largest relative
    gap of energy / completed / dropped / residual and the fault/SLO
    ledgers, and whether p50, p99, swaps and the events (commits, fault
    transitions, detections) agree exactly."""
    rel = 0.0
    for f in ("energy_j", "completed", "dropped", "residual", "dropped_slo",
              "dropped_fault", "retried"):
        a, b = getattr(card, f), getattr(host, f)
        rel = max(rel, abs(a - b) / max(abs(b), 1e-300))
    return {"max_rel": rel,
            "p50_equal": card.p50_latency_s == host.p50_latency_s,
            "p99_equal": card.p99_latency_s == host.p99_latency_s,
            "swaps_equal": card.swaps == host.swaps,
            "events_equal": card.telemetry.events == host.telemetry.events}


def seq_gap_ok(gap) -> bool:
    return gap["max_rel"] <= SEQ_RTOL and all(
        gap[k] for k in ("p50_equal", "p99_equal", "swaps_equal",
                         "events_equal"))


def seq_report(r, syncs=None) -> dict:
    out = {"wall_s": r.elapsed_wall_s, "ticks_per_s": r.ticks_per_s_wall,
           "requests_per_s": r.requests_per_s_wall,
           "percentiles_ms": r.timings["percentiles"] * 1e3,
           "energy_per_request_mj": r.energy_per_request_j * 1e3,
           "p50_ms": r.p50_latency_s * 1e3, "p99_ms": r.p99_latency_s * 1e3,
           "completed": r.completed, "offered": r.offered,
           "swaps": r.swaps}
    if syncs is not None:
        out.update(syncs_in_ticks=syncs.in_ticks, syncs_per_run=syncs.total)
    return out


# the ticks of each sequential run profiled by tick_loop_profile (its
# numbers are per tick; cut from 500 for the script's 1,200 s limit: the
# profiler's own processing of every kernel it saw took most of the time)
PROFILE_TICKS = 100


def tick_loop_profile(make_run, ticks):
    """Where a sequential run's time goes: one warm call of ``make_run()``
    (a ``SimEngine`` run over ``ticks`` ticks) under ``torch.profiler`` —
    kernels launched per tick, device microseconds per tick — and the same
    call unprofiled: host wall microseconds per tick of its tick loop and
    the card's idle share there (1 - device time / loop wall)."""
    from torch.profiler import ProfilerActivity, profile
    make_run()
    sync()
    loop_s = make_run().elapsed_wall_s
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        make_run()
        sync()
    launches, dev_us = 0, 0.0
    for e in prof.key_averages():
        d = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if d > 0:
            launches += e.count
            dev_us += d
    return {"ticks": ticks, "kernels_per_tick": launches / ticks,
            "device_us_per_tick": dev_us / ticks,
            "loop_wall_us_per_tick": loop_s * 1e6 / ticks,
            "idle_share": 1.0 - dev_us / (loop_s * 1e6)}


def phase_closed_loop():
    """The example's default scenario on the card: the 12-tile platform, a
    1,000,000-request diurnal day over 8,700 ticks of 5 ms, fixed-max /
    membound / PID through ``SimEngine``.  The reference's gates; the
    fixed-max and membound runs against the same runs on the CPU; the
    fixed-max tick loop under sync-debug "error"; the controlled runs'
    syncs counted (at most one per control tick)."""
    ex = closed_loop_example()
    from repro_torch.sim import SimConfig, SimEngine
    plat = ex.build_platform()
    trace = ex.default_trace(plat, device=DEV)
    cfg = SimConfig(control_interval=CLOSED_LOOP_CI)
    control_ticks = trace.ticks // CLOSED_LOOP_CI
    report = {"phase": "closed_loop", "A": plat.n_tiles, "T": trace.ticks,
              "dt": trace.dt, "requests": trace.n_requests,
              "control_ticks": control_ticks}
    runs = {}
    for name in ("fixed-max", "dfs-membound", "dfs-pid"):
        ctl = ex.controllers(plat)[name]
        with SyncCount(strict=ctl is None) as syncs:
            r = SimEngine(plat, config=cfg, controller=ctl,
                          device=DEV).run(trace)
        runs[name] = r
        report[name] = seq_report(r, syncs)
        if syncs.loops != 1 or syncs.in_ticks > (
                0 if ctl is None else control_ticks):
            emit(report)
            raise SystemExit(f"closed_loop[{name}]: {syncs.in_ticks} syncs "
                             f"in the tick loop")
    for name in ("fixed-max", "dfs-membound"):
        t0 = time.perf_counter()
        host = SimEngine(plat, config=cfg,
                         controller=ex.controllers(plat)[name],
                         device="cpu").run(trace)
        gap = seq_gap(runs[name], host)
        report[name].update(cpu_wall_s=time.perf_counter() - t0,
                            cpu_ticks_per_s=host.ticks_per_s_wall,
                            vs_cpu=gap)
        if not seq_gap_ok(gap):
            emit(report)
            raise SystemExit(f"closed_loop[{name}]: the card disagrees "
                             f"with the CPU")
    # the first PROFILE_TICKS ticks of the membound run, profiled
    from repro_torch.sim import Trace
    short = Trace(trace.arrivals[:PROFILE_TICKS], trace.dt)
    report[f"profile_membound_{PROFILE_TICKS}"] = tick_loop_profile(
        lambda: SimEngine(plat, config=cfg,
                          controller=ex.controllers(plat)["dfs-membound"],
                          device=DEV).run(short), PROFILE_TICKS)
    try:
        report["membound_saving"] = ex.default_gate(runs)
    except AssertionError as e:
        emit(report)
        raise SystemExit(f"closed_loop: the energy gate fails: {e}")
    base = runs["fixed-max"]
    report["pid_saving"] = 1.0 - (runs["dfs-pid"].energy_per_request_j
                                  / base.energy_per_request_j)
    emit(report)
    return runs, {"plat": plat, "trace": trace, "cfg": cfg}


def phase_closed_loop_pipeline():
    """The ``--pipeline`` scenario on the card: fixed / DFS-only / LB-only
    / LB+DFS through ``SimEngine`` on the chained 3+3 platform and a
    5,000-tick hotspot trace, the scenario gate asserted; LB+DFS against
    the same run on the CPU."""
    ex = closed_loop_example()
    from repro_torch.sim import LoadBalancer, SimConfig, SimEngine
    plat, tr = ex.pipeline_platform(), ex.hotspot_trace()
    with SyncCount() as syncs:
        runs = ex.pipeline_runs(plat, tr, device=DEV)
    # DFS-only and LB+DFS copy one window per control tick; the balancer
    # adds none (its layout goes up before the loop)
    control_ticks = 2 * (tr.ticks // CLOSED_LOOP_CI)
    report = {"phase": "closed_loop_pipeline", "A": plat.n_tiles,
              "T": tr.ticks, "requests": tr.n_requests,
              "syncs_in_ticks": syncs.in_ticks, "loops": syncs.loops,
              "control_ticks": control_ticks,
              **{name: seq_report(r) for name, r in runs.items()}}
    if syncs.loops != len(runs) or syncs.in_ticks > control_ticks:
        emit(report)
        raise SystemExit("closed_loop_pipeline: more syncs in the tick "
                         "loops than control ticks")
    def lb_dfs(device, trace=tr):
        return SimEngine(
            plat, config=SimConfig(control_interval=CLOSED_LOOP_CI),
            controller=ex.controllers(plat)["dfs-membound"],
            balancer=LoadBalancer((ex.STAGE0, ex.STAGE1), plat.names),
            device=device).run(trace)

    from repro_torch.sim import Trace
    short = Trace(tr.arrivals[:PROFILE_TICKS], tr.dt)
    report[f"profile_lb_dfs_{PROFILE_TICKS}"] = tick_loop_profile(
        lambda: lb_dfs(DEV, short), PROFILE_TICKS)
    t0 = time.perf_counter()
    host = lb_dfs("cpu")
    gap = seq_gap(runs["lb+dfs"], host)
    report["lb+dfs"].update(cpu_wall_s=time.perf_counter() - t0, vs_cpu=gap)
    if not seq_gap_ok(gap):
        emit(report)
        raise SystemExit("closed_loop_pipeline: the card disagrees with "
                         "the CPU")
    try:
        report["saving_vs_dfs_only"], report["saving_vs_lb_only"] = \
            ex.pipeline_gate(runs)
    except AssertionError as e:
        emit(report)
        raise SystemExit(f"closed_loop_pipeline: the scenario gate fails: "
                         f"{e!r}")
    emit(report)


DSE_WIDE = dict(top=24, ticks=300)   # survivors whose scores differ


def _dse_rerank(ex, model, **kw):
    """One ``dse_score`` re-rank on the card and the same on the CPU: its
    report, and whether the card's survivors, ranking and p99 equal the
    CPU's and its energy per request lies within SEQ_RTOL."""
    t0 = time.perf_counter()
    res, card = ex.dse_score(model, device=DEV, **kw)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, host = ex.dse_score(model, device="cpu", **kw)
    ranked = card.ranked_indices()
    report = {"points": len(res), "survivors": int(card.indices.shape[0]),
              "wall_s": wall, "cpu_wall_s": time.perf_counter() - t0,
              "ticks_per_s": [r.ticks_per_s_wall for r in card.results],
              "ranked": ranked.tolist(),
              "distinct_scores": len(set(zip(
                  card.p99_latency_s.tolist(),
                  card.energy_per_request_j.tolist()))),
              "ranked_is_index_order": bool(np.array_equal(
                  ranked, np.sort(card.indices))),
              "p99_ms": (card.p99_latency_s * 1e3).tolist(),
              "energy_per_request_mj": (card.energy_per_request_j
                                        * 1e3).tolist(),
              "swaps": [r.swaps for r in card.results],
              "max_rel_vs_cpu": float(np.max(
                  np.abs(card.energy_per_request_j
                         - host.energy_per_request_j)
                  / host.energy_per_request_j))}
    same = (np.array_equal(card.indices, host.indices)
            and np.array_equal(ranked, host.ranked_indices())
            and np.array_equal(card.p99_latency_s, host.p99_latency_s)
            and report["max_rel_vs_cpu"] <= SEQ_RTOL)
    return report, same


def phase_closed_loop_dse():
    """The ``--dse`` re-rank through ``controller_factory=`` (the per-point
    sequential path, a PID harness per survivor) on the card, its ranking
    equal to the same call's on the CPU.  The example's six survivors
    score alike (their ranking is their index order), so the same re-rank
    over DSE_WIDE, whose survivors score differently, is held to the CPU
    too, and fails unless its ranking is other than index order."""
    ex = closed_loop_example()
    from repro_torch.core.perfmodel import SoCPerfModel
    model = SoCPerfModel()
    example, same = _dse_rerank(ex, model)
    wide, wide_same = _dse_rerank(ex, model, **DSE_WIDE)
    emit({"phase": "closed_loop_dse", **example,
          "wide": {**DSE_WIDE, **wide}})
    if not (same and wide_same):
        raise SystemExit("closed_loop_dse: the ranking on the card differs "
                         "from the CPU's")
    if wide["distinct_scores"] < 2 or wide["ranked_is_index_order"]:
        raise SystemExit("closed_loop_dse: the wide re-rank's scores do not "
                         "order its survivors, so its ranking check is "
                         "empty")


def phase_closed_loop_b1_fused(runs, ctx):
    """The membound and PID scenarios at B = 1 through
    ``BatchSimEngine("fused")`` (the tick_sim kernel) with the batch
    policies, against the sequential float64 engine's runs on the card:
    energy/request and p99 within B1_FUSED_RTOL; swaps printed.  The
    path's tick_sim launches are counted."""
    from repro_torch.core.dfs import BatchMemoryBoundPolicy, BatchPIDRatePolicy
    from repro_torch.kernels.tick_sim import fused_tick_sim
    from repro_torch.sim import (BatchControllerHarness, BatchSimEngine,
                                 BatchSimPlatform)
    bp = BatchSimPlatform.stack([ctx["plat"]])
    report = {"phase": "closed_loop_b1_fused", "rtol": B1_FUSED_RTOL}
    policies = {"dfs-membound": BatchMemoryBoundPolicy(threshold=0.55,
                                                       low_rate=0.5),
                "dfs-pid": BatchPIDRatePolicy(target=0.7)}
    fused_tick_sim.launches = 0
    ok = True
    for name, pol in policies.items():
        ctl = BatchControllerHarness(bp.islands, bp.rates, pol,
                                     tile_names=bp.names,
                                     queue_guard_ticks=3.0)
        f = BatchSimEngine(bp, config=ctx["cfg"], controller=ctl,
                           backend="fused", device=DEV).run(ctx["trace"])
        seq = runs[name]
        e_rel = abs(f.energy_per_request_j[0] / seq.energy_per_request_j
                    - 1.0)
        p_rel = abs(f.p99_latency_s[0] / seq.p99_latency_s - 1.0)
        report[name] = {"kernel_ms": f.timings["loop"] * 1e3,
                        "energy_per_request_rel": e_rel,
                        "p99_rel": p_rel,
                        "p99_ms": float(f.p99_latency_s[0]) * 1e3,
                        "swaps_fused": int(f.swaps[0]),
                        "swaps_sequential": seq.swaps}
        ok = ok and e_rel <= B1_FUSED_RTOL and p_rel <= B1_FUSED_RTOL
    report["tick_sim_launches"] = fused_tick_sim.launches
    emit(report)
    if fused_tick_sim.launches < len(policies):
        raise SystemExit("closed_loop_b1_fused: the path did not launch the "
                         "tick_sim kernel")
    if not ok:
        raise SystemExit("closed_loop_b1_fused: the kernel at B = 1 "
                         "disagrees with the sequential engine")


def fault_report(r, syncs=None) -> dict:
    return {**seq_report(r, syncs), "drop_rate": r.drop_rate,
            "dropped_slo": r.dropped_slo, "dropped_fault": r.dropped_fault,
            "retried": r.retried, "energy_j": r.energy_j}


def phase_closed_loop_faults():
    """``--faults`` on the card: the paper's replica-kill scenario
    (``examples/closed_loop.py:137-202``) through ``SimEngine`` — the 3+3
    chained dfmul pipeline at K 8, FAULT_TICKS ticks of 1 ms at 0.45 of
    stage capacity, be1 killed on [0.45 T, 0.65 T), a 50 ms deadline, an even
    balancer; fixed / DFS, each without and with recovery, and DFS with
    recovery and the online detector.  The example's gate; every run
    against the same run on the CPU (ledgers within FAULT_RTOL, p50 / p99
    / swaps / events exact, the same detection tick); syncs in the tick
    loops (none open loop, exactly one per control tick with DFS); ticks/s
    against the fault-free runs of the same platform and trace; kernels
    launched per tick (PROFILE_TICKS ticks profiled) with faults on and
    off."""
    ex = closed_loop_example()
    from repro_torch.sim import LoadBalancer, SimConfig, SimEngine, Trace
    plat = ex.pipeline_platform()
    tr = ex.surge_trace(plat, FAULT_TICKS, device=DEV)
    ks, ke = ex.kill_window(tr.ticks)
    control_ticks = tr.ticks // CLOSED_LOOP_CI
    report = {"phase": "closed_loop_faults", "A": plat.n_tiles,
              "T": tr.ticks, "requests": tr.n_requests, "kill": [ks, ke],
              "control_ticks": control_ticks, "rtol_vs_cpu": FAULT_RTOL}
    runs, ok = {}, True
    for name, (rec, dfs, det) in ex.FAULT_RUNS.items():
        with SyncCount(strict=not dfs) as syncs:
            runs[name] = ex.fault_run(plat, tr, recover=rec, dfs=dfs,
                                      detect=det, device=DEV)
        report[name] = fault_report(runs[name][1], syncs)
        want = control_ticks if dfs else 0
        report[name]["syncs_ok"] = (syncs.loops == 1
                                    and syncs.in_ticks == want)
        ok = ok and report[name]["syncs_ok"]
    if not ok:
        emit(report)
        raise SystemExit("closed_loop_faults: syncs in a tick loop other "
                         "than one per control tick")
    det_card = ex.detection_tick(runs["dfs,rec+detect"][2])
    report["detection_tick"] = det_card
    report["detection_latency_ticks"] = det_card - ks
    t0 = time.perf_counter()
    for name, (rec, dfs, det) in ex.FAULT_RUNS.items():
        _, host, sup = ex.fault_run(plat, tr, recover=rec, dfs=dfs,
                                    detect=det, device="cpu")
        gap = seq_gap(runs[name][1], host)
        report[name]["vs_cpu"] = gap
        report[name]["cpu_ticks_per_s"] = host.ticks_per_s_wall
        ok = ok and gap["max_rel"] <= FAULT_RTOL and seq_gap_ok(gap)
        if sup is not None:
            report["detection_tick_cpu"] = ex.detection_tick(sup)
            report["detector_events_equal"] = (
                sup.events == runs[name][2].events)
            ok = ok and report["detector_events_equal"] and (
                report["detection_tick_cpu"] == det_card)
    report["cpu_s"] = time.perf_counter() - t0
    if not ok:
        emit(report)
        raise SystemExit("closed_loop_faults: the card disagrees with the "
                         "CPU")

    # the same platform and trace without the fault machinery
    def fault_free(dfs, trace=tr):
        ctl = ex.controllers(plat)["dfs-membound"] if dfs else None
        return SimEngine(
            plat, config=SimConfig(control_interval=CLOSED_LOOP_CI),
            controller=ctl,
            balancer=LoadBalancer((ex.STAGE0, ex.STAGE1), plat.names,
                                  mode="even"), device=DEV).run(trace)

    for dfs, name, twin in ((False, "fault_free_fixed", "fixed,recovery"),
                            (True, "fault_free_dfs", "dfs,recovery")):
        r = fault_free(dfs)
        report[name] = {"ticks_per_s": r.ticks_per_s_wall,
                        "wall_s": r.elapsed_wall_s,
                        "faults_on_ticks_per_s":
                            report[twin]["ticks_per_s"],
                        "slowdown": (r.ticks_per_s_wall
                                     / report[twin]["ticks_per_s"])}
    short = Trace(tr.arrivals[:PROFILE_TICKS], tr.dt)
    report[f"profile_faults_{PROFILE_TICKS}"] = tick_loop_profile(
        lambda: ex.fault_run(plat, short, recover=True, dfs=True,
                             detect=True, device=DEV)[1], PROFILE_TICKS)
    report[f"profile_fault_free_{PROFILE_TICKS}"] = tick_loop_profile(
        lambda: fault_free(True, short), PROFILE_TICKS)
    try:
        ex.fault_gate(runs, tr)
    except AssertionError as e:
        emit(report)
        raise SystemExit(f"closed_loop_faults: the scenario gate fails: "
                         f"{e!r}")
    report["gate"] = "passed"
    emit(report)


# the replica-kill scenario's depth in phase closed_loop_faults (the
# example's 8,000 ticks cut to 500 for the script's 1,200 s limit; the kill
# window is the same share of the run, [0.45 T, 0.65 T), and the example's
# gate holds there: 8.65 % dropped without recovery, none with it)
FAULT_TICKS = 500

RERANK_FAULTS = dict(rate=0.2, link_scale=0.5, deadline_s=0.02,
                     max_drop_rate=0.02, check=64)


def rerank_fault_schedule(model, res, T):
    """One accelerator island stuck at 0.2 and one MEM-tile link degraded
    to 0.5, both over the middle third of the day."""
    from repro_torch.sim import FaultSchedule
    (r, c) = model.mem_pos
    a, b = T // 3, 2 * T // 3
    return (FaultSchedule()
            .stick_island(res.workloads[0].name, start=a, end=b,
                          rate=RERANK_FAULTS["rate"])
            .degrade_link((r, c), (r, c + 1), RERANK_FAULTS["link_scale"],
                          start=a, end=b))


def phase_rerank_faults(ctx):
    """``closed_loop_score`` under faults on the float64 ``"torch"`` loop at
    the main path's size (its 4,096 survivors of the 1.73 M-point sweep,
    8,700 diurnal ticks at 35 % of capacity, PID + guard 3.0):
    ``rerank_fault_schedule``, a 20 ms deadline, a 2 % drop budget.  The
    fault-free call on the same survivors beside it (loop / percentiles /
    copies); the faulted loop's syncs (one per control tick); 64 of the
    designs against the same call on the CPU: drop rate, p99 and their
    order exactly; the float32 loop at the same size against the float64
    one at the reference's float32 limits (drop rate rtol 1e-3 / atol
    1e-4, p99 atol dt)."""
    from repro_torch.core.dse import _rank_scores, closed_loop_score
    from repro_torch.sim import SLOConfig
    model, res, survivors = ctx["model"], ctx["res"], ctx["survivors"]
    trace, cfg = ctx["trace"], ctx["cfg"]
    T, B = trace.ticks, len(survivors)
    fs = rerank_fault_schedule(model, res, T)
    slo = SLOConfig(deadline_s=RERANK_FAULTS["deadline_s"])
    common = dict(model=model, req_mb=ctx["req_mb"], sim_config=cfg,
                  batch_controller_factory=pid_factory(), backend="torch")
    faults = dict(fault_schedule=fs, slo=slo,
                  max_drop_rate=RERANK_FAULTS["max_drop_rate"])
    report = {"phase": "rerank_faults", "B": B, "T": T, "A": 2,
              "schedule": [repr(e) for e in fs.events], **RERANK_FAULTS}
    for label, extra in (("fault_free", {}), ("faults", faults)):
        sync()
        t0 = time.perf_counter()
        with SyncCount() as syncs:
            score = closed_loop_score(res, trace, indices=survivors,
                                      **common, **extra)
        sync()
        r = score.results[0]
        report[label] = {
            "wall_s": time.perf_counter() - t0,
            "loop_s": r.timings["loop"],
            "percentiles_s": r.timings["percentiles"],
            "copies_s": r.timings["copies"],
            "syncs_in_ticks": syncs.in_ticks,
            "drop_rate_range": [float(r.drop_rate.min()),
                                float(r.drop_rate.max())],
            "p99_ms_range": [float(np.nanmin(r.p99_latency_s)) * 1e3,
                             float(np.nanmax(r.p99_latency_s)) * 1e3],
            "best_index": int(score.ranked_indices()[0])}
        if label == "faults":
            card = score
            if syncs.in_ticks != T // cfg.control_interval:
                emit(report)
                raise SystemExit("rerank_faults: syncs in the tick loop "
                                 "other than one per control tick")
    report["same_best_as_fault_free"] = (
        report["fault_free"]["best_index"] == report["faults"]["best_index"])
    sync()
    t0 = time.perf_counter()
    f32 = closed_loop_score(res, trace, indices=survivors,
                            **{**common, "dtype": torch.float32}, **faults)
    sync()
    r32 = f32.results[0]
    report["float32"] = {
        "wall_s": time.perf_counter() - t0, "loop_s": r32.timings["loop"],
        "drop_rate_within": bool(np.allclose(
            f32.drop_rate, card.drop_rate, rtol=1e-3, atol=1e-4)),
        "p99_within": bool(np.allclose(
            f32.p99_latency_s, card.p99_latency_s, rtol=1e-3,
            atol=trace.dt, equal_nan=True)),
        "drop_rate_max_abs": float(np.max(np.abs(f32.drop_rate
                                                 - card.drop_rate)))}
    if not (report["float32"]["drop_rate_within"]
            and report["float32"]["p99_within"]):
        emit(report)
        raise SystemExit("rerank_faults: the float32 loop disagrees with "
                         "the float64 one beyond the float32 limits")
    pick = np.arange(0, B, max(1, B // RERANK_FAULTS["check"]))[
        :RERANK_FAULTS["check"]]
    t0 = time.perf_counter()
    host = closed_loop_score(res, trace, indices=survivors[pick],
                             device="cpu", **common, **faults)
    sub = dict(p99=card.p99_latency_s[pick],
               ept=card.energy_per_request_j[pick],
               drop=card.drop_rate[pick])
    order = _rank_scores(sub["p99"], sub["ept"], None, drop_rate=sub["drop"],
                         max_drop_rate=RERANK_FAULTS["max_drop_rate"])
    report["check64"] = {
        "cpu_s": time.perf_counter() - t0,
        "drop_rate_equal": bool(np.array_equal(sub["drop"],
                                               host.drop_rate)),
        "p99_equal": bool(np.array_equal(sub["p99"], host.p99_latency_s,
                                         equal_nan=True)),
        "order_equal": bool(np.array_equal(order, host.order)),
        "energy_per_request_max_rel": float(np.nanmax(
            np.abs(sub["ept"] - host.energy_per_request_j)
            / np.abs(host.energy_per_request_j))),
        "designs_with_drops": int((host.drop_rate > 0).sum())}
    emit(report)
    c = report["check64"]
    if not (c["drop_rate_equal"] and c["p99_equal"] and c["order_equal"]):
        raise SystemExit("rerank_faults: the card's drop rates, p99 or "
                         "order differ from the CPU's")


def phase_fused_refuses_faults(ctx):
    """``backend="fused"`` refuses a fault schedule and an SLO on the card,
    at construction and when set before a run, and launches nothing."""
    from repro_torch.kernels.tick_sim import fused_tick_sim
    from repro_torch.sim import SLOConfig
    from repro_torch.sim.batch import BatchSimEngine
    fs = rerank_fault_schedule(ctx["model"], ctx["res"], ctx["trace"].ticks)
    knobs = {"faults": (fs, "fused backend does not simulate fault "
                            "schedules; use backend='torch'"),
             "slo": (SLOConfig(deadline_s=0.02), "fused backend does not "
                     "apply SLO semantics; use backend='torch'")}
    before = fused_tick_sim.launches
    report, ok = {"phase": "fused_refuses_faults"}, True
    for knob, (value, text) in knobs.items():
        said = []
        try:
            BatchSimEngine(ctx["plat"], config=ctx["cfg"], backend="fused",
                           **{knob: value})
        except NotImplementedError as e:
            said.append(str(e))
        eng = BatchSimEngine(ctx["plat"], config=ctx["cfg"], backend="fused")
        setattr(eng, knob, value)
        try:
            eng.run(ctx["trace"])
        except NotImplementedError as e:
            said.append(str(e))
        report[knob] = {"refusals": said,
                        "replayed": eng.last_histories is not None}
        ok = ok and said == [text, text] and eng.last_histories is None
    report["tick_sim_launches"] = fused_tick_sim.launches - before
    emit(report)
    if not ok or report["tick_sim_launches"]:
        raise SystemExit("fused_refuses_faults: the kernel backend did not "
                         "refuse faults / SLO as it should")


# ---------------------------------------------------------------------------
# observe: the run-time monitoring plane on the card
# ---------------------------------------------------------------------------

# the card's counter plane against the same run's on the CPU: sums add in
# another order on the card, so not bit for bit; stall counts exact
PLANE_RTOL = 1e-12
# the float32 loop's counters against the float64 plane of the same run
# (tests/test_observe.py:157-182): 2e-4 * max(|v|, 1) + 1e-6, stall exact
F32_PLANE = (2e-4, 1e-6)
PLANE_GROUPS = ("tile", "link", "island")


def plane_gap(card, host) -> dict:
    """The card's counter plane against the CPU's: the largest relative gap
    of any counter (to the CPU's value; where that is 0 the card's must be
    0 too), whether shapes, finiteness, the stall counts and the tick
    counts agree."""
    rel, worst, shapes, finite = 0.0, None, True, True
    for group in PLANE_GROUPS:
        mine, theirs = getattr(card, group), getattr(host, group)
        for k, b in theirs.items():
            a, b = np.asarray(mine.get(k)), np.asarray(b)
            if a.shape != b.shape:
                shapes = False
                continue
            finite = finite and np.array_equal(np.isfinite(a),
                                               np.isfinite(b))
            d = np.abs(a - b)
            r = np.where(b != 0.0, d / np.where(b != 0.0, np.abs(b), 1.0),
                         np.where(d > 0.0, np.inf, 0.0))
            m = float(np.nanmax(r)) if r.size else 0.0
            if m > rel:
                rel, worst = m, f"{group}.{k}"
    return {"max_rel": rel, "worst": worst, "shapes_equal": shapes,
            "finite_equal": bool(finite),
            "stall_equal": bool(np.array_equal(card.tile["stall_ticks"],
                                               host.tile["stall_ticks"])),
            "ticks_equal": bool(np.array_equal(card.ticks, host.ticks))}


def plane_ok(gap) -> bool:
    return (gap["max_rel"] <= PLANE_RTOL and gap["shapes_equal"]
            and gap["finite_equal"] and gap["stall_equal"]
            and gap["ticks_equal"])


def plane_planted_faults(plane):
    """Copies of ``plane`` with one counter perturbed each (at its largest
    element): what :func:`plane_ok` must reject."""
    import copy

    def planted(group, kind, fn):
        p = copy.deepcopy(plane)
        arr = np.array(getattr(p, group)[kind], dtype=np.float64)
        at = np.unravel_index(int(np.argmax(np.abs(arr))), arr.shape)
        arr[at] = fn(arr[at])
        getattr(p, group)[kind] = arr
        return p

    return [("hop_flits off by 1e-9", planted(
                "tile", "hop_flits", lambda v: v * (1.0 + 1e-9))),
            ("one stall tick more", planted(
                "tile", "stall_ticks", lambda v: v + 1.0)),
            ("peak link utilization off by 1e-9", planted(
                "link", "peak_util", lambda v: v * (1.0 + 1e-9))),
            ("island energy off by 1e-10", planted(
                "island", "energy_j", lambda v: v * (1.0 + 1e-10)))]


def f32_plane_ratio(f32, f64) -> dict:
    """The float32 plane against the float64 one: the largest ratio of any
    counter's gap to its tolerance ``2e-4 * max(|v|, 1) + 1e-6`` (<= 1
    passes) and whether the stall counts are equal."""
    rtol, atol = F32_PLANE
    worst, where = 0.0, None
    for group in PLANE_GROUPS:
        for k, v in getattr(f64, group).items():
            v = np.asarray(v)
            jv = np.asarray(getattr(f32, group)[k])
            ratio = np.abs(jv - v) / (rtol * np.maximum(np.abs(v), 1.0)
                                      + atol)
            m = float(np.max(ratio)) if ratio.size else 0.0
            if not np.isfinite(m) or m > worst:
                worst, where = m, f"{group}.{k}"
    return {"max_ratio": worst, "worst": where,
            "stall_equal": bool(np.array_equal(f32.tile["stall_ticks"],
                                               f64.tile["stall_ticks"]))}


def plane_rows(plane, rows):
    """The designs ``rows`` of a batched plane, as a plane of its own."""
    from repro_torch.sim.observe import CounterPlane
    return CounterPlane.from_arrays(
        **{g: {k: np.asarray(v)[rows] for k, v in getattr(plane, g).items()}
           for g in PLANE_GROUPS},
        ticks=np.asarray(plane.ticks)[rows], lead=(len(rows),),
        tile_names=plane.tile_names, island_names=plane.island_names)


def results_equal(a, b) -> bool:
    """Bit for bit the same simulated outputs (sequential or batched)."""
    return all(np.array_equal(getattr(a, f), getattr(b, f), equal_nan=True)
               for f in ("energy_j", "completed", "dropped", "residual",
                         "p50_latency_s", "p99_latency_s", "swaps",
                         "dropped_slo", "dropped_fault", "retried"))


# the order of a phase's observed and unobserved runs: in turns, so that a
# drift of the host's speed over the phase does not read as the plane's cost
# observe's runs of closed-loop-12tile-1M: these levels in turns, over the
# first OBSERVE_TICKS ticks of the day (58 control ticks; the whole day
# runs unobserved in closed_loop)
TURNS = ("off", "counters", "full", "off")
OBSERVE_TICKS = 1450
# rerank-A2 with the plane: B 4,096 over the day's first 1,450 ticks (the
# full 8,700 run unobserved in main_path and with faults in rerank_faults)
OBSERVE_RERANK_TICKS = 1450
# observe's replica-kill pipeline (its checks are equalities with the
# CPU's run; closed_loop_faults holds the example's gates at FAULT_TICKS)
OBSERVE_FAULT_TICKS = 500


def _in_turns(make, levels, want_syncs, fails, label, *, strict=False):
    """Sequential runs of ``make(level)`` in the order ``levels``: per level
    its ticks/s of each run, and every run's syncs in the tick loop held to
    ``want_syncs``; returns (report, {level: [(engine, result), ...]})."""
    rep, runs = {}, {}
    for level in levels:
        with SyncCount(strict=strict) as syncs:
            eng, r = make(level)
        runs.setdefault(level, []).append((eng, r))
        row = rep.setdefault(level, {"ticks_per_s": [],
                                     "syncs_in_ticks": []})
        row["ticks_per_s"].append(r.ticks_per_s_wall)
        row["syncs_in_ticks"].append(syncs.in_ticks)
        if syncs.loops != 1 or syncs.in_ticks != want_syncs:
            fails.append(f"{label}[{level}]: {syncs.in_ticks} syncs in the "
                         f"tick loop, not {want_syncs}")
    off = runs["off"][0][1]
    for level, rs in runs.items():
        rep[level]["equal_to_off"] = all(results_equal(r, off)
                                         for _, r in rs)
        if not rep[level]["equal_to_off"]:
            fails.append(f"{label}[{level}]: observing changed the run")
    return rep, runs


def phase_observe(cl_ctx, main_ctx):
    """The monitoring plane at full size on the card.

    closed-loop-12tile-1M (membound), cut to its first OBSERVE_TICKS ticks:
    runs at ``observe`` off / ``"counters"`` / ``"full"`` in turns
    (``TURNS``) — outputs bit for bit
    equal, syncs in the tick loop one per control tick at every level,
    ticks/s per level, kernels per tick (PROFILE_TICKS profiled, off and
    full in turns); the plane's reconstruction (``finalize``) and
    ``export_metrics`` timed; the plane within PLANE_RTOL of the CPU run's
    (stall counts exact) and the trace the CPU's JSONL, a check that must
    reject ``plane_planted_faults``.  closed-loop-faults-pipeline
    (``OBSERVE_FAULT_TICKS`` ticks, the kill window the same share): DFS +
    recovery + detector and the open-loop fixed + recovery run, each off
    and at ``"full"``, the same checks (no sync at all in the open-loop
    loop, under sync-debug "error").  rerank-A2: ``closed_loop_score`` at
    B 4,096 x T 1,450 on the float64 ``"torch"`` loop, unobserved then
    ``observe="counters"``, and on the float32 loop
    unobserved then observed (loop s, finalize s, device peak memory), over
    the first ``OBSERVE_RERANK_TICKS`` ticks; 64 designs' float64 planes
    against the CPU's, the float32 plane against the float64 one.
    ``"fused"`` refuses ``observe=`` and launches nothing; the chunked
    sweep's ``sweep_chunk`` phases are timed by CUDA events."""
    ex = closed_loop_example()
    from repro_torch.core.dse import closed_loop_score
    from repro_torch.kernels.tick_sim import fused_tick_sim
    from repro_torch.sim import (Observer, Profiler, SimEngine, Trace,
                                 export_metrics, get_profiler, reset_profiler)
    from repro_torch.sim.batch import BatchSimEngine
    report, fails = {"phase": "observe", "plane_rtol": PLANE_RTOL}, []

    # -- closed-loop-12tile-1M, membound DFS, its first OBSERVE_TICKS ticks
    plat, cfg = cl_ctx["plat"], cl_ctx["cfg"]
    trace = Trace(cl_ctx["trace"].arrivals[:OBSERVE_TICKS],
                  cl_ctx["trace"].dt)
    control_ticks = trace.ticks // CLOSED_LOOP_CI

    def membound(level, device=DEV, tr=trace):
        eng = SimEngine(plat, config=cfg,
                        controller=ex.controllers(plat)["dfs-membound"],
                        observe=level, device=device)
        return eng, eng.run(tr)

    cl, runs = _in_turns(membound, TURNS, control_ticks, fails,
                         "closed_loop")
    cl.update(T=trace.ticks, control_ticks=control_ticks)
    eng, r = runs["full"][0]
    ob = eng.observer
    sync()
    t0 = time.perf_counter()
    plane = ob.counters
    cl["finalize_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    text = export_metrics(telemetry=r.telemetry, counters=plane,
                          trace=ob.trace).render_prometheus()
    cl["export_metrics_s"] = time.perf_counter() - t0
    cl["export_lines"] = len(text.splitlines())
    cl["trace_counts"] = ob.trace.counts()
    t0 = time.perf_counter()
    h_eng, _ = membound("full", "cpu")
    host = h_eng.observer.counters
    cl["cpu_s"] = time.perf_counter() - t0
    cl["vs_cpu"] = plane_gap(plane, host)
    cl["trace_equal_cpu"] = (ob.trace.to_jsonl()
                             == h_eng.observer.trace.to_jsonl())
    cl["planted_faults_passed"] = [
        label for label, bad in plane_planted_faults(host)
        if plane_ok(plane_gap(bad, host))]
    if not (plane_ok(cl["vs_cpu"]) and cl["trace_equal_cpu"]):
        fails.append("closed_loop: the plane or trace differs from the CPU's")
    if cl["planted_faults_passed"]:
        fails.append("the plane check passed a planted fault")
    short = Trace(trace.arrivals[:PROFILE_TICKS], trace.dt)
    for level in ("off", "full", "full", "off"):
        cl.setdefault(f"profile_{PROFILE_TICKS}_{level}", []).append(
            tick_loop_profile(lambda level=level: membound(level, tr=short)[1],
                              PROFILE_TICKS))
    report["closed_loop_12tile_1M"] = cl

    # -- closed-loop-faults-pipeline
    fplat = ex.pipeline_platform()
    ftr = ex.surge_trace(fplat, OBSERVE_FAULT_TICKS, device=DEV)
    fr = {"T": ftr.ticks}
    for name in ("dfs,rec+detect", "fixed,recovery"):
        rec, dfs, det = ex.FAULT_RUNS[name]

        def fault(level, device=DEV):
            e, res, _ = ex.fault_run(fplat, ftr, recover=rec, dfs=dfs,
                                     detect=det, device=device,
                                     observe=level)
            return e, res

        out, got = _in_turns(fault, ("off", "full"),
                             ftr.ticks // CLOSED_LOOP_CI if dfs else 0,
                             fails, f"faults[{name}]", strict=not dfs)
        e = got["full"][0][0]
        h, _ = fault("full", "cpu")
        out["vs_cpu"] = plane_gap(e.observer.counters, h.observer.counters)
        out["trace_equal_cpu"] = (e.observer.trace.to_jsonl()
                                  == h.observer.trace.to_jsonl())
        out["trace_counts"] = e.observer.trace.counts()
        fr[name] = out
        if not (plane_ok(out["vs_cpu"]) and out["trace_equal_cpu"]):
            fails.append(f"faults[{name}]: the plane or trace differs from "
                         f"the CPU's")
    report["closed_loop_faults_pipeline"] = fr

    # -- rerank-A2: the float64 loop with counters, and float32 at full B
    model, res, survivors = main_ctx["model"], main_ctx["res"], \
        main_ctx["survivors"]
    rtrace = Trace(main_ctx["trace"].arrivals[:OBSERVE_RERANK_TICKS],
                   main_ctx["trace"].dt)
    rcfg = main_ctx["cfg"]
    common = dict(model=model, req_mb=main_ctx["req_mb"], sim_config=rcfg,
                  batch_controller_factory=pid_factory(), backend="torch")
    want = rtrace.ticks // rcfg.control_interval
    rr = {"B": len(survivors), "T": rtrace.ticks}
    planes = {}
    for dtype, label, levels in (
            (torch.float64, "float64", ("off", "counters")),
            (torch.float32, "float32", ("off", "counters"))):
        rows, results = {}, {}
        for level in levels:
            ob = (None if level == "off"
                  else Observer(level, profiler=Profiler()))
            sync()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            with SyncCount() as syncs:
                sc = closed_loop_score(res, rtrace, indices=survivors,
                                       observe=ob, dtype=dtype, **common)
            sync()
            row = rows.setdefault(level, {"loop_s": [], "peak_bytes": []})
            row["loop_s"].append(sc.results[0].timings["loop"])
            # above what was allocated before the call
            row["peak_bytes"].append(
                int(torch.cuda.max_memory_allocated() - base))
            if syncs.in_ticks != want:
                fails.append(f"rerank[{label}, {level}]: {syncs.in_ticks} "
                             f"syncs in the tick loop, not {want}")
            if ob is not None:
                row.setdefault("finalize_s", []).append(
                    ob.profiler.summary()["counters_finalize"]["total_s"])
                planes.setdefault(label, ob.counters)
                if len(sc.counters) != len(survivors):
                    fails.append(f"rerank[{label}]: summaries missing")
            results.setdefault(level, []).append(sc.results[0])
        rows["equal_to_off"] = all(results_equal(x, results["off"][0])
                                   for x in results["counters"])
        if not rows["equal_to_off"]:
            fails.append(f"rerank[{label}]: observing changed the run")
        rr[label] = rows
    pick = np.arange(0, len(survivors), max(1, len(survivors) // 64))[:64]
    hob = Observer("counters")
    t0 = time.perf_counter()
    closed_loop_score(res, rtrace, indices=survivors[pick], device="cpu",
                      observe=hob, **common)
    rr["check64_cpu_s"] = time.perf_counter() - t0
    rr["check64"] = plane_gap(plane_rows(planes["float64"], pick),
                              hob.counters)
    rr["float32_vs_float64"] = f32_plane_ratio(planes["float32"],
                                               planes["float64"])
    if not plane_ok(rr["check64"]):
        fails.append("rerank: 64 designs' planes differ from the CPU's")
    if not np.all(np.isfinite(planes["float32"].tile["invocations"])):
        fails.append("rerank: the float32 plane is not finite")
    report["rerank_A2"] = rr

    # -- "fused" refuses observe=, and launches nothing
    before = fused_tick_sim.launches
    said = []
    try:
        BatchSimEngine(main_ctx["plat"], config=rcfg, backend="fused",
                       observe="counters")
    except NotImplementedError as e:
        said.append(str(e))
    feng = BatchSimEngine(main_ctx["plat"], config=rcfg, backend="fused")
    feng.observer = Observer("full")
    try:
        feng.run(rtrace)
    except NotImplementedError as e:
        said.append(str(e))
    text = "fused backend records no observer plane; use backend='torch'"
    report["fused_refuses"] = {
        "refusals": said, "launches": fused_tick_sim.launches - before}
    if said != [text, text] or fused_tick_sim.launches != before:
        fails.append("fused did not refuse observe= as it should")

    # -- the chunked sweep's phases, timed by CUDA events (no sync added)
    from repro_torch.configs.vespa_soc import CHSTONE
    from repro_torch.core.perfmodel import AccelWorkload
    wls = [AccelWorkload(n, *CHSTONE[n]) for n in ISLANDS["accels"]]
    reset_profiler()
    sw, sw_s, _ = timed_sweep(model, wls, chunked_axes(ISLANDS),
                              chunk_points=ISLANDS["chunk"], device=None,
                              backend="torch")
    phase = get_profiler().summary().get("sweep_chunk", {})
    report["sweep_chunk_profile"] = {
        "n_chunks": sw.n_chunks, "count": phase.get("count"),
        "device_s": phase.get("total_s"), "sweep_wall_s": sw_s}
    if phase.get("count") != sw.n_chunks or not phase.get("total_s"):
        fails.append("the chunked sweep's phases were not profiled")
    reset_profiler()
    report["failures"] = fails
    emit(report)
    if fails:
        raise SystemExit("observe: " + "; ".join(fails))
    return report


# ---------------------------------------------------------------------------


def llm_kernels():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.fused_mlp import fused_rmsnorm_mlp
    return {"flash_attention": flash_attention, "flash_decode": flash_decode,
            "fused_mlp": fused_rmsnorm_mlp}


def all_kernels():
    """The LLM kernels and ``ssd_scan``: every count a serving run resets."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {**llm_kernels(), "ssd_scan": ssd_scan}


def _randn(gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device=DEV) * scale
            ).to(dtype)


def _err(a, b):
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def row_rel_err(out, ref) -> float:
    """Largest error over an output row (last dim) divided by the largest
    |value| of that row of ``ref``; a row of zeros in ``ref`` (a query with
    no live key) counts its absolute error."""
    if not ref.numel():
        return 0.0
    o, r = out.double(), ref.double()
    err, top = (o - r).abs().amax(-1), r.abs().amax(-1)
    return float(torch.where(top > 0, err / top.clamp(min=1e-300), err).max())


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (2^(e - 7) for |x| in [2^e, 2^(e+1)))."""
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def mlp_limit(ref: torch.Tensor, atol: float) -> torch.Tensor:
    """The bf16 MLP's limit per element: max(atol, one bf16 ulp of |ref|)."""
    return torch.clamp(bf16_ulp(ref), min=atol)


def llm_check(kind, out, ref, dtype):
    """``out`` held against ``ref``: shape, finite, abs error within
    LLM_ATOL (for the bf16 MLP: within ``mlp_limit`` per element;
    ``max_excess`` is the largest error less its element's limit) and, for
    attention, row-relative error within LLM_ROW_RTOL."""
    atol = LLM_ATOL[(kind, dtype)]
    res = {"max_abs_err": _err(out, ref),
           "max_row_rel_err": row_rel_err(out, ref),
           "tolerance": atol,
           "row_rtol": LLM_ROW_RTOL[dtype] if kind == "attention" else None}
    same = tuple(out.shape) == tuple(ref.shape)
    if (kind, dtype) in ULP_AWARE:
        res["limit"] = "max(atol, 1 bf16 ulp of |ref|)"
        res["max_excess"] = (float(((out.float() - ref.float()).abs()
                                    - mlp_limit(ref, atol)).max())
                             if same and ref.numel() else 0.0)
        within = res["max_excess"] <= 0.0
    else:
        within = res["max_abs_err"] <= atol
    res["ok"] = (same and bool(torch.isfinite(out.float()).all()) and within
                 and (res["row_rtol"] is None
                      or res["max_row_rel_err"] <= res["row_rtol"]))
    return res


def planted_faults(name, args, plain, ref, split=512, tile=64):
    """What a faulty attention kernel would return on ``args``, made with
    the plain version: all zeros; one ``split`` of cache slots left out
    (decode) or, for the last ``tile`` queries, one ``tile`` of keys in the
    middle of their window (prefill); the window one key short.  The check
    must reject each."""
    from repro_torch.models.layers import UNWRITTEN
    q, k, v, qpos, kpos, window, scale = args
    out = {"zero": torch.zeros_like(ref)}
    n_keys = k.shape[1]
    if name == "flash_decode":
        k0 = (n_keys // split // 2) * split
        kp = kpos.clone()
        kp[:, k0:k0 + split] = UNWRITTEN
        out["dropped_split"] = plain(q, k, v, qpos, kp, window, scale)
    else:
        last = int(qpos[0, -1])
        k0 = max(0, last - (window or last + 1) // 2) // tile * tile
        kp = kpos.clone()
        kp[:, k0:k0 + tile] = UNWRITTEN
        f = ref.clone()
        f[:, -tile:] = plain(q[:, -tile:].contiguous(), k, v,
                             qpos[:, -tile:].contiguous(), kp, window, scale)
        out["dropped_tile"] = f
    if window > 1:
        out["window_one_short"] = plain(q, k, v, qpos, kpos, window - 1,
                                        scale)
    return out


def head_tail_faults(args, plain, ref, tail=16, box=64):
    """What an attention kernel that lost the part of the head dim past
    its first 64-column TMA box would return on ``args`` (head dims 80 and
    112 load each row as two boxes), made with the plain version: the
    scores without the last ``tail`` dims (Q K^T's last k step dropped) and
    the output's columns past ``box`` left at zero (P V's second box lost).
    The check must reject each."""
    q, k, v, qpos, kpos, window, scale = args
    q2 = q.clone()
    q2[..., -tail:] = 0
    cut = ref.clone()
    cut[..., box:] = 0
    return {"scores_tail_dropped": plain(q2, k, v, qpos, kpos, window, scale),
            "out_second_box_zero": cut}


def attention_case(gen, B, Sq, Sk, KV, G, hd, hdv, window, dtype,
                   qpos=None, kpos=None):
    """Inputs of one flash_attention call (positions: arange by default)."""
    q = _randn(gen, (B, Sq, KV, G, hd), dtype)
    k = _randn(gen, (B, Sk, KV, hd), dtype)
    v = _randn(gen, (B, Sk, KV, hdv), dtype)
    if qpos is None:
        qpos = torch.arange(Sq, dtype=torch.int32, device=DEV
                            ).expand(B, Sq).contiguous()
    if kpos is None:
        kpos = torch.arange(Sk, dtype=torch.int32, device=DEV
                            ).expand(B, Sk).contiguous()
    return (q, k, v, qpos, kpos, window, 1.0 / float(np.sqrt(hd)))


def decode_case(gen, B, W, KV, G, hd, hdv, window, dtype, pos):
    """Inputs of one flash_decode call over a ring cache at positions
    ``pos`` (B,), unwritten slots included."""
    from repro_torch.models.layers import ring_kpos
    q = _randn(gen, (B, KV, G, hd), dtype)
    ck = _randn(gen, (B, W, KV, hd), dtype)
    cv = _randn(gen, (B, W, KV, hdv), dtype)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=DEV)
    return (q, ck, cv, pos, ring_kpos(pos, W), window,
            1.0 / float(np.sqrt(hd)))


def mlp_case(gen, N, d, F, act, dtype):
    return (_randn(gen, (N, d), dtype), _randn(gen, (d,), dtype, 0.1),
            _randn(gen, (d, F), dtype, 0.02), _randn(gen, (d, F), dtype, 0.02),
            act, 1e-5)


def mlp_planted_faults(args, ref, strip=64, krows=64):
    """What a faulty fused MLP would return on ``args``, made with the
    plain version: one ``krows`` range of d left out of one ``strip`` of
    columns (a lost segment of a split strip), one strip's outputs left at
    zero, gate and up swapped.  The check must reject each."""
    from repro_torch.kernels.fused_mlp import fused_rmsnorm_mlp_plain
    x, scale, wg, wu, act, eps = args
    d, F = wg.shape
    cols = slice((F // strip // 2) * strip, (F // strip // 2 + 1) * strip)
    k0 = (d // krows // 2) * krows
    wg2, wu2 = wg[:, cols].clone(), wu[:, cols].clone()
    wg2[k0:k0 + krows] = 0
    wu2[k0:k0 + krows] = 0
    lost = ref.clone()
    lost[:, cols] = fused_rmsnorm_mlp_plain(x, scale, wg2, wu2, act, eps)
    zero = ref.clone()
    zero[:, cols] = 0
    return {"dropped_k_range": lost, "dropped_strip": zero,
            "gate_up_swapped": fused_rmsnorm_mlp_plain(x, scale, wu, wg, act,
                                                       eps)}


def mlp_faults_rejected(args, ref):
    """``llm_check`` put to each of ``mlp_planted_faults``: per fault its
    error, excess and whether it was rejected."""
    out = {}
    for fault, bad in mlp_planted_faults(args, ref).items():
        c = llm_check("mlp", bad, ref, args[0].dtype)
        out[fault] = {"max_abs_err": c["max_abs_err"],
                      "max_excess": c.get("max_excess"),
                      "rejected": not c["ok"]}
    return out


# The wgmma/TMA kernels' edges (bfloat16; tests/test_torch_llm_kernels.py
# holds the same cases): B, Sq, Sk, KV, G, hd, window, query positions
# (kind, first), key positions ("perm": a random permutation)
EDGE_ATTN = (
    (2, 200, 200, 2, 2, 80, 0, ("arange", 0), "arange"),    # ragged tiles
    (1, 150, 400, 2, 4, 128, 0, ("arange", 250), "arange"),  # Sk > Sq
    (1, 150, 400, 1, 2, 64, 100, ("arange", 250), "arange"),  # + window
    (1, 300, 300, 2, 2, 64, 0, ("perm", 0), "perm"),        # non-monotone
    (1, 260, 260, 1, 2, 128, 90, ("perm", 0), "perm"),
    (1, 512, 512, 2, 2, 80, 130, ("arange", 0), "arange"),  # live by window
    (1, 300, 300, 2, 2, 80, 0, ("arange", -40), "arange"),  # rows no key
    (2, 1000, 1000, 2, 4, 80, 300, ("arange", 0), "arange"),  # full tiles
    (1, 384, 384, 1, 1, 128, 0, ("arange", 0), "arange"),   # exact tiles
    # zamba2's head dim 112 (two TMA boxes, 16 columns of zero fill), G 1
    (2, 200, 330, 2, 1, 112, 0, ("arange", 130), "arange"),  # ragged, offset
    (1, 300, 300, 4, 1, 112, 100, ("arange", 0), "arange"),  # a window
    (1, 260, 260, 2, 2, 112, 0, ("perm", 0), "perm"),       # non-monotone
    (1, 300, 300, 2, 1, 112, 0, ("arange", -40), "arange"),  # rows no key
)
# N, d, F, act: ragged rows, h2o-danube's and a 5,632 width, F and d off
# the 128 / 64 tiles, gelu
EDGE_MLP = ((200, 256, 384, "silu"), (300, 2560, 6912, "silu"),
            (150, 2048, 5632, "gelu"), (130, 512, 1000, "gelu"),
            (100, 200, 136, "silu"))


# The gemv_tma decode kernel's edges (bfloat16; tests/
# test_torch_llm_kernels.py holds the same cases): N, d, F, act at every
# dense config's (d, F) (configs/*.py), N from 1 to 8, silu and gelu; F off
# the 64-column strip, and d off the 64-row chunk too
DENSE_WIDTHS = ((2048, 16384), (4096, 14336), (2560, 6912), (2048, 8192),
                (5120, 17920), (8192, 22016))
EDGE_MLP_ROWS = tuple((N, d, F, "gelu" if N in (1, 3) else "silu")
                      for d, F in DENSE_WIDTHS for N in (1, 3, 4, 8)) + (
    (4, 2560, 1000, "gelu"), (3, 200, 1000, "silu"))
# a decode x that is not 16-byte aligned: no TMA operand, the rows kernel
MISALIGNED_MLP_ROWS = (4, 2560, 6912, "silu")


# The cp_async decode sweep's edges (bfloat16 cache; tests/
# test_torch_llm_kernels.py holds the same cases): B, W, KV, G, hd, hd_v,
# window, positions, kv_block, q dtype, ring ("perm": slots and positions
# permuted, an unwritten run in the middle)
EDGE_DECODE = (
    (3, 1000, 2, 4, 64, 64, 0, (5, 999, 2500), 512, "bf16", "ring"),
    (2, 333, 1, 8, 128, 128, 100, (50, 700), 37, "bf16", "ring"),
    (2, 2048, 2, 4, 80, 80, 0, (3000, 3000), 512, "bf16", "perm"),
    (2, 2048, 2, 4, 80, 80, 0, (100, 100), 512, "bf16", "ring"),  # dead splits
    (4, 4096, 8, 4, 80, 80, 4096, (4638, 4639, 3103, 2300), 512, "bf16",
     "ring"),
    (2, 4096, 1, 16, 128, 128, 0, (10, 5000), 512, "bf16", "ring"),  # 2,048
    (2, 500, 2, 2, 72, 72, 0, (100, 900), 512, "bf16", "ring"),     # hd % 16
    (2, 500, 2, 5, 128, 64, 200, (499, 900), 512, "f32", "ring"),   # f32 q
)
# The tf32x3 scan's edges: B, L, nh, hd, st, chunk, dt draw (Q = 1, 8, 100,
# 256; st 16 / 128; hd 32 / 64; large dt)
EDGE_SSD = (
    (2, 256, 3, 32, 16, 1, "normal"),
    (1, 64, 4, 32, 16, 8, "normal"),
    (1, 200, 2, 64, 128, 100, "large_dt"),
    (1, 1024, 8, 32, 128, 256, "mamba"),
    (1, 512, 4, 64, 16, 256, "mamba"),
    (2, 768, 4, 64, 128, 256, "large_dt"),
)

# One case of each wrapper with an operand that is not 16-byte aligned
# (tests/test_torch_*.py hold them too): decode B, W, KV, G, hd, hd_v,
# window, positions, kv_block with the cache shifted; the scan's B, L, nh,
# hd, st, chunk, dt draw with xs shifted (two chunks: the state pass runs)
MISALIGNED_DECODE = (2, 300, 2, 4, 80, 80, 0, (100, 400), 512)
MISALIGNED_SSD = (1, 512, 4, 64, 128, 256, "mamba")


def misaligned(t):
    """``t`` copied into a contiguous view that starts one element into
    its buffer, so not 16-byte aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


def edge_decode_case(gen, B, W, KV, G, hd, hdv, win, pos, qdtype, ring):
    """Inputs of one EDGE_DECODE call; ``perm``: a run of W / 4 slots
    unwritten, then slots and their positions permuted alike."""
    a = list(decode_case(gen, B, W, KV, G, hd, hdv, win, torch.bfloat16,
                         list(pos)))
    a[0] = a[0].to(torch.float32 if qdtype == "f32" else torch.bfloat16)
    if ring == "perm":
        from repro_torch.models.layers import UNWRITTEN
        kp = a[4].clone()
        kp[:, W // 8:W // 8 + W // 4] = UNWRITTEN
        perm = torch.randperm(W, generator=gen, device=DEV)
        a[1], a[2], a[4] = (t[:, perm].contiguous() for t in (a[1], a[2], kp))
    return tuple(a)


def edge_positions(gen, kind, n, first):
    if kind == "perm":
        p = torch.randperm(n, generator=gen, device=DEV) + first
    else:
        p = torch.arange(first, first + n, device=DEV)
    return p.to(torch.int32)[None]


# ssd_scan parity cases: B, L, nh, hd, st, chunk, dt draw (see ssd_case)
SSD_CASES = (
    (2, 128, 3, 32, 16, 32, "normal"),      # the four shapes of
    (1, 64, 1, 8, 8, 16, "normal"),         # tests/test_kernels.py:52-57
    (1, 256, 2, 64, 128, 64, "normal"),
    (3, 96, 4, 16, 32, 32, "normal"),
    (1, 100, 32, 64, 128, 256, "normal"),   # a ragged single chunk
    (2, 1, 4, 64, 128, 256, "normal"),      # L = 1
    (1, 2, 8, 64, 128, 256, "normal"),      # L = 2
    (3, 150, 5, 20, 24, 50, "normal"),      # Q = 50, widths off the tiles
    (2, 320, 6, 64, 128, 160, "mamba"),     # Q = 160: a ragged last tile
    (1, 512, 4, 64, 128, 256, "large_dt"),  # exp above the diagonal overflows
    (1, 2048, 32, 64, 128, 256, "mamba"),   # 8 chunks at the path's widths
)


def ssd_case(gen, B, L, nh, hd, st, kind="normal"):
    """Inputs of one ssd_scan call, float32.  ``normal``: the draws of
    tests/test_kernels.py (dt = softplus(N(0,1)), A = -exp(0.2 N(0,1)));
    ``large_dt``: that dt times 50, so exp(la_i - la_j) overflows above the
    diagonal; ``mamba``: Mamba-2's initialisation ranges, A in -[1, 16] and
    a dt per head log-uniform in [1e-3, 1e-1] (times exp(0.5 N(0,1)) per
    token), so some heads keep their state over many chunks and others
    forget it within a few tokens."""
    f32 = torch.float32
    xs = _randn(gen, (B, L, nh, hd), f32)
    Bm, Cm = (_randn(gen, (B, L, st), f32) for _ in range(2))
    D = _randn(gen, (nh,), f32)
    if kind == "mamba":
        A = -(1.0 + 15.0 * torch.rand((nh,), generator=gen, device=DEV))
        lo, hi = float(np.log(1e-3)), float(np.log(1e-1))
        dt_head = torch.exp(lo + (hi - lo) * torch.rand(
            (nh,), generator=gen, device=DEV))
        dt = dt_head * torch.exp(0.5 * _randn(gen, (B, L, nh), f32))
    else:
        A = -torch.exp(0.2 * _randn(gen, (nh,), f32))
        dt = torch.nn.functional.softplus(_randn(gen, (B, L, nh), f32))
        if kind == "large_dt":
            dt = dt * 50.0
    return xs, dt.contiguous(), A.contiguous(), Bm, Cm, D


def head_rel_err(out, ref, dims) -> float:
    """Largest error over each (batch, head) slice (the ``dims`` reduced)
    divided by the largest |value| of that slice of ``ref``; a slice of
    zeros in ``ref`` counts its absolute error."""
    if not ref.numel():
        return 0.0
    o, r = out.double(), ref.double()
    err, top = (o - r).abs().amax(dims), r.abs().amax(dims)
    return float(torch.where(top > 0, err / top.clamp(min=1e-300), err).max())


def ssd_check(y, h, ref_y, ref_h):
    """(y, h) held against (ref_y, ref_h): shapes, finite, per element
    |err| <= SSD_TOL + SSD_TOL * |ref| (``max_excess`` = the largest
    |err| - SSD_TOL * |ref|), and per (batch, head) max |err| / max |ref|
    <= SSD_TOL (``max_row_rel_err``: for ``ssd_scan`` a row is one
    (batch, head) of y or of h)."""
    res = {"tolerance": SSD_TOL, "row_rtol": SSD_TOL}
    if y.shape != ref_y.shape or h.shape != ref_h.shape:
        return {**res, "max_abs_err": float("inf"), "max_excess": float("inf"),
                "max_row_rel_err": float("inf"), "ok": False}
    excess = 0.0
    for a, b in ((y, ref_y), (h, ref_h)):
        if a.numel():
            d = (a.double() - b.double()).abs() - SSD_TOL * b.double().abs()
            excess = max(excess, float(d.max()))
    res.update(max_abs_err=max(_err(y, ref_y), _err(h, ref_h)),
               max_excess=excess,
               max_row_rel_err=max(head_rel_err(y, ref_y, (1, 3)),
                                   head_rel_err(h, ref_h, (2, 3))))
    res["ok"] = (bool(torch.isfinite(y).all())
                 and bool(torch.isfinite(h).all()) and excess <= SSD_TOL
                 and res["max_row_rel_err"] <= SSD_TOL)
    return res


def ssd_planted_faults(args, chunk, ref):
    """What a faulty ssd_scan would return on ``args``, made with the plain
    version: the state carry dropped at the middle chunk boundary (both
    halves scanned from a zero state); the D term left out; the decay
    shifted by one position (la exclusive instead of inclusive); the first
    super-diagonal let through the causal mask (y_i also gets
    (C_i . B_{i+1}) exp(la_i - la_{i+1}) dt_{i+1} x_{i+1} within a chunk).
    The check must reject each."""
    from repro_torch.kernels.ssd_scan import (chunk_cumsum, chunk_len,
                                              ssd_chunks_plain,
                                              ssd_scan_plain)
    xs, dt, A, Bm, Cm, D = args
    ref_y, ref_h = ref
    L = xs.shape[1]
    Q = chunk_len(L, chunk)
    out = {}
    if L // Q > 1:
        k = (L // Q // 2) * Q
        part = [tuple(t[:, lo:hi].contiguous() for t in (xs, dt, Bm, Cm))
                for lo, hi in ((0, k), (k, L))]
        y1, _ = ssd_scan_plain(*part[0][:2], A, *part[0][2:], D, chunk)
        y2, h2 = ssd_scan_plain(*part[1][:2], A, *part[1][2:], D, chunk)
        out["carry_dropped"] = (torch.cat([y1, y2], dim=1), h2)
    out["no_D"] = ssd_scan_plain(xs, dt, A, Bm, Cm, torch.zeros_like(D),
                                 chunk)
    la = chunk_cumsum(dt * A, Q)
    out["decay_shifted"] = ssd_chunks_plain(xs, dt, la - dt * A, Bm, Cm, D,
                                            Q)
    if Q > 1:
        same_chunk = (torch.arange(L - 1, device=xs.device) % Q) != Q - 1
        cb = (Cm[:, :-1] * Bm[:, 1:]).sum(-1)                     # (B, L-1)
        w = torch.exp(la[:, :-1] - la[:, 1:]) * dt[:, 1:]         # (B,L-1,nh)
        term = (cb[..., None] * w)[..., None] * xs[:, 1:]
        y = ref_y.clone()
        y[:, :-1] += torch.where(same_chunk[None, :, None, None], term, 0.0)
        out["superdiag"] = (y, ref_h)
    return out


def phase_llm_kernels():
    """Each LLM kernel against its plain version on the card at small and
    edge shapes: head dim 80, ragged tiles, windows, a query row with no
    live key, ring caches with unwritten slots, G from 1 to 8, silu and
    gelu, float32 and bfloat16; the wgmma/TMA kernels at their edges
    (``EDGE_ATTN``, ``EDGE_MLP``), the cp_async decode sweep at its edges
    (``EDGE_DECODE``) and the tf32x3 scan at its (``EDGE_SSD``), each of
    which must run that kernel; ``ssd_scan`` at ``SSD_CASES`` too; one
    misaligned operand of each, which must run the older kernels."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.flash_decode import flash_decode_plain
    from repro_torch.kernels.fused_mlp import fused_rmsnorm_mlp_plain
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    K = llm_kernels()
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    cases, bad = [], []

    def run(name, kind, args, plain, extra=(), want=None):
        out = K[name](*args, *extra)
        sync()
        ref = plain(*args)
        dtype = args[0].dtype
        res = llm_check(kind, out, ref, dtype)
        case = {"kernel": name, "shape": list(args[0].shape),
                "dtype": str(dtype).split(".")[-1],
                "variant": getattr(K[name], "last_variant", None),
                "max_abs_err": res["max_abs_err"],
                "max_row_rel_err": res["max_row_rel_err"]}
        cases.append(case)
        if not res["ok"] or (want and case["variant"] != want):
            bad.append(case)

    for dtype in (torch.float32, torch.bfloat16):
        for (B, Sq, KV, G, hd, hdv, win) in (
                (2, 200, 2, 4, 80, 80, 64), (1, 130, 1, 8, 256, 256, 0),
                (2, 77, 4, 1, 32, 48, 0), (1, 333, 2, 2, 192, 128, 100),
                (1, 70, 2, 2, 20, 12, 0)):
            run("flash_attention", "attention",
                attention_case(gen, B, Sq, Sq, KV, G, hd, hdv, win, dtype),
                flash_attention_plain)
        # queries placed before every key: rows with no live key give 0
        qpos = torch.arange(-40, 60, dtype=torch.int32, device=DEV)[None]
        run("flash_attention", "attention",
            attention_case(gen, 1, 100, 100, 2, 2, 80, 80, 0, dtype,
                           qpos=qpos), flash_attention_plain)
        for (B, W, KV, G, hd, win, split, pos) in (
                (4, 4096, 8, 4, 80, 4096, 512, [5, 4095, 4096, 9000]),
                (3, 100, 1, 8, 256, 0, 32, [0, 50, 250]),
                (2, 64, 2, 1, 80, 16, 512, [10, 70])):
            run("flash_decode", "attention",
                decode_case(gen, B, W, KV, G, hd, hd, win, dtype, pos),
                flash_decode_plain, (split,))
        mlps = [(100, 96, 200, "gelu"), (17, 300, 64, "silu"),
                (12, 64, 130, "gelu"), (1, 64, 1000, "gelu"),
                (3, 100, 77, "silu")]
        if dtype == torch.bfloat16:     # float32 sums over d=2560 exceed 2e-5
            mlps.append((4, 2560, 6912, "silu"))
        for (N, d, F, act) in mlps:
            run("fused_mlp", "mlp", mlp_case(gen, N, d, F, act, dtype),
                fused_rmsnorm_mlp_plain)
    # the wgmma/TMA paths' edges; each must run the new kernel
    bf16 = torch.bfloat16
    for (B, Sq, Sk, KV, G, hd, win, (qkind, qfirst), kkind) in EDGE_ATTN:
        qp = edge_positions(gen, qkind, Sq, qfirst).expand(B, Sq).contiguous()
        kp = edge_positions(gen, kkind, Sk, 0).expand(B, Sk).contiguous()
        run("flash_attention", "attention",
            attention_case(gen, B, Sq, Sk, KV, G, hd, hd, win, bf16,
                           qpos=qp, kpos=kp),
            flash_attention_plain, want="wgmma_tma")
    for (N, d, F, act) in EDGE_MLP:
        run("fused_mlp", "mlp", mlp_case(gen, N, d, F, act, bf16),
            fused_rmsnorm_mlp_plain, want="wgmma_tma")
    # the gemv_tma decode kernel's edges, and the planted faults at the
    # dense configs' widths (each must be rejected); a misaligned x takes
    # the rows kernel
    for (N, d, F, act) in EDGE_MLP_ROWS:
        a = mlp_case(gen, N, d, F, act, bf16)
        run("fused_mlp", "mlp", a, fused_rmsnorm_mlp_plain, want="gemv_tma")
        if (d, F) in DENSE_WIDTHS:
            faults = mlp_faults_rejected(a, fused_rmsnorm_mlp_plain(*a))
            cases[-1]["faults_rejected"] = all(
                f["rejected"] for f in faults.values())
            if not cases[-1]["faults_rejected"]:
                cases[-1]["planted_faults"] = faults
                bad.append(cases[-1])
        del a
    a = mlp_case(gen, *MISALIGNED_MLP_ROWS[:3], MISALIGNED_MLP_ROWS[3], bf16)
    run("fused_mlp", "mlp", (misaligned(a[0]),) + a[1:],
        fused_rmsnorm_mlp_plain, want="rows")
    del a
    for (B, W, KV, G, hd, hdv, win, pos, blk, qd, ring) in EDGE_DECODE:
        a = edge_decode_case(gen, B, W, KV, G, hd, hdv, win, pos, qd, ring)
        run("flash_decode", "attention", a, flash_decode_plain, (blk,),
            want="cp_async")
        cases[-1]["split"] = K["flash_decode"].last_split
    # a cache that is no cp.async operand takes the PR 12 sweep
    a = edge_decode_case(gen, *MISALIGNED_DECODE[:8], "bf16", "ring")
    run("flash_decode", "attention",
        (a[0], misaligned(a[1]), misaligned(a[2])) + a[3:],
        flash_decode_plain, (MISALIGNED_DECODE[8],), want="cuda_cores")
    # the lse at a window-split cache's rank slices (danube, zamba2), the
    # planted faults its check must reject, and the halves merged by it
    for c in LSE_SLICES:
        a = decode_lse_case(*c, "bfloat16")
        out, lse = K["flash_decode"](*a, return_lse=True)
        sync()
        ref, ref_lse = flash_decode_plain(*a, return_lse=True)
        res = lse_check(out, lse, ref, ref_lse, bf16)
        rejected = {f: not lse_check(o, l, ref, ref_lse, bf16)["ok"]
                    for f, (o, l) in lse_faults(out, lse, ref_lse).items()}
        case = {"kernel": "flash_decode", "lse": True, "shape": list(
            a[0].shape), "cache": list(a[1].shape), "part": c[-1],
            "dtype": "bfloat16", "variant": K["flash_decode"].last_variant,
            "max_row_rel_err": row_rel_err(out, ref), **res,
            "faults_rejected": rejected}
        cases.append(case)
        if not res["ok"] or not all(rejected.values()) or \
                case["variant"] != "cp_async":
            bad.append(case)
        del a, out, lse, ref, ref_lse
    comb = lse_combine_check(gen)
    if not all(v["ok"] for v in comb.values()):
        bad.append({"kernel": "flash_decode", "lse_combine": comb})
    edge_ssd = ([c + (None, False) for c in SSD_CASES]
                + [c + ("tf32x3", False) for c in EDGE_SSD]
                + [MISALIGNED_SSD + ("cuda_cores", True)])
    for (B, L, nh, hd, st, chunk, kind, want, shift) in edge_ssd:
        args = ssd_case(gen, B, L, nh, hd, st, kind)
        if shift:       # xs is no cp.async operand: the PR 13 kernels
            args = (misaligned(args[0]),) + args[1:]
        y, h = ssd_scan(*args, chunk)
        sync()
        res = ssd_check(y, h, *ssd_scan_plain(*args, chunk))
        case = {"kernel": "ssd_scan", "shape": [B, L, nh, hd], "st": st,
                "chunk": chunk, "dt": kind, "dtype": "float32",
                "variant": ssd_scan.last_variant,
                "max_abs_err": res["max_abs_err"],
                "max_excess": res["max_excess"],
                "max_row_rel_err": res["max_row_rel_err"]}
        cases.append(case)
        if not res["ok"] or (want and case["variant"] != want):
            bad.append(case)
    names = sorted({c["kernel"] for c in cases})
    emit({"phase": "llm_kernels", "cases": len(cases), "failed": len(bad),
          "atol": {f"{k}/{str(t).split('.')[-1]}": v
                   for (k, t), v in LLM_ATOL.items()},
          "attention_row_rtol": {str(t).split('.')[-1]: v
                                 for t, v in LLM_ROW_RTOL.items()},
          "ssd_tol": SSD_TOL,
          "worst": {n: max(c["max_abs_err"] for c in cases
                           if c["kernel"] == n) for n in names},
          "worst_row_rel": {n: max(c["max_row_rel_err"] for c in cases
                                   if c["kernel"] == n) for n in names},
          "decode_lse": {"cases": sum(1 for c in cases if c.get("lse")),
                         "worst_lse_abs_err": max(
                             c["lse_max_abs_err"] for c in cases
                             if c.get("lse")), "lse_atol": LSE_ATOL,
                         "dead_rows": [c["dead_rows"] for c in cases
                                       if c.get("lse")],
                         "combine": comb},
          "first_failures": bad[:5]})
    if bad:
        raise SystemExit("an LLM kernel disagrees with its plain version")


def drive_serve(spec=SERVE, lm_kwargs=None, phase="serve",
                path=("flash_attention", "flash_decode", "fused_mlp")):
    """A serving path through its public entry points: ``ServeEngine`` on
    the card with the kernel backends (``lm_kwargs``; default: attention
    and MLP ``fused``); records the logits it computed.  Every kernel's
    count is set to 0 just before the requests and read just after; each
    kernel of ``path`` must have launched."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import AttnOptions
    from repro_torch.runtime.serve import Request, ServeEngine
    K = all_kernels()
    cfg = get_config(spec["arch"])
    if lm_kwargs is None:
        lm_kwargs = dict(opts=AttnOptions(backend="fused"))
    window = spec.get("window", 256)     # the ssm cache has no window
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, batch_slots=spec["slots"], window=window,
                      lm_kwargs=lm_kwargs, seed=SEED, device=DEV)
    sync()
    init_s = time.perf_counter() - t0
    lm = eng.lm

    # warm the path (first launches, cuBLAS handles) on a throwaway cache
    warm = torch.zeros((1, 64), dtype=torch.long, device=DEV)
    _, c = lm.prefill(eng.params, warm, cache_len=window)
    lm.decode_step(eng.params, c, warm[:, :1])
    del c
    sync()
    init_peak = torch.cuda.max_memory_allocated()     # weights' draw included
    held = torch.cuda.memory_allocated()              # weights + slot cache
    torch.cuda.reset_peak_memory_stats()

    # record what the engine computes: (rid, token index) -> logits row
    rng = np.random.default_rng(SEED)
    reqs = [Request(rid=i, max_new=spec["max_new"],
                    prompt=rng.integers(0, cfg.vocab_size, size=n
                                        ).astype(np.int32))
            for i, n in enumerate(spec["prompts"])]
    logits = {}
    prefill, decode_step = lm.prefill, lm.decode_step
    admission = iter([r.rid for r in reqs])     # the queue is FIFO

    started = {}                                # rid -> prefill's start

    def rec_prefill(params, tokens, cache_len=0):
        rid = next(admission)
        started[rid] = time.perf_counter()
        lg, cache = prefill(params, tokens, cache_len=cache_len)
        logits[(rid, 0)] = lg[0]
        return lg, cache

    def rec_decode(params, cache, tokens):
        rows = {s: (r.rid, len(r.out)) for s, r in eng.active.items()}
        lg, cache = decode_step(params, cache, tokens)
        for s, key in rows.items():
            logits[key] = lg[s]
        return lg, cache

    lm.prefill, lm.decode_step = rec_prefill, rec_decode
    for f in K.values():                        # counted from here ...
        f.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    for _ in range(10 * len(reqs) * spec["max_new"]):
        if len(eng.done) == len(reqs):
            break
        eng.step()
    sync()
    wall = time.perf_counter() - t0
    launches = {n: f.launches for n, f in K.items()}   # ... to here
    variants = {n: getattr(f, "last_variant", None) for n, f in K.items()
                if n in path}
    lm.prefill, lm.decode_step = prefill, decode_step
    if len(eng.done) != len(reqs):
        raise SystemExit(f"{phase}: {len(eng.done)}/{len(reqs)} requests "
                         f"done")
    if min(launches[n] for n in path) < 1:
        raise SystemExit(f"{phase}: a kernel was never launched: {launches}")

    tm = eng.timings
    n_decoded = sum(len(r.out) - 1 for r in reqs)
    report = {
        "phase": phase, "arch": cfg.name, "d_model": cfg.d_model,
        "n_layers": cfg.n_layers, "slots": spec["slots"],
        **({"window": spec["window"]} if "window" in spec else {}),
        "prompts": list(spec["prompts"]),
        "max_new": spec["max_new"], "init_s": init_s, "wall_s": wall,
        "ttft_s": [r.t_first - r.t_submit for r in reqs],
        "prefill_s": tm["prefill_s"],
        # each request's prefill, its start to its first token (the engine
        # reads the token, which waits for the card)
        "prefill_s_by_request": [r.t_first - started[r.rid] for r in reqs],
        "prefill_tokens_per_s": tm["prefill_tokens"] / tm["prefill_s"],
        "decode_s": tm["decode_s"], "decode_steps": tm["decode_steps"],
        "decode_tokens": n_decoded,
        "decode_tokens_per_s": n_decoded / tm["decode_s"],
        "decode_step_ms": 1e3 * tm["decode_s"] / tm["decode_steps"],
        "peak_mem_gb": max(init_peak, torch.cuda.max_memory_allocated())
        / 2**30,
        "held_mem_gb": held / 2**30,
        "serve_peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches, "last_variants": variants,
        "stats": eng.stats()}
    return report, dict(eng=eng, reqs=reqs, logits=logits, window=window)


def verify_serve_logits(report, ctx, plain_kwargs=None):
    """The kernel path against the plain path on the card, teacher forced:
    the plain LM (``plain_kwargs``; default: attention ``naive``) is fed the
    kernel path's tokens, so one near-tie cannot make the two runs
    diverge.  Each request is prefilled alone (B = 1) and written into its
    row of one batched cache, as the engine admits it; then all requests
    decode together, each row at its own position."""
    from repro_torch.models.layers import AttnOptions
    from repro_torch.models.transformer import LM
    from repro_torch.runtime.serve import write_slot
    eng, reqs, logits = ctx["eng"], ctx["reqs"], ctx["logits"]
    if plain_kwargs is None:
        plain_kwargs = dict(opts=AttnOptions(backend="naive"))
    plain = LM(eng.cfg, **plain_kwargs)
    worst, agree, n, finite = 0.0, 0, 0, True
    t0 = time.perf_counter()

    def held(r, i, lg):
        nonlocal worst, agree, n, finite
        got = logits[(r.rid, i)]
        finite &= bool(torch.isfinite(got).all())
        worst = max(worst, _err(got, lg) / float(lg.abs().max()))
        agree += int(torch.argmax(lg)) == r.out[i]
        n += 1

    cache = plain.init_cache(len(reqs), ctx["window"], device=DEV)
    for b, r in enumerate(reqs):
        prompt = torch.as_tensor(r.prompt[None, :], dtype=torch.long,
                                 device=DEV)
        lg, one = plain.prefill(eng.params, prompt, cache_len=ctx["window"])
        held(r, 0, lg[0])
        write_slot(cache, b, one)
        del one
    for i in range(1, max(len(r.out) for r in reqs)):
        tok = torch.tensor([[r.out[i - 1] if i < len(r.out) else 0]
                            for r in reqs], device=DEV)
        lg, cache = plain.decode_step(eng.params, cache, tok)
        for b, r in enumerate(reqs):
            if i < len(r.out):
                held(r, i, lg[b])
    del cache
    sync()
    report["teacher_forced"] = {
        "positions": n, "max_rel_logit_err": worst, "rel_tol": LOGIT_REL_TOL,
        "token_agreement": agree / n, "agree_min": AGREE_MIN,
        "finite": finite, "plain_path_s": time.perf_counter() - t0}
    if not finite or worst > LOGIT_REL_TOL or agree / n < AGREE_MIN:
        emit(report)
        raise SystemExit(f"{report['phase']}: the kernel path disagrees with "
                         f"the plain path")


def _bound(byts, ops, peak=H100_BF16_PER_S):
    """Least milliseconds for ``byts`` bytes and ``ops`` operations at the
    card's memory rate and ``peak`` operations/s, and which bounds."""
    t_bytes = byts / H100_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


def _nbytes(*ts):
    return float(sum(t.numel() * t.element_size() for t in ts))


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()``: ``reps`` calls captured in one
    CUDA graph and replayed, so no host time sits between the launches
    (CUDA events around the replay)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                        # warm, outside the graph
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    g.replay()
    end.record()
    sync()
    del g
    return start.elapsed_time(end) / reps


def time_llm_kernel(name, kind, args, plain, library=None, extra=()):
    """Kernel vs plain version on the same inputs: error (``llm_check``),
    the device kernel that ran (``variant``), and times.  ``ms`` is the
    kernel's device time and ``library_ms`` the library call's, both timed
    the same way (a CUDA graph of SERVE["reps"] calls, ``graph_ms``);
    ``library_call_ms`` is the library call run eagerly (CUDA events, mean
    of 2 after a warm call: host gaps between its launches included);
    ``call_ms`` one wrapper call as the path makes it, host work included
    (CUDA events, mean of SERVE["reps"] after a warm call); the plain
    version is timed as it runs, eagerly (mean of 2).  For attention the same check is
    also put to the planted faults, each of which it must reject
    (``faults_rejected``); decode drops the split the kernel itself used
    (``split``, from ``last_split``); a head dim past 64 adds
    ``head_tail_faults``."""
    f = llm_kernels()[name]
    out = f(*args, *extra)
    sync()
    variant = getattr(f, "last_variant", None)
    split = getattr(f, "last_split", None)
    ref = plain(*args)
    sync()
    res = {**llm_check(kind, out, ref, args[0].dtype), "variant": variant,
           **({"split": split} if split is not None else {}),
           "ms": graph_ms(lambda: f(*args, *extra), SERVE["reps"]),
           "call_ms": cuda_ms(lambda: f(*args, *extra), SERVE["reps"]),
           "plain_ms": cuda_ms(lambda: plain(*args), 2),
           "library_ms": None, "library_call_ms": None}
    if library is not None:
        library()
        res["library_ms"] = graph_ms(library, SERVE["reps"])
        res["library_call_ms"] = cuda_ms(library, 2)
    del out
    if kind == "attention":
        faults = {}
        at = {"split": split} if split is not None else {}
        planted = planted_faults(name, args, plain, ref, **at)
        if args[0].shape[-1] > 64:
            planted.update(head_tail_faults(args, plain, ref))
        for fault, bad in planted.items():
            c = llm_check(kind, bad, ref, args[0].dtype)
            faults[fault] = {"max_abs_err": c["max_abs_err"],
                             "max_row_rel_err": c["max_row_rel_err"],
                             "rejected": not c["ok"]}
            del bad
        res["planted_faults"] = faults
        res["faults_rejected"] = all(v["rejected"] for v in faults.values())
    del ref
    return res


def time_serve_mlp(cfg, eng, spec, gen, hybrid, W, KV, G, hd, win, S,
                   slots, bp=None):
    """``fused_rmsnorm_mlp`` at a serving path's shapes (time_serve_kernels'
    MLP row, its inputs drawn from ``gen`` after the attention rows'): the
    longest prefill (N = 4,608) and the 4-slot decode, with layer 0's
    weights (hybrid: the shared tile's; ``bp``: that block's, the MLA
    path's dense prelude)."""
    from repro_torch.kernels.fused_mlp import _launch as fm_launch
    from repro_torch.kernels.fused_mlp import fused_rmsnorm_mlp_plain
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.transformer import _layer
    bf16 = torch.bfloat16
    replay_ulp = bp is None and not hybrid
    if bp is None:
        bp = (eng.params["shared_attn"] if hybrid
              else _layer(eng.params["blocks"], 0))
    norm, wg, wu = bp["mlp_norm"], bp["mlp"]["wi_gate"], bp["mlp"]["wi_up"]
    d, Ff = wg.shape
    x_ulp = None
    if replay_ulp:
        # An earlier version of this phase drew the one-slot decode case
        # from this generator just before the MLP's inputs; its prefill x
        # then read one bf16 ulp (2^-4, at 8-16) off the plain version and
        # failed the constant 5e-2 limit.  Those inputs, drawn again, must
        # pass the ulp-aware limit.
        g_ulp = torch.Generator(device=DEV)
        g_ulp.set_state(gen.get_state())
        decode_case(g_ulp, 1, W, KV, G, hd, hd, win, bf16, [2 * W - 1])
        x_ulp = _randn(g_ulp, (S, d), bf16)
    per = {}
    for label, N in (("prefill", S), ("decode", slots)):
        x = _randn(gen, (N, d), bf16)
        m_args = (x, norm, wg, wu, cfg.act, cfg.norm_eps)
        rr = time_llm_kernel("fused_mlp", "mlp", m_args,
                             fused_rmsnorm_mlp_plain)
        # yardstick only (the port never calls it): cuBLAS on the same
        # products, normalised x against [Wg | Wu], graph-timed
        xn = rms_norm(x, norm, cfg.norm_eps)
        wgu = torch.cat([wg, wu], dim=1)
        rr["matmul_ms"] = graph_ms(lambda: torch.matmul(xn, wgu),
                                   spec["reps"])
        del xn, wgu
        if label == "decode":       # the rows kernel, same inputs
            rr["old_variant_ms"] = graph_ms(
                lambda: fm_launch(*m_args, variant="rows"), spec["reps"])
        rr["planted_faults"] = mlp_faults_rejected(
            m_args, fused_rmsnorm_mlp_plain(*m_args))
        rr["faults_rejected"] = all(f["rejected"]
                                    for f in rr["planted_faults"].values())
        ops = 4.0 * N * d * Ff
        rr.update(zip(("bound_ms", "bound_by"),
                      _bound(_nbytes(x, norm, wg, wu) + 2.0 * N * Ff, ops)))
        rr.update(shape=f"x ({N},{d}), W ({d},{Ff}) bf16, {cfg.act}",
                  operations=ops)
        per[label] = rr
    if x_ulp is not None:
        a_ulp = (x_ulp, norm, wg, wu, cfg.act, cfg.norm_eps)
        out_ulp = llm_kernels()["fused_mlp"](*a_ulp)
        per["prefill"]["one_ulp_inputs"] = {
            **llm_check("mlp", out_ulp, fused_rmsnorm_mlp_plain(*a_ulp),
                        bf16),
            "variant": llm_kernels()["fused_mlp"].last_variant}
        del x_ulp, a_ulp, out_ulp
    return {**per["prefill"], "also": per["decode"]}


def time_serve_kernels(ctx, spec=SERVE, phase="serve_kernels",
                       kernels=("flash_attention", "flash_decode",
                                "fused_mlp")):
    """Each LLM kernel of ``kernels`` at a serving path's shapes (``spec``:
    the dense path's by default; the hybrid path's shared tile with
    SERVE_HYBRID; the moe path's attention, which has no dense MLP, with
    SERVE_MOE):
    against its plain version, timed beside its bound and, for attention,
    SDPA; the older kernel of each on the same inputs (``old_variant_ms``).
    Each row must have run the kernel SERVE_VARIANT names (at the hybrid
    path's head dim 112 too)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import _launch as fa_launch
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.flash_decode import flash_decode_plain
    from repro_torch.models.layers import AttnOptions, _window_mask, ring_kpos
    eng = ctx["eng"]
    cfg = eng.cfg
    KV, G, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    win, S, slots = cfg.sliding_window, max(spec["prompts"]), spec["slots"]
    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)
    bf16 = torch.bfloat16
    rows = {}
    # the hybrid path's attention is its shared tile (site 0's history)
    hybrid = "shared_attn" in eng.cache

    # flash_attention: the longest prefill (dense: S = 4,608 over a 4,096
    # window; hybrid: 4,608, causal)
    a = attention_case(gen, 1, S, S, KV, G, hd, hd, win, bf16)
    q, k, v, qp, kp, _, scale = a
    mask = _window_mask(qp[0], kp[0], win)
    qt = q.reshape(1, S, KV * G, hd).transpose(1, 2).contiguous()
    kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
    # SDPA with the mask, or causal (its flash kernel) where no window
    sdpa = dict(attn_mask=mask) if win else dict(is_causal=True)
    r = time_llm_kernel(
        "flash_attention", "attention", a, flash_attention_plain,
        lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale,
                                               enable_gqa=True, **sdpa))
    # the PR 12 WMMA kernel on the same inputs, graph-timed
    r["old_variant_ms"] = graph_ms(lambda: fa_launch(*a, variant="wmma"),
                                   spec["reps"])
    pairs = float(mask.sum())
    ops = 2.0 * pairs * KV * G * (hd + hd)
    # bytes: q, k, v, the positions, and the output (q's shape and type)
    r.update(zip(("bound_ms", "bound_by"),
                 _bound(_nbytes(q, k, v, q, qp, kp), ops)))
    r.update(shape=f"q (1,{S},{KV},{G},{hd}) bf16, "
             + (f"window {win}" if win else "causal"),
             live_pairs_per_head=pairs, operations=ops)
    rows["flash_attention"] = r
    del a, q, k, v, qt, kt, vt, mask

    # flash_decode: the slots over the engine's final ring cache, layer 0
    # (hybrid: the shared tile's first site)
    from repro_torch.kernels.flash_decode import _launch as fd_launch
    ck, cv = (c[0] for c in eng.cache["shared_attn" if hybrid else "blocks"])
    pos = (eng.cache["pos"] - 1).to(torch.int32)
    kpos = ring_kpos(pos, ck.shape[1])
    qd = _randn(gen, (slots, KV, G, hd), bf16)
    d_args = (qd, ck, cv, pos, kpos, win, 1.0 / float(np.sqrt(hd)))
    live = _window_mask(pos[:, None], kpos, win)[:, 0]           # (B, W)
    qt = qd.reshape(slots, KV * G, 1, hd)
    kt, vt = (c.transpose(1, 2).contiguous() for c in (ck, cv))
    kv_block = AttnOptions().kv_block                 # what the path passes
    r = time_llm_kernel(
        "flash_decode", "attention", d_args, flash_decode_plain,
        lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=live[:, None, None, :], scale=d_args[-1],
            enable_gqa=True), extra=(kv_block,))
    # the cuda_cores sweep on the same inputs (split = kv_block), graph-timed
    r["old_variant_ms"] = graph_ms(
        lambda: fd_launch(*d_args, kv_block, kv_block, "cuda_cores"),
        spec["reps"])
    # decode_split at one slot, where its grid would cover under one block
    # per SM at split = kv_block and it takes a shorter split: its choice
    # (checked against the plain version) timed against kv_block; drawn
    # from a generator of its own, so the other rows keep their inputs
    W = ck.shape[1]
    sb = decode_case(torch.Generator(device=DEV).manual_seed(SEED + 4), 1,
                     W, KV, G, hd, hd, win, bf16, [2 * W - 1])
    fd = llm_kernels()["flash_decode"]
    sb_out = fd(*sb, kv_block)
    r["small_batch_split"] = {
        "shape": f"q (1,{KV},{G},{hd}), cache (1,{W},{KV},{hd}) bf16",
        "variant": fd.last_variant, "split": fd.last_split,
        **llm_check("attention", sb_out, flash_decode_plain(*sb), bf16),
        "ms": graph_ms(lambda: fd(*sb, kv_block), spec["reps"]),
        "kv_block_ms": graph_ms(
            lambda: fd_launch(*sb, kv_block, kv_block, "cp_async"),
            spec["reps"])}
    del sb, sb_out
    n_live = float(live.sum())
    byts = n_live * KV * 2 * hd * ck.element_size() + _nbytes(
        qd, qd, pos, kpos)
    ops = 2.0 * n_live * KV * G * (hd + hd)
    r.update(zip(("bound_ms", "bound_by"), _bound(byts, ops)))
    r.update(shape=f"q ({slots},{KV},{G},{hd}), cache "
             f"({slots},{ck.shape[1]},{KV},{hd}) bf16",
             live_slots=n_live, operations=ops)
    rows["flash_decode"] = r
    del kt, vt
    if "fused_mlp" in kernels:     # the moe path has no dense MLP
        rows["fused_mlp"] = time_serve_mlp(cfg, eng, spec, gen, hybrid, W, KV,
                                           G, hd, win, S, slots)
    bad = [n for n, r in rows.items()
           if not r["ok"] or ("also" in r and not r["also"]["ok"])
           or not r.get("small_batch_split", {}).get("ok", True)
           or not r.get("one_ulp_inputs", {}).get("ok", True)]
    blind = [n for n, r in rows.items()
             if not r.get("faults_rejected", True)
             or not r.get("also", {}).get("faults_rejected", True)]
    old = [n for n, want in SERVE_VARIANT.items()
           if n.partition(".")[0] in rows
           and serve_row(rows, n)["variant"] != want]
    emit({"phase": phase, **rows})
    if bad:
        raise SystemExit(f"kernels disagree with their plain versions at the "
                         f"serving path's shapes: {bad}")
    if blind:
        raise SystemExit(f"the check passed a planted fault of {blind}")
    if old:
        raise SystemExit(f"the serving shape did not run the Hopper kernel "
                         f"of {old}")
    return rows


def _is_grouped_gemm(name: str) -> bool:
    """A kernel of ``torch._grouped_mm`` (CUTLASS's grouped GEMM)."""
    return "GroupProblemShape" in name or "grouped" in name.lower()


def _kernel_group(name: str) -> str:
    for k in ("fused_mlp", "flash_attention", "flash_decode"):
        if k in name:
            return k
    if _is_grouped_gemm(name):          # the MoE's expert products
        return "torch._grouped_mm (MoE experts)"
    if "fd2_combine" in name:           # flash_decode's cp_async combine
        return "flash_decode"
    if name.startswith("ssd_"):         # the kernels of csrc/ssd_scan.cu
        return "ssd_scan"
    if name.startswith("nvjet") or "gemm" in name.lower():
        return "torch.matmul (cuBLAS)"
    return "other torch ops"


def moe_ms_by_group(prof) -> dict:
    """Device ms of the kernels launched inside the ``moe`` ranges of a
    profile (``moe_apply`` under ``record_function("moe")``), by group: the
    grouped expert products and every other pass of the MoE (routing, sort,
    gathers, activation, gates, combine)."""
    out = {"moe: grouped products": 0.0, "moe: other passes": 0.0}
    for e in prof.events():
        if not getattr(e, "kernels", None):
            continue
        p = e
        while p is not None and p.name != "moe":
            p = p.cpu_parent
        if p is None:
            continue
        for k in e.kernels:
            g = ("moe: grouped products" if _is_grouped_gemm(k.name)
                 else "moe: other passes")
            out[g] += k.duration / 1e3
    return out


def profile_serve(ctx, phase="serve_profile"):
    """Where the time of one serving step goes: a decode step at all slots
    (on the engine's final cache) and a prefill of the longest prompt,
    each under ``torch.profiler``: host wall time, device time by kernel
    group, the kernels launched (``device_kernels``) and the device's idle
    share (1 - device time / wall time).  On a moe path each ``moe_apply``
    runs inside ``record_function("moe")``, and ``moe_ms_by_group`` splits
    the device time of its kernels into the grouped products and the
    other passes."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import moe as MoE
    eng, reqs = ctx["eng"], ctx["reqs"]
    lm = eng.lm
    longest = max(reqs, key=lambda r: len(r.prompt))
    prompt = torch.as_tensor(longest.prompt[None, :], dtype=torch.long,
                             device=DEV)
    steps = {
        "decode_step": lambda: lm.decode_step(eng.params, eng.cache,
                                              eng.tokens),
        "prefill_%d" % prompt.shape[1]: lambda: lm.prefill(
            eng.params, prompt, cache_len=ctx["window"])}
    moe = eng.cfg.family == "moe"
    apply = MoE.moe_apply

    def ranged(*a, **kw):
        with record_function("moe"):
            return apply(*a, **kw)

    out = {}
    for label, fn in steps.items():
        fn()
        sync()
        MoE.moe_apply = ranged if moe else apply
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                sync()
                wall = time.perf_counter() - t0
        finally:
            MoE.moe_apply = apply
        groups, kernels, top = {}, 0, []
        for e in prof.key_averages():
            dev = getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0))
            # a device kernel; the "moe" range's own device-side span
            # would count its kernels twice
            if e.self_cpu_time_total == 0 and dev > 0 and e.key != "moe":
                g = _kernel_group(e.key)
                groups[g] = groups.get(g, 0.0) + dev / 1e3
                kernels += e.count
                top.append((dev / 1e3, e.count, e.key[:100]))
        device_ms = sum(groups.values())
        out[label] = {"wall_ms": wall * 1e3, "device_ms": device_ms,
                      "device_kernels": kernels,
                      "idle_share": 1.0 - device_ms / (wall * 1e3),
                      "device_ms_by_group": dict(sorted(
                          groups.items(), key=lambda kv: -kv[1])),
                      "top_kernels": [list(t) for t in sorted(top)[::-1][:6]]}
        if moe:
            out[label]["moe_ms_by_group"] = moe_ms_by_group(prof)
    emit({"phase": phase, **out})
    if any(v["device_ms"] <= 0 for v in out.values()):
        raise SystemExit(f"{phase}: the profiler saw no device time")
    return out


def phase_serve():
    report, ctx = drive_serve()
    verify_serve_logits(report, ctx)
    emit(report)
    profile_serve(ctx)
    rows = time_serve_kernels(ctx)
    return report, rows


def ssd_bound(B, L, nh, hd, st, Q):
    """Least time of one ssd_scan call: operations over the float32 peak
    (67 TFLOP/s) or bytes over 3.35 TB/s.  Operations count the live
    (i >= j) pairs of each chunk only: C B^T once per (batch, chunk), 2 st
    each (shared by the heads); per head the pair's decay, dt and product
    (3) and its att @ x (2 hd); C @ h_in and the state update, 2 st hd per
    token and head each.  Bytes: each input read once, y and h written
    once."""
    nc = L // Q
    pairs = Q * (Q + 1) / 2.0
    ops = (2.0 * B * nc * pairs * st + B * nh * nc * pairs * (3.0 + 2.0 * hd)
           + 2.0 * 2.0 * B * L * nh * st * hd)
    byts = 4.0 * (2 * B * L * nh * hd + B * L * nh + 2 * nh + 2 * B * L * st
                  + B * nh * st * hd)
    return ops, byts, _bound(byts, ops, H100_FP32_PER_S)


H100_TF32_PER_S = 494e12        # TF32 tensor cores, dense, published


def ssd_bound_tc(B, L, nh, hd, st, Q):
    """The same work with the products on tensor cores in 3xTF32: the
    product operations of ``ssd_bound`` (C B^T, att @ x, C @ h_in, the
    state update) three times over at 494 TFLOP/s, plus the rest (the
    pair's decay, dt and product: 3 per pair and head) at 67 TFLOP/s,
    against the same bytes; returns (ms, "bytes" | "operations")."""
    nc = L // Q
    pairs = Q * (Q + 1) / 2.0
    prod = (2.0 * B * nc * pairs * st + B * nh * nc * pairs * 2.0 * hd
            + 2.0 * 2.0 * B * L * nh * st * hd)
    rest = 3.0 * B * nh * nc * pairs
    t_ops = (3.0 * prod / H100_TF32_PER_S + rest / H100_FP32_PER_S) * 1e3
    _, byts, _ = ssd_bound(B, L, nh, hd, st, Q)
    t_bytes = byts / H100_BYTES_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


def ssd_ms_by_kernel(fn, reps=5):
    """Device milliseconds per call of each kernel ``fn()`` launches
    (``torch.profiler``, mean over ``reps`` calls after a warm one)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    per = {}
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0.0))
        if dev > 0 and e.key.startswith("ssd_"):
            k = e.key.split("(")[0]
            per[k] = per.get(k, 0.0) + dev / reps / 1e3
    return per


def time_ssm_kernels(spec=SERVE_SSM, phase="serve_ssm_kernels"):
    """``ssd_scan`` at a serving path's shapes (``spec``: by default the
    16,384-token and the 100-token prefill of mamba2-370m, nh 32, hd 64,
    st 128, chunk 256; SERVE_HYBRID: zamba2-7b's 4,608 and 100 tokens, nh
    112, hd 64, st 64) against its plain version, on inputs drawn in
    Mamba-2's initialisation ranges (``ssd_case`` "mamba"): per element and
    per (batch, head) within SSD_TOL; the kernel's device time (CUDA graph
    of ``spec["reps"]`` calls), one call as the path makes it, the plain version's time, the
    bound with the products on tensor cores in 3xTF32 (``bound_tc_ms``) and
    at the float32 CUDA-core rate (``bound_f32_ms``), ``bound_ms`` the
    lesser of the two; the device time of each kernel of a
    call (``ms_by_kernel``) and the ``cuda_cores`` kernels on the same inputs
    (``old_variant_ms``, ``old_ms_by_kernel``); and the same check put to
    planted faults, each of which it must reject."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import _launch as ssd_launch
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    cfg = get_config(spec["arch"])
    nh, hd, st, chunk = (cfg.n_ssm_heads, cfg.ssm_headdim, cfg.ssm_state,
                         cfg.ssm_chunk)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 3)
    reps = spec["reps"]
    rows = {}
    for L in (max(spec["prompts"]), 100):
        args = ssd_case(gen, 1, L, nh, hd, st, "mamba")
        y, h = ssd_scan(*args, chunk)
        sync()
        ref = ssd_scan_plain(*args, chunk)
        sync()
        res = ssd_check(y, h, *ref)
        del y, h
        variant = ssd_scan.last_variant
        res.update(variant=variant,
                   ms=graph_ms(lambda: ssd_scan(*args, chunk), reps),
                   call_ms=cuda_ms(lambda: ssd_scan(*args, chunk), reps),
                   plain_ms=cuda_ms(lambda: ssd_scan_plain(*args, chunk), 2),
                   library_ms=None,
                   # the cuda_cores kernels on the same inputs, graph-timed
                   old_variant_ms=graph_ms(
                       lambda: ssd_launch(*args, chunk, "cuda_cores"), reps),
                   ms_by_kernel=ssd_ms_by_kernel(
                       lambda: ssd_scan(*args, chunk)),
                   old_ms_by_kernel=ssd_ms_by_kernel(
                       lambda: ssd_launch(*args, chunk, "cuda_cores")))
        Q = min(chunk, L)
        ops, byts, f32_bound = ssd_bound(1, L, nh, hd, st, Q)
        tc_bound = ssd_bound_tc(1, L, nh, hd, st, Q)
        # the row's bound is the lesser: the card can do the work that fast
        bound_ms, bound_by = min(f32_bound, tc_bound)
        res.update(bound_ms=bound_ms, bound_by=bound_by,
                   bound_f32_ms=f32_bound[0], bound_tc_ms=tc_bound[0],
                   operations=ops, bytes=byts,
                   shape=f"xs (1,{L},{nh},{hd}), st {st}, Q {Q}, f32",
                   kernels_per_call=len(res["ms_by_kernel"]))
        faults = {}
        for fault, (fy, fh) in ssd_planted_faults(args, chunk, ref).items():
            c = ssd_check(fy, fh, *ref)
            faults[fault] = {"max_abs_err": c["max_abs_err"],
                             "max_excess": c["max_excess"],
                             "max_row_rel_err": c["max_row_rel_err"],
                             "rejected": not c["ok"]}
            del fy, fh
        res["planted_faults"] = faults
        res["faults_rejected"] = all(v["rejected"] for v in faults.values())
        rows[L] = res
        del args, ref
    row = {**rows[max(rows)], "also": rows[100]}
    emit({"phase": phase, "ssd_scan": row})
    if not (row["ok"] and row["also"]["ok"]):
        raise SystemExit(f"ssd_scan disagrees with its plain version at the "
                         f"{spec['arch']} serving path's shapes")
    if SSD_VARIANT != row["variant"] or SSD_VARIANT != row["also"]["variant"]:
        raise SystemExit(f"the {spec['arch']} serving shapes did not run "
                         f"the {SSD_VARIANT} kernels")
    if not (row["faults_rejected"] and row["also"]["faults_rejected"]):
        raise SystemExit("the ssd_scan check passed a planted fault")
    return row


def phase_serve_ssm():
    """The Mamba-2 serving path (``ssm_backend="fused"``), its teacher-
    forced check against the plain path, its profile, and ``ssd_scan`` at
    its shapes.  One ``ssd_scan`` launch is one call (its four kernels);
    every prefill makes one per layer."""
    from repro_torch.configs import get_config
    cfg = get_config(SERVE_SSM["arch"])
    report, ctx = drive_serve(SERVE_SSM, dict(ssm_backend="fused"),
                              "serve_ssm", ("ssd_scan",))
    need = cfg.n_layers * len(SERVE_SSM["prompts"])
    report.update(d_inner=cfg.d_inner, ssm_heads=cfg.n_ssm_heads,
                  ssm_headdim=cfg.ssm_headdim, ssm_state=cfg.ssm_state,
                  ssm_chunk=cfg.ssm_chunk, ssd_scan_launches_min=need)
    if report["launches"]["ssd_scan"] < need:
        emit(report)
        raise SystemExit(f"serve_ssm: ssd_scan launched "
                         f"{report['launches']['ssd_scan']} times, fewer "
                         f"than {need} (layers x prefills)")
    verify_serve_logits(report, ctx, dict(ssm_backend="torch"))
    emit(report)
    profile_serve(ctx, "serve_ssm_profile")
    del ctx
    torch.cuda.empty_cache()
    row = time_ssm_kernels()
    return report, row


def phase_serving():
    """The five serving paths in turn (dense, SSM, hybrid, moe, MLA): each
    one's report and kernel rows."""
    return (phase_serve() + phase_serve_ssm() + phase_serve_hybrid()
            + phase_serve_moe() + phase_serve_mla())


def phase_serve_hybrid():
    """The hybrid serving path (zamba2-7b at full width and depth: 81
    Mamba-2 blocks, the shared attention + MLP tile at 14 sites) through
    all four LLM kernels, each of which must launch: ``ssd_scan`` once per
    block and prefill, ``flash_attention`` once per site and prefill,
    ``flash_decode`` once per site and decode step, ``fused_rmsnorm_mlp``
    once per site and prefill or step.  Its teacher-forced check against
    the plain path (attention ``naive``, ``ssm_backend="torch"``), its
    profile, and the four kernels at its shapes."""
    from repro_torch.models.layers import AttnOptions
    spec = SERVE_HYBRID
    report, ctx = drive_serve(
        spec, dict(opts=AttnOptions(backend="fused"), ssm_backend="fused"),
        "serve_hybrid",
        ("flash_attention", "flash_decode", "fused_mlp", "ssd_scan"))
    lm = ctx["eng"].lm
    cfg, n_apps = lm.cfg, lm.n_apps
    prefills, steps = len(spec["prompts"]), report["decode_steps"]
    need = {"ssd_scan": cfg.n_layers * prefills,
            "flash_attention": n_apps * prefills,
            "flash_decode": n_apps * steps,
            "fused_mlp": n_apps * (prefills + steps)}
    report.update(d_inner=cfg.d_inner, ssm_heads=cfg.n_ssm_heads,
                  ssm_state=cfg.ssm_state, head_dim=cfg.head_dim,
                  shared_attn_every=cfg.shared_attn_every, sites=n_apps,
                  launches_min=need)
    short = [n for n, k in need.items() if report["launches"][n] < k]
    if short:
        emit(report)
        raise SystemExit(f"serve_hybrid: fewer launches than sites x "
                         f"prefills / steps (or blocks x prefills): {short}")
    verify_serve_logits(report, ctx, dict(opts=AttnOptions(backend="naive"),
                                          ssm_backend="torch"))
    emit(report)
    profile_serve(ctx, "serve_hybrid_profile")
    rows = time_serve_kernels(ctx, spec, "serve_hybrid_kernels")
    del ctx
    torch.cuda.empty_cache()
    rows["ssd_scan"] = time_ssm_kernels(spec, "serve_hybrid_ssd_kernels")
    return report, rows


def sync_sites(sc, per=1):
    """Where the syncs a ``SyncCount(stacks=True)`` block counted were
    raised (``file:line`` -> count over ``per`` calls) and, for a site
    outside the repo, the last repo frames it came through."""
    sites, via = {}, {}
    for r, stack in zip(sc.records, sc.stacks):
        if "synchroniz" in str(r.message):
            at = f"{os.path.relpath(r.filename, ROOT)}:{r.lineno}"
            sites[at] = sites.get(at, 0) + 1 / per
            if at.startswith("..") and stack:  # raised outside: by what
                via[at] = [f"{os.path.relpath(f.filename, ROOT)}:"
                           f"{f.lineno} {f.name}" for f in stack
                           if f.filename.startswith(ROOT)][-4:]
    return sites, via


# the innermost src/repro_torch frame of every sync a SyncCount(stacks=True)
# block recorded in this run, for phase "analysis" (package_frames)
OBSERVED_SYNCS = []
PKG_ROOT = os.path.join(ROOT, "src", "repro_torch") + os.sep


def package_frames(sc, source):
    """The innermost frame inside ``src/repro_torch`` of each sync a
    ``SyncCount(stacks=True)`` block counted: ``{"source", "path" (relative
    to the checkout, None when no frame of the package was on the stack),
    "line", "function", "raised_at"}``.  A lambda's or a generator
    expression's frame stands for the call that ran it (the linter indexes
    functions, not expressions), so the frame taken is the innermost one
    of a ``def``."""
    out = []
    for r, stack in zip(sc.records, sc.stacks):
        if "synchroniz" not in str(r.message):
            continue
        frame = next((f for f in reversed(stack or [])
                      if os.path.abspath(f.filename).startswith(PKG_ROOT)
                      and not f.name.startswith("<")), None)
        out.append({
            "source": source,
            "path": (os.path.relpath(frame.filename, ROOT).replace(
                os.sep, "/") if frame is not None else None),
            "line": frame.lineno if frame is not None else None,
            "function": frame.name if frame is not None else None,
            "raised_at": f"{os.path.relpath(r.filename, ROOT)}:{r.lineno}"})
    return out


def decode_syncs(ctx, plain_kwargs, steps=4):
    """Operations that wait for the card (torch's sync debug mode "warn", as
    ``SyncCount`` counts them) per decode step of the engine with every
    slot busy: over the whole ``ServeEngine.step`` (the token read
    included) and inside ``LM.decode_step`` alone; then the same with the
    engine's LM swapped for the plain one (``plain_kwargs``).  Fresh
    8-token requests fill the slots first (their prefills are not
    counted)."""
    from repro_torch.models.transformer import LM
    from repro_torch.runtime.serve import Request
    eng = ctx["eng"]
    rng = np.random.default_rng(SEED + 5)
    out = {"steps": steps}
    lms = {"kernel_path": eng.lm, "plain_path": LM(eng.cfg, **plain_kwargs)}
    for label, lm in lms.items():
        for i in range(eng.slots):
            eng.submit(Request(rid=10_000 + i, max_new=steps + 2,
                               prompt=rng.integers(0, eng.cfg.vocab_size,
                                                   size=8).astype(np.int32)))
        eng.lm = lm
        eng.step()                       # admits every slot, decodes once
        sync()
        decode_step, inner = lm.decode_step, [0]
        try:
            with SyncCount(stacks=True) as sc:
                def counted(*a, **kw):
                    n0 = len(sc.records)
                    res = decode_step(*a, **kw)
                    inner[0] += sc._syncs(sc.records[n0:])
                    return res
                lm.decode_step = counted
                for _ in range(steps):
                    eng.step()
        finally:
            lm.decode_step = decode_step
        eng.run(4)                       # the requests finish
        sites, via = sync_sites(sc, steps)
        OBSERVED_SYNCS.extend(package_frames(
            sc, f"decode_syncs:{eng.cfg.name}:{label}"))
        out[label] = {"per_step": sc.total / steps,
                      "in_decode_step": inner[0] / steps,
                      "sites_per_step": sites,
                      **({"outside_repo_via": via} if via else {})}
    eng.lm = lms["kernel_path"]
    return out


def grouped_check(out, ref):
    """``grouped_matmul`` (bf16) against its plain loop: per element as the
    bf16 MLP rows (max(5e-2, one bf16 ulp of |ref|), ``llm_check``) and the
    largest error over the largest |ref| within LLM_ROW_RTOL's bf16 2e-2
    (a product of small weights has outputs far below 5e-2)."""
    res = llm_check("mlp", out, ref, torch.bfloat16)
    top = float(ref.float().abs().max()) if ref.numel() else 0.0
    res["rel_err"] = res["max_abs_err"] / top if top > 0 else \
        res["max_abs_err"]
    res["rel_tol"] = LLM_ROW_RTOL[torch.bfloat16]
    res["ok"] = res["ok"] and res["rel_err"] <= res["rel_tol"]
    return res


def grouped_planted_faults(xs, w, offsets, ref):
    """What a faulty grouped product would return on (xs, w, offsets):
    the weights of the two largest groups' experts swapped, and the end of
    the first group followed by a non-empty one shifted one row up (that
    row taken by the wrong expert).  ``grouped_check`` must reject each."""
    from repro_torch.models.moe import grouped_matmul
    sizes = torch.diff(offsets, prepend=offsets.new_zeros(1)).tolist()
    out = {}
    a, b = sorted(range(len(sizes)), key=lambda e: -sizes[e])[:2]
    if sizes[b] > 0:
        swapped = w.clone()
        swapped[[a, b]] = w[[b, a]]
        out["experts_swapped"] = grouped_matmul(xs, swapped, offsets)
    j = next((e for e in range(len(sizes) - 1) if sizes[e + 1] > 0), None)
    if j is not None:
        shifted = offsets.clone()
        shifted[j] += 1
        out["offset_shifted"] = grouped_matmul(xs, w, shifted)
    return {name: {**{k: c[k] for k in ("max_abs_err", "rel_err")},
                   "rejected": not c["ok"]}
            for name, c in ((n, grouped_check(bad, ref))
                            for n, bad in out.items())}


def time_moe_experts(ctx, spec=SERVE_MOE, phase="serve_moe_experts"):
    """``grouped_matmul`` at the moe path's shapes, with layer 0's experts
    and router: the longest prefill (4,608 tokens, 36,864 rows), the
    4-slot decode (32 rows) and one token (8 rows, 24 of 32 groups empty),
    the rows routed and sorted as the path does.  Each of the three
    products against the plain loop (``grouped_check``), which must reject
    ``grouped_planted_faults``; the three products together (gate, up,
    down and the activation: ``expert_ffn``) graph-timed (``ms``), eagerly
    (``call_ms``) and through the per-expert loop as the plain path runs it
    (``loop_ms``: the offsets read once, eager), beside the bound (the
    gathered rows read, the weights of the experts with rows read, the
    output rows written; 2 rows d f 3 operations at the bf16 peak).  Also
    ``top_k`` on the card against the CPU on the same logits, all-tied and
    integer-tied rows included: the ids must be equal."""
    from repro_torch.models import moe as MoE
    from repro_torch.models.layers import _act
    from repro_torch.models.transformer import _layer
    eng = ctx["eng"]
    cfg = eng.cfg
    E, k, d, f = cfg.n_experts, cfg.top_k, cfg.d_model, cfg.d_ff_expert
    p = _layer(eng.params["blocks"], 0)["moe"]
    gen = torch.Generator(device=DEV).manual_seed(SEED + 6)
    bf16 = torch.bfloat16
    rows, bad, blind = {}, [], []
    for label, n in (("prefill", max(spec["prompts"])),
                     ("decode", spec["slots"]), ("one_token", 1)):
        x = _randn(gen, (n, d), bf16)
        _, ids, _ = MoE._route(p["router"], x, k)
        flat = ids.reshape(-1)
        xs = x[torch.argsort(flat, stable=True) // k]
        offs = MoE.group_offsets(flat, E)
        gate = MoE.grouped_matmul_plain(xs, p["wi_gate"], offs)
        h = _act(gate, cfg.act) * MoE.grouped_matmul_plain(xs, p["wi_up"],
                                                           offs)
        products = {}
        for name, (a, w) in (("wi_gate", (xs, p["wi_gate"])),
                             ("wi_up", (xs, p["wi_up"])), ("wo", (h, p["wo"]))):
            got = MoE.grouped_matmul(a, w, offs)
            sync()
            c = grouped_check(got, MoE.grouped_matmul_plain(a, w, offs))
            products[name] = {**c, "variant": MoE.grouped_matmul.last_variant}
            if not c["ok"] or products[name]["variant"] != "grouped_mm":
                bad.append(f"{label}.{name}")
        faults = grouped_planted_faults(xs, p["wi_gate"], offs, gate)
        if not all(v["rejected"] for v in faults.values()):
            blind.append(label)
        sizes = torch.diff(offs, prepend=offs.new_zeros(1))
        used = int((sizes > 0).sum())
        n_rows = int(flat.numel())
        byts = 2.0 * (2 * n_rows * d + used * 3 * d * f) + 4.0 * E
        ops = 2.0 * n_rows * d * f * 3
        ffn = (lambda: MoE.expert_ffn(xs, p, offs, cfg.act))
        rows[label] = {
            "rows": n_rows, "groups_used": used, "products": products,
            "planted_faults": faults,
            "faults_rejected": all(v["rejected"] for v in faults.values()),
            "ms": graph_ms(ffn, spec["reps"]),
            "call_ms": cuda_ms(ffn, spec["reps"]),
            "loop_ms": cuda_ms(lambda: MoE.expert_ffn(
                xs, p, offs.tolist(), cfg.act, MoE.grouped_matmul_plain), 3),
            **dict(zip(("bound_ms", "bound_by"), _bound(byts, ops))),
            "operations": ops,
            "shape": f"xs ({n_rows},{d}), W ({E},{d},{f}) bf16, {cfg.act}"}
        del x, xs, h, gate
    # routing ties: the card's ids against the CPU's on the same logits
    logits = _randn(gen, (64, E), torch.float32)
    logits[0] = 0.0                                       # all tied
    logits[1:9] = torch.round(logits[1:9] * 2)            # integer ties
    card_ids = MoE.top_k(logits, k)[1].cpu()
    cpu_ids = MoE.top_k(logits.cpu(), k)[1]
    ties = {"rows": 64, "equal": bool(torch.equal(card_ids, cpu_ids)),
            "all_tied_row": card_ids[0].tolist()}
    if not ties["equal"] or ties["all_tied_row"] != list(range(k)):
        bad.append("top_k")
    emit({"phase": phase, **rows, "routing_ties": ties})
    if bad:
        raise SystemExit(f"{phase}: grouped products or routing off the "
                         f"plain versions (or not torch._grouped_mm): {bad}")
    if blind:
        raise SystemExit(f"{phase}: the check passed a planted fault at "
                         f"{blind}")
    return rows


def phase_serve_moe():
    """The moe serving path (granite-moe-1b-a400m at full width and depth:
    24 layers of GQA attention at head dim 64 and a 32-expert top-8 MoE)
    through the two attention kernels, each of which must launch at least
    once per layer and prefill or decode step, with the expert products
    through ``torch._grouped_mm`` (``grouped_variant``); syncs per decode
    step (and where they come from, ``sites_per_step``); its teacher-forced
    check against the plain path (attention
    ``naive``, which also runs the experts through the per-expert loop);
    its profile; the attention kernels at its shapes; ``grouped_matmul`` at
    its shapes (``serve_moe_experts``)."""
    from repro_torch.models import moe as MoE
    from repro_torch.models.layers import AttnOptions
    spec = SERVE_MOE
    MoE.grouped_matmul.last_variant = None
    report, ctx = drive_serve(spec, dict(opts=AttnOptions(backend="fused")),
                              "serve_moe", ("flash_attention", "flash_decode"))
    cfg = ctx["eng"].cfg
    prefills, steps = len(spec["prompts"]), report["decode_steps"]
    need = {"flash_attention": cfg.n_layers * prefills,
            "flash_decode": cfg.n_layers * steps}
    report.update(head_dim=cfg.head_dim, kv_heads=cfg.n_kv_heads,
                  n_experts=cfg.n_experts, top_k=cfg.top_k,
                  d_ff_expert=cfg.d_ff_expert, launches_min=need,
                  grouped_variant=MoE.grouped_matmul.last_variant)
    short = [n for n, m in need.items() if report["launches"][n] < m]
    if short or report["grouped_variant"] != "grouped_mm":
        emit(report)
        raise SystemExit(f"serve_moe: fewer launches than layers x prefills "
                         f"/ steps ({short}) or the experts did not run "
                         f"torch._grouped_mm")
    plain = dict(opts=AttnOptions(backend="naive"))
    verify_serve_logits(report, ctx, plain)
    profile_serve(ctx, "serve_moe_profile")
    rows = time_serve_kernels(ctx, spec, "serve_moe_kernels",
                              ("flash_attention", "flash_decode"))
    report["syncs"] = decode_syncs(ctx, plain)
    emit(report)
    time_moe_experts(ctx, spec)
    del ctx
    torch.cuda.empty_cache()
    return report, rows


def mla_faults(args, plain, ref, rope=64, v_tail=16):
    """What an attention kernel that lost part of MLA's uneven head dims
    would return on ``args`` (hd_qk 192 = nope 128 + rope 64, hd_v 128),
    made with the plain version: the scores without the last ``rope``
    qk columns (the rope part, where position lives) and the output's last
    ``v_tail`` columns left at zero (a v tail lost).  The check must
    reject each."""
    q, k, v, qpos, kpos, window, scale = args
    q2 = q.clone()
    q2[..., -rope:] = 0
    cut = ref.clone()
    cut[..., -v_tail:] = 0
    return {"rope_columns_dropped": plain(q2, k, v, qpos, kpos, window,
                                          scale),
            "v_tail_lost": cut}


def sdpa_call(backend, qt, kt, vt, scale):
    """SDPA on ``backend`` alone, causal (a function of no arguments)."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    def call():
        with sdpa_kernel([backend]):
            return F.scaled_dot_product_attention(qt, kt, vt, scale=scale,
                                                  is_causal=True)
    return call


def sdpa_backends(qt, kt, vt, scale, reps):
    """Which of SDPA's backends take these operands (causal): each one's
    graph time where it does, the reason it gave where not."""
    import warnings
    from torch.nn.attention import SDPBackend
    out = {}
    for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
              SDPBackend.EFFICIENT_ATTENTION):
        call = sdpa_call(b, qt, kt, vt, scale)
        with warnings.catch_warnings(record=True) as said:
            warnings.simplefilter("always")
            try:
                call()
                sync()
            except RuntimeError as e:
                # the dispatcher says why each backend declined; keep the
                # line about this one
                key = {"FLASH_ATTENTION": "flash",
                       "CUDNN_ATTENTION": "cudnn",
                       "EFFICIENT_ATTENTION": "efficient"}[b.name]
                why = [str(w.message).strip().splitlines()[0] for w in said]
                mine = [w for w in why if key in w.lower()
                        and "not used because" not in w]
                out[b.name] = {"takes": False, "reason": (
                    mine or why or [str(e).strip().splitlines()[0]]
                    )[0][:200]}
                continue
        try:
            out[b.name] = {"takes": True, "ms": graph_ms(call, reps)}
        except RuntimeError as e:        # no graph capture: eager events
            out[b.name] = {"takes": True, "ms": cuda_ms(call, reps),
                           "eager": str(e).strip().splitlines()[0][:160]}
    return out


def time_mla_kernels(ctx, spec=SERVE_MLA, phase="serve_mla_kernels"):
    """The MLA path's two kernels at its shapes, with its own weights where
    it has them.  ``flash_attention`` at q (1,4608,16,1,192), k (1,4608,16,
    192), v (1,4608,16,128), causal (the prefill's MHA over the expanded
    latent): against its plain version per element and per row, with the
    planted faults (``planted_faults``, ``head_tail_faults`` and
    ``mla_faults``: the rope's 64 qk columns dropped, a v tail lost) each
    rejected; graph-timed beside the bound and SDPA on the same inputs
    (``sdpa_backends`` says which backend takes hd_qk != hd_v, and the
    fastest of them is the library time; with none, flash on v zero-padded
    to 192, which is timed in any case: ``sdpa_flash_v_padded_ms``).  It must run
    ``wmma`` (``wgmma_tma`` takes hd_qk == hd_v only).
    ``fused_rmsnorm_mlp`` at the dense prelude's d 2,048 / F 10,944 with its
    weights, N 4,608 (``wgmma_tma``) and the 4-slot decode (``gemv_tma``),
    beside cuBLAS's ``matmul_ms`` and the bound (``time_serve_mlp``)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention_plain
    eng = ctx["eng"]
    cfg = eng.cfg
    H = cfg.n_heads
    hd, hdv = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    S, slots = max(spec["prompts"]), spec["slots"]
    gen = torch.Generator(device=DEV).manual_seed(SEED + 7)
    bf16 = torch.bfloat16
    from torch.nn.attention import SDPBackend
    a = attention_case(gen, 1, S, S, H, 1, hd, hdv, 0, bf16)
    q, k, v, qp, kp, _, scale = a
    qt = q.reshape(1, S, H, hd).transpose(1, 2).contiguous()
    kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
    backends = sdpa_backends(qt, kt, vt, scale, spec["reps"])
    vpad = F.pad(vt, (0, hd - hdv)).contiguous()
    padded = sdpa_call(SDPBackend.FLASH_ATTENTION, qt, kt, vpad, scale)
    takes = {n: b["ms"] for n, b in backends.items()
             if b["takes"] and "eager" not in b}
    # the library call: the fastest backend that takes hd_qk != hd_v, else
    # flash on v zero-padded to hd_qk (its output's first hdv columns)
    best = min(takes, key=takes.get) if takes else None
    library = (sdpa_call(getattr(SDPBackend, best), qt, kt, vt, scale)
               if best else padded)
    r = time_llm_kernel("flash_attention", "attention", a,
                        flash_attention_plain, library)
    r["sdpa_backends"] = backends
    r["library"] = (f"SDPA {best}" if best else
                    "SDPA FLASH_ATTENTION, v zero-padded to hd_qk")
    r["sdpa_flash_v_padded_ms"] = graph_ms(padded, spec["reps"])
    del vpad
    ref = flash_attention_plain(*a)
    for fault, bad in mla_faults(a, flash_attention_plain, ref).items():
        c = llm_check("attention", bad, ref, bf16)
        r["planted_faults"][fault] = {
            "max_abs_err": c["max_abs_err"],
            "max_row_rel_err": c["max_row_rel_err"], "rejected": not c["ok"]}
    r["faults_rejected"] = all(f["rejected"]
                               for f in r["planted_faults"].values())
    del ref, bad
    pairs = S * (S + 1) / 2.0
    ops = 2.0 * pairs * H * (hd + hdv)
    out_bytes = float(S * H * hdv * 2)
    r.update(zip(("bound_ms", "bound_by"),
                 _bound(_nbytes(q, k, v, qp, kp) + out_bytes, ops)))
    r.update(shape=f"q (1,{S},{H},1,{hd}), v hd {hdv}, bf16, causal",
             live_pairs_per_head=pairs, operations=ops)
    rows = {"flash_attention": r}
    del a, q, k, v, qt, kt, vt
    rows["fused_mlp"] = time_serve_mlp(cfg, eng, spec, gen, False, 0, 0, 0,
                                       0, 0, S, slots,
                                       bp=eng.params["prelude"][0])
    want = {"flash_attention": "wmma", "fused_mlp": "wgmma_tma",
            "fused_mlp.also": "gemv_tma"}
    bad = [n for n, r in rows.items()
           if not r["ok"] or ("also" in r and not r["also"]["ok"])]
    blind = [n for n, r in rows.items()
             if not r["faults_rejected"]
             or not r.get("also", {}).get("faults_rejected", True)]
    other = [n for n, v in want.items() if serve_row(rows, n)["variant"] != v]
    emit({"phase": phase, **rows})
    if bad:
        raise SystemExit(f"{phase}: kernels disagree with their plain "
                         f"versions at the MLA path's shapes: {bad}")
    if blind:
        raise SystemExit(f"{phase}: the check passed a planted fault of "
                         f"{blind}")
    if other:
        raise SystemExit(f"{phase}: not the expected device kernel: {other}")
    return rows


def mla_int8_run(ctx, lm_kwargs):
    """The int8 latent cache on the card: ``quant_kv`` of a prefill's bf16
    latent equal, bit for bit, to the CPU's on the same values; then the
    engine's LM and cache swapped for int8 ones (same weights) to serve
    MLA_INT8's requests, and swapped back to serve them again with the bf16
    cache: every logit of the int8 run finite, and the share of greedy
    tokens equal between the two runs (no gate: int8 is a different
    cache)."""
    from repro_torch.models.layers import quant_kv
    from repro_torch.models.transformer import LM
    from repro_torch.runtime.serve import Request
    eng = ctx["eng"]
    cfg = eng.cfg
    rng = np.random.default_rng(SEED + 8)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 1000)),
                             dtype=torch.long, device=DEV)
    _, c = eng.lm.prefill(eng.params, prompt, cache_len=ctx["window"])
    latent = c["blocks"]
    same = all(torch.equal(quant_kv(a).cpu(), quant_kv(a.cpu()))
               for a in latent)
    del c, latent
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in MLA_INT8["prompts"]]
    bf16_lm, bf16_cache = eng.lm, eng.cache
    int8_lm = LM(cfg, **{**lm_kwargs, "kv_cache_dtype": torch.int8})
    finite = []

    def checked(fn):
        def call(*a, **kw):
            lg, cache = fn(*a, **kw)
            finite.append(torch.isfinite(lg).all())
            return lg, cache
        return call

    int8_lm.prefill = checked(int8_lm.prefill)
    int8_lm.decode_step = checked(int8_lm.decode_step)
    outs = {}
    try:
        for label, lm in (("int8", int8_lm), ("bfloat16", bf16_lm)):
            eng.lm = lm
            eng.cache = lm.init_cache(eng.slots, ctx["window"], device=DEV)
            n0 = len(eng.done)
            for i, p in enumerate(prompts):
                eng.submit(Request(rid=20_000 + i, prompt=p,
                                   max_new=MLA_INT8["max_new"]))
            while len(eng.done) < n0 + len(prompts):
                eng.step()
            outs[label] = {r.rid: r.out for r in eng.done[n0:]}
    finally:
        eng.lm, eng.cache = bf16_lm, bf16_cache
    pairs = [(a, b) for rid in outs["int8"]
             for a, b in zip(outs["int8"][rid], outs["bfloat16"][rid])]
    return {"quant_kv_card_equals_cpu": same,
            "cache_dtype": str(int8_lm.kv_cache_dtype),
            "prompts": list(MLA_INT8["prompts"]),
            "max_new": MLA_INT8["max_new"],
            "finite": bool(torch.stack(finite).all()) if finite else False,
            "token_agreement_with_bf16": sum(a == b for a, b in pairs)
            / len(pairs)}


def phase_serve_mla():
    """The MLA serving path (deepseek-v2-lite-16b at full width and depth:
    27 layers of MLA, the first with a dense MLP of width 10,944, the rest
    64 experts top 6 with 2 shared; random bf16 weights from a seed)
    through ``flash_attention`` (the expanded prefill, hd 192 / 128: once
    per layer and prefill) and ``fused_rmsnorm_mlp`` (the prelude's MLP:
    once per prefill and per decode step); MLA decode runs the reference's
    absorbed einsums over the latent cache (no kernel), the expert products
    ``torch._grouped_mm``.  Syncs per decode step (0 inside
    ``LM.decode_step`` on the kernel path, or the phase fails); the
    teacher-forced check against the plain path (attention ``naive``, the
    per-expert loop, the MLP unfused); the int8 latent cache
    (``mla_int8_run``); the profile with the MoE grouped; the kernels at
    the path's shapes (``time_mla_kernels``)."""
    from repro_torch.models import moe as MoE
    from repro_torch.models.layers import AttnOptions
    spec = SERVE_MLA
    MoE.grouped_matmul.last_variant = None
    report, ctx = drive_serve(spec, dict(opts=AttnOptions(backend="fused")),
                              "serve_mla", ("flash_attention", "fused_mlp"))
    eng = ctx["eng"]
    cfg = eng.cfg
    prefills, steps = len(spec["prompts"]), report["decode_steps"]
    need = {"flash_attention": cfg.n_layers * prefills,
            "fused_mlp": cfg.n_dense_layers * (prefills + steps)}
    ck, cr = eng.cache["blocks"]
    report.update(
        kv_lora_rank=cfg.kv_lora_rank, qk_rope_dim=cfg.qk_rope_dim,
        head_dim_qk=cfg.qk_nope_dim + cfg.qk_rope_dim,
        head_dim_v=cfg.v_head_dim, n_experts=cfg.n_experts, top_k=cfg.top_k,
        n_shared_experts=cfg.n_shared_experts, d_ff=cfg.d_ff,
        latent_cache_gb=_nbytes(ck, cr) / 2**30,
        cache_shapes=[list(ck.shape), list(cr.shape)], launches_min=need,
        grouped_variant=MoE.grouped_matmul.last_variant)
    short = [n for n, m in need.items() if report["launches"][n] < m]
    if (short or report["grouped_variant"] != "grouped_mm"
            or report["launches"]["flash_decode"]):
        emit(report)
        raise SystemExit(f"serve_mla: fewer launches than layers x prefills "
                         f"/ prefills + steps ({short}), flash_decode "
                         f"launched, or the experts did not run "
                         f"torch._grouped_mm")
    plain = dict(opts=AttnOptions(backend="naive"))
    verify_serve_logits(report, ctx, plain)
    report["syncs"] = decode_syncs(ctx, plain)
    report["int8_cache"] = mla_int8_run(ctx, dict(opts=AttnOptions(
        backend="fused")))
    emit(report)
    kp = report["syncs"]["kernel_path"]
    if kp["in_decode_step"] != 0 or kp["per_step"] > 1:
        raise SystemExit(f"serve_mla: {kp['in_decode_step']} syncs inside "
                         f"LM.decode_step, {kp['per_step']} a step")
    i8 = report["int8_cache"]
    if not (i8["quant_kv_card_equals_cpu"] and i8["finite"]):
        raise SystemExit("serve_mla: quant_kv on the card differs from the "
                         "CPU's, or the int8 run's logits are not finite")
    profile_serve(ctx, "serve_mla_profile")
    rows = time_mla_kernels(ctx, spec)
    del ctx, eng, ck, cr
    torch.cuda.empty_cache()
    return report, rows


# ---------------------------------------------------------------------------
# card_tests: the gpu-marked pytest cases, on the card
# ---------------------------------------------------------------------------
# The card's machine has no jax, which tests/test_torch_*.py import.  So each
# gpu-marked test there calls the function of its name here (``card_case``)
# with its case, ``phase_card_tests`` runs every case of CARD_TESTS, and a
# CPU test (tests/test_torch_card_cases.py) holds CARD_TESTS to exactly the
# gpu-marked tests and their cases.  Inputs are drawn as the tests draw them.
CARD_DTYPES = ("float32", "bfloat16")
# B, S, KV, G, hd_qk, hd_v, window, block (test_torch_llm_kernels ATTN_CASES)
CARD_ATTN = ((2, 64, 2, 2, 16, 16, 0, 16), (1, 48, 1, 4, 80, 80, 16, 16),
             (1, 32, 4, 1, 24, 16, 0, 8), (2, 40, 2, 2, 80, 80, 12, 8),
             (1, 24, 2, 2, 20, 12, 0, 8), (1, 40, 2, 1, 112, 112, 24, 8))
# B, W, KV, G, hd, window, kv_block, positions (DECODE_CASES)
CARD_DECODE = ((3, 32, 2, 4, 80, 16, 8, (5, 31, 50)),
               (2, 32, 1, 8, 16, 0, 16, (0, 95)),
               (2, 24, 4, 1, 32, 0, 8, (11, 23)),
               (2, 24, 2, 1, 112, 0, 8, (7, 40)))
# flash_decode(return_lse=True): B, W, KV, G, hd, window, positions, part,
# dtype (part -1: a ring of W slots; 0 / 1: that half of a ring of 2 W
# slots, as a rank of a window-split cache holds it); float32 takes the
# cuda_cores sweep, bf16 cp_async; part 1 of (2, 256, ..) and of (2, 64, ..)
# has no live key
CARD_DECODE_LSE = ((3, 32, 2, 4, 80, 16, (5, 31, 50), -1, "float32"),
                   (2, 64, 1, 8, 16, 0, (3, 10), 1, "float32"),
                   (2, 500, 2, 2, 72, 0, (100, 900), 0, "bfloat16"),
                   (2, 256, 2, 4, 80, 0, (3, 100), 1, "bfloat16"),
                   (4, 2048, 8, 4, 80, 4096, (4638, 4639, 3103, 2300), 1,
                    "bfloat16"),
                   (4, 2048, 32, 1, 112, 0, (4608, 4000, 30, 1), 0,
                    "bfloat16"))
# N, d, F of the MLP's parity cases
CARD_MLP = ((32, 64, 96), (4, 80, 64), (70, 300, 130), (12, 64, 130),
            (3, 100, 77))
# B, L, nh, hd, st, chunk, dt scale (test_torch_ssd CASES)
CARD_SSD = ((2, 128, 3, 32, 16, 32, 1.0), (1, 64, 1, 8, 8, 16, 1.0),
            (1, 256, 2, 64, 128, 64, 1.0), (3, 96, 4, 16, 32, 32, 1.0),
            (1, 100, 2, 16, 8, 256, 1.0), (2, 2, 3, 8, 8, 256, 1.0),
            (1, 1, 2, 8, 8, 256, 1.0), (2, 64, 2, 8, 8, 16, 50.0))
CARD_POLICIES = ("open", "guard", "membound", "pid", "ewma")


def _on_card(a, dtype):
    """NumPy values -> a tensor of ``dtype`` (a name) on the card, rounded
    from float32 as the tests round them."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        getattr(torch, dtype)).to(DEV)


def _close(out, ref, atol, rtol=0.0):
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=atol)


def _launched_once(f, before, want=None):
    assert f.launches == before + 1, f"{f.launches} launches, not one"
    if want is not None:
        assert f.last_variant == want, f"ran {f.last_variant}, not {want}"


def _shifted(rng, shape, dtype=torch.bfloat16):
    """A contiguous view that starts one element into its buffer."""
    n = int(np.prod(shape))
    a = torch.from_numpy(rng.standard_normal(n + 1).astype(np.float32))
    return a.to(dtype).to(DEV)[1:].view(shape)


def card_flash_attention(B, S, KV, G, hdq, hdv, win, blk, dtype):
    from repro_torch.kernels import flash_attention as FA
    rng = np.random.default_rng(0)
    q, k, v = (_on_card(rng.standard_normal(sh), dtype)
               for sh in ((B, S, KV, G, hdq), (B, S, KV, hdq),
                          (B, S, KV, hdv)))
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    qp, kp = (torch.from_numpy(p).to(DEV) for p in (pos - 3, pos))
    args = (q, k, v, qp, kp, win, 1 / np.sqrt(hdq))
    before = FA.flash_attention.launches
    out = FA.flash_attention(*args)
    sync()
    _launched_once(FA.flash_attention, before)
    _close(out, FA.flash_attention_plain(*args),
           LLM_ATOL[("attention", getattr(torch, dtype))])


def card_flash_decode(B, W, KV, G, hd, win, blk, pos, dtype):
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.models.layers import ring_kpos
    rng = np.random.default_rng(1)
    q, ck, cv = (_on_card(rng.standard_normal(sh), dtype)
                 for sh in ((B, KV, G, hd), (B, W, KV, hd), (B, W, KV, hd)))
    qp = torch.tensor(pos, dtype=torch.int32, device=DEV)
    kp = ring_kpos(qp, W)
    before = FD.flash_decode.launches
    out = FD.flash_decode(q, ck, cv, qp, kp, win, 1 / np.sqrt(hd), blk)
    sync()
    _launched_once(FD.flash_decode, before)
    _close(out, FD.flash_decode_plain(q, ck, cv, qp, kp, win,
                                      1 / np.sqrt(hd)),
           LLM_ATOL[("attention", getattr(torch, dtype))])


def lse_check(out, lse, ref, ref_lse, dtype) -> dict:
    """flash_decode(return_lse=True) against its plain version: the
    output within the attention limit of its dtype, -inf exactly where the
    plain lse is (those rows' output 0), the finite lse within 1e-4
    absolute (float32 sums of one row's scores; bf16 inputs give both the
    same rounded values)."""
    dead = torch.isneginf(ref_lse)
    fin = ~dead
    err = (float((lse[fin] - ref_lse[fin]).abs().max()) if fin.any()
           else 0.0)
    out_err = _err(out, ref)
    res = {"lse_max_abs_err": err, "lse_atol": LSE_ATOL,
           "dead_rows": int(dead.sum()),
           "dead_match": bool(torch.equal(torch.isneginf(lse), dead)),
           "dead_out_zero": bool((out.float()[dead] == 0).all()),
           "max_abs_err": out_err,
           "tolerance": LLM_ATOL[("attention", dtype)]}
    res["ok"] = bool(err <= LSE_ATOL and res["dead_match"]
                     and res["dead_out_zero"]
                     and out_err <= res["tolerance"]
                     and not torch.isnan(lse).any())
    return res


LSE_ATOL = 1e-4


def decode_lse_case(B, W, KV, G, hd, win, pos, part, dtype, seed=1):
    """(q, cache_k, cache_v, qpos, kpos, window, scale) of a
    ``CARD_DECODE_LSE`` case on the card."""
    from repro_torch.models.layers import ring_kpos
    rng = np.random.default_rng(seed)
    q, ck, cv = (_on_card(rng.standard_normal(sh), dtype)
                 for sh in ((B, KV, G, hd), (B, W, KV, hd), (B, W, KV, hd)))
    qp = torch.tensor(pos, dtype=torch.int32, device=DEV)
    kp = (ring_kpos(qp, W) if part < 0 else
          ring_kpos(qp, 2 * W)[:, part * W:(part + 1) * W].contiguous())
    return q, ck, cv, qp, kp, win, 1 / np.sqrt(hd)


# flash_decode(return_lse=True) at a window-split cache's rank slice (a
# data rank's 2 rows, one half of the 4,096-slot ring, every kv head):
# danube's and zamba2's decode shapes, B, W, KV, G, hd, window, positions,
# part; danube's second at positions below half the ring: no live key
LSE_SLICES = ((2, 2048, 8, 4, 80, 4096, (4638, 4639), 1),
              (2, 2048, 8, 4, 80, 4096, (1000, 1031), 1),
              (2, 2048, 32, 1, 112, 0, (3000, 3031), 0),
              (2, 2048, 32, 1, 112, 0, (3000, 3031), 1))


def lse_faults(out, lse, ref_lse) -> dict:
    """Planted faults of ``flash_decode(return_lse=True)``'s pair, each of
    which ``lse_check`` must reject: one row's lse off by 1e-2, one row
    live where it is dead or dead where it is live, a NaN, and a dead
    row's output made non-zero (where the case has one)."""
    out_f = {}
    live = torch.isfinite(ref_lse)
    if live.any():
        shifted = lse.clone()
        shifted[tuple(live.nonzero()[0])] += 1e-2
        out_f["lse_shifted"] = (out, shifted)
    flip = lse.clone()
    first = flip.view(-1)
    first[0] = 0.0 if torch.isneginf(ref_lse.view(-1)[0]) else -torch.inf
    out_f["dead_flipped"] = (out, flip)
    nan = lse.clone()
    nan.view(-1)[-1] = torch.nan
    out_f["lse_nan"] = (out, nan)
    if (~live).any():
        o = out.clone()
        o[tuple((~live).nonzero()[0])] = 0.5
        out_f["dead_row_output"] = (o, lse)
    return out_f


def lse_combine_check(gen) -> dict:
    """The kernel over each half of danube's 4,096-slot ring with its
    lse, merged as placed decode merges its ranks' slices
    (``layers.merge_by_lse``), against the kernel over the whole ring (the
    attention checks): a wrapped ring (both halves live) and an early one
    (the second half empty: no NaN, weight 0); a planted wrong lse (the
    second half's + 1) must be rejected."""
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.models.layers import merge_by_lse
    bf16 = torch.bfloat16
    res = {}
    for tag, pos in (("wrapped", [4638, 4639]), ("half_empty", [1000, 1031])):
        a = decode_case(gen, 2, 4096, 8, 4, 80, 80, 4096, bf16, pos)
        q, ck, cv, qp, kp, win, scale = a
        whole = FD.flash_decode(*a)
        parts = [FD.flash_decode(q, ck[:, sl].contiguous(),
                                 cv[:, sl].contiguous(), qp,
                                 kp[:, sl].contiguous(), win, scale,
                                 return_lse=True)
                 for sl in (slice(0, 2048), slice(2048, 4096))]
        sync()
        outs = torch.stack([o for o, _ in parts])
        merged = merge_by_lse(outs, torch.stack([l for _, l in parts]))
        c = llm_check("attention", merged.to(bf16), whole, bf16)
        wrong = merge_by_lse(outs, torch.stack([parts[0][1],
                                                parts[1][1] + 1.0]))
        w = llm_check("attention", wrong.to(bf16), whole, bf16)
        res[tag] = {"max_abs_err": c["max_abs_err"],
                    "max_row_rel_err": c["max_row_rel_err"],
                    "finite": bool(torch.isfinite(merged).all()),
                    "second_half_dead_rows": int(
                        torch.isneginf(parts[1][1]).sum()),
                    "wrong_lse_rejected": (not w["ok"]) or tag == "half_empty",
                    "ok": c["ok"] and bool(torch.isfinite(merged).all())}
        res[tag]["ok"] &= res[tag]["wrong_lse_rejected"]
    # at 1,000 the second half holds no live key: its rows must be dead
    res["half_empty"]["ok"] &= res["half_empty"][
        "second_half_dead_rows"] == 2 * 8 * 4
    return res


def card_flash_decode_lse(B, W, KV, G, hd, win, pos, part, dtype):
    from repro_torch.kernels import flash_decode as FD
    args = decode_lse_case(B, W, KV, G, hd, win, pos, part, dtype)
    before = FD.flash_decode.launches
    out, lse = FD.flash_decode(*args, return_lse=True)
    sync()
    _launched_once(FD.flash_decode, before,
                   "cuda_cores" if dtype == "float32" else "cp_async")
    ref, ref_lse = FD.flash_decode_plain(*args, return_lse=True)
    res = lse_check(out, lse, ref, ref_lse, getattr(torch, dtype))
    assert res["ok"], res
    assert (res["dead_rows"] > 0) == (part == 1 and max(pos) < W), res


def _mlp_ok(out, args):
    from repro_torch.kernels.fused_mlp import fused_rmsnorm_mlp_plain
    res = llm_check("mlp", out, fused_rmsnorm_mlp_plain(*args),
                    args[0].dtype)
    assert res["ok"], f"MLP off its plain version: {res}"


def card_fused_mlp(N, d, F, act, dtype):
    from repro_torch.kernels import fused_mlp as FM
    rng = np.random.default_rng(2)
    x, s, wg, wu = (_on_card(a, dtype) for a in (
        rng.standard_normal((N, d)), 0.1 * rng.standard_normal(d),
        rng.standard_normal((d, F)) / np.sqrt(d),
        rng.standard_normal((d, F)) / np.sqrt(d)))
    before = FM.fused_rmsnorm_mlp.launches
    out = FM.fused_rmsnorm_mlp(x, s, wg, wu, act)
    sync()
    _launched_once(FM.fused_rmsnorm_mlp, before)
    _mlp_ok(out, (x, s, wg, wu, act, 1e-5))


def _edge_pos(kind, n, lo, seed):
    p = (np.random.default_rng(seed).permutation(n) + lo if kind == "perm"
         else np.arange(lo, lo + n))
    return torch.from_numpy(p.astype(np.int32))[None].to(DEV)


def card_flash_attention_wgmma_edges(B, Sq, Sk, KV, G, hd, win, qk, kk):
    from repro_torch.kernels import flash_attention as FA
    rng = np.random.default_rng(7)
    q, k, v = (_on_card(rng.standard_normal(sh), "bfloat16")
               for sh in ((B, Sq, KV, G, hd), (B, Sk, KV, hd),
                          (B, Sk, KV, hd)))
    qp = _edge_pos(qk[0], Sq, qk[1], 1).expand(B, Sq).contiguous()
    kp = _edge_pos(kk, Sk, 0, 2).expand(B, Sk).contiguous()
    args = (q, k, v, qp, kp, win, 1 / np.sqrt(hd))
    before = FA.flash_attention.launches
    out = FA.flash_attention(*args)
    sync()
    _launched_once(FA.flash_attention, before, "wgmma_tma")
    ref = FA.flash_attention_plain(*args)
    _close(out, ref, LLM_ATOL[("attention", torch.bfloat16)])
    assert row_rel_err(out, ref) <= LLM_ROW_RTOL[torch.bfloat16]


def card_fused_mlp_wgmma_edges(N, d, F, act):
    from repro_torch.kernels import fused_mlp as FM
    rng = np.random.default_rng(3)
    x, s, wg, wu = (_on_card(a, "bfloat16") for a in (
        rng.standard_normal((N, d)), 0.1 * rng.standard_normal(d),
        0.02 * rng.standard_normal((d, F)),
        0.02 * rng.standard_normal((d, F))))
    before = FM.fused_rmsnorm_mlp.launches
    out = FM.fused_rmsnorm_mlp(x, s, wg, wu, act)
    sync()
    _launched_once(FM.fused_rmsnorm_mlp, before, "wgmma_tma")
    _mlp_ok(out, (x, s, wg, wu, act, 1e-5))


def card_fused_mlp_gemv_edges(N, d, F, act):
    """The gemv_tma kernel at one EDGE_MLP_ROWS case: it runs, agrees with
    the plain version under the MLP limit and, at a dense config's widths,
    the check rejects every planted fault."""
    from repro_torch.kernels import fused_mlp as FM
    gen = torch.Generator(device=DEV).manual_seed(12)
    args = mlp_case(gen, N, d, F, act, torch.bfloat16)
    before = FM.fused_rmsnorm_mlp.launches
    out = FM.fused_rmsnorm_mlp(*args)
    sync()
    _launched_once(FM.fused_rmsnorm_mlp, before, "gemv_tma")
    _mlp_ok(out, args)
    if (d, F) in DENSE_WIDTHS:
        faults = mlp_faults_rejected(args, FM.fused_rmsnorm_mlp_plain(*args))
        assert all(f["rejected"] for f in faults.values()), faults


def card_misaligned_views():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_mlp as FM
    rng = np.random.default_rng(4)
    bf16 = torch.bfloat16
    q = _shifted(rng, (1, 130, 2, 2, 80))
    k, v = _shifted(rng, (1, 130, 2, 80)), _shifted(rng, (1, 130, 2, 80))
    p = torch.arange(130, dtype=torch.int32, device=DEV)[None]
    out = FA.flash_attention(q, k, v, p, p, 0, 80 ** -0.5)
    assert FA.flash_attention.last_variant == "wmma"
    _close(out, FA.flash_attention_plain(q, k, v, p, p, 0, 80 ** -0.5),
           LLM_ATOL[("attention", bf16)])
    x = _shifted(rng, (40, 64))
    s = (0.1 * _shifted(rng, (64,)).float()).to(bf16)
    wg, wu = ((0.1 * _shifted(rng, (64, 96)).float()).to(bf16)
              for _ in range(2))
    out = FM.fused_rmsnorm_mlp(x, s, wg, wu, "silu")
    assert FM.fused_rmsnorm_mlp.last_variant == "wmma"
    _mlp_ok(out, (x, s, wg, wu, "silu", 1e-5))


def card_misaligned_decode_mlp():
    """A decode x that is no TMA operand takes the rows kernel."""
    from repro_torch.kernels import fused_mlp as FM
    N, d, F, act = MISALIGNED_MLP_ROWS
    gen = torch.Generator(device=DEV).manual_seed(14)
    args = mlp_case(gen, N, d, F, act, torch.bfloat16)
    args = (misaligned(args[0]),) + args[1:]
    out = FM.fused_rmsnorm_mlp(*args)
    sync()
    assert FM.fused_rmsnorm_mlp.last_variant == "rows"
    _mlp_ok(out, args)


def card_flash_decode_cp_async_edges(B, W, KV, G, hd, hdv, win, pos, blk,
                                     qd, ring):
    from repro_torch.kernels import flash_decode as FD
    gen = torch.Generator(device=DEV).manual_seed(11)
    args = edge_decode_case(gen, B, W, KV, G, hd, hdv, win, pos, qd, ring)
    before = FD.flash_decode.launches
    out = FD.flash_decode(*args, blk)
    sync()
    _launched_once(FD.flash_decode, before, "cp_async")
    assert FD.flash_decode.last_split == FD.decode_split(
        B * KV, W, blk, FD._sm_count(out.device))
    ref = FD.flash_decode_plain(*args)
    dt = torch.float32 if qd == "f32" else torch.bfloat16
    _close(out, ref, LLM_ATOL[("attention", dt)])
    assert row_rel_err(out, ref) <= LLM_ROW_RTOL[dt]


def card_misaligned_decode_cache():
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.models.layers import ring_kpos
    rng = np.random.default_rng(5)
    bf16 = torch.bfloat16
    B, W, KV, G, hd = 2, 300, 2, 4, 80
    q = _on_card(rng.standard_normal((B, KV, G, hd)), "bfloat16")
    ck, cv = _shifted(rng, (B, W, KV, hd)), _shifted(rng, (B, W, KV, hd))
    pos = torch.tensor([100, 400], dtype=torch.int32, device=DEV)
    args = (q, ck, cv, pos, ring_kpos(pos, W), 0, hd ** -0.5)
    out = FD.flash_decode(*args, 128)
    assert FD.flash_decode.last_variant == "cuda_cores"
    assert FD.flash_decode.last_split == 128
    _close(out, FD.flash_decode_plain(*args), LLM_ATOL[("attention", bf16)])
    ck, cv = (c.clone() for c in (ck, cv))               # aligned copies
    args = (_shifted(rng, (B, KV, G, hd)), ck, cv) + args[3:]
    out = FD.flash_decode(*args, 128)
    assert FD.flash_decode.last_variant == "cuda_cores"
    _close(out, FD.flash_decode_plain(*args), LLM_ATOL[("attention", bf16)])


def _ssd_inputs(B, L, nh, hd, st, dt_scale=1.0, seed=0):
    """float32 inputs on the card, drawn as tests/test_torch_ssd.py draws
    them (tests/test_kernels.py's draws)."""
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((B, L, nh, hd))
    dt = np.logaddexp(rng.standard_normal((B, L, nh)), 0.0) * dt_scale
    A = -np.exp(0.2 * rng.standard_normal(nh))
    Bm, Cm = rng.standard_normal((B, L, st)), rng.standard_normal((B, L, st))
    return [_on_card(a, "float32") for a in (xs, dt, A, Bm, Cm, np.ones(nh))]


def card_ssd_scan(B, L, nh, hd, st, chunk, dt_scale):
    from repro_torch.kernels import ssd_scan as SS
    a = _ssd_inputs(B, L, nh, hd, st, dt_scale)
    before = SS.ssd_scan.launches
    y, h = SS.ssd_scan(*a, chunk)
    sync()
    _launched_once(SS.ssd_scan, before)
    ry, rh = SS.ssd_scan_plain(*a, chunk)
    _close(y, ry, SSD_TOL, SSD_TOL)
    _close(h, rh, SSD_TOL, SSD_TOL)


def card_ssd_scan_tf32x3_edges(B, L, nh, hd, st, chunk, kind):
    from repro_torch.kernels import ssd_scan as SS
    gen = torch.Generator(device=DEV).manual_seed(13)
    args = ssd_case(gen, B, L, nh, hd, st, kind)
    before = SS.ssd_scan.launches
    y, h = SS.ssd_scan(*args, chunk)
    sync()
    _launched_once(SS.ssd_scan, before, "tf32x3")
    assert ssd_check(y, h, *SS.ssd_scan_plain(*args, chunk))["ok"]


def card_misaligned_ssd():
    from repro_torch.kernels import ssd_scan as SS
    a = _ssd_inputs(1, 64, 2, 8, 8)
    xs = misaligned(a[0])
    y, h = SS.ssd_scan(xs, *a[1:], 16)
    assert SS.ssd_scan.last_variant == "cuda_cores"
    ry, rh = SS.ssd_scan_plain(xs, *a[1:], 16)
    _close(y, ry, SSD_TOL, SSD_TOL)
    _close(h, rh, SSD_TOL, SSD_TOL)


def _tick_platform(k, flows=None):
    """The four-tile dfmul platform of tests/_torch_port_helpers.py."""
    from repro_torch.core.perfmodel import AccelWorkload, SoCPerfModel
    from repro_torch.sim.engine import SimPlatform
    pos = [(r, c) for r in range(4) for c in range(4)
           if (r, c) not in {(1, 0), (0, 0), (0, 3)}][:4]
    wls = [AccelWorkload("dfmul", 8.70, 1.1, replication=k) for _ in pos]
    return SimPlatform.build(SoCPerfModel(), wls, pos, noc_rate=1.0, n_tg=2,
                             req_mb=0.005, flows=flows)


def card_tick_sim(policy):
    """tests/test_torch_tick_sim.py's card case: four tiles, a chain, the
    45 nm tech model, max_queue 3, an MMPP trace, every policy."""
    from repro_torch.kernels.tick_sim import (fused_tick_sim,
                                              fused_tick_sim_plain)
    from repro_torch.sim.batch import BatchSimEngine, BatchSimPlatform
    from repro_torch.sim.control import BatchControllerHarness
    from repro_torch.sim.engine import SimConfig
    from repro_torch.sim.flows import FlowPattern
    from repro_torch.sim.traffic import mmpp_trace
    flows = FlowPattern.chain(("dfmul0", "dfmul1"), ("dfmul2", "dfmul3"),
                              demand={"dfmul0": 0.3})
    plat = BatchSimPlatform.stack([_tick_platform(k, flows)
                                   for k in (2, 4, 8)])
    ctl = None
    if policy != "open":
        ctl = BatchControllerHarness(
            plat.islands, plat.rates,
            make_policy(policy),
            tile_names=plat.names, queue_guard_ticks=3.0)
    eng = BatchSimEngine(plat, config=SimConfig(control_interval=25,
                                                max_queue=3.0),
                         controller=ctl, backend="fused", tech=45, device=DEV)
    cap = BatchSimEngine(BatchSimPlatform.stack([_tick_platform(2)]),
                         device="cpu").capacity_rps()[0]
    tr = mmpp_trace(cap * 0.1, cap * 1.3, 300, 4, dt=1e-3, seed=3)
    arr, consts, scalars, init, plan = eng.fused_inputs(tr)[:5]
    before = fused_tick_sim.launches
    out = fused_tick_sim(arr, consts, scalars, init, plan=plan)
    sync()
    _launched_once(fused_tick_sim, before)
    ref = fused_tick_sim_plain(arr, consts, scalars, init, plan=plan)
    for key in ("adm", "served", "queue", "busy", "rtt", "rates", "energy",
                "dropped"):
        _close(out[key], ref[key], ATOL, RTOL)
    assert torch.equal(out["swaps"], ref["swaps"])
    assert torch.equal(out["guard"], ref["guard"])


def card_shard_fused(policy):
    """tests/test_torch_shard.py's card case: ``"fused"`` with
    ``devices=4`` (the forced count 4, every shard on this card) against
    the unsharded launch at a ragged B = 5, bit for bit, with one launch a
    shard."""
    from repro_torch.kernels.tick_sim import fused_tick_sim
    from repro_torch.sim.batch import BatchSimEngine, BatchSimPlatform
    from repro_torch.sim.control import BatchControllerHarness
    from repro_torch.sim.engine import SimConfig
    from repro_torch.sim.traffic import diurnal_trace
    cap = BatchSimEngine(BatchSimPlatform.stack([_tick_platform(2)]),
                         device="cpu").capacity_rps()[0]
    tr = diurnal_trace(cap * 0.6, 400, 4, dt=1e-3, depth=0.5, seed=3)
    got = {}
    for d in (None, 4):
        plat = BatchSimPlatform.stack([_tick_platform(k)
                                       for k in (2, 4, 8, 8, 4)])
        ctl = BatchControllerHarness(plat.islands, plat.rates,
                                     make_policy(policy),
                                     tile_names=plat.names,
                                     queue_guard_ticks=3.0)
        eng = BatchSimEngine(plat, config=SimConfig(control_interval=25),
                             controller=ctl, backend="fused", device=DEV,
                             devices=d)
        before = fused_tick_sim.launches
        with forced_devices(4):
            got[d] = eng.run(tr), ctl
        sync()
        assert fused_tick_sim.launches - before == (1 if d is None else 4)
    (a, ca), (b, cb) = got[None], got[4]
    assert not shard_gap(a, b), shard_gap(a, b)
    assert np.array_equal(ca.rates, cb.rates)
    assert np.array_equal(ca.swaps, cb.swaps)


CARD_SWEEP = dict(ks=(1, 2), acc_rates=(0.2, 0.6, 1.0), noc_rates=(0.5, 1.0),
                  tg_rates=(0.5, 1.0), positions=((1, 1), (3, 3), (0, 2)),
                  n_tg=4)
CARD_CHUNKS = tuple((m, c) for m in ("shared", "independent")
                    for c in (17, 101, 430))


def card_chunked_sweep(mode, chunk):
    """tests/test_torch_dse_chunked.py's card case: the chunked sweep with
    its mask, prefilter and top-k on the card against the host NumPy
    chunked sweep (the reference's loop): same n_valid, Pareto set, top-k
    and tracked indices, values <= 1e-12; and the dense sweep's prefilter
    on the card gives the host's Pareto set."""
    from repro_torch.configs.vespa_soc import CHSTONE
    from repro_torch.core.dse import (ChunkedSweepResult, _TRACKED_OBJECTIVES,
                                      grid_sweep)
    from repro_torch.core.perfmodel import AccelWorkload, SoCPerfModel
    model = SoCPerfModel()
    wls = [AccelWorkload(n, *CHSTONE[n]) for n in ("dfsin", "gsm")]
    kw = dict(CARD_SWEEP, island_rates=mode)
    card = grid_sweep(model, wls, **kw, chunk_points=chunk, topk_track=16,
                      device=DEV, backend="torch")
    host = grid_sweep(model, wls, **kw, chunk_points=chunk, topk_track=16,
                      device="cpu")
    assert isinstance(card, ChunkedSweepResult) and card.backend == "torch"
    assert (card.n_valid, card.n_chunks) == (host.n_valid, host.n_chunks)
    assert np.array_equal(card.pareto_indices(), host.pareto_indices())
    for o, _ in _TRACKED_OBJECTIVES:
        assert np.array_equal(card.topk_indices(16, o),
                              host.topk_indices(16, o)), o
    assert np.array_equal(card.cand_indices, host.cand_indices)
    for o, v in host.cand_values.items():
        assert np.all(np.abs(card.cand_values[o] - v)
                      <= 1e-12 * np.abs(v)), o
    dense = grid_sweep(model, wls, **kw, device=DEV, backend="torch")
    assert dense.front_candidates is not None
    assert np.array_equal(dense.pareto_indices(), host.pareto_indices())


def card_telemetry(policy):
    """tests/test_torch_telemetry.py's card case: the float64 ``"torch"``
    loop's telemetry on the card (a wrapped ring, every policy) against
    the same run on the CPU: rel <= 1e-12, events and rows equal, and no
    host sync inside any row (``NoSyncPerRow``)."""
    from repro_torch.sim.batch import BatchSimEngine, BatchSimPlatform
    from repro_torch.sim.control import BatchControllerHarness
    from repro_torch.sim.engine import SimConfig
    from repro_torch.sim.traffic import mmpp_trace
    plat = BatchSimPlatform.stack([_tick_platform(k) for k in (2, 4, 8)])
    cfg = SimConfig(control_interval=25, telemetry_interval=7,
                    telemetry_capacity=20)
    cap = BatchSimEngine(BatchSimPlatform.stack([_tick_platform(2)]),
                         device="cpu").capacity_rps()[0]
    tr = mmpp_trace(cap * 0.1, cap * 1.3, 300, 4, dt=1e-3, seed=3)

    def run(device):
        ctl = None
        if policy != "open":
            ctl = BatchControllerHarness(
                plat.islands, plat.rates, make_policy(policy),
                tile_names=plat.names, queue_guard_ticks=3.0)
        return BatchSimEngine(plat, config=cfg, controller=ctl,
                              backend="torch", device=device).run(tr)

    with NoSyncPerRow() as guard:
        card = run(DEV).telemetry
    host = run("cpu").telemetry
    assert guard.rows == card.scalars.total_appended == 42
    assert telemetry_gap(card, host) <= 1e-12


def card_sim_engine(policy):
    """tests/test_torch_sim_engine.py's card case: the sequential engine on
    the card (four tiles, an MMPP trace, a wrapped telemetry ring, every
    policy) against the same run on the CPU (energy, completed, dropped,
    residual <= SEQ_RTOL; p50, p99, swaps, commit events exact), and the
    B = 1 batched run on the card against it, bit for bit."""
    from functools import partial
    from repro_torch.core.dfs import (BatchMemoryBoundPolicy,
                                      BatchPIDRatePolicy, PIDRatePolicy,
                                      policy_memory_bound)
    from repro_torch.sim import (BatchControllerHarness, BatchSimEngine,
                                 BatchSimPlatform, ControllerHarness,
                                 SimConfig, SimEngine)
    from repro_torch.sim.traffic import mmpp_trace
    plat = _tick_platform(8)
    cfg = SimConfig(control_interval=20, telemetry_interval=7,
                    telemetry_capacity=20)
    cap = SimEngine(plat, device="cpu").capacity_rps()
    tr = mmpp_trace(cap * 0.1, cap * 1.3, 400, 4, dt=1e-3, seed=3)
    scalar = {"membound": lambda: partial(policy_memory_bound,
                                          threshold=0.55, low_rate=0.5),
              "pid": lambda: PIDRatePolicy(target=0.7)}
    batch = {"membound": lambda: BatchMemoryBoundPolicy(threshold=0.55,
                                                        low_rate=0.5),
             "pid": lambda: BatchPIDRatePolicy(target=0.7)}

    def run(device):
        ctl = (None if policy == "open" else ControllerHarness(
            plat.islands, scalar[policy](), queue_guard_ticks=3.0))
        eng = SimEngine(plat, config=cfg, controller=ctl, device=device)
        return eng, eng.run(tr)

    e_card, card = run(DEV)
    _, host = run("cpu")
    gap = seq_gap(card, host)
    assert seq_gap_ok(gap), gap
    bp = BatchSimPlatform.stack([plat])
    ctl = (None if policy == "open" else BatchControllerHarness(
        bp.islands, bp.rates, batch[policy](), tile_names=bp.names,
        queue_guard_ticks=3.0))
    b_eng = BatchSimEngine(bp, config=cfg, controller=ctl, device=DEV)
    bat = b_eng.run(tr)
    for f in ("energy_j", "completed", "residual", "p50_latency_s",
              "p99_latency_s"):
        assert getattr(bat, f)[0] == getattr(card, f), f
    assert int(bat.swaps[0]) == card.swaps
    for a, b in zip(b_eng.last_histories, e_card.last_histories):
        assert torch.equal(a[:, 0], b)


# (seed, T): random histories, and T = 1
CARD_PERCENTILES = ((0, 300), (1, 300), (2, 1), (3, 57))


def percentile_histories(seed, T, B=9, A=3):
    """(T, B, A) admitted / served float64 histories of FIFO fluid queues:
    integer and fractional batches (ties in the delays), empty ticks, a
    queue that drains by the end and one that does not, and a design with
    nothing admitted."""
    rng = np.random.default_rng(seed)
    adm = rng.poisson(3.0, size=(T, B, A)).astype(np.float64)
    adm[:, 1::2] *= rng.choice([0.5, 0.25, 1.0 / 3.0], size=(T, 1, A))
    adm *= rng.uniform(0.0, 1.0, size=(T, B, A)) < 0.8      # empty ticks
    cap = rng.uniform(0.5, 4.5, size=(B, A))
    adm[:, 2] = 0.0                                          # an idle design
    served = np.zeros_like(adm)
    q = np.zeros((B, A))
    for t in range(T):
        q = q + adm[t]
        served[t] = np.minimum(q, cap)
        q = q - served[t]
    return adm, served


def card_percentiles(seed, T):
    """tests/test_torch_sim_batch.py's card case: ``latency_percentiles_batch``
    on the card (float64 and float32 histories, design blocks) against the
    NumPy per-design function, bit for bit."""
    from repro_torch.sim.engine import (latency_percentiles,
                                        latency_percentiles_batch)
    adm, srv = percentile_histories(seed, T)
    for dtype in (torch.float64, torch.float32):
        a = torch.as_tensor(adm, device=DEV).to(dtype)
        s_ = torch.as_tensor(srv, device=DEV).to(dtype)
        p50, p99 = latency_percentiles_batch(a, s_, 1e-3,
                                             max_elems=T * 3 * 4)
        ah, sh = a.double().cpu().numpy(), s_.double().cpu().numpy()
        for b in range(adm.shape[1]):
            want = latency_percentiles(ah[:, b], sh[:, b], 1e-3)
            got = (float(p50[b]), float(p99[b]))
            assert np.array_equal(np.asarray(got), np.asarray(want),
                                  equal_nan=True), (dtype, b, got, want)


# the fault paths on the card against the CPU: every ledger within this
# relative gap (the float64 engine's card-vs-CPU difference is ~1e-16)
FAULT_RTOL = 1e-15


def _fault_case_platform():
    from repro_torch.core.perfmodel import AccelWorkload, SoCPerfModel
    from repro_torch.sim import SimPlatform
    pos = [(r, c) for r in range(4) for c in range(4)
           if (r, c) not in {(1, 0), (0, 0), (0, 3)}][:6]
    return SimPlatform.build(
        SoCPerfModel(), [AccelWorkload("dfmul", 8.70, 1.1, replication=8)
                         for _ in pos], pos,
        names=("a0", "a1", "a2", "b0", "b1", "b2"), n_tg=2, req_mb=0.005)


def card_fault_run(on_kill):
    """tests/test_torch_sim_faults.py's card case: kills (one revived), a
    degraded link, a stuck rate, a 30 ms deadline and an even balancer
    through the sequential engine on the card against the CPU (ledgers
    within FAULT_RTOL, p50 / p99 / events exact), with no sync in its
    open-loop tick loop; the B = 1 batched run on the card bit for bit the
    sequential one (incl. ``retry_q`` and ``queue_drops``); two designs in
    float64 on the card against the CPU, and in float32 on the card
    against them at the reference's float32 limits (rtol 1e-3; ledgers
    atol 1e-2, drop rate atol 1e-4, p99 atol dt)."""
    from repro_torch.sim import (BatchSimEngine, BatchSimPlatform,
                                 FaultSchedule, LoadBalancer, SimConfig,
                                 SimEngine, SLOConfig, diurnal_trace)
    plat = _fault_case_platform()
    names = plat.names
    sched = (FaultSchedule().kill_tile("a1", start=150, end=380)
             .kill_tile("b2", start=300)
             .degrade_link((1, 1), (1, 2), 0.3, start=100, end=500)
             .stick_island("b0", start=50, end=250, rate=0.4))
    slo = SLOConfig(deadline_s=0.03, on_kill=on_kill,
                    max_retries=int(on_kill == "respill"))
    cap = SimEngine(plat, device="cpu").capacity_rps()
    tr = diurnal_trace(cap * 0.85, 600, 6, dt=1e-3, depth=0.5, seed=4)
    cfg = SimConfig(telemetry_interval=20, telemetry_capacity=64)

    def bal():
        return LoadBalancer((names[:3], names[3:]), names, mode="even")

    def seq(device):
        eng = SimEngine(plat, config=cfg, faults=sched, slo=slo,
                        balancer=bal(), device=device)
        return eng, eng.run(tr)

    with SyncCount(strict=True) as syncs:
        e_card, card = seq(DEV)
    assert syncs.loops == 1 and syncs.in_ticks == 0, syncs.in_ticks
    _, host = seq("cpu")
    gap = seq_gap(card, host)
    assert gap["max_rel"] <= FAULT_RTOL and seq_gap_ok(gap), gap
    assert card.dropped_slo > 0.0
    bp = BatchSimPlatform.stack([plat])
    b_eng = BatchSimEngine(bp, config=cfg, faults=sched, slo=slo,
                           balancer=bal(), device=DEV)
    bat = b_eng.run(tr)
    for f in ("energy_j", "completed", "residual", "p50_latency_s",
              "p99_latency_s", "dropped_slo", "dropped_fault", "retried"):
        assert getattr(bat, f)[0] == getattr(card, f), f
    for f in ("queue", "retry_q", "busy"):
        assert torch.equal(getattr(b_eng.last_state, f)[0],
                           getattr(e_card.last_state, f)), f
    for k, v in e_card.last_fault_histories.items():
        assert torch.equal(b_eng.last_fault_histories[k][:, 0], v), k
    two = BatchSimPlatform.stack([plat, plat])

    def pair(device, dtype=torch.float64):
        return BatchSimEngine(two, config=cfg, faults=sched, slo=slo,
                              balancer=bal(), device=device,
                              dtype=dtype).run(tr)

    a, b = pair(DEV), pair("cpu")
    for f in ("energy_j", "completed", "dropped_slo", "dropped_fault",
              "retried"):
        x, y = getattr(a, f), getattr(b, f)
        assert np.all(np.abs(x - y) <= FAULT_RTOL * np.abs(y)), f
    for f in ("p50_latency_s", "p99_latency_s", "drop_rate"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    f32 = pair(DEV, torch.float32)
    assert f32.telemetry is None
    assert np.allclose(f32.completed, b.completed, rtol=1e-3, atol=0.0)
    assert np.allclose(f32.energy_j, b.energy_j, rtol=1e-3, atol=0.0)
    for f in ("dropped_slo", "dropped_fault", "retried"):
        assert np.allclose(getattr(f32, f), getattr(b, f), rtol=1e-3,
                           atol=1e-2), f
    assert np.allclose(f32.drop_rate, b.drop_rate, rtol=1e-3, atol=1e-4)
    assert np.allclose(f32.p99_latency_s, b.p99_latency_s, rtol=1e-3,
                       atol=tr.dt)


def card_supervisor_run(dfs):
    """tests/test_torch_sim_faults.py's card case: the online detector in
    the loop (be1 of the 3+3 pipeline killed on ticks [400, 900), 50 ms
    deadline, even balancer, membound DFS or none) on the card against
    the CPU: the same supervisor events and detection tick, ledgers within
    FAULT_RTOL; no sync in the tick loop without a controller, exactly
    one per control tick with one."""
    from functools import partial
    from repro_torch.core.dfs import policy_memory_bound
    from repro_torch.runtime.fault import SimFaultConfig, SimFaultSupervisor
    from repro_torch.sim import (ControllerHarness, FaultSchedule,
                                 LoadBalancer, SimConfig, SimEngine,
                                 SLOConfig)
    ex = closed_loop_example()
    plat = ex.pipeline_platform()
    tr = ex.surge_trace(plat, 1200, device="cpu")

    def run(device):
        sup = SimFaultSupervisor(SimFaultConfig(dead_ticks=3))
        ctl = (ControllerHarness(
            plat.islands, partial(policy_memory_bound, threshold=0.55,
                                  low_rate=0.5), queue_guard_ticks=3.0)
            if dfs else None)
        eng = SimEngine(
            plat, config=SimConfig(telemetry_interval=50,
                                   control_interval=CLOSED_LOOP_CI),
            controller=ctl, supervisor=sup,
            faults=FaultSchedule().kill_tile("be1", start=400, end=900),
            slo=SLOConfig(deadline_s=0.05),
            balancer=LoadBalancer((ex.STAGE0, ex.STAGE1), plat.names,
                                  mode="even"), device=device)
        return eng.run(tr), sup

    with SyncCount(strict=not dfs) as syncs:
        card, sup_card = run(DEV)
    want = tr.ticks // CLOSED_LOOP_CI if dfs else 0
    assert syncs.loops == 1 and syncs.in_ticks == want, syncs.in_ticks
    host, sup_host = run("cpu")
    assert sup_card.events == sup_host.events and sup_card.events
    assert ex.detection_tick(sup_card) == ex.detection_tick(sup_host)
    assert np.array_equal(sup_card.believed_alive, sup_host.believed_alive)
    gap = seq_gap(card, host)
    assert gap["max_rel"] <= FAULT_RTOL and seq_gap_ok(gap), gap


def card_observe(case):
    """tests/test_torch_observe.py's card case: an observed run on the card
    against the unobserved card run (bit for bit) and against the same
    observed run on the CPU (plane within PLANE_RTOL, stall counts exact;
    the trace's JSONL equal).  ``sequential``: four tiles at 1.2x capacity,
    a balancer, PID + guard, a 4 ms deadline (SLO spans, splits, guards in
    the trace); ``faults``: a kill, a degraded link, a stuck island and
    the online supervisor, open loop, no sync in the tick loop (sync-debug
    "error"); ``batch64``: three designs, PID and a kill, float64;
    ``batch32``: the same in float32, its plane within the float32
    tolerance of the CPU's float64 plane, stall counts exact."""
    from repro_torch.core.dfs import BatchPIDRatePolicy, PIDRatePolicy
    from repro_torch.runtime.fault import SimFaultSupervisor
    from repro_torch.sim import (BatchControllerHarness, BatchSimEngine,
                                 BatchSimPlatform, ControllerHarness,
                                 FaultSchedule, LoadBalancer, SimConfig,
                                 SimEngine, SLOConfig, constant_trace)
    plat = _tick_platform(2)
    names = plat.names
    cap = SimEngine(plat, device="cpu").capacity_rps()
    tr = constant_trace(cap * 1.2, 300, 4, dt=1e-3)
    cfg = SimConfig(telemetry_interval=7, control_interval=10)
    kill = (FaultSchedule().kill_tile(names[1], start=100, end=200)
            .degrade_link((1, 1), (1, 2), 0.4, start=50)
            .stick_island(names[3], start=30, end=150, rate=0.4))

    def run(device, level, dtype=torch.float64):
        if case in ("sequential", "faults"):
            kw = dict(balancer=LoadBalancer([names[:2]], names),
                      slo=SLOConfig(deadline_s=0.004))
            if case == "faults":
                kw.update(faults=kill, supervisor=SimFaultSupervisor())
            else:
                kw["controller"] = ControllerHarness(
                    plat.islands, PIDRatePolicy(target=0.7),
                    queue_guard_ticks=3.0)
            eng = SimEngine(plat, config=cfg, observe=level, device=device,
                            **kw)
        else:
            bp = BatchSimPlatform.stack([_tick_platform(k)
                                         for k in (2, 4, 8)])
            eng = BatchSimEngine(
                bp, config=cfg, observe=level, device=device, dtype=dtype,
                faults=FaultSchedule().kill_tile(names[2], start=80,
                                                 end=200),
                slo=SLOConfig(deadline_s=0.05, on_kill="respill",
                              max_retries=1),
                controller=BatchControllerHarness(
                    bp.islands, bp.rates, BatchPIDRatePolicy(target=0.7),
                    tile_names=bp.names, queue_guard_ticks=3.0))
        return eng, eng.run(tr)

    dtype = torch.float32 if case == "batch32" else torch.float64
    level = "counters" if case == "batch32" else "full"
    with SyncCount(strict=case == "faults") as syncs:
        card, r_card = run(DEV, level, dtype)
    assert syncs.loops == 1, syncs.loops
    _, r_off = run(DEV, None, dtype)
    assert results_equal(r_card, r_off)
    host, _ = run("cpu", level if case != "batch32" else "counters")
    if case == "batch32":
        h64, _ = run("cpu", "counters")
        gap = f32_plane_ratio(card.observer.counters, h64.observer.counters)
        assert gap["max_ratio"] <= 1.0 and gap["stall_equal"], gap
        return
    gap = plane_gap(card.observer.counters, host.observer.counters)
    assert plane_ok(gap), gap
    assert card.observer.trace.to_jsonl() == host.observer.trace.to_jsonl()
    assert len(card.observer.trace) > 2


# rows, E, K, N, seed (test_torch_moe GROUPED_CASES): granite's one-token
# (8 rows over 32 experts: 24 empty groups), 4-slot decode and 4,608-token
# prefill rows against its gate/up weights, a reduced shape, its down
# product's K and N
CARD_GROUPED = ((8, 32, 1024, 512, 0), (32, 32, 1024, 512, 1),
                (36864, 32, 1024, 512, 2), (40, 4, 64, 64, 3),
                (64, 32, 512, 1024, 4))


def card_grouped_matmul(rows, E, K, N, seed):
    """``grouped_matmul`` on CUDA bf16 rows sorted by expert (ids drawn
    uniformly, so some groups may be empty) runs ``torch._grouped_mm`` and
    agrees with the per-expert loop (``grouped_check``)."""
    from repro_torch.models import moe as MoE
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, E, size=rows))
    offs = torch.from_numpy(np.cumsum(np.bincount(ids, minlength=E)).astype(
        np.int32)).to(DEV)
    xs = _on_card(rng.standard_normal((rows, K)), "bfloat16")
    w = _on_card(rng.standard_normal((E, K, N)) / np.sqrt(K), "bfloat16")
    out = MoE.grouped_matmul(xs, w, offs)
    sync()
    assert MoE.grouped_matmul.last_variant == "grouped_mm", \
        MoE.grouped_matmul.last_variant
    res = grouped_check(out, MoE.grouped_matmul_plain(xs, w, offs))
    assert res["ok"], f"grouped product off its loop: {res}"


# ---------------------------------------------------------------------------
# the training path: the kernels under autograd, three models at full width
# ---------------------------------------------------------------------------

# a model's training run: train_4k's length, global batch 256 cut to 4 (two
# microbatches of 2), AdamW at launch/train.py's lr with a warm-up of 2
TRAIN = {"arch": "h2o-danube-1.8b", "seq_len": 4096, "global_batch": 4,
         "accum": 2, "steps": 6, "lr": 6e-4, "warmup": 2,
         "path": ("flash_attention", "fused_mlp")}
TRAIN_MOE = {**TRAIN, "arch": "granite-moe-1b-a400m",
             "path": ("flash_attention",)}
TRAIN_SSM = {**TRAIN, "arch": "mamba2-370m", "path": ("ssd_scan",)}
# the device kernel each must run in training (bf16 hd 80 / 64, f32 SSD)
TRAIN_VARIANT = {"flash_attention": "wgmma_tma", "fused_mlp": "wgmma_tma",
                 "ssd_scan": "tf32x3"}
TRAIN_LOSS_ATOL = 5e-2          # step 1's loss, kernel path vs plain path
TRAIN_GNORM_RTOL = LOGIT_REL_TOL    # step 1's grad_norm, relative
TRAIN_GRAD_RTOL = LOGIT_REL_TOL     # step 1's gradient, ||g - g_plain||
                                    # / ||g_plain|| (direction included)
TRAIN_RESUME_RTOL = 1e-5        # a resumed run's losses vs uninterrupted
# a run whose step 1 starts above the uniform guess (log V) must fall below
# step 1 by step 6; one that starts at it (danube) cannot show learning on
# six fresh batches of this stream, and its gate is step 1's gradient
# against the plain path's
UNIFORM_MARGIN = 0.1
# after the counted steps, the trainer's first AdamW step from zero moments
# is checked on the run's first microbatch (``fit_one_batch``), from the
# weights where the run ended: g the NLL's gradient there, u the step the
# trainer applied (its new parameters less theta).  Its premise holds by
# construction: a first AdamW step from zero moments moves each coordinate
# against the sign of its gradient (m-hat = g, v-hat = g^2: -lr sign(g),
# the decay lr wd theta aside), and the cast to bf16 keeps that sign where
# it does not round the move away, so each leaf's g.u is about
# -sum |g_i u_i|; and by Taylor's theorem a small enough multiple of any
# descent direction lowers the loss by at least half its first-order
# prediction.  So (a) every leaf must have g.u <= -LEAF_DESCENT sum
# |g_i u_i| (a reversed step, or one leaf's update written into another's,
# fails it), (b) g.u < 0 over the whole tree (a zero step fails it), and
# (c) for some s of ARMIJO_SCALES the NLL at theta + s u, cast to the
# parameters' dtype as the trainer casts (delta the real displacement),
# must fall by ARMIJO_C |g.delta| at least.  The scales run
# from the step itself down to where the line is linear and its drop above
# the bf16 loss's own noise: on granite-moe at full width (six end states,
# examples/torch_fit_study.py) the NLL rises at every s >= 1/64 and falls
# by 1.0x its prediction, 0.0084-0.0100 nats, at 1/1024, where theta - s u
# rises as much; below 1/4096 the prediction (< 6e-4) is under the noise
# (2-5e-4 nats either way), so no smaller s is taken
ARMIJO_SCALES = (1.0, 1 / 4, 1 / 16, 1 / 64, 1 / 256, 1 / 1024)
ARMIJO_C = 0.5
LEAF_DESCENT = 0.5
# the Functions of kernels.ops by the kernels' names in the kernels line
TRAIN_FUNCTIONS = {"flash_attention": "flash_attention",
                   "fused_mlp": "fused_rmsnorm_mlp", "ssd_scan": "ssd_scan"}

# (Function, dtype name, shape): a reduced case of each kernel under
# autograd, the bf16 ones at shapes its Hopper variant takes
TRAIN_KERNEL_CASES = (
    ("flash_attention", "bfloat16", (2, 256, 2, 2, 80, 128)),
    ("flash_attention", "float32", (1, 128, 2, 2, 64, 0)),
    ("fused_rmsnorm_mlp", "bfloat16", (256, 256, 384, "silu")),
    ("fused_rmsnorm_mlp", "float32", (64, 128, 96, "gelu")),
    ("ssd_scan", "float32", (2, 512, 4, 64, 128, 256)),
)
# the forward's tolerances (float32: absolute, scaled by the tensor's
# largest |value| where that exceeds 1; bfloat16: per row of the last dim)
TRAIN_ATOL = {"flash_attention": 2e-5, "fused_rmsnorm_mlp": 2e-5,
              "ssd_scan": SSD_TOL}
TRAIN_ROW_RTOL = LLM_ROW_RTOL[torch.bfloat16]


def train_path_cases():
    """(Function, dtype, shape) at the shapes the training phases give each
    Function: one microbatch (``global_batch // accum`` sequences of
    ``seq_len`` tokens) of danube's attention and MLP, granite-moe's
    attention and mamba2's scan, from their configs."""
    from repro_torch.configs import get_config
    B = TRAIN["global_batch"] // TRAIN["accum"]
    S = TRAIN["seq_len"]
    dn, gr, mb = (get_config(s["arch"]) for s in (TRAIN, TRAIN_MOE,
                                                   TRAIN_SSM))
    cases = [("flash_attention", "bfloat16",
              (B, S, c.n_kv_heads, c.n_heads // c.n_kv_heads, c.head_dim,
               c.sliding_window)) for c in (dn, gr)]
    cases.append(("fused_rmsnorm_mlp", "bfloat16",
                  (B * S, dn.d_model, dn.d_ff, dn.act)))
    cases.append(("ssd_scan", "float32",
                  (B, S, mb.n_ssm_heads, mb.ssm_headdim, mb.ssm_state,
                   mb.ssm_chunk)))
    return cases


def train_kernel_case(name, dtype, shape, device, seed=0):
    """Inputs of one case: (differentiable inputs, the rest of the
    arguments, the output gradients' shapes come from the forward)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    dt = getattr(torch, dtype)

    def rnd(*s, scale=1.0):
        return (torch.randn(s, generator=gen) * scale).to(device=device,
                                                          dtype=dt)
    if name == "flash_attention":
        B, S, KV, G, hd, window = shape
        pos = torch.arange(S, dtype=torch.int32, device=device).expand(B, S)
        return ((rnd(B, S, KV, G, hd), rnd(B, S, KV, hd), rnd(B, S, KV, hd)),
                (pos, pos, window, 1.0 / hd ** 0.5))
    if name == "fused_rmsnorm_mlp":
        N, d, F, act = shape
        return ((rnd(N, d), rnd(d, scale=0.1), rnd(d, F, scale=d ** -0.5),
                 rnd(d, F, scale=d ** -0.5)), (act, 1e-5))
    B, L, nh, hd, st, chunk = shape
    f32 = dict(device=device, dtype=torch.float32)
    dtv = torch.nn.functional.softplus(
        torch.randn((B, L, nh), generator=gen) - 1.0).to(**f32)
    A = -torch.exp(torch.randn((nh,), generator=gen) * 0.5).to(**f32)
    return ((rnd(B, L, nh, hd), dtv, A, rnd(B, L, st, scale=0.3),
             rnd(B, L, st, scale=0.3), torch.ones(nh, **f32)), (chunk,))


def _train_fns(name):
    """(ops function, plain version, raw kernel wrapper, its launch)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_mlp as FM
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as SS
    return {"flash_attention": (ops.flash_attention, FA.flash_attention_plain,
                                FA.flash_attention, FA._launch),
            "fused_rmsnorm_mlp": (ops.fused_rmsnorm_mlp,
                                  FM.fused_rmsnorm_mlp_plain,
                                  FM.fused_rmsnorm_mlp, FM._launch),
            "ssd_scan": (ops.ssd_scan, SS.ssd_scan_plain, SS.ssd_scan,
                         SS._launch)}[name]


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def grad_check(name, got, ref):
    """A gradient (or forward output) against the plain version's: float32
    within ``TRAIN_ATOL`` times max(1, max |ref|); bfloat16 within
    ``TRAIN_ROW_RTOL`` of each row's largest |value|."""
    if ref.dtype == torch.bfloat16:
        err, tol = row_rel_err(got, ref), TRAIN_ROW_RTOL
    else:
        scale = max(1.0, float(ref.abs().max())) if ref.numel() else 1.0
        err, tol = _err(got, ref) / scale, TRAIN_ATOL[name]
    ok = (tuple(got.shape) == tuple(ref.shape)
          and bool(torch.isfinite(got.float()).all()) and err <= tol)
    return {"err": err, "tol": tol, "ok": ok}


def train_kernel_check(name, dtype, shape, device=DEV, seed=0):
    """One Function of ``kernels.ops`` on one case: the forward equals the
    raw kernel's output (on the card; the plain version's on the CPU) and
    launches once; the gradient of every differentiable input (random
    output gradients) agrees with autograd through the plain version; the
    backward ran once."""
    from repro_torch.kernels import ops
    fn, plain, wrapper, launch = _train_fns(name)
    Fn = ops.FUNCTIONS[name]
    diff, rest = train_kernel_case(name, dtype, shape, device, seed)
    card = torch.device(device).type == "cuda"
    leaves = [t.clone().requires_grad_(True) for t in diff]
    n0, b0 = wrapper.launches, Fn.backward_calls
    outs = _as_tuple(fn(*leaves, *rest))
    launched = wrapper.launches - n0
    raw = _as_tuple(launch(*diff, *rest) if card else plain(*diff, *rest))
    gen = torch.Generator(device="cpu").manual_seed(seed + 1)
    gouts = [torch.randn(o.shape, generator=gen).to(o) for o in outs]
    grads = torch.autograd.grad(outs, leaves, gouts)
    ref_leaves = [t.clone().requires_grad_(True) for t in diff]
    ref_outs = _as_tuple(plain(*ref_leaves, *rest))
    ref_grads = torch.autograd.grad(ref_outs, ref_leaves, gouts)
    checks = {"forward_vs_plain": [grad_check(name, o.detach(), r.detach())
                                   for o, r in zip(outs, ref_outs)],
              "grads": [grad_check(name, g, r)
                        for g, r in zip(grads, ref_grads)]}
    res = {"case": [name, dtype, list(shape)],
           "forward_equals_kernel": all(torch.equal(o.detach(), r)
                                        for o, r in zip(outs, raw)),
           "launches": launched, "backward_calls": Fn.backward_calls - b0,
           "variant": getattr(wrapper, "last_variant", None) if card
           else None,
           "max_grad_err": max(c["err"] for c in checks["grads"]),
           "max_forward_err": max(c["err"]
                                  for c in checks["forward_vs_plain"])}
    res["ok"] = (res["forward_equals_kernel"]
                 and res["launches"] == (1 if card else 0)
                 and res["backward_calls"] == 1
                 and all(c["ok"] for v in checks.values() for c in v))
    return res


def train_kernel_faults(device=DEV):
    """What ``train_kernel_check`` must reject: an attention backward that
    zeroes ``dk``, and (on the card) a forward that returns the plain
    output without a launch.  Returns {fault: rejected}."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import flash_attention as FA
    case = TRAIN_KERNEL_CASES[0]
    F = ops.FlashAttention
    orig_bwd, orig_fwd = F.backward, F.forward
    out = {}

    def zero_dk(ctx, g):
        dq, dk, dv, *rest = orig_bwd(ctx, g)
        return (dq, torch.zeros_like(dk), dv, *rest)

    def plain_fwd(ctx, q, k, v, qpos, kpos, window, scale):
        ctx.save_for_backward(q, k, v, qpos, kpos)
        ctx.window, ctx.scale = window, scale
        return FA.flash_attention_plain(q, k, v, qpos, kpos, window, scale)

    faults = {"backward_zeroes_dk": ("backward", zero_dk)}
    if torch.device(device).type == "cuda":
        faults["forward_without_launch"] = ("forward", plain_fwd)
    for label, (attr, bad) in faults.items():
        setattr(F, attr, staticmethod(bad))
        try:
            out[label] = not train_kernel_check(*case, device=device)["ok"]
        finally:
            F.backward = staticmethod(orig_bwd)
            F.forward = staticmethod(orig_fwd)
    return out


def raw_wrappers_refuse_grad(device=DEV):
    """Each raw kernel wrapper given a CUDA input that requires grad must
    raise (its output would carry no gradient).  {wrapper: raised}."""
    out = {}
    for name, dtype, shape in TRAIN_KERNEL_CASES[::2]:
        _, _, wrapper, _ = _train_fns(name)
        diff, rest = train_kernel_case(name, dtype, shape, device)
        diff = (diff[0].requires_grad_(True),) + diff[1:]
        try:
            wrapper(*diff, *rest)
            out[name] = False
        except RuntimeError as e:
            out[name] = "kernels.ops" in str(e)
    return out


def grouped_grad_check(rows=65536, E=32, d=1024, f=512, seed=0):
    """``grouped_matmul``'s gradients (``torch._grouped_mm`` and its
    backward) against the per-expert loop's, at a granite training
    microbatch's rows (2 x 4,096 tokens x top 8): the gate product (d -> f)
    and the down product (f -> d), rows routed by a random router; each
    gradient held as ``grouped_check`` holds a product, and the check must
    reject one expert's rows of ``dxs`` zeroed."""
    from repro_torch.models import moe as MoE
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((rows // 8, d), generator=gen).to(DEV, torch.bfloat16)
    router = (torch.randn((d, E), generator=gen) * 0.02).to(DEV)
    _, ids, _ = MoE._route(router, x, 8)
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    offsets = MoE.group_offsets(flat, E)
    out = {"rows": rows, "experts": E}
    for label, (K, N) in (("gate", (d, f)), ("down", (f, d))):
        xs = (x.index_select(0, order // 8) if K == d else
              torch.randn((rows, K), generator=gen).to(DEV, torch.bfloat16))
        w = (torch.randn((E, K, N), generator=gen) / K ** 0.5).to(
            DEV, torch.bfloat16)
        g = torch.randn((rows, N), generator=gen).to(DEV, torch.bfloat16)
        a = [t.clone().requires_grad_(True) for t in (xs, w)]
        y = MoE.grouped_matmul(*a, offsets)
        variant = MoE.grouped_matmul.last_variant
        dx, dw = torch.autograd.grad(y, a, g)
        b = [t.clone().requires_grad_(True) for t in (xs, w)]
        rx, rw = torch.autograd.grad(
            MoE.grouped_matmul_plain(*b, offsets), b, g)
        cx, cw = grouped_check(dx, rx), grouped_check(dw, rw)
        sizes = torch.diff(offsets, prepend=offsets.new_zeros(1))
        e = int(torch.argmax(sizes))
        lo = int(offsets[e - 1]) if e else 0
        bad = dx.clone()
        bad[lo:int(offsets[e])] = 0
        out[label] = {"variant": variant,
                      "dxs": {k: cx[k] for k in ("max_abs_err", "rel_err")},
                      "dw": {k: cw[k] for k in ("max_abs_err", "rel_err")},
                      "ok": cx["ok"] and cw["ok"],
                      "expert_rows_zeroed_rejected":
                          not grouped_check(bad, rx)["ok"]}
    return out


# the training run each train_path_cases() entry belongs to, in order
TRAIN_PATH_RUNS = ("train", "train_moe", "train", "train_ssm")


def backward_work(name, shape):
    """(products, other operations) that a Function's backward must do at a
    path case, from its inputs and the output gradients alone, counting the
    live (unmasked) pairs only.  flash_attention: five products a live pair
    and head, 2 hd each (the scores again, dP = dO V^T, dV, dQ, dK; D =
    rowsum(P dP) needs no O), the softmax's elementwise work not counted.
    fused_rmsnorm_mlp: six products of 2 N d F (the gate and up products
    again, then two for dx and two for the weights), the norm and the
    activation not counted.  ssd_scan: each forward product of
    ``ssd_bound`` (C B^T, att @ x, C @ h_in, the state update) twice, one
    gradient per operand, plus C B^T and the chunk states again; six
    operations a live pair and head besides (the decay-weighted product
    rebuilt, 3, and its gradient to C B^T, the decay and dt, 3)."""
    if name == "flash_attention":
        B, S, KV, G, hd, window = shape
        w = window if 0 < window < S else S
        pairs = w * (w + 1) / 2.0 + (S - w) * w       # i - w < j <= i
        return 5.0 * 2.0 * B * KV * G * hd * pairs, 0.0
    if name == "fused_rmsnorm_mlp":
        N, d, F, _ = shape
        return 6.0 * 2.0 * N * d * F, 0.0
    B, L, nh, hd, st, chunk = shape
    Q = min(chunk, L)
    nc = L // Q
    pairs = Q * (Q + 1) / 2.0
    cb = 2.0 * B * nc * pairs * st
    att_x = 2.0 * B * nh * nc * pairs * hd
    c_h = state = 2.0 * B * L * nh * st * hd
    return (3.0 * cb + 2.0 * att_x + 2.0 * c_h + 3.0 * state,
            6.0 * B * nh * nc * pairs)


def backward_bound(name, dtype, shape):
    """The least time of a Function's backward at a case: the work it must
    do (``backward_work``) against the bytes it must move (its inputs and
    the output gradients read once, the input gradients written once) over
    HBM, whichever is larger.  bf16 products at 989.4 TFLOP/s; float32
    (``ssd_scan``) the lesser of its products on TF32 tensor cores in three
    passes with the rest at 67 TFLOP/s (``backward_bound_tc_ms``) and all
    of it at 67 (``backward_bound_f32_ms``), as its forward row.  Beside it
    the FLOPs of what the Function's backward runs (the oracle's forward
    again and its gradients over every pair), counted by
    ``launch.costing`` on meta inputs (``oracle_backward_*``)."""
    from repro_torch.launch.costing import flops_of_fn
    fn = _train_fns(name)[0]
    diff, rest = train_kernel_case(name, dtype, shape, "meta")
    n = len(diff)

    def forward(*a):
        return _as_tuple(fn(*a))

    def forward_backward(*a):
        leaves = [t.requires_grad_(True) for t in a[:n]]
        outs = forward(*leaves, *a[n:])
        return torch.autograd.grad(outs, leaves,
                                   [torch.ones_like(o) for o in outs])
    both = flops_of_fn(forward_backward, *diff, *rest)
    fwd = flops_of_fn(forward, *diff, *rest)
    if name == "ssd_scan":               # y like xs, and the final state
        B, L, nh, hd, st, _ = shape
        out_bytes = _nbytes(diff[0]) + 4.0 * B * nh * st * hd
    elif name == "fused_rmsnorm_mlp":
        out_bytes = float(diff[0].shape[0] * diff[2].shape[1]
                          * diff[0].element_size())
    else:
        out_bytes = _nbytes(diff[0])     # hd_v == hd_qk on the path
    byts = 2.0 * _nbytes(*diff) + out_bytes
    prod, other = backward_work(name, shape)
    res = {"backward_flops": prod + other, "backward_dot_flops": prod,
           "backward_bytes": byts,
           "oracle_backward_flops": both.total - fwd.total,
           "oracle_backward_dot_flops": both.dot - fwd.dot}
    if dtype == "bfloat16":
        ms, by = _bound(byts, prod + other, H100_BF16_PER_S)
    else:
        t_bytes = byts / H100_BYTES_PER_S * 1e3
        t_tc = (3.0 * prod / H100_TF32_PER_S + other / H100_FP32_PER_S) * 1e3
        t_f32 = (prod + other) / H100_FP32_PER_S * 1e3
        tc, f32 = max(t_bytes, t_tc), max(t_bytes, t_f32)
        res.update(backward_bound_tc_ms=tc, backward_bound_f32_ms=f32)
        ms = min(tc, f32)
        by = "bytes" if t_bytes >= min(t_tc, t_f32) else "operations"
    res.update(backward_bound_ms=ms, backward_bound_by=by)
    return res


def sdpa_backward_ms(shape, reps=None):
    """SDPA's backward at a training attention case, the library yardstick
    of the attention Function's backward: q (B,S,KV,G,hd) as (B, KV G, S,
    hd) bf16, GQA through ``enable_gqa``, causal (a window of S or more is
    the causal mask).  The backward's graph time is a forward with its
    ``torch.autograd.grad`` captured together (the backward runs on its
    forward's stream, so it cannot be captured alone) less the forward
    captured alone (``graph_ms`` both); ``eager_ms`` is the backward alone
    under CUDA events (``cuda_ms``: host gaps between its launches
    included)."""
    import torch.nn.functional as F
    reps = reps or SERVE["reps"]
    B, S, KV, G, hd, window = shape
    assert window == 0 or window >= S, shape
    gen = torch.Generator(device="cpu").manual_seed(0)

    def rnd(*sh):
        return torch.randn(sh, generator=gen).to(
            DEV, torch.bfloat16).requires_grad_(True)
    q, k, v = rnd(B, KV * G, S, hd), rnd(B, KV, S, hd), rnd(B, KV, S, hd)
    g = torch.randn((B, KV * G, S, hd), generator=gen).to(DEV,
                                                          torch.bfloat16)

    def forward():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              scale=hd ** -0.5,
                                              enable_gqa=True)

    def forward_backward():
        return torch.autograd.grad(forward(), (q, k, v), g)
    fb, f = graph_ms(forward_backward, reps), graph_ms(forward, reps)
    out = forward()
    eager = cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), g,
                                                retain_graph=True), reps)
    res = {"shape_q": [B, KV * G, S, hd], "kv_heads": KV, "causal": True,
           "ms": fb - f, "forward_ms": f, "forward_backward_ms": fb,
           "eager_ms": eager}
    del out, g, q, k, v
    torch.cuda.empty_cache()
    return res


def phase_train_kernels():
    """Each Function of ``kernels.ops`` on its reduced cases (bf16 and f32)
    and at the training path's own shapes (``train_path_cases``, each with
    its backward's bound, ``backward_bound``, and for attention SDPA's
    backward, ``sdpa_backward_ms``), the planted faults, the raw wrappers'
    refusal, and the grouped products' gradients at granite's rows."""
    cases = [train_kernel_check(*c) for c in TRAIN_KERNEL_CASES]
    t0 = time.perf_counter()
    for c, run in zip(train_path_cases(), TRAIN_PATH_RUNS):
        cases.append({**train_kernel_check(*c), "run": run,
                      **backward_bound(*c)})
        torch.cuda.empty_cache()
        if c[0] == "flash_attention":
            cases[-1]["sdpa_backward"] = sdpa_backward_ms(c[2])
    path_s = time.perf_counter() - t0
    faults = train_kernel_faults()
    refused = raw_wrappers_refuse_grad()
    grouped = grouped_grad_check()
    report = {"phase": "train_kernels", "cases": cases,
              "path_cases_s": path_s, "planted_faults_rejected": faults,
              "raw_wrappers_refuse_grad": refused, "grouped_mm": grouped}
    emit(report)
    bad = [c["case"] for c in cases if not c["ok"]]
    if bad or not all(faults.values()) or not all(refused.values()) or \
            not all(grouped[k]["ok"] and grouped[k]
                    ["expert_rows_zeroed_rejected"] for k in ("gate",
                                                              "down")):
        raise SystemExit(f"train_kernels: a check failed or a planted "
                         f"fault passed (cases {bad})")
    if any(grouped[k]["variant"] != "grouped_mm" for k in ("gate", "down")):
        raise SystemExit("train_kernels: the grouped products did not run "
                         "torch._grouped_mm")
    return report


def _raw_device_times(prof, suffix):
    """From the profiler's raw events (no parse into an event tree, which
    takes over a minute at ~90,000 kernels): every device activity
    (kernels, copies, fills) as (name, ns), and the kernels inside each
    ``<name><suffix>`` range, by range name, with the count of host-side
    ranges.  A kernel belongs to the range whose device-side span (a
    user annotation on the device) holds its start (one stream: a range's
    kernels run in a row)."""
    import bisect
    evs = prof.profiler.kineto_results.events()
    device, spans, calls = [], [], {}
    for e in evs:
        on_device = str(e.device_type()).endswith("CUDA")
        if not e.is_user_annotation():
            if on_device:
                device.append((e.start_ns(), e.duration_ns(), e.name()))
        elif e.name().endswith(suffix):
            if on_device:
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                              e.name()))
            else:
                calls[e.name()] = calls.get(e.name(), 0) + 1
    device.sort()
    starts = [d[0] for d in device]
    ranged = {}
    for lo, hi, name in spans:
        i, j = bisect.bisect_left(starts, lo), bisect.bisect_right(starts, hi)
        ranged[name] = ranged.get(name, 0.0) + sum(
            d[1] for d in device[i:j]) / 1e6
    return [(n, dur) for _, dur, n in device], ranged, calls


def profile_train_step(tr):
    """One more training step under ``torch.profiler``: wall ms, device ms
    by kernel group, the device's idle share, and each Function's backward
    (the kernels inside its ``<name>.backward`` range) per call beside its
    forward kernel per launch."""
    from torch.profiler import ProfilerActivity, profile
    K = all_kernels()
    n0 = {n: f.launches for n, f in K.items()}
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.run(1)
        sync()
        wall = time.perf_counter() - t0
    launched = {n: f.launches - n0[n] for n, f in K.items()}
    t_post = time.perf_counter()
    device, bwd_ms, bwd_calls = _raw_device_times(prof, ".backward")
    groups = {}
    for name, ns in device:
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + ns / 1e6
    kernels = len(device)
    device_ms = sum(groups.values())
    per_fn = {}
    for n, fname in TRAIN_FUNCTIONS.items():
        r = f"{fname}.backward"
        if launched[n] or bwd_calls.get(r):
            per_fn[n] = {
                "forward_ms_per_launch": groups.get(n, 0.0)
                / max(launched[n], 1),
                "launches": launched[n],
                "backward_ms_per_call": bwd_ms.get(r, 0.0)
                / max(bwd_calls.get(r, 0), 1),
                "backward_calls": bwd_calls.get(r, 0),
                "backward_ms": bwd_ms.get(r, 0.0)}
    return {"wall_ms": wall * 1e3, "device_ms": device_ms,
            "device_kernels": kernels,
            "idle_share": 1.0 - device_ms / (wall * 1e3),
            "postprocess_s": time.perf_counter() - t_post,
            "device_ms_by_group": dict(sorted(groups.items(),
                                              key=lambda kv: -kv[1])),
            "functions": per_fn}


def drive_train(spec, lm_kwargs, plain_kwargs, phase):
    """A model's training path through ``Trainer`` on the card at full
    width and depth (random bf16 weights from a seed): first the plain
    path's step 1 on the same weights and batch (its update discarded),
    then ``spec["steps"]`` steps through the kernels, every count set to 0
    just before and read just after, each step timed (device synchronised
    around it) and its host syncs counted (``SyncCount``; the batch's copy
    happens before it), step 1's gradients (as AdamW receives them) held
    against the plain path's as vectors; then one step under the
    profiler."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import LM
    from repro_torch.optim import adamw
    import repro_torch.runtime.train as RTM
    from repro_torch.runtime.train import TrainConfig, Trainer, step_grads
    K = all_kernels()
    cfg = get_config(spec["arch"])
    shape = ShapeConfig("train_4k", spec["seq_len"], spec["global_batch"],
                        "train")
    tc = TrainConfig(accum=spec["accum"], log_every=1, ckpt_every=0,
                     monitor_every=2,
                     opt=adamw.AdamWConfig(lr=spec["lr"],
                                           warmup_steps=spec["warmup"],
                                           total_steps=spec["steps"]))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, shape, tc=tc, lm_kwargs=lm_kwargs, seed=SEED,
                 device=DEV)
    sync()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in _leaves(tr.params))
    tokens = spec["global_batch"] * spec["seq_len"]

    # the plain path's step 1: same weights, same batch; its gradients are
    # kept for step 1's through the kernels (taken as AdamW receives them)
    batch0 = tr.place_batch(tr.data.batch_at(0))
    t0 = time.perf_counter()
    p_loss, _, p_grads = step_grads(LM(cfg, **plain_kwargs), tr.params,
                                    batch0, spec["accum"])
    plain = {"loss": float(p_loss),
             "grad_norm": float(adamw.global_norm(p_grads))}
    plain_s = time.perf_counter() - t0
    del batch0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    update, first_grads = RTM.adamw.update, []

    def keep_first(cfg_, grads, state, params):
        if not first_grads:
            first_grads.append(grads)
        return update(cfg_, grads, state, params)

    step_fn, times, syncs = tr._step, [], []

    def timed(*a):
        sync()
        t = time.perf_counter()
        with SyncCount() as sc:
            out = step_fn(*a)
        sync()
        times.append(time.perf_counter() - t)
        syncs.append(sc.total)
        return out

    tr._step = timed
    RTM.adamw.update = keep_first
    for f in K.values():                        # counted from here ...
        f.launches = 0
    ops.reset_counts()
    try:
        hist = tr.run(spec["steps"])
    finally:
        RTM.adamw.update = update
    launches = {n: f.launches for n, f in K.items()}   # ... to here
    bwd = {n: ops.FUNCTIONS[f].backward_calls
           for n, f in TRAIN_FUNCTIONS.items()}
    variants = {n: K[n].last_variant for n in spec["path"]}
    tr._step = step_fn
    peak = torch.cuda.max_memory_allocated()
    gap = grads_gap(first_grads[0], p_grads)
    del first_grads, p_grads
    prof = profile_train_step(tr)
    fit = fit_one_batch(tr, spec)

    losses = [m["loss"] for _, m in hist]
    step_s = times[1:]
    mean_s = sum(step_s) / len(step_s)
    first = hist[0][1]
    report = {
        "phase": phase, "arch": cfg.name, "n_params": n_params,
        "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "seq_len": spec["seq_len"], "global_batch": spec["global_batch"],
        "accum": spec["accum"], "steps": spec["steps"], "init_s": init_s,
        "losses": losses, "aux": [m["aux"] for _, m in hist],
        "grad_norms": [m["grad_norm"] for _, m in hist],
        "lrs": [m["lr"] for _, m in hist],
        "step_s": times, "mean_step_s_after_first": mean_s,
        "tokens_per_step": tokens, "tokens_per_s": tokens / mean_s,
        "mfu": 6 * n_params * tokens / (mean_s * H100_BF16_PER_S),
        "mfu_peak_flops": H100_BF16_PER_S,
        "peak_mem_gb": peak / 2**30,
        "launches": launches,
        "launches_per_step": {n: v / spec["steps"]
                              for n, v in launches.items()},
        "backward_calls": bwd,
        "backward_calls_per_step": {n: v / spec["steps"]
                                    for n, v in bwd.items()},
        "last_variants": variants,
        "syncs_per_step": syncs,
        "plain_step1": {"loss": plain["loss"],
                        "grad_norm": plain["grad_norm"], "seconds": plain_s,
                        "loss_err": abs(first["loss"] - plain["loss"]),
                        "loss_atol": TRAIN_LOSS_ATOL,
                        "grad_norm_rel_err": abs(first["grad_norm"]
                                                 - plain["grad_norm"])
                        / max(abs(plain["grad_norm"]), 1e-30),
                        "grad_norm_rtol": TRAIN_GNORM_RTOL,
                        "grad_rel_l2": gap["rel_l2"],
                        "grad_cosine": gap["cosine"],
                        "grad_rtol": TRAIN_GRAD_RTOL},
        "uniform_loss": math.log(cfg.vocab_size),
        "falls_over_steps": losses[-1] < losses[0],
        "fit_one_batch": fit, "profile": prof}
    emit(report)
    pc = report["plain_step1"]
    fails = []
    if not all(np.isfinite(losses)):
        fails.append("a loss is not finite")
    if losses[0] > report["uniform_loss"] + UNIFORM_MARGIN and \
            not report["falls_over_steps"]:
        fails.append("the loss did not fall from above the uniform guess")
    if not fit["ok"]:
        fails.append(f"the first AdamW step on one microbatch is not a "
                     f"descent step: {fit['why']}")
    if not all(fit["faults_rejected"].values()):
        fails.append(f"the step check passed a planted fault: "
                     f"{fit['faults_rejected']}")
    if pc["loss_err"] > TRAIN_LOSS_ATOL or \
            pc["grad_norm_rel_err"] > TRAIN_GNORM_RTOL or \
            not pc["grad_rel_l2"] <= TRAIN_GRAD_RTOL:
        fails.append("step 1 disagrees with the plain path")
    if any(syncs):
        fails.append(f"host syncs inside a step: {syncs}")
    if any(launches[n] < spec["steps"] or bwd[n] < spec["steps"]
           for n in spec["path"]):
        fails.append(f"a kernel of the path did not launch or run its "
                     f"backward every step: {launches}, {bwd}")
    if any(variants[n] != TRAIN_VARIANT[n] for n in spec["path"]):
        fails.append(f"variants {variants}")
    if fails:
        raise SystemExit(f"{phase}: " + "; ".join(fails))
    return report


def first_step(tr, spec) -> dict:
    """The trainer's first AdamW step from zero moments on the run's first
    microbatch (``global_batch // accum`` sequences), from the weights where
    the run ended (its moments carry other batches' gradients, and its end
    state is not bit-reproducible on the card), at the phase's learning rate
    held constant: the batch, the weights theta, the gradient g of the NLL
    (``step_grads``, as AdamW receives it), the step u (``adamw.update``'s
    new parameters less theta, float32) and the NLL at theta."""
    import repro_torch.runtime.train as RTM
    mb = spec["global_batch"] // spec["accum"]
    batch = {k: v[:mb] for k, v in
             tr.place_batch(tr.data.batch_at(0)).items()}
    tr.opt_state = None
    _, parts, grads = RTM.step_grads(tr.lm, tr.params, batch)
    return {"batch": batch, "grads": list(grads),
            "u": adamw_first_step(tr, spec["lr"], grads),
            "nll": float(parts["nll"])}


def adamw_first_step(tr, lr, grads) -> list:
    """The step (float32 leaves: ``adamw.update``'s new parameters less
    ``tr.params``) of AdamW's first update from zero moments on ``grads``,
    at ``lr`` held constant."""
    from repro_torch.optim import adamw
    opt = adamw.AdamWConfig(lr=lr, warmup_steps=0, schedule="constant")
    new, _, _ = adamw.update(opt, grads, adamw.init(tr.params), tr.params)
    return [n.float() - p.float() for n, p in zip(_leaves(new),
                                                    _leaves(tr.params))]


def step_verdict(tr, st, u, scales=ARMIJO_SCALES, every=False) -> dict:
    """``fit_one_batch``'s conditions (a)-(c) on the step ``u`` (a list of
    float32 leaves) from ``st`` (:func:`first_step`): each leaf's g.u and
    sum |g_i u_i| in float64, the whole g.u, and along the line,
    for each s until one passes (every s with ``every``, as the study
    asks), the displacement's g.delta, the NLL at theta + delta and its
    drop against ARMIJO_C |g.delta|."""
    from repro_torch.models.params import tree_unflatten
    leaves = _leaves(tr.params)
    rows, gu = [], 0.0
    for g, d in zip(st["grads"], u):
        prod = g.double() * d.double()
        dot, mag = float(prod.sum()), float(prod.abs().sum())
        del prod
        rows.append({"gu": dot, "gu_abs": mag,
                     "ratio": dot / mag if mag > 0 else 0.0})
        gu += dot
    out = {"gu": gu, "leaves": rows, "line": [],
           "leaf_max_ratio": max(r["ratio"] for r in rows)}
    bad = [i for i, r in enumerate(rows)
           if not r["gu"] <= -LEAF_DESCENT * r["gu_abs"]]
    if bad:
        out.update(ok=False, why=f"leaves {bad} do not descend their own "
                   f"gradient (g.u / sum |g_i u_i| "
                   f"{[rows[i]['ratio'] for i in bad]})")
        return out
    if not gu < 0:
        out.update(ok=False, why=f"g.u = {gu} is not negative")
        return out
    ok = False
    for s in scales:
        moved = [(p.float() + s * d).to(p.dtype) for p, d in zip(leaves, u)]
        g_delta = float(sum(torch.sum(g.double() * (m.double() - p.double()))
                            for g, m, p in zip(st["grads"], moved, leaves)))
        with torch.no_grad():
            nll = float(tr.lm.loss_fn(tree_unflatten(tr.params, moved),
                                      st["batch"])[1]["nll"])
        del moved
        drop = st["nll"] - nll
        hit = g_delta < 0 and drop >= ARMIJO_C * abs(g_delta)
        out["line"].append({"s": s, "g_delta": g_delta, "nll": nll,
                            "drop": drop, "need": ARMIJO_C * abs(g_delta),
                            "ok": hit})
        ok = ok or hit
        if ok and not every:
            break
    out.update(ok=ok, why="" if ok else
               f"no s of {list(scales)} lowers the NLL by {ARMIJO_C} "
               f"|g.delta|: {out['line']}")
    return out


def planted_steps(st) -> dict:
    """The step ``u`` of ``st`` made wrong three ways: zero, reversed, and
    misdirected (the update of one leaf written into the first other leaf
    of its shape, which keeps its own)."""
    u = st["u"]
    pair = next(((i, j) for i in range(len(u)) for j in range(i + 1, len(u))
                 if u[i].shape == u[j].shape and u[i].numel() > 1), None)
    mis = list(u)
    if pair is not None:
        mis[pair[1]] = u[pair[0]]
    return {"zero": [torch.zeros_like(d) for d in u],
            "reversed": [-d for d in u], "misdirected": mis,
            "pair": pair}


def fit_one_batch(tr, spec) -> dict:
    """The check of the trainer's first AdamW step on one microbatch
    (ARMIJO_SCALES' notes): :func:`first_step`, then :func:`step_verdict`
    on it and on its three planted faults (:func:`planted_steps`), each of
    which must fail, and on a fourth that only the line can see: the
    AdamW step of the reversed gradient, which descends that gradient
    leaf by leaf, so (a) and (b) hold, and must fail at (c), every s of
    the line tried (its drop and need kept, ``reversed_gradient_line``).
    The weights are left as the run ended them."""
    t0 = time.perf_counter()
    st = first_step(tr, spec)
    out = step_verdict(tr, st, st["u"])
    plants = planted_steps(st)
    out["faults_rejected"] = {k: not step_verdict(tr, st, plants[k])["ok"]
                              for k in ("zero", "reversed", "misdirected")}
    out["misdirected_pair"] = plants["pair"]
    del plants
    neg = [-g for g in st["grads"]]
    rev = dict(st, grads=neg, u=adamw_first_step(tr, spec["lr"], neg))
    del neg
    v = step_verdict(tr, rev, rev["u"])
    out["faults_rejected"]["reversed_gradient"] = (
        not v["ok"] and len(v["line"]) == len(ARMIJO_SCALES))
    out["reversed_gradient_line"] = [
        {k: p[k] for k in ("s", "drop", "need")} for p in v["line"]]
    out["reversed_gradient_why"] = v["why"][:300]
    out.update(lr=spec["lr"], nll=st["nll"],
               seconds=time.perf_counter() - t0)
    del st, rev
    return out


def grads_gap(got, ref) -> dict:
    """Two gradients (lists of leaves) as vectors: ``||got - ref|| /
    ||ref||`` and their cosine, summed in float64 leaf by leaf."""
    num = den = dot = nrm = 0.0
    for g, r in zip(got, ref):
        g, r = g.double(), r.double()
        num += float(torch.sum((g - r) ** 2))
        den += float(torch.sum(r * r))
        nrm += float(torch.sum(g * g))
        dot += float(torch.sum(g * r))
    return {"rel_l2": math.sqrt(num / den) if den > 0 else math.sqrt(num),
            "cosine": dot / math.sqrt(den * nrm) if den * nrm > 0 else 0.0}


def _leaves(tree):
    from repro_torch.models.params import tree_leaves
    return tree_leaves(tree, torch.is_tensor)


def phase_train():
    """h2o-danube-1.8b at full width and depth: ``flash_attention`` and
    ``fused_rmsnorm_mlp`` through ``kernels.ops``; the plain path is
    ``chunked`` attention (the folded schedule) and the plain MLP.  Both
    take the iota-compare loss (``onehot_loss``), as ``train_mesh`` does.
    Then the attention backward's head grouping timed
    (``attention_backward_groups``)."""
    from repro_torch.models.layers import AttnOptions
    report = drive_train(TRAIN, _train_lm_kwargs(),
                         dict(opts=AttnOptions(backend="chunked",
                                               folded=True),
                              remat=True, onehot_loss=True), "train")
    from repro_torch.kernels.ops import FlashAttention
    emit({"phase": "train_attention_backward",
          "path_heads_per_group": FlashAttention.last_heads,
          **attention_backward_groups(TRAIN, report)})
    return report


def attention_backward_groups(spec, report) -> dict:
    """The attention oracle's backward (``kernels.ops.attention_grads``) at
    the phase's microbatch shapes, one kv head at a time (as ``train_mesh``'s
    ranks run it) and all kv heads at once (as a card of its own does),
    timed in turn with CUDA events; the split's cost to a step is the
    difference times the backward's calls a step (a layer a
    microbatch)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import attention_grads
    cfg = get_config(spec["arch"])
    B, S = spec["global_batch"] // spec["accum"], spec["seq_len"]
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    G = cfg.n_heads // KV
    gen = torch.Generator(device=DEV).manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=DEV).bfloat16()
    q, g = rnd(B, S, KV, G, hd), rnd(B, S, KV, G, hd)
    k, v = rnd(B, S, KV, hd), rnd(B, S, KV, hd)
    pos = torch.arange(S, device=DEV).expand(B, S)

    def run(heads):
        return attention_grads(q, k, v, pos, pos, g, hd ** -0.5,
                               cfg.sliding_window, heads=heads)
    gap = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(run(1), run(KV)))
    ms = {1: [], KV: []}
    for _ in range(3):
        for h in (1, KV):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            e0.record()
            run(h)
            e1.record()
            e1.synchronize()
            ms[h].append(e0.elapsed_time(e1))
    one, whole = sorted(ms[1])[1], sorted(ms[KV])[1]
    calls = report["backward_calls_per_step"]["flash_attention"]
    torch.cuda.empty_cache()
    return {"shape": [B, S, KV, G, hd], "one_head_ms": ms[1],
            "all_heads_ms": ms[KV], "one_head_median_ms": one,
            "all_heads_median_ms": whole, "ratio": one / whole,
            "calls_per_step": calls,
            "step_cost_ms": (one - whole) * calls,
            "step_share": (one - whole) * calls
            / (1e3 * report["mean_step_s_after_first"]),
            "max_abs_gap": gap}


def phase_train_moe():
    """granite-moe-1b-a400m at full width and depth: ``flash_attention``
    and the expert products through ``torch._grouped_mm``; the plain path
    ``chunked`` attention (folded) and the per-expert loop."""
    from repro_torch.models.layers import AttnOptions
    return drive_train(TRAIN_MOE, dict(opts=AttnOptions(backend="fused"),
                                       remat=True),
                       dict(opts=AttnOptions(backend="chunked", folded=True),
                            remat=True), "train_moe")


def phase_train_ssm():
    """mamba2-370m at full width and depth: ``ssd_scan`` through
    ``kernels.ops`` (``ssm_backend="fused"``); the plain path the chunked
    scan in PyTorch."""
    return drive_train(TRAIN_SSM, dict(ssm_backend="fused", remat=True),
                       dict(ssm_backend="torch", remat=True), "train_ssm")


def phase_train_resume(tmp_root):
    """Checkpoint and restart on the card: the reduced danube in float32
    through the kernels; 10 steps uninterrupted, against 8 steps saving
    every 5, the parameters lost, ``FaultSupervisor.recover()`` and 5 more:
    steps 6-10's losses within ``TRAIN_RESUME_RTOL`` (the embedding and
    scatter backward add with atomics on the card, so bit equality is the
    CPU tests' gate)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.layers import AttnOptions
    from repro_torch.models.params import tree_map
    from repro_torch.optim import adamw
    from repro_torch.runtime.fault import FaultSupervisor
    from repro_torch.runtime.train import TrainConfig, Trainer
    cfg = get_config(TRAIN["arch"]).reduced()
    shape = ShapeConfig("tiny", 64, 4, "train")

    def trainer(ckpt_every, sub):
        tc = TrainConfig(log_every=1, ckpt_every=ckpt_every,
                         ckpt_dir=os.path.join(tmp_root, sub),
                         monitor_every=2,
                         opt=adamw.AdamWConfig(lr=1e-3, warmup_steps=2,
                                               total_steps=100))
        tr = Trainer(cfg, shape, tc=tc, seed=SEED, device=DEV,
                     lm_kwargs=dict(opts=AttnOptions(backend="fused"),
                                    remat=True))
        tr.params = tree_map(lambda a: a.float(), tr.params, torch.is_tensor)
        tr.opt_state = adamw.init(tr.params)
        return tr

    ref = {s: m["loss"] for s, m in trainer(0, "a").run(10)}
    tr = trainer(5, "b")
    sup = FaultSupervisor(tr)
    tr.run(8)
    saved = tr.store().wait()
    tr.params = None                           # total state loss
    resumed = sup.recover()
    t0 = time.perf_counter()
    got = {s: m["loss"] for s, m in tr.run(10 - tr.step)}
    worst = max(abs(got[s] - ref[s]) / abs(ref[s]) for s in got)
    report = {"phase": "train_resume", "arch": cfg.name, "dtype": "float32",
              "resumed_at": resumed, "steps_rerun": sorted(got),
              "loss10": got.get(10), "loss10_uninterrupted": ref[10],
              "max_rel_err": worst, "rtol": TRAIN_RESUME_RTOL,
              "rerun_s": time.perf_counter() - t0,
              "save_s": saved.seconds, "save_bytes": saved.nbytes,
              "events": [e.kind for e in sup.events]}
    emit(report)
    if resumed != 5 or 10 not in got or worst > TRAIN_RESUME_RTOL:
        raise SystemExit("train_resume: the resumed run disagrees with the "
                         "uninterrupted one")
    return report


def phase_training():
    """The training phases in turn: the Functions, then danube, granite-moe
    and mamba2 at full width, then checkpoint / restart; the full-width
    runs' reports and the Functions' report."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    kernels_report = phase_train_kernels()
    reports = {"train": phase_train(), "train_moe": phase_train_moe(),
               "train_ssm": phase_train_ssm()}
    full_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        phase_train_resume(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "training", "seconds": time.perf_counter() - t0,
          "kernels_and_full_width_s": full_s})
    return reports, kernels_report


# ---------------------------------------------------------------------------
# the cost model beside the measured paths (phase ``costing``)
# ---------------------------------------------------------------------------

# serving phase -> its spec; the LM is built as drive_serve built it
COST_SERVE = {"serve": SERVE, "serve_ssm": SERVE_SSM,
              "serve_hybrid": SERVE_HYBRID, "serve_moe": SERVE_MOE,
              "serve_mla": SERVE_MLA}
COST_TRAIN = {"train": TRAIN, "train_moe": TRAIN_MOE, "train_ssm": TRAIN_SSM}
MFU_RTOL = 1e-9                 # the costing MFU vs the training phase's


def cost_lm_kwargs(phase):
    """The LM keywords the phase ran with (``drive_serve`` /
    ``drive_train``)."""
    from repro_torch.models.layers import AttnOptions
    fused = AttnOptions(backend="fused")
    return {"serve": dict(opts=fused), "serve_ssm": dict(ssm_backend="fused"),
            "serve_hybrid": dict(opts=fused, ssm_backend="fused"),
            "serve_moe": dict(opts=fused), "serve_mla": dict(opts=fused),
            "train": dict(opts=fused, remat=True, onehot_loss=True),
            "train_moe": dict(opts=fused, remat=True),
            "train_ssm": dict(ssm_backend="fused", remat=True)}[phase]


def cost_row(path, kind, count, n_params, tokens, hbm, measured_s, train,
             count_s):
    """One path's counted FLOPs, model FLOPs, HBM bytes and roofline terms
    on ``H100_SXM`` at one card, beside the seconds the phase measured."""
    from repro_torch.core.perfmodel import model_flops, roofline_from_counts
    mf = model_flops(n_params, tokens, train=train)
    t = roofline_from_counts(count.total, hbm, 0.0, 1)
    peak = H100_BF16_PER_S
    return {"path": path, "kind": kind, "flops_total": count.total,
            "dot_flops": count.dot, "model_flops": mf,
            "n_params_for_model_flops": n_params, "tokens": tokens,
            "hbm_bytes": hbm, "t_compute_s": t.t_compute,
            "t_memory_s": t.t_memory, "dominant": t.dominant,
            "t_bound_s": t.t_bound, "measured_s": measured_s,
            "bound_over_measured": t.t_bound / measured_s,
            "mfu": mf / (measured_s * peak),
            "counted_flop_util": count.total / (measured_s * peak),
            "dot_flop_util": count.dot / (measured_s * peak),
            "count_s": count_s}


def cost_train(phase, report):
    """A training phase's step (the same LM, batch, microbatches and
    AdamW step) counted on meta inputs, beside its mean step seconds; its
    MFU is the phase's own, recomputed through ``model_flops``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.tiles import default_plan
    from repro_torch.launch import specs as SP
    from repro_torch.launch.costing import flops_of_fn, hbm_bytes
    from repro_torch.models.transformer import LM
    from repro_torch.runtime.train import TrainConfig, make_train_step
    spec = COST_TRAIN[phase]
    cfg = get_config(spec["arch"])
    lm = LM(cfg, **cost_lm_kwargs(phase))
    shape = ShapeConfig("train_4k", spec["seq_len"], spec["global_batch"],
                        "train")
    plan = default_plan(cfg)
    p = lm.abstract()
    t0 = time.perf_counter()
    count = flops_of_fn(make_train_step(lm, plan, None,
                                        TrainConfig(accum=spec["accum"])),
                        p, SP.abstract_opt_state(p),
                        SP.abstract_batch(cfg, shape),
                        SP.abstract_counters(plan))
    row = cost_row(phase, "train", count, report["n_params"],
                   report["tokens_per_step"], hbm_bytes(cfg, shape),
                   report["mean_step_s_after_first"], True,
                   time.perf_counter() - t0)
    row["mfu_phase"] = report["mfu"]
    row["mfu_rel_gap"] = abs(row["mfu"] - report["mfu"]) / report["mfu"]
    return row


def cost_serve(phase, report):
    """A serving phase's longest prefill (one request, B = 1, the cache
    fitted to the window, as the engine runs it) and its decode step (every
    slot, over the window's ring), counted on meta inputs, beside the
    seconds the phase measured for them."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import specs as SP
    from repro_torch.launch.costing import flops_of_fn, hbm_bytes
    from repro_torch.models.transformer import LM
    spec = COST_SERVE[phase]
    cfg = get_config(spec["arch"])
    lm = LM(cfg, **cost_lm_kwargs(phase))
    window = spec.get("window", 256)     # drive_serve's
    p = lm.abstract()
    i = int(np.argmax(spec["prompts"]))
    n = spec["prompts"][i]
    shape = ShapeConfig("prefill", n, 1, "prefill")
    t0 = time.perf_counter()
    count = flops_of_fn(lambda p, t: lm.prefill(p, t, cache_len=window), p,
                        SP.abstract_prefill_tokens(shape))
    rows = [cost_row(phase, f"prefill_{n}", count, cfg.n_active_params(), n,
                     hbm_bytes(cfg, shape),
                     report["prefill_s_by_request"][i], False,
                     time.perf_counter() - t0)]
    shape = ShapeConfig("decode", window, spec["slots"], "decode")
    cache, tok = SP.abstract_decode_inputs(lm, shape)
    t0 = time.perf_counter()
    count = flops_of_fn(lambda p, c, t: lm.decode_step(p, c, t), p, cache,
                        tok)
    rows.append(cost_row(phase, f"decode_{spec['slots']}x{window}", count,
                         cfg.n_active_params(), spec["slots"],
                         hbm_bytes(cfg, shape),
                         report["decode_step_ms"] / 1e3, False,
                         time.perf_counter() - t0))
    return rows


def counting_refuses_a_launch():
    """The planted fault: counting a step that would launch
    ``flash_attention`` on the card (real CUDA inputs, which the counter
    turns into fakes on the card) must raise, naming the kernel, and
    launch nothing."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.costing import flops_of_fn
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    q = _randn(gen, (1, 128, 2, 2, 64), torch.bfloat16)
    k = _randn(gen, (1, 128, 2, 64), torch.bfloat16)
    v = _randn(gen, (1, 128, 2, 64), torch.bfloat16)
    pos = torch.arange(128, dtype=torch.int32, device=DEV)[None]
    n0 = flash_attention.launches
    try:
        flops_of_fn(ops.flash_attention, q, k, v, pos, pos, 0, 0.125)
        out = {"raised": False}
    except RuntimeError as e:
        out = {"raised": "flash_attention" in str(e),
               "message": str(e).splitlines()[0][:120]}
    out["launched"] = flash_attention.launches - n0
    return out


# the dry run's cells beyond the 33 single-pod tp ones: expert parallelism
# on the moe family's cells; the reference's pod_domain rows (deepseek
# decode_32k at mra1/2/4/8: per-device weight bytes beside collective
# bytes); the attention tiles replicated four ways on one train cell a
# family
DRY_EP_ARCHS = ("granite-moe-1b-a400m", "deepseek-v2-lite-16b")
DRY_K_SWEEP = ("deepseek-v2-lite-16b", "decode_32k", (1, 2, 4, 8))
DRY_MRA_ATTN = ("h2o-danube-1.8b", "granite-moe-1b-a400m", "mamba2-370m",
                "zamba2-7b")


def _dry_cell(r) -> dict:
    """The keys of one dry-run cell that the card's report keeps."""
    return {"arch": r["arch"], "shape": r["shape"],
            "strategy": r["strategy"], "mesh": r["mesh"],
            "flops_total": r["flops_total"],
            "dot_flops_total": r["dot_flops_total"],
            "hbm_bytes_total": r["hbm_bytes_total"],
            "argument_size_in_bytes": r["argument_size_in_bytes"],
            "param_bytes_per_device": r["param_bytes_per_device"],
            "collective_bytes": r["collective_bytes"],
            "per_op_bytes": r["per_op_bytes"],
            "op_counts": r["op_counts"],
            "t_compute_s": r["roofline"]["t_compute"],
            "t_memory_s": r["roofline"]["t_memory"],
            "t_collective_s": r["roofline"]["t_collective"],
            "dominant": r["roofline"]["dominant"],
            "lower_seconds": r["lower_seconds"],
            "count_seconds": r["count_seconds"]}


def dryrun_on_card():
    """The dry run here, abstract: every assigned architecture's cells on
    the single-pod mesh (256 chips), each with its collective term (one
    rank's placed step on a fake process group of the mesh, this process
    its rank 0), then the ``ep``, K-sweep and ``mra4-attn`` cells above,
    counted by this machine's torch; the per-cell numbers and the seconds
    it took."""
    from repro_torch.configs import get_config, shapes_for
    from repro_torch.core.replication import replication_area_model
    from repro_torch.launch import dryrun as D
    t0 = time.perf_counter()
    jobs = [(a, sh, "tp") for a, sh in D.iter_cells()]
    jobs += [(a, sh, "ep") for a in DRY_EP_ARCHS
             for sh in shapes_for(get_config(a))]
    arch, shape, ks = DRY_K_SWEEP
    jobs += [(arch, shape, f"mra{k}") for k in ks]
    jobs += [(a, "train_4k", "mra4-attn") for a in DRY_MRA_ATTN]
    cells, fails = [], []
    for arch_, shape_, strategy in jobs:
        try:
            r = D.run_cell(arch_, shape_, multi_pod=False, save=False,
                           co=D.CellOptions(strategy=strategy))
        except Exception as e:                   # reported, then fails
            fails.append(f"{arch_} x {shape_} x {strategy}: {e!r}"[:200])
            continue
        if not (r["collective_bytes"] or 0) > 0:
            fails.append(f"{arch_} x {shape_} x {strategy}: collective "
                         f"bytes {r['collective_bytes']}")
        cells.append(_dry_cell(r))
    sweep = []
    for c in cells:
        if (c["arch"], c["shape"]) == (arch, shape) and \
                c["strategy"].startswith("mra"):
            k = int(c["strategy"][3:])
            area = replication_area_model(get_config(arch).n_params() * 2,
                                          0, k)
            sweep.append({"k": k, "collective_bytes": c["collective_bytes"],
                          "param_bytes_per_device":
                              c["param_bytes_per_device"],
                          "area_model_weight_bytes_per_dev":
                              area["weight_bytes_per_dev"],
                          "t_memory_s": c["t_memory_s"],
                          "t_collective_s": c["t_collective_s"]})
    return {"mesh": "1-pod (16 x 16; K-factored for mra<K>)",
            "cells": cells, "k_sweep": sweep, "failures": fails,
            "seconds": time.perf_counter() - t0}


DRYRUN_LIMIT_S = 600    # the dry run's process, from its start


def start_dryrun():
    """Start ``dryrun_on_card`` in a process of its own (``--dryrun-out``):
    it counts on fakes and never waits for the card, so it runs beside the
    card's phases; ``dryrun_result`` collects it.  The process is killed if
    the script ends first."""
    import atexit
    import shutil
    import tempfile
    workdir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    path = os.path.join(workdir, "dryrun.json")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dryrun-out", path],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        shutil.rmtree(workdir, ignore_errors=True)
    atexit.register(stop)
    return {"proc": proc, "path": path, "t0": time.perf_counter()}


def dryrun_result(job) -> dict:
    """The report of ``start_dryrun``'s process (waiting for it, up to its
    limit; its folder goes when the script ends); a process that failed or
    ran out of time is the dry run's failure."""
    proc = job["proc"]
    left = DRYRUN_LIMIT_S - (time.perf_counter() - job["t0"])
    try:
        _, err = proc.communicate(timeout=max(1.0, left))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        err = f"no result in {DRYRUN_LIMIT_S} s"
    if proc.returncode:
        return {"mesh": "1-pod (16 x 16)", "cells": [], "seconds": None,
                "failures": [f"the dry run's process: {err[-600:]}"]}
    with open(job["path"]) as f:
        return json.load(f)


def phase_costing(serve_reports, train_reports, dry_job):
    """The cost model on the card: each training path's step and each
    serving path's longest prefill and decode step counted abstractly
    (total and dot FLOPs), ``model_flops``, ``hbm_bytes``, the roofline
    terms on ``H100_SXM`` at one card, beside the seconds the earlier
    phases measured (``t_bound / measured``, MFU and counted-FLOP
    utilisation; re-running no path); the planted launch that counting
    must refuse; the dry run's single-pod cells (``dry_job``: its process,
    started by ``start_dryrun``)."""
    t0 = time.perf_counter()
    rows = [cost_train(ph, r) for ph, r in train_reports.items()]
    for ph, r in serve_reports.items():
        rows += cost_serve(ph, r)
    planted = counting_refuses_a_launch()
    dry = dryrun_result(dry_job)
    report = {"phase": "costing",
              "device_spec": dataclasses.asdict(H100_SXM),
              "rows": rows, "planted_launch_refused": planted,
              "dryrun": dry, "seconds": time.perf_counter() - t0}
    emit(report)
    fails = []
    for r in rows:
        if not (0 < r["dot_flops"] <= r["flops_total"]
                and math.isfinite(r["flops_total"])
                and math.isfinite(r["bound_over_measured"])):
            fails.append(f"{r['path']} {r['kind']}: counts {r['dot_flops']}"
                         f" / {r['flops_total']}")
        if "mfu_rel_gap" in r and not r["mfu_rel_gap"] <= MFU_RTOL:
            fails.append(f"{r['path']}: MFU {r['mfu']} vs the phase's "
                         f"{r['mfu_phase']}")
    if not planted["raised"] or planted["launched"]:
        fails.append(f"counting did not refuse a launch: {planted}")
    if dry["failures"]:
        fails.append(f"dry run: {dry['failures']}")
    if fails:
        raise SystemExit("costing: " + "; ".join(fails))
    return report


def train_row(reports, n, kernels_report):
    """The kernels line's ``train`` entry of kernel ``n``: its launches and
    its Function's backward calls over the three training runs, and its
    forward launch beside its backward call from each run's profile, with
    the backward's bound at the run's shapes and, for attention, SDPA's
    backward there (``train_kernels``)."""
    runs = {ph: r for ph, r in reports.items() if r["launches"].get(n)}
    path = {c["run"]: c for c in kernels_report["cases"]
            if c.get("run") and c["case"][0] == TRAIN_FUNCTIONS[n]}

    def bound(ph):
        c = path.get(ph, {})
        out = {k: c[k] for k in ("backward_bound_ms", "backward_bound_by",
                                 "backward_bound_tc_ms",
                                 "backward_bound_f32_ms") if k in c}
        if "sdpa_backward" in c:
            out["backward_library_ms"] = c["sdpa_backward"]["ms"]
        return out
    return {"launches": sum(r["launches"][n] for r in reports.values()),
            "backward_calls": sum(r["backward_calls"][n]
                                  for r in reports.values()),
            "by_run": {ph: {"launches_per_step": r["launches_per_step"][n],
                            **r["profile"]["functions"].get(n, {}),
                            **bound(ph)}
                       for ph, r in runs.items()}}


def card_train_kernel(name, dtype, shape):
    """A Function of ``kernels.ops`` on the card: forward equal to the raw
    kernel's, one launch, gradients against autograd through the plain
    version (``train_kernel_check``)."""
    res = train_kernel_check(name, dtype, shape)
    assert res["ok"], f"autograd Function off its plain version: {res}"


# gpu-marked test -> (the function here, its cases as the test's arguments)
CARD_TESTS = {
    "test_cuda_flash_attention_matches_plain": (
        card_flash_attention,
        tuple(c + (t,) for t in CARD_DTYPES for c in CARD_ATTN)),
    "test_cuda_flash_decode_matches_plain": (
        card_flash_decode,
        tuple(c + (t,) for t in CARD_DTYPES for c in CARD_DECODE)),
    "test_cuda_fused_mlp_matches_plain": (
        card_fused_mlp,
        tuple(c + (a, t) for t in CARD_DTYPES for a in ("silu", "gelu")
              for c in CARD_MLP)),
    "test_cuda_flash_attention_wgmma_edges": (
        card_flash_attention_wgmma_edges, EDGE_ATTN),
    "test_cuda_fused_mlp_wgmma_edges": (card_fused_mlp_wgmma_edges,
                                        EDGE_MLP),
    "test_cuda_fused_mlp_gemv_edges": (card_fused_mlp_gemv_edges,
                                       EDGE_MLP_ROWS),
    "test_cuda_misaligned_views_take_the_wmma_kernels": (
        card_misaligned_views, ((),)),
    "test_cuda_misaligned_decode_mlp_takes_the_rows_kernel": (
        card_misaligned_decode_mlp, ((),)),
    "test_cuda_flash_decode_cp_async_edges": (
        card_flash_decode_cp_async_edges, EDGE_DECODE),
    "test_cuda_misaligned_decode_cache_takes_the_cuda_core_sweep": (
        card_misaligned_decode_cache, ((),)),
    "test_cuda_flash_decode_lse_matches_plain": (card_flash_decode_lse,
                                                 CARD_DECODE_LSE),
    "test_cuda_ssd_scan_matches_plain": (card_ssd_scan, CARD_SSD),
    "test_cuda_ssd_scan_tf32x3_edges": (card_ssd_scan_tf32x3_edges,
                                        EDGE_SSD),
    "test_cuda_misaligned_ssd_takes_the_cuda_core_kernels": (
        card_misaligned_ssd, ((),)),
    "test_cuda_kernel_matches_plain_version": (
        card_tick_sim, tuple((p,) for p in CARD_POLICIES)),
    "test_cuda_chunked_sweep_matches_host": (card_chunked_sweep,
                                             CARD_CHUNKS),
    "test_cuda_telemetry_matches_cpu": (
        card_telemetry, tuple((p,) for p in CARD_POLICIES)),
    "test_cuda_percentiles_bit_equal": (card_percentiles,
                                        CARD_PERCENTILES),
    "test_cuda_sequential_engine_matches_cpu": (
        card_sim_engine, (("open",), ("membound",), ("pid",))),
    "test_cuda_fault_run_matches_cpu": (
        card_fault_run, (("respill",), ("drop",), ("wait",))),
    "test_cuda_supervisor_run_matches_cpu": (
        card_supervisor_run, ((False,), (True,))),
    "test_cuda_observed_run_matches_cpu": (
        card_observe, (("sequential",), ("faults",), ("batch64",),
                       ("batch32",))),
    "test_cuda_grouped_matmul_matches_plain": (card_grouped_matmul,
                                               CARD_GROUPED),
    "test_cuda_ops_match_plain_under_autograd": (card_train_kernel,
                                                 TRAIN_KERNEL_CASES),
    "test_cuda_fused_devices_match_unsharded": (
        card_shard_fused, (("pid",), ("membound",))),
}


# ---------------------------------------------------------------------------
# shard_main_path: devices= on the main path, N shards on one card
# ---------------------------------------------------------------------------

# The forced device count of repro_torch.shard: N shards, all on cuda:0 on a
# one-card machine (no multi-GPU speed can be measured here)
SHARDS = 4
SHARD_F64 = {"B": 63, "T": 1000}   # the float64 loop: ragged B, syncs, plane
SHARD_FIELDS = ("completed", "dropped", "residual", "energy_j", "swaps",
                "p50_latency_s", "p99_latency_s", "energy_per_request_j")


class ShardSyncs(SyncCount):
    """:class:`SyncCount`, plus the syncs of every single engine's run
    (``per_run``, in order: the unsharded engine's, or each shard's; a
    ``"fused"`` shard's launch and collect summed) and of every tick loop
    (``per_loop``)."""

    def __enter__(self):
        super().__enter__()
        from repro_torch.sim.batch import BatchSimEngine
        self._by_engine = {}
        self._runs = {n: getattr(BatchSimEngine, n)
                      for n in ("_launch_fused", "_collect_fused",
                                "_run_torch")}
        count = self

        def wrap(orig):
            def run(engine, *a, **kw):
                n0 = len(count.records)
                try:
                    return orig(engine, *a, **kw)
                finally:
                    key = id(engine)
                    count._by_engine[key] = count._by_engine.get(
                        key, 0) + count._syncs(count.records[n0:])
            return run

        for n, orig in self._runs.items():
            setattr(BatchSimEngine, n, wrap(orig))
        # the syncs inside each tick loop, loop by loop
        self.per_loop = []
        inner = BatchSimEngine._ticks

        def ticks(engine, lp, trace):
            before = count.in_ticks
            inner(engine, lp, trace)
            count.per_loop.append(count.in_ticks - before)

        BatchSimEngine._ticks = ticks
        return self

    def __exit__(self, *exc):
        for n, orig in self._runs.items():
            setattr(self._cls, n, orig)
        self.per_run = list(self._by_engine.values())
        return super().__exit__(*exc)


@contextlib.contextmanager
def forced_devices(n):
    """A block with ``REPRO_TORCH_FORCE_DEVICE_COUNT=n``."""
    from repro_torch.shard import FORCE_ENV
    old = os.environ.get(FORCE_ENV)
    os.environ[FORCE_ENV] = str(n)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(FORCE_ENV, None)
        else:
            os.environ[FORCE_ENV] = old


def shard_gap(a, b):
    """The fields of result ``b`` that are not result ``a``'s bit for bit
    (shape included)."""
    bad = []
    for f in SHARD_FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        if x.shape != y.shape or not np.array_equal(x, y, equal_nan=True):
            bad.append(f)
    return bad


def shard_planted_faults(r, n):
    """Two results the equality check must reject: the first two shards'
    blocks joined out of order, and the last shard's pad left on."""
    B = r.n_designs
    per = -(-B // n)
    order = np.r_[per:2 * per, 0:per, 2 * per:B]
    pad = np.r_[0:B, [0] * (per * n - B or 1)]
    return {name: dataclasses.replace(r, **{
        f: np.asarray(getattr(r, f))[idx] for f in SHARD_FIELDS})
        for name, idx in (("shards_out_of_order", order),
                          ("pad_not_sliced", pad))}


def sweep_gap(a, b, chunked):
    """What differs between two sweeps of one grid: the objective arrays
    (dense), the Pareto set, the candidates and their values, the top-k."""
    from repro_torch.core.dse import _TRACKED_OBJECTIVES
    bad = []
    if chunked:
        pairs = [("pareto", a.pareto, b.pareto),
                 ("cand_indices", a.cand_indices, b.cand_indices),
                 ("n_valid", a.n_valid, b.n_valid)]
        pairs += [(f"cand_values.{o}", a.cand_values[o], b.cand_values[o])
                  for o in a.cand_values]
        pairs += [(f"topk.{o}", a.topk[o], b.topk[o]) for o in a.topk]
    else:
        pairs = [(f, getattr(a, f), getattr(b, f))
                 for f in ("throughput", "area", "energy_per_unit",
                           "mem_traffic", "valid", "front_candidates")]
        pairs.append(("pareto", a.pareto_indices(), b.pareto_indices()))
        pairs += [(f"topk.{o}", a.topk_indices(64, o), b.topk_indices(64, o))
                  for o, _ in _TRACKED_OBJECTIVES]
    return [n for n, x, y in pairs if not np.array_equal(x, y)]


def fused_sync_failures(label, syncs):
    """A ``"fused"`` re-rank's syncs: ``devices=4`` runs one engine a
    shard, and no shard's run waits for the card more often than the
    unsharded run does (a shard reads its percentiles back in fewer
    blocks; everything else is one read a run)."""
    one, four = syncs[1], syncs[SHARDS]
    if len(one) != 1 or len(four) != SHARDS or max(four) > one[0]:
        return [f"{label}: syncs per shard {four} against the unsharded "
                f"run's {one}"]
    return []


def phase_shard_main_path(model, res, main_ctx, a12_ctx):
    """``devices=`` on the main path with the forced count at 4 on cuda:0:
    the dense and chunked sweeps, the A2 re-rank and the A12 chain, each at
    ``devices=1`` and ``devices=4``, bit for bit; the float64 loop at a
    ragged B with the observer.  Returns the report and the tick_sim
    launches of the two ``devices=4`` re-ranks (the path's own drive; the
    ``devices=1`` runs compare)."""
    from repro_torch.configs.vespa_soc import CHSTONE
    from repro_torch.core.dse import closed_loop_score, grid_sweep
    from repro_torch.core.islands import NOC_LADDER, TILE_LADDER
    from repro_torch.core.perfmodel import AccelWorkload
    from repro_torch.kernels.tick_sim import fused_tick_sim
    from repro_torch.sim.batch import BatchSimEngine
    from repro_torch.sim.traffic import Trace

    t_phase = time.perf_counter()
    out = {"phase": "shard_main_path", "shards": SHARDS,
           "card": "one card: every shard on cuda:0; the wall times are "
                   "not a multi-GPU speed"}
    fails = []

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        r = fn()
        sync()
        return r, time.perf_counter() - t0

    with forced_devices(SHARDS):
        # the sweeps
        wls = [AccelWorkload("dfsin", *CHSTONE["dfsin"]),
               AccelWorkload("gsm", *CHSTONE["gsm"])]
        axes = dict(ks=(1, 2, 4), acc_rates=TILE_LADDER.levels(),
                    noc_rates=NOC_LADDER.levels(),
                    tg_rates=TILE_LADDER.levels()[::2], n_tg=4)
        iwls = [AccelWorkload(n, *CHSTONE[n]) for n in ISLANDS["accels"]]
        for name, w, ax, kw in (
                ("sweep_dense", wls, axes, {}),
                ("sweep_islands", iwls, chunked_axes(ISLANDS),
                 {"chunk_points": ISLANDS["chunk"]})):
            one, s1 = timed(lambda: grid_sweep(model, w, **ax, devices=1,
                                               device=None, **kw))
            four, s4 = timed(lambda: grid_sweep(model, w, **ax, devices=4,
                                                device=None, **kw))
            bad = sweep_gap(one, four, bool(kw))
            out[name] = {"points": len(one), "wall_s_1": s1, "wall_s_4": s4,
                         "pareto_size": int(np.size(
                             one.pareto if kw else one.pareto_indices())),
                         "differs": bad}
            if bad:
                fails.append(f"{name}: {bad}")

        # the re-ranks on the tick kernel, launches counted from 0; the
        # sharded runs' own launches apart (the devices=1 runs compare)
        fused_tick_sim.launches = 0
        shard_launches = 0
        ctx = main_ctx
        rerank = dict(model=model, indices=ctx["survivors"],
                      req_mb=ctx["req_mb"], sim_config=ctx["cfg"],
                      backend="fused")
        scores, walls, syncs = {}, {}, {}
        for d in (1, 4):
            n0 = fused_tick_sim.launches
            with ShardSyncs() as sc:
                scores[d], walls[d] = timed(lambda: closed_loop_score(
                    res, ctx["trace"], devices=d,
                    batch_controller_factory=pid_factory(), **rerank))
            syncs[d] = sc.per_run
            if d == SHARDS:
                shard_launches += fused_tick_sim.launches - n0
        a, b = scores[1].results[0], scores[4].results[0]
        bad = shard_gap(a, b)
        if not np.array_equal(scores[1].ranked_indices(),
                              scores[4].ranked_indices()):
            bad.append("ranked_indices")
        planted = {k: shard_gap(a, v)
                   for k, v in shard_planted_faults(b, SHARDS).items()}
        launches_a2 = fused_tick_sim.launches
        out["rerank_A2"] = {
            "B": a.n_designs, "T": int(ctx["trace"].ticks),
            "wall_s_1": walls[1], "wall_s_4": walls[4],
            "loop_s_1": a.timings["loop"], "loop_s_4": b.timings["loop"],
            "launches": launches_a2, "syncs_per_run": syncs,
            "differs": bad, "planted_rejected": planted}
        if bad:
            fails.append(f"rerank_A2: {bad}")
        if launches_a2 != 1 + SHARDS:
            fails.append(f"rerank_A2 launched tick_sim {launches_a2} times, "
                         f"not 1 + {SHARDS}")
        if not all(planted.values()):
            fails.append(f"a planted shard fault passed: {planted}")
        fails += fused_sync_failures("rerank_A2", syncs)

        before = fused_tick_sim.launches
        runs, syncs = {}, {}
        for d in (1, 4):
            eng = a12_engine(a12_ctx["plat"], a12_ctx["cfg"])
            eng.devices = d
            n0 = fused_tick_sim.launches
            with ShardSyncs() as sc:
                runs[d], walls[d] = timed(lambda: eng.run(a12_ctx["trace"]))
            syncs[d] = sc.per_run
            if d == SHARDS:
                shard_launches += fused_tick_sim.launches - n0
        launches_a12 = fused_tick_sim.launches - before
        bad = shard_gap(runs[1], runs[4])
        out["rerank_A12_chain"] = {
            "B": runs[1].n_designs, "T": runs[1].ticks,
            "wall_s_1": walls[1], "wall_s_4": walls[4],
            "loop_s_1": runs[1].timings["loop"],
            "loop_s_4": runs[4].timings["loop"],
            "launches": launches_a12, "syncs_per_run": syncs,
            "differs": bad}
        if bad:
            fails.append(f"rerank_A12_chain: {bad}")
        if launches_a12 != 1 + SHARDS:
            fails.append(f"A12 launched tick_sim {launches_a12} times")
        fails += fused_sync_failures("rerank_A12_chain", syncs)
        out["launches_devices_4"] = shard_launches

        # the float64 loop at a ragged B: syncs per shard, the plane
        n, T = SHARD_F64["B"], SHARD_F64["T"]
        plat = ctx["plat"].take(np.arange(n))
        tr = Trace(ctx["trace"].arrivals[:T], ctx["trace"].dt)
        f64, syncs64, loops64, planes = {}, {}, {}, {}
        for d in (1, 4):
            eng = BatchSimEngine(plat, config=ctx["cfg"],
                                 controller=pid_factory()(plat),
                                 backend="torch", observe="counters",
                                 devices=d)
            with ShardSyncs() as sc:
                f64[d], walls[d] = timed(lambda: eng.run(tr))
            syncs64[d], loops64[d] = sc.per_run, sc.per_loop
            planes[d] = eng.observer.counters
        bad = shard_gap(f64[1], f64[4])
        stall_equal = bool(np.array_equal(planes[1].tile["stall_ticks"],
                                          planes[4].tile["stall_ticks"]))
        gap = plane_gap(planes[4], planes[1])
        out["float64_loop"] = {
            "B": n, "T": T, "wall_s_1": walls[1], "wall_s_4": walls[4],
            "syncs_per_run": syncs64, "syncs_per_tick_loop": loops64,
            "control_ticks": T // ctx["cfg"].control_interval,
            "differs": bad,
            "stall_ticks_equal": stall_equal, "plane_gap": gap}
        if bad or not stall_equal or not plane_ok(gap):
            fails.append(f"float64 loop: {bad}, stall {stall_equal}")
        if loops64[4] != loops64[1] * SHARDS:
            fails.append(f"float64 tick loop syncs per shard {loops64[4]} "
                         f"are not the unsharded loop's {loops64[1]}")
    out["failures"] = fails
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    if fails:
        raise SystemExit("devices=4 differs from devices=1 on the main path")
    return out, shard_launches


# ---------------------------------------------------------------------------
# collectives: the explicit-collective bodies on 4 gloo ranks on cuda:0
# ---------------------------------------------------------------------------

COLL = {"world": 4, "limit_s": 300, "timeout_s": 120,
        "pipe": {"S": 4, "M": 8, "L": 8, "d": 512, "B": 64},
        "comp_n": 1 << 20, "moe_mesh": (2, 2), "moe_tokens": (4, 4096),
        "cf_low": 0.9,
        "batch": (8, 4096)}
COLL_TOL = {"pipe_fwd": 1e-5, "pipe_grad": 1e-4, "comp_deq": 1e-6,
            "comp_rel": 0.02, "aux_rel": 0.15,
            # moe vs the one-rank local path, over max(1, max|ref|)
            "moe": {"float32": 2e-4, "bfloat16": 5e-2},
            # float32 gradients vs the one-rank layer's, over max|ref grad|
            "moe_grad": 2e-4}


def _rel_to_max(out, ref):
    return float((out.float() - ref.float()).abs().max()
                 / max(1.0, float(ref.float().abs().max())))


def _moe_grad_errs(MoE, P, p, x, cfg, ample, mesh, gen):
    """The gradients of the router, the expert weights and the tokens
    through expert-TP and EP (ample capacity) on this rank, under the loss
    sum(out * R), against the one-rank layer's autograd: the largest error
    over max |ref grad| of each."""
    R = torch.randn(x.shape, generator=gen).to(x.device)

    def grads(fn):
        pg = {k: v.detach().clone().requires_grad_(True)
              for k, v in p.items()}
        xg = x.detach().clone().requires_grad_(True)
        (fn(pg, xg) * R).sum().backward()
        return {**{k: v.grad for k, v in pg.items()}, "x": xg.grad}

    B, S, d = x.shape
    ref = grads(lambda pg, xg: MoE._moe_ffn_local(
        pg, xg.reshape(B * S, d), cfg)[0].reshape(B, S, d))
    out = {}
    for name, c, ep in (("tp", cfg, False), ("ep", ample, True)):
        with P.set_mesh(mesh):
            got = grads(lambda pg, xg: MoE.moe_apply(pg, c, xg, ep=ep)[0])
        out[name] = {k: float((got[k] - g).abs().max()
                              / g.abs().max().clamp_min(1e-30))
                     for k, g in ref.items()}
    return out


def collectives_rank(rank, world, workdir, device="cuda"):
    """One rank of phase ``collectives``: its checks, written to
    ``workdir/rank<rank>.json`` (``device`` "cpu" only to rehearse the
    phase's code away from the card)."""
    import torch.distributed as dist
    from repro_torch import parallel as P
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import device_put_batch
    from repro_torch.models import moe as MoE
    from repro_torch.models.params import init_params
    from repro_torch.optim.compress import (compressed_allreduce,
                                            dequantize_int8, quantize_int8)
    from repro_torch.parallel import collectives as C

    backend = C.init_process_group(
        rank, world, "file://" + os.path.join(workdir, "store"),
        device=device, timeout_s=COLL["timeout_s"])
    rep = {"rank": rank, "backend": backend}

    def _sync_dev(d):
        if d.type == "cuda":
            torch.cuda.synchronize(d)

    gen = torch.Generator().manual_seed(SEED)

    # pipeline_apply against the sequential composition
    pc = COLL["pipe"]
    mesh = P.make_mesh((pc["S"],), ("stage",), device=device)
    dev = mesh.device
    W = (torch.randn(pc["L"], pc["d"], pc["d"], generator=gen)
         / math.sqrt(pc["d"])).to(dev)
    x = torch.randn(pc["B"], pc["d"], generator=gen).to(dev)
    xs = x.clone().requires_grad_(True)
    xp = x.clone().requires_grad_(True)

    def stage_fn(wg, h):
        for i in range(wg.shape[0]):
            h = torch.tanh(h @ wg[i])
        return h

    Wseq = W.clone().requires_grad_(True)
    y_seq = stage_fn(Wseq, xs)
    (y_seq ** 2).sum().backward()
    Wst = P.stack_layer_groups(W, pc["S"]).clone().requires_grad_(True)
    t0 = time.perf_counter()
    y = P.pipeline_apply(stage_fn, Wst, xp, mesh=mesh, n_micro=pc["M"])
    (y ** 2).sum().backward()
    _sync_dev(dev)
    s = C.axis_index("stage", mesh)
    g_seq = P.stack_layer_groups(Wseq.grad, pc["S"])[s]
    others = torch.cat([Wst.grad[:s], Wst.grad[s + 1:]])
    rep["pipeline"] = {
        "seconds": time.perf_counter() - t0,
        "fwd_err": float((y - y_seq).detach().abs().max()),
        "grad_err": float((Wst.grad[s] - g_seq).abs().max()),
        "x_grad_err": float((xp.grad - xs.grad).abs().max()),
        "grad_outside_stage": float(others.abs().max()),
        "bubble": P.bubble_fraction(pc["S"], pc["M"])}

    # compressed_allreduce over pod on (pod 2, data 2)
    mesh = P.make_mesh((2, world // 2), ("pod", "data"), device=device)
    g = torch.randn(2, COLL["comp_n"], generator=gen).to(dev)
    pod = C.axis_index("pod", mesh)
    t0 = time.perf_counter()
    out = compressed_allreduce({"g": g[pod]}, mesh, "pod")["g"]
    _sync_dev(dev)
    deq = sum(dequantize_int8(*quantize_int8(g[i])) for i in range(2))
    exact = g.sum(0)
    rep["compressed"] = {
        "seconds": time.perf_counter() - t0,
        "deq_err": float((out - deq).abs().max()),
        "rel_to_exact": float((out - exact).norm() / exact.norm())}

    # the MoE layer at granite-moe-1b-a400m's full width, one layer
    cfg = get_config("granite-moe-1b-a400m")
    mesh = P.make_mesh(COLL["moe_mesh"], ("data", "model"), device=device)
    m = mesh.shape["model"]
    p32 = {k: v.to(dev) for k, v in init_params(
        MoE.moe_spec(cfg), torch.Generator().manual_seed(SEED)).items()}
    x32 = torch.randn(*COLL["moe_tokens"], cfg.d_model,
                      generator=gen).to(dev)
    rep["moe"] = {}
    for dtype in (torch.float32, torch.bfloat16):
        p = {k: (v.float() if k == "router" else v.to(dtype))
             for k, v in p32.items()}
        x = x32.to(dtype)
        B, S, d = x.shape
        ref, logits, ids = MoE._moe_ffn_local(p, x.reshape(B * S, d), cfg)
        ref = ref.reshape(B, S, d)
        aux_ref = MoE.load_balance_loss(logits, ids, cfg.n_experts,
                                        cfg.top_k)
        ample = dataclasses.replace(cfg, capacity_factor=float(m))
        with P.set_mesh(mesh):
            t0 = time.perf_counter()
            tp, tp_aux = MoE.moe_apply(p, cfg, x)
            _sync_dev(dev)
            t1 = time.perf_counter()
            ep, ep_aux = MoE.moe_apply(p, ample, x, ep=True)
            _sync_dev(dev)
            t2 = time.perf_counter()
            ep125, _ = MoE.moe_apply(p, cfg, x, ep=True)
        n_loc = B * S // mesh.size
        i = C.axis_index(("data", "model"), mesh)
        e0 = C.axis_index("model", mesh) * (cfg.n_experts // m)
        pp = {"router": p["router"],
              **{w: p[w][e0:e0 + cfg.n_experts // m]
                 for w in ("wi_gate", "wi_up", "wo")}}
        # GShard's drops where the buckets overflow (capacity factor
        # COLL["cf_low"]): this rank's kept rows against a plain count,
        # first come first served per destination in flat order
        cap = max(1, math.ceil(n_loc * cfg.top_k / m * COLL["cf_low"]))
        x_loc = x.reshape(B * S, d)[i * n_loc:(i + 1) * n_loc]
        _, _, keep = MoE._moe_ep_shard(pp, x_loc, cfg, mesh=mesh,
                                       model_axis="model", capacity=cap)
        ids = MoE._route(p["router"], x_loc, cfg.top_k)[1]
        dest = ids.reshape(-1).cpu().numpy() // (cfg.n_experts // m)
        order = np.argsort(dest, kind="stable")
        first = np.searchsorted(dest[order], np.arange(m))
        pos = np.empty_like(dest)
        pos[order] = np.arange(dest.size) - first[dest[order]]
        name = str(dtype).split(".")[-1]
        grad_err = None
        if dtype == torch.float32:
            grad_err = _moe_grad_errs(MoE, P, p, x, cfg, ample, mesh, gen)
        rep["moe"][name] = {
            "grad_err": grad_err,
            "tp_s": t1 - t0, "ep_s": t2 - t1,
            "tp_err": _rel_to_max(tp, ref), "ep_err": _rel_to_max(ep, ref),
            "tp_aux_rel": abs(float(tp_aux) / float(aux_ref) - 1.0),
            "ep_aux_rel": abs(float(ep_aux) / float(aux_ref) - 1.0),
            "ep125_finite": bool(torch.isfinite(ep125).all()),
            "low_capacity": cap,
            "low_dropped_rows": int((~keep).sum().item()),
            "low_drops_exact": bool(np.array_equal(keep.cpu().numpy(),
                                                   pos < cap)),
            "experts": MoE.grouped_matmul.last_variant}

    # device_put_batch over data
    mesh = P.make_mesh((2, world // 2), ("pod", "data"), device=device)
    toks = np.arange(np.prod(COLL["batch"])).reshape(COLL["batch"])
    got = device_put_batch({"tokens": toks, "s": np.float32(2.0)}, mesh,
                           ("pod", "data"))
    n = COLL["batch"][0] // world
    rep["device_put_batch"] = {
        "exact": bool(np.array_equal(got["tokens"].cpu().numpy(),
                                     toks[rank * n:(rank + 1) * n])),
        "device": str(got["tokens"].device),
        "scalar_replicated": got["s"].shape == () and float(got["s"]) == 2.0}
    dist.barrier()
    rep["used"] = {"/".join(k): v for k, v in sorted(C.USED.items())}
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(rep, f)
    dist.destroy_process_group()
    return 0


def collectives_failures(reps):
    """Every check of every rank's report that fails, named."""
    bad = []
    for r in reps:
        k = r["rank"]
        pl, cp = r["pipeline"], r["compressed"]
        if pl["fwd_err"] > COLL_TOL["pipe_fwd"] \
                or pl["grad_err"] > COLL_TOL["pipe_grad"] \
                or pl["x_grad_err"] > COLL_TOL["pipe_grad"] \
                or pl["grad_outside_stage"] != 0.0:
            bad.append(f"rank {k} pipeline {pl}")
        if cp["deq_err"] > COLL_TOL["comp_deq"] \
                or cp["rel_to_exact"] > COLL_TOL["comp_rel"]:
            bad.append(f"rank {k} compressed {cp}")
        for dt, mo in r["moe"].items():
            tol = COLL_TOL["moe"][dt]
            if mo["tp_err"] > tol or mo["ep_err"] > tol \
                    or (mo["grad_err"] is not None and max(
                        e for g in mo["grad_err"].values()
                        for e in g.values()) > COLL_TOL["moe_grad"]) \
                    or mo["tp_aux_rel"] > COLL_TOL["aux_rel"] \
                    or mo["ep_aux_rel"] > COLL_TOL["aux_rel"] \
                    or not mo["ep125_finite"] or not mo["low_drops_exact"] \
                    or mo["low_dropped_rows"] < 1:
                bad.append(f"rank {k} moe {dt} {mo}")
        db = r["device_put_batch"]
        if not (db["exact"] and db["scalar_replicated"]
                and db["device"].startswith("cuda")):
            bad.append(f"rank {k} device_put_batch {db}")
        off = [u for u in r["used"] if not u.endswith("/cuda")]
        if off or not r["used"]:
            bad.append(f"rank {k} ran collectives off the card: {off}")
    return bad


def phase_collectives():
    """4 gloo ranks as subprocesses on cuda:0 (``collectives_rank``), each
    with its own time limit; their reports checked here."""
    import shutil
    import tempfile
    world = COLL["world"]
    workdir = tempfile.mkdtemp(prefix="chip_smoke_coll_")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--collectives-rank",
         str(r), "--world", str(world), "--workdir", workdir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    outs, timed_out = [], False
    deadline = time.perf_counter() + COLL["limit_s"]
    for p in procs:
        try:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.perf_counter())))
        except subprocess.TimeoutExpired:
            timed_out = True
            break
    if timed_out:
        for p in procs:
            p.kill()
        outs = [p.communicate() for p in procs]
    out = {"phase": "collectives", "ranks": world,
           "seconds": time.perf_counter() - t0,
           "card": "4 ranks sharing cuda:0 over gloo: no multi-GPU speed"}
    try:
        errs = [(r, p.returncode, e[-2000:]) for r, (p, (_, e))
                in enumerate(zip(procs, outs)) if p.returncode != 0]
        if timed_out or errs:
            out["errors"] = errs
            out["timed_out"] = timed_out
            emit(out)
            raise SystemExit("a collectives rank failed (gloo on CUDA "
                             "tensors, or a check): see errors")
        reps = []
        for r in range(world):
            with open(os.path.join(workdir, f"rank{r}.json")) as f:
                reps.append(json.load(f))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    out["backend"] = sorted({r["backend"] for r in reps})
    out["used"] = reps[0]["used"]
    out["rank0"] = {k: reps[0][k] for k in ("pipeline", "compressed", "moe",
                                            "device_put_batch")}
    out["tolerance"] = COLL_TOL
    bad = collectives_failures(reps)
    out["failures"] = bad
    emit(out)
    if bad:
        raise SystemExit("the collectives phase failed its checks")
    return out


# ---------------------------------------------------------------------------
# the GSPMD half of the training stack: 4 ranks sharing the card
# ---------------------------------------------------------------------------

# danube at full width on (data 2, model 2), TRAIN's shape and schedule
# (its lr at steps 1 and 2), onehot_loss as the train phase's; cut to 4 of
# its 24 layers for time (the script's 1,200 s limit; the train phase
# runs the full depth on one device), held to the same cut on one device
TRAIN_MESH = {**TRAIN, "mesh": (2, 2), "axes": ("data", "model"),
              "world": 4, "n_layers": 4, "mesh_steps": 2, "limit_s": 420,
              "timeout_s": 300}
TRAIN_MESH_LOSS_ATOL = 2e-2     # the reference's gate (test_distributed.py)
# at random init danube's loss sits at log V whatever the layers compute,
# and a norm barely moves when a rank is handed the wrong block: step 1's
# gradient leaves below (layers 0 and L-1 of the column-parallel wq /
# wi_gate and the row-parallel wo's), gathered whole on every rank, are held
# against one device's, ||g - g_one|| / ||g_one|| over them together
TRAIN_MESH_GRAD_LEAVES = ("blocks/attn/wq", "blocks/attn/wo",
                          "blocks/mlp/wi_gate", "blocks/mlp/wo")
TRAIN_MESH_GRAD_LAYERS = (0, -1)
TRAIN_MESH_GRAD_RTOL = TRAIN_GRAD_RTOL
TRAIN_MESH_GNORM_RTOL = 1e-3    # step 1's grad_norm, relative
TRAIN_MESH_FAULT_ARCH = TRAIN["arch"]     # planted faults at reduced size


def _train_lm_kwargs():
    from repro_torch.models.layers import AttnOptions
    return dict(opts=AttnOptions(backend="fused"), remat=True,
                onehot_loss=True)


# the routed experts' gradient leaves are kept for their first experts
# only (a whole (layers, 64, 2048, 1408) leaf is 1.5 GB in float32)
KEPT_EXPERTS = 4


def kept_grads(params, grads, leaves=TRAIN_MESH_GRAD_LEAVES) -> dict:
    """Step 1's gradient ``leaves`` (a stacked leaf, ``blocks/..``, at
    layers ``TRAIN_MESH_GRAD_LAYERS``, a routed expert leaf of those at its
    first ``KEPT_EXPERTS`` experts; any other whole) (``grads`` in
    ``params``' leaf order, as AdamW receives them): on one device float32
    copies on the host; placed, this rank's blocks (float32 copies on its
    device) with their specs and shapes, for ``gathered_grads``."""
    from repro_torch.checkpoint.store import _flatten_with_paths
    from repro_torch.parallel import placement as PL
    out = {}
    for (path, p), g in zip(_flatten_with_paths(params), grads):
        if path not in leaves:
            continue
        stacked = path.startswith("blocks/")
        experts = stacked and path.split("/")[-2:] in (
            ["moe", "wi_gate"], ["moe", "wi_up"], ["moe", "wo"])

        def pick(t):
            """The kept part of ``t``, by basic indexing only (a list
            index would copy it to the card, a copy that waits)."""
            if not stacked:
                return t
            return torch.stack([t[r, :KEPT_EXPERTS] if experts else t[r]
                                for r in TRAIN_MESH_GRAD_LAYERS])
        if not PL.is_placed(g):
            out[path] = pick(g.detach()).float().cpu()
            continue
        sp = tuple(PL.spec_of(g))
        if stacked and sp and sp[0] is not None:
            raise ValueError(f"{path}: its layers are split ({sp})")
        if experts and len(sp) > 1 and sp[1] is not None:
            raise ValueError(f"{path}: its experts are split ({sp})")
        loc = pick(PL.local(g).detach()).float().clone()
        shape = tuple(g.shape)
        if stacked:
            shape = (len(TRAIN_MESH_GRAD_LAYERS),) + (
                (KEPT_EXPERTS,) + shape[2:] if experts else shape[1:])
        out[path] = (loc, sp, shape, PL.mesh_of(g))
    return out


def gathered_grads(kept) -> dict:
    """``kept_grads``' placed blocks gathered whole on every rank."""
    from repro_torch.parallel import placement as PL
    return {p: PL.full_tensor(PL.from_block(loc, sp, mesh, shape))
            for p, (loc, sp, shape, mesh) in kept.items()}


def grads_vs(got, ref) -> dict:
    """``grads_gap`` of two ``{leaf: tensor}`` sets, and each leaf's."""
    paths = sorted(ref)
    dev = [got[p].device for p in paths]
    pairs = [(got[p], ref[p].to(d)) for p, d in zip(paths, dev)]
    out = grads_gap([a for a, _ in pairs], [b for _, b in pairs])
    out["per_leaf"] = {p: grads_gap([a], [b])["rel_l2"]
                       for p, (a, b) in zip(paths, pairs)}
    return out


class first_grads_kept:
    """Within it, the first AdamW update's gradient ``leaves`` are kept
    (``kept_grads``) in ``.kept``."""

    def __init__(self, leaves=TRAIN_MESH_GRAD_LEAVES):
        self.leaves = leaves

    def __enter__(self):
        import repro_torch.runtime.train as RTM
        self.kept, self._update = {}, RTM.adamw.update

        def keep(cfg_, grads, state, params):
            if not self.kept:
                self.kept.update(kept_grads(params, grads, self.leaves))
            return self._update(cfg_, grads, state, params)
        RTM.adamw.update = keep
        return self

    def __exit__(self, *exc):
        import repro_torch.runtime.train as RTM
        RTM.adamw.update = self._update


def one_device_grads(cfg, shape, spec, device) -> dict:
    """Step 1's kept gradient leaves of the same run on one device (the
    same seed, weights and batch): the reduced runs' reference."""
    tr = _mesh_trainer(cfg, shape, None, spec, 10, device=device)
    with first_grads_kept() as fk:
        tr.run(1)
    return fk.kept


def placement_failures(params, full, mesh) -> list:
    """The leaves whose block here is not the slice of ``full`` (the same
    tree, unsharded) that their spec names."""
    from repro_torch.checkpoint.store import _flatten_with_paths
    from repro_torch.parallel import placement as PL
    whole = dict(_flatten_with_paths(full))
    return [p for p, t in _flatten_with_paths(params)
            if not torch.equal(PL.local(t), PL.local_block(
                whole[p], PL.spec_of(t), mesh))]


def peer_gap(params, mesh, axes) -> float:
    """max |difference| between the blocks this rank's peers along the
    batch ``axes`` hold (they hold the same block: 0 bit for bit)."""
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import placement as PL
    from repro_torch.models.params import tree_leaves
    gap = 0.0
    for t in tree_leaves(params, torch.is_tensor):
        x = PL.local(t).detach()
        for a in axes:
            parts = C._all_gather(x, mesh.group(a), mesh.shape[a])
            gap = max(gap, float((parts.float() - x.float()).abs().max()))
    return gap


def _mesh_trainer(cfg, shape, mesh, spec, steps_total, device=None,
                  plan=None):
    """The phase's trainer on ``mesh`` (``None``: one ``device``), under
    ``plan`` (the default one by default)."""
    from repro_torch.optim import adamw
    from repro_torch.runtime.train import TrainConfig, Trainer
    tc = TrainConfig(accum=spec["accum"], log_every=1, ckpt_every=0,
                     monitor_every=2,
                     opt=adamw.AdamWConfig(lr=spec["lr"],
                                           warmup_steps=spec["warmup"],
                                           total_steps=steps_total))
    kw = {} if device is None else {"device": device}
    return Trainer(cfg, shape, mesh=mesh, tc=tc, plan=plan,
                   lm_kwargs=_train_lm_kwargs(), seed=SEED, **kw)


def mesh_planted_faults(mesh) -> dict:
    """The two faults the phase's checks must reject, at reduced size:
    rank 0 keeping its own gradient (it joins the reduce and drops the sum:
    its parameters leave its data peer's), and rank 1 handed its model
    neighbour's block of one weight (the placement check, and step 1's
    gradient leaves against one device's: ``grads_vs``)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.layers import batch_axes
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import placement as PL
    cfg = get_config(TRAIN_MESH_FAULT_ARCH).reduced()
    shape = ShapeConfig("tiny", 64, 4, "train")
    spec = {**TRAIN_MESH, "accum": 1}
    me = C.axis_index(mesh.axis_names, mesh)
    out = {}
    one = one_device_grads(cfg, shape, spec, mesh.device)
    # the control: the same run without a fault
    tr = _mesh_trainer(cfg, shape, mesh, spec, 10)
    with first_grads_kept() as fk:
        tr.run(1)
    out["control_peer_gap"] = peer_gap(tr.params, mesh, batch_axes(mesh))
    out["control_grad_rel_l2"] = grads_vs(gathered_grads(fk.kept),
                                          one)["rel_l2"]
    # rank 0 keeps its own gradient
    real = C.sum_into

    def keeps_own(x, axis, mesh=None):
        if x.numel() > 16:                # a gradient, not a norm or metric
            real(x.clone(), axis, mesh)
            return x
        return real(x, axis, mesh)
    tr = _mesh_trainer(cfg, shape, mesh, spec, 10)
    C.sum_into = keeps_own if me == 0 else real
    try:
        tr.run(1)
    finally:
        C.sum_into = real
    out["skipped_reduce_peer_gap"] = peer_gap(tr.params, mesh,
                                              batch_axes(mesh))
    # rank 1 holds its model neighbour's block of one weight
    tr = _mesh_trainer(cfg, shape, mesh, spec, 10)
    full = tr.lm.init(torch.Generator(device=mesh.device).manual_seed(SEED))
    leaf = tr.params["blocks"]["mlp"]["wi_gate"]
    if me == 1:
        n, c = mesh.shape["model"], mesh.coord("model")
        f = full["blocks"]["mlp"]["wi_gate"]
        step = f.shape[-1] // n
        wrong = f.narrow(-1, ((c + 1) % n) * step, step).contiguous()
        tr.params["blocks"]["mlp"]["wi_gate"] = PL.like_placed(wrong, leaf)
    out["neighbour_slice_failures"] = placement_failures(tr.params, full,
                                                         mesh)
    with first_grads_kept() as fk:
        tr.run(1)
    out["neighbour_slice_grad_rel_l2"] = grads_vs(gathered_grads(fk.kept),
                                                  one)["rel_l2"]
    return out


def train_mesh_rank(rank, world, workdir, device="cuda", reduced=False):
    """One rank of phase ``train_mesh``: danube at full width on (data 2,
    model 2) through ``Trainer(mesh=)``, 2 steps, step 1's gradient leaves
    held against one device's (``train_mesh_one_device``'s, in
    ``workdir/one_device_grads.pt``); its report written to
    ``workdir/rank<rank>.json`` (``device`` "cpu" with ``reduced`` only to
    rehearse the phase's code away from the card: its one-device leaves
    then come from a run of its own)."""
    import torch.distributed as dist
    from repro_torch import parallel as P
    from repro_torch.checkpoint.store import CheckpointStore, \
        _flatten_with_paths
    from repro_torch.core.replication import merged_rules
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_mlp as FM
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as REF
    from repro_torch.launch.costing import _Collectives
    from repro_torch.models.layers import batch_axes
    from repro_torch.models.params import shardings_for
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import placement as PL
    spec = TRAIN_MESH
    backend = C.init_process_group(
        rank, world, "file://" + os.path.join(workdir, "store"),
        device=device, timeout_s=spec["timeout_s"])
    mesh = P.make_mesh(spec["mesh"], spec["axes"], device=device)
    rep = {"rank": rank, "backend": backend, "device": str(mesh.device),
           "coords": {a: mesh.coord(a) for a in mesh.axis_names},
           "marks_s": {}}
    t_rank = time.perf_counter()

    def mark(name):                     # seconds since the group formed
        rep["marks_s"][name] = time.perf_counter() - t_rank

    # the plain versions on CUDA tensors: never in place of a kernel (the
    # forward runs with grad off, inside the autograd Function); the MLP's
    # backward is its oracle's autograd, which is the plain version (grad
    # on), counted apart; the attention's oracle is attention_naive
    plain_cuda = {"flash_attention": 0, "fused_mlp": 0}
    oracle_cuda = {"flash_attention": 0, "fused_mlp": 0}

    def counting(name, fn):
        def f(*a, **k):
            if any(torch.is_tensor(x) and x.is_cuda for x in a):
                (oracle_cuda if torch.is_grad_enabled()
                 else plain_cuda)[name] += 1
            return fn(*a, **k)
        return f
    FA.flash_attention_plain = counting("flash_attention",
                                        FA.flash_attention_plain)
    FM.fused_rmsnorm_mlp_plain = counting("fused_mlp",
                                          FM.fused_rmsnorm_mlp_plain)
    # the MLP's oracle reads the plain version through its own name
    REF.fused_rmsnorm_mlp_plain = FM.fused_rmsnorm_mlp_plain

    cfg = _cut(spec["arch"], spec["n_layers"], reduced)
    shape = _train_mesh_shape(reduced)
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = _mesh_trainer(cfg, shape, mesh, spec, TRAIN["steps"])
    empty_cache(sync_only=True)
    rep["init_s"] = time.perf_counter() - t0
    full = tr.lm.init(torch.Generator(device=mesh.device).manual_seed(SEED))
    rep["placement_failures"] = placement_failures(tr.params, full, mesh)
    del full
    empty_cache()
    mark("placed_and_checked")
    rep["local_params"] = sum(PL.local(t).numel() for t in
                              _leaves(tr.params))

    K = {"flash_attention": FA.flash_attention,
         "fused_mlp": FM.fused_rmsnorm_mlp}
    step_fn, times, syncs, stats, calls = tr._step, [], [], {}, []

    def timed(*a):
        empty_cache(sync_only=True)
        dist.barrier()
        n0 = sum(C.USED.values())
        t = time.perf_counter()
        if not times and cuda:          # step 1: host syncs counted
            with SyncCount() as sc:
                out = step_fn(*a)
            syncs.append(sc.total)
        elif not times:
            out = step_fn(*a)
        else:                           # step 2: its collectives counted
            mode = _Collectives()
            with mode:
                out = step_fn(*a)
            stats.update(collective_bytes=sum(mode.per_op.values()),
                         per_op_bytes=dict(mode.per_op),
                         op_counts=dict(mode.counts))
        empty_cache(sync_only=True)
        times.append(time.perf_counter() - t)
        calls.append(sum(C.USED.values()) - n0)
        dist.barrier()
        return out

    tr._step = timed
    for f in K.values():                        # counted from here ...
        f.launches = 0
    ops.reset_counts()
    for d in (plain_cuda, oracle_cuda):
        d.update({n: 0 for n in d})
    C.USED.clear()
    with first_grads_kept() as fk:
        hist = tr.run(spec["mesh_steps"])
    launches = {n: f.launches for n, f in K.items()}   # ... to here
    mlp_backward = ops.FusedRMSNormMLP.backward_calls
    rep["attention_heads_per_group"] = ops.FlashAttention.last_heads
    plain_run, oracle_run = dict(plain_cuda), dict(oracle_cuda)
    mark("steps")
    tr._step = step_fn
    got = gathered_grads(fk.kept)
    del fk
    one = (one_device_grads(cfg, shape, spec, mesh.device) if reduced else
           torch.load(os.path.join(workdir, "one_device_grads.pt"),
                      map_location=mesh.device))
    rep["step1_grad"] = grads_vs(got, one)
    del got, one
    empty_cache()
    mark("step1_grad")
    rep.update(
        losses=[m["loss"] for _, m in hist],
        grad_norms=[m["grad_norm"] for _, m in hist],
        lrs=[m["lr"] for _, m in hist], step_s=times, syncs_per_step=syncs,
        gloo_calls_per_step=calls,
        collective_stats_step2=stats, launches=launches,
        variants={n: f.last_variant for n, f in K.items()},
        plain_on_cuda=plain_run, backward_oracle_on_cuda=oracle_run,
        mlp_backward_calls=mlp_backward,
        peak_gib=(torch.cuda.max_memory_allocated() / 2**30 if cuda
                  else None),
        used={"/".join(k): v for k, v in sorted(C.USED.items())})
    rep["peer_gap"] = peer_gap(tr.params, mesh, batch_axes(mesh))
    mark("peer_gap")

    # elastic restore: save, then (model 4) on the same ranks and whole on
    # rank 0, each against the saved state leaf by leaf
    tr.opt_state = None
    empty_cache()
    store = CheckpointStore(os.path.join(workdir, "ckpt"), level=0)
    t0 = time.perf_counter()
    store.save(tr.step, {"params": tr.params})
    rep["save_s"] = time.perf_counter() - t0
    mesh4 = P.make_mesh((4,), ("model",), device=device)
    like = {"params": tr.lm.abstract()}
    sh4 = {"params": shardings_for(tr.lm.param_specs(),
                                   merged_rules(tr.plan, mesh4), mesh4)}
    t0 = time.perf_counter()
    r4 = dict(_flatten_with_paths(store.restore(like, shardings=sh4)))
    rep["restore_model4_s"] = time.perf_counter() - t0
    whole = None
    if rank == 0:
        t0 = time.perf_counter()
        whole = dict(_flatten_with_paths(store.restore(like,
                                                       device=mesh.device)))
        rep["restore_one_s"] = time.perf_counter() - t0
    bad4, bad1, split4 = [], [], 0
    for p, t in _flatten_with_paths({"params": tr.params}):
        f = PL.full_tensor(t)
        s4 = PL.spec_of(r4[p])
        split4 += any(e is not None for e in s4)
        if not torch.equal(PL.local(r4[p]), PL.local_block(f, s4, mesh4)):
            bad4.append(p)
        if whole is not None and not torch.equal(whole[p], f):
            bad1.append(p)
        del f
    mark("elastic")
    rep["elastic"] = {"model4_mismatch": bad4, "one_rank_mismatch": bad1,
                      "model4_split_leaves": split4,
                      "one_rank_checked": whole is not None}
    del r4, whole
    tr.params = None
    empty_cache()
    rep["planted"] = mesh_planted_faults(mesh)
    mark("planted")
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(rep, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def empty_cache(sync_only=False) -> None:
    """Wait for the card (and return its cached blocks); nothing on a CPU
    rehearsal."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        if not sync_only:
            torch.cuda.empty_cache()


def train_mesh_failures(reps, single) -> list:
    """Every check of phase ``train_mesh`` that fails, named."""
    spec = TRAIN_MESH
    n_steps = spec["mesh_steps"]
    want = 2 * spec["accum"] * spec["n_layers"] * n_steps
    bad = []
    r0 = reps[0]
    l1, l2 = r0["losses"][0], r0["losses"][1]
    if not (abs(l1 - single["losses"][0]) <= TRAIN_MESH_LOSS_ATOL
            and abs(l2 - single["losses"][1]) <= TRAIN_MESH_LOSS_ATOL):
        bad.append(f"losses {r0['losses']} vs one device "
                   f"{single['losses'][:2]}")
    g, g1 = r0["grad_norms"][0], single["grad_norms"][0]
    if not abs(g - g1) <= TRAIN_MESH_GNORM_RTOL * abs(g1):
        bad.append(f"step 1 grad_norm {g} vs one device {g1}")
    for r in reps:
        k = r["rank"]
        if not r["step1_grad"]["rel_l2"] <= TRAIN_MESH_GRAD_RTOL:
            bad.append(f"rank {k}'s step 1 gradient vs one device: "
                       f"{r['step1_grad']}")
        if r["losses"] != r0["losses"] or \
                r["grad_norms"] != r0["grad_norms"]:
            bad.append(f"rank {k}'s metrics differ from rank 0's")
        if any(v != want for v in r["launches"].values()):
            bad.append(f"rank {k} launches {r['launches']}, not {want}")
        if any(v != "wgmma_tma" for v in r["variants"].values()):
            bad.append(f"rank {k} variants {r['variants']}")
        if any(r["plain_on_cuda"].values()):
            bad.append(f"rank {k} ran a plain version on CUDA tensors: "
                       f"{r['plain_on_cuda']}")
        # the MLP's backward is its oracle's autograd, once a backward;
        # the attention's oracle is the reference's, not the plain version
        if r["backward_oracle_on_cuda"] != {
                "flash_attention": 0, "fused_mlp": r["mlp_backward_calls"]}:
            bad.append(f"rank {k} backward oracle calls on CUDA tensors "
                       f"{r['backward_oracle_on_cuda']}, not the MLP's "
                       f"{r['mlp_backward_calls']} backward calls")
        off = [u for u in r["used"] if not u.endswith("/gloo/cuda")]
        if off or not r["used"]:
            bad.append(f"rank {k} collectives off gloo/cuda: {off}")
        if r["placement_failures"]:
            bad.append(f"rank {k} placement {r['placement_failures']}")
        if r["peer_gap"] != 0.0:
            bad.append(f"rank {k}'s blocks differ from its data peer's "
                       f"({r['peer_gap']})")
        el = r["elastic"]
        if el["model4_mismatch"] or el["one_rank_mismatch"] \
                or el["model4_split_leaves"] < 1:
            bad.append(f"rank {k} elastic restore {el}")
        if r["planted"]["control_peer_gap"] != 0.0 or \
                not r["planted"]["control_grad_rel_l2"] \
                <= TRAIN_MESH_GRAD_RTOL:
            bad.append(f"rank {k}: the unfaulted reduced run diverged")
    if not any(r["elastic"]["one_rank_checked"] for r in reps):
        bad.append("no rank restored the parameters whole")
    if not any(r["planted"]["skipped_reduce_peer_gap"] > 0 for r in reps):
        bad.append("a rank keeping its own gradient passed the check")
    if not any(r["planted"]["neighbour_slice_failures"] for r in reps):
        bad.append("a neighbour's slice passed the placement check")
    if not all(r["planted"]["neighbour_slice_grad_rel_l2"]
               > TRAIN_MESH_GRAD_RTOL for r in reps):
        bad.append("a neighbour's slice passed the gradient check")
    return bad


def _train_mesh_shape(reduced=False):
    from repro_torch.configs.base import ShapeConfig
    spec = TRAIN_MESH
    if reduced:
        return ShapeConfig("tiny", 64, 4, "train")
    return ShapeConfig("train_4k", spec["seq_len"], spec["global_batch"],
                       "train")


def train_mesh_one_device(device=DEV) -> dict:
    """The numbers ``train_mesh``'s ranks are held to: the same cut of
    danube, seed, weights and batches through the same ``Trainer`` on one
    device, 2 steps (losses, grad norms, step 1's kept gradient leaves)."""
    spec = TRAIN_MESH
    t0 = time.perf_counter()
    tr = _mesh_trainer(_cut(spec["arch"], spec["n_layers"]),
                       _train_mesh_shape(), None, spec, TRAIN["steps"],
                       device=device)
    with first_grads_kept() as fk:
        hist = tr.run(spec["mesh_steps"])
    out = {"losses": [m["loss"] for _, m in hist],
           "grad_norms": [m["grad_norm"] for _, m in hist],
           "step1_grads": fk.kept, "seconds": time.perf_counter() - t0}
    del tr, fk
    empty_cache()
    return out


def phase_train_mesh(smi, single=None):
    """4 gloo ranks as subprocesses on cuda:0 (``train_mesh_rank``) under
    a hard limit, held to ``train_mesh_one_device`` (the one-device
    numbers on the same seed, weights and batches: ``single`` where the
    caller has them).  Prints the price of four ranks sharing one card, not
    a multi-GPU speed."""
    import gc
    import shutil
    import tempfile
    spec = TRAIN_MESH
    single = dict(single or train_mesh_one_device())
    gc.collect()
    torch.cuda.empty_cache()
    parent = {"allocated_gib": torch.cuda.memory_allocated() / 2**30,
              "reserved_gib": torch.cuda.memory_reserved() / 2**30}
    world = spec["world"]
    workdir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    torch.save(single["step1_grads"],
               os.path.join(workdir, "one_device_grads.pt"))
    # four ranks' state and activations fill the card: no room is lost to
    # the allocator's fragmentation
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--train-mesh-rank",
         str(r), "--world", str(world), "--workdir", workdir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(world)]
    outs, timed_out = [], False
    deadline = time.perf_counter() + spec["limit_s"]
    for p in procs:
        try:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.perf_counter())))
        except subprocess.TimeoutExpired:
            timed_out = True
            break
    if timed_out:
        for p in procs:
            p.kill()
        outs = [p.communicate() for p in procs]
    out = {"phase": "train_mesh", "ranks": world,
           "mesh": dict(zip(spec["axes"], spec["mesh"])),
           "arch": spec["arch"], "layers": spec["n_layers"],
           "seconds": time.perf_counter() - t0,
           "one_device_s": single["seconds"],
           "nvidia_smi": smi, "parent_memory": parent,
           "card": "4 ranks sharing one H100 over gloo: the price of "
                   "sharing the card, not a multi-GPU speed"}
    try:
        errs = [(r, p.returncode, e[-3000:]) for r, (p, (_, e))
                in enumerate(zip(procs, outs)) if p.returncode != 0]
        if timed_out or errs:
            out["errors"] = errs
            out["timed_out"] = timed_out
            emit(out)
            raise SystemExit("a train_mesh rank failed: see errors")
        reps = []
        for r in range(world):
            with open(os.path.join(workdir, f"rank{r}.json")) as f:
                reps.append(json.load(f))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    r0 = reps[0]
    tokens = spec["global_batch"] * spec["seq_len"]
    out.update({
        "losses": r0["losses"], "grad_norms": r0["grad_norms"],
        "one_device": {"losses": single["losses"][:2],
                       "grad_norm": single["grad_norms"][0]},
        "loss_err": [abs(a - b) for a, b in zip(r0["losses"],
                                                single["losses"])],
        "loss_atol": TRAIN_MESH_LOSS_ATOL,
        "grad_norm_rel_err": abs(r0["grad_norms"][0]
                                 - single["grad_norms"][0])
        / abs(single["grad_norms"][0]),
        "grad_norm_rtol": TRAIN_MESH_GNORM_RTOL,
        "step1_grad_by_rank": [r["step1_grad"] for r in reps],
        "grad_rtol": TRAIN_MESH_GRAD_RTOL,
        "step_s": r0["step_s"],
        "tokens_per_s": [tokens / s for s in r0["step_s"]],
        "step2_under_collective_counter": True,
        "peak_gib_by_rank": [r["peak_gib"] for r in reps],
        "init_s_by_rank": [r["init_s"] for r in reps],
        "local_params_by_rank": [r["local_params"] for r in reps],
        "collective_stats_step2": r0["collective_stats_step2"],
        # torch's sync-debug mode does not see gloo's copies (its C++
        # backend moves CUDA tensors through the host); each gloo call on
        # CUDA tensors waits for the card
        "host_syncs_step1": r0["syncs_per_step"],
        "gloo_calls_per_step": r0["gloo_calls_per_step"],
        "launches_by_rank": [r["launches"] for r in reps],
        "backward_oracle_calls": r0["backward_oracle_on_cuda"],
        "attention_heads_per_group": [r["attention_heads_per_group"]
                                      for r in reps],
        "mlp_backward_calls": r0["mlp_backward_calls"],
        "variants": r0["variants"], "used": r0["used"],
        "save_s": r0["save_s"], "restore_model4_s": r0["restore_model4_s"],
        "restore_one_s": r0.get("restore_one_s"),
        "elastic": r0["elastic"], "rank0_marks_s": r0["marks_s"],
        "planted": [r["planted"] for r in reps]})
    bad = train_mesh_failures(reps, single)
    out["failures"] = bad
    emit(out)
    if bad:
        raise SystemExit("train_mesh: " + "; ".join(bad))
    return out


# ---------------------------------------------------------------------------
# the paper's multi-replica tile on the LLM stack: 4 ranks sharing the card
# ---------------------------------------------------------------------------

# (data 1, replica 2, shard 2): train_mesh's danube cut, tokens, accum and
# remat, the attention tile replicated twice (mra2-attn: its weights over
# shard, each replica rank on its own rows of the stream, the gradients of
# its leaves summed over replica) beside the K = 1 MLP over (replica,
# shard) on the replica group's rows; 2 training steps held to train_mesh's
# one-device run within train_mesh's gates, then a prefill of 4 slots (the
# ring wraps) and 8 teacher-forced decode steps held to one device within
# mesh_families' gates.  Step 1's collectives, read on these ranks, must be
# the fake mesh's count of the same step (launch.costing.
# placed_step_count, in the parent: no process group there).  Planted at
# reduced size: both replica ranks fed the same rows, and the replica
# reduce of the replicated leaves skipped
MESH_MRA = {**TRAIN_MESH, "mesh": (1, 2, 2),
            "axes": ("data", "replica", "shard"), "strategy": "mra2-attn",
            "prompt": 4608, "window": 4096, "decode_steps": 8,
            "limit_s": 420, "timeout_s": 300}


def _mra_plan(cfg):
    """The dry run's plan for ``MESH_MRA``'s strategy."""
    from repro_torch.launch import dryrun as D
    return D.cell_plan(cfg, D.CellOptions(strategy=MESH_MRA["strategy"]))


def _mra_serve_shape(reduced):
    """(prompt length, window, decode steps)."""
    spec = MESH_MRA
    return (12, 16, 4) if reduced else (spec["prompt"], spec["window"],
                                        spec["decode_steps"])


def mra_one_device_serve(workdir, device=DEV, reduced=False) -> dict:
    """The serving numbers ``mesh_mra``'s ranks are held to: the cut
    danube on ``device`` from the seed, 4 prompts prefilled and greedily
    decoded (tokens and float32 logits written to ``workdir``)."""
    from repro_torch.models.transformer import LM
    S, W, steps = _mra_serve_shape(reduced)
    cfg = _cut(MESH_MRA["arch"], MESH_MRA["n_layers"], reduced)
    lm = LM(cfg, **_families_lm_kwargs())
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(device=device).manual_seed(SEED))
    rng = np.random.default_rng(SEED + 1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, S)),
                           device=device)
    logits = []
    with torch.no_grad():
        lg, cache = lm.prefill(params, toks, cache_len=W)
        for _ in range(steps):
            nxt = torch.argmax(lg, -1)[:, None]
            toks = torch.cat([toks, nxt], 1)
            logits.append(lg.cpu())
            lg, cache = lm.decode_step(params, cache, nxt)
        logits.append(lg.cpu())
    torch.save({"tokens": toks.cpu(), "logits": torch.stack(logits)},
               os.path.join(workdir, "serve_mra.pt"))
    del params, cache, lg, lm
    empty_cache()
    return {"seconds": time.perf_counter() - t0, "prompt": S, "window": W,
            "steps": steps}


def replica_gap(params, mesh) -> float:
    """``peer_gap`` over ``replica`` of the leaves not split over it (the
    replicated tile's, and those every rank holds whole): 0 bit for bit."""
    from repro_torch.parallel import placement as PL
    kept = [t for t in _leaves(params) if "replica" not in
            [a for e in PL.spec_of(t) for a in PL.entry_axes(e)]]
    return peer_gap(kept, mesh, ("replica",))


def _rows_of(t) -> list:
    """Token rows as tuples (a tile's rows, compared by content)."""
    return [tuple(r) for r in t.detach().cpu().tolist()]


def mra_planted_faults(mesh) -> dict:
    """The two faults the phase's checks must reject, at reduced size,
    with a control run: both replica ranks fed replica rank 0's rows, and
    the replica reduce of the replicated tile's gradients skipped; each
    run's step 1 gradient leaves against one device's, the rows each tile
    ran on, and the gap between the replica peers' blocks after it."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import device_put_batch
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import group_axes
    import repro_torch.runtime.train as RTM
    cfg = get_config(TRAIN_MESH_FAULT_ARCH).reduced()
    shape = ShapeConfig("tiny", 64, 4, "train")
    spec = {**MESH_MRA, "accum": 1}
    plan = _mra_plan(cfg)
    one = one_device_grads(cfg, shape, spec, mesh.device)
    out = {}

    def run(tag, tr):
        with first_grads_kept() as fk, T.recording_rows() as rows:
            tr.run(1)
        out[tag] = {"grad_rel_l2": grads_vs(gathered_grads(fk.kept),
                                            one)["rel_l2"],
                    "replica_gap": replica_gap(tr.params, mesh),
                    "rows": {k: _rows_of(v) for k, v in rows.items()}}
    run("control", _mesh_trainer(cfg, shape, mesh, spec, 10, plan=plan))
    # both replica ranks fed replica rank 0's rows
    tr = _mesh_trainer(cfg, shape, mesh, spec, 10, plan=plan)

    def same_rows(np_batch):
        got = device_put_batch(np_batch, mesh, group_axes(mesh))
        n = mesh.shape["replica"]
        return {k: v[:v.shape[0] // n] for k, v in got.items()}
    tr.place_batch = same_rows
    run("same_rows", tr)
    # the replicated leaves' gradients not summed over replica
    grad_axes = RTM.grad_axes
    RTM.grad_axes = lambda lm, m: [tuple(a for a in ax if a != "replica")
                                   for ax in grad_axes(lm, m)]
    try:
        run("no_replica_reduce",
            _mesh_trainer(cfg, shape, mesh, spec, 10, plan=plan))
    finally:
        RTM.grad_axes = grad_axes
    return out


def mesh_mra_rank(rank, world, workdir, device="cuda", reduced=False):
    """One rank of phase ``mesh_mra`` (``MESH_MRA``'s notes): the training
    steps, step 1's collectives and gradient leaves, the rows each tile ran
    on, the placed prefill and decode, the planted faults; its report
    written to ``workdir/rank<rank>.json`` (``device`` "cpu" with
    ``reduced`` only to rehearse the phase's code away from the card)."""
    import torch.distributed as dist
    from repro_torch import parallel as P
    from repro_torch.checkpoint.store import _flatten_with_paths
    from repro_torch.core.replication import merged_rules, split_kinds
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import ops
    from repro_torch.launch.costing import _Collectives
    from repro_torch.models import transformer as T
    from repro_torch.models.params import place_params, shardings_for
    from repro_torch.models.transformer import LM
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import placement as PL
    spec = MESH_MRA
    backend = C.init_process_group(
        rank, world, "file://" + os.path.join(workdir, "store"),
        device=device, timeout_s=spec["timeout_s"])
    mesh = P.make_mesh(spec["mesh"], spec["axes"], device=device)
    cuda = mesh.device.type == "cuda"
    rep = {"rank": rank, "backend": backend, "device": str(mesh.device),
           "coords": {a: mesh.coord(a) for a in mesh.axis_names},
           "reduced": reduced}
    K = all_kernels()
    plain = {}
    undo = _count_plain_on_cuda(plain)

    def reset():
        for f in K.values():
            f.launches = 0
        FD.flash_decode.lse_launches = 0
        ops.reset_counts()
        plain.clear()
        C.USED.clear()

    cfg = _cut(spec["arch"], spec["n_layers"], reduced)
    plan = _mra_plan(cfg)
    shape = _train_mesh_shape(reduced)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = _mesh_trainer(cfg, shape, mesh, spec, TRAIN["steps"], plan=plan)
    empty_cache(sync_only=True)
    rep["init_s"] = time.perf_counter() - t0
    rep["mra_split"] = list(tr.lm.mra_split)
    rep["rows_axes"] = list(tr.lm.rows_axes(mesh))
    rep["specs"] = {p: repr(PL.spec_of(t)) for p, t in
                    _flatten_with_paths(tr.params)
                    if p in ("blocks/attn/wq", "blocks/mlp/wi_gate")}
    rep["local_shapes"] = {p: list(PL.local(t).shape) for p, t in
                           _flatten_with_paths(tr.params)
                           if p in ("blocks/attn/wq", "blocks/mlp/wi_gate")}
    step_fn, times, stats = tr._step, [], {}

    def timed(*a):
        empty_cache(sync_only=True)
        dist.barrier()
        t = time.perf_counter()
        if not times:                   # step 1: its collectives counted
            mode = _Collectives()
            with mode:
                out = step_fn(*a)
            stats.update(collective_bytes=sum(mode.per_op.values()),
                         per_op_bytes=dict(mode.per_op),
                         op_counts=dict(mode.counts))
        else:
            out = step_fn(*a)
        empty_cache(sync_only=True)
        times.append(time.perf_counter() - t)
        dist.barrier()
        return out
    tr._step = timed
    reset()
    with first_grads_kept() as fk, T.recording_rows() as rows:
        hist = tr.run(spec["mesh_steps"])
    rep["rows"] = {k: _rows_of(v[:, :16]) for k, v in rows.items()}
    del rows
    tr._step = step_fn
    rep.update(losses=[m["loss"] for _, m in hist],
               grad_norms=[m["grad_norm"] for _, m in hist], step_s=times,
               collective_stats_step1=stats,
               launches={k: f.launches for k, f in K.items()},
               variants={k: getattr(f, "last_variant", None)
                         for k, f in K.items()},
               oracle_calls={k: v for k, v in {
                   "fused_mlp.oracle": ops.FusedRMSNormMLP.backward_calls
               }.items() if v},
               plain_on_cuda=dict(plain),
               used={"/".join(k): v for k, v in sorted(C.USED.items())},
               train_peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                               if cuda else None))
    got = gathered_grads(fk.kept)
    del fk
    one = (one_device_grads(cfg, shape, spec, mesh.device) if reduced else
           torch.load(os.path.join(workdir, "one_device_grads.pt"),
                      map_location=mesh.device))
    rep["step1_grad"] = grads_vs(got, one)
    rep["replica_gap"] = replica_gap(tr.params, mesh)
    del got, one, tr
    empty_cache()
    dist.barrier()

    # serving: the cut danube from the seed, placed, this rank's rows
    S, W, steps = _mra_serve_shape(reduced)
    lm = LM(cfg, **_families_lm_kwargs(), mra_split=split_kinds(plan, mesh))
    params = place_params(
        lm.init(torch.Generator(device=mesh.device).manual_seed(SEED)),
        shardings_for(lm.param_specs(), merged_rules(plan, mesh), mesh))
    empty_cache()
    ref = torch.load(os.path.join(workdir, "serve_mra.pt"))
    ax = lm.rows_axes(mesh)
    B = ref["tokens"].shape[0] // C.axis_size(ax, mesh)
    r0 = C.axis_index(ax, mesh) * B
    toks = ref["tokens"][r0:r0 + B].to(mesh.device)
    want = ref["logits"][:, r0:r0 + B]
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    worst, agree, finite, calls = 0.0, 0, True, 0
    reset()
    dist.barrier()
    t0 = time.perf_counter()
    with torch.no_grad():
        with T.recording_rows() as rows:
            lg, cache = lm.prefill(params, toks[:, :S], cache_len=W)
        empty_cache(sync_only=True)
        prefill_s = time.perf_counter() - t0
        serve_rows = {k: _rows_of(v[:, :16]) for k, v in rows.items()}
        t1 = time.perf_counter()
        for i in range(steps + 1):
            if i:
                lg, cache = lm.decode_step(params, cache,
                                           toks[:, S + i - 1:S + i])
            w = want[i].to(lg.device)
            finite &= bool(torch.isfinite(lg).all())
            for b in range(B):
                worst = max(worst, _err(lg[b], w[b])
                            / float(w[b].abs().max()))
            agree += int((torch.argmax(lg, -1).cpu()
                          == torch.argmax(w, -1).cpu()).sum())
            calls += B
        empty_cache(sync_only=True)
    rep["serve"] = {
        "layers": cfg.n_layers, "prompt": S, "window": W,
        "decode_steps": steps, "rows": r0, "prefill_s": prefill_s,
        "decode_s_per_step": (time.perf_counter() - t1) / max(steps, 1),
        "max_rel_logit_err": worst, "agreed": agree, "positions": calls,
        "finite": finite, "prefill_rows": serve_rows,
        "cache_spec": repr(PL.spec_of(cache["blocks"][0])),
        "launches": {k: f.launches for k, f in K.items()},
        "lse_launches": FD.flash_decode.lse_launches,
        "variants": {k: getattr(f, "last_variant", None)
                     for k, f in K.items()},
        "plain_on_cuda": dict(plain),
        "used": {"/".join(k): v for k, v in sorted(C.USED.items())},
        "peak_gib": (torch.cuda.max_memory_allocated() / 2**30 if cuda
                     else None)}
    del params, cache, lg, ref, want, lm
    empty_cache()
    dist.barrier()
    rep["planted"] = mra_planted_faults(mesh)
    undo()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(rep, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def mra_fake_count(reduced=False) -> dict:
    """Step 1 of ``mesh_mra``'s training counted on a fake process group of
    its mesh's shape (``launch.costing.placed_step_count``: the same model,
    plan, rules, microbatches and rows a rank): run where no process group
    is (the parent)."""
    from repro_torch.core.replication import split_kinds
    from repro_torch.launch.costing import placed_step_count
    from repro_torch.launch.mesh import counting_mesh
    from repro_torch.models.transformer import LM
    from repro_torch.optim import adamw
    from repro_torch.runtime.train import TrainConfig
    spec = MESH_MRA
    cfg = _cut(spec["arch"], spec["n_layers"], reduced)
    shape = _train_mesh_shape(reduced)
    plan = _mra_plan(cfg)
    tc = TrainConfig(accum=spec["accum"],
                     opt=adamw.AdamWConfig(lr=spec["lr"]))
    t0 = time.perf_counter()
    with counting_mesh(spec["mesh"], spec["axes"]) as pm:
        lm = LM(cfg, **_train_lm_kwargs(), mra_split=split_kinds(plan, pm))
        c = placed_step_count(lm, "train", shape.global_batch, shape.seq_len,
                              pm, plan, tc=tc)
    return {"collective_bytes": c.collective_bytes,
            "per_op_bytes": dict(c.per_op_bytes),
            "op_counts": dict(c.op_counts),
            "seconds": time.perf_counter() - t0}


def _want_mra_launches(cfg, steps) -> dict:
    """Each kernel's launches on a rank: training (every block's forward
    and its remat recompute, a microbatch at a time), and serving (the
    prefill's one a layer, each decode step's)."""
    spec = MESH_MRA
    L = cfg.n_layers
    train = 2 * spec["accum"] * L * spec["mesh_steps"]
    return {"train": {"flash_attention": train, "fused_mlp": train,
                      "flash_decode": 0, "ssd_scan": 0},
            "serve": {"flash_attention": L, "fused_mlp": L * (1 + steps),
                      "flash_decode": L * steps, "ssd_scan": 0}}


def mra_rows_failures(reps, rows_key="rows") -> list:
    """The stream split, by the token rows each tile ran on: the attention
    tile's are half of its replica group's rows, disjoint across the two
    replica ranks, and together the MLP's, which every rank of the group
    sees whole (``rows_key``: the training run's rows, or a planted
    run's ``planted/<tag>/rows``)."""
    def rows(r):
        x = r
        for k in rows_key.split("/"):
            x = x[k]
        return {k: [tuple(row) for row in v] for k, v in x.items()}
    bad = []
    groups = {}
    for r in reps:
        groups.setdefault((r["coords"]["data"], r["coords"]["shard"]),
                          []).append(r)
    for key, members in sorted(groups.items()):
        mlp = [rows(r)["ffn"] for r in members]
        attn = [rows(r)["attn"] for r in members]
        if any(m != mlp[0] for m in mlp):
            bad.append(f"{rows_key} {key}: the MLP's rows differ across the "
                       "replica group")
        if any(len(a) * len(members) != len(mlp[0]) for a in attn):
            bad.append(f"{rows_key} {key}: the attention ran on "
                       f"{[len(a) for a in attn]} rows of the group's "
                       f"{len(mlp[0])}")
        flat = [row for a in attn for row in a]
        if len(set(flat)) != len(flat):
            bad.append(f"{rows_key} {key}: the replica ranks' attention "
                       "rows overlap")
        if sorted(flat) != sorted(mlp[0]):
            bad.append(f"{rows_key} {key}: the attention rows are not the "
                       "MLP's")
    return bad


def mesh_mra_failures(reps, single, fake) -> list:
    """Every check of phase ``mesh_mra`` that fails, named."""
    bad = []
    r0 = reps[0]
    reduced = r0["reduced"]
    cfg = _cut(MESH_MRA["arch"], MESH_MRA["n_layers"], reduced)
    want = _want_mra_launches(cfg, r0["serve"]["decode_steps"])
    for i, (a, b) in enumerate(zip(r0["losses"], single["losses"])):
        if not abs(a - b) <= TRAIN_MESH_LOSS_ATOL:
            bad.append(f"step {i + 1} loss {a} vs one device {b}")
    g, g1 = r0["grad_norms"][0], single["grad_norms"][0]
    if not abs(g - g1) <= TRAIN_MESH_GNORM_RTOL * abs(g1):
        bad.append(f"step 1 grad_norm {g} vs one device {g1}")
    bad += mra_rows_failures(reps)
    for r in reps:
        k = r["rank"]
        if r["mra_split"] != ["attn"]:
            bad.append(f"rank {k} splits {r['mra_split']}")
        if not r["step1_grad"]["rel_l2"] <= TRAIN_MESH_GRAD_RTOL:
            bad.append(f"rank {k}'s step 1 gradient vs one device: "
                       f"{r['step1_grad']}")
        if r["losses"] != r0["losses"] or \
                r["grad_norms"] != r0["grad_norms"]:
            bad.append(f"rank {k}'s metrics differ from rank 0's")
        if r["replica_gap"] != 0.0:
            bad.append(f"rank {k}'s replicated blocks differ from its "
                       f"replica peer's ({r['replica_gap']})")
        if r["launches"] != want["train"]:
            bad.append(f"rank {k} training launches {r['launches']}, not "
                       f"{want['train']}")
        if r["serve"]["launches"] != want["serve"] or \
                r["serve"]["lse_launches"] != want["serve"]["flash_decode"]:
            bad.append(f"rank {k} serving launches {r['serve']['launches']}"
                       f" (lse {r['serve']['lse_launches']}), not "
                       f"{want['serve']}")
        if r["plain_on_cuda"] != r["oracle_calls"] or \
                r["serve"]["plain_on_cuda"]:
            bad.append(f"rank {k} plain versions on CUDA tensors "
                       f"{r['plain_on_cuda']} / "
                       f"{r['serve']['plain_on_cuda']}")
        for what, used in (("training", r["used"]),
                           ("serving", r["serve"]["used"])):
            off = [u for u in used if not u.endswith("/gloo/cuda")]
            if off or not used:
                bad.append(f"rank {k} {what} collectives off gloo/cuda: "
                           f"{off}")
        s = r["serve"]
        if not s["finite"] or s["max_rel_logit_err"] > mesh_logit_tol(
                "dense"):
            bad.append(f"rank {k} serving vs one device: logit error "
                       f"{s['max_rel_logit_err']}, finite {s['finite']}")
        if s["cache_spec"] != ("PartitionSpec(None, ('data', 'replica'), "
                               "'shard', None, None)"):
            bad.append(f"rank {k} cache placed {s['cache_spec']}")
        st = r["collective_stats_step1"]
        if (st.get("per_op_bytes"), st.get("op_counts")) != (
                fake["per_op_bytes"], fake["op_counts"]):
            bad.append(f"rank {k} step 1 collectives {st} vs the fake "
                       f"mesh's count {fake}")
        pl = r["planted"]
        if pl["control"]["grad_rel_l2"] > TRAIN_MESH_GRAD_RTOL or \
                pl["control"]["replica_gap"] != 0.0:
            bad.append(f"rank {k}: the unfaulted reduced run diverged")
    agree = (sum(r["serve"]["agreed"] for r in reps if r["coords"]["shard"]
                 == 0) / max(1, sum(r["serve"]["positions"] for r in reps
                                    if r["coords"]["shard"] == 0)))
    if agree < AGREE_MIN:
        bad.append(f"greedy agreement {agree} over the run's rows")
    bad += mra_rows_failures(reps, "planted/control/rows")
    if not mra_rows_failures(reps, "planted/same_rows/rows"):
        bad.append("both replica ranks fed the same rows passed the rows "
                   "check")
    if not any(r["planted"]["no_replica_reduce"]["grad_rel_l2"]
               > TRAIN_MESH_GRAD_RTOL for r in reps):
        bad.append("the skipped replica reduce passed the gradient check")
    return bad


def phase_mesh_mra(smi, single, mesh_report=None):
    """4 gloo ranks as subprocesses on cuda:0 (``mesh_mra_rank``) under a
    hard limit, held to ``train_mesh_one_device``'s numbers (``single``)
    and to ``mra_one_device_serve``'s; step 1's collectives held to
    ``mra_fake_count``'s; beside train_mesh's (data 2, model 2) step's
    collectives (``mesh_report``)."""
    import shutil
    import tempfile
    spec = MESH_MRA
    world = spec["world"]
    workdir = tempfile.mkdtemp(prefix="chip_smoke_mra_")
    torch.save(single["step1_grads"],
               os.path.join(workdir, "one_device_grads.pt"))
    serve_one = mra_one_device_serve(workdir)
    fake = mra_fake_count()
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-mra-rank",
         str(r), "--world", str(world), "--workdir", workdir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(world)]
    outs, timed_out = [], False
    deadline = time.perf_counter() + spec["limit_s"]
    for p in procs:
        try:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.perf_counter())))
        except subprocess.TimeoutExpired:
            timed_out = True
            break
    if timed_out:
        for p in procs:
            p.kill()
        outs = [p.communicate() for p in procs]
    out = {"phase": "mesh_mra", "ranks": world,
           "mesh": dict(zip(spec["axes"], spec["mesh"])),
           "arch": spec["arch"], "layers": spec["n_layers"],
           "strategy": spec["strategy"],
           "seconds": time.perf_counter() - t0, "serve_one_device": serve_one,
           "fake_count_step1": fake, "nvidia_smi": smi,
           "card": "4 ranks sharing one H100 over gloo: the price of "
                   "sharing the card, not a multi-GPU speed"}
    try:
        errs = [(r, p.returncode, e[-3000:]) for r, (p, (_, e))
                in enumerate(zip(procs, outs)) if p.returncode != 0]
        if timed_out or errs:
            out["errors"] = errs
            out["timed_out"] = timed_out
            emit(out)
            raise SystemExit("a mesh_mra rank failed: see errors")
        reps = []
        for r in range(world):
            with open(os.path.join(workdir, f"rank{r}.json")) as f:
                reps.append(json.load(f))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    r0 = reps[0]
    out.update({
        "losses": r0["losses"], "grad_norms": r0["grad_norms"],
        "one_device": {"losses": single["losses"][:2],
                       "grad_norm": single["grad_norms"][0]},
        "step1_grad_by_rank": [r["step1_grad"] for r in reps],
        "step_s": r0["step_s"], "init_s_by_rank": [r["init_s"] for r in reps],
        "specs": r0["specs"], "local_shapes": r0["local_shapes"],
        "rows_by_rank": [{k: len(v) for k, v in r["rows"].items()}
                         for r in reps],
        "collective_stats_step1": r0["collective_stats_step1"],
        "train_mesh_collective_stats_step2": (
            mesh_report or {}).get("collective_stats_step2"),
        "train_peak_gib_by_rank": [r["train_peak_gib"] for r in reps],
        "serve_by_rank": [{k: v for k, v in r["serve"].items()
                           if k not in ("prefill_rows", "used")}
                          for r in reps],
        "launches_by_rank": [r["launches"] for r in reps],
        "serve_launches_by_rank": [r["serve"]["launches"] for r in reps],
        "planted": [{k: {kk: vv for kk, vv in v.items() if kk != "rows"}
                     for k, v in r["planted"].items()} for r in reps]})
    bad = mesh_mra_failures(reps, single, fake)
    out["failures"] = bad
    emit(out)
    if bad:
        raise SystemExit("mesh_mra: " + "; ".join(bad))
    return out


# ---------------------------------------------------------------------------
# every model family from placed parameters: 4 ranks sharing the card
# ---------------------------------------------------------------------------

# (data 2, model 2) as train_mesh; TRAIN's shape, lr and microbatches.
# Training: zamba2-7b cut to 7 Mamba-2 blocks (the shared tile's two sites,
# before blocks 0 and 6) and deepseek-v2-lite-16b cut to 3 layers (the
# dense first layer and 2 MoE layers), full width, 2 steps, remat and the
# iota-compare loss, each held to the same configuration on one device.
# Serving: each family at full width, 4 slots of one prompt length (the
# rows of one prefill share it), window 4,096, 16 teacher-forced decode
# steps (32 until PR 28; cut for the script's time when mesh_mra joined:
# danube's prompt crosses the window, so both halves of every ring hold
# live keys from the first step and the planted lse fault shows at once),
# held to the one-device LM on the same weights and tokens.
MESH_FAMILIES = {"mesh": (2, 2), "axes": ("data", "model"), "world": 4,
                 "seq_len": TRAIN["seq_len"],
                 "global_batch": TRAIN["global_batch"],
                 "accum": TRAIN["accum"], "steps": 2, "lr": TRAIN["lr"],
                 "warmup": TRAIN["warmup"], "window": 4096,
                 "decode_steps": 16, "limit_s": 600, "timeout_s": 300}
# (arch, n_layers, step 1's gradient leaves held whole against one
# device's): column- and row-split weights, leaves every rank reads whole
# (Mamba-2's w_B, MLA's latent down-projection), the shared tile's
# weights (one leaf read at both sites), the expert and shared-expert
# weights and the dense first layer's
MESH_TRAIN_CASES = (
    ("zamba2-7b", 7, ("blocks/ssm/w_x", "blocks/ssm/out_proj",
                      "blocks/ssm/w_B", "shared_attn/attn/wq",
                      "shared_attn/attn/wo", "shared_attn/mlp/wi_gate")),
    ("deepseek-v2-lite-16b", 3, ("blocks/attn/wq", "blocks/attn/w_uk",
                                 "blocks/attn/w_dkv", "blocks/attn/wo",
                                 "blocks/moe/wi_gate",
                                 "blocks/moe/shared/wo",
                                 "prelude/0/mlp/wi_gate",
                                 "prelude/0/attn/w_uv")))
# (tag, arch, n_layers (None: full depth), prompt length): danube's
# prompt crosses its 4,096-token sliding window (the ring wraps), granite's
# leaves model rank 1's half of every ring empty through all 16 steps,
# deepseek's gives rank 1 its first key at the first step.  Cut for time
# (each decode step's collectives wait for the card, which the 4 ranks
# time-share: ~4 ms a call; the script's 1,200 s limit): zamba2 81 -> 12
# blocks (the tile's 2 sites), mamba2 48 -> 24 blocks (0.82 s a decode
# step at 48), granite 24 -> 12 layers; deepseek to 4 layers (four ranks
# each drawing the 16 B parameters whole do not fit the card).  danube,
# whose planted fault the gates are set from, keeps its full depth
MESH_SERVE_CASES = (("dense", "h2o-danube-1.8b", None, 4608),
                    ("moe", "granite-moe-1b-a400m", 12, 1000),
                    ("ssm", "mamba2-370m", 24, 4096),
                    ("hybrid", "zamba2-7b", 12, 3000),
                    ("mla", "deepseek-v2-lite-16b", 4, 2048))
# served once more with a fault planted in the placed decode (the merge
# of the ranks' partial outputs drops model rank 1's): both halves of
# their rings hold live keys, so the serving gates must reject it
MESH_FAULT_CASES = ("dense", "hybrid")
# each serving case's logit-error gate: the serve phases' own
# (LOGIT_REL_TOL), tightened for danube, whose planted fault (above) reads
# 4.2e-2 under it against 1.3e-2 unplanted (PERF.md section 6)
MESH_LOGIT_REL_TOL = {"dense": 2.5e-2}


def mesh_logit_tol(tag) -> float:
    return MESH_LOGIT_REL_TOL.get(tag, LOGIT_REL_TOL)


def _cut(arch, n_layers, reduced=False):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if reduced:
        return cfg.reduced()
    return cfg if n_layers is None else dataclasses.replace(
        cfg, n_layers=n_layers)


def _families_lm_kwargs():
    from repro_torch.models.layers import AttnOptions
    return dict(opts=AttnOptions(backend="fused"), ssm_backend="fused")


def _serve_shapes(reduced):
    """(prompt length, window, decode steps) of each serving case."""
    spec = MESH_FAMILIES
    if reduced:
        return {t: (12 if t != "moe" else 3, 16, 4)
                for t, _, _, _ in MESH_SERVE_CASES}
    return {t: (S, spec["window"], spec["decode_steps"])
            for t, _, _, S in MESH_SERVE_CASES}


def _train_shape(reduced):
    from repro_torch.configs.base import ShapeConfig
    spec = MESH_FAMILIES
    if reduced:
        return ShapeConfig("tiny", 64, 4, "train")
    return ShapeConfig("train_4k", spec["seq_len"], spec["global_batch"],
                       "train")


def _families_trainer(cfg, shape, mesh, device=None):
    """The training case's ``Trainer`` on ``mesh``, or (``mesh`` None) on
    one device with a rank's microbatch, one row a microbatch (accum times
    the data axis): the MoE's load-balance loss, a microbatch's, then
    covers the same tokens as a data rank's, and the one device computes
    the mesh's function."""
    from repro_torch.optim import adamw
    from repro_torch.runtime.train import TrainConfig, Trainer
    spec = MESH_FAMILIES
    accum = spec["accum"] * (1 if mesh is not None else dict(zip(
        spec["axes"], spec["mesh"]))["data"])
    tc = TrainConfig(accum=accum, log_every=1, ckpt_every=0,
                     monitor_every=2,
                     opt=adamw.AdamWConfig(lr=spec["lr"],
                                           warmup_steps=spec["warmup"],
                                           total_steps=spec["steps"]))
    kw = {} if device is None else {"device": device}
    return Trainer(cfg, shape, mesh=mesh, tc=tc,
                   lm_kwargs={**_families_lm_kwargs(), "remat": True,
                              "onehot_loss": True}, seed=SEED, **kw)


def families_one_device(workdir, device=DEV, reduced=False) -> dict:
    """The one-device numbers ``mesh_families``' ranks are held to, each
    configuration on ``device`` from the same seed: 2 training steps
    (losses, grad norms, step 1's kept gradient leaves, written to
    ``workdir``) and each serving case's prefill and greedy decode
    (tokens and float32 logits written to ``workdir``)."""
    from repro_torch.models.transformer import LM
    out = {"train": {}, "serve": {}}
    shape = _train_shape(reduced)
    for arch, n, leaves in MESH_TRAIN_CASES:
        t0 = time.perf_counter()
        tr = _families_trainer(_cut(arch, n, reduced), shape, None, device)
        with first_grads_kept(leaves) as fk:
            hist = tr.run(MESH_FAMILIES["steps"])
        torch.save(fk.kept, os.path.join(workdir, f"grads_{arch}.pt"))
        out["train"][arch] = {
            "losses": [m["loss"] for _, m in hist],
            "grad_norms": [m["grad_norm"] for _, m in hist],
            "seconds": time.perf_counter() - t0}
        del tr, fk
        empty_cache()
    rng = np.random.default_rng(SEED)
    for tag, arch, n, _ in MESH_SERVE_CASES:
        S, W, steps = _serve_shapes(reduced)[tag]
        cfg = _cut(arch, n, reduced)
        lm = LM(cfg, **_families_lm_kwargs())
        t0 = time.perf_counter()
        params = lm.init(torch.Generator(device=device).manual_seed(SEED))
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, S)),
                               device=device)
        logits = []
        with torch.no_grad():
            lg, cache = lm.prefill(params, toks, cache_len=W)
            for _ in range(steps):
                nxt = torch.argmax(lg, -1)[:, None]
                toks = torch.cat([toks, nxt], 1)
                logits.append(lg.cpu())
                lg, cache = lm.decode_step(params, cache, nxt)
            logits.append(lg.cpu())
        torch.save({"tokens": toks.cpu(), "logits": torch.stack(logits)},
                   os.path.join(workdir, f"serve_{tag}.pt"))
        out["serve"][tag] = {"seconds": time.perf_counter() - t0,
                             "layers": cfg.n_layers, "prompt": S,
                             "window": W, "steps": steps}
        del params, cache, lg, lm
        empty_cache()
    return out


def _count_plain_on_cuda(counts):
    """Wrap every kernel's plain version so a call on CUDA tensors is
    counted in ``counts`` (by kernel); returns the undo."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import fused_mlp as FM
    from repro_torch.kernels import ref as REF
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.models import mamba2 as M2
    saved = [(FA, "flash_attention_plain"), (FD, "flash_decode_plain"),
             (FM, "fused_rmsnorm_mlp_plain"), (SSD, "ssd_scan_plain"),
             (REF, "fused_rmsnorm_mlp_plain"), (M2, "ssd_scan_ref")]
    orig = [getattr(m, n) for m, n in saved]
    names = {"flash_attention_plain": "flash_attention",
             "flash_decode_plain": "flash_decode",
             "fused_rmsnorm_mlp_plain": "fused_mlp",
             "ssd_scan_plain": "ssd_scan", "ssd_scan_ref": "ssd_scan"}

    def counting(name, fn):
        def f(*a, **k):
            if any(torch.is_tensor(x) and x.is_cuda for x in a):
                key = name if not torch.is_grad_enabled() else \
                    name + ".oracle"
                counts[key] = counts.get(key, 0) + 1
            return fn(*a, **k)
        return f
    for (m, n), fn in zip(saved, orig):
        setattr(m, n, counting(names[n], fn))

    def undo():
        for (m, n), fn in zip(saved, orig):
            setattr(m, n, fn)
    return undo


def mesh_families_rank(rank, world, workdir, device="cuda", reduced=False):
    """One rank of phase ``mesh_families`` on (data 2, model 2): the two
    training cases through ``Trainer(mesh=)`` and the five serving cases
    through ``LM.prefill`` / ``LM.decode_step`` from placed parameters,
    each held to the one-device numbers the parent left in ``workdir``
    (``families_one_device``); its report written to
    ``workdir/rank<rank>.json`` (``device`` "cpu" with ``reduced`` only to
    rehearse the phase's code away from the card)."""
    import torch.distributed as dist
    from repro_torch import parallel as P
    from repro_torch.checkpoint.store import _flatten_with_paths
    from repro_torch.core.replication import merged_rules
    from repro_torch.core.tiles import default_plan
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import ops
    from repro_torch.launch.specs import cache_specs
    from repro_torch.models import layers as L
    from repro_torch.models.layers import batch_axes
    from repro_torch.models.params import place_params, shardings_for
    from repro_torch.models.transformer import LM
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import placement as PL
    spec = MESH_FAMILIES
    backend = C.init_process_group(
        rank, world, "file://" + os.path.join(workdir, "store"),
        device=device, timeout_s=spec["timeout_s"])
    mesh = P.make_mesh(spec["mesh"], spec["axes"], device=device)
    cuda = mesh.device.type == "cuda"
    rep = {"rank": rank, "backend": backend, "device": str(mesh.device),
           "coords": {a: mesh.coord(a) for a in mesh.axis_names},
           "train": {}, "serve": {}}
    K = all_kernels()
    plain = {}
    undo = _count_plain_on_cuda(plain)
    rep["reduced"] = reduced

    def reset():
        for f in K.values():
            f.launches = 0
        FD.flash_decode.lse_launches = 0
        ops.reset_counts()
        plain.clear()
        C.USED.clear()

    def oracle_calls():
        """The backward oracles' calls on CUDA tensors a run may make:
        one a backward of the MLP and of the scan."""
        n = {"fused_mlp.oracle": ops.FusedRMSNormMLP.backward_calls,
             "ssd_scan.oracle": ops.SSDScan.backward_calls}
        return {k: v for k, v in n.items() if v}

    shape = _train_shape(reduced)
    for arch, n, leaves in MESH_TRAIN_CASES:
        t0 = time.perf_counter()
        tr = _families_trainer(_cut(arch, n, reduced), shape, mesh)
        empty_cache(sync_only=True)
        init_s = time.perf_counter() - t0
        step_fn, times, syncs, sites, frames = tr._step, [], [], [], []

        def timed(*a):
            empty_cache(sync_only=True)
            dist.barrier()
            t = time.perf_counter()
            if not times and cuda:      # step 1: host syncs counted
                with SyncCount(stacks=True) as sc:
                    out = step_fn(*a)
                syncs.append(sc.total)
                sites.append(sync_sites(sc))
                frames.extend(package_frames(
                    sc, f"mesh_families:{arch}:step1:rank{rank}"))
            else:
                out = step_fn(*a)
            empty_cache(sync_only=True)
            times.append(time.perf_counter() - t)
            dist.barrier()
            return out
        tr._step = timed
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        reset()
        with first_grads_kept(leaves) as fk:
            hist = tr.run(spec["steps"])
        rep["train"][arch] = {
            "layers": tr.cfg.n_layers,
            "losses": [m["loss"] for _, m in hist],
            "grad_norms": [m["grad_norm"] for _, m in hist],
            "step_s": times, "init_s": init_s, "syncs_step1": syncs,
            "sync_sites_step1": sites, "sync_frames_step1": frames,
            "launches": {k: f.launches for k, f in K.items()},
            "oracle_calls": oracle_calls(), "plain_on_cuda": dict(plain),
            "used": {"/".join(k): v for k, v in sorted(C.USED.items())},
            "peak_gib": (torch.cuda.max_memory_allocated() / 2**30 if cuda
                         else None)}
        got = gathered_grads(fk.kept)
        del tr, fk
        empty_cache()
        one = torch.load(os.path.join(workdir, f"grads_{arch}.pt"),
                         map_location=mesh.device)
        rep["train"][arch]["step1_grad"] = grads_vs(got, one)
        del got, one
        empty_cache()
        dist.barrier()              # every rank's state is gone

    bax = batch_axes(mesh)
    shapes = _serve_shapes(reduced)

    def serve(tag, arch, n):
        """One serving case: prefill of this rank's rows and the decode
        steps from placed parameters, held to the one-device logits."""
        S, W, steps = shapes[tag]
        cfg = _cut(arch, n, reduced)
        lm = LM(cfg, **_families_lm_kwargs())
        t0 = time.perf_counter()
        sh = shardings_for(lm.param_specs(),
                           merged_rules(default_plan(cfg), mesh), mesh)
        params = place_params(
            lm.init(torch.Generator(device=mesh.device).manual_seed(SEED)),
            sh)
        empty_cache()
        init_s = time.perf_counter() - t0
        ref = torch.load(os.path.join(workdir, f"serve_{tag}.pt"))
        B = ref["tokens"].shape[0] // C.axis_size(bax, mesh)
        r0 = C.axis_index(bax, mesh) * B
        toks = ref["tokens"][r0:r0 + B].to(mesh.device)
        want = ref["logits"][:, r0:r0 + B]
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        worst, agree, finite, calls = 0.0, 0, True, 0
        reset()
        dist.barrier()
        t0 = time.perf_counter()
        with torch.no_grad():
            lg, cache = lm.prefill(params, toks[:, :S], cache_len=W)
            empty_cache(sync_only=True)
            prefill_s = time.perf_counter() - t0
            prefill_gib = (torch.cuda.max_memory_allocated() / 2**30
                           if cuda else None)
            specs_ok = all(PL.same_spec(PL.spec_of(t), sp, t.dim())
                           for t, sp in zip(_leaves(cache), _spec_leaves(
                               cache_specs(lm, ref["tokens"].shape[0], W,
                                           mesh))))
            t1 = time.perf_counter()
            for i in range(steps + 1):
                if i:
                    lg, cache = lm.decode_step(params, cache,
                                               toks[:, S + i - 1:S + i])
                w = want[i].to(lg.device)
                finite &= bool(torch.isfinite(lg).all())
                for b in range(B):
                    worst = max(worst, _err(lg[b], w[b])
                                / float(w[b].abs().max()))
                agree += int((torch.argmax(lg, -1).cpu()
                              == torch.argmax(w, -1).cpu()).sum())
                calls += B
            empty_cache(sync_only=True)
        decode_s = time.perf_counter() - t1
        out = {
            "layers": cfg.n_layers, "prompt": S, "window": W,
            "decode_steps": steps, "init_s": init_s, "prefill_s": prefill_s,
            "decode_s_per_step": decode_s / max(steps, 1),
            "max_rel_logit_err": worst, "token_agreement": agree / calls,
            "agreed": agree, "positions": calls,
            "finite": finite, "cache_specs_ok": specs_ok,
            "cache_specs": {p: repr(PL.spec_of(t))
                            for p, t in _flatten_with_paths(cache)},
            "launches": {k: f.launches for k, f in K.items()},
            "variants": {k: getattr(f, "last_variant", None)
                         for k, f in K.items()},
            "lse_launches": FD.flash_decode.lse_launches,
            "plain_on_cuda": dict(plain),
            "used": {"/".join(k): v for k, v in sorted(C.USED.items())},
            "prefill_peak_gib": prefill_gib,
            "peak_gib": (torch.cuda.max_memory_allocated() / 2**30 if cuda
                         else None)}
        del params, cache, lg, ref, want, lm
        empty_cache()
        dist.barrier()              # every rank's model is gone
        return out

    for tag, arch, n, _ in MESH_SERVE_CASES:
        rep["serve"][tag] = serve(tag, arch, n)
    # the planted fault: the merge of the ranks' partial outputs drops
    # model rank 1's (its lse -inf: weight 0)
    merge = L.merge_by_lse
    L.merge_by_lse = lambda outs, lses: merge(outs, torch.cat(
        [lses[:1], torch.full_like(lses[1:], -torch.inf)]))
    try:
        rep["fault"] = {tag: serve(tag, arch, n)
                        for tag, arch, n, _ in MESH_SERVE_CASES
                        if tag in MESH_FAULT_CASES}
    finally:
        L.merge_by_lse = merge
    undo()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(rep, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _spec_leaves(tree):
    from repro_torch.launch.mesh import PartitionSpec
    from repro_torch.models.params import tree_leaves
    return tree_leaves(tree, lambda x: isinstance(x, PartitionSpec))


def _want_serve_launches(tag, cfg, steps) -> dict:
    """Each kernel's launches on a rank in a serving case: the prefill's
    (one call a layer or site) and each decode step's."""
    L, every = cfg.n_layers, cfg.shared_attn_every
    sites = -(-L // every) if cfg.family == "hybrid" else 0
    attn = sites if cfg.family == "hybrid" else (
        0 if cfg.family == "ssm" else L)
    dense = (sites if cfg.family == "hybrid" else
             cfg.n_dense_layers if cfg.family == "moe" else
             0 if cfg.family == "ssm" else L)
    mla = cfg.attn_type == "mla"
    ssd = L if cfg.family in ("ssm", "hybrid") else 0
    return {"flash_attention": attn, "fused_mlp": dense * (1 + steps),
            "flash_decode": 0 if mla else attn * steps, "ssd_scan": ssd}


def _want_train_launches(cfg) -> dict:
    """Each kernel's launches on a rank over the steps: every block's
    forward and its remat recompute, a microbatch at a time (the moe
    family's dense prelude runs outside the remat body: once)."""
    spec = MESH_FAMILIES
    n = spec["accum"] * spec["steps"]
    L = cfg.n_layers
    if cfg.family == "hybrid":
        sites = -(-L // cfg.shared_attn_every)
        return {"flash_attention": 2 * n * sites, "fused_mlp": 2 * n * sites,
                "flash_decode": 0, "ssd_scan": 2 * n * L}
    pre = cfg.n_dense_layers
    return {"flash_attention": n * (pre + 2 * (L - pre)),
            "fused_mlp": n * pre, "flash_decode": 0, "ssd_scan": 0}


def run_agreement(reps, kind, tag) -> float:
    """Greedy agreement over every row of the run, as the serve phases
    count it: each data coordinate's rows, from its model rank 0 (its
    model peers compute the same rows: held equal in the checks)."""
    rows = [r[kind][tag] for r in reps if r["coords"]["model"] == 0]
    return (sum(x["agreed"] for x in rows)
            / max(1, sum(x["positions"] for x in rows)))


def fault_gates(reps, tag) -> dict:
    """The serving gates on the run with the planted fault: whether the
    logit error (or a non-finite logit) and the greedy agreement reject
    it, with their readings."""
    worst = max(r["fault"][tag]["max_rel_logit_err"] for r in reps)
    finite = all(r["fault"][tag]["finite"] for r in reps)
    agree = run_agreement(reps, "fault", tag)
    return {"max_rel_logit_err": worst, "token_agreement": agree,
            "logits_rejected": not (finite and worst <= mesh_logit_tol(tag)),
            "agreement_rejected": agree < AGREE_MIN}


def mesh_families_failures(reps, single) -> list:
    """Every check of phase ``mesh_families`` that fails, named."""
    bad = []
    r0 = reps[0]
    reduced = r0["reduced"]
    for arch, n, leaves in MESH_TRAIN_CASES:
        one, t0 = single["train"][arch], r0["train"][arch]
        for i, (a, b) in enumerate(zip(t0["losses"], one["losses"])):
            if not abs(a - b) <= TRAIN_MESH_LOSS_ATOL:
                bad.append(f"{arch} step {i + 1} loss {a} vs one device {b}")
        g, g1 = t0["grad_norms"][0], one["grad_norms"][0]
        if not abs(g - g1) <= TRAIN_MESH_GNORM_RTOL * abs(g1):
            bad.append(f"{arch} step 1 grad_norm {g} vs one device {g1}")
        want = _want_train_launches(_cut(arch, n, reduced))
        for r in reps:
            t, k = r["train"][arch], r["rank"]
            # each kept leaf on its own: a fault in a small leaf (MLA's
            # latent down-projection) must not hide under the large ones
            if not max(t["step1_grad"]["per_leaf"].values(),
                       default=math.inf) <= TRAIN_MESH_GRAD_RTOL:
                bad.append(f"{arch} rank {k}'s step 1 gradient vs one "
                           f"device: {t['step1_grad']}")
            if sorted(t["step1_grad"]["per_leaf"]) != sorted(leaves):
                bad.append(f"{arch} rank {k} kept {t['step1_grad']}")
            if t["losses"] != t0["losses"] or \
                    t["grad_norms"] != t0["grad_norms"]:
                bad.append(f"{arch} rank {k}'s metrics differ from rank 0's")
            if t["launches"] != want:
                bad.append(f"{arch} rank {k} launches {t['launches']}, not "
                           f"{want}")
            if t["syncs_step1"] != [0]:
                bad.append(f"{arch} rank {k} host syncs in step 1: "
                           f"{t['syncs_step1']}")
            # the plain versions on CUDA tensors: only as the backward's
            # oracles, once a backward call
            if t["plain_on_cuda"] != t["oracle_calls"]:
                bad.append(f"{arch} rank {k} plain versions on CUDA "
                           f"tensors: {t['plain_on_cuda']}, not the "
                           f"backward oracles' {t['oracle_calls']}")
            off = [u for u in t["used"] if not u.endswith("/gloo/cuda")]
            if off or not t["used"]:
                bad.append(f"{arch} rank {k} collectives off gloo/cuda: "
                           f"{off}")
    for tag in MESH_FAULT_CASES:
        gates = fault_gates(reps, tag)
        if not (gates["logits_rejected"] or gates["agreement_rejected"]):
            bad.append(f"{tag}: the planted fault passed the serving gates "
                       f"{gates}")
    for tag, arch, n, _ in MESH_SERVE_CASES:
        cfg = _cut(arch, n, reduced)
        agree = run_agreement(reps, "serve", tag)
        if agree < AGREE_MIN:
            bad.append(f"{tag} greedy agreement {agree} over the run's "
                       f"rows, under {AGREE_MIN}")
        for r in reps:
            s, k = r["serve"][tag], r["rank"]
            want = _want_serve_launches(tag, cfg, s["decode_steps"])
            peer = next(x["serve"][tag] for x in reps
                        if x["coords"]["data"] == r["coords"]["data"]
                        and x["coords"]["model"] == 0)
            if (s["max_rel_logit_err"], s["agreed"]) != (
                    peer["max_rel_logit_err"], peer["agreed"]):
                bad.append(f"{tag} rank {k}'s rows differ from its model "
                           "peer's")
            if not s["finite"] or s["max_rel_logit_err"] > mesh_logit_tol(
                    tag):
                bad.append(f"{tag} rank {k} vs one device: logit error "
                           f"{s['max_rel_logit_err']}, finite {s['finite']}")
            if not s["cache_specs_ok"]:
                bad.append(f"{tag} rank {k} cache placed {s['cache_specs']}")
            if s["launches"] != want:
                bad.append(f"{tag} rank {k} launches {s['launches']}, not "
                           f"{want}")
            if s["lse_launches"] != want["flash_decode"]:
                bad.append(f"{tag} rank {k}: {s['lse_launches']} "
                           "flash_decode launches with the lse, not "
                           f"{want['flash_decode']}")
            if s["plain_on_cuda"]:
                bad.append(f"{tag} rank {k} plain versions on CUDA tensors "
                           f"{s['plain_on_cuda']}")
            off = [u for u in s["used"] if not u.endswith("/gloo/cuda")]
            if off or not s["used"]:
                bad.append(f"{tag} rank {k} collectives off gloo/cuda: "
                           f"{off}")
    return bad


def time_decode_lse() -> dict:
    """``flash_decode(return_lse=True)`` at the placed decode's rank
    slices (``LSE_SLICES``' danube and zamba2 shapes with live keys in
    both halves) beside the call without the lse on the same inputs, both
    graph-timed (``graph_ms``), the plain version eagerly; the bound from
    the live slots' bytes and the two products; the library call that
    gives the output and the log-sum-exp (memory-efficient attention, its
    ``compute_log_sumexp``, over the kv heads expanded to every q head and
    the mask as a bias, made before the timing)."""
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.models.layers import _window_mask
    rows = {}
    for c in (LSE_SLICES[0], LSE_SLICES[2]):
        B, W, KV, G, hd, win, pos, part = c
        a = decode_lse_case(*c, "bfloat16")
        q, ck, cv, qp, kp, _, scale = a
        fd = FD.flash_decode
        out, lse = fd(*a, return_lse=True)
        ref, ref_lse = FD.flash_decode_plain(*a, return_lse=True)
        sync()
        live = _window_mask(qp[:, None], kp, win)[:, 0]            # (B, W)
        n_live = float(live.sum())
        byts = n_live * KV * 2 * hd * ck.element_size() + _nbytes(
            q, out, lse, qp, kp)
        ops = 2.0 * n_live * KV * G * (hd + hd)
        qt = q.reshape(B, KV * G, 1, hd)
        kt, vt = (x.transpose(1, 2).repeat_interleave(G, 1).contiguous()
                  for x in (ck, cv))
        bias = torch.zeros((B, KV * G, 1, W), dtype=q.dtype, device=DEV)
        bias.masked_fill_(~live[:, None, None, :], -torch.inf)

        def library():
            return torch.ops.aten._scaled_dot_product_efficient_attention(
                qt, kt, vt, bias, True, scale=scale)
        library()
        r = {"shape": f"q ({B},{KV},{G},{hd}), cache ({B},{W},{KV},{hd}) "
                      f"bf16, half {part} of a {2 * W}-slot ring",
             "variant": fd.last_variant, "live_slots": n_live,
             **lse_check(out, lse, ref, ref_lse, torch.bfloat16),
             "ms": graph_ms(lambda: fd(*a, return_lse=True), SERVE["reps"]),
             "no_lse_ms": graph_ms(lambda: fd(*a), SERVE["reps"]),
             "plain_ms": cuda_ms(lambda: FD.flash_decode_plain(
                 *a, return_lse=True), 2),
             "library_ms": graph_ms(library, SERVE["reps"]),
             "library_call": "aten._scaled_dot_product_efficient_attention"
                             "(compute_log_sumexp=True)", "operations": ops}
        r.update(zip(("bound_ms", "bound_by"), _bound(byts, ops)))
        rows["danube" if hd == 80 else "zamba2"] = r
        del a, out, lse, ref, ref_lse, kt, vt, bias
    return rows


def phase_mesh_families(smi):
    """4 gloo ranks as subprocesses on cuda:0 (``mesh_families_rank``)
    under a hard limit, after the one-device numbers they are held to
    (``families_one_device``).  Prints the price of four ranks sharing one
    card, not a multi-GPU speed."""
    import gc
    import shutil
    import tempfile
    spec = MESH_FAMILIES
    gc.collect()
    torch.cuda.empty_cache()
    parent = {"allocated_gib": torch.cuda.memory_allocated() / 2**30,
              "reserved_gib": torch.cuda.memory_reserved() / 2**30}
    world = spec["world"]
    workdir = tempfile.mkdtemp(prefix="chip_smoke_families_")
    t0 = time.perf_counter()
    lse_rows = time_decode_lse()
    empty_cache()
    try:
        single = families_one_device(workdir)
        one_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        env = dict(os.environ,
                   PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
        t1 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--mesh-families-rank", str(r), "--world", str(world),
             "--workdir", workdir],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for r in range(world)]
        outs, timed_out = [], False
        deadline = time.perf_counter() + spec["limit_s"]
        for p in procs:
            try:
                outs.append(p.communicate(
                    timeout=max(1.0, deadline - time.perf_counter())))
            except subprocess.TimeoutExpired:
                timed_out = True
                break
        if timed_out:
            for p in procs:
                p.kill()
            outs = [p.communicate() for p in procs]
        out = {"phase": "mesh_families", "ranks": world,
               "mesh": dict(zip(spec["axes"], spec["mesh"])),
               "seconds": time.perf_counter() - t0, "one_device_s": one_s,
               "ranks_s": time.perf_counter() - t1, "nvidia_smi": smi,
               "parent_memory": parent, "one_device": single,
               "decode_lse": lse_rows,
               "card": "4 ranks sharing one H100 over gloo: the price of "
                       "sharing the card, not a multi-GPU speed"}
        errs = [(r, p.returncode, e[-3000:]) for r, (p, (_, e))
                in enumerate(zip(procs, outs)) if p.returncode != 0]
        if timed_out or errs:
            out["errors"] = errs
            out["timed_out"] = timed_out
            emit(out)
            raise SystemExit("a mesh_families rank failed: see errors")
        reps = []
        for r in range(world):
            with open(os.path.join(workdir, f"rank{r}.json")) as f:
                reps.append(json.load(f))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    out["train"] = {arch: {
        "layers": reps[0]["train"][arch]["layers"],
        "losses": reps[0]["train"][arch]["losses"],
        "one_device_losses": single["train"][arch]["losses"],
        "grad_norms": reps[0]["train"][arch]["grad_norms"],
        "one_device_grad_norm": single["train"][arch]["grad_norms"][0],
        **{f"{k}_by_rank": [r["train"][arch][k] for r in reps]
           for k in ("step1_grad", "step_s", "syncs_step1",
                     "sync_sites_step1", "launches", "peak_gib", "init_s")}}
        for arch, _, _ in MESH_TRAIN_CASES}
    out["serve"] = {tag: {
        **{k: reps[0]["serve"][tag][k] for k in (
            "layers", "prompt", "window", "decode_steps", "cache_specs",
            "variants")},
        **{f"{k}_by_rank": [r["serve"][tag][k] for r in reps]
           for k in ("max_rel_logit_err", "token_agreement", "launches",
                     "lse_launches", "prefill_s", "decode_s_per_step",
                     "prefill_peak_gib", "peak_gib", "init_s")}}
        for tag, _, _, _ in MESH_SERVE_CASES}
    out["fault"] = {"planted": "the merge of the ranks' partial outputs "
                               "drops model rank 1's",
                    **{tag: fault_gates(reps, tag)
                       for tag in MESH_FAULT_CASES}}
    out.update(logit_rel_tol={t: mesh_logit_tol(t)
                              for t, _, _, _ in MESH_SERVE_CASES},
               agree_min=AGREE_MIN,
               loss_atol=TRAIN_MESH_LOSS_ATOL,
               grad_norm_rtol=TRAIN_MESH_GNORM_RTOL,
               grad_rtol=TRAIN_MESH_GRAD_RTOL)
    bad = mesh_families_failures(reps, single)
    out["failures"] = bad
    out["launches"] = {n: sum(
        r["train"][a]["launches"][n] for r in reps
        for a, _, _ in MESH_TRAIN_CASES) + sum(
        r["serve"][t]["launches"][n] for r in reps
        for t, _, _, _ in MESH_SERVE_CASES) for n in all_kernels()}
    out["lse_launches"] = sum(r["serve"][t]["lse_launches"] for r in reps
                              for t, _, _, _ in MESH_SERVE_CASES)
    OBSERVED_SYNCS.extend(f for r in reps for a, _, _ in MESH_TRAIN_CASES
                          for f in r["train"][a].get("sync_frames_step1",
                                                     ()))
    bad += [f"decode_lse {k}: {v}" for k, v in lse_rows.items()
            if not v["ok"] or v["variant"] != "cp_async"]
    emit(out)
    if bad:
        raise SystemExit("mesh_families: " + "; ".join(bad[:8]))
    return out


# phase "analysis": the runs whose syncs it observes besides the serving
# and mesh phases' — the sequential replay (the example's platform under
# PID, DFS on; control every 10 ticks), the chunked sweep's blocks and the
# batched "torch" loop under PID
ANALYSIS = {"replay_ticks": 100, "replay_ci": 10, "chunk": 1_000_000,
            "rerank_ticks": 200, "baseline": "analysis/baseline_torch.json"}


def analysis_replay():
    """One short sequential replay with DFS on, under
    ``SyncCount(stacks=True)``: its sync frames (the control window's copy
    each control tick, and what the run reads after its loop)."""
    ex = closed_loop_example()
    from repro_torch.sim import SimConfig, SimEngine, Trace
    plat = ex.build_platform()
    trace = ex.default_trace(plat, device=DEV)
    short = Trace(trace.arrivals[:ANALYSIS["replay_ticks"]], trace.dt)
    cfg = SimConfig(control_interval=ANALYSIS["replay_ci"])
    with SyncCount(stacks=True) as sc:
        r = SimEngine(plat, config=cfg, controller=ex.controllers(plat)[
            "dfs-pid"], device=DEV).run(short)
    frames = package_frames(sc, "analysis_replay:dfs-pid")
    return frames, {"ticks": short.ticks, "control_ticks": short.ticks
                    // ANALYSIS["replay_ci"], "syncs": sc.total,
                    "syncs_in_ticks": sc.in_ticks,
                    "completed": r.completed}


def analysis_sweep():
    """The chunked sweep's block loop on the card under
    ``SyncCount(stacks=True)``: the islands grid of ``sweep_chunked`` cut
    to four positions and one TG rate (10.1 M points), chunks of 10^6."""
    from repro_torch.configs.vespa_soc import CHSTONE
    from repro_torch.core.dse import grid_sweep
    from repro_torch.core.perfmodel import AccelWorkload, SoCPerfModel
    wls = [AccelWorkload(n, *CHSTONE[n]) for n in ISLANDS["accels"]]
    axes = dict(chunked_axes(ISLANDS), positions=ISLANDS["positions"][:4],
                tg_rates=ISLANDS["tg_rates"][:1])
    with SyncCount(stacks=True) as sc:
        r = grid_sweep(SoCPerfModel(), wls, **axes, device=None,
                       backend="torch", chunk_points=ANALYSIS["chunk"])
    return package_frames(sc, "analysis_sweep"), {
        "points": r.n_points, "chunks": r.n_chunks, "syncs": sc.total}


def analysis_rerank():
    """The batched ``"torch"`` loop with PID control on the card under
    ``SyncCount(stacks=True)``: three designs, 200 ticks, a control every
    25."""
    from repro_torch.sim.batch import BatchSimEngine, BatchSimPlatform
    from repro_torch.sim.control import BatchControllerHarness
    from repro_torch.sim.engine import SimConfig
    from repro_torch.sim.traffic import mmpp_trace
    plat = BatchSimPlatform.stack([_tick_platform(k) for k in (2, 4, 8)])
    ctl = BatchControllerHarness(plat.islands, plat.rates,
                                 make_policy("pid"), tile_names=plat.names)
    cap = BatchSimEngine(BatchSimPlatform.stack([_tick_platform(2)]),
                         device="cpu").capacity_rps()[0]
    tr = mmpp_trace(cap * 0.1, cap * 1.3, ANALYSIS["rerank_ticks"], 4,
                    dt=1e-3, seed=3)
    eng = BatchSimEngine(plat, config=SimConfig(control_interval=25),
                         controller=ctl, backend="torch", device=DEV)
    with SyncCount(stacks=True) as sc:
        eng.run(tr)
    return package_frames(sc, "analysis_rerank:pid"), {
        "designs": plat.n_designs, "ticks": tr.ticks, "syncs": sc.total,
        "syncs_in_ticks": sc.in_ticks}


def hot_scope(ctxs):
    """``{path: [(first, last, hot, region)]}`` of every function of the
    linted modules (``region``: a part entry's (first, last) lines)."""
    hot = ctxs[0].hotindex if ctxs else None
    out = {}
    for c in ctxs:
        for rec in c.funcindex.records:
            info = hot.info(rec)
            reg = info.region if info is not None else None
            out.setdefault(c.relpath, []).append((
                rec.node.lineno, rec.node.end_lineno, info is not None,
                None if reg is None else (reg.lineno, reg.end_lineno)))
    return out


def match_syncs(frames, findings, scope):
    """Each observed sync against the static rule: a frame inside a
    function the hot scope marks (inside its part, for a part entry) must
    lie on a line a TPR001 finding covers (``findings``: (path, first,
    last)).  Returns ``{"hot", "flagged", "missed" {site: n},
    "outside_scope" {site: n}, "outside_package" n}``."""
    spans = {}
    for path, lo, hi in findings:
        spans.setdefault(path, []).append((lo, hi))
    res = {"hot": 0, "flagged": 0, "missed": {}, "outside_scope": {},
           "outside_package": 0, "hot_sites": []}
    for f in frames:
        if f["path"] is None:
            res["outside_package"] += 1
            continue
        site, line = f"{f['path']}:{f['line']}", f["line"]
        fns = [(hi - lo, is_hot, reg) for lo, hi, is_hot, reg
               in scope.get(f["path"], ()) if lo <= line <= hi]
        _, is_hot, reg = min(fns) if fns else (0, False, None)
        if is_hot and reg is not None and not reg[0] <= line <= reg[1]:
            is_hot = False
        if not is_hot:
            res["outside_scope"][site] = res["outside_scope"].get(site,
                                                                  0) + 1
            continue
        res["hot"] += 1
        if site not in res["hot_sites"]:
            res["hot_sites"].append(site)
        if any(lo <= line <= hi for lo, hi in spans.get(f["path"], ())):
            res["flagged"] += 1
        else:
            res["missed"][site] = res["missed"].get(site, 0) + 1
    return res


def phase_analysis(smi, t_script):
    """``repro_torch.analysis`` in-process (AST only) over the checkout's
    ``src/repro_torch`` against its baseline, then held to the syncs this
    run observed (the serving and mesh phases', and those of
    :func:`analysis_replay`, :func:`analysis_sweep` and
    :func:`analysis_rerank`): every sync whose innermost ``src/repro_torch``
    frame lies in a hot function must lie on a line TPR001 flags (new,
    baselined or noqa'd); the frames outside the hot scope are counted
    (``outside_scope``).  A planted fault (one observed site dropped from
    the flagged lines) must come back as missed."""
    from repro_torch.analysis import analyze_paths, load_baseline
    from repro_torch.analysis.engine import load_modules
    from pathlib import Path
    t0 = time.perf_counter()
    runs = {}
    for name, fn in (("replay", analysis_replay), ("sweep", analysis_sweep),
                     ("rerank", analysis_rerank)):
        frames, runs[name] = fn()
        OBSERVED_SYNCS.extend(frames)
    t1 = time.perf_counter()
    pkg = Path(ROOT) / "src" / "repro_torch"
    report = analyze_paths([pkg], root=Path(ROOT), baseline=load_baseline(
        Path(ROOT) / ANALYSIS["baseline"]))
    scope = hot_scope(load_modules([pkg], Path(ROOT)))
    lint_s = time.perf_counter() - t1
    flagged = [(f.path, f.line, max(f.line, f.end_line))
               for f in report.findings if f.rule == "TPR001"]
    res = match_syncs(OBSERVED_SYNCS, flagged, scope)
    by_source = {}
    for f in OBSERVED_SYNCS:
        by_source[f["source"]] = by_source.get(f["source"], 0) + 1
    sites = sorted({f"{f['path']}:{f['line']}" for f in OBSERVED_SYNCS
                    if f["path"] is not None})
    # the planted fault: the findings covering one observed hot site go
    hot_sites = sorted(res["hot_sites"])
    planted = {"dropped": None, "missed": {}}
    if hot_sites:
        planted["dropped"] = hot_sites[0]
        path, line = hot_sites[0].rsplit(":", 1)
        cut = [x for x in flagged
               if not (x[0] == path and x[1] <= int(line) <= x[2])]
        planted["missed"] = match_syncs(OBSERVED_SYNCS, cut, scope)["missed"]
    out = {"phase": "analysis", "nvidia_smi": smi,
           "modules": report.modules, "lint_s": lint_s,
           "counts": {"new": len(report.new),
                      "baselined": len(report.baselined),
                      "suppressed": len(report.suppressed)},
           "tpr001_findings": len(flagged),
           "new": [f"{f.location()} {f.rule} {f.message}"
                   for f in report.new][:20],
           "observed": {"syncs": len(OBSERVED_SYNCS), "sites": len(sites),
                        "by_source": by_source, **res},
           "planted": planted, "runs": runs,
           "seconds": time.perf_counter() - t0,
           "script_s_so_far": time.perf_counter() - t_script}
    emit(out)
    bad = []
    if report.modules < 1:
        bad.append(f"the linter found no module under {pkg}")
    if report.new:
        bad.append(f"{len(report.new)} new lint finding(s)")
    if res["missed"]:
        bad.append(f"syncs in hot functions on lines TPR001 does not flag: "
                   f"{res['missed']}")
    if hot_sites and planted["dropped"] not in planted["missed"]:
        bad.append(f"the planted miss {planted['dropped']} was not caught")
    if not hot_sites:
        bad.append("no observed sync lies in the hot scope: nothing held")
    if bad:
        raise SystemExit("analysis: " + "; ".join(bad))
    return out


def card_case(test_name, *args):
    """Run one case of the gpu-marked test ``test_name`` (its arguments, in
    its signature's order, the card fixture left out)."""
    CARD_TESTS[test_name][0](*args)


def phase_card_tests():
    """Every case of every gpu-marked pytest test, on the card."""
    n, failed = 0, []
    for name, (fn, cases) in CARD_TESTS.items():
        for case in cases:
            n += 1
            try:
                fn(*case)
            except AssertionError as e:
                failed.append({"test": name, "case": repr(case),
                               "error": str(e)[:400]})
    emit({"phase": "card_tests", "tests": len(CARD_TESTS), "cases": n,
          "failed": len(failed), "first_failures": failed[:5]})
    if failed:
        raise SystemExit("a gpu-marked test case fails on the card")


LLM_REPLACES = {
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:107"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:90"),
    "fused_mlp": ("src/repro_torch/kernels/csrc/fused_mlp.cu",
                  "src/repro/kernels/fused_mlp.py:57"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:90"),
}

KERNEL_KEYS = ("max_abs_err", "tolerance", "max_row_rel_err", "row_rtol",
               "shape", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")
# keys a row carries where it has them
KERNEL_EXTRA_KEYS = ("variant", "split", "library_call_ms", "matmul_ms",
                     "old_variant_ms", "bound_tc_ms", "bound_f32_ms",
                     "small_batch_split", "ms_by_kernel")
# the device kernel each must run at the serving shapes, the dense path's
# and the hybrid path's ("name.also": the row's second shape, fused_mlp's
# 4-slot decode)
SERVE_VARIANT = {"flash_attention": "wgmma_tma", "fused_mlp": "wgmma_tma",
                 "fused_mlp.also": "gemv_tma", "flash_decode": "cp_async"}


def serve_row(rows, key):
    """The row of ``rows`` a SERVE_VARIANT key names."""
    name, _, sub = key.partition(".")
    return rows[name][sub] if sub else rows[name]
SSD_VARIANT = "tf32x3"


def kernel_lse_row(r):
    """``time_decode_lse``'s row in the kernels line."""
    return {k: r[k] for k in ("shape", "variant", "max_abs_err",
                              "lse_max_abs_err", "ms", "no_lse_ms",
                              "plain_ms", "bound_ms", "bound_by",
                              "library_ms")}


def kernel_row(r):
    return {**{k: r[k] for k in KERNEL_KEYS},
            **{k: r[k] for k in KERNEL_EXTRA_KEYS if r.get(k) is not None}}


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="device, build and kernel parity only")
    ap.add_argument("--serve-only", action="store_true",
                    help="device, build, kernel parity and the serving "
                         "phases only")
    ap.add_argument("--train-only", action="store_true",
                    help="device, build, kernel parity and the training "
                         "phases only")
    ap.add_argument("--shard-only", action="store_true",
                    help="device, build, kernel parity, the sweep, the main "
                         "path and the two multi-device phases only")
    ap.add_argument("--mesh-only", action="store_true",
                    help="device, build and train_mesh only")
    ap.add_argument("--families-only", action="store_true",
                    help="device, build, the LLM kernels' parity and "
                         "mesh_families only")
    ap.add_argument("--analysis-only", action="store_true",
                    help="device, build, the moe and MLA serving paths, "
                         "mesh_families and analysis only")
    ap.add_argument("--ptxas", action="store_true",
                    help="print the compiler's register/spill report")
    ap.add_argument("--collectives-rank", type=int, default=None,
                    help=argparse.SUPPRESS)     # one rank of "collectives"
    ap.add_argument("--train-mesh-rank", type=int, default=None,
                    help=argparse.SUPPRESS)     # one rank of "train_mesh"
    ap.add_argument("--mesh-families-rank", type=int, default=None,
                    help=argparse.SUPPRESS)     # one of "mesh_families"
    ap.add_argument("--mesh-mra-rank", type=int, default=None,
                    help=argparse.SUPPRESS)     # one rank of "mesh_mra"
    ap.add_argument("--mra-only", action="store_true",
                    help="device, build and mesh_mra only")
    ap.add_argument("--dryrun-out", default=None,
                    help=argparse.SUPPRESS)     # the dry run's process
    ap.add_argument("--world", type=int, default=COLL["world"],
                    help=argparse.SUPPRESS)
    ap.add_argument("--workdir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.dryrun_out is not None:        # counts on fakes: no card
        with open(args.dryrun_out, "w") as f:
            json.dump(dryrun_on_card(), f)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures on the card "
              "and does not fall back to the CPU", file=sys.stderr)
        return 2
    if args.collectives_rank is not None:
        return collectives_rank(args.collectives_rank, args.world,
                                args.workdir)
    if args.train_mesh_rank is not None:
        return train_mesh_rank(args.train_mesh_rank, args.world,
                               args.workdir)
    if args.mesh_families_rank is not None:
        return mesh_families_rank(args.mesh_families_rank, args.world,
                                  args.workdir)
    if args.mesh_mra_rank is not None:
        return mesh_mra_rank(args.mesh_mra_rank, args.world, args.workdir)

    from repro_torch.kernels import build
    from repro_torch.kernels.tick_sim import fused_tick_sim

    t_script = time.perf_counter()
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    build.build_all(verbose=args.ptxas)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": build.last_build_seconds,
          "sources": [os.path.relpath(s, ROOT) for s in build.sources()],
          "flags": " ".join(build.NVCC_FLAGS),
          "source_flags": build.SOURCE_FLAGS})
    if args.ptxas:
        for src, log in build.last_build_log.items():
            print(f"--- nvcc {src} ---\n{log}", flush=True)
    device = {"platform": "gpu", "kind": name,
              "count": torch.cuda.device_count()}
    if args.mesh_only:
        phase_train_mesh(smi)
        print(smi, flush=True)
        emit({"ok": True, "mesh_only": True, "device": device})
        return 0
    if args.mra_only:
        phase_mesh_mra(smi, train_mesh_one_device())
        print(smi, flush=True)
        emit({"ok": True, "mra_only": True, "device": device})
        return 0
    if args.analysis_only:
        phase_serve_moe()
        phase_serve_mla()
        phase_mesh_families(smi)
        phase_analysis(smi, t_script)
        print(smi, flush=True)
        emit({"ok": True, "analysis_only": True, "device": device})
        return 0
    if args.families_only:
        phase_llm_kernels()
        phase_mesh_families(smi)
        print(smi, flush=True)
        emit({"ok": True, "families_only": True, "device": device})
        return 0

    parity = phase_kernels()
    phase_llm_kernels()
    phase_card_tests()
    if args.quick:
        print(smi, flush=True)
        emit({"ok": True, "quick": True, "device": device})
        return 0
    if args.serve_only:
        phase_serving()
        print(smi, flush=True)
        emit({"ok": True, "serve_only": True, "device": device})
        return 0
    if args.train_only:
        dry_job = start_dryrun()
        train_reports, _ = phase_training()
        phase_costing({}, train_reports, dry_job)
        phase_train_mesh(smi)
        print(smi, flush=True)
        emit({"ok": True, "train_only": True, "device": device})
        return 0

    model, res, _ = phase_sweep()
    if not args.shard_only:
        phase_sweep_chunked(model)

    # the main path, counted: every count to 0 just before, read just after
    fused_tick_sim.launches = 0
    main_report, main_ctx = drive_main_path(model, res)
    a12_report, a12_ctx = drive_main_path_a12()
    launches = fused_tick_sim.launches
    if launches < 1:
        raise SystemExit("the main path never launched the tick_sim kernel")

    if args.shard_only:
        phase_shard_main_path(model, res, main_ctx, a12_ctx)
        phase_collectives()
        print(smi, flush=True)
        emit({"ok": True, "shard_only": True, "device": device})
        return 0

    # the dry run counts on fakes in a process of its own, beside the
    # card's phases; phase_costing collects it
    dry_job = start_dryrun()
    # comparisons and timings (their launches are not the main path's)
    main_report = verify_main_path(main_report, main_ctx)
    a12_report = verify_main_path_a12(a12_report, a12_ctx)
    # devices= on the main path (N shards on this one card), its tick_sim
    # launches counted inside and kept apart from the main path's; then the
    # explicit collectives on 4 ranks
    _, shard_launches = phase_shard_main_path(model, res, main_ctx, a12_ctx)
    phase_collectives()

    # the sequential engine's paths: examples/torch_closed_loop.py's
    # scenarios at full size (they run no kernel of their own); the B = 1
    # fused path counts its tick_sim launches from 0
    cl_runs, cl_ctx = phase_closed_loop()
    phase_closed_loop_pipeline()
    phase_closed_loop_dse()
    phase_closed_loop_b1_fused(cl_runs, cl_ctx)
    # faults, SLO and online detection (no kernel of their own; "fused"
    # refuses them)
    phase_closed_loop_faults()
    phase_rerank_faults(main_ctx)
    phase_fused_refuses_faults(main_ctx)
    # the monitoring plane on those paths (no kernel of its own; "fused"
    # refuses it)
    phase_observe(cl_ctx, main_ctx)

    # the serving paths, each counted inside drive_serve the same way
    (serve_report, serve_rows, ssm_report, ssm_row, hyb_report, hyb_rows,
     moe_report, moe_rows, mla_report, mla_rows) = phase_serving()
    serve_rows = {**serve_rows, "ssd_scan": ssm_row}
    path_launches = {**serve_report["launches"],
                     "ssd_scan": ssm_report["launches"]["ssd_scan"]}
    hyb_launches = hyb_report["launches"]
    moe_launches = moe_report["launches"]
    mla_launches = mla_report["launches"]
    # the GSPMD half on 4 ranks sharing the card, each rank counting its
    # launches from 0 just before its steps and reading them just after;
    # the card is theirs (the contexts no later phase reads are dropped)
    del main_ctx, a12_ctx, cl_ctx, cl_runs
    single = train_mesh_one_device()
    mesh_report = phase_train_mesh(smi, single)
    mesh_launches = {n: sum(r[n] for r in mesh_report["launches_by_rank"])
                     for n in mesh_report["launches_by_rank"][0]}
    # the multi-replica tile: the stream split on (data 1, replica 2,
    # shard 2), each rank counting from 0 just before its steps and its
    # serving and reading just after
    mra_report = phase_mesh_mra(smi, single, mesh_report)
    del single
    mra_launches = {n: sum(r[n] + s[n] for r, s in zip(
        mra_report["launches_by_rank"], mra_report["serve_launches_by_rank"]))
        for n in mra_report["launches_by_rank"][0]}
    # every family from placed parameters, training and serving, on 4
    # ranks sharing the card, each rank counting from 0 just before each
    # case and reading just after
    families = phase_mesh_families(smi)
    # the static host-sync rule held to the syncs this run observed
    analysis = phase_analysis(smi, t_script)
    # the training paths, each counted inside drive_train the same way
    train_reports, train_kernels_report = phase_training()
    # the cost model beside the measured paths (it re-runs none of them)
    phase_costing({"serve": serve_report, "serve_ssm": ssm_report,
                   "serve_hybrid": hyb_report, "serve_moe": moe_report,
                   "serve_mla": mla_report}, train_reports, dry_job)

    def sub_row(rows, launches, n):
        """A serving path's row of kernel ``n``, with its own launches."""
        return {"launches": launches[n], **kernel_row(rows[n]),
                **({"also": kernel_row(rows[n]["also"])}
                   if "also" in rows[n] else {})}

    # the analysis phase's numbers again, short, near the end of the output
    obs = analysis["observed"]
    emit({"phase": "analysis_summary", "nvidia_smi": smi,
          "syncs": obs["syncs"], "sites": obs["sites"], "hot": obs["hot"],
          "hot_sites": len(obs["hot_sites"]), "flagged": obs["flagged"],
          "missed": obs["missed"], "outside_scope": obs["outside_scope"],
          "outside_package": obs["outside_package"],
          "planted": {"dropped": analysis["planted"]["dropped"],
                      "caught": analysis["planted"]["dropped"]
                      in analysis["planted"]["missed"]},
          "tpr001_findings": analysis["tpr001_findings"],
          "lint_s": analysis["lint_s"], "seconds": analysis["seconds"]})
    lin = main_report["kernel_vs_plain"]["linear"]
    a12k = a12_report["kernel_vs_plain"]
    emit({"kernels": [{
        "name": "tick_sim", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tick_sim.cu",
        "replaces": "src/repro/kernels/tick_sim.py:350",
        "launches": launches,
        "shard_main_path": {"launches": shard_launches},
        "max_abs_err": max(lin["max_abs_err"], a12k["max_abs_err"],
                           parity["max_abs_err"]),
        "max_rel_err": max(lin["max_rel_err"], a12k["max_rel_err"],
                           parity["max_rel_err"]),
        "tolerance": {"rtol": RTOL, "atol": ATOL, "swaps": "exact"},
        "shape": "T=%d B=%d A=2 L=48 pid+guard" % (SIZES["main_T"],
                                                   SIZES["main_B"]),
        "ms": lin["ms"], "cycles_per_tick": lin["cycles_per_tick"],
        "sm_mhz": lin["sm_mhz"], "plain_ms": lin["plain_ms"],
        "bound_ms": lin["bound_ms"], "bound_by": lin["bound_by"],
        "library_ms": None,
        "also": {"shape": "T=%d B=%d A=12 L=48 chain membound+guard"
                 % (SIZES["a12_T"], SIZES["a12_B"]),
                 "ms": a12k["ms"], "cycles_per_tick": a12k["cycles_per_tick"],
                 "sm_mhz": a12k["sm_mhz"], "plain_ms": a12k["plain_ms"],
                 "bound_ms": a12k["bound_ms"],
                 "bound_by": a12k["bound_by"]}}] + [{
        "name": n, "route": "cuda", "source": LLM_REPLACES[n][0],
        "replaces": LLM_REPLACES[n][1],
        "launches": (path_launches[n] + hyb_launches[n] + moe_launches[n]
                     + mla_launches[n]
                     + sum(r["launches"][n] for r in train_reports.values())
                     + mesh_launches.get(n, 0)
                     + mra_launches.get(n, 0)
                     + families["launches"][n]),
        **kernel_row(serve_rows[n]),
        **({"also": kernel_row(serve_rows[n]["also"])}
           if "also" in serve_rows[n] else {}),
        "hybrid": sub_row(hyb_rows, hyb_launches, n),
        **({"moe": sub_row(moe_rows, moe_launches, n)} if n in moe_rows
           else {}),
        **({"mla": sub_row(mla_rows, mla_launches, n)} if n in mla_rows
           else {}),
        **({"train": train_row(train_reports, n, train_kernels_report)}
           if n in TRAIN_FUNCTIONS else {}),
        **({"train_mesh": {"launches": mesh_launches[n],
                           "ranks": TRAIN_MESH["world"]}}
           if n in mesh_launches else {}),
        "mesh_families": {"launches": families["launches"][n],
                          "ranks": MESH_FAMILIES["world"]},
        **({"mesh_mra": {"launches": mra_launches[n],
                         "ranks": MESH_MRA["world"]}}
           if mra_launches.get(n) else {}),
        **({"lse": {"launches": families["lse_launches"],
                    **{k: kernel_lse_row(v) for k, v in
                       families["decode_lse"].items()}}}
           if n == "flash_decode" else {})}
        for n in LLM_REPLACES]})
    print(smi, flush=True)
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
