#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU. Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failed check exits non-zero before the result line):

1. device  — a CUDA device must be present; prints ``nvidia-smi``'s card
             name and power limit.
2. build   — compiles every CUDA kernel from ``src/repro_torch/csrc`` with
             ``nvcc`` (one process per source, all at once), timed.
3. kernels — at the serve path's own inputs (captured from one request of
             the default launcher stack, fp32 and bf16) and on clamped,
             all-invalid, -0.0-row and empty-grid cases, each kernel must
             equal its plain PyTorch version bit for bit (compared as
             integers, so -0.0 is not +0.0), each call twice; then a sweep
             of both kernels' lane plans (d 16/64/128/256 in fp32 and
             bf16, bf16 d 37, fans 1/5/33, the hot[1:] view in bf16, rows
             of -0.0, 200,000 segments grid-stride), and ``-Xptxas -v``
             must report no spills. Times the kernel, the plain version,
             one PyTorch library call computing the same function
             (``index_select`` / ``F.embedding_bag`` on a pre-concatenated
             table; the port never calls them) and the launch floor (an
             in-place add on one element) with CUDA events, as medians;
             computes each kernel's HBM/compute bound from the inputs.
4. serve   — runs the port's launcher (``repro_torch.launch.serve``) at its
             defaults on ``cuda`` twice, fused and ``--fuse-aggregate``,
             with the launch counters set to 0 just before each run and
             read just after: each path's kernel must have launched. Then
             the same host-sampled hops must give bitwise-equal outputs on
             the two paths, and the card's ``HostExecutor`` outputs must be
             finite, of the served shape, and within 1e-4 of the port on
             the CPU for the same seed.
4b. cold   — the launcher again at its defaults with the cold path and the
             control loop on (``--adaptive --prefetch --gpu-cache
             --spill-path``, control period ``COLD_ADAPT_INTERVAL``): fused,
             ``--fuse-aggregate``, ``--gateway --priority mixed
             --deadline-ms GATEWAY_DEADLINE_MS`` and ``--models a=sage-base
             --models b=sage-wide``. Each run records the store's lookups
             from the first admission on (entry, hops, outputs, and the
             placement generation before and after each), and the fused
             and fuse-aggregate runs add ``CHURN_STEPS`` control steps (FAP
             on the card, migration, a prefetch refresh on the side
             stream) beside a thread repeating recorded lookups. Every
             recorded lookup is replayed on a pristine store (the same
             features and original plan, no cache, no stage) and must
             give the same integer bits. Each run must have migrated rows,
             staged rows, cache hits, prefetch hits and launches of its
             serve kernel; some lookups must come after a migration and,
             with churn, some must overlap one; the gateway's outcomes
             must partition the requests. Prints rps, p50, p99 and host
             fetches per request beside the same run without the cold
             path (phase 4).
4c. sharded — the distributed path: the launcher at its defaults with
             ``--sharded --mesh-world SHARDED_WORLD --prefetch
             --sharded-spill-dir`` (4 logical shards on one card, one a
             card where there are more), then again with ``--adaptive``.
             Every ``lookup_hops`` call on the sharded store (calibration,
             warm-up, serving) is recorded and replayed on fresh sharded
             stores under both strategies, stage off and on, over the
             launcher's placement and over one with the single-host HBM
             budget (DISK rows, per-shard spill files), with the most-read
             rows and the most-read WARM rows made -0.0: the bits must
             equal a pristine single-host store's, except that
             ``allgather`` returns +0.0 for a -0.0 read from another
             shard's WARM row (the reference's sum), which must occur. On
             the replay stores ``exchanges``, ``exchanged_ids``,
             ``stage_hits`` and (DISK placement) ``spill_reads`` must be
             > 0 and ``exchanged_ids`` at most the occurrences exchanged.
             An engine over host, device and sharded executors with
             registered curves must route to all three, and the sharded
             executor must answer a batch above ``max_batch``. Logs rps,
             p50, p99 and ``routed`` of each run, the sharded and
             single-host collect ms, the dedup ratio, and ``lookup_hops``
             ms (host clock and CUDA events) and device ops a lookup at
             1, 2 and 4 shards under both strategies.
5. din     — builds the DIN recsys stack of ``repro_torch.launch.
             recsys_din --config din`` (10M-row item table placed through
             the tiered store). Kernel checks first: ``embedding_bag`` at
             the inputs ``din_forward`` hands it (captured at ``serve_p99``
             and at one ``retrieval_cand`` chunk; sum and mean, with and
             without weights, fp32 and bf16; all-padding bags, ids past the
             table, empty grids; the copy ring's edges: bags of
             ``LONG_LIST`` ids, the ``table[1:]`` view in bf16, bf16 d 37,
             each call repeated for equal bits) must be bitwise equal to
             its plain version, and ``-Xptxas -v`` must report no spills;
             kernel, plain version and ``F.embedding_bag`` on the
             compacted valid ids are timed. Then it serves
             ``DIN_BATCHES`` batches of 512 with the counter zeroed just
             before and read just after (exactly 2 launches a batch),
             checks the store path bitwise equal to the direct-table path
             and within 1e-4 of the port on the CPU, and scores 1,000,000
             candidates for one user (exactly 2 launches per chunk of
             31,250; finite; the first 4,096 within 1e-4 of the CPU port).
5b. din train — DIN ``train_batch`` at full size through ``repro_torch.
             launch.recsys_din --config din --train-steps
             DIN_TRAIN_STEPS`` (B 65,536, history 100, the 10M-row item
             table as a parameter on the card), the ``embedding_bag``
             counter zeroed just before and read just after: exactly 2
             launches a step (the two bags' forwards; their backward is
             torch ops). Finite losses, step 0 within 0.1 of ln 2, step
             ms and its stages, peak under the card's memory. The last
             step's two calls (the weighted interest sum and the mean over
             the 6,553,600 × 36 history table) are recorded, held bitwise
             to the plain version and timed beside it, ``F.embedding_bag``
             and the bound. Then card
             vs CPU gradients at the example config (``hold_card_vs_cpu``:
             the loss within ``CPU_TOL``, every gradient against an fp64
             witness within ``GRAD_TOL`` of its size).
6. train   — GIN-TU full-graph training at the ``ogb_products`` shape
             (2,449,408 nodes, 61,859,840 edges, d_feat 100, 47 classes).
             Kernel checks first: ``segment_spmm`` at the inputs one GIN
             forward and backward hand it (layer 1 at d 100, layer 2 at d
             64, the first backward on the transposed table), fp32 and
             bf16, weighted or not, with ``-1`` in mid-row and all-invalid
             rows, and the copy ring's edges: lists of ``LONG_LIST`` ids,
             the ``feat[1:]`` view in bf16, bf16 d 37, each call repeated)
             must be bitwise equal to its plain version, and ``-Xptxas -v``
             must report no spills; a repeated backward call gives the same
             bits; empty grids give zeros without a launch. Kernel, plain
             version and ``torch.sparse.mm`` on the CSR adjacency
             (cuSPARSE; the port never calls it) are timed, and each
             captured call's rate on the gathered bytes is logged as a
             share of HBM's 3.35 TB/s. Then ``repro_torch.launch.train`` runs
             ``TRAIN_STEPS`` steps at that shape with the counter zeroed
             just before and read just after (exactly 9 launches a step:
             5 forward, 4 backward), finite losses, and its peak device
             memory; at the launcher's default size the card's first-step
             loss is held against the port on the CPU, and each
             parameter's gradient (and all of them in norm) against an
             fp64 witness on the CPU.
6d. halo  — halo-sharded training (run after 6c, before 6b): ``repro_torch.
             launch.train --mesh-world HALO_WORLD`` at ``TRAIN_SHAPE`` for
             ``TRAIN_STEPS`` steps (4 logical shards on one card, one a card
             where there are more), the ``segment_spmm`` counter zeroed just
             before and read just after: exactly ``SPMM_PER_STEP`` launches a
             step a card; finite losses, no id dropped at the reference's
             ``cap_pp``, the first loss within ``HALO_LOSS_TOL`` of phase 6's
             unsharded loss on the same batch and weights; peak memory,
             ``remote_fraction`` and the exchange counters logged. The first
             step's layer-2 ``segment_spmm`` call (ids into the exchange
             buffer) is recorded, held bitwise to its plain version (twice)
             and timed beside it, ``torch.sparse.mm`` and its bound (distinct
             rows read once). Then EquiformerV2: the launcher with
             ``--mesh-world HALO_WORLD`` (no kernel of the repo launches); at
             its published widths on the launcher's graph through the halo
             cell at the reference's ``cap_pp`` (losses, step ms, peak,
             dropped share); at a no-drop ``cap_pp`` its loss within
             ``CPU_TOL`` of the unsharded loss, and the card's sharded loss
             within ``CPU_TOL`` of the CPU port's at ``GEO_CPU_GRAPH``. One
             ``{"halo": ...}`` line.
6b. geometric — SchNet, MeshGraphNet and EquiformerV2 training: each
             through ``repro_torch.launch.train --arch A --steps
             GEO_STEPS`` at the launcher's defaults with the five kernels'
             counters zeroed just before and read just after (this path
             must launch none), finite losses, wall time and peak memory;
             EquiformerV2 at its published widths (``_init``, EQ_PARAMS
             parameters) trained ``GEO_STEPS`` steps by ``run_training``
             at the launcher's graph and at the ``molecule`` shape (step
             ms, peak memory, losses); ``repro_torch.launch.
             train_gnn_100m --params-scale full`` (MGN_FULL_PARAMS
             parameters) for ``MGN_FULL_STEPS`` steps; card vs CPU for
             each arch at its published widths on ``GEO_CPU_GRAPH`` (loss
             within ``CPU_TOL``; every gradient against an fp64 CPU
             witness within ``GRAD_TOL`` of its own size, MeshGraphNet
             ``MGN_GRAD_TOL``, EquiformerV2's logit biases over their
             weight's size; all of it within ``GRAD_TOL`` in norm); full-
             width EquiformerV2's logits under ``rotation_matrix_zyz(
             EQ_ROTATION)`` within ``EQ_EQUIV_TOL`` and with 8 edge chunks
             within ``EQ_CHUNK_TOL``. One ``{"geometric": ...}`` line.
6c. full graph — GAT and SAGE full-graph forwards on the serve
             launcher's graph (20,000 nodes, 239,991 edges) with the
             features looked up from its store (checked equal to the
             launcher's): SAGE at sage-base widths (128-128), its
             neighbour sums through ``segment_spmm`` on the out-neighbour
             ELL table (20,000 × 5,003), exactly one launch a layer; GAT
             at 4 heads × 32, none; each within ``CPU_TOL`` of the port on
             the CPU; the kernel at both SAGE layers' inputs bitwise equal
             to its plain version, layer 1's call timed beside it and
             ``torch.sparse.mm``, with its bound (distinct rows read once).
7. lm      — qwen3-4b serving at its published widths and 36 layers.
             The earlier stacks are released first. ``repro_torch.launch.
             lm`` runs at its defaults (one request: a 32,768-token prefill,
             then 16 greedy decode steps, bf16 serving weights) with the
             ``flash_attention`` counter zeroed just before and read just
             after (exactly 36 launches: one a layer, none in decode);
             logits finite, generated ids in the vocabulary. Layer 0's and
             layer 35's q/k/v of that prefill are kept (references, no
             copy). Kernel checks: at those inputs in bf16 and cast to
             fp32, and on edge cases (Sq 257, non-causal, H = KV = 20, dh
             64, B 2, Sq 200 < Skv 700, B 2 of 100-token sequences), the
             kernel must be within ``ref.tolerance`` of its plain version
             (fp32 2e-5; bf16 one ulp of the larger magnitude plus 2e-5);
             Sq = 0 and Skv = 0 give zeros without a launch. Kernel, plain
             version and ``F.scaled_dot_product_attention`` (the port never
             calls it) are timed at layer 0's inputs, eager, 1 call a
             sample; the log and the ``kernels`` entry add the bf16 design,
             TFLOP/s and the ratios to the bound and to SDPA; the log, the
             time before the redesign (PERF.md) and the compiler's
             registers and spills. Then card vs CPU at full width with 2 layers and a
             257-token prompt: fp32 logits and the fp32 k/v the cache
             stores within 1e-4, the bf16 cache within one bf16 ulp plus
             1e-4; bf16 serving weights and activations within
             ``LM_BF16_CPU_TOL``.
7b. moe   — deepseek-moe-16b serving at its published widths and 28
             layers, after phase 7's memory is freed: ``repro_torch.launch.
             lm --arch deepseek-moe-16b`` at its defaults (a 32,768-token
             prefill, 16 greedy decode steps, bf16 weights, fp32 routers)
             with the ``flash_attention`` counter zeroed just before and
             read just after (exactly 28 launches a request, all causal);
             logits finite, ids in the vocabulary, peak device memory under
             the card's total; the prefill's router stats reported (dropped
             assignments are counted, not failed), every expert's load at
             most its capacity and kept + dropped = T·k in every layer.
             Logs prefill ms, decode ms a token, peak GiB, the dropped
             share and ``expert_placement(layer-0 load, 4, 4)``. The kernel
             at layer 0's q/k/v there (1, 32768, 16|16, 128), bf16 and cast
             to fp32, within ``ref.tolerance`` of its plain version, timed
             beside the plain version and SDPA (the ``kernels`` entry's
             ``deepseek_moe_16b`` key). Then card vs CPU at full width with
             2 layers and a 257-token prompt, fp32 and bf16: each layer's
             ``top_e`` compared (a differing token is reported with its gap
             between the k-th and (k+1)-th router probabilities, and that
             layer's MoE output is held with the card's routing fed to the
             CPU: fp32 within 1e-4, bf16 within ``MOE_BF16_ULPS`` ulps);
             fp32 logits within 1e-4, bf16 within ``LM_BF16_CPU_TOL``.
7c. lm train — qwen3-4b ``train_4k`` at its published widths and 36
             layers, last, with nothing else on the card: ``repro_torch.
             launch.lm --shape train_4k --steps LM_TRAIN_STEPS --batch 1``
             (fp32 weights and AdamW state, bf16 activations, 4,096
             positions); finite losses, step 0 between ln V and ln V +
             1.5, peak under the card's memory, step ms and its stages
             (forward, backward, optimizer). Then card vs CPU at the
             smoke reduction: fp32 through ``hold_card_vs_cpu``; bf16
             activations against the fp64 witness within
             ``LM_BF16_LOSS_TOL`` (loss) and ``LM_BF16_GRAD_TOL``
             (gradients in norm).
8. figures — the paper's evaluation, last, after the earlier phases'
             memory is freed: the eight modules of ``repro_torch.bench.run``
             on ``cuda`` at the reference's sizes, then
             ``placement_compare`` and ``feature_collection`` at
             ogbn-products' size (2,449,029 nodes, average degree 25.26,
             d 100), then ``calibration``, ``skew_robustness`` and
             ``serve_throughput`` (600 requests, at once and paced) there,
             each row on its own line, with every counter set to 0 just
             before and read just after. Prints
             ``tier_bandwidths``' table (with the card's name and power
             limit). Every module must end ``ok``; the hash, degree, freq
             and p3 plans must pass ``validate()``; every non-P3 store's
             ``lookup`` (device tiers only and with host rows) and
             ``lookup_hops`` must equal the features indexed on the host
             bit for bit; ``tiered_gather`` must have launched exactly once
             for each ``lookup_hops`` the figures' stores served, and no
             other kernel at all. Then ``tiered_gather`` at each
             products-size store's largest call, bitwise to its plain
             version, timed beside it, ``index_select``, its bound and the
             launch floor. One ``{"figures": ...}`` line.
8b. serving — the eight serving benchmarks of ``repro_torch.bench.run``
             (``fused_gather``, ``gather_aggregate``, ``prefetch``,
             ``sharded_hierarchy`` at 4 logical shards, ``flash_crowd``,
             ``gateway_soak``, ``multi_model``, ``workload_drift``) on
             ``cuda`` at the reference's full sizes, one at a time, every
             counter set to 0 just before and read just after. Each must
             end ``ok``, its in-run assertions holding on the card (fused
             == per-hop, staged == unstaged, spill-backed and cached ==
             all-HOT, sharded == single-host with one exchange of distinct
             ids, the gateway's outcomes partitioning the requests and its
             interactive p99 below FIFO's). Every module but
             ``sharded_hierarchy`` must have made ``lookup_hops`` calls
             and launched ``tiered_gather``; ``sharded_hierarchy`` none
             (its shards gather for themselves). ``tiered_gather`` must
             have launched once for each ``lookup_hops`` made with no
             device cache attached (with one attached, at most once a
             call); ``gather_aggregate`` once for each
             ``lookup_aggregate``, in ``gather_aggregate`` only (its
             autotune's launches counted apart); no other kernel at all.
             Then every launch shape ``autotune_gather_aggregate`` sweeps,
             at the module's inputs and at d 16, 64 and 256
             (``AUTOTUNE_SHAPE``), bitwise to the plain version, with each
             one's µs, the chosen plan, the bound and ``F.embedding_bag``.
             One ``{"serving_benches": ...}`` line.
9. summary — one ``{"kernels": [...]}`` line (``launches_by_path`` splits
             ``embedding_bag``'s and ``segment_spmm``'s launches by path:
             ``segment_spmm``'s GIN-TU train, SAGE full graph and GIN-TU
             halo; ``tiered_gather``'s GNN serve, the paper's figures,
             whose products-size calls are under ``paper_figures``, and
             each serving benchmark (``bench/<module>``);
             ``gather_aggregate``'s GNN serve and its benchmark, with the
             autotune's rows under ``autotune``),
             then the result line
             ``{"ok": true, "device": {...}}`` as the last line.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SERVE_REQUESTS = 200
DIN_BATCHES = 8
DIN_CANDIDATES = 1_000_000
DIN_CPU_CANDIDATES = 4096  # retrieval scores held against the CPU port
CPU_TOL = 1e-4            # card vs CPU model outputs (fp32, other sum order)
TRAIN_STEPS = 2
TRAIN_SHAPE = dict(nodes=2449408, edges=61859840, d_feat=100, classes=47)
SPMM_PER_STEP = 9          # 5 forward + 4 backward (layer 1 needs none)
# card gradients at the launcher's default size, per parameter, against
# an fp64 witness (the port on the CPU in fp64): max |diff| over that
# parameter's own largest fp64 gradient entry. The CPU port in fp32 reaches
# 8.1e-5 of it on the weights and biases, and 2.0e-3 on a scalar ε (its
# gradient is one sum over every node and channel, which cancels).
GRAD_TOL = 1e-3
EPS_GRAD_TOL = 1e-2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_TENSOR_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
LM_CAPTURE_LAYERS = (0, 35)
LM_CPU_LAYERS = 2          # card vs CPU: full width, depth cut to 2
LM_CPU_PROMPT = 257
# layer 0's time of the design before wgmma+tma (mma.sync q.k^T, fp32 p.v
# on the CUDA cores; PERF.md), named in the log only: not measured here
FLASH_PREV_MS = 218.16
# card vs CPU in bf16 weights and activations, max |logit diff|: bf16
# rounds in other orders on the two sides; the CPU port's bf16 logits sit
# ~0.05 from its fp32 ones at this shape (vocab cut to 8,192), so two bf16
# runs are held to 0.125 (set before the card ran it; PERF.md, PR 14)
LM_BF16_CPU_TOL = 0.125
LONG_LIST = 500            # ids a list in the ring checks: longer than a ring
LONG_LISTS = 65536         # lists of that length in segment_spmm's check
SERVE_FANS = (1, 5, 33)    # serve kernels' sweep: 33 is over a window of 32
GRID_STRIDE_SEGMENTS = 200_000  # more segments than the grid holds at once
COLD_ADAPT_INTERVAL = 16   # control period of the cold-path runs (default 32)
GATEWAY_DEADLINE_MS = 250  # interactive requests' deadline in the gateway run
CHURN_STEPS = 6            # control steps beside a reader thread
MOE_ARCH = "deepseek-moe-16b"  # phase 7b: MoE serving at full width and depth
MOE_KEY = "deepseek_moe_16b"   # its flash_attention numbers in the entry
# card vs CPU, one MoE layer in bf16 on the same routing: bf16 ulps of the
# output's largest magnitude (both sides round the expert products, the
# SiLU and each of the k combine adds; tests/test_torch_moe.py's bound)
MOE_BF16_ULPS = 4
GEO_ARCHS = ("schnet", "meshgraphnet", "equiformer-v2")  # phase 6b
GEO_STEPS = 3
GEO_CPU_GRAPH = dict(nodes=512, edges=2048, d_feat=64, classes=16)
EQ_PARAMS = 40_054_724     # equiformer_v2._init at d_feat 64, 16 classes
MGN_FULL_PARAMS = 37_609_475  # train_gnn_100m --params-scale full
MGN_FULL_STEPS = 4
# MeshGraphNet's gradients at GEO_CPU_GRAPH, per parameter over its own
# size: its 30 ReLU MLPs see pre-activations within fp32 rounding of 0,
# and a ReLU that fp32 rounding flips moves its hidden unit's row of the
# gradient by one edge's term (the CPU port in fp32: 5.5e-4; the card's
# first run: 1.17e-3 on blocks.11.edge.mlp.layers.0.weight). The whole
# gradient is still held to GRAD_TOL in norm.
MGN_GRAD_TOL = 1e-2
EQ_ROTATION = (0.4, 1.0, -0.3)  # zyz angles of the equivariance check
# EquiformerV2 at full width (l_max 6, 12 layers) on GEO_CPU_GRAPH without
# self-loops, max |logit diff|: rotated positions against unrotated, and 8
# edge chunks against 1. The CPU port gives 5.7e-6 and 4.8e-6 on logits
# of magnitude 9.4; the card's atomic sums add in other orders, so 10×
# that (set before the card ran it).
EQ_EQUIV_TOL = 5e-5
EQ_CHUNK_TOL = 5e-5
SHARDED_WORLD = 4          # logical shards of phase 4c on one card
HALO_WORLD = 4             # phase 6d: logical shards of the halo step
# phase 6d: the halo-sharded GIN-TU's first loss against phase 6's
# unsharded one on the same batch and weights. With no id dropped and the
# 4 shards on one card, every node's logits are the same ops on the same
# rows in the same order (the ELL lists a node's edges in edge order either
# way); only the loss's mean is summed shard by shard (set before the card
# ran it)
HALO_LOSS_TOL = 1e-5
SHARDED_HOT_FRAC = 0.25    # the launcher's --hot-frac
DIN_TRAIN_STEPS = 3        # phase 5b: train_batch steps at full size
DIN_CPU_TRAIN_BATCH = 256  # phase 5b's card vs CPU: the example config
FULL_GRAPH_SAGE = [128, 128, 128]  # phase 6c: sage-base widths
FULL_GRAPH_GAT = ([128, 32, 32], 4)  # phase 6c: 4 heads of 32
SAGE_LAYERS = 2            # segment_spmm launches a sage_full_graph call
LM_TRAIN_STEPS = 3         # phase 7c: qwen3-4b train_4k steps, B 1
LM_TRAIN_PARAMS = 4_411_415_040
# phase 7c's card vs CPU at the smoke reduction in bf16 activations (fp32
# weights): the loss within 2e-2 of the fp64 CPU witness, the gradients
# within 5e-2 of its norm (bf16 keeps 8 bits; both sides round q, k, v,
# p, every product's output and the residual stream; set before the card
# ran it)
LM_BF16_LOSS_TOL = 2e-2
LM_BF16_GRAD_TOL = 5e-2


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, *, inner: int = 20, reps: int = 25,
            graph: bool = True) -> float:
    """Median milliseconds per call of ``fn`` on the card: CUDA events
    around ``inner`` back-to-back calls, after a warm-up. With ``graph``
    the calls are captured once in a CUDA graph and replayed, so the time
    is the device's alone; without it, eager calls, so the host's cost of
    issuing each call counts too."""
    import torch
    fn()
    torch.cuda.synchronize()
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(inner):
                fn()
        run = g.replay
    else:
        def run():
            for _ in range(inner):
                fn()
    run()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def check_no_spills(name: str) -> dict:
    """Fail if ``-Xptxas -v`` reports a stack frame or spills for any
    compiled kernel of ``name``; return the report."""
    from repro_torch.kernels import build
    res = build.ptxas_resources(build.build_log(name))
    check(bool(res), f"{name}: no ptxas report in the build log")
    bad = {fn: r for fn, r in res.items()
           if r.get("spill_stores") or r.get("spill_loads") or r.get("stack")}
    check(not bad, f"{name}: ptxas reports spills: {bad}")
    regs = sorted({r["registers"] for r in res.values()})
    log(f"{name} ptxas: {len(res)} instantiations, registers {regs}, "
        "0 bytes of stack and spills")
    return res


# ---------------------------------------------------------------------------
# phase 3 helpers
# ---------------------------------------------------------------------------
def capture_serve_inputs(stack, fanouts, seeds):
    """The exact arguments the store hands each kernel for one request of
    the default stack (one fused and one fuse-aggregate request)."""
    from repro_torch.core import feature_store as fs
    from repro_torch.serving import HostExecutor
    graph, _, _, _, store, _, infer = stack
    captured = {}
    originals = {"tiered_gather": fs.tiered_gather,
                 "gather_aggregate": fs.gather_aggregate}

    def recorder(name):
        def wrapped(*args):
            captured[name] = args
            return originals[name](*args)
        return wrapped

    try:
        for name in originals:
            setattr(fs, name, recorder(name))
        for fuse_aggregate in (False, True):
            ex = HostExecutor(graph, store, fanouts, infer, rng_seed=1,
                              fuse_aggregate=fuse_aggregate)
            ex.run(seeds)
            ex.close()
    finally:
        for name, fn in originals.items():
            setattr(fs, name, fn)
    return captured


def distinct_rows(tier, slot, tables):
    """Distinct (table, row) pairs a call must read at least once."""
    return sum(int(slot[tier == t].long().clamp(0, table.shape[0] - 1)
                   .unique().numel()) for t, table in enumerate(tables))


def bits(x):
    """``x``'s bits as integers: equal bits, not equal values (-0.0 is not
    +0.0 here)."""
    from repro_torch.kernels.build import int_bits
    return int_bits(x)


def negative_zeros(table):
    """Make every 7th row of ``table`` -0.0, and every 3rd value of the
    rows after those, in place; returns ``table``."""
    table[::7] = -0.0
    table[1::7, ::3] = -0.0
    return table


def sweep_serve_kernels(gen) -> int:
    """Both serve kernels on seeded inputs across their lane plans: d 16,
    64, 128 and 256 in fp32 and bf16 and bf16 d 37, fans 1, 5 and
    ``SERVE_FANS[-1]`` (longer than a window of 32 children), the hot[1:]
    view in bf16, rows of -0.0 (a -0.0 singleton folds to +0.0 and copies
    as -0.0), and ``GRID_STRIDE_SEGMENTS`` segments (more than the grid
    holds at once). Each call twice; every result equal to the plain
    version's bit for bit. Returns the number of cases."""
    import torch
    from repro_torch.kernels import gather_aggregate as ga
    from repro_torch.kernels import tiered_gather as tg
    dev = torch.device("cuda")
    cases = [(d, dt, 0, 300, fan) for dt in (torch.float32, torch.bfloat16)
             for d in (16, 64, 128, 256) for fan in SERVE_FANS]
    cases += [(37, torch.bfloat16, 0, 300, fan) for fan in SERVE_FANS]
    cases += [(d, torch.bfloat16, 1, 300, fan) for d in (16, 37, 128, 256)
              for fan in SERVE_FANS]
    cases += [(d, torch.float32, 0, GRID_STRIDE_SEGMENTS, 5)
              for d in (16, 128)]
    for d, dtype, offset, segs, fan in cases:
        what = f"d {d} {dtype} offset {offset} S {segs} fan {fan}"

        def table(rows, off=0):
            x = torch.randn((rows + off, d), generator=gen, device=dev)
            return negative_zeros(x.to(dtype)[off:])

        hot, warm, cold = table(51, offset), table(40), table(9)
        tier = torch.randint(0, 5, (segs, fan), generator=gen, device=dev,
                             dtype=torch.int32)
        tier[tier == 3] = 99
        tier[tier == 4] = -1
        slot = torch.randint(-2, 60, (segs, fan), generator=gen,
                             device=dev, dtype=torch.int32)
        tier[0], slot[0] = 99, 0
        tier[0, 0], slot[0, 0] = 0, 7      # hot[7]: a -0.0 row, alone
        want = ga.gather_aggregate_ref(tier, slot, hot, warm, cold)
        first = ga.gather_aggregate(tier, slot, hot, warm, cold)
        again = ga.gather_aggregate(tier, slot, hot, warm, cold)
        ft, fs = tier.reshape(-1), slot.reshape(-1)
        want_tg = tg.tiered_gather_ref(ft, fs, hot, warm)
        first_tg = tg.tiered_gather(ft, fs, hot, warm)
        again_tg = tg.tiered_gather(ft, fs, hot, warm)
        torch.cuda.synchronize()
        check(torch.equal(bits(first), bits(want))
              and torch.equal(bits(again), bits(first)),
              f"gather_aggregate != plain by bits ({what})")
        check(not bits(first)[0].any(),
              f"gather_aggregate -0.0 singleton not +0.0 ({what})")
        check(torch.equal(bits(first_tg), bits(want_tg))
              and torch.equal(bits(again_tg), bits(first_tg)),
              f"tiered_gather != plain by bits ({what})")
        check(torch.equal(bits(first_tg[0]), bits(hot[7]))
              and bool((bits(hot[7]) != 0).all()),
              f"tiered_gather -0.0 row not copied as -0.0 ({what})")
    return len(cases)


def kernel_phase(stack, fanouts, seeds) -> list[dict]:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import gather_aggregate as ga
    from repro_torch.kernels import tiered_gather as tg
    from repro_torch.kernels.gather_aggregate import kernel as ga_kernel
    from repro_torch.kernels.tiered_gather import kernel as tg_kernel

    cap = capture_serve_inputs(stack, fanouts, seeds)
    check(set(cap) == {"tiered_gather", "gather_aggregate"},
          f"serve path reached only {sorted(cap)}")
    dev = torch.device("cuda")
    results = []

    # -- tiered_gather ------------------------------------------------------
    tier, slot, hot, warm = cap["tiered_gather"]
    m, d = tier.shape[0], hot.shape[1]
    log(f"tiered_gather serve inputs: M={m} d={d} hot={tuple(hot.shape)} "
        f"warm={tuple(warm.shape)} dtype={hot.dtype}")
    err = 0.0
    gen = torch.Generator(device=dev).manual_seed(0)
    rand_tier = torch.randint(0, 3, (m,), generator=gen, device=dev,
                              dtype=torch.int32)
    rand_tier[rand_tier == 2] = 99
    rand_slot = torch.randint(-5, max(hot.shape[0], warm.shape[0]) + 5, (m,),
                              generator=gen, device=dev, dtype=torch.int32)
    cases = {"serve": (tier, slot), "clamped": (rand_tier, rand_slot),
             "all-invalid": (torch.full_like(tier, 99), slot),
             "-0.0 rows": (tier, slot)}
    for dtype in (torch.float32, torch.bfloat16):
        for name, (t, s) in cases.items():
            h, w = hot.to(dtype), warm.to(dtype)
            if name == "-0.0 rows":
                h, w = negative_zeros(h.clone()), negative_zeros(w.clone())
            got = tg.tiered_gather(t, s, h, w)
            again = tg.tiered_gather(t, s, h, w)
            want = tg.tiered_gather_ref(t, s, h, w)
            torch.cuda.synchronize()
            check(torch.equal(bits(got), bits(want))
                  and torch.equal(bits(again), bits(got)),
                  f"tiered_gather != plain by bits ({name}, {dtype})")
            err = max(err, float((got.float() - want.float()).abs().max()))
            if name == "all-invalid":
                check(not got.any(), "tiered_gather all-invalid not zero")
        before = tg.LAUNCHES.value
        z = torch.zeros(0, dtype=torch.int32, device=dev)
        check(tg.tiered_gather(z, z, h, w).shape == (0, d)
              and tg.LAUNCHES.value == before,
              "tiered_gather empty grid launched or misshaped")
    log("tiered_gather == plain by bits (fp32, bf16; serve, clamped, "
        "all-invalid, -0.0 rows, empty; each call repeated)")
    table = torch.cat([hot, warm, hot.new_zeros((1, d))])
    h_rows, w_rows = hot.shape[0], warm.shape[0]
    sl = slot.long()
    lib_idx = torch.where(tier == 0, sl.clamp(0, h_rows - 1),
                          torch.where(tier == 1,
                                      h_rows + sl.clamp(0, w_rows - 1),
                                      h_rows + w_rows))
    lib_out = torch.index_select(table, 0, lib_idx)
    log("index_select yardstick == kernel: "
        f"{torch.equal(lib_out, tg.tiered_gather(tier, slot, hot, warm))}")
    elem = hot.element_size()
    read_rows = distinct_rows(tier, slot, (hot, warm))
    nbytes = 8 * m + read_rows * d * elem + m * d * elem
    results.append({
        "name": "tiered_gather", "route": "cuda",
        "source": "src/repro_torch/csrc/tiered_gather.cu",
        "replaces": "src/repro/kernels/tiered_gather/kernel.py:40",
        "max_abs_err": err,
        "ms": time_ms(lambda: tg.tiered_gather_cuda(tier, slot, hot, warm)),
        "plain_ms": time_ms(lambda: tg.tiered_gather_ref(tier, slot, hot,
                                                         warm)),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": time_ms(lambda: torch.index_select(table, 0, lib_idx)),
        "call_ms": time_ms(lambda: tg.tiered_gather_cuda(tier, slot, hot,
                                                         warm), graph=False),
        "bytes": nbytes, "shape": [m, d], "design": tg_kernel.DESIGN})

    # -- gather_aggregate ---------------------------------------------------
    tier, slot, hot, warm, cold = cap["gather_aggregate"]
    s, fan = tier.shape
    log(f"gather_aggregate serve inputs: S={s} fan={fan} d={d} "
        f"cold={tuple(cold.shape)} dtype={hot.dtype}")
    err = 0.0
    rand_tier = torch.randint(0, 4, (s, fan), generator=gen, device=dev,
                              dtype=torch.int32)
    rand_tier[rand_tier == 3] = 99
    rand_slot = torch.randint(-5, max(hot.shape[0], warm.shape[0]) + 5,
                              (s, fan), generator=gen, device=dev,
                              dtype=torch.int32)
    cases = {"serve": (tier, slot), "clamped": (rand_tier, rand_slot),
             "all-invalid": (torch.full_like(tier, 99), slot),
             "-0.0 rows": (tier, slot)}
    for dtype in (torch.float32, torch.bfloat16):
        for name, (t, sl_) in cases.items():
            h, w, c = hot.to(dtype), warm.to(dtype), cold.to(dtype)
            if name == "-0.0 rows":
                h, w, c = (negative_zeros(x.clone()) for x in (h, w, c))
            got = ga.gather_aggregate(t, sl_, h, w, c)
            again = ga.gather_aggregate(t, sl_, h, w, c)
            want = ga.gather_aggregate_ref(t, sl_, h, w, c)
            torch.cuda.synchronize()
            check(torch.equal(bits(got), bits(want))
                  and torch.equal(bits(again), bits(got)),
                  f"gather_aggregate != plain by bits ({name}, {dtype})")
            err = max(err, float((got.float() - want.float()).abs().max()))
            if name == "all-invalid":
                check(not got.any(), "gather_aggregate all-invalid not zero")
        before = ga.LAUNCHES.value
        for shape in ((0, fan), (s, 0)):
            z = torch.zeros(shape, dtype=torch.int32, device=dev)
            out = ga.gather_aggregate(z, z, h, w, c)
            check(out.shape == (shape[0], d) and not out.any(),
                  f"gather_aggregate empty grid {shape} wrong")
        check(ga.LAUNCHES.value == before,
              "gather_aggregate empty grid launched")
    log("gather_aggregate == plain by bits (fp32, bf16; serve, clamped, "
        "all-invalid, -0.0 rows, empty; each call repeated)")
    n_cases = sweep_serve_kernels(gen)
    log(f"tiered_gather and gather_aggregate == plain by bits in {n_cases} "
        "sweep cases (d 16/64/128/256 fp32 and bf16, bf16 d 37; fans "
        f"{SERVE_FANS}; hot[1:] in bf16; rows of -0.0; "
        f"{GRID_STRIDE_SEGMENTS} segments grid-stride; each call repeated)")
    check_no_spills("tiered_gather")
    check_no_spills("gather_aggregate")
    one = torch.zeros(1, device=dev)
    floor_ms = time_ms(lambda: one.add_(1))
    log(f"launch floor (an in-place add on one element, CUDA graph "
        f"replay): {floor_ms:.5f} ms")
    table = torch.cat([hot, warm, cold, hot.new_zeros((1, d))])
    h_rows, w_rows, c_rows = hot.shape[0], warm.shape[0], cold.shape[0]
    sl = slot.long()
    lib_idx = torch.where(
        tier == 0, sl.clamp(0, h_rows - 1), torch.where(
            tier == 1, h_rows + sl.clamp(0, w_rows - 1), torch.where(
                tier == 2, h_rows + w_rows + sl.clamp(0, c_rows - 1),
                h_rows + w_rows + c_rows)))
    lib_out = F.embedding_bag(lib_idx, table, mode="sum")
    kern_out = ga.gather_aggregate(tier, slot, hot, warm, cold)
    log("embedding_bag yardstick max |diff| vs kernel: "
        f"{float((lib_out - kern_out).abs().max()):.3g}")
    valid = int((tier <= 2).logical_and(tier >= 0).sum())
    read_rows = distinct_rows(tier, slot, (hot, warm, cold))
    nbytes = 8 * s * fan + read_rows * d * elem + s * d * elem
    flops = valid * d
    bound_s = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)
    results.append({
        "name": "gather_aggregate", "route": "cuda",
        "source": "src/repro_torch/csrc/gather_aggregate.cu",
        "replaces": "src/repro/kernels/gather_aggregate/kernel.py:69",
        "max_abs_err": err,
        "ms": time_ms(lambda: ga.gather_aggregate_cuda(tier, slot, hot, warm,
                                                       cold)),
        "plain_ms": time_ms(lambda: ga.gather_aggregate_ref(tier, slot, hot,
                                                            warm, cold)),
        "bound_ms": bound_s * 1e3,
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                     >= flops / FP32_FLOPS else "operations"),
        "library_ms": time_ms(lambda: F.embedding_bag(lib_idx, table,
                                                      mode="sum")),
        "call_ms": time_ms(lambda: ga.gather_aggregate_cuda(
            tier, slot, hot, warm, cold), graph=False),
        "bytes": nbytes, "shape": [s, fan, d], "design": ga_kernel.DESIGN})
    for r in results:
        r["floor_ms"] = floor_ms
        log(f"{r['name']} device time (CUDA graph replay): kernel "
            f"{r['ms']:.5f} ms, plain {r['plain_ms']:.5f} ms, library "
            f"{r['library_ms']:.5f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bytes']} bytes, {r['bound_by']}), launch floor "
            f"{floor_ms:.5f} ms ({r['ms'] - floor_ms:+.5f} ms from it); "
            f"eager wrapper call {r['call_ms']:.5f} ms; design: "
            f"{r['design']}")
    return results


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------
def serve_phase(results: list[dict], stack, fanouts, gen_seeds) -> dict:
    import numpy as np
    import torch
    from repro_torch.graph import host_sample_dense
    from repro_torch.kernels import gather_aggregate as ga
    from repro_torch.kernels import tiered_gather as tg
    from repro_torch.launch import serve as launcher
    from repro_torch.serving import HostExecutor

    counters = {"tiered_gather": tg.LAUNCHES, "gather_aggregate": ga.LAUNCHES}
    path_kernel = {"fused": "tiered_gather",
                   "fuse_aggregate": "gather_aggregate"}
    launches = {}
    baselines = {}
    for path, extra in (("fused", []), ("fuse_aggregate",
                                        ["--fuse-aggregate"])):
        args = launcher.parse_args(["--device", "cuda", "--requests",
                                    str(SERVE_REQUESTS), *extra])
        run_stack = launcher.stack_from_args(args)
        mark = FirstAdmission(run_stack[4])
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        with HostTimer(lookup_targets()) as timer:
            summary = launcher.serve(args, stack=run_stack, hooks=[mark])
        wall = time.perf_counter() - t0
        counts = {k: c.value for k, c in counters.items()}
        baselines[path] = dict(summary, host_fetches_per_request=(
            mark.served("host_fetches") / summary["requests"]),
            host_ms=timer.report())
        log(f"serve[{path}] host time of the store's entries: "
            f"{timer.report()}")
        log(f"serve[{path}]: {summary['requests']} requests, "
            f"{summary['throughput_rps']:.2f} rps, p50 "
            f"{summary['p50_ms']:.3f} ms, p99 {summary['p99_ms']:.3f} ms, "
            f"routed {summary['routed']}, launches {counts}, "
            f"store {summary['store']}, wall {wall:.1f} s")
        check(summary["requests"] == SERVE_REQUESTS,
              f"serve[{path}] answered {summary['requests']} requests")
        kernel = path_kernel[path]
        check(counts[kernel] > 0, f"serve[{path}] never launched {kernel}")
        launches[kernel] = counts[kernel]
        print(json.dumps({"serve": path, "requests": summary["requests"],
                          "throughput_rps": summary["throughput_rps"],
                          "p50_ms": summary["p50_ms"],
                          "p99_ms": summary["p99_ms"],
                          "routed": summary["routed"],
                          "executors": summary["executors"],
                          "launches": counts}), flush=True)
    for r in results:
        r["launches"] = launches[r["name"]]

    graph, _, _, _, store, _, infer = stack
    rng = np.random.default_rng(7)
    for i in range(8):
        hops = [torch.from_numpy(h).cuda() for h in host_sample_dense(
            rng, graph, gen_seeds[i], fanouts)]
        fused = infer(store.lookup_hops(hops), hops)
        feats, agg = store.lookup_aggregate(hops)
        folded = infer(feats, hops, deep_agg=agg)
        torch.cuda.synchronize()
        check(torch.equal(fused, folded),
              f"fused != fuse-aggregate outputs on batch {i}")
    log("fused == fuse-aggregate outputs bitwise on 8 host-sampled batches")

    def host_outputs(st):
        g, _, _, _, st_store, _, st_infer = st
        ex = HostExecutor(g, st_store, fanouts, st_infer, rng_seed=0)
        try:
            return [ex.run(gen_seeds[i]).cpu() for i in range(4)]
        finally:
            ex.close()

    cpu_stack = launcher.stack_from_args(
        launcher.parse_args(["--device", "cpu"]))
    worst = 0.0
    for i, (a, b) in enumerate(zip(host_outputs(stack),
                                   host_outputs(cpu_stack))):
        check(a.shape == (gen_seeds[i].shape[0], launcher.HIDDEN[-1]),
              f"output shape {tuple(a.shape)}")
        check(bool(torch.isfinite(a).all()), "non-finite card output")
        worst = max(worst, float((a - b).abs().max()))
    check(worst <= CPU_TOL, f"card vs CPU max |diff| {worst:.3g} > {CPU_TOL}")
    log(f"card HostExecutor outputs within {CPU_TOL} of the CPU port "
        f"(max |diff| {worst:.3g})")
    return baselines


# ---------------------------------------------------------------------------
# phase 4b
# ---------------------------------------------------------------------------
class HostTimer:
    """Host-clock time of named methods, patched on their classes while the
    context is open (every thread's calls count)."""

    def __init__(self, targets):
        import threading
        self.targets = list(targets)
        self.times: dict = {}
        self._lock = threading.Lock()
        self._saved = []

    def _timed(self, key, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                with self._lock:
                    self.times.setdefault(key, []).append(
                        time.perf_counter() - t0)
        return call

    def __enter__(self):
        for cls, name in self.targets:
            fn = getattr(cls, name)
            self._saved.append((cls, name, fn))
            setattr(cls, name,
                    self._timed(f"{cls.__name__}.{name}", fn))
        return self

    def __exit__(self, *exc):
        for cls, name, fn in reversed(self._saved):
            setattr(cls, name, fn)
        self._saved.clear()

    def report(self) -> dict:
        """{method: {calls, total_ms, p50_ms}}."""
        with self._lock:
            return {k: {"calls": len(v), "total_ms": sum(v) * 1e3,
                        "p50_ms": statistics.median(v) * 1e3}
                    for k, v in sorted(self.times.items())}


def lookup_targets():
    from repro_torch.core import TieredFeatureStore
    return [(TieredFeatureStore, "lookup_hops"),
            (TieredFeatureStore, "lookup_aggregate")]


def cold_targets():
    from repro_torch.core import GPUFeatureCache, Prefetcher
    from repro_torch.core import TieredFeatureStore
    from repro_torch.serving import AdaptiveController
    return lookup_targets() + [
        (AdaptiveController, "step"), (AdaptiveController, "target_plan"),
        (TieredFeatureStore, "swap_assignments"),
        (TieredFeatureStore, "promote_misses"),
        (GPUFeatureCache, "query"), (GPUFeatureCache, "replace"),
        (Prefetcher, "refresh")]


class FirstAdmission:
    """Engine hook: the store's counters when the first request is admitted
    (after calibration and warm-up), so a run's counters per request count
    serving alone."""

    def __init__(self, store):
        self.store = store
        self.at_start = None

    def on_admit(self, name, seeds, model=""):
        if self.at_start is None:
            self.at_start = self.store.snapshot_stats()

    def on_batch_complete(self, name, seeds, latency_s, model=""):
        pass

    def served(self, key: str) -> int:
        return self.store.snapshot_stats()[key] - self.at_start[key]


class LookupRecorder(FirstAdmission):
    """Records the store's lookups from the first admission on, as (entry,
    hops, outputs, generation before, generation after, migrations
    before): the generation counts migrations and stage publications."""

    def __init__(self, store):
        import threading
        super().__init__(store)
        self.calls: list = []
        self.generation = 0
        self.migrations = 0
        self.staged = []
        self._lock = threading.Lock()
        self.recording = False
        for name in ("lookup_hops", "lookup_aggregate"):
            setattr(store, name, self._recorded(name, getattr(store, name)))
        swap, publish = store.swap_assignments, store.publish_stage

        def swap_assignments(pairs):
            moved = swap(pairs)
            with self._lock:
                self.generation += 1
                self.migrations += 1
            return moved

        def publish_stage(stage_slot, stage_rows):
            publish(stage_slot, stage_rows)
            with self._lock:
                self.generation += 1
                if stage_slot is not None:
                    self.staged.append(int((stage_slot >= 0).sum()))

        store.swap_assignments = swap_assignments
        store.publish_stage = publish_stage

    def on_admit(self, name, seeds, model=""):
        super().on_admit(name, seeds, model)
        self.recording = True

    def _recorded(self, name, fn):
        def call(hops, **kw):
            gen0, mig0 = self.generation, self.migrations
            out = fn(hops, **kw)
            if self.recording:
                flat = (list(out[0]) + [out[1]] if name == "lookup_aggregate"
                        else list(out))
                entry = (name, [h.clone() for h in hops],
                         [o.clone() for o in flat], gen0, self.generation,
                         mig0)
                with self._lock:
                    self.calls.append(entry)
            return out
        return call


def replay_bitwise(calls, pristine) -> int:
    """Replay recorded lookups on a pristine store (original plan, no cache,
    no stage); every output must equal the recorded one as integer bits.
    Returns the calls replayed."""
    for i, (name, hops, outs, *_) in enumerate(calls):
        got = getattr(pristine, name)(hops)
        flat = list(got[0]) + [got[1]] if name == "lookup_aggregate" \
            else list(got)
        check(len(flat) == len(outs), f"replay {i}: {len(flat)} outputs")
        for k, (a, b) in enumerate(zip(outs, flat)):
            check(a.shape == b.shape and bits(a).equal(bits(b)),
                  f"replay {i} ({name}) output {k}: bits differ from the "
                  "pristine store's")
    return len(calls)


def churn(store, stack, fanouts, calls, steps: int) -> int:
    """Control steps (FAP on the card, migration, prefetch refresh on the
    side stream) while a reader thread repeats recorded lookups on the
    same store; the recorder keeps recording. Returns the reader's calls."""
    import threading
    import numpy as np
    from repro_torch.core import Prefetcher
    from repro_torch.serving import AdaptiveConfig, AdaptiveController
    graph, _, psgs, fap, _, _, _ = stack
    ctl = AdaptiveController(graph, fanouts, store, psgs_table=psgs,
                             config=AdaptiveConfig(rows_per_step=512))
    pf = Prefetcher(store, budget=1024)
    ctl.attach_prefetcher(pf)
    hot = np.argsort(fap)[:512]        # the coldest nodes turn hot
    stop, seen, errors = threading.Event(), [0], []
    sample = calls[:8]

    def reader():
        try:
            while not stop.is_set():
                for name, hops, *_ in sample:
                    getattr(store, name)(hops)
                    seen[0] += 1
        except Exception as exc:   # surfaced below, never swallowed
            errors.append(exc)

    t = threading.Thread(target=reader)
    t.start()
    try:
        for _ in range(steps):
            ctl.on_admit("churn", np.repeat(hot, 4))
            ctl.step()
    finally:
        stop.set()
        t.join(timeout=120)
        pf.close()
    check(not t.is_alive(), "churn reader still running after 120 s")
    check(not errors, f"churn reader raised {errors!r}")
    return seen[0]


def cold_path_phase(fanouts, baselines: dict) -> None:
    """The serve path with the cold path and control loop on, through the
    launcher at its default size: fused, fuse-aggregate, gateway, models."""
    import dataclasses
    import shutil
    from repro_torch.core import TieredFeatureStore
    from repro_torch.kernels import gather_aggregate as ga
    from repro_torch.kernels import tiered_gather as tg
    from repro_torch.launch import serve as launcher

    counters = {"tiered_gather": tg.LAUNCHES, "gather_aggregate": ga.LAUNCHES}
    spill_dir = ROOT / "build" / "spill"
    spill_dir.mkdir(parents=True, exist_ok=True)
    cold = ["--adaptive", "--prefetch", "--gpu-cache",
            "--adapt-interval", str(COLD_ADAPT_INTERVAL)]
    runs = (("fused", [], "tiered_gather"),
            ("fuse_aggregate", ["--fuse-aggregate"], "gather_aggregate"),
            ("gateway", ["--gateway", "--priority", "mixed", "--deadline-ms",
                         str(GATEWAY_DEADLINE_MS)], "tiered_gather"),
            ("models", ["--models", "a=sage-base", "--models",
                        "b=sage-wide"], "tiered_gather"))
    log(f"cold path: {' '.join(cold)} (adapt interval cut from 32 to "
        f"{COLD_ADAPT_INTERVAL} batches so a {SERVE_REQUESTS}-request run "
        "takes more control steps)")
    try:
        for path, extra, kernel in runs:
            t0 = time.perf_counter()
            args = launcher.parse_args(
                ["--device", "cuda", "--requests", str(SERVE_REQUESTS),
                 "--spill-path", str(spill_dir / f"{path}.spill"),
                 *cold, *extra])
            stack = launcher.stack_from_args(args)
            store = stack[4]
            plan0 = dataclasses.replace(
                store.plan, tier=store.plan.tier.copy(),
                slot=store.plan.slot.copy(),
                pod_owner=store.plan.pod_owner.copy(),
                device_owner=store.plan.device_owner.copy())
            timer = HostTimer(cold_targets())
            with timer:
                rec = LookupRecorder(store)
                for c in counters.values():
                    c.reset()
                summary = launcher.serve(args, stack=stack, hooks=[rec])
            counts = {k: c.value for k, c in counters.items()}
            stats = store.snapshot_stats()
            check(summary["requests"] > 0, f"cold[{path}] served nothing")
            # per request served: the gateway's shed requests do no lookup
            per_req = rec.served("host_fetches") / summary["requests"]
            log(f"cold[{path}]: {summary['requests']} requests, "
                f"{summary['throughput_rps']:.2f} rps, p50 "
                f"{summary['p50_ms']:.3f} ms, p99 {summary['p99_ms']:.3f} "
                f"ms, host_fetches/request {per_req:.3f}, launches "
                f"{counts}, migrated_rows {store.migrated_rows}, promoted "
                f"{store.promoted_rows}, staged {rec.staged}, store "
                f"{stats}, adaptation {summary.get('adaptation')}, cache "
                f"{summary.get('gpu_cache')}")
            log(f"cold[{path}] host time (calibration and warm-up "
                f"included): {timer.report()}")
            check(counts[kernel] > 0, f"cold[{path}] never launched {kernel}")
            check(store.migrated_rows > 0, f"cold[{path}]: nothing migrated")
            check(max(rec.staged, default=0) > 0,
                  f"cold[{path}]: nothing staged")
            check(stats["cache_hits"] > 0, f"cold[{path}]: no cache hit")
            check(stats["prefetch_hits"] > 0, f"cold[{path}]: no prefetch hit")
            if path == "gateway":
                gw = summary["gateway"]
                check(gw["completed"] + gw["shed_window"]
                      + gw["shed_deadline"] == SERVE_REQUESTS,
                      f"gateway outcome partition broken: {gw}")
                check(gw["completed"] > 0, "gateway completed nothing")
                log(f"cold[gateway]: partition holds: {gw['completed']} "
                    f"completed + {gw['shed_window']} shed_window + "
                    f"{gw['shed_deadline']} shed_deadline = "
                    f"{SERVE_REQUESTS}; classes {summary['classes']}")
            else:
                check(summary["requests"] == SERVE_REQUESTS,
                      f"cold[{path}] answered {summary['requests']}")
            if path == "models":
                check(set(summary["models"]) == {"a", "b"},
                      f"models served {sorted(summary['models'])}")
            served_calls = len(rec.calls)
            migrated = store.migrated_rows
            check(served_calls > 0, f"cold[{path}]: no lookup recorded")
            churned = 0
            if path in ("fused", "fuse_aggregate"):
                churned = churn(store, stack, fanouts, rec.calls,
                                CHURN_STEPS)
            calls = rec.calls
            straddled = sum(g0 != g1 for *_, g0, g1, _ in calls)
            after = sum(m0 > 0 for *_, m0 in calls)
            check(after > 0, f"cold[{path}]: no lookup after a migration")
            if path in ("fused", "fuse_aggregate"):
                check(straddled > 0, f"cold[{path}]: no lookup overlapped "
                      "a migration or a stage publication")
            pristine = TieredFeatureStore.build(stack[1], plan0,
                                                device="cuda")
            n = replay_bitwise(calls, pristine)
            log(f"cold[{path}]: {n} lookups replayed bitwise on a pristine "
                f"store ({served_calls} while serving, {n - served_calls} "
                f"in {CHURN_STEPS if churned else 0} churn steps beside "
                f"{churned} reader calls; {after} after a migration, "
                f"{straddled} overlapping a migration or a stage "
                f"publication) in {time.perf_counter() - t0:.1f} s")
            base = baselines.get(path if path in baselines else "fused")
            print(json.dumps({
                "cold_path": path, "requests": summary["requests"],
                "throughput_rps": summary["throughput_rps"],
                "p50_ms": summary["p50_ms"], "p99_ms": summary["p99_ms"],
                "host_fetches_per_request": per_req,
                "without": {k: base[k] for k in (
                    "throughput_rps", "p50_ms", "p99_ms",
                    "host_fetches_per_request")},
                "launches": counts, "migrated_rows": migrated,
                "churn_migrated_rows": store.migrated_rows - migrated,
                "staged_rows": max(rec.staged),
                "cache_hits": stats["cache_hits"],
                "prefetch_hits": stats["prefetch_hits"],
                "replayed": n, "straddled": straddled,
                "host_ms": {k: v["total_ms"]
                            for k, v in timer.report().items()},
                "host_ms_without": {k: v["total_ms"] for k, v in
                                    base["host_ms"].items()}}), flush=True)
            del rec, stack, store, pristine, calls
    finally:
        shutil.rmtree(spill_dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 4c
# ---------------------------------------------------------------------------
def sharded_targets():
    from repro_torch.core import ShardedFeatureStore, TieredFeatureStore
    return [(ShardedFeatureStore, "lookup_hops"),
            (TieredFeatureStore, "lookup_hops")]


class HopRecorder:
    """Records the hops of every ``ShardedFeatureStore.lookup_hops`` call
    while the context is open (calibration, warm-up and serving; the
    sampler's fresh tensors, which nothing writes afterwards)."""

    def __enter__(self):
        from repro_torch.core import ShardedFeatureStore
        self.calls = []
        self._fn = fn = ShardedFeatureStore.lookup_hops

        def lookup_hops(store, hops):
            self.calls.append(list(hops))
            return fn(store, hops)

        ShardedFeatureStore.lookup_hops = lookup_hops
        return self

    def __exit__(self, *exc):
        from repro_torch.core import ShardedFeatureStore
        ShardedFeatureStore.lookup_hops = self._fn


def most_read(calls) -> "np.ndarray":
    """Ids read by the recorded calls, the most-read first."""
    import numpy as np
    ids = np.concatenate([h.cpu().numpy() for hops in calls for h in hops])
    counts = np.bincount(ids[ids >= 0])
    return np.argsort(-counts, kind="stable")[:int((counts > 0).sum())]


def placement_at(fap, world: int, rows_per_device=None):
    """A placement over ``world`` shards with the launcher's HOST budget
    (half the nodes, the rest on DISK) and ``rows_per_device`` HBM rows a
    shard (default: the launcher's ``--sharded`` sizing, which covers the
    graph)."""
    from repro_torch.core import TopologySpec, quiver_placement
    n = fap.shape[0]
    if rows_per_device is None:
        rows_per_device = max(-(-n // world), 64)
    return quiver_placement(fap, TopologySpec(
        num_pods=1, devices_per_pod=world, rows_per_device=rows_per_device,
        rows_host=max(n // 2, 64), hot_replicate_fraction=SHARDED_HOT_FRAC))


def sharded_store_at(feats, plan, strategy: str, spill_dir=None):
    """A sharded store of the plan's shards, placed on the card(s)."""
    from repro_torch.core import ShardedFeatureStore, TieredFeatureStore
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(plan.topology.devices_per_pod, device="cuda")
    return ShardedFeatureStore.from_tiered(
        TieredFeatureStore.build(feats, plan, device=mesh.devices[0]),
        mesh, "x", strategy,
        spill_dir=None if spill_dir is None else str(spill_dir))


def replay_sharded(calls, ss, pristine) -> dict:
    """Replay recorded hops on ``ss``; every output must equal the pristine
    single-host store's bits, except that under ``allgather`` a -0.0 read
    from another shard's WARM row is +0.0 (the reference's sum). Returns
    counts: lookups, occurrences exchanged, remote -0.0 elements."""
    import numpy as np
    import torch
    from repro_torch.core.placement import TIER_HOST, TIER_WARM
    world = ss.world
    stage = ss._snapshot_stage()
    out = {"lookups": 0, "occurrences": 0, "remote_negzero": 0}
    for i, hops in enumerate(calls):
        got = torch.cat(ss.lookup_hops(hops))
        want = bits(torch.cat(pristine.lookup_hops(hops))).clone()
        ids = torch.cat(hops).cpu().numpy().astype(np.int64)
        safe = np.maximum(ids, 0)
        tier = ss.tier_np[safe]
        warm = (ids >= 0) & (tier == TIER_WARM)
        staged = ((ids >= 0) & (tier >= TIER_HOST) & (stage[0][safe] >= 0)
                  if stage is not None else np.zeros(ids.size, bool))
        out["occurrences"] += int((warm | staged).sum())
        if ss.strategy == "allgather":
            requester = np.arange(ids.size) // (ids.size // world)
            remote = torch.from_numpy(
                warm & (ss._owner_np[safe] != requester)).to(want.device)
            negzero = remote[:, None] & (want == -2 ** 31)
            out["remote_negzero"] += int(negzero.sum())
            want[negzero] = 0
        check(bits(got).equal(want),
              f"sharded replay {i} ({ss.strategy}, stage "
              f"{'on' if stage is not None else 'off'}): bits differ from "
              "the pristine store's")
        out["lookups"] += 1
    return out


def time_lookups(ss, calls) -> dict:
    """Host-clock and CUDA-event ms of ``lookup_hops`` over ``calls``
    (each call synchronized), and device activities (kernels, copies,
    memsets) per lookup under ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for hops in calls[:3]:
        ss.lookup_hops(hops)
    torch.cuda.synchronize()
    host, dev = [], []
    for hops in calls:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        ss.lookup_hops(hops)
        end.record()
        end.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(start.elapsed_time(end))
    sample = calls[:10]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for hops in sample:
            ss.lookup_hops(hops)
        torch.cuda.synchronize()
    launches = sum(e.device_type == DeviceType.CUDA for e in prof.events())
    return {"host_ms_p50": statistics.median(host),
            "event_ms_p50": statistics.median(dev),
            "device_ops_per_lookup": launches / len(sample)}


def three_executor_check(stack, world: int, fanouts) -> dict:
    """Host, device and sharded executors under one engine, each given a
    sweet spot on the PSGS axis (registered curves): all three must be
    routed to, and the sharded executor must answer a batch larger than
    its ``max_batch`` with one finite row per seed."""
    import numpy as np
    import torch
    from repro_torch.core import Request
    from repro_torch.launch import serve as launcher
    from repro_torch.serving import (CostModelRouter, LatencyCurve,
                                     ServingEngine, ShardedExecutor)
    graph, _, psgs, _, store, _, infer = stack
    ex = launcher.build_executors(graph, store, fanouts, infer, psgs,
                                  num_workers=1, max_batch=32)
    sstore = sharded_store_at(stack[1], placement_at(stack[3], world),
                              "alltoall")
    # no tier table: every batch is eligible
    ex["sharded"] = ShardedExecutor(sstore.mesh, "x",
                                    graph.device_arrays(sstore.device),
                                    sstore, fanouts, infer, max_batch=32,
                                    psgs_table=psgs)
    order = np.argsort(psgs)
    picks = [int(order[0]), int(order[order.size // 2]), int(order[-1])]
    xs = [float(psgs[s]) for s in picks]
    qmax = xs[-1] + 1.0

    def vcurve(center):
        grid = np.array([0.0, center, qmax])
        ys = np.abs(grid - center) + 1e-6
        return LatencyCurve(psgs=grid, avg=ys, mx=ys)

    router = CostModelRouter(psgs, "latency_preferred")
    for name, x in zip(("host", "device", "sharded"), xs):
        router.register(name, vcurve(x), kind="host" if name == "host"
                        else "device", executor=ex[name])
    engine = ServingEngine(ex, router, max_inflight=8)
    try:
        reqs = [Request(i, np.array([s]), time.perf_counter())
                for i, s in enumerate(picks * 4)]
        m = engine.run([[r] for r in reqs])
        check(all(m.routed.get(k, 0) > 0
                  for k in ("host", "device", "sharded")),
              f"three executors: routed {m.routed}")
        big = ex["sharded"].max_batch + 8
        out = ex["sharded"].run(np.arange(big))
        torch.cuda.synchronize()
        check(out.shape == (big, launcher.HIDDEN[-1])
              and bool(torch.isfinite(out).all()),
              f"sharded executor: {tuple(out.shape)} rows for {big} seeds")
    finally:
        engine.close()
    return dict(m.routed)


def sharded_phase(fanouts, baselines: dict) -> None:
    """The distributed serve path on the card: ``SHARDED_WORLD`` logical
    shards (one a card where there are more cards), through the launcher
    at its default size with ``--sharded --prefetch --sharded-spill-dir``,
    and again with ``--adaptive``; then replays, routing, mechanism
    counters and timings."""
    import shutil
    import torch
    from repro_torch.core import Prefetcher, TieredFeatureStore
    from repro_torch.core.placement import TIER_WARM
    from repro_torch.launch import serve as launcher
    world = max(SHARDED_WORLD, torch.cuda.device_count())
    spill_root = ROOT / "build" / "sharded_spill"
    runs = (("prefetch", ["--prefetch"]),
            ("adaptive", ["--prefetch", "--adaptive", "--adapt-interval",
                          str(COLD_ADAPT_INTERVAL)]))
    recorded = []
    try:
        for name, extra in runs:
            t0 = time.perf_counter()
            args = launcher.parse_args(
                ["--device", "cuda", "--requests", str(SERVE_REQUESTS),
                 "--sharded", "--mesh-world", str(world),
                 "--sharded-spill-dir", str(spill_root / name), *extra])
            stack = launcher.stack_from_args(args)
            with HopRecorder() as rec, HostTimer(sharded_targets()) as timer:
                summary = launcher.serve(args, stack=stack)
            calls = rec.calls
            host_ms = timer.report()
            sstats = summary["store"]["ShardedFeatureStore"]
            check(summary["requests"] == SERVE_REQUESTS,
                  f"sharded[{name}] answered {summary['requests']}")
            check(len(calls) > 0, f"sharded[{name}]: no sharded lookup")
            check(sstats["exchanges"] > 0 and sstats["exchanged_ids"] > 0,
                  f"sharded[{name}]: no exchange {sstats}")
            base = (baselines or {}).get("fused", {}).get("host_ms", {})
            log(f"sharded[{name}]: {world} shards; {summary['requests']} "
                f"requests, {summary['throughput_rps']:.2f} rps, p50 "
                f"{summary['p50_ms']:.3f} ms, p99 {summary['p99_ms']:.3f} "
                f"ms, routed {summary['routed']}, executors "
                f"{summary['executors']}; sharded store {sstats}; "
                f"{len(calls)} sharded lookups (calibration and warm-up "
                f"included); collect host ms {host_ms}; phase 4 (no "
                f"--sharded) {base} in {time.perf_counter() - t0:.1f} s")
            print(json.dumps({
                "sharded": name, "world": world,
                "requests": summary["requests"],
                "throughput_rps": summary["throughput_rps"],
                "p50_ms": summary["p50_ms"], "p99_ms": summary["p99_ms"],
                "routed": summary["routed"],
                "executors": summary["executors"],
                "sharded_store": sstats,
                "collect_ms": host_ms,
                "collect_ms_phase4": base}), flush=True)
            recorded.append((name, stack, calls))

        # 1. replay, both strategies, stage on and off, on the launcher's
        #    placement and on one with DISK rows (the single-host store's
        #    HBM budget split over the shards; per-shard spill files); the
        #    most-read rows, and the most-read WARM rows, made -0.0
        t0 = time.perf_counter()
        for name, stack, calls in recorded:
            fap = stack[3]
            n = stack[1].shape[0]
            order = most_read(calls)
            layouts = (("launcher", None), ("disk", max(n // 4 // world, 64)))
            for layout, rows_per_device in layouts:
                plan = placement_at(fap, world, rows_per_device)
                feats = stack[1].copy()
                feats[order[:256]] = -0.0
                feats[order[plan.tier[order] == TIER_WARM][:256]] = -0.0
                pristine = TieredFeatureStore.build(feats, plan,
                                                    device="cuda")
                for strategy in ("alltoall", "allgather"):
                    ss = sharded_store_at(
                        feats, plan, strategy,
                        spill_dir=spill_root / f"{name}-{layout}-{strategy}")
                    pf = Prefetcher(ss, budget=1024)
                    try:
                        off = replay_sharded(calls, ss, pristine)
                        pf.refresh(scores=fap)
                        on = replay_sharded(calls, ss, pristine)
                    finally:
                        pf.close()
                    st = ss.snapshot_stats()
                    log(f"sharded replay [{name}, {layout} placement "
                        f"{ss.tier_np.size - int((ss.tier_np >= 2).sum())} "
                        f"HBM rows, {strategy}]: {off['lookups']} + "
                        f"{on['lookups']} lookups bitwise (stage off, on); "
                        f"remote -0.0 elements {off['remote_negzero']} + "
                        f"{on['remote_negzero']}; counters {st}")
                    if strategy == "allgather":
                        check(off["remote_negzero"] > 0,
                              "allgather replay read no remote -0.0 row")
                        continue
                    occ = off["occurrences"] + on["occurrences"]
                    check(st["exchanges"] > 0 and st["exchanged_ids"] > 0,
                          f"replay [{layout}]: no exchange {st}")
                    check(st["exchanged_ids"] <= occ,
                          f"exchanged_ids {st['exchanged_ids']} > "
                          f"{occ} occurrences")
                    check(st["stage_hits"] > 0,
                          f"replay [{layout}]: no stage hit {st}")
                    if layout == "disk":
                        check(st["spill_reads"] > 0,
                              f"replay [disk]: no spill read {st}")
                    log(f"dedup [{name}, {layout}]: {st['exchanged_ids']} "
                        f"distinct (shard, id) pairs for {occ} occurrences "
                        f"exchanged ({st['exchanged_ids'] / occ:.3f})")
        log(f"sharded replays in {time.perf_counter() - t0:.1f} s")

        # 2. three executors under one engine
        name, stack, calls = recorded[0]
        routed = three_executor_check(stack, world, fanouts)
        log(f"three executors routed {routed}")

        # 3. lookup_hops time at 1, 2 and world shards, both strategies
        feats, fap = stack[1], stack[3]
        timings = {}
        for w in sorted({1, 2, world}):
            plan = placement_at(fap, w)
            for strategy in ("alltoall", "allgather"):
                ss = sharded_store_at(feats, plan, strategy)
                timings[f"{w}/{strategy}"] = t = time_lookups(
                    ss, calls[:40])
                log(f"lookup_hops at {w} shard(s), {strategy}: host p50 "
                    f"{t['host_ms_p50']:.3f} ms, CUDA events p50 "
                    f"{t['event_ms_p50']:.3f} ms, "
                    f"{t['device_ops_per_lookup']:.1f} device ops a lookup")
        print(json.dumps({"sharded_lookup_hops": timings,
                          "three_executors_routed": routed}), flush=True)
    finally:
        shutil.rmtree(spill_root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------
def capture_din_inputs(stack):
    """The exact ``embedding_bag`` calls ``din_forward`` makes for one
    ``serve_p99`` batch and for one ``retrieval_cand`` chunk: two each
    (the weighted interest sum, then the history mean)."""
    from repro_torch.configs.din import RETRIEVAL_CHUNK
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.launch import recsys_din
    original = bag_ops.embedding_bag
    calls = []

    def wrapped(*args, **kwargs):
        calls.append((args, kwargs))
        return original(*args, **kwargs)

    bag_ops.embedding_bag = wrapped
    try:
        batch = recsys_din.draw_batch(stack)
        recsys_din.score_batch(stack, batch)
        recsys_din.score_candidates(stack, batch, RETRIEVAL_CHUNK)
    finally:
        bag_ops.embedding_bag = original
    check(len(calls) == 4, f"din_forward made {len(calls)} embedding_bag "
          "calls for one batch and one chunk, not 2 + 2")
    return {"serve_p99": calls[:2], "retrieval_cand": calls[2:]}


def ring_edges_embedding_bag(table, ids, weights, same, gen) -> None:
    """``embedding_bag`` on the copy ring's edges, from one DIN call's
    table: bags of ``LONG_LIST`` ids (longer than the ring), the view
    ``table[1:]`` (one row in: 72 bytes in bf16), and bf16 rows of odd
    width (d 37: staged through registers). Each call twice, equal bits."""
    import torch
    from repro_torch.kernels import embedding_bag as eb
    bsz = ids.shape[0]
    rows = table.shape[0]
    dev = table.device
    long_ids = torch.randint(-1, rows, (bsz, LONG_LIST), generator=gen,
                             device=dev, dtype=torch.int32)
    long_w = torch.randn((bsz, LONG_LIST), generator=gen, device=dev)
    odd = torch.cat([table, table[:, :1]], 1).to(torch.bfloat16)
    cases = {"long bags": (table, long_ids, long_w.to(table.dtype)),
             "table[1:] bf16": (table.to(torch.bfloat16)[1:], ids,
                                weights.to(torch.bfloat16)),
             "bf16 d 37": (odd, ids, weights.to(torch.bfloat16))}
    for name, (t, i, w) in cases.items():
        for mode in ("sum", "mean"):
            for wt in (None, w):
                first = eb.embedding_bag(t, i, wt, mode=mode)
                again = eb.embedding_bag(t, i, wt, mode=mode)
                same(first, eb.embedding_bag_ref(t, i, wt, mode=mode),
                     f"{name} {mode} weighted={wt is not None} {t.dtype}")
                same(again, first, f"{name} {mode} repeated")


def bag_call_row(shape: str, table, ids, weights, mode: str, *,
                 big: bool) -> dict:
    """One ``embedding_bag`` call's timing row: the kernel, its plain
    version and ``F.embedding_bag`` (on the valid ids, compacted, with
    offsets) on the same inputs, CUDA events; the bound from the bytes
    (each valid slot's row read once, ids and weights once, the output
    written once) and the FMAs of the valid slots. ``big`` cuts the plain
    version's repeats. Logs the row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import embedding_bag as eb
    bsz, bag = ids.shape
    d, elem = table.shape[1], table.element_size()
    valid = ids >= 0
    n_valid = int(valid.sum())
    flat = ids[valid].long()
    offsets = torch.zeros(bsz, dtype=torch.long, device=ids.device)
    offsets[1:] = valid.sum(1).cumsum(0)[:-1]
    psw = weights[valid] if weights is not None else None

    def library():
        return F.embedding_bag(flat, table, offsets, mode=mode,
                               per_sample_weights=psw)

    def kernel():
        return eb.embedding_bag_cuda(table, ids, weights, mode=mode)

    log(f"F.embedding_bag yardstick ({shape} {mode}) max |diff| vs "
        f"kernel: {float((library() - kernel()).abs().max()):.3g}")
    nbytes = (n_valid * d * elem
              + bsz * bag * (4 + (elem if weights is not None else 0))
              + bsz * d * elem)
    flops = n_valid * d * (2 if weights is not None else 1)
    r = {"shape": shape, "call": ("interest (sum, weighted)"
                                  if weights is not None
                                  else "hist_mean (mean)"),
         "ids": [bsz, bag], "d": d, "valid": n_valid,
         "ms": time_ms(kernel),
         "plain_ms": time_ms(lambda: eb.embedding_bag_ref(
             table, ids, weights, mode=mode),
             **(dict(inner=3, reps=5) if big else {})),
         "library_ms": time_ms(library),
         "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3,
         "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                      >= flops / FP32_FLOPS else "operations"),
         "bytes": nbytes,
         "call_ms": time_ms(kernel, graph=False)}
    log(f"embedding_bag {shape} {r['call']}: kernel {r['ms']:.5f} ms, plain "
        f"{r['plain_ms']:.5f} ms, library {r['library_ms']:.5f} ms, bound "
        f"{r['bound_ms']:.5f} ms ({nbytes} bytes, {r['bound_by']}); eager "
        f"wrapper call {r['call_ms']:.5f} ms")
    return r


def embedding_bag_phase(stack) -> dict:
    """Bitwise checks and timings of ``embedding_bag`` at the inputs the
    DIN path hands it; prints one timing row per captured call. Returns
    the ``kernels`` entry (the serve_p99 interest call)."""
    import torch
    from repro_torch.kernels import embedding_bag as eb

    cap = capture_din_inputs(stack)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    err = 0.0

    def same(got, want, what):
        nonlocal err
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"embedding_bag != plain ({what})")
        err = max(err, float((got.float() - want.float()).abs().max()))

    for shape, calls in cap.items():
        for (table, ids, weights), kw in calls:
            log(f"embedding_bag {shape} inputs: table={tuple(table.shape)} "
                f"ids={tuple(ids.shape)} weighted={weights is not None} "
                f"mode={kw['mode']} valid={int((ids >= 0).sum())}")
        (table, ids, scores), _ = calls[0]
        rows, (bsz, bag) = table.shape[0], ids.shape
        cases = {
            "din": ids,
            # padding on purpose: a random half of the slots and whole bags
            "padded": torch.where(
                torch.rand(ids.shape, generator=gen, device=dev) < 0.5, ids,
                -1),
            "all-padding": torch.full_like(ids, -1),
            "past-the-table": torch.randint(
                -2, rows + 50, ids.shape, generator=gen, device=dev,
                dtype=torch.int32)}
        cases["padded"][::7] = -1
        for dtype in (torch.float32, torch.bfloat16):
            t, w = table.to(dtype), scores.to(dtype)
            for name, case_ids in cases.items():
                for mode in ("sum", "mean"):
                    for weights in (None, w):
                        got = eb.embedding_bag(t, case_ids, weights,
                                               mode=mode)
                        want = eb.embedding_bag_ref(t, case_ids, weights,
                                                    mode=mode)
                        same(got, want, f"{shape} {name} {mode} "
                             f"weighted={weights is not None} {dtype}")
                        if name == "all-padding":
                            check(not got.any(),
                                  "embedding_bag all-padding not zero")
            if shape == "serve_p99" and dtype == torch.float32:
                ring_edges_embedding_bag(t, ids, w, same, gen)
            before = eb.LAUNCHES.value
            for b, n_bag, d in ((0, bag, t.shape[1]), (bsz, 0, t.shape[1]),
                                (bsz, bag, 0)):
                out = eb.embedding_bag(
                    t[:, :d].contiguous(),
                    torch.zeros((b, n_bag), dtype=torch.int32, device=dev),
                    mode="mean")
                check(out.shape == (b, d) and not out.any(),
                      f"embedding_bag empty grid {(b, n_bag, d)} wrong")
            check(eb.LAUNCHES.value == before,
                  "embedding_bag empty grid launched")
    log("embedding_bag == plain bitwise (fp32, bf16; sum, mean; weighted "
        "and not; din inputs at serve_p99 and retrieval_cand, padded, "
        "all-padding, ids past the table, empty grids; bags of "
        f"{LONG_LIST} (longer than the ring), the table[1:] view in bf16, "
        "bf16 d 37; each repeated with equal bits)")
    check_no_spills("embedding_bag")

    rows_out = [bag_call_row(shape, table, ids, weights, kw["mode"],
                             big=shape == "retrieval_cand")
                for shape, calls in cap.items()
                for (table, ids, weights), kw in calls]
    print(json.dumps({"embedding_bag_calls": rows_out}), flush=True)
    head = rows_out[0]  # serve_p99, the weighted interest sum
    entry = {"name": "embedding_bag", "route": "cuda",
             "source": "src/repro_torch/csrc/embedding_bag.cu",
             "replaces": "src/repro/kernels/embedding_bag/kernel.py:50",
             "max_abs_err": err,
             **{k: head[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}}
    return entry


def din_phase(stack, entry: dict) -> None:
    """Serve DIN batches through the store and score 1M candidates, with
    the ``embedding_bag`` counter zeroed before each and read after; hold
    the outputs against the direct-table path and the CPU port."""
    import torch
    from repro_torch.configs.din import RETRIEVAL_CHUNK
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.launch import recsys_din
    from repro_torch.models.din import (din_forward, din_init,
                                        din_score_candidates)

    eb.LAUNCHES.reset()
    t0 = time.perf_counter()
    report, served, logits = recsys_din.serve(stack, DIN_BATCHES)
    wall = time.perf_counter() - t0
    serve_launches = eb.LAUNCHES.value
    log(f"din serve: {DIN_BATCHES} batches of {stack.batch}, per-batch ms "
        f"{[round(x, 3) for x in report['batch_ms']]}, p50 "
        f"{report['p50_ms']:.3f} ms, tier mix {report['tier_mix']} "
        f"(placement {report['placement']}), embedding_bag launches "
        f"{serve_launches}, store {report['store']}, wall {wall:.1f} s")
    check(serve_launches == 2 * DIN_BATCHES,
          f"din serve launched embedding_bag {serve_launches} times for "
          f"{DIN_BATCHES} batches, not 2 each")
    print(json.dumps({"din_serve": {k: report[k] for k in (
        "items", "batch", "batches", "batch_ms", "p50_ms", "tier_counts",
        "tier_mix", "placement", "store")}, "launches": serve_launches}),
        flush=True)

    cfg, model = stack.cfg, stack.model
    keys = ("target_item", "target_cate", "hist_items", "hist_cates",
            "dense_feat")
    for i, (batch, out) in enumerate(zip(served, logits)):
        check(out.shape == (stack.batch,) and bool(torch.isfinite(out).all()),
              f"din batch {i}: logits {tuple(out.shape)} not finite")
        direct = din_forward(model, cfg, *(batch[k] for k in keys))
        torch.cuda.synchronize()
        check(torch.equal(direct, out),
              f"din batch {i}: store path != direct-table path")
    log(f"din store path == direct-table path bitwise on {DIN_BATCHES} "
        "batches")

    cpu_model = din_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    first = {k: v.cpu() for k, v in served[0].items()}
    cpu_logits = din_forward(cpu_model, cfg, *(first[k] for k in keys))
    worst = float((logits[0].cpu() - cpu_logits).abs().max())
    check(worst <= CPU_TOL, f"din card vs CPU max |diff| {worst:.3g} > "
          f"{CPU_TOL}")
    log(f"din card logits within {CPU_TOL} of the CPU port (max |diff| "
        f"{worst:.3g})")

    eb.LAUNCHES.reset()
    ret = recsys_din.score_candidates(stack, served[0], DIN_CANDIDATES)
    ret_launches = eb.LAUNCHES.value
    chunks = -(-DIN_CANDIDATES // RETRIEVAL_CHUNK)
    log(f"din retrieval: {DIN_CANDIDATES} candidates in {chunks} chunks of "
        f"{RETRIEVAL_CHUNK}: {ret.ms:.3f} ms, embedding_bag launches "
        f"{ret_launches}")
    check(ret_launches == 2 * chunks, f"retrieval launched embedding_bag "
          f"{ret_launches} times, not 2 per chunk ({2 * chunks})")
    check(ret.scores.shape == (DIN_CANDIDATES,)
          and bool(torch.isfinite(ret.scores).all()),
          f"retrieval scores {tuple(ret.scores.shape)} not all finite")
    k = DIN_CPU_CANDIDATES
    cpu_scores = din_score_candidates(
        cpu_model, cfg, first["hist_items"][0], first["hist_cates"][0],
        first["dense_feat"][0], ret.items[:k].cpu(), ret.cates[:k].cpu(),
        chunk=k)
    worst = float((ret.scores[:k].cpu() - cpu_scores).abs().max())
    check(worst <= CPU_TOL, f"retrieval card vs CPU max |diff| {worst:.3g}")
    log(f"din retrieval: first {k} scores within {CPU_TOL} of the CPU port "
        f"(max |diff| {worst:.3g}); score mean "
        f"{float(ret.scores.mean()):.5f} std {float(ret.scores.std()):.5f}")
    print(json.dumps({"din_retrieval": {
        "candidates": DIN_CANDIDATES, "chunk": RETRIEVAL_CHUNK, "ms": ret.ms,
        "launches": ret_launches, "cpu_max_abs_diff": worst}}), flush=True)
    entry["launches"] = serve_launches + ret_launches
    entry["launches_by_path"] = {"din_serve": serve_launches,
                                 "din_retrieval": ret_launches}


def din_train_phase(entry: dict) -> None:
    """DIN ``train_batch`` at full size through ``repro_torch.launch.
    recsys_din --config din --train-steps DIN_TRAIN_STEPS`` (B 65,536,
    history 100, the 10M-row item table as a plain parameter), with the
    ``embedding_bag`` counter zeroed just before and read just after
    (exactly 2 launches a step: the two bags' forwards; their backward is
    torch ops). The last step's two calls are recorded and the kernel held
    bitwise to its plain version on them, then timed beside plain,
    ``F.embedding_bag`` and its bound; then card vs CPU gradients at the
    example config."""
    import math

    import numpy as np
    import torch
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.launch import recsys_din
    from repro_torch.models.din import din_init, din_loss

    calls, seen = [], [0]
    original = bag_ops.embedding_bag

    def recorder(table, ids, weights=None, *, mode="sum"):
        # the last step's two calls (earlier steps' inputs are not kept)
        seen[0] += 1
        if seen[0] > 2 * (DIN_TRAIN_STEPS - 1):
            calls.append((table.detach(), ids, None if weights is None
                          else weights.detach(), mode))
        return original(table, ids, weights, mode=mode)

    bag_ops.embedding_bag = recorder
    eb.LAUNCHES.reset()
    try:
        report = recsys_din.train("din", DIN_TRAIN_STEPS, device="cuda")
    finally:
        bag_ops.embedding_bag = original
    launches = eb.LAUNCHES.value
    stages = report["stage_ms"]
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"din train_batch: {report['steps']} steps at B {report['batch']}, "
        f"history {report['hist_len']}, {report['items']} items "
        f"({report['params']:,} params): losses {report['losses']}, step "
        f"ms {[round(x, 2) for x in report['step_ms']]}, stages "
        f"{[{k: round(v, 2) for k, v in st.items()} for st in stages]}"
        f", peak {report['peak_bytes'] / 2**30:.2f} GiB, embedding_bag "
        f"launches {launches}")
    check(launches == 2 * DIN_TRAIN_STEPS, f"din training launched "
          f"embedding_bag {launches} times for {DIN_TRAIN_STEPS} steps, not 2 "
          "each")
    check(report["batch"] == 65536 and report["items"] == 10_000_000
          and len(report["losses"]) == DIN_TRAIN_STEPS
          and all(math.isfinite(x) for x in report["losses"])
          and abs(report["losses"][0] - math.log(2)) < 0.1,
          f"din training: batch {report['batch']}, losses "
          f"{report['losses']} (step 0 should be near ln 2)")
    check(report["peak_bytes"] < total, f"din training peak "
          f"{report['peak_bytes']} B over the card's {total} B")
    print(json.dumps({"din_train": report, "launches": launches}),
          flush=True)
    entry["launches_by_path"]["din_train_batch"] = launches
    entry["launches"] += launches

    check(len(calls) == 2, f"din's last train step made {len(calls)} "
          "embedding_bag calls, not 2")
    for table, ids, weights, mode in calls:
        log(f"embedding_bag train_batch inputs: table={tuple(table.shape)} "
            f"{table.dtype} ids={tuple(ids.shape)} weighted="
            f"{weights is not None} mode={mode} valid={int((ids >= 0).sum())}")
        got = eb.embedding_bag(table, ids, weights, mode=mode)
        want = eb.embedding_bag_ref(table, ids, weights, mode=mode)
        torch.cuda.synchronize()
        check(torch.equal(got, want), "embedding_bag != plain at din "
              f"train_batch's {mode} call")
        del got, want
    log("embedding_bag == plain bitwise at both of din train_batch's calls")
    rows = [bag_call_row("train_batch", *call, big=True) for call in calls]
    del calls
    print(json.dumps({"embedding_bag_train_calls": rows}), flush=True)

    cfg = recsys_din.EXAMPLE
    pop = recsys_din.popularity(cfg, np.random.default_rng(0))

    def run(dev, dtype):
        model = din_init(torch.Generator().manual_seed(0), cfg,
                         device=dev).to(dtype)
        batch = recsys_din.draw_requests(
            cfg, DIN_CPU_TRAIN_BATCH, np.random.default_rng(1),
            pop / pop.sum(), torch.device(dev), labels=True)
        batch["dense_feat"] = batch["dense_feat"].to(dtype)
        return din_loss(model, cfg, batch), model

    hold_card_vs_cpu("din", run, f"the example config ({cfg.n_items} "
                     f"items, history {cfg.hist_len}), B "
                     f"{DIN_CPU_TRAIN_BATCH}")


# ---------------------------------------------------------------------------
# phase 6
# ---------------------------------------------------------------------------
def capture_train_inputs() -> dict:
    """The ``segment_spmm`` calls of one GIN-TU forward and backward at
    ``TRAIN_SHAPE`` (the launcher's model and its step-0 batch): layer 1's
    forward (d 100), layer 2's (d 64) and the first backward call (the
    transposed table, d 64)."""
    import torch
    from repro_torch.configs import gin_tu
    from repro_torch.configs.gnn_common import make_concrete_batch
    from repro_torch.kernels.segment_spmm import ops as sp_ops
    info = dict(TRAIN_SHAPE, graphs=None)
    model = gin_tu._init(torch.Generator().manual_seed(0), info["d_feat"],
                         info["classes"], "custom", device="cuda")
    t0 = time.perf_counter()
    batch = make_concrete_batch(info, seed=0, device="cuda")
    log(f"train batch at {TRAIN_SHAPE} drawn and copied in "
        f"{time.perf_counter() - t0:.1f} s")
    original = sp_ops.segment_spmm
    calls = []

    def wrapped(ids, feat, weights=None):
        calls.append((ids, feat.detach(), weights))
        return original(ids, feat, weights)

    sp_ops.segment_spmm = wrapped
    try:
        loss = gin_tu._loss(model, batch, info, "custom")
        loss.backward()
    finally:
        sp_ops.segment_spmm = original
    torch.cuda.synchronize()
    check(len(calls) == SPMM_PER_STEP, f"one GIN step made {len(calls)} "
          f"segment_spmm calls, not {SPMM_PER_STEP}")
    return {"layer1_fwd": calls[0], "layer2_fwd": calls[1],
            "backward": calls[5]}


def ring_edges_segment_spmm(ids, feat, same, gen) -> None:
    """``segment_spmm`` on the copy ring's edges, from layer 1's inputs:
    ``LONG_LISTS`` lists of ``LONG_LIST`` ids (longer than any ring, -1
    anywhere), the view ``feat[1:]`` in bf16 (200 bytes in), and bf16 rows
    of odd width (d 37: staged through registers). Each call twice, equal
    bits."""
    import torch
    from repro_torch.kernels import segment_spmm as sp
    dev = feat.device
    m = feat.shape[0]
    long_ids = torch.randint(-1, m, (LONG_LISTS, LONG_LIST), generator=gen,
                             device=dev, dtype=torch.int32)
    long_w = torch.randn((LONG_LISTS, LONG_LIST), generator=gen, device=dev)
    w32 = torch.randn(ids.shape, generator=gen, device=dev)
    half = feat.to(torch.bfloat16)
    cases = {"long lists": (long_ids, feat, long_w),
             "feat[1:] bf16": (ids, half[1:], w32.to(torch.bfloat16)),
             "bf16 d 37": (ids, half[:, :37].contiguous(),
                           w32.to(torch.bfloat16))}
    for name, (i, f, w) in cases.items():
        for wt in (None, w):
            first = sp.segment_spmm(i, f, wt)
            again = sp.segment_spmm(i, f, wt)
            same(first, sp.segment_spmm_plain(i, f, wt),
                 f"{name} weighted={wt is not None} {f.dtype}")
            same(again, first, f"{name} repeated")
            del first, again


def spmm_call_row(name: str, ids, feat) -> dict:
    """One unweighted ``segment_spmm`` call's timing row: the kernel, its
    plain version and ``torch.sparse.mm`` (the same ids as a CSR matrix
    of ones) on the same inputs, CUDA events; the bound from the bytes
    (the id table, each distinct row read once, the output written once)
    and one add for each valid id's row. Logs the row."""
    import torch
    from repro_torch.kernels import segment_spmm as sp
    n, dmax = ids.shape
    m, d = feat.shape
    elem = feat.element_size()
    valid = ids >= 0
    nnz = int(valid.sum())
    rows_read = int((torch.bincount(ids[valid].long(), minlength=m) > 0)
                    .sum())
    crow = torch.zeros(n + 1, dtype=torch.int64, device=ids.device)
    crow[1:] = valid.sum(1).cumsum(0)
    adj = torch.sparse_csr_tensor(
        crow, ids[valid].long(), torch.ones(nnz, device=ids.device),
        size=(n, m), check_invariants=False)
    kern = sp.segment_spmm_cuda(ids, feat)
    lib = torch.sparse.mm(adj, feat)
    log(f"torch.sparse.mm yardstick ({name}) max |diff| vs kernel: "
        f"{float((lib - kern).abs().max()):.3g} (its sums in another "
        f"order; max |kernel| {float(kern.abs().max()):.4g})")
    del kern, lib
    nbytes = n * dmax * 4 + rows_read * d * elem + n * d * elem
    flops = nnz * d
    r = {"call": name, "ids": [n, dmax], "feat": [m, d], "nnz": nnz,
         "rows_read": rows_read, "gathered_bytes": nnz * d * elem,
         "ms": time_ms(lambda: sp.segment_spmm_cuda(ids, feat), inner=5,
                       reps=10),
         "plain_ms": time_ms(lambda: sp.segment_spmm_plain(ids, feat),
                             inner=1, reps=3, graph=False),
         "library_ms": time_ms(lambda: torch.sparse.mm(adj, feat), inner=3,
                               reps=5, graph=False),
         "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3,
         "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                      >= flops / FP32_FLOPS else "operations"),
         "bytes": nbytes}
    r["gathered_hbm_share"] = (r["gathered_bytes"] / (r["ms"] * 1e-3)
                               / HBM_BYTES_PER_S)
    log(f"segment_spmm {name} {r['ids']} x {r['feat']}: kernel "
        f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, torch.sparse.mm "
        f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({nbytes} "
        f"bytes, {r['bound_by']}); gathered {r['gathered_bytes']} bytes, "
        f"{r['gathered_bytes'] / (r['ms'] * 1e-3) / 1e12:.3f} TB/s = "
        f"{r['gathered_hbm_share']:.4f} of HBM's 3.35 TB/s")
    return r


def segment_spmm_phase() -> dict:
    """Bitwise checks and timings of ``segment_spmm`` at the inputs the
    training path hands it; prints one timing row per captured call.
    Returns the ``kernels`` entry (the layer-2 forward, d 64, the width of
    8 of a step's 9 launches)."""
    import torch
    from repro_torch.kernels import segment_spmm as sp

    cap = capture_train_inputs()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    err = 0.0

    def same(got, want, what):
        nonlocal err
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"segment_spmm != plain ({what})")
        err = max(err, float((got.float() - want.float()).abs().max()))

    for name, (ids, feat, weights) in cap.items():
        check(weights is None, f"{name}: the training path is unweighted")
        n, dmax = ids.shape
        log(f"segment_spmm {name} inputs: ids={tuple(ids.shape)} "
            f"feat={tuple(feat.shape)} dtype={feat.dtype} "
            f"valid={int((ids >= 0).sum())}")
        mid = torch.where(torch.rand(ids.shape, generator=gen, device=dev)
                          < 0.5, ids, -1)
        invalid_rows = ids.clone()
        invalid_rows[::5] = -1
        cases = {"path": ids, "mid-row -1": mid,
                 "all-invalid rows": invalid_rows}
        w32 = torch.randn(ids.shape, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            f = feat.to(dtype)
            for case, case_ids in cases.items():
                for w in (None, w32.to(dtype)):
                    got = sp.segment_spmm(case_ids, f, w)
                    same(got, sp.segment_spmm_plain(case_ids, f, w),
                         f"{name} {case} weighted={w is not None} {dtype}")
                    if case == "all-invalid rows":
                        check(not got[::5].any(),
                              "segment_spmm all-invalid rows not zero")
            del f
        before = sp.LAUNCHES.value
        for shape, d in (((0, dmax), feat.shape[1]), ((n, 0), feat.shape[1]),
                         ((n, dmax), 0)):
            out = sp.segment_spmm(
                torch.zeros(shape, dtype=torch.int32, device=dev),
                feat[:, :d].contiguous())
            check(out.shape == (shape[0], d) and not out.any(),
                  f"segment_spmm empty grid {shape}, d {d} wrong")
        check(sp.LAUNCHES.value == before, "segment_spmm empty grid launched")
    ids_t, grad = cap["backward"][:2]
    a = sp.segment_spmm_cuda(ids_t, grad)
    b = sp.segment_spmm_cuda(ids_t, grad)
    torch.cuda.synchronize()
    check(torch.equal(a, b), "repeated backward call differs")
    del a, b
    ring_edges_segment_spmm(*cap["layer1_fwd"][:2], same, gen)
    log("segment_spmm == plain bitwise (fp32, bf16; weighted and not; "
        "layer 1, layer 2 and backward inputs at ogb_products, -1 in "
        "mid-row, all-invalid rows, empty grids; lists of "
        f"{LONG_LIST} (longer than the ring), the feat[1:] view in bf16, "
        "bf16 d 37, each repeated with equal bits); repeated backward call "
        "bitwise equal")
    check_no_spills("segment_spmm")

    rows_out = [spmm_call_row(name, ids, feat)
                for name, (ids, feat, _) in cap.items()]
    print(json.dumps({"segment_spmm_calls": rows_out}), flush=True)
    head = rows_out[1]  # layer 2's forward, d 64
    return {"name": "segment_spmm", "route": "cuda",
            "source": "src/repro_torch/csrc/segment_spmm.cu",
            "replaces": "src/repro/kernels/segment_spmm/kernel.py:55",
            "max_abs_err": err,
            **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")}}


def train_phase(entry: dict) -> dict:
    """The training launcher at ``TRAIN_SHAPE`` with the ``segment_spmm``
    counter zeroed before and read after; then card vs CPU at the
    launcher's default size. Returns the launcher's report."""
    import math

    import torch
    from repro_torch.configs import gin_tu
    from repro_torch.kernels import segment_spmm as sp
    from repro_torch.launch import train as train_launcher

    torch.cuda.reset_peak_memory_stats()
    sp.LAUNCHES.reset()
    report = train_launcher.main([
        "--device", "cuda", "--steps", str(TRAIN_STEPS),
        *(f"--{k.replace('_', '-')}={v}" for k, v in TRAIN_SHAPE.items())])
    launches = sp.LAUNCHES.value
    peak = report["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"train at {TRAIN_SHAPE}: {TRAIN_STEPS} steps in "
        f"{report['wall_s']:.1f} s, losses {report['losses']}, "
        f"segment_spmm launches {launches}, peak device memory "
        f"{peak / 2**30:.2f} GiB")
    check(launches == SPMM_PER_STEP * TRAIN_STEPS,
          f"training launched segment_spmm {launches} times for "
          f"{TRAIN_STEPS} steps, not {SPMM_PER_STEP} each")
    check(report["step"] == TRAIN_STEPS
          and len(report["losses"]) == TRAIN_STEPS
          and all(math.isfinite(x) for x in report["losses"]),
          f"training losses {report['losses']} not {TRAIN_STEPS} finite")
    print(json.dumps({"train": {"shape": TRAIN_SHAPE, "steps": TRAIN_STEPS,
                                "losses": report["losses"],
                                "wall_s": report["wall_s"],
                                "params": report["params"],
                                "peak_bytes": peak},
                      "launches": launches}), flush=True)
    entry["launches"] = launches
    entry["launches_by_path"] = {"gin_tu_train": launches}

    defaults = train_launcher.parse_args([])
    info = dict(nodes=defaults.nodes, edges=defaults.edges,
                d_feat=defaults.d_feat, classes=defaults.classes, graphs=None)
    card_vs_cpu("gin-tu", gin_tu, info, tol_of=lambda k: (
        EPS_GRAD_TOL if k.endswith(".eps") else GRAD_TOL))
    return report


def card_vs_cpu(name: str, mod, info: dict, *, tol_of=lambda k: GRAD_TOL,
                size_of=lambda k: k) -> dict:
    """``mod._init`` (seed 0) and ``mod._loss`` on ``make_concrete_batch(
    info, seed=0)`` through :func:`hold_card_vs_cpu`."""
    import torch
    from repro_torch.configs.gnn_common import make_concrete_batch

    def run(dev, dtype):
        model = mod._init(torch.Generator().manual_seed(0), info["d_feat"],
                          info["classes"], "custom", device=dev).to(dtype)
        batch = {k: v.to(dtype) if v.is_floating_point() else v
                 for k, v in make_concrete_batch(info, seed=0,
                                                 device=dev).items()}
        return mod._loss(model, batch, info, "custom"), model

    return hold_card_vs_cpu(name, run, info, tol_of=tol_of, size_of=size_of)


def hold_card_vs_cpu(name: str, run, what, *, tol_of=lambda k: GRAD_TOL,
                     size_of=lambda k: k) -> dict:
    """``run(device, dtype) -> (loss, model)`` on the card in fp32, on the
    CPU in fp32 and in fp64: the card's loss against the CPU port's within
    ``CPU_TOL``, and every parameter's gradient on the card and on the CPU
    (fp32) against an fp64 witness (the CPU port in fp64; a loss head that
    casts to fp32 does so in every run, as the reference does): max |diff|
    over the largest fp64 gradient entry of parameter ``size_of(name)``
    (its own unless said otherwise) within ``tol_of(name)``, where that is
    0 exactly 0; and all parameters' gradients together within
    ``GRAD_TOL`` of the witness's norm. ``what`` names the inputs in the
    log."""
    import math

    import torch
    out = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                       ("cpu", torch.float64)):
        loss, model = run(dev, dtype)
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, list(params.values()))
        out[dev if dtype == torch.float32 else "fp64"] = (
            float(loss.detach()),
            {k: g.cpu().double() for k, g in zip(params, grads)})
        del model, params, loss, grads
    loss_diff = abs(out["cuda"][0] - out["cpu"][0])
    check(loss_diff <= CPU_TOL, f"{name} card vs CPU loss |diff| "
          f"{loss_diff:.3g} > {CPU_TOL}")
    witness = out["fp64"][1]
    worst, norm_rel = {}, {}
    for side in ("cuda", "cpu"):
        norm_rel[side] = float(
            torch.sqrt(sum(((out[side][1][k] - g) ** 2).sum()
                           for k, g in witness.items()))
            / torch.sqrt(sum((g ** 2).sum() for g in witness.values())))
        check(norm_rel[side] <= GRAD_TOL, f"{name} {side} gradient off its "
              f"fp64 witness by {norm_rel[side]:.3g} in norm > {GRAD_TOL}")
        for k, g64 in witness.items():
            g = out[side][1][k]
            check(bool(torch.isfinite(g).all()), f"non-finite {side} "
                  f"{name} gradient {k}")
            diff = float((g - g64).abs().max())
            size = float(witness[size_of(k)].abs().max())
            # a gradient that is zero by construction (EquiformerV2's first
            # layer sees no l > 0 input; its last layer's l > 0 outputs
            # reach no output) must be zero on every side
            rel = diff / size if size else (0.0 if diff == 0 else math.inf)
            check(rel <= tol_of(k), f"{name} {side} gradient of {k} off "
                  f"its fp64 witness by {rel:.3g} of the size of "
                  f"{size_of(k)}'s > {tol_of(k)}")
            if rel >= worst.get(side, (0.0, ""))[0]:
                worst[side] = (rel, k)
    log(f"{name} card vs CPU at {what}: card loss {out['cuda'][0]:.7f} vs "
        f"CPU {out['cpu'][0]:.7f} (|diff| {loss_diff:.3g}, limit {CPU_TOL}); "
        f"gradients against the fp64 witness (worst over the parameter's "
        f"size): " + "; ".join(f"{side} {rel:.3g} ({k}, limit {tol_of(k)})"
                               for side, (rel, k) in sorted(worst.items()))
        + "; in norm: " + ", ".join(f"{side} {v:.3g}" for side, v in
                                    sorted(norm_rel.items()))
        + f" (limit {GRAD_TOL})")
    return {"loss_card": out["cuda"][0], "loss_cpu": out["cpu"][0],
            "loss_diff": loss_diff,
            "grad_worst": {side: {"rel": rel, "param": k}
                           for side, (rel, k) in worst.items()},
            "grad_norm_rel": norm_rel}


# ---------------------------------------------------------------------------
# phase 6b
# ---------------------------------------------------------------------------
def kernel_launches() -> dict:
    """The five kernels' launch counters."""
    from repro_torch.kernels import (embedding_bag, flash_attention,
                                     gather_aggregate, segment_spmm,
                                     tiered_gather)
    return {m.__name__.rsplit(".", 1)[1]: m.LAUNCHES
            for m in (tiered_gather, gather_aggregate, embedding_bag,
                      segment_spmm, flash_attention)}


def train_full_equiformer(info: dict, shape: str, cell=None) -> dict:
    """``equiformer_v2._init`` (published widths), ``_loss`` (or the halo
    ``cell``'s sharded loss on its sharded batches) and ``run_training``
    for ``GEO_STEPS`` steps on the card: losses, step ms (each step's
    batch draw to the next one's, after a synchronize) and peak
    memory."""
    import math

    import torch
    from repro_torch.configs import equiformer_v2
    from repro_torch.configs.gnn_common import make_concrete_batch
    from repro_torch.models.common import count_params
    from repro_torch.training import AdamW, run_training

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n_out = info["classes"] if info["classes"] is not None else 1
    model = equiformer_v2._init(torch.Generator().manual_seed(0),
                                info["d_feat"], n_out, shape, device="cuda")
    starts, losses = [], []

    def batch_fn(step):
        torch.cuda.synchronize()
        starts.append(time.perf_counter())
        if cell is not None:
            return cell.shard(make_concrete_batch(info, seed=step,
                                                  device="cpu"))
        return make_concrete_batch(info, seed=step, device="cuda")

    def loss_fn(m, batch):
        loss = (cell.loss(m, batch) if cell is not None
                else equiformer_v2._loss(m, batch, info, shape))
        losses.append(loss.detach())
        return loss

    run_training(loss_fn=loss_fn, model=model,
                 opt=AdamW(lr=1e-3, weight_decay=0.0), batch_fn=batch_fn,
                 steps=GEO_STEPS, log_every=1000)
    torch.cuda.synchronize()
    starts.append(time.perf_counter())
    losses = [float(x) for x in losses]
    check(len(losses) == GEO_STEPS and all(math.isfinite(x) for x in losses),
          f"equiformer-v2 at full width, {shape}: losses {losses} not "
          f"{GEO_STEPS} finite")
    out = {"shape": shape, "nodes": info["nodes"], "edges": info["edges"],
           "params": count_params(model), "losses": losses,
           "step_ms": [(b - a) * 1e3 for a, b in zip(starts, starts[1:])],
           "peak_bytes": torch.cuda.max_memory_allocated()}
    log(f"equiformer-v2 full width ({out['params']:,} params) at {shape} "
        f"({info['nodes']} nodes, {info['edges']} edges"
        f"{'' if cell is None else ', halo-sharded'}): losses {losses}, "
        f"step ms {[round(x, 1) for x in out['step_ms']]}, peak "
        f"{out['peak_bytes'] / 2**30:.2f} GiB")
    return out


def equiformer_symmetry() -> dict:
    """Full-width EquiformerV2 on the card at ``GEO_CPU_GRAPH`` (self-loops
    made padding: a zero edge vector has no direction to rotate): node
    logits under a rotation of the positions, and with 8 edge chunks."""
    import numpy as np
    import torch
    from repro_torch.configs import equiformer_v2
    from repro_torch.configs.gnn_common import make_concrete_batch
    from repro_torch.models.equiformer_v2 import equiformer_forward
    from repro_torch.models.so3 import rotation_matrix_zyz

    info = dict(GEO_CPU_GRAPH, graphs=None)
    model = equiformer_v2._init(torch.Generator().manual_seed(0),
                                info["d_feat"], info["classes"], "custom",
                                device="cuda")
    b = make_concrete_batch(info, seed=0, device="cuda")
    src = torch.where(b["src"] == b["dst"], -1, b["src"])
    rot = torch.as_tensor(rotation_matrix_zyz(*EQ_ROTATION).astype(
        np.float32), device="cuda")
    kw = dict(num_nodes=info["nodes"], node_feat=b["node_feat"])
    with torch.no_grad():
        base = equiformer_forward(model, b["species"], b["positions"], src,
                                  b["dst"], **kw)
        turned = equiformer_forward(model, b["species"],
                                    b["positions"] @ rot.T, src, b["dst"],
                                    **kw)
        chunked = equiformer_forward(model, b["species"], b["positions"],
                                     src, b["dst"], edge_chunks=8, **kw)
    out = {"logit_max_abs": float(base.abs().max()),
           "equivariance_max_abs": float((turned - base).abs().max()),
           "chunking_max_abs": float((chunked - base).abs().max())}
    check(bool(torch.isfinite(base).all()), "equiformer-v2 logits not finite")
    check(out["equivariance_max_abs"] <= EQ_EQUIV_TOL,
          f"equiformer-v2 logits move by {out['equivariance_max_abs']:.3g} "
          f"under a rotation > {EQ_EQUIV_TOL}")
    check(out["chunking_max_abs"] <= EQ_CHUNK_TOL,
          f"equiformer-v2 8 edge chunks vs 1: {out['chunking_max_abs']:.3g} "
          f"> {EQ_CHUNK_TOL}")
    log(f"equiformer-v2 full width on the card: logits (max |x| "
        f"{out['logit_max_abs']:.3g}) move by "
        f"{out['equivariance_max_abs']:.3g} under rotation_matrix_zyz"
        f"{EQ_ROTATION} (limit {EQ_EQUIV_TOL}); 8 edge chunks vs 1: "
        f"{out['chunking_max_abs']:.3g} (limit {EQ_CHUNK_TOL})")
    return out


def geometric_phase() -> None:
    """SchNet, MeshGraphNet and EquiformerV2 training on the card: each
    through the training launcher at its defaults (no kernel of the repo
    may launch: the counters are zeroed before and read after); full-width
    EquiformerV2 at the launcher's graph and the ``molecule`` shape; the
    MeshGraphNet example at ``--params-scale full``; card vs CPU for each
    at full width on ``GEO_CPU_GRAPH``; EquiformerV2's equivariance and
    edge chunking at l_max 6."""
    import math
    import shutil

    import torch
    from repro_torch.configs import equiformer_v2, meshgraphnet, schnet
    from repro_torch.configs.gnn_common import SHAPES
    from repro_torch.launch import train as train_launcher
    from repro_torch.launch import train_gnn_100m

    result = {"launcher": {}}
    counters = kernel_launches()
    for arch in GEO_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.reset()
        report = train_launcher.main(["--device", "cuda", "--arch", arch,
                                      "--steps", str(GEO_STEPS)])
        launched = {k: c.value for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        check(report["step"] == GEO_STEPS
              and len(report["losses"]) == GEO_STEPS
              and all(math.isfinite(x) for x in report["losses"]),
              f"{arch} through the launcher: losses {report['losses']} "
              f"not {GEO_STEPS} finite")
        check(not any(launched.values()), f"{arch} training launched "
              f"kernels of the repo: {launched}")
        result["launcher"][arch] = {
            "steps": report["step"], "losses": report["losses"],
            "wall_s": report["wall_s"], "params": report["params"],
            "peak_bytes": peak}
        log(f"{arch} through the launcher on the card: {report['params']:,} "
            f"params, losses {report['losses']}, {report['wall_s']:.2f} s, "
            f"peak {peak / 2**30:.2f} GiB")

    defaults = train_launcher.parse_args([])
    default_info = dict(nodes=defaults.nodes, edges=defaults.edges,
                        d_feat=defaults.d_feat, classes=defaults.classes,
                        graphs=None)
    full = {"custom": train_full_equiformer(default_info, "custom"),
            "molecule": train_full_equiformer(SHAPES["molecule"],
                                              "molecule")}
    check(full["custom"]["params"] == EQ_PARAMS, f"equiformer-v2 _init has "
          f"{full['custom']['params']:,} parameters, not {EQ_PARAMS:,}")
    result["equiformer_full"] = full

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ckpt_dir = ROOT / "build" / "mgn_full_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        mgn = train_gnn_100m.main(["--device", "cuda", "--params-scale",
                                   "full", "--steps", str(MGN_FULL_STEPS),
                                   "--ckpt-dir", str(ckpt_dir)])
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    mgn["peak_bytes"] = torch.cuda.max_memory_allocated()
    check(mgn["params"] == MGN_FULL_PARAMS and mgn["step"] == MGN_FULL_STEPS
          and all(math.isfinite(x) for x in mgn["losses"]),
          f"train_gnn_100m full: {mgn['params']:,} params, losses "
          f"{mgn['losses']}")
    result["mgn_full"] = {k: mgn[k] for k in ("params", "nodes", "edges",
                                              "losses", "step_ms",
                                              "wall_s", "peak_bytes")}
    log(f"train_gnn_100m --params-scale full: {mgn['params']:,} params, "
        f"{mgn['nodes']} nodes, {mgn['edges']} edges, losses "
        f"{mgn['losses']}, step ms {[round(x, 1) for x in mgn['step_ms']]}, "
        f"peak {mgn['peak_bytes'] / 2**30:.2f} GiB")

    info = dict(GEO_CPU_GRAPH, graphs=None)
    result["card_vs_cpu"] = {
        "schnet": card_vs_cpu("schnet", schnet, info),
        "meshgraphnet": card_vs_cpu("meshgraphnet", meshgraphnet, info,
                                    tol_of=lambda k: MGN_GRAD_TOL),
        # each layer's logit bias shifts a head's logits, which cancels in
        # the softmax but for the tanh cap: its gradient is 1e-4–8e-4 of
        # the logit weight's, so it is held over that weight's size
        "equiformer-v2": card_vs_cpu(
            "equiformer-v2", equiformer_v2, info, size_of=lambda k: (
                k[:-len("bias")] + "weight"
                if k.endswith("alpha.layers.1.bias") else k))}
    result.update(equiformer_symmetry())
    print(json.dumps({"geometric": result}), flush=True)


# ---------------------------------------------------------------------------
# phase 6c
# ---------------------------------------------------------------------------
def full_graph_phase(stack, entry: dict) -> None:
    """GAT and SAGE full-graph forwards on the serve launcher's graph and
    its store's features (all rows looked up): SAGE at sage-base widths,
    its neighbour sums through ``segment_spmm`` on the out-neighbour ELL
    table (counter zeroed just before the call and read just after:
    exactly one launch a layer), the kernel held bitwise to its plain
    version at both calls' inputs and layer 1's call timed beside plain,
    ``torch.sparse.mm`` and its bound; GAT at 4 heads × 32; both within
    ``CPU_TOL`` of the port on the CPU with the same weights; times by
    CUDA events."""
    import torch
    from repro_torch.kernels import segment_spmm as sp
    from repro_torch.kernels.segment_spmm import ops as sp_ops
    from repro_torch.kernels.segment_spmm.ref import ell_table
    from repro_torch.models import gnn_basic

    graph, feats = stack[0], stack[1]
    n = graph.num_nodes
    dev = torch.device("cuda")
    src_np, dst_np = graph.to_coo()
    src = torch.as_tensor(src_np, dtype=torch.int32, device=dev)
    dst = torch.as_tensor(dst_np, dtype=torch.int32, device=dev)
    x = stack[4].lookup(torch.arange(n, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    check(torch.equal(x.cpu(), torch.from_numpy(feats)), "the store's rows "
          "are not the launcher's features")
    t0 = time.perf_counter()
    ell = ell_table(dst, src, n)
    torch.cuda.synchronize()
    ell_ms = (time.perf_counter() - t0) * 1e3
    log(f"full graph: {n} nodes, {graph.num_edges} edges; out-neighbour ELL "
        f"{tuple(ell.shape)} int32 ({ell.numel() * 4 / 1e6:.1f} MB) built "
        f"in {ell_ms:.1f} ms")

    sage_dims, (gat_dims, heads) = FULL_GRAPH_SAGE, FULL_GRAPH_GAT
    models = {"sage": gnn_basic.sage_init(torch.Generator().manual_seed(0),
                                          sage_dims, device=dev),
              "gat": gnn_basic.gat_init(torch.Generator().manual_seed(0),
                                        gat_dims, heads=heads, device=dev)}
    forward = {"sage": gnn_basic.sage_full_graph,
               "gat": gnn_basic.gat_full_graph}
    extra = {"sage": {"ell": ell}, "gat": {}}
    calls = []
    original = sp_ops.segment_spmm

    def recorder(ids, feat, weights=None):
        calls.append((ids, feat))
        return original(ids, feat, weights)

    result = {}
    with torch.no_grad():
        for name, model in models.items():
            sp.LAUNCHES.reset()
            sp_ops.segment_spmm = recorder
            try:
                out = forward[name](model, x, src, dst, num_nodes=n,
                                    **extra[name])
                torch.cuda.synchronize()
            finally:
                sp_ops.segment_spmm = original
            launches = sp.LAUNCHES.value
            want = SAGE_LAYERS if name == "sage" else 0
            check(launches == want, f"{name}_full_graph launched "
                  f"segment_spmm {launches} times, not {want}")
            check(out.shape == (n, sage_dims[-1] if name == "sage"
                                else gat_dims[-1] * heads)
                  and bool(torch.isfinite(out).all()),
                  f"{name} full-graph output {tuple(out.shape)} not finite")
            cpu_model = (gnn_basic.sage_init(torch.Generator().manual_seed(0),
                                             sage_dims, device="cpu")
                         if name == "sage" else
                         gnn_basic.gat_init(torch.Generator().manual_seed(0),
                                            gat_dims, heads=heads,
                                            device="cpu"))
            cpu_out = forward[name](cpu_model, torch.from_numpy(feats),
                                    src.cpu(), dst.cpu(), num_nodes=n)
            diff = float((out.cpu() - cpu_out).abs().max())
            check(diff <= CPU_TOL, f"{name} full graph card vs CPU max "
                  f"|diff| {diff:.3g} > {CPU_TOL}")
            ms = time_ms(lambda m=model, nm=name: forward[nm](
                m, x, src, dst, num_nodes=n, **extra[nm]), inner=3, reps=5,
                graph=False)
            result[name] = {"ms": ms, "launches": launches,
                            "cpu_max_abs_diff": diff,
                            "out_shape": list(out.shape)}
            log(f"{name}_full_graph on the card: {ms:.3f} ms a forward, "
                f"segment_spmm launches {launches}, card vs CPU max |diff| "
                f"{diff:.3g} (limit {CPU_TOL})")
    check(len(calls) == SAGE_LAYERS, f"sage made {len(calls)} segment_spmm "
          "calls")
    for layer, (ids, feat) in enumerate(calls, 1):
        got = sp.segment_spmm(ids, feat)
        plain = sp.segment_spmm_plain(ids, feat)
        torch.cuda.synchronize()
        check(torch.equal(got, plain), "segment_spmm != plain at the SAGE "
              f"full-graph layer {layer}'s inputs")
        del got, plain
    log(f"segment_spmm == plain bitwise at both SAGE full-graph layers' "
        "inputs")
    call = spmm_call_row("sage_full_graph layer 1", *calls[0])
    result["segment_spmm_sage_call"] = call
    result["ell_ms"] = ell_ms
    print(json.dumps({"full_graph": result}), flush=True)
    entry["launches_by_path"]["sage_full_graph"] = result["sage"]["launches"]
    entry["launches"] += result["sage"]["launches"]


# ---------------------------------------------------------------------------
# phase 6d
# ---------------------------------------------------------------------------
def halo_gin(unsharded: dict, entry: dict) -> dict:
    """GIN-TU at ``TRAIN_SHAPE`` through the launcher's halo-sharded step
    (``--mesh-world HALO_WORLD``), the ``segment_spmm`` counter zeroed just
    before and read just after: exactly ``SPMM_PER_STEP`` launches a step
    a card, finite losses, no id dropped, the first loss within
    ``HALO_LOSS_TOL`` of phase 6's; the first step's layer-2 call (d 64)
    recorded, held bitwise to the plain version, repeated, and timed
    beside it, ``torch.sparse.mm`` and its bound."""
    import math

    import torch
    from repro_torch.kernels import segment_spmm as sp
    from repro_torch.kernels.segment_spmm import ops as sp_ops
    from repro_torch.launch import train as train_launcher

    torch.cuda.reset_peak_memory_stats()
    seen, kept = [0], []
    original = sp_ops.segment_spmm

    def recorder(ids, feat, weights=None):
        seen[0] += 1
        if seen[0] == 2:                 # layer 2's forward, d 64
            kept.append((ids, feat.detach()))
        return original(ids, feat, weights)

    sp.LAUNCHES.reset()
    sp_ops.segment_spmm = recorder
    try:
        report = train_launcher.main([
            "--device", "cuda", "--steps", str(TRAIN_STEPS),
            "--mesh-world", str(HALO_WORLD),
            *(f"--{k.replace('_', '-')}={v}" for k, v in TRAIN_SHAPE.items())])
    finally:
        sp_ops.segment_spmm = original
    launches = sp.LAUNCHES.value
    peak = torch.cuda.max_memory_allocated()
    halo = report["halo"]
    want = SPMM_PER_STEP * report["cards"] * TRAIN_STEPS
    check(launches == want, f"the halo step launched segment_spmm "
          f"{launches} times for {TRAIN_STEPS} steps on {report['cards']} "
          f"card(s), not {want}")
    check(report["step"] == TRAIN_STEPS
          and len(report["losses"]) == TRAIN_STEPS
          and all(math.isfinite(x) for x in report["losses"]),
          f"halo losses {report['losses']} not {TRAIN_STEPS} finite")
    check(halo["dropped_ids"] == 0, f"the halo step dropped "
          f"{halo['dropped_ids']} ids at cap_pp {report['cap_pp']}")
    diff = abs(report["losses"][0] - unsharded["losses"][0])
    check(diff <= HALO_LOSS_TOL, f"halo first loss "
          f"{report['losses'][0]!r} vs unsharded "
          f"{unsharded['losses'][0]!r}: |diff| {diff:.3g} > {HALO_LOSS_TOL}")
    log(f"gin-tu halo at {TRAIN_SHAPE}, {HALO_WORLD} shards on "
        f"{report['cards']} card(s), cap_pp {report['cap_pp']}: "
        f"{TRAIN_STEPS} steps in {report['wall_s']:.1f} s, losses "
        f"{report['losses']} (unsharded {unsharded['losses']}; first |diff| "
        f"{diff:.3g}, limit {HALO_LOSS_TOL}), segment_spmm launches "
        f"{launches}, peak {peak / 2**30:.2f} GiB (unsharded "
        f"{unsharded['peak_bytes'] / 2**30:.2f}), remote_fraction "
        f"{report['remote_fraction']:.6f}, exchange counters {halo}")

    ids, feat = kept[0]
    got = sp.segment_spmm(ids, feat)
    again = sp.segment_spmm(ids, feat)
    plain = sp.segment_spmm_plain(ids, feat)
    torch.cuda.synchronize()
    check(torch.equal(got, plain), "segment_spmm != plain at the halo "
          "step's layer-2 call")
    check(torch.equal(again, got), "repeated halo call differs")
    err = float((got - plain).abs().max())
    del got, again, plain
    log(f"segment_spmm == plain bitwise at the halo step's layer-2 call "
        f"(ids {tuple(ids.shape)} into the {tuple(feat.shape)} exchange "
        f"buffer), repeated with equal bits")
    call = spmm_call_row("halo layer 2", ids, feat)
    del kept, ids, feat
    entry["launches"] += launches
    entry["launches_by_path"]["gin_tu_halo"] = launches
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    return {"world": HALO_WORLD, "cards": report["cards"],
            "cap_pp": report["cap_pp"],
            "remote_fraction": report["remote_fraction"],
            "losses": report["losses"],
            "unsharded_losses": unsharded["losses"], "first_loss_diff": diff,
            "wall_s": report["wall_s"], "peak_bytes": peak,
            "launches": launches, "exchange": halo,
            "segment_spmm_call": call}


def halo_equiformer() -> dict:
    """EquiformerV2 through the halo step: the launcher (``_reduced_init``)
    with ``--mesh-world HALO_WORLD`` (no kernel of the repo launches); at
    its published widths on the launcher's graph with the reference's
    ``cap_pp`` (losses, step ms, peak, dropped share); at a ``cap_pp``
    that drops nothing (each shard's edge count), its loss against the
    unsharded loss on the same batch and weights, and the card's sharded
    loss against the CPU port's at ``GEO_CPU_GRAPH``, each within
    ``CPU_TOL``."""
    import math

    import numpy as np
    import torch
    from repro_torch.configs import equiformer_v2, gnn_common
    from repro_torch.launch import train as train_launcher
    from repro_torch.launch.mesh import make_host_mesh

    out = {}
    counters = kernel_launches()
    for c in counters.values():
        c.reset()
    report = train_launcher.main([
        "--device", "cuda", "--arch", "equiformer-v2", "--steps",
        str(GEO_STEPS), "--mesh-world", str(HALO_WORLD)])
    launched = {k: c.value for k, c in counters.items()}
    check(not any(launched.values()), f"equiformer-v2 halo training "
          f"launched kernels of the repo: {launched}")
    check(len(report["losses"]) == GEO_STEPS
          and all(math.isfinite(x) for x in report["losses"]),
          f"equiformer-v2 halo launcher losses {report['losses']}")
    out["launcher"] = {k: report[k] for k in (
        "params", "losses", "wall_s", "cap_pp", "remote_fraction", "halo")}
    log(f"equiformer-v2 through the launcher with --mesh-world "
        f"{HALO_WORLD}: {report['params']:,} params, losses "
        f"{report['losses']}, cap_pp {report['cap_pp']}, exchange "
        f"{report['halo']}")

    adapter = equiformer_v2.ARCH.adapter
    defaults = train_launcher.parse_args([])
    info = dict(nodes=defaults.nodes, edges=defaults.edges,
                d_feat=defaults.d_feat, classes=defaults.classes,
                graphs=None)
    mesh = make_host_mesh(HALO_WORLD, device="cuda")
    cell = gnn_common.build_halo_cell(adapter, info, "custom", mesh)
    full = train_full_equiformer(info, "custom", cell)
    st = cell.ctx.stats
    full["cap_pp"] = cell.ctx.cap_pp
    full["exchange"] = dict(st)
    full["dropped_share"] = st["dropped_ids"] / max(st["unique_ids"], 1)
    check(full["params"] == EQ_PARAMS, f"equiformer-v2 _init has "
          f"{full['params']:,} parameters, not {EQ_PARAMS:,}")
    log(f"equiformer-v2 full width halo-sharded at the launcher's graph: "
        f"cap_pp {cell.ctx.cap_pp}, dropped share "
        f"{full['dropped_share']:.4f} of the unique ids wanted "
        f"({st['dropped_ids']} of {st['unique_ids']} over "
        f"{st['exchanges']} exchanges)")
    out["full"] = full

    def losses(graph: dict, dev: str) -> tuple[float, float, dict]:
        """(sharded loss at a no-drop cap_pp, unsharded loss, counters)
        at published widths, seed 0, without gradients."""
        model = equiformer_v2._init(torch.Generator().manual_seed(0),
                                    graph["d_feat"], graph["classes"],
                                    "custom", device=dev)
        batch = gnn_common.make_concrete_batch(graph, seed=0, device="cpu")
        rows = graph["nodes"] // HALO_WORLD
        cap = int(np.bincount(batch["dst"].numpy() // rows,
                              minlength=HALO_WORLD).max())
        c = gnn_common.build_halo_cell(
            adapter, graph, "custom",
            make_host_mesh(HALO_WORLD, device=dev), cap_pp=cap)
        with torch.no_grad():
            sharded = float(c.loss(model, c.shard(batch)))
            whole = float(equiformer_v2._loss(
                model, {k: v.to(dev) for k, v in batch.items()}, graph,
                "custom"))
        check(c.ctx.stats["dropped_ids"] == 0, "a no-drop cap_pp dropped")
        return sharded, whole, dict(c.ctx.stats)

    gc.collect()
    torch.cuda.empty_cache()
    sharded, whole, _ = losses(info, "cuda")
    diff = abs(sharded - whole)
    check(diff <= CPU_TOL, f"equiformer-v2 halo loss {sharded!r} vs "
          f"unsharded {whole!r} on the card: |diff| {diff:.3g} > {CPU_TOL}")
    small = dict(GEO_CPU_GRAPH, graphs=None)
    card, _, _ = losses(small, "cuda")
    cpu, _, _ = losses(small, "cpu")
    cpu_diff = abs(card - cpu)
    check(cpu_diff <= CPU_TOL, f"equiformer-v2 halo loss card {card!r} vs "
          f"CPU {cpu!r}: |diff| {cpu_diff:.3g} > {CPU_TOL}")
    out["no_drop"] = {"sharded": sharded, "unsharded": whole, "diff": diff,
                      "card_vs_cpu": {"card": card, "cpu": cpu,
                                      "diff": cpu_diff}}
    log(f"equiformer-v2 full width halo loss at a no-drop cap_pp: "
        f"{sharded!r} vs unsharded {whole!r} (|diff| {diff:.3g}); at "
        f"{GEO_CPU_GRAPH} card {card!r} vs CPU {cpu!r} (|diff| "
        f"{cpu_diff:.3g}; limit {CPU_TOL})")
    return out


def halo_phase(unsharded: dict, entry: dict) -> None:
    """Phase 6d: halo-sharded GIN-TU and EquiformerV2 training; one
    ``{"halo": ...}`` line."""
    import torch
    result = {"gin_tu": halo_gin(unsharded, entry)}
    gc.collect()
    torch.cuda.empty_cache()
    result["equiformer_v2"] = halo_equiformer()
    print(json.dumps({"halo": result}), flush=True)


# ---------------------------------------------------------------------------
# phase 7
# ---------------------------------------------------------------------------
def serve_lm(argv: list, capture: tuple) -> tuple[dict, dict, int]:
    """The LM launcher on ``argv`` (``serve(parse_args(argv))``) with the
    ``flash_attention`` counter zeroed just before and read just after;
    keeps the q/k/v of the prefill calls numbered in ``capture``
    (references, no copy). Checks one causal launch a layer and request,
    finite logits, ids in the vocabulary and the timings. Returns
    (report, captures, launches)."""
    import math

    import torch
    from repro_torch.configs import LM_ARCHS
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import lm as lm_launcher

    captured, calls = {}, []
    original = fa_ops.flash_attention

    def recorder(q, k, v, *, causal=True):
        if len(calls) in capture:
            captured[len(calls)] = (q, k, v)
        calls.append(causal)
        return original(q, k, v, causal=causal)

    args = lm_launcher.parse_args(argv)
    cfg = LM_ARCHS[args.arch]
    fa_ops.flash_attention = recorder
    fa.LAUNCHES.reset()
    try:
        report = lm_launcher.serve(args)
    finally:
        fa_ops.flash_attention = original
    launches = fa.LAUNCHES.value
    req = report["requests"]
    check(launches == cfg.n_layers * len(req), f"{args.arch} serving "
          f"launched flash_attention {launches} times for {len(req)} "
          f"request(s), not {cfg.n_layers} each")
    check(all(calls) and len(calls) == launches, f"{args.arch} prefill "
          "attention calls were not all causal kernel launches")
    check(report["logits_finite"], f"{args.arch} serving logits not finite")
    total = torch.cuda.get_device_properties(0).total_memory
    check(report["peak_bytes"] < total, f"{args.arch} peak device memory "
          f"{report['peak_bytes']} B over the card's {total} B")
    for r in req:
        ids = [i for row in r["generated"] for i in row]
        check(len(ids) == args.batch * (args.new_tokens + 1)
              and all(0 <= i < cfg.vocab for i in ids),
              f"{args.arch} generated ids {r['generated']} not in the "
              "vocabulary")
        check(math.isfinite(r["prefill_ms"])
              and math.isfinite(r["decode_ms_per_token"]),
              f"{args.arch} timings missing")
    return report, captured, launches


def lm_serve_phase() -> tuple[dict, dict, int]:
    """qwen3-4b through the LM launcher at its defaults (:func:`serve_lm`),
    keeping the q/k/v that layers ``LM_CAPTURE_LAYERS`` hand the kernel.
    Returns (report, captures, launches)."""
    report, captured, launches = serve_lm(["--device", "cuda"],
                                          LM_CAPTURE_LAYERS)
    req = report["requests"]
    log(f"lm serve ({report['arch']}, {report['params']:,} params, batch "
        f"{report['batch']}, prompt {report['prompt_len']}, "
        f"{report['new_tokens']} new tokens): prefill "
        f"{req[0]['prefill_ms']:.1f} ms, decode "
        f"{req[0]['decode_ms_per_token']:.2f} ms/token, flash_attention "
        f"launches {launches}, peak device memory "
        f"{report['peak_bytes'] / 2**30:.2f} GiB (with the 0.75 GiB of "
        f"captured layer inputs)")
    print(json.dumps({"lm_serve": {k: report[k] for k in (
        "arch", "params", "batch", "prompt_len", "new_tokens", "requests",
        "peak_bytes")}, "launches": launches}), flush=True)
    return report, captured, launches


def hold_flash(q, k, v, what: str, causal: bool = True) -> float:
    """The kernel against its plain version at (q, k, v): fail unless
    within ``ref.tolerance``; returns the max |diff|."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    got = fa.flash_attention_cuda(q, k, v, causal=causal)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    diff = float((got.float() - want.float()).abs().max())
    check(fa_ref.within_tolerance(got, want), f"flash_attention off its "
          f"plain version ({what}): max |diff| {diff:.3g}")
    return diff


def flash_times(q, k, v) -> dict:
    """Causal kernel, plain version and ``F.scaled_dot_product_attention``
    (the port never calls it) at (q, k, v), eager, 1 call a sample; the
    bound from this input's bytes and flops (bf16 tensor-core peak)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    nbytes = (2 * b * s * h * dh + 2 * b * s * kvh * dh) * q.element_size()
    flops = 4 * b * h * dh * s * (s + 1) // 2
    row = {
        "ms": time_ms(lambda: fa.flash_attention_cuda(q, k, v), inner=1,
                      reps=3, graph=False),
        "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v),
                            inner=1, reps=3, graph=False),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), inner=1, reps=3,
            graph=False),
        "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                        flops / BF16_TENSOR_FLOPS) * 1e3,
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                     >= flops / BF16_TENSOR_FLOPS else "operations"),
        "flops": flops, "bytes": nbytes}
    row["tflops"] = flops / row["ms"] / 1e9
    row["over_bound"] = row["ms"] / row["bound_ms"]
    row["over_library"] = row["ms"] / row["library_ms"]
    return row


def flash_attention_phase(captured: dict) -> dict:
    """Kernel vs plain at the captured 32k layer inputs and on edge cases;
    times. Returns the ``kernels`` entry (layer 0, bf16)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    err = 0.0

    def held(q, k, v, what, causal=True):
        nonlocal err
        diff = hold_flash(q, k, v, what, causal)
        err = max(err, diff)
        return diff

    for layer, (q, k, v) in sorted(captured.items()):
        log(f"flash_attention layer {layer} inputs: q {tuple(q.shape)} k "
            f"{tuple(k.shape)} {q.dtype}")
        for dtype in (torch.bfloat16, torch.float32):
            d = held(q.to(dtype), k.to(dtype), v.to(dtype),
                     f"layer {layer}, {dtype}")
            log(f"flash_attention layer {layer} {dtype}: max |kernel - "
                f"plain| {d:.3g}")
    q, k, v = captured[0]

    def part(x, s0, s1, h0=0, h1=None, d0=0, d1=None):
        return x[:, s0:s1, h0:h1, d0:d1].contiguous()

    edge = {
        "Sq 257 (tail tile)": ((part(q, 0, 257), part(k, 0, 257),
                                part(v, 0, 257)), True),
        "non-causal": ((part(q, 0, 1024), part(k, 0, 1024),
                        part(v, 0, 1024)), False),
        "H = KV = 20": ((part(q, 0, 512, 0, 20), part(q, 0, 512, 12, 32),
                         part(q, 512, 1024, 0, 20)), True),
        "dh 64": ((part(q, 0, 512, d1=64), part(k, 0, 512, d1=64),
                   part(v, 0, 512, d0=64)), True),
        "B 2": ((torch.cat([part(q, 0, 384), part(q, 384, 768)]),
                 torch.cat([part(k, 0, 384), part(k, 384, 768)]),
                 torch.cat([part(v, 0, 384), part(v, 384, 768)])), True),
        "Sq 200 < Skv 700": ((part(q, 0, 200), part(k, 0, 700),
                              part(v, 0, 700)), True),
        "B 2, sequences of 100": ((torch.cat([part(q, 0, 100),
                                              part(q, 100, 200)]),
                                   torch.cat([part(k, 0, 100),
                                              part(k, 100, 200)]),
                                   torch.cat([part(v, 0, 100),
                                              part(v, 100, 200)])), True),
    }
    for name, ((eq, ek, ev), causal) in edge.items():
        for dtype in (torch.bfloat16, torch.float32):
            held(eq.to(dtype), ek.to(dtype), ev.to(dtype),
                 f"{name}, {dtype}", causal)
    before = fa.LAUNCHES.value
    for sq, skv in ((0, 64), (64, 0)):
        out = fa.flash_attention_cuda(part(q, 0, sq), part(k, 0, skv),
                                      part(v, 0, skv))
        check(out.shape == (1, sq, q.shape[2], q.shape[3])
              and not out.any(), f"flash_attention Sq {sq} Skv {skv} "
              "not zeros")
    check(fa.LAUNCHES.value == before, "flash_attention empty input "
          "launched")
    log("flash_attention within tolerance of plain (bf16 and fp32 at layers "
        f"{sorted(captured)} of the 32k prefill; {', '.join(edge)}); Sq = 0 "
        "and Skv = 0 give zeros without a launch")

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True).transpose(1, 2)
    log("scaled_dot_product_attention yardstick vs kernel max |diff|: "
        f"{float((lib.float() - fa.flash_attention_cuda(q, k, v).float()).abs().max()):.3g}")
    del lib
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    times = flash_times(q, k, v)
    flops, nbytes = times["flops"], times["bytes"]
    row = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:81",
        "max_abs_err": err, **times,
        "design": fa_kernel.DESIGNS[q.dtype]}
    # -Xptxas -v per compiled kernel (registers, stack, spills): reported
    res = build.ptxas_resources(build.build_log("flash_attention"))
    log(f"flash_attention layer 0 (1, {s}, {h}|{kvh}, {dh}) bf16 causal, "
        f"design {row['design']}: kernel {row['ms']:.3f} ms "
        f"({row['tflops']:.1f} TFLOP/s; PR 14's design took "
        f"{FLASH_PREV_MS} ms, PERF.md), {row['over_bound']:.2f}x the bound "
        f"{row['bound_ms']:.3f} ms ({flops} flops, {nbytes} bytes, "
        f"{row['bound_by']}), {row['over_library']:.2f}x "
        f"scaled_dot_product_attention {row['library_ms']:.3f} ms, plain "
        f"{row['plain_ms']:.1f} ms; ptxas: {res}")
    return row


def lm_cpu_phase() -> None:
    """qwen3-4b at full width with ``LM_CPU_LAYERS`` layers: the card's
    prefill against the port on the CPU, same weights and prompt."""
    import torch
    from repro_torch.configs import qwen3_4b
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import bf16_ulp
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(qwen3_4b.CONFIG, n_layers=LM_CPU_LAYERS,
                              dtype="float32")
    t0 = time.perf_counter()
    cpu = tf.lm_init(torch.Generator().manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab, (1, LM_CPU_PROMPT),
                           generator=torch.Generator().manual_seed(1))
    original = fa_ops.flash_attention
    out = {}
    for dtype, cfg_d in ((torch.float32, cfg),
                         (torch.bfloat16, dataclasses.replace(
                             cfg, dtype="bfloat16"))):
        for dev in ("cuda", "cpu"):
            model = tf.LM(cfg_d, dtype=dtype, device=dev)
            model.load_state_dict(cpu.state_dict())
            qkv = []

            def recorder(q, k, v, *, causal=True):
                qkv.append((q.cpu(), k.cpu(), v.cpu()))
                return original(q, k, v, causal=causal)

            fa_ops.flash_attention = recorder
            try:
                logits, cache = tf.lm_prefill(model, tokens.to(dev), cfg_d)
            finally:
                fa_ops.flash_attention = original
            out[dtype, dev] = (logits.cpu(), {k: c.cpu()
                                              for k, c in cache.items()},
                               qkv)
            del model
    log(f"lm card vs CPU set-up and runs: {time.perf_counter() - t0:.1f} s")
    (cl, cc, cqkv), (pl, pc, pqkv) = (out[torch.float32, "cuda"],
                                      out[torch.float32, "cpu"])
    diffs = {"logits": float((cl - pl).abs().max())}
    for i, (a, b) in enumerate(zip(cqkv, pqkv)):
        for name, x, y in zip("qkv", a, b):
            diffs[f"layer{i}.{name}"] = float((x - y).abs().max())
    worst = max(diffs.values())
    check(worst <= CPU_TOL, f"lm card vs CPU (fp32) max |diff| {worst:.3g} "
          f"> {CPU_TOL}: {diffs}")
    for key in ("k", "v"):
        a, b = cc[key].float(), pc[key].float()
        allow = bf16_ulp(torch.maximum(a.abs(), b.abs())) + CPU_TOL
        check(bool(((a - b).abs() <= allow).all()), f"lm card vs CPU bf16 "
              f"cache {key} beyond one bf16 ulp + {CPU_TOL}")
    log(f"lm card vs CPU at full width, {LM_CPU_LAYERS} layers, prompt "
        f"{LM_CPU_PROMPT}, fp32: logits max |diff| {diffs['logits']:.3g}, "
        f"the fp32 q/k/v (k/v as cached) max |diff| {worst:.3g} (limit "
        f"{CPU_TOL}); bf16 cache within one bf16 ulp + {CPU_TOL}")
    bl = float((out[torch.bfloat16, "cuda"][0]
                - out[torch.bfloat16, "cpu"][0]).abs().max())
    check(bl <= LM_BF16_CPU_TOL, f"lm card vs CPU (bf16) logits max |diff| "
          f"{bl:.3g} > {LM_BF16_CPU_TOL}")
    own = float((out[torch.bfloat16, "cpu"][0] - pl).abs().max())
    log(f"lm card vs CPU, bf16 weights and activations: logits max |diff| "
        f"{bl:.3g} (limit {LM_BF16_CPU_TOL}; max |logit| "
        f"{float(pl.abs().max()):.3g}; the CPU's own bf16 logits sit "
        f"{own:.3g} from its fp32 ones)")
    print(json.dumps({"lm_card_vs_cpu": {
        "layers": LM_CPU_LAYERS, "prompt": LM_CPU_PROMPT,
        "fp32_max_abs_diff": diffs, "bf16_logits_max_abs_diff": bl,
        "cpu_bf16_vs_fp32_logits_max_abs_diff": own}}),
        flush=True)


# ---------------------------------------------------------------------------
# phase 7b
# ---------------------------------------------------------------------------
def moe_serve_phase() -> tuple[dict, dict, int]:
    """deepseek-moe-16b through the LM launcher at its defaults
    (:func:`serve_lm`), keeping layer 0's q/k/v; checks each request's
    router stats: every expert's load at most its capacity and kept +
    dropped = T·k in every layer. Returns (report, captures, launches)."""
    import numpy as np
    from repro_torch.configs import LM_ARCHS
    from repro_torch.core import expert_placement

    cfg = LM_ARCHS[MOE_ARCH]
    report, captured, launches = serve_lm(
        ["--arch", MOE_ARCH, "--device", "cuda"], (0,))
    req = report["requests"]
    for r in req:
        st = r["moe_prefill"]
        load = np.asarray(st["expert_load_by_layer"])
        dropped = np.asarray(st["dropped_by_layer"])
        check(load.shape == (cfg.n_layers, cfg.moe.num_experts)
              and isinstance(st["dropped"], int),
              f"{MOE_ARCH} router stats missing: {st.keys()}")
        check(bool((load <= st["capacity"]).all()), f"{MOE_ARCH} an "
              f"expert's load {load.max()} over its capacity "
              f"{st['capacity']}")
        check(bool((load.sum(1) + dropped == st["assignments"]).all()),
              f"{MOE_ARCH} kept + dropped assignments != T·k "
              f"({st['assignments']}) in some layer")
    st = req[0]["moe_prefill"]
    share = st["max_load_share_by_layer"]
    reps = expert_placement(np.asarray(st["expert_load_by_layer"][0]), 4, 4)
    log(f"moe serve ({MOE_ARCH}, {report['params']:,} params, "
        f"{report['active_params']:,} active, batch {report['batch']}, "
        f"prompt {report['prompt_len']}, {report['new_tokens']} new "
        f"tokens): prefill {req[0]['prefill_ms']:.1f} ms, decode "
        f"{req[0]['decode_ms_per_token']:.2f} ms/token, flash_attention "
        f"launches {launches}, peak device memory "
        f"{report['peak_bytes'] / 2**30:.2f} GiB (with the 0.38 GiB of "
        f"captured layer-0 inputs); capacity {st['capacity']} a expert, "
        f"dropped {st['dropped']} of {st['assignments'] * cfg.n_layers} "
        f"assignments ({st['dropped_share']:.4f}), largest load over "
        f"capacity {min(share):.3f}-{max(share):.3f} by layer; "
        f"expert_placement(layer-0 load, 4, 4) = {reps.tolist()}")
    print(json.dumps({"moe_serve": {k: report[k] for k in (
        "arch", "params", "active_params", "batch", "prompt_len",
        "new_tokens", "peak_bytes")} | {"requests": [
            {k: v for k, v in r.items() if k != "moe_prefill"}
            | {"moe_prefill": {k: v for k, v in r["moe_prefill"].items()
                               if k != "expert_load_by_layer"}}
            for r in req]}, "launches": launches,
        "expert_placement_layer0_4_4": reps.tolist()}), flush=True)
    return report, captured, launches


def moe_flash_phase(captured: dict, launches: int) -> dict:
    """``flash_attention`` at deepseek-moe-16b's layer-0 q/k/v (bf16 and
    cast to fp32) against its plain version, and timed beside it and SDPA.
    Returns the numbers for the kernel's ``kernels`` entry."""
    import torch
    q, k, v = captured[0]
    err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        err = max(err, hold_flash(q.to(dtype), k.to(dtype), v.to(dtype),
                                  f"{MOE_ARCH} layer 0, {dtype}"))
    times = flash_times(q, k, v)
    flops, nbytes = times["flops"], times["bytes"]
    row = {"call_site": f"{MOE_ARCH} prefill", "shape": list(q.shape)
           + [k.shape[2]], "launches": launches, "max_abs_err": err,
           **times}
    log(f"flash_attention at {MOE_ARCH} layer 0 {tuple(q.shape)}|"
        f"{k.shape[2]} bf16 causal: within tolerance of plain (bf16, fp32; "
        f"max |diff| {err:.3g}); kernel {row['ms']:.3f} ms "
        f"({row['tflops']:.1f} TFLOP/s), {row['over_bound']:.2f}x the bound "
        f"{row['bound_ms']:.3f} ms ({flops} flops, {nbytes} bytes, "
        f"{row['bound_by']}), {row['over_library']:.2f}x "
        f"scaled_dot_product_attention {row['library_ms']:.3f} ms, plain "
        f"{row['plain_ms']:.1f} ms")
    return row


def moe_cpu_phase() -> None:
    """deepseek-moe-16b at full width with ``LM_CPU_LAYERS`` layers and
    ``LM_CPU_PROMPT`` tokens: the card's prefill against the port on the
    CPU, same weights and prompt, fp32 and bf16. Each layer's experts
    (``top_e``) are compared; where they differ, the tokens and their gap
    between the k-th and (k+1)-th router probabilities are reported, and
    that layer's MoE output is held with the card's routing fed to the
    CPU."""
    import torch
    from repro_torch.configs import deepseek_moe_16b
    from repro_torch.kernels.flash_attention.ref import bf16_ulp
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(deepseek_moe_16b.CONFIG,
                              n_layers=LM_CPU_LAYERS, dtype="float32")
    k = cfg.moe.top_k
    t0 = time.perf_counter()
    cpu = tf.lm_init(torch.Generator().manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab, (1, LM_CPU_PROMPT),
                           generator=torch.Generator().manual_seed(1))
    original = moe_mod.moe_route
    report = {}
    for dtype, cfg_d in ((torch.float32, cfg),
                         (torch.bfloat16, dataclasses.replace(
                             cfg, dtype="bfloat16"))):
        runs = {}
        for dev in ("cuda", "cpu"):
            model = tf.LM(cfg_d, dtype=dtype, device=dev)
            model.load_state_dict(cpu.state_dict())
            routes, outs = [], []

            def route(m, x, c):
                r = original(m, x, c)
                routes.append([t.cpu() for t in (x, *r)])
                return r

            hooks = [b.moe.register_forward_hook(
                lambda mod, inp, out: outs.append(out.cpu()))
                for b in model.layers]
            moe_mod.moe_route = route
            try:
                logits, _ = tf.lm_prefill(model, tokens.to(dev), cfg_d)
            finally:
                moe_mod.moe_route = original
                for h in hooks:
                    h.remove()
            runs[dev] = (logits.cpu(), routes, outs)
            if dev == "cuda":
                del model
        (cl, croutes, couts), (pl, proutes, pouts) = runs["cuda"], runs["cpu"]
        flips = []
        for i, ((x, probs, top_w, top_e), (_, _, _, p_e)) in enumerate(
                zip(croutes, proutes)):
            differ = (top_e != p_e).any(-1).nonzero().flatten()
            if differ.numel() == 0:
                continue
            srt = probs.sort(-1, descending=True).values
            gaps = (srt[differ, k - 1] - srt[differ, k]).tolist()
            with torch.no_grad():
                got, _ = moe_mod.moe_apply_routed(model.layers[i].moe, x,
                                                  cfg.moe, probs, top_w,
                                                  top_e)
            want = couts[i]
            diff = float((got.float() - want.float()).abs().max())
            allow = (CPU_TOL if dtype == torch.float32 else
                     MOE_BF16_ULPS * float(bf16_ulp(want.abs().max())))
            check(diff <= allow, f"{MOE_ARCH} card vs CPU ({dtype}) layer "
                  f"{i}: MoE output with the card's routing max |diff| "
                  f"{diff:.3g} > {allow:.3g}")
            flips.append({"layer": i, "tokens": differ.tolist(),
                          "gap_k_k1": gaps, "routed_max_abs_diff": diff})
        same_out = [float((a.float() - b.float()).abs().max())
                    for a, b in zip(couts, pouts)]
        del model
        ld = float((cl - pl).abs().max())
        limit = CPU_TOL if dtype == torch.float32 else LM_BF16_CPU_TOL
        check(ld <= limit, f"{MOE_ARCH} card vs CPU ({dtype}) logits max "
              f"|diff| {ld:.3g} > {limit}")
        report[str(dtype)] = {"logits_max_abs_diff": ld,
                              "moe_out_max_abs_diff": same_out,
                              "routing_differs": flips}
        log(f"{MOE_ARCH} card vs CPU at full width, {LM_CPU_LAYERS} layers, "
            f"prompt {LM_CPU_PROMPT}, {dtype}: logits max |diff| {ld:.3g} "
            f"(limit {limit}); MoE outputs max |diff| by layer "
            f"{[f'{d:.3g}' for d in same_out]}; top_e equal in "
            f"{LM_CPU_LAYERS - len(flips)} of {LM_CPU_LAYERS} layers"
            + (f", differing: {flips}" if flips else ""))
    log(f"{MOE_ARCH} card vs CPU set-up and runs: "
        f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"moe_card_vs_cpu": {
        "arch": MOE_ARCH, "layers": LM_CPU_LAYERS, "prompt": LM_CPU_PROMPT,
        **report}}), flush=True)


def lm_train_phase() -> None:
    """qwen3-4b ``train_4k`` at its published widths and 36 layers through
    ``repro_torch.launch.lm --shape train_4k`` (fp32 weights and AdamW
    state, bf16 activations, B 1, seq 4,096, ``LM_TRAIN_STEPS`` steps),
    with nothing else on the card: finite losses, step 0 between ln V and
    ln V + 1.5 (unit-variance logits at init give about ln V + 0.5), the
    peak under the card's memory, step ms and its stages logged.
    Then card vs CPU at the smoke reduction (B 2, 64 positions, chunks
    32): in fp32 every gradient against the fp64 witness
    (:func:`hold_card_vs_cpu`); in bf16 activations the loss and the
    gradients against that witness within ``LM_BF16_LOSS_TOL`` and
    ``LM_BF16_GRAD_TOL`` (in norm)."""
    import math

    import torch
    from repro_torch.configs import LM_ARCHS, lm_common
    from repro_torch.launch import lm as lm_launcher
    from repro_torch.models import transformer as tf

    total = torch.cuda.get_device_properties(0).total_memory
    log(f"lm train: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        "allocated before the run")
    report = lm_launcher.main(["--shape", "train_4k", "--device", "cuda",
                               "--steps", str(LM_TRAIN_STEPS),
                               "--batch", "1"])
    vocab = LM_ARCHS["qwen3-4b"].vocab
    stages = report["stage_ms"]
    log(f"lm train ({report['arch']}, {report['params']:,} params, "
        f"{report['dtype']} activations, batch {report['batch']} in "
        f"{report['micro']} micro-batch(es), seq {report['seq']}): losses "
        f"{report['losses']} (ln V = {math.log(vocab):.4f}), step ms "
        f"{[round(x, 1) for x in report['step_ms']]}, stages "
        f"{[{k: round(v, 1) for k, v in st.items()} for st in stages]}"
        f", peak {report['peak_bytes'] / 2**30:.2f} GiB of "
        f"{total / 2**30:.2f}")
    check(report["params"] == LM_TRAIN_PARAMS and report["seq"] == 4096,
          f"lm train ran {report['params']:,} params at seq {report['seq']}")
    check(len(report["losses"]) == LM_TRAIN_STEPS
          and all(math.isfinite(x) for x in report["losses"])
          and 0 < report["losses"][0] - math.log(vocab) < 1.5,
          f"lm train losses {report['losses']} (step 0 should be near "
          f"ln V = {math.log(vocab):.3f})")
    check(report["peak_bytes"] < total, f"lm train peak "
          f"{report['peak_bytes']} B over the card's {total} B")
    print(json.dumps({"lm_train": report}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    cfg = lm_common.smoke_config(LM_ARCHS["qwen3-4b"])
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (2, 2, 64), generator=gen)

    def run(dev, dtype, act="float32"):
        model = tf.lm_init(torch.Generator().manual_seed(0), cfg).to(
            device=dev, dtype=dtype)
        c = dataclasses.replace(cfg, dtype=act if dtype == torch.float32
                                else "float64")
        t = toks.to(dev)
        return tf.lm_loss(model, t[0], t[1], c,
                          **lm_common.SMOKE_CHUNKS), model

    fp32 = hold_card_vs_cpu("qwen3-4b train (smoke)", run,
                            "the smoke reduction, B 2, 64 positions")
    loss16, model16 = run("cuda", torch.float32, "bfloat16")
    params = dict(model16.named_parameters())
    grads = torch.autograd.grad(loss16, list(params.values()))
    loss64, model64 = run("cpu", torch.float64)
    p64 = dict(model64.named_parameters())
    g64 = torch.autograd.grad(loss64, list(p64.values()))
    loss_diff = abs(float(loss16.detach()) - float(loss64.detach()))
    num = math.sqrt(sum(float(((a.cpu().double() - b) ** 2).sum())
                        for a, b in zip(grads, g64)))
    den = math.sqrt(sum(float((b ** 2).sum()) for b in g64))
    check(loss_diff <= LM_BF16_LOSS_TOL and num / den <= LM_BF16_GRAD_TOL,
          f"lm train bf16 card vs fp64 CPU: loss |diff| {loss_diff:.3g} "
          f"(limit {LM_BF16_LOSS_TOL}), gradients {num / den:.3g} of the "
          f"norm (limit {LM_BF16_GRAD_TOL})")
    log(f"lm train card vs CPU, bf16 activations: loss |diff| "
        f"{loss_diff:.3g} from the fp64 witness (limit {LM_BF16_LOSS_TOL}), "
        f"gradients {num / den:.3g} of its norm (limit {LM_BF16_GRAD_TOL})")
    print(json.dumps({"lm_train_card_vs_cpu": {
        "fp32": fp32, "bf16_loss_diff": loss_diff,
        "bf16_grad_norm_rel": num / den}}), flush=True)


# ---------------------------------------------------------------------------
# phase 8
# ---------------------------------------------------------------------------
FIGURE_STORES = ("quiver", "hash", "degree", "freq")  # placement_compare's
FIGURE_PRODUCTS = ("placement_compare", "feature_collection")
# the serving figures at products' size: their gathers are counted, not
# captured (FIGURE_PRODUCTS' stores are the timed calls)
FIGURE_SERVE_PRODUCTS = ("calibration", "skew_robustness", "serve_throughput")


def capture_figure_gathers() -> tuple:
    """Wrap the store's ``tiered_gather`` so that each distinct (hot, warm)
    pair keeps its largest call's arguments, in order of first use.
    Returns ``(calls, restore)``; the kept tensors hold their stores'
    device rows until ``calls`` is dropped."""
    from repro_torch.core import feature_store as fs
    original = fs.tiered_gather
    calls: dict = {}

    def wrapped(tier, slot, hot, warm):
        key = (id(hot), id(warm))
        if key not in calls or tier.shape[0] > calls[key][0].shape[0]:
            calls[key] = (tier, slot, hot, warm)
        return original(tier, slot, hot, warm)

    fs.tiered_gather = wrapped

    def restore():
        fs.tiered_gather = original
    return calls, restore


def figure_gather_row(name: str, args) -> dict:
    """``tiered_gather`` at one figure store's largest call: bitwise to its
    plain version (twice), then kernel, plain version and ``index_select``
    on the concatenated tables timed (CUDA graph replays), beside the bound
    (ids and tier/slot read once, each distinct row read once, the output
    written once)."""
    import torch
    from repro_torch.kernels import tiered_gather as tg
    tier, slot, hot, warm = args
    got = tg.tiered_gather_cuda(tier, slot, hot, warm)
    again = tg.tiered_gather_cuda(tier, slot, hot, warm)
    want = tg.tiered_gather_ref(tier, slot, hot, warm)
    torch.cuda.synchronize()
    check(torch.equal(bits(got), bits(want))
          and torch.equal(bits(again), bits(got)),
          f"tiered_gather != plain by bits at the {name} store's call")
    m, d = tier.shape[0], hot.shape[1]
    elem = hot.element_size()
    table = torch.cat([hot, warm, hot.new_zeros((1, d))])
    h_rows, w_rows = hot.shape[0], warm.shape[0]
    sl = slot.long()
    lib_idx = torch.where(tier == 0, sl.clamp(0, h_rows - 1),
                          torch.where(tier == 1,
                                      h_rows + sl.clamp(0, w_rows - 1),
                                      h_rows + w_rows))
    read_rows = distinct_rows(tier, slot, (hot, warm))
    nbytes = 8 * m + read_rows * d * elem + m * d * elem
    row = {"m": m, "d": d, "distinct_rows": read_rows,
           "device_rows": int(((tier == 0) | (tier == 1)).sum()),
           "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "ms": time_ms(lambda: tg.tiered_gather_cuda(tier, slot, hot,
                                                       warm)),
           "plain_ms": time_ms(lambda: tg.tiered_gather_ref(tier, slot, hot,
                                                            warm)),
           "library_ms": time_ms(lambda: torch.index_select(table, 0,
                                                            lib_idx))}
    log(f"tiered_gather at the {name} store's call (M {m}, d {d}, "
        f"{row['device_rows']} HOT/WARM rows, {read_rows} distinct): "
        f"kernel {row['ms']:.5f} ms, plain {row['plain_ms']:.5f} ms, "
        f"index_select {row['library_ms']:.5f} ms, bound "
        f"{row['bound_ms']:.5f} ms ({nbytes} bytes)")
    return row


def figures_phase(tg_entry: dict) -> None:
    """The paper's figures through ``repro_torch.bench.run`` on the card:
    the eight modules at the reference's sizes, then ``placement_compare``
    and ``feature_collection`` at ogbn-products' size, then
    ``calibration``, ``skew_robustness`` and ``serve_throughput`` there
    (600 requests, at once and paced), every counter set to 0 just
    before and read just after. Every module must end ``ok``
    (placement_compare and feature_collection hold each store's reads to
    the features bit for bit, and validate the plans); ``tiered_gather``
    must have launched once for each ``lookup_hops`` the figures' stores
    served, and no other kernel at all. Then ``tiered_gather`` at each
    products-size store's largest call against its plain version, its
    bound, ``index_select`` and the launch floor."""
    import torch
    from repro_torch.bench import common as bench_common
    from repro_torch.bench import run as bench_run
    from repro_torch.kernels import (embedding_bag, flash_attention,
                                     gather_aggregate, segment_spmm,
                                     tiered_gather)

    bw = bench_common.tier_bandwidths("cuda")
    for line in bench_common.format_bandwidths(bw).splitlines():
        log(line)
    print(json.dumps({"tier_bandwidths": bw}), flush=True)
    counters = (tiered_gather, gather_aggregate, embedding_bag, segment_spmm,
                flash_attention)
    for m in counters:
        m.LAUNCHES.reset()
    check(sorted(FIGURE_PRODUCTS + FIGURE_SERVE_PRODUCTS)
          == sorted(bench_run.SIZES["products"]),
          f"phase 8 runs {FIGURE_PRODUCTS + FIGURE_SERVE_PRODUCTS} at the "
          f"products size, the runner {sorted(bench_run.SIZES['products'])}")
    status = {}
    for size, names, capture in (
            ("reference", bench_run.FIGURES, False),
            ("products", FIGURE_PRODUCTS, True),
            ("products", FIGURE_SERVE_PRODUCTS, False)):
        t0 = time.perf_counter()
        if capture:
            calls, restore = capture_figure_gathers()
        try:
            ran = bench_run.run_modules(names, device="cuda", size=size)
        finally:
            if capture:
                restore()
        status.setdefault(size, {}).update(ran)
        log(f"figures at the {size} size in {time.perf_counter() - t0:.1f} "
            f"s: " + ", ".join(f"{n} {s['status']} {s['seconds']:.1f} s"
                               for n, s in ran.items()))
        failed = [n for n, s in ran.items() if s["status"] != "ok"]
        check(not failed, f"figure modules failed at the {size} size: "
              f"{failed}")
    counts = {k: c.value for k, c in kernel_launches().items()}
    expected = sum(s["fused_lookups"] for run in status.values()
                   for s in run.values())
    log(f"figures: launches {counts}; lookup_hops served {expected}")
    check(counts["tiered_gather"] == expected and expected > 0,
          f"tiered_gather launched {counts['tiered_gather']} times for "
          f"{expected} lookup_hops")
    check(not any(v for k, v in counts.items() if k != "tiered_gather"),
          f"the figures launched another kernel: {counts}")
    for size, run in status.items():
        pc = run["placement_compare"]
        check(pc["validated"] == ["degree", "freq", "hash", "p3", "quiver"],
              f"placement_compare validated {pc['validated']} ({size})")
        check(sorted(pc["bitwise_ids"]) == sorted(FIGURE_STORES),
              f"placement_compare checked {pc['bitwise_ids']} ({size})")
        check(run["feature_collection"]["bitwise_ids"].get("quiver", 0) > 0,
              f"feature_collection unchecked ({size})")
        log(f"figures[{size}]: hash/degree/freq/p3 plans validated; "
            f"lookups bitwise to the features (ids checked) "
            f"{pc['bitwise_ids']}, feature_collection "
            f"{run['feature_collection']['bitwise_ids']}")
    names = FIGURE_STORES + ("feature_collection",)
    check(len(calls) == len(names),
          f"{len(calls)} stores launched tiered_gather at the products "
          f"size, {len(names)} expected")
    rows = {name: figure_gather_row(name, args)
            for name, args in zip(names, calls.values())}
    del calls
    one = torch.zeros(1, device="cuda")
    floor_ms = time_ms(lambda: one.add_(1))
    log(f"launch floor (an in-place add on one element): {floor_ms:.5f} ms")
    tg_entry["launches"] += counts["tiered_gather"]
    tg_entry["launches_by_path"] = {"gnn_serve": tg_entry["launches"]
                                    - counts["tiered_gather"],
                                    "paper_figures": counts["tiered_gather"]}
    tg_entry["paper_figures"] = {"products": rows, "floor_ms": floor_ms}
    print(json.dumps({"figures": {
        size: {n: {"status": s["status"], "seconds": s["seconds"],
                   "fused_lookups": s["fused_lookups"]}
               for n, s in run.items()} for size, run in status.items()},
        "card": bw["card"]}), flush=True)


# ---------------------------------------------------------------------------
# phase 8b
# ---------------------------------------------------------------------------
# the autotune's widths and shape beside the module's own inputs: the
# launcher's --fuse-aggregate call (2,272 segments of fan 5, phase 3)
AUTOTUNE_DIMS = (16, 64, 256)
AUTOTUNE_SHAPE = (2272, 5)


def count_store_calls() -> tuple:
    """Count the single-host store's ``lookup_hops`` calls (those made
    with a device cache attached apart: their cold ids may all hit the
    cache, and then no gather launches) and its ``lookup_aggregate``
    calls. Returns ``(counts, restore)``."""
    import threading
    from repro_torch.core.feature_store import TieredFeatureStore as Store
    hops, agg = Store.lookup_hops, Store.lookup_aggregate
    counts = {"lookup_hops": 0, "lookup_hops_cached": 0,
              "lookup_aggregate": 0}
    lock = threading.Lock()

    def bump(key):
        with lock:
            counts[key] += 1

    def lookup_hops(self, *args, **kwargs):
        bump("lookup_hops" if self.cache is None else "lookup_hops_cached")
        return hops(self, *args, **kwargs)

    def lookup_aggregate(self, *args, **kwargs):
        bump("lookup_aggregate")
        return agg(self, *args, **kwargs)

    Store.lookup_hops, Store.lookup_aggregate = lookup_hops, lookup_aggregate

    def restore():
        Store.lookup_hops, Store.lookup_aggregate = hops, agg
    return counts, restore


def hold_plans(tier, slot, hot, warm, cold, what: str) -> int:
    """Every launch shape the autotune sweeps on these inputs gives the
    default plan's and the plain version's bits (compared as integers).
    Returns the plans held."""
    import torch
    from repro_torch.kernels.build import sm_count
    from repro_torch.kernels.gather_aggregate import autotune, kernel, ref
    want = ref.gather_aggregate_ref(tier, slot, hot, warm, cold)
    default = kernel.gather_aggregate_cuda(tier, slot, hot, warm, cold)
    addr = (hot.data_ptr() | warm.data_ptr() | cold.data_ptr()
            | default.data_ptr())
    plans = autotune.candidate_plans(hot.shape[1], hot.element_size(), addr,
                                     tier.shape[0], sm_count(hot.device))
    torch.cuda.synchronize()
    check(torch.equal(bits(default), bits(want)),
          f"gather_aggregate default plan != plain by bits ({what})")
    for plan in plans:
        got = kernel.gather_aggregate_cuda(tier, slot, hot, warm, cold,
                                           plan=plan)
        torch.cuda.synchronize()
        check(torch.equal(bits(got), bits(want)),
              f"gather_aggregate plan {autotune.plan_key(plan)} != plain by "
              f"bits ({what})")
    return len(plans)


def autotune_row(tier, slot, hot, warm, cold, what: str) -> dict:
    """The autotune on these inputs (every candidate held bitwise first),
    beside the bound (ids read once, each distinct row once, the output
    once; a valid child's adds at the fp32 rate) and ``F.embedding_bag``
    on the concatenated tables."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.gather_aggregate import autotune
    n_plans = hold_plans(tier, slot, hot, warm, cold, what)
    tune = autotune.autotune_gather_aggregate(tier, slot, hot, warm, cold)
    s, fan = tier.shape
    d, elem = hot.shape[1], hot.element_size()
    read_rows = distinct_rows(tier, slot, (hot, warm, cold))
    nbytes = 8 * s * fan + read_rows * d * elem + s * d * elem
    flops = int(((tier >= 0) & (tier <= 2)).sum()) * d
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
    table = torch.cat([hot, warm, cold, hot.new_zeros((1, d))])
    h_rows, w_rows, c_rows = hot.shape[0], warm.shape[0], cold.shape[0]
    sl = slot.long()
    lib_idx = torch.where(
        tier == 0, sl.clamp(0, h_rows - 1), torch.where(
            tier == 1, h_rows + sl.clamp(0, w_rows - 1), torch.where(
                tier == 2, h_rows + w_rows + sl.clamp(0, c_rows - 1),
                h_rows + w_rows + c_rows)))
    library_ms = time_ms(lambda: F.embedding_bag(lib_idx, table, mode="sum"))
    key = "{vec_bytes}x{lanes}x{blocks}"
    best, default = tune["best"], tune["default"]
    row = {"shape": [s, fan, d], "plans": n_plans,
           "timings_us": tune["timings_us"], "best": best,
           "default": default,
           "best_us": tune["timings_us"][key.format(**best)],
           "default_us": tune["timings_us"][key.format(**default)],
           "bound_ms": bound_ms, "bytes": nbytes, "library_ms": library_ms,
           "launches": tune["launches"]}
    log(f"gather_aggregate autotune at {what} (S {s}, fan {fan}, d {d}): "
        + ", ".join(f"{k} {v:.3f} us" for k, v in tune["timings_us"].items()))
    log(f"  {n_plans} plans bitwise to plain; chosen {key.format(**best)} "
        f"{row['best_us']:.3f} us, default {key.format(**default)} "
        f"{row['default_us']:.3f} us; bound {bound_ms * 1e3:.3f} us "
        f"({nbytes} bytes); F.embedding_bag {library_ms * 1e3:.3f} us")
    return row


def serving_benches_phase(tg_entry: dict, ga_entry: dict) -> None:
    """The eight serving benchmarks of ``repro_torch.bench.run`` on the card
    at the reference's full sizes, one at a time, every launch counter set
    to 0 just before each and read just after. Each must end ``ok`` (its
    in-run assertions held on the card); every module but
    ``sharded_hierarchy`` must have made ``lookup_hops`` calls and
    launched ``tiered_gather`` (``sharded_hierarchy``: none, by design);
    ``tiered_gather`` must have launched once for each ``lookup_hops``
    made with no device cache attached (with one attached, at most once a
    call); ``gather_aggregate`` once for each ``lookup_aggregate``,
    in the ``gather_aggregate`` module only (where the autotune's own
    launches are counted apart); no other kernel at all. Then every plan
    the autotune sweeps, at the module's inputs and at d 16, 64 and 256,
    held to the plain version bit for bit, with the timings, the chosen
    plan, the bound and ``F.embedding_bag``."""
    import torch
    from repro_torch.bench import common as bench_common
    from repro_torch.bench import gather_aggregate as ga_bench
    from repro_torch.bench import run as bench_run

    counters = kernel_launches()
    tune_calls: list = []
    original_tune = ga_bench.autotune_gather_aggregate

    def recorded_tune(*args, **kwargs):
        out = original_tune(*args, **kwargs)
        tune_calls.append((args, out))
        return out

    status, paths = {}, {}
    ga_bench.autotune_gather_aggregate = recorded_tune
    try:
        for name in bench_run.SERVING:
            for c in counters.values():
                c.reset()
            calls, restore = count_store_calls()
            try:
                ran = bench_run.run_modules([name], device="cuda")[name]
            finally:
                restore()
            launches = {k: c.value for k, c in counters.items()}
            status[name] = ran
            log(f"serving bench {name}: {ran['status']} in "
                f"{ran['seconds']:.1f} s; launches {launches}; store calls "
                f"{calls}")
            check(ran["status"] == "ok", f"serving bench {name} failed")
            tg, ga = launches["tiered_gather"], launches["gather_aggregate"]
            uncached, cached = calls["lookup_hops"], calls["lookup_hops_cached"]
            if name == "sharded_hierarchy":
                # by design: the sharded store's shards answer with their
                # own gathers, and the single-host source store is read
                # only through per-hop lookup, never lookup_hops
                check(uncached == cached == tg == 0,
                      f"{name}: {uncached} + {cached} lookup_hops and "
                      f"{tg} tiered_gather launches, where none are made")
            else:
                check(uncached + cached > 0 and tg > 0,
                      f"{name}: {uncached} + {cached} lookup_hops and {tg} "
                      "tiered_gather launches: the module went round the "
                      "store's fused lookup")
            if cached:
                check(uncached <= tg <= uncached + cached,
                      f"{name}: tiered_gather launched {tg} times for "
                      f"{uncached} lookup_hops without a cache and {cached} "
                      "with one")
            else:
                check(tg == uncached,
                      f"{name}: tiered_gather launched {tg} times for "
                      f"{uncached} lookup_hops")
            tuned = sum(out["launches"] for _, out in tune_calls) \
                if name == "gather_aggregate" else 0
            check(ga == calls["lookup_aggregate"] + tuned,
                  f"{name}: gather_aggregate launched {ga} times for "
                  f"{calls['lookup_aggregate']} lookup_aggregate and "
                  f"{tuned} autotune calls")
            check((calls["lookup_aggregate"] > 0) == (name == "gather_aggregate"),
                  f"{name}: {calls['lookup_aggregate']} lookup_aggregate")
            check(not any(v for k, v in launches.items()
                          if k not in ("tiered_gather", "gather_aggregate")),
                  f"{name} launched another kernel: {launches}")
            paths[name] = {"tiered_gather": tg,
                           "gather_aggregate": ga - tuned,
                           "autotune": tuned, **calls}
    finally:
        ga_bench.autotune_gather_aggregate = original_tune
    check(len(tune_calls) == 1,
          f"the gather_aggregate module ran {len(tune_calls)} autotunes")

    # every plan, at the module's inputs and at each width
    args, _ = tune_calls[0]
    tune = {"module": autotune_row(*args, "the module's inputs")}
    del tune_calls
    gen = torch.Generator(device="cuda").manual_seed(25)
    s, fan = AUTOTUNE_SHAPE
    for d in AUTOTUNE_DIMS:
        def table(rows):
            return negative_zeros(torch.randn((rows, d), generator=gen,
                                              device="cuda"))

        hot, warm, cold = table(1000), table(3000), table(64)
        tier = torch.randint(0, 4, (s, fan), generator=gen, device="cuda",
                             dtype=torch.int32)
        tier[tier == 3] = 99
        slot = torch.randint(-2, 3100, (s, fan), generator=gen,
                             device="cuda", dtype=torch.int32)
        tune[f"d{d}"] = autotune_row(tier, slot, hot, warm, cold, f"d {d}")

    for name, n in paths.items():
        if n["tiered_gather"]:
            tg_entry["launches_by_path"][f"bench/{name}"] = n["tiered_gather"]
            tg_entry["launches"] += n["tiered_gather"]
    ga_launches = paths["gather_aggregate"]["gather_aggregate"]
    ga_entry["launches_by_path"] = {"gnn_serve": ga_entry["launches"],
                                    "bench/gather_aggregate": ga_launches}
    ga_entry["launches"] += ga_launches
    ga_entry["autotune"] = tune
    print(json.dumps({"serving_benches": {
        "modules": {n: {**r, "launches": paths[n]} for n, r in status.items()},
        "autotune": tune, "card": bench_common.card_name("cuda")}},
        default=str), flush=True)


def main() -> None:
    import torch
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: needs an NVIDIA GPU")
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it "
             "from a checkout of the repository")
    sys.path.insert(0, str(src))

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    # 2. build
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")

    # 3. kernels at the serve path's inputs
    from repro_torch.launch import serve as launcher
    defaults = launcher.parse_args([])
    fanouts = launcher.fanouts_of(defaults)
    stack = launcher.stack_from_args(defaults)
    gen = stack[5]
    gen_seeds = [r.seeds for r in gen.stream(8, defaults.batch)]
    results = kernel_phase(stack, fanouts, gen_seeds[0])

    # 4. serve
    baselines = serve_phase(results, stack, fanouts, gen_seeds)
    t0 = time.perf_counter()
    cold_path_phase(fanouts, baselines)
    log(f"cold path phase in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sharded_phase(fanouts, baselines)
    log(f"sharded phase in {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # 5. din
    from repro_torch.launch import recsys_din
    t0 = time.perf_counter()
    din_stack = recsys_din.build_stack("din", device="cuda")
    log(f"din stack built in {time.perf_counter() - t0:.1f} s: "
        f"{din_stack.cfg.n_items} items, placement "
        f"{din_stack.store.plan.tier_counts()}")
    entry = embedding_bag_phase(din_stack)
    din_phase(din_stack, entry)
    results.append(entry)
    del din_stack
    gc.collect()
    torch.cuda.empty_cache()

    # 5b. din train_batch
    t0 = time.perf_counter()
    din_train_phase(entry)
    log(f"din train phase in {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # 6. train
    entry = segment_spmm_phase()
    gc.collect()
    torch.cuda.empty_cache()
    unsharded = train_phase(entry)
    results.append(entry)
    gc.collect()
    torch.cuda.empty_cache()

    # 6c. GAT and SAGE full graph
    t0 = time.perf_counter()
    full_graph_phase(stack, entry)
    log(f"full graph phase in {time.perf_counter() - t0:.1f} s")
    del stack
    gc.collect()
    torch.cuda.empty_cache()

    # 6d. halo-sharded training
    t0 = time.perf_counter()
    halo_phase(unsharded, entry)
    log(f"halo phase in {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # 6b. geometric training
    t0 = time.perf_counter()
    geometric_phase()
    log(f"geometric phase in {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # 7. lm
    torch.cuda.reset_peak_memory_stats()
    _, captured, launches = lm_serve_phase()
    entry = flash_attention_phase(captured)
    entry["launches"] = launches
    del captured
    gc.collect()
    torch.cuda.empty_cache()
    lm_cpu_phase()
    gc.collect()
    torch.cuda.empty_cache()

    # 7b. MoE lm
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, captured, launches = moe_serve_phase()
    entry[MOE_KEY] = moe_flash_phase(captured, launches)
    del captured
    gc.collect()
    torch.cuda.empty_cache()
    moe_cpu_phase()
    log(f"moe phase in {time.perf_counter() - t0:.1f} s")
    results.append(entry)
    gc.collect()
    torch.cuda.empty_cache()

    # 7c. qwen3-4b train_4k, with nothing else on the card
    t0 = time.perf_counter()
    lm_train_phase()
    log(f"lm train phase in {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # 8. the paper's figures
    t0 = time.perf_counter()
    figures_phase(next(r for r in results if r["name"] == "tiered_gather"))
    log(f"figures phase in {time.perf_counter() - t0:.1f} s")

    # 8b. the serving benchmarks
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serving_benches_phase(
        next(r for r in results if r["name"] == "tiered_gather"),
        next(r for r in results if r["name"] == "gather_aggregate"))
    log(f"serving benches phase in {time.perf_counter() - t0:.1f} s")

    # 9. summary
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("design", "floor_ms", "tflops", "over_bound", "over_library",
             MOE_KEY, "launches_by_path", "paper_figures", "autotune")
    print(json.dumps({"kernels": [
        {k: r[k] for k in keys} | {k: r[k] for k in extra if k in r}
        for r in results]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
