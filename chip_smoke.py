#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each fails loudly; the exit code is non-zero on any error):

1. the card: name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build: every CUDA kernel of the port compiled with ``nvcc`` for sm_90a
   from ``src/repro_torch/kernels/csrc``, one process per source, all at
   once (time and ``-Xptxas -v``);
3. kernels: each kernel at the DeepSeek-R1 main-path shapes (per logical
   rank, G' = 4, bf16) held against its plain PyTorch version (max error
   relative to max|ref| <= 2e-2), and timed with CUDA events (median of 5
   windows of >= 40 ms, with the fastest and slowest) beside its plain
   version, a per-bank torch.matmul/bmm composition (a yardstick the port
   never calls; for flash attention ``scaled_dot_product_attention`` with
   an explicit mask) and its bound. Flash attention is held at R1's 1024-
   and 8192-token prompts and Gemma-3's 4096-token prompt (local and
   global layers), its error also held per query row and head, and its
   bound counting only the visible keys' bytes and the visible query-key
   pairs' operations; each case prints its plan (bf16 at hd 128 must run
   the Hopper path, TMA-fed K/V and wgmma), a second launch must give the
   same bits, and a ragged case (Sq, Sk not multiples of 128, a window and
   an offset) joins the five. The demand kernel is checked at each fetch
   mode's fetched bank; its padding rows must be exact zeros and its real
   experts' blocks bitwise kernel #2's (at C 1, 16 and 88). Kernel #4 is
   also held at the k/v projections' widths (R1 Fs 256 at 2, 256 and 2048
   rows, Gemma-3 Fs 512), #4, #5 and #6 at R1 8192's per-rank prefill
   (2048 rows) and #2 at its expert capacity (C 88). At each case of #2-#6
   the plan of every launch (path, tile, stages, splits) is printed and
   must be, as counted by the wrapper, the Hopper path (TMA, mbarrier
   ring, wgmma) above 2 rows; at 2 rows or fewer split_hopper.cuh's
   few-row path (#4-#6) or its Hopper path at BM 64 (#2, #3); a second
   launch must give the same bits. One 64 x 64 x 64 tile through TMA and
   wgmma is held against an fp32 product;
   Kernel #1 is held at R1's expert shapes at C 1, 16 and 88, with bf16
   and with e4m3-stored banks (bf16 activations; its fp8 bound counts
   1-byte weights, and the bf16 kernel on the widened banks is timed
   beside it, no PyTorch call multiplying bf16 by fp8 as it does); its
   plan is printed and must be the Hopper path at every launch. With e4m3
   and e5m2 banks at C 1, 16 and 88 its result must be bitwise the bf16
   kernel's on the widened banks under the same block tile;
4. ``ops.split_gemm`` (kernel #1's entry point; no engine calls it) at
   R1 expert shapes, C 16 and 1, with bf16 and then e4m3 banks: its
   launches counted, every one on the Hopper path;
5. serve: ``build_engine`` at DeepSeek-R1 width (2 layers, first one
   dense), mesh (data=1, model=4) as 4 logical ranks, random weights from a
   seeded generator, every step a captured CUDA graph; 4 requests at two
   pow2 prefill buckets (1024 and 512 tokens), 16 output tokens each,
   max_batch 2. Warmup captures every bucket and decode variant and the
   serve must capture nothing more. Every kernel of the all-fetch path
   must have launched in the replays, as measured: for each variant that
   replayed, one replay and one eager run of its step on the same inputs
   are traced, the port's device kernels by name and count must be the
   same in both, and the eager run's wrapper launches must equal what
   the capture recorded; a kernel's launches are then that record times
   the variant's replays, which must equal the host counters. One
   prefill's and one decode step's logits are compared with the plain
   versions' (tolerance below); one prefill profiled, replayed and eager;
   the path counts of kernels #2-#6 over the serve are printed, and every
   launch above 2 rows must have run the Hopper path, every one at 2 rows
   or fewer its kernel's path as above, and every flash attention launch
   the Hopper path (its plans are counted and printed per serve). A
   request served alone must give the same tokens as served among the 4,
   and its first decode step's logits beside another request those
   beside an empty slot (row-local capacity, ``capacity_from="global"``);
6. fetch modes: the same requests on the same weights under ``expert_fetch``
   all, demand, predictive and sync_free, each through graphs and eagerly
   (``graphs=False``): every serve's tokens must equal the all-fetch graph
   serve's, and one decode step from the all-fetch serve's final state
   (with the mode's warm predictor) its logits bitwise; the demand kernel
   must launch in the route-before-gather modes (through graphs, launches
   measured through the replays as in 5). The demand graph engine
   also serves the requests again switching demand <-> predictive every 4
   steps (at least 3 switches, both tables warmed: no capture, no variant
   built), and demand with a budget of 1 row per peer must give the
   all-fetch tokens and logits, its overflowed steps run again eagerly and
   counted. Per mode, graph against eager, with the card's name and power
   limit: TPOT p50, the device ms of one replayed decode step (CUDA events)
   and of the eager step (profiled, by kind), TPOT / device time, peak
   memory, landing bytes per decode step and fallbacks;
7. DeepSeek-R1 at the paper's input length: the same weights behind a
   ``prefill_len`` 8192 engine (graphs); 2 requests of 8192 tokens, 16 output tokens
   each, max_batch 2; flash attention must launch; TTFT, TPOT, peak memory,
   one profiled prefill, and one prefill's and one decode step's logits
   against the plain versions;
8. DEP, the paper's baseline, behind the reference's default serving pair:
   on the same weights, a DWDP context server feeding a DEP generation
   server (graphs; experts stay with their owners behind an all-to-all,
   tensor-parallel FFN, decode attention gathered merged) serves the R1
   1024 cell as in 5: warmup captures every variant, the serve none more,
   every all-fetch kernel must launch in the replays (the context server's
   DWDP prefill) and none in the DEP decode step's, prefill and decode
   logits against the plain versions. From the served state: one DEP decode step
   (replay ms, profiled by kind, landed bytes: the merged attention)
   against the DWDP all-fetch step of the same state, and one qgather and
   one hybrid decode step (the hybrid one must launch #4-#6) against their
   plain versions, each within LOGIT_TOL; one DEP ``forward_prefill``
   (tensor-parallel attention) must launch flash attention on its Hopper
   path once per layer and rank and no other kernel (``DEP_KERNELS``), its
   logits within LOGIT_TOL of the plain
   versions'; a rolling ``ServingScheduler`` serve over
   ``LiveReplicaClient``; then an eager DEP engine (``graphs=False``) must
   give the graph serve's tokens bitwise. Printed beside the card's name
   and power limit: TPOT p50, the all-to-all bytes per decode step (from
   the shapes), peak memory (under the limit), and TPS/user and TPS per
   card beside the DWDP all-fetch and demand serves'. Kernel #7 is also
   held at DEP's tensor-parallel prefill shapes in 3, and DEP's grouped
   expert FFN (``torch.bmm``, no kernel of the port) timed at its decode
   shape beside its byte bound;
9. mesh (data=2, model=4), on R1 1024's weights (the two data replicas
   share the model ranks' tensors): the batch-sharded prefill, B = 4 on
   (1, 4) and B = 8 on (2, 4) (each rank a whole 1024-token row), must
   launch every kernel as often as the shapes say, with last logits within
   LOGIT_TOL of the plain versions' and, in the no-drop regime, of each
   prompt's seq-sharded B = 1 prefill; then ``build_engine(mesh_shape=(2,
   4), max_batch=4)`` serves the 4 requests with a DWDP context server (each
   prompt over all eight ranks) and generation in DEP, DWDP all-fetch and
   DWDP demand (two slots per replica, the KV ring over model), each
   through graphs as in 5 and then eagerly (the same tokens); from the
   served state one decode step: replay time, profile, ``prefetch.LANDED``
   equal to 8 x the modelled per-rank bytes, and its logits at row-local
   capacity within LOGIT_TOL of a (1, 4) server's step on the same slots
   (admitted from ``snapshot_slot``). TPOT, TTFT, TPS/user, TPS per card,
   replay time, landed bytes and peak are printed beside the (1, 4) serves'
   of this run. Kernels #2, #4-#7 are also held in 3 at this phase's
   per-rank shapes (the (2, 4) context prefill's 128-token shards, a whole
   1024-token row);
10. Gemma-3-27B (every width kept, 6 layers: one 5 local : 1 global
   pattern), mesh (1, 4), random weights, graphs: 4 requests of 4096 tokens, 16
   output tokens each, max_batch 2. Every kernel of its path must launch
   (the dense split kernels and flash attention's window branch); prefill
   and decode-step logits against the plain versions; a request alone
   against among the others, tokens and first decode step's logits, as in
   5; TTFT, TPOT, peak, one profiled prefill;
11. the serving layer (``runtime.serving``), each run with the launch counts
   set to 0 just before and read just after, its kernels required: on the
   R1 1024 engine's weights and graph pool, servers with row-local
   capacity serve 4 requests (buckets 1024 and 512, 8 / 16 / 8 / 16 output
   tokens) through ``DisaggregatedEngine.run``, then ``ServingScheduler``
   over ``LiveReplicaClient`` with rolling admission and in
   ``epoch_mode``, then under an SLO (evict_after 2, a target above
   1 / TPOT) that evicts and resumes: every stream bitwise equal, rolling
   in fewer decode steps than epoch, two requests evicted and resumed in
   each other's slot bitwise, no capture after warmup. In 6, the demand
   graph engine switched to predictive serves through the live client
   with a ``RoutedTraceRecorder``: (steps, 4, 256) bitmaps, at most top_k
   x rows experts per rank, the all-fetch tokens. After 10, two Gemma-3
   replicas behind ``MultiReplicaEngine`` serve a workload skewed to the
   4096 bucket: every request completed, the router's assignments
   printed. Each serving summary (TTFT, TPOT, TPS/user, TPS per card,
   ``gather_fetch_ratio``, predictive hit rates) is printed beside the
   landed bytes per decode step, with the card's name and power limit;
12. gather policies (run after 9, on R1 1024's weights, mesh (1, 4),
   graphs): the merged layout (``merged:all:allgather``: every shard, the
   resident one included, in one canonical buffer) serves the 4 requests as
   in 5 (prefill and decode logits against the plain versions, launches
   through the replays: flash attention in prefill, no split kernel, the
   decode step none), landing exactly 4/3 of the split serve's bytes per
   decode step (a quarter of them the resident copies), its peak held to
   the card's 80 GB; its tokens' agreement with the split serve's is
   printed (bf16 router ties break differently). The split ``ring`` and
   ``ring_sliced`` serves must give the all-fetch serve's tokens and one
   decode step's logits (from 5's final state) bitwise, and
   ``merged:all:ring_sliced`` the merged serve's; the ring_sliced engine
   then serves again switching to allgather and back every 2 steps (both
   tables warmed: the unswitched tokens, no capture, no variant built).
   The JAX package's MIXED table (demand-fetched split experts, merged
   attention, the dense FFN split over the ring) must be bitwise its
   COMPOSED table (demand -> all, ring -> allgather). Each serve prints its
   decode and 1024-token prefill replay ms, TPOT, landed and merge bytes,
   peak, and the decode step's device time by kind (``strided copies``:
   ring_sliced's column-slice copies), with the card's name and power
   limit;
13. the roofline cost model and the ``auto`` / ``auto-online`` policies (run
   after 12, on R1 1024's weights, mesh (1, 4), graphs): the prefill table
   and the decode tables at 1 and 2 rows under GB200 (1-byte weights, the
   JAX package's default), H100 and the per-logical-rank view of the card
   (bf16), with their residency-cache rows, must be ``AUTO_TABLES`` (the CPU
   test's); the servers resolve for the view. ``--policy auto`` and
   ``auto-online`` (switch interval 2) serve the 4 requests as in 12
   (``policy_serve``: every candidate table captured in warmup and none
   after, launches through the replays, peak under the card's 80 GB), each
   with the all-fetch serve's tokens and one decode step's logits bitwise;
   printed with their transitions, switches and resizes, prefill and decode
   replay ms, TTFT and TPOT p50, TPOT / replay, landed bytes per step and
   peak. Then the view's modeled decode step x G' beside the measured replay
   of every table phases 6, 12 and 13 served, their ratio and the pairs the
   model orders wrongly; and Figure 3's crossover and compute/prefetch at 1K
   and 8K under H100 and GB200, as model output;
14. the validated fetch and fault injection (run after 13, on R1 1024's
   weights, mesh (1, 4), graphs, one graph pool and one all-fetch context
   server for a generation server per table: demand, predictive and
   sync_free with an 8-row cache): a ``validate_fetch`` serve, then the
   plain and validated decode replays timed from 5's final state (cold
   predictor, alternated) and their difference, then the same server under
   ``FAULT_SPEC`` (drop, zero, corrupt and cache faults; a mirror drift
   under sync_free). Every serve: tokens and one decode step's logits from
   5's final state bitwise the all-fetch serve's, no capture after warmup,
   the fault counters consistent (detected >= injected, the per-source tail
   summing to detected); the validated serves' demand kernel launches
   measured through the decode replays; under the fault spec one eager
   step's injected counters recomputed from its masks, each mask drawn on
   the card equal to the same draw on the CPU. Then a storm of one bad peer
   under predictive decode with a ``HealthMonitor``: every ladder rung
   captured in warmup, the launches measured through every rung's replays,
   the ladder walked down to ``all`` and back, faults detected from that
   peer only. TPOT, fallbacks, counters, transitions and peak (under 70
   GB), beside the card's name and power limit;
15. the cluster model (run after 14; no kernel of its own, the launch counts
   must stay 0): the mirrored predictor (``core.traces.predictor_hit_rate``)
   replayed on the card over the R1 acceptance trace (Zipf 1.3, affinity
   0.8, 48 steps, E 256 over G' 4, budget 16: >= 0.9, the richer signals
   within 0.02 of hotness alone), a uniform trace (< 0.6) and the routed
   trace of 6's predictive serve (printed beside that serve's own
   ``predict_hit_rate`` and the traces' skew), each equal to the same
   replay on the CPU to 1e-6; R1's MoE-layer expert leaves of the engine
   (four shards of 64 experts, 22.55 GB), with the layer's experts of the
   weights' pinned host checkpoint (``checkpoint.convert.to_checkpoint``,
   28.14 GB) as ``source``, the dead position's shard filled with NaN (and
   written back from the checkpoint after), re-sharded for G' 4 -> 3
   (``prefetch.reshard_split_bank``): each new 86-row shard bitwise a fresh
   ``make_placement(256, 3)`` shard of ``source``, padding zeros, no NaN,
   rows by origin ``reshard_plan_rows(256, 4, 2)``, the wire (device to
   device) and source (host to device) copies timed with CUDA events beside
   ``rank_death_recovery`` on the card's view, peak under 70 GB; then model
   output under GB200: ``ClusterSimulator.degraded_table`` of full R1
   under predictive and sync_free fed the served trace's replayed hit rate
   and 14's re-run share, Table 5's ``pareto_sweep`` (DEP and DWDP context
   servers, 2 / 4 / 8 GPUs, 0.5-4 requests/s, 120 s) and DWDP's TPS/GPU
   over DEP's in the paper's band of 20-100 TPS/user, and two
   ``ModeledReplicaClient`` replicas that lose a rank mid-run and complete
   every request;
16. rank death on the live engine (run after 15, on R1 1024's weights and
   their checkpoint; it takes the last references to both, since the
   re-shard frees the old weights as the new land): a (2, 4) engine, graphs,
   the reference kill script's policy (``RD_POLICY``), row-local capacity,
   4 slots, serves 8 requests of 1024 tokens (16 out) through
   ``ServingScheduler`` over ``LiveReplicaClient`` in a one-replica
   ``MultiReplicaEngine`` uninterrupted; its generation server steps onto
   the ladder's ``"reshard"`` rung, which must replay the captured
   all-fetch variant with no capture and the all-fetch rung's decode
   logits bitwise; then the same requests again, rank 5 (data row 1) killed
   after 4 decode steps. The client's standby is a callable that, once
   ``kill_rank`` has released the dying engine's graphs, fills the dead
   shard with NaN, re-shards the weights in place for (2, 3)
   (``checkpoint.convert.reshard_params``: the survivors' expert rows on the
   card, the dead rank's from the pinned checkpoint; every other family
   split for three shards, the attention unsharded, the vocabulary, FFN
   widths and experts padded) and builds and warms a (2, 3) engine. One card
   holds no second R1 weight set beside a running engine, so the fleet is
   one replica and its migrants requeue. Checked: migrated + requeued = the
   active slots, every request at 16 tokens, the summary's recovery counts,
   the standby's expert shards bitwise fresh ``make_placement(256, 3)``
   shards of the checkpoint (zero padding, no NaN anywhere), its prefill and
   decode logits within LOGIT_TOL of the plain versions, the requeued
   requests served again on the standby alone bitwise, the launches through
   its replays (#2, #3, #6 and #7; not #4 or #5: its attention is
   unsharded; #6 on its mma path at the shared expert's 683 columns), no
   capture after the recovery, peak under the card's 80 GB. Printed: the
   recovery's parts (snapshots, the copies by kind with CUDA events, the
   other families, the standby's captures, the reported seconds beside
   ``rank_death_recovery`` on GB200 and the card's view), TTFT and TPOT p50
   on (2, 4) and on the standby, peak, the card's name and power limit.
   Kernels #2, #3, #6 and #7 are also held in 3 at the standby's per-rank
   shapes;
17. R1 1024 stored in e4m3 (run after 16, with every earlier weight set
   freed): weights (14.1 GB) and KV cache in e4m3 drawn on the card from a
   seeded generator, compute in bf16, phase 5's widths, depth, mesh and
   prompts; one graph pool and one all-fetch context server serve the four
   fetch modes (all, demand, predictive and sync_free with an 8-row
   cache) through graphs: warmup captures every variant and no serve
   captures after it; the all-fetch serve as in 5 (the launches of #2,
   #4-#7 measured through the replays, one prefill's and one decode
   step's logits within LOGIT_TOL of the plain versions on the same fp8
   weights, the prefill profiled), #3's launches measured through the
   route-before-gather decode replays; every launch of #2-#6 counted
   under the banks' dtype on its planned path (the fp8 paths); every mode's
   tokens the all-fetch serve's and one decode step from its state bitwise.
   Printed beside 5's and 6's bf16 figures of the same run: per mode TPOT
   p50, the decode step's replay ms and landed GB, the step's device time
   by kind; the serve's peak memory and TTFT p50; one prefill's profiled
   device ms (and its replay ms). Kernels #2-#6 are also held in 3 with
   e4m3 and e5m2 banks (#4-#6 at 2, 256 and 2048 rows, #4 at the q and k/v
   widths; #2 at C 1, 16 and 88; #3 at the demand and predictive decodes'
   fetched banks): within KERNEL_TOL of the plain version, bitwise the bf16
   kernel on the widened banks under the same plans, the plan printed and
   run (the Hopper path above 2 rows, the few-row path of #4-#6 at 2), a
   second launch bitwise, timed beside the plain version, the bf16 kernel
   on the widened banks and the bound at 1-byte weights (no library call:
   none multiplies bf16 by fp8);
18. the other architectures at full width (run after 10 and the Gemma-3
   fleet, with every earlier weight set freed; each with the launch counts
   set to 0 just before its serve and read just after):
   RecurrentGemma-2B at full depth (26 layers: 18 RG-LRU, 8 local attention
   at head dim 256), mesh (1, 4), graphs, 4 requests of 1024 tokens (the
   sequence sharded 256 a rank) and 16 output tokens, served as in 5 (#6
   and #7 launches measured through the replays, #7 on its hd-256 mma path,
   no capture after warmup, prefill and decode logits within LOGIT_TOL of
   the plain versions, peak printed); then 8 decode steps from the (1, 4)
   prefill's captured state (the RG-LRU fix-up's) against a (1, 1)
   unsharded prefill of the same prompt on the same weights: the same
   tokens, each step's logits within LOGIT_TOL. xLSTM-350M at full depth
   (24 layers; no kernel of the port on its path), 4 requests of 256
   tokens through graphs (no capture after warmup), the first 2 eagerly
   too (the same tokens), one prefill and one decode step in fp32 on the
   card against the same fp32 run on the CPU (FP32_LOGIT_TOL) and in bf16
   against the fp32 run (printed: bf16's own rounding over 24 layers,
   ~0.1 norm-wise, is no check), the prefill's wall time eager and
   replayed printed (the recurrences loop over tokens). Grok-1
   at 2 of its 64 layers (weights reckoned 22.90 GB), 4 requests of 1024
   tokens, all-fetch as in 5 (#2, #4, #5 and #7), then a demand engine on
   the same weights (#3 through its replays): the same tokens, one decode
   step from the all-fetch serve's state bitwise, landed GB per decode step
   and the replay ms printed. Phase 3 also holds #7 at head dim 256 at
   RecurrentGemma's prefill shards and #2 / #3 at Grok-1's per-rank expert
   shapes;
19. a ``{"kernels": [...]}`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

Needs a CUDA device and the repository's ``src/`` beside this file.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
KERNEL_TOL = 2e-2             # bf16, relative to max|ref| (tests/test_kernels.py TOL)
# The single wgmma tile: exact bf16 products summed in fp32 in another order.
TILE_TOL = 1e-5
# The kernels whose plan picks a path: split_hopper.cuh's Hopper path above
# 2 rows; at 2 rows or fewer its few-row path (#4-#6) or its Hopper path
# at BM 64 (#1-#3). Kernel -> (launches, path at 2 rows or fewer).
PLANNED = {"split_stack_gemm": (("stack",), "few_row"),
           "split_reduce_gemm": (("reduce",), "few_row"),
           "split_dense_swiglu": (("gate_up", "reduce"), "few_row"),
           "split_grouped_swiglu": (("gate_up", "down"), "hopper"),
           "split_grouped_swiglu_demand": (("gate_up", "down"), "hopper"),
           "split_grouped_gemm": (("gemm",), "hopper")}
GROUPED_KERNELS = ("split_grouped_swiglu", "split_grouped_swiglu_demand", "split_grouped_gemm")
# Kernel #1's bank types: bf16, and fp8 widened to bf16 on the chip (the
# kernel cases and the entry-point path run e4m3; the bitwise check both).
GEMM_WEIGHTS = ("bfloat16", "float8_e4m3fn")
FP8_WEIGHTS = ("float8_e4m3fn", "float8_e5m2")
# Phase 17: R1 1024 stored in this type (weights and KV cache), and the
# kernels whose every launch there must run its fp8 path (#2-#6)
FP8_MODEL = "float8_e4m3fn"
FP8_KERNELS = ("split_grouped_swiglu", "split_stack_gemm", "split_reduce_gemm",
               "split_dense_swiglu", "split_grouped_swiglu_demand")
# End to end through two bf16 layers the kernels and the plain versions
# round at different points (the kernels round h once after silu*mul in
# fp32, the plain versions after every product), and with random weights
# a router near-tie can send a token to another of the 256 experts, which
# moves its output by one expert's share (~1/8). One prefill's logits are
# held to a norm-wise bound: ||kernels - plain|| / ||plain|| <= 0.1.
LOGIT_TOL = 1e-1
# The same comparison in fp32 at the reduced DeepSeek-R1 width, where both
# sides round alike (tests/test_torch_model.py's 1e-4, relative to max|ref|).
FP32_LOGIT_TOL = 1e-4
# xLSTM-350M in bf16 against the same weights in fp32, norm-wise: both
# packages round the residual stream and every projection to bf16, and 24
# exponentially gated layers carry it to the logits. tests/xlstm_drift.py
# (the pattern and depth at d_model 256, 256-token prompts, 8 draws) reads
# the JAX package's own bf16 0.061-0.215 from its fp32, the port's
# 0.063-0.256; a decode step from a zeroed state (the prefill's state
# dropped) 1.06-1.35, which the limit must refuse (phase 18 checks both).
XLSTM_BF16_TOL = 0.5

G = 4                         # DWDP4: the model axis, G' = 4 logical ranks
PROMPT = 1024
OUTPUT = 16
MAX_BATCH = 2
N_REQUESTS = 4
GEOM = dict(shard_attention=True, expert_axes=("model",), moe_exec="gather")
# The kernels the all-fetch serving path launches.
ALL_FETCH_KERNELS = ("split_grouped_swiglu", "split_stack_gemm", "split_reduce_gemm",
                     "split_dense_swiglu", "flash_attention")
SPLIT_DECODE_KERNELS = ALL_FETCH_KERNELS[:4]  # decode attention is plain PyTorch
# The kernels DEP's own path launches: its tensor-parallel prefill
# attention runs flash attention; its decode runs none of the port's kernels
# (merged attention and the tensor-parallel FFN are jnp in the JAX package,
# its grouped expert FFN ``torch.bmm``). Served behind the reference's
# default pair, a DWDP context server, whose prefill launches every
# all-fetch kernel, the DEP serve must launch all of ALL_FETCH_KERNELS.
DEP_KERNELS = ("flash_attention",)
# The kernels a hybrid decode step runs: attention and the dense FFN as
# split banks (the experts take DEP's all-to-all).
HYBRID_KERNELS = ("split_stack_gemm", "split_reduce_gemm", "split_dense_swiglu")
# DeepSeek-R1 at the paper's input length (it evaluates 8K prompts): the
# same weights, 2 requests.
LONG_PROMPT = 8192
LONG_REQUESTS = 2
# Gemma-3-27B: every width kept, one 5 local : 1 global pattern of its 62
# layers; prompts of 4 windows. Dense: no expert kernels on its path.
GEMMA_LAYERS = 6
GEMMA_PROMPT = 4096
GEMMA_GEOM = dict(shard_attention=True, ffn_axes_override=("model",))
GEMMA_KERNELS = ("split_stack_gemm", "split_reduce_gemm", "split_dense_swiglu",
                 "flash_attention")
# The route-before-gather modes. Residency-cache rows per rank and MoE
# layer (88 MB each at R1 width): 8 keeps the all-fetch prefill's two
# remote banks plus the 4 ranks' caches under the 70 GB limit.
CACHE_BUDGET = 8
FETCH_MODES = (("demand", {}), ("predictive", {"cache_budget": CACHE_BUDGET}),
               ("sync_free", {"cache_budget": CACHE_BUDGET}))
PEAK_LIMIT = 70e9
# The serving layer: output lengths of the R1 1024 cell's 4 requests (unequal,
# so rolling admission refills a freed slot where epoch mode waits), and the
# two-replica Gemma-3 fleet's workload.
SERVING_LENS = (8, 16, 8, 16)
FLEET_REQUESTS = 6
FLEET_OSL = 8
# Kernel timing: TIME_WINDOWS windows of at least WINDOW_MS of back-to-back
# launches each; the median window is reported beside the fastest and the
# slowest.
TIME_WINDOWS = 5
WINDOW_MS = 40.0
# Mesh (data=2, model=4): eight logical ranks, two data replicas of the DWDP
# group of four, on R1 1024's weights (shared by the replicas); 4 decode
# slots, two per replica. The generation modes served there: DEP (the
# reference's default), DWDP all-fetch and DWDP demand.
MESH24 = (2, 4)
N_DP = MESH24[0] * MESH24[1]
MAX_BATCH24 = 4
DP_GEN = (("dep", "all"), ("dwdp", "all"), ("dwdp", "demand"))
# Gather policies on R1 1024 (mesh (1, 4), graphs): the merged layout (every
# shard, the resident one included, landed in one canonical buffer: the
# paper's §4.2 baseline), the ring transports, and the JAX package's MIXED
# table (tests/test_multidevice.py) against its COMPOSED one. A merged
# expert unit is a whole layer (256 x 3 x 7168 x 2048 x 2 B = 22.55 GB) and
# the bank pipeline keeps two alive: the merged serve's peak is held to the
# card's 80 GB (CARD_PEAK_LIMIT), not to PEAK_LIMIT, and recorded as the
# layout's cost. The roofline-resolved serves of phase 13 are held to it too.
MERGED = "merged:all:allgather"
SPLIT_TRANSPORTS = ("split:all:ring", "split:all:ring_sliced")
MERGED_SLICED = "merged:all:ring_sliced"
MIXED = {"moe_experts": "split:demand", "attn_qkv": "merged", "attn_out": "merged",
         "dense_ffn": "split:all:ring"}
COMPOSED = {"moe_experts": "split:all", "attn_qkv": "merged", "attn_out": "merged",
            "dense_ffn": "split:all:allgather"}
CARD_PEAK_LIMIT = 80e9
SWITCH_EVERY = 2
# The roofline-resolved policies (phase 13) on R1 1024, mesh (1, 4): the
# tables the resolver gives under each hardware entry at the weight bytes it
# is asked for (GB200: the JAX package's default, 1-byte weights; H100 and
# the per-logical-rank view of one card, "H100/4": bf16), as
# tests/test_torch_roofline.py pins them: entry -> (weight bytes, decode
# residency-cache rows, prefill table, decode table at 1 and at 2 rows). On
# the card the servers resolve for the view.
_SLICED = "split:all:ring_sliced"
_ALL_SLICED = {"default": "split:all:allgather", "moe_experts": _SLICED, "attn_qkv": _SLICED,
               "attn_out": _SLICED, "dense_ffn": _SLICED}
AUTO_TABLES = {
    "GB200": (1, 192, _ALL_SLICED,
              dict(_ALL_SLICED, moe_experts="split:predictive:ring_sliced:4:0:192")),
    "H100": (2, 192, _ALL_SLICED,
             dict(_ALL_SLICED, moe_experts="split:predictive:ring_sliced:4:0:192")),
    "H100/4": (2, 24, _ALL_SLICED, dict(_ALL_SLICED, moe_experts="split:demand:ring_sliced")),
}
# The kernels the view's decode table runs: demand-fetched experts, split
# attention and dense FFN.
AUTO_DECODE_KERNELS = ("split_grouped_swiglu_demand", "split_stack_gemm", "split_reduce_gemm",
                       "split_dense_swiglu")
AUTO_SWITCH_INTERVAL = 2
# Phase 14, the validated fetch: the faults injected into each table's serve
# (cache rot needs a residency cache; the mirror drift, sync_free), and the
# storm of one bad peer under predictive decode with a HealthMonitor.
# Payload rates low enough that about half the steps see no bad row in the
# last round (a bad one there runs the step again eagerly, ~0.13 s at R1).
FAULT_SPEC = "seed=3,drop=0.004,zero=0.002,corrupt=0.002,cache=0.1"
FAULT_MIRROR = ",mirror=0.15"
STORM_PEER = 2
STORM_SPEC = f"seed=7,peers={STORM_PEER}"
# Phase 15, the cluster model: the predictor replayed on the card over the R1
# acceptance trace (tests/test_syncfree.py:263: >= 0.9, the richer signals
# within 0.02 of hotness alone), a uniform trace (< 0.6) and the routed
# trace of the predictive serve, each against the same replay on the CPU
# (REPLAY_TOL); R1's MoE layer re-sharded from G' 4 to 3 with rank
# RESHARD_DEAD dead; and the simulator's model output under GB200.
ACCEPT_TRACE = dict(steps=48, rows=8, num_experts=256, top_k=8, alpha=1.3, affinity=0.8,
                    drift_every=24, seed=7)
UNIFORM_TRACE = dict(steps=32, rows=8, num_experts=256, top_k=8, alpha=0.0, affinity=0.0,
                     seed=7)
REPLAY_BUDGET = 16
REPLAY_TOL = 1e-6
RESHARD_DEAD = 2
# reshard_plan_rows(256, 4, 2): rows of each new shard by origin
RESHARD_ROWS = {"local": [64, 42, 64], "wire": [22, 0, 0], "source": [0, 44, 20]}
PAPER_TPS_USER = (20.0, 100.0)  # the paper's band of TPS/user (Table 5)
# Phase 16, rank death on the live engine: R1 1024's weights on (2, 4), 4
# decode slots (two per data replica), 8 requests; rank 5 (data row 1,
# model position 1) dies after 4 decode steps, so slots 2 and 3 lose their
# KV; the standby runs the survivors' mesh (2, 3). Row-local capacity keeps
# a request's tokens independent of its neighbours. The reference's kill
# script serves "split:predictive:allgather:4:4:8" (tests/test_rank_death.py):
# at R1 width its 4-row budget overflows on most decode steps, each then
# run again eagerly over the whole remote bank (31.5 GiB of landings on
# (2, 4)) beside its 8-row residency cache (5.6 GB) and the captured
# all-fetch variant of the reshard rung, and that does not fit the card's
# memory after the earlier phases; the demand fetch (auto budget) does.
RD_MESH = (2, 4)
RD_MESH_SURVIVORS = (2, 3)
RD_BATCH = 4
RD_ROWS = RD_BATCH // RD_MESH[0]  # decode rows of a data replica's ranks
RD_REQUESTS = 8
RD_DEAD = 5
RD_PRE_STEPS = 4
# Phase 18, the other architectures at full width: RecurrentGemma-2B at full
# depth (26 layers) over 1024-token prompts (the sequence sharded, 256
# tokens a rank; its local attention at head dim 256 runs #7's mma path),
# RG_CONTINUE decode steps of the (1, 4) prefill's captured state held
# against a (1, 1) unsharded prefill; xLSTM-350M at full depth (24 layers)
# over 256-token prompts; Grok-1 at 2 of its 64 layers over 1024-token
# prompts, all-fetch and demand.
RG_PROMPT = 1024
RG_KERNELS = ("split_dense_swiglu", "flash_attention")
RG_CONTINUE = 8
XLSTM_PROMPT = 256
XLSTM_EAGER = 2
GROK_LAYERS = 2
GROK_PROMPT = 1024
GROK_KERNELS = ("split_grouped_swiglu", "split_stack_gemm", "split_reduce_gemm",
                "flash_attention")
RD_POLICY = {"moe_experts": "split:demand"}
# The kernels of the standby's path: its attention is unsharded (16384 % 3),
# so #4 and #5 leave it for plain products, as in the JAX package.
RD_KERNELS = ("split_grouped_swiglu", "split_grouped_swiglu_demand", "split_dense_swiglu",
              "flash_attention")
RD_OFF_PATH = ("split_stack_gemm", "split_reduce_gemm")
# The degraded table's decode batch: 8 rows, the JAX package's R1 decode
# acceptance shape (64 routed draws < the 224 remote experts of G' 8, so the
# route-before-gather fetches engage; at the simulator's default 64 every
# rung would gather the whole bank)
DEGRADED_BATCH = 8
# The batch-sharded prefill compares its layouts in the no-drop regime: at
# factor 1.25 the expert capacity follows each rank's token count (a
# 256-token shard, a whole 1024-token row), so the two layouts drop
# different tokens; factor 4.0, as the reference's layout comparisons.
NO_DROP_FACTOR = 4.0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, warmup: int = 2) -> tuple[float, float, float]:
    """(median, fastest, slowest) ms per call of ``fn`` over TIME_WINDOWS
    windows timed with CUDA events; each window repeats ``fn`` enough
    times to last at least WINDOW_MS."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def window(reps: int) -> float:
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    reps = max(1, math.ceil(WINDOW_MS / max(window(1), 1e-3)))
    per_call = sorted(window(reps) for _ in range(TIME_WINDOWS))
    return per_call[TIME_WINDOWS // 2], per_call[0], per_call[-1]


def profile_step(label: str, fn) -> None:
    """Profile one call of ``fn``: device time by kind (the split kernels,
    the attention kernel, device-to-device copies of the landing banks,
    everything else) beside the host wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3  # includes the profiler's own cost
    kinds = {"split kernels": 0.0, "attention kernel": 0.0, "landing copies": 0.0,
             "strided copies": 0.0, "other device work": 0.0}
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = e.key
        kinds[kernel_kind(name)] += us / 1e3
        rows.append((us / 1e3, e.count, name[:70]))
    busy = sum(kinds.values())
    print(f"profile {label}: wall_ms_under_profiler {wall_ms:.2f} device_ms_sum {busy:.2f} "
          + " ".join(f"[{k}: {v:.2f} ms]" for k, v in kinds.items()))
    for ms, count, name in sorted(rows, reverse=True)[:8]:
        print(f"  {ms:9.3f} ms  x{count:<5d} {name}")
    return dict(kinds, device_ms=busy)


# A profiler trace of a graph replay has lacked a few kernel records, and
# has held a few twice: a replay and its eager step are traced again this
# many times before their kernels are held to differ.
TRACE_ATTEMPTS = 3
# The demangled names of the port's device kernels (its CUDA namespaces).
PORT_KERNEL = re.compile(r"^(void )?(split_hopper|split_tile|fa|hopper)::")


def kernel_kind(name: str) -> str:
    """A device kernel's kind in a profile, by its demangled name: the
    port's split kernels and its flash attention by their CUDA namespaces
    (a name alone would also match PyTorch's own ``at::native::
    reduce_kernel``), the landing copies (device-to-device copies of split
    banks and merged landings, row gathers of demand payloads), PyTorch's
    element-wise copies between strided tensors (``ring_sliced``'s column
    slices land so; other steps run few), and everything else."""
    port = PORT_KERNEL.match(name)
    if port:
        return "attention kernel" if port.group(2) == "fa" else "split kernels"
    if "Memcpy" in name or "memcpy" in name or "indexSelect" in name:
        return "landing copies"
    if "direct_copy_kernel" in name:
        return "strided copies"
    return "other device work"


def port_kernels(fn) -> collections.Counter:
    """The port's device kernels, by name and count, in a profiler trace of
    one call of ``fn``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return collections.Counter({e.key: e.count for e in prof.key_averages()
                                if e.device_type == DeviceType.CUDA and PORT_KERNEL.match(e.key)})


def replay_counts(engine) -> dict:
    """The replays so far of every cached step of both servers."""
    return {id(s): s.replays for srv in (engine.ctx, engine.gen) for s in srv.variants.steps()}


def replay_launches(label: str, engine, before: dict, servers=None,
                    kernel_free: bool = False) -> collections.Counter:
    """Each kernel's launches in the graph replays of ``servers`` (default:
    both) since ``before`` (:func:`replay_counts`), measured. For every step
    that replayed, one replay of its graph and one eager run of the step on
    the same inputs are traced: the port's device kernels, by name and
    count, must be the same in both, and the eager run's wrapper launches
    must equal what the capture recorded (``step.record``). A replay then
    launched each kernel as often as the record says, and the serve that
    record times the step's replays. A decode step may run none of the
    port's kernels under DEP, or with ``kernel_free`` (the merged layout's
    decode: plain products over its landings)."""
    from repro_torch import counters
    from repro_torch.kernels import registry

    total = collections.Counter({name: 0 for name in registry.KERNELS})
    for server in servers or (engine.ctx, engine.gen):
        for step in server.variants.steps():
            replays = step.replays - before.get(id(step), 0)
            if not replays:
                continue
            for attempt in range(TRACE_ATTEMPTS):
                replayed = port_kernels(step.graph.replay)
                with counters.recording() as ran:
                    eager = port_kernels(lambda: step.eager(engine.params))
                if replayed == eager:
                    break
                print(f"{label}: trace {attempt + 1} of a replay and its eager step disagree "
                      f"({sum(replayed.values())} against {sum(eager.values())} kernel records); "
                      "tracing both again")
            launched = {k[0]: n for k, n in ran.items() if k[0] in registry.KERNELS}
            recorded = {k[0]: n for k, n in step.record.items() if k[0] in registry.KERNELS}
            # DEP's decode is the one step that runs none of the port's kernels
            quiet = server.xp.phase == "decode" and (server.xp.mode == "dep" or kernel_free)
            if replayed != eager or not (replayed or quiet):
                fail(f"{label}: a replay ran other device kernels than the eager step: "
                     f"{dict(replayed)} vs {dict(eager)}")
            if launched != recorded:
                fail(f"{label}: the capture recorded {recorded} launches, the eager step "
                     f"made {launched}")
            for name, n in recorded.items():
                total[name] += n * replays
    return total


def check_launches(label: str, engine, measured: dict, counts: dict) -> None:
    """The host counters (each replay adding its capture's record) against
    the launches measured through the replays: equal where no step was
    run again eagerly, no fewer where some were."""
    eager_reruns = engine.ctx.fallbacks + engine.gen.fallbacks
    short = {k: (counts[k], n) for k, n in measured.items()
             if counts[k] < n or (counts[k] != n and not eager_reruns)}
    print(f"{label}: launches measured through the replays {json.dumps(measured)}; "
          f"host counters {json.dumps(counts)}; steps run again eagerly {eager_reruns}")
    if short:
        fail(f"{label}: host launch counters disagree with the replays (host, measured): {short}")


def logit_err(label: str, got, ref, tol: float = LOGIT_TOL) -> float:
    """Norm-wise relative error of two logit rows, held to ``tol``."""
    import torch

    got, ref = got.float(), ref.float()
    if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
        fail(f"{label}: non-finite logits")
    err = (torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref)).item()
    print(f"{label}: norm-wise rel err {err:.3e} (tol {tol}); argmax "
          f"{got.argmax(-1).tolist()} vs {ref.argmax(-1).tolist()}")
    if err > tol:
        fail(f"{label}: {err:.3e} > {tol}")
    return err


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# Per-kernel checks at the main-path shapes.
# --------------------------------------------------------------------------
def library_versions():
    """One per-bank torch.matmul/bmm composition per kernel: timed as a
    yardstick only, never called by the port."""
    import torch
    F = torch.nn.functional

    def stack(x, wl, wr):
        return torch.cat([torch.matmul(x, wl), torch.matmul(x, wr)], dim=0)

    def reduce(x, wl, wr):
        s_l = wl.shape[0]
        return torch.bmm(x[:s_l], wl).sum(0) + torch.bmm(x[s_l:], wr).sum(0)

    def dense(x, gl, ul, dl, gr, ur, dr):
        def part(g, u, d):
            h = F.silu(torch.matmul(x, g)) * torch.matmul(x, u)
            return torch.bmm(h, d).sum(0)
        return part(gl, ul, dl) + part(gr, ur, dr)

    def part(xe, g, u, d):
        return torch.bmm(F.silu(torch.bmm(xe, g)) * torch.bmm(xe, u), d)

    def grouped(x, gl, ul, dl, gr, ur, dr):
        e_l = gl.shape[0]
        return torch.cat([part(x[:e_l], gl, ul, dl), part(x[e_l:], gr, ur, dr)], dim=0)

    def demand(x, gl, ul, dl, gf, uf, df, valid):
        e_l = gl.shape[0]
        y_f = part(x[e_l:], gf, uf, df) * valid[:, None, None].to(x.dtype)
        return torch.cat([part(x[:e_l], gl, ul, dl), y_f], dim=0)

    def gemm(x, wl, wr):
        e_l = wl.shape[0]
        return torch.cat([torch.bmm(x[:e_l], wl), torch.bmm(x[e_l:], wr)], dim=0)

    return {"split_stack_gemm": stack, "split_reduce_gemm": reduce,
            "split_dense_swiglu": dense, "split_grouped_swiglu": grouped,
            "split_grouped_swiglu_demand": demand, "split_grouped_gemm": gemm}


def demand_fetched_rows(cfg) -> dict:
    """Fetched-bank rows the demand kernel gets at R1 decode, by fetch
    mode: demand lands 3 peers x the auto budget; predictive and sync-free
    land [cache | 3 peers x speculative | 3 peers x correction]."""
    from repro_torch.core.budget import demand_budget_rows, predictive_budget_rows

    draws, e = MAX_BATCH * cfg.moe.top_k, cfg.moe.num_experts
    spec, corr = predictive_budget_rows(draws, e, e // G)
    return {"decode": (G - 1) * demand_budget_rows(draws, e, e // G),
            "decode_predictive": CACHE_BUDGET + (G - 1) * (spec + corr)}


def kernel_cases(cfg, gemma):
    """(kernel, phase, shapes) at the per-rank main-path shapes (R1's, and
    Gemma-3's prefill for the dense kernels)."""
    from repro_torch.core.budget import demand_budget_rows
    from repro_torch.core.placement import make_placement
    from repro_torch.models.moe import capacity_for
    from repro_torch.models.transformer import ffn_pad

    d, a = cfg.d_model, G
    qd, kvd = cfg.q_dim // a, cfg.kv_dim // a
    fs = cfg.d_ff // G
    e, fe = cfg.moe.num_experts, cfg.moe.d_ff
    cases = []
    for phase, t, c in (("prefill", PROMPT // G, capacity_for(PROMPT // G, e, cfg.moe.top_k, 1.25)),
                        ("decode", MAX_BATCH, capacity_for(MAX_BATCH, e, cfg.moe.top_k, 1.25))):
        cases.append(("split_stack_gemm", phase, dict(t=t, d=d, f=qd, s=a)))
        cases.append(("split_stack_gemm", f"{phase}_kv", dict(t=t, d=d, f=kvd, s=a)))
        cases.append(("split_reduce_gemm", phase, dict(t=t, d=d, f=qd, s=a)))
        cases.append(("split_dense_swiglu", phase, dict(t=t, d=d, f=fs, s=G)))
        cases.append(("split_grouped_swiglu", phase, dict(c=c, d=d, f=fe, e=e, e_l=e // G)))
        cases += gemm_cases(phase, c, d, fe, e)
    # the demand kernel: 64 resident experts + the fetched bank of each
    # mode's decode (C 1, the few-row path), about half its rows valid, and
    # one tensor-core tile shape (C 16)
    rows = demand_fetched_rows(cfg)
    for phase, c, e_f in (("decode", 1, rows["decode"]),
                          ("decode_predictive", 1, rows["decode_predictive"]),
                          ("tile", 16, rows["decode"])):
        cases.append(("split_grouped_swiglu_demand", phase,
                      dict(c=c, d=d, f=fe, e_l=e // G, e_f=e_f)))
    # R1 at the paper's 8K prompt: 2048 rows per rank, the same widths;
    # the expert capacity of a 2048-token shard (88)
    t = LONG_PROMPT // G
    cases.append(("split_stack_gemm", "prefill_8192", dict(t=t, d=d, f=qd, s=a)))
    cases.append(("split_stack_gemm", "prefill_8192_kv", dict(t=t, d=d, f=kvd, s=a)))
    cases.append(("split_reduce_gemm", "prefill_8192", dict(t=t, d=d, f=qd, s=a)))
    cases.append(("split_dense_swiglu", "prefill_8192", dict(t=t, d=d, f=fs, s=G)))
    c = capacity_for(t, e, cfg.moe.top_k, 1.25)
    cases.append(("split_grouped_swiglu", "prefill_8192", dict(c=c, d=d, f=fe, e=e, e_l=e // G)))
    cases += gemm_cases("prefill_8192", c, d, fe, e)
    # mesh (2, 4): the context server's one-row prefill over 8 ranks (128
    # tokens each) and the batch-sharded prefill (a whole 1024-token row per
    # rank), at the expert capacity of those token counts
    for phase, t in (("prefill_mesh2x4", PROMPT // N_DP), ("prefill_batch_sharded", PROMPT)):
        c = capacity_for(t, e, cfg.moe.top_k, 1.25)
        cases += [("split_stack_gemm", phase, dict(t=t, d=d, f=qd, s=a)),
                  ("split_stack_gemm", f"{phase}_kv", dict(t=t, d=d, f=kvd, s=a)),
                  ("split_reduce_gemm", phase, dict(t=t, d=d, f=qd, s=a)),
                  ("split_dense_swiglu", phase, dict(t=t, d=d, f=fs, s=G)),
                  ("split_grouped_swiglu", phase, dict(c=c, d=d, f=fe, e=e, e_l=e // G))]
    # mesh (2, 3), the survivors of a rank death (phase 16): the context
    # prefill's 512-token halves (1024 % 3: the prompt shards over data
    # only), the decode rows of a data replica; 86 resident of the 258
    # padded experts, the dense FFN at 6144 and the shared expert at 683
    # columns a shard (683: #6's mma path), the demand decode's fetched bank
    # (two peers at the auto budget)
    g3 = RD_MESH_SURVIVORS[1]
    pl3 = make_placement(e, g3)
    t3 = PROMPT // RD_MESH_SURVIVORS[0]
    c3 = capacity_for(t3, e, cfg.moe.top_k, 1.25)
    rd = dict(e=pl3.num_padded, e_l=pl3.local_count)
    cases.append(("split_grouped_swiglu", "prefill_mesh2x3", dict(c=c3, d=d, f=fe, **rd)))
    cases.append(("split_grouped_swiglu_demand", "decode_mesh2x3", dict(
        c=RD_ROWS, d=d, f=fe, e_l=pl3.local_count, e_f=(g3 - 1) * demand_budget_rows(
            RD_ROWS * cfg.moe.top_k, e, pl3.local_count))))
    for phase, t in (("prefill_mesh2x3", t3), ("decode_mesh2x3", RD_ROWS)):
        for tail, f in (("", cfg.d_ff), ("_shared", cfg.moe.shared_d_ff)):
            cases.append(("split_dense_swiglu", phase + tail,
                          dict(t=t, d=d, f=ffn_pad(f, g3) // g3, s=g3)))
    # fp8-stored banks of #2-#6 (phase 17's weights), e4m3 and e5m2 (bf16
    # activations): #4-#6 at decode, R1 1024's and R1 8192's per-rank
    # prefill (2, 256 and 2048 rows), #4 also at the k/v width; #2 at C 1,
    # 16 and 88; #3 at the demand and predictive decodes' fetched banks
    for w in FP8_WEIGHTS:
        tag = w.split("_")[1]
        for phase, t in (("decode", MAX_BATCH), ("prefill", PROMPT // G),
                         ("prefill_8192", LONG_PROMPT // G)):
            cases += [("split_stack_gemm", f"{phase}_{tag}", dict(t=t, d=d, f=qd, s=a, weight=w)),
                      ("split_stack_gemm", f"{phase}_kv_{tag}",
                       dict(t=t, d=d, f=kvd, s=a, weight=w)),
                      ("split_reduce_gemm", f"{phase}_{tag}", dict(t=t, d=d, f=qd, s=a, weight=w)),
                      ("split_dense_swiglu", f"{phase}_{tag}", dict(t=t, d=d, f=fs, s=G, weight=w))]
        for phase, t in (("decode", MAX_BATCH), ("prefill", PROMPT // G),
                         ("prefill_8192", LONG_PROMPT // G)):
            c = capacity_for(t, e, cfg.moe.top_k, 1.25)
            cases.append(("split_grouped_swiglu", f"{phase}_{tag}",
                          dict(c=c, d=d, f=fe, e=e, e_l=e // G, weight=w)))
        for phase in ("decode", "decode_predictive"):
            cases.append(("split_grouped_swiglu_demand", f"{phase}_{tag}",
                          dict(c=1, d=d, f=fe, e_l=e // G, e_f=rows[phase], weight=w)))
    t, d = GEMMA_PROMPT // G, gemma.d_model
    for name, phase, f in (("split_stack_gemm", "gemma3_prefill", gemma.q_dim // G),
                           ("split_stack_gemm", "gemma3_prefill_kv", gemma.kv_dim // G),
                           ("split_reduce_gemm", "gemma3_prefill", gemma.q_dim // G),
                           ("split_dense_swiglu", "gemma3_prefill", gemma.d_ff // G)):
        cases.append((name, phase, dict(t=t, d=d, f=f, s=G)))
    return cases


def gemm_cases(phase, c, d, f, e) -> list:
    """Kernel #1 at expert capacity ``c`` with each of GEMM_WEIGHTS (the
    fp8 phases named ``<phase>_<type>``)."""
    return [("split_grouped_gemm", phase if w == "bfloat16" else f"{phase}_{w.split('_')[1]}",
             dict(c=c, d=d, f=f, e=e, e_l=e // G, weight=w)) for w in GEMM_WEIGHTS]


#: the bank operands of #2-#6 (the positions of their weight tensors)
BANK_ARGS = {"split_stack_gemm": (1, 2), "split_reduce_gemm": (1, 2),
             "split_dense_swiglu": range(1, 7), "split_grouped_swiglu": range(1, 7),
             "split_grouped_swiglu_demand": range(1, 7)}


def banks_fp8(name, shp, args):
    """A case of #2-#6 with ``shp["weight"]`` (an fp8 type): ``(args with
    the banks stored in it, args with those banks widened back to bf16)``;
    None for a bf16 case. The bf16 draws are dropped as they are cast."""
    import torch

    if "weight" not in shp:
        return None
    wdt, pos = getattr(torch, shp["weight"]), BANK_ARGS[name]
    args = list(args)
    for i in pos:
        args[i] = args[i].to(wdt)
    wide = list(args)
    for i in pos:
        wide[i] = args[i].to(torch.bfloat16)
    return tuple(args), tuple(wide)


def fp8_weight_elems(name, shp) -> int:
    """The bank elements a case of #2-#6 reads (the real experts' of #3)."""
    if name in ("split_stack_gemm", "split_reduce_gemm"):
        return shp["s"] * shp["d"] * shp["f"]
    if name == "split_dense_swiglu":
        return 3 * shp["s"] * shp["d"] * shp["f"]
    n = shp["e"] if name == "split_grouped_swiglu" else shp["e_l"] + shp["n_valid"]
    return 3 * n * shp["d"] * shp["f"]


def run_kernel_case(name, shp, gen):
    import torch
    from repro_torch.kernels.split_gemm import dense, grouped

    dev, bf = "cuda", torch.bfloat16
    widened = None

    def rnd(*shape, scale=0.05):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(bf)

    lib = library_versions()[name]
    if name == "split_stack_gemm":
        t, d, f, s = shp["t"], shp["d"], shp["f"], shp["s"]
        args = (rnd(t, d), rnd(1, d, f), rnd(s - 1, d, f))
        kern, plain = dense.split_stack_gemm, dense.split_stack_gemm_torch
        nbytes = 2 * (t * d + s * d * f + s * t * f)
        flops = 2 * s * t * d * f
    elif name == "split_reduce_gemm":
        t, d, f, s = shp["t"], shp["d"], shp["f"], shp["s"]
        args = (rnd(s, t, f), rnd(1, f, d), rnd(s - 1, f, d))
        kern, plain = dense.split_reduce_gemm, dense.split_reduce_gemm_torch
        nbytes = 2 * (s * t * f + s * f * d + t * d)
        flops = 2 * s * t * f * d
    elif name == "split_dense_swiglu":
        t, d, f, s = shp["t"], shp["d"], shp["f"], shp["s"]
        args = (rnd(t, d), rnd(1, d, f), rnd(1, d, f), rnd(1, f, d),
                rnd(s - 1, d, f), rnd(s - 1, d, f), rnd(s - 1, f, d))
        kern, plain = dense.split_dense_swiglu, dense.split_dense_swiglu_torch
        nbytes = 2 * (2 * t * d + 3 * s * d * f)
        flops = 6 * s * t * d * f
    elif name == "split_grouped_swiglu":
        c, d, f, e, e_l = shp["c"], shp["d"], shp["f"], shp["e"], shp["e_l"]
        args = (rnd(e, c, d, scale=1.0), rnd(e_l, d, f), rnd(e_l, d, f), rnd(e_l, f, d),
                rnd(e - e_l, d, f), rnd(e - e_l, d, f), rnd(e - e_l, f, d))
        kern, plain = grouped.split_grouped_swiglu, grouped.split_grouped_swiglu_torch
        nbytes = 2 * (2 * e * c * d + 3 * e * d * f)
        flops = 6 * e * c * d * f
    elif name == "split_grouped_gemm":
        c, d, f, e, e_l = shp["c"], shp["d"], shp["f"], shp["e"], shp["e_l"]
        wdt = getattr(torch, shp["weight"])
        args = (rnd(e, c, d, scale=1.0), rnd(e_l, d, f).to(wdt), rnd(e - e_l, d, f).to(wdt))
        kern, plain = grouped.split_grouped_gemm, grouped.split_grouped_gemm_torch
        # x read and y written in bf16, the banks at their stored width
        nbytes = 2 * (e * c * d + e * c * f) + wdt.itemsize * e * d * f
        flops = 2 * e * c * d * f
        if wdt != bf:
            # no PyTorch call multiplies bf16 by fp8 without quantizing the
            # activations: the bf16 kernel on the widened banks stands beside it
            lib = None
            widened = (args[0], args[1].to(bf), args[2].to(bf))
    else:
        c, d, f, e_l, e_f = shp["c"], shp["d"], shp["f"], shp["e_l"], shp["e_f"]
        valid = torch.arange(e_f, device=dev) % 2 == 0
        args = (rnd(e_l + e_f, c, d, scale=1.0), rnd(e_l, d, f), rnd(e_l, d, f), rnd(e_l, f, d),
                rnd(e_f, d, f), rnd(e_f, d, f), rnd(e_f, f, d), valid)
        kern = grouped.split_grouped_swiglu_demand
        plain = grouped.split_grouped_swiglu_demand_torch
        # this run's data: the real experts' rows and weights are read,
        # every output block is written
        n_real = e_l + int(valid.sum())
        shp = dict(shp, n_valid=int(valid.sum()))
        nbytes = 2 * (n_real * c * d + (e_l + e_f) * c * d + 3 * n_real * d * f)
        flops = 6 * n_real * c * d * f
    widened = banks_fp8(name, shp, args) if name != "split_grouped_gemm" else widened
    if widened is not None and name != "split_grouped_gemm":
        # the banks stored in fp8: read at 1 byte; no PyTorch call
        # multiplies bf16 by fp8 (the bf16 kernel on the widened banks is
        # timed beside it)
        args, widened = widened
        nbytes -= fp8_weight_elems(name, shp)
        lib = None
    plans = None
    if name in PLANNED:
        plans = {"split_stack_gemm": lambda: (dense.stack_plan(*args),),
                 "split_reduce_gemm": lambda: (dense.reduce_plan(*args),),
                 "split_dense_swiglu": lambda: dense.dense_swiglu_plans(*args),
                 "split_grouped_gemm": lambda: (grouped.gemm_plan(*args),),
                 }.get(name, lambda: grouped.grouped_swiglu_plans(*args[:7]))()
        counter = grouped.PATHS if name in GROUPED_KERNELS else dense.PATHS
        before = collections.Counter(counter)
    got = kern(*args)
    ran = None if plans is None else counter - before
    ref = plain(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite kernel output")
    abs_err = (got.float() - ref.float()).abs().max().item()
    rel_err = abs_err / max(ref.float().abs().max().item(), 1e-30)
    row = {"max_abs_err": abs_err, "max_rel_err": rel_err, "tol_rel": KERNEL_TOL}
    if plans is not None:
        row.update(check_plans(name, shp, plans, ran, torch.equal(kern(*args), got)))
    # #2-#6 with fp8 banks: the bf16 kernel on the widened banks under the
    # same plans (the few-row paths' k chunks follow the fp8 blocks' width)
    plan_kw = {} if plans is None or name == "split_grouped_gemm" else (
        {"plan": plans[0]} if name in ("split_stack_gemm", "split_reduce_gemm")
        else {"plans": plans})
    if widened is not None and plan_kw:
        row["bitwise_widened_bf16"] = torch.equal(kern(*widened, **plan_kw), got)
        if not row["bitwise_widened_bf16"]:
            fail(f"{name} {shp}: not bitwise the bf16 kernel on the widened banks")
    for key, fn in (("ms", kern), ("plain_ms", plain), ("library_ms", lib)):
        if fn is None:
            row[key] = row[f"{key}_range"] = None
            continue
        row[key], lo, hi = time_ms(lambda: fn(*args))
        row[f"{key}_range"] = [lo, hi]
    if widened is not None:
        row["widened_bf16_ms"], lo, hi = time_ms(lambda: kern(*widened, **plan_kw))
        row["widened_bf16_ms_range"] = [lo, hi]
        del widened
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
    row["shape"] = shp
    del args, got, ref
    torch.cuda.empty_cache()
    if rel_err > KERNEL_TOL:
        fail(f"{name} {shp}: kernel disagrees with its plain version: rel err {rel_err:.3e} > {KERNEL_TOL}")
    return row


def check_plans(name, shp, plans, ran, bitwise) -> dict:
    """Kernels #2-#6: the plan each launch ran (counted by the wrapper),
    which must be the Hopper path above 2 rows and the kernel's path at 2
    rows or fewer (PLANNED; bf16), or split_tile.cuh's mma path where a
    width is no multiple of 8 (#6 at the survivors' shared expert, 683
    columns), and a second launch bitwise equal to the first. ``ran``: the
    wrapper's path counts of the first launch."""
    from repro_torch.kernels.split_gemm import dense

    launches, few = PLANNED[name]
    rows = shp["c"] if "c" in shp else shp["t"]
    want = "hopper" if rows > dense.FEW_ROW_MAXM else few
    if shp["d"] % 8 or shp["f"] % 8:  # the tensor maps take no such width
        want = "mma"
    tail = (shp["weight"],) if "weight" in shp else ()  # #1 counts its banks' type
    out = {"bitwise_repeat": bitwise}
    for launch, plan in zip(launches, plans):
        n = ran[(name, launch, plan.path, dense.row_class(rows), *tail)]
        out[f"plan_{launch}"] = {"path": plan.path, "tile": list(plan.tile),
                                 "stages": plan.stages, "splits": plan.splits,
                                 "chunk": plan.chunk}
        if plan.path != want or n != 1:
            fail(f"{name} {shp}: {launch} launch ran {plan.path} ({n} counted), not {want}")
    if not bitwise:
        fail(f"{name} {shp}: a second launch gave other bits")
    return out


def path_counts() -> dict:
    """The launches of kernels #2-#6 by (kernel, launch, path, row class)
    and of flash attention by plan, as the wrappers counted them since the
    counters were cleared."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.split_gemm import dense, grouped

    paths = {"/".join(k): v for k, v in sorted((dense.PATHS + grouped.PATHS).items())}
    paths.update({f"flash_attention/{fa.plan_label(p)}": v for p, v in sorted(fa.PATHS.items())})
    return paths


def clear_path_counts() -> None:
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.split_gemm import dense, grouped

    for counter in (dense.PATHS, grouped.PATHS, fa.PATHS):
        counter.clear()


def check_paths(label: str, paths: dict, flash: str = "wgmma") -> None:
    """Every launch of #1-#6 above 2 rows ran the Hopper path, every one at
    2 rows or fewer its kernel's path (PLANNED), and every flash attention
    launch the path ``flash`` (``flash_plan``'s: the Hopper path at bf16 and
    hd 128, else "mma")."""
    bad = {}
    for key, n in paths.items():
        if key.startswith("flash_attention/"):
            if key.split("/")[1].split(" ")[0] != flash:
                bad[key] = n
            continue
        name, _, path, rows, *_ = key.split("/")
        if name in PLANNED and path != ("hopper" if rows == "rows>2" else PLANNED[name][1]):
            bad[key] = n
    if bad:
        fail(f"{label}: launches off their planned path: {bad}")


def check_hopper_tile(gen) -> float:
    """The prefill path's building blocks on one tile (one TMA load per
    operand, four wgmma m64n64k16 steps) against a plain fp32 product."""
    import torch
    from repro_torch.kernels.split_gemm import dense

    a = torch.randn(64, 64, generator=gen, device="cuda").to(torch.bfloat16)
    b = torch.randn(64, 64, generator=gen, device="cuda").to(torch.bfloat16)
    ref = a.float() @ b.float()
    err = ((dense.hopper_tile_check(a, b) - ref).abs().max() / ref.abs().max()).item()
    print(f"hopper single tile (64 x 64 x 64, TMA + wgmma) vs fp32 product: rel err {err:.3e} "
          f"(tol {TILE_TOL})")
    if err > TILE_TOL:
        fail(f"hopper single-tile check: rel err {err:.3e} > {TILE_TOL}")
    return err


def flash_cases(r1, gemma) -> list:
    """(phase, shape) of flash attention per logical rank at G' = 4: the
    prefill shards of R1's 1024-token prompt (first and last rank, on (1, 4)
    and on (2, 4), the two 512-token halves of the survivors' (2, 3), and a
    whole row of the batch-sharded prefill), R1's
    8192-token prompt (last rank), DEP's tensor-parallel prefill of R1's
    1024- and 8192-token prompts (the whole sequence, 32 of the 128 heads,
    2 of the 8 kv heads) and Gemma-3's 4096-token prompt (last rank, a local
    and a global layer)."""
    def case(cfg, prompt, rank, window):
        sq = prompt // G
        return dict(b=1, sq=sq, sk=prompt, h=cfg.num_heads, kh=cfg.num_kv_heads,
                    hd=cfg.head_dim, q_offset=rank * sq, window=window)

    def dep_tp(cfg, prompt):
        # DEP's tensor-parallel prefill: the whole sequence, the rank's heads
        return dict(b=1, sq=prompt, sk=prompt, h=cfg.num_heads // G,
                    kh=cfg.num_kv_heads // G, hd=cfg.head_dim, q_offset=0, window=0)

    def mesh24(rank):
        # the (2, 4) context prefill: 8 sequence shards of the 1024 tokens
        sq = PROMPT // N_DP
        return dict(b=1, sq=sq, sk=PROMPT, h=r1.num_heads, kh=r1.num_kv_heads,
                    hd=r1.head_dim, q_offset=rank * sq, window=0)

    def mesh23(row):
        # the survivors' (2, 3) context prefill: 1024 % 3, so the prompt
        # shards over data only, a 512-token half with every head per rank
        sq = PROMPT // RD_MESH_SURVIVORS[0]
        return dict(b=1, sq=sq, sk=PROMPT, h=r1.num_heads, kh=r1.num_kv_heads,
                    hd=r1.head_dim, q_offset=row * sq, window=0)

    return [("r1_1024_first", case(r1, PROMPT, 0, 0)),
            ("r1_1024_last", case(r1, PROMPT, G - 1, 0)),
            ("r1_1024_mesh2x4_first", mesh24(0)),
            ("r1_1024_mesh2x4_last", mesh24(N_DP - 1)),
            ("r1_1024_mesh2x3_first", mesh23(0)),
            ("r1_1024_mesh2x3_last", mesh23(RD_MESH_SURVIVORS[0] - 1)),
            # the batch-sharded prefill: a whole row per rank, every head
            ("r1_1024_batch_sharded", dict(b=1, sq=PROMPT, sk=PROMPT, h=r1.num_heads,
                                           kh=r1.num_kv_heads, hd=r1.head_dim, q_offset=0,
                                           window=0)),
            ("r1_8192_last", case(r1, LONG_PROMPT, G - 1, 0)),
            ("r1_1024_dep_tp", dep_tp(r1, PROMPT)),
            ("r1_8192_dep_tp", dep_tp(r1, LONG_PROMPT)),
            ("gemma3_4096_last_local", case(gemma, GEMMA_PROMPT, G - 1, gemma.window)),
            ("gemma3_4096_last_global", case(gemma, GEMMA_PROMPT, G - 1, 0)),
            # ragged: neither Sq nor Sk a multiple of 128, a window, an offset
            ("gemma3_ragged", dict(b=1, sq=1000, sk=3001, h=gemma.num_heads,
                                   kh=gemma.num_kv_heads, hd=gemma.head_dim, q_offset=2001,
                                   window=700))]


def visible_pairs(sq: int, sk: int, q_offset: int, window: int) -> int:
    """Query-key pairs the causal mask (and the window) leave visible."""
    n = 0
    for i in range(sq):
        p = q_offset + i
        lo = max(0, p - window + 1) if window else 0
        n += max(0, min(p, sk - 1) - lo + 1)
    return n


def visible_keys(sq: int, sk: int, q_offset: int, window: int) -> int:
    """Keys some query row sees: [q_offset - window + 1, q_offset + Sq),
    clipped to [0, Sk). The function never needs the others."""
    lo = max(0, q_offset - window + 1) if window else 0
    return max(0, min(q_offset + sq, sk) - lo)


def sdpa_version(q, k, v, window: int, q_offset: int):
    """One ``scaled_dot_product_attention`` call computing flash attention
    on (B, S, heads, hd) inputs (GQA, an explicit boolean mask for the
    offset and the window): a yardstick the port never calls. Returns a
    function of no arguments giving (B, H, Sq, hd)."""
    import torch

    sq, sk = q.shape[1], k.shape[1]
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = kpos <= qpos
    if window:
        mask &= qpos - kpos < window
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)


def run_flash_case(shp, gen) -> dict:
    """Flash attention against its plain version on the same bf16 inputs,
    timed beside the plain version and one ``scaled_dot_product_attention``
    call (``sdpa_version``). The error is held both over the whole output
    (max error over max|ref|) and per query row and head (the worst row's
    max error over that row's max|ref|): rows that see few keys have
    outputs far larger than rows that see many. The plan must be the
    Hopper path at hd 128 (bf16) and the mma path at hd 256 (RecurrentGemma's:
    ``flash_plan``), counted by the wrapper, and a second launch must give
    the same bits."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa

    b, sq, sk, h, kh, hd = (shp[k] for k in ("b", "sq", "sk", "h", "kh", "hd"))
    window, q_offset = shp["window"], shp["q_offset"]
    q, k, v = (torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)
               for s in ((b, sq, h, hd), (b, sk, kh, hd), (b, sk, kh, hd)))
    plan = fa.flash_plan(q.dtype, hd)

    def kern():
        return fa.flash_attention(q, k, v, window=window, q_offset=q_offset)

    def plain():
        return fa.flash_attention_torch(q, k, v, window=window, q_offset=q_offset)

    library = sdpa_version(q, k, v, window, q_offset)
    before = fa.PATHS[plan]
    got = kern()
    ran = fa.PATHS[plan] - before
    bitwise = torch.equal(kern(), got)
    ref = plain()
    lib = library().transpose(1, 2)
    torch.cuda.synchronize()
    want = "wgmma" if hd == 128 else "mma"  # the Hopper path at hd 128 only
    if plan.path != want or ran != 1:
        fail(f"flash_attention {shp}: ran {fa.plan_label(plan)} ({ran} counted), not {want}")
    if not bitwise:
        fail(f"flash_attention {shp}: a second launch gave other bits")
    if not torch.isfinite(got).all():
        fail(f"flash_attention {shp}: non-finite kernel output")
    ref_abs = ref.float().abs()
    scale = max(ref_abs.max().item(), 1e-30)
    row_scale = ref_abs.amax(-1).clamp_min(1e-30)
    diff = (got.float() - ref.float()).abs()
    abs_err = diff.max().item()
    rel_err = abs_err / scale
    row_err = (diff.amax(-1) / row_scale).max().item()
    lib_diff = (lib.float() - ref.float()).abs()
    row = {"max_abs_err": abs_err, "max_rel_err": rel_err, "max_row_rel_err": row_err,
           "tol_rel": KERNEL_TOL, "library_rel_err": lib_diff.max().item() / scale,
           "library_row_rel_err": (lib_diff.amax(-1) / row_scale).max().item(),
           "plan": plan._asdict(), "bitwise_repeat": bitwise}
    del got, ref, lib, ref_abs, row_scale, diff, lib_diff
    for key, fn in (("ms", kern), ("plain_ms", plain), ("library_ms", library)):
        row[key], lo, hi = time_ms(fn)
        row[f"{key}_range"] = [lo, hi]
    # bytes: q read and out written, k and v read over the visible keys only
    pairs = b * visible_pairs(sq, sk, q_offset, window)
    keys = visible_keys(sq, sk, q_offset, window)
    nbytes = 2 * (2 * b * sq * h * hd + 2 * b * keys * kh * hd)
    row["bound_ms"], row["bound_by"] = bound(nbytes, 4 * hd * h * pairs)
    row["shape"] = dict(shp, visible_pairs=pairs, visible_keys=keys)
    del q, k, v, library
    torch.cuda.empty_cache()
    if max(rel_err, row_err) > KERNEL_TOL:
        fail(f"flash_attention {shp}: kernel disagrees with its plain version: "
             f"rel err {rel_err:.3e}, worst row {row_err:.3e} > {KERNEL_TOL}")
    return row


def grouped_ffn_case(cfg, gen) -> dict:
    """DEP's grouped expert FFN (``models.moe.grouped_ffn``: three
    ``torch.bmm``, as the JAX package computes it in jnp, no kernel of the
    port) at DEP's decode shape on one owner rank: its 64 resident experts,
    each with the G' x C slots the all-to-all brings (2 rows at capacity 1,
    from each of the 4 ranks). A library row, timed beside its bound."""
    import torch
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.moe import capacity_for

    d, fe, e_l = cfg.d_model, cfg.moe.d_ff, cfg.moe.num_experts // G
    rows = G * capacity_for(MAX_BATCH, cfg.moe.num_experts, cfg.moe.top_k, 1.25)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    x = randn(e_l, rows, d)
    wg, wu, wd = randn(e_l, d, fe, scale=d ** -0.5), randn(e_l, d, fe, scale=d ** -0.5), randn(
        e_l, fe, d, scale=fe ** -0.5)
    y = moe_lib.grouped_ffn(x, wg, wu, wd)
    if not torch.isfinite(y).all():
        fail("grouped_ffn at DEP's decode shape: non-finite output")
    ms, lo, hi = time_ms(lambda: moe_lib.grouped_ffn(x, wg, wu, wd))
    nbytes = 2 * (3 * e_l * d * fe + 2 * e_l * rows * d)
    bound_ms, by = bound(nbytes, 2 * 3 * e_l * rows * d * fe)
    row = {"shape": dict(e_l=e_l, rows=rows, d=d, f=fe), "ms": ms, "ms_range": [lo, hi],
           "bound_ms": bound_ms, "bound_by": by}
    print(f"library grouped_ffn dep_decode {row['shape']}: ms {ms:.4f} [{lo:.4f}, {hi:.4f}] "
          f"bound_ms {bound_ms:.4f} ({by}), {bound_ms / ms:.1%} of the bound")
    del x, wg, wu, wd, y
    torch.cuda.empty_cache()
    return row


def check_demand_matches_grouped(cfg, gen) -> dict:
    """The demand kernel over a fetched bank that is a subset of kernel
    #2's remote bank, on the same rows: its padding rows are exact zeros
    and every real expert's block is bitwise kernel #2's (split_hopper.cuh's
    Hopper path at C 1 with each mode's fetched bank, at C 16 and at R1
    8192's C 88)."""
    import torch
    from repro_torch.kernels.split_gemm import grouped

    dev, bf = "cuda", torch.bfloat16
    d, f, e = cfg.d_model, cfg.moe.d_ff, cfg.moe.num_experts
    e_l = e // G
    rows = demand_fetched_rows(cfg)

    def rnd(*shape, scale=0.05):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(bf)

    wl = [rnd(e_l, d, f), rnd(e_l, d, f), rnd(e_l, f, d)]
    wr = [rnd(e - e_l, d, f), rnd(e - e_l, d, f), rnd(e - e_l, f, d)]
    out = {}
    for c, e_f in ((1, rows["decode"]), (16, rows["decode"]), (88, rows["decode"]),
                   (1, rows["decode_predictive"])):
        idx = torch.randperm(e - e_l, generator=gen, device=dev)[:e_f]
        wf = [w.index_select(0, idx) for w in wr]
        valid = torch.arange(e_f, device=dev) % 2 == 0
        x2 = rnd(e, c, d, scale=1.0)
        y2 = grouped.split_grouped_swiglu(x2, *wl, *wr)
        x3 = torch.cat([x2[:e_l], x2[e_l:].index_select(0, idx)])
        y3 = grouped.split_grouped_swiglu_demand(x3, *wl, *wf, valid)
        torch.cuda.synchronize()
        zeros = bool((y3[e_l:][~valid] == 0).all())
        same = torch.equal(y3[:e_l], y2[:e_l]) and torch.equal(
            y3[e_l:][valid], y2[e_l:].index_select(0, idx)[valid])
        print(f"kernel split_grouped_swiglu_demand C {c} E_f {e_f}: padding rows exact zeros {zeros}; "
              f"real experts bitwise split_grouped_swiglu's {same} ({e_l} local + "
              f"{int(valid.sum())} of {e_f} fetched rows)")
        if not (zeros and same):
            fail(f"demand kernel at C {c}, E_f {e_f}: zeros {zeros}, bitwise vs kernel #2 {same}")
        out[f"C{c}_Ef{e_f}"] = {"padding_zero": zeros, "bitwise_vs_split_grouped_swiglu": same}
        del wf
    del wl, wr
    torch.cuda.empty_cache()
    return out


def check_fp8_matches_widened(cfg, gen) -> dict:
    """Kernel #1 with e4m3 and e5m2 banks at R1's expert shapes, C 1, 16
    and 88: its result must be bitwise the bf16 kernel's on the widened
    banks (``w.to(bfloat16)``, exact) under the same block tile, since the
    widening is exact and the same tile bits meet the same wgmma sequence."""
    import torch
    from repro_torch.kernels.split_gemm import grouped

    bf = torch.bfloat16
    d, f, e = cfg.d_model, cfg.moe.d_ff, cfg.moe.num_experts
    e_l = e // G
    wl = (torch.randn(e_l, d, f, generator=gen, device="cuda") * 0.05).to(bf)
    wr = (torch.randn(e - e_l, d, f, generator=gen, device="cuda") * 0.05).to(bf)
    out = {}
    for wname in FP8_WEIGHTS:
        wdt = getattr(torch, wname)
        ql, qr = wl.to(wdt), wr.to(wdt)
        wide = (ql.to(bf), qr.to(bf))
        for c in (1, 16, 88):
            x = torch.randn(e, c, d, generator=gen, device="cuda").to(bf)
            p8, p16 = grouped.gemm_plan(x, ql, qr), grouped.gemm_plan(x, *wide)
            y8 = grouped.split_grouped_gemm(x, ql, qr)
            y16 = grouped.split_grouped_gemm(x, *wide)
            torch.cuda.synchronize()
            same = torch.equal(y8, y16)
            print(f"kernel split_grouped_gemm {wname} C {c}: bitwise the bf16 kernel on the "
                  f"widened banks {same} (tiles {list(p8.tile)} / {list(p16.tile)}, stages "
                  f"{p8.stages} / {p16.stages})")
            if p8.path != "hopper" or p8.tile != p16.tile:
                fail(f"split_grouped_gemm {wname} C {c}: plans {p8} / {p16}")
            if not same:
                err = (y8.float() - y16.float()).abs().max().item()
                fail(f"split_grouped_gemm {wname} C {c}: not bitwise the bf16 kernel on the "
                     f"widened banks (max diff {err})")
            out[f"{wname}_C{c}"] = same
        del ql, qr, wide
    del wl, wr
    torch.cuda.empty_cache()
    return out


def drive_split_gemm(cfg, gen) -> int:
    """Kernel #1's path: its entry point ``ops.split_gemm`` (no engine
    calls it) at R1 expert shapes, C 16 and C 1, with bf16 banks and then
    with e4m3 banks, with the launch counts set to 0 just before and read
    just after; every launch must have run the Hopper path."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.kernels.split_gemm import ops

    d, f, e = cfg.d_model, cfg.moe.d_ff, cfg.moe.num_experts
    e_l = e // G
    wl = (torch.randn(e_l, d, f, generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
    wr = (torch.randn(e - e_l, d, f, generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
    xs = {c: torch.randn(e, c, d, generator=gen, device="cuda").to(torch.bfloat16)
          for c in (16, 1)}
    banks = [(w, wl.to(getattr(torch, w)), wr.to(getattr(torch, w))) for w in GEMM_WEIGHTS]
    del wl, wr
    registry.reset_launch_counts()
    clear_path_counts()
    for wname, bl, br in banks:
        for c, x in xs.items():
            y = ops.split_gemm(x, bl, br)
            if y.shape != (e, c, f) or y.dtype != torch.bfloat16 or not torch.isfinite(y).all():
                fail(f"ops.split_gemm {wname} C {c}: bad output {tuple(y.shape)} {y.dtype}")
    torch.cuda.synchronize()
    counts = registry.launch_counts()
    paths = path_counts()
    print(f"ops.split_gemm path: launch counts {json.dumps(counts)} paths {json.dumps(paths)}")
    if counts["split_grouped_gemm"] <= 0:
        fail("split_grouped_gemm never launched on its entry point")
    check_paths("ops.split_gemm", paths)
    for wname, *_ in banks:
        if not any(k.startswith("split_grouped_gemm/gemm/hopper/") and k.endswith(wname)
                   for k in paths):
            fail(f"ops.split_gemm: no Hopper-path launch with {wname} banks")
    del banks, xs
    torch.cuda.empty_cache()
    return counts["split_grouped_gemm"]


# --------------------------------------------------------------------------
# Serving.
# --------------------------------------------------------------------------
def r1_two_layers():
    from repro_torch.configs import get_arch

    base = get_arch("deepseek-r1")
    return dataclasses.replace(
        base, num_layers=2, moe=dataclasses.replace(base.moe, first_dense=1)
    )


def gemma_six_layers():
    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch("gemma3-27b"), num_layers=GEMMA_LAYERS)


def free_memory() -> None:
    """Collect dropped engines and return their memory (graph pools
    included) to the card before the next engine."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def in_pool(engine):
    """Eager work in ``engine``'s graph pool (a context): the pool already
    holds the memory of the engine's largest step, which eager work outside
    it would need again. Outputs made there are cloned before the engine's
    next step."""
    import contextlib

    space = engine.gen.space
    return space.eager() if space is not None else contextlib.nullcontext()


def captures(engine) -> tuple:
    return engine.ctx.variants.captures(), engine.gen.variants.captures()


def serve_phase(label: str, cfg, engine, prompts, kernels, tables=(), peak_limit=PEAK_LIMIT,
                kernel_free: bool = False) -> tuple[dict, dict]:
    """Serve ``prompts`` on a fresh engine after its warmup (which captures
    every prefill bucket and decode variant), with the launch counts set to
    0 just before and read just after, and the launches measured through
    the replays (:func:`replay_launches`); every kernel in ``kernels`` must
    have launched, no variant may be captured after warmup, and the peak
    memory stays under ``peak_limit`` (``kernel_free``: the decode step may
    run none of the port's kernels, :func:`replay_launches`; every flash
    attention launch on the path ``flash_plan`` gives the model's head dim,
    :func:`check_paths`). Then one
    prefill's and one decode step's logits against the plain versions, and
    one profiled prefill, replayed and eager. Returns (numbers, outputs)."""
    import torch
    from repro_torch.core import execution
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_attention import ops as fa

    free_memory()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine.warmup(tables)
    warm = captures(engine)
    print(f"{label}: warmup {time.perf_counter() - t0:.2f} s, captures (ctx, gen) {warm}, "
          f"weights and pool {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
          f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved")
    registry.reset_launch_counts()
    clear_path_counts()
    replays = replay_counts(engine)
    t0 = time.perf_counter()
    outputs = serve(engine, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # read before the replays are traced: the horizon ends now
    summary = engine.metrics.summary(horizon=engine.horizon())
    counts = registry.launch_counts()
    paths = path_counts()
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    launches = replay_launches(label, engine, replays, kernel_free=kernel_free)
    check_launches(label, engine, launches, counts)
    for rec in sorted(engine.metrics.records, key=lambda r: r.req_id):
        print(f"{label} request {rec.req_id} ({rec.prompt_len} tokens): tokens "
              f"{outputs[rec.req_id]} ttft_s {rec.ttft:.4f} tpot_s {rec.tpot:.4f}")
    print(f"{label} serve: {json.dumps(summary)} wall_s {wall:.3f} peak_gb {peak / 1e9:.2f} "
          f"reserved_gb {reserved / 1e9:.2f} captures {captures(engine)} fallbacks (ctx, gen) "
          f"({engine.ctx.fallbacks}, {engine.gen.fallbacks}) overflowed layers "
          f"({engine.ctx.overflow_layers}, {engine.gen.overflow_layers}) launches "
          f"{json.dumps(launches)} paths of #2-#7 {json.dumps(paths)}")
    check_paths(label, paths, fa.flash_plan(engine.gen.model.compute_dtype, cfg.head_dim).path)
    if captures(engine) != warm:
        fail(f"{label}: serving captured new variants: {warm} after warmup, "
             f"{captures(engine)} after the serve")
    if summary["completed"] != len(prompts):
        fail(f"{label}: {summary['completed']} of {len(prompts)} requests completed")
    for rid, toks in outputs.items():
        if len(toks) != OUTPUT or not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"{label} request {rid}: bad tokens {toks}")
    missing = [k for k in kernels if launches[k] <= 0]
    if missing:
        fail(f"{label}: kernels never launched on the served path: {missing}")

    def prefill_logits(impl):
        return engine.ctx.forward(engine.params, prompts[0], impl=impl)["last_logits"].clone()

    def decode_logits(impl):
        gen = engine.gen
        ctx = execution.Ctx(model=gen.model, xp=gen.xp, impl=impl)
        with in_pool(engine):
            out = execution.forward_decode(engine.params, gen.cur_token, gen.state, ctx)
        return out["logits"].clone()

    # one prefill, and one decode step from the served state (both rows)
    errs = {}
    for step, run in (("prefill", prefill_logits), ("decode", decode_logits)):
        lk = run(None)[:, :cfg.vocab_size]
        lt = run("torch")[:, :cfg.vocab_size]
        errs[step] = logit_err(f"{label} {step} logits kernels vs plain", lk, lt)
        del lk, lt
    prof = profile_step(f"{label} prefill, graph replay",
                        lambda: engine.ctx.prefill(engine.params, prompts[0]))
    prof_eager = profile_step(f"{label} prefill, eager",
                              lambda: engine.ctx.forward(engine.params, prompts[0]))
    phase_peak = torch.cuda.max_memory_allocated()
    phase_reserved = torch.cuda.max_memory_reserved()
    print(f"{label}: peak over the phase (plain versions and profiles included) "
          f"{phase_peak / 1e9:.2f} GB allocated, {phase_reserved / 1e9:.2f} GB reserved")
    if phase_peak > peak_limit:
        fail(f"{label}: peak memory {phase_peak / 1e9:.2f} GB > {peak_limit / 1e9:.0f} GB")
    return {"summary": summary, "wall_s": wall, "peak_gb": peak / 1e9,
            "reserved_gb": reserved / 1e9, "fallbacks": engine.gen.fallbacks,
            "overflow_layers": engine.gen.overflow_layers, "phase_peak_gb": phase_peak / 1e9,
            "phase_reserved_gb": phase_reserved / 1e9, "captures": list(warm),
            "launches": launches, "host_launches": counts, "paths": paths,
            "logit_norm_err": errs,
            "profile_prefill_ms": prof, "profile_prefill_eager_ms": prof_eager}, outputs


def serve(engine, prompts) -> dict:
    from repro_torch.runtime.engine import Request

    for i, p in enumerate(prompts):
        engine.submit(Request(i, p, OUTPUT))
    steps = 0
    while engine.busy():
        engine.run(1)
        steps += 1
        if steps > N_REQUESTS * OUTPUT + 8:
            fail("serving did not finish")
    return {rid: list(toks) for rid, toks in engine.outputs.items()}


def check_isolation(label: str, cfg, engine, model, prompts) -> dict:
    """Request 0 served alone against served among the others, on fresh
    servers (captured into the engine's graph pool) with row-local capacity
    (``capacity_from="global"``): its tokens must be equal, and its first
    decode step's logits, beside request 1 or beside an empty slot, within
    LOGIT_TOL norm-wise. (With tied embeddings and random weights greedy
    tokens can repeat the prompt's last token whatever the context; the
    logits still carry it.)"""
    import torch
    from repro_torch.runtime.engine import ContextServer, DisaggregatedEngine, GenerationServer

    sizes = {"data": 1, "model": G}
    kw = dict(capacity_from="global", space=engine.gen.space)
    ctx = ContextServer(model, sizes, prefill_len=engine.ctx.prefill_len,
                        prefill_buckets=engine.ctx.prefill_lens,
                        cache_len=engine.ctx.cache_len, **kw)

    def gen_server():
        return GenerationServer(model, sizes, max_batch=MAX_BATCH,
                                cache_len=engine.gen.cache_len, **kw)

    among = serve(DisaggregatedEngine(engine.params, ctx, gen_server()), prompts)[0]
    alone = serve(DisaggregatedEngine(engine.params, ctx, gen_server()), prompts[:1])[0]

    def first_step_logits(batch):
        gen = gen_server()
        for slot, tokens in enumerate(batch):
            first, state = ctx.prefill(engine.params, tokens)
            gen.admit(slot, slot, first, state)
        out, _, _ = gen.step_outputs(engine.params)
        return out["logits"][0, :cfg.vocab_size].float().clone()

    l_alone, l_among = first_step_logits(prompts[:1]), first_step_logits(prompts[:2])
    bitwise = torch.equal(l_alone, l_among)
    print(f"{label} request 0 among {len(prompts)}: {among}\n{label} request 0 alone: {alone}")
    if among != alone:
        fail(f"{label}: a request served alone gave other tokens than served among the others")
    err = logit_err(f"{label} request 0 first decode step logits, alone vs beside request 1 "
                    f"(bitwise {bitwise})", l_alone, l_among)
    return {"tokens_equal": True, "first_step_logit_norm_err": err, "logits_bitwise": bitwise}


def kv_leaves(gen) -> list:
    """A generation server's position and KV ring tensors, in tree order."""
    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        if isinstance(tree, list):
            return [x for v in tree for x in leaves(v)]
        return [tree]

    return leaves({"pos": gen.state["pos"], "layers": gen.state["layers"]})


def snapshot(gen) -> dict:
    """A copy of a generation server's KV ring, positions and token row."""
    return {"state": [t.clone() for t in kv_leaves(gen)], "token": gen.cur_token.clone()}


def snapshot_step(label: str, engine, snap) -> dict:
    """One decode step from ``snap`` (the mode's own predictor state kept)
    through the server's step — the graph's replay, or the eager step —
    committing nothing: its logits (cloned), the bytes it landed, its
    device time by kind (profiled) and, for a graph, the replay's CUDA-event
    time (median of TIME_WINDOWS windows)."""
    import torch
    from repro_torch.core import prefetch

    gen = engine.gen
    for dst, src in zip(kv_leaves(gen), snap["state"], strict=True):
        dst.copy_(src)
    gen.cur_token.copy_(snap["token"])
    fallbacks = gen.fallbacks
    prefetch.LANDED.bytes = prefetch.LANDED.merge_bytes = 0
    out, _, _ = gen.step_outputs(engine.params)
    logits = out["logits"].clone()
    del out
    torch.cuda.synchronize()
    row = {"logits": logits, "landed_gb": prefetch.LANDED.bytes / 1e9,
           "landed_bytes": prefetch.LANDED.bytes, "merge_bytes": prefetch.LANDED.merge_bytes,
           "fell_back": gen.fallbacks > fallbacks,
           "profile_ms": profile_step(f"decode step, {label}",
                                      lambda: gen.step_outputs(engine.params))}
    if gen.space is not None:
        row["replay_ms"], lo, hi = time_ms(lambda: gen.step(engine.params))
        row["replay_ms_range"] = [lo, hi]
    return row


def switch_serve(engine, prompts, tables, every: int) -> dict:
    """Serve ``prompts`` again on a warmed engine, switching the decode
    policy to the next of ``tables`` every ``every`` steps."""
    from repro_torch.runtime.engine import Request

    for i, p in enumerate(prompts):
        engine.submit(Request(100 + i, p, OUTPUT))
    steps = switches = 0
    while engine.busy():
        if steps and steps % every == 0:
            switches += engine.gen.set_policy(tables[(steps // every - 1) % len(tables)])
        engine.run(1)
        steps += 1
    outs = {rid - 100: list(engine.outputs[rid]) for rid in range(100, 100 + len(prompts))}
    return {"outputs": outs, "switches": switches}


def serve_fetch_modes(cfg, params, prompts, ref_outputs, r1, snap, ref_step) -> dict:
    """Every fetch mode (all, demand, predictive, sync_free) on the all-fetch
    engine's weights, through graphs and eagerly (``graphs=False``): each
    serve's tokens must equal the all-fetch graph serve's, and one decode
    step from the same state (``snap``, with the mode's warm predictor) its
    logits bitwise. The graph serves take no capture after warmup; the
    demand one also serves the requests again switching demand <->
    predictive every 4 steps (both tables warmed) and must capture nothing
    and miss no variant. Then demand with a budget of 1 row per peer: its
    overflowing steps run again eagerly, counted, with the all-fetch tokens
    and logits. Returns per-mode numbers."""
    import numpy as np
    import torch
    from repro_torch.core import execution
    from repro_torch.core.strategy import PolicyTable
    from repro_torch.kernels import registry
    from repro_torch.launch.serve import build_engine

    ref_logits = ref_step.pop("logits")
    rows = {"all": {"graph": dict(r1_numbers(r1), **ref_step)}}
    predictive = PolicyTable.uniform(fetch="predictive", cache_budget=CACHE_BUDGET)
    demand = PolicyTable.uniform(fetch="demand")
    runs = [("all", {}, False)] + [(m, kw, g) for m, kw in FETCH_MODES for g in (True, False)]
    for mode, kw, graphs in runs + [("demand", {"demand_budget": 1}, True)]:
        forced = kw.get("demand_budget") == 1
        label = f"{mode}{' budget 1' if forced else ''} {'graph' if graphs else 'eager'}"
        free_memory()
        torch.cuda.reset_peak_memory_stats()
        eng, m_model = build_engine(
            cfg, mesh_shape=(1, G), prefill_len=PROMPT, prefill_buckets=(PROMPT // 2,),
            cache_len=PROMPT + OUTPUT, max_batch=MAX_BATCH, dtype=torch.bfloat16, device="cuda",
            params=params, geom_kwargs=GEOM, expert_fetch=mode, graphs=graphs, **kw,
        )
        if mode != "all" and not execution.demand_fetch_active(cfg, m_model.geom, eng.gen.xp):
            fail(f"expert_fetch={mode}: the decode plan does not run the demand path")
        switching = mode == "demand" and graphs and not forced
        eng.warmup((predictive,) if switching else ())
        warm = captures(eng)
        registry.reset_launch_counts()
        clear_path_counts()
        execution.DEMAND.layers = execution.DEMAND.fallbacks = 0
        replays = replay_counts(eng)
        t0 = time.perf_counter()
        outs = serve(eng, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        summ = eng.metrics.summary(horizon=eng.horizon())  # before any tracing
        counts = registry.launch_counts()
        paths = path_counts()
        demand_measured = None
        if graphs:
            # The demand kernel's launches in the decode replays. (An eager
            # prefill beside this engine's decode graphs does not fit on the
            # card; the R1 serves check the prefill replays.)
            measured = replay_launches(f"expert_fetch={label}", eng, replays, (eng.gen,))
            demand_measured = measured["split_grouped_swiglu_demand"]
            check_launches(f"expert_fetch={label}", eng,
                           {"split_grouped_swiglu_demand": demand_measured}, counts)
        check_paths(f"expert_fetch={label}", paths)
        layers, layer_fallbacks = execution.DEMAND.layers, execution.DEMAND.fallbacks
        peak = torch.cuda.max_memory_allocated()
        reserved = torch.cuda.max_memory_reserved()
        stats = np.sum(eng.gen.pred_stats, axis=0).tolist() if eng.gen.pred_stats else None
        step = snapshot_step(label, eng, snap)
        logits = step.pop("logits")
        budgets = {
            "demand_or_corr": execution.resolve_demand_budget(cfg, m_model.geom, eng.gen.xp),
            "spec": (execution.resolve_spec_budget(cfg, m_model.geom, eng.gen.xp)
                     if execution.predictive_fetch_active(cfg, m_model.geom, eng.gen.xp) else 0),
            "cache_rows": kw.get("cache_budget", 0),
        }
        row = {"budgets": budgets, "tpot_p50_s": summ["tpot_p50_s"],
               "tpot_p95_s": summ["tpot_p95_s"], "ttft_p50_s": summ["ttft_p50_s"],
               "mean_tps_user": summ["mean_tps_user"], "tps_per_gpu": summ["tps_per_gpu"],
               "wall_s": wall, "peak_gb": peak / 1e9, "reserved_gb": reserved / 1e9,
               "captures": list(captures(eng)), "fallbacks": eng.gen.fallbacks,
               "overflow_layers": eng.gen.overflow_layers,
               "ctx_fallbacks": eng.ctx.fallbacks, "demand_layers": layers,
               "layer_fallbacks": layer_fallbacks, "pred_stats_sum": stats,
               "launches": counts, "demand_launches_measured": demand_measured,
               "paths": paths, **step}
        bitwise = torch.equal(logits, ref_logits)
        print(f"fetch {label}: budgets {json.dumps(budgets)} tpot_p50_s {summ['tpot_p50_s']:.4f} "
              f"tpot_p95_s {summ['tpot_p95_s']:.4f} ttft_p50_s {summ['ttft_p50_s']:.4f} "
              f"wall_s {wall:.3f} peak_gb {peak / 1e9:.2f} reserved_gb {reserved / 1e9:.2f} "
              f"landed_gb_per_decode_step {step['landed_gb']:.3f} demand_layers {layers} "
              f"fallbacks (steps run again) {eng.gen.fallbacks} (prefills {eng.ctx.fallbacks}, "
              f"overflowed layers {eng.gen.overflow_layers}) "
              f"captures {captures(eng)} pred_stats_sum {stats} launches {json.dumps(counts)} "
              f"paths {json.dumps(paths)} tokens_equal_all {outs == ref_outputs} "
              f"logits_bitwise_all {bitwise}")
        if outs != ref_outputs:
            fail(f"expert_fetch={label}: tokens differ from the all-fetch tokens: "
                 f"{outs} vs {ref_outputs}")
        if not bitwise:
            err = (logits.float() - ref_logits.float()).abs().max().item()
            fail(f"expert_fetch={label}: decode logits not bitwise the all-fetch ones (max {err})")
        if captures(eng) != warm:
            fail(f"expert_fetch={label}: serving captured new variants ({warm} -> "
                 f"{captures(eng)})")
        if mode != "all" and counts["split_grouped_swiglu_demand"] <= 0:
            fail(f"expert_fetch={label}: split_grouped_swiglu_demand never launched")
        if forced and not (eng.gen.fallbacks > 0 and step["fell_back"]):
            fail(f"expert_fetch={label}: no decode step was run again after an overflow")
        if not forced and eng.gen.fallbacks:
            print(f"fetch {label}: {eng.gen.fallbacks} decode steps overflowed and ran again")
        if peak > PEAK_LIMIT:
            fail(f"expert_fetch={label}: peak memory {peak / 1e9:.2f} GB > "
                 f"{PEAK_LIMIT / 1e9:.0f} GB")
        if switching:
            misses = (eng.ctx.variants.stats["misses"], eng.gen.variants.stats["misses"])
            sw = switch_serve(eng, prompts, (predictive, demand), every=4)
            print(f"fetch {label}: serve switching demand <-> predictive every 4 steps: "
                  f"{sw['switches']} switches, tokens_equal_all {sw['outputs'] == ref_outputs}, "
                  f"captures {captures(eng)} (after warmup {warm}), misses (ctx, gen) "
                  f"{(eng.ctx.variants.stats['misses'], eng.gen.variants.stats['misses'])}")
            if sw["switches"] < 3:
                fail(f"policy switching: {sw['switches']} switches, want at least 3")
            if sw["outputs"] != ref_outputs:
                fail("policy switching: tokens differ from the all-fetch tokens")
            if captures(eng) != warm or misses != (eng.ctx.variants.stats["misses"],
                                                   eng.gen.variants.stats["misses"]):
                fail("policy switching captured or built a variant after warmup")
            row["switching"] = {"switches": sw["switches"], "captures": list(captures(eng))}
            row["predictive_trace"] = predictive_trace(
                "predictive trace (demand engine switched to predictive)", eng, prompts,
                ref_outputs, predictive)
            row["trace_bitmaps"] = row["predictive_trace"].pop("bitmaps")
        rows.setdefault(mode if not forced else "demand_budget_1", {})[
            "graph" if graphs else "eager"] = row
        del eng, m_model, logits
    for mode in ("all",) + tuple(m for m, _ in FETCH_MODES):
        g, e = rows[mode]["graph"], rows[mode]["eager"]
        g_dev = g.get("replay_ms") or g["profile_ms"]["device_ms"]
        e_dev = e["profile_ms"]["device_ms"]
        print(f"graph vs eager, fetch {mode} ({card_line()}): tpot_p50_s graph "
              f"{g['tpot_p50_s']:.4f} eager {e['tpot_p50_s']:.4f}; decode step device ms graph "
              f"replay {g_dev:.2f} (events {g.get('replay_ms_range')}) profiled "
              f"{g['profile_ms']['device_ms']:.2f} eager profiled {e_dev:.2f}; by kind graph "
              f"{json.dumps({k: round(v, 2) for k, v in g['profile_ms'].items()})} eager "
              f"{json.dumps({k: round(v, 2) for k, v in e['profile_ms'].items()})}; tpot / device "
              f"graph {g['tpot_p50_s'] * 1e3 / g_dev:.2f} eager "
              f"{e['tpot_p50_s'] * 1e3 / e_dev:.2f}; peak_gb graph {g['peak_gb']:.2f} eager "
              f"{e['peak_gb']:.2f}; reserved_gb graph {g['reserved_gb']:.2f} eager "
              f"{e['reserved_gb']:.2f}; landed_gb per step {g['landed_gb']:.3f} / "
              f"{e['landed_gb']:.3f}; fallbacks {g['fallbacks']} / {e['fallbacks']} (overflowed "
              f"layers {g['overflow_layers']} / {e['overflow_layers']})")
    free_memory()
    brief = {mode: {path: {k: v for k, v in row.items()
                           if k not in ("launches", "paths", "trace_bitmaps")}
                    for path, row in by_path.items()} for mode, by_path in rows.items()}
    print(f"fetch modes: {json.dumps(brief)}")
    return rows


# --------------------------------------------------------------------------
# Gather policies: the merged layout, the ring transports, mixed tables.
# --------------------------------------------------------------------------
def token_agreement(got: dict, ref: dict) -> float:
    """The share of equal tokens, position by position, of two serves."""
    pairs = [(a, b) for rid in ref for a, b in zip(got[rid], ref[rid])]
    return sum(a == b for a, b in pairs) / len(pairs)


def policy_serve(label: str, cfg, params, prompts, snap, policy, tables=(),
                 kernels=SPLIT_DECODE_KERNELS, peak_limit=PEAK_LIMIT, **engine_kw) -> dict:
    """``policy`` on both servers of an R1 1024 engine (graphs) on the
    shared weights: warmup (``tables`` too), the 4 requests served with
    nothing captured after warmup, the replays' launches of both servers
    measured (:func:`replay_launches`) and held against the host counters
    of the same serve (:func:`check_launches`), the decode replays' kernels
    exactly ``kernels`` (none: the step runs no kernel of the port), then
    one decode step from
    ``snap`` (:func:`snapshot_step`: logits, landed and merge bytes,
    profile, replay ms) and the 1024-token prefill's replay ms. ``engine_kw``
    goes to ``build_engine``. Returns the row with the serve's outputs, its
    summary, the step's logits and the engine."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.launch.serve import build_engine

    free_memory()
    torch.cuda.reset_peak_memory_stats()
    eng, _ = build_engine(
        cfg, mesh_shape=(1, G), prefill_len=PROMPT, prefill_buckets=(PROMPT // 2,),
        cache_len=PROMPT + OUTPUT, max_batch=MAX_BATCH, dtype=torch.bfloat16, device="cuda",
        params=params, geom_kwargs=GEOM, policy=policy, **engine_kw,
    )
    eng.warmup(tables)
    warm = captures(eng)
    registry.reset_launch_counts()
    replays = replay_counts(eng)
    outs = serve(eng, prompts)
    torch.cuda.synchronize()
    summ = eng.metrics.summary(horizon=eng.horizon())
    counts = registry.launch_counts()
    launches = replay_launches(label, eng, replays, kernel_free=not kernels)
    check_launches(label, eng, launches, counts)
    # the decode steps' kernels: their records, each checked by replay_launches
    decode = {k[0] for s in eng.gen.variants.steps() if s.replays > replays.get(id(s), 0)
              for k, n in s.record.items() if n and k[0] in registry.KERNELS}
    if decode != set(kernels):
        fail(f"{label}: the decode replays launched {sorted(decode)}, want {sorted(kernels)}")
    if captures(eng) != warm:
        fail(f"{label}: serving captured new variants ({warm} -> {captures(eng)})")
    peak = torch.cuda.max_memory_allocated()
    if peak > peak_limit:
        fail(f"{label}: peak memory {peak / 1e9:.2f} GB > {peak_limit / 1e9:.0f} GB")
    step = snapshot_step(label, eng, snap)
    eng.ctx.prefill(eng.params, prompts[0])  # installs the 1024-token bucket
    prefill_ms = time_ms(eng.ctx.step.graph.replay)
    row = dict(step, outputs=outs, tpot_p50_s=summ["tpot_p50_s"], ttft_p50_s=summ["ttft_p50_s"],
               peak_gb=peak / 1e9, fallbacks=eng.gen.fallbacks, captures=list(captures(eng)),
               launches=dict(launches), prefill_replay_ms=prefill_ms[0],
               policies=eng.gen.xp.policies.to_dict(), summary=summ, engine=eng)
    print(f"{label}: {eng.gen.xp.policies.describe()} tpot_p50_s {summ['tpot_p50_s']:.4f} "
          f"ttft_p50_s {summ['ttft_p50_s']:.4f} decode replay_ms {step.get('replay_ms', 0):.2f} "
          f"prefill replay_ms {prefill_ms[0]:.2f} landed_gb_per_decode_step "
          f"{step['landed_gb']:.3f} (merge copies {step['merge_bytes'] / 1e9:.3f}) peak_gb "
          f"{peak / 1e9:.2f} fallbacks {eng.gen.fallbacks} launches (replays of both servers) "
          f"{json.dumps(dict(launches))}, decode kernels {sorted(decode)} by kind {json.dumps(step['profile_ms'])}")
    return row


def policies_phase(cfg, params, prompts, ref_outputs, snap, ref_step, ref_logits, r1) -> dict:
    """The gather-policy space on R1 1024 against the split all-fetch serve
    (``ref_outputs``; one decode step ``ref_step`` from ``snap``, its logits
    ``ref_logits``; the serve ``r1``): the merged all-fetch serve
    (``serve_phase``: logits against the plain versions, flash attention in
    prefill only, no split kernel, the landed bytes per decode step exactly
    4/3 of split's, its peak under the card's memory); the split ring and ring_sliced serves, tokens and one
    decode step's logits bitwise the all-fetch serve's; merged ring_sliced
    bitwise merged allgather; MIXED bitwise COMPOSED; and a ring_sliced
    engine switched to allgather and back every SWITCH_EVERY steps, tokens
    as unswitched, no capture after warmup."""
    import torch
    from repro_torch.core.strategy import PolicyTable
    from repro_torch.kernels import registry
    from repro_torch.launch.serve import build_engine

    card = card_line()
    t_phase = time.perf_counter()
    rows = {}
    # ---- merged all-fetch ------------------------------------------------
    free_memory()
    eng, _ = build_engine(
        cfg, mesh_shape=(1, G), prefill_len=PROMPT, prefill_buckets=(PROMPT // 2,),
        cache_len=PROMPT + OUTPUT, max_batch=MAX_BATCH, dtype=torch.bfloat16, device="cuda",
        params=params, geom_kwargs=GEOM, policy=MERGED,
    )
    label = f"{cfg.name} {PROMPT} {MERGED}"
    merged, merged_outs = serve_phase(label, cfg, eng, prompts, ("flash_attention",),
                                      peak_limit=CARD_PEAK_LIMIT, kernel_free=True)
    split_runs = {k: n for k, n in merged["launches"].items() if n and k != "flash_attention"}
    decode_record = {k[0]: n for k, n in eng.gen.step.record.items() if k[0] in registry.KERNELS}
    if split_runs or decode_record:
        fail(f"{label}: split kernels launched {split_runs}, decode record {decode_record}")
    step = snapshot_step(label, eng, snap)
    eng.ctx.prefill(eng.params, prompts[0])
    prefill_ms = time_ms(eng.ctx.step.graph.replay)
    merged.update(step, outputs=merged_outs, prefill_replay_ms=prefill_ms[0])
    agree = token_agreement(merged_outs, ref_outputs)
    if 3 * step["landed_bytes"] != 4 * ref_step["landed_bytes"]:
        fail(f"{label}: landed {step['landed_bytes']} bytes per decode step, want 4/3 of "
             f"split's {ref_step['landed_bytes']}")
    if 4 * step["merge_bytes"] != step["landed_bytes"]:
        fail(f"{label}: merge copies {step['merge_bytes']} bytes, want 1/4 of "
             f"{step['landed_bytes']}")
    print(f"{label} ({card}): tokens agree with the split serve's at {agree:.4f} of positions "
          f"(bf16 router ties break differently); decode replay_ms {step['replay_ms']:.2f} "
          f"(split {ref_step['replay_ms']:.2f}) prefill replay_ms {prefill_ms[0]:.2f} "
          f"{prefill_ms[1:]} (split profiled {r1['profile_prefill_ms']['device_ms']:.2f}, "
          f"merged profiled {merged['profile_prefill_ms']['device_ms']:.2f}) landed_gb "
          f"{step['landed_gb']:.3f} (merge {step['merge_bytes'] / 1e9:.3f}; split "
          f"{ref_step['landed_gb']:.3f}) tpot_p50_s {merged['summary']['tpot_p50_s']:.4f} "
          f"(split {r1['summary']['tpot_p50_s']:.4f}) peak_gb {merged['peak_gb']:.2f} phase "
          f"{merged['phase_peak_gb']:.2f} (split {r1['peak_gb']:.2f}) by kind "
          f"{json.dumps(step['profile_ms'])}")
    merged["token_agreement"] = agree
    merged_logits = merged.pop("logits")
    rows[MERGED] = merged
    del eng
    # ---- transports ------------------------------------------------------
    runs = [(pol, ref_outputs, ref_logits, SPLIT_DECODE_KERNELS, PEAK_LIMIT)
            for pol in SPLIT_TRANSPORTS]
    runs.append((MERGED_SLICED, merged_outs, merged_logits, (), CARD_PEAK_LIMIT))
    for pol, want_outs, want_logits, kernels, limit in runs:
        tables = (PolicyTable.uniform(),) if pol == "split:all:ring_sliced" else ()
        row = policy_serve(f"{cfg.name} {PROMPT} {pol}", cfg, params, prompts, snap, pol,
                           tables, kernels, limit)
        eng = row.pop("engine")
        logits = row.pop("logits")
        bitwise = torch.equal(logits, want_logits) and row["outputs"] == want_outs
        print(f"policy {pol}: tokens and decode logits bitwise the allgather serve's {bitwise}")
        if not bitwise:
            fail(f"policy {pol}: not bitwise the allgather serve (tokens equal "
                 f"{row['outputs'] == want_outs})")
        if tables:
            misses = (eng.ctx.variants.stats["misses"], eng.gen.variants.stats["misses"])
            warm = captures(eng)
            sw = switch_serve(eng, prompts, (PolicyTable.uniform(), eng.gen.xp.policies),
                              every=SWITCH_EVERY)
            after = (eng.ctx.variants.stats["misses"], eng.gen.variants.stats["misses"])
            print(f"policy {pol}: serve switching allgather <-> ring_sliced every "
                  f"{SWITCH_EVERY} steps: {sw['switches']} switches, tokens equal the unswitched "
                  f"serve's {sw['outputs'] == want_outs}, captures {captures(eng)} (after warmup "
                  f"{warm}), misses {after} (before {misses})")
            if sw["switches"] < 3 or sw["outputs"] != want_outs:
                fail(f"policy switching allgather <-> ring_sliced: {sw['switches']} switches "
                     f"(want >= 3), tokens equal {sw['outputs'] == want_outs}")
            if captures(eng) != warm or after != misses:
                fail("policy switching allgather <-> ring_sliced captured or built a variant")
            row["switching"] = {"switches": sw["switches"], "captures": list(captures(eng))}
        row.pop("outputs")
        rows[pol] = row
        del eng, logits
    # ---- MIXED against COMPOSED -------------------------------------------
    pair = {}
    for name, table in (("mixed", MIXED), ("composed", COMPOSED)):
        kernels = ("split_grouped_swiglu_demand",) if name == "mixed" else ("split_grouped_swiglu",)
        row = policy_serve(f"{cfg.name} {PROMPT} {name}", cfg, params, prompts, snap, table,
                           kernels=kernels + ("split_dense_swiglu",))
        row.pop("engine")
        pair[name] = row
    mixed, composed = pair["mixed"], pair["composed"]
    bitwise = (torch.equal(mixed.pop("logits"), composed.pop("logits"))
               and mixed["outputs"] == composed["outputs"])
    print(f"policy MIXED vs COMPOSED ({card}): tokens and decode logits bitwise {bitwise}; "
          f"MIXED fallbacks {mixed['fallbacks']}; tokens agree with the split serve's at "
          f"{token_agreement(mixed['outputs'], ref_outputs):.4f}")
    if not bitwise:
        fail("policy MIXED: not bitwise its COMPOSED table")
    for name in pair:
        pair[name].pop("outputs")
    rows.update(pair)
    free_memory()
    brief = {k: {m: v for m, v in r.items() if m not in ("launches", "paths", "host_launches",
                                                          "outputs", "summary")}
             for k, r in rows.items()}
    print(f"policies ({card}; phase wall_s {time.perf_counter() - t_phase:.1f}): "
          f"{json.dumps(brief, default=str)}")
    return rows


# --------------------------------------------------------------------------
# The roofline cost model and the auto / auto-online policies.
# --------------------------------------------------------------------------
def served_tables(modes: dict, policy_rows: dict) -> dict:
    """Every decode table phases 6 and 12 served on R1 1024, with its
    measured decode replay ms: name -> (table, ms)."""
    from repro_torch.core.strategy import PolicyTable, resolve_policy

    out = {f"split {m}": (PolicyTable.uniform(fetch=m, cache_budget=dict(FETCH_MODES).get(
        m, {}).get("cache_budget", 0)), modes[m]["graph"]["replay_ms"])
        for m in ("all",) + tuple(dict(FETCH_MODES))}
    for name, spec in ((MERGED, MERGED), ("split:all:ring", "split:all:ring"),
                       ("split:all:ring_sliced", "split:all:ring_sliced"),
                       (MERGED_SLICED, MERGED_SLICED), ("mixed", MIXED), ("composed", COMPOSED)):
        out[name] = (resolve_policy(spec), policy_rows[name]["replay_ms"])
    return out


def auto_phase(cfg, params, prompts, ref_outputs, snap, ref_logits, served: dict) -> dict:
    """Phase 13, the roofline cost model (``core.roofline``) and the
    ``"auto"`` / ``"auto-online"`` policies on R1 1024's weights, mesh (1,
    4), graphs: the tables the resolver gives under GB200, H100 and the
    per-logical-rank view of the card (``AUTO_TABLES``, as the CPU test pins
    them); the ``auto`` and ``auto-online`` serves (``policy_serve``: every
    candidate captured in warmup, none after, launches through the replays,
    peak under the card's 80 GB), each bitwise the all-fetch serve's tokens
    and one decode step's logits, with their transitions; the view's
    modeled decode step x G' against the measured replay of every table
    ``served`` (and the auto one), with the pairs the model orders wrongly;
    and Figure 3 under H100 and GB200, as model output."""
    import itertools

    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.core import roofline, strategy
    from repro_torch.models.transformer import build_model

    card = card_line()
    t_phase = time.perf_counter()
    sizes = {"data": 1, "model": G}
    cache_len = PROMPT + OUTPUT
    model = build_model(cfg, sizes, dtype=torch.bfloat16, device="cuda", **GEOM)  # no weights
    view = roofline.card_view(G)
    if roofline.serving_target(model) != (view, 2):
        fail(f"auto: the servers resolve for {roofline.serving_target(model)}, want ({view}, 2)")
    prefill = InputShape("ctx", PROMPT, 1, "prefill")
    resolved = {}
    for hw in (roofline.GB200, roofline.H100, view):
        wb, cache, want_prefill, want_decode = AUTO_TABLES[hw.name]
        got = {"weight_bytes": wb, "prefill": strategy.resolve_policies(
            model, prefill, sizes, hw=hw, weight_bytes=wb).to_dict()}
        for rows in (1, MAX_BATCH):
            dec = InputShape("gen", cache_len, rows, "decode")
            got[f"decode_{rows}"] = strategy.resolve_policies(model, dec, sizes, hw=hw,
                                                              weight_bytes=wb).to_dict()
            got[f"cache_rows_{rows}"] = strategy._auto_cache_rows(model, dec, sizes, hw, wb)
        print(f"auto tables, model output under {hw.name} ({wb}-byte weights): {json.dumps(got)}")
        if got["prefill"] != want_prefill or any(
                got[f"decode_{r}"] != want_decode or got[f"cache_rows_{r}"] != cache
                for r in (1, MAX_BATCH)):
            fail(f"auto tables under {hw.name} differ from the pinned ones: {AUTO_TABLES[hw.name]}")
        resolved[hw.name] = got
    _, _, view_prefill, view_decode = AUTO_TABLES[view.name]

    rows = {}
    want_kernels = ALL_FETCH_KERNELS + ("split_grouped_swiglu_demand",)
    for policy in ("auto", "auto-online"):
        label = f"{cfg.name} {PROMPT} --policy {policy}"
        row = policy_serve(label, cfg, params, prompts, snap, policy,
                           kernels=AUTO_DECODE_KERNELS, peak_limit=CARD_PEAK_LIMIT,
                           switch_interval=AUTO_SWITCH_INTERVAL)
        eng, logits, summ = row.pop("engine"), row.pop("logits"), row.pop("summary")
        boot = strategy.resolve_policies(model, InputShape("gen", cache_len, MAX_BATCH, "decode"),
                                         sizes, hw=view, weight_bytes=2)
        tables = {boot.describe()}
        if eng.scheduler is not None:
            tables |= {t.describe() for t in eng.scheduler.candidate_tables(eng.gen)}
        transitions = summ.get("policy_transitions", [])
        switches, resizes = summ.get("policy_switches", 0), summ.get("budget_resizes", 0)
        bitwise = row["outputs"] == ref_outputs and torch.equal(logits, ref_logits)
        missing = [k for k in want_kernels if row["launches"].get(k, 0) <= 0]
        ratio = row["tpot_p50_s"] * 1e3 / row["replay_ms"]
        print(f"{label} ({card}): ctx table {eng.ctx.xp.policies.describe()} decode table "
              f"{eng.gen.xp.policies.describe()}; decode variants captured in warmup "
              f"{row['captures'][1]} (candidates {len(tables)}), after the serve the same; "
              f"transitions {json.dumps(transitions)} policy_switches {switches} budget_resizes "
              f"{resizes}; prefill replay_ms {row['prefill_replay_ms']:.2f} decode replay_ms "
              f"{row['replay_ms']:.2f} ttft_p50_s {row['ttft_p50_s']:.4f} tpot_p50_s "
              f"{row['tpot_p50_s']:.4f} tpot/replay {ratio:.3f} landed_gb_per_decode_step "
              f"{row['landed_gb']:.3f} peak_gb {row['peak_gb']:.2f}; tokens and decode logits "
              f"bitwise the all-fetch serve's {bitwise}")
        if eng.ctx.xp.policies.to_dict() != view_prefill:
            fail(f"{label}: the context server runs {eng.ctx.xp.policies.to_dict()}, want "
                 f"{view_prefill}")
        if not transitions and eng.gen.xp.policies.to_dict() != view_decode:
            fail(f"{label}: the generation server runs {eng.gen.xp.policies.to_dict()}, want "
                 f"{view_decode}")
        if row["captures"][1] != len(tables):
            fail(f"{label}: {row['captures'][1]} decode variants captured, want every candidate "
                 f"({len(tables)})")
        if not bitwise:
            fail(f"{label}: not bitwise the all-fetch serve (tokens equal "
                 f"{row['outputs'] == ref_outputs})")
        if missing:
            fail(f"{label}: kernels never launched in the replays: {missing}")
        row.pop("outputs")
        rows[policy] = dict(row, transitions=transitions, policy_switches=switches,
                            budget_resizes=resizes, tpot_over_replay=ratio,
                            candidates=len(tables))
        del eng, logits
        free_memory()

    # ---- the view's modeled decode step against the measured replays -------
    dec = InputShape("gen", cache_len, MAX_BATCH, "decode")
    tokens = strategy._engine_eligibility(model, dec, sizes).rows
    table_ms = dict(served, auto=(strategy.PolicyTable.from_dict(view_decode),
                                  rows["auto"]["replay_ms"]))
    compare = {}
    for name, (table, measured) in table_ms.items():
        eff = strategy.effective_policies(model, dec, sizes, table)
        modeled = G * 1e3 * roofline.modeled_step_time(
            cfg, tokens=tokens, group=G, hw=view, policies=eff, kv_len=cache_len,
            attn_gathered=bool(model.geom.attn_axes), weight_bytes=2)
        compare[name] = {"modeled_ms": modeled, "measured_ms": measured,
                         "measured_over_modeled": measured / modeled}
    wrong, ties = [], []
    for a, b in itertools.combinations(compare, 2):
        ma, mb = compare[a]["modeled_ms"], compare[b]["modeled_ms"]
        ra, rb = compare[a]["measured_ms"], compare[b]["measured_ms"]
        if ma == mb:
            ties.append([a, b])
        elif (ma < mb) != (ra < rb):
            wrong.append([a, b])
    print(f"modeled (model output, {view.name} x {G}, {tokens} rows per rank) against measured "
          f"decode replay ms ({card}): {json.dumps(compare)}; pairs the model orders wrongly "
          f"{json.dumps(wrong)}; pairs the model ties {json.dumps(ties)}")

    # ---- Figure 3 -----------------------------------------------------------
    figure3 = {}
    for hw in (roofline.H100, roofline.GB200):
        sweep = roofline.figure3_sweep(cfg, group=G, hw=hw, isls=(1024, 8192))
        figure3[hw.name] = {"crossover_isl": roofline.crossover_isl(cfg, group=G, hw=hw),
                            **{f"compute_to_prefetch_{r['isl']}": r["compute_to_prefetch"]
                               for r in sweep}}
        print(f"figure 3, model output under {hw.name} (R1, G' {G}, batch 1): "
              f"{json.dumps(figure3[hw.name])}")
    del model
    free_memory()
    print(f"auto ({card}; phase wall_s {time.perf_counter() - t_phase:.1f})")
    return {"tables": resolved, "serves": rows, "modeled_vs_measured": compare,
            "wrong_order": wrong, "figure3": figure3}


# --------------------------------------------------------------------------
# Faults: the validated fetch, fault injection, the degradation ladder.
# --------------------------------------------------------------------------
def restore(gen, snap) -> None:
    """``snap``'s KV ring, positions and token row into a generation
    server's state, in place."""
    for dst, src in zip(kv_leaves(gen), snap["state"], strict=True):
        dst.copy_(src)
    gen.cur_token.copy_(snap["token"])


def fault_counts(label: str, eng, snap, spec: str) -> dict:
    """One eager decode step from ``snap`` under ``spec`` with the
    injection sites logged (``Ctx.fault_log``): every logged mask drawn on
    the card must equal the same draw on the CPU (``faults.FaultInjector``
    keyed by the site, rank and step), and the step's injected counters
    must equal the counts recomputed from those masks over the valid rows;
    detected >= injected, and the per-source tail sums to detected."""
    import torch
    from repro_torch.core import execution, faults

    gen = eng.gen
    restore(gen, snap)
    log = []
    ctx = execution.Ctx(model=gen.model, xp=gen.xp, fault_log=log)
    with in_pool(eng):
        out = execution.forward_decode(eng.params, gen.cur_token, gen.state, ctx)
    got = out["fault_stats"].cpu().numpy()
    del out
    inj = faults.FaultInjector(faults.FaultSpec.parse(spec), gen.model.geom.moe_placement,
                               gen.xp.mesh_sizes)
    g = gen.model.geom.moe_placement.subgroup_size
    want = [0.0] * 4
    per_site: dict = {}
    for e in log:
        step, rank = int(e["step"]), e["rank"]
        key = inj.site_key(e["site"], step, rank)
        cpu = ((inj.cache_mask(key, e["budget"]),) if e["site"] == "cache" else
               inj.payload_masks(key, e["budget"], rank % g))
        if not all(torch.equal(a.cpu(), b) for a, b in zip(e["masks"], cpu)):
            fail(f"{label}: the {e['site']} masks of rank {rank} at step {step} on the card "
                 "differ from the same draws on the CPU")
        valid = e["valid"].cpu()
        if e["site"] == "cache":
            n = float((cpu[0] & valid).sum())
            want[3] += n
        else:
            n = 0.0
            for i in range(3):
                want[i] += float((cpu[i] & valid).sum())
                n += float((cpu[i] & valid).sum())
        site = per_site.setdefault(e["site"], [0.0, 0.0])
        site[0] += n
        site[1] += float(e["bad"].sum())
    injected = sum(want)
    print(f"{label}: one eager decode step from phase 5's state: {len(log)} injection sites, "
          f"masks on the card = the CPU's draws; injected {want} recomputed, counters "
          f"{got[:4].tolist()}, detected {got[4]} by source {got[7:].tolist()}, fault "
          f"fallbacks {got[5]} mirror divergence {got[6]}; (injected, detected) by site "
          f"{json.dumps(per_site)}")
    short = {k: v for k, v in per_site.items() if v[1] < v[0]}
    if short:
        fail(f"{label}: sites detected fewer rows than were injected: {short}")
    if got[:4].tolist() != want:
        fail(f"{label}: injected counters {got[:4].tolist()} != recomputed {want}")
    if got[4] < injected or abs(got[7:].sum() - got[4]) > 1e-6:
        fail(f"{label}: detected {got[4]} (by source {got[7:].tolist()}) vs injected {injected}")
    return {"sites": len(log), "injected": want, "stats": got.tolist()}


def fault_serve(label: str, cfg, eng, prompts, ref_outputs, snap, ref_logits, *,
                exclusions=None, trace: bool = True) -> dict:
    """Warm up, serve ``prompts`` with the launch counts set to 0 just
    before and read just after, and check: the tokens bitwise the all-fetch
    serve's, the decode replays' launches measured (``trace``; as in phase
    6: the demand kernel's host count no fewer than the replays'), nothing
    captured after warmup, the fault counters consistent (detected >=
    injected, the per-source tail summing to detected; checked by
    :func:`check_counters`), one decode step from ``snap`` bitwise the
    all-fetch logits."""
    import torch
    from repro_torch.kernels import registry

    eng.warmup(exclusions=exclusions)
    warm = captures(eng)
    registry.reset_launch_counts()
    replays = replay_counts(eng)
    falls, steps = eng.gen.fallbacks, eng.decode_steps
    outs = serve(eng, prompts)
    torch.cuda.synchronize()
    summ = eng.metrics.summary(horizon=eng.horizon())
    counts = registry.launch_counts()
    measured = {}
    if trace:
        measured = replay_launches(label, eng, replays, (eng.gen,))
        check_launches(label, eng, {"split_grouped_swiglu_demand":
                                    measured["split_grouped_swiglu_demand"]}, counts)
    fs = summ.get("faults", {})
    injected = sum(v for k, v in fs.items() if k.startswith("injected"))
    restore(eng.gen, snap)
    out, _, _ = eng.gen.step_outputs(eng.params)
    bitwise = outs == ref_outputs and torch.equal(out["logits"], ref_logits)
    del out
    row = {"tpot_p50_s": summ["tpot_p50_s"], "ttft_p50_s": summ["ttft_p50_s"],
           "fallbacks": eng.gen.fallbacks - falls, "fault_fallbacks": eng.gen.fault_fallbacks,
           "decode_steps": eng.decode_steps - steps,
           "faults": fs, "detected_by_peer": summ.get("detected_by_peer", []),
           "transitions": summ.get("policy_transitions", []), "captures": list(captures(eng)),
           "launches": dict(counts), "decode_launches_measured": dict(measured),
           "bitwise": bitwise}
    print(f"{label}: tpot_p50_s {summ['tpot_p50_s']:.4f} ttft_p50_s {summ['ttft_p50_s']:.4f} "
          f"steps run again {row['fallbacks']} (checksum {eng.gen.fault_fallbacks}) faults "
          f"of {row['decode_steps']} decode steps {json.dumps(fs)} detected_by_peer "
          f"{row['detected_by_peer']} transitions "
          f"{json.dumps([(t['step'], t['kind'], t['fetch']) for t in row['transitions']])} "
          f"captures {captures(eng)} (warmup {warm}) launches {json.dumps(counts)}; tokens and "
          f"decode logits bitwise the all-fetch serve's {bitwise}")
    if not bitwise:
        fail(f"{label}: not bitwise the all-fetch serve (tokens equal {outs == ref_outputs})")
    if captures(eng) != warm:
        fail(f"{label}: serving captured new variants ({warm} -> {captures(eng)})")
    if counts["split_grouped_swiglu_demand"] <= 0 and eng.gen.level == 0:
        fail(f"{label}: the demand kernel never launched")
    row["counters_consistent"] = not fs or (
        fs.get("detected", 0) >= injected
        and abs(sum(row["detected_by_peer"]) - fs["detected"]) <= 1e-6)
    if any(v < 0 for v in list(fs.values()) + row["detected_by_peer"]):
        fail(f"{label}: a negative fault counter")
    return row


def check_counters(label: str, row: dict) -> None:
    if not row["counters_consistent"]:
        fail(f"{label}: fault counters inconsistent: {row['faults']} by peer "
             f"{row['detected_by_peer']}")


def faults_phase(cfg, params, prompts, ref_outputs, snap, ref_logits) -> dict:
    """Phase 14, the validated fetch on R1 1024's weights, mesh (1, 4),
    graphs, one engine per table (demand, predictive and sync_free with an
    8-row cache): a ``validate_fetch`` serve, the plain and validated decode
    replays timed from phase 5's state (a cold predictor in both), then the
    same engine under ``FAULT_SPEC`` (plus a mirror drift under sync_free),
    its counters recomputed from the card's masks and the CPU's draws
    (:func:`fault_counts`); then a one-peer storm under predictive (no
    cache) with a ``HealthMonitor`` that must demote to the all-gather floor
    and promote back. Every serve through :func:`fault_serve`; peak memory
    under the 70 GB limit."""
    import torch
    from repro_torch.models.transformer import build_model
    from repro_torch.runtime.engine import (
        ContextServer,
        DisaggregatedEngine,
        GenerationServer,
        GraphSpace,
        HealthMonitor,
    )

    card = card_line()
    t_phase = time.perf_counter()
    rows: dict = {}
    sizes = {"data": 1, "model": G}
    model = build_model(cfg, sizes, dtype=torch.bfloat16, device="cuda", **GEOM)  # no weights
    # one graph pool and one all-fetch context server (its prefill runs no
    # route-before-gather layer at 1024 tokens, so no fault site) for every
    # generation server of the phase
    space = GraphSpace(model.device)
    ctx = ContextServer(model, sizes, prefill_len=PROMPT, prefill_buckets=(PROMPT // 2,),
                        cache_len=PROMPT + OUTPUT, space=space)

    def engine(health=None, **kw):
        gen = GenerationServer(model, sizes, max_batch=MAX_BATCH, cache_len=PROMPT + OUTPUT,
                               space=space, **kw)
        return DisaggregatedEngine(params, ctx, gen, health=health)

    def lap(what: str) -> None:
        print(f"faults: {what} at {time.perf_counter() - t_phase:.1f} s")

    for fetch, kw in FETCH_MODES:
        free_memory()
        torch.cuda.reset_peak_memory_stats()
        eng = engine(expert_fetch=fetch, validate_fetch=True, **kw)
        gen = eng.gen
        row = {"validated": fault_serve(f"faults {fetch} --validate-fetch", cfg, eng, prompts,
                                        ref_outputs, snap, ref_logits)}
        lap(f"{fetch} validated serve")
        if row["validated"]["faults"]:
            fail(f"faults {fetch}: a healthy validated serve detected faults")
        # the plain and validated decode replays from phase 5's state, with
        # a cold predictor in both (a fault switch starts the predictor cold)
        times = {}
        for name, validate in (("plain", False), ("validated", True), ("validated_2", True),
                               ("plain_2", False)):
            gen.set_faults(None, validate)
            gen.warmup(eng.params)
            restore(gen, snap)
            times[name] = time_ms(lambda: gen.step(eng.params))[0]
        plain = (times["plain"] + times["plain_2"]) / 2
        validated = (times["validated"] + times["validated_2"]) / 2
        row["replay_ms"] = dict(times, plain_mean=plain, validated_mean=validated,
                                checksum_ms=validated - plain)
        print(f"faults {fetch} ({card}): decode replay ms plain {times['plain']:.2f} / "
              f"{times['plain_2']:.2f}, validated {times['validated']:.2f} / "
              f"{times['validated_2']:.2f}; validated - plain {validated - plain:.2f} ms "
              f"({100 * (validated / plain - 1):.1f} %)")
        lap(f"{fetch} replay times")
        spec = FAULT_SPEC + (FAULT_MIRROR if fetch == "sync_free" else "")
        gen.set_faults(spec)
        # the fault variant runs the validated variant's kernels (traced
        # above) and the injector's PyTorch ops: its launches are the host's
        row["faults"] = fault_serve(f"faults {fetch} --fault-spec {spec}", cfg, eng, prompts,
                                    ref_outputs, snap, ref_logits, trace=False)
        row["counts"] = fault_counts(f"faults {fetch} --fault-spec {spec}", eng, snap, spec)
        check_counters(f"faults {fetch} --fault-spec {spec}", row["faults"])
        if not row["faults"]["faults"] or row["faults"]["fault_fallbacks"] <= 0:
            fail(f"faults {fetch}: the fault spec injected nothing or took no full gather")
        if fetch == "sync_free" and not row["faults"]["faults"].get("mirror_divergence"):
            fail("faults sync_free: no mirror divergence detected")
        row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"faults {fetch}: peak over the engine {row['peak_gb']:.2f} GB allocated")
        if row["peak_gb"] * 1e9 > PEAK_LIMIT:
            fail(f"faults {fetch}: peak memory {row['peak_gb']:.2f} GB > {PEAK_LIMIT / 1e9:.0f} GB")
        rows[fetch] = row
        lap(f"{fetch} faults serve")
        del eng, gen
    # ---- the storm: one bad peer, the HealthMonitor walks the ladder --------
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    eng = engine(expert_fetch="predictive", fault_spec=STORM_SPEC, health=HealthMonitor(min_dwell=1))
    ladder = [label for label, _, _ in eng.gen.ladder]
    # two requests, 15 decode steps: the walk down to "all" takes 6, the way
    # back 7 (decay 0.7, one step of dwell)
    storm = fault_serve(f"faults storm {STORM_SPEC} (ladder {ladder})", cfg, eng,
                        prompts[:MAX_BATCH], {i: ref_outputs[i] for i in range(MAX_BATCH)},
                        snap, ref_logits, exclusions=[(STORM_PEER,)])
    lap("storm serve")
    check_counters("faults storm", storm)
    kinds = [(t["kind"], t["fetch"]) for t in storm["transitions"]]
    storm["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    storm["decode_variants"] = len(eng.gen.variants)
    if ("demote", "all") not in kinds or not any(k == "promote" for k, _ in kinds):
        fail(f"faults storm: the ladder did not walk down to 'all' and back: {kinds}")
    if any(p != STORM_PEER and v for p, v in enumerate(storm["detected_by_peer"])):
        fail(f"faults storm: rows detected from other peers than {STORM_PEER}")
    if storm["peak_gb"] * 1e9 > PEAK_LIMIT:
        fail(f"faults storm: peak memory {storm['peak_gb']:.2f} GB > {PEAK_LIMIT / 1e9:.0f} GB")
    rows["storm"] = storm
    del eng, ctx, space, model
    free_memory()
    wall = time.perf_counter() - t_phase
    brief = {k: {"replay_ms": r["replay_ms"], "validated_tpot_p50_s": r["validated"]["tpot_p50_s"],
                 "faults_tpot_p50_s": r["faults"]["tpot_p50_s"], "peak_gb": r["peak_gb"]}
             for k, r in rows.items() if k != "storm"}
    brief["storm"] = {k: storm[k] for k in ("tpot_p50_s", "fallbacks", "faults", "peak_gb")}
    print(f"faults ({card}; phase wall_s {wall:.1f}): {json.dumps(brief)}")
    rows["wall_s"] = wall
    return rows


# --------------------------------------------------------------------------
# The cluster model: the predictor replayed, R1's banks re-sharded, the
# simulator's model output.
# --------------------------------------------------------------------------
def replay_both(label: str, trace, num_experts: int, **kw) -> dict:
    """``traces.predictor_hit_rate`` of ``trace`` on the card and on the CPU
    (G' = G, ``REPLAY_BUDGET``): equal to ``REPLAY_TOL``, finite."""
    import torch
    from repro_torch.core import traces

    row = {}
    for dev in ("cuda", "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        row[dev] = traces.predictor_hit_rate(trace, num_experts, G, budget=REPLAY_BUDGET,
                                             device=dev, **kw)
        row[f"{dev}_wall_s"] = time.perf_counter() - t0
    print(f"cluster: predictor replay {label} {tuple(trace.shape)} budget {REPLAY_BUDGET}"
          f"{' ' + json.dumps(kw) if kw else ''}: hit rate card {row['cuda']:.6f} cpu "
          f"{row['cpu']:.6f} (wall s {row['cuda_wall_s']:.3f} / {row['cpu_wall_s']:.3f})")
    if not all(math.isfinite(row[d]) for d in ("cuda", "cpu")):
        fail(f"cluster: predictor replay {label}: a hit rate is not finite")
    if abs(row["cuda"] - row["cpu"]) > REPLAY_TOL:
        fail(f"cluster: predictor replay {label}: card {row['cuda']} != cpu {row['cpu']}")
    return row


def checkpoint_copy(cfg, params) -> dict:
    """R1 1024's weights as the checkpoint a re-shard reads the dead rank's
    rows from: the JAX package's global tree (``checkpoint.convert.
    to_checkpoint`` of the (1, 4) weight set), in page-locked host memory
    where the host allows. Returns ``{"tree", "seconds", "pinned", "gb"}``."""
    import torch
    from repro_torch.checkpoint.convert import to_checkpoint
    from repro_torch.models.transformer import build_model

    model = build_model(cfg, {"data": 1, "model": G}, dtype=torch.bfloat16, device="cuda", **GEOM)
    t0 = time.perf_counter()
    try:
        tree, pinned = to_checkpoint(params, model, pin_memory=True), True
    except RuntimeError:
        tree, pinned = to_checkpoint(params, model), False
    seconds = time.perf_counter() - t0
    gb = sum(t.numel() * t.element_size() for t in tree_leaves(tree)) / 1e9
    print(f"checkpoint: {gb:.2f} GB of R1 1024's weights copied to the host in {seconds:.1f} s "
          f"(pinned {pinned})")
    return {"tree": tree, "seconds": seconds, "pinned": pinned, "gb": gb}


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def reshard_check(cfg, params, checkpoint: dict) -> dict:
    """R1's MoE-layer expert leaves at mesh (1, 4), as the engine holds them,
    re-sharded for G' 4 -> 3 with position ``RESHARD_DEAD`` dead
    (``prefetch.reshard_split_bank``): ``source`` is the layer's experts in
    the checkpoint's host copy (:func:`checkpoint_copy`), the dead shard is
    filled with NaN first; each new shard must be bitwise a fresh
    ``make_placement(256, 3)`` shard of ``source``, padding exact zeros, no
    NaN, its rows by origin ``RESHARD_ROWS``; the copies timed by kind with
    CUDA events beside ``roofline.rank_death_recovery`` (model output). The
    dead shard is then written back from the checkpoint."""
    import torch
    from repro_torch.core import prefetch, roofline
    from repro_torch.core.placement import make_placement

    e = cfg.moe.num_experts
    old, new = make_placement(e, G), make_placement(e, G - 1)
    groups = [(g, k) for g in params[0]["layers"] for k in params[0]["layers"][g]
              if "moe" in params[0]["layers"][g][k]]
    if len(groups) != 1:
        fail(f"cluster: re-shard: {len(groups)} MoE layers, want 1")
    g, k = groups[0]
    shards = [params[r]["layers"][g][k]["moe"]["experts"] for r in range(G)]
    leaf_bytes = {n: t[0].numel() * t.element_size() for n, t in shards[0].items()}
    per_expert = sum(leaf_bytes.values())
    source = checkpoint["tree"]["layers"][g][k]["moe"]["experts"]
    host_s, pinned = checkpoint["seconds"], checkpoint["pinned"]
    for leaf in shards[RESHARD_DEAD].values():
        leaf.fill_(float("nan"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events: dict = {}
    t0 = time.perf_counter()
    out = prefetch.reshard_split_bank(shards, old, new, RESHARD_DEAD, source, events=events)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = {kind: a.elapsed_time(b) for kind, (a, b) in events.items()}
    runs = prefetch.reshard_runs(old, new, RESHARD_DEAD)
    rows = {kind: [sum(b - a for kk, _, a, b in pos if kk == kind) for pos in runs]
            for kind in prefetch.RESHARD_KINDS}
    plan = roofline.reshard_plan_rows(e, G, RESHARD_DEAD)
    bitwise, nan, pad_zero = True, False, True
    for p, tree in enumerate(out):
        first, stop = p * new.local_count, min((p + 1) * new.local_count, e)
        for name, leaf in tree.items():
            if leaf.device.type != "cuda" or leaf.shape[0] != new.local_count:
                fail(f"cluster: re-shard: new shard {p} {name} {tuple(leaf.shape)} on {leaf.device}")
            want = torch.zeros_like(leaf)
            want[:stop - first].copy_(source[name][first:stop])
            bitwise &= torch.equal(leaf, want)
            nan |= bool(torch.isnan(leaf).any())
            pad_zero &= bool((leaf[stop - first:] == 0).all())
            del want
    copied = {kind: sum(rows[kind]) * per_expert for kind in rows}
    model = {wb: roofline.rank_death_recovery(cfg, group=G, hw=roofline.card_view(G),
                                              weight_bytes=wb)["seconds"] for wb in (1, 2)}
    row = {"rows": rows, "ms": ms, "bytes": copied, "wall_s": wall_s, "host_copy_s": host_s,
           "pinned": pinned, "peak_gb": peak_gb, "bitwise": bitwise, "nan": nan,
           "padding_zero": pad_zero, "model_seconds": model,
           "gb_per_s": {kind: copied[kind] / ms[kind] / 1e6 for kind in ms if ms[kind] > 0}}
    print(f"cluster: re-shard R1 MoE layer G' {G} -> {G - 1}, dead {RESHARD_DEAD} "
          f"({card_line()}): {e} experts x {per_expert / 1e6:.2f} MB, new shards of "
          f"{new.local_count} rows; rows by origin {json.dumps(rows)} (plan "
          f"{json.dumps({k: plan[k].tolist() for k in RESHARD_ROWS})}); copy ms by kind "
          f"{json.dumps({k: round(v, 3) for k, v in ms.items()})} GB/s "
          f"{json.dumps({k: round(v, 1) for k, v in row['gb_per_s'].items()})} (wire: device to "
          f"device, source: host to device, pinned {pinned}); call wall {wall_s:.3f} s, checkpoint "
          f"host copy {host_s:.1f} s; model output rank_death_recovery(group={G}, hw=card_view({G})) "
          f"seconds {model[1]:.6f} at 1-byte weights, {model[2]:.6f} at 2; bitwise fresh "
          f"shards {bitwise}, NaN {nan}, padding zero {pad_zero}, peak {peak_gb:.2f} GB")
    if rows != RESHARD_ROWS or any(plan[kk].tolist() != v for kk, v in RESHARD_ROWS.items()):
        fail(f"cluster: re-shard rows by origin {rows}, want {RESHARD_ROWS}")
    if not bitwise or nan or not pad_zero:
        fail(f"cluster: re-shard bitwise {bitwise} NaN {nan} padding zero {pad_zero}")
    if peak_gb * 1e9 > PEAK_LIMIT:
        fail(f"cluster: re-shard peak {peak_gb:.2f} GB > {PEAK_LIMIT / 1e9:.0f} GB")
    del out
    dead_rows = slice(RESHARD_DEAD * old.local_count, (RESHARD_DEAD + 1) * old.local_count)
    for name, leaf in shards[RESHARD_DEAD].items():
        leaf.copy_(source[name][dead_rows])
    return row


def table5_ratio(rows: list) -> dict:
    """DWDP's TPS/GPU over DEP's: each mode's best TPS/GPU among the points
    with TPS/user in ``PAPER_TPS_USER`` (None where the band holds no point),
    over the whole sweep, and at each (context GPUs, rate) point, with the
    sweep's range of TPS/user."""
    band, best = {}, {}
    for mode in ("dep", "dwdp"):
        pts = [r for r in rows if r["ctx_mode"] == mode and r["mean_tps_user"] is not None]
        best[mode] = max(r["tps_per_gpu"] for r in pts)
        band[mode] = max((r["tps_per_gpu"] for r in pts
                          if PAPER_TPS_USER[0] <= r["mean_tps_user"] <= PAPER_TPS_USER[1]),
                         default=None)
    dep = {(r["ctx_gpus"], r["rate"]): r for r in rows if r["ctx_mode"] == "dep"}
    per_point = {f"{r['ctx_gpus']}@{r['rate']}": r["tps_per_gpu"] / dep[(r["ctx_gpus"], r["rate"])][
        "tps_per_gpu"] for r in rows if r["ctx_mode"] == "dwdp"}
    users = [r["mean_tps_user"] for r in rows if r["mean_tps_user"] is not None]
    return {"in_band": band, "in_band_dwdp_over_dep": (band["dwdp"] / band["dep"]
                                                       if band["dep"] and band["dwdp"] else None),
            "best": best, "best_dwdp_over_dep": best["dwdp"] / best["dep"],
            "per_point_dwdp_over_dep": per_point, "tps_user_range": [min(users), max(users)]}


def modeled_fleet() -> dict:
    """Two ``ModeledReplicaClient`` replicas of full R1 (2 context and 8
    generation GPUs each, sync-free decode, GB200): rank 0 of replica 0 is
    killed after 8 steps of each; every submitted request must complete."""
    from repro_torch.configs import get_arch
    from repro_torch.runtime.serving import (
        ModeledReplicaClient, MultiReplicaEngine, ServingScheduler, WorkloadConfig,
        synthesize_workload,
    )
    from repro_torch.runtime.simulator import SimConfig

    cfg = get_arch("deepseek-r1")
    scheds = [ServingScheduler(ModeledReplicaClient(SimConfig(
        cfg=cfg, ctx_gpus=2, gen_gpus=8, gen_mode="dwdp", expert_fetch="sync_free",
        cache_budget=CACHE_BUDGET, gen_batch=8, isl_max=8192, osl=1024), num_slots=8))
        for _ in range(2)]
    fleet = MultiReplicaEngine(scheds)
    n = 16
    fleet.submit(synthesize_workload(WorkloadConfig(num_requests=n, isl_buckets=(4096, 8192),
                                                    osl=64, seed=5)))
    for _ in range(8):
        for s in fleet.schedulers:
            s.step()
    active = fleet.schedulers[0].active_count()
    report = fleet.kill_rank(0, 0)
    summary = fleet.run().summary(fleet.horizon())
    print(f"cluster: modeled fleet (model output, GB200): 2 replicas of R1, rank 0 of replica 0 "
          f"killed with {active} active: {json.dumps(report)}; summary "
          f"{summary_line(summary)} rank_deaths {summary['rank_deaths']} migrated "
          f"{summary['migrated']} requeued {summary['requeued']} time_to_recover_p50_s "
          f"{summary['time_to_recover_p50_s']}")
    if summary["completed"] != n or summary["rank_deaths"] != 1 or active <= 0:
        fail(f"cluster: modeled fleet completed {summary['completed']} of {n} after the kill "
             f"({summary['rank_deaths']} rank deaths, {active} active)")
    return {"report": report, "summary": summary}


def cluster_phase(cfg, params, bitmaps, served_summary: dict, fault_rows: dict,
                  checkpoint: dict) -> dict:
    """Phase 15, the cluster model (run after 14, on R1 1024's weights; it
    launches no kernel of its own, checked by the launch counts): the
    predictor replayed on the card over the R1 acceptance trace, a uniform
    trace and the predictive serve's routed trace (``bitmaps``), each
    beside the CPU's replay; R1's expert banks re-sharded (``params``' MoE
    leaves, the dead shard poisoned and then restored from ``checkpoint``,
    :func:`checkpoint_copy`); then model output under
    GB200: ``degraded_table`` of full R1 under predictive and sync_free fed
    the served trace's replayed hit rate and phase 14's re-run share,
    Table 5's sweep and the DWDP / DEP ratio, and a modeled fleet that
    loses a rank."""
    from repro_torch.configs import get_arch
    from repro_torch.core import traces
    from repro_torch.kernels import registry
    from repro_torch.runtime.simulator import ClusterSimulator, SimConfig, pareto_sweep

    card = card_line()
    t_phase = time.perf_counter()
    registry.reset_launch_counts()
    e = cfg.moe.num_experts
    accept = traces.zipf_routing_trace(*[ACCEPT_TRACE[k] for k in ("steps", "rows", "num_experts",
                                                                  "top_k")],
                                       **{k: ACCEPT_TRACE[k] for k in ("alpha", "affinity",
                                                                       "drift_every", "seed")})
    rich = replay_both("R1 acceptance (rich)", accept, e)
    plain = replay_both("R1 acceptance (plain)", accept, e, rich=False)
    uniform = replay_both("uniform", traces.zipf_routing_trace(
        *[UNIFORM_TRACE[k] for k in ("steps", "rows", "num_experts", "top_k")],
        **{k: UNIFORM_TRACE[k] for k in ("alpha", "affinity", "seed")}), e)
    served_trace = traces.from_served_trace(bitmaps, top_k=cfg.moe.top_k)
    served = replay_both("served (predictive serve's routed trace)", served_trace, e)
    skew = {"accept": traces.trace_skew(accept, e), "served": traces.trace_skew(served_trace, e),
            "uniform": traces.trace_skew(traces.zipf_routing_trace(
                *[UNIFORM_TRACE[k] for k in ("steps", "rows", "num_experts", "top_k")],
                **{k: UNIFORM_TRACE[k] for k in ("alpha", "affinity", "seed")}), e)}
    print(f"cluster: served trace {tuple(bitmaps.shape)} -> {tuple(served_trace.shape)}: replayed "
          f"hit rate {served['cuda']:.6f} beside the serve's own predict_hit_rate "
          f"{served_summary.get('predict_hit_rate')} (spec {served_summary.get('spec_hit_rate')}, "
          f"cache {served_summary.get('cache_hit_rate')}); trace_skew served {skew['served']:.4f} "
          f"acceptance {skew['accept']:.4f} uniform {skew['uniform']:.4f}")
    if rich["cuda"] < 0.9 or rich["cuda"] < plain["cuda"] - 0.02:
        fail(f"cluster: acceptance hit rate {rich['cuda']:.4f} (plain {plain['cuda']:.4f})")
    if uniform["cuda"] >= 0.6:
        fail(f"cluster: uniform trace hit rate {uniform['cuda']:.4f} >= 0.6")
    reshard = reshard_check(cfg, params, checkpoint)

    # ---- model output (GB200) ----------------------------------------------
    r1 = get_arch("deepseek-r1")
    degraded = {}
    for fetch in ("predictive", "sync_free"):
        f = fault_rows[fetch]["faults"]
        rate = f["fallbacks"] / max(1, f["decode_steps"])
        sim = ClusterSimulator(SimConfig(cfg=r1, gen_mode="dwdp", expert_fetch=fetch,
                                         cache_budget=CACHE_BUDGET, gen_batch=DEGRADED_BATCH,
                                         predict_hit_rate=served["cuda"], fault_rate=rate,
                                         validate_fetch=True))
        degraded[fetch] = {"fault_rate": rate, "rows": sim.degraded_table()}
        print(f"cluster: model output (GB200) degraded_table R1 gen dwdp {fetch} batch "
              f"{DEGRADED_BATCH} cache {CACHE_BUDGET} predict_hit_rate {served['cuda']:.4f} (replayed) fault_rate "
              f"{f['fallbacks']}/{f['decode_steps']} = {rate:.4f} (phase 14's re-runs): "
              f"{json.dumps(degraded[fetch]['rows'])}")
    t0 = time.perf_counter()
    sweep = [row for mode in ("dep", "dwdp") for row in pareto_sweep(
        r1, ctx_mode=mode, ctx_gpu_options=(2, 4, 8), rate_options=(0.5, 1.0, 2.0, 4.0),
        horizon_s=120.0)]
    table5 = table5_ratio(sweep)
    print(f"cluster: model output (GB200) Table 5 sweep ({time.perf_counter() - t0:.1f} s): "
          + json.dumps([{k: r[k] for k in ("ctx_mode", "ctx_gpus", "rate", "completed",
                                          "mean_tps_user", "tps_per_gpu", "median_ttft_s")}
                        for r in sweep])
          + f"; DWDP / DEP TPS/GPU at TPS/user in {list(PAPER_TPS_USER)}: "
          + json.dumps(table5))
    fleet = modeled_fleet()
    counts = registry.launch_counts()
    if any(counts.values()):
        fail(f"cluster: the phase launched kernels: {counts}")
    wall = time.perf_counter() - t_phase
    out = {"replay": {"accept_rich": rich, "accept_plain": plain, "uniform": uniform,
                      "served": served, "served_serve_predict_hit_rate":
                      served_summary.get("predict_hit_rate"), "trace_skew": skew},
           "reshard": reshard, "degraded": degraded, "table5": table5, "fleet": fleet,
           "wall_s": wall}
    print(f"cluster ({card}; phase wall_s {wall:.1f}): " + json.dumps(
        {"replay": out["replay"], "reshard": {k: reshard[k] for k in
                                               ("ms", "gb_per_s", "model_seconds", "peak_gb")},
         "table5": table5}))
    return out


# --------------------------------------------------------------------------
# Rank death on the live engine: the standby on the survivors' mesh.
# --------------------------------------------------------------------------
def poison_dead_shard(params: list, dead: int, g: int) -> float:
    """NaN into every leaf of model position ``dead`` that no survivor
    shares (its embedding and head slices, attention, FFN and expert
    shards); returns the GB filled."""
    import torch

    kept = {id(t) for m in range(g) if m != dead for t in tree_leaves(params[m])}
    filled = 0
    for t in tree_leaves(params[dead]):
        if isinstance(t, torch.Tensor) and id(t) not in kept and t.is_floating_point():
            t.fill_(float("nan"))
            filled += t.numel() * t.element_size()
    return filled / 1e9


def standby_checks(label: str, cfg, sb, source: dict) -> dict:
    """The standby's weights: each expert shard bitwise a fresh
    ``make_placement(256, 3)`` shard of the checkpoint's experts with zero
    padding, and no NaN in any leaf."""
    import torch

    pl = sb.gen.model.geom.moe_placement
    e, chunk = cfg.moe.num_experts, 8
    bitwise, pad_zero, layers = True, True, 0
    for g_name, group in sb.params[0]["layers"].items():
        for k, lp in group.items():
            if "moe" not in lp:
                continue
            layers += 1
            src = source["layers"][g_name][k]["moe"]["experts"]
            for p in range(pl.subgroup_size):
                first, stop = p * pl.local_count, min((p + 1) * pl.local_count, e)
                for name, leaf in sb.params[p]["layers"][g_name][k]["moe"]["experts"].items():
                    for a in range(0, stop - first, chunk):
                        b = min(stop - first, a + chunk)
                        want = src[name][first + a:first + b].to(leaf.device, non_blocking=True)
                        bitwise &= torch.equal(leaf[a:b], want)
                    pad_zero &= bool((leaf[stop - first:] == 0).all())
    nan = any(bool(torch.isnan(t).any()) for p in sb.params for t in tree_leaves(p)
              if isinstance(t, torch.Tensor) and t.is_floating_point())
    print(f"{label}: standby expert shards of {layers} MoE layer(s) bitwise fresh "
          f"make_placement({e}, {pl.subgroup_size}) shards of the checkpoint {bitwise}, padding "
          f"zero {pad_zero} ({pl.num_padded - e} dummy rows), NaN in the standby's weights {nan}")
    if not (bitwise and pad_zero) or nan:
        fail(f"{label}: standby weights bitwise {bitwise} padding zero {pad_zero} NaN {nan}")
    return {"experts_bitwise": bitwise, "padding_zero": pad_zero, "nan": nan}


def time_snapshots(gen, sink: dict) -> None:
    """Add the seconds of each of ``gen``'s ``snapshot_slot`` calls to
    ``sink["snapshot_s"]`` (nothing but ``gen`` holds the wrapper, so a
    dropped server is not kept alive)."""
    inner = gen.snapshot_slot

    def timed(slot):
        t0 = time.perf_counter()
        out = inner(slot)
        sink["snapshot_s"] += time.perf_counter() - t0
        return out

    gen.snapshot_slot = timed


def event_ms(pairs: list) -> float:
    return sum(a.elapsed_time(b) for a, b in pairs)


def rank_death_phase(cfg, held: dict, rng) -> dict:
    """Phase 16, rank death on the live engine (run after 15, on R1 1024's
    weights and the checkpoint's host copy, both taken from ``held``: the
    re-shard frees the old weights as the new land, so nothing else may
    hold them). A (2, 4) engine, graphs, ``RD_POLICY``, row-local capacity,
    4 slots, serves ``RD_REQUESTS`` requests of 1024 tokens (16 out) through
    ``ServingScheduler`` over ``LiveReplicaClient`` in a one-replica
    ``MultiReplicaEngine``: first uninterrupted; its generation server then
    steps onto the ladder's ``"reshard"`` rung, which must replay the
    captured all-fetch variant (no capture) with one decode step's logits
    bitwise the all-fetch rung's; then the requests again, rank ``RD_DEAD``
    killed after ``RD_PRE_STEPS`` decode steps. The standby is the client's
    callable: after the dying engine's graphs are released it fills the dead
    shard with NaN, re-shards the weights in place for (2, 3)
    (``checkpoint.convert.reshard_params``, the dead rank's rows from the
    pinned checkpoint) and builds and warms a (2, 3) engine. One card holds
    no second R1 weight set beside a running engine, so the fleet is one
    replica and its migrants requeue (their owner's plan changed).
    Checked: migrated + requeued = the active slots, every request at 16
    tokens, the summary's recovery counts, the standby's weights
    (:func:`standby_checks`), its prefill and decode logits against the
    plain versions, the requeued requests served again on the standby alone
    bitwise, the launches through its replays (#2, #3, #6 and #7 on, #4 and
    #5 off its unsharded attention; #6 on both its Hopper and mma paths),
    no capture after the recovery, peak under the card's 80 GB."""
    import torch
    from repro_torch.checkpoint.convert import reshard_params
    from repro_torch.core import execution, roofline
    from repro_torch.core.strategy import degrade_policy_table
    from repro_torch.kernels import registry
    from repro_torch.launch.serve import build_engine
    from repro_torch.models.transformer import build_model, replicate_over_data
    from repro_torch.runtime.serving import LiveReplicaClient, MultiReplicaEngine, ServingScheduler

    card = card_line()
    label = f"rank death ({cfg.name} {PROMPT}, mesh {RD_MESH} -> {RD_MESH_SURVIVORS})"
    t_phase = time.perf_counter()
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    source = held.pop("source")["tree"]
    sizes = {"data": RD_MESH[0], "model": RD_MESH[1]}
    params = replicate_over_data(held.pop("params"), sizes)
    kw = dict(prefill_len=PROMPT, cache_len=PROMPT + OUTPUT, max_batch=RD_BATCH,
              dtype=torch.bfloat16, device="cuda", geom_kwargs=GEOM, policy=RD_POLICY,
              capacity_from="global")
    eng, model24 = build_engine(cfg, mesh_shape=RD_MESH, params=params, **kw)
    model23 = build_model(cfg, dict(zip(("data", "model"), RD_MESH_SURVIVORS)),
                          dtype=torch.bfloat16, device="cuda", **GEOM)
    all_table = degrade_policy_table(eng.gen.xp.policies, "all")
    client = LiveReplicaClient.from_engine(eng)
    del eng
    t0 = time.perf_counter()
    # the prefill, the reshard rung's all-fetch decode (its landings are the
    # largest), then the policy's decode
    client.ctx.warmup(client.params)
    client.gen.variants.get(all_table)[1].warm(client.params)
    client.warmup()
    print(f"{label}: policy {json.dumps(RD_POLICY)} (not the reference's predictive "
          f"table: see RD_POLICY), warmup {time.perf_counter() - t0:.2f} s (prefill, the "
          f"reshard rung's all-fetch decode, the policy's decode), "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT) for _ in range(RD_REQUESTS)]

    def requests(ids=None):
        reqs = served_requests(prompts, [OUTPUT] * RD_REQUESTS)
        return reqs if ids is None else [r for r in reqs if r.req_id in ids]

    def streams(fleet) -> dict:
        return {rid: list(t) for s in fleet.schedulers for rid, t in s.outputs.items()}

    # ---- uninterrupted --------------------------------------------------------
    ref = MultiReplicaEngine([ServingScheduler(client)])
    ref.submit(requests())
    ref.run()
    before = ref.merged_metrics().summary(ref.horizon())
    print(f"{label} uninterrupted on {RD_MESH}: {summary_line(before)}")

    # ---- the reshard rung: the all-fetch floor's captured variant -------------
    gen = client.gen
    snap = snapshot(gen)
    caps = (client.ctx.variants.captures(), gen.variants.captures())
    floor = next(i for i, (lab, _, _) in enumerate(gen.ladder) if lab == "all")
    top = len(gen.ladder) - 1
    logits, steps = {}, {}
    for level in (floor, top):
        gen.set_level(level)
        restore(gen, snap)
        replays = gen.step.replays
        logits[gen.fetch_label] = gen.step_outputs(client.params)[0]["logits"].clone()
        steps[gen.fetch_label] = (gen.step, gen.step.replays - replays)
    rung = {"labels": [lab for lab, _, _ in gen.ladder], "max_silent_level":
            gen.max_silent_level, "replayed": steps["reshard"][1],
            "same_variant": steps["reshard"][0] is steps["all"][0],
            "captures": [client.ctx.variants.captures(), gen.variants.captures()],
            "bitwise": torch.equal(logits["all"], logits["reshard"])}
    gen.set_level(0)
    print(f"{label}: set_level({top}) onto the ladder {rung['labels']} (max_silent_level "
          f"{rung['max_silent_level']}): the all-fetch rung's variant {rung['same_variant']}, "
          f"replayed {rung['replayed']} time(s), captures {caps} -> {rung['captures']}, decode "
          f"logits bitwise the all-fetch rung's {rung['bitwise']}")
    if not (rung["bitwise"] and rung["same_variant"]) or rung["replayed"] != 1 \
            or tuple(rung["captures"]) != caps or rung["max_silent_level"] != top - 1:
        fail(f"{label}: the reshard rung {rung}")
    del gen, snap, logits, steps

    # ---- the kill ---------------------------------------------------------------
    recovery: dict = {"snapshot_s": 0.0}
    time_snapshots(client.gen, recovery)

    def standby(dead_rank):
        """Called by ``kill_rank`` once the dying engine's graphs are gone."""
        torch.cuda.synchronize()
        recovery["released_gb"] = [torch.cuda.memory_allocated() / 1e9,
                                   torch.cuda.memory_reserved() / 1e9]
        dead = dead_rank % RD_MESH[1]
        recovery["poisoned_gb"] = poison_dead_shard(params, dead, RD_MESH[1])
        events: dict = {}
        t0 = time.perf_counter()
        new = reshard_params(params, model24, model23, dead, source, free=True, events=events)
        torch.cuda.synchronize()
        recovery["reshard_s"] = time.perf_counter() - t0
        recovery["reshard_ms"] = {k: event_ms(v) for k, v in events.items()}
        recovery["weights_gb"] = [torch.cuda.memory_allocated() / 1e9,
                                  torch.cuda.memory_reserved() / 1e9]
        t0 = time.perf_counter()
        sb, _ = build_engine(cfg, mesh_shape=RD_MESH_SURVIVORS, params=new, **kw)
        recovery["build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sb.warmup()
        torch.cuda.synchronize()
        recovery["captures_s"] = time.perf_counter() - t0
        recovery["engine"] = sb
        return sb

    client.standby = standby
    fleet = MultiReplicaEngine([ServingScheduler(client)])
    fleet.submit(requests())
    sched = fleet.schedulers[0]
    for _ in range(RD_PRE_STEPS):
        sched.step()
    active = sched.active_count()
    # the slots' requests: the dead row's requeue, and the migrants come back
    # to their owner, whose new plan turns their snapshots away (one replica)
    requeued = sorted(r.req_id for r in sched.slots if r is not None)
    t0 = time.perf_counter()
    report = fleet.kill_rank(0, RD_DEAD)
    kill_wall = time.perf_counter() - t0
    sb = recovery.pop("engine")
    seconds = sched.metrics.recovery_times[-1]
    warm = captures(sb)
    registry.reset_launch_counts()
    clear_path_counts()
    replays = replay_counts(sb)
    fleet.run()
    torch.cuda.synchronize()
    counts = registry.launch_counts()
    paths = path_counts()
    after = fleet.merged_metrics().summary(fleet.horizon())
    out = streams(fleet)
    launches = replay_launches(label, sb, replays)
    check_launches(label, sb, launches, counts)
    # the requeued requests served again from their prompts, on the standby alone
    alone = MultiReplicaEngine([ServingScheduler(client)])
    alone.submit(requests(set(requeued)))
    alone.run()
    alone_out = streams(alone)
    standby_summary = alone.merged_metrics().summary(alone.horizon())
    bitwise_alone = all(alone_out[rid] == out[rid] for rid in requeued)

    geom = sb.gen.model.geom
    checks = standby_checks(label, cfg, sb, source)
    errs = {}
    for step in ("prefill", "decode"):
        def run(impl):
            if step == "prefill":
                return sb.ctx.forward(sb.params, prompts[0], impl=impl)["last_logits"].clone()
            g = sb.gen
            ctx = execution.Ctx(model=g.model, xp=g.xp, impl=impl)
            with in_pool(sb):
                return execution.forward_decode(sb.params, g.cur_token, g.state, ctx)[
                    "logits"].clone()
        lk, lt = run(None)[:, :cfg.vocab_size], run("torch")[:, :cfg.vocab_size]
        errs[step] = logit_err(f"{label} standby {step} logits kernels vs plain", lk, lt)
        del lk, lt
    peak = torch.cuda.max_memory_allocated()
    g = RD_MESH[0] * RD_MESH[1]
    model_s = {"gb200_group8": roofline.rank_death_recovery(cfg, group=g)["seconds"],
               "card_view4_bf16": roofline.rank_death_recovery(
                   cfg, group=G, hw=roofline.card_view(G), weight_bytes=2)["seconds"]}
    mma = sum(n for k, n in paths.items() if k.startswith("split_dense_swiglu/")
              and k.split("/")[2] == "mma")
    tensor_core = sum(n for k, n in paths.items() if k.startswith("split_dense_swiglu/")
                      and k.split("/")[2] != "mma")
    row = {"policy": RD_POLICY, "active_before": active, "report": report,
           "seconds": seconds, "kill_wall_s": kill_wall,
           "recovery": recovery, "model_seconds": model_s,
           "summary_before": before, "summary_after": after, "summary_standby_alone":
           standby_summary, "rung": rung, "checks": checks, "logit_norm_err": errs,
           "launches": dict(launches), "host_launches": dict(counts), "paths": paths,
           "captures": list(warm), "requeued_ids": requeued, "bitwise_alone": bitwise_alone,
           "peak_gb": peak / 1e9,
           "geometry": {"local_count": geom.moe_placement.local_count,
                        "num_padded": geom.moe_placement.num_padded,
                        "attn_axes": list(geom.attn_axes), "vocab_pad": geom.vocab_pad,
                        "ffn_shards": geom.ffn_shards,
                        "ctx_seq_axes": list(sb.ctx.xp.seq_axes),
                        "gen_batch_axes": list(sb.gen.xp.batch_axes)}}
    ms = recovery["reshard_ms"]
    print(f"{label} ({card}): {active} active at the kill, report {json.dumps(report)}; "
          f"recovery: snapshot {recovery['snapshot_s'] * 1e3:.1f} ms, re-shard "
          f"{recovery['reshard_s'] * 1e3:.1f} ms (copies by kind, CUDA events: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(ms.items()))
          + f"), standby build {recovery['build_s']:.2f} s, its captures "
          f"{recovery['captures_s']:.2f} s, kill wall {kill_wall:.2f} s, reported seconds "
          f"{seconds:.3f} beside rank_death_recovery GB200 group {g} "
          f"{model_s['gb200_group8']:.6f} s and card_view({G}) bf16 "
          f"{model_s['card_view4_bf16']:.6f} s; device memory (allocated, reserved GB) after "
          f"the release {[round(x, 2) for x in recovery['released_gb']]}, after the re-shard "
          f"{[round(x, 2) for x in recovery['weights_gb']]} (dead shard "
          f"{recovery['poisoned_gb']:.2f} GB NaN-filled first)")
    print(f"{label}: standby geometry {json.dumps(row['geometry'])}; after the kill "
          f"{summary_line(after)} rank_deaths {after['rank_deaths']} migrated "
          f"{after['migrated']} requeued {after['requeued']} time_to_recover_p50_s "
          f"{after['time_to_recover_p50_s']}; TTFT / TPOT p50 before (mesh {RD_MESH}) "
          f"{before['ttft_p50_s']:.4f} / {before['tpot_p50_s']:.4f} s, after (the standby "
          f"alone, {RD_MESH_SURVIVORS}) {standby_summary['ttft_p50_s']:.4f} / "
          f"{standby_summary['tpot_p50_s']:.4f} s; requeued {requeued} served again on the "
          f"standby alone bitwise {bitwise_alone}; launches through the standby's replays "
          f"{json.dumps(launches)}; #6 launches on the mma path (683 columns) {mma}, on the "
          f"tensor-core paths {tensor_core}; captures {captures(sb)} (after its warmup "
          f"{warm}); peak {peak / 1e9:.2f} GB")
    if report["migrated"] + report["requeued"] != active or active != RD_BATCH \
            or after["admission"].get("requeued", 0) < active:
        fail(f"{label}: {report} for {active} active slots")
    if after["completed"] != RD_REQUESTS or any(len(t) != OUTPUT for t in out.values()) \
            or len(out) != RD_REQUESTS:
        fail(f"{label}: {after['completed']} completed, streams {[len(t) for t in out.values()]}")
    if (after["rank_deaths"], after["migrated"], after["requeued"]) != \
            (1, report["migrated"], report["requeued"]):
        fail(f"{label}: summary recovery keys {after['rank_deaths']} {after['migrated']} "
             f"{after['requeued']} against the report {report}")
    if not bitwise_alone:
        fail(f"{label}: the requeued requests served alone on the standby differ from the fleet")
    if captures(sb) != warm:
        fail(f"{label}: the standby captured after its warmup: {warm} -> {captures(sb)}")
    want_geom = {"local_count": 86, "num_padded": 258, "attn_axes": [], "ffn_shards": 3,
                 "ctx_seq_axes": ["data"], "gen_batch_axes": ["data"]}
    if any(row["geometry"][k] != v for k, v in want_geom.items()):
        fail(f"{label}: standby geometry {row['geometry']}, want {want_geom}")
    missing = [k for k in RD_KERNELS if launches[k] <= 0]
    if missing or any(launches[k] for k in RD_OFF_PATH) or not mma or not tensor_core:
        fail(f"{label}: launches {dict(launches)} (missing {missing}), #6 mma {mma} "
             f"tensor-core {tensor_core}")
    check_paths(label, {k: n for k, n in paths.items()
                        if not (k.startswith("split_dense_swiglu/") and k.split("/")[2] == "mma")})
    if peak > CARD_PEAK_LIMIT:
        fail(f"{label}: peak {peak / 1e9:.2f} GB > {CARD_PEAK_LIMIT / 1e9:.0f} GB")
    row["wall_s"] = time.perf_counter() - t_phase
    print(f"rank death ({card}; phase wall_s {row['wall_s']:.1f})")
    return row


# --------------------------------------------------------------------------
# DEP: a DWDP context server feeding a DEP generation server.
# --------------------------------------------------------------------------
def a2a_bytes_per_decode_step(model, xp) -> dict:
    """DEP's all-to-all traffic of one decode step, from the shapes: per MoE
    layer each rank dispatches an ``(E_pad, C, D)`` buffer; the two
    all-to-alls send ``(G' - 1) / G'`` of it out and as much back (``wire``,
    all ranks), and on one card copy every block of it twice (``copied``)."""
    from repro_torch.models.moe import capacity_for

    cfg, pl = model.cfg, model.geom.moe_placement
    cap = capacity_for(xp.global_batch, cfg.moe.num_experts, cfg.moe.top_k, xp.capacity_factor)
    buf = pl.num_padded * cap * cfg.d_model * model.dtype.itemsize
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    g = pl.subgroup_size
    return {"capacity": cap, "wire": n_moe * model.n_ranks * 2 * buf * (g - 1) / g,
            "copied": n_moe * model.n_ranks * 2 * buf}


def dep_phase(cfg, params, prompts) -> dict:
    """The reference's default serving pair on the R1 1024 cell: a DWDP
    context server feeding a DEP generation server (graphs), on the same
    weights. The serve (``serve_phase``: captures flat after warmup, the
    replays' launches measured, flash attention required, prefill and decode
    logits against the plain versions); from the served state one DEP decode
    step (replay time, profile by kind, landed bytes: the merged attention)
    against the DWDP all-fetch step, and one qgather and one hybrid decode
    step against their plain versions; one DEP ``forward_prefill``
    (tensor-parallel attention through flash attention's Hopper path)
    against its plain version; a rolling ``ServingScheduler`` serve over
    ``LiveReplicaClient``; then the same requests on an eager DEP engine
    (``graphs=False``), whose tokens must equal the graph serve's. Returns
    the numbers."""
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.core import execution
    from repro_torch.core.strategy import make_execution_plan
    from repro_torch.kernels import registry
    from repro_torch.launch.serve import build_engine
    from repro_torch.runtime.serving import LiveReplicaClient

    free_memory()
    torch.cuda.reset_peak_memory_stats()
    kw = dict(mesh_shape=(1, G), prefill_len=PROMPT, prefill_buckets=(PROMPT // 2,),
              cache_len=PROMPT + OUTPUT, max_batch=MAX_BATCH, dtype=torch.bfloat16,
              device="cuda", params=params, geom_kwargs=GEOM, ctx_mode="dwdp", gen_mode="dep")
    eng, model = build_engine(cfg, **kw)
    label = f"{cfg.name} {PROMPT} dwdp ctx + dep gen"
    if (eng.ctx.xp.mode, eng.gen.xp.mode) != ("dwdp", "dep") or "pred" in eng.gen.state:
        fail(f"{label}: modes {eng.ctx.xp.mode}/{eng.gen.xp.mode}, a predictive state attached")
    row, outputs = serve_phase(label, cfg, eng, prompts, ALL_FETCH_KERNELS)
    gen, table = eng.gen, eng.gen.xp.policies
    recorded = {k[0]: n for k, n in gen.step.record.items() if k[0] in registry.KERNELS}
    if recorded:
        fail(f"{label}: the DEP decode step's capture recorded kernel launches {recorded}")
    snap = snapshot(gen)
    step = snapshot_step("dep graph", eng, snap)
    dep_logits = step.pop("logits")
    row.update(step)
    sizes = {"data": 1, "model": G}

    def variant_logits(name, mode="dep", decode_attn="gather"):
        """One eager decode step of another plan over the served state: its
        kernels' logits and its plain versions', and its launches."""
        xp = make_execution_plan(model, gen.variants.shape, sizes, mode=mode, policy=table,
                                 decode_attn=decode_attn, capacity_from=gen.xp.capacity_from)

        def logits(impl):
            with in_pool(eng):
                out = execution.forward_decode(eng.params, gen.cur_token, gen.state,
                                               execution.Ctx(model=model, xp=xp, impl=impl))
            return out["logits"].clone()

        registry.reset_launch_counts()
        got = logits(None)
        launches = {k: n for k, n in registry.launch_counts().items() if n}
        ref = logits("torch")
        err = logit_err(f"{label} {name} decode step, kernels vs plain",
                        got[:, :cfg.vocab_size], ref[:, :cfg.vocab_size])
        print(f"{label} {name} decode step launches {json.dumps(launches)}")
        return got, err, launches

    dwdp_logits, _, _ = variant_logits("dwdp all-fetch", mode="dwdp")
    row["dep_vs_dwdp_err"] = logit_err(f"{label}: DEP decode step vs the DWDP all-fetch step",
                                       dep_logits[:, :cfg.vocab_size],
                                       dwdp_logits[:, :cfg.vocab_size])
    del dwdp_logits
    _, row["qgather_err"], _ = variant_logits("dep qgather", decode_attn="qgather")
    _, row["hybrid_err"], hybrid_launches = variant_logits("hybrid", mode="hybrid")
    missing = [k for k in HYBRID_KERNELS if not hybrid_launches.get(k)]
    if missing:
        fail(f"{label}: the hybrid decode step never launched {missing}")

    # DEP's own prefill: tensor-parallel attention through flash attention
    xp = make_execution_plan(model, InputShape("ctx", PROMPT, 1, "prefill"), sizes, mode="dep")
    tokens = torch.as_tensor(prompts[0][None, :], dtype=torch.int64, device="cuda")
    registry.reset_launch_counts()
    clear_path_counts()
    with in_pool(eng):
        got = execution.forward_prefill(eng.params, tokens, execution.Ctx(model=model, xp=xp))
        got = got["last_logits"].clone()
    launched = {k: n for k, n in registry.launch_counts().items() if n}
    paths = path_counts()
    check_paths(f"{label} dep prefill", paths)
    n_layers = cfg.num_layers * G
    if launched != {k: n_layers for k in DEP_KERNELS} or sum(paths.values()) != n_layers:
        fail(f"{label}: the DEP prefill launched {launched}, paths {paths}; want "
             f"{n_layers} launches of each of {DEP_KERNELS} on the Hopper path, nothing else")
    with in_pool(eng):
        ref = execution.forward_prefill(eng.params, tokens,
                                        execution.Ctx(model=model, xp=xp, impl="torch"))
        ref = ref["last_logits"].clone()
    row["dep_prefill_err"] = logit_err(f"{label} DEP prefill (tensor-parallel attention) "
                                       f"logits, kernels vs plain", got[:, :cfg.vocab_size],
                                       ref[:, :cfg.vocab_size])
    row["dep_prefill_paths"] = paths
    del got, ref, tokens

    # a rolling ServingScheduler serve over the live client
    client = LiveReplicaClient.from_engine(eng)
    client.warmup()
    warm = captures(eng)
    row["rolling"] = drive_scheduler("dep rolling", client, served_requests(prompts, SERVING_LENS),
                                     ALL_FETCH_KERNELS)
    row["rolling"].pop("outputs")
    if captures(eng) != warm:
        fail(f"{label}: the rolling serve captured ({warm} -> {captures(eng)})")
    row["a2a_bytes_per_decode_step"] = a2a_bytes_per_decode_step(model, gen.xp)
    phase_peak = torch.cuda.max_memory_allocated()
    row["dep_phase_peak_gb"] = phase_peak / 1e9
    if phase_peak > PEAK_LIMIT:
        fail(f"{label}: peak memory {phase_peak / 1e9:.2f} GB > {PEAK_LIMIT / 1e9:.0f} GB")
    del eng, client, gen, model, dep_logits
    free_memory()

    # the same requests through eager steps
    eager, _ = build_engine(cfg, graphs=False, **kw)
    eager_outputs = serve(eager, prompts)
    row["eager_tpot_p50_s"] = eager.metrics.summary(horizon=eager.horizon())["tpot_p50_s"]
    print(f"{label}: graph and eager serves give the same tokens {eager_outputs == outputs}; "
          f"eager tpot_p50_s {row['eager_tpot_p50_s']:.4f}")
    if eager_outputs != outputs:
        fail(f"{label}: the eager DEP serve gave other tokens: {eager_outputs} vs {outputs}")
    del eager
    free_memory()
    a2a = row["a2a_bytes_per_decode_step"]
    print(f"dep ({card_line()}): tpot_p50_s {row['summary']['tpot_p50_s']:.4f} decode step "
          f"replay ms {row['replay_ms']:.2f} {row['replay_ms_range']} profiled by kind "
          f"{json.dumps({k: round(v, 2) for k, v in row['profile_ms'].items()})} landed_gb per "
          f"decode step {row['landed_gb']:.3f} (the merged attention) all-to-all bytes per "
          f"decode step {json.dumps(a2a)} peak_gb {row['peak_gb']:.2f} (phase "
          f"{row['dep_phase_peak_gb']:.2f})")
    return row


# --------------------------------------------------------------------------
# Mesh (data=2, model=4): batch-sharded prefill, and serving on two replicas.
# --------------------------------------------------------------------------
def prefill_launches(model, xp) -> dict:
    """The kernel launches one DWDP prefill under ``xp`` makes, from the
    shapes: per rank and layer #4 three times (q, k, v), #5 and #7 once, #6
    once per dense FFN (dense layers and shared experts), #2 once per MoE
    layer."""
    cfg, n = model.cfg, model.n_ranks
    layers = cfg.num_layers
    moe_layers = sum(cfg.is_moe_layer(i) for i in range(layers))
    dense = (layers - moe_layers) + (moe_layers if cfg.moe.shared_d_ff else 0)
    return {"split_stack_gemm": 3 * layers * n, "split_reduce_gemm": layers * n,
            "flash_attention": layers * n, "split_dense_swiglu": dense * n,
            "split_grouped_swiglu": moe_layers * n}


def batch_sharded_prefill(cfg, params, rng) -> dict:
    """DWDP prefill with the batch sharded over ``model``: B = 4 on (1, 4) and
    B = 8 on (2, 4), 1024-token prompts, each rank a whole row. At the serving
    factor (1.25) the launches of every kernel must equal the shapes' count
    and the last logits be within LOGIT_TOL of the plain versions'; in the
    no-drop regime (NO_DROP_FACTOR) within LOGIT_TOL of each prompt's
    seq-sharded B = 1 prefill on (1, 4). Returns the numbers."""
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.core import execution
    from repro_torch.core.strategy import make_execution_plan
    from repro_torch.kernels import registry
    from repro_torch.models.moe import capacity_for
    from repro_torch.models.transformer import build_model, replicate_over_data

    free_memory()
    torch.cuda.reset_peak_memory_stats()
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (8, PROMPT)), device="cuda")
    layouts = {}
    for mesh, b in (((1, G), 4), (MESH24, 8)):
        sizes = {"data": mesh[0], "model": mesh[1]}
        model = build_model(cfg, sizes, dtype=torch.bfloat16, device="cuda", **GEOM)
        layouts[mesh] = (model, sizes, replicate_over_data(params, sizes), b)
    out = {}

    def prefill(mesh, rows, factor, impl=None):
        model, sizes, prm, _ = layouts[mesh]
        xp = make_execution_plan(model, InputShape("p", PROMPT, len(rows), "prefill"), sizes,
                                 capacity_factor=factor)
        logits = execution.forward_prefill(prm, prompts[rows],
                                           execution.Ctx(model=model, xp=xp, impl=impl))
        return xp, logits["last_logits"][:, :cfg.vocab_size].float().clone()

    # seq-sharded references: each prompt alone on (1, 4), in the no-drop regime
    seq_ref = torch.cat([prefill((1, G), [i], NO_DROP_FACTOR)[1] for i in range(8)])
    for mesh, (model, _, _, b) in layouts.items():
        label = f"batch-sharded prefill B {b} on mesh {mesh}"
        rows = list(range(b))
        registry.reset_launch_counts()
        clear_path_counts()
        xp, got = prefill(mesh, rows, 1.25)
        torch.cuda.synchronize()
        counts = {k: n for k, n in registry.launch_counts().items() if n}
        paths = path_counts()
        want = prefill_launches(model, xp)
        print(f"{label}: batch axes {xp.batch_axes} seq axes {xp.seq_axes}, {PROMPT} tokens and "
              f"expert capacity {capacity_for(PROMPT, cfg.moe.num_experts, cfg.moe.top_k, 1.25)} "
              f"per rank; launches {json.dumps(counts)} (from the shapes {json.dumps(want)}); "
              f"paths {json.dumps(paths)}")
        if "model" not in xp.batch_axes or xp.seq_axes:
            fail(f"{label}: the plan is not batch-sharded over model ({xp.batch_axes}, {xp.seq_axes})")
        if counts != want:
            fail(f"{label}: launches {counts} differ from the shapes' {want}")
        check_paths(label, paths)
        plain = prefill(mesh, rows, 1.25, impl="torch")[1]
        row = {"launches": counts,
               "vs_plain_err": logit_err(f"{label} logits, kernels vs plain", got, plain)}
        del plain
        _, nodrop = prefill(mesh, rows, NO_DROP_FACTOR)
        row["vs_seq_sharded_err"] = logit_err(
            f"{label} logits (factor {NO_DROP_FACTOR}) vs each prompt's seq-sharded B 1 "
            f"prefill on (1, {G})", nodrop, seq_ref[:b])
        out[f"mesh{mesh[0]}x{mesh[1]}_b{b}"] = row
        del got, nodrop
    peak = torch.cuda.max_memory_allocated()
    out["peak_gb"] = peak / 1e9
    print(f"batch-sharded prefill ({card_line()}): peak {peak / 1e9:.2f} GB")
    if peak > PEAK_LIMIT:
        fail(f"batch-sharded prefill: peak memory {peak / 1e9:.2f} GB > {PEAK_LIMIT / 1e9:.0f} GB")
    del layouts, prompts, seq_ref
    free_memory()
    return out


@contextlib.contextmanager
def recorded_routing():
    """Record every ``moe.route_topk`` call of the port (per MoE layer and
    rank, in rank order) as (top-k expert ids, gates)."""
    from repro_torch.models import moe

    calls, route = [], moe.route_topk

    def record(*args, **kw):
        d = route(*args, **kw)
        calls.append((d.top_experts.clone(), d.gates.float().clone()))
        return d

    moe.route_topk = record
    try:
        yield calls
    finally:
        moe.route_topk = route


def routing_diff(got: list, ref: list, top_k: int) -> dict:
    """Tokens whose top-k expert sets differ between two recorded runs of
    the same prefill, the gate margin between the k-th and the next expert
    of each in ``ref``, and whether the last call's last token differs."""
    import torch

    if len(got) != len(ref):
        fail(f"routing recorded {len(got)} calls against {len(ref)}")
    tokens, differ, margins, last = 0, 0, [], False
    for i, ((ea, _), (eb, gb)) in enumerate(zip(got, ref)):
        rows = (ea.sort(-1).values != eb.sort(-1).values).any(-1)
        if gb.shape[-1] > top_k:
            top = gb.topk(top_k + 1, dim=-1).values
            margins += (top[:, top_k - 1] - top[:, top_k])[rows].tolist()
        tokens, differ = tokens + rows.numel(), differ + int(rows.sum())
        last = bool(rows[-1]) if i == len(got) - 1 else last
    return {"calls": len(got), "tokens": tokens, "tokens_differ": differ,
            "last_token_differs": last, "margins": sorted(margins)[:8]}


def context_prefill_drops(cfg, params, prompt) -> dict:
    """The context server's layout of one prompt, B = 1, sequence-sharded:
    over model on (1, 4) (256-token shards) and over data and model on (2, 4)
    (128-token shards), the prompt the serves check first. At the serving
    factor (1.25: expert capacity 16 on (1, 4), 6 on (2, 4)) a bf16 near-tie
    in routing can flip which tokens the kernels and the plain versions drop;
    in the no-drop regime (NO_DROP_FACTOR) nothing is dropped. Kernels vs
    plain on both meshes at both factors, and (2, 4) vs (1, 4) in the
    no-drop regime, each within LOGIT_TOL. In the no-drop regime the
    routing of both paths is recorded (``recorded_routing``): the tokens
    whose top-k expert sets differ, their gate margins, and whether the
    last token's set differs (the last logits read only the last token's
    MoE output). Returns the errors and the routing differences."""
    import numpy as np
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.core import execution
    from repro_torch.core.strategy import make_execution_plan
    from repro_torch.models.moe import capacity_for
    from repro_torch.models.transformer import build_model, replicate_over_data

    free_memory()
    row = torch.as_tensor(np.asarray(prompt)[None, :], dtype=torch.int64, device="cuda")
    out, nodrop = {}, {}
    for mesh in ((1, G), MESH24):
        sizes = {"data": mesh[0], "model": mesh[1]}
        model = build_model(cfg, sizes, dtype=torch.bfloat16, device="cuda", **GEOM)
        prm = replicate_over_data(params, sizes)
        for factor in (1.25, NO_DROP_FACTOR):
            xp = make_execution_plan(model, InputShape("p", len(prompt), 1, "prefill"), sizes,
                                     capacity_factor=factor)
            if xp.seq_axes != tuple(a for a in ("data", "model") if sizes[a] > 1):
                fail(f"context prefill on mesh {mesh}: seq axes {xp.seq_axes}")
            logits, routes = {}, {}
            for impl in (None, "torch"):
                with recorded_routing() as routes[impl]:
                    logits[impl] = execution.forward_prefill(
                        prm, row, execution.Ctx(model=model, xp=xp, impl=impl)
                    )["last_logits"][:, :cfg.vocab_size].float().clone()
            cap = capacity_for(xp.local_seq, cfg.moe.num_experts, cfg.moe.top_k, factor)
            out[f"mesh{mesh[0]}x{mesh[1]}_f{factor}"] = logit_err(
                f"context prefill B 1 on mesh {mesh} ({xp.local_seq} tokens and expert capacity "
                f"{cap} per rank, factor {factor}) logits kernels vs plain",
                logits[None], logits["torch"])
            if factor == NO_DROP_FACTOR:
                nodrop[mesh] = logits[None]
                out[f"mesh{mesh[0]}x{mesh[1]}_routing"] = diff = routing_diff(
                    routes[None], routes["torch"], cfg.moe.top_k)
                print(f"context prefill B 1 on mesh {mesh} (factor {factor}) routing, kernels vs "
                      f"plain: {json.dumps(diff)}")
            del logits, routes
        del model, prm
    out["mesh2x4_vs_mesh1x4_nodrop"] = logit_err(
        f"context prefill B 1 (factor {NO_DROP_FACTOR}) logits, mesh {MESH24} vs (1, {G}), kernels",
        nodrop[MESH24], nodrop[(1, G)])
    del nodrop, row
    free_memory()
    return out


def modelled_landed(model, xp) -> float:
    """``prefetch.LANDED`` of one decode step on every rank, from the wire-byte
    model: each rank lands its split banks' remote shards (DEP's merged
    landing also copies the rank's own shard: G / (G - 1) of the model's
    remote bytes) and, under the demand fetch, the payload rows alone (the
    model's per-layer index bitmaps are wire bytes, not landed)."""
    from repro_torch.core import execution

    cfg, geom = model.cfg, model.geom
    fams = execution.gathered_wire_bytes_per_step(model, xp)["families"]
    dense = sum(fams[f]["fetched"] for f in ("attn_qkv", "attn_out", "dense_ffn"))
    if xp.mode == "dep":
        dense *= G / (G - 1)
    experts = fams["moe_experts"]["fetched"]
    if execution.demand_fetch_active(cfg, geom, xp):
        pl = geom.moe_placement
        budget = min(execution.resolve_demand_budget(cfg, geom, xp), pl.local_count)
        pe = 3 * cfg.d_model * cfg.moe.d_ff * model.dtype.itemsize
        n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
        experts = n_moe * (pl.subgroup_size - 1) * budget * pe
    return model.n_ranks * (dense + experts)


def mesh24_phase(cfg, params, prompts, ref14: dict) -> dict:
    """Serving on mesh (2, 4), max_batch 4, R1 1024's weights shared by the
    two replicas: a DWDP context server (each prompt sharded over all eight
    ranks) feeding a generation server (two slots per replica, the KV ring
    over model) in each of DP_GEN, through graphs (``serve_phase``: captures
    flat after warmup, the replays' launches measured, prefill and decode
    logits against the plain versions, peak under the limit), then eagerly:
    the same tokens. From the served state one decode step: its replay time
    and profile, ``prefetch.LANDED`` against N_DP x the modelled per-rank
    bytes, and its logits at row-local capacity against a (1, 4) server's
    step on the same slots (admitted from ``snapshot_slot``). The numbers
    are printed beside the (1, 4) ones of this run (``ref14``)."""
    import torch
    from repro_torch.core import execution
    from repro_torch.core.strategy import make_execution_plan
    from repro_torch.launch.serve import build_engine
    from repro_torch.models.transformer import build_model, replicate_over_data
    from repro_torch.runtime.engine import GenerationServer

    sizes14 = {"data": 1, "model": G}
    sizes24 = {"data": MESH24[0], "model": MESH24[1]}
    params24 = replicate_over_data(params, sizes24)
    model14 = build_model(cfg, sizes14, dtype=torch.bfloat16, device="cuda", **GEOM)
    out = {}
    for gen_mode, fetch in DP_GEN:
        name = gen_mode if gen_mode == "dep" else f"{gen_mode}_{fetch}"
        label = f"{cfg.name} {PROMPT} mesh (2, 4) dwdp ctx + {gen_mode} gen, fetch {fetch}"
        kw = dict(mesh_shape=MESH24, prefill_len=PROMPT, prefill_buckets=(PROMPT // 2,),
                  cache_len=PROMPT + OUTPUT, max_batch=MAX_BATCH24, dtype=torch.bfloat16,
                  device="cuda", params=params24, geom_kwargs=GEOM, gen_mode=gen_mode,
                  expert_fetch=fetch)
        free_memory()
        torch.cuda.reset_peak_memory_stats()
        eng, model = build_engine(cfg, **kw)
        gen = eng.gen
        if (eng.ctx.xp.seq_axes, gen.xp.batch_axes, gen.xp.seq_axes) != (
                ("data", "model"), ("data",), ("model",)):
            fail(f"{label}: plans ctx seq {eng.ctx.xp.seq_axes}, gen batch {gen.xp.batch_axes} "
                 f"seq {gen.xp.seq_axes}")
        demand = execution.demand_fetch_active(cfg, model.geom, gen.xp)
        if demand != (fetch == "demand"):
            fail(f"{label}: the decode plan's demand path is {demand}")
        kernels = ALL_FETCH_KERNELS + (("split_grouped_swiglu_demand",) if demand else ())
        row, outputs = serve_phase(label, cfg, eng, prompts, kernels)
        step = snapshot_step(f"{name} mesh (2, 4) graph", eng, snapshot(gen))
        step_logits = step.pop("logits")
        row.update(step)
        landed = gen.step.record[("landed", "bytes")] if gen.step.record else 0
        want = modelled_landed(model, gen.xp)
        row["landed_gb_per_decode_step"] = landed / 1e9
        row["modelled_landed_gb"] = want / 1e9
        print(f"{label}: landed per decode step (prefetch.LANDED, {N_DP} ranks) "
              f"{landed / 1e9:.3f} GB, the model's {N_DP} x per-rank bytes {want / 1e9:.3f} GB "
              f"(per rank fetched {gen.gather_bytes['fetched'] / 1e9:.3f} of "
              f"{gen.gather_bytes['full'] / 1e9:.3f} GB)")
        if abs(landed - want) > 1e-9 * want:
            fail(f"{label}: landed {landed} bytes a decode step, the model {want}")
        # the same slots' step at row-local capacity on (2, 4) and on a (1, 4)
        # server: slots 0-1 and then 2-3 admitted from snapshot_slot
        table = gen.xp.policies
        xp24 = make_execution_plan(model, gen.variants.shape, sizes24, mode=gen_mode,
                                   policy=table, capacity_from="global")
        with in_pool(eng):
            got = execution.forward_decode(eng.params, gen.cur_token, gen.state,
                                           execution.Ctx(model=model, xp=xp24))
            got = got["logits"][:, :cfg.vocab_size].float().clone()
        snaps = [{k: v for k, v in gen.snapshot_slot(i).items() if k != "plan"}
                 for i in range(MAX_BATCH24)]
        ref = []
        for pair in ((0, 1), (2, 3)):
            gen14 = GenerationServer(model14, sizes14, mode=gen_mode, max_batch=MAX_BATCH,
                                     cache_len=gen.cache_len, capacity_from="global",
                                     expert_fetch=fetch, space=gen.space)
            for j, i in enumerate(pair):
                gen14.admit(j, i, snaps[i]["token"], snaps[i])
            xp14 = make_execution_plan(model14, gen14.variants.shape, sizes14, mode=gen_mode,
                                       policy=table, capacity_from="global")
            with in_pool(eng):
                o = execution.forward_decode(params, gen14.cur_token, gen14.state,
                                             execution.Ctx(model=model14, xp=xp14))
                ref.append(o["logits"][:, :cfg.vocab_size].float().clone())
            del gen14, o
        row["vs_mesh1x4_err"] = logit_err(
            f"{label}: a decode step at row-local capacity, (2, 4) vs a (1, {G}) server on the "
            f"same slots", got, torch.cat(ref))
        del got, ref, snaps, step_logits
        phase_peak = torch.cuda.max_memory_allocated()
        row["mesh24_phase_peak_gb"] = phase_peak / 1e9
        if phase_peak > PEAK_LIMIT:
            fail(f"{label}: peak memory {phase_peak / 1e9:.2f} GB > {PEAK_LIMIT / 1e9:.0f} GB")
        del eng, gen, model
        free_memory()
        eager, _ = build_engine(cfg, graphs=False, **kw)
        eager_outputs = serve(eager, prompts)
        row["eager_tpot_p50_s"] = eager.metrics.summary(horizon=eager.horizon())["tpot_p50_s"]
        print(f"{label}: graph and eager serves give the same tokens "
              f"{eager_outputs == outputs}; eager tpot_p50_s {row['eager_tpot_p50_s']:.4f}")
        if eager_outputs != outputs:
            fail(f"{label}: the eager serve gave other tokens: {eager_outputs} vs {outputs}")
        del eager
        free_memory()
        out[name] = row
    compare = {name: {"mesh2x4": headline(row["summary"], row["replay_ms"],
                                          row["landed_gb_per_decode_step"], row["peak_gb"],
                                          row["eager_tpot_p50_s"]),
                      "mesh1x4": ref14[name]} for name, row in out.items()}
    print(f"mesh (2, 4) vs (1, {G}) ({card_line()}; R1 {PROMPT}, 4 requests x {OUTPUT} tokens; "
          f"max_batch {MAX_BATCH24} vs {MAX_BATCH}; tps_per_gpu counts one card, whose logical "
          f"ranks share it): " + json.dumps(compare))
    out["vs_mesh1x4"] = compare
    return out


def headline(summary: dict, replay_ms, landed_gb, peak_gb, eager_tpot) -> dict:
    """A serve's numbers for the (2, 4) against (1, 4) line."""
    return dict({k: summary[k] for k in ("tpot_p50_s", "ttft_p50_s", "mean_tps_user",
                                          "tps_per_gpu")},
                replay_ms=replay_ms, landed_gb=landed_gb, peak_gb=peak_gb,
                eager_tpot_p50_s=eager_tpot)


# --------------------------------------------------------------------------
# The serving layer: ServingScheduler over LiveReplicaClient, and replicas.
# --------------------------------------------------------------------------
def served_requests(prompts, lens) -> list:
    from repro_torch.runtime.serving import ServedRequest

    return [ServedRequest(req_id=i, prompt_len=len(p), target_len=n, tokens=p)
            for i, (p, n) in enumerate(zip(prompts, lens))]


def summary_line(summary: dict) -> str:
    """The serving summary's headline numbers (tps_per_gpu: one card per
    replica, whose G logical ranks share it)."""
    keys = ("completed", "ttft_p50_s", "ttft_p95_s", "tpot_p50_s", "tpot_p95_s",
            "mean_tps_user", "tps_per_gpu", "gather_fetch_ratio", "gathered_mb_fetched",
            "gathered_mb_full", "predict_hit_rate", "spec_hit_rate", "cache_hit_rate", "admission")
    return json.dumps({k: summary.get(k) for k in keys})


def drive_scheduler(label: str, client, reqs, kernels, **kw) -> dict:
    """Serve ``reqs`` through a ``ServingScheduler`` over ``client`` with the
    launch counts and landed bytes set to 0 just before and read just after;
    every kernel in ``kernels`` must have launched. Returns the scheduler's
    numbers, summary and streams."""
    import torch
    from repro_torch.core import prefetch
    from repro_torch.kernels import registry
    from repro_torch.runtime.serving import ServingScheduler

    for r in reqs:
        r.resume = r.remaining = None
    registry.reset_launch_counts()
    prefetch.LANDED.bytes = 0
    sched = ServingScheduler(client, **kw)
    sched.submit(reqs)
    t0 = time.perf_counter()
    sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = registry.launch_counts()
    summary = sched.metrics.summary(horizon=sched.t)
    gen = client.gen
    landed_step = gen.step.record[("landed", "bytes")] if gen.step.record else None
    print(f"serving {label}: {sched.steps} decode steps, horizon {sched.t:.4f} s, wall "
          f"{wall:.3f} s; summary {summary_line(summary)}; landed GB over the serve "
          f"{prefetch.LANDED.bytes / 1e9:.3f}, per decode step (all {G} ranks, prefetch.LANDED) "
          f"{(landed_step or 0) / 1e9:.3f} beside the modelled per-rank decode step "
          f"{gen.gather_bytes['fetched'] / 1e9:.3f} GB fetched of {gen.gather_bytes['full'] / 1e9:.3f}"
          f" full; launches {json.dumps(counts)}")
    missing = [k for k in kernels if counts[k] <= 0]
    if missing:
        fail(f"serving {label}: kernels never launched: {missing}")
    if summary["completed"] != len(reqs):
        fail(f"serving {label}: {summary['completed']} of {len(reqs)} requests completed")
    return {"steps": sched.steps, "horizon_s": sched.t, "wall_s": wall, "summary": summary,
            "launches": counts, "landed_gb": prefetch.LANDED.bytes / 1e9,
            "landed_gb_per_decode_step": (landed_step or 0) / 1e9,
            "model_gb_per_rank_decode_step": gen.gather_bytes["fetched"] / 1e9,
            "outputs": {rid: list(t) for rid, t in sched.outputs.items()}}


def swap_resume(client, reqs, ref: dict, before: int = 3) -> bool:
    """Requests 0 and 1 admitted into slots 0 and 1, ``before`` decode steps,
    both evicted to the host, resumed into each other's slot, then decoded
    to their targets: their streams must equal ``ref``'s."""
    a, b = reqs[0], reqs[1]
    for r in (a, b):
        r.resume = None
    streams = {a.req_id: [client.admit(0, a)[0]], b.req_id: [client.admit(1, b)[0]]}
    slots = {0: a, 1: b}
    for i in range(before):
        toks, _ = client.step([0, 1])
        for slot, r in slots.items():
            streams[r.req_id].append(int(toks[slot]))
    snaps = {r.req_id: client.evict(slot) for slot, r in slots.items()}
    slots = {0: b, 1: a}
    for slot, r in slots.items():
        r.resume = snaps[r.req_id]
        client.admit(slot, r)
        r.resume = None
    while slots:
        toks, _ = client.step(sorted(slots))
        for slot, r in list(slots.items()):
            streams[r.req_id].append(int(toks[slot]))
            if len(streams[r.req_id]) == r.target_len:
                client.release(slot)
                del slots[slot]
    ok = all(streams[r.req_id] == ref[r.req_id] for r in (a, b))
    print(f"serving swap resume: requests {a.req_id}, {b.req_id} evicted after {before} steps "
          f"and resumed in each other's slot: streams equal the uninterrupted ones {ok}")
    return ok


def serving_layer(cfg, engine, prompts) -> dict:
    """The serving layer at DeepSeek-R1 width on the R1 engine's weights and
    graph pool, with row-local capacity (``capacity_from="global"``: with 1
    expert slot for 2 rows a request's tokens would depend on its batch
    neighbour, and rolling and epoch admission pair requests differently).
    4 requests at buckets 1024 and 512 with 8 / 16 / 8 / 16 output tokens
    through ``DisaggregatedEngine.run``, then ``ServingScheduler`` over
    ``LiveReplicaClient`` with rolling admission and in ``epoch_mode``: the
    three streams must be bitwise equal and rolling must take fewer decode
    steps. Then an SLO serve (evict_after 2, a target above 1 / TPOT) that
    evicts and resumes with the same streams, and two requests evicted and
    resumed in each other's slot. No capture after warmup. Returns the
    numbers."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.runtime.engine import (
        ContextServer, DisaggregatedEngine, GenerationServer, Request)
    from repro_torch.runtime.serving import AdmissionController, LiveReplicaClient, SLOConfig

    free_memory()
    sizes = {"data": 1, "model": G}
    kw = dict(capacity_from="global", space=engine.gen.space)
    ctx = ContextServer(engine.gen.model, sizes, prefill_len=engine.ctx.prefill_len,
                        prefill_buckets=engine.ctx.prefill_lens, cache_len=engine.ctx.cache_len,
                        **kw)
    gen = GenerationServer(engine.gen.model, sizes, max_batch=MAX_BATCH,
                           cache_len=engine.gen.cache_len, **kw)
    eng = DisaggregatedEngine(engine.params, ctx, gen)
    client = LiveReplicaClient.from_engine(eng)
    client.warmup()
    warm = captures(eng)
    lens = SERVING_LENS
    # the engine's fixed loop
    registry.reset_launch_counts()
    for i, (p, n) in enumerate(zip(prompts, lens)):
        eng.submit(Request(i, p, n))
    run_steps = 0
    while eng.busy():
        eng.run(1)
        run_steps += 1
    ref = {rid: list(t) for rid, t in eng.outputs.items()}
    run_summary = eng.metrics.summary(horizon=eng.horizon())
    print(f"serving engine.run: {run_steps} decode steps; summary {summary_line(run_summary)}; "
          f"launches {json.dumps(registry.launch_counts())}")
    out = {"lens": list(lens), "engine_run": {"steps": run_steps, "summary": run_summary}}
    reqs = served_requests(prompts, lens)
    for name, kw in (("rolling", {}), ("epoch", {"epoch_mode": True})):
        out[name] = drive_scheduler(name, client, reqs, ALL_FETCH_KERNELS, **kw)
    tpot = out["rolling"]["summary"]["tpot_p50_s"]
    # a fresh client: its step-time projection is empty, so both slots admit
    # and the measured steps miss the target
    slo = SLOConfig(target_tps_user=2.0 / tpot, evict_after=2)
    slo_client = LiveReplicaClient.from_engine(eng)
    out["slo"] = drive_scheduler(
        f"SLO (target {slo.target_tps_user:.2f} tokens/s/user, evict_after 2)", slo_client, reqs,
        ALL_FETCH_KERNELS, admission=AdmissionController(slo, slo_client.step_time))
    out["swap_resume_bitwise"] = swap_resume(client, reqs, ref)
    streams = {name: out[name].pop("outputs") for name in ("rolling", "epoch", "slo")}
    adm = out["slo"]["summary"].get("admission", {})
    print(f"serving ({card_line()}): rolling {out['rolling']['steps']} vs epoch "
          f"{out['epoch']['steps']} decode steps; streams rolling == epoch == engine.run == SLO "
          f"{all(s == ref for s in streams.values())}; SLO admission {json.dumps(adm)}; captures "
          f"(ctx, gen) after warmup {warm}, after serving {captures(eng)}")
    for name, s in streams.items():
        if s != ref:
            fail(f"serving {name}: streams differ from engine.run's: {s} vs {ref}")
    if not out["rolling"]["steps"] < out["epoch"]["steps"]:
        fail("serving: rolling admission took no fewer decode steps than epoch mode")
    if adm.get("evicted", 0) < 1 or adm.get("resumed", 0) < 1:
        fail(f"serving SLO: no eviction and resume ({adm})")
    if not out["swap_resume_bitwise"]:
        fail("serving: requests resumed in another slot gave other tokens")
    if captures(eng) != warm:
        fail(f"serving: captured after warmup ({warm} -> {captures(eng)})")
    out["captures"] = list(warm)
    del eng, client, slo_client, ctx, gen
    free_memory()
    return out


def predictive_trace(label: str, eng, prompts, ref_outputs, table) -> dict:
    """A predictive serve through the live client on a warmed demand engine
    switched to ``table``, with a ``RoutedTraceRecorder``: the bitmaps are
    (steps, ranks, experts), each rank's at most top_k * rows (one MoE layer),
    the tokens those of the all-fetch serve, and nothing is captured."""
    import numpy as np
    from repro_torch.runtime.serving import LiveReplicaClient, RoutedTraceRecorder

    warm = captures(eng)
    eng.gen.set_policy(table)
    trace = RoutedTraceRecorder()
    client = LiveReplicaClient.from_engine(eng)
    row = drive_scheduler(label, client, served_requests(prompts, [OUTPUT] * len(prompts)),
                          ("split_grouped_swiglu_demand",), on_step=trace)
    bm = trace.as_array()
    cfg = eng.gen.model.cfg
    per_rank = bm.sum(-1)
    limit = cfg.moe.top_k * MAX_BATCH
    print(f"serving {label}: routed trace {bm.shape} {bm.dtype}, experts per rank and step "
          f"{int(per_rank.min())}-{int(per_rank.max())} (at most {limit}); tokens equal the "
          f"all-fetch serve {row['outputs'] == ref_outputs}")
    if bm.shape != (row["steps"], G, cfg.moe.num_experts) or bm.dtype != np.bool_:
        fail(f"{label}: routed trace of shape {bm.shape} {bm.dtype}")
    if per_rank.max() > limit or not bm.any():
        fail(f"{label}: {int(per_rank.max())} routed experts on a rank, at most {limit}")
    if row.pop("outputs") != ref_outputs:
        fail(f"{label}: tokens differ from the all-fetch serve")
    if captures(eng) != warm:
        fail(f"{label}: captured after warmup ({warm} -> {captures(eng)})")
    row["trace_shape"] = list(bm.shape)
    row["experts_per_rank_max"] = int(per_rank.max())
    row["bitmaps"] = bm
    return row


def gemma_fleet(cfg) -> dict:
    """Two Gemma-3 replicas (the same seeded weights, graphs) behind
    ``MultiReplicaEngine``: a workload skewed to the 4096 bucket, routed
    least loaded; every request must complete. The replicas run one after
    another on the one card, each on its own clock; the merged
    ``tps_per_gpu`` counts one card per replica."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.launch.serve import build_engine
    from repro_torch.runtime.serving import (
        LiveReplicaClient, MultiReplicaEngine, ServingScheduler, WorkloadConfig,
        synthesize_workload)

    free_memory()
    torch.cuda.reset_peak_memory_stats()
    scheds = []
    for _ in range(2):
        eng, _ = build_engine(
            cfg, mesh_shape=(1, G), prefill_len=GEMMA_PROMPT, prefill_buckets=(GEMMA_PROMPT // 2,),
            cache_len=GEMMA_PROMPT + FLEET_OSL * 2, max_batch=MAX_BATCH, dtype=torch.bfloat16,
            device="cuda", seed=0, geom_kwargs=GEMMA_GEOM,
        )
        client = LiveReplicaClient.from_engine(eng)
        client.warmup()
        scheds.append(ServingScheduler(client))
    warm = [captures(s.client) for s in scheds]
    fleet = MultiReplicaEngine(scheds)
    wl = WorkloadConfig(num_requests=FLEET_REQUESTS, isl_buckets=(GEMMA_PROMPT // 2, GEMMA_PROMPT),
                        isl_weights=(0.2, 0.8), osl=FLEET_OSL, osl_jitter=0.5, seed=1)
    reqs = synthesize_workload(wl, vocab_size=cfg.vocab_size)
    registry.reset_launch_counts()
    fleet.submit(reqs)
    t0 = time.perf_counter()
    merged = fleet.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = registry.launch_counts()
    summary = merged.summary(horizon=fleet.horizon())
    per = [{"requests": sorted(r for r, i in fleet.assignments.items() if i == k),
            "steps": s.steps, "horizon_s": s.t,
            "summary": s.metrics.summary(horizon=s.t)} for k, s in enumerate(scheds)]
    peak = torch.cuda.max_memory_allocated()
    print(f"serving fleet {cfg.name} x2 ({card_line()}): workload "
          f"{[(r.req_id, r.prompt_len, r.target_len) for r in reqs]}; router assignments "
          f"{json.dumps(fleet.assignments)}; per replica "
          f"{json.dumps([{k: v for k, v in p.items() if k != 'summary'} for p in per])}; merged "
          f"summary (num_gpus {merged.num_gpus}: one per replica, both on this card) "
          f"{summary_line(summary)}; wall {wall:.3f} s; peak {peak / 1e9:.2f} GB; launches "
          f"{json.dumps(counts)}")
    if summary["completed"] != len(reqs):
        fail(f"serving fleet: {summary['completed']} of {len(reqs)} requests completed")
    missing = [k for k in GEMMA_KERNELS if counts[k] <= 0]
    if missing:
        fail(f"serving fleet: kernels never launched: {missing}")
    if [captures(s.client) for s in scheds] != warm:
        fail("serving fleet: captured after warmup")
    if min(len(p["requests"]) for p in per) < 1:
        fail("serving fleet: a replica got no request")
    out = {"assignments": dict(fleet.assignments), "horizon_s": fleet.horizon(), "wall_s": wall,
           "summary": summary, "replicas": per, "launches": counts, "peak_gb": peak / 1e9}
    del fleet, scheds, eng, client
    free_memory()
    return out


def r1_numbers(r1: dict) -> dict:
    """The serve numbers of the all-fetch graph serve, as a fetch-mode row."""
    s = r1["summary"]
    return {"tpot_p50_s": s["tpot_p50_s"], "tpot_p95_s": s["tpot_p95_s"],
            "ttft_p50_s": s["ttft_p50_s"], "mean_tps_user": s["mean_tps_user"],
            "tps_per_gpu": s["tps_per_gpu"], "wall_s": r1["wall_s"], "peak_gb": r1["peak_gb"],
            "reserved_gb": r1["reserved_gb"], "captures": r1["captures"],
            "fallbacks": r1["fallbacks"], "overflow_layers": r1["overflow_layers"],
            "launches": r1["launches"], "paths": r1["paths"]}


# --------------------------------------------------------------------------
# Phase 17: DeepSeek-R1 1024 stored in e4m3.
# --------------------------------------------------------------------------
def check_fp8_paths(label: str, paths: dict) -> None:
    """Every launch of #2-#6 ran its fp8 path: counted under the banks'
    dtype (FP8_MODEL), on its planned path (:func:`check_paths`)."""
    check_paths(label, paths)
    bad = {k: n for k, n in paths.items()
           if k.split("/")[0] in FP8_KERNELS and not k.endswith("/" + FP8_MODEL)}
    if bad:
        fail(f"{label}: launches of #2-#6 off their fp8 path: {bad}")


def fp8_phase(cfg, prompts, modes: dict, r1: dict) -> dict:
    """Phase 17: R1 1024 with its weights and KV cache stored in e4m3
    (FP8_MODEL), drawn on the card from a seeded generator (phase 5's
    widths, depth and mesh), compute in bf16. One graph pool and one
    all-fetch context server serve the four fetch modes, each a generation
    server of its own, on phase 5's prompts: the all-fetch serve through
    :func:`serve_phase` (launches of #2, #4-#7 measured through the
    replays, prefill and decode logits against the plain versions on the
    same fp8 weights, the prefill profiled); the route-before-gather serves
    with #3's launches measured through the decode replays. No serve may
    capture after its warmup; every launch of #2-#6 must run its fp8 path;
    each mode's tokens must be the all-fetch serve's, and one decode step
    from the all-fetch serve's state its logits bitwise. Printed beside
    phase 5's and 6's bf16 figures of the same run."""
    import torch
    from repro_torch.core import execution
    from repro_torch.kernels import registry
    from repro_torch.models.transformer import build_model
    from repro_torch.runtime.engine import (
        ContextServer,
        DisaggregatedEngine,
        GenerationServer,
        GraphSpace,
    )

    card = card_line()
    t_phase = time.perf_counter()
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    sizes = {"data": 1, "model": G}
    model = build_model(cfg, sizes, dtype=getattr(torch, FP8_MODEL), device="cuda", **GEOM)
    before = torch.cuda.memory_allocated()
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    # the weight set's own bytes (the ranks' shared tensors once each)
    weights_gb = sum({t.data_ptr(): t.numel() * t.element_size()
                      for p in params for t in tree_leaves(p) if torch.is_tensor(t)}.values()) / 1e9
    print(f"fp8: {cfg.name} stored in {FP8_MODEL} (compute {model.compute_dtype}), weights "
          f"{weights_gb:.2f} GB ({(torch.cuda.memory_allocated() - before) / 1e9:.2f} GB "
          f"allocated by the draw, {before / 1e9:.2f} GB held before it)")
    space = GraphSpace(model.device)
    ctx = ContextServer(model, sizes, prefill_len=PROMPT, prefill_buckets=(PROMPT // 2,),
                        cache_len=PROMPT + OUTPUT, space=space)
    rows: dict = {}
    ref_outputs = snap = ref_logits = None
    for fetch, kw in (("all", {}),) + FETCH_MODES:
        free_memory()
        torch.cuda.reset_peak_memory_stats()
        gen = GenerationServer(model, sizes, max_batch=MAX_BATCH, cache_len=PROMPT + OUTPUT,
                               space=space, expert_fetch=fetch, **kw)
        eng = DisaggregatedEngine(params, ctx, gen)
        label = f"fp8 {cfg.name} {PROMPT} {fetch}"
        if fetch == "all":
            num, outs = serve_phase(label, cfg, eng, prompts, ALL_FETCH_KERNELS)
            ref_outputs, snap = outs, snapshot(gen)
            row = dict(r1_numbers(num), logit_norm_err=num["logit_norm_err"],
                       profile_prefill_ms=num["profile_prefill_ms"], launches=num["launches"])
            row["prefill_replay_ms"], lo, hi = time_ms(lambda: ctx.prefill(params, prompts[0]))
            row["prefill_replay_ms_range"] = [lo, hi]
        else:
            if not execution.demand_fetch_active(cfg, model.geom, gen.xp):
                fail(f"{label}: the decode plan does not run the demand path")
            eng.warmup()
            warm = captures(eng)
            registry.reset_launch_counts()
            clear_path_counts()
            replays = replay_counts(eng)
            outs = serve(eng, prompts)
            torch.cuda.synchronize()
            summ = eng.metrics.summary(horizon=eng.horizon())
            counts, paths = registry.launch_counts(), path_counts()
            peak = torch.cuda.max_memory_allocated()
            measured = replay_launches(label, eng, replays, (gen,))
            check_launches(label, eng, {"split_grouped_swiglu_demand":
                                        measured["split_grouped_swiglu_demand"]}, counts)
            if measured["split_grouped_swiglu_demand"] <= 0:
                fail(f"{label}: split_grouped_swiglu_demand never launched in the replays")
            if captures(eng) != warm:
                fail(f"{label}: serving captured new variants ({warm} -> {captures(eng)})")
            row = {"tpot_p50_s": summ["tpot_p50_s"], "tpot_p95_s": summ["tpot_p95_s"],
                   "ttft_p50_s": summ["ttft_p50_s"], "peak_gb": peak / 1e9,
                   "captures": list(captures(eng)), "fallbacks": gen.fallbacks,
                   "launches": dict(measured), "host_launches": counts, "paths": paths}
        check_fp8_paths(label, row["paths"])
        step = snapshot_step(label, eng, snap)
        logits = step.pop("logits")
        if ref_logits is None:
            ref_logits = logits
        row.update(step)
        bitwise = torch.equal(logits, ref_logits)
        print(f"{label}: tokens_equal_all {outs == ref_outputs} decode logits bitwise all "
              f"{bitwise}; tpot_p50_s {row['tpot_p50_s']:.4f} decode replay ms "
              f"{row['replay_ms']:.2f} landed_gb_per_decode_step {row['landed_gb']:.3f} "
              f"fallbacks {row['fallbacks']} at {time.perf_counter() - t_phase:.1f} s")
        if outs != ref_outputs:
            fail(f"{label}: tokens differ from the all-fetch tokens: {outs} vs {ref_outputs}")
        if not bitwise:
            fail(f"{label}: decode logits not bitwise the all-fetch ones")
        rows[fetch] = row
        del eng, gen, logits
    launched = collections.Counter(rows["all"]["launches"])
    for m, _ in FETCH_MODES:
        launched.update(rows[m]["launches"])
    missing = [k for k in FP8_KERNELS + ("flash_attention",) if launched[k] <= 0]
    if missing:
        fail(f"fp8: kernels never launched in the replays: {missing}")
    peak = torch.cuda.max_memory_allocated()
    del ctx, space, params, model
    free_memory()
    for fetch, row in rows.items():
        ref = modes[fetch]["graph"]
        print(f"fp8 vs bf16 ({card}; R1 {PROMPT}, fetch {fetch}): tpot_p50_s e4m3 "
              f"{row['tpot_p50_s']:.4f} bf16 {ref['tpot_p50_s']:.4f}; decode replay ms e4m3 "
              f"{row['replay_ms']:.2f} bf16 {ref['replay_ms']:.2f}; landed GB per decode step "
              f"e4m3 {row['landed_gb']:.3f} bf16 {ref['landed_gb']:.3f}; decode step by kind "
              f"e4m3 {json.dumps({k: round(v, 2) for k, v in row['profile_ms'].items()})} bf16 "
              f"{json.dumps({k: round(v, 2) for k, v in ref['profile_ms'].items()})}")
    a = rows["all"]
    print(f"fp8 vs bf16 ({card}; R1 {PROMPT}, the all-fetch serve): weights GB e4m3 "
          f"{weights_gb:.2f}; peak GB e4m3 {a['peak_gb']:.2f} bf16 {r1['peak_gb']:.2f}; "
          f"ttft_p50_s e4m3 {a['ttft_p50_s']:.4f} bf16 {r1['summary']['ttft_p50_s']:.4f}; one "
          f"1024-token prefill, profiled device ms e4m3 "
          f"{a['profile_prefill_ms']['device_ms']:.2f} bf16 "
          f"{r1['profile_prefill_ms']['device_ms']:.2f}, replay ms e4m3 "
          f"{a['prefill_replay_ms']:.2f}; phase peak {peak / 1e9:.2f} GB; "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"weights_gb": weights_gb, "phase_peak_gb": peak / 1e9, "modes": rows,
            "launches": dict(launched), "seconds": time.perf_counter() - t_phase}


# --------------------------------------------------------------------------
# Phase 18: RecurrentGemma-2B, xLSTM-350M and Grok-1 at full width.
# --------------------------------------------------------------------------
def arch_kernel_cases() -> list:
    """Phase 3's cases at phase 18's per-rank shapes: #7 at head dim 256
    (RecurrentGemma's local attention: 10 heads, 1 kv head, window 2048)
    over the first and the last 256-token shard of a 1024-token prompt, and
    #2 / #3 at Grok-1's expert shapes (E 8 over G' 4: 2 resident and 6
    remote experts of 6144 x 32768): the prefill's and decode's capacity,
    and the demand decode's fetched bank (3 peers x 2 rows, the auto budget
    clamped to a peer's 2 experts)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.budget import demand_budget_rows
    from repro_torch.models.moe import capacity_for

    rg, grok = get_arch("recurrentgemma-2b"), get_arch("grok-1-314b")
    sq = RG_PROMPT // G
    att = dict(b=1, sq=sq, h=rg.num_heads, kh=rg.num_kv_heads, hd=rg.head_dim, window=rg.window)
    cases = [("flash_attention", "recurrentgemma_1024_first", dict(att, sk=sq, q_offset=0)),
             ("flash_attention", "recurrentgemma_1024_last",
              dict(att, sk=RG_PROMPT, q_offset=RG_PROMPT - sq))]
    e, k, d, fe = grok.moe.num_experts, grok.moe.top_k, grok.d_model, grok.moe.d_ff
    for phase, t in (("grok1_prefill", GROK_PROMPT // G), ("grok1_decode", MAX_BATCH)):
        cases.append(("split_grouped_swiglu", phase,
                      dict(c=capacity_for(t, e, k, 1.25), d=d, f=fe, e=e, e_l=e // G)))
    e_f = (G - 1) * demand_budget_rows(MAX_BATCH * k, e, e // G)
    cases.append(("split_grouped_swiglu_demand", "grok1_decode",
                  dict(c=capacity_for(MAX_BATCH, e, k, 1.25), d=d, f=fe, e_l=e // G, e_f=e_f)))
    return cases


def whole_params(params: list, model, whole) -> list:
    """The parameter list of ``whole``, the same architecture on mesh (1, 1),
    from ``model``'s per-rank trees (mesh (1, G)): the embedding's vocab
    shards and the dense FFN's shards concatenated in rank order (the
    canonical order), every replicated leaf shared. For the dense and
    recurrent families only (RecurrentGemma: attention unsharded)."""
    import torch

    geom = model.geom
    if geom.attn_axes or geom.moe_placement is not None or \
            geom.vocab_pad != whole.geom.vocab_pad:
        fail("whole_params: sharded attention, experts or another vocab padding")
    ranks = params[:geom.model_size]
    out = {"embed": torch.cat([p["embed"] for p in ranks]), "final_norm": ranks[0]["final_norm"],
           "layers": {}}
    if "lm_head" in ranks[0]:
        out["lm_head"] = torch.cat([p["lm_head"] for p in ranks], dim=-1)
    for group in model.plan:
        gd = {}
        for key, lp in ranks[0]["layers"][group.name].items():
            tree = dict(lp)
            if "ffn" in lp:
                parts = [p["layers"][group.name][key]["ffn"] for p in ranks]
                tree["ffn"] = {"w_gate": torch.cat([t["w_gate"] for t in parts], dim=-1),
                               "w_up": torch.cat([t["w_up"] for t in parts], dim=-1),
                               "w_down": torch.cat([t["w_down"] for t in parts], dim=-2)}
            gd[key] = tree
        out["layers"][group.name] = gd
    return [out]


def continuation_check(label: str, cfg, engine, model, prompt) -> dict:
    """The (1, G) prefill's captured state handed to decode against the same
    prompt prefilled unsharded on (1, 1), on the same weights on the card:
    the engine's context server prefills ``prompt`` (its sequence sharded
    over the G ranks, the RG-LRU fix-up capturing the fixed-up state) and
    its generation server decodes RG_CONTINUE greedy steps from it
    (graph replays); a (1, 1) model with the merged weights
    (:func:`whole_params`) prefills and decodes eagerly. The first token and
    every decoded token must be equal, and each step's logits within
    LOGIT_TOL norm-wise."""
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.core import execution, strategy
    from repro_torch.models.transformer import build_model

    v = cfg.vocab_size
    gen, params = engine.gen, engine.params
    first, state = engine.ctx.prefill(params, prompt)
    slot = gen.free_slots()[0]
    gen.admit(slot, 10_000, first, state)
    sharded = {"tokens": [first], "logits": []}
    for _ in range(RG_CONTINUE):
        tokens = gen.decode_step(params)
        sharded["logits"].append(gen.step.outputs["logits"][slot, :v].float().clone())
        sharded["tokens"].append(int(tokens[slot]))
    gen.release(slot)
    sizes1 = {"data": 1, "model": 1}
    whole = build_model(cfg, sizes1, dtype=model.dtype, device="cuda")  # nothing sharded
    params1 = whole_params(params, model, whole)
    cache = engine.ctx.cache_len
    with in_pool(engine):
        xp = strategy.make_execution_plan(whole, InputShape("p", len(prompt), 1, "prefill"),
                                          sizes1)
        out = execution.forward_prefill(params1, torch.as_tensor(prompt[None], device="cuda"),
                                        execution.Ctx(model=whole, xp=xp, capture_len=cache))
        xpd = strategy.make_execution_plan(whole, InputShape("g", cache, 1, "decode"), sizes1)
        ref = {"tokens": [int(out["last_logits"][0].argmax())], "logits": []}
        st, tok = out["state"], out["last_logits"][:, :].argmax(-1, keepdim=True)
        for _ in range(RG_CONTINUE):
            o = execution.forward_decode(params1, tok, st, execution.Ctx(model=whole, xp=xpd))
            ref["logits"].append(o["logits"][0, :v].float().clone())
            st, tok = o["state"], o["next_token"]
            ref["tokens"].append(int(tok[0, 0]))
        del out, st, o
    print(f"{label} (1, {G}) sequence-sharded prefill + decode: {sharded['tokens']}\n"
          f"{label} (1, 1) unsharded prefill + decode:        {ref['tokens']}")
    if sharded["tokens"] != ref["tokens"]:
        fail(f"{label}: the (1, {G}) prefill's captured state decodes other tokens than the "
             "(1, 1) prefill")
    errs = [logit_err(f"{label} decode step {i} logits, (1, {G}) vs (1, 1)", a, b)
            for i, (a, b) in enumerate(zip(sharded["logits"], ref["logits"]))]
    del params1, whole
    free_memory()
    return {"tokens": sharded["tokens"], "logit_norm_err": errs}


def recurrentgemma_phase(rng) -> dict:
    """RecurrentGemma-2B at full width and depth (26 layers: 18 RG-LRU, 8
    local attention at head dim 256), mesh (1, G), graphs: RG_PROMPT-token
    prompts (the sequence sharded, 256 tokens a rank), served as in 5
    (:func:`serve_phase`: launches of #6 and #7 measured through the
    replays, #7 on its hd-256 mma path, no capture after warmup, prefill
    and decode logits against the plain versions), then the (1, G) against
    (1, 1) continuation (:func:`continuation_check`)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import SERVE_GEOMETRY, build_engine

    cfg = get_arch("recurrentgemma-2b")
    free_memory()
    prompts = [rng.integers(0, cfg.vocab_size, RG_PROMPT) for _ in range(N_REQUESTS)]
    t0 = time.perf_counter()
    eng, model = build_engine(
        cfg, mesh_shape=(1, G), prefill_len=RG_PROMPT, cache_len=RG_PROMPT + OUTPUT,
        max_batch=MAX_BATCH, dtype=torch.bfloat16, device="cuda", seed=0,
        geom_kwargs=SERVE_GEOMETRY[cfg.name])
    torch.cuda.synchronize()
    kinds = collections.Counter(s.kind.value for g in model.plan for s in g.sigs
                                for _ in range(g.n_cycles))
    print(f"model: {cfg.name} d_model {cfg.d_model} layers {cfg.num_layers} {dict(kinds)} "
          f"params {cfg.param_count() / 1e9:.3f} B attn_shards {model.geom.attn_shards} "
          f"ffn_shards {model.geom.ffn_shards}; init {time.perf_counter() - t0:.1f} s, weights "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    label = f"{cfg.name} {RG_PROMPT}"
    row, _ = serve_phase(label, cfg, eng, prompts, RG_KERNELS)
    row["continuation"] = continuation_check(label, cfg, eng, model, prompts[0])
    del eng, model
    free_memory()
    return row


def map_leaves(params: list, fn) -> list:
    """The per-rank trees (dicts and lists) with ``fn`` applied to every
    leaf, a leaf the ranks share mapped once (the new trees share it too)."""
    memo: dict = {}

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        if id(t) not in memo:
            memo[id(t)] = fn(t)
        return memo[id(t)]

    return [walk(p) for p in params]


def xlstm_phase(rng) -> dict:
    """xLSTM-350M at full width and depth (24 layers: 18 mLSTM, 6 sLSTM;
    no attention, no FFN: no kernel of the port on its path), mesh (1, G)
    (the ranks replicate the rows: the JAX package never shards an xLSTM
    sequence), XLSTM_PROMPT-token prompts, 4 requests of OUTPUT tokens:
    through graphs (no capture after warmup), and the first XLSTM_EAGER
    eagerly: the same tokens. One prefill and one decode step (of the
    served first token) in bf16 against the same weights in fp32 on the
    card (XLSTM_BF16_TOL, with its control: a decode step from a zeroed
    state must fail it), and the fp32 run on the card against the same
    fp32 run on the CPU (FP32_LOGIT_TOL). The prefill's wall time, eager
    and replayed, is printed: the recurrences are a loop over tokens."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import InputShape
    from repro_torch.core import execution, strategy
    from repro_torch.kernels import registry
    from repro_torch.launch.serve import SERVE_GEOMETRY, build_engine
    from repro_torch.models.transformer import build_model

    cfg = get_arch("xlstm-350m")
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    geom = SERVE_GEOMETRY[cfg.name]
    prompts = [rng.integers(0, cfg.vocab_size, XLSTM_PROMPT) for _ in range(N_REQUESTS)]
    kw = dict(mesh_shape=(1, G), prefill_len=XLSTM_PROMPT, cache_len=XLSTM_PROMPT + OUTPUT,
              max_batch=MAX_BATCH, dtype=torch.bfloat16, device="cuda", geom_kwargs=geom)
    eng, model = build_engine(cfg, seed=0, **kw)
    label = f"{cfg.name} {XLSTM_PROMPT}"
    t0 = time.perf_counter()
    eng.warmup()
    warm = captures(eng)
    warm_s = time.perf_counter() - t0
    registry.reset_launch_counts()
    t0 = time.perf_counter()
    outputs = serve(eng, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    summary = eng.metrics.summary(horizon=eng.horizon())
    counts = {k: v for k, v in registry.launch_counts().items() if v}
    if captures(eng) != warm:
        fail(f"{label}: serving captured new variants: {warm} after warmup, {captures(eng)}")
    if summary["completed"] != len(prompts):
        fail(f"{label}: {summary['completed']} of {len(prompts)} requests completed")
    for rid, toks in outputs.items():
        if len(toks) != OUTPUT or not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"{label} request {rid}: bad tokens {toks}")
    # the eager serve of the first two requests (an eager prefill costs ~2.5 s)
    eager, _ = build_engine(cfg, params=eng.params, graphs=False, **kw)
    eager_outputs = serve(eager, prompts[:XLSTM_EAGER])
    eager_ttft = eager.metrics.summary(horizon=eager.horizon())["ttft_p50_s"]
    print(f"{label}: graph tokens {outputs}\n{label}: eager tokens {eager_outputs}")
    if eager_outputs != {i: outputs[i] for i in range(XLSTM_EAGER)}:
        fail(f"{label}: the eager serve gave other tokens than the graph serve")
    del eager

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def zeroed(state):
        """The state with every layer's tensors zero: the prefill's dropped."""
        return {**state, "layers": map_leaves([state["layers"]], torch.zeros_like)[0]}

    v, nxt = cfg.vocab_size, outputs[0][0]  # every run decodes the served first token
    # the served path, replayed: prompts[0]'s prefill, then one decode step of
    # nxt from its captured state and one from a zeroed state
    gen, params = eng.gen, eng.params
    (_, state), prefill_replay_s = timed(lambda: eng.ctx.prefill(params, prompts[0]))
    bf = [eng.ctx.step.outputs["last_logits"][0, :v].float().cpu()]
    slot = gen.free_slots()[0]
    for st in (state, zeroed(state)):
        gen.admit(slot, 10_000, nxt, st)
        gen.decode_step(params)
        bf.append(gen.step.outputs["logits"][slot, :v].float().cpu())
    gen.release(slot)
    del state
    sizes = {"data": 1, "model": G}
    cache_len = XLSTM_PROMPT + OUTPUT

    def run(m, params, device):
        """The same prefill (timed) and decode step, eagerly, on ``m``."""
        xp = strategy.make_execution_plan(m, InputShape("p", XLSTM_PROMPT, 1, "prefill"), sizes)
        toks = torch.as_tensor(prompts[0][None], device=device)
        out, s = timed(lambda: execution.forward_prefill(
            params, toks, execution.Ctx(model=m, xp=xp, capture_len=cache_len)))
        xpd = strategy.make_execution_plan(m, InputShape("g", cache_len, 1, "decode"), sizes)
        dec = execution.forward_decode(params, torch.tensor([[nxt]], device=device),
                                       out["state"], execution.Ctx(model=m, xp=xpd))
        return [out["last_logits"][0, :v].float().cpu(), dec["logits"][0, :v].float().cpu()], s

    with in_pool(eng):
        m32 = build_model(cfg, sizes, dtype=torch.float32, device="cuda", **geom)
        p32 = map_leaves(eng.params, lambda t: t.float())
        f32, prefill_fp32_s = run(m32, p32, "cuda")
    del p32
    m_cpu = build_model(cfg, sizes, dtype=torch.float32, device="cpu", **geom)
    p_cpu = map_leaves(eng.params, lambda t: t.cpu().float())
    t0 = time.perf_counter()
    cpu, _ = run(m_cpu, p_cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    del p_cpu
    errs = {}
    for i, step in enumerate(("prefill", "decode")):
        errs[f"{step}_bf16_vs_fp32"] = logit_err(
            f"{label} {step} logits, bf16 served (graph) vs fp32 (card)", bf[i], f32[i],
            XLSTM_BF16_TOL)
        e32 = ((f32[i] - cpu[i]).abs().max() / cpu[i].abs().max()).item()
        print(f"{label} {step} logits fp32 card vs fp32 CPU: max err / max|ref| {e32:.3e} "
              f"(tol {FP32_LOGIT_TOL})")
        if e32 > FP32_LOGIT_TOL:
            fail(f"{label} {step}: fp32 logits on the card and the CPU disagree: {e32:.3e}")
        errs[f"{step}_fp32_card_vs_cpu"] = e32
    # the control: a decode step that lost the prefill's state must fail the limit
    ctl = (torch.linalg.vector_norm(bf[2] - f32[1]) / torch.linalg.vector_norm(f32[1])).item()
    print(f"{label} control, bf16 decode step from a zeroed state vs fp32 from the prefill's: "
          f"norm-wise rel err {ctl:.3e} (must exceed {XLSTM_BF16_TOL})")
    if not ctl > XLSTM_BF16_TOL:
        fail(f"{label}: XLSTM_BF16_TOL {XLSTM_BF16_TOL} passes a decode step whose state was "
             f"dropped ({ctl:.3e})")
    errs["control_zeroed_state_bf16_vs_fp32"] = ctl
    peak = torch.cuda.max_memory_allocated()
    print(f"{label} ({card_line()}): serve {json.dumps(summary)} wall_s {wall:.3f} warmup_s "
          f"{warm_s:.2f} captures {list(warm)} prefill of {XLSTM_PROMPT} tokens: graph replay "
          f"{prefill_replay_s:.3f} s, eager serve TTFT p50 {eager_ttft:.3f} s, eager fp32 "
          f"{prefill_fp32_s:.3f} s (the recurrences loop over tokens); fp32 CPU prefill + decode "
          f"step {cpu_s:.2f} s; launches of the port's kernels {counts} (none on this path); "
          f"peak {peak / 1e9:.2f} GB")
    del eng, model
    free_memory()
    return {"summary": summary, "wall_s": wall, "warmup_s": warm_s, "captures": list(warm),
            "eager_ttft_p50_s": eager_ttft, "prefill_replay_s": prefill_replay_s,
            "prefill_fp32_eager_s": prefill_fp32_s, "logit_err": errs, "peak_gb": peak / 1e9,
            "launches": counts}


def grok_phase(rng) -> dict:
    """Grok-1 at full width, GROK_LAYERS of its 64 layers (8 experts of
    6144 x 32768, top-2, every layer MoE), mesh (1, G), graphs:
    GROK_PROMPT-token prompts served all-fetch as in 5 (launches of #2,
    #4, #5 and #7 measured through the replays, prefill and decode logits
    against the plain versions), then on the same weights a demand-fetch
    engine (#3 through its decode replays): the same tokens, and one decode
    step from the all-fetch serve's final state bitwise the all-fetch step.
    Landed GB per decode step and the replay ms of each are printed."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import registry
    from repro_torch.launch.serve import SERVE_GEOMETRY, build_engine

    cfg = dataclasses.replace(get_arch("grok-1-314b"), num_layers=GROK_LAYERS)
    free_memory()
    reckoned = cfg.param_count() * 2 / 1e9
    prompts = [rng.integers(0, cfg.vocab_size, GROK_PROMPT) for _ in range(N_REQUESTS)]
    kw = dict(mesh_shape=(1, G), prefill_len=GROK_PROMPT, cache_len=GROK_PROMPT + OUTPUT,
              max_batch=MAX_BATCH, dtype=torch.bfloat16, device="cuda",
              geom_kwargs=SERVE_GEOMETRY["grok-1-314b"])
    t0 = time.perf_counter()
    eng, model = build_engine(cfg, seed=0, **kw)
    torch.cuda.synchronize()
    print(f"model: {cfg.name} layers {cfg.num_layers} experts {cfg.moe.num_experts} top_k "
          f"{cfg.moe.top_k} expert d_ff {cfg.moe.d_ff} attn_shards {model.geom.attn_shards} "
          f"kv_shard {model.geom.kv_shard}; weights reckoned {reckoned:.2f} GB (bf16), allocated "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB; init {time.perf_counter() - t0:.1f} s")
    label = f"{cfg.name} {GROK_PROMPT}"
    row, outputs = serve_phase(label, cfg, eng, prompts, GROK_KERNELS)
    snap = snapshot(eng.gen)
    ref_step = snapshot_step(f"{label} all-fetch graph", eng, snap)
    params = eng.params
    del eng, model
    free_memory()
    dem, _ = build_engine(cfg, params=params, expert_fetch="demand", **kw)
    dem.warmup()
    warm = captures(dem)
    registry.reset_launch_counts()
    replays = replay_counts(dem)
    dem_outputs = serve(dem, prompts)
    launches = replay_launches(f"{label} demand", dem, replays)
    check_launches(f"{label} demand", dem, launches, registry.launch_counts())
    if captures(dem) != warm:
        fail(f"{label} demand: serving captured new variants")
    if dem_outputs != outputs:
        fail(f"{label}: the demand serve gave other tokens than the all-fetch serve")
    if launches["split_grouped_swiglu_demand"] <= 0:
        fail(f"{label} demand: the demand kernel never launched")
    step = snapshot_step(f"{label} demand graph", dem, snap)
    bitwise = torch.equal(step["logits"], ref_step["logits"])
    print(f"{label} ({card_line()}): demand tokens equal the all-fetch tokens; one decode step "
          f"bitwise {bitwise}; landed GB per decode step all {ref_step['landed_gb']:.3f} demand "
          f"{step['landed_gb']:.3f}; decode replay ms all {ref_step['replay_ms']:.3f} demand "
          f"{step['replay_ms']:.3f}; demand launches {json.dumps(launches)}")
    if not bitwise:
        fail(f"{label}: the demand decode step is not bitwise the all-fetch step")
    row.update(reckoned_gb=reckoned, demand_launches=launches,
               landed_gb={"all": ref_step["landed_gb"], "demand": step["landed_gb"]},
               replay_ms={"all": ref_step["replay_ms"], "demand": step["replay_ms"]},
               demand_bitwise=bitwise)
    del dem, params, snap
    free_memory()
    return row


def archs_phase(rng) -> dict:
    """Phase 18: RecurrentGemma-2B, xLSTM-350M and Grok-1, each with the
    launch counts set to 0 just before its serve and read just after."""
    out, seconds = {}, {}
    for name, fn in (("recurrentgemma", recurrentgemma_phase), ("xlstm", xlstm_phase),
                     ("grok", grok_phase)):
        t0 = time.perf_counter()
        out[name] = fn(rng)
        seconds[name] = time.perf_counter() - t0
    out["seconds"] = sum(seconds.values())
    print(f"phase 18 (RecurrentGemma-2B, xLSTM-350M, Grok-1): {out['seconds']:.1f} s "
          f"({', '.join(f'{k} {v:.1f}' for k, v in seconds.items())})")
    return out


def main() -> None:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"the port's sources are not beside this script ({SRC}/repro_torch missing)")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA device")
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import numpy as np

    from repro_torch.kernels import build, registry
    from repro_torch.launch.serve import build_engine

    t_start = time.perf_counter()
    laps: list = []  # (section, its start): the sections' seconds, printed at the end

    def lap(name: str) -> None:
        laps.append((name, time.perf_counter()))
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # ---- build ----------------------------------------------------------
    lap("build")
    t0 = time.perf_counter()
    report = build.build_all()
    print(f"build: {len(report)} kernel libraries compiled in {time.perf_counter() - t0:.1f} s "
          f"({sorted(report)})")
    for name, rep in sorted(report.items()):
        keep = [ln.strip() for ln in rep["ptxas"].splitlines()
                if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
        print(f"ptxas -v {name}:")
        for ln in keep:
            print(f"  {ln}")
    for name in registry.KERNELS:
        build.load(name)

    # ---- kernel checks --------------------------------------------------
    lap("kernel checks")
    cfg = r1_two_layers()
    gen = torch.Generator(device="cuda").manual_seed(0)
    results: dict = {}
    gemma_cfg = gemma_six_layers()
    cases = kernel_cases(cfg, gemma_cfg) + [("flash_attention", phase, shp)
                                            for phase, shp in flash_cases(cfg, gemma_cfg)]
    cases += arch_kernel_cases()
    for name, phase, shp in cases:
        if name == "flash_attention":
            row = run_flash_case(shp, gen)
        else:
            row = run_kernel_case(name, shp, gen)
        results.setdefault(name, {})[phase] = row
        worst_row = (f" worst row {row['max_row_rel_err']:.3e}"
                     if "max_row_rel_err" in row else "")
        plans = " ".join(f"{k} {json.dumps(v)}" for k, v in row.items() if k.startswith("plan"))
        library = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
        widened = (f" widened_bf16_ms {row['widened_bf16_ms']:.4f}"
                   if "widened_bf16_ms" in row else "")
        if "bitwise_widened_bf16" in row:
            widened += f" bitwise_widened_bf16 {row['bitwise_widened_bf16']}"
        print(f"kernel {name} {phase} {row['shape']}: rel_err {row['max_rel_err']:.3e}{worst_row} "
              f"(tol {KERNEL_TOL}) ms {row['ms']:.4f} {row['ms_range']} plain_ms "
              f"{row['plain_ms']:.4f} library_ms {library}{widened} bound_ms "
              f"{row['bound_ms']:.4f} ({row['bound_by']})"
              + (f" {plans} bitwise_repeat {row['bitwise_repeat']}" if plans else ""))
    grouped_ffn_row = grouped_ffn_case(cfg, gen)
    tile_err = check_hopper_tile(gen)
    demand_checks = check_demand_matches_grouped(cfg, gen)
    fp8_checks = check_fp8_matches_widened(cfg, gen)
    gemm_launches = drive_split_gemm(cfg, gen)

    # ---- serve ----------------------------------------------------------
    lap("serve")
    free_memory()
    rng = np.random.default_rng(0)
    # two pow2 prefill buckets: 1024 and 512 tokens, in turns
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT // (1 + i % 2)) for i in range(N_REQUESTS)]
    t0 = time.perf_counter()
    engine, model = build_engine(
        cfg, mesh_shape=(1, G), prefill_len=PROMPT, prefill_buckets=(PROMPT // 2,),
        cache_len=PROMPT + OUTPUT, max_batch=MAX_BATCH, dtype=torch.bfloat16, device="cuda",
        seed=0, geom_kwargs=GEOM,
    )
    torch.cuda.synchronize()
    print(f"model: {cfg.name} d_model {cfg.d_model} layers {cfg.num_layers} "
          f"(first_dense {cfg.moe.first_dense}) experts {cfg.moe.num_experts} "
          f"geometry {model.geom.expert_axes}/{model.geom.moe_exec} attn_shards "
          f"{model.geom.attn_shards} ffn_shards {model.geom.ffn_shards}; init "
          f"{time.perf_counter() - t0:.1f} s, weights "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB; prefill buckets "
          f"{engine.ctx.prefill_lens}")
    r1, outputs = serve_phase(f"{cfg.name} {PROMPT}", cfg, engine, prompts, ALL_FETCH_KERNELS)
    r1["isolation"] = check_isolation(cfg.name, cfg, engine, model, prompts)
    serving = serving_layer(cfg, engine, prompts)
    # the all-fetch decode state after the serve: every fetch mode's one
    # decode step starts from it
    snap = snapshot(engine.gen)
    ref_step = snapshot_step("fetch all graph", engine, snap)
    ref_logits = ref_step["logits"]  # the fetch modes' phase pops it
    params = engine.params
    del engine, model
    free_memory()

    # ---- the whole path in fp32 at reduced width: kernels vs plain ---------
    lap("the whole path in fp32 at reduced width")
    from repro_torch.configs import reduced_variant

    small_cfg = reduced_variant(cfg)
    small, _ = build_engine(
        small_cfg, mesh_shape=(1, G), prefill_len=64, cache_len=80, max_batch=MAX_BATCH,
        dtype=torch.float32, device="cuda", seed=1, geom_kwargs=GEOM,
    )
    toks = rng.integers(0, small_cfg.vocab_size, 64)
    sk = small.ctx.forward(small.params, toks)["last_logits"][:, : small_cfg.vocab_size].clone()
    st = small.ctx.forward(small.params, toks, impl="torch")["last_logits"][:, : small_cfg.vocab_size]
    fp32_err = ((sk - st).abs().max() / st.abs().max()).item()
    print(f"fp32 reduced-width prefill logits kernels vs plain: max err / max|ref| "
          f"{fp32_err:.3e} (tol {FP32_LOGIT_TOL})")
    if fp32_err > FP32_LOGIT_TOL:
        fail(f"fp32 prefill logits disagree: {fp32_err:.3e} > {FP32_LOGIT_TOL}")
    del small, sk, st

    # ---- every fetch mode on the same weights, graphs and eager -----------
    lap("every fetch mode on the same weights, graphs and eager")
    modes = serve_fetch_modes(cfg, params, prompts, outputs, r1, snap, ref_step)
    demand_launches = sum(m["graph"]["demand_launches_measured"]
                          for mode, m in modes.items() if mode in dict(FETCH_MODES))

    # ---- DeepSeek-R1 at the paper's input length, on the same weights ------
    lap("DeepSeek-R1 at the paper's input length, on the same weights")
    long_prompts = [rng.integers(0, cfg.vocab_size, LONG_PROMPT) for _ in range(LONG_REQUESTS)]
    long_eng, _ = build_engine(
        cfg, mesh_shape=(1, G), prefill_len=LONG_PROMPT, cache_len=LONG_PROMPT + OUTPUT,
        max_batch=MAX_BATCH, dtype=torch.bfloat16, device="cuda", params=params,
        geom_kwargs=GEOM,
    )
    r1_long, _ = serve_phase(f"{cfg.name} {LONG_PROMPT}", cfg, long_eng, long_prompts,
                             ALL_FETCH_KERNELS)
    del long_eng
    free_memory()

    # ---- DEP: a DWDP context server feeding a DEP generation server ---------
    lap("DEP")
    dep = dep_phase(cfg, params, prompts)
    free_memory()

    # ---- mesh (2, 4): batch-sharded prefill, serving on two data replicas ---
    lap("mesh (2, 4)")
    batch_sharded = batch_sharded_prefill(cfg, params, np.random.default_rng(24))
    context_drops = context_prefill_drops(cfg, params, prompts[0])
    ref14 = {"dep": headline(dep["summary"], dep["replay_ms"], dep["landed_gb"], dep["peak_gb"],
                             dep["eager_tpot_p50_s"])}
    for fetch in ("all", "demand"):
        g, e = modes[fetch]["graph"], modes[fetch]["eager"]
        ref14[f"dwdp_{fetch}"] = headline(g, g["replay_ms"], g["landed_gb"], g["peak_gb"],
                                          e["tpot_p50_s"])
    mesh24 = mesh24_phase(cfg, params, prompts, ref14)
    free_memory()

    # ---- gather policies: merged, ring transports, mixed tables -------------
    lap("gather policies")
    policy_rows = policies_phase(cfg, params, prompts, outputs, snap, ref_step, ref_logits, r1)

    # ---- the roofline cost model and the auto / auto-online policies --------
    lap("the roofline cost model and the auto / auto-online policies")
    auto_phase(cfg, params, prompts, outputs, snap, ref_logits,
               served_tables(modes, policy_rows))

    # ---- the validated fetch, fault injection, the degradation ladder -------
    lap("the validated fetch, fault injection, the degradation ladder")
    fault_rows = faults_phase(cfg, params, prompts, outputs, snap, ref_logits)

    # ---- the cluster model: predictor replay, re-shard, model output -------
    lap("the cluster model")
    checkpoint = checkpoint_copy(cfg, params)
    cluster = cluster_phase(cfg, params, modes["demand"]["graph"]["trace_bitmaps"],
                            modes["demand"]["graph"]["predictive_trace"]["summary"], fault_rows,
                            checkpoint)

    # ---- rank death on the live engine: the standby on the survivors -------
    lap("rank death on the live engine")
    # the phase re-shards the weights in place: it takes the last references
    held = {"params": params, "source": checkpoint}
    del params, checkpoint
    rank_death = rank_death_phase(cfg, held, rng)
    free_memory()

    # ---- R1 1024 stored in e4m3: the four fetch modes through graphs -------
    lap("R1 1024 stored in e4m3")
    fp8 = fp8_phase(cfg, prompts, modes, r1)
    rolling = {"dep": dep["rolling"]["summary"], "dwdp_all_row_local": serving["rolling"]["summary"]}
    run = {"dep": dep["summary"], "dwdp_all": modes["all"]["graph"],
           "dwdp_demand": modes["demand"]["graph"]}
    print(f"dep vs dwdp ({card}; R1 {PROMPT}; tps_per_gpu counts one card, whose {G} logical "
          f"ranks share it): engine.run, 4 requests x {OUTPUT} tokens: " + json.dumps({
              k: {m: v.get(m) for m in ("tpot_p50_s", "mean_tps_user", "tps_per_gpu")}
              for k, v in run.items()}) + f"; rolling ServingScheduler ({list(SERVING_LENS)} "
          "tokens): " + json.dumps({k: {m: v.get(m) for m in ("tpot_p50_s", "mean_tps_user",
                                                                "tps_per_gpu")}
                                    for k, v in rolling.items()}) + "; decode step replay ms "
          + json.dumps({"dep": dep["replay_ms"], "dwdp_all": modes["all"]["graph"]["replay_ms"],
                        "dwdp_demand": modes["demand"]["graph"]["replay_ms"]}))

    # ---- Gemma-3-27B: sliding-window layers, dense split kernels -----------
    lap("Gemma-3-27B")
    gemma_prompts = [rng.integers(0, gemma_cfg.vocab_size, GEMMA_PROMPT)
                     for _ in range(N_REQUESTS)]
    gemma_eng, gmodel = build_engine(
        gemma_cfg, mesh_shape=(1, G), prefill_len=GEMMA_PROMPT, cache_len=GEMMA_PROMPT + OUTPUT,
        max_batch=MAX_BATCH, dtype=torch.bfloat16, device="cuda", seed=0,
        geom_kwargs=GEMMA_GEOM,
    )
    print(f"model: {gemma_cfg.name} d_model {gemma_cfg.d_model} layers "
          f"{gemma_cfg.num_layers} windows {[s.window for g in gmodel.plan for s in g.sigs]} "
          f"attn_shards "
          f"{gmodel.geom.attn_shards} kv_shard {gmodel.geom.kv_shard} ffn_shards "
          f"{gmodel.geom.ffn_shards} vocab_pad {gmodel.geom.vocab_pad}")
    gemma, _ = serve_phase(f"{gemma_cfg.name} {GEMMA_PROMPT}", gemma_cfg, gemma_eng,
                           gemma_prompts, GEMMA_KERNELS)
    gemma["isolation"] = check_isolation(gemma_cfg.name, gemma_cfg, gemma_eng, gmodel,
                                         gemma_prompts)
    del gemma_eng, gmodel
    fleet = gemma_fleet(gemma_cfg)
    free_memory()

    # ---- RecurrentGemma-2B, xLSTM-350M, Grok-1 at full width ----------------
    lap("RecurrentGemma-2B, xLSTM-350M, Grok-1 at full width")
    archs = archs_phase(rng)

    lap("end")
    # ---- report ---------------------------------------------------------
    served = collections.Counter()
    for run in (r1, r1_long, gemma):
        served.update(run["paths"])
    print(f"paths of #2-#7 over the three serves (R1 {PROMPT}, R1 {LONG_PROMPT}, Gemma-3 "
          f"{GEMMA_PROMPT}): {json.dumps(dict(sorted(served.items())))}")
    replaces = {
        "split_grouped_swiglu": "src/repro/kernels/split_gemm/split_gemm.py:261",
        "split_stack_gemm": "src/repro/kernels/split_gemm/dense.py:92",
        "split_reduce_gemm": "src/repro/kernels/split_gemm/dense.py:183",
        "split_dense_swiglu": "src/repro/kernels/split_gemm/dense.py:308",
        "split_grouped_swiglu_demand": "src/repro/kernels/split_gemm/split_gemm.py:419",
        "split_grouped_gemm": "src/repro/kernels/split_gemm/split_gemm.py:124",
        "flash_attention": "src/repro/kernels/flash_attention/flash_attention.py:74",
    }
    # the phase each kernel's headline numbers come from
    primary = {"flash_attention": "r1_1024_last"}
    # each kernel's launches on its own path, measured through the replays:
    # the all-fetch serve, the three route-before-gather graph serves;
    # ops.split_gemm eagerly
    launches = dict(r1["launches"], split_grouped_swiglu_demand=demand_launches,
                    split_grouped_gemm=gemm_launches)
    kernels = []
    for name in registry.KERNELS:
        head = primary.get(name, "decode")
        dec = results[name][head]
        others = {ph: row for ph, row in results[name].items() if ph != head}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "launches_r1_8192": r1_long["launches"][name],
            "launches_r1_1024_dep": dep["launches"][name],
            **{f"launches_r1_1024_mesh2x4_{m}": mesh24[m]["launches"][name]
               for m in mesh24 if m != "vs_mesh1x4"},
            **{f"launches_r1_1024_batch_sharded_{k}": v["launches"].get(name, 0)
               for k, v in batch_sharded.items() if k != "peak_gb"},
            "launches_gemma3_4096": gemma["launches"][name],
            **{f"launches_r1_1024_faults_{m}_{k}": fault_rows[m][k]["launches"][name]
               for m, _ in FETCH_MODES for k in ("validated", "faults")},
            "launches_r1_1024_faults_storm": fault_rows["storm"]["launches"][name],
            "launches_r1_1024_rank_death_standby": rank_death["launches"][name],
            "launches_r1_1024_fp8": fp8["launches"].get(name, 0),
            "launches_recurrentgemma_1024": archs["recurrentgemma"]["launches"][name],
            "launches_xlstm_256": archs["xlstm"]["launches"].get(name, 0),
            "launches_grok1_1024": archs["grok"]["launches"][name],
            "launches_grok1_1024_demand": archs["grok"]["demand_launches"][name],
            "max_abs_err": dec["max_abs_err"],
            "max_rel_err": dec["max_rel_err"],
            "ms": dec["ms"],
            "ms_range": dec["ms_range"],
            "plain_ms": dec["plain_ms"],
            "bound_ms": dec["bound_ms"],
            "bound_by": dec["bound_by"],
            "library_ms": dec["library_ms"],
            "shape": dec["shape"],
            **others,
        })
        if "max_row_rel_err" in dec:
            kernels[-1].update(max_row_rel_err=dec["max_row_rel_err"], plan=dec["plan"],
                               bitwise_repeat=dec["bitwise_repeat"])
        if name == "split_grouped_swiglu_demand":
            kernels[-1]["checks"] = demand_checks
        if name == "split_grouped_gemm":
            kernels[-1]["fp8_bitwise_widened_bf16"] = fp8_checks
        if name in PLANNED:
            kernels[-1]["header"] = "src/repro_torch/kernels/csrc/split_hopper.cuh"
            kernels[-1].update({k: v for k, v in dec.items()
                                if k.startswith("plan_") or k == "bitwise_repeat"})
        if name == "split_reduce_gemm":
            kernels[-1]["hopper_tile_rel_err"] = tile_err
    predictive = modes["demand"]["graph"]["predictive_trace"]
    print(f"serving numbers ({card}; tps_per_gpu counts one card per replica, whose {G} logical "
          f"ranks share it): " + json.dumps({
              "r1_1024_rolling": serving["rolling"]["summary"],
              "r1_1024_epoch": serving["epoch"]["summary"],
              "r1_1024_slo": serving["slo"]["summary"],
              "r1_1024_engine_run": serving["engine_run"]["summary"],
              "steps": {k: serving[k]["steps"] for k in ("rolling", "epoch", "slo")},
              "landed_gb_per_decode_step": serving["rolling"]["landed_gb_per_decode_step"],
              "model_gb_per_rank_decode_step": serving["rolling"]["model_gb_per_rank_decode_step"],
              "r1_1024_predictive": predictive["summary"],
              "r1_1024_dep_rolling": dep["rolling"]["summary"],
              "r1_1024_mesh2x4": {m: r["summary"] for m, r in mesh24.items() if m != "vs_mesh1x4"},
              "r1_1024_batch_sharded_prefill": batch_sharded,
              "r1_1024_context_prefill_drops": context_drops,
              "grouped_ffn_dep_decode": grouped_ffn_row,
              "gemma3_fleet": fleet["summary"], "gemma3_fleet_assignments": fleet["assignments"],
              "r1_1024_rank_death": {k: rank_death[k] for k in (
                  "report", "seconds", "summary_before", "summary_after",
                  "summary_standby_alone", "model_seconds")}}))
    print("section seconds " + json.dumps({name: round(end - start, 1) for (name, start), (_, end)
                                           in zip(laps, laps[1:])}))
    print(f"total_s {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
