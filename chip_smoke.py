#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, each of which fails the run with a non-zero exit:

1. Device: a CUDA device must be present; prints its name and power limit.
2. Build every kernel from ``src/repro_torch/kernels/csrc`` with nvcc, one
   nvcc per source, all started together; prints the build seconds and
   the compiler's register report.
3. Each kernel against its plain PyTorch version on the card, on the
   paths' shapes and on edge cases (tie-heavy, zero-heavy and signed-zero
   rows, eta = 0, k = 1 and k = C, odd widths, unaligned rows, wide rows,
   rows wider than shared memory; for the top-k kernels also the edges of
   their design: k = 32 and 33, a candidate list that overflows, equal
   lane maxima, C < 32, fewer rows than the persistent grid, subnormal
   and +-inf rows, mostly-zero rows, one exponent): outputs must match bit
   for bit. Times each kernel, its plain version and one PyTorch library
   call that computes the same function, with CUDA events, beside the
   bandwidth bound, and prints the top-k kernels' launch geometry; times
   the top-k kernels on the largest leaf's rows as they are (copied to
   shared memory in bulk) and 4 bytes past alignment (copied by the
   lanes' plain loads). Then the cutover sweep: the loop top-k against
   the threshold top-k at C = 2560 and 1024 over k, and the largest k at
   which the loop wins; and the threshold kernel at k = 64 on rows of one
   exponent (its top-digit histogram in one bin) against random rows.
   The fused kernel: both branches bitwise against the plain version on
   the fused cases above (each of k <= 12 also at k = 20) and on the
   design's edges (k = 13, 20, 32, 33, 256,
   257 and C; a candidate list that overflows; all-zero and signed-zero
   rows; ties; subnormal and +-inf rows; eta = 0; C % 4 != 0; unaligned
   rows; row counts that leave the last block's warps spare; the widest
   row each holds); both branches timed at each bucket at the bucketed
   path's k = 10 and the topk preset's k = 20 (the median of 4 runs
   each, in turns), beside the plain version, the library call, the
   bound and the launch geometry; and the fused sweep, loop against
   threshold branch at qwen3-4b's bucket (C = 1024), k = 1 ... 33, 48,
   64, upward then downward, twice, the card's clocks sampled beside it:
   each branch's median and range, which give FUSED_LOOP_CUTOVER.
   The bf16 forms of the three kernels: both top-k kernels on bf16 rows
   (every design edge above rounded to bf16, then bf16's own: a list
   that overflows at 8 values to a 16-byte word, bf16 subnormals, k above
   the list's capacity and k = C, C % 8 != 0, rows 2 bytes past
   alignment, rows of 4, a row wider than shared memory) and the fused
   kernel's two branches with bf16 m and float32 or bf16 g (its design
   edges, eta 0 and 0.37, the widest bf16 rows, the pod sync's bucket at
   k = 10 and 20), bitwise against the plain versions, each launch
   counted under its bf16 name; each timed beside its plain version, the
   library call, its bytes bound and its float32 form on the same values
   (the top-k kernels at the pod re-select's (496345, 1024), k = 20, on a
   bf16 pod mean, and at (40960, 2560), k = 26; the fused kernel at
   qwen3-4b's (1154560, 1024) bucket), and the bf16 fused sweep there
   (loop against threshold branch over k, which gives
   FUSED_LOOP_CUTOVER_BF16). Then ``bucket_memory_step`` over bf16
   memory on qwen3-4b's gradient tree (4 layers, full width), from a
   first step's memory, with method "threshold" and "auto" (the loop
   branch at k = 10: one launch of each bf16 branch), each held bitwise
   against the plain version on the card at that bucket and the two
   bitwise equal, and on a small input the card's step bitwise the
   CPU's.
4. The bucketed path: ``train()`` of the bucketed Mem-SGD step on
   qwen3-4b at full width, depth cut to 4 layers, from the port's own
   seeded init (k = 10: the fused kernel's branch that the fused cutover
   picks, the threshold branch). Then the topk preset path
   (``SyncConfig.preset("topk", ratio=0.02)``: the packed wire, k = 20:
   the fused threshold branch too) in a 1-rank NCCL
   process group, whose gather runs through NCCL: its bytes per step, and
   the same run with the unpacked wire giving identical losses.
5. The per-leaf path (the train CLI's default): ``train()`` with
   ``bucketed=False`` on the same model, once with the default selection
   ``argmax_onehot`` (the loop top-k kernel) and once with
   ``topk_scatter`` (the threshold top-k kernel). The two runs' losses
   must be identical: the contract fixes the selection. After the first
   run, one more step keeps its own u of the embed and lm_head leaves:
   both top-k kernels bitwise against the plain version on it, and timed.
6. The same three paths on rwkv6-3b (RWKV-6 "Finch") at full width, depth
   cut to 8 layers: bucketed (its (1002500, 1024) bucket, k = 10), the
   topk preset (packed, then unpacked: identical losses) and the per-leaf
   path with ``argmax_onehot`` (22 loop launches and, for the k = 90 leaf
   above ``argmax_k_limit``, 1 threshold launch per step), each checking
   its bytes per step against the reference's accounting.
   For every path run, every launch count is zeroed just before it and
   read just after; after each path, a few more steps run under
   torch.profiler: wall and device-busy time per step, and the kernels
   that take the most device time.
7. A small input: one train step of each architecture's smoke config in
   float32 on the card and on the CPU (the plain versions) must agree, on
   the bucketed path, the topk preset and the per-leaf path; for the two
   MoE configs every layer's routing (top_i, keep) must be identical
   first (the smallest top-K probability margin is printed), then the
   gradients, and the CPU's step from the card's gradients must give the
   card's update bit for bit, so that a near-tie flip in the selection is
   told apart from a fault.
8. The single-row regime (after phase 3's cutover sweep): the top-k of
   one wide row, as ``compression.top_k`` sends a flat vector, and of
   ``blockwise_top_k``'s (nb, block) rows. ``row_topk`` (the kernel its
   "auto" method picks), and both kernels where k <= 64, bitwise against
   the plain version on random, tie-heavy and all-zero rows at (1, 2000)
   k = 1, 2, 3 (epsilon), (1, 47236) k = 10, 20, 30 (rcv1), (47, 1024)
   k = 2 (blockwise over rcv1's d) and (1, 1048576) k = 1024 (pairs
   ordered through ``write_selected``); each timed beside the plain
   version, the library call and the bound.
9. The two remaining optimizer modes of the train driver on qwen3-4b
   (after its per-leaf path): ``memsgd_momentum`` (momentum 0.9, eta
   0.05) and ``adam_compressed`` (eta 1e-3), 4 steps each on the per-leaf
   and the bucketed path, checked as the paths above (finite losses from
   near ln V, the last below the first, the kernels' launches, peak
   memory), the bucketed runs profiled.
10. The paper's logistic regression (Section 4, after the rwkv6-3b
   paths): ``make_epsilon_like(n=400000, d=2000)`` and
   ``make_rcv1_like(n=20000, d=47236)`` in float32 on the card, 80000
   (epsilon) or 20000 (rcv1) single-sample steps of
   ``memsgd_flat(top_k(k))`` per run at eta_t =
   2 / (lam (t + a)), a = d/k (epsilon, k = 1, 2, 3) and 10 d/k (rcv1,
   k = 10, 20, 30), and the SGD baseline (``identity``, a = 1), through
   ``examples/torch_logreg_paper.run_memsgd_flat`` with the weighted
   average; the sample indices drawn on the host before the loop. Each
   run's losses must be finite, the average's loss at T below ln 2 and
   below its loss at T/10; its loss after 1000 steps (the SGD baseline:
   100) must equal the same steps on the CPU (the plain versions) within
   rtol 1e-3. Prints
   each run's loss beside the baseline's, its us/step and its kernel
   launches per step.
11. The MoE family (after qwen3-4b's per-leaf path): granite-moe-3b-a800m
   (40 experts, top-8) at full width, depth cut to 8 layers, on all three
   paths as qwen3-4b's (bucketed: its (935136, 1024) bucket at k = 10;
   the same bucketed step through the ``memsgd_bucketed`` optimizer with
   method "loop" and "threshold" (each fused branch by name), then
   "auto": identical losses; the topk preset packed, then unpacked: identical
   losses; per-leaf with
   both selections: 10 loop, then 10 threshold launches per step,
   identical losses); qwen3-moe-30b-a3b (128 experts, top-8) at full
   width, depth cut to 2 layers, bucketed (its (1825280, 1024) bucket,
   1.87e9 elements) and per-leaf. Then the rest of the dense family at
   full width, per-leaf with ``argmax_onehot``, DENSE_STEPS steps each
   (qwen1.5-4b, yi-9b, granite-3-8b and musicgen-medium at 2 layers,
   internvl2-26b at 1): the loop kernel at k = 41 (C = 4096) and 61
   (C = 6144). Every run checks its bytes per step against the
   reference's accounting, and is profiled.
12. The griffin family (after the dense family): recurrentgemma-9b
   (RG-LRU, causal conv, local MQA) at full width, depth cut to 3 layers
   (rec, rec, attn), at eta 0.3 on all three paths: bucketed (its
   (2689056, 1024) bucket, 2.75e9 elements), the topk preset (packed,
   then unpacked: identical losses) and per-leaf with ``argmax_onehot``
   (27 loop launches a step, its conv_w rows of C = 4 among them), each
   checking its bytes per step and profiled.
13. The blocked attention paths (after the optimizer modes): qwen3-4b
   (4 layers) and recurrentgemma-9b (3 layers) at full width on the
   per-leaf path, batch 1 x seq 4096, 3 steps each; the attention branch
   counts, zeroed before and read after each run, must show every
   attention layer of every step on ``_flash_full`` (qwen3-4b) or
   ``_flash_windowed`` (recurrentgemma-9b, its 2048 window binding). Then
   what the two new plain-PyTorch layers cost (forward and backward: ms,
   device operations, peak memory): griffin's RG-LRU and its log-depth
   scan at the path's shape, and one qwen3-4b attention layer at seq 4096
   through the causal blocked path and the direct one. Phase 7 adds recurrentgemma-9b's smoke config at 3 layers and seq 96 (above
   its window of 64) and one ``attention`` call at seq 3072 at tiny
   widths, with and without a window, card against CPU.

14. The two-level pod sync (after phase 8): rwkv6-3b at full width, depth
   cut to 2 layers (its (496345, 1024) bucket; phase 3 holds the fused
   kernel, its level-1 select, bitwise there at k = 10 and 20 and times
   it). First its top-k launches at that shape: the calibration's
   per-shard select at k_row = 10 on random rows and the pod re-select
   at k_max = 20 on a pod mean, both top-k kernels bitwise against the
   plain version and timed beside it, the library call and the bound.
   Then 4 ranks spawned on the one card, laid out (2 pods x 2
   data) in a gloo group (NCCL refuses two ranks on one device): the
   hierarchical bucketed path on the packed wire, its pod ratios
   autotuned and its pod ks refreshed every 2 steps, 6 steps; two
   profiled steps; a probe sync (the bytes each level realized against
   ``bucketed_message_bytes(by_level=True, pod_ks=live)``, cross below the
   flat path's, mass conserved through an all-reduce within 1e-6); the
   ``pod_budgeted`` preset at a cross-pod byte budget, 4 steps; a small
   input (card vs CPU: loss 1e-5, gradients 1e-3 relative L2, then the
   4-rank sync from the card's gradients bitwise on both devices) and a constant live pod k against
   the static pod k through ``train()`` (params and memory bitwise). Then
   the chain at bf16 wire values (``value_dtype="bfloat16"``,
   threshold_onehot, autotuned, refreshed every 2 steps), 3 steps: one
   launch of the bf16 re-select kernel a step a rank (the loop at k_max =
   20), params bitwise on every rank; two probe syncs on its state
   (argmax_onehot: the float32 loop kernel on the pod mean's float32
   keys, as the reference's compiled argmax loop keeps them; topk_scatter:
   the bf16 threshold kernel), each level's realized bytes equal to the
   accounting at bf16, the update bitwise on every rank and between the
   two. Each run's losses must be finite from near ln V,
   falling and equal on every rank, its params bitwise equal on every
   rank, and its launches one fused and one re-select launch per sparse
   bucket a step (and on pod 0's ranks one calibration top-k per
   calibration). The bucket pipeline there: the ``pod_budgeted`` run
   again at overlap off and on (its chains' repack stage included),
   params and memory bitwise the overlap None run's on every rank, each
   rank's step ms printed; then ``core.selfcheck``'s
   ``overlap_selfcheck`` and ``repack_selfcheck`` on the (2, 2) layout on
   the card: every flag True.
15. The overlap pipeline (after qwen3-4b's per-leaf path): qwen3-4b at
   full width (4 layers), the per-leaf path (``argmax_onehot``) and the
   bucketed path, OVERLAP_STEPS steps each at ``SyncConfig.overlap``
   None, False and True from one cloned init, each run's launches zeroed
   before and read after: params and memory bitwise equal across the
   three; each mode's step ms (drain clock) and device busy time (a
   2-step profile after the checked run).
16. The host pipeline (after phase 8): ``core.pipeline.run_host_pipeline``
   over ``EmulatedLink``, 8 buckets of (64, 2048): encode ``row_topk`` at
   k = 64 (its kernel first held bitwise against the plain version and
   timed) + the packed encode, decode + densify, the link's latency the
   measured encode + decode time; depth 1 against depth 2, outputs
   bitwise equal, wall ms of each (3 rounds in turns), 8 launches a run.
17. Qsparse-local-SGD (after the topk preset path): qwen3-4b at full width
   (4 layers) on ``SyncConfig.preset("qsparse_local", ratio=0.01)`` (H = 4
   local steps, s = 15 levels, the packed wire, k = 10) in a 1-rank NCCL
   group, QSPARSE_STEPS steps through ``train()`` (two sync rounds): its
   bytes a sync and a step the reference's accounting, below the topk
   preset's at the same ratio, and the telemetry's bytes a step the
   amortized ones; each step call's launches read around it: a local step
   launches nothing, a sync step the fused kernel once; the losses finite
   from near ln V and the second round's mean below the first's; the
   local and sync steps' ms (the drain clock, and a round with each step
   call synchronized), a profiled round's device busy time, the peak. Then H = 1 through the accumulator
   (``buckets.accumulate_local``, the sync of it through ``grad_bufs=`` at
   eta 1.0) against the direct sync on the model's real gradients,
   QSPARSE_H1_STEPS steps from one cloned init: params and memory bit for
   bit (a sign-of-zero difference is located and reported). Then the
   quantizer on the sync's (1154560, 10) selection: on uniforms drawn on
   the CPU the card's norms, codes and dequantized values the CPU's bit
   for bit; on the card's own ``QuantNoise`` the mean of deq - vals over
   QSPARSE_DRAWS draws within 5 sigma of 0; the quantize and the
   quantized encode timed beside the float32 encode. In the pod phase
   (14), rwkv6-3b's two-level chain at POD_QUANT_H local steps and 15
   levels, POD_QUANT_STEPS steps (params bitwise on every rank, one fused
   and one re-select launch a sync step), a probe sync on its state (the
   level-2 codes identical within each pod, each level's realized bytes
   the accounting, mass conserved within 1e-5), then
   ``local_quant_selfcheck`` on the (2, 2) layout: every flag True.
18. The serving side (last): ``decode_loop`` of qwen3-4b (4 layers),
   rwkv6-3b (8) and recurrentgemma-9b (3) at full width, batch 8, a bf16
   cache of 4096 positions, a 64-token prompt teacher-forced and 64
   tokens generated: ms a step, then a profile of a few steps (device
   busy) and of the params' per-step cast to bf16 alone (its share).
   Then qwen3-4b's bucketed trainer (k = 10, W = 1) with ``emit_deltas``
   for 4 steps, every launch count zeroed before and read after the run:
   each step's delta (its bytes ``DeltaSpec.nbytes``, against the dense
   broadcast) applied to a replica and published to a ``FanoutHub`` with
   a float32 and a bf16 replica synced every step; a late joiner at log
   bound 2 (a snapshot resync); a wire checkpoint at step 4 against the
   boot params (memory cap 0.05: k = 51), restored. The float32, late
   and delta replicas and the restored params must be the trainer's bit
   for bit, the restored memory exact on its support, the bf16 replica
   under the summed transcode errors, and the launches one fused
   threshold and one loop top-k a step and one threshold top-k (the
   cap). The two top-k launches, the delta re-select on the last
   update and the memory cap on the memory, are held bitwise against the
   plain version and timed beside the library call and the bound. Last,
   each family's smoke config decodes in float32 on the card and on the
   CPU, every KV ring wrapping: logits and caches within 1e-4 of the
   largest, the greedy tokens equal past the tolerance.

Phase 3 runs the kernels at every architecture's shapes: the fused
kernel at each bucket (qwen3-4b's, rwkv6-3b's, the two MoE configs',
recurrentgemma-9b's, above 2^31 elements, and the pod sync's), the top-k
kernels at every per-leaf (rows, C, k) of each (and at griffin's rows of
C = 4 with k = 1 and 4, aligned and not), timed per per-leaf step of
each and, for rwkv6-3b and recurrentgemma-9b, over their rows narrower
than 1024 alone.

Prints each architecture's launches per kernel in each of its runs on a
``{"launches_by_arch": ...}`` line, the optimizer modes', the logistic
regression runs' and the pod sync's (by rank) on a
``{"launches_by_path": ...}`` line, then a
``{"kernels": [...]}`` line (the float32 kernels at granite-moe-3b-a800m's
shapes and launches, the bf16 forms at the pod sync's shapes with the
launches of the bf16 pod run, its topk_scatter probe and the bf16 bucket
memory's steps, and the serving run's two top-k launches at their shapes:
each kernel's count from one run, named by ``launches_from``), then the card's name and power limit, then the
result line ``{"ok": true, "device": {...}}`` last.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

# the script builds configs with the flat SyncConfig keywords, which parse
# into the grouped configs (their deprecation warning says so once each)
import warnings  # noqa: E402

warnings.filterwarnings("ignore", "flat SyncConfig keyword",
                        DeprecationWarning)

# H100 SXM published peaks (NVIDIA data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# main-path configuration: qwen3-4b at full width, depth cut to 4 layers
ARCH, N_LAYERS, BATCH, SEQ, STEPS = "qwen3-4b", 4, 4, 512, 4
RATIO, ETA = 0.01, 0.5
PATH_SHAPE, PATH_K = (1154560, 1024), 10  # its sparse bucket, k = 0.01 * 1024
# the topk preset path: the same bucket at k = round(0.02 * 1024) = 20;
# its bytes per step on the packed
# wire (the reference's bucketed_message_bytes)
TOPK_RATIO, TOPK_K, TOPK_BYTES = 0.02, 20, 124_788_768
# the second configuration: rwkv6-3b (RWKV-6 "Finch") at full width, depth
# cut to 8 layers, the same batches at the eta of the reference's own
# rwkv6-3b Mem-SGD runs (benchmarks/run.py:1532, the local-steps benchmark);
# its sparse bucket and its bytes per step on each path (the reference's
# accounting)
RWKV_ARCH, RWKV_LAYERS, RWKV_ETA = "rwkv6-3b", 8, 0.1
ETAS = {ARCH: ETA, RWKV_ARCH: RWKV_ETA}
RWKV_SHAPE = (1002500, 1024)
RWKV_BYTES = {"per-leaf": 83_927_936, "bucketed": 80_210_240,
              "topk packed": 108_280_272, "topk unpacked": 160_410_240}
# the MoE family. granite-moe-3b-a800m (40 experts, top-8) at full width,
# depth cut to 8 layers, on all three paths: the kernels line holds its
# shapes and launches. qwen3-moe-30b-a3b (128 experts, top-8) at full
# width, depth cut to 2 layers (1.87e9 parameters; its bucket is the
# largest fused launch), on the per-leaf and bucketed paths. Their sparse
# buckets and bytes per step (the reference's accounting,
# tests/test_torch_moe.py)
MOE_ARCH, MOE_LAYERS = "granite-moe-3b-a800m", 8
MOE_SHAPE = (935136, 1024)
MOE_BYTES = {"per-leaf": 74_975_232, "bucketed": 74_915_328,
             "topk packed": 101_099_168, "topk unpacked": 149_726_208}
QMOE_ARCH, QMOE_LAYERS = "qwen3-moe-30b-a3b", 2
QMOE_SHAPE = (1825280, 1024)
QMOE_BYTES = {"per-leaf": 150_251_520, "bucketed": 146_065_408}
# the rest of the dense family at full width, per-leaf path, DENSE_STEPS
# steps each: (depth, bytes per step, the reference's accounting,
# tests/test_torch_models.py). internvl2-26b keeps 1 layer: its embed and
# lm_head alone hold 1.14e9 parameters
DENSE = {"qwen1.5-4b": (2, 76_257_280), "yi-9b": (2, 69_775_360),
         "granite-3-8b": (2, 64_401_408), "internvl2-26b": (1, 121_503_744),
         "musicgen-medium": (2, 6_420_480)}
DENSE_STEPS = 3
# the MoE configs train at the eta of the reference's own MoE Mem-SGD
# runs (benchmarks/run.py:1664, its config-zoo matrix, the topk preset):
# at 0.5 granite-moe's topk preset path rose from 10.98 to 36.18 at its
# fourth step
ETAS.update({MOE_ARCH: 0.3, QMOE_ARCH: 0.3})
ETAS.update({arch: ETA for arch in DENSE})
# the griffin family: recurrentgemma-9b (RG-LRU, causal conv, local MQA)
# at full width, depth cut to 3 layers (rec, rec, attn: the least depth
# that holds every block kind; 2,753,654,784 parameters), on all three
# paths at the eta of the reference's own Mem-SGD runs of it
# (benchmarks/run.py:1607, :1664, its config-zoo matrix); its sparse
# bucket, 2,753,593,344 elements (above 2^31), and its bytes per step
# (the reference's accounting, tests/test_torch_griffin.py)
GRIFFIN_ARCH, GRIFFIN_LAYERS = "recurrentgemma-9b", 3
GRIFFIN_SHAPE = (2689056, 1024)
GRIFFIN_BYTES = {"per-leaf": 220_811_264, "bucketed": 215_370_240,
                 "topk packed": 290_663_840, "topk unpacked": 430_494_720}
ETAS[GRIFFIN_ARCH] = 0.3
# the blocked attention paths: per-leaf runs at batch 1 x seq 4096 (the
# reference's train_4k length), LONG_STEPS steps each: arch -> (depth,
# the attention branch each of its attention layers must take)
LONG = {ARCH: (N_LAYERS, "flash_full"),
        GRIFFIN_ARCH: (GRIFFIN_LAYERS, "flash_windowed")}
LONG_BATCH, LONG_SEQ, LONG_STEPS = 1, 4096, 3
# the two-level pod sync: rwkv6-3b (the reference's own pod example) at
# full width, depth cut to 2 layers (508,300,800 parameters, its sparse
# bucket (496345, 1024), 1.89 GiB a float32 copy), 4 ranks laid out (2
# pods x 2 data) on the one card in a gloo group (NCCL refuses two ranks on
# one device; gloo moves CUDA tensors through the host). Batch 4 x seq 512
# (1 a rank) at eta 0.1, k_row = 10, the pod k up to k_max = 2 * 10: the
# hierarchical bucketed path on the packed wire, autotuned, its pod ks
# refreshed every POD_REFRESH steps, POD_STEPS steps; then the
# pod_budgeted preset at a cross-pod byte budget (the accounted bytes at
# pod k POD_BUDGET_K), POD_BUDGET_STEPS steps
POD_ARCH, POD_LAYERS, POD_ETA = RWKV_ARCH, 2, 0.1
PODS, POD_DATA = 2, 2
POD_SHAPE = (496345, 1024)
POD_STEPS, POD_REFRESH, POD_BUDGET_STEPS, POD_BUDGET_K = 6, 2, 4, 8
# the small input's (smoke config, float32) sync ratio and live pod k
POD_SMALL_RATIO, POD_SMALL_K = 0.05, 5
# each architecture's depth on the card
DEPTHS = {ARCH: N_LAYERS, RWKV_ARCH: RWKV_LAYERS, MOE_ARCH: MOE_LAYERS,
          QMOE_ARCH: QMOE_LAYERS, **{a: d for a, (d, _) in DENSE.items()},
          GRIFFIN_ARCH: GRIFFIN_LAYERS}
# every sparse bucket phase 3 runs the fused kernel at, by label: (shape,
# eta); the pod sync's is its level-1 select
BUCKETS = {arch: (shape, ETAS[arch]) for arch, shape in (
    (ARCH, PATH_SHAPE), (RWKV_ARCH, RWKV_SHAPE), (MOE_ARCH, MOE_SHAPE),
    (QMOE_ARCH, QMOE_SHAPE), (GRIFFIN_ARCH, GRIFFIN_SHAPE))}
BUCKETS[f"{POD_ARCH} {POD_LAYERS}-layer pod sync"] = (POD_SHAPE, POD_ETA)
# the bf16 forms of the three kernels: the top-k kernels at the pod
# re-select's shape at bf16 wire values (k_max = 20 on a bf16 pod mean)
# and at one per-leaf width; the fused kernel held bitwise at the pod
# sync's bucket, and timed and swept at qwen3-4b's bucket, where
# bucket_memory_step launches it over bf16 memory (phase_bf16_memory), at
# the bucketed path's and the topk preset's k, with float32 g (what
# bucket_memory_step packs) and bf16 g; each timed beside its float32 form
BF16 = torch.bfloat16
BF16_TOPK_SHAPES = ((POD_SHAPE, 2 * PATH_K), ((40960, 2560), 26))
BF16_FUSED_SHAPE = PATH_SHAPE
BF16_SWEEP_KS = (1, 2, 4, 8, 10, 12, 16, 20, 26, 32, 33, 64)
# the pod phase's bf16 run (hierarchical, packed, bf16 wire values,
# threshold_onehot: its re-select is the bf16 row top-k on the bf16 pod
# mean; autotuned and refreshed every POD_REFRESH steps)
POD_BF16_STEPS = 3
# the overlap pipeline (core.pipeline): qwen3-4b's per-leaf and bucketed
# paths at SyncConfig.overlap None, False and True, OVERLAP_STEPS steps
# each from one cloned init (the paths' own STEPS: at eta 0.5 the
# bucketed run's loss rises at a fifth step, 11.86 -> 13.14, which
# run_path's falling-loss check refuses), then OVERLAP_PROFILE profiled
# steps; the pod phase's pod_budgeted run (repack on) at overlap off and
# on
OVERLAP_MODES = (None, False, True)
OVERLAP_STEPS, OVERLAP_PROFILE = STEPS, 2
# the host pipeline over an emulated link (the reference's overlap
# headline, benchmarks/run.py:1252-1311): HOST_BUCKETS buckets of
# HOST_SHAPE, each encoded (row_topk at HOST_K, the packed wire),
# shipped over core.pipeline.EmulatedLink at the measured encode + decode
# time, decoded (the densify); depth 1 against depth 2, HOST_ROUNDS timed
# rounds each, in turns
HOST_BUCKETS, HOST_SHAPE, HOST_K, HOST_ROUNDS = 8, (64, 2048), 64, 3
# Qsparse-local-SGD (phase 17): qwen3-4b's bucketed path on the
# qsparse_local preset (H = 4 local steps, s = 15 levels, the packed wire)
# at ratio 0.01 (k = 10), QSPARSE_STEPS steps (two sync rounds) in a
# 1-rank NCCL group; its bytes a sync and a step amortized, and the topk
# preset's a step at the same ratio (the reference's accounting,
# tests/test_torch_qsgd.py); H = 1 through the accumulator against the
# direct sync for QSPARSE_H1_STEPS steps; the quantizer's unbiasedness
# over QSPARSE_DRAWS draws
QSPARSE_STEPS, QSPARSE_H1_STEPS, QSPARSE_DRAWS = 8, 3, 64
QSPARSE_SYNC_BYTES, QSPARSE_STEP_BYTES = 32_423_968, 8_105_992
TOPK_BYTES_AT_RATIO = 64_751_648
# the pod phase's quantized run: rwkv6-3b's two-level chain at
# POD_QUANT_H local steps and 15 levels, POD_QUANT_STEPS steps
POD_QUANT_H, POD_QUANT_S, POD_QUANT_STEPS = 2, 15, 4
# the serving side (phase 18): each family's decode at full width (qwen3-4b
# 4 layers, rwkv6-3b 8, recurrentgemma-9b 3) at batch SERVE_BATCH against a
# bf16 cache of SERVE_MAX_LEN positions, a SERVE_PROMPT-token prompt
# teacher-forced, SERVE_GEN tokens generated; SERVE_PROFILE profiled steps.
# Then qwen3-4b's bucketed trainer (k = 10, W = 1: the delta's k' = 10)
# emitting its deltas for SERVE_STEPS steps to a replica and a fan-out hub
# (a float32 and a bf16 replica, a late joiner at log bound SERVE_LOG),
# and a wire checkpoint at its last step (memory cap 0.05: k = 51). Its
# bytes a step (the reference's accounting, tests/test_torch_delta.py)
SERVE_DECODE = {ARCH: N_LAYERS, RWKV_ARCH: RWKV_LAYERS,
                GRIFFIN_ARCH: GRIFFIN_LAYERS}
SERVE_BATCH, SERVE_MAX_LEN, SERVE_PROMPT, SERVE_GEN = 8, 4096, 64, 64
SERVE_PROFILE, SERVE_STEPS, SERVE_LOG = 4, 4, 2
SERVE_DELTA_BYTES, SERVE_MEMORY_RATIO = 64_751_680, 0.05
# the serve phase's small input: each family's smoke config in float32 on
# the card and the CPU, each KV ring wrapping: arch -> (overrides, decode
# steps, max_len)
SERVE_SMALL = {ARCH: (dict(sliding_window=8), 12, 16),
               MOE_ARCH: ({}, 8, 16), RWKV_ARCH: ({}, 10, 16),
               GRIFFIN_ARCH: (dict(n_layers=3), 70, 80)}
# the per-leaf rows narrower than this are timed on their own
NARROW_C = 1024
KERNEL_SOURCES = ("fused_memsgd", "topk_select")
TOPK_KERNELS = ("row_topk_loop", "row_topk_threshold")
SWEEP_KS = (1, 2, 4, 8, 12, 14, 16, 20, 24, 26, 32, 33, 48, 64)
# the fused sweep: every k up to 32, then the list's batches
FUSED_SWEEP_KS = tuple(range(1, 33)) + (33, 48, 64)
FUSED_SWEEP_ROUNDS = 2
# the single-row regime: (rows, C, k) of compression.top_k's (1, d) rows
# at the logistic regression's widths, blockwise_top_k's (nb, 1024) rows
# over rcv1's d, and one bounded large-k row
SINGLE_ROW_CASES = ((1, 2000, 1), (1, 2000, 2), (1, 2000, 3),
                    (1, 47236, 10), (1, 47236, 20), (1, 47236, 30),
                    (47, 1024, 2), (1, 1 << 20, 1024))
# the optimizer modes and their stepsizes: momentum 0.9 at eta 0.05 (an
# effective step eta / (1 - 0.9) = 0.5, the memsgd paths'); Adam at 1e-3:
# the reference's smoke-size rate 3e-3 (tests/test_system.py) moves each
# selected weight by 3e-3 a step, 15% of a full-width weight's scale
# (1/sqrt(2560)), and the bucketed run rose to 13.99 at its fourth step
OPT_MODES = {"memsgd_momentum": 0.05, "adam_compressed": 1e-3}
# the paper's logistic regression: (name, generator kwargs, ks, shift
# factor, steps T per run) at the examples' --full sizes. epsilon's lam
# = 1/400000 makes its first steps large (eta_0 = 2n/a), and its average
# falls below ln 2 only after ~60000 steps; rcv1's falls within 20000.
# The card is compared with the CPU over the first steps of each run,
# 1000 for Mem-SGD, 100 for the SGD baseline: its a = 1 makes the first
# steps 2n / (t + 1) long, so that a sample whose margin lies within
# float32 rounding of 0 flips its whole gradient. Another summation order
# of the gradient's dot product alone moves epsilon's baseline by ~3e-3
# at 2000 steps on the CPU (tools/logreg_rounding_cpu.py, which also gives
# the losses at the card's step sizes), and the card's by 5.3e-3 at 1000.
LOGREG_SETS = (("epsilon", dict(n=400_000, d=2_000), (1, 2, 3), 1.0, 80_000),
               ("rcv1", dict(n=20_000, d=47_236), (10, 20, 30), 10.0, 20_000))
LOGREG_CPU_STEPS = {"memsgd": 1_000, "sgd": 100}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    # float32 products in full float32 (PyTorch's default, stated here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> None:
    from repro_torch.kernels import _build

    def timed(name):
        t0 = time.perf_counter()
        path = _build.build(name)
        return path, time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        futures = {n: pool.submit(timed, n) for n in KERNEL_SOURCES}
        built = {n: f.result() for n, f in futures.items()}
    for name, (path, secs) in built.items():
        print(f"build: {name} in {secs:.2f} s -> "
              f"{os.path.relpath(path, ROOT)}")
        for line in _build.BUILD_LOGS.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas: {line.strip()}")


def launch_counts() -> dict:
    """Every kernel's launches: the fused kernel's per branch and m dtype
    ("fused_memsgd" is its float32 loop branch), and the two top-k
    kernels' per dtype (the bf16 forms' under "<name>_bf16")."""
    from repro_torch.kernels.fused_memsgd import SELECTION_LAUNCHES
    from repro_torch.kernels.topk_select import LAUNCHES

    fused = SELECTION_LAUNCHES
    return {"fused_memsgd": fused["loop"],
            "fused_memsgd_threshold": fused["threshold"],
            "fused_memsgd_bf16": fused["loop_bf16"],
            "fused_memsgd_threshold_bf16": fused["threshold_bf16"],
            **LAUNCHES}


def zero_launch_counts() -> None:
    from repro_torch.kernels.fused_memsgd import (SELECTION_LAUNCHES,
                                                  fused_memsgd_cuda)
    from repro_torch.kernels.topk_select import LAUNCHES

    fused_memsgd_cuda.launches = 0
    for counts in (SELECTION_LAUNCHES, LAUNCHES):
        for name in counts:
            counts[name] = 0


def fused_branch(k: int) -> str:
    """The launch count's name of the fused kernel's branch that a
    bucketed path ("auto") takes at ``k`` on the card (the fused cutover,
    ``FUSED_LOOP_CUTOVER["cuda"]``)."""
    from repro_torch.kernels.ops import _resolve_method
    from repro_torch.utils.platform import fused_loop_cutover

    return ("fused_memsgd"
            if _resolve_method("auto", k, "cuda", fused_loop_cutover) == "loop"
            else "fused_memsgd_threshold")


def fused_path_k(selection: str) -> int:
    """The k at which the kernels line's count of ``selection``'s branch is
    taken: that of the path whose run it comes from (fused_path_run)."""
    return TOPK_K if fused_path_run(selection) == "topk preset" else PATH_K


def fused_path_run(selection: str) -> str:
    """Which of MOE_ARCH's runs the kernels line's count of ``selection``'s
    fused branch comes from: the bucketed path (k = 10) if "auto" sends it
    there, else the topk preset's packed run (k = 20) if "auto" sends it
    there, else the memsgd_bucketed optimizer's run with the branch by
    name (k = 10)."""
    name = {"loop": "fused_memsgd", "threshold": "fused_memsgd_threshold"}
    if fused_branch(PATH_K) == name[selection]:
        return "bucketed"
    if fused_branch(TOPK_K) == name[selection]:
        return "topk preset"
    return f"memsgd_bucketed {selection}"


def card_state() -> str:
    """The card's SM clock, power draw and temperature now (nvidia-smi)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


def fused_library(m, g, eta, k):
    """One PyTorch library top-k (torch.topk + gather + scatter) computing
    the fused step (u = m + eta * g in m's dtype, eta and g rounded to
    it); a yardstick only, never called by the port. torch.topk promises
    no tie order, so it is timed, not compared."""
    from repro_torch.kernels.ref import eta_as

    u = torch.add(m, torch.mul(g.to(m.dtype), eta_as(eta, m.dtype)))
    _, idx = torch.topk(torch.abs(u), k, dim=1)
    vals = torch.gather(u, 1, idx)
    return u.scatter_(1, idx, 0.0), vals, idx


def kernel_cases(dev):
    """Yields (label, m, g, eta, k) on the card, made from seeds, one at a
    time so that only one case's tensors are alive."""
    gen = torch.Generator(device=dev)

    def randn(shape, seed):
        gen.manual_seed(seed)
        return torch.randn(shape, generator=gen, device=dev)

    for (R, C) in [(8, 64), (16, 128), (8, 1024), (24, 100), (3, 33),
                   (1, 257)]:
        for k in (1, 4, 16):
            if k <= C:
                yield (f"({R},{C}) k={k}", randn((R, C), R * C + k),
                       randn((R, C), R + C + k), 0.37, k)
    m = torch.round(randn((16, 256), 1) * 2) / 2
    g = torch.round(randn((16, 256), 2) * 2) / 2
    for k in (1, 8, 32):
        yield (f"tie-heavy halves (16,256) k={k}", m, g, 1.0, k)
    gen.manual_seed(3)
    ints = torch.randint(-3, 4, (32, 512), generator=gen, device=dev)
    yield ("tie-heavy small integers (32,512) k=24", ints.float(),
           torch.zeros((32, 512), device=dev), 1.0, 24)
    z = torch.zeros((8, 96), device=dev)
    z[:, 5], z[:, 90] = 3.0, -1.0
    yield ("zero-heavy (8,96) k=8", z, torch.zeros_like(z), 0.5, 8)
    yield ("eta=0 (13,200) k=11", randn((13, 200), 5), randn((13, 200), 6),
           0.0, 11)
    for k in (10, 64):
        yield (f"C=8192 (64,8192) k={k}", randn((64, 8192), 7),
               randn((64, 8192), 8), 0.37, k)
    yield ("C=20000 (6,20000) k=5", randn((6, 20000), 9),
           randn((6, 20000), 10), 0.37, 5)
    flat_m, flat_g = randn((8 * 1024 + 1,), 11), randn((8 * 1024 + 1,), 12)
    yield ("unaligned rows (8,1024) k=16", flat_m[1:].view(8, 1024),
           flat_g[1:].view(8, 1024), 0.37, 16)
    for i, (label, (shape, eta)) in enumerate(BUCKETS.items()):
        yield (f"{label} bucket {shape} k={PATH_K}",
               randn(shape, 13 + 2 * i) * 0.01, randn(shape, 14 + 2 * i),
               eta, PATH_K)


def fused_edges():
    """(label, m, g as float32 numpy, eta, k) at the edges of the fused
    kernel's design, made with numpy from a seed: k around the candidate
    list's bound (32) and capacity (256), k = C, a candidate list that
    overflows, all-zero and signed-zero rows, ties, subnormal and +-inf
    rows, eta = 0, C % 4 != 0, row counts that leave the last block's
    warps spare, the widest row both branches hold (their
    row and scratch fill a block's shared memory; the loop branch's wider
    row is yielded by fused_branch_cases)."""
    import numpy as np

    from repro_torch.kernels.fused_memsgd import MAX_COLS

    rng = np.random.default_rng(21)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def signs(shape):
        return np.where(rng.random(shape) < 0.5, -1.0, 1.0)

    for k in (13, 20, 32, 33, 256, 257):
        yield f"k={k} (8,1024)", f32(8, 1024), f32(8, 1024), 0.37, k
    yield "k=C (4,300) k=300", f32(4, 300), f32(4, 300), 0.37, 300
    # lane l of a warp reads the columns j with (j // 4) % 32 == l: every
    # entry of lane l above every entry of lane l + 1, so ~800 entries
    # pass the lanes' bound and the candidate list overflows
    lane = (np.arange(1024) // 4) % 32
    x = ((32 - lane) * 10.0 + rng.random((4, 1024))) * signs((4, 1024))
    for k in (10, 20):
        yield (f"lane-stratified, list overflows (4,1024) k={k}",
               x.astype(np.float32), np.zeros((4, 1024), np.float32), 1.0, k)
    z = np.zeros((6, 256), np.float32)
    z[:, 1::3] = -0.0
    yield "all-zero rows, signed zeros (6,256) k=20", z, z.copy(), 0.5, 20
    yield ("all-zero rows, signed zeros (6,256) k=10", z, z.copy(), 0.5,
           10)
    m = np.zeros((6, 256), np.float32)
    m[:, ::5] = -0.0
    m[:3, 7], m[:3, 200] = 2.0, -1.0
    yield ("mostly signed zeros (6,256) k=20", m, np.zeros_like(m), 1.0,
           20)
    yield ("tie-heavy halves (16,512) k=40", np.round(f32(16, 512) * 2) / 2,
           np.round(f32(16, 512) * 2) / 2, 1.0, 40)
    yield ("tie-heavy small integers (8,1024) k=20",
           rng.integers(-3, 4, (8, 1024)).astype(np.float32),
           np.zeros((8, 1024), np.float32), 1.0, 20)
    bits = rng.integers(1, 2**23, (6, 1024), dtype=np.uint32)
    bits |= (rng.random((6, 1024)) < 0.5).astype(np.uint32) << 31
    yield ("subnormal only (6,1024) k=10", bits.view(np.float32),
           np.zeros((6, 1024), np.float32), 1.0, 10)
    x = f32(6, 1024)
    x[0, [5, 900, 1023]] = [np.inf, -np.inf, np.inf]
    x[1, rng.choice(1024, 40, replace=False)] = np.inf * signs(40)
    yield "rows holding +-inf (6,1024) k=20", x, np.zeros_like(x), 1.0, 20
    yield "eta=0 (8,1024) k=20", f32(8, 1024), f32(8, 1024), 0.0, 20
    yield "C % 4 != 0 (6,1023) k=26", f32(6, 1023), f32(6, 1023), 0.37, 26
    yield ("spare warps (5,1024) k=10", f32(5, 1024), f32(5, 1024),
           0.37, 10)
    yield ("spare warps (30001,1024) k=20", f32(30001, 1024),
           f32(30001, 1024), 0.37, 20)
    C = MAX_COLS["threshold"]
    yield (f"widest row (2,{C}) k=300", f32(2, C), f32(2, C), 0.37, 300)


def fused_branch_cases(dev):
    """Yields (label, m, g, eta, k, branches) on the card, each case for
    both branches unless ``branches`` says otherwise: the fused kernel's
    cases (each of k <= 12 also at the topk preset's k = 20), the
    unaligned rows, the design's edges and the loop branch's widest
    row."""
    import numpy as np

    from repro_torch.kernels.fused_memsgd import MAX_COLS, SELECTIONS

    for label, m, g, eta, k in kernel_cases(dev):
        yield label, m, g, eta, k, SELECTIONS
        C = m.shape[1]
        if k <= 12 and C > 12:
            yield (label.replace(f"k={k}", f"k={min(C, TOPK_K)}"), m, g, eta,
                   min(C, TOPK_K), SELECTIONS)
    for label, m, g, eta, k in fused_edges():
        yield label, torch.from_numpy(m).to(dev), torch.from_numpy(g).to(
            dev), eta, k, SELECTIONS
    C = MAX_COLS["loop"]
    rng = np.random.default_rng(23)
    m, g = (torch.from_numpy(rng.standard_normal((2, C)).astype(np.float32))
            .to(dev) for _ in range(2))
    yield f"widest loop row (2,{C}) k=300", m, g, 0.37, 300, ("loop",)


def fused_plan_text(selection: str, rows: int, cols: int,
                    m_dtype=torch.float32, g_dtype=torch.float32) -> str:
    """The fused kernel's launch geometry for an (rows, cols) input."""
    from repro_torch.kernels.fused_memsgd import launch_geometry

    g = launch_geometry(selection, rows, cols, torch.device("cuda", 0),
                        m_dtype, g_dtype)
    return (f"{selection} {g.blocks} blocks x {g.warps_per_block} warps, "
            f"{g.smem_bytes} B shared memory per block, {g.warps_per_sm} "
            f"warps per SM")


def bucket_inputs(dev, gen, i, shape):
    """The i-th bucket's (m, g), made from a seed on the card."""
    gen.manual_seed(13 + 2 * i)
    m = torch.randn(shape, generator=gen, device=dev) * 0.01
    gen.manual_seed(14 + 2 * i)
    return m, torch.randn(shape, generator=gen, device=dev)


def phase_fused(dev) -> list:
    """The fused kernel's two branches: bitwise against the plain version
    on every case of fused_branch_cases; then both branches timed at each
    configuration's bucket (the bucketed path's k = 10 and the topk
    preset's k = 20) beside the plain version, the library call, the bound
    and the launch geometry; and the fused sweep (loop against threshold
    branch at C = 1024 over k). Returns the branches' entries of the
    kernels line, at the kernels line's (MOE_ARCH's) bucket, each at the
    k of the path that takes it (fused_path_k)."""
    from repro_torch.kernels.fused_memsgd import SELECTIONS, fused_memsgd_cuda
    from repro_torch.kernels.ref import fused_memsgd_ref
    from repro_torch.utils.platform import fused_loop_cutover

    worst = {sel: 0.0 for sel in SELECTIONS}
    bad = []
    n = collections.Counter()
    for label, m, g, eta, k, branches in fused_branch_cases(dev):
        want = fused_memsgd_ref(m, g, eta, k)
        verdicts = []
        for sel in branches:
            got = fused_memsgd_cuda(m, g, eta, k, sel)
            torch.cuda.synchronize()
            ok = all(same_bits(a, b) for a, b in zip(got, want))
            err = max(float((a - b).abs().max()) if a.numel() else 0.0
                      for a, b in zip(got[:2], want[:2]))
            worst[sel] = max(worst[sel], err)
            n[sel] += 1
            verdicts.append(f"{sel} {'bitwise equal' if ok else 'MISMATCH'}"
                            f" (max |err| {err:g})")
            if not ok:
                bad.append(f"{sel} {label}")
            del got
        print(f"  fused_memsgd {label}: {'; '.join(verdicts)}")
        del m, g, want
    if bad:
        fail(f"fused_memsgd differs from its plain version on {bad}")
    print(f"  fused_memsgd: {dict(n)} cases bitwise equal (by branch)")
    torch.cuda.empty_cache()

    # both branches at each configuration's bucket, in turns, at the
    # bucketed path's k = 10 and the topk preset's k = 20: the median of 4
    # runs each (a pair's first run can be cold)
    gen = torch.Generator(device=dev)
    entries = {}
    for i, (arch, (shape, eta)) in enumerate(BUCKETS.items()):
        m, g = bucket_inputs(dev, gen, i, shape)
        R, C = shape
        print(f"  fused_memsgd {arch} {shape}: "
              f"{'; '.join(fused_plan_text(s, R, C) for s in SELECTIONS)}")
        for k in (PATH_K, TOPK_K):
            t = collections.defaultdict(list)
            for sel in ("threshold", "loop", "loop", "threshold") * 2:
                t[sel].append(cuda_ms(
                    lambda: fused_memsgd_cuda(m, g, eta, k, sel), iters=10,
                    warmup=2))
            plain_ms = cuda_ms(lambda: fused_memsgd_ref(m, g, eta, k),
                               iters=3)
            library_ms = cuda_ms(lambda: fused_library(m, g, eta, k),
                                 iters=3)
            nbytes = 3 * R * C * 4 + R * k * 8
            byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
            op_ms = 2 * R * C / F32_FLOPS_PER_S * 1e3
            bound_ms = max(byte_ms, op_ms)
            med = {sel: statistics.median(ts) for sel, ts in t.items()}
            print(f"  fused_memsgd {arch} {shape} k={k}: threshold branch "
                  f"{' / '.join(f'{x:.4f}' for x in t['threshold'])} ms "
                  f"(median {med['threshold'] / bound_ms:.3f}x bound), loop "
                  f"branch {' / '.join(f'{x:.4f}' for x in t['loop'])} ms "
                  f"(median {med['loop'] / bound_ms:.3f}x bound), plain "
                  f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({nbytes} bytes)")
            for sel in SELECTIONS:
                if arch != MOE_ARCH or fused_path_k(sel) != k:
                    continue
                entries[sel] = {
                    "ms": med[sel], "plain_ms": plain_ms,
                    "bound_ms": bound_ms,
                    "bound_by": "bytes" if byte_ms >= op_ms else "operations",
                    "library_ms": library_ms}
        del m, g
        torch.cuda.empty_cache()

    # the fused sweep: loop against threshold branch at qwen3-4b's bucket
    # (C = 1024, the buckets' width), in turns at each k (loop, threshold,
    # threshold, loop; then the other way round), over k upward and then
    # downward, FUSED_SWEEP_ROUNDS times, so that the card's drift over a
    # long load (its clocks, sampled before and after each pass) falls on
    # every k and branch alike; each branch's median run and its range
    m, g = bucket_inputs(dev, gen, 0, PATH_SHAPE)
    tk = {k: collections.defaultdict(list) for k in FUSED_SWEEP_KS}
    for rnd in range(FUSED_SWEEP_ROUNDS):
        first, second = SELECTIONS if rnd % 2 == 0 else SELECTIONS[::-1]
        for ks in (FUSED_SWEEP_KS, FUSED_SWEEP_KS[::-1]):
            print(f"  fused sweep pass starts: {card_state()}")
            for k in ks:
                for sel in (first, second, second, first):
                    tk[k][sel].append(cuda_ms(
                        lambda: fused_memsgd_cuda(m, g, ETA, k, sel),
                        iters=10, warmup=2))
            print(f"  fused sweep pass ends: {card_state()}")
    del m, g
    torch.cuda.empty_cache()
    cut = fused_loop_cutover("cuda")
    for k, t in tk.items():
        med = {sel: statistics.median(t[sel]) for sel in SELECTIONS}
        win = min(SELECTIONS, key=med.get)
        auto = "threshold" if k > cut else "loop"
        print(f"  fused sweep {PATH_SHAPE} k={k}: loop {med['loop']:.4f} ms "
              f"({min(t['loop']):.4f}-{max(t['loop']):.4f}), threshold "
              f"{med['threshold']:.4f} ms ({min(t['threshold']):.4f}-"
              f"{max(t['threshold']):.4f}) -> {win} by "
              f"{abs(med['loop'] / med['threshold'] - 1) * 100:.2f}%; auto "
              f"takes {auto}")
    print(f"fused sweep: FUSED_LOOP_CUTOVER['cuda'] = {cut} (the loop "
          "branch for k <= it)")
    return [{
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_memsgd.cu",
        "replaces": "src/repro/kernels/fused_memsgd.py:61",
        "max_abs_err": worst[sel], **entries[sel], "ok": True,
    } for name, sel in (("fused_memsgd", "loop"),
                        ("fused_memsgd_threshold", "threshold"))]


def leaf_row_shapes(arch=ARCH, n_layers=N_LAYERS) -> collections.Counter:
    """The per-leaf path's top-k calls: (rows, C, k) of each sparse leaf
    with its column axis last and its k = k_for(C), and how many leaves
    give each, per step."""
    from repro_torch.core.distributed import SyncConfig
    from repro_torch.launch.sharding import sync_col_axes
    from repro_torch.utils.tree import tree_leaves

    shapes = full_model(arch, n_layers).param_shapes()
    sync = SyncConfig(ratio=RATIO)
    out = collections.Counter()
    for p, c in zip(tree_leaves(shapes), tree_leaves(sync_col_axes(shapes))):
        if p.numel() >= sync.dense_below:
            C = p.shape[c]
            out[(p.numel() // C, C, sync.k_for(C))] += 1
    return out


def topk_library(x, k):
    """One PyTorch library top-k (torch.topk on |x| + gather); a yardstick
    only, never called by the port. torch.topk promises no tie order, so
    it is timed, not compared."""
    _, idx = torch.topk(torch.abs(x), k, dim=1)
    return torch.gather(x, 1, idx), idx


def topk_cases(dev, leaf_shapes):
    """Yields (label, x, k) on the card, made from seeds, one at a time.
    ``leaf_shapes``: arch -> its per-leaf (rows, C, k) calls."""
    gen = torch.Generator(device=dev)

    def randn(shape, seed):
        gen.manual_seed(seed)
        return torch.randn(shape, generator=gen, device=dev)

    for (R, C) in [(8, 64), (16, 128), (24, 100), (3, 33), (1, 257),
                   (5, 77), (8, 300)]:
        for k in (1, 4, 16):
            if k <= C:
                yield f"({R},{C}) k={k}", randn((R, C), R * C + k), k
    halves = torch.round(randn((16, 256), 1) * 2) / 2
    for k in (1, 8, 32):
        yield f"tie-heavy halves (16,256) k={k}", halves, k
    gen.manual_seed(3)
    ints = torch.randint(-3, 4, (32, 512), generator=gen, device=dev).float()
    yield "tie-heavy small integers (32,512) k=24", ints, 24
    z = torch.zeros((8, 96), device=dev)
    z[:, ::3] = -0.0
    z[:, 5], z[:, 40] = 3.0, -1.0
    yield "zero-heavy, signed zeros (8,96) k=8", z, 8
    zeros = torch.zeros((4, 64), device=dev)
    zeros[:, 1::2] = -0.0
    yield "all-zero rows, signed zeros (4,64) k=10", zeros, 10
    for (R, C) in [(8, 300), (4, 33)]:
        yield f"k=C ({R},{C}) k={C}", randn((R, C), 4 + C), C
    yield "C not a multiple of 4 (6,1023) k=26", randn((6, 1023), 5), 26
    flat = randn((8 * 1024 + 1,), 6)
    yield "unaligned rows (8,1024) k=16", flat[1:].view(8, 1024), 16
    for k in (5, 200):
        yield f"C=20000 (6,20000) k={k}", randn((6, 20000), 7), k
    for k in (7, 100):
        yield (f"C=60000, wider than shared memory (3,60000) k={k}",
               randn((3, 60000), 8), k)
    i = 0
    for arch, calls in leaf_shapes.items():
        for (R, C, k_row) in sorted(calls):
            for k in (k_row, 3):
                if k <= C:
                    yield (f"{arch} per-leaf path ({R},{C}) k={k}",
                           randn((R, C), 20 + i) * 0.01, k)
            i += 1
    # griffin's conv_w rows at full width, C = 4: k = 1 (its per-leaf k)
    # and k = C, 16-byte aligned and 4 or 12 bytes past alignment (a row
    # then straddles two 16-byte words)
    flat = randn((4096 * 4 + 3,), 9)
    for off in (0, 1, 3):
        for k in (1, 4):
            yield (f"C = 4 rows (4096,4) k={k}, {4 * off} bytes past "
                   "alignment", flat[off:off + 4096 * 4].view(4096, 4), k)
    for label, x, k in design_edges():
        yield label, torch.from_numpy(x).to(dev), k


def design_edges():
    """(label, x as float32 numpy, k) at the edges of the top-k kernels'
    design: the candidate list's bound (k <= 32) and its overflow, the
    all-zero fast path, the radix digits, the persistent grid's row walk
    and the copy of unaligned rows. Made from a seed with numpy."""
    import numpy as np

    rng = np.random.default_rng(11)

    def signs(shape):
        return np.where(rng.random(shape) < 0.5, -1.0, 1.0)

    def f32(x):
        return np.ascontiguousarray(x, dtype=np.float32)

    for k in (32, 33):
        yield f"k={k} (8,2560)", f32(rng.standard_normal((8, 2560))), k
    x = rng.standard_normal((4, 2560)) * 0.1
    for r in range(4):
        x[r, rng.choice(2560, 2000, replace=False)] = 3.0 * signs(2000)
    yield "2000 equal magnitudes per row (4,2560) k=26", f32(x), 26
    # lane l of a warp reads the columns j with (j // 4) % 32 == l: every
    # entry of lane l above every entry of lane l + 1, so ~2000 entries
    # pass the lanes' bound and the candidate list overflows
    lane = (np.arange(2560) // 4) % 32
    x = ((32 - lane) * 10.0 + rng.random((4, 2560))) * signs((4, 2560))
    yield "lane-stratified, list overflows (4,2560) k=26", f32(x), 26
    x = rng.standard_normal((4, 2560)) * 0.1
    x[:, 4 * np.arange(32)] = 5.0 * signs((4, 32))
    yield "every lane's maximum equal (4,2560) k=26", f32(x), 26
    yield "C < 32 (7,20) k=5", f32(rng.standard_normal((7, 20))), 5
    yield "C = k < 32 (4,3) k=3", f32(rng.standard_normal((4, 3))), 3
    yield ("R below the grid (5,2560) k=26",
           f32(rng.standard_normal((5, 2560))), 26)
    yield ("R past the grid, not a multiple of the block (7925,1024) k=10",
           f32(rng.standard_normal((7925, 1024))), 10)
    bits = rng.integers(1, 2**23, (6, 2560), dtype=np.uint32)
    bits |= (rng.random((6, 2560)) < 0.5).astype(np.uint32) << 31
    yield "subnormal only (6,2560) k=26", bits.view(np.float32), 26
    x = rng.standard_normal((6, 2560))
    x[0, [5, 900, 2559]] = [np.inf, -np.inf, np.inf]
    x[1, rng.choice(2560, 40, replace=False)] = np.inf * signs(40)
    yield "rows holding +-inf (6,2560) k=26", f32(x), 26
    # the embed leaf at the first step, memory still zero: 4 x 512 tokens
    # touch at most 2048 of its 152064 rows (1.3%), the rest of u is zero
    # (later the memory keeps every row it has seen nonzero)
    x = np.zeros((1000, 2560))
    x[:, ::7] = -0.0
    x[rng.choice(1000, 13, replace=False)] = \
        rng.standard_normal((13, 2560)) * 0.01
    yield "embed mix, 13 of 1000 rows nonzero (1000,2560) k=26", f32(x), 26
    x = (1.0 + rng.random((8, 2560))) * signs((8, 2560))
    for k in (26, 64):
        yield f"one exponent, [1, 2) (8,2560) k={k}", f32(x), k


def plan_text(name: str, rows: int, cols: int,
              dtype=torch.float32) -> str:
    """A top-k kernel's launch geometry for an (rows, cols) input."""
    from repro_torch.kernels.topk_select import launch_geometry

    g = launch_geometry(name, rows, cols, torch.device("cuda", 0), dtype)
    form = "one row buffer per warp" if g.in_smem else "device-memory form"
    return (f"{name} {g.blocks} blocks x {g.warps_per_block} warps, {form}, "
            f"{g.smem_bytes} B shared memory per block, {g.warps_per_sm} "
            f"warps per SM")


def topk_wrappers() -> dict:
    from repro_torch.kernels.topk_select import (row_topk_loop_cuda,
                                                 row_topk_threshold_cuda)

    return {"row_topk_loop": row_topk_loop_cuda,
            "row_topk_threshold": row_topk_threshold_cuda}


def phase_topk(dev, leaf_shapes) -> list:
    """Both top-k kernels bitwise against the plain version, then their
    times per per-leaf step of each architecture (the sum over the path's
    leaves) beside the plain version's, the library call's and the bound.
    ``leaf_shapes``: arch -> its per-leaf (rows, C, k) calls. Returns the
    kernels' entries at the kernels line's (MOE_ARCH's) shapes."""
    from repro_torch.kernels.ref import row_topk_ref

    fns = topk_wrappers()
    worst = {name: 0.0 for name in TOPK_KERNELS}
    bad = []
    for label, x, k in topk_cases(dev, leaf_shapes):
        want = row_topk_ref(x, k)
        got = {name: fn(x, k) for name, fn in fns.items()}
        torch.cuda.synchronize()
        verdicts = []
        for name, out in got.items():
            ok = all(same_bits(a, b) for a, b in zip(out, want))
            err = float((out[0] - want[0]).abs().max())
            worst[name] = max(worst[name], err)
            if not ok:
                bad.append(f"{name} {label}")
            verdicts.append(f"{name} {'bitwise equal' if ok else 'MISMATCH'}"
                            f" (max |err| {err:g})")
        print(f"  top-k {label}: {'; '.join(verdicts)}")
        del x, got, want
    if bad:
        fail(f"top-k kernels differ from their plain version on {bad}")
    # a dtype no form takes raises by name on the card (float16 never
    # reaches a plain version)
    from repro_torch.kernels.fused_memsgd import fused_memsgd_cuda

    half = torch.zeros((8, 64), device=dev, dtype=torch.float16)
    for name, fn in (*fns.items(), ("fused_memsgd", lambda x, k:
                                    fused_memsgd_cuda(x, x, 0.1, k))):
        try:
            fn(half, 4)
        except TypeError as e:
            print(f"  {name} float16 on the card raises by name: {e}")
        else:
            fail(f"a float16 CUDA tensor reached {name}")

    gen = torch.Generator(device=dev)
    times = {arch: leaf_step_times(dev, gen, arch, calls, fns)
             for arch, calls in leaf_shapes.items()}
    # the rows' copy into shared memory: 16-byte aligned rows come by bulk
    # copy, the same rows 4 bytes past alignment by the lanes' plain loads
    R, C, k = max(leaf_shapes[ARCH])
    gen.manual_seed(29)
    flat = torch.randn(R * C + 1, generator=gen, device=dev) * 0.01
    views = {"aligned": flat[:-1].view(R, C), "offset": flat[1:].view(R, C)}
    for name, fn in fns.items():
        got = {}
        for _ in range(2):  # in turns: aligned, offset, aligned, offset
            for v, x in views.items():
                got.setdefault(v, []).append(
                    cuda_ms(lambda: fn(x, k), iters=10, warmup=2))
        print(f"  {name} ({R},{C}) k={k}, rows' copy: "
              + ", ".join(f"{v} " + " / ".join(f"{t:.4f}" for t in ts)
                          + " ms" for v, ts in got.items()))
    del flat, views
    torch.cuda.empty_cache()
    out = []
    for name, line in zip(TOPK_KERNELS, ("285", "315")):
        t, bound_ms, bound_by = times[MOE_ARCH]["all"][name]
        out.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/topk_select.cu",
            "replaces": f"src/repro/kernels/topk_select.py:{line}",
            "max_abs_err": worst[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": t["library_ms"], "ok": True,
        })
    return out


def leaf_step_times(dev, gen, arch, calls, fns) -> dict:
    """Each top-k kernel's time per per-leaf step of ``arch`` (the sum over
    its sparse leaves, each at its own (rows, C, k), on random rows) beside
    the plain version's, the library call's and the bound; the same over
    the rows narrower than NARROW_C alone. Returns {"all", "narrow"} ->
    kernel -> (times, bound ms, bound by)."""
    from repro_torch.kernels.ref import row_topk_ref

    sums = {part: {name: collections.Counter() for name in TOPK_KERNELS}
            for part in ("all", "narrow")}
    work = {part: collections.Counter() for part in ("all", "narrow")}
    for i, ((R, C, k), n) in enumerate(sorted(calls.items())):
        gen.manual_seed(30 + i)
        x = torch.randn((R, C), generator=gen, device=dev) * 0.01
        plain_ms = cuda_ms(lambda: row_topk_ref(x, k), iters=2)
        library_ms = cuda_ms(lambda: topk_library(x, k), iters=3)
        parts = ("all", "narrow") if C < NARROW_C else ("all",)
        line = []
        for name, fn in fns.items():
            ms = cuda_ms(lambda: fn(x, k), iters=10, warmup=2)
            for part in parts:
                sums[part][name].update(ms=n * ms, plain_ms=n * plain_ms,
                                        library_ms=n * library_ms)
            line.append(f"{name} {ms:.4f} ms")
        for part in parts:
            # each row read once, k (value, index) pairs written; one
            # magnitude compare per element
            work[part].update(bytes=n * (R * C * 4 + R * k * 8),
                              ops=n * R * C, launches=n)
        print(f"  {arch} top-k ({R},{C}) k={k} x{n} per step: "
              f"{', '.join(line)}, plain {plain_ms:.4f} ms, library "
              f"{library_ms:.4f} ms; "
              f"{'; '.join(plan_text(name, R, C) for name in fns)}")
        del x
        torch.cuda.empty_cache()
    out = {}
    for part, what in (("all", "per per-leaf step"),
                       ("narrow", f"rows narrower than {NARROW_C}")):
        w = work[part]
        if not w:
            continue
        byte_ms = w["bytes"] / HBM_BYTES_PER_S * 1e3
        op_ms = w["ops"] / F32_FLOPS_PER_S * 1e3
        bound_by = "bytes" if byte_ms >= op_ms else "operations"
        out[part] = {}
        for name in TOPK_KERNELS:
            t = sums[part][name]
            out[part][name] = (t, max(byte_ms, op_ms), bound_by)
            print(f"  {arch} {name} {what} ({w['launches']} launches): "
                  f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
                  f"library {t['library_ms']:.4f} ms, bound "
                  f"{max(byte_ms, op_ms):.4f} ms ({w['bytes']} bytes, "
                  f"{bound_by})")
    return out


def phase_cutover(dev) -> None:
    """Loop against threshold top-k over k at two row widths, on ~420 MB
    of rows each; prints the largest k up to which the loop wins at every
    swept k (the candidate for TOPK_LOOP_CUTOVER["cuda"])."""
    from repro_torch.utils.platform import topk_loop_cutover

    fns = topk_wrappers()
    gen = torch.Generator(device=dev)
    wins = {}
    for C in (2560, 1024):
        R = 40960 * 2560 // C
        gen.manual_seed(C)
        x = torch.randn((R, C), generator=gen, device=dev)
        print(f"  cutover ({R},{C}): "
              f"{'; '.join(plan_text(name, R, C) for name in fns)}")
        last, streak = 0, True
        for k in SWEEP_KS:
            # in turns (loop, threshold, threshold, loop): each the mean
            t = collections.Counter()
            for name in TOPK_KERNELS + TOPK_KERNELS[::-1]:
                t[name] += cuda_ms(lambda: fns[name](x, k), iters=10) / 2
            loop, thr = t["row_topk_loop"], t["row_topk_threshold"]
            streak = streak and loop < thr
            if streak:
                last = k
            winner = "loop" if loop < thr else "threshold"
            print(f"  cutover ({R},{C}) k={k}: loop {loop:.4f} ms, "
                  f"threshold {thr:.4f} ms -> {winner}")
        wins[C] = last
        if C == 2560:
            # the threshold kernel's top-digit histogram (k > 32) over rows
            # whose magnitudes share one exponent: every count lands in
            # one bin, against random rows' few
            one = ((1.0 + torch.rand((R, C), generator=gen, device=dev))
                   * torch.randn((R, C), generator=gen, device=dev).sign())
            fn = fns["row_topk_threshold"]
            ms = [cuda_ms(lambda: fn(z, 64), iters=10)
                  for z in (x, one, one, x)]
            print(f"  threshold ({R},{C}) k=64, random rows "
                  f"{ms[0]:.4f} / {ms[3]:.4f} ms, one exponent "
                  f"{ms[1]:.4f} / {ms[2]:.4f} ms")
            del one
        del x
        torch.cuda.empty_cache()
    print(f"cutover: the loop wins at every swept k up to {wins} (by C), "
          f"{min(wins.values())} at both widths; TOPK_LOOP_CUTOVER['cuda'] "
          f"= {topk_loop_cutover('cuda')}")


def step_clock(printer=print):
    """The train loop's telemetry sink, stamping the host clock as each
    step's loss is drained (one step late, so after the step ran)."""
    from repro_torch.utils.telemetry import Telemetry

    class StepClock(Telemetry):
        def __init__(self):
            super().__init__(printer=printer)
            self.times = []

        def step(self, i, loss, **kw):
            rec = super().step(i, loss, **kw)
            self.times.append(time.perf_counter())
            return rec

    return StepClock()


def run_path(label, model, tc, dev, expect: dict, steps: int = STEPS,
             batch: int = BATCH, seq: int = SEQ, params=None):
    """One path's run through ``train()`` for ``steps`` steps of batch x
    seq tokens from the seeded init (or ``params``, updated in place):
    every launch count zeroed just
    before, read just after, and checked against ``expect`` (kernel ->
    launches; every other kernel 0). Fails unless the losses are finite
    from near ln V, the last below the first, and every parameter moved
    somewhere. Returns (losses, counts, params, memory, batches)."""
    from repro_torch.data import DeviceBatcher, token_batches
    from repro_torch.launch.train import train
    from repro_torch.utils.tree import tree_leaves

    cfg = model.cfg
    if params is None:
        params = model.init(seed=0, device=dev)
    before = [p.clone() for p in tree_leaves(params)]
    batches = DeviceBatcher(
        token_batches(cfg.vocab_size, batch, seq, seed=0), dev)
    tel = step_clock()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    params, memory, _, count, _ = train(
        model, tc, batches, steps, device=dev, params=params, log_every=1,
        telemetry=tel)
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = tel.losses
    # a loss is drained once the NEXT step is issued, so each interval
    # between drains inside the loop is one step; the last drain, after
    # the loop, only waits out the final step's tail and is left out
    step_ms = [1e3 * (b - a) for a, b in zip(tel.times, tel.times[1:-1])]
    changed = sum(int((a != b).sum())
                  for a, b in zip(before, tree_leaves(params)))
    del before
    print(f"{label}: losses {losses}; step ms after the first {step_ms} "
          f"(mean {sum(step_ms) / len(step_ms):.2f}); peak memory "
          f"{peak / 2**30:.2f} GiB; launches {counts}; "
          f"{changed} parameter entries changed")
    lnv = math.log(cfg.vocab_size)
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        fail(f"{label}: expected {steps} finite losses, got {losses}")
    if not lnv - 1 <= losses[0] <= lnv + 2:
        fail(f"{label}: first loss {losses[0]} outside [ln V - 1, ln V + 2] "
             f"= [{lnv - 1:.3f}, {lnv + 2:.3f}]")
    if not losses[-1] < losses[0]:
        fail(f"{label}: the loss did not fall in {steps} steps: {losses}")
    want = {name: expect.get(name, 0) for name in counts}
    if counts != want:
        fail(f"{label}: launches {counts} in {steps} steps, expected {want}")
    if count != steps or changed == 0:
        fail(f"{label}: count {count}, {changed} parameter entries changed")
    return losses, counts, params, memory, batches


def full_model(arch=ARCH, n_layers=N_LAYERS):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    return build_model(get_config(arch).replace(n_layers=n_layers))


def phase_bucketed(dev, arch=ARCH, n_layers=N_LAYERS, shape=PATH_SHAPE,
                   nbytes=None) -> dict:
    """The bucketed path of ``arch`` (the fused kernel's branch that the
    fused cutover picks at k = 10); returns the launches in its run."""
    from repro_torch.core.buckets import make_plan
    from repro_torch.core.distributed import SyncConfig, bucketed_message_bytes
    from repro_torch.launch.train import TrainConfig

    model = full_model(arch, n_layers)
    tc = TrainConfig(optimizer="memsgd", eta=ETAS[arch],
                     sync=SyncConfig(ratio=RATIO, bucketed=True))
    dense_sync = SyncConfig(strategy="dense", bucketed=True)
    plan = make_plan(model.param_shapes(), cols=tc.sync.bucket_cols,
                     dense_below=tc.sync.dense_below)
    sparse = [s.shape for s in plan.buckets if s.kind == "sparse"]
    wire = bucketed_message_bytes(tc.sync, plan)
    print(f"bucketed path: {arch} {n_layers} layers at full width, "
          f"{model.n_params()} params, buckets "
          f"{[(s.kind, s.shape) for s in plan.buckets]}, k="
          f"{tc.sync.k_for(tc.sync.bucket_cols)}, batch {BATCH} x seq {SEQ}, "
          f"wire {wire} B/step (dense "
          f"{bucketed_message_bytes(dense_sync, plan)} B)")
    if sparse != [shape]:
        fail(f"{arch}: sparse buckets {sparse}, expected [{shape}]")
    if nbytes is not None and wire != nbytes:
        fail(f"{arch} bucketed path: {wire} B/step, expected {nbytes}")
    _, counts, params, memory, batches = run_path(
        f"{arch} bucketed path", model, tc, dev,
        {fused_branch(tc.sync.k_for(tc.sync.bucket_cols)):
         STEPS * len(sparse)})
    profile_steps(model, tc, params, memory, batches, dev)
    return counts


def phase_memsgd_bucketed(dev, arch=MOE_ARCH, n_layers=MOE_LAYERS) -> dict:
    """``core.memsgd.memsgd_bucketed``, the reference's bucketed Mem-SGD
    optimizer (Algorithm 1 over the bucket plan, one fused launch per
    sparse bucket a step), on ``arch`` at full width for STEPS steps with
    each fused method it takes: "loop" and "threshold" (each branch by
    name) and "auto" (the fused cutover's branch at k = 10). Every run
    starts from the seeded init on the same batches; their losses must be
    finite from near ln V, falling and identical. Every launch count is
    zeroed just before each run and read just after. Returns each run's
    launches, by method."""
    from repro_torch.core.memsgd import constant_eta, memsgd_bucketed
    from repro_torch.data import DeviceBatcher, token_batches
    from repro_torch.utils.tree import tree_flatten, tree_leaves

    model = full_model(arch, n_layers)
    lnv = math.log(model.cfg.vocab_size)
    losses, launches = {}, {}
    for method in ("loop", "threshold", "auto"):
        label = f"{arch} memsgd_bucketed(method={method!r})"
        params = model.init(seed=0, device=dev)
        leaves, treedef = tree_flatten(params)
        tx = memsgd_bucketed(RATIO, constant_eta(ETAS[arch]), method=method)
        state = tx.init(params)
        batches = iter(DeviceBatcher(
            token_batches(model.cfg.vocab_size, BATCH, SEQ, seed=0), dev))
        torch.cuda.synchronize()
        zero_launch_counts()
        run = []
        for _ in range(STEPS):
            live = [p.detach().requires_grad_(True) for p in leaves]
            loss, metrics = model.loss(treedef.unflatten(live), next(batches))
            grads = torch.autograd.grad(loss, live)
            del live, loss
            updates, state = tx.update(treedef.unflatten(list(grads)), state)
            del grads
            with torch.no_grad():
                for p, u in zip(leaves, tree_leaves(updates)):
                    p.add_(u.to(p.dtype))
            run.append(metrics["xent"].detach())  # the loss train() logs
            del updates, metrics
        torch.cuda.synchronize()
        counts = launch_counts()
        losses[method] = [float(x) for x in run]
        branch = {"loop": "fused_memsgd",
                  "threshold": "fused_memsgd_threshold"}.get(
                      method, fused_branch(round(RATIO * 1024)))
        want = {name: STEPS if name == branch else 0 for name in counts}
        print(f"{label}: losses {losses[method]}; launches {counts}")
        if counts != want:
            fail(f"{label}: launches {counts}, expected {want}")
        run = losses[method]
        if not (all(math.isfinite(x) for x in run)
                and lnv - 1 <= run[0] <= lnv + 2 and run[-1] < run[0]):
            fail(f"{label}: losses {run} not finite from ln V = {lnv:.3f} "
                 "and falling")
        launches[method] = counts
        del params, leaves, state, batches
        torch.cuda.empty_cache()
    if len(set(map(tuple, losses.values()))) != 1:
        fail(f"{arch} memsgd_bucketed: the methods' losses differ: {losses}")
    print(f"{arch} memsgd_bucketed: the loop, threshold and auto methods' "
          "losses are identical")
    return launches


def phase_topk_preset(dev, arch=ARCH, n_layers=N_LAYERS,
                      nbytes=None) -> dict:
    """The topk preset path (the reference's headline configuration) in a
    1-rank NCCL process group: the packed wire gathered through NCCL, the
    fused kernel's branch that the fused cutover picks at k = 20 once per
    step; then the same run on the unpacked wire must give identical
    losses. ``nbytes``: wire -> expected bytes per step. Returns the
    launches in the packed run."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.core.buckets import make_plan
    from repro_torch.core.distributed import SyncConfig, bucketed_message_bytes
    from repro_torch.launch.train import TrainConfig

    model = full_model(arch, n_layers)
    plan = make_plan(model.param_shapes())
    losses, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                                rank=0, world_size=1)
        try:
            for wire in ("packed", "unpacked"):
                sync = SyncConfig.preset("topk", ratio=TOPK_RATIO, wire=wire)
                got = bucketed_message_bytes(sync, plan)
                print(f"topk preset path, {wire} wire: {arch} {n_layers} "
                      f"layers, 1-rank {dist.get_backend()} group, k="
                      f"{sync.k_for(sync.bucket_cols)}, {got} B/step")
                want = (nbytes or {}).get(wire)
                if want is not None and got != want:
                    fail(f"{arch} topk preset, {wire} wire: {got} B/step, "
                         f"expected {want}")
                tc = TrainConfig(optimizer="memsgd", eta=ETAS[arch],
                                 sync=sync)
                losses[wire], counts, params, memory, batches = run_path(
                    f"{arch} topk preset path, {wire} wire", model, tc, dev,
                    {fused_branch(sync.k_for(sync.bucket_cols)): STEPS})
                if wire == "packed":
                    launches = counts
                    profile_steps(model, tc, params, memory, batches, dev)
                del params, memory, batches
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    if losses["packed"] != losses["unpacked"]:
        fail(f"{arch}: the packed and unpacked wires' losses differ: {losses}")
    print(f"{arch} topk preset path: the packed and unpacked wires' losses "
          "are identical")
    return launches


def qsparse_counted_steps(per_call: list):
    """A ``make_train_step`` whose step and ``step.accum`` record the
    launches each call made, ("sync" or "local", {kernel: n}), in
    ``per_call``: the launch counts are host counters, read around each
    call."""
    from repro_torch.launch import train as train_mod

    real = train_mod.make_train_step

    def wrap(fn, kind):
        def call(*args, **kwargs):
            before = launch_counts()
            out = fn(*args, **kwargs)
            after = launch_counts()
            per_call.append((kind, {n: after[n] - before[n] for n in after
                                    if after[n] != before[n]}))
            return out
        return call

    def make(*args, **kwargs):
        step = real(*args, **kwargs)
        counted = wrap(step, "sync")
        for name in ("sync", "plan", "col_axes", "layout", "pod_k_max",
                     "local_steps"):
            setattr(counted, name, getattr(step, name))
        counted.accum = wrap(step.accum, "local")
        return counted

    return real, make


def qsparse_run(model, sync, dev, fused: str, per_step: float) -> dict:
    """The qsparse_local run through ``train()`` (phase 17): QSPARSE_STEPS
    steps from the seeded init, every launch count zeroed just before and
    read just after, and each step call's launches read around it.
    Returns the run's launches."""
    from repro_torch.data import DeviceBatcher, token_batches
    from repro_torch.launch import train as train_mod
    from repro_torch.utils.tree import tree_leaves

    H = sync.local_steps
    V = model.cfg.vocab_size
    params = model.init(seed=0, device=dev)
    before = [p.clone() for p in tree_leaves(params)]
    tel = step_clock()
    per_call = []
    real, counted = qsparse_counted_steps(per_call)
    tc = train_mod.TrainConfig(optimizer="memsgd", eta=ETA, sync=sync)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    train_mod.make_train_step = counted
    try:
        params, memory, _, count, _ = train_mod.train(
            model, tc, DeviceBatcher(token_batches(V, BATCH, SEQ, seed=0),
                                     dev),
            QSPARSE_STEPS, device=dev, params=params, log_every=1,
            telemetry=tel)
    finally:
        train_mod.make_train_step = real
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = tel.losses
    # times[i] - times[i - 1]: step i, drained once step i + 1 was issued
    # (the last drain, after the loop, is left out)
    ms = {"local": [], "sync": []}
    for i in range(1, QSPARSE_STEPS - 1):
        kind = "sync" if (i + 1) % H == 0 else "local"
        ms[kind].append(round(1e3 * (tel.times[i] - tel.times[i - 1]), 2))
    changed = sum(int((a != b).sum())
                  for a, b in zip(before, tree_leaves(params)))
    del before
    rounds = [losses[j * H:(j + 1) * H] for j in range(QSPARSE_STEPS // H)]
    means = [sum(r) / len(r) for r in rounds]
    print(f"qsparse_local run: losses {losses} (round means {means}); "
          f"drain clock ms, local steps {ms['local']}, sync steps "
          f"{ms['sync']}; peak {peak / 2**30:.2f} GiB; launches {counts}; "
          f"bytes a step {tel.bytes_per_step}; {changed} parameter entries "
          "changed")
    print(f"qsparse_local run: launches by step call {per_call}")
    lnv = math.log(model.cfg.vocab_size)
    if len(losses) != QSPARSE_STEPS or not all(map(math.isfinite, losses)):
        fail(f"qsparse_local: expected {QSPARSE_STEPS} finite losses, got "
             f"{losses}")
    if not lnv - 1 <= losses[0] <= lnv + 2:
        fail(f"qsparse_local: first loss {losses[0]} outside [ln V - 1, "
             f"ln V + 2]")
    if not means[-1] < means[0]:
        fail(f"qsparse_local: the loss did not fall: round means {means}")
    want_calls = [("sync", {fused: 1}) if (i + 1) % H == 0 else ("local", {})
                  for i in range(QSPARSE_STEPS)]
    if per_call != want_calls:
        fail(f"qsparse_local: launches by step call {per_call}, expected "
             f"{want_calls} (a local step launches no kernel, a sync step "
             "the fused kernel once)")
    want = {n: QSPARSE_STEPS // H if n == fused else 0 for n in counts}
    if counts != want or count != QSPARSE_STEPS or changed == 0:
        fail(f"qsparse_local: launches {counts} (expected {want}), count "
             f"{count}, {changed} entries changed")
    if tel.bytes_per_step != {"total": per_step}:
        fail(f"qsparse_local: telemetry bytes a step {tel.bytes_per_step}, "
             f"expected {per_step}")
    qsparse_profile(model, tc, params, memory, dev)
    return counts


def qsparse_profile(model, tc, params, memory, dev) -> None:
    """After one warm round (H - 1 local steps and the sync step): a round
    with each step call synchronized and timed on the host clock (local
    and sync steps apart), then one under torch.profiler: wall and
    device-busy ms a step, and the kernels that take the most (launches
    here are not counted)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import buckets as bk
    from repro_torch.data import DeviceBatcher, token_batches
    from repro_torch.launch.train import make_train_step

    step = make_train_step(model, tc)
    H = step.local_steps
    acc = bk.init_local_accum(step.plan, device=dev)
    it = iter(DeviceBatcher(token_batches(model.cfg.vocab_size, BATCH, SEQ,
                                          seed=11), dev))
    count, opt = QSPARSE_STEPS, ()

    def one_round():
        nonlocal params, memory, acc, opt, count
        for h in range(H):
            f = step if h == H - 1 else step.accum
            params, memory, acc, opt, count, _ = f(params, memory, acc, opt,
                                                   count, next(it))

    one_round()
    torch.cuda.synchronize()
    # each step call timed on its own, synchronized before and after (the
    # drain clock gives a step the issue time of the next one)
    ms = {"local": [], "sync": []}
    for h in range(H):
        f = step if h == H - 1 else step.accum
        t0 = time.perf_counter()
        params, memory, acc, opt, count, _ = f(params, memory, acc, opt,
                                               count, next(it))
        torch.cuda.synchronize()
        ms["sync" if h == H - 1 else "local"].append(
            round(1e3 * (time.perf_counter() - t0), 2))
    print(f"qsparse_local step ms, each synchronized: local {ms['local']}, "
          f"sync {ms['sync']}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_round()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / H
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / H
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print(f"qsparse_local profile: one round of {H} steps, wall "
          f"{wall:.2f} ms/step, device busy {busy:.2f} ms/step "
          f"({100 * busy / wall:.1f}% of wall, idle "
          f"{100 * (1 - busy / wall):.1f}%)")
    for e in top:
        print(f"  {e.self_device_time_total / 1e3 / H:9.3f} ms/step "
              f"x{e.count / H:<5g} {e.key[:150]}")


def zero_sign_report(a: torch.Tensor, b: torch.Tensor) -> str:
    """Where two tensors differ in their bits: how many entries, and how
    many of those are +0.0 against -0.0."""
    diff = a.view(torch.int32) != b.view(torch.int32)
    zeros = diff & (a == 0) & (b == 0)
    first = diff.nonzero()[:3].tolist()
    return (f"{int(diff.sum())} entries differ, {int(zeros.sum())} of them "
            f"+0.0 against -0.0; first at {first}")


def qsparse_h1(model, plan, sync, dev):
    """H = 1 through the accumulator against the direct sync (phase 17):
    QSPARSE_H1_STEPS steps from one cloned init, each step's gradient
    (of the direct path's params) synced twice: directly at eta, and
    through ``init_local_accum`` + ``accumulate_local`` at eta and the
    sync of the accumulator through ``grad_bufs=`` at eta 1.0, on the same
    QuantNoise. Params and memory must stay bit for bit equal. Returns the
    sparse bucket's next selection (values) for the quantizer check."""
    from repro_torch.core import buckets as bk
    from repro_torch.core.distributed import bucketed_sync_gradients
    from repro_torch.data import DeviceBatcher, token_batches
    from repro_torch.kernels import fused_memsgd_update
    from repro_torch.launch.train import _grads
    from repro_torch.optim.qsgd import QuantNoise
    from repro_torch.utils.tree import tree_flatten, tree_leaves

    cfg = dataclasses.replace(sync, local_steps=1)
    leaves_d, treedef = tree_flatten(model.init(seed=0, device=dev))
    leaves_a = [p.clone() for p in leaves_d]
    mem_d = bk.init_bucket_memory(plan, device=dev)
    mem_a = bk.init_bucket_memory(plan, device=dev)
    it = iter(DeviceBatcher(token_batches(model.cfg.vocab_size, BATCH, SEQ,
                                          seed=3), dev))
    b = next(i for i, s in enumerate(plan.buckets) if s.kind == "sparse")
    for i in range(QSPARSE_H1_STEPS + 1):
        grads, _ = _grads(model, treedef.unflatten(leaves_d), next(it))
        g_tree = treedef.unflatten(list(grads))
        del grads
        if i == QSPARSE_H1_STEPS:
            g = bk.pack(plan, g_tree, dtype=torch.float32)[b]
            _, vals, _ = fused_memsgd_update(mem_d[b], g, ETA,
                                             cfg.k_for(cfg.bucket_cols))
            return vals
        noise = QuantNoise(0, i)
        upd, mem_d, _ = bucketed_sync_gradients(cfg, plan, mem_d, g_tree,
                                                ETA, quant_noise=noise)
        with torch.no_grad():
            for p, u in zip(leaves_d, tree_leaves(upd)):
                p.sub_(u)
        del upd
        acc = bk.accumulate_local(
            plan, bk.init_local_accum(plan, device=dev), g_tree, ETA)
        del g_tree
        upd, mem_a, _ = bucketed_sync_gradients(cfg, plan, mem_a, None, 1.0,
                                                grad_bufs=acc,
                                                quant_noise=noise)
        del acc
        with torch.no_grad():
            for p, u in zip(leaves_a, tree_leaves(upd)):
                p.sub_(u)
        del upd
        for name, xs, ys in (("params", leaves_d, leaves_a),
                             ("memory", mem_d, mem_a)):
            for j, (x, y) in enumerate(zip(xs, ys)):
                if not same_bits(x, y):
                    fail(f"H = 1 through the accumulator, step {i}: {name} "
                         f"leaf {j} differs from the direct sync's: "
                         f"{zero_sign_report(x, y)}")
        print(f"H = 1 through the accumulator, step {i}: params and memory "
              "bitwise the direct sync's")


def qsparse_quantizer(vals: torch.Tensor, dev, s: int) -> None:
    """The quantizer on the sync's (rows, k) selection (phase 17): card
    against CPU on uniforms drawn on the CPU (norms, codes and dequantized
    values bit for bit); unbiased on the card's own noise (the mean of deq
    - vals over QSPARSE_DRAWS draws and every entry within 5 sigma of 0,
    sigma from each entry's Bernoulli variance); the quantize, the
    quantized encode and the float32 encode of the same pairs timed."""
    from repro_torch.core import encoding as enc
    from repro_torch.optim.qsgd import QuantNoise, quantize_rows

    rows, k = vals.shape
    u = QuantNoise(0, 0).uniforms(0, 1, 0, vals.shape, "cpu")
    on_card = quantize_rows(vals, s, u.to(dev))
    on_cpu = quantize_rows(vals.cpu(), s, u)
    deq_card = enc.dequantize_rows(*on_card, s)
    deq_cpu = enc.dequantize_rows(*on_cpu, s)
    for name, a, b in (("norms", on_card[0], on_cpu[0]),
                       ("codes", on_card[1], on_cpu[1]),
                       ("dequantized values", deq_card, deq_cpu)):
        if not same_bits(a.cpu(), b):
            fail(f"quantizer: the card's {name} differ from the CPU's on "
                 f"the same uniforms: {zero_sign_report(a.cpu(), b)}")
    print(f"quantizer on the ({rows}, {k}) selection at s = {s}: norms, "
          "codes and dequantized values on the card bitwise the CPU's on "
          "CPU-drawn uniforms")
    total = torch.zeros((), dtype=torch.float64, device=dev)
    for i in range(QSPARSE_DRAWS):
        norms, codes = quantize_rows(vals, s, QuantNoise(1, i).uniforms(
            0, 1, 0, vals.shape, dev))
        total += (enc.dequantize_rows(norms, codes, s).double()
                  - vals.double()).sum()
    norms = on_card[0].double().unsqueeze(-1)
    r = vals.double().abs() / norms.clamp(min=1e-300) * s
    p = r - torch.floor(r)
    var = (norms / s) ** 2 * p * (1 - p)
    sigma = math.sqrt(float(var.sum()) / QSPARSE_DRAWS)
    z = float(total) / QSPARSE_DRAWS / max(sigma, 1e-300)
    print(f"quantizer unbiased on the card's noise: the sum of deq - vals "
          f"over {rows * k} entries, mean of {QSPARSE_DRAWS} draws, "
          f"{float(total) / QSPARSE_DRAWS:.4g} = {z:.3f} sigma")
    if not abs(z) < 5:
        fail(f"quantizer: mean of deq - vals at {z:.2f} sigma from 0")
    idx = torch.randint(0, 1024, vals.shape, dtype=torch.int32, device=dev)
    qspec = enc.WireSpec(rows, 1024, k, quant=s)
    fspec = enc.WireSpec(rows, 1024, k)
    norms, codes = on_card
    u = u.to(dev)
    times = {
        "quantize": cuda_ms(lambda: quantize_rows(vals, s, u), 5),
        "dequantize": cuda_ms(lambda: enc.dequantize_rows(norms, codes, s),
                              5),
        "quantized encode": cuda_ms(lambda: enc.encode(
            qspec, codes, idx, norms=norms), 5),
        "float32 encode": cuda_ms(lambda: enc.encode(fspec, vals, idx), 5)}
    print(f"quantizer timing at ({rows}, {k}), s = {s} ({card_state()}): "
          + ", ".join(f"{n} {t:.3f} ms" for n, t in times.items())
          + f"; message {qspec.nbytes} B quantized, {fspec.nbytes} B float32")


def phase_qsparse(dev) -> dict:
    """Phase 17, Qsparse-local-SGD (see the module docstring): the
    qsparse_local run in a 1-rank NCCL group, H = 1 through the
    accumulator against the direct sync, the quantizer card against CPU.
    Returns the run's launches."""
    import gc
    import tempfile

    import torch.distributed as dist

    from repro_torch.core import buckets as bk
    from repro_torch.core.distributed import (SyncConfig,
                                              amortized_bytes_per_step,
                                              bucketed_message_bytes)

    t0 = time.perf_counter()
    model = full_model()
    plan = bk.make_plan(model.param_shapes())
    sync = SyncConfig.preset("qsparse_local", ratio=RATIO)
    k = sync.k_for(sync.bucket_cols)
    per_sync = bucketed_message_bytes(sync, plan)
    per_step = amortized_bytes_per_step(sync, plan)
    topk = bucketed_message_bytes(SyncConfig.preset("topk", ratio=RATIO),
                                  plan)
    print(f"qsparse_local: {ARCH} {N_LAYERS} layers at full width, H = "
          f"{sync.local_steps}, s = {sync.quant}, k = {k}, {sync.wire} wire: "
          f"{per_sync} B a sync, {per_step} B a step; the topk preset at "
          f"ratio {RATIO}: {topk} B a step")
    if (per_sync, per_step, topk) != (QSPARSE_SYNC_BYTES, QSPARSE_STEP_BYTES,
                                      TOPK_BYTES_AT_RATIO) \
            or not per_sync < topk:
        fail(f"qsparse_local bytes {per_sync} a sync, {per_step} a step, "
             f"topk {topk}: expected {QSPARSE_SYNC_BYTES}, "
             f"{QSPARSE_STEP_BYTES}, {TOPK_BYTES_AT_RATIO}")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                                rank=0, world_size=1)
        try:
            launches = qsparse_run(model, sync, dev, fused_branch(k),
                                   per_step)
            gc.collect()
            torch.cuda.empty_cache()
            vals = qsparse_h1(model, plan, sync, dev)
        finally:
            dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    qsparse_quantizer(vals, dev, sync.quant)
    del vals
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 17 (Qsparse-local-SGD): {time.perf_counter() - t0:.1f} s")
    return launches


def selection_launches(selection, calls) -> dict:
    """Each top-k kernel's launches per per-leaf step under ``selection``
    (the reference's ``_pick_selection``: argmax_onehot runs the loop up
    to ``argmax_k_limit`` and the threshold above it, topk_scatter the
    threshold)."""
    from repro_torch.core.distributed import SyncConfig

    limit = SyncConfig().argmax_k_limit
    out = collections.Counter()
    for (_, _, k), n in calls.items():
        loop = selection == "argmax_onehot" and k <= limit
        out["row_topk_loop" if loop else "row_topk_threshold"] += n
    return dict(out)


def phase_leaf(dev, calls, arch=ARCH, n_layers=N_LAYERS,
               selections=("argmax_onehot", "topk_scatter"),
               nbytes=None, steps: int = STEPS) -> dict:
    """The per-leaf path of ``arch`` with each selection (``calls``: its
    per-leaf (rows, C, k) calls), ``steps`` steps each; returns each top-k
    kernel's launches in the selections' runs."""
    from repro_torch.core.distributed import SyncConfig, message_bytes
    from repro_torch.launch.sharding import sync_col_axes
    from repro_torch.launch.train import TrainConfig

    model = full_model(arch, n_layers)
    shapes = model.param_shapes()
    cols = sync_col_axes(shapes)
    wire = message_bytes(SyncConfig(ratio=RATIO), shapes, cols)
    print(f"per-leaf path: {arch} {n_layers} layers at full width, "
          f"{sum(calls.values())} sparse leaves {dict(calls)} (rows, C, k), "
          f"batch {BATCH} x seq {SEQ}, wire {wire} B/step (dense "
          f"{message_bytes(SyncConfig(strategy='dense'), shapes, cols)} B)")
    if nbytes is not None and wire != nbytes:
        fail(f"{arch} per-leaf path: {wire} B/step, expected {nbytes}")
    launches, losses = {}, {}
    for selection in selections:
        tc = TrainConfig(optimizer="memsgd", eta=ETAS[arch],
                         sync=SyncConfig(ratio=RATIO, selection=selection))
        expect = {name: steps * n for name, n in
                  selection_launches(selection, calls).items()}
        losses[selection], counts, params, memory, batches = run_path(
            f"{arch} per-leaf path, selection={selection}", model, tc, dev,
            expect, steps)
        launches.update({name: counts[name] for name in expect})
        if arch == ARCH and selection == "argmax_onehot":
            params, memory = step_u_topk(model, tc, params, memory, batches)
        profile_steps(model, tc, params, memory, batches, dev, count=steps)
        del params, memory, batches
        torch.cuda.empty_cache()
    if len(set(map(tuple, losses.values()))) != 1:
        fail(f"{arch}: the selections' losses differ: {losses}")
    if len(losses) > 1:
        print(f"{arch} per-leaf path: the selections' losses are identical")
    return launches


def phase_overlap(dev, calls) -> dict:
    """The overlap pipeline on qwen3-4b (4 layers, full width): the
    per-leaf path (``argmax_onehot``; ``calls``: its per-leaf (rows, C, k)
    calls) and the bucketed path, OVERLAP_STEPS steps each at
    ``SyncConfig.overlap`` None, False and True from one cloned init, each
    through ``run_path`` (launch counts zeroed before, read after, the
    losses checked). The three modes' params and memory must be bitwise
    equal; each mode's step ms (drain clock) and its device busy time
    (OVERLAP_PROFILE profiled steps after the checked run). Returns each
    run's launches."""
    from repro_torch.core.distributed import SyncConfig
    from repro_torch.launch.train import TrainConfig
    from repro_torch.utils.tree import tree_leaves, tree_map

    model = full_model()
    init = model.init(seed=0, device=dev)
    paths = {"per-leaf": (SyncConfig(ratio=RATIO), {
                 name: OVERLAP_STEPS * n for name, n in
                 selection_launches("argmax_onehot", calls).items()}),
             "bucketed": (SyncConfig(ratio=RATIO, bucketed=True), {
                 fused_branch(round(RATIO * PATH_SHAPE[1])): OVERLAP_STEPS})}
    launches, summary = {}, {}
    for path, (sync, expect) in paths.items():
        first = None
        for ov in OVERLAP_MODES:
            tc = TrainConfig(optimizer="memsgd", eta=ETA,
                             sync=dataclasses.replace(sync, overlap=ov))
            label = f"{ARCH} {path} path, overlap={ov}"
            losses, counts, params, memory, batches = run_path(
                label, model, tc, dev, expect, OVERLAP_STEPS,
                params=tree_map(torch.clone, init))
            launches[label] = counts
            # the bucketed path's memory is a tuple of buffers
            state = tree_leaves(params) + (
                list(memory) if isinstance(memory, tuple)
                else tree_leaves(memory))
            if first is None:
                # kept for the comparison; profiled once the others are
                first = (losses, state, params, memory, batches, tc)
                continue
            if losses != first[0] or not all(
                    same_bits(a, b) for a, b in zip(first[1], state)):
                fail(f"{label}: params or memory differ from overlap=None")
            summary[label] = profile_steps(model, tc, params, memory,
                                           batches, dev, OVERLAP_PROFILE,
                                           count=OVERLAP_STEPS)
            del params, memory, batches, state
            torch.cuda.empty_cache()
        losses, _, params, memory, batches, tc = first
        summary[f"{ARCH} {path} path, overlap=None"] = profile_steps(
            model, tc, params, memory, batches, dev, OVERLAP_PROFILE,
            count=OVERLAP_STEPS)
        print(f"{ARCH} {path} path: overlap None, False and True bitwise "
              f"equal (params and memory after {OVERLAP_STEPS} steps)")
        del first, params, memory, batches
        torch.cuda.empty_cache()
    for label, (wall, busy) in summary.items():
        print(f"overlap profile: {label}: wall {wall:.2f} ms/step, device "
              f"busy {busy:.2f} ms/step")
    del init
    torch.cuda.empty_cache()
    return launches


def phase_host_pipeline(dev) -> dict:
    """The host pipeline over ``pipeline.EmulatedLink``: HOST_BUCKETS
    buckets of HOST_SHAPE on the card; encode = ``row_topk`` at HOST_K
    (its "auto" kernel, held bitwise against the plain version and timed
    first) + the packed encode, decode = the decode + densify, each
    synchronised; the link's latency the measured encode + decode time
    (comm ~= compute, the regime the double buffer targets). Depth 1
    against depth 2 (``run_host_pipeline``), the outputs bitwise equal,
    HOST_ROUNDS timed rounds each in turns after a warm one; launch
    counts zeroed before each run and read after. Returns the kernel's
    numbers with its launches a run."""
    from repro_torch.core import encoding as enc
    from repro_torch.core.pipeline import (COMM, COMPUTE, EmulatedLink,
                                           run_host_pipeline)
    from repro_torch.kernels import row_topk
    from repro_torch.kernels.ops import _resolve_method

    R, C = HOST_SHAPE
    wspec = enc.WireSpec(R, C, HOST_K)
    gen = torch.Generator(device=dev)
    gen.manual_seed(61)
    bufs = [torch.randn(HOST_SHAPE, generator=gen, device=dev)
            for _ in range(HOST_BUCKETS)]
    kernel = f"row_topk_{_resolve_method('auto', HOST_K, dev)}"
    held = held_topk(bufs[0], HOST_K, "host pipeline's select")

    def encode(u):
        out = enc.encode(wspec, *row_topk(u, HOST_K))
        torch.cuda.synchronize()
        return out

    def decode_apply(buf):
        gv, gi = enc.decode(wspec, buf)
        out = torch.zeros(HOST_SHAPE, device=dev).scatter_add_(
            1, gi.to(torch.int64), gv)
        torch.cuda.synchronize()
        return out

    def per_call(fn, x, n=5):
        fn(x)
        t0 = time.perf_counter()
        for _ in range(n):
            fn(x)
        return (time.perf_counter() - t0) / n

    wire0 = encode(bufs[0])
    t_enc, t_dec = per_call(encode, bufs[0]), per_call(decode_apply, wire0)
    latency = t_enc + t_dec
    kinds = [(COMPUTE, COMM, COMPUTE)] * HOST_BUCKETS

    def run(depth):
        link = EmulatedLink(latency_s=latency)
        stages = [[encode, lambda w: link.transfer(w, wspec.nbytes),
                   decode_apply]] * HOST_BUCKETS
        torch.cuda.synchronize()
        zero_launch_counts()
        t0 = time.perf_counter()
        outs = run_host_pipeline(list(bufs), stages, kinds, depth)
        ms = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
        want = {name: 0 for name in counts}
        want[kernel] = HOST_BUCKETS
        if counts != want:
            fail(f"host pipeline at depth {depth}: launches {counts}, "
                 f"expected {want}")
        return outs, ms

    seq, _ = run(1)
    ovl, _ = run(2)
    if not all(same_bits(a, b) for a, b in zip(seq, ovl)):
        fail("host pipeline: depth 2's outputs differ from depth 1's")
    times = {1: [], 2: []}
    for r in range(HOST_ROUNDS):
        for depth in ((1, 2) if r % 2 == 0 else (2, 1)):
            times[depth].append(run(depth)[1])
    best = {d: min(t) for d, t in times.items()}
    print(f"host pipeline: {HOST_BUCKETS} buckets of {HOST_SHAPE}, k = "
          f"{HOST_K} ({kernel}, {HOST_BUCKETS} launches a run), "
          f"{wspec.nbytes} B a message; encode {t_enc * 1e3:.3f} ms + "
          f"decode {t_dec * 1e3:.3f} ms = the link's latency; wall ms "
          f"depth 1 {[round(t, 3) for t in times[1]]}, depth 2 "
          f"{[round(t, 3) for t in times[2]]}: best {best[1]:.3f} against "
          f"{best[2]:.3f} (x{best[1] / best[2]:.3f}); outputs bitwise equal")
    return {**held, "kernel": kernel, "launches": HOST_BUCKETS,
            "depth_ms": times, "latency_ms": latency * 1e3}


def step_u_topk(model, tc, params, memory, batches):
    """Both top-k kernels on the per-leaf step's own u: one more step of
    the run above (launches not counted) hands its (152064, 2560) rows,
    the embed and lm_head leaves', to the kernel as usual, and a copy of
    each is kept. On each: both kernels bitwise against the plain version,
    and their times beside the plain version's (CUDA events). Returns the
    step's params and memory."""
    from repro_torch.core import distributed
    from repro_torch.kernels.ref import row_topk_ref
    from repro_torch.launch.train import make_train_step

    captured = []
    row_topk = distributed.row_topk

    def keep(x, k, method="auto"):
        if tuple(x.shape) == (152064, 2560):
            captured.append((x.clone(), k))
        return row_topk(x, k, method=method)

    distributed.row_topk = keep
    try:
        params, memory, *_ = make_train_step(model, tc)(
            params, memory, (), STEPS, next(iter(batches)))
        torch.cuda.synchronize()
    finally:
        distributed.row_topk = row_topk
    if len(captured) != 2:
        fail(f"expected the step's two (152064, 2560) top-k inputs, got "
             f"{len(captured)}")
    fns = topk_wrappers()
    total = collections.Counter()
    for leaf, (x, k) in zip(("embed", "lm_head"), captured):
        want = row_topk_ref(x, k)
        zero_rows = int((x.abs().amax(dim=1) == 0).sum())
        line = []
        for name, fn in fns.items():
            got = fn(x, k)
            torch.cuda.synchronize()
            if not all(same_bits(a, b) for a, b in zip(got, want)):
                fail(f"{name} differs from its plain version on the "
                     f"step's {leaf} u")
            ms = cuda_ms(lambda: fn(x, k), iters=10, warmup=2)
            total[name] += ms
            line.append(f"{name} {ms:.4f} ms")
        plain_ms = cuda_ms(lambda: row_topk_ref(x, k), iters=2)
        print(f"  step's own u, {leaf} {tuple(x.shape)} k={k} "
              f"({zero_rows} all-zero rows): bitwise equal; "
              f"{', '.join(line)}, plain {plain_ms:.4f} ms")
        del x, want
    captured.clear()
    torch.cuda.empty_cache()
    print(f"  step's own u, embed + lm_head: "
          f"{', '.join(f'{n} {t:.4f} ms' for n, t in total.items())}")
    return params, memory


def profile_steps(model, tc, params, memory, batches, dev, n: int = 5,
                  opt=(), count: int = STEPS) -> tuple:
    """Where a path's step time goes: torch.profiler over ``n`` steady
    steps continuing the run above (launches here are not counted).
    Prints the wall time per step, the device's busy time per step
    (kernel time, one stream) and the kernels that take the most; returns
    (wall, busy) ms per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import take
    from repro_torch.launch.train import make_train_step

    step = make_train_step(model, tc)
    it = iter(batches)
    params, memory, opt, count, _ = step(params, memory, opt, count, next(it))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in take(it, n):
            params, memory, opt, count, _ = step(params, memory, opt,
                                                 count, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print(f"profile: {n} steps, wall {wall:.2f} ms/step, device busy "
          f"{busy:.2f} ms/step ({100 * busy / wall:.1f}% of wall, "
          f"idle {100 * (1 - busy / wall):.1f}%)")
    for e in top:
        print(f"  {e.self_device_time_total / 1e3 / n:9.3f} ms/step "
              f"x{e.count // n:<4d} {e.key[:150]}")
    return wall, busy


def single_row_inputs(dev, R, C, seed):
    """(kind, x) on the card, made from a seed: random, tie-heavy (halves)
    and all-zero rows with signed zeros."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn((R, C), generator=gen, device=dev)
    yield "random", x
    yield "tie-heavy", torch.round(x * 2) / 2
    z = torch.zeros((R, C), device=dev)
    z[:, 1::3] = -0.0
    yield "all-zero", z


def phase_single_row(dev) -> list:
    """The single-row regime (SINGLE_ROW_CASES): ``row_topk`` (its "auto"
    method, as ``compression.top_k`` calls it) and, where k <= 64, both
    kernels bitwise against the plain version on each kind of row; then
    the picked kernel timed on the random row beside the plain version,
    the library call and the bound. Returns one record per case."""
    from repro_torch.kernels.ops import row_topk
    from repro_torch.kernels.ref import row_topk_ref
    from repro_torch.utils.platform import topk_loop_cutover

    fns = topk_wrappers()
    bad, out = [], []
    for i, (R, C, k) in enumerate(SINGLE_ROW_CASES):
        picked = ("row_topk_threshold" if k > topk_loop_cutover("cuda")
                  else "row_topk_loop")
        for kind, x in single_row_inputs(dev, R, C, 40 + i):
            want = row_topk_ref(x, k)
            got = {f"row_topk -> {picked}": row_topk(x, k)}
            if k <= 64:
                got.update({name: fn(x, k) for name, fn in fns.items()})
            torch.cuda.synchronize()
            verdicts = []
            for name, o in got.items():
                ok = all(same_bits(a, b) for a, b in zip(o, want))
                if not ok:
                    bad.append(f"{name} ({R},{C}) k={k} {kind}")
                verdicts.append(f"{name} "
                                f"{'bitwise equal' if ok else 'MISMATCH'}")
            print(f"  single row ({R},{C}) k={k} {kind}: "
                  f"{'; '.join(verdicts)}")
            del x, got, want
        _, x = next(single_row_inputs(dev, R, C, 40 + i))
        ms = cuda_ms(lambda: row_topk(x, k), iters=20, warmup=2)
        plain_ms = cuda_ms(lambda: row_topk_ref(x, k), iters=2)
        library_ms = cuda_ms(lambda: topk_library(x, k), iters=20, warmup=2)
        nbytes = R * C * 4 + R * k * 8
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        op_ms = R * C / F32_FLOPS_PER_S * 1e3
        rec = {"shape": [R, C], "k": k, "kernel": picked, "ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": max(byte_ms, op_ms),
               "bound_by": "bytes" if byte_ms >= op_ms else "operations"}
        print(f"  single row ({R},{C}) k={k}: {picked} {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
              f"{rec['bound_ms']:.6f} ms ({nbytes} bytes); "
              f"{plan_text(picked, R, C)}")
        out.append(rec)
        del x
    if bad:
        fail(f"the single-row top-k differs from its plain version on {bad}")
    print(f"single-row regime: {len(SINGLE_ROW_CASES)} shapes x 3 kinds "
          "bitwise equal")
    torch.cuda.empty_cache()
    return out


def phase_opt_modes(dev, calls) -> dict:
    """memsgd_momentum and adam_compressed (OPT_MODES) on qwen3-4b at full
    width, per-leaf (``calls``: its per-leaf (rows, C, k)) and bucketed,
    through ``train()`` as the memsgd paths run; the bucketed runs
    profiled (from a zero optimizer state). Returns each run's launches."""
    from repro_torch.core.distributed import SyncConfig
    from repro_torch.launch.train import TrainConfig, init_opt_state

    model = full_model()
    out = {}
    for mode, eta in OPT_MODES.items():
        for path in ("per-leaf", "bucketed"):
            bucketed = path == "bucketed"
            tc = TrainConfig(optimizer=mode, eta=eta, sync=SyncConfig(
                ratio=RATIO, bucketed=bucketed))
            expect = ({fused_branch(tc.sync.k_for(tc.sync.bucket_cols)):
                       STEPS} if bucketed else
                      {name: STEPS * n for name, n in selection_launches(
                          "argmax_onehot", calls).items()})
            _, counts, params, memory, batches = run_path(
                f"{ARCH} {mode} (eta {eta}), {path} path", model, tc, dev,
                expect)
            out[f"{mode} {path}"] = {name: counts[name] for name in expect}
            if bucketed:
                profile_steps(model, tc, params, memory, batches, dev,
                              opt=init_opt_state(tc, params))
            del params, memory, batches
            torch.cuda.empty_cache()
    return out


def phase_logreg(dev) -> dict:
    """The paper's logistic regression (LOGREG_SETS) through
    ``examples/torch_logreg_paper.run_memsgd_flat``: each run on the card
    with every launch count zeroed just before and read just after, then
    its first steps on the CPU from the same indices (LOGREG_CPU_STEPS).
    Returns each run's launches."""
    import importlib.util

    import numpy as np

    from repro_torch.core.compression import identity, top_k
    from repro_torch.data import make_epsilon_like, make_rcv1_like
    from repro_torch.utils.platform import topk_loop_cutover

    path = os.path.join(ROOT, "examples", "torch_logreg_paper.py")
    spec = importlib.util.spec_from_file_location("torch_logreg_paper", path)
    example = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = example
    spec.loader.exec_module(example)
    run_memsgd_flat = example.run_memsgd_flat

    makers = {"epsilon": make_epsilon_like, "rcv1": make_rcv1_like}
    launches = {}
    for name, kw, ks, factor, T in LOGREG_SETS:
        t0 = time.perf_counter()
        data = makers[name](**kw)
        gen_s = time.perf_counter() - t0
        lam, n, d = data.lam, data.n, data.d
        A_cpu = torch.from_numpy(data.A.astype(np.float32))
        b_cpu = torch.from_numpy(data.b.astype(np.float32))
        del data
        A, b = A_cpu.to(dev), b_cpu.to(dev)
        idx = example.sample_indices(n, T)
        print(f"logistic regression {name}: n={n} d={d} lam=1/n, "
              f"generated on the host in {gen_s:.2f} s, A {A.numel() * 4} "
              f"B float32 on the card; T={T}")
        cmp_steps = sorted(LOGREG_CPU_STEPS.values())
        evals = (*cmp_steps, T // 10, T)
        # (label, compressor, shift a, the top-k kernel it launches)
        runs = [("sgd", identity(), 1.0, None)] + [
            (f"top-{k}", top_k(k), factor * d / k,
             "row_topk_threshold" if k > topk_loop_cutover("cuda")
             else "row_topk_loop") for k in ks]
        base = None
        for label, comp, a, kernel in runs:
            held = LOGREG_CPU_STEPS["sgd" if kernel is None else "memsgd"]
            torch.cuda.synchronize()
            zero_launch_counts()
            t0 = time.perf_counter()
            _, losses = run_memsgd_flat(A, b, lam, comp, a, idx, evals=evals)
            torch.cuda.synchronize()
            us = (time.perf_counter() - t0) / T * 1e6
            counts = launch_counts()
            launches[f"{name} {label}"] = counts
            got = {t: float(v) for t, v in losses.items()}
            _, cpu = run_memsgd_flat(A_cpu, b_cpu, lam, comp, a,
                                     idx[:max(cmp_steps)], evals=cmp_steps)
            rels = {t: abs(got[t] - float(cpu[t])) / abs(float(cpu[t]))
                    for t in cmp_steps}
            rel = rels[held]
            base = got[T] if base is None else base
            per_step = {k_: v / T for k_, v in counts.items() if v}
            print(f"  {name} {label} (a={a:.1f}): loss of the average at "
                  f"{T // 10} {got[T // 10]:.6f}, at {T} {got[T]:.6f} "
                  f"(sgd {base:.6f}); {us:.2f} us/step; launches per step "
                  f"{per_step}; card vs cpu: " + ", ".join(
                      f"after {t} steps {got[t]:.7f} vs {float(cpu[t]):.7f}"
                      f" (rel {rels[t]:.2e})" for t in cmp_steps)
                  + f"; held at {held}")
            if not all(math.isfinite(v) for v in got.values()):
                fail(f"logreg {name} {label}: non-finite loss {got}")
            if not got[T] < min(math.log(2), got[T // 10]):
                fail(f"logreg {name} {label}: the average's loss {got[T]} "
                     f"at {T} is not below ln 2 and its loss "
                     f"{got[T // 10]} at {T // 10}")
            if rel > 1e-3:
                fail(f"logreg {name} {label}: the card's loss after {held} "
                     f"steps differs from the CPU's by {rel:.2e} relative")
            want = {k_: T if k_ == kernel else 0 for k_ in counts}
            if counts != want:
                fail(f"logreg {name} {label}: launches {counts}, expected "
                     f"{want}")
        del A, b, A_cpu, b_cpu
        torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def routing_capture():
    """While open, records each MoE layer's routing as it runs: top_i and
    keep (on the host) and the smallest top-K probability margin (a
    token's K-th largest probability less its next), so that a routing
    flip between two devices can be told apart from a fault."""
    from repro_torch.models import moe

    rec = {"top_i": [], "keep": [], "margin": []}
    top_k, assign = moe.router_top_k, moe.assign_slots

    def top_k_(probs, k):
        vals, idx = top_k(probs, k)
        s = torch.sort(probs.detach(), dim=-1, descending=True).values
        rec["margin"].append(float((s[..., k - 1] - s[..., k]).min()))
        rec["top_i"].append(idx.cpu())
        return vals, idx

    def assign_(top_i, n_experts, C):
        keep, slot = assign(top_i, n_experts, C)
        rec["keep"].append(keep.cpu())
        return keep, slot

    moe.router_top_k, moe.assign_slots = top_k_, assign_
    try:
        yield rec
    finally:
        moe.router_top_k, moe.assign_slots = top_k, assign


@contextlib.contextmanager
def gradient_tap(replace=None):
    """While open, records the gradients the train step computes (the
    result of ``torch.autograd.grad``, on the host) and, given ``replace``
    (a list of host tensors), hands the step those in place of its own."""
    real = torch.autograd.grad
    rec = []

    def grad(outputs, inputs, *args, **kwargs):
        out = real(outputs, inputs, *args, **kwargs)
        rec.append([g.detach().cpu() for g in out])
        if replace is not None:
            out = tuple(r.to(g.device) for r, g in zip(replace, out))
        return out

    torch.autograd.grad = grad
    try:
        yield rec
    finally:
        torch.autograd.grad = real


def phase_small(dev) -> None:
    """One float32 step of each architecture's smoke config on the card
    and on the CPU (plain versions) from the same params and batch must
    agree, on the bucketed path, the topk preset (the threshold branch,
    packed wire) and the per-leaf path: loss to 1e-5 relative. qwen3-4b
    and rwkv6-3b: the applied update to 1e-3 relative L2 (matrix products
    sum in another order on the card, which can flip a rare near-tie in
    the selection). The MoE configs: the routing of every layer (top_i,
    keep) identical first, the smallest top-K probability margin printed
    beside it; the gradients within 1e-5 relative L2 (float32 products
    and sums in another order); and the CPU's step taken from the card's
    gradients must give the card's update bit for bit (the sync is exact:
    the kernels' contract, float32 ops each rounded once). A selection
    flip is then told apart from a fault: the end-to-end update's relative
    L2 and the entries selected on one device only are printed, not held
    (a single flip at k = 20 in a smoke bucket moves it by ~1.5e-3)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.distributed import SyncConfig
    from repro_torch.data import token_batches
    from repro_torch.launch.train import (TrainConfig, init_train_state,
                                          make_train_step)
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_leaves, tree_map

    paths = {"bucketed": SyncConfig(ratio=RATIO, bucketed=True),
             "topk preset": SyncConfig.preset("topk", ratio=TOPK_RATIO),
             "per-leaf": SyncConfig(ratio=RATIO)}
    # (config overrides, seq): griffin at 3 layers (every block kind) and
    # seq 96, above its smoke window of 64, so that the window binds
    small = {GRIFFIN_ARCH: (dict(n_layers=3), 96)}
    for arch in (ARCH, RWKV_ARCH, MOE_ARCH, QMOE_ARCH, GRIFFIN_ARCH):
        overrides, seq = small.get(arch, ({}, 64))
        cfg = get_smoke_config(arch).replace(compute_dtype="float32",
                                             **overrides)
        model = build_model(cfg)
        batch = next(token_batches(cfg.vocab_size, 4, seq, seed=1))
        host = model.init(seed=0, device="cpu")
        for path, sync in paths.items():
            tc = TrainConfig(eta=ETAS[arch], sync=sync)
            def one_step(d, grads=None):
                """(loss, update on the host, routes, gradients) of one
                step on ``d``, from the card's gradients if given."""
                params, memory, opt, count = init_train_state(
                    model, tc, device=d,
                    params=tree_map(lambda t: t.to(d, copy=True), host))
                before = [p.clone() for p in tree_leaves(params)]
                step = make_train_step(model, tc)
                with routing_capture() as routes, \
                        gradient_tap(grads) as tapped:
                    params, memory, opt, count, met = step(
                        params, memory, opt, count,
                        {k: torch.as_tensor(v, device=d)
                         for k, v in batch.items()})
                upd = torch.cat([(a - b).reshape(-1).cpu() for a, b in
                                 zip(before, tree_leaves(params))])
                return float(met["loss"]), upd, routes, tapped[0]

            (l_cpu, u_cpu, r_cpu, g_cpu) = one_step(torch.device("cpu"))
            (l_gpu, u_gpu, r_gpu, g_gpu) = one_step(dev)
            if cfg.moe is not None:
                same = all(len(r_cpu[key]) == len(r_gpu[key]) == cfg.n_layers
                           and all(torch.equal(a, b) for a, b in
                                   zip(r_cpu[key], r_gpu[key]))
                           for key in ("top_i", "keep"))
                margin = min(r_cpu["margin"] + r_gpu["margin"])
                print(f"small input, {arch} {path} path: routing of "
                      f"{cfg.n_layers} layers (top_i, keep) "
                      f"{'identical' if same else 'DIFFERS'} on card and "
                      f"cpu; smallest top-{cfg.moe.top_k} probability margin "
                      f"{margin:.3e}")
                if not same:
                    fail(f"the card's {arch} {path} routing differs from the "
                         f"CPU's (smallest margin {margin:.3e})")
            rel_loss = abs(l_gpu - l_cpu) / abs(l_cpu)
            rel_upd = float((u_gpu - u_cpu).norm() / u_cpu.norm())
            print(f"small input, {arch} {path} path: loss card {l_gpu} vs "
                  f"cpu {l_cpu} (rel {rel_loss:.2e}), update rel L2 "
                  f"{rel_upd:.2e}")
            if rel_loss > 1e-5:
                fail(f"the card's {arch} {path} loss disagrees with the "
                     "CPU's on the small input")
            if cfg.moe is None:
                if rel_upd > 1e-3:
                    fail(f"the card's {arch} {path} step disagrees with the "
                         "CPU's on the small input")
                continue
            gc, gg = (torch.cat([g.reshape(-1) for g in gs])
                      for gs in (g_cpu, g_gpu))
            rel_grad = float((gg - gc).norm() / gc.norm())
            u_from_card = one_step(torch.device("cpu"), g_gpu)[1]
            exact = same_bits(u_from_card, u_gpu)
            flips = int(((u_gpu == 0) != (u_cpu == 0)).sum())
            print(f"small input, {arch} {path} path: gradients rel L2 "
                  f"{rel_grad:.2e}; the CPU's step from the card's gradients "
                  f"{'bitwise equal to' if exact else 'DIFFERS from'} the "
                  f"card's; {flips} entries selected on one device only")
            if rel_grad > 1e-5 or not exact:
                fail(f"the card's {arch} {path} step disagrees with the "
                     "CPU's on the small input")
    small_attention(dev)


def phase_moe(dev, leaf_shapes) -> dict:
    """The MoE family: MOE_ARCH on the bucketed path, through the
    ``memsgd_bucketed`` optimizer with each fused method, on the topk
    preset (packed, then unpacked) and on the per-leaf path with both
    selections; QMOE_ARCH on the bucketed and the per-leaf path. Returns
    each architecture's launches, by path."""
    moe = {"bucketed": phase_bucketed(dev, MOE_ARCH, MOE_LAYERS, MOE_SHAPE,
                                      MOE_BYTES["bucketed"])}
    for method, counts in phase_memsgd_bucketed(dev).items():
        moe[f"memsgd_bucketed {method}"] = counts
    moe["topk preset"] = phase_topk_preset(
        dev, MOE_ARCH, MOE_LAYERS, {"packed": MOE_BYTES["topk packed"],
                                    "unpacked": MOE_BYTES["topk unpacked"]})
    moe["per-leaf"] = phase_leaf(dev, leaf_shapes[MOE_ARCH], MOE_ARCH,
                                 MOE_LAYERS, nbytes=MOE_BYTES["per-leaf"])
    qmoe = {"bucketed": phase_bucketed(dev, QMOE_ARCH, QMOE_LAYERS,
                                       QMOE_SHAPE, QMOE_BYTES["bucketed"]),
            "per-leaf": phase_leaf(dev, leaf_shapes[QMOE_ARCH], QMOE_ARCH,
                                   QMOE_LAYERS, ("argmax_onehot",),
                                   QMOE_BYTES["per-leaf"])}
    return {MOE_ARCH: moe, QMOE_ARCH: qmoe}


def phase_griffin(dev, leaf_shapes) -> dict:
    """GRIFFIN_ARCH at full width on the bucketed path (its (2689056, 1024)
    bucket), the topk preset (packed, then unpacked: identical losses) and
    the per-leaf path with ``argmax_onehot`` (every k <= 64: the loop
    kernel, the conv_w leaves' rows of C = 4 at k = 1 among them), each
    checking its bytes per step against the reference's accounting.
    Returns its launches, by path."""
    return {
        "bucketed": phase_bucketed(dev, GRIFFIN_ARCH, GRIFFIN_LAYERS,
                                   GRIFFIN_SHAPE, GRIFFIN_BYTES["bucketed"]),
        "topk preset": phase_topk_preset(
            dev, GRIFFIN_ARCH, GRIFFIN_LAYERS,
            {"packed": GRIFFIN_BYTES["topk packed"],
             "unpacked": GRIFFIN_BYTES["topk unpacked"]}),
        "per-leaf": phase_leaf(dev, leaf_shapes[GRIFFIN_ARCH], GRIFFIN_ARCH,
                               GRIFFIN_LAYERS, ("argmax_onehot",),
                               GRIFFIN_BYTES["per-leaf"])}


def fwd_bwd_cost(label, fn, leaves) -> None:
    """Prints the CUDA-event ms of ``fn``'s forward and the backward of
    its float32 sum into ``leaves``, the kernels one such call launches
    (torch.profiler) and its peak memory above what was allocated before
    it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def call():
        out = fn()
        torch.autograd.grad(out.float().sum(), leaves)

    ms = cuda_ms(call, iters=5, warmup=2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    print(f"  {label}: forward + backward {ms:.3f} ms, {kernels} device "
          f"operations, peak {peak / 2**30:.2f} GiB above its inputs")


def layer_costs(dev) -> None:
    """What the slice's two new plain-PyTorch layers cost on the card
    (bf16 inputs as in the models; the work that a fused kernel would
    replace): griffin's RG-LRU at the path's shape (BATCH x SEQ x 4096)
    and its log-depth scan alone (float32, T + 1 = 513 positions: 10
    rounds); one attention layer of qwen3-4b at full width, batch 1, seq
    LONG_SEQ, through the causal blocked path and through the direct
    path's ``_sdpa``."""
    from repro_torch.models import griffin, layers

    cfg = full_model(GRIFFIN_ARCH, GRIFFIN_LAYERS).cfg
    R = cfg.hybrid.lru_width
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    rec = {k: v.to(torch.bfloat16).requires_grad_(True) for k, v in
           griffin.init_recurrent_block(cfg, torch.float32, dev, gen).items()}
    x = torch.randn((BATCH, SEQ, R), generator=gen, device=dev).to(
        torch.bfloat16).requires_grad_(True)
    h0 = torch.zeros((BATCH, R), device=dev)
    leaves = [x] + [rec[k] for k in ("w_a", "b_a", "w_x", "b_x", "lam")]
    fwd_bwd_cost(f"{GRIFFIN_ARCH} rg_lru ({BATCH},{SEQ},{R})",
                 lambda: griffin.rg_lru(rec, x, h0)[0], leaves)
    a = torch.rand((BATCH, SEQ + 1, R), generator=gen,
                   device=dev).requires_grad_(True)
    b = torch.randn((BATCH, SEQ + 1, R), generator=gen,
                    device=dev).requires_grad_(True)
    fwd_bwd_cost(f"linear_scan ({BATCH},{SEQ + 1},{R}) float32",
                 lambda: griffin.linear_scan(a, b), [a, b])
    del rec, x, h0, leaves, a, b

    cfg = full_model(ARCH, N_LAYERS).cfg
    p = {k: v.to(torch.bfloat16).requires_grad_(True) for k, v in
         layers.init_attention(cfg, None, torch.float32, dev, gen).items()}
    x = (torch.randn((1, LONG_SEQ, cfg.d_model), generator=gen, device=dev)
         .to(torch.bfloat16).requires_grad_(True))
    pos = torch.arange(LONG_SEQ, dtype=torch.int32, device=dev)[None]
    n_rep = cfg.n_heads // cfg.n_kv_heads

    def direct():
        q, k, v = layers._qkv(p, cfg, x)
        q = layers.apply_rope(q, pos, cfg.rope_theta)
        k = layers.apply_rope(k, pos, cfg.rope_theta)
        out = layers._sdpa(q, k, v, layers.causal_mask(LONG_SEQ, None, dev),
                           n_rep)
        return out.reshape(1, LONG_SEQ, -1) @ p["wo"]

    leaves = [x] + list(p.values())
    fwd_bwd_cost(f"{ARCH} attention (1,{LONG_SEQ},{cfg.d_model}), "
                 "_flash_full", lambda: layers.attention(p, cfg, x, pos),
                 leaves)
    fwd_bwd_cost(f"{ARCH} attention (1,{LONG_SEQ},{cfg.d_model}), direct "
                 "_sdpa", direct, leaves)
    del p, x, leaves
    torch.cuda.empty_cache()


def phase_long(dev) -> dict:
    """The blocked attention paths: each LONG architecture on the per-leaf
    path (``argmax_onehot``) at LONG_BATCH x LONG_SEQ for LONG_STEPS steps,
    checked as every path run is; the attention branch counts
    (``models.layers.ATTENTION_CALLS``) zeroed just before the run and read
    just after must show every attention layer of every step on the named
    blocked branch. Returns each run's launches."""
    from repro_torch.core.distributed import SyncConfig
    from repro_torch.launch.train import TrainConfig
    from repro_torch.models import griffin, layers

    out = {}
    for arch, (n_layers, branch) in LONG.items():
        model = full_model(arch, n_layers)
        cfg = model.cfg
        n_attn = (griffin.layer_kinds(cfg).count("attn")
                  if cfg.family == "hybrid" else n_layers)
        calls = leaf_row_shapes(arch, n_layers)
        tc = TrainConfig(optimizer="memsgd", eta=ETAS[arch],
                         sync=SyncConfig(ratio=RATIO))
        expect = {name: LONG_STEPS * n for name, n in
                  selection_launches("argmax_onehot", calls).items()}
        window = cfg.hybrid.attn_window if cfg.hybrid else cfg.sliding_window
        print(f"long sequence: {arch} {n_layers} layers at full width, "
              f"per-leaf path, batch {LONG_BATCH} x seq {LONG_SEQ}, "
              f"{n_attn} attention layers (window {window})")
        layers.ATTENTION_CALLS.clear()
        _, counts, params, memory, batches = run_path(
            f"{arch} per-leaf path at seq {LONG_SEQ}", model, tc, dev,
            expect, LONG_STEPS, LONG_BATCH, LONG_SEQ)
        took = dict(layers.ATTENTION_CALLS)
        print(f"{arch} at seq {LONG_SEQ}: attention calls by branch {took}")
        if took != {branch: LONG_STEPS * n_attn}:
            fail(f"{arch} at seq {LONG_SEQ}: attention took {took}, expected "
                 f"{LONG_STEPS * n_attn} calls of {branch}")
        out[arch] = {name: counts[name] for name in expect}
        del params, memory, batches
        torch.cuda.empty_cache()
    return out


def small_attention(dev) -> None:
    """``models.layers.attention`` at seq 3072 > FLASH_THRESHOLD (tiny
    widths: d_model 32, 2 heads of 16, one kv head; float32), without a
    window (the causal blocked path) and with one of 1000 (the windowed
    blocked path), on the card and on the CPU from the same inputs: within
    1e-5 of the output's largest entry (float32 sums in other orders)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import layers
    from repro_torch.utils.tree import tree_map

    cfg = get_smoke_config(GRIFFIN_ARCH).replace(
        d_model=32, n_heads=2, n_kv_heads=1, compute_dtype="float32")
    gen = torch.Generator()
    gen.manual_seed(4)
    p = layers.init_attention(cfg, None, torch.float32, "cpu", gen)
    x = torch.randn((1, 3072, 32), generator=gen)
    pos = torch.arange(3072, dtype=torch.int32)[None]
    for window, branch in ((None, "flash_full"), (1000, "flash_windowed")):
        outs = {}
        for d in (torch.device("cpu"), dev):
            layers.ATTENTION_CALLS.clear()
            outs[d.type] = layers.attention(
                tree_map(lambda t: t.to(d), p), cfg, x.to(d), pos.to(d),
                window).cpu()
            if dict(layers.ATTENTION_CALLS) != {branch: 1}:
                fail(f"attention at seq 3072, window {window}: took "
                     f"{dict(layers.ATTENTION_CALLS)}, expected {branch}")
        err = float((outs["cuda"] - outs["cpu"]).abs().max()
                    / outs["cpu"].abs().max())
        print(f"small input, attention at seq 3072, window {window} "
              f"({branch}): card vs cpu max |err| {err:.2e} of the largest")
        if err > 1e-5:
            fail(f"the card's blocked attention ({branch}) disagrees with the "
                 "CPU's")


def held_topk(x, k, label) -> dict:
    """Both top-k kernels on x at k, bitwise against the plain version
    (failing otherwise), each timed beside the plain version, the library
    call and the bound; returns those numbers."""
    from repro_torch.kernels.ref import row_topk_ref

    R, C = x.shape
    fns = topk_wrappers()
    want = row_topk_ref(x, k)
    out = {"shape": [R, C], "k": k}
    for name, fn in fns.items():
        got = fn(x, k)
        torch.cuda.synchronize()
        if not all(same_bits(a, b) for a, b in zip(got, want)):
            fail(f"{label}: {name} differs from the plain version at ({R}, "
                 f"{C}) k = {k}")
        out[f"{name}_ms"] = cuda_ms(lambda: fn(x, k), iters=10, warmup=2)
        del got
    del want
    out["plain_ms"] = cuda_ms(lambda: row_topk_ref(x, k), iters=2)
    out["library_ms"] = cuda_ms(lambda: topk_library(x, k), iters=5)
    # the row read once, k (value, index) pairs written; one magnitude
    # compare per element
    byte_ms = (R * C * 4 + R * k * 8) / HBM_BYTES_PER_S * 1e3
    op_ms = R * C / F32_FLOPS_PER_S * 1e3
    out["bound_ms"] = max(byte_ms, op_ms)
    out["bound_by"] = "bytes" if byte_ms >= op_ms else "operations"
    print(f"{label} at ({R}, {C}) k = {k}: both kernels bitwise equal to "
          "the plain version; "
          + ", ".join(f"{n} {out[f'{n}_ms']:.4f} ms" for n in fns)
          + f", plain {out['plain_ms']:.4f} ms, library "
          f"{out['library_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms "
          f"({out['bound_by']}); {plan_text('row_topk_loop', R, C)}")
    return out


def phase_pod_reselect(dev) -> dict:
    """The pod sync's top-k launches at their path's shape, POD_SHAPE, each
    through ``held_topk``: the calibration's per-shard select at k_row on
    random rows (``simulate_pod_mean``'s), then the pod re-select at k_max
    = POD_DATA * k_row on a pod mean formed as the sync forms it (POD_DATA
    shards' per-row top-k_row, densified, summed, / POD_DATA: at most k_max
    nonzeros a row). Returns their numbers."""
    R, C = POD_SHAPE
    k_row = round(RATIO * C)
    k_max = POD_DATA * k_row
    fns = topk_wrappers()
    gen = torch.Generator(device=dev)
    gen.manual_seed(41)
    pm = torch.zeros((R, C), device=dev)
    out = {}
    for shard in range(POD_DATA):
        u = torch.randn((R, C), generator=gen, device=dev)
        if shard == 0:
            out["calibration select"] = held_topk(
                u, k_row, "pod calibration select")
        vals, idx = fns["row_topk_loop"](u, k_row)
        del u
        pm.scatter_add_(1, idx.to(torch.int64), vals)
    pm.div_(POD_DATA)
    out["pod re-select"] = held_topk(pm, k_max, "pod re-select on a pod mean")
    del pm, vals, idx
    torch.cuda.empty_cache()
    return out


def bf16_topk_cases(dev):
    """Yields (label, x, k): bf16 rows on the card at the edges of the
    top-k kernels' bf16 forms, made from seeds: every float32 design edge
    rounded to bf16 (bf16's 8 significant bits make ties common), then the
    bf16 form's own: 8 values to a 16-byte word (a lane owns columns j with
    (j // 8) % 32 == lane), so a list that overflows at that stride; bf16
    subnormals; signed-zero rows; k = 32 and 33; k = C; k above the list's
    capacity (the pairs ordered in idx); C < 32; C % 8 != 0 with C % 4 ==
    0; rows 2 bytes past alignment; rows of 4; a row wider than shared
    memory at bf16."""
    import numpy as np

    rng = np.random.default_rng(51)

    def signs(shape):
        return np.where(rng.random(shape) < 0.5, -1.0, 1.0)

    def bf(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            dev).to(BF16)

    for label, x, k in design_edges():
        yield f"{label}, rounded to bf16", bf(x), k
    lane = (np.arange(2560) // 8) % 32
    yield ("lane-stratified at bf16, list overflows (4,2560) k=26",
           bf(((32 - lane) * 10.0 + rng.random((4, 2560)))
              * signs((4, 2560))), 26)
    bits = rng.integers(1, 128, (6, 2560)).astype(np.int16)
    bits |= ((rng.random((6, 2560)) < 0.5) << 15).astype(np.int16)
    yield ("bf16 subnormals only (6,2560) k=26",
           torch.from_numpy(bits).to(dev).view(BF16), 26)
    z = np.zeros((4, 64))
    z[:, 1::2] = -0.0
    yield "all-zero rows, signed zeros (4,64) k=10", bf(z), 10
    for k in (32, 33):
        yield f"k={k} (8,1024)", bf(rng.standard_normal((8, 1024))), k
    yield "k=C (8,300) k=300", bf(rng.standard_normal((8, 300))), 300
    yield ("k above the list's capacity (4,1024) k=300",
           bf(rng.standard_normal((4, 1024))), 300)
    yield ("k=C above the list's capacity (3,600) k=600",
           bf(rng.standard_normal((3, 600))), 600)
    yield ("C % 8 != 0, C % 4 == 0 (6,1020) k=26",
           bf(rng.standard_normal((6, 1020))), 26)
    flat = bf(rng.standard_normal(8 * 1024 + 1))
    yield "rows 2 bytes past alignment (8,1024) k=26", flat[1:].view(
        8, 1024), 26
    yield "rows of 4 (4096,4) k=1", bf(rng.standard_normal((4096, 4))), 1
    yield ("wider than shared memory at bf16 (2,130000) k=26",
           bf(rng.standard_normal((2, 130000))), 26)


def bf16_pod_mean(dev, R, C, k_row, seed):
    """A bf16 pod mean as the two-level sync forms it at bf16 wire values:
    POD_DATA shards' per-row top-k_row of random rows, their values in
    bf16, densified and averaged by the sync's own ``_densify_mean``
    (argmax_onehot's one-hot form): at most POD_DATA * k_row nonzeros a
    row."""
    from repro_torch.core.distributed import _densify_mean

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    fn = topk_wrappers()["row_topk_loop"]
    pairs = []
    for _ in range(POD_DATA):
        u = torch.randn((R, C), generator=gen, device=dev)
        vals, idx = fn(u, k_row)
        del u
        pairs.append((vals.to(BF16), idx))
    gv = torch.cat([v for v, _ in pairs], 1)
    gi = torch.cat([i for _, i in pairs], 1)
    del pairs
    return _densify_mean(torch.zeros((R, C), dtype=BF16, device=dev), 1, gv,
                         gi, k_row, True)


def bf16_fused_cases(dev):
    """Yields (label, m (bf16), g (float32), eta, k, branches) on the card:
    the fused kernel's design edges (eta 0 and 0.37, not exact in bf16;
    ties; +-inf and subnormal rows; k = C; k above 256; a list that
    overflows; signed-zero rows; spare warps), C % 8 != 0 with C % 4 == 0,
    the widest row each branch holds at bf16 (the loop branch's only for
    it), and the pod sync's bucket at k = 10 and 20. Each case runs with g
    as it is and rounded to bf16."""
    from repro_torch.kernels.fused_memsgd import MAX_COLS_BY_DTYPE

    gen = torch.Generator(device=dev)

    def randn(shape, seed):
        gen.manual_seed(seed)
        return torch.randn(shape, generator=gen, device=dev)

    both = ("loop", "threshold")
    for label, m, g, eta, k in fused_edges():
        yield (label, torch.from_numpy(m).to(dev).to(BF16),
               torch.from_numpy(g).to(dev), eta, k, both)
    yield ("C % 8 != 0, C % 4 == 0 (6,1020) k=26",
           randn((6, 1020), 61).to(BF16), randn((6, 1020), 62), 0.37, 26,
           both)
    for sel, widest in MAX_COLS_BY_DTYPE[BF16].items():
        yield (f"widest {sel} row at bf16 (2,{widest}) k=300",
               randn((2, widest), 63).to(BF16), randn((2, widest), 64),
               0.37, 300, both if sel == "threshold" else (sel,))
    for k in (PATH_K, TOPK_K):
        yield (f"pod sync bucket {POD_SHAPE} k={k}",
               (randn(POD_SHAPE, 65) * 0.01).to(BF16),
               randn(POD_SHAPE, 66), POD_ETA, k, both)


def phase_bf16_kernels(dev) -> dict:
    """The three kernels' bf16 forms, each bitwise against its plain
    version on the card (the top-k kernels on bf16_topk_cases and at the
    BF16_TOPK_SHAPES; the fused kernel's two branches on bf16_fused_cases,
    with float32 and with bf16 g, the launches of each bf16 form counted);
    then each timed with CUDA events at the path's shapes beside its plain
    version, the library call, the bytes bound and its float32 form on the
    same values, with the launch geometry; and the bf16 fused sweep (loop
    against threshold branch over k). Returns the kernels line's numbers
    of each bf16 kernel, by name."""
    from repro_torch.kernels.fused_memsgd import fused_memsgd_cuda
    from repro_torch.kernels.ref import fused_memsgd_ref, row_topk_ref
    from repro_torch.kernels.topk_select import LAUNCHES
    from repro_torch.utils.platform import fused_loop_cutover

    fns = topk_wrappers()
    worst = collections.defaultdict(float)
    bad, n = [], collections.Counter()
    for label, x, k in bf16_topk_cases(dev):
        want = row_topk_ref(x, k)
        for name, fn in fns.items():
            before = LAUNCHES[name + "_bf16"]
            got = fn(x, k)
            torch.cuda.synchronize()
            ok = (LAUNCHES[name + "_bf16"] == before + 1
                  and all(same_bits(a, b) for a, b in zip(got, want)))
            worst[name + "_bf16"] = max(worst[name + "_bf16"], float(
                (got[0].float() - want[0].float()).abs().max()))
            n[name + "_bf16"] += 1
            if not ok:
                bad.append(f"{name}_bf16 {label}")
        del x, want
    for label, m, g32, eta, k, branches in bf16_fused_cases(dev):
        for g in (g32, g32.to(BF16)):
            want = fused_memsgd_ref(m, g, eta, k)
            for sel in branches:
                name = "fused_memsgd" + ("_threshold" if sel == "threshold"
                                         else "") + "_bf16"
                before = launch_counts()[name]
                got = fused_memsgd_cuda(m, g, eta, k, sel)
                torch.cuda.synchronize()
                ok = (launch_counts()[name] == before + 1
                      and all(same_bits(a, b) for a, b in zip(got, want)))
                worst[name] = max(worst[name], max(
                    float((a.float() - b.float()).abs().max())
                    for a, b in zip(got[:2], want[:2])))
                n[name] += 1
                if not ok:
                    bad.append(f"{name} {label} g {g.dtype}")
                del got
            del want
        del m, g32, g
    if bad:
        fail(f"bf16 kernels differ from their plain versions on {bad}")
    print(f"bf16 kernels: {dict(n)} cases bitwise equal to the plain "
          "versions (vals and new_m in bf16), each launch counted under its "
          "bf16 name")
    torch.cuda.empty_cache()

    out = {}
    # the top-k kernels: bf16 against float32 on the same values, in turns
    for (R, C), k in BF16_TOPK_SHAPES:
        if (R, C) == POD_SHAPE:
            x = bf16_pod_mean(dev, R, C, k // POD_DATA, 71)
            what = f"the pod re-select on a bf16 pod mean (<= {k} nonzeros)"
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(72)
            x = (torch.randn((R, C), generator=gen, device=dev)
                 * 0.01).to(BF16)
            what = "random rows"
        x32 = x.float()
        want = row_topk_ref(x, k)
        for name, fn in fns.items():
            if not all(same_bits(a, b) for a, b in zip(fn(x, k), want)):
                fail(f"{name}_bf16 differs from the plain version at "
                     f"({R}, {C}) k = {k}")
        del want
        plain_ms = cuda_ms(lambda: row_topk_ref(x, k), iters=2)
        library_ms = cuda_ms(lambda: topk_library(x, k), iters=5)
        byte_ms = (R * C * 2 + R * k * 6) / HBM_BYTES_PER_S * 1e3
        op_ms = R * C / F32_FLOPS_PER_S * 1e3
        for name, fn in fns.items():
            t = collections.defaultdict(list)
            for form, z in (("bf16", x), ("f32", x32), ("f32", x32),
                            ("bf16", x)):
                t[form].append(cuda_ms(lambda: fn(z, k), iters=10,
                                       warmup=2))
            ms, ms32 = (statistics.median(t[f]) for f in ("bf16", "f32"))
            entry = {"ms": ms, "plain_ms": plain_ms,
                     "bound_ms": max(byte_ms, op_ms),
                     "bound_by": "bytes" if byte_ms >= op_ms
                     else "operations",
                     "library_ms": library_ms, "f32_ms": ms32,
                     "shape": [R, C], "k": k}
            print(f"  {name}_bf16 ({R},{C}) k={k}, {what}: "
                  f"{' / '.join(f'{v:.4f}' for v in t['bf16'])} ms "
                  f"({ms / entry['bound_ms']:.3f}x bound), float32 form "
                  f"{' / '.join(f'{v:.4f}' for v in t['f32'])} ms, plain "
                  f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
                  f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}); "
                  f"{plan_text(name, R, C, BF16)}")
            if (R, C) == POD_SHAPE:
                out[name + "_bf16"] = entry
        del x, x32
        torch.cuda.empty_cache()

    # the fused kernel at qwen3-4b's bucket (bucket_memory_step's launches
    # over bf16 memory): both branches, float32 and bf16 g, in turns with
    # the float32 form on the same values
    R, C = BF16_FUSED_SHAPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(73)
    m = (torch.randn((R, C), generator=gen, device=dev) * 0.01).to(BF16)
    g32 = torch.randn((R, C), generator=gen, device=dev)
    m32 = m.float()
    for g, g_bytes in ((g32, 4), (g32.to(BF16), 2)):
        print(f"  fused_memsgd bf16 m, {g.dtype} g ({R},{C}): "
              + "; ".join(fused_plan_text(sel, R, C, BF16, g.dtype)
                          for sel in ("loop", "threshold")))
        for k in (PATH_K, TOPK_K):
            plain_ms = cuda_ms(lambda: fused_memsgd_ref(m, g, POD_ETA, k),
                               iters=2)
            library_ms = cuda_ms(lambda: fused_library(m, g, POD_ETA, k),
                                 iters=3)
            byte_ms = ((R * C * (2 + g_bytes + 2) + R * k * 6)
                       / HBM_BYTES_PER_S * 1e3)
            op_ms = 2 * R * C / F32_FLOPS_PER_S * 1e3
            bound_ms = max(byte_ms, op_ms)
            for sel in ("threshold", "loop"):
                t = collections.defaultdict(list)
                for form in ("bf16", "f32", "f32", "bf16"):
                    mm, gg = (m, g) if form == "bf16" else (m32, g32)
                    t[form].append(cuda_ms(
                        lambda: fused_memsgd_cuda(mm, gg, POD_ETA, k, sel),
                        iters=5, warmup=1))
                ms, ms32 = (statistics.median(t[f]) for f in ("bf16", "f32"))
                name = "fused_memsgd" + ("_threshold" if sel == "threshold"
                                         else "") + "_bf16"
                print(f"  {name}, {g.dtype} g, ({R},{C}) k={k}: "
                      f"{' / '.join(f'{v:.4f}' for v in t['bf16'])} ms "
                      f"({ms / bound_ms:.3f}x bound), float32 form "
                      f"{' / '.join(f'{v:.4f}' for v in t['f32'])} ms, "
                      f"plain {plain_ms:.4f} ms, library {library_ms:.4f} "
                      f"ms, bound {bound_ms:.4f} ms")
                if g is g32 and k == PATH_K:
                    out[name] = {
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": ("bytes" if byte_ms >= op_ms
                                     else "operations"),
                        "library_ms": library_ms, "f32_ms": ms32,
                        "shape": [R, C], "k": k}
    # the bf16 fused sweep: loop against threshold branch at the bucket
    # with float32 g (what bucket_memory_step packs), in turns at each k
    # (loop, threshold, threshold, loop), upward then downward; each
    # branch's median, against FUSED_LOOP_CUTOVER_BF16["cuda"]
    tk = {k: collections.defaultdict(list) for k in BF16_SWEEP_KS}
    for ks in (BF16_SWEEP_KS, BF16_SWEEP_KS[::-1]):
        for k in ks:
            for sel in ("loop", "threshold", "threshold", "loop"):
                tk[k][sel].append(cuda_ms(
                    lambda: fused_memsgd_cuda(m, g32, POD_ETA, k, sel),
                    iters=5, warmup=1))
    cut = fused_loop_cutover("cuda", BF16)
    for k, t in tk.items():
        med = {sel: statistics.median(v) for sel, v in t.items()}
        win = min(med, key=med.get)
        gap = abs(med["loop"] / med["threshold"] - 1) * 100
        print(f"  bf16 fused sweep ({R},{C}) float32 g k={k}: loop "
              f"{med['loop']:.4f} ms, threshold {med['threshold']:.4f} ms "
              f"-> {win} by {gap:.2f}%; auto takes "
              f"{'threshold' if k > cut else 'loop'}")
    del m, g32, m32, g
    torch.cuda.empty_cache()
    for name, entry in out.items():
        entry["max_abs_err"] = worst[name]
    return out


def phase_bf16_memory(dev) -> dict:
    """``bucket_memory_step`` over bf16 memory (``init_bucket_memory(plan,
    dtype=bfloat16)``; the sparse bucket through the fused kernel's bf16
    form, float32 g) on qwen3-4b's gradient tree at full width, 4 layers:
    a first step from the zero memory, then from its memory one step with
    method "threshold" and one with "auto" (the branch the bf16 form's
    cutover picks at k = 10), each launch count zeroed before and read
    after (one launch of the expected bf16 branch per sparse bucket). Each
    sparse bucket's new memory and applied values are held bitwise against
    the plain version on the card (``fused_memsgd_ref`` on the packed g:
    its new_m, and its (vals, idx) densified), at the (1154560, 1024)
    bucket whose launches the kernels line reports; both steps finite and
    bitwise equal. Then a small
    input (qwen3-4b's smoke config, float32, its CPU gradients): the step
    on the card bitwise the CPU's plain version. Returns the launches by
    method."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import buckets as bk
    from repro_torch.core.distributed import SyncConfig
    from repro_torch.data import token_batches
    from repro_torch.kernels.ops import _resolve_method
    from repro_torch.kernels.ref import densify_rows_ref, fused_memsgd_ref
    from repro_torch.launch.train import _grads
    from repro_torch.models import build_model
    from repro_torch.utils.platform import fused_loop_cutover
    from repro_torch.utils.tree import tree_flatten, tree_leaves

    k_for = SyncConfig(ratio=RATIO).k_for
    model = full_model(ARCH, N_LAYERS)
    params = model.init(seed=0, device=dev)
    batch = next(token_batches(model.cfg.vocab_size, BATCH, SEQ, seed=0))
    grads, _ = _grads(model, params, {k: torch.as_tensor(v, device=dev)
                                      for k, v in batch.items()})
    g_tree = tree_flatten(params)[1].unflatten(grads)
    del params, grads
    plan = bk.make_plan(model.param_shapes(), cols=1024, dense_below=16_384)
    sparse = sum(s.kind == "sparse" for s in plan.buckets)
    auto = _resolve_method("auto", k_for(1024), "cuda", functools.partial(
        fused_loop_cutover, dtype=BF16))
    name_of = {"loop": "fused_memsgd_bf16",
               "threshold": "fused_memsgd_threshold_bf16"}
    memory = bk.init_bucket_memory(plan, dtype=BF16, device=dev)
    # the memory the checked steps start from: one step's residual
    _, memory, _ = bk.bucket_memory_step(plan, memory, g_tree, ETA, k_for,
                                         method="threshold")
    # the plain version of each sparse bucket's step: its new memory, and
    # its (vals, idx) densified as the step applies them
    g_bufs = bk.pack(plan, g_tree, dtype=torch.float32)
    plain = {}
    for b, spec in enumerate(plan.buckets):
        if spec.kind == "sparse":
            nm, vals, idx = fused_memsgd_ref(memory[b], g_bufs[b], ETA,
                                             k_for(spec.cols))
            plain[b] = (nm, densify_rows_ref(memory[b], vals, idx))
            del nm, vals, idx
    del g_bufs
    torch.cuda.empty_cache()
    launches, results, bad = {}, {}, []
    for method, name in (("threshold", name_of["threshold"]),
                         ("auto", name_of[auto])):
        torch.cuda.synchronize()
        zero_launch_counts()
        applied, new_m, _ = bk.bucket_memory_step(
            plan, memory, g_tree, ETA, k_for, method=method)
        torch.cuda.synchronize()
        counts = launch_counts()
        launches[method] = counts
        want = {n: 0 for n in counts}
        want[name] = sparse
        if counts != want:
            fail(f"bf16 bucket memory (method {method!r}): launches "
                 f"{counts}, expected {want}")
        packed = bk.pack(plan, applied, dtype=BF16)
        for b, (nm, dense) in plain.items():
            if not (same_bits(new_m[b], nm) and same_bits(packed[b], dense)):
                bad.append(f"{method} bucket {plan.buckets[b].shape}")
        results[method] = tree_leaves(applied) + list(new_m)
        del applied, new_m, packed
    if bad:
        fail(f"bf16 bucket memory: the step differs from the plain version "
             f"on the card at {bad}")
    finite = all(bool(torch.isfinite(t).all()) for t in results["auto"])
    same = all(same_bits(a, b) for a, b in zip(*results.values()))
    dtypes = sorted({str(t.dtype) for t in results["auto"][-len(
        plan.buckets):]})
    print(f"bf16 bucket memory: {ARCH} {N_LAYERS} layers, buckets "
          f"{[(s.kind, s.shape) for s in plan.buckets]}, k = "
          f"{k_for(1024)}, from a first step's memory: one fused launch per "
          f"sparse bucket { {m: c for m, c in launches.items()} } (auto: "
          f"the {auto} branch), each step's new memory and applied sparse "
          f"buckets bitwise the plain version's on the card; threshold == "
          f"auto bitwise {same}, finite {finite}, new memory dtypes "
          f"{dtypes}")
    if not (same and finite):
        fail("bf16 bucket memory: the branches differ or a value is not "
             "finite")
    del results, g_tree, memory, plain
    torch.cuda.empty_cache()

    small = build_model(get_smoke_config(ARCH).replace(
        compute_dtype="float32"))
    host = small.init(seed=0, device="cpu")
    b_np = next(token_batches(small.cfg.vocab_size, 4, 64, seed=1))
    gh, _ = _grads(small, host, {k: torch.from_numpy(v)
                                 for k, v in b_np.items()})
    treedef = tree_flatten(host)[1]
    splan = bk.make_plan(small.param_shapes(), cols=1024, dense_below=16_384)
    gen = torch.Generator().manual_seed(74)
    mem = [torch.randn(s.shape, generator=gen).to(BF16)
           for s in splan.buckets]
    outs = {}
    for d in ("cpu", dev):
        applied, new_m, _ = bk.bucket_memory_step(
            splan, [m.to(d) for m in mem],
            treedef.unflatten([g.to(d) for g in gh]), 0.37, k_for)
        outs[str(d)] = [t.cpu() for t in tree_leaves(applied) + list(new_m)]
    if not all(same_bits(a, b) for a, b in zip(*outs.values())):
        fail("bf16 bucket memory: the card's step differs from the CPU's "
             "on the small input")
    print(f"bf16 bucket memory, small input ({ARCH} smoke config, buckets "
          f"{[(s.kind, s.shape) for s in splan.buckets]}, eta 0.37): the "
          "card's step bitwise the CPU's plain version")
    return launches


def _rank_fail(msg: str):
    """A pod rank's failure: raised, so that the spawn reports it and ends
    the other ranks."""
    raise RuntimeError(f"pod sync rank: {msg}")


def _same_on_every_rank(t: torch.Tensor) -> bool:
    """Whether every rank holds ``t`` bit for bit: rank 0's copy broadcast
    and compared on each, the verdicts reduced."""
    import torch.distributed as dist

    ref = t.clone() if dist.get_rank() == 0 else torch.empty_like(t)
    dist.broadcast(ref, 0)
    ok = torch.tensor([int(same_bits(ref, t))], device=t.device)
    del ref
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    return bool(ok.item())


def _pod_profile(model, tc, layout, params, memory, batches, live, dev,
                 n: int = 2) -> dict:
    """``n`` steps of the pod path at the live ks under torch.profiler on
    this rank, after one unprofiled step: wall and device-busy ms per step
    (this process's kernels; the four ranks share the card in turns), and
    the three kernels that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.train import make_train_step

    step = make_train_step(model, tc, layout)
    it = iter(batches)
    count = POD_STEPS
    params, memory, opt, count, _ = step(params, memory, (), count, next(it),
                                         live)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            params, memory, opt, count, _ = step(params, memory, opt, count,
                                                 next(it), live)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:3]
    return {"wall_ms": wall, "busy_ms": busy,
            "top": [[e.key[:80], e.self_device_time_total / 1e3 / n]
                    for e in top]}


def pod_rank_work(rank: int, dev) -> dict:
    """The pod phase's work on one rank (see ``phase_pod``); raises on any
    failed check. Returns what the parent prints and compares."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.configs import PodRefreshConfig, get_smoke_config
    from repro_torch.core import buckets as bk
    from repro_torch.core.distributed import (SyncConfig,
                                              bucketed_message_bytes,
                                              bucketed_sync_gradients)
    from repro_torch.core.selfcheck import (local_quant_selfcheck,
                                            overlap_selfcheck,
                                            repack_selfcheck)
    from repro_torch.data import ShardedBatcher, token_batches
    from repro_torch.kernels.ops import _resolve_method
    from repro_torch.kernels.ref import eta32
    from repro_torch.launch.mesh import make_layout
    from repro_torch.launch.train import TrainConfig, _grads, train
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_map

    W = PODS * POD_DATA
    layout = make_layout(PODS)
    model = full_model(POD_ARCH, POD_LAYERS)
    V = model.cfg.vocab_size
    plan = bk.make_plan(model.param_shapes(), cols=POD_SHAPE[1],
                        dense_below=16_384)
    sparse = [s.shape for s in plan.buckets if s.kind == "sparse"]
    if sparse != [POD_SHAPE]:
        _rank_fail(f"sparse buckets {sparse}, expected [{POD_SHAPE}]")
    k_row = round(RATIO * POD_SHAPE[1])
    # the pod re-select's kernel (argmax_onehot at k <= k_max <= 64: the
    # loop) and the calibration's (row_topk "auto" at k_row)
    reselect = "row_topk_loop"
    calib = f"row_topk_{_resolve_method('auto', k_row, dev)}"
    lnv = math.log(V)
    quiet = print if rank == 0 else (lambda line: None)
    out = {"rank": rank, "pod": layout.pod, "data": layout.data}

    def run(label, tc, steps, n_calib, reselect=reselect, n_sync=None):
        batches = ShardedBatcher(token_batches(V, BATCH, SEQ, seed=0), dev)
        tel = step_clock(quiet)
        params = model.init(seed=0, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launch_counts()
        params, memory, _, count, _ = train(
            model, tc, batches, steps, device=dev, params=params,
            log_every=1, telemetry=tel, layout=layout)
        torch.cuda.synchronize()
        counts = launch_counts()
        want = {name: 0 for name in counts}
        n_sync = steps if n_sync is None else n_sync
        want[fused_branch(k_row)] = n_sync
        want[reselect] += n_sync
        if layout.pod == 0:  # pod 0's ranks simulate the pod mean
            want[calib] += n_calib
        losses = tel.losses
        rec = {"losses": losses, "launches": counts,
               "step_ms": [1e3 * (b - a) for a, b in
                           zip(tel.times, tel.times[1:-1])],
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "schedule": [[i, list(ks)] for i, ks in tel.refresh_schedule],
               "initial_ks": list(tel.initial_pod_ks or ()),
               "bytes": tel.bytes_per_step}
        if len(losses) != steps or not all(map(math.isfinite, losses)) \
                or not lnv - 1 <= losses[0] <= lnv + 2 \
                or not losses[-1] < losses[0]:
            _rank_fail(f"{label}: losses {losses} not {steps} finite from "
                       f"ln V = {lnv:.3f} and falling")
        if counts != want or count != steps:
            _rank_fail(f"{label}: launches {counts}, expected {want}")
        return rec, params, memory, tel

    # the refresh run: autotuned, pod ks refreshed every POD_REFRESH steps
    sync = SyncConfig(strategy="hierarchical", ratio=RATIO, bucketed=True,
                      wire="packed")
    tc = TrainConfig(eta=POD_ETA, sync=sync,
                     pod_refresh=PodRefreshConfig(every=POD_REFRESH))
    n_refresh = sum(1 for i in range(1, POD_STEPS) if i % POD_REFRESH == 0)
    rec, params, memory, tel = run("refresh run", tc, POD_STEPS,
                                   1 + n_refresh)
    rec["params_same_on_every_rank"] = all(
        _same_on_every_rank(p) for p in tree_leaves(params))
    if not rec["params_same_on_every_rank"]:
        _rank_fail("the params differ across the ranks")
    out["refresh run"] = rec
    live = tuple(tel.refresh_schedule[-1][1])
    dyn = dataclasses.replace(tc, sync=dataclasses.replace(
        sync, pod_dynamic=True), pod_refresh=None)
    more = ShardedBatcher(token_batches(V, BATCH, SEQ, seed=5), dev)
    out["profile"] = _pod_profile(model, dyn, layout, params, memory, more,
                                  live, dev)

    # a probe sync on the run's state through the repack boundary: the
    # bytes each level realized, and the mass conserved through an
    # all-reduce
    step_sync = dataclasses.replace(dyn.sync, pod_axis="pod", repack=True)
    grads, _ = _grads(model, params, {k: v for k, v in next(iter(
        ShardedBatcher(token_batches(V, BATCH, SEQ, seed=7), dev))).items()})
    g_tree = tree_flatten(params)[1].unflatten(grads)
    level = {"intra": 0, "cross": 0}
    upd, new_m, _ = bucketed_sync_gradients(
        step_sync, plan, memory, g_tree, POD_ETA, layout=layout, pod_ks=live,
        level_bytes=level)
    accounted = bucketed_message_bytes(step_sync, plan, by_level=True,
                                       pod_ks=live)
    flat = bucketed_message_bytes(
        SyncConfig(ratio=RATIO, bucketed=True, wire="packed",
                   pod_axis="pod"), plan, by_level=True, n_data=POD_DATA)
    u = bk.pack(plan, g_tree, dtype=torch.float32)
    del grads, g_tree
    upd = bk.pack(plan, upd)
    worst = 0.0
    for b, spec in enumerate(plan.buckets):
        u[b].mul_(eta32(POD_ETA)).add_(memory[b])  # u = m + eta * g
        for t in (u[b], new_m[b]):
            dist.all_reduce(t)
            t.div_(W)
        upd[b].add_(new_m[b])
        worst = max(worst, float((u[b] - upd[b]).abs().max()
                                 / u[b].abs().max()))
    out["probe"] = {"level": level, "accounted": accounted,
                    "flat": flat, "conservation": worst, "live": list(live)}
    if level != {k: accounted[k] for k in level}:
        _rank_fail(f"realized bytes {level}, accounted {accounted}")
    if not level["cross"] < flat["cross"]:
        _rank_fail(f"cross-pod {level['cross']} B not below the flat "
                   f"path's {flat['cross']} B")
    if worst > 1e-6:
        _rank_fail(f"mass conservation off by {worst:.3g} of max |u|")
    del params, memory, u, upd, new_m, more
    torch.cuda.empty_cache()

    # the pod_budgeted preset at a cross-pod byte budget
    preset = SyncConfig.preset("pod_budgeted", ratio=RATIO)
    budget = bucketed_message_bytes(
        dataclasses.replace(preset, pod_axis="pod"), plan, by_level=True,
        pod_ks=[POD_BUDGET_K if s.kind == "sparse" else 1
                for s in plan.buckets])["cross"]
    tc_b = TrainConfig(eta=POD_ETA, sync=dataclasses.replace(
        preset, byte_budget=budget), pod_refresh=PodRefreshConfig(
            every=POD_REFRESH))
    rec_b, params, memory, _ = run(
        "pod_budgeted run", tc_b, POD_BUDGET_STEPS,
        1 + sum(1 for i in range(1, POD_BUDGET_STEPS)
                if i % POD_REFRESH == 0))
    rec_b["budget"] = budget
    if not rec_b["bytes"]["cross"] <= budget:
        _rank_fail(f"pod_budgeted: {rec_b['bytes']} over the budget "
                   f"{budget} B")
    out["pod_budgeted run"] = rec_b
    # the same run at overlap off and on (its chains' R stage included):
    # params and memory bitwise the run's above (overlap None), on every
    # rank
    kept = [t.cpu() for t in tree_leaves(params) + list(memory)]
    del params, memory
    torch.cuda.empty_cache()
    for ov in (False, True):
        name = f"pod_budgeted run, overlap {'on' if ov else 'off'}"
        rec_o, params, memory, _ = run(name, dataclasses.replace(
            tc_b, sync=dataclasses.replace(tc_b.sync, overlap=ov)),
            POD_BUDGET_STEPS, 1 + sum(1 for i in range(1, POD_BUDGET_STEPS)
                                      if i % POD_REFRESH == 0))
        rec_o["bitwise_overlap_none"] = all(
            same_bits(a, b.cpu()) for a, b in zip(
                kept, tree_leaves(params) + list(memory)))
        if not rec_o["bitwise_overlap_none"]:
            _rank_fail(f"{name}: params or memory differ from overlap None")
        out[name] = rec_o
        del params, memory
        torch.cuda.empty_cache()
    del kept

    # the chain at bf16 wire values: the pod mean, its re-select and the
    # residual in bf16. threshold_onehot (the reference's threshold select
    # at k_row = 10, above its loop cutover) re-selects the bf16 pod mean
    # with the bf16 row top-k, "auto" at k_max = POD_DATA * k_row = 20: the
    # loop; argmax_onehot's argmax loop would take the float32 keys.
    # Autotuned (the calibration's selections move in float32, as the
    # reference measures) and refreshed every POD_REFRESH steps
    sync16 = dataclasses.replace(sync, value_dtype="bfloat16",
                                 selection="threshold_onehot")
    tc16 = TrainConfig(eta=POD_ETA, sync=sync16,
                       pod_refresh=PodRefreshConfig(every=POD_REFRESH))
    rec16, params, memory, tel16 = run(
        "bf16 run", tc16, POD_BF16_STEPS,
        1 + sum(1 for i in range(1, POD_BF16_STEPS) if i % POD_REFRESH == 0),
        reselect=f"row_topk_{_resolve_method('auto', POD_DATA * k_row, dev)}"
                 "_bf16")
    rec16["params_same_on_every_rank"] = all(
        _same_on_every_rank(p) for p in tree_leaves(params))
    if not rec16["params_same_on_every_rank"]:
        _rank_fail("bf16 run: the params differ across the ranks")
    # two probe syncs on its state at its last pod ks, through the repack
    # boundary: argmax_onehot (the float32 loop kernel on the pod mean's
    # float32 keys: at two workers a pod the product by 1/2 is the bf16
    # pod mean's value, above bf16's subnormals) and topk_scatter (the bf16
    # threshold kernel, the scatter densify: at two terms a column the
    # same bits); each launch count zeroed before and read after
    live16 = tuple((tel16.refresh_schedule or [(0, tel16.initial_pod_ks)])
                   [-1][1])
    grads, _ = _grads(model, params, {k: v for k, v in next(iter(
        ShardedBatcher(token_batches(V, BATCH, SEQ, seed=8), dev))).items()})
    g_tree = tree_flatten(params)[1].unflatten(grads)
    del grads
    n_sparse = sum(s.kind == "sparse" for s in plan.buckets)
    probes = {}
    for selection, kernel in (("argmax_onehot", "row_topk_loop"),
                              ("topk_scatter", "row_topk_threshold_bf16")):
        cfg16 = dataclasses.replace(sync16, pod_axis="pod", pod_dynamic=True,
                                    repack=True, selection=selection)
        level = {"intra": 0, "cross": 0}
        torch.cuda.synchronize()
        zero_launch_counts()
        upd, _, _ = bucketed_sync_gradients(
            cfg16, plan, memory, g_tree, POD_ETA, layout=layout,
            pod_ks=live16, level_bytes=level)
        torch.cuda.synchronize()
        counts = launch_counts()
        accounted = bucketed_message_bytes(cfg16, plan, by_level=True,
                                           pod_ks=live16)
        upd = bk.pack(plan, upd)
        same = all(_same_on_every_rank(u) for u in upd)
        want = {name: 0 for name in counts}
        want[fused_branch(k_row)] = n_sparse
        want[kernel] = n_sparse
        probes[selection] = {"level": level, "accounted": accounted,
                             "launches": counts, "update": upd,
                             "same_on_every_rank": same}
        if counts != want:
            _rank_fail(f"bf16 probe ({selection}): launches {counts}, "
                       f"expected {want}")
        if level != {k: accounted[k] for k in level}:
            _rank_fail(f"bf16 probe ({selection}): realized bytes {level}, "
                       f"accounted {accounted}")
        if not same:
            _rank_fail(f"bf16 probe ({selection}): the update differs across "
                       "the ranks")
    both = all(same_bits(a, b) for a, b in zip(
        probes["argmax_onehot"].pop("update"),
        probes["topk_scatter"].pop("update")))
    if not both:
        _rank_fail("bf16 probe: argmax_onehot and topk_scatter differ")
    rec16["probes"] = probes
    rec16["live"] = list(live16)
    out["bf16 run"] = rec16
    del params, memory, g_tree
    torch.cuda.empty_cache()
    out["qsparse run"] = pod_qsparse(model, plan, layout, run, dev)

    # a small input: rwkv6-3b's smoke config in float32, this rank's
    # quarter of the batch; the gradients on the card and the CPU (1e-3
    # relative L2 a leaf, the loss 1e-5), then the 4-rank sync on the CPU
    # from the card's gradients must give the card's bit for bit
    small = build_model(get_smoke_config(POD_ARCH).replace(
        compute_dtype="float32"))
    host = small.init(seed=0, device="cpu")
    card = tree_map(lambda t: t.to(dev, copy=True), host)
    b_np = next(token_batches(small.cfg.vocab_size, 4, 64, seed=1))
    mine = {k: torch.from_numpy(v[rank:rank + 1]) for k, v in b_np.items()}
    gh, mh = _grads(small, host, mine)
    gc, mc = _grads(small, card, {k: v.to(dev) for k, v in mine.items()})
    grad_err = max(float((a.cpu() - b).norm() / b.norm().clamp(min=1e-30))
                   for a, b in zip(gc, gh))
    lc, lh = float(mc["xent"].detach()), float(mh["xent"].detach())
    loss_err = abs(lc - lh) / abs(lh)
    # rwkv6-3b's float32 gradients differ by ~1e-4 between summation
    # orders (phase 7 holds its update to 1e-3 relative L2 for the same
    # reason): the sync below is then held bitwise from one set of them
    if grad_err > 1e-3 or loss_err > 1e-5:
        _rank_fail(f"small input: card vs CPU gradients {grad_err:.3g}, "
                   f"loss {loss_err:.3g}")
    splan = bk.make_plan(small.param_shapes(), cols=POD_SHAPE[1],
                         dense_below=16_384)
    ssync = SyncConfig.preset("pod_budgeted", ratio=POD_SMALL_RATIO,
                              pod_axis="pod")
    ks = tuple(POD_SMALL_K if s.kind == "sparse" else 1
               for s in splan.buckets)
    rng = np.random.default_rng(50 + rank)
    mem = [torch.from_numpy(rng.standard_normal(s.shape).astype(np.float32))
           for s in splan.buckets]
    treedef = tree_flatten(host)[1]
    synced = {}
    for name, d in (("cpu", "cpu"), ("card", dev)):
        upd, new_m, _ = bucketed_sync_gradients(
            ssync, splan, [m.to(d) for m in mem],
            treedef.unflatten([g.to(d) for g in gc]), POD_ETA,
            layout=layout, pod_ks=ks)
        synced[name] = [t.cpu() for t in tree_leaves(upd) + list(new_m)]
    same = all(same_bits(a, b) for a, b in zip(*synced.values()))
    if not same:
        _rank_fail("small input: the card's two-level sync differs from the "
                   "CPU's on the same gradients")

    # invariant 9 through the driver, on the card: the runtime pod k fed a
    # constant live k (a one-entry schedule) gives the static pod k's
    # params and memory bit for bit
    ratios = tuple(1.0 if s.kind == "dense" else k / s.cols
                   for s, k in zip(splan.buckets, ks))
    runs = {}
    for name, sched in (("static", None), ("dynamic", [(0, ks)])):
        tc_s = TrainConfig(eta=POD_ETA, sync=SyncConfig(
            strategy="hierarchical", ratio=POD_SMALL_RATIO, bucketed=True,
            wire="packed", pod_ratios=ratios))
        params, memory, *_ = train(
            small, tc_s, ShardedBatcher(token_batches(
                small.cfg.vocab_size, 4, 64, seed=2), dev), 3, device=dev,
            params=tree_map(lambda t: t.to(dev, copy=True), host),
            telemetry=step_clock(lambda line: None), layout=layout,
            pod_k_schedule=sched)
        runs[name] = tree_leaves(params) + list(memory)
    const = all(same_bits(a, b) for a, b in zip(*runs.values()))
    if not const:
        _rank_fail("a constant live pod k differs from the static pod k")
    out["small"] = {"grad_err": grad_err, "loss_err": loss_err,
                    "sync_bitwise": same, "constant_live_k_bitwise": const}

    # the bucket pipeline's self-checks on this layout, on the card
    checks = {"overlap": overlap_selfcheck(layout, device=dev),
              "repack": repack_selfcheck(layout, device=dev),
              "local_quant": local_quant_selfcheck(layout, device=dev)}
    if not all(v for c in checks.values() for k, v in c.items()
               if k not in ("padded_vs_live_bytes",
                            "quant_conservation_max_err")) \
            or not checks["local_quant"]["quant_conservation_max_err"] < 1e-5:
        _rank_fail(f"self-checks: {checks}")
    out["selfchecks"] = checks
    return out


def pod_qsparse(model, plan, layout, run, dev) -> dict:
    """The pod phase's Qsparse-local-SGD run on one rank (phase 17): the
    two-level chain at POD_QUANT_H local steps and POD_QUANT_S levels on
    the packed wire, autotuned, POD_QUANT_STEPS steps through ``run`` (one
    fused and one re-select launch a sync step; params bitwise on every
    rank); then a probe sync on its state with the pod k at k_row: the
    level-2 codes (the pod summary's) identical on the ranks of each pod,
    each level's realized bytes the accounting, mass conserved within 1e-5
    through an all-reduce. Returns what the parent prints."""
    import torch.distributed as dist

    import repro_torch.core.distributed as dist_mod
    from repro_torch.core import buckets as bk
    from repro_torch.core.distributed import (SyncConfig, WireConfig,
                                              amortized_bytes_per_step,
                                              bucketed_message_bytes)
    from repro_torch.data import ShardedBatcher, token_batches
    from repro_torch.kernels.ref import eta32
    from repro_torch.launch.train import TrainConfig, _grads
    from repro_torch.optim.qsgd import QuantNoise
    from repro_torch.utils.tree import tree_flatten, tree_leaves

    W = PODS * POD_DATA
    V = model.cfg.vocab_size
    sync = SyncConfig(strategy="hierarchical", ratio=RATIO, bucketed=True,
                      local_steps=POD_QUANT_H,
                      wire=WireConfig(wire="packed", quant=POD_QUANT_S))
    rec, params, memory, _ = run(
        "qsparse run", TrainConfig(eta=POD_ETA, sync=sync), POD_QUANT_STEPS,
        1, n_sync=POD_QUANT_STEPS // POD_QUANT_H)
    rec["params_same_on_every_rank"] = all(
        _same_on_every_rank(p) for p in tree_leaves(params))
    if not rec["params_same_on_every_rank"]:
        _rank_fail("qsparse run: the params differ across the ranks")
    probe = sync.with_pod(axis="pod")
    grads, _ = _grads(model, params, {k: v for k, v in next(iter(
        ShardedBatcher(token_batches(V, BATCH, SEQ, seed=9), dev))).items()})
    g_tree = tree_flatten(params)[1].unflatten(grads)
    del grads, params
    level, codes = {"intra": 0, "cross": 0}, []
    real = dist_mod._quantize_selected

    def spy(cfg, vals, uniforms):
        q = real(cfg, vals, uniforms)
        codes.append(q[1])
        return q

    dist_mod._quantize_selected = spy
    try:
        upd, new_m, _ = dist_mod.bucketed_sync_gradients(
            probe, plan, [m.clone() for m in memory], g_tree, POD_ETA,
            layout=layout, level_bytes=level,
            quant_noise=QuantNoise(0, POD_QUANT_STEPS))
    finally:
        dist_mod._quantize_selected = real
    accounted = bucketed_message_bytes(probe, plan, by_level=True)
    # the sparse bucket's level-2 codes: each rank's against its pod's
    got = dist_mod._all_gather(codes[1], layout.data_group)
    same_in_pod = all(same_bits(got[0], g) for g in got[1:])
    del got, codes
    u = bk.pack(plan, g_tree, dtype=torch.float32)
    del g_tree
    upd = bk.pack(plan, upd)
    worst = worst_rel = 0.0
    for b, spec in enumerate(plan.buckets):
        u[b].mul_(eta32(POD_ETA)).add_(memory[b])  # u = m + eta * g
        for t in (u[b], new_m[b]):
            dist.all_reduce(t)
            t.div_(W)
        upd[b].add_(new_m[b])
        err = float((u[b] - upd[b]).abs().max())
        worst = max(worst, err)
        worst_rel = max(worst_rel, err / float(u[b].abs().max()))
    rec["probe"] = {"level": level, "accounted": accounted,
                    "level2_codes_same_in_pod": same_in_pod,
                    "conservation": worst, "conservation_rel": worst_rel,
                    "amortized": amortized_bytes_per_step(
                        probe, plan, by_level=True)}
    if not same_in_pod:
        _rank_fail("qsparse probe: the level-2 codes differ within a pod")
    if level != {k: accounted[k] for k in level}:
        _rank_fail(f"qsparse probe: realized bytes {level}, accounted "
                   f"{accounted}")
    if worst > 1e-5:
        _rank_fail(f"qsparse probe: mass conservation off by {worst:.3g}")
    del memory, u, upd, new_m
    torch.cuda.empty_cache()
    return rec


def pod_rank(rank: int, tmp: str) -> None:
    """One spawned rank of the pod phase: joins the gloo group on the one
    card and writes its results to ``tmp``."""
    import datetime

    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp}/pg", rank=rank,
        world_size=PODS * POD_DATA, timeout=datetime.timedelta(seconds=600))
    try:
        out = pod_rank_work(rank, torch.device("cuda", 0))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)


def phase_pod(dev) -> dict:
    """The two-level pod sync (see POD_ARCH): its top-k launches at their
    shape (``phase_pod_reselect``), then PODS * POD_DATA ranks spawned
    on the one card in a gloo group: NCCL refuses two ranks on one device,
    and gloo moves the CUDA tensors through the host, so the gathers' times
    are not the card's. Each rank (pod_rank_work): the refresh run and the
    pod_budgeted run through ``train()`` (finite, falling losses; every
    launch count zeroed before and read after: one fused and one pod
    re-select launch per sparse bucket a step, and on pod 0's ranks one
    calibration top-k per calibration; params bitwise equal on every
    rank); a profile of two steps; a probe sync (the bytes each level
    realized equal to ``bucketed_message_bytes(by_level=True,
    pod_ks=live)``, cross below the flat path's n_data messages, mean_w(u)
    == update + mean_w(new memory) through an all-reduce within 1e-6 of
    max |u|); the budget held; a small input (card vs CPU loss 1e-5,
    gradients 1e-3, the sync from the card's gradients bitwise on both) and a constant
    live pod k against the static pod k (params and memory bitwise).
    Returns the launches of each run by rank."""
    import gc
    import tempfile

    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    reselect = phase_pod_reselect(dev)
    gc.collect()
    torch.cuda.empty_cache()
    W = PODS * POD_DATA
    print(f"pod sync: {POD_ARCH} {POD_LAYERS} layers at full width, {W} "
          f"ranks in a ({PODS} pods x {POD_DATA} data) gloo group on the "
          "one card (NCCL refuses two ranks on one device; gloo stages the "
          f"CUDA tensors through the host), batch {BATCH} x seq {SEQ}, eta "
          f"{POD_ETA}")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            mp.spawn(pod_rank, args=(tmp,), nprocs=W, join=True)
        except ProcessException as e:
            fail(f"pod sync phase: {e}")
        recs = []
        for r in range(W):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                recs.append(json.load(fh))
    secs = time.perf_counter() - t0
    if [(r["pod"], r["data"]) for r in recs] != [
            (p, d) for p in range(PODS) for d in range(POD_DATA)]:
        fail("pod sync: the ranks do not form the (pod, data) layout")
    launches = {}
    for run in ("refresh run", "pod_budgeted run",
                "pod_budgeted run, overlap off", "pod_budgeted run, overlap on",
                "bf16 run", "qsparse run"):
        first = recs[0][run]
        for r in recs[1:]:
            if (r[run]["losses"], r[run]["schedule"]) != (
                    first["losses"], first["schedule"]):
                fail(f"pod sync {run}: the ranks' losses or pod-k schedules "
                     "differ")
        launches[run] = {f"rank {r['rank']}": r[run]["launches"]
                         for r in recs}
        print(f"pod sync {run}: losses {first['losses']}; initial pod ks "
              f"{first['initial_ks']}, refreshes {first['schedule']}; bytes "
              f"per step {first['bytes']}"
              + (f" (budget {first['budget']} B)" if "budget" in first
                 else ""))
        for r in recs:
            x = r[run]
            print(f"  rank {r['rank']} (pod {r['pod']}, data {r['data']}): "
                  f"step ms after the first {[round(t, 2) for t in x['step_ms']]}"
                  f" (mean {sum(x['step_ms']) / len(x['step_ms']):.2f}); "
                  f"peak {x['peak_gib']:.2f} GiB; launches {x['launches']}")
    busy = [r["profile"]["busy_ms"] for r in recs]
    wall = max(r["profile"]["wall_ms"] for r in recs)
    print(f"pod sync profile (2 steps at the live ks): wall "
          f"{[round(r['profile']['wall_ms'], 2) for r in recs]} ms/step, "
          f"device busy {[round(b, 2) for b in busy]} ms/step by rank, "
          f"{sum(busy):.2f} together ({100 * sum(busy) / wall:.1f}% of the "
          f"slowest rank's wall); rank 0's top kernels "
          f"{recs[0]['profile']['top']}")
    rec16 = recs[0]["bf16 run"]
    for sel, p in rec16["probes"].items():
        print(f"pod sync bf16 probe ({sel}) at live ks {rec16['live']}: "
              f"realized {p['level']} B/step/worker, accounted at bf16 "
              f"{p['accounted']}; launches {p['launches']}; the update "
              "bitwise on every rank")
        launches[f"bf16 probe, {sel}"] = {
            f"rank {r['rank']}": r["bf16 run"]["probes"][sel]["launches"]
            for r in recs}
    print("pod sync bf16 probes: argmax_onehot and topk_scatter bitwise "
          "equal (two terms a column at each level)")
    probe = recs[0]["probe"]
    print(f"pod sync probe at live ks {probe['live']}: realized "
          f"{probe['level']} B/step/worker, accounted "
          f"{probe['accounted']}; the flat path's cross-pod "
          f"{probe['flat']['cross']} B; mass conservation worst "
          f"{max(r['probe']['conservation'] for r in recs):.3g} of max |u|")
    small = [r["small"] for r in recs]
    print(f"pod sync small input: card vs CPU gradients max "
          f"{max(x['grad_err'] for x in small):.3g}, loss "
          f"{max(x['loss_err'] for x in small):.3g}; the 4-rank sync from "
          "the card's gradients bitwise on the card and the CPU; a constant "
          "live pod k bitwise the static pod k (params and memory)")
    print("pod sync pod_budgeted run at overlap off and on: params and "
          "memory bitwise the overlap None run's on every rank")
    q = recs[0]["qsparse run"]["probe"]
    print(f"pod sync qsparse run (local_steps {POD_QUANT_H}, quant "
          f"{POD_QUANT_S}): params bitwise on every rank; probe sync: "
          f"realized {q['level']} B/worker a sync, accounted "
          f"{q['accounted']}, amortized a step {q['amortized']}; level-2 "
          f"codes identical within each pod on every rank: "
          f"{all(r['qsparse run']['probe']['level2_codes_same_in_pod'] for r in recs)}; "
          f"mass conservation worst "
          f"{max(r['qsparse run']['probe']['conservation'] for r in recs):.3g} "
          f"({max(r['qsparse run']['probe']['conservation_rel'] for r in recs):.3g} "
          "of max |u|)")
    checks = recs[0]["selfchecks"]
    print(f"pod sync self-checks on the (2, 2) layout, on the card: "
          f"overlap {checks['overlap']}; repack {checks['repack']}; "
          f"local_quant {checks['local_quant']}")
    print(f"pod sync phase: {secs:.1f} s; its top-k launches {reselect}")
    return launches


def device_profile(fn, n: int) -> tuple:
    """(wall ms, device-busy ms) per call of ``fn`` over ``n`` calls under
    torch.profiler (kernel time, one stream), and its top kernels: (name,
    ms a call, launches a call), the launches showing whether the trace
    kept every kernel record."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return wall, busy, [(e.key[:80], e.self_device_time_total / 1e3 / n,
                         e.count / n) for e in top]


def serve_decode(dev, arch: str, depth: int) -> dict:
    """``decode_loop`` of ``arch`` at full width (depth cut): the prompt
    teacher-forced, then greedy generation; its ms a step (host clock,
    synchronized), then SERVE_PROFILE profiled steps (device busy) and the
    per-step cast of the float32 params to bf16 (``Model._cast``) timed
    alone with CUDA events: its share of a step's device time (a trace
    has been seen to drop kernel records, which would understate it).
    Fails unless the tokens lie in the vocabulary and the logits are
    finite."""
    from repro_torch.launch.serve import decode_loop, make_serve_step

    model = full_model(arch, depth)
    cfg = model.cfg
    params = model.init(seed=0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    B = SERVE_BATCH
    prompts = torch.randint(0, cfg.vocab_size, (B, SERVE_PROMPT),
                            generator=gen, device=dev, dtype=torch.int32)
    decode_loop(model, params, prompts[:, :2], 2, SERVE_MAX_LEN)  # warm up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    toks = decode_loop(model, params, prompts, SERVE_GEN, SERVE_MAX_LEN)
    torch.cuda.synchronize()
    n = SERVE_PROMPT - 1 + SERVE_GEN
    ms = (time.perf_counter() - t0) * 1e3 / n
    peak = torch.cuda.max_memory_allocated() / 2**30
    if (tuple(toks.shape) != (B, SERVE_GEN) or toks.dtype != torch.int32
            or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size):
        fail(f"{arch} decode: tokens {tuple(toks.shape)} {toks.dtype} "
             f"outside [0, {cfg.vocab_size})")
    step = make_serve_step(model, B)
    state = {"cache": model.init_cache(B, SERVE_MAX_LEN, device=dev),
             "tok": prompts[:, 0]}

    def one():
        state["tok"], state["cache"] = step(params, state["cache"],
                                            state["tok"])

    one()
    wall, busy, top = device_profile(one, SERVE_PROFILE)
    cast = cuda_ms(lambda: model._cast(params), SERVE_PROFILE)
    leaves = len(tree_leaves_of(params))
    logits, _ = model.decode_step(params, state["cache"], state["tok"])
    if not bool(torch.isfinite(logits.float()).all()):
        fail(f"{arch} decode: non-finite logits")
    cache_gib = sum(x.numel() * x.element_size()
                    for x in tree_leaves_of(state["cache"])) / 2**30
    print(f"serve decode: {arch} {depth} layers at full width, "
          f"{model.n_params()} params, batch {B}, bf16 cache of "
          f"{SERVE_MAX_LEN} positions ({cache_gib:.3f} GiB), prompt "
          f"{SERVE_PROMPT} teacher-forced + {SERVE_GEN} generated: "
          f"{ms:.3f} ms/step (host clock, {n} steps); profiled "
          f"{SERVE_PROFILE} steps: wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms ({100 * busy / wall:.1f}%); the params' cast "
          f"({leaves} leaves, CUDA events) {cast:.3f} ms "
          f"({100 * cast / busy:.1f}% of the busy time); peak "
          f"{peak:.2f} GiB; first tokens {toks[0, :6].tolist()}")
    for key, t, count in top:
        print(f"    {t:8.3f} ms/step x{count:g} {key}")
    return {"ms_per_step": ms, "wall": wall, "busy": busy, "cast": cast}


def tree_leaves_of(tree) -> list:
    from repro_torch.utils.tree import tree_leaves

    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def transcode_error(dspec, msgs) -> float:
    """One step's ``||u - bf16(u)||_inf``: the largest change the bf16
    transcode makes to the step's decoded update (the hub's
    ``drift_bound`` term for one step)."""
    from repro_torch.core import encoding as enc
    from repro_torch.launch import delta_stream as ds

    half = dspec.with_value_dtype("bfloat16")
    worst = 0.0
    for w, hw, m, t in zip(dspec.wires, half.wires, msgs,
                           ds.transcode_delta(dspec, msgs)):
        a = enc.decode(w, m)[0].float()
        b = enc.decode(hw, t)[0].float()
        worst = max(worst, float((a - b).abs().max()))
    return worst


def bitwise_trees(a, b) -> bool:
    xs, ys = tree_leaves_of(a), tree_leaves_of(b)
    return len(xs) == len(ys) and all(same_bits(x, y)
                                      for x, y in zip(xs, ys))


def serve_small(dev) -> None:
    """Each family's smoke config in float32, decoded on the card and on
    the CPU from the same params, every KV ring wrapping (SERVE_SMALL):
    every step's logits and the final caches within rtol 1e-4, atol 1e-4
    of the largest; the greedy tokens equal wherever the CPU's top-2
    margin exceeds twice that."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import greedy_tokens
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_map

    for arch, (over, S, max_len) in SERVE_SMALL.items():
        cfg = get_smoke_config(arch).replace(compute_dtype="float32", **over)
        model = build_model(cfg)
        host = model.init(seed=0, device="cpu")
        gen = torch.Generator().manual_seed(3)
        toks = torch.randint(0, cfg.vocab_size, (2, S), generator=gen,
                             dtype=torch.int32)
        out = {}
        for d in (torch.device("cpu"), dev):
            params = tree_map(lambda t: t.to(d, copy=True), host)
            cache = model.init_cache(2, max_len, torch.float32, device=d)
            logits = []
            for t in range(S):
                lg, cache = model.decode_step(params, cache, toks[:, t].to(d))
                logits.append(lg.cpu())
            out[d.type] = [torch.stack(logits, 1)] + [
                x.cpu() for x in tree_leaves_of(cache)]
        worst = max(float((g - w).abs().max() / w.abs().max())
                    for g, w in zip(out["cuda"], out["cpu"]))
        ok = all(torch.allclose(g, w, rtol=1e-4,
                                atol=1e-4 * float(w.abs().max()))
                 for g, w in zip(out["cuda"], out["cpu"]))
        want = out["cpu"][0][..., :cfg.vocab_size]
        top2 = torch.topk(want, 2, dim=-1).values
        margin = top2[..., 0] - top2[..., 1]
        sure = margin > 2e-4 * float(want.abs().max())
        same = torch.equal(greedy_tokens(out["cuda"][0], cfg.vocab_size)[sure],
                           greedy_tokens(out["cpu"][0], cfg.vocab_size)[sure])
        print(f"serve small input, {arch} ({S} tokens, max_len {max_len}, "
              f"{over}): logits and caches card vs cpu within {worst:.2e} of the "
              f"largest; greedy tokens {'equal' if same else 'DIFFER'} on "
              f"{int(sure.sum())} of {sure.numel()} (smallest margin "
              f"{float(margin.min()):.3g})")
        if not (ok and same):
            fail(f"the card's {arch} decode disagrees with the CPU's on the "
                 "small input")


def phase_serve(dev) -> tuple:
    """The serving side (phase 18): each family's decode at full width;
    qwen3-4b's bucketed trainer emitting its deltas to a replica and a
    fan-out hub; a wire checkpoint; the two top-k launches of the path
    held bitwise and timed; the small input. Returns (the run's launches,
    the kernels line's two entries)."""
    import tempfile

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core import buckets as bk
    from repro_torch.core.distributed import SyncConfig
    from repro_torch.data import DeviceBatcher, token_batches
    from repro_torch.launch import delta_stream as ds
    from repro_torch.kernels.ref import densify_rows_ref, row_topk_ref
    from repro_torch.launch.fanout import FanoutHub
    from repro_torch.launch.serve import replica_copy
    from repro_torch.launch.train import (TrainConfig, init_train_state,
                                          make_train_step)

    t_phase = time.perf_counter()
    decode = {arch: serve_decode(dev, arch, depth)
              for arch, depth in SERVE_DECODE.items()}
    torch.cuda.empty_cache()

    model = full_model(ARCH, N_LAYERS)
    tc = TrainConfig(optimizer="memsgd", eta=ETA, emit_deltas=True,
                     sync=SyncConfig(ratio=RATIO, bucketed=True))
    params, memory, opt, count = init_train_state(model, tc, device=dev,
                                                  seed=0)
    step = make_train_step(model, tc)
    dspec, plan = step.delta_spec, step.plan
    k_sel = max(w.k for w in dspec.wires if w.kind == "sparse")
    gib = dspec.dense_nbytes / 2**30
    print(f"serve stream: {ARCH} {N_LAYERS} layers bucketed (k = "
          f"{tc.sync.k_for(tc.sync.bucket_cols)}, W = 1: k' = {k_sel}), "
          f"delta {dspec.nbytes} B a step against a dense broadcast of "
          f"{dspec.dense_nbytes} B (x{dspec.dense_nbytes / dspec.nbytes:.2f})"
          f"; peak reckoned: the trainer's 26.6-31.2 GiB + the hub's packed "
          f"base, shadow and 2 replicas + the delta replica, 5 x {gib:.2f} "
          f"GiB = {31.2 + 5 * gib:.1f} GiB at a step, the late joiner and "
          f"the checkpoint after the steps")
    if dspec.nbytes != SERVE_DELTA_BYTES:
        fail(f"delta {dspec.nbytes} B a step, expected {SERVE_DELTA_BYTES}")
    replica = replica_copy(params)
    hub = FanoutHub(dspec, params, log_bound=SERVE_LOG)
    steady, edge = hub.join(), hub.join("bfloat16")
    batches = iter(DeviceBatcher(
        token_batches(model.cfg.vocab_size, BATCH, SEQ, seed=0), dev))
    bound, losses, times = 0.0, [], collections.defaultdict(list)

    def timed(label, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[label].append((time.perf_counter() - t0) * 1e3)
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    for i in range(SERVE_STEPS):
        params, memory, opt, count, m, delta = timed(
            "train step + delta encode",
            lambda: step(params, memory, opt, count, next(batches)))
        losses.append(m["loss"])
        if sum(d.numel() * 4 for d in delta) != dspec.nbytes:
            fail(f"step {i}: the delta's buffers are not {dspec.nbytes} B")
        timed("apply_delta", lambda: ds.apply_delta(replica, dspec, delta))
        timed("hub publish", lambda: hub.publish(i, delta))
        timed("hub sync float32", lambda: hub.sync(steady))
        timed("hub sync bf16", lambda: hub.sync(edge))
        bound += transcode_error(dspec, delta)
    late = hub.join()
    timed("late join + sync", lambda: hub.sync(late))
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp)
        timed("save_wire", lambda: ck.save_wire(
            SERVE_STEPS, params, memory, plan, base_params=hub.base,
            memory_ratio=SERVE_MEMORY_RATIO))
        restored, rmem, meta = timed("restore_wire", lambda: ck.restore_wire(
            plan=plan, base_params=hub.base))
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in losses]
    expect = {fused_branch(PATH_K): SERVE_STEPS,
              "row_topk_loop": SERVE_STEPS,
              "row_topk_threshold": 1}
    want = {name: expect.get(name, 0) for name in counts}
    drift = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(tree_leaves_of(params),
                                tree_leaves_of(edge.params)))
    st = hub.stats()
    w = meta["wire"]
    # the memory's records: the sparse bucket's capped at k_cap (lossy,
    # held below against the plain top-k), every other one exact
    b = next(i for i, s_ in enumerate(plan.buckets) if s_.kind == "sparse")
    k_cap = max(1, round(SERVE_MEMORY_RATIO * plan.buckets[b].cols))
    mem_recs = {r["index"]: r for r in w["records"]
                if r["section"] == "memory"}
    lossy = sorted(i for i, r in mem_recs.items() if not r["exact"])
    mem_kept = [int((r != 0).sum(1).max()) for r in rmem]
    mem_exact = len(rmem) == len(memory) == len(mem_recs) and all(
        same_bits(rmem[i], memory[i]) for i in mem_recs if i not in lossy)
    flags = {"replica": bitwise_trees(replica, params),
             "steady": bitwise_trees(steady.params, params),
             "late": bitwise_trees(late.params, params),
             "late resynced": late.resyncs == 1,
             "bf16 under bound": 0 < drift <= bound * 1.01 + 1e-6,
             "checkpoint params": bitwise_trees(restored, params),
             "checkpoint memory exact records": mem_exact,
             "checkpoint memory capped": (lossy == [b]
                                          and mem_recs[b]["k"] == k_cap
                                          and mem_kept[b] == k_cap),
             "launches": counts == want}
    print(f"serve stream run: losses {losses}; launches {counts}; peak "
          f"{peak:.2f} GiB; " + "; ".join(
              f"{k} {statistics.median(v):.2f} ms (median of {len(v)})"
              for k, v in times.items()))
    print(f"serve stream: bf16 replica drift {drift:.3e} against the bound "
          f"{bound:.3e} (the {SERVE_STEPS} steps' transcode errors; the "
          f"hub's drift_bound over its log {hub.drift_bound():.3e}); the "
          f"late joiner resynced x{late.resyncs} from a snapshot")
    print(f"serve hub stats: {json.dumps(st)}")
    print(f"serve wire checkpoint at step {SERVE_STEPS}: {w['nbytes']} B "
          f"against a dense dump of {w['dense_nbytes']} B "
          f"(x{w['ratio_vs_dense']:.2f}); records " + ", ".join(
              f"{r['section']}/{r['index']} {r['kind']} k={r['k']} "
              f"{r['nbytes']} B exact={r['exact']} dropped "
              f"{r['dropped_frac']:.4f}" for r in w["records"])
          + f"; memory rows keep <= {mem_kept} entries")
    print(f"serve flags: {flags}")
    if not all(math.isfinite(x) for x in losses) or not (
            losses[-1] < losses[0]):
        fail(f"serve stream: losses {losses}")
    if not all(flags.values()):
        fail(f"serve stream: {flags}; launches {counts}, expected {want}")

    # the path's two top-k launches, at their shapes and on their data
    upd = ds._decode_buf(dspec.wires[b], delta[b])
    mem_b, rmem_b = memory[b], rmem[b]
    del (replica, hub, steady, edge, late, restored, rmem, params, opt,
         delta, batches, step)
    memory = None
    torch.cuda.empty_cache()
    held = {"delta re-select": (held_topk(upd, k_sel, "serve delta "
                                          "re-select on an update"),
                                "row_topk_loop"),
            "memory cap": (held_topk(mem_b, k_cap, "serve memory cap on the "
                                     "memory"), "row_topk_threshold")}
    # the capped memory restores as the plain top-k of the trainer's
    # memory at k_cap, scattered into zeros, bit for bit
    want = densify_rows_ref(mem_b, *row_topk_ref(mem_b, k_cap))
    if not same_bits(rmem_b, want):
        fail(f"serve wire checkpoint: the restored memory of bucket {b} is "
             f"not the plain row top-k of the trainer's at k = {k_cap}")
    print(f"serve wire checkpoint: the restored memory of bucket {b} is "
          f"bitwise the plain row top-k of the trainer's at k = {k_cap}")
    del upd, mem_b, rmem_b, want
    torch.cuda.empty_cache()
    entries = []
    for label, (h, name) in held.items():
        entries.append({
            "name": f"{name} ({label})", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/topk_select.cu",
            "replaces": "src/repro/kernels/topk_select.py:"
            + ("315" if "threshold" in name else "285"),
            "max_abs_err": 0.0, "ms": h[f"{name}_ms"],
            "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
            "bound_by": h["bound_by"], "library_ms": h["library_ms"],
            "ok": True, "launches_from": f"serve stream, {label}",
            "launches": counts[name]})
    serve_small(dev)
    print(f"serve phase: {time.perf_counter() - t_phase:.1f} s; decode ms a "
          "step " + ", ".join(f"{a} {d['ms_per_step']:.3f}"
                              for a, d in decode.items()))
    return counts, entries


def main() -> None:
    t_start = time.perf_counter()
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    leaf_shapes = {arch: leaf_row_shapes(arch, depth)
                   for arch, depth in DEPTHS.items()}
    kernels = phase_fused(dev) + phase_topk(dev, leaf_shapes)
    bf16 = phase_bf16_kernels(dev)
    bf16_memory = phase_bf16_memory(dev)
    phase_cutover(dev)
    phase_single_row(dev)
    host = phase_host_pipeline(dev)
    pod_launches = phase_pod(dev)
    by_arch = {ARCH: {"bucketed": phase_bucketed(dev),
                      "topk preset": phase_topk_preset(dev),
                      "qsparse_local": phase_qsparse(dev),
                      "per-leaf": phase_leaf(dev, leaf_shapes[ARCH])}}
    overlap_launches = phase_overlap(dev, leaf_shapes[ARCH])
    by_arch.update(phase_moe(dev, leaf_shapes))
    for arch, (depth, nbytes) in DENSE.items():
        by_arch[arch] = {"per-leaf": phase_leaf(
            dev, leaf_shapes[arch], arch, depth, ("argmax_onehot",), nbytes,
            DENSE_STEPS)}
    by_arch[GRIFFIN_ARCH] = phase_griffin(dev, leaf_shapes)
    by_path = {"optimizer modes": phase_opt_modes(dev, leaf_shapes[ARCH]),
               f"seq {LONG_SEQ}": phase_long(dev), "pod sync": pod_launches,
               "bf16 bucket memory": bf16_memory,
               "overlap": overlap_launches,
               "host pipeline": {host["kernel"]: host["launches"]}}
    layer_costs(dev)
    by_arch[RWKV_ARCH] = {
        "bucketed": phase_bucketed(dev, RWKV_ARCH, RWKV_LAYERS, RWKV_SHAPE,
                                   RWKV_BYTES["bucketed"]),
        "topk preset": phase_topk_preset(
            dev, RWKV_ARCH, RWKV_LAYERS,
            {"packed": RWKV_BYTES["topk packed"],
             "unpacked": RWKV_BYTES["topk unpacked"]}),
        "per-leaf": phase_leaf(dev, leaf_shapes[RWKV_ARCH], RWKV_ARCH,
                               RWKV_LAYERS, ("argmax_onehot",),
                               RWKV_BYTES["per-leaf"])}
    by_path["logistic regression"] = phase_logreg(dev)
    phase_small(dev)
    by_path["serve stream"], serve_kernels = phase_serve(dev)
    # each kernel's count from one of MOE_ARCH's runs: a fused branch's
    # from the run that takes it (fused_path_run), a top-k kernel's from
    # the per-leaf run of its selection
    runs = {"fused_memsgd": fused_path_run("loop"),
            "fused_memsgd_threshold": fused_path_run("threshold")}
    for k in kernels:
        k["launches_from"] = runs.get(k["name"], "per-leaf")
        k["launches"] = by_arch[MOE_ARCH][k["launches_from"]][k["name"]]
    # the bf16 forms' counts: the pod sync's bf16 run (its re-select, rank
    # 0), its topk_scatter probe (rank 0) and the bf16 bucket memory's
    # step with each fused method
    bf16_runs = {
        "row_topk_loop_bf16": ("pod sync bf16 run, rank 0",
                               pod_launches["bf16 run"]["rank 0"]),
        "row_topk_threshold_bf16": (
            "pod sync bf16 probe, topk_scatter, rank 0",
            pod_launches["bf16 probe, topk_scatter"]["rank 0"]),
        "fused_memsgd_bf16": ("bf16 bucket memory, method auto",
                              bf16_memory["auto"]),
        "fused_memsgd_threshold_bf16": (
            "bf16 bucket memory, method threshold",
            bf16_memory["threshold"])}
    for name, e in bf16.items():
        fused = name.startswith("fused")
        source, replaces = (
            ("fused_memsgd.cu", "fused_memsgd.py:61") if fused else
            ("topk_select.cu", "topk_select.py:"
             + ("315" if "threshold" in name else "285")))
        run, counts = bf16_runs[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}", **e, "ok": True,
            "launches_from": run, "launches": counts[name]})
    kernels += serve_kernels
    if any(k["launches"] == 0 for k in kernels):
        fail(f"a kernel of the kernels line was never launched on its path: "
             f"{[(k['name'], k['launches_from']) for k in kernels]}")
    print(f"chip_smoke total wall time: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"launches_by_arch": by_arch}))
    print(json.dumps({"launches_by_path": by_path}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
