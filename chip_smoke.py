#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rdmnet_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each fatal on failure:
1. device: a CUDA card is required; prints its name and power limit;
2. build: both kernels from ``rdmnet_tpu_torch/csrc`` with ``nvcc``, in
   parallel, with the ``-Xptxas -v`` register/spill report (no spills);
3. kernels against their plain PyTorch versions at the main path's shapes:
   the 12 radius searches of one pair's graph build (plus the unbanded
   level-0 searches and a level-0 search over duplicated points, whose
   distance ties must come out in index order), and Sinkhorn at P=256,
   K1=129, 100 iterations with masked patches and rows; each kernel's device
   time (CUDA-graph replay) and time per wrapper call (CUDA events around
   eager calls) beside its bound, its launch plan and the time per call of
   the kernels' first design (v1); then each kernel's other paths against
   its plain version: the kNN's select paths at the k the plan sends each
   (the warp select path at k = 257 to 1024, the block select path at k =
   2048 to 6144), on dense windows where the lists fill (banded, unbanded,
   tiled, a batch of two clouds, duplicated points, k above the support
   count, two sort chunks, a window that overflows the block path's key
   cache, a window past the warp select path's box tile; tables exact,
   every launch on the plan's route); Sinkhorn's
   cluster path (208 < K1 <= 546) at P = 256, K1 = 209, 257, 304, 412, 513, 546 (each
   cluster size's first and last among them), its group path (K1 > 546)
   at (P, K1) = (32, 600), (256, 600), (256, 601), (32, 1025) and (32,
   2640), and past 2640, where each CTA reads the rows of its band that do
   not fit in its shared memory from device memory, at (8, 2641), (2, 3000)
   and (2, 4096), 100 iterations with masked rows and patches (within
   1e-4; 0 iterations give the scores), with
   cudaOccupancyMaxActiveClusters for each cluster size and the CTAs,
   groups, rounds and spilled rows of each group case; each instance with its
   device time, time per call, plain time, bound and plan;
4. the main path at ``make_cfg()`` full width, 0.7 bucket: a seeded ~20k
   point procedural pair through ``pipeline`` (graph build to pose), 3
   warm-up pairs, 12 timed pairs, 5 pairs with a per-stage breakdown; every
   kernel must have launched inside that window;
5. the same weights and inputs on the card and on the CPU at
   ``make_tiny_cfg()``, for 8 weight draws: every index table equal, log
   transport plans within 1e-3, LGR on the same plans with equal
   correspondence sets and per-patch hypothesis residuals within 1e-4 m,
   and poses within 1e-4 for the draws that register the pair;
6. the training path at ``make_cfg()`` full width, 0.7 bucket, on the
   phase-4 pair with its true pose: ``batch_to_device`` then
   ``make_train_step`` (forward with ground truth, the seven losses,
   backward, Adam), 2 warm-up and 8 timed steps with each part synchronised,
   the peak memory and every step's losses (finite, ``grad_norm`` > 0, the
   weights move); 12 kNN and 0 Sinkhorn launches per step (training runs the
   plain Sinkhorn under autograd); then one eval step (PIR, IR, RRE, RTE, RR)
   with 12 kNN launches and 1 Sinkhorn launch;
7. one tiny-config train step on the card and on the CPU with the same
   weights, for 3 weight draws, on a pair whose ground-truth target set fits
   ``num_targets`` (so both sample all of it): losses within 1e-4, gradients
   within 1e-2 of each tensor's norm plus 1e-6 of the global norm (2e-3
   globally), weights after the step within 1e-7 where the gradient stands
   clear of float noise and within one step (lr) elsewhere;
8. serving at ``make_cfg()`` full width: ``export_inference`` with buckets
   (0.5, 0.7, 1.0) into a temporary directory, ``load_exported`` on the card
   (the load must allocate one set of weights, ~101 MB, shared by the
   buckets, beside what each bucket's captured program keeps),
   ``make_handler`` on a ``ThreadingHTTPServer`` at 127.0.0.1 in a
   thread; seeded procedural pairs of ~13k, ~20k and ~28k points and one
   above the largest capacity (truncated) posted over HTTP: every response
   equal to a direct ``serve`` call (pose within 1e-6, the same number of
   correspondences) and to ``pipeline`` on the model at that bucket's
   config, each request a replay of its bucket's program (12 kNN and 1
   Sinkhorn launches in it, counted at its capture; no wrapper ticked by the
   replay), ``/healthz`` counting
   every request per bucket, a malformed body answered 400 with the server
   still up; for each of these requests, both kernels against their plain
   versions at that bucket's shapes: the 12 searches of the request's graph
   build at the bucket's caps, bands and launch plans (tables equal), and
   Sinkhorn on the request's own inputs, taken from its eager twin (against a float64 run of the
   plain version: within 1e-4 + 1e-4 of each entry's magnitude, or no
   further than twice the float32 plain version); per bucket, after
   warm-up, the ms per request over HTTP, per direct call, per direct call
   on a new thread and per ``pipeline`` call on the padded pair already on
   the card, timed in turns, with their spread; the ms per request of the
   HTTP layer alone (a server answering with stored outputs); the peak
   memory; and the kernel time of one profiled request;
9. RANSAC on the card: 2048 correspondences under a known pose with noise
   and 60% outliers, the same uniforms on the card and on the CPU
   (transforms within 1e-5, the pose within 1e-3 of the known one), and the
   ms of ``ransac_registration_host`` for 50,000 iterations (a replay of its
   program; the untimed first call captures it);
10. the train -> snapshot -> test -> eval workflow at ``make_cfg()`` full
   width, 0.7 bucket, on a KITTI-layout root of procedural scans written
   into a temporary directory (train sequence 00 of 5 frames, val 06 and
   test 08 of 3, ~20k points per scan): ``cli.trainval.main`` for 2 epochs
   (8 steps, 4 validation pairs), then again with ``--resume`` for a third
   (the resumed state equal to the saved one bit for bit, 3 train and 3 val
   records, every loss finite, the best snapshot the best val record);
   ``cli.test.main`` on the best snapshot with buckets 0.7/1.0 (each dump
   equal to ``make_forward`` + ``trim_outputs`` at its bucket; with two pairs
   both are a bucket program's eager warm-ups); ``cli.eval.main``
   with lgr, svd and ransac on the card (the JAX CLI's JSON keys, 2 pairs,
   finite numbers); 12 kNN and 0 Sinkhorn launches per train step, 12 and 1
   per validation and test pair; ``cli.test.main --vis`` (each pair's PLY
   exports and ``viewer.html``) and ``cli.eval.main --figures --baselines
   kitti`` (the JAX CLI's three PNGs, readable; where matplotlib is not
   installed the flag must refuse at once, and the figures' ATE and recall
   numbers are computed without drawing). Prints the Trainer's windowed steps/s beside
   phase 6's isolated step, the loader-wait share of each epoch, validation
   ms per pair, snapshot save/restore ms and size, test ms per pair (prep,
   proc, the ``.npz`` write alone, wall) and eval ms per pair per method;
11. the model surface at ``make_cfg()`` width, 0.7 bucket, on the phase-4
   pair: ``make_parity_cfg()`` with a random kernel disposition per KPConv
   layer, its 12 searches (9 at K 63-81, 3 at K = 1) against the plain
   version with device and per-call ms beside the bound, ``pipeline`` ms per
   pair, per-stage ms and peak memory with 12 kNN and 1 Sinkhorn launches per
   pair; level-0 searches at K = 81 and K = 256 (the 128- and 256-entry
   lists) against the plain version; an upstream-schema ``.pth.tar`` of the
   parity model converted on load (``--torch_checkpoint``'s path) against the
   same weights carried by ``params_from_jax`` (poses within 1e-6); then for
   GeoTransformer, APE, ThDRoFormer with ``k2=(0.5,) * 4`` and the model
   without the vote layer: ``pipeline`` ms per pair and peak memory (12/1
   launches per pair), 3 train steps (finite losses and gradient, 12/0
   launches per step, peak memory), and card against CPU at
   ``make_tiny_cfg()`` for 2 weight draws (tables and node masks equal, the
   same matched node pairs, plans within 1e-3);
12. ``compute_dtype="bfloat16"`` beside float32 at ``make_cfg()`` width, 0.7
   bucket, on the phase-4 pair with one set of weights: ``pipeline`` in
   turns (3 warm-up and 12 timed pairs each; ms/pair, per-stage ms, peak
   memory; 12 kNN and 1 Sinkhorn launches per bf16 pair; the coarse features'
   median cosine to float32 > 0.98); 1 + 3 train steps each in turns (finite
   losses, ``grad_norm`` > 0, float32 weights, parts, peak memory; 12/0
   launches per step); card against CPU at ``make_tiny_cfg()`` for 2 weight
   draws (tables equal; the card's bf16 features no further from the CPU's
   bf16 than twice the CPU's bf16 from its float32);
13. data preparation through ``cli.preprocess.main``: a raw KITTI-layout
   sequence (7 procedural scans of ~100k points 4 m apart, a non-identity
   ``Tr``) written into a temporary directory; ``downsample``; ``pairs`` on
   the card (ICP on the radius-kNN kernel) and with ``--device cpu`` (the
   same pairs, ground truth within 1e-4, one kNN launch per ICP iteration);
   the first ICP iteration's search against the plain version (equal on
   every query, timed beside its bound) and against the native library (the
   differing rows counted); ``calibrate`` on the card and on the CPU (equal
   limits and band caps, equal neighbour counts per level), with the ms per
   ICP pair and the seconds per ``calibrate`` on each;
14. data parallelism, world 2 through a ``file://`` store: NCCL with a card
   per rank where there are two, else gloo with both ranks on card 0 (asked
   for explicitly: placement and collectives, not a scaling figure). (a) the
   dp train step at ``make_cfg()`` width, 0.7 bucket, one pair a rank (the
   phase-4 pair and its src moved by a seeded rigid motion), rank 1's
   different weights replaced by rank 0's broadcast, each rank's target
   generator at the state the one-process two-pair step had at its pair:
   gradients and losses within max(2 x the distance between two one-process
   runs, 1e-6 of the global norm / the loss), gradients and weights after the
   step bit-equal across ranks, 12 kNN and 0 Sinkhorn launches per rank per
   step, an eval step's Sinkhorn against the plain version, ms/step (1
   warm-up, 3 timed) beside the one process's and peak memory per rank;
   (b) the phase-4 pair's build with its searches of 2048 query rows or more
   sharded: every table equal to the unsharded build, each shard's table
   equal to the plain version, launches per rank, build ms beside the whole
   build in turns; (d) the dp programs at ``make_cfg()``, 0.7 bucket, on
   each rank: the dp train program (``capture_train_step(..., group)``: two
   eager warm-ups, both halves captured into one pool, replays with the
   exchange between them) against an eager dp twin from the same weights,
   generators and batches over 7 steps, rank 1's ground truth NaN at step 4:
   metrics, weights, Adam's moments and steps, the lr, the counters and the
   generators bit-equal after every step, the NaN step skipped on both
   ranks, the ranks' states bit-equal; the same at ``grad_acc_steps`` 2 over
   three groups (the second NaN); the eval program under the group on
   two-pair batches against the eager eval step, bit-equal; the launches at
   each capture (12/0 kNN/Sinkhorn a train pair, all in the gradient half;
   12/1 an eval pair) and in profiled replays (the whole step, each half
   apart, the eval program); replayed against eager dp steps in turns
   (ms/step a rank with spread, peak memory), the busy share of a profiled
   replay, capture s, memory kept and reserved per rank; (e) on NCCL, 10
   graphs a rank recorded in the programs' "global" capture mode while the
   NCCL watchdog still holds an all-reduce, each captured and replayed
   right; (c)
   ``cli.trainval.main --dp 2`` on phase 10's root for an epoch and a run
   resumed to epoch 4, on the programs and with the Trainer kept eager:
   every ``metrics.jsonl`` record, every logged step and the weights after
   each run equal, the weights bit-equal across ranks, the launches of the
   resumed run's programs (12/0 a train step, 12/1 a validation pair), the
   validation means within 1e-5 of one process validating the snapshot,
   windowed steps/s of both.
15. the library surface no model path calls: (a) ``run_fast_contracts()``
   on the card, three ``pass`` and one launch of each kernel, each kernel's
   device time at the contract shapes; (b) the correspondence toolkit, the
   geometry, partition and KPConv helpers, ``log_sinkhorn``,
   ``point_matching`` and ``ConvBlock`` (Linear + GroupNorm, Conv2d 3x2
   stride 2 "SAME" + BatchNorm in train then eval, Conv1d + InstanceNorm) on
   the card and the CPU on the same seeded inputs: masks and indices equal,
   floats within 1e-5 of max |y|; (c) ``group_and_aggregate`` at level-1
   shapes of the phase-4 pair: one kNN launch per call, equal to the plain
   version, and at k = 257 one select-path launch, equal too; (d) the phase-4 pair's pyramid
   and its ref against a moved copy repacked into the reference's stacked
   layout, split by ``pair_batch_from_stacked`` (rows and tables equal to
   the batch's) and run through the model: one Sinkhorn launch, fine
   features within 1e-4 of max |y|, the pose difference from the batch's
   printed, and held to ``SPLIT_POSE_LIMIT`` for the moved copy when both
   poses register;
16. the model at shapes past the kernels' first paths: ``make_cfg()`` at the
   0.7 bucket with neighbour limits (320, 40, 40, 40, 40) and 256 points a
   patch, on the phase-4 pair: ``pipeline`` builds and runs on the card (2
   warm-up, 6 timed pairs, 2 with a per-stage breakdown; ms/pair, peak
   memory), both second paths launch inside the window (2 select-path kNN
   and 1 cluster-path Sinkhorn launch a pair), its 12 searches equal the plain
   version's (the two warp-select searches' device ms summed beside their
   bound), the graph build at level-0 limit 2048 launches the block path
   twice (tables equal), and against the CPU port on the same weights
   (``overfit_demo.hold_card_to_cpu``): tables and node masks equal, the
   matched node pairs equal but for near-ties at the top-256 boundary
   (within 1e-4 of the lowest matched score), plans through the common
   pairs (at least one) within 1e-3, LGR on the CPU's plans with equal
   correspondence sets, scores within 1e-6 and residuals within 1e-4 m, the
   card's model replayed on the CPU's node pairs with plans within 1e-3, and
   the LGR and replay poses within 1e-4 when the CPU's registers the pair
   (the whole-path pose too where no node pair parted); then the same
   model with 600 points a patch (K1 = 601, neighbour limits as phase 4): 2
   warm-up and 4 timed pairs launch the 12 list-path searches and one
   group-path Sinkhorn each, one more pair's Sinkhorn is held against the
   plain version on its own inputs (as phase 8 does), with ms/pair,
   per-stage ms (OT among them) and peak memory; no CPU pipeline there.
17. the learning loop: (a) ``tools/overfit_demo.run`` at ``make_cfg()``
   width, 0.7 bucket, lr 5e-4, on the phase-4 ref against its copy moved by
   the demo's known pose (104 degrees, 0.02 m noise), 150 steps from seeded
   weights with the batch built once, evaluated at steps 1, 50, 100 and 150
   and after the last (PIR, IR, RR, RRE, RTE): every metric finite, the mean
   loss of steps 141-150 below that of steps 1-10, 12 kNN launches for the
   build, none in a train step, one Sinkhorn launch and no kNN per eval step;
   (b) the vote-rescue recipe (the seed-31337 290-degree field-of-view pair,
   tiny config, 75 steps) from the port's seeded weights for target-draw
   seeds 1-4, held to the range of the same recipe's 48 draws on the CPU:
   summed over the four, at least 7 true node pairs (of 32 a draw) with the
   vote on, at most 9 with it off and no fewer on than off; a draw at most 6
   off;
18. the compiled serving program: (a) one eager ``pipeline`` call at
   ``make_cfg()``, 0.7 bucket, on the phase-4 pair under
   ``torch.cuda.set_sync_debug_mode("error")`` between the upload and the
   fetch: no host sync; (b) the port's own kernels against their plain
   versions at the main path's shapes: ``segment_sums`` bit-equal at every
   level of the phase-4 pair and on a cloud with over 2000 points in one
   voxel, ``nms_peel`` keep masks and rounds equal on the phase-4 nodes and
   on a 512-node chain 0.9 r apart (256 rounds), and at M = 1600 (random
   nodes and a chain), where the rows leave shared memory for device
   memory, ``eigh4``'s rotation within
   1e-5 of ``torch.linalg.eigh``'s on the phase-4 LGR fits and 10^5 seeded
   random fits whose relative eigen-gap is at least 0.1 (closer fits within
   max(1e-5, 32 u / gap), the worst printed beside its gap), each with its
   device ms, plain ms, bound and library ms (``index_add_``;
   ``torch.linalg.eigh``); (c) ``load_exported`` of a ``make_cfg()`` artifact
   with buckets 0.5/0.7/1.0 captures every bucket (time to capture, memory
   kept; in each program 12 kNN, 1 Sinkhorn, 4 segment-sum, 1 NMS and 7
   eigh4 launches, counted at the capture); (d) requests of ~13k, ~20k,
   ~28k, ~20k and ~13k points and one above the capacity, each replay held
   against the eager ``pipeline`` on its bucket's model: tables, dropped
   counts, NMS keep masks and rounds and matched node pairs equal, the pose
   and scores within 1e-5, bit-equality printed; (e) 8 HTTP clients sending
   4 requests each at once, every answer equal to its eager twin; (f) per
   bucket, replayed and eager requests timed in turns (direct, over HTTP, on
   a new thread) with spread, one profiled request of each (the card's busy
   share; the replay's kernels must be the program's 12/1/4/1/7) and the
   peak memory of each; (g) phase 16's cluster-path (K1 257)
   and group-path (K1 601) models, the parity config and phase 11's other
   families (GeoTransformer, APE, ``k2``, vote off) captured (each capture's
   warm-up under the sync check), two replays of each held to eager the
   same way.

19. the Trainer's compiled programs (``capture_train_step``,
   ``capture_eval_step``), in a process of its own (``--train-program-only``;
   a profiled replay of the train program has crashed in ``cudaGraphLaunch``
   after phase 18 in one process), at ``make_cfg()``, 0.7 bucket, on the phase-4 pair
   and copies of it with src moved by seeded rigid motions: (a) one eager
   train step and one eval step, each with its graph build, under
   ``set_sync_debug_mode("error")`` between the upload and the fetch: no
   host sync; (b) the train program (2 eager warm-ups, the capture, replays)
   against an eager twin from the same weights, generator and batches over 7
   steps, one with a NaN in its ground truth: metrics, weights, Adam's
   moments and steps, the lr, the counters and the generators bit-equal
   after every step, the NaN step skipped; (c) the same at
   ``grad_acc_steps`` 2 over three groups (the second non-finite); (d) the
   eval program on batches of two pairs against the eager step, ``valid``
   weighting included: metrics and transforms bit-equal; (f) each program's
   launches counted at its capture (12/0 kNN/Sinkhorn a train pair,
   12/1/4/1/7 an eval pair) and a profiled replay launching exactly them;
   (g) replayed against eager train steps in turns (ms/step, spread, peak
   memory) and eval steps (ms a pair), a replayed and an eager train step
   profiled (busy share), the kernel ms of the eager step by part with its
   top operators, the replay's top kernels, capture s, memory kept and
   reserved; (e) ``cli.trainval.main`` on phase 10's root
   for 2 epochs on the programs and with the Trainer kept eager: every
   ``metrics.jsonl`` record and every logged step's values equal, windowed
   steps/s of both; (h) ``compute_dtype="bfloat16"`` and phase 11's families
   (GeoTransformer, APE, ``k2``, vote off): two warm-ups, the capture and a
   replay each, bit-equal to eager; (i) ``IterBasedTrainer`` on phase 10's
   root for 6 iterations (validation every 2, a snapshot every 3), then the
   same object resumed from its snapshot 6 to 9, on the programs and kept
   eager: every step's metrics, logged line, validation record and the
   final weights bit-equal, the train program captured anew after the
   restore.

20. the offline CLIs' compiled programs, in a process of its own
   (``--cli-program-only``), at ``make_cfg()``: (a) one eager forward with
   ground truth (build, model, Evaluator) on the phase-4 pair at 0.7 and one
   eager ``ransac_registration`` on phase 9's correspondences at 50,000
   iterations under ``set_sync_debug_mode("error")`` between the upload and
   the fetch: no host sync; (b) ``cli.test.main`` with ``--vis`` at buckets
   0.7/1.0 on a KITTI-layout root whose test split holds 5 pairs a bucket
   (sequence 08 of ~16-19k-point scans, 09 of ~26-28k), each bucket a
   program (two eager warm-ups, the capture, 3 replays), against the same
   run on the eager forward: every ``.npz``, every vis file and every
   logged metric line equal bit for bit; (c) ``cli.infer.main`` on three of
   those scans, on the programs (``capture_pipeline``, RANSAC) and eager:
   the pose file and every ``.npz`` equal; (d) RANSAC programs at
   capacities 512/1024/2048 and 5,000/50,000 iterations, seeds 0-4 in a
   row at thresholds 0.3 and 0.015 on each program, every transform equal
   to an eager call's bit for bit, the draws shown to follow the seed,
   phase 9's pose within 1e-3; ``cli.eval.main --method ransac`` and
   ``ransac_featurematch`` on (b)'s dumps, the JSON equal to an eager run's;
   (e) bfloat16: ``load_exported`` of a bf16 artifact at 0.7 (two replayed
   requests) and the bf16 test program (two replays), bit-equal to eager
   bf16; (f) the launches counted at each capture (12/1/4/1/7 a test pair,
   ``eigh4`` chunks + 2 a RANSAC call) and a profiled replay of the test,
   infer and RANSAC programs launching exactly them; (g) in turns, with
   spread: the test loop's wall and proc ms a pair on the programs and
   eager, the ``.npz`` write alone, a test pair, an infer pair (forward and
   trim), a RANSAC call at 50,000 iterations, the bf16 replays beside
   float32's (test pair, served request), each with its peak allocated
   memory; the busy share of each profiled replay; capture s, memory kept
   and reserved.

``python3 chip_smoke.py --dp-only`` runs phases 1, 2 and 14 alone (with two
cards or more, the NCCL path); ``python3 chip_smoke.py --program-only``
phases 1, 2 and 18; ``python3 chip_smoke.py --train-program-only`` phases 1,
2 and 19; ``python3 chip_smoke.py --cli-program-only`` phases 1, 2 and 20.

Phase 2 fails if ``-Xptxas -v`` reports a spilled register in any kernel.
Prints a ``kernels`` JSON line, the card line, and as the last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

SEED = 7351
WEIGHT_SEEDS = (1, 2, 3, 4, 5, 6, 7, 8)  # weight draws of the card-vs-CPU phase (phase 5)
TRAIN_SEEDS = (1, 2, 3)                  # weight draws of the training card-vs-CPU phase (7)
TRAIN_WARM, TRAIN_TIMED = 2, 8           # train steps of phase 6
SERVE_SCALES = (0.5, 0.7, 1.0)           # capacity buckets of phase 8
SERVE_SIZES = (13000, 20000, 28000)      # points per cloud of phase 8's pairs, one per bucket
SERVE_WARM, SERVE_TIMED = 3, 15          # requests per bucket of phase 8
HTTP_LAYER_TIMED = 40                    # requests per bucket to phase 8's HTTP-layer server
RANSAC_ITERATIONS = 50000                # phase 9
# phase 10: (scene seed, frames) per sequence of the KITTI-layout root
WORKFLOW_SEQUENCES = {0: (SEED + 10, 5), 6: (SEED + 11, 3), 8: (SEED + 12, 3)}
WORKFLOW_SCAN = dict(n_rings=80, n_azimuths=3000, step=10.0)
# the JAX CLI's --json_out keys (rdmnet_tpu/cli/eval.py)
EVAL_JSON_KEYS = {"method", "n_pairs", "RR", "RRE_deg", "RTE_m", "PIR", "IR", "overlap",
                  "failed_pairs", "per_pair"}
# phase 16: the checks of hold_card_to_cpu held only where they can be (the CPU's pose registers)
POSES = ("LGR pose", "replay pose", "whole-path pose")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
SFU_PER_SM_CLK = 16           # exp2 throughput per SM per clock (compute capability 9.0)
NUM_SMS = 132
KNN_OPS_PER_PAIR = 9          # 3 FMA (2 each), sub, add, max per (query, candidate)
SINKHORN_OPS_PER_ENTRY = 4    # add, max, sub, add per entry and half-step (beside one exp)
DESIGN = "v2"                 # the kernels' design in csrc/, as PERF.md names it
# ms per wrapper call of the kernels' first design, v1 (one thread per query with
# a local-memory top-K; warp-per-row Sinkhorn in shared memory), on an NVIDIA H100
# 80GB HBM3 at 700.00 W: the mean of two runs of the v1 tree's chip_smoke.py in
# one call (PERF.md, section 6, the v2 redesign). Keys are (table, query level,
# support level, k).
V1_KNN_MS = {
    ("neighbors", 0, 0, 40): 1.2344, ("subsampling", 1, 0, 40): 1.7591,
    ("neighbors", 1, 1, 40): 1.0634, ("subsampling", 2, 1, 40): 1.7496,
    ("upsampling", 1, 2, 1): 0.0551, ("neighbors", 2, 2, 40): 0.9172,
    ("subsampling", 3, 2, 40): 1.5240, ("upsampling", 2, 3, 1): 0.0397,
    ("neighbors", 3, 3, 40): 0.8292, ("subsampling", 4, 3, 40): 1.2368,
    ("upsampling", 3, 4, 1): 0.0383, ("neighbors", 4, 4, 40): 0.5811,
    ("unbanded", 0, 0, 40): 2.5537, ("unbanded", 0, 0, 1): 0.6676,
}
V1_SINKHORN_MS = 2.5560


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def smi(query: str) -> str:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "unknown"


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call over ``reps`` calls, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call: ``reps`` calls captured in one CUDA
    graph and replayed, so the host's per-call work is not in the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def knn_diagnosis(q, s, got, want, rows: int = 3):
    """Lines describing the first ``rows`` rows where the kernel's table
    differs from the plain version's: each side's neighbours with their
    float64 squared distances (printed when the check fails)."""
    import torch

    ns = s.shape[1]
    lines = []
    for b, r in (got != want).any(dim=-1).nonzero().tolist()[:rows]:
        qd = q[b, r].double()
        for side, idx in (("kernel", got[b, r]), ("plain", want[b, r])):
            valid = idx[idx < ns].long()
            d = ((s[b, valid].double() - qd) ** 2).sum(-1)
            lines.append(f"  cloud {b} query {r} {side}: "
                         + ", ".join(f"{i}:{x:.6f}" for i, x in zip(valid.tolist(), d.tolist())))
    return lines


def check_knn(pts, cnts, sp, kernels):
    """Kernel vs plain for one search ``sp`` (a ``SearchSpec``) of the graph
    build on the card."""
    import torch

    from rdmnet_tpu_torch.ops.kernels.radius_knn import knn_plan, radius_knn_cuda, radius_knn_plain
    from rdmnet_tpu_torch.ops.radius_search import band_windows
    from rdmnet_tpu_torch.tools.kernel_probe import knn_bound

    q, s, scnt = pts[sp.q_lvl], pts[sp.s_lvl], cnts[sp.s_lvl]
    plan = knn_plan(q.shape[0], q.shape[1], s.shape[1], sp.k, sp.band)
    kw = {}
    if sp.band is not None:
        win, _ = band_windows(q, s, cnts[sp.q_lvl], sp.radius, sp.cell, sp.band, sp.chunk)
        kw.update(win=win, chunk=sp.chunk, band=sp.band)
    got = radius_knn_cuda(q, s, scnt, sp.radius, sp.k, **kw)
    torch.cuda.synchronize()
    want = radius_knn_plain(q, s, scnt, sp.radius, sp.k, **kw)
    # exact: the kernel's FMA chain and (distance, index) order are the plain
    # version's, so even ties must come out the same
    differ = (got != want).any(dim=-1)
    if bool(differ.any()):
        print("\n".join(knn_diagnosis(q, s, got, want)), file=sys.stderr)
        fail(f"radius_knn {sp.table}[{sp.q_lvl}->{sp.s_lvl}] k={sp.k}: {int(differ.sum())} "
             "rows differ from the plain version")
    err = float((got.long() - want.long()).abs().max())
    call = lambda: radius_knn_cuda(q, s, scnt, sp.radius, sp.k, **kw)  # noqa: E731
    ms, call_ms = graph_ms(call, reps=10), cuda_ms(call, reps=10)
    plain_ms = cuda_ms(lambda: radius_knn_plain(q, s, scnt, sp.radius, sp.k, **kw), reps=1,
                       warmup=0)
    # work this run's data needs: the valid queries against the valid rows of
    # the 32-row chunks of their window that their radius reaches
    bound, by, window, reached = knn_bound(q, s, scnt, cnts[sp.q_lvl], sp.radius, sp.k, **kw)
    kernels["radius_knn"]["max_abs_err"] = max(kernels["radius_knn"]["max_abs_err"], err)
    return ms, call_ms, plain_ms, bound, dict(by=by, window=window, reached=reached), plan


def work_text(work) -> str:
    return (f"candidate pairs {work['window']}, {work['reached']} of them in chunks the radius "
            f"reaches (bound by {work['by']})")


def knn_line(name: str, ms, call_ms, pms, bound, plan, v1) -> str:
    p = (f"plan route={plan.route} warps={plan.warps} k_bucket={plan.k_bucket} "
         f"tile_rows={plan.tile_rows} tiled={plan.tiled} smem={plan.smem_bytes}")
    if plan.route != "list":
        p += f" sort_rows={plan.sort_rows} cache_keys={plan.cache_keys} box_rows={plan.box_rows}"
    old = "not recorded" if v1 is None else f"{v1:.4f} ms per call"
    return (f"radius_knn {name}: kernel {ms:.4f} ms on the device, {call_ms:.4f} ms per call, "
            f"v1 design {old}; plain {pms:.3f} ms, bound {bound:.5f} ms; {p}")


def pair_levels(batch, num_stages):
    """Per-level points (2, N, 3) and counts (2,) of a pair batch, ref and src
    stacked as the kNN wrapper takes them."""
    import torch

    pts = [torch.stack([batch.ref.points[i], batch.src.points[i]]).contiguous()
           for i in range(num_stages)]
    cnts = [torch.stack([batch.ref.counts[i], batch.src.counts[i]]).to(torch.int32)
            for i in range(num_stages)]
    return pts, cnts


def check_searches(pts, cnts, pyramid, kernels, prefix="", v1=None):
    """``check_knn`` over the 12 searches of ``pyramid``'s graph build, one
    line each. Returns the summed (device ms, ms per call, plain ms, bound ms)
    and what bounds the larger share of the summed bound."""
    from rdmnet_tpu_torch.graph.pyramid import search_plan

    total, by = [0.0, 0.0, 0.0, 0.0], {"bytes": 0.0, "operations": 0.0}
    for item in search_plan(pyramid):
        ms, call_ms, pms, bound, work, plan = check_knn(pts, cnts, item, kernels)
        total = [a + b for a, b in zip(total, (ms, call_ms, pms, bound))]
        by[work["by"]] += bound
        name = (f"{prefix}{item.table}[{item.q_lvl}->{item.s_lvl}] Q={pts[item.q_lvl].shape[1]} "
                f"S={pts[item.s_lvl].shape[1]} K={item.k} band={item.band}")
        print(knn_line(name, ms, call_ms, pms, bound, plan,
                       (v1 or {}).get((item.table, item.q_lvl, item.s_lvl, item.k)))
              + f"; {work_text(work)}")
    return (*total, max(by, key=by.get))


def train_phase(cfg, host, dev):
    """Phase 6: ``TRAIN_WARM`` + ``TRAIN_TIMED`` train steps on ``host`` (a
    one-pair host batch), each part synchronised, then one eval step. Returns
    the printed summary's numbers and the launch counts."""
    import numpy as np
    import torch

    from rdmnet_tpu_torch.engine import (TRAIN_STAGES, batch_to_device, create_train_state,
                                         make_eval_step, make_train_step)
    from rdmnet_tpu_torch.models import RDMNet
    from rdmnet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    state = create_train_state(cfg, RDMNet(cfg, device=dev,
                                           generator=torch.Generator().manual_seed(SEED)))
    step = make_train_step(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    start = [p.detach().clone() for p in state.params]
    parts = {name: 0.0 for name in TRAIN_STAGES}
    train_counts = {name: 0 for name in launch_counts()}
    step_ms = []
    for i in range(TRAIN_WARM + TRAIN_TIMED):
        if i == TRAIN_WARM:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        marks = []

        def hook(name):
            torch.cuda.synchronize(dev)
            marks.append((name, time.perf_counter()))

        reset_launch_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        batch = batch_to_device(host, cfg.pyramid, device=dev)
        hook("build")
        state, metrics = step(state, batch, gen, stage_hook=hook)
        counts = launch_counts()
        metrics = {k: float(v) for k, v in metrics.items()}
        if counts != {"radius_knn": 12, "sinkhorn": 0}:
            fail(f"train step {i}: launches {counts}, expected 12 kNN and 0 Sinkhorn")
        if not all(np.isfinite(v) for v in metrics.values()) or metrics["grad_norm"] <= 0:
            fail(f"train step {i}: non-finite losses or zero gradient: {metrics}")
        for name in counts:
            train_counts[name] += counts[name]
        kind = "warm-up" if i < TRAIN_WARM else "timed"
        print(f"train step {i} ({kind}): {(marks[-1][1] - t0) * 1e3:.3f} ms, "
              + ", ".join(f"{k} {v:.6g}" for k, v in metrics.items()))
        if i >= TRAIN_WARM:
            step_ms.append((marks[-1][1] - t0) * 1e3)
            prev = t0
            for name, t in marks:
                parts[name] += (t - prev) * 1e3 / TRAIN_TIMED
                prev = t
    peak = torch.cuda.max_memory_allocated(dev)
    moved = max(float((p.detach() - q).abs().max()) for p, q in zip(state.params, start))
    if state.count != TRAIN_WARM + TRAIN_TIMED or moved <= 0:
        fail(f"training: {state.count} updates applied, weights moved by {moved}")

    # one more step under the profiler: device time by operation and the
    # device's busy share of the step's wall time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch_to_device(host, cfg.pyramid, device=dev), gen)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels are the events on the device; operators (host events) carry
    # the device time of the kernels they launched, so they are listed, not summed
    events = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)) / 1e3
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0), key=lambda e: -e.self_device_time_total)
    print(f"profiled train step: {wall_ms:.3f} ms wall, {device_ms:.3f} ms of kernel time on "
          f"the device ({100 * device_ms / wall_ms:.1f}% busy under the profiler); top "
          "operators by the device time of their kernels:")
    for e in ops[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d} calls  {e.key[:90]}")

    reset_launch_counts()
    batch = batch_to_device(host, cfg.pyramid, device=dev)
    ev, tfs = make_eval_step(cfg, device=dev)(state, batch)
    eval_counts = launch_counts()
    ev = {k: float(v) for k, v in ev.items()}
    if eval_counts != {"radius_knn": 12, "sinkhorn": 1}:
        fail(f"eval step: launches {eval_counts}, expected 12 kNN and 1 Sinkhorn")
    if not all(np.isfinite(v) for v in ev.values()) or tfs.shape != (1, 4, 4):
        fail(f"eval step: non-finite metrics {ev} or transforms of shape {tuple(tfs.shape)}")
    return dict(step_ms=step_ms, parts=parts, peak=peak, moved=moved, eval=ev,
                train_counts=train_counts, eval_counts=eval_counts, busy=device_ms / wall_ms)


def train_card_vs_cpu(cfg, host, dev):
    """Phase 7: one train step per weight draw of ``TRAIN_SEEDS`` on ``dev``
    and on the CPU, held to the tolerances of the module docstring."""
    import torch

    from rdmnet_tpu_torch.engine import batch_to_device, create_train_state, make_value_and_grad
    from rdmnet_tpu_torch.models import RDMNet

    lr = cfg.optim.lr
    for seed in TRAIN_SEEDS:
        runs = []
        for d in (dev, torch.device("cpu")):
            state = create_train_state(cfg, RDMNet(cfg, device=d,
                                                   generator=torch.Generator().manual_seed(seed)))
            batch = batch_to_device(host, cfg.pyramid, device=d)
            with torch.no_grad():
                overlaps = state.model(batch[0], training=False, with_gt=True)["gt_node_corr_overlaps"]
            eligible = int((overlaps > cfg.coarse_matching.overlap_threshold).sum())
            if not 0 < eligible <= cfg.coarse_matching.num_targets:
                fail(f"train card vs CPU (weights {seed}): {eligible} eligible targets, the "
                     f"check needs 1..{cfg.coarse_matching.num_targets}")
            metrics, grads = make_value_and_grad(cfg, device=d)(
                state, batch, torch.Generator(device=d).manual_seed(0))
            before = [p.detach().cpu().clone() for p in state.params]
            if not state.apply_gradients(grads):
                fail(f"train card vs CPU (weights {seed}): the update was skipped on {d}")
            runs.append(({k: float(v) for k, v in metrics.items()}, [g.cpu() for g in grads],
                         before, [p.detach().cpu().clone() for p in state.params], eligible))
        (m_g, g_g, p0_g, p1_g, e_g), (m_c, g_c, p0_c, p1_c, e_c) = runs
        loss_err = max(abs(m_g[k] - m_c[k]) for k in m_c if k != "grad_norm")
        total = float(torch.sqrt(sum((g * g).sum() for g in g_c)))
        glob = float(torch.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(g_g, g_c)))) / total
        gmax = max(float(g.abs().max()) for g in g_c)
        names = [n for n, p in state.model.named_parameters() if p.requires_grad]
        worst, worst_name, p_err, step_max = 0.0, "", 0.0, 0.0
        for name, a, b, q0g, q0c, q1g, q1c in zip(names, g_g, g_c, p0_g, p0_c, p1_g, p1_c):
            if not torch.equal(q0g, q0c):
                fail(f"train card vs CPU (weights {seed}): the initial weights differ")
            ratio = float(torch.linalg.norm(a - b)) / (1e-2 * float(torch.linalg.norm(b))
                                                       + 1e-6 * total)
            if ratio > worst:
                worst, worst_name = ratio, name
            sig = b.abs() > 1e-3 * gmax
            if bool(sig.any()):
                p_err = max(p_err, float((q1g - q1c)[sig].abs().max()))
            step_max = max(step_max, float((q1g - q0g).abs().max()))
        print(f"train card vs CPU (tiny cfg, weights {seed}): eligible targets {e_g}/{e_c} of "
              f"{cfg.coarse_matching.num_targets}; losses max abs diff {loss_err:.3e}; gradients "
              f"{glob:.3e} of the global norm, worst tensor {worst_name} at {worst:.3f} of its "
              f"bound; weights after the step {p_err:.3e} where the gradient is clear of noise, "
              f"largest step {step_max:.3e} (lr {lr})")
        if e_g != e_c or loss_err > 1e-4 or glob > 2e-3 or worst > 1.0 or p_err > 1e-7 \
                or step_max > lr * (1 + 1e-3):
            fail(f"train card vs CPU (weights {seed}): outside the tolerances")


def post(url, body):
    """(status, body bytes) of one POST."""
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def get_json(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def spread(ms):
    ms = sorted(ms)
    return (f"mean {sum(ms) / len(ms):.3f}, median {ms[len(ms) // 2]:.3f}, min {ms[0]:.3f}, "
            f"max {ms[-1]:.3f}")


def serve_checked(view, padded, dev, kernels):
    """The eager ``pipeline`` on a served request's padded pair at its bucket
    (``view``), the model the served program was captured from, with its
    Sinkhorn inputs kept and run again through the plain version, in float32
    and in float64 (a replayed program runs no Python, so the request's own
    inputs are taken from its eager twin). On the entries that are not
    masked, the kernel's log plan must lie within the card tests' tolerance,
    1e-4 + 1e-4 * |x|, of the float64 run, or no further from it than twice
    the float32 plain version does: a model's scores reach magnitudes of a
    few hundred, where 100 iterations of float32 rounding alone can leave the
    tolerance. Returns the pipeline's outputs."""
    from rdmnet_tpu_torch.models import pipeline

    ot = view.optimal_transport  # shared by every bucket's view
    seen = []
    handle = ot.register_forward_hook(
        lambda mod, args, kwargs, out: seen.append((args, kwargs, out)), with_kwargs=True)
    try:
        live = pipeline(view, *padded, device=dev)
    finally:
        handle.remove()
    (args, kwargs, got), = seen
    err = sinkhorn_against_plain(ot, args, kwargs, got, "serving", "a served request's")
    kernels["sinkhorn"]["max_abs_err"] = max(kernels["sinkhorn"]["max_abs_err"], err)
    return live


def sinkhorn_against_plain(ot, args, kwargs, got, where, whose) -> float:
    """One call of the optimal-transport module ``ot`` (its ``args``,
    ``kwargs`` and output ``got``, the kernel's) held against the plain
    version in float32 and float64 as ``serve_checked`` says. Prints a line
    and returns the max abs error against the float32 plain version."""
    import torch

    if not kwargs.get("use_kernel", True):
        fail(f"{where}: the call did not take the Sinkhorn kernel")
    with torch.no_grad():
        want = ot(*args, use_kernel=False)
        exact = ot(args[0].double(), *args[1:], use_kernel=False)
    live = want > -1e11
    if not torch.isfinite(got).all() or not torch.equal(got > -1e11, live):
        fail(f"{where}: Sinkhorn kernel output non-finite or masked entries differ")
    ref = exact[live]
    tol = 1e-4 + 1e-4 * ref.abs()
    worst_k = float(((got[live] - ref).abs() / tol).max())
    worst_p = float(((want[live] - ref).abs() / tol).max())
    err = float((got - want)[live].abs().max())
    print(f"{where}: sinkhorn on {whose} own inputs {tuple(args[0].shape)}: max abs err "
          f"{err:.3e} against the plain version; against the float64 run (entries up to "
          f"{float(ref.abs().max()):.3f} in magnitude) the kernel's worst entry is at "
          f"{worst_k:.3f} of the tolerance, the float32 plain version's at {worst_p:.3f}")
    if worst_k > max(1.0, 2.0 * worst_p):
        fail(f"{where}: sinkhorn outside its tolerance on {whose} inputs")
    return err


def serving_phase(dev, card, kernels):
    """Phase 8: export, load on the card, serve over HTTP at every bucket.
    Returns the launches per served request by kernel."""
    import numpy as np
    import torch
    from http.server import ThreadingHTTPServer

    from rdmnet_tpu_torch.cli.serve import make_handler
    from rdmnet_tpu_torch.config import make_cfg
    from rdmnet_tpu_torch.data.procedural import procedural_pair
    from rdmnet_tpu_torch.graph.pyramid import build_pair_batch, pad_cloud
    from rdmnet_tpu_torch.models import RDMNet, pipeline, with_pyramid
    from rdmnet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from rdmnet_tpu_torch.data.loader import pad_points_np
    from rdmnet_tpu_torch.serving import export_inference, load_exported

    cfg = make_cfg()
    model = RDMNet(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    resident = sum(t.numel() * t.element_size()
                   for t in list(model.parameters()) + list(model.buffers()))
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        buckets = export_inference(cfg, model, out_dir, bucket_scales=SERVE_SCALES)
        export_s = time.perf_counter() - t0
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        serve, meta = load_exported(out_dir)
        torch.cuda.synchronize(dev)
        load_s = time.perf_counter() - t0
        loaded = torch.cuda.memory_allocated(dev) - before
    del model
    caps = [b["cap"] for b in buckets]
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in list(serve.model.parameters()) + list(serve.model.buffers())}
    # the load also captures each bucket's program, which keeps its inputs and outputs
    programs = sum(p.memory_bytes for p in serve.programs.values())
    print(f"serving: exported {n_params} parameters ({meta['n_weights']} arrays) for buckets "
          f"{caps} in {export_s:.3f} s, loaded in {load_s:.3f} s; the load allocated "
          f"{loaded / 1e6:.3f} MB on the card: {programs / 1e6:.3f} MB kept by the captured "
          f"programs ({sorted(serve.programs)}) and {(loaded - programs) / 1e6:.3f} MB for "
          f"{resident / 1e6:.3f} MB of parameters and buffers, held in {len(storages)} device "
          f"storages of {sum(storages.values()) / 1e6:.3f} MB")
    loaded -= programs
    if serve.model.device.type != "cuda" or sorted(serve.programs) != caps \
            or not resident <= loaded < 1.5 * resident:
        fail(f"serving: the load allocated {loaded} bytes for {resident} bytes of weights "
             "(one shared copy expected)")

    # ~13k / ~20k / ~28k points per cloud from one dense procedural pair, and the
    # whole pair (above the largest capacity: truncated)
    ref, src, _ = procedural_pair(SEED, n_rings=192, n_azimuths=6000)
    if min(len(ref), len(src)) <= caps[-1]:
        fail(f"serving: the dense pair has {len(ref)}/{len(src)} points, not above {caps[-1]}")
    pick = np.random.RandomState(SEED)
    pairs = [(ref[pick.permutation(len(ref))[:n]], src[pick.permutation(len(src))[:n]])
             for n in SERVE_SIZES] + [(ref, src)]

    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(serve, meta))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    served, expected = {name: 0 for name in launch_counts()}, {}
    n_requests = 0
    try:
        for (r, s), want_cap in zip(pairs, caps + [caps[-1]]):
            buf = io.BytesIO()
            np.savez(buf, ref_points=r, src_points=s)
            body = buf.getvalue()
            # the checked request, over HTTP: it replays its bucket's program, whose
            # launches were counted at the capture; the wrappers' counters stay at 0
            reset_launch_counts()
            status, data = post(url + "/register", body)
            ticked = launch_counts()
            n_requests += 1
            expected[str(want_cap)] = expected.get(str(want_cap), 0) + 1
            if status != 200:
                fail(f"serving: HTTP {status} for a {len(r)}-point pair: {data[:200]!r}")
            program = serve.programs[want_cap].launches
            counts = {name: program[name] for name in ticked}
            if counts != {"radius_knn": 12, "sinkhorn": 1} or any(ticked.values()):
                fail(f"serving: launches {counts} in the request's program (expected 12 kNN and "
                     f"1 Sinkhorn), wrappers ticked {ticked} by the replay (expected none)")
            for name, n in counts.items():
                served[name] += n
            resp = dict(np.load(io.BytesIO(data)))
            direct = serve(r, s)
            if serve.last_cap != want_cap:
                fail(f"serving: a {len(r)}-point pair went to bucket {serve.last_cap}, "
                     f"expected {want_cap}")
            bucket = next(b for b in buckets if b["cap"] == want_cap)
            # the kNN kernel against its plain version at this bucket's shapes
            # and launch plans, on the graph of this request's pair
            pyr = bucket["cfg"].pyramid
            kb = build_pair_batch(*pad_cloud(r, want_cap, device=dev),
                                  *pad_cloud(s, want_cap, device=dev),
                                  torch.eye(4, device=dev), pyr)
            check_searches(*pair_levels(kb, pyr.num_stages), pyr, kernels,
                           prefix=f"bucket {want_cap} ({len(r)} points) ")
            live = serve_checked(with_pyramid(serve.model, bucket["cfg"].pyramid),
                                 (*pad_points_np(r, want_cap), *pad_points_np(s, want_cap)), dev,
                                 kernels)
            live_tf = live["estimated_transform"].cpu().numpy()
            n_corr = int((direct["corr_scores"] > 0).sum())
            est = direct["estimated_transform"]
            http_err = float(np.abs(resp["estimated_transform"] - est).max())
            live_err = float(np.abs(live_tf - est).max())
            n_live = int((live["corr_scores"] > 0).sum())
            print(f"serving: {len(r)}/{len(s)} points -> bucket {want_cap}: {n_corr} "
                  f"correspondences; HTTP vs direct pose {http_err:.3e}, "
                  f"{len(resp['corr_scores'])} correspondences; pipeline vs direct pose "
                  f"{live_err:.3e}, {n_live} correspondences; launches {counts}")
            if http_err > 1e-6 or len(resp["corr_scores"]) != n_corr:
                fail("serving: the HTTP response differs from the direct call")
            if live_err > 1e-6 or n_live != n_corr or not np.isfinite(live_tf).all():
                fail("serving: the direct call differs from pipeline at the bucket's config")

        status, data = post(url + "/register", b"not an npz")
        if status != 400:
            fail(f"serving: a malformed body got HTTP {status}, expected 400")
        health = get_json(url + "/healthz")
        print(f"serving: /healthz after a malformed body: requests {health['requests']}, "
              f"errors {health['errors']}, per bucket {health['bucket_requests']}")
        if (health["requests"], health["errors"]) != (n_requests, 1) \
                or health["bucket_requests"] != expected:
            fail(f"serving: /healthz counts {health}, expected {n_requests} requests, 1 error, "
                 f"{expected}")

        # time each bucket on its pair, after warm-up: HTTP requests, direct
        # calls, direct calls on a new thread (as the server runs each
        # request) and pipeline on the padded pair already on the card, in
        # turns with the order rotating (the host's noise drifts)
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        # the HTTP layer alone: a second server whose serve function returns
        # the bucket's stored outputs, so its time holds no device work and
        # none of the device path's host noise
        stored = {}
        stub = lambda _r, _s: stored["out"]  # noqa: E731
        stub_server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(stub, meta))
        stub_thread = threading.Thread(target=stub_server.serve_forever, daemon=True)
        stub_thread.start()
        stub_url = f"http://127.0.0.1:{stub_server.server_address[1]}/register"
        kinds = ("http", "direct", "thread", "pipeline")
        for (r, s), b in zip(pairs, buckets):
            cap = b["cap"]
            buf = io.BytesIO()
            np.savez(buf, ref_points=r, src_points=s)
            body = buf.getvalue()
            view = with_pyramid(serve.model, b["cfg"].pyramid)
            padded = [torch.as_tensor(x, device=dev)
                      for x in (*pad_points_np(r, cap), *pad_points_np(s, cap))]
            for _ in range(SERVE_WARM):
                post(url + "/register", body)
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            resident_now = torch.cuda.memory_allocated(dev)
            ms = {kind: [] for kind in kinds}
            for i in range(SERVE_TIMED):
                for kind in kinds[i % 4:] + kinds[:i % 4]:
                    t0 = time.perf_counter()
                    if kind == "http":
                        status, _ = post(url + "/register", body)
                        if status != 200:
                            fail(f"serving: HTTP {status} while timing bucket {cap}")
                    elif kind == "direct":
                        serve(r, s)
                    elif kind == "thread":
                        with ThreadPoolExecutor(max_workers=1) as worker:
                            worker.submit(serve, r, s).result()
                    else:
                        pipeline(view, *padded, device=dev)
                        torch.cuda.synchronize(dev)
                    ms[kind].append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated(dev)
            # one more direct call under the profiler: kernel time against wall time
            torch.cuda.synchronize(dev)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                serve(r, s)
                wall_ms = (time.perf_counter() - t0) * 1e3
            kernel_ms = sum(e.self_device_time_total for e in prof.key_averages()
                            if e.device_type == DeviceType.CUDA
                            and not getattr(e, "is_user_annotation", False)) / 1e3
            diff = {k: sorted(a - c for a, c in zip(ms[k], ms[base]))
                    for k, base in (("http", "direct"), ("thread", "direct"),
                                    ("direct", "pipeline"))}
            stored["out"] = serve(r, s)
            layer_ms = []
            for i in range(SERVE_WARM + HTTP_LAYER_TIMED):
                t0 = time.perf_counter()
                status, _ = post(stub_url, body)
                if status != 200:
                    fail(f"serving: HTTP {status} from the HTTP-layer server")
                if i >= SERVE_WARM:
                    layer_ms.append((time.perf_counter() - t0) * 1e3)
            print(f"serving bucket {cap} ({len(r)}/{len(s)} points), {SERVE_TIMED} turns after "
                  f"{SERVE_WARM} warm-up requests, {card}:\n"
                  f"  HTTP ms/request {spread(ms['http'])}\n"
                  f"  direct ms/call {spread(ms['direct'])}\n"
                  f"  direct ms/call on a new thread {spread(ms['thread'])}\n"
                  f"  pipeline ms/pair on the padded pair on the card {spread(ms['pipeline'])}\n"
                  f"  serving overhead per turn: HTTP - direct {spread(diff['http'])}; thread - "
                  f"direct {spread(diff['thread'])}; direct - pipeline {spread(diff['direct'])}\n"
                  f"  HTTP layer alone (stored outputs, {len(body)} request bytes), "
                  f"{HTTP_LAYER_TIMED} requests: ms/request {spread(layer_ms)}\n"
                  f"  peak memory {peak / 2**20:.1f} MiB ({resident_now / 2**20:.1f} MiB resident "
                  f"before the requests); profiled direct call {wall_ms:.3f} ms wall, "
                  f"{kernel_ms:.3f} ms of kernel time ({100 * kernel_ms / wall_ms:.1f}% busy under "
                  "the profiler)")
        final = get_json(url + "/healthz")
        if final["requests"] != n_requests + len(caps) * (SERVE_WARM + SERVE_TIMED):
            fail(f"serving: /healthz counted {final['requests']} requests")
        stub_server.shutdown()
        stub_server.server_close()
        stub_thread.join(timeout=60)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    return {name: n / n_requests for name, n in served.items()}


RANSAC_INLIERS = 820  # of phase 9's 2048 correspondences (60% outliers)


def ransac_case():
    """Phase 9's correspondences: (src, ref, pose) with 2048 rows, the first
    ``RANSAC_INLIERS`` under the pose with +-0.01 m noise, the rest outliers
    in a 40 m cube."""
    import numpy as np

    from rdmnet_tpu_torch.utils.se3_np import get_transform_from_rotation_translation

    rng = np.random.RandomState(SEED)
    n, n_in = 2048, RANSAC_INLIERS
    q = rng.randn(4)
    w, x, y, z = q / np.linalg.norm(q)
    rot = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                    [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                    [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])
    tf = get_transform_from_rotation_translation(rot, rng.randn(3) * 3)
    src = ((rng.rand(n, 3) - 0.5) * 40).astype(np.float32)
    ref = (src @ rot.T + tf[:3, 3] + (rng.rand(n, 3) - 0.5) * 0.02).astype(np.float32)
    ref[n_in:] = (rng.rand(n - n_in, 3) - 0.5) * 40
    return src, ref, tf


def ransac_phase(dev, card):
    """Phase 9: RANSAC on the card against the CPU on the same uniforms, the
    known pose recovered, and the time of 50,000 iterations."""
    import numpy as np
    import torch

    from rdmnet_tpu_torch.ops.ransac import (ransac_capacity, ransac_registration,
                                             ransac_registration_host)

    src, ref, tf = ransac_case()
    n, n_in = len(src), RANSAC_INLIERS
    cap, chunk = ransac_capacity(n)
    n_chunks = -(-RANSAC_ITERATIONS // chunk)
    u = torch.rand(n_chunks, chunk, 4, generator=torch.Generator().manual_seed(SEED))
    args = [torch.from_numpy(src), torch.from_numpy(ref), torch.ones(n, dtype=torch.bool), u]
    kw = dict(num_iterations=RANSAC_ITERATIONS, chunk=chunk, threshold=0.3)
    with torch.no_grad():
        want = ransac_registration(*args, **kw).numpy()
        got = ransac_registration(*[a.to(dev) for a in args], **kw).cpu().numpy()
    err = float(np.abs(got - want).max())
    pose_err = float(np.abs(got - tf).max())
    ransac_registration_host(src, ref, num_iterations=RANSAC_ITERATIONS)  # warm-up
    ms = []
    for seed in range(5):
        t0 = time.perf_counter()
        host = ransac_registration_host(src, ref, num_iterations=RANSAC_ITERATIONS, seed=seed)
        ms.append((time.perf_counter() - t0) * 1e3)
    host_err = float(np.abs(host - tf).max())
    print(f"ransac: {n} correspondences ({n - n_in} outliers), {n_chunks} chunks of {chunk} "
          f"hypotheses at capacity {cap}; card vs CPU on the same uniforms {err:.3e}; pose vs "
          f"known {pose_err:.3e} (host wrapper {host_err:.3e}); {RANSAC_ITERATIONS} iterations "
          f"in ms: {spread(ms)} ({card})")
    if err > 1e-5 or pose_err > 1e-3 or host_err > 1e-3:
        fail("ransac: outside the tolerances")


def _launch_recorder(events, kind):
    """Wraps a step factory of the port so each step it makes appends (kind,
    the cumulative launch counts after the step) to ``events``."""
    from rdmnet_tpu_torch.ops.kernels import launch_counts

    def wrap(factory):
        def make(*args, **kwargs):
            step = factory(*args, **kwargs)

            def counted(*a, **kw):
                out = step(*a, **kw)
                events.append((kind, launch_counts()))
                return out
            return counted
        return make
    return wrap


def _program_recorder(events, kind, replayed):
    """Wraps a capture function of the port so each call of the program it
    makes appends (kind, the cumulative launch counts after the call) to
    ``events``. A replay ticks no wrapper counter, so each replay adds its
    program's launches (counted at the capture) to ``replayed``, which the
    counts carry; the eager warm-ups and the capture tick the counters."""
    from rdmnet_tpu_torch.ops.kernels import launch_counts

    def wrap(capture):
        def make(*args, **kwargs):
            program = capture(*args, **kwargs)

            def counted(*a, **kw):
                captured = program.graph is not None
                out = program(*a, **kw)
                if captured:
                    for name in replayed:
                        replayed[name] += program.launches[name]
                events.append((kind, {k: v + replayed[k] for k, v in launch_counts().items()}))
                return out
            return counted
        return make
    return wrap


def _per_event(events):
    """Launches per event from cumulative counts: each event owns what was
    launched since the one before it (its batch's graph build included)."""
    out, prev = [], {"radius_knn": 0, "sinkhorn": 0}
    for kind, counts in events:
        out.append((kind, {k: counts[k] - prev[k] for k in counts}))
        prev = counts
    return out


def write_workflow_root(root, sequences=WORKFLOW_SEQUENCES, scan=WORKFLOW_SCAN):
    """Phase 10's KITTI-layout root of procedural scans (phase 14 trains on
    it too)."""
    import numpy as np

    from rdmnet_tpu_torch.data.datasets import write_procedural_root

    t0 = time.perf_counter()
    write_procedural_root(root, "kitti", sequences, **scan)
    sizes = [len(np.load(os.path.join(root, "downsampled_xyzi", f"{seq:02d}", f"{i:06d}.npy")))
             for seq, (_, n) in sequences.items() for i in range(n)]
    print(f"workflow: root of {len(sizes)} procedural scans ({min(sizes)}-{max(sizes)} "
          f"points) written in {time.perf_counter() - t0:.3f} s")


def workflow_phase(dev, card, kernels, isolated_step_ms, root, cli_args=()):
    """Phase 10: train -> snapshot -> test -> eval through the CLIs' ``main``
    on the procedural KITTI-layout root ``root`` (``write_workflow_root``),
    on ``dev``; then test with ``--vis`` and eval with ``--figures``.
    ``cli_args`` go to every CLI (``--cfg_preset tiny`` rehearses the phase
    on the CPU). Returns launches per trainer step, validation pair and test
    pair by kernel."""
    import numpy as np
    import torch

    import rdmnet_tpu_torch.cli.test as test_cli
    import rdmnet_tpu_torch.engine.trainer as trainer_mod
    from rdmnet_tpu_torch.cli import eval as eval_cli
    from rdmnet_tpu_torch.cli import trainval
    from rdmnet_tpu_torch.cli.common import (build_model_and_params, make_forward, pad_pair_np,
                                             trim_outputs)
    from rdmnet_tpu_torch.data.datasets import RegistrationPairDataset
    from rdmnet_tpu_torch.data.loader import PairLoader, choose_bucket
    from rdmnet_tpu_torch.engine import create_train_state
    from rdmnet_tpu_torch.engine.checkpoint import CheckpointManager, state_to_host
    from rdmnet_tpu_torch.models import RDMNet
    from rdmnet_tpu_torch.ops.kernels import reset_launch_counts

    def equal_states(a, b, where):
        for part in ("model", "accumulator"):
            for k, v in (a[part] or {}).items():
                if not torch.equal(v, b[part][k]):
                    fail(f"workflow: {where}: {part} {k} differs")
        for name, st in a["optimizer"]["state"].items():
            for k, v in st.items():
                if not torch.equal(v.cpu(), b["optimizer"]["state"][name][k].cpu()):
                    fail(f"workflow: {where}: optimizer {name} {k} differs")
        for k in ("count", "mini_step", "notfinite_count"):
            if a[k] != b[k]:
                fail(f"workflow: {where}: {k} {a[k]} != {b[k]}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cli_args = ["--device", dev.type, *cli_args]
    events, resumed, test_cfgs = [], [], []
    orig = (trainer_mod.make_train_step, trainer_mod.make_eval_step, trainer_mod.Trainer.resume,
            test_cli._make_eval_forward, test_cli.run_eval_loop, trainer_mod.capture_train_step,
            trainer_mod.capture_eval_step, test_cli._make_eval_program)
    replayed = {"radius_knn": 0, "sinkhorn": 0}
    loop_s = []

    def resume_and_keep(self):
        orig[2](self)
        resumed.append(state_to_host(self.state))

    def test_forward(cfg, *args, **kwargs):  # the CPU's
        test_cfgs.append(cfg)
        return _launch_recorder(events, "test")(orig[3])(cfg, *args, **kwargs)

    def test_program(cfg, *args, **kwargs):  # the card's
        test_cfgs.append(cfg)
        return _program_recorder(events, "test", replayed)(orig[7])(cfg, *args, **kwargs)

    def timed_loop(*args, **kwargs):
        t0 = time.perf_counter()
        board = orig[4](*args, **kwargs)
        loop_s.append(time.perf_counter() - t0)
        return board

    # the CLIs build these inside their mains: wrapped here to count launches
    # per step and pair, keep the resumed state and time the test loop
    trainer_mod.make_train_step = _launch_recorder(events, "train")(orig[0])
    trainer_mod.make_eval_step = _launch_recorder(events, "val")(orig[1])
    # on the card the Trainer steps through its captured programs
    trainer_mod.capture_train_step = _program_recorder(events, "train", replayed)(orig[5])
    trainer_mod.capture_eval_step = _program_recorder(events, "val", replayed)(orig[6])
    trainer_mod.Trainer.resume = resume_and_keep
    test_cli._make_eval_forward = test_forward
    test_cli._make_eval_program = test_program
    test_cli.run_eval_loop = timed_loop
    try:
        with tempfile.TemporaryDirectory() as tmp:
            run = os.path.join(tmp, "run")
            argv = ["--root", root, "--output_dir", run, "--bucket_scale", "0.7",
                    "--log_steps", "2", "--keep_snapshots", "1", *cli_args]

            # ---- train 2 epochs, then resume for a third
            reset_launch_counts()
            t0 = time.perf_counter()
            first = trainval.main(argv + ["--max_epoch", "2"])
            train1_s = time.perf_counter() - t0
            saved = torch.load(os.path.join(run, "snapshots", "2", "state.pt"),
                               map_location="cpu", weights_only=True)
            equal_states(state_to_host(first.state), saved, "the saved snapshot")
            t0 = time.perf_counter()
            second = trainval.main(argv + ["--max_epoch", "3", "--resume"])
            train2_s = time.perf_counter() - t0
            if len(resumed) != 1:
                fail("workflow: the resumed run did not resume")
            equal_states(resumed[0], saved, "the resumed state against the snapshot")
            train_events = _per_event(events)
            with open(os.path.join(run, "metrics.jsonl")) as f:
                records = [json.loads(line) for line in f]
            phases = [(r["phase"], r["epoch"]) for r in records]
            if phases != [("train", 0), ("val", 0), ("train", 1), ("val", 1), ("train", 2),
                          ("val", 2)]:
                fail(f"workflow: metrics.jsonl records {phases}")
            if not all(np.isfinite(v) for r in records for v in r.values()
                       if isinstance(v, float)):
                fail(f"workflow: non-finite values in metrics.jsonl: {records}")
            best = CheckpointManager(os.path.join(run, "snapshots_best")).read_metadata()
            want_best = max(trainer_mod.Trainer._val_score(r) for r in records
                            if r["phase"] == "val")
            if tuple(best["score"]) != want_best:
                fail(f"workflow: best snapshot score {best['score']}, best val {want_best}")
            if second.snapshots.all_steps() != [3] or second.state.count != 12:
                fail(f"workflow: snapshots {second.snapshots.all_steps()}, "
                     f"{second.state.count} updates")
            for kind, want in (("train", {"radius_knn": 12, "sinkhorn": 0}),
                               ("val", {"radius_knn": 12, "sinkhorn": 1})):
                got = [c for k, c in train_events if k == kind]
                if len(got) != {"train": 12, "val": 6}[kind] or any(c != want for c in got):
                    fail(f"workflow: {kind} launches {got}, expected {want} each")
            timings = first.epoch_timings + second.epoch_timings
            vals = first.val_timings + second.val_timings
            cfg = second.cfg
            for t, v in zip(timings, vals):
                rates = ", ".join(f"{r:.3f}" for r in t["window_steps_per_s"])
                print(f"workflow epoch {t['epoch']}: {t['steps']} steps in {t['seconds']:.3f} s "
                      f"({t['seconds'] / t['steps'] * 1e3:.3f} ms/step), windowed steps/s "
                      f"[{rates}] ({', '.join(f'{1e3 / r:.3f}' for r in t['window_steps_per_s'])}"
                      f" ms/step; phase 6 isolated step {isolated_step_ms:.3f} ms); waited on the "
                      f"loader {t['loader_wait_s']:.3f} s ({100 * t['loader_wait_s'] / t['seconds']:.2f}"
                      f"% of the epoch); validation {v['pairs']:.0f} pairs in {v['seconds']:.3f} s "
                      f"({v['seconds'] / v['pairs'] * 1e3:.3f} ms/pair)")
            print(f"workflow train: trainval.main {train1_s:.3f} s (2 epochs), resumed "
                  f"{train2_s:.3f} s (1 epoch); resumed state equal to the snapshot; launches per "
                  f"train step {train_events[0][1]}, per val pair "
                  f"{next(c for k, c in train_events if k == 'val')}; best snapshot epoch "
                  f"{best['epoch']} score {best['score']}")

            # ---- snapshot save and restore on their own
            mgr = CheckpointManager(os.path.join(tmp, "timing"))
            sync()
            t0 = time.perf_counter()
            mgr.save(1, second.state, metadata={"epoch": 1})
            host_s = time.perf_counter() - t0
            mgr.wait_until_finished()
            save_s = time.perf_counter() - t0
            nbytes = os.path.getsize(os.path.join(mgr.directory, "1", "state.pt"))
            fresh = create_train_state(cfg, RDMNet(cfg, device=dev))
            sync()
            t0 = time.perf_counter()
            mgr.restore(fresh)
            sync()
            restore_s = time.perf_counter() - t0
            equal_states(state_to_host(fresh), state_to_host(second.state), "restore timing")
            print(f"workflow snapshot: save {save_s * 1e3:.3f} ms ({host_s * 1e3:.3f} ms copying "
                  f"to the host, the rest writing), restore {restore_s * 1e3:.3f} ms, "
                  f"{nbytes / 1e6:.3f} MB on disk ({card})")
            del fresh, first

            # ---- what the loader's thread costs the loop: the CLI's prefetch of 2
            # against batches read on the loop's own thread, in turns, one
            # epoch each on the same data (seeds as trainval's)
            t = cfg.train
            for turn, prefetch in enumerate((0, 2, 2, 0)):
                ds = RegistrationPairDataset("kitti", root, "train", point_limit=t.point_limit,
                                             use_augmentation=t.use_augmentation, seed=cfg.seed)
                loader = PairLoader(ds, cap=cfg.pyramid.caps[0], shuffle=True, drop_last=True,
                                    seed=cfg.seed, prefetch=prefetch)
                probe = trainer_mod.Trainer(cfg, loader, output_dir=os.path.join(tmp, f"pf{turn}"),
                                            log_steps=1, device=dev)
                probe.train_epoch()
                e = probe.epoch_timings[-1]
                print(f"workflow loader prefetch {prefetch} (turn {turn}): ms per step "
                      f"{[round(1e3 / r, 3) for r in e['window_steps_per_s']]}, epoch "
                      f"{e['seconds'] * 1e3:.3f} ms ({e['seconds'] / e['steps'] * 1e3:.3f} "
                      f"ms/step), waited on the loader {e['loader_wait_s'] * 1e3:.3f} ms ({card})")
                del probe
            # the same batches through the train step outside the loop, each
            # step synchronised: what the data costs beside phase 6's one pair
            loader = PairLoader(RegistrationPairDataset(
                "kitti", root, "train", point_limit=t.point_limit,
                use_augmentation=t.use_augmentation, seed=cfg.seed),
                cap=cfg.pyramid.caps[0], shuffle=True, drop_last=True, seed=cfg.seed, prefetch=0)
            loader.peek()  # as the Trainer does
            batches = list(loader)
            state = create_train_state(cfg, RDMNet(cfg, device=dev, generator=torch.Generator()
                                                   .manual_seed(cfg.seed)),
                                       steps_per_epoch=len(batches))
            step, gen, alone_ms = orig[0](cfg, dev), torch.Generator(device=dev), []
            gen.manual_seed(cfg.seed + 1)
            for _ in range(2):
                for b in batches:
                    sync()
                    t0 = time.perf_counter()
                    state, _ = step(state, trainer_mod.batch_to_device(b, cfg.pyramid, dev), gen)
                    sync()
                    alone_ms.append(round((time.perf_counter() - t0) * 1e3, 3))
            print(f"workflow: the epoch's batches through the train step outside the loop, twice, "
                  f"each step synchronised: ms {alone_ms} ({card})")
            del state

            # ---- test the best snapshot
            feature_dir = os.path.join(tmp, "features")
            events.clear()
            replayed.update(dict.fromkeys(replayed, 0))
            reset_launch_counts()
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                board = test_cli.main(["--root", root, "--snapshot_dir",
                                       os.path.join(run, "snapshots_best"), "--buckets",
                                       "0.7,1.0", "--subset", "test", "--feature_dir",
                                       feature_dir, *cli_args])
            test_s = time.perf_counter() - t0
            print("\n".join("  " + line for line in out.getvalue().splitlines()))
            test_events = _per_event(events)
            if [c for _, c in test_events] != [{"radius_knn": 12, "sinkhorn": 1}] * 2:
                fail(f"workflow: test launches {test_events}")
            names = sorted(n for n in os.listdir(feature_dir) if n.endswith(".npz"))
            if len(names) != 2:
                fail(f"workflow: test wrote {names}")
            # each dump against the same pair through make_forward at its bucket
            cfgs = sorted(test_cfgs, key=lambda c: c.pyramid.caps[0])
            t0 = time.perf_counter()
            model = build_model_and_params(cfgs[-1], os.path.join(run, "snapshots_best"),
                                           device=dev)
            load_s = time.perf_counter() - t0
            dataset = RegistrationPairDataset("kitti", root, "test")
            write_ms, check_ms = [], []
            for i in range(len(dataset)):
                item = dataset[i]
                name = f"{item['seq_id']}_{item['src_frame']}_{item['ref_frame']}.npz"
                bi = choose_bucket(max(len(item["ref_points"]), len(item["src_points"])),
                                   [c.pyramid.caps[0] for c in cfgs])
                sync()
                t0 = time.perf_counter()
                want = trim_outputs(make_forward(cfgs[bi], model, with_gt=True, device=dev)(
                    *pad_pair_np(cfgs[bi], item["ref_points"], item["src_points"]),
                    item["transform"]), item["transform"])
                check_ms.append((time.perf_counter() - t0) * 1e3)
                got = dict(np.load(os.path.join(feature_dir, name)))
                if set(got) != set(want) or any(not np.array_equal(got[k], want[k]) for k in want):
                    bad = [k for k in want if k not in got or not np.array_equal(got[k], want[k])]
                    fail(f"workflow: {name} differs from make_forward + trim_outputs in {bad}")
                t0 = time.perf_counter()
                np.savez_compressed(os.path.join(tmp, "write_" + name), **got)
                write_ms.append((time.perf_counter() - t0) * 1e3)
            lines = [line for line in out.getvalue().splitlines() if "prep" in line]
            prep = [float(x) * 1e3 for x in re.findall(r"prep ([0-9.]+)s", "\n".join(lines))]
            proc = [float(x) * 1e3 for x in re.findall(r"proc ([0-9.]+)s", "\n".join(lines))]
            print(f"workflow test: {len(names)} dumps equal to make_forward + trim_outputs at "
                  f"their buckets; per pair prep {prep} ms, proc {proc} ms, the .npz write alone "
                  f"{[round(w, 3) for w in write_ms]} ms, forward + trim in sequence "
                  f"{[round(c, 3) for c in check_ms]} ms; run_eval_loop {loop_s[0] * 1e3 / len(names):.3f} "
                  f"ms/pair wall (in sequence, forward + trim + write: "
                  f"{(sum(check_ms) + sum(write_ms)) / len(names):.3f}); test.main {test_s:.3f} s in "
                  f"all (model build and snapshot load alone {load_s * 1e3:.3f} ms); launches per "
                  f"pair {test_events[0][1]} ({card})")
            print(f"workflow test board (a model trained for 12 steps: a plumbing check, not "
                  f"accuracy): {board.format()}")

            # ---- eval the dumps
            for method in ("lgr", "svd", "ransac"):
                json_out = os.path.join(tmp, f"eval_{method}.json")
                with contextlib.redirect_stdout(io.StringIO()):
                    t0 = time.perf_counter()
                    summary = eval_cli.main(["--feature_dir", feature_dir, "--method", method,
                                             "--json_out", json_out, "--device", dev.type])
                    eval_s = time.perf_counter() - t0
                with open(json_out) as f:
                    written = json.load(f)
                numbers = [v for k, v in written.items() if k not in ("method", "failed_pairs",
                                                                       "per_pair")]
                numbers += [v for p in written["per_pair"] for k, v in p.items()
                            if k not in ("seq_id", "src_frame", "ref_frame")]
                if set(written) != EVAL_JSON_KEYS or written["n_pairs"] != 2 or written != summary \
                        or not all(v is None or np.isfinite(v) for v in numbers):
                    fail(f"workflow: eval {method} wrote {written}")
                print(f"workflow eval {method}: {eval_s / written['n_pairs'] * 1e3:.3f} ms/pair; "
                      f"RR {written['RR']}, RRE {written['RRE_deg']} deg, RTE {written['RTE_m']} m, "
                      f"PIR {written['PIR']:.4f}, IR {written['IR']:.4f} (a model trained for 12 "
                      f"steps: a plumbing check, not accuracy; {card})")

            # ---- the same test with --vis, its dumps through eval --figures
            vis_dir = os.path.join(tmp, "featureskitti")
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                test_cli.main(["--root", root, "--snapshot_dir", os.path.join(run, "snapshots_best"),
                               "--buckets", "0.7,1.0", "--subset", "test", "--feature_dir",
                               vis_dir, "--vis", *cli_args])
            vis_s = time.perf_counter() - t0
            check_vis_exports(vis_dir, names)
            figures_check(vis_dir, dev, card)
            print(f"workflow test --vis: {vis_s:.3f} s for {len(names)} pairs, each pair's PLY "
                  f"exports and viewer.html present ({card})")
    finally:
        (trainer_mod.make_train_step, trainer_mod.make_eval_step, trainer_mod.Trainer.resume,
         test_cli._make_eval_forward, test_cli.run_eval_loop, trainer_mod.capture_train_step,
         trainer_mod.capture_eval_step, test_cli._make_eval_program) = orig
    counts = {}
    for key, kind, events_of in (("launches_per_trainer_step", "train", train_events),
                                 ("launches_per_val_pair", "val", train_events),
                                 ("launches_per_test_pair", "test", test_events)):
        got = [c for k, c in events_of if k == kind]
        counts[key] = {name: sum(c[name] for c in got) / len(got) for name in got[0]}
    return counts


VIS_FILES = {"viewer.html", "ref_points.ply", "src_points.ply", "ref_grouping.ply",
             "src_grouping.ply", "ref_vote_offsets.ply", "src_vote_offsets.ply",
             "ref_shifted_nodes.ply", "src_shifted_nodes.ply"}
FIGURE_FILES = ["method_comparison_lgr.png", "recall_curves_lgr.png", "traj_seq8_lgr.png"]


def check_vis_exports(feature_dir, dumps):
    """``test --vis`` wrote ``VIS_FILES`` and correspondence lines for each
    dump, and no export into the ``.npz`` schema."""
    import numpy as np

    got = sorted(n for n in os.listdir(feature_dir) if n.endswith(".npz"))
    if got != sorted(dumps):
        fail(f"test --vis wrote dumps {got}, the plain run {sorted(dumps)}")
    for name in got:
        files = set(os.listdir(os.path.join(feature_dir, "vis", name[:-4])))
        lines = files & {"correspondences_correct.ply", "correspondences_wrong.ply"}
        if not VIS_FILES <= files or not lines:
            fail(f"test --vis: {name} has {sorted(files)}")
        with np.load(os.path.join(feature_dir, name)) as d:
            if any(k.startswith("vis_") for k in d.files):
                fail(f"test --vis: {name} holds vis_* keys")
        with open(os.path.join(feature_dir, "vis", name[:-4], "viewer.html")) as f:
            if "const LAYERS = [" not in f.read():
                fail(f"test --vis: {name}'s viewer.html holds no layers")


def figures_check(feature_dir, dev, card):
    """``eval --figures --baselines kitti`` on ``feature_dir``: the JAX CLI's
    file names, each PNG readable. Where matplotlib is not installed the flag
    must refuse at once; the figures' numbers (ATE per sequence, recall
    curves) are then computed without drawing."""
    import importlib.util

    import numpy as np

    from rdmnet_tpu_torch.cli import eval as eval_cli
    from rdmnet_tpu_torch.utils.eval_figures import (absolute_trajectory_error,
                                                     compose_trajectory, recall_vs_threshold)

    args = ["--feature_dir", feature_dir, "--figures", "--baselines", "kitti",
            "--device", dev.type]
    if importlib.util.find_spec("matplotlib") is None:
        err = io.StringIO()
        with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
            try:
                eval_cli.main(args)
                fail("eval --figures ran without matplotlib")
            except SystemExit as e:
                if e.code != 2 or "matplotlib" not in err.getvalue():
                    fail(f"eval --figures without matplotlib: exit {e.code}, {err.getvalue()}")
        summary = eval_cli.main(["--feature_dir", feature_dir, "--device", dev.type])
        pairs = sorted(summary["per_pair"], key=lambda p: p["src_frame"])
        ests, gts = [], []
        for p in pairs:
            with np.load(os.path.join(feature_dir, f"{p['seq_id']}_{p['src_frame']}_"
                                                   f"{p['ref_frame']}.npz")) as d:
                ests.append(d["estimated_transform"])
                gts.append(d["transform"])
        ate, _ = absolute_trajectory_error(compose_trajectory(ests), compose_trajectory(gts))
        rr, _ = recall_vs_threshold([p["rre"] for p in pairs], [p["rte"] for p in pairs],
                                    np.linspace(0.25, 5, 20), np.linspace(0.1, 2, 20), 5.0, 2.0)
        if not all(np.isfinite(v) for v in ate.values()) or not np.isfinite(rr).all():
            fail(f"figure numbers: ATE {ate}, recall {rr}")
        print(f"eval --figures: matplotlib is not installed on this machine, so the flag "
              f"refuses at once (exit 2); the figures' numbers without drawing: ATE "
              f"{ {k: round(v, 4) for k, v in ate.items()} }, recall by RRE "
              f"{rr.round(3).tolist()} ({card})")
        return
    with contextlib.redirect_stdout(io.StringIO()):
        eval_cli.main(args)
    figure_dir = os.path.join(feature_dir, "figures")
    got = sorted(os.listdir(figure_dir))
    if got != FIGURE_FILES:
        fail(f"eval --figures wrote {got}")
    import matplotlib.image

    for name in got:
        if matplotlib.image.imread(os.path.join(figure_dir, name)).ndim != 3:
            fail(f"eval --figures: {name} is not an image")
    print(f"eval --figures: {got} written and readable ({card})")


FAMILY_STEPS = 3                         # train steps per family in phase 11
FAMILY_SEEDS = (1, 2)                    # weight draws of phase 11's card-vs-CPU check
PARITY_WARM, PARITY_TIMED, PARITY_STAGE = 2, 6, 3  # parity pairs of phase 11


def family_cfgs(base):
    """Phase 11's model families over ``base``: the other coarse transformers,
    ThDRoFormer with a sparse top-k schedule on every stage-2 layer, and the
    model without the vote layer."""
    r = dataclasses.replace
    return {
        "geotransformer": r(base, model=r(base.model, coarse_module="geotransformer")),
        "ape": r(base, model=r(base.model, coarse_module="ape")),
        "thdroformer_k2": r(base, thdroformer=r(base.thdroformer,
                                                k2=(0.5,) * base.thdroformer.num_layers2)),
        "vote_off": r(base, vote=r(base.vote, model_use_vote=False)),
    }


def upstream_key(key: str) -> str:
    """A port ``state_dict`` key -> an upstream RDMNet key that
    ``utils/torch_convert`` maps back to it (its rules inverted, with
    upstream's nesting)."""
    parts = key.split(".")
    if parts[0] in ("transformer", "transformer2") and re.fullmatch(r"(self|cross)_\d+", parts[1]):
        kind, idx = parts[1].rsplit("_", 1)
        rest = parts[2:]
        if rest[0] in ("attention", "linear", "norm"):
            rest = ["attention"] + rest
        return ".".join([parts[0], "transformer", "layers",
                         str(2 * int(idx) + (kind == "cross"))] + rest)
    if parts[0] in ("encoder", "decoder") and parts[-2] in ("norm", "norm_conv"):
        return ".".join(parts[:-1] + ["norm", parts[-1]])
    if parts[0] == "vote":
        m = re.fullmatch(r"(mlp|mlp_norm)_(\d+)", parts[1])
        if m:
            return ".".join(["vote", "mlp_modules", str(3 * int(m[2]) + (m[1] == "mlp_norm"))]
                            + parts[2:])
        if parts[1] == "out_norm":
            return ".".join(["vote", "out_proj", "1"] + parts[2:])
    return key


def rotate_kernel_points(model, seed):
    """A random rotation of every KPConv layer's kernel disposition, one per
    layer, as upstream draws them (the parity config reads each layer's own)."""
    import torch

    from rdmnet_tpu_torch.nn.kpconv import KPConv

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, KPConv):
                q, _ = torch.linalg.qr(torch.randn(3, 3, generator=gen, dtype=torch.float64))
                q = q * torch.sign(torch.linalg.det(q))
                kp = mod.kernel_points
                kp.copy_((kp.double().cpu() @ q).to(kp))


def timed_pipeline(model, args, dev, warm, timed, n_stage, label):
    """``warm`` + ``timed`` + ``n_stage`` pipeline calls on ``args`` (the
    padded pair on the card); 12 kNN and 1 Sinkhorn launches per call or
    fail. Returns (ms/pair, peak bytes, per-stage ms, the last outputs)."""
    import torch

    from rdmnet_tpu_torch.models import pipeline
    from rdmnet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    for _ in range(warm):
        out = pipeline(model, *args, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(timed):
        out = pipeline(model, *args, device=dev)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / timed
    peak = torch.cuda.max_memory_allocated()
    stage_ms = {}
    for _ in range(n_stage):
        marks = []

        def hook(name):
            torch.cuda.synchronize()
            marks.append((name, time.perf_counter()))

        torch.cuda.synchronize()
        prev = time.perf_counter()
        out = pipeline(model, *args, device=dev, stage_hook=hook)
        for name, t in marks:
            stage_ms[name] = stage_ms.get(name, 0.0) + (t - prev) * 1e3 / n_stage
            prev = t
    n = warm + timed + n_stage
    counts = launch_counts()
    if counts != {"radius_knn": 12 * n, "sinkhorn": n}:
        fail(f"{label}: launches {counts} over {n} pairs, expected 12 kNN and 1 Sinkhorn each")
    tf = out["estimated_transform"]
    if tf.shape != (4, 4) or not bool(torch.isfinite(tf).all()):
        fail(f"{label}: non-finite or misshapen estimated_transform")
    stages = (" stages " + json.dumps({k: round(v, 3) for k, v in stage_ms.items()})
              if n_stage else "")
    print(f"{label}: {ms:.3f} ms/pair over {timed} pairs, peak memory {peak / 2**20:.1f} MiB, "
          f"launches {counts} over {n} pairs (12 kNN and 1 Sinkhorn per pair){stages}")
    return ms, peak, stage_ms, out


def aligned_plan_error(a, b):
    """Max abs difference of two runs' log transport plans, patch by patch
    through their matched (ref, src) node pairs (near-equal matching scores
    may come out in another order); fails if the matched pairs differ."""
    import torch

    m = b["src_node_masks"].shape[0]
    keys = [(o["ref_node_corr_indices"].long().cpu() * m + o["src_node_corr_indices"].long().cpu())
            for o in (a, b)]
    order = torch.argsort(keys[0], stable=True)[torch.argsort(torch.argsort(keys[1], stable=True))]
    if not torch.equal(keys[0][order], keys[1]):
        return None, 0
    pa, pb = a["matching_scores"].cpu()[order], b["matching_scores"].cpu()
    live = pb > -1e11
    if not torch.equal(pa > -1e11, live):
        return None, 0
    return float((pa - pb)[live].abs().max()), int((order != torch.arange(len(order))).sum())


def model_surface_phase(dev, kernels, ref, src, gt):
    """Phase 11: the parity config, the other model families and the
    converter on the card, at ``make_cfg()`` width and the 0.7 bucket, on the
    phase-4 pair. Returns the launches per parity pair by kernel."""
    import numpy as np
    import torch

    from rdmnet_tpu_torch.cli.common import build_model_and_params
    from rdmnet_tpu_torch.config import make_cfg, make_parity_cfg, make_tiny_cfg
    from rdmnet_tpu_torch.data.procedural import procedural_pair
    from rdmnet_tpu_torch.engine import batch_to_device, create_train_state, make_train_step
    from rdmnet_tpu_torch.graph.pyramid import build_pair_batch, pad_cloud, search_plan
    from rdmnet_tpu_torch.models import RDMNet, pipeline
    from rdmnet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from rdmnet_tpu_torch.ops.kernels.radius_knn import knn_plan
    from rdmnet_tpu_torch.tools.overfit_demo import host_batch
    from rdmnet_tpu_torch.utils.convert import params_from_jax, params_to_jax
    from rdmnet_tpu_torch.utils.torch_convert import export_state_dict, port_key_and_kind

    # ---- the parity config: 9 searches at K 63-81 ---------------------------
    pcfg = make_parity_cfg()
    pcfg = dataclasses.replace(pcfg, pyramid=pcfg.pyramid.scaled(0.7))
    cap = pcfg.pyramid.caps[0]
    args = (*pad_cloud(ref, cap, device=dev), *pad_cloud(src, cap, device=dev))
    model = RDMNet(pcfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    rotate_kernel_points(model, SEED)
    batch = build_pair_batch(*args, torch.eye(4, device=dev), pcfg.pyramid)
    pts, cnts = pair_levels(batch, pcfg.pyramid.num_stages)
    ks = [item.k for item in search_plan(pcfg.pyramid)]
    knn_ms, knn_call_ms, knn_plain_ms, knn_bound, _ = check_searches(pts, cnts, pcfg.pyramid,
                                                                     kernels, prefix="parity ")
    print(f"parity radius_knn per pair (12 searches, K {ks}): kernel {knn_ms:.4f} ms on the "
          f"device, {knn_call_ms:.4f} ms in wrapper calls; plain {knn_plain_ms:.3f} ms, bound "
          f"{knn_bound:.5f} ms; tables equal to the plain version's")
    kernels["radius_knn"].update(parity_ms=knn_ms, parity_bound_ms=knn_bound)
    ms, peak, stage_ms, out = timed_pipeline(model, args, dev, PARITY_WARM, PARITY_TIMED,
                                             PARITY_STAGE, "parity pipeline (make_parity_cfg, "
                                             "0.7 bucket, per-layer kernel points)")
    per_pair = {"radius_knn": 12, "sinkhorn": 1}

    # ---- the 256-entry list at level-0 shapes ----------------------------------
    level0 = search_plan(pcfg.pyramid)[0]
    for k in (81, 256):
        sp = level0._replace(k=k)
        ms_k, call_k, pms_k, bound_k, work, plan = check_knn(pts, cnts, sp, kernels)
        print(knn_line(f"level-0 K={k} band={sp.band}", ms_k, call_k, pms_k, bound_k, plan, None)
              + f"; {work_text(work)}; table equal to the plain version's")
        if plan.k_bucket != (128 if k <= 128 else 256):
            fail(f"radius_knn K={k}: list bucket {plan.k_bucket}")
        kernels["radius_knn"][f"level0_k{k}_ms"] = ms_k

    # ---- converter on the card ---------------------------------------------------
    state = model.state_dict()
    schema = {upstream_key(k): tuple(v.shape) for k, v in state.items()}
    if any(port_key_and_kind(up)[0] != k for up, k in zip(schema, state)):
        fail("converter: the upstream schema does not map back onto the model")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rdmnet.pth.tar")
        torch.save({"model": {k: torch.from_numpy(v) for k, v in
                              export_state_dict(state, schema).items()}, "epoch": 0}, path)
        converted = build_model_and_params(pcfg, device=dev, torch_checkpoint=path)
    carried = RDMNet(pcfg, device=dev, generator=torch.Generator().manual_seed(SEED + 1))
    carried.load_state_dict(params_from_jax(params_to_jax(model)), strict=True)
    tf_a = pipeline(converted, *args, device=dev)["estimated_transform"]
    tf_b = pipeline(carried, *args, device=dev)["estimated_transform"]
    diff = float((tf_a - tf_b).abs().max())
    print(f"converter on the card: {len(schema)} upstream tensors through a .pth.tar, loaded "
          f"strict; pose against the same weights through params_from_jax: max abs diff {diff:.3e}")
    if diff > 1e-6 or not bool(torch.isfinite(tf_a).all()):
        fail(f"converter: the converted checkpoint's pose differs by {diff}")
    del model, converted, carried, batch
    torch.cuda.empty_cache()

    # ---- the other families at full width --------------------------------------
    base = dataclasses.replace(make_cfg(), pyramid=make_cfg().pyramid.scaled(0.7))
    host = host_batch(ref, src, gt, cap)
    tiny = make_tiny_cfg()
    small, _, _ = procedural_pair(SEED + 2, n_rings=16, n_azimuths=200)
    small = small[np.random.RandomState(0).permutation(len(small))[:500]]
    motion = np.eye(4, dtype=np.float32)
    motion[:2, :2] = [[np.cos(0.05), -np.sin(0.05)], [np.sin(0.05), np.cos(0.05)]]
    motion[:3, 3] = [0.5, 0.3, 0.1]
    moved = ((small - motion[:3, 3]) @ motion[:3, :3]).astype(np.float32)
    tcap = tiny.pyramid.caps[0]
    for (name, cfg), (_, tcfg) in zip(family_cfgs(base).items(), family_cfgs(tiny).items()):
        model = RDMNet(cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
        timed_pipeline(model, args, dev, 1, 3, 0, f"{name} pipeline (0.7 bucket)")
        state = create_train_state(cfg, model)
        step = make_train_step(cfg, device=dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(FAMILY_STEPS):
            reset_launch_counts()
            t0 = time.perf_counter()
            state, metrics = step(state, batch_to_device(host, cfg.pyramid, device=dev), gen)
            metrics = {k: float(v) for k, v in metrics.items()}
            step_ms = (time.perf_counter() - t0) * 1e3
            counts = launch_counts()
            if counts != {"radius_knn": 12, "sinkhorn": 0}:
                fail(f"{name} train step {i}: launches {counts}, expected 12 kNN and 0 Sinkhorn")
            if not all(np.isfinite(v) for v in metrics.values()) or metrics["grad_norm"] <= 0:
                fail(f"{name} train step {i}: non-finite losses or gradient: {metrics}")
            print(f"{name} train step {i}: {step_ms:.3f} ms, "
                  + ", ".join(f"{k} {v:.6g}" for k, v in metrics.items()))
        print(f"{name} training: peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
              f"over {FAMILY_STEPS} steps, 12 kNN and 0 Sinkhorn launches per step")
        del model, state, step
        torch.cuda.empty_cache()

        for seed in FAMILY_SEEDS:
            outs = []
            for d in (dev, torch.device("cpu")):
                m = RDMNet(tcfg, device=d, generator=torch.Generator().manual_seed(seed))
                outs.append(pipeline(m, *pad_cloud(small, tcap, device=d),
                                     *pad_cloud(moved, tcap, device=d), device=d))
            o_gpu, o_cpu = outs
            for side in ("ref", "src"):
                g, c = getattr(o_gpu["batch"], side), getattr(o_cpu["batch"], side)
                for field in ("points", "neighbors", "subsampling", "upsampling"):
                    for lvl, (a, b) in enumerate(zip(getattr(g, field), getattr(c, field))):
                        if not torch.equal(a.cpu(), b):
                            fail(f"{name} card vs CPU (weights {seed}): {side} {field}[{lvl}]")
            for key in ("nodes_ref_valid", "nodes_src_valid", "node_corr_valid"):
                if not torch.equal(o_gpu[key].cpu(), o_cpu[key]):
                    fail(f"{name} card vs CPU (weights {seed}): {key} differ")
            err, swapped = aligned_plan_error(o_gpu, o_cpu)
            if err is None or err > 1e-3:
                fail(f"{name} card vs CPU (weights {seed}): matched patches or plans differ ({err})")
            pose = float((o_gpu["estimated_transform"].cpu() - o_cpu["estimated_transform"])
                         .abs().max())
            print(f"{name} card vs CPU (tiny cfg, weights {seed}): tables and node masks equal, "
                  f"matched node pairs equal ({swapped} patches in another order), plans within "
                  f"{err:.3e}; pose {pose:.3e}")
    return per_pair


BF16_WARM, BF16_TIMED, BF16_STAGE = 3, 12, 3  # pairs per dtype of phase 12, timed in turns
BF16_STEPS = 3                                # timed train steps per dtype of phase 12, in turns
BF16_STEP_WARM = 1                            # untimed first steps (bf16 GEMM set-up)
BF16_SEEDS = (1, 2)                           # weight draws of phase 12's card-vs-CPU check
BF16_BOUND = 2.0   # rel(card bf16, CPU bf16) <= 2 rel(CPU bf16, CPU f32), tests/test_torch_port_bf16.py
# phase 13: a raw KITTI-layout sequence, frames ICP_STEP m apart, ~100k points a scan
ICP_SEED, ICP_FRAMES, ICP_STEP = SEED + 20, 7, 4.0
ICP_SCAN = dict(n_rings=64, n_azimuths=1800, voxel_size=0.01)


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rel_dist(a, b) -> float:
    """|a - b| / |b| (Frobenius norms) in float64."""
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).norm() / b.norm())


def bf16_phase(dev, cfg, ref, src, gt):
    """Phase 12: ``compute_dtype="bfloat16"`` beside float32 at ``cfg`` (the
    phase-4 config) on the phase-4 pair, with one set of weights: pipeline
    ms/pair, stages and peak memory timed in turns, train steps in turns,
    and card against CPU at ``make_tiny_cfg()``. Returns the launches per
    bf16 pair by kernel."""
    import numpy as np
    import torch

    from rdmnet_tpu_torch.config import make_tiny_cfg
    from rdmnet_tpu_torch.data.procedural import procedural_pair
    from rdmnet_tpu_torch.engine import (TRAIN_STAGES, batch_to_device, create_train_state,
                                         make_train_step)
    from rdmnet_tpu_torch.graph.pyramid import pad_cloud
    from rdmnet_tpu_torch.models import RDMNet, pipeline
    from rdmnet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from rdmnet_tpu_torch.tools.overfit_demo import host_batch

    cfgs = {"float32": cfg, "bfloat16": dataclasses.replace(cfg, compute_dtype="bfloat16")}
    models = {name: RDMNet(c, device=dev, generator=torch.Generator().manual_seed(SEED))
              for name, c in cfgs.items()}
    models["bfloat16"].load_state_dict(models["float32"].state_dict())
    cap = cfg.pyramid.caps[0]
    args = (*pad_cloud(ref, cap, device=dev), *pad_cloud(src, cap, device=dev))
    per_pair = {"radius_knn": 12, "sinkhorn": 1}

    def run(name, hook=None):
        reset_launch_counts()
        out = pipeline(models[name], *args, device=dev, stage_hook=hook)
        counts = launch_counts()
        if dev.type == "cuda" and counts != per_pair:
            fail(f"{name} pipeline: launches {counts}, expected 12 kNN and 1 Sinkhorn per pair")
        return out

    ms = {name: [] for name in models}
    for i in range(BF16_WARM + BF16_TIMED):
        for name in (("float32", "bfloat16") if i % 2 == 0 else ("bfloat16", "float32")):
            sync(dev)
            t0 = time.perf_counter()
            run(name)
            sync(dev)
            if i >= BF16_WARM:
                ms[name].append((time.perf_counter() - t0) * 1e3)
    stage_ms = {name: {} for name in models}
    for _ in range(BF16_STAGE):
        for name in models:
            marks = []

            def hook(stage):
                sync(dev)
                marks.append((stage, time.perf_counter()))

            sync(dev)
            prev = time.perf_counter()
            run(name, hook)
            for stage, t in marks:
                stage_ms[name][stage] = stage_ms[name].get(stage, 0.0) + (t - prev) * 1e3 / BF16_STAGE
                prev = t
    outs, peak = {}, {}
    for name in models:
        sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        outs[name] = run(name)
        sync(dev)
        peak[name] = torch.cuda.max_memory_allocated(dev) / 2**20 if dev.type == "cuda" else 0.0
    for name in models:
        t = sorted(ms[name])
        print(f"bf16 phase, {name} pipeline (0.7 bucket, the phase-4 pair, timed in turns): "
              f"{sum(t) / len(t):.3f} ms/pair (median {t[len(t) // 2]:.3f}, min {t[0]:.3f}, max "
              f"{t[-1]:.3f}) over {BF16_TIMED} pairs after {BF16_WARM} warm-up; peak memory "
              f"{peak[name]:.1f} MiB; stages "
              + json.dumps({k: round(v, 3) for k, v in stage_ms[name].items()}))
    if dev.type == "cuda":
        # one profiled pair each: kernels launched and their device time
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        for name in models:
            sync(dev)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run(name)
                sync(dev)
                wall = (time.perf_counter() - t0) * 1e3
            events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)]
            device_ms = sum(e.self_device_time_total for e in events) / 1e3
            gemm = sum(e.self_device_time_total for e in events
                       if "gemm" in e.key.lower() or "sm90" in e.key.lower()) / 1e3
            print(f"bf16 phase, {name} profiled pair: {wall:.3f} ms wall, "
                  f"{sum(e.count for e in events)} kernels, {device_ms:.3f} ms on the device "
                  f"({100 * device_ms / wall:.1f}% busy under the profiler), of it {gemm:.3f} ms "
                  "in GEMM kernels")
    o16, o32 = outs["bfloat16"], outs["float32"]
    v = (o16["nodes_ref_valid"] & o32["nodes_ref_valid"]).cpu()
    a, b = o16["ref_feats_c"].cpu()[v], o32["ref_feats_c"].cpu()[v]
    cos = float(torch.median((a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1) + 1e-9)))
    if cos <= 0.98 or not all(bool(torch.isfinite(o["estimated_transform"]).all())
                              for o in (o16, o32)):
        fail(f"bf16 pipeline: median cosine of coarse features to float32 {cos} or a pose "
             "is not finite")
    if {p.dtype for p in models["bfloat16"].parameters()} != {torch.float32}:
        fail("bf16 model: weights are not float32")
    print(f"bf16 phase: coarse features against float32 on the same weights, median cosine "
          f"{cos:.5f} over {int(v.sum())} nodes; launches per pair {per_pair} for both dtypes")
    del models, outs
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- train steps in turns --------------------------------------------------
    host = host_batch(ref, src, gt, cap)
    states = {name: create_train_state(c, RDMNet(c, device=dev,
                                                 generator=torch.Generator().manual_seed(SEED)))
              for name, c in cfgs.items()}
    steps = {name: make_train_step(c, device=dev) for name, c in cfgs.items()}
    gens = {name: torch.Generator(device=dev).manual_seed(SEED) for name in cfgs}
    step_ms = {name: [] for name in cfgs}
    parts = {name: {k: 0.0 for k in TRAIN_STAGES} for name in cfgs}
    tpeak = {name: 0.0 for name in cfgs}
    for i in range(BF16_STEP_WARM + BF16_STEPS):
        for name in (("bfloat16", "float32") if i % 2 == 0 else ("float32", "bfloat16")):
            marks = []

            def hook(stage):
                sync(dev)
                marks.append((stage, time.perf_counter()))

            sync(dev)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            reset_launch_counts()
            t0 = time.perf_counter()
            batch = batch_to_device(host, cfgs[name].pyramid, device=dev)
            hook("build")
            states[name], metrics = steps[name](states[name], batch, gens[name], stage_hook=hook)
            counts = launch_counts()
            metrics = {k: float(val) for k, val in metrics.items()}
            if dev.type == "cuda" and counts != {"radius_knn": 12, "sinkhorn": 0}:
                fail(f"{name} train step {i}: launches {counts}, expected 12 kNN and 0 Sinkhorn")
            if not all(np.isfinite(val) for val in metrics.values()) or metrics["grad_norm"] <= 0:
                fail(f"{name} train step {i}: non-finite losses or zero gradient: {metrics}")
            kind = "warm-up" if i < BF16_STEP_WARM else "timed"
            if kind == "timed":
                step_ms[name].append((marks[-1][1] - t0) * 1e3)
                prev = t0
                for stage, t in marks:
                    parts[name][stage] += (t - prev) * 1e3 / BF16_STEPS
                    prev = t
            if dev.type == "cuda":
                tpeak[name] = max(tpeak[name], torch.cuda.max_memory_allocated(dev) / 2**20)
            print(f"{name} train step {i} ({kind}): {(marks[-1][1] - t0) * 1e3:.3f} ms, "
                  + ", ".join(f"{k} {val:.6g}" for k, val in metrics.items()))
    for name in cfgs:
        if {p.dtype for p in states[name].params} != {torch.float32}:
            fail(f"{name} training: weights are not float32")
        print(f"bf16 phase, {name} training: {sum(step_ms[name]) / BF16_STEPS:.3f} ms/step over "
              f"{BF16_STEPS} steps in turns after {BF16_STEP_WARM} warm-up, peak memory {tpeak[name]:.1f} MiB, float32 weights; "
              "parts " + json.dumps({k: round(val, 3) for k, val in parts[name].items()}))
    del states, steps
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- card against CPU at the tiny config -----------------------------------
    tiny = make_tiny_cfg()
    small, _, _ = procedural_pair(SEED + 2, n_rings=16, n_azimuths=200)
    small = small[np.random.RandomState(0).permutation(len(small))[:500]]
    moved = (small + np.array([0.5, 0.3, 0.1], np.float32)).astype(np.float32)
    tcap = tiny.pyramid.caps[0]
    cpu = torch.device("cpu")
    for seed in BF16_SEEDS:
        o = {}
        for d, dt in ((dev, "bfloat16"), (cpu, "bfloat16"), (cpu, "float32")):
            m = RDMNet(dataclasses.replace(tiny, compute_dtype=dt), device=d,
                       generator=torch.Generator().manual_seed(seed))
            o[d.type, dt] = pipeline(m, *pad_cloud(small, tcap, device=d),
                                     *pad_cloud(moved, tcap, device=d), device=d)
        card, host16, host32 = o[dev.type, "bfloat16"], o["cpu", "bfloat16"], o["cpu", "float32"]
        for side in ("ref", "src"):
            g, c = getattr(card["batch"], side), getattr(host16["batch"], side)
            for field in ("points", "neighbors", "subsampling", "upsampling"):
                for lvl, (x, y) in enumerate(zip(getattr(g, field), getattr(c, field))):
                    if not torch.equal(x.cpu(), y):
                        fail(f"bf16 card vs CPU (weights {seed}): {side} {field}[{lvl}] differ")
        vn = (host16["nodes_ref_valid"] & host32["nodes_ref_valid"]).cpu()
        report = []
        for key in ("ref_feats_c", "src_feats_c", "ref_feats_f", "src_feats_f"):
            sel = vn if key == "ref_feats_c" else slice(None)
            if key == "src_feats_c":
                sel = (host16["nodes_src_valid"] & host32["nodes_src_valid"]).cpu()
            gap = rel_dist(card[key].cpu()[sel], host16[key][sel])
            yard = rel_dist(host16[key][sel], host32[key][sel])
            report.append(f"{key} {gap:.3e} (bound {BF16_BOUND} x {yard:.3e})")
            if not gap <= BF16_BOUND * yard:
                fail(f"bf16 card vs CPU (weights {seed}): {key} {gap} > {BF16_BOUND} x {yard}")
        print(f"bf16 card vs CPU (tiny cfg, weights {seed}): tables equal; card bf16 from CPU "
              "bf16: " + ", ".join(report))
    return per_pair


def write_raw_kitti(root, seed, n_frames, step, **scan_kwargs):
    """A raw KITTI odometry sequence 00 under ``root``: ``velodyne/*.bin``
    xyzi scans of one procedural scene, frames ``step`` m apart,
    ``poses/00.txt`` camera poses and a ``calib.txt`` with a non-identity
    ``Tr``. Returns the velodyne poses (sensor to world)."""
    import numpy as np

    from rdmnet_tpu_torch.data.procedural import lidar_scan, make_scene, trajectory
    from rdmnet_tpu_torch.utils.se3_np import euler_zyx_matrix

    rng = np.random.RandomState(seed)
    scene = make_scene(rng, corridor_length=max(60.0, n_frames * step + 30.0))
    poses = trajectory(rng, n_frames, step=step)
    velo2cam = np.eye(4)
    velo2cam[:3, :3] = euler_zyx_matrix(-1.57, 0.01, -1.56)
    velo2cam[:3, 3] = [-0.004, -0.076, -0.272]
    seq_dir = os.path.join(root, "sequences", "00")
    os.makedirs(os.path.join(seq_dir, "velodyne"))
    os.makedirs(os.path.join(root, "poses"))
    for k in range(n_frames):
        scan = lidar_scan(scene, poses[k], rng, **scan_kwargs)
        scan.astype(np.float32).tofile(os.path.join(seq_dir, "velodyne", f"{k:06d}.bin"))
    cam = np.stack([(p @ np.linalg.inv(velo2cam))[:3].reshape(-1) for p in poses])
    np.savetxt(os.path.join(root, "poses", "00.txt"), cam)
    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        f.write("Tr: " + " ".join(repr(float(v)) for v in velo2cam[:3].reshape(-1)) + "\n")
    return poses


def icp_search_check(dev, kernels, cur, ref32, radius, extent):
    """Phase 13: the first ICP iteration's search (``cur`` the float64 moved
    points, ``ref32`` the reference cloud): the kernel's launch (K =
    ``ICP_CANDIDATES`` within the widened radius) against its plain version
    on every query, timed beside its bound; then, against the native
    library on every query, the rows where the kernel's own nearest (its
    first column, the graph build's rounding) and ``nearest_within`` (that
    table re-ranked on exact distances) part from it."""
    import torch

    from rdmnet_tpu_torch.data.preprocess import (ICP_CANDIDATES, candidate_radius,
                                                  nearest_within)
    from rdmnet_tpu_torch.graph.native import radius_knn_native
    from rdmnet_tpu_torch.graph.pyramid import SearchSpec
    from rdmnet_tpu_torch.ops.radius_search import radius_knn

    q = cur.to(torch.float32)[None].contiguous()
    s = ref32[None].contiguous()
    nq, ns = q.shape[1], s.shape[1]
    counts = [torch.tensor([nq], dtype=torch.int32, device=dev),
              torch.tensor([ns], dtype=torch.int32, device=dev)]
    wide = candidate_radius(radius, extent)
    spec = SearchSpec("icp", 0, 1, wide, ICP_CANDIDATES, None, 0, 0.0)
    if dev.type == "cuda":
        ms_k, call_k, pms_k, bound_k, _, plan = check_knn([q, s], counts, spec, kernels)
        print(knn_line(f"ICP search (first iteration of the first pair, {nq} queries x {ns} "
                       f"rows, K={ICP_CANDIDATES} within {wide:.5f} m, unbanded)", ms_k, call_k,
                       pms_k, bound_k, plan, None)
              + "; table equal to the plain version's on every query")
        kernels["radius_knn"].update(icp_search_ms=ms_k, icp_search_bound_ms=bound_k,
                                     icp_search_plain_ms=pms_k)
    first_col = radius_knn(q[0], s[0], counts[1][0], radius, 1)[:, 0].cpu().long()
    got = nearest_within(cur, ref32, radius, extent).cpu()
    qh = q[0].cpu()
    native = torch.from_numpy(radius_knn_native(qh.numpy(), ref32.cpu().numpy(), ns, radius,
                                                1)[:, 0]).long()
    sh = ref32.cpu().double()

    def parted(idx):
        differ = idx != native
        both = differ & (idx < ns) & (native < ns)
        d2 = lambda i: ((qh[both].double() - sh[i[both]]) ** 2).sum(1)  # noqa: E731
        a, b = d2(idx), d2(native)
        farther = int((a > b * (1 + 1e-6) + 1e-12).sum())
        nearer = int((b > a * (1 + 1e-6) + 1e-12).sum())
        return (int(differ.sum()), farther, nearer, int(both.sum()) - farther - nearer,
                int((differ & ~both).sum()))

    for name, idx in (("the kernel's K=1 search (graph-build distances)", first_col),
                      ("nearest_within (re-ranked on exact distances)", got)):
        n, farther, nearer, ties, edge = parted(idx)
        print(f"data prep: first ICP search, {name} against the native library on all {nq} "
              f"queries: {n} rows differ ({farther} pick a farther point, {nearer} a nearer "
              f"one, {ties} one as near within 1e-6, {edge} at the radius boundary: one side "
              "finds none)")
    n, farther, _, _, _ = parted(got)
    if farther:
        fail(f"data prep: nearest_within picks a farther point than the native search in "
             f"{farther} rows")


def data_prep_phase(dev, kernels, frames=ICP_FRAMES, scan_kwargs=ICP_SCAN):
    """Phase 13: ``rdmnet-torch-preprocess`` downsample -> pairs -> calibrate
    on a raw KITTI-layout sequence written into a temporary directory, on
    ``dev`` and again with ``--device cpu``. Returns the radius-kNN launches
    per ICP iteration."""
    import numpy as np
    import torch

    from rdmnet_tpu_torch.cli import preprocess as cli
    from rdmnet_tpu_torch.config import make_cfg
    from rdmnet_tpu_torch.data import calibration, preprocess
    from rdmnet_tpu_torch.data.datasets import RegistrationPairDataset
    from rdmnet_tpu_torch.ops.grid_subsample import grid_subsample
    from rdmnet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "kitti")
        t0 = time.perf_counter()
        write_raw_kitti(root, ICP_SEED, frames, ICP_STEP, **scan_kwargs)
        sizes = [os.path.getsize(os.path.join(root, "sequences", "00", "velodyne", f"{k:06d}.bin"))
                 // 16 for k in range(frames)]
        print(f"data prep: raw KITTI sequence 00 of {frames} frames {ICP_STEP} m apart, "
              f"{min(sizes)}-{max(sizes)} points a scan ({scan_kwargs}), non-identity Tr; "
              f"written in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            done = cli.main(["downsample", "--root", root, "--seqs", "0"])
        down = [len(np.load(os.path.join(root, "downsampled_xyzi", "00", f"{k:06d}.npy")))
                for k in range(frames)]
        print(f"data prep: downsample {done} scans in {time.perf_counter() - t0:.3f} s (host), "
              f"{min(down)}-{max(down)} points a scan at 0.3 m")

        # ---- pairs: ICP on dev, then on the CPU ----------------------------------
        search, icp = preprocess.nearest_within, preprocess.icp_point_to_point
        first, calls, per_icp = [], [], []

        def counted_search(cur, ref, radius, extent):
            if not first:
                first.append((cur.clone(), ref.clone(), radius, extent))
            calls.append(1)
            return search(cur, ref, radius, extent)

        def timed_icp(*a, **kw):
            n0 = len(calls)
            reset_launch_counts()
            sync(dev)
            t = time.perf_counter()
            out = icp(*a, **kw)
            sync(dev)
            per_icp.append(((time.perf_counter() - t) * 1e3, len(calls) - n0,
                            launch_counts()["radius_knn"], torch.device(kw["device"]).type))
            return out

        preprocess.nearest_within, preprocess.icp_point_to_point = counted_search, timed_icp
        lines = {}
        try:
            for d in (dev.type, "cpu"):
                out_root = root if d == dev.type else os.path.join(tmp, "cpu")
                with contextlib.redirect_stdout(io.StringIO()):
                    cli.main(["pairs", "--root", root, "--seqs", "0", "--out_root", out_root,
                              "--device", d])
                with open(os.path.join(out_root, "icp10", "00")) as f:
                    lines[d] = f.read().splitlines()
        finally:
            preprocess.nearest_within, preprocess.icp_point_to_point = search, icp
        on_dev = [r for r in per_icp if r[3] == dev.type]
        on_cpu = [r for r in per_icp if r[3] == "cpu"]
        if not lines[dev.type] or len(lines[dev.type]) != len(lines["cpu"]):
            fail(f"data prep: pairs {lines}")
        tf_err = 0.0
        for a, b in zip(lines[dev.type], lines["cpu"]):
            a, b = a.split(), b.split()
            if a[:2] != b[:2]:
                fail(f"data prep: pair {a[:2]} on {dev.type} against {b[:2]} on the CPU")
            tf_err = max(tf_err, float(np.abs(np.float64(a[2:]) - np.float64(b[2:])).max()))
        if tf_err > 1e-4:
            fail(f"data prep: ground truth on {dev.type} and the CPU differ by {tf_err} > 1e-4")
        for ms_, iters, launches, _ in on_dev:
            if dev.type == "cuda" and launches != iters:
                fail(f"data prep: {launches} kNN launches in an ICP of {iters} iterations")
        print(f"data prep: pairs {[' '.join(x.split()[:2]) for x in lines[dev.type]]}, ground "
              f"truth on {dev.type} against the CPU within {tf_err:.3e}; ICP per pair on "
              f"{dev.type}: " + ", ".join(f"{r[0]:.3f} ms ({r[1]} iterations, {r[2]} kNN "
                                          "launches)" for r in on_dev)
              + "; on the CPU (native search): " + ", ".join(f"{r[0]:.3f} ms" for r in on_cpu))

        # ---- the first ICP iteration's search against plain and native ------------
        if dev.type == "cuda" and not first:
            fail("data prep: the ICP on the card never reached the kNN kernel's search")
        for args in first[:1]:
            icp_search_check(dev, kernels, *args)

        # ---- calibrate on dev and on the CPU ---------------------------------------
        gt_dir = os.path.join(root, "icp10")
        for seq in range(1, 6):  # the other train sequences of the KITTI schema, empty
            open(os.path.join(gt_dir, f"{seq:02d}"), "a").close()
        cal, secs = {}, {}
        for d in (dev.type, "cpu"):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as printed:
                cal[d] = cli.main(["calibrate", "--root", root, "--device", d])
            secs[d] = time.perf_counter() - t0
            print(f"data prep: calibrate on {d} in {secs[d]:.3f} s over {cal[d]['clouds']} "
                  f"clouds: " + " | ".join(printed.getvalue().splitlines()))
        if cal[dev.type] != cal["cpu"]:
            fail(f"data prep: calibration on {dev.type} {cal[dev.type]} != CPU {cal['cpu']}")
        cfg = make_cfg()
        cloud = RegistrationPairDataset("kitti", root, "train",
                                        point_limit=cfg.train.point_limit)[0]["ref_points"]
        per_level = {}
        for d in (dev, torch.device("cpu")):
            spec_p = cfg.pyramid
            pts = np.full((1, spec_p.caps[0], 3), 1e9, np.float32)
            n = min(len(cloud), spec_p.caps[0])
            pts[0, :n] = cloud[:n]
            p = torch.from_numpy(pts).to(d)
            c = torch.tensor([n], dtype=torch.int32, device=d)
            voxel, radius_c = spec_p.voxel_size, spec_p.search_radius
            per_level[d.type] = []
            for lvl in range(spec_p.num_stages):
                if lvl > 0:
                    voxel *= 2
                    p, c, _ = grid_subsample(p, c, voxel, spec_p.caps[lvl])
                per_level[d.type].append(calibration._neighbor_counts(p[0], int(c[0]), radius_c))
                radius_c *= 2
        diffs = [int((a != b).sum()) if a.shape == b.shape else -1
                 for a, b in zip(per_level[dev.type], per_level["cpu"])]
        print(f"data prep: neighbour counts of the first calibration cloud, {dev.type} against "
              f"the CPU, per level: {[len(a) for a in per_level['cpu']]} points, {diffs} differ; "
              f"limits and band caps equal; calibrate {secs[dev.type]:.3f} s on {dev.type}, "
              f"{secs['cpu']:.3f} s on the CPU")
        if any(x != 0 for x in diffs):
            fail(f"data prep: neighbour counts differ between {dev.type} and the CPU: {diffs}")
        iters = sum(r[1] for r in on_dev)
        return {"radius_knn": sum(r[2] for r in on_dev) / max(iters, 1), "sinkhorn": 0.0}


DP_WORLD = 2                 # ranks of phase 14
DP_WARM, DP_TIMED = 1, 3     # train steps of phase 14 (a), per rank and for the one process
SP_MIN_QUERIES = 2048        # phase 14 (b): query levels of at least this many rows shard
DP_EPOCHS = 4                # phase 14 (c): epochs of the resumed trainval run (1 before it)
DP_PROGRAM_STEPS, DP_PROGRAM_NAN = 7, 4  # phase 14 (d): dp train steps; rank 1's NaN step
DP_ACC_STEPS, DP_ACC_NAN = 6, 3          # (d) at grad_acc_steps 2: three groups, the second NaN
DP_PROGRAM_TURNS = 4         # phase 14 (d): timed turns of a replayed and an eager dp step
DP_WATCHDOG_PROBES = 10      # phase 14 (e), NCCL: captures with the watchdog's work pending


def _sha1(tensors) -> str:
    import hashlib

    import torch

    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().reshape(-1).cpu().numpy().tobytes())
    return h.hexdigest()


def profiled_halves(program, host, dev):
    """One call of a ``SplitProgram`` with each half's replay under a
    profiler of its own (the exchange between them unprofiled): the
    launches of the port's kernels in each half's replay."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    profs = [profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])]
    between = program.between

    def split(mid):
        torch.cuda.synchronize(dev)
        profs[0].__exit__(None, None, None)
        between(mid)
        torch.cuda.synchronize(dev)
        profs.append(profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        profs[1].__enter__()

    program.between = split
    try:
        torch.cuda.synchronize(dev)
        profs[0].__enter__()
        out = program(host)
        torch.cuda.synchronize(dev)
        profs[1].__exit__(None, None, None)
    finally:
        program.between = between
    seen = [{name: sum(e.count for e in p.key_averages() if e.device_type == DeviceType.CUDA
                       and key in e.key) for name, key in PROFILED_KERNELS.items()}
            for p in profs]
    return seen, out


def _dp_programs(rank, dev, cfg, group, spec):
    """Phase 14 (d) on one rank: the dp train program against an eager dp
    twin over ``DP_PROGRAM_STEPS`` steps (rank 1's ground truth NaN at
    ``DP_PROGRAM_NAN``) and at grad_acc_steps 2, the eval program against the
    eager eval step, the launches at each capture and in profiled replays,
    and replayed against eager dp steps in turns. Fails on a mismatch;
    returns its findings."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from rdmnet_tpu_torch.engine import batch_to_device, capture_eval_step, make_eval_step

    pairs = moved_pairs(spec["ref"], spec["src"], spec["gt"], cfg.pyramid.caps[0],
                        DP_PROGRAM_STEPS, SEED + 140 + rank)
    where = f"dp train program, rank {rank}"

    def with_nan(batches, at):
        batches = list(batches)
        if rank == 1:
            batches[at] = {k: v.copy() for k, v in batches[at].items()}
            batches[at]["transform"][0, 0, 3] = np.nan
        return batches

    out = {"trace": [], "acc_trace": []}
    acc_cfg = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, grad_acc_steps=2))
    acc_program, acc_state, _, _, _ = twin_run(
        dev, acc_cfg, with_nan(pairs[:DP_ACC_STEPS], DP_ACC_NAN), DP_ACC_NAN,
        f"{where}, grad_acc_steps 2", group=group, gen_seed=SEED + 29 + 1000 * rank,
        trace=out["acc_trace"])
    out["acc_counters"] = (acc_state.count, acc_state.mini_step, acc_state.notfinite_count)
    del acc_program, acc_state
    torch.cuda.empty_cache()
    program, p_state, e_state, e_step, gens = twin_run(
        dev, cfg, with_nan(pairs, DP_PROGRAM_NAN), DP_PROGRAM_NAN, where, group=group,
        gen_seed=SEED + 19 + 1000 * rank, trace=out["trace"])

    # the eval program under the group against the eager eval step
    e_program = capture_eval_step(e_state, cfg, 2, dev)
    e_eval = make_eval_step(cfg, dev)
    for i, valid in enumerate(EVAL_PROGRAM_VALID):
        host = {k: np.concatenate([pairs[(2 * i) % len(pairs)][k],
                                   pairs[(2 * i + 1) % len(pairs)][k]]) for k in pairs[0]}
        got, got_tf = e_program(host, np.array(valid))
        want, want_tf = e_eval(e_state, batch_to_device(host, cfg.pyramid, dev),
                               torch.tensor(valid))
        held_bitwise(got, want, f"dp eval program, rank {rank}: batch {i} metrics")
        held_bitwise({"transforms": got_tf}, {"transforms": want_tf},
                     f"dp eval program, rank {rank}: batch {i}")

    # launches at the captures and in profiled replays; the twin takes the same steps
    out.update(train_launches=program.launches, half_launches=program.half_launches,
               eval_launches=e_program.launches)
    _, _, seen, _ = profiled_kernels(lambda: e_program(
        {k: np.concatenate([pairs[0][k], pairs[1][k]]) for k in pairs[0]}), dev)
    out["eval_seen"] = seen
    out["half_seen"], _ = profiled_halves(program, pairs[0], dev)
    e_step(e_state, batch_to_device(pairs[0], cfg.pyramid, dev), gens[1])
    wall, kernel, seen, _ = profiled_kernels(lambda: program(pairs[1]), dev)
    e_step(e_state, batch_to_device(pairs[1], cfg.pyramid, dev), gens[1])
    out.update(train_seen=seen, busy=(wall, kernel))
    held_bitwise(state_bits(p_state), state_bits(e_state), f"{where}: after the profiled steps")

    # replayed against eager dp steps in turns, the ranks meeting before each
    ms = {"replay": [], "eager": []}
    peaks = {}
    for turn in range(DP_PROGRAM_TURNS):
        host = pairs[turn % len(pairs)]
        for kind in (("replay", "eager") if turn % 2 == 0 else ("eager", "replay")):
            torch.cuda.synchronize(dev)
            dist.barrier(group=group)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            if kind == "replay":
                got = program(host)
            else:
                _, want = e_step(e_state, batch_to_device(host, cfg.pyramid, dev), gens[1])
            torch.cuda.synchronize(dev)
            ms[kind].append((time.perf_counter() - t0) * 1e3)
            peaks[kind] = max(peaks.get(kind, 0), torch.cuda.max_memory_allocated(dev))
        held_bitwise(got, want, f"{where}: timed turn {turn}")
    held_bitwise(state_bits(p_state), state_bits(e_state), f"{where}: after the timed turns")
    out.update(ms=ms, peaks=peaks, state_sha1=_sha1(state_bits(p_state)[k] for k in
                                                     ("weights", "exp_avg", "exp_avg_sq")),
               capture=(program.capture_s, program.memory_bytes, program.reserved_bytes),
               eval_capture=(e_program.capture_s, e_program.memory_bytes,
                             e_program.reserved_bytes))
    del program, e_program, p_state, e_state
    torch.cuda.empty_cache()
    return out


def _captures_beside_watchdog(dev, group):
    """Phase 14 (e), NCCL only: ``DP_WATCHDOG_PROBES`` graphs, each recorded
    in the default "global" capture mode, which every program of the port
    uses, right after an all-reduce the NCCL watchdog has not yet retired,
    and held open 0.3 s, so its thread queries the work's event while the
    capture runs. Returns how many captured and replayed right."""
    import torch
    import torch.distributed as dist

    flag = torch.ones(1024, device=dev)
    x = torch.zeros(1024, device=dev)
    side = torch.cuda.Stream(dev)
    ok = 0
    for _ in range(DP_WATCHDOG_PROBES):
        dist.all_reduce(flag, group=group)  # NCCL: enqueued, left to the watchdog
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            y = x + flag
            time.sleep(0.3)
        graph.replay()
        sync(dev)
        ok += bool((y == flag).all())
    return ok


def _dp_rank(rank, world, backend, store, spec):
    """One rank of phase 14 (a spawned process): (a) the dp train step, an
    eval step and timed steps, (b) the sp-sharded build, (d) the dp programs
    against eager dp twins, (e) on NCCL, captures beside the watchdog, (c)
    ``trainval --dp`` for an epoch and a resumed run, on the programs and
    kept eager. Its findings go to ``<out>/rank<r>.pt``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import rdmnet_tpu_torch.engine.trainer as trainer_mod
    import rdmnet_tpu_torch.ops.radius_search as search_mod
    from rdmnet_tpu_torch.cli import trainval
    from rdmnet_tpu_torch.engine import (batch_to_device, create_train_state, make_eval_step,
                                         make_train_step, make_value_and_grad)
    from rdmnet_tpu_torch.graph.pyramid import build_pair_batch
    from rdmnet_tpu_torch.models import RDMNet
    from rdmnet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from rdmnet_tpu_torch.ops.kernels.radius_knn import radius_knn_plain
    from rdmnet_tpu_torch.parallel import initialize_distributed, replicate

    torch.set_num_threads(2)
    on_card = spec["device_type"] == "cuda"
    if on_card and backend == "gloo":
        torch.cuda.set_device(0)  # one card: both ranks on it, asked for explicitly
    initialize_distributed(backend=backend, init_method=f"file://{store}", world_size=world,
                           rank=rank, local_rank=rank)
    dev = torch.device("cuda", torch.cuda.current_device()) if on_card else torch.device("cpu")
    group = dist.group.WORLD
    cfg = spec["cfg"]
    res = {"rank": rank, "device": str(dev)}
    try:
        # ---- (a) the dp train step against the one-process two-pair step
        model = RDMNet(cfg, device=dev, generator=torch.Generator().manual_seed(1000 + rank))
        if rank == 0:
            model.load_state_dict(torch.load(spec["weights"], weights_only=True), strict=True)
        replicate(model, group)
        res["replicated"] = _sha1(model.state_dict().values())
        state = create_train_state(cfg, model, steps_per_epoch=10, dp_size=world)
        gen = torch.Generator(device=dev)
        gen.set_state(spec["gen_states"][rank])
        reset_launch_counts()
        batch = batch_to_device(spec["pairs"][rank], cfg.pyramid, dev)
        metrics, grads = make_value_and_grad(cfg, dev, group)(state, batch, gen)
        sync(dev)
        res["step_launches"] = launch_counts()
        res["metrics"] = {k: float(v) for k, v in metrics.items()}
        res["grad_sha1"] = _sha1(grads)
        if rank == 0:
            torch.save(torch.cat([g.reshape(-1) for g in grads]).cpu(), spec["grads_out"])
        state.apply_gradients(grads)
        res["params_sha1"] = _sha1(state.params)
        # an eval step: its Sinkhorn launch against the plain version
        ot, seen = state.model.optimal_transport, []
        hook = ot.register_forward_hook(
            lambda mod, args, kwargs, out: seen.append((args, kwargs, out)), with_kwargs=True)
        reset_launch_counts()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            make_eval_step(cfg, dev)(state, batch)
            hook.remove()
            sync(dev)
            res["eval_launches"] = launch_counts()
            res["sinkhorn_err"] = sinkhorn_against_plain(ot, *seen[0], f"dp rank {rank}",
                                                         "its eval step's")
        res["sinkhorn_line"] = out.getvalue().strip()
        # timed steps, every rank in lockstep
        step = make_train_step(cfg, dev, group)
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        ms = []
        for i in range(DP_WARM + DP_TIMED):
            sync(dev)
            t0 = time.perf_counter()
            state, _ = step(state, batch_to_device(spec["pairs"][rank], cfg.pyramid, dev), gen)
            sync(dev)
            if i >= DP_WARM:
                ms.append((time.perf_counter() - t0) * 1e3)
        res["step_ms"] = ms
        res["peak"] = torch.cuda.max_memory_allocated(dev) if on_card else 0
        res["params_after_timed_sha1"] = _sha1(state.params)
        del state, model, batch, grads

        # ---- (b) the sp-sharded build against the unsharded one
        rp, rc, sp, sc = (torch.as_tensor(x, device=dev) for x in spec["padded"])
        eye = torch.eye(4, device=dev)
        calls = []
        batched = search_mod.radius_knn_batched

        def record(q, s, cnt, radius, k, **kw):
            out = batched(q, s, cnt, radius, k, **kw)
            calls.append((q, s, cnt, radius, k, kw, out))
            return out

        search_mod.radius_knn_batched = record
        try:
            reset_launch_counts()
            got = build_pair_batch(rp, rc, sp, sc, eye, cfg.pyramid, sp_group=group,
                                   sp_min_queries=SP_MIN_QUERIES)
            sync(dev)
            res["sp_launches"] = launch_counts()
        finally:
            search_mod.radius_knn_batched = batched
        want = build_pair_batch(rp, rc, sp, sc, eye, cfg.pyramid)
        res["sp_equal"] = all(
            torch.equal(a, b) for side in ("ref", "src")
            for field in ("points", "counts", "neighbors", "subsampling", "upsampling")
            for a, b in zip(getattr(getattr(got, side), field), getattr(getattr(want, side), field))
        ) and torch.equal(got.ref.dropped, want.ref.dropped) \
            and torch.equal(got.src.dropped, want.src.dropped)
        res["sp_plain_equal"] = all(
            torch.equal(out, radius_knn_plain(q, s, cnt, radius, k, kw.get("win"),
                                              kw.get("chunk", 0), kw.get("band", 0)))
            for q, s, cnt, radius, k, kw, out in calls)
        res["sp_shards"] = sorted({(tuple(c[0].shape), tuple(c[1].shape)) for c in calls})
        del calls
        build_ms = {"sharded": [], "whole": []}
        for turn in ("sharded", "whole", "whole", "sharded") * 2:
            sync(dev)
            dist.barrier(group=group)
            t0 = time.perf_counter()
            build_pair_batch(rp, rc, sp, sc, eye, cfg.pyramid,
                             sp_group=group if turn == "sharded" else None,
                             sp_min_queries=SP_MIN_QUERIES)
            sync(dev)
            build_ms[turn].append((time.perf_counter() - t0) * 1e3)
        res["build_ms"] = build_ms

        # ---- (d) the dp programs against eager dp twins
        res["programs"] = _dp_programs(rank, dev, cfg, group, spec)
        # ---- (e) global-mode captures beside the NCCL watchdog
        res["watchdog_probes"] = (_captures_beside_watchdog(dev, group)
                                  if on_card and backend == "nccl" else None)

        # ---- (c) trainval --dp on phase 10's root, an epoch and a resumed run to
        # DP_EPOCHS, on the programs and with the Trainer kept eager
        class Recorded(trainer_mod.SummaryBoard):
            rows = []

            def update_from_dict(self, d):
                Recorded.rows.append(dict(d))
                super().update_from_dict(d)

        init = trainer_mod.Trainer.__init__

        def eager_init(self, *args, **kwargs):
            init(self, *args, **kwargs)
            self.use_programs = False

        runs = {}
        orig_board = trainer_mod.SummaryBoard
        trainer_mod.SummaryBoard = Recorded
        try:
            for kind, run_dir in (("programs", spec["run"]), ("eager", spec["run"] + "_eager")):
                argv = ["--root", spec["root"], "--output_dir", run_dir, "--bucket_scale",
                        "0.7", "--log_steps", "2", "--keep_snapshots", "1", "--dp", str(world),
                        "--device", dev.type, *spec["cli_args"]]
                Recorded.rows = []
                runs[kind] = {"runs": []}
                if kind == "eager":
                    trainer_mod.Trainer.__init__ = eager_init
                with contextlib.redirect_stdout(io.StringIO()):
                    for extra in (["--max_epoch", "1"],
                                  ["--max_epoch", str(DP_EPOCHS), "--resume"]):
                        t0 = time.perf_counter()
                        trainer = trainval.main(argv + extra)
                        programs = (trainer.train_program, trainer.eval_program)
                        runs[kind]["runs"].append(dict(
                            seconds=time.perf_counter() - t0,
                            params_sha1=_sha1(trainer.state.params), epoch=trainer.epoch,
                            count=trainer.state.count, epochs=trainer.epoch_timings,
                            vals=trainer.val_timings, programs=trainer.use_programs,
                            launches=[None if p is None or p.graph is None else p.launches
                                      for p in programs]))
                        del trainer, programs
                        if on_card:
                            torch.cuda.empty_cache()
                trainer_mod.Trainer.__init__ = init
                runs[kind]["rows"] = list(Recorded.rows)
        finally:
            trainer_mod.SummaryBoard = orig_board
            trainer_mod.Trainer.__init__ = init
        res["runs"] = runs
        torch.save(res, os.path.join(spec["out"], f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def dp_phase(dev, card, kernels, cfg, ref, src, gt, root, cli_args=()):
    """Phase 14: data parallelism on the card, world 2 (NCCL with a card per
    rank where there are two, else gloo with both ranks on card 0): the dp
    train step against the one-process two-pair step, the sp-sharded build,
    the dp programs against eager dp twins, ``trainval --dp 2`` on ``root``
    (phase 10's) on the programs and kept eager, and its validation against
    one process. Returns the launches per rank and pair by kernel. On the CPU
    (gloo, ``cli_args=["--cfg_preset", "tiny"]`` with the tiny config, CPU
    stand-ins for the programs) it rehearses the phase; only its launch
    checks fail there."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from rdmnet_tpu_torch.config import Config, config_from_dict
    from rdmnet_tpu_torch.data.datasets import RegistrationPairDataset
    from rdmnet_tpu_torch.data.loader import PairLoader
    from rdmnet_tpu_torch.engine import (Trainer, batch_to_device, create_train_state,
                                         make_train_step, make_value_and_grad)
    from rdmnet_tpu_torch.engine.checkpoint import CheckpointManager
    from rdmnet_tpu_torch.graph.pyramid import pad_cloud
    from rdmnet_tpu_torch.models import RDMNet
    from rdmnet_tpu_torch.tools.overfit_demo import host_batch

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = "nccl" if n_cards >= DP_WORLD else "gloo"
    print(f"dp phase: backend {backend}, {n_cards} card(s), world {DP_WORLD}"
          + ("" if n_cards >= DP_WORLD else
             " (both ranks on card 0: placement and collectives, not a scaling figure)")
          + f" ({card})")
    cap = cfg.pyramid.caps[0]
    # the second pair: the phase-4 pair's src moved by a seeded rigid motion
    rng = np.random.RandomState(SEED + 14)
    a = rng.uniform(-0.3, 0.3)
    motion = np.eye(4)
    motion[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    motion[:3, 3] = rng.uniform(-2, 2, 3)
    src2 = (src @ motion[:3, :3].T + motion[:3, 3]).astype(np.float32)
    pairs = [host_batch(ref, src, gt, cap), host_batch(ref, src2, gt @ np.linalg.inv(motion), cap)]
    both = {k: np.concatenate([p[k] for p in pairs]) for k in pairs[0]}

    with tempfile.TemporaryDirectory() as tmp:
        model = RDMNet(cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
        weights = os.path.join(tmp, "weights.pt")
        torch.save({k: v.cpu() for k, v in model.state_dict().items()}, weights)
        # the one-process two-pair step, twice: the card's own distance
        state = create_train_state(cfg, model, steps_per_epoch=10, dp_size=DP_WORLD)
        vag = make_value_and_grad(cfg, dev)
        gen = torch.Generator(device=dev)
        runs, gen_states = [], []

        def mark(stage):  # the generator's state after each pair: rank r starts at pair r's
            if stage == "backward":
                gen_states.append(gen.get_state())

        for _ in range(2):
            gen.manual_seed(cfg.seed + 1)
            gen_states[:] = [gen.get_state()]
            m, g = vag(state, batch_to_device(both, cfg.pyramid, dev), gen, stage_hook=mark)
            runs.append(({k: float(v) for k, v in m.items()},
                         torch.cat([x.reshape(-1) for x in g])))
            del g
        step = make_train_step(cfg, dev)
        sync(dev)
        if n_cards:
            torch.cuda.reset_peak_memory_stats()
        one_ms = []
        for i in range(DP_WARM + DP_TIMED):
            sync(dev)
            t0 = time.perf_counter()
            state, _ = step(state, batch_to_device(both, cfg.pyramid, dev), gen)
            sync(dev)
            if i >= DP_WARM:
                one_ms.append((time.perf_counter() - t0) * 1e3)
        one_peak = torch.cuda.max_memory_allocated() if n_cards else 0
        del state, model, step, vag
        if n_cards:
            torch.cuda.empty_cache()

        padded = [x.numpy() for x in (*pad_cloud(ref, cap), *pad_cloud(src, cap))]
        spec = dict(cfg=cfg, weights=weights, pairs=pairs, gen_states=gen_states[:DP_WORLD],
                    grads_out=os.path.join(tmp, "grads.pt"), padded=padded, root=root,
                    run=os.path.join(tmp, "run"), out=tmp, device_type=dev.type,
                    cli_args=list(cli_args), ref=ref, src=src, gt=gt)
        t0 = time.perf_counter()
        ctx = mp.start_processes(_dp_rank, args=(DP_WORLD, backend, os.path.join(tmp, "store"),
                                                 spec), nprocs=DP_WORLD, join=False,
                                 start_method="spawn")
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > 600:
                    fail("dp phase: the ranks ran past 600 s")
        except Exception as e:  # a rank's failure, with its traceback
            fail(f"dp phase: a rank failed: {e}")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        ranks_s = time.perf_counter() - t0
        res = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
               for r in range(DP_WORLD)]
        dp_grads = torch.load(spec["grads_out"], weights_only=True)

        # ---- (a)
        (m1, g1), (m2, g2) = runs
        norm = float(g1.norm())
        run_dist = float((g1 - g2).abs().max())
        err = float((dp_grads - g1.cpu()).abs().max())
        bound = max(2 * run_dist, 1e-6 * norm)
        print(f"dp step: ranks on {[r['device'] for r in res]}; gradients max abs diff to the "
              f"one-process two-pair step {err:.3e} (two one-process runs {run_dist:.3e}, "
              f"bound {bound:.3e}, global norm {norm:.6g})")
        if err > bound:
            fail(f"dp step: gradients {err} from the one-process step, bound {bound}")
        for name, want in m1.items():
            lb = max(2 * abs(m1[name] - m2[name]), 1e-6 * abs(want))
            for r in res:
                if abs(r["metrics"][name] - want) > lb:
                    fail(f"dp step: rank {r['rank']} {name} {r['metrics'][name]} against one "
                         f"process's {want} (bound {lb})")
        for key in ("replicated", "grad_sha1", "params_sha1", "params_after_timed_sha1"):
            if len({r[key] for r in res}) != 1:
                fail(f"dp step: the ranks' {key} differ")
        for r in res:
            if r["step_launches"] != {"radius_knn": 12, "sinkhorn": 0} or \
                    r["eval_launches"] != {"radius_knn": 0, "sinkhorn": 1}:
                fail(f"dp step: rank {r['rank']} launches {r['step_launches']} per step, "
                     f"{r['eval_launches']} per eval step (batch built before it)")
            print("  " + r["sinkhorn_line"])
            kernels["sinkhorn"]["max_abs_err"] = max(kernels["sinkhorn"]["max_abs_err"],
                                                     r["sinkhorn_err"])
        print(f"dp step: {[round(x, 3) for x in res[0]['step_ms']]} ms/step on rank 0, "
              f"{[round(x, 3) for x in res[1]['step_ms']]} on rank 1 (one pair a rank, the "
              f"gradient all-reduced); one process on both pairs "
              f"{[round(x, 3) for x in one_ms]} ms/step; peak memory per rank "
              f"{[round(r['peak'] / 2**20, 1) for r in res]} MiB, one process "
              f"{one_peak / 2**20:.1f} MiB; launches per rank per step {res[0]['step_launches']};"
              f" weights bit-equal across ranks after the step ({backend}, {card})")

        # ---- (b)
        for r in res:
            if not (r["sp_equal"] and r["sp_plain_equal"]):
                fail(f"sp build: rank {r['rank']} tables equal to the unsharded build "
                     f"{r['sp_equal']}, shard tables equal to the plain version "
                     f"{r['sp_plain_equal']}")
        b = res[0]["build_ms"]
        print(f"sp build (sp_min_queries {SP_MIN_QUERIES}): every table equal to the unsharded "
              f"build on both ranks, each rank's shard tables equal to the plain version; "
              f"launches per rank {res[0]['sp_launches']} (shards q/s {res[0]['sp_shards']}); "
              f"build ms sharded {[round(x, 3) for x in b['sharded']]}, whole "
              f"{[round(x, 3) for x in b['whole']]} on rank 0, in turns ({backend}, {card})")

        # ---- (d)
        train_pair = {"radius_knn": 12, "sinkhorn": 0}
        eval_pair = {"radius_knn": 12, "sinkhorn": 1}
        pr = [r["programs"] for r in res]
        for key in ("trace", "acc_trace", "state_sha1"):
            if pr[0][key] != pr[1][key]:
                fail(f"dp programs: the ranks' states differ ({key})")
        for r, p in zip(res, pr):
            tl, (first, second) = p["train_launches"], p["half_launches"]
            per_eval = {k: v / 2 for k, v in p["eval_launches"].items()}
            if {k: tl[k] for k in train_pair} != train_pair or first != tl or any(second.values()) \
                    or {k: per_eval[k] for k in eval_pair} != eval_pair:
                fail(f"dp programs: rank {r['rank']} launches {tl} a train pair ({first} / "
                     f"{second} by half), {per_eval} an eval pair at the captures")
            want = {k: tl[k] for k in PROFILED_KERNELS}
            if p["train_seen"] != want or p["half_seen"] != [want, {k: 0 for k in want}] or \
                    p["eval_seen"] != {k: p["eval_launches"][k] for k in PROFILED_KERNELS}:
                fail(f"dp programs: rank {r['rank']} profiled replays launched "
                     f"{p['train_seen']} (halves {p['half_seen']}), eval {p['eval_seen']}; the "
                     f"captures counted {tl}, {p['eval_launches']}")
            if p["acc_counters"] != (2, 0, 0):
                fail(f"dp programs: rank {r['rank']} (count, mini_step, notfinite_count) "
                     f"{p['acc_counters']} after three groups at grad_acc_steps 2")
        p = pr[0]
        wall, kernel = p["busy"]
        print(f"dp programs ({backend}, {card}): the dp train program (2 eager warm-ups, both "
              f"halves captured into one pool, replays; the exchange between them) against the "
              f"eager dp step over {DP_PROGRAM_STEPS} steps from the same weights, generators and "
              f"batches, rank 1's ground truth NaN at step {DP_PROGRAM_NAN}: metrics, weights, "
              f"Adam's moments and steps, lr, counters and generators bit-equal after every step "
              f"on both ranks, the NaN step skipped on both, the ranks' states bit-equal; the same "
              f"at grad_acc_steps 2 over {DP_ACC_STEPS // 2} groups (the second NaN: 2 updates); "
              f"the eval program on {len(EVAL_PROGRAM_VALID)} two-pair batches bit-equal to the "
              f"eager eval step; launches at the captures {p['train_launches']} a train pair "
              f"(halves {p['half_launches'][0]} / {p['half_launches'][1]}), "
              f"{ {k: v / 2 for k, v in p['eval_launches'].items()} } an eval pair, and in "
              f"profiled replays")
        for r, p in zip(res, pr):
            cap_s, kept, reserved = p["capture"]
            e_cap_s, e_kept, e_reserved = p["eval_capture"]
            print(f"  rank {r['rank']}: replay ms/step {spread(p['ms']['replay'])}, eager "
                  f"{spread(p['ms']['eager'])} ({DP_PROGRAM_TURNS} turns); peak allocated "
                  f"replay {p['peaks']['replay'] / 2**20:.1f} MiB, eager "
                  f"{p['peaks']['eager'] / 2**20:.1f} MiB; train program captured in "
                  f"{cap_s:.3f} s, {kept / 2**20:.1f} MiB kept, {reserved / 2**20:.1f} MiB "
                  f"reserved; eval program {e_cap_s:.3f} s, {e_kept / 2**20:.1f} MiB kept, "
                  f"{e_reserved / 2**20:.1f} MiB reserved; a profiled replay {p['busy'][0]:.3f} "
                  f"ms wall, {p['busy'][1]:.3f} ms of kernels "
                  f"({100 * p['busy'][1] / p['busy'][0]:.1f}% busy)")

        # ---- (e)
        if backend == "nccl":
            probes = [r["watchdog_probes"] for r in res]
            if probes != [DP_WATCHDOG_PROBES] * len(res):
                fail(f"dp watchdog probes: {probes} of {DP_WATCHDOG_PROBES} captures right a rank")
            print(f"dp watchdog probes (nccl, {card}): {DP_WATCHDOG_PROBES} graphs a rank recorded "
                  f"in the global capture mode of every program, each held open 0.3 s right after "
                  f"an all-reduce left to the NCCL watchdog, all captured and replayed right")
        else:
            print(f"dp watchdog probes: not run ({backend}: its exchange waits for its end, so "
                  f"nothing of it runs while a program is recorded)")

        # ---- (c)
        run_dir = spec["run"]
        for kind in ("programs", "eager"):
            for i in range(2):
                if len({r["runs"][kind]["runs"][i]["params_sha1"] for r in res}) != 1:
                    fail(f"trainval --dp ({kind}): the ranks' weights differ after run {i + 1}")
        for r in res:
            got, eager = r["runs"]["programs"], r["runs"]["eager"]
            last = got["runs"][-1]
            if not all(x["programs"] for x in got["runs"]) or any(x["programs"]
                                                                  for x in eager["runs"]):
                fail(f"trainval --dp: rank {r['rank']}: the Trainer on programs "
                     f"{[x['programs'] for x in got['runs']]}, kept eager "
                     f"{[x['programs'] for x in eager['runs']]}")
            if last["launches"][0] is None or last["launches"][1] is None or \
                    {k: last["launches"][0][k] for k in train_pair} != train_pair or \
                    {k: last["launches"][1][k] for k in eval_pair} != eval_pair:
                fail(f"trainval --dp: rank {r['rank']}: launches of the resumed run's programs "
                     f"{last['launches']} (captured at its third train step and validation)")
            if got["rows"] != eager["rows"] or [x["params_sha1"] for x in got["runs"]] != \
                    [x["params_sha1"] for x in eager["runs"]]:
                fail(f"trainval --dp: rank {r['rank']}: the logged steps or the weights on the "
                     f"programs differ from the eager Trainer's")
        records = {}
        for kind, d in (("programs", run_dir), ("eager", run_dir + "_eager")):
            with open(os.path.join(d, "metrics.jsonl")) as f:
                records[kind] = [json.loads(line) for line in f]
        if records["programs"] != records["eager"]:
            fail(f"trainval --dp: metrics.jsonl on the programs {records['programs']} against "
                 f"the eager Trainer's {records['eager']}")
        records = records["programs"]
        with open(os.path.join(run_dir, "config.json")) as f:
            run_cfg = config_from_dict(Config, json.load(f))
        if run_cfg.parallel.dp != DP_WORLD or [(x["phase"], x["epoch"]) for x in records] != [
                (phase, e) for e in range(DP_EPOCHS) for phase in ("train", "val")]:
            fail(f"trainval --dp: parallel {run_cfg.parallel}, records {records}")
        one_cfg = dataclasses.replace(run_cfg, parallel=dataclasses.replace(run_cfg.parallel,
                                                                            dp=1))
        t = one_cfg.train
        loaders = [PairLoader(RegistrationPairDataset("kitti", root, subset,
                                                      point_limit=t.point_limit),
                              cap=one_cfg.pyramid.caps[0]) for subset in ("train", "val")]
        with contextlib.redirect_stdout(io.StringIO()):
            single = Trainer(one_cfg, *loaders, output_dir=os.path.join(tmp, "single"),
                             device=dev)
            single.use_programs = False
            single.state.model.load_state_dict(
                CheckpointManager(os.path.join(run_dir, "snapshots")).restore_params(DP_EPOCHS))
            got = single.validate()
        want = records[-1]
        worst = max(abs(got[k] - want[k]) for k in got)
        if set(got) != set(want) - {"phase", "epoch"} or worst > 1e-5:
            fail(f"trainval --dp: validation {want} against one process's {got}")
        rows = res[0]["runs"]["programs"]["rows"]
        print(f"trainval --dp {DP_WORLD} on the programs and with the Trainer kept eager (an "
              f"epoch, then resumed to {DP_EPOCHS}): every record of metrics.jsonl "
              f"({len(records)}) and every logged step ({len(rows)} rows on rank 0) equal, the "
              f"weights equal after each run and across ranks; launches per train step "
              f"{ {k: last['launches'][0][k] for k in train_pair} }, per val pair "
              f"{ {k: last['launches'][1][k] for k in eval_pair} } (the resumed run's programs, "
              f"counted at their captures); validation means within {worst:.3e} of one process "
              f"on snapshot {DP_EPOCHS} ({backend}, {card})")
        for kind in ("programs", "eager"):
            r0 = res[0]["runs"][kind]["runs"]
            epochs = [e for run in r0 for e in run["epochs"]]
            vals = [v for run in r0 for v in run["vals"]]
            rates = [x for e in epochs for x in e["window_steps_per_s"]]
            print(f"  {kind}: {r0[0]['seconds']:.3f} s (1 epoch) and {r0[1]['seconds']:.3f} s "
                  f"resumed ({DP_EPOCHS - 1} epochs) on rank 0; windowed steps/s "
                  f"{[round(x, 3) for x in rates]}; per epoch "
                  f"{[round(e['seconds'] / e['steps'] * 1e3, 3) for e in epochs]} ms/step "
                  f"({[e['steps'] for e in epochs]} steps a rank), validation "
                  f"{[round(v['seconds'] / v['pairs'] * 1e3, 3) for v in vals]} ms/pair")
        print(f"dp phase: {time.perf_counter() - t_phase:.3f} s in all, of it the ranks "
              f"{ranks_s:.3f} s, their start-up included")
    return {"launches_per_dp_train_step_rank": res[0]["step_launches"],
            "launches_per_sp_build_rank": res[0]["sp_launches"],
            "launches_per_dp_train_program_pair": res[0]["programs"]["train_launches"],
            "launches_per_dp_val_pair": {k: v / 2 for k, v in
                                         res[0]["programs"]["eval_launches"].items()}}


# ---- phase 15: the library surface -------------------------------------------------------
SPLIT_POSE_LIMIT = 1e-4  # phase 15 (d): split pose against the batch's, max abs entry
GA_REPS = 20             # timed group_and_aggregate calls of phase 15 (c)


def _flat(out):
    """A tensor or a (named) tuple of tensors -> a list of tensors."""
    return [out] if hasattr(out, "shape") else list(out)


def card_vs_cpu(dev, name, fn, *args, worst=None):
    """``fn`` on the card and on the CPU on the same inputs (numpy arrays become
    tensors, other arguments pass as they are): bool and integer outputs equal,
    float outputs within 1e-5 of the CPU's max |y|. Returns the card's outputs."""
    import numpy as np
    import torch

    cpu = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]
    card = [a.to(dev) if isinstance(a, torch.Tensor) else a for a in cpu]
    got, want = _flat(fn(*card)), _flat(fn(*cpu))
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.detach().cpu()
        w = w.detach()
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"library phase: {name}[{i}] {tuple(g.shape)} {g.dtype} on the card, "
                 f"{tuple(w.shape)} {w.dtype} on the CPU")
        if not w.is_floating_point():
            if not torch.equal(g, w):
                fail(f"library phase: {name}[{i}] differs between the card and the CPU")
            continue
        scale = float(w.abs().max()) if w.numel() else 0.0
        err = float((g - w).abs().max()) if w.numel() else 0.0
        if not err <= 1e-5 * max(scale, 1e-30):
            fail(f"library phase: {name}[{i}] card vs CPU {err:.3e} > 1e-5 x {scale:.3e}")
        if worst is not None:
            worst[name] = max(worst.get(name, 0.0), err / max(scale, 1e-30))
    if worst is not None:
        worst.setdefault(name, 0.0)
    return got


def library_phase(dev, card, kernels, cfg, model, batch):
    """Phase 15: the library surface no model path calls. (a) the fast
    contracts on the card; (b) the correspondence toolkit, the geometry,
    partition and KPConv helpers, ``log_sinkhorn``, ``point_matching`` and
    ``ConvBlock`` on the card and the CPU on the same seeded inputs; (c)
    ``group_and_aggregate`` at level-1 shapes of the phase-4 pair against its
    plain version, at its k and at k = 257 (the select path); (d) the phase-4 pair's
    pyramid repacked into the reference's stacked layout, split by
    ``pair_batch_from_stacked`` and run through the model. Returns the launches
    per contracts run and per ``group_and_aggregate`` call by kernel."""
    import copy

    import numpy as np
    import torch

    from rdmnet_tpu_torch.graph.pyramid import build_pair_batch, pad_cloud, search_plan
    from rdmnet_tpu_torch.nn import kpconv, layers
    from rdmnet_tpu_torch.nn.point_matching import group_and_aggregate, point_matching
    from rdmnet_tpu_torch.nn.sinkhorn import log_sinkhorn
    from rdmnet_tpu_torch.ops import correspondences as corr
    from rdmnet_tpu_torch.ops import geometry as geo
    from rdmnet_tpu_torch.ops.kernels import launch_counts, path_launch_counts, reset_launch_counts
    from rdmnet_tpu_torch.ops.kernels.radius_knn import radius_knn_cuda
    from rdmnet_tpu_torch.ops.kernels.sinkhorn import sinkhorn_cuda
    from rdmnet_tpu_torch.ops.partition import knn_partition
    from rdmnet_tpu_torch.utils import contracts
    from rdmnet_tpu_torch.utils.golden import pair_batch_from_stacked, stack_pair_batch

    t_phase = time.perf_counter()
    # ---- (a) the fast contracts: one kNN and one Sinkhorn launch ----------------
    scan = contracts.default_scan()
    reset_launch_counts()
    results = contracts.run_fast_contracts(dev, scan=scan)
    per_contracts = launch_counts()
    for name, verdict in results.items():
        print(f"library phase: contract {name}: {verdict}")
    if results != {"knn_exact": "pass", "sinkhorn": "pass", "horn_pose_recovery": "pass"}:
        fail(f"library phase: contracts {results}")
    if per_contracts != {"radius_knn": 1, "sinkhorn": 1}:
        fail(f"library phase: a contracts run launched {per_contracts}, not one of each kernel")
    q = torch.from_numpy(scan[:contracts.KNN_QUERIES]).to(dev)[None]
    s = torch.from_numpy(scan[:contracts.KNN_SUPPORT]).to(dev)[None]
    cnt = torch.tensor([contracts.KNN_COUNT], dtype=torch.int32, device=dev)
    knn_ms = graph_ms(lambda: radius_knn_cuda(q, s, cnt, contracts.KNN_RADIUS, contracts.KNN_K),
                      reps=20)
    pairs = contracts.KNN_QUERIES * contracts.KNN_COUNT
    knn_bound = max((q.numel() + s.numel() + contracts.KNN_QUERIES * contracts.KNN_K) * 4
                    / HBM_BYTES_PER_S, pairs * KNN_OPS_PER_PAIR / F32_FLOPS) * 1e3
    sk = [torch.from_numpy(a).to(dev) for a in contracts.sinkhorn_inputs()]
    sk_ms = graph_ms(lambda: sinkhorn_cuda(*sk, contracts.SINKHORN_ITERS), reps=20)
    # as phase 3's bound: each half-step's exp per entry on the SFU, its f32
    # ops, or the scores, marginals and plan through memory
    entries = int(np.prod(contracts.SINKHORN_SHAPE))
    half_steps = 2 * contracts.SINKHORN_ITERS * entries
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    sk_bound = max(half_steps / (NUM_SMS * SFU_PER_SM_CLK * clock_hz),
                   half_steps * SINKHORN_OPS_PER_ENTRY / F32_FLOPS,
                   (2 * sk[0].numel() + sk[1].numel() + sk[2].numel()) * 4 / HBM_BYTES_PER_S) * 1e3
    kernels["radius_knn"]["contract_ms"] = knn_ms
    kernels["sinkhorn"]["contract_ms"] = sk_ms
    print(f"library phase: contract shapes on the device ({card}): radius_knn 256 x 2048 rows, "
          f"k 8: {knn_ms:.4f} ms (bound {knn_bound:.5f}); sinkhorn (8, 17, 17), 20 it.: "
          f"{sk_ms:.4f} ms (bound {sk_bound:.5f})")

    # ---- (b) card against CPU on seeded inputs ------------------------------------
    rng = np.random.RandomState(SEED + 15)
    f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)  # noqa: E731
    worst = {}
    both = lambda name, fn, *a: card_vs_cpu(dev, name, fn, *a, worst=worst)  # noqa: E731
    pts = f32(rng.rand(4000, 3) * [70.0, 40.0, 4.0] - [35.0, 20.0, 2.0])
    pmask = rng.rand(4000) > 0.1
    nodes = f32(pts[rng.permutation(4000)[:256]] + rng.randn(256, 3) * 0.3)
    nmask = rng.rand(256) > 0.1
    rot = geo.rodrigues_rotation(torch.from_numpy(f32(rng.randn(3))), torch.tensor(0.4)).numpy()
    tf = np.eye(4, dtype=np.float32)
    tf[:3, :3], tf[:3, 3] = rot, [1.5, -0.7, 0.2]
    both("apply_rotation", geo.apply_rotation, pts, rot)
    both("apply_rotation batched", geo.apply_rotation, f32(rng.randn(8, 500, 3) * 30),
         np.stack([rot] * 8))
    axis, angle = f32(rng.randn(64, 3)), f32(rng.uniform(-3, 3, 64))
    both("skew_symmetric", geo.skew_symmetric, axis)
    both("rodrigues_rotation", geo.rodrigues_rotation, axis, angle)
    both("vector_angle", geo.vector_angle, axis, f32(rng.randn(64, 3)))
    both("masked_min", lambda v, m: geo.masked_min(v, m, 1),
         f32(rng.randint(0, 50, (256, 300))), rng.rand(256, 300) > 0.3)
    both("knn_partition", lambda p, n, m: knn_partition(p, n, 32, m), pts, nodes, pmask)
    nbr = rng.randint(0, 4000, (1000, 16))
    nbr[rng.rand(1000, 16) < 0.2] = 4000
    feats = f32(rng.randn(4000, 64))
    both("knn_interpolate", lambda f, q_, p, i: kpconv.knn_interpolate(f, q_, p, i, 8), feats,
         pts[:1000], pts, nbr)
    both("global_avgpool", kpconv.global_avgpool, feats, pmask)
    both("log_sinkhorn", lambda a, b, c: log_sinkhorn(a, b, c, 20), f32(rng.randn(4, 65, 65)),
         f32(rng.randn(4, 65) * 0.1), f32(rng.randn(4, 65) * 0.1))
    score = f32(rng.randn(129, 129) * 2)
    for mutual, bilateral, dustbin, thr in ((False, False, False, 0.0), (True, False, True, 0.05),
                                            (False, True, False, 0.05)):
        both(f"masks_from_scores {mutual}/{bilateral}/{dustbin}",
             lambda sm: corr.correspondence_masks_from_scores(sm, mutual, bilateral, dustbin, thr),
             score)
    both("masks_threshold", lambda sm: corr.correspondence_masks_threshold(sm, 0.5, True), score)
    both("top_k_correspondences", lambda sm: corr.top_k_correspondences(sm, 256, True), score)
    # features on a 1/8 grid: their products and sums are exact in float32 on
    # both devices, so argmin decisions cannot part on rounding
    both("masks_from_feats", lambda a, b: corr.correspondence_masks_from_feats(a, b, mutual=True),
         f32(rng.randint(-16, 17, (200, 32)) / 8), f32(rng.randint(-16, 17, (220, 32)) / 8))
    both("nearest_node_assignment", corr.nearest_node_assignment, pts, nodes, pmask, nmask)
    src_pts = f32((pts - tf[:3, 3]) @ rot)
    corr_idx = np.stack([rng.randint(0, 4000, 5000), rng.randint(0, 4000, 5000)], 1)
    corr_idx[-50:] = 4000  # rows past the clouds: dropped by the scatter
    both("dense_to_node", lambda *a: corr.dense_to_node_correspondences(*a[:5], corr_mask=a[5]),
         pts, src_pts, nodes, nodes, corr_idx, rng.rand(5000) > 0.1)
    p_, k_ = 256, 64
    rki = rng.randint(0, 4000, (p_, k_))
    rki[rng.rand(p_, k_) < 0.2] = 4000
    rkm = rki < 4000
    rkp = f32(pts[np.minimum(rki, 3999)])
    skp = f32(src_pts[np.minimum(rki, 3999)] + rng.randn(p_, k_, 3) * 0.05)
    ncorr = np.stack([np.arange(p_), rng.permutation(p_)], 1)
    ncm = rng.rand(p_) > 0.1
    both("node_to_dense", lambda *a: corr.node_to_dense_correspondences(
        *a[:6], 0.3, node_corr_mask=a[6], ref_knn_masks=a[7], src_knn_masks=a[7]),
        rkp, skp, rki, rki, ncorr, tf, ncm, rkm)
    both("node_pair_overlaps", lambda *a: corr.node_pair_overlaps(a[0], a[1], a[2], 0.3, a[3], a[3]),
         rkp, skp, tf, rkm)
    for fn in (corr.node_overlap_ratios, corr.node_occlusion_ratios):
        both(fn.__name__, lambda *a, fn=fn: fn(4000, 4000, *a[:6], 0.3, a[7], a[7],
                                                node_corr_mask=a[6]),
             rkp, skp, rki, rki, ncorr, tf, ncm, rkm)
    both("point_matching", lambda *a: point_matching(*a, cfg.fine_matching), rkp, skp, rkm, rkm,
         f32(rng.randn(p_, k_ + 1, k_ + 1) * 2 - 4), ncm)
    # ConvBlock: seeded torch init on the CPU, the same weights copied to the card
    torch.manual_seed(SEED)
    blocks = [
        ("Linear+GroupNorm", layers.ConvBlock(64, 256, "Linear", norm_cfg="GroupNorm",
                                              act_cfg="LeakyReLU"), (4096, 64)),
        ("Conv2d 3x2 s2 SAME+BatchNorm", layers.ConvBlock(
            16, 32, "Conv2d", kernel_size=(3, 2), stride=2, padding="SAME",
            norm_cfg="BatchNorm2d", act_cfg="ReLU"), (4, 64, 63, 16)),  # uneven SAME pads
        ("Conv1d+InstanceNorm", layers.ConvBlock(32, 64, "Conv1d", kernel_size=3, padding=1,
                                                 norm_cfg="InstanceNorm1d", act_cfg="GELU"),
         (8, 512, 32)),
    ]
    for name, block, shape in blocks:
        pair = {"cpu": block, "card": copy.deepcopy(block).to(dev)}
        run = lambda x, train, pair=pair: pair["card" if x.is_cuda else "cpu"](x, train=train)  # noqa: E731
        x = f32(rng.randn(*shape))
        if "BatchNorm" in name:
            both(f"{name} train", lambda t: run(t, True), x)
            bn = {k: dict(m.BatchNorm_0.named_buffers()) for k, m in pair.items()}
            for key in ("running_mean", "running_var"):
                err = float((bn["card"][key].cpu() - bn["cpu"][key]).abs().max())
                if err > 1e-5 * float(bn["cpu"][key].abs().max()):
                    fail(f"library phase: {name} {key} card vs CPU {err:.3e}")
        with torch.no_grad():
            both(f"{name} eval", lambda t: run(t, False), f32(rng.randn(*shape) * 2 + 0.5))
    print(f"library phase: {len(worst)} calls equal on the card and the CPU (masks and "
          f"indices exact); worst float error / max |y|: {max(worst.values()):.3e} "
          f"({max(worst, key=worst.get)})")

    # ---- (c) group_and_aggregate at level-1 shapes of the phase-4 pair ------------
    lvl1 = [sp for sp in search_plan(cfg.pyramid) if sp.table == "neighbors" and sp.q_lvl == 1][0]
    q1, c1 = batch.ref.points[1], batch.ref.counts[1]
    f1 = torch.from_numpy(f32(rng.randn(q1.shape[0], 128))).to(dev)
    reset_launch_counts()
    got = group_and_aggregate(q1, q1, f1, c1, lvl1.radius, lvl1.k)
    per_ga = launch_counts()
    if per_ga != {"radius_knn": 1, "sinkhorn": 0}:
        fail(f"library phase: group_and_aggregate launched {per_ga}")
    want = group_and_aggregate(q1.cpu(), q1.cpu(), f1.cpu(), c1.cpu(), lvl1.radius, lvl1.k)
    if not (torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])):
        fail("library phase: group_and_aggregate on the card differs from its plain version")
    ga = lambda: group_and_aggregate(q1, q1, f1, c1, lvl1.radius, lvl1.k)  # noqa: E731
    ga_ms = cuda_ms(ga, reps=GA_REPS)
    t0 = time.perf_counter()
    group_and_aggregate(q1.cpu(), q1.cpu(), f1.cpu(), c1.cpu(), lvl1.radius, lvl1.k)
    ga_plain_ms = (time.perf_counter() - t0) * 1e3
    # k = 257: the kNN kernel's select path over the tiled 8704-row window
    reset_launch_counts()
    got = group_and_aggregate(q1, q1, f1, c1, lvl1.radius, 257)
    per_257 = path_launch_counts()["radius_knn"]
    if per_257 != {"list": 0, "select": 1, "block": 0}:
        fail(f"library phase: group_and_aggregate at k = 257 launched {per_257}")
    want = group_and_aggregate(q1.cpu(), q1.cpu(), f1.cpu(), c1.cpu(), lvl1.radius, 257)
    if not (torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])):
        fail("library phase: group_and_aggregate at k = 257 differs from its plain version")
    print(f"library phase: group_and_aggregate at level 1 ({q1.shape[0]} x {q1.shape[0]} rows, "
          f"{int(c1)} valid, r {lvl1.radius}, k {lvl1.k}, 128 channels): {ga_ms:.4f} ms per call "
          f"on the card ({card}), plain on the CPU {ga_plain_ms:.3f} ms; {per_ga['radius_knn']} "
          f"kNN launch per call; equal to the plain version; at k = 257 one select-path launch, "
          f"equal to the plain version (largest group {int(got[1].max())})")

    # ---- (d) the phase-4 pairs through the reference's stacked layout ------------
    # The split holds the batch's valid rows and tables at smaller capacities
    # (round8 of the larger cloud), so every sum over padded rows rounds
    # otherwise. Held: the split's rows and tables equal to the batch's, its
    # fine features within 1e-4 of max |y| (the golden test's bound), one
    # Sinkhorn launch, a finite rigid pose. With random weights NMS, the
    # superpoint top-k and LGR's few-correspondence hypotheses sit on near-ties
    # (on the card the phase-4 pair's node correspondences part), so the
    # pose difference is only printed; a scan against a rigidly moved copy is
    # held to SPLIT_POSE_LIMIT when both its poses register (phase 5's 0.05).
    motion = np.eye(4, dtype=np.float32)
    motion[:2, :2] = [[np.cos(0.05), -np.sin(0.05)], [np.sin(0.05), np.cos(0.05)]]
    motion[:3, 3] = [0.5, 0.3, 0.1]
    ref0 = batch.ref.points[0][:int(batch.ref.counts[0])].cpu().numpy()
    moved = f32((ref0 - motion[:3, 3]) @ motion[:3, :3])
    cap = cfg.pyramid.caps[0]
    moved_batch = build_pair_batch(*pad_cloud(ref0, cap, device=dev),
                                   *pad_cloud(moved, cap, device=dev), torch.eye(4, device=dev),
                                   cfg.pyramid)
    for label, b, known in (("the phase-4 pair", batch, None),
                            ("its ref against a moved copy", moved_batch, motion)):
        split = pair_batch_from_stacked(**stack_pair_batch(b),
                                        transform=np.eye(4, dtype=np.float32), device=dev)
        for side in ("ref", "src"):
            x, y = getattr(b, side), getattr(split, side)
            counts = [int(c) for c in x.counts]
            for lvl, n in enumerate(counts):
                if int(y.counts[lvl]) != n or not torch.equal(x.points[lvl][:n], y.points[lvl][:n]):
                    fail(f"library phase: {label}: {side} points[{lvl}] of the split differ")
            for field, q_off, s_off in (("neighbors", 0, 0), ("subsampling", 1, 0),
                                        ("upsampling", 0, 1)):
                for lvl, (tx, ty) in enumerate(zip(getattr(x, field), getattr(y, field))):
                    nq, ns_ = counts[lvl + q_off], counts[lvl + s_off]
                    want_t = torch.where(tx[:nq] < ns_, tx[:nq], y.points[lvl + s_off].shape[0])
                    if not torch.equal(ty[:nq], want_t.to(ty.dtype)):
                        fail(f"library phase: {label}: {side} {field}[{lvl}] of the split differ")
        reset_launch_counts()
        with torch.no_grad():
            out_split = model(split)
        per_split = launch_counts()
        with torch.no_grad():
            out = model(b)
        if per_split != {"radius_knn": 0, "sinkhorn": 1}:
            fail(f"library phase: {label} split launched {per_split}, not one Sinkhorn")
        feat_err = 0.0
        for side, key in (("ref", "ref_feats_f"), ("src", "src_feats_f")):
            n1 = int(getattr(b, side).counts[1])
            a, w = out_split[key][:n1], out[key][:n1]
            feat_err = max(feat_err, float((a - w).abs().max()) / float(w.abs().max()))
        if not feat_err <= 1e-4:
            fail(f"library phase: {label}: split fine features {feat_err:.3e} of max |y| apart")
        tf_split, tf = out_split["estimated_transform"], out["estimated_transform"]
        rot = tf_split[:3, :3]
        ortho = float((rot.T @ rot - torch.eye(3, device=dev)).abs().max())
        if not (bool(torch.isfinite(tf_split).all()) and ortho < 1e-4):
            fail(f"library phase: {label}: split pose not a finite rigid transform ({ortho:.3e})")
        pose_diff = float((tf_split - tf).abs().max())
        same_nodes = all(torch.equal(out_split[k], out[k]) for k in (
            "ref_node_corr_indices", "src_node_corr_indices", "node_corr_valid"))
        line = (f"library phase: {label} split from the reference's stacked layout (caps "
                f"{[p.shape[0] for p in split.ref.points]} against "
                f"{[p.shape[0] for p in b.ref.points]}): tables equal, fine features within "
                f"{feat_err:.3e} of max |y|, node correspondences "
                f"{'equal' if same_nodes else 'parted'}, pose differs from the batch's by "
                f"{pose_diff:.3e}; launches {per_split}")
        if known is None:
            line += " (pose not held: random weights)"
        else:
            reg = [float((t.cpu() - torch.from_numpy(known)).abs().max()) for t in (tf, tf_split)]
            held = max(reg) <= 0.05
            line += (f"; poses against the known motion {reg[0]:.3e} (batch), {reg[1]:.3e} "
                     f"(split): " + (f"both register, difference held to {SPLIT_POSE_LIMIT}"
                                     if held else "not both registered, difference not held"))
            if held and not pose_diff <= SPLIT_POSE_LIMIT:
                fail(f"library phase: {label}: split pose differs by {pose_diff} > "
                     f"{SPLIT_POSE_LIMIT}")
        print(line)
    print(f"library phase: {time.perf_counter() - t_phase:.3f} s")
    return {"launches_per_contracts_run": per_contracts, "launches_per_group_and_aggregate": per_ga}


# ---- phase 3's large shapes and phase 16: every shape the JAX package runs -------------
LARGE_K1 = (209, 257, 304, 412, 513, 546)  # phase 3: cluster-path patches (C's limits among them)
LARGE_P, LARGE_ITERS = 256, 100   # phase 3: patches and iterations of each
# phase 3: (P, K1) on the group path: P = 32 and 256 at K1 = 600, phase 16's
# (256, 601), and P = 32 at K1 = 1025 and at the last K1 held wholly in shared memory (2640)
GROUP_CASES = ((32, 600), (256, 600), (256, 601), (32, 1025), (32, 2640))
SPILL_CASES = ((8, 2641), (2, 3000), (2, 4096))  # phase 3: (P, K1) on the group path, bands spilled
LARGE_REPS = 5                    # timed calls per phase-3 large-shape instance
SELECT_KS = (320, 512, 1024)       # phase 3: k on the warp select path, the 8192-row band
BLOCK_KS = (2048, 4096)            # phase 3: k on the block select path, the 8192-row band
LARGE_LIMITS = (320, 40, 40, 40, 40)  # phase 16: neighbour limits, level 0 past the register list
BLOCK_LIMITS = (2048, 40, 40, 40, 40)  # phase 16: a graph build whose level 0 takes the block path
LARGE_PATCH = 256                     # phase 16: num_points_in_patch (K1 = 257)
LARGE_WARM, LARGE_TIMED, LARGE_STAGE = 2, 6, 2  # phase 16 pairs
GROUP_PATCH = 600                     # phase 16's group-path pass: num_points_in_patch (K1 = 601)
GROUP_WARM, GROUP_TIMED, GROUP_STAGE = 2, 4, 2  # its pairs


def dense_cloud(seed, n, box):
    """``n`` points uniform in a box at the origin, x-cell sorted (0.6 m, the
    pyramid's order): far more rows inside a search radius than any k."""
    import numpy as np

    rng = np.random.RandomState(seed)
    pts = (rng.rand(n, 3) * np.asarray(box)).astype(np.float32)
    return pts[np.argsort(np.floor(pts[:, 0] / 0.6), kind="stable")]


def sinkhorn_inputs(seed, p, k1):
    """Phase 3's Sinkhorn inputs: scores N(0, 9), uniform marginals with a
    dustbin, 10% of the patches and 10% of the other rows masked (-1e12)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    scores = (rng.randn(p, k1, k1) * 3).astype(np.float32)
    log_mu = np.full((p, k1), -np.log(2 * (k1 - 1)), np.float32)
    log_nu = log_mu.copy()
    masked_patch = rng.rand(p) < 0.1
    scores[masked_patch] = -1e12
    log_mu[masked_patch, :-1] = -1e12
    log_nu[masked_patch, :-1] = -1e12
    rows = (rng.rand(p, k1) < 0.1) & ~masked_patch[:, None]
    rows[:, -1] = False
    scores[rows] = -1e12
    log_mu[rows] = -1e12
    return scores, log_mu, log_nu


def sinkhorn_bounds(p, k1, iters, max_clock_mhz):
    """(bound ms, bound_by, SFU ms, f32-ops ms, bytes ms): the least time for
    the function (each exp on the SFU, 4 f32 ops beside it, inputs and
    output moved once)."""
    entries = p * k1 * k1
    exp_s = 2 * iters * entries / (NUM_SMS * SFU_PER_SM_CLK * max_clock_mhz * 1e6)
    ops_s = 2 * iters * entries * SINKHORN_OPS_PER_ENTRY / F32_FLOPS
    bytes_s = (2 * entries + 2 * p * k1) * 4 / HBM_BYTES_PER_S
    by = "operations" if max(exp_s, ops_s) >= bytes_s else "bytes"
    return max(exp_s, ops_s, bytes_s) * 1e3, by, exp_s * 1e3, ops_s * 1e3, bytes_s * 1e3


def large_knn_case(dev, kernels, name, s_np, counts, radius, k, band=None, chunk=256,
                   queries=None, route="select"):
    """One search past the register list (k > 256) through ``check_knn``:
    the plan's path is ``route``, tables equal to the plain version, every
    launch on that path, the share of queries whose list fills. ``queries``:
    search the first rows only. Returns (device ms, ms per call, plain ms,
    bound ms, plan, bound_by)."""
    import torch

    from rdmnet_tpu_torch.graph.pyramid import SearchSpec
    from rdmnet_tpu_torch.ops.kernels import path_launch_counts, reset_launch_counts
    from rdmnet_tpu_torch.ops.kernels.radius_knn import radius_knn_plain
    from rdmnet_tpu_torch.ops.radius_search import band_windows

    s = torch.from_numpy(s_np).to(dev).contiguous()
    cnt = torch.tensor(counts, dtype=torch.int32, device=dev)
    q, q_cnt = s, cnt
    if queries is not None:
        q = s[:, :queries].contiguous()
        q_cnt = torch.full_like(cnt, queries)
    # level 0 the support, level 1 the queries (the SearchSpec's indices)
    sp = SearchSpec("dense", 1, 0, radius, k, band, chunk, 0.6)
    reset_launch_counts()
    ms, call_ms, plain_ms, bound, work, plan = check_knn([s, q], [cnt, q_cnt], sp, kernels)
    if plan.route != route:
        fail(f"radius_knn {name} k={k}: planned on the {plan.route} path, not the {route} path")
    paths = path_launch_counts()["radius_knn"]
    if any(n for r, n in paths.items() if r != plan.route) or not paths[plan.route]:
        fail(f"radius_knn {name} k={k}: launched {paths}, not the {plan.route} path alone")
    kw = {}
    if band is not None:
        win, _ = band_windows(q, s, q_cnt, radius, sp.cell, band, chunk)
        kw = dict(win=win, chunk=chunk, band=band)
    found = (radius_knn_plain(q, s, cnt, radius, k, **kw) < s.shape[1]).sum(-1)
    print(knn_line(f"{plan.route} path {name} Q={q.shape[1]} S={s.shape[1]} K={k} band={band} "
                   f"r={radius}", ms, call_ms, plain_ms, bound, plan, None)
          + f"; {work_text(work)}; table equal to the plain version, neighbours per query "
          f"{int(found.min())}-{int(found.max())}, "
          f"{float((found == min(k, s.shape[1])).float().mean()):.3f} of the queries with a "
          "full list")
    return ms, call_ms, plain_ms, bound, plan, work["by"]


def large_shapes_check(dev, kernels, max_clock_mhz):
    """Phase 3's large shapes: the kNN kernel's select paths at the k the
    plan sends each (the warp select path at k = 257 to 1024, the block
    select path at k = 2048 to 6144, and k above the support count) on dense
    windows, banded, unbanded, tiled, a batch of two clouds, duplicated
    points, two sort chunks, an overflowing key cache and a window past the
    warp select path's box tile; Sinkhorn's cluster path at K1 in
    ``LARGE_K1``, its group path at ``GROUP_CASES`` and, with spilled
    bands, at ``SPILL_CASES``, with masked rows and patches. Fills the
    kernels' ``block_path`` entry (k = 2048, the 8192-row band), and
    ``cluster_path`` (P = 256, K1 = 257, 100 iterations, phase 16's shape),
    ``group_path`` (P = 256, K1 = 601, phase 16's group-path pass) and
    ``group_path_spilled`` (P = 8, K1 = 2641) entries."""
    import numpy as np
    import torch

    from rdmnet_tpu_torch.ops.kernels import path_launch_counts, reset_launch_counts
    from rdmnet_tpu_torch.ops.kernels.radius_knn import SELECT_BOX_ROWS_MAX
    from rdmnet_tpu_torch.ops.kernels.sinkhorn import (GROUP_K1_MAX, cluster_occupancy,
                                                       group_resident, sinkhorn_cuda,
                                                       sinkhorn_plain, sinkhorn_plan)

    # banded, a batch of two clouds with different counts, the band staged whole
    two = np.stack([dense_cloud(SEED + 20, 12000, (12.0, 3.0, 2.0)),
                    dense_cloud(SEED + 21, 12000, (12.0, 3.0, 2.0))])
    for k, route in ((257, "select"), (512, "select"), (1024, "select"), (2048, "block")):
        large_knn_case(dev, kernels, "banded batch", two, [11000, 12000], 1.5, k, band=4096,
                       route=route)
    # every point twice: the (distance, index) tie order, on both select paths
    twin = np.ascontiguousarray(two[:1, (np.arange(12000) + 1) // 2])
    for k, route in ((512, "select"), (2048, "block")):
        large_knn_case(dev, kernels, "banded duplicated points", twin, [12000], 1.5, k,
                       band=4096, route=route)
    # a band of 8192 rows (tiled on the block path's key cache)
    big = dense_cloud(SEED + 22, 16000, (10.0, 3.0, 2.0))[None]
    for k in SELECT_KS + BLOCK_KS:
        ms, call_ms, pms, bound, plan, by = large_knn_case(
            dev, kernels, "banded tiled", big, [16000], 2.0, k, band=8192,
            route="block" if k in BLOCK_KS else "select")
        if k == BLOCK_KS[0]:
            kernels["radius_knn"]["block_path"] = dict(
                shape=f"Q=16000 S=16000 K={k} band=8192 r=2.0", ms=ms, ms_per_call=call_ms,
                plain_ms=pms, bound_ms=bound, bound_by=by, library_ms=None)
    for k in (2048, 4096):
        large_knn_case(dev, kernels, "unbanded tiled", big, [15500], 2.0, k, queries=4096,
                       route="block")
    # a window past the warp select path's box tile, swept tile by tile, every
    # list overflowing its sort buffer
    huge = dense_cloud(SEED + 27, SELECT_BOX_ROWS_MAX + 7000, (40.0, 3.0, 2.0))[None]
    for k in (320, 1024):
        large_knn_case(dev, kernels, "unbanded tiled", huge, [huge.shape[1] - 77], 1.5, k,
                       queries=4096)
    # unbanded, the window staged whole
    mid = dense_cloud(SEED + 23, 6000, (4.0, 3.0, 2.0))[None]
    large_knn_case(dev, kernels, "unbanded", mid, [6000], 1.5, 512)
    # k above the support count: sentinels past the in-radius rows
    small = dense_cloud(SEED + 24, 300, (1.0, 1.0, 1.0))[None]
    for k, route in ((512, "select"), (1024, "select"), (4096, "block")):
        large_knn_case(dev, kernels, "k above the support count", small, [300], 2.0, k,
                       route=route)
    # the block path's output in two sort chunks of 4096 ranks, the keys cached
    few = dense_cloud(SEED + 25, 7000, (2.0, 2.0, 1.5))[None]
    large_knn_case(dev, kernels, "two sort chunks", few, [7000], 3.0, 6144, queries=512,
                   route="block")
    # a window whose in-radius rows overflow the block path's key cache, in
    # one sort chunk and in two
    wide = dense_cloud(SEED + 26, 12000, (3.0, 3.0, 2.0))[None]
    for k in (2048, 6144):
        large_knn_case(dev, kernels, "overflowing the key cache", wide, [12000], 3.0, k,
                       queries=512, route="block")

    cases = ([(k1, LARGE_P) for k1 in LARGE_K1] + [(k1, p) for p, k1 in GROUP_CASES]
             + [(k1, p) for p, k1 in SPILL_CASES])
    if (GROUP_CASES[-1][1] != GROUP_K1_MAX or sinkhorn_plan(GROUP_K1_MAX).spill_rows
            or not all(sinkhorn_plan(k1).spill_rows for _, k1 in SPILL_CASES)):
        fail(f"sinkhorn: phase 3's group cases must end at {GROUP_K1_MAX} and its spilled "
             "cases lie past it")
    occupancy = {}
    for k1, p in cases:
        s_np, mu_np, nu_np = sinkhorn_inputs(SEED + k1, p, k1)
        s_t, mu_t, nu_t = (torch.from_numpy(x).to(dev) for x in (s_np, mu_np, nu_np))
        plan = sinkhorn_plan(k1)
        reset_launch_counts()
        got = sinkhorn_cuda(s_t, mu_t, nu_t, LARGE_ITERS)
        torch.cuda.synchronize()
        paths = path_launch_counts()["sinkhorn"]
        if paths != {**dict.fromkeys(paths, 0), plan.route: 1} or plan.route == "register":
            fail(f"sinkhorn K1={k1}: launched {paths}, not one {plan.route}-path launch")
        want = sinkhorn_plain(s_t, mu_t, nu_t, LARGE_ITERS)
        live = want > -1e11
        if not torch.isfinite(got).all() or not torch.equal(got > -1e11, live):
            fail(f"sinkhorn K1={k1}: non-finite output or masked entries differ")
        err = float((got - want)[live].abs().max())
        if err > 1e-4:
            fail(f"sinkhorn K1={k1}: max abs error {err} > 1e-4")
        zero = sinkhorn_cuda(s_t, mu_t, nu_t, 0)  # u = v = 0: the scores
        zero_err = float((zero - s_t)[s_t > -1e11].abs().max())
        if zero_err > 1e-4 or not torch.equal(zero > -1e11, s_t > -1e11):
            fail(f"sinkhorn K1={k1}, 0 iterations: {zero_err} from the scores")
        kernels["sinkhorn"]["max_abs_err"] = max(kernels["sinkhorn"]["max_abs_err"], err)
        call = lambda: sinkhorn_cuda(s_t, mu_t, nu_t, LARGE_ITERS)  # noqa: E731
        ms, call_ms = graph_ms(call, reps=LARGE_REPS), cuda_ms(call, reps=LARGE_REPS)
        plain_ms = cuda_ms(lambda: sinkhorn_plain(s_t, mu_t, nu_t, LARGE_ITERS), reps=1,
                           warmup=0)
        bound, by, exp_ms, ops_ms, bytes_ms = sinkhorn_bounds(p, k1, LARGE_ITERS, max_clock_mhz)
        extra = ""
        if plan.route == "cluster":
            if plan.cluster not in occupancy:
                occupancy[plan.cluster] = cluster_occupancy(k1)
            extra = (f"; {plan.cluster} CTAs a cluster, {plan.cta_bytes} bytes a CTA, "
                     f"cudaOccupancyMaxActiveClusters {cluster_occupancy(k1)}")
        elif plan.route == "group":
            groups = min(p, group_resident(k1, s_t.device.index) // plan.group)
            extra = (f"; {plan.group} CTAs a group, {plan.cta_bytes} bytes a CTA, "
                     f"{group_resident(k1, s_t.device.index)} CTAs resident, {groups} groups "
                     f"in {-(-p // groups)} rounds")
            if plan.spill_rows:
                spilled = plan.group * plan.spill_rows * k1 * 4
                extra += (f"; {plan.spill_rows} of {-(-k1 // plan.group)} rows a band spilled: "
                          f"{spilled / 1e6:.3f} MB of the patch read from device memory every "
                          f"half-step ({2 * LARGE_ITERS * spilled / HBM_BYTES_PER_S * 1e3:.5f} ms "
                          "a patch at the HBM rate)")
        print(f"sinkhorn {plan.route} path P={p} K1={k1} iters={LARGE_ITERS}: kernel "
              f"{ms:.4f} ms on the device, {call_ms:.4f} ms per call; plain {plain_ms:.3f} ms, "
              f"bound {bound:.5f} ms (exp {exp_ms:.5f}, f32 ops {ops_ms:.5f}, bytes "
              f"{bytes_ms:.5f}){extra}; max abs err {err:.3e}, 0 iterations {zero_err:.3e}")
        entry = dict(shape=f"P={p} K1={k1} iters={LARGE_ITERS}", ms=ms, ms_per_call=call_ms,
                     plain_ms=plain_ms, bound_ms=bound, bound_by=by, max_abs_err=err,
                     library_ms=None)
        if k1 == LARGE_PATCH + 1:
            kernels["sinkhorn"]["cluster_path"] = dict(entry, cluster=plan.cluster)
        if k1 == GROUP_PATCH + 1:
            kernels["sinkhorn"]["group_path"] = dict(entry, group=plan.group)
        if (p, k1) == SPILL_CASES[0]:
            kernels["sinkhorn"]["group_path_spilled"] = dict(
                entry, group=plan.group, spill_rows=plan.spill_rows, launches=0)
    print("sinkhorn cluster path: cudaOccupancyMaxActiveClusters by cluster size "
          + json.dumps(occupancy))


def record_large_phase(per_pair, block_launches, kernels):
    """Phase 16's launches into the kernels line: per pair by kernel, and in
    its timed window by the large-shape path; the block path's in its graph
    build at ``BLOCK_LIMITS``."""
    for name, path in (("radius_knn", "select_path"), ("sinkhorn", "cluster_path")):
        kernels[name]["launches_per_large_shape_pair"] = sum(per_pair[name].values())
        big = path.split("_")[0]
        kernels[name][path].update(launches=round(per_pair[name][big] * LARGE_TIMED),
                                   launches_per_pair=per_pair[name][big])
    kernels["radius_knn"]["block_path"]["launches"] = block_launches


def large_model_phase(dev, card, kernels, cfg, ref, src, gt):
    """Phase 16: ``pipeline`` at ``cfg``'s width (``make_cfg()``, the phase-4
    bucket) with ``neighbor_limits`` ``LARGE_LIMITS`` and ``num_points_in_patch``
    ``LARGE_PATCH`` on the phase-4 pair: the model builds on the card, both
    kernels' large-shape paths launch inside the timed window, its 12
    searches equal the plain version, and the card's run against the CPU
    port's with the same weights by ``overfit_demo.hold_card_to_cpu`` (every
    table and node mask equal, the matched node pairs equal but for
    near-ties at the top-k boundary, plans through the common pairs, LGR on
    the CPU's plans, the card's model replayed on the CPU's node pairs):
    every check but the three poses' must hold, and no pose may fail.
    Returns the launches per pair by kernel and path."""
    import torch

    from rdmnet_tpu_torch.graph.pyramid import build_pair_batch, pad_cloud, search_plan
    from rdmnet_tpu_torch.models import RDMNet, pipeline
    from rdmnet_tpu_torch.models.rdmnet import STAGES
    from rdmnet_tpu_torch.ops.kernels import path_launch_counts, reset_launch_counts
    from rdmnet_tpu_torch.tools.overfit_demo import hold_card_to_cpu, report_text

    t_phase = time.perf_counter()
    big = dataclasses.replace(
        cfg, pyramid=dataclasses.replace(cfg.pyramid, neighbor_limits=LARGE_LIMITS),
        model=dataclasses.replace(cfg.model, num_points_in_patch=LARGE_PATCH))
    cap = big.pyramid.caps[0]
    model = RDMNet(big, device=dev, generator=torch.Generator().manual_seed(SEED))
    rp, rc = pad_cloud(ref, cap, device=dev)
    sp, sc = pad_cloud(src, cap, device=dev)
    for i in range(LARGE_WARM):
        pipeline(model, rp + 1e-6 * (i + 1), rc, sp, sc, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    outs = [pipeline(model, rp + 1e-6 * (i + 1), rc, sp, sc, device=dev)["estimated_transform"]
            for i in range(LARGE_TIMED)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / LARGE_TIMED
    paths = path_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if paths["radius_knn"]["select"] == 0 or paths["sinkhorn"]["cluster"] == 0:
        fail(f"large-shape phase: a large-shape path was not launched in the window: {paths}")
    if not all(bool(torch.isfinite(t).all()) for t in outs):
        fail("large-shape phase: non-finite estimated_transform")
    per_pair = {name: {path: n / LARGE_TIMED for path, n in per.items()}
                for name, per in paths.items()}
    stage_ms = {name: 0.0 for name in STAGES}
    for _ in range(LARGE_STAGE):
        marks = []

        def hook(name):
            torch.cuda.synchronize()
            marks.append((name, time.perf_counter()))

        torch.cuda.synchronize()
        prev = time.perf_counter()
        pipeline(model, rp, rc, sp, sc, device=dev, stage_hook=hook)
        for name, t in marks:
            stage_ms[name] += (t - prev) * 1e3 / LARGE_STAGE
            prev = t
    print(f"large-shape phase (neighbor_limits {LARGE_LIMITS}, num_points_in_patch "
          f"{LARGE_PATCH}, caps {big.pyramid.caps}, band caps {big.pyramid.band_caps}; {card}): "
          f"{dt * 1e3:.3f} ms/pair over {LARGE_TIMED} pairs, peak memory {peak / 2**20:.1f} MiB; "
          f"launches per pair {per_pair}; stages (ms, mean of {LARGE_STAGE} synchronised pairs) "
          + json.dumps({k: round(v, 3) for k, v in stage_ms.items()}))

    # its 12 searches against the plain version; the select-path ones summed
    batch = build_pair_batch(rp, rc, sp, sc, torch.eye(4, device=dev), big.pyramid)
    pts, cnts = pair_levels(batch, big.pyramid.num_stages)
    select, select_by = [0.0, 0.0, 0.0, 0.0], {"bytes": 0.0, "operations": 0.0}
    for item in search_plan(big.pyramid):
        ms, call_ms, pms, bound, work, plan = check_knn(pts, cnts, item, kernels)
        print(knn_line(f"large-shape {item.table}[{item.q_lvl}->{item.s_lvl}] "
                       f"Q={pts[item.q_lvl].shape[1]} S={pts[item.s_lvl].shape[1]} K={item.k} "
                       f"band={item.band}", ms, call_ms, pms, bound, plan, None)
              + f"; {work_text(work)}")
        if plan.sort_rows:
            select = [a + b for a, b in zip(select, (ms, call_ms, pms, bound))]
            select_by[work["by"]] += bound
    kernels["radius_knn"]["select_path"] = dict(
        shape=f"the {int(per_pair['radius_knn']['select'])} searches of a phase-16 pair at k = "
              f"{LARGE_LIMITS[0]}", ms=select[0], ms_per_call=select[1], plain_ms=select[2],
        bound_ms=select[3], bound_by=max(select_by, key=select_by.get), library_ms=None)
    print(f"large-shape phase: the {int(per_pair['radius_knn']['select'])} warp-select searches "
          f"of a pair {select[0]:.4f} ms on the device, {select[1]:.4f} ms in wrapper calls, "
          f"bound {select[3]:.5f} ms, plain {select[2]:.3f} ms ({card})")

    # a graph build whose level-0 search takes the block path: the same
    # pair's pyramid at a level-0 limit of 2048, set by hand
    dense = dataclasses.replace(big.pyramid, neighbor_limits=BLOCK_LIMITS)
    reset_launch_counts()
    dense_batch = build_pair_batch(rp, rc, sp, sc, torch.eye(4, device=dev), dense)
    torch.cuda.synchronize()
    block_paths = path_launch_counts()["radius_knn"]
    want_paths = {"list": 10, "select": 0, "block": 2}
    if block_paths != want_paths:
        fail(f"large-shape phase: the level-0 limit {BLOCK_LIMITS[0]} build launched "
             f"{block_paths}, not {want_paths}")
    dpts, dcnts = pair_levels(dense_batch, dense.num_stages)
    for item in search_plan(dense)[:2]:
        ms, call_ms, pms, bound, _, plan = check_knn(dpts, dcnts, item, kernels)
        print(knn_line(f"large-shape build at level-0 limit {BLOCK_LIMITS[0]}: {item.table}"
                       f"[{item.q_lvl}->{item.s_lvl}] K={item.k} band={item.band}", ms, call_ms,
                       pms, bound, plan, None)
              + f"; launches of the build {block_paths}; table equal to the plain version")

    # the card against the CPU port, same weights and inputs
    m_cpu = RDMNet(big, device="cpu", generator=torch.Generator().manual_seed(SEED))
    o_gpu = pipeline(model, rp, rc, sp, sc, device=dev)
    t0 = time.perf_counter()
    o_cpu = pipeline(m_cpu, *pad_cloud(ref, cap), *pad_cloud(src, cap), device="cpu")
    print(f"large-shape phase: the CPU port's pipeline {time.perf_counter() - t0:.3f} s")
    # at full width with random weights the top-256 of ~10^5 node-pair
    # scores has near-ties at its boundary, which the two devices' roundings
    # may break either way: hold_card_to_cpu accepts a pair only one side
    # matched at that side's boundary and holds the plans through the rest
    report = hold_card_to_cpu(big, model, o_gpu["batch"], o_cpu["batch"], o_gpu, o_cpu, gt)
    bad = [c for c in report["checks"]
           if c.status == "FAILED" or (c.name not in POSES and c.status != "ok")]
    print(f"large-shape phase, card vs CPU (CPU pose RRE {report['cpu_rre']:.3f} deg, RTE "
          f"{report['cpu_rte']:.3f} m); phase {time.perf_counter() - t_phase:.3f} s\n"
          + report_text(report))
    if bad:
        fail("large-shape phase: card vs CPU: " + "; ".join(c.text() for c in bad))
    return per_pair, block_paths["block"]


def group_model_phase(dev, card, kernels, cfg, ref, src):
    """Phase 16's group-path pass: ``pipeline`` at ``cfg``'s width (the
    phase-4 bucket and neighbour limits) with ``num_points_in_patch``
    ``GROUP_PATCH`` (K1 = 601) on the phase-4 pair. Inside the timed window
    every pair launches the 12 list-path searches and one group-path
    Sinkhorn; one more pair's Sinkhorn is held against the plain version on
    its own inputs (``sinkhorn_against_plain``). Prints ms/pair, per-stage ms
    (OT among them) and peak memory; no CPU pipeline at this shape. Returns
    the launches per pair by kernel and path."""
    import torch

    from rdmnet_tpu_torch.graph.pyramid import pad_cloud
    from rdmnet_tpu_torch.models import RDMNet, pipeline
    from rdmnet_tpu_torch.models.rdmnet import STAGES
    from rdmnet_tpu_torch.ops.kernels import path_launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    big = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                             num_points_in_patch=GROUP_PATCH))
    cap = big.pyramid.caps[0]
    model = RDMNet(big, device=dev, generator=torch.Generator().manual_seed(SEED))
    rp, rc = pad_cloud(ref, cap, device=dev)
    sp, sc = pad_cloud(src, cap, device=dev)
    for i in range(GROUP_WARM):
        pipeline(model, rp + 1e-6 * (i + 1), rc, sp, sc, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    outs = [pipeline(model, rp + 1e-6 * (i + 1), rc, sp, sc, device=dev)["estimated_transform"]
            for i in range(GROUP_TIMED)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / GROUP_TIMED
    paths = path_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {"radius_knn": {"list": 12 * GROUP_TIMED, "select": 0, "block": 0},
            "sinkhorn": {"register": 0, "cluster": 0, "group": GROUP_TIMED}}
    if paths != want:
        fail(f"group-path pass: launched {paths} in {GROUP_TIMED} pairs, not {want}")
    if not all(bool(torch.isfinite(t).all()) for t in outs):
        fail("group-path pass: non-finite estimated_transform")
    stage_ms = {name: 0.0 for name in STAGES}
    for _ in range(GROUP_STAGE):
        marks = []

        def hook(name):
            torch.cuda.synchronize()
            marks.append((name, time.perf_counter()))

        torch.cuda.synchronize()
        prev = time.perf_counter()
        pipeline(model, rp, rc, sp, sc, device=dev, stage_hook=hook)
        for name, t in marks:
            stage_ms[name] += (t - prev) * 1e3 / GROUP_STAGE
            prev = t
    ot, seen = model.optimal_transport, []
    handle = ot.register_forward_hook(
        lambda mod, args, kwargs, out: seen.append((args, kwargs, out)), with_kwargs=True)
    try:
        pipeline(model, rp, rc, sp, sc, device=dev)
    finally:
        handle.remove()
    (args, kwargs, got), = seen
    if got.shape[-1] != GROUP_PATCH + 1:
        fail(f"group-path pass: Sinkhorn ran on {tuple(got.shape)}, not K1 = {GROUP_PATCH + 1}")
    err = sinkhorn_against_plain(ot, args, kwargs, got, "group-path pass", "a pair's")
    kernels["sinkhorn"]["max_abs_err"] = max(kernels["sinkhorn"]["max_abs_err"], err)
    per_pair = {name: {path: n / GROUP_TIMED for path, n in per.items()}
                for name, per in paths.items()}
    print(f"group-path pass (num_points_in_patch {GROUP_PATCH}, caps {big.pyramid.caps}; "
          f"{card}): {dt * 1e3:.3f} ms/pair over {GROUP_TIMED} pairs, peak memory "
          f"{peak / 2**20:.1f} MiB; launches per pair {per_pair}; stages (ms, mean of "
          f"{GROUP_STAGE} synchronised pairs) "
          + json.dumps({k: round(v, 3) for k, v in stage_ms.items()})
          + f"; phase {time.perf_counter() - t_phase:.3f} s")
    return per_pair


DEMO_STEPS, DEMO_LOG = 150, 50  # phase 17 (a): overfit demo steps, evaluated at 1 and every 50
VOTE_SEEDS = (1, 2, 3, 4)        # phase 17 (b): target-draw seeds of the vote-rescue recipe
# phase 17 (b): true node pairs (of 32) from the port's own init seeded 0, the range of its
# draws 1-48 on the CPU (`python -m tests.test_torch_port_vote_rescue own 1-48`): summed over
# each of the 12 windows of four draws, and vote-off of one draw
VOTE_ON_MIN, VOTE_OFF_MAX, VOTE_CONTRAST_MIN, VOTE_OFF_MAX_DRAW = 7, 9, 0, 6


def learning_phase(dev, card, kernels, scan):
    """Phase 17: the learning loop on the card. (a) ``overfit_demo.run`` at
    ``make_cfg()`` width, 0.7 bucket, lr 5e-4, on ``scan`` (the phase-4 ref)
    against its copy moved by the demo's known pose, ``DEMO_STEPS`` steps
    from the seeded init, the batch built once: every logged metric finite,
    the mean loss of the last 10 steps below that of the first 10, and 12 kNN
    launches for the build, none in the train steps and one Sinkhorn launch
    (no kNN) per eval step. (b) the vote-rescue recipe (the seed-31337
    290-degree field-of-view pair, tiny config, 75 steps) from the port's
    seeded init for each target-draw seed of ``VOTE_SEEDS``, held to the
    range of the same recipe's draws on the CPU: summed over the draws, at
    least ``VOTE_ON_MIN`` true node pairs with the vote on, at most
    ``VOTE_OFF_MAX`` with it off, and at least ``VOTE_CONTRAST_MIN`` more on
    than off; each draw at most ``VOTE_OFF_MAX_DRAW`` off. Returns the launches of (a) by part and the
    number of eval steps."""
    import numpy as np

    from rdmnet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from rdmnet_tpu_torch.tools import overfit_demo

    t_phase = time.perf_counter()
    cfg = overfit_demo.demo_cfg()
    ref, src, tf_gt = overfit_demo.demo_pair(scan)
    print(f"learning phase (a): overfit demo at make_cfg() width, caps {cfg.pyramid.caps}, lr "
          f"{cfg.optim.lr}, {DEMO_STEPS} steps ({card}):")
    reset_launch_counts()
    demo = overfit_demo.run(cfg, ref, src, tf_gt, steps=DEMO_STEPS, log_every=DEMO_LOG,
                            device=dev)
    counts = launch_counts()
    if not all(np.isfinite(v) for r in demo.rows + [demo.final] for v in r.values()) \
            or not all(np.isfinite(demo.losses)):
        fail(f"learning phase: a non-finite metric in {demo.rows} {demo.final}")
    first, last = float(np.mean(demo.losses[:10])), float(np.mean(demo.losses[-10:]))
    if not last < first:
        fail(f"learning phase: the mean loss of the last 10 steps {last} is not below that of "
             f"the first 10 {first}")
    want = {"build": {"radius_knn": 12, "sinkhorn": 0}, "train": {"radius_knn": 0, "sinkhorn": 0},
            "eval": {"radius_knn": 0, "sinkhorn": demo.n_evals}}
    total = {name: sum(part[name] for part in demo.launches.values()) for name in counts}
    if demo.launches != want or counts != total:
        fail(f"learning phase: launches {demo.launches} (total {counts}), expected {want}")
    print(f"learning phase (a): mean loss steps 1-10 {first:.4f}, steps {DEMO_STEPS - 9}-"
          f"{DEMO_STEPS} {last:.4f}; {demo.rows[-1]['ms_per_step']:.3f} ms/step (batch built "
          f"once); launches: build {demo.launches['build']}, {DEMO_STEPS} train steps "
          f"{demo.launches['train']}, {demo.n_evals} eval steps {demo.launches['eval']}")

    vref, vsrc, vgt = overfit_demo.fov_pair()
    vcfg = overfit_demo.vote_rescue_cfg(vref, vsrc)
    pirs = []
    for seed in VOTE_SEEDS:
        t0 = time.perf_counter()
        pirs.append(overfit_demo.vote_rescue(vcfg, vref, vsrc, vgt, device=dev, draw_seed=seed))
        print(f"learning phase (b): vote rescue, draws seeded {seed}: vote-on PIR "
              f"{pirs[-1]['on']:.5f}, vote-off PIR {pirs[-1]['off']:.5f} "
              f"({time.perf_counter() - t0:.3f} s)")
    hits = [(round(p["on"] * 32), round(p["off"] * 32)) for p in pirs]
    on, off = sum(h[0] for h in hits), sum(h[1] for h in hits)
    print(f"learning phase (b): over seeds {VOTE_SEEDS}, {on} true node pairs of "
          f"{32 * len(pirs)} with the vote on, {off} with it off (held: on >= {VOTE_ON_MIN}, "
          f"off <= {VOTE_OFF_MAX}, on - off >= {VOTE_CONTRAST_MIN}; a draw's off <= "
          f"{VOTE_OFF_MAX_DRAW}); phase "
          f"{time.perf_counter() - t_phase:.3f} s")
    if on < VOTE_ON_MIN or off > VOTE_OFF_MAX or on - off < VOTE_CONTRAST_MIN or any(
            h[1] > VOTE_OFF_MAX_DRAW for h in hits):
        fail(f"learning phase: the vote rescue is outside the CPU draws' range: {pirs}")
    return demo.launches, demo.n_evals


PROGRAM_SIZES = (13000, 20000, 28000, 20000, 13000)  # phase 18: requests that rise, then fall
PROGRAM_WARM, PROGRAM_TURNS = 2, 6    # phase 18: per bucket, warm-up and timed turns of each kind
LOAD_CLIENTS, LOAD_REQUESTS = 8, 4    # phase 18: concurrent HTTP clients, requests each
EIGH_FITS = 100_000                   # phase 18: seeded random Horn fits for eigh4
NMS_DEVICE_ROWS = 1600                # phase 18: nms_peel past shared memory (M > 1348)
EIGH_GAP = 0.1                        # relative eigen-gap from which a fit is held within 1e-5
F32_UNIT = 2.0 ** -24                 # float32 unit roundoff
JACOBI_FLOPS = 6 * 50                 # eigh4: one sweep of six rotations, ~50 operations each
PROFILED_KERNELS = {"radius_knn": "radius_knn", "sinkhorn": "sinkhorn",  # kernel name parts
                    "segment_sums": "segment_sum_kernel", "nms_peel": "nms_peel_kernel",
                    "eigh4": "eigh4_top_kernel"}


def rotation_of(q):
    """(..., 4) unit quaternions (w, x, y, z) -> (..., 3, 3), Horn's formula."""
    import torch

    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def eigh4_against_plain(ks, where):
    """``eigh4_cuda`` on the (n, 4, 4) Horn matrices ``ks`` against the plain
    version (``torch.linalg.eigh``) through the rotation each top
    eigenvector gives (its sign is free). Fits whose top eigenvalue stands
    ``EIGH_GAP`` of the largest |eigenvalue| clear of the next are held
    within 1e-5; closer ones, where float32 fixes the vector only to ~u / gap
    in either solver, within max(1e-5, 32 u / gap), and a zero gap (a top
    eigenvector that is not unique) is not held. Prints the worst distance
    beside its gap; returns the worst distance of the held fits."""
    import torch

    from rdmnet_tpu_torch.ops.kernels.eigh4 import eigh4_cuda, top_eigenvector_plain

    got = rotation_of(eigh4_cuda(ks))
    # cuSOLVER's batched eigh refuses batches past some size: the plain version in chunks
    want = rotation_of(torch.cat([top_eigenvector_plain(k) for k in ks.split(8192)]))
    dist = (got - want).abs().flatten(1).amax(dim=1).double().cpu()
    vals = torch.linalg.eigvalsh(ks.double().cpu())
    gap = (vals[:, -1] - vals[:, -2]) / vals.abs().amax(dim=1).clamp_min(1e-300)
    held = gap >= EIGH_GAP
    close = ~held & (gap > 0)
    worst = float(dist[held].max()) if bool(held.any()) else 0.0
    limit = torch.clamp_min(32 * F32_UNIT / gap.clamp_min(1e-300), 1e-5)
    over = close & (dist > limit)
    # each solver against float64 (the CPU's eigh), where the gap leaves float32 some digits
    exact = rotation_of(torch.linalg.eigh(ks.double().cpu()).eigenvectors[..., -1])
    posed = gap >= 1e-3
    to64 = {name: float((r.double().cpu() - exact).abs().flatten(1).amax(dim=1)[posed].max())
            if bool(posed.any()) else 0.0 for name, r in (("eigh4", got), ("eigh", want))}
    i = int(torch.argmax(dist))
    bands = ", ".join(f"gap >= {g:g}: {int((gap >= g).sum())} fits, worst "
                      f"{float(dist[gap >= g].max()) if bool((gap >= g).any()) else 0.0:.3e}"
                      for g in (1e-2, 1e-3, 1e-4))
    print(f"{where}: eigh4 against torch.linalg.eigh on {len(ks)} fits: {int(held.sum())} with a "
          f"relative eigen-gap >= {EIGH_GAP} within {worst:.3e} of rotation; {int(close.sum())} "
          f"closer ({int((gap == 0).sum())} with no gap), each within max(1e-5, 32 u / gap); "
          f"{int((dist <= 1e-5).sum())} of all within 1e-5; {bands}; the worst fit "
          f"{float(dist[i]):.3e} at gap {float(gap[i]):.3e}; against float64 at gap >= 1e-3: "
          f"eigh4 {to64['eigh4']:.3e}, torch.linalg.eigh {to64['eigh']:.3e}")
    if worst > 1e-5 or bool(over.any()):
        fail(f"{where}: eigh4's rotation outside its tolerance")
    return worst


def peel_ops(adj, mask) -> int:
    """Word ANDs the peeling needs on this adjacency: each round, every active
    node reads its row's words up to its own (confirm) and every active node
    left unconfirmed does again (kill)."""
    import numpy as np

    adj, active = adj.cpu().numpy(), mask.cpu().numpy().copy()
    words = np.arange(adj.shape[1]) // 32 + 1
    ops = 0
    while active.any():
        has = (adj & active[:, None, :]).any(-1)
        confirm = active & ~has
        killed = (adj & confirm[:, None, :]).any(-1)
        ops += int(words[np.nonzero(active)[1]].sum()) + int(
            words[np.nonzero(active & ~confirm)[1]].sum())
        active = active & ~confirm & ~killed
    return ops


def held_to_eager(got, want, where):
    """A replayed program's outputs against the eager ``pipeline``'s: every
    table, count and ``dropped``, the NMS keep masks and rounds and the
    matched node pairs equal; the pose and the correspondence scores within
    1e-5. Returns (pose error, scores error, bit-equal)."""
    import torch

    for k in ("dropped", "nodes_ref_valid", "nodes_src_valid", "nms_rounds",
              "ref_node_corr_indices", "src_node_corr_indices", "node_corr_valid"):
        if not torch.equal(got[k], want[k]):
            fail(f"{where}: {k} differs between the replayed program and eager pipeline")
    for side in ("ref", "src"):
        for field in ("points", "counts", "neighbors", "subsampling", "upsampling"):
            for lvl, (a, b) in enumerate(zip(getattr(getattr(got["batch"], side), field),
                                             getattr(getattr(want["batch"], side), field))):
                if not torch.equal(a, b):
                    fail(f"{where}: {side} {field}[{lvl}] differs between replay and eager")
    pose = float((got["estimated_transform"] - want["estimated_transform"]).abs().max())
    scores = float((got["corr_scores"] - want["corr_scores"]).abs().max())
    if not pose <= 1e-5 or not scores <= 1e-5:
        fail(f"{where}: replay against eager: pose {pose:.3e}, scores {scores:.3e} > 1e-5")
    bit = all(torch.equal(got[k], want[k]) for k in (
        "estimated_transform", "corr_scores", "ref_corr_points", "src_corr_points",
        "matching_scores"))
    return pose, scores, bit


def program_phase(dev, card, kernels, cfg, model, ref, src):
    """Phase 18: the compiled serving program. Returns each new kernel's
    launches per pair in the captured program."""
    import numpy as np
    import torch
    from http.server import ThreadingHTTPServer
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import rdmnet_tpu_torch.ops.procrustes as procrustes
    from rdmnet_tpu_torch.cli.serve import make_handler
    from rdmnet_tpu_torch.config import make_cfg, make_parity_cfg
    from rdmnet_tpu_torch.data.procedural import procedural_pair
    from rdmnet_tpu_torch.graph.pyramid import pad_cloud
    from rdmnet_tpu_torch.models import RDMNet, capture_pipeline, pipeline, with_pyramid
    from rdmnet_tpu_torch.ops.grid_subsample import voxel_segments
    from rdmnet_tpu_torch.ops.kernels import all_launch_counts, reset_launch_counts
    from rdmnet_tpu_torch.ops.kernels.eigh4 import eigh4_cuda, top_eigenvector_plain
    from rdmnet_tpu_torch.ops.kernels.nms import nms_peel_cuda, nms_peel_plain
    from rdmnet_tpu_torch.ops.kernels.segment_sum import segment_sums_cuda, segment_sums_plain
    from rdmnet_tpu_torch.ops.nms import nms_adjacency
    from rdmnet_tpu_torch.ops.procrustes import cross_covariance, horn_matrix
    from rdmnet_tpu_torch.serving import SERVE_OUTPUTS, _pad_np, export_inference, load_exported

    t_phase = time.perf_counter()
    pyr = cfg.pyramid
    cap = pyr.caps[0]
    rp, rc = pad_cloud(ref, cap, device=dev)
    sp, sc = pad_cloud(src, cap, device=dev)

    # (a) no host sync between the upload and the fetch of an eager pipeline call;
    # the LGR fits' Horn matrices recorded on the way
    fits = []
    solve = procrustes.top_eigenvector
    procrustes.top_eigenvector = lambda k: (fits.append(k.detach().reshape(-1, 4, 4).clone()),
                                            solve(k))[1]
    pipeline(model, rp, rc, sp, sc, device=dev)
    torch.cuda.synchronize()
    fits.clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = pipeline(model, rp, rc, sp, sc, device=dev)
    except RuntimeError as e:
        fail(f"program: eager pipeline waited for the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
        procrustes.top_eigenvector = solve
    tf = out["estimated_transform"].cpu()
    print(f"program: eager pipeline at make_cfg(), bucket {cap}, under "
          f"set_sync_debug_mode('error') between the upload and the fetch: no host sync; "
          f"pose finite {bool(torch.isfinite(tf).all())}, NMS rounds {int(out['nms_rounds'])}")

    # (b) the new kernels against their plain versions at the main path's shapes
    batch = out["batch"]
    pts, cnts = pair_levels(batch, pyr.num_stages)
    seg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bytes=0, ops=0)
    voxel = pyr.voxel_size
    for lvl in range(1, pyr.num_stages):
        voxel *= 2.0
        spts, start, length, _, _ = voxel_segments(pts[lvl - 1], cnts[lvl - 1], voxel, pyr.caps[lvl])
        st32, ln32 = start.int().contiguous(), length.int().contiguous()
        got = segment_sums_cuda(spts, st32, ln32)
        want = segment_sums_plain(spts, start, length)
        if not torch.equal(got, want):
            fail(f"program: segment_sums differs from its plain version at level {lvl}")
        b, n, _ = spts.shape
        c = pyr.caps[lvl]
        ids = torch.full((b, n), c, dtype=torch.int64, device=dev)
        for i in range(b):
            seg_ids = torch.repeat_interleave(torch.arange(c, device=dev), length[i])
            ids[i, :len(seg_ids)] = seg_ids
        flat = (ids + torch.arange(b, device=dev)[:, None] * (c + 1)).reshape(-1)
        sink = torch.zeros((b * (c + 1), 3), device=dev)
        rows = spts.reshape(-1, 3)
        ms = graph_ms(lambda: segment_sums_cuda(spts, st32, ln32), reps=20)
        pms = cuda_ms(lambda: segment_sums_plain(spts, start, length), reps=3)
        lms = cuda_ms(lambda: sink.index_add_(0, flat, rows), reps=20)
        # the rows the kept segments hold (padding, invalid rows and dropped voxels are
        # never read), the starts and lengths, the sums
        nbytes = 12 * int(length.sum()) + b * c * 8 + b * c * 12
        ops = 3 * int(length.sum())
        bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_FLOPS else "operations"
        print(f"program: segment_sums level {lvl} ({b} x {n} rows, {int(length.sum())} of them in "
              f"{c} segments, the longest {int(length.max())}): bit-equal to the plain version; "
              f"kernel {ms:.4f} ms on the device, plain {pms:.3f} ms, index_add_ {lms:.4f} ms, "
              f"bound {bound:.6f} ms ({by}: {nbytes} bytes)")
        for key, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms), ("bound_ms", bound),
                       ("bytes", nbytes), ("ops", ops)):
            seg[key] += v
    rng = np.random.RandomState(SEED)
    # 2500 points in a 5 cm cube inside one 0.6 m voxel (the grid is anchored at the
    # scatter's minimum, ~-40.2 m: cells [7.2, 7.8) m), beside 6000 scattered points
    dense = np.concatenate([(rng.rand(2500, 3) * 0.05 + 7.3), (rng.rand(6000, 3) - 0.5) * 80])
    dense = torch.from_numpy(np.stack([dense, dense[::-1].copy()]).astype(np.float32)).to(dev)
    counts = torch.tensor([8500, 8000], dtype=torch.int32, device=dev)
    spts, start, length, _, _ = voxel_segments(dense, counts, 0.6, 4096)
    if not torch.equal(segment_sums_cuda(spts, start.int().contiguous(), length.int().contiguous()),
                       segment_sums_plain(spts, start, length)) or int(length.max()) < 2000:
        fail("program: segment_sums differs from its plain version on the dense voxel")
    print(f"program: segment_sums on a cloud with {int(length.max())} points in one voxel: "
          "bit-equal to the plain version")

    nodes = torch.stack([out["nodes_ref"], out["nodes_src"]])
    masks = torch.stack([out["ref_mask_c"], out["src_mask_c"]])
    adj = nms_adjacency(nodes, masks, cfg.vote.nms_radius, cfg.vote.nms_neighbor_limit)
    keep, rounds = nms_peel_cuda(adj, masks)
    pkeep, prounds = nms_peel_plain(adj, masks)
    valid = torch.stack([out["nodes_ref_valid"], out["nodes_src_valid"]])
    if not torch.equal(keep, pkeep) or int(rounds) != int(prounds) \
            or not torch.equal(keep & masks, valid) or int(rounds) != int(out["nms_rounds"]):
        fail("program: nms_peel differs from its plain version on the phase-4 nodes")
    nms_ms = graph_ms(lambda: nms_peel_cuda(adj, masks), reps=20)
    nms_pms = cuda_ms(lambda: nms_peel_plain(adj, masks), reps=3)
    # the strict-lower bytes of the valid nodes' rows (row i: its i columns j < i), the
    # mask read, keep written, a round count a cloud and their maximum
    nms_bytes = (int(masks.nonzero()[:, 1].sum()) + 2 * masks.numel()
                 + 4 * masks.shape[0] + 4)
    nms_ops = peel_ops(adj, masks)
    nms_bound = max(nms_bytes / HBM_BYTES_PER_S, nms_ops / F32_FLOPS) * 1e3
    nms_by = "bytes" if nms_bytes / HBM_BYTES_PER_S >= nms_ops / F32_FLOPS else "operations"
    chain = torch.zeros((2, 512, 3), device=dev)
    chain[..., 0] = torch.arange(512, device=dev) * 0.9 * cfg.vote.nms_radius
    chain_mask = torch.ones((2, 512), dtype=torch.bool, device=dev)
    chain_adj = nms_adjacency(chain, chain_mask, cfg.vote.nms_radius)
    ckeep, crounds = nms_peel_cuda(chain_adj, chain_mask)
    pck, pcr = nms_peel_plain(chain_adj, chain_mask)
    if not torch.equal(ckeep, pck) or int(crounds) != int(pcr) or int(crounds) < 200:
        fail(f"program: nms_peel on the chain: {int(crounds)} rounds against {int(pcr)}")
    print(f"program: nms_peel on the phase-4 nodes ({tuple(masks.shape)}, {int(rounds)} rounds): "
          f"keep masks and rounds equal to the plain version and to the pipeline's; on a "
          f"512-node chain 0.9 r apart: equal, {int(crounds)} rounds; kernel {nms_ms:.4f} ms on "
          f"the device (packing and peeling; the strict-lower rows: {nms_bytes} bytes, "
          f"{nms_ops} word ANDs), plain {nms_pms:.3f} ms, bound {nms_bound:.6f} ms ({nms_by}); "
          f"no PyTorch call computes it")
    # past 1348 nodes the packed rows leave shared memory for device memory: random nodes
    # (some masked) and a chain at M = 1600, the 1.0 bucket's coarse cap at scale 2.5
    big = NMS_DEVICE_ROWS
    side = 80.0 * (big / 640) ** 0.5
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rand_nodes = torch.rand((2, big, 3), generator=gen, device=dev) * torch.tensor(
        [side, side, 6.0], device=dev)
    rand_mask = torch.rand((2, big), generator=gen, device=dev) > 0.1
    long_chain = torch.zeros((2, big, 3), device=dev)
    long_chain[..., 0] = torch.arange(big, device=dev) * 0.9 * cfg.vote.nms_radius
    for what, n_, m_ in (("random nodes", rand_nodes, rand_mask),
                         ("a chain", long_chain, torch.ones((2, big), dtype=torch.bool,
                                                            device=dev))):
        big_adj = nms_adjacency(n_, m_, cfg.vote.nms_radius)
        before = nms_peel_cuda.path_launches["device"]
        bkeep, brounds = nms_peel_cuda(big_adj, m_)
        pbk, pbr = nms_peel_plain(big_adj, m_)
        if nms_peel_cuda.path_launches["device"] != before + 1:
            fail(f"program: nms_peel at M = {big} held its rows in shared memory")
        if not torch.equal(bkeep, pbk) or int(brounds) != int(pbr):
            fail(f"program: nms_peel at M = {big} ({what}, rows in device memory) differs "
                 f"from its plain version: {int(brounds)} rounds against {int(pbr)}")
        print(f"program: nms_peel at M = {big}, {what}, the rows in device memory: keep masks "
              f"and rounds ({int(brounds)}) equal to the plain version")

    lgr_worst = eigh4_against_plain(torch.cat(fits), "program: phase-4 LGR fits")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q = torch.randn((EIGH_FITS, 4), generator=gen, device=dev)
    rot = rotation_of(q / q.norm(dim=1, keepdim=True))
    fit_src = torch.randn((EIGH_FITS, 40, 3), generator=gen, device=dev) * 10
    fit_ref = (fit_src @ rot.transpose(1, 2)
               + torch.randn((EIGH_FITS, 1, 3), generator=gen, device=dev) * 3
               + torch.randn((EIGH_FITS, 40, 3), generator=gen, device=dev) * 0.05)
    h, _, _ = cross_covariance(fit_src, fit_ref, torch.rand((EIGH_FITS, 40), generator=gen,
                                                            device=dev))
    rand_worst = eigh4_against_plain(horn_matrix(h).contiguous(), "program: random fits")
    del fit_src, fit_ref, h
    batch_k, single_k = fits[0].contiguous(), fits[-1].contiguous()
    n_single = len(fits) - 1
    eig_ms = (graph_ms(lambda: eigh4_cuda(batch_k), reps=20)
              + n_single * graph_ms(lambda: eigh4_cuda(single_k), reps=20))
    eig_pms = (cuda_ms(lambda: top_eigenvector_plain(batch_k), reps=10)
               + n_single * cuda_ms(lambda: top_eigenvector_plain(single_k), reps=10))
    n_mats = len(batch_k) + n_single * len(single_k)
    eig_bytes, eig_ops = 80 * n_mats, JACOBI_FLOPS * n_mats
    eig_bound = max(eig_bytes / HBM_BYTES_PER_S, eig_ops / F32_FLOPS) * 1e3
    eig_by = "bytes" if eig_bytes / HBM_BYTES_PER_S >= eig_ops / F32_FLOPS else "operations"
    print(f"program: eigh4 per pair ({len(fits)} launches: {len(batch_k)} hypotheses, then "
          f"{n_single} single fits): kernel {eig_ms:.4f} ms on the device, torch.linalg.eigh "
          f"(the plain version, one PyTorch call) {eig_pms:.3f} ms, bound {eig_bound:.6f} ms "
          f"({eig_by}: {eig_bytes} bytes, at least {eig_ops} operations); rotation within "
          f"{lgr_worst:.3e} (LGR fits) and {rand_worst:.3e} ({EIGH_FITS} random fits)")
    kernels["segment_sums"].update(
        ms=seg["ms"], plain_ms=seg["plain_ms"], library_ms=seg["library_ms"],
        bound_ms=seg["bound_ms"], bound_by="bytes", max_abs_err=0.0)
    kernels["nms_peel"].update(ms=nms_ms, plain_ms=nms_pms, library_ms=None, bound_ms=nms_bound,
                               bound_by=nms_by, max_abs_err=0.0)
    kernels["eigh4"].update(ms=eig_ms, plain_ms=eig_pms, library_ms=eig_pms, bound_ms=eig_bound,
                            bound_by=eig_by, max_abs_err=max(lgr_worst, rand_worst))

    # (c) the programs: every bucket captured at load, launches counted at the capture
    full = make_cfg()
    weights = RDMNet(full, device="cpu", generator=torch.Generator().manual_seed(SEED))
    expected = {"radius_knn": 12, "sinkhorn": 1, "segment_sums": full.pyramid.num_stages - 1,
                "nms_peel": 1, "eigh4": 2 + full.fine_matching.num_refinement_steps}
    with tempfile.TemporaryDirectory() as out_dir:
        export_inference(full, weights, out_dir, bucket_scales=SERVE_SCALES)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated(dev)
        reserved = torch.cuda.memory_reserved(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        serve, meta = load_exported(out_dir)
        load_s = time.perf_counter() - t0
        counts = all_launch_counts()
    del weights
    resident = torch.cuda.memory_allocated(dev) - before
    reserved = torch.cuda.memory_reserved(dev) - reserved
    if sorted(serve.programs) != sorted(b["cap"] for b in meta["buckets"]):
        fail(f"program: buckets {sorted(serve.programs)} captured, artifact {meta['buckets']}")
    for c, program in serve.programs.items():
        if program.launches != expected:
            fail(f"program: bucket {c} launches {program.launches} at its capture, expected "
                 f"{expected}")
    if any(n == 0 for n in counts.values()):
        fail(f"program: a kernel was not launched by the capture: {counts}")
    print(f"program: load_exported on the card in {load_s:.3f} s, every bucket captured: "
          + ", ".join(f"{c}: {p.capture_s:.3f} s, {p.memory_bytes / 2**20:.1f} MiB of outputs"
                      for c, p in serve.programs.items())
          + f"; the load allocated {resident / 2**20:.1f} MiB and reserved {reserved / 2**20:.1f} "
          f"MiB (the weights and every bucket's graph memory pool); launches in each program "
          f"{expected}; the wrappers' counters over the load {counts}")

    # (d) each replay against the eager pipeline, requests rising then falling
    dense_ref, dense_src, _ = procedural_pair(SEED, n_rings=192, n_azimuths=6000)
    pick = np.random.RandomState(SEED + 18)
    requests = [(dense_ref[pick.permutation(len(dense_ref))[:n]],
                 dense_src[pick.permutation(len(dense_src))[:n]]) for n in PROGRAM_SIZES]
    requests.append((dense_ref, dense_src))
    views = {b["cap"]: with_pyramid(serve.model, b["cfg"].pyramid) for b in meta_buckets(meta)}

    def eager(r, s):
        c = next((c for c in sorted(views) if max(len(r), len(s)) <= c), max(views))
        eager.last_cap = c
        return pipeline(views[c], *_pad_np(r, c), *_pad_np(s, c), device=dev)

    def eager_serve(r, s):
        return {k: v.cpu().numpy() for k, v in eager(r, s).items() if k in SERVE_OUTPUTS}

    twins = []
    for i, (r, s) in enumerate(requests):
        direct = serve(r, s)
        c = serve.last_cap
        got = serve.programs[c].outputs
        want = eager(r, s)
        torch.cuda.synchronize()
        if eager.last_cap != c:
            fail(f"program: request {i} went to bucket {c}, eager to {eager.last_cap}")
        pose, scores, bit = held_to_eager(got, want, f"program: request {i} ({len(r)} points)")
        if not all(np.array_equal(direct[k], got[k].cpu().numpy()) for k in SERVE_OUTPUTS):
            fail(f"program: request {i}: serve's fetch differs from the program's outputs")
        twins.append({k: want[k].cpu().numpy() for k in SERVE_OUTPUTS})
        print(f"program: request {i}, {len(r)}/{len(s)} points -> bucket {c}: tables, NMS keep "
              f"masks and rounds ({int(got['nms_rounds'])}), matched node pairs equal to eager; "
              f"pose {pose:.3e}, scores {scores:.3e}, bit-equal {bit}")

    # (e) under load: concurrent HTTP clients, every answer its eager twin's
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(serve, meta))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/register"
    eager_server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(eager_serve, meta))
    eager_thread = threading.Thread(target=eager_server.serve_forever, daemon=True)
    eager_thread.start()
    eager_url = f"http://127.0.0.1:{eager_server.server_address[1]}/register"
    bodies = []
    for r, s in requests:
        buf = io.BytesIO()
        np.savez(buf, ref_points=r, src_points=s)
        bodies.append(buf.getvalue())
    answers, errors = [], []

    def client(cid):
        for j in range(LOAD_REQUESTS):
            i = (cid + j) % len(requests)
            status, data = post(url, bodies[i])
            if status != 200:
                errors.append(f"HTTP {status}")
                continue
            answers.append((i, dict(np.load(io.BytesIO(data)))))

    try:
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(cid,)) for cid in range(LOAD_CLIENTS)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=600)
        load_wall = time.perf_counter() - t0
        if errors or len(answers) != LOAD_CLIENTS * LOAD_REQUESTS:
            fail(f"program: {len(answers)} answers under load, errors {errors[:3]}")
        worst = 0.0
        for i, got in answers:
            twin = twins[i]
            sel = twin["corr_scores"] > 0
            if len(got["corr_scores"]) != int(sel.sum()) or not np.array_equal(
                    got["ref_corr_points"], twin["ref_corr_points"][sel]):
                fail(f"program: an answer under load differs from its eager twin (request {i})")
            worst = max(worst, float(np.abs(got["estimated_transform"]
                                            - twin["estimated_transform"]).max()))
        if worst > 1e-5:
            fail(f"program: a pose under load is {worst:.3e} from its eager twin")
        print(f"program: {LOAD_CLIENTS} HTTP clients x {LOAD_REQUESTS} requests at once in "
              f"{load_wall:.3f} s: every answer equal to its eager twin (correspondences equal, "
              f"poses within {worst:.3e})")

        # (f) per bucket: replay against eager in turns, direct, over HTTP, on a new thread
        kinds = ("replay direct", "replay HTTP", "replay thread", "eager direct", "eager HTTP",
                 "eager thread")
        seen = set()
        for i, (r, s) in enumerate(requests):
            serve(r, s)
            c = serve.last_cap
            if c in seen:
                continue
            seen.add(c)

            def call(kind):
                fn = serve if kind.startswith("replay") else eager_serve
                if kind.endswith("HTTP"):
                    status, _ = post(url if kind.startswith("replay") else eager_url, bodies[i])
                    if status != 200:
                        fail(f"program: HTTP {status} while timing bucket {c}")
                elif kind.endswith("thread"):
                    with ThreadPoolExecutor(max_workers=1) as worker:
                        worker.submit(fn, r, s).result()
                else:
                    fn(r, s)

            for _ in range(PROGRAM_WARM):
                for kind in kinds:
                    call(kind)
            ms = {kind: [] for kind in kinds}
            peaks = {}
            for turn in range(PROGRAM_TURNS):
                for kind in kinds[turn % 6:] + kinds[:turn % 6]:
                    torch.cuda.synchronize(dev)
                    torch.cuda.reset_peak_memory_stats(dev)
                    t0 = time.perf_counter()
                    call(kind)
                    ms[kind].append((time.perf_counter() - t0) * 1e3)
                    side = kind.split()[0]
                    peaks[side] = max(peaks.get(side, 0), torch.cuda.max_memory_allocated(dev))
            busy, seen_launches = {}, {}
            for side, fn in (("replay", serve), ("eager", eager_serve)):
                torch.cuda.synchronize(dev)
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    fn(r, s)
                    wall = (time.perf_counter() - t0) * 1e3
                events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                          and not getattr(e, "is_user_annotation", False)]
                kernel = sum(e.self_device_time_total for e in events) / 1e3
                busy[side] = (wall, kernel)
                seen_launches[side] = {name: sum(e.count for e in events if key in e.key)
                                       for name, key in PROFILED_KERNELS.items()}
            if seen_launches["replay"] != expected:
                fail(f"program: a profiled replay launched {seen_launches['replay']}, its "
                     f"program {expected}")
            print(f"program bucket {c} ({len(r)}/{len(s)} points), {PROGRAM_TURNS} turns after "
                  f"{PROGRAM_WARM} warm-up rounds, {card}: capture {serve.programs[c].capture_s:.3f} s\n"
                  + "\n".join(f"  {kind} ms/request {spread(ms[kind])}" for kind in kinds)
                  + "\n" + "\n".join(
                      f"  {side}: one profiled request {w:.3f} ms wall, {k:.3f} ms of kernel time "
                      f"({100 * k / w:.1f}% busy under the profiler)" for side, (w, k) in busy.items())
                  + f"\n  kernels in one profiled request: replay {seen_launches['replay']}, "
                  f"eager {seen_launches['eager']}"
                  + f"\n  peak memory allocated: replay {peaks['replay'] / 2**20:.1f} MiB (all "
                  f"buckets captured: their graphs' buffers sit in the {reserved / 2**20:.1f} MiB "
                  f"the load reserved), eager {peaks['eager'] / 2**20:.1f} MiB")
    finally:
        for srv, th in ((server, thread), (eager_server, eager_thread)):
            srv.shutdown()
            srv.server_close()
            th.join(timeout=60)
    per_pair = {k: v for k, v in expected.items() if k in ("segment_sums", "nms_peel", "eigh4")}
    del serve, views
    torch.cuda.empty_cache()

    # (g) more programs: phase 16's shapes (Sinkhorn's cluster and group paths), the parity
    # config and phase 11's other families, each capture's warm-up a check for host syncs
    r = dataclasses.replace
    parity = make_parity_cfg()
    shapes = {
        "cluster": r(cfg, pyramid=r(cfg.pyramid, neighbor_limits=LARGE_LIMITS),
                     model=r(cfg.model, num_points_in_patch=LARGE_PATCH)),
        "group": r(cfg, model=r(cfg.model, num_points_in_patch=GROUP_PATCH)),
        "parity": r(parity, pyramid=parity.pyramid.scaled(0.7)),
        **family_cfgs(cfg),
    }
    for name, c in shapes.items():
        m = RDMNet(c, device=dev, generator=torch.Generator().manual_seed(SEED))
        if name == "parity":
            rotate_kernel_points(m, SEED)
        program = capture_pipeline(m, dev)
        if name in ("cluster", "group") and program.path_launches["sinkhorn"][name] != 1:
            fail(f"program: the {name}-path model's program launches {program.path_launches}")
        c_cap = c.pyramid.caps[0]
        args = (*pad_cloud(ref, c_cap, device=dev), *pad_cloud(src, c_cap, device=dev))
        # replayed twice: a replay must find the group path's scratch zeroed again
        # (its torch.zeros is a captured fill, run by every replay)
        for replay in range(2):
            got = program(ref[:c_cap], min(len(ref), c_cap), src[:c_cap], min(len(src), c_cap))
            want = pipeline(m, *args, device=dev)
            torch.cuda.synchronize()
            pose, scores, bit = held_to_eager(got, want, f"program: {name}, replay {replay}")
        print(f"program: the {name} model ({c.model.coarse_module}, K1 "
              f"{c.model.num_points_in_patch + 1}) captured with no host sync in "
              f"{program.capture_s:.3f} s, launches {program.launches}, Sinkhorn's path "
              f"{[k for k, n in program.path_launches['sinkhorn'].items() if n]}; two replays "
              f"against eager: tables, keep masks, node pairs equal, pose {pose:.3e}, scores "
              f"{scores:.3e}, bit-equal {bit}")
        del program, m, got, want
        torch.cuda.empty_cache()
    print(f"program phase: {time.perf_counter() - t_phase:.1f} s")
    return per_pair


TRAIN_PROGRAM_STEPS = 7      # phase 19 (b): train steps held bit for bit against the eager twin
TRAIN_PROGRAM_NAN = 4        # phase 19 (b): the step whose ground truth holds a NaN (a replay)
ACC_PROGRAM_STEPS = 6        # phase 19 (c): micro-batches at grad_acc_steps 2 (three groups)
ACC_PROGRAM_NAN = 3          # phase 19 (c): the NaN micro-batch (the second group's last)
EVAL_PROGRAM_VALID = ((True, True), (True, False), (True, True), (False, True))  # (d), 2 pairs
TRAIN_PROGRAM_TURNS = 4      # phase 19 (g): timed turns of a replayed and an eager step
ITER_FIRST, ITER_RESUMED = 6, 9  # phase 19 (i): iterations of the first run and the resumed one
ITER_SNAPSHOT, ITER_VAL = 3, 2   # phase 19 (i): snapshot and validation every so many iterations
PARTS = ("build", "forward", "losses", "backward", "optimizer")


def moved_pairs(ref, src, gt, cap, n, seed):
    """``n`` one-pair host batches: the phase-4 pair with its src moved by
    seeded rigid motions (up to 10 degrees about z and 1 m), the ground
    truth following each motion."""
    import numpy as np

    from rdmnet_tpu_torch.tools.overfit_demo import host_batch

    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        a = np.deg2rad(rng.uniform(-10, 10))
        m = np.eye(4)
        m[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        m[:3, 3] = rng.uniform(-1, 1, 3)
        moved = (src.astype(np.float64) @ m[:3, :3].T + m[:3, 3]).astype(np.float32)
        out.append(host_batch(ref, moved, (gt.astype(np.float64) @ np.linalg.inv(m)), cap))
    return out


def bits(t):
    """A tensor's bytes, flattened: equal bits compare equal, NaNs included."""
    import torch

    return t.detach().reshape(-1).contiguous().view(torch.uint8)


def state_bits(state):
    """Every tensor a train step writes, as bytes per kind: weights, Adam's
    moments and steps, the counters, the accumulator."""
    import torch

    opt = [state.optimizer.state[p] for p in state.params if p in state.optimizer.state]
    parts = {"weights": state.params, "exp_avg": [s["exp_avg"] for s in opt],
             "exp_avg_sq": [s["exp_avg_sq"] for s in opt], "adam step": [s["step"] for s in opt],
             "counters": list(state.counters.values()), "lr": [state.lr],
             "accumulator": state.accumulator or []}
    return {k: torch.cat([bits(t) for t in v]) if v else None for k, v in parts.items()}


def held_bitwise(got, want, where):
    """Two dicts of tensors (or of bytes) equal bit for bit."""
    import torch

    if sorted(got) != sorted(want):
        fail(f"{where}: keys {sorted(got)} against {sorted(want)}")
    for k in got:
        if got[k] is None and want[k] is None:
            continue
        if not torch.equal(bits(got[k]), bits(want[k])):
            fail(f"{where}: {k} differs between the replayed program and the eager step")


def twin_run(dev, c, batches, nan_at, where, group=None, gen_seed=SEED + 19, trace=None):
    """The train program against an eager twin from the same weights,
    generator state and batches, held bit for bit after every step: the
    metrics, every tensor the step writes and the generators' states. The
    step at ``nan_at`` (a NaN in its ground truth, on this rank or another
    of ``group``) must leave the weights and ``count`` as they were and count
    one non-finite step. With a data-parallel ``group`` both step over it
    (the program and the eager step each exchange their gradients) and
    ``trace`` gets the digest of the state after each step. Returns
    (program, its state, the eager state, the eager step, the two
    generators)."""
    import torch

    from rdmnet_tpu_torch.engine import (batch_to_device, capture_train_step,
                                         create_train_state, make_train_step)
    from rdmnet_tpu_torch.models import RDMNet

    world = 1 if group is None else torch.distributed.get_world_size(group)
    states = [create_train_state(c, RDMNet(c, device=dev,
                                           generator=torch.Generator().manual_seed(SEED)),
                                 dp_size=world)
              for _ in range(2)]
    gens = [torch.Generator(device=dev).manual_seed(gen_seed) for _ in range(2)]
    program = capture_train_step(states[0], c, 1, gens[0], dev, group)
    step = make_train_step(c, dev, group)
    held_bitwise(state_bits(states[0]), state_bits(states[1]), f"{where}: the starting states")
    for i, host in enumerate(batches):
        before = state_bits(states[0])
        got = program(host)
        _, want = step(states[1], batch_to_device(host, c.pyramid, dev), gens[1])
        held_bitwise(got, want, f"{where}: step {i} metrics")
        after = state_bits(states[0])
        held_bitwise(after, state_bits(states[1]), f"{where}: step {i} state")
        if trace is not None:
            trace.append(_sha1(t for t in after.values() if t is not None))
        if not torch.equal(gens[0].get_state(), gens[1].get_state()):
            fail(f"{where}: step {i}: the program's generator stands elsewhere than the "
                 "eager one's")
        finite = bool(torch.isfinite(got["grad_norm"]))
        if (i == nan_at) == finite:
            fail(f"{where}: step {i}: grad_norm {float(got['grad_norm'])}, a NaN step at {nan_at}")
        if i == nan_at:
            if not torch.equal(before["weights"], after["weights"]) \
                    or not torch.equal(before["exp_avg"], after["exp_avg"]) \
                    or states[0].notfinite_count != 1:
                fail(f"{where}: the non-finite step {i} moved the weights or the moments, or "
                     f"counted {states[0].notfinite_count} non-finite steps")
    return program, states[0], states[1], step, gens


def profiled_kernels(fn, dev):
    """``fn()`` under the profiler: (wall ms, kernel ms, launches of the
    port's kernels by name, the profiler's events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False) and not e.key.startswith("part:")]
    kernel = sum(e.self_device_time_total for e in events) / 1e3
    seen = {name: sum(e.count for e in events if key in e.key)
            for name, key in PROFILED_KERNELS.items()}
    return wall, kernel, seen, prof


def parts_of_step(prof, marks):
    """Kernel ms by part of a profiled eager step: each operator's own
    kernels go to the part whose host window (``marks``, the
    ``record_function`` ranges named ``part:<name>``) holds the operator's
    start, whatever thread launched it (the backward runs on autograd's).
    Returns {part: (ms, [(ms, operator), ...] by ms)}."""
    from torch.autograd import DeviceType

    events = prof.events()
    # the host ranges only: each range also has a device-side annotation, on the
    # device's later timeline
    windows = [(e.name[5:], e.time_range.start, e.time_range.end) for e in events
               if e.name.startswith("part:") and e.device_type == DeviceType.CPU]
    out = {name: [0.0, {}] for name, _, _ in windows}
    for e in events:
        if e.device_type != DeviceType.CPU or e.name.startswith("part:") \
                or e.self_device_time_total <= 0:
            continue
        for name, start, end in windows:
            if start <= e.time_range.start <= end:
                out[name][0] += e.self_device_time_total / 1e3
                ops = out[name][1]
                ops[e.name] = ops.get(e.name, 0.0) + e.self_device_time_total / 1e3
                break
    return {k: (ms, sorted(((v, op) for op, v in ops.items()), reverse=True))
            for k, (ms, ops) in out.items()}


def iter_trainer_check(dev, card, cfg, root, tmp):
    """Phase 19 (i): ``IterBasedTrainer`` on ``root`` for ``ITER_FIRST``
    iterations (validation every ``ITER_VAL``, a snapshot every
    ``ITER_SNAPSHOT``), then on the same object resumed from its last
    snapshot to ``ITER_RESUMED``, on the programs and kept eager: every
    logged line, step's metrics and validation record and the final weights
    bit-equal, and the resumed run on a program captured after the
    restore."""
    import logging

    import torch

    from rdmnet_tpu_torch.data.datasets import RegistrationPairDataset
    from rdmnet_tpu_torch.data.loader import PairLoader
    from rdmnet_tpu_torch.engine.iter_trainer import IterBasedTrainer
    from rdmnet_tpu_torch.engine.meters import to_floats

    class Lines(logging.Handler):
        def __init__(self):
            super().__init__()
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    t, cap = cfg.train, cfg.pyramid.caps[0]
    runs = {}
    for kind in ("programs", "eager"):
        train = RegistrationPairDataset(
            "kitti", root=root, subset="train", point_limit=t.point_limit,
            use_augmentation=t.use_augmentation, augmentation_noise=t.augmentation_noise,
            augmentation_min_scale=t.augmentation_min_scale,
            augmentation_max_scale=t.augmentation_max_scale,
            augmentation_shift=t.augmentation_shift,
            augmentation_rotation=t.augmentation_rotation, seed=cfg.seed)
        val = RegistrationPairDataset("kitti", root=root, subset="val", point_limit=t.point_limit)
        trainer = IterBasedTrainer(
            cfg, PairLoader(train, cap=cap, batch_size=t.batch_size, shuffle=True, drop_last=True,
                            seed=cfg.seed),
            PairLoader(val, cap=cap, batch_size=t.batch_size), output_dir=os.path.join(tmp, kind),
            log_steps=1, device=dev, max_iterations=ITER_FIRST, snapshot_every=ITER_SNAPSHOT,
            val_every=ITER_VAL)
        if kind == "eager":
            trainer.use_programs = False
        lines = Lines()
        trainer.logger.addHandler(lines)
        steps, vals = [], []
        train_batch, validate = trainer._train_batch, trainer.validate

        def recorded(np_batch):
            metrics = train_batch(np_batch)
            steps.append(to_floats(metrics))
            return metrics

        trainer._train_batch = recorded
        trainer.validate = lambda: vals.append(validate()) or vals[-1]
        t0 = time.perf_counter()
        trainer.run()
        first = (trainer.train_program, trainer.eval_program)
        trainer.max_iterations = ITER_RESUMED
        trainer.run(resume=True)
        trainer.logger.removeHandler(lines)
        runs[kind] = dict(steps=steps, vals=vals, lines=lines.lines,
                          weights=_sha1(trainer.state.params), seconds=time.perf_counter() - t0,
                          first=[p is not None and p.graph is not None for p in first],
                          after=(trainer.train_program is not None
                                 and trainer.train_program is not first[0]
                                 and trainer.train_program.graph is not None),
                          iteration=trainer.iteration)
        del trainer, first
        torch.cuda.empty_cache()
    got, want = runs["programs"], runs["eager"]
    if got["first"] != [True, True] or not got["after"] or got["iteration"] != ITER_RESUMED:
        fail(f"iter trainer: programs captured in the first run {got['first']}, a new train "
             f"program captured after the restore {got['after']}, iteration {got['iteration']}")
    for key in ("steps", "vals", "lines", "weights"):
        if got[key] != want[key]:
            fail(f"iter trainer: {key} on the programs differ from the eager run's")
    n_resumed = ITER_RESUMED - (ITER_FIRST // ITER_SNAPSHOT) * ITER_SNAPSHOT
    print(f"train program (i): IterBasedTrainer on phase 10's root, {ITER_FIRST} iterations "
          f"(validation every {ITER_VAL}, a snapshot every {ITER_SNAPSHOT}), then resumed on the "
          f"same object to {ITER_RESUMED}: {len(got['steps'])} steps' metrics, "
          f"{len(got['vals'])} validation records, {len(got['lines'])} logged lines and the final "
          f"weights bit-equal to the eager run; both programs captured in the first run, the "
          f"train program captured anew after the restore ({n_resumed} steps); "
          f"{got['seconds']:.3f} s on the programs, {want['seconds']:.3f} s eager ({card})")


def train_program_phase(dev, card, kernels, cfg, ref, src, gt, scan=WORKFLOW_SCAN, cli_args=()):
    """Phase 19: the Trainer's compiled programs. (e) and (i) train on phase
    10's root written with ``scan``; ``cli_args`` go to (e)'s CLI. Returns the
    launches a pair in the train and the eval program."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType

    import rdmnet_tpu_torch.engine.trainer as trainer_mod
    from rdmnet_tpu_torch.cli import trainval
    from rdmnet_tpu_torch.engine import (batch_to_device, capture_eval_step, create_train_state,
                                         make_eval_step, make_train_step)
    from rdmnet_tpu_torch.engine.train_step import batch_inputs, build_batch
    from rdmnet_tpu_torch.models import RDMNet
    from rdmnet_tpu_torch.ops.kernels import all_launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    spec = cfg.pyramid
    cap = spec.caps[0]
    pairs = moved_pairs(ref, src, gt, cap, max(TRAIN_PROGRAM_STEPS, 8), SEED + 19)
    nan_pair = {k: v.copy() for k, v in pairs[TRAIN_PROGRAM_NAN].items()}
    nan_pair["transform"][0, 0, 3] = np.nan
    acc_nan_pair = {k: v.copy() for k, v in pairs[ACC_PROGRAM_NAN].items()}
    acc_nan_pair["transform"][0, 0, 3] = np.nan

    # (a) no host sync between the upload and the fetch of an eager train and eval step
    state = create_train_state(cfg, RDMNet(cfg, device=dev,
                                           generator=torch.Generator().manual_seed(SEED)))
    step, evaluate = make_train_step(cfg, dev), make_eval_step(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    inputs = {k: torch.tensor(v, device=dev) for k, v in batch_inputs(pairs[0]).items()}
    reset_launch_counts()
    step(state, build_batch(inputs, spec), gen)  # lazy set-up (cuBLAS, Adam's state) first
    train_launches = all_launch_counts()
    reset_launch_counts()
    evaluate(state, build_batch(inputs, spec))
    eval_launches = all_launch_counts()
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, metrics = step(state, build_batch(inputs, spec), gen)
        ev, tfs = evaluate(state, build_batch(inputs, spec))
    except RuntimeError as e:
        fail(f"train program: an eager step waited for the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not all(bool(torch.isfinite(v)) for v in metrics.values()) or \
            not bool(torch.isfinite(tfs).all()) or state.count != 2:
        fail(f"train program: the checked steps gave {metrics}, {ev}, count {state.count}")
    if train_launches["radius_knn"] != 12 or train_launches["sinkhorn"] != 0 or \
            {k: eval_launches[k] for k in ("radius_knn", "sinkhorn", "segment_sums", "nms_peel",
                                          "eigh4")} != \
            {"radius_knn": 12, "sinkhorn": 1, "segment_sums": spec.num_stages - 1,
             "nms_peel": 1, "eigh4": 2 + cfg.fine_matching.num_refinement_steps}:
        fail(f"train program: eager launches {train_launches} a train pair, {eval_launches} an "
             f"eval pair")
    print(f"train program: one eager train step and one eval step at make_cfg(), bucket {cap}, "
          f"each with its graph build, under set_sync_debug_mode('error') between the upload "
          f"and the fetch: no host sync; launches a train pair {train_launches}, an eval pair "
          f"{eval_launches}")
    del state, inputs, metrics, ev, tfs

    # (b) the train program against its eager twin, a NaN step among them
    batches = pairs[:TRAIN_PROGRAM_STEPS]
    batches[TRAIN_PROGRAM_NAN] = nan_pair
    program, p_state, e_state, e_step, gens = twin_run(dev, cfg, batches, TRAIN_PROGRAM_NAN,
                                                       "train program")
    if program.launches != train_launches:
        fail(f"train program: {program.launches} launches at the capture, the eager step "
             f"{train_launches}")
    print(f"train program: {TRAIN_PROGRAM_STEPS} steps (2 eager warm-ups, the capture, "
          f"replays; a NaN ground truth at step {TRAIN_PROGRAM_NAN}) against the eager step "
          f"from the same weights, generator and batches: losses, grad_norm, weights, Adam's "
          f"moments and steps, lr, count and notfinite_count bit-equal after every step, the "
          f"generators at one offset; the NaN step skipped (weights and moments unchanged, "
          f"count {p_state.count}, notfinite_count reset by the next finite step to "
          f"{p_state.notfinite_count}); captured in {program.capture_s:.3f} s, "
          f"{program.memory_bytes / 2**10:.1f} KiB kept (its outputs), "
          f"{program.reserved_bytes / 2**20:.1f} MiB reserved (its graph pool), launches "
          f"{program.launches}")

    # (c) accumulation: one program for every micro-batch of a group
    acc_cfg = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, grad_acc_steps=2))
    acc_batches = pairs[:ACC_PROGRAM_STEPS]
    acc_batches[ACC_PROGRAM_NAN] = acc_nan_pair
    acc_program, acc_state, _, _, _ = twin_run(dev, acc_cfg, acc_batches, ACC_PROGRAM_NAN,
                                               "train program, grad_acc_steps 2")
    if acc_state.count != 2 or acc_state.mini_step != 0:
        fail(f"train program, grad_acc_steps 2: count {acc_state.count}, mini_step "
             f"{acc_state.mini_step} after three groups, the second non-finite")
    print(f"train program, grad_acc_steps 2: {ACC_PROGRAM_STEPS} micro-batches (three groups, "
          f"the second's last with a NaN ground truth) bit-equal to the eager steps after every "
          f"micro-batch, accumulator included; {acc_state.count} updates applied")
    del acc_program, acc_state
    torch.cuda.empty_cache()

    # (d) the eval program on two pairs a batch, valid weighting included
    e_program = capture_eval_step(e_state, cfg, 2, dev)
    e_eval = make_eval_step(cfg, dev)
    for i, valid in enumerate(EVAL_PROGRAM_VALID):
        host = {k: np.concatenate([pairs[(2 * i) % 8][k], pairs[(2 * i + 1) % 8][k]])
                for k in pairs[0]}
        got, got_tf = e_program(host, np.array(valid))
        want, want_tf = e_eval(e_state, batch_to_device(host, spec, dev), torch.tensor(valid))
        held_bitwise(got, want, f"eval program: batch {i} metrics")
        held_bitwise({"transforms": got_tf}, {"transforms": want_tf},
                     f"eval program: batch {i}")
    per_eval_pair = {k: v / 2 for k, v in e_program.launches.items()}
    if per_eval_pair != {k: float(v) for k, v in eval_launches.items()}:
        fail(f"eval program: {e_program.launches} launches for two pairs at the capture, the "
             f"eager step {eval_launches} a pair")
    print(f"eval program: {len(EVAL_PROGRAM_VALID)} batches of two pairs (valid "
          f"{EVAL_PROGRAM_VALID}; 2 eager warm-ups, the capture, a replay) against the eager "
          f"step: metrics and transforms bit-equal; captured in {e_program.capture_s:.3f} s, "
          f"{e_program.memory_bytes / 2**10:.1f} KiB kept, "
          f"{e_program.reserved_bytes / 2**20:.1f} MiB reserved, launches {e_program.launches}")

    # (f) a profiled replay of each launches exactly what its capture counted
    for name, prog, call in (("train", program, lambda: program(pairs[0])),
                             ("eval", e_program, lambda: e_program(
                                 {k: np.concatenate([pairs[0][k], pairs[1][k]])
                                  for k in pairs[0]}))):
        _, _, seen, _ = profiled_kernels(call, dev)
        if seen != {k: prog.launches[k] for k in PROFILED_KERNELS}:
            fail(f"{name} program: a profiled replay launched {seen}, its capture counted "
                 f"{prog.launches}")
        print(f"{name} program: a profiled replay launched {seen}, as its capture counted")
    step(e_state, batch_to_device(pairs[0], spec, dev), gens[1])  # the twin takes that step too
    held_bitwise(state_bits(p_state), state_bits(e_state), "train program: after the profiled step")

    # (g) replayed against eager steps in turns; the parts of a step's kernels
    ms = {"replay": [], "eager": []}
    peaks = {}
    for turn in range(TRAIN_PROGRAM_TURNS):
        host = pairs[turn % 8]
        for kind in (("replay", "eager") if turn % 2 == 0 else ("eager", "replay")):
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            if kind == "replay":
                got = program(host)
            else:
                _, want = e_step(e_state, batch_to_device(host, spec, dev), gens[1])
            torch.cuda.synchronize(dev)
            ms[kind].append((time.perf_counter() - t0) * 1e3)
            peaks[kind] = max(peaks.get(kind, 0), torch.cuda.max_memory_allocated(dev))
        held_bitwise(got, want, f"train program: timed turn {turn}")
    held_bitwise(state_bits(p_state), state_bits(e_state), "train program: after the timed turns")
    eval_ms = {"replay": [], "eager": []}
    for turn in range(TRAIN_PROGRAM_TURNS):
        host = {k: np.concatenate([pairs[turn % 8][k], pairs[(turn + 1) % 8][k]]) for k in pairs[0]}
        for kind in (("replay", "eager") if turn % 2 == 0 else ("eager", "replay")):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            if kind == "replay":
                got_ev = e_program(host)
            else:
                want_ev = e_eval(e_state, batch_to_device(host, spec, dev))
            torch.cuda.synchronize(dev)
            eval_ms[kind].append((time.perf_counter() - t0) * 1e3 / 2)
        held_bitwise(got_ev[0], want_ev[0], f"eval program: timed turn {turn}")
    r_wall, r_kernel, r_seen, r_prof = profiled_kernels(lambda: program(pairs[1]), dev)
    marks = []

    def part_hook(name):
        marks[-1].__exit__(None, None, None)
        nxt = PARTS.index(name) + 1
        if nxt < len(PARTS):
            marks.append(torch.profiler.record_function(f"part:{PARTS[nxt]}"))
            marks[-1].__enter__()

    def eager_parts():
        marks.append(torch.profiler.record_function("part:build"))
        marks[-1].__enter__()
        batch = batch_to_device(pairs[1], spec, dev)
        part_hook("build")
        e_step(e_state, batch, gens[1], stage_hook=part_hook)

    e_wall, e_kernel, e_seen, e_prof = profiled_kernels(eager_parts, dev)
    held_bitwise(state_bits(p_state), state_bits(e_state), "train program: after the profiled pair")
    parts = parts_of_step(e_prof, marks)
    r_events = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                       for e in r_prof.key_averages() if e.self_device_time_total > 0
                       and not getattr(e, "is_user_annotation", False)
                       and e.device_type == DeviceType.CUDA),
                      reverse=True)
    print(f"train program: replayed against eager steps in {TRAIN_PROGRAM_TURNS} turns "
          f"({card}): replay ms/step {spread(ms['replay'])}, eager {spread(ms['eager'])}; one "
          f"profiled replay {r_wall:.3f} ms wall, {r_kernel:.3f} ms of kernels "
          f"({100 * r_kernel / r_wall:.1f}% busy), one profiled eager step {e_wall:.3f} ms wall, "
          f"{e_kernel:.3f} ms of kernels ({100 * e_kernel / e_wall:.1f}% busy); peak memory "
          f"allocated: replay "
          f"{peaks['replay'] / 2**20:.1f} MiB (the graph's buffers sit in its pool's "
          f"{program.reserved_bytes / 2**20:.1f} MiB), eager {peaks['eager'] / 2**20:.1f} MiB; "
          f"the eval step on two pairs, ms a pair: replay {spread(eval_ms['replay'])}, eager "
          f"{spread(eval_ms['eager'])}")
    attributed = sum(ms for ms, _ in parts.values())
    print(f"train program: kernel ms by part of the profiled eager step, {attributed:.3f} ms "
          f"of its {e_kernel:.3f} attributed (the replay runs the same kernels: "
          f"{r_kernel:.3f} ms, launches {r_seen} / {e_seen}):")
    for part in PARTS:
        p_ms, ops = parts.get(part, (0.0, []))
        print(f"  {part:9s} {p_ms:9.3f} ms  "
              + "; ".join(f"{op[:48]} {v:.3f}" for v, op in ops[:4]))
    print("train program: the replay's top kernels by device ms:")
    for v, n, key in r_events[:8]:
        print(f"  {v:9.3f} ms  {n:5d} launches  {key[:90]}")
    del program, e_program, p_state, e_state, got, want
    torch.cuda.empty_cache()

    # (e) the Trainer through cli.trainval on its programs against an eager Trainer
    class Recorded(trainer_mod.SummaryBoard):
        rows = []

        def update_from_dict(self, d):
            Recorded.rows.append(dict(d))
            super().update_from_dict(d)

    init = trainer_mod.Trainer.__init__

    def eager_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.use_programs = False

    runs = {}
    orig_board = trainer_mod.SummaryBoard
    trainer_mod.SummaryBoard = Recorded
    tmp_dir = tempfile.TemporaryDirectory()  # phase 10's root, for (e) and (i)
    tmp = tmp_dir.name
    try:
        write_workflow_root(os.path.join(tmp, "kitti"), scan=scan)
        for kind in ("programs", "eager"):
            Recorded.rows = []
            out_dir = os.path.join(tmp, kind)
            if kind == "eager":
                trainer_mod.Trainer.__init__ = eager_init
            t0 = time.perf_counter()
            try:
                trainer = trainval.main(["--root", os.path.join(tmp, "kitti"),
                                         "--output_dir", out_dir,
                                         "--bucket_scale", "0.7", "--log_steps", "2",
                                         "--keep_snapshots", "1", "--max_epoch", "2",
                                         "--device", dev.type, *cli_args])
            finally:
                trainer_mod.Trainer.__init__ = init
            wall = time.perf_counter() - t0
            with open(os.path.join(out_dir, "metrics.jsonl")) as f:
                records = [json.loads(line) for line in f]
            runs[kind] = dict(records=records, rows=list(Recorded.rows), wall=wall,
                              timings=trainer.epoch_timings, vals=trainer.val_timings,
                              programs=trainer.use_programs,
                              captured=(trainer.train_program is not None,
                                        trainer.eval_program is not None))
            del trainer
            torch.cuda.empty_cache()
    finally:
        trainer_mod.SummaryBoard = orig_board
    if runs["programs"]["captured"] != (True, True) or runs["eager"]["programs"]:
        fail(f"train program: the Trainer's programs {runs['programs']['captured']}, the eager "
             f"Trainer's {runs['eager']['programs']}")
    if runs["programs"]["records"] != runs["eager"]["records"]:
        fail(f"train program: metrics.jsonl on the programs {runs['programs']['records']} "
             f"against eager {runs['eager']['records']}")
    if runs["programs"]["rows"] != runs["eager"]["rows"] or \
            len({json.dumps(r, sort_keys=True) for r in runs["programs"]["rows"]}) != \
            len(runs["programs"]["rows"]):
        fail("train program: the Trainer's logged steps differ from the eager Trainer's, or "
             "two logged steps share their values")
    n_steps = sum(t["steps"] for t in runs["programs"]["timings"])
    print(f"train program: cli.trainval.main on phase 10's root, 2 epochs: every record of "
          f"metrics.jsonl ({len(runs['programs']['records'])}) and every logged step "
          f"({len(runs['programs']['rows'])} rows, {n_steps} train steps, no two alike) equal to "
          f"the eager Trainer's ({card})")
    for kind, r in runs.items():
        rates = [x for t in r["timings"] for x in t["window_steps_per_s"]]
        print(f"  {kind}: trainval.main {r['wall']:.3f} s; windowed steps/s "
              f"{[round(x, 3) for x in rates]} ({[round(1e3 / x, 3) for x in rates]} ms/step); "
              f"epochs {[round(t['seconds'], 3) for t in r['timings']]} s; validation "
              f"{[round(v['seconds'] / v['pairs'] * 1e3, 3) for v in r['vals']]} ms/pair")

    # (i) the iteration-based Trainer on its programs, across a resume
    iter_trainer_check(dev, card, cfg, os.path.join(tmp, "kitti"), os.path.join(tmp, "iter"))
    tmp_dir.cleanup()

    # (h) bfloat16 and phase 11's families: two replayed steps each, held to eager
    variants = {"bfloat16": dataclasses.replace(cfg, compute_dtype="bfloat16"),
                **family_cfgs(cfg)}
    for name, c in variants.items():
        prog, _, _, _, _ = twin_run(dev, c, pairs[:4], None, f"train program, {name}")
        print(f"train program, {name}: two eager warm-ups, the capture and a replay "
              f"bit-equal to the eager steps; captured in {prog.capture_s:.3f} s, launches "
              f"{ {k: v for k, v in prog.launches.items() if v} }")
        del prog
        torch.cuda.empty_cache()
    print(f"train program phase: {time.perf_counter() - t_phase:.1f} s")
    return {"train": train_launches, "eval": eval_launches}


CLI_SEQUENCES = {8: (SEED + 30, 6), 9: (SEED + 31, 6)}  # phase 20's test split: 5 pairs each
CLI_SCANS = {8: dict(n_rings=64, n_azimuths=2000, step=10.0), 9: WORKFLOW_SCAN}
CLI_DENSE = 3            # phase 20: seq 09's scans gain every 3rd point again, 0.1 m higher
CLI_TURNS = 2            # phase 20 (g): timed turns a mode (program, eager, eager, program)
CLI_PAIR_KERNELS = {"radius_knn": 12, "sinkhorn": 1, "segment_sums": 4, "nms_peel": 1, "eigh4": 7}
RANSAC_ROWS = (500, 1000, 2048)          # phase 20 (d): phase 9's first rows, capacities 512-2048
RANSAC_PROGRAM_ITERATIONS = (5000, 50000)
RANSAC_SEEDS = (0, 1, 2, 3, 4)           # called in a row on each program
RANSAC_THRESHOLDS = (0.3, 0.015)         # 0.015: inlier sets, and so the refits, differ by draw


def write_cli_root(root):
    """Phase 20's KITTI-layout root: test sequence 08 of ~16-18k-point scans
    (the 0.7 bucket) and 09 of ~20k-point scans, each given every
    ``CLI_DENSE``-th point again 0.1 m higher (~25-29k points: the 1.0
    bucket); 6 frames, so 5 pairs, each. The two sequences are rendered in
    two processes."""
    import multiprocessing

    import numpy as np

    from rdmnet_tpu_torch.data.datasets import write_procedural_root

    t0 = time.perf_counter()
    with ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn")) as pool:
        for done in [pool.submit(write_procedural_root, root, "kitti", {seq: spec},
                                 **CLI_SCANS[seq]) for seq, spec in CLI_SEQUENCES.items()]:
            done.result()
    sizes = {}
    for seq, (_, n) in CLI_SEQUENCES.items():
        for i in range(n):
            path = os.path.join(root, "downsampled_xyzi", f"{seq:02d}", f"{i:06d}.npy")
            scan = np.load(path)
            if seq == 9:
                extra = scan[::CLI_DENSE].copy()
                extra[:, 2] += 0.1
                scan = np.concatenate([scan, extra])
                np.save(path, scan)
            sizes.setdefault(seq, []).append(len(scan))
    print(f"cli programs: root of {sum(map(len, sizes.values()))} procedural scans, points per "
          f"scan {sizes}, written in {time.perf_counter() - t0:.3f} s")


class CountedProgram:
    """A program whose calls are counted (the first ``CAPTURE_WARMUP`` run
    eagerly, the rest replay)."""

    def __init__(self, program):
        self.program, self.calls = program, 0

    def __call__(self, *args):
        self.calls += 1
        return self.program(*args)


def host_copy(parts):
    """Every tensor of (outputs, metrics) cloned: a program's next call
    overwrites them."""
    import torch

    return {f"{i}:{k}": v.clone() for i, part in enumerate(parts) for k, v in part.items()
            if isinstance(v, torch.Tensor)}


def same_files(a_dir, b_dir, where):
    """Every ``.npz`` (each array bit for bit) and every other file of two
    output directories, subdirectories included, equal; returns the
    ``.npz`` names of the top directory."""
    import numpy as np

    names = sorted(os.listdir(a_dir))
    if names != sorted(os.listdir(b_dir)):
        fail(f"{where}: files {names} against {sorted(os.listdir(b_dir))}")
    for name in names:
        pa, pb = os.path.join(a_dir, name), os.path.join(b_dir, name)
        if os.path.isdir(pa):
            same_files(pa, pb, f"{where}/{name}")
        elif name.endswith(".npz"):
            with np.load(pa) as a, np.load(pb) as b:
                if sorted(a.files) != sorted(b.files) or any(
                        a[k].dtype != b[k].dtype or a[k].tobytes() != b[k].tobytes()
                        for k in a.files):
                    fail(f"{where}: {name} differs between the programs and eager")
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                if fa.read() != fb.read():
                    fail(f"{where}: {name} differs between the programs and eager")
    return [n for n in names if n.endswith(".npz")]


def cli_program_phase(dev, card, kernels, cfg, ref, src, gt, full=None, cli_args=()):
    """Phase 20: the offline CLIs' compiled programs, at ``make_cfg()`` full
    width (``full``, the unscaled config; ``cfg`` its 0.7 bucket):
    ``test``'s forward with ground truth a program per bucket, ``infer``'s
    forward replayed, RANSAC a program per capacity, the bfloat16 captures.
    ``cli_args`` go to every CLI (``--cfg_preset tiny`` with ``full`` the
    tiny config rehearses the phase on the CPU with stand-in programs).
    Returns the launches of a test program's pair and of a RANSAC call at
    ``RANSAC_ITERATIONS``, and the mean ms of each replayed and eager."""
    import numpy as np
    import torch

    import rdmnet_tpu_torch.cli.infer as infer_cli
    import rdmnet_tpu_torch.cli.test as test_cli
    from rdmnet_tpu_torch.cli import eval as eval_cli
    from rdmnet_tpu_torch.cli.common import make_forward, pad_pair_np, trim_outputs
    from rdmnet_tpu_torch.config import make_cfg
    from rdmnet_tpu_torch.graph.pyramid import pad_cloud
    from rdmnet_tpu_torch.losses import Evaluator
    from rdmnet_tpu_torch.models import RDMNet, capture_pipeline, pipeline, with_pyramid
    from rdmnet_tpu_torch.ops import ransac
    from rdmnet_tpu_torch.ops.kernels import all_launch_counts, reset_launch_counts
    from rdmnet_tpu_torch.program import CAPTURE_WARMUP
    from rdmnet_tpu_torch.serving import SERVE_OUTPUTS, _pad_np, export_inference, load_exported

    t_phase = time.perf_counter()
    full = full or make_cfg()
    cap = cfg.pyramid.caps[0]
    model = RDMNet(cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    evaluator = Evaluator(cfg)
    r_src, r_ref, r_pose = ransac_case()
    orig_solver, orig_program, orig_loop = ransac.solver, test_cli._make_eval_program, \
        test_cli.run_eval_loop

    # (a) no host sync between the upload and the fetch of an eager forward with
    # ground truth (its build and the Evaluator) and of an eager RANSAC
    body = test_cli._eval_body(cfg, model, evaluator)
    (rp, rc), (sp, sc) = pad_cloud(ref, cap, device=dev), pad_cloud(src, cap, device=dev)
    pose = torch.tensor(gt, dtype=torch.float32, device=dev)
    r_args = [torch.tensor(r_src, device=dev), torch.tensor(r_ref, device=dev),
              torch.ones(len(r_src), dtype=torch.bool, device=dev)]
    r_cap, r_chunk = ransac.ransac_capacity(len(r_src))

    def eager_ransac():
        with torch.no_grad():
            return ransac.ransac_registration(
                *r_args, torch.Generator(device=dev).manual_seed(SEED),
                num_iterations=RANSAC_ITERATIONS, chunk=r_chunk, threshold=0.3)

    body(rp, rc, sp, sc, pose)  # lazy set-up (cuBLAS handles) first
    eager_ransac()
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, metrics = body(rp, rc, sp, sc, pose)
        r_tf = eager_ransac()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    metrics = {k: float(v) for k, v in metrics.items()}
    r_err = float(np.abs(r_tf.cpu().numpy() - r_pose).max())
    if not all(np.isfinite(v) for v in metrics.values()) or r_err > 1e-3:
        fail(f"cli programs (a): metrics {metrics}, RANSAC pose off by {r_err}")
    print(f"cli programs (a): no host sync between the upload and the fetch of an eager forward "
          f"with ground truth (build, model, Evaluator; {metrics}) nor of an eager "
          f"ransac_registration ({len(r_src)} correspondences, {RANSAC_ITERATIONS} iterations, "
          f"pose within {r_err:.3e})")

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "kitti")
        write_cli_root(root)

        def run_test(mode, feature_dir, vis):
            """``cli.test.main`` on the root at buckets 0.7/1.0, its forward the
            programs (``program``) or the eager forward (``eager``): (log lines,
            run_eval_loop s, [(cap, CountedProgram)])."""
            made, loop_s = [], []

            def make_program(c, *args):
                made.append((c.pyramid.caps[0], CountedProgram(orig_program(c, *args))))
                return made[-1][1]

            def timed_loop(*args, **kwargs):
                t0 = time.perf_counter()
                board = orig_loop(*args, **kwargs)
                loop_s.append(time.perf_counter() - t0)
                return board

            test_cli._make_eval_program = (make_program if mode == "program"
                                           else test_cli._make_eval_forward)
            test_cli.run_eval_loop = timed_loop
            out = io.StringIO()
            try:
                with contextlib.redirect_stdout(out):
                    test_cli.main(["--root", root, "--buckets", "0.7,1.0", "--subset", "test",
                                   "--feature_dir", feature_dir, "--device", dev.type,
                                   *cli_args] + (["--vis"] if vis else []))
            finally:
                test_cli._make_eval_program, test_cli.run_eval_loop = orig_program, orig_loop
            return out.getvalue().splitlines(), loop_s[0], made

        def untimed(lines):
            return [re.sub(r" \| prep [0-9.]+s proc [0-9.]+s", "", line) for line in lines]

        # (b) cli.test.main on the programs against the eager forward, --vis on
        reset_launch_counts()
        p_lines, _, made = run_test("program", os.path.join(tmp, "test_program"), True)
        counted = all_launch_counts()
        e_lines, _, _ = run_test("eager", os.path.join(tmp, "test_eager"), True)
        names = same_files(os.path.join(tmp, "test_program"), os.path.join(tmp, "test_eager"),
                           "cli programs (b): test")
        if untimed(p_lines) != untimed(e_lines):
            fail("cli programs (b): test's log lines differ between the programs and eager:\n"
                 + "\n".join(untimed(p_lines)) + "\n--\n" + "\n".join(untimed(e_lines)))
        check_vis_exports(os.path.join(tmp, "test_program"), names)
        if sorted(c for c, _ in made) != [cap, full.pyramid.caps[0]]:
            fail(f"cli programs (b): programs at {[c for c, _ in made]}")
        for c, prog in made:
            if prog.calls - CAPTURE_WARMUP < 3:
                fail(f"cli programs (b): bucket {c} replayed {prog.calls - CAPTURE_WARMUP} times")
            if prog.program.launches != CLI_PAIR_KERNELS:
                fail(f"cli programs (f): the test program at {c} launches "
                     f"{prog.program.launches} a pair, not {CLI_PAIR_KERNELS}")
        if any(n == 0 for n in counted.values()):
            fail(f"cli programs (b): a kernel of the path was not launched: {counted}")
        replayed = {k: sum(p.program.launches[k] * (p.calls - CAPTURE_WARMUP) for _, p in made)
                    for k in counted}
        print(f"cli programs (b): cli.test.main at buckets 0.7/1.0 with --vis, {len(names)} "
              f"pairs ({', '.join(f'{p.calls} at cap {c}' for c, p in made)}: two eager "
              f"warm-ups, then the capture and replays): every .npz, every vis file and every "
              f"logged metric line equal to the eager forward's run bit for bit; launches "
              f"{counted} in the warm-ups and captures, {replayed} in the replays (counted at "
              f"the capture)")
        for c, p in made:
            print(f"  test program at cap {c}: captured in {p.program.capture_s:.3f} s, "
                  f"{p.program.memory_bytes / 2**20:.1f} MiB kept, "
                  f"{p.program.reserved_bytes / 2**20:.1f} MiB reserved, launches a pair "
                  f"{p.program.launches}")

        # (c) cli.infer.main on three scans: programs against eager
        assets = os.path.join(tmp, "assets")
        os.makedirs(assets)
        for i, name in enumerate(("000000", "000004", "000007")):
            np.save(os.path.join(assets, name + ".npy"),
                    np.load(os.path.join(root, "downsampled_xyzi", "08", f"{i:06d}.npy")))
        kept = []
        orig_infer = infer_cli._make_forward

        def run_infer(mode, out_dir):
            if mode == "program":
                infer_cli._make_forward = lambda c, m, d: (kept.append((c, m, orig_infer(c, m, d)))
                                                           or kept[-1][2])
            else:
                infer_cli._make_forward = lambda c, m, d: (
                    lambda *padded: make_forward(c, m, with_gt=False, device=d)(
                        *padded, np.eye(4, dtype=np.float32)))
                ransac.solver = ransac.eager_solver
            try:
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    infer_cli.main(["--asset_dir", assets, "--output_dir", out_dir,
                                    "--device", dev.type, *cli_args])
                return time.perf_counter() - t0
            finally:
                infer_cli._make_forward, ransac.solver = orig_infer, orig_solver

        infer_s = {m: run_infer(m, os.path.join(tmp, f"infer_{m}")) for m in ("program", "eager")}
        inferred = same_files(os.path.join(tmp, "infer_program"), os.path.join(tmp, "infer_eager"),
                              "cli programs (c): infer")
        i_cfg, i_model, i_run = kept[0]
        print(f"cli programs (c): cli.infer.main on 3 scans: the pose file and {len(inferred)} "
              f".npz (ransac_transform among them) equal to the eager run's bit for bit; "
              f"infer.main {infer_s['program']:.3f} s on the programs, {infer_s['eager']:.3f} s "
              f"eager (model build, capture, 2 pairs, RANSAC); the forward at cap "
              f"{i_cfg.pyramid.caps[0]} captured in {i_run.capture_s:.3f} s, launches "
              f"{i_run.launches}")

        # (d) the RANSAC programs against eager calls, bit for bit
        weights = np.random.RandomState(SEED).rand(len(r_src)).astype(np.float32)
        spread_seeds, r_programs = 0, {}
        for n in RANSAC_ROWS:
            n_cap, n_chunk = ransac.ransac_capacity(n)
            for iters in RANSAC_PROGRAM_ITERATIONS:
                program = ransac.solver(n_cap, n_chunk, iters, 4, dev)
                r_programs[(n_cap, iters)] = program
                want_eigh = -(-iters // n_chunk) + 2
                if program.launches != dict.fromkeys(CLI_PAIR_KERNELS, 0) | {"eigh4": want_eigh}:
                    fail(f"cli programs (f): the RANSAC program at capacity {n_cap}, {iters} "
                         f"iterations launches {program.launches}, not {want_eigh} eigh4")
                for thr in RANSAC_THRESHOLDS:
                    args = (r_src[:n], r_ref[:n], weights[:n])
                    kw = dict(num_iterations=iters, threshold=thr, device=dev)
                    got = [ransac.ransac_registration_host(*args, seed=s, **kw)
                           for s in RANSAC_SEEDS]
                    ransac.solver = ransac.eager_solver
                    try:
                        want = [ransac.ransac_registration_host(*args, seed=s, **kw)
                                for s in RANSAC_SEEDS]
                    finally:
                        ransac.solver = orig_solver
                    for s, a, b in zip(RANSAC_SEEDS, got, want):
                        if a.tobytes() != b.tobytes():
                            fail(f"cli programs (d): RANSAC at capacity {n_cap}, {iters} "
                                 f"iterations, threshold {thr}, seed {s}: the replay differs "
                                 f"from eager by {np.abs(a - b).max():.3e}")
                    spread_seeds += len({w.tobytes() for w in want}) > 1
                    if thr == RANSAC_THRESHOLDS[0]:
                        err = max(float(np.abs(a - r_pose).max()) for a in got)
                        if err > 1e-3:
                            fail(f"cli programs (d): RANSAC at capacity {n_cap}, {iters} "
                                 f"iterations: pose off by {err:.3e}")
        if not spread_seeds:
            fail("cli programs (d): no case's eager transforms differ by seed: the draws "
                 "are not checked")
        print(f"cli programs (d): RANSAC programs at capacities "
              f"{sorted({c for c, _ in r_programs})}, {RANSAC_PROGRAM_ITERATIONS} iterations: "
              f"seeds {RANSAC_SEEDS} in a row at thresholds {RANSAC_THRESHOLDS} on each program "
              f"(the threshold an input, not a constant), every transform equal to an eager "
              f"call's bit for bit; {spread_seeds} of {len(r_programs) * 2} cases' transforms "
              f"differ by seed; phase 9's pose within 1e-3 at 0.3; eigh4 launches a call "
              f"{ {k: p.launches['eigh4'] for k, p in r_programs.items()} }; captured in "
              f"{ {k: round(p.capture_s, 3) for k, p in r_programs.items()} } s")
        caps_seen = set()
        for name in names:
            with np.load(os.path.join(tmp, "test_program", name)) as d:
                caps_seen.add(ransac.ransac_capacity(len(d["corr_scores"]))[0])
        for method in ("ransac", "ransac_featurematch"):
            written, eval_s = set(), {}
            for mode in ("program", "eager", "eager", "program"):
                json_out = os.path.join(tmp, f"eval_{method}_{mode}.json")
                if mode == "eager":
                    ransac.solver = ransac.eager_solver
                try:
                    t0 = time.perf_counter()
                    with contextlib.redirect_stdout(io.StringIO()):
                        eval_cli.main(["--feature_dir", os.path.join(tmp, "test_program"),
                                       "--method", method, "--json_out", json_out,
                                       "--device", dev.type])
                    eval_s.setdefault(mode, []).append(
                        (time.perf_counter() - t0) * 1e3 / len(names))
                finally:
                    ransac.solver = orig_solver
                with open(json_out) as f:
                    written.add(f.read())
            if len(written) != 1:
                fail(f"cli programs (d): eval {method}'s JSON differs between the programs and "
                     f"eager")
            print(f"cli programs (d): cli.eval.main --method {method} on (b)'s {len(names)} "
                  f"dumps (--method ransac: capacities {sorted(caps_seen)}, a program each) : "
                  f"the JSON equal to the eager run's; ms a pair in turns: programs "
                  f"{[round(x, 3) for x in eval_s['program']]}, eager "
                  f"{[round(x, 3) for x in eval_s['eager']]} ({card})")

        # (e) bfloat16: the served pipeline through load_exported, and the test program
        cfg_b = dataclasses.replace(full, compute_dtype="bfloat16")
        model_b = RDMNet(cfg_b, device=dev, generator=torch.Generator().manual_seed(SEED))
        export_inference(cfg_b, model_b, os.path.join(tmp, "bf16"), bucket_scales=(0.7,))
        serve, _ = load_exported(os.path.join(tmp, "bf16"), device=dev)
        b_cfg = dataclasses.replace(cfg_b, pyramid=cfg.pyramid)
        b_view = with_pyramid(serve.model, b_cfg.pyramid)
        pairs = moved_pairs(ref, src, gt, cap, 4, SEED + 20)
        padded = [tuple(p[k][0] for k in ("ref_points", "ref_counts", "src_points", "src_counts",
                                          "transform")) for p in pairs]
        for i in range(2):
            r_pts, s_pts = padded[i][0][:padded[i][1]], padded[i][2][:padded[i][3]]
            got = serve(r_pts, s_pts)
            want = pipeline(b_view, *_pad_np(r_pts, cap), *_pad_np(s_pts, cap), device=dev)
            for k in SERVE_OUTPUTS:
                if got[k].tobytes() != want[k].cpu().numpy().tobytes():
                    fail(f"cli programs (e): bf16 served request {i}: {k} differs from eager")
        b_served = serve.programs[cap]
        b_eval = Evaluator(b_cfg)
        b_program = test_cli._make_eval_program(b_cfg, model_b, b_eval, dev)
        b_eager = test_cli._make_eval_forward(b_cfg, model_b, b_eval, dev)
        for i, args in enumerate(padded):
            got = host_copy(b_program(*args))
            held_bitwise(got, host_copy(b_eager(*args)), f"cli programs (e): bf16 test pair {i}")
        print(f"cli programs (e): bfloat16: load_exported captured the served pipeline at cap "
              f"{cap} (warm-ups under the sync check) in {b_served.capture_s:.3f} s, two replayed "
              f"requests bit-equal to the eager bf16 pipeline; the bf16 test program (2 eager "
              f"warm-ups, the capture) replayed twice, outputs and metrics bit-equal to the "
              f"eager bf16 forward; launches {b_program.launches}")

        # (f) a profiled replay of each program launches what its capture counted; the
        # card's busy share in it
        t_program = next(p.program for c, p in made if c == cap)
        f_program = test_cli._make_eval_program(cfg, model, evaluator, dev)
        f_eager = test_cli._make_eval_forward(cfg, model, evaluator, dev)
        for args in padded[:3]:
            f_program(*args)
        i_padded = pad_pair_np(i_cfg, ref, src)
        r_program = r_programs[(r_cap, RANSAC_ITERATIONS)]
        r_host = (r_src, r_ref, weights)
        busy = {}
        for name, prog, call in (
                ("test", f_program, lambda: f_program(*padded[0])),
                ("infer", i_run, lambda: i_run(*i_padded)),
                ("ransac", r_program, lambda: ransac.ransac_registration_host(
                    *r_host, num_iterations=RANSAC_ITERATIONS, device=dev))):
            wall, kernel, seen, _ = profiled_kernels(call, dev)
            if seen != {k: prog.launches[k] for k in PROFILED_KERNELS}:
                fail(f"cli programs (f): a profiled {name} replay launched {seen}, its capture "
                     f"counted {prog.launches}")
            busy[name] = (wall, kernel)
            print(f"cli programs (f): a profiled {name} replay launched {seen}, as its capture "
                  f"counted; {wall:.3f} ms wall, {kernel:.3f} ms of kernels "
                  f"({100 * kernel / wall:.1f}% busy)")

        # (g) replayed against eager in turns: the test loop, infer's forward, RANSAC
        loop = {"program": [], "eager": []}
        for turn in range(CLI_TURNS):
            for mode in (("program", "eager") if turn % 2 == 0 else ("eager", "program")):
                lines, loop_s, _ = run_test(mode, os.path.join(tmp, f"t{turn}{mode}"), False)
                proc = [float(x) * 1e3 for x in re.findall(r"proc ([0-9.]+)s", "\n".join(lines))]
                loop[mode].append((loop_s * 1e3 / len(names), proc))
        write_ms = []
        for name in names[:3]:
            with np.load(os.path.join(tmp, "test_program", name)) as d:
                arrays = {k: d[k] for k in d.files}
            t0 = time.perf_counter()
            np.savez_compressed(os.path.join(tmp, "write_" + name), **arrays)
            write_ms.append((time.perf_counter() - t0) * 1e3)
        for mode, runs in loop.items():
            print(f"cli programs (g): test loop, {mode}: wall ms a pair "
                  f"{[round(w, 3) for w, _ in runs]}; proc ms a pair (issue only) "
                  f"{[[round(p, 3) for p in proc] for _, proc in runs]} ({card})")
        print(f"cli programs (g): the .npz write alone {[round(w, 3) for w in write_ms]} ms")

        timed = {}
        f_served = capture_pipeline(with_pyramid(model, cfg.pyramid), dev)
        i_eager = make_forward(i_cfg, i_model, with_gt=False, device=dev)
        f_cases = {
            "test pair": (lambda: host_copy(f_program(*padded[0])),
                          lambda: host_copy(f_eager(*padded[0]))),
            "infer pair": (lambda: trim_outputs(i_run(*i_padded), np.eye(4)),
                           lambda: trim_outputs(i_eager(*i_padded, np.eye(4, dtype=np.float32)),
                                                np.eye(4))),
            "RANSAC call": (lambda: ransac.ransac_registration_host(
                *r_host, num_iterations=RANSAC_ITERATIONS, device=dev),
                lambda: ransac.eager_solver(r_cap, r_chunk, RANSAC_ITERATIONS, 4, dev)(
                    r_src, r_ref, np.ones(r_cap, bool), weights, 0.3, 0).cpu()),
            "bf16 test pair": (lambda: host_copy(b_program(*padded[0])),
                               lambda: host_copy(f_program(*padded[0]))),
            "bf16 served request": (lambda: b_served(*padded[0][:4]),
                                    lambda: f_served(*padded[0][:4])),
        }
        peaks = {}
        for name, fns in f_cases.items():
            labels = (("bf16 replay", "float32 replay") if name.startswith("bf16")
                      else ("replay", "eager"))
            for turn in range(3 * CLI_TURNS):
                for which in ((0, 1) if turn % 2 == 0 else (1, 0)):
                    torch.cuda.synchronize(dev)
                    torch.cuda.reset_peak_memory_stats(dev)
                    t0 = time.perf_counter()
                    fns[which]()
                    torch.cuda.synchronize(dev)
                    timed.setdefault((name, labels[which]), []).append(
                        (time.perf_counter() - t0) * 1e3)
                    peaks[(name, labels[which])] = max(peaks.get((name, labels[which]), 0),
                                                       torch.cuda.max_memory_allocated(dev))
            print(f"cli programs (g): {name} in {3 * CLI_TURNS} turns, ms: "
                  + "; ".join(f"{lab} {spread(timed[(name, lab)])} (peak allocated "
                              f"{peaks[(name, lab)] / 2**20:.1f} MiB)" for lab in labels)
                  + f" ({card})")
        for name, (wall, kernel) in busy.items():
            print(f"cli programs (g): one profiled {name} replay {wall:.3f} ms wall, "
                  f"{kernel:.3f} ms of kernels, {100 * kernel / wall:.1f}% busy ({card})")
        print(f"cli programs (g): test program at cap {cap}: captured in "
              f"{t_program.capture_s:.3f} s, {t_program.memory_bytes / 2**20:.1f} MiB kept, "
              f"{t_program.reserved_bytes / 2**20:.1f} MiB reserved; RANSAC pool "
              f"{ {k: round(p.reserved_bytes / 2**20, 1) for k, p in r_programs.items()} } MiB "
              f"reserved at each capture; infer's forward {i_run.memory_bytes / 2**20:.1f} MiB "
              f"kept; bf16 test program {b_program.capture_s:.3f} s, "
              f"{b_program.reserved_bytes / 2**20:.1f} MiB reserved")
    print(f"cli program phase: {time.perf_counter() - t_phase:.1f} s")
    mean = {k: sum(v) / len(v) for k, v in timed.items()}
    return {"test_program": t_program.launches, "ransac_program": r_program.launches,
            "test_pair_ms": {k: mean[("test pair", k)] for k in ("replay", "eager")},
            "ransac_call_ms": {k: mean[("RANSAC call", k)] for k in ("replay", "eager")}}


def meta_buckets(meta):
    """The bucket configs of a port artifact's ``serving.json``."""
    from rdmnet_tpu_torch.config import Config, config_from_dict
    from rdmnet_tpu_torch.serving import bucket_configs

    return bucket_configs(config_from_dict(Config, meta["config"]),
                          [b["scale"] for b in meta["buckets"]])


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA card")
    import numpy as np

    from rdmnet_tpu_torch.config import make_cfg, make_tiny_cfg
    from rdmnet_tpu_torch.data.loader import choose_bucket
    from rdmnet_tpu_torch.data.procedural import procedural_pair, procedural_sequence
    from rdmnet_tpu_torch.device import set_precision
    from rdmnet_tpu_torch.graph.pyramid import build_pair_batch, pad_cloud, search_plan
    from rdmnet_tpu_torch.models import RDMNet, pipeline
    from rdmnet_tpu_torch.models.rdmnet import STAGES
    from rdmnet_tpu_torch.ops.kernels import _build, all_launch_counts, reset_launch_counts
    from rdmnet_tpu_torch.ops.kernels.sinkhorn import sinkhorn_cuda, sinkhorn_plain, sinkhorn_plan
    from rdmnet_tpu_torch.ops.lgr import local_to_global_registration
    from rdmnet_tpu_torch.tools.overfit_demo import LGR_INPUTS, host_batch, hypothesis_residuals

    card = smi("name,power.limit")
    max_clock_mhz = float(smi("clocks.max.sm").split()[0])
    dev = torch.device("cuda")
    set_precision()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)} "
          f"({card}), max SM clock {max_clock_mhz:.0f} MHz")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    builds = [_build.Build(name) for name in _build.KERNELS]  # all at once
    for b in builds:
        for line in b.wait().splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "built")):
                print(f"[{b.name}] {line.strip()}")
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if spills and (int(spills[1]) or int(spills[2])):
                fail(f"build: {b.name} spills registers: {line.strip()}")
    print(f"build: {time.perf_counter() - t0:.3f} s for {len(builds)} kernels")

    kernels = {
        "radius_knn": dict(name="radius_knn", route="cuda",
                           source="rdmnet_tpu_torch/csrc/radius_knn.cu",
                           replaces="rdmnet_tpu/ops/pallas/radius_knn.py:93",
                           launches=0, max_abs_err=0.0, library_ms=None, design=DESIGN),
        "sinkhorn": dict(name="sinkhorn", route="cuda",
                         source="rdmnet_tpu_torch/csrc/sinkhorn.cu",
                         replaces="rdmnet_tpu/ops/pallas/sinkhorn.py:59",
                         launches=0, max_abs_err=0.0, library_ms=None, design=DESIGN),
        # the port's own kernels: no TPU kernel; each takes a host round trip off the path
        "segment_sums": dict(name="segment_sums", route="cuda",
                             source="rdmnet_tpu_torch/csrc/segment_sum.cu",
                             replaces="none: jax.ops.segment_sum at "
                                      "rdmnet_tpu/ops/grid_subsample.py:141 (no Pallas)",
                             launches=0, max_abs_err=0.0, library_ms=None),
        "nms_peel": dict(name="nms_peel", route="cuda", source="rdmnet_tpu_torch/csrc/nms.cu",
                         replaces="none: the lax.while_loop at rdmnet_tpu/ops/nms.py:88-101 "
                                  "(no Pallas)",
                         launches=0, max_abs_err=0.0, library_ms=None),
        "eigh4": dict(name="eigh4", route="cuda", source="rdmnet_tpu_torch/csrc/eigh4.cu",
                      replaces="none: jnp.linalg.eigh at rdmnet_tpu/ops/procrustes.py:49 "
                               "(no Pallas)",
                      launches=0, max_abs_err=0.0, library_ms=None),
    }

    # ---- main-path input and model ------------------------------------------
    ref, src, gt = procedural_pair(SEED, n_rings=80, n_azimuths=3000)
    cfg = make_cfg()
    buckets = [cfg.pyramid.scaled(0.7), cfg.pyramid]
    bi = choose_bucket(max(len(ref), len(src)), [b.caps[0] for b in buckets])
    cfg = dataclasses.replace(cfg, pyramid=buckets[bi])
    cap = cfg.pyramid.caps[0]
    print(f"input: ref {len(ref)} / src {len(src)} points, bucket caps {cfg.pyramid.caps}, "
          f"band caps {cfg.pyramid.band_caps}")
    model = RDMNet(cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    rp, rc = pad_cloud(ref, cap, device=dev)
    sp, sc = pad_cloud(src, cap, device=dev)

    if "--dp-only" in sys.argv[1:]:
        # phase 14 alone (a card per rank where there are two): the path that
        # exists only across cards, without the one-card phases
        with tempfile.TemporaryDirectory() as tmp:
            write_workflow_root(os.path.join(tmp, "kitti"))
            dp_phase(dev, card, kernels, cfg, ref, src, gt, os.path.join(tmp, "kitti"))
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return

    if "--train-program-only" in sys.argv[1:]:
        # phase 19 alone: the Trainer's compiled programs; its launches a pair
        # on a line of their own for a parent run
        launches = train_program_phase(dev, card, kernels, cfg, ref, src, gt)
        print(json.dumps({"train_program_launches": launches}))
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return

    if "--cli-program-only" in sys.argv[1:]:
        # phase 20 alone: the offline CLIs' compiled programs; their launches on a
        # line of their own for a parent run
        launches = cli_program_phase(dev, card, kernels, cfg, ref, src, gt)
        print(json.dumps({"cli_program_launches": launches}))
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return

    if "--program-only" in sys.argv[1:]:
        # phase 18 alone: the compiled serving program and the port's own kernels
        program_phase(dev, card, kernels, cfg, model, ref, src)
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return

    # ---- 3. kernels vs plain at main-path shapes -------------------------
    batch = build_pair_batch(rp, rc, sp, sc, torch.eye(4, device=dev), cfg.pyramid)
    pts, cnts = pair_levels(batch, cfg.pyramid.num_stages)
    knn_ms, knn_call_ms, knn_plain_ms, knn_bound, knn_by = check_searches(
        pts, cnts, cfg.pyramid, kernels, v1=V1_KNN_MS)
    level0 = search_plan(cfg.pyramid)[0]
    for extra in (level0._replace(band=None),
                  level0._replace(band=None, k=1, radius=2 * cfg.pyramid.search_radius)):
        ms, call_ms, pms, bound, _, plan = check_knn(pts, cnts, extra, kernels)
        print(knn_line(f"level-0 unbanded K={extra.k} r={extra.radius}", ms, call_ms, pms, bound,
                       plan, V1_KNN_MS.get(("unbanded", 0, 0, extra.k))))
    # every level-0 point twice (rows 2i-1 and 2i): each query's nearest two
    # are at one distance, so the table shows the (distance, index) tie order
    twin = (torch.arange(cap, device=dev) + 1) // 2
    dup_pts = [p[:, twin].contiguous() for p in pts[:1]] + pts[1:]
    dup_cnts = [torch.clamp(2 * cnts[0] - 1, max=cap)] + cnts[1:]
    ms, call_ms, pms, bound, _, plan = check_knn(dup_pts, dup_cnts, level0, kernels)
    print(knn_line(f"level-0 duplicated points K={level0.k} band={level0.band}", ms, call_ms,
                   pms, bound, plan, None) + ": table equal to the plain version's")
    v1 = sum(V1_KNN_MS[(i.table, i.q_lvl, i.s_lvl, i.k)] for i in search_plan(cfg.pyramid))
    print(f"radius_knn per pair (12 searches): kernel {knn_ms:.4f} ms on the device, "
          f"{knn_call_ms:.4f} ms in wrapper calls, v1 design {v1:.4f} ms in wrapper calls; "
          f"plain {knn_plain_ms:.3f} ms, bound {knn_bound:.5f} ms, tables equal to the plain "
          f"version's (max abs index difference {kernels['radius_knn']['max_abs_err']})")

    p, k1, iters = 256, 129, 100
    s_t, mu_t, nu_t = (torch.from_numpy(x).to(dev) for x in sinkhorn_inputs(SEED, p, k1))
    got = sinkhorn_cuda(s_t, mu_t, nu_t, iters)
    torch.cuda.synchronize()
    want = sinkhorn_plain(s_t, mu_t, nu_t, iters)
    live = want > -1e11
    if not torch.isfinite(got).all() or not torch.equal(got > -1e11, live):
        fail("sinkhorn: non-finite output or masked entries differ")
    err = float((got - want)[live].abs().max())
    kernels["sinkhorn"]["max_abs_err"] = err
    if err > 1e-4:
        fail(f"sinkhorn: max abs error {err} > 1e-4")
    s_ms = graph_ms(lambda: sinkhorn_cuda(s_t, mu_t, nu_t, iters), reps=20)
    s_call_ms = cuda_ms(lambda: sinkhorn_cuda(s_t, mu_t, nu_t, iters), reps=20)
    s_plain = cuda_ms(lambda: sinkhorn_plain(s_t, mu_t, nu_t, iters), reps=3)
    s_bound, s_by, exp_ms, ops_ms, bytes_ms = sinkhorn_bounds(p, k1, iters, max_clock_mhz)
    print(f"sinkhorn P={p} K1={k1} iters={iters}: kernel {s_ms:.4f} ms on the device, "
          f"{s_call_ms:.4f} ms per call, v1 design {V1_SINKHORN_MS:.4f} ms per call; plain "
          f"{s_plain:.3f} ms, bound {s_bound:.5f} ms (exp {exp_ms:.5f}, f32 ops "
          f"{ops_ms:.5f}, bytes {bytes_ms:.5f}), max abs err {err:.3e}; plan {sinkhorn_plan(k1)}")
    kernels["radius_knn"].update(ms=knn_ms, ms_per_call=knn_call_ms, plain_ms=knn_plain_ms,
                                 bound_ms=knn_bound, bound_by=knn_by)
    kernels["sinkhorn"].update(ms=s_ms, ms_per_call=s_call_ms, plain_ms=s_plain, bound_ms=s_bound,
                               bound_by=s_by)
    # the kernels' large-shape paths (k > 256, K1 > 208) against their plain versions
    large_shapes_check(dev, kernels, max_clock_mhz)

    # ---- 4. main path -----------------------------------------------------
    n_warm, n_timed, n_stage = 3, 12, 5
    jitter = [rp + 1e-6 * (i + 1) for i in range(n_warm + n_timed)]
    reset_launch_counts()
    for i in range(n_warm):
        out = pipeline(model, jitter[i], rc, sp, sc, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = [pipeline(model, jitter[n_warm + i], rc, sp, sc, device=dev)["estimated_transform"]
            for i in range(n_timed)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_timed
    peak = torch.cuda.max_memory_allocated()
    stage_ms = {name: 0.0 for name in STAGES}
    for _ in range(n_stage):
        marks = []

        def hook(name):
            torch.cuda.synchronize()
            marks.append((name, time.perf_counter()))

        torch.cuda.synchronize()
        start = time.perf_counter()
        out = pipeline(model, rp, rc, sp, sc, device=dev, stage_hook=hook)
        prev = start
        for name, t in marks:
            stage_ms[name] += (t - prev) * 1e3 / n_stage
            prev = t
    counts = all_launch_counts()
    n_pairs = n_warm + n_timed + n_stage
    for name, n in counts.items():
        kernels[name]["launches"] = n
        if n == 0:
            fail(f"kernel {name} was not launched on the main path")
    tf = out["estimated_transform"]
    if not all(bool(torch.isfinite(t).all()) for t in outs + [tf]) or tf.shape != (4, 4):
        fail("main path: non-finite or misshapen estimated_transform")
    rot_err = float(np.degrees(np.arccos(np.clip(
        (np.trace(tf[:3, :3].cpu().numpy().T @ gt[:3, :3]) - 1) / 2, -1, 1))))
    print("main path stages (ms, mean of %d pairs, synchronised at each stage): %s" % (
        n_stage, json.dumps({k: round(v, 3) for k, v in stage_ms.items()})))
    print(f"main path: {dt * 1e3:.3f} ms/pair, {1.0 / dt:.4f} pairs/s over {n_timed} pairs, "
          f"peak memory {peak / 2**20:.1f} MiB, dropped {out['dropped'].tolist()}, "
          f"NMS rounds {int(out['nms_rounds'])}, launches {counts} over {n_pairs} pairs "
          f"({ {k: v / n_pairs for k, v in counts.items()} } per pair), "
          f"rotation vs ground truth {rot_err:.2f} deg (random weights)")

    # ---- 5. card vs CPU on the whole path at a small config ---------------
    # A scan against a rigidly moved copy through both devices, with the same
    # weights, for each draw of WEIGHT_SEEDS. Held for every draw: every
    # index table equal and the log transport plans within 1e-3; then LGR on
    # the CPU's patches and plans, run on both devices: the same
    # correspondence set and per-patch Procrustes hypotheses whose weighted
    # residuals agree within 1e-4 m (a residual stays well-posed where a
    # patch's few correspondences leave its pose ill-conditioned). The poses
    # are held to 1e-4 only for draws whose CPU pose registers the pair:
    # random weights otherwise pick a hypothesis that rests on a few
    # ill-conditioned correspondences, and the pose is chaotic in the last
    # bits of the plans. The draw of WEIGHT_SEEDS[0] registers it.
    tiny = make_tiny_cfg()
    small, _, _ = procedural_pair(SEED + 2, n_rings=16, n_azimuths=200)
    small = small[np.random.RandomState(0).permutation(len(small))[:500]]
    motion = np.eye(4, dtype=np.float32)
    motion[:2, :2] = [[np.cos(0.05), -np.sin(0.05)], [np.sin(0.05), np.cos(0.05)]]
    motion[:3, 3] = [0.5, 0.3, 0.1]
    moved = ((small - motion[:3, 3]) @ motion[:3, :3]).astype(np.float32)
    tcap = tiny.pyramid.caps[0]
    registered, diverged = [], []
    for seed in WEIGHT_SEEDS:
        m_gpu = RDMNet(tiny, device=dev, generator=torch.Generator().manual_seed(seed))
        m_cpu = RDMNet(tiny, device="cpu", generator=torch.Generator().manual_seed(seed))
        o_gpu = pipeline(m_gpu, *pad_cloud(small, tcap, device=dev),
                         *pad_cloud(moved, tcap, device=dev), device=dev)
        o_cpu = pipeline(m_cpu, *pad_cloud(small, tcap), *pad_cloud(moved, tcap), device="cpu")
        for side in ("ref", "src"):
            g, c = getattr(o_gpu["batch"], side), getattr(o_cpu["batch"], side)
            for field in ("points", "neighbors", "subsampling", "upsampling"):
                for lvl, (a, b) in enumerate(zip(getattr(g, field), getattr(c, field))):
                    if not torch.equal(a.cpu(), b):
                        fail(f"card vs CPU (weights {seed}): {side} {field}[{lvl}] differ")
        for key in ("dropped", "nodes_ref_valid", "nodes_src_valid", "ref_node_corr_indices",
                    "src_node_corr_indices", "node_corr_valid"):
            if not torch.equal(o_gpu[key].cpu(), o_cpu[key]):
                fail(f"card vs CPU (weights {seed}): {key} differ")
        live = o_cpu["matching_scores"] > -1e11
        ms_err = float((o_gpu["matching_scores"].cpu() - o_cpu["matching_scores"])[live].abs().max())
        if ms_err > 1e-3:
            fail(f"card vs CPU (weights {seed}): matching scores differ by {ms_err} > 1e-3")

        lgr_in = [o_cpu[key] for key in LGR_INPUTS]
        corr_c, tf_c = local_to_global_registration(*lgr_in, tiny.fine_matching)
        corr_g, tf_g = local_to_global_registration(*[x.to(dev) for x in lgr_in],
                                                    tiny.fine_matching)
        if not (torch.equal(corr_g.ref_points.cpu(), corr_c.ref_points)
                and torch.equal(corr_g.src_points.cpu(), corr_c.src_points)):
            fail(f"card vs CPU (weights {seed}): LGR correspondence sets differ")
        sc_err = float((corr_g.scores.cpu() - corr_c.scores).abs().max())
        if sc_err > 1e-6:
            fail(f"card vs CPU (weights {seed}): correspondence scores differ by {sc_err} > 1e-6")
        (res_g, n_g), (res_c, n_c) = hypothesis_residuals(corr_g), hypothesis_residuals(corr_c)
        posed = n_c >= tiny.fine_matching.correspondence_threshold
        hyp_err = float((res_g.cpu() - res_c)[posed].abs().max()) if bool(posed.any()) else 0.0
        if hyp_err > 1e-4:
            fail(f"card vs CPU (weights {seed}): hypothesis residuals differ by {hyp_err} m")

        tf_err = float((o_gpu["estimated_transform"].cpu()
                        - o_cpu["estimated_transform"]).abs().max())
        lgr_err = float((tf_g.cpu() - tf_c).abs().max())
        reg_err = float(np.abs(o_cpu["estimated_transform"].numpy() - motion).max())
        print(f"card vs CPU (tiny cfg, weights {seed}): index tables equal, matching scores max "
              f"abs diff {ms_err:.3e}; LGR on the same plans: correspondence sets equal, scores "
              f"{sc_err:.3e}, {int(posed.sum())} hypotheses' residuals within {hyp_err:.3e} m, "
              f"pose {lgr_err:.3e}; whole-path pose {tf_err:.3e}; CPU pose vs known motion "
              f"{reg_err:.3e}")
        if reg_err <= 0.05:
            registered.append(seed)
            if max(tf_err, lgr_err) > 1e-4:
                fail(f"card vs CPU (weights {seed}): registered poses differ by "
                     f"{max(tf_err, lgr_err)} > 1e-4")
        elif max(tf_err, lgr_err) > 1e-4:
            diverged.append(seed)
    if WEIGHT_SEEDS[0] not in registered:
        fail(f"card vs CPU: the weights of seed {WEIGHT_SEEDS[0]} no longer register the pair")
    print(f"card vs CPU: {len(registered)} of {len(WEIGHT_SEEDS)} weight draws register the "
          f"pair (poses held to 1e-4: {registered}); of the others, {len(diverged)} have card "
          f"and CPU poses more than 1e-4 apart: {diverged}")

    # ---- 6. training path at full width ------------------------------------
    tr = train_phase(cfg, host_batch(ref, src, gt, cap), dev)
    for name, n in tr["train_counts"].items():
        kernels[name]["launches_per_train_step"] = n / (TRAIN_WARM + TRAIN_TIMED)
    for name, n in tr["eval_counts"].items():
        kernels[name]["launches_per_eval_step"] = n
    ms = sorted(tr["step_ms"])
    print("train step parts (ms, mean of %d steps, synchronised at each part): %s" % (
        TRAIN_TIMED, json.dumps({k: round(v, 3) for k, v in tr["parts"].items()})))
    print(f"train path: {sum(ms) / len(ms):.3f} ms/step (median {ms[len(ms) // 2]:.3f}, min "
          f"{ms[0]:.3f}, max {ms[-1]:.3f}) over {TRAIN_TIMED} steps, build included; peak memory "
          f"{tr['peak'] / 2**20:.1f} MiB; weights moved by up to {tr['moved']:.3e}; launches "
          f"{tr['train_counts']} over {TRAIN_WARM + TRAIN_TIMED} steps")
    print("eval step: " + ", ".join(f"{k} {v:.6g}" for k, v in tr["eval"].items())
          + f"; launches {tr['eval_counts']} (random weights after {TRAIN_WARM + TRAIN_TIMED} "
          "steps)")

    # ---- 7. card vs CPU on one train step at a small config ---------------
    scans, poses = procedural_sequence(11, 2, n_rings=16, n_azimuths=200)
    pick = np.random.RandomState(0)
    small_ref = scans[0][pick.permutation(len(scans[0]))[:500], :3]
    small_src = scans[1][pick.permutation(len(scans[1]))[:480], :3]
    train_card_vs_cpu(tiny, host_batch(small_ref, small_src, np.linalg.inv(poses[0]) @ poses[1],
                                      tcap), dev)

    # ---- 8. serving at full width ---------------------------------------------
    for name, n in serving_phase(dev, card, kernels).items():
        kernels[name]["launches_per_served_request"] = n

    # ---- 9. RANSAC on the card ------------------------------------------------
    ransac_phase(dev, card)

    # ---- 10. train -> snapshot -> test -> eval ---------------------------------
    step_ms = sum(tr["step_ms"]) / len(tr["step_ms"])
    workflow_tmp = tempfile.TemporaryDirectory()  # its root serves phase 14 too
    workflow_root = os.path.join(workflow_tmp.name, "kitti")
    write_workflow_root(workflow_root)
    for key, per in workflow_phase(dev, card, kernels, step_ms, workflow_root).items():
        for name, n in per.items():
            kernels[name][key] = n

    # ---- 11. the model surface: parity config, families, converter -------------
    for name, n in model_surface_phase(dev, kernels, ref, src, gt).items():
        kernels[name]["launches_per_parity_pair"] = n

    # ---- 12. bfloat16 beside float32 at full width ------------------------------
    for name, n in bf16_phase(dev, cfg, ref, src, gt).items():
        kernels[name]["launches_per_bf16_pair"] = n

    # ---- 13. data preparation: downsample -> pairs (ICP) -> calibrate ----------------
    for name, n in data_prep_phase(dev, kernels).items():
        kernels[name]["launches_per_icp_iteration"] = n

    # ---- 14. data parallelism: dp step, sp-sharded build, trainval --dp ----------------
    for key, per in dp_phase(dev, card, kernels, cfg, ref, src, gt, workflow_root).items():
        for name, n in per.items():
            kernels[name][key] = n
    workflow_tmp.cleanup()

    # ---- 15. the library surface: contracts, toolkit, layers, splitter -------------------
    for key, per in library_phase(dev, card, kernels, cfg, model, batch).items():
        for name, n in per.items():
            kernels[name][key] = n

    # ---- 16. the model at shapes past the kernels' first paths -------------------------
    record_large_phase(*large_model_phase(dev, card, kernels, cfg, ref, src, gt), kernels)
    group_per_pair = group_model_phase(dev, card, kernels, cfg, ref, src)
    kernels["sinkhorn"]["group_path"].update(
        launches=round(group_per_pair["sinkhorn"]["group"] * GROUP_TIMED),
        launches_per_pair=group_per_pair["sinkhorn"]["group"])
    kernels["sinkhorn"]["launches_per_group_pass_pair"] = sum(group_per_pair["sinkhorn"].values())

    # ---- 17. the learning loop: the overfit demo and the vote-rescue recipe --------------
    demo_launches, n_evals = learning_phase(dev, card, kernels, ref)
    kernels["radius_knn"]["launches_per_demo_build"] = demo_launches["build"]["radius_knn"]
    for name in demo_launches["train"]:  # the two the learning loop counts
        kernels[name]["launches_per_demo_train_step"] = demo_launches["train"][name] / DEMO_STEPS
        kernels[name]["launches_per_demo_eval"] = demo_launches["eval"][name] / n_evals

    # ---- 18. the compiled serving program: each bucket captured as a CUDA graph ----------------
    for name, n in program_phase(dev, card, kernels, cfg, model, ref, src).items():
        kernels[name]["launches_per_pair"] = n

    # ---- 19. the Trainer's compiled programs: the train and eval steps as CUDA graphs ---------
    # in a process of its own: a profiled replay of the train program has crashed
    # (SIGSEGV in cudaGraphLaunch under the profiler) after phase 18 in one process,
    # never in a fresh one
    del model, batch
    torch.cuda.empty_cache()
    child = subprocess.run([sys.executable, os.path.abspath(__file__), "--train-program-only"],
                           capture_output=True, text=True, timeout=900)
    print("\n".join(line for line in child.stdout.splitlines()
                    if not line.startswith(("{", "[")) and line != card))
    if child.returncode != 0:
        fail(f"train program phase: the child process ended with {child.returncode}: "
             f"{child.stderr[-3000:]}")
    launches = next(json.loads(line)["train_program_launches"]
                    for line in child.stdout.splitlines()
                    if line.startswith('{"train_program_launches"'))
    for kind, per in launches.items():
        for name, n in per.items():
            kernels[name][f"launches_per_{kind}_program_pair"] = n

    # ---- 20. the offline CLIs' compiled programs: test, infer, RANSAC, bf16 ----------------
    # in a process of its own, as phase 19
    child = subprocess.run([sys.executable, os.path.abspath(__file__), "--cli-program-only"],
                           capture_output=True, text=True, timeout=900)
    print("\n".join(line for line in child.stdout.splitlines()
                    if not line.startswith(("{", "[")) and line != card))
    if child.returncode != 0:
        fail(f"cli program phase: the child process ended with {child.returncode}: "
             f"{child.stderr[-3000:]}")
    launches = next(json.loads(line)["cli_program_launches"]
                    for line in child.stdout.splitlines()
                    if line.startswith('{"cli_program_launches"'))
    for name, n in launches["test_program"].items():
        kernels[name]["launches_per_test_program_pair"] = n
        kernels[name]["test_program_pair_ms"] = launches["test_pair_ms"]
    for name, n in launches["ransac_program"].items():
        kernels[name]["launches_per_ransac_program_call"] = n
    kernels["eigh4"]["ransac_program_call_ms"] = launches["ransac_call_ms"]

    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
