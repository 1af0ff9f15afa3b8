#!/usr/bin/env python3
"""chip_smoke.py: drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and the repo's
ddt_tpu_torch package beside this file; imports nothing of JAX or ddt_tpu.
Prints one JSON object per line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}},
printed only when every phase passed. Any failure raises (exit != 0).
Times of kernels, plain versions and library calls are device times: the
median of CUDA-event pairs around single calls, with a spin kernel queued
before each start event so that the host's time in the wrapper stays
outside the pair.

Phases:
  1 device   card name, nvidia-smi's name and power limit, datasheet peaks
  2 build    nvcc of every csrc/*.cu (all at once), seconds
  3 hist     the histogram kernel's exact mode (the f32 training mode:
             int64 fixed-point sums) against its plain version, bitwise,
             at the Higgs shape (1M x 28, 255 bins, nodes 1..32, 10% frozen
             rows), and at 128 and 64 bins; times of the kernel, the plain
             version, two int64 index_add_ calls (the library yardstick,
             bitwise too) and the bound; beside them on the same inputs
             its float-atomic f32 mode (|diff| <= 1e-5 * sum|g| (|h|) over
             the cell's own rows + 1e-6) and two torch.bincount calls;
             then the same checks, times and bound on the node indices of
             one main-path tree grown on the card (left children only
             from level 1 on), per level and summed per tree
  4 traverse the traversal kernel (K3, csrc/lut.cu ddt_traverse_f32)
             against its plain version: bitwise on an exact-grid ensemble
             (leaves multiples of 1/8) with missing and categorical
             routing and 7 classes, on the 1M rows and at 1, 16, 64, 256
             and 257 rows and on both sides of the mapping crossover (a
             block of 512 rows an SM), each also equal to the 1M-row
             call's rows; and the host oracle on 50k rows; then the same
             on a 1000-tree ensemble, whose records the kernel stages pass
             by pass in both mappings
  5 main     api.train on 1M x 28 float rows at 255 bins, depth 6, on the
             card, then api.predict on the 1M rows; the counters are zeroed
             just before and read just after: both kernels' launch counters
             move, the rows were binned on the card (ops/quantize's counter
             moves, BinMapper.transform is never called), the loop ran as
             100 replays of one captured round with ~6 histogram launches
             a tree, counted per replay; train AUC >= 0.80; scores equal
             the host oracle's on 50k rows. Then the same steps timed
             apart: edge fitting, the f32 upload, binning, the reference
             bin counts, the fused loop (capture included), and predict's
             upload, binning and scoring
  5b bin     binning on the card (ops/quantize) against BinMapper.transform
             at 1M x 28, bitwise, on rows with NaN, +/-inf, -0.0, a
             low-cardinality column (duplicate edges) and an identity
             column, with and without the reserved NaN bin; its device
             time beside its byte bound, the H2D upload timed apart; the
             card's feature_bincounts bitwise against numpy
  5c fused   20 trees at 1M x 28: the fused loop (replays of a captured
             round) against the granular loop on the card: int8 and f32
             trees bitwise, bagging 0.8 + colsample 0.8 in int8 bitwise, a
             block cap of 7 against one block bitwise; ms a tree of both
             loops
  6 trained  the traversal kernel against its plain version on the trained
             ensemble, bitwise, at 1M rows and at every size of phase 4,
             and its times
  7 parity   the same 200k-row, 10-tree, depth-6 model trained on the card
             and on the CPU (plain versions): trees identical except at
             bf16-boundary ties, AUC within 0.005
  8 lut_exact   K4 (csrc/lut.cu ddt_lut_int8, fp16 and int8 leaves) and K5
             (ddt_lut_int4 at 13 bins, nibble thresholds, and at 255 bins)
             on the 1M rows over exact-grid ensembles (70 trees, 7
             classes, missing and categorical, lossless grids): bitwise
             against their plain versions and against the traversal kernel
             on the same f32 ensemble; and at 1, 16, 64, 256 and 257 rows
             (the small-batch mapping) bitwise against the plain version
             and the 1M-row call's rows
  9 lut_trained K4 (fp16) and K5 on phase 5's model: |diff| <= 1e-5 *
             (|p| + 1) against their plain versions, and within the tables'
             max_abs_err (+ the same slack) of the traversal kernel; times,
             bounds and table bytes per tier
 10 lut4_packed the same Higgs shape trained at 15 bins on the card; its
             int4 tables nibble-pack the thresholds; K5 against its plain
             version, with times
 11 serve    ServeEngine over phase 5's bundle at quantize None, "int8"
             and "int4" (max_batch 256, max_wait_ms 1.0): 32 submitter
             threads send ~2,000 requests of 1-64 raw float rows, with a
             hot swap to the 15-bin bundle halfway, then single rows at an
             idle queue (the express lane). Every response equals offline
             api.predict at that tier for the token that scored it,
             bitwise; each model resolves to the requested tier; the
             counters are zeroed just before and the LUT kernels' must move;
             each batch is binned once on the card (transforms a batch ==
             1), and the gate segment (batch assembly and binning) is
             reported per tier
    serve_kernels K3, K4 (fp16) and K5 on phase 5's model at 1, 16, 64 and
             256 binned rows a call: device time with L2 warm and with L2
             flushed, beside the serve phase's launch counts; and an empty
             kernel timed the same way, the latency floor of one launch
 12 quantize ops/grad.quantize_gradients on the card at 1M rows, int8 and
             int16, from logloss gradients: q's and scales bitwise equal to
             the numpy twin, and which term (max|g|/qmax or the snapped sum
             cap) set each scale; the device uniform twin bitwise equal to
             uniform_np, at row base 0 and above 2^32
 13 hist_int the histogram kernel's integer mode against its plain version,
             bitwise (max |diff| = 0), int8 and int16 q's at 1M x 28, 255
             bins at N = 1..32 and 128 / 64 bins at N = 16, 32, 10% frozen
             rows; times of the kernel, the plain version, two int32
             index_add_ calls (the library yardstick, itself bitwise) and
             the bound; the per-tree sum over N = 1, 1, 2, 4, 8, 16; and
             bitwise, timed and bounded on phase 3's main-path node indices
 14 quant_exact one tree from exact-grid gradients, int8 against f32,
             structure and leaves bitwise: mse on y in {-1, +1} (g = -/+1,
             h = 1) at 131,072 rows, so every integer sum stays below 2^24
             and the one dequantize is exact; and the reference's pinned
             grid (scale exactly 1) at 1M rows through the backend
 15 train_quant api.train at 1M x 28, 255 bins, depth 6, 100 trees with
             grad_dtype="int8" on the card: the integer kernel's counter
             moves and the f32 one does not; train AUC >= 0.80 and within
             0.005 of phase 5's; per-round split agreement with f32 >= 0.985
             over 10 rounds grown from the same f32 boosting state
 16 parity_quant 200k rows, 10 trees, depth 6, 63 bins (K2's regime),
             int16, subsample 0.8, colsample_bytree 0.8, on the card and on
             the CPU: trees identical except at bf16-boundary ties, AUC
             within 0.005
    The training matrix. Each path's counters are zeroed just before it
    and read just after.
 17 covertype  BASELINE config 2 at full width through api.train: 464,809
             x 54 float rows (synthetic_multiclass), 7 classes, 255 bins,
             depth 8, up to 500 rounds, the last 116,203 rows as the eval
             set with logloss and early stopping (patience 20), binned on
             the card, the fused loop with the eval step inside the
             captured round; then api.predict of the kept ensemble through
             K3. One capture, one replay a round, 8 x 7 histogram launches
             a round (+ the warm-up round); eval accuracy >= 0.80; the
             host logloss of K3's scores equals the round's device score
             to 1e-4; scores equal the host oracle's on 2,000 rows. Then
             the loop apart (blocks of 20 rounds: ms a round, a profiled
             5-round window's busy share and kernels), K1 on one covertype
             tree's node indices level by level (kernel, plain, library,
             bound; the float-atomic mode's time beside it), and K3 on the
             trained model bitwise against its plain version at 1, 256 and
             116,203 rows, with its bound
 18 covertype_prefix  20 rounds with the eval set, fused against granular:
             int8 and f32 trees and eval scores bitwise
 19 missing  1M x 28 (synthetic_missing: 10% NaN, informative on 3
             features), missing_policy "learn" against "zero", 100 rounds,
             depth 6, 800k rows train: learned AUC >= zero policy's on the
             rest; K3's routing step on the learned model bitwise
 20 categorical  synthetic_ctr(1M): 13 numeric + 26 frequency-binned
             categorical columns as cat_features, 255 bins, depth 6, 100
             rounds; one-vs-rest splits chosen; K3's routing step bitwise
 21 weights  Higgs shape, 20 rounds, int8: all-ones weights == no
             weights bitwise; integer weights 0-3 fused == granular
             bitwise; the training loss is the weighted mean (to 1e-4)
 22 resume   covertype at 100k rows (20k eval): 10 rounds with
             checkpoint_every=5, resumed to 20, against an uninterrupted
             20: int8 and f32 bitwise (trees and eval scores)
    parity_matrix  card against CPU at 20k rows, 5 rounds, for missing,
             categorical, weights (f32) and covertype (int8): trees
             identical except at bf16-boundary ties, AUC or accuracy
             within 0.005
    Row partitions over NCCL
 23 multi    BASELINE config 3 (synthetic_ctr: 13 numeric + 26 frequency-
             binned categorical columns as cat_features, 255 bins, depth 6,
             100 rounds) at 1M rows a rank, on P = min(4, cards) NCCL ranks
             started by parallel/spawn, one card each, every rank calling
             api.train with the same rows: f32 with split_comms allreduce
             and reduce_scatter (hist_comms_slabs 1 and 4), int8
             allreduce. Held: every rank's
             ensemble bitwise equal; int8 bitwise equal to one card trained
             on the same P x 1M rows; f32's first divergence from that run
             reported and its AUC within 0.005; the collectives' modeled
             bytes equal to collective_bytes_per_tree a round run; K1 and
             K3 launched on every rank. Times: api.train wall, fused ms a
             round, the NCCL kernels' share of a profiled window, the
             collectives a round, and the one card's ms a round over the
             ranks'. With one card the same code runs one NCCL rank (the
             captured round holds its collectives) and the phase says the
             multi-rank wire was not witnessed.
    The 2D mesh, the hosts axis, slabs and checkpoints under partitions
 24 mesh2d   BASELINE config 5's width (stress_binned_chunk: 1024 binned
             features, 255 bins, binary) at 1M rows in all, depth 6, 20
             rounds in fused blocks of 10. On one card first: K1 on one
             tree's levels at the shapes a rank sees (1M x 1024, a (2, 2)
             rank's 500k x 512, a (1, 4) rank's 1M x 256: kernel, plain,
             library and bound), and the one-card f32 and int8 runs (wall,
             ms a round, K1 ms a round from a profiled window, AUC). Then
             on four NCCL ranks (four cards): mesh (2, 2) in f32 (it
             resolves to reduce_scatter) and int8, (1, 4) in f32 (it
             resolves to allreduce), and 2 emulated hosts x 2 rows in f32
             with hist_comms_slabs 4 and 1, and in int8 with 4. Held:
             every rank's ensemble bitwise equal; int8 bitwise equal to
             the one card's (slabs too); f32's first divergence reported
             and AUC within 0.005; the counted modeled bytes equal to
             (replays + the warm-up round) x the model a tree
             (16,716,224 B at (2, 2) and (1, 4)); f32 slabs 4 against 1
             AUC within 0.005, the first divergence reported; K1 and K3
             launched on every rank. Times: api.train wall, ms a
             round, K1 ms a round and the NCCL kernels' share of a profiled
             window per rank, the routing broadcast's bytes and ms a level,
             the speedup over one card. Then an int8 (2, 2) run stopped at
             round 10 with a checkpoint, resumed to 20 on one card with no
             group: bitwise the one card's. With one card the same code
             runs one NCCL rank at mesh (1, 1) with 4 slabs and the
             checkpoint case, and the phase says the mesh was not
             witnessed.
    Out of core
 25 stream   BASELINE config 5's width streamed: 4M x 1024 stress rows in
             8 chunks of 512k held once in pinned host memory, depth 6, 2
             rounds, f32 and int8, the device chunk cache off (every pass
             over the wire) and on, against the in-memory trainer on the
             same rows. Held: trees bitwise equal; h2d_bytes exactly the
             chunk bytes x the passes (x 1 with the cache); K1 launched
             once a chunk-level; predict_streaming bitwise api.predict at
             the f32, lut and lut4 tiers; K4 and K5 at 1024 features
             bitwise their plain versions (the pairs mapping). Times: ms a
             round of each run, H2D GB/s, and a profiled cache-off f32
             round's staging, H2D and K1 times apart with their overlap
             and the launches a chunk-level; K4 / K5 at 1024 features
             against their bound.
    The model's lifecycle
 26 lifecycle  phase 5's Higgs model through save_model / load_model (the
             manifest digest verified, scores on the 1M rows bitwise);
             written as LightGBM text and read back (api.fill_bin_thresholds
             from the mapper): the model's arrays bitwise (features, bin
             thresholds, leaves = f32(leaf * lr + base on the first round),
             the format's own content) and its card scores within 1e-5 *
             (|p| + 1) of the trained model's (the text folds shrinkage and
             base into the leaves, which reorders f32 adds); then
             push_servable at f32, int8 and int4 and load_servable in this
             process (K3 / K4 / K5 launches counted from zero around each
             restore-and-score) and in a cold child (python3 -c, the same
             tree, binning 16,384 float rows on the card itself): every
             restored score bitwise api.predict at its tier, the child's
             nvcc builds 0
 27 config4  BASELINE config 4: a 1000-tree, depth-6, 255-bin binary model
             trained on the card (fused loop, f32) on 1M Higgs-shape rows,
             its LightGBM text round trip as in phase 26, then 10M x 28
             float rows scored in three arms: total (host floats -> binning
             on the card -> K3 -> host, api.predict), resident (binned rows
             on the card -> K3 -> host), compute (K3 alone, no D2H): wall
             Mrows/s of each, the card's peak memory in the total arm, a
             profiled run of total and resident (the card's busy share,
             copies included, and its top device rows; "not measured"
             when the profile lacks the arm's copies or K3), K3's device
             ms against its bound (traverse_compares on this data) and
             bitwise its plain version on the first 1M rows; scores equal
             the host oracle's on 10,000 rows. Then the row-sharded
             scorer on one card (its scaling yardstick) and
             api.predict(n_partitions=k) for k = 2..min(4, cards), bitwise
             one card's, total and resident Mrows/s per k (with one card:
             "multi-card scoring not witnessed: 1 card").
    The serving plane (run after phase serve_kernels, on phase 5's 255-bin
    model and phase 10's 15-bin model, 100 trees, depth 6; max_batch 256,
    max_wait_ms 1.0; K3 / K4 / K5 launches counted from zero over it)
 28 serve_plane  a: serve_forever on 127.0.0.1 (ephemeral port) over a
             ServeEngine at f32, then int4; 32 client threads send 1-64
             rows as JSON floats or as binned=raw bodies (15-bin codes,
             valid in both bin spaces), a /metrics scrape mid-storm lies
             counter by counter between snapshots taken around it, and a
             POST /swap by registry reference to the 15-bin artifact fires
             mid-storm; then express singles, raw == JSON binned bitwise, a
             ragged raw body 400s, a client X-DDT-Trace-Id round-trips
             through the headers and /debug/requests, /stats?emit=1's event
             validates. b: f32 / int8 / int4 artifacts behind one fleet at
             max_resident 2 over HTTP, routed by path and header, raw
             bodies too; a cycle forcing evictions and reloads (their
             latency), a steady-state window over the resident models with
             0 nvcc and 0 operand builds, and an eviction that frees at
             least the evicted model's operand bytes from
             memory_allocated (the incoming model's bytes measured alone).
             c: a drift-tracked champion with an int4 shadow challenger
             and an unshifted control; covariate-shifted binned traffic:
             only the champion alerts (event and counter), both windows'
             counts equal numpy's bincount of the rows sent, bitwise, the
             challenger scores rows on its own stream, and the champion's
             answers equal those of the same traffic with the shadow off.
             d: a cold `python -m ddt_tpu_torch.cli serve --registry R
             --model higgs@1` child answers bitwise with 0 nvcc builds
             (its /metrics). Every answer equals offline api.predict of
             the artifact and tier that served it, bitwise. Recorded, not
             gated: HTTP p50 / p99 / p999 a tier and arm, the trace
             segments' medians, the reload latency, and the p99 ratios of
             fleet / single engine, request traces on / off and drift +
             shadow on / off (min over 3 interleaved saturated windows a
             side, in process).
 29 ops      training telemetry and the operator's CLI at config 1's
             full width (1M x 28 rows written to an .npz, 255 bins, depth
             6, 100 trees): a `python -m ddt_tpu_torch.cli train` child
             with --run-log, --status-port 0 (its /healthz polled until it
             closes: progress rises to 100 and the last phase reads
             done) and a capture window of rounds 2-3; every line of the
             log validates: 100 round records, phase timings, counters
             (jit_compiles 1: one captured round, no nvcc build; a device
             peak), cost_analysis of the hist phase whose calls show 101
             rounds of 6 K1 launches (the warm-up round and 100 replays);
             its model bitwise an untelemetered api.train's. A --profile
             child (the granular loop): its phases sum to within 15% of
             its rounds' time, the hist phase's roofline GB/s is <= the
             card's peak, trees bitwise again. `cli report`, `report
             diff`, `cli trace` exit 0, the trace has 100 round slices,
             the torch.profiler capture has ddt: ranges and the device
             work of rounds 2-3 only (two graph launches, and in them 12
             K1 kernels: CUPTI reports a replayed graph's kernels). `cli predict` at f32, int8 and int4: bitwise
             api.predict; `cli inspect`. Then the same path in this
             process with the counters zeroed around it (a telemetered
             api.train and the three tiers' scoring: the ops path's
             launches, 100 replays of a capture, new or kept from the
             untelemetered api.train; its log's hist cost calls count
             every replay either way), and the fused loop's ms a tree
             with and without a run log (three fits each, interleaved,
             each on a backend of its own, so each captures its round
             once: capture included); each CLI child's seconds.
 30 robust    config 1 at full width (1M x 28, 255 bins, depth 6, 8 trees),
             f32 and int8, under a fault plan: two transient tree fetches
             and a torn checkpoint write (retried) and an allocation
             failure at the third tree's second level (the backend's OOM
             ladder steps down one rung: the carried parent table given
             up) on the granular loop; then the streamed trainer over 4
             chunks with three failed chunk reads (retried); every
             ensemble bitwise the undisturbed granular one (itself the
             fused one's); retries, degrades, fault events and the rung
             taken, read off the backend. The ladder's peaks: at config 1
             and at a wide level of 65,536 rows x 1024 features, f32 and
             int8, the last histogram level (32 nodes) of one depth-6
             tree grown at each rung, its peak of card memory
             (max_memory_allocated after reset_peak_memory_stats, above
             what was allocated before the level, the carried parent
             table counted), strictly falling rung by rung, every rung's
             tree bitwise rung 0's. The real allocation failure: the
             wide rows at depth 7, the process capped by
             set_per_process_memory_fraction between rung 0's and rung
             1's level peak, an f32 and an int8 granular fit with no
             fault plan take torch.cuda.OutOfMemoryError at rung 0, step
             their backend down and end bitwise the undisturbed fit's
             trees; the cap lifted, a backend of another config starts
             and stays at rung 0. A `cli
             train` child crashed by ckpt.save.between at round 6 (the
             torn pair's cursor at 4), a second child resuming it, its
             model bitwise api.train's. The fused ms a tree with no plan
             and with a plan armed at every seam that never matches, 3
             fits a side interleaved, each capturing its round.
 31 baseline the CPU reference: backends/cpu.CPUDevice's native C++
             histogram on one main-path Higgs tree's level shapes
             (main_path_levels), at all host threads and at one, against
             K1 on the same inputs on the card: f32 (native f32 sums
             within 1e-5 * sum|g| + 1e-6 of K1's exact table) and int8
             q's (bitwise, every cell below 2^24); Mrows/s a build on
             each side and their ratio, lscpu's model name and the thread
             count; a 5-tree backend="cpu" fit against the card's trees
             (equal but for bf16 ties); the streamed host loop
             (fit_streaming with backend="cpu") over 4 chunks of the same
             rows, 5 trees, cache_preds on and off (bitwise each other),
             against the in-memory backend="cpu" fit and the card's
             streamed fit against it (equal but for bf16 ties), with its
             seconds.
  then the {"kernels": [...]} line (K1 and K3 report covertype, the other
  paths' launches under "paths", "stream", "lifecycle", "serve_plane",
  "ops", "robust" and K3's "config4" included; K1's entry is its exact mode, with the float-atomic mode's
  time as cas_ms), nvidia-smi's line, and the ok line.

    python3 chip_smoke.py --phase multi
    python3 chip_smoke.py --phase mesh2d
    python3 chip_smoke.py --phase stream
    python3 chip_smoke.py --phase config4
    python3 chip_smoke.py --phase serve_plane
    python3 chip_smoke.py --phase ops
    python3 chip_smoke.py --phase robust
    python3 chip_smoke.py --phase baseline
    python3 chip_smoke.py --phase straggler
    python3 chip_smoke.py --phase multihost

run the device, build and multi (or mesh2d, stream, config4, ops,
robust, baseline, or serve_plane after training its two models) phases
alone
(the calls to make on a machine with several cards, or with the host
memory for the witness) and end with the same ok line. `--phase stream`
then trains 1 round f32 at depth 6 over a chunk set larger than the
card's memory, held in pageable host memory, where /proc/meminfo's
MemAvailable allows, and prints its size, or "not witnessed: host
memory". `--phase straggler` (>= 2 cards; not in the default run) runs
config 3's layout at 1M rows a rank on min(4, cards) NCCL ranks, 6
trees: f32 allreduce, f32 reduce_scatter, int8 and (with 4 cards) a (2,
2) mesh, each with the flag off (the fused loop), on (the granular loop,
undisturbed) and on under an injected straggler on rank 1 (the watchdog
rotates the row shards at checkpoint_every=2, three times): every
rank's trees bitwise the undisturbed run's with the flag on; ms a round
off, on and rotating, each rotation's ms, the modeled histogram bytes a
round off and on (the f32 path's int64 wire), K1's launches. `--phase
multihost` (>= 2 cards; not in the default run) runs two `python -m
ddt_tpu_torch.cli train` children with --multihost-coordinator
localhost:PORT --multihost-processes 2 --multihost-id i, each bound to
its own card over NCCL, at config 3's layout (criteo, one-vs-rest
categorical columns, 255 bins, depth 6) with 1M rows a rank for 4 trees,
int8 and f32: both children's models bitwise equal; int8 bitwise equal
to one process training all the rows on one card, f32 equal to it but
for proven bf16 ties (trees_match_mod_ties: its wire sums f32; the first
divergence reported).
"""

from __future__ import annotations

import gc
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

from ddt_tpu_torch import _build, api
from ddt_tpu_torch.backends import cuda as cuda_backend
from ddt_tpu_torch.backends import get_backend, row_sharded_backend
from ddt_tpu_torch.breakdown import profiled
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data.categorical import fit_categorical_encoder
from ddt_tpu_torch.data.datasets import (stress_binned_chunk,
                                         synthetic_binary, synthetic_ctr,
                                         synthetic_missing,
                                         synthetic_multiclass)
from ddt_tpu_torch.data.quantizer import (BinMapper, feature_bincounts,
                                          fit_bin_mapper)
from ddt_tpu_torch.driver import Driver
from ddt_tpu_torch.models.tree import TreeEnsemble, empty_ensemble
from ddt_tpu_torch.ops import grow as grow_ops
from ddt_tpu_torch.ops import (grad, hist_cuda, histogram, predict,
                               predict_cuda, predict_lut, predict_lut_cuda,
                               quantize, sampling)
from ddt_tpu_torch.parallel import comms, mesh, spawn, tasks
from ddt_tpu_torch.registry import manifest as manifest_mod
from ddt_tpu_torch.registry.loader import load_servable, push_servable
from ddt_tpu_torch.serve import ServeEngine
from ddt_tpu_torch.serve.control import (FleetSpec, build_fleet,
                                         parse_models_arg)
from ddt_tpu_torch.serve.http import serve_forever
from ddt_tpu_torch.serve.metrics import parse_exposition
from ddt_tpu_torch.streaming import fit_streaming, predict_streaming
from ddt_tpu_torch.telemetry import costmodel
from ddt_tpu_torch.telemetry import counters as tele_counters
from ddt_tpu_torch.telemetry.events import RunLog, validate_event
from ddt_tpu_torch.utils.metrics import accuracy, auc, logloss

ROWS = 1_000_000
FEATURES = 28
DEPTH = 6
N_TREES = 100
PARITY_ROWS = 200_000
PARITY_TREES = 10
SERVE_POOL = 65_536         # raw rows the serve phase's requests slice
FUSED_TREES = 20
SERVE_REQUESTS = 2_000
SERVE_THREADS = 32
EXPRESS_REQUESTS = 200
QUANT_EXACT_ROWS = 131_072  # 127 * rows < 2^24: every int32 sum exact in f32
AGREE_ROUNDS = 10
PARITY_Q_BINS = 63
HIST_SHAPES = ((255, (1, 2, 4, 8, 16, 32)), (128, (16, 32)), (64, (16, 32)))
#: Histogram builds of one main-path tree with sibling subtraction (on for
#: the card, and everywhere for integer histograms): nodes per level.
TREE_SEQ = (1, 1, 2, 4, 8, 16)
SERVE_SIZES = (1, 16, 64, 256)     # rows per call, phase serve_kernels
LUT_EXACT_SIZES = (1, 16, 64, 256, 257)   # rows per call, phase lut_exact
PASS_TREES = 1000                  # phase traverse_exact's staged model
PASS_ROWS = 200_000
SLEEP_CYCLES = 2_000_000           # ~1 ms spin before each timed call
# The training matrix (phases covertype .. parity_matrix).
COV_ROWS = 581_012            # BASELINE config 2: Covertype's rows
COV_TRAIN = 464_809           # the first 80% train, the last 116,203 eval
COV_FEATURES = 54
COV_CLASSES = 7
COV_DEPTH = 8
COV_ROUNDS = 500              # 3,500 trees at most
COV_PATIENCE = 20             # early_stopping_rounds
COV_PREFIX = 20               # rounds of the fused-vs-granular prefix
COV_PROFILE = 5               # rounds in the profiled window
MATRIX_TRAIN = 800_000        # missing / categorical: train rows of the 1M
MATRIX_ROUNDS = 100
NAN_FRAC = 0.1
WEIGHT_ROUNDS = 20
RESUME_ROWS = 100_000
RESUME_ROUNDS = 10            # trained, then resumed to twice as many
RESUME_EVERY = 5
PARITY_MATRIX_ROWS = 20_000
PARITY_MATRIX_ROUNDS = 5
MULTI_ROWS = 1_000_000        # BASELINE config 3: rows a rank
MULTI_ROUNDS = 100
MULTI_BLOCK = 20              # fused blocks; rounds after the first are steady
MULTI_PROFILE = 5             # rounds in each rank's profiled window
#: (gradients, split_comms, hist_comms_slabs); slabs 4 beside 1 under
#: reduce_scatter, config 3's default.
MULTI_CASES = (("f32", "allreduce", 1), ("f32", "reduce_scatter", 1),
               ("int8", "allreduce", 1), ("f32", "reduce_scatter", 4))
MESH_ROWS = 1_000_000         # BASELINE config 5's rows, cut to one run
MESH_FEATURES = 1024          # config 5's width, not cut
MESH_ROUNDS = 20
MESH_BLOCK = 10               # fused blocks; the second block is steady
MESH_PROFILE = 3              # rounds in each rank's profiled window
MESH_CKPT_EVERY = 10          # the checkpoint case stops here
#: comms.hist_allreduce_bytes at depth 6, 1024 features, 255 bins with
#: subtraction: (2, 2) under reduce-scatter and (1, 4) under allreduce.
MESH_MODEL_BYTES = 16_716_224
#: (case, mesh) on four cards, and on one.
MESH_CASES_4 = (
    ("2x2_f32", dict(mesh_shape=(2, 2))),
    ("2x2_int8", dict(mesh_shape=(2, 2), grad_dtype="int8")),
    ("1x4_f32", dict(mesh_shape=(1, 4))),
    ("2hx2_slabs4_f32", dict(host_partitions=2, n_partitions=2,
                             hist_comms_slabs=4)),
    ("2hx2_slabs1_f32", dict(host_partitions=2, n_partitions=2,
                             hist_comms_slabs=1)),
    ("2hx2_slabs4_int8", dict(host_partitions=2, n_partitions=2,
                              hist_comms_slabs=4, grad_dtype="int8")))
MESH_CASES_1 = (("1x1_slabs4_f32", dict(mesh_shape=(1, 1),
                                        host_partitions=1,
                                        hist_comms_slabs=4)),)
#: Out-of-core training (phase stream): BASELINE config 5's width, 4M
#: rows in 8 chunks of 512k held once in pinned host memory, 2 rounds at
#: depth 6, f32 and int8, the device chunk cache off and on.
STREAM_CHUNK = 524_288
STREAM_CHUNKS = 8
STREAM_ROUNDS = 2
STREAM_LUT_ROWS = 65_536        # rows a K4 / K5 call at 1024 features
#: --phase stream's witness: a chunk set past the card's memory, where the
#: host holds it (plus this much to spare), 1 round f32 at depth 6.
WITNESS_HOST_SPARE = 8 << 30
#: The model's lifecycle (phase lifecycle): rows each restored tier scores,
#: and the bucket ladder's top of the pushed artifacts.
LIFE_ROWS = 16_384
LIFE_MAX_BATCH = 256
#: BASELINE config 4 (phase config4): a 1000-tree ensemble trained here
#: on 1M Higgs-shape rows, scoring 10M x 28 float rows.
C4_TRAIN_ROWS = 1_000_000
C4_TREES = 1000
C4_ROWS = 10_000_000
C4_ORACLE_ROWS = 10_000
C4_PLAIN_ROWS = 250_000       # K3 against its plain version, and timed
C4_REPS = 3
C4_PROFILE_PAD_S = 1.0        # idle profile around each profiled arm
#: The serving plane (phase serve_plane): the deployment of max_batch 256,
#: max_wait_ms 1.0 and 32 submitters of 1-64 rows, on phase 5's 255-bin
#: model and phase 10's 15-bin model.
PLANE_THREADS = 32
PLANE_REQUESTS = 24           # a client thread, arms a (each tier) and b
PLANE_RAW_SHARE = 0.3         # of those requests: binned=raw bodies
PLANE_EXPRESS = 50            # sequential single rows a tier, arm a
PLANE_STEADY = 200            # requests of arm b's steady-state window
PLANE_AB_THREADS = 16         # saturated in-process A/B windows
PLANE_AB_REQUESTS = 30        # a thread and window
PLANE_AB_WINDOWS = 3          # a side, interleaved
PLANE_DRIFT_CTRL = 4096       # unshifted rows to arm c's control
PLANE_CHILD_REQUESTS = 8      # to arm d's cold cli serve child
HERE = Path(__file__).resolve().parent
TIER_IMPL = {None: "auto", "int8": "lut", "int4": "lut4"}
TIER_RESOLVED = {None: "f32", "int8": "lut", "int4": "lut4"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_peaks(name: str) -> tuple[float, float, str]:
    """(memory bytes/s, f32 FLOP/s outside the tensor cores, source) of
    the card nvidia-smi names: its row of telemetry.costmodel's ceilings,
    the one the run log's roofline reads. The FLOP rate counts an FMA as
    two operations on 128 FP32 lanes per SM: a plain f32 add runs at half
    of it, an INT32 compare (64 lanes per SM) at a quarter."""
    row = costmodel.peaks_for(name)
    return (row["gbs"] * 1e9, row["gflops"] * 1e9,
            row.get("source", "telemetry.costmodel's generic gpu row"))


def time_ms(fn, reps: int, flush: torch.Tensor | None = None,
            spin: bool = True) -> float:
    """Median time of fn() in ms, CUDA events around each call, with L2
    flushed before each when `flush` is given (the buffer is larger than
    the 50 MB L2; None leaves L2 warm, as a serving loop finds it). With
    `spin`, a spin kernel keeps the stream busy while the host enqueues
    fn(), so the host's time in the wrapper stays outside the events and
    the time is the device's; without it the card also waits for the
    host, as it does in the boosting loop."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        if spin:
            torch.cuda._sleep(SLEEP_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def trees_match_mod_ties(full, other, min_split_gain, leaf_rtol=1e-3,
                         leaf_atol=2e-5, leaf_contrib_atol=1e-3,
                         cascade_gain_atol=2e-3, cascade_leaf_scale=5.0):
    """Tree equality except provable bf16-boundary ties (an adaptation of
    the repo's tests/tree_compare.assert_trees_match_mod_ties): walking
    each tree from the root, a node with matching ancestors either matches
    (feature, bin, leaf-ness; leaf values to tolerance; gains within 2
    bf16 ULPs) or is a root cause whose competing gains sit within 2 bf16
    ULPs (or at the min_split_gain floor); its subtree is then excluded.
    Rounds after the first root cause get the cascade allowances. Returns
    the number of root causes; raises on a real divergence or when root
    causes exceed one per 500 nodes."""
    tie = 2 ** -6
    T, N = full.feature.shape
    n_rc = 0
    first_rc = None
    for t in range(T):
        cascade = first_rc is not None and t > first_rc

        def gain_ok(ga, gb):
            d = abs(ga - gb)
            return (d <= tie * max(abs(ga), abs(gb), 1e-12)
                    or (cascade and d <= cascade_gain_atol))

        queue = [0]
        while queue:
            s = queue.pop()
            fa, fb = int(full.feature[t, s]), int(other.feature[t, s])
            ba, bb = int(full.threshold_bin[t, s]), \
                int(other.threshold_bin[t, s])
            la, lb = bool(full.is_leaf[t, s]), bool(other.is_leaf[t, s])
            ga, gb = float(full.split_gain[t, s]), \
                float(other.split_gain[t, s])
            if (fa, ba, la) == (fb, bb, lb):
                va = float(full.leaf_value[t, s])
                vb = float(other.leaf_value[t, s])
                dv = abs(va - vb)
                ls = cascade_leaf_scale if cascade else 1.0
                check(dv <= ls * (leaf_atol + leaf_rtol * abs(vb))
                      or dv * full.learning_rate <= ls * leaf_contrib_atol,
                      f"leaf value tree {t} node {s}: {va} vs {vb}")
                check(gain_ok(ga, gb), f"gain tree {t} node {s}: {ga} {gb}")
                if not la and 2 * s + 2 < N:
                    queue += [2 * s + 1, 2 * s + 2]
                continue
            n_rc += 1
            if first_rc is None:
                first_rc = t
            if la != lb:
                g_split = gb if la else ga
                check(abs(g_split - min_split_gain)
                      <= tie * max(g_split, min_split_gain)
                      or (cascade and abs(g_split - min_split_gain)
                          <= cascade_gain_atol),
                      f"split/leaf flip tree {t} node {s}: gain {g_split}")
            else:
                check(gain_ok(ga, gb),
                      f"split flip tree {t} node {s}: gains {ga} vs {gb}")
    check(n_rc <= max(1, T * N // 500), f"{n_rc} root causes")
    return n_rc


def first_divergence(a, b) -> dict:
    """Where two ensembles of the same shape first part: the trees equal in
    (feature, threshold_bin, is_leaf), and the first tree and node (heap
    order) whose decision differs, with both split gains."""
    same = np.all((a.feature == b.feature)
                  & (a.threshold_bin == b.threshold_bin)
                  & (a.is_leaf == b.is_leaf), axis=1)
    out = {"identical_trees": int(same.sum()), "trees": int(len(same))}
    if not same.all():
        t = int(np.argmin(same))
        n = int(np.argmax((a.feature[t] != b.feature[t])
                          | (a.threshold_bin[t] != b.threshold_bin[t])
                          | (a.is_leaf[t] != b.is_leaf[t])))
        out["first"] = {"tree": t, "node": n,
                        "gains": [float(a.split_gain[t, n]),
                                  float(b.split_gain[t, n])]}
    return out


# --------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------- #

def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    bw, f32, src = card_peaks(name)
    print(smi, flush=True)
    emit({"phase": "device", "name": name, "count":
          torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "peak_bytes_per_s": bw, "peak_f32_flops": f32,
          "peak_f32_adds_per_s": f32 / 2, "peak_int32_ops_per_s": f32 / 4,
          "peaks_from": src})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"name": name, "smi": smi, "bw": bw, "f32_add": f32 / 2,
            "int32": f32 / 4}


def phase_build() -> None:
    t0 = time.perf_counter()
    took = _build.build_all()
    for name in _build.sources():
        check(_build.lib_path(name).exists(), f"{name} library built")
    emit({"phase": "build", "sources": _build.sources(),
          "nvcc_s": {k: round(v, 3) for k, v in took.items()},
          "wall_s": round(time.perf_counter() - t0, 3)})


def hist_bound_ms(ni: np.ndarray, F: int, N: int, B: int,
                  card: dict) -> tuple[float, float]:
    """(bytes time, operations time) in ms; the bound is the larger. Each
    input byte the data needs read once (node index of every row; Xb, g, h
    of the active rows), the table written once; 2 f32 adds per active
    (row, feature), at the f32 add rate."""
    act = int((ni >= 0).sum())
    nbytes = ni.size * 4 + act * (F + 8) + N * F * B * 8
    ops = 2 * act * F
    return 1e3 * nbytes / card["bw"], 1e3 * ops / card["f32_add"]


def hist_exact_bound_ms(ni: np.ndarray, F: int, N: int, B: int,
                        card: dict) -> tuple[float, float]:
    """(bytes time, operations time) in ms of K1's exact mode: the node
    index of every row, Xb and f32 g/h of the active rows read once, the
    int64 table (16 B a cell) written once; two int32 adds per active
    (row, feature) (the low words; the high words' carries are data-
    dependent and not counted), at the int32 rate."""
    act = int((ni >= 0).sum())
    nbytes = ni.size * 4 + act * (F + 8) + N * F * B * 16
    ops = 2 * act * F
    return 1e3 * nbytes / card["bw"], 1e3 * ops / card["int32"]


def exact_scales(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The exact mode's f32 [2] power-of-two scales of these g, h, as
    training takes them (ops/grad.fixed_scales over their rows)."""
    return grad.fixed_scales(grad.abs_max2(g, h), g.shape[0])


def check_hist_exact(args: tuple, scales: torch.Tensor, what: str) -> None:
    """K1's exact mode against its plain version (ops/histogram.
    build_histograms_fixed_segment), bitwise, int64."""
    got = hist_cuda.build_histograms_cuda(*args, scales=scales)
    want = histogram.build_histograms_fixed_segment(*args, scales)
    check(got.dtype == torch.int64 and torch.equal(got, want),
          f"{what}: exact kernel != plain")


def index_add_hist(key: torch.Tensor, qg: torch.Tensor, qh: torch.Tensor,
                   m: int) -> tuple:
    """The library yardstick of the exact mode: two int64 index_add_ over
    the (feature, node, bin) key of every (row, feature) (key and the
    per-(row, feature) values made beforehand)."""
    return (torch.zeros(m, dtype=torch.int64, device=key.device)
            .index_add_(0, key, qg),
            torch.zeros(m, dtype=torch.int64, device=key.device)
            .index_add_(0, key, qh))


def check_hist(args: tuple, what: str) -> float:
    """The histogram kernel against its plain version on args = (Xb, g, h,
    node_index, n_nodes, n_bins); max |kernel - plain|. f32 within 1e-5 *
    sum|g| (|h|) over each cell's own rows + 1e-6 (float atomics add in a
    different order every run); integer g/h bitwise."""
    got = hist_cuda.build_histograms_cuda(*args)
    want = histogram.build_histograms_segment(*args)
    Xb, g, h, ni, N, B = args
    if not g.is_floating_point():
        check(got.dtype == torch.int32 and torch.equal(got, want),
              f"{what}: kernel != plain")
        return 0.0
    tol = 1e-5 * histogram.build_histograms_segment(
        Xb, g.abs(), h.abs(), ni, N, B) + 1e-6
    err = (got - want).abs()
    check(bool((err <= tol).all()), f"{what}: max err {float(err.max())}")
    return float(err.max())


def tree_levels(Xd: torch.Tensor, p0: float, y1: np.ndarray,
                depth: int) -> list:
    """[(node_index, n_nodes)] of each level of one tree grown on the card
    (255 bins, sibling subtraction) from logloss-shaped gradients p0 - y1,
    p0 * (1 - p0): the indices ops/grow.level_histograms hands the kernel,
    from level 1 on the left-child index (-1 for right children and frozen
    rows). They are recorded by swapping grow's build_histograms for the
    length of one grow_tree call: the swap is process-wide and not
    thread-safe, so nothing else may build histograms meanwhile."""
    from ddt_tpu_torch.ops import grow

    g = torch.from_numpy((p0 - y1.astype(np.float32)).astype(np.float32)) \
        .to(Xd.device)
    h = torch.full_like(g, p0 * (1 - p0))
    levels = []
    # The f32 level loop's build: the exact mode's (a checkout before it,
    # timed by kernel_bench --other, builds with build_histograms).
    name = ("build_histograms_exact"
            if hasattr(grow.H, "build_histograms_exact")
            else "build_histograms")
    build = getattr(grow.H, name)

    def record(Xb_, g_, h_, ni, n, B, *rest, **kw):
        levels.append((ni.clone(), n))
        return build(Xb_, g_, h_, ni, n, B, *rest, **kw)

    setattr(grow.H, name, record)
    try:
        grow.grow_tree(Xd, g, h, max_depth=depth, n_bins=255,
                       reg_lambda=1.0, min_child_weight=1e-3,
                       min_split_gain=0.0, hist_subtraction=True)
    finally:
        setattr(grow.H, name, build)
    torch.cuda.synchronize()
    seq = [1] + [1 << d for d in range(depth - 1)]
    check([n for _, n in levels] == seq,
          f"levels {[n for _, n in levels]}, want {seq}")
    return levels


def main_path_levels(Xd: torch.Tensor, y: np.ndarray) -> list:
    """tree_levels of one main-path tree: logloss gradients at the base
    score, depth 6 (TREE_SEQ's node counts)."""
    return tree_levels(Xd, float(y.mean()), y, DEPTH)


def phase_hist(binned: dict, levels: list, card: dict,
               flush: torch.Tensor) -> dict:
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    R = binned[255].shape[0]
    g = rng.standard_normal(R).astype(np.float32)
    h = (0.25 * rng.random(R)).astype(np.float32)
    gd, hd = torch.from_numpy(g).to(dev), torch.from_numpy(h).to(dev)
    per_n = {}
    max_err = 0.0
    for B, nodes in HIST_SHAPES:
        Xd = torch.from_numpy(binned[B]).to(dev)
        for N in nodes:
            ni = rng.integers(0, N, size=R).astype(np.int32)
            ni[rng.random(R) < 0.1] = -1
            nid = torch.from_numpy(ni).to(dev)
            args = (Xd, gd, hd, nid, N, B)
            got = hist_cuda.build_histograms_cuda(*args)
            want = histogram.build_histograms_segment(*args)
            # Per cell: 1e-5 * (sum of |g| or |h| over the cell's rows).
            tol = 1e-5 * histogram.build_histograms_segment(
                Xd, gd.abs(), hd.abs(), nid, N, B) + 1e-6
            err = (got - want).abs()
            check(bool((err <= tol).all()),
                  f"hist B={B} N={N}: max err {float(err.max())}")
            err = float(err.max())
            max_err = max(max_err, err)
            # Library yardstick: two weighted bincounts over the combined
            # (f*N + node)*B + bin key (keys and weights made beforehand).
            key = ((torch.arange(FEATURES, device=dev)[None, :] * N
                    + nid.clamp(min=0).long()[:, None]) * B
                   + Xd.long()).reshape(-1)
            wg = torch.where(nid >= 0, gd, 0.0)[:, None] \
                .expand(R, FEATURES).reshape(-1).contiguous()
            wh = torch.where(nid >= 0, hd, 0.0)[:, None] \
                .expand(R, FEATURES).reshape(-1).contiguous()
            m = FEATURES * N * B
            lib = torch.stack([torch.bincount(key, wg, minlength=m),
                               torch.bincount(key, wh, minlength=m)], -1)
            lib = lib.reshape(FEATURES, N, B, 2).permute(1, 0, 2, 3)
            check(bool(((lib.float() - want).abs() <= tol).all()),
                  f"bincount yardstick B={B} N={N}")
            t_bytes, t_ops = hist_bound_ms(ni, FEATURES, N, B, card)
            cas = {
                "kernel_ms": time_ms(lambda: hist_cuda.build_histograms_cuda(
                    *args), 20, flush),
                "library_ms": time_ms(lambda: (
                    torch.bincount(key, wg, minlength=m),
                    torch.bincount(key, wh, minlength=m)), 10, flush),
                "bound_ms": max(t_bytes, t_ops), "max_abs_err": err}
            del wg, wh, lib, tol
            # The exact mode (what f32 training runs) on the same inputs:
            # bitwise its plain version and the int64 index_add_
            # yardstick, which is exact too.
            sc = exact_scales(gd, hd)
            check_hist_exact(args, sc, f"hist exact B={B} N={N}")
            act = (nid >= 0)[:, None].expand(R, FEATURES).reshape(-1)
            qg = torch.where(act, grad.to_fixed(gd, sc[0])[:, None]
                             .expand(R, FEATURES).reshape(-1), 0)
            qh = torch.where(act, grad.to_fixed(hd, sc[1])[:, None]
                             .expand(R, FEATURES).reshape(-1), 0)
            lib = torch.stack(index_add_hist(key, qg, qh, m), -1) \
                .reshape(FEATURES, N, B, 2).permute(1, 0, 2, 3)
            check(torch.equal(lib, histogram.build_histograms_fixed_segment(
                *args, sc)), f"int64 index_add_ yardstick B={B} N={N}")
            e_bytes, e_ops = hist_exact_bound_ms(ni, FEATURES, N, B, card)
            row = {
                "kernel_ms": time_ms(lambda: hist_cuda.build_histograms_cuda(
                    *args, scales=sc), 20, flush),
                "plain_ms": time_ms(
                    lambda: histogram.build_histograms_fixed_segment(
                        *args, sc), 5, flush),
                "library_ms": time_ms(
                    lambda: index_add_hist(key, qg, qh, m), 10, flush),
                "bound_ms": max(e_bytes, e_ops),
                "bound_bytes_ms": e_bytes, "bound_ops_ms": e_ops,
                "max_abs_err": 0.0, "cas": cas,
            }
            del key, qg, qh, lib, act
            per_n[(B, N)] = row
            emit({"phase": "hist", "rows": R, "features": FEATURES,
                  "bins": B, "nodes": N, "frozen_frac": 0.1,
                  "plan": hist_cuda.plan_tiles(
                      N, FEATURES, B, _build.smem_limit(dev),
                      hist_cuda.CELL_BYTES_EXACT).__dict__,
                  **row})
    # One tree of the main path with sibling subtraction (on for the
    # card) builds 1, 1, 2, 4, 8, 16 nodes at 255 bins.
    seq = TREE_SEQ
    tree = {k: sum(per_n[(255, n)][k] for n in seq)
            for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms",
                      "bound_bytes_ms", "bound_ops_ms")}
    tree["bound_by"] = ("bytes" if tree["bound_bytes_ms"]
                        >= tree["bound_ops_ms"] else "operations")
    tree["cas_kernel_ms"] = sum(per_n[(255, n)]["cas"]["kernel_ms"]
                                for n in seq)
    emit({"phase": "hist", "per_tree_main_path": list(seq), **tree})
    # The same tree on the main path's own node indices: from level 1 on
    # only left children are built, so about half the rows are -1.
    real = hist_tree(torch.from_numpy(binned[255]).to(dev), levels, card,
                     flush, seed=7)
    emit({"phase": "hist", "per_tree_main_path_indices": list(seq),
          "synthetic_kernel_ms": tree["kernel_ms"], **real})
    return {**tree, "max_abs_err": 0.0, "cas_max_abs_err": max(
        max_err, real["cas_max_abs_err"]),
            "main_path_indices_ms": real["kernel_ms"],
            "main_path_indices_cas_ms": real["cas_kernel_ms"]}


def exact_grid_ensemble(T, depth, F, B, C, cat, seed=0):
    """Random pushed-down-able trees with leaf values on the 1/8 grid,
    learned default directions and categorical features."""
    rng = np.random.default_rng(seed)
    N = 2 ** (depth + 1) - 1
    ens = empty_ensemble(T, depth, F, 0.125, 0.25, "softmax", n_classes=C,
                         missing_bin=True, n_bins=B, cat_features=cat)
    ens.feature[:] = rng.integers(0, F, size=(T, N))
    ens.threshold_bin[:] = rng.integers(0, B - 2, size=(T, N))
    ens.is_leaf[:] = rng.random((T, N)) < 0.2
    ens.leaf_value[:] = rng.integers(-7, 8, size=(T, N)) / 8.0
    ens.default_left[:] = rng.random((T, N)) < 0.5
    return ens


def device_operands(ce, dev):
    ops = [torch.from_numpy(a).to(dev) for a in ce.arrays()]
    ef, et, bv, coh, *rest = ops
    dl = rest.pop(0) if ce.eff_dl is not None else None
    cat = rest.pop(0) if ce.eff_cat is not None else None
    tables = predict_cuda.pack_tables(ef, et, bv, coh, ce.max_depth,
                                      eff_dl=dl, eff_cat=cat)
    kw = dict(learning_rate=ce.learning_rate, base=ce.base_score,
              tree_chunk=ce.tree_chunk,
              missing_bin_value=ce.missing_bin_value)

    def kernel(X):
        return predict_cuda.traverse_cuda(tables, X, **kw)

    def plain(X):
        return predict.predict_effective_plain(
            ef, et, bv, coh, X, max_depth=ce.max_depth, eff_dl=dl,
            eff_cat=cat, **kw)

    return tables, kernel, plain


def k3_plan(tables, R: int, F: int):
    """The launch plan traverse_cuda takes for R rows of F features."""
    dev = tables.rec.device
    return predict_lut_cuda.plan_launch(
        R, tables.n_trees, tables.max_depth, F, "float32", tables.n_classes,
        _build.smem_limit(dev), predict_lut_cuda.sm_count(dev))


def traverse_sizes(tables, F: int) -> list:
    """Rows a call at which phases traverse_exact and traverse_trained
    hold K3 bitwise: serving sizes, then both sides of the crossover where
    the launch plan leaves the pairs mapping for the rows mapping (a block
    of rows-mapping rows an SM: 67,584 rows on an H100)."""
    sms = predict_lut_cuda.sm_count(tables.rec.device)
    cross = sms * k3_plan(tables, ROWS, F).rows
    check(k3_plan(tables, cross - 1, F).pairs
          and not k3_plan(tables, cross, F).pairs,
          f"mapping crossover at {cross} rows")
    return list(LUT_EXACT_SIZES) + [cross - 1, cross]


def check_traverse(kernel, plain, tables, Xd: torch.Tensor,
                   what: str) -> tuple[np.ndarray, list]:
    """K3 against its plain version on all of Xd and on its first rows at
    every traverse_sizes() count, bitwise; each smaller call's rows also
    equal the full call's. Returns (the full call's scores, the sizes)."""
    got = kernel(Xd).cpu().numpy()
    check(np.array_equal(got, plain(Xd).cpu().numpy()),
          f"{what}: kernel == plain, bitwise, {Xd.shape[0]} rows")
    sizes = traverse_sizes(tables, Xd.shape[1])
    for n in sizes:
        Xn = Xd[:n].contiguous()
        small = kernel(Xn).cpu().numpy()
        check(np.array_equal(small, plain(Xn).cpu().numpy())
              and np.array_equal(small, got[:n]),
              f"{what}: {n} rows, kernel == plain == the full call")
    return got, sizes


def phase_traverse_exact(Xb: np.ndarray) -> None:
    dev = torch.device("cuda")
    for trees, rows in ((70, len(Xb)), (PASS_TREES, PASS_ROWS)):
        ens = exact_grid_ensemble(trees, DEPTH, FEATURES, 255, 7, (3, 10))
        ce = ens.compile(tree_chunk=64)
        tables, kernel, plain = device_operands(ce, dev)
        Xd = torch.from_numpy(Xb[:rows]).to(dev)
        got, sizes = check_traverse(kernel, plain, tables, Xd,
                                    f"traverse exact-grid {trees} trees")
        passes = [k3_plan(tables, n, FEATURES).sub < tables.n_trees
                  for n in (1, rows)]
        check(all(passes) == (trees == PASS_TREES),
              f"{trees} trees staged pass by pass: {passes}")
        sub = min(50_000, rows)
        oracle = ens.predict_raw(Xb[:sub], binned=True)
        check(np.array_equal(got[:sub], oracle),
              f"traverse exact-grid {trees} trees: kernel == host oracle")
        emit({"phase": "traverse_exact", "rows": rows, "trees": trees,
              "trees_packed": tables.n_trees, "depth": DEPTH, "classes": 7,
              "missing": True, "cat": [3, 10], "bitwise_equal": True,
              "bitwise_equal_at_rows": sizes, "staged_pass_by_pass": trees
              == PASS_TREES, "oracle_rows": sub})


class HostTransformCount:
    """Counts BinMapper.transform calls (host binning) while open."""

    def __enter__(self):
        self.calls = 0
        self._orig = BinMapper.transform

        def counted(mapper, X):
            self.calls += 1
            return self._orig(mapper, X)

        BinMapper.transform = counted
        return self

    def __exit__(self, *exc):
        BinMapper.transform = self._orig


def synced(fn):
    """(fn(), host seconds of fn ending in a synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_main(X: np.ndarray, y: np.ndarray) -> dict:
    cfg = TrainConfig(n_trees=N_TREES, max_depth=DEPTH, n_bins=255,
                      device="cuda")
    zero_counters()
    with HostTransformCount() as host_bins:
        t0 = time.perf_counter()
        res = api.train(X, y, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        p = api.predict(res.ensemble, X, mapper=res.mapper)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    launches = {**read_counters(), "host_transforms": host_bins.calls}
    check(launches["hist"] > 0, "histogram kernel launched on main path")
    check(launches["hist_f32_atomics"] == 0,
          "the float-atomic histogram mode is on no training path")
    check(hist_cuda.launches_int == 0,
          "integer histogram mode not launched on the f32 path")
    check(launches["traverse"] > 0, "traversal kernel launched on main path")
    check(launches["binning"] == 2, "train and predict binned on the card")
    check(host_bins.calls == 0, "no host binning on the main path")
    check(launches["graph_replays"] == N_TREES,
          f"{launches['graph_replays']} round replays for {N_TREES} trees")
    # One launch a level with sibling subtraction, counted per replay; a
    # capture adds one warm-up round outside the graph.
    check(DEPTH * N_TREES <= launches["hist"] <= DEPTH * (N_TREES + 1),
          f"{launches['hist']} histogram launches for {N_TREES} trees")
    check(p.shape == (len(X),) and np.all(np.isfinite(p)),
          "predictions finite, one per row")
    train_auc = auc(y, p)
    check(train_auc >= 0.80, f"train AUC {train_auc} >= 0.80")
    # Scores equal the host oracle's (numpy traversal) to f32 order.
    sub = 50_000
    Xb_sub = res.mapper.transform(X[:sub])
    raw = api.predict(res.ensemble, Xb_sub, binned=True, raw=True)
    oracle = res.ensemble.predict_raw(Xb_sub, binned=True)
    check(np.all(np.abs(raw - oracle) <= 1e-5 * (np.abs(oracle) + 1)),
          "main-path scores == host oracle")
    emit({"phase": "main", "rows": len(X), "features": FEATURES,
          "bins": 255, "depth": DEPTH, "trees": N_TREES,
          "train_s": t1 - t0, "predict_s": t2 - t1,
          "train_auc": train_auc, "launches": launches,
          "hist_launches_per_tree": launches["hist"] / N_TREES})
    pieces = main_pieces(X, y, cfg)
    return {"res": res, "launches": launches, "auc": train_auc,
            "train_s": t1 - t0, "pieces": pieces}


def main_pieces(X: np.ndarray, y: np.ndarray, cfg: TrainConfig) -> dict:
    """api.train's and api.predict's steps on the same rows, each timed
    apart (host clock ending in a synchronize), one line each."""
    dev = torch.device("cuda")
    out = {}
    mapper, out["fit_bin_mapper_s"] = synced(
        lambda: fit_bin_mapper(X, n_bins=255, seed=cfg.seed))
    Xd, out["upload_f32_s"] = synced(lambda: torch.from_numpy(X).to(dev))
    Xb, out["bin_s"] = synced(lambda: mapper.transform_device(Xd, dev))
    _, out["ref_counts_s"] = synced(
        lambda: feature_bincounts(Xb, 255).cpu().numpy())
    be = get_backend(cfg)
    ens, out["loop_s"] = synced(lambda: Driver(be, cfg).fit(Xb, y))
    out["loop_ms_per_tree"] = 1e3 * out["loop_s"] / N_TREES
    out["capture_s"] = be.last_capture_s
    Xp, out["predict_upload_and_bin_s"] = synced(
        lambda: mapper.transform_device(X, dev))
    _, out["predict_score_s"] = synced(lambda: be.predict_raw(ens, Xp))
    for k, v in out.items():
        emit({"phase": "main", "piece": k, "value": v})
    return out


def binning_rows(X: np.ndarray) -> np.ndarray:
    """X with binning's edge cases mixed in: NaN, +/-inf, -0.0 and 0.0, a
    low-cardinality column (runs of duplicate edges) and an integer column
    (fitted as identity)."""
    rng = np.random.default_rng(21)
    Xs = X.copy()
    Xs[:, 6] = rng.integers(0, 4, len(X))
    Xs[:, 5] = rng.integers(0, 40, len(X))
    for v, frac in ((np.nan, 0.03), (np.inf, 0.005), (-np.inf, 0.005),
                    (-0.0, 0.005), (0.0, 0.005)):
        Xs[rng.random(Xs.shape) < frac] = v
    return Xs


def phase_bin(X: np.ndarray, card: dict, flush: torch.Tensor) -> dict:
    dev = torch.device("cuda")
    Xs = binning_rows(X)
    R, F = Xs.shape
    out = {}
    for policy in ("zero", "learn"):
        mapper = fit_bin_mapper(Xs, n_bins=255, missing_policy=policy,
                                cat_features=(5,))
        check(mapper.non_identity_columns((5,)) == [], "identity column")
        check(len(np.unique(mapper.edges[6, :mapper.n_value_bins - 1]))
              < mapper.n_value_bins - 1, "duplicate edges in column 6")
        t0 = time.perf_counter()
        host = mapper.transform(Xs)
        host_s = time.perf_counter() - t0
        ups = []
        for _ in range(3):
            Xd, t = synced(lambda: torch.from_numpy(Xs).to(dev))
            ups.append(t)
        edges = quantize.device_edges(mapper, dev)
        got = quantize.transform_binned(Xd, edges, 255, mapper.missing_bin)
        check(np.array_equal(got.cpu().numpy(), host),
              f"binning {policy}: card == BinMapper.transform, bitwise")
        counts = feature_bincounts(got, 255).cpu().numpy()
        check(np.array_equal(counts, feature_bincounts(host, 255)),
              f"binning {policy}: feature_bincounts card == numpy")
        nbytes = R * F * 4 + R * F
        row = {"ms": time_ms(lambda: quantize.transform_binned(
                   Xd, edges, 255, mapper.missing_bin), 20, flush),
               "bound_ms": 1e3 * nbytes / card["bw"], "bound_by": "bytes",
               "bytes": nbytes, "upload_s": float(np.median(ups)),
               "upload_s_all": ups, "host_transform_s": host_s,
               "bincounts_ms": time_ms(
                   lambda: feature_bincounts(got, 255), 10, flush)}
        out[policy] = row
        emit({"phase": "bin", "rows": R, "features": F, "bins": 255,
              "missing_policy": policy, "nan": int(np.isnan(Xs).sum()),
              "identity_columns": [5], "bitwise_equal": True,
              "bincounts_bitwise_equal": True, **row})
        del Xd, got
    return out


def phase_fused(Xb: np.ndarray, y: np.ndarray) -> dict:
    dev = torch.device("cuda")
    Xd = torch.from_numpy(Xb).to(dev)
    base = TrainConfig(n_trees=FUSED_TREES, max_depth=DEPTH, n_bins=255,
                       min_split_gain=1e-3)
    cases = (("int8", dict(grad_dtype="int8")),
             ("f32", {}),
             ("int8 bagging 0.8 colsample 0.8",
              dict(grad_dtype="int8", subsample=0.8, colsample_bytree=0.8,
                   seed=3)))
    out = {}
    for what, kw in cases:
        cfg = base.replace(**kw)
        r0 = cuda_backend.graph_replays
        fused, fused_s = synced(
            lambda: Driver(get_backend(cfg), cfg).fit(Xd, y))
        check(cuda_backend.graph_replays - r0 == FUSED_TREES,
              f"fused {what}: {FUSED_TREES} replays")
        gran, gran_s = synced(
            lambda: Driver(tasks.Granular(cfg), cfg).fit(Xd, y))
        capture_s = get_backend(cfg).last_capture_s
        row = {"fused_ms_per_tree": 1e3 * fused_s / FUSED_TREES,
               "fused_ms_per_tree_after_capture":
                   1e3 * (fused_s - capture_s) / FUSED_TREES,
               "granular_ms_per_tree": 1e3 * gran_s / FUSED_TREES,
               "capture_s": capture_s}
        # Exact histograms (f32 in fixed point, int8 in int32): the
        # graph's trees are the granular loop's bit for bit.
        for k in TREE_FIELDS:
            check(np.array_equal(getattr(gran, k), getattr(fused, k)),
                  f"fused {what}: {k} == granular, bitwise")
        row["bitwise_equal"] = True
        out[what] = row
        emit({"phase": "fused", "case": what, "rows": len(Xb),
              "trees": FUSED_TREES, "depth": DEPTH, **row})
    cfg = base.replace(**cases[2][1])
    one = Driver(get_backend(cfg), cfg).fit(Xd, y)
    cap7 = cfg.replace(fused_block_rounds=7)
    blocks = Driver(get_backend(cap7), cap7).fit(Xd, y)
    for k in TREE_FIELDS:
        check(np.array_equal(getattr(one, k), getattr(blocks, k)),
              f"fused block cap 7 vs 100: {k} bitwise")
    emit({"phase": "fused", "case": "block cap 7 vs 100, " + cases[2][0],
          "bitwise_equal": True})
    return out


def phase_traverse_trained(res, X: np.ndarray, card: dict,
                           flush: torch.Tensor) -> dict:
    dev = torch.device("cuda")
    ce = res.ensemble.compile(tree_chunk=64)
    tables, kernel, plain = device_operands(ce, dev)
    Xd = res.mapper.transform_device(X, dev)
    _, sizes = check_traverse(kernel, plain, tables, Xd, "traverse trained")
    R, F = Xd.shape
    table_bytes = tables.rec.numel()
    nbytes = R * F + R * ce.n_classes_out * 4 + table_bytes
    compares = traverse_compares(ce, Xd)
    adds = R * res.ensemble.n_trees
    t_bytes = 1e3 * nbytes / card["bw"]
    t_ops = 1e3 * (compares / card["int32"] + adds / card["f32_add"])
    row = {
        "kernel_ms": time_ms(lambda: kernel(Xd), 20, flush),
        "plain_ms": time_ms(lambda: plain(Xd), 3, flush),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "int32_compares": compares, "f32_adds": adds,
        "max_abs_err": 0.0,
    }
    emit({"phase": "traverse_trained", "rows": R, "trees": N_TREES,
          "trees_padded": ce.n_trees_padded, "trees_packed": tables.n_trees,
          "depth": DEPTH, "bitwise_equal_at_rows": sizes, **row})
    return row


def traverse_compares(ce, Xd: torch.Tensor) -> int:
    """Integer compares this data needs: one per real (not pushed-down)
    split node on each row's path (the bound adds one f32 add per row and
    real tree). Each row's path through every tree is walked level by
    level, as the plain descent routes it; one host read at the end."""
    dev = Xd.device
    D = ce.max_depth
    ef = torch.from_numpy(ce.eff_feat).to(dev)
    et = torch.from_numpy(ce.eff_thr).to(dev)
    T, N = ef.shape
    ef_flat, et_flat = ef.reshape(-1), et.reshape(-1)
    tree_base = (torch.arange(T, dtype=torch.int64, device=dev) * N)[None]
    total = torch.zeros((), dtype=torch.int64, device=dev)
    step = max(1, (1 << 26) // T)          # (row, tree) pairs a step
    for r0 in range(0, Xd.shape[0], step):
        x = Xd[r0:r0 + step]
        R, F = x.shape
        row_base = (torch.arange(R, dtype=torch.int64, device=dev)
                    * F)[:, None]
        x_flat = x.reshape(-1).to(torch.int32)
        k = torch.zeros((R, T), dtype=torch.int64, device=dev)
        for d in range(D):
            node = tree_base + ((1 << d) - 1) + k
            f = ef_flat[node]
            total += (f >= 0).sum()
            v = torch.where(f >= 0, x_flat[row_base + f.clamp(min=0)], 0)
            k = 2 * k + (v > et_flat[node]).to(torch.int64)
    return int(total)


def lut_grid_ensemble(T, depth, F, B, C, cat, qmax, seed=0):
    """exact_grid_ensemble with leaves on the 1/(qmax+1) grid and each
    tree's largest |leaf| pinned to qmax/(qmax+1) (the left spine stays
    internal): the per-tree scale max/qmax is exactly 1/(qmax+1), so int8
    (qmax 127) or int4 (qmax 7) quantization is lossless."""
    ens = exact_grid_ensemble(T, depth, F, B, C, cat, seed=seed)
    rng = np.random.default_rng(seed + 1)
    ens.leaf_value[:] = rng.integers(
        -qmax, qmax + 1, size=ens.leaf_value.shape) / (qmax + 1)
    ens.is_leaf[:, [(1 << d) - 1 for d in range(depth)]] = False
    ens.leaf_value[:, (1 << depth) - 1] = qmax / (qmax + 1)
    return ens


def lut_callables(tables, dev):
    """(operand tensors on the card, kernel(X), plain(X)) of the tier
    `tables` serves: K4 for fp16/int8 leaves, K5 for int4."""
    if tables.leaf_dtype == "int4":
        p = tables.pack_int4()
        host, static = p.ops, p.static_kwargs()
        kern = predict_lut_cuda.lut_int4_cuda
        plain = predict_lut.predict_effective_lut4_plain
    else:
        host = predict_lut.lut_device_operands(tables)
        static = predict_lut.lut_static_kwargs(tables)
        kern = predict_lut_cuda.lut_int8_cuda
        plain = predict_lut.predict_effective_lut_plain
    ops = tuple(torch.from_numpy(a).to(dev) for a in host)
    n_int = (1 << tables.max_depth) - 1
    extras = dict(
        cls=torch.from_numpy(tables.cls_oh.argmax(axis=1).astype(np.int32))
        .to(dev), max_feature=int(tables.eff_feat[:, :n_int].max()))
    return (ops, lambda X: kern(ops, X, **static, **extras),
            lambda X: plain(ops, X, **static))


def phase_lut_exact(X: np.ndarray, Xb: np.ndarray) -> None:
    dev = torch.device("cuda")
    Xb13 = fit_bin_mapper(X, n_bins=13).transform_device(X).cpu().numpy()
    cases = (("K4 fp16", "float16", 255, 7, Xb),
             ("K4 int8", "int8", 255, 127, Xb),
             ("K5 13 bins", "int4", 13, 7, Xb13),
             ("K5 255 bins", "int4", 255, 7, Xb))
    for what, leaf_dtype, B, qmax, rows in cases:
        ens = lut_grid_ensemble(70, DEPTH, FEATURES, B, 7, (3, 10), qmax)
        ce = ens.compile(tree_chunk=64)
        tables = ce.quantize(leaf_dtype)
        check(tables.max_abs_err == 0.0, f"{what}: lossless grid")
        packed = (tables.pack_int4().thr_packed
                  if leaf_dtype == "int4" else None)
        if leaf_dtype == "int4":
            check(packed == (B <= 15), f"{what}: thr_packed {packed}")
        _, kernel, plain = lut_callables(tables, dev)
        Xd = torch.from_numpy(rows).to(dev)
        got = kernel(Xd).cpu().numpy()
        check(np.array_equal(got, plain(Xd).cpu().numpy()),
              f"{what}: kernel == plain, bitwise")
        # Serving sizes take the other mapping: bitwise there too, and a
        # row's score does not depend on its batch.
        for n in LUT_EXACT_SIZES:
            Xn = Xd[:n].contiguous()
            small = kernel(Xn).cpu().numpy()
            check(np.array_equal(small, plain(Xn).cpu().numpy())
                  and np.array_equal(small, got[:n]),
                  f"{what}: {n} rows, kernel == plain == the 1M-row call")
        _, k3, _ = device_operands(ce, dev)
        check(np.array_equal(got, k3(Xd).cpu().numpy()),
              f"{what}: kernel == traversal kernel on the f32 ensemble")
        emit({"phase": "lut_exact", "case": what, "leaf_dtype": leaf_dtype,
              "bins": B, "thr_packed": packed, "rows": len(rows),
              "trees": 70, "depth": DEPTH, "classes": 7, "missing": True,
              "cat": [3, 10], "bitwise_equal_plain": True,
              "bitwise_equal_at_rows": list(LUT_EXACT_SIZES),
              "bitwise_equal_traverse": True, "max_abs_err": 0.0})


def lut_bound_ms(ce, ops, Xd, card: dict, muls: bool,
                 n_trees: int) -> dict:
    """The traversal's bound (traverse_compares) over the quantized
    tables: bytes = rows in, scores out, every operand and the per-tree
    class once; operations = INT32 compares plus one f32 add per row and
    real tree, and one f32 multiply more where leaves are dequantized by
    scale (priced at the add rate)."""
    R, F = Xd.shape
    table_bytes = sum(t.numel() * t.element_size() for t in ops) \
        + 4 * ce.n_trees_padded
    nbytes = R * F + R * ce.n_classes_out * 4 + table_bytes
    compares = traverse_compares(ce, Xd)
    flops = R * n_trees * (2 if muls else 1)
    t_bytes = 1e3 * nbytes / card["bw"]
    t_ops = 1e3 * (compares / card["int32"] + flops / card["f32_add"])
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "table_bytes": table_bytes,
            "int32_compares": compares, "f32_ops": flops}


def lut_measure(what, tables, ce, n_trees, Xd, card, flush,
                k3_out=None) -> dict:
    dev = Xd.device
    ops, kernel, plain = lut_callables(tables, dev)
    got = kernel(Xd)
    want = plain(Xd)
    err = (got - want).abs()
    check(bool((err <= 1e-5 * (want.abs() + 1)).all()),
          f"{what}: kernel vs plain max err {float(err.max())}")
    row = {"max_abs_err": float(err.max())}
    if k3_out is not None:
        d = (got - k3_out).abs()
        lim = tables.max_abs_err * (1 + 1e-5) + 1e-5 * (k3_out.abs() + 1)
        check(bool((d <= lim).all()),
              f"{what}: vs traversal kernel {float(d.max())} > "
              f"max_abs_err {tables.max_abs_err}")
        row["max_abs_diff_vs_traverse"] = float(d.max())
    row.update(lut_bound_ms(ce, ops, Xd, card,
                            muls=tables.leaf_dtype != "float16",
                            n_trees=n_trees))
    row["kernel_ms"] = time_ms(lambda: kernel(Xd), 20, flush)
    row["plain_ms"] = time_ms(lambda: plain(Xd), 3, flush)
    row["library_ms"] = None       # no single PyTorch call computes it
    row["tables_max_abs_err"] = tables.max_abs_err
    return row


def phase_lut_trained(res, X: np.ndarray, card: dict,
                      flush: torch.Tensor) -> dict:
    dev = torch.device("cuda")
    ce = res.ensemble.compile(tree_chunk=64)
    k3_tables, k3, _ = device_operands(ce, dev)
    Xd = res.mapper.transform_device(X, dev)
    k3_out = k3(Xd)
    rows = {}
    for name, leaf_dtype in (("lut", "float16"), ("lut4", "int4")):
        tables = ce.quantize(leaf_dtype)
        rows[name] = lut_measure(name, tables, ce, res.ensemble.n_trees,
                                 Xd, card, flush, k3_out)
        rows[name]["thr_packed"] = (tables.pack_int4().thr_packed
                                    if leaf_dtype == "int4" else None)
        emit({"phase": "lut_trained", "kernel": name,
              "leaf_dtype": leaf_dtype, "rows": Xd.shape[0],
              "trees": N_TREES, "depth": DEPTH, **rows[name]})
    emit({"phase": "lut_trained", "table_bytes": {
        "f32 (traverse)": k3_tables.rec.numel(),
        "int8 tier (lut)": rows["lut"]["table_bytes"],
        "int4 tier (lut4)": rows["lut4"]["table_bytes"]}})
    return rows


def phase_lut4_packed(X: np.ndarray, y: np.ndarray, card: dict,
                      flush: torch.Tensor):
    cfg = TrainConfig(n_trees=N_TREES, max_depth=DEPTH, n_bins=15)
    t0 = time.perf_counter()
    res = api.train(X, y, cfg)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    ce = res.ensemble.compile(tree_chunk=64)
    tables = ce.quantize("int4")
    check(tables.pack_int4().thr_packed, "15-bin model: thr_packed")
    Xd = res.mapper.transform_device(X, get_backend(cfg).device)
    _, k3, _ = device_operands(ce, Xd.device)
    row = lut_measure("lut4 packed", tables, ce, res.ensemble.n_trees, Xd,
                      card, flush, k3(Xd))
    emit({"phase": "lut4_packed", "rows": len(X), "bins": 15,
          "trees": N_TREES, "depth": DEPTH, "train_s": train_s,
          "thr_packed": True, **row})
    return res, row


def serve_tier(tier, b255, b15, pool, refs) -> dict:
    """One engine at `tier` under load with a hot swap, then the express
    lane at idle; every response checked against offline api.predict."""
    eng = ServeEngine(b255, TrainConfig(), quantize=tier, max_batch=256,
                      max_wait_ms=1.0)
    try:
        results, errors = [], []
        lock = threading.Lock()
        per_thread = SERVE_REQUESTS // SERVE_THREADS

        def submitter(tid):
            rng = np.random.default_rng(tid)
            for _ in range(per_thread):
                s = int(rng.integers(0, SERVE_POOL - 64))
                c = int(rng.integers(1, 65))
                try:
                    req = eng.predict_async(pool[s:s + c])
                    out = req.result(timeout=60.0)
                except Exception as e:  # collected, checked empty below
                    with lock:
                        errors.append(repr(e))
                    continue
                with lock:
                    results.append((s, c, req.model_token, out))

        threads = [threading.Thread(target=submitter, args=(t,))
                   for t in range(SERVE_THREADS)]
        bins0 = quantize.transforms
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        while True:
            with lock:
                n_done = len(results) + len(errors)
            if n_done >= SERVE_REQUESTS // 2 or \
                    not any(t.is_alive() for t in threads):
                break
            time.sleep(0.001)
        swap = eng.swap(b15)
        for t in threads:
            t.join(120)
        load_s = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "submitters done")
        check(not errors, f"serve {tier}: errors {errors[:3]}")
        load = eng.stats.window_summary(reset=True)
        # Every request is float rows: one transform on the card a batch.
        per_batch = (quantize.transforms - bins0) / load["batches"]
        check(per_batch == 1.0, f"serve {tier}: {per_batch} transforms a "
              "batch")
        # Median request-trace segments of the last loaded requests.
        ring = eng.stats.traces_snapshot()
        segments = {k: float(np.median([t[k] for t in ring]))
                    for k in ("handler_ms", "queue_ms", "gate_ms",
                              "device_ms", "wake_ms", "total_ms")}
        # Express lane: single rows at an idle queue, one at a time.
        rng = np.random.default_rng(99)
        for _ in range(EXPRESS_REQUESTS):
            s = int(rng.integers(0, SERVE_POOL))
            req = eng.predict_async(pool[s:s + 1])
            out = req.result(timeout=60.0)     # stamps req.model_token
            results.append((s, 1, req.model_token, out))
        express = eng.stats.window_summary(reset=True)
        tokens = {swap["old"], swap["new"]}
        for s, c, token, out in results:
            check(token in tokens, f"serve {tier}: unknown token")
            check(np.array_equal(out, refs[token, tier][s:s + c]),
                  f"serve {tier}: rows [{s}:{s + c}] differ from offline "
                  "api.predict")
        by_token = {tok: sum(1 for r in results if r[2] == tok)
                    for tok in tokens}
        check(all(by_token.values()), f"serve {tier}: both models served")
        for tok in tokens:
            got = eng.backend.resolved_predict_impl(tok)
            check(got == TIER_RESOLVED[tier],
                  f"serve {tier}: token {tok[:12]} resolved to {got}")
        check(eng.health()["predict_impl"] == TIER_RESOLVED[tier],
              f"serve {tier}: health tier")
        check(express["express"] >= 1, f"serve {tier}: express lane used")
    finally:
        eng.close()
    return {"tier": tier or "f32", "requests": load["requests"],
            "load_s": load_s, "batches": load["batches"],
            "coalesce_max": load["coalesce_max"],
            "coalesce_mean": load["coalesce_mean"],
            "p50_ms": load["p50_ms"], "p99_ms": load["p99_ms"],
            "p999_ms": load["p999_ms"], "responses_by_model": list(
                by_token.values()), "gate_ms": segments["gate_ms"],
            "transforms_per_batch": per_batch, "trace_median_ms": segments,
            "express_requests": express["requests"],
            "express_lane": express["express"],
            "express_p50_ms": express["p50_ms"],
            "express_p99_ms": express["p99_ms"]}


def phase_serve(res255, res15, X: np.ndarray) -> dict:
    b255 = api.ModelBundle(res255.ensemble, res255.mapper)
    b15 = api.ModelBundle(res15.ensemble, res15.mapper)
    pool = np.ascontiguousarray(X[:SERVE_POOL], np.float32)
    # Offline answers first: their launches are the yardstick's, not the
    # serving path's.
    refs = {}
    for tier, impl in TIER_IMPL.items():
        for b in (b255, b15):
            token = b.ensemble.compile(tree_chunk=64).token
            refs[token, tier] = api.predict(
                b, pool, cfg=TrainConfig(predict_impl=impl))
    torch.cuda.synchronize()
    predict_cuda.launches = 0
    predict_lut_cuda.launches_lut = 0
    predict_lut_cuda.launches_lut4 = 0
    t0 = time.perf_counter()
    tiers = [serve_tier(t, b255, b15, pool, refs) for t in TIER_IMPL]
    torch.cuda.synchronize()
    launches = {"traverse": predict_cuda.launches,
                "lut": predict_lut_cuda.launches_lut,
                "lut4": predict_lut_cuda.launches_lut4}
    for name in ("traverse", "lut", "lut4"):
        check(launches[name] > 0, f"{name} kernel launched while serving")
    for row in tiers:
        emit({"phase": "serve", **row})
    emit({"phase": "serve", "wall_s": time.perf_counter() - t0,
          "launches": launches, "max_batch": 256, "max_wait_ms": 1.0,
          "threads": SERVE_THREADS})
    return launches


def phase_serve_kernels(res, X: np.ndarray, served: dict,
                        flush: torch.Tensor) -> dict:
    """K3, K4 (fp16 leaves) and K5 at serving batch sizes on phase 5's
    model: device time of one call at 1, 16, 64 and 256 binned rows, with
    L2 warm and with L2 flushed before each call."""
    dev = torch.device("cuda")
    ce = res.ensemble.compile(tree_chunk=64)
    _, k3, _ = device_operands(ce, dev)
    kernels = {"traverse": k3}
    for name, leaf_dtype in (("lut", "float16"), ("lut4", "int4")):
        _, kern, _ = lut_callables(ce.quantize(leaf_dtype), dev)
        kernels[name] = kern
    Xb = torch.from_numpy(res.mapper.transform(
        X[:max(SERVE_SIZES)])).to(dev)
    out = {}
    for name, kern in kernels.items():
        out[name] = {}
        for n in SERVE_SIZES:
            Xn = Xb[:n].contiguous()
            out[name][n] = {
                "l2_warm_ms": time_ms(lambda: kern(Xn), 50),
                "l2_flushed_ms": time_ms(lambda: kern(Xn), 20, flush)}
        emit({"phase": "serve_kernels", "kernel": name, "trees": N_TREES,
              "depth": DEPTH, "serve_launches": served[name],
              "by_rows": {str(n): v for n, v in out[name].items()}})
    # The latency floor of one launch: an empty kernel, timed the same way.
    out["empty"] = {
        "l2_warm_ms": time_ms(lambda: predict_lut_cuda.empty_launch(dev), 50),
        "l2_flushed_ms": time_ms(lambda: predict_lut_cuda.empty_launch(dev),
                                 20, flush)}
    emit({"phase": "serve_kernels", "kernel": "empty", **out["empty"]})
    return out


def phase_parity(X: np.ndarray, y: np.ndarray) -> None:
    Xs, ys = X[:PARITY_ROWS], y[:PARITY_ROWS]
    cfg = TrainConfig(n_trees=PARITY_TREES, max_depth=DEPTH, n_bins=255,
                      min_split_gain=1e-3)
    t0 = time.perf_counter()
    on_card = api.train(Xs, ys, cfg, device="cuda")
    t1 = time.perf_counter()
    on_cpu = api.train(Xs, ys, cfg, device="cpu")
    t2 = time.perf_counter()
    n_rc = trees_match_mod_ties(on_cpu.ensemble, on_card.ensemble, 1e-3)
    a_card = auc(ys, api.predict(on_card.ensemble, Xs,
                                 mapper=on_card.mapper))
    a_cpu = auc(ys, api.predict(on_cpu.ensemble, Xs, mapper=on_cpu.mapper,
                                device="cpu"))
    check(abs(a_card - a_cpu) <= 0.005, f"AUC {a_card} vs {a_cpu}")
    same = int(np.sum(np.all(
        (on_card.ensemble.feature == on_cpu.ensemble.feature)
        & (on_card.ensemble.threshold_bin == on_cpu.ensemble.threshold_bin),
        axis=1)))
    emit({"phase": "parity", "rows": PARITY_ROWS, "trees": PARITY_TREES,
          "identical_trees": same, "tie_root_causes": n_rc,
          "auc_card": a_card, "auc_cpu": a_cpu,
          "train_card_s": t1 - t0, "train_cpu_s": t2 - t1})

# --------------------------------------------------------------------- #
# quantized-gradient training (grad_dtype int8 / int16)
# --------------------------------------------------------------------- #

def logloss_gh(R: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """f32 logloss (g, h) at random raw scores and labels."""
    rng = np.random.default_rng(seed)
    raw = (0.5 * rng.standard_normal(R)).astype(np.float32)
    y = (rng.random(R) < 0.5).astype(np.float32)
    p = (np.float32(1) / (np.float32(1) + np.exp(-raw))).astype(np.float32)
    return (p - y).astype(np.float32), (p * (1 - p)).astype(np.float32)


def scale_term(a: np.ndarray, grad_dtype: str) -> dict:
    """Which term of quant_scale set the scale of values `a`, from host
    stats: 'max' (max|a| / qmax, exact) or 'sum_cap' (the power-of-two
    snap of sum|a| / 2^30)."""
    mx, sm = np.max(np.abs(a)), np.sum(np.abs(a))
    base = np.float32(mx) / np.float32(grad.GRAD_QMAX[grad_dtype])
    scale = grad.quant_scale_np(mx, sm, grad_dtype)
    return {"term": "max" if scale == base else "sum_cap",
            "max_term": float(base),
            "cap_term": float(grad.quant_scale_np(0.0, sm, grad_dtype)),
            "sum_abs_numpy": float(sm)}


def phase_quantize(flush: torch.Tensor) -> dict:
    dev = torch.device("cuda")
    g, h = logloss_gh(ROWS, 11)
    gd, hd = torch.from_numpy(g).to(dev), torch.from_numpy(h).to(dev)
    out = {}
    for dt in ("int8", "int16"):
        qg, qh, gs, hs = grad.quantize_gradients(gd, hd, grad_dtype=dt,
                                                 tree_id=3, seed=11)
        ng, nh, ngs, nhs = grad.quantize_gradients_np(
            g, h, grad_dtype=dt, tree_id=3, seed=11)
        check(np.array_equal(qg.cpu().numpy(), ng), f"quantize {dt}: q(g)")
        check(np.array_equal(qh.cpu().numpy(), nh), f"quantize {dt}: q(h)")
        check(float(gs) == float(ngs) and float(hs) == float(nhs),
              f"quantize {dt}: scales {float(gs)} {float(ngs)} "
              f"{float(hs)} {float(nhs)}")
        _, sg, _, sh = grad.grad_abs_stats(gd, hd)
        row = {"gscale": float(gs), "hscale": float(hs),
               "g": {**scale_term(g, dt), "sum_abs_card": float(sg)},
               "h": {**scale_term(h, dt), "sum_abs_card": float(sh)},
               "q_bitwise_equal": True, "scales_equal": True,
               "ms": time_ms(lambda: grad.quantize_gradients(
                   gd, hd, grad_dtype=dt, tree_id=3, seed=11), 20, flush)}
        out[dt] = row
        emit({"phase": "quantize", "rows": ROWS, "grad_dtype": dt, **row})
    for base in (0, (1 << 33) + 0xFFFFFF00):
        u = sampling.uniform(11, 3, base, ROWS, dev).cpu().numpy()
        check(np.array_equal(u.view(np.uint32),
                             sampling.uniform_np(11, 3, base, ROWS)
                             .view(np.uint32)),
              f"uniform twin at row base {base}")
        emit({"phase": "quantize", "uniform_row_base": base, "rows": ROWS,
              "bitwise_equal_uniform_np": True})
    return out


def hist_int_bound_ms(ni: np.ndarray, F: int, N: int, B: int,
                      itemsize: int, card: dict) -> tuple[float, float]:
    """(bytes time, operations time) in ms of the integer mode: the node
    index of every row, Xb and the two q's of each active row read once,
    the int32 table written once; 2 INT32 adds per active (row, feature)
    at the INT32 rate."""
    act = int((ni >= 0).sum())
    nbytes = ni.size * 4 + act * (F + 2 * itemsize) + N * F * B * 8
    return 1e3 * nbytes / card["bw"], 1e3 * 2 * act * F / card["int32"]


def phase_hist_int(binned: dict, levels: list, card: dict,
                   flush: torch.Tensor) -> dict:
    dev = torch.device("cuda")
    R = binned[255].shape[0]
    rng = np.random.default_rng(7)
    g = rng.standard_normal(R).astype(np.float32)
    h = (0.25 * rng.random(R)).astype(np.float32)
    rows = {}
    for dt, itemsize in (("int8", 1), ("int16", 2)):
        qg, qh, _, _ = grad.quantize_gradients_np(g, h, grad_dtype=dt,
                                                  tree_id=0, seed=7)
        gd, hd = torch.from_numpy(qg).to(dev), torch.from_numpy(qh).to(dev)
        rng_n = np.random.default_rng(8)
        for B, nodes in HIST_SHAPES:
            Xd = torch.from_numpy(binned[B]).to(dev)
            for N in nodes:
                ni = rng_n.integers(0, N, size=R).astype(np.int32)
                ni[rng_n.random(R) < 0.1] = -1
                nid = torch.from_numpy(ni).to(dev)
                args = (Xd, gd, hd, nid, N, B)
                err = check_hist(args, f"hist_int {dt} B={B} N={N}")
                want = histogram.build_histograms_segment(*args)
                # Library yardstick: two int32 index_add_ calls over the
                # combined (f*N + node)*B + bin key.
                key = ((torch.arange(FEATURES, device=dev)[None, :] * N
                        + nid.clamp(min=0).long()[:, None]) * B
                       + Xd.long()).reshape(-1)
                act = nid >= 0
                wg = torch.where(act, gd.int(), 0)[:, None] \
                    .expand(R, FEATURES).reshape(-1).contiguous()
                wh = torch.where(act, hd.int(), 0)[:, None] \
                    .expand(R, FEATURES).reshape(-1).contiguous()
                m = FEATURES * N * B

                def library():
                    return (torch.zeros(m, dtype=torch.int32, device=dev)
                            .index_add_(0, key, wg),
                            torch.zeros(m, dtype=torch.int32, device=dev)
                            .index_add_(0, key, wh))

                lib = torch.stack(library(), -1).reshape(
                    FEATURES, N, B, 2).permute(1, 0, 2, 3)
                check(torch.equal(lib, want),
                      f"index_add_ yardstick {dt} B={B} N={N}")
                t_bytes, t_ops = hist_int_bound_ms(ni, FEATURES, N, B,
                                                   itemsize, card)
                row = {
                    "kernel_ms": time_ms(
                        lambda: hist_cuda.build_histograms_cuda(*args), 20,
                        flush),
                    "plain_ms": time_ms(
                        lambda: histogram.build_histograms_segment(*args), 5,
                        flush),
                    "library_ms": time_ms(library, 10, flush),
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops,
                    "max_abs_err": err,
                }
                row["bound_by"] = ("bytes" if t_bytes >= t_ops
                                   else "operations")
                del key, wg, wh, lib
                rows[(dt, B, N)] = row
                emit({"phase": "hist_int", "grad_dtype": dt, "rows": R,
                      "features": FEATURES, "bins": B, "nodes": N,
                      "frozen_frac": 0.1, "bitwise_equal": True, **row})
    out = {"rows": rows}
    # The main path's own node indices (phase hist's tree), int8 and int16.
    Xd = torch.from_numpy(binned[255]).to(dev)
    for dt, itemsize in (("int8", 1), ("int16", 2)):
        qg, qh, _, _ = grad.quantize_gradients_np(g, h, grad_dtype=dt,
                                                  tree_id=0, seed=7)
        gd, hd = torch.from_numpy(qg).to(dev), torch.from_numpy(qh).to(dev)
        real = {"kernel_ms": 0.0, "bound_ms": 0.0, "levels": []}
        for ni, N in levels:
            args = (Xd, gd, hd, ni, N, 255)
            check_hist(args, f"hist_int {dt} main-path indices N={N}")
            t_bytes, t_ops = hist_int_bound_ms(ni.cpu().numpy(), FEATURES, N,
                                               255, itemsize, card)
            lv = {"nodes": N, "active_rows": int((ni >= 0).sum()),
                  "kernel_ms": time_ms(
                      lambda: hist_cuda.build_histograms_cuda(*args), 20,
                      flush), "bound_ms": max(t_bytes, t_ops)}
            real["kernel_ms"] += lv["kernel_ms"]
            real["bound_ms"] += lv["bound_ms"]
            real["levels"].append(lv)
        out[dt + "_main_path_indices"] = real
        emit({"phase": "hist_int", "grad_dtype": dt,
              "per_tree_main_path_indices": list(TREE_SEQ),
              "bitwise_equal": True, **real})
    for dt in ("int8", "int16"):
        tree = {k: sum(rows[(dt, 255, n)][k] for n in TREE_SEQ)
                for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms",
                          "bound_bytes_ms", "bound_ops_ms")}
        tree["bound_by"] = ("bytes" if tree["bound_bytes_ms"]
                            >= tree["bound_ops_ms"] else "operations")
        out[dt] = tree
        emit({"phase": "hist_int", "grad_dtype": dt,
              "per_tree_main_path": list(TREE_SEQ), **tree})
    out["max_abs_err"] = max(r["max_abs_err"] for r in rows.values())
    return out


TREE_FIELDS = ("feature", "threshold_bin", "is_leaf", "leaf_value",
               "split_gain", "default_left")


def phase_quant_exact(binned: dict, y: np.ndarray) -> None:
    # (a) mse on y in {-1, +1} with mean exactly 0: g = -/+1 and h = 1, so
    # q = -/+127 and 127, and with 127 * rows < 2^24 every integer sum
    # converts to f32 exactly and dequantizes to the f32 path's sum.
    R = QUANT_EXACT_ROWS
    Xb = binned[255][:R]
    ypm = np.where(y[:R] > 0.5, 1.0, -1.0).astype(np.float32)
    flip = np.flatnonzero(ypm > 0 if ypm.sum() > 0 else ypm < 0)
    ypm[flip[:int(abs(ypm.sum())) // 2]] *= -1
    check(ypm.sum() == 0, "balanced +-1 labels")
    cfg = TrainConfig(n_trees=1, max_depth=DEPTH, n_bins=255, loss="mse")
    hist_cuda.launches_int = 0
    ens = {dt: api.train(Xb, ypm, cfg.replace(grad_dtype=dt),
                         binned=True).ensemble for dt in ("f32", "int8")}
    check(hist_cuda.launches_int > 0, "quant_exact ran the integer mode")
    for k in TREE_FIELDS:
        check(np.array_equal(getattr(ens["f32"], k), getattr(ens["int8"], k)),
              f"quant_exact mse: {k} int8 == f32")
    emit({"phase": "quant_exact", "case": "mse y in {-1,+1}", "rows": R,
          "depth": DEPTH, "bins": 255, "bitwise_equal": list(TREE_FIELDS),
          "split_nodes": int((ens["f32"].feature >= 0).sum())})
    # (b) the reference's pinned grid at full width: integer g in {-1, 0,
    # 1} and h = 1, each channel's max pinned to 127, so the scale is
    # exactly 1.0 and every sum stays below 2^24.
    R = ROWS
    rng = np.random.default_rng(5)
    g = rng.integers(-1, 2, size=R).astype(np.float32)
    h = np.ones(R, np.float32)
    g[0] = h[0] = 127.0
    trees = {}
    for dt in ("f32", "int8"):
        be = get_backend(TrainConfig(n_trees=1, max_depth=DEPTH, n_bins=255,
                                     grad_dtype=dt))
        data = be.upload(binned[255])
        handle, _ = be.grow_tree(data, torch.from_numpy(g).to(be.device),
                                 torch.from_numpy(h).to(be.device),
                                 tree_id=0)
        trees[dt] = be.fetch_tree(handle)
    for k in TREE_FIELDS:
        check(np.array_equal(trees["f32"][k], trees["int8"][k]),
              f"quant_exact pinned grid: {k} int8 == f32")
    emit({"phase": "quant_exact", "case": "pinned grid, scale 1.0",
          "rows": R, "depth": DEPTH, "bins": 255,
          "bitwise_equal": list(TREE_FIELDS),
          "split_nodes": int((trees["f32"]["feature"] >= 0).sum())})


def boost_ms_per_tree(Xb: np.ndarray, y: np.ndarray, grad_dtype: str) -> float:
    """ms per tree of the Driver's boosting loop on binned rows (upload
    included, binning not), host clock ending in a synchronize."""
    cfg = TrainConfig(n_trees=N_TREES, max_depth=DEPTH, n_bins=255,
                      grad_dtype=grad_dtype)
    t0 = time.perf_counter()
    api.train(Xb, y, cfg, binned=True)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / N_TREES


def phase_train_quant(X: np.ndarray, y: np.ndarray, binned: dict,
                      main_run: dict) -> dict:
    cfg = TrainConfig(n_trees=N_TREES, max_depth=DEPTH, n_bins=255,
                      grad_dtype="int8")
    zero_counters()
    t0 = time.perf_counter()
    res = api.train(X, y, cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    p = api.predict(res.ensemble, X, mapper=res.mapper)
    launches = {"hist_int": hist_cuda.launches_int,
                "hist_f32": hist_cuda.launches + hist_cuda.launches_exact,
                "traverse": predict_cuda.launches}
    check(launches["hist_int"] > 0, "integer histogram mode launched")
    check(launches["hist_f32"] == 0, "f32 histogram mode not launched")
    check(launches["traverse"] > 0, "traversal kernel launched")
    check(p.shape == (len(X),) and np.all(np.isfinite(p)), "finite scores")
    a = auc(y, p)
    check(a >= 0.80, f"int8 train AUC {a} >= 0.80")
    check(abs(a - main_run["auc"]) <= 0.005,
          f"int8 AUC {a} vs f32 {main_run['auc']}")
    # Per-round split agreement: both trees of a round grown from the same
    # f32 boosting state (the reference's acceptance protocol).
    be_f = get_backend(TrainConfig(max_depth=DEPTH, n_bins=255))
    be_q = get_backend(TrainConfig(max_depth=DEPTH, n_bins=255,
                                   grad_dtype="int8"))
    data = be_f.upload(binned[255])
    yh = be_f.upload_labels(y)
    pred = be_f.init_pred(yh, float(np.log(y.mean() / (1 - y.mean()))))
    same = tot = 0
    for rnd in range(AGREE_ROUNDS):
        g, h = be_f.grad_hess(pred, yh)
        hf, delta = be_f.grow_tree(data, g, h, tree_id=rnd)
        hq, _ = be_q.grow_tree(data, g, h, tree_id=rnd)
        tf, tq = be_f.fetch_tree(hf), be_q.fetch_tree(hq)
        same += int((tf["feature"] == tq["feature"]).sum())
        tot += tf["feature"].size
        pred = be_f.apply_delta(pred, delta, 0)
    agree = same / tot
    check(agree >= 0.985, f"int8 split agreement {agree} >= 0.985")
    # Boosting loop alone, f32 and int8 in turns (binning excluded).
    order = ("f32", "int8", "int8", "f32")
    loop = {dt: [] for dt in ("f32", "int8")}
    for dt in order:
        loop[dt].append(boost_ms_per_tree(binned[255], y, dt))
    row = {"rows": len(X), "bins": 255, "depth": DEPTH, "trees": N_TREES,
           "grad_dtype": "int8", "train_s": t1 - t0,
           "train_s_f32_main": main_run["train_s"], "train_auc": a,
           "train_auc_f32": main_run["auc"], "launches": launches,
           "hist_int_launches_per_tree": launches["hist_int"] / N_TREES,
           "split_agreement": agree, "agreement_rounds": AGREE_ROUNDS,
           "boost_ms_per_tree": loop, "boost_order": list(order)}
    emit({"phase": "train_quant", **row})
    return row


def phase_parity_quant(X: np.ndarray, y: np.ndarray) -> dict:
    Xs, ys = X[:PARITY_ROWS], y[:PARITY_ROWS]
    cfg = TrainConfig(n_trees=PARITY_TREES, max_depth=DEPTH,
                      n_bins=PARITY_Q_BINS, min_split_gain=1e-3,
                      grad_dtype="int16", subsample=0.8,
                      colsample_bytree=0.8)
    zero_counters()
    t0 = time.perf_counter()
    on_card = api.train(Xs, ys, cfg, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = {"hist_int": hist_cuda.launches_int,
                "hist_f32": hist_cuda.launches + hist_cuda.launches_exact}
    check(launches["hist_int"] > 0 and launches["hist_f32"] == 0,
          f"parity_quant launches {launches}")
    on_cpu = api.train(Xs, ys, cfg, device="cpu")
    t2 = time.perf_counter()
    n_rc = trees_match_mod_ties(on_cpu.ensemble, on_card.ensemble, 1e-3)
    a_card = auc(ys, api.predict(on_card.ensemble, Xs,
                                 mapper=on_card.mapper))
    a_cpu = auc(ys, api.predict(on_cpu.ensemble, Xs, mapper=on_cpu.mapper,
                                device="cpu"))
    check(abs(a_card - a_cpu) <= 0.005, f"AUC {a_card} vs {a_cpu}")
    same = int(np.sum(np.all(
        (on_card.ensemble.feature == on_cpu.ensemble.feature)
        & (on_card.ensemble.threshold_bin == on_cpu.ensemble.threshold_bin),
        axis=1)))
    row = {"rows": PARITY_ROWS, "trees": PARITY_TREES,
           "bins": PARITY_Q_BINS, "grad_dtype": "int16", "subsample": 0.8,
           "colsample_bytree": 0.8, "identical_trees": same,
           "tie_root_causes": n_rc, "auc_card": a_card, "auc_cpu": a_cpu,
           "launches": launches, "train_card_s": t1 - t0,
           "train_cpu_s": t2 - t1}
    emit({"phase": "parity_quant", **row})
    return row


# --------------------------------------------------------------------- #
# the full training matrix: softmax with an eval set, early stopping and
# resume; learned missing values; categorical splits; instance weights
# --------------------------------------------------------------------- #

#: telemetry's counters at the last zero_counters (they never reset).
_TELE0: dict = {}


def zero_counters() -> None:
    _TELE0.clear()
    _TELE0.update(tele_counters.snapshot())
    hist_cuda.launches_exact = 0
    hist_cuda.launches = 0
    hist_cuda.launches_int = 0
    predict_cuda.launches = 0
    predict_lut_cuda.launches_lut = 0
    predict_lut_cuda.launches_lut4 = 0
    quantize.transforms = 0
    cuda_backend.graph_replays = 0
    cuda_backend.graph_captures = 0


def read_counters() -> dict:
    """The counters since zero_counters: "hist" is K1's exact mode (the
    f32 training paths'), "hist_f32_atomics" its float-atomic mode (on
    no training path), "hist_int" its integer mode."""
    torch.cuda.synchronize()
    return {"hist": hist_cuda.launches_exact,
            "hist_f32_atomics": hist_cuda.launches,
            "hist_int": hist_cuda.launches_int,
            "traverse": predict_cuda.launches,
            "lut": predict_lut_cuda.launches_lut,
            "lut4": predict_lut_cuda.launches_lut4,
            "binning": quantize.transforms,
            "graph_replays": cuda_backend.graph_replays,
            "graph_captures": cuda_backend.graph_captures,
            "h2d_bytes": tele_counters.delta(_TELE0)["h2d_bytes"]}


def hist_tree(Xd: torch.Tensor, levels: list, card: dict,
              flush: torch.Tensor, seed: int,
              reps: tuple = (20, 3, 5)) -> dict:
    """K1's exact mode (what f32 training runs) on the node indices of one
    recorded tree, level by level, bitwise its plain version
    (check_hist_exact), and the tree's sums: kernel, plain and library
    (two int64 index_add_) device ms, and the bound (hist_exact_bound_ms
    per level). Beside them on the same inputs, `cas_kernel_ms`: the f32
    float-atomic mode it replaced (checked with check_hist's
    tolerance)."""
    dev = Xd.device
    R, F = Xd.shape
    rng = np.random.default_rng(seed)
    gd = torch.from_numpy(rng.standard_normal(R).astype(np.float32)).to(dev)
    hd = torch.from_numpy((0.25 * rng.random(R)).astype(np.float32)).to(dev)
    sc = exact_scales(gd, hd)
    out = {"kernel_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "bound_bytes_ms": 0.0, "bound_ops_ms": 0.0, "bound_ms": 0.0,
           "cas_kernel_ms": 0.0, "max_abs_err": 0.0, "cas_max_abs_err": 0.0,
           "levels": []}
    for ni, N in levels:
        args = (Xd, gd, hd, ni, N, 255)
        check_hist_exact(args, sc, f"hist exact F={F} N={N}")
        err = check_hist(args, f"hist f32 F={F} N={N}")
        key = ((torch.arange(F, device=dev)[None, :] * N
                + ni.clamp(min=0).long()[:, None]) * 255
               + Xd.long()).reshape(-1)
        act = (ni >= 0)[:, None].expand(R, F).reshape(-1)
        qg = torch.where(act, grad.to_fixed(gd, sc[0])[:, None]
                         .expand(R, F).reshape(-1), 0)
        qh = torch.where(act, grad.to_fixed(hd, sc[1])[:, None]
                         .expand(R, F).reshape(-1), 0)
        m = F * N * 255
        t_bytes, t_ops = hist_exact_bound_ms(ni.cpu().numpy(), F, N, 255,
                                             card)
        lv = {"nodes": N, "active_rows": int((ni >= 0).sum()),
              "plan": hist_cuda.plan_tiles(
                  N, F, 255, _build.smem_limit(dev),
                  hist_cuda.CELL_BYTES_EXACT).__dict__,
              "kernel_ms": time_ms(lambda: hist_cuda.build_histograms_cuda(
                  *args, scales=sc), reps[0], flush),
              "cas_kernel_ms": time_ms(
                  lambda: hist_cuda.build_histograms_cuda(*args), reps[0],
                  flush),
              "plain_ms": time_ms(
                  lambda: histogram.build_histograms_fixed_segment(
                      *args, sc), reps[1], flush),
              "library_ms": time_ms(lambda: index_add_hist(key, qg, qh, m),
                                    reps[2], flush),
              "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops,
              "bound_ms": max(t_bytes, t_ops), "cas_max_abs_err": err}
        del key, qg, qh, act
        for k in ("kernel_ms", "cas_kernel_ms", "plain_ms", "library_ms",
                  "bound_bytes_ms", "bound_ops_ms", "bound_ms"):
            out[k] += lv[k]
        out["cas_max_abs_err"] = max(out["cas_max_abs_err"], err)
        out["levels"].append(lv)
    out["bound_by"] = ("bytes" if out["bound_bytes_ms"]
                       >= out["bound_ops_ms"] else "operations")
    return out


def traverse_row(kernel, plain, tables, ce, Xd: torch.Tensor, card: dict,
                 flush: torch.Tensor, sizes, what: str) -> dict:
    """K3 bitwise against its plain version on all of Xd and on its first
    rows at each of `sizes`, then its time, the plain version's and the
    bound (traverse_compares: int32 compares on each row's real path, one
    f32 add per row and real tree; bytes: rows in, scores out, records
    once)."""
    got = kernel(Xd)
    check(torch.equal(got, plain(Xd)), f"{what}: kernel == plain, "
          f"bitwise, {Xd.shape[0]} rows")
    for n in sizes:
        Xn = Xd[:n].contiguous()
        small = kernel(Xn)
        check(torch.equal(small, plain(Xn)) and torch.equal(small, got[:n]),
              f"{what}: {n} rows, kernel == plain == the full call")
    R, F = Xd.shape
    tables_bytes = tables.rec.numel()
    nbytes = R * F + R * ce.n_classes_out * 4 + tables_bytes
    compares = traverse_compares(ce, Xd)
    adds = R * tables.n_trees
    t_bytes = 1e3 * nbytes / card["bw"]
    t_ops = 1e3 * (compares / card["int32"] + adds / card["f32_add"])
    return {"kernel_ms": time_ms(lambda: kernel(Xd), 10, flush),
            "plain_ms": time_ms(lambda: plain(Xd), 2, flush),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "int32_compares": compares, "f32_adds": adds,
            "max_abs_err": 0.0, "bitwise_equal_at_rows": list(sizes) + [R]}


def matrix_parity(what: str, X: np.ndarray, y: np.ndarray,
                  cfg: TrainConfig, score, **train_kw) -> dict:
    """The same model trained on the card and on the CPU (plain versions):
    trees identical except at bf16-boundary ties, `score` (AUC or
    accuracy, on the training rows) within 0.005."""
    t0 = time.perf_counter()
    card_run = api.train(X, y, cfg, device="cuda", **train_kw)
    t1 = time.perf_counter()
    cpu_run = api.train(X, y, cfg, device="cpu", **train_kw)
    t2 = time.perf_counter()
    n_rc = trees_match_mod_ties(cpu_run.ensemble, card_run.ensemble,
                                cfg.min_split_gain)
    s_card = score(y, api.predict(card_run.ensemble, X,
                                  mapper=card_run.mapper, raw=True))
    s_cpu = score(y, api.predict(cpu_run.ensemble, X, mapper=cpu_run.mapper,
                                 raw=True, device="cpu"))
    check(abs(s_card - s_cpu) <= 0.005, f"{what} parity: {s_card} vs "
          f"{s_cpu}")
    same = int(np.sum(np.all(
        (card_run.ensemble.feature == cpu_run.ensemble.feature)
        & (card_run.ensemble.threshold_bin
           == cpu_run.ensemble.threshold_bin), axis=1)))
    row = {"rows": len(y), "rounds": cfg.n_trees,
           "trees": card_run.ensemble.n_trees, "identical_trees": same,
           "tie_root_causes": n_rc, "score_card": s_card,
           "score_cpu": s_cpu, "train_card_s": t1 - t0,
           "train_cpu_s": t2 - t1}
    emit({"phase": "parity_matrix", "case": what, **row})
    return row


def eval_accuracy(ens, Xvd: torch.Tensor, yv: np.ndarray) -> float:
    """Accuracy of a multiclass ensemble's K3 scores on binned eval rows."""
    return accuracy(yv, api.predict(ens, Xvd, binned=True, raw=True))


def covertype_data():
    """BASELINE config 2's rows: synthetic_multiclass at Covertype's shape,
    the first COV_TRAIN rows to train on, the rest as the eval set."""
    X, y = synthetic_multiclass(COV_ROWS, COV_FEATURES, COV_CLASSES, seed=0)
    return X[:COV_TRAIN], y[:COV_TRAIN], X[COV_TRAIN:], y[COV_TRAIN:]


def covertype_cfg(**kw) -> TrainConfig:
    return TrainConfig(n_trees=COV_ROUNDS, max_depth=COV_DEPTH, n_bins=255,
                       loss="softmax", n_classes=COV_CLASSES).replace(**kw)


def phase_covertype(card: dict, flush: torch.Tensor) -> dict:
    dev = torch.device("cuda")
    Xt, yt, Xv, yv = covertype_data()
    cfg = covertype_cfg()
    C = COV_CLASSES
    zero_counters()
    t0 = time.perf_counter()
    res = api.train(Xt, yt, cfg, eval_set=(Xv, yv), eval_metric="logloss",
                    early_stopping_rounds=COV_PATIENCE)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    raw = api.predict(res.ensemble, Xv, mapper=res.mapper, raw=True)
    t2 = time.perf_counter()
    launches = read_counters()
    rounds = len(res.history)
    best = res.best_round
    stopped = rounds < COV_ROUNDS
    check(launches["hist"] > 0 and launches["hist_int"] == 0
          and launches["hist_f32_atomics"] == 0,
          f"covertype: the exact histogram mode only, {launches}")
    check(launches["traverse"] > 0, "covertype: traversal kernel launched")
    check(launches["binning"] == 3,
          "covertype: train rows, eval rows and predict rows binned on "
          "the card")
    check(launches["graph_captures"] == 1
          and launches["graph_replays"] == rounds,
          f"covertype: one capture, {rounds} replays: {launches}")
    # One launch a level with sibling subtraction, C trees a round,
    # counted per replay, plus the capture's warm-up round.
    check(launches["hist"] == COV_DEPTH * C * (rounds + 1),
          f"covertype: {launches['hist']} histogram launches for "
          f"{rounds} rounds")
    if stopped:
        check(rounds == best + 1 + COV_PATIENCE,
              f"covertype: stopped at {rounds}, best {best}")
    check(res.ensemble.n_trees == (best + 1 if stopped else rounds) * C,
          f"covertype: {res.ensemble.n_trees} trees kept")
    check(raw.shape == (len(yv), C) and np.all(np.isfinite(raw)),
          "covertype: finite [rows, 7] scores")
    acc = accuracy(yv, raw)
    check(acc >= 0.80, f"covertype eval accuracy {acc} >= 0.80")
    ll = logloss(yv, raw)
    ll_dev = res.history[best]["valid_logloss"]
    kept = res.history[res.ensemble.n_trees // C - 1]["valid_logloss"]
    check(abs(ll - kept) <= 1e-4 * (abs(ll) + 1e-3),
          f"covertype: host logloss {ll} vs the round's device score "
          f"{kept}")
    sub = 2_000
    Xvb = res.mapper.transform(Xv[:sub])
    oracle = res.ensemble.predict_raw(Xvb, binned=True)
    check(np.all(np.abs(raw[:sub] - oracle) <= 1e-5 * (np.abs(oracle) + 1)),
          "covertype: scores == host oracle")
    row = {"rows_train": len(yt), "rows_eval": len(yv),
           "features": COV_FEATURES, "classes": C, "bins": 255,
           "depth": COV_DEPTH, "max_rounds": COV_ROUNDS,
           "patience": COV_PATIENCE, "rounds_trained": rounds,
           "early_stopped": stopped, "best_round": best,
           "trees_kept": res.ensemble.n_trees, "train_s": t1 - t0,
           "predict_s": t2 - t1, "ms_per_round_api": 1e3 * (t1 - t0) / rounds,
           "eval_accuracy": acc, "eval_logloss": ll,
           "eval_logloss_device_best": ll_dev, "launches": launches,
           "hist_launches_per_round": launches["hist"] / (rounds + 1)}
    emit({"phase": "covertype", **row})

    # The loop apart on binned rows, its block at the Driver's size
    # (COV_PATIENCE rounds): a call that captures, a timed one, and a
    # profiled window.
    mapper = res.mapper
    Xd = mapper.transform_device(Xt, dev)
    Xvd = mapper.transform_device(Xv, dev)
    be = get_backend(cfg)
    yd, yvd = be.upload_labels(yt), be.upload_labels(yv)
    pred = be.init_pred(yd, 0.0)
    vpred = torch.zeros((len(yv), C), device=dev)

    def block(k, first=0):
        return be.grow_rounds_eval(Xd, pred, yd, k, Xvd, vpred, yvd,
                                   "logloss", first_round=first)

    synced(lambda: block(COV_PATIENCE))
    _, loop_s = synced(lambda: block(COV_PATIENCE, COV_PATIENCE))
    prof = profiled(lambda: block(COV_PROFILE, 2 * COV_PATIENCE))
    loop = {"ms_per_round": 1e3 * loop_s / COV_PATIENCE,
            "ms_per_tree": 1e3 * loop_s / (COV_PATIENCE * C),
            "capture_s": be.last_capture_s,
            "profile_rounds": COV_PROFILE,
            "busy_share": prof["busy_share"],
            "device_ms_per_round": 1e3 * prof["device_busy_s"] / COV_PROFILE,
            "hist_kernel_ms_per_tree":
                prof["hist_kernel_ms"] / (COV_PROFILE * C),
            "device_launches_per_round":
                prof["device_launches"] / COV_PROFILE,
            "host_launches_per_round":
                prof["host_launch_calls"] / COV_PROFILE,
            "top": prof["top"]}
    emit({"phase": "covertype", "piece": "loop", **loop})

    # K1 on one covertype tree's node indices (class 0 at pred 0).
    levels = tree_levels(Xd, 1.0 / C, (yt == 0).astype(np.int32), COV_DEPTH)
    k1 = hist_tree(Xd, levels, card, flush, seed=8)
    emit({"phase": "covertype", "piece": "hist_per_tree", **k1})
    del levels

    # K3 on the trained model: bitwise to its plain version at 1, 256
    # and every eval row; its time against its bound.
    ce = res.ensemble.compile(tree_chunk=64)
    tables, kernel, plain = device_operands(ce, dev)
    k3 = traverse_row(kernel, plain, tables, ce, Xvd, card, flush, (1, 256),
                      "covertype traverse")
    k3.update(trees=res.ensemble.n_trees, trees_packed=tables.n_trees,
              passes_at_eval_rows=-(-tables.n_trees // k3_plan(
                  tables, len(yv), COV_FEATURES).sub))
    emit({"phase": "covertype", "piece": "traverse_trained", **k3})
    return {"row": row, "loop": loop, "hist": k1, "traverse": k3,
            "Xd": Xd, "yt": yt, "Xvd": Xvd, "yv": yv}


def phase_covertype_prefix(cov: dict) -> dict:
    """COV_PREFIX rounds with the eval set, fused against granular on the
    card: trees and eval scores bitwise, int8 and f32 (whose histograms
    are exact too); the same best round."""
    Xd, yt, Xvd, yv = cov["Xd"], cov["yt"], cov["Xvd"], cov["yv"]
    out = {}
    for dt in ("int8", "f32"):
        cfg = covertype_cfg(n_trees=COV_PREFIX, grad_dtype=dt,
                            min_split_gain=1e-3)
        kw = dict(eval_set=(Xvd, yv), eval_metric="logloss",
                  early_stopping_rounds=COV_PATIENCE)
        fd = Driver(get_backend(cfg), cfg)
        fused, fused_s = synced(lambda: fd.fit(Xd, yt, **kw))
        gd = Driver(tasks.Granular(cfg), cfg)
        gran, gran_s = synced(lambda: gd.fit(Xd, yt, **kw))
        check(fd.best_round == gd.best_round,
              f"covertype prefix {dt}: best round {fd.best_round} vs "
              f"{gd.best_round}")
        sf, sg = fd.best_score, gd.best_score
        row = {"best_round": fd.best_round, "best_logloss": [sf, sg],
               "fused_ms_per_round": 1e3 * fused_s / COV_PREFIX,
               "granular_ms_per_round": 1e3 * gran_s / COV_PREFIX}
        for k in TREE_FIELDS:
            check(np.array_equal(getattr(fused, k), getattr(gran, k)),
                  f"covertype prefix {dt}: {k} fused == granular")
        check([r["valid_logloss"] for r in fd.history]
              == [r["valid_logloss"] for r in gd.history],
              f"covertype prefix {dt}: eval scores bitwise")
        row["bitwise_equal"] = True
        out[dt] = row
        emit({"phase": "covertype_prefix", "grad_dtype": dt,
              "rounds": COV_PREFIX, **row})
    return out


def phase_missing(card: dict, flush: torch.Tensor) -> dict:
    dev = torch.device("cuda")
    X, y = synthetic_missing(ROWS, FEATURES, seed=3, frac=NAN_FRAC)
    tr = MATRIX_TRAIN
    out = {}
    for policy in ("learn", "zero"):
        cfg = TrainConfig(n_trees=MATRIX_ROUNDS, max_depth=DEPTH, n_bins=255,
                          missing_policy=policy)
        zero_counters()
        res, train_s = synced(lambda: api.train(X[:tr], y[:tr], cfg))
        raw = api.predict(res.ensemble, X[tr:], mapper=res.mapper, raw=True)
        launches = read_counters()
        check(launches["hist"] > 0 and launches["traverse"] > 0,
              f"missing {policy}: kernels launched {launches}")
        out[policy] = {"auc": auc(y[tr:], raw), "train_s": train_s,
                       "launches": launches, "res": res}
    learn = out["learn"]["res"]
    check(learn.ensemble.missing_bin
          and bool(learn.ensemble.default_left.any()),
          "missing: learned default directions used")
    check(out["learn"]["auc"] >= out["zero"]["auc"],
          f"missing: learned AUC {out['learn']['auc']} >= zero policy's "
          f"{out['zero']['auc']}")
    ce = learn.ensemble.compile(tree_chunk=64)
    tables, kernel, plain = device_operands(ce, dev)
    check(tables.use_missing, "missing: routing step with the NaN test")
    Xd = learn.mapper.transform_device(X[tr:], dev)
    _, sizes = check_traverse(kernel, plain, tables, Xd, "missing traverse")
    row = {"rows_train": tr, "rows_eval": ROWS - tr, "nan_frac": NAN_FRAC,
           "nan_values": int(np.isnan(X).sum()), "rounds": MATRIX_ROUNDS,
           "depth": DEPTH, "auc_learn": out["learn"]["auc"],
           "auc_zero": out["zero"]["auc"],
           "train_s_learn": out["learn"]["train_s"],
           "train_s_zero": out["zero"]["train_s"],
           "launches": out["learn"]["launches"],
           "default_left_nodes": int(learn.ensemble.default_left.sum()),
           "traverse_bitwise_at_rows": sizes + [Xd.shape[0]],
           "traverse_ms": time_ms(lambda: kernel(Xd), 10, flush)}
    emit({"phase": "missing", **row})
    p = PARITY_MATRIX_ROWS
    row["parity"] = matrix_parity(
        "missing", X[:p], y[:p],
        TrainConfig(n_trees=PARITY_MATRIX_ROUNDS, max_depth=DEPTH,
                    n_bins=255, missing_policy="learn", min_split_gain=1e-3),
        auc)
    return row


def phase_categorical(card: dict, flush: torch.Tensor) -> dict:
    dev = torch.device("cuda")
    Xn, Xc, y = synthetic_ctr(ROWS, seed=0)
    enc, enc_s = synced(lambda: fit_categorical_encoder(Xc, n_bins=255))
    X = np.concatenate([Xn, enc.transform(Xc).astype(np.float32)], axis=1)
    cat = tuple(range(Xn.shape[1], X.shape[1]))
    tr = MATRIX_TRAIN
    cfg = TrainConfig(n_trees=MATRIX_ROUNDS, max_depth=DEPTH, n_bins=255,
                      cat_features=cat)
    zero_counters()
    res, train_s = synced(lambda: api.train(X[:tr], y[:tr], cfg))
    raw = api.predict(res.ensemble, X[tr:], mapper=res.mapper, raw=True)
    launches = read_counters()
    check(launches["hist"] > 0 and launches["traverse"] > 0,
          f"categorical: kernels launched {launches}")
    ens = res.ensemble
    split = ~ens.is_leaf & (ens.feature >= 0)
    cat_nodes = int(np.isin(ens.feature[split], cat).sum())
    check(cat_nodes > 0, "categorical: one-vs-rest splits chosen")
    ce = ens.compile(tree_chunk=64)
    tables, kernel, plain = device_operands(ce, dev)
    check(tables.use_cat, "categorical: routing step with the category test")
    Xd = res.mapper.transform_device(X[tr:], dev)
    _, sizes = check_traverse(kernel, plain, tables, Xd,
                              "categorical traverse")
    a = auc(y[tr:], raw)
    row = {"rows_train": tr, "rows_eval": ROWS - tr,
           "numeric": Xn.shape[1], "categorical": len(cat),
           "encoder_fit_s": enc_s, "rounds": MATRIX_ROUNDS, "depth": DEPTH,
           "auc": a, "train_s": train_s, "launches": launches,
           "categorical_split_nodes": cat_nodes,
           "split_nodes": int(split.sum()),
           "traverse_bitwise_at_rows": sizes + [Xd.shape[0]],
           "traverse_ms": time_ms(lambda: kernel(Xd), 10, flush)}
    emit({"phase": "categorical", **row})
    p = PARITY_MATRIX_ROWS
    row["parity"] = matrix_parity(
        "categorical", X[:p], y[:p],
        TrainConfig(n_trees=PARITY_MATRIX_ROUNDS, max_depth=DEPTH,
                    n_bins=255, cat_features=cat, min_split_gain=1e-3),
        auc)
    return row


def phase_weights(X: np.ndarray, y: np.ndarray, binned: dict) -> dict:
    dev = torch.device("cuda")
    Xd = torch.from_numpy(binned[255]).to(dev)
    cfg = TrainConfig(n_trees=WEIGHT_ROUNDS, max_depth=DEPTH, n_bins=255,
                      grad_dtype="int8")
    w = np.random.default_rng(5).integers(0, 4, len(y)).astype(np.float32)
    zero_counters()
    plain_run = Driver(get_backend(cfg), cfg).fit(Xd, y)
    ones = Driver(get_backend(cfg), cfg).fit(Xd, y,
                                             sample_weight=np.ones(len(y)))
    for k in TREE_FIELDS:
        check(np.array_equal(getattr(plain_run, k), getattr(ones, k)),
              f"weights: all-ones {k} == unweighted, bitwise")
    fd = Driver(get_backend(cfg), cfg)
    fused, fused_s = synced(lambda: fd.fit(Xd, y, sample_weight=w))
    raw = api.predict(fused, Xd, binned=True, raw=True).astype(np.float64)
    launches = read_counters()
    gran, gran_s = synced(lambda: Driver(tasks.Granular(cfg), cfg).fit(
        Xd, y, sample_weight=w))
    for k in TREE_FIELDS:
        check(np.array_equal(getattr(fused, k), getattr(gran, k)),
              f"weights: integer weights {k} fused == granular, bitwise")
    per = np.logaddexp(0.0, raw) - raw * y
    want = float((per * w).sum() / w.sum())
    got = fd.history[-1]["train_loss"]
    check(abs(got - want) <= 1e-4 * want,
          f"weights: train loss {got} == weighted mean {want}")
    row = {"rows": len(y), "rounds": WEIGHT_ROUNDS, "depth": DEPTH,
           "grad_dtype": "int8", "weights": "integers 0-3",
           "all_ones_bitwise": True, "fused_granular_bitwise": True,
           "train_loss": got, "weighted_mean_loss_host": want,
           "unweighted_mean_loss_host": float(per.mean()),
           "fused_ms_per_tree": 1e3 * fused_s / WEIGHT_ROUNDS,
           "granular_ms_per_tree": 1e3 * gran_s / WEIGHT_ROUNDS,
           "launches": launches}
    emit({"phase": "weights", **row})
    p = PARITY_MATRIX_ROWS
    row["parity"] = matrix_parity(
        "weights", X[:p], y[:p],
        TrainConfig(n_trees=PARITY_MATRIX_ROUNDS, max_depth=DEPTH,
                    n_bins=255, min_split_gain=1e-3), auc,
        sample_weight=w[:p])
    return row


def phase_resume() -> dict:
    dev = torch.device("cuda")
    Xt, yt, Xv, yv = covertype_data()
    Xt, yt = Xt[:RESUME_ROWS], yt[:RESUME_ROWS]
    Xv, yv = Xv[:RESUME_ROWS // 5], yv[:RESUME_ROWS // 5]
    mapper = fit_bin_mapper(Xt, n_bins=255)
    Xd, Xvd = mapper.transform_device(Xt, dev), mapper.transform_device(Xv,
                                                                        dev)
    kw = dict(eval_set=(Xvd, yv), eval_metric="logloss")
    out = {}
    zero_counters()
    for dt in ("int8", "f32"):
        cfg = covertype_cfg(n_trees=2 * RESUME_ROUNDS, grad_dtype=dt,
                            min_split_gain=1e-3)
        be = get_backend(cfg)
        whole = Driver(be, cfg)
        full = whole.fit(Xd, yt, **kw)
        with tempfile.TemporaryDirectory() as ck:
            first = cfg.replace(n_trees=RESUME_ROUNDS)
            Driver(be, first, checkpoint_dir=ck,
                   checkpoint_every=RESUME_EVERY).fit(Xd, yt, **kw)
            again = Driver(be, cfg, checkpoint_dir=ck,
                           checkpoint_every=RESUME_EVERY)
            resumed, resume_s = synced(lambda: again.fit(Xd, yt, **kw))
        last = [whole.history[-1]["valid_logloss"],
                again.history[-1]["valid_logloss"]]
        row = {"resume_s": resume_s, "final_logloss": last}
        for k in TREE_FIELDS:
            check(np.array_equal(getattr(full, k), getattr(resumed, k)),
                  f"resume {dt}: {k} == uninterrupted, bitwise")
        check([r["valid_logloss"] for r in again.history]
              == [r["valid_logloss"]
                  for r in whole.history[RESUME_ROUNDS:]],
              f"resume {dt}: eval scores == uninterrupted")
        row["bitwise_equal"] = True
        out[dt] = row
        emit({"phase": "resume", "grad_dtype": dt, "rows": RESUME_ROWS,
              "rounds": [RESUME_ROUNDS, 2 * RESUME_ROUNDS],
              "checkpoint_every": RESUME_EVERY, **row})
    out["launches"] = read_counters()
    return out


def phase_covertype_parity() -> dict:
    Xt, yt, _, _ = covertype_data()
    p = PARITY_MATRIX_ROWS
    # int8: the card's histograms are then order-free as the CPU's are
    # (f32 ones part at noise-level gains on this shape, see
    # phase_covertype_prefix).
    return matrix_parity(
        "covertype", Xt[:p], yt[:p],
        covertype_cfg(n_trees=PARITY_MATRIX_ROUNDS, grad_dtype="int8",
                      min_split_gain=1e-3), accuracy)


# --------------------------------------------------------------------- #
# row partitions over NCCL: BASELINE config 3 on P ranks
# --------------------------------------------------------------------- #

def config3_rows(n_rows: int):
    """BASELINE config 3's rows as phase_categorical builds them: X float32
    [n_rows, 39] (13 numeric, 26 encoded categorical), y, the categorical
    columns."""
    Xn, Xc, y = synthetic_ctr(n_rows, seed=0)
    enc = fit_categorical_encoder(Xc, n_bins=255)
    X = np.concatenate([Xn, enc.transform(Xc).astype(np.float32)], axis=1)
    return X, y, tuple(range(Xn.shape[1], X.shape[1]))


def steady_ms(history) -> float:
    """Mean ms a round of the fused blocks after the first (which holds
    the warm-up round and the capture)."""
    return float(np.mean([r["ms_per_round"]
                          for r in history[MULTI_BLOCK:]]))


def multi_launches(multi: dict, kernel: str) -> dict:
    """The multi phase's launches of one kernel: per rank, by case."""
    return {case: [r[kernel] for r in row["launches"]]
            for case, row in multi["cases"].items()}


def mesh_launches(mesh2d: dict, kernel: str) -> dict:
    """The mesh2d phase's launches of one kernel: per rank, by case, and
    the one-card resume's."""
    out = {case: [r[kernel] for r in row["launches"]]
           for case, row in mesh2d["cases"].items()}
    out["resume_one_card"] = mesh2d["checkpoint"]["launches"][kernel]
    return out


def phase_multi(card: dict) -> dict:
    n_cards = torch.cuda.device_count()
    P = min(4, n_cards)
    rows = P * MULTI_ROWS
    t0 = time.perf_counter()
    X, y, cat = config3_rows(rows)
    data_s = time.perf_counter() - t0
    base = dict(n_trees=MULTI_ROUNDS, max_depth=DEPTH, n_bins=255,
                cat_features=cat, fused_block_rounds=MULTI_BLOCK)
    # One card on all P x 1M rows, the yardstick (no process group).
    alone = {}
    for dt in ("f32", "int8"):
        cfg = TrainConfig(grad_dtype=dt, **base)
        res, train_s = synced(lambda: api.train(X, y, cfg, log_every=1))
        alone[dt] = {"res": res, "train_s": train_s,
                     "ms_per_round": steady_ms(res.history),
                     "auc": auc(y, api.predict(res.ensemble, X,
                                               mapper=res.mapper,
                                               raw=True))}
    cases = [c for c in MULTI_CASES if P > 1 or c[1] == "allreduce"]
    out = {"card": card["smi"], "cards": n_cards, "ranks": P, "rows": rows,
           "rows_per_rank": MULTI_ROWS, "data_s": data_s, "cases": {}}
    with tempfile.TemporaryDirectory() as d:
        xp, yp = f"{d}/x.npy", f"{d}/y.npy"
        np.save(xp, X)
        np.save(yp, y)
        del X
        t0 = time.perf_counter()
        with spawn.Pool(P, backend="nccl", device="cuda",
                        timeout_s=900.0) as pool:
            out["pool_start_s"] = time.perf_counter() - t0
            for dt, sc, slabs in cases:
                ranks = pool.run(tasks.train_timed, xp, yp,
                                 dict(base, grad_dtype=dt, split_comms=sc,
                                      hist_comms_slabs=slabs),
                                 MULTI_PROFILE)
                name = f"{dt}_{sc}" + (f"_slabs{slabs}" if slabs > 1
                                       else "")
                out["cases"][name] = multi_case(
                    name, dt, sc, ranks, alone[dt], y, P)
    for dt in alone:
        del alone[dt]["res"]
    out["one_card"] = alone
    if P == 1:
        emit({"phase": "multi", "ranks": 1,
              "multi_rank": "not witnessed: 1 card"})
    emit({"phase": "multi", **out})
    return out


def multi_case(name: str, dt: str, sc: str, ranks: list, alone: dict,
               y: np.ndarray, P: int) -> dict:
    """Hold one partitioned run (a result per rank, parallel/tasks.
    train_timed) against its ranks and the one-card run."""
    what = f"multi {name}"
    e0 = ranks[0]["ensemble"]
    for r in ranks[1:]:
        for k in TREE_FIELDS:
            check(np.array_equal(getattr(r["ensemble"], k), getattr(e0, k)),
                  f"{what}: rank {r['rank']} {k} == rank 0's, bitwise")
    one = alone["res"].ensemble
    div = first_divergence(one, e0)
    row = {"split_comms_resolved": ranks[0]["split_comms"],
           "cards": [r["device"] for r in ranks], **div}
    if dt == "int8":
        for k in TREE_FIELDS:
            check(np.array_equal(getattr(one, k), getattr(e0, k)),
                  f"{what}: {k} == one card's, bitwise")
        row["bitwise_equal_one_card"] = True
    a = auc(y, np.concatenate([r["raw"] for r in ranks]))
    row.update(auc=a, auc_one_card=alone["auc"])
    check(abs(a - alone["auc"]) <= 0.005,
          f"{what}: AUC {a} vs one card {alone['auc']}")
    for r in ranks:
        c = r["train_counters"]
        rounds = c["cuda.graph_replays"] + c["cuda.graph_captures"]
        check(c["cuda.graph_captures"] == 1
              and c["cuda.graph_replays"] == MULTI_ROUNDS,
              f"{what}: one capture, a replay a round: {c}")
        check(c["comms.modeled_bytes"] == rounds * r["bytes_model"],
              f"{what}: modeled bytes {c['comms.modeled_bytes']} == "
              f"{rounds} rounds x {r['bytes_model']}")
        k1 = "hist_cuda.launches_" + ("int" if dt == "int8" else "exact")
        check(r["counters"][k1] > 0
              and r["counters"]["predict_cuda.launches"] > 0,
              f"{what}: K1 ({k1}) and K3 launched on rank {r['rank']}")
    ms = [r["fused_ms_per_round"] for r in ranks]
    row.update(
        train_s=[r["train_s"] for r in ranks],
        fused_ms_per_round=ms,
        one_card_ms_per_round=alone["ms_per_round"],
        one_card_train_s=alone["train_s"],
        speedup=alone["ms_per_round"] / max(ms),
        scaling_efficiency=alone["ms_per_round"] / max(ms) / P,
        bytes_per_tree_model=ranks[0]["bytes_model"],
        modeled_bytes=[r["train_counters"]["comms.modeled_bytes"]
                       for r in ranks],
        other_bytes=[r["train_counters"]["comms.other_bytes"]
                     for r in ranks],
        collectives_per_round=ranks[0]["profile"]["collectives_per_round"],
        profile=[r["profile"] for r in ranks],
        launches=[{"hist": r["counters"]["hist_cuda.launches_exact"],
                   "hist_f32_atomics": r["counters"]["hist_cuda.launches"],
                   "hist_int": r["counters"]["hist_cuda.launches_int"],
                   "traverse": r["counters"]["predict_cuda.launches"]}
                  for r in ranks])
    emit({"phase": "multi", "case": name, "ranks": P, **row})
    return row


# --------------------------------------------------------------------- #
# the 2D rows x features mesh, the hosts axis, slab-pipelined collectives
# and checkpoints under partitions: BASELINE config 5's width
# --------------------------------------------------------------------- #

def k1_shapes(Xd: torch.Tensor, y: np.ndarray, card: dict,
              flush: torch.Tensor) -> dict:
    """K1 on one tree's levels (hist_tree, fewer repetitions) at the
    shapes a rank's K1 sees at config 5's width: one card's 1M x 1024,
    a (2, 2) rank's 500k x 512 and a (1, 4) rank's 1M x 256."""
    R = Xd.shape[0]
    out = {}
    for name, r, f in (("1x1", R, MESH_FEATURES),
                       ("2x2", R // 2, MESH_FEATURES // 2),
                       ("1x4", R, MESH_FEATURES // 4)):
        Xs = Xd[:r, :f].contiguous()
        levels = tree_levels(Xs, float(y[:r].mean()), y[:r], DEPTH)
        t = hist_tree(Xs, levels, card, flush, seed=7, reps=(5, 1, 1))
        out[name] = {k: t[k] for k in (
            "kernel_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_bytes_ms", "bound_ops_ms", "bound_by", "max_abs_err",
            "cas_kernel_ms")}
        out[name].update(rows=r, features=f,
                         slabs=[lv["plan"]["n_slabs"]
                                for lv in t["levels"]])
        del Xs, levels
    return out


def mesh_one_card(Xb: np.ndarray, Xd: torch.Tensor, y: np.ndarray,
                  base: dict, card: dict, flush: torch.Tensor) -> dict:
    """The one-card yardstick on all rows (no process group), f32 and
    int8: the trained model, api.train wall, fused ms a round after the
    first block, AUC on the training rows (K3), and a profiled window of
    MESH_PROFILE replays (K1's device ms a round). Then K3 on the f32
    model at 1M x 1024 (rows too wide for a block of one row a thread:
    the pairs mapping), bitwise its plain version, timed."""
    out = {}
    for dt in ("f32", "int8"):
        cfg = TrainConfig(grad_dtype=dt, **base)
        res, train_s = synced(lambda: api.train(Xb, y, cfg, binned=True,
                                                log_every=1))
        be = get_backend(cfg)
        data = be.upload(Xd)
        yh = be.upload_labels(y)
        pred = be.init_pred(yh, res.ensemble.base_score)
        be.grow_rounds(data, pred, yh, 1)
        prof = profiled(lambda: be.grow_rounds(data, pred, yh,
                                               MESH_PROFILE))
        del data, pred
        out[dt] = {
            "res": res, "train_s": train_s,
            "ms_per_round": float(np.mean(
                [r["ms_per_round"] for r in res.history[MESH_BLOCK:]])),
            "profile_ms_per_round": 1e3 * prof["wall_s"] / MESH_PROFILE,
            "k1_ms_per_round": prof["hist_kernel_ms"] / MESH_PROFILE,
            "busy_share": prof["busy_share"],
            "auc": auc(y, api.predict(res.ensemble, Xd, binned=True,
                                      raw=True))}
    ce = out["f32"]["res"].ensemble.compile(tree_chunk=64)
    tables, kernel, plain = device_operands(ce, Xd.device)
    k3 = traverse_row(kernel, plain, tables, ce, Xd, card, flush,
                      (1, 256, 67_584), "mesh2d traverse")
    k3["plan"] = k3_plan(tables, Xd.shape[0], Xd.shape[1])._asdict()
    out["k3"] = k3
    return out


def phase_mesh2d(card: dict, flush: torch.Tensor) -> dict:
    n_cards = torch.cuda.device_count()
    P = 4 if n_cards >= 4 else 1
    t0 = time.perf_counter()
    Xb, y = stress_binned_chunk(0, MESH_ROWS, n_features=MESH_FEATURES,
                                n_bins=255, seed=0)
    data_s = time.perf_counter() - t0
    base = dict(n_trees=MESH_ROUNDS, max_depth=DEPTH, n_bins=255,
                fused_block_rounds=MESH_BLOCK)
    Xd = torch.from_numpy(Xb).to("cuda")
    k1 = k1_shapes(Xd, y, card, flush)
    alone = mesh_one_card(Xb, Xd, y, base, card, flush)
    del Xd
    k3 = alone.pop("k3")
    out = {"card": card["smi"], "cards": n_cards, "ranks": P,
           "rows": MESH_ROWS, "features": MESH_FEATURES,
           "rounds": MESH_ROUNDS, "data_s": data_s, "k1": k1, "k3": k3,
           "cases": {},
           "one_card": {dt: {k: v for k, v in a.items() if k != "res"}
                        for dt, a in alone.items()}}
    emit({"phase": "mesh2d", "k1": k1, "k3": k3,
          "one_card": out["one_card"]})
    cases = MESH_CASES_4 if P == 4 else MESH_CASES_1
    with tempfile.TemporaryDirectory() as d:
        xp, yp, ck = f"{d}/x.npy", f"{d}/y.npy", f"{d}/ckpt"
        np.save(xp, Xb)
        np.save(yp, y)
        t0 = time.perf_counter()
        with spawn.Pool(P, backend="nccl", device="cuda",
                        timeout_s=900.0) as pool:
            out["pool_start_s"] = time.perf_counter() - t0
            for name, kw in cases:
                ranks = pool.run(tasks.train_mesh, xp, yp, dict(base, **kw),
                                 None, MESH_PROFILE)
                out["cases"][name] = mesh_case(name, kw, ranks, alone, y, P)
            ck_kw = dict(base, grad_dtype="int8", n_trees=MESH_CKPT_EVERY,
                         **({"mesh_shape": (2, 2)} if P == 4
                            else {"mesh_shape": (1, 1)}))
            ranks = pool.run(tasks.train_mesh, xp, yp, ck_kw,
                             dict(checkpoint_dir=ck,
                                  checkpoint_every=MESH_CKPT_EVERY), 0)
        out["checkpoint"] = mesh_resume(ranks, Xb, y, ck, base, alone)
    if "2hx2_slabs4_f32" in out["cases"]:
        out["slabs"] = mesh_slabs(out["cases"], y)
        print("mesh2d: the hosts axis is emulated on one node: cross-node "
              "traffic is not witnessed", flush=True)
    if P == 1:
        emit({"phase": "mesh2d", "ranks": 1,
              "mesh2d": "not witnessed: 1 card"})
    emit({"phase": "mesh2d", **{k: v for k, v in out.items()
                                if k not in ("cases", "k1", "k3",
                                             "one_card")}})
    return out


def mesh_case(name: str, kw: dict, ranks: list, alone: dict,
              y: np.ndarray, P: int) -> dict:
    """Hold one mesh run (a result per rank, parallel/tasks.train_mesh)
    against its ranks, the payload model and the one-card run."""
    what = f"mesh2d {name}"
    dt = kw.get("grad_dtype", "f32")
    e0 = ranks[0]["ensemble"]
    for r in ranks[1:]:
        for k in TREE_FIELDS:
            check(np.array_equal(getattr(r["ensemble"], k), getattr(e0, k)),
                  f"{what}: rank {r['rank']} {k} == rank 0's, bitwise")
    one = alone[dt]["res"].ensemble
    row = {"mesh": kw, "split_comms": ranks[0]["split_comms"],
           "comms_slabs": ranks[0]["comms_slabs"],
           "columns_per_rank": ranks[0]["columns"],
           "cards": [r["device"] for r in ranks],
           "coords": [r["coords"] for r in ranks],
           **first_divergence(one, e0)}
    if dt == "int8":
        for k in TREE_FIELDS:
            check(np.array_equal(getattr(one, k), getattr(e0, k)),
                  f"{what}: {k} == one card's, bitwise")
        row["bitwise_equal_one_card"] = True
    # Feature shard 0's ranks score row blocks that tile the rows.
    raw = np.concatenate([r["raw"] for r in ranks if r["raw"] is not None])
    a = auc(y, raw[:len(y)])
    row.update(auc=a, auc_one_card=alone[dt]["auc"])
    check(abs(a - alone[dt]["auc"]) <= 0.005,
          f"{what}: AUC {a} vs one card {alone[dt]['auc']}")
    cfg = TrainConfig(**kw)
    model = comms.hist_allreduce_bytes(
        DEPTH, MESH_FEATURES, 255, partitions=cfg.row_shards,
        feature_partitions=cfg.feature_partitions,
        mode=ranks[0]["split_comms"], subtraction=True, grad_dtype=dt)
    if name in ("2x2_f32", "1x4_f32"):
        check(model == MESH_MODEL_BYTES,
              f"{what}: model {model} == {MESH_MODEL_BYTES}")
    for r in ranks:
        c = r["train_counters"]
        rounds = c["cuda.graph_replays"] + c["cuda.graph_captures"]
        check(c["cuda.graph_captures"] == 1
              and c["cuda.graph_replays"] == MESH_ROUNDS,
              f"{what}: one capture, a replay a round: {c}")
        check(r["bytes_model"] == model,
              f"{what}: backend model {r['bytes_model']} == {model}")
        check(c["comms.modeled_bytes"] == rounds * model,
              f"{what}: modeled bytes {c['comms.modeled_bytes']} == "
              f"{rounds} rounds x {model}")
        k1 = "hist_cuda.launches_" + ("int" if dt == "int8" else "exact")
        check(r["counters"][k1] > 0
              and r["counters"]["predict_cuda.launches"] > 0,
              f"{what}: K1 ({k1}) and K3 launched on rank {r['rank']}")
    ms = [r["fused_ms_per_round"] for r in ranks]
    prof = [r["profile"] for r in ranks]
    row.update(
        train_s=[r["train_s"] for r in ranks],
        fused_ms_per_round=ms,
        profile_ms_per_round=[p["ms_per_round"] for p in prof],
        k1_ms_per_round=[p["k1_ms_per_round"] for p in prof],
        nccl_share_of_wall=[p["nccl_share_of_wall"] for p in prof],
        nccl_share_of_busy=[p["nccl_share_of_busy"] for p in prof],
        nccl_by_kernel=prof[0]["nccl_by_kernel"],
        one_card_ms_per_round=alone[dt]["ms_per_round"],
        speedup=alone[dt]["ms_per_round"] / max(ms),
        bytes_per_tree_model=model,
        modeled_bytes=[r["train_counters"]["comms.modeled_bytes"]
                       for r in ranks],
        other_bytes=[r["train_counters"]["comms.other_bytes"]
                     for r in ranks],
        other_bytes_per_round=[p["other_bytes_per_round"] for p in prof],
        route=[r.get("route") for r in ranks],
        launches=[{"hist": r["counters"]["hist_cuda.launches_exact"],
                   "hist_f32_atomics": r["counters"]["hist_cuda.launches"],
                   "hist_int": r["counters"]["hist_cuda.launches_int"],
                   "traverse": r["counters"]["predict_cuda.launches"]}
                  for r in ranks])
    emit({"phase": "mesh2d", "case": name, "ranks": P,
          **{k: v for k, v in row.items() if k != "ensemble"}})
    row["ensemble"] = e0
    row["auc_value"] = a
    return row


def mesh_slabs(cases: dict, y: np.ndarray) -> dict:
    """Slabs 4 against 1 on the emulated hosts axis, f32: the first
    divergence (each rank's table is exact, but the f32 wire's reduction
    order depends on where an element falls in its chunks, ops/grow),
    AUC within 0.005, and the round time each gives. Slabs' exactness is
    held in int8 (case 2hx2_slabs4_int8: bitwise the one card's)."""
    s4, s1 = cases["2hx2_slabs4_f32"], cases["2hx2_slabs1_f32"]
    check(abs(s4["auc_value"] - s1["auc_value"]) <= 0.005,
          f"slabs 4 AUC {s4['auc_value']} vs slabs 1 {s1['auc_value']}")
    out = {**first_divergence(s1["ensemble"], s4["ensemble"]),
           "fused_ms_per_round": {"slabs1": max(s1["fused_ms_per_round"]),
                                  "slabs4": max(s4["fused_ms_per_round"])},
           "profile_ms_per_round": {
               "slabs1": max(s1["profile_ms_per_round"]),
               "slabs4": max(s4["profile_ms_per_round"])}}
    emit({"phase": "mesh2d", "slabs": out})
    return out


def mesh_resume(ranks: list, Xb: np.ndarray, y: np.ndarray, ck: str,
                base: dict, alone: dict) -> dict:
    """The int8 checkpoint the mesh's rank 0 wrote after MESH_CKPT_EVERY
    rounds, resumed to MESH_ROUNDS on one card with no process group:
    bitwise the uninterrupted one-card run."""
    e0 = ranks[0]["ensemble"]
    for r in ranks[1:]:
        for k in TREE_FIELDS:
            check(np.array_equal(getattr(r["ensemble"], k), getattr(e0, k)),
                  f"mesh2d checkpoint: rank {r['rank']} {k} == rank 0's")
    zero_counters()
    res, resume_s = synced(lambda: api.train(
        Xb, y, TrainConfig(grad_dtype="int8", **base), binned=True,
        checkpoint_dir=ck, checkpoint_every=MESH_CKPT_EVERY, log_every=1))
    launches = read_counters()
    check(len(res.history) == MESH_ROUNDS - MESH_CKPT_EVERY,
          f"mesh2d checkpoint: resumed {len(res.history)} rounds")
    one = alone["int8"]["res"].ensemble
    for k in TREE_FIELDS:
        check(np.array_equal(getattr(one, k), getattr(res.ensemble, k)),
              f"mesh2d checkpoint: resumed {k} == one card's, bitwise")
    out = {"written_by": f"{len(ranks)} NCCL rank(s), "
                         f"{ranks[0]['coords']} ...",
           "rounds_before": ranks[0]["history_len"],
           "rounds_after": len(res.history), "resume_train_s": resume_s,
           "bitwise_equal_one_card": True, "launches": launches}
    emit({"phase": "mesh2d", "checkpoint": out})
    return out


# --------------------------------------------------------------------- #
# out-of-core training and scoring: BASELINE config 5's width streamed
# --------------------------------------------------------------------- #

def stress_chunks(n_chunks: int, pinned: bool) -> tuple:
    """n_chunks chunks of STREAM_CHUNK stress rows (stress_binned_chunk at
    1024 features, 255 bins), made by 8 threads into one host tensor
    (pinned, or pageable): (rows uint8 [n * STREAM_CHUNK, 1024], labels,
    seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    R = n_chunks * STREAM_CHUNK
    rows = torch.empty((R, MESH_FEATURES), dtype=torch.uint8,
                       pin_memory=pinned)
    y = np.empty(R, np.int32)
    view = rows.numpy()

    def make(c):
        lo = c * STREAM_CHUNK
        Xc, yc = stress_binned_chunk(lo, STREAM_CHUNK,
                                     n_features=MESH_FEATURES, n_bins=255,
                                     seed=0)
        view[lo:lo + STREAM_CHUNK] = Xc
        y[lo:lo + STREAM_CHUNK] = yc

    with ThreadPoolExecutor(8) as ex:
        list(ex.map(make, range(n_chunks)))
    return rows, y, time.perf_counter() - t0


def chunk_source(rows: torch.Tensor, y: np.ndarray, n_chunks: int):
    """chunk_fn over the host tensor: chunk c is a view of its rows (a
    pinned view is transferred as it is), with a label side channel."""
    def f(c):
        lo = c * STREAM_CHUNK
        return rows[lo:lo + STREAM_CHUNK], y[lo:lo + STREAM_CHUNK]

    f.labels = lambda c: y[c * STREAM_CHUNK:(c + 1) * STREAM_CHUNK]
    f.n_features = rows.shape[1]
    return f


def stream_run(src, n_chunks: int, cfg: TrainConfig, cache) -> dict:
    """One fit_streaming run with the counters zeroed around it and the
    staging's transfer times recorded: the ensemble, wall seconds, the
    counters and the staging's {stage_s, h2d_ms, transfers}."""
    be = get_backend(cfg)
    zero_counters()
    if be.stager is not None:
        be.stager.reset_stats()
        be.stager.timing = True
    ens, wall = synced(lambda: fit_streaming(src, n_chunks, cfg,
                                             backend=be,
                                             device_chunk_cache=cache))
    counters = read_counters()
    stats = be.stager.stats()
    be.stager.timing = False
    return {"ensemble": ens, "wall_s": wall, "counters": counters,
            "staging": stats}


def phase_stream(card: dict, flush: torch.Tensor) -> dict:
    """BASELINE config 5's width streamed: 4M x 1024 stress rows in 8
    chunks of 512k held once in pinned host memory, 2 rounds at depth 6,
    f32 and int8, the device chunk cache off (every pass over the wire)
    and on, against the in-memory trainer on the same 4M rows. Held:
    trees bitwise equal; h2d_bytes exactly the chunk bytes moved; K1
    launched once a chunk-level; predict_streaming bitwise api.predict at
    the f32, lut and lut4 tiers; K4 and K5 at 1024 features bitwise their
    plain versions. Reported: ms a round, H2D GB/s, the staging, H2D and
    K1 times apart and their overlap (a profiled cache-off f32 round),
    launches a chunk-level."""
    n = STREAM_CHUNKS
    rows, y, data_s = stress_chunks(n, pinned=True)
    src = chunk_source(rows, y, n)
    nbytes = rows.numel()
    base = dict(n_trees=STREAM_ROUNDS, max_depth=DEPTH, n_bins=255)
    out = {"rows": len(y), "features": MESH_FEATURES, "chunks": n,
           "chunk_rows": STREAM_CHUNK, "rounds": STREAM_ROUNDS,
           "depth": DEPTH, "data_s": data_s, "chunk_bytes": nbytes // n,
           "card": card["smi"], "runs": {}}
    Xd = rows.to("cuda")
    passes = STREAM_ROUNDS * (DEPTH + 1)
    for dt in ("f32", "int8"):
        cfg = TrainConfig(grad_dtype=dt, **base)
        zero_counters()
        be = get_backend(cfg)
        mem, mem_s = synced(lambda: Driver(be, cfg).fit(Xd, y))
        mem_counters = read_counters()
        # The in-memory loop's steady rate: replays of the round captured
        # on handles uploaded once (Driver.fit uploads its labels anew, so
        # each fit captures again).
        data, yh = be.upload(Xd), be.upload_labels(y)
        pred = be.init_pred(yh, mem.base_score)
        be.grow_rounds(data, pred, yh, 1)
        _, steady_s = synced(lambda: be.fetch_rounds(
            *be.grow_rounds(data, pred, yh, STREAM_ROUNDS)[::2]))
        del data, pred
        row = {"wall_s": mem_s, "steady_s": steady_s,
               "ms_per_round": 1e3 * steady_s / STREAM_ROUNDS,
               "counters": mem_counters}
        out["runs"][f"in_memory_{dt}"] = row
        emit({"phase": "stream", "case": f"in_memory_{dt}", "rows": len(y),
              **{k: v for k, v in row.items() if k != "counters"},
              "launches": mem_counters})
        for cache in (False, True):
            name = f"{dt}_cache_{'on' if cache else 'off'}"
            r = stream_run(src, n, cfg, cache)
            c = r["counters"]
            for k in TREE_FIELDS:
                check(np.array_equal(getattr(mem, k),
                                     getattr(r["ensemble"], k)),
                      f"stream {name}: {k} == in-memory, bitwise")
            want = nbytes * (1 if cache else passes)
            check(c["h2d_bytes"] == want,
                  f"stream {name}: h2d_bytes {c['h2d_bytes']} == {want}")
            k1 = c["hist"] if dt == "f32" else c["hist_int"]
            check(k1 == n * STREAM_ROUNDS * DEPTH,
                  f"stream {name}: {k1} K1 launches, one a chunk-level")
            check(c["hist_f32_atomics"] == 0,
                  f"stream {name}: no float-atomic histogram launch")
            st = r["staging"]
            row = {"wall_s": r["wall_s"],
                   "ms_per_round": 1e3 * r["wall_s"] / STREAM_ROUNDS,
                   "bitwise_equal_in_memory": True, "counters": c,
                   "h2d_transfers": st["transfers"],
                   "h2d_ms": st["h2d_ms"], "stage_s": st["stage_s"],
                   "h2d_gb_per_s": (c["h2d_bytes"] / st["h2d_ms"] / 1e6
                                    if st["h2d_ms"] else None),
                   "k1_launches_per_chunk_level": k1 / (
                       n * STREAM_ROUNDS * DEPTH)}
            out["runs"][name] = row
            emit({"phase": "stream", "case": name, "rows": len(y),
                  **{k: v for k, v in row.items() if k != "counters"},
                  "launches": c})
            if dt == "f32" and not cache:
                f32_model = r["ensemble"]
    # The time split of one cache-off f32 round: a profiled window.
    cfg1 = TrainConfig(grad_dtype="f32", **dict(base, n_trees=1))
    be = get_backend(cfg1)
    be.stager.reset_stats()
    be.stager.timing = True
    prof = profiled(lambda: fit_streaming(src, n, cfg1, backend=be,
                                          device_chunk_cache=False))
    st = be.stager.stats()
    be.stager.timing = False
    parts_ms = 1e3 * st["stage_s"] + st["h2d_ms"] + prof["hist_kernel_ms"]
    wall_ms = 1e3 * prof["wall_s"]
    split = {"wall_ms": wall_ms, "stage_ms": 1e3 * st["stage_s"],
             "h2d_ms": st["h2d_ms"], "k1_ms": prof["hist_kernel_ms"],
             "device_busy_ms": 1e3 * prof["device_busy_s"],
             "busy_share": prof["busy_share"],
             "overlap_ms": max(0.0, parts_ms - wall_ms),
             "h2d_gb_per_s": nbytes * (DEPTH + 1) / st["h2d_ms"] / 1e6,
             "device_launches_per_chunk_level":
                 prof["device_launches"] / (n * (DEPTH + 1)),
             "host_launch_calls_per_chunk_level":
                 prof["host_launch_calls"] / (n * (DEPTH + 1)),
             "top": prof["top"]}
    out["time_split_f32_cache_off_1_round"] = split
    emit({"phase": "stream", "time_split_f32_cache_off_1_round": split})
    # Scoring: predict_streaming bitwise api.predict at every tier; K4 and
    # K5 at 1024 features against their plain versions.
    zero_counters()
    lut = {}
    for impl in ("auto", "lut", "lut4"):
        be = get_backend(TrainConfig(n_bins=255, predict_impl=impl))
        got, s_ = synced(lambda: predict_streaming(src, n, f32_model,
                                                   backend=be))
        want = api.predict(f32_model, Xd, binned=True, raw=True,
                           backend=be)
        check(np.array_equal(got, want),
              f"stream predict_streaming {impl} == api.predict")
        tier = be.resolved_predict_impl(f32_model.cache_token())
        check(tier == {"auto": "f32"}.get(impl, impl),
              f"stream predict {impl}: served by {tier}")
        lut[impl] = {"predict_streaming_s": s_, "rows_per_s": len(y) / s_,
                     "tier": tier}
    out["predict_counters"] = read_counters()
    check(out["predict_counters"]["lut"] > 0
          and out["predict_counters"]["lut4"] > 0
          and out["predict_counters"]["traverse"] > 0,
          f"stream predict: K3, K4 and K5 launched {out['predict_counters']}")
    ce = f32_model.compile(tree_chunk=64)
    Xs = Xd[:STREAM_LUT_ROWS].contiguous()
    for name, tables in (("lut", ce.quantize()),
                         ("lut4", ce.quantize(leaf_dtype="int4"))):
        _, kernel, plain = lut_callables(tables, Xs.device)
        check(torch.equal(kernel(Xs), plain(Xs)),
              f"stream {name} at 1024 features: kernel == plain, bitwise")
        row = lut_measure(f"stream {name}", tables, ce, f32_model.n_trees,
                          Xs, card, flush)
        row["plan"] = predict_lut_cuda.plan_launch(
            STREAM_LUT_ROWS, tables.n_trees_padded, DEPTH, MESH_FEATURES,
            tables.leaf_dtype, 1, _build.smem_limit(Xs.device),
            predict_lut_cuda.sm_count(Xs.device))._asdict()
        row["bitwise_equal"] = True
        lut[f"{name}_1024"] = row
    out["scoring"] = lut
    emit({"phase": "stream", "scoring": lut,
          "predict_counters": out["predict_counters"]})
    del Xd, rows
    torch.cuda.empty_cache()
    emit({"phase": "stream", **{k: v for k, v in out.items()
                                if k not in ("runs", "scoring",
                                             "time_split_f32_cache_off_1_round")}})
    return out


def stream_witness(card: dict) -> dict:
    """1 round f32 at depth 6 over a chunk set larger than the card's
    memory, held in pageable host memory, where /proc/meminfo's
    MemAvailable holds it and WITNESS_HOST_SPARE; else the reason."""
    total = torch.cuda.get_device_properties(0).total_memory
    chunk_bytes = STREAM_CHUNK * MESH_FEATURES
    n = total // chunk_bytes + 1
    need = n * chunk_bytes + WITNESS_HOST_SPARE
    avail = 0
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                avail = int(line.split()[1]) * 1024
    out = {"card_bytes": total, "chunks": int(n),
           "chunk_set_bytes": int(n * chunk_bytes),
           "host_mem_available": avail, "needed": int(need)}
    if avail < need:
        out["witness"] = "not witnessed: host memory"
        emit({"phase": "stream_witness", **out})
        return out
    rows, y, data_s = stress_chunks(int(n), pinned=False)
    src = chunk_source(rows, y, int(n))
    cfg = TrainConfig(n_trees=1, max_depth=DEPTH, n_bins=255)
    r = stream_run(src, int(n), cfg, True)
    c = r["counters"]
    check(c["hist"] == n * DEPTH, f"witness: {c['hist']} K1 launches")
    ens = r["ensemble"]
    check(bool(np.isfinite(ens.leaf_value).all())
          and (~ens.is_leaf[0, :(1 << DEPTH) - 1]).any(),
          "witness: a finite tree with splits")
    st = r["staging"]
    out.update(witness=f"{n * chunk_bytes / 1e9:.1f} GB of chunks over a "
               f"card of {total / 1e9:.1f} GB", data_s=data_s,
               wall_s=r["wall_s"], h2d_bytes=c["h2d_bytes"],
               stage_s=st["stage_s"], h2d_ms=st["h2d_ms"],
               h2d_gb_per_s=c["h2d_bytes"] / max(st["h2d_ms"], 1e-9) / 1e6,
               counters=c)
    emit({"phase": "stream_witness", **out})
    del rows
    return out


# --------------------------------------------------------------------- #
# the model's lifecycle and BASELINE config 4
# --------------------------------------------------------------------- #

def reached_nodes(ens) -> tuple[np.ndarray, np.ndarray]:
    """(split, leaf) bool [T, N]: the nodes a row can reach, split
    nodes and leaves, as the LightGBM writer walks them."""
    leafy = ens.is_leaf | (ens.feature < 0)
    reach = np.zeros_like(leafy)
    reach[:, 0] = True
    for n in range(1, leafy.shape[1]):
        par = (n - 1) // 2
        reach[:, n] = reach[:, par] & ~leafy[:, par]
    return reach & ~leafy, reach & leafy


def lgbm_roundtrip(ens, mapper, X: np.ndarray) -> dict:
    """`ens` written as LightGBM text and read back with the bin
    thresholds filled from `mapper`: its arrays bitwise what the text
    holds (the same splits, leaves f32(leaf * lr, + base on the first
    round)), and its card scores on X within 1e-5 * (|p| + 1) of
    `ens`'s."""
    t0 = time.perf_counter()
    txt = ens.to_lightgbm_text()
    t1 = time.perf_counter()
    back = TreeEnsemble.from_lightgbm_text(txt)
    api.fill_bin_thresholds(back, mapper)
    t2 = time.perf_counter()
    check(back.feature.shape == ens.feature.shape,
          f"parsed shape {back.feature.shape} == {ens.feature.shape}")
    split, leaf = reached_nodes(ens)
    check(np.array_equal(back.feature, np.where(split, ens.feature, -1))
          and np.array_equal(back.threshold_bin[split],
                             ens.threshold_bin[split])
          and np.array_equal(back.is_leaf, leaf),
          "LightGBM text: splits and leaves bitwise after the round trip")
    C = ens.n_classes if ens.loss == "softmax" else 1
    first = (np.arange(ens.n_trees) < C)[:, None]
    want = (ens.leaf_value.astype(np.float64) * ens.learning_rate
            + np.where(first, ens.base_score, 0.0)).astype(np.float32)
    check(np.array_equal(back.leaf_value[leaf], want[leaf]),
          "LightGBM text: leaf values bitwise f32(leaf * lr + base)")
    got = api.predict(back, X, mapper=mapper, raw=True)
    ref = api.predict(ens, X, mapper=mapper, raw=True)
    diff = float(np.abs(got - ref).max())
    check(np.all(np.abs(got - ref) <= 1e-5 * (np.abs(ref) + 1)),
          f"LightGBM text model scores within 1e-5 (max |diff| {diff})")
    return {"text_bytes": len(txt), "write_s": t1 - t0,
            "read_s": t2 - t1, "arrays_bitwise": True, "rows": len(X),
            "max_abs_score_diff": diff}


#: The cold restore (phase lifecycle): a fresh interpreter restores each
#: named artifact, bins the float rows on the card with the restored
#: mapper and scores them, counting K3 / K4 / K5 and binning from zero.
LIFE_CHILD = r"""
import json, sys
import numpy as np
from ddt_tpu_torch import _build
from ddt_tpu_torch.ops import predict_cuda, predict_lut_cuda, quantize
from ddt_tpu_torch.registry.loader import load_servable
root, rows, out = sys.argv[1:4]
X = np.load(rows)
tiers, scores = {}, {}
for name in sys.argv[4:]:
    predict_cuda.launches = 0
    predict_lut_cuda.launches_lut = predict_lut_cuda.launches_lut4 = 0
    quantize.transforms = 0
    rep = load_servable(root, name)
    scores[name] = rep.model.score_binned(rep.model.transform(X))
    tiers[name] = {"mode": rep.mode, "digest": rep.digest,
                   "predict_impl": rep.model.predict_impl,
                   "traverse": predict_cuda.launches,
                   "lut": predict_lut_cuda.launches_lut,
                   "lut4": predict_lut_cuda.launches_lut4,
                   "binning": quantize.transforms}
np.savez(out, **scores)
print(json.dumps({"builds": _build.builds, "tiers": tiers}))
"""
#: serving tier -> the launch counter of its kernel.
TIER_KERNEL = {None: "traverse", "int8": "lut", "int4": "lut4"}


def phase_lifecycle(res, X: np.ndarray) -> dict:
    t0 = time.perf_counter()
    out = {"launches": {}}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "higgs.npz")
        api.save_model(path, res.ensemble, mapper=res.mapper, cfg=res.cfg)
        bundle = api.load_model(path)
        with np.load(path) as z:
            check(manifest_mod.arrays_digest(dict(z))
                  == bundle.manifest["digest"]
                  and bundle.manifest["kind"] == "model_bundle",
                  "save_model manifest digest verified")
        want = api.predict(res.ensemble, X, mapper=res.mapper, raw=True)
        check(np.array_equal(api.predict(bundle, X, raw=True), want),
              "load_model scores bitwise the trained model's")
        out["lightgbm"] = lgbm_roundtrip(res.ensemble, res.mapper, X)
        root = os.path.join(tmp, "registry")
        rows = np.ascontiguousarray(X[:LIFE_ROWS])
        Xb = res.mapper.transform_device(rows, "cuda")
        model = api.ModelBundle(res.ensemble, res.mapper)
        names, wants = [], {}
        for tier in (None, "int8", "int4"):
            name = f"higgs-{tier or 'f32'}"
            pushed = push_servable(root, model, name=name,
                                   max_batch=LIFE_MAX_BATCH,
                                   quantize=tier or False)
            wants[name] = api.predict(
                res.ensemble, rows, mapper=res.mapper,
                cfg=TrainConfig(predict_impl=TIER_IMPL[tier]))
            zero_counters()
            rep = load_servable(root, name)
            got = rep.model.score_binned(Xb)
            c = read_counters()
            kernel = TIER_KERNEL[tier]
            check(np.array_equal(got, wants[name]),
                  f"{name}: restored scores bitwise api.predict")
            check(c[kernel] > 0 and sum(c[k] for k in TIER_KERNEL.values())
                  == c[kernel], f"{name}: only {kernel} launched: {c}")
            check(rep.digest == pushed["digest"]
                  and rep.model.predict_impl == TIER_RESOLVED[tier],
                  f"{name}: restored digest and tier")
            out["launches"][kernel] = c[kernel]
            out[name] = {"digest": rep.digest, "mode": rep.mode,
                         "max_abs_err": rep.model.max_abs_err,
                         "launches": c[kernel]}
            names.append(name)
        rows_path = os.path.join(tmp, "rows.npy")
        scores_path = os.path.join(tmp, "child.npz")
        np.save(rows_path, rows)
        t_child = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", LIFE_CHILD, root, rows_path,
             scores_path, *names], cwd=HERE, capture_output=True,
            text=True, timeout=600)
        check(proc.returncode == 0, f"cold restore child: {proc.stderr}")
        child = json.loads(proc.stdout.strip().splitlines()[-1])
        check(child["builds"] == 0,
              f"cold child ran {child['builds']} nvcc builds")
        with np.load(scores_path) as z:
            for tier, name in zip((None, "int8", "int4"), names):
                row = child["tiers"][name]
                kernel = TIER_KERNEL[tier]
                check(np.array_equal(z[name], wants[name]),
                      f"{name}: cold child's scores bitwise api.predict")
                check(row[kernel] > 0 and row["binning"] == 1
                      and row["digest"] == out[name]["digest"],
                      f"{name}: cold child's launches {row}")
        out["child"] = {"builds": child["builds"], "tiers": child["tiers"],
                        "wall_s": time.perf_counter() - t_child}
    out["wall_s"] = time.perf_counter() - t0
    emit({"phase": "lifecycle", "rows": len(X), "restore_rows": LIFE_ROWS,
          **out})
    return out


# --------------------------------------------------------------------- #
# the serving plane (phase serve_plane)
# --------------------------------------------------------------------- #
def http_call(port: int, path: str, data: bytes | None = None,
              headers: dict | None = None) -> tuple:
    """(status, response headers, body bytes, client ms) of one request to
    127.0.0.1:port; HTTP errors are returned, not raised."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, headers=headers or {},
        method="GET" if data is None else "POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            code, hdr, body = r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        code, hdr, body = e.code, e.headers, e.read()
    return code, hdr, body, (time.perf_counter() - t0) * 1e3


def post_rows(port: int, path: str, rows: np.ndarray,
              headers: dict | None = None) -> tuple:
    """POST rows: a uint8 block as a binned=raw body, float rows as JSON."""
    if rows.dtype == np.uint8:
        sep = "&" if "?" in path else "?"
        return http_call(port, f"{path}{sep}binned=raw", rows.tobytes(),
                         {"Content-Type": "application/octet-stream",
                          **(headers or {})})
    return http_call(port, path, json.dumps({"rows": rows.tolist()}).encode(),
                     {"Content-Type": "application/json", **(headers or {})})


def start_http(engine) -> tuple:
    ready = threading.Event()
    th = threading.Thread(target=serve_forever, args=(engine,),
                          kwargs=dict(port=0, ready_event=ready),
                          daemon=True)
    th.start()
    check(ready.wait(60), "HTTP front end listening")
    return th, engine.http_port


def stop_http(port: int, th: threading.Thread) -> None:
    http_call(port, "/shutdown", b"{}")
    th.join(60)
    check(not th.is_alive(), "HTTP front end stopped")


def nearest_rank(ms: list) -> dict:
    """p50 / p99 / p999 by nearest rank (the engine's quantile rule)."""
    v = sorted(ms)
    if not v:
        return {"p50_ms": None, "p99_ms": None, "p999_ms": None, "n": 0}
    q = {k: v[max(0, min(len(v) - 1, int(np.ceil(p * len(v))) - 1))]
         for k, p in (("p50_ms", 0.5), ("p99_ms", 0.99),
                      ("p999_ms", 0.999))}
    return {**q, "n": len(v)}


def storm(n_threads: int, per_thread: int, request, seed: int) -> list:
    """n_threads in-process clients, each sending per_thread requests made
    by request(rng, thread, i); returns what they returned. A raising
    request fails the phase."""
    out, errors = [], []
    lock = threading.Lock()

    def client(t):
        rng = np.random.default_rng(seed * 1000 + t)
        for i in range(per_thread):
            try:
                got = request(rng, t, i)
            except Exception as e:  # collected, checked empty below
                with lock:
                    errors.append(repr(e))
                continue
            with lock:
                out.append(got)

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    check(not any(t.is_alive() for t in threads), "storm clients done")
    check(not errors, f"storm errors: {errors[:3]}")
    return out


def plane_refs(models: dict, pool: np.ndarray, bins: dict) -> dict:
    """Offline api.predict of every artifact at its tier on the pool's
    float rows and on the binned blocks its bin space admits (`bins`:
    kind -> (block, its highest bin)): {(name, kind): scores}."""
    refs = {}
    for name, (bundle, tier) in models.items():
        cfg = TrainConfig(predict_impl=TIER_IMPL[tier])
        refs[name, "float"] = api.predict(bundle, pool, cfg=cfg)
        for kind, (Xb, top) in bins.items():
            if top < bundle.mapper.n_bins:
                refs[name, kind] = api.predict(bundle.ensemble, Xb,
                                               binned=True, cfg=cfg)
    return refs


#: The HTTP clients of arms a and b, in a process of their own (numpy and
#: the standard library only), so that the server's interpreter serves
#: and the clients' JSON work runs elsewhere. argv[1] is a JSON spec:
#: port, pool / bins (.npy paths), threads, requests a thread, seed,
#: raw_share, routes (fleet model names, or null), flag (a path: past
#: half its requests each client keeps sending until it exists, or null)
#: and out (the results' path).
PLANE_CLIENT = r"""
import json, os, sys, threading, time, urllib.error, urllib.request
import numpy as np
spec = json.load(open(sys.argv[1]))
pool, bins = np.load(spec["pool"]), np.load(spec["bins"])
port, routes, n = spec["port"], spec["routes"], spec["requests"]
out, errors = [], []
lock = threading.Lock()
def call(path, data, headers):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, headers=headers, method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            code, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read()
    return code, body, (time.perf_counter() - t0) * 1e3
def client(t):
    rng = np.random.default_rng(spec["seed"] * 1000 + t)
    i, deadline = 0, time.monotonic() + 300
    while i < n:
        s = int(rng.integers(0, len(pool) - 64))
        c = int(rng.integers(1, 65))
        raw = bool(rng.random() < spec["raw_share"])
        route = routes[(t + i) % len(routes)] if routes else None
        path, headers = "/predict", {}
        if route is not None and i % 2:
            path = f"/models/{route}/predict"
        elif route is not None:
            headers["X-DDT-Model"] = route
        if raw:
            code, body, ms = call(
                path + "?binned=raw", bins[s:s + c].tobytes(),
                {"Content-Type": "application/octet-stream", **headers})
        else:
            code, body, ms = call(
                path, json.dumps({"rows": pool[s:s + c].tolist()}).encode(),
                {"Content-Type": "application/json", **headers})
        with lock:
            if code != 200:
                errors.append([code, body[:300].decode(errors="replace")])
            else:
                r = json.loads(body)
                out.append(["raw" if raw else "float", s, c,
                            route or r["model"], ms, r["scores"]])
        if not (spec["flag"] and i == n // 2 and time.monotonic() < deadline
                and not os.path.exists(spec["flag"])):
            i += 1
threads = [threading.Thread(target=client, args=(t,))
           for t in range(spec["threads"])]
t0 = time.perf_counter()
for t in threads:
    t.start()
for t in threads:
    t.join()
with open(spec["out"], "w") as f:
    json.dump({"results": out, "errors": errors,
               "wall_s": time.perf_counter() - t0}, f)
"""


def http_storm(port: int, tmp: str, name: str, routes=None,
               flag: str | None = None) -> subprocess.Popen:
    """Start PLANE_CLIENT against `port` over the pool and the 15-bin
    codes saved in `tmp`; returns the process (read_storm collects)."""
    spec = {"port": port, "pool": os.path.join(tmp, "pool.npy"),
            "bins": os.path.join(tmp, "bins15.npy"),
            "threads": PLANE_THREADS, "requests": PLANE_REQUESTS,
            "seed": len(name), "raw_share": PLANE_RAW_SHARE,
            "routes": routes, "flag": flag,
            "out": os.path.join(tmp, f"{name}.json")}
    path = os.path.join(tmp, f"{name}.spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return subprocess.Popen([sys.executable, "-c", PLANE_CLIENT, path],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def read_storm(proc: subprocess.Popen, tmp: str, name: str) -> dict:
    try:
        _, err = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=60)
    check(proc.returncode == 0, f"{name} clients: {err[-2000:]}")
    with open(os.path.join(tmp, f"{name}.json")) as f:
        got = json.load(f)
    check(not got["errors"], f"{name}: failed requests {got['errors'][:3]}")
    return got


def plane_single(tier, b255, by_token: dict, refs: dict, pool, bins15,
                 root: str, tmp: str) -> dict:
    """Arm a at one tier: the 255-bin model behind serve_forever, a storm
    of JSON float and binned=raw requests from a client process with a
    swap by registry reference mid-storm, then express singles, the wire
    and trace checks and /stats?emit=1."""
    rl = RunLog()
    eng = ServeEngine(b255, TrainConfig(), quantize=tier, max_batch=256,
                      max_wait_ms=1.0, run_log=rl)
    eng.registry_root = root
    th, port = start_http(eng)
    label = f"single_{tier or 'f32'}"
    flag = os.path.join(tmp, f"{label}.swapped")
    try:
        out = {}
        proc = http_storm(port, tmp, label, flag=flag)
        deadline = time.monotonic() + 300
        while (eng.stats.requests < PLANE_THREADS * PLANE_REQUESTS // 2
               and time.monotonic() < deadline and proc.poll() is None):
            time.sleep(0.001)
        # A /metrics scrape mid-storm: every counter series lies between
        # the snapshots taken just before and just after it.
        c0 = tele_counters.snapshot()
        code, _, text, _ = http_call(port, "/metrics")
        c1 = tele_counters.snapshot()
        check(code == 200, "mid-storm /metrics")
        scraped = parse_exposition(text.decode())
        for k in c0:
            v = scraped[f"ddt_{k}_total"][()]
            check(c0[k] <= v <= c1[k], f"/metrics {k}: {c0[k]} <= {v} <= "
                  f"{c1[k]}")
        target = "higgs15@1" if tier is None else "higgs15_4@1"
        code, _, body, swap_ms = http_call(
            port, "/swap", json.dumps({"model": target}).encode(),
            {"Content-Type": "application/json"})
        open(flag, "w").close()
        check(code == 200, f"serve_plane {tier}: /swap {body[:200]}")
        swap = json.loads(body)
        got = read_storm(proc, tmp, label)
        results = got["results"]
        served = {}
        for kind, s, c, token, ms, scores in results:
            name = by_token[token]
            served[name] = served.get(name, 0) + 1
            check(np.array_equal(np.float32(scores),
                                 refs[(name, tier), kind][s:s + c]),
                  f"serve_plane {tier}: {kind} rows [{s}:{s + c}] by "
                  f"{name} differ from offline api.predict")
        check(len(served) == 2, f"serve_plane {tier}: both models served "
              f"{served}")
        segments = {k: float(np.median([t[k] for t in
                                        eng.stats.traces_snapshot()]))
                    for k in ("handler_ms", "queue_ms", "gate_ms",
                              "device_ms", "wake_ms", "total_ms")}
        storm_ms = {kind: nearest_rank([r[4] for r in results
                                        if r[0] == kind])
                    for kind in ("float", "raw")}
        window = eng.stats.window_summary(reset=False)
        # Express singles at an idle queue, one at a time.
        express0 = eng.stats.express
        rng = np.random.default_rng(7)
        ex_ms = []
        for _ in range(PLANE_EXPRESS):
            s = int(rng.integers(0, len(pool)))
            code, _, body, ms = post_rows(port, "/predict", pool[s:s + 1])
            r = json.loads(body)
            check(code == 200 and np.array_equal(
                np.float32(r["scores"]),
                refs[(by_token[r["model"]], tier), "float"][s:s + 1]),
                f"serve_plane {tier}: express row {s}")
            ex_ms.append(ms)
        check(eng.stats.express > express0, "express lane used")
        # raw and JSON binned bodies agree bitwise; a ragged raw body 400s.
        code, _, b1, _ = post_rows(port, "/predict", bins15[:64])
        code2, _, b2, _ = http_call(
            port, "/predict", json.dumps({"rows": bins15[:64].tolist(),
                                          "binned": True}).encode(),
            {"Content-Type": "application/json"})
        check(code == code2 == 200 and json.loads(b1)["scores"]
              == json.loads(b2)["scores"], "raw == JSON binned, bitwise")
        code, _, body, _ = http_call(
            port, "/predict?binned=raw", bins15[:2].tobytes()[:-1],
            {"Content-Type": "application/octet-stream"})
        check(code == 400 and b"whole number" in body, "ragged raw -> 400")
        # A client trace id round-trips through the headers and the ring.
        pin = f"serve-plane-{tier or 'f32'}"
        code, hdr, _, _ = post_rows(port, "/predict", pool[:3],
                                    {"X-DDT-Trace-Id": pin})
        segs = dict(kv.split("=") for kv in
                    (hdr["X-DDT-Timing"] or "").split(","))
        check(code == 200 and hdr["X-DDT-Trace-Id"] == pin
              and set(segs) == {"handler", "queue", "gate", "device",
                                "wake", "total"}, "trace headers")
        _, _, dbg, _ = http_call(port, "/debug/requests")
        check(pin in [t["trace_id"] for t in
                      json.loads(dbg)["models"]["default"]],
              "trace id in /debug/requests")
        code, _, body, _ = http_call(port, "/stats?emit=1")
        emitted = json.loads(body)
        ev = rl.events("serve_latency")[-1]
        validate_event(ev)
        check(code == 200 and ev["requests"] == emitted["requests"] > 0,
              "/stats?emit=1 event")
        _, _, body, _ = http_call(port, "/healthz")
        health = json.loads(body)
        check(health["predict_impl"] == TIER_RESOLVED[tier],
              f"serve_plane {tier}: health tier {health['predict_impl']}")
        out.update(tier=tier or "f32", requests=len(results),
                   clients_wall_s=got["wall_s"], swap_ms=swap_ms,
                   swap=swap, served=served, http_ms=storm_ms,
                   express_http_ms=nearest_rank(ex_ms),
                   trace_median_ms=segments, storm_window=window)
    finally:
        stop_http(port, th)
    return out


def model_bytes(model) -> int:
    """Bytes of one ServableModel's operand tensors on the card (the LUT
    tiers' operand tuple, or K3's packed records)."""
    ops = model.operands().ops
    parts = ops.ops if isinstance(ops, predict_lut.LutOperands) else ops
    return sum(t.numel() * t.element_size() for t in parts
               if isinstance(t, torch.Tensor))


def allocated() -> int:
    torch.cuda.synchronize()
    gc.collect()
    return torch.cuda.memory_allocated()


def plane_fleet(refs: dict, pool, root: str, tmp: str) -> dict:
    """Arm b: three artifacts at f32, int8 and int4 behind one fleet with
    max_resident 2, a storm routed by path and header, a deterministic
    cycle of evictions and reloads, a steady-state window, and the card
    memory an eviction frees."""
    names = ("ff32", "fi8", "fi4")
    alone = {}
    for name in names:
        m0 = allocated()
        eng = build_fleet(parse_models_arg(f"{name}@1"), registry=root)
        alone[name] = allocated() - m0
        eng.close()
        del eng
    rl = RunLog()
    eng = build_fleet(parse_models_arg(",".join(f"{n}@1" for n in names)),
                      registry=root, max_resident=2, max_wait_ms=1.0,
                      run_log=rl)
    th, port = start_http(eng)

    def fleet_storm(label):
        got = read_storm(http_storm(port, tmp, label, routes=list(names)),
                         tmp, label)
        for kind, s, c, name, _, scores in got["results"]:
            check(np.array_equal(np.float32(scores),
                                 refs[name, kind][s:s + c]),
                  f"fleet {name}: {kind} rows [{s}:{s + c}] differ from "
                  "offline api.predict")
        return got

    try:
        got = fleet_storm("fleet")
        results = got["results"]
        # The same storm again under torch.profiler: the card's busy share
        # while the fleet serves (its latencies are the first storm's).
        holder = {}
        prof = profiled(lambda: holder.update(got=fleet_storm("fleet_prof")),
                        pad_s=1.0)
        prof["requests"] = len(holder["got"]["results"])
        # A deterministic cycle: with 2 resident, each request for the
        # third model evicts one and reloads it on the handler thread.
        cycle = []
        for name in names * 2:
            r0 = eng.health()["models"][name]["reloads"]
            code, _, body, ms = post_rows(port, f"/models/{name}/predict",
                                          pool[:1])
            check(code == 200, f"fleet cycle {name}")
            cycle.append({"model": name, "ms": ms, "reloaded":
                          eng.health()["models"][name]["reloads"] > r0})
        _, _, body, _ = http_call(port, "/healthz")
        health = json.loads(body)
        check(health["evictions"] >= 1 and health["reloads"] >= 1,
              f"fleet evictions {health['evictions']} reloads "
              f"{health['reloads']}")
        # Steady state over the two resident models: no nvcc build, no
        # operand build.
        resident = [n for n, m in health["models"].items() if m["resident"]]
        check(len(resident) == 2, f"fleet resident {resident}")
        b0, o0 = _build.builds, cuda_backend.operand_builds
        rng = np.random.default_rng(3)
        steady_ms = []
        for i in range(PLANE_STEADY):
            s = int(rng.integers(0, len(pool) - 64))
            code, _, _, ms = post_rows(
                port, f"/models/{resident[i % 2]}/predict",
                pool[s:s + int(rng.integers(1, 65))])
            check(code == 200, "fleet steady state")
            steady_ms.append(ms)
        steady = {"nvcc_builds": _build.builds - b0,
                  "operand_builds": cuda_backend.operand_builds - o0}
        check(steady == {"nvcc_builds": 0, "operand_builds": 0},
              f"fleet steady state builds {steady}")
        # The card memory an eviction frees: touch resident[1] so
        # resident[0] is the coldest, then load the third model.
        coldest, warm = resident
        third = next(n for n in names if n not in resident)
        post_rows(port, f"/models/{warm}/predict", pool[:1])
        held = model_bytes(eng._slots[coldest].model)
        before = allocated()
        t1 = time.perf_counter()
        code, _, _, reload_ms = post_rows(port, f"/models/{third}/predict",
                                          pool[:1])
        check(code == 200 and not eng.health()["models"][coldest][
            "resident"], f"fleet: {third} evicted {coldest}")
        after = allocated()
        freed = before + alone[third] - after
        check(freed >= held, f"eviction freed {freed} B of {coldest}'s "
              f"{held} operand bytes")
        by_model = {n: nearest_rank([r[4] for r in results if r[3] == n])
                    for n in names}
        faults = [e["kind"] for e in rl.events("fault")]
    finally:
        stop_http(port, th)
    return {"clients_wall_s": got["wall_s"], "requests": len(results),
            "profiled_storm": prof,
            "http_ms": by_model, "cycle": cycle,
            "reload_ms": [c["ms"] for c in cycle if c["reloaded"]],
            "evictions": health["evictions"], "reloads": health["reloads"],
            "steady": steady, "steady_http_ms": nearest_rank(steady_ms),
            "evicted_operand_bytes": held, "freed_bytes": freed,
            "incoming_bytes": alone[third], "evict_reload_ms": reload_ms,
            "eviction_wall_s": time.perf_counter() - t1,
            "fault_kinds": sorted(set(faults))}


def ab_windows(sides: dict, rows, seed: int) -> dict:
    """Saturated in-process windows, the sides interleaved (a, b, a, b,
    ...): PLANE_AB_THREADS threads of PLANE_AB_REQUESTS requests of 1-64
    rows each; returns each side's per-window p99 (ms) and its responses
    by (window, thread, request)."""
    out = {k: {"p99_ms": [], "responses": {}} for k in sides}
    for w in range(PLANE_AB_WINDOWS):
        for side, predict in sides.items():
            def request(rng, t, i, predict=predict):
                s = int(rng.integers(0, len(rows) - 64))
                c = int(rng.integers(1, 65))
                t0 = time.perf_counter()
                got = predict(rows[s:s + c])
                return (w, t, i), (time.perf_counter() - t0) * 1e3, got

            res = storm(PLANE_AB_THREADS, PLANE_AB_REQUESTS, request,
                        seed * 100 + w)
            out[side]["p99_ms"].append(
                nearest_rank([ms for _, ms, _ in res])["p99_ms"])
            out[side]["responses"].update({k: g for k, _, g in res})
    return out


def ab_ratio(ab: dict, a: str, b: str) -> dict:
    return {"a": a, "b": b, "p99_ms": {k: ab[k]["p99_ms"] for k in (a, b)},
            "ratio_of_min_p99": min(ab[a]["p99_ms"]) / min(ab[b]["p99_ms"])}


def plane_drift(refs: dict, bins255s, bins15, root: str) -> dict:
    """Arm c: a drift-tracked champion with an int4 shadow challenger and
    an unshifted control; covariate-shifted binned traffic to the
    champion in saturated windows interleaved with the same traffic to a
    fleet with drift and the shadow off."""
    c0 = tele_counters.snapshot()
    rl = RunLog()
    on = build_fleet([FleetSpec(name="champ", ref="higgs@1", drift=True),
                      FleetSpec(name="chall", ref="higgs4@1",
                                shadow_of="champ"),
                      FleetSpec(name="ctrl", ref="higgs15@1", drift=True)],
                     registry=root, max_wait_ms=1.0, run_log=rl)
    off = build_fleet([FleetSpec(name="champ", ref="higgs@1", drift=False)],
                      registry=root, max_wait_ms=1.0)
    try:
        ab = ab_windows({
            "drift_shadow_on": lambda r: on.predict(r, model="champ",
                                                    timeout=120.0),
            "drift_shadow_off": lambda r: off.predict(r, model="champ",
                                                      timeout=120.0)},
            bins255s, 3)
        mine = ab["drift_shadow_on"]["responses"]
        theirs = ab["drift_shadow_off"]["responses"]
        check(mine.keys() == theirs.keys() and all(
            np.array_equal(mine[k], theirs[k]) for k in mine),
            "champion bitwise with the shadow on and off")
        sent = len(mine)
        ctrl_rows = []
        for s in range(0, PLANE_DRIFT_CTRL, 256):
            ctrl_rows.append(bins15[s:s + 256])
            got = on.predict(bins15[s:s + 256], model="ctrl", timeout=60.0)
            check(np.array_equal(got, refs["higgs15", "raw"][s:s + 256]),
                  "control rows bitwise offline")
        got = on.predict(bins255s[:64], model="champ", timeout=60.0)
        check(np.array_equal(got, refs["higgs", "raw255s"][:64]),
              "champion bitwise offline api.predict")
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            sh = on.health()["models"]["champ"]["shadow"]
            rows_in = on._slots["champ"].drift._win_rows
            if sh["rows"] > 0 and rows_in >= 1:
                break
            time.sleep(0.01)
        h = on.health()["models"]
        d = tele_counters.delta(c0)
        drifts = [e for e in rl.events("drift")]
        for e in drifts:
            validate_event(e)
        check(h["champ"]["drift_alerting"] is True
              and h["champ"]["drift_alerts"] == 1
              and h["ctrl"]["drift_alerting"] is False
              and h["ctrl"]["drift_alerts"] == 0
              and d["drift_alerts"] == 1
              and [e["model_name"] for e in drifts] == ["champ"],
              f"only the shifted model alerts: {h['champ']} {h['ctrl']} "
              f"{d['drift_alerts']} {drifts}")
        check(sh["rows"] > 0 and sh["errors"] == 0, f"shadow {sh}")
        check(on._slots["champ"].shadow._stream is not None,
              "shadow on its own stream")
        win = {n: on._slots[n].drift._win for n in ("champ", "ctrl")}
    finally:
        on.close()
        off.close()
    return {"ab": ab_ratio(ab, "drift_shadow_on", "drift_shadow_off"),
            "champ_requests": sent, "ctrl_rows": PLANE_DRIFT_CTRL,
            "alerts": d["drift_alerts"], "shadow": sh,
            "champ_psi_max": h["champ"]["drift_psi_max"],
            "ctrl_psi_max": h["ctrl"]["drift_psi_max"],
            "window": win, "ctrl_sent": np.concatenate(ctrl_rows)}


def plane_child(refs: dict, pool, bins15, root: str) -> dict:
    """Arm d: a cold `python -m ddt_tpu_torch.cli serve --registry R
    --model higgs@1` child on the card: bitwise answers, no nvcc build."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "ddt_tpu_torch.cli", "serve", "--registry",
         root, "--model", "higgs@1", "--port", str(port)], cwd=HERE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        info = json.loads(proc.stdout.readline() or "{}")
        check(info.get("device") == "cuda" and info.get("mode") == "rebuild",
              f"cli serve child: {info}")
        deadline = time.monotonic() + 300
        while True:
            try:
                if http_call(port, "/healthz")[0] == 200:
                    break
            except OSError:
                pass
            check(time.monotonic() < deadline and proc.poll() is None,
                  "cli serve child came up")
            time.sleep(0.05)
        up_s = time.perf_counter() - t0
        rng = np.random.default_rng(5)
        ms = []
        for i in range(PLANE_CHILD_REQUESTS):
            s = int(rng.integers(0, len(pool) - 64))
            c = int(rng.integers(1, 65))
            kind = "raw" if i % 2 else "float"
            rows = bins15[s:s + c] if i % 2 else pool[s:s + c]
            code, _, body, m = post_rows(port, "/predict", rows)
            check(code == 200 and np.array_equal(
                np.float32(json.loads(body)["scores"]),
                refs["higgs", kind][s:s + c]),
                f"cli serve child: {kind} rows [{s}:{s + c}] bitwise")
            ms.append(m)
        _, _, text, _ = http_call(port, "/metrics")
        builds = parse_exposition(text.decode())["ddt_jit_compiles_total"][()]
        check(builds == 0, f"cli serve child ran {builds} nvcc builds")
        http_call(port, "/shutdown", b"{}")
        check(proc.wait(timeout=60) == 0, "cli serve child exited 0")
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate(timeout=60)
    return {"up_s": up_s, "http_ms": nearest_rank(ms), "nvcc_builds": 0,
            "requests": PLANE_CHILD_REQUESTS}


def phase_serve_plane(res255, res15, X: np.ndarray, card: dict) -> dict:
    """The serving plane on the card: arms a (single model over HTTP at
    f32 and int4, swap by registry reference mid-storm), b (fleet of f32,
    int8 and int4 artifacts, max_resident 2), c (drift and shadow) and d
    (a cold `cli serve` child), and the three A/B ratios."""
    t0 = time.perf_counter()
    b255 = api.ModelBundle(res255.ensemble, res255.mapper)
    b15 = api.ModelBundle(res15.ensemble, res15.mapper)
    pool = np.ascontiguousarray(X[:SERVE_POOL], np.float32)
    bins15 = res15.mapper.transform(pool)
    shifted = pool + 5.0 * np.abs(pool).max(axis=0)
    bins255s = res255.mapper.transform(shifted)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "reg")
        np.save(os.path.join(tmp, "pool.npy"), pool)
        np.save(os.path.join(tmp, "bins15.npy"), bins15)
        artifacts = {"higgs": (b255, None), "higgs15": (b15, None),
                     "higgs4": (b255, "int4"), "higgs15_4": (b15, "int4"),
                     "ff32": (b255, None), "fi8": (b15, "int8"),
                     "fi4": (b255, "int4")}
        for name, (bundle, tier) in artifacts.items():
            push_servable(root, bundle, name=name, max_batch=256,
                          quantize=tier or False)
        refs = plane_refs(artifacts, pool, {
            "raw": (bins15, int(bins15.max())),
            "raw255s": (bins255s, int(bins255s.max()))})
        # Arm a's answers by (token, tier): the engine quantizes the
        # 255-bin model itself, the swap restores the 15-bin artifact.
        tok = {b255.ensemble.cache_token(): "255",
               b15.ensemble.cache_token(): "15"}
        single_refs = {}
        for tier, names in ((None, ("higgs", "higgs15")),
                            ("int4", ("higgs4", "higgs15_4"))):
            for label, name in zip(("255", "15"), names):
                for kind in ("float", "raw"):
                    single_refs[(label, tier), kind] = refs[name, kind]
        torch.cuda.synchronize()
        predict_cuda.launches = 0
        predict_lut_cuda.launches_lut = 0
        predict_lut_cuda.launches_lut4 = 0
        single = {(tier or "f32"): plane_single(tier, b255, tok,
                                                single_refs, pool, bins15,
                                                root, tmp)
                  for tier in (None, "int4")}
        fleet = plane_fleet(refs, pool, root, tmp)
        drift = plane_drift(refs, bins255s, bins15, root)
        check(np.array_equal(drift["window"]["ctrl"], feature_bincounts(
            drift["ctrl_sent"], 15)), "control window == numpy bincount")
        champ_sent = np.concatenate([
            bins255s[s:s + c] for s, c in plane_ab_spans(3)] + [
            bins255s[:64]])
        check(np.array_equal(drift["window"]["champ"], feature_bincounts(
            champ_sent, 255)), "champion window == numpy bincount, bitwise")
        # Fleet against single engine, request traces on against off.
        one = build_fleet([FleetSpec(name="m", ref="higgs@1")],
                          registry=root, max_wait_ms=1.0)
        eng = ServeEngine(b255, TrainConfig(), max_batch=256,
                          max_wait_ms=1.0)
        quiet = ServeEngine(b255, TrainConfig(), max_batch=256,
                            max_wait_ms=1.0, request_traces=False)
        try:
            ab_fleet = ab_windows({
                "fleet": lambda r: one.predict(r, model="m", timeout=120.0),
                "single": lambda r: eng.predict(r, timeout=120.0)}, pool, 4)
            ab_traces = ab_windows({
                "traces_on": lambda r: eng.predict(r, timeout=120.0),
                "traces_off": lambda r: quiet.predict(r, timeout=120.0)},
                pool, 5)
            # One saturated window of the single engine under
            # torch.profiler: the card's busy share and its kernels.
            prof_single = profiled(lambda: ab_windows(
                {"single": lambda r: eng.predict(r, timeout=120.0)},
                pool, 6), pad_s=1.0)
        finally:
            one.close()
            eng.close()
            quiet.close()
        child = plane_child(refs, pool, bins15, root)
    torch.cuda.synchronize()
    launches = {"traverse": predict_cuda.launches,
                "lut": predict_lut_cuda.launches_lut,
                "lut4": predict_lut_cuda.launches_lut4}
    for name, n in launches.items():
        check(n > 0, f"serve_plane: {name} kernel launched")
    for tier, row in single.items():
        emit({"phase": "serve_plane", "arm": "a_single_http", "tier": tier,
              "nvidia_smi": card["smi"], **row})
    emit({"phase": "serve_plane", "arm": "b_fleet", "nvidia_smi":
          card["smi"], **fleet})
    emit({"phase": "serve_plane", "arm": "c_drift_shadow", "nvidia_smi":
          card["smi"], **{k: v for k, v in drift.items()
                          if k not in ("window", "ctrl_sent")}})
    emit({"phase": "serve_plane", "arm": "d_cli_child", "nvidia_smi":
          card["smi"], **child})
    emit({"phase": "serve_plane", "profiled_single_in_process":
          prof_single, "nvidia_smi": card["smi"]})
    emit({"phase": "serve_plane", "ratios": {
        "fleet_vs_single": ab_ratio(ab_fleet, "fleet", "single"),
        "traces_on_vs_off": ab_ratio(ab_traces, "traces_on", "traces_off"),
        "drift_shadow_on_vs_off": drift["ab"]},
        "launches": launches, "nvidia_smi": card["smi"],
        "wall_s": time.perf_counter() - t0})
    return launches


def plane_ab_spans(seed: int) -> list:
    """The (start, count) of every request one side of ab_windows(...,
    seed) makes (storm's per-thread generators), in no particular
    order."""
    spans = []
    for w in range(PLANE_AB_WINDOWS):
        for t in range(PLANE_AB_THREADS):
            rng = np.random.default_rng((seed * 100 + w) * 1000 + t)
            for _ in range(PLANE_AB_REQUESTS):
                s = int(rng.integers(0, SERVE_POOL - 64))
                spans.append((s, int(rng.integers(1, 65))))
    return spans


def mrows(n: int, seconds: float) -> float:
    return n / seconds / 1e6


def config4_arms(ens, mapper, Xs: np.ndarray, Xd: torch.Tensor,
                 want: np.ndarray, card: dict) -> dict:
    """The three scoring arms of ddt_tpu/bench.py's config 4 on one card
    (best of C4_REPS walls), each bitwise `want`, and K3's device ms
    against its bound."""
    dev = Xd.device
    be = get_backend(TrainConfig())
    ce = ens.compile(tree_chunk=64)
    tables, kernel, plain = device_operands(ce, dev)
    R, F = Xd.shape

    def total():
        return api.predict(ens, Xs, mapper=mapper, raw=True)

    def resident():
        return be.predict_raw(ens, Xd)

    arms = (("total", total), ("resident", resident),
            ("compute", lambda: kernel(Xd)))
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    walls = {}
    for name, fn in arms:
        runs = [synced(fn) for _ in range(C4_REPS)]
        if name == "total":
            peak = torch.cuda.max_memory_allocated() - base
        got = runs[-1][0]
        got = got.cpu().numpy()[:, 0] if name == "compute" else got
        check(np.array_equal(got, want), f"{name} arm bitwise")
        walls[name] = min(t for _, t in runs)
    busy = {}
    for (name, fn), expect in zip(arms[:2], (
            ("Memcpy HtoD", "searchsorted", "lut_rows", "Memcpy DtoH"),
            ("lut_rows", "Memcpy DtoH"))):
        # Padded: a profile opened late in a long process was seen to
        # miss its first ~120 ms of device events; an idle second before
        # the arm keeps them (device_lead_ms checks the device clock).
        prof = profiled(fn, pad_s=C4_PROFILE_PAD_S)
        seen = [any(e in r["name"] for r in prof["top"]) for e in expect]
        # A profile that lost device events is no measurement: its busy
        # share is not reported.
        busy[name] = ({"busy_share": prof["busy_share"],
                       "device_lead_ms": prof["device_lead_ms"],
                       "top": prof["top"][:6]} if all(seen) else
                      {"busy_share": "not measured: the profile lost "
                       f"device events ({prof['top'][:6]})",
                       "device_lead_ms": prof["device_lead_ms"]})
    sub = Xd[:C4_PLAIN_ROWS]
    plain_out = plain(sub).cpu().numpy()
    check(np.array_equal(kernel(sub).cpu().numpy(), plain_out),
          f"K3 == plain, bitwise, at {C4_PLAIN_ROWS} x {ens.n_trees}")
    # K3's margins of the whole 10M-row launch (`want`, which every arm
    # equals) against the plain version on rows from the whole batch: a
    # strided sample (every row offset's range) and the last
    # C4_PLAIN_ROWS rows (the grid's last blocks).
    for rows, what in ((slice(None, None, R // C4_PLAIN_ROWS), "strided"),
                       (slice(R - C4_PLAIN_ROWS, None), "last")):
        held = plain(Xd[rows].contiguous()).cpu().numpy()[:, 0]
        check(np.array_equal(want[rows], held),
              f"K3 at {R} rows == plain on the {what} {len(held)} rows, "
              "bitwise")
    compares = traverse_compares(ce, Xd)
    adds = R * ens.n_trees
    nbytes = R * F + R * 4 + tables.rec.numel()
    t_bytes = 1e3 * nbytes / card["bw"]
    t_ops = 1e3 * (compares / card["int32"] + adds / card["f32_add"])
    return {
        "mrows_per_s": {k: mrows(R, v) for k, v in walls.items()},
        "wall_ms": {k: 1e3 * v for k, v in walls.items()},
        "profiled": busy, "total_arm_peak_card_bytes": peak,
        "kernel_ms": time_ms(lambda: kernel(Xd), 10),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "int32_compares": compares, "f32_adds": adds,
        "kernel_ms_plain_rows": time_ms(lambda: kernel(sub), 5),
        "plain_ms_plain_rows": time_ms(lambda: plain(sub), 1),
        "plain_rows": C4_PLAIN_ROWS, "max_abs_err": 0.0,
        "plain_held_rows": {"first": C4_PLAIN_ROWS,
                            "strided": len(range(0, R, R // C4_PLAIN_ROWS)),
                            "last": C4_PLAIN_ROWS},
    }


def config4_multi(ens, mapper, Xs: np.ndarray, want: np.ndarray) -> dict:
    """The row-sharded scorer on k = 1..min(4, cards) cards (k = 1 the
    same code on one shard, the yardstick of its scaling; k > 1 through
    api.predict(n_partitions=k)): bitwise one card's api.predict, K3 and
    binning launched once a card; total and resident Mrows/s."""
    n = torch.cuda.device_count()
    out = {}
    R = Xs.shape[0]
    for k in range(1, min(4, n) + 1):
        sc = row_sharded_backend(k)

        def total():
            if k == 1:
                return sc.predict_raw(ens, Xs, mapper=mapper)
            return api.predict(ens, Xs, mapper=mapper, raw=True,
                               n_partitions=k)

        zero_counters()
        got = total()
        c = read_counters()
        check(np.array_equal(got, want),
              f"{k} card(s), row-sharded: bitwise one card's")
        check(c["traverse"] == k and c["binning"] == k,
              f"{k} card(s): K3 and binning once a card: {c}")
        blocks = []
        for i in range(k):
            a, b, _ = mesh.row_block(R, k, i)
            blocks.append(mapper.transform_device(Xs[a:b], f"cuda:{i}"))
        walls = {}
        for name, fn in (("total", total),
                         ("resident", lambda: sc.predict_raw(ens, blocks))):
            runs = [synced(fn) for _ in range(C4_REPS)]
            check(all(np.array_equal(g, want) for g, _ in runs),
                  f"{k} card(s) {name} bitwise")
            walls[name] = min(t for _, t in runs)
        out[k] = {"launches": c["traverse"],
                  "mrows_per_s": {n_: mrows(R, v) for n_, v in walls.items()},
                  "wall_ms": {n_: 1e3 * v for n_, v in walls.items()}}
        del blocks
    if n < 2:
        print("multi-card scoring not witnessed: 1 card", flush=True)
        return {"row_sharded": out, "multi_card": "not witnessed: 1 card"}
    return {"row_sharded": out, "multi_card": sorted(out)[1:]}


def phase_config4(card: dict, flush: torch.Tensor) -> dict:
    t0 = time.perf_counter()
    X, y = synthetic_binary(C4_TRAIN_ROWS, n_features=FEATURES, seed=4)
    cfg = TrainConfig(n_trees=C4_TREES, max_depth=DEPTH, n_bins=255)
    zero_counters()
    res, train_s = synced(lambda: api.train(X, y, cfg))
    trained = read_counters()
    check(trained["graph_replays"] == C4_TREES,
          f"{trained['graph_replays']} replays for {C4_TREES} trees")
    check(DEPTH * C4_TREES <= trained["hist"] <= DEPTH * (C4_TREES + 1),
          f"{trained['hist']} histogram launches for {C4_TREES} trees")
    ens, mapper = res.ensemble, res.mapper
    lgbm = lgbm_roundtrip(ens, mapper, X)
    del X, y
    t_data = time.perf_counter()
    Xs, _ = synthetic_binary(C4_ROWS, n_features=FEATURES, seed=5)
    data_s = time.perf_counter() - t_data
    zero_counters()
    want, first_s = synced(lambda: api.predict(ens, Xs, mapper=mapper,
                                               raw=True))
    scored = read_counters()
    check(scored["traverse"] == 1 and scored["binning"] == 1
          and scored["lut"] == scored["lut4"] == 0,
          f"config 4 scoring launched K3 once, binned once: {scored}")
    check(want.shape == (C4_ROWS,) and np.all(np.isfinite(want)),
          "config 4 scores finite, one per row")
    sub = C4_ORACLE_ROWS
    oracle = ens.predict_raw(mapper.transform(Xs[:sub]), binned=True)
    check(np.all(np.abs(want[:sub] - oracle) <= 1e-5 * (np.abs(oracle) + 1)),
          "config 4 scores == host oracle")
    Xd = mapper.transform_device(Xs, "cuda")
    arms = config4_arms(ens, mapper, Xs, Xd, want, card)
    del Xd
    multi = config4_multi(ens, mapper, Xs, want)
    row = {"train_rows": C4_TRAIN_ROWS, "trees": ens.n_trees,
           "depth": DEPTH, "bins": 255, "rows": C4_ROWS,
           "features": FEATURES, "train_s": train_s,
           "train_launches": trained, "lightgbm": lgbm,
           "scoring_rows_s": data_s, "first_total_s": first_s,
           "launches": scored["traverse"], **arms, **multi,
           "wall_s": time.perf_counter() - t0}
    emit({"phase": "config4", **row})
    return row


# --------------------------------------------------------------------- #
# operations: training telemetry and the operator's CLI on the card
# --------------------------------------------------------------------- #

OPS_TIERS = (None, "int8", "int4")


def cli_children(runs: dict) -> dict:
    """Run `python -m ddt_tpu_torch.cli <args>` for each name -> args of
    `runs`, side by side, from the repo root, each to its end: name ->
    (stdout lines, its seconds). Fails unless every one exits 0."""
    procs = {name: (time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "ddt_tpu_torch.cli", *args], cwd=HERE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for name, args in runs.items()}
    out = {}
    for name, (t0, p) in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        out[name] = (stdout.splitlines(), time.perf_counter() - t0)
        if p.returncode != 0:
            print(stderr[-4000:], file=sys.stderr)
        check(p.returncode == 0, f"cli {name} exited {p.returncode}")
    return out


def poll_status(proc: subprocess.Popen) -> list:
    """The cli train child's /healthz bodies until its status daemon
    closes: the first stdout line names the port; polled every 5 ms."""
    boot = json.loads(proc.stdout.readline() or "{}")
    check("statusd" in boot, f"cli train printed its status port: {boot}")
    port = boot["statusd"]["port"]
    seen = []
    while True:
        try:
            code, _, body, _ = http_call(port, "/healthz")
        except OSError:
            if seen or proc.poll() is not None:
                break
            time.sleep(0.005)
            continue
        if code == 200:
            seen.append(json.loads(body))
        time.sleep(0.005)
    return seen


def read_log(path: str) -> dict:
    """The run log's events by type, every line validated."""
    by = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            rec = json.loads(line)
            validate_event(rec)
            by.setdefault(rec["event"], []).append(rec)
    return by


def same_trees(a: TreeEnsemble, b: TreeEnsemble, what: str) -> None:
    for k in TREE_FIELDS:
        check(np.array_equal(getattr(a, k), getattr(b, k)),
              f"{what}: {k} bitwise")


def profiler_trace(trace_dir: str) -> dict:
    """What the capture window's Chrome trace holds: the ddt: ranges, the
    device kernels by name, and the graph launches."""
    with open(os.path.join(trace_dir, "trace.json"), encoding="utf-8") as f:
        tr = json.load(f)
    evs = tr["traceEvents"] if isinstance(tr, dict) else tr
    names = {}
    kernels = {}
    graph_launches = 0
    for e in evs:
        n = str(e.get("name", ""))
        if n.startswith("ddt:"):
            names[n] = names.get(n, 0) + 1
        if e.get("cat") == "kernel":
            kernels[n] = kernels.get(n, 0) + 1
        if "cudaGraphLaunch" in n:
            graph_launches += 1
    hist = sum(v for k, v in kernels.items() if "hist_kernel" in k)
    return {"ddt_ranges": names, "graph_launches": graph_launches,
            "kernel_events": sum(kernels.values()), "hist_kernels": hist,
            "kernels": dict(sorted(kernels.items(),
                                   key=lambda kv: -kv[1])[:12])}


def loop_ms_per_tree(Xd, y, cfg, log_path) -> tuple[float, int]:
    """The fused loop (Driver.fit on binned rows on the card) on a backend
    of its own, so that it captures its round: (ms a tree, capture
    included; the rounds it captured). With a run log when log_path is
    given, whose hist cost events must count the warm-up round and every
    replay."""
    be = cuda_backend.CUDADevice(cfg)
    drv = Driver(be, cfg, run_log=log_path)
    c0 = cuda_backend.graph_captures
    _, s = synced(lambda: drv.fit(Xd, y))
    captures = cuda_backend.graph_captures - c0
    if log_path is not None:
        check_hist_costs(read_log(log_path), captures, f"arm {log_path}")
    return 1e3 * s / cfg.n_trees, captures


def check_hist_costs(ev: dict, captures: int, what: str) -> int:
    """The run log's hist cost events count DEPTH calls for each of its
    N_TREES rounds, replayed or not, and for the warm-up round of each
    capture (the capture itself runs nothing): the count."""
    hist = [e for e in ev.get("cost_analysis", []) if e["op"] == "hist"]
    check(hist and all(e["phase"] == "hist" for e in hist),
          f"{what}: cost_analysis events for the hist phase")
    calls = sum(e["calls"] for e in hist)
    check(calls == DEPTH * (N_TREES + captures),
          f"{what}: {calls} K1 calls counted for {N_TREES} rounds and "
          f"{captures} capture(s)")
    return calls


def phase_ops(X: np.ndarray, y: np.ndarray) -> dict:
    """Training telemetry and the operator's CLI at config 1's full width
    (module docstring, phase ops)."""
    from ddt_tpu_torch.telemetry import report as tele_report
    from ddt_tpu_torch.telemetry.statusd import TrainStatus

    t_phase = time.perf_counter()
    cfg = TrainConfig(n_trees=N_TREES, max_depth=DEPTH, n_bins=255)
    tmp = tempfile.mkdtemp(prefix="ddt_ops_")
    rows = os.path.join(tmp, "rows.npz")
    np.savez(rows, X=X, y=y)
    common = ["--data", rows, "--trees", str(N_TREES), "--depth",
              str(DEPTH), "--bins", "255"]
    a, b = os.path.join(tmp, "a.jsonl"), os.path.join(tmp, "b.jsonl")
    prof_dir = os.path.join(tmp, "xprof")
    secs = {}

    # The untelemetered in-process model every CLI model must equal.
    plain = api.train(X, y, cfg)

    # 1. cli train with a run log, the status daemon and a capture
    # window of rounds 2-3.
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "ddt_tpu_torch.cli", "train", *common,
         "--run-log", a, "--status-port", "0", "--xprof-dir", prof_dir,
         "--xprof-rounds", "2:3", "--out", os.path.join(tmp, "a.npz")],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        seen = poll_status(proc)
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    secs["train_run_log"] = time.perf_counter() - t0
    if proc.returncode != 0:
        print(err[-4000:], file=sys.stderr)
    check(proc.returncode == 0, f"cli train exited {proc.returncode}")
    train_a = json.loads(out.splitlines()[-1])
    progress = [h["round"] for h in seen]
    check(len(set(progress)) >= 2 and progress == sorted(progress)
          and progress[-1] == N_TREES,
          f"/healthz progress rose to {N_TREES}: {sorted(set(progress))}")
    check(seen[-1]["phase"] == "done",
          f"/healthz last phase {seen[-1]['phase']!r} is done")
    ev = read_log(a)
    check(len(ev["round"]) == N_TREES, f"{len(ev['round'])} round records")
    for k in ("run_manifest", "phase_timings", "counters", "run_end"):
        check(k in ev, f"a.jsonl has {k}")
    c = ev["counters"][-1]
    check(c["jit_compiles"] >= 1, f"jit_compiles {c['jit_compiles']} >= 1")
    check((c["device_peak_bytes"] or 0) > 0,
          f"device_peak_bytes {c['device_peak_bytes']} > 0")
    # A new process captures its round once: a warm-up round, then one
    # set of calls a replay.
    hist_calls = check_hist_costs(ev, 1, "cli train --run-log")
    check(c["jit_compiles"] == 1 and c["jit_compile_seconds"] > 0,
          f"one round captured, no nvcc build: {c['jit_compiles']}")
    man = ev["run_manifest"][0]
    check(man["xprof_rounds"] == [2, 3] and
          man["xprof_dir"] == os.path.join(prof_dir, f"run_{man['run_id']}"),
          "the manifest names the capture window's trace")
    model_a = api.load_model(os.path.join(tmp, "a.npz"))
    same_trees(model_a.ensemble, plain.ensemble, "cli train --run-log")

    # 2. cli train --profile: the granular loop, phases on the card.
    runs = cli_children({"train_profile": [
        "train", *common, "--profile", "--run-log", b, "--out",
        os.path.join(tmp, "b.npz")]})
    secs["train_profile"] = runs["train_profile"][1]
    evb = read_log(b)
    phases = {p["phase"]: p for p in evb["phase_timings"][-1]["phases"]}
    check({"grad", "grow", "hist", "gain", "apply_delta",
           "fetch_tree"} <= set(phases), f"profiled phases {set(phases)}")
    phase_ms = sum(p["ms_total"] for p in phases.values())
    round_ms = sum(r["ms_per_round"] for r in evb["round"])
    check(abs(phase_ms - round_ms) <= 0.15 * round_ms,
          f"phases sum {phase_ms:.1f} ms within 15% of the rounds' "
          f"{round_ms:.1f}")
    summ = tele_report.summarize(tele_report.read_events(b))
    roof = {r["phase"]: r for r in summ["roofline"]}
    hist_row = roof["hist"]
    check(hist_row["hbm_util"] is not None and hist_row["hbm_util"] <= 1.0,
          f"hist achieved {hist_row['gbs']} GB/s, "
          f"{hist_row['hbm_util']} of the card's peak (<= 1)")
    same_trees(api.load_model(os.path.join(tmp, "b.npz")).ensemble,
               plain.ensemble, "cli train --profile")

    # 3-4. The readers, `cli predict` at the three tiers and `cli
    # inspect`, side by side (their seconds overlap).
    model = os.path.join(tmp, "a.npz")
    tpath = os.path.join(tmp, "trace.json")
    runs = {"report": ["report", "--log", a],
            "report_diff": ["report", "diff", a, b],
            "trace": ["trace", "--log", a, "--out", tpath],
            "inspect": ["inspect", "--model", model, "--tree", "0"]}
    for tier in OPS_TIERS:
        runs[f"predict_{TIER_RESOLVED[tier]}"] = [
            "predict", "--data", rows, "--model", model, "--out",
            os.path.join(tmp, f"s_{TIER_RESOLVED[tier]}.npy")] + (
            [] if tier is None else ["--quantized", tier])
    done = cli_children(runs)
    secs.update({k: v[1] for k, v in done.items()})
    with open(tpath, encoding="utf-8") as f:
        tr = json.load(f)
    slices = [e for e in tr["traceEvents"]
              if str(e.get("name", "")).startswith("round ")]
    check(len(slices) == N_TREES, f"{len(slices)} round slices in the trace")
    prof = profiler_trace(man["xprof_dir"])
    check(prof["ddt_ranges"], "the capture has ddt: ranges")
    # Rounds 2-3 only: two replays of the captured round, whose kernels
    # CUPTI reports one by one (K1 once a level).
    check(prof["graph_launches"] == 2 and prof["hist_kernels"] == 2 * DEPTH,
          f"the capture holds rounds 2-3's device work: {prof}")
    for tier in OPS_TIERS:
        name = TIER_RESOLVED[tier]
        want = api.predict(model_a, X, cfg=TrainConfig(
            predict_impl=TIER_IMPL[tier]))
        check(np.array_equal(np.load(os.path.join(tmp, f"s_{name}.npy")),
                             want),
              f"cli predict {name}: scores bitwise api.predict's")
    check(json.loads(done["inspect"][0][0])["n_trees"] == N_TREES,
          "cli inspect")

    # 5. The same path in this process, counted: a telemetered train
    # (run log, status, a capture window) and the three tiers' scoring.
    c_log = os.path.join(tmp, "c.jsonl")
    from ddt_tpu_torch.telemetry.profiler import CaptureWindow

    zero_counters()
    res = api.train(X, y, cfg, run_log=c_log, status=TrainStatus(),
                    profiler_window=CaptureWindow(
                        os.path.join(tmp, "xprof_in"), "2:3"))
    for tier in OPS_TIERS:
        api.predict(res.ensemble, X, mapper=res.mapper, cfg=TrainConfig(
            predict_impl=TIER_IMPL[tier]))
    launches = read_counters()
    # One capture at most: the backend keeps the round that the
    # untelemetered api.train above captured while the data's and labels'
    # addresses are the same. Either way the run log counts every replay.
    captures = launches["graph_captures"]
    check(launches["graph_replays"] == N_TREES and captures <= 1,
          f"ops: {launches['graph_replays']} replays of one capture "
          f"({captures} new)")
    check(launches["hist"] == DEPTH * (N_TREES + captures),
          f"ops: {launches['hist']} K1 launches for {N_TREES} trees")
    hist_calls_in = check_hist_costs(read_log(c_log), captures,
                                     "api.train with a run log")
    for k in ("traverse", "lut", "lut4"):
        check(launches[k] > 0, f"ops: {k} launched")
    same_trees(res.ensemble, plain.ensemble, "api.train with telemetry")

    # 6. The run log's cost on the fused loop: ms a tree with and without
    # one, interleaved, each fit on a backend of its own, so that each
    # captures its round once.
    Xd = res.mapper.transform_device(X, get_backend(cfg).device)
    ms = {"plain": [], "run_log": []}
    arm_captures = {"plain": [], "run_log": []}
    for arm in ("plain", "run_log", "run_log", "plain", "plain", "run_log"):
        gc.collect()                  # the last arm's graph freed untimed
        torch.cuda.synchronize()
        t, n = loop_ms_per_tree(
            Xd, y, cfg, None if arm == "plain" else
            os.path.join(tmp, f"o{len(ms[arm])}.jsonl"))
        ms[arm].append(t)
        arm_captures[arm].append(n)
    check(all(n == 1 for v in arm_captures.values() for n in v),
          f"ops: each timed fit captured its round once: {arm_captures}")
    out = {"phase": "ops", "rows": len(X), "trees": N_TREES,
           "healthz_rounds": sorted(set(progress)),
           "hist_calls_child": hist_calls,
           "hist_calls_in_process": hist_calls_in,
           "graph_captures_in_process": captures,
           "jit_compiles_child": c["jit_compiles"],
           "device_peak_bytes_child": c["device_peak_bytes"],
           "profiled_phases_ms": {k: p["ms_total"]
                                  for k, p in phases.items()},
           "profiled_rounds_ms": round_ms, "profiled_phases_sum_ms": phase_ms,
           "roofline": summ["roofline"], "profiler_trace": prof,
           "loop_ms_per_tree": ms, "loop_graph_captures": arm_captures,
           "cli_seconds": secs,
           "launches": launches, "wall_s": time.perf_counter() - t_phase}
    emit(out)
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    return out


# --------------------------------------------------------------------- #
# robustness, the CPU baseline, the straggler rotation (PR 15)
# --------------------------------------------------------------------- #

ROBUST_TREES = 8
ROBUST_EVERY = 4
ROBUST_CHUNKS = 4
ROBUST_OVERHEAD_FITS = 3      # a side, interleaved
#: A plan whose every fault fires once: two transient tree fetches, a torn
#: ensemble write, and an allocation failure at the third tree's second
#: level (a rung step on the granular loop).
ROBUST_PLAN = {"faults": [
    {"site": "fetch_tree", "times": 2},
    {"site": "ckpt.save.write", "round": ROBUST_EVERY},
    {"site": "hist.build", "after_calls": 2 * DEPTH + 1}]}
#: Armed at every seam, matching nothing (no seam passes these contexts).
ROBUST_NEVER = {"faults": [
    {"site": "hist.build", "chunk": -1},
    {"site": "fetch_tree", "round": -1},
    {"site": "ckpt.save.write", "round": -1},
    {"site": "stream.chunk_read", "chunk": -1}]}
#: The OOM ladder's peaks: a wide level of 65,536 rows x 1024 features at
#: 32 nodes (the last histogram level of a depth-6 tree), beside config 1.
LADDER_ROWS = 65_536
LADDER_FEATURES = 1024
#: The real-OOM witness: that width at depth 7 (a 64-node last level, so
#: the carried table, what rung 1 gives up, is 64 MiB or more), 2 trees.
OOM_DEPTH = 7
OOM_TREES = 2
BASELINE_REPS = 3
BASELINE_FIT_TREES = 5
#: The streamed backend="cpu" fit: config 1's shape, 5 trees, 4 chunks.
BASELINE_STREAM_TREES = 5
BASELINE_STREAM_CHUNKS = 4
STRAGGLER_ROWS = 1_000_000    # config 3: rows a rank, as phase multi
STRAGGLER_TREES = 12
STRAGGLER_BLOCK = 6           # flag off: fused blocks; the second is steady
STRAGGLER_EVERY = 2
#: An injected straggler on rank 1 for every round: 600 s added to its
#: lane (the watchdog trips; nothing sleeps).
STRAGGLER_PLAN = {"faults": [{"site": "straggler", "device": 1,
                              "delay_ms": 600000.0,
                              "rounds": [1, STRAGGLER_TREES],
                              "times": 1000}]}
STRAGGLER_CASES = (
    ("f32_allreduce", dict(split_comms="allreduce")),
    ("f32_reduce_scatter", dict(split_comms="reduce_scatter")),
    ("int8_allreduce", dict(grad_dtype="int8", split_comms="allreduce")),
    ("2x2_f32", dict(mesh_shape=(2, 2))))


def host_chunks(Xb: np.ndarray, y: np.ndarray, n: int):
    bounds = np.linspace(0, len(y), n + 1).astype(np.int64)

    def f(c):
        return Xb[bounds[c]:bounds[c + 1]], y[bounds[c]:bounds[c + 1]]

    return f


def level_peaks(Xd: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                depth: int, grad_dtype: str) -> dict:
    """One depth-`depth` tree grown by ops/grow.grow_tree at each rung of a
    ladder with the carry (sibling subtraction on): per rung the peak of
    card memory over its last histogram level's step (build, subtraction,
    split search) above what was allocated before it, the parent table
    it carries counted as the level's (`peak`), what grow_tree held
    before that step over what was allocated before the tree (`held`),
    and the tree's arrays (every rung's bitwise rung 0's)."""
    cfg = TrainConfig(max_depth=depth, n_bins=255)
    out, trees = {}, {}
    for rung in histogram.HistLadder(carry=True).rungs:
        ladder = histogram.HistLadder(carry=True)
        ladder.rung = rung
        got = {}

        def probe(d, carried, run, got=got):
            if d != depth - 1:
                return run()
            torch.cuda.synchronize()
            carry = (0 if carried is None
                     else carried.numel() * carried.element_size())
            base = torch.cuda.memory_allocated() - carry
            got["held"] = base - got["pre"]
            torch.cuda.reset_peak_memory_stats()
            res = run()
            torch.cuda.synchronize()
            got["peak"] = torch.cuda.max_memory_allocated() - base
            got["carried"] = carry
            return res

        gc.collect()
        torch.cuda.synchronize()
        got["pre"] = torch.cuda.memory_allocated()
        tree = grow_ops.grow_tree(
            Xd, g, h, max_depth=depth, n_bins=255, reg_lambda=cfg.reg_lambda,
            min_child_weight=cfg.min_child_weight,
            min_split_gain=cfg.min_split_gain, hist_subtraction=True,
            grad_dtype=grad_dtype, ladder=ladder, level_probe=probe)
        check(ladder.rung == rung, f"ladder peaks: rung {rung} held")
        trees[rung] = [t.cpu() for t in tree[:6]]
        out[rung] = {"name": histogram.rung_name(rung), "peak": got["peak"],
                     "held": got["held"], "carried": got["carried"]}
        del tree
    for rung in out:
        check(all(torch.equal(a, b) for a, b in zip(trees[0], trees[rung])),
              f"ladder peaks: rung {rung}'s tree bitwise rung 0's")
    return out


def round0_grads(y: np.ndarray, dev) -> tuple:
    """Round 0's logloss g, h at the base score (p = mean(y)) on `dev`."""
    p0 = float(y.mean())
    g = torch.from_numpy((p0 - y.astype(np.float32)).astype(np.float32))
    h = torch.full((len(y),), p0 * (1 - p0), dtype=torch.float32)
    return g.to(dev), h.to(dev)


def wide_rows(seed: int = 0) -> tuple:
    """LADDER_ROWS x LADDER_FEATURES binned rows on the card and labels
    that depend on a few columns."""
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, 255, size=(LADDER_ROWS, LADDER_FEATURES),
                      dtype=np.uint8)
    y = ((Xb[:, 0].astype(np.int32) + Xb[:, 7] - Xb[:, 99]
          + rng.integers(0, 96, LADDER_ROWS)) > 300).astype(np.float32)
    return torch.from_numpy(Xb).to("cuda"), y


def real_oom_fit(grad_dtype: str, n_trees: int = OOM_TREES) -> dict:
    """The real allocation failure: the card capped by
    set_per_process_memory_fraction between rung 0's and rung 1's level
    peak (measured first, level_peaks, on the fit's round-0 gradients;
    the cap three quarters of the way up from rung 1's, room for the
    allocator's segments), a granular fit of wide_rows at depth
    OOM_DEPTH on a fresh backend with no fault plan takes
    torch.cuda.OutOfMemoryError at rung 0, steps that backend down and
    finishes; its trees against the undisturbed fit's. The cap is
    lifted on every exit."""
    Xd, y = wide_rows()
    cfg = TrainConfig(n_trees=n_trees, max_depth=OOM_DEPTH, n_bins=255,
                      grad_dtype=grad_dtype)
    ref = api.train(Xd, y, cfg, binned=True,
                    backend=tasks.Granular(cfg)).ensemble
    g, h = round0_grads(y, Xd.device)
    peaks = level_peaks(Xd, g, h, OOM_DEPTH, grad_dtype)
    del g, h
    p0, p1 = peaks[0]["peak"], peaks[1]["peak"]
    be = tasks.Granular(cfg)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    cap = (torch.cuda.memory_reserved() + peaks[0]["held"] + p1
           + 3 * (p0 - p1) // 4)
    emit({"phase": "robust_oom_cap", "grad_dtype": grad_dtype,
          "peaks": peaks, "cap_bytes": cap, "total_bytes": total,
          "reserved_before": torch.cuda.memory_reserved()})
    log = RunLog()
    d0 = tele_counters.snapshot()["hist_oom_degrades"]
    torch.cuda.set_per_process_memory_fraction(cap / total)
    try:
        got = api.train(Xd, y, cfg, binned=True, backend=be,
                        run_log=log).ensemble
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    degrades = tele_counters.snapshot()["hist_oom_degrades"] - d0
    ev = [e for e in log.events("fault") if e["kind"] == "hist_oom_degrade"]
    same = all(np.array_equal(getattr(ref, k), getattr(got, k))
               for k in TREE_FIELDS)
    return {"grad_dtype": grad_dtype, "rows": LADDER_ROWS,
            "features": LADDER_FEATURES, "depth": OOM_DEPTH,
            "trees": n_trees, "peaks": peaks, "cap_bytes": cap,
            "cap_fraction": cap / total, "rung": be.hist_ladder.rung,
            "rung_name": histogram.rung_name(be.hist_ladder.rung),
            "degrades": degrades,
            "steps": [(e["from_impl"], e["to_impl"]) for e in ev],
            "real_oom": bool(ev) and ev[0]["from_impl"] == "k1",
            "bitwise": same}


def phase_robust(X: np.ndarray, y: np.ndarray, Xb: np.ndarray) -> dict:
    """Config 1 at full width under the fault plan (module docstring,
    phase robust)."""
    from ddt_tpu_torch.robustness import faultplan

    t_phase = time.perf_counter()
    out = {"phase": "robust", "rows": len(y), "trees": ROBUST_TREES,
           "plan": ROBUST_PLAN, "cases": {}}
    tmp = tempfile.mkdtemp(prefix="ddt_robust_")
    Xd = torch.from_numpy(Xb).to("cuda")
    zero_counters()
    for dt in ("f32", "int8"):
        cfg = TrainConfig(n_trees=ROBUST_TREES, max_depth=DEPTH, n_bins=255,
                          grad_dtype=dt)
        ref = api.train(Xd, y, cfg, binned=True,
                        backend=tasks.Granular(cfg)).ensemble
        fused = api.train(Xd, y, cfg, binned=True).ensemble
        same_trees(fused, ref, f"robust {dt}: fused vs granular")
        log = RunLog()
        be = tasks.Granular(cfg)
        prev = faultplan.activate(faultplan.load_plan(ROBUST_PLAN))
        try:
            chaos = api.train(Xd, y, cfg, binned=True, backend=be,
                              run_log=log,
                              checkpoint_dir=os.path.join(tmp, dt),
                              checkpoint_every=ROBUST_EVERY).ensemble
        finally:
            faultplan.deactivate(prev)
        rung = be.hist_ladder.rung
        same_trees(chaos, ref, f"robust {dt}: the planned faults")
        kinds = [e["kind"] for e in log.events("fault")]
        c = log.events("counters")[0]
        check(rung == 1, f"robust {dt}: one rung down, got {rung}")
        check(c["hist_oom_degrades"] == 1 and c["fault_retries"] == 3,
              f"robust {dt}: 1 degrade, 3 retries: {c}")
        check(kinds.count("injected") == 4
              and kinds.count("hist_oom_degrade") == 1,
              f"robust {dt}: fault events {kinds}")
        src = host_chunks(Xb, y, ROBUST_CHUNKS)
        clean = fit_streaming(src, ROBUST_CHUNKS, cfg,
                              device_chunk_cache=False)
        same_trees(clean, ref, f"robust {dt}: streamed vs in memory")
        slog = RunLog()
        prev = faultplan.activate(faultplan.load_plan({"faults": [
            {"site": "stream.chunk_read", "chunk": 1, "times": 2},
            {"site": "stream.chunk_read", "chunk": 3}]}))
        try:
            streamed = fit_streaming(src, ROBUST_CHUNKS, cfg, run_log=slog,
                                     device_chunk_cache=False)
        finally:
            faultplan.deactivate(prev)
        same_trees(streamed, clean, f"robust {dt}: stream.chunk_read")
        sc = slog.events("counters")[0]
        check(sc["fault_retries"] == 3,
              f"robust {dt}: 3 chunk-read retries, {sc['fault_retries']}")
        out["cases"][dt] = {
            "rung_taken": histogram.rung_name(rung),
            "fault_retries": c["fault_retries"],
            "hist_oom_degrades": c["hist_oom_degrades"],
            "fault_events": {k: kinds.count(k) for k in sorted(set(kinds))},
            "stream_fault_retries": sc["fault_retries"],
            "bitwise": ["granular", "fused", "planned faults", "streamed",
                        "stream.chunk_read"]}
    out["launches"] = read_counters()
    # The ladder's peaks: config 1 at full width and the wide level, each
    # rung strictly below the one above it; then the real allocation
    # failure under a memory cap, f32 and int8, and a backend of another
    # config starting at rung 0 in this process.
    gd, hd = round0_grads(y, Xd.device)
    out["ladder_peaks"] = {}
    for dt in ("f32", "int8"):
        for shape in ("config1_1m_x_28", "wide_65536_x_1024"):
            if shape.startswith("config1"):
                Xs, gs, hs = Xd, gd, hd
            else:
                Xs, yw = wide_rows()
                gs, hs = round0_grads(yw, Xs.device)
            pk = level_peaks(Xs, gs, hs, DEPTH, dt)
            vals = [pk[r]["peak"] for r in sorted(pk)]
            emit({"phase": "robust_ladder_peak", "shape": shape,
                  "grad_dtype": dt, "peaks": vals})
            check(all(b < a for a, b in zip(vals, vals[1:])),
                  f"robust ladder {shape} {dt}: peaks fall strictly {vals}")
            out["ladder_peaks"][f"{shape}_{dt}"] = {
                pk[r]["name"]: pk[r] for r in sorted(pk)}
            del Xs, gs, hs
    emit({"phase": "robust_ladder_peaks", "peaks": out["ladder_peaks"]})
    out["real_oom"] = {}
    for dt in ("f32", "int8"):
        r = real_oom_fit(dt)
        check(r["real_oom"] and r["degrades"] >= 1 and r["rung"] > 0,
              f"robust real OOM {dt}: a real failure at rung 0 stepped "
              f"down: {r['steps']}")
        check(r["bitwise"], f"robust real OOM {dt}: trees bitwise")
        out["real_oom"][dt] = r
    other_cfg = TrainConfig(n_trees=2, max_depth=DEPTH - 1, n_bins=255)
    other = tasks.Granular(other_cfg)
    check(other.hist_ladder.rung == 0, "robust: a new backend at rung 0")
    api.train(Xd, y, other_cfg, binned=True, backend=other)
    check(other.hist_ladder.rung == 0,
          "robust: another config's backend stays at rung 0")
    out["other_backend_rung"] = other.hist_ladder.rung
    emit({"phase": "robust_real_oom", "real_oom": out["real_oom"]})
    # The crash between the checkpoint pair's replaces, in a cli child,
    # then a second child resuming its directory (f32).
    rows = os.path.join(tmp, "rows.npz")
    np.savez(rows, X=X, y=y)
    plan = os.path.join(tmp, "between.json")
    with open(plan, "w") as f:
        json.dump({"faults": [{"site": "ckpt.save.between",
                               "round": 2 * ROBUST_EVERY - 2}]}, f)
    ck, model = os.path.join(tmp, "ck"), os.path.join(tmp, "resumed.npz")
    args = ["train", "--data", rows, "--trees", str(ROBUST_TREES),
            "--depth", str(DEPTH), "--bins", "255", "--checkpoint-dir", ck,
            "--checkpoint-every", "2", "--out", model]
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "ddt_tpu_torch.cli", *args,
                        "--fault-plan", plan], cwd=HERE, capture_output=True,
                       text=True, timeout=600)
    crash_s = time.perf_counter() - t0
    check(p.returncode != 0 and "InjectedCrash" in p.stderr,
          f"robust: the child crashed between the pair (rc {p.returncode})")
    with open(os.path.join(ck, "cursor.json")) as f:
        torn = json.load(f)["completed_rounds"]
    check(torn == 2 * ROBUST_EVERY - 4,
          f"robust: the torn pair's cursor at {torn}")
    (_, resume_s), = cli_children({"resume": args}).values()
    plain = api.train(X, y, TrainConfig(n_trees=ROBUST_TREES,
                                        max_depth=DEPTH, n_bins=255))
    same_trees(TreeEnsemble.load(model), plain.ensemble,
               "robust: crashed-then-resumed cli child")
    out["cli"] = {"crash_s": crash_s, "resume_s": resume_s,
                  "cursor_after_crash": torn, "bitwise": True}
    # The armed plan's cost on the fused loop: fits on backends of their
    # own (each captures), no plan and a never-matching plan interleaved.
    cfg = TrainConfig(n_trees=N_TREES, max_depth=DEPTH, n_bins=255)
    arms = {"no_plan": [], "armed_never_matching": []}
    for _ in range(ROBUST_OVERHEAD_FITS):
        for arm in arms:
            prev = faultplan.activate(
                faultplan.load_plan(ROBUST_NEVER)
                if arm != "no_plan" else None)
            try:
                ms, caps = loop_ms_per_tree(Xd, y, cfg, None)
            finally:
                faultplan.deactivate(prev)
            check(caps == 1, f"robust {arm}: one capture a fit")
            arms[arm].append(ms)
    out["fused_ms_per_tree"] = arms
    out["wall_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


def cpu_model() -> str:
    """The host CPU's model name as lscpu prints it, or /proc/cpuinfo's
    where lscpu names none (a sandboxed host may hide it from lscpu)."""
    name = "unknown"
    try:
        p = subprocess.run(["lscpu"], capture_output=True, text=True,
                           timeout=30)
        for line in p.stdout.splitlines():
            if line.startswith("Model name:"):
                name = line.split(":", 1)[1].strip()
    except OSError:
        pass
    if name.lower() in ("", "unknown"):
        try:
            with open("/proc/cpuinfo", encoding="utf-8") as f:
                for line in f:
                    if line.startswith("model name"):
                        return (f"{line.split(':', 1)[1].strip()} "
                                "(/proc/cpuinfo; lscpu: unknown)")
        except OSError:
            pass
    return name


def phase_baseline(X: np.ndarray, y: np.ndarray, Xb: np.ndarray,
                   levels: list, card: dict) -> dict:
    """The CPU reference baseline (module docstring, phase baseline)."""
    from ddt_tpu_torch import native
    from ddt_tpu_torch.backends.cpu import CPUDevice

    t_phase = time.perf_counter()
    be = CPUDevice(TrainConfig(backend="cpu", n_bins=255), use_native=True)
    check(be.hist_impl == "native", "baseline: the native histogram ran")
    dev = torch.device("cuda")
    R = Xb.shape[0]
    Xd = torch.from_numpy(Xb).to(dev)
    p0 = float(y.mean())
    g = (p0 - y.astype(np.float32)).astype(np.float32)
    h = np.full(R, p0 * (1 - p0), np.float32)
    gd, hd = torch.from_numpy(g).to(dev), torch.from_numpy(h).to(dev)
    scales = exact_scales(gd, hd)
    q = grad.quantize_gradients(gd, hd, grad_dtype="int8", tree_id=0,
                                seed=0)
    qg, qh = q[0], q[1]
    qgf, qhf = qg.float().cpu().numpy(), qh.float().cpu().numpy()
    his = [(ni.cpu().numpy(), n) for ni, n in levels]
    threads_all = native.omp_max_threads()

    def native_tree(gg, hh, threads):
        with native.omp_threads(threads):
            t0 = time.perf_counter()
            outs = [be.build_histograms(Xb, gg, hh, ni, n)
                    for ni, n in his]
            return outs, time.perf_counter() - t0

    rows = {}
    max_err = 0.0
    for mode in ("f32", "int8"):
        gg, hh = (g, h) if mode == "f32" else (qgf, qhf)
        res = {}
        for threads in (threads_all, 1):
            times = []
            for _ in range(BASELINE_REPS):
                outs, s = native_tree(gg, hh, threads)
                times.append(s)
            res[threads] = (outs, float(np.median(times)))
        for outs in (res[threads_all][0], res[1][0]):
            for (ni, n), host in zip(levels, outs):
                if mode == "f32":
                    want = grad.from_fixed(histogram.build_histograms_exact(
                        Xd, gd, hd, ni, n, 255, scales), scales)
                    tol = 1e-5 * histogram.build_histograms_segment(
                        Xd, gd.abs(), hd.abs(), ni, n, 255) + 1e-6
                    err = (torch.from_numpy(host).to(dev) - want).abs()
                    check(bool((err <= tol).all()),
                          f"baseline f32 N={n}: max err {float(err.max())}")
                    max_err = max(max_err, float(err.max()))
                else:
                    want = hist_cuda.build_histograms_cuda(Xd, qg, qh, ni,
                                                           n, 255)
                    check(int(want.abs().max()) < 1 << 24,
                          "baseline int8: every cell below 2^24 (exact f32)")
                    check(torch.equal(torch.from_numpy(host).to(dev)
                                      .to(torch.int32), want),
                          f"baseline int8 N={n}: native != K1, bitwise")
        if mode == "f32":
            k1 = sum(time_ms(lambda ni=ni, n=n: histogram.
                             build_histograms_exact(Xd, gd, hd, ni, n, 255,
                                                    scales), 10)
                     for ni, n in levels)
        else:
            k1 = sum(time_ms(lambda ni=ni, n=n: hist_cuda.
                             build_histograms_cuda(Xd, qg, qh, ni, n, 255),
                             10) for ni, n in levels)
        builds = len(levels)
        k1_mrows = R * builds / (k1 / 1e3) / 1e6
        cpu_all = R * builds / res[threads_all][1] / 1e6
        cpu_one = R * builds / res[1][1] / 1e6
        rows[mode] = {
            "levels": [n for _, n in levels],
            "native_s_per_tree": {str(threads_all): res[threads_all][1],
                                  "1": res[1][1]},
            "native_mrows_per_s": {str(threads_all): cpu_all, "1": cpu_one},
            "k1_ms_per_tree": k1, "k1_mrows_per_s": k1_mrows,
            "ratio_k1_over_native_all_threads": k1_mrows / cpu_all,
            "ratio_k1_over_native_one_thread": k1_mrows / cpu_one}
    # A short fit through the oracle backend, held to the card's trees.
    cfg = TrainConfig(n_trees=BASELINE_FIT_TREES, max_depth=DEPTH,
                      n_bins=255)
    t0 = time.perf_counter()
    cpu_fit = api.train(Xb, y, cfg.replace(backend="cpu"),
                        binned=True).ensemble
    cpu_fit_s = time.perf_counter() - t0
    card_fit = api.train(Xd, y, cfg, binned=True).ensemble
    tie = trees_match_mod_ties(card_fit, cpu_fit, cfg.min_split_gain)
    # The streamed host loop over the oracle: 4 chunks, cache_preds on
    # and off, against the in-memory oracle fit above, and the card's
    # streamed fit against it.
    src = host_chunks(Xb, y, BASELINE_STREAM_CHUNKS)
    scfg = cfg.replace(n_trees=BASELINE_STREAM_TREES, backend="cpu")
    streamed = {}
    for cache in (True, False):
        t0 = time.perf_counter()
        ens = fit_streaming(src, BASELINE_STREAM_CHUNKS, scfg,
                            cache_preds=cache)
        s = time.perf_counter() - t0
        tie = trees_match_mod_ties(cpu_fit, ens, cfg.min_split_gain)
        streamed[f"cache_preds_{str(cache).lower()}"] = {
            "seconds": s, "tie_root_causes_vs_in_memory": tie,
            "bitwise_in_memory": all(
                np.array_equal(getattr(cpu_fit, k), getattr(ens, k))
                for k in TREE_FIELDS)}
        streamed[f"ens_{cache}"] = ens
    same = all(np.array_equal(getattr(streamed["ens_True"], k),
                              getattr(streamed["ens_False"], k))
               for k in TREE_FIELDS)
    check(same, "baseline: streamed cpu cache_preds on == off, bitwise")
    card_streamed = fit_streaming(src, BASELINE_STREAM_CHUNKS,
                                  cfg.replace(n_trees=BASELINE_STREAM_TREES),
                                  device_chunk_cache=False)
    streamed["card_streamed_tie_root_causes_vs_cpu_streamed"] = \
        trees_match_mod_ties(card_streamed, streamed.pop("ens_True"),
                             cfg.min_split_gain)
    del streamed["ens_False"]
    out = {"phase": "baseline", "card": card["smi"],
           "host_cpu": cpu_model(), "host_threads": threads_all,
           "os_cpu_count": os.cpu_count(), "rows": R,
           "features": Xb.shape[1], "bins": 255, "hist_impl": be.hist_impl,
           "modes": rows, "max_abs_err_f32": max_err,
           "cpu_fit": {"trees": BASELINE_FIT_TREES, "seconds": cpu_fit_s,
                       "tie_root_causes_vs_card": tie},
           "cpu_streamed_fit": {"trees": BASELINE_STREAM_TREES,
                                "chunks": BASELINE_STREAM_CHUNKS,
                                **streamed}}
    out["wall_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


MULTIHOST_ROWS = 1_000_000     # config 3: rows a rank, as phase multi
MULTIHOST_TREES = 4


def free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def phase_multihost(card: dict) -> dict:
    """`cli train --multihost-*` over two NCCL processes, one card each
    (module docstring, phase multihost)."""
    n_cards = torch.cuda.device_count()
    check(n_cards >= 2, f"--phase multihost needs >= 2 cards, {n_cards}")
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ddt_multihost_")
    out = {"phase": "multihost", "card": card["smi"], "cards": n_cards,
           "processes": 2, "rows_per_rank": MULTIHOST_ROWS,
           "trees": MULTIHOST_TREES, "cases": {}}
    base = ["train", "--dataset", "criteo", "--cat-splits", "onehot",
            "--rows", str(2 * MULTIHOST_ROWS), "--trees",
            str(MULTIHOST_TREES), "--depth", str(DEPTH), "--bins", "255"]
    for dt in ("int8", "f32"):
        port = free_port()
        outs = [os.path.join(tmp, f"{dt}_{i}.npz") for i in range(2)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "ddt_tpu_torch.cli", *base,
             "--grad-dtype", dt, "--partitions", "2",
             "--multihost-coordinator", f"localhost:{port}",
             "--multihost-processes", "2", "--multihost-id", str(i),
             "--out", outs[i]], cwd=HERE, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for i in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        check(all(p.returncode == 0 for p in procs),
              f"multihost {dt}: children failed:\n"
              + "\n----\n".join(x[-3000:] for x in logs))
        a, b = (TreeEnsemble.load(o) for o in outs)
        same_trees(a, b, f"multihost {dt}: process 0 vs process 1")
        one = os.path.join(tmp, f"{dt}_one.npz")
        (_, one_s), = cli_children({f"one_{dt}": [
            *base, "--grad-dtype", dt, "--out", one]}).values()
        single = TreeEnsemble.load(one)
        row = {"wall_s": wall, "one_process_s": one_s,
               "bitwise_across_processes": True,
               "records": [json.loads(ln) for x in logs
                           for ln in x.splitlines()
                           if ln.startswith('{"cmd"')]}
        if dt == "int8":
            same_trees(a, single, "multihost int8: vs one process")
            row["bitwise_vs_one_process"] = True
        else:
            # The wire sums f32: equal but for proven bf16 ties.
            row["first_divergence_vs_one_process"] = first_divergence(
                a, single)
            row["tie_root_causes_vs_one_process"] = trees_match_mod_ties(
                single, a, TrainConfig().min_split_gain)
        out["cases"][dt] = row
    out["wall_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


def phase_straggler(card: dict) -> dict:
    """The straggler watchdog's rotation on four NCCL ranks (module
    docstring, phase straggler)."""
    n_cards = torch.cuda.device_count()
    check(n_cards >= 2, f"--phase straggler needs >= 2 cards, {n_cards}")
    P = min(4, n_cards)
    t_phase = time.perf_counter()
    X, y, cat = config3_rows(P * STRAGGLER_ROWS)
    base = dict(n_trees=STRAGGLER_TREES, max_depth=DEPTH, n_bins=255,
                cat_features=cat, fused_block_rounds=STRAGGLER_BLOCK)
    out = {"phase": "straggler", "card": card["smi"], "cards": n_cards,
           "ranks": P, "rows_per_rank": STRAGGLER_ROWS, "cases": {}}
    with tempfile.TemporaryDirectory() as d:
        xp, yp = f"{d}/x.npy", f"{d}/y.npy"
        np.save(xp, X)
        np.save(yp, y)
        del X
        with spawn.Pool(P, backend="nccl", device="cuda",
                        timeout_s=900.0) as pool:
            for name, kw in STRAGGLER_CASES:
                if "mesh_shape" in kw and P < 4:
                    continue
                kw = dict(base, **kw)
                off = pool.run(tasks.straggler_timed, xp, yp, kw, None, None)
                on_kw = dict(kw, straggler_repartition=True)
                on = pool.run(tasks.straggler_timed, xp, yp, on_kw, None,
                              None)
                hit = pool.run(tasks.straggler_timed, xp, yp, on_kw,
                               STRAGGLER_PLAN,
                               dict(checkpoint_every=STRAGGLER_EVERY,
                                    checkpoint_dir=f"{d}/ck_{name}"))
                what = f"straggler {name}"
                for r in hit + on:
                    same_trees(r["ensemble"], on[0]["ensemble"],
                               f"{what}: rank {r['rank']} vs undisturbed")
                kinds = hit[0]["faults"]
                n_rot = STRAGGLER_TREES // STRAGGLER_EVERY
                check(kinds.count("repartition") == n_rot
                      and "straggler_detected" in kinds,
                      f"{what}: {n_rot} rotations, {kinds}")
                for r in off + on:
                    c = r["counters"]
                    # The fused loop's warm-up round runs the collectives
                    # too; the granular loop runs a round a tree.
                    rounds = (c["cuda.graph_replays"]
                              + c["cuda.graph_captures"]) or STRAGGLER_TREES
                    check(r["modeled_bytes"] == rounds * r["bytes_model"],
                          f"{what}: modeled bytes {r['modeled_bytes']} vs "
                          f"{rounds} rounds x {r['bytes_model']}")
                k1 = "hist_cuda.launches_" + (
                    "int" if kw.get("grad_dtype") == "int8" else "exact")

                def med(runs, first=0):
                    """Per rank, the median ms of the rounds from
                    `first` on."""
                    return [float(np.median(r["ms"][first:])) for r in runs]

                out["cases"][name] = {
                    # Flag off: the fused loop's second block (the first
                    # holds the warm-up round and the capture).
                    "ms_per_round_flag_off_steady": med(off,
                                                        STRAGGLER_BLOCK),
                    "ms_per_round_flag_off_first_block": med(off)[:1],
                    # Flag on: the granular loop, undisturbed and with the
                    # rotations (the rounds after the first).
                    "ms_per_round_flag_on": med(on, 1),
                    "ms_per_round_rotating": med(hit, 1),
                    "rotation_ms_rank0": hit[0]["rotation_ms"],
                    "rotation_ms_max_over_ranks": [
                        max(v) for v in zip(*[r["rotation_ms"]
                                              for r in hit])],
                    "shards_after": [r["shard"] for r in hit],
                    "bytes_per_round_flag_off": off[0]["bytes_model"],
                    "bytes_per_round_flag_on": on[0]["bytes_model"],
                    "k1_launches": [r["counters"][k1] for r in hit],
                    "bitwise_undisturbed": True}
                emit({"phase": "straggler", "case": name,
                      **out["cases"][name]})
    out["wall_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    if argv not in ([], ["--phase", "multi"], ["--phase", "mesh2d"],
                    ["--phase", "stream"], ["--phase", "config4"],
                    ["--phase", "serve_plane"], ["--phase", "ops"],
                    ["--phase", "robust"], ["--phase", "baseline"],
                    ["--phase", "straggler"], ["--phase", "multihost"]):
        print(f"chip_smoke: unknown arguments {argv}; usage: chip_smoke.py "
              "[--phase multi|mesh2d|stream|config4|serve_plane|ops|"
              "robust|baseline|straggler|multihost]", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = phase_device()
    phase_build()
    if argv:
        flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        if argv[1] == "multi":
            phase_multi(card)
        elif argv[1] == "mesh2d":
            phase_mesh2d(card, flush)
        elif argv[1] == "config4":
            phase_config4(card, flush)
        elif argv[1] == "serve_plane":
            X, y = synthetic_binary(ROWS, n_features=FEATURES, seed=0)
            models = [api.train(X, y, TrainConfig(
                n_trees=N_TREES, max_depth=DEPTH, n_bins=B))
                for B in (255, 15)]
            phase_serve_plane(*models, X, card)
        elif argv[1] == "ops":
            X, y = synthetic_binary(ROWS, n_features=FEATURES, seed=0)
            phase_ops(X, y)
        elif argv[1] in ("robust", "baseline"):
            X, y = synthetic_binary(ROWS, n_features=FEATURES, seed=0)
            Xb = fit_bin_mapper(X, n_bins=255).transform_device(X) \
                .cpu().numpy()
            if argv[1] == "robust":
                phase_robust(X, y, Xb)
            else:
                levels = main_path_levels(torch.from_numpy(Xb).to("cuda"),
                                          y)
                phase_baseline(X, y, Xb, levels, card)
        elif argv[1] == "straggler":
            phase_straggler(card)
        elif argv[1] == "multihost":
            phase_multihost(card)
        else:
            phase_stream(card, flush)
            stream_witness(card)
        emit({"phase": "done", "wall_s": time.perf_counter() - t_start})
        print(card["smi"], flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": card["name"],
                                     "count": torch.cuda.device_count()}})
        return 0
    X, y = synthetic_binary(ROWS, n_features=FEATURES, seed=0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    # Fixtures binned on the card (phase bin holds that bitwise to the
    # host transform).
    binned = {B: fit_bin_mapper(X, n_bins=B).transform_device(X)
              .cpu().numpy() for B, _ in HIST_SHAPES}
    levels = main_path_levels(torch.from_numpy(binned[255]).to("cuda"), y)
    hist = phase_hist(binned, levels, card, flush)
    Xb = binned[255]
    phase_traverse_exact(Xb)
    main_run = phase_main(X, y)
    phase_bin(X, card, flush)
    phase_fused(Xb, y)
    trav = phase_traverse_trained(main_run["res"], X, card, flush)
    phase_parity(X, y)
    phase_lut_exact(X, Xb)
    lut = phase_lut_trained(main_run["res"], X, card, flush)
    res15, _ = phase_lut4_packed(X, y, card, flush)
    served = phase_serve(main_run["res"], res15, X)
    phase_serve_kernels(main_run["res"], X, served, flush)
    plane = phase_serve_plane(main_run["res"], res15, X, card)
    phase_quantize(flush)
    hist_int = phase_hist_int(binned, levels, card, flush)
    phase_quant_exact(binned, y)
    train_q = phase_train_quant(X, y, binned, main_run)
    parity_q = phase_parity_quant(X, y)
    cov = phase_covertype(card, flush)
    phase_covertype_prefix(cov)
    del cov["Xd"], cov["Xvd"]
    missing = phase_missing(card, flush)
    categorical = phase_categorical(card, flush)
    weights = phase_weights(X, y, binned)
    resume = phase_resume()
    phase_covertype_parity()
    multi = phase_multi(card)
    mesh2d = phase_mesh2d(card, flush)
    stream = phase_stream(card, flush)
    life = phase_lifecycle(main_run["res"], X)
    c4 = phase_config4(card, flush)
    ops = phase_ops(X, y)
    robust = phase_robust(X, y, Xb)
    base = phase_baseline(X, y, Xb, levels, card)
    launches = main_run["launches"]
    k2 = hist_int["rows"][("int16", 64, 32)]

    def lut_entry(name, line):
        r = lut[name]
        wide = stream["scoring"][f"{name}_1024"]
        return {"name": name, "route": "cuda",
                "source": "ddt_tpu_torch/csrc/lut.cu",
                "replaces": f"ddt_tpu/ops/predict_lut.py:{line}",
                "launches": served[name], "max_abs_err": r["max_abs_err"],
                "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": None,
                "paths": {"stream_1024_features": {
                    "launches": stream["predict_counters"][name],
                    "ms": wide["kernel_ms"], "plain_ms": wide["plain_ms"],
                    "bound_ms": wide["bound_ms"],
                    "bound_by": wide["bound_by"], "max_abs_err": 0.0},
                    "lifecycle": life["launches"][name],
                    "serve_plane": plane[name],
                    "ops": ops["launches"][name]}}

    k1, k3 = cov["hist"], cov["traverse"]
    cov_launches = cov["row"]["launches"]
    runs = stream["runs"]
    emit({"kernels": [
        # K1 and K3 report the covertype path (depth 8, 54 features, 7
        # classes; K1 a tree in its exact mode, the f32 training mode,
        # with the float-atomic mode it replaced timed on the same inputs
        # as cas_ms; K3 on the trained model); each other path's
        # launches, counted from zero around it, and the Higgs main
        # path's numbers are under "paths".
        {"name": "hist", "route": "cuda",
         "source": "ddt_tpu_torch/csrc/hist.cu",
         "replaces": "ddt_tpu/ops/hist_pallas.py:175",
         "launches": cov_launches["hist"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["kernel_ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": k1["library_ms"], "cas_ms": k1["cas_kernel_ms"],
         "paths": {
             "main_higgs": {
                 "launches": launches["hist"],
                 "max_abs_err": hist["max_abs_err"],
                 "ms": hist["kernel_ms"], "plain_ms": hist["plain_ms"],
                 "bound_ms": hist["bound_ms"], "bound_by": hist["bound_by"],
                 "library_ms": hist["library_ms"],
                 "cas_ms": hist["cas_kernel_ms"]},
             "missing": missing["launches"]["hist"],
             "categorical": categorical["launches"]["hist"],
             "resume": resume["launches"]["hist"],
             "multi": multi_launches(multi, "hist"),
             "mesh2d": mesh_launches(mesh2d, "hist"),
             "mesh2d_k1_1m_x_1024": {
                 k: mesh2d["k1"]["1x1"][k] for k in (
                     "kernel_ms", "cas_kernel_ms", "plain_ms",
                     "library_ms", "bound_ms", "bound_by")},
             "stream": {name: row["counters"]["hist"]
                        for name, row in runs.items()
                        if name.startswith(("f32", "in_memory_f32"))},
             "ops": ops["launches"]["hist"],
             "robust": robust["launches"]["hist"],
             "baseline": {"native_vs_k1_mrows_per_s":
                          base["modes"]["f32"]}}},
        {"name": "traverse", "route": "cuda",
         "source": "ddt_tpu_torch/csrc/lut.cu",
         "replaces": "ddt_tpu/ops/predict_pallas.py:105",
         "launches": cov_launches["traverse"],
         "max_abs_err": k3["max_abs_err"], "ms": k3["kernel_ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": None,
         "paths": {
             "main_higgs": {
                 "launches": launches["traverse"],
                 "max_abs_err": trav["max_abs_err"], "ms": trav["kernel_ms"],
                 "plain_ms": trav["plain_ms"], "bound_ms": trav["bound_ms"],
                 "bound_by": trav["bound_by"]},
             "missing": missing["launches"]["traverse"],
             "categorical": categorical["launches"]["traverse"],
             "weights": weights["launches"]["traverse"],
             "multi": multi_launches(multi, "traverse"),
             "mesh2d": mesh_launches(mesh2d, "traverse"),
             "stream_predict": stream["predict_counters"]["traverse"],
             "lifecycle": life["launches"]["traverse"],
             "serve_plane": plane["traverse"],
             "ops": ops["launches"]["traverse"],
             "config4": {
                 "launches": c4["launches"], "rows": c4["rows"],
                 "trees": c4["trees"], "max_abs_err": c4["max_abs_err"],
                 "ms": c4["kernel_ms"], "bound_ms": c4["bound_ms"],
                 "bound_by": c4["bound_by"],
                 "ms_at_plain_rows": c4["kernel_ms_plain_rows"],
                 "plain_ms": c4["plain_ms_plain_rows"],
                 "plain_rows": c4["plain_rows"]}}},
        lut_entry("lut", 376),
        lut_entry("lut4", 674),
        {"name": "hist_int", "route": "cuda",
         "source": "ddt_tpu_torch/csrc/hist.cu",
         "replaces": "ddt_tpu/ops/hist_pallas.py:175",
         "launches": train_q["launches"]["hist_int"],
         "paths": {"weights": weights["launches"]["hist_int"],
                   "resume": resume["launches"]["hist_int"],
                   "multi": multi_launches(multi, "hist_int"),
                   "mesh2d": mesh_launches(mesh2d, "hist_int"),
                   "stream": {name: row["counters"]["hist_int"]
                              for name, row in runs.items()
                              if "int8" in name},
                   "robust": robust["launches"]["hist_int"]},
         "max_abs_err": hist_int["max_abs_err"],
         "ms": hist_int["int8"]["kernel_ms"],
         "plain_ms": hist_int["int8"]["plain_ms"],
         "bound_ms": hist_int["int8"]["bound_ms"],
         "bound_by": hist_int["int8"]["bound_by"],
         "library_ms": hist_int["int8"]["library_ms"]},
        {"name": "hist_int_t", "route": "cuda",
         "source": "ddt_tpu_torch/csrc/hist.cu",
         "replaces": "ddt_tpu/ops/hist_pallas.py:214",
         "launches": parity_q["launches"]["hist_int"],
         "max_abs_err": hist_int["max_abs_err"], "ms": k2["kernel_ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": k2["library_ms"]},
    ]})
    emit({"phase": "done", "wall_s": time.perf_counter() - t_start})
    print(card["smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card["name"],
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
