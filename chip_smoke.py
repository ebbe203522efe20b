#!/usr/bin/env python3
"""Smoke run of the PyTorch port (det3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:
  1. environment: the card (nvidia-smi name and power limit), torch, CUDA;
     TF32 off for the float32 phases;
  2. build: every CUDA kernel from det3d_tpu_torch/kernels/csrc, in
     parallel, with the compiler's register/shared-memory report;
  3. kernels vs their plain PyTorch versions on the card, at the shapes of
     the 20 cm main path: the BEV scatter bit-equal in f32 and bf16, NMS
     keep masks equal (a real frame's 3 x 1000 candidates, random boxes,
     1 to 8 classes, K from 33 to 1024, a chain of dependent decisions,
     identical boxes, valid flags only in the last chunk); times from CUDA
     events, the NMS mask kernel and sweep also apart;
  4. the main path at full width: configs/ntusl_20cm.json (800x800 grid,
     16k pillars x 15 points, 1.44M anchors, bf16) with seeded random
     weights, ~100k-point frames through the eager `detect` (`eager_detect`:
     pad, `Detector.infer`, annos; `Detector.detect` itself replays
     `infer_jit`, which phase 19 times, so phases 4-18 time the eager path
     as before); every kernel of the path must launch on every
     frame; the host-card synchronisations of each of three `detect`s, by the
     line that made each (and its caller outside torch);
  5. the full path in float32 with the kernels against the same path with
     the plain versions on the card (the RPN's InstanceNorm + ReLU too),
     and a small geometry on the card against the CPU, at the tolerances
     of tests/test_golden_e2e.py;
  6. the train path's kernels vs their plain versions on the card, at the
     20 cm shapes (batch 2): the matcher (a real frame pair, no valid gt,
     every anchor masked, one class's anchors masked, gt outside the range,
     a zero-size gt and two gt that tie everywhere, a matched threshold of
     0: labels, weights, dir and gt-max equal, targets within 1e-6; what its
     cull leaves of the real pair), the scatter backward (bit-equal in f32 and bf16) and the fence
     copy (bit-equal and contiguous on the head's three views, f32, odd
     offsets and sizes, rank 6; the kernel each view took; timed with a warm
     and with a flushed L2 against the contiguous-format `clone`); device
     times from CUDA events, host times per call;
  7. the train step at full width: ntusl_20cm, bf16, batch 2, seeded
     weights, two seeded ~100k-point scenes repeated; ms/step, peak memory,
     launches per step of every train-path kernel, finite losses that fall,
     the host-card synchronisations of one step, a stage breakdown and the
     profiler's device share;
  8. one float32 train step with the kernels against one with the plain
     versions, from the same weights and batch: loss, gradients, updated
     parameters and batch statistics at the CPU tests' tolerances;
  9. the layout path's kernels vs their plain versions at the 20 cm shapes
     (16k pillars x 64 channels; batch 1 and 2): the s2d scatter in H-major
     and W-major order, the blocked-halo s2d scatter (8 blocks, halo (4, 3))
     and both backwards, bit-equal in f32 and bf16, each timed against its
     bytes bound, its plain version and zeros + index_put_ (the dense
     backward: a gather; the blocked one: embedding_bag's sum); the blocked
     backward also beside the kernel it replaced
     (experiments/blocked_bwd_per_piece.cu, old, new, new, old), at the
     20 cm shape and at ntusl_10cm's blocked train shape (8 blocks of 100
     + 7 rows, 20k pillars, batch 2);
 10. packed inference at full width: ntusl_20cm with pack_w, then with
     pack_w + block0_blocked (bf16, 20 frames each): ms/frame, peak memory,
     stage breakdown, launches (the s2d or the blocked scatter once a
     frame, the dense scatter never); in f32, the kernel path against the
     plain path, and packed against dense `cls_preds`;
 11. the packed train step at full width: ntusl_20cm with pack_w and its
     shipped block0_blocked_train + late_blocked_train (bf16, batch 2, 20
     steps: ms/step, peak memory, falling loss, the blocked scatter and its
     backward once a step, breakdown; the piece width its blocked
     backward takes on the step's real cotangent, and that kernel's own
     span in the step's profiler trace beside the kernel it replaced, in
     turns), the packed step without blocking
     (the s2d scatter and its backward once a step), and one f32 packed +
     blocked step with the kernels against one with the plain versions;
 12. the applications at full width: a dataset of 8 train and 8 eval
     ~100k-point scenes written to a temporary directory, `train_app.train`
     (ntusl_20cm, bf16, batch 2, two prefetcher workers, 6 steps, a
     checkpoint every 3, an in-training eval of 4 frames at step 6): ms/step
     beside phase 7's bare step, the wait for batches, the eval's wall time
     and its rotated-IoU share, launches (the app's step and eval are
     captured graphs: each kernel in the warm-up calls and the capture of
     its graph); `latest.pth` restored into a fresh
     trainer bit-equal to the live one, and one more step; then
     `infer_app.infer` of the checkpoint over the 8 eval frames through the
     native reader: ms/frame, the pre / net / post breakdown, the mAP
     strings, launches.
 13. deploy and serve at full width (ntusl_20cm, bf16): `export_detector`
     of `init_weights(0)` (seconds, bytes); the live `Detector.infer`
     outputs of 8 ~100k-point frames saved; a fresh `python` process
     (`chip_smoke.py --deploy-child`) loads the artifact, captures its CUDA
     graph and checks the 8 frames against them (bit-equal, else the
     golden tolerances); the calls per frame of every hand-written kernel
     inside the graph, from the profiler; ms/frame, device ms and busy
     share of the live `detect`, the exported program op by op and its
     graph; host-card syncs per frame; `serve_synthetic` at 10 Hz for 40
     frames, live and exported (p50/p95/max, drops); `serve_replay` of
     phase 12's `.bin` frames at 20 Hz in loop mode; `infer_app.infer`
     at batch 4 against batch 1 (annos in f32, ms/frame in bf16: box for
     box, but for ties that NMS broke the other way between two
     overlapping candidates); `bench_rpn`.
 14. the JAX package's model options at full width (ntusl_20cm, bf16
     unless stated): (a) its default inference network, pack_w +
     fuse_in_stats + split_head, 20 frames beside phase 10's unfused packed
     network (ms/frame, device ms and busy share, peak memory, stage
     breakdown, launches: the s2d scatter once a frame, NMS once, the dense
     scatter never), in f32 the kernel path against the plain path and the
     fused + split predictions against the unfused ones (1e-4), the same
     with block0_blocked, and its export replayed as a CUDA graph in a
     fresh process against the live detector; (b) `head: "multi"`, 8
     frames and 6 train steps at batch 2 (falling finite losses, the train
     kernels once a step), its checkpoint restored bit-equal, one f32 step
     with the kernels against one with the plain versions; (c) the
     device-augmented train step (`Trainer(device_global_augment=True)`):
     10 steps beside phase 7's, host-card syncs per step equal to phase
     7's, `train_app.train(device_augment=True)` over phase 12's dataset
     with two workers (ms/step, the wait for batches) beside phase 12's
     run, and the host chain's ms per sample with and without the global
     transforms; (d) configs/ntusl_10cm.json at full width (1600x1600,
     20k pillars x 10 points, 5.76M anchors): 8 frames of the dense
     network, its kernels against their plain versions and bounds at the
     10 cm shapes, 3 train steps at batch 2; and ntusl_20cm at batch 4, 5
     steps. Every number beside the card's name and power limit.
 15. data parallelism (`parallel/mesh.py`), each group of ranks in
     processes of its own (spawn, a file:// rendezvous in a temporary
     directory, a rank alive after DP_TIMEOUT_S fails the phase, the
     world-1 process after W1_TIMEOUT_S): (a) a world-1 NCCL group on
     cuda:0, cuDNN deterministic: 3 f32 steps of the captured
     `make_sharded_train_step` (one CUDA graph a step, its all-reduces
     inside) against the eager body (`Trainer.train_step(..., mesh=)`) in
     lockstep, bit for bit; then phase 7's step (ntusl_20cm, bf16, batch
     2, the same weights and batch) plain, eager data-parallel and
     captured, each twice in turns, 3 steps each from fresh trainers (the
     plain and the eager data-parallel runs bit for bit; two plain runs
     bit-equal too), then ms/step, device ms, busy share, peak memory, the
     reserve each holds (a graph's pool), host-card syncs, collectives a
     step (the port's count) and NCCL and hand-written kernels a step (the
     profiler), wrapper launches per step; (b) two gloo ranks sharing the
     card (NCCL refuses two ranks on one card; gloo on a card runs the
     eager forms by name: no graph captures it), f32, batch 1 each, 2
     steps against one process at batch 2 at phase 8's tolerances, once
     with the kernels on both ranks and once with rank 1 on the plain
     versions (the two runs must agree too), then a third step of each
     run, of the one process and of the one process with its samples
     swapped, its ratios to those bounds printed and not gated (F1);
     ms/step per rank, launches per rank; (c) `make_sharded_infer`'s eager
     body over 4 frames on those two ranks against `Detector.infer_batch`
     at batch 4 in one process, NMS calls per rank; (d) `train --synthetic`
     (`train_app.train`) on the world-1 NCCL group through the captured
     step, 3 steps and a save, rank 0's checkpoint restored bit-equal; (e)
     the captured `make_sharded_infer` of 4 frames on the world-1 group
     against `Detector.infer_batch` bit for bit, and `infer --batch 4`
     (`infer_app.infer`) on it. Each kernel row of the kernels line gains
     `dp_launches` (launches per path and rank).
 16. the spatial modes (`parallel/spatial.py`, `make_spatial_infer`,
     `make_spatial_train`), each group of ranks in processes of its own as
     in phase 15: (a) a world-1 NCCL group, cuDNN deterministic: in f32,
     8 frames of the eager spatial frame against the plain detector (phase
     5's tolerances, bit-equal frames counted) and the captured
     `make_spatial_infer` against the eager frame bit for bit; 3 steps of
     the eager (1, 1) hybrid step against the plain step (phase 8's) and
     the captured `make_spatial_train` against the eager step in
     lockstep, bit for bit; collectives per frame and per step of each
     form; in bf16 each path timed in turns (plain, eager, captured,
     eager, captured: ms, device ms and busy share, peak, the reserve held,
     launches, syncs, collectives, NCCL and hand-written kernels per call;
     the eager frames' host self time split by the profiler); (b) two gloo
     ranks sharing the card, sp = 2, through the eager forms by name: the
     slab scatter and its backward bit-equal to the full canvas's rows
     (f32, bf16), 4 f32 frames against one process (valid equal, scores
     2e-3, boxes 5e-3 / 1e-2), 3 f32 steps at (1, 2) against one process
     (phase 15(b)'s rule over its 2 steps, gradients by norm; the third
     measured, printed beside 15(b)'s third steps), each rank's peak
     beside the one process's, launches and collectives per rank; (c)
     ntusl_10cm at (1, 2) on the two gloo ranks, bf16, batch 2, 2 steps:
     each rank's peak against the one-process 12 129 428 480 bytes of
     phase 14(d) (PERF.md). Each kernel row gains `spatial_launches`, and
     `sharded_jit_launches_per_call` (kernels per replay of the captured
     data-parallel step, sharded inference, spatial frame and hybrid step,
     from the profiler).
 17. the viewer's device pieces and tune (ntusl_20cm, bf16): (a) the nine
     3D-box and camera functions of ops/geometry.py on the card against
     the CPU on seeded inputs at KITTI's calibration (rtol 1e-5, atol 1e-4,
     1e-3 where a matrix is inverted; the masks equal), the viewer's voxel
     overlay (`SceneViewer.voxel_coors`) of a 100k-point frame equal to
     the CPU's, and, where matplotlib is installed, a BEV and a 3D frame
     rendered (a line says which); (b) the tuner's raw-event device time
     against the parsed trace's on one trace, then `tune` at the JAX
     tuner's defaults (32 frames, 12 steps at batch 2, margin 0.02, device
     time), (i) the config as shipped and (ii) with pack_w on and every
     other lever: each trial's device and host ms, the choices, the
     skipped levers with their reasons, the tuned JSON loaded into a
     `Detector` that detects; (c) every kernel's launches over each run,
     three a trial (each trial's frame or step is captured once: the
     warm-up calls and the capture), the blocked pair non-zero in
     (ii), none zero over both. Each kernel row gains `tune_launches`.
 18. cell-id-ordered voxelization at full width (ntusl_20cm, bf16):
     `Detector(cfg, fcfs=False)` over 8 frames through `detect` (4 of 12k
     points, under the 16k pillar cap, 4 of 100k, over it), the scatter
     and NMS launched once a frame; against `fcfs=True` frame by frame:
     under the cap the same pillar set and detections (golden tolerances;
     bit-equality printed), over it each order's own selection (the first
     16k cells to occur; the 16k lowest cell ids), their overlap printed;
     the voxelize stage's host ms (median of 16 calls each, in turns) and
     device ms (profiler) of both orders. Each kernel row gains
     `cellid_launches`.
 19. the compiled entry points (ntusl_20cm unless stated), each one
     captured CUDA graph over static buffers: (a) `Detector.infer_jit`
     bit-equal to `infer` on 8 frames, kernels per replay (profiler), ms,
     device ms and busy share of `detect` through it against the eager one
     (in turns), syncs, peak, one capture; (b) 10 captured f32 dense steps
     (`Trainer.train_step_jit`, batch 2) bit-equal to 10 eager steps from
     `init_weights(0)`, cuDNN deterministic (losses, counts, parameters,
     running statistics, moments after every step); then bf16 eager and
     captured in turns: ms/step (median of 20 after 3), device ms, busy
     share, syncs, peak allocated and reserved, the first call's seconds,
     kernels per step; (c) the packed + blocked step (`pack_w` with the
     shipped blocked train levers), 5 steps bit-equal, its kernels per
     replay; (d) `Trainer.eval_step_jit` equal to eager `infer` on the
     trainer's model on 4 frames after 3 captured steps, after 10 and after
     a `load_state_dict`; (e) the device-augmented step, 3 steps bit-equal;
     (f) `train_app.train(synthetic=True)`, `infer_app.infer` at batch 1 and
     4 and `serve_synthetic` at 10 Hz through the captured paths; (g)
     ntusl_10cm's captured step, 3 steps: ms, device ms, peak. Each kernel
     row gains `jit_launches_per_call` (kernels per replay of each graph,
     from the profiler; a replay runs no wrapper, so the counters move only
     in the warm-up calls and the capture: phases 12, 13, 14(c) and 17 count
     those for the apps and the tuner, which run the captured paths).
     Each profiler count of inference also counts the RPN's InstanceNorm
     + ReLU op (`in_relu`: statistics, finalize and apply, 19 calls a
     frame, 16 in a packed network with `fuse_in_stats`, none in a train
     step or on the spatial path).
 20. the RPN's InstanceNorm + ReLU kernel (`kernels/norm_cuda.py`) at the
     dense 20 cm network's four map shapes, batch 1 and 4, bf16: its
     statistics against the plain version's (float32 reassociation), its
     apply pass bit-equal to the plain one for equal statistics; ms a call
     (warm and after an L2 flush), its two passes apart, its bound at 6
     bytes an element and its floor (4 bytes an element where the map
     fits the L2 between the passes, else 6), the plain version's and the
     library call's ms
     (`F.instance_norm` + ReLU), each shape and summed over a frame's 19
     pairs; the eager RPN's op calls a frame and its ms with the kernel
     against the plain pair, in turns.
 21. the rotated NMS kernel (`nms_cuda.nms_keep_rotated`, the center
     model's): keep sets equal to the plain version's (`ops/nms.py`
     `greedy_keep_rotated` on the card) at 6 x 1000 and 24 x 1000 boxes
     over several seeds, spread and dense; ms a call, the mask kernel and
     the sweep apart, its bound (the circle reject of every valid pair and
     the clip of every pair whose circles meet, float32) and the plain ms.
 22. the center model (CenterPoint-PP, `benchmark/configs/
     centerpoint_pp_nusc.json`, every published width) through `detect`
     and `infer_batch_jit` at batch 4, captured, on the benchmark family's
     seeded weights and sweeps: ms a frame and a batch, kernels per replay
     by the profiler (all, scatter, `mask_tiles`, `sweep`), peak memory,
     kept boxes and gated candidates a task. At its shapes: the dense
     scatter against its plain version (batch 4, 60 000 pillar slots, 60 000,
     41 000 and 0 valid, 512 x 512, bit-equal in f32 and bf16), the full path
     at batch 4 in float32 with the kernels against the plain scatter and
     rotated NMS (phase 5's tolerances), and each answer of `detect` (2
     frames) and of `infer_batch_jit` (4 frames) under the configuration's
     `center_gap` limit (`benchmark/families/centerpoint.py`).
 23. the voxelizer (`kernels/voxelize_cuda.py`, `csrc/voxelize.cu`) at both
     configurations' shapes (ntusl_20cm: 800 x 800, 16 000 x 15 x 4;
     CenterPoint-PP: 512 x 512, 60 000 x 20 x 5), batch 1 and 4, on the
     benchmark families' clouds: bit-equal to the plain version in both slot
     orders; ms a call against its byte bound (the real points read, the
     buffers written) and the plain version's ms (the library chain it
     replaced); each of its six kernels' launches and ms a call, six
     launches a captured replay (profiler); in the detector's captured frame
     and batch its kernels by name and no `scan_innermost_dim_with_indices`;
     in the PointPillars frame's replay, the kernels between `vox_fill` and
     the network (the anchor mask, the stage between the marks `voxelize`
     and `preprocess`) by name and device ms, and that stretch's span.
`chip_smoke.py --center` runs phases 21-22 alone (~2 min),
`chip_smoke.py --voxelize` phase 23.
The last lines are the kernels table and phase 20's table (JSON), the
card's name and power limit, and {"ok": true, "device": {...}}. Needs one CUDA card; imports
nothing of the JAX package. `chip_smoke.py --deploy-child ARTIFACT FRAMES
OUT` is phase 13's fresh process, not a run of its own;
`chip_smoke.py --detect-syncs TREE` prints the host-card synchronisations
and ms/frame of `detect` with the port of the checkout at TREE (to compare
two commits in one call, in turns).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import importlib.util
import itertools
import json
import multiprocessing
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
N_FRAMES = 20
N_POINTS = 100_000
HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate (NVIDIA data sheet)
SPIN_CYCLES = 40_000_000    # ~20 ms of a spin kernel at the H100's ~1.98 GHz boost clock
F32_OPS_PER_S = 67e12       # H100 SXM float32 rate outside the tensor cores
# operations per box pair in the NMS suppression test: iw and ih (min, max,
# sub, add, max each), inter, union (add, sub), the division, the compare;
# the per-box areas are counted once per box, not per pair
NMS_OPS_PER_PAIR = 15
# operations per overlapping (included anchor, valid gt of its class) pair
# in the matcher: the IoU (iw, ih: min, max, sub each; two compares and a
# multiply for inter; two areas of sub, sub, mul; union add, sub; compare,
# divide) is 19; pass 1 adds the max, pass 2 the argmax compare and select
# and the force-match compare, compare and or. A pair that the kernels visit
# and find disjoint costs the interval tests only (min, max, sub, compare,
# twice)
MATCH_OPS_PASS1 = 20
MATCH_OPS_PASS2 = 24
MATCH_OPS_DISJOINT = 8
# the matcher kernels that looped over every gt of the class for every
# anchor, before the cull by anchor-chunk boxes, at the same batch on an H100
# at 700 W (PERF.md, kernel table)
MATCHER_GT_MAX_PREV_MS = 0.1116
MATCHER_ASSIGN_PREV_MS = 0.1160
# the one-block-per-class NMS kernel that the mask + sweep design replaced, at
# the 3 x 1000 real-frame shape on an H100 at 700 W (PERF.md, kernel table)
NMS_PREV_MS = 0.3533
# the element-per-thread fence kernel on the `cls_preds` view, before the
# transpose kernel took that view (PERF.md, kernel table)
FENCE_PREV_MS = 0.0209
L2_FLUSH_BYTES = 128 * 2**20  # more than twice the H100's 50 MB L2
TRAIN_BATCH = 2
TRAIN_WARMUP = 3
TRAIN_STEPS = 20
TRAIN_POINTS = 97_000  # ground points of each scene; ~100k with the objects
LAYOUT_TRAIN_STEPS = 10  # steps of the packed train step without blocking
# packed (and blocked) against dense cls_preds in f32 with TF32 off: the
# same function with other convolutions summing in other orders through
# 20 layers, each renormalised by an InstanceNorm; a fraction of the
# largest |cls_preds| (at least 1)
PACKED_VS_DENSE_TOL = 1e-3
APP_FRAMES = 8      # scenes of each split that phase 12 writes
APP_STEPS = 6       # train_app steps: a checkpoint every 3, an eval at 6
APP_EVAL_FRAMES = 4
APP_WORKERS = 2
DEPLOY_FRAMES = 8    # frames the exported graph is held against the live detector on
SERVE_FRAMES = 40    # frames of each serve_synthetic run, at SERVE_HZ
SERVE_HZ = 10.0
REPLAY_FRAMES = 16   # serve_replay of phase 12's 8 eval .bin frames, looped, at REPLAY_HZ
REPLAY_HZ = 20.0
INFER_BATCH = 4
RPN_ITERS = 20
OPTION_FRAMES = 20   # phase 14(a): frames of the JAX default inference network
BLOCKED_FRAMES = 8   # ... and of its block0_blocked variant
MULTI_FRAMES = 8     # phase 14(b): head "multi", inference frames and train steps
MULTI_STEPS = 6
AUG_STEPS = 10       # phase 14(c): device-augmented train steps
R1_FRAMES = 8        # phase 14(d): ntusl_10cm inference frames, train steps at batch 2
R1_STEPS = 3
BATCH4 = 4           # ... and ntusl_20cm train steps at batch 4
BATCH4_STEPS = 5
FUSED_VS_UNFUSED_TOL = 1e-4  # tests/test_torch_model.py's rtol/atol for the network's outputs
DENSE_JIT_STEPS = 10   # phase 19(b): captured f32 steps held bit for bit against eager ones
BLOCKED_JIT_STEPS = 5  # phase 19(c): the same for the packed + blocked step
AUG_JIT_STEPS = 3      # phase 19(e): the same for the device-augmented step
CAPTURE_LAUNCHES = 3  # a captured call's wrapper launches: utils/graphs.WARMUP_CALLS warm-up calls + the capture
DP_STEPS = 3          # phase 15(a): steps of the world-1 NCCL step held bit for bit against the plain step
DP_TIMED_STEPS = 20   # ... then timed, each path, in turns (plain, data-parallel, plain)
DP_GLOO_STEPS = 2     # phase 15(b): f32 steps of two gloo ranks (batch 1 each) against one process at batch 2
F1_STEP = DP_GLOO_STEPS + 1  # ... and one more, measured against phase 15(b)'s bounds and not gated, as 16(b)'s third
DP_INFER_FRAMES = 4   # phase 15(c): frames of the sharded infer_batch
DP_APP_STEPS = 3      # phase 15(d): train_app steps at world 1, one save
DP_TIMEOUT_S = 120.0  # a rank still alive after this fails the phase
W1_TIMEOUT_S = 300.0  # ... for phase 15's world-1 process, which also runs the captured paths
SP_FRAMES_W1 = 8      # phase 16(a): frames of make_spatial_infer on a world-1 NCCL group
SP_STEPS = 3          # phase 16(a) and (b): hybrid steps at batch 2
SP_FRAMES_GLOO = 4    # phase 16(b): frames of make_spatial_infer over two gloo ranks
SP10_STEPS = 2        # phase 16(c): ntusl_10cm hybrid steps at (1, 2), after one warm-up step
SP_TIMEOUT_S = 300.0  # a rank of phase 16 still alive after this fails the phase
CELLID_FRAMES = 8             # phase 18: frames of Detector(fcfs=False), half under the pillar cap, half over
CELLID_UNDER_POINTS = 12_000  # ~11k pillars at 20 cm, under its 16 000
# phase 17: tune at the JAX tuner's defaults, (i) the config as shipped, (ii) pack_w on with every other lever
TUNE_ARGS = dict(mode="both", infer_iters=32, train_iters=12, batch_size=2, margin=0.02)
# KITTI frame 000000's calibration (R0_rect, Tr_velo_to_cam, P2), for phase 17(a)
KITTI_R0_RECT = np.eye(4)
KITTI_R0_RECT[:3, :3] = [[9.999239e-01, 9.837760e-03, -7.445048e-03], [-9.869795e-03, 9.999421e-01, -4.278459e-03],
                         [7.402527e-03, 4.351614e-03, 9.999631e-01]]
KITTI_VELO2CAM = np.array([[7.533745e-03, -9.999714e-01, -6.166020e-04, -4.069766e-03],
                           [1.480249e-02, 7.280733e-04, -9.998902e-01, -7.631618e-02],
                           [9.998621e-01, 7.523790e-03, 1.480755e-02, -2.717806e-01], [0.0, 0.0, 0.0, 1.0]])
KITTI_P2 = np.array([[7.215377e+02, 0.0, 6.095593e+02, 4.485728e+01], [0.0, 7.215377e+02, 1.728540e+02, 2.163791e-01],
                     [0.0, 0.0, 1.0, 2.745884e-03], [0.0, 0.0, 0.0, 1.0]])
# the one-process peak of the ntusl_10cm train step at batch 2, bf16, on an
# H100 at 700 W (PERF.md, phase 14(d))
ONE_PROCESS_PEAK_10CM = 12_129_428_480
# every hand-written kernel by the name the profiler gives it, under its row
# of the kernels line. A scatter's or a gather's canvas layout is its
# template argument (csrc/scatter.cu: 0 dense, 1 and 2 the s2d orders), so
# the dense and the s2d scatter have names of their own. One call of
# nms_keep launches both its kernels, one of the fence one of its three:
# each row counts calls, as the wrappers' counters do
PROFILER_KERNELS = {
    "scatter_to_bev": (r"\bscatter_rows<[^<>,]+, (?:\(int\))?0>",),
    "scatter_to_bev_s2d": (r"\bscatter_rows<[^<>,]+, (?:\(int\))?[12]>",),
    "scatter_to_bev_s2d_blocked": (r"\bscatter_rows_blocked<",),
    "scatter_to_bev_bwd": (r"\bgather_rows<[^<>,]+, (?:\(int\))?0>",),
    "scatter_to_bev_s2d_bwd": (r"\bgather_rows<[^<>,]+, (?:\(int\))?1>",),
    "scatter_to_bev_s2d_blocked_bwd": (r"\bgather_rows_blocked<",),
    "nms_keep": (r"\bmask_tiles\(", r"\bsweep\("),
    "matcher_gt_max": (r"\bgt_max_kernel<",),
    "matcher_assign": (r"\bassign_kernel<",),
    "fence_copy": (r"\bcopy_(?:contiguous|transpose|strided)<",),
    "in_relu": (r"\bin_stats<", r"\bin_finalize\(", r"\bin_apply<"),
}
# the dense RPN's InstanceNorm + ReLU pairs, (C, H, W) at 20 cm and how many
# a frame runs at that shape: block1's 4 and deconv1's, block2's 6, block3's
# 6, deconv2's and deconv3's (138.24 M elements a frame)
IN_RELU_SHAPES = {(64, 400, 400): 5, (128, 200, 200): 6, (256, 100, 100): 6, (128, 400, 400): 2}
IN_RELU_PAIRS = sum(IN_RELU_SHAPES.values())
IN_RELU_BYTES = 6  # bf16: one read for the sums, one read and one write to normalise and rectify
IN_RELU_BYTES_IN_L2 = 4  # bf16, a map that stays in the L2 between the passes: one read and one write
IN_RELU_FRAME_MS = 0.6  # the 19 pairs of a batch-1 frame at most, together (kernel time)


def in_relu_pairs(cfg) -> int:
    """IN + ReLU ops of an inference frame: the RPN's 19 pairs, less the
    three upsample branches that a packed network with `fuse_in_stats`
    normalises from Gram statistics."""
    return IN_RELU_PAIRS - 3 * int(cfg.pack_w and cfg.fuse_in_stats)


# calls per frame of the inference path: one scatter, one NMS and the RPN's 19 IN + ReLU pairs
INFER_CALLS = {k: {"scatter_to_bev": 1, "nms_keep": 1, "in_relu": IN_RELU_PAIRS}.get(k, 0) for k in PROFILER_KERNELS}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


_PHASE = {"name": None, "t0": 0.0, "card": "card not read yet"}  # the phase that runs, for its wall seconds


def phase(name: str | None) -> None:
    """End the running phase with its wall seconds and start `name` (None:
    no other)."""
    if _PHASE["name"] is not None:
        print(f"[{_PHASE['card']}] phase {_PHASE['name'].split('.')[0]} took {time.time() - _PHASE['t0']:.1f} s",
              flush=True)
    _PHASE.update(name=name, t0=time.time())
    if name is not None:
        print(f"\n=== {name} ===", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around `iters` calls.
    A spin kernel queued first keeps the card busy while the host queues
    the calls, so a wrapper's Python time does not show as device time
    (unless the host needs longer than the spin, ~20 ms)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def single_call_ms(fn, flush: torch.Tensor | None = None, reps: int = 10) -> float:
    """Median device time of single calls, CUDA events around each. With
    `flush`, a buffer larger than the L2, every call comes after a `zero_()`
    of it, so the call finds its input in device memory, not in the cache.
    A short spin kernel goes first, so the host has queued the call before
    the card reaches it; the events' own cost (a few microseconds) is part
    of every reading."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES // 40)  # ~0.5 ms
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, iters: int = 30) -> float:
    """Mean host time of one call (the wrapper's Python and the launch),
    with the card kept busy so that no call waits on it."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def eager_detect(det):
    """`Detector.detect` as phases 4-18 time it: pad, the eager
    `Detector.infer`, annos. `Detector.detect` itself goes through the
    captured `infer_jit`, which phase 19 times; these phases keep their
    history."""
    from det3d_tpu_torch.postprocess import to_annos

    def detect(points: np.ndarray) -> dict:
        padded, n = det.pad_points(points)
        return to_annos(det.cfg, det.infer(torch.from_numpy(padded).to(det.device), int(n)))

    return detect


def eager_serve_infer(det):
    """A `PointCloudServer`'s `infer_fn` on the eager `Detector.infer` (the
    live server's default is `infer_jit`, which phase 19 serves)."""
    return lambda points, n: det.infer(torch.from_numpy(points).to(det.device), int(n))


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def scatter_inputs(v: int, c: int, grid_xy, n_valid: int, dtype, gen: torch.Generator, batch: int = 1):
    nx, ny = grid_xy
    feats = torch.randn((batch, v, c), generator=gen).to(dtype)
    coors = torch.full((batch, v, 3), -1, dtype=torch.int32)
    for b in range(batch):
        cells = torch.randperm(nx * ny, generator=gen)[:n_valid]
        coors[b, :n_valid, 0] = (cells // ny).to(torch.int32)
        coors[b, :n_valid, 1] = (cells % ny).to(torch.int32)
        coors[b, :n_valid, 2] = 0
    return feats.cuda(), coors.cuda()


def check_scatter(grid_xy, v: int, c: int, batch: int = 1, counts=(12_000, 0)) -> dict:
    """The dense scatter against its plain version at `batch` frames of `v`
    pillar slots, `counts` of them valid (each bit-equal, f32 and bf16),
    and timed at the first count."""
    from det3d_tpu_torch.kernels import scatter_cuda as sc

    gen = torch.Generator().manual_seed(SEED)
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        for n_valid in counts:
            feats, coors = scatter_inputs(v, c, grid_xy, n_valid, dtype, gen, batch)
            got = sc.scatter_to_bev_cuda(feats, coors, grid_xy)
            want = sc.scatter_to_bev_plain(feats, coors, grid_xy)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            equal = torch.equal(bits(got), bits(want))
            print(f"scatter {str(dtype):15s} batch={batch} valid={n_valid:5d}: bit-equal={equal} max_abs_err={err}")
            check(equal, f"scatter {dtype} at batch {batch} with {n_valid} pillars differs from the plain version")
            result["max_abs_err"] = max(result.get("max_abs_err", 0.0), err)
        # times at the first count
        feats, coors = scatter_inputs(v, c, grid_xy, counts[0], dtype, gen, batch)
        frame, slot = (coors[..., 0] >= 0).nonzero(as_tuple=True)
        idx = (frame, coors[frame, slot, 0].long(), coors[frame, slot, 1].long())
        rows = feats[frame, slot]
        nx, ny = grid_xy
        ms = cuda_ms(lambda: sc.scatter_to_bev_cuda(feats, coors, grid_xy))
        plain_ms = cuda_ms(lambda: sc.scatter_to_bev_plain(feats, coors, grid_xy))
        library_ms = cuda_ms(lambda: torch.zeros((batch, nx, ny, c), dtype=dtype, device="cuda").index_put_(idx, rows))
        moved = batch * (nx * ny * c + v * c) * feats.element_size() + coors.numel() * 4
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        print(f"scatter {str(dtype):15s} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} bound_ms={bound_ms:.4f} (bytes)")
        result[dtype] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms)
    return result


def random_boxes(ncls: int, k: int, gen: torch.Generator) -> torch.Tensor:
    centers = torch.rand((ncls, k, 2), generator=gen) * 80 - 40
    dims = torch.rand((ncls, k, 2), generator=gen) * 7 + 1
    return torch.cat([centers - dims / 2, centers + dims / 2], dim=-1).cuda()


def nms_cases(candidates, gen: torch.Generator):
    """(name, boxes (ncls, K, 4), valid (ncls, K)) cases on the card: the
    first three at the main path's 3 x 1000, then the shapes and data that
    stress the chunked sweep."""
    k = max(c.valid.shape[0] for c in candidates)
    ncls = len(candidates)
    real = torch.zeros((ncls, k, 4), device="cuda")
    for ci, c in enumerate(candidates):
        real[ci, : c.standup.shape[0]] = c.standup
    # ~20% invalid, as the score gate leaves a real frame's tail
    some_invalid = torch.rand((ncls, k), generator=gen) >= 0.2
    ones = lambda *shape: torch.ones(shape, dtype=torch.bool, device="cuda")
    # each box over the threshold only with its neighbours: kept and
    # suppressed alternate along 1000 dependent decisions
    x = torch.arange(1000, dtype=torch.float32, device="cuda") * 5
    chain = torch.stack([x, torch.zeros_like(x), x + 9, torch.full_like(x, 9.0)], dim=-1)[None]
    identical = torch.tensor([1.0, 2.0, 6.0, 5.0], device="cuda").expand(1, 1000, 4).contiguous()
    last_chunk = (torch.arange(k, device="cuda") >= (k - 1) // 32 * 32).expand(ncls, k).contiguous()
    return [
        ("random boxes", random_boxes(3, 1000, gen), ones(3, 1000)),
        ("real frame, 20% invalid", real.contiguous(), some_invalid.cuda()),
        ("real frame, all invalid", real.contiguous(), ~ones(ncls, k)),
        ("real frame, last chunk valid", real.contiguous(), last_chunk),
        ("chain of 1000", chain.contiguous(), ones(1, 1000)),
        ("1000 identical boxes", identical, ones(1, 1000)),
        ("random 1 x 33", random_boxes(1, 33, gen), ones(1, 33)),
        ("random 2 x 77", random_boxes(2, 77, gen), torch.rand((2, 77), generator=gen).cuda() >= 0.2),
        ("random 8 x 1024", random_boxes(8, 1024, gen), torch.rand((8, 1024), generator=gen).cuda() >= 0.2),
    ]


def check_nms(candidates, iou_threshold: float) -> dict:
    from det3d_tpu_torch.kernels import nms_cuda as nc

    gen = torch.Generator().manual_seed(SEED + 1)
    cases = nms_cases(candidates, gen)
    for name, boxes, valid in cases:
        got = nc.nms_keep_cuda(boxes, valid, iou_threshold)
        want = nc.nms_keep_plain(boxes, valid, iou_threshold)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        print(f"nms {name:28s} {tuple(valid.shape)}: keep equal={equal} kept={int(got.sum())} "
              f"of {int(valid.sum())} valid")
        check(equal, f"nms keep mask differs from the plain version on '{name}'")
    check(int(nc.nms_keep_cuda(*cases[4][1:], iou_threshold).sum()) == 500, "the chain keeps every other box")
    check(int(nc.nms_keep_cuda(*cases[5][1:], iou_threshold).sum()) == 1, "identical boxes keep the first")
    _, boxes, valid = cases[1]
    ms = cuda_ms(lambda: nc.nms_keep_cuda(boxes, valid, iou_threshold))
    # the two launches apart, over one scratch mask (the sweep reads what the mask kernel left there)
    mask = nc.mask_scratch(boxes)
    mask_ms = cuda_ms(lambda: nc.launch(boxes, valid, iou_threshold, mask, parts=1))
    sweep_ms = cuda_ms(lambda: nc.launch(boxes, valid, iou_threshold, mask, parts=2))
    plain_ms = cuda_ms(lambda: nc.nms_keep_plain(boxes, valid, iou_threshold), iters=5, warmup=1)
    nv = valid.sum(dim=1).double()
    ops = float((nv * (nv - 1) / 2).sum()) * NMS_OPS_PER_PAIR
    moved = boxes.numel() * 4 + 2 * valid.numel()
    bound_ms = max(moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    bound_by = "bytes" if moved / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations"
    print(f"nms (3 x {boxes.shape[1]}, one call, two launches) kernel_ms={ms:.4f} (mask kernel alone {mask_ms:.4f}, "
          f"sweep alone {sweep_ms:.4f}; prev_ms={NMS_PREV_MS}, the one-block-per-class kernel it replaced) "
          f"plain_ms={plain_ms:.4f} library_ms=none bound_ms={bound_ms:.6f} ({bound_by}); "
          f"host ms per call {host_ms(lambda: nc.nms_keep_cuda(boxes, valid, iou_threshold)):.4f}")
    for name, b, v in (cases[4], cases[8]):
        print(f"nms {name}: kernel_ms={cuda_ms(lambda: nc.nms_keep_cuda(b, v, iou_threshold)):.4f}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=0.0)


def assert_detections_close(a, b, what: str) -> None:
    """tests/test_golden_e2e.py tolerances: valid equal, boxes 1e-4, scores 1e-5."""
    va, vb = a.valid.cpu(), b.valid.cpu()
    check(torch.equal(va, vb), f"{what}: valid sets differ ({int(va.sum())} vs {int(vb.sum())})")
    torch.testing.assert_close(a.boxes.cpu()[va], b.boxes.cpu()[va], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(a.scores.cpu()[va], b.scores.cpu()[va], rtol=1e-5, atol=1e-5)
    print(f"{what}: valid equal ({int(va.sum())} detections), boxes and scores within tolerance")


@torch.no_grad()
def stage_breakdown(det, frames) -> dict[str, float]:
    """Median ms of each stage of `Detector.detect` over `frames`, host clock
    with a synchronize after every stage (so the stages do not overlap)."""
    from det3d_tpu_torch.postprocess import frame_preds

    model, post = det.model, det.postprocess
    spans: dict[str, list[float]] = {}
    for pts_np in frames:
        marks = [("start", time.perf_counter())]

        def mark(name):
            torch.cuda.synchronize()
            marks.append((name, time.perf_counter()))

        padded, n = det.pad_points(pts_np)
        pts = torch.from_numpy(padded).cuda()
        mark("pad + copy to card")
        frame, anchors_mask = det.preprocess(pts, int(n))
        mark("voxelize + anchor mask")
        feats = model.pillar_point_net(frame.voxels[None], frame.num_points_per_voxel[None], frame.coors[None])
        mark("PFN")
        layout = model.layout(1, False)
        canvas = model.canvas(feats, frame.coors[None], layout)
        mark("BEV scatter (kernel)")
        x = model.rpn(canvas, *layout, *model.neck(False))
        mark("RPN")
        preds = model.heads(x)
        mark("head")
        cands = post.decode_stage(frame_preds(preds, 0), anchors_mask)
        mark("decode (gate, top-k, decode)")
        post.finalize_stage(cands)
        mark("finalize (NMS kernel, compaction)")
        for (_, t0), (name, t1) in zip(marks, marks[1:]):
            spans.setdefault(name, []).append((t1 - t0) * 1e3)
    return {name: statistics.median(v) for name, v in spans.items()}


def device_time(det, frames) -> tuple[float, list[tuple[str, float]]] | None:
    """Device time per eager `detect` frame (`eager_detect`) from a
    torch.profiler trace (sum of the card's kernel, memset and memcpy
    spans), and the top device ops by time per frame; None when the trace
    holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    detect = eager_detect(det)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for pts_np in frames:
            detect(pts_np)
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / len(frames)
    if not by_name:
        return None
    return sum(by_name.values()), sorted(by_name.items(), key=lambda kv: -kv[1])[:12]


def train_scenes(cfg, seed: int, n: int = TRAIN_BATCH):
    """`n` seeded ~100k-point scenes with 20-40 gt boxes each."""
    from det3d_tpu_torch.data.synthetic import sample_scene

    rng = np.random.RandomState(seed)
    return [sample_scene(cfg, rng, (20, 40), ground_points=TRAIN_POINTS) for _ in range(n)]


MATCHER_CASES = ("real frames", "no valid gt", "every anchor masked", "a class's anchors masked",
                 "gt outside the range", "zero-size gt, one standup box twice", "matched threshold 0")


def matcher_inputs(trainer, batch, case: str):
    """(mask (B, A), gt_boxes, gt_bv, gt_classes, gt_valid) on the card."""
    from det3d_tpu_torch.targets import gt_standup

    masks = [trainer.detector.preprocess(batch.points[i], batch.num_points[i])[1] for i in range(TRAIN_BATCH)]
    mask = torch.stack(masks).reshape(TRAIN_BATCH, -1)
    gt_boxes, gt_classes, gt_valid = batch.gt_boxes.clone(), batch.gt_classes.clone(), batch.gt_valid
    if case == "no valid gt":
        gt_valid = torch.zeros_like(gt_valid)
    elif case == "every anchor masked":
        mask = torch.zeros_like(mask)
    elif case == "a class's anchors masked":  # its valid gt end at -1, the others' at >= 0
        start = trainer.assigner.tables.class_start.tolist()
        mask[:, start[1] : start[2]] = False
    elif case == "gt outside the range":
        gt_boxes[..., :2] += 500.0
    elif case == "zero-size gt, one standup box twice":
        gt_boxes[:, 1, 3:5] = 0.0
        # row 3 ties with row 2 on every anchor and differs in z and height:
        # the first of the two must be the one matched
        gt_boxes[:, 3] = gt_boxes[:, 2]
        gt_boxes[:, 3, 2] += 1.0
        gt_boxes[:, 3, 5] *= 1.2
        gt_classes[:, 3] = gt_classes[:, 2]
    return mask, gt_boxes, gt_standup(gt_boxes), gt_classes, gt_valid


def matcher_cull_stats(tables, mask, gt_bv, gt_classes, gt_valid) -> dict:
    """What the matcher's cull leaves of this input, counted with tensor
    operations: per (sample, anchor chunk) the candidate gt (valid, of the
    chunk's classes, box not disjoint from the chunk's box), the pairs of an
    included anchor and a candidate of its class that the kernels visit, and
    those of them that overlap."""
    from det3d_tpu_torch.kernels import matcher_cuda as mc

    a, dev = mask.shape[1], mask.device
    nchunks = tables.chunk_bv.shape[0]
    bounds = tables.class_start.long()[1:-1].contiguous()
    first = torch.arange(nchunks, device=dev) * mc.CHUNK
    c_lo = torch.bucketize(first, bounds, right=True)
    c_hi = torch.bucketize((first + mc.CHUNK).clamp(max=a) - 1, bounds, right=True)
    cls = torch.where(gt_valid, gt_classes.long() - 1, -1)              # (B, G)
    cb, gb = tables.chunk_bv[None, :, None, :], gt_bv[:, None, :, :]    # (1, C, 1, 4), (B, 1, G, 4)
    cand = ((cls[:, None, :] >= c_lo[None, :, None]) & (cls[:, None, :] <= c_hi[None, :, None])
            & ~(gb[..., 2] <= cb[..., 0]) & ~(cb[..., 2] <= gb[..., 0])
            & ~(gb[..., 3] <= cb[..., 1]) & ~(cb[..., 3] <= gb[..., 1]))  # (B, C, G)
    per_chunk = cand.sum(-1)
    b_i, ch_i, g_i = cand.nonzero(as_tuple=True)
    idx = ch_i[:, None] * mc.CHUNK + torch.arange(mc.CHUNK, device=dev)
    exists = idx < a
    idx = idx.clamp(max=a - 1)
    active = exists & mask[b_i[:, None], idx] & (torch.bucketize(idx, bounds, right=True) == cls[b_i, g_i][:, None])
    q, g4 = tables.anchors_bv[idx], gt_bv[b_i, g_i][:, None, :]
    iw = torch.minimum(g4[..., 2], q[..., 2]) - torch.maximum(g4[..., 0], q[..., 0])
    ih = torch.minimum(g4[..., 3], q[..., 3]) - torch.maximum(g4[..., 1], q[..., 1])
    return dict(
        chunks=per_chunk.numel(), none=int((per_chunk == 0).sum()), one=int((per_chunk == 1).sum()),
        more=int((per_chunk > 1).sum()), most=int(per_chunk.max()), candidates=int(cand.sum()),
        reached_chunks=int((per_chunk.sum(0) > 0).sum()),  # chunks whose anchors_bv some sample needs
        visited=int(active.sum()), overlapping=int((active & (iw > 0) & (ih > 0)).sum()),
    )


def check_matcher(trainer, batch) -> dict:
    """Both matcher kernels against the plain dense assignment on the card."""
    import dataclasses

    from det3d_tpu_torch.kernels import matcher_cuda as mc
    from det3d_tpu_torch.targets import make_target_assigner

    fx, fy = trainer.assigner.grid_hw
    zero_thr = tuple(dataclasses.replace(s, matched_threshold=0.0, unmatched_threshold=0.0)
                     for s in trainer.cfg.class_specs)
    result = {"max_abs_err": 0.0, "gt_max_err": 0.0}
    for case in MATCHER_CASES:
        assigner = trainer.assigner
        if case == "matched threshold 0":  # an included anchor is positive on a row of zeros
            assigner = make_target_assigner(trainer.cfg.replace(class_specs=zero_thr), trainer.detector.anchor_set,
                                            "cuda")
        tables = assigner.tables
        mask, gt_boxes, gt_bv, gt_classes, gt_valid = matcher_inputs(trainer, batch, case)
        spatial = mask.reshape(TRAIN_BATCH, -1, fx, fy)
        got_max = mc.decode_gt_max(mc.gt_max_bits_cuda(tables, mask, gt_boxes, gt_bv, gt_classes, gt_valid))
        want_max = assigner.gt_max_plain(gt_boxes, gt_classes, gt_valid, spatial)
        got = assigner.kernel(gt_boxes, gt_classes, gt_valid, spatial)
        want = assigner.plain(gt_boxes, gt_classes, gt_valid, spatial)
        torch.cuda.synchronize()
        check(torch.equal(got_max, want_max), f"matcher gt-max differs from the plain version on '{case}'")
        for name in ("labels", "bbox_outside_weights", "dir_targets"):
            check(torch.equal(getattr(got, name), getattr(want, name)), f"matcher {name} differ on '{case}'")
        err = (got.bbox_targets - want.bbox_targets).abs().max().item()
        torch.testing.assert_close(got.bbox_targets, want.bbox_targets, rtol=1e-6, atol=1e-6)
        labels = got.labels
        print(f"matcher {case:36s}: labels/weights/dir equal, gt-max equal (valid gt at -1: "
              f"{int((got_max[gt_valid] < 0).sum())}, at 0: {int((got_max[gt_valid] == 0).sum())}), "
              f"targets max_abs_err={err:.3e}; positives {int((labels > 0).sum())}, "
              f"negatives {int((labels == 0).sum())}, ignored {int((labels < 0).sum())}")
        result["max_abs_err"] = max(result["max_abs_err"], err)

    assigner = trainer.assigner
    tables = assigner.tables
    mask, gt_boxes, gt_bv, gt_classes, gt_valid = matcher_inputs(trainer, batch, "real frames")
    spatial = mask.reshape(TRAIN_BATCH, -1, fx, fy)
    args = (tables, mask, gt_boxes, gt_bv, gt_classes, gt_valid)
    bits = mc.gt_max_bits_cuda(*args)
    result["gt_max_ms"] = cuda_ms(lambda: mc.gt_max_bits_cuda(*args))
    result["assign_ms"] = cuda_ms(lambda: mc.assign_cuda(*args, bits))
    print(f"matcher, one call of both passes (match_cuda): {cuda_ms(lambda: mc.match_cuda(*args)):.4f} ms")
    print(f"matcher host ms per call (wrapper + launch): gt-max {host_ms(lambda: mc.gt_max_bits_cuda(*args)):.4f}, "
          f"assign {host_ms(lambda: mc.assign_cuda(*args, bits)):.4f}, "
          f"TargetAssigner.kernel {host_ms(lambda: assigner.kernel(gt_boxes, gt_classes, gt_valid, spatial)):.4f}")
    plain = (gt_boxes, gt_classes, gt_valid, spatial)
    result["gt_max_plain_ms"] = cuda_ms(lambda: assigner.gt_max_plain(*plain), iters=5, warmup=1)
    result["assign_plain_ms"] = cuda_ms(lambda: assigner.plain(*plain), iters=5, warmup=1)

    # bounds from this run's inputs: every byte the function needs read
    # once, every output written once; operations over the pairs this data
    # needs. The function needs the mask, the gt, the anchors' yaw plane
    # (dir) and every output; it needs an anchor's standup box only where a
    # gt reaches its chunk, and its other six planes only where it is positive.
    a = tables.anchors.shape[0]
    g = gt_valid.shape[1]
    hw = fx * fy
    pairs = 0
    for b in range(TRAIN_BATCH):
        for ci, (c0, c1) in enumerate(assigner.channels):
            included = int(mask[b, c0 * hw : c1 * hw].sum())
            valid = int((gt_valid[b] & (gt_classes[b] == ci + 1)).sum())
            pairs += included * valid
    stats = matcher_cull_stats(tables, mask, gt_bv, gt_classes, gt_valid)
    positives = int((assigner.kernel(*plain).labels > 0).sum())
    print(f"matcher cull on the real frames: {stats}; {pairs} (included anchor, valid gt of its class) pairs, "
          f"{positives} positives")
    gt_bytes = TRAIN_BATCH * g * (16 + 4 + 1)
    reached = stats["reached_chunks"] * mc.CHUNK * 16 + tables.chunk_bv.numel() * 4
    old_pass1 = a * 16 + TRAIN_BATCH * a + gt_bytes + TRAIN_BATCH * g * 4
    old_pass2 = a * (28 + 16) + TRAIN_BATCH * a + gt_bytes + TRAIN_BATCH * g * (28 + 4) \
        + TRAIN_BATCH * a * (4 + 28 + 4 + 4)
    pass1_bytes = TRAIN_BATCH * a + gt_bytes + TRAIN_BATCH * g * 4 + reached
    pass2_bytes = TRAIN_BATCH * a * (4 + 28 + 4 + 4) + TRAIN_BATCH * a + a * 4 + gt_bytes \
        + TRAIN_BATCH * g * (28 + 4) + reached + positives * 24
    print(f"matcher bytes counted before the cull (all of anchors and anchors_bv read once): pass 1 {old_pass1} "
          f"({old_pass1 / HBM_BYTES_PER_S * 1e3:.5f} ms), pass 2 {old_pass2} ({old_pass2 / HBM_BYTES_PER_S * 1e3:.5f} ms); "
          f"counted for what these inputs need: pass 1 {pass1_bytes}, pass 2 {pass2_bytes}")
    disjoint = (stats["visited"] - stats["overlapping"]) * MATCH_OPS_DISJOINT
    for key, moved, ops, prev in (
            ("gt_max", pass1_bytes, stats["overlapping"] * MATCH_OPS_PASS1 + disjoint, MATCHER_GT_MAX_PREV_MS),
            ("assign", pass2_bytes, stats["overlapping"] * MATCH_OPS_PASS2 + disjoint, MATCHER_ASSIGN_PREV_MS)):
        t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
        result[f"{key}_bound_ms"] = max(t_bytes, t_ops) * 1e3
        result[f"{key}_bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        check(result[f"{key}_ms"] >= result[f"{key}_bound_ms"], f"matcher {key} reads faster than its bound")
        print(f"matcher {key}: kernel_ms={result[f'{key}_ms']:.4f} (prev_ms={prev}, the kernel without the cull) "
              f"plain_ms={result[f'{key}_plain_ms']:.4f} "
              f"library_ms=none bound_ms={result[f'{key}_bound_ms']:.5f} ({result[f'{key}_bound_by']}; "
              f"{moved} bytes, {ops} operations over {stats['overlapping']} overlapping of {stats['visited']} visited pairs)")
    return result


def check_scatter_bwd(grid_xy, v: int, c: int) -> dict:
    """The backward gather against the plain gather, bit for bit, on a
    channels-last cotangent like the one the first convolution returns."""
    from det3d_tpu_torch.kernels import scatter_cuda as sc

    gen = torch.Generator().manual_seed(SEED + 2)
    nx, ny = grid_xy
    result = {"max_abs_err": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for n_valid in (12_000, 0):
            _, coors = scatter_inputs(v, c, grid_xy, n_valid, dtype, gen)
            grad = torch.randn((TRAIN_BATCH, c, nx, ny), generator=gen).to(dtype).cuda()
            grad = grad.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
            coors = coors.expand(TRAIN_BATCH, -1, -1).contiguous()
            got = sc.scatter_to_bev_bwd_cuda(grad, coors)
            want = sc.scatter_to_bev_bwd_plain(grad, coors)
            torch.cuda.synchronize()
            equal = torch.equal(bits(got), bits(want))
            print(f"scatter bwd {str(dtype):15s} valid={n_valid:5d}: bit-equal={equal}")
            check(equal, f"scatter backward {dtype} with {n_valid} pillars differs from the plain gather")
        _, coors = scatter_inputs(v, c, grid_xy, 12_000, dtype, gen)
        coors = coors.expand(TRAIN_BATCH, -1, -1).contiguous()
        grad = torch.randn((TRAIN_BATCH, c, nx, ny), generator=gen).to(dtype).cuda()
        grad = grad.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        bi, x, y, keep = sc._kept_rows(coors, grid_xy)
        idx = (bi[keep], x[keep], y[keep])
        ms = cuda_ms(lambda: sc.scatter_to_bev_bwd_cuda(grad, coors))
        plain_ms = cuda_ms(lambda: sc.scatter_to_bev_bwd_plain(grad, coors))
        library_ms = cuda_ms(lambda: grad[idx])
        kept = int(keep.sum())
        moved = (kept * c + TRAIN_BATCH * v * c) * grad.element_size() + coors.numel() * 4
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        print(f"scatter bwd {str(dtype):15s} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} (advanced indexing) bound_ms={bound_ms:.5f} (bytes); "
              f"host ms per call {host_ms(lambda: sc.scatter_to_bev_bwd_cuda(grad, coors)):.4f}")
        result[dtype] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms)
    return result


def check_fence(preds: dict[str, torch.Tensor]) -> dict:
    """The fence copy against the contiguous-format `clone`, bit for bit, on
    the head's three strided views and on other layouts, each through the
    kernel that `copy_plan` names; then its time on the `cls_preds` view."""
    from det3d_tpu_torch.kernels import fence_cuda as fc

    preds_cls = preds["cls_preds"]
    b, _, a, h, w = preds_cls.shape
    head32 = torch.randn(b, a * 10, h, w, device="cuda").contiguous(memory_format=torch.channels_last)
    views = [(f"{name} view", x) for name, x in preds.items()]
    views += [
        ("cls_preds view, f32", head32[:, :a].reshape(b, a, 1, h, w).transpose(1, 2)),
        ("contiguous", preds_cls.contiguous()),
        ("odd-sized f32", torch.randn(7, 13, 5, device="cuda")),
        ("odd offset", preds_cls.contiguous().flatten()[1:]),
        ("rank 6, strided", torch.randn(3, 4, 5, 6, 7, 8, device="cuda")[::2, :, 1:, ::3].permute(0, 5, 2, 3, 4, 1)),
    ]
    for name, x in views:
        route = fc.copy_plan(x).route
        before = fc.route_launches[route]
        got, want = fc.fence_copy_cuda(x), x.clone(memory_format=torch.contiguous_format)
        torch.cuda.synchronize()
        equal = torch.equal(bits(got), bits(want)) and torch.equal(bits(fc.fence_copy_plain(x)), bits(want))
        print(f"fence {name:20s} {tuple(x.shape)} {x.dtype} strides {x.stride()} offset {x.storage_offset()}: "
              f"{route} kernel, bit-equal={equal} contiguous={got.is_contiguous()}")
        check(equal and got.is_contiguous(), f"fence copy differs from the contiguous clone on the {name}")
        check(fc.route_launches[route] == before + 1, f"the {route} kernel was not launched for the {name}")
        if name.startswith("cls_preds view"):
            check(route == "transpose", f"the {name} took the {route} kernel")
        if name in ("contiguous", "odd offset"):
            check(route == "contiguous", f"the {name} tensor took the {route} kernel")
    del head32, views

    kernel = lambda: fc.fence_copy_cuda(preds_cls)
    library = lambda: preds_cls.clone(memory_format=torch.contiguous_format)
    keep_order = lambda: preds_cls.clone()  # keeps the view's stride order: no transpose, an easier function
    ms, library_ms, keep_order_ms = cuda_ms(kernel), cuda_ms(library), cuda_ms(keep_order)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    moved = 2 * preds_cls.numel() * preds_cls.element_size()
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    print(f"fence {tuple(preds_cls.shape)} kernel_ms={ms:.4f} (prev_ms={FENCE_PREV_MS}, one element per thread) "
          f"plain_ms=library_ms={library_ms:.4f} (clone(memory_format=contiguous_format)) "
          f"clone_keep_order_ms={keep_order_ms:.4f} bound_ms={bound_ms:.5f} (bytes); "
          f"host ms per call {host_ms(kernel):.4f}")
    print("fence, single calls between CUDA events, median of 10, warm L2 / after a "
          f"{L2_FLUSH_BYTES >> 20} MB zero_(): kernel {single_call_ms(kernel):.4f} / "
          f"{single_call_ms(kernel, flush):.4f}, library {single_call_ms(library):.4f} / "
          f"{single_call_ms(library, flush):.4f}, clone keeping order {single_call_ms(keep_order):.4f} / "
          f"{single_call_ms(keep_order, flush):.4f}")
    for name in ("box_preds", "dir_preds"):
        x = preds[name]
        print(f"fence {name} view: kernel_ms={cuda_ms(lambda: fc.fence_copy_cuda(x)):.4f} library_ms="
              f"{cuda_ms(lambda: x.clone(memory_format=torch.contiguous_format)):.4f}")
    return dict(ms=ms, plain_ms=library_ms, library_ms=library_ms, bound_ms=bound_ms, max_abs_err=0.0)


def layout_inputs(b: int, v: int, c: int, grid_xy, n_valid: int, dtype, gen: torch.Generator):
    """Features (b, v, c) and coordinates on the card: n_valid pillars on
    unique cells of each sample, at random slots, -1 rows elsewhere."""
    nx, ny = grid_xy
    feats = torch.randn((b, v, c), generator=gen).to(dtype)
    coors = torch.full((b, v, 3), -1, dtype=torch.int32)
    for i in range(b):
        cells = torch.randperm(nx * ny, generator=gen)[:n_valid]
        slots = torch.randperm(v, generator=gen)[:n_valid]
        coors[i, slots, 0] = (cells // ny).to(torch.int32)
        coors[i, slots, 1] = (cells % ny).to(torch.int32)
        coors[i, slots, 2] = 0
    return feats.cuda(), coors.cuda()


@functools.cache
def _per_piece_lib() -> ctypes.CDLL:
    from det3d_tpu_torch.kernels import build

    lib = build.load("blocked_bwd_per_piece")
    fn = lib.det3d_blocked_bwd_per_piece
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_int64] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def blocked_bwd_per_piece(grad: torch.Tensor, coors: torch.Tensor, halo) -> torch.Tensor:
    """The blocked backward's kernel as it was before its redesign
    (det3d_tpu_torch/experiments/blocked_bwd_per_piece.cu: a thread per
    piece, 64-bit divisions), on the shipped wrapper's arguments; timed
    beside it, on no path."""
    b, nblk, rtot, ny2, c4 = grad.shape
    nx2 = nblk * (rtot - halo[0] - halo[1])
    dfeats = torch.empty((b, coors.shape[1], c4 // 4), dtype=grad.dtype, device=grad.device)
    sb, sj, sr, sy, _ = grad.stride()
    err = _per_piece_lib().det3d_blocked_bwd_per_piece(
        grad.data_ptr(), coors.data_ptr(), dfeats.data_ptr(), b, coors.shape[1], c4 // 4,
        int(grad.dtype == torch.bfloat16), 2 * nx2, 2 * ny2, nblk, halo[0], halo[1], sb, sj, sr, sy,
        torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"blocked_bwd_per_piece.cu failed with CUDA error {err}")
    return dfeats


def blocked_grad(b: int, c: int, nblk: int, rtot: int, ny2: int, dtype, gen: torch.Generator) -> torch.Tensor:
    """A blocked cotangent (b, nblk, rtot, ny2, 4c) as block0's entry
    convolution returns it: channels-last (b·nblk, 4c, rtot, ny2), viewed."""
    g = torch.randn((b * nblk, 4 * c, rtot, ny2), generator=gen).to(dtype).cuda()
    return g.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1).unflatten(0, (b, nblk))


@contextlib.contextmanager
def blocked_bwd_as(fn):
    """`fn` in place of the blocked backward's wrapper, which the autograd op
    looks up at each call."""
    from det3d_tpu_torch.kernels import scatter_cuda

    shipped = scatter_cuda.scatter_to_bev_s2d_blocked_bwd_cuda
    scatter_cuda.scatter_to_bev_s2d_blocked_bwd_cuda = fn
    try:
        yield
    finally:
        scatter_cuda.scatter_to_bev_s2d_blocked_bwd_cuda = shipped


def time_blocked_bwd(label: str, grid_xy, v: int, c: int, nblk: int, halo, n_valid: int, dtype,
                     gen: torch.Generator, b: int = TRAIN_BATCH) -> dict:
    """The redesigned blocked backward and the kernel it replaced, each bit
    for bit against the plain version, then timed in turns (old, new, new,
    old) beside the plain version, the library's one call and the bytes
    bound: the coordinates, the kept rows and their halo copies, the dfeats
    write. All warm: 30 calls on one input, whose copies stay in L2. The
    library call is `embedding_bag(mode="sum")` over the flattened
    cotangent, a bag of each pillar's copy rows (own, above, below; empty
    for a dropped slot): the same sum, rounded once where the kernel rounds
    after each add, so it is held to the plain version within 2^-6 of three
    times the largest |cotangent| in bf16 and 1e-6 of it in f32."""
    from det3d_tpu_torch.kernels import scatter_cuda as sc

    _, coors = layout_inputs(b, v, c, grid_xy, n_valid, dtype, gen)
    _, rtot = sc.blocked_rows(grid_xy, nblk, halo)
    ny2 = grid_xy[1] // 2
    g = blocked_grad(b, c, nblk, rtot, ny2, dtype, gen)
    want = sc.scatter_to_bev_s2d_blocked_bwd_plain(g, coors, halo)
    new = lambda: sc.scatter_to_bev_s2d_blocked_bwd_cuda(g, coors, halo)
    old = lambda: blocked_bwd_per_piece(g, coors, halo)
    for name, fn in (("new", new), ("old", old)):
        got = fn()
        torch.cuda.synchronize()
        check(torch.equal(bits(got), bits(want)), f"blocked bwd ({name} kernel) {label} {dtype} differs from plain")
    bi, y2, phase, places = sc._blocked_places(coors, grid_xy, nblk, halo)
    present = torch.stack([p for p, _, _ in places], -1)
    flat = torch.stack([(((bi * nblk + blk) * rtot + row) * ny2 + y2) * 4 + phase for _, blk, row in places], -1)
    bags, sizes = flat[present], present.sum(-1).flatten()
    offsets, table = torch.cumsum(sizes, 0) - sizes, g.view(-1, c)
    library = lambda: torch.nn.functional.embedding_bag(bags, table, offsets, mode="sum").view(b, v, c)
    lib_err = (library().float() - want.float()).abs().max().item()
    lib_tol = (2 ** -6 if dtype == torch.bfloat16 else 1e-6) * 3 * g.abs().max().item()
    check(lib_err <= lib_tol, f"blocked bwd {label} {dtype}: embedding_bag off the plain version by {lib_err}")
    times = [cuda_ms(fn) for fn in (old, new, new, old)]
    copies = int(present.sum())
    elt = torch.finfo(dtype).bits // 8
    moved = (copies * c + b * v * c) * elt + b * v * 3 * 4
    t = dict(ms=(times[1] + times[2]) / 2, old_ms=(times[0] + times[3]) / 2,
             plain_ms=cuda_ms(lambda: sc.scatter_to_bev_s2d_blocked_bwd_plain(g, coors, halo), iters=10, warmup=2),
             library_ms=cuda_ms(library), bound_ms=moved / HBM_BYTES_PER_S * 1e3,
             pieces=sc.blocked_bwd_piece_bytes(g))
    print(f"blocked bwd {label} {str(dtype):15s} batch {b}, {n_valid} of {v} pillars kept a sample, {copies} copies "
          f"read: old kernel {times[0]:.4f} / {times[3]:.4f} ms, new {times[1]:.4f} / {times[2]:.4f} ms; "
          f"bound_ms={t['bound_ms']:.5f} (bytes: {moved}) = {100 * t['bound_ms'] / t['ms']:.1f} % of the new "
          f"time, {100 * t['bound_ms'] / t['old_ms']:.1f} % of the old (warm, in L2); plain_ms={t['plain_ms']:.4f}; "
          f"library_ms={t['library_ms']:.4f} (embedding_bag, max abs diff {lib_err:.3e}, tol {lib_tol:.3e}); "
          f"{t['pieces']}-byte pieces; host ms per call {host_ms(new):.4f}")
    return t


def check_layout_scatters(grid_xy, v: int, c: int, nblk: int, halo, blocked10=None) -> dict:
    """The s2d and blocked scatters and their backwards against their plain
    versions, bit for bit, in f32 and bf16 at batch 1 and 2 (phase 9); then
    their times at the main path's shapes: the s2d scatter at batch 1 (packed
    inference), the blocked scatter, both backwards at batch 2 (the train
    step), the blocked backward beside the kernel it replaced, and, with
    `blocked10` = (grid, pillars, nblk, halo) of the 10 cm configuration, the
    blocked backward at those shapes too. Bounds: each input read once, each
    output written once (the backwards read only the kept rows and their
    halo copies)."""
    from det3d_tpu_torch.kernels import scatter_cuda as sc

    gen = torch.Generator().manual_seed(SEED + 3)
    nx, ny = grid_xy
    nx2, ny2 = nx // 2, ny // 2
    rb, rtot = sc.blocked_rows(grid_xy, nblk, halo)
    result = {name: {"max_abs_err": 0.0} for name in LAYOUT_COUNTERS}
    for dtype in (torch.float32, torch.bfloat16):
        for b in (1, 2):
            for n_valid in (12_000, 0):
                feats, coors = layout_inputs(b, v, c, grid_xy, n_valid, dtype, gen)
                cases = [(f"s2d w_major={wm}", sc.scatter_to_bev_s2d_cuda(feats, coors, grid_xy, wm),
                          sc.scatter_to_bev_s2d_plain(feats, coors, grid_xy, wm)) for wm in (False, True)]
                cases.append(("blocked", sc.scatter_to_bev_s2d_blocked_cuda(feats, coors, grid_xy, nblk, halo),
                              sc.scatter_to_bev_s2d_blocked_plain(feats, coors, grid_xy, nblk, halo)))
                g = torch.randn((b, 4 * c, nx2, ny2), generator=gen).to(dtype).cuda()
                g = g.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)  # as the entry conv returns it
                cases.append(("s2d bwd", sc.scatter_to_bev_s2d_bwd_cuda(g, coors),
                              sc.scatter_to_bev_s2d_bwd_plain(g, coors)))
                g5 = torch.randn((b * nblk, 4 * c, rtot, ny2), generator=gen).to(dtype).cuda()
                g5 = g5.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1).unflatten(0, (b, nblk))
                cases.append(("blocked bwd", sc.scatter_to_bev_s2d_blocked_bwd_cuda(g5, coors, halo),
                              sc.scatter_to_bev_s2d_blocked_bwd_plain(g5, coors, halo)))
                torch.cuda.synchronize()
                for name, got, want in cases:
                    equal = got.stride() == want.stride() and torch.equal(bits(got), bits(want))
                    err = (got.float() - want.float()).abs().max().item()
                    print(f"{name:17s} {str(dtype):15s} batch {b} valid={n_valid:5d}: bit-equal={equal}")
                    check(equal, f"{name} {dtype} batch {b} with {n_valid} pillars differs from the plain version")
                    key = {"blocked": "blocked_fwd", "s2d bwd": "s2d_bwd", "blocked bwd": "blocked_bwd"}.get(
                        name, "s2d_fwd")
                    result[key]["max_abs_err"] = max(result[key]["max_abs_err"], err)

        elt = torch.finfo(dtype).bits // 8
        coors_bytes = v * 3 * 4
        for key, b in (("s2d_fwd", 1), ("blocked_fwd", 2), ("s2d_bwd", 2), ("blocked_bwd", 2)):
            feats, coors = layout_inputs(b, v, c, grid_xy, 12_000, dtype, gen)
            bi, x2, y2, phase, keep = sc._s2d_index(coors, grid_xy)
            kept = int(keep.sum())
            if key == "s2d_fwd":
                idx = (bi[keep], x2[keep], y2[keep], phase[keep])
                rows = feats[keep]
                fn = lambda: sc.scatter_to_bev_s2d_cuda(feats, coors, grid_xy)
                plain = lambda: sc.scatter_to_bev_s2d_plain(feats, coors, grid_xy)
                library = lambda: torch.zeros((b, nx2, ny2, 4, c), dtype=dtype, device="cuda").index_put_(idx, rows)
                moved = (b * nx * ny * c + b * v * c) * elt + b * coors_bytes
            elif key == "blocked_fwd":
                _, y2b, phb, places = sc._blocked_places(coors, grid_xy, nblk, halo)
                idx = tuple(torch.cat(parts) for parts in zip(*[
                    (bi[p], blk[p], row[p], y2b[p], phb[p]) for p, blk, row in places]))
                rows = torch.cat([feats[p] for p, _, _ in places])
                fn = lambda: sc.scatter_to_bev_s2d_blocked_cuda(feats, coors, grid_xy, nblk, halo)
                plain = lambda: sc.scatter_to_bev_s2d_blocked_plain(feats, coors, grid_xy, nblk, halo)
                library = lambda: torch.zeros((b, nblk, rtot, ny2, 4, c), dtype=dtype,
                                              device="cuda").index_put_(idx, rows)
                moved = (b * nblk * rtot * ny2 * 4 * c + b * v * c) * elt + b * coors_bytes
            elif key == "s2d_bwd":
                g = torch.randn((b, 4 * c, nx2, ny2), generator=gen).to(dtype).cuda()
                g = g.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
                idx = (bi[keep], x2[keep], y2[keep], phase[keep])
                g5 = g.unflatten(-1, (4, c))
                fn = lambda: sc.scatter_to_bev_s2d_bwd_cuda(g, coors)
                plain = lambda: sc.scatter_to_bev_s2d_bwd_plain(g, coors)
                library = lambda: g5[idx]
                moved = (kept * c + b * v * c) * elt + b * coors_bytes
            else:
                result[key][dtype] = time_blocked_bwd("20 cm", grid_xy, v, c, nblk, halo, 12_000, dtype, gen, b)
                continue
            t = dict(ms=cuda_ms(fn), plain_ms=cuda_ms(plain, iters=10, warmup=2),
                     library_ms=None if library is None else cuda_ms(library),
                     bound_ms=moved / HBM_BYTES_PER_S * 1e3)
            lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
            print(f"{key:12s} {str(dtype):15s} batch {b}: kernel_ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
                  f"library_ms={lib} bound_ms={t['bound_ms']:.5f} (bytes: {moved}); "
                  f"host ms per call {host_ms(fn):.4f}")
            result[key][dtype] = t
    if blocked10 is not None:
        grid10, v10, nblk10, halo10 = blocked10
        result["blocked_bwd_10cm"] = {dtype: time_blocked_bwd("10 cm", grid10, v10, c, nblk10, halo10,
                                                              v10 * 3 // 4, dtype, gen)
                                      for dtype in (torch.float32, torch.bfloat16)}
    return result


@torch.no_grad()
def run_frames(det, frames, counters) -> dict:
    """The eager `detect` (`eager_detect`) over `frames` after one warm-up
    frame, with every counter set to 0 just before and read just after:
    ms/frame, peak memory, launches."""
    detect = eager_detect(det)
    detect(frames[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    times, detections = [], []
    for pts_np in frames[1:]:
        t0 = time.perf_counter()
        annos = detect(pts_np)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        detections.append(len(annos["score"]))
        for key in ("location", "dimensions", "rotation_y", "score"):
            check(bool(np.isfinite(annos[key]).all()), f"non-finite {key}")
    return dict(ms=statistics.median(times), min=min(times), max=max(times), n=len(times),
                peak=torch.cuda.max_memory_allocated(), launches={k: c.launches for k, c in counters.items()},
                detections=detections)


def run_steps(trainer, state, batch, steps: int, counters, warmup: int = TRAIN_WARMUP, falling: bool = True) -> dict:
    """`Trainer.train_step` over `steps` steps of one batch after warm-up
    steps, counters set to 0 just before and read just after: ms/step, peak
    memory, launches, the loss by step (finite; with `falling`, lower at the
    last step than at the first)."""
    for _ in range(warmup):
        trainer.train_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    times, history = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, loss, metrics = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        history.append({k: float(v) for k, v in loss.items()})
    for h in history:
        check(all(np.isfinite(v) for v in h.values()), f"non-finite loss term in {h}")
    check(not falling or history[-1]["loss"] < history[0]["loss"], "the loss did not fall on the repeated batch")
    return dict(ms=statistics.median(times), min=min(times), max=max(times), n=steps,
                peak=torch.cuda.max_memory_allocated(), launches={k: c.launches for k, c in counters.items()},
                history=history, metrics=metrics)


TRAIN_COUNTERS = ("matcher_gt_max", "matcher_assign", "scatter_fwd", "scatter_bwd", "fence", "nms")
LAYOUT_COUNTERS = ("s2d_fwd", "s2d_bwd", "blocked_fwd", "blocked_bwd")


def train_counters(layouts: bool = False):
    """The launch counters of the train path's kernels; with `layouts`,
    the layout path's four scatter kernels too."""
    from det3d_tpu_torch.kernels import fence_cuda, matcher_cuda, nms_cuda, scatter_cuda

    counters = dict(zip(TRAIN_COUNTERS, (matcher_cuda.gt_max_counter, matcher_cuda.assign_counter,
                                         scatter_cuda.counter, scatter_cuda.bwd_counter, fence_cuda.counter,
                                         nms_cuda.counter)))
    if layouts:
        counters.update(zip(LAYOUT_COUNTERS, (scatter_cuda.s2d_counter, scatter_cuda.s2d_bwd_counter,
                                              scatter_cuda.blocked_counter, scatter_cuda.blocked_bwd_counter)))
    return counters


def train_stage_breakdown(trainer, state, batch, steps: int) -> dict[str, float]:
    """Median ms of each stage of `Trainer.train_step`, host clock with a
    synchronize after every stage."""
    from det3d_tpu_torch.losses import detection_loss

    spans: dict[str, list[float]] = {}
    for _ in range(steps):
        marks = [("start", time.perf_counter())]

        def mark(name):
            torch.cuda.synchronize()
            marks.append((name, time.perf_counter()))

        dev_batch = trainer.to_device(batch)
        mark("host batch to card")
        frames, tgt = trainer.prepare(dev_batch)
        mark("prepare (voxelize, mask, assign)")
        preds = trainer.model(frames.voxels, frames.num_points_per_voxel, frames.coors, train=True)
        preds = dict(preds, cls_preds=trainer.fence(preds["cls_preds"]))
        mark("forward (+ fence)")
        loss_dict = detection_loss(preds, tgt.labels, tgt.bbox_targets, tgt.dir_targets)
        mark("loss")
        for p in trainer.params:
            p.grad = None
        loss_dict["loss"].backward()
        mark("backward")
        trainer.apply_gradients(state)
        mark("optimizer (clip + Adam)")
        for (_, t0), (name, t1) in zip(marks, marks[1:]):
            spans.setdefault(name, []).append((t1 - t0) * 1e3)
    return {name: statistics.median(v) for name, v in spans.items()}


def count_syncs(fn) -> list[str]:
    """The host-card synchronisations that one call of `fn` makes, as
    torch's sync debug mode reports them: each by the line that made it
    and, where that line is torch's own, by the nearest line outside torch
    that called it ("torch line <- caller line")."""
    import traceback
    import warnings

    torch_dir = str(Path(torch.__file__).parent)
    short = lambda filename, lineno: f"{'/'.join(filename.split('/')[-2:])}:{lineno}"
    found = []

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        where = short(filename, lineno)
        if filename.startswith(torch_dir):
            stack = traceback.extract_stack()
            inner = max((i for i, f in enumerate(stack) if f.filename == filename and f.lineno == lineno), default=0)
            caller = next((f for f in reversed(stack[:inner]) if not f.filename.startswith(torch_dir)), None)
            if caller is not None:
                where += f" <- {short(caller.filename, caller.lineno)}"
        found.append(where)

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True):
        # the first switch to "warn" in a process reports a sync of its own
        # (at torch/cuda/__init__.py, called from here): switch once unread
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode("default")
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return found


def detect_syncs(tree: str, n_frames: int = 20) -> int:
    """`chip_smoke.py --detect-syncs TREE`: the host-card synchronisations
    of one eager `detect` (`eager_detect`; configs/ntusl_20cm.json, bf16, seeded
    weights, 100 000-point frames) and its ms/frame (median over
    `n_frames` frames after a warm-up call) with the port of the checkout at TREE:
    this one, or an earlier commit unpacked into a git-ignored directory.
    Run it on two trees in turns (old, new, new, old) to compare them in
    one call."""
    root = Path(tree).resolve()
    sys.path.insert(0, str(root))
    import det3d_tpu_torch
    from det3d_tpu_torch.config import load_config
    from det3d_tpu_torch.data.synthetic import synthetic_cloud
    from det3d_tpu_torch.pipeline import Detector

    check(Path(det3d_tpu_torch.__file__).resolve().parents[1] == root, f"imported {det3d_tpu_torch.__file__}")
    cfg = load_config(root / "configs" / "ntusl_20cm.json", max_points=120_000)
    det = Detector(cfg).init_weights(SEED)
    frames = [synthetic_cloud(cfg.max_points, N_POINTS, seed=SEED + i)[:N_POINTS] for i in range(n_frames)]
    detect = eager_detect(det)
    times = host_ms_per_frame(detect, frames)
    syncs = [count_syncs(lambda: detect(f)) for f in frames[:3]]
    ms = statistics.median(times)
    print(f"[{card_line()}] {root}: host-card syncs in each of 3 detects {[len(x) for x in syncs]} "
          f"({', '.join(syncs[0])}); ms/frame median {ms:.3f} (min {min(times):.3f}, max {max(times):.3f}) "
          f"over {len(times)} frames")
    return 0


def profile_device_time(fn, n: int) -> tuple[float, list[tuple[str, float]]] | None:
    """Device time per call of `fn` from a torch.profiler trace (sum of the
    card's kernel, memset and memcpy spans) and the top device ops per call;
    None when the trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / n
    if not by_name:
        return None
    return sum(by_name.values()), sorted(by_name.items(), key=lambda kv: -kv[1])


def use_plain_scatters(model) -> None:
    """Set the plain versions in place of every scatter kernel of `model`."""
    from det3d_tpu_torch.kernels import scatter_cuda

    model.scatter = scatter_cuda.scatter_to_bev_plain
    model.scatter_s2d = scatter_cuda.scatter_to_bev_s2d_plain
    model.scatter_s2d_blocked = scatter_cuda.scatter_to_bev_s2d_blocked_plain


def compare_train_steps(cfg32, batch) -> None:
    """One float32 step with the kernels against one with the plain
    versions, from the same weights and batch (phase 8). Tolerances of
    tests/test_torch_train.py: loss terms rtol 1e-5; gradients within 1e-4
    of each tensor's largest; updated parameters within 1e-6 where the
    gradient is above 1e-3 of its tensor's largest, else within 2·lr (Adam's
    first step is about lr·sign(g)); batch statistics rtol 1e-5."""
    from det3d_tpu_torch.kernels import fence_cuda
    from det3d_tpu_torch.train.trainer import Trainer

    runs = []
    for plain in (False, True):
        trainer = Trainer(cfg32)
        state = trainer.init_state(SEED)
        before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        if plain:
            trainer.assigner = trainer.assigner.plain
            use_plain_scatters(trainer.model)
            trainer.fence = fence_cuda.fence_copy_plain
        state, loss, _ = trainer.train_step(state, batch)
        grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters()}
        runs.append((loss, grads, trainer.model.state_dict(), state.lr))
        del trainer
    (lk, gk, sk, lr), (lp, gp, sp, _) = runs
    for key in lk:
        torch.testing.assert_close(lk[key], lp[key], rtol=1e-5, atol=1e-6)
    print("f32 step, kernels vs plain: loss " + ", ".join(f"{k}={float(lk[k]):.6f}/{float(lp[k]):.6f}" for k in lk))
    worst_g = worst_p = worst_small = 0.0
    for name, g in gk.items():
        scale = gp[name].abs().max().item()
        dg = (g - gp[name]).abs().max().item()
        check(dg <= 1e-4 * scale + 1e-12, f"gradient of {name}: {dg} against scale {scale}")
        worst_g = max(worst_g, dg / max(scale, 1e-30))
        big = gp[name].abs() > 1e-3 * scale
        dp = (sk[name] - sp[name]).abs()
        if big.any():
            check(dp[big].max().item() <= 1e-6, f"updated {name} differs where the gradient is large")
            worst_p = max(worst_p, dp[big].max().item())
        check(dp.max().item() <= 2 * lr, f"updated {name} differs by more than 2·lr")
        worst_small = max(worst_small, dp.max().item())
    for name in sk:
        if "running" in name:
            torch.testing.assert_close(sk[name], sp[name], rtol=1e-5, atol=1e-6)
            check(not torch.equal(sk[name], before[name]), f"{name} was not updated")
    print(f"f32 step, kernels vs plain: gradients within {worst_g:.2e} of each tensor's largest; updated "
          f"params within {worst_p:.2e} where |g| is large, {worst_small:.2e} overall (lr {lr}); batch stats equal "
          "to rtol 1e-5")



def run_apps(cfg, counters, bare_step_ms: float, root: Path) -> tuple[dict, dict]:
    """Phase 12: the train and infer applications on a dataset written to
    `root` (a temporary directory; phases 13 and 14 read it), with every
    counter set to 0 just before each app and read just after → (launches
    over both apps, the train app's waits for batches, ms/step by window
    and the host's ms per sample)."""
    from det3d_tpu_torch.apps import infer_app, train_app
    from det3d_tpu_torch.data.dataset import DetectionDataset
    from det3d_tpu_torch.data.synthetic import write_split
    from det3d_tpu_torch.eval import ap
    from det3d_tpu_torch.train.checkpoint import CheckpointManager
    from det3d_tpu_torch.train.trainer import Trainer, host_batch

    frame_overlaps = ap._frame_overlaps
    overlaps_s: list[float] = []

    def timed_overlaps(*args, **kw):  # the eval's rotated IoUs on the card, numpy out (so synced)
        t0 = time.perf_counter()
        out = frame_overlaps(*args, **kw)
        overlaps_s.append(time.perf_counter() - t0)
        return out

    try:
        t0 = time.perf_counter()
        for split, seed in (("train", SEED + 10), ("eval", SEED + 11)):
            write_split(cfg, root / split, APP_FRAMES, seed, num_objects=(20, 40), ground_points=TRAIN_POINTS)
        print(f"wrote {APP_FRAMES} train and {APP_FRAMES} eval scenes in {time.perf_counter() - t0:.2f} s")
        app_cfg = app_config(cfg, root)
        model_dir = root / "model"
        ds = DetectionDataset(app_cfg, app_cfg.train_info, training=True, seed=SEED)
        sample_ms = []
        for i in range(4):
            t0 = time.perf_counter()
            ds[i]
            sample_ms.append((time.perf_counter() - t0) * 1e3)
        print(f"one training sample (read + augment + range filter + shuffle) in this process: "
              f"{[round(v, 1) for v in sample_ms]} ms")

        ap._frame_overlaps = timed_overlaps
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        summary = train_app.train(app_cfg, max_steps=APP_STEPS, display_step=2, save_step=3, eval_step=APP_STEPS,
                                  eval_frames=APP_EVAL_FRAMES, model_dir=str(model_dir))
        train_s = time.perf_counter() - t0
        train_launches = {k: c.launches for k, c in counters.items()}
        ap._frame_overlaps = frame_overlaps
        check(not multiprocessing.active_children(), "the prefetcher's workers outlived the train loop")
        check(summary["steps"] == APP_STEPS, f"train_app ran {summary['steps']} steps")
        waits, summary_ms = summary["batch_wait_s"], summary["ms_per_step"]
        print(f"train_app: {APP_STEPS} steps in {train_s:.2f} s; ms/step by display window of 2 steps "
              f"{[round(v, 3) for v in summary['ms_per_step']]} (the first window holds the workers' start and the "
              f"first batches; the last follows the eval) against phase 7's bare train_step {bare_step_ms:.3f}")
        print(f"train_app: waited for batches {[round(w * 1e3, 3) for w in waits]} ms by step "
              f"({APP_WORKERS} spawned workers; after the first: mean {1e3 * statistics.mean(waits[1:]):.3f} ms/step)")
        print(f"train_app: checkpoint saves (latest.pth + <step>.pth, from the card) "
              f"{[round(v * 1e3, 1) for v in summary['save_s']]} ms; the window of steps 3-4 holds the save at 3")
        print(f"train_app: in-training eval ({APP_EVAL_FRAMES} frames) {summary['eval_s'][0]:.3f} s wall, of which "
              f"_frame_overlaps (rotated IoU on the card, bev + 3d) {sum(overlaps_s):.3f} s in {len(overlaps_s)} calls")
        print(f"train_app launches over {APP_STEPS} steps and {APP_EVAL_FRAMES} eval frames (captured: the "
              f"warm-up calls and the capture of each graph): {train_launches}")
        # the app's step and eval are captured graphs: the wrappers
        # launch in their warm-up calls and capture only, once each graph
        want = {k: 0 for k in counters}
        want.update({name: CAPTURE_LAUNCHES for name in TRAIN_COUNTERS})
        want.update(scatter_fwd=2 * CAPTURE_LAUNCHES, nms=CAPTURE_LAUNCHES)
        check(train_launches == want, f"train_app launches {train_launches}, expected {want}")

        names = sorted(p.name for p in model_dir.iterdir())
        print(f"model dir: {names}")
        check({"3.pth", "6.pth", "latest.pth", "log.txt"} <= set(names), f"checkpoints written: {names}")
        live, live_state = summary["trainer"], summary["state"]
        fresh = Trainer(app_cfg)
        fresh.init_state(SEED + 1)
        restored = CheckpointManager(model_dir).restore_latest(fresh)
        live_sd, fresh_sd = live.model.state_dict(), fresh.model.state_dict()
        check(all(torch.equal(live_sd[k], fresh_sd[k]) for k in live_sd), "restored weights or batch statistics")
        check(all(torch.equal(a, b) for a, b in zip(live_state.mu + live_state.nu, restored.mu + restored.nu)),
              "restored Adam moments")
        check((restored.step, restored.lr) == (live_state.step, live_state.lr), "restored step and lr")
        print(f"latest.pth restored into a fresh Trainer: weights, batch statistics, moments, step {restored.step} "
              f"and lr {restored.lr} bit-equal to the live trainer's")
        _, loss, _ = fresh.train_step(restored, host_batch(app_cfg, train_scenes(app_cfg, SEED + 12)))
        check(all(np.isfinite(float(v)) for v in loss.values()), f"loss after the restore: {loss}")
        print(f"one more step after the restore: step {restored.step}, loss {float(loss['loss']):.4f}")
        del live, fresh, summary

        for c in counters.values():
            c.launches = 0
        out = infer_app.infer(app_cfg, checkpoint=str(model_dir), num_frames=APP_FRAMES, breakdown=True)
        infer_launches = {k: c.launches for k, c in counters.items()}
        check(out["reader"] == "native", f"infer read its frames with the {out['reader']} reader")
        print(f"infer_app: reader {out['reader']}, {out['avg_ms']:.3f} ms/frame over {APP_FRAMES - 1} frames after "
              f"the first; breakdown ms (the replay's stage marks, median of {infer_app.BREAKDOWN_CALLS}) "
              f"{ {k: round(v * 1e3, 3) for k, v in out['stages'].items()} }")
        print(f"infer_app launches over {APP_FRAMES} frames and the breakdown: {infer_launches}")
        want = {k: 0 for k in counters}  # one captured frame graph; the breakdown replays it
        want.update(scatter_fwd=CAPTURE_LAUNCHES, nms=CAPTURE_LAUNCHES)
        check(infer_launches == want, f"infer_app launches {infer_launches}, expected {want}")
        check(len(out["eval_strs"]) == 3 and all("Metric: 3d" in e for e in out["eval_strs"]), "mAP strings")
        for a in out["dt_annos"]:
            for key in ("location", "dimensions", "rotation_y", "score"):
                check(bool(np.isfinite(a[key]).all()), f"non-finite {key} in infer's annos")
        launches = {k: train_launches[k] + infer_launches[k] for k in counters}
        return launches, dict(waits=waits, ms_per_step=summary_ms, sample_ms=sample_ms)
    finally:
        ap._frame_overlaps = frame_overlaps


def app_config(cfg, root: Path):
    """Phase 12's config: batch 2, two workers, the dataset under `root`."""
    return cfg.replace(batch_size=TRAIN_BATCH, num_workers=APP_WORKERS, data_root=str(root),
                       train_info=("train/data_info.pkl",), eval_info=("eval/data_info.pkl",))


def host_ms_per_frame(fn, clouds) -> list[float]:
    """Host ms of `fn(cloud)` + synchronize for each cloud, after one
    warm-up call."""
    fn(clouds[0])
    torch.cuda.synchronize()
    times = []
    for c in clouds:
        t0 = time.perf_counter()
        fn(c)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def profiled_frames(fn, clouds) -> tuple[dict[str, float] | None, float | None, list[str]]:
    """From a torch.profiler trace of `fn` over `clouds`, per frame: the
    calls of every hand-written kernel (`PROFILER_KERNELS`; None when the
    trace holds none of them) and the device ms (the card's kernel, memset
    and memcpy spans summed; None without device events); and the names of
    the hand-written kernels it saw."""
    return profiled_calls(fn, clouds)[:3]


def profiled_calls(fn, clouds) -> tuple[dict[str, float] | None, float | None, list[str], dict[str, float]]:
    """`profiled_frames`, and the NCCL events on the card per call by name:
    NCCL's kernels (none where a one-rank group runs a collective as a
    copy) and the `nccl:` spans that an eager collective records (a replay
    runs no host code, so records none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for c in clouds:
            fn(c)
        torch.cuda.synchronize()
    launches = {(k, p): 0 for k, patterns in PROFILER_KERNELS.items() for p in patterns}
    busy, names, nccl = 0.0, set(), collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy += e.time_range.elapsed_us() / 1e3
            if "nccl" in e.name.lower():
                nccl[e.name.split("(")[0]] += 1
            for k, p in launches:
                found = re.search(p, e.name)
                if found:
                    launches[k, p] += 1
                    names.add(found.group(0))
    calls = {}
    for k, patterns in PROFILER_KERNELS.items():
        counts = {launches[k, p] for p in patterns}
        check(len(counts) == 1, f"the kernels of one {k} call launched unequal times: {counts}")
        calls[k] = counts.pop() / len(clouds)
    per_frame = calls if names else None
    return (per_frame, (busy / len(clouds) if busy else None), sorted(names),
            {k: v / len(clouds) for k, v in nccl.items()})


def detections_equal(got, want, what: str) -> bool:
    """True where (boxes, scores, valid) are bit-equal; else checks the
    golden tolerances (valid equal, boxes 1e-4, scores 1e-5), prints the
    largest differences and returns False."""
    if all(np.array_equal(g, w) for g, w in zip(got, want)):
        return True
    (gb, gs, gv), (wb, ws, wv) = got, want
    check(np.array_equal(gv, wv), f"{what}: valid sets differ ({int(gv.sum())} vs {int(wv.sum())})")
    db, ds = np.abs(gb - wb)[wv].max(initial=0.0), np.abs(gs - ws)[wv].max(initial=0.0)
    print(f"{what}: not bit-equal; valid equal, boxes max diff {db:.3e}, scores max diff {ds:.3e}")
    check(np.allclose(gb[wv], wb[wv], rtol=1e-4, atol=1e-4) and np.allclose(gs[wv], ws[wv], rtol=1e-5, atol=1e-5),
          f"{what}: outside the golden tolerances")
    return False


def bev_standup(anno: dict, m: np.ndarray) -> torch.Tensor:
    """The standup boxes that NMS compares, of the boxes `m` of `anno`
    (the yaw's flip by pi leaves them as they are)."""
    from det3d_tpu_torch.ops import geometry

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    unit = geometry.unit_corners(0.5, torch.device("cpu"), torch.float32)
    corners = geometry.center_to_corner_box2d(t(anno["location"][m][:, :2]), t(anno["dimensions"][m][:, :2]),
                                              t(anno["rotation_y"][m]), unit)
    return geometry.corner_to_standup(corners)


def annos_match(a: dict, b: dict, what: str, iou_threshold: float, box_tol: float = 1e-3,
                score_tol: float = 1e-4, tie_tol: float = 1e-5) -> list:
    """Two annos of one frame from two paths whose float32 sums differ in
    order (cuDNN picks other algorithms at another batch): per class the
    same count and sorted scores within `score_tol` (the JAX package's
    check, tests/test_apps.py:417-440), and every box within `box_tol`
    (location, dimensions) of one on the other side, except where NMS broke
    a tie the other way: of two candidates that overlap above
    `iou_threshold` (NMS's own IoU of their standup boxes) and whose scores
    tie within `tie_tol`, each path keeps the one it ranks first. So every
    box without a counterpart must have a twin on the other side, also
    without one, that ties with it and overlaps it so. Returns those boxes
    as (class, score, distance to the nearest box of the other side, IoU
    with its twin)."""
    from det3d_tpu_torch.ops.nms import iou_pixel_convention

    swapped = []
    for name in np.unique(np.concatenate([a["name"], b["name"]])):
        ma, mb = a["name"] == name, b["name"] == name
        check(ma.sum() == mb.sum(), f"{what}: {ma.sum()} and {mb.sum()} {name} boxes")
        sa, sb = np.sort(a["score"][ma]), np.sort(b["score"][mb])
        check(np.abs(sa - sb).max(initial=0.0) <= score_tol, f"{what}: {name} scores differ")
        ra = np.concatenate([a["location"][ma], a["dimensions"][ma]], 1)
        rb = np.concatenate([b["location"][mb], b["dimensions"][mb]], 1)
        dist = np.abs(ra[:, None, :] - rb[None, :, :]).max(-1)
        near_a, near_b = dist.min(1, initial=np.inf), dist.min(0, initial=np.inf)
        ua, ub = near_a > box_tol, near_b > box_tol
        check(ua.sum() == ub.sum(), f"{what}: {name} boxes without a counterpart: {ua.sum()} and {ub.sum()}")
        if not ua.any():
            continue
        score_a, score_b = a["score"][ma][ua], b["score"][mb][ub]
        ka, kb = len(score_a), len(score_b)
        iou = iou_pixel_convention(torch.cat([bev_standup(a, ma)[ua], bev_standup(b, mb)[ub]]))[:ka, ka:].numpy()
        twins = (np.abs(score_a[:, None] - score_b[None, :]) <= tie_tol) & (iou > iou_threshold)
        check(twins.any(1).all() and twins.any(0).all(),
              f"{what}: {name} boxes without a counterpart and without an overlapping tie: "
              f"{score_a.tolist()} vs {score_b.tolist()}")
        best = np.where(twins, iou, -1.0).max(1)
        swapped += [(str(name), round(float(sc), 6), float(d), round(float(o), 3))
                    for sc, d, o in zip(score_a, near_a[ua], best)]
    return swapped


def latency_line(stats) -> str:
    lat = np.asarray(stats) * 1e3
    return (f"p50 {np.percentile(lat, 50):.3f} ms, p95 {np.percentile(lat, 95):.3f} ms, max {lat.max():.3f} ms over "
            f"{len(lat)} served; submitted {stats.submitted}, dropped {stats.dropped}")


def deploy_child(artifact: str, frames_path: str, out_path: str) -> int:
    """Phase 13's fresh process: load the artifact (no model code), capture
    its graph, hold its detections against the live ones the parent saved,
    time it against the program run op by op, serve it."""
    from det3d_tpu_torch.apps import serve_app
    from det3d_tpu_torch.deploy.runtime import ExportedDetector
    from det3d_tpu_torch.kernels import nms_cuda, scatter_cuda

    card = card_line()
    t0 = time.perf_counter()
    runner = ExportedDetector(artifact)
    load_s = time.perf_counter() - t0
    # the artifact's scatter: the s2d one for a packed config (phase 14), else the dense one
    packed = runner.cfg.pack_w
    check(not runner.cfg.block0_blocked, "the fresh process replays the dense or the packed network")
    scatter_row = "scatter_to_bev_s2d" if packed else "scatter_to_bev"
    counters = {"scatter": scatter_cuda.s2d_counter if packed else scatter_cuda.counter, "nms": nms_cuda.counter}
    infer_calls = {k: int(k in (scatter_row, "nms_keep")) for k in PROFILER_KERNELS}
    infer_calls["in_relu"] = in_relu_pairs(runner.cfg)
    captured = {k: c.launches for k, c in counters.items()}  # two warm-up calls and the capture
    loaded = sorted(m for m in sys.modules if m.startswith(("det3d_tpu_torch.models", "det3d_tpu_torch.pipeline")))
    check(not loaded, f"the runtime imported {loaded}")
    check(runner.graph is not None, "no CUDA graph was captured")
    live = np.load(frames_path)
    clouds = [live["points"][i][: live["counts"][i]] for i in range(len(live["counts"]))]
    equal = [detections_equal([t.cpu().numpy() for t in runner.infer(live["points"][i], live["counts"][i])],
                              [live[k][i] for k in ("boxes", "scores", "valid")], f"graph frame {i}")
             for i in range(len(clouds))]
    detections = [len(runner.detect(c)["name"]) for c in clouds]
    print(f"[{card}] graph replay vs live Detector.infer over {len(clouds)} frames: bit-equal {equal}; "
          f"detections per frame {detections}; loaded and captured in {load_s:.2f} s, imported no model code")
    check(sum(detections) > 0, "the graph found nothing")

    result = {"load_s": load_s, "bit_equal": all(equal), "captured": captured}
    for name, fn_runner in (("graph", runner), ("eager", None)):
        if fn_runner is None:
            fn_runner = ExportedDetector(artifact, cuda_graph=False)
        for c in counters.values():
            c.launches = 0
        times = host_ms_per_frame(fn_runner.detect, clouds)
        launches = {k: c.launches for k, c in counters.items()}
        per_frame, device, names = profiled_frames(fn_runner.detect, clouds)
        syncs = count_syncs(lambda: fn_runner.detect(clouds[0]))
        ms = statistics.median(times)
        busy = "not measured" if device is None else f"{device:.3f} ms ({100 * device / ms:.1f} % busy)"
        print(f"[{card}] exported, {name}: ms/frame median {ms:.3f} (min {min(times):.3f}, max {max(times):.3f}); "
              f"device {busy}; calls per frame of each kernel (profiler) {per_frame}, by the names {names}; "
              f"wrapper launches {launches}; host-card syncs per detect {len(syncs)} ({', '.join(syncs)})")
        check(per_frame is None or per_frame == infer_calls, f"{name}: kernel calls per frame {per_frame}")
        result[name] = dict(ms=ms, times=times, device_ms=device, per_frame=per_frame, launches=launches,
                            syncs=len(syncs))
    check(result["graph"]["launches"] == {"scatter": 0, "nms": 0}, "a replay ran an op's Python")
    check(result["eager"]["launches"] == {"scatter": len(clouds) + 1, "nms": len(clouds) + 1},
          f"the program op by op launched {result['eager']['launches']}")
    if result["graph"]["per_frame"] is None:  # the trace shows no kernel inside the graph: not measured
        print(f"[{card}] the profiler shows no kernel inside the graph: kernel calls per replay not measured; "
              f"the capture's calls (two warm-up calls and the capture) {captured}")
        check(captured == {"scatter": 3, "nms": 3}, f"launches while capturing {captured}")

    stats = serve_app.serve_synthetic(runner.cfg, frames=SERVE_FRAMES, hz=SERVE_HZ,
                                      server=serve_app.PointCloudServer(runner.cfg, infer_fn=runner.infer))
    print(f"[{card}] serve_synthetic, exported graph, {SERVE_HZ} Hz: {latency_line(stats)}")
    check(stats.submitted == SERVE_FRAMES and len(stats) + stats.dropped == SERVE_FRAMES, "serve counts")
    result["serve"] = dict(latencies=list(stats), submitted=stats.submitted, dropped=stats.dropped)
    Path(out_path).write_text(json.dumps(result))
    return 0


def export_and_replay(cfg, det, root: Path, card: str, name: str) -> tuple[dict, list]:
    """Export `cfg`'s detector with `init_weights(0)` into `root / name`,
    save the live `det`'s outputs of DEPLOY_FRAMES clouds, and hold the
    artifact's CUDA graph against them in a fresh process (`deploy_child`)
    → (its result with the export's seconds and bytes, the clouds)."""
    from det3d_tpu_torch.data.synthetic import synthetic_cloud
    from det3d_tpu_torch.deploy.export import export_detector

    t0 = time.perf_counter()
    art = export_detector(cfg, out_dir=root / name)
    export_s = time.perf_counter() - t0
    art_bytes = {p.name: p.stat().st_size for p in art.iterdir()}
    print(f"[{card}] export of init_weights(0) ({name}): {export_s:.2f} s, {art_bytes} bytes")

    clouds = [synthetic_cloud(cfg.max_points, N_POINTS, seed=SEED + 100 + i)[:N_POINTS] for i in range(DEPLOY_FRAMES)]
    pads = [det.pad_points(c) for c in clouds]
    outs = [[t.cpu().numpy() for t in det.infer(torch.from_numpy(p).cuda(), int(n))] for p, n in pads]
    np.savez(root / f"{name}.npz", points=np.stack([p for p, _ in pads]), counts=np.array([n for _, n in pads]),
             **{k: np.stack([o[i] for o in outs]) for i, k in enumerate(("boxes", "scores", "valid"))})
    out = root / f"{name}.json"
    child = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--deploy-child", str(art),
                            str(root / f"{name}.npz"), str(out)], timeout=600)
    check(child.returncode == 0, f"the fresh process failed (exit {child.returncode})")
    return dict(json.loads(out.read_text()), export_s=export_s, art_bytes=art_bytes), clouds


def run_deploy(cfg, det, root: Path, card: str) -> dict:
    """Phase 13: export, the graph in a fresh process against the live
    detector, serve live and exported, replay, infer at batch 4, bench-rpn."""
    from det3d_tpu_torch.apps import infer_app, serve_app
    from det3d_tpu_torch.deploy.rpn_bench import bench_rpn
    from det3d_tpu_torch.kernels import nms_cuda, scatter_cuda

    counters = {"scatter": scatter_cuda.counter, "nms": nms_cuda.counter}
    result, clouds = export_and_replay(cfg, det, root, card, "artifact")
    for c in counters.values():
        c.launches = 0
    detect = eager_detect(det)
    live_times = host_ms_per_frame(detect, clouds)
    live_launches = {k: c.launches for k, c in counters.items()}
    live_per_frame, live_device, _ = profiled_frames(detect, clouds)
    live_syncs = count_syncs(lambda: detect(clouds[0]))
    live_ms = statistics.median(live_times)
    busy = "not measured" if live_device is None else f"{live_device:.3f} ms ({100 * live_device / live_ms:.1f} % busy)"
    print(f"[{card}] live detect: ms/frame median {live_ms:.3f} (min {min(live_times):.3f}, max {max(live_times):.3f}); "
          f"device {busy}; calls per frame of each kernel (profiler) {live_per_frame}; launches {live_launches}; "
          f"host-card syncs per detect {len(live_syncs)} ({', '.join(live_syncs)})")
    check(live_launches == {"scatter": DEPLOY_FRAMES + 1, "nms": DEPLOY_FRAMES + 1}, f"live launches {live_launches}")
    check(live_per_frame is None or live_per_frame == INFER_CALLS, f"live kernel calls per frame {live_per_frame}")

    for c in counters.values():
        c.launches = 0
    stats = serve_app.serve_synthetic(cfg, frames=SERVE_FRAMES, hz=SERVE_HZ,
                                      server=serve_app.PointCloudServer(cfg, infer_fn=eager_serve_infer(det)))
    serve_launches = {k: c.launches for k, c in counters.items()}
    print(f"[{card}] serve_synthetic, live detector, {SERVE_HZ} Hz: {latency_line(stats)}; launches {serve_launches}")
    check(stats.submitted == SERVE_FRAMES and len(stats) + stats.dropped == SERVE_FRAMES, "live serve counts")
    check(serve_launches == {k: len(stats) + 1 for k in counters}, f"live serve launches {serve_launches}")
    result["serve_live"] = dict(latencies=list(stats), submitted=stats.submitted, dropped=stats.dropped)

    replay = serve_app.serve_replay(cfg, str(root / "eval" / "velodyne"), hz=REPLAY_HZ, frames=REPLAY_FRAMES, loop=True,
                                    server=serve_app.PointCloudServer(cfg, infer_fn=eager_serve_infer(det)))
    print(f"[{card}] serve_replay of phase 12's eval .bin frames, loop, {REPLAY_HZ} Hz: {latency_line(replay)}")
    check(replay.submitted == REPLAY_FRAMES and len(replay) + replay.dropped == REPLAY_FRAMES, "replay counts")

    app_cfg = app_config(cfg, root)
    runs = {}
    for dtype in ("float32", "bfloat16"):
        for batch in (1, INFER_BATCH):
            for c in counters.values():
                c.launches = 0
            r = infer_app.infer(app_cfg.replace(compute_dtype=dtype), num_frames=APP_FRAMES, range_thresholds=(80.0,),
                                batch=batch)
            r["launches"] = {k: c.launches for k, c in counters.items()}
            runs[dtype, batch] = r
            print(f"[{card}] infer_app {dtype} batch {batch}: {r['avg_ms']:.3f} ms/frame over {r['timed_frames']} "
                  f"timed frames; launches {r['launches']}")
    check(runs["bfloat16", INFER_BATCH]["launches"] == {"scatter": CAPTURE_LAUNCHES, "nms": CAPTURE_LAUNCHES},
          f"batch {INFER_BATCH}: one scatter and one NMS call in the warm-up calls and the capture of its graph")
    pairs = list(zip(runs["float32", INFER_BATCH]["dt_annos"], runs["float32", 1]["dt_annos"]))
    thr = det.postprocess.params.nms_iou_threshold
    unmatched = [annos_match(a, b, f"f32 frame {i}, batch {INFER_BATCH} vs 1", thr) for i, (a, b) in enumerate(pairs)]
    print(f"[{card}] infer_app f32, batch {INFER_BATCH} vs batch 1: per class counts equal, sorted scores within 1e-4, "
          f"boxes within 1e-3 but for ties that NMS broke the other way, each with a twin on the other side that "
          f"overlaps it above the NMS threshold {thr} and ties with it within 1e-5 (class, score, distance to the "
          f"nearest box, IoU with the twin) per frame {unmatched} of {[len(a['name']) for a, _ in pairs]} boxes")

    rpn = bench_rpn(cfg, iters=RPN_ITERS)
    print(f"[{card}] bench_rpn (device ms per call, torch.profiler over {RPN_ITERS} calls): {rpn}")
    return dict(result, live_ms=live_ms, live_device_ms=live_device,
                live_syncs=len(live_syncs), rpn=rpn, infer={f"{d} batch {b}": r["avg_ms"] for (d, b), r in runs.items()})


def merge_parity(x) -> torch.Tensor:
    """A split head's column-parity pair → one map (column 2·y2 + p); a
    map stays as it is."""
    if not isinstance(x, tuple):
        return x
    return torch.stack(x, dim=-1).flatten(-2)


def print_run(card: str, name: str, run: dict, what: str = "frame") -> None:
    print(f"[{card}] {name}: ms/{what} median {run['ms']:.3f} (min {run['min']:.3f}, max {run['max']:.3f}) over "
          f"{run['n']} {what}s; peak memory allocated {run['peak']} bytes; launches {run['launches']}")


def expected_launches(counters, **n) -> dict:
    want = {k: 0 for k in counters}
    want.update(n)
    return want


def train_path_launches(counters, n: int, scatter: str = "scatter") -> dict:
    """Launches of `n` train steps: the matcher's two passes, the scatter of
    the layout and its backward, the fence, once a step each."""
    return expected_launches(counters, matcher_gt_max=n, matcher_assign=n, fence=n,
                             **{f"{scatter}_fwd": n, f"{scatter}_bwd": n})


def run_options(cfg, cfg32, frames, batch, card: str, base: dict, root: Path) -> dict:
    """Phase 14: the JAX package's model options at full width; `base`
    holds the numbers of phases 7, 10 and 12 to print beside them →
    {path: launches} of every path it drove."""
    from det3d_tpu_torch.apps import train_app
    from det3d_tpu_torch.config import load_config
    from det3d_tpu_torch.data.dataset import DetectionDataset
    from det3d_tpu_torch.data.synthetic import synthetic_cloud
    from det3d_tpu_torch.kernels import nms_cuda
    from det3d_tpu_torch.models.pointpillars import Layout, MultiHead, Neck
    from det3d_tpu_torch.pipeline import Detector
    from det3d_tpu_torch.train.checkpoint import CheckpointManager
    from det3d_tpu_torch.train.trainer import Trainer, host_batch

    counters = train_counters(layouts=True)
    launches = {}

    # (a) the JAX package's default inference network
    t0 = time.time()
    unfused = base["packed"]
    for name, flags, layout, n in (
        ("packed fused split", dict(pack_w=True), Layout(True, False, False), OPTION_FRAMES),
        ("packed fused split + blocked", dict(pack_w=True, block0_blocked=True), Layout(True, True, False),
         BLOCKED_FRAMES),
    ):
        det = Detector(cfg.replace(**flags)).init_weights(SEED)
        check(det.model.layout(1, False) == layout and det.model.neck(False) == Neck(True, True),
              f"{name}: layout {det.model.layout(1, False)}, neck {det.model.neck(False)}")
        run = run_frames(det, frames[:n + 1], counters)
        launches[name] = run["launches"]
        print_run(card, name, run)
        scatter = "blocked_fwd" if layout.block0_blocked else "s2d_fwd"
        want = expected_launches(counters, nms=n, **{scatter: n})
        check(run["launches"] == want, f"{name}: launches {run['launches']}, expected {want}")
        traced = device_time(det, frames[1:6])
        device = "not measured" if traced is None else f"{traced[0]:.3f} ms ({100 * traced[0] / run['ms']:.1f} % busy)"
        print(f"[{card}] {name}: device time per frame (torch.profiler, 5 frames) {device}")
        if not layout.block0_blocked:
            print(f"[{card}] beside it, phase 10's unfused packed network in this run: ms/frame median "
                  f"{unfused['ms']:.3f} (min {unfused['min']:.3f}, max {unfused['max']:.3f}), peak {unfused['peak']} "
                  f"bytes, device {unfused.get('device', 'not measured')}")
            print(f"[{card}] {name}: stage breakdown, median ms (synchronized after each stage):")
            for stage, ms in stage_breakdown(det, frames[1:]).items():
                print(f"  {stage:36s} {ms:.3f}")
        del det

    pts = torch.from_numpy(frames[2]).cuda()
    unfused32 = Detector(cfg32.replace(pack_w=True, fuse_in_stats=False, split_head=False)).init_weights(SEED)
    with torch.no_grad():
        frame, _ = unfused32.preprocess(pts, N_POINTS)
        args = (frame.voxels[None], frame.num_points_per_voxel[None], frame.coors[None])
        want_preds = unfused32.model(*args)
    del unfused32
    for name, flags in (("packed fused split", dict(pack_w=True)),
                        ("packed fused split + blocked", dict(pack_w=True, block0_blocked=True))):
        det = Detector(cfg32.replace(**flags)).init_weights(SEED)
        with torch.no_grad():
            preds = det.model(*args)
        check(isinstance(preds["cls_preds"], tuple), f"{name}: the head returned no parity pair")
        worst = 0.0
        for key, want in want_preds.items():
            got = merge_parity(preds[key])
            torch.testing.assert_close(got, want, rtol=FUSED_VS_UNFUSED_TOL, atol=FUSED_VS_UNFUSED_TOL)
            worst = max(worst, (got - want).abs().max().item())
        print(f"[{card}] f32 {name} vs the unfused packed network (phase 10): preds within rtol/atol "
              f"{FUSED_VS_UNFUSED_TOL}, max abs diff {worst:.3e}")
        with_kernels = det.infer(pts, N_POINTS)
        use_plain_scatters(det.model)
        det.postprocess.nms_keep = nms_cuda.nms_keep_plain
        assert_detections_close(with_kernels, det.infer(pts, N_POINTS), f"ntusl_20cm f32 {name}, kernels vs plain")
        del det

    det = Detector(cfg.replace(pack_w=True)).init_weights(SEED)
    replay, _ = export_and_replay(cfg.replace(pack_w=True), det, root, card, "artifact_packed")
    graph = replay["graph"]
    print(f"[{card}] exported packed fused split network: bit-equal to the live detector {replay['bit_equal']}; "
          f"graph {graph['ms']:.3f} ms/frame (device {graph['device_ms']}), op by op {replay['eager']['ms']:.3f}; "
          f"export {replay['export_s']:.2f} s, {replay['art_bytes']} bytes; calls per frame in the graph "
          f"{graph['per_frame']}")
    del det
    print(f"[{card}] 14(a) took {time.time() - t0:.1f} s")

    # (b) head "multi"
    t0 = time.time()
    cfg_m = cfg.replace(head="multi")
    det = Detector(cfg_m).init_weights(SEED)
    check(isinstance(det.model.heads, MultiHead) and det.model.neck(False) == Neck(False, False), "multi head")
    run = run_frames(det, frames[:MULTI_FRAMES + 1], counters)
    launches["multi head, inference"] = run["launches"]
    print_run(card, "multi head, inference", run)
    check(run["launches"] == expected_launches(counters, scatter_fwd=MULTI_FRAMES, nms=MULTI_FRAMES),
          f"multi head inference launches {run['launches']}")
    del det
    trainer = Trainer(cfg_m)
    state = trainer.init_state(SEED)
    run = run_steps(trainer, state, batch, MULTI_STEPS, counters)
    launches["multi head, train"] = run["launches"]
    print_run(card, "multi head, train step (batch 2)", run, "step")
    print(f"[{card}] multi head: loss by step " + " ".join(f"{h['loss']:.4f}" for h in run["history"]))
    check(run["launches"] == train_path_launches(counters, MULTI_STEPS), f"multi head train launches {run['launches']}")
    CheckpointManager(root / "model_multi").save(state, trainer.model)
    fresh = Trainer(cfg_m)
    restored = CheckpointManager(root / "model_multi").restore_latest(fresh)
    live_sd, fresh_sd = trainer.model.state_dict(), fresh.model.state_dict()
    check(all(torch.equal(live_sd[k], fresh_sd[k]) for k in live_sd)
          and all(torch.equal(a, b) for a, b in zip(state.mu + state.nu, restored.mu + restored.nu)),
          "the multi head's latest.pth restores bit-equal")
    print(f"[{card}] multi head: latest.pth restored into a fresh Trainer bit-equal (step {restored.step})")
    del trainer, fresh, state, restored
    compare_train_steps(cfg32.replace(head="multi"), batch)
    print(f"[{card}] 14(b) took {time.time() - t0:.1f} s")

    # (c) the device-augmented train step
    t0 = time.time()
    trainer = Trainer(cfg, device_global_augment=True, aug_seed=SEED)
    state = trainer.init_state(SEED)
    run = run_steps(trainer, state, batch, AUG_STEPS, counters, falling=False)
    launches["device-augmented train"] = run["launches"]
    print_run(card, "device-augmented train step (batch 2)", run, "step")
    print(f"[{card}] device-augmented: loss by step " + " ".join(f"{h['loss']:.4f}" for h in run["history"]))
    print(f"[{card}] beside it, phase 7's bare step in this run: ms/step median {base['step_ms']:.3f}")
    check(run["launches"] == train_path_launches(counters, AUG_STEPS), f"augmented train launches {run['launches']}")
    syncs = count_syncs(lambda: trainer.train_step(state, batch))
    print(f"[{card}] device-augmented: host-card synchronisations in one train_step {len(syncs)} "
          f"({', '.join(syncs)}); phase 7: {base['step_syncs']}")
    check(len(syncs) == base["step_syncs"], "the device augmentation added host-card syncs to the step")
    dev_batch = trainer.to_device(batch)
    augment = lambda: trainer.device_augment(dev_batch.points, dev_batch.gt_boxes, dev_batch.gt_valid,  # noqa: E731
                                             trainer.augment_params(0, TRAIN_BATCH))
    print(f"[{card}] device augmentation alone (draws, transforms, range filter, wrap) of the batch of "
          f"{TRAIN_BATCH}: host ms per call {host_ms(augment, iters=10):.3f}, device ms per call "
          f"{cuda_ms(augment, iters=10):.4f}")
    print(f"[{card}] device-augmented: stage breakdown, median ms over 5 steps (synchronized after each stage):")
    for stage, ms in train_stage_breakdown(trainer, state, batch, 5).items():
        print(f"  {stage:36s} {ms:.3f}")
    del trainer, state, dev_batch

    app_cfg = app_config(cfg, root)
    for flag in (False, True):
        ds = DetectionDataset(app_cfg, app_cfg.train_info, training=True, seed=SEED, device_global_augment=flag)
        sample_ms = []
        for i in range(6):
            t1 = time.perf_counter()
            ds[i]
            sample_ms.append((time.perf_counter() - t1) * 1e3)
        print(f"[{card}] host chain in this process, one sample, {'without' if flag else 'with'} the global "
              f"transforms: {[round(v, 1) for v in sample_ms]} ms (median {statistics.median(sample_ms):.1f})")
    for c in counters.values():
        c.launches = 0
    summary = train_app.train(app_cfg, max_steps=APP_STEPS, display_step=2, save_step=3, eval_step=10 ** 9,
                              model_dir=str(root / "model_augmented"), device_augment=True)
    launches["train_app --device-augment"] = {k: c.launches for k, c in counters.items()}
    check(not multiprocessing.active_children(), "the prefetcher's workers outlived the train loop")
    check(launches["train_app --device-augment"] == train_path_launches(counters, CAPTURE_LAUNCHES),
          f"train_app --device-augment launches {launches['train_app --device-augment']}")
    waits, app = summary["batch_wait_s"], base["app"]
    print(f"[{card}] train_app --device-augment ({APP_WORKERS} workers, {APP_STEPS} steps, saves at 3 and 6, no "
          f"eval): ms/step by window of 2 {[round(v, 3) for v in summary['ms_per_step']]}; waited for batches "
          f"{[round(w * 1e3, 3) for w in waits]} ms (after the first: mean {1e3 * statistics.mean(waits[1:]):.3f})")
    print(f"[{card}] beside it, phase 12's train_app without it: ms/step by window {[round(v, 3) for v in app['ms_per_step']]}; "
          f"waited {[round(w * 1e3, 3) for w in app['waits']]} ms (after the first: mean "
          f"{1e3 * statistics.mean(app['waits'][1:]):.3f})")
    del summary
    print(f"[{card}] 14(c) took {time.time() - t0:.1f} s")

    # (d) the 10 cm configuration and batch 4
    t0 = time.time()
    cfg10 = load_config("configs/ntusl_10cm.json", max_points=120_000)
    grid10 = (cfg10.grid_size[0], cfg10.grid_size[1])
    det = Detector(cfg10).init_weights(SEED)
    check(grid10 == (1600, 1600) and (cfg10.max_voxels, cfg10.max_num_points) == (20_000, 10)
          and det.anchor_set.num_anchors == 5_760_000 and cfg10.compute_dtype == "bfloat16"
          and det.model.layout(1, False) == Layout(False, False, False), "ntusl_10cm: the dense network at full width")
    print(f"[{card}] ntusl_10cm: grid {cfg10.grid_size}, {cfg10.max_voxels} pillars x {cfg10.max_num_points} points, "
          f"{det.anchor_set.num_anchors} anchors, bf16, dense (its block0_blocked key is inert)")
    frames10 = [synthetic_cloud(cfg10.max_points, N_POINTS, seed=SEED + 200 + i) for i in range(R1_FRAMES + 1)]
    run = run_frames(det, frames10, counters)
    launches["10 cm inference"] = run["launches"]
    print_run(card, "ntusl_10cm inference", run)
    check(run["launches"] == expected_launches(counters, scatter_fwd=R1_FRAMES, nms=R1_FRAMES),
          f"10 cm inference launches {run['launches']}")
    traced = device_time(det, frames10[1:4])
    print(f"[{card}] ntusl_10cm: device time per frame (torch.profiler, 3 frames) "
          + ("not measured" if traced is None else f"{traced[0]:.3f} ms ({100 * traced[0] / run['ms']:.1f} % busy)"))
    print(f"[{card}] ntusl_10cm kernels vs their plain versions and bounds at the 10 cm shapes:")
    kernels10 = {"scatter": check_scatter(grid10, cfg10.max_voxels, 64)}
    candidates = det.infer_candidates(torch.from_numpy(frames10[0]).cuda(), N_POINTS)
    kernels10["nms"] = check_nms(candidates, det.postprocess.params.nms_iou_threshold)
    del det, candidates
    trainer = Trainer(cfg10)
    state = trainer.init_state(SEED)
    batch10 = host_batch(cfg10, train_scenes(cfg10, SEED))
    dev_batch = trainer.to_device(batch10)
    kernels10["matcher"] = check_matcher(trainer, dev_batch)
    kernels10["scatter_bwd"] = check_scatter_bwd(grid10, cfg10.max_voxels, 64)
    with torch.no_grad():
        vox, _ = trainer.prepare(dev_batch)
        preds = trainer.model(vox.voxels, vox.num_points_per_voxel, vox.coors)
    kernels10["fence"] = check_fence(preds)
    del vox, preds, dev_batch
    run = run_steps(trainer, state, batch10, R1_STEPS, counters, warmup=1)
    launches["10 cm train"] = run["launches"]
    print_run(card, "ntusl_10cm train step (batch 2)", run, "step")
    print(f"[{card}] ntusl_10cm: loss by step " + " ".join(f"{h['loss']:.4f}" for h in run["history"]))
    check(run["launches"] == train_path_launches(counters, R1_STEPS), f"10 cm train launches {run['launches']}")
    del trainer, state

    trainer = Trainer(cfg.replace(batch_size=BATCH4))
    state = trainer.init_state(SEED)
    batch4 = host_batch(cfg, train_scenes(cfg, SEED + 20, BATCH4))
    run = run_steps(trainer, state, batch4, BATCH4_STEPS, counters, warmup=1)
    launches["20 cm train, batch 4"] = run["launches"]
    print_run(card, f"ntusl_20cm train step (batch {BATCH4})", run, "step")
    print(f"[{card}] batch {BATCH4}: loss by step " + " ".join(f"{h['loss']:.4f}" for h in run["history"]))
    check(run["launches"] == train_path_launches(counters, BATCH4_STEPS), f"batch 4 launches {run['launches']}")
    del trainer, state
    print(f"[{card}] 14(d) took {time.time() - t0:.1f} s")
    return dict(launches=launches, kernels10=kernels10)


# --- phase 15: data parallelism (each group of ranks in processes of its own) ---


def dp_state(trainer, state) -> dict:
    """CPU copies of the weights, batch statistics and Adam moments."""
    return dict(sd={k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()},
                moments=[t.detach().cpu().clone() for t in state.mu + state.nu], step=state.step)


def same_bits(a: dict, b: dict) -> list[str]:
    """The tensors of two `dp_state`s that are not bit-equal (by name)."""
    bad = [k for k in a["sd"] if not torch.equal(a["sd"][k], b["sd"][k])]
    bad += [f"moment {i}" for i, (x, y) in enumerate(zip(a["moments"], b["moments"])) if not torch.equal(x, y)]
    return bad + (["step"] if a["step"] != b["step"] else [])


def dp_timed_steps(step, state, batch, mesh, start: int) -> dict:
    """DP_TIMED_STEPS calls of `step` after the checked ones, the launch
    counters set to 0 just before and read just after: ms/step, peak memory,
    launches and collectives per step, host-card syncs of one more step, the
    profiler's device ms, hand-written kernels and NCCL events per step,
    and the bytes the run holds reserved over `start` (the reserve before
    its trainer was made: a captured step's graph pool and static
    buffers)."""
    counters = train_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    before = dict(mesh.collectives)
    times = []
    for _ in range(DP_TIMED_STEPS):
        t0 = time.perf_counter()
        state, _, _ = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {k: c.launches / DP_TIMED_STEPS for k, c in counters.items()}
    collectives = {k: (n - before.get(k, 0)) / DP_TIMED_STEPS for k, n in mesh.collectives.items()
                   if n != before.get(k, 0)}
    peak = torch.cuda.max_memory_allocated()
    syncs = count_syncs(lambda: step(state, batch))
    per_call, device, _, nccl = profiled_calls(lambda b: step(state, b), [batch] * 3)
    torch.cuda.empty_cache()
    return dict(ms=statistics.median(times), min=min(times), max=max(times), peak=peak, launches=launches,
                collectives=collectives, syncs=len(syncs), device=device, per_call=per_call, nccl=nccl,
                held=torch.cuda.memory_reserved() - start)


def lockstep_steps(make, batch, n: int) -> list[list[str]]:
    """The eager and the captured form of one step from `make(captured)` →
    (trainer, state, step fn), n steps of each in lockstep on `batch`: what
    differed after each step, by name (`step_snapshot`, `differing`)."""
    (te, se, eager), (tc, sc, captured) = make(False), make(True)
    diffs = []
    for _ in range(n):
        se, le, ce = eager(se, batch)
        want = step_snapshot(te, se, le, ce)
        sc, lc, cc = captured(sc, batch)
        diffs.append(differing(step_snapshot(tc, sc, lc, cc), want))
        del want
    return diffs


def dp_world1_child(out_dir: str) -> None:
    """Phase 15(a), (d) and (e), in a process of its own: a world-1 NCCL
    group on cuda:0, cuDNN deterministic, so that two plain runs are
    bit-equal at all. (a) phase 7's step (ntusl_20cm, bf16, batch 2, the
    same weights and batch) plain, the eager data-parallel body
    (`Trainer.train_step(..., mesh=)`), the captured data-parallel step
    (`make_sharded_train_step`), and each again, DP_STEPS steps from a
    fresh trainer and then timed; first DP_STEPS f32 steps of the captured
    step against the eager body in lockstep, bit for bit. (d)
    `train_app.train` on the group (its captured step), a save, the
    checkpoint restored into a fresh trainer. (e) the captured
    `make_sharded_infer` of DP_INFER_FRAMES frames against
    `Detector.infer_batch`, bit for bit, and `infer_app.infer` at batch
    INFER_BATCH on the group."""
    import gc

    import torch.distributed as dist

    from det3d_tpu_torch.apps import infer_app
    from det3d_tpu_torch.apps.train_app import train
    from det3d_tpu_torch.config import load_config
    from det3d_tpu_torch.data.synthetic import synthetic_cloud
    from det3d_tpu_torch.parallel import mesh as pm
    from det3d_tpu_torch.pipeline import Detector
    from det3d_tpu_torch.train.checkpoint import CheckpointManager
    from det3d_tpu_torch.train.trainer import Trainer, host_batch

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = Path(out_dir)
    cfg = load_config("configs/ntusl_20cm.json", max_points=120_000)
    cfg32 = cfg.replace(compute_dtype="float32")
    batch = host_batch(cfg, train_scenes(cfg, SEED))
    mesh = pm.make_mesh(device="cuda:0", rank=0, world_size=1, init_method=f"file://{out}/rendezvous-a")
    result = {"backend": mesh.backend, "device": str(mesh.device)}
    try:
        def make(captured: bool, config=cfg32):
            trainer = Trainer(config)
            state = pm.replicated(mesh, trainer, trainer.init_state(SEED))
            step = pm.make_sharded_train_step(trainer, mesh) if captured else \
                functools.partial(trainer.train_step, mesh=mesh)
            return trainer, state, step

        result["f32 captured vs eager"] = lockstep_steps(make, host_batch(cfg32, train_scenes(cfg32, SEED)), DP_STEPS)
        collect_graphs()
        for name in ("plain", "data-parallel", "captured", "plain again", "data-parallel again", "captured again"):
            start = torch.cuda.memory_reserved()
            if name.startswith("plain"):
                trainer = Trainer(cfg)
                state, step = trainer.init_state(SEED), trainer.train_step
            else:
                trainer, state, step = make(name.startswith("captured"), cfg)
            losses = []
            for _ in range(DP_STEPS):
                state, loss, _ = step(state, batch)
                losses.append(float(loss["loss"]))
            result[name] = dict(dp_state(trainer, state), losses=losses)
            result[name].update(dp_timed_steps(step, state, batch, mesh, start))
            del trainer, state, step, loss
            collect_graphs()
        counters = train_counters()
        for c in counters.values():
            c.launches = 0
        summary = train(cfg, max_steps=DP_APP_STEPS, display_step=DP_APP_STEPS, save_step=DP_APP_STEPS,
                        eval_step=10**9, synthetic=True, seed=SEED, model_dir=str(out / "app"), mesh=mesh)
        launches = {k: c.launches for k, c in counters.items()}
        fresh = Trainer(cfg)
        restored = CheckpointManager(out / "app", readonly=True).restore_latest(fresh)
        result["app"] = dict(ms_per_step=summary["ms_per_step"], launches=launches, steps=summary["steps"],
                             files=sorted(p.name for p in (out / "app").iterdir()),
                             captures=summary["trainer"].train_step_jit.captures,
                             restored=same_bits(dp_state(summary["trainer"], summary["state"]),
                                                dp_state(fresh, restored)))
        del summary, fresh, restored
        collect_graphs()

        det = Detector(cfg).init_weights(SEED)
        points = np.stack([synthetic_cloud(cfg.max_points, N_POINTS, seed=SEED + i) for i in range(DP_INFER_FRAMES)])
        num_points = np.full(DP_INFER_FRAMES, N_POINTS, np.int32)
        infer = pm.make_sharded_infer(det, mesh)
        before = pm.collective_counts(mesh)
        got = [t.clone() for t in infer(points, num_points)]
        collectives = counts_delta(before, pm.collective_counts(mesh))
        want = det.infer_batch(torch.from_numpy(points).cuda(), torch.from_numpy(num_points).cuda())
        per_call, device, _, nccl = profiled_calls(lambda _: infer(points, num_points), [None] * 2)
        result["infer"] = dict(bit_equal=all(torch.equal(a, b) for a, b in zip(got, want)), collectives=collectives,
                               captures=[c.captures for c in infer.captured.values()], per_call=per_call,
                               device=device, nccl=nccl)
        del det, infer, got, want
        collect_graphs()
        app = infer_app.infer(cfg, synthetic=True, num_frames=APP_FRAMES, range_thresholds=(80.0,),
                              batch=INFER_BATCH, mesh=mesh)
        result["infer_app"] = dict(avg_ms=app["avg_ms"], frames=len(app["dt_annos"]),
                                   evaluated="Metric: 3d" in app["eval_strs"][0])
        del app
    finally:
        gc.collect()  # every captured graph goes before the communicator its kernels use
        torch.cuda.synchronize()
        dist.destroy_process_group()
    with open(out / "world1.pkl", "wb") as f:
        pickle.dump(result, f)


def dp_step_record(trainer, state, loss) -> dict:
    return dict(dp_state(trainer, state), loss={k: float(v) for k, v in loss.items()},
                grads={n: p.grad.detach().cpu().clone() for n, p in trainer.model.named_parameters()})


def dp_compare(got: list[dict], want: list[dict], lr: float, elementwise: bool = True, start: int = 1) -> dict:
    """Steps of one run against another. The first step at phase 8's
    tolerances: loss terms rtol 1e-5, gradients within 1e-4 of each
    tensor's largest, parameters within 1e-6 where the gradient is above
    1e-3 of the tensor's largest and within 2·lr elsewhere, batch statistics
    rtol 1e-5. After step k > 1: parameters within k·2·lr, batch statistics
    rtol 1e-5, loss terms rtol 1e-4 — Adam's first update moves every
    weight by ±lr, so a weight whose gradient is within rounding of 0 moves
    2·lr apart in two summation orders, and the later steps start from
    weights that differ so (their gradients are not compared).

    `elementwise=False` holds the first step's gradients by norm instead,
    |Δg| within 1e-2 of |g| for each tensor (the late-blocked RPN's
    criterion against JAX, tests/test_torch_layouts.py), and drops the
    1e-6 on parameters that follows from the elementwise gradients: for a
    run whose convolutions see another batch than the reference's. cuDNN
    sums in other orders at another batch, and at full width the
    one-process step's own gradients move by up to ~1e-2 of a tensor's
    largest element, but under 1e-3 of its norm, when only the order of its
    two samples changes (PERF.md, phase 15; 15(b) measures it in each
    run). `start`: the step number of got[0]. Returns the worst of each,
    relative to its bound (a check fails above 1), and the tensor where it
    is."""
    worst: dict[str, tuple[float, str]] = collections.defaultdict(lambda: (0.0, ""))

    def note(kind: str, ratio: float, where: str) -> None:
        if ratio > worst[kind][0]:
            worst[kind] = (ratio, where)

    for k, (g, w) in enumerate(zip(got, want), start):
        rtol = 1e-5 if k == 1 else 1e-4
        for key, v in w["loss"].items():
            note("loss", abs(g["loss"][key] - v) / (rtol * abs(v) + 1e-12), f"{key}, step {k}")
        for name, wg in w["grads"].items():
            dp = (g["sd"][name] - w["sd"][name]).abs()
            note("params", dp.max().item() / (k * 2 * lr), f"{name}, step {k}")
            if k == 1 and not elementwise:
                note("grads by norm", (g["grads"][name] - wg).norm().item() / (1e-2 * wg.norm().item() + 1e-30), name)
            elif k == 1:
                scale = wg.abs().max().item()
                note("grads", (g["grads"][name] - wg).abs().max().item() / (1e-4 * scale + 1e-30), name)
                big = wg.abs() > 1e-3 * scale
                if big.any():
                    note("params where |g| is large", dp[big].max().item() / 1e-6, name)
        for name in w["sd"]:
            if "running" in name:
                err = (g["sd"][name] - w["sd"][name]).abs() / (1e-5 * w["sd"][name].abs() + 1e-6)
                note("batch stats", err.max().item(), f"{name}, step {k}")
    return dict(worst)


def step_ratios(got: dict, want: dict, lr: float, k: int) -> dict:
    """Step k's ratios to phase 15(b)'s bounds for that step (`dp_compare`,
    gradients by norm, which it compares at step 1 only): measured, never
    gated."""
    worst = dp_compare([got], [want], lr, elementwise=False, start=k)
    worst["grads by norm"] = max(((got["grads"][n] - g).norm().item() / (1e-2 * g.norm().item() + 1e-30), n)
                                 for n, g in want["grads"].items())
    return worst


def dp_gloo_child(rank: int, out_dir: str) -> None:
    """Phase 15(b) and (c), rank `rank` of two gloo ranks that share cuda:0
    (NCCL refuses two ranks on one card). (b) DP_GLOO_STEPS f32 steps of
    ntusl_20cm, each rank on its sample of phase 8's batch of 2, with the
    kernels on both ranks and then with rank 1 on the plain versions;
    rank 0 runs the one-process step at batch 2, and again with its two
    samples swapped, and holds both runs against the first (`dp_compare`:
    the runs against each other elementwise, against the one process by
    norm). Every run takes one step more, F1_STEP, whose ratios to the
    bounds are measured and not gated. (c) `make_sharded_infer`'s eager
    body of DP_INFER_FRAMES frames, two a rank, held by rank 0 against
    `Detector.infer_batch` of all four in one process. A gloo group on a
    card runs the eager forms by name (`Trainer.train_step(..., mesh=)`,
    `eager_sharded_infer`): no CUDA graph captures its collectives."""
    import hashlib

    import torch.distributed as dist

    from det3d_tpu_torch.config import load_config
    from det3d_tpu_torch.data.synthetic import synthetic_cloud
    from det3d_tpu_torch.kernels import fence_cuda
    from det3d_tpu_torch.parallel import mesh as pm
    from det3d_tpu_torch.pipeline import Detector
    from det3d_tpu_torch.postprocess import Detections, to_annos
    from det3d_tpu_torch.train.trainer import Trainer, TrainBatch, host_batch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = Path(out_dir)
    cfg32 = load_config("configs/ntusl_20cm.json", max_points=120_000).replace(compute_dtype="float32")
    batch = host_batch(cfg32, train_scenes(cfg32, SEED))
    mesh = pm.make_mesh(device="cuda:0", backend="gloo", rank=rank, world_size=2,
                        init_method=f"file://{out}/rendezvous-b")
    result = {"backend": mesh.backend, "rank": mesh.rank}
    counters = train_counters()
    try:
        runs = {}
        for name in ("kernels on both ranks", "rank 1 on the plain versions"):
            trainer = Trainer(cfg32)
            if rank == 1 and name.startswith("rank 1"):
                trainer.assigner = trainer.assigner.plain
                use_plain_scatters(trainer.model)
                trainer.fence = fence_cuda.fence_copy_plain
            state = pm.replicated(mesh, trainer, trainer.init_state(SEED))
            step = functools.partial(trainer.train_step, mesh=mesh)  # gloo on a card: the eager body
            local = pm.shard_batch(mesh, batch)
            torch.cuda.synchronize()
            for c in counters.values():
                c.launches = 0
            records, times = [], []
            for i in range(F1_STEP):
                t0 = time.perf_counter()
                state, loss, _ = step(state, local)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                records.append(dp_step_record(trainer, state, loss))
                if i + 1 == DP_GLOO_STEPS:
                    launches = {k: c.launches for k, c in counters.items()}
            last = records[DP_GLOO_STEPS - 1]
            digest = hashlib.sha256(b"".join(t.numpy().tobytes() for t in [*last["sd"].values(), *last["moments"]]))
            runs[name] = records
            result[name] = dict(ms=times[:DP_GLOO_STEPS], launches=launches, digest=digest.hexdigest(),
                                losses=[r["loss"]["loss"] for r in records[:DP_GLOO_STEPS]])
            del trainer, state
        if rank == 0:
            one = {}
            for name, order in (("one process", [0, 1]), ("one process, samples swapped", [1, 0])):
                trainer = Trainer(cfg32)
                state = trainer.init_state(SEED)
                one[name] = []
                for _ in range(F1_STEP):
                    state, loss, _ = trainer.train_step(state, TrainBatch(*(a[order] for a in batch)))
                    one[name].append(dp_step_record(trainer, state, loss))
                del trainer
            lr, n = state.lr, DP_GLOO_STEPS
            want, swapped = one["one process"], one["one process, samples swapped"]
            result["one process"] = dict(losses=[r["loss"]["loss"] for r in want[:n]])
            result["swapped"] = dict(by_norm=dp_compare(swapped[:n], want[:n], lr, elementwise=False),
                                     elementwise=dp_compare(swapped[:n], want[:n], lr))
            for name, records in runs.items():
                result[name]["vs one process"] = dp_compare(records[:n], want[:n], lr, elementwise=False)
            result["runs agree"] = dp_compare(runs["rank 1 on the plain versions"][:n],
                                              runs["kernels on both ranks"][:n], lr)
            result["f1"] = {f"{name}, step {F1_STEP}": step_ratios(records[n], want[n], lr, F1_STEP)
                            for name, records in [*runs.items(), ("one process, samples swapped", swapped)]}
            del state, want, one, swapped
        del runs

        det = Detector(cfg32).init_weights(SEED)
        clouds = [synthetic_cloud(cfg32.max_points, N_POINTS, seed=SEED + i) for i in range(DP_INFER_FRAMES)]
        points = np.stack(clouds)
        num_points = np.full(DP_INFER_FRAMES, N_POINTS, np.int32)
        infer = eager_sharded_infer(det, mesh)
        infer(points, num_points)  # warm-up
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        got = infer(points, num_points)
        torch.cuda.synchronize()
        result["infer"] = dict(ms=(time.perf_counter() - t0) * 1e3, launches={k: c.launches for k, c in counters.items()},
                               shape=tuple(got.boxes.shape))
        if rank == 0:
            want = det.infer_batch(torch.from_numpy(points).cuda(), torch.from_numpy(num_points).cuda())
            g_np, w_np = [tuple(t.cpu().numpy() for t in d) for d in (got, want)]
            if not np.array_equal(g_np[2], w_np[2]):
                # cuDNN sums in another order at another batch: a near-tie that
                # NMS broke the other way, as phase 13 sees between batch sizes
                swaps = [annos_match(to_annos(cfg32, Detections(*(t[i] for t in got))),
                                     to_annos(cfg32, Detections(*(t[i] for t in want))), f"(c) frame {i}",
                                     det.postprocess.params.nms_iou_threshold) for i in range(DP_INFER_FRAMES)]
                result["infer"]["vs one process"] = f"equal but for NMS near-ties broken the other way: {swaps}"
            elif detections_equal(g_np, w_np, "(c) sharded vs batch 4"):
                result["infer"]["vs one process"] = "bit-equal"
            else:
                result["infer"]["vs one process"] = "valid equal, boxes and scores within the golden tolerances"
        mesh.barrier()
    finally:
        dist.destroy_process_group()
    with open(out / f"gloo-{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


def eager_sharded_infer(det, mesh):
    """`make_sharded_infer`'s body, eager: `Detector.infer_batch` on this
    rank's slice of host arrays and the three gathers (a gloo group on the
    card, which no CUDA graph captures)."""
    from det3d_tpu_torch.parallel import mesh as pm
    from det3d_tpu_torch.postprocess import Detections

    def infer(points: np.ndarray, num_points: np.ndarray):
        sl = pm.local_slice(mesh, len(points))
        out = det.infer_batch(torch.from_numpy(points[sl]).cuda(), torch.from_numpy(num_points[sl]).cuda())
        return Detections(mesh.all_gather(out.boxes), mesh.all_gather(out.scores),
                          mesh.all_gather(out.valid.to(torch.uint8)).bool())

    return infer


def run_ranks(procs, what: str, timeout: float = DP_TIMEOUT_S) -> None:
    """Start the ranks' processes and join them within `timeout` seconds; a
    rank still alive then is killed, and it or a non-zero exit fails the
    phase."""
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [i for i, p in enumerate(procs) if p.is_alive()]
        check(not hung, f"{what}: ranks {hung} still running after {timeout} s")
        codes = [p.exitcode for p in procs]
        check(codes == [0] * len(procs), f"{what}: exit codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)


def run_data_parallel(card: str, base: dict) -> tuple[dict, dict, dict]:
    """Phase 15: (a), (d) and (e) in one process, then (b) and (c) in two,
    each group's ranks spawned with a file:// rendezvous in a temporary
    directory; prints every result beside phase 7's numbers in `base` and
    checks them → the launches of each path per rank, for the kernels line,
    (b)'s ungated F1_STEP ratios, and the kernels per replay of the
    captured step and sharded inference (profiler)."""
    ctx = multiprocessing.get_context("spawn")
    root = Path(tempfile.mkdtemp(prefix="det3d-dp-"))
    try:
        run_ranks([ctx.Process(target=dp_world1_child, args=(str(root),))], "(a)/(d)/(e) world 1, NCCL",
                  W1_TIMEOUT_S)
        with open(root / "world1.pkl", "rb") as f:
            w1 = pickle.load(f)
        run_ranks([ctx.Process(target=dp_gloo_child, args=(r, str(root))) for r in range(2)],
                  "(b)/(c) two gloo ranks")
        gloo = []
        for r in range(2):
            with open(root / f"gloo-{r}.pkl", "rb") as f:
                gloo.append(pickle.load(f))
    finally:
        shutil.rmtree(root, ignore_errors=True)

    plain, again, dp, cap = w1["plain"], w1["plain again"], w1["data-parallel"], w1["captured"]
    print(f"[{card}] (a) world 1, {w1['backend']} on {w1['device']}: loss by step, plain {plain['losses']}, "
          f"data-parallel {dp['losses']}, captured {cap['losses']}")
    check(not same_bits(plain, again), f"(a) two plain runs differ: {same_bits(plain, again)[:5]}")
    differ = same_bits(plain, dp)
    check(not differ, f"(a) the world-1 step differs from the plain step in {differ[:5]}")
    print(f"[{card}] (a) after {DP_STEPS} steps the eager data-parallel weights, batch statistics, Adam moments and "
          f"step equal the plain step's bit for bit (cuDNN deterministic; two plain runs bit-equal too)")
    f32 = w1["f32 captured vs eager"]
    print(f"[{card}] (a) f32, the captured make_sharded_train_step against the eager body in lockstep, "
          f"{DP_STEPS} steps: bit-equal after every step {[not d for d in f32]} (losses, counts, parameters, running "
          f"statistics, moments); bf16 after {DP_STEPS} steps: {not same_bits(cap, dp)}")
    check(not any(f32), f"(a) the captured f32 step differs from the eager one in {f32}")
    for name in ("plain", "data-parallel", "captured", "plain again", "data-parallel again", "captured again"):
        run = w1[name]
        device = "not measured" if run["device"] is None else \
            f"{run['device']:.3f} ms ({100 * run['device'] / run['ms']:.1f} % busy)"
        print(f"[{card}] (a) {name}: ms/step median {run['ms']:.3f} (min {run['min']:.3f}, max {run['max']:.3f}) "
              f"over {DP_TIMED_STEPS} steps; device {device}; peak {run['peak']} bytes; held reserved "
              f"{run['held']} bytes; host-card syncs of a step {run['syncs']}; collectives per step "
              f"{run['collectives']}; NCCL events per step (profiler) {run['nccl']}; hand-written kernels per step "
              f"(profiler) {run['per_call']}")
    print(f"[{card}] (a) beside them, phase 7's step in this run: ms/step median {base['step_ms']:.3f}, "
          f"device {base['step_device']}, peak {base['step_peak']} bytes")
    want = {k: 1.0 for k in TRAIN_COUNTERS}
    want["nms"] = 0.0
    print(f"[{card}] (a) kernel launches per step, world 1: eager {dp['launches']}; captured (wrappers: 0 in "
          f"replays) {cap['launches']}")
    check(dp["launches"] == want, f"(a) launches per step {dp['launches']}, expected {want}")
    check(not any(cap["launches"].values()), f"(a) a replay ran a wrapper: {cap['launches']}")
    train_calls = {k: float(k in ("scatter_to_bev", "scatter_to_bev_bwd", "matcher_gt_max", "matcher_assign",
                                  "fence_copy")) for k in PROFILER_KERNELS}
    check(cap["per_call"] is None or cap["per_call"] == train_calls, f"(a) kernels per replay {cap['per_call']}")
    for name in ("data-parallel", "captured", "data-parallel again", "captured again"):
        check(w1[name]["collectives"] == {"all_reduce": 7}, f"(a) {name}: collectives per step "
                                                            f"{w1[name]['collectives']}")
    check(cap["syncs"] == 0, f"(a) the captured step synchronised {cap['syncs']} times")
    check(plain["collectives"] == {}, f"(a) the plain step issued collectives {plain['collectives']}")

    app = w1["app"]
    print(f"[{card}] (d) train --synthetic at world 1 ({w1['backend']}) through the captured step: {app['steps']} "
          f"steps, ms/step {[round(v, 3) for v in app['ms_per_step']]}, files {app['files']}, captures "
          f"{app['captures']}, launches {app['launches']} (the warm-up calls and the capture)")
    check(app["steps"] == DP_APP_STEPS and "latest.pth" in app["files"] and f"{DP_APP_STEPS}.pth" in app["files"],
          f"(d) steps {app['steps']}, files {app['files']}")
    check(app["captures"] == 1, f"(d) {app['captures']} captures")
    check(not app["restored"], f"(d) the restored checkpoint differs in {app['restored'][:5]}")
    want_app = {k: CAPTURE_LAUNCHES for k in TRAIN_COUNTERS}
    want_app["nms"] = 0
    check(app["launches"] == want_app, f"(d) launches {app['launches']}, expected {want_app}")
    print(f"[{card}] (d) rank 0's latest.pth restores into a fresh trainer bit-equal (weights, batch statistics, "
          "Adam moments, step)")
    inf, iapp = w1["infer"], w1["infer_app"]
    print(f"[{card}] (e) the captured make_sharded_infer of {DP_INFER_FRAMES} frames on the world-1 group against "
          f"Detector.infer_batch: bit-equal {inf['bit_equal']}; collectives a call {inf['collectives']}; captures "
          f"{inf['captures']}; device {inf['device']} ms a call; hand-written kernels per replay (profiler) "
          f"{inf['per_call']}; NCCL events per replay (profiler) {inf['nccl']}")
    print(f"[{card}] (e) infer --synthetic --batch {INFER_BATCH} on the world-1 group through the captured "
          f"make_sharded_infer: {iapp['avg_ms']:.3f} ms/frame over {iapp['frames']} frames, evaluated "
          f"{iapp['evaluated']}")
    check(inf["bit_equal"], "(e) the captured sharded infer differs from infer_batch")
    check(inf["collectives"] == {"all_gather": 3} and inf["captures"] == [1], f"(e) {inf}")
    check(inf["per_call"] is None or inf["per_call"] == {k: float(v) for k, v in INFER_CALLS.items()},
          f"(e) kernels per replay {inf['per_call']}")
    check(iapp["frames"] == APP_FRAMES and iapp["evaluated"], f"(e) infer_app {iapp}")

    r0, r1 = gloo
    kernels_run, plain_run = "kernels on both ranks", "rank 1 on the plain versions"
    fmt = lambda worst: ", ".join(f"{k} {v:.3f} ({at})" for k, (v, at) in worst.items())  # noqa: E731
    print(f"[{card}] (b) two gloo ranks sharing the card, f32, batch 1 each, {DP_GLOO_STEPS} steps; one process at "
          f"batch 2: loss {r0['one process']['losses']}")
    print(f"[{card}] (b) the one-process step against itself with its two samples swapped, worst over its bound: "
          f"elementwise {fmt(r0['swapped']['elementwise'])}; by norm {fmt(r0['swapped']['by_norm'])}")
    for name in (kernels_run, plain_run):
        for r in (r0, r1):
            print(f"[{card}] (b) {name}, rank {r['rank']}: loss {r[name]['losses']}; ms/step "
                  f"{[round(v, 3) for v in r[name]['ms']]} (two ranks on one card through the host: not a scaling "
                  f"number); launches {r[name]['launches']}")
        check(r0[name]["digest"] == r1[name]["digest"], f"(b) {name}: the ranks' states differ")
        worst = r0[name]["vs one process"]
        print(f"[{card}] (b) {name} vs one process (gradients by norm), worst of each over its bound: {fmt(worst)}")
        check(all(v <= 1.0 for v, _ in worst.values()), f"(b) {name} vs one process: {worst}")
    worst = r0["runs agree"]
    print(f"[{card}] (b) the two runs against each other (elementwise, phase 8's tolerances), worst over its "
          f"bound: {fmt(worst)}")
    check(all(v <= 1.0 for v, _ in worst.values()), f"(b) the runs disagree: {worst}")
    want_k = {k: DP_GLOO_STEPS for k in TRAIN_COUNTERS}
    want_k["nms"] = 0
    for r in (r0, r1):
        check(r[kernels_run]["launches"] == want_k, f"(b) rank {r['rank']} launches {r[kernels_run]['launches']}")
    check(r0[plain_run]["launches"] == want_k, f"(b) rank 0 launches {r0[plain_run]['launches']}")
    check(not any(r1[plain_run]["launches"].values()), f"(b) rank 1 on plain launched {r1[plain_run]['launches']}")
    for name, worst in r0["f1"].items():
        print(f"[{card}] (b) F1, measured and not gated: {name} vs one process, each over phase 15(b)'s bound for "
              f"that step: {fmt(worst)}")

    print(f"[{card}] (c) make_sharded_infer's eager body over two gloo ranks, {DP_INFER_FRAMES} frames of {N_POINTS} points, "
          f"f32: detections {r0['infer']['shape']} on every rank; vs Detector.infer_batch at batch "
          f"{DP_INFER_FRAMES} in one process: {r0['infer']['vs one process']}")
    for r in (r0, r1):
        print(f"[{card}] (c) rank {r['rank']}: {r['infer']['ms']:.3f} ms for the call; launches {r['infer']['launches']}")
        want_i = {k: 0 for k in TRAIN_COUNTERS}
        want_i.update(scatter_fwd=1, nms=1)
        check(r["infer"]["launches"] == want_i, f"(c) rank {r['rank']} launches {r['infer']['launches']}")
    check(r1["infer"]["shape"] == r0["infer"]["shape"], "(c) the ranks gathered other shapes")
    return {
        "(a) per step, world 1 NCCL": dp["launches"],
        "(b) rank 0, 2 steps": r0[kernels_run]["launches"],
        "(b) rank 1, 2 steps": r1[kernels_run]["launches"],
        "(c) rank 0": r0["infer"]["launches"],
        "(c) rank 1": r1["infer"]["launches"],
        "(d) app, 3 steps": app["launches"],
    }, r0["f1"], {"dp step": cap["per_call"], "sharded infer": inf["per_call"]}


# --- phase 16: the spatial modes (each group of ranks in processes of its own) ---


def counts_delta(before: dict, after: dict) -> dict:
    """The collectives between two `collective_counts` readings (by group
    for a hybrid grid), only the kinds that moved."""
    if after and isinstance(next(iter(after.values())), dict):
        return {g: counts_delta(before.get(g, {}), after[g]) for g in after}
    return {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}


def detection_arrays(d) -> tuple:
    return tuple(t.cpu().numpy() for t in d)


def spatial_timed(fn, n: int, counters, counted=None, syncs: bool = True) -> dict:
    """`fn()` n times after one warm-up call (a captured call's warm-up
    calls and capture), the launch counters set to 0 just before and read
    just after: ms per call (host clock around the call + synchronize),
    peak memory, launches and collectives per call (of `counted`, a mesh),
    the profiler's device ms, hand-written kernels and NCCL events per
    call, with `syncs` the host-card syncs of one call, and the bytes held
    reserved over those reserved before the warm-up (a captured call's
    graph pool and static buffers)."""
    from det3d_tpu_torch.parallel import mesh as pm

    torch.cuda.empty_cache()
    start = torch.cuda.memory_reserved()
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    before = {} if counted is None else pm.collective_counts(counted)
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    collectives = {} if counted is None else counts_delta(before, pm.collective_counts(counted))
    out = dict(ms=statistics.median(times), min=min(times), max=max(times), n=n,
               peak=torch.cuda.max_memory_allocated(), launches={k: c.launches for k, c in counters.items()},
               collectives=collectives)
    out["per_call"], out["device"], _, out["nccl"] = profiled_calls(lambda _: fn(), [None] * 2)
    out["syncs"] = len(count_syncs(fn)) if syncs else None
    torch.cuda.empty_cache()
    out["held"] = torch.cuda.memory_reserved() - start
    return out


def host_split(fn, n: int) -> dict[str, float]:
    """The host's self CPU ms per call of `fn` from a torch.profiler trace:
    all of it, and the spatial path's own parts (the halo exchange's and
    the InstanceNorm's autograd functions, the collectives' bookkeeping and
    calls)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = collections.defaultdict(float)
    for e in prof.key_averages():
        ms = e.self_cpu_time_total / 1e3 / n
        out["total"] += ms
        for part in ("_HaloExchange", "_SpatialInstanceNorm", "record_param_comms", "c10d::"):
            if e.key.startswith(part):
                out[part] += ms
    return dict(out)


def spatial_steps(step, trainer, state, batch, n: int) -> list[dict]:
    records = []
    for _ in range(n):
        state, loss, _ = step(state, batch)
        records.append(dp_step_record(trainer, state, loss))
    return records


def spatial_world1_child(out_dir: str) -> None:
    """Phase 16(a), in a process of its own: a world-1 NCCL group on
    cuda:0, cuDNN deterministic. f32: the eager spatial `Detector.infer`
    against the plain detector on SP_FRAMES_W1 frames (phase 5's
    tolerances) and the captured `make_spatial_infer` against the eager
    spatial frame, bit for bit; the eager (1, 1) hybrid step
    (`Trainer.train_step(..., mesh=)`) against the plain step, SP_STEPS
    steps at batch 2 (phase 8's), and the captured `make_spatial_train`
    against the eager hybrid step in lockstep, bit for bit; then bf16,
    each path timed in turns (plain, eager spatial, captured, eager
    spatial, captured) with its launches, collectives, kernels per call and
    the reserve it holds."""
    import gc

    import torch.distributed as dist

    from det3d_tpu_torch.config import load_config
    from det3d_tpu_torch.data.synthetic import synthetic_cloud
    from det3d_tpu_torch.kernels import norm_cuda
    from det3d_tpu_torch.parallel import mesh as pm
    from det3d_tpu_torch.pipeline import Detector
    from det3d_tpu_torch.train.trainer import Trainer, host_batch

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = Path(out_dir)
    cfg = load_config("configs/ntusl_20cm.json", max_points=120_000)
    cfg32 = cfg.replace(compute_dtype="float32")
    clouds = [synthetic_cloud(cfg.max_points, N_POINTS, seed=SEED + 300 + i) for i in range(SP_FRAMES_W1 + 1)]
    counters = train_counters()
    mesh = pm.make_spatial_mesh(device="cuda:0", rank=0, world_size=1, init_method=f"file://{out}/rendezvous-s1")
    result = {"backend": mesh.backend, "device": str(mesh.device)}
    try:
        det, infer = pm.make_spatial_infer(cfg32, mesh)
        det.init_weights(SEED)
        plain = Detector(cfg32).init_weights(SEED)
        plain.model.rpn.in_relu = norm_cuda.in_relu_plain  # the spatial path's InstanceNorms are plain pairs
        equal, captured_equal, per_frame, captured_per_frame = 0, [], [], []
        for pts in clouds[1:]:
            before = pm.collective_counts(mesh)
            eager = detection_arrays(det.infer(torch.from_numpy(pts).cuda(), N_POINTS))
            middle = pm.collective_counts(mesh)
            got = detection_arrays(infer(pts, N_POINTS))
            per_frame.append(counts_delta(before, middle))
            captured_per_frame.append(counts_delta(middle, pm.collective_counts(mesh)))
            captured_equal.append(all(np.array_equal(a, b) for a, b in zip(got, eager)))
            want = detection_arrays(plain.infer(torch.from_numpy(pts).cuda(), N_POINTS))
            equal += detections_equal(eager, want, "16(a) f32 spatial vs plain frame")
        result["infer_f32"] = dict(bit_equal=equal, collectives=per_frame, captured_equal=captured_equal,
                                   captured_collectives=captured_per_frame, captures=det.infer_jit.captures)
        del det, infer, plain
        collect_graphs()
        batch = host_batch(cfg32, train_scenes(cfg32, SEED))
        hybrid = pm.make_hybrid_mesh(1, 1, device="cuda:0")

        def make(captured: bool, config=cfg32):
            trainer, step = pm.make_spatial_train(config, hybrid)
            state = pm.replicated(hybrid.world, trainer, trainer.init_state(SEED))
            return trainer, state, step if captured else functools.partial(trainer.train_step, mesh=hybrid)

        records = {}
        for name in ("plain", "spatial"):
            if name == "plain":
                trainer = Trainer(cfg32)
                state, step = trainer.init_state(SEED), trainer.train_step
            else:
                trainer, state, step = make(False)
            before = pm.collective_counts(hybrid)
            records[name] = spatial_steps(step, trainer, state, batch, SP_STEPS)
            result.setdefault("train_collectives", {})[name] = counts_delta(before, pm.collective_counts(hybrid))
            lr = state.lr
            del trainer, state, step
        result["train_f32"] = dict(vs_plain=dp_compare(records["spatial"], records["plain"], lr),
                                   differ=same_bits(records["spatial"][-1], records["plain"][-1]),
                                   losses={k: [r["loss"]["loss"] for r in v] for k, v in records.items()})
        del records
        collect_graphs()
        result["train_f32"]["captured vs eager"] = lockstep_steps(make, batch, SP_STEPS)
        collect_graphs()

        frames_iter = itertools.cycle(clouds)
        for name in ("plain", "spatial", "captured", "spatial again", "captured again"):
            if name == "plain":
                det = Detector(cfg)
                fn = lambda: det.infer(torch.from_numpy(next(frames_iter)).cuda(), N_POINTS)  # noqa: E731
            else:
                det, infer = pm.make_spatial_infer(cfg, mesh)
                fn = (lambda: infer(next(frames_iter), N_POINTS)) if name.startswith("captured") else \
                    (lambda: det.infer(torch.from_numpy(next(frames_iter)).cuda(), N_POINTS))
            det.init_weights(SEED)
            result[f"infer {name}"] = spatial_timed(fn, SP_FRAMES_W1, counters, mesh)
            if name in ("plain", "spatial"):
                detect = eager_detect(det)
                result[f"infer {name}"]["host"] = host_split(lambda: detect(next(frames_iter)), 3)
            del det, fn
            collect_graphs()
        batch = host_batch(cfg, train_scenes(cfg, SEED))
        for name in ("plain", "spatial", "captured", "spatial again", "captured again"):
            if name == "plain":
                trainer = Trainer(cfg)
                state, step = trainer.init_state(SEED), trainer.train_step
            else:
                trainer, state, step = make(name.startswith("captured"), cfg)
            result[f"train {name}"] = spatial_timed(lambda: step(state, batch), SP_STEPS, counters, hybrid)
            del trainer, state, step
            collect_graphs()
    finally:
        gc.collect()  # every captured graph goes before the communicator its kernels use
        torch.cuda.synchronize()
        dist.destroy_process_group()
    with open(out / "spatial-world1.pkl", "wb") as f:
        pickle.dump(result, f)


def check_slab_scatter(grid_xy, v: int, c: int, sp: int) -> dict:
    """The dense scatter into each of `sp` slabs (the pillars' x shifted by
    the slab's first row, a grid of the slab's rows) against the full
    canvas's rows, and its backward against the full backward of a
    cotangent that is zero outside the slab, bit for bit, f32 and bf16, at
    the 20 cm shapes; the pillars outside the slab get zero."""
    from det3d_tpu_torch.kernels import scatter_cuda as sc
    from det3d_tpu_torch.parallel.spatial import slab_bounds

    gen = torch.Generator().manual_seed(SEED + 5)
    nx, ny = grid_xy
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        feats, coors = scatter_inputs(v, c, grid_xy, 12_000, dtype, gen)
        full = sc.scatter_to_bev(feats, coors, grid_xy)
        g_full = torch.randn((1, nx, ny, c), generator=gen).to(dtype).cuda()
        for lo, hi in slab_bounds(nx, sp)[0]:
            shifted = torch.cat([coors[..., :1] - lo, coors[..., 1:]], dim=-1).contiguous()
            slab = sc.scatter_to_bev(feats, shifted, (hi - lo, ny))
            check(torch.equal(bits(slab), bits(full[:, lo:hi])), f"slab [{lo}, {hi}) {dtype}: not the canvas's rows")
            fs = feats.clone().requires_grad_()
            sc.scatter_to_bev(fs, shifted, (hi - lo, ny)).backward(g_full[:, lo:hi].contiguous())
            gz = torch.zeros_like(g_full)
            gz[:, lo:hi] = g_full[:, lo:hi]
            fw = feats.clone().requires_grad_()
            sc.scatter_to_bev(fw, coors, grid_xy).backward(gz)
            inside = (coors[..., 0] >= lo) & (coors[..., 0] < hi)
            check(torch.equal(bits(fs.grad), bits(fw.grad)), f"slab [{lo}, {hi}) {dtype}: backward differs")
            check(not fs.grad[~inside].any(), f"slab [{lo}, {hi}) {dtype}: gradient outside the slab")
            result[f"{dtype} [{lo}, {hi})"] = int(inside.sum())
    torch.cuda.synchronize()
    return result


def spatial_gloo_child(rank: int, out_dir: str) -> None:
    """Phase 16(b) and (c), rank `rank` of two gloo ranks that share cuda:0
    (NCCL refuses two ranks on one card), sp = 2. (b) rank 0 holds the slab
    scatter and its backward against the full canvas, bit for bit; then
    `make_spatial_infer` over SP_FRAMES_GLOO f32 frames, held by rank 0
    against the one-process detector (which it runs first, for its peak);
    then `make_spatial_train` at (1, 2), f32, batch 2, SP_STEPS steps, held
    by rank 0 against the one-process step (gradients by norm). (c)
    ntusl_10cm at (1, 2), bf16, batch 2: one warm-up step and SP10_STEPS
    timed, each rank's peak. A gloo group on a card runs the eager forms
    by name (`Detector.infer`, `Trainer.train_step(..., mesh=)`): no CUDA
    graph captures its collectives."""
    import hashlib

    import torch.distributed as dist

    from det3d_tpu_torch.config import load_config
    from det3d_tpu_torch.data.synthetic import synthetic_cloud
    from det3d_tpu_torch.kernels import norm_cuda
    from det3d_tpu_torch.parallel import mesh as pm
    from det3d_tpu_torch.pipeline import Detector
    from det3d_tpu_torch.postprocess import Detections, to_annos
    from det3d_tpu_torch.train.trainer import Trainer, host_batch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = Path(out_dir)
    cfg = load_config("configs/ntusl_20cm.json", max_points=120_000)
    cfg32 = cfg.replace(compute_dtype="float32")
    counters = train_counters()
    mesh = pm.make_spatial_mesh(device="cuda:0", backend="gloo", rank=rank, world_size=2,
                                init_method=f"file://{out}/rendezvous-s2")
    result = {"rank": rank, "backend": mesh.backend}
    try:
        if rank == 0:
            result["slab"] = check_slab_scatter((cfg.grid_size[0], cfg.grid_size[1]), cfg.max_voxels, 64, 2)
        clouds = [synthetic_cloud(cfg.max_points, N_POINTS, seed=SEED + 400 + i) for i in range(SP_FRAMES_GLOO + 1)]
        if rank == 0:
            plain = Detector(cfg32).init_weights(SEED)
            plain.model.rpn.in_relu = norm_cuda.in_relu_plain  # the spatial path's InstanceNorms are plain pairs
            plain.infer(torch.from_numpy(clouds[0]).cuda(), N_POINTS)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            want = [detection_arrays(plain.infer(torch.from_numpy(p).cuda(), N_POINTS)) for p in clouds[1:]]
            result["infer one process peak"] = torch.cuda.max_memory_allocated()
            del plain
            torch.cuda.empty_cache()
        det, _ = pm.make_spatial_infer(cfg32, mesh)
        det.init_weights(SEED)
        got = []
        frames_iter = itertools.cycle(clouds)
        infer = lambda pts, n: det.infer(torch.from_numpy(pts).cuda(), n)  # noqa: E731  (gloo: the eager frame)
        result["infer"] = spatial_timed(lambda: got.append(detection_arrays(infer(next(frames_iter), N_POINTS))),
                                        SP_FRAMES_GLOO, counters, mesh, syncs=False)  # gloo syncs on every op
        got = got[1:1 + SP_FRAMES_GLOO]  # the warm-up frame out, the profiler's frames out
        if rank == 0:
            verdicts = []
            for i, (g, w) in enumerate(zip(got, want)):
                if all(np.array_equal(a, b) for a, b in zip(g, w)):
                    verdicts.append("bit-equal")
                    continue
                if not np.array_equal(g[2], w[2]):
                    # a near-tie that NMS broke the other way, as phases 13 and 15 see
                    swaps = annos_match(to_annos(cfg32, Detections(*map(torch.from_numpy, g))),
                                        to_annos(cfg32, Detections(*map(torch.from_numpy, w))), f"16(b) frame {i}",
                                        det.postprocess.params.nms_iou_threshold)
                    verdicts.append(f"NMS near-ties broken the other way: {swaps}")
                    continue
                v = w[2]
                check(np.allclose(g[1][v], w[1][v], rtol=0, atol=2e-3)
                      and np.allclose(g[0][v], w[0][v], rtol=5e-3, atol=1e-2), f"16(b) frame {i}: outside tolerance")
                verdicts.append(f"valid equal; scores max diff {np.abs(g[1] - w[1])[v].max(initial=0.0):.2e}, "
                                f"boxes {np.abs(g[0] - w[0])[v].max(initial=0.0):.2e}")
            result["infer"]["vs one process"] = verdicts
        del det, infer, got
        torch.cuda.empty_cache()

        batch = host_batch(cfg32, train_scenes(cfg32, SEED))
        if rank == 0:
            trainer = Trainer(cfg32)
            state = trainer.init_state(SEED)
            trainer.train_step(state, batch)  # the peak of a step after the first, as below
            state = trainer.init_state(SEED)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            want = spatial_steps(trainer.train_step, trainer, state, batch, SP_STEPS)
            result["train one process peak"] = torch.cuda.max_memory_allocated()
            lr = state.lr
            del trainer, state
            torch.cuda.empty_cache()
        hybrid = pm.make_hybrid_mesh(1, 2, device="cuda:0")
        trainer, _ = pm.make_spatial_train(cfg32, hybrid)
        step = functools.partial(trainer.train_step, mesh=hybrid)  # gloo: the eager step
        state = pm.replicated(hybrid.world, trainer, trainer.init_state(SEED))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        before = pm.collective_counts(hybrid)
        t0 = time.perf_counter()
        records = spatial_steps(step, trainer, state, batch, SP_STEPS)
        torch.cuda.synchronize()
        result["train"] = dict(ms=(time.perf_counter() - t0) * 1e3 / SP_STEPS, peak=torch.cuda.max_memory_allocated(),
                               launches={k: c.launches for k, c in counters.items()},
                               collectives=counts_delta(before, pm.collective_counts(hybrid)),
                               losses=[r["loss"]["loss"] for r in records])
        digest = hashlib.sha256(b"".join(t.numpy().tobytes() for t in [*records[-1]["sd"].values(),
                                                                         *records[-1]["moments"]]))
        result["train"]["digest"] = digest.hexdigest()
        if rank == 0:
            # the gate: phase 15(b)'s steps; the rest measured (their weights drift by Adam's sign flips)
            result["train"]["vs one process"] = dp_compare(records[:DP_GLOO_STEPS], want[:DP_GLOO_STEPS], lr,
                                                           elementwise=False)
            result["train"]["vs one process, every step"] = dp_compare(records, want, lr, elementwise=False)
            result["train"]["f1"] = step_ratios(records[F1_STEP - 1], want[F1_STEP - 1], lr, F1_STEP)
            del want
        del trainer, state, step, records
        torch.cuda.empty_cache()

        cfg10 = load_config("configs/ntusl_10cm.json", max_points=120_000)
        batch10 = host_batch(cfg10, train_scenes(cfg10, SEED))
        trainer, _ = pm.make_spatial_train(cfg10, hybrid)
        step = functools.partial(trainer.train_step, mesh=hybrid)
        state = pm.replicated(hybrid.world, trainer, trainer.init_state(SEED))
        step(state, batch10)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        times, losses = [], []
        for _ in range(SP10_STEPS):
            t0 = time.perf_counter()
            state, loss, _ = step(state, batch10)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss["loss"]))
        result["10cm"] = dict(ms=times, peak=torch.cuda.max_memory_allocated(), losses=losses,
                              launches={k: c.launches for k, c in counters.items()})
        del trainer, state, step
        mesh.barrier()
    finally:
        dist.destroy_process_group()
    with open(out / f"spatial-gloo-{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


def run_spatial(card: str, base: dict) -> tuple[dict, dict]:
    """Phase 16: (a) in one process, then (b) and (c) in two, each group's
    ranks spawned with a file:// rendezvous in a temporary directory;
    prints every result beside the numbers of phases 4 and 7 in `base` and
    checks them → the launches of each path per rank, for the kernels
    line, and the kernels per replay of the captured frame and step
    (profiler)."""
    ctx = multiprocessing.get_context("spawn")
    root = Path(tempfile.mkdtemp(prefix="det3d-spatial-"))
    try:
        run_ranks([ctx.Process(target=spatial_world1_child, args=(str(root),))], "16(a) world 1, NCCL",
                  SP_TIMEOUT_S)
        with open(root / "spatial-world1.pkl", "rb") as f:
            w1 = pickle.load(f)
        run_ranks([ctx.Process(target=spatial_gloo_child, args=(r, str(root))) for r in range(2)],
                  "16(b)/(c) two gloo ranks", SP_TIMEOUT_S)
        gloo = []
        for r in range(2):
            with open(root / f"spatial-gloo-{r}.pkl", "rb") as f:
                gloo.append(pickle.load(f))
    finally:
        shutil.rmtree(root, ignore_errors=True)

    n_convs, n_norms = 16, 19
    per_frame = {"all_gather": n_convs + 1, "all_reduce": n_norms}
    per_step = {"spatial": {"all_gather": 2 * n_convs + 1, "all_reduce": 2 * n_norms}, "data": {"all_reduce": 6},
                "world": {"all_reduce": 1}}
    inf = w1["infer_f32"]
    print(f"[{card}] (a) world 1, {w1['backend']} on {w1['device']}, f32: the eager spatial frame vs the plain "
          f"detector over {SP_FRAMES_W1} frames: {inf['bit_equal']} bit-equal, the rest within phase 5's tolerances; "
          f"collectives per frame {inf['collectives'][0]}; the captured make_spatial_infer vs the eager spatial "
          f"frame: bit-equal {inf['captured_equal']}, collectives per frame {inf['captured_collectives'][0]}, "
          f"captures {inf['captures']}")
    check(all(c == per_frame for c in inf["collectives"] + inf["captured_collectives"]),
          f"(a) collectives per frame {inf['collectives']}, captured {inf['captured_collectives']}")
    check(all(inf["captured_equal"]) and inf["captures"] == 1, f"(a) the captured frame: {inf['captured_equal']}")
    tr = w1["train_f32"]
    fmt = lambda worst: ", ".join(f"{k} {v:.3f} ({at})" for k, (v, at) in worst.items())  # noqa: E731
    print(f"[{card}] (a) f32 eager (1, 1) hybrid step vs the plain step, {SP_STEPS} steps at batch 2: loss "
          f"{tr['losses']}; bit-equal: {not tr['differ']}; worst of each over phase 8's bound: {fmt(tr['vs_plain'])}")
    print(f"[{card}] (a) f32 captured make_spatial_train (1, 1) vs the eager hybrid step in lockstep, {SP_STEPS} "
          f"steps: bit-equal after every step {[not d for d in tr['captured vs eager']]}")
    check(all(v <= 1.0 for v, _ in tr["vs_plain"].values()), f"(a) spatial step vs plain: {tr['vs_plain']}")
    check(not any(tr["captured vs eager"]), f"(a) the captured hybrid step differs in {tr['captured vs eager']}")
    check(w1["infer spatial"]["syncs"] == w1["infer plain"]["syncs"],
          f"(a) host-card syncs of a frame: spatial {w1['infer spatial']['syncs']}, plain {w1['infer plain']['syncs']}")
    check(w1["train_collectives"]["spatial"] == {g: {k: n * SP_STEPS for k, n in d.items()}
                                                 for g, d in per_step.items()},
          f"(a) collectives {w1['train_collectives']}")
    launches, replays = {}, {}
    for what, unit, n_want in (("infer", "frame", dict(scatter_fwd=1, nms=1)),
                               ("train", "step", dict(matcher_gt_max=1, matcher_assign=1, scatter_fwd=1,
                                                      scatter_bwd=1))):
        for name in ("plain", "spatial", "captured", "spatial again", "captured again"):
            run = w1[f"{what} {name}"]
            device = "not measured" if run["device"] is None else \
                f"{run['device']:.3f} ms ({100 * run['device'] / run['ms']:.1f} % busy)"
            per = {k: v / run["n"] for k, v in run["launches"].items()}
            print(f"[{card}] (a) bf16 {what}, {name}: ms/{unit} median {run['ms']:.3f} (min {run['min']:.3f}, max "
                  f"{run['max']:.3f}) over {run['n']}; device {device}; peak {run['peak']} bytes; held reserved "
                  f"{run['held']} bytes; host-card syncs of a {unit} {run['syncs']}; launches per {unit} {per}; "
                  f"collectives over the run {run['collectives']}; NCCL events per {unit} (profiler) {run['nccl']}; "
                  f"hand-written kernels per {unit} (profiler) {run['per_call']}")
            if "host" in run:
                print(f"[{card}] (a) bf16 detect, {name}: host self CPU ms per frame (torch.profiler, 3 frames) "
                      f"{({k: round(v, 3) for k, v in run['host'].items()})}")
        want = {k: 0 for k in TRAIN_COUNTERS}
        want.update({k: v * w1[f"{what} spatial"]["n"] for k, v in n_want.items()})
        if what == "train":
            want["fence"] = 0
        check(w1[f"{what} spatial"]["launches"] == want, f"(a) {what} launches {w1[f'{what} spatial']['launches']}")
        launches[f"(a) {what}, world 1 NCCL, {w1[f'{what} spatial']['n']} {unit}s"] = w1[f"{what} spatial"]["launches"]
        cap = w1[f"{what} captured"]
        check(not any(cap["launches"].values()), f"(a) a captured {unit}'s replay ran a wrapper: {cap['launches']}")
        calls = {k: 0.0 for k in PROFILER_KERNELS}
        calls.update({"infer": {"scatter_to_bev": 1.0, "nms_keep": 1.0},
                      "train": {"scatter_to_bev": 1.0, "scatter_to_bev_bwd": 1.0, "matcher_gt_max": 1.0,
                                "matcher_assign": 1.0}}[what])
        check(cap["per_call"] is None or cap["per_call"] == calls, f"(a) captured {unit}: kernels {cap['per_call']}")
        one = per_frame if what == "infer" else per_step
        want_c = {g: {k: n * cap["n"] for k, n in d.items()} for g, d in one.items()} if what == "train" else \
            {k: n * cap["n"] for k, n in one.items()}
        check(cap["collectives"] == want_c, f"(a) captured {unit}: collectives {cap['collectives']}")
        check(cap["syncs"] == 0 or what == "infer", f"(a) the captured step synchronised {cap['syncs']} times")
        replays[f"spatial {'frame' if what == 'infer' else 'step'}"] = cap["per_call"]
    print(f"[{card}] (a) beside them, phase 4's frame {base['frame_ms']:.3f} ms and peak {base['frame_peak']} bytes; "
          f"phase 7's step {base['step_ms']:.3f} ms and peak {base['step_peak']} bytes")

    r0, r1 = gloo
    print(f"[{card}] (b) slab scatter and its backward, 2 slabs of the 20 cm canvas, f32 and bf16: bit-equal to the "
          f"full canvas's rows (pillars per slab {r0['slab']})")
    for r in (r0, r1):
        run = r["infer"]
        device = "not measured" if run["device"] is None else f"{run['device']:.3f} ms"
        print(f"[{card}] (b) rank {r['rank']}, make_spatial_infer f32, sp 2 over gloo: ms/frame median {run['ms']:.3f} "
              f"(two ranks on one card through the host: not a scaling number); device {device}; peak "
              f"{run['peak']} bytes; launches {run['launches']}; collectives {run['collectives']}")
        check(run["launches"] == expected_launches(train_counters(), scatter_fwd=SP_FRAMES_GLOO, nms=SP_FRAMES_GLOO),
              f"(b) rank {r['rank']} inference launches {run['launches']}")
        check(run["collectives"] == {k: v * SP_FRAMES_GLOO for k, v in per_frame.items()},
              f"(b) rank {r['rank']} collectives {run['collectives']}")
    print(f"[{card}] (b) the one-process f32 detector's peak {r0['infer one process peak']} bytes; spatial vs one "
          f"process by frame: {r0['infer']['vs one process']}")
    for r in (r0, r1):
        run = r["train"]
        print(f"[{card}] (b) rank {r['rank']}, make_spatial_train (1, 2) f32 batch 2: {run['ms']:.3f} ms/step over "
              f"{SP_STEPS} (through the host); peak {run['peak']} bytes; loss {run['losses']}; launches "
              f"{run['launches']}; collectives {run['collectives']}")
        check(run["launches"] == expected_launches(train_counters(), matcher_gt_max=SP_STEPS, matcher_assign=SP_STEPS,
                                                   scatter_fwd=SP_STEPS, scatter_bwd=SP_STEPS),
              f"(b) rank {r['rank']} train launches {run['launches']}")
        check(run["collectives"] == {g: {k: n * SP_STEPS for k, n in d.items()} for g, d in per_step.items()},
              f"(b) rank {r['rank']} collectives {run['collectives']}")
    check(r0["train"]["digest"] == r1["train"]["digest"], "(b) the ranks' states differ")
    worst = r0["train"]["vs one process"]
    print(f"[{card}] (b) the one-process f32 step's peak {r0['train one process peak']} bytes; spatial vs one process "
          f"(gradients by norm), worst of each over its bound in the first {DP_GLOO_STEPS} steps (phase 15(b)'s): "
          f"{fmt(worst)}; over all {SP_STEPS} (measured, not held: later steps start from weights Adam's first "
          f"update moved ±lr apart): {fmt(r0['train']['vs one process, every step'])}")
    check(all(v <= 1.0 for v, _ in worst.values()), f"(b) spatial step vs one process: {worst}")
    print(f"[{card}] (b) F1, measured and not gated, each over phase 15(b)'s bound for step {F1_STEP}: the (1, 2) "
          f"hybrid step {F1_STEP} vs one process: {fmt(r0['train']['f1'])}")
    for name, worst in base["f1"].items():
        print(f"[{card}] (b) F1, beside it from phase 15(b): {name} vs one process: {fmt(worst)}")
    for r in (r0, r1):
        run = r["10cm"]
        print(f"[{card}] (c) rank {r['rank']}, ntusl_10cm make_spatial_train (1, 2) bf16 batch 2: ms/step "
              f"{[round(v, 3) for v in run['ms']]} (through the host); peak {run['peak']} bytes = "
              f"{run['peak'] / ONE_PROCESS_PEAK_10CM:.3f} of the one-process {ONE_PROCESS_PEAK_10CM} (phase 14(d)); loss {run['losses']}; "
              f"launches {run['launches']}")
        check(all(np.isfinite(run["losses"])), "(c) non-finite loss")
        check(run["launches"] == expected_launches(train_counters(), matcher_gt_max=SP10_STEPS,
                                                   matcher_assign=SP10_STEPS, scatter_fwd=SP10_STEPS,
                                                   scatter_bwd=SP10_STEPS),
              f"(c) rank {r['rank']} launches {run['launches']}")
    check(r0["10cm"]["losses"] == r1["10cm"]["losses"], "(c) the ranks' losses differ")
    for r in (r0, r1):
        launches[f"(b) infer, rank {r['rank']}, {SP_FRAMES_GLOO} frames"] = r["infer"]["launches"]
        launches[f"(b) train, rank {r['rank']}, {SP_STEPS} steps"] = r["train"]["launches"]
        launches[f"(c) 10 cm train, rank {r['rank']}, {SP10_STEPS} steps"] = r["10cm"]["launches"]
    return launches, replays


# --- phase 17: the viewer's device pieces and tune ---


def geometry_cases(gen: np.random.RandomState) -> dict:
    """Seeded float32 inputs of the nine 3D-box and camera functions of
    `ops/geometry.py` → {name: (fn(device) → output, atol)}, at KITTI's
    calibration: boxes as tests/test_geometry.py draws them, lidar points
    in front of the camera and around it, axis-aligned boxes with points on
    their faces."""
    from det3d_tpu_torch.ops import geometry as G

    n = 4096
    boxes = np.concatenate([gen.uniform(-50, 50, (n, 2)), gen.uniform(-2, 2, (n, 1)), gen.uniform(0.5, 8, (n, 3)),
                            gen.uniform(-np.pi, np.pi, (n, 1))], 1).astype(np.float32)
    anchors = np.concatenate([gen.uniform(-50, 50, (n, 2)), gen.uniform(-2, 2, (n, 1)), gen.uniform(0.5, 8, (n, 3)),
                              gen.uniform(-np.pi, np.pi, (n, 1))], 1).astype(np.float32)
    points = np.concatenate([gen.uniform(-10, 60, (20_000, 1)), gen.uniform(-30, 30, (20_000, 1)),
                             gen.uniform(-3, 2, (20_000, 1)), gen.uniform(0, 1, (20_000, 1))], 1).astype(np.float32)
    aligned = np.array([[0, 0, 0, 4, 2, 2, 0], [3.5, -2.25, -1.5, 1.5, 0.75, 1.25, 0]], np.float32)
    faces = np.array([[x + dx, y + dy, z + dz, 0.5] for x, y, z, l, w, h, _ in aligned
                      for dx, dy, dz in [(0, 0, 0), (l / 2, 0, 0), (0, -w / 2, 0), (0, 0, h / 2), (0, 0, -h / 2)]],
                     np.float32)
    near = np.concatenate([boxes[:64], aligned])  # few pairs: a flag decided by the last bit flips rarely
    near[:64, :2] = gen.uniform(-8, 8, (64, 2))
    in_pts = np.concatenate([points[:2000] * [0.2, 0.4, 1, 1], faces]).astype(np.float32)
    cam = np.concatenate([gen.uniform(-20, 20, (n, 2)), gen.uniform(2, 70, (n, 1))], 1).astype(np.float32)
    cal = (KITTI_R0_RECT, KITTI_VELO2CAM)

    def on(a, device):
        return torch.from_numpy(a).to(device)

    def corners(d):
        unit = G.unit_corners_3d((0.5, 0.5, 0.0), d, torch.float32)
        return G.center_to_corner_box3d(on(boxes[:, :3], d), on(boxes[:, 3:6], d), on(boxes[:, 6], d), unit)

    cam_pts = G.lidar_to_camera(on(points, "cpu"), *cal).numpy()
    cam_boxes = G.box_lidar_to_camera(on(boxes, "cpu"), *cal).numpy()
    return {
        "center_to_corner_box3d": (corners, 1e-4),
        "box_lidar_to_camera": (lambda d: G.box_lidar_to_camera(on(boxes, d), *cal), 1e-4),
        "project_to_image": (lambda d: G.project_to_image(on(cam, d), KITTI_P2), 1e-4),
        "lidar_to_camera": (lambda d: G.lidar_to_camera(on(points, d), *cal), 1e-4),
        "camera_to_lidar": (lambda d: G.camera_to_lidar(on(cam_pts, d), *cal), 1e-3),
        "box_camera_to_lidar": (lambda d: G.box_camera_to_lidar(on(cam_boxes, d), *cal), 1e-3),
        "box_encode": (lambda d: G.box_encode(on(boxes, d), on(anchors, d)), 1e-4),
        "points_in_rbbox": (lambda d: G.points_in_rbbox(on(in_pts, d), on(near, d)), 0),
        "corners_to_frustum_mask": (lambda d: G.corners_to_frustum_mask(on(points, d), [0.0, 0.0, 1242.0, 375.0],
                                                                         KITTI_P2, *cal), 0),
    }


def run_viewer_pieces(cfg, card: str) -> None:
    """Phase 17(a): the nine geometry functions on the card against the CPU
    (rtol 1e-5 and the atol beside each, tests/test_torch_geometry_camera.py's;
    the masks equal), the viewer's voxel overlay (`SceneViewer.voxel_coors`,
    the port's voxelizer) on the card equal to the CPU's on a 100k-point
    frame; then a BEV frame and a 3D frame rendered on the card where
    matplotlib is installed, and a line saying which it was."""
    from det3d_tpu_torch.data.synthetic import sample_scene, synthetic_cloud
    from det3d_tpu_torch.viewer.app import SceneViewer

    for name, (fn, atol) in geometry_cases(np.random.RandomState(SEED + 17)).items():
        got, want = fn("cuda").cpu(), fn("cpu")
        check(got.shape == want.shape and got.dtype == want.dtype, f"17(a) {name}: {got.shape} {got.dtype}")
        if got.dtype == torch.bool:
            check(torch.equal(got, want), f"17(a) {name}: {int((got != want).sum())} flags differ")
            print(f"[{card}] (a) {name}: card equal to the CPU ({int(want.sum())} of {want.numel()} true)")
            continue
        err = (got - want).abs().max().item()
        check(torch.allclose(got, want, rtol=1e-5, atol=atol), f"17(a) {name}: max abs diff {err:.3e}")
        print(f"[{card}] (a) {name} {tuple(got.shape)}: card vs CPU max abs diff {err:.3e} (atol {atol}, rtol 1e-5)")
    cloud = synthetic_cloud(cfg.max_points, N_POINTS, seed=SEED + 170)[:N_POINTS]
    viewer = SceneViewer(cfg)
    coors = viewer.voxel_coors(cloud)
    check(np.array_equal(coors, SceneViewer(cfg, device="cpu").voxel_coors(cloud)), "17(a) voxel overlay differs")
    print(f"[{card}] (a) voxel overlay of a {N_POINTS}-point frame on the card: {int((coors[:, 0] >= 0).sum())} "
          f"pillars, coordinates equal to the CPU's")
    if importlib.util.find_spec("matplotlib") is None:
        print(f"[{card}] (a) matplotlib is not installed: no BEV or 3D frame rendered (the renders are host-side; "
              "every check above ran)")
        return
    from det3d_tpu_torch.viewer.render import BEVRenderer
    from det3d_tpu_torch.viewer.render3d import render_scene_3d

    scene = sample_scene(cfg, np.random.RandomState(SEED + 171))
    gt = scene["gt_boxes"]
    dt = np.concatenate([gt[: len(gt) // 2] + np.float32([0.3, 0.2, 0, 0, 0, 0, 0.05]),
                         gt[-2:] + np.float32([6, 6, 0, 0, 0, 0, 0])])  # matches and two false positives
    scores = np.linspace(0.9, 0.3, len(dt))
    root = Path(tempfile.mkdtemp(prefix="det3d-view-"))
    try:
        dr = cfg.detection_range
        bev = (BEVRenderer((dr[0], dr[1], dr[3], dr[4]), device=viewer.device).points(scene["points"])
               .detections_vs_gt(gt, dt, scores).voxel_grid(viewer.voxel_coors(scene["points"]), cfg.voxel_size,
                                                            cfg.detection_offset).save(root / "bev.png"))
        view3d = render_scene_3d(scene["points"], gt, dt, scores, root / "3d.png", device=viewer.device)
        sizes = [bev.stat().st_size, view3d.stat().st_size]
        check(min(sizes) > 10_000, f"17(a) render sizes {sizes}")
        print(f"[{card}] (a) matplotlib installed: a BEV frame ({sizes[0]} bytes, FP/FN match and voxel overlay on "
              f"the card) and a 3D frame ({sizes[1]} bytes) rendered")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def run_tune(card: str) -> dict:
    """Phase 17(b) and (c): `tune` of configs/ntusl_20cm.json at full width
    on the card at the JAX tuner's defaults, (i) as shipped (dense: pack_w
    measured, the five packed-only levers skipped) and (ii) with pack_w on
    and every other lever measured; each run's trials (device ms and host
    ms), its choices and tuned JSON, which must load and build a
    `Detector`; every kernel's launches over each run, the counters set to
    0 just before it and read just after."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from det3d_tpu_torch import tune as T
    from det3d_tpu_torch.config import load_config
    from det3d_tpu_torch.data.synthetic import synthetic_cloud
    from det3d_tpu_torch.pipeline import Detector

    # the tuner's device time: its raw-event sum, and the parsed events' sum of the same trace
    det = Detector(load_config("configs/ntusl_20cm.json", max_points=120_000)).init_weights(SEED)
    pts = torch.from_numpy(synthetic_cloud(det.cfg.max_points, N_POINTS, seed=SEED + 172)).cuda()
    det.infer(pts, N_POINTS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            det.infer(pts, N_POINTS)
        torch.cuda.synchronize()
    raw = T.device_span_ms(prof)
    parsed = sum(e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA) / 1e3
    check(abs(raw - parsed) <= 1e-3 * parsed, f"17(b) the tuner's device time {raw} ms, the parsed trace's {parsed}")
    print(f"[{card}] (b) device time of 3 frames from one trace: the tuner's raw events {raw:.4f} ms, the parsed "
          f"events {parsed:.4f} ms")
    del det, pts, prof
    counters = train_counters(layouts=True)
    others = tuple(n for n, _, _, _ in T.LEVERS if n != "pack_w")
    runs = (("(i) as shipped", {}, None), ("(ii) pack_w on", {"pack_w": True}, others))
    root = Path(tempfile.mkdtemp(prefix="det3d-tune-"))
    launches = {}
    try:
        for i, (name, overrides, levers) in enumerate(runs):
            torch.cuda.synchronize()
            for c in counters.values():
                c.launches = 0
            t0 = time.time()
            report = T.tune("configs/ntusl_20cm.json", out_path=str(root / f"tuned-{i}.json"), only_levers=levers,
                            config_overrides=overrides, device="cuda", **TUNE_ARGS)
            torch.cuda.synchronize()
            launches[name] = {k: c.launches for k, c in counters.items()}
            print(f"[{card}] (b) {name}: {time.time() - t0:.1f} s; timed by {report['timed_by']}")
            trials = {m: v["trials"] for m, v in report["modes"].items()}
            for mode, mode_trials in trials.items():
                for t in mode_trials:
                    check(t["device_ms"] is not None and t["ms"] == t["device_ms"], f"17(b) {name} trial {t}")
                    print(f"[{card}] (b) {name} {mode} {t['levers'] or 'baseline'}: device {t['device_ms']:.4f} ms, "
                          f"host {t['host_ms']:.4f} ms a {'frame' if mode == 'infer' else 'step'}")
            print(f"[{card}] (b) {name}: chosen {report['chosen']}; skipped {report['skipped']}")
            tuned = json.loads(Path(report["out"]).read_text())
            print(f"[{card}] (b) {name}: tuned JSON {json.dumps(tuned)}")
            check(tuned["_tuned_on"] == torch.cuda.get_device_name(0), f"17(b) _tuned_on {tuned['_tuned_on']}")
            cfg_t = load_config(report["out"])
            check(all(getattr(cfg_t, k) == v for k, v in report["chosen"].items()), f"17(b) {name}: choices lost")
            det = Detector(cfg_t).init_weights(SEED)
            d = det.infer(torch.from_numpy(synthetic_cloud(cfg_t.max_points, N_POINTS, seed=SEED + 172)).cuda(),
                          N_POINTS)
            check(bool(torch.isfinite(d.boxes).all()), f"17(b) {name}: the tuned config's detector")
            del det, d
            packed = overrides.get("pack_w") or report["chosen"].get("pack_w") is True
            skipped = {s["lever"]: s["reason"] for s in report["skipped"]}
            want = {} if packed else {k: T.PACKED_ONLY_REASON for k in T.PACKED_ONLY}
            check(skipped == want, f"17(b) {name}: skipped {skipped}, expected {want}")
            # each trial captures its frame or step once: the wrappers
            # launch in the warm-up calls and the capture, never in a replay
            n_infer, n_train = (len(trials.get(m, [])) for m in ("infer", "train"))
            frames, steps = n_infer * CAPTURE_LAUNCHES, n_train * CAPTURE_LAUNCHES
            got = launches[name]
            print(f"[{card}] (c) {name}: launches over the run ({n_infer} infer trials, {n_train} train trials, "
                  f"each captured once): {got}")
            check(got["nms"] == frames and got["matcher_gt_max"] == got["matcher_assign"] == got["fence"] == steps,
                  f"17(c) {name}: launches {got}")
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ii = launches["(ii) pack_w on"]
    check(ii["blocked_fwd"] > 0 and ii["blocked_bwd"] > 0, f"17(c) the blocked pair did not launch in (ii): {ii}")
    idle = [k for k in counters if not any(n[k] for n in launches.values())]
    check(not idle, f"17(c) kernels that tune launched no time: {idle}")
    return launches


def cell_id_frames(cfg) -> list[tuple[str, np.ndarray]]:
    """Phase 18's frames: CELLID_FRAMES // 2 `synthetic_cloud`s of
    CELLID_UNDER_POINTS points, under the 20 cm pillar cap, then as many of
    N_POINTS, over it."""
    from det3d_tpu_torch.data.synthetic import synthetic_cloud

    half = CELLID_FRAMES // 2
    return ([("under the cap", synthetic_cloud(cfg.max_points, CELLID_UNDER_POINTS, seed=SEED + 40 + i))
             for i in range(half)]
            + [("over the cap", synthetic_cloud(cfg.max_points, N_POINTS, seed=SEED + 50 + i)) for i in range(half)])


def cell_ids(coors: torch.Tensor, voxel_num, grid) -> np.ndarray:
    """The linear cell ids of a frame's first `voxel_num` pillar slots."""
    nx, ny, nz = grid
    c = coors[:int(voxel_num)].long().cpu().numpy()
    return c[:, 0] * (ny * nz) + c[:, 1] * nz + c[:, 2]


def run_cell_id_order(cfg, card: str) -> dict:
    """Phase 18: `Detector(cfg, fcfs=False)` at full width, its 8 frames
    through `detect` with the scatter and NMS counters set to 0 just before
    and read just after; against `fcfs=True` frame by frame: under the cap
    the same pillars (slots aside) and the same detections, over it each
    order's own selection (fcfs=True: the first `max_voxels` cells to
    occur; fcfs=False: the `max_voxels` lowest cell ids); the voxelize
    stage's ms and device ms of both orders, in turns."""
    from det3d_tpu_torch.kernels import nms_cuda, scatter_cuda
    from det3d_tpu_torch.ops.voxelize import grid_tensors, voxelize
    from det3d_tpu_torch.pipeline import Detector

    frames = cell_id_frames(cfg)
    by_order = {fcfs: Detector(cfg, fcfs=fcfs).init_weights(SEED) for fcfs in (True, False)}
    det = by_order[False]
    check(not det.module.fcfs and by_order[True].module.fcfs, "the detectors' slot orders")
    counters = {"scatter": scatter_cuda.counter, "nms": nms_cuda.counter}
    run = run_frames(det, [frames[0][1]] + [p for _, p in frames], counters)
    print_run(card, f"Detector(fcfs=False), {run['n']} frames", run)
    check(run["launches"] == {"scatter": run["n"], "nms": run["n"]}, f"fcfs=False launches {run['launches']}")
    spec = det.module.spec
    grid = grid_tensors(spec, torch.device("cuda"))
    every = spec._replace(max_voxels=cfg.max_points)  # a cap no frame reaches: every occupied cell
    for i, (kind, pts_np) in enumerate(frames):
        padded, n = det.pad_points(pts_np)
        pts = torch.from_numpy(padded).cuda()
        with torch.no_grad():
            vox = {f: voxelize(pts, int(n), spec, grid, fcfs=f) for f in (True, False)}
            occupied = cell_ids(*voxelize(pts, int(n), every, grid)[1::2], spec.grid_size)
            got = {f: by_order[f].infer(pts, int(n)) for f in (True, False)}
        ids = {f: cell_ids(v.coors, v.voxel_num, spec.grid_size) for f, v in vox.items()}
        same_set = np.array_equal(np.sort(ids[True]), np.sort(ids[False]))
        if len(occupied) <= spec.max_voxels:
            check(kind == "under the cap", f"frame {i}: {len(occupied)} pillars, {kind}")
            check(same_set and np.array_equal(ids[False], np.sort(occupied)), f"frame {i}: the pillar sets differ")
            assert_detections_close(got[False], got[True], f"frame {i}, fcfs=False vs fcfs=True")
            equal = all(torch.equal(a, b) for a, b in zip(got[False], got[True]))
            print(f"frame {i} ({kind}): {len(occupied)} pillars, the same set in both orders; detections "
                  f"bit-equal={equal}")
        else:
            check(kind == "over the cap", f"frame {i}: {len(occupied)} pillars, {kind}")
            check(np.array_equal(ids[True], occupied[:spec.max_voxels]), f"frame {i}: fcfs=True's selection")
            check(np.array_equal(ids[False], np.sort(occupied)[:spec.max_voxels]),
                  f"frame {i}: fcfs=False's selection")
            check(all(bool(torch.isfinite(t).all()) for t in got[False][:2]), f"frame {i}: non-finite detections")
            shared = len(np.intersect1d(ids[True], ids[False]))
            print(f"frame {i} ({kind}): {len(occupied)} pillars, {spec.max_voxels} kept by each order, "
                  f"{shared} by both; each order's own selection")
    host, device = {True: [], False: []}, {True: [], False: []}
    clouds = [(torch.from_numpy(p).cuda(), int(n)) for p, n in (det.pad_points(c) for _, c in frames)]
    for fcfs in (True, False, False, True):
        for pts, n in clouds:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            voxelize(pts, n, spec, grid, fcfs=fcfs)
            torch.cuda.synchronize()
            host[fcfs].append((time.perf_counter() - t0) * 1e3)
        pts, n = clouds[-1]
        traced = profile_device_time(functools.partial(voxelize, pts, n, spec, grid, fcfs=fcfs), 10)
        device[fcfs].append(None if traced is None else traced[0])
    for fcfs in (True, False):
        dev = "not measured" if None in device[fcfs] else " / ".join(f"{d:.4f}" for d in device[fcfs])
        print(f"[{card}] voxelize fcfs={fcfs}: host ms median {statistics.median(host[fcfs]):.3f} (min "
              f"{min(host[fcfs]):.3f}, max {max(host[fcfs]):.3f}) over {len(host[fcfs])} calls; device ms of a "
              f"{N_POINTS}-point frame (torch.profiler, 10 calls, two runs) {dev}")
    return {"detect, fcfs=False": run["launches"]}


# --- phase 19: the compiled entry points (captured CUDA graphs) ---


def collect_graphs(part: str | None = None) -> None:
    """Give back what the last part freed: a captured callable goes with
    its owner, and the graph's pool with it once no output of the graph is
    alive. With `part`, print what the card still holds as it starts."""
    torch.cuda.empty_cache()
    if part is not None:
        print(f"[{_PHASE['card']}] {part} starts with {torch.cuda.memory_allocated()} bytes allocated, "
              f"{torch.cuda.memory_reserved()} reserved", flush=True)


@contextlib.contextmanager
def cudnn_deterministic():
    before = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before


def step_snapshot(trainer, state, loss, counts) -> dict:
    """A step's results and the trainer's whole state after it, cloned."""
    return dict(loss={k: v.clone() for k, v in loss.items()}, counts={k: v.clone() for k, v in counts.items()},
                model={k: v.clone() for k, v in trainer.model.state_dict().items()},
                moments=[t.clone() for t in state.mu + state.nu])


def differing(a: dict, b: dict) -> list[str]:
    """The names of the tensors in which two `step_snapshot`s differ by a bit."""
    out = [f"loss {k}" for k in a["loss"] if not torch.equal(a["loss"][k], b["loss"][k])]
    out += [f"counts {k}" for k in a["counts"] if not torch.equal(a["counts"][k], b["counts"][k])]
    out += [k for k in a["model"] if not torch.equal(a["model"][k], b["model"][k])]
    out += [f"moment {i}" for i, (x, y) in enumerate(zip(a["moments"], b["moments"])) if not torch.equal(x, y)]
    return out


def eager_vs_captured(cfg, batch, steps: int, what: str, card: str, **trainer_kw) -> list[str]:
    """`steps` eager steps and `steps` captured steps from `init_weights(SEED)`
    on `batch`, each on a fresh trainer, cuDNN deterministic: after every
    step the losses, counts, every parameter and running statistic and the
    moments, bit for bit → what differed (nothing, where the gate holds)."""
    from det3d_tpu_torch.train.trainer import Trainer

    runs = {}
    with cudnn_deterministic():
        for jit in (False, True):
            trainer = Trainer(cfg, **trainer_kw)
            state = trainer.init_state(SEED)
            fn = trainer.train_step_jit if jit else trainer.train_step
            snaps = []
            for _ in range(steps):
                state, loss, counts = fn(state, batch)
                snaps.append(step_snapshot(trainer, state, loss, counts))
            if jit:
                check(trainer.train_step_jit.captures == 1, f"{what}: {trainer.train_step_jit.captures} captures")
            runs[jit] = snaps
            del trainer, state, fn
            collect_graphs()
    diffs = [differing(a, b) for a, b in zip(runs[False], runs[True])]
    losses = [round(float(r["loss"]["loss"]), 6) for r in runs[True]]
    print(f"[{card}] {what}: {steps} captured steps against {steps} eager steps from init_weights({SEED}), cuDNN "
          f"deterministic: bit-equal after every step {all(not d for d in diffs)} (losses, counts, "
          f"{len(runs[True][0]['model'])} parameters and buffers, {len(runs[True][0]['moments'])} moments); "
          f"loss by step {losses}" + ("" if all(not d for d in diffs) else f"; differing {diffs}"))
    check(losses[-1] < losses[0], f"{what}: the loss did not fall")
    return [name for d in diffs for name in d]


def timed_steps(fn, batch, n: int, warmup: int) -> dict:
    """ms of `fn(batch)` + synchronize, median over n after `warmup` calls,
    peak allocated bytes since just before the first call over those
    allocated then (`live`), the bytes the
    run still holds reserved after it with the cache emptied (a captured
    call's graph pool and static buffers, and what the step keeps), the
    reserve at its start, and the first call's seconds (the capture, for a
    captured step)."""
    collect_graphs()
    start, live = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn(batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    for _ in range(warmup - 1):
        fn(batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    return dict(ms=statistics.median(times), min=min(times), max=max(times), first_s=first_s, peak=peak - live,
                live=live, held=torch.cuda.memory_reserved() - start, start=start)


def step_line(card: str, what: str, r: dict) -> str:
    busy = "not measured" if r["device"] is None else f"{r['device']:.3f} ms ({100 * r['device'] / r['ms']:.1f} % busy)"
    return (f"[{card}] {what}: ms median {r['ms']:.3f} (min {r['min']:.3f}, max {r['max']:.3f}); device {busy}; "
            f"host-card syncs {r['syncs']}; peak {r['peak']} bytes allocated over the {r['live']} live at its start; "
            f"held reserved after the run "
            f"{r['held']} bytes over the {r['start']} reserved at its start; first call {r['first_s']:.3f} s; kernels "
            f"per call (profiler) {r['per_call']}")


def run_compiled(cfg, frames, batch, card: str, base: dict) -> dict:
    """Phase 19: `Detector.infer_jit`, `Trainer.train_step_jit` and
    `Trainer.eval_step_jit` on the card, each one captured CUDA graph.
    (a) the frame: bit-equal to `infer` on phase 4's 8 frames, kernels per
    replay, ms, device ms, busy share, syncs, peak, one capture; (b) the
    dense train step: 10 captured f32 steps bit-equal to 10 eager ones, then
    bf16 timings of both; (c) the packed + blocked step, 5 steps bit-equal;
    (d) `eval_step_jit` after 3 captured steps, at the end and after a
    `load_state_dict` against eager `infer`; (e) the device-augmented step,
    3 steps bit-equal; (f) the apps through the captured paths; (g)
    ntusl_10cm's captured step → {path: kernels per replay}."""
    from det3d_tpu_torch.apps import infer_app, serve_app, train_app
    from det3d_tpu_torch.config import load_config
    from det3d_tpu_torch.models.pointpillars import Layout
    from det3d_tpu_torch.pipeline import Detector
    from det3d_tpu_torch.train.trainer import Trainer, host_batch
    from det3d_tpu_torch.utils import graphs

    check(CAPTURE_LAUNCHES == graphs.WARMUP_CALLS + 1, "CAPTURE_LAUNCHES follows utils/graphs.WARMUP_CALLS")
    counters = train_counters(layouts=True)
    per_call = {}
    train_calls = {k: int(k in ("scatter_to_bev", "scatter_to_bev_bwd", "matcher_gt_max", "matcher_assign",
                                "fence_copy")) for k in PROFILER_KERNELS}

    # (a) the frame
    t0 = time.time()
    collect_graphs("19(a)")
    start, live = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
    det = Detector(cfg).init_weights(SEED)
    clouds = [f[:N_POINTS] for f in frames[1:DEPLOY_FRAMES + 1]]
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    det.infer_jit(frames[0], N_POINTS)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t1
    equal = []
    for f in frames[1:DEPLOY_FRAMES + 1]:
        got = [t.cpu().numpy() for t in det.infer_jit(f, N_POINTS)]
        want = [t.cpu().numpy() for t in det.infer(torch.from_numpy(f).cuda(), N_POINTS)]
        equal.append(all(np.array_equal(g, w) for g, w in zip(got, want)))
    check(all(equal), f"19(a) infer_jit against infer: bit-equal {equal}")
    for c in counters.values():
        c.launches = 0
    runs = {}
    for name in ("captured", "eager", "captured", "eager"):
        fn = det.detect if name == "captured" else eager_detect(det)
        runs.setdefault(name, []).extend(host_ms_per_frame(fn, clouds))
    replay_launches = {k: c.launches for k, c in counters.items()}
    for name in ("captured", "eager"):
        fn = det.detect if name == "captured" else eager_detect(det)
        frames_per, device, _ = profiled_frames(fn, clouds)
        syncs = count_syncs(lambda: fn(clouds[0]))
        ms = statistics.median(runs[name])
        if name == "captured":
            per_call["frame"] = frames_per
        busy = "not measured" if device is None else f"{device:.3f} ms ({100 * device / ms:.1f} % busy)"
        print(f"[{card}] (a) detect, {name}: ms/frame median {ms:.3f} (min {min(runs[name]):.3f}, max "
              f"{max(runs[name]):.3f}, {len(runs[name])} frames in two turns); device {busy}; calls per frame of each "
              f"kernel (profiler) {frames_per}; host-card syncs per detect {len(syncs)} ({', '.join(syncs)})")
        check(frames_per is None or frames_per == INFER_CALLS, f"19(a) {name}: kernel calls per frame {frames_per}")
    peak = torch.cuda.max_memory_allocated() - live
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved() - start
    print(f"[{card}] (a) infer_jit bit-equal to infer on {len(equal)} frames; captures {det.infer_jit.captures}; "
          f"first call (warm-up and capture) {capture_s:.3f} s; peak {peak} bytes allocated over the {live} live "
          f"at its start, both paths (phase 4's eager frame: {base['frame_peak']}); the detector with its graph holds {held} bytes reserved over the "
          f"{start} at the start; wrapper launches over the timed frames {replay_launches} (the eager "
          f"turns only: {2 * (len(clouds) + 1)} each)")
    check(det.infer_jit.captures == 1, f"19(a) {det.infer_jit.captures} captures")
    check(replay_launches["scatter_fwd"] == replay_launches["nms"] == 2 * (len(clouds) + 1),
          f"19(a) a replay ran a wrapper: {replay_launches}")
    del det
    collect_graphs()
    print(f"[{card}] 19(a) took {time.time() - t0:.1f} s")

    # (b) the dense step, and (d) the eval graph inside it
    t0 = time.time()
    collect_graphs("19(b)")
    cfg32 = cfg.replace(compute_dtype="float32")
    eval_frames = frames[1:5]
    evals = {}

    def eval_check(trainer, when: str) -> None:
        # cloned: each call overwrites the last one's buffers
        got = [[t.clone() for t in trainer.eval_step_jit(f, N_POINTS)] for f in eval_frames]
        want = [trainer.eval_step(f, N_POINTS) for f in eval_frames]
        evals[when] = all(all(torch.equal(a, b) for a, b in zip(g, w)) for g, w in zip(got, want))

    diffs = eager_vs_captured(cfg32, batch, DENSE_JIT_STEPS, "(b) dense f32 step", card)
    check(not diffs, f"19(b) the captured dense f32 step differs from the eager one in {sorted(set(diffs))}")

    with cudnn_deterministic():  # (d): eval_step_jit against eager infer on the trainer's model
        trainer = Trainer(cfg32)
        state = trainer.init_state(SEED)
        for k in range(DENSE_JIT_STEPS):
            state, _, _ = trainer.train_step_jit(state, batch)
            if k + 1 == 3:
                eval_check(trainer, "after 3 captured steps")
        eval_check(trainer, f"after {DENSE_JIT_STEPS}")
        trainer.detector.load_state_dict(Detector(cfg32).init_weights(SEED + 1).model.state_dict())
        eval_check(trainer, "after load_state_dict")
        state, loss, counts = trainer.train_step_jit(state, batch)
        check(np.isfinite(float(loss["loss"])), "19(d) the captured step after load_state_dict")
        del loss, counts  # the graph's outputs: they would keep its pool alive
        check(trainer.detector.infer_jit.captures == 1 and trainer.train_step_jit.captures == 1,
              "19(d) one capture of each graph")
    print(f"[{card}] (d) eval_step_jit equal to eager infer on the trainer's model on {len(eval_frames)} frames: "
          f"{evals}; one capture each")
    check(all(evals.values()), f"19(d) {evals}")
    del trainer, state
    collect_graphs()

    steps = {}
    for name in ("eager", "captured", "eager", "captured"):
        trainer = Trainer(cfg)
        state = trainer.init_state(SEED)
        fn = (trainer.train_step_jit if name == "captured" else trainer.train_step)
        r = timed_steps(lambda b: fn(state, b), batch, TRAIN_STEPS, TRAIN_WARMUP)
        if name not in steps:
            traced_per, device, _ = profiled_frames(lambda b: fn(state, b), [batch] * 3)
            r.update(device=device, per_call=traced_per, syncs=len(count_syncs(lambda: fn(state, batch))))
            check(traced_per is None or traced_per == train_calls, f"19(b) {name}: kernels per step {traced_per}")
            steps[name] = r
        else:
            steps[name]["turn 2"] = r["ms"]
        del trainer, state, fn
        collect_graphs()
        dropped = torch.cuda.memory_reserved()
        check(dropped <= r["start"], f"19(b) {name}: a dropped trainer left {dropped} bytes reserved, "
                                     f"{r['start']} with it alive before its first step")
        steps[name]["dropped"] = dropped
    for name, r in steps.items():
        print(step_line(card, f"(b) dense bf16 step, {name} (second turn {r['turn 2']:.3f} ms; {r['dropped']} bytes "
                              f"reserved once the trainer is dropped)", r))
    print(f"[{card}] (b) beside them, phase 7's eager step in this run: {base['step_ms']:.3f} ms, device "
          f"{base['step_device']}, syncs {base['step_syncs']}, peak {base['step_peak']}")
    per_call["dense step"] = steps["captured"]["per_call"]
    print(f"[{card}] 19(b, d) took {time.time() - t0:.1f} s")

    # (c) pack_w + the shipped blocked train levers
    t0 = time.time()
    collect_graphs("19(c)")
    cfg_b = cfg32.replace(pack_w=True)
    check(Trainer(cfg_b).model.layout(TRAIN_BATCH, True) == Layout(True, True, True), "19(c) packed + blocked")
    collect_graphs()
    diffs = eager_vs_captured(cfg_b, batch, BLOCKED_JIT_STEPS, "(c) packed + blocked f32 step", card)
    check(not diffs, f"19(c) the captured packed + blocked step differs in {sorted(set(diffs))}")
    trainer = Trainer(cfg.replace(pack_w=True))
    state = trainer.init_state(SEED)
    trainer.train_step_jit(state, batch)
    traced_per, device, names = profiled_frames(lambda b: trainer.train_step_jit(state, b), [batch] * 3)
    want = {k: int(k in ("scatter_to_bev_s2d_blocked", "scatter_to_bev_s2d_blocked_bwd", "matcher_gt_max",
                         "matcher_assign", "fence_copy")) for k in PROFILER_KERNELS}
    print(f"[{card}] (c) packed + blocked bf16 captured step: kernels per replay (profiler) {traced_per}, by the "
          f"names {names}; device {device} ms a step")
    check(traced_per is None or traced_per == want, f"19(c) kernels per replay {traced_per}")
    per_call["packed + blocked step"] = traced_per
    del trainer, state
    collect_graphs()
    print(f"[{card}] 19(c) took {time.time() - t0:.1f} s")

    # (e) the device-augmented step
    t0 = time.time()
    collect_graphs("19(e)")
    diffs = eager_vs_captured(cfg32, batch, AUG_JIT_STEPS, "(e) device-augmented f32 step", card,
                              device_global_augment=True, aug_seed=SEED)
    check(not diffs, f"19(e) the captured device-augmented step differs in {sorted(set(diffs))}")
    print(f"[{card}] 19(e) took {time.time() - t0:.1f} s")

    # (f) the apps through the captured paths
    t0 = time.time()
    collect_graphs("19(f)")
    root = Path(tempfile.mkdtemp(prefix="det3d-jit-"))
    try:
        for c in counters.values():
            c.launches = 0
        summary = train_app.train(cfg.replace(batch_size=TRAIN_BATCH), max_steps=APP_STEPS, display_step=2,
                                  save_step=10 ** 9, eval_step=APP_STEPS, eval_frames=APP_EVAL_FRAMES, synthetic=True,
                                  model_dir=str(root / "model"))
        app_launches = {k: c.launches for k, c in counters.items()}
        check(summary["steps"] == APP_STEPS and summary["trainer"].train_step_jit.captures == 1, "19(f) train_app")
        print(f"[{card}] (f) train --synthetic through train_step_jit: ms/step by window of 2 "
              f"{[round(v, 3) for v in summary['ms_per_step']]} (the host draws each synthetic scene); waited for "
              f"batches {[round(w * 1e3, 3) for w in summary['batch_wait_s']]} ms; eval {summary['eval_s'][0]:.3f} s; "
              f"wrapper launches {app_launches}; beside it, phase 12's app (captured too; a dataset, 2 workers) "
              f"{[round(v, 3) for v in base['app_ms']]}")
        want = {k: 0 for k in counters}
        want.update({name: CAPTURE_LAUNCHES for name in TRAIN_COUNTERS})
        want.update(scatter_fwd=2 * CAPTURE_LAUNCHES, nms=CAPTURE_LAUNCHES)
        check(app_launches == want, f"19(f) train_app launches {app_launches}, expected {want}")
        del summary
        collect_graphs()
        avg = {}
        for b in (1, INFER_BATCH):
            r = infer_app.infer(cfg, synthetic=True, num_frames=APP_FRAMES, range_thresholds=(80.0,), batch=b)
            avg[b] = r["avg_ms"]
            check(len(r["dt_annos"]) == APP_FRAMES and "Metric: 3d" in r["eval_strs"][0], f"19(f) infer batch {b}")
        print(f"[{card}] (f) infer through infer_jit / infer_batch_jit, synthetic, bf16: ms/frame batch 1 "
              f"{avg[1]:.3f}, batch {INFER_BATCH} {avg[INFER_BATCH]:.3f}; beside them, phase 13's infer_app (captured "
              f"too) {base['infer_app']}")
        collect_graphs()
        det = Detector(cfg).init_weights(SEED)
        stats = serve_app.serve_synthetic(cfg, frames=SERVE_FRAMES, hz=SERVE_HZ,
                                          server=serve_app.PointCloudServer(cfg, detector=det))
        check(stats.submitted == SERVE_FRAMES and len(stats) + stats.dropped == SERVE_FRAMES, "19(f) serve counts")
        check(det.infer_jit.captures == 1, "19(f) serve captured once")
        print(f"[{card}] (f) serve_synthetic through infer_jit, {SERVE_HZ} Hz: {latency_line(stats)}; beside it, "
              f"phase 13's live eager serve: {base['serve_live']}")
        del det
        collect_graphs()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[{card}] 19(f) took {time.time() - t0:.1f} s")

    # (g) ntusl_10cm, captured
    t0 = time.time()
    collect_graphs("19(g)")
    cfg10 = load_config("configs/ntusl_10cm.json", max_points=120_000)
    trainer = Trainer(cfg10)
    state = trainer.init_state(SEED)
    batch10 = host_batch(cfg10, train_scenes(cfg10, SEED))
    r = timed_steps(lambda b: trainer.train_step_jit(state, b), batch10, R1_STEPS, 1)
    traced_per, device, _ = profiled_frames(lambda b: trainer.train_step_jit(state, b), [batch10] * 2)
    r.update(device=device, per_call=traced_per, syncs=len(count_syncs(lambda: trainer.train_step_jit(state, batch10))))
    print(step_line(card, f"(g) ntusl_10cm captured step, batch 2, bf16 ({R1_STEPS} steps after the capture)", r))
    check(traced_per is None or traced_per == train_calls, f"19(g) kernels per replay {traced_per}")
    per_call["10 cm step"] = traced_per
    del trainer, state
    collect_graphs()
    print(f"[{card}] 19(g) took {time.time() - t0:.1f} s")
    return per_call


def small_config():
    """A 32x32-grid geometry with the default 9 anchors per location."""
    from det3d_tpu_torch.config import load_config

    return load_config({
        "detection_range": [-16.0, -16.0, -2.5, 16.0, 16.0, 8.5],
        "center_limit": [-16.0, -16.0, -10.0, 16.0, 16.0, 10.0],
        "voxel_size": [1.0, 1.0, 11.0], "max_voxels": 256, "max_num_points": 5,
        "max_points": 4096, "compute_dtype": "float32",
    })


def check_in_relu(card: str) -> dict:
    """Phase 20: the RPN's InstanceNorm + ReLU kernel (`kernels/norm_cuda.py`)
    at the dense 20 cm network's map shapes (`IN_RELU_SHAPES`), batch 1 and
    INFER_BATCH, bf16: its statistics against the plain version's within
    tests/test_torch_norm.py's float32 bounds, and its apply pass bit-equal
    to the plain one's for equal statistics; then ms a call of the kernel
    (CUDA events over 30 calls back to back, the map warm in the L2 as the
    producing convolution leaves it; and single calls after an L2 flush),
    its statistics and apply passes apart, its bound at IN_RELU_BYTES an
    element and its floor (IN_RELU_BYTES_IN_L2 where the map fits the
    card's L2, so the apply pass can read it there), the plain version's ms and the library call's (`F.instance_norm`
    + ReLU, a yardstick the port never calls), each shape and a frame's 19
    pairs summed; last the eager RPN on the canvas: its op calls a frame and
    its ms with the kernel against the plain pair in its place, in turns."""
    import torch.nn.functional as F

    from det3d_tpu_torch.kernels import norm_cuda
    from det3d_tpu_torch.kernels.norm_cuda import in_moments, normalize
    from det3d_tpu_torch.models.pointpillars import RPN

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    l2_bytes = torch.cuda.get_device_properties(torch.cuda.current_device()).L2_cache_size
    result = {}
    for b in (1, INFER_BATCH):
        frame = collections.Counter()
        for (c, h, w), pairs in IN_RELU_SHAPES.items():
            x = torch.randn((b, h, w, c), device="cuda", generator=gen) * (0.5 + torch.rand(c, device="cuda",
                                                                                             generator=gen))
            x = (x + torch.randn((b, 1, 1, c), device="cuda", generator=gen)).to(torch.bfloat16).permute(0, 3, 1, 2)
            p = norm_cuda.kernel_plan(x)
            partial, stats = norm_cuda.scratch(x, p)
            out = torch.empty_like(x)
            mean, inv, _ = in_moments(x)
            norm_cuda.launch(x, False, out, partial, stats, p, parts=1)
            mean_err = ((stats[:, 0] - mean).abs() / x.float().abs().mean(dim=(2, 3))).max().item()
            inv_err = ((stats[:, 1] - inv).abs() / (inv * (1 + mean**2 * inv**2))).max().item()
            check(mean_err <= 2e-5 and inv_err <= 2e-5, f"in_relu {(b, c, h, w)}: statistics off by {mean_err:.2e}, "
                                                        f"{inv_err:.2e}")
            stats.copy_(torch.stack([mean, inv], dim=1))
            norm_cuda.launch(x, False, out, partial, stats, p, parts=2)
            check(torch.equal(bits(out), bits(torch.relu(normalize(x, mean, inv)))),
                  f"in_relu {(b, c, h, w)}: the apply pass differs from the plain one's")
            row = dict(
                ms=cuda_ms(lambda: norm_cuda.in_relu(x)),
                cold_ms=single_call_ms(lambda: norm_cuda.in_relu(x), flush),
                stats_ms=cuda_ms(lambda: norm_cuda.launch(x, False, out, partial, stats, p, parts=1)),
                apply_ms=cuda_ms(lambda: norm_cuda.launch(x, False, out, partial, stats, p, parts=2)),
                bound_ms=IN_RELU_BYTES * x.numel() / HBM_BYTES_PER_S * 1e3,
                floor_ms=(IN_RELU_BYTES_IN_L2 if x.numel() * x.element_size() <= l2_bytes else IN_RELU_BYTES)
                * x.numel() / HBM_BYTES_PER_S * 1e3,
                plain_ms=cuda_ms(lambda: norm_cuda.in_relu_plain(x)),
                library_ms=cuda_ms(lambda: torch.relu(F.instance_norm(x, eps=1e-3))),
            )
            print(f"[{card}] in_relu batch {b}, (C, H, W) {(c, h, w)} x{pairs} a frame, {p.tiles} tiles of "
                  f"{p.rows_per_tile} rows: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items())
                  + f"; statistics off by {mean_err:.2e} (mean), {inv_err:.2e} (inv)")
            result[f"b{b} {c}x{h}x{w}"] = row
            frame.update({k: pairs * v for k, v in row.items()})
            del x, out, partial, stats
        result[f"b{b} frame"] = dict(frame)
        print(f"[{card}] in_relu batch {b}, the {IN_RELU_PAIRS} pairs of a frame (batch {b}) summed: "
              + ", ".join(f"{k} {v:.4f}" for k, v in frame.items())
              + (f"; kernel {'within' if frame['ms'] <= IN_RELU_FRAME_MS else 'OVER'} {IN_RELU_FRAME_MS} ms"
                 if b == 1 else ""))
    del flush

    rpn = RPN().cuda()
    for b in (1, INFER_BATCH):
        canvas = torch.randn((b, 800, 800, 64), device="cuda", generator=gen).to(torch.bfloat16).permute(0, 3, 1, 2)
        before = norm_cuda.counter.launches
        with torch.no_grad():
            rpn(canvas)
        calls = norm_cuda.counter.launches - before
        check(calls == IN_RELU_PAIRS, f"the eager RPN called in_relu {calls} times at batch {b}")
        times = collections.defaultdict(list)
        for name in ("kernel", "plain", "plain", "kernel"):
            rpn.in_relu = norm_cuda.in_relu if name == "kernel" else norm_cuda.in_relu_plain
            with torch.no_grad():
                times[name].append(cuda_ms(lambda: rpn(canvas), iters=4))  # the host's launches inside the spin
        rpn.in_relu = norm_cuda.in_relu
        result[f"b{b} rpn"] = {k: min(v) for k, v in times.items()}
        print(f"[{card}] eager RPN at batch {b} on the 800x800x64 canvas: {calls} in_relu calls; ms a call (CUDA "
              f"events, 4 calls, in turns): with the kernel {times['kernel']}, with the plain pair {times['plain']}")
        del canvas
    del rpn
    torch.cuda.empty_cache()
    return result


ROTATED_K = 1000
ROTATED_ROWS = (6, 24)        # a frame's tasks, a batch of four frames' tasks
ROTATED_SEEDS = (0, 1, 2, 3)


def rotated_rows(rows: int, seed: int, spread_m: float):
    """`rows` rows of ROTATED_K rotated boxes [cx, cy, dx, dy, angle] on
    the card, centres over a square of `spread_m` metres, 80 % valid."""
    import math

    g = torch.Generator().manual_seed(seed)
    centre = (torch.rand(rows, ROTATED_K, 2, generator=g) - 0.5) * spread_m
    dims = torch.exp(torch.randn(rows, ROTATED_K, 2, generator=g) * 0.5) * 1.5
    yaw = (torch.rand(rows, ROTATED_K, 1, generator=g) * 2 - 1) * math.pi
    valid = torch.rand(rows, ROTATED_K, generator=g) < 0.8
    return torch.cat([centre, dims, yaw], -1).cuda().contiguous(), valid.cuda().contiguous()


def check_rotated_nms(card: str) -> dict:
    """Phase 21 (see the module docstring)."""
    from benchmark.families.centerpoint import nms_row_bound_s
    from det3d_tpu_torch.kernels import nms_cuda
    from det3d_tpu_torch.ops.nms import circles_meet

    out = {}
    for rows in ROTATED_ROWS:
        for spread in (120.0, 30.0):
            for seed in ROTATED_SEEDS:
                rb, valid = rotated_rows(rows, seed, spread)
                got = nms_cuda.nms_keep_rotated_cuda(rb, valid, 0.2)
                want = nms_cuda.nms_keep_rotated_plain(rb, valid, 0.2)
                check(torch.equal(got, want), f"21: rotated keep sets differ at {rows} x {ROTATED_K}, spread "
                                              f"{spread}, seed {seed}: {int((got != want).sum())} flags")
            n = valid.sum(1).tolist()
            idx = torch.arange(ROTATED_K, device=rb.device)
            meet = (circles_meet(rb) & valid[:, None, :] & valid[:, :, None] & (idx[:, None] < idx[None, :])).sum(
                (1, 2)).tolist()
            scratch = nms_cuda.mask_scratch(rb)
            corners = nms_cuda.rbbox_corners(rb).contiguous()
            ms = cuda_ms(lambda: nms_cuda.nms_keep_rotated_cuda(rb, valid, 0.2))
            mask_ms = cuda_ms(lambda: nms_cuda.launch_rotated(rb, valid, 0.2, scratch, 1, corners))
            sweep_ms = cuda_ms(lambda: nms_cuda.launch_rotated(rb, valid, 0.2, scratch, 2, corners))
            plain_ms = cuda_ms(lambda: nms_cuda.nms_keep_rotated_plain(rb, valid, 0.2), iters=3, warmup=1)
            bound_ms = sum(nms_row_bound_s(v, m) for v, m in zip(n, meet)) * 1e3
            key = f"{rows}x{ROTATED_K} spread {spread:g} m"
            out[key] = {"ms": round(ms, 4), "mask_ms": round(mask_ms, 4), "sweep_ms": round(sweep_ms, 4),
                        "bound_ms": round(bound_ms, 5), "plain_ms": round(plain_ms, 3),
                        "valid_pairs": int(sum(v * (v - 1) // 2 for v in n)), "meeting_pairs": int(sum(meet)),
                        "seeds_equal": len(ROTATED_SEEDS)}
            print(f"[{card}] rotated NMS {key}: keep sets equal over {len(ROTATED_SEEDS)} seeds; {out[key]}",
                  flush=True)
    return out


def kernels_per_replay(fn, names: dict) -> dict:
    """Kernels of one call of a captured `fn` by the profiler: all, and
    those whose names hold each pattern of `names`."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {"all": len(kernels)}
    out.update({k: sum(1 for n in kernels if p in n) for k, p in names.items()})
    return out


def run_center(card: str, seed: int = 2**31 + 21) -> dict:
    """Phase 22 (see the module docstring)."""
    from benchmark.families import centerpoint as fam
    from benchmark.lib import traffic
    from det3d_tpu_torch.config import load_config
    from det3d_tpu_torch.kernels import nms_cuda, scatter_cuda
    from det3d_tpu_torch.pipeline import Detector
    from det3d_tpu_torch.postprocess import Detections, to_annos

    path = "benchmark/configs/centerpoint_pp_nusc.json"
    cfg, geo = load_config(path), fam.geometry(path)
    limit = json.loads(Path(path).read_text())["compare_limits"]["center_gap"]
    batch = 4
    scatter = check_scatter((cfg.grid_size[0], cfg.grid_size[1]), cfg.max_voxels, geo.pfn_filters[-1], batch=batch,
                            counts=(cfg.max_voxels, 41_000, 0))
    w = fam.make_weights(seed, geo, "cuda")
    frames = [fam.point_cloud(int(n), traffic.rng(seed, 2, i)) for i, n in enumerate(np.linspace(240_000, 360_000, 8))]

    # the full path at batch 4 in float32, kernels against plain versions, as phase 5
    det32 = Detector(cfg.replace(compute_dtype="float32"))
    det32.load_state_dict(w)
    padded = [det32.pad_points(f) for f in frames[:batch]]
    pts32 = torch.from_numpy(np.stack([p for p, _ in padded])).cuda()
    n32 = torch.as_tensor([k for _, k in padded], dtype=torch.int32, device="cuda")
    with_kernels = det32.infer_batch(pts32, n32)
    det32.model.scatter = scatter_cuda.scatter_to_bev_plain
    det32.postprocess.nms_keep = nms_cuda.nms_keep_rotated_plain
    with_plain = det32.infer_batch(pts32, n32)
    assert_detections_close(with_kernels, with_plain, f"centerpoint_pp_nusc f32 at batch {batch}, kernels vs plain")
    del det32, pts32, with_kernels, with_plain
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    det = Detector(cfg)
    det.load_state_dict(w)
    det.detect(frames[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kept = [det.detect(f) for f in frames]
    frame_ms = (time.perf_counter() - t0) / len(frames) * 1e3
    padded = [det.pad_points(f) for f in frames[:batch]]
    pts, n = np.stack([p for p, _ in padded]), np.asarray([k for _, k in padded], np.int32)
    det.infer_batch_jit(pts, n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        got = det.infer_batch_jit(pts, n)
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) / 8 * 1e3
    batched = [to_annos(cfg, Detections(got.boxes[j], got.scores[j], got.valid[j])) for j in range(batch)]
    names = {"scatter": "scatter_rows", "mask_tiles": "mask_tiles(", "sweep": "sweep("}
    padded1 = det.pad_points(frames[1])
    frame_k = kernels_per_replay(lambda: det.infer_jit(*padded1), names)
    batch_k = kernels_per_replay(lambda: det.infer_batch_jit(pts, n), names)
    peak = torch.cuda.max_memory_reserved()
    # each answer of both captured entries judged by the family's comparison, under the configuration's limit
    net = fam.reference_network(w, geo, "cuda")
    gaps = []
    for what, answers in (("detect", kept[:2]), (f"infer_batch_jit at batch {batch}", batched)):
        for i, a in enumerate(answers):
            got = fam.check_frame(fam.reference_frame(net, frames[i], geo, "cuda"), a, f"{what} frame {i}")
            gap = got.numbers["center_gap"]
            print(f"[{card}] {what} frame {i}: {got.note}", flush=True)
            check(gap <= limit, f"22: {what} frame {i}: center_gap {gap:.6g} over the limit {limit}")
            gaps.append(round(gap, 6))
    out = {"frame_ms": round(frame_ms, 3), "batch_ms": round(batch_ms, 3),
           "frame_kernels_per_replay": frame_k, "batch_kernels_per_replay": batch_k,
           "peak_gib": round(peak / 2**30, 3), "kept": [len(a["name"]) for a in kept],
           "center_gap": gaps, "center_gap_limit": limit,
           "scatter_b4_ms": {str(k): round(v["ms"], 4) for k, v in scatter.items() if k != "max_abs_err"}}
    print(f"[{card}] center model: {json.dumps(out)}", flush=True)
    return out


VOXELIZE_CONFIGS = {"ntusl_20cm": ("configs/ntusl_20cm.json", "pointpillars", (60_000, 130_000)),
                    "centerpoint_pp_nusc": ("benchmark/configs/centerpoint_pp_nusc.json", "centerpoint",
                                            (240_000, 360_000))}
VOXELIZE_KERNELS = ("vox_reset", "vox_bin", "vox_count", "vox_number", "vox_append", "vox_fill")


def voxelize_bytes(counts, c: int, spec) -> int:
    """The voxelizer's bytes: the real points read once, the buffers
    (voxels, coors, counts) written once."""
    b = len(counts)
    return int(sum(counts)) * c * 4 + b * spec.max_voxels * (spec.max_num_points * c + 4) * 4


def device_kernels(fn, n: int) -> dict[str, tuple[int, float]]:
    """{kernel name: (launches a call, device ms a call)} of `fn` by the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            k = out.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us() / 1e3
    return {name: (k / n, ms / n) for name, (k, ms) in out.items()}


def kernels_after(fn, first: str, eager, n: int = 10) -> dict:
    """The kernels that follow the kernel whose name holds `first` in each
    call of a captured `fn`, as many as one eager call of `eager` launches (the stage
    `eager` runs next): their names against the eager call's, device ms a
    call by name (profiler), their sum, and the span from `first`'s end to
    the last one's end."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def kernels(prof):
        return sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA), key=lambda e: e.time_range.start)

    eager()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eager()
        torch.cuda.synchronize()
    stage = [e.name for e in kernels(prof)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = kernels(prof)
    heads = [i for i, e in enumerate(events) if first in e.name]
    by_name: dict[str, float] = {}
    spans, total, same = [], 0.0, True
    for i in heads:
        run = events[i + 1:i + 1 + len(stage)]
        same = same and [e.name for e in run] == stage
        for e in run:
            ms = e.time_range.elapsed_us() / 1e3
            by_name[e.name[:70]] = by_name.get(e.name[:70], 0.0) + ms / len(heads)
            total += ms / len(heads)
        spans.append((run[-1].time_range.end - events[i].time_range.end) / 1e3)
    return {"calls": len(heads), "kernels": len(stage), "names_as_eager": same,
            "kernel_ms": round(total, 4), "span_ms": round(statistics.median(spans), 4) if spans else None,
            "by_name": {k: round(v, 4) for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])}}


def check_voxelize(card: str, seed: int = 2**31 + 23) -> dict:
    """Phase 23: the voxelizer's kernels (`kernels/voxelize_cuda.py`) at
    both configurations' shapes, batch 1 and INFER_BATCH, on the benchmark
    families' clouds: bit-equal to the plain version in both slot orders;
    ms a call (CUDA events behind a spin kernel) beside its byte bound and
    the plain version's ms (today's library chain: two sorts, a flipped
    cummin, gathers, frame by frame); each kernel's ms and launches a call,
    and launches per replay of a captured call (profiler); then the
    detector's captured frame (`infer_jit`) and batch (`infer_batch_jit`):
    the op called once a capture, the voxelizer's kernels in the replay by
    name, and no `scan_innermost_dim_with_indices` left in it."""
    from benchmark.families import centerpoint, pointpillars
    from benchmark.lib import traffic
    from det3d_tpu_torch.config import load_config
    from det3d_tpu_torch.kernels import voxelize_cuda
    from det3d_tpu_torch.ops.voxelize import VoxelizedFrame, VoxelizerSpec, grid_tensors, voxelize
    from det3d_tpu_torch.pipeline import Detector

    families = {"pointpillars": pointpillars, "centerpoint": centerpoint}
    result = {}
    for name, (path, family, (lo, hi)) in VOXELIZE_CONFIGS.items():
        cfg = load_config(path)
        spec = VoxelizerSpec.from_config(cfg)
        grid = grid_tensors(spec, torch.device("cuda"))
        clouds = [families[family].point_cloud(int(k), traffic.rng(seed, 23, i))
                  for i, k in enumerate(np.linspace(lo, hi, INFER_BATCH + 1))]
        c = clouds[0].shape[1]
        for b in (1, INFER_BATCH):
            group = clouds[-b:]
            pts = torch.zeros((b, cfg.max_points, c), dtype=torch.float32)
            for i, p in enumerate(group):
                pts[i, :len(p)] = torch.from_numpy(p[:cfg.max_points])
            pts = pts.cuda()
            counts_host = [min(len(p), cfg.max_points) for p in group]
            counts = torch.tensor(counts_host, dtype=torch.int32, device="cuda")
            row: dict = {}
            for fcfs in (True, False):
                got = voxelize_cuda.voxelize_batch(pts, counts, spec, fcfs)
                for i in range(b):
                    want = voxelize(pts[i], counts_host[i], spec, grid, fcfs=fcfs)
                    for f in VoxelizedFrame._fields:
                        g, w = getattr(got, f)[i], getattr(want, f)
                        check(torch.equal(bits(g) if g.is_floating_point() else g,
                                          bits(w) if w.is_floating_point() else w),
                              f"23: {name} batch {b} fcfs={fcfs} frame {i}: {f} differs from the plain version")
                row[f"pillars_fcfs_{fcfs}"] = got.voxel_num.tolist()

                def plain():
                    for i in range(b):
                        voxelize(pts[i], counts[i], spec, grid, fcfs=fcfs)

                key = "" if fcfs else "_cellid"
                row["ms" + key] = cuda_ms(lambda: voxelize_cuda.voxelize_batch(pts, counts, spec, fcfs))
                row["plain_ms" + key] = cuda_ms(plain, iters=10)
                per = device_kernels(lambda: voxelize_cuda.voxelize_batch(pts, counts, spec, fcfs), 10)
                row["kernels" + key] = {k: (round(v[0], 2), round(v[1], 5)) for k, v in per.items()
                                        if any(p in k for p in VOXELIZE_KERNELS)}
            row["bound_ms"] = voxelize_bytes(counts_host, c, spec) / HBM_BYTES_PER_S * 1e3
            row["points"] = counts_host
            # launches per replay of a captured call
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                voxelize_cuda.voxelize_batch(pts, counts, spec)
            torch.cuda.current_stream().wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                voxelize_cuda.voxelize_batch(pts, counts, spec)
            replay = kernels_per_replay(graph.replay, {"vox": "vox_"})
            row["launches_per_replay"] = replay
            check(replay["all"] == replay["vox"] == len(VOXELIZE_KERNELS),
                  f"23: {name} batch {b}: a replay launched {replay}")
            del graph
            print(f"[{card}] voxelize {name} batch {b}: bit-equal to the plain version in both orders; "
                  + json.dumps({k: (round(v, 4) if isinstance(v, float) else v) for k, v in row.items()}), flush=True)
            result[f"{name} b{b}"] = row
        # the detector's captured frame and batch
        det = Detector(cfg).init_weights(SEED)
        frame = det.pad_points(clouds[-1])
        padded = [det.pad_points(p) for p in clouds[-INFER_BATCH:]]
        batch_pts = np.stack([p for p, _ in padded])
        batch_n = np.asarray([k for _, k in padded], np.int32)
        for what, fn in (("infer_jit", lambda: det.infer_jit(*frame)),
                         ("infer_batch_jit", lambda: det.infer_batch_jit(batch_pts, batch_n))):
            before = voxelize_cuda.counter.launches
            fn()
            torch.cuda.synchronize()
            calls = voxelize_cuda.counter.launches - before  # the warm-up calls and the capture
            per = device_kernels(fn, 5)
            vox = {k: v[0] for k, v in per.items() if any(p in k for p in VOXELIZE_KERNELS)}
            scans = sum(v[0] for k, v in per.items() if "scan_innermost_dim_with_indices" in k)
            gathers = sum(v[0] for k, v in per.items() if "vectorized_gather_kernel" in k)
            check(calls >= 1 and sum(vox.values()) == len(VOXELIZE_KERNELS) and scans == 0,
                  f"23: {name} {what}: {calls} op calls in the capture, voxelizer kernels {vox}, {scans} index scans")
            top = sorted(per.items(), key=lambda kv: -kv[1][1])[:8]
            result[f"{name} {what}"] = {"op_calls_while_capturing": calls, "voxelize_kernels": vox,
                                        "index_scans": scans, "gathers": gathers,
                                        "kernels": int(sum(v[0] for v in per.values())),
                                        "device_ms": round(sum(v[1] for v in per.values()), 4),
                                        "top": [(k[:60], round(v[1], 4)) for k, v in top]}
            print(f"[{card}] voxelize {name} {what}: {json.dumps(result[f'{name} {what}'])}", flush=True)
        if not det.module.center:  # the anchor mask: the stage after the voxelizer in the frame's replay
            pts1 = torch.from_numpy(frame[0]).cuda()
            coors = det.module.voxelize_frame(pts1, frame[1]).coors
            split = kernels_after(lambda: det.infer_jit(*frame), "vox_fill(", lambda: det.module.anchors_mask(coors))
            check(split["calls"] > 0, f"23: {name}: no vox_fill in the frame's replays")
            result[f"{name} anchor mask in the infer_jit replay"] = split
            print(f"[{card}] voxelize {name}: the anchor mask in the frame's replay: {json.dumps(split)}", flush=True)
        del det
        torch.cuda.empty_cache()
    return result


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--deploy-child":
        return deploy_child(*sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == "--detect-syncs":
        return detect_syncs(sys.argv[2])
    if len(sys.argv) == 2 and sys.argv[1] == "--center":
        card = _PHASE["card"] = card_line()
        phase("21. the rotated NMS kernel (the center model's)")
        rotated = check_rotated_nms(card)
        phase("22. the center model (CenterPoint-PP), captured, full width")
        center = run_center(card)
        phase(None)
        print(json.dumps({"rotated_nms": rotated, "center": center}))
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--voxelize":
        card = _PHASE["card"] = card_line()
        phase("23. the voxelizer's kernels (both configurations, batch 1 and 4)")
        vox = check_voxelize(card)
        phase(None)
        print(json.dumps({"voxelize": vox}))
        print(card_line())
        return 0

    from det3d_tpu_torch.config import load_config
    from det3d_tpu_torch.data.synthetic import sample_scene, synthetic_cloud
    from det3d_tpu_torch.kernels import build, nms_cuda, norm_cuda, scatter_cuda
    from det3d_tpu_torch.pipeline import Detector

    t_start = time.time()
    phase("1. environment")
    card = _PHASE["card"] = card_line()
    print("nvidia-smi:", card)
    print("torch", torch.__version__, "cuda", torch.version.cuda, "device", torch.cuda.get_device_name(0))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("cudnn.allow_tf32", torch.backends.cudnn.allow_tf32,
          "cuda.matmul.allow_tf32", torch.backends.cuda.matmul.allow_tf32)

    phase("2. build")
    t0 = time.time()
    logs = build.build_all(tuple(build.EXTRA_FLAGS) + tuple(build.HOST_SOURCES)
                           + tuple(build.EXPERIMENT_SOURCES))
    for name, log in logs.items():
        print(f"--- {name}.cu (ptxas -v)")
        print("\n".join(line for line in log.splitlines() if "ptxas" in line or "error" in line.lower()))
    print(f"built {sorted(logs)} in {time.time() - t0:.1f} s")

    cfg = load_config("configs/ntusl_20cm.json", max_points=120_000)
    check(cfg.compute_dtype == "bfloat16", "ntusl_20cm computes in bf16")
    det = Detector(cfg).init_weights(SEED)
    frames = [synthetic_cloud(cfg.max_points, N_POINTS, seed=SEED + i) for i in range(N_FRAMES + 1)]

    phase("3. kernels vs plain versions on the card")
    grid_xy = (cfg.grid_size[0], cfg.grid_size[1])
    scatter = check_scatter(grid_xy, cfg.max_voxels, 64)
    pts = torch.from_numpy(frames[0]).cuda()
    candidates = det.infer_candidates(pts, N_POINTS)
    nms = check_nms(candidates, det.postprocess.params.nms_iou_threshold)

    phase("4. main path at full width (ntusl_20cm, bf16)")
    print(f"grid {cfg.grid_size}, {cfg.max_voxels} pillars x {cfg.max_num_points} points, "
          f"{det.anchor_set.num_anchors} anchors, {N_POINTS} points per frame")
    run = run_frames(det, frames, {"scatter": scatter_cuda.counter, "nms": nms_cuda.counter})
    launches, frame_ms, frame_peak = run["launches"], run["ms"], run["peak"]
    print(f"ms/frame median {frame_ms:.3f} (host clock around detect + synchronize; "
          f"min {run['min']:.3f}, max {run['max']:.3f}) over {run['n']} frames")
    print(f"peak memory allocated {run['peak']} bytes; detections per frame {run['detections']}")
    print(f"launches on the main path: {launches}")
    for name, n in launches.items():
        check(n == run["n"], f"{name} kernel launched {n} times over {run['n']} frames")
    syncs = [count_syncs(lambda: eager_detect(det)(frames[i])) for i in (1, 2, 3)]
    print(f"host-card synchronisations in each of 3 detects: {[len(x) for x in syncs]}; in the first: "
          f"{', '.join(f'{k} x{v}' for k, v in sorted(collections.Counter(syncs[0]).items()))}")
    print("stage breakdown, median ms (synchronized after each stage):")
    for name, ms in stage_breakdown(det, frames[1:]).items():
        print(f"  {name:36s} {ms:.3f}")
    traced = device_time(det, frames[1:6])
    if traced is None:
        print("device time per frame: not measured (the profiler trace holds no device events)")
    else:
        busy, top = traced
        print(f"device time per frame (torch.profiler, 5 frames): {busy:.3f} ms = "
              f"{100 * busy / frame_ms:.1f}% of the {frame_ms:.3f} ms median frame")
        for name, ms in top:
            print(f"  {ms:8.3f} ms  {name[:100]}")
    d = det.infer(torch.from_numpy(frames[1]).cuda(), N_POINTS)
    ncls, post = len(cfg.class_specs), det.postprocess.params.nms_post_max_size
    check(tuple(d.boxes.shape) == (ncls, post, 7) and tuple(d.valid.shape) == (ncls, post), "Detections shape")
    check(bool(torch.isfinite(d.boxes).all()) and bool(torch.isfinite(d.scores).all()), "finite detections")

    phase("5. full path, kernels vs plain versions (f32), and the card vs the CPU")
    cfg32 = cfg.replace(compute_dtype="float32")
    det32 = Detector(cfg32).init_weights(SEED)
    pts = torch.from_numpy(frames[2]).cuda()
    with_kernels = det32.infer(pts, N_POINTS)
    det32.model.scatter = scatter_cuda.scatter_to_bev_plain
    det32.postprocess.nms_keep = nms_cuda.nms_keep_plain
    det32.model.rpn.in_relu = norm_cuda.in_relu_plain
    with_plain = det32.infer(pts, N_POINTS)
    assert_detections_close(with_kernels, with_plain, "ntusl_20cm f32, kernels vs plain")

    small = small_config()
    on_card = Detector(small).init_weights(SEED)
    on_cpu = Detector(small, device="cpu").init_weights(SEED)
    rng = np.random.RandomState(SEED)
    for i in range(3):
        padded, n = on_card.pad_points(sample_scene(small, rng, (2, 6), ground_points=1200)["points"])
        a = on_card.infer(torch.from_numpy(padded).cuda(), int(n))
        b = on_cpu.infer(torch.from_numpy(padded), int(n))
        assert_detections_close(a, b, f"small geometry frame {i}, card vs CPU")

    phase("6. train-path kernels vs plain versions on the card")
    from det3d_tpu_torch.train.trainer import Trainer, host_batch

    trainer = Trainer(cfg)
    state = trainer.init_state(SEED)
    batch = host_batch(cfg, train_scenes(cfg, SEED))
    print(f"batch of {TRAIN_BATCH}: points {batch.num_points.tolist()}, valid gt {batch.gt_valid.sum(1).tolist()} "
          f"(classes {[np.bincount(c[v], minlength=4)[1:].tolist() for c, v in zip(batch.gt_classes, batch.gt_valid)]})")
    dev_batch = trainer.to_device(batch)
    matcher = check_matcher(trainer, dev_batch)
    scatter_bwd = check_scatter_bwd(grid_xy, cfg.max_voxels, 64)
    with torch.no_grad():
        vox, tgt = trainer.prepare(dev_batch)
        preds = trainer.model(vox.voxels, vox.num_points_per_voxel, vox.coors)
    fence = check_fence(preds)
    del vox, tgt, preds  # so that the peaks below count only their own phase

    phase("7. train step at full width (ntusl_20cm, bf16, batch 2)")
    run = run_steps(trainer, state, batch, TRAIN_STEPS, train_counters())
    train_launches, step_ms, history, metrics = run["launches"], run["ms"], run["history"], run["metrics"]
    print(f"ms/step median {step_ms:.3f} (host clock around train_step + synchronize; min {run['min']:.3f}, "
          f"max {run['max']:.3f}) over {TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up steps")
    print(f"peak memory allocated {run['peak']} bytes")
    print("loss by step: " + " ".join(f"{h['loss']:.4f}" for h in history))
    print(f"last step: {history[-1]}; metrics tp {metrics['tp'].tolist()} fp {metrics['fp'].tolist()} "
          f"fn {metrics['fn'].tolist()}")
    print(f"launches over {TRAIN_STEPS} steps: {train_launches}")
    expected = {name: TRAIN_STEPS for name in TRAIN_COUNTERS}
    expected["nms"] = 0
    check(train_launches == expected, f"train-path launches {train_launches}, expected {expected}")
    syncs = count_syncs(lambda: trainer.train_step(state, batch))
    step_syncs = len(syncs)
    print(f"host-card synchronisations in one train_step: {len(syncs)} "
          f"({', '.join(f'{k} x{v}' for k, v in sorted(collections.Counter(syncs).items()))})")
    print("stage breakdown, median ms over 5 steps (synchronized after each stage):")
    for name, ms in train_stage_breakdown(trainer, state, batch, 5).items():
        print(f"  {name:36s} {ms:.3f}")
    traced = profile_device_time(lambda: trainer.train_step(state, batch), 3)
    step_base = dict(step_ms=step_ms, step_peak=run["peak"], step_device="not measured")
    if traced is None:
        print("device time per step: not measured (the profiler trace holds no device events)")
    else:
        busy, top = traced
        step_base["step_device"] = f"{busy:.3f} ms"
        print(f"device time per step (torch.profiler, 3 steps): {busy:.3f} ms = "
              f"{100 * busy / step_ms:.1f}% of the {step_ms:.3f} ms median step")
        for name, ms in top[:12]:
            print(f"  {ms:8.3f} ms  {name[:100]}")
    del trainer, state

    phase("8. f32 train step, kernels vs plain versions")
    compare_train_steps(cfg32, batch)

    phase("9. layout kernels vs plain versions on the card")
    from det3d_tpu_torch.models.pointpillars import Layout, block0_blocking

    nblk, halo = block0_blocking(grid_xy)
    cfg10 = load_config("configs/ntusl_10cm.json")
    grid10 = tuple(cfg10.grid_size[:2])
    layout_k = check_layout_scatters(grid_xy, cfg.max_voxels, 64, nblk, halo,
                                     blocked10=(grid10, cfg10.max_voxels, *block0_blocking(grid10)))

    phase("10. packed inference at full width (ntusl_20cm + pack_w, bf16)")
    counters = train_counters(layouts=True)
    frame_runs = {}
    unfused = dict(fuse_in_stats=False, split_head=False)  # the fused, split network is phase 14's
    for name, flags, layout in (("packed", dict(pack_w=True, **unfused), Layout(True, False, False)),
                                ("packed + blocked", dict(pack_w=True, block0_blocked=True, **unfused),
                                 Layout(True, True, False))):
        det_l = Detector(cfg.replace(**flags)).init_weights(SEED)
        check(det_l.model.layout(1, False) == layout, f"{name}: layout {det_l.model.layout(1, False)}")
        run = run_frames(det_l, frames, counters)
        frame_runs[name] = run
        print(f"{name}: ms/frame median {run['ms']:.3f} (min {run['min']:.3f}, max {run['max']:.3f}) over "
              f"{run['n']} frames; peak memory allocated {run['peak']} bytes")
        print(f"{name}: launches {run['launches']}")
        want = {k: 0 for k in counters}
        want.update(nms=run["n"], **{"blocked_fwd" if layout.block0_blocked else "s2d_fwd": run["n"]})
        check(run["launches"] == want, f"{name}: launches {run['launches']}, expected {want}")
        print(f"{name}: stage breakdown, median ms (synchronized after each stage):")
        for stage, ms in stage_breakdown(det_l, frames[1:]).items():
            print(f"  {stage:36s} {ms:.3f}")
        traced = device_time(det_l, frames[1:6])
        if traced is not None:
            print(f"{name}: device time per frame (torch.profiler, 5 frames): {traced[0]:.3f} ms = "
                  f"{100 * traced[0] / run['ms']:.1f}% of the median frame")
            run["device"] = f"{traced[0]:.3f} ms ({100 * traced[0] / run['ms']:.1f} % busy)"
        del det_l
    pts = torch.from_numpy(frames[2]).cuda()
    dense32 = Detector(cfg32).init_weights(SEED)
    with torch.no_grad():
        frame, _ = dense32.preprocess(pts, N_POINTS)
        args = (frame.voxels[None], frame.num_points_per_voxel[None], frame.coors[None])
        dense_cls = dense32.model(*args)["cls_preds"]
    del dense32
    for name, flags in (("packed", dict(pack_w=True, **unfused)),
                        ("packed + blocked", dict(pack_w=True, block0_blocked=True, **unfused))):
        det_l = Detector(cfg32.replace(**flags)).init_weights(SEED)
        with torch.no_grad():
            cls = det_l.model(*args)["cls_preds"]
        with_kernels = det_l.infer(pts, N_POINTS)
        use_plain_scatters(det_l.model)
        det_l.postprocess.nms_keep = nms_cuda.nms_keep_plain
        with_plain = det_l.infer(pts, N_POINTS)
        assert_detections_close(with_kernels, with_plain, f"ntusl_20cm f32 {name}, kernels vs plain")
        # the same weights on the dense network: one function, summed in
        # other orders by other convolutions (f32, TF32 off)
        scale = dense_cls.abs().max().item()
        err = (cls - dense_cls).abs().max().item()
        print(f"f32 {name} vs dense cls_preds: max abs diff {err:.3e} (largest |cls_preds| {scale:.3f})")
        check(err <= PACKED_VS_DENSE_TOL * max(scale, 1.0), f"{name} cls_preds differ from the dense network's")
        del det_l

    phase("11. packed train step at full width (ntusl_20cm + pack_w, bf16, batch 2)")
    step_runs = {}
    for name, flags, layout in (
        ("packed + blocked (shipped train levers)", dict(pack_w=True), Layout(True, True, True)),
        ("packed", dict(pack_w=True, block0_blocked_train=False, late_blocked_train=False),
         Layout(True, False, False)),
    ):
        trainer = Trainer(cfg.replace(**flags))
        check(trainer.model.layout(TRAIN_BATCH, True) == layout, f"{name}: layout")
        state = trainer.init_state(SEED)
        n = TRAIN_STEPS if layout.block0_blocked else LAYOUT_TRAIN_STEPS
        run = run_steps(trainer, state, batch, n, counters)
        step_runs[name] = run
        losses = [h["loss"] for h in run["history"]]
        print(f"{name}: ms/step median {run['ms']:.3f} (min {run['min']:.3f}, max {run['max']:.3f}) over {n} "
              f"steps after {TRAIN_WARMUP} warm-up steps; peak memory allocated {run['peak']} bytes")
        print(f"{name}: loss by step: " + " ".join(f"{v:.4f}" for v in losses))
        print(f"{name}: launches {run['launches']}")
        want = {k: n for k in ("matcher_gt_max", "matcher_assign", "fence")}
        want.update({k: 0 for k in ("scatter_fwd", "scatter_bwd", "nms")})
        want.update({k: n if (k.startswith("blocked") == layout.block0_blocked) else 0 for k in LAYOUT_COUNTERS})
        check(run["launches"] == want, f"{name}: launches {run['launches']}, expected {want}")
        print(f"{name}: stage breakdown, median ms over 5 steps (synchronized after each stage):")
        for stage, ms in train_stage_breakdown(trainer, state, batch, 5).items():
            print(f"  {stage:36s} {ms:.3f}")
        if layout.block0_blocked:
            # the cotangent the step hands the blocked backward: which piece width it takes
            seen, shipped = [], scatter_cuda.scatter_to_bev_s2d_blocked_bwd_cuda

            def recording(g, c, halo_):
                seen.append((tuple(g.shape), g.stride(), scatter_cuda.blocked_bwd_piece_bytes(g)))
                return shipped(g, c, halo_)

            with blocked_bwd_as(recording):
                trainer.train_step(state, batch)
            check(len(seen) == 1, f"{name}: {len(seen)} blocked backward calls in one step")
            print(f"{name}: the blocked backward's cotangent {seen[0][0]}, strides {seen[0][1]}: "
                  f"{seen[0][2]}-byte pieces")
            # the kernel's own span inside the step, where the cotangent was
            # just written: the shipped kernel and the one it replaced, in turns
            spans = {"new": [], "old": []}
            for kernel in ("new", "old", "new", "old"):
                with blocked_bwd_as(shipped if kernel == "new" else blocked_bwd_per_piece):
                    traced = profile_device_time(lambda: trainer.train_step(state, batch), 3)
                if traced is None:
                    break
                span = sum(ms for op, ms in traced[1] if "gather_rows_blocked" in op)
                spans[kernel].append(span)
                print(f"{name}: device time per step with the {kernel} blocked backward (torch.profiler, 3 steps): "
                      f"{traced[0]:.3f} ms = {100 * traced[0] / run['ms']:.1f}% of the median step; the kernel's "
                      f"own span {span * 1e3:.2f} us a step" + ("" if span else " (no gather_rows_blocked span)"))
                if kernel == "new" and len(spans["new"]) == 1:
                    for op, ms in traced[1][:8]:
                        print(f"  {ms:8.3f} ms  {op[:100]}")
            run["blocked_bwd_in_step_ms"] = {k: v or None for k, v in spans.items()}
        del trainer, state
    compare_train_steps(cfg32.replace(pack_w=True), batch)

    apps_root = Path(tempfile.mkdtemp(prefix="det3d-apps-"))
    try:
        phase("12. apps at full width (train_app, checkpoint, infer_app; ntusl_20cm, bf16)")
        app_launches, app_stats = run_apps(cfg, train_counters(layouts=True), step_ms, apps_root)

        phase("13. deploy and serve at full width (ntusl_20cm, bf16)")
        deploy = run_deploy(cfg, det, apps_root, card)

        phase("14. model options at full width (ntusl_20cm unless stated, bf16 unless stated)")
        del det
        options = run_options(cfg, cfg32, frames, batch, card, dict(
            packed=frame_runs["packed"], step_ms=step_ms, step_syncs=step_syncs, app=app_stats), apps_root)
    finally:
        shutil.rmtree(apps_root, ignore_errors=True)

    phase("15. data parallelism (ntusl_20cm: world 1 under NCCL, two gloo ranks on the one card)")
    torch.cuda.empty_cache()
    dp_launches, dp_f1, sharded_per_call = run_data_parallel(card, step_base)

    phase("16. spatial modes (ntusl_20cm unless stated: world 1 under NCCL, two gloo ranks on the one card)")
    spatial_launches, spatial_per_call = run_spatial(card, dict(step_base, frame_ms=frame_ms, frame_peak=frame_peak,
                                                                f1=dp_f1))
    sharded_per_call.update(spatial_per_call)

    phase("17. the viewer's device pieces and tune (ntusl_20cm, bf16, at full width)")
    torch.cuda.empty_cache()
    run_viewer_pieces(cfg, card)
    tune_launches = run_tune(card)

    phase("18. cell-id-ordered voxelization (Detector(fcfs=False), ntusl_20cm, bf16, at full width)")
    cellid_launches = run_cell_id_order(cfg, card)

    phase("19. the compiled entry points: infer_jit, train_step_jit, eval_step_jit as CUDA graphs (ntusl_20cm)")
    live_serve = np.asarray(deploy["serve_live"]["latencies"]) * 1e3
    jit_per_call = run_compiled(cfg, frames, batch, card, dict(
        step_base, frame_peak=frame_peak, step_syncs=step_syncs, app_ms=app_stats["ms_per_step"],
        infer_app={k: round(v, 3) for k, v in deploy["infer"].items()},
        serve_live=f"p50 {np.percentile(live_serve, 50):.3f} ms, p95 {np.percentile(live_serve, 95):.3f} ms, "
                   f"dropped {deploy['serve_live']['dropped']}"))

    phase("20. the RPN's InstanceNorm + ReLU kernel (ntusl_20cm's map shapes, bf16)")
    in_relu = check_in_relu(card)

    phase("21. the rotated NMS kernel (the center model's)")
    rotated = check_rotated_nms(card)
    phase("22. the center model (CenterPoint-PP), captured, full width")
    center = run_center(card)
    phase("23. the voxelizer's kernels (both configurations, batch 1 and 4)")
    vox = check_voxelize(card)

    kernels = [
        {
            "name": "scatter_to_bev", "route": "cuda",
            "source": "det3d_tpu_torch/kernels/csrc/scatter.cu",
            "replaces": "det3d_tpu/kernels/scatter_pallas.py:40",
            "launches": launches["scatter"], "max_abs_err": scatter["max_abs_err"],
            **{k: scatter[torch.bfloat16][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": "bytes",
        },
        {
            "name": "nms_keep", "route": "cuda",
            "source": "det3d_tpu_torch/kernels/csrc/nms.cu",
            "replaces": "det3d_tpu/kernels/nms_pallas.py:30",
            "launches": launches["nms"], "library_ms": None, **nms,
        },
        {
            "name": "scatter_to_bev_bwd", "route": "cuda",
            "source": "det3d_tpu_torch/kernels/csrc/scatter.cu",
            "replaces": "det3d_tpu/kernels/scatter_pallas.py:290",
            "launches": train_launches["scatter_bwd"], "max_abs_err": scatter_bwd["max_abs_err"],
            **{k: scatter_bwd[torch.bfloat16][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": "bytes",
        },
        {
            "name": "matcher_gt_max", "route": "cuda",
            "source": "det3d_tpu_torch/kernels/csrc/matcher.cu",
            "replaces": "det3d_tpu/kernels/matcher_pallas.py:66",
            "launches": train_launches["matcher_gt_max"], "max_abs_err": matcher["gt_max_err"],
            "ms": matcher["gt_max_ms"], "plain_ms": matcher["gt_max_plain_ms"],
            "bound_ms": matcher["gt_max_bound_ms"], "bound_by": matcher["gt_max_bound_by"], "library_ms": None,
        },
        {
            "name": "matcher_assign", "route": "cuda",
            "source": "det3d_tpu_torch/kernels/csrc/matcher.cu",
            "replaces": "det3d_tpu/kernels/matcher_pallas.py:139",
            "launches": train_launches["matcher_assign"], "max_abs_err": matcher["max_abs_err"],
            "ms": matcher["assign_ms"], "plain_ms": matcher["assign_plain_ms"],
            "bound_ms": matcher["assign_bound_ms"], "bound_by": matcher["assign_bound_by"], "library_ms": None,
        },
        {
            "name": "fence_copy", "route": "cuda",
            "source": "det3d_tpu_torch/kernels/csrc/fence.cu",
            "replaces": "det3d_tpu/kernels/fence_pallas.py:23",
            "launches": train_launches["fence"], "bound_by": "bytes", **fence,
        },
    ]
    blocked_train = step_runs["packed + blocked (shipped train levers)"]["launches"]
    for name, key, replaces, launches in (
        ("scatter_to_bev_s2d", "s2d_fwd", 93, frame_runs["packed"]["launches"]["s2d_fwd"]),
        ("scatter_to_bev_s2d_bwd", "s2d_bwd", 178, step_runs["packed"]["launches"]["s2d_bwd"]),
        ("scatter_to_bev_s2d_blocked", "blocked_fwd", 358, blocked_train["blocked_fwd"]),
        ("scatter_to_bev_s2d_blocked_bwd", "blocked_bwd", 421, blocked_train["blocked_bwd"]),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": "det3d_tpu_torch/kernels/csrc/scatter.cu",
            "replaces": f"det3d_tpu/kernels/scatter_pallas.py:{replaces}", "launches": launches,
            "max_abs_err": layout_k[key]["max_abs_err"], "bound_by": "bytes",
            **{k: layout_k[key][torch.bfloat16][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        })
    # the blocked backward beside the kernel it replaced, at the 10 cm train
    # shape, and its own span inside phase 11's step
    row = next(k for k in kernels if k["name"] == "scatter_to_bev_s2d_blocked_bwd")
    row["old_ms"] = layout_k["blocked_bwd"][torch.bfloat16]["old_ms"]
    row["at_10cm"] = {k: layout_k["blocked_bwd_10cm"][torch.bfloat16][k]
                      for k in ("ms", "old_ms", "bound_ms", "library_ms")}
    row["in_step_ms"] = step_runs["packed + blocked (shipped train levers)"]["blocked_bwd_in_step_ms"]
    app_keys = {"scatter_to_bev": "scatter_fwd", "nms_keep": "nms", "scatter_to_bev_bwd": "scatter_bwd",
                "matcher_gt_max": "matcher_gt_max", "matcher_assign": "matcher_assign", "fence_copy": "fence",
                "scatter_to_bev_s2d": "s2d_fwd", "scatter_to_bev_s2d_bwd": "s2d_bwd",
                "scatter_to_bev_s2d_blocked": "blocked_fwd", "scatter_to_bev_s2d_blocked_bwd": "blocked_bwd"}
    graph = deploy["graph"]["per_frame"]  # None where the profiler saw no kernel inside the graph
    print(f"[{card}] calls per frame of each kernel inside the graph (profiler): {graph}")
    # launches over phase 12 (both apps); calls per frame inside phase 13's graph; phases 14-17's paths
    for k in kernels:
        k["app_launches"] = app_launches[app_keys[k["name"]]]
        k["graph_launches_per_frame"] = None if graph is None else graph[k["name"]]
        k["option_launches"] = {path: n[app_keys[k["name"]]] for path, n in options["launches"].items()}
        k["dp_launches"] = {path: n.get(app_keys[k["name"]], 0) for path, n in dp_launches.items()}
        k["spatial_launches"] = {path: n.get(app_keys[k["name"]], 0) for path, n in spatial_launches.items()}
        k["tune_launches"] = {path: n[app_keys[k["name"]]] for path, n in tune_launches.items()}
        k["cellid_launches"] = {path: n.get({"scatter_to_bev": "scatter", "nms_keep": "nms"}.get(k["name"]), 0)
                                for path, n in cellid_launches.items()}
        k["jit_launches_per_call"] = {path: None if n is None else n[k["name"]] for path, n in jit_per_call.items()}
        k["sharded_jit_launches_per_call"] = {path: None if n is None else n[k["name"]]
                                              for path, n in sharded_per_call.items()}
    phase(None)
    print(f"\ntotal {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"in_relu": in_relu}))
    print(json.dumps({"rotated_nms": rotated, "center": center}))
    print(json.dumps({"voxelize": vox}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
