#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--report PATH] [--phases PHASE...]

The main paths are the eval and train steps of MinkUNet mk34_cr10 (the
MODEL and OPTIM blocks of tools/cfgs/voxel/semantic_kitti/
minkunet_mk34_cr10.yaml), of SPVCNN mk34_cr10 (tools/cfgs/fusion/
semantic_kitti/spvcnn_mk34_cr10.yaml), of Cylinder3D cy480_cr10
(tools/cfgs/voxel/semantic_kitti/cylinder_cy480_cr10.yaml), of RPVNet
mk34_cr17_5 (tools/cfgs/fusion/semantic_kitti/rpvnet_mk34_cr17_5.yaml)
of the range models CENet, FIDNet, RangeNet and SalsaNext
(tools/cfgs/range/semantic_kitti/*_64x2048.yaml), and of MinkUNet
mk34_cr16 on Waymo Open (tools/cfgs/voxel/waymo/minkunet_mk34_cr16.yaml
and its _infer twin: widths 51-409, every conv on its kernel's ragged
path), with every other shipped Waymo and nuScenes yaml for a step, at
full width, with weights drawn from a seeded torch.Generator, on
131,072-point ray-cast scans (Waymo: ~180k-point ray-cast frames of
data/raycast_waymo.py; nuScenes: sweeps of data/raycast_nuscenes.py),
computing in bfloat16 through eight hand-written CUDA kernels
(openpcseg_torch/csrc):

  K1 subm gather-GEMM   K3 down gather-GEMM   K4 up parent gather
  K7 trilinear devoxelize                     (forward, eval and train)
  K2 subm backward      K6 down backward      K5 up backward
  K8 devoxelize transpose                     (backward, train)

SPVCNN's mean-voxelize runs K8 over each p2v table (its sum, eval and
train) and K7 over it (its backward), counted apart as vmean / vmean_bwd.
Cylinder3D runs its submanifold convs (3^3 and anisotropic kernels, the
rows of the 3^3 map) on K1 / K2, its k3 strided convs on the gather-GEMM
and gather_dw (counted as strided / strided_bwd / strided_dw; JAX runs
them on XLA), and its refinement gather on K7 over the level-0 p2v table
(K8 back; the vmean counters). RPVNet adds a float32 range branch (cuDNN,
TF32) fused with the voxel and point branches at four gates: each range
map goes to the points by K7 over a 4-corner bilinear table (K8 over its
transpose back; counters r2p / r2p_bwd), the points to a range map by K8
over a one-corner pixel table, the sum of a mean (K7 back; p2r /
p2r_bwd).

The range models run float32 dense convs on cuDNN, no kernel of the port.

Phases (any failure exits non-zero and prints no result line), which run
in the order 1-3, 7, 4-6, 8, 9, 22, 19, 11, 14, 18, 12, 13, 10, 23, 15,
16, 17, 20, 21 (PHASES: the phases that need no CPU reference step run
between those that do, so the reference process keeps ahead of them):
  1. the card's name and power limit; TF32 off for matmuls and cuDNN
     (back to torch's default, TF32 convs, for phases 13, 14 and 21);
     then the CPU reference process starts (python3 chip_smoke.py
     --cpu-refs DIR JOB...: the CPU float32 half of every training
     reference, of the range models' and of the entry reference, then
     the Waymo entry tree, REF_JOBS, in a niced process of 4 torch
     threads; each reference waits for its file and the script kills the
     process when it ends; every model but the Bottleneck takes five of
     its ten draws, TRAIN_REF_DRAWS_OF);
  2. build the kernels with nvcc (sm_90a) from the checkout's sources, and
     log ptxas's registers and spills per kernel instance;
  3. kernel phase: the launch configuration of the two gather kernels at
     the main-path shapes (tile, shared memory, blocks per SM); the device
     time of the parity plans (K4's and K6's tiling) and of the whole
     voxelize + geometry pass under torch.profiler; then each forward
     kernel against its plain PyTorch version on the card, at the shapes a
     real pyramid of ray-cast scan 0 gives it, twice, bit for bit (K4:
     parentless rows exactly 0);
  4. serving phase: SegTask answers REQUESTS requests (eval_step +
     predict_step each), with voxel_overflow 0, hist summing to the valid
     point count, every forward kernel launched and no plain version run
     on a CUDA tensor; p50 latency per scan after a warm-up;
  5. reference phase: the same weights on an 8192-point scan, GPU (bf16,
     kernels) against CPU (float32, plain versions);
  6. a torch.profiler window over one request (device time per kernel; per
     kernel family beside its bound, from one more request whose kernel
     calls note their work);
  7. backward-kernel phase: per devox level the contributors per voxel
     and the points per cell (max, p99, mean), the segments of K8's table,
     and K8's device time at each segment length of DEVOX_CHUNKS; then each
     backward kernel against its plain version on the card, dfeats and dW
     apart, at the same pyramid's shapes, and twice, bit for bit; K2, K5
     and K6 also pass by pass (dfeats alone, dW alone);
  8. training phase: TRAIN_STEPS SegTask.train_steps on the repeated scan
     of seed 1, each with a finite loss and gradient norm, voxel_overflow
     0, every forward and backward kernel launched and no plain version on
     a CUDA tensor; the last loss below the first; scans/s per card;
     then a torch.profiler window over one more step (device time per
     kernel and per family beside its bound, device idle share);
  9. training-reference phase: one train_step of the same numpy-seeded
     weights on an 8192-point scan and on four of its nine
     feature-perturbed copies (TRAIN_REF_DRAWS_OF), GPU (bf16, kernels)
     against CPU (float32, plain versions):
     loss and gradient cosines, held to the rule over the draws that
     JAX's reading sets (the mean loss difference within twice JAX's
     mean; each draw's cosines within 0.02 of JAX's on that draw) and to
     TRAIN_GROSS;
 10. entry-point phase: a ray-cast SemanticKITTI tree (4 train scans, 2
     val scans, data/raycast_kitti.py); the train CLI
     (openpcseg_torch.cli.train) on the mk34 yaml as it stands at batch 2
     for one epoch, then again with --epochs 2, which must resume from
     epoch 0; the infer CLI with --save_pred --save_raw_ids (one raw id
     per point, each in the inverse label map); voxel_overflow 0, finite
     losses, every kernel launched and no plain version on the card over
     the phase; the CLI's step ms, scans/s and val mIoU; then the first
     batch of the CLI's loader: one train step against the CPU float32
     reference, and every forward and backward kernel case (untimed) on
     that batch's pyramid;
 11. SPVCNN phases: serving (as 4, its mean-voxelize's K8 launched too),
     the eval reference (as 5), the eval profile (as 6), the
     mean-voxelize's kernel cases at VMEAN on scan 0's pyramid (sum and
     transpose against their plain versions, twice, bit for bit, timed),
     training (as 8, with every counter on every step), the training
     reference (as 9, under SPVCNN's own JAX reading), and the train CLI
     on the SPVCNN yaml as it stands (the
     fusion view) at batch 2 for one epoch over the same tree, then the
     infer CLI with --save_pred, every counter launched over the phase;
 12. Cylinder3D phases: serving (as 4, on its forward counters), the eval
     profile and its idle share, its kernel cases on scan 0's pyramid
     (CYL_SUBM's submanifold convs forward and backward, CYL_STRIDED's
     strided convs down and up, forward and backward, the refinement
     gather and its backward, each against its plain version, twice, bit
     for bit, timed), the point branch's share of the eval step's device
     time, and the scatter-max (the card's forward and backward
     equal the CPU's, the backward repeats bit for bit); the count of the
     8192-point scan's points whose cylindrical cell the card and the CPU
     put apart (where not 0, the card's reference runs take the CPU's
     tables); the eval reference (as 5); training (as 8, every counter of
     its path on every step); the training reference (as 9, under its own
     JAX reading and floor); the train CLI on its yaml as it stands at
     batch 2 for one epoch, a resumed second, and the infer CLI with
     --save_pred --save_raw_ids;
 13. RPVNet phases (the yaml as it stands, bf16 voxel branch, its range
     branch float32 on cuDNN in TF32): serving (as 4, its range fusion's
     K7 and K8 launched on every request), the eval profile and idle
     share, its kernel cases on scan SEED's pyramid and range tables
     (RPV_SUBM, RPV_DOWNS, RPV_UPS, RPV_DEVOX forward and backward, and
     the range fusion at RPV_R2P / RPV_P2R: each against its plain
     version, twice, bit for bit, timed, beside its bound and
     torch.sparse.mm), the count of points whose range tables the card
     and the CPU build apart (where not 0 the references take the CPU's
     tables), the eval reference (as 5), training (as 8, every counter of
     its path on every step), the training reference (as 9, under its own
     JAX reading, widened for TF32 by twice RPV_TF32_READING), and the
     train CLI on its yaml at batch 2 for one epoch, a resumed second, and
     the infer CLI with --save_pred --save_raw_ids;
 14. range phases, for each of CENet, FIDNet, RangeNet and SalsaNext from
     its yaml as it stands (64 x 2048, float32, TF32 convs): serving
     (REQUESTS + 1 eval and predict requests on ray-cast scans projected
     with range_project, each re-projected to its points by the KNN:
     hist = valid points, the p50, one profiled request's device ms and
     idle share), the reference (numpy weights, seed_range_weights: the
     card's eval logits against the CPU's float32 ones within
     RANGE_REF_TOL, argmax agreement at least RANGE_REF_AGREE, both set
     before the first card run, on the scan as ray-cast and moved into the
     sensor frame), the training reference (one AdamW + onecycle step,
     card against CPU float32, under range_train_bounds: twice the CPU
     emulation of TF32), training (RANGE_TRAIN_STEPS steps of
     the yaml's AdamW + onecycle: finite, the last loss below the first;
     scans/s, one profiled step's device ms, its dense-conv share and
     idle share); then CENet's yaml through the train CLI at batch 2 (an
     epoch, a resumed second) and the infer CLI with --save_pred
     --save_raw_ids (one raw id per pixel; its loader must project through
     native.range_project, and the data_time median is logged); no
     counter of the port's kernels may move over the phase;
 15. Waymo MinkUNet mk34_cr16 phases (the yaml as it stands, caps 196,608
     points and 163,840 voxels): every kernel case at its widths
     (mink_shapes of its MODEL block, the _xyz yaml's 3-channel stem, K7 /
     K8 at 409, 204 and 153) on the pyramid of Waymo frame SEED, forward
     and backward, each against its plain version, twice, bit for bit,
     timed, and each kernel's share of its bound beside mk34_cr10's;
     serving (as 4), the eval profile and idle share, the eval reference
     on an 8192-point Waymo frame (as 5), training (as 8), the training
     reference over ten draws of that frame under MinkUNet mk34_cr10's
     rule (as 9); then a ray-cast Waymo tree (WAYMO_ENTRY_FRAMES, cast by
     the reference process once its steps are done), the train CLI at
     the yaml's batch 8 for an epoch and a resumed second (scans/s,
     max_memory_allocated), and the infer CLI on the _infer
     yaml streaming the unlabeled sequence from the last checkpoint (one
     .npy a frame, one id a point);
 16. every shipped yaml that no other phase drives (YAML_CELLS: the other
     Waymo / nuScenes yamls, on the Waymo and a ray-cast nuScenes tree,
     and the other SemanticKITTI ones on the entry tree), and SPVCNN
     mk34_cr10 with MODEL.MULTI_SCALE "none", at full width and batch 1:
     one train and one eval step on a batch of its own view
     (voxel_overflow 0, finite loss, hist = valid points, its family's
     counters launched, none for CENet), then nuScenes CENet through the
     CLIs at batch 1 and its submission dump (lidarseg/val/
     <token>_lidarseg.bin, uint8 raw ids);
 17. tta phase: TTA_VOTES-vote test-time augmentation of MinkUNet
     mk34_cr10 at full width over the entry tree's 2 val scans (the
     view's own votes, one batched forward a scan, every forward kernel
     launched by tta_scan_hist alone, its counts read just after it):
     voxel_overflow 0, the histogram summing to the valid points, the
     host time of building a scan's votes, the batched votes against
     per-vote forwards of a batch-1 task sharing the model (max |dp| <=
     TTA_VOTE_TOL, argmax agreement >= TTA_VOTE_AGREE), one scan's host
     wall and device time and the share of its vote mean, argmax and
     histogram; the same votes of an 8192-point scan on the card and on
     the CPU in float32 (the serving rule: 0.1 of the range, agreement >=
     0.9); one scan each of Cylinder3D cy480_cr10 and CENet 64 x 2048; the
     infer CLI with --tta ending in a logged mIoU;
 18. dp phase: DP_WORLD ranks sharing cuda:0 over gloo
     (openpcseg_torch/parallel/worker.py), MinkUNet mk34_cr10 at full
     width, one ray-cast scan a rank, DP_STEPS steps: every kernel
     launched on every rank and step, both ranks' parameters bit-equal
     after the steps, the first step against its one-process exact
     equivalent (DP_LOSS_REL, the cosines within DP_SPREAD times the
     exact step's own spread under a swap of its scans, the gradient norm
     within DP_NORM_REL), the summed eval
     histogram equal to the ranks' own, the sharded TTA histogram equal to
     one rank's; beside the ranks, openpcseg_torch/cli/dist_train.sh 2
     (an epoch, rank 0's checkpoint, a resumed second epoch, gloo) and
     dist_train.sh 1 (NCCL), whose times are not measurements;
 19. Bottleneck phases (after phase 9, on the entry tree): MinkUNet
     mk34_cr10 with BLOCK Bottleneck (31.8M parameters): every kernel case
     at its widths (bottleneck_shapes: K3 / K6 up to 512, K4 from 1024,
     512 and 384, K5 dfeats to 1024, K7 / K8 at 1024 and 512) forward and
     backward against its plain version, twice, bit for bit, timed, with
     each kernel's share of its bound beside mk34's; serving (as 4), the
     eval profile (per kernel row) and idle share, the eval reference (as
     5), training (as 8, with its profile), the training reference over
     its ten draws under its own JAX reading (TRAIN_REF_MEAN_RULE), the
     CLIs on the mk34 yaml with --set MODEL.BLOCK Bottleneck (an epoch, a
     resumed second, the raw-id dump), and one train step of SPVCNN with
     a Bottleneck;
 20. loss phases (after phase 18): each of the ten losses on the card
     against the CPU in float32 on the same full-scan logits
     (LOSS_VALUE_TOL, LOSS_GRAD_TOL), LOSS_STEPS train steps of each,
     and one train step of every loss at once (and of the sampling pair
     over the extended head) under torch.cuda.set_sync_debug_mode('warn'):
     no sync may start in this slice's modules (SLICE_MODULES); then the
     train CLI with [EQLv2, GroupSoftmax] and adam_onecycle (its buffers
     restored bit for bit on resume) and with the extended GroupSoftmax
     and sgd_fc (the raw-id dump);
 21. crf phase: RangeNet++ 64 x 2048 with MODEL.POST_CRF served, the CRF's
     device ms, its refined probabilities and histogram against the CPU's
     under the range reference rule, one CRF under the sync debug mode;
 22. native phase (once the entry tree of phase 10 is written): the
     SemanticKITTI view's native scan and label readers
     (openpcseg_torch/native.py) built with g++ from the checkout, every
     .bin and .label of the tree read through them and through their
     plain numpy versions (equal arrays), the train CLI loader's first
     batch over the tree (native.READS must move), and the host ms a
     scan of each path (the .bin read; the .label read and remapped);
     then the native range projection (JAX's C++ z-buffer) of the
     ray-cast scan of SEED at 64 x 2048: its pixels against a CPU
     machine's output of the same scan (RANGE_NATIVE_FIXTURE, at most
     PROJECTION_FIXTURE_PIXELS differ)
     and against its plain numpy version (at most PROJECTION_PLAIN_SHARE
     of the image), and the host ms of each;
 23. jax_ckpt phase (on the entry tree): a JAX training run carried to the
     card, as JAX_CKPT_FIXTURE (made by tests/jax_ckpt_fixture.py on the
     CPU, where JAX runs) holds it: the narrow
     MinkUNet of JAX_CKPT_SETS after two float32 SGD steps, converted,
     restored by Trainer.restore (step, epoch and every momentum buffer on
     the card); its bf16 eval logits on the 8192-point scan of SEED
     against JAX's float32 ones (the serving rule), one bf16 train step
     against JAX's float32 step under train_ref_rule of JAX's own reading
     on the fixture (the expectations' `reading`); the train CLI with
     --ckp (resumes at the fixture's epoch + 1 for one epoch) and the
     infer CLI with --ckp (the raw-id dump); every counter of
     MINK_COUNTERS over the phase.
The run's total time is logged.
Every kernel case carries CUDA-event ms of the wrapper and of the plain
version, the kernel's profiler device ms, and its bound (bound_ms: bytes
over the memory rate or operations over the peak rate, whichever is
larger, from the case's own shapes and hits; a profiler window that
reads less than the bound is taken again); K7 and
K8 also the time of torch.sparse.mm over the same table as a CSR matrix (library_ms), which the port never calls.
--phases runs the named phases alone, after the build, in their order,
and prints no result line: cases (3 and 7: the kernel half of an A/B
call), minkunet (4-6, 8, 9), native (22), bottleneck (19), spvcnn (11),
range (14), dp (18), cylinder (12), rpvnet (13), entry (10), jax_ckpt
(23), waymo (15), yamls (16, with waymo), tta (17, with entry), loss_zoo
and loss_clis (20), crf (21).
Then the kernel JSON line, the card line and the result line.
The full report (every kernel case, request, step and profiler row) goes
to --report, by default build/openpcseg_torch/chip_smoke.json.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import hashlib
import inspect
import json
import os
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

ROOT = Path(__file__).resolve().parent

# == the MODEL block of tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr10.yaml
MODEL_CFG = {
    "NAME": "MinkUNet",
    "IGNORE_LABEL": 0,
    "IN_FEATURE_DIM": 4,
    "BLOCK": "ResBlock",
    "NUM_LAYER": [2, 3, 4, 6, 2, 2, 2, 2],
    "PLANES": [32, 32, 64, 128, 256, 256, 128, 96, 96],
    "cr": 1.0,
    "DROPOUT_P": 0.0,
    "LABEL_SMOOTHING": 0.1,
    "IF_DIST": True,
}
# == the OPTIM block of the same yaml
OPTIM_CFG = {
    "BATCH_SIZE_PER_GPU": 12,
    "NUM_EPOCHS": 36,
    "OPTIMIZER": "sgd",
    "LR_PER_SAMPLE": 0.02,
    "WEIGHT_DECAY": 0.0001,
    "MOMENTUM": 0.9,
    "NESTEROV": True,
    "GRAD_NORM_CLIP": 10,
    "SCHEDULER": "linear_warmup_with_cosdecay",
    "WARMUP_EPOCH": 1,
}
CFGS = {
    "MODALITY": "voxel",
    "DATA": {"DATASET": "semantickitti", "VOXEL_SIZE": 0.05},
    "MODEL": MODEL_CFG,
    "TPU": {"POINT_CAP_PER_SCAN": 131072, "VOXEL_CAP_PER_SCAN": 98304},
}
TRAIN_CFGS = dict(CFGS, OPTIM=OPTIM_CFG)
NUM_CLASS = 20
N_POINTS = 131072
SEED = 0
REQUESTS = 6          # timed requests, after one warm-up request
KERNEL_REPS = 20      # launches per timing of a kernel or its plain version
# kernel vs plain on the card: both take the same bf16 operands and sum in
# float32, so they differ by summation order only (K4's plain version also
# rounds its per-offset products to bf16, as JAX's _up2_fwd_impl does)
KERNEL_TOL = 2e-2     # max|kernel - plain| <= KERNEL_TOL * max|plain|
TRAIN_STEPS = 10      # on one repeated scan, batch 1 (LR = 0.02 x 1 x 1)
ITERS_PER_EPOCH = 4   # so the one-epoch warm-up ends at step 4 of the run
# training reference: one step from the same weights, GPU bf16 kernels
# against the CPU float32 plain versions, read as (|loss_gpu - loss_cpu| /
# |loss_cpu|, cosine of the whole gradient vector, worst cosine of a conv
# weight's gradient), on each of TRAIN_REF_DRAWS inputs: the 8192-point
# scan of SEED, then copies of it whose features are scaled by 1 + 1e-3
# N(0, 1) (train_ref_draws), from the weights seed_weights(SEED), which
# numpy draws alike on every machine (TRAIN_REF_INPUTS is their digest
# with MinkUNet, SPV_TRAIN_REF_INPUTS with SPVCNN). JAX_TRAIN_READING is
# JAX's own reading of the same thing on each draw, its bf16 train step
# against its float32 one from the same weights on the CPU, and
# PORT_CPU_BF16_READING the port's plain versions in bf16 against float32
# on the CPU (tests/test_torch_train_ref.py prints both); the SPV_ ones
# are SPVCNN's. The rule, per model over its draws (a per-draw loss row
# from one other draw of bf16 rounding settles nothing): the mean of the
# card's relative loss differences is at most twice JAX's mean
# (train_ref_rule); each draw's cosines are within its row, JAX's reading
# on that draw less TRAIN_REF_MARGIN; and each draw is within TRAIN_GROSS.
# Any miss fails the run. The kernels are held to their plain versions
# one by one in the kernel phases.
TRAIN_REF_DRAWS = 10
TRAIN_REF_NOISE = 1e-3
TRAIN_REF_MARGIN = 0.02
# inputs_digest of train_ref_draws() and a model under seed_weights(SEED)
TRAIN_REF_INPUTS = "f0b40fad44a5cba0"
JAX_TRAIN_READING = ((4.0223e-4, 0.966321, 0.862872),
                     (2.3018e-4, 0.967252, 0.863532),
                     (7.8872e-5, 0.966167, 0.865999),
                     (2.3945e-4, 0.967052, 0.877830),
                     (1.6237e-4, 0.968972, 0.895976),
                     (1.5333e-4, 0.963664, 0.866023),
                     (2.4387e-4, 0.968933, 0.857149),
                     (5.5336e-5, 0.967218, 0.842825),
                     (2.0011e-4, 0.967062, 0.883094),
                     (1.1540e-4, 0.966667, 0.880206))
PORT_CPU_BF16_READING = ((3.4931e-4, 0.964768, 0.862494),
                         (1.4014e-4, 0.969844, 0.877395),
                         (1.9788e-4, 0.967117, 0.868496),
                         (1.9116e-6, 0.967005, 0.877750),
                         (3.1288e-5, 0.971083, 0.889419),
                         (2.0475e-4, 0.965778, 0.880202),
                         (2.6660e-5, 0.968785, 0.867482),
                         (1.0826e-4, 0.966142, 0.866798),
                         (1.3220e-4, 0.967065, 0.881054),
                         (2.4569e-4, 0.968086, 0.879791))
SPV_TRAIN_REF_INPUTS = "13c7c4ccb96fb8a4"
JAX_SPV_TRAIN_READING = ((2.8894e-4, 0.975227, 0.854738),
                         (2.3646e-4, 0.977663, 0.879269),
                         (1.1482e-4, 0.976139, 0.874341),
                         (5.9817e-5, 0.978588, 0.889694),
                         (7.2581e-6, 0.978313, 0.889305),
                         (3.1833e-5, 0.977764, 0.882306),
                         (1.9606e-4, 0.979280, 0.874014),
                         (9.5062e-5, 0.978290, 0.872282),
                         (1.1176e-4, 0.976842, 0.880260),
                         (4.4774e-5, 0.977760, 0.886794))
PORT_CPU_SPV_BF16_READING = ((3.2409e-4, 0.975494, 0.864278),
                             (1.9816e-4, 0.980144, 0.891610),
                             (1.9238e-4, 0.977760, 0.887742),
                             (1.1474e-4, 0.978030, 0.889503),
                             (1.6178e-5, 0.980099, 0.893592),
                             (1.6389e-4, 0.976064, 0.887188),
                             (4.3462e-5, 0.978918, 0.890387),
                             (4.5738e-5, 0.977219, 0.879885),
                             (7.0487e-5, 0.975945, 0.875965),
                             (1.4491e-4, 0.978047, 0.880337))


def train_ref_rule(reading):
    """The rule a model's JAX reading sets: (the bound on the mean relative
    loss difference, twice JAX's mean; per draw its cosine row, JAX's
    whole-gradient and worst conv cosines less TRAIN_REF_MARGIN)."""
    return (2 * statistics.fmean(r[0] for r in reading),
            tuple((cos_all - TRAIN_REF_MARGIN, cos_conv - TRAIN_REF_MARGIN)
                  for _, cos_all, cos_conv in reading))


TRAIN_REF_LOSS_MEAN, TRAIN_REF = train_ref_rule(JAX_TRAIN_READING)
SPV_TRAIN_REF_LOSS_MEAN, SPV_TRAIN_REF = train_ref_rule(JAX_SPV_TRAIN_READING)
def train_ref_floor(reading):
    """The floor a model's JAX reading sets under any one step against the
    CPU float32 step: a gross loss difference, and the cosines of the
    spread of JAX's draws, their lowest less TRAIN_REF_MARGIN (every row
    of the model lies above it)."""
    return (0.03, min(r[1] for r in reading) - TRAIN_REF_MARGIN,
            min(r[2] for r in reading) - TRAIN_REF_MARGIN)


# MinkUNet's floor; SPVCNN's rows lie above it too, Cylinder3D's do not
# (JAX's own worst conv cosine reads 0.8184 on one draw), and each model's
# draws are held to its own floor and rows
TRAIN_GROSS = train_ref_floor(JAX_TRAIN_READING)
FWD_COUNTERS = ("subm", "down", "up", "devox")
# SPVCNN's mean-voxelize (K8 over the p2v table) and its backward (K7)
SPV_COUNTERS = ("vmean", "vmean_bwd")
# MinkUNet's path: every counter but SPVCNN's and Cylinder3D's
MINK_COUNTERS = ("subm", "down", "up", "devox", "subm_bwd", "down_bwd",
                 "up_bwd", "dw", "devox_bwd")
# Cylinder3D's path: its submanifold convs (3^3 and anisotropic) on K1 / K2
# and dW, its k3 strided convs on the gather-GEMM (forward, dfeats) and
# gather_dw (dW), and its refinement gather over the level-0 p2v table (K7
# forward, K8 backward: the vmean counters)
CYL_FWD = ("subm", "strided", "vmean_bwd")
CYL_NEED = CYL_FWD + ("subm_bwd", "dw", "strided_bwd", "strided_dw",
                      "vmean")
# entry-point phase: the train CLI on the yaml as it stands, at this batch,
# over a ray-cast tree of (train scans in 00, val scans in 08)
ENTRY_CFG = "tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr10.yaml"
ENTRY_BATCH = 2
ENTRY_SCANS = (4, 2)
NATIVE_REPS = 5          # timed reads of each entry-tree file a reader path
# the native range projection (native_phase): the ray-cast scan of SEED
# projected at 64 x 2048 on a CPU machine by the same source with the
# same flags (tests/test_torch_range_native.py writes it and holds it to
# the output of the machine that runs the tests). Two glibc builds may
# round atan2f / asinf apart, so at most 0.05% of the pixels (65 of
# 131,072) may differ; the plain numpy z-buffer (float64 angles) within
# 1% of the image (146 mask, 462 scan and 161 label pixels where the
# fixture was made). PROJECTION_REPS timed projections of each, in turns
RANGE_NATIVE_FIXTURE = ("openpcseg_torch/tools/fixtures/"
                        "range_native_raycast.npz")
PROJECTION_FIXTURE_PIXELS = 65
PROJECTION_PLAIN_SHARE = 0.01
PROJECTION_REPS = 10
# the depth of the network in the entry phase's step against the CPU
# float32 step (entry_reference): its stages cut to one block each, to
# hold the whole run inside its time (the CPU step at the yaml's depth took
# 111 s of the card machine's CPU); its batch and widths are the CLI's
ENTRY_REF_LAYERS = [1] * 8
# == the jax_ckpt phase: a JAX run's checkpoint, converted where JAX runs
# (tests/jax_ckpt_fixture.py: the entry yaml's
# MinkUNet narrowed by JAX_CKPT_SETS, which keeps the fixture and its
# expectations under 4 MB, after two float32 SGD steps on the 8192-point
# scan of SEED at batch 1 and cap JAX_CKPT_CAP), and what JAX computed
# from it (_expect.npz: its float32 eval logits on that scan, its third
# step's loss, lr, raw gradient and parameters, and its own bf16 step
# against its float32 one on that scan and nine feature-perturbed copies,
# `reading`, whose rule the card's step on the scan is held to)
JAX_CKPT_FIXTURE = "openpcseg_torch/tools/fixtures/jax_ckpt_mk_narrow"
JAX_CKPT_SETS = ("MODEL.NUM_LAYER", "[1,1,1,1,1,1,1,1]", "MODEL.cr", "0.125")
JAX_CKPT_CAP = 8192
# == the MODEL and OPTIM blocks of tools/cfgs/fusion/semantic_kitti/
# spvcnn_mk34_cr10.yaml: SPVCNN's serving, reference, training and entry
# phases; its convs have MinkUNet mk34's shapes, so the kernel cases above
# cover them, and its mean-voxelize's cases are at VMEAN
SPV_MODEL_CFG = dict(MODEL_CFG, NAME="SPVCNN")
SPV_OPTIM_CFG = dict(OPTIM_CFG, BATCH_SIZE_PER_GPU=16)
SPV_CFGS = dict(CFGS, MODALITY="fusion", MODEL=SPV_MODEL_CFG)
SPV_TRAIN_CFGS = dict(SPV_CFGS, OPTIM=SPV_OPTIM_CFG)
SPV_ENTRY_CFG = "tools/cfgs/fusion/semantic_kitti/spvcnn_mk34_cr10.yaml"
VMEAN = [(4, 256), (2, 128)]    # (p2v level, C): z1 into L4, z2 into L2
# == the blocks of tools/cfgs/voxel/semantic_kitti/cylinder_cy480_cr10.yaml
# (its OPTIM block is the mk34 yaml's): Cylinder3D's phases
CYL_MODEL_CFG = {
    "NAME": "Cylinder_TS",
    "IGNORE_LABEL": 0,
    "IN_FEATURE_DIM": 9,
    "DROPOUT_P": 0.0,
    "LABEL_SMOOTHING": 0.0,
    "INIT_SIZE": 32,
    "POINT_REFINEMENT": True,
    "IF_DIST": True,
}
CYL_CFGS = {
    "MODALITY": "cylinder",
    "DATA": {"DATASET": "semantickitti",
             "CYLINDER_GRID_SIZE": [480, 360, 32],
             "CYLINDER_SPACE_MAX": [50, 180, 2],
             "CYLINDER_SPACE_MIN": [0, -180, -4]},
    "MODEL": CYL_MODEL_CFG,
    "TPU": {"POINT_CAP_PER_SCAN": 131072, "VOXEL_CAP_PER_SCAN": 98304,
            "VOXEL_CAP_RATIOS": [1.0, 0.55, 0.3, 0.2, 0.15]},
}
CYL_TRAIN_CFGS = dict(CYL_CFGS, OPTIM=OPTIM_CFG)
CYL_ENTRY_CFG = "tools/cfgs/voxel/semantic_kitti/cylinder_cy480_cr10.yaml"
CYL_TRAIN_REF_INPUTS = "1c93deddac9ac2a3"
JAX_CYL_TRAIN_READING = ((1.0630e-4, 0.979020, 0.850750),
                         (5.4573e-5, 0.983082, 0.827842),
                         (6.0481e-5, 0.986186, 0.857272),
                         (6.8105e-5, 0.975578, 0.864149),
                         (2.5805e-5, 0.986278, 0.873207),
                         (6.5025e-5, 0.983732, 0.850572),
                         (1.0789e-4, 0.979714, 0.826652),
                         (1.3552e-4, 0.982435, 0.850376),
                         (4.7976e-5, 0.981643, 0.818435),
                         (5.2981e-5, 0.984151, 0.824961))
PORT_CPU_CYL_BF16_READING = ((2.0116e-5, 0.985820, 0.856317),
                             (1.5002e-5, 0.978819, 0.830292),
                             (7.6934e-5, 0.986498, 0.882815),
                             (7.3871e-5, 0.985416, 0.870767),
                             (1.3467e-4, 0.986376, 0.894934),
                             (4.7387e-5, 0.982571, 0.868790),
                             (3.0684e-6, 0.985430, 0.877124),
                             (1.1296e-4, 0.984965, 0.858687),
                             (3.3754e-5, 0.983987, 0.872928),
                             (1.3639e-5, 0.982681, 0.845566))
CYL_TRAIN_REF_LOSS_MEAN, CYL_TRAIN_REF = train_ref_rule(JAX_CYL_TRAIN_READING)
# == the blocks of tools/cfgs/fusion/semantic_kitti/rpvnet_mk34_cr17_5.yaml
# as it stands: RPVNet's phases (widths 56-448, bf16 voxel branch, float32
# range branch over the 64 x 2048 image of each scan, golden_run.to_fusion)
RPV_MODEL_CFG = {
    "NAME": "RPVNet",
    "IGNORE_LABEL": 0,
    "IN_FEATURE_DIM": 5,
    "BLOCK": "ResBlock",
    "NUM_LAYER": [2, 3, 4, 6, 2, 2, 2, 2],
    "PLANES": [32, 32, 64, 128, 256, 256, 128, 96, 96],
    "cr": 1.75,
    "DROPOUT_P": 0.0,
    "LABEL_SMOOTHING": 0.1,
    "IF_DIST": True,
}
RPV_OPTIM_CFG = dict(OPTIM_CFG, BATCH_SIZE_PER_GPU=4)
RPV_CFGS = {
    "MODALITY": "fusion",
    "DATA": {"DATASET": "semantickitti", "VOXEL_SIZE": 0.05},
    "MODEL": RPV_MODEL_CFG,
    "TPU": {"POINT_CAP_PER_SCAN": 131072, "VOXEL_CAP_PER_SCAN": 98304},
}
RPV_TRAIN_CFGS = dict(RPV_CFGS, OPTIM=RPV_OPTIM_CFG)
RPV_ENTRY_CFG = "tools/cfgs/fusion/semantic_kitti/rpvnet_mk34_cr17_5.yaml"
# its range fusion: K7 over the 4-corner bilinear tables (r2p), K8 over
# their transposes (r2p_bwd), K8 over the pixel tables (p2r, the mean's
# sum) and K7 over them (p2r_bwd)
RPV_FWD = FWD_COUNTERS + ("vmean", "r2p", "p2r")
RPV_NEED = MINK_COUNTERS + SPV_COUNTERS + ("r2p", "r2p_bwd", "p2r",
                                          "p2r_bwd")
# the training reference's draws through golden_run.to_fusion (digest with
# seed_weights(SEED) on RPVNet), JAX's bf16-against-f32 reading of them
# and the port's CPU one (tests/test_torch_train_ref.py -m slow -k rpvnet)
RPV_TRAIN_REF_INPUTS = "e2d7102bc343c6c8"
JAX_RPV_TRAIN_READING = ((7.3699e-05, 0.998842, 0.935502),
                         (7.7938e-05, 0.998881, 0.935581),
                         (1.1532e-04, 0.998620, 0.930750),
                         (7.0292e-05, 0.998722, 0.929631),
                         (5.8010e-05, 0.998866, 0.933994),
                         (1.5392e-04, 0.998862, 0.927832),
                         (5.2325e-05, 0.998874, 0.935461),
                         (5.7185e-05, 0.998939, 0.937135),
                         (7.8458e-06, 0.998855, 0.934650),
                         (7.1232e-05, 0.998893, 0.932115))
PORT_CPU_RPV_BF16_READING = ((1.8043e-04, 0.998921, 0.929512),
                             (3.0298e-04, 0.998931, 0.937686),
                             (1.7158e-04, 0.998646, 0.933110),
                             (1.7341e-05, 0.998840, 0.929716),
                             (1.7805e-04, 0.998869, 0.934128),
                             (1.4060e-04, 0.998806, 0.932669),
                             (3.0549e-05, 0.998908, 0.936106),
                             (2.2090e-05, 0.998808, 0.924216),
                             (1.6435e-04, 0.998700, 0.923186),
                             (1.1500e-04, 0.998867, 0.935461))
# the card also runs RPVNet's range convs in TF32 (cuDNN at torch's
# default), which JAX's reading does not see. RPV_TF32_READING is the CPU
# emulation of it (python -m openpcseg_torch.cli.range_tf32 --train: the
# float32 step with every range conv's operands rounded to TF32, forward
# and backward, against the float32 step, on draws 0-4 of the training
# reference, the worst of the five per field, on the card machine's CPU
# before the first card run of the reference): (loss rel, whole-gradient
# cosine, worst conv cosine). A1's rule widens JAX's rule by twice it:
# the loss bounds by 2 x its loss rel, the cosine rows and floor by 2 x
# (1 - its cosines).
RPV_TF32_READING = (3.4021e-04, 0.99929915, 0.98126717)
# the training reference of each model: (train config, digest of the draws
# and seed_weights(SEED), JAX's reading, the port's CPU bf16 reading,
# report key, log tag)
TRAIN_REF_MODELS = {
    "MinkUNet": (TRAIN_CFGS, TRAIN_REF_INPUTS, JAX_TRAIN_READING,
                 PORT_CPU_BF16_READING, "train_reference", "train-ref"),
    "SPVCNN": (SPV_TRAIN_CFGS, SPV_TRAIN_REF_INPUTS, JAX_SPV_TRAIN_READING,
               PORT_CPU_SPV_BF16_READING, "spvcnn_train_reference",
               "spv-train-ref"),
    "Cylinder_TS": (CYL_TRAIN_CFGS, CYL_TRAIN_REF_INPUTS,
                    JAX_CYL_TRAIN_READING, PORT_CPU_CYL_BF16_READING,
                    "cylinder_train_reference", "cyl-train-ref"),
    "RPVNet": (RPV_TRAIN_CFGS, RPV_TRAIN_REF_INPUTS, JAX_RPV_TRAIN_READING,
               PORT_CPU_RPV_BF16_READING, "rpvnet_train_reference",
               "rpv-train-ref"),
}
# the least time a call could take (bound_ms): the larger of the bytes it
# must move (each input read once, each output written once) over the
# memory rate, and its operations over the peak rate of their type. NVIDIA's
# published H100 SXM peaks at a 700 W power limit; the card line says what
# limit this card runs at.
HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS = 989e12     # bf16 tensor cores, dense (K1-K6, dW)
F32_FLOPS = 67e12          # float32 outside the tensor cores (K7, K8)

KERNELS = {
    "K1_subm_conv": dict(
        route="cuda", source="openpcseg_torch/csrc/gather_gemm.cu",
        replaces="openpcseg_tpu/ops/pallas_conv.py:364", counter="subm"),
    "K3_down_conv": dict(
        route="cuda", source="openpcseg_torch/csrc/gather_gemm.cu",
        replaces="openpcseg_tpu/ops/pallas_updown.py:144", counter="down"),
    "K4_up_conv": dict(
        route="cuda", source="openpcseg_torch/csrc/parent_gemm.cu",
        replaces="openpcseg_tpu/ops/pallas_updown.py:219", counter="up"),
    "K7_devoxelize": dict(
        route="cuda", source="openpcseg_torch/csrc/devox.cu",
        replaces="openpcseg_tpu/ops/pallas_devox.py:109", counter="devox"),
    # backward kernels: dW of K2 / K5 / K6 is csrc/gather_dw.cu; their
    # dfeats passes run gather_gemm.cu (K2, K5) and parent_gemm.cu (K6)
    "K2_subm_conv_bwd": dict(
        route="cuda", source="openpcseg_torch/csrc/gather_dw.cu",
        dfeats_source="openpcseg_torch/csrc/gather_gemm.cu",
        replaces="openpcseg_tpu/ops/pallas_conv.py:459", counter="subm_bwd"),
    "K5_up_conv_bwd": dict(
        route="cuda", source="openpcseg_torch/csrc/gather_dw.cu",
        dfeats_source="openpcseg_torch/csrc/gather_gemm.cu",
        replaces="openpcseg_tpu/ops/pallas_updown.py:144", counter="up_bwd"),
    "K6_down_conv_bwd": dict(
        route="cuda", source="openpcseg_torch/csrc/gather_dw.cu",
        dfeats_source="openpcseg_torch/csrc/parent_gemm.cu",
        replaces="openpcseg_tpu/ops/pallas_updown.py:219",
        counter="down_bwd"),
    "K8_devoxelize_bwd": dict(
        route="cuda", source="openpcseg_torch/csrc/devox.cu",
        replaces="openpcseg_tpu/ops/pallas_devox.py:277",
        counter="devox_bwd", vmean_counter="vmean"),
}
KERNELS["K7_devoxelize"]["vmean_counter"] = "vmean_bwd"
# the counters of each kernel on Cylinder3D's path: K1 / K2 its submanifold
# convs (3^3 and anisotropic) and their dW; K3 and K5 the gather-GEMM and
# gather_dw over its k3 strided maps, forward and backward (JAX runs these
# convs on XLA, not on a Pallas kernel); K7 / K8 its refinement gather over
# the level-0 p2v table and its backward
# the counters of each kernel on RPVNet's path: MinkUNet's and SPVCNN's,
# and K7 / K8 over its range tables (r2p and p2r_bwd are K7, r2p_bwd and
# p2r K8)
for _name, _rpv in (("K1_subm_conv", ("subm",)),
                    ("K2_subm_conv_bwd", ("subm_bwd", "dw")),
                    ("K3_down_conv", ("down",)), ("K4_up_conv", ("up",)),
                    ("K5_up_conv_bwd", ("up_bwd",)),
                    ("K6_down_conv_bwd", ("down_bwd",)),
                    ("K7_devoxelize", ("devox", "vmean_bwd", "r2p",
                                       "p2r_bwd")),
                    ("K8_devoxelize_bwd", ("devox_bwd", "vmean", "r2p_bwd",
                                           "p2r"))):
    KERNELS[_name]["rpv_counters"] = _rpv
# the kernels line's rows of RPVNet's range fusion, each one of K7 / K8
# over a range table: (kernel, its counter, the label of its cases)
RANGE_FUSION_ROWS = {
    "K7_range_to_point": ("K7_devoxelize", "r2p", "rpv r2p"),
    "K8_range_to_point_bwd": ("K8_devoxelize_bwd", "r2p_bwd", "rpv r2p"),
    "K8_point_to_range": ("K8_devoxelize_bwd", "p2r", "rpv p2r"),
    "K7_point_to_range_bwd": ("K7_devoxelize", "p2r_bwd", "rpv p2r"),
}
for _name, _cyl in (("K1_subm_conv", ("subm",)),
                    ("K2_subm_conv_bwd", ("subm_bwd", "dw")),
                    ("K3_down_conv", ("strided",)), ("K4_up_conv", ()),
                    ("K5_up_conv_bwd", ("strided_bwd", "strided_dw")),
                    ("K6_down_conv_bwd", ()), ("K7_devoxelize", ("vmean_bwd",)),
                    ("K8_devoxelize_bwd", ("vmean",))):
    KERNELS[_name]["cyl_counters"] = _cyl


def mink_shapes(model_cfg):
    """The kernel shapes of a MinkUNet MODEL block, from its widths cs =
    int(cr x PLANES): (level, Cin, Cout) of every submanifold conv (the
    stem; each down stage's first block, when it widens, and the rest; each
    up stage's first conv over the concatenation with the skip, and the
    rest), (coarse level, C) of the down convs, (fine level, Cin, Cout) of
    the up convs and (level, C) of the devoxelizes of levels 4 and 2 (level
    0's is the identity: the points are its voxels). mk34_cr10: 4 -> 32 ...
    96; Waymo's mk34_cr16: 5 -> 51 ... 153."""
    cs = [int(model_cfg.get("cr", 1.0) * x) for x in model_cfg["PLANES"]]
    subm = [(0, model_cfg["IN_FEATURE_DIM"], cs[0]), (0, cs[0], cs[0])]
    for i in range(4):
        if cs[i] != cs[i + 1]:
            subm.append((i + 1, cs[i], cs[i + 1]))
        subm.append((i + 1, cs[i + 1], cs[i + 1]))
    for i in range(4):
        subm += [(3 - i, cs[5 + i] + cs[3 - i], cs[5 + i]),
                 (3 - i, cs[5 + i], cs[5 + i])]
    downs = [(i + 1, cs[i]) for i in range(4)]
    ups = [(3 - i, cs[4 + i], cs[5 + i]) for i in range(4)]
    return subm, downs, ups, [(4, cs[4]), (2, cs[6])]


# (level, Cin, Cout), (coarse level, C), (fine level, Cin, Cout), (level, C)
SUBM_PAIRS, DOWNS, UPS, DEVOX = mink_shapes(MODEL_CFG)
DEVOX_CHUNKS = (16, 32, 64, 128)  # K8 segment lengths timed per DEVOX case


def log(*a):
    print(*a, flush=True)


def free_card() -> None:
    """Collect the objects earlier phases left in reference cycles (their
    tasks, models and optimizers) and return the allocator's cached
    blocks to the card: the wide Bottleneck phases leave blocks of other
    sizes cached, and Waymo's batch-8 CLI needs ~63 GiB."""
    gc.collect()
    torch.cuda.empty_cache()


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def events_ms(fn, reps: int) -> float:
    """Device time per call of fn() by CUDA events, with the host ahead of
    the card: a spin kernel (torch.cuda._sleep, ~10 ms) holds the card
    while the host enqueues `reps` calls, so the events time the calls'
    kernels and the gaps between them, not the host's enqueue (a host
    slower than the spin reads high, never low)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def parentless_rows(plan):
    """Fine rows without a parent (the plan's group 8): the parent gather
    must write exact zeros there."""
    return plan.dst_rows[int(plan.group_offsets[8]):].long()


# -- the work of one call: (bytes it must move, operations, peak rate) ----

def _rows(idx) -> int:
    """Distinct rows an index array reads (-1 reads none)."""
    return int(torch.unique(idx[idx >= 0]).numel())


def gemm_work(feats, w, kmap):
    """Gather-GEMM (K1, K3, the dfeats of K2 and K5): the map, each source
    row it hits, W, the f32 output; 2 Cin Cout operations per hit."""
    k, cin, cout = w.shape
    return (kmap.numel() * 4 + _rows(kmap) * cin * 2
            + kmap.shape[1] * cout * 4 + k * cin * cout * 2,
            2 * int((kmap >= 0).sum()) * cin * cout, BF16_TC_FLOPS)


def dw_work(a, ia, b, ib):
    """Gathered weight gradient: the maps, each row of A and of B a live
    pair reads, the f32 dW; 2 Ca Cb operations per live pair."""
    idx = ia if ia is not None else ib
    k, n = idx.shape
    ident = torch.arange(n, device=idx.device).expand(k, n)
    ra = ident if ia is None else ia
    rb = ident if ib is None else ib
    live = (ra >= 0) & (rb >= 0)
    ca, cb = a.shape[1], b.shape[1]
    maps = sum(m.numel() * 4 for m in (ia, ib) if m is not None)
    return (maps + _rows(ra[live]) * ca * 2 + _rows(rb[live]) * cb * 2
            + k * ca * cb * 4, 2 * int(live.sum()) * ca * cb, BF16_TC_FLOPS)


def parent_work(src, w, plan):
    """Parent gather (K4, K6's dfeats): the plan's two row tables, each
    parent row, W, the f32 output; 2 Cin Cout operations per fine row with
    a parent."""
    k, cin, cout = w.shape
    n = plan.dst_rows.numel()
    par = int(plan.group_offsets[8])
    return (2 * n * 4 + _rows(plan.src_rows[:par]) * cin * 2 + n * cout * 4
            + k * cin * cout * 2, 2 * par * cin * cout, BF16_TC_FLOPS)


def devox_work(x, idx, w):
    """K7: the corner indices and weights, each voxel row hit, the output;
    2 C operations per live corner (f32 on the CUDA cores)."""
    c, es = x.shape[1], x.element_size()
    return (idx.numel() * 8 + _rows(idx) * c * es + idx.shape[1] * c * es,
            2 * int((idx >= 0).sum()) * c, F32_FLOPS)


def devox_bwd_work(d, tbl):
    """K8: the CSR transpose (offsets, points, weights), each point row a
    contributor reads, dvox; 2 C operations per contributor. Its segment
    table and f32 scratch are not counted."""
    nnz = int(tbl.t_ptr[-1])
    c, es = d.shape[1], d.element_size()
    return ((tbl.num_voxels + 1) * 4 + nnz * 8
            + _rows(tbl.t_point[:nnz]) * c * es + tbl.num_voxels * c * es,
            2 * nnz * c, F32_FLOPS)


def sum_work(z, tbl):
    """voxel_sum (K8 over a one-corner p2v table): the transpose's offsets
    and points (not its weights, all 1), each point row once, the sums; C
    additions per point (f32 on the CUDA cores)."""
    nnz = int(tbl.t_ptr[-1])
    c, es = z.shape[1], z.element_size()
    return ((tbl.num_voxels + 1) * 4 + nnz * 4 + nnz * c * es
            + tbl.num_voxels * c * es, nnz * c, F32_FLOPS)


def gather_work(dy, tbl):
    """point_gather (K7 over a one-corner p2v table): the p2v, each voxel
    row it hits once, the output; no arithmetic."""
    p2v = tbl.idx[0]
    c, es = dy.shape[1], dy.element_size()
    return (p2v.numel() * 4 + _rows(p2v) * c * es + p2v.numel() * c * es, 0,
            F32_FLOPS)


def both(*works):
    """Two passes of one backward: their bytes and operations added."""
    return (sum(w[0] for w in works), sum(w[1] for w in works),
            works[0][2])


def bound(work):
    """(bound_ms, bound_by) of a call's (bytes, operations, peak)."""
    t_bytes, t_ops = work[0] / HBM_BYTES_PER_S, work[1] / work[2]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sparse_library(m, x):
    """torch.sparse.mm(m, x) in x's type, the one PyTorch call that computes
    K7 (m the devox table as a CSR [N, V]) or K8 (its transpose [V, N])."""
    m = m.to(x.dtype)
    return lambda: torch.sparse.mm(m, x)


def devox_csr(idx, w, n_vox):
    """K7's table as a CSR matrix [N, V]: row p holds weight w[c, p] at
    column idx[c, p] for each live corner c."""
    hit = idx >= 0
    pts = torch.arange(idx.shape[1], device=idx.device).expand_as(idx)[hit]
    return torch.sparse_coo_tensor(
        torch.stack([pts, idx[hit].long()]), w[hit],
        (idx.shape[1], n_vox)).coalesce().to_sparse_csr()


def devox_t_csr(tbl, n_points):
    """K8's table, the CSR transpose K8 walks, as a CSR matrix [V, N]."""
    nnz = int(tbl.t_ptr[-1])
    return torch.sparse_csr_tensor(tbl.t_ptr, tbl.t_point[:nnz],
                                   tbl.t_weight[:nnz],
                                   (tbl.num_voxels, n_points))


def case(kernel, label, kern, plain, args, work, zero_rows=None,
         library=None):
    """One kernel case: its wrapper and plain version on the same args,
    the work that sets its bound, output rows that must be exactly 0 (or
    None), and the one PyTorch call that computes the same (or None)."""
    return dict(kernel=kernel, label=label, kern=kern, plain=plain,
                args=args, work=work, zero_rows=zero_rows, library=library)


def kernel_cases(pyr, gen, subm=SUBM_PAIRS, downs=DOWNS, ups=UPS,
                 devox_shapes=DEVOX, tag=""):
    """The forward kernels' cases at main-path shapes: every channel pair
    the mk34 forward gives each kernel (or the shapes given), on the
    levels where it gives it, with seeded bf16 features (zero on padding
    rows); each label starts with `tag`."""
    from openpcseg_torch.ops import devox, subm_conv, updown

    def up_plain(x, w, km, plan):
        return updown.up_conv_plain(x, w, km)

    def feats(level, c):
        lv = pyr.levels[level]
        x = torch.randn(lv.capacity, c, device="cuda", generator=gen)
        return torch.where(lv.valid[:, None], x, 0.0).to(torch.bfloat16)

    def weight(k, cin, cout):
        return (torch.randn(k, cin, cout, device="cuda", generator=gen)
                / (k * cin) ** 0.5).to(torch.bfloat16)

    cases = []
    for level, cin, cout in subm:
        args = (feats(level, cin), weight(27, cin, cout),
                pyr.levels[level].subm_kmap)
        cases.append(case("K1_subm_conv", f"{tag}L{level} {cin}->{cout}",
                          subm_conv.subm_conv, subm_conv.subm_conv_plain,
                          args, gemm_work(*args)))
    for level, c in downs:
        args = (feats(level - 1, c), weight(8, c, c),
                pyr.levels[level].down_kmap)
        cases.append(case("K3_down_conv",
                          f"{tag}L{level - 1}->L{level} {c}->{c}",
                          updown.down_conv, updown.down_conv_plain, args,
                          gemm_work(*args)))
    for level, cin, cout in ups:
        plan = pyr.levels[level + 1].parity_plan
        args = (feats(level + 1, cin), weight(8, cin, cout),
                pyr.levels[level].up_kmap, plan)
        cases.append(case("K4_up_conv", f"{tag}L{level + 1}->L{level} "
                          f"{cin}->{cout}", updown.up_conv, up_plain, args,
                          parent_work(args[0], args[1], plan),
                          zero_rows=parentless_rows(plan)))
    for level, c in devox_shapes:
        tbl = pyr.devox[level]
        args = (feats(level, c), tbl.idx, tbl.weights)
        m = devox_csr(tbl.idx, tbl.weights, pyr.levels[level].capacity)
        cases.append(case("K7_devoxelize", f"{tag}L{level} C={c}",
                          devox.devoxelize, devox.devoxelize_plain, args,
                          devox_work(*args),
                          library=sparse_library(m, args[0])))
    return cases


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


def check_cases(cases, tag, timed=True):
    """Each case's kernel against its plain version, per output, twice bit
    for bit; then, when `timed`, its times: CUDA-event ms per call of the
    wrapper and of the plain version, the kernel's device ms under the
    profiler (CUDA events read the host's enqueue once a kernel is this
    fast), its bound, and the library call's ms where there is one."""
    rows = []
    for c in cases:
        kern, plain, args = c["kern"], c["plain"], c["args"]
        got, again = _tuple(kern(*args)), _tuple(kern(*args))
        ref = _tuple(plain(*args))
        torch.cuda.synchronize()
        errs, scales, same = [], [], True
        for g, a, r in zip(got, again, ref):
            errs.append(float((g.float() - r.float()).abs().max()))
            scales.append(float(r.float().abs().max()))
            same = same and bool(torch.equal(g, a))
        zeros = c["zero_rows"] is None or bool(
            (got[0][c["zero_rows"]] == 0).all())
        ok = same and zeros and all(
            np.isfinite(e) and e <= KERNEL_TOL * max(sc, 1e-6)
            for e, sc in zip(errs, scales))
        row = dict(kernel=c["kernel"], shape=c["label"],
                   max_abs_err=max(errs), errs=errs, max_abs_ref=scales,
                   bit_identical=same, parentless_zero=zeros, ok=ok)
        times = ""
        if timed:
            bound_ms, bound_by = bound(c["work"])
            row.update(ms=cuda_ms(lambda: kern(*args), KERNEL_REPS),
                       plain_ms=cuda_ms(lambda: plain(*args), KERNEL_REPS),
                       device_ms=device_ms(lambda: kern(*args), KERNEL_REPS,
                                           bound_ms),
                       bytes=c["work"][0], operations=c["work"][1],
                       bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
            if c["library"] is not None:
                lib_fn = c["library"]
                lib_err = float((lib_fn().float() - ref[0].float()).abs()
                                .max())
                row.update(library_ms=cuda_ms(lib_fn, KERNEL_REPS),
                           library_device_ms=device_ms(lib_fn, KERNEL_REPS),
                           library_max_abs_err=lib_err)
            lib = ("" if row["library_ms"] is None else
                   f" library {row['library_ms']:.4f} ms (device "
                   f"{row['library_device_ms']:.4f})")
            times = (f" kernel {row['ms']:.4f} ms (device "
                     f"{row['device_ms']:.4f} ms, bound {bound_ms:.4f} ms by "
                     f"{bound_by}, {bound_ms / row['device_ms']:.1%} of it) "
                     f"plain {row['plain_ms']:.4f} ms{lib}")
        rows.append(row)
        log(f"[{tag}] {c['kernel']:17s} {c['label']:25s} max|err|/max|ref| "
            + " ".join(f"{e:.3e}/{sc:.3e}" for e, sc in zip(errs, scales))
            + f" repeat {'bit-identical' if same else 'DIFFERS'}"
            f"{'' if zeros else ' NONZERO parentless rows'}{times} "
            f"{'ok' if ok else 'MISMATCH'}")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise SystemExit(f"{tag}: {len(bad)} case(s) disagree with their "
                         f"plain versions or do not repeat: {bad}")
    return rows


def log_occupancy(pyr):
    """The launch configuration of the two gather kernels at the main-path
    shapes (tile, dynamic shared memory, blocks per SM); ptxas's registers
    are in the build log."""
    from openpcseg_torch.ops import cuda_lib
    if not hasattr(cuda_lib, "query"):    # a tree without the query
        return
    shapes = sorted({(lv, 27, ci, co) for lv, ci, co in SUBM_PAIRS}
                    | {(lv, 8, c, c) for lv, c in DOWNS})
    for lv, k, cin, cout in shapes:
        n = pyr.levels[lv].capacity
        bm, bn, smem, per_sm, rb, cb, bk = cuda_lib.query(
            "opcs_gather_gemm_config", n, k, cin, cout)
        log(f"[occupancy] gather_gemm L{lv} N {n} K {k} {cin}->{cout}: tile "
            f"{bm} x {bn}, {bk} channels a step, {rb} x {cb} blocks, {smem} B "
            f"shared, {per_sm} blocks per SM")
    for ca, cb in sorted({(a, b) for _, a, b in SUBM_PAIRS}):
        tm, tn, smem, per_sm = cuda_lib.query("opcs_gather_dw_config", ca,
                                              cb)
        log(f"[occupancy] gather_dw {ca} x {cb}: tile {tm} x {tn}, {smem} B "
            f"shared, {per_sm} blocks per SM")


def kernel_phase(task, gen, report):
    from openpcseg_torch.engine.task import batch_to_device

    b = batch_to_device(scan_for(CFGS, SEED), "cuda")
    vb, pyr = task.preprocess(b)
    counts = pyr.level_counts.tolist()
    log(f"[kernels] pyramid of scan {SEED}: voxels per level {counts}, "
        f"caps {task.caps}")
    log_occupancy(pyr)
    plan_phase(task, b, pyr, report)
    rows = check_cases(kernel_cases(pyr, gen), "kernels")
    report["kernel_cases"] = rows
    return rows


def plan_phase(task, b, pyr, report):
    """Device time of the parity plans (K4's and K6's tiling), which
    build_pyramid builds once per step and the kernel times below leave
    out, beside that of the whole voxelize + geometry pass."""
    from openpcseg_torch.core.geometry import build_parity_plan

    def plans():
        return [build_parity_plan(pyr.levels[l].down_kmap,
                                  pyr.levels[l - 1].capacity)
                for l in range(1, len(pyr.levels))]
    plan_ms = profile_window("parity_plans", plans, report)
    call_ms = cuda_ms(plans, KERNEL_REPS)
    pre_ms = profile_window("preprocess", lambda: task.preprocess(b), report)
    groups = [lv.parity_plan.group_offsets.tolist() for lv in pyr.levels[1:]]
    log(f"[plans] parity plans of levels 1-4: {plan_ms:.4f} ms of device "
        f"time ({call_ms:.4f} ms per call by CUDA events, host enqueue "
        f"included), of {pre_ms:.4f} ms for voxelize + geometry; group "
        f"offsets per level {groups}")
    report.update(parity_plan_device_ms=plan_ms, parity_plan_call_ms=call_ms,
                  preprocess_device_ms=pre_ms, parity_plan_groups=groups)


def serving_phase(task, report, tag="serve", need=FWD_COUNTERS, key=""):
    """REQUESTS + 1 eval and predict requests on scans SEED + 1.., the
    first a warm-up: voxel_overflow 0, hist summing to the valid points,
    the counters `need` launched and no plain version on a CUDA tensor;
    the p50 per scan. Report keys start with `key`."""
    from openpcseg_torch.engine.task import batch_to_device
    from openpcseg_torch.ops import cuda_lib

    seeds = [SEED + 1 + i for i in range(REQUESTS + 1)]
    cast_scans(task.cfgs, seeds)
    scans = [scan_for(task.cfgs, s) for s in seeds]
    cuda_lib.reset_counts()
    lat = []
    reqs = []
    for i, scan in enumerate(scans):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = task.eval_step(batch_to_device(scan, "cuda"))
        hist = out["hist"].cpu()
        ms = (time.perf_counter() - t0) * 1e3
        pred = task.predict_step(batch_to_device(scan, "cuda")).cpu()
        n_valid = int(scan["valid"].sum())
        over = int(out["voxel_overflow"])
        counts = out["level_counts"].tolist()
        log(f"[{tag}] request {i}{' (warm-up)' if i == 0 else ''}: "
            f"{n_valid} points, voxels per level {counts}, voxel_overflow "
            f"{over}, hist sum {int(hist.sum())} == valid points "
            f"{int(hist.sum()) == n_valid}, eval_step {ms:.2f} ms, "
            f"pred {tuple(pred.shape)}")
        if over != 0 or int(hist.sum()) != n_valid:
            raise SystemExit(f"{tag}: overflow or hist/point-count mismatch")
        if tuple(pred.shape) != scan["valid"].shape or int(
                pred.min()) < 0 or int(pred.max()) >= task.num_class:
            raise SystemExit(f"{tag}: bad predictions {tuple(pred.shape)}")
        if i > 0:
            lat.append(ms)
        reqs.append(dict(points=n_valid, level_counts=counts,
                         voxel_overflow=over, eval_ms=ms))
    launches = dict(cuda_lib.LAUNCHES)
    plain_on_cuda = dict(cuda_lib.PLAIN_ON_CUDA)
    log(f"[{tag}] kernel launches {launches}; plain versions on CUDA "
        f"tensors {plain_on_cuda}")
    missing = [k for k in need if launches[k] == 0]
    if missing or any(plain_on_cuda.values()):
        raise SystemExit(f"{tag}: kernels never launched {missing} or a "
                         f"plain version ran on the card {plain_on_cuda}")
    p50 = statistics.median(lat)
    log(f"[{tag}] p50 eval_step latency per scan: {p50:.3f} ms over "
        f"{len(lat)} requests (min {min(lat):.3f}, max {max(lat):.3f})")
    report.update({f"{key}requests": reqs, f"{key}p50_ms": p50,
                   f"{key}latencies_ms": lat, f"{key}launches": launches})
    return launches


def to_device(obj, dev):
    """A copy of the tensors of `obj` (a tensor, dataclass, named tuple,
    tuple, list or dict of them, nested) on `dev`."""
    if torch.is_tensor(obj):
        return obj.to(dev)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), dev)
            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_device(x, dev) for x in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(x, dev) for x in obj)
    if isinstance(obj, dict):
        return {k: to_device(v, dev) for k, v in obj.items()}
    return obj


def tables_from_cpu(task, cfgs, **task_kw):
    """Make the card's `task` take the voxel tables and pyramid of the CPU
    (a CPU SegTask of `cfgs` builds them, then they move to the card): so
    a card-against-CPU comparison holds the network, not a point whose
    cylindrical cell the card's float32 rounds into another."""
    from openpcseg_torch.engine.task import SegTask
    cpu = SegTask(cfgs, classes(cfgs), device="cpu", **task_kw)
    task.preprocess = lambda b: to_device(cpu.preprocess(to_device(
        b, "cpu")), "cuda")


def cells_moved(cfgs, scan):
    """The valid points of the numpy `scan` whose cylindrical cell differs
    between the card and the CPU (sqrt and atan2 may round apart)."""
    from openpcseg_torch.core.batch import cylinder_points_batch
    from openpcseg_torch.engine.task import batch_to_device

    data = cfgs["DATA"]
    grids = {}
    for dev in ("cuda", "cpu"):
        b = batch_to_device(scan, dev)
        vb = cylinder_points_batch(
            b["xyz"], b["feats"][..., 3:], b["labels"], b["valid"],
            space_min=data["CYLINDER_SPACE_MIN"],
            space_max=data["CYLINDER_SPACE_MAX"],
            grid_size=data["CYLINDER_GRID_SIZE"], voxel_cap=8192,
            num_class=NUM_CLASS)
        grids[dev] = vb.point_grid.cpu()
    diff = (grids["cuda"] != grids["cpu"]).any(-1) & torch.as_tensor(
        scan["valid"]).reshape(-1)
    return int(diff.sum())


def reference_phase(report, cfgs=CFGS, tag="reference", cpu_tables=False):
    """Same seeded weights, 8192-point scan: kernels (bf16) on the card
    against the plain versions (float32) on the CPU; with `cpu_tables`, the
    card's run takes the CPU's tables (tables_from_cpu)."""
    from openpcseg_torch.engine.task import SegTask, batch_to_device

    scan = scan_for(cfgs, SEED, cap=8192)
    logits = {}
    for dev, dt in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        t = SegTask(cfgs, classes(cfgs), device=dev, compute_dtype=dt,
                    voxel_cap_per_scan=8192, seed=SEED)
        if cpu_tables and dev == "cuda":
            tables_from_cpu(t, cfgs, voxel_cap_per_scan=8192)
        _, _, lg = t.forward(batch_to_device(scan, dev))
        logits[dev] = lg.float().cpu()
    g, r = logits["cuda"], logits["cpu"]
    valid = torch.as_tensor(scan["valid"][0])
    err = float((g - r).abs().max() / r.abs().max())
    agree = float((g.argmax(-1) == r.argmax(-1))[valid].float().mean())
    finite = bool(torch.isfinite(g).all())
    log(f"[{tag}] 8192-point scan, GPU bf16 kernels vs CPU f32 plain: "
        f"logits {tuple(g.shape)} finite {finite}, max|diff|/max|ref| "
        f"{err:.4f}, argmax agreement {agree:.4f}")
    report[tag] = dict(rel_max_err=err, argmax_agree=agree)
    # bf16 activations over ~40 layers against float32: a few percent of
    # the logit range, and most argmaxes unchanged
    if not finite or err > 0.1 or agree < 0.9:
        raise SystemExit(f"{tag} phase: GPU output disagrees with the "
                         "CPU float32 reference")


def _device_rows(prof):
    """(kernel, launches, device ms) of every device kernel in a profile.
    Only device events count, and no annotation: the host-side ranges
    (autograd Functions, aten ops) and the device-side copies of annotated
    ranges (the optimizer step) carry the time of their kernels again."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0.0)
        if (e.device_type == DeviceType.CUDA and dev_us > 0
                and not getattr(e, "is_user_annotation", False)
                and FLUSH_KERNEL not in e.key):
            rows.append((e.key, e.count, dev_us / 1e3))
    return rows


# the L2 flush between the calls of a retaken window: a bitwise_not over
# 256 MB (five times the H100's 50 MB L2), a kernel no wrapper launches, so
# its events are told apart by name and left out
FLUSH_KERNEL = "bitwise_not"
_FLUSH_BUF = []


def _flush_l2():
    if not _FLUSH_BUF:
        _FLUSH_BUF.append(torch.empty(64 << 20, dtype=torch.int32,
                                      device="cuda"))
    _FLUSH_BUF[0].bitwise_not_()


def _profiled(fn, calls, flush=False):
    """torch.profiler over `calls` calls of fn(), after one unprofiled
    call (with `flush`, the L2 cache flushed before each call); returns
    the profile."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            if flush:
                _flush_l2()
            fn()
        torch.cuda.synchronize()
    return prof


def device_ms(fn, reps: int, floor: float = 0.0) -> float:
    """Device kernel time per call of fn() under torch.profiler: the median
    of three windows of `reps` calls. CUDA events time a call from its
    first enqueue to its last kernel's end, so where the host's enqueue
    takes longer than the kernels, as for the parent gather, they read the
    host. The profiler loses a kernel event in most windows, and now and
    then many: a window reads, per kernel, its mean event time times the
    launches a call makes, its events over `reps` rounded. A window is
    taken again, up to five times, where a kernel's events lie more than a
    quarter of `reps` from a whole number per call (after five they count
    as they are: a library call may launch a kernel on some calls only),
    or where it reads less than `floor`, the call's bound (five such fail
    the run). The bound counts each input byte read from HBM once; a
    call whose inputs stay in the 50 MB L2 cache from the call before can
    beat it with every event present, so a window below the bound with
    whole counts is taken again with the L2 flushed before each call (the
    flush's own events left out). Where five windows fail, CUDA events
    with the host ahead of the card (events_ms) take the reading, and one
    below the bound fails the run."""
    def per_call(n):
        k = round(n / reps)
        return k if abs(n - k * reps) <= reps // 4 else n / reps

    def window():
        got, flush = [], False
        for _ in range(5):
            rows = _device_rows(_profiled(fn, reps, flush))
            ms = sum(t / n * per_call(n) for _, n, t in rows)
            whole = all(per_call(n) == round(n / reps) for _, n, _ in rows)
            if rows and ms >= floor and whole:
                if flush:
                    log(f"[profiler] a window read below the bound "
                        f"{floor:.4f} ms with every event present: taken "
                        f"again with the L2 flushed, {ms:.4f} ms")
                return ms
            got.append((sum(n for _, n, _ in rows), ms, flush))
            flush = flush or bool(rows and whole)
        if rows and ms >= floor:
            return ms
        # five windows that lost events (or read below the bound): CUDA
        # events with the host ahead of the card read the device instead
        ev = events_ms(fn, reps)
        log(f"[profiler] five windows of {reps} calls read no device time "
            f"or less than the bound {floor:.4f} ms a call (events, ms, "
            f"flushed): {got}; CUDA events with the host ahead read "
            f"{ev:.4f} ms")
        if ev >= floor:
            return ev
        raise SystemExit(f"profiler and CUDA events read less than the "
                         f"bound {floor:.4f} ms a call: {got}, {ev:.4f}")
    return statistics.median(window() for _ in range(3))


def profile_window(label, step, report):
    """Device time per kernel over one call of step() under torch.profiler
    (after one unprofiled call); returns the total device kernel ms."""
    return _window(label, _profiled(step, 1), report)


def _window(label, prof, report):
    """Log and report a profile's device time per kernel; its total ms."""
    rows = _device_rows(prof)
    if not rows:
        raise SystemExit(f"profiler: no device time recorded for {label}")
    rows.sort(key=lambda r: -r[2])
    total = sum(r[2] for r in rows)
    log(f"[profile] device kernel time of one {label}: {total:.3f} ms "
        f"over {sum(r[1] for r in rows)} kernels; top 12:")
    for k, n, ms in rows[:12]:
        log(f"[profile]   {ms:9.3f} ms  x{n:<5d} {k[:90]}")
    report[f"profile_{label}"] = [dict(kernel=k, count=n, ms=ms)
                                  for k, n, ms in rows]
    report[f"profile_{label}_total_device_ms"] = total
    return total


def profile_phase(task, report, key=""):
    from openpcseg_torch.engine.task import batch_to_device

    b = batch_to_device(scan_for(task.cfgs, SEED + 1), "cuda")
    return step_profile(f"{key}eval_step", lambda: task.eval_step(b), report)


# the kernels each wrapper family launches per call, by profiler name
FAMILY_KERNELS = {"gather_gemm": ("gather_gemm_kernel",),
                  "gather_dw": ("gather_dw_kernel", "sum_chunks_kernel"),
                  "parent_gemm": ("parent_gemm_kernel",),
                  "devox": ("devox_kernel",),
                  "devox_bwd": ("devox_bwd_kernel",)}


def _role(family, a, kw=None):
    """Which kernel row (K1-K8, and which pass of a backward) a wrapper
    call with positional args `a` (and keywords `kw`) serves. The gather
    kernels over Cylinder3D's k3 strided maps have rows of their own."""
    if family == "gather_gemm":
        return {"subm": "K1", "down": "K3", "subm_bwd": "K2 dfeats",
                "up_bwd": "K5 dfeats", "strided": "k3 strided",
                "strided_bwd": "k3 strided dfeats"}[a[3]]
    if family == "parent_gemm":
        return {"up": "K4", "down_bwd": "K6 dfeats"}[a[3]]
    if family == "gather_dw":
        idx = a[1] if a[1] is not None else a[3]
        if (kw or {}).get("counter", "dw") == "strided_dw":
            return "k3 strided dW"
        return ("K2 dW" if idx.shape[0] != 8 else
                "K6 dW" if a[1] is not None else "K5 dW")
    # K7 / K8 calls that name their counter (RPVNet's range fusion)
    counter = a[3 if family == "devox" else 2] if len(a) > (
        3 if family == "devox" else 2) else (kw or {}).get("counter", family)
    return {"devox": "K7", "devox_bwd": "K8", "vmean": "K8 vmean",
            "vmean_bwd": "K7 vmean", "r2p": "K7 r2p", "r2p_bwd": "K8 r2p",
            "p2r": "K8 p2r", "p2r_bwd": "K7 p2r"}[counter]


def _kernels_of(family, a):
    """The profiler names of the kernels one call launches, in order."""
    from openpcseg_torch.ops.subm_conv import dw_chunks
    names = FAMILY_KERNELS[{"vmean": "devox_bwd",
                            "vmean_bwd": "devox"}.get(family, family)]
    if family == "gather_dw":
        idx = a[1] if a[1] is not None else a[3]
        if dw_chunks(idx.shape[1], idx.shape[0], a[0].shape[1],
                     a[2].shape[1])[1] == 1:
            return names[:1]
    return names


@contextlib.contextmanager
def noting_work(noted):
    """Inside: each kernel wrapper call appends a dict to `noted`: its
    family, role (_role), work, the kernels it launches, and (K7, K8) its
    inputs as (features, corner indices, weights) or (dout, table), whose
    library call is timed afterwards."""
    from openpcseg_torch.ops import devox, subm_conv, updown

    def wrap(fn, family, work, n_args):
        def noted_call(*a, **kw):
            out = fn(*a, **kw)
            w = a[:n_args]
            lib = w if family.startswith(("devox", "vmean")) else None
            if family == "vmean_bwd":      # (voxel feats, one-corner table)
                lib = (w[0], w[1].idx, w[1].weights)
            noted.append(dict(
                family=family, role=_role(family, a, kw), work=work(*w),
                kernels=_kernels_of(family, a), args=lib))
            return out
        return noted_call
    patches = [(subm_conv, "gather_gemm", "gather_gemm", gemm_work, 3),
               (updown, "gather_gemm", "gather_gemm", gemm_work, 3),
               (subm_conv, "gather_dw", "gather_dw", dw_work, 4),
               (updown, "gather_dw", "gather_dw", dw_work, 4),
               (updown, "parent_gemm", "parent_gemm", parent_work, 3),
               (devox, "devoxelize", "devox", devox_work, 3),
               (devox, "devoxelize_bwd", "devox_bwd", devox_bwd_work, 2),
               (devox, "voxel_sum", "vmean", sum_work, 2),
               (devox, "point_gather", "vmean_bwd", gather_work, 2)]
    saved = [(m, name, getattr(m, name)) for m, name, *_ in patches]
    try:
        for m, name, family, work, n_args in patches:
            setattr(m, name, wrap(getattr(m, name), family, work, n_args))
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def _device_events(prof):
    """Every device kernel of a profile, in the order it started."""
    from torch.autograd import DeviceType
    return sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


def step_profile(label, step, report):
    """One call of step() with the wrappers noting their work, then the
    profiler window over another (the same launches, in the same order;
    taken again where a kernel's events miss calls or a row reads less
    than its bound, and three such windows fail the run).
    Per kernel row (K1-K8, the passes of a backward apart): its launches
    and device ms in the profile, each kernel event matched in order to the
    call that launched it, beside the summed bound of those calls and, for
    K7 and K8, the summed ms of the library call on the same inputs.
    Returns the step's total device kernel ms."""
    noted = []
    with noting_work(noted):
        step()
    names = {k for c in noted for k in c["kernels"]}
    roles = {}
    for c in noted:
        r = roles.setdefault(c["role"], dict(
            family=c["family"], calls=0, launches=0, device_ms=0.0,
            bound_ms=0.0, library_ms=None))
        r["calls"] += 1
        r["bound_ms"] += bound(c["work"])[0]
    # a window that dropped device events is taken again: a kernel's
    # events against the calls that launched it, and no row below its bound
    for _ in range(3):
        prof = _profiled(step, 1)
        events = _device_events(prof)
        counts = {name: (sum(name in e.name for e in events),
                         sum(name in c["kernels"] for c in noted))
                  for name in names}
        for r in roles.values():
            r.update(launches=0, device_ms=0.0)
        for name in names:
            calls = [c["role"] for c in noted if name in c["kernels"]]
            evs = [e for e in events if name in e.name]
            for role, e in zip(calls, evs):
                roles[role]["launches"] += 1
                roles[role]["device_ms"] += e.time_range.elapsed_us() / 1e3
        short = {k: (r["device_ms"], r["bound_ms"]) for k, r in roles.items()
                 if r["device_ms"] < r["bound_ms"]}
        if all(got == want for got, want in counts.values()) and not short:
            break
    else:
        raise SystemExit(f"profiler: kernel events in {label} against the "
                         f"calls that launched them, and rows below their "
                         f"bound, three times: {counts}, {short}")
    total = _window(label, prof, report)
    for c in noted:
        if c["args"] is not None:
            x, rest = c["args"][0], c["args"][1:]
            m = (devox_csr(rest[0], rest[1], x.shape[0])
                 if len(rest) == 2 else devox_t_csr(rest[0], x.shape[0]))
            r = roles[c["role"]]
            ms = cuda_ms(sparse_library(m, x), KERNEL_REPS)
            r["library_ms"] = (r["library_ms"] or 0.0) + ms
    for role, r in sorted(roles.items()):
        lib = ("" if r["library_ms"] is None else
               f", library call {r['library_ms']:.4f} ms")
        log(f"[profile] {label} {role:9s} ({r['family']}): device "
            f"{r['device_ms']:.4f} ms over {r['launches']} kernels "
            f"({r['calls']} calls), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_ms'] / max(r['device_ms'], 1e-9):.1%}){lib}")
    for family in list(FAMILY_KERNELS) + list(SPV_COUNTERS):
        mine = [r for r in roles.values() if r["family"] == family]
        if mine:
            dev = sum(r["device_ms"] for r in mine)
            bnd = sum(r["bound_ms"] for r in mine)
            log(f"[profile] {label} {family} in all: device {dev:.4f} ms "
                f"over {sum(r['launches'] for r in mine)} kernels, bound "
                f"{bnd:.4f} ms ({bnd / max(dev, 1e-9):.1%})")
    report[f"profile_{label}_kernels"] = roles
    return total


def backward_cases(pyr, gen, subm=SUBM_PAIRS, downs=DOWNS, ups=UPS,
                   devox_shapes=DEVOX, tag=""):
    """The backward kernels' cases at the shapes the mk34 training step
    gives them (or the shapes given): upstream gradients in float32 (zero
    on padding rows, as the masked forward leaves them), saved bf16
    activations, float32 weights. K2, K5 and K6 run whole (dfeats and dW)
    and each pass alone (labels "... dfeats" and "... dW"), on the
    operands the whole backward hands it: dout cast to bf16, W^T in bf16.
    Each label starts with `tag`."""
    from openpcseg_torch.ops import devox, subm_conv, updown
    from openpcseg_torch.ops.sparse_conv import _conv_apply

    bf, f32 = torch.bfloat16, torch.float32

    def down_bwd_plain(dout, feats, w, kmap, up_kmap, plan):
        return updown.down_conv_bwd_plain(dout, feats, w, kmap, up_kmap)

    def gemm_plain(d16, wt, kmap_t):
        return _conv_apply(d16, wt, kmap_t, None, bf)

    # subm dfeats reads the map reversed; an A/B call also runs this script
    # over the parent tree, whose gather-GEMM has no such flag: there it
    # gets the flipped copy, made once outside the timing
    if "reverse" in inspect.signature(subm_conv.gather_gemm).parameters:
        def subm_dfeats(d16, wt, kmap, kmap_t):
            return subm_conv.gather_gemm(d16, wt, kmap, "subm_bwd",
                                         reverse=True)
    else:
        def subm_dfeats(d16, wt, kmap, kmap_t):
            return subm_conv.gather_gemm(d16, wt, kmap_t, "subm_bwd")

    def rand(level, c, dtype):
        lv = pyr.levels[level]
        x = torch.randn(lv.capacity, c, device="cuda", generator=gen)
        return torch.where(lv.valid[:, None], x, 0.0).to(dtype)

    def weight(k, cin, cout):
        return torch.randn(k, cin, cout, device="cuda",
                           generator=gen) / (k * cin) ** 0.5

    def passes(name, label, dfeats, dfeats_plain, dfeats_args, dfeats_work,
               dw_args, zero_rows=None):
        """The dfeats pass alone and the dW pass alone."""
        return [case(name, label + " dfeats", dfeats, dfeats_plain,
                     dfeats_args, dfeats_work, zero_rows=zero_rows),
                case(name, label + " dW", subm_conv.gather_dw,
                     subm_conv.gather_dw_plain, dw_args, dw_work(*dw_args))]

    cases = []
    for level, cin, cout in subm:
        lv = pyr.levels[level]
        label = f"{tag}L{level} {cin}->{cout}"
        d, x, w = rand(level, cout, f32), rand(level, cin, bf), weight(
            27, cin, cout)
        d16, wt = d.to(bf), w.transpose(1, 2).to(bf).contiguous()
        km = lv.subm_kmap
        gwork, dwargs = gemm_work(d16, wt, km), (x, km, d16, None)
        cases.append(case("K2_subm_conv_bwd", label,
                          subm_conv.subm_conv_bwd,
                          subm_conv.subm_conv_bwd_plain, (d, x, w, km),
                          both(gwork, dw_work(*dwargs))))
        cases += passes("K2_subm_conv_bwd", label, subm_dfeats,
                        lambda d16, wt, km, km_t: gemm_plain(d16, wt, km_t),
                        (d16, wt, km, km.flip(0).contiguous()), gwork,
                        dwargs)
    for level, c in downs:
        fine, coarse = pyr.levels[level - 1], pyr.levels[level]
        plan = coarse.parity_plan
        label = f"{tag}L{level - 1}->L{level} {c}->{c}"
        d, x, w = rand(level, c, f32), rand(level - 1, c, bf), weight(8, c, c)
        d16, wt = d.to(bf), w.transpose(1, 2).to(bf).contiguous()
        pwork = parent_work(d16, wt, plan)
        dwargs = (x, coarse.down_kmap, d16, None)
        cases.append(case("K6_down_conv_bwd", label, updown.down_conv_bwd,
                          down_bwd_plain,
                          (d, x, w, coarse.down_kmap, fine.up_kmap, plan),
                          both(pwork, dw_work(*dwargs))))
        cases += passes(
            "K6_down_conv_bwd", label,
            lambda d16, wt, uk, plan: updown.parent_gemm(d16, wt, plan,
                                                         "down_bwd"),
            lambda d16, wt, uk, plan: gemm_plain(d16, wt, uk),
            (d16, wt, fine.up_kmap, plan), pwork, dwargs,
            zero_rows=parentless_rows(plan))
    for level, cin, cout in ups:
        fine, coarse = pyr.levels[level], pyr.levels[level + 1]
        label = f"{tag}L{level + 1}->L{level} {cin}->{cout}"
        d, x, w = rand(level, cout, f32), rand(level + 1, cin, bf), weight(
            8, cin, cout)
        d16, wt = d.to(bf), w.transpose(1, 2).to(bf).contiguous()
        dk = coarse.down_kmap
        gwork, dwargs = gemm_work(d16, wt, dk), (x, None, d16, dk)
        cases.append(case("K5_up_conv_bwd", label, updown.up_conv_bwd,
                          updown.up_conv_bwd_plain,
                          (d, x, w, fine.up_kmap, dk),
                          both(gwork, dw_work(*dwargs))))
        cases += passes(
            "K5_up_conv_bwd", label,
            lambda d16, wt, dk: subm_conv.gather_gemm(d16, wt, dk, "up_bwd"),
            gemm_plain, (d16, wt, dk), gwork, dwargs)
    for level, c in devox_shapes:
        tbl = pyr.devox[level]
        d = torch.randn(tbl.idx.shape[1], c, device="cuda", generator=gen)
        d = torch.where(pyr.points.valid[:, None], d, 0.0).to(bf)
        cases.append(case("K8_devoxelize_bwd", f"{tag}L{level} C={c}",
                          devox.devoxelize_bwd, devox.devoxelize_bwd_plain,
                          (d, tbl), devox_bwd_work(d, tbl),
                          library=sparse_library(
                              devox_t_csr(tbl, d.shape[0]), d)))
    return cases


def devox_phase(pyr, report):
    """Per devox level, the work K8 walks: contributors per valid voxel
    (max, p99, mean) of the transpose, and points per valid level cell
    (corner 0 of a point is its own cell), which bound how far the rows it
    re-reads could be shared; where the tree cuts the transpose into
    segments, their count and K8's device time on the level's DEVOX width
    with the table cut at each chunk of DEVOX_CHUNKS (the geometry pass
    builds one of them). Its inputs come from a generator of its own, so
    the cases after it get the same inputs in a tree without segments."""
    from openpcseg_torch.core import geometry
    from openpcseg_torch.ops import devox

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def stats(cnt):
        cnt = cnt.float()
        return dict(max=int(cnt.max()), p99=float(torch.quantile(cnt, 0.99)),
                    mean=float(cnt.mean()))

    def text(st):
        return " ".join(f"{k} {v:.1f}" for k, v in st.items())
    out = []
    for level, c in DEVOX:
        tbl, lv = pyr.devox[level], pyr.levels[level]
        cells = tbl.idx[0][tbl.idx[0] >= 0].long()
        row = dict(level=level, voxels=int(lv.valid.sum()),
                   contributors=int(tbl.t_ptr[-1]),
                   per_voxel=stats(tbl.t_ptr.diff()[lv.valid]),
                   per_cell=stats(torch.bincount(
                       cells, minlength=lv.capacity)[lv.valid]))
        msg = (f"[devox] L{level}: {row['voxels']} voxels, "
               f"{row['contributors']} contributors; per voxel "
               f"{text(row['per_voxel'])}; points per cell "
               f"{text(row['per_cell'])}")
        if hasattr(geometry, "devox_table"):
            nseg = tbl.seg_ptr.diff()[lv.valid]
            d = torch.randn(tbl.idx.shape[1], c, device="cuda", generator=gen)
            d = torch.where(pyr.points.valid[:, None], d, 0.0).to(
                torch.bfloat16)
            by_chunk = {}
            for chunk in DEVOX_CHUNKS:
                t = geometry.devox_table(tbl.idx, tbl.weights,
                                         tbl.num_voxels, chunk)
                by_chunk[chunk] = device_ms(
                    lambda: devox.devoxelize_bwd(d, t), KERNEL_REPS)
            row.update(chunk=tbl.chunk, segments=int(tbl.seg_ptr[-1]),
                       segment_capacity=tbl.seg_voxel.shape[0],
                       split_voxels=int((nseg > 1).sum()),
                       max_segments=int(nseg.max()),
                       k8_device_ms_by_chunk=by_chunk)
            msg += (f"; chunk {tbl.chunk}: {row['segments']} segments of "
                    f"{row['segment_capacity']}, {row['split_voxels']} "
                    f"voxels cut in several (up to {row['max_segments']}); "
                    f"K8 device ms at C={c} by chunk " + ", ".join(
                        f"{k}: {v:.4f}" for k, v in by_chunk.items()))
        log(msg)
        out.append(row)
    report["devox_tables"] = out


def backward_kernel_phase(task, gen, report):
    """Each backward kernel against its plain version, per output, and a
    bit-identical repeat, whole and pass by pass; before them, the devox
    tables' statistics and K8 by chunk (devox_phase)."""
    from openpcseg_torch.engine.task import batch_to_device

    b = batch_to_device(scan_for(CFGS, SEED), "cuda")
    _, pyr = task.preprocess(b)
    devox_phase(pyr, report)
    rows = check_cases(backward_cases(pyr, gen), "bwd")
    report["backward_cases"] = rows
    return rows


def training_phase(report, cfgs=TRAIN_CFGS, tag="train", need=None,
                   key=""):
    """TRAIN_STEPS full-width train steps on the repeated scan of seed 1,
    the counters `need` (by default every one but SPVCNN's) launched on
    every step; then one profiled step for the device idle share. Report
    keys start with `key`."""
    from openpcseg_torch.engine.task import SegTask, batch_to_device
    from openpcseg_torch.ops import cuda_lib

    need = need or MINK_COUNTERS
    task = SegTask(cfgs, classes(cfgs), device="cuda",
                   compute_dtype=torch.bfloat16, seed=SEED,
                   iters_per_epoch=ITERS_PER_EPOCH)
    scan = scan_for(cfgs, SEED + 1)
    steps, totals = [], dict.fromkeys(cuda_lib.COUNTERS, 0)
    for i in range(TRAIN_STEPS):
        cuda_lib.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = task.train_step(batch_to_device(scan, "cuda"))
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(cuda_lib.LAUNCHES)
        plain_on_cuda = dict(cuda_lib.PLAIN_ON_CUDA)
        over = int(m["voxel_overflow"])
        log(f"[{tag}] step {i}: loss {loss:.5f} grad_norm {gnorm:.4f} lr "
            f"{m['lr']:.6f} voxels {int(m['num_voxels'])} voxel_overflow "
            f"{over} wall {ms:.2f} ms launches {launches}")
        if not (np.isfinite(loss) and np.isfinite(gnorm)) or over != 0:
            raise SystemExit(f"{tag}: step {i} loss {loss} grad norm "
                             f"{gnorm} voxel_overflow {over}")
        missing = [k for k in need if launches[k] == 0]
        if missing or any(plain_on_cuda.values()):
            raise SystemExit(f"{tag}: step {i} never launched {missing} "
                             f"or ran a plain version on the card "
                             f"{plain_on_cuda}")
        for k, v in launches.items():
            totals[k] += v
        steps.append(dict(loss=loss, grad_norm=gnorm, lr=m["lr"],
                          voxel_overflow=over, wall_ms=ms,
                          launches=launches))
    if not steps[-1]["loss"] < steps[0]["loss"]:
        raise SystemExit(f"{tag}: the last loss {steps[-1]['loss']} is "
                         f"not below the first {steps[0]['loss']}")
    med = statistics.median(s["wall_ms"] for s in steps[1:])
    log(f"[{tag}] median train_step {med:.3f} ms over steps 1..{len(steps)-1}"
        f" = {1e3 / med:.3f} scans/s per card (batch 1); loss "
        f"{steps[0]['loss']:.5f} -> {steps[-1]['loss']:.5f}; launches over "
        f"the phase {totals}")
    report.update({f"{key}train_steps": steps, f"{key}train_median_ms": med,
                   f"{key}train_scans_per_s": 1e3 / med,
                   f"{key}train_launches": totals})
    b = batch_to_device(scan, "cuda")
    step_ms = step_profile(f"{key}train_step", lambda: task.train_step(b),
                           report)
    idle = 1.0 - step_ms / med
    log(f"[profile] {key}train_step device idle share {idle:.4f} (device "
        f"{step_ms:.3f} ms of the {med:.3f} ms median step)")
    report[f"{key}train_idle_share"] = idle
    return totals


def train_ref_draws(cfgs=CFGS):
    """The training reference's inputs, numpy batches: the 8192-point
    scan of SEED as `cfgs`'s model reads it (the ray-cast scan; on Waymo
    the frame), then TRAIN_REF_DRAWS - 1 copies of it with its features
    scaled by 1 + TRAIN_REF_NOISE * N(0, 1) (seeded). Each is one draw of
    bf16's rounding over the same geometry."""

    scan = scan_for(cfgs, SEED, cap=8192)
    rng = np.random.default_rng(SEED)
    draws = [scan]
    for _ in range(TRAIN_REF_DRAWS - 1):
        noise = 1 + TRAIN_REF_NOISE * rng.standard_normal(scan["feats"].shape)
        draws.append(dict(scan, feats=(scan["feats"] * noise).astype(
            np.float32)))
    return draws


def scan_for(cfgs, seed, cap=None):
    """The ray-cast scan of `seed` as `cfgs`'s model reads it (numpy, a
    batch of 1, padded to `cap` points, by default the config's cap): on
    Waymo the frame of data/raycast_waymo.py as WaymoDataset reads it (both
    returns, tanh of intensity and elongation); else RPVNet's a fusion
    batch (golden_run.to_fusion: the 64 x 2048 range image and each point's
    pxpy), every other model's the scan as ray-cast. Scans are cast once
    a run (_SCANS)."""
    from openpcseg_torch.cli.golden_run import to_fusion
    from openpcseg_torch.data.raycast import raycast_batch
    from openpcseg_torch.data.raycast_waymo import frame_batch

    cap = cap or cfgs.get("TPU", {}).get("POINT_CAP_PER_SCAN", N_POINTS)
    waymo = cfgs["DATA"]["DATASET"] == "waymo"
    key = (waymo, seed, cap)
    if key not in _SCANS:
        _SCANS[key] = (frame_batch(seed, cap) if waymo
                       else raycast_batch(seed, 1, cap=cap))
    b = _SCANS[key]
    return to_fusion(b, seed) if cfgs["MODEL"]["NAME"] == "RPVNet" else b


_SCANS: dict = {}
SCAN_THREADS = 8


def cast_scans(cfgs, seeds, cap=None):
    """scan_for of each seed, cast in SCAN_THREADS threads (numpy's array
    passes release the GIL) before the phase that reads them."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(SCAN_THREADS) as pool:
        list(pool.map(lambda s: scan_for(cfgs, s, cap), seeds))


def classes(cfgs) -> int:
    """The class count of `cfgs`'s dataset (data.num_classes_for)."""
    from openpcseg_torch.data import num_classes_for
    return num_classes_for(cfgs["DATA"]["DATASET"])


def rpv_train_ref_draws():
    """RPVNet's training-reference inputs: the 8192-point scan of SEED as
    its fusion batch (scan_for), then TRAIN_REF_DRAWS - 1 copies whose
    point features and range image are scaled by 1 + TRAIN_REF_NOISE *
    N(0, 1) (seeded); the points, their pxpy and so every table stay
    the same."""
    scan = scan_for(RPV_CFGS, SEED, cap=8192)
    rng = np.random.default_rng(SEED)
    draws = [scan]
    for _ in range(TRAIN_REF_DRAWS - 1):
        d = dict(scan)
        for k in ("feats", "range_image"):
            noise = 1 + TRAIN_REF_NOISE * rng.standard_normal(scan[k].shape)
            d[k] = (scan[k] * noise).astype(np.float32)
        draws.append(d)
    return draws


def seed_weights(model, seed):
    """Overwrite `model`'s conv, classifier and point-MLP (every other
    Linear) weights, then its 2-D convs' (RPVNet's range branch), in that
    order, with draws of numpy's
    generator seeded with `seed`, at the scale of the model's own
    initializer (a unit normal truncated to [-2, 2], times sqrt(1 / fan-in)
    over that normal's std): the same weights on every machine, whatever
    torch's own initializer draws there. Norm layers keep 1 and 0. The
    weights of a (model layout, seed) are drawn once and kept
    (_SEEDED): the references seed the same model again on each draw."""
    from openpcseg_torch.models.layers import SparseConv

    names = {id(p): n for n, p in model.named_parameters()}
    key = (seed, tuple((n, tuple(p.shape)) for n, p in
                       model.named_parameters()))
    if key in _SEEDED:
        params = dict(model.named_parameters())
        with torch.no_grad():
            for n, v in _SEEDED[key].items():
                params[n].copy_(v)
        return
    drawn = _SEEDED.setdefault(key, {})
    rng = np.random.default_rng(seed)

    def trunc(shape, fan_in):
        z = rng.standard_normal(shape)
        bad = np.abs(z) > 2
        while bad.any():
            z[bad] = rng.standard_normal(int(bad.sum()))
            bad = np.abs(z) > 2
        return torch.from_numpy(z * (1.0 / fan_in) ** 0.5
                                / 0.87962566103423978)

    def put(w, value):
        w.copy_(value)
        drawn[names[id(w)]] = w.detach().cpu().clone()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, SparseConv):
                put(m.weight, trunc(m.weight.shape, m.fan_in))
        head = getattr(model, "classifier", None)
        if head is not None:
            put(head.weight, trunc(head.weight.shape, head.weight.shape[1]))
        for m in model.modules():     # SPVCNN's and Cylinder3D's Linears
            if isinstance(m, torch.nn.Linear) and m is not head:
                put(m.weight, trunc(m.weight.shape, m.weight.shape[1]))
        for m in model.modules():     # RPVNet's range convs
            if isinstance(m, torch.nn.Conv2d):
                put(m.weight, trunc(m.weight.shape, m.weight[0].numel()))


_SEEDED: dict = {}


def inputs_digest(batches, model) -> str:
    """sha256 (first 16 hex digits) of numpy batches and a model's state:
    equal digests mean a reading was taken on the very same inputs."""
    h = hashlib.sha256()
    for b in batches:
        for k in sorted(b):
            h.update(k.encode())
            h.update(np.ascontiguousarray(b[k]).tobytes())
    for n, t in model.state_dict().items():
        h.update(n.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def one_step(cfgs, batch, dev, weights_seed=None, cpu_tables=False,
             **task_kw):
    """One train_step of `cfgs` on the numpy `batch` on `dev` (the card in
    bf16 through the kernels, the CPU in float32 through the plain
    versions): SegTask's seeded weights, or seed_weights(`weights_seed`);
    with `cpu_tables` the card takes the CPU's tables (tables_from_cpu).
    Returns the loss, each parameter's clipped gradient (float32, flat, on
    the CPU), the conv weights' names and the seconds it took."""
    from openpcseg_torch.engine.task import SegTask, batch_to_device
    from openpcseg_torch.models.layers import SparseConv

    t0 = time.perf_counter()
    dt = torch.bfloat16 if dev == "cuda" else torch.float32
    t = SegTask(cfgs, classes(cfgs), device=dev, compute_dtype=dt, seed=SEED,
                **task_kw)
    if cpu_tables and dev == "cuda":
        tables_from_cpu(t, cfgs, **task_kw)
    if weights_seed is not None:
        seed_weights(t.model, weights_seed)
    no_dropout(t.model)
    m = t.train_step(batch_to_device(batch, dev))
    # the clipped gradients stay in .grad; a cosine ignores the scale
    return dict(loss=float(m["loss"]),
                grads={n: p.grad.float().cpu().reshape(-1)
                       for n, p in t.model.named_parameters()},
                convs=[n + ".weight" for n, mod in t.model.named_modules()
                       if isinstance(mod, (SparseConv, torch.nn.Conv2d))],
                seconds=time.perf_counter() - t0)


def step_against_cpu(cfgs, batch, cpu, weights_seed=None, cpu_tables=False,
                     **task_kw):
    """One train_step of the same weights on the numpy `batch`: the card
    (bf16, kernels) against the CPU (float32, plain versions): `cpu` is
    that step's one_step, taken by the reference process. Returns the
    losses, |loss_gpu - loss_cpu| / |loss_cpu|, the cosine of the whole
    gradient vector and each conv weight gradient's cosine."""
    gpu = one_step(cfgs, batch, "cuda", weights_seed, cpu_tables, **task_kw)

    def cos(a, b):
        a, b = a.double(), b.double()
        return float(a @ b / (a.norm() * b.norm()).clamp(min=1e-300))

    g, r = gpu["grads"], cpu["grads"]
    return dict(loss_gpu=gpu["loss"], loss_cpu=cpu["loss"],
                seconds=dict(gpu=gpu["seconds"], cpu=cpu["seconds"]),
                loss_rel=abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"]),
                cos_all=cos(torch.cat([g[n] for n in r]),
                            torch.cat(list(r.values()))),
                cos_conv={n: cos(g[n], r[n]) for n in cpu["convs"]})


# == the phases, in the order they run: those that need no CPU reference
# step (range, dp) run between those that do, so the reference process
# keeps ahead of them; --phases runs a subset, in this order
PHASES = ("cases", "minkunet", "native", "bottleneck", "spvcnn", "range",
          "dp", "cylinder", "rpvnet", "entry", "jax_ckpt", "waymo", "yamls",
          "tta", "loss_zoo", "loss_clis", "crf")
PHASE_NEEDS = {"yamls": "waymo", "tta": "entry"}   # reads what that wrote
TREE_PHASES = {"native", "bottleneck", "spvcnn", "range", "dp", "cylinder",
               "rpvnet", "entry", "jax_ckpt", "yamls", "tta",
               "loss_clis"}  # read the entry tree
# == the CPU float32 halves of the training references, in a process of
# their own that starts before the build (python3 chip_smoke.py --cpu-refs
# DIR JOB...): it takes the jobs of the phases run (REF_JOBS) in their
# order and writes each draw's one_step to DIR/<model>_<i>.pt, which the
# phase waits for, reads and deletes; the card's halves run meanwhile.
# Its last job, once its steps are done, is host work of its own: the
# Waymo entry tree (ray-cast in REF_THREADS threads)
REF_JOBS = {"minkunet": ("MinkUNet",), "bottleneck": ("Bottleneck",),
            "spvcnn": ("SPVCNN",), "range": ("range",),
            "cylinder": ("Cylinder_TS",), "rpvnet": ("RPVNet",),
            "entry": ("entry",), "waymo": ("Waymo", "waymo_tree")}
REF_THREADS = 4          # the reference process's torch threads, niced
REF_WAIT_S = 900.0


def ref_draws(model):
    """The numpy draws of a model's training reference."""
    if model == "RPVNet":
        return rpv_train_ref_draws()
    return train_ref_draws(TRAIN_REF_MODELS[model][0])


def cpu_refs_main(out_dir, models) -> int:
    """The reference process: every draw's CPU float32 step of each of
    `models`, in order, and the Waymo tree where asked."""
    os.nice(10)
    torch.set_num_threads(REF_THREADS)
    sys.path.insert(0, str(ROOT))
    out = Path(out_dir)

    def put(name, r):
        tmp = out / f"{name}.pt.tmp"
        torch.save(r, tmp)
        tmp.replace(out / f"{name}.pt")
    for model in models:
        if model == "entry":
            put("entry_0", entry_cpu_step(out))
            continue
        if model == "waymo_tree":
            t0 = time.perf_counter()
            write_waymo_tree(out / "waymo", REF_THREADS)
            (out / "waymo" / "ready").write_text(
                f"{time.perf_counter() - t0:.1f}")
            continue
        if model == "range":
            for name in RANGE_MODELS:
                put(f"range_{name}_0", range_cpu_step(name))
            continue
        cfgs = TRAIN_REF_MODELS[model][0]
        n = TRAIN_REF_DRAWS_OF.get(model, TRAIN_REF_DRAWS)
        for i, draw in enumerate(ref_draws(model)[:n]):
            put(f"{model}_{i}", one_step(
                cfgs, draw, "cpu", SEED, voxel_cap_per_scan=8192,
                iters_per_epoch=ITERS_PER_EPOCH))
    return 0


class CpuRefs:
    """The reference process's results: started with start(), read with
    get(model, i) and waymo_tree(), which wait for the file (and fail the
    run where no process was started for it, where it ended without
    writing it, or after REF_WAIT_S), stopped with stop()."""

    def __init__(self):
        self.dir = self.proc = None

    def start(self, out_dir, models):
        self.dir = Path(out_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.log = open(self.dir / "refs.log", "w")
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--cpu-refs",
             str(self.dir), *models], cwd=ROOT, stdout=self.log,
            stderr=subprocess.STDOUT)
        self.t0 = time.perf_counter()

    def _wait(self, path):
        """Wait for the process to write `path`; the seconds waited."""
        if self.proc is None:
            raise SystemExit(f"no CPU reference process to write {path}")
        t0 = time.perf_counter()
        while not path.exists():
            if self.proc.poll() is not None and not path.exists():
                raise SystemExit(
                    f"the CPU reference process ended ({self.proc.returncode})"
                    f" without {path.name}:\n"
                    + (self.dir / "refs.log").read_text()[-4000:])
            if time.perf_counter() - t0 > REF_WAIT_S:
                raise SystemExit(f"no {path.name} after {REF_WAIT_S} s")
            time.sleep(0.2)
        return time.perf_counter() - t0

    def get(self, model, i):
        path = self.dir / f"{model}_{i}.pt"
        waited = self._wait(path)
        r = torch.load(path, weights_only=True)
        path.unlink()
        log(f"[refs] {model} draw {i}: the CPU step took {r['seconds']:.1f} s"
            f" in the reference process; waited {waited:.1f} s for it, "
            f"{time.perf_counter() - self.t0:.1f} s after it started")
        return r

    def entry_tree(self, tmp):
        """The entry phases' tree: in the reference process's directory,
        which it reads for the entry reference, marked ready once written
        (else under `tmp`)."""
        if self.proc is None:
            return write_entry_tree(tmp)
        tree = write_entry_tree(self.dir / "entry")
        (self.dir / "entry" / "ready").touch()
        return tree

    def waymo_tree(self):
        """The Waymo entry tree the process writes (write_waymo_tree)."""
        ready = self.dir / "waymo" / "ready"
        waited = self._wait(ready)
        log(f"[refs] the Waymo tree: {ready.read_text()} s of host time in "
            f"the reference process ({REF_THREADS} threads); waited "
            f"{waited:.1f} s for it, {time.perf_counter() - self.t0:.1f} s "
            "after it started")
        return ready.parent

    def stop(self):
        """End the process where it still runs; remove its directory."""
        if self.proc is None:
            return
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()
        shutil.rmtree(self.dir, ignore_errors=True)


CPU_REFS = CpuRefs()


def hold_step(tag, reading, ref):
    """Log a step_against_cpu reading beside its bound `ref` (loss rel,
    whole-gradient cosine, worst conv cosine); returns its misses."""
    cc = reading["cos_conv"]
    worst = min(cc, key=cc.get)
    got = (reading["loss_rel"], reading["cos_all"], cc[worst])
    names = ("loss rel", "whole-gradient cosine", "worst conv cosine")
    misses = [f"{tag}: {n} {v:.4e} beyond {b:.4e}" for n, v, b, up in
              zip(names, got, ref, (True, False, False))
              if not np.isfinite(v) or (v > b if up else v < b)]
    log(f"[{tag}] loss {reading['loss_gpu']:.6f} vs {reading['loss_cpu']:.6f} "
        f"(rel {got[0]:.4e}, bound {ref[0]:.4e}); whole-gradient cosine "
        f"{got[1]:.6f} (>= {ref[1]:.4f}); conv weight gradient cosines over "
        f"{len(cc)} convs: min {got[2]:.6f} at {worst} (>= {ref[2]:.4f}), "
        f"median {statistics.median(cc.values()):.6f}; "
        f"{'MISS: ' + '; '.join(misses) if misses else 'within its bounds'}"
        f" (card {reading['seconds']['gpu']:.1f} s, CPU "
        f"{reading['seconds']['cpu']:.1f} s)")
    return misses


def tf32_widened(loss_mean, ref, floor, reading):
    """A model's rule (train_ref_rule's loss bound and cosine rows, and
    train_ref_floor) widened for TF32 convs by twice a TF32 reading (loss
    rel, whole-gradient cosine, worst conv cosine): the loss bounds up by
    2 x its loss rel, the cosines down by 2 x (1 - its cosine)."""
    dl, da, dc = 2 * reading[0], 2 * (1 - reading[1]), 2 * (1 - reading[2])
    return (loss_mean + dl, tuple((a - da, c - dc) for a, c in ref),
            (floor[0] + dl, floor[1] - da, floor[2] - dc))


# the draws a model's training reference takes, where not all ten: the
# first five (the reference process's CPU steps are the host's largest
# load, and on a slow host the phases waited for them), each held to its
# row and the model's floor, the mean loss difference to twice JAX's mean
# over those five; the Bottleneck's rule holds its ten draws as a set
TRAIN_REF_DRAWS_OF = {"MinkUNet": 5, "SPVCNN": 5, "Cylinder_TS": 5,
                      "RPVNet": 5, "Waymo": 5}


def train_ref_bounds(model):
    """A model's rule (TRAIN_REF_MODELS): (the bound on the mean relative
    loss difference, each draw's cosine row, the floor, and the bounds on
    the mean whole-gradient and worst conv cosines or None). RPVNet's is
    widened for its TF32 range convs; a model of TRAIN_REF_MEAN_RULE
    holds each draw to the floor and the means to JAX's means less
    TRAIN_REF_MARGIN."""
    reading = TRAIN_REF_MODELS[model][2]
    n = TRAIN_REF_DRAWS_OF.get(model, TRAIN_REF_DRAWS)
    loss_mean, ref = train_ref_rule(reading[:n])
    floor = train_ref_floor(reading)
    if model == "RPVNet":    # its range convs run TF32 on the card
        loss_mean, ref, floor = tf32_widened(loss_mean, ref, floor,
                                             RPV_TF32_READING)
    if model not in TRAIN_REF_MEAN_RULE:
        return loss_mean, ref, floor, None
    # the floor lies below JAX's lowest cosines by the widest gap between
    # two bf16 runs of one draw (JAX's and the port's CPU readings)
    port = TRAIN_REF_MODELS[model][3]
    floor = (floor[0],) + tuple(
        min(r[k] for r in reading)
        - max(abs(j[k] - p[k]) for j, p in zip(reading, port))
        for k in (1, 2))
    return (loss_mean, tuple((floor[1], floor[2]) for _ in reading), floor,
            tuple(statistics.fmean(r[k] for r in reading) - TRAIN_REF_MARGIN
                  for k in (1, 2)))


def train_reference_phase(report, model="MinkUNet", cpu_tables=False):
    """One train_step of `model` from the weights seed_weights(SEED) on each
    of the draws of train_ref_draws: GPU (bf16, kernels) against CPU
    (float32, plain versions; the reference process's, CPU_REFS), held to
    the rule JAX's reading sets (train_ref_bounds: the mean loss
    difference, each draw's cosine row, the floor, and for a model of
    TRAIN_REF_MEAN_RULE the mean cosines), beside JAX's and the CPU bf16
    readings of the same draw. The draws and weights must be those the
    readings were taken on (the model's digest in TRAIN_REF_MODELS)."""
    from openpcseg_torch.engine.task import SegTask

    cfgs, inputs, jax_reading, port_reading, key, tag = TRAIN_REF_MODELS[
        model]
    loss_mean, ref, floor, mean_cos = train_ref_bounds(model)
    draws = ref_draws(model)
    net = SegTask(cfgs, classes(cfgs), device="cpu",
                  voxel_cap_per_scan=8192).model
    seed_weights(net, SEED)
    digest = inputs_digest(draws, net)
    log(f"[{tag}] {model} draws and weights: digest {digest} (JAX's "
        f"reading was taken on {inputs})")
    if digest != inputs:
        raise SystemExit(f"{tag} phase: the draws or weights differ from "
                         "those of JAX's reading")
    rows, misses = [], []
    n = TRAIN_REF_DRAWS_OF.get(model, TRAIN_REF_DRAWS)
    for i, draw in enumerate(draws[:n]):
        r = step_against_cpu(cfgs, draw, CPU_REFS.get(model, i),
                             weights_seed=SEED, cpu_tables=cpu_tables,
                             voxel_cap_per_scan=8192,
                             iters_per_epoch=ITERS_PER_EPOCH)
        misses += hold_step(f"{tag} draw {i}", r, (floor[0],) + ref[i])
        log(f"[{tag} draw {i}] JAX bf16 vs f32 {jax_reading[i]}, port CPU "
            f"bf16 vs f32 {port_reading[i] if port_reading else '-'}")
        rows.append(r)
    means, sd = {}, {}
    for name, vals in (("card", [r["loss_rel"] for r in rows]),
                       ("jax", [r[0] for r in jax_reading[:n]]),
                       ("port_cpu_bf16", [r[0] for r in
                                          (port_reading or ())[:n]])):
        if vals:
            means[name] = statistics.fmean(vals)
            sd[name] = statistics.stdev(vals)
    log(f"[{tag}] mean relative loss difference over {len(rows)} draws: "
        f"card {means['card']:.4e} (bound {loss_mean:.4e}, twice JAX's "
        f"{means['jax']:.4e}); standard deviations card {sd['card']:.4e}, "
        f"JAX {sd['jax']:.4e}; port CPU bf16 mean, sd "
        f"{means.get('port_cpu_bf16', float('nan')):.4e}, "
        f"{sd.get('port_cpu_bf16', float('nan')):.4e}")
    if means["card"] > loss_mean:
        misses.append(f"mean loss rel {means['card']:.4e} beyond "
                      f"{loss_mean:.4e}")
    if mean_cos is not None:
        got = (statistics.fmean(r["cos_all"] for r in rows),
               statistics.fmean(min(r["cos_conv"].values()) for r in rows))
        log(f"[{tag}] mean whole-gradient cosine {got[0]:.6f} (at least "
            f"{mean_cos[0]:.6f}), mean worst conv cosine {got[1]:.6f} (at "
            f"least {mean_cos[1]:.6f}): JAX's means less {TRAIN_REF_MARGIN}")
        misses += [f"mean cosine {g:.6f} below {b:.6f}"
                   for g, b in zip(got, mean_cos) if g < b]
    report[key] = dict(draws=rows, loss_rel_mean=means, loss_rel_sd=sd)
    if misses:
        raise SystemExit(f"{tag} phase: " + "; ".join(misses))


def entry_batch(argv):
    """The train CLI's config for `argv` and the first batch its training
    loader gives (numpy, without the scan names)."""
    from openpcseg_torch.cli.train import parse_config
    from openpcseg_torch.data import build_dataloader

    args, cfgs = parse_config(argv)
    _, loader = build_dataloader(
        cfgs.DATA, cfgs.get("MODALITY", "voxel"), args.batch_size,
        training=True, point_cap=cfgs.TPU.POINT_CAP_PER_SCAN, num_workers=1,
        seed=args.seed)
    batch = next(iter(loader))
    return cfgs, {k: v for k, v in batch.items() if k != "name"}


def entry_ref_cfgs(cfgs):
    """The entry reference's network: the CLI's config with its stages
    cut to ENTRY_REF_LAYERS."""
    return dict(cfgs, MODEL=dict(cfgs["MODEL"], NUM_LAYER=ENTRY_REF_LAYERS))


def entry_argv(tmp, tree):
    """The train CLI's arguments of the entry phase."""
    return (["--cfg_file", str(ROOT / ENTRY_CFG), "--log_dir",
             f"{tmp}/logs", "--extra_tag", "chip_smoke", "--batch_size",
             str(ENTRY_BATCH), "--log_interval", "1"],
            ["--set", "DATA.DATA_PATH", tree])


def entry_cpu_step(out):
    """The reference process's entry step: once the main process has
    written the entry tree under `out`/entry (CpuRefs.entry_tree), the CLI
    loader's first batch over it and that batch's CPU float32 step (with
    the batch's digest, which the card's side checks)."""
    ready = out / "entry" / "ready"
    t0 = time.perf_counter()
    while not ready.exists():
        if time.perf_counter() - t0 > REF_WAIT_S:
            raise SystemExit("the entry tree was not written")
        time.sleep(0.5)
    argv, sets = entry_argv(out, str(out / "entry" / "sequences"))
    cfgs, batch = entry_batch(argv + sets)
    r = one_step(entry_ref_cfgs(cfgs), batch, "cpu",
                 batch_per_device=ENTRY_BATCH)
    r["digest"] = inputs_digest([batch], torch.nn.Module())
    return r


def entry_reference(cfgs, batch, report):
    """The entry phase's own batch on the card, after its counters are
    read: one train step of the CLI's network cut to ENTRY_REF_LAYERS
    against the CPU float32 reference, held to
    TRAIN_REF_LOSS_MEAN and the strictest cosine rows of TRAIN_REF (no JAX
    reading exists at this size), then every forward and backward kernel
    case, untimed, on the pyramid of that batch."""
    from openpcseg_torch.engine.task import SegTask, batch_to_device

    strict = (TRAIN_REF_LOSS_MEAN, max(r[0] for r in TRAIN_REF),
              max(r[1] for r in TRAIN_REF))
    cpu = CPU_REFS.get("entry", 0)
    if cpu["digest"] != inputs_digest([batch], torch.nn.Module()):
        raise SystemExit("entry reference: the reference process's batch "
                         "differs from the CLI loader's")
    step = step_against_cpu(entry_ref_cfgs(cfgs), batch, cpu,
                            batch_per_device=ENTRY_BATCH)
    misses = hold_step(f"entry-ref batch {ENTRY_BATCH}", step, strict)
    if misses:
        raise SystemExit("entry reference: " + "; ".join(misses))
    task = SegTask(cfgs, NUM_CLASS, device="cuda",
                   compute_dtype=torch.bfloat16, seed=SEED,
                   batch_per_device=ENTRY_BATCH)
    _, pyr = task.preprocess(batch_to_device(batch, "cuda"))
    log(f"[entry-kernels] batch-{ENTRY_BATCH} pyramid: voxels per level "
        f"{pyr.level_counts.tolist()}, caps {task.caps}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows = check_cases(kernel_cases(pyr, gen), "entry-kernels", timed=False)
    rows += check_cases(backward_cases(pyr, gen), "entry-bwd", timed=False)
    report["entry_reference"] = dict(step=step, cases=rows)


def write_entry_tree(tmp):
    """The entry phases' ray-cast SemanticKITTI tree under `tmp`."""
    from openpcseg_torch.data.raycast_kitti import write_tree

    t0 = time.perf_counter()
    tree = write_tree(tmp, *ENTRY_SCANS)
    log(f"[entry] ray-cast SemanticKITTI tree: {ENTRY_SCANS[0]} train "
        f"scans in 00, {ENTRY_SCANS[1]} val scans in 08 "
        f"({time.perf_counter() - t0:.1f} s of host time)")
    return tree


def native_phase(report, tmp, tree):
    """The native scan and label readers (openpcseg_torch/native.py) on the
    card machine's host: built with g++ from the checkout's source; every
    .bin and .label of the entry `tree` read through them and through
    their plain versions, which must give equal arrays; the first batch
    of the train CLI's loader over the tree, over which native.READS must
    move; and the host ms a scan of each path, reading the .bin and
    reading and remapping the .label: per file the median of NATIVE_REPS
    reads of each path in turns (page-cached, warm), then the median over
    the tree's scans."""
    from openpcseg_torch import native
    from openpcseg_torch.data.semantickitti_meta import LEARNING_MAP_LUT

    t0 = time.perf_counter()
    so = native.build()
    native.lib()
    log(f"[native] g++ build of {native.SRC.name}: "
        f"{time.perf_counter() - t0:.2f} s -> {so.name}")
    readers = {
        "scan": (native.load_kitti_scan, native.load_kitti_scan_plain),
        "labels": (lambda p: native.load_kitti_labels(p, LEARNING_MAP_LUT),
                   lambda p: native.load_kitti_labels_plain(
                       p, LEARNING_MAP_LUT)),
    }
    bins = sorted(Path(tree).glob("*/velodyne/*.bin"))
    ms = {(kind, path): [] for kind in readers
          for path in ("native", "plain")}
    rows, faults = [], []
    for b in bins:
        files = {"scan": b,
                 "labels": b.parents[1] / "labels" / f"{b.stem}.label"}
        for kind, (nat, plain) in readers.items():
            got, want = nat(files[kind]), plain(files[kind])
            if got.dtype != want.dtype or not np.array_equal(got, want):
                faults.append(f"{files[kind].name}: the native {kind} "
                              "differs from its plain version")
            times = {"native": [], "plain": []}
            for _ in range(NATIVE_REPS):
                for path, fn in (("native", nat), ("plain", plain)):
                    t = time.perf_counter()
                    fn(files[kind])
                    times[path].append((time.perf_counter() - t) * 1e3)
            for path in times:
                ms[kind, path].append(statistics.median(times[path]))
            if kind == "scan":
                rows.append(len(got))
    before = {k: native.READS[k] for k in readers}
    _, batch = entry_batch(sum(entry_argv(tmp, tree), []))
    moved = {k: native.READS[k] - before[k] for k in before}
    if len(bins) != sum(ENTRY_SCANS) or min(moved.values()) < ENTRY_BATCH:
        faults.append(f"{len(bins)} scans read; the loader's batch moved "
                      f"native.READS by {moved} (want >= {ENTRY_BATCH})")
    med = {f"{kind}_{path}": statistics.median(v)
           for (kind, path), v in ms.items()}
    log(f"[native] {len(bins)} scans of {min(rows)}-{max(rows)} points, "
        "native equal to plain; host ms a scan (median over the scans of "
        f"each file's median of {NATIVE_REPS} reads, page-cached) on the "
        f"host of {card_line()}: .bin native {med['scan_native']:.3f} / "
        f"plain {med['scan_plain']:.3f}; .label read + remap native "
        f"{med['labels_native']:.3f} / plain {med['labels_plain']:.3f}; "
        f"the loader's first batch of {ENTRY_BATCH} moved native.READS by "
        f"{moved}")
    report["native"] = dict(ms={f"{k}_{p}": v for (k, p), v in ms.items()},
                            median_ms=med, points=rows, reads_moved=moved,
                            host_of=card_line())
    faults += projection_check(report)
    if faults:
        raise SystemExit("native phase: " + "; ".join(faults))


def raycast_projection_input():
    """The ray-cast scan of SEED as the range view hands it to the
    projection: ([N, 4] float32 x, y, z, intensity, [N] int32 labels)."""
    from openpcseg_torch.data.raycast import raycast_batch

    b = raycast_batch(SEED, 1)
    v = b["valid"][0]
    pts = np.concatenate([b["xyz"][0][v], b["feats"][0][v, 3:4]], 1)
    return pts.astype(np.float32), b["labels"][0][v].astype(np.int32)


def points_digest(pts) -> str:
    """sha256 (first 16 hex digits) of a float32 point array."""
    return hashlib.sha256(np.ascontiguousarray(
        pts, np.float32).tobytes()).hexdigest()[:16]


def projection_pixels(a, b) -> dict:
    """The pixels where two (scan, label, mask) projections differ: in the
    mask, in any channel of the scan tensor, in the label, in any."""
    scan = (a[0] != b[0]).any(-1)
    label, mask = a[1] != b[1], a[2] != b[2]
    return {"mask": int(mask.sum()), "scan": int(scan.sum()),
            "label": int(label.sum()), "any": int((scan | label | mask).sum())}


def projection_check(report) -> list:
    """native_phase's range projection: the ray-cast scan of SEED through
    native.range_project (the library native_phase built) against
    RANGE_NATIVE_FIXTURE and against range_project_plain, and the host ms
    of each (median of PROJECTION_REPS, in turns, after one call of each).
    The faults found."""
    from openpcseg_torch import native

    pts, lab = raycast_projection_input()
    want = np.load(ROOT / RANGE_NATIVE_FIXTURE)
    same_points = str(want["points_sha256"]) == points_digest(pts)
    args = (pts, lab, RANGE_H, RANGE_W)
    before = native.READS["projection"]
    nat = native.range_project(*args)
    plain = native.range_project_plain(*args)
    vs_fixture = projection_pixels(nat, [want[k] for k in (
        "scan", "label", "mask")])
    vs_plain = projection_pixels(nat, plain)
    times = {"native": [], "plain": []}
    for _ in range(PROJECTION_REPS):
        for path, fn in (("native", native.range_project),
                         ("plain", native.range_project_plain)):
            t = time.perf_counter()
            fn(*args)
            times[path].append((time.perf_counter() - t) * 1e3)
    calls = native.READS["projection"] - before
    med = {k: statistics.median(v) for k, v in times.items()}
    pixels = RANGE_H * RANGE_W
    log(f"[native] range projection of the ray-cast scan of SEED "
        f"({len(pts)} points, digest {'equal to' if same_points else 'NOT'}"
        f" the fixture's) at {RANGE_H} x {RANGE_W}: "
        f"{int(nat[2].sum())} pixels hold a point natively, "
        f"{int(plain[2].sum())} by the plain version; pixels differing "
        f"from the fixture's native output {vs_fixture} "
        f"(at most {PROJECTION_FIXTURE_PIXELS}), from the plain version "
        f"{vs_plain} (at most {PROJECTION_PLAIN_SHARE:.0%} of {pixels}); "
        f"host ms (median of {PROJECTION_REPS}) on the host of "
        f"{card_line()}: native {med['native']:.3f} / plain "
        f"{med['plain']:.3f}; native.READS['projection'] moved by {calls}")
    report["native_projection"] = dict(
        points=len(pts), same_points=same_points, vs_fixture=vs_fixture,
        vs_plain=vs_plain, ms=times, median_ms=med, calls=calls,
        host_of=card_line())
    faults = []
    if vs_fixture["any"] > PROJECTION_FIXTURE_PIXELS:
        faults.append(f"the native projection differs from the fixture's "
                      f"on {vs_fixture} pixels (at most "
                      f"{PROJECTION_FIXTURE_PIXELS})")
    if vs_plain["any"] > PROJECTION_PLAIN_SHARE * pixels:
        faults.append(f"the native projection differs from its plain "
                      f"version on {vs_plain} pixels (at most "
                      f"{PROJECTION_PLAIN_SHARE * pixels:.0f})")
    if calls != 1 + PROJECTION_REPS:
        faults.append(f"native.READS['projection'] moved by {calls}, not "
                      f"{1 + PROJECTION_REPS}")
    return faults


def _run_logs(log_dir):
    """The log text, metrics records and checkpoints of a train CLI run."""
    exp = next(Path(log_dir).glob("**/ckp")).parent
    logs = "".join(p.read_text() for p in sorted(exp.glob("log_*.txt")))
    recs = [json.loads(line) for line in (exp / "metrics.jsonl").open()]
    return (logs, [r for r in recs if "loss" in r],
            [r for r in recs if "val_miou" in r],
            sorted(p.name for p in (exp / "ckp").iterdir()))


def entry_point_phase(report, tmp, tree):
    """The user's entry points on the card: the train CLI on the mk34 yaml
    as it stands (full width, cap 98304, bf16) at batch ENTRY_BATCH over
    the ray-cast SemanticKITTI `tree`, its auto-resume, and the infer
    CLI's SemanticKITTI submission dump; every counter but SPVCNN's read
    over the phase; then the phase's first batch against the CPU reference
    (entry_reference)."""
    from openpcseg_torch.cli import infer, train
    from openpcseg_torch.data.semantickitti_meta import LEARNING_MAP_INV_LUT
    from openpcseg_torch.ops import cuda_lib

    preds = Path(tmp) / "preds"
    argv, sets = entry_argv(tmp, tree)
    cuda_lib.reset_counts()
    t0 = time.perf_counter()
    for epochs in (1, 2):
        if train.main(argv + ["--epochs", str(epochs)] + sets) != 0:
            raise SystemExit(f"entry point: train --epochs {epochs} "
                             "failed")
    if infer.main(argv + ["--save_pred", "--save_raw_ids"] + sets
                  + ["DATA.OUTPUT_DIR", str(preds)]) != 0:
        raise SystemExit("entry point: infer failed")
    wall = time.perf_counter() - t0
    launches = dict(cuda_lib.LAUNCHES)
    plain_on_cuda = dict(cuda_lib.PLAIN_ON_CUDA)

    logs, steps, evals, ckps = _run_logs(f"{tmp}/logs")
    labels = sorted(preds.glob("sequences/08/predictions/*.label"))
    legal = set(LEARNING_MAP_INV_LUT.tolist())
    dumped = []
    for f in labels:
        ids = np.fromfile(f, dtype=np.uint32)
        scan = Path(tree, "08", "velodyne", f.stem + ".bin")
        dumped.append(dict(file=f.name, ids=len(ids),
                           points=scan.stat().st_size // 16,
                           legal=set(np.unique(ids).tolist()) <= legal))
    entry_reference(*entry_batch(argv + sets), report)

    step_ms = [r["step_time"] * 1e3 for r in steps]
    med = statistics.median(step_ms)
    data_ms = statistics.median(r["data_time"] * 1e3 for r in steps)
    miou = evals[-1]["val_miou"] if evals else float("nan")
    log(f"[entry] train CLI, batch {ENTRY_BATCH}: step ms {med:.1f} (median "
        f"of {len(step_ms)}: {', '.join(f'{t:.1f}' for t in step_ms)}), "
        f"data_time ms {data_ms:.1f} (median), "
        f"{ENTRY_BATCH * 1e3 / med:.2f} scans/s, val mIoU {miou:.2f}; "
        f"{wall:.1f} s for train, resume and infer; launches {launches}")
    report["entry_point"] = dict(
        steps=steps, evals=evals, checkpoints=ckps, dumped=dumped,
        step_ms_median=med, data_ms_median=data_ms,
        scans_per_s=ENTRY_BATCH * 1e3 / med,
        val_miou=miou, wall_s=wall, launches=launches,
        plain_on_cuda=plain_on_cuda)
    faults = []
    if "resumed from epoch 0" not in logs:
        faults.append("the second train call did not resume from epoch 0")
    n_steps = ENTRY_SCANS[0] // ENTRY_BATCH * 2
    if [r["step"] for r in steps] != list(range(1, n_steps + 1)):
        faults.append(f"train steps {[r['step'] for r in steps]}, not "
                      f"1..{n_steps} over the two epochs")
    if ckps != ["0.pt", "1.pt"] or len(evals) != 3:
        faults.append(f"checkpoints {ckps}, {len(evals)} evals (want 0.pt, "
                      "1.pt and 3: one per epoch, one by infer)")
    if not all(np.isfinite(r["loss"]) for r in steps):
        faults.append("a loss is not finite")
    if any(r["voxel_overflow"] for r in steps) or any(
            r["val_voxel_overflow"] for r in evals):
        faults.append("voxel_overflow > 0 in metrics.jsonl")
    if len(dumped) != ENTRY_SCANS[1] or not all(
            d["ids"] == d["points"] and d["legal"] for d in dumped):
        faults.append(f"the --save_raw_ids dump is wrong: {dumped}")
    missing = [k for k in MINK_COUNTERS if launches[k] == 0]
    if missing or any(plain_on_cuda.values()):
        faults.append(f"kernels never launched {missing}, or a plain version "
                      f"ran on the card {plain_on_cuda}")
    if faults:
        raise SystemExit("entry-point phase: " + "; ".join(faults))
    return launches


def jax_ckpt_phase(report, tmp, tree):
    """A JAX run resumed and served on the card (phase 23): the fixture
    JAX_CKPT_FIXTURE through Trainer.restore, its eval logits and one train
    step against JAX's numbers, then the train and infer CLIs with --ckp
    over the entry tree; every counter of MINK_COUNTERS read over the
    phase."""
    from openpcseg_torch.cli import infer, train
    from openpcseg_torch.data.semantickitti_meta import LEARNING_MAP_INV_LUT
    from openpcseg_torch.engine.task import batch_to_device
    from openpcseg_torch.engine.trainer import Trainer
    from openpcseg_torch.models.layers import SparseConv
    from openpcseg_torch.ops import cuda_lib

    fixture = ROOT / f"{JAX_CKPT_FIXTURE}.pt"
    want = np.load(ROOT / f"{JAX_CKPT_FIXTURE}_expect.npz")
    base = ["--cfg_file", str(ROOT / ENTRY_CFG), "--extra_tag", "chip_smoke",
            "--log_interval", "1"]
    sets = ["--set", "DATA.DATA_PATH", tree, *JAX_CKPT_SETS]
    cuda_lib.reset_counts()
    t0 = time.perf_counter()
    args, cfgs = train.parse_config(
        base + ["--log_dir", f"{tmp}/jax_ckpt_restore", "--batch_size", "1",
                "--workers", "1"] + sets
        + ["TPU.VOXEL_CAP_PER_SCAN", str(JAX_CKPT_CAP)])
    trainer = Trainer(args, cfgs)
    trainer.restore(fixture)
    task = trainer.task
    opt = task.optimizer
    params = [p for g in opt.param_groups for p in g["params"]]
    restored = dict(
        step=task.step, start_epoch=trainer.start_epoch,
        buffers=sum(1 for p in params if opt.state[p][
            "momentum_buffer"].is_cuda), parameters=len(params))
    restore_s = time.perf_counter() - t0

    scan = scan_for(CFGS, SEED, cap=JAX_CKPT_CAP)
    if inputs_digest([scan], torch.nn.Module()) != str(want["scan_digest"]):
        raise SystemExit("jax_ckpt phase: the scan differs from the one "
                         "the fixture was made on")
    batch = batch_to_device(scan, "cuda")
    g = task.forward(batch)[2].float().cpu()
    r = torch.as_tensor(want["logits"])
    valid = torch.as_tensor(want["valid"])
    serve = dict(
        rel_max_err=float((g - r).abs().max() / r.abs().max()),
        argmax_agree=float((g.argmax(-1) == r.argmax(-1))[valid].float()
                           .mean()),
        finite=bool(torch.isfinite(g).all()))
    no_dropout(task.model)
    m = task.train_step(batch)

    def cos(a, b):
        a, b = a.double(), b.double()
        return float(a @ b / (a.norm() * b.norm()).clamp(min=1e-300))
    grads = {n: p.grad.float().cpu().reshape(-1)
             for n, p in task.model.named_parameters()}
    ref = {n: torch.as_tensor(want[f"grads3/{n}"]).reshape(-1)
           for n in grads}
    convs = [n + ".weight" for n, mod in task.model.named_modules()
             if isinstance(mod, SparseConv)]
    step = dict(loss_gpu=float(m["loss"]), loss_jax=float(want["loss3"]),
                lr=m["lr"], lr_jax=float(want["lr3"]),
                cos_all=cos(torch.cat(list(grads.values())),
                            torch.cat([ref[n] for n in grads])),
                cos_conv={n: cos(grads[n], ref[n]) for n in convs})
    step["loss_rel"] = (abs(step["loss_gpu"] - step["loss_jax"])
                        / abs(step["loss_jax"]))
    loss_bound, rows = train_ref_rule(tuple(map(tuple, want["reading"])))
    trainer.close()

    preds = Path(tmp) / "jax_ckpt_preds"
    cli = base + ["--log_dir", f"{tmp}/jax_ckpt_cli", "--batch_size",
                  str(ENTRY_BATCH), "--ckp", str(fixture)]
    epochs = int(want["epoch"]) + 2
    t1 = time.perf_counter()
    if train.main(cli + ["--epochs", str(epochs)] + sets) != 0 or infer.main(
            cli + ["--save_pred", "--save_raw_ids"] + sets
            + ["DATA.OUTPUT_DIR", str(preds)]) != 0:
        raise SystemExit("jax_ckpt phase: a CLI with --ckp failed")
    cli_s = time.perf_counter() - t1
    launches = dict(cuda_lib.LAUNCHES)
    plain_on_cuda = dict(cuda_lib.PLAIN_ON_CUDA)
    logs, steps, evals, ckps = _run_logs(f"{tmp}/jax_ckpt_cli")
    legal = set(LEARNING_MAP_INV_LUT.tolist())
    dumped = []
    for f in sorted(preds.glob("sequences/08/predictions/*.label")):
        ids = np.fromfile(f, dtype=np.uint32)
        n_pts = Path(tree, "08", "velodyne", f.stem + ".bin").stat().st_size
        dumped.append(dict(file=f.name, ids=len(ids), points=n_pts // 16,
                           legal=set(np.unique(ids).tolist()) <= legal))
    worst = min(step["cos_conv"].values())
    log(f"[jax_ckpt] fixture restored: step {restored['step']}, next epoch "
        f"{restored['start_epoch']}, {restored['buffers']} of "
        f"{restored['parameters']} momentum buffers on the card "
        f"({restore_s:.1f} s); eval bf16 against JAX f32: max|diff|/max|ref| "
        f"{serve['rel_max_err']:.4f}, argmax agreement "
        f"{serve['argmax_agree']:.4f}; train step: lr {step['lr']:.6g} (JAX "
        f"{step['lr_jax']:.6g}), loss rel {step['loss_rel']:.4e} (bound "
        f"{loss_bound:.4e}), whole-gradient cosine {step['cos_all']:.6f} "
        f"(>= {rows[0][0]:.6f}), worst conv cosine {worst:.6f} (>= "
        f"{rows[0][1]:.6f}); CLIs {cli_s:.1f} s: steps "
        f"{[r['step'] for r in steps]}, checkpoints {ckps}, dump {dumped}; "
        f"launches {launches}")
    report["jax_ckpt"] = dict(
        restored=restored, serve=serve, step=step, loss_bound=loss_bound,
        rows=rows[0], steps=steps, evals=evals, checkpoints=ckps,
        dumped=dumped, launches=launches, plain_on_cuda=plain_on_cuda,
        restore_s=restore_s, cli_s=cli_s,
        seconds=time.perf_counter() - t0)
    faults = []
    n_train = ENTRY_SCANS[0] // ENTRY_BATCH
    if (restored["step"] != int(want["step"]) or restored["start_epoch"]
            != int(want["epoch"]) + 1
            or restored["buffers"] != restored["parameters"]):
        faults.append(f"restored {restored}")
    if (not serve["finite"] or serve["rel_max_err"] > 0.1
            or serve["argmax_agree"] < 0.9):
        faults.append(f"eval against JAX {serve}")
    if (step["loss_rel"] > loss_bound or step["cos_all"] < rows[0][0]
            or worst < rows[0][1]):
        faults.append("train step against JAX outside train_ref_rule")
    if (f"resumed from epoch {int(want['epoch'])}" not in logs
            or ckps != [f"{epochs - 1}.pt"]
            or [r["step"] for r in steps] != list(range(
                int(want["step"]) + 1, int(want["step"]) + n_train + 1))
            or not all(np.isfinite(r["loss"]) for r in steps)):
        faults.append(f"train --ckp: steps {[r['step'] for r in steps]}, "
                      f"checkpoints {ckps}")
    if len(dumped) != ENTRY_SCANS[1] or not all(
            d["ids"] == d["points"] and d["legal"] for d in dumped):
        faults.append(f"infer --ckp dump {dumped}")
    missing = [k for k in MINK_COUNTERS if launches[k] == 0]
    if missing or any(plain_on_cuda.values()):
        faults.append(f"kernels never launched {missing}, or a plain version "
                      f"ran on the card {plain_on_cuda}")
    if faults:
        raise SystemExit("jax_ckpt phase: " + "; ".join(faults))


def vmean_cases(pyr, gen):
    """SPVCNN's mean-voxelize at the shapes its train step gives it: the
    sum (K8 over the level's p2v table) of float32 point features z, and
    its transpose (K7 over the table) of a float32 voxel gradient, zero
    on padding rows; the library call is torch.sparse.mm over the table
    as a CSR matrix."""
    from openpcseg_torch.ops import devox

    cases = []
    for level, c in VMEAN:
        tbl, lv = pyr.p2v[level], pyr.levels[level]
        z = torch.randn(tbl.idx.shape[1], c, device="cuda", generator=gen)
        z = torch.where(pyr.points.valid[:, None], z, 0.0)
        dy = torch.randn(lv.capacity, c, device="cuda", generator=gen)
        dy = torch.where(lv.valid[:, None], dy, 0.0)
        cases.append(case("K8_devoxelize_bwd", f"voxelize_mean L{level} C={c}",
                          devox.voxel_sum, devox.voxel_sum_plain, (z, tbl),
                          sum_work(z, tbl), library=sparse_library(
                              devox_t_csr(tbl, z.shape[0]), z)))
        cases.append(case("K7_devoxelize", f"voxelize_mean bwd L{level} "
                          f"C={c}", devox.point_gather,
                          devox.point_gather_plain, (dy, tbl),
                          gather_work(dy, tbl),
                          library=sparse_library(devox_csr(
                              tbl.idx, tbl.weights, lv.capacity), dy)))
    return cases


def spvcnn_entry_phase(report, tmp, tree):
    """The train CLI on the SPVCNN yaml as it stands (fusion view, full
    width, cap 98304, bf16) at batch ENTRY_BATCH for one epoch over
    `tree`, then the infer CLI with --save_pred; every counter read over
    the phase."""
    from openpcseg_torch.cli import infer, train
    from openpcseg_torch.ops import cuda_lib

    preds = Path(tmp) / "spv_preds"
    argv = ["--cfg_file", str(ROOT / SPV_ENTRY_CFG), "--log_dir",
            f"{tmp}/spv_logs", "--extra_tag", "chip_smoke", "--batch_size",
            str(ENTRY_BATCH), "--log_interval", "1"]
    sets = ["--set", "DATA.DATA_PATH", tree]
    cuda_lib.reset_counts()
    t0 = time.perf_counter()
    if train.main(argv + ["--epochs", "1"] + sets) != 0:
        raise SystemExit("SPVCNN entry point: train failed")
    if infer.main(argv + ["--save_pred"] + sets
                  + ["DATA.OUTPUT_DIR", str(preds)]) != 0:
        raise SystemExit("SPVCNN entry point: infer failed")
    wall = time.perf_counter() - t0
    launches = dict(cuda_lib.LAUNCHES)
    plain_on_cuda = dict(cuda_lib.PLAIN_ON_CUDA)
    _, steps, evals, ckps = _run_logs(f"{tmp}/spv_logs")
    dumped = sorted(p.name for p in preds.glob("*.npy"))
    step_ms = [r["step_time"] * 1e3 for r in steps]
    miou = evals[-1]["val_miou"] if evals else float("nan")
    log(f"[spv-entry] train CLI on {SPV_ENTRY_CFG}, batch {ENTRY_BATCH}: "
        f"step ms {', '.join(f'{t:.1f}' for t in step_ms)}, val mIoU "
        f"{miou:.2f}; {wall:.1f} s for train and infer; {len(dumped)} "
        f"prediction files; launches {launches}")
    report["spvcnn_entry_point"] = dict(
        steps=steps, evals=evals, checkpoints=ckps, dumped=dumped,
        val_miou=miou, wall_s=wall, launches=launches,
        plain_on_cuda=plain_on_cuda)
    faults = []
    if len(steps) != ENTRY_SCANS[0] // ENTRY_BATCH or not all(
            np.isfinite(r["loss"]) for r in steps):
        faults.append(f"train steps {steps}")
    if ckps != ["0.pt"] or len(evals) != 2:
        faults.append(f"checkpoints {ckps}, {len(evals)} evals (want 0.pt "
                      "and 2: one by the epoch, one by infer)")
    if any(r["voxel_overflow"] for r in steps) or any(
            r["val_voxel_overflow"] for r in evals):
        faults.append("voxel_overflow > 0 in metrics.jsonl")
    if len(dumped) != ENTRY_SCANS[1]:
        faults.append(f"--save_pred wrote {dumped}")
    missing = [k for k in MINK_COUNTERS + SPV_COUNTERS if launches[k] == 0]
    if missing or any(plain_on_cuda.values()):
        faults.append(f"kernels never launched {missing}, or a plain version "
                      f"ran on the card {plain_on_cuda}")
    if faults:
        raise SystemExit("SPVCNN entry-point phase: " + "; ".join(faults))
    return launches


def spvcnn_phases(report, tmp, tree):
    """SPVCNN mk34_cr10 on the card: serving, the eval reference, the eval
    profile, its mean-voxelize's kernel cases on scan SEED's pyramid,
    training (every counter launched on every step), the training
    reference over its draws, and the entry points. Returns the cases, the launches
    of serving and training, and those of the entry phase."""
    from openpcseg_torch.engine.task import SegTask, batch_to_device
    from openpcseg_torch.ops import cuda_lib

    task = SegTask(SPV_CFGS, NUM_CLASS, device="cuda",
                   compute_dtype=torch.bfloat16, seed=SEED)
    launches = serving_phase(task, report, "spv-serve",
                             FWD_COUNTERS + ("vmean",), "spvcnn_")
    reference_phase(report, SPV_CFGS, "spvcnn_reference")
    profile_phase(task, report, "spvcnn_")
    _, pyr = task.preprocess(batch_to_device(
        scan_for(CFGS, SEED), "cuda"))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows = check_cases(vmean_cases(pyr, gen), "vmean")
    report["vmean_cases"] = rows
    del task, pyr
    train = training_phase(report, SPV_TRAIN_CFGS, "spv-train",
                           MINK_COUNTERS + SPV_COUNTERS, "spvcnn_")
    launches.update({k: v for k, v in train.items()
                     if k not in FWD_COUNTERS + ("vmean",)})
    train_reference_phase(report, "SPVCNN")
    return rows, launches, spvcnn_entry_phase(report, tmp, tree)


# == Cylinder3D cy480_cr10 ==================================================
# kernel cases at its shapes: (kernel, level, Cin, Cout) of its submanifold
# convs (anisotropic K 9 and 3, the 3^3 at L4, the 20-class head) and
# (coarse level, C) of its k3 strided convs, down and up
CYL_SUBM = [((1, 3, 3), 0, 32, 32), ((3, 1, 1), 0, 32, 32),
            ((1, 3, 3), 3, 256, 256), ((3, 1, 1), 3, 256, 256),
            ((3, 3, 3), 4, 512, 512), ((3, 3, 3), 0, 128, 20)]
CYL_STRIDED = [(1, 64), (4, 512)]
CYL_POINT_C = 256     # the point MLP's width, which the scatter-max reads
CYL_REFINE_C = 128    # up0e's width, which the refinement gathers


def cylinder_cases(pyr, gen):
    """Cylinder3D's kernel cases on a scan's pyramid: each submanifold
    conv of CYL_SUBM on K1 (forward) and K2 (backward, whole), each strided
    conv of CYL_STRIDED down into its level and up out of it on the
    gather-GEMM (forward; rows K3) and its backward (dfeats + dW; rows K5),
    and the refinement gather over the level-0 p2v table (K7) and its
    backward (K8). Labels start with "cyl"."""
    from openpcseg_torch.ops import devox, subm_conv, updown

    bf, f32 = torch.bfloat16, torch.float32

    def rand(lv, c, dtype):
        x = torch.randn(lv.capacity, c, device="cuda", generator=gen)
        return torch.where(lv.valid[:, None], x, 0.0).to(dtype)

    def weight(k, cin, cout):
        return torch.randn(k, cin, cout, device="cuda",
                           generator=gen) / (k * cin) ** 0.5

    cases = []
    for ks, level, cin, cout in CYL_SUBM:
        lv = pyr.levels[level]
        km = lv.subm_subset(ks)
        label = f"cyl {''.join(map(str, ks))} L{level} {cin}->{cout}"
        x, w, d = rand(lv, cin, bf), weight(km.shape[0], cin, cout), rand(
            lv, cout, f32)
        args = (x, w.to(bf), km)
        cases.append(case("K1_subm_conv", label, subm_conv.subm_conv,
                          subm_conv.subm_conv_plain, args, gemm_work(*args)))
        d16, wt = d.to(bf), w.transpose(1, 2).to(bf).contiguous()
        cases.append(case("K2_subm_conv_bwd", label, subm_conv.subm_conv_bwd,
                          subm_conv.subm_conv_bwd_plain, (d, x, w, km),
                          both(gemm_work(d16, wt, km),
                               dw_work(x, km, d16, None))))
    for level, c in CYL_STRIDED:
        fine, coarse = pyr.levels[level - 1], pyr.levels[level]
        for way, src, dst, km, km_t in (
                ("down", fine, coarse, coarse.down_kmap, fine.up_kmap),
                ("up", coarse, fine, fine.up_kmap, coarse.down_kmap)):
            a, b = (level - 1, level) if way == "down" else (level, level - 1)
            label = f"cyl strided {way} L{a}->L{b} {c}->{c}"
            x, w, d = rand(src, c, bf), weight(27, c, c), rand(dst, c, f32)
            args = (x, w.to(bf), km)
            cases.append(case("K3_down_conv", label, updown.strided_conv,
                              updown.strided_conv_plain, args,
                              gemm_work(*args)))
            d16, wt = d.to(bf), w.transpose(1, 2).to(bf).contiguous()
            dwargs = ((x, km, d16, None) if km.shape[1] <= km_t.shape[1]
                      else (x, None, d16, km_t))
            cases.append(case("K5_up_conv_bwd", label,
                              updown.strided_conv_bwd,
                              updown.strided_conv_bwd_plain,
                              (d, x, w, km, km_t),
                              both(gemm_work(d16, wt, km_t),
                                   dw_work(*dwargs))))
    tbl, lv = pyr.p2v[0], pyr.levels[0]
    up0e = rand(lv, CYL_REFINE_C, f32)
    dp = torch.randn(tbl.idx.shape[1], CYL_REFINE_C, device="cuda",
                     generator=gen)
    dp = torch.where(pyr.points.valid[:, None], dp, 0.0)
    cases.append(case("K7_devoxelize", f"cyl refine gather L0 "
                      f"C={CYL_REFINE_C}", devox.point_gather,
                      devox.point_gather_plain, (up0e, tbl),
                      gather_work(up0e, tbl), library=sparse_library(
                          devox_csr(tbl.idx, tbl.weights, lv.capacity),
                          up0e)))
    cases.append(case("K8_devoxelize_bwd", f"cyl refine gather bwd L0 "
                      f"C={CYL_REFINE_C}", devox.voxel_sum,
                      devox.voxel_sum_plain, (dp, tbl), sum_work(dp, tbl),
                      library=sparse_library(devox_t_csr(
                          tbl, dp.shape[0]), dp)))
    return cases


def scatter_max_check(pyr, report):
    """The scatter-max voxelize (plain PyTorch on the card: JAX runs it on
    XLA) at its shape, a float32 [points, 256] into level 0: its forward
    and its backward on the card equal the CPU's, and two backward calls
    on the card agree bit for bit; its device ms beside its bound (the
    points read once, the voxels written once)."""
    from openpcseg_torch.ops.segment import segment_max

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    p2v, cap = pyr.point_to_voxel0, pyr.levels[0].capacity
    pts = torch.randn(p2v.shape[0], CYL_POINT_C, device="cuda",
                      generator=gen)
    dy = torch.randn(cap, CYL_POINT_C, device="cuda", generator=gen)

    def fwd_bwd(x, ids, d):
        x = x.clone().requires_grad_()
        out = segment_max(x, ids, cap)
        out.backward(d)
        return out.detach(), x.grad
    out, g1 = fwd_bwd(pts, p2v, dy)
    _, g2 = fwd_bwd(pts, p2v, dy)
    ref, gref = fwd_bwd(pts.cpu(), p2v.cpu(), dy.cpu())
    same = bool(torch.equal(g1, g2))
    exact = bool(torch.equal(out.cpu(), ref) and torch.equal(g1.cpu(), gref))
    work = (p2v.numel() * 4 + pts.numel() * 4 + out.numel() * 4, 0,
            F32_FLOPS)
    bound_ms, _ = bound(work)
    ms = device_ms(lambda: segment_max(pts, p2v, cap), KERNEL_REPS,
                   bound_ms)
    log(f"[cyl-scatter-max] [{p2v.shape[0]}, {CYL_POINT_C}] f32 into {cap} "
        f"voxels: card == CPU forward and backward {exact}, backward "
        f"repeats {'bit-identical' if same else 'DIFFERS'}; device {ms:.4f} "
        f"ms, bound {bound_ms:.4f} ms")
    report["cylinder_scatter_max"] = dict(exact=exact, bit_identical=same,
                                          device_ms=ms, bound_ms=bound_ms)
    if not (exact and same):
        raise SystemExit("cylinder: the scatter-max on the card differs from "
                         "the CPU's or does not repeat")


def point_branch_phase(task, eval_ms, report):
    """Device time of Cylinder3D's point branch in one eval forward on
    scan SEED + 1 (the point MLP over every point, the scatter-max with
    its compression, the refinement head over the level-0 rows; the
    model's own methods, the UNet left out) and its share of the eval
    step's device time `eval_ms`."""
    from openpcseg_torch.engine.task import batch_to_device

    m = task.model.eval()
    with torch.no_grad():
        vb, pyr = task.preprocess(batch_to_device(
            scan_for(CFGS, SEED + 1), "cuda"))
        up0e = torch.zeros(pyr.levels[0].capacity, m.refine.in_features,
                           device="cuda")

        def branch():
            pp = m.point_mlp(vb.point_feats, pyr.points.valid)
            m.voxelize(pp, pyr)
            m.refine_points(up0e, pp, pyr)
        ms = profile_window("cylinder_point_branch", branch, report)
    log(f"[profile] cylinder point branch: {ms:.3f} ms of the eval step's "
        f"{eval_ms:.3f} ms device time ({ms / eval_ms:.1%})")
    report["cylinder_point_branch_share"] = ms / eval_ms


def cylinder_entry_phase(report, tmp, tree):
    """The train CLI on the Cylinder3D yaml as it stands (the cylinder
    view, full width, cap 98304, bf16) at batch ENTRY_BATCH over `tree`
    for one epoch, again to two (it must resume), then the infer CLI with
    --save_pred --save_raw_ids; its counters read over the phase."""
    from openpcseg_torch.cli import infer, train
    from openpcseg_torch.data.semantickitti_meta import LEARNING_MAP_INV_LUT
    from openpcseg_torch.ops import cuda_lib

    preds = Path(tmp) / "cyl_preds"
    argv = ["--cfg_file", str(ROOT / CYL_ENTRY_CFG), "--log_dir",
            f"{tmp}/cyl_logs", "--extra_tag", "chip_smoke", "--batch_size",
            str(ENTRY_BATCH), "--log_interval", "1"]
    sets = ["--set", "DATA.DATA_PATH", tree]
    cuda_lib.reset_counts()
    t0 = time.perf_counter()
    for epochs in (1, 2):
        if train.main(argv + ["--epochs", str(epochs)] + sets) != 0:
            raise SystemExit(f"Cylinder entry point: train --epochs {epochs} "
                             "failed")
    if infer.main(argv + ["--save_pred", "--save_raw_ids"] + sets
                  + ["DATA.OUTPUT_DIR", str(preds)]) != 0:
        raise SystemExit("Cylinder entry point: infer failed")
    wall = time.perf_counter() - t0
    launches = dict(cuda_lib.LAUNCHES)
    plain_on_cuda = dict(cuda_lib.PLAIN_ON_CUDA)
    logs, steps, evals, ckps = _run_logs(f"{tmp}/cyl_logs")
    legal = set(LEARNING_MAP_INV_LUT.tolist())
    dumped = []
    for f in sorted(preds.glob("sequences/08/predictions/*.label")):
        ids = np.fromfile(f, dtype=np.uint32)
        scan = Path(tree, "08", "velodyne", f.stem + ".bin")
        dumped.append(dict(file=f.name, ids=len(ids),
                           points=scan.stat().st_size // 16,
                           legal=set(np.unique(ids).tolist()) <= legal))
    step_ms = [r["step_time"] * 1e3 for r in steps]
    miou = evals[-1]["val_miou"] if evals else float("nan")
    log(f"[cyl-entry] train CLI on {CYL_ENTRY_CFG}, batch {ENTRY_BATCH}: "
        f"step ms {', '.join(f'{t:.1f}' for t in step_ms)}, val mIoU "
        f"{miou:.2f}; {wall:.1f} s for train, resume and infer; launches "
        f"{launches}")
    report["cylinder_entry_point"] = dict(
        steps=steps, evals=evals, checkpoints=ckps, dumped=dumped,
        val_miou=miou, wall_s=wall, launches=launches,
        plain_on_cuda=plain_on_cuda)
    faults = []
    n_steps = ENTRY_SCANS[0] // ENTRY_BATCH * 2
    if "resumed from epoch 0" not in logs:
        faults.append("the second train call did not resume from epoch 0")
    if [r["step"] for r in steps] != list(range(1, n_steps + 1)) or not all(
            np.isfinite(r["loss"]) for r in steps):
        faults.append(f"train steps {steps}")
    if ckps != ["0.pt", "1.pt"]:
        faults.append(f"checkpoints {ckps}")
    if any(r["voxel_overflow"] for r in steps) or any(
            r["val_voxel_overflow"] for r in evals):
        faults.append("voxel_overflow > 0 in metrics.jsonl")
    if len(dumped) != ENTRY_SCANS[1] or not all(
            d["ids"] == d["points"] and d["legal"] for d in dumped):
        faults.append(f"the --save_raw_ids dump is wrong: {dumped}")
    missing = [k for k in CYL_NEED if launches[k] == 0]
    if missing or any(plain_on_cuda.values()):
        faults.append(f"kernels never launched {missing}, or a plain version "
                      f"ran on the card {plain_on_cuda}")
    if faults:
        raise SystemExit("Cylinder entry-point phase: " + "; ".join(faults))
    return launches


def cylinder_phases(report, tmp, tree):
    """Cylinder3D cy480_cr10 on the card: serving (its forward counters
    on every request), the eval profile, its idle share and its point
    branch's share, its kernel
    cases and the scatter-max on scan SEED's pyramid, the eval reference
    (after counting the points whose cell the card and the CPU put apart),
    training (every counter of its path on every step), the training
    reference over its draws under its own JAX reading, and the entry
    points. Returns the cases, the launches of serving and training, and
    those of the entry phase."""
    from openpcseg_torch.engine.task import SegTask, batch_to_device

    task = SegTask(CYL_CFGS, NUM_CLASS, device="cuda",
                   compute_dtype=torch.bfloat16, seed=SEED)
    launches = serving_phase(task, report, "cyl-serve", CYL_FWD, "cylinder_")
    eval_ms = profile_phase(task, report, "cylinder_")
    idle = 1.0 - eval_ms / report["cylinder_p50_ms"]
    log(f"[profile] cylinder_eval_step device idle share {idle:.4f} (device "
        f"{eval_ms:.3f} ms of the {report['cylinder_p50_ms']:.3f} ms p50)")
    report["cylinder_eval_idle_share"] = idle
    point_branch_phase(task, eval_ms, report)
    _, pyr = task.preprocess(batch_to_device(
        scan_for(CFGS, SEED), "cuda"))
    log(f"[cyl-kernels] pyramid of scan {SEED}: voxels per level "
        f"{pyr.level_counts.tolist()}, caps {task.caps}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    rows = check_cases(cylinder_cases(pyr, gen), "cyl-kernels")
    report["cylinder_cases"] = rows
    scatter_max_check(pyr, report)
    del task, pyr
    moved = cells_moved(CYL_CFGS, scan_for(CFGS, SEED, cap=8192))
    log(f"[cylinder-reference] points of the 8192-point scan whose cell the "
        f"card and the CPU put apart: {moved}"
        + ("; the card's runs below take the CPU's tables" if moved else ""))
    report["cylinder_cells_moved"] = moved
    reference_phase(report, CYL_CFGS, "cylinder_reference", moved > 0)
    train = training_phase(report, CYL_TRAIN_CFGS, "cyl-train", CYL_NEED,
                           "cylinder_")
    launches.update({k: v for k, v in train.items() if k not in CYL_FWD})
    train_reference_phase(report, "Cylinder_TS", moved > 0)
    return rows, launches, cylinder_entry_phase(report, tmp, tree)


# == RPVNet mk34_cr17_5 =====================================================
# kernel cases at its shapes on scan SEED's pyramid: submanifold convs the
# mk34 cases never ran (the 5-wide stem, 56, the first block of stage 4,
# the 672 = 448 + 224 concatenation of up stage 0), its widest down conv
# (k2 convs keep their width) and its two widest up convs, the voxel
# devoxelize at 448 / 224, and the range fusion over its tables: (scale of
# the 64 x 2048 image, C) of each gate's range map (K7 over the bilinear
# table, K8 over its transpose) and each point-to-range mean (K8 over the
# pixel table, K7 back), float32
RPV_SUBM = [(0, 5, 56), (0, 56, 56), (4, 224, 448), (3, 672, 448)]
RPV_DOWNS = [(4, 224)]
RPV_UPS = [(3, 448, 448), (2, 448, 224)]
RPV_DEVOX = [(4, 448), (2, 224)]
RPV_R2P = [(1, 56), (16, 448), (4, 224), (1, 168)]
RPV_P2R = [(1, 56), (16, 448), (4, 224)]


def no_dropout(model):
    """p = 0 for the dropout of every block that holds its rate as `p`
    (the range models' and RPVNet's range blocks): the card's and the
    CPU's generators draw different masks, so a step compared across them
    runs without."""
    for m in model.modules():
        if isinstance(getattr(m, "p", None), float):
            m.p = 0.0


def rpv_range_cases(pyr, gen):
    """RPVNet's range fusion at the shapes its train step gives it, on the
    range tables of scan SEED: K7 over each bilinear table (4 corners) of
    a float32 range map and K8 over its transpose of a float32 point
    gradient; K8 over each pixel table of float32 point features (the
    mean's sum) and K7 over it of a pixel gradient (the mean's backward);
    the library call torch.sparse.mm over the same table as a CSR."""
    from functools import partial

    from openpcseg_torch.ops import devox

    valid = pyr.points.valid
    n = valid.shape[0]

    def rand(rows, c, keep=None):
        x = torch.randn(rows, c, device="cuda", generator=gen)
        return x if keep is None else torch.where(keep[:, None], x, 0.0)

    cases = []
    for scale, c in RPV_R2P:
        h, w = RANGE_H // scale, RANGE_W // scale
        tbl = pyr.range[h, w].bilinear
        fmap, d = rand(tbl.num_voxels, c), rand(n, c, valid)
        label = f"rpv r2p {h}x{w} C={c}"
        cases.append(case(
            "K7_devoxelize", label, partial(devox.devoxelize, counter="r2p"),
            partial(devox.devoxelize_plain, counter="r2p"),
            (fmap, tbl.idx, tbl.weights), devox_work(fmap, tbl.idx,
                                                     tbl.weights),
            library=sparse_library(devox_csr(tbl.idx, tbl.weights,
                                             tbl.num_voxels), fmap)))
        cases.append(case(
            "K8_devoxelize_bwd", label + " bwd",
            partial(devox.devoxelize_bwd, counter="r2p_bwd"),
            partial(devox.devoxelize_bwd_plain, counter="r2p_bwd"),
            (d, tbl), devox_bwd_work(d, tbl),
            library=sparse_library(devox_t_csr(tbl, n), d)))
    for scale, c in RPV_P2R:
        h, w = RANGE_H // scale, RANGE_W // scale
        tbl = pyr.range[h, w].pixel
        z, dy = rand(n, c, valid), rand(tbl.num_voxels, c)
        label = f"rpv p2r {h}x{w} C={c}"
        cases.append(case(
            "K8_devoxelize_bwd", label, partial(devox.voxel_sum,
                                                counter="p2r"),
            partial(devox.voxel_sum_plain, counter="p2r"), (z, tbl),
            sum_work(z, tbl), library=sparse_library(devox_t_csr(tbl, n),
                                                     z)))
        cases.append(case(
            "K7_devoxelize", label + " bwd",
            partial(devox.point_gather, counter="p2r_bwd"),
            partial(devox.point_gather_plain, counter="p2r_bwd"),
            (dy, tbl), gather_work(dy, tbl),
            library=sparse_library(devox_csr(tbl.idx, tbl.weights,
                                             tbl.num_voxels), dy)))
    return cases


def rpv_tables_moved(scan, cap):
    """RPVNet's range tables of the numpy fusion `scan` built on the card
    and on the CPU (voxelize, each voxel's pxpy, the tables): the points
    whose pixel or bilinear corners differ, summed over the resolutions,
    and the largest weight difference."""
    from openpcseg_torch.engine.task import SegTask, batch_to_device

    tables = {}
    for dev in ("cuda", "cpu"):
        t = SegTask(RPV_CFGS, NUM_CLASS, device=dev,
                    voxel_cap_per_scan=cap, seed=SEED)
        tables[dev] = {k: to_device(v, "cpu") for k, v in t.preprocess(
            batch_to_device(scan, dev))[1].range.items()}
        del t
    moved, werr = 0, 0.0
    for k, g in tables["cuda"].items():
        r = tables["cpu"][k]
        moved += int(((g.bilinear.idx != r.bilinear.idx).any(0)
                      | (g.pixel.idx != r.pixel.idx).any(0)).sum())
        werr = max(werr, float((g.bilinear.weights - r.bilinear.weights)
                               .abs().max()))
    return moved, werr


def rpvnet_entry_phase(report, tmp, tree):
    """The train CLI on the RPVNet yaml as it stands (fusion view, full
    width, cap 98304, bf16, TF32 range convs) at batch ENTRY_BATCH for one
    epoch over `tree`, again to two (it must resume), then the infer CLI
    with --save_pred --save_raw_ids; every counter of its path read over
    the phase."""
    from openpcseg_torch.cli import infer, train
    from openpcseg_torch.data.semantickitti_meta import LEARNING_MAP_INV_LUT
    from openpcseg_torch.ops import cuda_lib

    preds = Path(tmp) / "rpv_preds"
    argv = ["--cfg_file", str(ROOT / RPV_ENTRY_CFG), "--log_dir",
            f"{tmp}/rpv_logs", "--extra_tag", "chip_smoke", "--batch_size",
            str(ENTRY_BATCH), "--log_interval", "1"]
    sets = ["--set", "DATA.DATA_PATH", tree]
    cuda_lib.reset_counts()
    t0 = time.perf_counter()
    for epochs in (1, 2):
        if train.main(argv + ["--epochs", str(epochs)] + sets) != 0:
            raise SystemExit(f"RPVNet entry point: train --epochs {epochs} "
                             "failed")
    if infer.main(argv + ["--save_pred", "--save_raw_ids"] + sets
                  + ["DATA.OUTPUT_DIR", str(preds)]) != 0:
        raise SystemExit("RPVNet entry point: infer failed")
    wall = time.perf_counter() - t0
    launches = dict(cuda_lib.LAUNCHES)
    plain_on_cuda = dict(cuda_lib.PLAIN_ON_CUDA)
    logs, steps, evals, ckps = _run_logs(f"{tmp}/rpv_logs")
    legal = set(LEARNING_MAP_INV_LUT.tolist())
    dumped = []
    for f in sorted(preds.glob("sequences/08/predictions/*.label")):
        ids = np.fromfile(f, dtype=np.uint32)
        scan = Path(tree, "08", "velodyne", f.stem + ".bin")
        dumped.append(dict(file=f.name, ids=len(ids),
                           points=scan.stat().st_size // 16,
                           legal=set(np.unique(ids).tolist()) <= legal))
    step_ms = [r["step_time"] * 1e3 for r in steps]
    miou = evals[-1]["val_miou"] if evals else float("nan")
    log(f"[rpv-entry] train CLI on {RPV_ENTRY_CFG}, batch {ENTRY_BATCH}: "
        f"step ms {', '.join(f'{t:.1f}' for t in step_ms)}, val mIoU "
        f"{miou:.2f}; {wall:.1f} s for train, resume and infer; dumps "
        f"{dumped}; launches {launches}")
    report["rpvnet_entry_point"] = dict(
        steps=steps, evals=evals, checkpoints=ckps, dumped=dumped,
        val_miou=miou, wall_s=wall, launches=launches,
        plain_on_cuda=plain_on_cuda)
    faults = []
    if "resumed from epoch 0" not in logs:
        faults.append("the second train call did not resume from epoch 0")
    n_steps = ENTRY_SCANS[0] // ENTRY_BATCH * 2
    if [r["step"] for r in steps] != list(range(1, n_steps + 1)) or not all(
            np.isfinite(r["loss"]) for r in steps):
        faults.append(f"train steps {steps}")
    if ckps != ["0.pt", "1.pt"] or len(evals) != 3:
        faults.append(f"checkpoints {ckps}, {len(evals)} evals (want 0.pt, "
                      "1.pt and 3: one per epoch, one by infer)")
    if any(r["voxel_overflow"] for r in steps) or any(
            r["val_voxel_overflow"] for r in evals):
        faults.append("voxel_overflow > 0 in metrics.jsonl")
    if len(dumped) != ENTRY_SCANS[1] or not all(
            d["ids"] == d["points"] and d["legal"] for d in dumped):
        faults.append(f"the --save_raw_ids dump is wrong: {dumped}")
    missing = [k for k in RPV_NEED if launches[k] == 0]
    if missing or any(plain_on_cuda.values()):
        faults.append(f"kernels never launched {missing}, or a plain version "
                      f"ran on the card {plain_on_cuda}")
    if faults:
        raise SystemExit("RPVNet entry-point phase: " + "; ".join(faults))
    return launches


def rpvnet_phases(report, tmp, tree, cudnn_tf32):
    """RPVNet mk34_cr17_5 on the card, its range convs on cuDNN at torch's
    default precision `cudnn_tf32` (TF32, as the CLIs run them): serving
    (every forward counter of its path on every request), the eval profile
    and idle share, its kernel cases on scan SEED's pyramid and range
    tables, the count of the points whose range tables the card and the
    CPU build apart (where not 0 the references take the CPU's tables),
    the eval reference, training (every counter of its path on every
    step), the training reference over its draws under its own JAX reading
    widened for TF32, and the entry points. Returns the cases, the
    launches of serving and training, and those of the entry phase."""
    from openpcseg_torch.engine.task import SegTask, batch_to_device

    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    task = SegTask(RPV_CFGS, NUM_CLASS, device="cuda",
                   compute_dtype=torch.bfloat16, seed=SEED)
    log(f"[rpv-serve] RPVNet from {RPV_ENTRY_CFG}: "
        f"{sum(p.numel() for p in task.model.parameters())} parameters; "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} for its range "
        f"branch")
    launches = serving_phase(task, report, "rpv-serve", RPV_FWD, "rpvnet_")
    eval_ms = profile_phase(task, report, "rpvnet_")
    idle = 1.0 - eval_ms / report["rpvnet_p50_ms"]
    log(f"[profile] rpvnet_eval_step device idle share {idle:.4f} (device "
        f"{eval_ms:.3f} ms of the {report['rpvnet_p50_ms']:.3f} ms p50)")
    report["rpvnet_eval_idle_share"] = idle
    _, pyr = task.preprocess(batch_to_device(scan_for(RPV_CFGS, SEED),
                                             "cuda"))
    occ = {f"{h}x{w}": int((t.pixel.t_ptr.diff() > 0).sum())
           for (h, w), t in pyr.range.items()}
    log(f"[rpv-kernels] pyramid of scan {SEED}: voxels per level "
        f"{pyr.level_counts.tolist()}, caps {task.caps}; pixels holding a "
        f"voxel per range resolution {occ}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    shapes = (RPV_SUBM, RPV_DOWNS, RPV_UPS, RPV_DEVOX, "rpv ")
    rows = check_cases(kernel_cases(pyr, gen, *shapes)
                       + backward_cases(pyr, gen, *shapes)
                       + rpv_range_cases(pyr, gen), "rpv-kernels")
    report["rpvnet_cases"] = rows
    del task, pyr
    moved, werr = rpv_tables_moved(scan_for(RPV_CFGS, SEED, cap=8192), 8192)
    moved_full, werr_full = rpv_tables_moved(scan_for(RPV_CFGS, SEED),
                                             98304)
    log(f"[rpvnet-reference] points whose range tables the card and the CPU "
        f"build apart: {moved} of the 8192-point scan (largest weight "
        f"difference {werr:.3e}), {moved_full} of scan {SEED} "
        f"({werr_full:.3e})" + ("; the card's reference runs take the "
                                "CPU's tables" if moved else ""))
    report.update(rpvnet_tables_moved=moved, rpvnet_tables_moved_full=(
        moved_full), rpvnet_table_weight_err=max(werr, werr_full))
    reference_phase(report, RPV_CFGS, "rpvnet_reference", moved > 0)
    train = training_phase(report, RPV_TRAIN_CFGS, "rpv-train", RPV_NEED,
                           "rpvnet_")
    launches.update({k: v for k, v in train.items() if k not in RPV_FWD})
    train_reference_phase(report, "RPVNet", moved > 0)
    entry = rpvnet_entry_phase(report, tmp, tree)
    torch.backends.cudnn.allow_tf32 = False
    report["rpvnet_phases_s"] = time.perf_counter() - t0
    log(f"[rpvnet] the RPVNet phases took {report['rpvnet_phases_s']:.1f} s")
    return rows, launches, entry


# == Waymo Open and nuScenes-lidarseg (data/waymo.py, data/nuscenes.py) on
# ray-cast trees in each dataset's layout (data/raycast_waymo.py,
# data/raycast_nuscenes.py). The main path: MinkUNet mk34_cr16 on Waymo,
# the MODEL block of WAYMO_CFG at full width: cs = int(1.6 x PLANES) = 51,
# 51, 102, 204, 409, 409, 204, 153, 153 over a 5-channel stem, so every
# conv takes its kernel's ragged path (Cin or Cout not a multiple of 8)
WAYMO_CFG = "tools/cfgs/voxel/waymo/minkunet_mk34_cr16.yaml"
WAYMO_INFER_CFG = "tools/cfgs/voxel/waymo/minkunet_mk34_cr16_infer.yaml"
WAYMO_MODEL_CFG = dict(MODEL_CFG, IN_FEATURE_DIM=5, cr=1.6)
WAYMO_OPTIM_CFG = dict(OPTIM_CFG, BATCH_SIZE_PER_GPU=8)
WAYMO_CFGS = {
    "MODALITY": "voxel",
    "DATA": {"DATASET": "waymo", "VOXEL_SIZE": 0.1},
    "MODEL": WAYMO_MODEL_CFG,
    "TPU": {"POINT_CAP_PER_SCAN": 196608, "VOXEL_CAP_PER_SCAN": 163840},
}
WAYMO_TRAIN_CFGS = dict(WAYMO_CFGS, OPTIM=WAYMO_OPTIM_CFG)
# its entry phase: train, val and unlabeled-sequence frames of the tree
WAYMO_ENTRY_FRAMES = (16, 8, 8)
# its training reference: the 8192-point Waymo frame of SEED and nine
# feature-perturbed copies (train_ref_draws(WAYMO_CFGS)), weights
# seed_weights(SEED), held to MinkUNet mk34_cr10's rule (its JAX reading:
# train_ref_rule and TRAIN_GROSS), set before the first card run
WAYMO_TRAIN_REF_INPUTS = "c43930a06e795756"
TRAIN_REF_MODELS["Waymo"] = (
    WAYMO_TRAIN_CFGS, WAYMO_TRAIN_REF_INPUTS, JAX_TRAIN_READING, None,
    "waymo_train_reference", "waymo-train-ref")
# == MinkUNet mk34_cr10 with BLOCK Bottleneck (JAX's default block; the
# shipped yaml with MODEL.BLOCK Bottleneck): 4x expanded stages, so the
# down convs run at 128-512, the up convs from 1024 / 1024 / 512 / 384, the
# devoxelizes at 1024 (L4) and 512 (L2) and the classifier over 1920
BN_MODEL_CFG = dict(MODEL_CFG, BLOCK="Bottleneck")
BN_CFGS = dict(CFGS, MODEL=BN_MODEL_CFG)
BN_TRAIN_CFGS = dict(BN_CFGS, OPTIM=OPTIM_CFG)
# its training reference: MinkUNet's ten draws (train_ref_draws) and
# seed_weights(SEED) of the Bottleneck network, held to its own JAX reading
# (tests/test_torch_train_ref.py, taken on the CPU before the first card
# run). On this network bf16 moves a step's gradient far from float32's:
# JAX's whole-gradient cosines read 0.576-0.658 over the draws (sd 0.024),
# and two bf16 runs of one draw lie as far apart as two draws do (the
# port's CPU bf16 run differs from JAX's by up to 0.047 on a draw, 0.114
# in the worst conv cosine). So a draw's row says nothing of that draw,
# and the rule holds the card's draws as a set (TRAIN_REF_MEAN_RULE): the
# mean loss difference within twice JAX's, the mean cosines within
# TRAIN_REF_MARGIN of JAX's means, and each draw above a floor: JAX's
# lowest cosines less that widest gap between the two CPU readings
# (train_ref_bounds). The rule set before the first card run took JAX's
# lowest less TRAIN_REF_MARGIN for the floor; that run's draw 6 read a
# worst conv cosine of 0.3722 against its 0.3756 with every mean within
# its bound, and the floor was widened to the gap the CPU readings had
# already shown. Faults planted in the card's step (PERF.md): two
# offsets of one conv's map swapped in the encoder fail every bound; in
# the decoder they fail the mean worst conv cosine (0.289) and the floor
# on 3 of 10 draws; one offset's dW slice lost passes
BN_TRAIN_REF_INPUTS = "e1bf5e905cb1905f"
JAX_BN_TRAIN_READING = ((3.6620e-04, 0.599219, 0.475355),
                        (1.5855e-03, 0.589851, 0.422960),
                        (4.6116e-04, 0.658432, 0.542352),
                        (1.8487e-03, 0.612656, 0.490897),
                        (2.8508e-03, 0.622843, 0.470062),
                        (1.6177e-03, 0.586903, 0.395583),
                        (4.0283e-04, 0.576134, 0.459751),
                        (1.9827e-03, 0.625336, 0.481777),
                        (8.6591e-05, 0.616092, 0.412381),
                        (2.6004e-03, 0.582552, 0.434505))
PORT_CPU_BN_BF16_READING = ((3.4022e-04, 0.598976, 0.493528),
                            (9.5102e-05, 0.603760, 0.479011),
                            (1.1025e-03, 0.611196, 0.442361),
                            (8.6670e-04, 0.597566, 0.468335),
                            (3.4707e-03, 0.598924, 0.453772),
                            (2.9575e-03, 0.606937, 0.448589),
                            (4.3323e-04, 0.583182, 0.437956),
                            (8.0026e-04, 0.631890, 0.472669),
                            (1.1700e-03, 0.632078, 0.526372),
                            (1.8397e-03, 0.588002, 0.464205))
TRAIN_REF_MEAN_RULE = ("Bottleneck",)
TRAIN_REF_MODELS["Bottleneck"] = (
    BN_TRAIN_CFGS, BN_TRAIN_REF_INPUTS, JAX_BN_TRAIN_READING,
    PORT_CPU_BN_BF16_READING, "bn_train_reference", "bn-train-ref")
# every shipped yaml that no other phase drives, one train and one eval
# step each at full width and batch 1 on a batch of its own view, with
# the --set overrides of the cell and the counters its family must move
# (CENet: none); the last cell is SPVCNN with the classifier on z3 alone
SPV_NEED = MINK_COUNTERS + SPV_COUNTERS
YAML_CELLS = (
    ("tools/cfgs/voxel/waymo/minkunet_mk18_cr10.yaml", MINK_COUNTERS, ()),
    ("tools/cfgs/voxel/waymo/minkunet_mk34_cr10.yaml", MINK_COUNTERS, ()),
    ("tools/cfgs/voxel/waymo/minkunet_mk34_cr16_xyz.yaml", MINK_COUNTERS,
     ()),
    ("tools/cfgs/voxel/waymo/cylinder_cy480_cr10.yaml", CYL_NEED, ()),
    ("tools/cfgs/fusion/waymo/spvcnn_mk18_cr10.yaml", SPV_NEED, ()),
    ("tools/cfgs/fusion/waymo/spvcnn_mk34_cr16.yaml", SPV_NEED, ()),
    ("tools/cfgs/fusion/waymo/rpvnet_mk18_cr10.yaml", RPV_NEED, ()),
    ("tools/cfgs/voxel/nuscenes/minkunet_mk34_cr10.yaml", MINK_COUNTERS,
     ()),
    ("tools/cfgs/voxel/nuscenes/cylinder_cy480_cr10.yaml", CYL_NEED, ()),
    ("tools/cfgs/fusion/nuscenes/spvcnn_mk34_cr10.yaml", SPV_NEED, ()),
    ("tools/cfgs/range/nuscenes/cenet_32x1088.yaml", (), ()),
    ("tools/cfgs/voxel/semantic_kitti/minkunet_mk18_cr10.yaml",
     MINK_COUNTERS, ()),
    ("tools/cfgs/voxel/semantic_kitti/minkunet_mk18_cr5.yaml",
     MINK_COUNTERS, ()),
    ("tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr16.yaml",
     MINK_COUNTERS, ()),
    ("tools/cfgs/voxel/semantic_kitti/cylinder_cy480_cr5.yaml", CYL_NEED,
     ()),
    ("tools/cfgs/fusion/semantic_kitti/spvcnn_mk18_cr10.yaml", SPV_NEED, ()),
    ("tools/cfgs/fusion/semantic_kitti/spvcnn_mk18_cr5.yaml", SPV_NEED, ()),
    ("tools/cfgs/fusion/semantic_kitti/spvcnn_mk34_cr16.yaml", SPV_NEED, ()),
    ("tools/cfgs/fusion/semantic_kitti/rpvnet_mk18_cr10.yaml", RPV_NEED, ()),
    (SPV_ENTRY_CFG, SPV_NEED, ("MODEL.MULTI_SCALE", "none")),
)
NUSC_CENET_CFG = "tools/cfgs/range/nuscenes/cenet_32x1088.yaml"
NUSC_SWEEPS = (2, 1)     # train and val sweeps of the nuScenes tree


def share_lines(rows, aligned, tag="waymo", label="Waymo cr1.6"):
    """Per kernel row (and backward pass), the summed bound of the `tag`
    cases (Waymo's, or the Bottleneck's) over their summed device time,
    beside the same of MinkUNet mk34_cr10's cases of that kernel
    (`aligned`): what those widths cost against the mk34 widths. Returns
    the table."""
    def part(r):
        for p in ("dfeats", "dW"):
            if r["shape"].endswith(" " + p):
                return p
        return "whole"

    def total(rs):
        dev = sum(r["device_ms"] for r in rs)
        bnd = sum(r["bound_ms"] for r in rs)
        return dict(cases=len(rs), device_ms=dev, bound_ms=bnd,
                    share=bnd / max(dev, 1e-9))
    table = []
    for name in KERNELS:
        for pt in ("whole", "dfeats", "dW"):
            w = [r for r in rows if r["kernel"] == name and part(r) == pt
                 and "device_ms" in r]
            a = [r for r in aligned if r["kernel"] == name and part(r) == pt]
            if not w or not a:
                continue
            tw, ta = total(w), total(a)
            table.append({"kernel": name, "part": pt, tag: tw, "mk34": ta})
            log(f"[{tag}-kernels] {name} {pt}: {label} {tw['cases']} "
                f"cases, device {tw['device_ms']:.4f} ms, bound "
                f"{tw['bound_ms']:.4f} ms ({tw['share']:.1%}); mk34_cr10 "
                f"{ta['cases']} cases, device {ta['device_ms']:.4f} ms, "
                f"bound {ta['bound_ms']:.4f} ms ({ta['share']:.1%})")
    return table


def waymo_kernel_phase(report, aligned):
    """Every kernel case at Waymo mk34_cr16's shapes (mink_shapes of its
    MODEL block, the _xyz yaml's 3-channel stem, and K7 / K8 at the last
    up stage's width over level 2's table as well) on the pyramid of
    Waymo frame SEED, forward and backward, each against its plain
    version, twice, bit for bit, timed (the dfeats and dW passes alone
    untimed); then each kernel's share of its bound beside mk34_cr10's
    (`aligned`)."""
    from openpcseg_torch.engine.task import SegTask, batch_to_device

    task = SegTask(WAYMO_CFGS, classes(WAYMO_CFGS), device="cuda",
                   compute_dtype=torch.bfloat16, seed=SEED)
    _, pyr = task.preprocess(batch_to_device(scan_for(WAYMO_CFGS, SEED),
                                             "cuda"))
    subm, downs, ups, devox = mink_shapes(WAYMO_MODEL_CFG)
    # the _xyz yaml's 3-channel stem; K7 / K8 also at the head's width
    subm = subm + [(0, 3, subm[0][2])]
    devox = devox + [(2, subm[-2][2])]
    log(f"[waymo-kernels] pyramid of Waymo frame {SEED}: "
        f"{int(pyr.points.valid.sum())} points, voxels per level "
        f"{pyr.level_counts.tolist()}, caps {task.caps}; shapes {subm}, "
        f"{downs}, {ups}, {devox}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    shapes = (subm, downs, ups, devox, "waymo ")
    bwd = backward_cases(pyr, gen, *shapes)
    alone = [c["label"].endswith((" dfeats", " dW")) for c in bwd]
    passes = [c for c, a in zip(bwd, alone) if a]
    rows = check_cases(kernel_cases(pyr, gen, *shapes)
                       + [c for c, a in zip(bwd, alone) if not a],
                       "waymo-kernels")
    # the passes alone are checked untimed (the step profiles time them),
    # to hold the run inside its time
    rows += check_cases(passes, "waymo-passes", timed=False)
    report["waymo_cases"] = rows
    report["waymo_shares"] = share_lines(rows, aligned)
    return rows


def write_waymo_tree(root, workers):
    """The Waymo entry phase's ray-cast tree under `root`
    (WAYMO_ENTRY_FRAMES: train and val frames, and an unlabeled sequence
    under `root`/sequence)."""
    from openpcseg_torch.data.raycast_waymo import write_sequence, write_tree

    n_train, n_val, n_seq = WAYMO_ENTRY_FRAMES
    write_tree(root, n_train, n_val, workers=workers)
    write_sequence(Path(root) / "sequence", n_seq, workers=workers)


def waymo_entry_phase(report, tmp):
    """The user's entry points on Waymo mk34_cr16 at the yaml's batch 8: a
    ray-cast Waymo tree (WAYMO_ENTRY_FRAMES, written by the reference
    process, CpuRefs.waymo_tree), the train CLI for an epoch and
    a resumed second, then the infer CLI on the _infer yaml streaming the
    unlabeled sequence from the last checkpoint into DATA.OUTPUT_DIR (one
    .npy a frame, one id a point); every MinkUNet counter over the phase.
    Returns the launches and the tree's root."""
    from openpcseg_torch.cli import infer, train
    from openpcseg_torch.ops import cuda_lib

    free_card()
    n_train, _, n_seq = WAYMO_ENTRY_FRAMES
    root = CPU_REFS.waymo_tree()
    seq = str(root / "sequence")
    out = Path(tmp) / "waymo_stream"
    argv = ["--cfg_file", str(ROOT / WAYMO_CFG), "--log_dir",
            f"{tmp}/waymo_logs", "--extra_tag", "chip_smoke",
            "--log_interval", "1"]
    cuda_lib.reset_counts()
    t0 = time.perf_counter()
    for epochs in (1, 2):
        if train.main(argv + ["--epochs", str(epochs), "--set",
                              "DATA.DATA_PATH", str(root)]) != 0:
            raise SystemExit(f"Waymo entry point: train --epochs {epochs} "
                             "failed")
    logs, steps, evals, ckps = _run_logs(f"{tmp}/waymo_logs")
    ckp = next(Path(tmp, "waymo_logs").glob("**/ckp/1.pt"))
    if infer.main(["--cfg_file", str(ROOT / WAYMO_INFER_CFG), "--log_dir",
                   f"{tmp}/waymo_infer_logs", "--extra_tag", "chip_smoke",
                   "--ckp", str(ckp), "--save_pred", "--set",
                   "DATA.DATA_PATH", seq, "DATA.OUTPUT_DIR", str(out)]) != 0:
        raise SystemExit("Waymo entry point: streaming infer failed")
    wall = time.perf_counter() - t0
    launches = dict(cuda_lib.LAUNCHES)
    plain_on_cuda = dict(cuda_lib.PLAIN_ON_CUDA)
    _, _, infer_evals, _ = _run_logs(f"{tmp}/waymo_infer_logs")
    dumped = []
    for i, f in enumerate(sorted(out.glob("*.npy"))):
        ids = np.load(f)
        frame = Path(seq, "first", f"{i:06d}.npy")
        points = len(np.load(frame)) + len(np.load(
            Path(seq, "second", frame.name)))
        dumped.append(dict(file=f.name, ids=len(ids), points=points,
                           legal=bool(ids.min() >= 0 and ids.max() < 23)))
    step_ms = [r["step_time"] * 1e3 for r in steps]
    med = statistics.median(step_ms)
    mem = max(r.get("max_memory_allocated", 0) for r in steps)
    log(f"[waymo-entry] train CLI on {WAYMO_CFG}, batch "
        f"{WAYMO_OPTIM_CFG['BATCH_SIZE_PER_GPU']}: step ms "
        f"{', '.join(f'{t:.1f}' for t in step_ms)} (median {med:.1f}), "
        f"{WAYMO_OPTIM_CFG['BATCH_SIZE_PER_GPU'] * 1e3 / med:.2f} scans/s, "
        f"max_memory_allocated {mem / 2**30:.2f} GiB, data_time "
        f"{', '.join(f'{r["data_time"]:.3f}' for r in steps)} s; val mIoU "
        f"{evals[-1]['val_miou'] if evals else float('nan'):.2f}; "
        f"{wall:.1f} s for train, resume and the stream; dumps {dumped}; "
        f"launches {launches}")
    report["waymo_entry_point"] = dict(
        steps=steps, evals=evals, infer_evals=infer_evals, checkpoints=ckps,
        dumped=dumped, step_ms_median=med,
        scans_per_s=WAYMO_OPTIM_CFG["BATCH_SIZE_PER_GPU"] * 1e3 / med,
        max_memory_allocated=mem, wall_s=wall, launches=launches,
        plain_on_cuda=plain_on_cuda)
    faults = []
    if "resumed from epoch 0" not in logs:
        faults.append("the second train call did not resume from epoch 0")
    n_steps = n_train // WAYMO_OPTIM_CFG["BATCH_SIZE_PER_GPU"] * 2
    if [r["step"] for r in steps] != list(range(1, n_steps + 1)) or not all(
            np.isfinite(r["loss"]) for r in steps):
        faults.append(f"train steps {steps}")
    if ckps != ["0.pt", "1.pt"] or len(evals) != 2 or len(infer_evals) != 1:
        faults.append(f"checkpoints {ckps}, {len(evals)} train evals, "
                      f"{len(infer_evals)} infer evals (want 0.pt, 1.pt, 2 "
                      "and 1)")
    if any(r["voxel_overflow"] for r in steps) or any(
            r["val_voxel_overflow"] for r in evals + infer_evals):
        faults.append("voxel_overflow > 0 in metrics.jsonl")
    if len(dumped) != n_seq or not all(
            d["ids"] == d["points"] and d["legal"] for d in dumped):
        faults.append(f"the stream's dump is wrong: {dumped}")
    missing = [k for k in MINK_COUNTERS if launches[k] == 0]
    if missing or any(plain_on_cuda.values()):
        faults.append(f"kernels never launched {missing}, or a plain version "
                      f"ran on the card {plain_on_cuda}")
    if faults:
        raise SystemExit("Waymo entry-point phase: " + "; ".join(faults))
    return launches, root


def waymo_phases(report, tmp, aligned):
    """Waymo MinkUNet mk34_cr16 on the card: its kernel cases, serving
    (every forward counter on every request), the eval reference, the eval
    profile and idle share, training (every counter on every step) and its
    profile, the training reference over its ten draws under MinkUNet
    mk34_cr10's rule, and the entry points at batch 8. Returns the cases,
    the launches of serving and training, those of the entry phase, and
    the tree's root."""
    from openpcseg_torch.engine.task import SegTask

    t0 = time.perf_counter()

    def done(name):
        report.setdefault("waymo_phase_s", {})[name] = (
            time.perf_counter() - t0)
        log(f"[time] waymo {name} done at "
            f"{report['waymo_phase_s'][name]:.1f} s")
    cast_scans(WAYMO_CFGS, range(SEED, SEED + REQUESTS + 2))
    rows = waymo_kernel_phase(report, aligned)
    done("kernels")
    task = SegTask(WAYMO_CFGS, classes(WAYMO_CFGS), device="cuda",
                   compute_dtype=torch.bfloat16, seed=SEED)
    log(f"[waymo-serve] MinkUNet mk34_cr16 from {WAYMO_CFG}: "
        f"{sum(p.numel() for p in task.model.parameters())} parameters, "
        f"caps {task.caps}")
    launches = serving_phase(task, report, "waymo-serve", FWD_COUNTERS,
                             "waymo_")
    eval_ms = profile_phase(task, report, "waymo_")
    idle = 1.0 - eval_ms / report["waymo_p50_ms"]
    log(f"[profile] waymo_eval_step device idle share {idle:.4f} (device "
        f"{eval_ms:.3f} ms of the {report['waymo_p50_ms']:.3f} ms p50)")
    report["waymo_eval_idle_share"] = idle
    del task
    done("serving")
    reference_phase(report, WAYMO_CFGS, "waymo_reference")
    train = training_phase(report, WAYMO_TRAIN_CFGS, "waymo-train",
                           MINK_COUNTERS, "waymo_")
    launches.update({k: v for k, v in train.items()
                     if k not in FWD_COUNTERS})
    done("training")
    train_reference_phase(report, "Waymo")
    done("train-reference")
    entry, root = waymo_entry_phase(report, tmp)
    report["waymo_phases_s"] = time.perf_counter() - t0
    log(f"[waymo] the Waymo mk34_cr16 phases took "
        f"{report['waymo_phases_s']:.1f} s")
    return rows, launches, entry, root


def yaml_cell(path, root, need, cudnn_tf32, sets=()):
    """One train step and one eval step of the yaml at `path` as it stands
    (with the --set overrides `sets`; full width, batch 1) on the first
    batch of its own view over the tree at `root` (train and val loaders):
    voxel_overflow 0 on both, finite loss, hist summing to the valid
    points, and the counters `need` launched (none at all where `need` is
    empty). Returns its record."""
    from openpcseg_torch.config import (CfgDict, cfg_from_list,
                                        cfg_from_yaml_file)
    from openpcseg_torch.data import build_dataloader
    from openpcseg_torch.engine.task import SegTask, batch_to_device
    from openpcseg_torch.ops import cuda_lib

    cfgs = CfgDict()
    cfg_from_yaml_file(str(ROOT / path), cfgs)
    cfg_from_list(list(sets), cfgs)
    cfgs.DATA.DATA_PATH = str(root)
    modality = cfgs.get("MODALITY", "voxel")
    batches = {}
    for training in (True, False):
        _, loader = build_dataloader(
            cfgs.DATA, modality, 1, training=training,
            point_cap=cfgs.TPU.POINT_CAP_PER_SCAN, num_workers=1, seed=SEED)
        batches[training] = batch_to_device(
            {k: v for k, v in next(iter(loader)).items() if k != "name"},
            "cuda")
    tf32 = modality == "range" or cfgs.MODEL.NAME == "RPVNet"
    torch.backends.cudnn.allow_tf32 = cudnn_tf32 if tf32 else False
    task = SegTask(dict(cfgs), classes(cfgs), device="cuda",
                   compute_dtype=torch.bfloat16, seed=SEED,
                   iters_per_epoch=ITERS_PER_EPOCH)
    cuda_lib.reset_counts()
    t0 = time.perf_counter()
    m = task.train_step(batches[True])
    out = task.eval_step(batches[False])
    loss, hist = float(m["loss"]), out["hist"].cpu()
    secs = time.perf_counter() - t0
    torch.backends.cudnn.allow_tf32 = False
    launches = dict(cuda_lib.LAUNCHES)
    plain_on_cuda = dict(cuda_lib.PLAIN_ON_CUDA)
    valid = batches[False]["p_valid" if modality == "range" else "valid"]
    rec = dict(yaml=path, sets=list(sets), dataset=cfgs.DATA.DATASET,
               model=cfgs.MODEL.NAME,
               parameters=sum(p.numel() for p in task.model.parameters()),
               loss=loss, voxel_overflow=int(m["voxel_overflow"]),
               eval_voxel_overflow=int(out["voxel_overflow"]),
               hist_sum=int(hist.sum()), valid_points=int(valid.sum()),
               seconds=secs, launches=launches)
    log(f"[yamls] {path} {' '.join(sets)}: {rec['parameters']} parameters, "
        f"loss {loss:.4f}, "
        f"voxel_overflow {rec['voxel_overflow']} / "
        f"{rec['eval_voxel_overflow']}, hist {rec['hist_sum']} of "
        f"{rec['valid_points']} points, {secs:.1f} s; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    missing = [k for k in need if launches[k] == 0]
    moved = [k for k, v in launches.items() if v] if not need else []
    if (not np.isfinite(loss) or rec["voxel_overflow"]
            or rec["eval_voxel_overflow"]
            or rec["hist_sum"] != rec["valid_points"] or missing or moved
            or any(plain_on_cuda.values())):
        raise SystemExit(f"yaml cell {path} {sets}: {rec}; never launched "
                         f"{missing}, launched {moved}, plain versions on "
                         f"the card {plain_on_cuda}")
    return rec


def nuscenes_dump_phase(report, tmp, root):
    """CENet 32 x 1088 through the CLIs on the nuScenes tree at batch 1
    (an epoch), then the infer CLI with --save_pred --save_raw_ids: one
    lidarseg/val/<sample_data_token>_lidarseg.bin per val sweep, uint8 raw
    categories, one per pixel of its image, each a raw id of a class."""
    from openpcseg_torch.cli import infer, train
    from openpcseg_torch.data.nuscenes import NuscenesDataset
    from openpcseg_torch.data.nuscenes_meta import LEARNING_MAP_INV
    from openpcseg_torch.config import CfgDict

    out = Path(tmp) / "nusc_preds"
    argv = ["--cfg_file", str(ROOT / NUSC_CENET_CFG), "--log_dir",
            f"{tmp}/nusc_logs", "--extra_tag", "chip_smoke", "--batch_size",
            "1", "--log_interval", "1"]
    sets = ["--set", "DATA.DATA_PATH", str(root)]
    if train.main(argv + ["--epochs", "1"] + sets) != 0 or infer.main(
            argv + ["--save_pred", "--save_raw_ids"] + sets
            + ["DATA.OUTPUT_DIR", str(out)]) != 0:
        raise SystemExit("nuScenes CENet CLIs failed")
    tokens = {r["token"] for r in NuscenesDataset(CfgDict(
        {"DATASET": "nuscenes", "DATA_PATH": str(root)}),
        training=False).annos}
    legal = set(LEARNING_MAP_INV.tolist())
    files = sorted(out.glob("lidarseg/val/*_lidarseg.bin"))
    dumped = [dict(file=f.name, ids=f.stat().st_size,
                   legal=set(np.unique(np.fromfile(f, np.uint8)).tolist())
                   <= legal) for f in files]
    log(f"[nusc-dump] CENet submission dump: {dumped}")
    report["nuscenes_dump"] = dumped
    if ({f.name[:-len("_lidarseg.bin")] for f in files} != tokens
            or not all(d["ids"] == 32 * 1088 and d["legal"]
                       for d in dumped)):
        raise SystemExit(f"nuScenes submission dump is wrong: {dumped}, "
                         f"val tokens {sorted(tokens)}")


def yaml_phases(report, tmp, waymo_root, kitti_root, cudnn_tf32):
    """Every yaml of YAML_CELLS, one train and one eval step each
    (yaml_cell), on the Waymo tree, a ray-cast nuScenes tree and the entry
    SemanticKITTI tree; then nuScenes CENet's submission dump. Returns the
    launches summed over the cells."""
    from openpcseg_torch.data.raycast_nuscenes import write_tree

    t0 = time.perf_counter()
    nusc = write_tree(Path(tmp) / "nuscenes", *NUSC_SWEEPS)
    roots = {"waymo": waymo_root, "nuscenes": nusc,
             "semantic_kitti": kitti_root}
    cells, total = [], {}
    for path, need, sets in YAML_CELLS:
        rec = yaml_cell(path, roots[Path(path).parent.name], need,
                        cudnn_tf32, sets)
        cells.append(rec)
        for k, v in rec["launches"].items():
            total[k] = total.get(k, 0) + v
    nuscenes_dump_phase(report, tmp, nusc)
    report["yaml_cells"] = cells
    report["yaml_phases_s"] = time.perf_counter() - t0
    log(f"[yamls] {len(cells)} cells, one train and one eval step each, "
        f"and the nuScenes dump: {report['yaml_phases_s']:.1f} s")
    return total


# == the range-view models: each yaml of tools/cfgs/range/semantic_kitti/
# as it stands (MODEL and OPTIM: AdamW + onecycle), full width, the 64 x
# 2048 image, float32 as in JAX. Their dense convs run on cuDNN at
# PyTorch's default precision, TF32 (cudnn.allow_tf32 as torch sets it,
# which the CLIs and golden runs keep); no CUDA kernel of the port lies on
# their path, and the phases check that none launches.
RANGE_MODELS = ("CENet", "FIDNet", "RangeNet", "SalsaNext")
RANGE_CFG = "tools/cfgs/range/semantic_kitti/{}_64x2048.yaml"
RANGE_H, RANGE_W = 64, 2048
RANGE_TRAIN_STEPS = 10
# eval logits of the same numpy weights (seed_range_weights) on one scan,
# the card (TF32 convs) against the CPU (float32): max|card - cpu| <=
# RANGE_REF_TOL * max|cpu|, and at least RANGE_REF_AGREE of the pixels
# with the same argmax. Set before the first card run from a CPU emulation
# of TF32's operand rounding (each conv's input and kernel rounded to 10
# mantissa bits) at this scan and these weights, which read 0.87-1.20e-3
# and agreements 0.9988-0.9995 over the four models: about 8x that error,
# and the disagreement that error would bring (PERF.md, PR 10)
RANGE_REF_TOL = 1e-2
RANGE_REF_AGREE = 0.985
# the ray-cast scans put the sensor at z = SENSOR_Z (data/raycast.py); the
# reference runs on the scan as the golden runs see it and again moved
# into the sensor frame (z - SENSOR_Z), where range_project's image is no
# longer degenerate
SENSOR_Z = 1.8
# one AdamW + onecycle train step per model, the card (TF32 convs) against
# the CPU (float32), from seed_range_weights(SEED) on scan SEED, dropout
# off on both: (|loss_card - loss_cpu| / |loss_cpu|, whole-gradient
# cosine, the worst cosine over the gradient tensors held, and |p_card -
# p_cpu| / |p_cpu - p_0| of the parameters after the step). A tensor is
# held where its float32 gradient's norm is at least RANGE_GRAD_FLOOR of
# the largest tensor's (a bias that a BN cancels has a gradient of
# rounding noise, whose cosine says nothing). Each bound is twice the CPU
# emulation of TF32 (python -m openpcseg_torch.cli.range_tf32 --train: the
# float32 step with every conv's operands, forward and both backward
# products, rounded to TF32, against the float32 step): the loss rel and
# the update rel times 2, the cosines 1 - 2 (1 - emulated). The emulation
# ran on the card machine's CPU before the first card run of this check,
# on five draws (the scan, then four copies whose continuous channels are
# scaled by 1 + 1e-3 N(0, 1)), one draw of TF32's rounding each: the loss
# rel of one draw ranges over an order of magnitude (CENet 1.4e-6 to
# 2.5e-5), so RANGE_TF32_TRAIN keeps the worst of the five per field.
RANGE_GRAD_FLOOR = 1e-3
RANGE_TF32_TRAIN = {"CENet": (2.5134e-05, 0.99101122, 0.97696833, 0.28984),
                    "FIDNet": (1.5317e-04, 0.98716202, 0.96925428, 0.37936),
                    "RangeNet": (4.7350e-05, 0.99991492, 0.95764229,
                                 0.29245),
                    "SalsaNext": (2.1611e-04, 0.98120573, 0.92807881,
                                  0.50188)}


def range_train_bounds(name):
    """(loss rel, whole cosine, worst held cosine, update rel) bounds of
    `name`'s card training reference: twice its TF32 emulation."""
    rel, cos_all, cos_worst, upd = RANGE_TF32_TRAIN[name]
    return 2 * rel, 1 - 2 * (1 - cos_all), 1 - 2 * (1 - cos_worst), 2 * upd
RANGE_ENTRY = "CENet"    # aux heads and the dice loss: the most code
# profiler kernel names of the dense convs: cuDNN's and CUTLASS's kernels,
# their implicit GEMMs and cuDNN's NCHW <-> NHWC layout transposes; every
# other kernel of a train step is the elementwise tail (BN, activations,
# resizes, pools, losses, the optimizer)
CONV_KERNEL_WORDS = ("cudnn", "xmma", "conv", "gemm", "cutlass", "wgrad",
                     "dgrad", "fprop", "implicit", "winograd", "fft")


def range_cfgs(name):
    """The CfgDict of `name`'s shipped range yaml."""
    from openpcseg_torch.config import CfgDict, cfg_from_yaml_file

    cfgs = CfgDict()
    cfg_from_yaml_file(str(ROOT / RANGE_CFG.format(name.lower())), cfgs)
    return cfgs


def range_request(seed, n_points=N_POINTS, z_shift=0.0):
    """The ray-cast scan of `seed` as the range eval view gives it: its
    valid points (moved down by `z_shift`) projected to the 64 x 2048
    image (range_project + pack_scan_tensor) and the points themselves
    (p_label, p_px, p_py, p_range over n_points, p_valid): a numpy batch
    of 1."""
    from openpcseg_torch.data.range_view import pack_scan_tensor, range_project

    b = scan_for(CFGS, seed, cap=n_points)
    v = b["valid"][0]
    n = int(v.sum())
    xyz = b["xyz"][0][v] - np.float32([0.0, 0.0, z_shift])
    s = range_project(xyz, b["feats"][0][v, 3], b["labels"][0][v], RANGE_H,
                      RANGE_W)
    scan, label, mask = pack_scan_tensor(s)
    pts = {"p_label": np.full(n_points, -1, np.int32),
           "p_px": np.zeros(n_points, np.int32),
           "p_py": np.zeros(n_points, np.int32),
           "p_range": np.zeros(n_points, np.float32),
           "p_valid": np.zeros(n_points, bool)}
    pts["p_label"][:n] = b["labels"][0][v]
    pts["p_px"][:n] = s["proj_x"]
    pts["p_py"][:n] = s["proj_y"]
    pts["p_range"][:n] = s["unproj_range"]
    pts["p_valid"][:n] = True
    out = {"scan": scan[None], "label": label[None], "mask": mask[None]}
    out.update({k: a[None] for k, a in pts.items()})
    return out


def seed_range_weights(model, seed):
    """Overwrite every conv and transposed-conv kernel of a range model (in
    module order) with draws of numpy's generator seeded with `seed`, at
    the scale of its own initializer (seed_weights' truncated normal over
    fan in): the same weights on every machine. Biases and BN keep their
    initial values."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                cin = (m.in_channels if isinstance(m, torch.nn.Conv2d)
                       else m.weight.shape[0])
                fan_in = cin * m.kernel_size[0] * m.kernel_size[1]
                z = rng.standard_normal(m.weight.shape)
                bad = np.abs(z) > 2
                while bad.any():
                    z[bad] = rng.standard_normal(int(bad.sum()))
                    bad = np.abs(z) > 2
                m.weight.copy_(torch.from_numpy(
                    z * (1.0 / fan_in) ** 0.5 / 0.87962566103423978))


def conv_share(rows):
    """(device ms of the dense-conv kernels, of the rest) of a profile's
    rows (kernel, launches, ms)."""
    conv = sum(ms for k, _, ms in rows
               if any(w in k.lower() for w in CONV_KERNEL_WORDS))
    return conv, sum(ms for _, _, ms in rows) - conv


def no_port_kernels(tag):
    """Fail where a kernel of the port launched, or a plain version ran on
    a CUDA tensor, since the counters were last reset: the range path has
    none."""
    from openpcseg_torch.ops import cuda_lib

    launched = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    plain = {k: v for k, v in cuda_lib.PLAIN_ON_CUDA.items() if v}
    if launched or plain:
        raise SystemExit(f"{tag}: the range path launched kernels of the "
                         f"port {launched} or ran their plain versions on "
                         f"the card {plain}")


def range_serving(task, name, report, key):
    """REQUESTS + 1 eval and predict requests on scans SEED + 1.. (the
    first a warm-up), each re-projected to its points by the KNN: hist
    sums to the valid points, predictions [1, 64, 2048] in range; the p50,
    one profiled request's device ms and the idle share."""
    from openpcseg_torch.engine.task import batch_to_device

    scans = [range_request(SEED + 1 + i) for i in range(REQUESTS + 1)]
    lat = []
    for i, b in enumerate(scans):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = task.eval_step(batch_to_device(b, "cuda"))["hist"].cpu()
        ms = (time.perf_counter() - t0) * 1e3
        pred = task.predict_step(batch_to_device(b, "cuda")).cpu()
        n_valid = int(b["p_valid"].sum())
        log(f"[{key}serve] request {i}{' (warm-up)' if i == 0 else ''}: "
            f"{n_valid} points, {int(b['mask'].sum())} pixels, hist sum "
            f"{int(hist.sum())} == valid points "
            f"{int(hist.sum()) == n_valid}, eval_step {ms:.2f} ms, pred "
            f"{tuple(pred.shape)}")
        if int(hist.sum()) != n_valid:
            raise SystemExit(f"{name} serving: hist/point-count mismatch")
        if tuple(pred.shape) != (1, RANGE_H, RANGE_W) or int(
                pred.min()) < 0 or int(pred.max()) >= NUM_CLASS:
            raise SystemExit(f"{name} serving: bad predictions "
                             f"{tuple(pred.shape)}")
        if i > 0:
            lat.append(ms)
    p50 = statistics.median(lat)
    b = batch_to_device(scans[1], "cuda")
    dev = profile_window(f"{key}eval_step", lambda: task.eval_step(b),
                         report)
    idle = 1.0 - dev / p50
    log(f"[{key}serve] p50 eval_step latency per scan {p50:.3f} ms over "
        f"{len(lat)} requests (min {min(lat):.3f}, max {max(lat):.3f}); "
        f"device {dev:.3f} ms, idle share {idle:.4f}")
    report.update({f"{key}p50_ms": p50, f"{key}latencies_ms": lat,
                   f"{key}eval_device_ms": dev, f"{key}eval_idle_share": idle})


def range_reference(name, cfgs, report, key):
    """seed_range_weights(SEED) on scan SEED, as ray-cast and moved into
    the sensor frame: the card's eval logits against the CPU's float32
    ones, under RANGE_REF_TOL and RANGE_REF_AGREE, with the pixels each
    image holds."""
    from openpcseg_torch.engine.task import SegTask, batch_to_device

    nets = {}
    for dev in ("cuda", "cpu"):
        nets[dev] = SegTask(cfgs, NUM_CLASS, device=dev, seed=SEED)
        seed_range_weights(nets[dev].model, SEED)
    misses = []
    for case_key, z in (("reference", 0.0),
                        ("reference_sensor_frame", SENSOR_Z)):
        b = range_request(SEED, z_shift=z)
        logits, secs = {}, {}
        for dev, t in nets.items():
            t0 = time.perf_counter()
            logits[dev] = t.range_logits(batch_to_device(b, dev)).cpu()
            secs[dev] = time.perf_counter() - t0
        g, r = logits["cuda"], logits["cpu"]
        err = float((g - r).abs().max() / r.abs().max())
        agree = float((g.argmax(1) == r.argmax(1)).float().mean())
        finite = bool(torch.isfinite(g).all())
        pixels = int(b["mask"].sum())
        log(f"[{key}{case_key}] z - {z}: {pixels} of {RANGE_H * RANGE_W} "
            f"pixels hold a point; card (TF32 convs) vs CPU float32 eval "
            f"logits {tuple(g.shape)}: finite {finite}, max|diff|/max|ref| "
            f"{err:.3e} (tolerance {RANGE_REF_TOL}), argmax agreement "
            f"{agree:.5f} (at least {RANGE_REF_AGREE}); CPU "
            f"{secs['cpu']:.1f} s")
        report[f"{key}{case_key}"] = dict(rel_max_err=err, pixels=pixels,
                                          argmax_agree=agree,
                                          cpu_s=secs["cpu"])
        if not finite or err > RANGE_REF_TOL or agree < RANGE_REF_AGREE:
            misses.append(case_key)
    if misses:
        raise SystemExit(f"{name} reference: the card's logits disagree "
                         f"with the CPU float32 reference: {misses}")


def range_step(cfgs, batch, dev):
    """One train step of seed_range_weights(SEED) on `dev`, dropout off:
    (loss, {name: float64 gradient}, {name: float64 parameter before},
    {name: float64 parameter after})."""
    from openpcseg_torch.engine.task import SegTask, batch_to_device

    t = SegTask(cfgs, NUM_CLASS, device=dev, seed=SEED,
                iters_per_epoch=ITERS_PER_EPOCH)
    seed_range_weights(t.model, SEED)
    no_dropout(t.model)

    def named(attr):
        return {n: getattr(p, attr).detach().double().cpu().reshape(-1)
                for n, p in t.model.named_parameters()}
    before = named("data")
    loss = float(t.train_step(batch_to_device(batch, dev))["loss"])
    return loss, named("grad"), before, named("data")


def range_step_reading(run, ref):
    """(loss rel, whole-gradient cosine, worst cosine over the held
    tensors, update rel, the worst tensor) of a step against the float32
    reference step `ref`, each a range_step result."""
    def cos(a, b):
        return float(a @ b / (a.norm() * b.norm()).clamp(min=1e-300))
    loss, g, _, after = run
    rloss, rg, before, rafter = ref
    top = max(float(v.norm()) for v in rg.values())
    held = {n: cos(g[n], rg[n]) for n in rg
            if float(rg[n].norm()) >= RANGE_GRAD_FLOOR * top}
    worst = min(held, key=held.get)
    flat = (torch.cat(list(after.values())), torch.cat(list(rafter.values())),
            torch.cat(list(before.values())))
    return (abs(loss - rloss) / abs(rloss),
            cos(torch.cat([g[n] for n in rg]), torch.cat(list(rg.values()))),
            held[worst],
            float((flat[0] - flat[1]).norm() / (flat[1] - flat[2]).norm()),
            worst)


def range_train_batch():
    """The range training reference's batch: scan SEED's range image."""
    req = range_request(SEED)
    return {k: req[k] for k in ("scan", "label", "mask")}


def range_cpu_step(name):
    """The reference process's CPU float32 range step of `name`'s yaml
    (range_step), its float64 tensors stored in float32 (they were
    float32, so nothing is lost)."""
    t0 = time.perf_counter()
    loss, *trees = range_step(range_cfgs(name), range_train_batch(), "cpu")
    return dict(loss=loss, trees=[{n: t.float() for n, t in tree.items()}
                                  for tree in trees],
                seconds=time.perf_counter() - t0)


def range_train_reference(name, cfgs, report, key):
    """One AdamW + onecycle step of seed_range_weights(SEED) on scan SEED,
    the card (TF32 convs) against the CPU (float32; the reference
    process's, CPU_REFS), dropout off on both, held to
    range_train_bounds(name)."""
    batch = range_train_batch()
    t0 = time.perf_counter()
    card = range_step(cfgs, batch, "cuda")
    t1 = time.perf_counter()
    got_cpu = CPU_REFS.get(f"range_{name}", 0)
    cpu = (got_cpu["loss"], *({n: t.double() for n, t in tree.items()}
                              for tree in got_cpu["trees"]))
    t2 = time.perf_counter()
    got = range_step_reading(card, cpu)
    bounds = range_train_bounds(name)
    names = ("loss rel", "whole-gradient cosine", "worst tensor cosine",
             "update rel")
    misses = [f"{n} {v:.4e} beyond {b:.4e}" for n, v, b, up in
              zip(names, got, bounds, (True, False, False, True))
              if not np.isfinite(v) or (v > b if up else v < b)]
    log(f"[{key}train-ref] card (TF32) vs CPU float32 AdamW step: loss "
        f"{card[0]:.6f} vs {cpu[0]:.6f} (rel {got[0]:.4e}, bound "
        f"{bounds[0]:.4e}); whole-gradient cosine {got[1]:.6f} (>= "
        f"{bounds[1]:.6f}); worst tensor cosine {got[2]:.6f} at {got[4]} "
        f"(>= {bounds[2]:.6f}); update rel {got[3]:.4e} (bound "
        f"{bounds[3]:.4e}); card {t1 - t0:.1f} s, CPU {t2 - t1:.1f} s"
        + (f"; MISS: {'; '.join(misses)}" if misses else ""))
    report[f"{key}train_reference"] = dict(
        loss_rel=got[0], cos_all=got[1], cos_worst=got[2], update_rel=got[3],
        worst=got[4], bounds=bounds, cpu_s=t2 - t1)
    if misses:
        raise SystemExit(f"{name} training reference: " + "; ".join(misses))


def range_training(name, cfgs, report, key):
    """RANGE_TRAIN_STEPS train steps of the yaml's AdamW + onecycle on the
    repeated scan SEED + 1 at batch 1: finite losses, the last below the
    first; scans/s, one profiled step's device ms, its dense-conv share
    and the idle share."""
    from openpcseg_torch.engine.task import SegTask, batch_to_device

    task = SegTask(cfgs, NUM_CLASS, device="cuda", seed=SEED,
                   iters_per_epoch=ITERS_PER_EPOCH)
    req = range_request(SEED + 1)
    b = batch_to_device({k: req[k] for k in ("scan", "label", "mask")},
                        "cuda")
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(RANGE_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = task.train_step(b)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        ms = (time.perf_counter() - t0) * 1e3
        log(f"[{key}train] step {i}: loss {loss:.5f} grad_norm {gnorm:.4f} "
            f"lr {m['lr']:.3e} wall {ms:.2f} ms")
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise SystemExit(f"{name} training: step {i} loss {loss} grad "
                             f"norm {gnorm}")
        steps.append(dict(loss=loss, grad_norm=gnorm, lr=m["lr"],
                          wall_ms=ms))
    if not steps[-1]["loss"] < steps[0]["loss"]:
        raise SystemExit(f"{name} training: the last loss "
                         f"{steps[-1]['loss']} is not below the first "
                         f"{steps[0]['loss']}")
    med = statistics.median(s["wall_ms"] for s in steps[1:])
    mem = torch.cuda.max_memory_allocated()
    dev = _window(f"{key}train_step", _profiled(lambda: task.train_step(b),
                                                1), report)
    conv, rest = conv_share([(r["kernel"], r["count"], r["ms"]) for r in
                             report[f"profile_{key}train_step"]])
    idle = 1.0 - dev / med
    log(f"[{key}train] median train_step {med:.3f} ms = {1e3 / med:.3f} "
        f"scans/s (batch 1); loss {steps[0]['loss']:.5f} -> "
        f"{steps[-1]['loss']:.5f}; device {dev:.3f} ms, idle share "
        f"{idle:.4f}; dense convs {conv:.3f} ms, the rest {rest:.3f} ms "
        f"({conv / max(conv + rest, 1e-9):.1%} convs); peak memory "
        f"{mem / 2**30:.2f} GiB")
    report.update({f"{key}train_steps": steps, f"{key}train_median_ms": med,
                   f"{key}train_scans_per_s": 1e3 / med,
                   f"{key}train_device_ms": dev,
                   f"{key}train_idle_share": idle,
                   f"{key}train_conv_ms": conv, f"{key}train_rest_ms": rest,
                   f"{key}train_max_memory_allocated": mem})


def range_entry_phase(report, tmp, tree):
    """The train CLI on RANGE_ENTRY's yaml as it stands (the range view
    with its augmentations, AdamW + onecycle) at batch ENTRY_BATCH over
    `tree` for one epoch, again to two (it must resume), then the infer
    CLI with --save_pred --save_raw_ids: one raw id per pixel of each val
    scan's image, every one in the inverse label map."""
    from openpcseg_torch import native
    from openpcseg_torch.cli import infer, train
    from openpcseg_torch.data.semantickitti_meta import LEARNING_MAP_INV_LUT
    from openpcseg_torch.ops import cuda_lib

    preds = Path(tmp) / "range_preds"
    argv = ["--cfg_file", str(ROOT / RANGE_CFG.format(RANGE_ENTRY.lower())),
            "--log_dir", f"{tmp}/range_logs", "--extra_tag", "chip_smoke",
            "--batch_size", str(ENTRY_BATCH), "--log_interval", "1"]
    sets = ["--set", "DATA.DATA_PATH", tree]
    cuda_lib.reset_counts()
    projected = native.READS["projection"]
    t0 = time.perf_counter()
    for epochs in (1, 2):
        if train.main(argv + ["--epochs", str(epochs)] + sets) != 0:
            raise SystemExit(f"range entry point: train --epochs {epochs} "
                             "failed")
    if infer.main(argv + ["--save_pred", "--save_raw_ids"] + sets
                  + ["DATA.OUTPUT_DIR", str(preds)]) != 0:
        raise SystemExit("range entry point: infer failed")
    wall = time.perf_counter() - t0
    projected = native.READS["projection"] - projected
    no_port_kernels("range entry point")
    logs, steps, evals, ckps = _run_logs(f"{tmp}/range_logs")
    legal = set(LEARNING_MAP_INV_LUT.tolist())
    dumped = []
    for f in sorted(preds.glob("sequences/08/predictions/*.label")):
        ids = np.fromfile(f, dtype=np.uint32)
        dumped.append(dict(file=f.name, ids=len(ids),
                           legal=set(np.unique(ids).tolist()) <= legal))
    step_ms = [r["step_time"] * 1e3 for r in steps]
    data_ms = statistics.median(r["data_time"] * 1e3 for r in steps)
    miou = evals[-1]["val_miou"] if evals else float("nan")
    log(f"[range-entry] train CLI on {RANGE_ENTRY}'s yaml, batch "
        f"{ENTRY_BATCH}: step ms {', '.join(f'{t:.1f}' for t in step_ms)}, "
        f"data_time ms {data_ms:.1f} (median), val mIoU {miou:.2f} (per "
        f"point, KNN); {wall:.1f} s for train, resume and infer; the "
        f"loaders projected {projected} images natively; dumps {dumped}")
    report["range_entry_point"] = dict(
        steps=steps, evals=evals, checkpoints=ckps, dumped=dumped,
        val_miou=miou, wall_s=wall, data_time_ms=data_ms,
        projected=projected)
    faults = []
    if projected < 2 * ENTRY_SCANS[0]:
        faults.append(f"the CLI's loaders moved native.READS['projection'] "
                      f"by {projected} (want >= {2 * ENTRY_SCANS[0]}, a "
                      "train epoch's scans twice)")
    n_steps = ENTRY_SCANS[0] // ENTRY_BATCH * 2
    if "resumed from epoch 0" not in logs:
        faults.append("the second train call did not resume from epoch 0")
    if [r["step"] for r in steps] != list(range(1, n_steps + 1)) or not all(
            np.isfinite(r["loss"]) for r in steps):
        faults.append(f"train steps {steps}")
    if ckps != ["0.pt", "1.pt"] or len(evals) != 3 or not all(
            np.isfinite(e["val_miou"]) for e in evals):
        faults.append(f"checkpoints {ckps}, evals {evals}")
    if len(dumped) != ENTRY_SCANS[1] or not all(
            d["ids"] == RANGE_H * RANGE_W and d["legal"] for d in dumped):
        faults.append(f"the --save_raw_ids dump is wrong: {dumped}")
    if faults:
        raise SystemExit("range entry-point phase: " + "; ".join(faults))


def range_phases(report, tmp, tree, cudnn_tf32):
    """The four range models from their yamls: serving with per-point KNN,
    the card-against-CPU reference, training; then RANGE_ENTRY through
    the CLIs. cuDNN's TF32 is set back to torch's default, `cudnn_tf32`,
    for these phases; no kernel of the port launches in them. Returns the
    launches of every counter over the phases (all 0)."""
    from openpcseg_torch.engine.task import SegTask
    from openpcseg_torch.ops import cuda_lib

    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    log(f"[range] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"(torch's default) for the range phases")
    cuda_lib.reset_counts()
    for name in RANGE_MODELS:
        key = f"{name.lower()}_"
        cfgs = range_cfgs(name)
        task = SegTask(cfgs, NUM_CLASS, device="cuda", seed=SEED)
        n_par = sum(p.numel() for p in task.model.parameters())
        log(f"[{key}serve] {name} from {RANGE_CFG.format(name.lower())}: "
            f"{n_par} parameters, {RANGE_H} x {RANGE_W}, float32")
        range_serving(task, name, report, key)
        del task
        range_reference(name, cfgs, report, key)
        range_train_reference(name, cfgs, report, key)
        range_training(name, cfgs, report, key)
    no_port_kernels("range phases")
    launches = dict(cuda_lib.LAUNCHES)
    range_entry_phase(report, tmp, tree)
    report["range_phases_s"] = time.perf_counter() - t0
    log(f"[range] the range phases took {report['range_phases_s']:.1f} s")
    return {k: v + cuda_lib.LAUNCHES[k] for k, v in launches.items()}


# == test-time augmentation (tta_phase) and data parallel (dp_phase)
TTA_VOTES = 10
# the batched votes against per-vote forwards of a batch-1 task sharing the
# model, both bf16 through the kernels on the card: the rows are the same
# and only a kernel's plan (its split over the offsets, chosen by the row
# count) sums in another order, so bf16 roundings flip on a few
# activations. Fixed before the first card run: max |p_batched - p_vote|
# <= TTA_VOTE_TOL over every vote and point, argmax agreement >=
# TTA_VOTE_AGREE over the valid points of every vote
TTA_VOTE_TOL = 0.05
TTA_VOTE_AGREE = 0.98
DP_WORLD = 2           # ranks sharing cuda:0 over gloo
DP_STEPS = 3
# the data-parallel step (2 ranks, one scan each) against its one-process
# exact equivalent on the card (worker.exact_train_step: the 2-scan batch,
# each scan's loss, their mean), both bf16 through the kernels; only the
# order of the BN statistics' sums and the kernels' plans differ. The loss
# within DP_LOSS_REL of the exact step's. The bf16 step of this network
# moves under a change of summation order alone: on an H100 the exact step
# with its two scans swapped read whole-gradient and worst conv cosines of
# 0.98996 and 0.95855 against itself (cosines of 0.99 and 0.95, fixed for
# the DP step before it first ran there, lay inside that spread). So the
# cosines are held to DP_SPREAD times the exact step's own spread under the
# swap, measured in the same run: 1 - cos <= DP_SPREAD x (1 - cos_swap),
# and never below TRAIN_GROSS's cosines (JAX's bf16-against-f32 floor)
DP_LOSS_REL = 2e-3
DP_SPREAD = 2.0
# the cosines cannot see a gradient's scale: rank 0's gradient norm before
# the clip within DP_NORM_REL of the exact step's (a sum over the ranks in
# place of their mean reads 2x); fixed before its first card run
DP_NORM_REL = 0.05


def yaml_view(path, tree):
    """(cfgs without OPTIM, val view) of the shipped yaml at `path` over
    the ray-cast `tree`."""
    from openpcseg_torch.cli.train import parse_config
    from openpcseg_torch.data import build_dataloader

    _, cfgs = parse_config(["--cfg_file", str(ROOT / path), "--set",
                            "DATA.DATA_PATH", tree])
    view, _ = build_dataloader(
        cfgs.DATA, cfgs.get("MODALITY", "voxel"), 1, training=False,
        point_cap=cfgs.get("TPU", {}).get("POINT_CAP_PER_SCAN", N_POINTS),
        num_workers=1, seed=SEED)
    return {k: v for k, v in cfgs.items() if k != "OPTIM"}, view


def one_scan_view(scan, data_cfgs):
    """The voxel view of `data_cfgs` over one in-memory scan (a numpy
    batch of 1), so that its votes are the view's own get_tta_sample."""
    from openpcseg_torch.config import CfgDict
    from openpcseg_torch.data.voxel_view import SemkittiVoxelDataset

    v = scan["valid"][0]
    pc = {"xyzret": np.concatenate([scan["xyz"][0][v],
                                    scan["feats"][0][v, 3:4]], 1),
          "labels": scan["labels"][0][v], "path": "raycast/000000.bin"}

    class Source(list):
        def resample(self):
            pass

    class View(SemkittiVoxelDataset):
        def _make_source(self, *args):
            return Source([pc])

    return View(CfgDict(data_cfgs), training=False,
                point_cap=scan["xyz"].shape[1], seed=SEED)


def _votes_batch(votes, dev="cuda"):
    from openpcseg_torch.data import collate
    from openpcseg_torch.engine.task import batch_to_device

    return batch_to_device({k: v for k, v in collate(votes).items()
                            if k != "name"}, dev)


def tta_scan_time(task, votes, label, report):
    """Host wall (median of 3, collate and copy included, ended by reading
    the histogram) and device kernel time (profiler) of one scan's
    test-time augmentation; its histogram, and the launches and plain
    versions on the card of the first of the 3 runs alone."""
    from openpcseg_torch.engine.trainer import tta_scan_hist
    from openpcseg_torch.ops import cuda_lib

    walls = []
    for i in range(3):
        torch.cuda.synchronize()
        cuda_lib.reset_counts()
        t0 = time.perf_counter()
        hist = tta_scan_hist(task, votes).cpu()
        walls.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            launches = dict(cuda_lib.LAUNCHES)
            plain = dict(cuda_lib.PLAIN_ON_CUDA)
    dev = profile_window(label, lambda: tta_scan_hist(task, votes), report)
    wall = statistics.median(walls)
    log(f"[{label}] one {len(votes)}-vote scan: {wall:.2f} ms of host wall "
        f"(median of 3: {', '.join(f'{w:.2f}' for w in walls)}), "
        f"{dev:.3f} ms of device kernel time")
    report[label] = dict(wall_ms=wall, walls_ms=walls, device_ms=dev)
    return hist, launches, plain


def tta_phase(report, tmp, tree, cudnn_tf32):
    """Test-time augmentation of MinkUNet mk34_cr10 at full width over the
    ray-cast tree's 2 val scans x TTA_VOTES votes (the view's own votes),
    then one scan each of Cylinder3D cy480_cr10 and CENet 64 x 2048, then
    the infer CLI with --tta. Returns the launches of each main path, read
    just after it ran: MinkUNet's scans through ``tta_scan_hist`` alone
    ("minkunet"), one scan of Cylinder3D and of CENet, and the CLI's run
    ("cli")."""
    from openpcseg_torch.cli import infer
    from openpcseg_torch.engine.task import SegTask
    from openpcseg_torch.engine.trainer import tta_scan_hist
    from openpcseg_torch.ops import cuda_lib
    from openpcseg_torch.utils.metrics import confusion_matrix

    t_phase = time.perf_counter()
    cfgs, view = yaml_view(ENTRY_CFG, tree)
    kw = dict(device="cuda", compute_dtype=torch.bfloat16)
    task = SegTask(cfgs, NUM_CLASS, seed=SEED, batch_per_device=TTA_VOTES,
                   **kw)
    one = SegTask(cfgs, NUM_CLASS, model=task.model, **kw)
    faults, scans = [], []
    launches = dict.fromkeys(cuda_lib.LAUNCHES, 0)
    for i in range(len(view)):
        t0 = time.perf_counter()
        votes = view.get_tta_sample(i, voting=TTA_VOTES)
        build_ms = (time.perf_counter() - t0) * 1e3
        # the main path alone (what evaluate_tta runs for a scan): its
        # launches are read before anything else runs on the card
        cuda_lib.reset_counts()
        hist = tta_scan_hist(task, votes).cpu()
        got = dict(cuda_lib.LAUNCHES)
        missing = [k for k in FWD_COUNTERS if got[k] == 0]
        if missing or any(cuda_lib.PLAIN_ON_CUDA.values()):
            faults.append(f"val scan {i}: kernels never launched {missing} "
                          f"or a plain version ran on the card "
                          f"{dict(cuda_lib.PLAIN_ON_CUDA)}")
        for k, n in got.items():
            launches[k] += n
        db = _votes_batch(votes)
        vb, pyr, _ = task.forward(db)
        over = int(task.voxel_overflow(vb, pyr))
        probs = task.predict_probs_step(db)
        seq = torch.cat([one.predict_probs_step(
            {k: v[j:j + 1] for k, v in db.items()})
            for j in range(TTA_VOTES)])
        valid = db["valid"]
        diff = float((probs - seq).abs().max())
        agree = float((probs.argmax(-1) == seq.argmax(-1))[valid]
                      .float().mean())
        mean_agree = float((probs.mean(0).argmax(-1) == seq.mean(0).argmax(
            -1))[valid[0]].float().mean())
        n_valid = int(votes[0]["valid"].sum())
        rec = dict(points=n_valid, voxels=int(vb.num_voxels),
                   level_counts=pyr.level_counts.tolist(),
                   voxel_overflow=over, max_abs_diff=diff, agree=agree,
                   mean_agree=mean_agree, hist_sum=int(hist.sum()),
                   finite=bool(torch.isfinite(probs).all()),
                   vote_build_ms=build_ms, launches=got)
        scans.append(rec)
        log(f"[tta] val scan {i}: {n_valid} points x {TTA_VOTES} votes "
            f"(built on the host in {build_ms:.1f} ms), voxels per level "
            f"{rec['level_counts']} (caps {task.caps}), voxel_overflow "
            f"{over}; batched against per-vote: max|dp| {diff:.3e} (<= "
            f"{TTA_VOTE_TOL}), argmax agreement {agree:.5f} (>= "
            f"{TTA_VOTE_AGREE}), of the vote mean {mean_agree:.5f}; hist sum "
            f"{rec['hist_sum']}; its tta_scan_hist launched {got}")
        if (over or diff > TTA_VOTE_TOL or agree < TTA_VOTE_AGREE
                or rec["hist_sum"] != n_valid or not rec["finite"]):
            faults.append(f"val scan {i}: {rec}")
    votes = view.get_tta_sample(0, voting=TTA_VOTES)
    tta_scan_time(task, votes, "tta_scan", report)
    probs = task.predict_probs_step(_votes_batch(votes))
    db = _votes_batch(votes)
    tail = device_ms(lambda: confusion_matrix(
        probs.mean(0).argmax(-1).to(torch.int32), db["labels"][0],
        db["valid"][0], NUM_CLASS), KERNEL_REPS)
    log(f"[tta] the vote mean, argmax and histogram of a scan: {tail:.3f} "
        f"ms of device time ({tail / report['tta_scan']['device_ms']:.2%} "
        "of the scan's)")
    report["tta_tail_device_ms"] = tail
    del probs, db, one
    out = {"minkunet": launches}

    # the same votes of an 8192-point scan on the card (bf16) and on the
    # CPU (float32, plain versions), the card's weights
    scan = scan_for(CFGS, SEED, cap=8192)
    votes = one_scan_view(scan, cfgs["DATA"]).get_tta_sample(
        0, voting=TTA_VOTES)
    small = dict(batch_per_device=TTA_VOTES, voxel_cap_per_scan=8192)
    gpu = SegTask(cfgs, NUM_CLASS, model=task.model, **small, **kw)
    cpu = SegTask(cfgs, NUM_CLASS, device="cpu", **small)
    cpu.model.load_state_dict(task.model.state_dict())
    t0 = time.perf_counter()
    pm = {"gpu": gpu.predict_probs_step(_votes_batch(votes)).mean(0).cpu(),
          "cpu": cpu.predict_probs_step(_votes_batch(votes, "cpu")).mean(0)}
    hists = {"gpu": tta_scan_hist(gpu, votes).cpu(),
             "cpu": tta_scan_hist(cpu, votes)}
    valid = torch.as_tensor(votes[0]["valid"])
    err = float((pm["gpu"] - pm["cpu"]).abs().max() / pm["cpu"].abs().max())
    agree = float((pm["gpu"].argmax(-1) == pm["cpu"].argmax(-1))[valid]
                  .float().mean())
    n_valid = int(valid.sum())
    same = int(hists["gpu"].diagonal().sum())
    log(f"[tta-ref] 8192-point scan x {TTA_VOTES} votes, GPU bf16 kernels "
        f"vs CPU f32 plain: vote-mean probabilities max|diff|/max|ref| "
        f"{err:.4f} (<= 0.1), argmax agreement {agree:.4f} (>= 0.9); hist "
        f"sums {int(hists['gpu'].sum())} / {int(hists['cpu'].sum())} of "
        f"{n_valid}, correct points {same} / "
        f"{int(hists['cpu'].diagonal().sum())} "
        f"({time.perf_counter() - t0:.1f} s)")
    report["tta_reference"] = dict(rel_max_err=err, argmax_agree=agree,
                                   hist_gpu=hists["gpu"].tolist(),
                                   hist_cpu=hists["cpu"].tolist())
    if (err > 0.1 or agree < 0.9 or not torch.isfinite(pm["gpu"]).all()
            or int(hists["gpu"].sum()) != n_valid):
        faults.append(f"the 8192-point TTA disagrees with the CPU's: err "
                      f"{err}, agreement {agree}")
    del gpu, cpu, task

    # one scan of Cylinder3D and of CENet
    for name, path, need in (("cylinder", CYL_ENTRY_CFG, CYL_FWD),
                             ("cenet", RANGE_CFG.format("cenet"), ())):
        c, v = yaml_view(path, tree)
        if name == "cenet":
            torch.backends.cudnn.allow_tf32 = cudnn_tf32
        t = SegTask(c, classes(c), seed=SEED, batch_per_device=TTA_VOTES,
                    **kw)
        votes = v.get_tta_sample(0, voting=TTA_VOTES)
        hist, got, plain = tta_scan_time(t, votes, f"tta_{name}_scan",
                                         report)
        torch.backends.cudnn.allow_tf32 = False
        n_valid = int(votes[0]["p_valid" if t.is_range else "valid"].sum())
        log(f"[tta-{name}] hist sum {int(hist.sum())} of {n_valid} valid "
            f"points; one scan's launches {got}")
        bad = [k for k in need if got[k] == 0] if need else {
            k: n for k, n in got.items() if n}
        if int(hist.sum()) != n_valid or bad or any(plain.values()):
            faults.append(f"{name}: hist sum {int(hist.sum())} of {n_valid}"
                          f", launches {got} (want {need or 'none'})")
        out[name] = got
        del t

    # the infer CLI with --tta over the entry phase's experiment
    cuda_lib.reset_counts()
    argv = ["--cfg_file", str(ROOT / ENTRY_CFG), "--log_dir",
            f"{tmp}/logs", "--extra_tag", "chip_smoke", "--tta", "--set",
            "DATA.DATA_PATH", tree]
    t0 = time.perf_counter()
    rc = infer.main(argv)
    wall = time.perf_counter() - t0
    got = dict(cuda_lib.LAUNCHES)
    logs = _run_logs(f"{tmp}/logs")[0]
    exp = next(Path(f"{tmp}/logs").glob("**/ckp")).parent
    tta_miou = [r["val_tta_miou"] for r in map(json.loads, (
        exp / "metrics.jsonl").open()) if "val_tta_miou" in r]
    log(f"[tta-cli] infer --tta: rc {rc}, TTA val mIoU {tta_miou}, "
        f"{wall:.1f} s; launches {got}")
    if rc != 0 or "TTA val mIoU" not in logs or not tta_miou or any(
            got[k] == 0 for k in FWD_COUNTERS):
        faults.append(f"infer --tta: rc {rc}, mIoU {tta_miou}, launches "
                      f"{got}")
    out["cli"] = got
    report["tta"] = dict(scans=scans, cli_tta_miou=tta_miou,
                         cli_wall_s=wall, launches=out)
    report["tta_phase_s"] = time.perf_counter() - t_phase
    log(f"[tta] the phase took {report['tta_phase_s']:.1f} s")
    if faults:
        raise SystemExit("tta phase: " + "; ".join(faults))
    return out


def cosines(got, want, convs):
    """(whole-gradient cosine, worst conv cosine, its name) of two dicts
    of named gradients."""
    def cos(a, b):
        a, b = a.double().reshape(-1), b.double().reshape(-1)
        return float(a @ b / (a.norm() * b.norm()).clamp(min=1e-300))

    whole = cos(torch.cat([got[n].reshape(-1) for n in want]),
                torch.cat([w.reshape(-1) for w in want.values()]))
    per = {n: cos(got[n], want[n]) for n in convs}
    worst = min(per, key=per.get)
    return whole, per[worst], worst


def _dist_train(n, tmp, tree, tag, epochs):
    """openpcseg_torch/cli/dist_train.sh `n` over `tree` at batch 1 a
    rank: its return code and wall seconds."""
    env = dict(os.environ, PYTHON=sys.executable)
    t0 = time.perf_counter()
    res = subprocess.run(
        ["sh", str(ROOT / "openpcseg_torch/cli/dist_train.sh"), str(n),
         "--cfg_file", str(ROOT / ENTRY_CFG), "--log_dir",
         f"{tmp}/{tag}_logs", "--extra_tag", tag, "--batch_size", "1",
         "--epochs", str(epochs), "--log_interval", "1", "--workers", "2",
         "--set", "DATA.DATA_PATH", tree],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    log(f"[dp-cli] dist_train.sh {n} --epochs {epochs}: rc "
        f"{res.returncode}, {wall:.1f} s")
    if res.returncode:
        log(res.stdout[-4000:] + res.stderr[-4000:])
    return res.returncode, wall


def dp_phase(report, tmp, tree):
    """Data parallel on the card: the ranks' steps against their exact
    equivalent (dp_steps_phase) while dist_train.sh 2 and 1 run on the tree
    beside them (dp_cli_phase: their processes share the card and the host
    with the ranks, so no time of theirs is a measurement). Returns rank
    0's launches over its steps."""
    from concurrent.futures import ThreadPoolExecutor

    t_phase = time.perf_counter()
    free_card()
    with ThreadPoolExecutor(2) as pool:
        clis = {"2": pool.submit(lambda: [
            _dist_train(DP_WORLD, tmp, tree, "dp2", e) for e in (1, 2)]),
            "1": pool.submit(_dist_train, 1, tmp, tree, "dp1", 1)}
        launches = dp_steps_phase(report, tmp, tree)
        runs = dict(zip(("2x1", "2x2"), clis["2"].result()),
                    **{"1x1": clis["1"].result()})
    dp_cli_phase(report, tmp, runs)
    report["dp_phase_s"] = time.perf_counter() - t_phase
    log(f"[dp] the phase took {report['dp_phase_s']:.1f} s")
    return launches


def dp_steps_phase(report, tmp, tree):
    """DP_WORLD ranks sharing cuda:0 over gloo (parallel/worker.py),
    MinkUNet mk34_cr10 at full width, one ray-cast scan a rank, DP_STEPS
    steps, held to the one-process exact step; the summed eval and the
    sharded TTA histograms. Returns rank 0's launches over its steps."""
    from openpcseg_torch.engine.task import SegTask
    from openpcseg_torch.engine.trainer import tta_histogram
    from openpcseg_torch.models.layers import SparseConv
    from openpcseg_torch.parallel.worker import (exact_train_step,
                                                 load_batch, run_ranks)

    d = Path(tmp) / "dp"
    d.mkdir(parents=True, exist_ok=True)
    cfgs, view = yaml_view(ENTRY_CFG, tree)
    paths = []
    for r in range(DP_WORLD):
        paths.append(str(d / f"batch{r}.npz"))
        np.savez(paths[-1], **scan_for(CFGS, SEED + r))
    kw = dict(device="cuda", compute_dtype=torch.bfloat16, seed=SEED,
              iters_per_epoch=ITERS_PER_EPOCH)
    exact = SegTask(TRAIN_CFGS, NUM_CLASS, batch_per_device=DP_WORLD, **kw)
    torch.save(exact.model.state_dict(), d / "w.pt")
    spec = dict(cfgs=TRAIN_CFGS, num_class=NUM_CLASS, device="cuda",
                compute_dtype="bfloat16", world=DP_WORLD,
                weights=str(d / "w.pt"), batches=paths, steps=DP_STEPS,
                iters_per_epoch=ITERS_PER_EPOCH, seed=SEED, threads=None,
                data=dict(data=dict(cfgs["DATA"]), modality="voxel",
                          point_cap=N_POINTS, voting=TTA_VOTES))
    t0 = time.perf_counter()
    ranks = run_ranks(spec, d / "ranks", timeout=600)
    wall = time.perf_counter() - t0
    faults = []
    for r, res in enumerate(ranks):
        for i, m in enumerate(res["steps"]):
            log(f"[dp] rank {r} step {i}: loss {m['loss']:.5f} grad_norm "
                f"{m['grad_norm']:.4f} voxels {m['num_voxels']} "
                f"voxel_overflow {m['voxel_overflow']} wall "
                f"{m['wall_ms']:.1f} ms (two ranks on one card, the CLIs "
                f"beside) launches "
                f"{m['launches']}")
            missing = [k for k in MINK_COUNTERS if m["launches"][k] == 0]
            if (missing or any(m["plain_on_cuda"].values())
                    or m["voxel_overflow"] or not np.isfinite(m["loss"])):
                faults.append(f"rank {r} step {i}: never launched {missing}"
                              f", overflow {m['voxel_overflow']}, loss "
                              f"{m['loss']}")
    s0, s1 = (res["state"] for res in ranks)
    equal = all(torch.equal(s0[k], s1[k]) for k in s0)
    losses = [[m["loss"] for m in res["steps"]] for res in ranks]
    if not equal or losses[0] != losses[1]:
        faults.append(f"the ranks differ after {DP_STEPS} steps: "
                      f"parameters equal {equal}, losses {losses}")

    batches = [load_batch(p, "cuda") for p in paths]
    m = exact_train_step(exact, batches)
    grads = {n: p.grad.float().cpu() for n, p in
             exact.model.named_parameters()}
    convs = [n + ".weight" for n, mod in exact.model.named_modules()
             if isinstance(mod, SparseConv)]
    del exact
    swap = SegTask(TRAIN_CFGS, NUM_CLASS, batch_per_device=DP_WORLD, **kw)
    swap.model.load_state_dict(torch.load(d / "w.pt", weights_only=True))
    swap_norm = float(exact_train_step(swap, batches[::-1])["grad_norm"])
    spread = cosines({n: p.grad.float().cpu() for n, p in
                      swap.model.named_parameters()}, grads, convs)
    del swap, batches
    bound = [max(TRAIN_GROSS[i + 1], 1 - DP_SPREAD * (1 - spread[i]))
             for i in range(2)]
    whole, worst, at = cosines(ranks[0]["grads"], grads, convs)
    first = ranks[0]["steps"][0]
    rel = abs(first["loss"] - float(m["loss"])) / abs(float(m["loss"]))
    norm = first["grad_norm"] / float(m["grad_norm"])
    log(f"[dp-ref] the exact step against itself with its scans swapped: "
        f"whole-gradient cosine {spread[0]:.6f}, worst conv {spread[1]:.6f}"
        f" at {spread[2]}, gradient norm ratio "
        f"{swap_norm / float(m['grad_norm']):.6f}; the {DP_WORLD}-rank step "
        f"against the exact step: loss {first['loss']:.6f} vs "
        f"{float(m['loss']):.6f} (rel {rel:.3e} <= {DP_LOSS_REL}), "
        f"whole-gradient cosine {whole:.6f} (>= {bound[0]:.6f}), worst conv "
        f"cosine {worst:.6f} at {at} (>= {bound[1]:.6f}), gradient norm "
        f"before the clip {first['grad_norm']:.4f} vs "
        f"{float(m['grad_norm']):.4f} (ratio {norm:.6f}, within "
        f"{DP_NORM_REL} of 1)")
    if (rel > DP_LOSS_REL or whole < bound[0] or worst < bound[1]
            or abs(norm - 1) > DP_NORM_REL):
        faults.append(f"the DP step against the exact step: {rel}, "
                      f"{whole}, {worst}, {norm} (bounds {DP_LOSS_REL}, "
                      f"{bound}, {DP_NORM_REL})")
    del grads

    r0, r1 = ranks
    local = r0["local_hist"] + r1["local_hist"]
    n_valid = sum(int(np.load(p)["valid"].sum()) for p in paths)
    hist_ok = (torch.equal(r0["hist"], local)
               and torch.equal(r0["hist"], r1["hist"])
               and int(local.sum()) == n_valid)
    one = SegTask(TRAIN_CFGS, NUM_CLASS, **kw)
    one.model.load_state_dict(r0["state"])
    tta = SegTask(cfgs, NUM_CLASS, device="cuda",
                  compute_dtype=torch.bfloat16, batch_per_device=TTA_VOTES,
                  model=one.model)
    t0 = time.perf_counter()
    tta_one = tta_histogram(tta, view, TTA_VOTES)
    tta_s = time.perf_counter() - t0
    tta_ok = (np.array_equal(r0["tta_hist"].numpy(), tta_one)
              and torch.equal(r0["tta_hist"], r1["tta_hist"]))
    log(f"[dp] all-reduced eval histogram = the ranks' own summed: "
        f"{hist_ok} ({int(local.sum())} of {n_valid} points); sharded "
        f"{TTA_VOTES}-vote TTA histogram over the {len(view)} val scans = "
        f"one rank's: {tta_ok} ({int(tta_one.sum())} points; one rank "
        f"{tta_s:.1f} s); the ranks took {wall:.1f} s")
    if not hist_ok or not tta_ok:
        faults.append(f"histograms: eval {hist_ok}, TTA {tta_ok}")
    del one, tta
    report["dp"] = dict(
        steps=[res["steps"] for res in ranks], params_equal=equal,
        reference=dict(loss_rel=rel, cos_all=whole, cos_worst=worst,
                       grad_norm_ratio=norm, swap_cos_all=spread[0],
                       swap_cos_worst=spread[1],
                       swap_grad_norm_ratio=swap_norm / float(
                           m["grad_norm"]), bounds=bound),
        hist_ok=hist_ok, tta_ok=tta_ok, ranks_wall_s=wall)
    if faults:
        raise SystemExit("dp phase: " + "; ".join(faults))
    launches = dict.fromkeys(ranks[0]["steps"][0]["launches"], 0)
    for m in ranks[0]["steps"]:
        for k, n in m["launches"].items():
            launches[k] += n
    return launches


def dp_cli_phase(report, tmp, runs):
    """What openpcseg_torch/cli/dist_train.sh left on the tree (`runs`:
    each run's return code and wall seconds): DP_WORLD ranks sharing the
    card (gloo), an epoch and its resume, and one rank (NCCL)."""
    faults = []
    logs, steps, evals, ckps = _run_logs(f"{tmp}/dp2_logs")
    n_logs = len(list(Path(next(Path(f"{tmp}/dp2_logs").glob(
        "**/ckp")).parent).glob("log_train_*.txt")))
    n_steps = ENTRY_SCANS[0] // DP_WORLD * 2
    if (any(rc for rc, _ in runs.values()) or ckps != ["0.pt", "1.pt"]
            or "resumed from epoch 0" not in logs or "over gloo" not in logs
            or n_logs != 2
            or [r["step"] for r in steps] != list(range(1, n_steps + 1))
            or any(r["voxel_overflow"] for r in steps)
            or not all(np.isfinite(r["loss"]) for r in steps)):
        faults.append(f"dist_train.sh {DP_WORLD}: runs {runs}, checkpoints "
                      f"{ckps}, {n_logs} log files, steps "
                      f"{[r['step'] for r in steps]}")
    dp2 = dict(steps=steps, evals=evals, checkpoints=ckps,
               step_ms=[r["step_time"] * 1e3 for r in steps])
    log(f"[dp-cli] {DP_WORLD} ranks on one card: checkpoints {ckps}, steps "
        f"{[r['step'] for r in steps]}, step ms {dp2['step_ms']}, val mIoU "
        f"{[r['val_miou'] for r in evals]}")
    logs, steps, _, ckps = _run_logs(f"{tmp}/dp1_logs")
    if (runs["1x1"][0] or ckps != ["0.pt"] or "over nccl" not in logs
            or len(steps) != ENTRY_SCANS[0]):
        faults.append(f"dist_train.sh 1: rc {runs['1x1'][0]}, checkpoints "
                      f"{ckps}, NCCL {'over nccl' in logs}, {len(steps)} "
                      "steps")
    report["dp"].update(cli=dp2, cli_runs=runs)
    if faults:
        raise SystemExit("dp phase: " + "; ".join(faults))


# == this slice: MinkUNet mk34_cr10 with BLOCK Bottleneck at full width, the
# loss zoo, the other optimizers and RangeNet++'s CRF ========================
def bottleneck_shapes(model_cfg):
    """mink_shapes of a Bottleneck MODEL block: (level, Cin, Cout) of each
    3^3 conv (the stem's, then each block's one, planes -> planes), the
    down convs at the width they get (cs[0], then 4 x the planes of the
    stage before), the up convs from 4 x the planes of the stage below,
    and the devoxelizes of levels 4 and 2 at 4 x cs[4] and 4 x cs[6]
    (level 0's is the identity). mk34_cr10: downs 32-512, ups 1024 -> 256,
    1024 -> 128, 512 -> 96, 384 -> 96, devoxelizes 1024 and 512."""
    cs = [int(model_cfg.get("cr", 1.0) * x) for x in model_cfg["PLANES"]]
    subm = [(0, model_cfg["IN_FEATURE_DIM"], cs[0]), (0, cs[0], cs[0])]
    subm += [(i + 1, cs[i + 1], cs[i + 1]) for i in range(4)]
    subm += [(3 - i, cs[5 + i], cs[5 + i]) for i in range(4)]
    downs = [(1, cs[0])] + [(i + 1, 4 * cs[i]) for i in range(1, 4)]
    ups = [(3 - i, 4 * cs[4 + i], cs[5 + i]) for i in range(4)]
    return subm, downs, ups, [(4, 4 * cs[4]), (2, 4 * cs[6])]


def bn_kernel_phase(report, aligned):
    """Every kernel case at the Bottleneck's shapes (bottleneck_shapes) on
    scan SEED's pyramid, forward and backward, each against its plain
    version, twice, bit for bit, timed (the dfeats and dW passes alone
    untimed); then each kernel's share of its bound beside mk34_cr10's
    (`aligned`)."""
    from openpcseg_torch.engine.task import SegTask, batch_to_device

    task = SegTask(CFGS, NUM_CLASS, device="cuda",
                   compute_dtype=torch.bfloat16, seed=SEED)
    _, pyr = task.preprocess(batch_to_device(scan_for(CFGS, SEED), "cuda"))
    shapes = (*bottleneck_shapes(BN_MODEL_CFG), "bn ")
    log(f"[bn-kernels] pyramid of scan {SEED}: voxels per level "
        f"{pyr.level_counts.tolist()}; shapes {shapes[:4]}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    bwd = backward_cases(pyr, gen, *shapes)
    alone = [c["label"].endswith((" dfeats", " dW")) for c in bwd]
    rows = check_cases(kernel_cases(pyr, gen, *shapes)
                       + [c for c, a in zip(bwd, alone) if not a],
                       "bn-kernels")
    rows += check_cases([c for c, a in zip(bwd, alone) if a], "bn-passes",
                        timed=False)
    report["bn_cases"] = rows
    report["bn_shares"] = share_lines(rows, aligned, "bn", "Bottleneck")
    return rows


def cli_phase(tag, cfg_path, tmp, tree, sets=(), epochs=(1, 2), need=(),
              infer_flags=("--save_pred", "--save_raw_ids"), check=None):
    """The train CLI on the yaml at `cfg_path` with the `sets` overrides at
    batch ENTRY_BATCH over `tree`, once per entry of `epochs` (the second
    call must resume), then the infer CLI with `infer_flags` (one raw id a
    point, each a class's, where --save_raw_ids); check(argv) runs between
    the train calls (a resume check of its own). Every counter is read over
    the phase and the counters `need` must move. Returns the launches and
    the phase's record."""
    from openpcseg_torch.cli import infer, train
    from openpcseg_torch.data.semantickitti_meta import LEARNING_MAP_INV_LUT
    from openpcseg_torch.ops import cuda_lib

    preds = Path(tmp) / f"{tag}_preds"
    argv = ["--cfg_file", str(ROOT / cfg_path), "--log_dir",
            f"{tmp}/{tag}_logs", "--extra_tag", "chip_smoke", "--batch_size",
            str(ENTRY_BATCH), "--log_interval", "1"]
    sets = ["--set", "DATA.DATA_PATH", tree, *sets]
    cuda_lib.reset_counts()
    t0 = time.perf_counter()
    for i, n in enumerate(epochs):
        if i and check is not None:
            check(argv + ["--epochs", str(n)] + sets)
        if train.main(argv + ["--epochs", str(n)] + sets) != 0:
            raise SystemExit(f"{tag} CLI: train --epochs {n} failed")
    if infer.main(argv + list(infer_flags) + sets
                  + ["DATA.OUTPUT_DIR", str(preds)]) != 0:
        raise SystemExit(f"{tag} CLI: infer failed")
    wall = time.perf_counter() - t0
    launches = dict(cuda_lib.LAUNCHES)
    plain_on_cuda = dict(cuda_lib.PLAIN_ON_CUDA)
    logs, steps, evals, ckps = _run_logs(f"{tmp}/{tag}_logs")
    legal = set(LEARNING_MAP_INV_LUT.tolist())
    dumped = []
    for f in sorted(preds.glob("sequences/08/predictions/*.label")):
        ids = np.fromfile(f, dtype=np.uint32)
        scan = Path(tree, "08", "velodyne", f.stem + ".bin")
        dumped.append(dict(file=f.name, ids=len(ids),
                           points=scan.stat().st_size // 16,
                           legal=set(np.unique(ids).tolist()) <= legal))
    step_ms = [r["step_time"] * 1e3 for r in steps]
    miou = evals[-1]["val_miou"] if evals else float("nan")
    log(f"[{tag}-cli] train CLI on {cfg_path} {' '.join(sets[3:])}, batch "
        f"{ENTRY_BATCH}: losses {[round(r['loss'], 4) for r in steps]}, "
        f"lr {[r['lr'] for r in steps]}, step ms "
        f"{', '.join(f'{t:.1f}' for t in step_ms)}, val mIoU {miou:.2f}; "
        f"{wall:.1f} s for train{', resume' * (len(epochs) > 1)} and infer; "
        f"checkpoints {ckps}; dumps {dumped}; launches {launches}")
    rec = dict(steps=steps, evals=evals, checkpoints=ckps, dumped=dumped,
               val_miou=miou, wall_s=wall, launches=launches,
               plain_on_cuda=plain_on_cuda)
    faults = []
    n_steps = ENTRY_SCANS[0] // ENTRY_BATCH * epochs[-1]
    if len(epochs) > 1 and "resumed from epoch 0" not in logs:
        faults.append("the second train call did not resume from epoch 0")
    if [r["step"] for r in steps] != list(range(1, n_steps + 1)) or not all(
            np.isfinite(r["loss"]) for r in steps):
        faults.append(f"train steps {steps}")
    if ckps != [f"{e}.pt" for e in range(epochs[-1])]:
        faults.append(f"checkpoints {ckps}")
    if any(r["voxel_overflow"] for r in steps) or any(
            r["val_voxel_overflow"] for r in evals):
        faults.append("voxel_overflow > 0 in metrics.jsonl")
    if "--save_raw_ids" in infer_flags and (
            len(dumped) != ENTRY_SCANS[1] or not all(
                d["ids"] == d["points"] and d["legal"] for d in dumped)):
        faults.append(f"the --save_raw_ids dump is wrong: {dumped}")
    missing = [k for k in need if launches[k] == 0]
    if missing or any(plain_on_cuda.values()):
        faults.append(f"kernels never launched {missing}, or a plain version "
                      f"ran on the card {plain_on_cuda}")
    if faults:
        raise SystemExit(f"{tag} CLI phase: " + "; ".join(faults))
    return launches, rec


def fusion_bottleneck_step(report):
    """SPVCNN mk34_cr10 with BLOCK Bottleneck (its yaml's MODEL block with
    the 4x expanded point MLPs) at full width: one train step on the scan
    of seed 1, finite, no overflow, every counter of its path launched.
    RPVNet takes no Bottleneck: JAX's gate adds a cs[4]-wide range feature
    to a 4 x cs[4]-wide voxel one (tests/test_torch_bottleneck.py)."""
    from openpcseg_torch.engine.task import SegTask, batch_to_device
    from openpcseg_torch.ops import cuda_lib

    cfgs = dict(SPV_TRAIN_CFGS, MODEL=dict(SPV_MODEL_CFG, BLOCK="Bottleneck"))
    task = SegTask(cfgs, NUM_CLASS, device="cuda",
                   compute_dtype=torch.bfloat16, seed=SEED,
                   iters_per_epoch=ITERS_PER_EPOCH)
    cuda_lib.reset_counts()
    m = task.train_step(batch_to_device(scan_for(cfgs, SEED + 1), "cuda"))
    loss, over = float(m["loss"]), int(m["voxel_overflow"])
    launches = dict(cuda_lib.LAUNCHES)
    plain_on_cuda = dict(cuda_lib.PLAIN_ON_CUDA)
    n = sum(p.numel() for p in task.model.parameters())
    log(f"[bn-spvcnn] SPVCNN Bottleneck: {n} parameters, one train step: "
        f"loss {loss:.4f}, voxel_overflow {over}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    report["bn_spvcnn_step"] = dict(parameters=n, loss=loss,
                                    voxel_overflow=over, launches=launches)
    missing = [k for k in SPV_NEED if launches[k] == 0]
    if (not np.isfinite(loss) or over or missing
            or any(plain_on_cuda.values())):
        raise SystemExit(f"SPVCNN Bottleneck step: loss {loss}, overflow "
                         f"{over}, never launched {missing}, plain versions "
                         f"on the card {plain_on_cuda}")


def bottleneck_phases(report, tmp, tree, aligned):
    """MinkUNet mk34_cr10 with BLOCK Bottleneck on the card: its kernel
    cases at the new widths, serving (every forward counter on every
    request), the eval profile and idle share, the eval reference,
    training (every counter on every step) and its profile, the training
    reference over its ten draws under its own JAX reading, the CLIs on
    the shipped yaml with --set MODEL.BLOCK Bottleneck (an epoch, a resumed
    second, the raw-id dump), and SPVCNN's Bottleneck step. Returns the
    cases, the launches of serving and training, and those of the CLIs."""
    from openpcseg_torch.engine.task import SegTask

    t0 = time.perf_counter()

    def done(name):
        report.setdefault("bn_phase_s", {})[name] = time.perf_counter() - t0
        log(f"[time] bottleneck {name} done at "
            f"{report['bn_phase_s'][name]:.1f} s")
    rows = bn_kernel_phase(report, aligned)
    done("kernels")
    task = SegTask(BN_CFGS, NUM_CLASS, device="cuda",
                   compute_dtype=torch.bfloat16, seed=SEED)
    n = sum(p.numel() for p in task.model.parameters())
    log(f"[bn-serve] MinkUNet mk34_cr10 BLOCK Bottleneck: {n} parameters, "
        f"classifier over {task.model.classifier.in_features}, caps "
        f"{task.caps}")
    report["bn_parameters"] = n
    launches = serving_phase(task, report, "bn-serve", FWD_COUNTERS, "bn_")
    eval_ms = profile_phase(task, report, "bn_")
    idle = 1.0 - eval_ms / report["bn_p50_ms"]
    log(f"[profile] bn_eval_step device idle share {idle:.4f} (device "
        f"{eval_ms:.3f} ms of the {report['bn_p50_ms']:.3f} ms p50)")
    report["bn_eval_idle_share"] = idle
    del task
    reference_phase(report, BN_CFGS, "bn_reference")
    done("serving")
    train = training_phase(report, BN_TRAIN_CFGS, "bn-train", MINK_COUNTERS,
                           "bn_")
    launches.update({k: v for k, v in train.items()
                     if k not in FWD_COUNTERS})
    done("training")
    train_reference_phase(report, "Bottleneck")
    done("train-reference")
    entry, report["bn_entry_point"] = cli_phase(
        "bn", ENTRY_CFG, tmp, tree, ["MODEL.BLOCK", "Bottleneck"],
        need=MINK_COUNTERS)
    fusion_bottleneck_step(report)
    free_card()
    report["bn_phases_s"] = time.perf_counter() - t0
    log(f"[bottleneck] the Bottleneck phases took "
        f"{report['bn_phases_s']:.1f} s")
    return rows, launches, entry


# the loss zoo on the card: each of the ten names of losses.KNOWN (the
# GroupSoftmax pair once more over the extended head) on the same
# full-scan logits, card against the CPU in float32: the value within
# LOSS_VALUE_TOL of the CPU's (relative), the gradient with respect to the
# logits within LOSS_GRAD_TOL of the CPU gradient's largest entry; set
# before the first card run (both sides compute in float32, in other
# summation orders over ~98k rows). Then LOSS_STEPS train steps each.
LOSS_VALUE_TOL = 1e-4
LOSS_GRAD_TOL = 1e-3
LOSS_STEPS = 3
# the port's modules of this slice: no host sync may start in them
SLICE_MODULES = tuple(f"openpcseg_torch/{m}" for m in (
    "losses/__init__.py", "losses/ce.py", "losses/dice.py",
    "losses/longtail.py", "ops/range_postproc.py", "optim/__init__.py"))


@contextlib.contextmanager
def sync_sites():
    """torch.cuda.set_sync_debug_mode('warn') for the block; yields the
    list of syncs it names, each the innermost frame of the port (or of
    this script) that called the synchronizing operation."""
    import traceback
    import warnings

    sites = []
    saved = warnings.showwarning

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return saved(message, category, filename, lineno, file, line)
        frames = [f for f in traceback.extract_stack()[:-1]
                  if "openpcseg_torch" in f.filename
                  or f.filename.endswith("chip_smoke.py")]
        port = [f for f in frames if "openpcseg_torch" in f.filename]
        site = (port or frames or [None])[-1]
        sites.append(f"{Path(site.filename).resolve().relative_to(ROOT)}:"
                     f"{site.lineno} ({site.name})" if site else "?")
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield sites
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = saved


def hold_syncs(tag, sites, report):
    """Log where the syncs came from; fail where one starts in this
    slice's modules (SLICE_MODULES)."""
    counts = {}
    for s in sites:
        counts[s] = counts.get(s, 0) + 1
    log(f"[syncs] {tag}: {len(sites)} synchronizing operations: {counts}")
    report.setdefault("syncs", {})[tag] = counts
    ours = [s for s in counts if s.startswith(SLICE_MODULES)]
    if ours:
        raise SystemExit(f"{tag}: host syncs in this slice's modules: {ours}")


def loss_zoo_phase(report):
    """The ten losses on the card against the CPU in float32, on the same
    logits of the full-width MinkUNet mk34_cr10 (ResBlock) on scan SEED
    (its voxels, labels and mask; the GroupSoftmax names over Waymo's
    first 20 class names, whose groups then hold classes, and once more
    over the logits of an EXTEND_HEAD_FOR_GROUPS head; DiceLossV1 and the
    extended GroupSoftmax on the same draws on both sides; EQLv2 from its
    zero buffers, then again from the buffers the first call left); then
    LOSS_STEPS train steps of each name alone (finite loss, every kernel
    launched on every step); then one train step of every name at once,
    and one of the extended GroupSoftmax and DiceLossV1, under
    torch.cuda.set_sync_debug_mode('warn'). Returns the launches of the
    train steps."""
    from openpcseg_torch import losses as tl
    from openpcseg_torch.data.waymo import WAYMO_CLASS_NAMES
    from openpcseg_torch.engine.task import SegTask, batch_to_device
    from openpcseg_torch.losses import longtail
    from openpcseg_torch.ops import cuda_lib

    t0 = time.perf_counter()
    scan = batch_to_device(scan_for(CFGS, SEED), "cuda")
    ext_cfgs = dict(CFGS, MODEL=dict(MODEL_CFG, EXTEND_HEAD_FOR_GROUPS=True))
    inputs = {}
    for key, cfgs in (("plain", CFGS), ("extended", ext_cfgs)):
        task = SegTask(cfgs, NUM_CLASS, device="cuda",
                       compute_dtype=torch.bfloat16, seed=SEED)
        vb, _, logits = task.forward(scan)
        inputs[key] = (logits.float(), vb.voxel_labels, vb.voxel_valid)
        del task
    names20 = list(WAYMO_CLASS_NAMES[:NUM_CLASS])
    from openpcseg_torch.data import dataset_meta
    kitti_names, kitti_pts = dataset_meta("semantickitti")
    gen = torch.Generator().manual_seed(SEED + 5)
    n = inputs["plain"][0].shape[0]
    dice_draws = torch.rand((NUM_CLASS, n), generator=gen)
    groups, _ = longtail.group_structure(names20)
    group_draws = [torch.rand(n, generator=gen) for g in groups if g]

    def run(name, dev, state=None):
        ext = name.endswith("extended")
        logits, labels, valid = (t.to(dev) for t in inputs[
            "extended" if ext else "plain"])
        base = name.replace(" extended", "")
        group = base.startswith("GroupSoftmax")
        x = logits.clone().requires_grad_()
        if base == "DiceLossV1":
            v = tl.dice_loss_v1(x, labels, valid, draws=dice_draws.to(dev))
        elif ext:
            v = longtail.group_softmax_loss_extended(
                x, labels, valid, num_class=NUM_CLASS, class_names=names20,
                draws=[d.to(dev) for d in group_draws])
        else:
            loss = tl.Losses([base], [1.0], cls_num_pts=kitti_pts,
                             class_names=names20 if group else kitti_names,
                             num_class=NUM_CLASS, label_smoothing=0.1)
            v = loss(x, labels, valid, state=state)
        if isinstance(v, tuple):
            v, state = v
        v.backward()
        return float(v.detach()), x.grad.cpu(), state

    rows, misses = [], []
    cases = list(tl.KNOWN) + ["GroupSoftmax extended", "EQLv2 second step"]
    for name in cases:
        if name == "EQLv2 second step":
            got = run("EQLv2", "cuda", eqlv2[0])
            want = run("EQLv2", "cpu", eqlv2[1])
        elif name == "EQLv2":
            states = [tl.Losses(["EQLv2"], [1.0]).init_state(
                NUM_CLASS, dev) for dev in ("cuda", "cpu")]
            got = run(name, "cuda", states[0])
            want = run(name, "cpu", states[1])
            eqlv2 = (got[2], want[2])
        else:
            got, want = run(name, "cuda"), run(name, "cpu")
        rel = abs(got[0] - want[0]) / max(abs(want[0]), 1e-12)
        gerr = float((got[1] - want[1]).abs().max()
                     / want[1].abs().max().clamp(min=1e-30))
        ok = (np.isfinite(got[0]) and rel <= LOSS_VALUE_TOL
              and gerr <= LOSS_GRAD_TOL and float(want[1].abs().max()) > 0)
        rows.append(dict(loss=name, card=got[0], cpu=want[0], value_rel=rel,
                         grad_rel=gerr, ok=ok))
        log(f"[loss-zoo] {name:24s} card {got[0]:.6f} CPU {want[0]:.6f} "
            f"(rel {rel:.2e}, tolerance {LOSS_VALUE_TOL}); gradient "
            f"max|diff|/max|CPU| {gerr:.2e} (tolerance {LOSS_GRAD_TOL}) "
            f"{'ok' if ok else 'MISS'}")
        if not ok:
            misses.append(name)
    report["loss_zoo"] = rows
    if misses:
        raise SystemExit(f"loss zoo: card against CPU misses {misses}")

    # LOSS_STEPS train steps of each name alone, on one model per head
    b = batch_to_device(scan_for(CFGS, SEED + 1), "cuda")
    shared, totals, steps = {}, dict.fromkeys(cuda_lib.COUNTERS, 0), {}
    for name in list(tl.KNOWN) + ["GroupSoftmax extended"]:
        ext = name.endswith("extended")
        model = dict(MODEL_CFG, EXTEND_HEAD_FOR_GROUPS=ext, LOSS_CONFIG={
            "LOSS_TYPES": [name.replace(" extended", "")],
            "LOSS_WEIGHTS": [1.0]})
        task = SegTask(dict(TRAIN_CFGS, MODEL=model), NUM_CLASS,
                       device="cuda", compute_dtype=torch.bfloat16,
                       seed=SEED, iters_per_epoch=ITERS_PER_EPOCH,
                       model=shared.get(ext))
        shared[ext] = task.model
        losses = []
        for _ in range(LOSS_STEPS):
            cuda_lib.reset_counts()
            m = task.train_step(b)
            losses.append(float(m["loss"]))
            launches = dict(cuda_lib.LAUNCHES)
            for k, v in launches.items():
                totals[k] += v
            missing = [k for k in MINK_COUNTERS if launches[k] == 0]
            if (missing or any(cuda_lib.PLAIN_ON_CUDA.values())
                    or not np.isfinite(losses[-1])):
                raise SystemExit(f"loss zoo {name}: loss {losses[-1]}, "
                                 f"never launched {missing}")
        steps[name] = losses
        log(f"[loss-zoo] {name}: {LOSS_STEPS} train steps, losses "
            f"{[round(x, 5) for x in losses]}"
            + (f"; EQLv2 buffers {task.loss_state['eqlv2']['pos_grad'][:3]}"
               if task.losses.stateful else ""))
    report["loss_zoo_steps"] = steps

    # one step of every name at once, and of the sampling pair over the
    # extended head, under the sync debug mode
    for tag, ext, names in (("every loss", False, [
            n for n in tl.KNOWN]), ("extended GroupSoftmax + DiceLossV1",
                                   True, ["GroupSoftmax", "DiceLossV1"])):
        model = dict(MODEL_CFG, EXTEND_HEAD_FOR_GROUPS=ext, LOSS_CONFIG={
            "LOSS_TYPES": names, "LOSS_WEIGHTS": [1.0] * len(names)})
        task = SegTask(dict(TRAIN_CFGS, MODEL=model), NUM_CLASS,
                       device="cuda", compute_dtype=torch.bfloat16,
                       seed=SEED, iters_per_epoch=ITERS_PER_EPOCH,
                       model=shared[ext])
        task.train_step(b)          # the first step's one-time copies
        torch.cuda.synchronize()
        with sync_sites() as sites:
            m = task.train_step(b)
            float(m["loss"])
        hold_syncs(f"train step, {tag}", sites, report)
    report["loss_zoo_s"] = time.perf_counter() - t0
    log(f"[loss-zoo] the phase took {report['loss_zoo_s']:.1f} s")
    return totals


def loss_cli_phase(report, tmp, tree):
    """The CLIs on the mk34 yaml with the loss zoo's stateful and sampling
    losses and the other optimizers: LOSS_TYPES [EQLv2, GroupSoftmax] with
    adam_onecycle (an epoch, a resumed second: the resumed Trainer holds
    EQLv2's buffers of ckp/0.pt bit for bit; they moved by the second
    epoch), then GroupSoftmax over the EXTEND_HEAD_FOR_GROUPS head with
    sgd_fc (an epoch, the raw-id dump: one real class's id a point, through
    the group-softmax activation). EQLv2 takes the num_class-wide head:
    JAX cannot run it with the extended head (tests/test_torch_loss_zoo.py).
    Returns the launches of both."""
    from openpcseg_torch.cli.train import parse_config
    from openpcseg_torch.engine.trainer import Trainer

    held = {}

    def resume_check(argv):
        args, cfgs = parse_config(argv)
        tr = Trainer(args, cfgs)
        tr.init_or_resume()
        saved = torch.load(next(Path(args.log_dir).glob("**/ckp/0.pt")),
                           map_location="cpu", weights_only=True)
        got = {k: v.cpu() for k, v in tr.task.loss_state["eqlv2"].items()}
        held["eq"] = all(torch.equal(got[k], saved["loss_state"]["eqlv2"][k])
                         for k in got)
        held["saved"] = saved["loss_state"]["eqlv2"]
        tr.close()
        log(f"[loss-cli] the resumed Trainer's EQLv2 buffers equal ckp/0.pt's"
            f" bit for bit: {held['eq']} (pos_grad[:4] "
            f"{got['pos_grad'][:4].tolist()})")

    total = {}
    for tag, sets, epochs, check in (
            ("eqlv2", ["MODEL.LOSS_CONFIG.LOSS_TYPES", "[EQLv2,GroupSoftmax]",
                       "MODEL.LOSS_CONFIG.LOSS_WEIGHTS", "[1.0,1.0]",
                       "OPTIM.OPTIMIZER", "adam_onecycle"], (1, 2),
             resume_check),
            ("sgdfc", ["MODEL.LOSS_CONFIG.LOSS_TYPES", "[GroupSoftmax]",
                       "MODEL.LOSS_CONFIG.LOSS_WEIGHTS", "[1.0]",
                       "MODEL.EXTEND_HEAD_FOR_GROUPS", "True",
                       "OPTIM.OPTIMIZER", "sgd_fc"], (1,), None)):
        launches, rec = cli_phase(tag, ENTRY_CFG, tmp, tree, sets, epochs,
                                  MINK_COUNTERS, check=check)
        report[f"loss_cli_{tag}"] = rec
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    last = torch.load(next(Path(tmp).glob("eqlv2_logs/**/ckp/1.pt")),
                      map_location="cpu", weights_only=True)["loss_state"]
    moved = not torch.equal(last["eqlv2"]["pos_grad"],
                            held["saved"]["pos_grad"])
    ext = torch.load(next(Path(tmp).glob("sgdfc_logs/**/ckp/0.pt")),
                     map_location="cpu", weights_only=True)
    width = ext["model"]["classifier.weight"].shape[0]
    scales = [g.get("lr_scale", 1.0) for g in ext["optimizer"]["param_groups"]]
    log(f"[loss-cli] EQLv2's buffers moved over the resumed epoch: {moved}; "
        f"the extended head is {width} wide; sgd_fc's groups {scales}")
    if not (held.get("eq") and moved and width == 24):
        raise SystemExit(f"loss CLI phase: buffers restored {held.get('eq')}"
                         f", moved {moved}, head width {width}")
    return total


# RangeNet++ 64 x 2048 from its yaml with POST_CRF {ITER 3, LCN_H 3,
# LCN_W 5}: the refined probabilities, card (TF32 convs) against CPU
# float32, under the range reference rule: max |p_card - p_cpu| within
# RANGE_REF_TOL and argmax agreement at least RANGE_REF_AGREE, on the
# pixels and on the points (the eval histograms' KNN predictions)
CRF_CFG = {"ITER": 3, "LCN_H": 3, "LCN_W": 5}


def crf_phase(report, cudnn_tf32):
    """RangeNet++ with MODEL.POST_CRF served at full width (range_serving:
    the CRF inside every eval step), the CRF's own device ms, the refined
    probabilities and the eval histogram against the CPU's, and one CRF
    eval step under the sync debug mode."""
    from openpcseg_torch.engine.task import SegTask, batch_to_device

    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    cfgs = dict(range_cfgs("RangeNet"))
    cfgs["MODEL"] = dict(cfgs["MODEL"], POST_CRF=CRF_CFG)
    tasks = {}
    for key, dev in (("card", "cuda"), ("cpu", "cpu")):
        tasks[key] = (SegTask(cfgs, NUM_CLASS, device=dev, seed=SEED), dev)
        seed_range_weights(tasks[key][0].model, SEED)
    task = tasks["card"][0]
    range_serving(task, "RangeNet POST_CRF", report, "crf_")
    b = range_request(SEED)
    cb = batch_to_device(b, "cuda")
    logits = task.range_logits(cb)
    crf_ms = profile_window("crf", lambda: task.crf_logits(cb, logits),
                            report)
    net_ms = report["crf_eval_device_ms"]
    log(f"[crf] the CRF ({CRF_CFG}) of one 64 x 2048 image: {crf_ms:.3f} ms "
        f"of device time, of the {net_ms:.3f} ms eval step")
    probs, hists = {}, {}
    for key, (t, dev) in tasks.items():
        tb = batch_to_device(b, dev)
        refined = t.crf_logits(tb, t.range_logits(tb))
        probs[key] = refined.exp().cpu()
        hists[key] = t.range_hist(tb, refined).cpu()
    g, r = probs["card"], probs["cpu"]
    err = float((g - r).abs().max())
    agree = float((g.argmax(1) == r.argmax(1)).float().mean())
    points = int(b["p_valid"].sum())
    hist_gap = int((hists["card"] - hists["cpu"]).abs().sum()) // 2
    log(f"[crf] refined probabilities, card (TF32 convs) vs CPU float32: "
        f"max|diff| {err:.3e} (tolerance {RANGE_REF_TOL}), argmax agreement "
        f"{agree:.5f} (at least {RANGE_REF_AGREE}); eval histograms: "
        f"{hist_gap} of {points} points apart (at most "
        f"{(1 - RANGE_REF_AGREE) * points:.0f}), sums "
        f"{int(hists['card'].sum())} / {int(hists['cpu'].sum())}")
    report["crf"] = dict(device_ms=crf_ms, eval_device_ms=net_ms,
                         prob_max_err=err, argmax_agree=agree,
                         hist_points_apart=hist_gap, points=points)
    torch.cuda.synchronize()
    with sync_sites() as sites:
        task.crf_logits(cb, logits).sum().item()
    hold_syncs("the CRF of one image", sites, report)
    torch.backends.cudnn.allow_tf32 = False
    if (err > RANGE_REF_TOL or agree < RANGE_REF_AGREE
            or hist_gap > (1 - RANGE_REF_AGREE) * points
            or int(hists["card"].sum()) != points):
        raise SystemExit("CRF phase: the card's refined probabilities or "
                         "histogram disagree with the CPU's")


def kernel_report(rows, launches, entry_launches, spv_launches,
                  spv_entry_launches, cyl_launches, cyl_entry_launches,
                  range_launches, rpv_launches, rpv_entry_launches,
                  waymo_launches, waymo_entry_launches, yaml_launches,
                  tta_launches, dp_launches, slice_launches):
    """The kernels JSON line: per kernel its launches on the main paths
    (MinkUNet's serving and training phases, SPVCNN's, whose K7 and K8
    also count the launches of its mean-voxelize, and Cylinder3D's), over
    the entry-point phases, and the MinkUNet case with the slowest plain
    version (the whole backward for K2, K5 and K6, beside the device times
    of their heaviest dfeats and dW passes alone), with its bound and, for
    K7 and K8, the library call's time; K7 and K8 also their heaviest
    mean-voxelize case; and Cylinder3D's heaviest case of the kernel
    (K1 / K2 its submanifold convs, K3 / K5 its k3 strided convs' forward /
    backward, K7 / K8 its refinement gather / its backward); RPVNet's
    launches (its range fusion's included) and its heaviest case at its
    voxel shapes; and its launches over the range phases, which run none
    of them; Waymo mk34_cr16's launches (serving and training, the entry
    phase at batch 8) and its heaviest case at the cr 1.6 widths, and the
    launches over the other Waymo / nuScenes yamls' cells; the launches of
    MinkUNet's test-time augmentation over its val scans (tta_scan_hist
    alone), of one Cylinder3D scan's and of the infer CLI's with --tta,
    apart; rank 0's over the data-parallel steps (every counter of the
    kernel); this slice's (`slice_launches`, column -> launches: the
    Bottleneck's serving and training, its CLIs, the loss zoo's train
    steps and its CLIs) and the Bottleneck's heaviest case at its widths.
    Then a row for
    each K7 / K8 route of RPVNet's range fusion (RANGE_FUSION_ROWS): its
    launches on RPVNet's serving and training, its heaviest case, bound
    and library call."""
    kernels = []
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name
                and not r["shape"].startswith(("voxelize_mean", "cyl",
                                               "rpv", "waymo", "bn "))]
        whole = [r for r in mine
                 if not r["shape"].endswith((" dfeats", " dW"))]
        heavy = max(whole, key=lambda r: r["plain_ms"])
        spv = [meta["counter"], meta.get("vmean_counter")]
        cyl = meta["cyl_counters"]
        row = dict(
            name=name, route=meta["route"], source=meta["source"],
            replaces=meta["replaces"], launches=launches[meta["counter"]],
            spvcnn_launches=sum(spv_launches[k] for k in spv if k),
            cylinder_launches=sum(cyl_launches[k] for k in cyl),
            entry_launches=entry_launches[meta["counter"]],
            spvcnn_entry_launches=sum(spv_entry_launches[k] for k in spv
                                      if k),
            cylinder_entry_launches=sum(cyl_entry_launches[k] for k in cyl),
            rpvnet_launches=sum(rpv_launches[k]
                                for k in meta["rpv_counters"]),
            rpvnet_entry_launches=sum(rpv_entry_launches[k]
                                      for k in meta["rpv_counters"]),
            range_launches=sum(range_launches[k] for k in
                               (meta["counter"], meta.get("vmean_counter"),
                                *cyl) if k),
            waymo_launches=waymo_launches[meta["counter"]],
            waymo_entry_launches=waymo_entry_launches[meta["counter"]],
            yaml_launches=sum(yaml_launches.get(k, 0) for k in set(
                meta["rpv_counters"] + cyl)),
            **{f"tta{tag}_launches": sum(
                tta_launches[path][k]
                for k in set(meta["rpv_counters"] + cyl))
               for tag, path in (("", "minkunet"), ("_cylinder", "cylinder"),
                                 ("_cli", "cli"))},
            dp_launches=sum(dp_launches[k] for k in meta["rpv_counters"]),
            **{f"{col}_launches": sum(got.get(k, 0)
                                      for k in meta["rpv_counters"])
               for col, got in slice_launches.items()},
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=heavy["ms"], plain_ms=heavy["plain_ms"],
            device_ms=heavy["device_ms"], bound_ms=heavy["bound_ms"],
            bound_by=heavy["bound_by"], library_ms=heavy["library_ms"],
            shape=heavy["shape"])
        if "dfeats_source" in meta:
            row.update(dfeats_source=meta["dfeats_source"],
                       dw_launches=launches["dw"],
                       spvcnn_dw_launches=spv_launches["dw"])
        for part in ("dfeats", "dW"):
            alone = [r for r in mine if r["shape"].endswith(" " + part)]
            if alone:
                h = max(alone, key=lambda r: r["device_ms"])
                row.update({f"{part}_device_ms": h["device_ms"],
                            f"{part}_bound_ms": h["bound_ms"],
                            f"{part}_shape": h["shape"]})
        for tag, prefix in (("vmean", "voxelize_mean"), ("cylinder", "cyl"),
                            ("rpvnet", "rpv L"), ("waymo", "waymo "),
                            ("bottleneck", "bn ")):
            got = [r for r in rows if r["kernel"] == name
                   and r["shape"].startswith(prefix)]
            if got:     # the heaviest of the timed cases
                h = max((r for r in got if "device_ms" in r),
                        key=lambda r: r["device_ms"])
                row.update({f"{tag}_max_abs_err": max(
                    r["max_abs_err"] for r in got), **{
                        f"{tag}_{k}": h[k] for k in (
                            "ms", "plain_ms", "device_ms", "bound_ms",
                            "library_ms", "shape")}})
        if "vmean_counter" in meta:
            row["vmean_launches"] = spv_launches[meta["vmean_counter"]]
        kernels.append(row)
    for name, (kernel, counter, prefix) in RANGE_FUSION_ROWS.items():
        meta = KERNELS[kernel]
        mine = [r for r in rows if r["kernel"] == kernel
                and r["shape"].startswith(prefix)]
        heavy = max(mine, key=lambda r: r["device_ms"])
        kernels.append(dict(
            name=name, route=meta["route"], source=meta["source"],
            replaces=meta["replaces"], launches=rpv_launches[counter],
            entry_launches=rpv_entry_launches[counter],
            range_launches=range_launches[counter],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            **{k: heavy[k] for k in ("ms", "plain_ms", "device_ms",
                                     "bound_ms", "bound_by", "library_ms",
                                     "shape")}))
    return kernels


def ptxas_summary(text):
    """One line per kernel instance of ptxas -v output: the kernel, its
    template integers, registers, spills and static shared memory."""
    out, name, spills = [], None, ""
    for line in text.splitlines():
        m = re.search(r"entry function '(.*)'", line)
        if m:
            mangled = m.group(1)
            kern = re.search(r"([a-z_]+_kernel)", mangled).group(1)
            targs = (["bf16"] if "bfloat16" in mangled else
                     ["f32"] if kern + "If" in mangled else [])
            targs += re.findall(r"Li(\d+)E", mangled)
            name = kern + (f"<{','.join(targs)}>" if targs else "")
        elif "spill" in line and name:
            spills = line.strip()
        elif "registers" in line and name:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spills}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--report", type=Path,
                    default=ROOT / "build" / "openpcseg_torch" /
                    "chip_smoke.json", help="where the full JSON report goes")
    ap.add_argument("--phases", nargs="+", choices=PHASES, default=PHASES,
                    metavar="PHASE",
                    help="run only these phases (after the build; in the "
                    "order of PHASES, the reference process taking only "
                    "their jobs), and print no result line: "
                    + " ".join(PHASES))
    ap.add_argument("--cpu-refs", nargs="+", metavar=("DIR", "JOB"),
                    help="run as the CPU reference process: the JOBs "
                    "(REF_JOBS) into DIR; main starts it")
    args = ap.parse_args()
    if args.cpu_refs:
        return cpu_refs_main(args.cpu_refs[0], args.cpu_refs[1:])
    for phase, need in PHASE_NEEDS.items():
        if phase in args.phases and need not in args.phases:
            ap.error(f"phase {phase} reads what phase {need} writes")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    card = card_line()
    log(f"[card] {card}")
    cudnn_tf32 = torch.backends.cudnn.allow_tf32     # torch's default
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    report = {"card": card, "torch": torch.__version__}
    t_start = time.perf_counter()
    scratch = ROOT / "build" / "openpcseg_torch"
    scratch.mkdir(parents=True, exist_ok=True)
    jobs = [j for p in PHASES if p in args.phases for j in REF_JOBS.get(p, ())]
    if jobs:      # before the build
        CPU_REFS.start(scratch / f"refs_{os.getpid()}", jobs)
    try:
        return run_phases(args, report, t_start, cudnn_tf32)
    finally:
        CPU_REFS.stop()


def run_phases(args, report, t_start, cudnn_tf32) -> int:
    """The build and the phases of main() that args.phases names, the CPU
    reference process running beside them; the kernel line, the card line
    and the result line where every phase ran."""
    from openpcseg_torch.engine.task import SegTask
    from openpcseg_torch.ops import cuda_lib

    scratch = ROOT / "build" / "openpcseg_torch"
    t0 = time.perf_counter()
    cuda_lib.lib()
    log(f"[build] nvcc sm_90a build of {cuda_lib.CSRC.name}/*.cu: "
        f"{time.perf_counter() - t0:.2f} s (nvcc {cuda_lib.BUILD_INFO['seconds']:.2f} s, "
        f"cached {cuda_lib.BUILD_INFO['cached']}) -> {cuda_lib.BUILD_INFO['path']}")
    for line in ptxas_summary(cuda_lib.BUILD_INFO.get("ptxas", "")):
        log(f"[build] ptxas {line}")
    report["build_s"] = cuda_lib.BUILD_INFO["seconds"]
    want = set(args.phases)
    t_main = time.perf_counter()

    def phase_done(name):
        report.setdefault("phase_s", {})[name] = time.perf_counter() - t_main
        log(f"[time] {name} done at {report['phase_s'][name]:.1f} s after "
            f"the build")
    # mk34's kernel cases (`rows`), which the Bottleneck's and Waymo's are
    # held beside, and each phase's launches (`got`)
    rows, more_rows, got = [], [], {}
    if want & {"cases", "minkunet"}:
        task = SegTask(CFGS, NUM_CLASS, device="cuda",
                       compute_dtype=torch.bfloat16, seed=SEED)
    if "cases" in want:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        rows = kernel_phase(task, gen, report)
        rows += backward_kernel_phase(task, gen, report)
        log(f"[cases] {len(rows)} kernel cases agree with their plain "
            "versions")
        phase_done("cases")
    if "minkunet" in want:
        got["main"] = serving_phase(task, report)
        reference_phase(report)
        profile_phase(task, report)
    if want & {"cases", "minkunet"}:
        del task
    if "minkunet" in want:
        got["main"].update({k: v for k, v in training_phase(report).items()
                            if k not in FWD_COUNTERS})
        train_reference_phase(report)
        phase_done("minkunet")
    with tempfile.TemporaryDirectory(prefix="entry_", dir=scratch) as tmp:
        tree = CPU_REFS.entry_tree(tmp) if want & TREE_PHASES else None
        if "native" in want:
            native_phase(report, tmp, tree)
            phase_done("native")
        if "bottleneck" in want:
            bn_rows, got["bottleneck"], got["bottleneck_entry"] = (
                bottleneck_phases(report, tmp, tree, rows))
            more_rows += bn_rows
            phase_done("bottleneck")
        if "spvcnn" in want:
            spv_rows, got["spv"], got["spv_entry"] = spvcnn_phases(
                report, tmp, tree)
            more_rows += spv_rows
            phase_done("spvcnn")
        if "range" in want:
            got["range"] = range_phases(report, tmp, tree, cudnn_tf32)
            phase_done("range")
        if "dp" in want:
            got["dp"] = dp_phase(report, tmp, tree)
            phase_done("dp")
        if "cylinder" in want:
            cyl_rows, got["cyl"], got["cyl_entry"] = cylinder_phases(
                report, tmp, tree)
            more_rows += cyl_rows
            phase_done("cylinder")
        if "rpvnet" in want:
            rpv_rows, got["rpv"], got["rpv_entry"] = rpvnet_phases(
                report, tmp, tree, cudnn_tf32)
            more_rows += rpv_rows
            phase_done("rpvnet")
        if "entry" in want:
            got["entry"] = entry_point_phase(report, tmp, tree)
            phase_done("entry")
        if "jax_ckpt" in want:
            jax_ckpt_phase(report, tmp, tree)
            phase_done("jax_ckpt")
        if "waymo" in want:
            waymo_rows, got["waymo"], got["waymo_entry"], root = (
                waymo_phases(report, tmp, rows))
            more_rows += waymo_rows
            phase_done("waymo")
        if "yamls" in want:
            got["yaml"] = yaml_phases(report, tmp, root, tree, cudnn_tf32)
            phase_done("yamls")
        if "tta" in want:
            got["tta"] = tta_phase(report, tmp, tree, cudnn_tf32)
            phase_done("tta")
        if "loss_zoo" in want:
            got["loss_zoo"] = loss_zoo_phase(report)
            phase_done("loss zoo")
        if "loss_clis" in want:
            got["loss_cli"] = loss_cli_phase(report, tmp, tree)
            phase_done("loss CLIs")
    if "crf" in want:
        crf_phase(report, cudnn_tf32)
        phase_done("crf")
    report["total_s"] = time.perf_counter() - t_start
    args.report.parent.mkdir(parents=True, exist_ok=True)
    if want != set(PHASES):
        log(f"[time] phases {' '.join(args.phases)} took "
            f"{report['total_s']:.1f} s in all, the kernels' build included; "
            f"report in {args.report}")
        args.report.write_text(json.dumps(report, indent=1))
        return 0
    rows += more_rows
    kernels = kernel_report(
        rows, got["main"], got["entry"], got["spv"], got["spv_entry"],
        got["cyl"], got["cyl_entry"], got["range"], got["rpv"],
        got["rpv_entry"], got["waymo"], got["waymo_entry"], got["yaml"],
        got["tta"], got["dp"], {k: got[k] for k in (
            "bottleneck", "bottleneck_entry", "loss_zoo", "loss_cli")})
    log(f"[time] chip_smoke.py took {report['total_s']:.1f} s in all, the "
        f"kernels' build included")
    args.report.write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
