#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--report PATH] [--cases-only]

The main paths are the eval and train steps of MinkUNet mk34_cr10 (the
MODEL and OPTIM blocks of tools/cfgs/voxel/semantic_kitti/
minkunet_mk34_cr10.yaml), of SPVCNN mk34_cr10 (tools/cfgs/fusion/
semantic_kitti/spvcnn_mk34_cr10.yaml) and of Cylinder3D cy480_cr10
(tools/cfgs/voxel/semantic_kitti/cylinder_cy480_cr10.yaml), at full
width, with weights drawn
from a seeded torch.Generator, on 131,072-point ray-cast scans, computing
in bfloat16 through eight hand-written CUDA kernels (openpcseg_torch/csrc):

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
(K8 back; the vmean counters).

Phases, in order (any failure exits non-zero and prints no result line):
  1. the card's name and power limit; TF32 off for matmuls and cuDNN;
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
     weights on an 8192-point scan and on nine feature-perturbed copies
     of it, GPU (bf16, kernels) against CPU (float32, plain versions):
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
     --save_pred --save_raw_ids.
Every kernel case carries CUDA-event ms of the wrapper and of the plain
version, the kernel's profiler device ms, and its bound (bound_ms: bytes
over the memory rate or operations over the peak rate, whichever is
larger, from the case's own shapes and hits; a profiler window that
reads less than the bound is taken again); K7 and
K8 also the time of torch.sparse.mm over the same table as a CSR matrix (library_ms), which the port never calls.
With --cases-only the script stops after the kernel and backward-kernel
cases (the kernel half of an A/B call). Then the kernel JSON line, the
card line and the result line.
The full report (every kernel case, request, step and profiler row) goes
to --report, by default build/openpcseg_torch/chip_smoke.json.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import inspect
import json
import re
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
for _name, _cyl in (("K1_subm_conv", ("subm",)),
                    ("K2_subm_conv_bwd", ("subm_bwd", "dw")),
                    ("K3_down_conv", ("strided",)), ("K4_up_conv", ()),
                    ("K5_up_conv_bwd", ("strided_bwd", "strided_dw")),
                    ("K6_down_conv_bwd", ()), ("K7_devoxelize", ("vmean_bwd",)),
                    ("K8_devoxelize_bwd", ("vmean",))):
    KERNELS[_name]["cyl_counters"] = _cyl
SUBM_PAIRS = [(0, 4, 32), (0, 32, 32), (1, 32, 32), (2, 32, 64), (2, 64, 64),
              (3, 64, 128), (3, 128, 128), (4, 128, 256), (4, 256, 256),
              (3, 384, 256), (3, 256, 256), (2, 192, 128), (2, 128, 128),
              (1, 128, 96), (1, 96, 96), (0, 128, 96), (0, 96, 96)]
DOWNS = [(1, 32), (2, 32), (3, 64), (4, 128)]          # (coarse level, C)
UPS = [(3, 256, 256), (2, 256, 128), (1, 128, 96), (0, 96, 96)]  # fine lvl
DEVOX = [(4, 256), (2, 128)]
DEVOX_CHUNKS = (16, 32, 64, 128)  # K8 segment lengths timed per DEVOX case


def log(*a):
    print(*a, flush=True)


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


def kernel_cases(pyr, gen):
    """The forward kernels' cases at main-path shapes: every channel pair
    the mk34 forward gives each kernel, on the levels where it gives it,
    with seeded bf16 features (zero on padding rows)."""
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
    for level, cin, cout in SUBM_PAIRS:
        args = (feats(level, cin), weight(27, cin, cout),
                pyr.levels[level].subm_kmap)
        cases.append(case("K1_subm_conv", f"L{level} {cin}->{cout}",
                          subm_conv.subm_conv, subm_conv.subm_conv_plain,
                          args, gemm_work(*args)))
    for level, c in DOWNS:
        args = (feats(level - 1, c), weight(8, c, c),
                pyr.levels[level].down_kmap)
        cases.append(case("K3_down_conv", f"L{level - 1}->L{level} {c}->{c}",
                          updown.down_conv, updown.down_conv_plain, args,
                          gemm_work(*args)))
    for level, cin, cout in UPS:
        plan = pyr.levels[level + 1].parity_plan
        args = (feats(level + 1, cin), weight(8, cin, cout),
                pyr.levels[level].up_kmap, plan)
        cases.append(case("K4_up_conv", f"L{level + 1}->L{level} "
                          f"{cin}->{cout}", updown.up_conv, up_plain, args,
                          parent_work(args[0], args[1], plan),
                          zero_rows=parentless_rows(plan)))
    for level, c in DEVOX:
        tbl = pyr.devox[level]
        args = (feats(level, c), tbl.idx, tbl.weights)
        m = devox_csr(tbl.idx, tbl.weights, pyr.levels[level].capacity)
        cases.append(case("K7_devoxelize", f"L{level} C={c}",
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
                     f"{bound_by}) plain {row['plain_ms']:.4f} ms{lib}")
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
    from openpcseg_torch.data.raycast import raycast_batch
    from openpcseg_torch.engine.task import batch_to_device

    b = batch_to_device(raycast_batch(SEED, 1, cap=N_POINTS), "cuda")
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
    from openpcseg_torch.data.raycast import raycast_batch
    from openpcseg_torch.engine.task import batch_to_device
    from openpcseg_torch.ops import cuda_lib

    scans = [raycast_batch(SEED + 1 + i, 1, cap=N_POINTS)
             for i in range(REQUESTS + 1)]
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
        if tuple(pred.shape) != (1, N_POINTS) or int(pred.min()) < 0 or int(
                pred.max()) >= NUM_CLASS:
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
    cpu = SegTask(cfgs, NUM_CLASS, device="cpu", **task_kw)
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
    from openpcseg_torch.data.raycast import raycast_batch
    from openpcseg_torch.engine.task import SegTask, batch_to_device

    scan = raycast_batch(SEED, 1, cap=8192)
    logits = {}
    for dev, dt in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        t = SegTask(cfgs, NUM_CLASS, device=dev, compute_dtype=dt,
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
    from openpcseg_torch.data.raycast import raycast_batch
    from openpcseg_torch.engine.task import batch_to_device

    b = batch_to_device(raycast_batch(SEED + 1, 1, cap=N_POINTS), "cuda")
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
    return {"devox": "K7", "devox_bwd": "K8", "vmean": "K8 vmean",
            "vmean_bwd": "K7 vmean"}[family]


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


def backward_cases(pyr, gen):
    """The backward kernels' cases at the shapes the mk34 training step
    gives them: upstream gradients in float32 (zero on padding rows, as
    the masked forward leaves them), saved bf16 activations, float32
    weights. K2, K5 and K6 run whole (dfeats and dW) and each pass alone
    (labels "... dfeats" and "... dW"), on the operands the whole backward
    hands it: dout cast to bf16, W^T in bf16."""
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
    for level, cin, cout in SUBM_PAIRS:
        lv = pyr.levels[level]
        label = f"L{level} {cin}->{cout}"
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
    for level, c in DOWNS:
        fine, coarse = pyr.levels[level - 1], pyr.levels[level]
        plan = coarse.parity_plan
        label = f"L{level - 1}->L{level} {c}->{c}"
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
    for level, cin, cout in UPS:
        fine, coarse = pyr.levels[level], pyr.levels[level + 1]
        label = f"L{level + 1}->L{level} {cin}->{cout}"
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
    for level, c in DEVOX:
        tbl = pyr.devox[level]
        d = torch.randn(tbl.idx.shape[1], c, device="cuda", generator=gen)
        d = torch.where(pyr.points.valid[:, None], d, 0.0).to(bf)
        cases.append(case("K8_devoxelize_bwd", f"L{level} C={c}",
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
    from openpcseg_torch.data.raycast import raycast_batch
    from openpcseg_torch.engine.task import batch_to_device

    b = batch_to_device(raycast_batch(SEED, 1, cap=N_POINTS), "cuda")
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
    from openpcseg_torch.data.raycast import raycast_batch
    from openpcseg_torch.engine.task import SegTask, batch_to_device
    from openpcseg_torch.ops import cuda_lib

    need = need or MINK_COUNTERS
    task = SegTask(cfgs, NUM_CLASS, device="cuda",
                   compute_dtype=torch.bfloat16, seed=SEED,
                   iters_per_epoch=ITERS_PER_EPOCH)
    scan = raycast_batch(SEED + 1, 1, cap=N_POINTS)
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


def train_ref_draws():
    """The training reference's inputs, numpy batches: the 8192-point
    ray-cast scan of SEED, then TRAIN_REF_DRAWS - 1 copies of it with its
    features scaled by 1 + TRAIN_REF_NOISE * N(0, 1) (seeded). Each is one
    draw of bf16's rounding over the same geometry."""
    from openpcseg_torch.data.raycast import raycast_batch

    scan = raycast_batch(SEED, 1, cap=8192)
    rng = np.random.default_rng(SEED)
    draws = [scan]
    for _ in range(TRAIN_REF_DRAWS - 1):
        noise = 1 + TRAIN_REF_NOISE * rng.standard_normal(scan["feats"].shape)
        draws.append(dict(scan, feats=(scan["feats"] * noise).astype(
            np.float32)))
    return draws


def seed_weights(model, seed):
    """Overwrite `model`'s conv, classifier and point-MLP (every other
    Linear) weights (in that order) with draws of numpy's
    generator seeded with `seed`, at the scale of the model's own
    initializer (a unit normal truncated to [-2, 2], times sqrt(1 / fan-in)
    over that normal's std): the same weights on every machine, whatever
    torch's own initializer draws there. Norm layers keep 1 and 0."""
    from openpcseg_torch.models.layers import SparseConv

    rng = np.random.default_rng(seed)

    def trunc(shape, fan_in):
        z = rng.standard_normal(shape)
        bad = np.abs(z) > 2
        while bad.any():
            z[bad] = rng.standard_normal(int(bad.sum()))
            bad = np.abs(z) > 2
        return torch.from_numpy(z * (1.0 / fan_in) ** 0.5
                                / 0.87962566103423978)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, SparseConv):
                m.weight.copy_(trunc(m.weight.shape, m.fan_in))
        head = getattr(model, "classifier", None)
        if head is not None:
            head.weight.copy_(trunc(head.weight.shape, head.weight.shape[1]))
        for m in model.modules():     # SPVCNN's and Cylinder3D's Linears
            if isinstance(m, torch.nn.Linear) and m is not head:
                m.weight.copy_(trunc(m.weight.shape, m.weight.shape[1]))


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


def step_against_cpu(cfgs, batch, weights_seed=None, cpu_tables=False,
                     **task_kw):
    """One train_step of the same weights on the numpy `batch`: the card
    (bf16, kernels) against the CPU (float32, plain versions). The weights
    are SegTask's seeded ones, or seed_weights(`weights_seed`); with
    `cpu_tables` the card takes the CPU's tables (tables_from_cpu).
    Returns the losses, |loss_gpu - loss_cpu| / |loss_cpu|, the cosine of
    the whole gradient vector and each conv weight gradient's cosine."""
    from openpcseg_torch.engine.task import SegTask, batch_to_device
    from openpcseg_torch.models.layers import SparseConv

    runs = [("gpu", "cuda", torch.bfloat16), ("cpu", "cpu", torch.float32)]
    loss, grads, convs, secs = {}, {}, None, {}
    for tag, dev, dt in runs:
        t0 = time.perf_counter()
        t = SegTask(cfgs, NUM_CLASS, device=dev, compute_dtype=dt, seed=SEED,
                    **task_kw)
        if cpu_tables and dev == "cuda":
            tables_from_cpu(t, cfgs, **task_kw)
        if weights_seed is not None:
            seed_weights(t.model, weights_seed)
        m = t.train_step(batch_to_device(batch, dev))
        loss[tag] = float(m["loss"])
        # the clipped gradients stay in .grad; a cosine ignores the scale
        grads[tag] = {n: p.grad.double().cpu().reshape(-1)
                      for n, p in t.model.named_parameters()}
        convs = [n + ".weight" for n, mod in t.model.named_modules()
                 if isinstance(mod, SparseConv)]
        secs[tag] = time.perf_counter() - t0
        del t

    def cos(a, b):
        return float(a @ b / (a.norm() * b.norm()).clamp(min=1e-300))

    g, r = grads["gpu"], grads["cpu"]
    return dict(loss_gpu=loss["gpu"], loss_cpu=loss["cpu"], seconds=secs,
                loss_rel=abs(loss["gpu"] - loss["cpu"]) / abs(loss["cpu"]),
                cos_all=cos(torch.cat([g[n] for n in r]),
                            torch.cat(list(r.values()))),
                cos_conv={n: cos(g[n], r[n]) for n in convs})


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


def train_reference_phase(report, model="MinkUNet", cpu_tables=False):
    """One train_step of `model` from the weights seed_weights(SEED) on each
    of the draws of train_ref_draws: GPU (bf16, kernels) against CPU
    (float32, plain versions), held to the rule over the draws that JAX's
    reading sets (train_ref_rule: the mean loss difference, each draw's
    cosine row) and to TRAIN_GROSS, beside JAX's and the CPU bf16 readings
    of the same draw. The draws and weights must be those the readings
    were taken on (the model's digest in TRAIN_REF_MODELS)."""
    from openpcseg_torch.engine.task import SegTask

    cfgs, inputs, jax_reading, port_reading, key, tag = TRAIN_REF_MODELS[
        model]
    loss_mean, ref = train_ref_rule(jax_reading)
    floor = train_ref_floor(jax_reading)
    draws = train_ref_draws()
    net = SegTask(cfgs, NUM_CLASS, device="cpu",
                  voxel_cap_per_scan=8192).model
    seed_weights(net, SEED)
    digest = inputs_digest(draws, net)
    log(f"[{tag}] {model} draws and weights: digest {digest} (JAX's "
        f"reading was taken on {inputs})")
    if digest != inputs:
        raise SystemExit(f"{tag} phase: the draws or weights differ from "
                         "those of JAX's reading")
    rows, misses = [], []
    for i, draw in enumerate(draws):
        r = step_against_cpu(cfgs, draw, weights_seed=SEED,
                             cpu_tables=cpu_tables, voxel_cap_per_scan=8192,
                             iters_per_epoch=ITERS_PER_EPOCH)
        misses += hold_step(f"{tag} draw {i}", r, (floor[0],) + ref[i])
        log(f"[{tag} draw {i}] JAX bf16 vs f32 {jax_reading[i]}, port CPU "
            f"bf16 vs f32 {port_reading[i]}")
        rows.append(r)
    means, sd = {}, {}
    for name, vals in (("card", [r["loss_rel"] for r in rows]),
                       ("jax", [r[0] for r in jax_reading]),
                       ("port_cpu_bf16", [r[0] for r in port_reading])):
        means[name], sd[name] = statistics.fmean(vals), statistics.stdev(vals)
    log(f"[{tag}] mean relative loss difference over {len(rows)} draws: "
        f"card {means['card']:.4e} (bound {loss_mean:.4e}, twice JAX's "
        f"{means['jax']:.4e}), port CPU bf16 {means['port_cpu_bf16']:.4e}; "
        f"standard deviations card {sd['card']:.4e}, JAX {sd['jax']:.4e}, "
        f"port CPU bf16 {sd['port_cpu_bf16']:.4e}")
    if means["card"] > loss_mean:
        misses.append(f"mean loss rel {means['card']:.4e} beyond "
                      f"{loss_mean:.4e}")
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


def entry_reference(cfgs, batch, report):
    """The entry phase's own batch on the card, after its counters are
    read: one train step against the CPU float32 reference, held to
    TRAIN_REF_LOSS_MEAN and the strictest cosine rows of TRAIN_REF (no JAX
    reading exists at this size), then every forward and backward kernel
    case, untimed, on the pyramid of that batch."""
    from openpcseg_torch.engine.task import SegTask, batch_to_device

    strict = (TRAIN_REF_LOSS_MEAN, max(r[0] for r in TRAIN_REF),
              max(r[1] for r in TRAIN_REF))
    step = step_against_cpu(cfgs, batch, batch_per_device=ENTRY_BATCH)
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
    argv = ["--cfg_file", str(ROOT / ENTRY_CFG), "--log_dir",
            f"{tmp}/logs", "--extra_tag", "chip_smoke", "--batch_size",
            str(ENTRY_BATCH), "--log_interval", "1"]
    sets = ["--set", "DATA.DATA_PATH", tree]
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
    miou = evals[-1]["val_miou"] if evals else float("nan")
    log(f"[entry] train CLI, batch {ENTRY_BATCH}: step ms {med:.1f} (median "
        f"of {len(step_ms)}: {', '.join(f'{t:.1f}' for t in step_ms)}), "
        f"{ENTRY_BATCH * 1e3 / med:.2f} scans/s, val mIoU {miou:.2f}; "
        f"{wall:.1f} s for train, resume and infer; launches {launches}")
    report["entry_point"] = dict(
        steps=steps, evals=evals, checkpoints=ckps, dumped=dumped,
        step_ms_median=med, scans_per_s=ENTRY_BATCH * 1e3 / med,
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
    from openpcseg_torch.data.raycast import raycast_batch
    from openpcseg_torch.engine.task import SegTask, batch_to_device
    from openpcseg_torch.ops import cuda_lib

    task = SegTask(SPV_CFGS, NUM_CLASS, device="cuda",
                   compute_dtype=torch.bfloat16, seed=SEED)
    launches = serving_phase(task, report, "spv-serve",
                             FWD_COUNTERS + ("vmean",), "spvcnn_")
    reference_phase(report, SPV_CFGS, "spvcnn_reference")
    profile_phase(task, report, "spvcnn_")
    _, pyr = task.preprocess(batch_to_device(
        raycast_batch(SEED, 1, cap=N_POINTS), "cuda"))
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
    from openpcseg_torch.data.raycast import raycast_batch
    from openpcseg_torch.engine.task import batch_to_device

    m = task.model.eval()
    with torch.no_grad():
        vb, pyr = task.preprocess(batch_to_device(
            raycast_batch(SEED + 1, 1, cap=N_POINTS), "cuda"))
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
    from openpcseg_torch.data.raycast import raycast_batch
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
        raycast_batch(SEED, 1, cap=N_POINTS), "cuda"))
    log(f"[cyl-kernels] pyramid of scan {SEED}: voxels per level "
        f"{pyr.level_counts.tolist()}, caps {task.caps}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    rows = check_cases(cylinder_cases(pyr, gen), "cyl-kernels")
    report["cylinder_cases"] = rows
    scatter_max_check(pyr, report)
    del task, pyr
    moved = cells_moved(CYL_CFGS, raycast_batch(SEED, 1, cap=8192))
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


def kernel_report(rows, launches, entry_launches, spv_launches,
                  spv_entry_launches, cyl_launches, cyl_entry_launches):
    """The kernels JSON line: per kernel its launches on the main paths
    (MinkUNet's serving and training phases, SPVCNN's, whose K7 and K8
    also count the launches of its mean-voxelize, and Cylinder3D's), over
    the entry-point phases, and the MinkUNet case with the slowest plain
    version (the whole backward for K2, K5 and K6, beside the device times
    of their heaviest dfeats and dW passes alone), with its bound and, for
    K7 and K8, the library call's time; K7 and K8 also their heaviest
    mean-voxelize case; and Cylinder3D's heaviest case of the kernel
    (K1 / K2 its submanifold convs, K3 / K5 its k3 strided convs' forward /
    backward, K7 / K8 its refinement gather / its backward)."""
    kernels = []
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name
                and not r["shape"].startswith(("voxelize_mean", "cyl"))]
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
        for tag, prefix in (("vmean", "voxelize_mean"), ("cylinder", "cyl")):
            got = [r for r in rows if r["kernel"] == name
                   and r["shape"].startswith(prefix)]
            if got:
                h = max(got, key=lambda r: r["device_ms"])
                row.update({f"{tag}_max_abs_err": max(
                    r["max_abs_err"] for r in got), **{
                        f"{tag}_{k}": h[k] for k in (
                            "ms", "plain_ms", "device_ms", "bound_ms",
                            "library_ms", "shape")}})
        if "vmean_counter" in meta:
            row["vmean_launches"] = spv_launches[meta["vmean_counter"]]
        kernels.append(row)
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
    ap.add_argument("--cases-only", action="store_true",
                    help="build, run the forward and backward kernel cases "
                    "(checks and times) and stop: the part of an A/B call "
                    "that compares kernels; prints no result line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from openpcseg_torch.engine.task import SegTask
    from openpcseg_torch.ops import cuda_lib

    card = card_line()
    log(f"[card] {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    report = {"card": card, "torch": torch.__version__}

    t0 = time.perf_counter()
    cuda_lib.lib()
    log(f"[build] nvcc sm_90a build of {cuda_lib.CSRC.name}/*.cu: "
        f"{time.perf_counter() - t0:.2f} s (nvcc {cuda_lib.BUILD_INFO['seconds']:.2f} s, "
        f"cached {cuda_lib.BUILD_INFO['cached']}) -> {cuda_lib.BUILD_INFO['path']}")
    for line in ptxas_summary(cuda_lib.BUILD_INFO.get("ptxas", "")):
        log(f"[build] ptxas {line}")
    report["build_s"] = cuda_lib.BUILD_INFO["seconds"]

    task = SegTask(CFGS, NUM_CLASS, device="cuda",
                   compute_dtype=torch.bfloat16, seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = kernel_phase(task, gen, report)
    if args.cases_only:
        rows += backward_kernel_phase(task, gen, report)
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=1))
        log(f"[cases] {len(rows)} kernel cases agree with their plain "
            f"versions; report in {args.report}")
        return 0
    launches = serving_phase(task, report)
    reference_phase(report)
    profile_phase(task, report)
    rows += backward_kernel_phase(task, gen, report)
    del task
    launches.update({k: v for k, v in training_phase(report).items()
                     if k not in FWD_COUNTERS})
    train_reference_phase(report)
    scratch = ROOT / "build" / "openpcseg_torch"
    scratch.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="entry_", dir=scratch) as tmp:
        tree = write_entry_tree(tmp)
        entry_launches = entry_point_phase(report, tmp, tree)
        spv_rows, spv_launches, spv_entry_launches = spvcnn_phases(
            report, tmp, tree)
        cyl_rows, cyl_launches, cyl_entry_launches = cylinder_phases(
            report, tmp, tree)
    rows += spv_rows + cyl_rows

    kernels = kernel_report(rows, launches, entry_launches, spv_launches,
                            spv_entry_launches, cyl_launches,
                            cyl_entry_launches)
    args.report.parent.mkdir(parents=True, exist_ok=True)
    args.report.write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
