#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases (each prints its own lines; any failure raises and exits non-zero):

1. environment — torch/CUDA versions, the card's name and power limit;
   TF32 off for cuDNN convs and matmuls (float32 references stay float32);
2. build — ``nvcc`` compiles ``bodyct_dram_emph_subtype_tpu_torch/csrc``
   for sm_90a (cached under ``build/kernels`` by source hash) and prints,
   from ``ptxas -v``, each kernel's registers, spill bytes and static
   shared memory, with the dynamic shared memory of the bf16 tensor-core
   instantiations (``*_mma_kernel``: the cp.async ring and the float32
   sums; for E its weights, plane ring and stem tile);
3. kernels vs their plain PyTorch versions at every deployment site shape
   of the med3ddram forward (B=2, 128x224x288 input), float32 and
   bfloat16, plus one small ragged shape each: max/mean |delta| against the
   bound, and the median time of kernel and plain version (CUDA events).
   Bounds (set from the first H100 run, which measured at most 0.11 /
   0.5 / 0.018 / 0.09 of the issue's looser ones): A float32 max|d| <=
   2e-5*max|ref|; A bf16 <= 2 bf16 ulps of each reference value (measured:
   exactly 1 ulp, a rounding split of two float32 sums; the second ulp
   covers values near zero, where float32 order noise of up to 1.8e-5 at
   us1.conv0 nears one ulp of the 2^-10-of-peak floor); B float32 max|d|
   <= 1e-5*max|ref|; B bf16 maps max|d| <= 5e-3 and mean <= 1e-6; C
   bit-equal;
3b. the training kernels vs their plain versions at every site of
   ``TRAIN_ROLL_SITES`` (the B=2 med3ddram train step at 128x224x288,
   float32 and bfloat16) plus one ragged shape: kernel D (weight gradient)
   against ``conv3x3x3_wgrad_plain`` (cuDNN wgrad in float32 of the exactly
   widened operands; D writes float32 for both input dtypes, bound max|d|
   <= 5e-5*max|ref|; the first card run measured at most 0.48 of it, at
   us1.conv0's 258 k-voxel sums) and bit-equal on a second run; the dgrad
   (kernel A on the flipped, I/O-transposed weights) against
   ``conv3x3x3_dgrad_plain`` (A's bounds: float32 2e-5*max|ref|, measured
   at most 0.13 of it; bf16 2 bf16 ulps, measured exactly one); and the
   forward of ``roll_conv_packed`` (kernel A, identity epilogue) against
   the float32 conv rounded once, in A's bounds;
3d. kernel F (``masked_sums``, the lung-masked sums) against its plain
   version at its three sites (the model's lesion fractions and the device
   path's reduction on (2, 64, 112, 144, 2) maps, the host path's predict
   step on (2, 128, 224, 288, 2)), a ragged C = 3 and a C = 1 shape, with
   float32 maps and bf16 maps (which the kernel reads as bf16): the masked
   sums of kernel and plain version within 1e-5 relative of a float64
   sum, the lung sums equal to the voxel count, the kernel bit-equal on a
   second run; times per call from one CUDA graph of 20 calls that cycle
   through copies of the inputs holding at least twice the 50 MB L2
   cache, so each call reads from device memory and the times are the
   device's, without the launch overhead that a single replay of a
   graph holds (the time of one Python call of the kernel's wrapper, L2
   flushed, is printed beside them); the share of the byte bound per
   site and per device-path batch; and ``torch.profiler``'s count and
   device time of the kernels of 10 calls, which must be 10 kernel-F
   kernels (one launch per call).  ``--masked-sums-only`` runs phases 1,
   2 and 3d alone: a copy of this script in another checkout times that
   checkout's kernel F the same way, so two versions compare in one run;
4. main path — three synthetic scans through ``run_inference`` (med3ddram,
   bf16, batch 2, seeded random weights), output contract checked, kernel
   launch counts checked per batch (the forward's, plus one kernel-F call
   for the reduction), scans/s and per-stage times; the upload: bytes per
   scan of the block-gated 10-bit CT stream, its gate bits and the lung
   bits (checked against ``stats["upload_bytes"]``) beside the int16
   planes + uint8 lung of the ungated upload, the host-clock ms of the
   packing per batch, and for the first batch the card's
   ``unpack10_gated_device`` equal bit for bit to ``clip(image_raw, -1150,
   -300)`` as float32 and to the CPU unpack; then the tiny model on the
   card against its CPU plain path;
5. bf16 vs float32 forward of the same weights on one scan;
6. training path — a synthetic ``.npz`` archive of 4 scans (int16 CT with a
   lung ellipsoid, stored 180x320x320) through the trainer in-process
   (med3ddram, bf16, B=2, the packed decoder, one epoch of 4 steps,
   augmentation on), then
   ``restore_best`` and a test evaluation over the archive: finite losses,
   params and BN running statistics moved, 22 kernel-A and 11 kernel-D
   launches (no B or C) in every train step, the eval launch counts, a
   checkpoint that ``try_resume`` reloads; ms per step, volumes/s, peak
   device memory and one step split into loader wait, augment, forward,
   backward and optimizer (CUDA events); then "train -> deploy":
   ``build_model(ckp_path=<the trainer's checkpoints directory>)``
   restores the newest epoch, and its lesion fractions on phase 4's scan0
   are bit-equal to ``run_inference`` of the trainer's restored model;
6b. one med3ddramtiny train step (float32, augment off) on the card with
   its kernels against the CPU plain path, same weights and batch: loss
   |d| <= 1e-4 relative; each gradient ||d||/||g|| <= 5e-3 and max|d| <=
   2e-2 of its peak (measured on the first card runs: 2.1e-3 and 8.8e-3
   at worst; float32 order noise of cuDNN vs CPU convs, amplified by the
   train BatchNorms' backward, whose E[x^2] - mean^2 variance cancels; the
   decoder conv biases ahead of a train BN, whose gradient is zero in
   exact arithmetic, are not compared); BN running statistics <= 1e-4
   relative.  Run once in each conv mode (``roll``: 14 A + 7 D launches;
   ``pallas``, ``tapmm`` (on a 128-wide input: its JAX gate refuses rows
   under 24) and ``flat``: one kernel-A launch per ``mode_conv_sites``
   site, no D, the backward on cuDNN), same bounds;
3c. the opt-in kernels vs their plain versions at the B=2 bf16 deployment
   shapes, float32 and bfloat16, plus one ragged shape each: kernel E
   (stem conv + BN + ReLU + pool, ``fused_stem_pool``) at the stem, and
   kernel A with an identity epilogue at every site of the conv modes
   ``pallas``, ``tapmm`` and ``flat`` (layer1, layer2, and the dilated
   layer3 (d=2) and layer4 (d=4) convs on the logical tensor); A's bounds
   for both (the stem's and the pooled output each);
4c. the processor in the conv modes ``pallas``, ``tapmm`` and ``flat``
   and with the quad stem on: ``run_inference`` over one batch of 2 scans
   each (launches per batch: A 26 / 13 / 18 and no B or C; quad: E 1,
   A 16, B 1, C 0; F 2 in each), and the B=2 bf16 forward's maps and
   lesion fractions
   against the default path's on the same weights and scans within the
   bf16 bounds of ``tests/test_composed_oracle.py:246-262`` (fractions
   |d| < 5e-3, map mean |d| < 1.5e-2, flip rate (|d| > 0.5) < 5e-3); the
   mode and the switch are restored afterwards;
4d. the host-preprocess path (``run_inference(device_preprocess=False)``,
   med3ddram, bf16, batch 2) over phase 4's scans: output contract, per
   batch A 16, B 1, C 1, F 2, every scan in ``stats["host_scans"]``, and
   against phase 4's device path the bf16 bounds above (lesion fractions,
   and the written uint8 heatmaps read as count / 255 over the voxels
   either map marks); one scan in float32 on both paths (the float32
   processor builds the unpacked decoder: per batch A 12, C 1, F 2, no
   B): fractions |d| <=
   2e-3 (the JAX package's bound, ``tests/test_processor.py:124-126``),
   heatmaps within one count on under 1 % of the voxels; then the per-scan
   fallback at the default ``pad_shape``: a fourth scan whose lung crop is
   wider than 384 columns runs the host path alone, the other three the
   device path, results in cohort order; peak device memory;
4e. the gated stream's overflow: phase 4's scans with a ``gated_frac`` whose
   budget lies between the largest and the second-largest live block
   count, so that exactly one scan exceeds it: a warning names that scan,
   ``stats["host_scans"]`` lists it alone, the results keep cohort order,
   launches per batch as phase 4 (2 device-path batches + 1 host), and
   every scan's fractions and heatmaps hold phase 4d's bf16 bounds
   against phase 4's device path;
4f. the processor as two ranks: phase 4's weights saved as ``.npz``, then
   the CLI (``python -m bodyct_dram_emph_subtype_tpu_torch.inference
   --ngpus 2 --ckp <npz> --compute_dtype bfloat16 --batch_size 2``) in a
   child process, whose ranks ``spawn_ranks`` starts (on one card they
   share ``cuda:0`` over gloo; on a host with two or more cards they take
   ``cuda:0`` and ``cuda:1`` over NCCL); rank 0 prints the run's
   statistics, which hold every rank's.  Three scans on two ranks: rank 0
   scores scan0 and scan2, rank 1 scan1 and its padding, scan0, which it
   does not write.  Checks: the output contract, ``results.json``'s order
   and the score JSONs equal to phase 4's, the ranks' finalized scans the
   three uids with no overlap, fractions and heatmaps in phase 4d's bf16
   bounds against phase 4 (the measured max printed), each rank's
   launches phase 4's per-batch counts times its batches.  Printed: the
   launch's wall (process start-up, the library load and the model build
   inside it), each rank's ``pipeline_s``, scans/s by the slowest rank's
   pipeline and by the wall, the host's cores;
6c. two trainer steps in conv mode ``pallas`` (med3ddram, bf16, B=2, the
   unpacked decoder, phase 6's archive): 31 kernel-A launches in every
   step, no D, B or C, finite losses; step ms and peak device memory;
6d. the trainers' default routing: two trainer steps of med3ddram with
   ``packed_decoder`` left at its default, False (bf16, B=2, conv mode
   roll): per step A 12, D 6 (layer1's six convs, as in the JAX train
   step), F 1, no B or C; a test evaluation with A 12, C 1, F 1 and no B
   per forward; step ms and peak device memory;
6e. med3ddram50, the training CLI's default arch: kernel D, the dgrad and
   the forward on A at its five train sites (bf16; us1.conv0 takes C =
   2048 + 256 = 2304: D one split of 8064 K steps, A's forward 1944 K
   steps in the 64-column tile) against their plain versions in phase 3b's
   bounds, and A with the BN epilogue at that conv's eval site; then two
   trainer steps (bf16, B=2, packed decoder): per step A 10, D 5, F 1; a
   test evaluation with C 1, A 4, B 1, F 1 per forward; step ms and peak
   device memory;
6f. the device input pipeline: a synthetic ``.npz`` archive of 4 scans of
   differing extents (the largest 180x320x320); the card's
   ``fused_preprocess`` of each scan (padded to 192x320x320) against the
   host ``preprocess_sample`` (image max|d| <= 1e-4, the JAX package's
   bound; lung and LAA masks bit-equal) and against the CPU
   ``fused_preprocess`` (<= 1e-5, masks bit-equal), and its time per batch
   of 2; then the trainer on each pipeline (med3ddram, bf16, B=2, packed
   decoder, one epoch of 4 steps, ``--input_pipeline device --pad_shape
   192,320,320`` and the host pipeline): per step A 22, D 11, F 1, ms per
   step (median without the first), volumes/s, loader wait per step, the
   last step's split (preprocess on the device pipeline, augment,
   forward, backward, optimizer) and peak memory; a test evaluation
   through each pipeline's eval step (the device pipeline's fused eval
   step) at the eval launch counts; and the device-pipeline model's
   forward on both pipelines' test inputs: labels equal, lesion fractions
   within 5e-3.

7. the classification strategy (med3d, resnet34segcls, n_classes (6, 3),
   bf16, B=2, 128x224x288): (a) med3d's eval us3 (conv 64 -> 32 + BN +
   ReLU on kernel A, a site the dRAM forward runs on B) is in phase 3's
   list, in A's bounds; (b) a synthetic archive of phase 6's 4 scans
   written as reference ``.pth`` caches (``torch.save``) through the
   trainer (packed decoder, one epoch of 4 steps, augmentation on):
   finite losses, params and BN running statistics moved, per step A 22
   and D 11 (``train_roll_sites``) and no B, C or F, the class weights at
   the epoch end equal to ``reweight_classes`` of the sampler's weights
   and the epoch's train predictions (each summing to 1 where it
   changed) in the trainer and the checkpoint, ms per step, volumes/s,
   peak memory and one step split; (c) the evaluation entry point
   (``evaluate.__main__.main(argv)`` in-process) on that checkpoint by
   epoch number and by path: equal metrics, per forward C 1 and A 17
   (``roll_eval_sites(kind="cls")``), no B or F; (f) the bf16 and float32
   forward of the trained model on one test batch: the pooled logits'
   max|d| over max|logit| <= 2.5e-2 (the first card run measured 9.0e-3)
   and the share of equal argmax labels (printed: 4/4 there); (d) the
   trainers' default routing (``packed_decoder`` False): two steps at A
   12, D 6 and a test evaluation at A 12, C 1 per forward; (e, after
   phase 6b) one med3dtiny train step (float32, augment off) on the card
   against the CPU plain path, same weights and batch, in phase 6b's
   bounds;
8. data parallelism on the card: two ranks share the one H100, each
   started as ``chip_smoke.py --ddp-rank`` with torchrun's environment
   (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE`` and ``LOCAL_WORLD_SIZE`` 2,
   ``MASTER_ADDR``, ``MASTER_PORT``) and the training CLI's flags with
   ``--multihost``, which puts two local ranks on one card over gloo
   (NCCL refuses two ranks on one device), through
   ``train.__main__``'s ``distributed`` and ``make_config``: med3ddram,
   bf16, packed decoder, 128x224x288, B=1 per rank, phase 6's archive,
   ``sampler_seed`` 0, lr 1e-6, one epoch of 2 steps, augmentation on,
   then the best epoch's test evaluation.  The dRAM heads are scaled as
   in ``tests/test_torch_train_step.py`` (``condition_heads``: at the
   seed's init the saturated maps make the coverage loss's clamp turn
   rounding noise into whole gradient flips, 0.6-1.2 of ||g|| even
   between the card and the CPU in float32).  Each rank's per-step
   launches are A 22, D 11, F 1 (a rank that fails a check exits
   non-zero, and so does this script).  Held against one process at B=2
   with ``num_data_shards=2`` on the same weights, batches and
   augmentation draws: each step's loss and components within 1e-3
   relative (the first card run: 6.8e-5); the first step's gradients,
   ||d|| / ||g|| per tensor (median and max), no more than twice the one
   process's own bf16 noise floor (its bf16 step against its float32
   step on the same batch; two independent bf16 roundings differ by about
   sqrt(2) of one; measured in the same run, since the DDP spread, about
   3.7e-2 median, lies inside bf16's own 4.9e-2 and no fixed bound
   could tell a fault from rounding); the
   median element of rank 0's checkpoint within ``0.05 * lr`` of the one
   process's parameters (the max is printed, not held: Adam moves an
   element whose gradient lies within noise of zero by up to lr either
   way each step, so 2 lr per step is its reach, not a bound); the
   test labels equal and the lesion fractions within 5e-3 (the bf16
   bound); the CSVs, ``metrics.jsonl`` (one line per phase) and the one
   checkpoint written once, by rank 0.  This proves the path; it is not a
   timing (gloo stages the 64,789,730 float32 gradients, 259 MB, through
   the host each step).  ``--ddp-only`` runs phases 1, 2, 4, 4f and 8
   alone; on a host with two or more cards the ranks of 4f and 8 take
   cards 0 and 1 and NCCL, with the same checks;
8b. ``--profile``: phase 6's setup (B=2, packed decoder, one epoch of 4
   steps) with ``profile=True``: the Chrome trace
   ``profile/rank0.json`` exists and holds each step's stage spans; the
   device busy share of steps 2-4 (the union of the kernel intervals over
   the window from the first to the last kernel launched inside those
   steps' spans) and the 10 device kernels with the most time there, by
   name.

Kernel F (the lung-masked sums) runs once in every dRAM forward, eval
and train, so each such train step and eval batch also counts one F
launch; the classification models have no F.

Every timed site also prints the library call that computes the same
conv or pool (cuDNN ``F.conv3d``, its ``conv3d_input`` / ``conv3d_weight``
gradients, ``F.max_pool3d``; for E the route it replaces, cuDNN stem conv
+ BN/ReLU + kernel C), timed with TF32 allowed; for F ``torch.bmm`` of the
lung row and the maps, TF32 off, which gives the masked sums but not the
lung sum; the bound: the larger
of the bytes read and written once over 3.35 TB/s and the conv's FLOPs
over the dtype's peak (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s float32
CUDA cores; NVIDIA's H100 SXM data sheet); the achieved TFLOP/s (GB/s
where there are no FLOPs) and the share of the bound that the kernel's
time reaches; and for kernel A in bf16 its block tile (128 voxels by
``conv_tile_n(O)`` channels).

The line before the last is the per-kernel JSON summary; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository beside it, the script exits non-zero and prints no result.
"""
import argparse
import copy
import json
import logging
import math
import os
import re
import socket
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
             "False); this smoke runs only on a GPU")

from bodyct_dram_emph_subtype_tpu_torch.data.loader import (
    default_collate, prefetch_to_device)
from bodyct_dram_emph_subtype_tpu_torch.data.mha import read_mha, write_mha
from bodyct_dram_emph_subtype_tpu_torch.data.host_preprocess import (
    RawPaddedView, preprocess_sample)
from bodyct_dram_emph_subtype_tpu_torch.inference.processor import (
    _RawPredictView, build_model, gate_plan, run_inference)
from bodyct_dram_emph_subtype_tpu_torch.data.datasets import (
    CLE_RATIO_MAP, PSE_RATIO_MAP, COPDGeneSubtyping, SubtypingInference)
from bodyct_dram_emph_subtype_tpu_torch.losses import ratio_to_label_batch
from bodyct_dram_emph_subtype_tpu_torch.models import blocks, experimental
from bodyct_dram_emph_subtype_tpu_torch.models.registry import \
    get_model_by_name
from bodyct_dram_emph_subtype_tpu_torch.ops import cuda_build
from bodyct_dram_emph_subtype_tpu_torch.ops.maxpool_kernel import (
    max_pool_k3s2p1, max_pool_k3s2p1_plain)
from bodyct_dram_emph_subtype_tpu_torch.ops.pallas_kernels import (
    masked_sums, masked_sums_plain)
from bodyct_dram_emph_subtype_tpu_torch.ops.packing import (
    pack10_gated_host, unpack10_gated_device)
from bodyct_dram_emph_subtype_tpu_torch.ops.preprocess import (
    fused_preprocess, fused_preprocess_preselected)
from bodyct_dram_emph_subtype_tpu_torch.models.blocks import (BasicBlock,
                                                              Bottleneck)
from bodyct_dram_emph_subtype_tpu_torch.models.resnet3d import (
    TRAIN_ROLL_SITES, mode_conv_sites, roll_eval_sites, site_launches,
    train_roll_launches, train_roll_site_shapes, train_roll_sites)
from bodyct_dram_emph_subtype_tpu_torch.ops.roll_conv import (
    CONV_TILE_M, CONV_TILE_N_LARGE, CONV_TILE_N_SMALL, MMA_BK, MMA_STAGES,
    WGRAD_COLS, WGRAD_ROWS, conv3x3x3_dgrad, conv3x3x3_dgrad_plain,
    conv3x3x3_f32, conv3x3x3_wgrad, conv3x3x3_wgrad_plain, conv_tile_n,
    identity_conv3d, roll_conv_affine_relu, roll_conv_affine_relu_plain,
    roll_conv_heads_sigmoid, roll_conv_heads_sigmoid_plain, roll_conv_packed)
from bodyct_dram_emph_subtype_tpu_torch.ops.stem_kernel import (
    fused_stem_pool, fused_stem_pool_plain, stem_smem_bytes)
from bodyct_dram_emph_subtype_tpu_torch.evaluate.__main__ import \
    main as evaluate_main
from bodyct_dram_emph_subtype_tpu_torch.parallel.mesh import gather_objects
from bodyct_dram_emph_subtype_tpu_torch.train.__main__ import (
    build_parser, distributed, make_config)
from bodyct_dram_emph_subtype_tpu_torch.train.loop import (
    SubtypeTrainer, TrainerConfig, reweight_classes, step_seed)
from bodyct_dram_emph_subtype_tpu_torch.train.state import make_optimizer
from bodyct_dram_emph_subtype_tpu_torch.train.steps import (
    dense_map_size, make_cls_train_step, make_reg_train_step)
from bodyct_dram_emph_subtype_tpu_torch.transforms.batch_augment import (
    augment_batch, draw_augment_params)

DEV = torch.device("cuda")
B = 2
TARGET = (128, 224, 288)
PAD = (160, 288, 384)            # the processor's default pad_shape
# phase 6f: the device input pipeline's buffer, and the archive's extents
# (differing, the largest 180x320x320)
PAD_6F = (192, 320, 320)
SHAPES_6F = [(180, 320, 320), (150, 300, 310), (170, 280, 320),
             (160, 320, 290)]
# phase 6f: the card's fused_preprocess against the host chain (the JAX
# package's bound, tests/test_fused_preprocess.py:34-35) and against the
# port's CPU fused_preprocess
PRE_HOST_ATOL, PRE_CPU_ATOL = 1e-4, 1e-5
# the bf16 bound on lesion fractions (tests/test_composed_oracle.py)
FRAC_BOUND = 5e-3
# (site, input shape, O, residual, launches per forward)
A_SITES = [
    ("layer1.conv1", (B, 32, 56, 72, 64), 64, False, 3),
    ("layer1.conv2+res", (B, 32, 56, 72, 64), 64, True, 3),
    ("layer2.tail.conv1", (B, 16, 28, 36, 128), 128, False, 3),
    ("layer2.tail.conv2+res", (B, 16, 28, 36, 128), 128, True, 3),
    ("us1.conv0", (B, 32, 56, 72, 576), 64, False, 1),
    ("us1.conv1", (B, 32, 56, 72, 64), 64, False, 1),
    ("us2.conv0", (B, 64, 112, 144, 128), 64, False, 1),
    ("us2.conv1", (B, 64, 112, 144, 64), 64, False, 1),
    # med3d's eval us3 (phase 7): not in the dRAM forward, whose us3 runs
    # on B, so it adds nothing to A's per-forward summary
    ("us3 (cls)", (B, 64, 112, 144, 64), 32, False, 0),
    ("ragged", (1, 5, 7, 9, 20), 13, True, 0),
]
B_SITES = [("us3+heads", (B, 64, 112, 144, 64), 32, 2, 1),
           ("ragged", (1, 5, 7, 9, 20), 13, 2, 0)]
C_SITES = [("stem.pool", (B, 64, 112, 144, 64), 1),
           ("ragged", (1, 5, 7, 9, 3), 0)]
LAYERS = (3, 4, 6, 3)


def per_forward(packed_decoder=True, quad=False, block=BasicBlock,
                kind="reg"):
    """Launches per eval forward of a med3ddram-family (``kind`` "reg") or
    med3d-family ("cls") model under conv mode roll (``roll_eval_sites``),
    every kernel named; the dRAM forward's one F call, none for CLS."""
    sites = roll_eval_sites(LAYERS, quad, packed_decoder, block, kind)
    return {**{k: 0 for k in cuda_build.KERNELS}, **site_launches(sites),
            "masked_sums": int(kind == "reg")}


def per_train_step(sites, kind="reg"):
    """Launches per train step with ``sites`` of ``roll_conv_packed`` (and
    the dRAM forward's one F call)."""
    return {**{k: 0 for k in cuda_build.KERNELS},
            **train_roll_launches(sites), "masked_sums": int(kind == "reg")}


# the bf16 processor's forward (packed decoder): A 16, B 1, C 1, F 1
PER_FORWARD = per_forward()
# a processor batch: the forward, and one more kernel-F call for the
# device path's reduction or the host path's predict-step numerators
PER_BATCH = {**PER_FORWARD, "masked_sums": 2}
# (site, dense shape, kernel-F calls per device-path batch)
F_SITES = [("model regs", (B, 64, 112, 144, 2), 1),
           ("reduction", (B, 64, 112, 144, 2), 1),
           ("host predict", (B, *TARGET, 2), 0),
           ("ragged", (3, 5, 7, 9, 3), 0),
           ("C=1", (B, 64, 112, 144, 1), 0)]
F_REL_BOUND = 1e-5
F_CALLS = 20                     # kernel-F calls per timed CUDA graph
L2_BYTES = 50 * 2 ** 20          # the H100's L2 cache
# (site, x shape, O) of the training convs, plus a ragged shape
TRAIN_SITES = train_roll_site_shapes(B, TARGET) + [
    ("ragged", (1, 5, 7, 9, 20), 13)]
GRAD_L2_BOUND, GRAD_PEAK_BOUND = 5e-3, 2e-2      # phases 6b, 7e
# phase 7f: bf16 against float32 pooled logits, max|d| over max|logit|
# (the first card run: 9.0e-3)
CLS_POOLED_BOUND = 2.5e-2
# phase 6 (packed decoder): A 22, D 11, F 1
PER_TRAIN_STEP = per_train_step(TRAIN_ROLL_SITES)
# the trainers' default (unpacked decoder; phase 6d): layer1's 6 sites
# in training (A 12, D 6), and A 12, C 1, no B in an eval forward
DEFAULT_TRAIN_SITES = train_roll_sites(LAYERS, packed_decoder=False)
# med3ddram50 with the packed decoder (phase 6e): the 5 decoder convs
SITES50 = train_roll_sites(LAYERS, Bottleneck, True)
E_SITES = [("stem", (B, *TARGET, 1), 1), ("ragged", (1, 20, 36, 44, 1), 0)]
MODES = {"pallas": "pallas_conv3d", "tapmm": "tap_conv3d",
         "flat": "flat_conv3d"}
# kernel-A launches per B=2 bf16 forward of the processor (packed decoder)
MODE_PER_FORWARD = {"pallas": 26, "tapmm": 13, "flat": 18}
QUAD_PER_BATCH = {**per_forward(quad=True), "masked_sums": 2}
PALLAS_PER_TRAIN_STEP = 31                       # phase 6c, unpacked decoder
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_S = 3.35e12
SOURCES = {
    "conv3x3x3_affine": (
        "bodyct_dram_emph_subtype_tpu_torch/csrc/conv3x3x3.cu",
        "bodyct_dram_emph_subtype_tpu/ops/roll_conv.py:311"),
    "conv3x3x3_heads_sigmoid": (
        "bodyct_dram_emph_subtype_tpu_torch/csrc/conv3x3x3.cu",
        "bodyct_dram_emph_subtype_tpu/ops/roll_conv.py:502"),
    "max_pool3d_k3s2p1": (
        "bodyct_dram_emph_subtype_tpu_torch/csrc/maxpool3d.cu",
        "bodyct_dram_emph_subtype_tpu/ops/maxpool_kernel.py:161"),
    "conv3x3x3_wgrad": (
        "bodyct_dram_emph_subtype_tpu_torch/csrc/conv3x3x3_wgrad.cu",
        "bodyct_dram_emph_subtype_tpu/ops/roll_conv.py:682"),
    "stem_pool": (
        "bodyct_dram_emph_subtype_tpu_torch/csrc/stem_pool.cu",
        "bodyct_dram_emph_subtype_tpu/ops/stem_kernel.py:241"),
    "masked_sums": (
        "bodyct_dram_emph_subtype_tpu_torch/csrc/masked_sums.cu",
        "bodyct_dram_emph_subtype_tpu/ops/pallas_kernels.py:46"),
    "pallas_conv3d": (
        "bodyct_dram_emph_subtype_tpu_torch/csrc/conv3x3x3.cu",
        "bodyct_dram_emph_subtype_tpu/ops/pallas_conv.py:80"),
    "tap_conv3d": (
        "bodyct_dram_emph_subtype_tpu_torch/csrc/conv3x3x3.cu",
        "bodyct_dram_emph_subtype_tpu/ops/tap_conv.py:118"),
    "flat_conv3d": (
        "bodyct_dram_emph_subtype_tpu_torch/csrc/conv3x3x3.cu",
        "bodyct_dram_emph_subtype_tpu/ops/flat_conv.py:140"),
}


class SmokeError(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeError(msg)


def median_ms(fn, reps: int = 5, flush=None) -> float:
    """Median CUDA-event ms of ``fn``; ``flush()``, if given, runs before
    each timed call, outside the events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rand(gen, shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=gen, device=DEV) * scale).to(dtype)


def bf16_ulp(ref: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each reference value, taken no lower than at 2^-10
    of the tensor's peak (near zero the two float32 accumulations, summed
    in different orders, differ by more than a bf16 ulp of the cancelled
    result)."""
    mag = ref.float().abs()
    mag = mag.clamp_min(max(mag.max().item() * 2.0 ** -10, 2.0 ** -126))
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def phase_environment():
    print("== phase 1: environment")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  devices {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"{torch.cuda.get_device_name(0)}, power limit unknown"
    print(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return card


def ptxas_kernels(log: str):
    """[(entry name, registers, spill store bytes, spill load bytes, static
    shared bytes)] from ``nvcc -Xptxas -v`` output."""
    out, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append((name, int(m.group(1)), *spills,
                        int(smem.group(1)) if smem else 0))
            name = None
    return out


def demangled(names):
    """``names`` through the toolkit's cu++filt, where there is one."""
    tool = Path(cuda_build._nvcc()).with_name("cu++filt")
    if not tool.exists():
        return list(names)
    res = subprocess.run([str(tool)], input="\n".join(names),
                         capture_output=True, text=True, timeout=60)
    got = res.stdout.splitlines()
    return got if res.returncode == 0 and len(got) == len(names) \
        else list(names)


def dynamic_smem(name: str):
    """Dynamic shared memory of a tensor-core instantiation (the mirrors in
    ``ops/roll_conv.py`` and ``ops/stem_kernel.py``): for A, B and D the
    cp.async ring of ``csrc/mma_bf16.cuh`` and, except in kernel A's
    128-column tile, one float32 sum per accumulator
    (``WarpTile::promote``); for E the weights, its space-to-depth plane
    ring and the stem tile."""
    if "stem_mma_kernel" in name:
        return stem_smem_bytes()
    if "wgrad_mma_kernel" in name:
        cols, rows, sums = WGRAD_COLS, WGRAD_ROWS, True
    elif "conv3x3x3_mma_kernel" in name:
        wide = "<128" in name or "ILi128E" in name      # demangled or not
        cols = CONV_TILE_N_LARGE if wide else CONV_TILE_N_SMALL
        rows, sums = CONV_TILE_M, not wide
    else:
        return 0
    return MMA_STAGES * (rows + cols) * MMA_BK * 2 + \
        (rows * cols * 4 if sums else 0)


def phase_build():
    print("== phase 2: build")
    t0 = time.perf_counter()
    cuda_build.library()
    info = cuda_build.build_info()
    kernels = ptxas_kernels(info.log)
    for (_, regs, st, ld, smem), name in zip(
            kernels, demangled([k[0] for k in kernels])):
        dyn = dynamic_smem(name)
        print(f"  ptxas: {name}: {regs} registers, spill stores {st} B, "
              f"spill loads {ld} B, static smem {smem} B"
              + (f", dynamic smem {dyn} B" if dyn else ""))
    new = [k for k in kernels if "mma_kernel" in k[0]]
    print(f"  {len(new)} tensor-core instantiations (mma_kernel), "
          f"{sum(1 for k in new if k[2] or k[3])} of them spill; "
          f"{len(kernels)} kernels in all")
    check(len(new) > 0 or info.cached, "no tensor-core kernel in the build")
    print(f"kernels built with nvcc for sm_90a in {info.seconds:.1f} s "
          f"({'cached' if info.cached else 'compiled'}; load "
          f"{time.perf_counter() - t0:.1f} s): {info.path.name}")


def library_ms(fn, flush=None) -> float:
    """Median ms of a PyTorch library call, TF32 allowed for cuDNN
    (PyTorch's default there; bf16 inputs do not use it); matmuls keep
    TF32 off."""
    torch.backends.cudnn.allow_tf32 = True
    try:
        return median_ms(fn, flush=flush)
    finally:
        torch.backends.cudnn.allow_tf32 = False


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def timed(kernel, plain, library, dtype, moved, flops, flush=None,
          calls=1):
    """Times of one site (kernel, plain version, library call; each of
    them ``calls`` calls of it) and its bound: the larger of ``moved``
    bytes (each input read once, each output written once) over the HBM
    rate and ``flops`` over the dtype's peak."""
    r = {"ms": median_ms(kernel, flush=flush) / calls,
         "plain_ms": median_ms(plain, flush=flush) / calls,
         "library_ms": library_ms(library, flush=flush) / calls,
         "bytes_ms": moved / HBM_BYTES_S * 1e3,
         "ops_ms": flops / PEAK_OPS[dtype] * 1e3}
    r["bound_ms"] = max(r["bytes_ms"], r["ops_ms"])
    r["rate"] = (f"{flops / r['ms'] / 1e9:.1f} TFLOP/s" if flops else
                 f"{moved / r['ms'] / 1e6:.0f} GB/s") \
        + f", {100 * r['bound_ms'] / r['ms']:.1f}% of bound"
    return r


def held(got, ref, dtype):
    """(|got - ref|, share of the bound, bound text): float32 max|d| <=
    2e-5*max|ref|, bf16 <= 2 bf16 ulps of each reference value (kernel
    A's bounds, phase 3)."""
    delta = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        bound = 2e-5 * ref.float().abs().max().item()
        return delta, delta.max().item() / bound, \
            f"<= 2e-5*max|ref| = {bound:.3g}"
    return delta, (delta / (2 * bf16_ulp(ref))).max().item(), \
        "<= 2 bf16 ulp(ref)"


def cudnn_weight(k, dtype):
    """(kd, kh, kw, C, O) weights as cuDNN's channels-last OIDHW."""
    return k.to(dtype).permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)


def cudnn_conv(x, w, **kw):
    """cuDNN conv of NDHWC ``x`` (a channels-last NCDHW view)."""
    return F.conv3d(x.permute(0, 4, 1, 2, 3), w, **kw)


def tile(o, dtype):
    """Kernel A's block tile at ``o`` output channels, in bf16 (float32
    runs the CUDA-core loop's 128 x 64)."""
    return (f" tile {CONV_TILE_M}x{conv_tile_n(o)}" if dtype == torch.bfloat16
            else "")


def report(kernel, site, dname, shape, delta, ratio, btxt, r, extra=""):
    ok = ratio <= 1.0
    print(f"{kernel:24s} {site:22s} {dname:4s} {str(shape):24s}{extra} "
          f"max|d|={delta.max().item():.3e} "
          f"mean|d|={delta.mean().item():.3e} ({btxt}; {ratio:.3f} of "
          f"bound) kernel {r['ms']:.3f} ms plain {r['plain_ms']:.3f} ms "
          f"library {r['library_ms']:.3f} ms bound {r['bound_ms']:.3f} ms "
          f"({'bytes' if r['bytes_ms'] >= r['ops_ms'] else 'operations'}) "
          f"[{r['rate']}] {'ok' if ok else 'FAIL'}")
    check(ok, f"{kernel} {site} {dname}: outside its bound")


TIMES = ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms", "ops_ms")


def new_summary():
    return {"max_abs_err": 0.0, **{k: 0.0 for k in TIMES}}


def accumulate(summary, delta, r, count, dtype, main=torch.bfloat16):
    """Fold one site into a kernel's summary: the largest error over every
    site and dtype, and ``count`` times the site's times in ``main`` (the
    main path's dtype)."""
    summary["max_abs_err"] = max(summary["max_abs_err"], delta.max().item())
    if dtype == main:
        for k in TIMES:
            summary[k] += count * r[k]


def compare_a(gen, shape, o, residual, dtype):
    c = shape[-1]
    x = rand(gen, shape, 0.5, dtype).relu_()
    k = rand(gen, (3, 3, 3, c, o), math.sqrt(2.0 / (27 * c)))
    sc = torch.rand(o, generator=gen, device=DEV) + 0.5
    sh = rand(gen, (o,), 0.1)
    res = rand(gen, shape[:4] + (o,), 0.5, dtype) if residual else None
    got = roll_conv_affine_relu(x, k, sc, sh, residual=res)
    torch.cuda.synchronize()
    ref = roll_conv_affine_relu_plain(x, k, sc, sh, res)
    delta, ratio, btxt = held(got, ref, dtype)
    w = cudnn_weight(k, dtype)
    r = timed(lambda: roll_conv_affine_relu(x, k, sc, sh, residual=res),
              lambda: roll_conv_affine_relu_plain(x, k, sc, sh, res),
              lambda: cudnn_conv(x, w, padding=1), dtype,
              nbytes(x, w, sc, sh, res, got),
              2.0 * math.prod(shape[:4]) * 27 * c * o)
    return delta, ratio, btxt, r


def compare_b(gen, shape, o, hn, dtype):
    c = shape[-1]
    x = rand(gen, shape, 0.5, dtype).relu_()
    k = rand(gen, (3, 3, 3, c, o), math.sqrt(2.0 / (27 * c)))
    sc = torch.rand(o, generator=gen, device=DEV) + 0.5
    sh = rand(gen, (o,), 0.1)
    hw = rand(gen, (o, hn), 0.3)
    hb = rand(gen, (hn,), 0.1)
    got = roll_conv_heads_sigmoid(x, k, sc, sh, hw, hb)
    torch.cuda.synchronize()
    ref = roll_conv_heads_sigmoid_plain(x, k, sc, sh, hw, hb)
    delta = (got - ref).abs()
    if dtype == torch.float32:
        bound = 1e-5 * ref.abs().max().item()
        ratio = delta.max().item() / bound
        btxt = f"<= 1e-5*max|ref| = {bound:.3g}"
    else:
        ratio = max(delta.max().item() / 5e-3, delta.mean().item() / 1e-6)
        btxt = "max <= 5e-3, mean <= 1e-6"
    w = cudnn_weight(k, dtype)
    r = timed(lambda: roll_conv_heads_sigmoid(x, k, sc, sh, hw, hb),
              lambda: roll_conv_heads_sigmoid_plain(x, k, sc, sh, hw, hb),
              lambda: cudnn_conv(x, w, padding=1), dtype,
              nbytes(x, w, sc, sh, hw, hb, got),
              2.0 * math.prod(shape[:4]) * (27 * c * o + o * hn))
    return delta, ratio, btxt, r


def compare_c(gen, shape, dtype):
    x = rand(gen, shape, 1.0, dtype)
    got = max_pool_k3s2p1(x)
    torch.cuda.synchronize()
    ref = max_pool_k3s2p1_plain(x)
    delta = (got.float() - ref.float()).abs()
    ratio = 0.0 if torch.equal(got, ref) else math.inf
    r = timed(lambda: max_pool_k3s2p1(x), lambda: max_pool_k3s2p1_plain(x),
              lambda: F.max_pool3d(x.permute(0, 4, 1, 2, 3), 3, 2, 1),
              dtype, nbytes(x, got), 0)
    return delta, ratio, "bit-equal", r


def phase_kernels():
    print("== phase 3: kernels vs plain versions (B=2 deployment sites)")
    gen = torch.Generator(device=DEV).manual_seed(0)
    summary = {k: new_summary() for k in ("conv3x3x3_affine",
                                          "conv3x3x3_heads_sigmoid",
                                          "max_pool3d_k3s2p1")}
    runs = ([("conv3x3x3_affine", s[0], s[1], s[4], s[2],
              lambda dt, s=s: compare_a(gen, *s[1:4], dt)) for s in A_SITES]
            + [("conv3x3x3_heads_sigmoid", s[0], s[1], s[4], s[2],
                lambda dt, s=s: compare_b(gen, *s[1:4], dt)) for s in B_SITES]
            + [("max_pool3d_k3s2p1", s[0], s[1], s[2], None,
                lambda dt, s=s: compare_c(gen, s[1], dt))
               for s in C_SITES])
    for kernel, site, shape, count, o, run in runs:
        for dtype in (torch.float32, torch.bfloat16):
            delta, ratio, btxt, r = run(dtype)
            dname = "f32" if dtype == torch.float32 else "bf16"
            report(kernel, site, dname, shape, delta, ratio, btxt, r,
                   tile(o, dtype) if o else "")
            accumulate(summary[kernel], delta, r, count, dtype)
            del delta
            torch.cuda.empty_cache()
    return summary


def compare_d(gen, shape, o, dtype):
    x = rand(gen, shape, 0.5, dtype)
    g = rand(gen, shape[:4] + (o,), 0.5, dtype)
    got = conv3x3x3_wgrad(x, g)
    again = conv3x3x3_wgrad(x, g)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"kernel D not bit-reproducible {shape}")
    ref = conv3x3x3_wgrad_plain(x, g)
    delta = (got - ref).abs()
    bound = 5e-5 * ref.abs().max().item()
    ratio = delta.max().item() / bound
    xt, gt = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
    wshape = (o, shape[-1], 3, 3, 3)
    r = timed(lambda: conv3x3x3_wgrad(x, g),
              lambda: conv3x3x3_wgrad_plain(x, g),
              lambda: torch.nn.grad.conv3d_weight(xt, wshape, gt, padding=1),
              dtype, nbytes(x, g, got),
              2.0 * math.prod(shape[:4]) * 27 * shape[-1] * o)
    return delta, ratio, \
        f"<= 5e-5*max|ref| = {bound:.3g}; bit-equal rerun", r


def compare_dgrad(gen, shape, o, dtype):
    c = shape[-1]
    g = rand(gen, shape[:4] + (o,), 0.5, dtype)
    k = rand(gen, (3, 3, 3, c, o), math.sqrt(2.0 / (27 * o))).to(dtype)
    got = conv3x3x3_dgrad(g, k)
    torch.cuda.synchronize()
    ref = conv3x3x3_dgrad_plain(g, k)
    delta, ratio, btxt = held(got, ref, dtype)
    w = cudnn_weight(k, dtype)
    gt = g.permute(0, 4, 1, 2, 3)
    r = timed(lambda: conv3x3x3_dgrad(g, k),
              lambda: conv3x3x3_dgrad_plain(g, k),
              lambda: torch.nn.grad.conv3d_input(
                  (shape[0], c, *shape[1:4]), w, gt, padding=1),
              dtype, nbytes(g, k, got),
              2.0 * math.prod(shape[:4]) * 27 * c * o)
    return delta, ratio, btxt, r


def compare_packed_forward(gen, shape, o, dtype):
    """The forward of ``roll_conv_packed`` (kernel A, identity epilogue)."""
    return compare_mode(gen, shape, o, 1, dtype,
                        conv=lambda x, k, d: roll_conv_packed(x, k))


def train_site_kernels(gen, sites, dtypes):
    """Kernel D, the dgrad on A and the forward of ``roll_conv_packed``
    against their plain versions at each (site, x shape, O) of ``sites``;
    the per-kernel summaries (bf16 times summed over the sites but
    "ragged")."""
    wgrad, dgrad, fwd = new_summary(), new_summary(), new_summary()
    for site, shape, o in sites:
        count = 0 if site == "ragged" else 1
        for dtype in dtypes:
            dname = "f32" if dtype == torch.float32 else "bf16"
            for kernel, run, acc, cols in (
                    ("conv3x3x3_wgrad", compare_d, wgrad, None),
                    ("dgrad(conv3x3x3_affine)", compare_dgrad, dgrad,
                     shape[-1]),
                    ("fwd(roll_conv_packed)", compare_packed_forward,
                     fwd, o)):
                delta, ratio, btxt, r = run(gen, shape, o, dtype)
                report(kernel, site, dname, shape, delta, ratio, btxt, r,
                       f" O={o:<3d}" + (tile(cols, dtype) if cols else ""))
                accumulate(acc, delta, r, count, dtype)
                del delta
                torch.cuda.empty_cache()
    return wgrad, dgrad, fwd


def phase_train_kernels():
    print("== phase 3b: training kernels vs plain versions (B=2 train sites)")
    gen = torch.Generator(device=DEV).manual_seed(1)
    wgrad, dgrad, fwd = train_site_kernels(
        gen, TRAIN_SITES, (torch.float32, torch.bfloat16))
    print(f"per B=2 bf16 train step: kernel D {wgrad['ms']:.2f} ms (plain "
          f"{wgrad['plain_ms']:.2f}, cuDNN {wgrad['library_ms']:.2f}, bound "
          f"{wgrad['bound_ms']:.2f}), dgrad on A {dgrad['ms']:.2f} ms (plain "
          f"{dgrad['plain_ms']:.2f}, cuDNN {dgrad['library_ms']:.2f}, bound "
          f"{dgrad['bound_ms']:.2f}), forward on A {fwd['ms']:.2f} ms (plain "
          f"{fwd['plain_ms']:.2f}, cuDNN {fwd['library_ms']:.2f}, bound "
          f"{fwd['bound_ms']:.2f})")
    return wgrad, dgrad


def compare_e(gen, shape, dtype):
    """Kernel E against its plain version, both outputs held to kernel A's
    bounds; the library yardstick is the route E replaces: the cuDNN stem
    conv, the BN affine and ReLU, and kernel C."""
    x = rand(gen, shape, 1.0, dtype)
    k = rand(gen, (7, 7, 7, 1, 64), math.sqrt(2.0 / 343))
    mul = torch.rand(64, generator=gen, device=DEV) + 0.5
    add = rand(gen, (64,), 0.1)
    stem, pooled = fused_stem_pool(x, k, mul, add)
    torch.cuda.synchronize()
    ref_stem, ref_pooled = fused_stem_pool_plain(x, k, mul, add)
    d1, r1, btxt = held(stem, ref_stem, dtype)
    d2, r2, _ = held(pooled, ref_pooled, dtype)
    w = cudnn_weight(k, dtype)
    m5, a5 = mul[:, None, None, None], add[:, None, None, None]

    def route():
        y = cudnn_conv(x, w, stride=2, padding=3)
        y = torch.relu(y.float() * m5 + a5).to(dtype)
        return max_pool_k3s2p1(y.permute(0, 2, 3, 4, 1))

    r = timed(lambda: fused_stem_pool(x, k, mul, add),
              lambda: fused_stem_pool_plain(x, k, mul, add), route, dtype,
              nbytes(x, w, mul, add, stem, pooled),
              2.0 * math.prod(stem.shape[:4]) * 343 * 64)
    delta = torch.cat([d1.flatten(), d2.flatten()])
    return delta, max(r1, r2), btxt + " (stem and pool)", r


def compare_mode(gen, shape, o, dilation, dtype, conv=identity_conv3d):
    """A conv-mode op (kernel A, identity epilogue, at ``dilation``)
    against the float32 conv of the same inputs rounded once."""
    c = shape[-1]
    x = rand(gen, shape, 0.5, dtype).relu_()
    k = rand(gen, (3, 3, 3, c, o), math.sqrt(2.0 / (27 * c))).to(dtype)
    with torch.no_grad():
        got = conv(x, k, dilation)
    torch.cuda.synchronize()
    ref = conv3x3x3_f32(x, k, dilation).to(dtype)
    delta, ratio, btxt = held(got, ref, dtype)
    w = cudnn_weight(k, dtype)
    r = timed(lambda: conv(x, k, dilation),
              lambda: conv3x3x3_f32(x, k, dilation).to(dtype),
              lambda: cudnn_conv(x, w, padding=dilation, dilation=dilation),
              dtype, nbytes(x, k, got),
              2.0 * math.prod(shape[:4]) * 27 * c * o)
    return delta, ratio, btxt, r


def mode_sites():
    """{(x shape, O, dilation): (first module name, {mode: launches})} of
    the processor's B=2 bf16 forward (packed decoder) in each conv mode."""
    model = get_model_by_name("med3ddram", packed_decoder=True)
    sites = {}
    for mode in MODES:
        sites_mode = mode_conv_sites(model, mode, B, TARGET, torch.bfloat16)
        check(len(sites_mode) == MODE_PER_FORWARD[mode],
              f"{mode}: {len(sites_mode)} sites")
        for name, shape, kshape, d, _ in sites_mode:
            entry = sites.setdefault((shape, kshape[-1], d), (name, Counter()))
            entry[1][mode] += 1
    return sites


def phase_mode_kernels():
    print("== phase 3c: kernel E and the conv-mode sites of kernel A vs "
          "plain versions (B=2 deployment sites)")
    gen = torch.Generator(device=DEV).manual_seed(2)
    summary = {"stem_pool": new_summary(),
               **{op: new_summary() for op in MODES.values()}}
    for site, shape, count in E_SITES:
        for dtype in (torch.float32, torch.bfloat16):
            delta, ratio, btxt, r = compare_e(gen, shape, dtype)
            dname = "f32" if dtype == torch.float32 else "bf16"
            report("stem_pool", site, dname, shape, delta, ratio, btxt, r)
            accumulate(summary["stem_pool"], delta, r, count, dtype)
            del delta
            torch.cuda.empty_cache()
    runs = [(name, shape, o, d, counts)
            for (shape, o, d), (name, counts) in mode_sites().items()]
    runs.append(("ragged", (1, 5, 7, 9, 20), 13, 2, Counter()))
    for name, shape, o, d, counts in runs:
        for dtype in (torch.float32, torch.bfloat16):
            delta, ratio, btxt, r = compare_mode(gen, shape, o, d, dtype)
            dname = "f32" if dtype == torch.float32 else "bf16"
            where = ",".join(f"{m}x{n}" for m, n in counts.items()) or "-"
            report("identity A", name, dname, shape, delta, ratio, btxt, r,
                   f" O={o:<3d} d={d} [{where}]" + tile(o, dtype))
            for mode, op in MODES.items():
                accumulate(summary[op], delta, r, counts[mode], dtype)
            del delta
            torch.cuda.empty_cache()
    for mode, op in MODES.items():
        s = summary[op]
        print(f"per B=2 bf16 forward in mode {mode} ({op}, "
              f"{MODE_PER_FORWARD[mode]} sites): kernel A {s['ms']:.2f} ms "
              f"(plain {s['plain_ms']:.2f}, cuDNN {s['library_ms']:.2f}, "
              f"bound {s['bound_ms']:.2f})")
    return summary


def graphed(fns):
    """The calls ``fns`` captured in order into one CUDA graph; returns its
    replay.  A replay's time is the device's, without the Python wrapper
    and the launch overhead that dominate a call of tens of microseconds.
    One eager round on the capture stream comes first, so what a call sets
    up once per stream (kernel F's ticket array) is not in the graph."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for fn in fns:
            fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=stream):
        for fn in fns:
            fn()
    return g.replay


def device_kernels(fn):
    """[(name, device us)] of the device kernels that ``fn`` runs, as
    ``torch.profiler`` traces them."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.device_time_total) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def f_device_kernels(shape, flush, calls=10):
    """{name: (count, mean device us)} of the device kernels that
    ``calls`` eager kernel-F calls at ``shape`` launch, the L2 flushed
    before each (the flush's own kernels left out)."""
    dense = torch.rand(shape, device=DEV)
    lung = (torch.rand(shape[:4] + (1,), device=DEV) > 0.4).float()
    masked_sums(dense, lung)
    skip = {name for name, _ in device_kernels(flush)}

    def run():
        for _ in range(calls):
            flush()
            masked_sums(dense, lung)

    found = {}
    for name, us in device_kernels(run):
        if name not in skip:
            n, total = found.get(name, (0, 0.0))
            found[name] = (n + 1, total + us)
    return {name: (n, total / n) for name, (n, total) in found.items()}


def compare_f(gen, shape, dtype, flush):
    """Kernel F against its plain version and a float64 sum.  The times of
    kernel, plain version and library call are per call, from one CUDA
    graph of ``F_CALLS`` calls that cycle through copies of the inputs
    holding together at least twice the L2 cache, so each call reads its
    inputs from device memory; the kernel's time per Python call (L2
    flushed before it) is printed beside them."""
    b, c = shape[0], shape[-1]

    def inputs():
        return (torch.rand(shape, generator=gen, device=DEV).to(dtype),
                (torch.rand(shape[:4] + (1,), generator=gen, device=DEV)
                 > 0.4).float())

    dense, lung = inputs()
    num, den = masked_sums(dense, lung)
    num2, den2 = masked_sums(dense, lung)
    torch.cuda.synchronize()
    check(torch.equal(num, num2) and torch.equal(den, den2),
          f"kernel F not bit-reproducible {shape}")
    ref = (dense.double() * lung.double()).sum((1, 2, 3))
    count = lung.double().sum((1, 2, 3, 4))
    check(torch.equal(den.double(), count), f"kernel F lung sums {shape}")
    plain_num, plain_den = masked_sums_plain(dense, lung)
    check(torch.equal(plain_den.double(), count), f"plain lung sums {shape}")
    rel = {name: ((got.double() - ref).abs() / ref.abs()).max().item()
           for name, got in (("kernel", num), ("plain", plain_num))}
    ratio = max(rel.values()) / F_REL_BOUND
    moved = nbytes(dense, lung, num, den)
    copies = [(dense, lung)] + [inputs() for _ in range(
        min(F_CALLS, -(-2 * L2_BYTES // moved)) - 1)]

    def bmm(d, l):
        return torch.bmm(l.to(dtype).reshape(b, 1, -1), d.reshape(b, -1, c))

    r = timed(*(graphed([lambda i=i, fn=fn: fn(*copies[i % len(copies)])
                         for i in range(F_CALLS)])
                for fn in (masked_sums, masked_sums_plain, bmm)),
              dtype, moved, 0, calls=F_CALLS)
    call_ms = median_ms(lambda: masked_sums(dense, lung), flush=flush)
    delta = (num.double() - ref).abs().float()
    return delta, ratio, (f"num rel|d| kernel {rel['kernel']:.2e} plain "
                          f"{rel['plain']:.2e} <= {F_REL_BOUND:g} of float64; "
                          f"den == count; bit-equal rerun"), r, call_ms


def phase_masked_sums():
    print("== phase 3d: kernel F (masked_sums) vs its plain version and "
          "float64 (its three sites, ragged, C=1)")
    gen = torch.Generator(device=DEV).manual_seed(3)
    summary = new_summary()
    shares = []
    l2 = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=DEV)
    flush = l2.zero_                 # 64 MB > the H100's 50 MB L2
    for site, shape, count in F_SITES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = "f32" if dtype == torch.float32 else "bf16"
            delta, ratio, btxt, r, call_ms = compare_f(gen, shape, dtype,
                                                       flush)
            report("masked_sums", site, dname, shape, delta, ratio, btxt, r,
                   f" per Python call {call_ms:.4f} ms; per call in a "
                   f"graph of {F_CALLS}:")
            accumulate(summary, delta, r, count, dtype, main=torch.float32)
            shares.append(f"{site} {dname} "
                          f"{100 * r['bound_ms'] / r['ms']:.1f}%")
            torch.cuda.empty_cache()
    print(f"kernel F share of its byte bound per site: {', '.join(shares)}")
    print(f"per B=2 device-path batch (model regs + reduction, float32 "
          f"maps; calls in CUDA graphs): kernel F {summary['ms']:.4f} ms "
          f"(plain "
          f"{summary['plain_ms']:.4f}, torch.bmm {summary['library_ms']:.4f} "
          f"without the lung sum, bound {summary['bound_ms']:.4f}: "
          f"{100 * summary['bound_ms'] / summary['ms']:.1f}% of it)")
    calls, shape = 10, F_SITES[0][1]
    kernels = f_device_kernels(shape, flush, calls)
    print(f"kernel F device kernels in {calls} calls at {shape} "
          f"(torch.profiler, L2 flushed before each): " + "; ".join(
              f"{name}: {n} x {us:.1f} us" for name, (n, us) in
              kernels.items()))
    check(sum(n for n, _ in kernels.values()) == calls and
          all("masked_sums" in name for name in kernels),
          "kernel F is not one device kernel per call")
    print("kernel F: one device kernel per call")
    return summary


def write_scan(scan_dir: Path, lobe_dir: Path, uid: str, shape, radii,
               seed: int):
    """A synthetic int16 CT with a lobe ellipsoid of ``radii`` (fractions
    of ``shape``) and its lobe mask."""
    spacing = (0.7, 0.7, 1.5)                      # ITK (x, y, z)
    rng = np.random.RandomState(seed)
    zz, yy, xx = np.ogrid[:shape[0], :shape[1], :shape[2]]
    lobe = ((((zz - shape[0] / 2) / (shape[0] * radii[0])) ** 2
             + ((yy - shape[1] / 2) / (shape[1] * radii[1])) ** 2
             + ((xx - shape[2] / 2) / (shape[2] * radii[2])) ** 2) < 1)
    ct = np.full(shape, -1000, np.int16)
    ct[lobe] = (-870 + 70 * rng.randn(int(lobe.sum()))).astype(np.int16)
    write_mha(scan_dir / f"{uid}.mha", ct, spacing)
    write_mha(lobe_dir / f"{uid}.mha", lobe.astype(np.uint8), spacing)


def write_scans(scan_dir: Path, lobe_dir: Path, n: int = 3):
    """Synthetic int16 CTs of about (180, 320, 320) with a lobe ellipsoid
    whose lung crop fits the default pad_shape (160, 288, 384)."""
    shape = (180, 320, 320)
    for i in range(n):
        write_scan(scan_dir, lobe_dir, f"scan{i}", shape,
                   (0.38 + 0.02 * i, 0.30, 0.38), 100 + i)
    return shape


def check_outputs(out_dir: Path, results, uids, shape):
    """The output contract; ``shape``: every scan's, or {uid: shape}."""
    check([r["entity"] for r in results] == uids, f"results order {results}")
    for r in results:
        m = r["metrics"]
        check(set(m) == {"cle_severity_score",
                         "cle_lesion_percentage_per_lung",
                         "pse_severity_score",
                         "pse_lesion_percentage_per_lung"}, f"metrics {m}")
        check(0 <= int(m["cle_severity_score"]) <= 5
              and 0 <= int(m["pse_severity_score"]) <= 2, f"scores {m}")
        for name in ("cle", "pse"):
            pct = float(m[f"{name}_lesion_percentage_per_lung"])
            check(math.isfinite(pct) and 0.0 <= pct <= 1.0, f"pct {m}")
        check(r["error_messages"] == [], f"errors {r}")
    for fname in ("centrilobular-emphysema-score.json",
                  "araseptal-emphysema-score.json"):
        js = json.loads((out_dir / fname).read_text())
        check(set(js) == {"score", "percentage"}, f"{fname}: {js}")
    check(len(json.loads((out_dir / "results.json").read_text())) ==
          len(uids), "results.json length")
    for sub in ("centrilobular-emphysema-heatmap",
                "paraseptal-emphysema-heatmap"):
        for uid in uids:
            img = read_mha(out_dir / "images" / sub / f"{uid}.mha")
            want = shape[uid] if isinstance(shape, dict) else shape
            check(img.array.shape == want and img.array.dtype == np.uint8,
                  f"{sub}/{uid}: {img.array.shape} {img.array.dtype}")


def phase_main_path(work: Path):
    print("== phase 4: main path (run_inference, med3ddram, bf16, batch 2)")
    scan_dir, lobe_dir, out_dir = work / "ct", work / "lobes", work / "out"
    for d in (scan_dir, lobe_dir, out_dir):
        d.mkdir(parents=True)
    t0 = time.perf_counter()
    shape = write_scans(scan_dir, lobe_dir)
    print(f"wrote 3 synthetic scans {shape} in "
          f"{time.perf_counter() - t0:.1f} s")
    model = build_model("med3ddram", ckp_path=None, seed=0,
                        compute_dtype="bfloat16")
    stats = {}
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    results = run_inference(
        str(scan_dir), str(lobe_dir), str(out_dir), target_size=TARGET,
        compute_dtype="bfloat16", batch_size=B, workers=2, model=model,
        device=DEV, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cuda_build.launches()
    uids = [f"scan{i}" for i in range(3)]
    check_outputs(out_dir, results, uids, shape)
    nb = stats["batches"]
    for kernel, per in PER_BATCH.items():
        print(f"launches {kernel}: {launches[kernel]} over {nb} batches "
              f"(expected {per} per batch)")
        check(launches[kernel] == per * nb and nb > 0,
              f"{kernel}: {launches[kernel]} launches for {nb} batches")
    for r in results:
        print("result", json.dumps(r))
    stage = {k: v / nb for k, v in stats["stage_ms"].items()}
    print("per batch of 2 (ms): " + ", ".join(
        f"{k} {v:.1f}" for k, v in stage.items())
        + "  (device: upload..download; host: postprocess)")
    gated = check_gated_upload(scan_dir, lobe_dir, stats, nb)
    print(f"main path: 3 scans in {stats['pipeline_s']:.2f} s pipeline "
          f"({3 / stats['pipeline_s']:.3f} scans/s), "
          f"run_inference {wall:.2f} s")
    return model, scan_dir, lobe_dir, launches, stage, \
        3 / stats["pipeline_s"], results, stats["fractions"], gated


def check_gated_upload(scan_dir: Path, lobe_dir: Path, stats, nb: int):
    """Phase 4's upload: the bytes per scan of the block-gated 10-bit
    stream, its gate bits and the lung bits against the int16 planes and
    uint8 lung the parent shipped, the host-clock ms of the packing per
    batch; and, for the first batch, the card's ``unpack10_gated_device``
    equal bit for bit to ``clip(image_raw, -1150, -300)`` as float32 and to
    the CPU unpack."""
    up_shape, block, budget = gate_plan(TARGET, PAD)
    nblk = int(np.prod(up_shape)) // block
    parts = {"stream": budget * 5 // 4, "gate bits": nblk // 8,
             "lung bits": int(np.prod(TARGET)) // 8,
             "extents + moments": 3 * 4 + 2 * 4}
    per_scan = sum(parts.values())
    parent = int(np.prod(up_shape)) * 2 + int(np.prod(TARGET)) + 2 * 4
    check(stats["upload_bytes"] == per_scan * B * nb,
          f"uploaded {stats['upload_bytes']} bytes, planned {per_scan} per "
          f"scan")
    dataset = SubtypingInference(str(scan_dir), str(lobe_dir),
                                 keep_original=False, compute_ess=False)
    view = _RawPredictView(dataset, up_shape, TARGET, budget, block)
    batch = default_collate([view[i] for i in range(B)])
    check(not any(batch["oversized"]), "phase 4's first batch overflowed")
    live = [int(g.sum()) for g in batch["gate_blocks"]]
    packed, bits = pack10_gated_host(batch["image_raw"], batch["gate_blocks"],
                                     budget, block)
    want = torch.from_numpy(np.clip(batch["image_raw"], -1150, -300)
                            .astype(np.float32))
    p_dev, b_dev = (torch.from_numpy(a).to(DEV) for a in (packed, bits))
    card = unpack10_gated_device(p_dev, b_dev, up_shape, block)
    cpu = unpack10_gated_device(torch.from_numpy(packed),
                                torch.from_numpy(bits), up_shape, block)
    check(card.dtype == torch.float32 and torch.equal(card.cpu(), want),
          "card gated unpack differs from the window clamp")
    check(torch.equal(cpu, want), "CPU gated unpack differs")
    unpack_ms = median_ms(
        lambda: unpack10_gated_device(p_dev, b_dev, up_shape, block))
    lung, sizes, moments = (torch.from_numpy(batch[k]).to(DEV) for k in
                            ("lung_raw", "in_sizes", "moments"))
    with torch.inference_mode():
        pre_ms = median_ms(lambda: fused_preprocess_preselected(
            card, lung, sizes, moments, target_size=TARGET,
            em_threshold=-910.0))
    del card, p_dev, b_dev, lung
    pack_ms = stats["pack_ms"] / nb
    print(f"upload per scan (gate block {block}, budget {budget // block} of "
          f"{nblk} blocks): " + ", ".join(f"{k} {v}" for k, v in parts.items())
          + f" = {per_scan} bytes ({per_scan / 1e6:.2f} MB) against "
          f"{parent} ({parent / 1e6:.2f} MB) for int16 planes + uint8 lung "
          f"({per_scan / parent:.3f} of it); live blocks of the first batch "
          f"{live} ({max(live) / nblk:.3f} of the buffer at most)")
    print(f"pack10_gated_host + lung packbits {pack_ms:.1f} ms per batch of "
          f"{B} (host clock, dispatch thread); the first batch's gated unpack "
          f"on the card equals clip(image_raw, -1150, -300) and the CPU "
          f"unpack bit for bit; alone on the card (CUDA events) the "
          f"batch's unpack takes {unpack_ms:.3f} ms and its preselected "
          f"preprocess {pre_ms:.3f} ms, against a preprocess stage of "
          f"{stats['stage_ms']['preprocess'] / nb:.1f} ms in the run (a "
          f"device-timeline interval that also holds the dispatch thread's "
          f"host time between the ops)")
    return {"bytes_per_scan": per_scan, "parent_bytes_per_scan": parent,
            "pack_ms": pack_ms, "unpack_ms": unpack_ms,
            "preprocess_ms": pre_ms}


def phase_small_reference():
    print("== phase 4b: med3ddramtiny on the card vs its CPU plain path")
    model = get_model_by_name("med3ddramtiny")
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((1, 32, 48, 64, 1), generator=gen)
    lung = (torch.rand((1, 32, 48, 64, 1), generator=gen) > 0.3).float()
    with torch.inference_mode():
        d_cpu, r_cpu = model(x, lung)
        model.to(DEV)
        d_gpu, r_gpu = model(x.to(DEV), lung.to(DEV))
    for a, b in zip(d_gpu, d_cpu):
        err = (a.cpu() - b).abs().max().item()
        check(a.shape == b.shape and torch.isfinite(a).all().item(),
              "tiny maps")
        check(err <= 1e-4, f"tiny map max|d| {err}")
    for a, b in zip(r_gpu, r_cpu):
        err = (a.cpu() - b).abs().max().item()
        check(err <= 1e-5, f"tiny fraction |d| {err}")
    print(f"tiny model maps max|d| "
          f"{max((a.cpu() - b).abs().max().item() for a, b in zip(d_gpu, d_cpu)):.3e}"
          f" (<= 1e-4), fractions max|d| "
          f"{max((a.cpu() - b).abs().max().item() for a, b in zip(r_gpu, r_cpu)):.3e}"
          f" (<= 1e-5) ok")


def preprocessed(scan_dir: Path, lobe_dir: Path, n: int):
    """The B=n float32 model input and lung mask of the first ``n`` scans,
    preprocessed on the card as the processor does."""
    dataset = SubtypingInference(str(scan_dir), str(lobe_dir),
                                 keep_original=False, compute_ess=False)
    up_shape, block, budget = gate_plan(TARGET, PAD)
    view = _RawPredictView(dataset, up_shape, TARGET, budget, block)
    batch = default_collate([view[i] for i in range(n)])
    check(not any(batch["oversized"]), "preprocessed: a dummy item")
    with torch.inference_mode():
        pre = fused_preprocess_preselected(
            torch.from_numpy(batch["image_raw"]).to(DEV),
            torch.from_numpy(batch["lung_raw"]).to(DEV),
            batch["in_sizes"].tolist(),
            torch.from_numpy(batch["moments"]).to(DEV),
            target_size=TARGET, em_threshold=-910.0)
    return pre["image"][..., None], pre["lung_mask"][..., None]


def phase_bf16_vs_f32(model, scan_dir: Path, lobe_dir: Path):
    print("== phase 5: bf16 vs float32 forward, same weights, one scan")
    x, lung = preprocessed(scan_dir, lobe_dir, 1)
    with torch.inference_mode():
        d32, r32 = model(x, lung)
        d16, r16 = model(x.to(torch.bfloat16), lung)
    for name, i in (("cle", 0), ("pse", 1)):
        frac = abs(r16[i].item() - r32[i].item())
        delta = (d16[i] - d32[i]).abs()
        mean, flips = delta.mean().item(), (delta > 0.5).float().mean().item()
        check(torch.isfinite(d16[i]).all().item(), f"{name} bf16 map finite")
        print(f"{name}: fraction f32 {r32[i].item():.6f} bf16 "
              f"{r16[i].item():.6f} |d|={frac:.2e} (< 5e-3); map mean|d|="
              f"{mean:.3e} (< 1.5e-2); flip rate (|d|>0.5) {flips:.2e} "
              f"(printed, not asserted)")
        check(frac < 5e-3, f"{name} fraction |d| {frac}")
        check(mean < 1.5e-2, f"{name} map mean |d| {mean}")


def phase_modes(model, scan_dir: Path, lobe_dir: Path, work: Path,
                default_results):
    print("== phase 4c: the processor in conv modes pallas, tapmm, flat and "
          "with the quad stem (med3ddram, bf16, batch 2)")
    ct, lobes = work / "ct2", work / "lobes2"
    for src, dst in ((scan_dir, ct), (lobe_dir, lobes)):
        dst.mkdir(parents=True)
        for i in range(B):
            shutil.copy(src / f"scan{i}.mha", dst / f"scan{i}.mha")
    x, lung = preprocessed(scan_dir, lobe_dir, B)
    x = x.to(torch.bfloat16)
    with torch.inference_mode():
        d_ref, r_ref = model(x, lung)
    totals, op_totals = Counter(), Counter()
    runs = [(mode, mode, False) for mode in MODES] + [("quad", "roll", True)]
    for label, mode, quad in runs:
        blocks.set_conv3d_mode(mode)
        experimental.set_quad_stem_enable(quad)
        try:
            stats = {}
            out = work / f"out_{label}"
            cuda_build.reset_launches()
            results = run_inference(
                str(ct), str(lobes), str(out), target_size=TARGET,
                compute_dtype="bfloat16", batch_size=B, workers=2,
                model=model, device=DEV, stats=stats)
            torch.cuda.synchronize()
            launches, ops = cuda_build.launches(), cuda_build.op_launches()
            with torch.inference_mode():
                dense, regs = model(x, lung)
        finally:
            blocks.set_conv3d_mode("roll")
            experimental.set_quad_stem_enable(False)
        totals.update(launches)
        op_totals.update(ops)
        check(stats["batches"] == 1, f"{label}: {stats['batches']} batches")
        uids = [f"scan{i}" for i in range(B)]
        check_outputs(out, results, uids, read_mha(ct / "scan0.mha")
                      .array.shape)
        want = ({**{k: 0 for k in launches}, **QUAD_PER_BATCH} if quad else
                {**{k: 0 for k in launches},
                 "conv3x3x3_affine": MODE_PER_FORWARD[mode],
                 "masked_sums": PER_BATCH["masked_sums"]})
        want_ops = {op: (0 if quad or m != mode else MODE_PER_FORWARD[m])
                    for m, op in MODES.items()}
        check(launches == want and ops == want_ops,
              f"{label}: launches {launches} ops {ops}")
        worst = {}
        for name, i in (("cle", 0), ("pse", 1)):
            key = f"{name}_lesion_percentage_per_lung"
            pct = max(abs(float(a["metrics"][key]) - float(b["metrics"][key]))
                      for a, b in zip(results, default_results))
            frac = (regs[i].float() - r_ref[i].float()).abs().max().item()
            delta = (dense[i].float() - d_ref[i].float()).abs()
            mean = delta.mean().item()
            flips = (delta > 0.5).float().mean().item()
            check(torch.isfinite(dense[i]).all().item(), f"{label} {name}")
            check(pct < 5e-3 and frac < 5e-3, f"{label} {name} fraction "
                  f"|d| {pct} (results), {frac} (forward)")
            check(mean < 1.5e-2, f"{label} {name} map mean |d| {mean}")
            check(flips < 5e-3, f"{label} {name} flip rate {flips}")
            worst[name] = (pct, frac, mean, flips)
        print(f"{label}: launches per forward "
              + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
              + (f" (all {MODES[mode]})" if not quad else "")
              + "; vs the default path: " + "; ".join(
                  f"{n} results |d| {w[0]:.1e}, fraction |d| {w[1]:.2e}, "
                  f"map mean|d| {w[2]:.3e}, flips {w[3]:.2e}"
                  for n, w in worst.items())
              + f"; forward {stats['stage_ms']['forward']:.1f} ms, "
              f"{stats['pipeline_s']:.2f} s pipeline ok")
    print("bounds: fractions < 5e-3, map mean < 1.5e-2, flip rate < 5e-3; "
          "mode and quad stem restored to roll / off")
    return totals, op_totals


def heatmap_delta(out_a: Path, out_b: Path, uid: str):
    """Both written uint8 heatmaps of ``uid`` read as maps in [0, 1]
    (count / 255): per map (mean |d| over the voxels either marks, flip
    rate |d| > 0.5 there, max |d| in counts, share of voxels that
    differ)."""
    out = {}
    for name, sub in (("cle", "centrilobular-emphysema-heatmap"),
                      ("pse", "paraseptal-emphysema-heatmap")):
        a, b = (read_mha(o / "images" / sub / f"{uid}.mha").array
                .astype(np.int16) for o in (out_a, out_b))
        counts = np.abs(a - b)
        marked = (a > 0) | (b > 0)
        d = counts[marked] / 255.0
        out[name] = (float(d.mean()) if d.size else 0.0,
                     float((d > 0.5).mean()) if d.size else 0.0,
                     int(counts.max()), float((counts > 0).mean()))
    return out


def phase_host_path(model, scan_dir: Path, lobe_dir: Path, work: Path,
                    default_fractions):
    print("== phase 4d: the host-preprocess path and the per-scan fallback "
          "(run_inference, med3ddram, batch 2)")
    torch.cuda.reset_peak_memory_stats()
    uids = [f"scan{i}" for i in range(3)]
    shape = read_mha(scan_dir / "scan0.mha").array.shape
    # (a) every scan on the host path, bf16, against phase 4's device path
    stats = {}
    out = work / "out_host"
    cuda_build.reset_launches()
    results = run_inference(
        str(scan_dir), str(lobe_dir), str(out), target_size=TARGET,
        compute_dtype="bfloat16", batch_size=B, workers=2, model=model,
        device=DEV, device_preprocess=False, stats=stats)
    torch.cuda.synchronize()
    launches = cuda_build.launches()
    check_outputs(out, results, uids, shape)
    nb = stats["batches"]
    check(nb == 2 and stats["host_scans"] == uids,
          f"host path: {nb} batches, host scans {stats['host_scans']}")
    check(launches == {k: PER_BATCH.get(k, 0) * nb for k in launches},
          f"host path launches {launches} for {nb} batches")
    total = Counter(launches)
    for uid in uids:
        frac = [abs(a - b) for a, b in zip(stats["fractions"][uid],
                                           default_fractions[uid])]
        heat = heatmap_delta(out, work / "out", uid)
        print(f"{uid}: host vs device path bf16: fractions |d| cle "
              f"{frac[0]:.2e} pse {frac[1]:.2e} (< 5e-3); heatmaps " +
              "; ".join(f"{n} mean|d| {h[0]:.3e} (< 1.5e-2), flips "
                        f"{h[1]:.2e} (< 5e-3), max {h[2]} counts"
                        for n, h in heat.items()))
        check(max(frac) < 5e-3, f"{uid} host vs device fractions {frac}")
        check(all(h[0] < 1.5e-2 and h[1] < 5e-3 for h in heat.values()),
              f"{uid} host vs device heatmaps {heat}")
    stage = {k: v / nb for k, v in stats["stage_ms"].items()}
    print(f"launches per batch " + ", ".join(
        f"{k} {v // nb}" for k, v in launches.items() if v)
        + "; per batch of 2 (ms): " + ", ".join(
            f"{k} {v:.1f}" for k, v in stage.items())
        + f"; host path: 3 scans in {stats['pipeline_s']:.2f} s pipeline "
        f"({3 / stats['pipeline_s']:.3f} scans/s)")
    host_rate = 3 / stats["pipeline_s"]
    # (b) one scan in float32 on both paths
    ct1, lobes1 = work / "ct1", work / "lobes1"
    for src, dst in ((scan_dir, ct1), (lobe_dir, lobes1)):
        dst.mkdir(parents=True)
        shutil.copy(src / "scan0.mha", dst / "scan0.mha")
    f32 = {}
    # the float32 processor builds the unpacked decoder (same seeded
    # weights): A 12, C 1, no B per forward
    model32 = build_model("med3ddram", ckp_path=None, seed=0,
                          compute_dtype="float32")
    check(not model32.packed_decoder, "float32 processor decoder")
    f32_batch = {**per_forward(packed_decoder=False), "masked_sums": 2}
    for path, host in (("device", False), ("host", True)):
        st = {}
        cuda_build.reset_launches()
        run_inference(str(ct1), str(lobes1), str(work / f"out_f32_{path}"),
                      target_size=TARGET, compute_dtype="float32",
                      batch_size=B, workers=2, model=model32, device=DEV,
                      device_preprocess=not host, stats=st)
        torch.cuda.synchronize()
        got = cuda_build.launches()
        check(st["host_scans"] == (["scan0"] if host else []),
              f"float32 {path} path host scans {st['host_scans']}")
        check(got == {k: v * st["batches"] for k, v in f32_batch.items()},
              f"float32 {path} path launches {got}")
        f32[path] = st["fractions"]["scan0"]
    print("float32 processor (unpacked decoder), launches per batch: "
          + ", ".join(f"{k} {v}" for k, v in f32_batch.items() if v))
    frac = [abs(a - b) for a, b in zip(f32["host"], f32["device"])]
    heat = heatmap_delta(work / "out_f32_host", work / "out_f32_device",
                         "scan0")
    print(f"scan0 float32, host vs device path: fractions cle "
          f"{f32['host'][0]:.7f} / {f32['device'][0]:.7f} |d| {frac[0]:.2e}, "
          f"pse |d| {frac[1]:.2e} (<= 2e-3); heatmaps " + "; ".join(
              f"{n} max {h[2]} counts, {h[3]:.2e} of voxels differ"
              for n, h in heat.items()) + " (<= 1 count on < 1 %)")
    check(max(frac) <= 2e-3, f"float32 host vs device fractions {frac}")
    check(all(h[2] <= 1 and h[3] < 0.01 for h in heat.values()),
          f"float32 host vs device heatmaps {heat}")
    # (c) the per-scan fallback at the default pad_shape (160, 288, 384)
    ct4, lobes4 = work / "ct4", work / "lobes4"
    for src, dst in ((scan_dir, ct4), (lobe_dir, lobes4)):
        dst.mkdir(parents=True)
        for uid in uids:
            shutil.copy(src / f"{uid}.mha", dst / f"{uid}.mha")
    wide = (180, 320, 448)
    write_scan(ct4, lobes4, "scan1_wide", wide, (0.38, 0.30, 0.47), 103)
    cohort = ["scan0", "scan1", "scan1_wide", "scan2"]
    stats = {}
    out = work / "out_fallback"
    cuda_build.reset_launches()
    results = run_inference(
        str(ct4), str(lobes4), str(out), target_size=TARGET,
        compute_dtype="bfloat16", batch_size=B, workers=2, model=model,
        device=DEV, stats=stats)
    torch.cuda.synchronize()
    launches = cuda_build.launches()
    check_outputs(out, results, cohort,
                  {u: (wide if u == "scan1_wide" else shape) for u in cohort})
    check(stats["host_scans"] == ["scan1_wide"],
          f"fallback host scans {stats['host_scans']}")
    nb = stats["batches"]      # 2 device-path batches (one with the dummy)
    check(nb == 3, f"fallback: {nb} batches, expected 2 device + 1 host")
    check(launches == {k: PER_BATCH.get(k, 0) * nb for k in launches},
          f"fallback launches {launches} for {nb} batches")
    total.update(launches)
    frac = max(abs(a - b) for uid in uids for a, b in
               zip(stats["fractions"][uid], default_fractions[uid]))
    check(frac < 5e-3, f"fallback device-path fractions |d| {frac}")
    peak = torch.cuda.max_memory_allocated()
    print(f"fallback at pad_shape (160, 288, 384): host scans "
          f"{stats['host_scans']} (crop wider than 384 columns), the other "
          f"3 on the device path (fractions |d| {frac:.2e} vs phase 4); "
          f"results in cohort order {[r['entity'] for r in results]}; "
          f"launches " + ", ".join(f"{k} {v}" for k, v in launches.items()
                                   if v)
          + f" over {nb} batches; peak device memory of phase 4d "
          f"{peak / 2 ** 30:.2f} GiB")
    return total, host_rate


class WarningLog(logging.Handler):
    """The port's WARNING records while the block runs."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        logging.getLogger("bodyct_dram_emph_subtype_tpu_torch").addHandler(
            self)
        return self

    def __exit__(self, *exc):
        logging.getLogger("bodyct_dram_emph_subtype_tpu_torch") \
            .removeHandler(self)


def phase_gated_overflow(model, scan_dir: Path, lobe_dir: Path, work: Path,
                         default_fractions):
    print("== phase 4e: a gated CT stream over its budget falls back alone "
          "(run_inference, med3ddram, bf16, batch 2)")
    up_shape, block, _ = gate_plan(TARGET, PAD)
    nblk = int(np.prod(up_shape)) // block
    dataset = SubtypingInference(str(scan_dir), str(lobe_dir),
                                 keep_original=False, compute_ess=False)
    view = _RawPredictView(dataset, up_shape, TARGET, nblk * block, block)
    live = {dataset[i]["uid"]: int(view[i]["gate_blocks"].sum())
            for i in range(len(dataset))}
    order = sorted(live, key=live.get)
    over = order[-1]
    # the budget of gated_frac is int(nblk * frac) rounded up to 8 blocks:
    # take the second-largest count rounded up, so that only `over` exceeds
    blocks = -(-live[order[-2]] // 8) * 8
    frac = (blocks + 0.5) / nblk
    _, _, budget = gate_plan(TARGET, PAD, frac)
    check(budget == blocks * block and live[over] > blocks,
          f"no budget between the live block counts {live}")
    stats = {}
    out = work / "out_gated_overflow"
    cuda_build.reset_launches()
    with WarningLog() as log:
        results = run_inference(
            str(scan_dir), str(lobe_dir), str(out), target_size=TARGET,
            compute_dtype="bfloat16", batch_size=B, workers=2, model=model,
            device=DEV, gated_frac=frac, stats=stats)
    torch.cuda.synchronize()
    launches = cuda_build.launches()
    uids = [f"scan{i}" for i in range(3)]
    check_outputs(out, results, uids,
                  read_mha(scan_dir / "scan0.mha").array.shape)
    warned = [m for m in log.messages if "exceeds budget" in m]
    check(len(warned) == 1 and over in warned[0],
          f"overflow warnings {warned}")
    check(stats["host_scans"] == [over], f"host scans {stats['host_scans']}")
    nb = stats["batches"]
    check(nb == 3, f"gated overflow: {nb} batches, expected 2 device + 1 "
          f"host")
    check(launches == {k: PER_BATCH.get(k, 0) * nb for k in launches},
          f"gated overflow launches {launches} for {nb} batches")
    worst = 0.0
    for uid in uids:
        frac_d = max(abs(a - b) for a, b in zip(stats["fractions"][uid],
                                                default_fractions[uid]))
        heat = heatmap_delta(out, work / "out", uid)
        check(frac_d < FRAC_BOUND, f"{uid} fractions |d| {frac_d}")
        check(all(h[0] < 1.5e-2 and h[1] < 5e-3 for h in heat.values()),
              f"{uid} heatmaps {heat}")
        worst = max(worst, frac_d)
    print(f"live blocks {live} of {nblk}; gated_frac {frac:.6f} (budget "
          f"{blocks} blocks): {over} alone over it, warned ({warned[0]!r}), "
          f"host scans {stats['host_scans']}, results in cohort order "
          f"{[r['entity'] for r in results]}; launches " + ", ".join(
              f"{k} {v}" for k, v in launches.items() if v)
          + f" over {nb} batches; against phase 4's device path: fractions "
          f"|d| {worst:.2e} at most (< {FRAC_BOUND:g}), heatmaps within the "
          f"bf16 bounds")
    return Counter(launches)


def printed_stats(text: str):
    """The ``stats:`` JSON that the processor CLI's rank 0 printed."""
    lines = [ln for ln in text.splitlines() if ln.startswith("stats: ")]
    check(len(lines) == 1, f"{len(lines)} stats lines")
    return json.loads(lines[0].removeprefix("stats: "))


def phase_processor_ranks(model, scan_dir: Path, lobe_dir: Path, work: Path,
                          default_fractions):
    print("== phase 4f: the processor as two ranks (the CLI with --ngpus 2, "
          "--ckp <phase 4's weights as .npz>, med3ddram, bf16, batch 2 per "
          "rank)")
    npz = work / "weights_4f.npz"
    np.savez(npz, **{k: v.detach().cpu().numpy()
                     for k, v in model.state_dict().items()})
    out = work / "out_ranks"
    argv = [sys.executable, "-m", "bodyct_dram_emph_subtype_tpu_torch."
            "inference", "--scan_path", str(scan_dir), "--lobe_path",
            str(lobe_dir), "--output_path", str(out), "--model_arch",
            "med3ddram", "--ckp", str(npz), "--compute_dtype", "bfloat16",
            "--batch_size", str(B), "--workers", "2", "--target_size",
            ",".join(map(str, TARGET)), "--ngpus", "2"]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=600,
                          cwd=Path(__file__).resolve().parent)
    wall = time.perf_counter() - t0
    if proc.returncode:
        print(proc.stdout[-4000:], proc.stderr[-6000:])
    check(proc.returncode == 0, f"phase 4f exited {proc.returncode}")
    stats = printed_stats(proc.stdout)
    check(proc.stdout.count("results: ") == 1, "results printed twice")
    ranks = stats["ranks"]
    uids = [f"scan{i}" for i in range(3)]
    results = json.loads((out / "results.json").read_text())
    shape = read_mha(scan_dir / "scan0.mha").array.shape
    check_outputs(out, results, uids, shape)
    check([r["entity"] for r in results] == [r["entity"] for r in json.loads(
        (work / "out" / "results.json").read_text())], "results.json order")
    for fname in ("centrilobular-emphysema-score.json",
                  "araseptal-emphysema-score.json"):
        check((out / fname).read_text() == (work / "out" / fname)
              .read_text(), f"phase 4f {fname} differs from phase 4's")
    finalized = [u for r in ranks for u in r["finalized"]]
    check(sorted(finalized) == uids, f"finalized {finalized}")
    fractions = {u: f for r in ranks for u, f in r["fractions"].items()}
    frac = max(abs(a - b) for u in uids for a, b in
               zip(fractions[u], default_fractions[u]))
    heat = {u: heatmap_delta(out, work / "out", u) for u in uids}
    worst = max(h[2] for hs in heat.values() for h in hs.values())
    check(frac < FRAC_BOUND, f"phase 4f fractions |d| {frac}")
    check(all(h[0] < 1.5e-2 and h[1] < 5e-3 for hs in heat.values()
              for h in hs.values()), f"phase 4f heatmaps {heat}")
    launches = Counter()
    for r in ranks:
        want = {k: PER_BATCH.get(k, 0) * r["batches"] for k in r["launches"]}
        check(r["batches"] > 0 and r["launches"] == want,
              f"rank {r['rank']}: launches {r['launches']} for "
              f"{r['batches']} batches")
        launches.update(r["launches"])
    slowest = max(r["pipeline_s"] for r in ranks)
    print(f"2 ranks ({stats['world']} in the group; {torch.cuda.device_count()}"
          f" visible card(s), {os.cpu_count()} host cores): rank 0 finalized "
          f"{ranks[0]['finalized']}, rank 1 {ranks[1]['finalized']} (and ran "
          f"scan0 as its padding); per rank " + "; ".join(
              f"rank {r['rank']}: {r['batches']} batch(es), pipeline "
              f"{r['pipeline_s']:.2f} s, launches " + ", ".join(
                  f"{k} {v}" for k, v in r["launches"].items() if v)
              for r in ranks))
    print(f"against phase 4 (one process): results.json's order and the "
          f"score JSONs equal; fractions max|d| {frac:.3e} (< {FRAC_BOUND:g}); heatmaps "
          f"max {worst} counts, " + "; ".join(
              f"{u} {n} mean|d| {h[0]:.2e} flips {h[1]:.2e}"
              for u, hs in heat.items() for n, h in hs.items()))
    rate = 3 / slowest
    print(f"phase 4f: 3 scans, launch wall {wall:.2f} s ({3 / wall:.3f} "
          f"scans/s; process start-up, the kernel library load and the "
          f"model build lie inside it), slowest rank's pipeline "
          f"{slowest:.2f} s ({rate:.3f} scans/s)")
    return launches, rate, wall


def write_archive(root: Path, shape=(180, 320, 320), fmt="npz",
                  shapes=None):
    """Synthetic training archive of 4 scans: int16 CT with a lung
    ellipsoid at a stored size of ``shape`` (or scan i at ``shapes[i]``),
    ``{uid}.npz`` (``fmt`` "npz") or the reference cache ``{uid}.pth``
    written with ``torch.save`` ("pth"), + ``merged.csv`` (4 CLE classes,
    so 2 samples each make one epoch of 4 steps)."""
    rows = ["SeriesInstanceUID,CT_Visual_Emph_Severity_P1,"
            "CT_Visual_Emph_Paraseptal_P1"]
    shapes = shapes or [shape] * 4
    for i, (cle, pse) in enumerate(((0, 0), (2, 1), (3, 2), (5, 1))):
        shape = shapes[i]
        zz, yy, xx = np.ogrid[:shape[0], :shape[1], :shape[2]]
        c = [s / 2 for s in shape]
        rng = np.random.RandomState(200 + i)
        lung = ((((zz - c[0]) / (0.39 * shape[0])) ** 2
                 + ((yy - c[1]) / ((0.31 + 0.015 * i) * shape[1])) ** 2
                 + ((xx - c[2]) / (0.39 * shape[2])) ** 2) < 1)
        ct = np.full(shape, -1000, np.int16)
        ct[lung] = (-900 + 80 * rng.randn(int(lung.sum()))).astype(np.int16)
        if fmt == "pth":
            torch.save({"image": torch.from_numpy(ct),
                        "lung_mask": torch.from_numpy(lung),
                        "cls_label": cle, "pse_label": pse},
                       root / f"scan{i}.pth")
        else:
            np.savez(root / f"scan{i}.npz", image=ct, lung_mask=lung,
                     cls_label=cle, pse_label=pse)
        rows.append(f"scan{i},{cle},{pse}")
    (root / "merged.csv").write_text("\n".join(rows) + "\n")
    return shapes[0] if len(set(shapes)) == 1 else shapes


class StepClock:
    """The trainer's ``step_mark`` hook: a CUDA event and a host time at
    each phase boundary, and the kernel launch counts at each ``loader``
    mark (one train step lies between two of them)."""

    def __init__(self):
        self.steps, self.cur, self.launches = [], None, []

    def __call__(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        if name == "loader":
            self.launches.append(cuda_build.launches())
            if self.cur is not None:
                self.steps.append(self.cur)
            self.cur = []
        self.cur.append((name, ev, time.perf_counter()))

    def breakdown(self, step):
        marks = self.steps[step]
        torch.cuda.synchronize()
        out = {"loader wait": 1e3 * (marks[1][2] - marks[0][2])}
        for (name, ev, _), (_, ev2, _) in zip(marks[1:], marks[2:]):
            out[name] = ev.elapsed_time(ev2)
        return out

    def wall_ms(self):
        """Host ms from each step's loader mark to the next one's."""
        starts = [s[0][2] for s in self.steps] + [self.cur[0][2]]
        return [1e3 * (b - a) for a, b in zip(starts, starts[1:])]


def trainer_config(work: Path, **kw):
    """Phase 6's trainer setup over the archive in ``work`` (bf16, B=2,
    one epoch), with ``kw`` overriding it."""
    csv = str(work / "merged.csv")
    return TrainerConfig(**{
        "model_arch": "med3ddram", "lr": 1e-4, "max_epochs": 1,
        "batch_size": B, "num_samples": 1, "target_size": TARGET,
        "workers": 4, "data_path": str(work), "train_csv": csv,
        "valid_csv": "", "test_csv": csv, "sampler_seed": 0,
        "compute_dtype": "bfloat16", "device": "cuda", **kw})


def fit_logged(trainer):
    """``trainer.fit()`` with each step's losses logged and the step clock
    on; the counts are set to 0 just before it.  Returns (losses, clock,
    launches, fit seconds, peak device bytes)."""
    losses = []
    step = trainer._train_step

    def logged_step(*args, **kw):
        metrics, preds = step(*args, **kw)
        losses.append({k: float(v) for k, v in metrics.items()})
        return metrics, preds

    trainer._train_step = logged_step
    clock = StepClock()
    trainer.step_mark = clock
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    return (losses, clock, cuda_build.launches(), fit_s,
            torch.cuda.max_memory_allocated())


def check_steps(losses, clock, want, label):
    """Every step's losses finite and its launches equal to ``want``."""
    n = len(clock.steps)
    check(n >= 1 and len(losses) == n, f"{label}: {n} train steps")
    for i, m in enumerate(losses):
        print(f"step {i}: " + ", ".join(f"{k} {v:.5f}" for k, v in m.items()))
        check(all(math.isfinite(v) for v in m.values()), f"step {i} losses")
        per = {k: clock.launches[i + 1][k] - clock.launches[i][k]
               for k in want}
        check(per == want, f"{label} step {i} launches {per}")
    print(f"launches per train step (every one of {n}): "
          + ", ".join(f"{k} {v}" for k, v in want.items() if v))
    return n


def check_eval(trainer, per_fwd, label):
    """A test evaluation over the 4-scan archive; its launches equal
    ``per_fwd`` per forward.  Returns (metrics, launches)."""
    cuda_build.reset_launches()
    metrics = trainer.evaluate("test", epoch=0)
    torch.cuda.synchronize()
    launches = cuda_build.launches()
    forwards = -(-4 // B)
    check(launches == {k: v * forwards for k, v in per_fwd.items()},
          f"{label} test eval launches {launches} for {forwards} forwards")
    check(0.0 <= metrics["epoch_test_acc_cle"] <= 1.0, f"{metrics}")
    return metrics, launches


def augment_costs(seed: int, steps: int):
    """Phase 6's augmentation: the gates (noise, cutout, flip, crop) that
    each step's rows draw (the trainer's generator seeds), and on one B=2
    batch the ms of the draws and of the apply step with every gate off
    and every gate on (3 boxes, 2 flip axes); CUDA events, median of 5."""
    gates = [draw_augment_params(
        torch.Generator(DEV).manual_seed(step_seed(seed, 0, n)), B,
        TARGET)["gates"].int().tolist() for n in range(steps)]
    gen = torch.Generator(DEV).manual_seed(step_seed(seed, 0, 0))
    images = torch.randn((B, *TARGET), device=DEV)
    masks = (torch.rand((B, *TARGET), device=DEV) > 0.5).float()
    draws = draw_augment_params(gen, B, TARGET)
    off = dict(draws, gates=torch.zeros_like(draws["gates"]),
               valid=torch.zeros_like(draws["valid"]),
               flip_axis=torch.zeros_like(draws["flip_axis"]))
    on = dict(draws, gates=torch.ones_like(draws["gates"]),
              valid=torch.zeros_like(draws["valid"]),
              flip_axis=torch.zeros_like(draws["flip_axis"]))
    on["valid"][:, :3] = True
    on["flip_axis"][:, :2] = True
    out = dense_map_size(TARGET)
    return gates, {
        "draws": median_ms(lambda: draw_augment_params(gen, B, TARGET)),
        "apply, gates off": median_ms(
            lambda: augment_batch(images, masks, masks, off, out)),
        "apply, gates on": median_ms(
            lambda: augment_batch(images, masks, masks, on, out))}


def train_to_deploy(trainer, scan_dir: Path, lobe_dir: Path, work: Path):
    """The processor given the trainer's checkpoint directory restores its
    newest epoch: lesion fractions bit-equal to ``run_inference`` of the
    trainer's restored model on one scan.  Returns the launches."""
    ckpts = trainer.config.exp_path / "checkpoints"
    newest = trainer.ckpt.latest_epoch()
    deployed = build_model("med3ddram", ckp_path=str(ckpts), seed=1,
                           compute_dtype="bfloat16")
    saved = trainer.ckpt.restore(newest)["model"]
    check(all(torch.equal(v, saved[k])
              for k, v in deployed.state_dict().items()),
          "build_model did not restore the newest epoch")
    fractions, launches = {}, Counter()
    for name, m in (("deployed", deployed), ("trainer", trainer.model)):
        st = {}
        cuda_build.reset_launches()
        run_inference(str(scan_dir), str(lobe_dir),
                      str(work / f"out_{name}"), target_size=TARGET,
                      compute_dtype="bfloat16", batch_size=B, workers=2,
                      model=m, device=DEV, stats=st)
        torch.cuda.synchronize()
        launches.update(cuda_build.launches())
        fractions[name] = st["fractions"]["scan0"]
    check(fractions["deployed"] == fractions["trainer"],
          f"train -> deploy fractions {fractions}")
    print(f"train -> deploy: build_model(ckp_path=<checkpoints>) restored "
          f"epoch {newest}; scan0's fractions {fractions['deployed']} "
          f"bit-equal to run_inference of the trainer's model")
    del deployed
    return launches


def phase_train(work: Path, deploy_scans=None):
    print("== phase 6: training path (trainer, med3ddram, bf16, B=2, "
          "packed decoder, augmentation on)")
    t0 = time.perf_counter()
    shape = write_archive(work)
    print(f"wrote 4 synthetic scans {shape} as .npz in "
          f"{time.perf_counter() - t0:.1f} s")
    cfg = trainer_config(work, num_samples=2, packed_decoder=True,
                         model_path=str(work / "models"))
    trainer = SubtypeTrainer(cfg)
    trainer.init_state()
    trainer.setup_checkpointing()
    check(not trainer.try_resume(), "resumed from an empty directory")
    before = {k: v.detach().clone()
              for k, v in trainer.model.state_dict().items()}
    losses, clock, train_launches, fit_s, peak = fit_logged(trainer)
    n = check_steps(losses, clock, PER_TRAIN_STEP, "packed decoder")
    check(n >= 4, f"{n} train steps")
    moved, stats = moved_state(before, trainer.model.state_dict())
    print(f"every weight moved (min max|d| "
          f"{min(v for k, v in moved.items() if k.endswith('weight')):.3e}); "
          f"all {len(stats)} BN running statistics moved")
    wall = clock.wall_ms()
    med = statistics.median(wall[1:])
    split = clock.breakdown(n - 1)
    print(f"train step ms (loader to loader): "
          + ", ".join(f"{t:.1f}" for t in wall)
          + f"; median without the first {med:.1f} ms, "
          f"{B / med * 1e3:.3f} volumes/s; fit {fit_s:.1f} s "
          f"(incl. epoch end and checkpoint)")
    print("last step split (ms): " + ", ".join(
        f"{k} {v:.1f}" for k, v in split.items())
        + " (loader wait: host clock; the rest: CUDA events); loader wait "
        "per step (ms): " + ", ".join(
            f"{clock.breakdown(i)['loader wait']:.1f}" for i in range(n)))
    print(f"peak device memory {peak / 2 ** 30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated)")
    gates, aug_ms = augment_costs(cfg.seed, n)
    print(f"augmentation gates (noise, cutout, flip, crop) per step and "
          f"row: {gates}; on one batch (ms): " + ", ".join(
              f"{k} {v:.1f}" for k, v in aug_ms.items()))
    best = trainer.restore_best()
    check(best == 0, f"best epoch {best}")
    metrics, eval_launches = check_eval(trainer, PER_FORWARD,
                                        "packed decoder")
    print(f"test evaluation over the archive (best epoch {best}): "
          f"acc_cle {metrics['epoch_test_acc_cle']:.3f} acc_pse "
          f"{metrics['epoch_test_acc_pse']:.3f}; launches "
          + ", ".join(f"{k} {v}" for k, v in eval_launches.items()))
    check(trainer.ckpt.epochs() == [0], f"checkpoints {trainer.ckpt.epochs()}")
    again = SubtypeTrainer(cfg)
    again.init_state()
    again.setup_checkpointing()
    check(again.try_resume(reload_only_weights=False) and again.epoch == 1,
          "try_resume did not reload the checkpoint")
    saved = trainer.ckpt.restore(0)["model"]
    check(all(torch.equal(v.cpu(), saved[k])
              for k, v in again.model.state_dict().items()),
          "resumed weights differ from the checkpoint")
    print("checkpoint epoch_0000.pt written; try_resume reloads weights, "
          "Adam state and epoch 1")
    total = Counter(train_launches) + Counter(eval_launches)
    if deploy_scans is not None:
        total += train_to_deploy(trainer, *deploy_scans, work)
    return total, {"step_ms": med, "volumes_s": B / med * 1e3,
                   "peak_gib": peak / 2 ** 30, "split": split}


def phase_train_small(mode: str = "roll", arch: str = "med3ddramtiny"):
    kind = "cls" if arch == "med3dtiny" else "reg"
    print(f"== phase {'7e' if kind == 'cls' else '6b'}: {arch} train step on "
          f"the card vs its CPU plain path (float32, augment off, conv mode "
          f"{mode})")
    rng = np.random.RandomState(7)
    # tapmm's JAX gate refuses rows narrower than 24: layer1 needs W >= 96
    size = (32, 48, 128) if mode == "tapmm" else (32, 48, 64)
    batch = {"image": rng.randn(B, *size).astype(np.float32),
             "lung_mask": (rng.rand(B, *size) > 0.3).astype(np.float32),
             "em_mask": (rng.rand(B, *size) > 0.8).astype(np.float32),
             "cls_label": np.asarray([3, 0]), "pse_label": np.asarray([1, 2])}
    cw_cle, cw_pse = np.full(6, 1 / 6), np.full(3, 1 / 3)
    out = {}
    for dev in ("cpu", "cuda"):
        # roll: the packed decoder, so the decoder convs take A and D too
        model = get_model_by_name(
            arch, generator=torch.Generator().manual_seed(3),
            packed_decoder=mode == "roll")
        if kind == "reg":
            with torch.no_grad():       # keep the maps off the clip edge
                for fc in model.fcs:
                    fc.weight.mul_(0.05)
                    fc.bias.fill_(-1.5)
        model.to(dev)
        if mode == "roll":
            want = per_train_step(train_roll_sites((1, 1, 1, 1)), kind)
        else:
            n = len(mode_conv_sites(model, mode, B, size, torch.float32))
            check(n > 0, f"no {mode} site at {size}")
            want = {"conv3x3x3_affine": n, "conv3x3x3_wgrad": 0,
                    "masked_sums": 1}
        make = make_reg_train_step if kind == "reg" else make_cls_train_step
        step = make(model, make_optimizer(model.parameters()), augment=False)
        blocks.set_conv3d_mode(mode)
        try:
            cuda_build.reset_launches()
            metrics, _ = step(batch, 0.0, cw_cle, cw_pse)
            if dev == "cuda":
                torch.cuda.synchronize()
                counts = cuda_build.launches()
        finally:
            blocks.set_conv3d_mode("roll")
        if dev == "cuda":
            check(all(counts[k] == v for k, v in want.items()),
                  f"tiny step {counts}")
        out[dev] = (float(metrics["loss"]),
                    {k: p.grad.detach().cpu() for k, p in
                     model.named_parameters()},
                    {k: b.detach().cpu() for k, b in model.named_buffers()
                     if "running" in k})
    (l_cpu, g_cpu, s_cpu), (l_gpu, g_gpu, s_gpu) = out["cpu"], out["cuda"]
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    # the decoder conv biases feed a train BatchNorm, which removes them:
    # their gradient is 0 in exact arithmetic and float32 noise here
    noise = [k for k in g_cpu
             if re.fullmatch(r"us[12]\.conv_blocks\.\d\.0\.bias|us3\.0\.bias", k)]
    l2 = {k: ((g_gpu[k] - g_cpu[k]).norm() / g_cpu[k].norm()).item()
          for k in g_cpu if k not in noise}
    peak = {k: ((g_gpu[k] - g_cpu[k]).abs().max()
                / g_cpu[k].abs().max()).item() for k in l2}
    worst_l2, worst_peak = max(l2, key=l2.get), max(peak, key=peak.get)
    stat = max(((s_gpu[k] - s_cpu[k]).abs()
                / s_cpu[k].abs().clamp_min(1e-3)).max().item()
               for k in s_cpu)
    print(f"loss cpu {l_cpu:.7f} card {l_gpu:.7f} rel|d| {rel:.2e} (<= 1e-4);"
          f" gradients: ||d||/||g|| {l2[worst_l2]:.2e} at worst "
          f"({worst_l2}; <= {GRAD_L2_BOUND:g}), max|d| {peak[worst_peak]:.2e} "
          f"of the tensor's peak at worst ({worst_peak}; <= "
          f"{GRAD_PEAK_BOUND:g}); {len(noise)} pre-BN conv biases, zero in "
          f"exact arithmetic, not compared; BN running stats rel|d| "
          f"{stat:.2e} (<= 1e-4); {want['conv3x3x3_affine']} A + "
          f"{want['conv3x3x3_wgrad']} D launches")
    for k in sorted(l2, key=l2.get, reverse=True)[:4]:
        print(f"  {k}: ||d||/||g|| {l2[k]:.2e}, max|d|/peak {peak[k]:.2e}")
    check(l2[worst_l2] <= GRAD_L2_BOUND, f"tiny step gradient L2 {l2}")
    check(peak[worst_peak] <= GRAD_PEAK_BOUND, f"tiny step gradient peak")
    check(rel <= 1e-4, f"tiny step loss rel|d| {rel}")
    check(stat <= 1e-4, f"tiny step BN stats rel|d| {stat}")


def phase_train_pallas(work: Path):
    print("== phase 6c: trainer in conv mode pallas (med3ddram, bf16, B=2, "
          "unpacked decoder, augmentation on)")
    cfg = trainer_config(work, test_csv="", packed_decoder=False,
                         model_path=str(work / "models_pallas"))
    blocks.set_conv3d_mode("pallas")
    try:
        trainer = SubtypeTrainer(cfg)
        trainer.init_state()
        trainer.setup_checkpointing()
        losses, clock, launches, _, peak = fit_logged(trainer)
        ops = cuda_build.op_launches()
    finally:
        blocks.set_conv3d_mode("roll")
    want = {**{k: 0 for k in launches},
            "conv3x3x3_affine": PALLAS_PER_TRAIN_STEP,
            "masked_sums": PER_TRAIN_STEP["masked_sums"]}
    n = check_steps(losses, clock, want, "pallas")
    check(n == 2, f"{n} pallas-mode train steps")
    check(ops == {"pallas_conv3d": n * PALLAS_PER_TRAIN_STEP,
                  "tap_conv3d": 0, "flat_conv3d": 0}, f"ops {ops}")
    wall = clock.wall_ms()
    split = clock.breakdown(n - 1)
    print(f"(all pallas_conv3d; no D, B, C or E) "
          f"step ms (loader to loader) " + ", ".join(f"{t:.1f}" for t in wall)
          + "; last step split (ms): " + ", ".join(
              f"{k} {v:.1f}" for k, v in split.items())
          + f"; peak device memory {peak / 2 ** 30:.2f} GiB")
    return launches, ops, {"step_ms": wall[-1], "peak_gib": peak / 2 ** 30}


def phase_train_default(work: Path):
    print("== phase 6d: the trainers' default routing (trainer, med3ddram, "
          "bf16, B=2, unpacked decoder, conv mode roll)")
    cfg = trainer_config(work, model_path=str(work / "models_default"))
    check(not cfg.packed_decoder, "the trainer's default decoder is packed")
    trainer = SubtypeTrainer(cfg)
    trainer.init_state()
    trainer.setup_checkpointing()
    losses, clock, launches, _, peak = fit_logged(trainer)
    want = per_train_step(DEFAULT_TRAIN_SITES)
    n = check_steps(losses, clock, want, "default routing")
    check(n == 2, f"{n} default-routing train steps")
    metrics, eval_launches = check_eval(
        trainer, per_forward(packed_decoder=False), "default routing")
    wall = clock.wall_ms()
    print(f"as the JAX train step: layer1's {len(DEFAULT_TRAIN_SITES)} convs "
          f"on A and D, the unpacked decoder and unfused heads on cuDNN; "
          f"test eval launches " + ", ".join(
              f"{k} {v}" for k, v in eval_launches.items() if v)
          + f" over {-(-4 // B)} forwards (A 12, C 1, F 1 each; no B); step "
          f"ms (loader to loader) " + ", ".join(f"{t:.1f}" for t in wall)
          + f"; peak device memory {peak / 2 ** 30:.2f} GiB")
    return Counter(launches) + Counter(eval_launches), \
        {"step_ms": wall[-1], "peak_gib": peak / 2 ** 30}


def phase_train50(work: Path):
    print("== phase 6e: med3ddram50 (the training CLI's default arch) on the "
          "card: trainer, bf16, B=2, packed decoder")
    gen = torch.Generator(device=DEV).manual_seed(4)
    shapes = train_roll_site_shapes(B, TARGET, SITES50)
    name, shape, o = shapes[0]
    check(shape[-1] == 2304, f"{name} C = {shape[-1]}")
    # the sites of its train step (D, dgrad and forward on A) and the eval
    # site of the C = 2304 conv (A with the BN epilogue, 64-column tile)
    wgrad, dgrad, fwd = train_site_kernels(gen, shapes, (torch.bfloat16,))
    delta, ratio, btxt, r = compare_a(gen, shape, o, False, torch.bfloat16)
    report("conv3x3x3_affine", name, "bf16", shape, delta, ratio, btxt, r,
           tile(o, torch.bfloat16))
    del delta
    torch.cuda.empty_cache()
    print(f"per B=2 bf16 med3ddram50 train step: kernel D {wgrad['ms']:.2f} "
          f"ms (bound {wgrad['bound_ms']:.2f}), dgrad on A {dgrad['ms']:.2f} "
          f"(bound {dgrad['bound_ms']:.2f}), forward on A {fwd['ms']:.2f} "
          f"(bound {fwd['bound_ms']:.2f})")
    cfg = trainer_config(work, model_arch="med3ddram50", packed_decoder=True,
                         model_path=str(work / "models50"))
    trainer = SubtypeTrainer(cfg)
    trainer.init_state()
    trainer.setup_checkpointing()
    losses, clock, launches, _, peak = fit_logged(trainer)
    n = check_steps(losses, clock, per_train_step(SITES50), "med3ddram50")
    check(n == 2, f"{n} med3ddram50 train steps")
    metrics, eval_launches = check_eval(
        trainer, per_forward(block=Bottleneck), "med3ddram50")
    wall = clock.wall_ms()
    split = clock.breakdown(n - 1)
    print(f"test eval launches " + ", ".join(
        f"{k} {v}" for k, v in eval_launches.items() if v)
        + f" over {-(-4 // B)} forwards; step ms (loader to loader) "
        + ", ".join(f"{t:.1f}" for t in wall) + "; last step split (ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
        + f"; peak device memory {peak / 2 ** 30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    return Counter(launches) + Counter(eval_launches), \
        {"step_ms": wall[-1], "peak_gib": peak / 2 ** 30}


def pipeline_run(work: Path, pipeline: str):
    """Phase 6f's trainer over the ragged archive in ``work`` (med3ddram,
    bf16, B=2, packed decoder, one epoch of 4 steps) on ``pipeline``, then
    a test evaluation through that pipeline's eval step."""
    cfg = trainer_config(work, num_samples=2, packed_decoder=True,
                         input_pipeline=pipeline,
                         pad_shape=PAD_6F if pipeline == "device" else None,
                         model_path=str(work / f"models_{pipeline}"))
    trainer = SubtypeTrainer(cfg)
    trainer.init_state()
    trainer.setup_checkpointing()
    losses, clock, launches, fit_s, peak = fit_logged(trainer)
    n = check_steps(losses, clock, PER_TRAIN_STEP, f"{pipeline} pipeline")
    check(n == 4, f"{n} {pipeline}-pipeline train steps")
    wall = clock.wall_ms()
    med = statistics.median(wall[1:])
    waits = [clock.breakdown(i)["loader wait"] for i in range(n)]
    split = clock.breakdown(n - 1)
    metrics, eval_launches = check_eval(trainer, PER_FORWARD,
                                        f"{pipeline} pipeline")
    print(f"{pipeline} pipeline: step ms (loader to loader) "
          + ", ".join(f"{t:.1f}" for t in wall)
          + f"; median without the first {med:.1f} ms, "
          f"{B / med * 1e3:.3f} volumes/s; loader wait per step (ms) "
          + ", ".join(f"{w:.1f}" for w in waits) + "; last step split (ms) "
          + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
          + f"; peak device memory {peak / 2 ** 30:.2f} GiB; test eval "
          f"acc_cle {metrics['epoch_test_acc_cle']:.3f} with launches "
          + ", ".join(f"{k} {v}" for k, v in eval_launches.items() if v))
    return trainer, Counter(launches) + Counter(eval_launches), {
        "step_ms": med, "volumes_s": B / med * 1e3, "waits": waits,
        "split": split, "peak_gib": peak / 2 ** 30}


def forward_fractions(trainer, pipeline: str):
    """{dataset index: (CLE, PSE) lesion fractions} of the bf16 eval
    forward of ``trainer``'s model on the test split's ``pipeline``
    inputs (the device pipeline's through ``fused_preprocess``)."""
    model = trainer.model.eval()
    out = {}
    for upload, batch in prefetch_to_device(
            trainer._loader("test", 0, pipeline),
            trainer._put(pipeline, train=False)):
        x = upload.ready()
        with torch.inference_mode():
            if pipeline == "device":
                pre = fused_preprocess(x["image_raw"], x["lung_raw"],
                                       x["in_sizes"], TARGET, -950.0)
                img, lung = pre["image"], pre["lung_mask"]
            else:
                img, lung = x["image"], x["lung_mask"]
            _, regs = model(img[..., None].to(torch.bfloat16),
                            lung[..., None])
        for j, idx in enumerate(np.asarray(batch["index"]).reshape(-1)):
            out[int(idx)] = (regs[0][j].item(), regs[1][j].item())
    return out


def phase_device_pipeline(work: Path):
    print("== phase 6f: the device input pipeline (trainer, med3ddram, bf16, "
          f"B=2, packed decoder, --input_pipeline device --pad_shape "
          f"{','.join(map(str, PAD_6F))}) against the host pipeline")
    t0 = time.perf_counter()
    write_archive(work, shapes=SHAPES_6F)
    print(f"wrote 4 synthetic scans {SHAPES_6F} as .npz in "
          f"{time.perf_counter() - t0:.1f} s")
    # (a) the card's fused_preprocess per scan against the host chain and
    # against the CPU fused_preprocess
    ds = COPDGeneSubtyping(str(work), COPDGeneSubtyping.get_series_uids(
        str(work / "merged.csv")))
    batch = default_collate([RawPaddedView(ds, PAD_6F)[i] for i in range(4)])
    raw, lung, sizes = (torch.from_numpy(batch[k]) for k in
                        ("image_raw", "lung_raw", "in_sizes"))
    check(sorted(map(tuple, batch["in_sizes"].tolist())) ==
          sorted(SHAPES_6F), f"in_sizes {batch['in_sizes'].tolist()}")
    args = [t.to(DEV) for t in (raw, lung, sizes)]
    with torch.inference_mode():
        card = fused_preprocess(*args, TARGET, -950.0)
        pre_ms = median_ms(lambda: fused_preprocess(
            *(a[:B] for a in args), TARGET, -950.0))
    cpu = fused_preprocess(raw, lung, sizes, TARGET, -950.0)
    card = {k: v.cpu() for k, v in card.items()}
    worst_host = worst_cpu = 0.0
    for i in range(4):
        host = preprocess_sample(ds[i], TARGET)
        e_host = (card["image"][i] - torch.from_numpy(host["image"])
                  ).abs().max().item()
        e_cpu = (card["image"][i] - cpu["image"][i]).abs().max().item()
        for key in ("lung_mask", "em_mask"):
            check(np.array_equal(card[key][i].numpy(), host[key]) and
                  torch.equal(card[key][i], cpu[key][i]),
                  f"scan{i} {key}: card, host and CPU differ")
        check(e_host <= PRE_HOST_ATOL and e_cpu <= PRE_CPU_ATOL,
              f"scan{i} image |d| host {e_host}, CPU {e_cpu}")
        worst_host, worst_cpu = max(worst_host, e_host), max(worst_cpu, e_cpu)
    print(f"fused_preprocess on the card, per scan of {SHAPES_6F}: image "
          f"max|d| against the host preprocess_sample {worst_host:.2e} (<= "
          f"{PRE_HOST_ATOL:g}), against the CPU fused_preprocess "
          f"{worst_cpu:.2e} (<= {PRE_CPU_ATOL:g}); lung and LAA masks "
          f"bit-equal to both; {pre_ms:.3f} ms per batch of {B} at pad "
          f"{PAD_6F} (CUDA events)")
    del card, cpu, args
    # (b) both pipelines through the trainer, then the test evaluation
    total, runs = Counter(), {}
    for pipeline in ("host", "device"):
        trainer, launches, runs[pipeline] = pipeline_run(work, pipeline)
        total.update(launches)
        if pipeline == "host":
            del trainer
            torch.cuda.empty_cache()
    # (c) the device pipeline's trained model on both pipelines' test inputs
    frac = {p: forward_fractions(trainer, p) for p in ("host", "device")}
    check(sorted(frac["host"]) == sorted(frac["device"]) == [0, 1, 2, 3],
          f"test indices {sorted(frac['host'])}")
    worst = 0.0
    for idx in range(4):
        h, d = frac["host"][idx], frac["device"][idx]
        for f_h, f_d, ratio_map in zip(h, d, (CLE_RATIO_MAP, PSE_RATIO_MAP)):
            labels = [int(ratio_to_label_batch(torch.tensor([f]), ratio_map))
                      for f in (f_h, f_d)]
            check(abs(f_h - f_d) < FRAC_BOUND and labels[0] == labels[1],
                  f"scan{idx}: host {f_h} / device {f_d}, labels {labels}")
            worst = max(worst, abs(f_h - f_d))
    print(f"the device-pipeline model's eval forward (bf16) on host- and "
          f"device-pipeline test inputs: labels equal for all 4 scans, "
          f"lesion fractions |d| {worst:.2e} at most (< {FRAC_BOUND:g})")
    return total, runs, pre_ms


def moved_state(before, after):
    """max|d| per state-dict entry (no ``num_batches_tracked``); checks
    that every weight and every BN running statistic moved."""
    moved = {k: (after[k].float() - before[k].float()).abs().max().item()
             for k in before if not k.endswith("num_batches_tracked")}
    check(all(v > 0 for k, v in moved.items() if k.endswith("weight")),
          "a weight did not move")
    stats = [k for k in moved if "running" in k]
    check(all(moved[k] > 0 for k in stats), "a BN running statistic did not "
          "move")
    return moved, stats


def phase_cls(work: Path):
    print("== phase 7: the classification strategy (med3d, bf16, B=2, "
          "reference .pth caches)")
    t0 = time.perf_counter()
    shape = write_archive(work, fmt="pth")
    print(f"wrote 4 synthetic scans {shape} as .pth (torch.save) in "
          f"{time.perf_counter() - t0:.1f} s")
    csv = str(work / "merged.csv")
    models = work / "models"
    # (b) the CLS trainer, packed decoder, one epoch of 4 steps
    print("-- 7b: trainer, packed decoder, augmentation on")
    cfg = trainer_config(work, model_arch="med3d", num_samples=2,
                         packed_decoder=True, model_path=str(models))
    trainer = SubtypeTrainer(cfg)
    check(trainer.mode == "cls", f"mode {trainer.mode}")
    trainer.init_state()
    trainer.setup_checkpointing()
    before = {k: v.detach().clone()
              for k, v in trainer.model.state_dict().items()}
    losses, clock, launches, fit_s, peak = fit_logged(trainer)
    want = per_train_step(TRAIN_ROLL_SITES, "cls")
    n = check_steps(losses, clock, want, "med3d packed decoder")
    check(n == 4, f"{n} med3d train steps")
    moved, stats = moved_state(before, trainer.model.state_dict())
    print(f"every weight moved (min max|d| "
          f"{min(v for k, v in moved.items() if k.endswith('weight')):.3e}); "
          f"all {len(stats)} BN running statistics moved")
    saved = trainer.ckpt.restore(0)
    with open(cfg.exp_path / "predicts" / "train" / "0_predicts.csv") as f:
        rows = [line.split(",") for line in f.read().split()[1:]]
    for name, col in (("cle", 1), ("pse", 2)):
        start = getattr(trainer.sampler, f"{name}_class_weights")
        new = reweight_classes(start, [int(r[col + 2]) for r in rows],
                               [int(r[col]) for r in rows])
        now = np.asarray(getattr(trainer, f"{name}_class_weights"))
        check(np.array_equal(now, new) and np.array_equal(
            np.asarray(saved[f"{name}_class_weights"]), new),
            f"{name} class weights {now} / checkpoint "
            f"{saved[f'{name}_class_weights']} vs {new}")
        # kept only where every seen class was always right (sum 0)
        changed = not np.array_equal(now, start)
        check(not changed or abs(now.sum() - 1) < 1e-12,
              f"{name} class weights {start} -> {now}")
        print(f"{name} class weights at the epoch end "
              f"({'re-weighted' if changed else 'unchanged'}): "
              + " ".join(f"{w:.4f}" for w in start) + " -> "
              + " ".join(f"{w:.4f}" for w in now)
              + f" (sum {now.sum():.6f}; the checkpoint holds them)")
    wall = clock.wall_ms()
    med = statistics.median(wall[1:])
    split = clock.breakdown(n - 1)
    print(f"train step ms (loader to loader): "
          + ", ".join(f"{t:.1f}" for t in wall)
          + f"; median without the first {med:.1f} ms, "
          f"{B / med * 1e3:.3f} volumes/s; fit {fit_s:.1f} s (incl. epoch "
          f"end and checkpoint); peak device memory {peak / 2 ** 30:.2f} GiB")
    print("last step split (ms): " + ", ".join(
        f"{k} {v:.1f}" for k, v in split.items())
        + " (loader wait: host clock; the rest: CUDA events); loader wait "
        "per step (ms): " + ", ".join(
            f"{clock.breakdown(i)['loader wait']:.1f}" for i in range(n)))
    total = Counter(launches)
    # (c) the evaluation entry point on that checkpoint, by epoch and path
    print("-- 7c: python -m bodyct_dram_emph_subtype_tpu_torch.evaluate")
    per_fwd = per_forward(kind="cls")
    forwards = -(-4 // B)
    argv = ["--model_arch", "med3d", "--data_path", str(work),
            "--train_csv", csv, "--valid_csv", csv, "--test_csv", csv,
            "--model_path", str(models), "--batch_size", str(B),
            "--workers", "4", "--compute_dtype", "bfloat16",
            "--packed_decoder", "--device", "cuda"]
    results = []
    for ckp in ("0", str(trainer.ckpt.path(0))):
        cuda_build.reset_launches()
        results.append(evaluate_main(argv + ["--ckp", ckp]))
        torch.cuda.synchronize()
        got = cuda_build.launches()
        check(got == {k: v * forwards for k, v in per_fwd.items()},
              f"evaluate --ckp {ckp}: launches {got}")
        total.update(got)
    check(results[0] == results[1], f"by epoch {results[0]} vs by path "
          f"{results[1]}")
    print(f"--ckp 0 and --ckp {trainer.ckpt.path(0).name}: equal metrics, "
          f"acc_cle {results[0]['epoch_test_acc_cle']:.3f} acc_pse "
          f"{results[0]['epoch_test_acc_pse']:.3f}; launches per forward "
          + ", ".join(f"{k} {v}" for k, v in per_fwd.items() if v)
          + f" (no B, no F) over {forwards} forwards each")
    # (f) the whole forward, bf16 against float32 on the same weights
    print("-- 7f: bf16 vs float32 forward of the trained med3d, one batch")
    batch = next(iter(trainer._loader("test", 0)))
    x = torch.from_numpy(np.asarray(batch["image"], np.float32)).to(DEV)
    model = trainer.model.eval()
    with torch.inference_mode():
        dense16, pooled16 = model(x[..., None].to(torch.bfloat16))
        dense32, pooled32 = model(x[..., None])
    torch.cuda.synchronize()
    worst, agree, total_labels = 0.0, 0, 0
    for p16, p32, d16 in zip(pooled16, pooled32, dense16):
        check(d16.dtype == torch.bfloat16 and p16.dtype == torch.float32
              and bool(torch.isfinite(p16).all()), "bf16 outputs")
        worst = max(worst, ((p16 - p32).abs().max()
                            / p32.abs().max()).item())
        agree += int((p16.argmax(-1) == p32.argmax(-1)).sum())
        total_labels += p16.shape[0]
    print(f"pooled logits max|d| / max|logit| {worst:.3e} "
          f"(<= {CLS_POOLED_BOUND:g}); argmax labels equal "
          f"{agree}/{total_labels}; dense "
          + ", ".join(str(tuple(d.shape)) for d in dense16))
    check(worst <= CLS_POOLED_BOUND, "bf16 pooled logits")
    del dense16, dense32, model, trainer
    torch.cuda.empty_cache()
    # (d) the trainers' default routing: unpacked decoder
    print("-- 7d: the trainers' default routing (packed_decoder False)")
    cfg = trainer_config(work, model_arch="med3d",
                         model_path=str(work / "models_default"))
    trainer = SubtypeTrainer(cfg)
    trainer.init_state()
    trainer.setup_checkpointing()
    losses, clock, launches, _, peak_d = fit_logged(trainer)
    n = check_steps(losses, clock, per_train_step(DEFAULT_TRAIN_SITES, "cls"),
                    "med3d default routing")
    check(n == 2, f"{n} med3d default-routing train steps")
    _, eval_launches = check_eval(
        trainer, per_forward(packed_decoder=False, kind="cls"),
        "med3d default routing")
    wall_d = clock.wall_ms()
    print(f"test eval launches " + ", ".join(
        f"{k} {v}" for k, v in eval_launches.items() if v)
        + f" over {forwards} forwards (A 12, C 1 each); step ms (loader to "
        f"loader) " + ", ".join(f"{t:.1f}" for t in wall_d)
        + f"; peak device memory {peak_d / 2 ** 30:.2f} GiB")
    total.update(launches)
    total.update(eval_launches)
    return total, {"step_ms": med, "volumes_s": B / med * 1e3,
                   "peak_gib": peak / 2 ** 30,
                   "default_step_ms": wall_d[-1]}


DDP_WORLD = 2
DDP_LR = 1e-6                    # phase 8's learning rate
DDP_LOSS_RTOL = 1e-3             # phase 8: per-step loss, relative
DDP_MEDIAN_LR = 0.05             # phase 8: median |d param| over lr
# the decoder conv biases that feed a train BatchNorm, which removes them:
# their gradients are rounding noise
PRE_BN_BIAS = re.compile(r"us[12]\.conv_blocks\.\d\.0\.bias|us3\.0\.bias")


def ddp_argv(work: Path):
    """Phase 8's training-CLI flags over the archive in ``work``."""
    csv = str(work / "merged.csv")
    return ["--model_arch", "med3ddram", "--lr", str(DDP_LR),
            "--max_epochs", "1",
            "--batch_size", "1", "--num_samples", "1", "--workers", "4",
            "--data_path", str(work), "--train_csv", csv, "--valid_csv", "",
            "--test_csv", csv, "--model_path", str(work / "models_ddp"),
            "--seed", "0", "--sampler_seed", "0", "--compute_dtype",
            "bfloat16", "--packed_decoder", "--device", "cuda"]


def condition_heads(model) -> None:
    """Scale the dRAM heads as ``tests/test_torch_train_step.py`` does
    (weights x0.05, bias -1.5: both maps near 0.2).  At the seed's init
    the maps saturate or sum to about 1, where ``clamp(cle + pse, 0, 1)``
    of the coverage loss turns rounding noise into whole gradient flips:
    the one process on the card against the CPU then differs by
    ||d|| / ||g|| of 0.6-1.2 even in float32, so no comparison of
    gradients could see a fault."""
    with torch.no_grad():
        for fc in model.fcs:
            fc.weight.mul_(0.05)
            fc.bias.fill_(-1.5)


def grad_spread(got, want):
    """(median, max, arg max) over the tensors of ``||got - want|| /
    ||want||``, without the decoder biases before a train BN."""
    rel = {n: ((got[n] - g).norm() / g.norm().clamp_min(1e-30)).item()
           for n, g in want.items() if not PRE_BN_BIAS.fullmatch(n)}
    order = sorted(rel.values())
    top = max(rel, key=rel.get)
    return order[len(order) // 2], rel[top], top


def bf16_grad_noise(trainer):
    """The bf16 noise floor of phase 8's gradients: ``grad_spread`` of the
    first train step of ``trainer``'s model (before it trains) in bf16
    against the same step in float32, on a copy, same batch and draws."""
    batch = next(iter(trainer._loader("train", 0)))
    grads = []
    for dtype in (torch.bfloat16, torch.float32):
        model = copy.deepcopy(trainer.model)
        step = make_reg_train_step(
            model, make_optimizer(model.parameters(), DDP_LR),
            num_data_shards=DDP_WORLD, compute_dtype=dtype, device=DEV,
            target_size=TARGET)
        gen = torch.Generator(DEV).manual_seed(step_seed(0, 0, 0))
        step(batch, DDP_LR, trainer.cle_class_weights,
             trainer.pse_class_weights, generator=gen)
        grads.append({n: p.grad.float().cpu()
                      for n, p in model.named_parameters()})
        del model, step
    torch.cuda.empty_cache()
    return grad_spread(grads[0], grads[1])


def keep_first_grads(trainer, path: Path) -> None:
    """Save the parameters' gradients after ``trainer``'s first train
    step to ``path`` (float32, on the CPU)."""
    step = trainer._train_step

    def first(*args, **kw):
        out = step(*args, **kw)
        if not path.exists():
            torch.save({n: p.grad.float().cpu() for n, p in
                        trainer.model.named_parameters()}, path)
        return out

    trainer._train_step = first


def ddp_rank(work: Path) -> None:
    """One rank of phase 8 (``--ddp-rank``): the training CLI's flow with
    each step's losses and launches logged; writes ``ddp_rank<r>.json``."""
    torch.backends.cudnn.allow_tf32 = False        # as phase 1 sets them
    torch.backends.cuda.matmul.allow_tf32 = False
    argv = ddp_argv(work) + ["--multihost"]
    args = build_parser().parse_args(argv)
    with distributed("bodyct_dram_emph_subtype_tpu_torch.train", args,
                     argv) as (device, rank):
        trainer = SubtypeTrainer(make_config(args, device))
        trainer.init_state()
        trainer.setup_checkpointing()
        check(not trainer.try_resume(), "phase 8 resumed")
        condition_heads(trainer.model)
        if rank == 0:
            keep_first_grads(trainer, work / "ddp_grads_ranks.pt")
        losses, clock, launches, fit_s, peak = fit_logged(trainer)
        n = check_steps(losses, clock, PER_TRAIN_STEP, f"rank {rank}")
        check(n == 2, f"rank {rank}: {n} train steps")
        best = trainer.restore_best()
        cuda_build.reset_launches()
        metrics = trainer.evaluate("test", epoch=best)
        torch.cuda.synchronize()
        eval_launches = cuda_build.launches()
        fractions = {}
        for part in gather_objects(forward_fractions(trainer, "host")):
            fractions.update(part)
        (work / f"ddp_rank{rank}.json").write_text(json.dumps({
            "losses": losses, "wall_ms": clock.wall_ms(),
            "launches": dict(Counter(launches) + Counter(eval_launches)),
            "metrics": metrics, "peak_gib": peak / 2 ** 30,
            "fractions": {str(k): v for k, v in fractions.items()},
            "backend": torch.distributed.get_backend(),
            "device": str(device)}))


def phase_ddp(work: Path):
    print("== phase 8: data parallelism (2 ranks, --multihost, med3ddram, "
          "bf16, B=1 per rank, packed decoder; gloo on one card, NCCL on "
          "two) against one process at B=2, num_data_shards=2")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    procs = []
    t0 = time.perf_counter()
    try:
        for r in range(DDP_WORLD):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                       WORLD_SIZE=str(DDP_WORLD),
                       LOCAL_WORLD_SIZE=str(DDP_WORLD),
                       MASTER_ADDR="localhost", MASTER_PORT=port)
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--ddp-rank", str(work)], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks_s = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode:
            print(out[-6000:])
        check(p.returncode == 0, f"phase 8 rank {r} exited {p.returncode}")
    ranks = [json.loads((work / f"ddp_rank{r}.json").read_text())
             for r in range(DDP_WORLD)]
    check(ranks[0]["losses"] == ranks[1]["losses"],
          "the ranks' global losses differ")
    check(ranks[1]["metrics"] == {}, "rank 1 reported epoch metrics")
    print(f"2 ranks ({ranks[0]['backend']}; "
          + ", ".join(r["device"] for r in ranks)
          + f") ran in {ranks_s:.1f} s (start, build cache load, 2 "
          f"steps, test evaluation); step ms (loader to loader) rank 0 "
          + ", ".join(f"{t:.1f}" for t in ranks[0]["wall_ms"])
          + ", rank 1 " + ", ".join(f"{t:.1f}" for t in ranks[1]["wall_ms"])
          + f"; peak device memory per rank "
          + ", ".join(f"{r['peak_gib']:.2f}" for r in ranks) + " GiB")
    # the one-process reference: B=2 holds rank 0's and rank 1's rows
    cfg = trainer_config(work, num_samples=1, packed_decoder=True,
                         lr=DDP_LR, model_path=str(work / "models_ddp_ref"))
    ref = SubtypeTrainer(cfg)
    ref.init_state()
    ref.setup_checkpointing()
    condition_heads(ref.model)
    ref._train_step = make_reg_train_step(
        ref.model, ref.optimizer, num_data_shards=DDP_WORLD,
        compute_dtype=torch.bfloat16, device=DEV, target_size=TARGET)
    keep_first_grads(ref, work / "ddp_grads_one.pt")
    floor = bf16_grad_noise(ref)
    losses, clock, _, _, _ = fit_logged(ref)
    check(len(losses) == 2, f"{len(losses)} reference steps")
    worst = 0.0
    for i, (got, want) in enumerate(zip(ranks[0]["losses"], losses)):
        rel = {k: abs(got[k] - v) / max(abs(v), 1e-12)
               for k, v in want.items()}
        worst = max(worst, max(rel.values()))
        print(f"step {i}: 2 ranks loss {got['loss']:.6f}, one process "
              f"{want['loss']:.6f}; relative |d| " + ", ".join(
                  f"{k} {v:.2e}" for k, v in rel.items()))
    grads = [torch.load(work / f"ddp_grads_{n}.pt", weights_only=True)
             for n in ("ranks", "one")]
    med, worst_g, top = grad_spread(grads[0], grads[1])
    print(f"first step's gradients, ||d|| / ||g|| per tensor (not the "
          f"decoder biases before a train BN): DDP's mean against one "
          f"process median {med:.2e}, max {worst_g:.2e} ({top}); the one "
          f"process's bf16 against its float32 (the noise floor) median "
          f"{floor[0]:.2e}, max {floor[1]:.2e} ({floor[2]})")
    check(med <= 2 * floor[0] and worst_g <= 2 * floor[1],
          "phase 8 gradients beyond twice the bf16 noise floor")
    check(worst <= DDP_LOSS_RTOL, f"phase 8 losses differ by {worst:.2e}")
    exp = work / "models_ddp" / "subtyping_med3ddram"
    ckpts = sorted(p.name for p in (exp / "checkpoints").iterdir())
    check(ckpts == ["epoch_0000.pt"], f"checkpoints {ckpts}")
    saved = torch.load(exp / "checkpoints" / ckpts[0], map_location="cpu",
                       weights_only=True)["model"]
    lr = cfg.lr
    d = torch.cat([(saved[k].float() - v.detach().float().cpu()).abs()
                   .reshape(-1) for k, v in ref.model.named_parameters()])
    print(f"parameters after 2 steps: median {d.median().item() / lr:.4f} "
          f"lr (<= {DDP_MEDIAN_LR:g}), max|d| {d.max().item() / lr:.3f} lr "
          f"(not held: Adam's reach is 2 lr per step), "
          f"{(d > 0.5 * lr).float().mean().item():.2e} of the "
          f"{d.numel()} elements beyond 0.5 lr")
    check(d.median().item() <= DDP_MEDIAN_LR * lr,
          "phase 8 parameters: median")
    phases = [json.loads(line)["phase"] for line in
              (exp / "metrics.jsonl").read_text().splitlines()]
    check(phases == ["train", "test"], f"metrics.jsonl phases {phases}")
    best = ref.restore_best()
    ref.evaluate("test", epoch=best)
    rows = {}
    for name, root in (("ranks", exp), ("one", cfg.exp_path)):
        with open(root / "predicts" / "test" / "0_predicts.csv") as f:
            rows[name] = f.read().split()
    check(len(rows["ranks"]) == 5 and rows["ranks"] == rows["one"],
          f"test CSVs {rows}")
    want = forward_fractions(ref, "host")
    frac = max(abs(a - b) for k, v in want.items()
               for a, b in zip(ranks[0]["fractions"][str(k)], v))
    print(f"test labels equal over {len(want)} scans (the gathered, "
          f"de-duplicated CSV of rank 0); lesion fractions |d| {frac:.2e} "
          f"(<= {FRAC_BOUND:g}); rank 0 alone wrote the checkpoint, "
          f"the CSVs and metrics.jsonl ({phases})")
    check(frac <= FRAC_BOUND, "phase 8 lesion fractions")
    launches = Counter()
    for r in ranks:
        launches.update(r["launches"])
    return launches


def profile_window(trace, steps=(1, 2, 3)):
    """(busy share, window ms, {kernel name: total ms}) of the device over
    the steps ``steps`` (0-based) of a profiled epoch: the kernels whose
    launch lies inside those steps' stage spans, the window from the first
    of them to start to the last to end, and the union of every kernel's
    interval inside it."""
    events = trace["traceEvents"]
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            spans.setdefault(e["name"], []).append(e)
    first, last = spans["augment"][steps[0]], spans["optimizer"][steps[-1]]
    t0, t1 = first["ts"], last["ts"] + last["dur"]
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") == "cuda_runtime" and t0 <= e["ts"] <= t1
                and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    mine = [e for e in kernels if e["args"].get("correlation") in launched]
    check(mine, "phase 8b: no device kernel in the profiled steps")
    w0 = min(e["ts"] for e in mine)
    w1 = max(e["ts"] + e["dur"] for e in mine)
    busy, end = 0.0, w0
    totals = Counter()
    for e in sorted(kernels, key=lambda e: e["ts"]):
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        totals[e["name"]] += (b - a) / 1e3
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / (w1 - w0), (w1 - w0) / 1e3, totals


def phase_profile(work: Path):
    print("== phase 8b: --profile on phase 6's setup (med3ddram, bf16, B=2, "
          "packed decoder, one epoch of 4 steps)")
    cfg = trainer_config(work, num_samples=2, packed_decoder=True,
                         profile=True, model_path=str(work / "models_prof"))
    trainer = SubtypeTrainer(cfg)
    trainer.init_state()
    trainer.setup_checkpointing()
    t0 = time.perf_counter()
    losses, clock, launches, fit_s, _ = fit_logged(trainer)
    n = check_steps(losses, clock, PER_TRAIN_STEP, "profiled")
    check(n == 4, f"{n} profiled steps")
    path = cfg.exp_path / "profile" / "rank0.json"
    check(path.exists(), f"no trace at {path}")
    trace = json.loads(path.read_text())
    names = Counter(e["name"] for e in trace["traceEvents"]
                    if e.get("cat") == "user_annotation")
    for stage in ("augment", "forward", "backward", "optimizer"):
        check(names[stage] == n, f"trace spans {dict(names)}")
    share, window_ms, totals = profile_window(trace)
    wall = clock.wall_ms()
    print(f"trace {path.name}: {path.stat().st_size / 2 ** 20:.1f} MiB, "
          f"{len(trace['traceEvents'])} events, spans "
          + ", ".join(f"{k} {v}" for k, v in sorted(names.items()))
          + f"; profiled step ms (loader to loader) "
          + ", ".join(f"{t:.1f}" for t in wall)
          + f"; fit with the trace export {time.perf_counter() - t0:.1f} s")
    print(f"device busy share of steps 2-4: {share:.3f} of a "
          f"{window_ms:.1f} ms window (the union of kernel intervals)")
    print("top 10 device kernels of steps 2-4 (total ms): ")
    for name, ms in totals.most_common(10):
        print(f"  {ms:8.2f}  {name[:110]}")
    return Counter(launches), {"busy": share, "window_ms": window_ms}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--masked-sums-only", action="store_true",
        help="run phases 1, 2 and 3d only (kernel F); copied into another "
             "checkout, this times that checkout's F by the same method")
    parser.add_argument(
        "--ddp-only", action="store_true",
        help="run phases 1, 2, 4, 4f and 8 only; on a host with two or "
             "more cards the ranks of 4f and 8 take a card each (NCCL)")
    parser.add_argument("--ddp-rank", type=Path, default=None,
                        help=argparse.SUPPRESS)   # phase 8's ranks
    flags = parser.parse_args()
    if flags.ddp_rank is not None:
        ddp_rank(flags.ddp_rank)
        return
    if flags.masked_sums_only:
        phase_environment()
        phase_build()
        phase_masked_sums()
        return
    if flags.ddp_only:
        phase_environment()
        phase_build()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            model, scan_dir, lobe_dir, _, _, _, _, fractions, _ = \
                phase_main_path(Path(tmp))
            phase_processor_ranks(model, scan_dir, lobe_dir, Path(tmp),
                                  fractions)
            del model
            torch.cuda.empty_cache()
            work = Path(tmp) / "train"
            work.mkdir()
            write_archive(work)
            phase_ddp(work)
        return
    card = phase_environment()
    phase_build()
    summary = phase_kernels()
    summary["conv3x3x3_wgrad"], _ = phase_train_kernels()
    summary.update(phase_mode_kernels())
    summary["masked_sums"] = phase_masked_sums()
    main_launches, main_ops = Counter(), Counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        model, scan_dir, lobe_dir, launches, stage, rate, results, \
            fractions, gated = phase_main_path(Path(tmp))
        main_launches.update(launches)
        phase_small_reference()
        launches, ops = phase_modes(model, scan_dir, lobe_dir, Path(tmp),
                                    results)
        main_launches.update(launches)
        main_ops.update(ops)
        phase_bf16_vs_f32(model, scan_dir, lobe_dir)
        launches, host_rate = phase_host_path(model, scan_dir, lobe_dir,
                                              Path(tmp), fractions)
        main_launches.update(launches)
        main_launches.update(phase_gated_overflow(model, scan_dir, lobe_dir,
                                                  Path(tmp), fractions))
        launches, ranks_rate, ranks_wall = phase_processor_ranks(
            model, scan_dir, lobe_dir, Path(tmp), fractions)
        main_launches.update(launches)
        del model
        torch.cuda.empty_cache()
        work = Path(tmp) / "train"
        work.mkdir()
        train_launches, train = phase_train(
            work, (Path(tmp) / "ct1", Path(tmp) / "lobes1"))
        main_launches.update(train_launches)
        launches, ops, pallas_train = phase_train_pallas(work)
        main_launches.update(launches)
        main_ops.update(ops)
        launches, default_train = phase_train_default(work)
        main_launches.update(launches)
        launches, train50 = phase_train50(work)
        main_launches.update(launches)
        work = Path(tmp) / "device_pipeline"
        work.mkdir()
        launches, pipes, pre_ms = phase_device_pipeline(work)
        main_launches.update(launches)
        work = Path(tmp) / "cls"
        work.mkdir()
        launches, cls = phase_cls(work)
        main_launches.update(launches)
        main_launches.update(phase_ddp(Path(tmp) / "train"))
        launches, profiled = phase_profile(Path(tmp) / "train")
        main_launches.update(launches)
    for mode in ("roll", *MODES):
        phase_train_small(mode)
    phase_train_small("roll", "med3dtiny")
    kernels = []
    for name, s in summary.items():
        source, replaces = SOURCES[name]
        count = main_ops[name] if name in MODES.values() else \
            main_launches[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": count,
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": ("bytes" if s["bytes_ms"] >= s["ops_ms"]
                         else "operations"),
            "library_ms": s["library_ms"]})
    print(f"card: {card}; main path {rate:.3f} scans/s (upload "
          f"{gated['bytes_per_scan'] / 1e6:.2f} MB per scan, parent "
          f"{gated['parent_bytes_per_scan'] / 1e6:.2f}; packing "
          f"{gated['pack_ms']:.1f} ms per batch), host path "
          f"{host_rate:.3f} scans/s, two ranks on {torch.cuda.device_count()}"
          f" card(s) (4f) {ranks_rate:.3f} scans/s by the slowest rank's "
          f"pipeline ({3 / ranks_wall:.3f} by the launch's wall); training "
          f"{train['step_ms']:.1f} ms per B=2 bf16 step "
          f"({train['volumes_s']:.3f} volumes/s, peak "
          f"{train['peak_gib']:.2f} GiB); pallas-mode training "
          f"{pallas_train['step_ms']:.1f} ms for its second step (peak "
          f"{pallas_train['peak_gib']:.2f} GiB); the trainers' default "
          f"routing {default_train['step_ms']:.1f} ms (peak "
          f"{default_train['peak_gib']:.2f} GiB); med3ddram50 "
          f"{train50['step_ms']:.1f} ms (peak {train50['peak_gib']:.2f} GiB); "
          f"med3d (CLS) {cls['step_ms']:.1f} ms ({cls['volumes_s']:.3f} "
          f"volumes/s, peak {cls['peak_gib']:.2f} GiB), default routing "
          f"{cls['default_step_ms']:.1f} ms; device input pipeline (6f, "
          f"ragged archive) {pipes['device']['step_ms']:.1f} ms "
          f"({pipes['device']['volumes_s']:.3f} volumes/s, loader wait "
          f"{statistics.median(pipes['device']['waits'][1:]):.1f} ms, fused "
          f"preprocess {pre_ms:.2f} ms per batch) against the host "
          f"pipeline's {pipes['host']['step_ms']:.1f} ms (loader wait "
          f"{statistics.median(pipes['host']['waits'][1:]):.1f} ms); "
          f"device busy share of profiled steps 2-4 (8b) "
          f"{profiled['busy']:.3f} of {profiled['window_ms']:.1f} ms; "
          f"launches are the main paths' "
          f"(phases 4, 4c, 4d, 4e, 4f summed over its ranks, 6 with its "
          f"train -> deploy check, 6c, 6d, 6e, 6f, 7, 8, 8b); kernel ms "
          f"per B=2 "
          f"bf16 dRAM forward (A, B, "
          f"C, E: default or quad path; the conv-mode ops: their mode's "
          f"forward), train step (D) or device-path batch (F, float32 "
          f"maps), summed over the sites")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
