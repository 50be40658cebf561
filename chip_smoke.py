#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Imports only the port (``greedy_multimodal_learning_tpu_torch``), never jax.
Phases, each of which fails the run (non-zero exit) when it fails:

1. the card's name and power limit; build every CUDA kernel (the gating
   forward and backward and the masked BatchNorm, one ``nvcc`` each, started together) from the
   sources in this checkout; TF32 off for the float32 phases;
2. the forward kernel against its plain PyTorch version on the card at the
   shapes the model gives it (the three 224² fusion sites at B=128, plus a
   ragged B=5, an oversize sample, S=3136 at C=128, that takes the
   streaming plan in float32, and the three sites of phase 16's kernel
   path, 112² views at B=8: S 196, 49, 16 at C 128, 256, 512), float32 and
   bfloat16, each case's plan printed; two runs give the same
   bits; one call is one CUDA launch (counted by the kernel's C code at
   each launch, and seen on the card by the profiler); times from
   CUDA events, and each site's launch plan (cluster size, samples a tile,
   resident maps, shared memory, clusters on the card);
3. the serving path at full width: ``predict_`` with
   ``configs/training_guided.gin`` + ``MMTM_mitigate.use_pallas=True`` over a
   synthetic 224², 2-view, 40-class split of 200 test samples (one padded
   batch of 128) from a seeded checkpoint in the JAX package's ``.pt``
   layout, in float32 and with the ``configs/tpu_bf16.gin`` mixin; the
   kernel's launch count must show every fusion site of every batch; the
   float32 logits must agree with the eager gating path, and a small input
   must agree with the port's CPU forward.  Every entry run (phases 3, 5, 7,
   8, 9 and 11) reads its data through the device-resident corpus, the
   default: each split it iterates must have its corpus on the card (the
   corpus bytes are logged);
4. the backward kernels against their plain version at the same shapes and
   dtypes (oversize and phase 16's sites included), two runs
   bit-identical, two CUDA launches a call (counted as in phase 2), with
   the time beside the bound, the plain version's and torch autograd of the
   eager gating's;
4b. the masked train-mode BatchNorm kernels (``csrc/masked_batch_norm.cu``)
   at every BatchNorm shape of the two training cells (2-D: B=128 at 224²,
   64×112² to 512×7²; 3-D: B=8 at 16×112², 64×16×56² to 512×2×7²), float32
   and bfloat16, channels-last, the masked tail (115 of 128 rows; 7 of 8),
   with and without the ReLU, against their plain version (y, the saved
   statistics, dx, dweight, dbias, the running statistics); two runs
   bit-identical, one CUDA launch a call each way; each site's forward and
   backward timed (median of 20, L2 flushed) beside its bounds and the
   plain ops' forward and autograd backward; then one forward and backward
   of each family's model at full width on the kernels against the plain
   ops from one state (the launches: 40 and 60 calls each way), with the
   plain ops against themselves and against a one-ulp nudge of the input
   beside it;
5. the training path at full width: the ``train`` entry with
   ``configs/training_guided.gin`` + ``MMTM_mitigate.use_pallas=True``,
   ``train.batch_size=128``, over a synthetic split of 256 train, 128
   validation and 128 test samples, ``training_loop.n_epochs=3`` (two
   epochs), in float32 and bfloat16; the forward kernel must have run 3 x
   (train steps + eval batches) times and the backward 3 x train steps, at
   least one step curated, every loss finite, every artifact written;
6. one guided step from identical state, batch and flips on the kernel path
   and on the eager path, with curation off and on (float32, TF32 off):
   the updated parameters, BatchNorm statistics and MMTM buffers agree
   (per tensor, the L2 of the difference within ``STEP_TOL`` of the
   update's L2; the eager step run twice is printed beside it); and
   guided-step samples/s with a device-resident batch, kernel path and
   eager path, float32 and bfloat16;
7. the eval path at full width in phase 5's float32 run (train -> record ->
   flow-off), through ``eval_``: (a) the recording pass
   (``configs/recording.gin`` + ``MMTM_mitigate.use_pallas=True``, B=128) over
   the whole train file (``valid_size=0``: phase 5's 256 train and 128
   validation samples), float32 and bfloat16, the forward kernel launched 3 x
   batches, the pickle's nesting and indices checked, and the float32 maps
   within the kernel's ``sq`` tolerance of the same pass with
   ``use_pallas=False``; (b) the same recording with
   ``evalution_loop.ondevice_rescale=True``, whose means must be within 1e-5
   relative of ``get_rescale_weights`` over the pickle; (c) the flow-off pass
   (``configs/eval.gin`` + ``use_pallas=True``) over the 128 test samples,
   which launches no kernel, with finite metrics, and a small flow-off input
   on the card against the port's CPU forward; samples/s of each pass;
8. resume on the card, float32 with the kernels and cuDNN's deterministic
   algorithms: ``training_loop.n_epochs=3`` straight through (twice: the
   run-to-run floor) against ``n_epochs=2`` followed by ``resume=True,
   n_epochs=3``; the same history epochs, the restored step and controller
   equal to the sidecar's, the final parameters and buffers per tensor
   within ``STEP_TOL`` of the resumed epoch's update (L2), the backward
   kernel launched 3 x the resumed run's train steps; two straight runs
   with cuDNN's default (non-deterministic) algorithms are printed beside;
9. the other controllers through the ``train`` entry on phase 5's split,
   float32 with the kernels, two epochs: ``configs/training_random.gin``
   (no step curated before its ``starting_epoch``, each step's decision the
   JAX package's draw from the seed's key chain), ``configs/training_weakest.gin`` (the target
   designated after epoch 1 from the validation accuracies, curated on the
   duty cycle in epoch 2) and the guided configuration with
   ``Bias_Mitigation_AdaptiveWeakest`` in place of the guided callback
   (four epochs, windows of one step; each step's window decision as the
   rule gives it from the designated targets, and at least one window
   opened); launches 3 x (train steps + eval batches)
   forward and 3 x train steps backward, finite losses, every artifact;
10. cached against streamed: ``configs/training_guided.gin`` with the
   kernels on a synthetic split of 1,024 train, 128 validation and 128
   test samples, three epochs, float32 and bfloat16, with
   ``get_mvdcndata.device_cache=False`` and with the default, cuDNN
   deterministic: the same history and bit-identical parameters and
   buffers; ``train_samples_per_sec`` of epochs 2 and 3 of each (when the
   histories differ, the cells that differ and a second streamed run's
   agreement with each are printed before the phase fails);
11. the 3-modality 3D-CNN family at full width (three r3d-18 towers, 25
   classes, RGB + depth + flow clips of 16 frames of 112², B=8) on a
   synthetic split of 80 train-file clips (64 train, 16 validation) and 16
   test clips: ``train`` with ``configs/training_3dcnn_guided.gin`` in
   float32 and bfloat16 (``MMTM_3DCNN.compute_dtype``), two epochs, at least
   one step curated, and with ``configs/training_3dcnn_random.gin`` (each
   step's decision the key chain's draw over modes 0..3); ``eval_``
   with ``configs/recording_3dcnn.gin`` over the whole train file (the
   pickle nests 3 MMTMs x 3 modalities) and ``configs/eval_3dcnn.gin``
   (flow off) over the test split, on the float32 run's
   ``model_best_val.pt``; ``predict_`` with ``model='MMTM_3DCNN'``; a small
   input (B=2, 4 frames of 32²) on the card against the port's CPU forward.
   Every run finite, every artifact written, each split resident on the
   card, and neither gating kernel launched (the family's gating is eager,
   as in the JAX package); samples/s of each run;
12. the side entries and options on the 2-D family at full width, in phase
   5's split, float32 run and phase 7's recording (kernels, B=128, TF32
   off): (a) ``predict_`` with ``fold_bn=True`` on ``model_best_val.pt``,
   its logits against the unfolded run's, 3 forward launches a batch, and
   the folded and unfolded forward's ms on a resident batch; (b)
   ``run_api.run_entry("eval", ...)`` with ``configs/recording.gin`` and
   ``evalution_loop.fold_bn_eval=True``, its maps within the ``sq``
   tolerance of phase 7's unfolded recording; (c) the ``eval_sweep`` entry
   over ``model_best_val.pt`` and ``model_last_epoch.pt`` (K=2), each row
   against a separate ``eval_`` of its checkpoint (rtol 1e-5), 3·K forward
   launches a batch, and the sweep's samples/s against two one-checkpoint
   sweeps over the same 1,024 resident samples; (d) two epochs with
   ``MMTM_MVCNN.remat=True`` against the same run without, cuDNN
   deterministic: final tensors within ``STEP_TOL`` of the update, equal
   launch counts, the peak device memory of each, and the guided step's
   samples/s and peak memory with and without remat over 20 steps each on
   a resident batch; (e) an epoch with ``stem_s2d`` (the plain stem, as
   the flag only keeps the JAX package's refusal of odd sizes); (f) an epoch
   each with ``MMTM_mitigate.SEonly`` and ``shareweight``, which launch
   neither kernel; (g) ``pretraining=True`` from a seeded torchvision-layout
   ResNet-18 file: both trunks equal the file before the first step, then
   an epoch; (h) ``Trainer.enable_profiling`` over an epoch: one trace that
   names both gating kernels.  Every run finite, every artifact written,
   each split resident on the card; samples/s of each run;
13. data parallelism on the 2-D family at full width (224², 2 views, 40
   classes, ``configs/training_dp_v5e8.gin``'s global batch of 256 at lr
   0.4) in phase 5's split: (a) the ``train`` entry with
   ``configs/training_guided.gin#configs/training_dp_v5e8.gin`` at world 1
   (a one-rank NCCL group, bf16) against the same bindings with
   ``training_loop.data_parallel=False``, cuDNN deterministic, two epochs:
   the same history, every tensor bit-identical, the launches of phase 5's
   rule, the collectives of each train step (> 0); (b) two ranks sharing
   cuda:0 in a gloo group (NCCL refuses two ranks on one card) against one
   process, f32, TF32 off: three guided steps, each from the one process's
   start, the last with the second rank's rows all padding: per tensor
   within ``STEP_TOL`` of the update (L2), the same curation decisions,
   losses within rtol 1e-4, both ranks' states identical, 3 forward and 3
   backward launches a step on each rank; (c) the recording ``eval_`` with
   ``evalution_loop.data_parallel`` at the two ranks against one process:
   every index once in the one process's order, the maps within the
   kernel's ``sq`` tolerance.  Samples/s of (a) both ways and of (b), the
   latter for correctness only (gloo goes through the host);
14. tensor parallelism on the 2-D family at full width, ranks sharing
   cuda:0 in gloo groups: (a) dp 1 × tp 2 (B=128, f32, TF32 off, cuDNN's
   default algorithms, SGD momentum 0.9) against one process: three guided
   steps, each from the one process's start, the last curating modality 1
   with padding rows: per tensor within ``STEP_TOL`` of the update (L2),
   the same curation decisions, losses within rtol 1e-4, both ranks' whole
   states identical, on each rank 26 weights and their momentum buffers
   holding half their output rows, 3 forward and 3 backward launches a
   step on each rank, the collectives and their bytes a step by group, of
   which one broadcast of the replicated buffers (the BatchNorm statistics
   and MMTM running averages, 83,980 bytes) over the model group, after
   which they are equal on both ranks (phase 13's steps at model size 1
   broadcast none); (b)
   the ``train`` entry with ``configs/training_guided.gin#configs/training_dp_v5e8.gin``
   and ``training_loop.model_parallel=2`` at dp 2 × tp 2 (four ranks, bf16,
   B=256 at lr 0.4), two one-step epochs: every rank's whole state (the
   model, SGD's momentum, the controller) equal bit for bit, the JAX
   columns of phase 13's history, the checkpoint with the names and full
   shapes of phase 13's world-1 checkpoint, which the one-process port
   loads, phase 13's launches on every rank; (c) the recording ``eval_``
   at tp 2 against phase 13's one-process recording: every index once in
   its order, the maps within the kernel's ``sq`` tolerance.  Samples/s of
   each, for correctness only;
15. the JAX package's random streams and ``training_loop.orbax_dir`` on the
   2-D family at full width (224², B=128, kernels): (a) ``init_model(777)``
   on the card bit-identical to the CPU's for both families at full width,
   with the seconds of each; (b) 5 steps' flips ((B, V) and (B,)) and random
   controller decisions on the card equal to the CPU's and to the seed's
   key chain, and the host microseconds of a step's draws; (c) the ``train``
   entry with ``configs/training_random.gin``, ``orbax_dir`` and
   ``orbax_max_to_keep=2`` over 3 epochs under cuDNN's deterministic
   algorithms: snapshots 2 and 3 kept, the same run without snapshots and
   a 2-epoch run (world 1 over NCCL, the saves over a gloo group beside it)
   resumed from its newest snapshot bit-identical to it
   (history, decisions, whole state), how long each save held the loop
   against a synchronous ``dcp.save``, the bytes of a snapshot, the epoch
   times with and without (the epoch after the first save against the same
   epoch without), and the seconds of the set-up save
   ``Snapshots.__init__`` makes before epoch 1; (d) a snapshot of dp 1 × tp 2 gloo ranks on
   cuda:0 (one guided step each) restored into one process at tp 1: the
   ranks' whole state, from 4 × 26 row-block keys;
16. the paper's run-level experiment (``experiments/``), both families:
   (a) the 2-D north-star driver in this process, seed 777, guided,
   random and weakest, ``--epochs 3`` (two run) over the generator's
   default corpus (1,200 train and 400 test models, 12 views of 112², 40
   classes), then the recording and flow-off passes; then (d) the guided
   arm again with the driver's ``--bind "#MMTM_mitigate.use_pallas=True"``
   (the kernel path, its own work directory over the same corpus); in a
   process of its own started first and run beside (a): (b) the 3-D
   driver at its defaults (400 + 150 clips of 8 frames of 32², width 0.5),
   seed 7, ``--epochs 3``, the guided, random, weakest80 and adaptive
   arms, its phases in that process, and (c) its guided run cut after
   epoch 1 and finished by the driver's resume path, whose history equals
   (b)'s straight run's (cuDNN deterministic in that process).
   Each summary has the keys of the JAX package's for its family, finite
   values, every artifact written; the port's ``experiments.analyze``
   reads them (subprocesses, rc 0); neither gating kernel launches in
   (a)-(c) (``use_pallas`` stays the configs' False, as in the JAX
   package's recorded runs), both launch in (d), where the train
   process's ``regime.json`` records its launches (> 0 both ways, its
   backward ones all of the run's) and the binding; each run's
   accuracies, flow-off accuracies and samples/s are logged, and the
   numeric regime each suite ran in: the ``train.matmul_precision`` its
   arms bind and the TF32 switches of its process;
17. a ``{"kernels": [...]}`` JSON line (with the launch counts of each 3D
   run, all 0, of each phase-12 run, of phase 13's, 14's and 15's runs
   and ranks, of phase 16's suites, all 0, and of its kernel path), the
   ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.  Each
   phase's seconds are logged.

Scratch files go to ``smoke_out/`` in the checkout (git-ignored); the
synthetic splits, checkpoints, training and eval runs are removed at exit.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import dataclasses
import datetime
import hashlib
import io
import json
import math
import os
import pickle
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from greedy_multimodal_learning_tpu_torch import config as cfg
from greedy_multimodal_learning_tpu_torch import parallel
from greedy_multimodal_learning_tpu_torch.analysis import get_rescale_weights
from greedy_multimodal_learning_tpu_torch.bootstrap import init_model
from greedy_multimodal_learning_tpu_torch.data.pipeline import DeviceCachePipeline
from greedy_multimodal_learning_tpu_torch.data.nvgesture import make_synthetic_nvgesture
from greedy_multimodal_learning_tpu_torch.data.synthetic import make_synthetic_modelnet
from greedy_multimodal_learning_tpu_torch.data.transforms import flip_shape, preprocess
from greedy_multimodal_learning_tpu_torch.engine import Trainer, load_weights, make_optimizer
from greedy_multimodal_learning_tpu_torch.engine.checkpoint import load_training_state
from greedy_multimodal_learning_tpu_torch.engine.controller import ControllerState, random_draw
from greedy_multimodal_learning_tpu_torch.engine.fold_bn import fold_batchnorm
from greedy_multimodal_learning_tpu_torch.engine.sweep import eval_sweep
from greedy_multimodal_learning_tpu_torch.entries import eval_, train
from greedy_multimodal_learning_tpu_torch.eval_sweep import eval_sweep_
from greedy_multimodal_learning_tpu_torch.models import MMTM3DCNN, MMTMMVCNN, ResNet18Trunk, init_parameters
from greedy_multimodal_learning_tpu_torch.models import layers as init_layers
from greedy_multimodal_learning_tpu_torch.ops import build as kernel_build
from greedy_multimodal_learning_tpu_torch.ops.masked_batch_norm import (
    cuda_launches as mbn_cuda_launches,
    masked_batch_norm,
    masked_batch_norm_backward,
    masked_batch_norm_backward_plain,
    masked_batch_norm_plain,
    max_blocks as mbn_max_blocks,
    split_stats as mbn_split_stats,
    plan_grid,
    update_running_plain,
)
from greedy_multimodal_learning_tpu_torch.ops.mmtm_gating import (
    cuda_launches,
    kernel_plan,
    max_active_clusters,
    mmtm_gating,
    mmtm_gating_bwd,
    mmtm_gating_bwd_plain,
    mmtm_gating_plain,
)
from greedy_multimodal_learning_tpu_torch.parallel import tensor as tensor_parallel
from greedy_multimodal_learning_tpu_torch.parallel.launch import run_ranks
from greedy_multimodal_learning_tpu_torch.predict import predict_
from greedy_multimodal_learning_tpu_torch.run_api import run_entry
from greedy_multimodal_learning_tpu_torch.utils import prng

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "smoke_out")
DATA = os.path.join(WORK, "data")  # synthetic splits, checkpoint and runs: removed at exit
CKPT = os.path.join(WORK, "seeded.pt")
TRAIN_DATA = os.path.join(WORK, "train_data")
TRAIN_RUNS = os.path.join(WORK, "train_runs")
CACHE_DATA = os.path.join(WORK, "cache_data")
CACHE_RUNS = os.path.join(WORK, "cache_runs")
CLIP_DATA = os.path.join(WORK, "clip_data")
CLIP_RUNS = os.path.join(WORK, "clip_runs")

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and the
# arithmetic rate for each input type (bf16 at the tensor-core rate, float32
# outside the tensor cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

SITES = {"mmtm2": (784, 128), "mmtm3": (196, 256), "mmtm4": (49, 512)}  # (S, C) at 224²
BATCH = 128
# checked, not timed: a ragged batch, mmtm2 at 448² (1.53 MiB per f32 map,
# beyond a cluster's shared memory: the streaming plan in float32), and the
# three sites of phase 16's kernel path, the 2-D north-star driver's 112²
# views at B=8 (configs/training_guided.gin, recording.gin and eval.gin all
# take batches of 8, and its 960 train, 240 val and 400 test samples divide
# by 8, so every train and eval batch has this shape): one sample a tile,
# 8 tiles, most of the card's clusters idle
NORTHSTAR_SITES = {"mmtm2": (196, 128), "mmtm3": (49, 256), "mmtm4": (16, 512)}  # (S, C) at 112²
NORTHSTAR_BATCH = 8
EXTRA_CASES = [("mmtm3_ragged", 5, 196, 256), ("mmtm2_448_oversize", 3, 3136, 128)] + [
    (f"{name}_northstar", NORTHSTAR_BATCH, S, C) for name, (S, C) in NORTHSTAR_SITES.items()]
LAUNCHES_PER_CALL = {"fwd": 1, "bwd": 2}  # CUDA launches a wrapper call makes
OWN_KERNELS = {"fwd": ("gating_fwd_kernel",), "bwd": ("gating_bwd_map_kernel", "weight_grad_kernel")}
PROFILER_TRIES = 3
SENTINEL_CYCLES = 20_000  # the profiler's sentinel kernel, about 10 us
N_TEST = 200
TOL = {
    # f32: same arithmetic, other summation order
    torch.float32: {"out": (1e-5, 1e-5), "sq": (1e-5, 1e-5), "g": (1e-5, 1e-5)},
    # bf16: sq from the same bf16 inputs (f32 sums); g may see joint/e round
    # across a bf16 boundary; out within one bf16 ulp (2^-7 relative)
    torch.bfloat16: {"out": (8e-3, 0.0), "sq": (1e-5, 1e-6), "g": (0.0, 2e-3)},
}
EAGER_LOGIT_ATOL = 1e-4
# (rtol, atol as a fraction of the largest |value| of that output): the
# weight gradients are batch sums of products that cancel (terms of order 1,
# sums of order 1e-2), so their rounding error scales with the terms, not
# with the sum.
BWD_TOL = {
    # f32: the same f32 arithmetic in another summation order
    torch.float32: {"df": (1e-5, 1e-6), "dw": (1e-4, 1e-5)},
    # bf16: df is rounded to bf16 on both sides (one ulp, 2^-7 relative);
    # the weight gradients are f32 sums of the same bf16 inputs
    torch.bfloat16: {"df": (8e-3, 1e-6), "dw": (1e-4, 1e-5)},
}
# Kernel path vs eager path after one guided step from the same state, f32
# without TF32: per tensor, ||p_kernel - p_eager||_2 <= STEP_TOL *
# ||p_eager - p_before||_2 + 1e-7.  The two gating paths differ by rounding
# (~1e-7 relative in the forward), and over the step's ~10^8 ReLU inputs a
# few lie within that distance of zero and land on opposite sides, each
# switching one element's gradient for the layers below it: a single weight
# can then move by a few percent of the largest update, so the element-wise
# max is no measure.  A wrong term in the backward moves the L2 of the update
# by O(1).  The same step run twice on the eager path gives the run-to-run
# floor (cuDNN's weight gradients need not be deterministic); it is printed
# beside the result.
STEP_TOL = 1e-2
N_TRAIN, N_VAL, N_TRAIN_TEST = 256, 128, 128
SLEEP_CYCLES = 2_000_000  # about 1 ms of device time: longer than any wrapper's host work
CPU_LOGIT_TOL = (1e-4, 1e-4)  # (rtol, atol): cuDNN without TF32 vs the CPU's f32 convolutions
RESCALE_TOL = (1e-5, 1e-6)  # (rtol, atol): on-device means vs the host's, f32 sums in another order
FUSION_CHANNELS = (128, 256, 512)  # mmtm2..mmtm4
SEED = 777  # train.seed: the flips' and the random controller's seed
N_CACHE_TRAIN, N_CACHE_VAL, N_CACHE_TEST = 1024, 128, 128
CLOCK_COLUMNS = ("time", "epoch_begin_time", "train_samples_per_sec")  # history columns read off the host clock
# phase 11: the published r3d-18 input (16 frames of 112², Tran et al., CVPR
# 2018, "A Closer Look at Spatiotemporal Convolutions"), RGB + depth + flow,
# 25 classes, configs/training_3dcnn_guided.gin's batch of 8; 80 train-file
# clips (64 train, 16 validation at valid_size 0.2) and 16 test clips
CLIP_MODALITIES, CLIP_FRAMES, CLIP_SIZE, CLIP_CLASSES, CLIP_BATCH = 3, 16, 112, 25, 8
N_CLIP_TRAIN_FILE, N_CLIP_TRAIN, N_CLIP_TEST = 80, 64, 16
CLIP_SMALL = (2, 4, 32)  # (B, frames, size) of the card-vs-CPU check


def log(msg):
    print(msg, flush=True)


def smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# ---- phase 2 helpers -----------------------------------------------------------


def gating_inputs(B, S, C, dtype, seed):
    """Seeded features and nn.Linear-initialized MMTM weights on the card
    (D = C at ratio 4)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    D = C

    def uni(shape, fan_in):
        bound = fan_in ** -0.5
        return (torch.rand(shape, generator=g, device="cuda") * 2 - 1) * bound

    f0 = torch.randn((B, S, C), generator=g, device="cuda").relu()
    f1 = torch.randn((B, S, C), generator=g, device="cuda").relu()
    weights = [uni((D, 2 * C), 2 * C), uni((D,), 2 * C), uni((C, D), D), uni((C,), D), uni((C, D), D), uni((C,), D)]
    return [t.to(dtype).contiguous() for t in [f0, f1] + weights]


def eager_gating(f0, f1, wsq, bsq, w0, b0, w1, b1):
    """The eager gating path of models/mmtm.py (biases added in the compute
    dtype), on (B, S, C) maps: the yardstick for the fused kernel, since no
    single PyTorch call computes the fused gating."""
    sq = [f0.mean(dim=1, dtype=torch.float32), f1.mean(dim=1, dtype=torch.float32)]
    e = torch.relu(torch.nn.functional.linear(torch.cat(sq, 1).to(f0.dtype), wsq) + bsq)
    g0 = torch.sigmoid((torch.nn.functional.linear(e, w0) + b0).float())
    g1 = torch.sigmoid((torch.nn.functional.linear(e, w1) + b1).float())
    return f0 * g0[:, None, :].to(f0.dtype), f1 * g1[:, None, :].to(f1.dtype), sq[0], sq[1], g0, g1


def time_ms(fn, args, iters=20, warmup=3):
    """Median device time of one call, L2 flushed before each (a fusion
    site's input arrives from the previous layer, not from a warm L2).  A
    device-side sleep after the flush keeps the card busy while the host
    enqueues the call, so the events time the device and not the host."""
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(B, S, C, dtype):
    """Least time for one fused gating call: each input read once and each
    output written once over HBM bandwidth, or its arithmetic over the peak
    rate for the input type, whichever is larger."""
    D = C
    item = torch.tensor([], dtype=dtype).element_size()
    maps = B * S * C * item
    weights = (2 * C * D + D + 2 * (D * C + C)) * item
    rows = 4 * B * C * 4  # sq0, sq1, g0, g1 in f32
    nbytes = 4 * maps + weights + rows
    flops = 2 * B * (2 * C * D + 2 * D * C) + 2 * 2 * B * S * C  # products + squeeze + scale
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_close(name, got, want, rtol, atol):
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        err = (got - want).abs()
        worst = int(torch.argmax(err - atol - rtol * want.abs()))
        raise AssertionError(
            f"{name}: max |diff| {err.max().item():.3e} beyond rtol={rtol} atol={atol} "
            f"(worst at flat {worst}: got {got.flatten()[worst].item()!r} want {want.flatten()[worst].item()!r})"
        )
    return float((got - want).abs().max())


def profiled_kernels(direction, fn, args):
    """(kernels of the direction's library, other kernels) that torch.profiler
    saw on the card in one call of fn, with one ``torch.cuda._sleep`` kernel
    started first in the same window as a sentinel.  A trace without the
    sentinel lost the card's activity and is taken again, up to
    PROFILER_TRIES times; None when every try lost it."""
    for attempt in range(PROFILER_TRIES):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            time.sleep(0.01)  # the window opens well before the first kernel and closes well after the last
            torch.cuda._sleep(SENTINEL_CYCLES)
            fn(*args)
            torch.cuda.synchronize()
            time.sleep(0.01)
        # every kernel the card ran, by event type: a time filter drops kernels
        # shorter than the trace's 1 us resolution; a span's range on the
        # device timeline is no kernel
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and "mem" not in e.name.lower()
                   and not getattr(e, "is_user_annotation", False)]
        own = sum(any(k in name for k in OWN_KERNELS[direction]) for name in kernels)
        other = len(kernels) - own
        if other:
            return own, other
        log(f"[profiler] {direction}: try {attempt + 1} traced no sentinel kernel ({own} of the call's)")
    return None


def check_launches_per_call(direction, fn, args):
    """The CUDA launches one call of fn makes, counted by the kernels' C
    code at each launch, and the call's kernels the profiler saw on the card
    (None when it traced nothing); fails unless both are the expected count
    and the profiler saw no other kernel than its sentinel."""
    want = LAUNCHES_PER_CALL[direction]
    before = cuda_launches(direction)
    fn(*args)
    issued = cuda_launches(direction) - before
    if issued != want:
        raise AssertionError(f"{direction}: one call launched {issued} CUDA kernels, want {want}")
    seen = profiled_kernels(direction, fn, args)
    if seen is not None and seen != (want, 1):
        raise AssertionError(f"{direction}: the profiler saw {seen[0]} kernels of one call and {seen[1]} others "
                             f"(the sentinel is one), want {want} and 1")
    return {"cuda_launches": issued, "profiled_kernels": None if seen is None else seen[0]}


def plan_report(direction, B, S, C, dtype):
    """The launch plan the kernel took for this shape, and how many of its
    clusters the card holds at once."""
    plan = kernel_plan(direction, B, S, C, C, dtype)
    return {"mode": plan.mode, **plan._asdict(), "clusters_on_card": max_active_clusters(direction, dtype, plan)}


def kernel_phase():
    """Kernel vs plain at the serving path's shapes; returns per-dtype timing."""
    cases = [(name, BATCH, S, C) for name, (S, C) in SITES.items()] + EXTRA_CASES
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[dtype]
        per_site, max_err = {}, 0.0
        for seed, (name, B, S, C) in enumerate(cases):
            args = gating_inputs(B, S, C, dtype, seed)
            got = mmtm_gating(*args)
            torch.cuda.synchronize()
            again = mmtm_gating(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name} {dtype}: two runs of the forward kernel differ")
            plan = plan_report("fwd", B, S, C, dtype)
            log(f"[kernel] {name} {str(dtype)[6:]} B={B} S={S} C={C}: plan {json.dumps(plan)}")
            want = mmtm_gating_plain(*args)
            for label, a, b in zip(("out0", "out1", "sq0", "sq1", "g0", "g1"), got, want):
                rtol, atol = tol[label[:-1]]
                max_err = max(max_err, check_close(f"{name} {dtype} {label}", a, b, rtol, atol))
            if name not in SITES:  # checked, not timed
                continue
            plan.update(check_launches_per_call("fwd", mmtm_gating, args))
            bms, bby = bound_ms(B, S, C, dtype)
            per_site[name] = {
                "shape": [B, S, C],
                "ms": time_ms(mmtm_gating, args),
                "plain_ms": time_ms(mmtm_gating_plain, args),
                "eager_ms": time_ms(eager_gating, args),
                "bound_ms": bms,
                "bound_by": bby,
                "plan": plan,
            }
            log(f"[kernel] {name} {str(dtype)[6:]} B={B} S={S} C={C}: " + json.dumps(per_site[name]))
        totals = {k: sum(site[k] for site in per_site.values()) for k in ("ms", "plain_ms", "eager_ms", "bound_ms")}
        report[dtype] = {"sites": per_site, "max_abs_err": max_err, **totals}
        log(f"[kernel] {str(dtype)[6:]} per forward (3 sites): " + json.dumps(totals) + f" max_abs_err {max_err:.3e}")
    return report


# ---- the device-resident corpus (phases 3, 5, 7-11) ---------------------------------


@contextlib.contextmanager
def built_pipelines():
    """Every :class:`DeviceCachePipeline` built inside the block."""
    built = []
    original = DeviceCachePipeline.__init__

    def init(self, *args, **kwargs):
        original(self, *args, **kwargs)
        built.append(self)

    DeviceCachePipeline.__init__ = init
    try:
        yield built
    finally:
        DeviceCachePipeline.__init__ = original


def check_resident(tag, built, want):
    """The run iterated ``want`` splits, each through a corpus on the card
    (none streamed after a budget refusal); returns their corpus bytes."""
    used = [p for p in built if p.epoch > 0]
    where = [(p.num_samples, p.resident, str(p.device)) for p in used]
    if len(used) != want or not all(p.resident and p.device.type == "cuda" for p in used):
        raise AssertionError(f"{tag}: iterated splits (samples, resident, device) {where}, want {want} resident "
                             "on the card")
    nbytes = sum(p.corpus_nbytes() for p in used)
    if want:
        log(f"[cache] {tag}: {want} splits resident on {used[0].device}, corpus {nbytes} B "
            f"({[p.corpus_nbytes() for p in used]})")
    return nbytes


# ---- phase 3 helpers -------------------------------------------------------------


def seeded_checkpoint(path, seed=0):
    """A seeded-init model with perturbed BatchNorm statistics, saved as the
    JAX package writes ``.pt`` files: {"model": state_dict, "optimizer": {}},
    without num_batches_tracked and MMTM buffers."""
    model = init_model(MMTMMVCNN(nclasses=40, use_pallas=True), seed, "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_(0.5 + torch.rand(c, generator=g))
                m.weight.copy_(0.5 + torch.rand(c, generator=g))
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
    sd = {
        k: v.contiguous()
        for k, v in model.state_dict().items()
        if not (k.endswith("num_batches_tracked") or ".running_avg_" in k or k.endswith(".step"))
    }
    torch.save({"model": sd, "optimizer": {}}, path)
    return model


def run_predict(tag, configs, bindings, out_dir, n_rows=N_TEST, nclasses=40):
    """One ``predict_`` run through the gin surface over ``n_rows`` samples of
    ``nclasses``; returns (out dict, samples/s as predict_ reports it,
    kernel launches during the run)."""
    cfg.clear_config()
    cfg.parse_config_files_and_bindings([os.path.join(REPO, c) for c in configs], "\n".join(bindings))
    buf = io.StringIO()
    with built_pipelines() as built:
        mmtm_gating.launches = 0
        with contextlib.redirect_stdout(buf):
            csv_path, out = predict_(out_dir)
        torch.cuda.synchronize()
        launches = mmtm_gating.launches
    check_resident(f"predict {tag}", built, 1)
    line = buf.getvalue().strip().splitlines()[-1]
    log(f"[predict {tag}] {line} | kernel launches {launches}")
    rate = float(re.search(r"\(([0-9.]+) samples/s\)", line).group(1))
    with open(csv_path) as f:
        rows = f.read().strip().splitlines()
    if rows[0] != "index,model,true_class,predicted_class,confidence" or len(rows) != n_rows + 1:
        raise AssertionError(f"{tag}: predictions.csv has {len(rows) - 1} rows, header {rows[0]!r}")
    for v in out["logits"]:
        if v.shape != (n_rows, nclasses) or not np.isfinite(v).all():
            raise AssertionError(f"{tag}: logits of shape {v.shape}, finite={np.isfinite(v).all()}")
    return out, rate, launches


def serving_phase():
    t0 = time.time()
    make_synthetic_modelnet(DATA, n_train=8, n_test=N_TEST, num_views=2, image_size=224, nclasses=40, seed=0)
    cpu_model = seeded_checkpoint(CKPT)
    log(f"[serving] synthetic split + checkpoint in {time.time() - t0:.1f}s")

    base = [
        "MMTM_mitigate.use_pallas=True",
        "predict_.batch_size=128",
        f"get_mvdcndata.root_dir='{DATA}'",
        "get_mvdcndata.specific_views=[0, 1]",
        f"predict_.pretrained_weights_path='{CKPT}'",
    ]
    n_batches = -(-N_TEST // BATCH)
    expected = 3 * n_batches * 1  # fusion sites x batches x kernel calls per site
    results = {}
    for tag, configs, extra in (
        ("f32", ["configs/training_guided.gin"], []),
        ("f32_eager", ["configs/training_guided.gin"], ["MMTM_mitigate.use_pallas=False"]),
        ("bf16", ["configs/training_guided.gin", "configs/tpu_bf16.gin"], []),
    ):
        out_dir = os.path.join(WORK, f"predict_{tag}")
        run_predict(tag + " warm-up", configs, base + extra, out_dir)
        out, rate, launches = run_predict(tag, configs, base + extra, out_dir)
        want = 0 if tag.endswith("eager") else expected
        if launches != want:
            raise AssertionError(f"{tag}: {launches} kernel launches, expected {want}")
        results[tag] = {"out": out, "samples_per_s": rate, "launches": launches}

    # kernel path vs eager path, f32: logits within atol; classes equal but for near-ties
    k, e = results["f32"]["out"], results["f32_eager"]["out"]
    logit_err = max(float(np.abs(a - b).max()) for a, b in zip(k["logits"], e["logits"]))
    blend_e = sum(e["logits"]) / 2.0
    top2 = np.sort(blend_e, axis=1)[:, -2:]
    near_tie = (top2[:, 1] - top2[:, 0]) <= 1e-4
    differ = k["predictions"] != e["predictions"]
    log(f"[serving] f32 kernel vs eager: max |logit diff| {logit_err:.3e}, classes differ on "
        f"{int(differ.sum())} rows ({int((differ & near_tie).sum())} near-ties)")
    if logit_err > EAGER_LOGIT_ATOL:
        raise AssertionError(f"kernel vs eager logits differ by {logit_err:.3e} > {EAGER_LOGIT_ATOL}")
    if (differ & ~near_tie).any():
        raise AssertionError(f"kernel vs eager classes differ on non-tied rows {np.flatnonzero(differ & ~near_tie)}")
    b = results["bf16"]["out"]
    agree = float((b["predictions"] == k["predictions"]).mean())
    bf16_err = max(float(np.abs(x - y).max()) for x, y in zip(b["logits"], k["logits"]))
    log(f"[serving] bf16 vs f32: class agreement {agree:.3f}, max |logit diff| {bf16_err:.3e}")

    # the card's forward (kernel path) vs the port's CPU forward (plain path), small input
    cfg.clear_config()
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(3, 2, 64, 64, 3)).astype(np.float32))
    mask = torch.tensor([1.0, 1.0, 0.0])
    with torch.no_grad():
        _, want, _, _ = cpu_model(x, valid_mask=mask, mmtm_state={})
        gpu_model = cpu_model.to("cuda")
        mmtm_gating.launches = 0
        _, got, _, _ = gpu_model(x.cuda(), valid_mask=mask.cuda(), mmtm_state={})
    if mmtm_gating.launches != 3:
        raise AssertionError(f"small-input forward made {mmtm_gating.launches} kernel launches, expected 3")
    cpu_err = max(
        check_close(f"gpu vs cpu logits view {i}", g.cpu(), w, *CPU_LOGIT_TOL) for i, (g, w) in enumerate(zip(got, want))
    )
    log(f"[serving] card (kernel) vs CPU (plain) forward at 64², B=3: max |logit diff| {cpu_err:.3e}")
    return {
        tag: {"samples_per_s": r["samples_per_s"], "launches": r["launches"]} for tag, r in results.items()
    } | {"eager_logit_err": logit_err, "bf16_class_agreement": agree, "cpu_logit_err": cpu_err}

# ---- phase 4 helpers -------------------------------------------------------------


def bwd_inputs(B, S, C, dtype, seed):
    """The backward's inputs for seeded gating inputs: the cotangents of
    the six forward outputs and the forward's residuals, in
    :func:`mmtm_gating_bwd`'s order."""
    f0, f1, wsq, bsq, w0, b0, w1, b1 = gating_inputs(B, S, C, dtype, seed)
    _, _, sq0, sq1, g0, g1 = mmtm_gating_plain(f0, f1, wsq, bsq, w0, b0, w1, b1)
    g = torch.Generator(device="cuda").manual_seed(seed + 100)
    do0, do1 = (torch.randn((B, S, C), generator=g, device="cuda").to(dtype) for _ in range(2))
    rows = [0.1 * torch.randn((B, C), generator=g, device="cuda") for _ in range(4)]  # dg0c dg1c dsq0c dsq1c
    return [do0, do1, f0, f1, g0, g1, sq0, sq1, wsq, bsq, w0, w1, *rows], (b0, b1)


def eager_autograd_backward(args, biases):
    """torch autograd through the eager gating (the yardstick for the fused
    backward; no single PyTorch call computes it): builds the graph once and
    returns a closure that runs only its backward."""
    do0, do1, f0, f1, _, _, _, _, wsq, bsq, w0, w1, dg0c, dg1c, dsq0c, dsq1c = args
    leaves = [t.detach().requires_grad_() for t in (f0, f1, wsq, bsq, w0, biases[0], w1, biases[1])]
    outs = eager_gating(*leaves)
    cots = (do0, do1, dsq0c, dsq1c, dg0c, dg1c)
    return lambda: torch.autograd.grad(outs, leaves, cots, retain_graph=True)


def bwd_bound_ms(B, S, C, dtype):
    """Least time for one fused backward call: do0, do1, f0, f1, the
    weights and the eight (B, C) f32 rows read once, df0, df1 and the f32
    weight gradients written once, over HBM bandwidth; or its f32
    arithmetic (two spatial passes, five B x D x 2C products) over the f32
    peak; whichever is larger."""
    D = C
    item = torch.tensor([], dtype=dtype).element_size()
    weights = 2 * C * D + D + 2 * D * C
    nbytes = 6 * B * S * C * item + weights * item + 8 * B * C * 4 + (weights + 2 * C) * 4
    flops = 2 * 2 * B * S * C + 3 * 2 * B * S * C + 2 * 5 * B * D * 2 * C
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[torch.float32]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def backward_kernel_phase():
    """Backward kernel vs plain at the model's shapes; returns per-dtype timing."""
    needs_grad = gating_inputs(5, 196, 256, torch.float32, 0)
    needs_grad[0].requires_grad_()
    try:
        mmtm_gating(*needs_grad)
    except RuntimeError:
        log("[bwd kernel] a direct forward-kernel call on tensors that need a gradient raises, as it must")
    else:
        raise AssertionError("mmtm_gating returned tensors detached from autograd instead of raising")
    cases = [(name, BATCH, S, C) for name, (S, C) in SITES.items()] + EXTRA_CASES
    names = ("df0", "df1", "dwsq", "dbsq", "dw0", "db0", "dw1", "db1")
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = BWD_TOL[dtype]
        per_site, max_err = {}, 0.0
        for seed, (name, B, S, C) in enumerate(cases):
            args, biases = bwd_inputs(B, S, C, dtype, seed)
            got = mmtm_gating_bwd(*args)
            torch.cuda.synchronize()
            again = mmtm_gating_bwd(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name} {dtype}: two runs of the backward kernel differ")
            plan = plan_report("bwd", B, S, C, dtype)
            log(f"[bwd kernel] {name} {str(dtype)[6:]} B={B} S={S} C={C}: plan {json.dumps(plan)}")
            want = mmtm_gating_bwd_plain(*args)
            for label, a, b in zip(names, got, want):
                rtol, atol = tol["df" if label.startswith("df") else "dw"]
                atol *= float(b.abs().max())
                max_err = max(max_err, check_close(f"bwd {name} {dtype} {label}", a, b, rtol, atol))
            if name not in SITES:  # checked, not timed
                continue
            plan.update(check_launches_per_call("bwd", mmtm_gating_bwd, args))
            bms, bby = bwd_bound_ms(B, S, C, dtype)
            per_site[name] = {
                "shape": [B, S, C],
                "ms": time_ms(mmtm_gating_bwd, args),
                "plain_ms": time_ms(mmtm_gating_bwd_plain, args),
                "eager_autograd_ms": time_ms(eager_autograd_backward(args, biases), ()),
                "bound_ms": bms,
                "bound_by": bby,
                "plan": plan,
            }
            log(f"[bwd kernel] {name} {str(dtype)[6:]} B={B} S={S} C={C}: " + json.dumps(per_site[name]))
        keys = ("ms", "plain_ms", "eager_autograd_ms", "bound_ms")
        totals = {k: sum(site[k] for site in per_site.values()) for k in keys}
        report[dtype] = {"sites": per_site, "max_abs_err": max_err, **totals}
        log(f"[bwd kernel] {str(dtype)[6:]} per step (3 sites): " + json.dumps(totals) + f" max_abs_err {max_err:.3e}")
    return report


# ---- phase 4b helpers ------------------------------------------------------------

# Every train-mode BatchNorm shape of the two training cells, with its count
# in one tower: 2-D, ResNet-18 at 224² (B=128); 3-D, r3d-18 at 16×112²
# (B=8).  (C, *spatial) -> BatchNorms of that shape.
BN_SITES = {
    "2d": (BATCH, {(64, 112, 112): 1, (64, 56, 56): 4, (128, 28, 28): 5, (256, 14, 14): 5, (512, 7, 7): 5}),
    "3d": (CLIP_BATCH, {(64, 16, 56, 56): 5, (128, 8, 28, 28): 5, (256, 4, 14, 14): 5, (512, 2, 7, 7): 5}),
}
BN_VALID = {"2d": 115, "3d": 7}  # the masked tail: 2-D's padded last step (115 of 128 rows), 3-D one row padded
BN_TOWERS = {"2d": 2, "3d": 3}
# (rtol, atol as a fraction of the largest |value| of that output): the
# kernels sum in another order than the plain version's torch reductions
# (the statistics of up to 1.6 M values a channel in f32); bf16 outputs may
# round to a neighbouring bf16 value (2^-7 relative).
BN_TOL = {
    torch.float32: {"y": (1e-4, 1e-5), "dx": (1e-3, 1e-4), "sums": (1e-4, 1e-5)},
    torch.bfloat16: {"y": (8e-3, 1e-4), "dx": (8e-3, 1e-3), "sums": (1e-4, 1e-5)},
}
# Whole-model gradients, kernels against the plain ops from one state
# (per tensor, the L2 of the difference over the gradient's L2): the two
# differ by rounding, and a few ReLU inputs near zero land on opposite sides
# (as STEP_TOL's note says); a wrong term moves a gradient by O(1).
BN_MODEL_TOL = 1e-2


def bn_inputs(B, shape, dtype, valid, seed):
    """A seeded channels-last map (the models' layout), its output gradient
    (non-zero on the padded rows too), the affine, running statistics and
    the (B,) mask with ``valid`` rows."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    C = shape[0]
    fmt = torch.channels_last if len(shape) == 3 else torch.channels_last_3d
    x = (3.0 * torch.randn((B,) + shape, generator=g, device="cuda") + 1.0).to(dtype).contiguous(memory_format=fmt)
    dy = torch.randn((B,) + shape, generator=g, device="cuda").to(dtype).contiguous(memory_format=fmt)
    weight = torch.rand(C, generator=g, device="cuda") + 0.5
    bias = torch.randn(C, generator=g, device="cuda")
    running = (torch.randn(C, generator=g, device="cuda"), torch.rand(C, generator=g, device="cuda") + 0.5)
    mask = torch.zeros(B, device="cuda")
    mask[:valid] = 1.0
    return x, dy, weight, bias, running, mask


def bn_bound_ms(B, shape, dtype):
    """(least time of a forward and backward call, each input read once and
    each output written once: x, y; dy, x, dx, five map passes), and (the
    time of the kernels' own nine passes: x three times and y forward; dy
    and x twice and dx backward), both over HBM bandwidth."""
    nbytes = B * math.prod(shape) * torch.tensor([], dtype=dtype).element_size()
    return 1e3 * 5 * nbytes / HBM_BYTES_PER_S, 1e3 * 9 * nbytes / HBM_BYTES_PER_S


def bn_plain_ops(x, dy, weight, bias, mask, relu):
    """The plain torch ops the port ran before the kernels
    (``_MaskedBatchNorm``'s CPU path, forced on the card), forward and
    autograd's backward, on a fresh module with this affine."""
    bn = (init_layers.BatchNorm2d if x.dim() == 4 else init_layers.BatchNorm3d)(x.shape[1]).to(x.device)
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    original = init_layers._kernel_route
    init_layers._kernel_route = lambda t: False
    try:
        xr = x.detach().requires_grad_()
        bn(xr, True, mask, relu=relu).backward(dy)
    finally:
        init_layers._kernel_route = original


def bn_kernels(x, dy, weight, bias, running, mask, relu):
    """The kernels' forward and backward (the running statistics updated)."""
    y, stats = masked_batch_norm(x, weight, bias, *running, mask, relu=relu)
    return (y, stats) + masked_batch_norm_backward(dy, x, weight, bias, mask, stats, relu)


def bn_plain(x, dy, weight, bias, running, mask, relu, gate=None):
    """The plain versions of the kernels' forward and backward.  With the
    ReLU, the backward takes its gate from ``gate`` (the kernels' own output):
    where the output before the ReLU lies within rounding of 0 the two
    versions' gates may differ, and the kernels' backward must gate as their
    forward did."""
    y, stats = masked_batch_norm_plain(x, weight, bias, mask, 1e-5, relu)
    update_running_plain(*running, stats, 0.1)
    if relu:
        dy = torch.where(gate > 0, dy, torch.zeros((), dtype=dy.dtype, device=dy.device))
    return (y, stats) + masked_batch_norm_backward_plain(dy, x, weight, bias, mask, stats)


def bn_site(family, B, shape, dtype, seed):
    """One site: the kernels against their plain version (with and without
    the ReLU), two runs bit-identical, one CUDA launch a call; timed (median
    of 20, L2 flushed) beside the bounds and the plain ops."""
    x, dy, weight, bias, running, mask = bn_inputs(B, shape, dtype, BN_VALID[family], seed)
    tol = BN_TOL[dtype]
    name = f"{family} {dtype} {(B,) + shape}"
    err = 0.0
    for relu in (False, True):
        runs = []
        for _ in range(2):
            state = tuple(t.clone() for t in running)
            runs.append(bn_kernels(x, dy, weight, bias, state, mask, relu) + state)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            raise AssertionError(f"{name} relu={relu}: two runs of the kernels differ")
        state = tuple(t.clone() for t in running)
        want = bn_plain(x, dy, weight, bias, state, mask, relu, gate=runs[0][0]) + state
        got, want = (dict(zip(("y", "stats", "dx", "dweight", "dbias", "running_mean", "running_var"), r))
                     for r in (runs[0], want))
        for out in (got, want):
            out.update({k: v for k, v in mbn_split_stats(out.pop("stats"), shape[0]).items()})
        if not torch.equal(got.pop("n"), want.pop("n")):
            raise AssertionError(f"{name} relu={relu}: the count differs")
        # R (sum m (x - mean)) is float32 rounding around 0 on both sides: its
        # limit is a fraction of sum |x - mean| <= sqrt(n s2)
        r_atol = 1e-5 * float((float(x.shape[0]) * math.prod(shape[1:]) * want["s2"]).sqrt().max())
        for label, b in want.items():
            rtol, atol = tol["y" if label == "y" else "dx" if label == "dx" else "sums"]
            atol = r_atol if label == "r" else atol * float(b.abs().max())
            err = max(err, check_close(f"{name} relu={relu} {label}", got[label], b, rtol, atol))
        if got["y"].stride() != x.stride() or got["dx"].stride() != x.stride():
            raise AssertionError(f"{name}: y or dx not in the input's layout")
    before, calls = mbn_cuda_launches(), masked_batch_norm.launches
    _, stats = masked_batch_norm(x, weight, bias, *running, mask)
    torch.cuda.synchronize()
    launches = {"fwd": (mbn_cuda_launches() - before, masked_batch_norm.launches - calls)}
    before, calls = mbn_cuda_launches(), masked_batch_norm_backward.launches
    masked_batch_norm_backward(dy, x, weight, bias, mask, stats)
    torch.cuda.synchronize()
    launches["bwd"] = (mbn_cuda_launches() - before, masked_batch_norm_backward.launches - calls)
    if launches != {"fwd": (1, 1), "bwd": (1, 1)}:
        raise AssertionError(f"{name}: (CUDA launches, wrapper calls) a call {launches}, want (1, 1) each way")
    bound, design = bn_bound_ms(B, shape, dtype)
    fwd_ms = time_ms(lambda: masked_batch_norm(x, weight, bias, *running, mask), ())
    bwd_ms = time_ms(lambda: masked_batch_norm_backward(dy, x, weight, bias, mask, stats), ())
    return {
        "shape": [B, *shape], "valid_rows": BN_VALID[family], "max_abs_err": err,
        "ms": fwd_ms + bwd_ms, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
        "relu_ms": time_ms(lambda: bn_kernels(x, dy, weight, bias, running, mask, True), ()),
        "plain_ms": time_ms(bn_plain_ops, (x, dy, weight, bias, mask, False)),
        "plain_relu_ms": time_ms(bn_plain_ops, (x, dy, weight, bias, mask, True)),
        "bound_ms": bound, "bound_by": "bytes", "nine_pass_ms": design,
        "blocks": {d: plan_grid(True, B, shape[0], math.prod(shape[1:]), 16 // x.element_size(),
                                mbn_max_blocks(d == "bwd", dtype, 16 // x.element_size(), True))
                   for d in ("fwd", "bwd")},
    }


def bn_model_calls(family):
    """One train-mode forward and backward of the family's model at full
    width (2-D: B=128, 224²; 3-D: B=8, 16×112²), float32, with padded rows:
    (BatchNorm forward calls, backward calls, CUDA launches) on the kernels,
    and the largest gap over every parameter gradient and running statistic,
    kernels against the plain ops from one state, and beside it the plain
    ops against themselves (cuDNN's weight gradients need not repeat) and
    against themselves on the input nudged one ulp (rounding's reach).  A
    tensor's gap is the L2 of the difference over the larger of its own and
    the median tensor's L2 (as the benchmark's ``grad_gap``: a bias whose
    gradient sums to near 0 would otherwise magnify rounding)."""
    B = BN_SITES[family][0]
    g = torch.Generator(device="cuda").manual_seed(17)
    if family == "2d":
        base = init_model(MMTMMVCNN(nclasses=40, use_pallas=True), 3, "cpu")
        x = torch.rand((B, 2, 224, 224, 3), generator=g, device="cuda")
    else:
        base = init_model(MMTM3DCNN(nclasses=25), 3, "cpu")
        x = torch.rand((B, 3, CLIP_FRAMES, CLIP_SIZE, CLIP_SIZE, 3), generator=g, device="cuda")
    mask = torch.ones(B, device="cuda")
    mask[BN_VALID[family]:] = 0.0
    grads, counts = {}, None
    for route in ("kernels", "plain", "plain_again", "plain_nudged"):
        model = copy.deepcopy(base).to(device="cuda", memory_format=base.memory_format)
        original = init_layers._kernel_route
        init_layers._kernel_route = lambda t: route == "kernels" and t.is_cuda
        try:
            calls = (masked_batch_norm.launches, masked_batch_norm_backward.launches, mbn_cuda_launches())
            # the nudge: every input one float32 ulp up, a perturbation of the size of rounding
            xr = torch.nextafter(x, torch.full_like(x, 2.0)) if route == "plain_nudged" else x
            _, logits, _, _ = model(xr, train=True, valid_mask=mask)
            sum(l.float().square().mean() for l in logits).backward()
            torch.cuda.synchronize()
            if route == "kernels":
                counts = (masked_batch_norm.launches - calls[0], masked_batch_norm_backward.launches - calls[1],
                          mbn_cuda_launches() - calls[2])
        finally:
            init_layers._kernel_route = original
        grads[route] = {**{k: p.grad.float() for k, p in model.named_parameters() if p.grad is not None},
                        **{k: b.float() for k, b in model.named_buffers() if "running" in k}}
        del model
    median = float(np.median([float(v.norm()) for v in grads["plain"].values()]))
    worst = {}
    for route in ("kernels", "plain_again", "plain_nudged"):
        worst[route] = (0.0, None)
        for k, want in grads["plain"].items():
            gap = float((grads[route][k] - want).norm()) / max(float(want.norm()), median, 1e-30)
            if gap > BN_MODEL_TOL and route == "kernels":
                raise AssertionError(f"{family} model: {k} {route} vs plain ops gap {gap:.3e} beyond {BN_MODEL_TOL}")
            worst[route] = max(worst[route], (gap, k))
    del grads, base
    torch.cuda.empty_cache()
    return counts, worst


def batch_norm_phase():
    """Phase 4b: the masked BatchNorm kernels at every BatchNorm shape of
    the two training cells; one model step of each family on the kernels
    against the plain ops, with its launch counts."""
    report = {}
    for family, (B, sites) in BN_SITES.items():
        report[family] = {}
        for dtype in (torch.float32, torch.bfloat16):
            per_site = {}
            for seed, (shape, n) in enumerate(sites.items()):
                per_site["x".join(map(str, shape))] = site = bn_site(family, B, shape, dtype, seed)
                site["per_tower"] = n
                log(f"[bn] {family} {str(dtype)[6:]} {json.dumps(site)}")
            keys = ("ms", "fwd_ms", "bwd_ms", "relu_ms", "plain_ms", "plain_relu_ms", "bound_ms", "nine_pass_ms")
            # a step: every BatchNorm of every tower
            step = {k: BN_TOWERS[family] * sum(s[k] * s["per_tower"] for s in per_site.values()) for k in keys}
            step["max_abs_err"] = max(s["max_abs_err"] for s in per_site.values())
            report[family][str(dtype)[6:]] = {"sites": per_site, "step": step}
            log(f"[bn] {family} {str(dtype)[6:]} a step ({BN_TOWERS[family]} towers): " + json.dumps(step))
        counts, worst = bn_model_calls(family)
        want = BN_TOWERS[family] * sum(sites.values())
        if counts != (want, want, 2 * want):
            raise AssertionError(f"{family} model step: (forward calls, backward calls, CUDA launches) {counts}, "
                                 f"want ({want}, {want}, {2 * want})")
        log(f"[bn] {family} model fwd+bwd (f32, {BN_VALID[family]} of {B} rows valid): {counts[0]} forward and "
            f"{counts[1]} backward calls, {counts[2]} CUDA launches; largest gap over gradients and running "
            f"statistics: kernels vs plain ops {worst['kernels'][0]:.3e} ({worst['kernels'][1]}), plain ops vs "
            f"themselves {worst['plain_again'][0]:.3e} ({worst['plain_again'][1]}), plain ops on the input nudged "
            f"one ulp {worst['plain_nudged'][0]:.3e} ({worst['plain_nudged'][1]})")
        report[family].update({"calls_per_step": counts[0], "backward_calls_per_step": counts[1],
                               "cuda_launches_per_step": counts[2], "model_gap": worst["kernels"][0],
                               "model_gap_plain_again": worst["plain_again"][0],
                               "model_gap_plain_nudged": worst["plain_nudged"][0]})
    return report


# ---- phase 5 helpers -------------------------------------------------------------


def counted(entry, configs, bindings, save_path, resident):
    """One run of an entry (``train`` or ``eval_``) through the gin surface,
    the kernels' counts set to 0 just before it and read just after, which
    must iterate ``resident`` splits through a corpus on the card (see
    :func:`check_resident`); returns (what it returned, forward launches,
    backward launches, seconds)."""
    cfg.clear_config()
    cfg.parse_config_files_and_bindings([os.path.join(REPO, c) for c in configs], "\n".join(bindings))
    buf = io.StringIO()
    with built_pipelines() as built:
        mmtm_gating.launches = 0
        mmtm_gating_bwd.launches = 0
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            out = entry(save_path)
        torch.cuda.synchronize()
        wall = time.time() - t0
        fwd, bwd = mmtm_gating.launches, mmtm_gating_bwd.launches
    cfg.clear_config()
    check_resident(os.path.basename(save_path), built, resident)
    return out, fwd, bwd, wall


def run_train(tag, configs, bindings, save_path):
    """One counted run of the ``train`` entry; checks the counts, the curated
    steps, the losses and the artifacts."""
    bn_before = (masked_batch_norm.launches, masked_batch_norm_backward.launches)
    trainer, fwd, bwd, wall = counted(train, configs, bindings, save_path, 3)
    bn = (masked_batch_norm.launches - bn_before[0], masked_batch_norm_backward.launches - bn_before[1])
    with open(os.path.join(save_path, "history.csv")) as f:
        rows = list(csv.DictReader(f))
    eval_batches = len(rows) * (-(-N_VAL // BATCH) + -(-N_TRAIN_TEST // BATCH))
    want_fwd, want_bwd = 3 * (trainer.step + eval_batches), 3 * trainer.step
    want_bn = BN_TOWERS["2d"] * sum(BN_SITES["2d"][1].values()) * trainer.step  # eval batches take none
    log(f"[train {tag}] {len(rows)} epochs, {trainer.step} steps, {trainer.curated_steps} curated, {wall:.1f}s | "
        f"forward launches {fwd} (want {want_fwd}), backward launches {bwd} (want {want_bwd}) | masked "
        f"BatchNorm calls (forward, backward) {bn} (want {want_bn} each)")
    if (fwd, bwd) != (want_fwd, want_bwd) or trainer.step != 2 * (N_TRAIN // BATCH):
        raise AssertionError(f"{tag}: launches (forward, backward) = {(fwd, bwd)}, want {(want_fwd, want_bwd)}; "
                             f"{trainer.step} steps")
    if bn != (want_bn, want_bn):
        raise AssertionError(f"{tag}: masked BatchNorm calls (forward, backward) = {bn}, want {want_bn} each")
    if trainer.curated_steps < 1:
        raise AssertionError(f"{tag}: no step ran with curation on")
    for r in rows:
        losses = [float(r[k]) for k in ("loss", "val_loss", "test_loss")]
        if not np.isfinite(losses).all():
            raise AssertionError(f"{tag}: epoch {r['epoch']} losses {losses}")
    for name in ("history.csv", "history.pickle", "model_best_val.pt", "model_last_epoch.pt",
                 "model_best_val.pt.torch.pt", "model_last_epoch.pt.torch.pt"):
        if not os.path.exists(os.path.join(save_path, name)):
            raise AssertionError(f"{tag}: {name} was not written")
    rates = [float(r["train_samples_per_sec"]) for r in rows]
    log(f"[train {tag}] train samples/s per epoch {rates}; losses {[float(r['loss']) for r in rows]}")
    return {"fwd_launches": fwd, "bwd_launches": bwd, "bn_launches": bn[0], "bn_bwd_launches": bn[1],
            "steps": trainer.step, "curated_steps": trainer.curated_steps, "train_samples_per_s": rates, "wall_s": wall}


TRAIN_BINDINGS = [
    "MMTM_mitigate.use_pallas=True",
    f"train.batch_size={BATCH}",
    f"get_mvdcndata.root_dir='{TRAIN_DATA}'",
    "get_mvdcndata.specific_views=[0, 1]",
    f"get_mvdcndata.valid_size={(N_VAL + 0.5) / (N_TRAIN + N_VAL)!r}",
    "training_loop.n_epochs=3",
]


def training_phase():
    t0 = time.time()
    make_synthetic_modelnet(TRAIN_DATA, n_train=N_TRAIN + N_VAL, n_test=N_TRAIN_TEST, num_views=2, image_size=224,
                            nclasses=40, seed=1)
    log(f"[train] synthetic split in {time.time() - t0:.1f}s")
    base = TRAIN_BINDINGS
    return {
        tag: run_train(tag, configs, base, os.path.join(TRAIN_RUNS, tag))
        for tag, configs in (
            ("f32", ["configs/training_guided.gin"]),
            ("bf16", ["configs/training_guided.gin", "configs/tpu_bf16.gin"]),
        )
    }


# ---- phase 6 helpers -------------------------------------------------------------


def guided_trainer(model):
    return Trainer(
        model,
        make_optimizer(model.parameters(), lr=0.1),
        controller_kind="guided",
        controller_config={"epsilon": 0.01, "curation_windowsize": 5},
        device="cuda",
    )


def device_batch(seed, pad=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    data = {
        "images": torch.randint(0, 256, (BATCH, 2, 224, 224, 3), generator=g, device="cuda", dtype=torch.uint8),
        "labels": torch.randint(0, 40, (BATCH,), generator=g, device="cuda", dtype=torch.int32),
        "mask": torch.ones(BATCH, device="cuda"),
    }
    data["mask"][BATCH - pad:] = 0.0
    return data, torch.rand((BATCH, 2), generator=g, device="cuda") < 0.5


def seeded_pair(dtype=torch.float32, seed=5):
    """The same seeded model on the kernel path and on the eager path."""
    base = init_model(MMTMMVCNN(nclasses=40, use_pallas=True, dtype=dtype), seed, "cpu")
    pair = {}
    for tag, kernel in (("kernel", True), ("eager", False)):
        model = copy.deepcopy(base)
        for m in model.mmtms.values():
            m.use_pallas = kernel
        pair[tag] = model.to(device="cuda", memory_format=torch.channels_last)
    return pair


def stepped_state(model, data, flips, curating):
    """Floating state_dict entries after one guided step (curating
    modality 1 or not) from the model's state."""
    trainer = guided_trainer(model)
    trainer.ctrl.curation_mode = torch.tensor(curating, device="cuda")
    trainer.ctrl.caring_modality = torch.tensor(1, dtype=torch.int32, device="cuda")
    trainer.train_batch(data, flips, torch.tensor(True, device="cuda"))
    return {k: v.float() for k, v in model.state_dict().items() if v.is_floating_point()}


def step_agreement():
    """One guided step from one state, batch and flips on both gating
    paths (and once more on the eager path), with curation off and curating
    modality 1; returns the largest per-tensor ||kernel - eager||_2 over
    ||update||_2 across parameters and floating buffers, and the same for
    eager vs eager."""
    data, flips = device_batch(11, pad=3)
    worst = {"kernel": 0.0, "eager_again": 0.0}
    for curating in (False, True):
        pair = seeded_pair()
        before = {k: v.float().clone() for k, v in pair["eager"].state_dict().items() if v.is_floating_point()}
        again = copy.deepcopy(pair["eager"])
        states = {tag: stepped_state(m, data, flips, curating) for tag, m in pair.items()}
        states["eager_again"] = stepped_state(again, data, flips, curating)
        for key, want in states["eager"].items():
            update = float((want - before[key]).norm())
            for tag in ("kernel", "eager_again"):
                got = states[tag][key]
                if not torch.isfinite(got).all():
                    raise AssertionError(f"step (curating={curating}) {tag} {key}: non-finite values")
                diff = float((got - want).norm())
                if tag == "kernel" and diff > STEP_TOL * update + 1e-7:
                    raise AssertionError(f"step (curating={curating}) kernel vs eager {key}: ||diff|| {diff:.3e} "
                                         f"beyond {STEP_TOL} x the update's {update:.3e}")
                worst[tag] = max(worst[tag], diff / max(update, 1e-30))
        del pair, again, states
        torch.cuda.empty_cache()
    log(f"[step] after one guided step, curation off and on (f32, B={BATCH}, 224²), largest ||diff||_2 / "
        f"||update||_2 over every parameter and buffer: kernel vs eager {worst['kernel']:.3e}, "
        f"eager vs eager {worst['eager_again']:.3e}")
    return worst


def step_throughput(dtype, kernel, steps=10, warmup=3):
    """Guided-step samples/s on a device-resident batch (no data loading)."""
    model = seeded_pair(dtype)["kernel" if kernel else "eager"]
    trainer = guided_trainer(model)
    unlock = torch.tensor(True, device="cuda")
    data, flips = device_batch(12)
    for _ in range(warmup):
        trainer.train_batch(data, flips, unlock)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.train_batch(data, flips, unlock)
    torch.cuda.synchronize()
    rate = steps * BATCH / (time.perf_counter() - t0)
    del trainer, model
    torch.cuda.empty_cache()
    return rate


def throughput_phase():
    """Kernel and eager gating in turns (kernel, eager, eager, kernel) per dtype."""
    rates = {}
    for dtype in (torch.float32, torch.bfloat16):
        runs = {True: [], False: []}
        for kernel in (True, False, False, True):
            runs[kernel].append(step_throughput(dtype, kernel))
        for kernel, vals in runs.items():
            tag = f"{str(dtype)[6:]}_{'kernel' if kernel else 'eager'}"
            rates[tag] = vals
            log(f"[step] guided step samples/s, {tag}, B={BATCH}, 224²: {vals}")
    return rates

# ---- phase 7 helpers -------------------------------------------------------------


def eval_rate(tag, save_path, rows, fwd, wall, modalities=2):
    """Samples/s of the pass from its own clock (the ``time`` column of
    ``eval_history_batch/history.csv``); checks the metrics are finite."""
    with open(os.path.join(save_path, "eval_history_batch", "history.csv")) as f:
        row = list(csv.DictReader(f))[-1]
    keys = ("test_loss", "test_acc", *(f"test_acc_modal_{m}" for m in range(modalities)))
    metrics = {k: float(row[k]) for k in keys}
    if not np.isfinite(list(metrics.values())).all():
        raise AssertionError(f"eval {tag}: metrics {metrics}")
    rate = rows / float(row["time"])
    log(f"[eval {tag}] {rows} samples, pass {float(row['time']):.3f}s ({rate:.1f} samples/s), entry {wall:.1f}s | "
        f"forward launches {fwd} | {json.dumps(metrics)}")
    return {"samples_per_s": rate, "launches": fwd, **metrics}


def recorded_maps(tag, save_path, rows, batch=BATCH):
    """The recording's squeeze maps, [MMTM][view] (rows, C) in dataset order,
    after checking the pickle's nesting (batches x 3 MMTMs x 2 views of
    (real rows, C) float32) and its indices."""
    with open(os.path.join(save_path, "eval_history_batch", "history.pickle"), "rb") as f:
        H = pickle.load(f)
    batches = H["test_squeezedmaps_array_list"][0]
    want_rows = [min(batch, rows - s) for s in range(0, rows, batch)]
    shapes = [[[v.shape for v in m] for m in b] for b in batches]
    want = [[[(r, c)] * 2 for c in FUSION_CHANNELS] for r in want_rows]
    if shapes != want or any(v.dtype != np.float32 or not np.isfinite(v).all() for b in batches for m in b for v in m):
        raise AssertionError(f"recording {tag}: nesting {shapes}, want {want}")
    indices = np.asarray(H["test_indices"][0])
    if sorted(indices.tolist()) != list(range(rows)):
        raise AssertionError(f"recording {tag}: test_indices are not the {rows} train-file samples")
    order = np.argsort(indices)
    return [[np.concatenate([b[m][v] for b in batches])[order] for v in range(2)] for m in range(3)]


def small_flow_off_agreement(trainer):
    """The flow-off forward of the eval's model on a small input, on the card
    (no kernel may launch) and on the CPU (the port's plain path)."""
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(3, 2, 64, 64, 3)).astype(np.float32))
    mask = torch.tensor([1.0, 1.0, 0.0])
    maps = trainer.average_squeezemaps
    cpu_model = copy.deepcopy(trainer.model).cpu()
    cpu_maps = [None if slot is None else [v.cpu() for v in slot] for slot in maps]
    with torch.no_grad():
        mmtm_gating.launches = 0
        _, got, _, _ = trainer.model(x.cuda(), valid_mask=mask.cuda(), mmtm_state={}, mmtm_off=True,
                                     average_squeezemaps=maps)
        torch.cuda.synchronize()
        if mmtm_gating.launches:
            raise AssertionError(f"flow-off forward made {mmtm_gating.launches} kernel launches, expected 0")
        _, want, _, _ = cpu_model(x, valid_mask=mask, mmtm_state={}, mmtm_off=True, average_squeezemaps=cpu_maps)
    return max(check_close(f"flow-off gpu vs cpu logits view {i}", g.cpu(), w, *CPU_LOGIT_TOL)
               for i, (g, w) in enumerate(zip(got, want)))


def eval_phase(run_dir):
    """Phase 7 in phase 5's float32 run: record, reduce on the device, then
    evaluate with the cross-modal flow cut."""
    rows = N_TRAIN + N_VAL  # recording.gin: valid_size=0, the whole train file
    base = [
        f"get_mvdcndata.root_dir='{TRAIN_DATA}'",
        "get_mvdcndata.specific_views=[0, 1]",
        f"eval_.batch_size={BATCH}",
        f"eval_.pretrained_weights_path='{os.path.join(run_dir, 'model_best_val.pt')}'",
    ]
    kernel = base + ["MMTM_mitigate.use_pallas=True"]
    rec_batches = -(-rows // BATCH)
    report, maps = {}, {}
    for tag, configs, bindings, save_path in (
        ("record_f32", ["configs/recording.gin"], kernel, run_dir),
        ("record_bf16", ["configs/recording.gin", "configs/tpu_bf16.gin"], kernel,
         os.path.join(TRAIN_RUNS, "rec_bf16")),
        ("record_f32_eager", ["configs/recording.gin"], base + ["MMTM_mitigate.use_pallas=False"],
         os.path.join(TRAIN_RUNS, "rec_eager")),
    ):
        trainer, fwd, bwd, wall = counted(eval_, configs, bindings, save_path, 1)
        del trainer
        want = 0 if tag.endswith("eager") else 3 * rec_batches
        if (fwd, bwd) != (want, 0):
            raise AssertionError(f"{tag}: kernel launches (forward, backward) = {(fwd, bwd)}, want {(want, 0)}")
        report[tag] = eval_rate(tag, save_path, rows, fwd, wall)
        maps[tag] = recorded_maps(tag, save_path, rows)
    sq_rtol, sq_atol = TOL[torch.float32]["sq"]
    report["record_kernel_vs_eager_max_abs_err"] = max(
        check_close(f"recorded squeeze mmtm{m + 2} view {v}: kernel vs eager", torch.from_numpy(k),
                    torch.from_numpy(e), sq_rtol, sq_atol)
        for m, (km, em) in enumerate(zip(maps["record_f32"], maps["record_f32_eager"]))
        for v, (k, e) in enumerate(zip(km, em))
    )
    log("[eval] recorded squeeze maps f32, kernel vs eager: max |diff| "
        f"{report['record_kernel_vs_eager_max_abs_err']:.3e}")

    od = os.path.join(TRAIN_RUNS, "rec_ondevice")
    trainer, fwd, _, wall = counted(eval_, ["configs/recording.gin"], kernel + [
        "evalution_loop.ondevice_rescale=True", f"evalution_loop.ondevice_rescale_training_path='{run_dir}'",
    ], od, 1)
    del trainer
    if fwd != 3 * rec_batches:
        raise AssertionError(f"record_ondevice: {fwd} forward launches, want {3 * rec_batches}")
    report["record_ondevice"] = eval_rate("record_ondevice", od, rows, fwd, wall)
    with open(os.path.join(od, "eval_history_batch", "history.pickle"), "rb") as f:
        if "test_squeezedmaps_array_list" in pickle.load(f):
            raise AssertionError("record_ondevice: the per-sample squeeze maps were stored")
    fast = get_rescale_weights(os.path.join(od, "eval_history_batch"), run_dir)
    host = get_rescale_weights(os.path.join(run_dir, "eval_history_batch"), run_dir)
    report["ondevice_rescale_max_abs_err"] = max(
        check_close(f"rescale mean position {p} view {v}: device vs host", torch.from_numpy(f),
                    torch.from_numpy(h), *RESCALE_TOL)
        for p in (1, 2, 3) for v, (f, h) in enumerate(zip(fast[p], host[p]))
    )
    log(f"[eval] on-device rescale means vs get_rescale_weights over the pickle: max |diff| "
        f"{report['ondevice_rescale_max_abs_err']:.3e}")

    off = os.path.join(TRAIN_RUNS, "flow_off")
    trainer, fwd, bwd, wall = counted(eval_, ["configs/eval.gin"], kernel + [
        f"MMTM_MVCNN.mmtm_rescale_eval_file_path='{os.path.join(run_dir, 'eval_history_batch')}'",
        f"MMTM_MVCNN.mmtm_rescale_training_file_path='{run_dir}'",
    ], off, 1)
    if (fwd, bwd) != (0, 0):
        raise AssertionError(f"flow_off: kernel launches (forward, backward) = {(fwd, bwd)}, want (0, 0)")
    report["flow_off"] = eval_rate("flow_off", off, N_TRAIN_TEST, fwd, wall)
    report["flow_off_cpu_logit_err"] = small_flow_off_agreement(trainer)
    log(f"[eval] flow-off forward, card vs CPU at 64², B=3: max |logit diff| {report['flow_off_cpu_logit_err']:.3e}")
    del trainer
    torch.cuda.empty_cache()
    log(f"[eval] samples/s on {smi_line()}: " + json.dumps(
        {k: v["samples_per_s"] for k, v in report.items() if isinstance(v, dict)}))
    return report


# ---- phase 8 helpers -------------------------------------------------------------


def checkpoint_state(path):
    """The float entries of a checkpoint and its sidecar's MMTM buffers."""
    state = dict(torch.load(path, map_location="cpu", weights_only=True)["model"])
    state.update(torch.load(f"{path}.torch.pt", map_location="cpu", weights_only=True)["mmtm"])
    return {k: v.float() for k, v in state.items() if v.is_floating_point()}


def float_state(model):
    return {k: v.detach().float().cpu() for k, v in model.state_dict().items() if v.is_floating_point()}


def l2_over_update(got, want, start):
    """Per floating tensor, ||got - want||_2 over ||want - start||_2 (the
    update of the epoch after ``start``): {name: (ratio, diff, update)}."""
    out = {}
    for key, w in want.items():
        if not torch.isfinite(got[key]).all():
            raise AssertionError(f"{key}: non-finite values")
        update, diff = float((w - start[key]).norm()), float((got[key] - w).norm())
        out[key] = (diff / max(update, 1e-30), diff, update)
    return out


def resume_phase():
    """Phase 8: a one-epoch run and its resume against the straight run,
    with cuDNN's deterministic algorithms.  Its default weight gradients
    are not deterministic; two straight runs with them are measured first,
    to show how far apart that alone puts two runs."""
    def epochs(save):
        with open(os.path.join(save, "history.csv")) as f:
            return [r["epoch"] for r in csv.DictReader(f)]

    guided = ["configs/training_guided.gin"]
    dirs = {tag: os.path.join(TRAIN_RUNS, f"resume_{tag}")
            for tag in ("default_a", "default_b", "straight", "again", "resumed")}
    runs = {tag: counted(train, guided, TRAIN_BINDINGS, dirs[tag], 3)[0] for tag in ("default_a", "default_b")}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    restored = {}
    original = Trainer.restore

    def spy(self, filepath):
        original(self, filepath)
        restored.update(step=self.step, ctrl={k: v.cpu().clone() for k, v in self.ctrl.as_dict().items()})

    try:
        for tag in ("straight", "again"):
            runs[tag] = counted(train, guided, TRAIN_BINDINGS, dirs[tag], 3)[0]
        counted(train, guided, TRAIN_BINDINGS[:-1] + ["training_loop.n_epochs=2"], dirs["resumed"], 3)
        last = os.path.join(dirs["resumed"], "model_last_epoch.pt")
        saved = torch.load(f"{last}.torch.pt", map_location="cpu", weights_only=True)
        start = checkpoint_state(last)
        Trainer.restore = spy
        runs["resumed"], fwd, bwd, wall = counted(train, guided, TRAIN_BINDINGS + ["training_loop.resume=True"],
                                                  dirs["resumed"], 3)
    finally:
        Trainer.restore = original
        torch.backends.cudnn.deterministic = deterministic
    if restored.get("step") != saved["step"] or any(
            not torch.equal(restored["ctrl"][k], v) for k, v in saved["controller"].items()):
        raise AssertionError(f"resume restored step {restored.get('step')} and controller {restored.get('ctrl')}, "
                             f"the sidecar holds {saved['step']} and {saved['controller']}")
    if not epochs(dirs["resumed"]) == epochs(dirs["straight"]) == ["1", "2"]:
        raise AssertionError(f"history epochs: resumed {epochs(dirs['resumed'])}, straight {epochs(dirs['straight'])}")
    steps = runs["resumed"].step - restored["step"]
    eval_batches = -(-N_VAL // BATCH) + -(-N_TRAIN_TEST // BATCH)
    if steps != N_TRAIN // BATCH or (fwd, bwd) != (3 * (steps + eval_batches), 3 * steps):
        raise AssertionError(f"resumed run: {steps} steps, launches (forward, backward) = {(fwd, bwd)}, "
                             f"want {(3 * (steps + eval_batches), 3 * steps)}")
    states = {tag: float_state(t.model) for tag, t in runs.items()}
    ratios = {
        "resumed": l2_over_update(states["resumed"], states["straight"], start),
        "again": l2_over_update(states["again"], states["straight"], start),
        # the epoch-1 state of the deterministic runs stands for the
        # default runs' own: the denominators are a scale
        "default_cudnn": l2_over_update(states["default_b"], states["default_a"], start),
    }
    worst = {tag: max(r for r, _, _ in v.values()) for tag, v in ratios.items()}
    median = {tag: float(np.median([r for r, _, _ in v.values()])) for tag, v in ratios.items()}
    log(f"[resume] restored step {restored['step']}, {steps} steps resumed ({wall:.1f}s), launches {fwd} / {bwd}; "
        f"||diff||_2 / ||epoch-2 update||_2 over every parameter and buffer, largest (median): deterministic cuDNN, "
        f"resumed vs straight {worst['resumed']:.3e} ({median['resumed']:.3e}), straight vs straight "
        f"{worst['again']:.3e} ({median['again']:.3e}); default cuDNN, straight vs straight "
        f"{worst['default_cudnn']:.3e} ({median['default_cudnn']:.3e})")
    beyond = [f"{k}: ||diff|| {d:.3e}, update {u:.3e}" for k, (_, d, u) in ratios["resumed"].items()
              if d > STEP_TOL * u + 1e-7]
    if beyond:
        raise AssertionError(f"resumed vs straight beyond {STEP_TOL} x the resumed epoch's update in {len(beyond)} "
                             f"tensors: " + "; ".join(beyond[:5]))
    del runs, states
    torch.cuda.empty_cache()
    return {"restored_step": restored["step"], "resumed_steps": steps, "fwd_launches": fwd, "bwd_launches": bwd,
            "l2_diff_over_update": worst, "l2_diff_over_update_median": median}


# ---- phase 9 helpers -------------------------------------------------------------


@contextlib.contextmanager
def step_log():
    """Each train step's (step, curated, the decision's curation flag and
    target) of the runs inside the block, fetched once at its end (no
    synchronization per step)."""
    steps = []
    original = Trainer.train_batch

    def spy(trainer, data, flips, unlock):
        step = trainer.step
        out = original(trainer, data, flips, unlock)
        steps.append((step, out["curated"], out["curation_mode"], out["caring_modality"]))
        return out

    Trainer.train_batch = spy
    try:
        yield steps
    finally:
        Trainer.train_batch = original
        steps[:] = [(t, bool(c), bool(m), int(k)) for t, c, m, k in steps]


def controller_run(tag, configs, bindings, epochs):
    """One counted ``train`` run over phase 5's split; checks the launches,
    the steps, the losses and the artifacts.  Returns (report, per-step log,
    history rows)."""
    save_path = os.path.join(TRAIN_RUNS, tag)
    with step_log() as steps:
        trainer, fwd, bwd, wall = counted(train, configs, bindings + [f"training_loop.n_epochs={epochs + 1}"],
                                          save_path, 3)
    with open(os.path.join(save_path, "history.csv")) as f:
        rows = list(csv.DictReader(f))
    per_epoch = N_TRAIN // BATCH
    eval_batches = epochs * (-(-N_VAL // BATCH) + -(-N_TRAIN_TEST // BATCH))
    want = (3 * (trainer.step + eval_batches), 3 * trainer.step)
    log(f"[controllers {tag}] {len(rows)} epochs, {trainer.step} steps, {trainer.curated_steps} curated, "
        f"{wall:.1f}s | launches forward {fwd}, backward {bwd} (want {want}) | steps (step, curated, decision, "
        f"target) {steps}")
    if (fwd, bwd) != want or trainer.step != epochs * per_epoch or len(rows) != epochs:
        raise AssertionError(f"{tag}: launches {(fwd, bwd)}, want {want}; {trainer.step} steps, {len(rows)} epochs")
    if [t for t, *_ in steps] != list(range(trainer.step)):
        raise AssertionError(f"{tag}: logged steps {[t for t, *_ in steps]}")
    for r in rows:
        losses = [float(r[k]) for k in ("loss", "val_loss", "test_loss")]
        if not np.isfinite(losses).all():
            raise AssertionError(f"{tag}: epoch {r['epoch']} losses {losses}")
    for name in ("history.csv", "history.pickle", "model_best_val.pt", "model_last_epoch.pt",
                 "model_best_val.pt.torch.pt", "model_last_epoch.pt.torch.pt"):
        if not os.path.exists(os.path.join(save_path, name)):
            raise AssertionError(f"{tag}: {name} was not written")
    report = {"fwd_launches": fwd, "bwd_launches": bwd, "steps": trainer.step, "curated_steps": trainer.curated_steps,
              "decisions": [m for _, _, m, _ in steps], "wall_s": wall}
    del trainer
    torch.cuda.empty_cache()
    return report, steps, rows


def check_steps(tag, steps, decisions, curated):
    """Each step's (decision, target) and whether its forward curated."""
    got = [(m, k) for _, _, m, k in steps]
    if got != decisions or [c for _, c, _, _ in steps] != curated:
        raise AssertionError(f"{tag}: (decision, target) per step {got}, want {decisions}; curated "
                             f"{[c for _, c, _, _ in steps]}, want {curated}")


def weakest_targets(rows, min_gap=None):
    """The target each epoch's end designates from its validation accuracies:
    the argmin, or (adaptive, with ``min_gap``) -1 unless it trails the other
    modality by more than ``min_gap`` points."""
    out = []
    for r in rows:
        accs = [float(r["val_acc_modal_0"]), float(r["val_acc_modal_1"])]
        weakest = int(np.argmin(accs))
        gap = accs[1 - weakest] - accs[weakest]
        out.append(weakest if min_gap is None or gap > min_gap else -1)
    return out


def chain_draws(seed, steps, n):
    """The random controller's draws of ``steps`` steps from ``PRNGKey(seed)``
    (one split a step, ``randint(sub, (), 0, n + 1)``), on the host."""
    key, draws = prng.PRNGKey(seed), []
    for _ in range(steps):
        key, draw = random_draw(key, n)
        draws.append(draw)
    return draws


def controller_phase():
    """Phase 9: the random, weakest and adaptive-weakest controllers through
    the ``train`` entry at full width on phase 5's split (float32, kernels)."""
    per_epoch = N_TRAIN // BATCH
    report = {}

    # random: unlocked from epoch 2; each decision the JAX package's draw from
    # the key chain of the seed; a step's forward takes the decision of the
    # step before
    report["random"], steps, _ = controller_run("random", ["configs/training_random.gin"], TRAIN_BINDINGS[:-1], 3)
    draws = chain_draws(SEED, 3 * per_epoch, 2)
    decisions = [(t >= per_epoch and d != 0, (1 if d == 1 else 0) if t >= per_epoch and d != 0 else 0)
                 for t, d in enumerate(draws)]
    check_steps("random", steps, decisions, [False] + [m for m, _ in decisions[:-1]])
    report["random"]["draws"] = draws

    # weakest (unlocked from epoch 1, 5 of every 10 steps): no target in epoch
    # 1; the eval passes turn curation off, so epoch 2's first forward is not
    # curated
    report["weakest"], steps, rows = controller_run("weakest", ["configs/training_weakest.gin"],
                                                    TRAIN_BINDINGS[:-1], 2)
    target = weakest_targets(rows)[0]
    decisions = [(False, -1)] * per_epoch + [(t % 10 < 5, target) for t in range(per_epoch, 2 * per_epoch)]
    curated = [False] * (per_epoch + 1) + [m for m, _ in decisions[per_epoch:-1]]
    check_steps("weakest", steps, decisions, curated)
    if not any(curated):
        raise AssertionError("weakest: no step of epoch 2 was curated")
    report["weakest"]["target"] = target

    # adaptive-weakest in place of the guided callback, windows of 1 step,
    # any gap opens the gate: enter, leave, enter again while the target
    # holds; three designations (equal accuracies close the gate)
    window = 1
    report["adaptive_weakest"], steps, rows = controller_run("adaptive_weakest", ["configs/training_guided.gin"], [
        *TRAIN_BINDINGS[:-1],
        "train.callbacks=['CompletedStopping', 'ReduceLROnPlateau_PyTorch', 'Bias_Mitigation_AdaptiveWeakest']",
        "Bias_Mitigation_AdaptiveWeakest.starting_epoch=1",
        f"Bias_Mitigation_AdaptiveWeakest.curation_windowsize={window}",
        "Bias_Mitigation_AdaptiveWeakest.min_gap=0.0",
    ], 4)
    targets = [-1] + weakest_targets(rows, min_gap=0.0)[:-1]  # the target each epoch runs with
    decisions, curated = [], []
    for epoch_target in targets:
        mode, count = False, 0  # the eval passes leave curation off
        for _ in range(per_epoch):
            curated.append(mode)
            if mode:
                count += 1
                mode = count != window
            elif epoch_target >= 0:
                mode, count = True, 0
            decisions.append((mode, epoch_target))
    check_steps("adaptive_weakest", steps, decisions, curated)
    if not any(curated):
        raise AssertionError(f"adaptive_weakest: no window opened (targets {targets})")
    report["adaptive_weakest"]["targets"] = targets
    return report


# ---- phase 10 helpers ------------------------------------------------------------


CACHE_BINDINGS = [
    "MMTM_mitigate.use_pallas=True",
    f"train.batch_size={BATCH}",
    f"get_mvdcndata.root_dir='{CACHE_DATA}'",
    "get_mvdcndata.specific_views=[0, 1]",
    f"get_mvdcndata.valid_size={(N_CACHE_VAL + 0.5) / (N_CACHE_TRAIN + N_CACHE_VAL)!r}",
    "training_loop.n_epochs=4",
]


def history_differences(rows, other):
    """(epoch, column, value in ``rows``, value in ``other``) for every
    history cell that differs, the wall-clock columns left out; a row that
    only one history has counts with its whole row."""
    out = [(r["epoch"], k, v, o.get(k)) for r, o in zip(rows, other) for k, v in r.items()
           if k not in CLOCK_COLUMNS and o.get(k) != v]
    longer = rows if len(rows) > len(other) else other
    return out + [(r["epoch"], "row", None, None) for r in longer[min(len(rows), len(other)):]]


def cache_phase():
    """Phase 10: the guided ``train`` entry streamed and cached, in turns
    (streamed, cached) for each dtype, cuDNN deterministic: the same
    history and the same bits; ``train_samples_per_sec`` of epochs 2-3.
    When the histories differ, a second streamed run says whether the
    streamed run repeats itself before the phase fails."""
    t0 = time.time()
    make_synthetic_modelnet(CACHE_DATA, n_train=N_CACHE_TRAIN + N_CACHE_VAL, n_test=N_CACHE_TEST, num_views=2,
                            image_size=224, nclasses=40, seed=2)
    log(f"[cache] synthetic split of {N_CACHE_TRAIN + N_CACHE_VAL + N_CACHE_TEST} samples in {time.time() - t0:.1f}s")
    steps = 3 * (N_CACHE_TRAIN // BATCH)
    eval_batches = 3 * (-(-N_CACHE_VAL // BATCH) + -(-N_CACHE_TEST // BATCH))
    want = (3 * (steps + eval_batches), 3 * steps)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    report = {}
    try:
        for dtype, configs in (("f32", ["configs/training_guided.gin"]),
                               ("bf16", ["configs/training_guided.gin", "configs/tpu_bf16.gin"])):
            runs = {}
            for path, extra, resident in (("streamed", ["get_mvdcndata.device_cache=False"], 0), ("cached", [], 3)):
                tag = f"{dtype}_{path}"
                save_path = os.path.join(CACHE_RUNS, tag)
                trainer, fwd, bwd, wall = counted(train, configs, CACHE_BINDINGS + extra, save_path, resident)
                with open(os.path.join(save_path, "history.csv")) as f:
                    rows = list(csv.DictReader(f))
                rates = [float(r["train_samples_per_sec"]) for r in rows]
                log(f"[cache {tag}] {trainer.step} steps, {wall:.1f}s | launches {fwd} / {bwd} (want {want}) | "
                    f"train samples/s per epoch {rates}")
                if (fwd, bwd) != want or trainer.step != steps:
                    raise AssertionError(f"{tag}: launches {(fwd, bwd)}, want {want}; {trainer.step} steps")
                runs[path] = (trainer, rows)
                report[tag] = {"train_samples_per_s": rates, "epochs_2_3": rates[1:3], "wall_s": wall,
                               "fwd_launches": fwd, "bwd_launches": bwd}
            (cached, c_rows), (streamed, s_rows) = runs["cached"], runs["streamed"]
            differ = history_differences(s_rows, c_rows)
            if differ:
                counted(train, configs, CACHE_BINDINGS + ["get_mvdcndata.device_cache=False"],
                        os.path.join(CACHE_RUNS, f"{dtype}_streamed_again"), 0)
                with open(os.path.join(CACHE_RUNS, f"{dtype}_streamed_again", "history.csv")) as f:
                    a_rows = list(csv.DictReader(f))
                raise AssertionError(
                    f"{dtype}: the cached run's history differs from the streamed run's in {len(differ)} cells, "
                    f"(epoch, column, streamed, cached) {differ[:8]}; a second streamed run's history differs from "
                    f"the first's in {len(history_differences(s_rows, a_rows))} cells and from the cached run's in "
                    f"{len(history_differences(c_rows, a_rows))}")
            got, ref = cached.model.state_dict(), streamed.model.state_dict()
            differ = [k for k, v in ref.items() if not torch.equal(got[k], v)]
            if differ:
                raise AssertionError(f"{dtype}: cached vs streamed, {len(differ)} tensors differ: {differ[:5]}")
            log(f"[cache] {dtype}: cached and streamed runs bit-identical in all {len(ref)} state_dict entries; "
                f"train samples/s epochs 2-3, streamed {report[dtype + '_streamed']['epochs_2_3']}, cached "
                f"{report[dtype + '_cached']['epochs_2_3']} on {smi_line()}")
            del runs, cached, streamed, got, ref
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return report


# ---- phase 11 helpers ------------------------------------------------------------


CLIP_BINDINGS = [
    f"get_nvgesturedata.root_dir='{CLIP_DATA}'",
    f"train.batch_size={CLIP_BATCH}",
]


def clip_run(tag, config, extra, epochs=2):
    """One counted ``train`` run of the 3D family over phase 11's split:
    no gating launch, the steps and epochs, finite losses, every artifact,
    three splits resident on the card.  Returns (report, per-step log,
    trainer)."""
    save_path = os.path.join(CLIP_RUNS, tag)
    with step_log() as steps:
        trainer, fwd, bwd, wall = counted(train, [config], CLIP_BINDINGS + extra + [
            f"training_loop.n_epochs={epochs + 1}"], save_path, 3)
    with open(os.path.join(save_path, "history.csv")) as f:
        rows = list(csv.DictReader(f))
    per_epoch = N_CLIP_TRAIN // CLIP_BATCH
    rates = [float(r["train_samples_per_sec"]) for r in rows]
    log(f"[3dcnn {tag}] {len(rows)} epochs, {trainer.step} steps, {trainer.curated_steps} curated, {wall:.1f}s | "
        f"gating launches {fwd} / {bwd} | train samples/s per epoch {rates} on {smi_line()} | losses "
        f"{[float(r['loss']) for r in rows]} | steps (step, curated, decision, target) {steps}")
    if (fwd, bwd) != (0, 0) or trainer.step != epochs * per_epoch or len(rows) != epochs:
        raise AssertionError(f"3dcnn {tag}: gating launches {(fwd, bwd)}, want (0, 0); {trainer.step} steps, "
                             f"{len(rows)} epochs")
    for r in rows:
        values = [float(r[k]) for k in ("loss", "val_loss", "test_loss", "acc_modal_2", "val_acc_modal_2")]
        if not np.isfinite(values).all():
            raise AssertionError(f"3dcnn {tag}: epoch {r['epoch']} values {values}")
    for name in ("history.csv", "history.pickle", "model_best_val.pt", "model_last_epoch.pt",
                 "model_best_val.pt.torch.pt", "model_last_epoch.pt.torch.pt"):
        if not os.path.exists(os.path.join(save_path, name)):
            raise AssertionError(f"3dcnn {tag}: {name} was not written")
    report = {"fwd_launches": fwd, "bwd_launches": bwd, "steps": trainer.step, "curated_steps": trainer.curated_steps,
              "train_samples_per_s": rates, "wall_s": wall}
    return report, steps, trainer


def clip_recording_nesting(save_path):
    """The recording pass's pickle: batches x 3 MMTMs x 3 modalities of
    (real rows, C) float32 maps over the whole train file, in order."""
    with open(os.path.join(save_path, "eval_history_batch", "history.pickle"), "rb") as f:
        H = pickle.load(f)
    batches = H["test_squeezedmaps_array_list"][0]
    shapes = [[[v.shape for v in m] for m in b] for b in batches]
    want = [[[(min(CLIP_BATCH, N_CLIP_TRAIN_FILE - s), c)] * CLIP_MODALITIES for c in FUSION_CHANNELS]
            for s in range(0, N_CLIP_TRAIN_FILE, CLIP_BATCH)]
    if shapes != want or any(v.dtype != np.float32 or not np.isfinite(v).all() for b in batches for m in b for v in m):
        raise AssertionError(f"3dcnn recording: nesting {shapes}, want {want}")
    if sorted(np.asarray(H["test_indices"][0]).tolist()) != list(range(N_CLIP_TRAIN_FILE)):
        raise AssertionError("3dcnn recording: test_indices are not the train file's clips")
    return len(batches)


def clip_cpu_agreement(ckpt):
    """The eval forward of ``ckpt``'s model on a small input, on the card
    and on the CPU (float32, cuDNN deterministic, TF32 off)."""
    cpu_model = MMTM3DCNN(nclasses=CLIP_CLASSES)
    load_weights(cpu_model, ckpt)
    cpu_model = cpu_model.to(memory_format=cpu_model.memory_format).eval()
    b, frames, size = CLIP_SMALL
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(b, CLIP_MODALITIES, frames, size, size, 3))
                         .astype(np.float32))
    mask = torch.ones(b)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad():
            _, want, _, _ = cpu_model(x, valid_mask=mask, mmtm_state={})
            gpu_model = copy.deepcopy(cpu_model).cuda()
            mmtm_gating.launches = 0
            _, got, _, _ = gpu_model(x.cuda(), valid_mask=mask.cuda(), mmtm_state={})
            torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if mmtm_gating.launches:
        raise AssertionError(f"3dcnn small forward made {mmtm_gating.launches} gating launches, expected 0")
    return max(check_close(f"3dcnn gpu vs cpu logits modality {i}", g.cpu(), w, *CPU_LOGIT_TOL)
               for i, (g, w) in enumerate(zip(got, want)))


def clip_phase():
    """Phase 11: the 3-modality 3D-CNN family at full width (three r3d-18
    towers, 25 classes, 16 frames of 112²) through ``train`` (guided f32
    and bf16, random f32), ``eval_`` (recording, flow-off) and
    ``predict_``, every split resident on the card and no gating kernel
    launched (the family's gating is eager, as in the JAX package)."""
    t0 = time.time()
    make_synthetic_nvgesture(CLIP_DATA, n_train=N_CLIP_TRAIN_FILE, n_test=N_CLIP_TEST, num_modalities=CLIP_MODALITIES,
                             frames=CLIP_FRAMES, image_size=CLIP_SIZE, nclasses=CLIP_CLASSES, seed=3)
    log(f"[3dcnn] synthetic split of {N_CLIP_TRAIN_FILE} + {N_CLIP_TEST} clips of {CLIP_MODALITIES} x {CLIP_FRAMES} "
        f"x {CLIP_SIZE}² in {time.time() - t0:.1f}s")
    guided = "configs/training_3dcnn_guided.gin"
    report = {}
    for tag, extra in (("guided_f32", []), ("guided_bf16", ["MMTM_3DCNN.compute_dtype='bfloat16'"])):
        report[tag], _, trainer = clip_run(tag, guided, extra)
        if trainer.curated_steps < 1:
            raise AssertionError(f"3dcnn {tag}: no step ran with curation on")
        del trainer
        torch.cuda.empty_cache()

    # random: locked in epoch 1 (starting_epoch 2); each decision the JAX
    # package's draw from the seed's key chain over modes 0..3, mode m > 0
    # caring for modality m - 1
    report["random"], steps, trainer = clip_run("random", "configs/training_3dcnn_random.gin", [])
    del trainer
    per_epoch = N_CLIP_TRAIN // CLIP_BATCH
    draws = chain_draws(SEED, 2 * per_epoch, CLIP_MODALITIES)
    decisions = [(t >= per_epoch and d != 0, d - 1 if t >= per_epoch and d != 0 else 0) for t, d in enumerate(draws)]
    check_steps("3dcnn random", steps, decisions, [False] + [m for m, _ in decisions[:-1]])
    report["random"]["draws"] = draws

    run = os.path.join(CLIP_RUNS, "guided_f32")
    ckpt = os.path.join(run, "model_best_val.pt")
    weights = [f"get_nvgesturedata.root_dir='{CLIP_DATA}'", f"eval_.pretrained_weights_path='{ckpt}'"]
    trainer, fwd, bwd, wall = counted(eval_, ["configs/recording_3dcnn.gin"], weights, run, 1)
    del trainer
    if (fwd, bwd) != (0, 0):
        raise AssertionError(f"3dcnn recording: gating launches {(fwd, bwd)}, want (0, 0)")
    report["record"] = {**eval_rate("3dcnn record", run, N_CLIP_TRAIN_FILE, fwd, wall, CLIP_MODALITIES),
                        "fwd_launches": fwd, "bwd_launches": bwd, "batches": clip_recording_nesting(run)}

    off = os.path.join(CLIP_RUNS, "flow_off")
    trainer, fwd, bwd, wall = counted(eval_, ["configs/eval_3dcnn.gin"], weights + [
        f"MMTM_3DCNN.mmtm_rescale_eval_file_path='{os.path.join(run, 'eval_history_batch')}'",
        f"MMTM_3DCNN.mmtm_rescale_training_file_path='{run}'",
    ], off, 1)
    del trainer
    if (fwd, bwd) != (0, 0):
        raise AssertionError(f"3dcnn flow-off: gating launches {(fwd, bwd)}, want (0, 0)")
    report["flow_off"] = {**eval_rate("3dcnn flow_off", off, N_CLIP_TEST, fwd, wall, CLIP_MODALITIES),
                          "fwd_launches": fwd, "bwd_launches": bwd}

    _, rate, launches = run_predict("3dcnn", [guided], [
        f"get_nvgesturedata.root_dir='{CLIP_DATA}'", "predict_.model='MMTM_3DCNN'",
        f"predict_.batch_size={CLIP_BATCH}", f"predict_.pretrained_weights_path='{ckpt}'",
    ], os.path.join(CLIP_RUNS, "predict"), n_rows=N_CLIP_TEST, nclasses=CLIP_CLASSES)
    if launches:
        raise AssertionError(f"3dcnn predict: {launches} gating launches, want 0")
    report["predict"] = {"samples_per_s": rate, "fwd_launches": launches}

    report["cpu_logit_err"] = clip_cpu_agreement(ckpt)
    log(f"[3dcnn] card vs CPU eval forward at B={CLIP_SMALL[0]}, {CLIP_SMALL[1]} frames of {CLIP_SMALL[2]}²: "
        f"max |logit diff| {report['cpu_logit_err']:.3e} (tolerance rtol, atol {CPU_LOGIT_TOL})")
    torch.cuda.empty_cache()
    log(f"[3dcnn] samples/s on {smi_line()}: " + json.dumps({
        k: v.get("train_samples_per_s", v.get("samples_per_s")) for k, v in report.items() if isinstance(v, dict)}))
    return report


# ---- phase 12 helpers ------------------------------------------------------------


# BatchNorm folded into the convolutions against the unfolded forward, f32
# without TF32, logits and recorded maps: rtol, and atol as a fraction of the
# largest |value| (tests/test_fold_bn.py:51 holds the JAX package to (2e-4,
# 2e-4)).  The folded recording's maps are held to the kernel's sq tolerance.
FOLD_LOGIT_TOL = (2e-4, 2e-4)
SWEEP_RTOL = 1e-5  # a sweep row against a separate eval_ of its checkpoint (tests/test_sweep.py:37-39)
RATE_BATCHES = 8  # resident B=128 batches the sweep is timed over (phase 10's 1,024 train samples)
RATE_STEPS = 10  # timed guided steps a turn, two turns a variant (off, on, on, off)
SIDE_DATA = [
    "MMTM_mitigate.use_pallas=True",
    f"get_mvdcndata.root_dir='{TRAIN_DATA}'",
    "get_mvdcndata.specific_views=[0, 1]",
]
ARTIFACTS = ("history.csv", "history.pickle", "model_best_val.pt", "model_last_epoch.pt",
             "model_best_val.pt.torch.pt", "model_last_epoch.pt.torch.pt")


@contextlib.contextmanager
def counting():
    """The gating wrappers' counts, set to 0 on entry; the dict gets
    ``fwd`` and ``bwd`` on exit, after a synchronize."""
    counts = {}
    mmtm_gating.launches = 0
    mmtm_gating_bwd.launches = 0
    yield counts
    torch.cuda.synchronize()
    counts.update(fwd=mmtm_gating.launches, bwd=mmtm_gating_bwd.launches)


def side_train(tag, extra, epochs=1, resident=3):
    """One counted ``train`` run on phase 5's split (guided, kernels, f32):
    finite losses and every artifact; returns (trainer, report)."""
    save_path = os.path.join(TRAIN_RUNS, f"side_{tag}")
    trainer, fwd, bwd, wall = counted(train, ["configs/training_guided.gin"], TRAIN_BINDINGS[:-1] + [
        f"training_loop.n_epochs={epochs + 1}", *extra], save_path, resident)
    with open(os.path.join(save_path, "history.csv")) as f:
        rows = list(csv.DictReader(f))
    for r in rows:
        losses = [float(r[k]) for k in ("loss", "val_loss", "test_loss")]
        if not np.isfinite(losses).all():
            raise AssertionError(f"{tag}: epoch {r['epoch']} losses {losses}")
    missing = [name for name in ARTIFACTS if not os.path.exists(os.path.join(save_path, name))]
    if len(rows) != epochs or trainer.step != epochs * (N_TRAIN // BATCH) or missing:
        raise AssertionError(f"{tag}: {len(rows)} epochs, {trainer.step} steps, artifacts missing {missing}")
    rates = [float(r["train_samples_per_sec"]) for r in rows]
    log(f"[side {tag}] {trainer.step} steps, {wall:.1f}s | forward launches {fwd}, backward {bwd} | train "
        f"samples/s {rates}; losses {[float(r['loss']) for r in rows]}")
    return trainer, {"fwd_launches": fwd, "bwd_launches": bwd, "steps": trainer.step,
                     "train_samples_per_s": rates, "wall_s": wall}


def want_launches(steps, epochs=1):
    """The kernel path's counts for a run: 3 a train step and eval batch
    forward, 3 a train step backward."""
    eval_batches = epochs * (-(-N_VAL // BATCH) + -(-N_TRAIN_TEST // BATCH))
    return 3 * (steps + eval_batches), 3 * steps


def fold_predict(run_dir):
    """(a) ``predict_`` with ``fold_bn=True`` against the unfolded run."""
    base = SIDE_DATA + ["predict_.batch_size=128",
                        f"predict_.pretrained_weights_path='{os.path.join(run_dir, 'model_best_val.pt')}'"]
    outs = {}
    for fold in (False, True):
        outs[fold] = run_predict(f"fold_bn={fold}", ["configs/training_guided.gin"], base + [
            f"predict_.fold_bn={fold}"], os.path.join(WORK, f"predict_fold_{fold}"), n_rows=N_TRAIN_TEST)
    scale = max(float(np.abs(v).max()) for v in outs[False][0]["logits"])
    err = max(check_close(f"folded vs unfolded logits view {i}", torch.from_numpy(g), torch.from_numpy(w),
                          FOLD_LOGIT_TOL[0], FOLD_LOGIT_TOL[1] * scale)
              for i, (g, w) in enumerate(zip(outs[True][0]["logits"], outs[False][0]["logits"])))
    launches = outs[True][2]
    if launches != 3 * -(-N_TRAIN_TEST // BATCH):
        raise AssertionError(f"fold_bn predict: {launches} forward launches, want {3 * -(-N_TRAIN_TEST // BATCH)}")
    forward_ms = fold_forward_ms(os.path.join(run_dir, "model_best_val.pt"))
    log(f"[side fold predict] folded vs unfolded logits: max |diff| {err:.3e} (largest |logit| {scale:.3e}); "
        f"samples/s folded {outs[True][1]}, unfolded {outs[False][1]} (one batch each); forward ms on a resident "
        f"batch, B={BATCH}, median of 10, turns unfolded, folded, folded, unfolded: {json.dumps(forward_ms)}")
    return {"launches": launches, "max_abs_err": err, "max_abs_logit": scale,
            "samples_per_s": outs[True][1], "samples_per_s_unfolded": outs[False][1], "forward_ms": forward_ms}


def eval_model(path):
    """The seeded 2-D model with ``path`` loaded, on the card, and its
    state_dict."""
    model = init_model(MMTMMVCNN(nclasses=40, use_pallas=True), SEED, "cpu")
    load_weights(model, path)
    model = model.to(device="cuda", memory_format=torch.channels_last)
    return model, dict(model.state_dict())


def fold_forward_ms(path):
    """The eval forward's device ms under the checkpoint's state and under
    its folded state (``functional_call``, as the Trainer runs a folded
    pass), in turns: unfolded, folded, folded, unfolded."""
    model, state = eval_model(path)
    states = {"unfolded": state, "folded": fold_batchnorm(state)}
    data, _ = device_batch(21)
    x = preprocess(data["images"], train=False)
    kwargs = {"train": False, "valid_mask": data["mask"], "mmtm_state": {}}
    times = {tag: [] for tag in states}
    with torch.no_grad():
        for tag in ("unfolded", "folded", "folded", "unfolded"):
            times[tag].append(time_ms(lambda: torch.func.functional_call(model, states[tag], (x,), kwargs), (),
                                      iters=10))
    return times


def fold_record(run_dir):
    """(b) ``run_entry("eval", ...)``: the recording pass with
    ``evalution_loop.fold_bn_eval``, against phase 7's unfolded recording."""
    rows = N_TRAIN + N_VAL
    save_path = os.path.join(TRAIN_RUNS, "side_fold_record")
    bindings = SIDE_DATA + [f"eval_.batch_size={BATCH}", "evalution_loop.fold_bn_eval=True",
                            f"eval_.pretrained_weights_path='{os.path.join(run_dir, 'model_best_val.pt')}'"]
    with built_pipelines() as built, counting() as n, contextlib.redirect_stdout(io.StringIO()):
        t0 = time.time()
        run_entry("eval", save_path, os.path.join(REPO, "configs", "recording.gin"), "#".join(bindings))
    wall = time.time() - t0
    check_resident("fold_record", built, 1)
    want = 3 * -(-rows // BATCH)
    if (n["fwd"], n["bwd"]) != (want, 0):
        raise AssertionError(f"fold_bn recording: launches {(n['fwd'], n['bwd'])}, want {(want, 0)}")
    report = eval_rate("fold_record", save_path, rows, n["fwd"], wall)
    pairs = [(f"mmtm{m + 2} view {v}", torch.from_numpy(f), torch.from_numpy(u))
             for m, (fm, um) in enumerate(zip(recorded_maps("fold", save_path, rows), recorded_maps("unfolded", run_dir, rows)))
             for v, (f, u) in enumerate(zip(fm, um))]
    report["max_abs_err"] = max(
        check_close(f"recorded squeeze {name}: folded vs unfolded", f, u, *TOL[torch.float32]["sq"])
        for name, f, u in pairs)
    report["max_rel_err"] = max(float(((f - u).abs() / u.abs().clamp(min=1e-30)).max()) for _, f, u in pairs)
    log(f"[side fold record] recorded maps folded vs phase 7's unfolded pass, within the kernel's sq tolerance "
        f"{TOL[torch.float32]['sq']}: max |diff| {report['max_abs_err']:.3e}, max relative {report['max_rel_err']:.3e}")
    return report


def sweep_check(run_dir):
    """(c) the ``eval_sweep`` entry over phase 5's two checkpoints against a
    separate ``eval_`` of each."""
    paths = [os.path.join(run_dir, "model_best_val.pt"), os.path.join(run_dir, "model_last_epoch.pt")]
    batches = -(-N_TRAIN_TEST // BATCH)
    buf = io.StringIO()
    cfg.clear_config()
    cfg.parse_config_files_and_bindings([os.path.join(REPO, "configs/training_guided.gin")], "\n".join(
        SIDE_DATA + [f"eval_sweep_.checkpoints={paths!r}", f"eval_sweep_.batch_size={BATCH}"]))
    with built_pipelines() as built, counting() as n, contextlib.redirect_stdout(buf):
        csv_path = eval_sweep_(os.path.join(TRAIN_RUNS, "side_sweep"))
    cfg.clear_config()
    check_resident("sweep", built, 1)
    if (n["fwd"], n["bwd"]) != (3 * len(paths) * batches, 0):
        raise AssertionError(f"sweep: launches {(n['fwd'], n['bwd'])}, want {(3 * len(paths) * batches, 0)}")
    line = next(l for l in buf.getvalue().splitlines() if l.startswith("sweep:"))
    seconds = float(re.search(r", ([0-9.]+)s \(", line).group(1))
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    for k, (path, row) in enumerate(zip(paths, rows)):
        save_path = os.path.join(TRAIN_RUNS, f"side_sweep_eval{k}")
        _, fwd, _, wall = counted(eval_, ["configs/training_guided.gin"], SIDE_DATA + [
            f"eval_.batch_size={BATCH}", f"eval_.pretrained_weights_path='{path}'"], save_path, 1)
        one = eval_rate(f"sweep_eval{k}", save_path, N_TRAIN_TEST, fwd, wall)
        for name in ("loss", "acc", "acc_modal_0", "acc_modal_1"):
            got, want = float(row[name]), one[f"test_{name}"]
            if row["checkpoint"] != path or not abs(got - want) <= SWEEP_RTOL * abs(want) + 5e-7:
                raise AssertionError(f"sweep row {row['checkpoint']} {name} {got} vs eval_ {want}")
    rates = sweep_rates(paths)
    report = {"launches": n["fwd"], "entry_samples_per_s": N_TRAIN_TEST / seconds, **rates}
    log(f"[side sweep] K=2 entry over {N_TRAIN_TEST} samples (upload included) {report['entry_samples_per_s']:.1f} "
        f"samples/s | forward launches {n['fwd']} | over {RATE_BATCHES * BATCH} resident samples, turns separate, "
        f"sweep, sweep, separate: {json.dumps(rates)}")
    return report


def sweep_rates(paths):
    """Checkpoint-samples/s of ``eval_sweep`` over RATE_BATCHES resident
    batches: the K checkpoints in one pass against K one-checkpoint passes
    (the separate evals without their uploads), in turns separate, sweep,
    sweep, separate, after one pass of each to warm up."""
    model = eval_model(paths[0])[0]
    states = [eval_model(p)[1] for p in paths]
    batches = [{**device_batch(30 + i)[0], "size": BATCH} for i in range(RATE_BATCHES)]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return len(paths) * RATE_BATCHES * BATCH / (time.perf_counter() - t0)

    runs = {"sweep": lambda: eval_sweep(model, states, batches),
            "separate": lambda: [eval_sweep(model, [s], batches) for s in states]}
    for fn in runs.values():
        fn()
    rates = {"sweep": [], "separate": []}
    for tag in ("separate", "sweep", "sweep", "separate"):
        rates[tag].append(timed(runs[tag]))
    return {f"{tag}_ckpt_samples_per_s": v for tag, v in rates.items()}


def remat_check():
    """(d) two epochs with ``MMTM_MVCNN.remat=True`` against the same run
    without, cuDNN deterministic: the final tensors within ``STEP_TOL`` of
    the run's update, equal launch counts; peak device memory of each."""
    start = float_state(init_model(MMTMMVCNN(nclasses=40, use_pallas=True), SEED, "cpu"))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs, peaks = {}, {}
    try:
        for tag, extra in (("no_remat", []), ("remat", ["MMTM_MVCNN.remat=True"])):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            runs[tag] = side_train(tag, extra, epochs=2)
            peaks[tag] = torch.cuda.max_memory_allocated()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (plain, p), (remat, r) = runs["no_remat"], runs["remat"]
    if not all(t.remat for t in remat.model.towers) or (p["fwd_launches"], p["bwd_launches"]) != (
            r["fwd_launches"], r["bwd_launches"]) or (r["fwd_launches"], r["bwd_launches"]) != want_launches(
            r["steps"], 2):
        raise AssertionError(f"remat: launches {(r['fwd_launches'], r['bwd_launches'])}, without "
                             f"{(p['fwd_launches'], p['bwd_launches'])}, want {want_launches(r['steps'], 2)}")
    ratios = l2_over_update(float_state(remat.model), float_state(plain.model), start)
    beyond = [k for k, (_, d, u) in ratios.items() if d > STEP_TOL * u + 1e-7]
    if beyond:
        raise AssertionError(f"remat vs no remat beyond {STEP_TOL} x the update in {beyond[:5]}")
    worst = max(v[0] for v in ratios.values())
    del plain, remat, runs
    torch.cuda.empty_cache()
    steps = remat_step_rates()
    log(f"[side remat] remat vs no remat after 2 epochs, largest ||diff||_2 / ||update||_2 {worst:.3e}; "
        f"peak memory allocated in the runs {peaks['remat']} B with remat, {peaks['no_remat']} B without; guided "
        f"steps on a resident batch, B={BATCH}, {RATE_STEPS} a turn, turns off, on, on, off: {json.dumps(steps)}")
    return {"remat": r, "no_remat": p, "l2_diff_over_update": worst, "peak_bytes_remat": peaks["remat"],
            "peak_bytes_no_remat": peaks["no_remat"], "steps": steps}


def remat_step_rates(warmup=3):
    """Guided-step samples/s with and without remat on a resident batch,
    RATE_STEPS timed steps a turn in turns off, on, on, off, and the peak
    device memory of a step of each (the model, its optimizer state and one
    batch; no corpus)."""
    data, flips = device_batch(12)
    unlock = torch.tensor(True, device="cuda")
    rates = {False: [], True: []}
    peaks = {}
    for remat in (False, True, True, False):
        model = init_model(MMTMMVCNN(nclasses=40, use_pallas=True, remat=remat), SEED, "cpu").to(
            device="cuda", memory_format=torch.channels_last)
        trainer = guided_trainer(model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(warmup):
            trainer.train_batch(data, flips, unlock)
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        for _ in range(RATE_STEPS):
            trainer.train_batch(data, flips, unlock)
        torch.cuda.synchronize()
        rates[remat].append(RATE_STEPS * BATCH / (time.perf_counter() - t0))
        del trainer, model
        torch.cuda.empty_cache()
    return {"remat_samples_per_s": rates[True], "no_remat_samples_per_s": rates[False],
            "step_peak_bytes_remat": peaks[True], "step_peak_bytes_no_remat": peaks[False]}


def stem_check():
    """(e) one epoch of ``train`` with ``MMTM_MVCNN.stem_s2d=True``: the
    plain stem (the flag keeps the JAX package's refusal of odd sizes)."""
    _, run = side_train("stem_s2d", ["MMTM_MVCNN.stem_s2d=True"])
    if (run["fwd_launches"], run["bwd_launches"]) != want_launches(run["steps"]):
        raise AssertionError(f"stem_s2d: launches {(run['fwd_launches'], run['bwd_launches'])}, "
                             f"want {want_launches(run['steps'])}")
    return run


def variants_check():
    """(f) one epoch with ``MMTM_mitigate.SEonly`` and with ``shareweight``
    under ``use_pallas=True``: neither takes the kernels."""
    report = {}
    for tag, binding in (("seonly", "MMTM_mitigate.SEonly=True"), ("shareweight", "MMTM_mitigate.shareweight=True")):
        _, report[tag] = side_train(tag, [binding])
        if (report[tag]["fwd_launches"], report[tag]["bwd_launches"]) != (0, 0):
            raise AssertionError(f"{tag}: launches {(report[tag]['fwd_launches'], report[tag]['bwd_launches'])}, "
                                 "want (0, 0)")
    return report


def pretrained_check():
    """(g) ``MMTM_MVCNN.pretraining=True`` from a seeded torchvision-layout
    ResNet-18 file: each tower's trunk is the file's before the first step,
    its head the seeded one; then one epoch."""
    trunk = ResNet18Trunk(1000)
    init_parameters(trunk, prng.PRNGKey(8))
    g = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for m in trunk.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.1 * torch.randn(m.num_features, generator=g))
                m.running_var.copy_(0.5 + torch.rand(m.num_features, generator=g))
    sd = trunk.state_dict()
    path = os.path.join(WORK, "resnet18-seeded.pt")
    torch.save({"state_dict": sd}, path)
    seen = {}
    original = Trainer.train_loop

    def spy(self, *args, **kwargs):
        seen.update({k: v.detach().cpu().clone() for k, v in self.model.state_dict().items()})
        return original(self, *args, **kwargs)

    Trainer.train_loop = spy
    try:
        _, run = side_train("pretrained", ["MMTM_MVCNN.pretraining=True",
                                           f"MMTM_MVCNN.pretrained_weights_path='{path}'"])
    finally:
        Trainer.train_loop = original
    head = init_model(MMTMMVCNN(nclasses=40, use_pallas=True), SEED, "cpu").state_dict()
    for i in range(2):
        wrong = [k for k, v in sd.items() if not k.startswith("fc.") and not k.endswith("num_batches_tracked")
                 and not torch.equal(seen[f"net_view_{i}.{k}"], v)]
        if wrong or not torch.equal(seen[f"net_view_{i}.fc.weight"], head[f"net_view_{i}.fc.weight"]):
            raise AssertionError(f"pretrained: net_view_{i} differs from the file in {wrong[:5]} or has no fresh head")
    if (run["fwd_launches"], run["bwd_launches"]) != want_launches(run["steps"]):
        raise AssertionError(f"pretrained: launches {(run['fwd_launches'], run['bwd_launches'])}")
    log("[side pretrained] both towers' trunks equal the file before the first step, heads the seeded init")
    return run


def profiling_check():
    """(h) ``Trainer.enable_profiling`` over one epoch: one trace that names
    both gating kernels (a trace that lost the card's activity is taken
    again, up to PROFILER_TRIES times)."""
    trace_dir = os.path.join(WORK, "trace")
    original = Trainer.train_loop

    def spy(self, *args, **kwargs):
        self.enable_profiling(trace_dir)
        return original(self, *args, **kwargs)

    for attempt in range(PROFILER_TRIES):
        shutil.rmtree(trace_dir, ignore_errors=True)
        Trainer.train_loop = spy
        try:
            _, run = side_train("profiled", [])
        finally:
            Trainer.train_loop = original
        files = os.listdir(trace_dir)
        if len(files) != 1:
            raise AssertionError(f"profiling: trace files {files}, want one")
        with open(os.path.join(trace_dir, files[0])) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"}
        found = {k: sum(k in name for name in names) for d in ("fwd", "bwd") for k in OWN_KERNELS[d]}
        if all(found.values()):
            log(f"[side profiling] {files[0]}: {len(names)} kernel names, the gating kernels {found}")
            return {**run, "trace": files[0], "kernel_names": len(names)}
        log(f"[profiler] enable_profiling: try {attempt + 1} traced {len(names)} kernel names, gating {found}")
    raise AssertionError("profiling: no trace named both gating kernels")


def side_phase(run_dir):
    """Phase 12 in phase 5's float32 run and split (2-D family at full width,
    B=128, kernels, f32, TF32 off)."""
    report = {
        "fold_predict": fold_predict(run_dir),
        "fold_record": fold_record(run_dir),
        "sweep": sweep_check(run_dir),
        "remat": remat_check(),
        "stem": stem_check(),
        **variants_check(),
        "pretrained": pretrained_check(),
        "profiled": profiling_check(),
    }
    torch.cuda.empty_cache()
    log(f"[side] samples/s on {smi_line()}: " + json.dumps({
        "predict_fold_bn": report["fold_predict"]["samples_per_s"], "record_fold_bn": report["fold_record"]["samples_per_s"],
        "sweep_entry": report["sweep"]["entry_samples_per_s"],
        **{k: report[k]["train_samples_per_s"] for k in ("seonly", "shareweight", "pretrained", "profiled")},
        "remat": report["remat"]["remat"]["train_samples_per_s"],
        "no_remat": report["remat"]["no_remat"]["train_samples_per_s"],
        "stem_s2d": report["stem"]["train_samples_per_s"]}))
    return report


# ---- phase 13 helpers ------------------------------------------------------------


# configs/training_dp_v5e8.gin: the global batch of 256 at lr 0.4, bf16
DP_CONFIGS = ["configs/training_guided.gin", "configs/training_dp_v5e8.gin"]
DP_BATCH, DP_LR, DP_RANKS = 256, 0.4, 2
DP_BINDINGS = [b for b in TRAIN_BINDINGS if not b.startswith("train.batch_size")]
DP_STEPS = 3  # (b): guided steps, the last curating modality 1 with the second rank's rows all padding
DP_GROUP_TIMEOUT = datetime.timedelta(seconds=300)
DP_RUN_TIMEOUT = 400.0  # seconds for both ranks of (b) and (c)
DP_LOSS_RTOL = 1e-4  # (b): a step's loss, two ranks against one process (tests/test_parallel.py's)


@contextlib.contextmanager
def collectives_per_step(counts):
    """Appends the collectives of each ``Trainer.train_batch`` call made
    inside the block to ``counts``."""
    original = Trainer.train_batch

    def spy(self, *args, **kwargs):
        before = parallel.collective_count()
        out = original(self, *args, **kwargs)
        counts.append(parallel.collective_count() - before)
        return out

    Trainer.train_batch = spy
    try:
        yield counts
    finally:
        Trainer.train_batch = original


def history_rows(save_path):
    with open(os.path.join(save_path, "history.csv")) as f:
        rows = list(csv.DictReader(f))
    return rows, [{k: v for k, v in r.items() if k not in CLOCK_COLUMNS} for r in rows]


def dp_world1():
    """(a) ``train`` with the DP config at world 1 (a one-rank NCCL group,
    bf16) against the same bindings with ``data_parallel=False``, cuDNN
    deterministic, two epochs on phase 5's split: the same history and
    bit-identical final tensors, the same launches, collectives every
    step."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for tag, extra in (("dp_world1", []), ("dp_plain", ["training_loop.data_parallel=False"])):
            counts = []
            save_path = os.path.join(TRAIN_RUNS, tag)
            with collectives_per_step(counts):
                trainer, fwd, bwd, wall = counted(train, DP_CONFIGS, DP_BINDINGS + extra, save_path, 3)
            rows, kept = history_rows(save_path)
            runs[tag] = {"trainer": trainer, "rows": kept, "fwd_launches": fwd, "bwd_launches": bwd, "wall_s": wall,
                         "collectives_per_step": counts, "world": trainer.world,
                         "train_samples_per_s": [float(r["train_samples_per_sec"]) for r in rows]}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    dp, plain = runs["dp_world1"], runs["dp_plain"]
    steps = dp["trainer"].step
    want = (3 * (steps + 2 * (-(-N_VAL // DP_BATCH) + -(-N_TRAIN_TEST // DP_BATCH))), 3 * steps)
    for tag, run in runs.items():
        if (run["fwd_launches"], run["bwd_launches"]) != want or run["trainer"].step != 2 * (N_TRAIN // DP_BATCH):
            raise AssertionError(f"{tag}: launches {(run['fwd_launches'], run['bwd_launches'])}, want {want}; "
                                 f"{run['trainer'].step} steps")
        if run["trainer"].model.dtype != torch.bfloat16:
            raise AssertionError(f"{tag}: compute dtype {run['trainer'].model.dtype}, the DP config's is bfloat16")
    if dp["world"] is None or dp["world"].size != 1 or plain["world"] is not None or dist.is_initialized():
        raise AssertionError(f"dp_world1: world {dp['world']}, plain {plain['world']}, group left "
                             f"{dist.is_initialized()}")
    if not dp["collectives_per_step"] or min(dp["collectives_per_step"]) <= 0 or any(plain["collectives_per_step"]):
        raise AssertionError(f"collectives per step: world 1 {dp['collectives_per_step']}, plain "
                             f"{plain['collectives_per_step']}")
    if dp["rows"] != plain["rows"]:
        raise AssertionError(f"dp_world1: history {dp['rows']} against the plain run's {plain['rows']}")
    a, b = dp["trainer"].model.state_dict(), plain["trainer"].model.state_dict()
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    if differ:
        raise AssertionError(f"dp_world1: {len(differ)} tensors differ from the plain run's, e.g. {differ[:5]}")
    log(f"[dp world1] {DP_CONFIGS[1]} at world 1 (NCCL, bf16, B={DP_BATCH}, lr {DP_LR}) vs data_parallel=False, "
        f"cuDNN deterministic: history and all {len(a)} tensors bit-identical after {steps} steps | collectives per "
        f"train step {dp['collectives_per_step']} | launches (fwd, bwd) {want} | train samples/s on {smi_line()}: "
        f"world 1 {dp['train_samples_per_s']}, plain {plain['train_samples_per_s']}")
    report = {tag: {k: v for k, v in run.items() if k not in ("trainer", "rows", "world")} for tag, run in runs.items()}
    del runs, dp, plain, a, b
    torch.cuda.empty_cache()
    report["step_samples_per_s"] = dp_step_rates()
    log(f"[dp world1] guided step, B={DP_BATCH} bf16 on a resident batch, {RATE_STEPS} steps a turn, turns plain, "
        f"world 1, world 1, plain: {json.dumps(report['step_samples_per_s'])} samples/s on {smi_line()}")
    return report


def dp_step_rates(warmup=3):
    """(a)'s guided step at the DP config's batch (B=256, bf16, kernels) on a
    resident batch, samples/s of RATE_STEPS steps a turn without and with a
    one-rank NCCL group, in turns plain, world 1, world 1, plain."""
    data = dp_batch(12)
    unlock = torch.tensor(True, device="cuda")
    rates = {"plain": [], "world1": []}
    for tag in ("plain", "world1", "world1", "plain"):
        world, made = parallel.join_world("cuda") if tag == "world1" else (None, False)
        try:
            model = init_model(MMTMMVCNN(nclasses=40, use_pallas=True, dtype=torch.bfloat16), SEED, "cpu").to(
                device="cuda", memory_format=torch.channels_last)
            trainer = Trainer(model, make_optimizer(model.parameters(), lr=DP_LR), controller_kind="guided",
                              controller_config={"epsilon": 0.01, "curation_windowsize": 5}, device="cuda",
                              world=world)
            flips = trainer.train_flips(DP_BATCH, 2)
            for _ in range(warmup):
                trainer.train_batch(data, flips, unlock)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(RATE_STEPS):
                trainer.train_batch(data, flips, unlock)
            torch.cuda.synchronize()
            rates[tag].append(RATE_STEPS * DP_BATCH / (time.perf_counter() - t0))
        finally:
            parallel.leave_world(made)
        del trainer, model
        torch.cuda.empty_cache()
    return rates


def dp_batch(seed, pad=0, batch=DP_BATCH):
    """A global batch of ``batch`` 224² samples on the card, the last ``pad``
    rows padding."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    data = {
        "images": torch.randint(0, 256, (batch, 2, 224, 224, 3), generator=g, device="cuda", dtype=torch.uint8),
        "labels": torch.randint(0, 40, (batch,), generator=g, device="cuda", dtype=torch.int32),
        "mask": torch.ones(batch, device="cuda"),
    }
    data["mask"][batch - pad:] = 0.0
    return data


DP_PADS = (0, 0, DP_BATCH // 2)  # the third batch: the second rank's rows all padding
# phase 13 (b)'s steps: the DP config's global batch and lr, no momentum
DP_SETUP = {"batch": DP_BATCH, "pads": DP_PADS, "lr": DP_LR, "momentum": 0.0, "model_parallel": 1}


def dp_trainer(world, setup=DP_SETUP):
    """The seeded kernel-path trainer of phase 13 (b) and 14 (a); with a
    world, every rank takes rank 0's state and, under tensor parallelism,
    its rows of the wide weights."""
    model = init_model(MMTMMVCNN(nclasses=40, use_pallas=True), SEED, "cpu").to(
        device="cuda", memory_format=torch.channels_last)
    trainer = Trainer(model, make_optimizer(model.parameters(), lr=setup["lr"], momentum=setup["momentum"]),
                      controller_kind="guided", controller_config={"epsilon": 0.01, "curation_windowsize": 5},
                      device="cuda", seed=SEED, world=world)
    if world is not None and world.model_size > 1:
        trainer.distribute()
    return trainer


def dp_state(trainer):
    """The trainer's state whole (a sharded model's weights and momentum
    joined): the model, the controller and SGD's momentum by name."""
    with tensor_parallel.unsharded(trainer.model, trainer.optimizer):
        names = {p: n for n, p in trainer.model.named_parameters()}
        return {"model": {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()},
                "ctrl": {k: v.cpu().clone() for k, v in trainer.ctrl.as_dict().items()},
                "momentum": {names[p]: s["momentum_buffer"].cpu().clone() for p, s in trainer.optimizer.state.items()
                             if s.get("momentum_buffer") is not None}}


def dp_step(trainer, t, start, world, setup=DP_SETUP):
    """Guided step ``t`` from ``start`` (loaded whole) on this rank's rows of
    the global batch, with its rows of the global flips; returns (outputs,
    seconds, the step's collectives, their bytes by group)."""
    with tensor_parallel.unsharded(trainer.model, trainer.optimizer):
        trainer.model.load_state_dict(start["model"])
        for name, p in trainer.model.named_parameters():
            if name in start["momentum"]:
                buf = torch.empty_like(p)  # the parameter's memory format, as SGD makes its buffers
                buf.copy_(start["momentum"][name])
                trainer.optimizer.state[p]["momentum_buffer"] = buf
    trainer.ctrl = ControllerState(**{k: v.cuda() for k, v in start["ctrl"].items()})
    trainer.step = t
    data = dp_batch(40 + t, setup["pads"][t], setup["batch"])
    if world is not None:
        rows = world.rows(setup["batch"])
        data = {k: v[rows] for k, v in data.items()}
    flips = trainer.train_flips(*flip_shape(data["images"].shape))
    torch.cuda.synchronize()
    parallel.reset_collective_count()
    t0 = time.perf_counter()
    out = trainer.train_batch(data, flips, torch.tensor(True, device="cuda"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    nbytes = bytes_by_group(world) if world is not None else {}
    return {"loss": float(out["loss"]), "acc": float(out["acc"]), "curated": bool(out["curated"]),
            "curation_mode": bool(trainer.ctrl.curation_mode), "caring_modality": int(trainer.ctrl.caring_modality)
            }, seconds, parallel.collective_count(), nbytes


def dp_one_process(path, setup=DP_SETUP):
    """(b)'s reference: DP_STEPS guided steps of one process on the global
    batches (f32, TF32 off) from the seeded model, the controller deciding
    each step but the last, which curates modality 1 (its forward reads
    the running averages); each step's start and end saved to ``path``."""
    trainer = dp_trainer(None, setup)
    starts, ends, outs = [], [], []
    for t in range(DP_STEPS):
        if t == DP_STEPS - 1:
            trainer.ctrl = dataclasses.replace(trainer.ctrl, curation_mode=torch.tensor(True, device="cuda"),
                                               caring_modality=torch.tensor(1, dtype=torch.int32, device="cuda"),
                                               curation_step=torch.tensor(0, dtype=torch.int32, device="cuda"))
        starts.append(dp_state(trainer))
        out, *_ = dp_step(trainer, t, starts[-1], None, setup)
        outs.append(out)
        ends.append(dp_state(trainer)["model"])
    torch.save({"starts": starts, "ends": ends, "outs": outs}, path)
    del trainer
    torch.cuda.empty_cache()
    return outs


def state_digest(state) -> str:
    h = hashlib.sha256()
    for k, v in state.items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def whole_digest(whole) -> str:
    """The digest of :func:`dp_state`'s model, momentum and controller,
    each name under its part's."""
    return state_digest({f"{part}/{k}": v for part in ("model", "momentum", "ctrl") for k, v in whole[part].items()})


def bytes_by_group(world):
    """The bytes the collectives carried since the count was reset, by the
    group they ran over: ``model`` (the world's model group), ``data`` (its
    data group) or ``world`` (the default group: the data group at model
    size 1)."""
    names = {world.model_group: "model", world.data_group: "data", None: "world"}
    return {names[g]: n for g, n in parallel.collective_bytes().items()}


@contextlib.contextmanager
def buffer_broadcasts(record):
    """Appends (collectives, bytes) of each ``tensor.broadcast_buffers_``
    call inside the block to ``record``."""
    original = tensor_parallel.broadcast_buffers_

    def spy(model, world):
        count, nbytes = parallel.collective_count(), sum(parallel.collective_bytes().values())
        original(model, world)
        record.append((parallel.collective_count() - count, sum(parallel.collective_bytes().values()) - nbytes))

    tensor_parallel.broadcast_buffers_ = spy
    try:
        yield record
    finally:
        tensor_parallel.broadcast_buffers_ = original


def replicated_buffer_bytes():
    """(count, bytes as broadcast: float32) of the 2-D model's floating
    buffers, the BatchNorm statistics and the MMTM running averages."""
    buffers = tensor_parallel.replicated_buffers(MMTMMVCNN(nclasses=40))
    return len(buffers), 4 * sum(b.numel() for b in buffers)


def dp_rank(rank, ref_path, record_bindings, record_path, setup=DP_SETUP):
    """One of the ranks sharing cuda:0 in a gloo group (NCCL refuses two
    ranks on one card), ``setup["model_parallel"]`` a model group: phase 13
    (b) / 14 (a) each guided step from the one-process run's start, on this
    rank's rows, against that run's end (the rank's state read whole); phase
    13 / 14 (c) the recording ``eval_`` with ``evalution_loop.data_parallel``
    and that ``model_parallel``."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="env://", timeout=DP_GROUP_TIMEOUT)
    try:
        world = parallel.world_from_process_group(setup["model_parallel"])
        ref = torch.load(ref_path, weights_only=False)
        trainer = dp_trainer(world, setup)
        steps = []
        for t in range(DP_STEPS):
            mmtm_gating.launches = mmtm_gating_bwd.launches = 0
            with buffer_broadcasts([]) as broadcasts:
                out, seconds, collectives, nbytes = dp_step(trainer, t, ref["starts"][t], world, setup)
            start, want = ref["starts"][t]["model"], ref["ends"][t]
            whole = dp_state(trainer)
            ratios = l2_over_update(float_state_of(whole["model"]), float_state_of(want), float_state_of(start))
            beyond = [k for k, (_, d, u) in ratios.items() if d > STEP_TOL * u + 1e-7]
            steps.append({**out, "seconds": seconds, "fwd_launches": mmtm_gating.launches,
                          "bwd_launches": mmtm_gating_bwd.launches, "collectives": collectives,
                          "collective_bytes": nbytes, "l2_diff_over_update": max(v[0] for v in ratios.values()),
                          "beyond": beyond, "digest": whole_digest(whole),
                          "buffer_broadcasts": broadcasts,
                          "buffers_digest": state_digest({n: b for n, b in trainer.model.named_buffers()
                                                          if b.is_floating_point()})})
        names = {p: n for n, p in trainer.model.named_parameters()}
        held = {"params": {n: tuple(p.shape) for n, p in trainer.model.named_parameters()},
                "momentum": {names[p]: tuple(s["momentum_buffer"].shape) for p, s in trainer.optimizer.state.items()
                             if s.get("momentum_buffer") is not None}}
        del trainer, ref
        torch.cuda.empty_cache()
        cfg.clear_config()
        cfg.parse_config_files_and_bindings(
            [os.path.join(REPO, "configs/recording.gin")],
            "\n".join(record_bindings + ["evalution_loop.data_parallel=True",
                                         f"evalution_loop.model_parallel={setup['model_parallel']}"]))
        with built_pipelines() as built, contextlib.redirect_stdout(io.StringIO()):
            mmtm_gating.launches = mmtm_gating_bwd.launches = 0
            eval_(record_path)
            torch.cuda.synchronize()
            record = {"fwd_launches": mmtm_gating.launches, "bwd_launches": mmtm_gating_bwd.launches,
                      "resident": [(p.resident, str(p.device)) for p in built if p.epoch > 0]}
        cfg.clear_config()
        return {"steps": steps, "record": record, "held": held, "world": (world.data_index, world.model_index)}
    finally:
        dist.destroy_process_group()


def float_state_of(state):
    return {k: v.float() for k, v in state.items() if v.is_floating_point()}


def dp_record_bindings(run_dir):
    """Phase 13's and 14's recording ``eval_`` on phase 5's f32 run."""
    return [
        f"get_mvdcndata.root_dir='{TRAIN_DATA}'", "get_mvdcndata.specific_views=[0, 1]",
        "MMTM_mitigate.use_pallas=True", f"eval_.batch_size={DP_BATCH}", "eval_.device='cuda:0'",
        f"eval_.pretrained_weights_path='{os.path.join(run_dir, 'model_best_val.pt')}'",
    ]


def dp_phase(run_dir):
    """Phase 13: data parallelism on the card (2-D family at full width,
    the DP config's global batch of 256): (a) world 1 against the plain run,
    (b) two gloo ranks on cuda:0 against one process, step by step, (c) the
    recording ``eval_`` at two ranks against one process."""
    report = {"world1": dp_world1()}

    ref_path = os.path.join(WORK, "dp_reference.pt")
    rows = N_TRAIN + N_VAL  # recording.gin: valid_size=0, the whole train file
    record_bindings = dp_record_bindings(run_dir)
    one_record = os.path.join(TRAIN_RUNS, "dp_record_one")
    ranks_record = os.path.join(TRAIN_RUNS, "dp_record_ranks")
    try:
        one = dp_one_process(ref_path)
        trainer, fwd, bwd, wall = counted(eval_, ["configs/recording.gin"], record_bindings, one_record, 1)
        del trainer
        torch.cuda.empty_cache()
        t0 = time.time()
        ranks = run_ranks(dp_rank, DP_RANKS, ref_path, record_bindings, ranks_record, timeout=DP_RUN_TIMEOUT)
        spawn_s = time.time() - t0
    finally:
        if os.path.exists(ref_path):
            os.remove(ref_path)

    # (b) each step: the same decisions and digests on both ranks, losses and
    # tensors against the one process
    batches = -(-DP_BATCH // DP_RANKS)
    for t, want in enumerate(one):
        got = [r["steps"][t] for r in ranks]
        for key in ("curated", "curation_mode", "caring_modality"):
            if any(g[key] != want[key] for g in got):
                raise AssertionError(f"dp step {t}: {key} {[g[key] for g in got]}, one process {want[key]}")
        if len({g["digest"] for g in got}) != 1 or len({g["loss"] for g in got}) != 1:
            raise AssertionError(f"dp step {t}: the ranks' states or losses differ")
        if not abs(got[0]["loss"] - want["loss"]) <= DP_LOSS_RTOL * abs(want["loss"]):
            raise AssertionError(f"dp step {t}: loss {got[0]['loss']} vs one process {want['loss']}")
        if got[0]["beyond"]:
            raise AssertionError(f"dp step {t}: beyond {STEP_TOL} x the update in {got[0]['beyond'][:5]}")
        for rank, g in enumerate(got):
            if (g["fwd_launches"], g["bwd_launches"]) != (3, 3) or g["collectives"] <= 0:
                raise AssertionError(f"dp step {t} rank {rank}: launches {(g['fwd_launches'], g['bwd_launches'])}, "
                                     f"want (3, 3); {g['collectives']} collectives")
            if g["buffer_broadcasts"] != [(0, 0)]:  # model size 1: no buffer broadcast
                raise AssertionError(f"dp step {t} rank {rank}: buffer broadcasts {g['buffer_broadcasts']}")
    if not one[-1]["curated"]:
        raise AssertionError("dp: the last step did not curate")
    rates = [DP_BATCH / max(r["steps"][t]["seconds"] for r in ranks) for t in range(DP_STEPS)]
    report["gloo"] = {
        "l2_diff_over_update": [max(r["steps"][t]["l2_diff_over_update"] for r in ranks) for t in range(DP_STEPS)],
        "loss_rel_err": [abs(ranks[0]["steps"][t]["loss"] - o["loss"]) / abs(o["loss"]) for t, o in enumerate(one)],
        "curated": [o["curated"] for o in one],
        "collectives_per_step": [ranks[0]["steps"][t]["collectives"] for t in range(DP_STEPS)],
        "launches_per_rank": [[sum(s[k] for s in r["steps"]) for k in ("fwd_launches", "bwd_launches")] for r in ranks],
        "samples_per_s_correctness_only": rates, "spawn_s": spawn_s,
    }
    log(f"[dp gloo] {DP_RANKS} ranks on cuda:0 (gloo) vs one process, f32, TF32 off, B={DP_BATCH} ({batches} a rank), "
        f"{DP_STEPS} guided steps each from the one process's start: largest ||diff||_2 / ||update||_2 a step "
        f"{report['gloo']['l2_diff_over_update']}, loss rel err {report['gloo']['loss_rel_err']}, curated "
        f"{report['gloo']['curated']} on both, collectives a step {report['gloo']['collectives_per_step']}, "
        f"launches (fwd, bwd) per rank {report['gloo']['launches_per_rank']} | correctness only: gloo through the "
        f"host, two processes sharing one card: {rates} samples/s on {smi_line()}")

    # (c) the recording at two ranks against one process
    recorded = {tag: recorded_maps(tag, path, rows, DP_BATCH)
                for tag, path in (("dp_record_one", one_record), ("dp_record_ranks", ranks_record))}
    order = {}
    for tag, path in (("one", one_record), ("ranks", ranks_record)):
        with open(os.path.join(path, "eval_history_batch", "history.pickle"), "rb") as f:
            order[tag] = np.concatenate([np.asarray(i) for i in pickle.load(f)["test_indices"]])
    if not np.array_equal(order["one"], order["ranks"]):
        raise AssertionError("dp record: the indices are not in the one-process order")
    rec_batches = -(-rows // DP_BATCH)
    for rank, r in enumerate(ranks):
        rec = r["record"]
        if (rec["fwd_launches"], rec["bwd_launches"]) != (3 * rec_batches, 0) or rec["resident"] != [(True, "cuda:0")]:
            raise AssertionError(f"dp record rank {rank}: launches {(rec['fwd_launches'], rec['bwd_launches'])}, "
                                 f"want {(3 * rec_batches, 0)}; splits {rec['resident']}")
    if (fwd, bwd) != (3 * rec_batches, 0):
        raise AssertionError(f"dp record one process: launches {(fwd, bwd)}")
    sq_rtol, sq_atol = TOL[torch.float32]["sq"]
    report["record_max_abs_err"] = max(
        check_close(f"dp recorded squeeze mmtm{m + 2} view {v}: two ranks vs one process", torch.from_numpy(g),
                    torch.from_numpy(w), sq_rtol, sq_atol)
        for m, (gm, wm) in enumerate(zip(recorded["dp_record_ranks"], recorded["dp_record_one"]))
        for v, (g, w) in enumerate(zip(gm, wm)))
    report["record_launches_per_rank"] = [r["record"]["fwd_launches"] for r in ranks]
    report["record_one"] = eval_rate("dp_record_one", one_record, rows, fwd, wall)
    report["record_ranks"] = eval_rate("dp_record_ranks", ranks_record, rows, report["record_launches_per_rank"][0],
                                       spawn_s)
    log(f"[dp record] {rows} samples at two ranks vs one process, B={DP_BATCH}: each index once, in the one "
        f"process's order; squeeze maps max |diff| {report['record_max_abs_err']:.3e} (sq tolerance); forward "
        f"launches per rank {report['record_launches_per_rank']}")
    return report


# ---- phase 14 helpers ------------------------------------------------------------


TP = 2
# (a): dp 1 × tp 2 at B=128, SGD momentum 0.9 so that the momentum buffers are
# split too, cuDNN's default algorithms: the two ranks compute the replicated
# part of the step each on its own and must still end with the same bits
TP_SETUP = {"batch": BATCH, "pads": (0, 0, BATCH // 4), "lr": 0.1, "momentum": 0.9, "model_parallel": TP}
TP_GRID = 4  # (b): dp 2 × tp 2 ranks
TP_SHARDED = 26  # the weights the JAX rule splits: layer3/4's 5 convolutions a tower, mmtm3/4's 3 linears


def tp_train_rank(rank, bindings, save_path):
    """(b) one of TP_GRID ranks sharing cuda:0 in a gloo group: the ``train``
    entry with the DP config and ``model_parallel=2``, and the digest of the
    rank's whole state after it."""
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="env://", timeout=DP_GROUP_TIMEOUT)
    try:
        cfg.clear_config()
        cfg.parse_config_files_and_bindings([os.path.join(REPO, c) for c in DP_CONFIGS], "\n".join(bindings))
        with built_pipelines() as built, contextlib.redirect_stdout(io.StringIO()):
            mmtm_gating.launches = mmtm_gating_bwd.launches = 0
            t0 = time.time()
            trainer = train(save_path)
            torch.cuda.synchronize()
            out = {"fwd_launches": mmtm_gating.launches, "bwd_launches": mmtm_gating_bwd.launches,
                   "wall_s": time.time() - t0, "steps": trainer.step, "dtype": str(trainer.model.dtype),
                   "world": (trainer.world.size, trainer.world.model_size, trainer.world.data_index,
                             trainer.world.model_index),
                   "sharded": len(tensor_parallel.sharded_weights(trainer.model)),
                   "resident": [(p.resident, str(p.device)) for p in built if p.epoch > 0],
                   "digest": whole_digest(dp_state(trainer))}
        cfg.clear_config()
        return out
    finally:
        dist.destroy_process_group()


def check_held(rank, held):
    """TP_SHARDED weights of each rank hold half their 256 or 512 output rows,
    their momentum buffers alike; every other parameter is whole."""
    whole = {n: tuple(p.shape) for n, p in MMTMMVCNN(nclasses=40).named_parameters()}
    split = {n: s for n, s in held["params"].items() if s != whole[n]}
    if len(split) != TP_SHARDED or any(whole[n][0] not in (256, 512) or s != (whole[n][0] // TP,) + whole[n][1:]
                                       for n, s in split.items()):
        raise AssertionError(f"tp rank {rank}: {len(split)} weights split, {sorted(split.items())[:4]}")
    if held["momentum"] != held["params"]:
        raise AssertionError(f"tp rank {rank}: momentum buffers {len(held['momentum'])} not shaped as the weights")
    return len(split)


def tp_phase(run_dir):
    """Phase 14: tensor parallelism on the card (2-D family at full width,
    ranks sharing cuda:0 over gloo): (a) dp 1 × tp 2 against one process,
    step by step; (b) the ``train`` entry with the DP config and
    ``model_parallel=2`` at dp 2 × tp 2; (c) the recording ``eval_`` at tp 2
    against phase 13's one-process recording."""
    ref_path = os.path.join(WORK, "tp_reference.pt")
    rows = N_TRAIN + N_VAL
    record_path = os.path.join(TRAIN_RUNS, "tp_record_ranks")
    try:
        one = dp_one_process(ref_path, TP_SETUP)
        t0 = time.time()
        ranks = run_ranks(dp_rank, TP, ref_path, dp_record_bindings(run_dir), record_path, TP_SETUP,
                          timeout=DP_RUN_TIMEOUT)
        spawn_s = time.time() - t0
    finally:
        if os.path.exists(ref_path):
            os.remove(ref_path)

    # (a) each step: the same decisions and whole states on both ranks, losses
    # and tensors against the one process; the rows each rank holds
    n_buffers, buffer_bytes = replicated_buffer_bytes()
    report = {"world": [r["world"] for r in ranks], "sharded": [check_held(i, r["held"]) for i, r in enumerate(ranks)],
              "buffer_broadcast": {"buffers": n_buffers, "collectives_per_step": 1, "bytes_per_step": buffer_bytes}}
    if report["world"] != [(0, m) for m in range(TP)]:
        raise AssertionError(f"tp: (data, model) indices {report['world']}")
    for t, want in enumerate(one):
        got = [r["steps"][t] for r in ranks]
        for key in ("curated", "curation_mode", "caring_modality"):
            if any(g[key] != want[key] for g in got):
                raise AssertionError(f"tp step {t}: {key} {[g[key] for g in got]}, one process {want[key]}")
        if len({g["digest"] for g in got}) != 1 or len({g["loss"] for g in got}) != 1:
            raise AssertionError(f"tp step {t}: the ranks' whole states or losses differ")
        if not abs(got[0]["loss"] - want["loss"]) <= DP_LOSS_RTOL * abs(want["loss"]):
            raise AssertionError(f"tp step {t}: loss {got[0]['loss']} vs one process {want['loss']}")
        if got[0]["beyond"]:
            raise AssertionError(f"tp step {t}: beyond {STEP_TOL} x the update in {got[0]['beyond'][:5]}")
        for rank, g in enumerate(got):
            if (g["fwd_launches"], g["bwd_launches"]) != (3, 3) or g["collectives"] <= 0:
                raise AssertionError(f"tp step {t} rank {rank}: launches {(g['fwd_launches'], g['bwd_launches'])}, "
                                     f"want (3, 3); {g['collectives']} collectives")
            # the replicated buffers: one broadcast a step over the model group, then equal on both ranks
            if g["buffer_broadcasts"] != [(1, buffer_bytes)]:
                raise AssertionError(f"tp step {t} rank {rank}: buffer broadcasts {g['buffer_broadcasts']}, want "
                                     f"[(1, {buffer_bytes})]")
        if len({g["buffers_digest"] for g in got}) != 1:
            raise AssertionError(f"tp step {t}: the replicated buffers differ between the ranks")
    if not one[-1]["curated"]:
        raise AssertionError("tp: the last step did not curate")
    rates = [TP_SETUP["batch"] / max(r["steps"][t]["seconds"] for r in ranks) for t in range(DP_STEPS)]
    report["steps"] = {
        "l2_diff_over_update": [max(r["steps"][t]["l2_diff_over_update"] for r in ranks) for t in range(DP_STEPS)],
        "loss_rel_err": [abs(ranks[0]["steps"][t]["loss"] - o["loss"]) / abs(o["loss"]) for t, o in enumerate(one)],
        "curated": [o["curated"] for o in one],
        "collectives_per_step": [ranks[0]["steps"][t]["collectives"] for t in range(DP_STEPS)],
        "collective_bytes_per_step": [ranks[0]["steps"][t]["collective_bytes"] for t in range(DP_STEPS)],
        "launches_per_rank": [[sum(s[k] for s in r["steps"]) for k in ("fwd_launches", "bwd_launches")]
                              for r in ranks],
        "samples_per_s_correctness_only": rates, "spawn_s": spawn_s,
    }
    steps = report["steps"]
    log(f"[tp steps] dp 1 x tp 2 on cuda:0 (gloo) vs one process, f32, TF32 off, cuDNN default algorithms, "
        f"B={TP_SETUP['batch']}, SGD momentum {TP_SETUP['momentum']}, {DP_STEPS} guided steps each from the one "
        f"process's start: {report['sharded']} weights split on the ranks (momentum alike); largest ||diff||_2 / "
        f"||update||_2 a step {steps['l2_diff_over_update']}, loss rel err {steps['loss_rel_err']}, curated "
        f"{steps['curated']} on both, both ranks' whole states identical, collectives a step "
        f"{steps['collectives_per_step']}, bytes a step by group {steps['collective_bytes_per_step']}, of which the "
        f"replicated buffers' broadcast 1 collective and {buffer_bytes} bytes over the model group ({n_buffers} "
        f"buffers, equal on both ranks after every step), launches "
        f"(fwd, bwd) per rank {steps['launches_per_rank']} | correctness only: gloo through the host, two "
        f"processes sharing one card: {rates} samples/s on {smi_line()}")

    # (c) the recording at tp 2 against phase 13's one-process recording
    one_record = os.path.join(TRAIN_RUNS, "dp_record_one")
    recorded = {tag: recorded_maps(tag, path, rows, DP_BATCH)
                for tag, path in (("dp_record_one", one_record), ("tp_record_ranks", record_path))}
    order = {}
    for tag, path in (("one", one_record), ("ranks", record_path)):
        with open(os.path.join(path, "eval_history_batch", "history.pickle"), "rb") as f:
            order[tag] = np.concatenate([np.asarray(i) for i in pickle.load(f)["test_indices"]])
    if not np.array_equal(order["one"], order["ranks"]):
        raise AssertionError("tp record: the indices are not in the one-process order")
    rec_batches = -(-rows // DP_BATCH)
    for rank, r in enumerate(ranks):
        rec = r["record"]
        if (rec["fwd_launches"], rec["bwd_launches"]) != (3 * rec_batches, 0) or rec["resident"] != [(True, "cuda:0")]:
            raise AssertionError(f"tp record rank {rank}: launches {(rec['fwd_launches'], rec['bwd_launches'])}, "
                                 f"want {(3 * rec_batches, 0)}; splits {rec['resident']}")
    sq_rtol, sq_atol = TOL[torch.float32]["sq"]
    report["record_max_abs_err"] = max(
        check_close(f"tp recorded squeeze mmtm{m + 2} view {v}: tp 2 vs one process", torch.from_numpy(g),
                    torch.from_numpy(w), sq_rtol, sq_atol)
        for m, (gm, wm) in enumerate(zip(recorded["tp_record_ranks"], recorded["dp_record_one"]))
        for v, (g, w) in enumerate(zip(gm, wm)))
    report["record_launches_per_rank"] = [r["record"]["fwd_launches"] for r in ranks]
    report["record_ranks"] = eval_rate("tp_record_ranks", record_path, rows, report["record_launches_per_rank"][0],
                                       spawn_s)
    log(f"[tp record] {rows} samples at tp 2 vs phase 13's one process, B={DP_BATCH}: each index once, in the one "
        f"process's order; squeeze maps max |diff| {report['record_max_abs_err']:.3e} (sq tolerance); forward "
        f"launches per rank {report['record_launches_per_rank']}")

    # (b) the DP config's train entry at dp 2 × tp 2
    save_path = os.path.join(TRAIN_RUNS, "tp_grid")
    bindings = DP_BINDINGS + ["train.device='cuda:0'", f"training_loop.model_parallel={TP}"]
    t0 = time.time()
    grid = run_ranks(tp_train_rank, TP_GRID, bindings, save_path, timeout=DP_RUN_TIMEOUT)
    grid_s = time.time() - t0
    world1 = os.path.join(TRAIN_RUNS, "dp_world1")
    with open(os.path.join(world1, "history.csv")) as f:
        want_columns = next(csv.reader(f))
    with open(os.path.join(save_path, "history.csv")) as f:
        history = list(csv.DictReader(f))
    if list(history[0]) != want_columns or [int(r["epoch"]) for r in history] != [1, 2]:
        raise AssertionError(f"tp grid: history columns {list(history[0])} epochs {[r['epoch'] for r in history]}, "
                             f"want phase 13's {want_columns} and [1, 2]")
    for r in history:
        losses = [float(r[k]) for k in ("loss", "val_loss", "test_loss")]
        if not np.isfinite(losses).all():
            raise AssertionError(f"tp grid: epoch {r['epoch']} losses {losses}")
    if len({g["digest"] for g in grid}) != 1:
        raise AssertionError(f"tp grid: the ranks' whole states differ after the train entry: "
                             f"{[g['digest'][:12] for g in grid]}")
    grid_steps = grid[0]["steps"]
    want = (3 * (grid_steps + 2 * (-(-N_VAL // DP_BATCH) + -(-N_TRAIN_TEST // DP_BATCH))), 3 * grid_steps)
    for rank, g in enumerate(grid):
        if ((g["fwd_launches"], g["bwd_launches"]) != want or g["steps"] != 2 * (N_TRAIN // DP_BATCH)
                or g["world"] != (TP_GRID, TP, rank // TP, rank % TP) or g["sharded"] != TP_SHARDED
                or g["dtype"] != str(torch.bfloat16) or g["resident"] != [(True, "cuda:0")] * 3):
            raise AssertionError(f"tp grid rank {rank}: {g}, want launches {want}")
    ckpt = os.path.join(save_path, "model_last_epoch.pt")
    got_state = torch.load(ckpt, map_location="cpu", weights_only=True)["model"]
    want_state = torch.load(os.path.join(world1, "model_last_epoch.pt"), map_location="cpu", weights_only=True)["model"]
    if {k: v.shape for k, v in got_state.items()} != {k: v.shape for k, v in want_state.items()}:
        raise AssertionError("tp grid: the checkpoint's names or shapes are not a world-1 run's")
    model = MMTMMVCNN(nclasses=40)
    load_weights(model, ckpt)
    loaded = model.state_dict()
    if any(not torch.equal(loaded[k], v) for k, v in got_state.items()):
        raise AssertionError("tp grid: the one-process port does not load the checkpoint as written")
    load_training_state(model, make_optimizer(model.parameters(), lr=DP_LR), ckpt)
    report["grid"] = {
        "train_samples_per_s_correctness_only": [float(r["train_samples_per_sec"]) for r in history],
        "launches_per_rank": [[g["fwd_launches"], g["bwd_launches"]] for g in grid], "spawn_s": grid_s,
        "losses": [float(r["loss"]) for r in history],
    }
    log(f"[tp grid] train entry, {DP_CONFIGS[1]} + model_parallel={TP} at dp 2 x tp 2 (4 gloo ranks on cuda:0, "
        f"bf16, B={DP_BATCH}, lr {DP_LR}): epochs [1, 2], the JAX columns, {TP_SHARDED} weights split on each rank, "
        f"every rank's whole state (model, momentum, controller) bit-identical after the entry; "
        f"the checkpoint whole ({len(got_state)} entries, world 1's names and shapes), loaded by the one-process "
        f"port | launches (fwd, bwd) per rank {report['grid']['launches_per_rank']} (want {want}) | correctness "
        f"only: train samples/s {report['grid']['train_samples_per_s_correctness_only']}, {grid_s:.1f}s for the "
        f"four ranks, on {smi_line()}")
    return report


# ---- phase 15 helpers ------------------------------------------------------------


DRAW_CALLS = 200  # host draws timed for the per-step cost
SNAP_CONFIGS = ["configs/training_random.gin"]
SNAP_EPOCHS = 3  # (c): the straight run's epochs; snapshots of the last two kept


def init_check():
    """(a) ``init_model(SEED)`` on the card against the CPU, bit for bit, for
    both families at full width (the draws are made on the host either way),
    each drawn anew (the process keeps the last two draws: cleared before
    each), with the seconds of each, and of a third init that finds the
    draws kept."""
    out = {}
    for family, make in (("2d", lambda: MMTMMVCNN(nclasses=40, use_pallas=True)),
                         ("3d", lambda: MMTM3DCNN(nclasses=CLIP_CLASSES))):
        init_layers._initial_state.cache_clear()
        t0 = time.time()
        cpu = init_model(make(), SEED, "cpu")
        cpu_s = time.time() - t0
        init_layers._initial_state.cache_clear()
        t0 = time.time()
        card = init_model(make(), SEED, "cuda")
        torch.cuda.synchronize()
        card_s = time.time() - t0
        t0 = time.time()
        init_model(make(), SEED, "cuda")
        torch.cuda.synchronize()
        kept_s = time.time() - t0
        want = cpu.state_dict()
        differ = [k for k, v in card.state_dict().items() if not torch.equal(v.cpu(), want[k])]
        n = sum(p.numel() for p in cpu.parameters())
        log(f"[prng init {family}] {n} parameters: init_model {card_s:.2f}s on cuda, {cpu_s:.2f}s on the CPU, "
            f"{kept_s:.2f}s on cuda with the draws kept; {len(want) - len(differ)} of {len(want)} tensors "
            "bit-identical")
        if differ:
            raise AssertionError(f"init {family}: the card's init differs from the CPU's in {differ[:5]}")
        out[family] = {"parameters": n, "init_s_cuda": card_s, "init_s_cpu": cpu_s, "init_s_kept": kept_s}
        if family == "2d":
            out["models"] = (cpu, card)
        else:
            del cpu, card
            torch.cuda.empty_cache()
    return out


def draws_check(cpu_model, card_model):
    """(b) the flips ((B, V) images, (B,) clips) and the random controller's
    decisions of 5 steps on the card equal the CPU's; the host's cost of
    a step's draws."""
    def random_trainer(model, device):
        return Trainer(model, make_optimizer(model.parameters(), lr=0.1), controller_kind="random", nummodalities=2,
                       seed=SEED, device=device, verbose=False)

    card, cpu = random_trainer(card_model, "cuda"), random_trainer(cpu_model, "cpu")
    decisions = {"cuda": [], "cpu": []}
    for t in range(5):
        for trainer in (card, cpu):
            trainer.step = t
        for shape in ((BATCH, 2), (CLIP_BATCH,)):
            got, want = card.train_flips(*shape), cpu.train_flips(*shape)
            if got.device.type != "cuda" or not torch.equal(got.cpu(), want):
                raise AssertionError(f"step {t}: the card's {shape} flips differ from the CPU's")
        for device, trainer in (("cuda", card), ("cpu", cpu)):
            ones = torch.ones(4, device=device)
            trainer.ctrl = trainer._controller_update(trainer.ctrl, ones, ones, torch.tensor(t >= 1, device=device))
            decisions[device].append((trainer.ctrl.curation_mode, trainer.ctrl.caring_modality))
    fetched = {d: [(bool(m), int(c)) for m, c in v] for d, v in decisions.items()}
    if fetched["cuda"] != fetched["cpu"] or fetched["cuda"] != [
            (t >= 1 and d != 0, (1 if d == 1 else 0) if t >= 1 and d != 0 else 0)
            for t, d in enumerate(chain_draws(SEED, 5, 2))]:
        raise AssertionError(f"random decisions: card {fetched['cuda']}, CPU {fetched['cpu']}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(DRAW_CALLS):
        card.step = t
        card.train_flips(BATCH, 2)
    flips_us = (time.perf_counter() - t0) / DRAW_CALLS * 1e6
    key = prng.PRNGKey(SEED)
    t0 = time.perf_counter()
    for _ in range(DRAW_CALLS):
        key, _ = random_draw(key, 2)
    ctrl_us = (time.perf_counter() - t0) / DRAW_CALLS * 1e6
    torch.cuda.synchronize()
    log(f"[prng draws] 5 steps: flips (B={BATCH}, V=2) and (B={CLIP_BATCH},) and random decisions {fetched['cuda']} "
        f"equal on the card and the CPU; host us a step: flips {flips_us:.1f} (draw, pinned copy, upload queued), "
        f"random controller draw {ctrl_us:.1f}")
    return {"decisions": fetched["cuda"], "flips_host_us": flips_us, "controller_draw_host_us": ctrl_us}


def snapshot_run(tag, extra):
    """One counted ``train`` run of (c) on phase 5's split (random
    controller, f32, kernels), its steps logged; returns (trainer,
    forward launches, backward launches, history rows, steps)."""
    save_path = os.path.join(TRAIN_RUNS, tag)
    with step_log() as steps:
        trainer, fwd, bwd, wall = counted(train, SNAP_CONFIGS, TRAIN_BINDINGS[:-1] + extra, save_path, 3)
    with open(os.path.join(save_path, "history.csv")) as f:
        rows = list(csv.DictReader(f))
    for r in rows:
        if not np.isfinite([float(r[k]) for k in ("loss", "val_loss", "test_loss")]).all():
            raise AssertionError(f"{tag}: epoch {r['epoch']} is not finite")
    log(f"[snapshots {tag}] {len(rows)} epochs, {trainer.step} steps, {wall:.1f}s, launches {fwd} / {bwd}; "
        f"epoch s {[round(float(r['time']), 3) for r in rows]}; decisions {[(m, k) for _, _, m, k in steps]}")
    return trainer, fwd, bwd, rows, steps


def history_values(rows):
    return [{k: v for k, v in r.items() if k not in CLOCK_COLUMNS} for r in rows]


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def snapshot_train_check():
    """(c) the ``train`` entry with ``orbax_dir`` and ``orbax_max_to_keep=2``
    over SNAP_EPOCHS epochs, under cuDNN's deterministic algorithms: the
    last two snapshots kept; the same run without snapshots bit-identical
    to it (epoch times side by side); a run of one epoch fewer (at world 1
    over NCCL, so the saves take the gloo group beside it), resumed from
    its newest snapshot, bit-identical to the straight run; how long
    each save held the loop, against one synchronous ``dcp.save`` of the
    same state, and the bytes of one snapshot."""
    import torch.distributed.checkpoint as dcp
    from greedy_multimodal_learning_tpu_torch.engine.snapshots import Snapshots, pack_tree, state_to_tree

    epochs = [f"training_loop.n_epochs={SNAP_EPOCHS + 1}"]
    snap = ["training_loop.orbax_dir='snapshots'", "training_loop.orbax_max_to_keep=2"]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    restored = []
    original = Snapshots.restore_latest

    def spy(self, trainer):
        restored.append(original(self, trainer))
        return restored[-1]

    try:
        runs = {"straight": snapshot_run("snap_straight", epochs + snap),
                "plain": snapshot_run("snap_plain", epochs)}
        straight = runs["straight"][0]
        setup_s = straight.snapshots.setup_s  # the warm-up save of Snapshots.__init__, before epoch 1
        kept = sorted(os.listdir(os.path.join(TRAIN_RUNS, "snap_straight", "snapshots")))
        blocked = list(straight.snapshots.blocked_s)
        nbytes = dir_bytes(os.path.join(TRAIN_RUNS, "snap_straight", "snapshots", str(SNAP_EPOCHS)))
        sync_dir = os.path.join(TRAIN_RUNS, "snap_sync")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dcp.save(pack_tree(state_to_tree(straight)), checkpoint_id=sync_dir, no_dist=True)  # what save() writes
        sync_s = time.perf_counter() - t0
        # its first epochs at world 1 over NCCL: the saves coordinate over a
        # gloo group made beside it
        snapshot_run("snap_resumed", [f"training_loop.n_epochs={SNAP_EPOCHS}", "training_loop.data_parallel=True"]
                     + snap)
        Snapshots.restore_latest = spy
        runs["resumed"] = snapshot_run("snap_resumed", epochs + snap + ["training_loop.resume=True"])
    finally:
        Snapshots.restore_latest = original
        torch.backends.cudnn.deterministic = deterministic
    if kept != [str(SNAP_EPOCHS - 1), str(SNAP_EPOCHS)]:
        raise AssertionError(f"snapshots kept {kept}, want the last two of {SNAP_EPOCHS}")
    if restored != [SNAP_EPOCHS - 1]:
        raise AssertionError(f"the resume restored snapshot(s) {restored}, want {SNAP_EPOCHS - 1}")
    whole = {tag: whole_digest(dp_state(r[0])) for tag, r in runs.items()}
    steps = {tag: r[0].step for tag, r in runs.items()}
    same = {tag: history_values(r[3]) == history_values(runs["straight"][3]) for tag, r in runs.items()}
    decisions = {tag: [(m, k) for _, _, m, k in r[4]] for tag, r in runs.items()}
    log(f"[snapshots] kept {kept}; resumed from {restored}; whole-state digests equal: plain "
        f"{whole['plain'] == whole['straight']}, resumed {whole['resumed'] == whole['straight']}; histories equal "
        f"{same}; steps {steps}; save() held the loop {[round(b * 1e3, 2) for b in blocked]} ms against one "
        f"synchronous dcp.save {sync_s * 1e3:.1f} ms; {nbytes} bytes a snapshot")
    if whole["plain"] != whole["straight"] or whole["resumed"] != whole["straight"] or not all(same.values()):
        raise AssertionError(f"snapshots: the runs differ (digests {whole}, histories equal {same})")
    if decisions["resumed"] != decisions["straight"][-len(decisions["resumed"]):]:
        raise AssertionError(f"resumed decisions {decisions['resumed']} do not continue {decisions['straight']}")
    epoch_s = {tag: [float(r["time"]) for r in runs[tag][3]] for tag in ("straight", "plain")}
    # the epoch after the first save against the same epoch without snapshots
    after_first = epoch_s["straight"][1] / epoch_s["plain"][1] - 1
    log(f"[snapshots] epoch s with orbax_dir {epoch_s['straight']}, without {epoch_s['plain']}: the epoch after the "
        f"first save {after_first * 100:+.1f}%; the set-up save in Snapshots.__init__ {setup_s * 1e3:.1f} ms "
        f"(before epoch 1), on {smi_line()}")
    report = {"kept": kept, "restored": restored, "save_blocked_ms": [b * 1e3 for b in blocked],
              "setup_ms": setup_s * 1e3, "epoch_after_first_save_rel": after_first,
              "sync_save_ms": sync_s * 1e3, "snapshot_bytes": nbytes, "epoch_s": epoch_s,
              "train_samples_per_s": {tag: [float(r["train_samples_per_sec"]) for r in runs[tag][3]]
                                      for tag in ("straight", "plain")},
              **{f"{tag}_launches": (r[1], r[2]) for tag, r in runs.items()}}
    del runs, straight
    torch.cuda.empty_cache()
    return report


def snapshot_rank(rank, directory):
    """(d) one of two ranks sharing cuda:0 in a gloo group at dp 1 × tp 2:
    a guided step at B=128 (so SGD's momentum exists), a snapshot through
    the port's snapshots, the digest of the rank's whole state."""
    from greedy_multimodal_learning_tpu_torch.engine.snapshots import Snapshots

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="env://", timeout=DP_GROUP_TIMEOUT)
    try:
        world = parallel.world_from_process_group(TP)
        trainer = dp_trainer(world, TP_SETUP)
        data = dp_batch(41, batch=BATCH)
        rows = world.rows(BATCH)
        mmtm_gating.launches = mmtm_gating_bwd.launches = 0
        trainer.train_batch({k: v[rows] for k, v in data.items()}, trainer.train_flips(BATCH // world.data_size, 2),
                            torch.tensor(True, device="cuda"))
        torch.cuda.synchronize()
        launches = (mmtm_gating.launches, mmtm_gating_bwd.launches)
        snapshots = Snapshots(directory, world=world)
        snapshots.save(1, trainer)
        snapshots.close()
        return {"digest": whole_digest(dp_state(trainer)), "launches": launches, "step": trainer.step,
                "sharded": len(tensor_parallel.sharded_weights(trainer.model)), "blocked_s": snapshots.blocked_s}
    finally:
        dist.destroy_process_group()


def snapshot_tp_check():
    """(d) a snapshot of dp 1 × tp 2 gloo ranks on cuda:0, restored into one
    process (tp 1): every tensor of the ranks' whole state, its rows from
    both ranks' blocks."""
    import torch.distributed.checkpoint as dcp
    from greedy_multimodal_learning_tpu_torch.engine.snapshots import Snapshots

    directory = os.path.join(TRAIN_RUNS, "snap_tp")
    ranks = run_ranks(snapshot_rank, TP, directory, timeout=DP_RUN_TIMEOUT)
    keys = set(dcp.FileSystemReader(os.path.join(directory, "1")).read_metadata().state_dict_metadata)
    blocks = sum("@rows" in k for k in keys)
    one = dp_trainer(None, TP_SETUP)
    epoch = Snapshots(directory).restore_latest(one)
    digest = whole_digest(dp_state(one))
    log(f"[snapshots tp] ranks: {[{k: r[k] for k in ('launches', 'step', 'sharded')} for r in ranks]}; {blocks} "
        f"row-block keys; restored at tp 1 (epoch {epoch}, step {one.step}): whole state equal to the ranks' "
        f"{digest == ranks[0]['digest'] == ranks[1]['digest']}")
    if not (digest == ranks[0]["digest"] == ranks[1]["digest"]) or blocks != 2 * 2 * TP_SHARDED or one.step != 1:
        raise AssertionError(f"tp snapshot: digests {[r['digest'][:12] for r in ranks]} vs {digest[:12]}, "
                             f"{blocks} row-block keys (want {4 * TP_SHARDED}), step {one.step}")
    for r in ranks:
        if r["launches"] != (3, 3) or r["sharded"] != TP_SHARDED:
            raise AssertionError(f"tp snapshot ranks: {ranks}")
    del one
    torch.cuda.empty_cache()
    return {"launches_per_rank": [r["launches"] for r in ranks], "row_block_keys": blocks}


def prng_phase():
    """Phase 15: the JAX package's random streams and ``orbax_dir`` on the
    card (2-D family at full width, 224², B=128, kernels): (a) the init of
    both families, (b) the flips and random decisions, (c) snapshots
    through ``train``, (d) a tp 2 snapshot restored at tp 1."""
    init = init_check()
    cpu_model, card_model = init.pop("models")
    draws = draws_check(cpu_model, card_model)
    del cpu_model, card_model
    torch.cuda.empty_cache()
    return {"init": init, "draws": draws, "train": snapshot_train_check(), "tp": snapshot_tp_check()}



# ---- phase 16 helpers ------------------------------------------------------------


NORTHSTAR = os.path.join(WORK, "northstar")  # the suites' corpora and runs: removed at exit
NS_EPOCHS = 3  # --epochs 3: two epochs run
NS_SEED, NS3D_SEED = 777, 7  # the first seed of each driver's default --seeds
NS_ARMS = ("guided", "random", "weakest")  # (a)
NS3D_ARMS = ("guided", "random", "weakest80", "adaptive")  # (b)
NS_PALLAS = "#MMTM_mitigate.use_pallas=True"  # (d): the driver's --bind
NS_TIMEOUT = 600  # seconds for the 3-D driver's process
NS3D_CHILD = "import sys, chip_smoke; chip_smoke.northstar3d_child(sys.argv[1])"


def jax_summary_keys(family):
    """The keys of the JAX package's run entries in the committed summary of
    ``family`` (``2d`` or ``3d``)."""
    name = {"2d": ("northstar", "northstar_summary.json"), "3d": ("northstar3d", "northstar3d_summary.json")}[family]
    with open(os.path.join(REPO, "results", *name)) as f:
        return set().union(*map(set, json.load(f).values()))


def check_suite(tag, workdir, summary, family, seed, arms):
    """Each arm's entry has the JAX summary's keys, finite values, two
    epochs run; every artifact of its runs is written; the summary file is
    the one returned."""
    keys = jax_summary_keys(family)
    if sorted(summary) != sorted(f"{kind}_s{seed}" for kind in arms):
        raise AssertionError(f"{tag}: summary entries {sorted(summary)}")
    for name, entry in summary.items():
        values = [v for k, v in entry.items() if k not in ("steps_to_90_top1", "val_weakest_counts")]
        if set(entry) != keys or not np.isfinite(values).all() or entry["epochs_run"] != NS_EPOCHS - 1:
            raise AssertionError(f"{tag} {name}: {entry}, want the keys {sorted(keys)}, finite, 2 epochs")
        run = os.path.join(workdir, name)
        for rel in ("history.csv", "history.pickle", "model_best_val.pt", "eval_history_batch/history.pickle",
                    "mmtm_off_eval/eval_history_batch/history.csv", "regime.json"):
            if not os.path.exists(os.path.join(run, rel)):
                raise AssertionError(f"{tag} {name}: {rel} was not written")
    summary_file = "northstar_summary.json" if family == "2d" else "northstar3d_summary.json"
    with open(os.path.join(workdir, summary_file)) as f:
        if json.load(f) != summary:
            raise AssertionError(f"{tag}: {summary_file} is not the returned summary")


def analyze(summary_path):
    """The port's ``experiments.analyze`` (numpy only) on a summary, as a
    subprocess; its output's line count."""
    r = subprocess.run([sys.executable, "-m", "greedy_multimodal_learning_tpu_torch.experiments.analyze",
                        summary_path], cwd=REPO, capture_output=True, text=True, timeout=120)
    if r.returncode != 0:
        raise AssertionError(f"analyze: rc {r.returncode}\n{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
    return len(r.stdout.splitlines())


def tf32_switches():
    """This process's TF32 switches of float32 convolutions and matmuls."""
    return {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}


def suite_matmul_precision(driver, workdir, seed):
    """``train.matmul_precision`` as each arm's train phase of ``driver``
    binds it (its config files and bindings; None when unbound)."""
    out = {}
    for kind in ("guided", "random"):
        _, config, bindings = driver.arm_phases(workdir, kind, seed, NS_EPOCHS, 50, "cuda")["train"]
        cfg.clear_config()
        try:
            cfg.parse_config_files_and_bindings(config.split("#"), bindings.replace("#", "\n"))
            out[kind] = cfg.query("train", "matmul_precision", None)
        finally:
            cfg.clear_config()
    return out


def northstar3d_child(workdir):
    """Phase 16 (b) and (c) in a process of their own, beside (a): the 3-D
    driver at its defaults (its phases in this process), then the guided
    run cut after epoch 1 (its train phase at ``n_epochs=2``, a checkpoint
    each epoch) and finished by the driver's resume path, whose history
    must be the straight run's; cuDNN deterministic.  Prints one JSON line
    last: the launches of each, the seconds, the summary."""
    from greedy_multimodal_learning_tpu_torch.experiments import northstar3d

    torch.backends.cudnn.deterministic = True
    out = {}
    mmtm_gating.launches = mmtm_gating_bwd.launches = 0
    t0 = time.time()
    northstar3d.main([workdir, "--epochs", str(NS_EPOCHS), "--seeds", str(NS3D_SEED), "--in-process",
                      "--arms", *NS3D_ARMS])
    torch.cuda.synchronize()
    with open(os.path.join(workdir, northstar3d.SUMMARY)) as f:
        out["3d"] = {"launches": [mmtm_gating.launches, mmtm_gating_bwd.launches], "wall_s": time.time() - t0,
                     "summary": json.load(f), "tf32": tf32_switches()}

    resumed = workdir + "_resumed"
    os.makedirs(resumed)
    os.symlink(os.path.join(workdir, "data"), os.path.join(resumed, "data"))
    mmtm_gating.launches = mmtm_gating_bwd.launches = 0
    t0 = time.time()
    run_entry("train", *northstar3d.arm_phases(resumed, "guided", NS3D_SEED, 2, 1, "cuda")["train"])
    run = f"guided_s{NS3D_SEED}"
    with open(os.path.join(resumed, run, "history.csv")) as f:
        cut = list(csv.DictReader(f))
    northstar3d.run_suite(resumed, epochs=NS_EPOCHS, seeds=[NS3D_SEED], arms=["guided"], checkpoint_every=1,
                          in_process=True, device="cuda")
    torch.cuda.synchronize()
    rows = {}
    for tag, root in (("straight", workdir), ("resumed", resumed)):
        with open(os.path.join(root, run, "history.csv")) as f:
            rows[tag] = list(csv.DictReader(f))
    out["resumed"] = {"launches": [mmtm_gating.launches, mmtm_gating_bwd.launches], "wall_s": time.time() - t0,
                      "cut_epochs": len(cut), "first_epoch_kept": rows["resumed"][0] == cut[0],
                      "history_equal": history_values(rows["resumed"]) == history_values(rows["straight"]),
                      "epochs": [len(rows["resumed"]), len(rows["straight"])]}
    print(json.dumps(out))


def northstar_phase():
    """Phase 16: the paper's run-level experiment on the card, both families
    (``experiments/``): (a) the 2-D driver in this process, seed 777, guided
    and random, ``--epochs 3`` over the generator's default corpus (1,200
    train and 400 test models, 12 views of 112², 40 classes); in a process
    of its own started first, beside (a) (:func:`northstar3d_child`): (b)
    the 3-D driver at its defaults (400 train-file and 150 test clips of 8
    frames of 32², width 0.5), seed 7, ``--epochs 3``, its phases in that
    process, and (c) its guided run cut after epoch 1 and finished by the
    driver's resume, against (b)'s straight run, cuDNN deterministic.
    The port's ``experiments.analyze`` reads both summaries."""
    from greedy_multimodal_learning_tpu_torch.experiments import northstar, northstar3d

    w2, w3, wp = (os.path.join(NORTHSTAR, name) for name in ("2d", "3d", "2d_pallas"))
    os.makedirs(NORTHSTAR, exist_ok=True)
    child_log = os.path.join(NORTHSTAR, "3d.log")
    t3 = time.time()
    with open(child_log, "w") as log_file:
        child = subprocess.Popen([sys.executable, "-c", NS3D_CHILD, w3], cwd=REPO, stdout=log_file,
                                 stderr=subprocess.STDOUT)
    try:
        # (a) the 2-D suite in this process, its corpus made by the driver
        mmtm_gating.launches = mmtm_gating_bwd.launches = 0
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            summary = northstar.run_suite(w2, epochs=NS_EPOCHS, seeds=[NS_SEED], arms=NS_ARMS, in_process=True,
                                          device="cuda")
        torch.cuda.synchronize()
        out = {"2d": {"launches": [mmtm_gating.launches, mmtm_gating_bwd.launches], "wall_s": time.time() - t0,
                      "summary": summary, "tf32": tf32_switches()}}
        check_suite("northstar 2-D", w2, summary, "2d", NS_SEED, NS_ARMS)

        # (d) the kernel path: the guided arm with the driver's --bind, over (a)'s corpus
        os.makedirs(wp)
        os.symlink(os.path.join(w2, "data"), os.path.join(wp, "data"))
        mmtm_gating.launches = mmtm_gating_bwd.launches = 0
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            northstar.main([wp, "--epochs", str(NS_EPOCHS), "--seeds", str(NS_SEED), "--arms", "guided",
                            "--in-process", "--bind", NS_PALLAS])
        torch.cuda.synchronize()
        launches = [mmtm_gating.launches, mmtm_gating_bwd.launches]
        with open(os.path.join(wp, northstar.SUMMARY)) as f:
            out["pallas"] = {"launches": launches, "wall_s": time.time() - t0, "summary": json.load(f)}
        check_suite("northstar 2-D kernel path", wp, out["pallas"]["summary"], "2d", NS_SEED, ["guided"])
        with open(os.path.join(wp, f"guided_s{NS_SEED}", "regime.json")) as f:
            regime = out["pallas"]["regime"] = json.load(f)
        if not (0 < regime["launches_fwd"] <= launches[0] and 0 < regime["launches_bwd"] == launches[1]
                and regime["bindings"][-1] == NS_PALLAS.lstrip("#")):
            raise AssertionError(f"northstar kernel path: regime {regime}, launches of the run {launches}")

        # (b) and (c): the child's last line
        rc = child.wait(timeout=max(NS_TIMEOUT - (time.time() - t3), 1))
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    with open(child_log) as f:
        lines = f.read()
    if rc != 0:
        raise AssertionError(f"northstar 3-D: rc {rc}\n{lines[-3000:]}")
    out.update(json.loads(lines.strip().splitlines()[-1]))
    out["child_s"] = time.time() - t3
    check_suite("northstar 3-D", w3, out["3d"]["summary"], "3d", NS3D_SEED, NS3D_ARMS)
    resumed = out["resumed"]
    if resumed["cut_epochs"] != 1 or not resumed["first_epoch_kept"] or not resumed["history_equal"]:
        raise AssertionError(f"northstar resume: the resumed history is not the straight run's: {resumed}")
    for key in ("2d", "3d", "resumed"):
        if out[key]["launches"] != [0, 0]:  # use_pallas stays the configs' False, as in the JAX runs
            raise AssertionError(f"northstar {key}: gating launches {out[key]['launches']}, want [0, 0]")
    out["analyze_lines"] = [analyze(os.path.join(w2, "northstar_summary.json")),
                            analyze(os.path.join(w3, "northstar3d_summary.json"))]
    out["matmul_precision"] = {"2d": suite_matmul_precision(northstar, w2, NS_SEED),
                               "3d": suite_matmul_precision(northstar3d, w3, NS3D_SEED)}
    for family in ("2d", "3d", "pallas"):
        entries = out[family]["summary"]
        log(f"[northstar {family}] {out[family]['wall_s']:.1f}s, launches {out[family]['launches']}: " + "; ".join(
            f"{name}: test_acc {e['test_acc']}, modal {[e[k] for k in sorted(e) if k.startswith('test_acc_modal')]}"
            f", flow-off {[e[k] for k in sorted(e) if k.startswith('flowoff_test_acc_modal')]}, epochs_run "
            f"{e['epochs_run']}" + (f", train samples/s {e['mean_train_samples_per_sec']:.1f}"
                                    if "mean_train_samples_per_sec" in e else "")
            for name, e in entries.items()) + f" | {smi_line()}")
    log(f"[northstar resume] 3-D guided s{NS3D_SEED} cut after epoch 1, resumed by the driver: history equal to the "
        f"straight run's (cuDNN deterministic), {resumed['wall_s']:.1f}s; the 3-D process {out['child_s']:.1f}s in "
        f"all; analyzers read both summaries ({out['analyze_lines']} lines)")
    log(f"[northstar pallas] the train process's regime.json: {json.dumps(out['pallas']['regime'])}")
    log("[northstar precision] " + "; ".join(
        f"{family} suite ({where}): train.matmul_precision {out['matmul_precision'][family]}, "
        + ", ".join(f"torch.backends.{k}={v}" for k, v in out[family]["tf32"].items())
        for family, where in (("2d", "this process"), ("3d", "its own process"))))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    t_start = time.time()
    os.makedirs(WORK, exist_ok=True)
    smi = smi_line()
    log(f"[card] {smi} | torch {torch.__version__} CUDA {torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    t0 = time.time()
    libs = kernel_build.build(["mmtm_gating", "mmtm_gating_bwd", "masked_batch_norm"])
    log(f"[build] {time.time() - t0:.1f}s: " + ", ".join(str(p.relative_to(REPO)) for p in libs.values()))
    for p in libs.values():
        log_path = p.with_suffix(".so.log")
        if log_path.exists():
            log("[build] ptxas: " + " | ".join(l.strip() for l in log_path.read_text().splitlines() if "Used" in l))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    seconds = {}

    def phase(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        seconds[name] = round(time.time() - t0, 1)
        log(f"[time] phase {name}: {seconds[name]}s")
        return out

    timing = phase("2 forward kernel", kernel_phase)
    try:
        serving = phase("3 serving", serving_phase)
    finally:
        shutil.rmtree(DATA, ignore_errors=True)
        if os.path.exists(CKPT):
            os.remove(CKPT)
    log("[serving] " + json.dumps(serving))
    bwd_timing = phase("4 backward kernel", backward_kernel_phase)
    batch_norm = phase("4b masked BatchNorm kernels", batch_norm_phase)
    try:
        training = phase("5 training", training_phase)
        log("[train] " + json.dumps(training))
        step_err = phase("6a step agreement", step_agreement)
        rates = phase("6b step throughput", throughput_phase)
        evaluation = phase("7 eval", eval_phase, os.path.join(TRAIN_RUNS, "f32"))
        log("[eval] " + json.dumps(evaluation))
        resumed = phase("8 resume", resume_phase)
        log("[resume] " + json.dumps(resumed))
        controllers = phase("9 controllers", controller_phase)
        log("[controllers] " + json.dumps(controllers))
        try:
            cached = phase("10 cached vs streamed", cache_phase)
            log("[cache] " + json.dumps(cached))
        finally:
            shutil.rmtree(CACHE_DATA, ignore_errors=True)
            shutil.rmtree(CACHE_RUNS, ignore_errors=True)
        try:
            clips = phase("11 3dcnn", clip_phase)
            log("[3dcnn] " + json.dumps(clips))
        finally:
            shutil.rmtree(CLIP_DATA, ignore_errors=True)
            shutil.rmtree(CLIP_RUNS, ignore_errors=True)
        # phase 5's split and runs, and phase 7's recording in its f32 run
        side = phase("12 side entries", side_phase, os.path.join(TRAIN_RUNS, "f32"))
        log("[side] " + json.dumps(side))
        dp = phase("13 data parallel", dp_phase, os.path.join(TRAIN_RUNS, "f32"))
        log("[dp] " + json.dumps(dp))
        tp = phase("14 tensor parallel", tp_phase, os.path.join(TRAIN_RUNS, "f32"))
        log("[tp] " + json.dumps(tp))
        snapshots = phase("15 random streams and snapshots", prng_phase)
        log("[prng] " + json.dumps(snapshots))
    finally:
        shutil.rmtree(TRAIN_DATA, ignore_errors=True)
        shutil.rmtree(TRAIN_RUNS, ignore_errors=True)
        shutil.rmtree(os.path.join(WORK, "trace"), ignore_errors=True)
        for name in ("resnet18-seeded.pt", "predict_fold_False", "predict_fold_True"):
            path = os.path.join(WORK, name)
            shutil.rmtree(path, ignore_errors=True) if os.path.isdir(path) else (
                os.remove(path) if os.path.exists(path) else None)
    try:
        experiment = phase("16 run-level experiment", northstar_phase)
    finally:
        shutil.rmtree(NORTHSTAR, ignore_errors=True)
    # the 3D family's runs (phase 11): its gating is eager, as in the JAX
    # package, so each of them launched neither kernel
    launches_3d = {direction: {f"launches_3dcnn_{k}": v[f"{direction}_launches"] for k, v in clips.items()
                               if isinstance(v, dict) and f"{direction}_launches" in v} for direction in ("fwd", "bwd")}

    # phase 12: the forward kernel 3 a batch on fold-BN serving and eval, 3·K
    # a batch in the sweep; both kernels on the remat, stem-s2d, pretrained
    # and profiled training; neither under SEonly or shareweight
    side_runs = {"remat": side["remat"]["remat"], "no_remat": side["remat"]["no_remat"],
                 "stem_s2d": side["stem"], **{k: side[k] for k in ("seonly", "shareweight", "pretrained",
                                                                                "profiled")}}
    side_launches = {
        "fwd": {"launches_fold_bn_predict": side["fold_predict"]["launches"],
                "launches_fold_bn_record": side["fold_record"]["launches"],
                "launches_sweep_k2": side["sweep"]["launches"],
                **{f"launches_{k}": v["fwd_launches"] for k, v in side_runs.items()}},
        "bwd": {f"launches_{k}": v["bwd_launches"] for k, v in side_runs.items()},
    }

    # phase 13: the DP config at world 1 and without data parallelism, each of
    # the two gloo ranks' guided steps, and each rank's recording pass
    dp_launches = {
        direction: {
            "launches_dp_world1": dp["world1"]["dp_world1"][f"{direction}_launches"],
            "launches_dp_plain": dp["world1"]["dp_plain"][f"{direction}_launches"],
            **{f"launches_dp_gloo_rank{r}": n[i] for r, n in enumerate(dp["gloo"]["launches_per_rank"])},
            **({f"launches_dp_record_rank{r}": n for r, n in enumerate(dp["record_launches_per_rank"])}
               if direction == "fwd" else {}),
        } for i, direction in enumerate(("fwd", "bwd"))
    }
    # phase 14: each tp 2 rank's three guided steps and its recording pass,
    # and each dp 2 x tp 2 rank's train entry
    tp_launches = {
        direction: {
            **{f"launches_tp_step_rank{r}": n[i] for r, n in enumerate(tp["steps"]["launches_per_rank"])},
            **{f"launches_tp_grid_rank{r}": n[i] for r, n in enumerate(tp["grid"]["launches_per_rank"])},
            **({f"launches_tp_record_rank{r}": n for r, n in enumerate(tp["record_launches_per_rank"])}
               if direction == "fwd" else {}),
        } for i, direction in enumerate(("fwd", "bwd"))
    }

    # phase 15: the snapshot runs through train, and each tp 2 rank's step
    snap_launches = {
        direction: {
            **{f"launches_snapshots_{k}": snapshots["train"][f"{k}_launches"][i]
               for k in ("straight", "plain", "resumed")},
            **{f"launches_snapshot_tp_rank{r}": n[i] for r, n in enumerate(snapshots["tp"]["launches_per_rank"])},
        } for i, direction in enumerate(("fwd", "bwd"))
    }

    # phase 16: the north-star suites (2-D in this process, 3-D in the driver's
    # own) and the resumed run, where use_pallas stays the configs' False, and
    # the kernel path (the 2-D guided arm with the driver's --bind)
    ns_launches = {direction: {f"launches_northstar_{k}": experiment[k]["launches"][i]
                               for k in ("2d", "3d", "resumed", "pallas")} for i, direction in enumerate(("fwd", "bwd"))}

    def bound_by(report):
        return "bytes" if all(s["bound_by"] == "bytes" for s in report["sites"].values()) else "operations"

    def cuda_launches_per_call(*reports):  # counted at every site, both dtypes
        return max(site["plan"]["cuda_launches"] for r in reports for site in r["sites"].values())

    f32, bf16 = timing[torch.float32], timing[torch.bfloat16]
    bf32, bbf16 = bwd_timing[torch.float32], bwd_timing[torch.bfloat16]
    kernels = [{
        "name": "mmtm_gating",
        "route": "cuda",
        "source": "greedy_multimodal_learning_tpu_torch/csrc/mmtm_gating.cu",
        "replaces": "greedy_multimodal_learning_tpu/ops/mmtm_pallas.py:47",
        "replaces_kernel": "_gating_kernel",
        "cuda_launches_per_call": cuda_launches_per_call(f32, bf16),
        # main path: the f32 training run (train steps and eval batches)
        "launches": training["f32"]["fwd_launches"],
        "launches_bf16": training["bf16"]["fwd_launches"],
        "launches_serving": serving["f32"]["launches"],
        "launches_serving_bf16": serving["bf16"]["launches"],
        # the eval path: the f32 recording pass, and the flow-off pass (no kernel)
        "launches_eval": evaluation["record_f32"]["launches"],
        "launches_eval_flow_off": evaluation["flow_off"]["launches"],
        # the other controllers (phase 9) and the cached/streamed runs (phase 10)
        **{f"launches_{k}": v["fwd_launches"] for k, v in controllers.items()},
        **{f"launches_{k}": v["fwd_launches"] for k, v in cached.items()},
        **launches_3d["fwd"],
        **side_launches["fwd"],
        **dp_launches["fwd"],
        **tp_launches["fwd"],
        **snap_launches["fwd"],
        **ns_launches["fwd"],
        "max_abs_err": f32["max_abs_err"],
        "max_abs_err_bf16": bf16["max_abs_err"],
        # float32, the configuration's dtype: one forward's three fusion sites at B=128
        "ms": f32["ms"],
        "kernel_ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
        "eager_ms": f32["eager_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": bound_by(f32),
        "library_ms": None,
        "bf16": {k: bf16[k] for k in ("ms", "plain_ms", "eager_ms", "bound_ms")},
        "sites": {str(dt)[6:]: t["sites"] for dt, t in timing.items()},
    }, {
        "name": "mmtm_gating_bwd",
        "route": "cuda",
        "source": "greedy_multimodal_learning_tpu_torch/csrc/mmtm_gating_bwd.cu",
        "replaces": "greedy_multimodal_learning_tpu/ops/mmtm_pallas.py:150",
        "replaces_kernel": "_gating_bwd_kernel",
        "cuda_launches_per_call": cuda_launches_per_call(bf32, bbf16),
        "launches": training["f32"]["bwd_launches"],
        "launches_bf16": training["bf16"]["bwd_launches"],
        **{f"launches_{k}": v["bwd_launches"] for k, v in controllers.items()},
        **{f"launches_{k}": v["bwd_launches"] for k, v in cached.items()},
        **launches_3d["bwd"],
        **side_launches["bwd"],
        **dp_launches["bwd"],
        **tp_launches["bwd"],
        **snap_launches["bwd"],
        **ns_launches["bwd"],
        "max_abs_err": bf32["max_abs_err"],
        "max_abs_err_bf16": bbf16["max_abs_err"],
        # float32: one step's three fusion sites at B=128
        "ms": bf32["ms"],
        "plain_ms": bf32["plain_ms"],
        "eager_autograd_ms": bf32["eager_autograd_ms"],
        "bound_ms": bf32["bound_ms"],
        "bound_by": bound_by(bf32),
        "library_ms": None,
        "bf16": {k: bbf16[k] for k in ("ms", "plain_ms", "eager_autograd_ms", "bound_ms")},
        "sites": {str(dt)[6:]: t["sites"] for dt, t in bwd_timing.items()},
    }, {
        "name": "masked_batch_norm",
        "route": "cuda",
        "source": "greedy_multimodal_learning_tpu_torch/csrc/masked_batch_norm.cu",
        "replaces": None,  # the JAX package's TorchBatchNorm is plain jnp ops (models/layers.py:83-120)
        "replaces_kernel": None,
        "cuda_launches_per_call": 1,  # forward and backward each, outside a data-parallel world (phase 4b)
        # forward calls (one a train-mode BatchNorm) of the main path: phase 5's f32 and bf16 runs, and a model
        # step of each family (phase 4b: 40 in 2-D, 60 in 3-D)
        "launches": training["f32"]["bn_launches"],
        "launches_bf16": training["bf16"]["bn_launches"],
        "backward_launches": training["f32"]["bn_bwd_launches"],
        **{f"launches_step_{f}": batch_norm[f]["calls_per_step"] for f in BN_SITES},
        **{f"model_gap_{f}": batch_norm[f]["model_gap"] for f in BN_SITES},
        # float32, the configurations' dtype: a step's every BatchNorm (both towers, 2-D), forward + backward
        **{k: batch_norm["2d"]["float32"]["step"][k] for k in ("ms", "fwd_ms", "bwd_ms", "plain_ms", "bound_ms",
                                                                "nine_pass_ms", "max_abs_err")},
        "bound_by": "bytes",
        "library_ms": None,
        "3d": batch_norm["3d"]["float32"]["step"],
        "bf16": {f: batch_norm[f]["bfloat16"]["step"] for f in BN_SITES},
        "sites": {f: {d: batch_norm[f][d]["sites"] for d in ("float32", "bfloat16")} for f in BN_SITES},
    }]
    log("[step] " + json.dumps({"l2_diff_over_update": step_err, "samples_per_s": rates}))
    log(f"[time] {time.time() - t_start:.1f}s in all; by phase {json.dumps(seconds)}")
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
