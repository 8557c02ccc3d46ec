#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nerf_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (``nvidia-smi``).
2. Builds the port's twelve CUDA kernels from ``nerf_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, started together) and prints the
   seconds it took and each kernel's registers, spills and ptxas C75xx
   notes (a ``wgmma`` serialized), labelled with the pass it runs
   (every kernel's MLP products run as 3xTF32 ``wgmma`` on the tensor
   cores, ``csrc/tc_mlp.cuh``, K5-bwd's and K8-bwd's inputs' cotangents
   too, with a float32 SIMT tile for encodings or features too wide for
   theirs, and K1-bwd's float32 SIMT passes where the encodings'
   cotangents are asked for).
3. Serving (slice 1): holds K1-fwd (``classic_mlp_fwd``, 262,144 points)
   and K4 (``union_eval``, the first 4000-ray tile of the frame) against
   their plain PyTorch versions, then renders one 400x400 frame of 64
   coarse + 128 fine samples through ``ClassicNeRF.render_image`` with the
   kernels (the launch counters are zeroed just before and must read 40
   each after, every call on the tensor cores) and once through the plain
   path, and compares the images.
4. Training (slice 2), the main path: a synthetic scene (8 views of
   64x64, on the card) and the full-width model trained through
   ``make_fused_multi_step_train_fn`` at 2048 rays x (64 + 128) samples,
   ``reuse_coarse_in_fine=True``, stratified jitter, density noise 1.0,
   Adam at lr 1e-4.  First one step's loss and gradients are held against
   the plain path (the same weights and draws through autograd); then
   warm-up steps, and timed steps with the counters zeroed just before:
   each step must launch one K1-fwd, one K1-bwd and one K3, each on the
   tensor cores, and nothing else.  Every loss must be finite, and the
   loss of a fixed probe batch (fixed draws) must be lower after the run
   than before.  Prints ms/step and rays/s.
5. Coarse-only training at 4096 rays x 64 samples: one K2 per step (on
   the tensor cores); prints ms/step and rays/s.
6. Holds K1-bwd, K2 and K3 against their plain versions on the inputs the
   trainer gave them (K1-bwd with random cotangents, as the reuse step
   calls it, on the tensor cores, and once with the encodings' cotangents,
   on the float32 SIMT passes), with their times and bounds.
7. Mip serving (slice 3): holds K7 (``mip_eval``) against its plain version
   on the first 4000-ray tile of the frame, then renders one 400x400 frame
   of 64 log-bbox fenceposts (63 intervals) through ``MipNeRF.render_image``
   with the kernels (the counters are zeroed just before and must read 40
   ``mip_eval`` and nothing else after, every call on the tensor cores)
   and once through the plain path, and compares the rgb and segmentation
   images; the segmentation output must satisfy logsumexp_c seg_c =
   log(acc + 63e-10) at every pixel.
8. Mip fused training, the main path: the full-width MipNeRF on a
   labelled synthetic scene through ``make_fused_multi_step_train_fn`` at
   4096 rays x 64 fenceposts, stratified jitter, density noise 1.0,
   segmentation weight 0.1, Adam at lr 1e-4.  One step's loss and
   gradients against the plain path, then warm-up and timed steps, each
   launching one K6 (``mip_train_grads``, on the tensor cores) and nothing
   else; every loss finite, the probe batch's loss lower after the run;
   ms/step and rays/s.
9. Mip general path: one ``make_train_step`` step of ``MipNeRF(use_pallas=
   True)`` launches one K5-fwd and one K5-bwd (both on the tensor cores),
   and its gradients match the ``use_pallas=False`` step's.
10. Holds K5-fwd (258,048 random feature rows), K5-bwd (the same rows,
   random cotangents; without the features' cotangent as the general path
   calls it, and with it) and K6 (the trainer's inputs, on the tensor
   cores) against their plain versions, with their times and bounds;
   prints the tile policy of the K5-fwd and K5-bwd calls, every one of
   which must have run the tensor cores.
11. K8 (slice 4), the MLP on raw points: one forward and backward of
   ``point_mlp.classic_pointmlp`` under autograd on the 262,144 raw points
   and directions of 4096 training rays x 64 stratified samples (the
   counters are zeroed just before and must read one K8-fwd and one
   K8-bwd after, both on the tensor cores); then K8-fwd and K8-bwd (with
   and without the raw inputs' cotangents) against their plain versions
   and K8-fwd against K1-fwd on the same encodings, with their times and
   bounds; prints the tile policy of the K8-fwd and K8-bwd calls, every
   one of which must have run the tensor cores.
12. K9 (slice 4), the whole reuse step in one call: one
   ``mega_train.mega_train_loss_and_grads`` step at 2048 rays x (64 +
   128) of the training phase's settings, held against ``mega_train_plain``
   (its own fine t-values held, and the plain resample's t-values against
   the kernel's) and against the reuse route
   (``reuse_train_loss_and_grads``); then 2 warm-up and 20 timed steps
   with ``torch.optim.Adam`` at lr 1e-4, the counters zeroed just before:
   each step must launch one ``mega_train`` (on the tensor cores) and
   nothing else; every loss finite, the probe batch's loss lower after the
   run; ms/step and rays/s beside the reuse step's of phase 4.  Then K9
   against its plain version with its time and bound.
13. Latent widths (slice 6): the full-width ClassicNeRF conditioned on
   2 + 1 latent scalars (``density_inputs=5, color_inputs=4``: encodings
   100 + 48, past the tensor-core tiles of K2, K3 and K4 at hidden 256).
   One 4000-ray tile of the frame through ``render_rays`` with per-image
   states (one K1-fwd and one K4, which must record the float32 SIMT
   tile), held against the plain path, and K4 against its plain version
   on its arguments; then one reuse step at 2048 x (64 + 128) (one
   K1-fwd, one K1-bwd and one K3, each recording the SIMT tile)
   and one coarse-only step at 4096 x 64 (one K2, the same) against the
   plain path.  Prints the policy each ran.  Then K8-fwd at x encodings
   120 + 36 and K5-fwd at 144 features (slice 10), each of which must run
   its float32 SIMT tile, against their plain versions.
14. The user's entry points (slice 11), in a temporary directory, each
   with the counters zeroed just before it and read just after, the
   counts derived from the code and checked exactly, every tensor-core
   kernel on the tile ``_build.tile_plan`` picks for its widths:
   a. ``cli.train_tiny_nerf.main`` at the notebook recipe (the synthetic
      scene at the CLI's defaults, 24 views of 100x100; full width,
      batch 1024, 64 samples, density noise 1.0, lr 1e-4, ``--use-pallas``)
      for 40 steps, a log, eval and checkpoint every 20: one K2 a step and
      the K1-fwd tiles of the two eval renders, nothing else; its files
      (``params.json``, ``checkpoint_20.npz``, ``checkpoint_40.npz``,
      ``nerf.pth``, a two-record ``metrics.jsonl``, ``psnrs.npy``); ms/step
      and rays/s from its metrics.
   b. ``--resume --num-steps 60`` in the same directory, under
      ``utils.profiling.trace``: it starts from step 40 (20 K2 launches,
      and K2's compositing kernel exactly 20 times in the trace file);
      a straight 60-step run in a fresh directory; the two final
      checkpoints' weights and Adam moments within atol 1e-6 (bitwise or
      not, printed); the time and size of one full-width
      ``save_checkpoint``.
   c. ``cli.render.main`` on ``checkpoint_60.npz``, 2 views of 100x100 at
      64 + 128 samples with ``--use-pallas``: K1-fwd and K4 once a tile,
      nothing else; each PNG within one 8-bit level of the plain path's
      on the card at every pixel whose fine samples both paths place
      alike (within 1e-4 in t; the others, where a near-empty coarse bin
      turns the rounding of the coarse weights into a shift of the fine
      samples, are counted and printed), and at every pixel of the 64
      coarse samples alone; the same call on the run's ``nerf.pth``
      writing the same PNGs; the CLI's time per view.
   d. ``cli.train_conditional.main`` for one epoch with ``--use-pallas``
      on a pickle written from a seed (4 synthetic views of 100x100, their
      6-DoF poses, states of width 2, so encodings 100 + 36): one K2 a
      step and the eval render's K1-fwd tiles, each on the tile
      ``tile_plan`` gives for that width; ``model.pth`` and the
      checkpoint written.
15. compute_dtype="bfloat16" (slice 12), the full-width model of phases
   3-4 with ``compute_dtype="bfloat16"``: one 400x400 frame at 64 + 128
   (the counters zeroed just before and read just after: 40 K1-fwd and
   40 K4, all ``tc_bf16``) against the plain bf16 frame (the same model
   with the five wrappers' plain versions, ``plain_versions``) in
   relative L2 and the float32 frame of phase 3 at the JAX package's bf16
   bound; one reuse step at 2048 x (64 + 128) and one coarse-only step at
   4096 x 64 against the plain bf16 step (loss, gradients in relative L2
   within 2e-2) and the float32 kernel step (cosine), then 2 warm-up and 20
   timed steps of each with the counters zeroed just before (one K1-fwd,
   K1-bwd and K3, or one K2, a step, all ``tc_bf16``), ms/step and rays/s
   beside phase 4's; K1-fwd, K4, K1-bwd, K2 and K3 against their plain
   bf16 versions on those paths' arguments (K1-bwd also the float32
   kernel on its inputs, which must fail the check), with their times
   and both bf16 bounds (FLOP at 989 TFLOP/s, bytes at 3.35 TB/s); one
   bf16 K2 at the latent width 100 + 36 on its SIMT ``fwd_store``
   (``simt_bf16``).
16. compute_dtype="bfloat16" for the mip family (slice 13), the full-width
   MipNeRF of phases 7-10 with ``compute_dtype="bfloat16"``: one 400x400
   frame at 64 fenceposts (the counters zeroed just before and read just
   after: 40 K7, all ``tc_bf16``) against the plain bf16 frame (the four
   mip wrappers' plain versions, ``plain_versions``) in relative L2 and
   the float32 frame of phase 7 at the JAX package's bf16 bound, with the
   seg/acc identity; one fused step at 4096 x 64 with the seg CE against
   the plain bf16 step (loss, gradients) and the float32 kernel step
   (cosine), then 2 warm-up and 20 timed steps (one K6 a step, all
   ``tc_bf16``), ms/step and rays/s beside phase 8's; one general-path
   step (one K5-fwd and one K5-bwd, ``tc_bf16``) against the plain bf16
   step; K7, K6, K5-fwd and K5-bwd (with and without the features'
   cotangent, which is bfloat16) against their plain bf16 versions on
   those paths' arguments, the float32 kernel on the same inputs beside
   each gradient check, with their times and both bf16 bounds; the head's
   rounding held directly against the float64 products of its rounded
   operands; K5-fwd at 144 features on its SIMT tile (``simt_bf16``).
17. compute_dtype="bfloat16" for K8-fwd, K8-bwd and K9 (slice 14): K8
   under autograd with ``compute_dtype="bfloat16"`` at phase 11's 262,144
   raw points (the counters zeroed just before and read just after: one
   K8-fwd and one K8-bwd, both ``tc_bf16``); K8-fwd and K8-bwd (on that
   step's cotangents, with and without the raw inputs' cotangents, which
   stay float32) against their plain bf16 versions, K8-bwd's scratch
   encodings bitwise the plain version's rounded ones; one K9 step of a
   bf16 model at 2048 x (64 + 128) (one ``mega_train``, ``tc_bf16``)
   against ``mega_train_plain`` in bf16 with its own fine t-values, its
   scratch encodings bitwise, its t-values against the plain bf16
   resample in probability, against phase 15's bf16 reuse route and the
   float32 K9 step (cosine); the float32 kernel on the same inputs beside
   each gradient check; 2 warm-up and 20 timed bf16 K9 steps with
   ``torch.optim.Adam`` (one ``mega_train`` each, all ``tc_bf16``), ms/step
   and rays/s beside phase 12's and phase 15's; K9's time against its
   plain bf16 version with both bf16 bounds; K8-fwd at x encodings 120 +
   36 on its SIMT tile (``simt_bf16``).
18. Data parallelism (slice 15), ``nerf_tpu_torch.parallel``:
   a. An NCCL group of one in this process (``parallel.initialize()``
      without a launcher's environment).  For the reuse (2048 x (64 +
      128)), coarse-only (4096 x 64) and mip (4096 x 64, seg 0.1) cells:
      22 steps with the gradients averaged over the mesh, every step's
      loss and gradients bitwise those of the same step without a mesh;
      then ``Trainer(mesh=...)`` for 2 warm-up and 20 timed steps with the
      counters zeroed just before (one K1-fwd, K1-bwd and K3; one K2; one
      K6 a step, all on the tensor cores), twice, between two runs of the
      plain ``Trainer()`` (the same counts), ms/step and rays/s beside
      them and phases 4, 5 and 8, and the gradient ``all_reduce`` and the
      whole average timed by CUDA events.  One 400x400 frame from
      ``render_image_sharded`` (all 160,000 rays in one ``render_rays``
      call: one K1-fwd for the coarse and one for the fine samples, as the
      JAX package renders a shard), its time and peak memory, against the
      plain render of the same rays within 1e-3.
   b. Two ranks spawned after the build, over gloo sharing the card: each
      half of one reuse and one mip step's global batch through the
      kernels, against the single-process kernel step on the same batch
      and draws (loss within rtol 1e-5, gradients within relative L2
      1e-4, the measured values printed); both ranks' losses and weights
      after 3 steps bitwise equal; the frame at two ranks within 1e-5 of
      (a)'s.
19. Prints the kernels' JSON line (each row with its float32 bound and
   its 3xTF32 tensor-core bound, ``bound_tc_ms``, the achieved share of
   each, ``products``: how its MLP products run, and since which slice,
   ``cli_launches``: its launches in phase 14, ``dp_launches``: in phase
   18a, and its bf16 entries from phases 15, 16 and 17, ``bf16_ms``,
   ``bf16_bound_ms``, ``bf16_launches`` and the rest), the card line,
   then, last, the device line.

The classic model is the full-width ClassicNeRF (hidden 256, 60 + 36
encoding widths, 638,468 parameters) with random weights from seed 0.  Its density
head is set to a small positive density everywhere (bias 0.5, weights
x 0.05): with the raw init about half the coarse intervals are empty, and
the fine sampler inverts a cdf with bins of 1e-5 mass, which turns a 1-ulp
difference of the coarse weights into a visible shift of the fine samples;
with mass in every bin the kernel path and the plain path agree to float32
rounding.  The mip model is the full-width MipNeRF (hidden 256, 96 IPE
features, 5 layers, 3 + 50 outputs, 304,438 parameters) with random
weights from seed 0.

Exits non-zero, with no result line, when there is no CUDA device or a
check fails.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch
import torch.distributed as dist

from nerf_tpu_torch import (
    ClassicNeRF,
    ClassicNeRFConfig,
    MipNeRF,
    MipNeRFConfig,
    RenderConfig,
    TrainConfig,
    parallel,
)
from nerf_tpu_torch.cli import render as render_cli
from nerf_tpu_torch.cli import train_conditional, train_tiny_nerf
from nerf_tpu_torch.data import RayBank, synthesize_scene
from nerf_tpu_torch.data.scenes import spherical_poses
from nerf_tpu_torch.ops import sampling
from nerf_tpu_torch.ops.cameras import pose_to_rays
from nerf_tpu_torch.ops.kernels import (
    _build,
    classic_mlp,
    fine_stage_train,
    mega_train,
    mip_mlp,
    mip_train,
    point_mlp,
    train_grads,
    union_eval,
)
from nerf_tpu_torch.parallel.mesh import flat_collective
from nerf_tpu_torch.testing import bf16_step_reference, mip_head_rounding, plain_versions
from nerf_tpu_torch.train import (
    Trainer,
    checkpoint,
    create_train_state,
    loop,
    make_fused_loss_and_grads,
    make_fused_multi_step_train_fn,
    make_loss_fn,
    make_train_step,
)
from nerf_tpu_torch.utils.profiling import (
    classic_flops_per_point,
    mip_flops_per_point,
    trace,
    train_step_flops,
)

# Published H100 SXM peaks (NVIDIA's data sheet): float32 outside the
# tensor cores, TF32 on the tensor cores, and HBM3 bandwidth.  The
# tensor-core bound of float32-accurate work is three TF32 products
# (3xTF32): FLOP / (495 / 3) TFLOP/s.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
IMAGE = 400
FOCAL = 555.0
RENDER = RenderConfig(
    num_coarse_samples=64, num_fine_samples=128, near=2.0, far=6.0,
    randomly_sample=False, density_noise_std=0.0, rays_per_tile=4000,
)
K1_POINTS = 262_144
# The training configurations (bench.py's hierarchical and coarse cells).
TRAIN_RENDER = RenderConfig(
    num_coarse_samples=64, num_fine_samples=128, near=2.0, far=6.0,
    randomly_sample=True, density_noise_std=1.0, reuse_coarse_in_fine=True,
)
TRAIN_RAYS = 2048
COARSE_RENDER = RenderConfig(
    num_coarse_samples=64, near=2.0, far=6.0, randomly_sample=True, density_noise_std=1.0,
)
COARSE_RAYS = 4096
LEARNING_RATE = 1e-4
WARMUP_STEPS, TIMED_STEPS = 2, 20
# The mip configurations (bench.py's mip cell with the segmentation CE on,
# as __graft_entry__.py trains it, and the mip serving frame).
MIP_RENDER = RenderConfig(num_coarse_samples=64, randomly_sample=False, density_noise_std=0.0,
                          rays_per_tile=4000)
MIP_TRAIN_RENDER = RenderConfig(num_coarse_samples=64, randomly_sample=True,
                                density_noise_std=1.0)
MIP_RAYS = 4096
SEG_WEIGHT = 0.1
K5_POINTS = MIP_RAYS * (MIP_TRAIN_RENDER.num_coarse_samples - 1)
# Stated tolerances.  K1: float32-accurate products (3xTF32 on the tensor
# cores, or float32 FMAs) summed in another order than cuBLAS's, through
# ten LayerNorm'd layers.  K4: the same MLP, then the
# transmittance summed in merged order where the plain version sums two
# blocks and the cross terms.  Frame: both paths' differences, plus the
# fine samples' sensitivity to the coarse weights' rounding.  Gradients
# (relative L2 error per tensor): at 10^5 rows some ReLU inputs lie
# within rounding of 0 and take the other branch in one of two float32
# evaluations, each moving its row's gradient.  Losses: sums of per-ray
# terms in another order.
# K5-fwd: float32-accurate products (3xTF32 on the tensor cores, or
# float32 FMAs past their tile) summed in another order than cuBLAS's,
# through five LayerNorm'd layers.  K7: the same, then the transmittance
# as the exponential of a prefix sum of logs where the plain version takes a
# cumulative product, and the class composite's max and exp-sum over the
# rows in another order.  Mip frame: both paths' differences; the
# segmentation images are log-probabilities, compared absolutely.  The
# seg/acc identity: a log-sum-exp of 50 float32 log-probabilities.
TOL = {
    "classic_mlp_fwd": dict(rtol=1e-4, atol=1e-4),
    "union_eval": dict(rtol=5e-4, atol=1e-4),
    "frame": dict(rtol=0.0, atol=1e-3),
    "mip_mlp_fwd": dict(rtol=1e-4, atol=1e-4),
    "mip_eval": dict(rtol=1e-4, atol=1e-4),
    "mip_frame": dict(rtol=0.0, atol=1e-3),
    "seg_identity": dict(rtol=0.0, atol=1e-4),
}
GRAD_REL_L2 = 1e-2
LOSS_RTOL = 1e-4
# K8: K1's tolerance (the same products; the encodings are the device's
# sines of the same arguments in both versions).  K9 against the reuse
# route: the JAX package's bound for its kernel against that route (loss
# rtol 1e-4, every gradient within 5e-3 of the largest entry): the
# fine samples move by a few ulp where the coarse weights are rounded
# otherwise, and the top encoding octave magnifies that.  K9's fine
# t-values against the plain resample, in probability: the plain cdf at
# the kernel's t-values equals the uniforms within 2e-5 beyond the mass
# that 4 ulp of t carry (the two versions' coarse weights differ by float32
# rounding, about 1e-6 of the mass, and a bin holding less than the 1e-5
# floor of mass is read as flat).  In t a sample in a nearly empty bin
# moves by that rounding over the bin's mass, so t is only reported: its
# share beyond 1e-4.
TOL["classic_pointmlp_fwd"] = TOL["classic_mlp_fwd"]
MEGA_VS_REUSE = dict(loss_rtol=1e-4, grad_of_max=5e-3)
T_FINE_MASS, T_FINE_ATOL = 2e-5, 1e-4
K8_RAYS, K8_SAMPLES = 4096, 64
# Slice 6: the latent-conditioned model (2 + 1 latent scalars: encodings
# 100 + 48), too wide for the tensor-core tiles at hidden 256.
LATENT = dict(density_inputs=5, color_inputs=4)
SOURCES = {
    "classic_mlp_fwd": ("nerf_tpu_torch/csrc/classic_mlp_fwd.cu",
                        "nerf_tpu/ops/pallas/fused_mlp.py:608"),
    "union_eval": ("nerf_tpu_torch/csrc/union_eval.cu",
                   "nerf_tpu/ops/pallas/fused_hier.py:635"),
    "classic_mlp_bwd": ("nerf_tpu_torch/csrc/classic_mlp_bwd.cu",
                        "nerf_tpu/ops/pallas/fused_mlp.py:673"),
    "train_grads": ("nerf_tpu_torch/csrc/train_grads.cu",
                    "nerf_tpu/ops/pallas/fused_train.py:524"),
    "fine_stage_train": ("nerf_tpu_torch/csrc/fine_stage_train.cu",
                         "nerf_tpu/ops/pallas/fused_hier.py:769"),
    "mip_mlp_fwd": ("nerf_tpu_torch/csrc/mip_mlp_fwd.cu",
                    "nerf_tpu/ops/pallas/fused_mip_mlp.py:207"),
    "mip_mlp_bwd": ("nerf_tpu_torch/csrc/mip_mlp_bwd.cu",
                    "nerf_tpu/ops/pallas/fused_mip_mlp.py:244"),
    "mip_eval": ("nerf_tpu_torch/csrc/mip_eval.cu",
                 "nerf_tpu/ops/pallas/fused_mip_train.py:515"),
    "mip_train_grads": ("nerf_tpu_torch/csrc/mip_train_grads.cu",
                        "nerf_tpu/ops/pallas/fused_mip_train.py:366"),
    "classic_pointmlp_fwd": ("nerf_tpu_torch/csrc/classic_pointmlp_fwd.cu",
                             "nerf_tpu/ops/pallas/fused_mlp.py:608"),
    "classic_pointmlp_bwd": ("nerf_tpu_torch/csrc/classic_pointmlp_bwd.cu",
                             "nerf_tpu/ops/pallas/fused_mlp.py:673"),
    "mega_train": ("nerf_tpu_torch/csrc/mega_train.cu",
                   "nerf_tpu/ops/pallas/fused_mega.py:765"),
}

# How each kernel's MLP products run, and since which slice of the port.
BF16_PRODUCTS = "; bf16 wgmma in compute_dtype bfloat16 (slice 12)"
MIP_BF16_PRODUCTS = "; bf16 wgmma in compute_dtype bfloat16 (slice 13)"
POINT_MEGA_BF16_PRODUCTS = "; bf16 wgmma in compute_dtype bfloat16 (slice 14)"
PRODUCTS = {
    "classic_mlp_fwd": "3xTF32 (slice 7)" + BF16_PRODUCTS,
    "union_eval": "3xTF32 (slice 5)" + BF16_PRODUCTS,
    "classic_mlp_bwd": "3xTF32 (slice 7); float32 SIMT with the encodings' cotangents"
    + BF16_PRODUCTS,
    "train_grads": "3xTF32 (slice 6)" + BF16_PRODUCTS,
    "fine_stage_train": "3xTF32 (slice 6)" + BF16_PRODUCTS,
    "mip_mlp_fwd": "3xTF32 (slice 10)" + MIP_BF16_PRODUCTS,
    "mip_mlp_bwd": "3xTF32 (slice 9)" + MIP_BF16_PRODUCTS,
    "mip_eval": "3xTF32 (slice 8)" + MIP_BF16_PRODUCTS,
    "mip_train_grads": "3xTF32 (slice 8)" + MIP_BF16_PRODUCTS,
    "classic_pointmlp_fwd": "3xTF32 (slice 10)" + POINT_MEGA_BF16_PRODUCTS,
    "classic_pointmlp_bwd": "3xTF32 (slice 9)" + POINT_MEGA_BF16_PRODUCTS,
    "mega_train": "3xTF32 (slice 5)" + POINT_MEGA_BF16_PRODUCTS,
}


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    print(("ok    " if ok else "FAIL  ") + what, flush=True)
    if not ok:
        raise CheckFailed(what)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def kernel_label(mangled: str) -> str:
    """A mangled kernel name's last identifier and its int and bool template
    arguments (types left out): ``_ZN8nerf_mlp15bwd_rows_kernelILi256EE...`` ->
    ``bwd_rows_kernel<256>``, ``...wgrad_tc_kernelILb1EE...`` ->
    ``wgrad_tc_kernel<true>`` (a kernel's last bool is kBf16; the SIMT mip
    tile's first is kSave)."""
    i, parts = mangled.find("N") + 1, []
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        parts.append(mangled[j:j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
    label = parts[-1] if parts else mangled
    end = mangled.find("Ev", i)  # the template arguments end before the void return
    values = [("true" if v == "1" else "false") if t == "b" else v
              for t, v in re.findall(r"L([ib])(\d+)E", mangled[i:end if end >= 0 else None])]
    return f"{label}<{', '.join(values)}>" if values else label


# The passes of the MLP kernels by kernel name, for reports and profiles:
# every kernel's products run on the tensor cores (csrc/tc_mlp.cuh; their
# float32 SIMT fwd_store, K1-fwd, K8-fwd, K4 and mip forward tiles serve
# encodings or features too wide for it, and K1-bwd's SIMT passes the
# encodings' cotangents).
PASSES = {
    "fwd_tc_kernel": "K1-fwd / K8-fwd tile, 3xTF32 (bf16 if <..., true>) wgmma",
    "fwd_simt_kernel":
        "K1-fwd / K8-fwd tile, fp32 SIMT (wide encodings; bf16 operands if <..., true>)",
    "fwd_store_tc_kernel": "fwd_store, 3xTF32 (bf16 if <..., true>) wgmma",
    "bwd_rows_tc_kernel": "bwd_rows, 3xTF32 (bf16 if <..., true>) wgmma",
    "wgrad_tc_kernel": "wgrad, 3xTF32 (bf16 if <true>) wgmma",
    "union_eval_kernel": "K4 tile, 3xTF32 (bf16 if <..., true>) wgmma MLP + compositing",
    "union_eval_simt_kernel":
        "K4 tile, fp32 SIMT MLP (wide encodings; bf16 operands if <..., true>) + compositing",
    "fwd_store_kernel": "fwd_store, fp32 SIMT (bf16 operands if <..., true>)",
    "bwd_rows_kernel": "bwd_rows, fp32 SIMT",
    "wgrad_kernel": "wgrad, fp32 SIMT",
    "colsum_kernel": "colsum",
    "mip_fwd_store_tc_kernel": "mip fwd_store (K5-bwd, K6), 3xTF32 (bf16 if <..., true>) wgmma",
    "mip_fwd_tc_kernel": "mip forward tile (K5-fwd, K7), 3xTF32 (bf16 if <..., true>) wgmma",
    "mip_bwd_rows_tc_kernel": "mip bwd_rows (K5-bwd, K6), 3xTF32 (bf16 if <..., true>) wgmma",
    "mip_fwd_kernel":
        "mip forward tile, fp32 SIMT (wide features; bf16 operands if <H, kSave, true>)",
    "encode_bwd_kernel": "K8-bwd chain rule to the raw inputs, fp32",
    "mip_objective_kernel": "K6 compositing and losses",
    "mip_eval_rays_kernel": "K7 compositing",
}


def pass_label(kernel: str) -> str:
    """The pass a kernel name (mangled, demangled or a label) runs, or ''."""
    for key, label in PASSES.items():
        if re.search(rf"\b{key}\b|\d{key}[IE]", kernel):
            return label
    return ""


def ptxas_usage(report: str):
    """(kernel, 'registers; spills') pairs from an ``nvcc -Xptxas -v`` report,
    and (kernel, the note) for each C75xx performance note (a ``wgmma``
    serialized)."""
    label, spills = "?", ""
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        note = re.search(r"\b(C75\d\d)\b.*", line)
        if entry:
            label = kernel_label(entry.group(1))
            if pass_label(label):
                label += f" [{pass_label(label)}]"
        elif note:
            func = re.search(r"function '(\w+)'", line)
            yield (kernel_label(func.group(1)) if func else label), \
                "(" + note.group(0).split(" in the function")[0]
        elif "spill" in line:
            spills = line.strip()
        elif re.search(r"Used \d+ registers", line):
            yield label, f"{line.split(':', 1)[-1].strip()}; {spills}"


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call, from CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(flops: float, nbytes: float) -> tuple:
    """(bound_ms, bound_by, bound_tc_ms): the larger of operations over the
    fp32 peak and bytes over the memory rate; and the same with the
    operations at the 3xTF32 tensor-core rate."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    t_tc = max(flops / PEAK_3XTF32_FLOPS * 1e3, t_bytes)
    return ((t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")) + (t_tc,)


def compare(name: str, got, ref) -> float:
    tol = TOL[name]
    max_abs = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    max_rel = max(float(((g - r).abs() / r.abs().clamp_min(1e-6)).max()) for g, r in zip(got, ref))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    close = all(torch.allclose(g, r, **tol) for g, r in zip(got, ref))
    print(f"{name}: max abs err {max_abs:.3e}, max rel err {max_rel:.3e}, "
          f"tolerance rtol={tol['rtol']} atol={tol['atol']}")
    check(finite and close, f"{name} matches its plain version")
    return max_abs


def compare_grads(name: str, got: dict, ref: dict, loss=None, ref_loss=None) -> float:
    """Gradients by relative L2 error per tensor (GRAD_REL_L2), the loss by
    LOSS_RTOL; returns the largest absolute difference of them all."""
    check(got.keys() == ref.keys(), f"{name}: the same gradients as its plain version")
    rel = {k: float((got[k] - ref[k]).norm() / ref[k].norm().clamp_min(1e-30)) for k in ref}
    max_abs = max(float((got[k] - ref[k]).abs().max()) for k in ref)
    worst = max(rel, key=rel.get)
    finite = all(bool(torch.isfinite(g).all()) for g in got.values())
    print(f"{name}: gradients max abs err {max_abs:.3e}, worst relative L2 err "
          f"{rel[worst]:.3e} ({worst}), tolerance {GRAD_REL_L2}")
    ok = finite and rel[worst] <= GRAD_REL_L2
    if loss is not None:
        loss_err = abs(float(loss) - float(ref_loss))
        max_abs = max(max_abs, loss_err)
        print(f"{name}: loss {float(loss):.7g} vs plain {float(ref_loss):.7g} "
              f"(rel err {loss_err / abs(float(ref_loss)):.3e}, tolerance {LOSS_RTOL})")
        ok = ok and loss_err <= LOSS_RTOL * abs(float(ref_loss))
    check(ok, f"{name} matches its plain version")
    return max_abs


@contextlib.contextmanager
def recording_results(module, fn_name: str, results: list):
    """Append the result of every call of ``module.fn_name`` to ``results``."""
    original = getattr(module, fn_name)

    def recording(*args, **kwargs):
        results.append(original(*args, **kwargs))
        return results[-1]

    setattr(module, fn_name, recording)
    try:
        yield
    finally:
        setattr(module, fn_name, original)


@contextlib.contextmanager
def capture_args(module, fn_name: str, store: dict):
    """Record the arguments of the first call of ``module.fn_name``."""
    original = getattr(module, fn_name)

    def recording(*args, **kwargs):
        store.setdefault(fn_name, (args, kwargs))
        return original(*args, **kwargs)

    setattr(module, fn_name, recording)
    try:
        yield
    finally:
        setattr(module, fn_name, original)


def make_model(use_pallas: bool, device, **cfg_kwargs) -> ClassicNeRF:
    cfg = ClassicNeRFConfig(normalize_position=6.0, use_pallas=use_pallas, **cfg_kwargs)
    model = ClassicNeRF(cfg, generator=torch.Generator().manual_seed(0), device=device)
    with torch.no_grad():
        model.mlp.density.bias.fill_(0.5)
        model.mlp.density.weight.mul_(0.05)
    return model


def make_mip_model(use_pallas: bool, device, **cfg_kwargs) -> MipNeRF:
    cfg = MipNeRFConfig(use_pallas=use_pallas, **cfg_kwargs)
    return MipNeRF(cfg, generator=torch.Generator().manual_seed(0), device=device)


def check_policies(what: str, launches: dict, policies: dict, policy: str) -> None:
    """Every launch of a tensor-core kernel among ``launches`` ran the
    ``policy`` tile: ``policies`` is ``_build.policy_counts`` read with
    ``launches`` (both zeroed together before the run)."""
    print(f"{what}: tile policies {policies}", flush=True)
    check(policies == {(k, policy): n for k, n in launches.items() if k in _build.PLANNED},
          f"{what}: every tensor-core kernel ran its {policy} tile")


def kernel_row(name, launches, max_abs, ms, plain_ms, flops, nbytes) -> dict:
    bound_ms, bound_by, bound_tc_ms = bound(flops, nbytes)
    print(f"{name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
          f"({bound_by}; {bound_ms / ms:.3f} of it), 3xTF32 tensor-core bound {bound_tc_ms:.3f} ms "
          f"({bound_tc_ms / ms:.3f} of it), {flops / ms / 1e9:.2f} TFLOP/s achieved, "
          f"{launches} launches")
    source, replaces = SOURCES[name]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "bound_tc_ms": bound_tc_ms, "share_of_bound": bound_ms / ms,
        "share_of_bound_tc": bound_tc_ms / ms, "products": PRODUCTS[name],
    }


def serving(device, flops_per_point: int) -> dict:
    """Phase 3: K1-fwd and K4 against their plain versions, then the frame.
    Returns the two kernels' rows."""
    model = make_model(True, device).eval().requires_grad_(False)
    plain_model = make_model(False, device).eval().requires_grad_(False)
    cfg = model.cfg
    packed = classic_mlp.pack_classic_params(model.mlp)
    weight_bytes = tensor_bytes(*packed.values())
    pose_o, pose_r = spherical_poses(1, radius=4.0, device=device)

    gen = torch.Generator(device=device).manual_seed(1)
    x_enc = torch.rand((K1_POINTS, cfg.x_encoding_dim), generator=gen, device=device) * 2 - 1
    d_enc = torch.rand((K1_POINTS, cfg.d_encoding_dim), generator=gen, device=device) * 2 - 1
    with torch.no_grad():
        _build.policy_counts.clear()
        got = classic_mlp.classic_mlp_fwd(packed, x_enc, d_enc)
        ref = classic_mlp.classic_mlp_fwd_plain(packed, x_enc, d_enc)
        torch.cuda.synchronize()
        check(dict(_build.policy_counts) == {("classic_mlp_fwd", "tc"): 1},
              "K1-fwd at 60 + 36 ran its tensor-core tile")
        err = compare("classic_mlp_fwd", [got], [ref])
        ms = cuda_ms(lambda: classic_mlp.classic_mlp_fwd(packed, x_enc, d_enc), iters=10)
        plain_ms = cuda_ms(lambda: classic_mlp.classic_mlp_fwd_plain(packed, x_enc, d_enc), iters=10)
    k1 = dict(max_abs=err, ms=ms, plain_ms=plain_ms, flops=K1_POINTS * flops_per_point,
              nbytes=tensor_bytes(x_enc, d_enc, got) + weight_bytes)

    store = {}
    rays_o, rays_d = (r.reshape(-1, 3)[: RENDER.rays_per_tile] for r in
                      pose_to_rays(pose_o, pose_r, IMAGE, IMAGE, FOCAL))
    with torch.no_grad(), capture_args(union_eval, "union_eval", store):
        model.render_rays(rays_o, rays_d, RENDER, fused_eval=True)
    args = store["union_eval"][0]
    with torch.no_grad():
        got = union_eval.union_eval(*args)
        ref = union_eval.union_eval_plain(*args)
        torch.cuda.synchronize()
        err = compare("union_eval", got, ref)
        ms = cuda_ms(lambda: union_eval.union_eval(*args), iters=5)
        plain_ms = cuda_ms(lambda: union_eval.union_eval_plain(*args), iters=5)
    _, x_f, d_ray, t_c, t_f, dens_c, col_c, dnorm = args
    k4 = dict(max_abs=err, ms=ms, plain_ms=plain_ms, flops=t_f.numel() * flops_per_point,
              nbytes=tensor_bytes(x_f, d_ray, t_c, t_f, dens_c, col_c, dnorm, *got)
              + weight_bytes)

    n_tiles = -(-IMAGE * IMAGE // RENDER.rays_per_tile)

    def render(m):
        return m.render_image(pose_o, pose_r, IMAGE, IMAGE, FOCAL, RENDER)

    render(model)  # warm-up
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    _build.policy_counts.clear()
    t0 = time.perf_counter()
    image = render(model)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3
    launches, policies = dict(_build.launch_counts), dict(_build.policy_counts)
    print(f"frame through the kernels: {frame_ms:.1f} ms; launches {launches}", flush=True)
    check(launches == {"classic_mlp_fwd": n_tiles, "union_eval": n_tiles},
          f"K1-fwd and K4 launched once per tile ({n_tiles} tiles), nothing else")
    check_policies("frame", launches, policies, "tc")

    render(plain_model)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_image = render(plain_model)
    torch.cuda.synchronize()
    plain_frame_ms = (time.perf_counter() - t0) * 1e3
    print(f"frame through the plain path: {plain_frame_ms:.1f} ms", flush=True)
    check(image.shape == (1, IMAGE, IMAGE, 3), f"image shape {tuple(image.shape)}")
    check(bool(torch.isfinite(image).all()), "image is finite")
    check(float(image.min()) >= -1e-5 and float(image.max()) <= 1.0 + 1e-5,
          f"pixels in [0, 1] (min {float(image.min()):.4f}, max {float(image.max()):.4f})")
    check(float(image.std()) > 1e-3, f"image is not flat (std {float(image.std()):.4f})")
    pixel_err = compare("frame", [image], [plain_image])
    print(f"frame: {frame_ms:.1f} ms through the kernels, {plain_frame_ms:.1f} ms plain, "
          f"max pixel difference {pixel_err:.3e}")
    rows = {"classic_mlp_fwd": (launches["classic_mlp_fwd"], k1),
            "union_eval": (launches["union_eval"], k4)}
    return rows, image, frame_ms


def train_run(name, render, n_rays, bank, device, expected: dict, store: dict,
              policy: str = "tc", **cfg_kwargs):
    """Warm-up then timed fused steps; the counters are zeroed just before
    the timed steps.  The loss of one fixed probe batch (fixed draws) is
    taken before and after the run.  The first call of each wrapper in the
    warm-up has its arguments recorded in ``store``.  Every launch must run
    the ``policy`` tile.  Returns (launches, ms per step)."""
    model = make_model(True, device, **cfg_kwargs)
    state = create_train_state(model, LEARNING_RATE, seed=0)
    gen = torch.Generator(device=device).manual_seed(99)
    probe = (bank.sample_batch(gen, n_rays), sampling.draw_step(gen, render, n_rays, device))
    probe_loss = make_fused_loss_and_grads(model, render)
    loss_before = float(probe_loss(*probe)[0])
    warm = make_fused_multi_step_train_fn(model, render, bank, n_rays, WARMUP_STEPS)
    timed = make_fused_multi_step_train_fn(model, render, bank, n_rays, TIMED_STEPS)
    with contextlib.ExitStack() as stack:
        for module, fn in ((classic_mlp, "classic_mlp_bwd"), (train_grads, "classic_train_grads"),
                           (fine_stage_train, "fine_stage_train")):
            stack.enter_context(capture_args(module, fn, store))
        state, aux_w = warm(state)
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    _build.policy_counts.clear()
    t0 = time.perf_counter()
    state, aux = timed(state)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    launches, policies = dict(_build.launch_counts), dict(_build.policy_counts)
    loss_after = float(probe_loss(*probe)[0])
    losses = torch.cat([aux_w["loss"], aux["loss"]]).cpu()
    print(f"{name}: {ms:.2f} ms/step, {n_rays / ms * 1e3:.0f} rays/s over {TIMED_STEPS} steps; "
          f"launches {launches}; step losses {[round(float(v), 5) for v in losses]}", flush=True)
    check(launches == {k: v * TIMED_STEPS for k, v in expected.items()},
          f"{name}: each step launched {expected} and nothing else")
    check_policies(name, launches, policies, policy)
    check(bool(torch.isfinite(losses).all()), f"{name}: every loss is finite")
    check(loss_after < loss_before,
          f"{name}: the probe batch's loss fell from {loss_before:.6f} to {loss_after:.6f} "
          f"over {WARMUP_STEPS + TIMED_STEPS} steps")
    return launches, ms


def training(device, cfg: ClassicNeRFConfig):
    """Phases 4-6.  Returns the three training kernels' rows, the ray bank
    and the reuse step's ms/step."""
    t0 = time.perf_counter()
    scene = synthesize_scene(num_views=8, image_hw=64, focal=80.0, device=device)
    bank = RayBank.from_images(scene.images, scene.pose_o, scene.pose_r, scene.focal)
    torch.cuda.synchronize()
    print(f"synthetic scene: {tuple(scene.images.shape)} on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # One step of the main path against the plain path: same weights, same
    # draws, plain model through autograd.
    gen = torch.Generator(device=device).manual_seed(7)
    batch = bank.sample_batch(gen, TRAIN_RAYS)
    draws = sampling.draw_step(gen, TRAIN_RENDER, TRAIN_RAYS, device)
    loss, grads, _ = make_fused_loss_and_grads(make_model(True, device), TRAIN_RENDER)(batch, draws)
    plain = make_model(False, device)
    with torch.enable_grad():
        ref_loss, _ = make_loss_fn(plain, TRAIN_RENDER)(batch, draws)
    names, params = zip(*plain.named_parameters())
    ref = dict(zip(names, torch.autograd.grad(ref_loss, params)))
    compare_grads("reuse step", grads, ref, loss, ref_loss.detach())

    store = {}
    reuse_launches, reuse_ms = train_run(
        "train 2048x(64+128) reuse", TRAIN_RENDER, TRAIN_RAYS, bank, device,
        {"classic_mlp_fwd": 1, "classic_mlp_bwd": 1, "fine_stage_train": 1}, store)
    coarse_launches, coarse_ms = train_run(
        "train 4096x64 coarse-only", COARSE_RENDER, COARSE_RAYS, bank, device,
        {"train_grads": 1}, store)

    # Phase 6: the training kernels against their plain versions on the
    # inputs the trainer gave them (outside autograd: the recorded weights
    # require grad).
    with torch.no_grad():
        rows = kernels_against_plain(store, cfg, device)
    rows["classic_mlp_bwd"] = (reuse_launches["classic_mlp_bwd"], rows["classic_mlp_bwd"])
    rows["train_grads"] = (coarse_launches["train_grads"], rows["train_grads"])
    rows["fine_stage_train"] = (reuse_launches["fine_stage_train"], rows["fine_stage_train"])
    print(f"training: reuse 2048x(64+128) {reuse_ms:.2f} ms/step = "
          f"{TRAIN_RAYS / reuse_ms * 1e3:.0f} rays/s; coarse-only 4096x64 {coarse_ms:.2f} ms/step "
          f"= {COARSE_RAYS / coarse_ms * 1e3:.0f} rays/s")
    return rows, bank, {"reuse": reuse_ms, "coarse": coarse_ms}


def without_images(kwargs: dict) -> dict:
    """A recorded call's keyword arguments without the operand images the
    step built beforehand: the call is repeated with its own."""
    return {k: v for k, v in kwargs.items() if k not in ("tc_fwd", "tc_bwd")}


def kernels_against_plain(store: dict, cfg: ClassicNeRFConfig, device) -> dict:
    """Phase 6: K1-bwd, K2 and K3 against their plain versions on the
    recorded arguments, with their times; returns their rows' numbers."""
    rows = {}
    # K1-bwd as the reuse step calls it (no encoding cotangents: the
    # encodings need no gradient; on the tensor cores), with random
    # cotangents; then once with the encodings' cotangents (the float32
    # SIMT passes).  Each call builds its own operand images, as the step's
    # were built for the weights of its own step.
    args, kwargs = store["classic_mlp_bwd"]
    check(without_images(kwargs) == {"input_grads": False},
          "the reuse step asks K1-bwd for no encoding cotangents")
    packed, x, d, _ = args
    weight_bytes = tensor_bytes(*packed.values())
    gen = torch.Generator(device=device).manual_seed(8)
    g_out = torch.rand((x.shape[0], 4), generator=gen, device=device) * 2 - 1
    named = lambda r: {"dx": r[0], "dd": r[1], **r[2]} if r[0] is not None else r[2]  # noqa: E731
    ms = {}
    for input_grads, policy in ((True, "simt"), (False, "tc")):
        _build.policy_counts.clear()
        got = classic_mlp.classic_mlp_bwd(packed, x, d, g_out, input_grads)
        torch.cuda.synchronize()
        check(dict(_build.policy_counts) == {("classic_mlp_bwd", policy): 1},
              f"classic_mlp_bwd with input_grads={input_grads} ran its {policy} passes")
        ref = classic_mlp.classic_mlp_bwd_plain(packed, x, d, g_out, input_grads)
        err = compare_grads("classic_mlp_bwd", named(got), named(ref))
        ms[input_grads] = cuda_ms(
            lambda: classic_mlp.classic_mlp_bwd(packed, x, d, g_out, input_grads), iters=5)
        print(f"classic_mlp_bwd at {x.shape[0]} points, input_grads={input_grads} ({policy}): "
              f"{ms[input_grads]:.3f} ms")
    plain_ms = cuda_ms(
        lambda: classic_mlp.classic_mlp_bwd_plain(packed, x, d, g_out, False), iters=3)
    rows["classic_mlp_bwd"] = dict(
        max_abs=err, ms=ms[False], plain_ms=plain_ms,
        flops=train_step_flops(cfg, x.shape[0], 1),
        nbytes=tensor_bytes(x, d, g_out, *got[:2]) + 2 * weight_bytes)

    args, kwargs = store["classic_train_grads"]
    got = train_grads.classic_train_grads(*args, **kwargs)
    ref = train_grads.classic_train_grads_plain(*args, **kwargs)
    err = compare_grads("train_grads", got[1], ref[1], got[0], ref[0])
    ms = cuda_ms(lambda: train_grads.classic_train_grads(*args, **kwargs), iters=5)
    plain_ms = cuda_ms(lambda: train_grads.classic_train_grads_plain(*args, **kwargs), iters=3)
    x = args[1]
    print(f"train_grads at {x.shape[0]} rays x {x.shape[1]} samples")
    rows["train_grads"] = dict(
        max_abs=err, ms=ms, plain_ms=plain_ms, flops=train_step_flops(cfg, *x.shape[:2]),
        nbytes=tensor_bytes(*args[1:6], *got[2:]) + 2 * weight_bytes + 4)

    args, kwargs = store["fine_stage_train"]
    kwargs = without_images(kwargs)
    got = fine_stage_train.fine_stage_train(*args, **kwargs)
    ref = fine_stage_train.fine_stage_train_plain(*args, **kwargs)
    err = compare_grads("fine_stage_train", {**got[1], "g_dens_c": got[2][0], "g_col_c": got[2][1]},
                        {**ref[1], "g_dens_c": ref[2][0], "g_col_c": ref[2][1]}, got[0], ref[0])
    ms = cuda_ms(lambda: fine_stage_train.fine_stage_train(*args, **kwargs), iters=5)
    plain_ms = cuda_ms(lambda: fine_stage_train.fine_stage_train_plain(*args, **kwargs), iters=3)
    x_f, d_f = args[1], args[2]
    print(f"fine_stage_train at {x_f.shape[0]} rays x ({args[3].shape[1]} + {x_f.shape[1]}) samples")
    # The view encoding is constant along a ray: the kernel reads one row
    # per ray.
    rows["fine_stage_train"] = dict(
        max_abs=err, ms=ms, plain_ms=plain_ms,
        flops=train_step_flops(cfg, *x_f.shape[:2]),
        nbytes=tensor_bytes(x_f, d_f[:, 0], *args[3:10], *got[2]) + 2 * weight_bytes + 4)
    return rows


def mip_serving(device, flops_per_point: int, keep: dict) -> dict:
    """Phase 7: K7 against its plain version, then the mip frame.  Returns
    K7's row; the frame and its time go to ``keep``."""
    model = make_mip_model(True, device).eval().requires_grad_(False)
    plain_model = make_mip_model(False, device).eval().requires_grad_(False)
    weight_bytes = tensor_bytes(*mip_mlp.pack_mip_params(model.mlp).values())
    pose_o, pose_r = spherical_poses(1, radius=4.0, device=device)
    rows_per_ray = MIP_RENDER.num_coarse_samples - 1

    store = {}
    rays_o, rays_d = (r.reshape(-1, 3)[: MIP_RENDER.rays_per_tile] for r in
                      pose_to_rays(pose_o, pose_r, IMAGE, IMAGE, FOCAL))
    with torch.no_grad(), capture_args(mip_train, "mip_eval", store):
        model.render_rays(rays_o, rays_d, MIP_RENDER, fused_eval=True)
    args = store["mip_eval"][0]  # without the frame's images: the call builds its own
    with torch.no_grad():
        _build.policy_counts.clear()
        got = mip_train.mip_eval(*args)
        ref = mip_train.mip_eval_plain(*args)
        torch.cuda.synchronize()
        check(dict(_build.policy_counts) == {("mip_eval", "tc"): 1},
              f"K7 at {args[1].shape[-1]} features ran its tensor-core tile")
        err = compare("mip_eval", got, ref)
        ms = cuda_ms(lambda: mip_train.mip_eval(*args), iters=5)
        plain_ms = cuda_ms(lambda: mip_train.mip_eval_plain(*args), iters=5)
    feat, dists, t_mids = args[1:4]
    k7 = dict(max_abs=err, ms=ms, plain_ms=plain_ms,
              flops=feat.shape[0] * feat.shape[1] * flops_per_point,
              nbytes=tensor_bytes(feat, dists, t_mids, *got) + weight_bytes)

    n_tiles = -(-IMAGE * IMAGE // MIP_RENDER.rays_per_tile)

    def render(m):
        return m.render_image(pose_o, pose_r, IMAGE, IMAGE, FOCAL, MIP_RENDER)

    render(model)  # warm-up
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    _build.policy_counts.clear()
    t0 = time.perf_counter()
    rgb, seg = render(model)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3
    launches, policies = dict(_build.launch_counts), dict(_build.policy_counts)
    print(f"mip frame through the kernels: {frame_ms:.1f} ms; launches {launches}", flush=True)
    check(launches == {"mip_eval": n_tiles},
          f"K7 launched once per tile ({n_tiles} tiles), nothing else")
    check_policies("mip frame", launches, policies, "tc")

    render(plain_model)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_rgb, plain_seg = render(plain_model)
    torch.cuda.synchronize()
    plain_frame_ms = (time.perf_counter() - t0) * 1e3
    print(f"mip frame through the plain path: {plain_frame_ms:.1f} ms", flush=True)
    classes = model.cfg.segmentation_outputs
    check(rgb.shape == (1, IMAGE, IMAGE, 3) and seg.shape == (1, IMAGE, IMAGE, classes),
          f"mip image shapes {tuple(rgb.shape)}, {tuple(seg.shape)}")
    check(bool(torch.isfinite(rgb).all() and torch.isfinite(seg).all()), "mip images are finite")
    check(float(rgb.min()) >= -1e-5 and float(rgb.max()) <= 1.0 + 1e-5,
          f"mip pixels in [0, 1] (min {float(rgb.min()):.4f}, max {float(rgb.max()):.4f})")
    check(float(rgb.std()) > 1e-3, f"mip image is not flat (std {float(rgb.std()):.4f})")
    pixel_err = compare("mip_frame", [rgb, seg], [plain_rgb, plain_seg])
    # sum_c exp(seg_c) = sum_i (w_i + 1e-10) sum_c softmax_ic = acc + R * 1e-10
    # at every pixel, acc from the same kernel tile by tile.
    all_o, all_d = (r.reshape(-1, 3) for r in pose_to_rays(pose_o, pose_r, IMAGE, IMAGE, FOCAL))
    tile = MIP_RENDER.rays_per_tile
    with torch.no_grad():
        acc = torch.cat([model.render_rays(all_o[i:i + tile], all_d[i:i + tile], MIP_RENDER,
                                           fused_eval=True).acc
                         for i in range(0, all_o.shape[0], tile)])
    lse = torch.logsumexp(seg.reshape(-1, classes), dim=-1)
    identity_err = compare("seg_identity", [lse], [torch.log(acc + rows_per_ray * 1e-10)])
    print(f"mip frame: {frame_ms:.1f} ms through the kernels, {plain_frame_ms:.1f} ms plain, "
          f"max pixel difference {pixel_err:.3e}, seg/acc identity error {identity_err:.3e}")
    keep.update(frame=(rgb, seg), frame_ms=frame_ms)
    return {"mip_eval": (launches["mip_eval"], k7)}


def mip_train_run(name, bank, device, store: dict, policy: str = "tc", **cfg_kwargs):
    """Warm-up then timed fused mip steps (4096 x 64, seg 0.1; one K6 a
    step), the counters zeroed just before the timed steps; the probe
    batch's loss taken before and after.  The first K6 call of the warm-up
    has its arguments recorded in ``store``.  Every launch must run the
    ``policy`` tile.  Returns (launches, ms per step)."""
    render = MIP_TRAIN_RENDER
    model = make_mip_model(True, device, **cfg_kwargs)
    state = create_train_state(model, LEARNING_RATE, seed=0)
    gen = torch.Generator(device=device).manual_seed(99)
    probe = (bank.sample_batch(gen, MIP_RAYS),
             loop.draws_for_model(gen, model, render, MIP_RAYS, device))
    probe_loss = make_fused_loss_and_grads(model, render, SEG_WEIGHT)
    loss_before = float(probe_loss(*probe)[0])
    warm = make_fused_multi_step_train_fn(model, render, bank, MIP_RAYS, WARMUP_STEPS,
                                          SEG_WEIGHT)
    timed = make_fused_multi_step_train_fn(model, render, bank, MIP_RAYS, TIMED_STEPS,
                                           SEG_WEIGHT)
    with capture_args(mip_train, "mip_train_grads", store):
        state, aux_w = warm(state)
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    _build.policy_counts.clear()
    t0 = time.perf_counter()
    state, aux = timed(state)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    launches, policies = dict(_build.launch_counts), dict(_build.policy_counts)
    loss_after = float(probe_loss(*probe)[0])
    losses = torch.cat([aux_w["loss"], aux["loss"]]).cpu()
    print(f"{name}: {ms:.2f} ms/step, {MIP_RAYS / ms * 1e3:.0f} rays/s over {TIMED_STEPS} "
          f"steps; launches {launches}; step losses {[round(float(v), 5) for v in losses]}",
          flush=True)
    check(launches == {"mip_train_grads": TIMED_STEPS},
          f"{name}: each step launched {{'mip_train_grads': 1}} and nothing else")
    check_policies(name, launches, policies, policy)
    check(bool(torch.isfinite(losses).all()), f"{name}: every loss is finite")
    check(loss_after < loss_before,
          f"{name}: the probe batch's loss fell from {loss_before:.6f} to {loss_after:.6f} "
          f"over {WARMUP_STEPS + TIMED_STEPS} steps")
    return launches, ms


def mip_training(device, store: dict, keep: dict) -> dict:
    """Phases 8 and 9.  Returns the launches of the timed fused steps and of
    the general-path step; the first call of K6 in the warm-up has its
    arguments recorded in ``store``, the labelled ray bank goes to
    ``keep``."""
    t0 = time.perf_counter()
    scene = synthesize_scene(num_views=8, image_hw=64, focal=80.0, with_labels=True,
                             device=device)
    bank = RayBank.from_images(scene.images, scene.pose_o, scene.pose_r, scene.focal,
                               labels=scene.labels)
    torch.cuda.synchronize()
    print(f"labelled synthetic scene: {tuple(scene.images.shape)} on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    keep["bank"] = bank
    render = MIP_TRAIN_RENDER

    def draws_for(gen, model):
        return loop.draws_for_model(gen, model, render, MIP_RAYS, device)

    # One fused step against the plain path: same weights, same draws.
    gen = torch.Generator(device=device).manual_seed(7)
    batch = bank.sample_batch(gen, MIP_RAYS)
    draws = draws_for(gen, make_mip_model(True, device))
    loss, grads, _ = make_fused_loss_and_grads(make_mip_model(True, device), render,
                                               SEG_WEIGHT)(batch, draws)
    plain = make_mip_model(False, device)
    with torch.enable_grad():
        ref_loss, _ = make_loss_fn(plain, render, SEG_WEIGHT)(batch, draws)
    names, params = zip(*plain.named_parameters())
    ref = dict(zip(names, torch.autograd.grad(ref_loss, params)))
    compare_grads("mip fused step", grads, ref, loss, ref_loss.detach())

    # Warm-up, then timed fused steps with the counters zeroed just before.
    launches, ms = mip_train_run("mip train 4096x64 seg 0.1", bank, device, store)

    # Phase 9: one general-path step through K5 against the plain step.
    step_grads = {}
    for use_pallas in (True, False):
        m = make_mip_model(use_pallas, device)
        kept = {}
        with capture_args(loop, "_apply", kept):
            _build.launch_counts.clear()
            _build.policy_counts.clear()
            make_train_step(m, render, SEG_WEIGHT)(create_train_state(m, LEARNING_RATE),
                                                    batch, draws)
            torch.cuda.synchronize()
            if use_pallas:
                general, policies = dict(_build.launch_counts), dict(_build.policy_counts)
        _, g, step_aux = kept["_apply"][0]
        step_grads[use_pallas] = (g, step_aux["loss"].detach())
    print(f"mip general step: launches {general}")
    check(general == {"mip_mlp_fwd": 1, "mip_mlp_bwd": 1},
          "mip general step launched one K5-fwd and one K5-bwd, nothing else")
    check_policies("mip general step", general, policies, "tc")
    compare_grads("mip general step", step_grads[True][0], step_grads[False][0],
                  step_grads[True][1], step_grads[False][1])
    return {"fused": (launches, ms), "general": general}


def mip_kernels_against_plain(store: dict, device) -> dict:
    """Phase 10: K5-fwd and K5-bwd on random rows, K6 on the trainer's
    recorded arguments, against their plain versions with their times;
    returns their rows' numbers."""
    cfg = MipNeRFConfig()
    flops_per_point = mip_flops_per_point(cfg)
    packed = mip_mlp.pack_mip_params(make_mip_model(True, device).mlp.requires_grad_(False))
    weight_bytes = tensor_bytes(*packed.values())
    gen = torch.Generator(device=device).manual_seed(9)
    feat = torch.rand((K5_POINTS, cfg.feature_dim), generator=gen, device=device) * 2 - 1
    g_out = torch.rand((K5_POINTS, cfg.num_outputs), generator=gen, device=device) * 2 - 1
    rows = {}
    _build.policy_counts.clear()
    got = mip_mlp.mip_mlp_fwd(packed, feat)
    ref = mip_mlp.mip_mlp_fwd_plain(packed, feat)
    torch.cuda.synchronize()
    err = compare("mip_mlp_fwd", [got], [ref])
    ms = cuda_ms(lambda: mip_mlp.mip_mlp_fwd(packed, feat), iters=10)
    check_policies("K5-fwd", {mip_mlp.NAME: 1 + (2 + 10)}, dict(_build.policy_counts), "tc")
    plain_ms = cuda_ms(lambda: mip_mlp.mip_mlp_fwd_plain(packed, feat), iters=10)
    print(f"K5-fwd {ms:.3f} ms at {K5_POINTS} rows")
    rows["mip_mlp_fwd"] = dict(max_abs=err, ms=ms, plain_ms=plain_ms,
                               flops=K5_POINTS * flops_per_point,
                               nbytes=tensor_bytes(feat, got) + weight_bytes)

    # As the general path calls it, the features needing no gradient; then
    # with the features' cotangent.  Every call on the tensor cores.
    _build.policy_counts.clear()
    got = mip_mlp.mip_mlp_bwd(packed, feat, g_out, input_grads=False)
    ref = mip_mlp.mip_mlp_bwd_plain(packed, feat, g_out, input_grads=False)
    err = compare_grads("mip_mlp_bwd", got[1], ref[1])
    ms = cuda_ms(lambda: mip_mlp.mip_mlp_bwd(packed, feat, g_out, input_grads=False), iters=5)
    plain_ms = cuda_ms(
        lambda: mip_mlp.mip_mlp_bwd_plain(packed, feat, g_out, input_grads=False), iters=3)
    got = mip_mlp.mip_mlp_bwd(packed, feat, g_out)
    ref = mip_mlp.mip_mlp_bwd_plain(packed, feat, g_out)
    err = max(err, compare_grads("mip_mlp_bwd with dfeat", {"dfeat": got[0], **got[1]},
                                 {"dfeat": ref[0], **ref[1]}))
    dfeat_ms = cuda_ms(lambda: mip_mlp.mip_mlp_bwd(packed, feat, g_out), iters=5)
    calls = 1 + (2 + 5) + 1 + (2 + 5)
    check_policies("K5-bwd", {"mip_mlp_bwd": calls}, dict(_build.policy_counts), "tc")
    print(f"K5-bwd {ms:.3f} ms without the features' cotangent (as the general path calls it), "
          f"{dfeat_ms:.3f} ms with it, at {K5_POINTS} rows")
    rows["mip_mlp_bwd"] = dict(max_abs=err, ms=ms, plain_ms=plain_ms,
                               flops=train_step_flops(cfg, K5_POINTS, 1, mip=True),
                               nbytes=tensor_bytes(feat, g_out) + 2 * weight_bytes)

    # K6 on the trainer's inputs, each call with its own operand images (the
    # step's were built for the weights of its own step).
    args, kwargs = store["mip_train_grads"]
    kwargs = without_images(kwargs)
    _build.policy_counts.clear()
    got = mip_train.mip_train_grads(*args, **kwargs)
    torch.cuda.synchronize()
    check(dict(_build.policy_counts) == {("mip_train_grads", "tc"): 1},
          "K6 on the trainer's inputs ran its tensor-core passes")
    ref = mip_train.mip_train_grads_plain(*args, **kwargs)
    err = compare_grads("mip_train_grads", got[2], ref[2], got[0] + SEG_WEIGHT * got[1],
                        ref[0] + SEG_WEIGHT * ref[1])
    ms = cuda_ms(lambda: mip_train.mip_train_grads(*args, **kwargs), iters=5)
    plain_ms = cuda_ms(lambda: mip_train.mip_train_grads_plain(*args, **kwargs), iters=3)
    feat_t = args[1]
    print(f"mip_train_grads at {feat_t.shape[0]} rays x {feat_t.shape[1]} rows, "
          f"seg weight {args[7]}")
    rows["mip_train_grads"] = dict(
        max_abs=err, ms=ms, plain_ms=plain_ms,
        flops=train_step_flops(cfg, *feat_t.shape[:2], mip=True),
        nbytes=tensor_bytes(*[a for a in args[1:6] if isinstance(a, torch.Tensor)])
        + 2 * weight_bytes + 8)
    return rows


def mip_phases(device, keep: dict) -> dict:
    """Phases 7-10 (slice 3).  Returns the four mip kernels' rows; the
    float32 frame, its time, the ray bank and the fused step's ms go to
    ``keep`` (phase 16 compares bf16 with them)."""
    cfg = MipNeRFConfig()
    rows = mip_serving(device, mip_flops_per_point(cfg), keep)
    store = {}
    runs = mip_training(device, store, keep)
    with torch.no_grad():
        k_rows = mip_kernels_against_plain(store, device)
    fused_launches, fused_ms = runs["fused"]
    keep["step_ms"] = fused_ms
    rows["mip_mlp_fwd"] = (runs["general"]["mip_mlp_fwd"], k_rows["mip_mlp_fwd"])
    rows["mip_mlp_bwd"] = (runs["general"]["mip_mlp_bwd"], k_rows["mip_mlp_bwd"])
    rows["mip_train_grads"] = (fused_launches["mip_train_grads"], k_rows["mip_train_grads"])
    flops = train_step_flops(cfg, MIP_RAYS, MIP_TRAIN_RENDER.num_coarse_samples - 1, mip=True)
    bound_ms, bound_tc_ms = flops / PEAK_FP32_FLOPS * 1e3, flops / PEAK_3XTF32_FLOPS * 1e3
    print(f"mip training: fused 4096x64 with seg CE {fused_ms:.2f} ms/step = "
          f"{MIP_RAYS / fused_ms * 1e3:.0f} rays/s (bound {bound_ms:.2f} ms = "
          f"{MIP_RAYS / bound_ms * 1e3:.0f} rays/s; 3xTF32 bound {bound_tc_ms:.2f} ms = "
          f"{MIP_RAYS / bound_tc_ms * 1e3:.0f} rays/s)")
    return rows


def resample_mass_error(t_c, weights_c, u, t_fine):
    """How far the plain cdf at K9's fine t-values is from their uniforms,
    less the mass that 4 ulp of t carry there (where a narrow bin holds
    much mass, one ulp of t is many ulp of mass)."""
    bins, w = 0.5 * (t_c[:, 1:] + t_c[:, :-1]), weights_c[:, 1:-1]
    step = 4 * 2.0 ** -23 * t_fine.abs()
    slack = (sampling.pdf_cdf_at(bins, w, t_fine + step)
             - sampling.pdf_cdf_at(bins, w, t_fine - step)) / 2
    return ((sampling.pdf_cdf_at(bins, w, t_fine) - u).abs() - slack).clamp_min(0.0)


def point_mlp_phase(device, cfg: ClassicNeRFConfig, bank) -> dict:
    """Phase 11: K8 through ``classic_pointmlp`` under autograd, then K8-fwd
    and K8-bwd against their plain versions.  Returns their rows."""
    model = make_model(True, device)
    args = (cfg.x_positional_encoding_size, cfg.normalize_position,
            cfg.d_positional_encoding_size, cfg.direction_bound)
    gen = torch.Generator(device=device).manual_seed(11)
    batch = bank.sample_batch(gen, K8_RAYS)
    t_vals = sampling.sample_linear(gen, (K8_RAYS,), K8_SAMPLES, TRAIN_RENDER.near,
                                    TRAIN_RENDER.far, device=device)
    points = (batch["rays_o"][:, None] + batch["rays_d"][:, None] * t_vals[..., None]).reshape(-1, 3)
    dirs = batch["rays_d"][:, None].expand(K8_RAYS, K8_SAMPLES, 3).reshape(-1, 3).contiguous()
    n_points = points.shape[0]

    # The main path: one forward and backward through the kernels.
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    _build.policy_counts.clear()
    density, color = point_mlp.classic_pointmlp(model, points, dirs, *args)
    loss = torch.mean((torch.sigmoid(color) - 0.5) ** 2) + torch.mean(torch.relu(density))
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    print(f"K8 at {n_points} raw points ({K8_RAYS} rays x {K8_SAMPLES}): launches {launches}",
          flush=True)
    check(launches == {point_mlp.NAME: 1, point_mlp.BWD_NAME: 1},
          "K8: the forward and backward launched one K8-fwd and one K8-bwd, nothing else")
    check_policies("K8 under autograd", launches, dict(_build.policy_counts), "tc")
    check(all(bool(torch.isfinite(g).all()) for g in grads) and bool(torch.isfinite(loss)),
          "K8: loss and gradients are finite")

    packed = classic_mlp.pack_classic_params(model.mlp.requires_grad_(False))
    weight_bytes = tensor_bytes(*packed.values())
    consts = point_mlp.encoding_consts(*args, device)
    flops = n_points * classic_flops_per_point(cfg)
    rows = {}
    with torch.no_grad():
        _build.policy_counts.clear()
        got = point_mlp.classic_pointmlp_fwd(packed, points, dirs, consts)
        ref = point_mlp.classic_pointmlp_fwd_plain(packed, points, dirs, consts)
        torch.cuda.synchronize()
        err = compare("classic_pointmlp_fwd", [got], [ref])
        x_enc = torch.sin(points @ consts[0] + consts[1])
        d_enc = torch.sin(dirs @ consts[2] + consts[3])
        k1 = classic_mlp.classic_mlp_fwd(packed, x_enc, d_enc)
        torch.cuda.synchronize()
        print("K8-fwd against K1-fwd on the same encodings:")
        compare("classic_pointmlp_fwd", [got], [k1])
        ms = cuda_ms(lambda: point_mlp.classic_pointmlp_fwd(packed, points, dirs, consts), iters=10)
        # K8-fwd's calls and the K1-fwd call on the encodings.
        check_policies("K8-fwd", {point_mlp.NAME: 1 + (2 + 10), classic_mlp.NAME: 1},
                       dict(_build.policy_counts), "tc")
        plain_ms = cuda_ms(
            lambda: point_mlp.classic_pointmlp_fwd_plain(packed, points, dirs, consts), iters=10)
        k1_ms = cuda_ms(lambda: classic_mlp.classic_mlp_fwd(packed, x_enc, d_enc), iters=10)
        print(f"K8-fwd {ms:.3f} ms, K1-fwd on the encodings {k1_ms:.3f} ms, at {n_points} points")
    rows["classic_pointmlp_fwd"] = (launches[point_mlp.NAME], dict(
        max_abs=err, ms=ms, plain_ms=plain_ms, flops=flops,
        nbytes=tensor_bytes(points, dirs, got, *consts) + weight_bytes))

    g_out = torch.rand((n_points, 4), generator=gen, device=device) * 2 - 1
    _build.policy_counts.clear()
    got = point_mlp.classic_pointmlp_bwd(packed, points, dirs, consts, g_out)
    ref = point_mlp.classic_pointmlp_bwd_plain(packed, points, dirs, consts, g_out)
    err = compare_grads("classic_pointmlp_bwd", {"dpoints": got[0], "ddirs": got[1], **got[2]},
                        {"dpoints": ref[0], "ddirs": ref[1], **ref[2]})
    ms = cuda_ms(lambda: point_mlp.classic_pointmlp_bwd(packed, points, dirs, consts, g_out),
                 iters=5)
    plain_ms = cuda_ms(
        lambda: point_mlp.classic_pointmlp_bwd_plain(packed, points, dirs, consts, g_out), iters=3)
    no_input_ms = cuda_ms(lambda: point_mlp.classic_pointmlp_bwd(
        packed, points, dirs, consts, g_out, input_grads=False), iters=5)
    check_policies("K8-bwd", {point_mlp.BWD_NAME: 1 + (2 + 5) + (2 + 5)},
                   dict(_build.policy_counts), "tc")
    print(f"K8-bwd {ms:.3f} ms with the raw inputs' cotangents, {no_input_ms:.3f} ms without "
          f"(as the main path calls it), at {n_points} points")
    rows["classic_pointmlp_bwd"] = (launches[point_mlp.BWD_NAME], dict(
        max_abs=err, ms=ms, plain_ms=plain_ms, flops=3 * flops,
        nbytes=tensor_bytes(points, dirs, g_out, *got[:2], *consts) + 2 * weight_bytes))
    return rows


def mega_run(name: str, bank, device, reuse_ms: float, policy: str = "tc", **cfg_kwargs):
    """K9's train loop: the model through ``mega_train_loss_and_grads`` and
    ``torch.optim.Adam``, 2 warm-up and 20 timed steps with the counters
    zeroed just before the timed ones; each must launch one ``mega_train``
    on the ``policy`` tile and nothing else, every loss be finite and the
    probe batch's loss fall.  Prints ms/step and rays/s beside the reuse
    route's ``reuse_ms``.  Returns (launches, ms per step)."""
    render, n_rays = TRAIN_RENDER, TRAIN_RAYS
    model = make_model(True, device, **cfg_kwargs)
    names, params = zip(*model.named_parameters())
    opt = torch.optim.Adam(params, lr=LEARNING_RATE)
    gen = torch.Generator(device=device).manual_seed(99)
    probe = (bank.sample_batch(gen, n_rays), sampling.draw_step(gen, render, n_rays, device))

    def probe_loss():
        return float(mega_train.mega_train_loss_and_grads(model, render, *probe)[0])

    def step():
        b = bank.sample_batch(gen, n_rays)
        d = sampling.draw_step(gen, render, n_rays, device)
        step_loss, step_grads, _ = mega_train.mega_train_loss_and_grads(model, render, b, d)
        for param_name, p in zip(names, params):
            p.grad = step_grads[param_name]
        opt.step()
        return step_loss

    loss_before = probe_loss()
    losses = [step() for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    _build.policy_counts.clear()
    t0 = time.perf_counter()
    losses += [step() for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    launches, policies = dict(_build.launch_counts), dict(_build.policy_counts)
    loss_after = probe_loss()
    losses = torch.stack(losses).cpu()
    print(f"{name}: {ms:.2f} ms/step, {n_rays / ms * 1e3:.0f} rays/s over {TIMED_STEPS} steps "
          f"(reuse route {reuse_ms:.2f} ms/step, {n_rays / reuse_ms * 1e3:.0f} rays/s); launches "
          f"{launches}; step losses {[round(float(v), 5) for v in losses]}", flush=True)
    check(launches == {mega_train.NAME: TIMED_STEPS},
          f"{name}: each step launched one mega_train and nothing else")
    check_policies(name, launches, policies, policy)
    check(bool(torch.isfinite(losses).all()), f"{name}: every loss is finite")
    check(loss_after < loss_before,
          f"{name}: the probe batch's loss fell from {loss_before:.6f} to {loss_after:.6f} "
          f"over {WARMUP_STEPS + TIMED_STEPS} steps")
    return launches, ms


def mega_phase(device, cfg: ClassicNeRFConfig, bank, reuse_ms: float) -> dict:
    """Phase 12: one K9 step against its plain version and the reuse route,
    then the K9 train loop, then K9 against its plain version with its
    time.  Returns K9's row and the loop's ms/step."""
    render, n_rays = TRAIN_RENDER, TRAIN_RAYS
    gen = torch.Generator(device=device).manual_seed(7)
    batch = bank.sample_batch(gen, n_rays)
    draws = sampling.draw_step(gen, render, n_rays, device)
    model = make_model(True, device)
    check(mega_train.supports_mega(model, render, batch), "K9 covers the reuse configuration")
    _build.launch_counts.clear()
    loss, grads, aux = mega_train.mega_train_loss_and_grads(model, render, batch, draws,
                                                            emit_t_fine=True)
    torch.cuda.synchronize()
    check(dict(_build.launch_counts) == {mega_train.NAME: 1}, "K9 step: one mega_train launch")

    # Against the plain version with the kernel's own fine t-values, and
    # the plain resample's t-values against the kernel's.
    inputs = mega_train.mega_inputs(model, batch, draws)
    packed = classic_mlp.pack_classic_params(model.mlp.requires_grad_(False))
    p_loss_c, p_loss_f, p_grads, _ = mega_train.mega_train_plain(packed, *inputs,
                                                                 t_fine=aux["t_fine"])
    names, params = zip(*model.named_parameters())
    k_loss_c, k_loss_f, k_grads, t_fine = mega_train.mega_train(packed, *inputs)
    err = compare_grads("mega_train", k_grads, p_grads, k_loss_c + k_loss_f,
                        p_loss_c + p_loss_f)
    x_enc_c, d_ray, t_c, noise_c, u, _, _, rays_d = inputs[:8]
    weights_c = mega_train.coarse_weights_plain(packed, x_enc_c, d_ray, t_c, noise_c, rays_d)
    mass_err = float(resample_mass_error(t_c, weights_c, u, t_fine).max())
    *_, plain_t = mega_train.mega_train_plain(packed, *inputs)
    t_err = (t_fine - plain_t).abs()
    print(f"mega_train t_fine against the plain resample: the plain cdf at them is within "
          f"{mass_err:.3e} of the uniforms (tolerance {T_FINE_MASS}); in t max abs err "
          f"{float(t_err.max()):.3e}, share beyond {T_FINE_ATOL}: "
          f"{float((t_err > T_FINE_ATOL).float().mean()):.2e}")
    check(mass_err <= T_FINE_MASS, "K9's fine t-values match the plain resample")

    # Against the reuse route (K1-fwd, K3, K1-bwd).
    model.requires_grad_(True)
    r_loss, r_grads, r_aux = fine_stage_train.reuse_train_loss_and_grads(model, render, batch,
                                                                         draws)
    flat = torch.cat([grads[k].ravel() for k in names])
    r_flat = torch.cat([r_grads[k].ravel() for k in names])
    grad_err = float((flat - r_flat).abs().max() / r_flat.abs().max())
    loss_err = abs(float(loss) - float(r_loss)) / abs(float(r_loss))
    print(f"K9 step against the reuse route: loss {float(loss):.7g} vs {float(r_loss):.7g} "
          f"(rel err {loss_err:.3e}, tolerance {MEGA_VS_REUSE['loss_rtol']}); largest gradient "
          f"difference {grad_err:.3e} of the largest entry (tolerance "
          f"{MEGA_VS_REUSE['grad_of_max']})")
    check(loss_err <= MEGA_VS_REUSE["loss_rtol"] and grad_err <= MEGA_VS_REUSE["grad_of_max"],
          "K9 step matches the reuse route")

    # The K9 train loop.
    launches, step_ms = mega_run("train 2048x(64+128) K9", bank, device, reuse_ms)

    with torch.no_grad():
        kernel_ms = cuda_ms(lambda: mega_train.mega_train(packed, *inputs), iters=5)
        plain_ms = cuda_ms(lambda: mega_train.mega_train_plain(packed, *inputs), iters=3)
    sc, sf = render.num_coarse_samples, render.num_fine_samples
    print(f"mega_train at {n_rays} rays x ({sc} + {sf}): {kernel_ms:.3f} ms")
    nbytes = (tensor_bytes(*[a for a in inputs if a is not None], t_fine) + 8
              + 2 * tensor_bytes(*packed.values()))
    return {"mega_train": (launches[mega_train.NAME], dict(
        max_abs=err, ms=kernel_ms, plain_ms=plain_ms, flops=train_step_flops(cfg, n_rays, sc + sf),
        nbytes=nbytes))}, step_ms


def latent_phase(device, bank) -> None:
    """Phase 13: the full-width model conditioned on 2 + 1 latent scalars
    (encodings 100 + 48), whose K1-fwd, K1-bwd, K2, K3 and K4 run the
    float32 SIMT tile where the tensor-core one does not fit: a frame tile through K1-fwd and
    K4, one reuse step (K1-fwd, K3, K1-bwd) and one coarse-only step (K2),
    each against the plain path, with the launches and tile policies."""
    model = make_model(True, device, **LATENT)
    plain = make_model(False, device, **LATENT)
    cfg = model.cfg
    print(f"latent model: density_inputs {cfg.density_inputs}, color_inputs "
          f"{cfg.color_inputs}, encodings {cfg.x_encoding_dim} + {cfg.d_encoding_dim}", flush=True)
    gen = torch.Generator(device=device).manual_seed(13)

    # One tile of the frame, per-image states broadcast to its rays.
    pose_o, pose_r = spherical_poses(1, radius=4.0, device=device)
    rays_o, rays_d = (r.reshape(-1, 3)[: RENDER.rays_per_tile] for r in
                      pose_to_rays(pose_o, pose_r, IMAGE, IMAGE, FOCAL))
    n = rays_o.shape[0]
    states = {"states_x": (torch.rand((1, 2), generator=gen, device=device) * 2 - 1).expand(n, 2),
              "states_d": (torch.rand((1, 1), generator=gen, device=device) * 2 - 1).expand(n, 1)}
    store = {}
    with torch.no_grad(), capture_args(union_eval, "union_eval", store):
        torch.cuda.synchronize()
        _build.launch_counts.clear()
        _build.policy_counts.clear()
        got = model.render_rays(rays_o, rays_d, RENDER, **states, fused_eval=True)
        torch.cuda.synchronize()
        launches, policies = dict(_build.launch_counts), dict(_build.policy_counts)
        print(f"latent frame tile ({n} rays, {RENDER.num_coarse_samples} + "
              f"{RENDER.num_fine_samples}): launches {launches}", flush=True)
        check(launches == {"classic_mlp_fwd": 1, "union_eval": 1},
              "latent frame tile: one K1-fwd and one K4, nothing else")
        check_policies("latent frame tile", launches, policies, "simt")
        ref = plain.render_rays(rays_o, rays_d, RENDER, **states, fused_eval=True)
        compare("frame", [got.rgb, got.acc], [ref.rgb, ref.acc])
        args = store["union_eval"][0]
        compare("union_eval", union_eval.union_eval(*args), union_eval.union_eval_plain(*args))

    # One reuse step and one coarse-only step with per-ray states.
    for name, render, n_rays, expected in (
            ("latent reuse step 2048x(64+128)", TRAIN_RENDER, TRAIN_RAYS,
             {"classic_mlp_fwd": 1, "classic_mlp_bwd": 1, "fine_stage_train": 1}),
            ("latent coarse-only step 4096x64", COARSE_RENDER, COARSE_RAYS,
             {"train_grads": 1})):
        batch = bank.sample_batch(gen, n_rays)
        batch["states_x"] = torch.rand((n_rays, 2), generator=gen, device=device) * 2 - 1
        batch["states_d"] = torch.rand((n_rays, 1), generator=gen, device=device) * 2 - 1
        draws = sampling.draw_step(gen, render, n_rays, device)
        torch.cuda.synchronize()
        _build.launch_counts.clear()
        _build.policy_counts.clear()
        loss, grads, _ = make_fused_loss_and_grads(model, render)(batch, draws)
        torch.cuda.synchronize()
        launches, policies = dict(_build.launch_counts), dict(_build.policy_counts)
        print(f"{name}: launches {launches}", flush=True)
        check(launches == expected, f"{name}: launched {expected} and nothing else")
        check_policies(name, launches, policies, "simt")
        with torch.enable_grad():
            ref_loss, _ = make_loss_fn(plain, render)(batch, draws)
        names, params = zip(*plain.named_parameters())
        ref = dict(zip(names, torch.autograd.grad(ref_loss, params)))
        compare_grads(name, grads, ref, loss, ref_loss.detach())


# Slice 10: K8-fwd's and K5-fwd's models too wide for their tensor-core
# tiles at hidden 256 (x encodings 120 + 36; 144 features), and the rows
# of each call.
WIDE_K8 = dict(x_positional_encoding_size=40)
WIDE_K5 = dict(encoding_size=48)
WIDE_ROWS = 65_536


def wide_forward_phase(device) -> None:
    """The rest of phase 13: K8-fwd and K5-fwd at widths past their
    tensor-core tiles (``WIDE_K8``, ``WIDE_K5``), each call of which must
    run its float32 SIMT tile, against their plain versions."""
    gen = torch.Generator(device=device).manual_seed(17)
    cfg = ClassicNeRFConfig(normalize_position=6.0, **WIDE_K8)
    packed = classic_mlp.pack_classic_params(make_model(True, device, **WIDE_K8).mlp
                                             .requires_grad_(False))
    consts = point_mlp.encoding_consts(cfg.x_positional_encoding_size, cfg.normalize_position,
                                       cfg.d_positional_encoding_size, cfg.direction_bound,
                                       device)
    points = torch.rand((WIDE_ROWS, 3), generator=gen, device=device) * 4 - 2
    dirs = torch.rand((WIDE_ROWS, 3), generator=gen, device=device) * 2 - 1
    mcfg = MipNeRFConfig(**WIDE_K5)
    mpacked = mip_mlp.pack_mip_params(
        MipNeRF(mcfg, generator=torch.Generator().manual_seed(0), device=device).mlp
        .requires_grad_(False))
    feat = torch.rand((WIDE_ROWS, mcfg.feature_dim), generator=gen, device=device) * 2 - 1
    widths = f"{cfg.x_encoding_dim} + {cfg.d_encoding_dim}"
    with torch.no_grad():
        for name, what, call, plain in (
                (point_mlp.NAME, f"K8-fwd at encodings {widths}",
                 lambda: point_mlp.classic_pointmlp_fwd(packed, points, dirs, consts),
                 lambda: point_mlp.classic_pointmlp_fwd_plain(packed, points, dirs, consts)),
                (mip_mlp.NAME, f"K5-fwd at {mcfg.feature_dim} features",
                 lambda: mip_mlp.mip_mlp_fwd(mpacked, feat),
                 lambda: mip_mlp.mip_mlp_fwd_plain(mpacked, feat))):
            torch.cuda.synchronize()
            _build.launch_counts.clear()
            _build.policy_counts.clear()
            got = call()
            torch.cuda.synchronize()
            launches = dict(_build.launch_counts)
            check(launches == {name: 1}, f"{what}: one launch, nothing else")
            check_policies(what, launches, dict(_build.policy_counts), "simt")
            compare(name, [got], [plain()])
            print(f"{what}, {WIDE_ROWS} rows (float32 SIMT tile): {cuda_ms(call, iters=3):.3f} ms")


# Slice 11: the user's entry points.  The tiny-NeRF trainer at the
# notebook recipe (the CLI's defaults, spelled out), on the synthetic scene
# its missing --data falls back to.
TINY_RECIPE = ["--use-pallas", "--batch-size", "1024", "--num-samples-per-ray", "64",
               "--density-noise-std", "1.0", "--learning-rate", "1e-4",
               "--normalize-position", "6.0", "--log-interval", "20"]
TINY_STEPS, RESUMED_STEPS = 40, 60
# The straight and the resumed run's weights and Adam moments: the bound
# the JAX package's tests hold its resume to (tests/test_train.py).
RESUME_ATOL = 1e-6
RENDER_ARGS = ["--use-pallas", "--num-fine-samples", "128", "--num-views", "2"]
CONDITIONAL_VIEWS, CONDITIONAL_HW, STATE_WIDTH = 4, 100, 2
# The one device kernel of K2's library that no other kernel on this path
# launches: every K2 call launches it once.
K2_TRACE_KERNEL = re.compile(r"\bcomposite_kernel\b")


def read_png(path: str) -> np.ndarray:
    """Decode the 8-bit RGB, filter-0 PNGs that ``cli.render.write_png``
    writes."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            size = (int.from_bytes(body[4:8], "big"), int.from_bytes(body[:4], "big"))
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(size[0], 1 + 3 * size[1])
    return raw[:, 1:].reshape(size[0], size[1], 3)


def counted(what: str, call, expected: dict, plans: dict):
    """Run ``call()`` with the counters zeroed just before and read just
    after; check the launches against ``expected`` and each tensor-core
    kernel's tile against ``plans`` (kernel -> ``tile_plan`` policy).
    Returns (launches, seconds)."""
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    _build.policy_counts.clear()
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, policies = dict(_build.launch_counts), dict(_build.policy_counts)
    print(f"{what}: {seconds:.2f} s; launches {launches}; tile policies {policies}", flush=True)
    check(launches == expected, f"{what}: launched {expected} and nothing else")
    check(policies == {(k, plans[k]): n for k, n in launches.items()},
          f"{what}: every launch ran the tile tile_plan picks ({plans})")
    return launches, seconds


def metrics_records(logdir: str) -> list:
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def checkpoint_leaves(path: str) -> dict:
    with np.load(path) as data:
        names = [str(n) for n in data["leaf_names"]]
        return {name: data[f"leaf_{i:05d}"] for i, name in enumerate(names)}


def entry_points_phase(device, card: str) -> dict:
    """Phase 14: the training CLIs, resume, the trace, the checkpoint save
    and the render CLI through the fused kernels.  Returns each kernel's
    launches in the phase."""
    cfg = ClassicNeRFConfig(normalize_position=6.0)
    xe, de, hidden = cfg.x_encoding_dim, cfg.d_encoding_dim, cfg.hidden_size
    plans = {name: _build.tile_plan(name, xe, de, hidden).policy
             for name in (train_grads.NAME, classic_mlp.NAME)}
    plans[union_eval.NAME] = _build.tile_plan(union_eval.NAME, xe, de, hidden, cfg.color_outputs,
                                              64, 128).policy
    check(set(plans.values()) == {"tc"}, f"the full-width model's tiles are all tensor-core: {plans}")
    # An eval render and a CLI view are 100 x 100 rays in tiles of
    # RenderConfig().rays_per_tile.
    tiles = -(-100 * 100 // RenderConfig().rays_per_tile)
    total = {}

    def tally(launches):
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        run, straight = os.path.join(tmp, "run"), os.path.join(tmp, "straight")
        tiny = ["--data", os.path.join(tmp, "tiny_nerf_data.npz")] + TINY_RECIPE

        # a. 40 steps: two log/eval/checkpoint boundaries.
        launches, seconds = counted(
            "14a train_tiny_nerf 40 steps",
            lambda: train_tiny_nerf.main(["--logging-dir", run, "--num-steps", str(TINY_STEPS)]
                                         + tiny),
            {train_grads.NAME: TINY_STEPS, classic_mlp.NAME: 2 * tiles}, plans)
        tally(launches)
        files = ("params.json", "checkpoint_20.npz", "checkpoint_40.npz", "nerf.pth",
                 "metrics.jsonl", "psnrs.npy")
        check(all(os.path.exists(os.path.join(run, f)) for f in files),
              f"14a: the run wrote {', '.join(files)}")
        records = metrics_records(run)
        check([r["step"] for r in records] == [20, 40], "14a: two metrics records, steps 20, 40")
        # The trainer raises TrainDivergedError at any non-finite loss of a
        # chunk; the records hold each chunk's last.
        check(all(np.isfinite([r["loss"], r["psnr"]]).all() for r in records),
              f"14a: every loss finite (last of each chunk: {[r['loss'] for r in records]})")
        rays_per_s = records[-1]["rays_per_s"]  # steps 21-40: no warm-up, no eval
        print(f"14a train_tiny_nerf: {1024 / rays_per_s * 1e3:.3f} ms/step, {rays_per_s:.0f} rays/s "
              f"(steps 21-40, host clock), holdout PSNR {records[-1]['psnr']:.3f} dB after 40 "
              f"steps, {seconds:.2f} s for the whole call; {card}", flush=True)

        # b. Resume to 60 under the profiler, then a straight 60-step run.
        trace_dir = os.path.join(tmp, "trace")
        resumed = ["--logging-dir", run, "--num-steps", str(RESUMED_STEPS), "--resume"] + tiny

        def traced_resume():
            with trace(trace_dir):
                train_tiny_nerf.main(resumed)

        launches, _ = counted("14b train_tiny_nerf --resume to 60", traced_resume,
                              {train_grads.NAME: RESUMED_STEPS - TINY_STEPS,
                               classic_mlp.NAME: tiles}, plans)
        tally(launches)
        check([r["step"] for r in metrics_records(run)] == [20, 40, 60],
              "14b: the resumed run started from step 40 (one new record, step 60)")
        (trace_file,) = os.listdir(trace_dir)
        with open(os.path.join(trace_dir, trace_file)) as f:
            events = json.load(f)["traceEvents"]
        k2_events = sum(1 for e in events
                        if e.get("cat") == "kernel" and K2_TRACE_KERNEL.search(e.get("name", "")))
        print(f"14b trace {trace_file}: {len(events)} events, {k2_events} of K2's "
              f"compositing kernel", flush=True)
        check(k2_events == RESUMED_STEPS - TINY_STEPS,
              f"14b: the trace lists K2 exactly {RESUMED_STEPS - TINY_STEPS} times")
        launches, _ = counted(
            "14b train_tiny_nerf straight 60 steps",
            lambda: train_tiny_nerf.main(["--logging-dir", straight, "--num-steps",
                                          str(RESUMED_STEPS)] + tiny),
            {train_grads.NAME: RESUMED_STEPS, classic_mlp.NAME: 3 * tiles}, plans)
        tally(launches)
        final = f"checkpoint_{RESUMED_STEPS}.npz"
        got = checkpoint_leaves(os.path.join(run, final))
        want = checkpoint_leaves(os.path.join(straight, final))
        check(list(got) == list(want), "14b: the two final checkpoints have the same leaves")
        floats = [k for k in want if want[k].dtype == np.float32]
        diff = max(float(np.abs(got[k] - want[k]).max()) for k in floats)
        bitwise = all(np.array_equal(got[k], want[k]) for k in want)
        print(f"14b resumed vs straight 60 steps: {len(floats)} weight and moment leaves, max abs "
              f"difference {diff:.3e}, bitwise equal: {bitwise}", flush=True)
        check(diff <= RESUME_ATOL and all(np.array_equal(got[k], want[k])
                                          for k in want if k not in floats),
              f"14b: the resumed run's weights and Adam moments within {RESUME_ATOL} of the "
              f"straight run's, step, count and key equal")

        model = ClassicNeRF(cfg, device=device)
        state = checkpoint.restore_checkpoint(os.path.join(run, final), create_train_state(model))
        save_dir = os.path.join(tmp, "save")
        checkpoint.save_checkpoint(save_dir, state)  # warm-up
        save_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            path = checkpoint.save_checkpoint(save_dir, state)
            save_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        checkpoint.restore_checkpoint(path, state)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        print(f"14b save_checkpoint at full width (638,468 parameters, weights + 2 moments): "
              f"{', '.join(f'{t:.1f}' for t in save_ms)} ms, {os.path.getsize(path) / 1e6:.3f} MB; "
              f"restore {restore_ms:.1f} ms; {card}", flush=True)

        # c. The render CLI on the checkpoint and on the exported .pth.
        ckpt = os.path.join(run, final)
        out = {name: os.path.join(tmp, name)
               for name in ("npz", "plain", "pth", "coarse", "coarse_plain")}
        # The fine t-values each render placed, tile by tile, in pixel order.
        t_fine = {"npz": [], "plain": []}
        with recording_results(sampling, "sample_pdf", t_fine["npz"]):
            launches, seconds = counted(
                "14c render --checkpoint checkpoint_60.npz",
                lambda: render_cli.main(["--checkpoint", ckpt, "--output-dir", out["npz"]]
                                        + RENDER_ARGS),
                {classic_mlp.NAME: 2 * tiles, union_eval.NAME: 2 * tiles}, plans)
        tally(launches)
        print(f"14c render CLI: {seconds / 2 * 1e3:.1f} ms per 100x100 view at 64 + 128 samples "
              f"(the whole call over its 2 views, checkpoint restore and PNGs included); {card}",
              flush=True)
        with recording_results(sampling, "sample_pdf", t_fine["plain"]):
            render_cli.main(["--checkpoint", ckpt, "--output-dir", out["plain"],
                             "--num-fine-samples", "128", "--num-views", "2"])
        render_cli.main(["--checkpoint", os.path.join(run, "nerf.pth"), "--output-dir", out["pth"]]
                        + RENDER_ARGS)
        # Without the fine stage nothing can move a sample: every pixel.
        render_cli.main(["--checkpoint", ckpt, "--output-dir", out["coarse"], "--use-pallas",
                         "--num-views", "2"])
        render_cli.main(["--checkpoint", ckpt, "--output-dir", out["coarse_plain"],
                         "--num-views", "2"])
        # Trained from a random init, some rays' coarse weights put ~1e-5 of
        # the mass in a bin; there the float32 rounding of the coarse
        # weights moves the fine samples, and the pixel by several 8-bit
        # levels, between any two float32 evaluations (the plain path
        # against itself at another batch size too).
        moved = ((torch.cat(t_fine["npz"]) - torch.cat(t_fine["plain"])).abs().amax(-1)
                 > T_FINE_ATOL).reshape(2, 100, 100).cpu().numpy()
        for i, name in enumerate(("view_000.png", "view_001.png")):
            coarse = read_png(os.path.join(out["coarse"], name)).astype(int)
            level = int(np.abs(coarse - read_png(os.path.join(out["coarse_plain"], name))).max())
            check(level <= 1, f"14c {name} at 64 coarse samples only: within one 8-bit level of "
                              f"the plain path's at every pixel ({level})")
            kernel_png = read_png(os.path.join(out["npz"], name)).astype(int)
            level = np.abs(kernel_png - read_png(os.path.join(out["plain"], name))).max(-1)
            still = level[~moved[i]].max()
            print(f"14c {name}: {int(moved[i].sum())} of {level.size} pixels with fine samples "
                  f"moved beyond {T_FINE_ATOL} in t between the two paths, up to "
                  f"{int(level[moved[i]].max(initial=0))} levels apart; the rest up to {still}",
                  flush=True)
            check(still <= 1 and kernel_png.std() > 0,
                  f"14c {name}: within one 8-bit level of the plain path's at every pixel whose "
                  f"fine samples both paths place alike ({still})")
            with open(os.path.join(out["npz"], name), "rb") as a, \
                    open(os.path.join(out["pth"], name), "rb") as b:
                check(a.read() == b.read(), f"14c {name}: the same PNG from the run's nerf.pth")

        # d. The conditional trainer on a pickle written from a seed.
        focal = CONDITIONAL_HW * 50.0 / 36.0  # the CLI's default camera
        scene = synthesize_scene(num_views=CONDITIONAL_VIEWS, image_hw=CONDITIONAL_HW,
                                 focal=focal, pose_seed=21, device=device)
        states = np.random.default_rng(21).normal(size=(CONDITIONAL_VIEWS, STATE_WIDTH))
        pose_o = scene.pose_o.cpu().numpy()
        data = os.path.join(tmp, "data_for_nerf.pkl")
        with open(data, "wb") as f:
            pickle.dump({"images": scene.images.cpu().numpy(),
                         "poses": np.concatenate([pose_o, -pose_o], -1),
                         "states": states.astype(np.float32)}, f)
        ccfg = ClassicNeRFConfig(density_inputs=3 + STATE_WIDTH)
        cxe = ccfg.x_encoding_dim
        cplans = {name: _build.tile_plan(name, cxe, de, hidden).policy
                  for name in (train_grads.NAME, classic_mlp.NAME)}
        steps = (CONDITIONAL_VIEWS - 1) * CONDITIONAL_HW ** 2 // 1024  # one epoch
        cond = os.path.join(tmp, "conditional")
        launches, seconds = counted(
            f"14d train_conditional 1 epoch (encodings {cxe} + {de})",
            lambda: train_conditional.main(["--logging-dir", cond, "--data", data, "--use-pallas",
                                            "--epochs", "1", "--near-plane", "2",
                                            "--far-plane", "6"]),
            {train_grads.NAME: steps, classic_mlp.NAME: tiles}, cplans)
        tally(launches)
        records = metrics_records(cond)
        check(records[-1]["step"] == steps and np.isfinite(records[-1]["loss"]),
              f"14d: {steps} steps, every loss finite (the last {records[-1]['loss']:.6f})")
        check(os.path.exists(os.path.join(cond, "model.pth"))
              and checkpoint.all_checkpoints(cond) == [f"checkpoint_{steps}.npz"],
              "14d: model.pth and the checkpoint written")
        print(f"14d train_conditional: {seconds:.2f} s for {steps} steps and one eval render, "
              f"tiles {cplans}; {card}", flush=True)
    return total


# Phase 15: compute_dtype="bfloat16" on the classic main path (slice 12).
# Bounds, in relative L2 over a whole output or over all gradients
# together: a bf16 kernel against its plain bf16 version (the same
# roundings; the products summed in another order, and by the tensor
# cores with truncation) within 1e-2 for outputs and 2e-2 for gradients.
# A single float32 rounding can move an activation or a cotangent to the
# other bf16 neighbour and the change travels through ten layers, so bf16
# is never held element by element at float32 tolerances.  The gradient
# checks run on the cotangents a step hands each kernel (a loss's, summed
# over the step's rows), and K1-bwd's check is shown to fail the float32
# kernel on the same inputs.  Against float32 the JAX package's own bf16
# bounds (tests/test_pallas.py): outputs within rtol 0.1, atol 0.15; the
# gradients' cosine above 0.98.  One step's loss against the plain bf16
# step: rtol 1e-3.
BF16 = dict(fwd_rel_l2=1e-2, grad_rel_l2=2e-2, loss_rtol=1e-3, f32_rtol=0.1, f32_atol=0.15,
            f32_cosine=0.98)
BF16_ROW_KEYS = ("bf16_ms", "bf16_plain_ms", "bf16_bound_ms", "bf16_bound_by",
                 "bf16_flop_bound_ms", "bf16_byte_bound_ms", "bf16_launches", "bf16_rel_l2")
# The float32 chain a training kernel writes and reads back: xhat and dpre,
# ten layers of 256 floats each, a row.
CHAIN_BYTES_PER_ROW = 2 * 2 * 10 * 256 * 4


def rel_l2(got, ref) -> float:
    got = torch.cat([g.double().ravel() for g in got])
    ref = torch.cat([r.double().ravel() for r in ref])
    return float((got - ref).norm() / ref.norm())


def check_bf16_grads(name: str, got: dict, ref: dict) -> float:
    """All of ``got`` against ``ref`` in relative L2, within BF16's
    gradient bound.  Returns the error."""
    keys = list(ref)
    check(set(got) == set(keys), f"{name}: the same gradients as its plain version")
    err = rel_l2([got[k] for k in keys], [ref[k] for k in keys])
    finite = all(bool(torch.isfinite(g).all()) for g in got.values())
    print(f"{name}: gradients relative L2 {err:.3e} against plain bf16 (bound "
          f"{BF16['grad_rel_l2']})", flush=True)
    check(finite and err <= BF16["grad_rel_l2"], f"{name} in bf16 matches its plain bf16 version")
    return err


def check_bf16_outputs(name: str, got, ref) -> float:
    err = rel_l2(got, ref)
    max_abs = max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    print(f"{name}: relative L2 {err:.3e} against plain bf16 (max abs {max_abs:.3e}; bound "
          f"{BF16['fwd_rel_l2']})", flush=True)
    check(finite and err <= BF16["fwd_rel_l2"], f"{name} in bf16 matches its plain bf16 version")
    return err


def bf16_row(name, launches, err, ms, plain_ms, flops, nbytes, chain_rows=0,
             chain_row_bytes=CHAIN_BYTES_PER_ROW) -> dict:
    """A kernel's bf16 entries for its row: the bound is the larger of its
    FLOP at the bf16 rate and the bytes of its inputs and outputs;
    ``chain_rows``, a training kernel's rows, prints the byte time with its
    float32 chain (``chain_row_bytes`` a row) beside it."""
    flop_ms, byte_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    row = {"bf16_ms": ms, "bf16_plain_ms": plain_ms, "bf16_launches": launches,
           "bf16_rel_l2": err, "bf16_flop_bound_ms": flop_ms, "bf16_byte_bound_ms": byte_ms,
           "bf16_bound_ms": max(flop_ms, byte_ms),
           "bf16_bound_by": "operations" if flop_ms >= byte_ms else "bytes"}
    chain = (f"; {(nbytes + chain_rows * chain_row_bytes) / PEAK_BYTES_PER_S * 1e3:.3f} ms "
             f"with its float32 chain" if chain_rows else "")
    print(f"{name} bf16: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bounds {flop_ms:.3f} ms "
          f"(FLOP at 989 TFLOP/s) and {byte_ms:.3f} ms (bytes at 3.35 TB/s{chain}); "
          f"{row['bf16_bound_ms'] / ms:.3f} of the bound; {launches} launches", flush=True)
    return row


def bf16_kernels(device, cfg, model, pose, store: dict, frame_launches: dict, out: dict):
    """Phase 15a: the five kernels against their plain bf16 versions, K1-fwd
    at phase 3's 262,144 points, K4 on the first tile of the frame, K1-bwd,
    K2 and K3 on the arguments the bf16 steps gave them; their times and
    bf16 bounds into ``out``."""
    flops_per_point = classic_flops_per_point(cfg)
    packed = classic_mlp.pack_classic_params(model.mlp)
    weight_bytes = tensor_bytes(*packed.values())
    gen = torch.Generator(device=device).manual_seed(1)

    def rand_bf16(*shape):
        return (torch.rand(shape, generator=gen, device=device) * 2 - 1).bfloat16()

    def on_route(kernel, call):
        _build.policy_counts.clear()
        got = call()
        torch.cuda.synchronize()
        check(dict(_build.policy_counts) == {(kernel, "tc_bf16"): 1},
              f"{kernel} in bf16 ran its tensor-core tile or passes (tc_bf16)")
        return got

    x_enc, d_enc = rand_bf16(K1_POINTS, cfg.x_encoding_dim), rand_bf16(K1_POINTS, cfg.d_encoding_dim)
    call = lambda: classic_mlp.classic_mlp_fwd(packed, x_enc, d_enc)  # noqa: E731
    plain = lambda: classic_mlp.classic_mlp_fwd_plain(packed, x_enc, d_enc)  # noqa: E731
    got = on_route(classic_mlp.NAME, call)
    err = check_bf16_outputs(classic_mlp.NAME, [got], [plain()])
    out[classic_mlp.NAME] = bf16_row(
        classic_mlp.NAME, frame_launches[classic_mlp.NAME], err, cuda_ms(call, iters=10),
        cuda_ms(plain, iters=5), K1_POINTS * flops_per_point,
        tensor_bytes(x_enc, d_enc, got) + weight_bytes)

    rays_o, rays_d = (r.reshape(-1, 3)[: RENDER.rays_per_tile] for r in
                      pose_to_rays(*pose, IMAGE, IMAGE, FOCAL))
    k4_store = {}
    with capture_args(union_eval, "union_eval", k4_store):
        model.render_rays(rays_o, rays_d, RENDER, fused_eval=True)
    args = k4_store["union_eval"][0]
    check(args[1].dtype == args[2].dtype == torch.bfloat16,
          "the frame hands K4 bfloat16 fine and per-ray view encodings")
    got = on_route(union_eval.NAME, lambda: union_eval.union_eval(*args))
    err = check_bf16_outputs(union_eval.NAME, got, union_eval.union_eval_plain(*args))
    _, x_f, d_ray, t_c, t_f, dens_c, col_c, dnorm = args
    out[union_eval.NAME] = bf16_row(
        union_eval.NAME, frame_launches[union_eval.NAME], err,
        cuda_ms(lambda: union_eval.union_eval(*args), iters=5),
        cuda_ms(lambda: union_eval.union_eval_plain(*args), iters=3),
        t_f.numel() * flops_per_point,
        tensor_bytes(x_f, d_ray, t_c, t_f, dens_c, col_c, dnorm, *got) + weight_bytes)

    # K1-bwd on the rows and cotangents the bf16 reuse step handed it; the
    # float32 kernel on the same inputs must fail the same check (a
    # control: the check sees bf16's roundings missing).
    args, kwargs = store["classic_mlp_bwd"]
    check(without_images(kwargs) == {"input_grads": False} and args[1].dtype == torch.bfloat16,
          "the bf16 reuse step hands K1-bwd bfloat16 encodings and asks no cotangents")
    pk, x, d, g_out = args
    call = lambda: classic_mlp.classic_mlp_bwd(pk, x, d, g_out, False)  # noqa: E731
    got = on_route(classic_mlp.BWD_NAME, call)
    ref = classic_mlp.classic_mlp_bwd_plain(pk, x, d, g_out, False)
    err = check_bf16_grads(classic_mlp.BWD_NAME, got[2], ref[2])
    f32 = classic_mlp.classic_mlp_bwd(pk, x.float(), d.float(), g_out, False)[2]
    f32_err = rel_l2([f32[k] for k in ref[2]], [ref[2][k] for k in ref[2]])
    print(f"{classic_mlp.BWD_NAME} control: the float32 kernel on the same inputs, relative L2 "
          f"{f32_err:.3e} against plain bf16", flush=True)
    check(f32_err > BF16["grad_rel_l2"],
          f"{classic_mlp.BWD_NAME}: the float32 kernel fails the bf16 check (control)")
    out[classic_mlp.BWD_NAME].update(bf16_row(
        classic_mlp.BWD_NAME, out[classic_mlp.BWD_NAME]["bf16_launches"], err,
        cuda_ms(call, iters=5),
        cuda_ms(lambda: classic_mlp.classic_mlp_bwd_plain(pk, x, d, g_out, False), iters=3),
        train_step_flops(cfg, x.shape[0], 1), tensor_bytes(x, d, g_out) + 2 * weight_bytes,
        x.shape[0]))

    args, kwargs = store["classic_train_grads"]
    check(args[1].dtype == torch.bfloat16, "the bf16 coarse step hands K2 bfloat16 encodings")
    call = lambda: train_grads.classic_train_grads(*args, **kwargs)  # noqa: E731
    got = on_route(train_grads.NAME, call)
    ref = train_grads.classic_train_grads_plain(*args, **kwargs)
    check_bf16_outputs(train_grads.NAME + " loss", [got[0]], [ref[0]])
    err = check_bf16_grads(train_grads.NAME, got[1], ref[1])
    x = args[1]
    out[train_grads.NAME].update(bf16_row(
        train_grads.NAME, out[train_grads.NAME]["bf16_launches"], err, cuda_ms(call, iters=5),
        cuda_ms(lambda: train_grads.classic_train_grads_plain(*args, **kwargs), iters=3),
        train_step_flops(cfg, *x.shape[:2]),
        tensor_bytes(*args[1:6], *got[2:]) + 2 * weight_bytes + 4, x.shape[0] * x.shape[1]))

    args, kwargs = store["fine_stage_train"]
    kwargs = without_images(kwargs)
    check(args[1].dtype == args[2].dtype == torch.bfloat16,
          "the bf16 reuse step hands K3 bfloat16 encodings")
    call = lambda: fine_stage_train.fine_stage_train(*args, **kwargs)  # noqa: E731
    got = on_route(fine_stage_train.NAME, call)
    ref = fine_stage_train.fine_stage_train_plain(*args, **kwargs)
    check_bf16_outputs(fine_stage_train.NAME + " loss", [got[0]], [ref[0]])
    named = lambda r: {**r[1], "g_dens_c": r[2][0], "g_col_c": r[2][1]}  # noqa: E731
    err = check_bf16_grads(fine_stage_train.NAME, named(got), named(ref))
    x_f, d_f = args[1], args[2]
    out[fine_stage_train.NAME].update(bf16_row(
        fine_stage_train.NAME, out[fine_stage_train.NAME]["bf16_launches"], err,
        cuda_ms(call, iters=5),
        cuda_ms(lambda: fine_stage_train.fine_stage_train_plain(*args, **kwargs), iters=3),
        train_step_flops(cfg, *x_f.shape[:2]),
        tensor_bytes(x_f, d_f[:, 0], *args[3:10], *got[2]) + 2 * weight_bytes + 4,
        x_f.shape[0] * x_f.shape[1]))


def bf16_phase(device, cfg: ClassicNeRFConfig, bank, f32_image, f32_frame_ms: float,
               f32_step_ms: dict, card: str, bf16_step_ms: dict) -> dict:
    """Phase 15: the classic main path in compute_dtype bfloat16: (b) one
    400x400 frame, (c) the reuse and coarse-only train steps (their ms/step
    into ``bf16_step_ms``), then (a) each of its five kernels against its
    plain bf16 version on those paths' shapes, and (d) K2 at a latent width
    on its SIMT tile.  Returns the five kernels' bf16 row entries."""
    bf = dict(compute_dtype="bfloat16")
    model = make_model(True, device, **bf).eval().requires_grad_(False)
    pose = spherical_poses(1, radius=4.0, device=device)
    out = {}

    # b. One 400x400 frame at 64 + 128 samples.
    n_tiles = -(-IMAGE * IMAGE // RENDER.rays_per_tile)

    def render():
        return model.render_image(*pose, IMAGE, IMAGE, FOCAL, RENDER)

    render()  # warm-up
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    _build.policy_counts.clear()
    t0 = time.perf_counter()
    image = render()
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3
    frame_launches = dict(_build.launch_counts)
    print(f"bf16 frame through the kernels: {frame_ms:.1f} ms; launches {frame_launches}",
          flush=True)
    check(frame_launches == {classic_mlp.NAME: n_tiles, union_eval.NAME: n_tiles},
          f"bf16 frame: K1-fwd and K4 launched once per tile ({n_tiles} tiles), nothing else")
    check_policies("bf16 frame", frame_launches, dict(_build.policy_counts), "tc_bf16")
    with plain_versions():
        plain_image = render()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(image).all()) and float(image.std()) > 1e-3,
          f"bf16 frame is finite and not flat (std {float(image.std()):.4f})")
    err = rel_l2([image], [plain_image])
    print(f"bf16 frame against the plain bf16 frame: relative L2 {err:.3e}, max pixel difference "
          f"{float((image - plain_image).abs().max()):.3e} (bound {BF16['fwd_rel_l2']} in "
          f"relative L2)", flush=True)
    check(err <= BF16["fwd_rel_l2"], "bf16 frame matches the plain bf16 frame")
    f32_diff = (image - f32_image).abs()
    print(f"bf16 frame against phase 3's float32 kernel frame: max pixel difference "
          f"{float(f32_diff.max()):.3e}, relative L2 {rel_l2([image], [f32_image]):.3e}",
          flush=True)
    check(bool((f32_diff <= BF16["f32_atol"] + BF16["f32_rtol"] * f32_image.abs()).all()),
          f"bf16 frame within rtol {BF16['f32_rtol']}, atol {BF16['f32_atol']} of the float32 "
          f"frame at every pixel (the JAX package's bf16 bound)")
    print(f"bf16 frame: {frame_ms:.1f} ms (float32 kernels {f32_frame_ms:.1f} ms); {card}",
          flush=True)

    # c. One step of each against the plain bf16 step and the float32
    # kernel step, then the timed runs (their first calls recorded).
    store = {}
    for name, render_cfg, n_rays, expected, key in (
            ("bf16 reuse step 2048x(64+128)", TRAIN_RENDER, TRAIN_RAYS,
             {classic_mlp.NAME: 1, classic_mlp.BWD_NAME: 1, fine_stage_train.NAME: 1}, "reuse"),
            ("bf16 coarse-only step 4096x64", COARSE_RENDER, COARSE_RAYS,
             {train_grads.NAME: 1}, "coarse")):
        step_model = make_model(True, device, **bf)
        gen = torch.Generator(device=device).manual_seed(7)
        batch = bank.sample_batch(gen, n_rays)
        draws = sampling.draw_step(gen, render_cfg, n_rays, device)
        torch.cuda.synchronize()
        _build.launch_counts.clear()
        _build.policy_counts.clear()
        loss, grads, _ = make_fused_loss_and_grads(step_model, render_cfg)(batch, draws)
        torch.cuda.synchronize()
        launches = dict(_build.launch_counts)
        check(launches == expected, f"{name}: launched {expected} and nothing else")
        check_policies(name, launches, dict(_build.policy_counts), "tc_bf16")
        ref_loss, ref = bf16_step_reference(step_model, render_cfg, batch, draws)
        loss_err = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        print(f"{name}: loss {float(loss):.7g} vs plain bf16 {float(ref_loss):.7g} (rel err "
              f"{loss_err:.3e}, tolerance {BF16['loss_rtol']})", flush=True)
        check(loss_err <= BF16["loss_rtol"], f"{name}: the loss matches the plain bf16 step's")
        check_bf16_grads(name, grads, ref)
        _, f32_grads, _ = make_fused_loss_and_grads(make_model(True, device), render_cfg)(
            batch, draws)
        a = torch.cat([grads[k].double().ravel() for k in f32_grads])
        b = torch.cat([f32_grads[k].double().ravel() for k in f32_grads])
        cosine = float(a @ b / (a.norm() * b.norm()))
        print(f"{name}: gradients' cosine to the float32 kernel step's {cosine:.5f}", flush=True)
        check(cosine > BF16["f32_cosine"],
              f"{name}: gradients' cosine to float32 above {BF16['f32_cosine']}")
        step_launches, ms = train_run(name, render_cfg, n_rays, bank, device, expected, store,
                                      policy="tc_bf16", **bf)
        print(f"{name}: {ms:.2f} ms/step = {n_rays / ms * 1e3:.0f} rays/s (float32 kernels "
              f"{f32_step_ms[key]:.2f} ms/step = {n_rays / f32_step_ms[key] * 1e3:.0f} rays/s); "
              f"{card}", flush=True)
        bf16_step_ms[key] = ms
        for k, n in step_launches.items():
            out[k] = {"bf16_launches": n}

    # a. The five kernels against their plain versions.
    with torch.no_grad():
        bf16_kernels(device, cfg, model, pose, store, frame_launches, out)

    # d. K2 at the latent width 100 + 36 (density_inputs 5): its SIMT
    # fwd_store tile, the tensor-core bwd_rows and wgrad.
    lc = dict(density_inputs=5)
    lpacked = classic_mlp.pack_classic_params(
        make_model(True, device, **lc, **bf).mlp.requires_grad_(False))
    lcfg = ClassicNeRFConfig(**lc)
    gen = torch.Generator(device=device).manual_seed(15)
    n_rays, s = 1024, 64
    d_ray = torch.rand((n_rays, 1, lcfg.d_encoding_dim), generator=gen, device=device) * 2 - 1
    largs = ((torch.rand((n_rays, s, lcfg.x_encoding_dim), generator=gen, device=device) * 2
              - 1).bfloat16(),
             d_ray.bfloat16().expand(n_rays, s, -1).contiguous(),
             torch.full((n_rays, s, 1), 0.03, device=device),
             torch.rand((n_rays, s), generator=gen, device=device) * 2 - 1,
             torch.rand((n_rays, 3), generator=gen, device=device))
    with torch.no_grad():
        _build.policy_counts.clear()
        got = train_grads.classic_train_grads(lpacked, *largs, s)
        torch.cuda.synchronize()
        what = f"bf16 K2 at encodings {lcfg.x_encoding_dim} + {lcfg.d_encoding_dim}"
        print(f"{what}: tile policies {dict(_build.policy_counts)}", flush=True)
        check(dict(_build.policy_counts) == {(train_grads.NAME, "simt_bf16"): 1},
              f"{what} ran its SIMT fwd_store tile (simt_bf16)")
        ref = train_grads.classic_train_grads_plain(lpacked, *largs, s)
        check_bf16_outputs(what + " loss", [got[0]], [ref[0]])
        check_bf16_grads(what, got[1], ref[1])
    return out


# Phase 16: compute_dtype="bfloat16" for the mip family (slice 13), with
# phase 15's bounds (BF16) against the plain bf16 versions and the float32
# kernels.  The seg/acc identity is the compositing's, float32 in bf16
# too: TOL["seg_identity"].  The gradient checks run on the cotangents a
# step hands each kernel, the float32 kernel on the same inputs beside
# each (a control).  A loss's summed gradients hold float32 within the
# bf16 bound (K6, K5-bwd's weights: PERF.md), so K5-bwd is also checked on
# uniform random cotangents, where the float32 kernel fails the check, as
# it fails K5-bwd's dfeat check; and the head's rounding, the one product
# outside the tensor-core tiles, is checked directly against the float64
# products of the rounded and of the unrounded operands
# (``mip_head_check``): within MIP_HEAD["rounded"] of the rounded ones,
# and at least MIP_HEAD["ratio"] times farther from the unrounded.
MIP_HEAD = dict(rounded=2e-5, ratio=100.0, rows=4096)
# The mip chain a training kernel writes and reads back: xhat and dpre, five
# layers of 256 floats each, a row.
MIP_CHAIN_BYTES_PER_ROW = 2 * 2 * 5 * 256 * 4


def f32_control(name: str, f32: dict, ref: dict, must_fail: bool) -> float:
    """The float32 kernel's distance from the plain bf16 version on a bf16
    check's inputs, printed beside the bound; with ``must_fail`` the check
    must fail it."""
    err = rel_l2([f32[k] for k in ref], [ref[k] for k in ref])
    print(f"{name} control: the float32 kernel on the same inputs, relative L2 {err:.3e} "
          f"against plain bf16 ({'fails' if err > BF16['grad_rel_l2'] else 'passes'} the "
          f"{BF16['grad_rel_l2']} check)", flush=True)
    if must_fail:
        check(err > BF16["grad_rel_l2"], f"{name}: the float32 kernel fails the bf16 check")
    return err


def mip_head_check(packed, x) -> None:
    """The bf16 head against the float64 products of its rounded operands
    (``testing.mip_head_rounding``: head_wide, head_dh, the head's dW)."""
    g = torch.rand((x.shape[0], packed["w_out"].shape[1]), device=x.device,
                   generator=torch.Generator(device=x.device).manual_seed(21)) * 2 - 1
    checks = mip_head_rounding(packed, x, g)
    check(checks.pop("h") == 0.0, "bf16 K5-fwd's head rounds the last layer's output")
    for what, (err, err_unrounded) in checks.items():
        print(f"bf16 mip head, {what}: relative L2 {err:.3e} from the float64 product of the "
              f"rounded operands, {err_unrounded:.3e} from the unrounded one", flush=True)
        check(err <= MIP_HEAD["rounded"] and err_unrounded >= MIP_HEAD["ratio"] * err,
              f"bf16 mip head, {what}: the rounded product")


def mip_bf16_kernels(device, store: dict, out: dict) -> None:
    """Phase 16d: K7, K6, K5-fwd and K5-bwd in bf16 against their plain bf16
    versions on the arguments the frame, the fused step and the general
    step gave them, the float32 kernel on the same inputs beside each
    gradient check; the head check; their times and bf16 bounds into
    ``out``."""
    cfg = MipNeRFConfig()
    flops_per_point = mip_flops_per_point(cfg)
    packed = mip_mlp.pack_mip_params(make_mip_model(True, device).mlp.requires_grad_(False))
    weight_bytes = tensor_bytes(*packed.values())

    def on_route(kernel, call):
        _build.policy_counts.clear()
        got = call()
        torch.cuda.synchronize()
        check(dict(_build.policy_counts) == {(kernel, "tc_bf16"): 1},
              f"{kernel} in bf16 ran its tensor-core tile and passes (tc_bf16)")
        return got

    args = store["mip_eval"][0]
    check(args[1].dtype == torch.bfloat16, "the bf16 frame hands K7 bfloat16 features")
    got = on_route(mip_train.EVAL_NAME, lambda: mip_train.mip_eval(*args))
    err = check_bf16_outputs(mip_train.EVAL_NAME, got, mip_train.mip_eval_plain(*args))
    feat, dists, t_mids = args[1:4]
    out[mip_train.EVAL_NAME] = bf16_row(
        mip_train.EVAL_NAME, out[mip_train.EVAL_NAME]["bf16_launches"], err,
        cuda_ms(lambda: mip_train.mip_eval(*args), iters=5),
        cuda_ms(lambda: mip_train.mip_eval_plain(*args), iters=3),
        feat.shape[0] * feat.shape[1] * flops_per_point,
        tensor_bytes(feat, dists, t_mids, *got) + weight_bytes)

    args, kwargs = store["mip_train_grads"]
    kwargs = without_images(kwargs)
    check(args[1].dtype == torch.bfloat16, "the bf16 fused step hands K6 bfloat16 features")
    call = lambda: mip_train.mip_train_grads(*args, **kwargs)  # noqa: E731
    got = on_route(mip_train.TRAIN_NAME, call)
    ref = mip_train.mip_train_grads_plain(*args, **kwargs)
    check_bf16_outputs(mip_train.TRAIN_NAME + " loss", [got[0] + SEG_WEIGHT * got[1]],
                       [ref[0] + SEG_WEIGHT * ref[1]])
    err = check_bf16_grads(mip_train.TRAIN_NAME, got[2], ref[2])
    f32_control(mip_train.TRAIN_NAME, mip_train.mip_train_grads(
        args[0], args[1].float(), *args[2:], **kwargs)[2], ref[2], must_fail=False)
    feat = args[1]
    rows = feat.shape[0] * feat.shape[1]
    out[mip_train.TRAIN_NAME].update(bf16_row(
        mip_train.TRAIN_NAME, out[mip_train.TRAIN_NAME]["bf16_launches"], err,
        cuda_ms(call, iters=5),
        cuda_ms(lambda: mip_train.mip_train_grads_plain(*args, **kwargs), iters=3),
        train_step_flops(cfg, *feat.shape[:2], mip=True),
        tensor_bytes(*[a for a in args[1:6] if isinstance(a, torch.Tensor)]) + 2 * weight_bytes
        + 8, rows, MIP_CHAIN_BYTES_PER_ROW))

    # K5 on the rows and the loss's cotangents the bf16 general step handed
    # K5-bwd (as it calls it, without the features' cotangent; then with it).
    args, kwargs = store["mip_mlp_bwd"]
    pk, x, g_out = args
    check(x.dtype == torch.bfloat16 and not kwargs.get("input_grads", True),
          "the bf16 general step hands K5-bwd bfloat16 features and asks no dfeat")
    call = lambda: mip_mlp.mip_mlp_fwd(pk, x)  # noqa: E731
    got = on_route(mip_mlp.NAME, call)
    err = check_bf16_outputs(mip_mlp.NAME, [got], [mip_mlp.mip_mlp_fwd_plain(pk, x)])
    out[mip_mlp.NAME].update(bf16_row(
        mip_mlp.NAME, out[mip_mlp.NAME]["bf16_launches"], err, cuda_ms(call, iters=10),
        cuda_ms(lambda: mip_mlp.mip_mlp_fwd_plain(pk, x), iters=5),
        x.shape[0] * flops_per_point, tensor_bytes(x, got) + weight_bytes))

    call = lambda: mip_mlp.mip_mlp_bwd(pk, x, g_out, input_grads=False)  # noqa: E731
    got = on_route(mip_mlp.BWD_NAME, call)
    ref = mip_mlp.mip_mlp_bwd_plain(pk, x, g_out, input_grads=False)
    err = check_bf16_grads(mip_mlp.BWD_NAME, got[1], ref[1])
    f32_control(mip_mlp.BWD_NAME, mip_mlp.mip_mlp_bwd(pk, x.float(), g_out, False)[1], ref[1],
                must_fail=False)
    ms = cuda_ms(call, iters=5)
    plain_ms = cuda_ms(lambda: mip_mlp.mip_mlp_bwd_plain(pk, x, g_out, input_grads=False),
                       iters=3)
    dfeat_call = lambda: mip_mlp.mip_mlp_bwd(pk, x, g_out)  # noqa: E731
    got = on_route(mip_mlp.BWD_NAME, dfeat_call)
    ref = mip_mlp.mip_mlp_bwd_plain(pk, x, g_out)
    check(got[0].dtype == torch.bfloat16 and got[0].shape == x.shape,
          "bf16 K5-bwd's features' cotangent is bfloat16, the features' shape")
    err = max(err, check_bf16_grads(mip_mlp.BWD_NAME + " with dfeat",
                                    {"dfeat": got[0], **got[1]}, {"dfeat": ref[0], **ref[1]}))
    f32 = mip_mlp.mip_mlp_bwd(pk, x.float(), g_out)
    f32_control(mip_mlp.BWD_NAME + " dfeat", {"dfeat": f32[0]}, {"dfeat": ref[0]},
                must_fail=True)
    # Uniform random cotangents on the same rows: sums of either sign, where
    # the weight gradients keep bf16's roundings apart from float32's.
    g_rand = torch.rand(g_out.shape, device=device,
                        generator=torch.Generator(device=device).manual_seed(23)) * 2 - 1
    got = mip_mlp.mip_mlp_bwd(pk, x, g_rand, input_grads=False)[1]
    ref = mip_mlp.mip_mlp_bwd_plain(pk, x, g_rand, input_grads=False)[1]
    check_bf16_grads(mip_mlp.BWD_NAME + " on random cotangents", got, ref)
    f32_control(mip_mlp.BWD_NAME + " on random cotangents",
                mip_mlp.mip_mlp_bwd(pk, x.float(), g_rand, False)[1], ref, must_fail=True)
    print(f"{mip_mlp.BWD_NAME} bf16 with dfeat: {cuda_ms(dfeat_call, iters=5):.3f} ms", flush=True)
    out[mip_mlp.BWD_NAME].update(bf16_row(
        mip_mlp.BWD_NAME, out[mip_mlp.BWD_NAME]["bf16_launches"], err, ms, plain_ms,
        train_step_flops(cfg, x.shape[0], 1, mip=True),
        tensor_bytes(x, g_out) + 2 * weight_bytes, x.shape[0], MIP_CHAIN_BYTES_PER_ROW))

    mip_head_check(pk, x[:MIP_HEAD["rows"]].contiguous())


def mip_bf16_phase(device, keep: dict, card: str) -> dict:
    """Phase 16: the mip family in compute_dtype bfloat16: (a) one 400x400
    frame, (b) the fused step and its timed run, (c) one general-path step,
    then (d) each of its four kernels against its plain bf16 version on
    those paths' arguments, and (e) K5-fwd at 144 features on its SIMT
    tile.  Returns the four kernels' bf16 row entries."""
    bf = dict(compute_dtype="bfloat16")
    model = make_mip_model(True, device, **bf).eval().requires_grad_(False)
    pose_o, pose_r = spherical_poses(1, radius=4.0, device=device)
    out, store = {}, {}

    # a. One 400x400 frame at 64 fenceposts.
    n_tiles = -(-IMAGE * IMAGE // MIP_RENDER.rays_per_tile)

    def render():
        return model.render_image(pose_o, pose_r, IMAGE, IMAGE, FOCAL, MIP_RENDER)

    render()  # warm-up
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    _build.policy_counts.clear()
    t0 = time.perf_counter()
    rgb, seg = render()
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(_build.launch_counts)
    print(f"bf16 mip frame through the kernels: {frame_ms:.1f} ms; launches {launches}",
          flush=True)
    check(launches == {mip_train.EVAL_NAME: n_tiles},
          f"bf16 mip frame: K7 launched once per tile ({n_tiles} tiles), nothing else")
    check_policies("bf16 mip frame", launches, dict(_build.policy_counts), "tc_bf16")
    out[mip_train.EVAL_NAME] = {"bf16_launches": launches[mip_train.EVAL_NAME]}
    with plain_versions():
        plain_rgb, plain_seg = render()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(rgb).all() and torch.isfinite(seg).all())
          and float(rgb.std()) > 1e-3,
          f"bf16 mip frame is finite and not flat (std {float(rgb.std()):.4f})")
    err = rel_l2([rgb, seg], [plain_rgb, plain_seg])
    print(f"bf16 mip frame against the plain bf16 frame: relative L2 {err:.3e} (rgb and seg "
          f"together; bound {BF16['fwd_rel_l2']})", flush=True)
    check(err <= BF16["fwd_rel_l2"], "bf16 mip frame matches the plain bf16 frame")
    f32_rgb, f32_seg = keep["frame"]
    for what, got, f32 in (("rgb", rgb, f32_rgb), ("seg", seg, f32_seg)):
        diff = (got - f32).abs()
        print(f"bf16 mip frame {what} against phase 7's float32 kernel frame: max difference "
              f"{float(diff.max()):.3e}, relative L2 {rel_l2([got], [f32]):.3e}", flush=True)
        check(bool((diff <= BF16["f32_atol"] + BF16["f32_rtol"] * f32.abs()).all()),
              f"bf16 mip frame {what} within rtol {BF16['f32_rtol']}, atol {BF16['f32_atol']} "
              f"of the float32 frame everywhere (the JAX package's bf16 bound)")
    all_o, all_d = (r.reshape(-1, 3) for r in pose_to_rays(pose_o, pose_r, IMAGE, IMAGE, FOCAL))
    tile = MIP_RENDER.rays_per_tile
    with torch.no_grad(), capture_args(mip_train, "mip_eval", store):
        acc = torch.cat([model.render_rays(all_o[i:i + tile], all_d[i:i + tile], MIP_RENDER,
                                           fused_eval=True).acc
                         for i in range(0, all_o.shape[0], tile)])
    classes = model.cfg.segmentation_outputs
    lse = torch.logsumexp(seg.reshape(-1, classes), dim=-1)
    rows_per_ray = MIP_RENDER.num_coarse_samples - 1
    compare("seg_identity", [lse], [torch.log(acc + rows_per_ray * 1e-10)])
    print(f"bf16 mip frame: {frame_ms:.1f} ms (float32 kernels {keep['frame_ms']:.1f} ms); "
          f"{card}", flush=True)

    # b. One fused step against the plain bf16 step and the float32 kernel
    # step, then the timed run (its first K6 call recorded).
    bank, render_cfg = keep["bank"], MIP_TRAIN_RENDER
    step_model = make_mip_model(True, device, **bf)
    gen = torch.Generator(device=device).manual_seed(7)
    batch = bank.sample_batch(gen, MIP_RAYS)
    draws = loop.draws_for_model(gen, step_model, render_cfg, MIP_RAYS, device)
    name = "bf16 mip step 4096x64 seg 0.1"
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    _build.policy_counts.clear()
    loss, grads, _ = make_fused_loss_and_grads(step_model, render_cfg, SEG_WEIGHT)(batch, draws)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    check(launches == {mip_train.TRAIN_NAME: 1}, f"{name}: launched one K6 and nothing else")
    check_policies(name, launches, dict(_build.policy_counts), "tc_bf16")
    ref_loss, ref = bf16_step_reference(step_model, render_cfg, batch, draws, SEG_WEIGHT)
    loss_err = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    print(f"{name}: loss {float(loss):.7g} vs plain bf16 {float(ref_loss):.7g} (rel err "
          f"{loss_err:.3e}, tolerance {BF16['loss_rtol']})", flush=True)
    check(loss_err <= BF16["loss_rtol"], f"{name}: the loss matches the plain bf16 step's")
    check_bf16_grads(name, grads, ref)
    _, f32_grads, _ = make_fused_loss_and_grads(make_mip_model(True, device), render_cfg,
                                                SEG_WEIGHT)(batch, draws)
    a = torch.cat([grads[k].double().ravel() for k in f32_grads])
    b = torch.cat([f32_grads[k].double().ravel() for k in f32_grads])
    cosine = float(a @ b / (a.norm() * b.norm()))
    print(f"{name}: gradients' cosine to the float32 kernel step's {cosine:.5f}", flush=True)
    check(cosine > BF16["f32_cosine"],
          f"{name}: gradients' cosine to float32 above {BF16['f32_cosine']}")
    launches, ms = mip_train_run(name, bank, device, store, policy="tc_bf16", **bf)
    out[mip_train.TRAIN_NAME] = {"bf16_launches": launches[mip_train.TRAIN_NAME]}
    f32_ms = keep["step_ms"]
    print(f"{name}: {ms:.2f} ms/step = {MIP_RAYS / ms * 1e3:.0f} rays/s (float32 kernels "
          f"{f32_ms:.2f} ms/step = {MIP_RAYS / f32_ms * 1e3:.0f} rays/s); {card}", flush=True)

    # c. One general-path step (K5-fwd, K5-bwd) against the plain bf16 step
    # of a model with the same weights (the step updates its own).
    general = make_mip_model(True, device, **bf)
    kept = {}
    with capture_args(loop, "_apply", kept), capture_args(mip_mlp, "mip_mlp_bwd", store):
        _build.launch_counts.clear()
        _build.policy_counts.clear()
        make_train_step(general, render_cfg, SEG_WEIGHT)(
            create_train_state(general, LEARNING_RATE), batch, draws)
        torch.cuda.synchronize()
        launches = dict(_build.launch_counts)
    name = "bf16 mip general step"
    print(f"{name}: launches {launches}", flush=True)
    check(launches == {mip_mlp.NAME: 1, mip_mlp.BWD_NAME: 1},
          f"{name}: launched one K5-fwd and one K5-bwd, nothing else")
    check_policies(name, launches, dict(_build.policy_counts), "tc_bf16")
    for k in (mip_mlp.NAME, mip_mlp.BWD_NAME):
        out[k] = {"bf16_launches": launches[k]}
    _, step_grads, step_aux = kept["_apply"][0]
    same = make_mip_model(True, device, **bf)
    with plain_versions(), torch.enable_grad():
        plain_loss, _ = make_loss_fn(same, render_cfg, SEG_WEIGHT)(batch, draws)
        names, params = zip(*same.named_parameters())
        plain_grads = dict(zip(names, torch.autograd.grad(plain_loss, params)))
    loss_err = abs(float(step_aux["loss"]) - float(plain_loss)) / abs(float(plain_loss))
    print(f"{name}: loss rel err {loss_err:.3e} against plain bf16", flush=True)
    check(loss_err <= BF16["loss_rtol"], f"{name}: the loss matches the plain bf16 step's")
    check_bf16_grads(name, step_grads, plain_grads)

    # d. The four kernels against their plain versions; the head check.
    with torch.no_grad():
        mip_bf16_kernels(device, store, out)

    # e. K5-fwd at 144 features: the bf16-rounding SIMT tile (simt_bf16).
    mcfg = MipNeRFConfig(**WIDE_K5)
    mpacked = mip_mlp.pack_mip_params(make_mip_model(True, device, **WIDE_K5).mlp
                                      .requires_grad_(False))
    feat = (torch.rand((WIDE_ROWS, mcfg.feature_dim), device=device,
                       generator=torch.Generator(device=device).manual_seed(17)) * 2
            - 1).bfloat16()
    what = f"bf16 K5-fwd at {mcfg.feature_dim} features"
    with torch.no_grad():
        _build.policy_counts.clear()
        got = mip_mlp.mip_mlp_fwd(mpacked, feat)
        torch.cuda.synchronize()
        check(dict(_build.policy_counts) == {(mip_mlp.NAME, "simt_bf16"): 1},
              f"{what} ran its SIMT tile (simt_bf16)")
        check_bf16_outputs(what, [got], [mip_mlp.mip_mlp_fwd_plain(mpacked, feat)])
        print(f"{what}, {WIDE_ROWS} rows (bf16-rounding SIMT tile): "
              f"{cuda_ms(lambda: mip_mlp.mip_mlp_fwd(mpacked, feat), iters=3):.3f} ms", flush=True)
    return out



# Phase 17: compute_dtype="bfloat16" for K8-fwd, K8-bwd and K9 (slice 14),
# with phase 15's bounds (BF16) against the plain bf16 versions.  K8's raw
# points, sines and cotangents stay float32; the one new rounding point is
# the encodings, which K8-bwd and K9 write to their scratch as bfloat16:
# held bitwise against the plain version's rounded sines.  The gradient
# checks run on the cotangents a step hands each kernel, the float32 kernel
# on the same inputs beside each: it must fail K8-fwd's, K8-bwd's raw
# inputs' cotangents' and K9's, and passes K8-bwd's weights' (a loss's
# summed gradients, PERF.md).  Each row's raw inputs' cotangents sit near
# the 2e-2 bound at hidden 256, as K1-bwd's dx and dd do: sums of
# per-row products whose bf16 roundings two float32-accurate evaluations
# place differently (``scripts/torch_bf16_sensitivity.py --family
# point``).  K9's fine t-values against the plain bf16 resample in
# probability, within BF16's output bound: the two versions' bf16 coarse
# weights differ by bf16's roundings, not float32's.


def scratch_bitwise(what: str, got: torch.Tensor, want: torch.Tensor) -> None:
    same = got.dtype == want.dtype and torch.equal(got, want)
    differing = int((got != want).sum()) if got.shape == want.shape else -1
    print(f"{what}: {got.dtype} {tuple(got.shape)}, {differing} values differ from the plain "
          f"version's rounded encodings", flush=True)
    check(same, f"{what} bitwise the plain version's rounded encodings")


def point_mega_bf16_phase(device, cfg: ClassicNeRFConfig, bank, k9_step_ms: float,
                          reuse_bf16_ms: float, card: str) -> dict:
    """Phase 17: K8 and K9 in compute_dtype bfloat16: (a) K8 under autograd
    at phase 11's 262,144 raw points, (b) K8-fwd and K8-bwd against their
    plain bf16 versions with their scratch encodings, (c) one bf16 K9 step
    against the plain bf16 step and phase 15's bf16 reuse route, (d) the K9
    train loop, (e) K9 against its plain bf16 version with its time, (f)
    K8-fwd at x encodings 120 + 36 on its SIMT tile.  Returns the three
    kernels' bf16 row entries."""
    bf = dict(compute_dtype="bfloat16")
    out = {}
    args = (cfg.x_positional_encoding_size, cfg.normalize_position,
            cfg.d_positional_encoding_size, cfg.direction_bound)
    gen = torch.Generator(device=device).manual_seed(11)
    batch = bank.sample_batch(gen, K8_RAYS)
    t_vals = sampling.sample_linear(gen, (K8_RAYS,), K8_SAMPLES, TRAIN_RENDER.near,
                                    TRAIN_RENDER.far, device=device)
    points = (batch["rays_o"][:, None] + batch["rays_d"][:, None] * t_vals[..., None]).reshape(-1, 3)
    dirs = batch["rays_d"][:, None].expand(K8_RAYS, K8_SAMPLES, 3).reshape(-1, 3).contiguous()
    n_points = points.shape[0]

    # a. K8 under autograd: one K8-fwd and one K8-bwd, both tc_bf16.
    model = make_model(True, device)
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    _build.policy_counts.clear()
    store = {}
    with capture_args(point_mlp, "classic_pointmlp_bwd", store):
        density, color = point_mlp.classic_pointmlp(model, points, dirs, *args, **bf)
        loss = torch.mean((torch.sigmoid(color) - 0.5) ** 2) + torch.mean(torch.relu(density))
        grads = torch.autograd.grad(loss, list(model.parameters()))
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    name = "bf16 K8 under autograd"
    print(f"{name} at {n_points} raw points: launches {launches}", flush=True)
    check(launches == {point_mlp.NAME: 1, point_mlp.BWD_NAME: 1},
          f"{name}: one K8-fwd and one K8-bwd, nothing else")
    check_policies(name, launches, dict(_build.policy_counts), "tc_bf16")
    check(all(bool(torch.isfinite(g).all()) for g in grads) and bool(torch.isfinite(loss)),
          f"{name}: loss and gradients are finite")

    # b. K8-fwd and K8-bwd against their plain bf16 versions.
    dt = torch.bfloat16
    packed = classic_mlp.pack_classic_params(model.mlp.requires_grad_(False))
    weight_bytes = tensor_bytes(*packed.values())
    consts = point_mlp.encoding_consts(*args, device)
    flops = n_points * classic_flops_per_point(cfg)

    def on_route(kernel, call, policy="tc_bf16"):
        _build.policy_counts.clear()
        got = call()
        torch.cuda.synchronize()
        check(dict(_build.policy_counts) == {(kernel, policy): 1},
              f"{kernel} in bf16 ran its {policy} tile")
        return got

    with torch.no_grad():
        call = lambda: point_mlp.classic_pointmlp_fwd(packed, points, dirs, consts, dtype=dt)  # noqa: E731
        plain = lambda: point_mlp.classic_pointmlp_fwd_plain(packed, points, dirs, consts,  # noqa: E731
                                                              dtype=dt)
        got = on_route(point_mlp.NAME, call)
        err = check_bf16_outputs(point_mlp.NAME, [got], [plain()])
        f32_err = rel_l2([point_mlp.classic_pointmlp_fwd(packed, points, dirs, consts)],
                         [plain()])
        print(f"{point_mlp.NAME} control: the float32 kernel on the same inputs, relative L2 "
              f"{f32_err:.3e} against plain bf16", flush=True)
        check(f32_err > BF16["fwd_rel_l2"],
              f"{point_mlp.NAME}: the float32 kernel fails the bf16 check")
        out[point_mlp.NAME] = bf16_row(
            point_mlp.NAME, launches[point_mlp.NAME], err, cuda_ms(call, iters=10),
            cuda_ms(plain, iters=5), flops,
            tensor_bytes(points, dirs, got, *consts) + weight_bytes)

    # K8-bwd on the cotangents the autograd step handed it, with the raw
    # inputs' cotangents (float32) and, as the step calls it, without.
    g_step = store["classic_pointmlp_bwd"][0][4].detach()
    keep = {}
    got = on_route(point_mlp.BWD_NAME, lambda: point_mlp.classic_pointmlp_bwd(
        packed, points, dirs, consts, g_step, dtype=dt, keep=keep))
    for key, want in zip(("x_enc", "d_enc"),
                         point_mlp.rounded_encodings(points, dirs, consts, dt)):
        scratch_bitwise(f"bf16 K8-bwd's scratch {key}", keep[key], want)
    check(got[0].dtype == got[1].dtype == torch.float32,
          "bf16 K8-bwd's raw inputs' cotangents are float32")
    ref = point_mlp.classic_pointmlp_bwd_plain(packed, points, dirs, consts, g_step, dtype=dt)
    f32 = point_mlp.classic_pointmlp_bwd(packed, points, dirs, consts, g_step)
    raw = lambda r: {"dpoints": r[0], "ddirs": r[1]}  # noqa: E731
    errs = [check_bf16_grads(point_mlp.BWD_NAME + " weights", got[2], ref[2])]
    f32_control(point_mlp.BWD_NAME + " weights", f32[2], ref[2], must_fail=False)
    errs.append(check_bf16_grads(point_mlp.BWD_NAME + " raw inputs' cotangents", raw(got),
                                 raw(ref)))
    f32_control(point_mlp.BWD_NAME + " raw inputs' cotangents", raw(f32), raw(ref),
                must_fail=True)
    no_input = lambda: point_mlp.classic_pointmlp_bwd(  # noqa: E731
        packed, points, dirs, consts, g_step, input_grads=False, dtype=dt)
    got = on_route(point_mlp.BWD_NAME, no_input)
    ref = point_mlp.classic_pointmlp_bwd_plain(packed, points, dirs, consts, g_step,
                                               input_grads=False, dtype=dt)
    errs.append(check_bf16_grads(point_mlp.BWD_NAME + " without the raw cotangents", got[2],
                                 ref[2]))
    call = lambda: point_mlp.classic_pointmlp_bwd(packed, points, dirs, consts, g_step,  # noqa: E731
                                                  dtype=dt)
    ms, no_input_ms = cuda_ms(call, iters=5), cuda_ms(no_input, iters=5)
    print(f"{point_mlp.BWD_NAME} bf16: {ms:.3f} ms with the raw inputs' cotangents, "
          f"{no_input_ms:.3f} ms without (as the step calls it), at {n_points} points",
          flush=True)
    out[point_mlp.BWD_NAME] = bf16_row(
        point_mlp.BWD_NAME, launches[point_mlp.BWD_NAME], max(errs), ms,
        cuda_ms(lambda: point_mlp.classic_pointmlp_bwd_plain(packed, points, dirs, consts,
                                                              g_step, dtype=dt), iters=3),
        3 * flops, tensor_bytes(points, dirs, g_step, *got[:2], *consts) + 2 * weight_bytes,
        n_points)

    # c. One bf16 K9 step against the plain bf16 step (its own fine
    # t-values held), the plain resample, phase 15's bf16 reuse route and
    # the float32 K9 step.
    render, n_rays = TRAIN_RENDER, TRAIN_RAYS
    gen = torch.Generator(device=device).manual_seed(7)
    batch = bank.sample_batch(gen, n_rays)
    draws = sampling.draw_step(gen, render, n_rays, device)
    model = make_model(True, device, **bf)
    name = "bf16 K9 step 2048x(64+128)"
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    _build.policy_counts.clear()
    loss, grads, aux = mega_train.mega_train_loss_and_grads(model, render, batch, draws,
                                                            emit_t_fine=True)
    torch.cuda.synchronize()
    step_launches = dict(_build.launch_counts)
    check(step_launches == {mega_train.NAME: 1}, f"{name}: one mega_train launch, nothing else")
    check_policies(name, step_launches, dict(_build.policy_counts), "tc_bf16")
    inputs = mega_train.mega_inputs(model, batch, draws)
    x_enc_c, d_ray, t_c, noise_c, u, _, rays_o, rays_d, _, placement, is_cos = inputs
    check(x_enc_c.dtype == d_ray.dtype == dt, f"{name}: bfloat16 coarse and view encodings")
    packed = classic_mlp.pack_classic_params(model.mlp.requires_grad_(False))
    keep = {}
    with torch.no_grad():
        k_loss_c, k_loss_f, k_grads, t_fine = on_route(
            mega_train.NAME, lambda: mega_train.mega_train(packed, *inputs, keep=keep))
    check(torch.equal(t_fine, aux["t_fine"]) and torch.equal(k_loss_c + k_loss_f, loss),
          f"{name}: the wrapper's call repeats the step bitwise")
    scratch_bitwise("bf16 K9's scratch encodings (coarse, then fine at its t-values)",
                    keep["x_all"], torch.cat([x_enc_c, mega_train.encode_fine_plain(
                        t_fine, rays_o, rays_d, placement, is_cos).to(dt)]))
    p_loss_c, p_loss_f, p_grads, _ = mega_train.mega_train_plain(packed, *inputs, t_fine=t_fine)
    loss_err = abs(float(loss) - float(p_loss_c + p_loss_f)) / abs(float(p_loss_c + p_loss_f))
    print(f"{name}: loss {float(loss):.7g} vs plain bf16 {float(p_loss_c + p_loss_f):.7g} (rel "
          f"err {loss_err:.3e}, tolerance {BF16['loss_rtol']})", flush=True)
    check(loss_err <= BF16["loss_rtol"], f"{name}: the loss matches the plain bf16 step's")
    k9_err = check_bf16_grads(mega_train.NAME, k_grads, p_grads)
    # The float32 kernel on the same inputs, against the plain bf16 step at
    # its own fine t-values.
    *_, k9_f32, f32_t = mega_train.mega_train(packed, x_enc_c.float(), d_ray.float(),
                                              *inputs[2:])
    f32_control(mega_train.NAME, k9_f32,
                mega_train.mega_train_plain(packed, *inputs, t_fine=f32_t)[2],
                must_fail=True)
    weights_c = mega_train.coarse_weights_plain(packed, x_enc_c, d_ray, t_c, noise_c, rays_d)
    bins = 0.5 * (t_c[:, 1:] + t_c[:, :-1])
    mass = float((sampling.pdf_cdf_at(bins, weights_c[:, 1:-1], t_fine) - u).abs().max())
    print(f"{name}: the plain bf16 cdf at the kernel's fine t-values is within {mass:.3e} of the "
          f"uniforms (bound {BF16['fwd_rel_l2']})", flush=True)
    check(mass <= BF16["fwd_rel_l2"], f"{name}: the fine t-values match the plain bf16 resample")
    model.requires_grad_(True)
    r_loss, r_grads, _ = fine_stage_train.reuse_train_loss_and_grads(model, render, batch, draws)
    loss_err = abs(float(loss) - float(r_loss)) / abs(float(r_loss))
    print(f"{name} against phase 15's bf16 reuse route: loss rel err {loss_err:.3e} "
          f"(tolerance {BF16['loss_rtol']})", flush=True)
    check(loss_err <= BF16["loss_rtol"], f"{name}: the loss matches the bf16 reuse route's")
    check_bf16_grads(name + " against the bf16 reuse route", grads, r_grads)
    _, f32_grads, _ = mega_train.mega_train_loss_and_grads(make_model(True, device), render,
                                                           batch, draws)
    a = torch.cat([grads[k].double().ravel() for k in f32_grads])
    b = torch.cat([f32_grads[k].double().ravel() for k in f32_grads])
    cosine = float(a @ b / (a.norm() * b.norm()))
    print(f"{name}: gradients' cosine to the float32 K9 step's {cosine:.5f}", flush=True)
    check(cosine > BF16["f32_cosine"],
          f"{name}: gradients' cosine to float32 above {BF16['f32_cosine']}")

    # d. The K9 train loop in bf16.
    loop_launches, ms = mega_run("train 2048x(64+128) bf16 K9", bank, device, reuse_bf16_ms,
                                 policy="tc_bf16", **bf)
    print(f"bf16 K9 loop: {ms:.2f} ms/step = {n_rays / ms * 1e3:.0f} rays/s (float32 K9, phase "
          f"12: {k9_step_ms:.2f} ms/step = {n_rays / k9_step_ms * 1e3:.0f} rays/s; bf16 reuse "
          f"route, phase 15: {reuse_bf16_ms:.2f} ms/step = {n_rays / reuse_bf16_ms * 1e3:.0f} "
          f"rays/s); {card}", flush=True)

    # e. K9 against its plain bf16 version, timed.
    with torch.no_grad():
        kernel_ms = cuda_ms(lambda: mega_train.mega_train(packed, *inputs), iters=5)
        plain_ms = cuda_ms(lambda: mega_train.mega_train_plain(packed, *inputs), iters=3)
    sc, sf = render.num_coarse_samples, render.num_fine_samples
    out[mega_train.NAME] = bf16_row(
        mega_train.NAME, loop_launches[mega_train.NAME], k9_err, kernel_ms, plain_ms,
        train_step_flops(cfg, n_rays, sc + sf),
        tensor_bytes(*[x for x in inputs if x is not None], t_fine) + 8
        + 2 * tensor_bytes(*packed.values()), n_rays * (sc + sf))

    # f. K8-fwd at x encodings 120 + 36: the bf16-rounding SIMT tile.
    wcfg = ClassicNeRFConfig(normalize_position=6.0, **WIDE_K8)
    wpacked = classic_mlp.pack_classic_params(make_model(True, device, **WIDE_K8).mlp
                                              .requires_grad_(False))
    wconsts = point_mlp.encoding_consts(wcfg.x_positional_encoding_size, wcfg.normalize_position,
                                        wcfg.d_positional_encoding_size, wcfg.direction_bound,
                                        device)
    wpts, wdirs = points[:WIDE_ROWS].contiguous(), dirs[:WIDE_ROWS].contiguous()
    what = f"bf16 K8-fwd at encodings {wcfg.x_encoding_dim} + {wcfg.d_encoding_dim}"
    with torch.no_grad():
        call = lambda: point_mlp.classic_pointmlp_fwd(wpacked, wpts, wdirs, wconsts, dtype=dt)  # noqa: E731
        got = on_route(point_mlp.NAME, call, "simt_bf16")
        check_bf16_outputs(what, [got], [point_mlp.classic_pointmlp_fwd_plain(
            wpacked, wpts, wdirs, wconsts, dtype=dt)])
        print(f"{what}, {WIDE_ROWS} rows (bf16-rounding SIMT tile): "
              f"{cuda_ms(call, iters=3):.3f} ms", flush=True)
    return out

# Phase 18: data parallelism (slice 15).  (a) One rank over NCCL in this
# process: every step's loss and gradients bitwise those of the step
# without a mesh (at one rank the all_reduce and the division by 1 change
# no bit).  (b) Two spawned ranks over gloo sharing cuda:0 (NCCL refuses
# two ranks on one GPU): each half of the global batch through the real
# kernels, against the single-process kernel step: the loss within rtol
# 1e-5 (two partial means of 1024 or 2048 rows summed, in another order),
# the gradients within relative L2 1e-4 (the kernels' row sums regroup);
# the frame within 1e-5 of (a)'s (each row's pixel is the same kernels'
# on the same inputs, rendered in a call of another size).
DP_LOSS_RTOL, DP_GRAD_REL_L2, DP_FRAME_ATOL = 1e-5, 1e-4, 1e-5
DP_RANKS = 2
DP_CHILD_TIMEOUT_S = 420
# cell: (render, rays, segmentation weight, the kernels one step launches)
DP_CELLS = {
    "reuse 2048x(64+128)": (TRAIN_RENDER, TRAIN_RAYS, 0.0,
                            {"classic_mlp_fwd": 1, "classic_mlp_bwd": 1, "fine_stage_train": 1}),
    "coarse-only 4096x64": (COARSE_RENDER, COARSE_RAYS, 0.0, {"train_grads": 1}),
    "mip 4096x64 seg 0.1": (MIP_TRAIN_RENDER, MIP_RAYS, SEG_WEIGHT, {"mip_train_grads": 1}),
}


def dp_model(cell: str, device):
    return make_mip_model(True, device) if cell.startswith("mip") else make_model(True, device)


def dp_global_step(cell: str, bank, device):
    """The global batch and draws of one step of ``cell``, from seed 21."""
    render, n_rays, _, _ = DP_CELLS[cell]
    gen = torch.Generator(device=device).manual_seed(21)
    batch = bank.sample_batch(gen, n_rays)
    return batch, loop.draws_for_model(gen, dp_model(cell, device), render, n_rays, device)


def flat_grads(grads: dict) -> torch.Tensor:
    return torch.cat([g.reshape(-1) for g in grads.values()])


def dp_bitwise_steps(cell: str, bank, mip_bank, device, mesh, steps: int) -> None:
    """``steps`` steps of ``cell`` without a mesh and through the one-rank
    mesh from the same state: every step's loss and gradients bitwise."""
    render, n_rays, seg, _ = DP_CELLS[cell]
    bank = mip_bank if cell.startswith("mip") else bank
    single = create_train_state(dp_model(cell, device), LEARNING_RATE, seed=3)
    sharded = parallel.prepare_parallel_state(
        create_train_state(dp_model(cell, device), LEARNING_RATE, seed=3), mesh)
    one = make_fused_loss_and_grads(single.model, render, seg)
    dp = parallel.make_parallel_loss_and_grads(sharded.model, render, mesh, seg, fused=True)
    for i in range(steps):
        batch, draws = loop._sample(single, bank, n_rays, render)
        loss, grads, aux = one(batch, draws)
        d_loss, d_grads, d_aux = dp(parallel.shard_batch(batch, mesh),
                                    parallel.shard_draws(draws, mesh))
        same = torch.equal(loss, d_loss) and grads.keys() == d_grads.keys() and all(
            torch.equal(grads[k], d_grads[k]) for k in grads)
        if not same:
            check(False, f"DP {cell} step {i}: loss and gradients bitwise the step without a "
                         f"mesh (loss {float(loss):.9g} vs {float(d_loss):.9g})")
        loop._apply(single, grads, aux)
        loop._apply(sharded, d_grads, d_aux)
    check(True, f"DP {cell}: {steps} steps' losses and gradients bitwise the steps without a "
                f"mesh at one rank")


def dp_trainer_run(cell: str, bank, mip_bank, device, mesh):
    """``Trainer(mesh=mesh)`` (``mesh`` None: the plain ``Trainer``) on
    ``cell``: 2 warm-up steps, then 20 timed with the counters zeroed just
    before.  Returns (launches, ms/step)."""
    render, n_rays, seg, expected = DP_CELLS[cell]
    bank = mip_bank if cell.startswith("mip") else bank
    cfg = TrainConfig(batch_size=n_rays, learning_rate=LEARNING_RATE,
                      num_steps=WARMUP_STEPS + TIMED_STEPS, log_interval=1000,
                      eval_interval=1000, checkpoint_interval=1000, seed=0)
    trainer = Trainer(dp_model(cell, device), render, cfg, segmentation_loss_weight=seg,
                      mesh=mesh)
    state = trainer.fit(bank, num_steps=WARMUP_STEPS)
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    _build.policy_counts.clear()
    t0 = time.perf_counter()
    state = trainer.fit(bank, state=state)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    launches, policies = dict(_build.launch_counts), dict(_build.policy_counts)
    what = f"DP {cell}: Trainer({'' if mesh is None else 'mesh=...'})"
    record = trainer.metrics.history[-1]
    check(state.step == WARMUP_STEPS + TIMED_STEPS and np.isfinite(record["loss"]),
          f"{what} ran to step {state.step}, loss {record['loss']:.6f}")
    check(launches == {k: v * TIMED_STEPS for k, v in expected.items()},
          f"{what}: each step launched {expected} and nothing else ({launches})")
    check_policies(what, launches, policies, "tc")
    return launches, ms


def dp_child(rank: int, init_method: str, work: str, device: torch.device) -> None:
    """One of phase 18(b)'s ranks (spawned): gloo on ``device``, shared
    with the other rank; its half of each cell's global batch
    (``dp_inputs.pt``) through the kernels, 3 Trainer-style steps, and its
    half of the sharded frame; writes ``rank<r>.pt``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parallel.initialize(backend="gloo", init_method=init_method, world_size=DP_RANKS, rank=rank,
                        device=device, timeout_s=DP_CHILD_TIMEOUT_S)
    try:
        mesh = parallel.make_mesh(DP_RANKS)
        inputs = torch.load(os.path.join(work, "dp_inputs.pt"), map_location=device)
        banks = {name: RayBank(**fields) for name, fields in inputs["banks"].items()}
        out = {}
        for cell in ("reuse 2048x(64+128)", "mip 4096x64 seg 0.1"):
            render, n_rays, seg, _ = DP_CELLS[cell]
            batch, draws = inputs[cell]
            model = dp_model(cell, device)
            fn = parallel.make_parallel_loss_and_grads(model, render, mesh, seg, fused=True)
            loss, grads, _ = fn(parallel.shard_batch(batch, mesh),
                                parallel.shard_draws(sampling.StepDraws(*draws), mesh))
            state = parallel.prepare_parallel_state(
                create_train_state(model, LEARNING_RATE, seed=3), mesh)
            bank = banks["mip" if cell.startswith("mip") else "classic"]
            parallel.make_parallel_multi_step_train_fn(model, render, bank, n_rays, mesh, 3, seg,
                                                       fused=True)(state)
            out[cell] = {"loss": loss.cpu(), "grads": {k: g.cpu() for k, g in grads.items()},
                         "weights": torch.cat([p.detach().reshape(-1)
                                               for p in model.parameters()]).cpu()}
        pose_o, pose_r = spherical_poses(1, radius=4.0, device=device)
        out["frame"] = parallel.render_image_sharded(make_model(True, device), mesh, pose_o,
                                                     pose_r, IMAGE, IMAGE, FOCAL, RENDER).cpu()
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        parallel.shutdown()


def dp_two_ranks(bank, mip_bank, device, frame_a) -> None:
    """Phase 18(b): two spawned ranks over gloo on cuda:0 against the
    single-process kernel step on the same global batch and draws."""
    import multiprocessing
    import socket

    with tempfile.TemporaryDirectory() as work:
        inputs = {"banks": {name: {f.name: getattr(b, f.name) for f in
                                   dataclasses.fields(RayBank)}
                            for name, b in (("classic", bank), ("mip", mip_bank))}}
        want = {}
        for cell in ("reuse 2048x(64+128)", "mip 4096x64 seg 0.1"):
            render, _, seg, _ = DP_CELLS[cell]
            batch, draws = dp_global_step(cell, mip_bank if cell.startswith("mip") else bank,
                                          device)
            inputs[cell] = (batch, tuple(draws))
            loss, grads, _ = make_fused_loss_and_grads(dp_model(cell, device), render, seg)(
                batch, draws)
            want[cell] = (loss, grads)
        torch.save(inputs, os.path.join(work, "dp_inputs.pt"))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=dp_child, args=(r, f"tcp://127.0.0.1:{port}", work, device))
                 for r in range(DP_RANKS)]
        t0 = time.perf_counter()
        for proc in procs:
            proc.start()
        try:
            for proc in procs:
                proc.join(DP_CHILD_TIMEOUT_S)
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        codes = [proc.exitcode for proc in procs]
        check(codes == [0] * DP_RANKS, f"DP two ranks over gloo on {device} ran and exited 0 "
                                       f"(exit codes {codes}, {time.perf_counter() - t0:.1f} s)")
        outs = [torch.load(os.path.join(work, f"rank{r}.pt")) for r in range(DP_RANKS)]
    for cell, (loss, grads) in want.items():
        got = outs[0][cell]
        loss_err = abs(float(got["loss"]) - float(loss)) / abs(float(loss))
        rel = {k: float((got["grads"][k] - g.cpu()).norm() / g.norm().clamp_min(1e-30))
               for k, g in grads.items()}
        worst = max(rel, key=rel.get)
        print(f"DP {cell} at {DP_RANKS} ranks (gloo, {device}) against the single-process kernel "
              f"step: loss {float(got['loss']):.9g} vs {float(loss):.9g} (rel err {loss_err:.3e}, "
              f"tolerance {DP_LOSS_RTOL}); gradients worst relative L2 {rel[worst]:.3e} ({worst}), "
              f"whole {float((flat_grads(got['grads']) - flat_grads(grads).cpu()).norm() / flat_grads(grads).norm()):.3e}, "
              f"tolerance {DP_GRAD_REL_L2}", flush=True)
        check(loss_err <= DP_LOSS_RTOL and rel[worst] <= DP_GRAD_REL_L2,
              f"DP {cell} at {DP_RANKS} ranks matches the single-process kernel step")
        check(all(torch.equal(o[cell]["loss"], got["loss"]) for o in outs[1:])
              and all(torch.equal(o[cell]["weights"], got["weights"]) for o in outs[1:]),
              f"DP {cell}: both ranks' losses, and weights after 3 steps, bitwise equal")
    frame_err = float((outs[0]["frame"] - frame_a.cpu()).abs().max())
    print(f"DP frame at {DP_RANKS} ranks against one rank: max pixel difference {frame_err:.3e} "
          f"(tolerance {DP_FRAME_ATOL})", flush=True)
    check(frame_err <= DP_FRAME_ATOL and torch.equal(outs[0]["frame"], outs[1]["frame"]),
          f"DP frame at {DP_RANKS} ranks: both ranks' frames equal and within {DP_FRAME_ATOL} "
          f"of one rank's")


def data_parallel_phase(device, bank, mip_bank, step_ms: dict, mip_step_ms: float,
                        card: str) -> dict:
    """Phase 18: (a) one rank over NCCL, (b) two ranks over gloo.  Returns
    each kernel's launches in (a)'s timed runs and frame."""
    parallel.initialize()  # no launcher environment: a group of one on cuda:0
    try:
        mesh = parallel.make_mesh()
        check(dist.get_backend() == "nccl" and mesh.size == 1
              and mesh.device == torch.device("cuda", torch.cuda.current_device()),
              f"DP: an NCCL group of one on {mesh.device}")
        total = collections.Counter()
        for cell, (render, n_rays, seg, expected) in DP_CELLS.items():
            dp_bitwise_steps(cell, bank, mip_bank, device, mesh, WARMUP_STEPS + TIMED_STEPS)
            # The mesh's runs between two of the plain Trainer's: the host
            # clock spreads by several ms from run to run.
            times = {None: [], "mesh": []}
            for run_mesh in (None, mesh, mesh, None):
                launches, ms = dp_trainer_run(cell, bank, mip_bank, device, run_mesh)
                times[None if run_mesh is None else "mesh"].append(ms)
                if run_mesh is not None and len(times["mesh"]) == 1:
                    total.update(launches)
            dp_ms, plain_ms = np.mean(times["mesh"]), np.mean(times[None])
            before = (mip_step_ms if cell.startswith("mip") else
                      step_ms["coarse" if cell.startswith("coarse") else "reuse"])
            print(f"DP {cell} at one rank (NCCL): Trainer(mesh=...) "
                  f"{', '.join(f'{t:.2f}' for t in times['mesh'])} ms/step, mean {dp_ms:.2f} = "
                  f"{n_rays / dp_ms * 1e3:.0f} rays/s; Trainer() before and after "
                  f"{', '.join(f'{t:.2f}' for t in times[None])}, mean {plain_ms:.2f} = "
                  f"{n_rays / plain_ms * 1e3:.0f} rays/s (ratio {dp_ms / plain_ms:.4f}); phases "
                  f"4, 5, 8: {before:.2f} ms/step = {n_rays / before * 1e3:.0f} rays/s; {card}",
                  flush=True)
            model = dp_model(cell, device)
            grads = [torch.rand_like(p) for p in model.parameters()]
            flat = torch.cat([g.reshape(-1) for g in grads])
            reduce_ms = cuda_ms(lambda: dist.all_reduce(flat), iters=50)
            average_ms = cuda_ms(lambda: flat_collective(grads, mesh, "mean"), iters=50)
            print(f"DP {cell}: all_reduce of the {flat.numel()} gradient floats "
                  f"({flat.numel() * 4 / 1e6:.2f} MB) {reduce_ms:.4f} ms, the whole average "
                  f"(pack, all_reduce, divide, unpack) {average_ms:.4f} ms (CUDA events)",
                  flush=True)

        # The frame split over the mesh (no K4: render_rays without
        # fused_eval, as the JAX package renders a shard).
        model = make_model(True, device).eval().requires_grad_(False)
        pose_o, pose_r = spherical_poses(1, radius=4.0, device=device)

        def frame():
            return parallel.render_image_sharded(model, mesh, pose_o, pose_r, IMAGE, IMAGE,
                                                 FOCAL, RENDER)

        frame()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.launch_counts.clear()
        _build.policy_counts.clear()
        t0 = time.perf_counter()
        image = frame()
        torch.cuda.synchronize()
        frame_ms = (time.perf_counter() - t0) * 1e3
        launches, policies = dict(_build.launch_counts), dict(_build.policy_counts)
        total.update(launches)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(launches == {"classic_mlp_fwd": 2},
              f"DP frame: one K1-fwd for the coarse and one for the fine samples ({launches})")
        check_policies("DP frame", launches, policies, "tc")
        plain = make_model(False, device).eval().requires_grad_(False)
        plain_image = plain.render_image(pose_o, pose_r, IMAGE, IMAGE, FOCAL, RENDER)
        pixel_err = float((image - plain_image).abs().max())
        print(f"DP frame {IMAGE}x{IMAGE} at one rank: {frame_ms:.1f} ms, "
              f"{IMAGE * IMAGE * RENDER.num_coarse_samples} coarse and "
              f"{IMAGE * IMAGE * RENDER.num_fine_samples} fine rows in one K1-fwd each, peak "
              f"{peak_gb:.2f} GB; max "
              f"pixel difference from the plain render {pixel_err:.3e} (tolerance "
              f"{TOL['frame']['atol']}); {card}", flush=True)
        check(image.shape == (1, IMAGE, IMAGE, 3) and bool(torch.isfinite(image).all())
              and pixel_err <= TOL["frame"]["atol"],
              "DP frame: finite, and within the frame tolerance of the plain render")
    finally:
        parallel.shutdown()
    dp_two_ranks(bank, mip_bank, device, image)
    return dict(total)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    # 1. The card.
    card = nvidia_smi("name,power.limit")
    props = torch.cuda.get_device_properties(0)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    print(f"card: {card}; {props.multi_processor_count} SMs, max SM clock {clock_mhz:.0f} MHz, "
          f"fp32 FMA peak {props.multi_processor_count * 128 * 2 * clock_mhz / 1e6:.1f} TFLOP/s "
          f"(bounds use the published {PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s float32, "
          f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s TF32, so {PEAK_3XTF32_FLOPS / 1e12:.0f} TFLOP/s "
          f"for 3xTF32, and {PEAK_BYTES_PER_S / 1e12:.2f} TB/s)", flush=True)

    # 2. Build.
    t0 = time.perf_counter()
    reports = _build.build()
    print(f"built {', '.join(_build.KERNELS)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, report in reports.items():
        for label, usage in ptxas_usage(report):
            print(f"  {name}: {label}: {usage}")
    for name in _build.KERNELS:
        _build.load(name)

    cfg = ClassicNeRFConfig(normalize_position=6.0)
    rows, f32_image, f32_frame_ms = serving(device, classic_flops_per_point(cfg))
    train_rows, bank, step_ms = training(device, cfg)
    rows.update(train_rows)
    mip_keep = {}
    rows.update(mip_phases(device, mip_keep))
    rows.update(point_mlp_phase(device, cfg, bank))
    mega_row, k9_step_ms = mega_phase(device, cfg, bank, step_ms["reuse"])
    rows.update(mega_row)
    latent_phase(device, bank)
    wide_forward_phase(device)
    cli_launches = entry_points_phase(device, card)
    bf16_step_ms = {}
    bf16 = bf16_phase(device, cfg, bank, f32_image, f32_frame_ms, step_ms, card, bf16_step_ms)
    bf16.update(mip_bf16_phase(device, mip_keep, card))
    bf16.update(point_mega_bf16_phase(device, cfg, bank, k9_step_ms, bf16_step_ms["reuse"],
                                      card))
    dp_launches = data_parallel_phase(device, bank, mip_keep["bank"], step_ms,
                                      mip_keep["step_ms"], card)

    # 19. Result lines.
    kernels = [kernel_row(name, launches, **row) for name, (launches, row) in rows.items()]
    for row in kernels:
        row["cli_launches"] = cli_launches.get(row["name"], 0)
        row["dp_launches"] = dp_launches.get(row["name"], 0)
        row.update(bf16.get(row["name"], dict.fromkeys(BF16_ROW_KEYS)))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed:
        sys.exit(1)
