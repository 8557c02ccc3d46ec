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
15. Prints the kernels' JSON line (each row with its float32 bound and
   its 3xTF32 tensor-core bound, ``bound_tc_ms``, the achieved share of
   each, ``products``: how its MLP products run, and since which slice,
   and ``cli_launches``: its launches in phase 14), the card line, then,
   last, the device line.

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

import contextlib
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

from nerf_tpu_torch import ClassicNeRF, ClassicNeRFConfig, MipNeRF, MipNeRFConfig, RenderConfig
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
from nerf_tpu_torch.train import (
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
PRODUCTS = {
    "classic_mlp_fwd": "3xTF32 (slice 7)", "union_eval": "3xTF32 (slice 5)",
    "classic_mlp_bwd": "3xTF32 (slice 7); float32 SIMT with the encodings' cotangents",
    "train_grads": "3xTF32 (slice 6)", "fine_stage_train": "3xTF32 (slice 6)",
    "mip_mlp_fwd": "3xTF32 (slice 10)", "mip_mlp_bwd": "3xTF32 (slice 9)",
    "mip_eval": "3xTF32 (slice 8)", "mip_train_grads": "3xTF32 (slice 8)",
    "classic_pointmlp_fwd": "3xTF32 (slice 10)", "classic_pointmlp_bwd": "3xTF32 (slice 9)",
    "mega_train": "3xTF32 (slice 5)",
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
    """A mangled kernel name's last identifier and int template argument:
    ``_ZN8nerf_mlp15bwd_rows_kernelILi256EE...`` -> ``bwd_rows_kernel<256>``."""
    i, parts = mangled.find("N") + 1, []
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        parts.append(mangled[j:j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
    arg = re.match(r"ILi(\d+)E", mangled[i:])
    label = parts[-1] if parts else mangled
    return f"{label}<{arg.group(1)}>" if arg else label


# The passes of the MLP kernels by kernel name, for reports and profiles:
# every kernel's products run on the tensor cores (csrc/tc_mlp.cuh; their
# float32 SIMT fwd_store, K1-fwd, K8-fwd, K4 and mip forward tiles serve
# encodings or features too wide for it, and K1-bwd's SIMT passes the
# encodings' cotangents).
PASSES = {
    "fwd_tc_kernel": "K1-fwd / K8-fwd tile, 3xTF32 wgmma",
    "fwd_simt_kernel": "K1-fwd / K8-fwd tile, fp32 SIMT (wide encodings)",
    "fwd_store_tc_kernel": "fwd_store, 3xTF32 wgmma",
    "bwd_rows_tc_kernel": "bwd_rows, 3xTF32 wgmma",
    "wgrad_tc_kernel": "wgrad, 3xTF32 wgmma",
    "union_eval_kernel": "K4 tile, 3xTF32 wgmma MLP + compositing",
    "union_eval_simt_kernel": "K4 tile, fp32 SIMT MLP (wide encodings) + compositing",
    "fwd_store_kernel": "fwd_store, fp32 SIMT",
    "bwd_rows_kernel": "bwd_rows, fp32 SIMT",
    "wgrad_kernel": "wgrad, fp32 SIMT",
    "colsum_kernel": "colsum",
    "mip_fwd_store_tc_kernel": "mip fwd_store (K5-bwd, K6), 3xTF32 wgmma",
    "mip_fwd_tc_kernel": "mip forward tile (K5-fwd, K7), 3xTF32 wgmma",
    "mip_bwd_rows_tc_kernel": "mip bwd_rows (K5-bwd, K6), 3xTF32 wgmma",
    "mip_fwd_kernel": "mip forward tile, fp32 SIMT (wide features)",
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


def make_mip_model(use_pallas: bool, device) -> MipNeRF:
    cfg = MipNeRFConfig(use_pallas=use_pallas)
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
    return {"classic_mlp_fwd": (launches["classic_mlp_fwd"], k1),
            "union_eval": (launches["union_eval"], k4)}


def train_run(name, render, n_rays, bank, device, expected: dict, store: dict):
    """Warm-up then timed fused steps; the counters are zeroed just before
    the timed steps.  The loss of one fixed probe batch (fixed draws) is
    taken before and after the run.  The first call of each wrapper in the
    warm-up has its arguments recorded in ``store``.  Returns (launches, ms
    per step)."""
    model = make_model(True, device)
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
    check_policies(name, launches, policies, "tc")
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
    return rows, bank, reuse_ms


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


def mip_serving(device, flops_per_point: int) -> dict:
    """Phase 7: K7 against its plain version, then the mip frame.  Returns
    K7's row."""
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
    return {"mip_eval": (launches["mip_eval"], k7)}


def mip_training(device, store: dict) -> dict:
    """Phases 8 and 9.  Returns the launches of the timed fused steps and of
    the general-path step; the first call of K6 in the warm-up has its
    arguments recorded in ``store``."""
    t0 = time.perf_counter()
    scene = synthesize_scene(num_views=8, image_hw=64, focal=80.0, with_labels=True,
                             device=device)
    bank = RayBank.from_images(scene.images, scene.pose_o, scene.pose_r, scene.focal,
                               labels=scene.labels)
    torch.cuda.synchronize()
    print(f"labelled synthetic scene: {tuple(scene.images.shape)} on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
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
    model = make_mip_model(True, device)
    state = create_train_state(model, LEARNING_RATE, seed=0)
    gen = torch.Generator(device=device).manual_seed(99)
    probe = (bank.sample_batch(gen, MIP_RAYS), draws_for(gen, model))
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
    name = "mip train 4096x64 seg 0.1"
    print(f"{name}: {ms:.2f} ms/step, {MIP_RAYS / ms * 1e3:.0f} rays/s over {TIMED_STEPS} "
          f"steps; launches {launches}; step losses {[round(float(v), 5) for v in losses]}",
          flush=True)
    check(launches == {"mip_train_grads": TIMED_STEPS},
          f"{name}: each step launched {{'mip_train_grads': 1}} and nothing else")
    check_policies(name, launches, policies, "tc")
    check(bool(torch.isfinite(losses).all()), f"{name}: every loss is finite")
    check(loss_after < loss_before,
          f"{name}: the probe batch's loss fell from {loss_before:.6f} to {loss_after:.6f} "
          f"over {WARMUP_STEPS + TIMED_STEPS} steps")

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


def mip_phases(device) -> dict:
    """Phases 7-10 (slice 3).  Returns the four mip kernels' rows."""
    cfg = MipNeRFConfig()
    rows = mip_serving(device, mip_flops_per_point(cfg))
    store = {}
    runs = mip_training(device, store)
    with torch.no_grad():
        k_rows = mip_kernels_against_plain(store, device)
    fused_launches, fused_ms = runs["fused"]
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


def mega_phase(device, cfg: ClassicNeRFConfig, bank, reuse_ms: float) -> dict:
    """Phase 12: one K9 step against its plain version and the reuse route,
    then the K9 train loop, then K9 against its plain version with its
    time.  Returns K9's row."""
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
    model = make_model(True, device)
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
        for name, p in zip(names, params):
            p.grad = step_grads[name]
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
    name = "train 2048x(64+128) K9"
    print(f"{name}: {ms:.2f} ms/step, {n_rays / ms * 1e3:.0f} rays/s over {TIMED_STEPS} steps "
          f"(reuse route {reuse_ms:.2f} ms/step, {n_rays / reuse_ms * 1e3:.0f} rays/s); launches "
          f"{launches}; step losses {[round(float(v), 5) for v in losses]}", flush=True)
    check(launches == {mega_train.NAME: TIMED_STEPS},
          f"{name}: each step launched one mega_train and nothing else")
    check_policies(name, launches, policies, "tc")
    check(bool(torch.isfinite(losses).all()), f"{name}: every loss is finite")
    check(loss_after < loss_before,
          f"{name}: the probe batch's loss fell from {loss_before:.6f} to {loss_after:.6f} "
          f"over {WARMUP_STEPS + TIMED_STEPS} steps")

    with torch.no_grad():
        kernel_ms = cuda_ms(lambda: mega_train.mega_train(packed, *inputs), iters=5)
        plain_ms = cuda_ms(lambda: mega_train.mega_train_plain(packed, *inputs), iters=3)
    sc, sf = render.num_coarse_samples, render.num_fine_samples
    print(f"mega_train at {n_rays} rays x ({sc} + {sf}): {kernel_ms:.3f} ms")
    nbytes = (tensor_bytes(*[a for a in inputs if a is not None], t_fine) + 8
              + 2 * tensor_bytes(*packed.values()))
    return {"mega_train": (launches[mega_train.NAME], dict(
        max_abs=err, ms=kernel_ms, plain_ms=plain_ms, flops=train_step_flops(cfg, n_rays, sc + sf),
        nbytes=nbytes))}


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
    rows = serving(device, classic_flops_per_point(cfg))
    train_rows, bank, reuse_ms = training(device, cfg)
    rows.update(train_rows)
    rows.update(mip_phases(device))
    rows.update(point_mlp_phase(device, cfg, bank))
    rows.update(mega_phase(device, cfg, bank, reuse_ms))
    latent_phase(device, bank)
    wide_forward_phase(device)
    cli_launches = entry_points_phase(device, card)

    # 15. Result lines.
    kernels = [kernel_row(name, launches, **row) for name, (launches, row) in rows.items()]
    for row in kernels:
        row["cli_launches"] = cli_launches.get(row["name"], 0)
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
