#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nerf_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (``nvidia-smi``).
2. Builds the port's five CUDA kernels from ``nerf_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, started together) and prints the
   seconds it took and each kernel's registers and spills.
3. Serving (slice 1): holds K1-fwd (``classic_mlp_fwd``, 262,144 points)
   and K4 (``union_eval``, the first 4000-ray tile of the frame) against
   their plain PyTorch versions, then renders one 400x400 frame of 64
   coarse + 128 fine samples through ``ClassicNeRF.render_image`` with the
   kernels (the launch counters are zeroed just before and must read 40
   each after) and once through the plain path, and compares the images.
4. Training (slice 2), the main path: a synthetic scene (8 views of
   64x64, on the card) and the full-width model trained through
   ``make_fused_multi_step_train_fn`` at 2048 rays x (64 + 128) samples,
   ``reuse_coarse_in_fine=True``, stratified jitter, density noise 1.0,
   Adam at lr 1e-4.  First one step's loss and gradients are held against
   the plain path (the same weights and draws through autograd); then
   warm-up steps, and timed steps with the counters zeroed just before:
   each step must launch one K1-fwd, one K1-bwd and one K3 and nothing
   else.  Every loss must be finite, and the loss of a fixed probe batch
   (fixed draws) must be lower after the run than before.  Prints ms/step
   and rays/s.
5. Coarse-only training at 4096 rays x 64 samples: one K2 per step;
   prints ms/step and rays/s.
6. Holds K1-bwd, K2 and K3 against their plain versions on the inputs the
   trainer gave them (K1-bwd with random cotangents), with their times and
   bounds.
7. Prints the kernels' JSON line, the card line, then, last, the device
   line.

The model is the full-width ClassicNeRF (hidden 256, 60 + 36 encoding
widths, 638,468 parameters) with random weights from seed 0.  Its density
head is set to a small positive density everywhere (bias 0.5, weights
x 0.05): with the raw init about half the coarse intervals are empty, and
the fine sampler inverts a cdf with bins of 1e-5 mass, which turns a 1-ulp
difference of the coarse weights into a visible shift of the fine samples;
with mass in every bin the kernel path and the plain path agree to float32
rounding.

Exits non-zero, with no result line, when there is no CUDA device or a
check fails.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import time

import torch

from nerf_tpu_torch import ClassicNeRF, ClassicNeRFConfig, RenderConfig
from nerf_tpu_torch.data import RayBank, synthesize_scene
from nerf_tpu_torch.data.scenes import spherical_poses
from nerf_tpu_torch.ops import sampling
from nerf_tpu_torch.ops.cameras import pose_to_rays
from nerf_tpu_torch.ops.kernels import (
    _build,
    classic_mlp,
    fine_stage_train,
    train_grads,
    union_eval,
)
from nerf_tpu_torch.train import (
    create_train_state,
    make_fused_loss_and_grads,
    make_fused_multi_step_train_fn,
    make_loss_fn,
)
from nerf_tpu_torch.utils.profiling import classic_flops_per_point, train_step_flops

# Published H100 SXM peaks (NVIDIA's data sheet): float32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
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
# Stated tolerances.  K1: float32 FMAs summed in another order than
# cuBLAS's, through ten LayerNorm'd layers.  K4: the same MLP, then the
# transmittance summed in merged order where the plain version sums two
# blocks and the cross terms.  Frame: both paths' differences, plus the
# fine samples' sensitivity to the coarse weights' rounding.  Gradients
# (relative L2 error per tensor): at 10^5 rows some ReLU inputs lie
# within rounding of 0 and take the other branch in one of two float32
# evaluations, each moving its row's gradient.  Losses: sums of per-ray
# terms in another order.
TOL = {
    "classic_mlp_fwd": dict(rtol=1e-4, atol=1e-4),
    "union_eval": dict(rtol=5e-4, atol=1e-4),
    "frame": dict(rtol=0.0, atol=1e-3),
}
GRAD_REL_L2 = 1e-2
LOSS_RTOL = 1e-4
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


def ptxas_usage(report: str):
    """(kernel, 'registers; spills') pairs from an ``nvcc -Xptxas -v`` report."""
    label, spills = "?", ""
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            label = kernel_label(entry.group(1))
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line:
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
    """(bound_ms, bound_by): the larger of operations over the fp32 peak and
    bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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


def make_model(use_pallas: bool, device) -> ClassicNeRF:
    cfg = ClassicNeRFConfig(normalize_position=6.0, use_pallas=use_pallas)
    model = ClassicNeRF(cfg, generator=torch.Generator().manual_seed(0), device=device)
    with torch.no_grad():
        model.mlp.density.bias.fill_(0.5)
        model.mlp.density.weight.mul_(0.05)
    return model


def kernel_row(name, launches, max_abs, ms, plain_ms, flops, nbytes) -> dict:
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"{name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
          f"({bound_by}), {flops / ms / 1e9:.2f} TFLOP/s achieved, {launches} launches")
    source, replaces = SOURCES[name]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
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
        got = classic_mlp.classic_mlp_fwd(packed, x_enc, d_enc)
        ref = classic_mlp.classic_mlp_fwd_plain(packed, x_enc, d_enc)
        torch.cuda.synchronize()
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
    t0 = time.perf_counter()
    image = render(model)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(_build.launch_counts)
    print(f"frame through the kernels: {frame_ms:.1f} ms; launches {launches}", flush=True)
    check(launches == {"classic_mlp_fwd": n_tiles, "union_eval": n_tiles},
          f"K1-fwd and K4 launched once per tile ({n_tiles} tiles), nothing else")

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
    t0 = time.perf_counter()
    state, aux = timed(state)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    launches = dict(_build.launch_counts)
    loss_after = float(probe_loss(*probe)[0])
    losses = torch.cat([aux_w["loss"], aux["loss"]]).cpu()
    print(f"{name}: {ms:.2f} ms/step, {n_rays / ms * 1e3:.0f} rays/s over {TIMED_STEPS} steps; "
          f"launches {launches}; step losses {[round(float(v), 5) for v in losses]}", flush=True)
    check(launches == {k: v * TIMED_STEPS for k, v in expected.items()},
          f"{name}: each step launched {expected} and nothing else")
    check(bool(torch.isfinite(losses).all()), f"{name}: every loss is finite")
    check(loss_after < loss_before,
          f"{name}: the probe batch's loss fell from {loss_before:.6f} to {loss_after:.6f} "
          f"over {WARMUP_STEPS + TIMED_STEPS} steps")
    return launches, ms


def training(device, cfg: ClassicNeRFConfig) -> dict:
    """Phases 4-6.  Returns the three training kernels' rows."""
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
    return rows


def kernels_against_plain(store: dict, cfg: ClassicNeRFConfig, device) -> dict:
    """Phase 6: K1-bwd, K2 and K3 against their plain versions on the
    recorded arguments, with their times; returns their rows' numbers."""
    rows = {}
    # K1-bwd as the reuse step calls it (no encoding cotangents: the
    # encodings need no gradient), with random cotangents.
    args, kwargs = store["classic_mlp_bwd"]
    packed, x, d, _ = args
    weight_bytes = tensor_bytes(*packed.values())
    gen = torch.Generator(device=device).manual_seed(8)
    g_out = torch.rand((x.shape[0], 4), generator=gen, device=device) * 2 - 1
    got = classic_mlp.classic_mlp_bwd(packed, x, d, g_out, **kwargs)
    ref = classic_mlp.classic_mlp_bwd_plain(packed, x, d, g_out, **kwargs)
    named = lambda r: {"dx": r[0], "dd": r[1], **r[2]} if r[0] is not None else r[2]  # noqa: E731
    err = compare_grads("classic_mlp_bwd", named(got), named(ref))
    ms = cuda_ms(lambda: classic_mlp.classic_mlp_bwd(packed, x, d, g_out, **kwargs), iters=5)
    plain_ms = cuda_ms(
        lambda: classic_mlp.classic_mlp_bwd_plain(packed, x, d, g_out, **kwargs), iters=3)
    print(f"classic_mlp_bwd at {x.shape[0]} points, {kwargs}")
    rows["classic_mlp_bwd"] = dict(
        max_abs=err, ms=ms, plain_ms=plain_ms, flops=train_step_flops(cfg, x.shape[0], 1),
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
          f"(bounds use the published {PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s and "
          f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s)", flush=True)

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
    rows.update(training(device, cfg))

    # 7. Result lines.
    print(card)
    print(json.dumps({"kernels": [kernel_row(name, launches, **row)
                                  for name, (launches, row) in rows.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed:
        sys.exit(1)
