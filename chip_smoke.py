#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nerf_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (``nvidia-smi``).
2. Builds the port's two CUDA kernels from ``nerf_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, started together) and prints the
   seconds it took and each kernel's registers and spills.
3. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes: K1-fwd (``classic_mlp_fwd``) on 262,144 points and
   K4 (``union_eval``) on the first 4000-ray tile of the frame below, with
   the inputs the renderer gives it.  Prints the errors against the stated
   tolerance and, from CUDA events after warm-up, the kernel's and the plain
   version's time beside the kernel's bound.
4. Renders one 400x400 frame of 64 coarse + 128 fine samples through
   ``ClassicNeRF.render_image`` with the kernels (``use_pallas=True``; the
   launch counters are zeroed just before and must read 40 each after) and
   once through the plain path, and compares the two images.
5. Prints the kernels' JSON line, then, last, the device line.

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
import subprocess
import sys
import time

import torch

from nerf_tpu_torch import ClassicNeRF, ClassicNeRFConfig, RenderConfig
from nerf_tpu_torch.data.scenes import spherical_poses
from nerf_tpu_torch.ops.cameras import pose_to_rays
from nerf_tpu_torch.ops.kernels import _build, classic_mlp, union_eval
from nerf_tpu_torch.utils.profiling import classic_flops_per_point

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
# Stated tolerances.  K1: float32 FMAs summed in another order than
# cuBLAS's, through ten LayerNorm'd layers.  K4: the same MLP, then the
# transmittance summed in merged order where the plain version sums two
# blocks and the cross terms.  Frame: both paths' differences, plus the
# fine samples' sensitivity to the coarse weights' rounding.
TOL = {
    "classic_mlp_fwd": dict(rtol=1e-4, atol=1e-4),
    "union_eval": dict(rtol=5e-4, atol=1e-4),
    "frame": dict(rtol=0.0, atol=1e-3),
}
SOURCES = {
    "classic_mlp_fwd": ("nerf_tpu_torch/csrc/classic_mlp_fwd.cu",
                        "nerf_tpu/ops/pallas/fused_mlp.py:608"),
    "union_eval": ("nerf_tpu_torch/csrc/union_eval.cu",
                   "nerf_tpu/ops/pallas/fused_hier.py:635"),
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


@contextlib.contextmanager
def capture_union_eval_args(store: dict):
    """Record the arguments of the renderer's first ``union_eval`` call."""
    original = union_eval.union_eval

    def recording(*args, **kwargs):
        store.setdefault("args", args)
        return original(*args, **kwargs)

    union_eval.union_eval = recording
    try:
        yield
    finally:
        union_eval.union_eval = original


def make_model(use_pallas: bool, device) -> ClassicNeRF:
    cfg = ClassicNeRFConfig(normalize_position=6.0, use_pallas=use_pallas)
    model = ClassicNeRF(cfg, generator=torch.Generator().manual_seed(0), device=device)
    with torch.no_grad():
        model.mlp.density.bias.fill_(0.5)
        model.mlp.density.weight.mul_(0.05)
    return model.eval().requires_grad_(False)


def kernel_row(name, launches, max_abs, ms, plain_ms, flops, nbytes) -> dict:
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"{name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
          f"({bound_by}), {flops / ms / 1e9:.2f} TFLOP/s achieved")
    source, replaces = SOURCES[name]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


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
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    for name in _build.KERNELS:
        _build.load(name)

    model = make_model(True, device)
    plain_model = make_model(False, device)
    cfg = model.cfg
    packed = classic_mlp.pack_classic_params(model.mlp)
    weight_bytes = tensor_bytes(*packed.values())
    flops_per_point = classic_flops_per_point(cfg)
    pose_o, pose_r = spherical_poses(1, radius=4.0, device=device)

    # 3a. K1-fwd against its plain version.
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

    # 3b. K4 on the first tile, with the inputs the renderer gives it.
    store = {}
    rays_o, rays_d = (r.reshape(-1, 3)[: RENDER.rays_per_tile] for r in
                      pose_to_rays(pose_o, pose_r, IMAGE, IMAGE, FOCAL))
    with torch.no_grad(), capture_union_eval_args(store):
        model.render_rays(rays_o, rays_d, RENDER, fused_eval=True)
    args = store["args"]
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

    # 4. The main path: one 400x400 frame through the kernels.
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
    launches = {name: _build.launch_counts[name] for name in _build.KERNELS}
    print(f"frame through the kernels: {frame_ms:.1f} ms; launches {launches}", flush=True)
    check(all(launches[name] == n_tiles for name in _build.KERNELS),
          f"each kernel launched once per tile ({n_tiles} tiles)")

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

    k1_row = kernel_row("classic_mlp_fwd", launches["classic_mlp_fwd"], **k1)
    k4_row = kernel_row("union_eval", launches["union_eval"], **k4)
    print(f"frame: {frame_ms:.1f} ms through the kernels, {plain_frame_ms:.1f} ms plain, "
          f"max pixel difference {pixel_err:.3e}")

    # 5. Result lines.
    print(card)
    print(json.dumps({"kernels": [k1_row, k4_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed:
        sys.exit(1)
