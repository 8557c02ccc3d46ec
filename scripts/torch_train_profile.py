"""Where a train step of the PyTorch/CUDA port spends its device time.

    python scripts/torch_train_profile.py [--steps 5] [--out profile.json]

Trains the model of ``chip_smoke.py`` (full-width ClassicNeRF, seed 0) on
its synthetic scene through ``make_fused_multi_step_train_fn`` in both of
its training configurations: the reuse step at 2048 rays x (64 + 128)
samples (K1-fwd, K3, one K1-bwd) and the coarse-only step at 4096 x 64
(K2).  For each, after two warm-up steps it times ``--steps`` steps on the
host clock (ending in ``torch.cuda.synchronize()``), then runs the same
number of steps under ``torch.profiler`` and sums the device time of every
kernel by name.  Prints the card, ms/step, rays/s, device time per step by
kernel (largest first) and the device's idle share (1 - busy / span of the
first to the last kernel); ``--out`` also writes them as JSON.  Exits
non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the smoke run's model and settings)
from nerf_tpu_torch.data import RayBank, synthesize_scene  # noqa: E402
from nerf_tpu_torch.train import create_train_state, make_fused_multi_step_train_fn  # noqa: E402


def profile_config(name, render, n_rays, bank, steps, device) -> dict:
    model = chip_smoke.make_model(True, device)
    state = create_train_state(model, chip_smoke.LEARNING_RATE, seed=0)
    run = make_fused_multi_step_train_fn(model, render, bank, n_rays, steps)
    make_fused_multi_step_train_fn(model, render, bank, n_rays, 2)(state)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(state)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(state)
        torch.cuda.synchronize()
    by_name = defaultdict(float)
    start, end = float("inf"), 0.0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] += evt.time_range.elapsed_us()
            start = min(start, evt.time_range.start)
            end = max(end, evt.time_range.end)
    if not by_name:
        raise RuntimeError("the profiler recorded no device time")
    busy_us = sum(by_name.values())
    per_step = {k: v / 1e3 / steps for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])}
    result = {
        "step_ms": step_ms,
        "rays_per_s": n_rays / step_ms * 1e3,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_span_ms_per_step": (end - start) / 1e3 / steps,
        "idle_share": 1.0 - busy_us / (end - start),
        "kernels_ms_per_step": dict(list(per_step.items())[:20]),
    }
    print(f"{name}: {step_ms:.2f} ms/step (host clock), {result['rays_per_s']:.0f} rays/s; "
          f"device busy {result['device_busy_ms_per_step']:.2f} ms, span "
          f"{result['device_span_ms_per_step']:.2f} ms, idle share {result['idle_share']:.4f}")
    for kernel, ms in list(per_step.items())[:20]:
        print(f"  {ms:9.3f} ms  {kernel[:110]}")
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--out", help="also write the result as JSON to this file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    card = chip_smoke.nvidia_smi("name,power.limit")
    print(card)
    scene = synthesize_scene(num_views=8, image_hw=64, focal=80.0, device=device)
    bank = RayBank.from_images(scene.images, scene.pose_o, scene.pose_r, scene.focal)
    result = {"card": card}
    result["reuse_2048x(64+128)"] = profile_config(
        "reuse 2048x(64+128)", chip_smoke.TRAIN_RENDER, chip_smoke.TRAIN_RAYS, bank,
        args.steps, device)
    result["coarse_4096x64"] = profile_config(
        "coarse-only 4096x64", chip_smoke.COARSE_RENDER, chip_smoke.COARSE_RAYS, bank,
        args.steps, device)
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
