"""Where a train step of the PyTorch/CUDA port spends its device time.

    python scripts/torch_train_profile.py [--steps 5] [--out profile.json]
                                          [--compute-dtype bfloat16] [--data-parallel]

Trains the models of ``chip_smoke.py`` (seed 0) on its synthetic scenes
through ``make_fused_multi_step_train_fn`` in each of its training
configurations: the full-width ClassicNeRF's reuse step at 2048 rays x (64
+ 128) samples (K1-fwd, K3, one K1-bwd) and its coarse-only step at 4096
x 64 (K2), and the full-width MipNeRF's step at 4096 rays x 64 fenceposts
with the segmentation CE at weight 0.1 (K6) on the labelled scene; and the
reuse step through K9 (``mega_train.mega_train_loss_and_grads``, one
``mega_train`` call a step) with ``torch.optim.Adam``, as ``chip_smoke.py``
trains it.  For each, after two warm-up steps it times ``--steps`` steps on
the host clock (ending in ``torch.cuda.synchronize()``), then runs the same
number of steps under ``torch.profiler`` and sums the device time of every
kernel by name (K9's passes are separate kernels of its one call).  Prints
the card, ms/step, rays/s, device time per step by kernel (largest first,
each MLP pass labelled as ``chip_smoke.PASSES`` names it: K1-bwd's, K2's,
K3's, K6's and K9's ``fwd_store``, ``bwd_rows`` and ``wgrad`` and K1-fwd's
tile run their products as 3xTF32 on the tensor cores) and the device's
idle share (1 - busy / span of the first to the last kernel); ``--out``
also writes them as JSON.  With ``--compute-dtype bfloat16`` it profiles
the same steps in compute_dtype bfloat16 (every pass a bf16 ``wgmma``).
With ``--data-parallel`` it profiles the reuse, coarse-only and mip steps
through ``parallel.make_parallel_multi_step_train_fn(fused=True)`` on an
NCCL group of one (the gradient average's ``all_reduce`` among the
kernels) instead, and no K9 step (no data-parallel path calls K9).
Exits non-zero without a GPU.
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
from nerf_tpu_torch import parallel  # noqa: E402
from nerf_tpu_torch.data import RayBank, synthesize_scene  # noqa: E402
from nerf_tpu_torch.ops import sampling  # noqa: E402
from nerf_tpu_torch.ops.kernels import mega_train  # noqa: E402
from nerf_tpu_torch.train import create_train_state, make_fused_multi_step_train_fn  # noqa: E402


def profile_config(name, model, render, n_rays, bank, steps, device, seg_weight=0.0,
                   mesh=None) -> dict:
    state = create_train_state(model, chip_smoke.LEARNING_RATE, seed=0)
    if mesh is None:
        def maker(k):
            return make_fused_multi_step_train_fn(model, render, bank, n_rays, k, seg_weight)
    else:
        state = parallel.prepare_parallel_state(state, mesh)

        def maker(k):
            return parallel.make_parallel_multi_step_train_fn(model, render, bank, n_rays, mesh,
                                                              k, seg_weight, fused=True)
    run, warm = maker(steps), maker(2)
    return profile_steps(name, lambda: warm(state), lambda: run(state), n_rays, steps)


def mega_steps(model, render, bank, n_rays, device):
    """``run(num_steps)``: K9 train steps with ``torch.optim.Adam``, each
    batch and its draws from one generator (``chip_smoke.py``'s loop)."""
    names, params = zip(*model.named_parameters())
    opt = torch.optim.Adam(params, lr=chip_smoke.LEARNING_RATE)
    gen = torch.Generator(device=device).manual_seed(99)

    def run(num_steps):
        for _ in range(num_steps):
            batch = bank.sample_batch(gen, n_rays)
            draws = sampling.draw_step(gen, render, n_rays, device)
            _, grads, _ = mega_train.mega_train_loss_and_grads(model, render, batch, draws)
            for name, p in zip(names, params):
                p.grad = grads[name]
            opt.step()

    return run


def profile_steps(name, warm, run, n_rays, steps) -> dict:
    """Times ``run()`` (``steps`` steps) after ``warm()``, then profiles it."""
    warm()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
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
        label = chip_smoke.pass_label(kernel)
        print(f"  {ms:9.3f} ms  {f'[{label}] ' if label else ''}{kernel[:110]}")
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--out", help="also write the result as JSON to this file")
    p.add_argument("--compute-dtype", default="float32", choices=("float32", "bfloat16"))
    p.add_argument("--data-parallel", action="store_true",
                   help="the data-parallel steps on an NCCL group of one")
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
    result = {"card": card, "compute_dtype": args.compute_dtype,
              "data_parallel": args.data_parallel}
    dt = dict(compute_dtype=args.compute_dtype)
    mesh = None
    if args.data_parallel:
        parallel.initialize()
        mesh = parallel.make_mesh()
    try:
        result["reuse_2048x(64+128)"] = profile_config(
            "reuse 2048x(64+128)", chip_smoke.make_model(True, device, **dt),
            chip_smoke.TRAIN_RENDER, chip_smoke.TRAIN_RAYS, bank, args.steps, device, mesh=mesh)
        if mesh is None:
            run_mega = mega_steps(chip_smoke.make_model(True, device, **dt),
                                  chip_smoke.TRAIN_RENDER, bank, chip_smoke.TRAIN_RAYS, device)
            result["mega_2048x(64+128)"] = profile_steps(
                "K9 reuse 2048x(64+128)", lambda: run_mega(2), lambda: run_mega(args.steps),
                chip_smoke.TRAIN_RAYS, args.steps)
        result["coarse_4096x64"] = profile_config(
            "coarse-only 4096x64", chip_smoke.make_model(True, device, **dt),
            chip_smoke.COARSE_RENDER, chip_smoke.COARSE_RAYS, bank, args.steps, device,
            mesh=mesh)
        scene = synthesize_scene(num_views=8, image_hw=64, focal=80.0, with_labels=True,
                                 device=device)
        bank = RayBank.from_images(scene.images, scene.pose_o, scene.pose_r, scene.focal,
                                   labels=scene.labels)
        result["mip_4096x64_seg"] = profile_config(
            "mip 4096x64 seg 0.1", chip_smoke.make_mip_model(True, device, **dt),
            chip_smoke.MIP_TRAIN_RENDER, chip_smoke.MIP_RAYS, bank, args.steps, device,
            chip_smoke.SEG_WEIGHT, mesh=mesh)
    finally:
        parallel.shutdown()
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
