"""Where a 400x400 frame of the PyTorch/CUDA port spends its device time.

    python scripts/torch_render_profile.py [--family classic|mip|all] [--frames 2]
                                           [--out profile.json] [--compute-dtype bfloat16]

Renders frames on the kernel path (``use_pallas=True``) with the models,
seeds and render settings of ``chip_smoke.py``: ``ClassicNeRF.render_image``
at 64 + 128 samples (K1-fwd and K4) and ``MipNeRF.render_image`` at 64
log-bbox fenceposts (K7).  For each, first it times ``--frames`` frames on
the host clock (ending in ``torch.cuda.synchronize()``, after a warm-up
frame); then it renders the same number of frames under ``torch.profiler``
and sums the device time of every kernel by name.  Prints the card, the
frame's wall time, device time per frame by kernel (largest first; K1-fwd's
``fwd_tc_kernel``, K4's ``union_eval_kernel`` and K7's
``mip_fwd_tc_kernel``, whose MLPs run as 3xTF32 on the tensor cores,
labelled as ``chip_smoke.PASSES`` names them), the ported kernels' share,
and the device's idle share (1 - busy / span of the
first to the last kernel); ``--out`` also writes them as JSON.  With
``--compute-dtype bfloat16`` the models run their bf16 kernels.  Exits
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
from nerf_tpu_torch.data.scenes import spherical_poses  # noqa: E402


# Kernel names (by substring) of each family's ported kernels.
PORTED = {"classic": ("fwd_tc_kernel", "union_eval"),
          "mip": ("mip_fwd_tc_kernel", "mip_fwd_kernel", "mip_eval_rays_kernel")}


def profile_family(family: str, n_frames: int, device, compute_dtype: str) -> dict:
    dt = dict(compute_dtype=compute_dtype)
    if family == "classic":
        model, render = chip_smoke.make_model(True, device, **dt), chip_smoke.RENDER
    else:
        model, render = chip_smoke.make_mip_model(True, device, **dt), chip_smoke.MIP_RENDER
    pose_o, pose_r = spherical_poses(1, radius=4.0, device=device)

    def frames():
        for _ in range(n_frames):
            model.render_image(pose_o, pose_r, chip_smoke.IMAGE, chip_smoke.IMAGE,
                               chip_smoke.FOCAL, render)
        torch.cuda.synchronize()

    frames()  # builds the kernels, warms up
    t0 = time.perf_counter()
    frames()
    frame_ms = (time.perf_counter() - t0) * 1e3 / n_frames

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        frames()
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
    per_frame = {k: v / 1e3 / n_frames for k, v in
                 sorted(by_name.items(), key=lambda kv: -kv[1])}
    ported = sum(v for k, v in per_frame.items() if any(p in k for p in PORTED[family]))
    result = {
        "frame_ms": frame_ms,
        "device_busy_ms_per_frame": busy_us / 1e3 / n_frames,
        "device_span_ms_per_frame": (end - start) / 1e3 / n_frames,
        "idle_share": 1.0 - busy_us / (end - start),
        "ported_kernels_ms_per_frame": ported,
        "kernels_ms_per_frame": dict(list(per_frame.items())[:15]),
    }
    print(f"{family} frame ({compute_dtype}) {frame_ms:.1f} ms (host clock); device busy "
          f"{result['device_busy_ms_per_frame']:.1f} ms, span "
          f"{result['device_span_ms_per_frame']:.1f} ms, idle share {result['idle_share']:.4f}; "
          f"ported kernels {ported:.1f} ms")
    for name, ms in list(per_frame.items())[:15]:
        label = chip_smoke.pass_label(name)
        print(f"  {ms:9.3f} ms  {f'[{label}] ' if label else ''}{name[:110]}")
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--family", choices=("classic", "mip", "all"), default="all")
    p.add_argument("--frames", type=int, default=2)
    p.add_argument("--out", help="also write the result as JSON to this file")
    p.add_argument("--compute-dtype", default="float32", choices=("float32", "bfloat16"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_render_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    card = chip_smoke.nvidia_smi("name,power.limit")
    print(card)
    result = {"card": card, "compute_dtype": args.compute_dtype}
    for family in (("classic", "mip") if args.family == "all" else (args.family,)):
        result[family] = profile_family(family, args.frames, device, args.compute_dtype)
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
