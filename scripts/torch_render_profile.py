"""Where a 400x400, 64+128-sample frame of the PyTorch/CUDA port spends its
device time.

    python scripts/torch_render_profile.py [--frames 2] [--out profile.json]

Renders frames through ``ClassicNeRF.render_image`` on the kernel path
(``use_pallas=True``) with the model, seed and render settings of
``chip_smoke.py``.  First it times ``--frames`` frames on the host clock
(ending in ``torch.cuda.synchronize()``, after a warm-up frame); then it
renders the same number of frames under ``torch.profiler`` and sums the
device time of every kernel by name.  Prints the card, the frame's wall
time, device time per frame by kernel (largest first), the two ported
kernels' share, and the device's idle share (1 - busy / span of the first
to the last kernel); ``--out`` also writes them as JSON.  Exits non-zero
without a GPU.
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames", type=int, default=2)
    p.add_argument("--out", help="also write the result as JSON to this file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_render_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    card = chip_smoke.nvidia_smi("name,power.limit")
    model = chip_smoke.make_model(True, device)
    pose_o, pose_r = spherical_poses(1, radius=4.0, device=device)

    def frames():
        for _ in range(args.frames):
            model.render_image(pose_o, pose_r, chip_smoke.IMAGE, chip_smoke.IMAGE,
                               chip_smoke.FOCAL, chip_smoke.RENDER)
        torch.cuda.synchronize()

    frames()  # builds the kernels, warms up
    t0 = time.perf_counter()
    frames()
    frame_ms = (time.perf_counter() - t0) * 1e3 / args.frames

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
        print("torch_render_profile: the profiler recorded no device time", file=sys.stderr)
        return 1
    busy_us = sum(by_name.values())
    per_frame = {k: v / 1e3 / args.frames for k, v in
                 sorted(by_name.items(), key=lambda kv: -kv[1])}
    ported = sum(v for k, v in per_frame.items()
                 if "classic_mlp_fwd_kernel" in k or "union_eval_kernel" in k)
    result = {
        "card": card,
        "frame_ms": frame_ms,
        "device_busy_ms_per_frame": busy_us / 1e3 / args.frames,
        "device_span_ms_per_frame": (end - start) / 1e3 / args.frames,
        "idle_share": 1.0 - busy_us / (end - start),
        "ported_kernels_ms_per_frame": ported,
        "kernels_ms_per_frame": dict(list(per_frame.items())[:15]),
    }
    print(card)
    print(f"frame {frame_ms:.1f} ms (host clock); device busy {result['device_busy_ms_per_frame']:.1f} "
          f"ms, span {result['device_span_ms_per_frame']:.1f} ms, idle share {result['idle_share']:.4f}; "
          f"K1-fwd + K4 {ported:.1f} ms")
    for name, ms in list(per_frame.items())[:15]:
        print(f"  {ms:9.3f} ms  {name[:110]}")
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
