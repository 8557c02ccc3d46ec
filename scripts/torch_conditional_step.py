"""Times the conditional trainer's step on the card, and where its device
time goes.

    python scripts/torch_conditional_step.py [--states 7] [--epochs 2] [--out step.json]

Writes the data of ``chip_smoke.py``'s phase 14d (4 views of 100x100 of
the synthetic scene, pose seed 21, states of ``--states`` scalars from
numpy seed 21) and runs ``cli.train_conditional.main --use-pallas`` on it
for ``--epochs`` epochs in a temporary directory: the full-width model
(hidden 256, float32) with 3 + s density inputs, one K2 a step at the
CLI's 1024 rays x 64 samples, and an eval render (K1-fwd) at each epoch's
end.  ms/step is the host clock over the last epoch's steps, the CLI's
last logged interval.  Then one more epoch runs under ``torch.profiler``
and each kernel's device time is summed: per step, the device time of
all kernels but the eval render's K1-fwd passes, of which the MLP passes
(named as ``chip_smoke.PASSES`` labels them), their share of the host
ms/step, and the device's idle share over the profiled span (1 - busy /
span of the first to the last kernel, the eval render included).  Prints
the card's name and power limit, then one JSON object.  The file runs
unchanged from another checkout's ``scripts/`` directory (it imports the
package of the tree it sits in), so two trees are compared in one call,
each run twice in turns (A, B, B, A).  Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import tempfile
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (phase 14d's data, the pass labels)
from nerf_tpu_torch.cli import train_conditional  # noqa: E402
from nerf_tpu_torch.data import synthesize_scene  # noqa: E402
from nerf_tpu_torch.ops.kernels import _build  # noqa: E402


def write_data(path: str, width: int, device) -> int:
    """Phase 14d's pickle; returns the steps of one epoch."""
    views, hw = chip_smoke.CONDITIONAL_VIEWS, chip_smoke.CONDITIONAL_HW
    scene = synthesize_scene(num_views=views, image_hw=hw, focal=hw * 50.0 / 36.0,
                             pose_seed=21, device=device)
    pose_o = scene.pose_o.cpu().numpy()
    states = np.random.default_rng(21).normal(size=(views, width))
    with open(path, "wb") as f:
        pickle.dump({"images": scene.images.cpu().numpy(),
                     "poses": np.concatenate([pose_o, -pose_o], -1),
                     "states": states.astype(np.float32)}, f)
    return (views - 1) * hw ** 2 // 1024


def train(data: str, logdir: str, epochs: int, steps: int) -> None:
    train_conditional.main(["--logging-dir", logdir, "--data", data, "--use-pallas",
                            "--epochs", str(epochs), "--near-plane", "2", "--far-plane", "6",
                            "--log-interval", str(steps)])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--states", type=int, default=7, help="state scalars (3 + s density inputs)")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--out", help="also write the result as JSON to this file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_conditional_step: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    card = chip_smoke.nvidia_smi("name,power.limit")
    _build.build()
    with tempfile.TemporaryDirectory(prefix="conditional_step_") as tmp:
        data = os.path.join(tmp, "data.pkl")
        steps = write_data(data, args.states, device)
        timed = os.path.join(tmp, "timed")
        train(data, timed, args.epochs, steps)
        with open(os.path.join(timed, "metrics.jsonl")) as f:
            last = [json.loads(line) for line in f][-1]
        step_ms = 1024 / last["rays_per_s"] * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            train(data, os.path.join(tmp, "profiled"), 1, steps)
            torch.cuda.synchronize()
    by_name = defaultdict(float)
    start, end = float("inf"), 0.0
    for evt in prof.events():
        # Device events, less the ranges that annotate them (the optimizer's).
        if evt.device_type == torch.autograd.DeviceType.CUDA and not evt.is_user_annotation:
            by_name[evt.name] += evt.time_range.elapsed_us() / 1e3
            start = min(start, evt.time_range.start)
            end = max(end, evt.time_range.end)
    if not by_name:
        raise RuntimeError("the profiler recorded no device time")
    labels = {k: chip_smoke.pass_label(k) for k in by_name}
    eval_ms = sum(ms for k, ms in by_name.items() if labels[k].startswith("K1-fwd"))
    step_kernels = {k: ms / steps for k, ms in by_name.items()
                    if not labels[k].startswith("K1-fwd")}
    busy = sum(step_kernels.values())
    passes = sum(ms for k, ms in step_kernels.items() if labels[k])
    result = {
        "card": card, "tree": str(REPO), "states": args.states, "steps_per_epoch": steps,
        "step_ms": step_ms, "rays_per_s": last["rays_per_s"],
        "device_ms_per_step": busy, "mlp_passes_ms_per_step": passes,
        "device_share_of_step": busy / step_ms, "mlp_share_of_step": passes / step_ms,
        "eval_k1_fwd_ms": eval_ms,
        "idle_share": 1.0 - sum(by_name.values()) * 1e3 / (end - start),
        "kernels_ms_per_step": dict(sorted(step_kernels.items(), key=lambda kv: -kv[1])[:12]),
    }
    print(card)
    print(f"{args.states} state scalars: {step_ms:.3f} ms/step (host clock, steps "
          f"{(args.epochs - 1) * steps + 1}-{args.epochs * steps}); device {busy:.3f} ms a step "
          f"({busy / step_ms:.1%}), of which the MLP passes {passes:.3f} ms "
          f"({passes / step_ms:.1%}); the eval render's K1-fwd {eval_ms:.3f} ms; idle share "
          f"{result['idle_share']:.4f}")
    for k, ms in result["kernels_ms_per_step"].items():
        print(f"  {ms:9.4f} ms  {f'[{labels[k]}] ' if labels[k] else ''}{k[:110]}")
    print(json.dumps(result))
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
