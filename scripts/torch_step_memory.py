"""Peak device memory of the classic training steps on the card: the reuse
step (K1-fwd, K1-bwd, K3) at 2048 rays x (64 + 128) at hidden 256 and at
512 rays at hidden 1024 (``chip_smoke.py`` phase 21's width), the
coarse-only step (K2) at 512 rays x 64 at hidden 1024 (the step phase 21
runs there), and the sample-parallel reuse step on an NCCL group of one
(phase 19a's 1x1 mesh), each through the user's entry point
(``make_fused_loss_and_grads``, ``make_sample_parallel_loss_and_grads``)
with random weights from seed 0, in float32.

    python scripts/torch_step_memory.py

Each figure is ``torch.cuda.max_memory_allocated()`` over one step after
a warm-up step and ``reset_peak_memory_stats()``, beside the memory held
before the step (the model, the scene, the draws).  The file runs
unchanged from another checkout's ``scripts/`` directory (it imports the
package of the tree it sits in), so two trees are compared in one call.
Prints the card's name and power limit, then one JSON object.  Exits
non-zero without a GPU.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the models, the scene, the renders, the card line)
from nerf_tpu_torch import parallel  # noqa: E402
from nerf_tpu_torch.data import RayBank, synthesize_scene  # noqa: E402
from nerf_tpu_torch.ops import sampling  # noqa: E402
from nerf_tpu_torch.train.loop import make_fused_loss_and_grads  # noqa: E402


def peak(step) -> dict:
    """GB held before the step and the step's peak, after a warm-up."""
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    step()
    torch.cuda.synchronize()
    return {"held_gb": before / 1e9, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_step_memory: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    card = chip_smoke.nvidia_smi("name,power.limit")
    scene = synthesize_scene(num_views=8, image_hw=64, focal=80.0, device=device)
    bank = RayBank.from_images(scene.images, scene.pose_o, scene.pose_r, scene.focal)
    gen = torch.Generator(device=device).manual_seed(5)
    out = {}
    cases = (("reuse 2048x(64+128), hidden 256", chip_smoke.TRAIN_RENDER, 2048, 256),
             ("reuse 512x(64+128), hidden 1024", chip_smoke.TRAIN_RENDER, 512, 1024),
             ("coarse-only 512x64, hidden 1024", chip_smoke.COARSE_RENDER, 512, 1024))
    for name, render, rays, hidden in cases:
        model = chip_smoke.make_model(True, device, hidden_size=hidden)
        batch = bank.sample_batch(gen, rays)
        draws = sampling.draw_step(gen, render, rays, device)
        step = make_fused_loss_and_grads(model, render)
        out[name] = peak(lambda: step(batch, draws))
        del model, step
        torch.cuda.empty_cache()
    parallel.initialize()  # no launcher environment: a group of one on cuda:0
    try:
        mesh = parallel.make_mesh_2d(1, 1)
        model = chip_smoke.make_model(True, device)
        batch = bank.sample_batch(gen, chip_smoke.TRAIN_RAYS)
        draws = sampling.draw_step(gen, chip_smoke.TRAIN_RENDER, chip_smoke.TRAIN_RAYS, device)
        step = parallel.make_sample_parallel_loss_and_grads(model, chip_smoke.TRAIN_RENDER, mesh)
        args = chip_smoke.sharded(mesh, batch, draws)
        out["SP reuse 2048x(64+128) at 1x1 (NCCL), hidden 256"] = peak(lambda: step(*args))
    finally:
        torch.distributed.destroy_process_group()
    for name, row in out.items():
        print(f"{name}: held {row['held_gb']:.3f} GB, peak {row['peak_gb']:.3f} GB", flush=True)
    print(card)
    print(json.dumps({"card": card, "tree": str(REPO), "peak_memory": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
