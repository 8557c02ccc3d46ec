"""Camera poses for rendering (counterpart of ``spherical_poses`` in
``nerf_tpu/data/scenes.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from nerf_tpu_torch.ops import cameras


def spherical_poses(
    num: int,
    radius: float = 4.0,
    elevation: float = 0.5,
    seed: Optional[int] = None,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cameras on a sphere looking at the origin (tiny_nerf style):
    ``(pose_o [num, 3], pose_r [num, 3, 3])``.  Equally spaced yaws by
    default; random yaws and elevations when ``seed`` is set."""
    if seed is None:
        yaw = np.linspace(0.0, 2 * np.pi, num, endpoint=False)
        el = np.full(num, elevation)
    else:
        rng = np.random.default_rng(seed)
        yaw = rng.uniform(0, 2 * np.pi, num)
        el = rng.uniform(0.2, 0.9, num)
    eye = cameras.spherical_to_cartesian(
        torch.as_tensor(yaw, dtype=torch.float32), torch.as_tensor(el, dtype=torch.float32)
    )
    pose_o = (eye * radius).to(device)
    # Look at the origin: the viewing direction is -eye.
    return pose_o, cameras.direction_to_rotation_matrix(-pose_o)
