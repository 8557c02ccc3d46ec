"""Datasets: the tiny_nerf ``.npz`` loader, camera poses and an analytic
synthetic scene (counterpart of ``nerf_tpu/data/scenes.py``, with the
same blob constants).

``load_tiny_nerf`` reads the reference's ``tiny_nerf_data.npz`` (images
``[B, H, W, 3]``, poses ``[B, 4, 4]``, focal) into the ``(pose_o,
pose_r)`` split.  ``synthesize_scene`` renders an emission-absorption
volume of coloured Gaussian blobs to ground truth by brute-force
quadrature of the same volume-rendering equation the models learn, so
training is testable without a dataset; ``synthesize_forward_facing``
renders the same blobs from LLFF-style forward-facing cameras for the
NDC path.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nerf_tpu_torch.ops import cameras, compositing


class SceneData(NamedTuple):
    images: torch.Tensor  # [B, H, W, 3]
    pose_o: torch.Tensor  # [B, 3]
    pose_r: torch.Tensor  # [B, 3, 3]
    focal: float
    labels: Optional[torch.Tensor] = None  # [B, H, W] int labels or None
    states_x: Optional[torch.Tensor] = None  # [B, Kx] per-scene latents or None
    states_d: Optional[torch.Tensor] = None  # [B, Kd]


def load_tiny_nerf(path: str, device="cuda") -> SceneData:
    """Load the tiny_nerf npz (images/poses/focal) into the pose split
    (``pose[:3, 3]`` / ``pose[:3, :3]``) on ``device``."""
    data = np.load(path)
    poses = torch.as_tensor(np.asarray(data["poses"], np.float32), device=device)
    return SceneData(
        images=torch.as_tensor(np.asarray(data["images"], np.float32), device=device),
        pose_o=poses[:, :3, 3].contiguous(),
        pose_r=poses[:, :3, :3].contiguous(),
        focal=float(data["focal"]),
    )


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


# A small asymmetric arrangement of coloured Gaussian blobs (every view
# looks different).
_BLOB_CENTERS = np.asarray(
    [
        [0.0, 0.0, 0.0],
        [0.7, 0.3, 0.2],
        [-0.5, 0.6, -0.3],
        [0.2, -0.7, 0.4],
        [-0.4, -0.4, -0.5],
    ],
    np.float32,
)
_BLOB_SIGMAS = np.asarray([0.45, 0.25, 0.3, 0.2, 0.25], np.float32)
_BLOB_DENSITY = np.asarray([8.0, 20.0, 15.0, 25.0, 18.0], np.float32)
_BLOB_COLORS = np.asarray(
    [
        [0.9, 0.8, 0.2],
        [0.9, 0.2, 0.2],
        [0.2, 0.5, 0.9],
        [0.2, 0.8, 0.3],
        [0.8, 0.3, 0.8],
    ],
    np.float32,
)


def scene_density_color(
    points: torch.Tensor, field_offset=None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Analytic density ``[..., 1]``, colour ``[..., 3]`` and dominant-blob
    label ``[...]`` (1..K, 0 for empty space) at 3-D ``points``."""

    def const(a):
        return torch.as_tensor(a, dtype=points.dtype, device=points.device)

    centers = const(_BLOB_CENTERS)
    if field_offset is not None:
        centers = centers + const(np.asarray(field_offset, np.float32))
    d2 = torch.sum((points[..., None, :] - centers) ** 2, dim=-1)  # [..., K]
    per_blob = const(_BLOB_DENSITY) * torch.exp(-0.5 * d2 / const(_BLOB_SIGMAS) ** 2)
    density = torch.sum(per_blob, dim=-1, keepdim=True)
    weights = per_blob / torch.clamp(density[..., 0:1], min=1e-8)
    color = weights @ const(_BLOB_COLORS)
    label = torch.where(
        density[..., 0] > 0.05, torch.argmax(per_blob, dim=-1) + 1, 0
    )
    return density, color, label


def render_ground_truth(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    near: float = 2.0,
    far: float = 6.0,
    num_samples: int = 512,
    field_offset=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force quadrature of the volume rendering equation with the
    compositing the models are trained against.  Returns ``(rgb [N, 3],
    label [N])``, the label being the dominant blob along the ray by
    compositing weight (0 for the background's leftover transmittance)."""
    t = torch.linspace(near, far, num_samples, dtype=rays_o.dtype, device=rays_o.device)
    t = t.expand(rays_o.shape[:-1] + (num_samples,))
    points = rays_o[..., None, :] + rays_d[..., None, :] * t[..., :, None]
    density, color, label = scene_density_color(points, field_offset)
    weights = compositing.weights_from_density(
        density, compositing.distances_from_tvals(t, rays_d)
    )
    rgb = torch.sum(weights * color, dim=-2)
    one_hot = F.one_hot(label, _BLOB_CENTERS.shape[0] + 1).to(weights.dtype)
    label_probs = torch.sum(weights * one_hot, dim=-2)
    leftover = 1.0 - torch.sum(weights, dim=-2)
    label_probs[..., 0] += leftover[..., 0]
    return rgb, torch.argmax(label_probs, dim=-1)


def forward_facing_poses(
    num: int, spread: float = 0.15, device="cuda"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """LLFF-style forward-facing cameras: a small grid of positions on the
    plane ``z = 0``, all looking straight down ``-z`` (the OpenGL
    convention the NDC warp assumes)."""
    side = int(np.ceil(np.sqrt(num)))
    xs = np.linspace(-spread, spread, side)
    offsets = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)[:num]
    pose_o = torch.as_tensor(
        np.stack([offsets[:, 0], offsets[:, 1], np.zeros(num)], -1).astype(np.float32),
        device=device,
    )
    fwd = torch.tensor([0.0, 0.0, -1.0], device=device).expand(num, 3)
    return pose_o, cameras.direction_to_rotation_matrix(fwd)


def _render_views(pose_o, pose_r, image_hw, focal, near, far, num_samples, field_offset=None):
    """Ground truth ``(rgb [B, H, W, 3], label [B, H, W])`` of the views,
    rendered in chunks of rays so the ``[rays, samples, blobs]``
    intermediates stay small."""
    rays_o, rays_d = cameras.pose_to_rays(pose_o, pose_r, image_hw, image_hw, focal)
    flat_o, flat_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    chunk = 8192
    parts = [
        render_ground_truth(flat_o[i:i + chunk], flat_d[i:i + chunk], near, far, num_samples,
                            field_offset)
        for i in range(0, flat_o.shape[0], chunk)
    ]
    b = pose_o.shape[0]
    return (torch.cat([p[0] for p in parts]).reshape(b, image_hw, image_hw, 3),
            torch.cat([p[1] for p in parts]).reshape(b, image_hw, image_hw))


def synthesize_forward_facing(
    num_views: int = 9,
    image_hw: int = 48,
    focal: float = 60.0,
    distance: float = 4.0,
    near: float = 2.0,
    far: float = 6.5,
    num_samples: int = 512,
    device="cuda",
) -> SceneData:
    """Forward-facing synthetic dataset for the NDC training path, on
    ``device``: cameras at z=0 looking down -z, the blob field translated
    to z = -distance so the whole scene lies beyond the NDC near plane."""
    pose_o, pose_r = forward_facing_poses(num_views, device=device)
    rgb, _ = _render_views(pose_o, pose_r, image_hw, focal, near, far, num_samples,
                           field_offset=(0.0, 0.0, -distance))
    return SceneData(images=rgb, pose_o=pose_o, pose_r=pose_r, focal=float(focal))


def synthesize_scene(
    num_views: int = 8,
    image_hw: int = 64,
    focal: float = 80.0,
    radius: float = 4.0,
    near: float = 2.0,
    far: float = 6.0,
    num_samples: int = 512,
    with_labels: bool = False,
    pose_seed: Optional[int] = None,
    device="cuda",
) -> SceneData:
    """A full synthetic dataset on ``device``: images, poses and focal
    (and labels)."""
    pose_o, pose_r = spherical_poses(num_views, radius, seed=pose_seed, device=device)
    rgb, label = _render_views(pose_o, pose_r, image_hw, focal, near, far, num_samples)
    return SceneData(
        images=rgb,
        pose_o=pose_o,
        pose_r=pose_r,
        focal=float(focal),
        labels=label if with_labels else None,
    )
