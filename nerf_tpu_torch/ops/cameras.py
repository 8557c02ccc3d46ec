"""Camera geometry: pinhole ray generation, pose math, world transforms, NDC.

PyTorch counterpart of ``nerf_tpu/ops/cameras.py``, function for function.
Conventions are OpenGL's: pixel ``(y, x)`` maps to
``[(x - 0.5(W-1))/f, -(y - 0.5(H-1))/f, -1]`` and a rotation's columns are
``[right, up, -eye]``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def generate_rays(
    image_h: int, image_w: int, focal_length: float,
    dtype=torch.float32, device="cuda",
) -> torch.Tensor:
    """Per-pixel camera-frame ray directions ``[H, W, 3]``."""
    y, x = torch.meshgrid(
        torch.arange(image_h, dtype=dtype, device=device),
        torch.arange(image_w, dtype=dtype, device=device),
        indexing="ij",
    )
    x = (x - 0.5 * float(image_w - 1)) / focal_length
    y = (y - 0.5 * float(image_h - 1)) / focal_length
    return torch.stack([x, -y, -torch.ones_like(x)], dim=-1)


def spherical_to_cartesian(yaw: torch.Tensor, elevation: torch.Tensor) -> torch.Tensor:
    """Yaw/elevation (radians) to a unit xyz vector, z-up."""
    return torch.stack(
        [
            torch.cos(yaw) * torch.cos(elevation),
            torch.sin(yaw) * torch.cos(elevation),
            torch.sin(elevation),
        ],
        dim=-1,
    )


def get_rotation_matrix(eye_vector: torch.Tensor, up_vector: torch.Tensor) -> torch.Tensor:
    """Camera-to-world rotation ``[..., 3, 3]`` with columns
    ``[cross(eye, up), up, -eye]``."""
    return torch.stack(
        [torch.linalg.cross(eye_vector, up_vector), up_vector, -eye_vector],
        dim=-1,
    )


def direction_to_rotation_matrix(direction: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Camera rotation from a viewing direction alone: up is world +z made
    orthogonal to the direction, or +y when looking straight up or down."""
    d = direction / torch.clamp(
        torch.linalg.norm(direction, dim=-1, keepdim=True), min=eps
    )
    world_up = torch.tensor([0.0, 0.0, 1.0], dtype=d.dtype, device=d.device).expand(d.shape)
    up = world_up - d * torch.sum(d * world_up, dim=-1, keepdim=True)
    up_norm = torch.linalg.norm(up, dim=-1, keepdim=True)
    fallback = torch.tensor([0.0, 1.0, 0.0], dtype=d.dtype, device=d.device).expand(d.shape)
    up = torch.where(up_norm > eps, up / torch.clamp(up_norm, min=eps), fallback)
    return get_rotation_matrix(d, up)


def rays_to_world_coordinates(
    rays: torch.Tensor, camera_o: torch.Tensor, camera_r: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate camera-frame directions into the world; origins pass through.
    ``d_world = R @ d_cam`` as the broadcast multiply-sum the JAX package
    uses."""
    rays_d = torch.sum(camera_r * rays[..., None, :], dim=-1)
    return camera_o, rays_d


def pose_to_rays(
    pose_o: torch.Tensor,
    pose_r: torch.Tensor,
    image_h: int,
    image_w: int,
    focal_length: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """World-space ray grid for a batch of poses: ``pose_o [B, 3]``,
    ``pose_r [B, 3, 3]`` -> ``rays_o, rays_d`` each ``[B, H, W, 3]``."""
    rays = generate_rays(
        image_h, image_w, focal_length, dtype=pose_o.dtype, device=pose_o.device
    )
    batch = pose_o.shape[0]
    rays = rays[None].expand(batch, image_h, image_w, 3)
    camera_o = pose_o[:, None, None, :].expand(batch, image_h, image_w, 3)
    camera_r = pose_r[:, None, None, :, :].expand(batch, image_h, image_w, 3, 3)
    return rays_to_world_coordinates(rays, camera_o, camera_r)


def ndc_rays(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    image_h: int,
    image_w: int,
    focal_length: float,
    near: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shift rays to normalized device coordinates (LLFF forward-facing,
    NeRF paper appendix C): advance origins to the near plane, then warp the
    frustum to the cube ``[-1, 1]^3``."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    ox, oy, oz = rays_o[..., 0], rays_o[..., 1], rays_o[..., 2]
    dx, dy, dz = rays_d[..., 0], rays_d[..., 1], rays_d[..., 2]

    o0 = -focal_length / (0.5 * image_w) * ox / oz
    o1 = -focal_length / (0.5 * image_h) * oy / oz
    o2 = 1.0 + 2.0 * near / oz

    d0 = -focal_length / (0.5 * image_w) * (dx / dz - ox / oz)
    d1 = -focal_length / (0.5 * image_h) * (dy / dz - oy / oz)
    d2 = -2.0 * near / oz

    return torch.stack([o0, o1, o2], dim=-1), torch.stack([d0, d1, d2], dim=-1)
