"""Device-resident ray bank (counterpart of ``nerf_tpu/data/rays.py``).

Every ray and pixel of the training images is computed once into flat
tensors on the device; batches are random gathers, with no host work per
step.

* ``RayBank.from_images``: world-space rays per pixel from poses + focal.
* ``RayBank.gather``: a batch by given flat indices (tests feed both
  packages the same indices through it).
* ``RayBank.sample_batch``: uniform-with-replacement batch drawn from a
  ``torch.Generator`` on the bank's device.
* ``RayBank.sample_block_stratified``: per-image stratified sampling over
  an ``nv x nh`` block grid, K rays per block.
* ``RayBank.iter_epoch``: exact once-per-epoch coverage from a numpy
  permutation.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from nerf_tpu_torch.ops import cameras


def _as_tensor(x, device, dtype=None) -> Optional[torch.Tensor]:
    if x is None:
        return None
    return torch.as_tensor(x if torch.is_tensor(x) else np.array(x), dtype=dtype, device=device)


@dataclasses.dataclass
class RayBank:
    """Flat arrays of all training rays, leading dim ``N = B * H * W``
    except the per-image ``states_*`` tables (gathered through
    ``image_index``)."""

    rays_o: torch.Tensor  # [N, 3] world-space origins
    rays_d: torch.Tensor  # [N, 3] world-space directions
    pixels: torch.Tensor  # [N, 3] ground-truth colors
    labels: Optional[torch.Tensor]  # [N] int segmentation labels, or None
    image_index: torch.Tensor  # [N] which image each ray came from
    states_x: Optional[torch.Tensor]  # [B, Kx] per-scene latents, or None
    states_d: Optional[torch.Tensor]  # [B, Kd]
    image_shape: tuple  # (B, H, W)
    focal_length: float

    @property
    def num_rays(self) -> int:
        return self.rays_o.shape[0]

    @property
    def device(self) -> torch.device:
        return self.rays_o.device

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_images(
        images,
        poses_o,
        poses_r,
        focal_length: float,
        labels=None,
        states_x=None,
        states_d=None,
        use_ndc: bool = False,
        ndc_near: float = 1.0,
        device=None,
    ) -> "RayBank":
        """Build the bank from ``[B, H, W, 3]`` images and camera poses
        ``poses_o [B, 3]`` / ``poses_r [B, 3, 3]`` (tensors or numpy
        arrays), on ``device`` (the images' device when ``None`` and they
        are a tensor, else the card).  ``use_ndc`` warps rays to normalized
        device coordinates for forward-facing scenes."""
        if device is None:
            device = images.device if torch.is_tensor(images) else "cuda"
        images = _as_tensor(images, device, torch.float32)
        poses_o = _as_tensor(poses_o, device, torch.float32)
        poses_r = _as_tensor(poses_r, device, torch.float32)
        b, h, w = images.shape[:3]
        rays_o, rays_d = cameras.pose_to_rays(poses_o, poses_r, h, w, focal_length)
        if use_ndc:
            rays_o, rays_d = cameras.ndc_rays(rays_o, rays_d, h, w, focal_length, near=ndc_near)
        n = b * h * w
        return RayBank(
            rays_o=rays_o.reshape(n, 3).contiguous(),
            rays_d=rays_d.reshape(n, 3).contiguous(),
            pixels=images.reshape(n, images.shape[-1]).contiguous(),
            labels=None if labels is None else _as_tensor(labels, device).reshape(n),
            image_index=torch.arange(b, device=device).repeat_interleave(h * w),
            states_x=_as_tensor(states_x, device, torch.float32),
            states_d=_as_tensor(states_d, device, torch.float32),
            image_shape=(b, h, w),
            focal_length=float(focal_length),
        )

    # -- batch sampling -------------------------------------------------------

    def gather(self, idx) -> Dict[str, torch.Tensor]:
        """A batch dict by flat ray index."""
        idx = torch.as_tensor(idx, device=self.device, dtype=torch.long)
        batch = {
            "rays_o": self.rays_o[idx],
            "rays_d": self.rays_d[idx],
            "pixels": self.pixels[idx],
        }
        if self.labels is not None:
            batch["labels"] = self.labels[idx]
        img_idx = self.image_index[idx]
        if self.states_x is not None:
            batch["states_x"] = self.states_x[img_idx]
        if self.states_d is not None:
            batch["states_d"] = self.states_d[img_idx]
        return batch

    def sample_indices(self, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        return torch.randint(
            0, self.num_rays, (batch_size,), generator=generator, device=self.device
        )

    def sample_batch(self, generator: torch.Generator, batch_size: int) -> Dict[str, torch.Tensor]:
        """Uniform-with-replacement random batch (the shuffled-DataLoader
        analogue)."""
        return self.gather(self.sample_indices(generator, batch_size))

    def sample_block_stratified(
        self,
        generator: torch.Generator,
        image_id: int,
        num_vertical_blocks: int = 8,
        num_horizontal_blocks: int = 8,
        num_samples_per_block: int = 2,
    ) -> Dict[str, torch.Tensor]:
        """Block-stratified sampling from one image: ``K`` rays drawn
        uniformly from every block of an ``nv x nh`` grid, flat
        ``K * nv * nh`` rays with the pixel coordinates ``image_hi`` /
        ``image_wi``."""
        _, h, w = self.image_shape
        vbs = h // num_vertical_blocks
        hbs = w // num_horizontal_blocks
        n_blocks = num_vertical_blocks * num_horizontal_blocks
        block_ray_idx = torch.randint(
            0, vbs * hbs, (num_samples_per_block, n_blocks),
            generator=generator, device=self.device,
        )
        return self.gather_block_stratified(
            block_ray_idx, image_id, num_vertical_blocks, num_horizontal_blocks
        )

    def gather_block_stratified(
        self,
        block_ray_idx: torch.Tensor,
        image_id: int,
        num_vertical_blocks: int,
        num_horizontal_blocks: int,
    ) -> Dict[str, torch.Tensor]:
        """The block-stratified batch for given in-block indices
        ``[K, nv * nh]`` (what ``sample_block_stratified`` draws)."""
        _, h, w = self.image_shape
        vbs = h // num_vertical_blocks
        hbs = w // num_horizontal_blocks
        block_ray_idx = torch.as_tensor(block_ray_idx, device=self.device, dtype=torch.long)
        block_idx = torch.arange(block_ray_idx.shape[1], device=self.device)[None, :]
        image_wi = block_ray_idx % hbs + (block_idx % num_horizontal_blocks) * hbs
        image_hi = block_ray_idx // hbs + (block_idx // num_horizontal_blocks) * vbs
        flat = (image_id * h + image_hi) * w + image_wi
        batch = self.gather(flat.reshape(-1))
        batch["image_hi"] = image_hi.reshape(-1)
        batch["image_wi"] = image_wi.reshape(-1)
        return batch

    # -- epoch iteration (host permutation) ----------------------------------

    def iter_epoch(
        self, seed: int, batch_size: int, drop_last: bool = True
    ) -> Iterator[Dict[str, torch.Tensor]]:
        """Exact-coverage epoch iterator (the same numpy permutation as the
        JAX package for a seed)."""
        perm = np.random.default_rng(seed).permutation(self.num_rays)
        stop = self.num_rays - self.num_rays % batch_size if drop_last else self.num_rays
        for start in range(0, stop, batch_size):
            yield self.gather(perm[start:start + batch_size])
