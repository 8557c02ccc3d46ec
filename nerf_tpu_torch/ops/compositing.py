"""Volume-rendering quadrature: alpha compositing along rays.

PyTorch counterpart of the classic half of ``nerf_tpu/ops/compositing.py``:
interval lengths from t-values with the ``1e10`` far pad,
``alpha = exp(-relu(sigma) * dist)``, transmittance as the shifted product
of ``alpha + 1e-10``, and the order-free union compositing of two sorted
sample blocks that the hierarchical-reuse renderer uses.

Shapes: density ``[..., S, 1]``, t-values ``[..., S]``, weights
``[..., S, 1]``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_FAR = 1e10  # length of the last interval of a ray


def distances_from_tvals(t_vals: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
    """``dist_i = (t_{i+1} - t_i) * ||d||`` with the last interval padded to
    ``1e10``; ``[..., S, 1]``."""
    deltas = (t_vals[..., 1:] - t_vals[..., :-1]) * torch.linalg.norm(
        rays_d, dim=-1, keepdim=True
    )
    dists = deltas[..., None]
    pad = torch.full_like(dists[..., :1, :], _FAR)
    return torch.cat([dists, pad], dim=-2)


def weights_from_density(density: torch.Tensor, dists: torch.Tensor) -> torch.Tensor:
    """``w_i = (1 - alpha_i) * prod_{j<i}(alpha_j + 1e-10)`` with
    ``alpha = exp(-relu(sigma) * dist)``."""
    alpha = torch.exp(-torch.relu(density) * dists)
    trans = torch.cumprod(alpha[..., :-1, :] + 1e-10, dim=-2)
    transmittance = torch.cat([torch.ones_like(trans[..., :1, :]), trans], dim=-2)
    return (1.0 - alpha) * transmittance


def _union_cross_masks(
    t_coarse: torch.Tensor, t_fine: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ge [..., Sc, Sf]``: fine at or after each coarse sample;
    ``gt [..., Sf, Sc]``: coarse strictly after each fine sample."""
    ge = t_fine[..., None, :] >= t_coarse[..., :, None]
    gt = t_coarse[..., None, :] > t_fine[..., :, None]
    return ge, gt


def _union_dists(
    t_coarse: torch.Tensor,
    t_fine: torch.Tensor,
    norm: torch.Tensor,
    cross_masks: Tuple[torch.Tensor, torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    inf = float("inf")
    ge, gt = cross_masks
    # Coarse slots: next coarse neighbour vs first fine >= t_c (a fine
    # sample tied with a coarse one sorts after it).
    own_c = torch.cat([t_coarse[..., 1:], torch.full_like(t_coarse[..., :1], inf)], dim=-1)
    cross_c = torch.amin(torch.where(ge, t_fine[..., None, :], inf), dim=-1)
    succ_c = torch.minimum(own_c, cross_c)
    # Fine slots: next fine neighbour vs first coarse > t_f.
    own_f = torch.cat([t_fine[..., 1:], torch.full_like(t_fine[..., :1], inf)], dim=-1)
    cross_f = torch.amin(torch.where(gt, t_coarse[..., None, :], inf), dim=-1)
    succ_f = torch.minimum(own_f, cross_f)
    dist_c = torch.where(torch.isfinite(succ_c), (succ_c - t_coarse) * norm, _FAR)
    dist_f = torch.where(torch.isfinite(succ_f), (succ_f - t_fine) * norm, _FAR)
    return dist_c[..., None], dist_f[..., None]


def union_dists_sorted(
    t_coarse: torch.Tensor, t_fine: torch.Tensor, rays_d: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Interval lengths of the union of two SORTED t-blocks, each sample's
    successor taken in the total order (t value, coarse before fine on
    ties), scaled by ``||d||``; the ray's last sample gets ``1e10``.

    Returns ``(dist_c [..., Sc, 1], dist_f [..., Sf, 1])``.
    """
    norm = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    return _union_dists(t_coarse, t_fine, norm, _union_cross_masks(t_coarse, t_fine))


def weights_from_union_norm(
    dens_c: torch.Tensor,
    dens_f: torch.Tensor,
    t_coarse: torch.Tensor,
    t_fine: torch.Tensor,
    norm: torch.Tensor,
) -> torch.Tensor:
    """``weights_from_union_sorted`` given ``norm = ||d|| [..., 1]`` in place
    of the ray directions."""
    masks = _union_cross_masks(t_coarse, t_fine)
    dist_c, dist_f = _union_dists(t_coarse, t_fine, norm, masks)
    alpha_c = torch.exp(-torch.relu(dens_c) * dist_c)  # [..., Sc, 1]
    alpha_f = torch.exp(-torch.relu(dens_f) * dist_f)
    log_ac = torch.log(alpha_c[..., 0] + 1e-10)  # [..., Sc]
    log_af = torch.log(alpha_f[..., 0] + 1e-10)

    def excl_cumsum(x):
        c = torch.cumsum(x, dim=-1)
        return torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]], dim=-1)

    ge, gt = masks
    # Coarse log-alphas at or before each fine sample (coarse ties first).
    cross_c = torch.sum(torch.where(gt, 0.0, log_ac[..., None, :]), dim=-1)
    # Fine log-alphas strictly before each coarse sample.
    cross_f = torch.sum(torch.where(ge, 0.0, log_af[..., None, :]), dim=-1)
    w_c = (1.0 - alpha_c) * torch.exp(excl_cumsum(log_ac) + cross_f)[..., None]
    w_f = (1.0 - alpha_f) * torch.exp(excl_cumsum(log_af) + cross_c)[..., None]
    return torch.cat([w_c, w_f], dim=-2)


def weights_from_union_sorted(
    dens_c: torch.Tensor,
    dens_f: torch.Tensor,
    t_coarse: torch.Tensor,
    t_fine: torch.Tensor,
    rays_d: torch.Tensor,
) -> torch.Tensor:
    """Compositing weights of the union of two SORTED sample blocks without
    merging them: each sample's transmittance is the exponential of the
    summed ``log(alpha + 1e-10)`` of every sample before it in the total
    order (t value, coarse before fine on ties).

    Returns ``[..., Sc + Sf, 1]`` weights in concatenated block order.
    """
    norm = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    return weights_from_union_norm(dens_c, dens_f, t_coarse, t_fine, norm)


def composite_rgb(weights: torch.Tensor, color_logits: torch.Tensor) -> torch.Tensor:
    """``sum_i w_i * sigmoid(c_i)`` over the sample axis."""
    return torch.sum(weights * torch.sigmoid(color_logits), dim=-2)


def composite_depth(weights: torch.Tensor, t_vals: torch.Tensor) -> torch.Tensor:
    """Expected termination depth ``sum_i w_i t_i``."""
    return torch.sum(weights[..., 0] * t_vals, dim=-1)


def composite_acc(weights: torch.Tensor) -> torch.Tensor:
    """Accumulated opacity ``sum_i w_i``."""
    return torch.sum(weights[..., 0], dim=-1)


def composite_rgb_with_background(
    weights: torch.Tensor,
    color_logits: torch.Tensor,
    background: Optional[float] = None,
) -> torch.Tensor:
    """``rgb + (1 - acc) * background``, or plain ``rgb`` without one."""
    rgb = composite_rgb(weights, color_logits)
    if background is None:
        return rgb
    acc = composite_acc(weights)[..., None]
    return rgb + (1.0 - acc) * background
