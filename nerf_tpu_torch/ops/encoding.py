"""Positional encoders: classic NeRF frequency encoding and mip-NeRF IPE.

PyTorch counterpart of ``nerf_tpu/ops/encoding.py``:

* the classic half, ``bbox_frequency_scales``, ``frequency_scales_np``,
  ``frequency_encoding`` and ``attenuated_frequency_encoding``, with the
  same ``[sin(x*f_0..f_{L-1}), cos(x*f_0..f_{L-1})]`` per-scalar feature
  layout, and the constants of the kernels that encode inside themselves:
  ``enc_consts`` (K8, ``nerf_tpu/ops/pallas/fused_mlp.py::_enc_consts``)
  and ``frequency_placement`` (K9);
* the mip half, ``expected_sin``, ``lift_gaussian``,
  ``conical_frustum_to_gaussian``, ``cylinder_to_gaussian``, ``cast_rays``
  and ``integrated_pos_enc``, term for term (the same closed forms, the
  same feature layout: scale outer, coordinate inner, sin block then cos
  block).

The scale constants are computed here (``torch.linspace`` exponents in
float32, ``torch.pow``) and cached per ``(size, bound)``.  They agree with
the JAX package's constants to within 2 ulp at the sizes and bounds the
classic models use ((12 or 20) x (6.0 or 20.0)), but not bitwise: the JAX
values carry XLA's rounding of ``jnp.linspace``, which neither
``torch.linspace`` nor a float64 linspace reproduces.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

_SCALES_CACHE: Dict[Tuple[int, float], np.ndarray] = {}


def frequency_scales_np(size: int, bbox_max_abs: float) -> np.ndarray:
    """The cached float32 scale constants of the classic encoder as numpy.

    The lowest frequency is ``pi / (2 * bbox_max_abs)`` so the coarsest
    sinusoid spans the scene bounding box; the ``size // 2`` frequencies are
    octaves above it (``size`` counts sin+cos features per scalar).
    """
    key = (int(size), float(bbox_max_abs))
    if key not in _SCALES_CACHE:
        start = -math.log2(bbox_max_abs)
        exponents = torch.linspace(
            start, start + size / 2.0 - 1.0, size // 2, dtype=torch.float32
        )
        scales = torch.pow(2.0, exponents) * (math.pi / 2.0)
        _SCALES_CACHE[key] = scales.numpy()
    return _SCALES_CACHE[key]


def bbox_frequency_scales(
    size: int, bbox_max_abs: float, device="cuda"
) -> torch.Tensor:
    """Frequency scales ``[size // 2]`` (float32) on ``device``, a copy of
    the cached constants."""
    return torch.tensor(frequency_scales_np(size, bbox_max_abs), device=device)


def frequency_encoding(x: torch.Tensor, frequency_scales: torch.Tensor) -> torch.Tensor:
    """Classic per-scalar sin/cos frequency encoding.

    Each scalar of the last axis expands to ``[sin(x*f), cos(x*f)]`` over the
    ``L`` scales and the per-scalar blocks are concatenated: output width
    ``x.shape[-1] * 2 * L``.
    """
    xf = x[..., :, None] * frequency_scales  # [..., D, L]
    emb = torch.cat([torch.sin(xf), torch.cos(xf)], dim=-1)  # [..., D, 2L]
    return emb.reshape(emb.shape[:-2] + (-1,))


def attenuated_frequency_encoding(
    x: torch.Tensor, diag_covariance: torch.Tensor, frequency_scales: torch.Tensor
) -> torch.Tensor:
    """``frequency_encoding`` with IPE-style attenuation: each feature is
    scaled by ``exp(-0.5 * f^2 * var)`` of its scalar's variance
    ``diag_covariance [..., D]`` (the amplitude the reference computes and
    never applies), an anti-aliased classic encoder."""
    xf = x[..., :, None] * frequency_scales
    amplitude = torch.exp(-0.5 * (frequency_scales ** 2) * diag_covariance[..., :, None])
    emb = torch.cat([amplitude * torch.sin(xf), amplitude * torch.cos(xf)], dim=-1)
    return emb.reshape(emb.shape[:-2] + (-1,))


def enc_consts(size: int, bound: float, dims: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """K8's encoding constants ``(S [dims, dims*size], phase [1, dims*size])``
    with ``sin(x @ S + phase)`` the frequency encoding of ``x [..., dims]``:
    row ``c`` holds the ``size // 2`` frequencies in scalar ``c``'s sin and
    cos blocks, the cos block with phase ``pi/2``.  The frequencies are
    computed in float64 and rounded to float32 once, as
    ``nerf_tpu/ops/pallas/fused_mlp.py::_enc_consts`` computes them, so
    both give the same bits (they are not ``frequency_scales_np``'s)."""
    half = size // 2
    start = -np.log2(bound)
    f = np.power(2.0, np.linspace(start, start + half - 1.0, half)) * (np.pi / 2.0)
    s = np.zeros((dims, dims * size), np.float32)
    phase = np.zeros((1, dims * size), np.float32)
    for c in range(dims):
        s[c, c * size:c * size + half] = f
        s[c, c * size + half:c * size + 2 * half] = f
        phase[0, c * size + half:c * size + 2 * half] = np.pi / 2.0
    return s, phase


def frequency_placement(
    scales: torch.Tensor, dims: int = 3
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lane placement of the flat frequency encoder (K9's fine
    encoding): ``(S [dims, dims*2L], is_cos [1, dims*2L])`` on ``scales``'s
    device, row ``c`` carrying the given ``L`` scales in scalar ``c``'s sin
    and cos blocks and ``is_cos`` 1 on the cos lanes.  It takes the scale
    tensor itself (a model's ``x_scales`` buffer) and computes nothing
    anew, so ``sum_c x_c * S[c]`` is bitwise ``frequency_encoding``'s
    sine argument for the same scales."""
    half = scales.shape[-1]
    size = 2 * half
    s = torch.zeros((dims, dims * size), dtype=scales.dtype, device=scales.device)
    is_cos = torch.zeros((1, dims * size), dtype=scales.dtype, device=scales.device)
    for c in range(dims):
        s[c, c * size:c * size + half] = scales
        s[c, c * size + half:c * size + size] = scales
        is_cos[0, c * size + half:c * size + size] = 1.0
    return s, is_cos


# -- mip-NeRF integrated positional encoding ---------------------------------


def expected_sin(x: torch.Tensor, x_var: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and variance of ``sin(z)`` for ``z ~ N(x, x_var)``."""
    y = torch.exp(-0.5 * x_var) * torch.sin(x)
    y_var = torch.clamp(
        0.5 * (1.0 - torch.exp(-2.0 * x_var) * torch.cos(2.0 * x)) - y ** 2, min=0.0
    )
    return y, y_var


def lift_gaussian(
    d: torch.Tensor, t_mean, t_var, r_var, diag: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lift a 1-D Gaussian along ray direction ``d`` to a 3-D mean and
    covariance: the diagonal ``[..., N, 3]`` with ``diag``, else full
    ``[..., N, 3, 3]`` covariances."""
    t_mean = torch.as_tensor(t_mean, dtype=d.dtype, device=d.device)
    t_var = torch.as_tensor(t_var, dtype=d.dtype, device=d.device)
    r_var = torch.as_tensor(r_var, dtype=d.dtype, device=d.device)
    mean = d[..., None, :] * t_mean[..., None]
    d_mag_sq = torch.clamp(torch.sum(d ** 2, dim=-1, keepdim=True), min=1e-10)
    if diag:
        d_outer_diag = d ** 2
        null_outer_diag = 1.0 - d_outer_diag / d_mag_sq
        t_cov_diag = t_var[..., None] * d_outer_diag[..., None, :]
        xy_cov_diag = r_var[..., None] * null_outer_diag[..., None, :]
        return mean, t_cov_diag + xy_cov_diag
    d_outer = d[..., :, None] * d[..., None, :]
    eye = torch.eye(d.shape[-1], dtype=d.dtype, device=d.device)
    null_outer = eye - d[..., :, None] * (d / d_mag_sq)[..., None, :]
    t_cov = t_var[..., None, None] * d_outer[..., None, :, :]
    xy_cov = r_var[..., None, None] * null_outer[..., None, :, :]
    return mean, t_cov + xy_cov


def conical_frustum_to_gaussian(
    d: torch.Tensor, t0: torch.Tensor, t1: torch.Tensor, base_radius,
    diag: bool = True, stable: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Moment-matched Gaussian of the cone section ``[t0, t1]``;
    ``base_radius`` is the cone's radius at distance 1.  ``stable`` picks
    mip-NeRF's numerically stable closed form."""
    if stable:
        mu = (t0 + t1) / 2.0
        hw = (t1 - t0) / 2.0
        t_mean = mu + (2.0 * mu * hw ** 2) / (3.0 * mu ** 2 + hw ** 2)
        t_var = (hw ** 2) / 3.0 - (4.0 / 15.0) * (
            (hw ** 4 * (12.0 * mu ** 2 - hw ** 2)) / (3.0 * mu ** 2 + hw ** 2) ** 2
        )
        r_var = base_radius ** 2 * (
            (mu ** 2) / 4.0
            + (5.0 / 12.0) * hw ** 2
            - (4.0 / 15.0) * (hw ** 4) / (3.0 * mu ** 2 + hw ** 2)
        )
    else:
        t_mean = (3.0 * (t1 ** 4 - t0 ** 4)) / (4.0 * (t1 ** 3 - t0 ** 3))
        r_var = base_radius ** 2 * (3.0 / 20.0 * (t1 ** 5 - t0 ** 5) / (t1 ** 3 - t0 ** 3))
        t_mosq = 3.0 / 5.0 * (t1 ** 5 - t0 ** 5) / (t1 ** 3 - t0 ** 3)
        t_var = t_mosq - t_mean ** 2
    return lift_gaussian(d, t_mean, t_var, r_var, diag)


def cylinder_to_gaussian(
    d: torch.Tensor, t0: torch.Tensor, t1: torch.Tensor, radius, diag: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Moment-matched Gaussian of a cylinder section ``[t0, t1]``."""
    t_mean = (t0 + t1) / 2.0
    r_var = radius ** 2 / 4.0
    t_var = (t1 - t0) ** 2 / 12.0
    return lift_gaussian(d, t_mean, t_var, r_var, diag)


def cast_rays(
    t_vals: torch.Tensor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    radii,
    ray_shape: str = "cone",
    diag: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[..., S]`` fencepost distances -> the ``S - 1`` interval
    Gaussians' means ``[..., S-1, 3]`` (offset by the ray origins) and
    covariances."""
    t0 = t_vals[..., :-1]
    t1 = t_vals[..., 1:]
    if ray_shape == "cone":
        gaussian_fn = conical_frustum_to_gaussian
    elif ray_shape == "cylinder":
        gaussian_fn = cylinder_to_gaussian
    else:
        raise ValueError(f"unknown ray_shape: {ray_shape!r}")
    means, covs = gaussian_fn(directions, t0, t1, radii, diag)
    return means + origins[..., None, :], covs


def integrated_pos_enc(
    means: torch.Tensor, covs_diag: torch.Tensor, min_deg: int, max_deg: int
) -> torch.Tensor:
    """Integrated positional encoding of Gaussians: ``expected_sin`` of the
    means and diagonal covariances scaled by ``2^[min_deg, max_deg)``, at
    ``y`` and ``y + pi/2``; width ``2 * D * (max_deg - min_deg)``, laid out
    ``[sin(x0*s0), sin(x1*s0), sin(x2*s0), sin(x0*s1), ..., cos(...)]``."""
    scales = torch.tensor(
        [2.0 ** i for i in range(min_deg, max_deg)], dtype=means.dtype, device=means.device
    )
    shape = means.shape[:-1] + (-1,)
    y = (means[..., None, :] * scales[:, None]).reshape(shape)
    y_var = (covs_diag[..., None, :] * scales[:, None] ** 2).reshape(shape)
    return expected_sin(
        torch.cat([y, y + 0.5 * math.pi], dim=-1), torch.cat([y_var, y_var], dim=-1)
    )[0]
