"""Ray samplers: linear stratified and log-spaced bbox coarse sampling, and
inverse-CDF fine sampling.

PyTorch counterpart of ``sample_log_bbox``, ``sample_linear``,
``pdf_uniforms``, ``sample_pdf`` and ``merge_samples`` in
``nerf_tpu/ops/sampling.py``, with ``pdf_cdf_at``, the inverse of
``sample_pdf``, in which the port's checks compare fine samples.  The JAX package
avoids sort, searchsorted and gathers because a TPU serialises them; on a
GPU they are the plain tools, so this module uses ``torch.searchsorted``,
``torch.gather`` and a stable sort where the JAX code builds dense masks.
The results are the same up to the cumulative sum's rounding (the JAX
package sums with a doubling ladder, ``torch.cumsum`` in order).

Randomness is explicit: every random draw takes a ``torch.Generator`` on the
tensors' device, and ``sample_pdf`` also accepts its uniforms precomputed.
``draw_step`` makes all the draws of one training step at once
(``StepDraws``), so the train steps take them as inputs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

# The HEAD-generation sampler's near end: 2^-9.43633744014 of the bbox
# diagonal (about 0.1 world units for the default +-20 box).
LOG_SAMPLING_MIN_EXPONENT = -9.43633744014


def _stratified_jitter(
    generator: Optional[torch.Generator], samples: torch.Tensor,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Jitter fencepost samples uniformly within midpoint-bounded bins (the
    first and last bins are clamped at the endpoints); ``u``, the uniforms,
    are drawn from ``generator`` unless given."""
    midpoints = 0.5 * (samples[..., 1:] + samples[..., :-1])
    lower = torch.cat([samples[..., :1], midpoints], dim=-1)
    upper = torch.cat([midpoints, samples[..., -1:]], dim=-1)
    if u is None:
        if generator is None:
            raise ValueError("randomly_sample=True requires a torch.Generator")
        u = torch.rand(
            samples.shape, generator=generator, dtype=samples.dtype, device=samples.device
        )
    return lower + (upper - lower) * u


def sample_log_bbox(
    generator: Optional[torch.Generator],
    batch_shape: Sequence[int],
    num_samples: int,
    bbox_diagonal: float,
    randomly_sample: bool = True,
    dtype=torch.float32,
    device="cuda",
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """HEAD-generation fenceposts, ``batch_shape + (num_samples,)``:
    ``2^linspace(LOG_SAMPLING_MIN_EXPONENT, 0, S) * bbox_diagonal``, jittered
    within midpoint-bounded bins when ``randomly_sample`` (uniforms ``u``
    drawn from ``generator`` unless given)."""
    samples = torch.pow(
        2.0, torch.linspace(LOG_SAMPLING_MIN_EXPONENT, 0.0, num_samples, dtype=dtype, device=device)
    )
    samples = samples.expand(tuple(batch_shape) + (num_samples,))
    if randomly_sample:
        samples = _stratified_jitter(generator, samples, u)
    return samples * bbox_diagonal


def sample_linear(
    generator: Optional[torch.Generator],
    batch_shape: Sequence[int],
    num_samples: int,
    near: float,
    far: float,
    randomly_sample: bool = True,
    dtype=torch.float32,
    device="cuda",
) -> torch.Tensor:
    """Linear stratified t-values between the near and far planes,
    ``batch_shape + (num_samples,)``."""
    samples = torch.linspace(near, far, num_samples, dtype=dtype, device=device)
    samples = samples.expand(tuple(batch_shape) + (num_samples,))
    if randomly_sample:
        samples = _stratified_jitter(generator, samples)
    return samples


def pdf_uniforms(
    generator: Optional[torch.Generator],
    batch_shape: Sequence[int],
    num_samples: int,
    randomly_sample: bool = True,
    dtype=torch.float32,
    device="cuda",
) -> torch.Tensor:
    """The stratified uniforms ``sample_pdf`` inverts: one per equal-mass
    stratum, jittered when ``randomly_sample``, else stratum midpoints."""
    grid = torch.arange(num_samples, dtype=dtype, device=device)
    shape = tuple(batch_shape) + (num_samples,)
    if randomly_sample:
        if generator is None:
            raise ValueError("randomly_sample=True requires a torch.Generator")
        jitter = torch.rand(shape, generator=generator, dtype=dtype, device=device)
        return (grid + jitter) / num_samples
    return ((grid + 0.5) / num_samples).expand(shape)


def _cdf_fenceposts(weights: torch.Tensor, eps: float) -> torch.Tensor:
    """``sample_pdf``'s cdf at the ``B + 1`` fenceposts of ``B`` weighted
    bins: ``eps`` added to every bin, normalised, summed, made monotone,
    0 at the first fencepost and exactly 1 at the last."""
    weights = weights + eps
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cummax(torch.cumsum(pdf, dim=-1), dim=-1).values
    return torch.cat(
        [torch.zeros_like(cdf[..., :1]), cdf[..., :-1], torch.ones_like(cdf[..., :1])],
        dim=-1,
    )


def pdf_cdf_at(bins: torch.Tensor, weights: torch.Tensor, t_vals: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """The piecewise-linear cdf that ``sample_pdf`` inverts, at ``t_vals
    [..., S]`` (``bins [..., B+1]``, ``weights [..., B]`` as there): the
    inverse of ``sample_pdf``, so ``pdf_cdf_at(bins, w, sample_pdf(...,
    u=u)) = u`` up to rounding (and to less than ``eps`` of mass in a bin
    that holds less).  A comparison of fine samples in this probability
    space does not magnify the rounding of a bin that holds almost no
    mass, as one in t does."""
    cdf = _cdf_fenceposts(weights, eps)
    n_bins = bins.shape[-1] - 1
    idx = torch.clamp(torch.searchsorted(bins.contiguous(), t_vals.contiguous(), right=True) - 1,
                      0, n_bins - 1)
    lo_b, hi_b = torch.gather(bins, -1, idx), torch.gather(bins, -1, idx + 1)
    lo_c, hi_c = torch.gather(cdf, -1, idx), torch.gather(cdf, -1, idx + 1)
    frac = torch.clamp((t_vals - lo_b) / (hi_b - lo_b), 0.0, 1.0)
    return lo_c + frac * (hi_c - lo_c)


def sample_pdf(
    generator: Optional[torch.Generator],
    bins: torch.Tensor,
    weights: torch.Tensor,
    num_samples: int,
    randomly_sample: bool = True,
    eps: float = 1e-5,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inverse-CDF sampling from a piecewise-constant PDF.

    Args:
        generator: draws the uniforms when ``randomly_sample`` and ``u`` is
            not given.
        bins: ``[..., B+1]`` fencepost positions of the histogram bins.
        weights: ``[..., B]`` unnormalised per-bin weights.
        num_samples: number of fine samples S per ray.
        randomly_sample: jittered uniforms when True, stratum midpoints when
            False.
        eps: mass added to every bin so empty rays still sample uniformly.
        u: optional precomputed uniforms ``[..., S]`` (sorted along the last
            axis), for example the JAX package's ``pdf_uniforms``.

    Returns:
        ``[..., S]`` sorted fine t-values.
    """
    cdf = _cdf_fenceposts(weights, eps)
    if u is None:
        u = pdf_uniforms(
            generator, bins.shape[:-1], num_samples,
            randomly_sample=randomly_sample, dtype=bins.dtype, device=bins.device,
        )
    u = u.expand(bins.shape[:-1] + (num_samples,)).contiguous()

    # The bin b with cdf[b] <= u < cdf[b+1]; the clamp closes the top
    # selection edge, so a u that rounds to 1.0 lands in the last bin
    # instead of matching none.
    n_bins = bins.shape[-1] - 1
    idx = torch.searchsorted(cdf.contiguous(), u, right=True) - 1
    idx = torch.clamp(idx, 0, n_bins - 1)
    cdf_below = torch.gather(cdf, -1, idx)
    cdf_above = torch.gather(cdf, -1, idx + 1)
    bins_below = torch.gather(bins, -1, idx)
    bins_above = torch.gather(bins, -1, idx + 1)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def merge_samples(coarse: torch.Tensor, fine: torch.Tensor) -> torch.Tensor:
    """Union of two sorted t-value sets, sorted along the sample axis,
    ``[..., Sc + Sf]``.  A stable sort keeps coarse before fine on ties."""
    merged = torch.cat([coarse, fine], dim=-1)
    return torch.sort(merged, dim=-1, stable=True).values


class StepDraws(NamedTuple):
    """Every random draw of one training step, made beforehand so a step
    can be replayed or fed the JAX package's draws: the coarse t-values
    ``[B, Sc]``, the coarse density noise ``[B, Sc]``, the pdf uniforms
    ``[B, Sf]`` and the fine density noise ``[B, Sf]`` (``[B, Sc + Sf]`` in
    the re-evaluate formulation, whose fine pass covers the merged set).
    Noise is already scaled by the noise std (zeros without noise); the
    uniforms are ``None`` without a fine stage.  For the mip family the
    coarse t-values are the ``Sc`` log-bbox fenceposts and the noise is per
    interval, ``[B, Sc - 1]``."""

    t_coarse: torch.Tensor
    noise_c: torch.Tensor
    u: Optional[torch.Tensor] = None
    noise_f: Optional[torch.Tensor] = None


def draw_step(
    generator: Optional[torch.Generator],
    render,
    num_rays: int,
    device="cuda",
    bbox_diagonal: Optional[float] = None,
) -> StepDraws:
    """The draws of one step under ``render`` (a ``RenderConfig``), in the
    JAX package's order: stratified t-values, coarse noise, pdf uniforms,
    fine noise.  With ``bbox_diagonal`` (the mip family) the draws are the
    log-bbox fenceposts and the per-interval noise."""
    sc, sf = render.num_coarse_samples, render.num_fine_samples
    std = render.density_noise_std

    def noise(n):
        if std == 0.0:
            return torch.zeros((num_rays, n), device=device)
        if generator is None:
            raise ValueError("density noise requires a torch.Generator")
        return std * torch.randn((num_rays, n), generator=generator, device=device)

    if bbox_diagonal is not None:
        t_coarse = sample_log_bbox(generator, (num_rays,), sc, bbox_diagonal,
                                   randomly_sample=render.randomly_sample, device=device)
        return StepDraws(t_coarse, noise(sc - 1))
    t_coarse = sample_linear(generator, (num_rays,), sc, render.near, render.far,
                             randomly_sample=render.randomly_sample, device=device)
    noise_c = noise(sc)
    if sf == 0:
        return StepDraws(t_coarse, noise_c)
    u = pdf_uniforms(generator, (num_rays,), sf, randomly_sample=render.randomly_sample,
                     device=device)
    return StepDraws(t_coarse, noise_c, u, noise(sf if render.reuse_coarse_in_fine else sc + sf))
