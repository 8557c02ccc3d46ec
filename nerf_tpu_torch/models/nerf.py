"""The NeRF renderers: ray rendering and tiled full-image rendering.

PyTorch counterpart of ``RenderOutput``, ``ClassicNeRF``, ``MipNeRF`` and
``_tiled_over_rays`` in ``nerf_tpu/models/nerf.py``.  Each model is an
``nn.Module`` that owns its MLP; randomness (stratified jitter, the pdf
uniforms, density noise) comes from a ``torch.Generator`` passed in.

With ``cfg.use_pallas`` the classic model runs every MLP evaluation
through the K1 kernel (``ops/kernels/classic_mlp.py``; under autograd its
backward is K1-bwd) and the deterministic hierarchical-reuse fine stage of
``render_image`` through the forward-only K4 kernel
(``ops/kernels/union_eval.py``), ``render_image`` packing the weights and
building their tensor-core operand images once a frame
(``classic_mlp.prepare_weights``); the mip model runs its MLP through K5
(``ops/kernels/mip_mlp.py``, backward K5-bwd) and its deterministic render
through the forward-only K7 (``ops/kernels/mip_train.py``), its
``render_image`` likewise packing the weights and building their forward
images once a frame (``mip_mlp.prepare_weights``).
``render_rays`` also takes a step's random draws made beforehand
(``sampling.StepDraws``), as the train steps pass them.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch import nn

from nerf_tpu_torch.config import ClassicNeRFConfig, MipNeRFConfig, RenderConfig
from nerf_tpu_torch.models.mlp import ClassicMLP, MipMLP
from nerf_tpu_torch.ops import cameras, compositing, encoding, sampling
from nerf_tpu_torch.ops.kernels import classic_mlp, mip_mlp, mip_train, union_eval


class RenderOutput(NamedTuple):
    """Per-ray render results; ``rgb`` carries a stage axis
    ``[..., num_stages, 3]`` (coarse, then fine when present)."""

    rgb: torch.Tensor
    segmentation: Optional[torch.Tensor] = None
    depth: Optional[torch.Tensor] = None
    acc: Optional[torch.Tensor] = None


def _maybe_add_density_noise(
    generator: Optional[torch.Generator], density: torch.Tensor, std: float,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Gaussian density-logit noise: ``noise [..., S]`` (already scaled)
    when given, else drawn from ``generator``."""
    if noise is not None:
        return density + noise[..., None]
    if std == 0.0 or generator is None:
        return density
    noise = torch.randn(
        density.shape, generator=generator, dtype=density.dtype, device=density.device
    )
    return density + noise * std


class ClassicNeRF(nn.Module):
    """The v1.2-generation model: classic frequency encoding and the 8-layer
    view-conditioned MLP, with stratified coarse and inverse-CDF fine
    sampling.  Weights are drawn from ``generator`` (a CPU generator; torch's
    global one when ``None``) and the module is placed on ``device``."""

    def __init__(
        self,
        cfg: ClassicNeRFConfig,
        generator: Optional[torch.Generator] = None,
        device="cuda",
    ):
        super().__init__()
        self.cfg = cfg
        self.mlp = ClassicMLP(cfg, generator=generator, device="cpu")
        x_scales = encoding.frequency_scales_np(cfg.x_positional_encoding_size, cfg.normalize_position)
        self.register_buffer("x_scales", torch.as_tensor(x_scales), persistent=False)
        if cfg.use_viewdirs:
            d_scales = encoding.frequency_scales_np(cfg.d_positional_encoding_size, cfg.direction_bound)
            self.register_buffer("d_scales", torch.as_tensor(d_scales), persistent=False)
        self.to(device)

    # -- encoders ----------------------------------------------------------

    def encode_position(
        self, x: torch.Tensor, states_x: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Frequency encoding of positions; a latent state is appended to
        the xyz scalars before encoding (``density_inputs = 3 + dim``)."""
        if states_x is not None and states_x.shape[-1] > 0:
            states_x = states_x.expand(x.shape[:-1] + states_x.shape[-1:])
            x = torch.cat([x, states_x], dim=-1)
        return encoding.frequency_encoding(x, self.x_scales)

    def encode_direction(
        self, d: torch.Tensor, states_d: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        if states_d is not None and states_d.shape[-1] > 0:
            states_d = states_d.expand(d.shape[:-1] + states_d.shape[-1:])
            d = torch.cat([d, states_d], dim=-1)
        return encoding.frequency_encoding(d, self.d_scales)

    # -- core evaluation ---------------------------------------------------

    def _encode_inputs(self, rays_o, rays_d, t_vals, states_x, states_d):
        """Sample points and their (position, direction) encodings; the
        direction is encoded once per ray and broadcast over its samples."""
        points = rays_o[..., None, :] + rays_d[..., None, :] * t_vals[..., :, None]
        x_enc = self.encode_position(
            points, None if states_x is None else states_x[..., None, :]
        )
        d_enc = None
        if self.cfg.use_viewdirs:
            per_ray = self.encode_direction(rays_d, states_d)
            d_enc = per_ray[..., None, :].expand(points.shape[:-1] + per_ray.shape[-1:])
        return points, x_enc, d_enc

    def encode_inputs_flat(
        self,
        rays_o: torch.Tensor,
        rays_d: torch.Tensor,
        t_vals: torch.Tensor,
        states_x: Optional[torch.Tensor] = None,
        states_d: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Encodings for the fused train kernels: positions encoded on
        ``[rays * S, 3]`` rows with the per-ray latents broadcast to them,
        directions encoded once per ray and broadcast over its samples.
        Returns ``(x_enc [rays, S, XE], d_enc [rays, S, DE] or None)``."""
        n_rays, s = t_vals.shape[0], t_vals.shape[-1]
        points = rays_o[:, None, :] + rays_d[:, None, :] * t_vals[..., None]

        def flat_states(st):
            if st is None or st.shape[-1] == 0:
                return None
            return st[:, None, :].expand(n_rays, s, st.shape[-1]).reshape(-1, st.shape[-1])

        x_enc = self.encode_position(points.reshape(-1, 3), flat_states(states_x))
        x_enc = x_enc.reshape(n_rays, s, -1)
        d_enc = None
        if self.cfg.use_viewdirs:
            per_ray = self.encode_direction(rays_d, states_d)
            d_enc = per_ray[:, None, :].expand(n_rays, s, per_ray.shape[-1])
        return x_enc, d_enc

    def _compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    def forward(
        self,
        rays_o: torch.Tensor,
        rays_d: torch.Tensor,
        t_vals: torch.Tensor,
        states_x: Optional[torch.Tensor] = None,
        states_d: Optional[torch.Tensor] = None,
        mlp_weights: Optional[classic_mlp.PreparedWeights] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Density and color logits at ``o + t*d`` for every sample:
        ``(points [..., S, 3], density [..., S, 1], color [..., S, C])``.
        On the kernel path ``mlp_weights`` are the MLP's weights prepared
        beforehand (``classic_mlp.prepare_weights``), else packed here."""
        points, x_enc, d_enc = self._encode_inputs(rays_o, rays_d, t_vals, states_x, states_d)
        if self._uses_kernels():
            dt = self._compute_dtype()
            lead = x_enc.shape[:-1]
            if mlp_weights is None:
                mlp_weights = classic_mlp.PreparedWeights(
                    classic_mlp.pack_classic_params(self.mlp))
            out = classic_mlp.classic_mlp_fwd(
                mlp_weights.packed,
                x_enc.reshape(-1, x_enc.shape[-1]).to(dt).contiguous(),
                None if d_enc is None else d_enc.reshape(-1, d_enc.shape[-1]).to(dt).contiguous(),
                mlp_weights.tc_fwd,
            )
            out = out.reshape(lead + (-1,))
            return points, out[..., :1], out[..., 1:]
        density, color = self.mlp(x_enc, d_enc)
        return points, density, color

    def _uses_kernels(self) -> bool:
        return self.cfg.use_pallas and classic_mlp.supports_classic_config(self.cfg)

    def _render_stage(
        self,
        generator: Optional[torch.Generator],
        rays_o: torch.Tensor,
        rays_d: torch.Tensor,
        t_vals: torch.Tensor,
        states_x: Optional[torch.Tensor],
        states_d: Optional[torch.Tensor],
        density_noise_std: float,
        white_background: bool = False,
        noise: Optional[torch.Tensor] = None,
        mlp_weights: Optional[classic_mlp.PreparedWeights] = None,
    ):
        """One coarse or fine pass: evaluate, composite.  Returns
        ``(rgb, weights [..., S, 1], depth, noised_density, color)``."""
        _, density, color = self.forward(rays_o, rays_d, t_vals, states_x, states_d,
                                         mlp_weights)
        density = _maybe_add_density_noise(generator, density, density_noise_std, noise)
        weights = compositing.weights_from_density(
            density, compositing.distances_from_tvals(t_vals, rays_d)
        )
        rgb = compositing.composite_rgb_with_background(
            weights, color, 1.0 if white_background else None
        )
        depth = compositing.composite_depth(weights, t_vals)
        return rgb, weights, depth, density, color

    def _use_fused_union(self, render: RenderConfig, rays_o: torch.Tensor) -> bool:
        """Gate for the K4 union kernel: fused path on, the kernel's
        architecture family, deterministic (no density noise), flat rays."""
        return self._uses_kernels() and render.density_noise_std == 0.0 and rays_o.ndim == 2

    def render_rays(
        self,
        rays_o: torch.Tensor,
        rays_d: torch.Tensor,
        render: RenderConfig,
        states_x: Optional[torch.Tensor] = None,
        states_d: Optional[torch.Tensor] = None,
        fused_eval: bool = False,
        generator: Optional[torch.Generator] = None,
        draws: Optional[sampling.StepDraws] = None,
        mlp_weights: Optional[classic_mlp.PreparedWeights] = None,
    ) -> RenderOutput:
        """Render a batch of rays: stratified coarse pass plus, with
        ``render.num_fine_samples``, the inverse-CDF fine pass (weights
        shared across stages).

        ``fused_eval=True`` lets a deterministic render take the K4 kernel
        (``_use_fused_union``); ``render_image`` sets it.  ``generator``
        draws the stratified jitter, the pdf uniforms and the density noise
        (required when ``render.randomly_sample``), unless ``draws`` holds
        them already made (flat rays; ``sampling.draw_step``).  On the
        kernel path ``mlp_weights`` are the MLP's weights as
        ``classic_mlp.prepare_weights`` built them for several calls
        (``render_image`` passes them to every tile; no gradient reaches
        the parameters through them), else the call packs them once.
        """
        batch_shape = rays_o.shape[:-1]
        if mlp_weights is None and self._uses_kernels():
            mlp_weights = classic_mlp.PreparedWeights(classic_mlp.pack_classic_params(self.mlp))
        if draws is not None:
            t_coarse = draws.t_coarse
        else:
            t_coarse = sampling.sample_linear(
                generator, batch_shape, render.num_coarse_samples, render.near, render.far,
                randomly_sample=render.randomly_sample, dtype=rays_o.dtype, device=rays_o.device,
            )
        noise_c = None if draws is None else draws.noise_c
        noise_f = None if draws is None else draws.noise_f
        rgb_c, weights_c, depth_c, density_c, color_c = self._render_stage(
            generator, rays_o, rays_d, t_coarse, states_x, states_d,
            render.density_noise_std, render.white_background, noise_c, mlp_weights,
        )

        stages = [rgb_c]
        weights, depth, acc = weights_c, depth_c, None

        if render.num_fine_samples > 0:
            t_mids = 0.5 * (t_coarse[..., 1:] + t_coarse[..., :-1])
            t_fine = sampling.sample_pdf(
                generator, t_mids, weights_c[..., 1:-1, 0].detach(),
                render.num_fine_samples, randomly_sample=render.randomly_sample,
                u=None if draws is None else draws.u,
            )
            if fused_eval and render.reuse_coarse_in_fine and self._use_fused_union(render, rays_o):
                # Fine MLP and union compositing in the K4 kernel, which
                # takes the raw coarse outputs and per-ray view encodings.
                points_f = rays_o[..., None, :] + rays_d[..., None, :] * t_fine[..., :, None]
                xf_enc = self.encode_position(
                    points_f, None if states_x is None else states_x[..., None, :]
                ).to(self._compute_dtype())
                df_ray = None
                if self.cfg.use_viewdirs:
                    df_ray = self.encode_direction(rays_d, states_d).to(self._compute_dtype())
                rgb_f, depth_f, acc_f = union_eval.union_eval(
                    mlp_weights.packed,
                    xf_enc.contiguous(),
                    None if df_ray is None else df_ray.contiguous(),
                    t_coarse.contiguous(),
                    t_fine.contiguous(),
                    density_c.contiguous(),
                    color_c.contiguous(),
                    torch.linalg.norm(rays_d, dim=-1),
                    tc_fwd=mlp_weights.tc_fwd,
                )
                if render.white_background:
                    rgb_f = rgb_f + (1.0 - acc_f[..., None])
                acc = acc_f
            elif render.reuse_coarse_in_fine:
                # The network runs only on the new fine samples; the coarse
                # evaluations (noise included) are reused and the union is
                # composited order-free.
                _, density_f, color_f = self.forward(rays_o, rays_d, t_fine, states_x, states_d,
                                                     mlp_weights)
                density_f = _maybe_add_density_noise(
                    generator, density_f, render.density_noise_std, noise_f
                )
                t_cat = torch.cat([t_coarse, t_fine], dim=-1)
                weights = compositing.weights_from_union_sorted(
                    density_c, density_f, t_coarse, t_fine, rays_d
                )
                rgb_f = compositing.composite_rgb_with_background(
                    weights, torch.cat([color_c, color_f], dim=-2),
                    1.0 if render.white_background else None,
                )
                depth_f = compositing.composite_depth(weights, t_cat)
            else:
                # NeRF-paper formulation: re-evaluate the merged sorted set.
                t_all = sampling.merge_samples(t_coarse, t_fine)
                rgb_f, weights, depth_f, _, _ = self._render_stage(
                    generator, rays_o, rays_d, t_all, states_x, states_d,
                    render.density_noise_std, render.white_background, noise_f, mlp_weights,
                )
            stages.append(rgb_f)
            depth = depth_f

        if acc is None:
            acc = compositing.composite_acc(weights)
        return RenderOutput(rgb=torch.stack(stages, dim=-2), depth=depth, acc=acc)

    @torch.no_grad()
    def render_image(
        self,
        camera_o: torch.Tensor,
        camera_r: torch.Tensor,
        image_h: int,
        image_w: int,
        focal_length: float,
        render: RenderConfig,
        states_x: Optional[torch.Tensor] = None,
        states_d: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Render full images ``[B, H, W, C]`` (the finest stage per ray),
        tile by tile of ``render.rays_per_tile`` rays.  On the kernel path
        the weights are packed, and their operand images built, once for
        the frame's kernel calls."""
        mlp_weights = None
        if self._uses_kernels():
            mlp_weights = classic_mlp.prepare_weights(self.mlp, dtype=self._compute_dtype())

        def per_tile(tile_o, tile_d, tile_sx, tile_sd):
            out = self.render_rays(
                tile_o, tile_d, render, tile_sx, tile_sd,
                fused_eval=True, generator=generator, mlp_weights=mlp_weights,
            )
            return out.rgb[..., -1, :]

        return _tiled_over_rays(
            per_tile, camera_o, camera_r, image_h, image_w, focal_length,
            render.rays_per_tile, self.cfg.color_outputs, states_x, states_d,
            use_ndc=render.use_ndc,
        )


class MipNeRF(nn.Module):
    """The HEAD-generation model: IPE cone casting, log-spaced bbox
    sampling, density + RGB + segmentation heads.  S fencepost t-values
    give S - 1 interval Gaussians.  Weights are drawn from ``generator`` (a
    CPU generator; torch's global one when ``None``) and the module is
    placed on ``device``."""

    def __init__(
        self,
        cfg: MipNeRFConfig,
        generator: Optional[torch.Generator] = None,
        device="cuda",
    ):
        super().__init__()
        self.cfg = cfg
        self.mlp = MipMLP(cfg, generator=generator, device="cpu")
        self.to(device)

    def integrated_pe(
        self, rays_o: torch.Tensor, rays_d: torch.Tensor, t_vals: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Cone-cast and IPE-featurize: ``(means [..., S-1, 3], covs,
        features [..., S-1, F])``."""
        cfg = self.cfg
        r_dot = 1.0 / (math.sqrt(3.0) * cfg.focal_length)
        means, covs = encoding.cast_rays(t_vals, rays_o, rays_d, r_dot, cfg.ray_shape)
        features = encoding.integrated_pos_enc(means, covs, cfg.min_deg, cfg.max_deg)
        return means, covs, features

    def forward(
        self,
        rays_o: torch.Tensor,
        rays_d: torch.Tensor,
        t_vals: torch.Tensor,
        states_x: Optional[torch.Tensor] = None,
        states_d: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(means, density [..., S-1, 1], color, segmentation)`` of the
        interval Gaussians; ``states_*`` are accepted and ignored, as in
        the JAX package."""
        del states_x, states_d
        means, _, features = self.integrated_pe(rays_o, rays_d, t_vals)
        if self._uses_kernels():
            lead = features.shape[:-1]
            out = mip_mlp.mip_mlp_fwd(
                mip_mlp.pack_mip_params(self.mlp),
                features.reshape(-1, features.shape[-1]).to(self._compute_dtype()).contiguous(),
            ).reshape(lead + (-1,))
            c = self.cfg.color_outputs
            return means, out[..., :1], out[..., 1:1 + c], out[..., 1 + c:]
        density, color, segmentation = self.mlp(features)
        return means, density, color, segmentation

    def _compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    def _uses_kernels(self) -> bool:
        return self.cfg.use_pallas and mip_mlp.supports_mip_config(self.cfg)

    def _use_fused_eval(self, render: RenderConfig, rays_o: torch.Tensor) -> bool:
        """Gate for the forward-only K7 kernel: fused path on, no density
        noise, a flat ray batch.  ``render_image`` opts in; differentiable
        paths must not (K7 has no backward)."""
        return self._uses_kernels() and render.density_noise_std == 0.0 and rays_o.ndim == 2

    def render_rays(
        self,
        rays_o: torch.Tensor,
        rays_d: torch.Tensor,
        render: RenderConfig,
        states_x: Optional[torch.Tensor] = None,
        states_d: Optional[torch.Tensor] = None,
        fused_eval: bool = False,
        generator: Optional[torch.Generator] = None,
        draws: Optional[sampling.StepDraws] = None,
        mlp_weights: Optional[classic_mlp.PreparedWeights] = None,
    ) -> RenderOutput:
        """Render a batch of rays over ``render.num_coarse_samples``
        log-bbox fenceposts; rgb and segmentation carry one stage entry.
        ``generator`` draws the jitter and the density noise unless
        ``draws`` holds them already made (``sampling.draw_step`` with the
        model's ``bbox_diagonal``).  On K7's path ``mlp_weights`` are the
        MLP's weights as ``mip_mlp.prepare_weights`` built them for several
        calls (``render_image`` passes them to every tile), else the call
        packs them."""
        if draws is not None:
            t_vals, noise = draws.t_coarse, draws.noise_c
        else:
            t_vals = sampling.sample_log_bbox(
                generator, rays_o.shape[:-1], render.num_coarse_samples,
                self.cfg.bbox_diagonal, randomly_sample=render.randomly_sample,
                dtype=rays_o.dtype, device=rays_o.device,
            )
            noise = None
        t_mids = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
        if fused_eval and self._use_fused_eval(render, rays_o):
            # MLP, compositing and the seg composite in one K7 launch.
            del states_x, states_d
            means, _, features = self.integrated_pe(rays_o, rays_d, t_vals)
            if mlp_weights is None:
                mlp_weights = classic_mlp.PreparedWeights(mip_mlp.pack_mip_params(self.mlp))
            rgb, seg, depth, acc = mip_train.mip_eval(
                mlp_weights.packed,
                features.to(self._compute_dtype()).contiguous(),
                compositing.distances_from_points(means).contiguous(),
                t_mids.contiguous(),
                None,
                self.cfg.color_outputs,
                render.white_background,
                tc_fwd=mlp_weights.tc_fwd,
            )
            return RenderOutput(rgb=rgb[..., None, :], segmentation=seg[..., None, :],
                                depth=depth, acc=acc)
        means, density, color, segmentation = self.forward(
            rays_o, rays_d, t_vals, states_x, states_d
        )
        density = _maybe_add_density_noise(generator, density, render.density_noise_std, noise)
        weights = compositing.compositing_weights(means, density)
        rgb = compositing.composite_rgb_with_background(
            weights, color, 1.0 if render.white_background else None
        )
        seg = compositing.composite_segmentation(weights, segmentation)
        return RenderOutput(
            rgb=rgb[..., None, :],
            segmentation=seg[..., None, :],
            depth=compositing.composite_depth(weights, t_mids),
            acc=compositing.composite_acc(weights),
        )

    @torch.no_grad()
    def render_image(
        self,
        camera_o: torch.Tensor,
        camera_r: torch.Tensor,
        image_h: int,
        image_w: int,
        focal_length: float,
        render: RenderConfig,
        states_x: Optional[torch.Tensor] = None,
        states_d: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full images ``([B, H, W, C], [B, H, W, num_classes])``, tile by
        tile of ``render.rays_per_tile`` rays.  On K7's path the weights are
        packed, and their forward images built in ``cfg.compute_dtype``,
        once for the frame's kernel calls."""
        cfg = self.cfg
        mlp_weights = None
        if self._uses_kernels() and render.density_noise_std == 0.0:
            mlp_weights = mip_mlp.prepare_weights(self.mlp, dtype=self._compute_dtype())

        def per_tile(tile_o, tile_d, tile_sx, tile_sd):
            out = self.render_rays(
                tile_o, tile_d, render, tile_sx, tile_sd,
                fused_eval=True, generator=generator, mlp_weights=mlp_weights,
            )
            return torch.cat([out.rgb[..., -1, :], out.segmentation[..., -1, :]], dim=-1)

        both = _tiled_over_rays(
            per_tile, camera_o, camera_r, image_h, image_w, focal_length,
            render.rays_per_tile, cfg.color_outputs + cfg.segmentation_outputs,
            states_x, states_d,
        )
        return both[..., :cfg.color_outputs], both[..., cfg.color_outputs:]


def _tiled_over_rays(
    per_tile_fn: Callable,
    camera_o: torch.Tensor,
    camera_r: torch.Tensor,
    image_h: int,
    image_w: int,
    focal_length: float,
    rays_per_tile: int,
    out_channels: int,
    states_x: Optional[torch.Tensor],
    states_d: Optional[torch.Tensor],
    use_ndc: bool = False,
) -> torch.Tensor:
    """Generate the world-space ray grid and run ``per_tile_fn`` over
    consecutive tiles of ``rays_per_tile`` rays (the last may be shorter),
    with per-image latent states broadcast to their rays."""
    rays_o, rays_d = cameras.pose_to_rays(camera_o, camera_r, image_h, image_w, focal_length)
    if use_ndc:
        rays_o, rays_d = cameras.ndc_rays(rays_o, rays_d, image_h, image_w, focal_length)
    batch = rays_o.shape[0]
    n_rays = batch * image_h * image_w
    rays_o = rays_o.reshape(n_rays, 3)
    rays_d = rays_d.reshape(n_rays, 3)

    def expand_states(states):
        if states is None or states.shape[-1] == 0:
            return None
        states = states[:, None, :].expand(batch, image_h * image_w, states.shape[-1])
        return states.reshape(n_rays, states.shape[-1])

    states_x = expand_states(states_x)
    states_d = expand_states(states_d)
    out = torch.empty((n_rays, out_channels), dtype=rays_o.dtype, device=rays_o.device)
    for start in range(0, n_rays, rays_per_tile):
        tile = slice(start, start + rays_per_tile)
        out[tile] = per_tile_fn(
            rays_o[tile], rays_d[tile],
            None if states_x is None else states_x[tile],
            None if states_d is None else states_d[tile],
        )
    return out.reshape(batch, image_h, image_w, out_channels)
