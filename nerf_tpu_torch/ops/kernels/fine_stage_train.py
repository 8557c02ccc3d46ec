"""K3: the fine stage of the hierarchical-reuse train objective and its
gradients as one CUDA call, and the whole reuse step built on it.

Counterpart of ``nerf_tpu/ops/pallas/fused_hier.py``
(``fine_stage_train_pallas`` and ``reuse_train_loss_and_grads``).  The
kernel is ``csrc/fine_stage_train.cu`` (MLP passes shared with K1-bwd and
K2 in ``csrc/classic_mlp_train.cuh``); ``fine_stage_train_plain`` is its
plain PyTorch version: ``classic_mlp_fwd_plain``,
``weights_from_union_norm`` and the MSE, with gradients from
``torch.autograd``.

``reuse_train_loss_and_grads`` runs one reuse step: the coarse MLP through
K1 under autograd, the coarse compositing, loss and inverse-CDF resample
in plain PyTorch, and the fine stage through ``FineStageFunction``, whose
backward hands back K3's gradients.  Autograd then sums both stages'
cotangents of the coarse outputs and runs ONE K1 backward, as the JAX
function pushes the summed cotangents through one coarse VJP.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from nerf_tpu_torch.ops import compositing, sampling
from nerf_tpu_torch.ops.kernels import _build
from nerf_tpu_torch.ops.kernels.classic_mlp import (
    HIDDEN_WIDTHS,
    MAX_COLORS,
    PACK_ORDER,
    Packed,
    _packed_from_args,
    check_inputs,
    classic_mlp_fwd,
    classic_mlp_fwd_plain,
    flat_grads_to_packed,
    pack_classic_params,
    packed_grads_plain,
    scratch_pointers,
    train_scratch,
    weight_pointers,
)

NAME = "fine_stage_train"
MAX_SAMPLES = 256  # coarse and fine samples per ray the kernel takes, each
STAGE_WEIGHT = 0.5  # the stage-mean MSE over (coarse, fine)


def _fine_loss(w, x_enc, d_enc, t_coarse, t_fine, dens_c, col_c, dnorm, noise_f, pixels,
               white_background, loss_weight):
    n_rays, s_fine = t_fine.shape
    rows = n_rays * s_fine
    out = classic_mlp_fwd_plain(
        w, x_enc.reshape(rows, -1), None if d_enc is None else d_enc.reshape(rows, -1)
    ).reshape(n_rays, s_fine, -1)
    weights = compositing.weights_from_union_norm(
        dens_c, out[..., :1] + noise_f[..., None], t_coarse, t_fine, dnorm[:, None]
    )
    rgb = compositing.composite_rgb_with_background(
        weights, torch.cat([col_c, out[..., 1:]], dim=-2), 1.0 if white_background else None
    )
    return loss_weight * torch.mean((rgb - pixels) ** 2)


def fine_stage_train_plain(
    packed: Packed, x_enc, d_enc, t_coarse, t_fine, dens_c, col_c, dnorm, noise_f, pixels,
    white_background: bool = False, loss_weight: float = 1.0,
):
    """The kernel's function in plain PyTorch (see ``fine_stage_train``)."""
    kept = {}

    def objective(w, dc, cc):
        loss = _fine_loss(w, x_enc, d_enc, t_coarse, t_fine, dc, cc, dnorm, noise_f, pixels,
                          white_background, loss_weight)
        kept["loss"] = loss.detach()
        return loss, None

    (g_dens_c, g_col_c), d_packed = packed_grads_plain(packed, (dens_c, col_c), objective)
    return kept["loss"], d_packed, (g_dens_c, g_col_c)


def fine_stage_train(
    packed: Packed,
    x_enc: torch.Tensor,
    d_enc: Optional[torch.Tensor],
    t_coarse: torch.Tensor,
    t_fine: torch.Tensor,
    dens_c: torch.Tensor,
    col_c: torch.Tensor,
    dnorm: torch.Tensor,
    noise_f: torch.Tensor,
    pixels: torch.Tensor,
    white_background: bool = False,
    loss_weight: float = 1.0,
) -> Tuple[torch.Tensor, Packed, Tuple[torch.Tensor, torch.Tensor]]:
    """One evaluation of the disjoint-stage fine objective.

    Args:
        packed: ``classic_mlp.pack_classic_params`` of the model's MLP.
        x_enc: ``[B, Sf, XE]`` encodings of the fine samples.
        d_enc: ``[B, Sf, DE]`` view encodings, constant along each ray (the
            kernel reads each ray's first row), or ``None`` without the
            view branch.
        t_coarse / t_fine: sorted t-values ``[B, Sc]`` / ``[B, Sf]``.
        dens_c: ``[B, Sc, 1]`` NOISED coarse densities (reused).
        col_c: ``[B, Sc, C]`` coarse colour logits (reused).
        dnorm: ``[B]`` ray direction norms ``||d||``.
        noise_f: ``[B, Sf]`` fine density noise, drawn beforehand.
        pixels: ``[B, C]`` targets.
        loss_weight: the stage weight (0.5 under the stage-mean MSE).

    Returns ``(loss, d_packed, (g_dens_c [B, Sc, 1], g_col_c [B, Sc, C]))``.
    CPU tensors run ``fine_stage_train_plain``; CUDA tensors launch the
    kernel (raising on what it does not take).
    """
    has_view = "wd_in" in packed
    if has_view != (d_enc is not None):
        raise ValueError(f"{NAME}: d_enc must be given iff the weights have a view branch")
    device = check_inputs(NAME, packed, {
        "x_enc": x_enc, "d_enc": d_enc, "t_coarse": t_coarse, "t_fine": t_fine,
        "dens_c": dens_c, "col_c": col_c, "dnorm": dnorm, "noise_f": noise_f, "pixels": pixels,
    })
    n_rays, s_fine = t_fine.shape
    s_coarse = t_coarse.shape[-1]
    xe, hidden = packed["w0"].shape
    colors = packed["w_col"].shape[1]
    expected = {
        "x_enc": (x_enc, (n_rays, s_fine, xe)),
        "t_coarse": (t_coarse, (n_rays, s_coarse)),
        "dens_c": (dens_c, (n_rays, s_coarse, 1)),
        "col_c": (col_c, (n_rays, s_coarse, colors)),
        "dnorm": (dnorm, (n_rays,)),
        "noise_f": (noise_f, (n_rays, s_fine)),
        "pixels": (pixels, (n_rays, colors)),
    }
    if has_view:
        expected["d_enc"] = (d_enc, (n_rays, s_fine, packed["wd_in"].shape[0]))
    for key, (t, shape) in expected.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{NAME}: {key} must be {shape}, got {tuple(t.shape)}")
    if device.type == "cpu":
        return fine_stage_train_plain(packed, x_enc, d_enc, t_coarse, t_fine, dens_c, col_c,
                                      dnorm, noise_f, pixels, white_background, loss_weight)
    if hidden not in HIDDEN_WIDTHS:
        raise ValueError(f"{NAME}: hidden width {hidden} not in {HIDDEN_WIDTHS}")
    if not (0 < s_coarse <= MAX_SAMPLES and 0 < s_fine <= MAX_SAMPLES):
        raise ValueError(f"{NAME}: takes 1..{MAX_SAMPLES} coarse and fine samples per ray, "
                         f"got {s_coarse} + {s_fine}")
    if colors > MAX_COLORS:
        raise ValueError(f"{NAME}: at most {MAX_COLORS} color outputs, got {colors}")
    if n_rays == 0:
        raise ValueError(f"{NAME}: needs at least one ray")
    sc = train_scratch(packed, n_rays * s_fine, device)
    d_ray = d_enc[:, 0, :].contiguous() if has_view else None
    loss = torch.empty((1,), dtype=torch.float32, device=device)
    g_dens_c = torch.empty_like(dens_c)
    g_col_c = torch.empty_like(col_c)
    gout = torch.empty_like(sc["out"])
    ray_loss = torch.empty((n_rays,), dtype=torch.float32, device=device)
    fn = getattr(_build.load(NAME), NAME)
    err = fn(
        x_enc.data_ptr(), _build.ptr(d_ray), t_coarse.data_ptr(), t_fine.data_ptr(),
        dens_c.data_ptr(), col_c.data_ptr(), dnorm.data_ptr(), noise_f.data_ptr(),
        pixels.data_ptr(), loss.data_ptr(), sc["grads"].data_ptr(), g_dens_c.data_ptr(),
        g_col_c.data_ptr(), n_rays, s_coarse, s_fine, xe,
        d_enc.shape[-1] if has_view else 0, hidden, colors, int(white_background),
        float(loss_weight), *weight_pointers(packed), *scratch_pointers(sc),
        gout.data_ptr(), ray_loss.data_ptr(), sc["splits"],
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check_launch(NAME, err)
    _build.launch_counts[NAME] += 1
    return loss[0], flat_grads_to_packed(sc["grads"], packed), (g_dens_c, g_col_c)


class FineStageFunction(torch.autograd.Function):
    """``fine_stage_train`` under autograd: ``apply(options, x_enc, d_enc,
    t_coarse, t_fine, dens_c, col_c, dnorm, noise_f, pixels, *weights)``
    with the weights in ``PACK_ORDER`` returns the loss, differentiable
    with respect to ``dens_c``, ``col_c`` and the weights; the backward
    scales the gradients the call returned.  ``options`` is
    ``(white_background, loss_weight)``."""

    @staticmethod
    def forward(ctx, options: Tuple, x_enc, d_enc, t_coarse, t_fine, dens_c, col_c, dnorm,
                noise_f, pixels, *weights):
        white, loss_weight = options
        loss, d_packed, (g_dens_c, g_col_c) = fine_stage_train(
            _packed_from_args(weights), x_enc, d_enc, t_coarse, t_fine, dens_c, col_c, dnorm,
            noise_f, pixels, white, loss_weight,
        )
        ctx.save_for_backward(g_dens_c, g_col_c, *[d_packed.get(k) for k in PACK_ORDER])
        return loss

    @staticmethod
    def backward(ctx, g_loss):
        g_dens_c, g_col_c, *grads = ctx.saved_tensors
        grads = [None if t is None else t * g_loss for t in grads]
        return (None,) * 5 + (g_dens_c * g_loss, g_col_c * g_loss) + (None,) * 3 + tuple(grads)


def _flat(t: torch.Tensor, n_rows: int) -> torch.Tensor:
    return t.reshape(n_rows, t.shape[-1]).contiguous()


def reuse_train_loss_and_grads(
    model, render, batch: Dict[str, torch.Tensor], draws: sampling.StepDraws
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Loss and parameter gradients of ONE hierarchical reuse step, every
    MLP evaluation through a kernel: K1-fwd on the coarse samples, K3 on
    the fine stage, and one K1-bwd on the summed coarse cotangents.

    ``draws`` holds the step's random draws (``sampling.draw_step``).
    Returns ``(loss, grads, aux)`` with ``grads`` keyed by
    ``model.named_parameters()``.
    """
    rays_o, rays_d, pixels = batch["rays_o"], batch["rays_d"], batch["pixels"]
    states_x, states_d = batch.get("states_x"), batch.get("states_d")
    n_rays = rays_o.shape[0]
    sc, sf = render.num_coarse_samples, render.num_fine_samples
    bg = 1.0 if render.white_background else None
    names, params = zip(*model.named_parameters())
    t_coarse = draws.t_coarse
    with torch.enable_grad():
        packed = pack_classic_params(model.mlp)
        # Coarse stage: K1 under autograd, compositing and loss in PyTorch.
        _, xc_enc, dc_enc = model._encode_inputs(rays_o, rays_d, t_coarse, states_x, states_d)
        out_c = classic_mlp_fwd(
            packed, _flat(xc_enc, n_rays * sc),
            None if dc_enc is None else _flat(dc_enc, n_rays * sc),
        ).reshape(n_rays, sc, -1)
        dens_c = out_c[..., :1] + draws.noise_c[..., None]
        col_c = out_c[..., 1:].contiguous()
        weights_c = compositing.weights_from_density(
            dens_c, compositing.distances_from_tvals(t_coarse, rays_d)
        )
        rgb_c = compositing.composite_rgb_with_background(weights_c, col_c, bg)
        loss_c = STAGE_WEIGHT * torch.mean((rgb_c - pixels) ** 2)
        # Inverse-CDF fine samples from the detached coarse weights.
        t_mids = 0.5 * (t_coarse[..., 1:] + t_coarse[..., :-1])
        t_fine = sampling.sample_pdf(
            None, t_mids, weights_c[..., 1:-1, 0].detach(), sf,
            randomly_sample=render.randomly_sample, u=draws.u,
        ).contiguous()
        # Fine stage: K3, whose backward returns its gradients.
        xf_enc, df_enc = model.encode_inputs_flat(rays_o, rays_d, t_fine, states_x, states_d)
        loss_f = FineStageFunction.apply(
            (render.white_background, STAGE_WEIGHT), xf_enc.contiguous(),
            None if df_enc is None else df_enc.contiguous(), t_coarse.contiguous(), t_fine,
            dens_c, col_c, torch.linalg.norm(rays_d, dim=-1), draws.noise_f.contiguous(),
            pixels.contiguous(), *[packed.get(k) for k in PACK_ORDER],
        )
        loss = loss_c + loss_f
    grads = torch.autograd.grad(loss, params)
    loss = loss.detach()
    aux = {"loss": loss, "rgb_loss": loss, "fine_mse": loss_f.detach() / STAGE_WEIGHT}
    return loss, dict(zip(names, grads)), aux
