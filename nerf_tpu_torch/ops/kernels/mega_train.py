"""K9: ONE hierarchical-reuse train step in one CUDA call: the coarse MLP,
its compositing and stage MSE, the inverse-CDF resample, the fine
encoding, the fine MLP, the union compositing and stage MSE, and both MLP
backwards, with no forward run twice.

Counterpart of ``nerf_tpu/ops/pallas/fused_mega.py`` (``supports_mega``,
``_encode_fine`` and ``mega_train_loss_and_grads``).  The kernel is
``csrc/mega_train.cu``, on the passes of ``csrc/classic_mlp_train.cuh`` with
the tensor-core products of ``csrc/tc_mlp.cuh`` (3xTF32 on operand images
``tc_mlp.tc_images`` builds once per call), K3's union pass
(``csrc/union_train.cuh``) and the in-kernel encoder of ``csrc/encode.cuh``;
``mega_train_plain`` is its plain PyTorch version: autograd through
``classic_mlp_fwd_plain``, the compositing and ``sampling.sample_pdf`` on
the detached coarse weights (with ``matmul=tc_mlp.tc_matmul_autograd`` it
emulates the kernel's products, forward and backward).  The JAX function's
TPU knobs (``interpret``, ``rays_per_tile``, ``splits``, ``ablate``) have
no counterpart here.

``compute_dtype="bfloat16"`` (a model's ``cfg.compute_dtype``, as the JAX
function reads it): ``mega_inputs`` casts the coarse and the per-ray view
encodings to bfloat16, and ``mega_train`` given them launches
``mega_train_bf16``: the fine encodings rounded to bfloat16 where the
kernel writes them, every product and both heads on operands rounded to
bfloat16 with float32 sums; the compositing, the resample, the losses and
the gradients float32.  ``mega_train_plain`` runs the JAX package's bf16
arithmetic on the same roundings (``tc_mlp.bf16_matmul_autograd``).
``_build.policy_counts`` records ``"tc_bf16"``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from nerf_tpu_torch.config import ClassicNeRFConfig
from nerf_tpu_torch.ops import compositing, encoding, sampling
from nerf_tpu_torch.ops.kernels import _build, tc_mlp
from nerf_tpu_torch.ops.kernels.classic_mlp import (
    PACK_ORDER,
    Packed,
    _packed_from_args,
    check_inputs,
    classic_mlp_fwd_plain,
    kernel_grads,
    pack_classic_params,
    packed_grads_plain,
    route,
    scratch_pointers,
    supports_classic_config,
    train_scratch,
    weight_pointers,
)

NAME = "mega_train"
STAGE_WEIGHT = 0.5  # the stage-mean MSE over (coarse, fine)


def supports_mega(model, render, batch=None) -> bool:
    """The rules of ``fused_mega.supports_mega``: a ClassicNeRF architecture
    the kernels cover (with or without the view branch), hierarchical
    ``reuse_coarse_in_fine`` rendering with at least 4 coarse samples, and
    no latent states in the batch."""
    cfg = getattr(model, "cfg", None)
    if not isinstance(cfg, ClassicNeRFConfig) or not supports_classic_config(cfg):
        return False
    if render.num_fine_samples <= 0 or not render.reuse_coarse_in_fine:
        return False
    if render.num_coarse_samples < 4:
        return False
    return batch is None or (batch.get("states_x") is None and batch.get("states_d") is None)


def encode_fine_plain(
    t_fine: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor,
    placement: torch.Tensor, is_cos: torch.Tensor, exact_trig: bool = False,
) -> torch.Tensor:
    """The fine samples' frequency encoding on a ``frequency_placement``:
    ``[R * Sf, XE]`` for ``t_fine [R, Sf]``.  The sine argument is ``sum_c
    p_c S[c]`` (each lane one exact product, as ``frequency_encoding``'s);
    the lanes are ``sin(arg + is_cos * pi/2)`` (one transcendental per
    lane, the JAX default), or with ``exact_trig`` ``where(is_cos, cos(arg),
    sin(arg))``."""
    pts = (rays_o[:, None, :] + rays_d[:, None, :] * t_fine[..., None]).reshape(-1, 3)
    arg = pts[:, 0:1] * placement[0] + pts[:, 1:2] * placement[1] + pts[:, 2:3] * placement[2]
    if exact_trig:
        return torch.where(is_cos > 0.0, torch.cos(arg), torch.sin(arg))
    return torch.sin(arg + is_cos * (math.pi / 2.0))  # float32(pi/2): a float32 op


def _stage_out(w: Packed, x_enc, d_ray, n_rays: int, per_ray: int, matmul) -> torch.Tensor:
    d = None if d_ray is None else d_ray[:, None, :].expand(n_rays, per_ray, -1).reshape(
        n_rays * per_ray, -1)
    return classic_mlp_fwd_plain(w, x_enc, d, matmul).reshape(n_rays, per_ray, -1)


def _coarse_plain(w: Packed, x_enc_c, d_ray, t_coarse, noise_c, rays_d, matmul):
    n_rays, s_coarse = t_coarse.shape
    out_c = _stage_out(w, x_enc_c, d_ray, n_rays, s_coarse, matmul)
    dens_c = out_c[..., :1] + noise_c[..., None]
    weights_c = compositing.weights_from_density(
        dens_c, compositing.distances_from_tvals(t_coarse, rays_d))
    return dens_c, out_c[..., 1:], weights_c


def coarse_weights_plain(packed: Packed, x_enc_c, d_ray, t_coarse, noise_c, rays_d,
                         matmul=None) -> torch.Tensor:
    """The coarse stage's compositing weights ``[R, Sc]`` in plain PyTorch,
    which the resample inverts (``mega_train``'s arguments)."""
    with torch.no_grad():
        return _coarse_plain(packed, x_enc_c, d_ray, t_coarse, noise_c, rays_d,
                             matmul)[2][..., 0]


def mega_train_plain(
    packed: Packed, x_enc_c, d_ray, t_coarse, noise_c, u, noise_f, rays_o, rays_d, pixels,
    placement, is_cos, white_background: bool = False, exact_trig: bool = False,
    t_fine: Optional[torch.Tensor] = None, matmul=None,
):
    """The kernel's function in plain PyTorch (see ``mega_train``).
    ``t_fine``, when given, takes the place of the resample's result (the
    fine t-values held constant, as the JAX package's exactness oracle
    holds them); ``matmul`` as in ``classic_mlp_fwd_plain``.  bfloat16
    encodings run the bf16 arithmetic, the fine encodings rounded to
    bfloat16 as the kernel writes them."""
    n_rays, s_coarse = t_coarse.shape
    s_fine = u.shape[-1]
    bg = 1.0 if white_background else None
    dnorm = torch.linalg.norm(rays_d, dim=-1)
    kept = {}

    def objective(w):
        dens_c, col_c, weights_c = _coarse_plain(w, x_enc_c, d_ray, t_coarse, noise_c, rays_d,
                                                 matmul)
        rgb_c = compositing.composite_rgb_with_background(weights_c, col_c, bg)
        loss_c = STAGE_WEIGHT * torch.mean((rgb_c - pixels) ** 2)
        t_f = t_fine
        if t_f is None:
            t_mids = 0.5 * (t_coarse[..., 1:] + t_coarse[..., :-1])
            t_f = sampling.sample_pdf(None, t_mids, weights_c[..., 1:-1, 0].detach(), s_fine,
                                      u=u)
        x_enc_f = encode_fine_plain(t_f, rays_o, rays_d, placement, is_cos, exact_trig)
        out_f = _stage_out(w, x_enc_f.to(x_enc_c.dtype), d_ray, n_rays, s_fine, matmul)
        weights = compositing.weights_from_union_norm(
            dens_c, out_f[..., :1] + noise_f[..., None], t_coarse, t_f, dnorm[:, None])
        rgb = compositing.composite_rgb_with_background(
            weights, torch.cat([col_c, out_f[..., 1:]], dim=-2), bg)
        loss_f = STAGE_WEIGHT * torch.mean((rgb - pixels) ** 2)
        kept.update(loss_c=loss_c.detach(), loss_f=loss_f.detach(), t_fine=t_f.detach())
        return loss_c + loss_f, None

    _, d_packed = packed_grads_plain(packed, (), objective)
    return kept["loss_c"], kept["loss_f"], d_packed, kept["t_fine"]


def mega_train(
    packed: Packed,
    x_enc_c: torch.Tensor,
    d_ray: Optional[torch.Tensor],
    t_coarse: torch.Tensor,
    noise_c: torch.Tensor,
    u: torch.Tensor,
    noise_f: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    pixels: torch.Tensor,
    placement: torch.Tensor,
    is_cos: torch.Tensor,
    white_background: bool = False,
    exact_trig: bool = False,
    keep: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Packed, torch.Tensor]:
    """One evaluation of the reuse objective and its gradients.

    Args:
        packed: ``classic_mlp.pack_classic_params`` of the model's MLP.
        x_enc_c: ``[R * Sc, XE]`` encodings of the coarse samples, float32
            or, for ``compute_dtype="bfloat16"``, bfloat16.
        d_ray: ``[R, DE]`` view encodings, one row per ray, in
            ``x_enc_c``'s dtype, or ``None`` without the view branch.
        t_coarse: sorted coarse t-values ``[R, Sc]``.
        noise_c / noise_f: density noise ``[R, Sc]`` / ``[R, Sf]``, drawn
            beforehand (zeros without noise).
        u: the sorted pdf uniforms ``[R, Sf]`` (``sampling.pdf_uniforms``).
        rays_o / rays_d: ``[R, 3]``.
        pixels: ``[R, C]`` targets.
        placement / is_cos: ``encoding.frequency_placement`` of the
            position scales, ``[3, XE]`` and ``[1, XE]``.
        exact_trig: the fine encoding's ``where(is_cos, cos, sin)`` form in
            place of the phase form.
        keep: a dict in which a CUDA call puts ``x_all [R (Sc + Sf), XE]``,
            the coarse then the fine encodings the kernel held in its
            scratch, in ``x_enc_c``'s dtype (for checks).

    Returns ``(loss_c, loss_f, d_packed, t_fine [R, Sf])``, the losses
    stage-weighted (0.5 each) and ``d_packed`` the gradient of their sum.
    CPU tensors run ``mega_train_plain``; CUDA tensors launch the kernel
    (raising on what it does not take): ``mega_train_bf16`` for bfloat16
    encodings.
    """
    has_view = "wd_in" in packed
    if has_view != (d_ray is not None):
        raise ValueError(f"{NAME}: d_ray must be given iff the weights have a view branch")
    device = check_inputs(NAME, packed, {
        "x_enc_c": x_enc_c, "d_ray": d_ray, "t_coarse": t_coarse, "noise_c": noise_c, "u": u,
        "noise_f": noise_f, "rays_o": rays_o, "rays_d": rays_d, "pixels": pixels,
        "placement": placement, "is_cos": is_cos,
    })
    n_rays, s_coarse = t_coarse.shape
    s_fine = u.shape[-1]
    xe, hidden = packed["w0"].shape
    colors = packed["w_col"].shape[1]
    expected = {
        "x_enc_c": (x_enc_c, (n_rays * s_coarse, xe)),
        "noise_c": (noise_c, (n_rays, s_coarse)),
        "u": (u, (n_rays, s_fine)),
        "noise_f": (noise_f, (n_rays, s_fine)),
        "rays_o": (rays_o, (n_rays, 3)),
        "rays_d": (rays_d, (n_rays, 3)),
        "pixels": (pixels, (n_rays, colors)),
        "placement": (placement, (3, xe)),
        "is_cos": (is_cos, (1, xe)),
    }
    if has_view:
        expected["d_ray"] = (d_ray, (n_rays, packed["wd_in"].shape[0]))
    for key, (t, shape) in expected.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{NAME}: {key} must be {shape}, got {tuple(t.shape)}")
    if device.type == "cpu":
        return mega_train_plain(packed, x_enc_c, d_ray, t_coarse, noise_c, u, noise_f, rays_o,
                                rays_d, pixels, placement, is_cos, white_background, exact_trig)
    if s_coarse < 3 or s_fine < 1:
        raise ValueError(f"{NAME}: takes at least 3 coarse and 1 fine samples per ray, "
                         f"got {s_coarse} + {s_fine}")
    if n_rays == 0:
        raise ValueError(f"{NAME}: needs at least one ray")
    n_rows = n_rays * (s_coarse + s_fine)
    de = d_ray.shape[1] if has_view else 0
    dtype = x_enc_c.dtype
    fn_name, policy = route(NAME, dtype == torch.bfloat16)
    kpacked = tc_mlp.pad_packed(packed)
    s = train_scratch(kpacked, n_rows, device)

    def buf(*shape, dt=torch.float32):
        return torch.empty(shape, dtype=dt, device=device)

    loss, t_fine = buf(2), buf(n_rays, s_fine)
    gout, x_all = torch.empty_like(s["out"]), buf(n_rows, xe, dt=dtype)
    dnorm, ray_loss = buf(n_rays), buf(2, n_rays)
    ray_scratch = buf(n_rays, 5 * (s_coarse + s_fine))
    tc_fwd, tc_bwd = tc_mlp.tc_images(kpacked, backward=True, dtype=dtype)
    fn = getattr(_build.load(NAME), fn_name)
    err = fn(
        x_enc_c.data_ptr(), _build.ptr(d_ray), t_coarse.data_ptr(), noise_c.data_ptr(),
        u.data_ptr(), noise_f.data_ptr(), rays_o.data_ptr(), rays_d.data_ptr(),
        pixels.data_ptr(), placement.data_ptr(), is_cos.data_ptr(), loss.data_ptr(),
        s["grads"].data_ptr(), t_fine.data_ptr(), n_rays, s_coarse, s_fine, xe, de, hidden,
        colors, int(white_background), int(exact_trig), *weight_pointers(kpacked),
        *scratch_pointers(s), gout.data_ptr(),
        x_all.data_ptr(), dnorm.data_ptr(), ray_loss.data_ptr(), ray_scratch.data_ptr(),
        s["splits"],
        tc_fwd.data_ptr(), tc_bwd.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check_launch(NAME, err)
    _build.launch_counts[NAME] += 1
    _build.policy_counts[(NAME, policy)] += 1
    if keep is not None:
        keep["x_all"] = x_all
    return loss[0], loss[1], kernel_grads(s["grads"], kpacked, packed), t_fine


class MegaTrainFunction(torch.autograd.Function):
    """``mega_train`` under autograd: ``apply(options, x_enc_c, d_ray,
    t_coarse, noise_c, u, noise_f, rays_o, rays_d, pixels, placement,
    is_cos, *weights)`` with the weights in ``PACK_ORDER`` returns ``(loss,
    loss_f, t_fine)``: the total loss, differentiable with respect to the
    weights (the backward scales the gradients the call returned), and the
    fine stage's loss and the fine t-values, which are not.  ``options``
    is ``(white_background, exact_trig)``."""

    @staticmethod
    def forward(ctx, options: Tuple, x_enc_c, d_ray, t_coarse, noise_c, u, noise_f, rays_o,
                rays_d, pixels, placement, is_cos, *weights):
        white, exact = options
        loss_c, loss_f, d_packed, t_fine = mega_train(
            _packed_from_args(weights), x_enc_c, d_ray, t_coarse, noise_c, u, noise_f, rays_o,
            rays_d, pixels, placement, is_cos, white, exact,
        )
        ctx.save_for_backward(*[d_packed.get(k) for k in PACK_ORDER])
        ctx.mark_non_differentiable(loss_f, t_fine)
        return loss_c + loss_f, loss_f, t_fine

    @staticmethod
    def backward(ctx, g_loss, _g_loss_f, _g_t_fine):
        grads = [None if t is None else t * g_loss for t in ctx.saved_tensors]
        return (None,) * 12 + tuple(grads)


def mega_inputs(model, batch: Dict[str, torch.Tensor], draws: sampling.StepDraws) -> Tuple:
    """``mega_train``'s tensor arguments for one step of ``model``:
    ``(x_enc_c, d_ray, t_coarse, noise_c, u, noise_f, rays_o, rays_d,
    pixels, placement, is_cos)``.  The coarse encodings are made here
    (``encode_inputs_flat``), the fine ones inside the kernel on
    ``frequency_placement`` of the model's ``x_scales`` buffer; the coarse
    and the view encodings in ``model.cfg.compute_dtype``, as the JAX
    function casts them."""
    rays_o, rays_d = batch["rays_o"], batch["rays_d"]
    dt = getattr(torch, model.cfg.compute_dtype)
    x_enc_c, _ = model.encode_inputs_flat(rays_o, rays_d, draws.t_coarse)
    d_ray = (model.encode_direction(rays_d).to(dt).contiguous() if model.cfg.use_viewdirs
             else None)
    placement, is_cos = encoding.frequency_placement(model.x_scales)
    return (x_enc_c.reshape(-1, x_enc_c.shape[-1]).to(dt).contiguous(), d_ray,
            draws.t_coarse.contiguous(), draws.noise_c.contiguous(), draws.u.contiguous(),
            draws.noise_f.contiguous(), rays_o.contiguous(), rays_d.contiguous(),
            batch["pixels"].contiguous(), placement, is_cos)


def mega_train_loss_and_grads(
    model, render, batch: Dict[str, torch.Tensor], draws: sampling.StepDraws,
    emit_t_fine: bool = False, exact_trig: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Loss and parameter gradients of ONE hierarchical reuse step through
    the one K9 call: a drop-in for
    ``fine_stage_train.reuse_train_loss_and_grads`` where ``supports_mega``
    holds, in ``model.cfg.compute_dtype``.

    ``draws`` holds the step's random draws (``sampling.draw_step``).
    Returns ``(loss, grads, aux)`` with ``grads`` keyed by
    ``model.named_parameters()`` and ``aux`` the reuse step's keys, plus
    ``aux["t_fine"]`` (the resampled fine t-values) with ``emit_t_fine``.
    """
    if not supports_mega(model, render, batch):
        raise ValueError(
            "mega_train_loss_and_grads covers ClassicNeRF architectures without latent "
            "states under hierarchical reuse_coarse_in_fine rendering with >= 4 coarse samples"
        )
    cfg = model.cfg
    if cfg.x_encoding_dim != 3 * cfg.x_positional_encoding_size:
        raise ValueError(f"{NAME}: encodes 3-D positions only (density_inputs=3)")
    names, params = zip(*model.named_parameters())
    inputs = mega_inputs(model, batch, draws)
    with torch.enable_grad():
        packed = pack_classic_params(model.mlp)
        loss, loss_f, t_fine = MegaTrainFunction.apply(
            (render.white_background, exact_trig), *inputs, *[packed.get(k) for k in PACK_ORDER]
        )
    grads = torch.autograd.grad(loss, params)
    loss = loss.detach()
    aux = {"loss": loss, "rgb_loss": loss, "fine_mse": loss_f / STAGE_WEIGHT}
    if emit_t_fine:
        aux["t_fine"] = t_fine
    return loss, dict(zip(names, grads)), aux
