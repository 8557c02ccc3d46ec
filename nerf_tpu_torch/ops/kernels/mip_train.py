"""K6 and K7: the mip family's fused objectives as CUDA calls.

Counterpart of ``nerf_tpu/ops/pallas/fused_mip_train.py``:

* K7, ``mip_eval`` (``mip_eval_pallas``): the MLP forward, alpha
  compositing, rgb, depth and acc, and the 50-class log-space
  segmentation composite, per ray; the kernel is ``csrc/mip_eval.cu``.
* K6, ``mip_train_grads`` (``mip_train_grads_pallas``): the MLP forward,
  compositing, the MSE, the log-space segmentation cross-entropy and the
  backward through all of it, returning the losses and the gradient of
  every packed weight; the kernel is ``csrc/mip_train_grads.cu``.

Both run on the MLP device code of ``csrc/mip_mlp.cuh`` with its products
as 3xTF32 on the tensor cores (the ``MipTc`` policy, on the operand images
``tc_mlp.tc_images`` builds: the forward's for K7, both for K6) at every
feature width, layer count and head width, recorded as ``"tc"`` in
``_build.policy_counts``; their per-ray passes take rays of any number of
rows (each ray's scratch in the device memory the wrapper hands them).
``mip_eval_plain`` and ``mip_train_grads_plain`` are their plain PyTorch
versions (``mip_mlp_fwd_plain`` and the ``compositing``
functions, with gradients from ``torch.autograd``; with
``matmul=tc_mlp.tc_matmul`` or ``tc_matmul_autograd`` they emulate the
kernels' products).  ``mip_train_loss_and_grads`` runs one fused train
step of a ``MipNeRF``; ``MipTrainGradsFunction`` puts K6 under autograd,
its backward handing back the gradients the kernel computed.

``compute_dtype="bfloat16"``: bfloat16 features (and images built in
bfloat16) launch ``mip_eval_bf16`` and ``mip_train_grads_bf16`` (every
product, the head's included, on bf16 operands with float32 sums; the
compositing and the losses float32), recorded as ``"tc_bf16"``; the plain
versions run the bf16 emulation
(``mip_mlp.mip_mlp_fwd_plain``).

Rows: S fenceposts give ``R = S - 1`` interval rows per ray; the interval
lengths come from the Gaussian means (``distances_from_points``, 1e10 far
pad), computed before the kernels as the JAX package does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from nerf_tpu_torch.ops import compositing, sampling
from nerf_tpu_torch.ops.kernels import _build, tc_mlp
from nerf_tpu_torch.ops.kernels.classic_mlp import (
    Packed,
    check_inputs,
    packed_grads_plain,
    route,
    wide_scratch,
)
from nerf_tpu_torch.ops.kernels.mip_mlp import (
    ALIGNED,
    PACK_ORDER,
    _packed_from_args,
    check_kernel_shapes,
    kernel_grads,
    mip_mlp_fwd_plain,
    mip_scratch,
    prepare_weights,
    scratch_pointers,
    weight_pointers,
)

EVAL_NAME = "mip_eval"
TRAIN_NAME = "mip_train_grads"
# Floats a row of the per-ray passes' scratch (``csrc/mip_eval.cu``,
# ``csrc/mip_train_grads.cu``), which the wrapper hands them in device
# memory.
EVAL_RAY_FLOATS, TRAIN_RAY_FLOATS = 4, 5


def _mlp_rows(packed: Packed, features: torch.Tensor, matmul) -> torch.Tensor:
    n_rays, rows, n_feat = features.shape
    return mip_mlp_fwd_plain(packed, features.reshape(n_rays * rows, n_feat), matmul).reshape(
        n_rays, rows, -1)


def _check_shapes(name, packed, color_outputs, tensors) -> Tuple[int, int]:
    """Shapes of the per-ray calls' inputs; returns ``(rays, rows)``."""
    n_rays, rows, n_feat = tensors["features"].shape
    if n_feat != packed["w_in"].shape[0]:
        raise ValueError(f"{name}: features must be [B, R, {packed['w_in'].shape[0]}], "
                         f"got {tuple(tensors['features'].shape)}")
    expected = {"dists": (n_rays, rows, 1), "noise": (n_rays, rows), "t_mids": (n_rays, rows),
                "pixels": (n_rays, color_outputs)}
    for key, t in tensors.items():
        if key in expected and t is not None and tuple(t.shape) != expected[key]:
            raise ValueError(f"{name}: {key} must be {expected[key]}, got {tuple(t.shape)}")
    if not 0 < color_outputs < packed["w_out"].shape[1]:
        raise ValueError(f"{name}: {color_outputs} color outputs of a "
                         f"{packed['w_out'].shape[1]}-wide head")
    return n_rays, rows


def _check_kernel(name, packed, color_outputs, n_rays, rows) -> None:
    """What the kernels take beyond the shapes, checked before any launch."""
    check_kernel_shapes(name, packed)
    if rows == 0:
        raise ValueError(f"{name}: needs at least one interval row per ray")
    if n_rays == 0:
        raise ValueError(f"{name}: needs at least one ray")


# -- K7: the deterministic render --------------------------------------------


def mip_eval_plain(
    packed: Packed,
    features: torch.Tensor,
    dists: torch.Tensor,
    t_mids: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    color_outputs: int = 3,
    white_background: bool = False,
    matmul=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch (see ``mip_eval``); ``matmul``
    as in ``mip_mlp_fwd_plain`` (bfloat16 features: the bf16 emulation)."""
    return mip_composite_plain(_mlp_rows(packed, features, matmul), dists, t_mids, noise,
                               color_outputs, white_background)


def mip_composite_plain(
    out: torch.Tensor,
    dists: torch.Tensor,
    t_mids: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    color_outputs: int = 3,
    white_background: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``mip_eval_plain`` after the MLP: its outputs ``out [B, R, O]`` ->
    rgb, seg, depth and acc."""
    dens = out[..., :1] if noise is None else out[..., :1] + noise[..., None]
    weights = compositing.weights_from_density(dens, dists)
    rgb = compositing.composite_rgb_with_background(
        weights, out[..., 1:1 + color_outputs], 1.0 if white_background else None)
    seg = compositing.composite_segmentation(weights, out[..., 1 + color_outputs:])
    return (rgb, seg, compositing.composite_depth(weights, t_mids),
            compositing.composite_acc(weights))


def mip_eval(
    packed: Packed,
    features: torch.Tensor,
    dists: torch.Tensor,
    t_mids: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    color_outputs: int = 3,
    white_background: bool = False,
    tc_fwd: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward-only mip render of a ray batch.

    Args:
        packed: ``mip_mlp.pack_mip_params`` of the model's MLP.
        features: ``[B, R, F]`` IPE features of the R interval rows.
        dists: ``[B, R, 1]`` interval lengths (``distances_from_points``).
        t_mids: ``[B, R]`` interval midpoints, for the depth.
        noise: ``[B, R]`` density-logit noise, or ``None``.
        color_outputs: C, the head's colour logits after the density.
        white_background: composite over white (``rgb + 1 - acc``).
        tc_fwd: the weights' forward operand image
            (``tc_mlp.tc_images(packed)[0]``) built beforehand, else the
            call builds it where the tensor-core tile runs.

    Returns ``(rgb [B, C], seg_log_probs [B, K], depth [B], acc [B])``.
    CPU tensors run ``mip_eval_plain``; CUDA tensors launch the kernel
    (raising on what it does not take): the tensor-core tile at every
    feature width, recorded in ``_build.policy_counts``.  bfloat16 features
    (and ``tc_fwd``) run ``compute_dtype="bfloat16"``: ``mip_eval_bf16``.
    """
    tensors = {"features": features, "dists": dists, "t_mids": t_mids, "noise": noise,
               "tc_fwd": tc_fwd}
    device = check_inputs(EVAL_NAME, packed, tensors, ALIGNED)
    dtype = features.dtype
    tc_mlp.check_images(EVAL_NAME, packed, tc_fwd, dtype=dtype)
    n_rays, rows = _check_shapes(EVAL_NAME, packed, color_outputs, tensors)
    if device.type == "cpu":
        return mip_eval_plain(packed, features, dists, t_mids, noise, color_outputs,
                              white_background)
    _check_kernel(EVAL_NAME, packed, color_outputs, n_rays, rows)
    kpacked = tc_mlp.pad_packed(packed)
    if tc_fwd is None:
        tc_fwd = tc_mlp.tc_images(kpacked, dtype=dtype)[0]
    fn_name, policy = route(EVAL_NAME, dtype == torch.bfloat16)
    layers, hidden = packed["b"].shape
    outputs = packed["w_out"].shape[1]
    classes = outputs - 1 - color_outputs
    per_ray = torch.empty((n_rays, color_outputs + classes + 2), dtype=torch.float32,
                          device=device)
    mlp_out = torch.empty((n_rays * rows, outputs), dtype=torch.float32, device=device)
    ray_scratch = torch.empty((n_rays * rows * EVAL_RAY_FLOATS,), dtype=torch.float32,
                              device=device)
    wide = wide_scratch(packed, -(-n_rays * rows // 64), device)
    fn = getattr(_build.load(EVAL_NAME), fn_name)
    err = fn(
        features.data_ptr(), dists.data_ptr(), t_mids.data_ptr(), _build.ptr(noise),
        per_ray.data_ptr(), n_rays, rows, features.shape[-1], hidden, layers, color_outputs,
        outputs, int(white_background), *weight_pointers(kpacked),
        mlp_out.data_ptr(), ray_scratch.data_ptr(), tc_fwd.data_ptr(), _build.ptr(wide),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check_launch(EVAL_NAME, err)
    _build.launch_counts[EVAL_NAME] += 1
    _build.policy_counts[(EVAL_NAME, policy)] += 1
    c = color_outputs
    return per_ray[:, :c], per_ray[:, c:c + classes], per_ray[:, c + classes], per_ray[:, -1]


# -- K6: the fused train objective -------------------------------------------


def _check_labels(name, labels, n_rays, seg_weight, device) -> Optional[torch.Tensor]:
    """The labels as int64 ``[B]`` on ``device``; required when
    ``seg_weight > 0``."""
    if labels is None:
        if seg_weight > 0.0:
            raise ValueError(f"{name}: seg_weight > 0 needs labels")
        return None
    if labels.dtype.is_floating_point or labels.shape != (n_rays,):
        raise ValueError(f"{name}: labels must be [{n_rays}] integers, got "
                         f"{tuple(labels.shape)} {labels.dtype}")
    if labels.device != device:
        raise ValueError(f"{name}: labels is on {labels.device}, expected {device}")
    return labels.to(torch.int64).contiguous()


def _objective(w, features, dists, noise, pixels, labels, color_outputs, seg_weight,
               white_background, matmul):
    out = _mlp_rows(w, features, matmul)
    weights = compositing.weights_from_density(out[..., :1] + noise[..., None], dists)
    rgb = compositing.composite_rgb_with_background(
        weights, out[..., 1:1 + color_outputs], 1.0 if white_background else None)
    rgb_loss = torch.mean((rgb - pixels) ** 2)
    if seg_weight == 0.0:
        return rgb_loss, torch.zeros_like(rgb_loss)
    seg = compositing.composite_segmentation(weights, out[..., 1 + color_outputs:])
    return rgb_loss, -torch.mean(torch.take_along_dim(seg, labels[:, None], dim=-1))


def mip_train_grads_plain(
    packed: Packed,
    features: torch.Tensor,
    dists: torch.Tensor,
    noise: torch.Tensor,
    pixels: torch.Tensor,
    labels: Optional[torch.Tensor],
    color_outputs: int = 3,
    seg_weight: float = 0.0,
    white_background: bool = False,
    matmul=None,
) -> Tuple[torch.Tensor, torch.Tensor, Packed]:
    """The kernel's function in plain PyTorch (see ``mip_train_grads``);
    ``matmul`` as in ``mip_mlp_fwd_plain`` (``tc_mlp.tc_matmul_autograd``
    emulates the kernel's products, forward and backward; bfloat16
    features run the bf16 emulation)."""
    kept = {}

    def objective(w):
        rgb_loss, seg_loss = _objective(w, features, dists, noise, pixels, labels,
                                        color_outputs, seg_weight, white_background, matmul)
        kept["rgb"], kept["seg"] = rgb_loss.detach(), seg_loss.detach()
        return rgb_loss + seg_weight * seg_loss, None

    _, d_packed = packed_grads_plain(packed, (), objective)
    return kept["rgb"], kept["seg"], d_packed


def mip_train_grads(
    packed: Packed,
    features: torch.Tensor,
    dists: torch.Tensor,
    noise: torch.Tensor,
    pixels: torch.Tensor,
    labels: Optional[torch.Tensor],
    color_outputs: int = 3,
    seg_weight: float = 0.0,
    white_background: bool = False,
    tc_fwd: Optional[torch.Tensor] = None,
    tc_bwd: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Packed]:
    """One evaluation of the full mip train objective.

    Args:
        packed: ``mip_mlp.pack_mip_params`` of the model's MLP.
        features: ``[B, R, F]`` IPE features of the R interval rows.
        dists: ``[B, R, 1]`` interval lengths (``distances_from_points``).
        noise: ``[B, R]`` density-logit noise, drawn beforehand (zeros when
            noiseless).
        pixels: ``[B, C]`` target pixels.
        labels: ``[B]`` integer class labels, required when
            ``seg_weight > 0``.
        seg_weight: weight of the segmentation cross-entropy; 0 skips it.
        white_background: composite over white (``rgb + 1 - acc``).
        tc_fwd, tc_bwd: the weights' operand images
            (``tc_mlp.tc_images(packed, backward=True)``) built beforehand,
            else the call builds them.

    Returns ``(rgb_loss, seg_loss, d_packed)``: the batch-mean MSE, the
    cross-entropy ``-mean_ray seg_log_probs[label]`` (0 when skipped) and
    the gradient of every packed weight of ``rgb_loss + seg_weight *
    seg_loss``.  CPU tensors run ``mip_train_grads_plain``; CUDA tensors
    launch the kernel (raising on what it does not take): every pass on the
    tensor cores at every feature width, recorded in
    ``_build.policy_counts``.  bfloat16 features (and images) run
    ``compute_dtype="bfloat16"``: ``mip_train_grads_bf16``.
    """
    tensors = {"features": features, "dists": dists, "noise": noise, "pixels": pixels,
               "tc_fwd": tc_fwd, "tc_bwd": tc_bwd}
    device = check_inputs(TRAIN_NAME, packed, tensors, ALIGNED)
    dtype = features.dtype
    tc_mlp.check_images(TRAIN_NAME, packed, tc_fwd, tc_bwd, dtype)
    n_rays, rows = _check_shapes(TRAIN_NAME, packed, color_outputs, tensors)
    labels = _check_labels(TRAIN_NAME, labels, n_rays, seg_weight, device)
    if device.type == "cpu":
        return mip_train_grads_plain(packed, features, dists, noise, pixels, labels,
                                     color_outputs, seg_weight, white_background)
    _check_kernel(TRAIN_NAME, packed, color_outputs, n_rays, rows)
    kpacked = tc_mlp.pad_packed(packed)
    if tc_fwd is None or tc_bwd is None:
        tc_fwd, tc_bwd = tc_mlp.tc_images(kpacked, backward=True, dtype=dtype)
    fn_name, policy = route(TRAIN_NAME, dtype == torch.bfloat16)
    layers, hidden = packed["b"].shape
    outputs = packed["w_out"].shape[1]
    sc = mip_scratch(kpacked, n_rays * rows, device)
    losses = torch.empty((2,), dtype=torch.float32, device=device)
    gout = torch.empty_like(sc["out"])
    ray_loss = torch.empty((n_rays, 2), dtype=torch.float32, device=device)
    ray_scratch = torch.empty((n_rays * rows * TRAIN_RAY_FLOATS,), dtype=torch.float32,
                              device=device)
    fn = getattr(_build.load(TRAIN_NAME), fn_name)
    err = fn(
        features.data_ptr(), dists.data_ptr(), noise.data_ptr(), pixels.data_ptr(),
        _build.ptr(labels), losses.data_ptr(), sc["grads"].data_ptr(),
        n_rays, rows, features.shape[-1], hidden, layers, color_outputs, outputs,
        int(white_background), float(seg_weight), *weight_pointers(kpacked),
        *scratch_pointers(sc), gout.data_ptr(), ray_loss.data_ptr(), ray_scratch.data_ptr(),
        sc["splits"], tc_fwd.data_ptr(), tc_bwd.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check_launch(TRAIN_NAME, err)
    _build.launch_counts[TRAIN_NAME] += 1
    _build.policy_counts[(TRAIN_NAME, policy)] += 1
    return losses[0], losses[1], kernel_grads(sc["grads"], kpacked, packed)


class MipTrainGradsFunction(torch.autograd.Function):
    """``mip_train_grads`` under autograd: ``apply(options, images,
    features, dists, noise, pixels, labels, *weights)`` with the weights in
    ``PACK_ORDER`` returns ``(loss, rgb_loss, seg_loss)``, ``loss = rgb_loss
    + seg_weight * seg_loss`` (the other two carry no gradient); the
    backward scales the gradients the call returned.  ``options`` is
    ``(color_outputs, seg_weight, white_background)``, ``images`` the
    operand images ``(tc_fwd, tc_bwd)`` built beforehand (``None`` where
    not)."""

    @staticmethod
    def forward(ctx, options: Tuple, images: Tuple, features, dists, noise, pixels, labels,
                *weights):
        color_outputs, seg_weight, white = options
        rgb_loss, seg_loss, d_packed = mip_train_grads(
            _packed_from_args(weights), features, dists, noise, pixels, labels,
            color_outputs, seg_weight, white, tc_fwd=images[0], tc_bwd=images[1],
        )
        ctx.save_for_backward(*[d_packed[k] for k in PACK_ORDER])
        ctx.mark_non_differentiable(rgb_loss, seg_loss)
        return rgb_loss + seg_weight * seg_loss, rgb_loss, seg_loss

    @staticmethod
    def backward(ctx, g_loss, _g_rgb, _g_seg):
        return (None,) * 7 + tuple(t * g_loss for t in ctx.saved_tensors)


def mip_train_loss_and_grads(
    model, render, batch: Dict[str, torch.Tensor], draws: sampling.StepDraws,
    seg_weight: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Loss and parameter gradients of ONE fused mip train step: IPE
    features of the draws' fenceposts, Gaussian-mean interval lengths, and
    K6 for the rest (one launch; the weights packed, and their operand
    images built in ``model.cfg.compute_dtype``, once for the step; the
    features cast to it, as the JAX function does).  ``draws`` holds the step's log-bbox
    fenceposts and per-interval noise (``sampling.draw_step`` with the
    model's ``bbox_diagonal``).  Returns ``(loss, grads, aux)`` with
    ``grads`` keyed by ``model.named_parameters()``."""
    rays_o, rays_d = batch["rays_o"], batch["rays_d"]
    names, params = zip(*model.named_parameters())
    means, _, features = model.integrated_pe(rays_o, rays_d, draws.t_coarse)
    dists = compositing.distances_from_points(means)
    dt = getattr(torch, model.cfg.compute_dtype)
    with torch.enable_grad():
        packed, *images = prepare_weights(model.mlp, backward=True, dtype=dt)
        loss, rgb_loss, seg_loss = MipTrainGradsFunction.apply(
            (model.cfg.color_outputs, seg_weight, render.white_background), tuple(images),
            features.to(dt).contiguous(), dists.contiguous(), draws.noise_c.contiguous(),
            batch["pixels"].contiguous(), batch.get("labels"),
            *[packed[k] for k in PACK_ORDER],
        )
    grads = torch.autograd.grad(loss, params)
    aux = {"loss": loss.detach(), "rgb_loss": rgb_loss, "fine_mse": rgb_loss}
    if seg_weight > 0.0:
        aux["seg_loss"] = seg_loss
    return loss.detach(), dict(zip(names, grads)), aux
