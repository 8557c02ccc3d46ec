"""K2: the coarse-only classic train objective and its gradients as one
CUDA call: MLP forward, density noise, alpha compositing, sigmoid colour,
the stage-weighted MSE, and the backward through all of it.

Counterpart of ``nerf_tpu/ops/pallas/fused_train.py::
classic_train_grads_pallas``.  The kernel is ``csrc/train_grads.cu``: the
MLP passes of ``csrc/classic_mlp_train.cuh`` with their hidden and encoding
products as 3xTF32 on the tensor cores (``csrc/tc_mlp.cuh``, on the operand
images ``tc_mlp.tc_images`` builds once per call, at every encoding width:
``_build.policy_counts`` records ``"tc"``).  ``classic_train_grads_plain``
is its plain PyTorch version: ``classic_mlp_fwd_plain``,
``weights_from_density`` and the MSE, with gradients from
``torch.autograd`` (with
``matmul=tc_mlp.tc_matmul_autograd`` it emulates the kernel's products,
forward and backward).  bfloat16 encodings run ``compute_dtype="bfloat16"``
(``train_grads_bf16``, the plain version's ``tc_mlp.bf16_matmul_autograd``;
``classic_mlp``'s docstring).  ``TrainGradsFunction`` puts the call under
autograd: its backward hands back the gradients the kernel already
computed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from nerf_tpu_torch.ops import compositing
from nerf_tpu_torch.ops.kernels import _build, tc_mlp
from nerf_tpu_torch.ops.kernels.classic_mlp import (
    PACK_ORDER,
    Packed,
    _packed_from_args,
    check_inputs,
    classic_mlp_fwd_plain,
    kernel_grads,
    packed_grads_plain,
    route,
    scratch_pointers,
    train_scratch,
    weight_pointers,
)

NAME = "train_grads"
MAX_SAMPLES = 1024


def _loss_and_weights(w, x_enc, d_enc, dists, noise, pixels, white_background, loss_weight,
                      matmul):
    n_rays, s = noise.shape
    rows = n_rays * s
    out = classic_mlp_fwd_plain(
        w, x_enc.reshape(rows, -1), None if d_enc is None else d_enc.reshape(rows, -1), matmul
    ).reshape(n_rays, s, -1)
    weights = compositing.weights_from_density(out[..., :1] + noise[..., None], dists)
    rgb = compositing.composite_rgb_with_background(
        weights, out[..., 1:], 1.0 if white_background else None
    )
    return loss_weight * torch.mean((rgb - pixels) ** 2), weights[..., 0]


def classic_train_grads_plain(
    packed: Packed,
    x_enc: torch.Tensor,
    d_enc: Optional[torch.Tensor],
    dists: torch.Tensor,
    noise: torch.Tensor,
    pixels: torch.Tensor,
    num_samples: int,
    white_background: bool = False,
    loss_weight: float = 1.0,
    return_weights: bool = False,
    matmul=None,
):
    """The kernel's function in plain PyTorch (see ``classic_train_grads``);
    ``matmul`` as in ``classic_mlp_fwd_plain``."""
    del num_samples  # the shapes carry it
    kept = {}

    def objective(w):
        loss, weights = _loss_and_weights(
            w, x_enc, d_enc, dists, noise, pixels, white_background, loss_weight, matmul
        )
        kept["loss"], kept["weights"] = loss.detach(), weights.detach()
        return loss, None

    _, d_packed = packed_grads_plain(packed, (), objective)
    if return_weights:
        return kept["loss"], d_packed, kept["weights"]
    return kept["loss"], d_packed


def classic_train_grads(
    packed: Packed,
    x_enc: torch.Tensor,
    d_enc: Optional[torch.Tensor],
    dists: torch.Tensor,
    noise: torch.Tensor,
    pixels: torch.Tensor,
    num_samples: int,
    white_background: bool = False,
    loss_weight: float = 1.0,
    return_weights: bool = False,
):
    """One evaluation of the coarse-only classic train objective.

    Args:
        packed: ``classic_mlp.pack_classic_params`` of the model's MLP.
        x_enc: ``[R, S, XE]`` encoded positions.
        d_enc: ``[R, S, DE]`` encoded directions, or ``None`` without the
            view branch.
        dists: ``[R, S, 1]`` interval lengths (``distances_from_tvals``).
        noise: ``[R, S]`` density-logit noise, drawn beforehand (zeros
            when noiseless).
        pixels: ``[R, C]`` target pixels.
        num_samples: S.
        white_background: composite over white (``rgb + 1 - acc``).
        loss_weight: scales the objective (0.5 per stage under the
            two-stage mean).
        return_weights: also return the compositing weights ``[R, S]``.

    Returns ``(loss, d_packed)``, plus ``weights`` when asked: the scalar
    MSE ``loss_weight * mean((rgb - pixels)^2)`` and the gradient of every
    packed weight.  CPU tensors run ``classic_train_grads_plain``; CUDA
    tensors launch the kernel (raising on what it does not take).  Both
    encodings bfloat16: ``compute_dtype="bfloat16"``.
    """
    has_view = "wd_in" in packed
    if has_view != (d_enc is not None):
        raise ValueError(f"{NAME}: d_enc must be given iff the weights have a view branch")
    device = check_inputs(NAME, packed, {
        "x_enc": x_enc, "d_enc": d_enc, "dists": dists, "noise": noise, "pixels": pixels,
    })
    dtype = x_enc.dtype
    n_rays, s = noise.shape
    xe, hidden = packed["w0"].shape
    colors = packed["w_col"].shape[1]
    expected = {
        "x_enc": (x_enc, (n_rays, num_samples, xe)),
        "dists": (dists, (n_rays, num_samples, 1)),
        "pixels": (pixels, (n_rays, colors)),
    }
    if has_view:
        expected["d_enc"] = (d_enc, (n_rays, num_samples, packed["wd_in"].shape[0]))
    for key, (t, shape) in expected.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{NAME}: {key} must be {shape}, got {tuple(t.shape)}")
    if device.type == "cpu":
        return classic_train_grads_plain(
            packed, x_enc, d_enc, dists, noise, pixels, num_samples,
            white_background, loss_weight, return_weights,
        )
    if not 0 < s <= MAX_SAMPLES:
        raise ValueError(f"{NAME}: takes 1..{MAX_SAMPLES} samples per ray, got {s}")
    if n_rays == 0:
        raise ValueError(f"{NAME}: needs at least one ray")
    rows = n_rays * s
    de = d_enc.shape[-1] if has_view else 0
    fn_name, policy = route(NAME, dtype == torch.bfloat16)
    kpacked = tc_mlp.pad_packed(packed)
    sc = train_scratch(kpacked, rows, device)
    tc_fwd, tc_bwd = tc_mlp.tc_images(kpacked, backward=True, dtype=dtype)
    loss = torch.empty((1,), dtype=torch.float32, device=device)
    weights = torch.empty((n_rays, s), dtype=torch.float32, device=device) if return_weights else None
    gout = torch.empty_like(sc["out"])
    ray_loss = torch.empty((n_rays,), dtype=torch.float32, device=device)
    fn = getattr(_build.load(NAME), fn_name)
    err = fn(
        x_enc.data_ptr(), _build.ptr(d_enc), dists.data_ptr(), noise.data_ptr(),
        pixels.data_ptr(), loss.data_ptr(), sc["grads"].data_ptr(), _build.ptr(weights),
        n_rays, s, xe, de, hidden, colors, int(white_background), float(loss_weight),
        *weight_pointers(kpacked), *scratch_pointers(sc), gout.data_ptr(), ray_loss.data_ptr(),
        sc["splits"], tc_fwd.data_ptr(), tc_bwd.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check_launch(NAME, err)
    _build.launch_counts[NAME] += 1
    _build.policy_counts[(NAME, policy)] += 1
    d_packed = kernel_grads(sc["grads"], kpacked, packed)
    if return_weights:
        return loss[0], d_packed, weights
    return loss[0], d_packed


class TrainGradsFunction(torch.autograd.Function):
    """``classic_train_grads`` under autograd: ``apply(options, x_enc,
    d_enc, dists, noise, pixels, *weights)`` with the weights in
    ``PACK_ORDER`` returns ``(loss, weights [R, S])`` (the weights carry no
    gradient); the backward scales the gradients the call returned.
    ``options`` is ``(num_samples, white_background, loss_weight)``."""

    @staticmethod
    def forward(ctx, options: Tuple, x_enc, d_enc, dists, noise, pixels, *weights):
        num_samples, white, loss_weight = options
        loss, d_packed, comp_weights = classic_train_grads(
            _packed_from_args(weights), x_enc, d_enc, dists, noise, pixels, num_samples,
            white, loss_weight, return_weights=True,
        )
        ctx.save_for_backward(*[d_packed.get(k) for k in PACK_ORDER])
        ctx.mark_non_differentiable(comp_weights)
        return loss, comp_weights

    @staticmethod
    def backward(ctx, g_loss, _g_weights):
        grads = [None if t is None else t * g_loss for t in ctx.saved_tensors]
        return (None, None, None, None, None, None, *grads)


def train_grads_loss(
    packed: Packed, x_enc, d_enc, dists, noise, pixels, num_samples: int,
    white_background: bool = False, loss_weight: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss, weights [R, S])`` of ``classic_train_grads`` with the loss
    differentiable with respect to ``packed`` (one launch)."""
    return TrainGradsFunction.apply(
        (num_samples, white_background, loss_weight), x_enc, d_enc, dists, noise, pixels,
        *[packed.get(k) for k in PACK_ORDER],
    )
