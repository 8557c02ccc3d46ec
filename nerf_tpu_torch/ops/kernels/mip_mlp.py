"""K5: the HEAD (mip) point MLP, forward and backward, as CUDA kernels.

Counterpart of ``nerf_tpu/ops/pallas/fused_mip_mlp.py``
(``pack_mip_params``, ``supports_mip_config`` and ``mip_mlp_pallas`` with
its custom VJP).  K5-fwd is ``csrc/mip_mlp_fwd.cu``, K5-bwd
``csrc/mip_mlp_bwd.cu``, both on the device code of ``csrc/mip_mlp.cuh``.
``mip_mlp_fwd_plain`` and ``mip_mlp_bwd_plain`` are their plain PyTorch
versions, which the wrappers run for CPU tensors and the tests and
``chip_smoke.py`` hold the kernels against (with
``matmul=tc_mlp.tc_matmul_autograd`` they emulate the tensor-core
products).  K5-fwd, K5-bwd, K6 and K7 (``mip_train``) run the chain on
the tensor cores (the ``MipTc`` policy of ``csrc/mip_mlp.cuh``, 3xTF32
``wgmma``; K5-bwd's features' cotangent too), on the weights as
``prepare_weights`` packs and images them, at every feature width (the
features stream through the one tile a k-chunk at a time, ``csrc/tc_mlp.cuh``
note 9), every layer count from 2 and every head width;
``_build.policy_counts`` records ``"tc"`` for each call.  Under autograd
``mip_mlp_fwd`` runs as ``MipMLPFunction``, whose backward is
``mip_mlp_bwd`` (K5-bwd).

``compute_dtype="bfloat16"``: features given as bfloat16 (and the operand
images built beforehand, ``prepare_weights(..., dtype=torch.bfloat16)``)
make K5-fwd, K5-bwd, K6 and K7 launch the bf16 kernel of their library
(``<name>_bf16``: every product, the 54-wide head's included, on operands
rounded to bfloat16 with float32 sums, float32 outputs and gradients;
K5-bwd's features' cotangent bfloat16, the features' dtype), recorded as
``"tc_bf16"``; the plain versions then run the JAX
package's bf16 arithmetic (``tc_mlp.bf16_matmul_autograd`` for every
product, the head's included).

The network: ``L`` x (Linear -> LayerNorm -> ReLU), then one Linear to
``O = 1 + color + segmentation`` logits.  The packed slabs, Linear weights
``(in, out)``: ``w_in [F, H]``, ``whh [L-1, H, H]``, ``b``, ``g``, ``beta``
``[L, H]``, ``w_out [H, O]``, ``b_out [O]``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from nerf_tpu_torch.models.mlp import LAYER_NORM_EPS, MipMLP
from nerf_tpu_torch.ops.kernels import _build, tc_mlp
from nerf_tpu_torch.ops.kernels.classic_mlp import (
    WGRAD_TILE,
    Packed,
    PreparedWeights,
    check_inputs,
    packed_grads_plain,
    route,
    scratch_for,
    scratch_pointers,
    wide_scratch,
)

NAME = "mip_mlp_fwd"
BWD_NAME = "mip_mlp_bwd"
PACK_ORDER = ("w_in", "whh", "b", "g", "beta", "w_out", "b_out")
# Order of the flat gradient the backward kernels write: the weight slabs
# (summed by the split product over points), then the per-tile column sums.
FLAT_ORDER = ("w_in", "whh", "w_out", "b", "g", "beta", "b_out")
ALIGNED = ("w_in", "whh")  # slabs the kernels stage with 16-byte copies


def supports_mip_config(cfg) -> bool:
    return cfg.num_hidden_layers >= 2


def pack_mip_params(mlp: MipMLP) -> Packed:
    """The MLP's weights as the kernels' contiguous float32 slabs, Linear
    weights ``(in, out)``."""
    seq = list(mlp.prediction_heads)
    linears, norms, out = seq[0:-1:3], seq[1:-1:3], seq[-1]
    packed = {
        "w_in": linears[0].weight.t(),
        "whh": torch.stack([lin.weight.t() for lin in linears[1:]]),
        "b": torch.stack([lin.bias for lin in linears]),
        "g": torch.stack([n.weight for n in norms]),
        "beta": torch.stack([n.bias for n in norms]),
        "w_out": out.weight.t(),
        "b_out": out.bias,
    }
    return {k: v.contiguous() for k, v in packed.items()}


def prepare_weights(mlp: MipMLP, backward: bool = False,
                    dtype: torch.dtype = torch.float32) -> PreparedWeights:
    """``classic_mlp.prepare_weights`` for the mip MLP: the packed weights
    and, where they lie on the card, their operand images
    (``tc_mlp.tc_images``; ``tc_bwd`` where asked for), once for the tiles
    of a frame or the passes of a step.  Valid only while the weights do not
    change; under autograd ``packed`` keeps the graph to the parameters.
    ``dtype`` is the compute dtype the calls will run in (their features'
    dtype)."""
    packed = pack_mip_params(mlp)
    if packed["w_in"].device.type != "cuda":
        return PreparedWeights(packed)
    return PreparedWeights(packed, *tc_mlp.tc_images(packed, backward, dtype))


def mip_mlp_fwd_plain(packed: Packed, features: torch.Tensor, matmul=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``[P, O]`` rows of
    ``[density, color logits, segmentation logits]``.  ``matmul`` computes
    the hidden and feature products (the head stays float32), by default
    ``torch.matmul``: ``tc_mlp.tc_matmul_autograd`` emulates the tensor-core
    products of K6 and K7.  Features given as bfloat16 run
    ``compute_dtype="bfloat16"``: by default ``tc_mlp.bf16_matmul_autograd``,
    and ``matmul`` takes the head too."""
    bf16 = features.dtype == torch.bfloat16
    if matmul is None:
        matmul = tc_mlp.bf16_matmul_autograd if bf16 else torch.matmul
    head = matmul if bf16 else torch.matmul
    h = features.float()
    for i in range(packed["b"].shape[0]):
        w = packed["w_in"] if i == 0 else packed["whh"][i - 1]
        z = matmul(h, w) + packed["b"][i]
        h = torch.relu(F.layer_norm(z, z.shape[-1:], packed["g"][i], packed["beta"][i],
                                    LAYER_NORM_EPS))
    return head(h, packed["w_out"]) + packed["b_out"]


def check_kernel_shapes(name: str, packed: Packed) -> None:
    """What the mip kernels take beyond ``check_inputs``: at least 2 layers
    (``supports_mip_config``); every hidden width (``csrc/tc_mlp.cuh`` note
    11), feature width, layer count and head width beyond that."""
    layers = packed["b"].shape[0]
    if layers < 2:
        raise ValueError(f"{name}: takes 2 or more hidden layers, got {layers}")


def weight_pointers(packed: Packed):
    return [packed[k].data_ptr() for k in PACK_ORDER]


def _packed_from_args(weights) -> Packed:
    return dict(zip(PACK_ORDER, weights))


def mip_mlp_fwd(packed: Packed, features: torch.Tensor,
                tc_fwd: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mip MLP forward on IPE features ``[P, F]`` -> ``[P, O]`` rows of
    ``[density, color logits, segmentation logits]``.

    CPU tensors run ``mip_mlp_fwd_plain``; CUDA tensors launch the kernel
    (raising on what it does not take): K7's tile on the tensor cores at
    every feature width.  ``tc_fwd`` is the weights' forward operand image
    (``tc_mlp.tc_images(packed)[0]``) built beforehand, else the call
    builds it.  ``_build.policy_counts`` records ``"tc"`` (``"tc_bf16"``)
    for each call.  When autograd records and an input
    requires grad, the call runs as ``MipMLPFunction``, whose backward is
    ``mip_mlp_bwd`` (K5-bwd), on the images it builds itself.  bfloat16
    features (and ``tc_fwd``) run ``compute_dtype="bfloat16"``:
    ``mip_mlp_fwd_bf16``.
    """
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (features, *packed.values())
    ):
        return MipMLPFunction.apply(features, *[packed[k] for k in PACK_ORDER])
    device = check_inputs(NAME, packed, {"features": features, "tc_fwd": tc_fwd}, ALIGNED)
    dtype = features.dtype
    tc_mlp.check_images(NAME, packed, tc_fwd, dtype=dtype)
    n_feat = packed["w_in"].shape[0]
    if features.ndim != 2 or features.shape[1] != n_feat:
        raise ValueError(f"{NAME}: features must be [P, {n_feat}], got {tuple(features.shape)}")
    if device.type == "cpu":
        return mip_mlp_fwd_plain(packed, features)
    check_kernel_shapes(NAME, packed)
    layers, hidden = packed["b"].shape
    outputs = packed["w_out"].shape[1]
    n_points = features.shape[0]
    out = torch.empty((n_points, outputs), dtype=torch.float32, device=device)
    if n_points == 0:
        return out
    kpacked = tc_mlp.pad_packed(packed)
    if tc_fwd is None:
        tc_fwd = tc_mlp.tc_images(kpacked, dtype=dtype)[0]
    fn_name, policy = route(NAME, dtype == torch.bfloat16)
    fn = getattr(_build.load(NAME), fn_name)
    wide = wide_scratch(packed, math.ceil(n_points / 64), device)
    err = fn(
        features.data_ptr(), out.data_ptr(), n_points, n_feat, hidden, layers, outputs,
        *weight_pointers(kpacked), tc_fwd.data_ptr(), _build.ptr(wide),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check_launch(NAME, err)
    _build.launch_counts[NAME] += 1
    _build.policy_counts[(NAME, policy)] += 1
    return out


# -- backward (K5-bwd) -------------------------------------------------------


def mip_mlp_bwd_plain(
    packed: Packed, features: torch.Tensor, g_out: torch.Tensor, input_grads: bool = True,
    matmul=None,
) -> Tuple[Optional[torch.Tensor], Packed]:
    """The backward kernel's function in plain PyTorch: the vector-Jacobian
    product of ``mip_mlp_fwd_plain`` with ``g_out [P, O]``; ``matmul`` as
    there (``tc_mlp.tc_matmul_autograd`` emulates the tensor-core passes,
    the features' cotangent included; bfloat16 features run the bf16
    emulation, their cotangent bfloat16)."""
    if not input_grads:
        _, d_packed = packed_grads_plain(
            packed, (), lambda w: (mip_mlp_fwd_plain(w, features, matmul), g_out)
        )
        return None, d_packed
    (dfeat,), d_packed = packed_grads_plain(
        packed, (features,), lambda w, x: (mip_mlp_fwd_plain(w, x, matmul), g_out)
    )
    return dfeat, d_packed


def flat_grad_numels(packed: Packed) -> Tuple[int, int]:
    """(weight-slab floats, per-tile floats) of the flat gradient."""
    sizes = [packed[k].numel() for k in FLAT_ORDER]
    return sum(sizes[:3]), sum(sizes[3:])


def flat_grads_to_packed(flat: torch.Tensor, packed: Packed) -> Packed:
    """Split the kernels' flat gradient into the packed weights' shapes."""
    out, at = {}, 0
    for k in FLAT_ORDER:
        n = packed[k].numel()
        out[k] = flat[at:at + n].view(packed[k].shape)
        at += n
    return out


def kernel_grads(flat: torch.Tensor, kpacked: Packed, packed: Packed) -> Packed:
    """The flat gradient a kernel wrote for its weights ``kpacked``
    (``tc_mlp.pad_packed(packed)``) in ``packed``'s shapes, the padded slots
    dropped."""
    return tc_mlp.unpad_grads(flat_grads_to_packed(flat, kpacked), packed)


def mip_scratch(packed: Packed, n_rows: int, device: torch.device) -> Dict[str, object]:
    """Global scratch of the mip MLP backward passes for ``n_rows`` rows
    (``classic_mlp.scratch_for``)."""
    layers, hidden = packed["b"].shape
    n_feat, outputs = packed["w_in"].shape[0], packed["w_out"].shape[1]
    tiles_h = math.ceil(hidden / WGRAD_TILE)
    prod_tiles = (tiles_h * math.ceil(n_feat / WGRAD_TILE) + (layers - 1) * tiles_h * tiles_h
                  + tiles_h * math.ceil(outputs / WGRAD_TILE))
    return scratch_for(layers, hidden, outputs, n_rows, prod_tiles, *flat_grad_numels(packed),
                       device)


def mip_mlp_bwd(
    packed: Packed, features: torch.Tensor, g_out: torch.Tensor, input_grads: bool = True,
    tc_fwd: Optional[torch.Tensor] = None, tc_bwd: Optional[torch.Tensor] = None,
) -> Tuple[Optional[torch.Tensor], Packed]:
    """Backward of ``mip_mlp_fwd``: given ``g_out [P, O]``, the cotangent
    of its output, returns ``(dfeat [P, F], d_packed)`` with ``d_packed``
    the gradient of every packed weight, summed over the points.  With
    ``input_grads=False`` the kernel skips the features' cotangent and
    ``dfeat`` is ``None``.  The kernel recomputes the forward, as the TPU
    kernel does.

    CPU tensors run ``mip_mlp_bwd_plain``; CUDA tensors launch the kernel
    (raising on what it does not take): its tensor-core passes on the
    operand images ``tc_fwd`` and ``tc_bwd`` (``tc_mlp.tc_images(packed,
    backward=True)``) when given, else built here, at every feature
    width, layer count and head width.  ``_build.policy_counts`` records
    ``"tc"`` for each call.  bfloat16 features (and images) run
    ``compute_dtype="bfloat16"`` (``mip_mlp_bwd_bf16``; ``dfeat``
    bfloat16): policy ``"tc_bf16"``.
    """
    device = check_inputs(BWD_NAME, packed, {"features": features, "g_out": g_out,
                                             "tc_fwd": tc_fwd, "tc_bwd": tc_bwd}, ALIGNED)
    dtype = features.dtype
    tc_mlp.check_images(BWD_NAME, packed, tc_fwd, tc_bwd, dtype)
    layers, hidden = packed["b"].shape
    n_feat, outputs = packed["w_in"].shape[0], packed["w_out"].shape[1]
    n_points = features.shape[0]
    for key, t, shape in (("features", features, (n_points, n_feat)),
                          ("g_out", g_out, (n_points, outputs))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{BWD_NAME}: {key} must be {shape}, got {tuple(t.shape)}")
    if device.type == "cpu":
        return mip_mlp_bwd_plain(packed, features, g_out, input_grads)
    check_kernel_shapes(BWD_NAME, packed)
    dfeat = torch.empty_like(features) if input_grads else None
    if n_points == 0:
        return dfeat, {k: torch.zeros_like(v) for k, v in packed.items()}
    kpacked = tc_mlp.pad_packed(packed)
    if tc_fwd is None or tc_bwd is None:
        tc_fwd, tc_bwd = tc_mlp.tc_images(kpacked, backward=True, dtype=dtype)
    fn_name, policy = route(BWD_NAME, dtype == torch.bfloat16)
    s = mip_scratch(kpacked, n_points, device)
    fn = getattr(_build.load(BWD_NAME), fn_name)
    err = fn(
        features.data_ptr(), g_out.data_ptr(), _build.ptr(dfeat), s["grads"].data_ptr(),
        n_points, n_feat, hidden, layers, outputs, *weight_pointers(kpacked),
        *scratch_pointers(s), s["splits"], tc_fwd.data_ptr(), tc_bwd.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check_launch(BWD_NAME, err)
    _build.launch_counts[BWD_NAME] += 1
    _build.policy_counts[(BWD_NAME, policy)] += 1
    return dfeat, kernel_grads(s["grads"], kpacked, packed)


class MipMLPFunction(torch.autograd.Function):
    """``mip_mlp_fwd`` under autograd: forward K5-fwd, backward K5-bwd.
    Arguments ``(features, *weights)`` with the weights in ``PACK_ORDER``.
    On the card the forward builds the operand images K5-fwd and K5-bwd
    read (``tc_mlp.tc_images``, in the features' dtype), runs K5-fwd on the
    forward image and hands both to the backward, once a step."""

    @staticmethod
    def forward(ctx, features, *weights):
        packed = _packed_from_args(weights)
        ctx.images = (tc_mlp.tc_images(packed, backward=True, dtype=features.dtype)
                      if features.device.type == "cuda" else (None, None))
        ctx.save_for_backward(features, *weights)
        return mip_mlp_fwd(packed, features, tc_fwd=ctx.images[0])

    @staticmethod
    def backward(ctx, g_out):
        features, *weights = ctx.saved_tensors
        dfeat, d_packed = mip_mlp_bwd(
            _packed_from_args(weights), features, g_out.contiguous(),
            input_grads=ctx.needs_input_grad[0], tc_fwd=ctx.images[0], tc_bwd=ctx.images[1],
        )
        return (dfeat, *[d_packed[k] for k in PACK_ORDER])
