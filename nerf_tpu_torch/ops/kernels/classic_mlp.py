"""K1: the classic NeRF point MLP, forward and backward, as CUDA kernels.

Counterpart of ``nerf_tpu/ops/pallas/fused_mlp.py`` (``pack_classic_params``,
``supports_classic_config`` and ``classic_mlp_pallas`` with its custom VJP).
K1-fwd is ``csrc/classic_mlp_fwd.cu`` (device code in
``csrc/classic_mlp.cuh``), K1-bwd ``csrc/classic_mlp_bwd.cu`` (device code
in ``csrc/classic_mlp_train.cuh``).  ``classic_mlp_fwd_plain`` and
``classic_mlp_bwd_plain`` are their plain PyTorch versions, which the
wrappers run for CPU tensors and the tests and ``chip_smoke.py`` hold the
kernels against.  Under autograd ``classic_mlp_fwd`` runs as a
``torch.autograd.Function`` whose backward is ``classic_mlp_bwd``.

The scratch helpers below (``train_scratch``, ``flat_grads_to_packed``)
serve the three kernels that run the MLP backward (K1-bwd, K2, K3).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from nerf_tpu_torch.config import ClassicNeRFConfig
from nerf_tpu_torch.models.mlp import LAYER_NORM_EPS, ClassicMLP
from nerf_tpu_torch.ops.kernels import _build

Packed = Dict[str, torch.Tensor]

NAME = "classic_mlp_fwd"
BWD_NAME = "classic_mlp_bwd"
HIDDEN_WIDTHS = (32, 64, 128, 256)  # the kernel's instantiations
MAX_COLORS = 8  # color outputs the backward kernels take
# Weight slabs in the order of the C interface (wd_in may be absent).
PACK_ORDER = (
    "w0", "wx", "wd_in", "whh", "b", "g", "beta",
    "w_dens", "b_dens", "w_col", "b_col",
)


def supports_classic_config(cfg: ClassicNeRFConfig) -> bool:
    """The kernel covers the reference architecture family, with or without
    the view branch, at any encoding width."""
    return cfg.trunk_blocks == (4, 4) and (
        not cfg.use_viewdirs or cfg.view_branch_depth == 2
    )


def pack_classic_params(mlp: ClassicMLP) -> Packed:
    """The MLP's weights as the kernel's contiguous float32 slabs, Linear
    weights ``(in, out)``.  The skip and view layers split into a slab on
    the hidden state (rows ``:H``, inside ``whh``) and one on the encoding
    (``wx``, ``wd_in``), following the concat order ``[h, enc]``."""
    h = mlp.cfg.hidden_size
    b0, b1 = list(mlp.block_0), list(mlp.block_1)
    b2 = list(mlp.block_2) if hasattr(mlp, "block_2") else []
    linears = b0[0::3] + b1[0::3] + b2[0::3]  # execution order
    norms = b0[2::3] + b1[2::3] + b2[2::3]

    def w(lin):
        return lin.weight.t()

    whh = [w(l) for l in b0[3::3]] + [w(b1[0])[:h]] + [w(l) for l in b1[3::3]]
    if b2:
        whh += [w(b2[0])[:h], w(b2[3])]
    packed = {
        "w0": w(b0[0]),
        "wx": w(b1[0])[h:],
        "whh": torch.stack(whh),
        "b": torch.stack([l.bias for l in linears]),
        "g": torch.stack([n.weight for n in norms]),
        "beta": torch.stack([n.bias for n in norms]),
        "w_dens": w(mlp.density),
        "b_dens": mlp.density.bias,
        "w_col": w(mlp.color),
        "b_col": mlp.color.bias,
    }
    if b2:
        packed["wd_in"] = w(b2[0])[h:]
    return {k: v.contiguous() for k, v in packed.items()}


def classic_mlp_fwd_plain(
    packed: Packed, x_enc: torch.Tensor, d_enc: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``[P, 1 + C]`` rows of
    ``[density, color logits]``."""

    def layer(i: int, pre: torch.Tensor) -> torch.Tensor:
        a = torch.relu(pre + packed["b"][i])
        return F.layer_norm(
            a, a.shape[-1:], packed["g"][i], packed["beta"][i], LAYER_NORM_EPS
        )

    whh = packed["whh"]
    h = layer(0, x_enc @ packed["w0"])
    for i in (1, 2, 3):
        h = layer(i, h @ whh[i - 1])
    h = layer(4, h @ whh[3] + x_enc @ packed["wx"])
    for i in (5, 6, 7):
        h = layer(i, h @ whh[i - 1])
    density = h @ packed["w_dens"] + packed["b_dens"]
    if "wd_in" in packed:
        h = layer(8, h @ whh[7] + d_enc @ packed["wd_in"])
        h = layer(9, h @ whh[8])
    color = h @ packed["w_col"] + packed["b_col"]
    return torch.cat([density, color], dim=-1)


def check_inputs(name: str, packed: Packed, tensors: Dict[str, Optional[torch.Tensor]]) -> torch.device:
    """Shared argument checks of the kernel wrappers: one device, float32
    (bfloat16 is not implemented yet), contiguous, and no autograd graph
    (a wrapper has no autograd backward of its own; ``classic_mlp_fwd``
    routes through ``ClassicMLPFunction`` before it gets here).  Returns
    the device."""
    given = {k: v for k, v in tensors.items() if v is not None}
    given.update({f"packed[{k}]": v for k, v in packed.items()})
    device = next(iter(given.values())).device
    for key, t in given.items():
        if t.dtype == torch.bfloat16:
            raise NotImplementedError(f"{name}: bfloat16 inputs are not implemented yet ({key})")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(f"{name}: has no autograd backward; {key} requires grad")
    if device.type == "cuda":
        for key in PACK_ORDER:
            if key in packed and packed[key].data_ptr() % 16:
                raise ValueError(f"{name}: packed[{key}] must be 16-byte aligned")
    elif device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {device}")
    return device


def weight_pointers(packed: Packed):
    return [_build.ptr(packed.get(k)) for k in PACK_ORDER]


def classic_mlp_fwd(
    packed: Packed, x_enc: torch.Tensor, d_enc: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Classic MLP forward on encoded points: ``x_enc [P, XE]`` and, with
    the view branch, ``d_enc [P, DE]`` -> ``[P, 1 + C]`` rows of ``[density,
    color logits]``.

    CPU tensors run ``classic_mlp_fwd_plain``; CUDA tensors launch the
    kernel (raising on what it does not take).  When autograd records and
    an input requires grad, the call runs as ``ClassicMLPFunction``, whose
    backward is ``classic_mlp_bwd`` (K1-bwd).
    """
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x_enc, d_enc, *packed.values())
    ):
        return ClassicMLPFunction.apply(x_enc, d_enc, *[packed.get(k) for k in PACK_ORDER])
    has_view = "wd_in" in packed
    if has_view != (d_enc is not None):
        raise ValueError(f"{NAME}: d_enc must be given iff the weights have a view branch")
    device = check_inputs(NAME, packed, {"x_enc": x_enc, "d_enc": d_enc})
    hidden = packed["w0"].shape[1]
    cols = 1 + packed["w_col"].shape[1]
    if x_enc.ndim != 2 or x_enc.shape[1] != packed["w0"].shape[0]:
        raise ValueError(f"{NAME}: x_enc must be [P, {packed['w0'].shape[0]}], got {tuple(x_enc.shape)}")
    if has_view and (d_enc.ndim != 2 or d_enc.shape != (x_enc.shape[0], packed["wd_in"].shape[0])):
        raise ValueError(f"{NAME}: d_enc must be [P, {packed['wd_in'].shape[0]}], got {tuple(d_enc.shape)}")
    if device.type == "cpu":
        return classic_mlp_fwd_plain(packed, x_enc, d_enc)
    if hidden not in HIDDEN_WIDTHS:
        raise ValueError(f"{NAME}: hidden width {hidden} not in {HIDDEN_WIDTHS}")
    n_points = x_enc.shape[0]
    out = torch.empty((n_points, cols), dtype=torch.float32, device=device)
    if n_points == 0:
        return out
    fn = getattr(_build.load(NAME), NAME)
    err = fn(
        x_enc.data_ptr(), _build.ptr(d_enc), out.data_ptr(), n_points,
        x_enc.shape[1], d_enc.shape[1] if has_view else 0, hidden, cols - 1,
        *weight_pointers(packed), torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check_launch(NAME, err)
    _build.launch_counts[NAME] += 1
    return out


# -- backward (K1-bwd) -------------------------------------------------------

# Order of the flat gradient the backward kernels write: the weight slabs
# (summed by the split product over points), then the per-tile column sums.
FLAT_ORDER = (
    "w0", "wx", "wd_in", "whh", "b", "g", "beta",
    "w_dens", "w_col", "b_dens", "b_col",
)
WGRAD_TILE = 128  # output tile edge of the weight-gradient product
TILE_ROWS = 64  # rows per block of the MLP passes
COLSUM_GROUPS = 64


def _packed_from_args(weights) -> Packed:
    return {k: v for k, v in zip(PACK_ORDER, weights) if v is not None}


def packed_grads_plain(
    packed: Packed, inputs: Tuple[torch.Tensor, ...], fn
) -> Tuple[Tuple[Optional[torch.Tensor], ...], Packed]:
    """Gradients by ``torch.autograd`` of the scalar or tensor objective
    ``fn(leaves, *inputs)``: returns the inputs' and the packed weights'
    gradients (the plain versions of the backward kernels use it)."""
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_(True) for k, v in packed.items()}
        ins = tuple(None if t is None else t.detach().requires_grad_(True) for t in inputs)
        objective, cotangent = fn(leaves, *ins)
        wrt = [t for t in ins if t is not None] + list(leaves.values())
        grads = list(torch.autograd.grad(objective, wrt, cotangent, allow_unused=True))
    in_grads = tuple(None if t is None else grads.pop(0) for t in ins)
    return in_grads, dict(zip(leaves, grads))


def classic_mlp_bwd_plain(
    packed: Packed, x_enc: torch.Tensor, d_enc: Optional[torch.Tensor], g_out: torch.Tensor,
    input_grads: bool = True,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Packed]:
    """The backward kernel's function in plain PyTorch: the vector-Jacobian
    product of ``classic_mlp_fwd_plain`` with ``g_out [P, 1 + C]``."""
    if not input_grads:
        _, d_packed = packed_grads_plain(
            packed, (), lambda w: (classic_mlp_fwd_plain(w, x_enc, d_enc), g_out)
        )
        return None, None, d_packed
    (dx, dd), d_packed = packed_grads_plain(
        packed, (x_enc, d_enc), lambda w, x, d: (classic_mlp_fwd_plain(w, x, d), g_out)
    )
    return dx, dd, d_packed


def flat_grad_numels(packed: Packed) -> Tuple[int, int]:
    """(weight-slab floats, per-tile floats) of the flat gradient."""
    sizes = [packed[k].numel() for k in FLAT_ORDER if k in packed]
    n_slabs = 4 if "wd_in" in packed else 3
    return sum(sizes[:n_slabs]), sum(sizes[n_slabs:])


def flat_grads_to_packed(flat: torch.Tensor, packed: Packed) -> Packed:
    """Split the kernels' flat gradient into the packed weights' shapes."""
    out, at = {}, 0
    for k in FLAT_ORDER:
        if k in packed:
            n = packed[k].numel()
            out[k] = flat[at:at + n].view(packed[k].shape)
            at += n
    return out


def train_scratch(packed: Packed, n_rows: int, device: torch.device) -> Dict[str, object]:
    """Global scratch of the MLP backward passes for ``n_rows`` rows
    (``csrc/classic_mlp_train.cuh``): the stored chain (xhat and
    statistics), every layer's dpre, the split weight-gradient partials,
    the per-tile partials, the sum's staging buffer, the hidden weight
    slabs transposed, the MLP output and the flat gradient.  The points are split so that the weight-gradient
    product's blocks (two run on each SM at a time) fill about four
    waves."""
    layers, hidden = packed["b"].shape
    xe = packed["w0"].shape[0]
    de = packed["wd_in"].shape[0] if "wd_in" in packed else 0
    cols = 1 + packed["w_col"].shape[1]
    tiles_n = math.ceil(hidden / WGRAD_TILE)
    prod_tiles = tiles_n * (2 * math.ceil(xe / WGRAD_TILE) + math.ceil(de / WGRAD_TILE)
                            + (layers - 1) * tiles_n)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = max(1, min(64, 8 * sms // prod_tiles, math.ceil(n_rows / 1024)))
    wfloats, tfloats = flat_grad_numels(packed)
    tiles = math.ceil(n_rows / TILE_ROWS)

    def buf(*shape):
        return torch.empty(shape, dtype=torch.float32, device=device)

    return dict(
        xhat=buf(layers, n_rows, hidden), stats=buf(layers, n_rows, 2),
        dpre=buf(layers, n_rows, hidden), wpart=buf(splits, wfloats),
        tpart=buf(tiles, tfloats), tmp=buf(COLSUM_GROUPS, max(wfloats, tfloats)),
        wt=buf(layers - 1, hidden, hidden), out=buf(n_rows, cols),
        grads=buf(wfloats + tfloats), splits=splits,
    )


SCRATCH_ORDER = ("xhat", "stats", "dpre", "wpart", "tpart", "tmp", "wt", "out")


def scratch_pointers(s: Dict[str, object]):
    """The scratch buffers in the C interfaces' order (``SCRATCH_ORDER``)."""
    return [s[k].data_ptr() for k in SCRATCH_ORDER]


def classic_mlp_bwd(
    packed: Packed, x_enc: torch.Tensor, d_enc: Optional[torch.Tensor], g_out: torch.Tensor,
    input_grads: bool = True,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Packed]:
    """Backward of ``classic_mlp_fwd``: given ``g_out [P, 1 + C]``, the
    cotangent of its output, returns ``(dx [P, XE], dd [P, DE] or None,
    d_packed)`` with ``d_packed`` the gradient of every packed weight,
    summed over the points.  With ``input_grads=False`` the kernel skips
    the encodings' cotangents and ``dx`` and ``dd`` are ``None``.

    CPU tensors run ``classic_mlp_bwd_plain``; CUDA tensors launch the
    kernel (raising on what it does not take).
    """
    has_view = "wd_in" in packed
    if has_view != (d_enc is not None):
        raise ValueError(f"{BWD_NAME}: d_enc must be given iff the weights have a view branch")
    device = check_inputs(BWD_NAME, packed, {"x_enc": x_enc, "d_enc": d_enc, "g_out": g_out})
    xe, hidden = packed["w0"].shape
    colors = packed["w_col"].shape[1]
    n_points = x_enc.shape[0]
    expected = {"x_enc": (x_enc, (n_points, xe)), "g_out": (g_out, (n_points, 1 + colors))}
    if has_view:
        expected["d_enc"] = (d_enc, (n_points, packed["wd_in"].shape[0]))
    for key, (t, shape) in expected.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{BWD_NAME}: {key} must be {shape}, got {tuple(t.shape)}")
    if device.type == "cpu":
        return classic_mlp_bwd_plain(packed, x_enc, d_enc, g_out, input_grads)
    if hidden not in HIDDEN_WIDTHS:
        raise ValueError(f"{BWD_NAME}: hidden width {hidden} not in {HIDDEN_WIDTHS}")
    if colors > MAX_COLORS:
        raise ValueError(f"{BWD_NAME}: at most {MAX_COLORS} color outputs, got {colors}")
    dx = torch.empty_like(x_enc) if input_grads else None
    dd = torch.empty_like(d_enc) if has_view and input_grads else None
    if n_points == 0:
        return dx, dd, {k: torch.zeros_like(v) for k, v in packed.items()}
    s = train_scratch(packed, n_points, device)
    fn = getattr(_build.load(BWD_NAME), BWD_NAME)
    err = fn(
        x_enc.data_ptr(), _build.ptr(d_enc), g_out.data_ptr(), _build.ptr(dx), _build.ptr(dd),
        s["grads"].data_ptr(), n_points, xe, d_enc.shape[1] if has_view else 0, hidden, colors,
        *weight_pointers(packed), *scratch_pointers(s), s["splits"],
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check_launch(BWD_NAME, err)
    _build.launch_counts[BWD_NAME] += 1
    return dx, dd, flat_grads_to_packed(s["grads"], packed)


class ClassicMLPFunction(torch.autograd.Function):
    """``classic_mlp_fwd`` under autograd: forward K1-fwd, backward K1-bwd.
    Arguments ``(x_enc, d_enc, *weights)`` with the weights in
    ``PACK_ORDER`` (``None`` for an absent ``wd_in``)."""

    @staticmethod
    def forward(ctx, x_enc, d_enc, *weights):
        ctx.save_for_backward(x_enc, d_enc, *weights)
        return classic_mlp_fwd(_packed_from_args(weights), x_enc, d_enc)

    @staticmethod
    def backward(ctx, g_out):
        x_enc, d_enc, *weights = ctx.saved_tensors
        packed = _packed_from_args(weights)
        dx, dd, d_packed = classic_mlp_bwd(
            packed, x_enc, d_enc, g_out.contiguous(),
            input_grads=any(ctx.needs_input_grad[:2]),
        )
        return (dx, dd, *[d_packed.get(k) for k in PACK_ORDER])
