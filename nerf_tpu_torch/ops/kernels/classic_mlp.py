"""K1-fwd: the classic NeRF point MLP forward as one CUDA kernel.

Counterpart of ``nerf_tpu/ops/pallas/fused_mlp.py`` (``pack_classic_params``,
``supports_classic_config`` and the forward of ``classic_mlp_pallas``).  The
kernel is ``csrc/classic_mlp_fwd.cu`` (device code in
``csrc/classic_mlp.cuh``); ``classic_mlp_fwd_plain`` is its plain PyTorch
version, which the wrapper runs for CPU tensors and the tests and
``chip_smoke.py`` hold the kernel against.  There is no backward yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from nerf_tpu_torch.config import ClassicNeRFConfig
from nerf_tpu_torch.models.mlp import LAYER_NORM_EPS, ClassicMLP
from nerf_tpu_torch.ops.kernels import _build

Packed = Dict[str, torch.Tensor]

NAME = "classic_mlp_fwd"
HIDDEN_WIDTHS = (32, 64, 128, 256)  # the kernel's instantiations
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
    (there is no backward yet; run under ``torch.no_grad()``).  Returns the
    device."""
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
            raise NotImplementedError(f"{name}: no backward yet; {key} requires grad")
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
    kernel (raising on what it does not take).
    """
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
