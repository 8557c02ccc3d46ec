"""K4: the forward-only fine stage of the hierarchical-reuse renderer as one
CUDA kernel: the fine MLP, then the union of the reused coarse samples and
the new fine ones composited in t order.

Counterpart of ``nerf_tpu/ops/pallas/fused_hier.py::fine_union_eval_pallas``.
The kernel is ``csrc/union_eval.cu``: the MLP's hidden and encoding products
run as 3xTF32 on the tensor cores (``csrc/tc_mlp.cuh``, on the operand images
``tc_mlp.tc_images`` builds, once per call unless the caller built them
once per frame), the epilogues, heads and
compositing in float32, at every encoding width (the encodings stream
through the tile a k-chunk at a time), hidden width (``csrc/tc_mlp.cuh``
note 11), sample count and colour count (the fine outputs and the
compositing scratch lie in device memory, so the block's bytes are the
tile's alone, and ``_build.policy_counts`` records ``"tc"``).
``union_eval_plain`` is its plain PyTorch version: ``classic_mlp_fwd_plain``
followed by ``weights_from_union_sorted`` and the ``composite_*`` functions
(with ``matmul=tc_mlp.tc_matmul`` it emulates the kernel's products).
bfloat16 encodings run ``compute_dtype="bfloat16"`` (``union_eval_bf16``;
``classic_mlp``'s docstring).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from nerf_tpu_torch.ops import compositing
from nerf_tpu_torch.ops.kernels import _build, tc_mlp
from nerf_tpu_torch.ops.kernels.classic_mlp import (
    Packed,
    check_inputs,
    classic_mlp_fwd_plain,
    route,
    weight_pointers,
    wide_scratch,
)

NAME = "union_eval"


def union_eval_plain(
    packed: Packed,
    x_enc: torch.Tensor,
    d_enc: Optional[torch.Tensor],
    t_coarse: torch.Tensor,
    t_fine: torch.Tensor,
    dens_c: torch.Tensor,
    col_c: torch.Tensor,
    dnorm: torch.Tensor,
    matmul=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch (see ``union_eval``);
    ``matmul`` as in ``classic_mlp_fwd_plain``."""
    n_rays, s_fine = t_fine.shape
    d_rows = None
    if d_enc is not None:
        d_rows = d_enc[:, None, :].expand(n_rays, s_fine, d_enc.shape[-1])
        d_rows = d_rows.reshape(n_rays * s_fine, -1)
    out = classic_mlp_fwd_plain(packed, x_enc.reshape(n_rays * s_fine, -1), d_rows, matmul)
    out = out.reshape(n_rays, s_fine, -1)
    weights = compositing.weights_from_union_norm(
        dens_c, out[..., :1], t_coarse, t_fine, dnorm[:, None]
    )
    rgb = compositing.composite_rgb(weights, torch.cat([col_c, out[..., 1:]], dim=-2))
    depth = compositing.composite_depth(weights, torch.cat([t_coarse, t_fine], dim=-1))
    return rgb, depth, compositing.composite_acc(weights)


def union_eval(
    packed: Packed,
    x_enc: torch.Tensor,
    d_enc: Optional[torch.Tensor],
    t_coarse: torch.Tensor,
    t_fine: torch.Tensor,
    dens_c: torch.Tensor,
    col_c: torch.Tensor,
    dnorm: torch.Tensor,
    tc_fwd: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fine MLP plus order-free union compositing, forward only.

    Args:
        packed: ``classic_mlp.pack_classic_params`` of the model's MLP.
        x_enc: ``[R, Sf, XE]`` encodings of the fine samples.
        d_enc: ``[R, DE]`` per-ray view-direction encodings (the kernel
            broadcasts them to the ray's samples), or ``None`` without the
            view branch.
        t_coarse: ``[R, Sc]`` coarse t-values, sorted along each ray.
        t_fine: ``[R, Sf]`` fine t-values, sorted along each ray.
        dens_c: ``[R, Sc, 1]`` raw coarse densities (reused, not recomputed).
        col_c: ``[R, Sc, C]`` raw coarse color logits.
        dnorm: ``[R]`` ray direction norms ``||d||``.
        tc_fwd: the weights' forward operand image
            (``tc_mlp.tc_images(packed)[0]``) built beforehand, else the
            call builds it where the tensor-core tile runs.

    Returns ``(rgb [R, C], depth [R], acc [R])`` over the union, without a
    background.  CPU tensors run ``union_eval_plain``; CUDA tensors launch
    the kernel (raising on what it does not take).  Both encodings (and
    ``tc_fwd``) bfloat16: ``compute_dtype="bfloat16"``.
    """
    has_view = "wd_in" in packed
    if has_view != (d_enc is not None):
        raise ValueError(f"{NAME}: d_enc must be given iff the weights have a view branch")
    device = check_inputs(NAME, packed, {
        "x_enc": x_enc, "d_enc": d_enc, "t_coarse": t_coarse, "t_fine": t_fine,
        "dens_c": dens_c, "col_c": col_c, "dnorm": dnorm, "tc_fwd": tc_fwd,
    })
    dtype = x_enc.dtype
    tc_mlp.check_images(NAME, packed, tc_fwd, dtype=dtype)
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
    }
    if has_view:
        expected["d_enc"] = (d_enc, (n_rays, packed["wd_in"].shape[0]))
    for key, (t, shape) in expected.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{NAME}: {key} must be {shape}, got {tuple(t.shape)}")
    if device.type == "cpu":
        return union_eval_plain(packed, x_enc, d_enc, t_coarse, t_fine, dens_c, col_c, dnorm)
    if s_coarse < 1 or s_fine < 1:
        raise ValueError(f"{NAME}: takes at least one coarse and one fine sample per ray, "
                         f"got {s_coarse} + {s_fine}")
    out = torch.empty((n_rays, colors + 2), dtype=torch.float32, device=device)
    if n_rays:
        de = d_enc.shape[1] if has_view else 0
        kpacked = tc_mlp.pad_packed(packed)
        if tc_fwd is None:
            tc_fwd = tc_mlp.tc_images(kpacked, dtype=dtype)[0]
        fn_name, policy = route(NAME, dtype == torch.bfloat16)
        lib = _build.load(NAME)
        fn = getattr(lib, fn_name)
        fout = torch.empty((n_rays * s_fine, colors + 1), dtype=torch.float32, device=device)
        scratch = torch.empty((n_rays, 4 * (s_coarse + s_fine)), dtype=torch.float32,
                              device=device)
        wide = wide_scratch(packed, lib.union_eval_blocks(n_rays, s_fine), device)
        err = fn(
            x_enc.data_ptr(), _build.ptr(d_enc), t_coarse.data_ptr(), t_fine.data_ptr(),
            dens_c.data_ptr(), col_c.data_ptr(), dnorm.data_ptr(), out.data_ptr(),
            n_rays, s_coarse, s_fine, xe, de, hidden, colors,
            *weight_pointers(kpacked), _build.ptr(tc_fwd), fout.data_ptr(),
            scratch.data_ptr(), _build.ptr(wide), torch.cuda.current_stream(device).cuda_stream,
        )
        _build.check_launch(NAME, err)
        _build.launch_counts[NAME] += 1
        _build.policy_counts[(NAME, policy)] += 1
    return out[:, :colors], out[:, colors], out[:, colors + 1]
