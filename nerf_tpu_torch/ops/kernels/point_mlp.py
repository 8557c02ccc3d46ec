"""K8: the classic NeRF point MLP on RAW points and view directions, the
frequency encoding computed inside the kernel, forward and backward.

Counterpart of ``nerf_tpu/ops/pallas/fused_mlp.py::classic_pointmlp_pallas``
(K1's two ``pallas_call``s with ``fuse_encoding=True``).  The encoding is
``sin(x @ S + phase)`` on the constants of ``encoding.enc_consts``.
K8-fwd is ``csrc/classic_pointmlp_fwd.cu``, K1-fwd's tensor-core tile
(``csrc/tc_mlp.cuh``'s ``fwd_tc_kernel``, 3xTF32 ``wgmma``) with the
encodings computed in the block (``csrc/encode.cuh``); K8-bwd
``csrc/classic_pointmlp_bwd.cu``, K2's tensor-core passes
(``csrc/tc_mlp.cuh``'s ``TcProducts``), the encodings' cotangents
included.  Both read the operand images ``tc_mlp.tc_images`` builds, at
every encoding width (the tile computes the encodings one k-chunk at a
time); ``_build.policy_counts`` records ``"tc"``.
``classic_pointmlp_fwd_plain`` and ``classic_pointmlp_bwd_plain`` are
their plain PyTorch versions, which the
wrappers run for CPU tensors (with ``matmul=tc_mlp.tc_matmul_autograd`` they
emulate the tensor-core products).  Under autograd the call runs as
``ClassicPointMLPFunction``, whose backward is K8-bwd: it returns the
weights' gradients and the raw points' and directions'.

``compute_dtype="bfloat16"`` (``dtype=torch.bfloat16``, as JAX's
``classic_pointmlp_pallas(..., compute_dtype=jnp.bfloat16)``): the raw
points and directions stay float32 and so do the sines; every product,
the heads' included, runs on operands rounded to bfloat16 with float32
sums (``<name>_bf16`` of each library, on bf16 operand images; the plain
versions run ``tc_mlp.bf16_matmul_autograd``).  K8-bwd writes the
encodings it computes to scratch as bfloat16 (the values its products
round them to) and keeps the encodings' cotangents float32 before the
chain rule, as JAX's fused kernel does, so the raw inputs' cotangents are
float32.  ``_build.policy_counts`` records ``"tc_bf16"``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from nerf_tpu_torch.ops import encoding
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
    train_scratch,
    weight_pointers,
    wide_scratch,
)

NAME = "classic_pointmlp_fwd"
BWD_NAME = "classic_pointmlp_bwd"

Consts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]  # sx, phx, sd, phd


def encoding_consts(x_size: int, x_bound: float, d_size: int, d_bound: float,
                    device) -> Consts:
    """``(sx [3, 3 x_size], phx [3 x_size], sd [3, 3 d_size], phd [3 d_size])``
    from ``encoding.enc_consts`` on ``device``."""
    sx, phx = encoding.enc_consts(x_size, x_bound)
    sd, phd = encoding.enc_consts(d_size, d_bound)
    return tuple(torch.as_tensor(a, device=device) for a in (sx, phx[0], sd, phd[0]))


def _encode(points: torch.Tensor, s: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    return torch.sin(points @ s + phase)


def classic_pointmlp_fwd_plain(packed: Packed, points: torch.Tensor, dirs: torch.Tensor,
                               consts: Consts, matmul=None,
                               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``sin(x @ S + phase)`` of
    both inputs, then ``classic_mlp_fwd_plain``; ``[P, 1 + C]``.  ``matmul``
    computes the MLP's hidden and encoding products, as in
    ``classic_mlp_fwd_plain`` (the encodings' ``x @ S`` is one exact product
    a lane in both versions and stays ``@``); ``dtype`` bfloat16 runs the
    bf16 arithmetic on the float32 sines."""
    sx, phx, sd, phd = consts
    return classic_mlp_fwd_plain(packed, _encode(points, sx, phx), _encode(dirs, sd, phd),
                                 matmul, bf16=dtype == torch.bfloat16)


def rounded_encodings(points: torch.Tensor, dirs: torch.Tensor, consts: Consts,
                      dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encodings K8-bwd writes to scratch, in plain PyTorch: ``sin(x @ S
    + phase)`` of both inputs in ``dtype`` (bfloat16 rounded to nearest
    even from the float32 sines)."""
    sx, phx, sd, phd = consts
    return _encode(points, sx, phx).to(dtype), _encode(dirs, sd, phd).to(dtype)


def classic_pointmlp_bwd_plain(
    packed: Packed, points: torch.Tensor, dirs: torch.Tensor, consts: Consts,
    g_out: torch.Tensor, input_grads: bool = True, matmul=None,
    dtype: torch.dtype = torch.float32,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Packed]:
    """The backward kernel's function in plain PyTorch: the vector-Jacobian
    product of ``classic_pointmlp_fwd_plain`` with ``g_out [P, 1 + C]``;
    ``matmul`` and ``dtype`` as there (``tc_mlp.tc_matmul_autograd``
    emulates the tensor-core passes, the encodings' cotangents included; in
    bfloat16 those cotangents are the float32 sums of the rounded products,
    as the kernel's)."""
    ins = (points, dirs) if input_grads else ()

    def objective(w, *raw):
        p, d = raw if input_grads else (points, dirs)
        return classic_pointmlp_fwd_plain(w, p, d, consts, matmul, dtype), g_out

    in_grads, d_packed = packed_grads_plain(packed, ins, objective)
    return (*in_grads, d_packed) if input_grads else (None, None, d_packed)


def _check(name: str, packed: Packed, points, dirs, consts, extra: dict,
           dtype: torch.dtype) -> torch.device:
    if "wd_in" not in packed:
        raise ValueError(f"{name}: covers the view-conditioned architecture only; use "
                         "classic_mlp.classic_mlp_fwd(x_enc, None) without the view branch")
    sx, phx, sd, phd = consts
    tensors = {"points": points, "dirs": dirs, "sx": sx, "phx": phx, "sd": sd, "phd": phd}
    device = check_inputs(name, packed, {**tensors, **extra}, compute=dtype)
    n_points = points.shape[0]
    expected = {
        "points": (points, (n_points, 3)), "dirs": (dirs, (n_points, 3)),
        "sx": (sx, (3, packed["w0"].shape[0])), "phx": (phx, (packed["w0"].shape[0],)),
        "sd": (sd, (3, packed["wd_in"].shape[0])), "phd": (phd, (packed["wd_in"].shape[0],)),
    }
    if "g_out" in extra:
        expected["g_out"] = (extra["g_out"], (n_points, 1 + packed["w_col"].shape[1]))
    for key, (t, shape) in expected.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} must be {shape}, got {tuple(t.shape)}")
    return device


def classic_pointmlp_fwd(packed: Packed, points: torch.Tensor, dirs: torch.Tensor,
                         consts: Consts, tc_fwd: Optional[torch.Tensor] = None,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K8-fwd on ``points [P, 3]``, ``dirs [P, 3]`` -> ``[P, 1 + C]`` rows of
    ``[density, color logits]``.  CPU tensors run
    ``classic_pointmlp_fwd_plain``; CUDA tensors launch the kernel (raising
    on what it does not take), its tensor-core tile at every encoding
    width.  ``tc_fwd`` is the weights' forward operand image
    (``tc_mlp.tc_images(packed, dtype=dtype)[0]``) built beforehand, else
    the call builds it.  ``dtype`` is the compute dtype: bfloat16 launches
    ``classic_pointmlp_fwd_bf16``.
    ``_build.policy_counts`` records the tile each call ran."""
    device = _check(NAME, packed, points, dirs, consts, {"tc_fwd": tc_fwd}, dtype)
    tc_mlp.check_images(NAME, packed, tc_fwd, dtype=dtype)
    if device.type == "cpu":
        return classic_pointmlp_fwd_plain(packed, points, dirs, consts, dtype=dtype)
    n_points = points.shape[0]
    out = torch.empty((n_points, 1 + packed["w_col"].shape[1]), dtype=torch.float32,
                      device=device)
    if n_points == 0:
        return out
    xe, hidden = packed["w0"].shape
    de = packed["wd_in"].shape[0]
    kpacked = tc_mlp.pad_packed(packed)
    if tc_fwd is None:
        tc_fwd = tc_mlp.tc_images(kpacked, dtype=dtype)[0]
    fn_name, policy = route(NAME, dtype == torch.bfloat16)
    fn = getattr(_build.load(NAME), fn_name)
    wide = wide_scratch(packed, -(-n_points // 64), device)
    err = fn(
        points.data_ptr(), dirs.data_ptr(), out.data_ptr(), n_points, xe, de, hidden,
        packed["w_col"].shape[1], *[c.data_ptr() for c in consts],
        *weight_pointers(kpacked), _build.ptr(tc_fwd), _build.ptr(wide),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check_launch(NAME, err)
    _build.launch_counts[NAME] += 1
    _build.policy_counts[(NAME, policy)] += 1
    return out


def classic_pointmlp_bwd(
    packed: Packed, points: torch.Tensor, dirs: torch.Tensor, consts: Consts,
    g_out: torch.Tensor, input_grads: bool = True, tc_fwd: Optional[torch.Tensor] = None,
    tc_bwd: Optional[torch.Tensor] = None, dtype: torch.dtype = torch.float32,
    keep: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Packed]:
    """K8-bwd: given ``g_out [P, 1 + C]``, returns ``(dpoints [P, 3], ddirs
    [P, 3], d_packed)``, the weights' gradients summed over the points;
    with ``input_grads=False`` the raw inputs' cotangents are skipped and
    ``None``.  CPU tensors run ``classic_pointmlp_bwd_plain``; CUDA tensors
    launch the kernel (raising on what it does not take): its tensor-core
    passes on the operand images ``tc_fwd`` and ``tc_bwd``
    (``tc_mlp.tc_images(packed, backward=True, dtype=dtype)``) when given,
    else built here, at every encoding width.  ``dtype`` bfloat16 launches
    ``classic_pointmlp_bwd_bf16`` (the cotangents stay float32).
    ``_build.policy_counts`` records the tile ``fwd_store`` ran.  A CUDA
    call given the dict ``keep`` puts there the encodings the kernel wrote
    to its scratch, ``x_enc [P, XE]`` and ``d_enc [P, DE]`` in ``dtype``
    (``rounded_encodings`` is their plain version)."""
    device = _check(BWD_NAME, packed, points, dirs, consts,
                    {"g_out": g_out, "tc_fwd": tc_fwd, "tc_bwd": tc_bwd}, dtype)
    tc_mlp.check_images(BWD_NAME, packed, tc_fwd, tc_bwd, dtype)
    if device.type == "cpu":
        return classic_pointmlp_bwd_plain(packed, points, dirs, consts, g_out, input_grads,
                                          dtype=dtype)
    n_points = points.shape[0]
    dpts = torch.empty_like(points) if input_grads else None
    ddirs = torch.empty_like(dirs) if input_grads else None
    if n_points == 0:
        return dpts, ddirs, {k: torch.zeros_like(v) for k, v in packed.items()}
    xe, hidden = packed["w0"].shape
    de = packed["wd_in"].shape[0]
    kpacked = tc_mlp.pad_packed(packed)
    if tc_fwd is None or tc_bwd is None:
        tc_fwd, tc_bwd = tc_mlp.tc_images(kpacked, backward=True, dtype=dtype)
    fn_name, policy = route(BWD_NAME, dtype == torch.bfloat16)
    s = train_scratch(kpacked, n_points, device)

    def buf(*shape, dt=torch.float32):
        return torch.empty(shape, dtype=dt, device=device)

    x_enc, d_enc = buf(n_points, xe, dt=dtype), buf(n_points, de, dt=dtype)
    dx_enc = buf(n_points, xe) if input_grads else None
    dd_enc = buf(n_points, de) if input_grads else None
    fn = getattr(_build.load(BWD_NAME), fn_name)
    err = fn(
        points.data_ptr(), dirs.data_ptr(), g_out.data_ptr(), _build.ptr(dpts),
        _build.ptr(ddirs), s["grads"].data_ptr(), n_points, xe, de, hidden,
        packed["w_col"].shape[1], *[c.data_ptr() for c in consts], *weight_pointers(kpacked),
        *scratch_pointers(s), x_enc.data_ptr(), d_enc.data_ptr(), _build.ptr(dx_enc),
        _build.ptr(dd_enc), s["splits"], tc_fwd.data_ptr(), tc_bwd.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check_launch(BWD_NAME, err)
    _build.launch_counts[BWD_NAME] += 1
    _build.policy_counts[(BWD_NAME, policy)] += 1
    if keep is not None:
        keep.update(x_enc=x_enc, d_enc=d_enc)
    return dpts, ddirs, kernel_grads(s["grads"], kpacked, packed)


class ClassicPointMLPFunction(torch.autograd.Function):
    """K8 under autograd: forward K8-fwd, backward K8-bwd.  Arguments
    ``(options, points, dirs, *weights)``: ``options`` is ``(consts,
    dtype)``, the weights in ``PACK_ORDER``; the backward returns the raw
    inputs' cotangents and the weights' gradients.  On the card the forward
    builds the operand images K8-fwd and K8-bwd read (``tc_mlp.tc_images``
    in ``dtype``), runs K8-fwd on the forward image and hands both to the
    backward, once a step."""

    @staticmethod
    def forward(ctx, options: Tuple, points, dirs, *weights):
        consts, dtype = options
        packed = _packed_from_args(weights)
        ctx.options = options
        ctx.images = (tc_mlp.tc_images(packed, backward=True, dtype=dtype)
                      if points.device.type == "cuda" else (None, None))
        ctx.save_for_backward(points, dirs, *weights)
        return classic_pointmlp_fwd(packed, points, dirs, consts, tc_fwd=ctx.images[0],
                                    dtype=dtype)

    @staticmethod
    def backward(ctx, g_out):
        points, dirs, *weights = ctx.saved_tensors
        consts, dtype = ctx.options
        packed = _packed_from_args(weights)
        dpts, ddirs, d_packed = classic_pointmlp_bwd(
            packed, points, dirs, consts, g_out.contiguous(),
            input_grads=any(ctx.needs_input_grad[1:3]), tc_fwd=ctx.images[0],
            tc_bwd=ctx.images[1], dtype=dtype,
        )
        return (None, dpts, ddirs, *[d_packed.get(k) for k in PACK_ORDER])


def classic_pointmlp(
    model_or_packed: Union[torch.nn.Module, Packed],
    points: torch.Tensor,
    dirs: torch.Tensor,
    x_encoding_size: int,
    x_bound: float,
    d_encoding_size: int,
    d_bound: float,
    compute_dtype: str = "float32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encoder and classic MLP on RAW positions and view directions: the
    counterpart of ``classic_pointmlp_pallas``.

    Args:
        model_or_packed: a ``ClassicNeRF``, its ``ClassicMLP``, or
            ``classic_mlp.pack_classic_params`` of one; view-conditioned
            (``ValueError`` otherwise, as in JAX).
        points: ``[..., 3]`` sample positions.
        dirs: ``[..., 3]`` view directions (broadcast to ``points``).
        x_encoding_size / x_bound: ``cfg.x_positional_encoding_size`` and
            ``cfg.normalize_position``.
        d_encoding_size / d_bound: the same for the directions.
        compute_dtype: ``"float32"`` or ``"bfloat16"``, the products'
            operand dtype, as the JAX function's argument (a model's
            ``cfg.compute_dtype`` is not read, as there).

    Returns ``(density [..., 1], color_logits [..., C])``, float32.  Under
    autograd (an input or weight that requires grad) the call runs as
    ``ClassicPointMLPFunction``.
    """
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"{NAME}: compute_dtype must be 'float32' or 'bfloat16', got "
                         f"{compute_dtype!r}")
    dtype = getattr(torch, compute_dtype)
    if isinstance(model_or_packed, torch.nn.Module):
        packed = pack_classic_params(getattr(model_or_packed, "mlp", model_or_packed))
    else:
        packed = model_or_packed
    lead = points.shape[:-1]
    p2 = points.reshape(-1, 3).contiguous()
    d2 = dirs.expand(points.shape).reshape(-1, 3).contiguous()
    consts = encoding_consts(x_encoding_size, x_bound, d_encoding_size, d_bound, p2.device)
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (p2, d2, *packed.values())
    ):
        out = ClassicPointMLPFunction.apply((consts, dtype), p2, d2,
                                            *[packed.get(k) for k in PACK_ORDER])
    else:
        out = classic_pointmlp_fwd(packed, p2, d2, consts, dtype=dtype)
    out = out.reshape(*lead, out.shape[-1])
    return out[..., :1], out[..., 1:]
