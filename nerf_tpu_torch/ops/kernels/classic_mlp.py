"""K1: the classic NeRF point MLP, forward and backward, as CUDA kernels.

Counterpart of ``nerf_tpu/ops/pallas/fused_mlp.py`` (``pack_classic_params``,
``supports_classic_config`` and ``classic_mlp_pallas`` with its custom VJP).
K1-fwd is ``csrc/classic_mlp_fwd.cu``: the MLP's hidden and encoding
products as 3xTF32 on the tensor cores (``csrc/tc_mlp.cuh``'s
``mlp_tile_tc``, K4's tile, the encodings streamed through it a k-chunk at
a time, so at every encoding width).  K1-bwd is ``csrc/classic_mlp_bwd.cu``,
the passes of ``csrc/classic_mlp_train.cuh``: K2's tensor-core passes, the
encodings' cotangents too where they are asked for.
``_build.policy_counts`` records the tile each call ran (``"tc"``).
``classic_mlp_fwd_plain`` and ``classic_mlp_bwd_plain`` are their plain
PyTorch versions, which the wrappers run for CPU tensors and
the tests and ``chip_smoke.py`` hold the kernels against (with
``matmul=tc_mlp.tc_matmul`` or ``tc_matmul_autograd`` they emulate the
tensor-core products).  Under autograd ``classic_mlp_fwd`` runs as a
``torch.autograd.Function`` whose backward is ``classic_mlp_bwd``.

``compute_dtype="bfloat16"``: encodings given as bfloat16 (both, and the
operand images built beforehand) make every wrapper of the classic main
path (K1-fwd, K1-bwd here, K2, K3 and K4) launch the bf16 kernel of its
library (``<name>_bf16``: every product and both heads on operands rounded
to bfloat16, float32 sums, float32 outputs and gradients; the encodings'
cotangents bfloat16), and the plain versions run the JAX package's bf16
arithmetic (``tc_mlp.bf16_matmul_autograd`` for every product, the heads'
included).  ``_build.policy_counts`` records ``"tc_bf16"`` for those
calls.  Every other kernel takes the compute dtype too: the mip family
(K5-fwd, K5-bwd, K6, K7) bfloat16 features (``mip_mlp``, ``mip_train``),
K8 a ``dtype`` argument beside its float32
raw points (``point_mlp``), K9 bfloat16 coarse and view encodings
(``mega_train``).

The kernels read the weights as ``pack_classic_params`` packs them and,
on the tensor cores, as the operand images ``tc_mlp.tc_images`` builds.
The wrappers build both per call unless given them: ``prepare_weights``
builds them once for the calls of a frame or a step, between which the
weights do not change.

The scratch helpers below (``train_scratch``, ``flat_grads_to_packed``)
serve the three kernels that run the MLP backward (K1-bwd, K2, K3).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from nerf_tpu_torch.config import ClassicNeRFConfig
from nerf_tpu_torch.models.mlp import LAYER_NORM_EPS, ClassicMLP
from nerf_tpu_torch.ops.kernels import _build, tc_mlp

Packed = Dict[str, torch.Tensor]

NAME = "classic_mlp_fwd"
BWD_NAME = "classic_mlp_bwd"
# The tiles' instantiations: any other hidden width runs on weights
# zero-padded to the next of them, or past 256 in column blocks of 256
# (tc_mlp.pad_packed, csrc/tc_mlp.cuh note 11).
HIDDEN_WIDTHS = tc_mlp.TILE_WIDTHS
# Weight slabs in the order of the C interface (wd_in may be absent).
PACK_ORDER = (
    "w0", "wx", "wd_in", "whh", "b", "g", "beta",
    "w_dens", "b_dens", "w_col", "b_col",
)


def supports_classic_config(cfg: ClassicNeRFConfig) -> bool:
    """The kernels cover the reference architecture family, with or without
    the view branch, at any encoding width, hidden width and colour count:
    their tensor-core tiles stream the encodings through a ring of k-chunks
    (``csrc/tc_mlp.cuh``, note 9), run a hidden width on weights padded to
    an instantiated tile or, past 256, in column blocks (note 11), and the
    per-ray passes take the colours a chunk at a time, so a
    latent-conditioned or a wider model runs them.  The only limit left is
    the card's memory."""
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


class PreparedWeights(NamedTuple):
    """A model's weights as the kernels read them: ``packed``
    (``pack_classic_params``) and, for weights on the card, the operand
    images (``tc_mlp.tc_images``; ``tc_bwd`` where asked for; bfloat16
    images for ``compute_dtype="bfloat16"``)."""

    packed: Packed
    tc_fwd: Optional[torch.Tensor] = None
    tc_bwd: Optional[torch.Tensor] = None


def prepare_weights(mlp: ClassicMLP, backward: bool = False,
                    dtype: torch.dtype = torch.float32) -> PreparedWeights:
    """Pack the weights, and build their operand images where they lie on
    the card, once for several kernel calls: the tiles of one frame, the
    passes of one step.  Valid only while the weights do not change (build
    them anew after each optimizer step).  Under autograd ``packed`` keeps
    the graph to the parameters; the images carry none.  ``dtype`` is the
    compute dtype the calls will run in (their encodings' dtype)."""
    packed = pack_classic_params(mlp)
    if packed["w0"].device.type != "cuda":
        return PreparedWeights(packed)
    return PreparedWeights(packed, *tc_mlp.tc_images(packed, backward, dtype))


def classic_mlp_fwd_plain(
    packed: Packed, x_enc: torch.Tensor, d_enc: Optional[torch.Tensor] = None,
    matmul=None, bf16: Optional[bool] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``[P, 1 + C]`` rows of
    ``[density, color logits]``.  ``matmul`` computes the hidden and
    encoding products (the heads stay float32): ``tc_mlp.tc_matmul_autograd``
    emulates the tensor-core kernels' 3xTF32; by default ``torch.matmul``.
    ``bf16`` runs ``compute_dtype="bfloat16"`` (by default where the
    encodings are given as bfloat16; K8's plain versions set it for their
    float32 sines): by default ``tc_mlp.bf16_matmul_autograd``, and
    ``matmul`` takes the heads too."""
    if bf16 is None:
        bf16 = x_enc.dtype == torch.bfloat16
    if matmul is None:
        matmul = tc_mlp.bf16_matmul_autograd if bf16 else torch.matmul
    head = matmul if bf16 else torch.matmul
    x_enc = x_enc.float()
    d_enc = None if d_enc is None else d_enc.float()

    def layer(i: int, pre: torch.Tensor) -> torch.Tensor:
        a = torch.relu(pre + packed["b"][i])
        return F.layer_norm(
            a, a.shape[-1:], packed["g"][i], packed["beta"][i], LAYER_NORM_EPS
        )

    whh = packed["whh"]
    h = layer(0, matmul(x_enc, packed["w0"]))
    for i in (1, 2, 3):
        h = layer(i, matmul(h, whh[i - 1]))
    h = layer(4, matmul(h, whh[3]) + matmul(x_enc, packed["wx"]))
    for i in (5, 6, 7):
        h = layer(i, matmul(h, whh[i - 1]))
    density = head(h, packed["w_dens"]) + packed["b_dens"]
    if "wd_in" in packed:
        h = layer(8, matmul(h, whh[7]) + matmul(d_enc, packed["wd_in"]))
        h = layer(9, matmul(h, whh[8]))
    color = head(h, packed["w_col"]) + packed["b_col"]
    return torch.cat([density, color], dim=-1)


# The inputs that take the compute dtype, bfloat16 together under
# compute_dtype="bfloat16": the encodings (K9's coarse and per-ray view
# ones too) or the mip features, and the operand images.
BF16_INPUTS = ("x_enc", "d_enc", "features", "x_enc_c", "d_ray", "tc_fwd", "tc_bwd")


def check_inputs(
    name: str, packed: Packed, tensors: Dict[str, Optional[torch.Tensor]],
    aligned: Tuple[str, ...] = PACK_ORDER, compute: Optional[torch.dtype] = None,
) -> torch.device:
    """Shared argument checks of the kernel wrappers: one device; the
    ``BF16_INPUTS`` given in the compute dtype (``compute`` where the
    caller names it, as K8's ``dtype``; else that of the first one given:
    float32, or bfloat16 for ``compute_dtype="bfloat16"``), every other
    tensor float32; contiguous, no autograd graph (a wrapper has no
    autograd backward of its own; ``classic_mlp_fwd`` routes through
    ``ClassicMLPFunction`` before it gets here), and on the card the
    ``aligned`` weight slabs 16-byte aligned.  Returns the device."""
    given = {k: v for k, v in tensors.items() if v is not None}
    given.update({f"packed[{k}]": v for k, v in packed.items()})
    device = next(iter(given.values())).device
    if compute is None:
        first = next((given[k] for k in BF16_INPUTS if k in given), None)
        compute = torch.float32 if first is None else first.dtype
    elif compute not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: the compute dtype must be float32 or bfloat16, got {compute}")
    for key, t in given.items():
        want = compute if key in BF16_INPUTS and compute == torch.bfloat16 else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name}: {key} must be {str(want)[6:]}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(f"{name}: has no autograd backward; {key} requires grad")
    if device.type == "cuda":
        for key in aligned:
            if key in packed and packed[key].data_ptr() % 16:
                raise ValueError(f"{name}: packed[{key}] must be 16-byte aligned")
    elif device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {device}")
    return device


def weight_pointers(packed: Packed):
    return [_build.ptr(packed.get(k)) for k in PACK_ORDER]


def wide_scratch(packed: Packed, tiles: int, device: torch.device) -> Optional[torch.Tensor]:
    """Past hidden 256 the forward kernels' rows in device memory, 2 x 64 x
    ``padded_hidden`` floats for each of ``tiles`` (``csrc/tc_mlp.cuh`` note
    11); ``None`` below (the kernels read none)."""
    hidden = tc_mlp.padded_hidden(tc_mlp.hidden_of(packed))
    if hidden <= tc_mlp.COL_BLOCK:
        return None
    return torch.empty((max(tiles, 1), 2, TILE_ROWS, hidden), dtype=torch.float32, device=device)


def route(name: str, bf16: bool) -> Tuple[str, str]:
    """The library function a call launches and the policy it records:
    ``name`` and ``"tc"`` in float32, ``<name>_bf16`` and ``"tc_bf16"`` in
    bfloat16."""
    return (f"{name}_bf16", "tc_bf16") if bf16 else (name, "tc")


def _fwd_checks(name: str, packed: Packed, x_enc: torch.Tensor, d_enc: Optional[torch.Tensor],
                tc_fwd: Optional[torch.Tensor]) -> torch.device:
    """The forward wrappers' argument checks; returns the device."""
    has_view = "wd_in" in packed
    if has_view != (d_enc is not None):
        raise ValueError(f"{name}: d_enc must be given iff the weights have a view branch")
    device = check_inputs(name, packed, {"x_enc": x_enc, "d_enc": d_enc, "tc_fwd": tc_fwd})
    tc_mlp.check_images(name, packed, tc_fwd, dtype=x_enc.dtype)
    if x_enc.ndim != 2 or x_enc.shape[1] != packed["w0"].shape[0]:
        raise ValueError(f"{name}: x_enc must be [P, {packed['w0'].shape[0]}], got {tuple(x_enc.shape)}")
    if has_view and (d_enc.ndim != 2 or d_enc.shape != (x_enc.shape[0], packed["wd_in"].shape[0])):
        raise ValueError(f"{name}: d_enc must be [P, {packed['wd_in'].shape[0]}], got {tuple(d_enc.shape)}")
    return device


def classic_mlp_fwd(
    packed: Packed, x_enc: torch.Tensor, d_enc: Optional[torch.Tensor] = None,
    tc_fwd: Optional[torch.Tensor] = None, tc_bwd: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Classic MLP forward on encoded points: ``x_enc [P, XE]`` and, with
    the view branch, ``d_enc [P, DE]`` -> ``[P, 1 + C]`` rows of ``[density,
    color logits]``.

    CPU tensors run ``classic_mlp_fwd_plain``; CUDA tensors launch the
    kernel (raising on what it does not take), its tensor-core tile at
    every encoding width.  ``tc_fwd`` is the weights' forward operand image
    (``tc_mlp.tc_images(packed)[0]``) built beforehand, else the call
    builds it.  When autograd records and an input requires grad, the call
    runs as ``ClassicMLPFunction``, whose forward keeps the chain
    (``classic_mlp_fwd_chain``) and whose backward is ``classic_mlp_bwd``
    (K1-bwd) from it, given ``tc_fwd`` and ``tc_bwd``.  bfloat16 encodings
    (and ``tc_fwd``) run ``compute_dtype="bfloat16"``:
    ``classic_mlp_fwd_bf16``.
    """
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x_enc, d_enc, *packed.values())
    ):
        return ClassicMLPFunction.apply(
            (tc_fwd, tc_bwd), x_enc, d_enc, *[packed.get(k) for k in PACK_ORDER])
    device = _fwd_checks(NAME, packed, x_enc, d_enc, tc_fwd)
    if device.type == "cpu":
        return classic_mlp_fwd_plain(packed, x_enc, d_enc)
    dtype = x_enc.dtype
    hidden = packed["w0"].shape[1]
    cols = 1 + packed["w_col"].shape[1]
    n_points = x_enc.shape[0]
    out = torch.empty((n_points, cols), dtype=torch.float32, device=device)
    if n_points == 0:
        return out
    de = d_enc.shape[1] if d_enc is not None else 0
    kpacked = tc_mlp.pad_packed(packed)
    if tc_fwd is None:
        tc_fwd = tc_mlp.tc_images(kpacked, dtype=dtype)[0]
    fn_name, policy = route(NAME, dtype == torch.bfloat16)
    fn = getattr(_build.load(NAME), fn_name)
    wide = wide_scratch(packed, math.ceil(n_points / TILE_ROWS), device)
    err = fn(
        x_enc.data_ptr(), _build.ptr(d_enc), out.data_ptr(), n_points,
        x_enc.shape[1], de, hidden, cols - 1, *weight_pointers(kpacked),
        _build.ptr(tc_fwd), _build.ptr(wide), torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check_launch(NAME, err)
    _build.launch_counts[NAME] += 1
    _build.policy_counts[(NAME, policy)] += 1
    return out


# The C function of the forward that keeps the chain, in K1-bwd's library.
FWD_STORE_NAME = "classic_mlp_fwd_store"


def classic_mlp_fwd_chain(
    packed: Packed, x_enc: torch.Tensor, d_enc: Optional[torch.Tensor] = None,
    tc_fwd: Optional[torch.Tensor] = None, input_grads: bool = True,
) -> Tuple[torch.Tensor, Dict[str, object]]:
    """``classic_mlp_fwd`` that also keeps what ``classic_mlp_bwd`` needs:
    ``(out, chain)``.  On the card the forward tile that stores the chain
    (``csrc/classic_mlp_bwd.cu``'s ``classic_mlp_fwd_store``, counted as
    K1-fwd): ``chain`` holds every layer's xhat and LayerNorm statistics
    (and, past hidden 256, the dpre buffer whose first layers hold the
    tiles' rows), ``out`` is the tile's output.  On the CPU the plain
    forward run under autograd: ``chain`` holds its graph (the leaves it
    differentiates, the encodings among them where ``input_grads``).
    ``classic_mlp_bwd(..., chain=chain)`` then starts from it instead of
    running the forward again; the caller drops the chain to free it."""
    device = _fwd_checks(NAME, packed, x_enc, d_enc, tc_fwd)
    if device.type == "cpu":
        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_(True) for k, v in packed.items()}
            ins = [None if t is None else t.detach().requires_grad_(input_grads)
                   for t in (x_enc, d_enc)]
            out = classic_mlp_fwd_plain(leaves, *ins)
        return out.detach(), {"graph": (out, *ins, leaves)}
    dtype = x_enc.dtype
    kpacked = tc_mlp.pad_packed(packed)
    n_points = x_enc.shape[0]
    layers, hidden = kpacked["b"].shape
    cols = 1 + packed["w_col"].shape[1]

    def buf(*shape):
        return torch.empty(shape, dtype=torch.float32, device=device)

    chain = dict(xhat=buf(layers, n_points, hidden), stats=buf(layers, n_points, 2),
                 out=buf(n_points, cols))
    if hidden > tc_mlp.COL_BLOCK:  # the tiles' rows (csrc/tc_mlp.cuh note 11)
        chain["dpre"] = buf(layers, n_points, hidden)
    if n_points == 0:
        return chain["out"], chain
    if tc_fwd is None:
        tc_fwd = tc_mlp.tc_images(kpacked, dtype=dtype)[0]
    fn_name, policy = route(FWD_STORE_NAME, dtype == torch.bfloat16)
    fn = getattr(_build.load(BWD_NAME), fn_name)
    err = fn(
        x_enc.data_ptr(), _build.ptr(d_enc), chain["out"].data_ptr(), n_points,
        x_enc.shape[1], d_enc.shape[1] if d_enc is not None else 0, packed["w0"].shape[1],
        cols - 1, *weight_pointers(kpacked), chain["xhat"].data_ptr(),
        chain["stats"].data_ptr(), _build.ptr(chain.get("dpre")), _build.ptr(tc_fwd),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check_launch(FWD_STORE_NAME, err)
    _build.launch_counts[NAME] += 1
    _build.policy_counts[(NAME, policy)] += 1
    return chain["out"], chain


# -- backward (K1-bwd) -------------------------------------------------------

# Order of the flat gradient the backward kernels write: the weight slabs
# (summed by the split product over points), then the per-tile column sums.
FLAT_ORDER = (
    "w0", "wx", "wd_in", "whh", "b", "g", "beta",
    "w_dens", "w_col", "b_dens", "b_col",
)
WGRAD_TILE = 128  # output tile edge of the weight-gradient product
TILE_ROWS = tc_mlp.TILE_ROWS  # rows per block of the MLP passes
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
    input_grads: bool = True, matmul=None, chain: Optional[Dict[str, object]] = None,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Packed]:
    """The backward kernel's function in plain PyTorch: the vector-Jacobian
    product of ``classic_mlp_fwd_plain`` with ``g_out [P, 1 + C]``;
    ``matmul`` as in ``classic_mlp_fwd_plain`` (``tc_mlp.tc_matmul_autograd``
    emulates the tensor-core passes, forward and backward).  ``chain``, the
    plain ``classic_mlp_fwd_chain``'s, is the forward's graph: the products
    are taken through it rather than through a forward run again (the same
    operations, so the same gradients bit for bit)."""
    if chain is not None:
        out, x, d, leaves = chain["graph"]
        ins = [t for t in (x, d) if t is not None] if input_grads else []
        if any(not t.requires_grad for t in ins):
            raise ValueError(f"{BWD_NAME}: the chain was kept without the encodings' gradients")
        grads = list(torch.autograd.grad(out, ins + list(leaves.values()), g_out,
                                         retain_graph=True, allow_unused=True))
        in_grads = [grads.pop(0) if t is not None and input_grads else None for t in (x, d)]
        return in_grads[0], in_grads[1], dict(zip(leaves, grads))
    if not input_grads:
        _, d_packed = packed_grads_plain(
            packed, (), lambda w: (classic_mlp_fwd_plain(w, x_enc, d_enc, matmul), g_out)
        )
        return None, None, d_packed
    (dx, dd), d_packed = packed_grads_plain(
        packed, (x_enc, d_enc), lambda w, x, d: (classic_mlp_fwd_plain(w, x, d, matmul), g_out)
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


def kernel_grads(flat: torch.Tensor, kpacked: Packed, packed: Packed) -> Packed:
    """The flat gradient a kernel wrote for its weights ``kpacked``
    (``tc_mlp.pad_packed(packed)``) in ``packed``'s shapes, the padded slots
    dropped."""
    return tc_mlp.unpad_grads(flat_grads_to_packed(flat, kpacked), packed)


def train_scratch(packed: Packed, n_rows: int, device: torch.device,
                  given: Optional[Dict[str, object]] = None) -> Dict[str, object]:
    """Global scratch of the classic MLP backward passes for ``n_rows``
    rows (``scratch_for``), of the kernels' weights ``tc_mlp.pad_packed``;
    the buffers in ``given`` (a stored chain) are taken as they are."""
    layers, hidden = packed["b"].shape
    xe = packed["w0"].shape[0]
    de = packed["wd_in"].shape[0] if "wd_in" in packed else 0
    tiles_n = math.ceil(hidden / WGRAD_TILE)
    prod_tiles = tiles_n * (2 * math.ceil(xe / WGRAD_TILE) + math.ceil(de / WGRAD_TILE)
                            + (layers - 1) * tiles_n)
    return scratch_for(layers, hidden, 1 + packed["w_col"].shape[1], n_rows, prod_tiles,
                       *flat_grad_numels(packed), device, given)


# The weight-gradient pass's blocks (``csrc/tc_mlp.cuh``'s
# ``wgrad_tc_kernel``: 230,400 bytes of shared memory, so one an SM) and
# the waves of them a launch is cut into.
WGRAD_BLOCKS_PER_SM = 1
WGRAD_WAVES = 8


def wgrad_splits(prod_tiles: int, n_rows: int, sms: int) -> int:
    """The splits of the points of the weight-gradient pass: enough that
    its ``prod_tiles`` output tiles, one block a tile and split, fill
    ``WGRAD_WAVES`` waves of ``WGRAD_BLOCKS_PER_SM`` blocks on each of the
    card's ``sms`` SMs, at most 64 (``COLSUM_GROUPS``: the partials' sum
    stays one stage a split) and no more than one per 1024 rows.  The
    classic and the mip scratch take theirs from here (``scratch_for``)."""
    waves = WGRAD_WAVES * WGRAD_BLOCKS_PER_SM * sms // prod_tiles
    return max(1, min(COLSUM_GROUPS, waves, math.ceil(n_rows / 1024)))


def scratch_for(
    layers: int, hidden: int, cols: int, n_rows: int, prod_tiles: int, wfloats: int,
    tfloats: int, device: torch.device, given: Optional[Dict[str, object]] = None,
) -> Dict[str, object]:
    """Global scratch of the MLP backward passes for ``n_rows`` rows
    (``csrc/classic_mlp_train.cuh``): the stored chain (xhat and
    statistics), every layer's dpre, the split weight-gradient partials
    (``wfloats`` each; ``wgrad_splits`` of them for the product's
    ``prod_tiles`` output tiles), the per-tile partials (``tfloats`` each),
    the sum's staging buffer, the MLP output (``cols`` wide) and the flat
    gradient.  Buffers in ``given`` are taken in place of new ones."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = wgrad_splits(prod_tiles, n_rows, sms)
    tiles = math.ceil(n_rows / TILE_ROWS)
    given = given or {}

    def buf(key, *shape):
        if key in given:
            return given[key]
        return torch.empty(shape, dtype=torch.float32, device=device)

    return dict(
        xhat=buf("xhat", layers, n_rows, hidden), stats=buf("stats", layers, n_rows, 2),
        dpre=buf("dpre", layers, n_rows, hidden), wpart=buf("wpart", splits, wfloats),
        tpart=buf("tpart", tiles, tfloats),
        tmp=buf("tmp", COLSUM_GROUPS, max(wfloats, tfloats)),
        out=buf("out", n_rows, cols), grads=buf("grads", wfloats + tfloats), splits=splits,
    )


SCRATCH_ORDER = ("xhat", "stats", "dpre", "wpart", "tpart", "tmp", "out")


def scratch_pointers(s: Dict[str, object]):
    """The scratch buffers in the C interfaces' order (``SCRATCH_ORDER``)."""
    return [s[k].data_ptr() for k in SCRATCH_ORDER]


def classic_mlp_bwd(
    packed: Packed, x_enc: torch.Tensor, d_enc: Optional[torch.Tensor], g_out: torch.Tensor,
    input_grads: bool = True, tc_fwd: Optional[torch.Tensor] = None,
    tc_bwd: Optional[torch.Tensor] = None, chain: Optional[Dict[str, object]] = None,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Packed]:
    """Backward of ``classic_mlp_fwd``: given ``g_out [P, 1 + C]``, the
    cotangent of its output, returns ``(dx [P, XE], dd [P, DE] or None,
    d_packed)`` with ``d_packed`` the gradient of every packed weight,
    summed over the points.  With ``input_grads=False`` the kernel skips
    the encodings' cotangents and ``dx`` and ``dd`` are ``None``.

    ``chain`` is what ``classic_mlp_fwd_chain`` kept of the forward on the
    same weights and encodings: the backward starts from it (the kernel's
    ``stored`` route, no forward run again).  Without it the kernel first
    runs the forward that stores the chain, as the JAX kernel recomputes
    its forward.  Both give the same gradients bit for bit.

    CPU tensors run ``classic_mlp_bwd_plain``; CUDA tensors launch the
    kernel (raising on what it does not take): the tensor-core passes of
    K2 at every encoding width, with or without the encodings' cotangents
    (``input_grads=False`` is autograd's call where the encodings need no
    gradient, as on the reuse step), on the operand images ``tc_fwd`` and
    ``tc_bwd`` (``tc_mlp.tc_images(packed, backward=True)``) when given,
    else built here.  ``_build.policy_counts`` records ``"tc"``.  bfloat16
    encodings (and images) run ``compute_dtype="bfloat16"``
    (``classic_mlp_bwd_bf16``), the encodings' cotangents then bfloat16;
    policy ``"tc_bf16"``.
    """
    has_view = "wd_in" in packed
    if has_view != (d_enc is not None):
        raise ValueError(f"{BWD_NAME}: d_enc must be given iff the weights have a view branch")
    device = check_inputs(BWD_NAME, packed, {"x_enc": x_enc, "d_enc": d_enc, "g_out": g_out,
                                             "tc_fwd": tc_fwd, "tc_bwd": tc_bwd})
    dtype = x_enc.dtype
    bf16 = dtype == torch.bfloat16
    tc_mlp.check_images(BWD_NAME, packed, tc_fwd, tc_bwd, dtype)
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
        return classic_mlp_bwd_plain(packed, x_enc, d_enc, g_out, input_grads, chain=chain)
    if chain is not None and (
        "xhat" not in chain or chain["xhat"].shape[1] != n_points
        or chain["xhat"].device != device
    ):
        raise ValueError(f"{BWD_NAME}: chain must be classic_mlp_fwd_chain's on these "
                         f"{n_points} rows on {device}")
    dx = torch.empty_like(x_enc) if input_grads else None
    dd = torch.empty_like(d_enc) if has_view and input_grads else None
    if n_points == 0:
        return dx, dd, {k: torch.zeros_like(v) for k, v in packed.items()}
    de = d_enc.shape[1] if has_view else 0
    fn_name, policy = route(BWD_NAME, bf16)
    kpacked = tc_mlp.pad_packed(packed)
    if tc_fwd is None or tc_bwd is None:
        tc_fwd, tc_bwd = tc_mlp.tc_images(kpacked, backward=True, dtype=dtype)
    s = train_scratch(kpacked, n_points, device, chain)
    fn = getattr(_build.load(BWD_NAME), fn_name)
    err = fn(
        x_enc.data_ptr(), _build.ptr(d_enc), g_out.data_ptr(), _build.ptr(dx), _build.ptr(dd),
        s["grads"].data_ptr(), n_points, xe, de, hidden, colors,
        *weight_pointers(kpacked), *scratch_pointers(s), s["splits"], int(chain is not None),
        _build.ptr(tc_fwd), _build.ptr(tc_bwd), torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check_launch(BWD_NAME, err)
    _build.launch_counts[BWD_NAME] += 1
    _build.policy_counts[(BWD_NAME, policy)] += 1
    return dx, dd, kernel_grads(s["grads"], kpacked, packed)


class ClassicMLPFunction(torch.autograd.Function):
    """``classic_mlp_fwd`` under autograd: forward K1-fwd, backward K1-bwd.
    Arguments ``(images, x_enc, d_enc, *weights)``: ``images`` is ``(tc_fwd,
    tc_bwd)``, operand images built beforehand (``None`` where not), the
    weights in ``PACK_ORDER`` (``None`` for an absent ``wd_in``).  The
    forward keeps the chain (``classic_mlp_fwd_chain``: on the card the
    tile that stores every layer's xhat and statistics, 1.34 GB at the
    reuse step's 131,072 rows, beside the output), and the backward starts
    from it and drops it (``ctx.chain`` is ``None`` after), so the forward
    runs once a step; the JAX kernel recomputes it instead, as VMEM cannot
    hold the chain.  A second backward through a retained graph finds no
    chain and runs the forward again."""

    @staticmethod
    def forward(ctx, images, x_enc, d_enc, *weights):
        ctx.save_for_backward(x_enc, d_enc, *weights)
        ctx.images = images
        out, ctx.chain = classic_mlp_fwd_chain(
            _packed_from_args(weights), x_enc, d_enc, images[0],
            input_grads=any(ctx.needs_input_grad[1:3]))
        return out

    @staticmethod
    def backward(ctx, g_out):
        x_enc, d_enc, *weights = ctx.saved_tensors
        packed = _packed_from_args(weights)
        chain, ctx.chain = ctx.chain, None
        dx, dd, d_packed = classic_mlp_bwd(
            packed, x_enc, d_enc, g_out.contiguous(),
            input_grads=any(ctx.needs_input_grad[1:3]), tc_fwd=ctx.images[0],
            tc_bwd=ctx.images[1], chain=chain,
        )
        return (None, dx, dd, *[d_packed.get(k) for k in PACK_ORDER])
