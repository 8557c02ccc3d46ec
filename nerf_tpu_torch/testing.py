"""References of the bf16 checks in ``chip_smoke.py`` and
``tests/test_torch_cuda.py``, on any device: the plain path of both model
families (a model's frame and train steps with the kernel wrappers of the
classic main path, K1-fwd, K1-bwd through ``ClassicMLPFunction``, K2, K3,
K4, and of the mip family, K5-fwd, K6, K7, replaced by their plain
versions), the mip head's products against the float64 products of
their rounded and unrounded operands, the bf16 products summed in
float64 (how far the plain bf16 version moves under another order of its
sums), and the classic checks' inputs: each row's distance from the
ReLU kinks (``kink_margin``) and a loss's output cotangents
(``loss_cotangent``)."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from nerf_tpu_torch.ops.kernels import (
    _build,
    classic_mlp,
    fine_stage_train,
    mip_mlp,
    mip_train,
    tc_mlp,
    train_grads,
    union_eval,
)
from nerf_tpu_torch.train import make_fused_loss_and_grads


@contextlib.contextmanager
def plain_versions(matmul=None):
    """The classic main path's five wrappers and the mip family's three
    replaced by their plain versions (the same arguments; bfloat16
    encodings or features run the bf16 emulation; the mip forward under
    autograd differentiates its plain version, so K5-bwd is not reached),
    each given ``matmul`` (``Bf16Float64Sums.apply``: the plain path with
    its sums in float64).  Raises if a kernel launched inside: a caller
    that reached a wrapper by another name would compare the kernel with
    itself.  The launch counts outside are kept."""
    k1 = classic_mlp.classic_mlp_fwd_plain
    k2 = train_grads.classic_train_grads_plain
    k3 = fine_stage_train.fine_stage_train_plain
    k4 = union_eval.union_eval_plain
    k5 = mip_mlp.mip_mlp_fwd_plain
    k6 = mip_train.mip_train_grads_plain
    k7 = mip_train.mip_eval_plain

    def fwd(packed, x, d=None, *images):
        return k1(packed, x, d, matmul=matmul)

    patches = (
        (classic_mlp, "classic_mlp_fwd", fwd),
        (fine_stage_train, "classic_mlp_fwd", fwd),
        (union_eval, "union_eval", lambda *args, tc_fwd=None: k4(*args, matmul=matmul)),
        (fine_stage_train, "fine_stage_train",
         lambda *args, tc_fwd=None, tc_bwd=None: k3(*args, matmul=matmul)),
        (train_grads, "classic_train_grads", lambda *args, **kwargs: k2(*args, **kwargs,
                                                                        matmul=matmul)),
        (mip_mlp, "mip_mlp_fwd", lambda packed, x, tc_fwd=None: k5(packed, x, matmul=matmul)),
        (mip_train, "mip_train_grads",
         lambda *args, tc_fwd=None, tc_bwd=None: k6(*args, matmul=matmul)),
        (mip_train, "mip_eval", lambda *args, tc_fwd=None: k7(*args, matmul=matmul)),
    )
    originals = [(m, n, getattr(m, n)) for m, n, _ in patches]
    counts = dict(_build.launch_counts)
    _build.launch_counts.clear()
    for module, name, fn in patches:
        setattr(module, name, fn)
    try:
        yield
    finally:
        for module, name, fn in originals:
            setattr(module, name, fn)
        launched = dict(_build.launch_counts)
        _build.launch_counts.clear()
        _build.launch_counts.update(counts)
    if launched:
        raise RuntimeError(f"the plain path launched kernels: {launched}")


def bf16_step_reference(model, render, batch, draws, seg_weight: float = 0.0, matmul=None):
    """The plain step's loss and gradients (``make_fused_loss_and_grads``
    under ``plain_versions(matmul)``)."""
    with plain_versions(matmul):
        loss, grads, _ = make_fused_loss_and_grads(model, render, seg_weight)(batch, draws)
    return loss, grads


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.double().ravel(), ref.double().ravel()
    return float((got - ref).norm() / ref.norm())


def mip_head_rounding(packed, x: torch.Tensor, g_out: torch.Tensor) -> dict:
    """The bf16 mip head held directly, on the card: for K5-fwd's outputs
    (``head_wide``), K5-bwd's last LayerNorm beta gradient (the masked
    column sums of ``head_dh``'s input cotangent) and the head's dW
    (``wgrad``), ``(relative L2 from the float64 product of the rounded
    operands, from the unrounded one)``, on bfloat16 features ``x`` and
    output cotangents ``g_out``.  The last layer's output comes from
    K5-fwd with an identity head, which returns it rounded, exactly; the
    first entry, ``"h"``, is 0 where that output is bf16-exact."""
    r = tc_mlp.bf16_round
    hidden = packed["w_out"].shape[0]
    identity = {**packed, "w_out": torch.eye(hidden, device=x.device),
                "b_out": torch.zeros(hidden, device=x.device)}
    h = mip_mlp.mip_mlp_fwd(identity, x)
    out = {"h": float((h - r(h)).abs().max())}
    h = h.double()
    w, b, rw = packed["w_out"].double(), packed["b_out"].double(), r(packed["w_out"]).double()
    g, rg = g_out.double(), r(g_out).double()
    _, d_packed = mip_mlp.mip_mlp_bwd(packed, x, g_out, input_grads=False)
    mask = (h > 0).double()  # the last layer's ReLU mask, rows away from its kinks
    for name, got, rounded, unrounded in (
            ("head_wide", mip_mlp.mip_mlp_fwd(packed, x), h @ rw + b, h @ w + b),
            ("head_dh", d_packed["beta"][-1], (mask * (rg @ rw.t())).sum(0),
             (mask * (g @ w.t())).sum(0)),
            ("wgrad", d_packed["w_out"], h.t() @ rg, h.t() @ g)):
        out[name] = (rel_l2(got, rounded), rel_l2(got, unrounded))
    return out


class Bf16Float64Sums(torch.autograd.Function):
    """``tc_mlp.bf16_matmul_autograd`` with the products summed in float64:
    the same operands and cotangents rounded to bfloat16, the sums in
    another order and precision.  A plain bf16 version run with it as its
    ``matmul`` shows how far the bf16 roundings alone move a result when
    only the sums change."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        r = tc_mlp.bf16_round
        return (r(a).double() @ r(b).double()).float()

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        r = tc_mlp.bf16_round
        g = r(g).double()
        return (g @ r(b).double().t()).float(), (r(a).double().t() @ g).float()


def kink_margin(packed, x_enc, d_enc, matmul=torch.matmul):
    """Per row, the smallest |ReLU input| of the plain forward
    (``classic_mlp_fwd_plain``'s layers; ``matmul`` its products)."""
    whh, margins = packed["whh"], []

    def layer(i, pre):
        a = pre + packed["b"][i]
        margins.append(a.abs().amin(-1))
        return F.layer_norm(torch.relu(a), a.shape[-1:], packed["g"][i], packed["beta"][i], 1e-5)

    h = layer(0, matmul(x_enc, packed["w0"]))
    for i in (1, 2, 3):
        h = layer(i, matmul(h, whh[i - 1]))
    h = layer(4, matmul(h, whh[3]) + matmul(x_enc, packed["wx"]))
    for i in (5, 6, 7):
        h = layer(i, matmul(h, whh[i - 1]))
    if "wd_in" in packed:
        layer(9, matmul(layer(8, matmul(h, whh[7]) + matmul(d_enc, packed["wd_in"])), whh[8]))
    return torch.stack(margins).amin(0)


def loss_cotangent(packed, x, d) -> torch.Tensor:
    """K1's output cotangents under the bf16 objective of the JAX package's
    ``tests/test_pallas.py``, mean(density^2) + mean(sin(color)), at the
    plain forward."""
    out = classic_mlp.classic_mlp_fwd_plain(packed, x, d)
    n, c = out.shape[0], out.shape[1] - 1
    return torch.cat([2 * out[:, :1] / n, torch.cos(out[:, 1:]) / (n * c)], -1)
