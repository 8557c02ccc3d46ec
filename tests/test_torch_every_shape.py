"""Every hidden width, colour count and sample count that the JAX kernels
take, held against the JAX package on the CPU.

On the card no kernel of the port refuses these shapes any more: a hidden
width up to 256 runs the smallest instantiated tile that holds it (32, 64,
128, 256) on weights zero-padded to it, with the LayerNorm statistics over
the model's own columns; past 256 the width pads to a multiple of 256 and
each layer runs in column blocks of 256, the rows in device memory
(``csrc/tc_mlp.cuh`` note 11); the per-ray passes take the colours a chunk
at a time and keep their scratch, K4 its fine outputs too, in device
memory.  On the CPU the wrappers run their plain versions, held here, with
inputs from numpy seeds:

* against the JAX package's Pallas kernels in interpret mode (exact
  two-pass LayerNorm statistics): K1-fwd and K1-bwd at hidden 48 and 384
  against ``classic_mlp_pallas`` and its VJP; K2 at 16 colours against
  ``classic_train_grads_pallas``; K3 and K4 at 5 + 300 samples and 16
  colours against ``fine_stage_train_pallas`` and
  ``fine_union_eval_pallas``; K9 at 5 + 300 samples and 16 colours against
  ``mega_train_loss_and_grads`` with its fine t-values held; K5 at hidden
  48 and 384 against ``mip_mlp_pallas`` and its VJP, K6 and K7 at hidden 48
  and 16 colours against ``mip_train_grads_pallas`` and
  ``mip_eval_pallas``.  Outputs and losses rtol 1e-5 (K1-fwd rtol 1e-4,
  atol 1e-5 and K4 rtol 5e-4, atol 1e-4, depth rtol 1e-3: the bounds of
  ``test_torch_kernels.py``, whose kernels sum in another order);
  gradients within 3e-5 of their largest entry (K9's within 5e-5 of the
  largest of them all, the JAX package's own bound for its kernel);
* the kernels' arithmetic at the new widths in plain torch
  (``padded_mlp``): the weights zero-padded as ``tc_mlp.pad_packed`` pads
  them, the LayerNorm statistics over the model's columns as the kernels
  take them (the padded zeros' mu^2 taken out of the variance), past 256 each
  product in column blocks of 256, the products as 3xTF32
  (``tc_mlp.tc_matmul``), against the unpadded float32 plain version at
  the card's tolerances (outputs rtol 1e-4, atol 1e-4; gradients relative
  L2 1e-2), the padded slots of every gradient exactly 0: the padded tile
  at 48 -> 64 and 200 -> 256 and the column blocks at 384 and 512, both
  families;
* ``ClassicNeRF(hidden_size=48)``'s ``render_rays`` (K4's plain version)
  and its fused reuse step (K1 and K3's) against JAX's with JAX's draws;
* the padding and the column-block operand images.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu import ClassicNeRF as JaxNeRF
from nerf_tpu import ClassicNeRFConfig as JaxConfig
from nerf_tpu import MipNeRFConfig as JaxMipConfig
from nerf_tpu import RenderConfig as JaxRender
from nerf_tpu.models import mlp as jmlp
from nerf_tpu.ops.pallas import fused_hier, fused_mega, fused_mip_mlp, fused_mip_train
from nerf_tpu.ops.pallas import fused_mlp, fused_train
from nerf_tpu_torch import ClassicNeRFConfig, MipNeRFConfig, RenderConfig
from nerf_tpu_torch.models.mlp import LAYER_NORM_EPS, ClassicMLP, MipMLP
from nerf_tpu_torch.ops.kernels import (
    _build,
    classic_mlp,
    fine_stage_train,
    mega_train,
    mip_mlp,
    mip_train,
    tc_mlp,
    train_grads,
    union_eval,
)
from nerf_tpu_torch.utils.pth_import import (
    classic_state_dict_from_jax_params,
    mip_state_dict_from_jax_params,
)
from test_torch_mip_kernels import ray_inputs
from test_torch_render import make_models as render_models
from test_torch_train_kernels import fine_inputs, train_inputs
from test_torch_train_reuse import batch_arrays, jax_draws
from test_torch_train_reuse import make_models as reuse_models

OUT_RTOL = 1e-5
GRAD_ATOL = 3e-5  # of the largest entry
K1_TOL = dict(rtol=1e-4, atol=1e-5)
K4_TOL = dict(rtol=5e-4, atol=1e-4)
CARD_TOL = dict(rtol=1e-4, atol=1e-4)
CARD_GRAD_REL_L2 = 1e-2
COLORS = 16
SC, SF = 5, 300


@pytest.fixture(autouse=True)
def exact_ln_stats():
    prev = fused_mlp._LN_STATS
    fused_mlp._LN_STATS = "twopass"
    yield
    fused_mlp._LN_STATS = prev


def quick_jit(fn):
    """``jax.jit`` with XLA's backend optimisation and LLVM's expensive
    passes off: each reference runs once on small shapes, so its compile
    time is its cost."""
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0,
                                         "xla_llvm_disable_expensive_passes": True})


def t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def close_to_largest(got, want, name, atol=GRAD_ATOL):
    want = np.asarray(want)
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(np.asarray(got).reshape(want.shape) / scale, want / scale,
                               rtol=0, atol=atol, err_msg=name)


def packed_close(got, jax_grads, pack):
    want = {k: np.asarray(v) for k, v in pack(jax_grads).items()}
    assert set(got) == set(want)
    for k, w in want.items():
        close_to_largest(got[k].detach().numpy(), w, k)


@functools.lru_cache(maxsize=None)
def classic(hidden, colors=3):
    """A classic model in both packages with the same weights (JAX's init),
    the LayerNorms drawn off the identity from a numpy seed: ``(config, JAX
    parameters, packed port weights)``."""
    kw = dict(hidden_size=hidden, color_outputs=colors)
    params = jax.tree_util.tree_map(np.asarray, JaxNeRF(JaxConfig(**kw)).init(
        jax.random.PRNGKey(hidden)))
    rng = np.random.default_rng(hidden + colors)
    for block in ("block_0", "block_1", "block_2"):
        for layer in params.get(block, []):
            layer["ln"] = {"scale": rng.uniform(0.5, 1.5, size=hidden).astype(np.float32),
                           "bias": rng.uniform(-0.3, 0.3, size=hidden).astype(np.float32)}
    cfg = ClassicNeRFConfig(**kw)
    mlp = ClassicMLP(cfg, device="cpu")
    mlp.load_state_dict(classic_state_dict_from_jax_params(params))
    return cfg, params, classic_mlp.pack_classic_params(mlp.requires_grad_(False))


@functools.lru_cache(maxsize=None)
def mip(hidden, colors=3):
    kw = dict(hidden_size=hidden, num_hidden_layers=3, segmentation_outputs=5,
              color_outputs=colors)
    params = jax.tree_util.tree_map(
        np.asarray, jmlp.init_mip_mlp(jax.random.PRNGKey(hidden), JaxMipConfig(**kw)))
    rng = np.random.default_rng(hidden)
    for layer in params["layers"]:
        layer["ln"] = {"scale": rng.uniform(0.5, 1.5, size=hidden).astype(np.float32),
                       "bias": rng.uniform(-0.3, 0.3, size=hidden).astype(np.float32)}
    cfg = MipNeRFConfig(**kw)
    mlp = MipMLP(cfg, device="cpu")
    mlp.load_state_dict(mip_state_dict_from_jax_params(params))
    return cfg, params, mip_mlp.pack_mip_params(mlp.requires_grad_(False))


def test_the_widths_pad_as_the_kernels_run_them():
    assert [tc_mlp.padded_hidden(h) for h in (1, 16, 32, 48, 64, 100, 200, 256)] == \
        [32, 32, 32, 64, 64, 128, 256, 256]
    assert [tc_mlp.padded_hidden(h) for h in (257, 384, 512, 1000, 1024)] == \
        [512, 512, 512, 1024, 1024]
    assert classic_mlp.HIDDEN_WIDTHS == tc_mlp.TILE_WIDTHS == (32, 64, 128, 256)


# -- the plain versions against the Pallas kernels ----------------------------


@pytest.mark.parametrize("hidden", [48, 384])
def test_k1_plain_matches_pallas_and_its_vjp(hidden):
    """K1-fwd against ``classic_mlp_pallas`` and K1-bwd with the encodings'
    cotangents against its VJP, on 40 rows."""
    cfg, params, packed = classic(hidden)
    rng = np.random.default_rng(hidden)
    x = rng.normal(size=(40, cfg.x_encoding_dim)).astype(np.float32)
    d = rng.normal(size=(40, cfg.d_encoding_dim)).astype(np.float32)
    g_out = rng.normal(size=(40, 1 + cfg.color_outputs)).astype(np.float32)

    def reference(p, x, d, g):
        out, vjp = jax.vjp(lambda p, x, d: fused_mlp.classic_mlp_pallas(p, x, d, interpret=True),
                           p, x, d)
        return out, vjp(g)

    (dens, col), (gp, gx, gd) = quick_jit(reference)(
        params, jnp.asarray(x), jnp.asarray(d),
        (jnp.asarray(g_out[:, :1]), jnp.asarray(g_out[:, 1:])))
    before = dict(_build.launch_counts)
    out = classic_mlp.classic_mlp_fwd(packed, t(x), t(d))
    np.testing.assert_allclose(out[:, :1].numpy(), np.asarray(dens), **K1_TOL)
    np.testing.assert_allclose(out[:, 1:].numpy(), np.asarray(col), **K1_TOL)
    dx, dd, d_packed = classic_mlp.classic_mlp_bwd(packed, t(x), t(d), t(g_out))
    assert dict(_build.launch_counts) == before  # the plain versions launch nothing
    packed_close(d_packed, gp, fused_mlp.pack_classic_params)
    close_to_largest(dx.numpy(), gx, "dx")
    close_to_largest(dd.numpy(), gd, "dd")


def test_k2_plain_matches_pallas_at_16_colours():
    cfg, params, packed = classic(48, COLORS)
    a = train_inputs(cfg, rays=6, s=8, seed=2)
    assert a["pixels"].shape == (6, COLORS)
    loss_r, grads_r = quick_jit(lambda p, *v: fused_train.classic_train_grads_pallas(
        p, *v, 8, loss_weight=0.5, interpret=True))(params, *[jnp.asarray(v) for v in a.values()])
    loss, d_packed = train_grads.classic_train_grads(
        packed, **{k: t(v) for k, v in a.items()}, num_samples=8, loss_weight=0.5)
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=OUT_RTOL)
    packed_close(d_packed, grads_r, fused_mlp.pack_classic_params)


def test_k3_plain_matches_pallas_at_300_fine_samples_and_16_colours():
    cfg, params, packed = classic(48, COLORS)
    a = fine_inputs(cfg, rays=2, sc=SC, sf=SF, seed=3)
    loss_r, grads_r, (gdc_r, gcc_r) = quick_jit(
        lambda p, *v: fused_hier.fine_stage_train_pallas(p, *v, white_background=True,
                                                         loss_weight=0.5, interpret=True))(
        params, *[jnp.asarray(v) for v in a.values()])
    loss, d_packed, (gdc, gcc) = fine_stage_train.fine_stage_train(
        packed, **{k: t(v) for k, v in a.items()}, white_background=True, loss_weight=0.5)
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=OUT_RTOL)
    packed_close(d_packed, grads_r, fused_mlp.pack_classic_params)
    close_to_largest(gdc.numpy(), gdc_r, "g_dens_c")
    close_to_largest(gcc.numpy(), gcc_r, "g_col_c")


def test_k4_plain_matches_pallas_at_300_fine_samples_and_16_colours():
    cfg, params, packed = classic(48, COLORS)
    a = fine_inputs(cfg, rays=2, sc=SC, sf=SF, seed=4)
    a = {"x_enc": a["x_enc"], "d_enc": a["d_enc"][:, 0], "t_coarse": a["t_coarse"],
         "t_fine": a["t_fine"], "dens_c": a["dens_c"], "col_c": a["col_c"], "dnorm": a["dnorm"]}
    ref = quick_jit(lambda p, *v: fused_hier.fine_union_eval_pallas(p, *v, interpret=True))(
        params, *[jnp.asarray(v) for v in a.values()])
    rgb, depth, acc = union_eval.union_eval(packed, **{k: t(v) for k, v in a.items()})
    assert rgb.shape == (2, COLORS)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(ref[0]), **K4_TOL)
    np.testing.assert_allclose(depth.numpy(), np.asarray(ref[1]), rtol=1e-3)
    np.testing.assert_allclose(acc.numpy(), np.asarray(ref[2]), **K4_TOL)


def test_k9_plain_matches_jax_kernel_at_300_fine_samples_and_16_colours():
    """K9 with the JAX kernel's fine t-values held (its resample is held in
    ``test_torch_mega.py``): the loss rtol 1e-5, every gradient within 5e-5
    of the largest of them all."""
    jmodel, params, model = reuse_models(hidden_size=48, color_outputs=COLORS)
    kw = dict(num_coarse_samples=SC, num_fine_samples=SF, near=2.0, far=6.0,
              randomly_sample=True, density_noise_std=1.0, reuse_coarse_in_fine=True)
    b = batch_arrays(n=2, seed=9, colors=COLORS)
    key = jax.random.PRNGKey(9)
    loss_j, grads_j, aux_j = fused_mega.mega_train_loss_and_grads(
        jmodel, params, JaxRender(**kw), {k: jnp.asarray(v) for k, v in b.items()}, key,
        interpret=True, emit_t_fine=True)
    t_fine_j = np.asarray(aux_j["t_fine"])
    batch = {k: t(v) for k, v in b.items()}
    inputs = mega_train.mega_inputs(model, batch, jax_draws(key, JaxRender(**kw), 2))
    with torch.no_grad():
        packed = classic_mlp.pack_classic_params(model.mlp)
    loss_c, loss_f, d_packed, _ = mega_train.mega_train_plain(packed, *inputs, t_fine=t(t_fine_j))
    np.testing.assert_allclose(float(loss_c + loss_f), float(loss_j), rtol=OUT_RTOL)
    want = {k: np.asarray(v) for k, v in fused_mlp.pack_classic_params(grads_j).items()}
    got = np.concatenate([d_packed[k].numpy().ravel() for k in sorted(want)])
    ref = np.concatenate([want[k].ravel() for k in sorted(want)])
    assert np.abs(got - ref).max() < 5e-5 * np.abs(ref).max()


@pytest.mark.parametrize("hidden", [48, 384])
def test_k5_plain_matches_pallas_and_its_vjp(hidden):
    cfg, params, packed = mip(hidden)
    rng = np.random.default_rng(hidden)
    feat = rng.normal(size=(40, cfg.feature_dim)).astype(np.float32)
    g_out = rng.normal(size=(40, cfg.num_outputs)).astype(np.float32)
    layers, c = cfg.num_hidden_layers, cfg.color_outputs

    def reference(p, x, g):
        out, vjp = jax.vjp(lambda p, x: fused_mip_mlp.mip_mlp_pallas(p, x, layers, c,
                                                                     interpret=True), p, x)
        return jnp.concatenate(out, -1), vjp((g[:, :1], g[:, 1:1 + c], g[:, 1 + c:]))

    ref, (gp, gx) = quick_jit(reference)(params, jnp.asarray(feat), jnp.asarray(g_out))
    out = mip_mlp.mip_mlp_fwd(packed, t(feat))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=OUT_RTOL, atol=1e-6)
    dfeat, d_packed = mip_mlp.mip_mlp_bwd(packed, t(feat), t(g_out))
    packed_close(d_packed, gp, fused_mip_mlp.pack_mip_params)
    close_to_largest(dfeat.numpy(), gx, "dfeat")


def test_k6_k7_plain_match_pallas_at_hidden_48_and_16_colours():
    cfg, params, packed = mip(48, COLORS)
    a = ray_inputs(cfg, 4, 15, seed=7)
    a["pixels"] = np.random.default_rng(7).uniform(size=(4, COLORS)).astype(np.float32)
    keys = ("features", "dists", "noise", "pixels", "labels")

    def reference(p, features, dists, noise, pixels, labels, t_mids):
        train = fused_mip_train.mip_train_grads_pallas(
            p, features, dists, noise, pixels, labels, 3, color_outputs=COLORS,
            seg_weight=0.1, interpret=True)
        render = fused_mip_train.mip_eval_pallas(
            p, features, dists, t_mids, noise, 3, color_outputs=COLORS, white_background=True,
            interpret=True)
        return train, render

    (rgb_r, seg_r, grads_r), render_r = quick_jit(reference)(
        params, *[jnp.asarray(a[k]) for k in keys], jnp.asarray(a["t_mids"]))
    rgb, seg, d_packed = mip_train.mip_train_grads(
        packed, *[t(a[k]) for k in keys], color_outputs=COLORS, seg_weight=0.1)
    np.testing.assert_allclose(float(rgb), float(rgb_r), rtol=OUT_RTOL)
    np.testing.assert_allclose(float(seg), float(seg_r), rtol=OUT_RTOL)
    packed_close(d_packed, grads_r, fused_mip_mlp.pack_mip_params)
    got = mip_train.mip_eval(packed, t(a["features"]), t(a["dists"]), t(a["t_mids"]),
                             t(a["noise"]), COLORS, True)
    for name, g, r in zip(("rgb", "seg", "depth", "acc"), got, render_r):
        np.testing.assert_allclose(g.numpy(), np.asarray(r).reshape(tuple(g.shape)),
                                   rtol=OUT_RTOL, atol=1e-5, err_msg=name)


# -- the kernels' arithmetic at the new widths, in plain torch -----------------


def block_matmul(matmul, hp):
    """``a @ w`` with the output columns in blocks of 256 past 256 (each
    block its own product, as the kernels' column blocks)."""
    if hp <= tc_mlp.COL_BLOCK:
        return matmul
    return lambda a, w: torch.cat([matmul(a, w[:, c:c + tc_mlp.COL_BLOCK])
                                   for c in range(0, hp, tc_mlp.COL_BLOCK)], -1)


def masked_layer_norm(a, h, g, beta):
    """LayerNorm with its statistics over the first h columns, applied to
    every column, as the kernels' epilogue takes them on a padded tile: the
    padded columns are exactly 0, so the mean is the sum of every column
    over h, and the two-pass variance over every column less the (padded)
    mu^2 the zeros added, over h (``csrc/classic_mlp.cuh``'s
    ``layer_epilogue``)."""
    assert not bool(a[:, h:].detach().any())
    mu = a.sum(-1, keepdim=True) / h
    padded = a.shape[-1] - h
    var = (((a - mu) ** 2).sum(-1, keepdim=True) - padded * mu * mu).clamp_min(0.0) / h
    # The backward as the kernels take it: the statistics' derivatives over
    # the model's columns only (layer_bwd's means over h, the padded dpre 0).
    exact = ((a[:, :h] - a[:, :h].mean(-1, keepdim=True)) ** 2).mean(-1, keepdim=True)
    var = exact + (var - exact).detach()
    mu = a[:, :h].mean(-1, keepdim=True) + (mu - a[:, :h].mean(-1, keepdim=True)).detach()
    return (a - mu) * torch.rsqrt(var + LAYER_NORM_EPS) * g + beta


def padded_mlp(family, kp, h, x, d, matmul):
    """The network as the kernels run it at width h: on ``kp``
    (``tc_mlp.pad_packed`` of the weights) with the statistics over h
    columns and, past 256, the products in column blocks."""
    mm = block_matmul(matmul, kp["b"].shape[-1])
    if family == "mip":
        act = x
        for i in range(kp["b"].shape[0]):
            w = kp["w_in"] if i == 0 else kp["whh"][i - 1]
            act = torch.relu(masked_layer_norm(mm(act, w) + kp["b"][i], h, kp["g"][i],
                                               kp["beta"][i]))
        return act @ kp["w_out"] + kp["b_out"]

    def layer(i, pre):
        return masked_layer_norm(torch.relu(pre + kp["b"][i]), h, kp["g"][i], kp["beta"][i])

    whh = kp["whh"]
    act = layer(0, mm(x, kp["w0"]))
    for i in (1, 2, 3):
        act = layer(i, mm(act, whh[i - 1]))
    act = layer(4, mm(act, whh[3]) + mm(x, kp["wx"]))
    for i in (5, 6, 7):
        act = layer(i, mm(act, whh[i - 1]))
    density = act @ kp["w_dens"] + kp["b_dens"]
    act = layer(8, mm(act, whh[7]) + mm(d, kp["wd_in"]))
    act = layer(9, mm(act, whh[8]))
    return torch.cat([density, act @ kp["w_col"] + kp["b_col"]], -1)


def full_width_weights(family, hidden):
    """Random weights of a family at a width, the LayerNorms off the
    identity (numpy seed), and 96 rows of inputs away from nothing in
    particular: ``(packed, x, d)``."""
    gen = torch.Generator().manual_seed(hidden)
    if family == "mip":
        mlp = MipMLP(MipNeRFConfig(hidden_size=hidden, num_hidden_layers=4), generator=gen,
                     device="cpu")
    else:
        mlp = ClassicMLP(ClassicNeRFConfig(hidden_size=hidden), generator=gen, device="cpu")
    rng = np.random.default_rng(hidden)
    with torch.no_grad():
        for m in mlp.modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.weight.copy_(t(rng.uniform(0.5, 1.5, m.weight.shape).astype(np.float32)))
                m.bias.copy_(t(rng.uniform(-0.3, 0.3, m.bias.shape).astype(np.float32)))
    mlp.requires_grad_(False)
    if family == "mip":
        packed = mip_mlp.pack_mip_params(mlp)
        return packed, t(rng.normal(size=(96, packed["w_in"].shape[0])).astype(np.float32)), None
    packed = classic_mlp.pack_classic_params(mlp)
    return (packed, t(rng.normal(size=(96, packed["w0"].shape[0])).astype(np.float32)),
            t(rng.normal(size=(96, packed["wd_in"].shape[0])).astype(np.float32)))


def rel_l2(got, want) -> float:
    got, want = got.double().ravel(), want.double().ravel()
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("family", ["classic", "mip"])
@pytest.mark.parametrize("hidden", [48, 200, 384, 512])
def test_padded_and_column_block_arithmetic_meets_the_card_tolerance(family, hidden):
    """The padded tile (48 -> 64, 200 -> 256) and the column blocks (384 ->
    512, 512) with 3xTF32 products against the unpadded float32 plain
    version: outputs rtol 1e-4, atol 1e-4; the weights' gradients and the
    inputs' cotangents relative L2 1e-2; every padded slot of the padded
    weights' gradients exactly 0 (what the wrappers drop)."""
    packed, x, d = full_width_weights(family, hidden)
    kp = tc_mlp.pad_packed(packed)
    hp = tc_mlp.padded_hidden(hidden)
    assert kp["b"].shape[-1] == hp and (hp == hidden) == (hidden == 512)
    if family == "mip":
        ref = mip_mlp.mip_mlp_fwd_plain(packed, x)
    else:
        ref = classic_mlp.classic_mlp_fwd_plain(packed, x, d)
    with torch.enable_grad():
        leaves = {k: v.clone().requires_grad_(True) for k, v in kp.items()}
        xs = x.clone().requires_grad_(True)
        got = padded_mlp(family, leaves, hidden, xs, d, tc_mlp.tc_matmul_autograd)
        g_out = torch.cos(ref)
        grads = torch.autograd.grad(got, [xs, *leaves.values()], g_out)
    torch.testing.assert_close(got.detach(), ref, **CARD_TOL)
    if family == "mip":
        rdx, rgrads = mip_mlp.mip_mlp_bwd_plain(packed, x, g_out)
    else:
        rdx, _, rgrads = classic_mlp.classic_mlp_bwd_plain(packed, x, d, g_out)
    assert rel_l2(grads[0], rdx) <= CARD_GRAD_REL_L2
    padded = dict(zip(leaves, grads[1:]))
    cut = tc_mlp.unpad_grads(padded, packed)
    for k, r in rgrads.items():
        assert cut[k].shape == r.shape, k
        assert rel_l2(cut[k], r) <= CARD_GRAD_REL_L2, k
        kept = torch.zeros_like(padded[k], dtype=torch.bool)
        kept[tuple(slice(0, n) for n in r.shape)] = True
        assert torch.count_nonzero(padded[k][~kept]) == 0, k


# -- the models at hidden 48 against JAX ----------------------------------------


def test_render_rays_and_reuse_step_at_hidden_48_match_jax():
    """``ClassicNeRF(hidden_size=48)``: ``render_rays`` through K4's plain
    version against JAX's fused render (the bounds of
    ``test_torch_render.py``), and the fused reuse step (K1 and K3's plain
    versions) against JAX's ``reuse_train_loss_and_grads`` with JAX's draws
    (``test_torch_train_reuse.py``'s: loss rtol 1e-5, gradients within 2e-4
    of their largest entry)."""
    jmodel, params, model = render_models(True, hidden_size=48)
    rng = np.random.default_rng(0)
    o = (rng.normal(size=(8, 3)) * 0.5).astype(np.float32)
    dirs = rng.normal(size=(8, 3)).astype(np.float32)
    kw = dict(num_coarse_samples=16, num_fine_samples=24, near=2.0, far=6.0,
              randomly_sample=False, density_noise_std=0.0)
    ref = quick_jit(lambda p, o, d: jmodel.render_rays(p, None, o, d, JaxRender(**kw),
                                                       fused_eval=True))(
        params, jnp.asarray(o), jnp.asarray(dirs))
    with torch.no_grad():
        out = model.render_rays(t(o), t(dirs), RenderConfig(**kw), fused_eval=True)
    np.testing.assert_allclose(out.rgb.numpy(), np.asarray(ref.rgb), **K4_TOL)
    np.testing.assert_allclose(out.acc.numpy(), np.asarray(ref.acc), **K4_TOL)
    np.testing.assert_allclose(out.depth.numpy(), np.asarray(ref.depth), rtol=1e-3, atol=1e-4)

    jmodel, params, model = reuse_models(hidden_size=48)
    kw = dict(num_coarse_samples=8, num_fine_samples=8, near=2.0, far=6.0,
              randomly_sample=True, density_noise_std=1.0, reuse_coarse_in_fine=True)
    b = batch_arrays(n=8, seed=4)
    key = jax.random.PRNGKey(4)
    loss_r, grads_r, _ = quick_jit(lambda p, bb, k: fused_hier.reuse_train_loss_and_grads(
        jmodel, p, JaxRender(**kw), bb, k))(params, {k: jnp.asarray(v) for k, v in b.items()},
                                            key)
    loss, grads, _ = fine_stage_train.reuse_train_loss_and_grads(
        model, RenderConfig(**kw), {k: t(v) for k, v in b.items()},
        jax_draws(key, JaxRender(**kw), 8))
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=OUT_RTOL)
    sd = classic_state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, grads_r))
    assert set(grads) == {f"mlp.{k}" for k in sd}
    for k, want in sd.items():
        close_to_largest(grads[f"mlp.{k}"].numpy(), want.numpy(), k, atol=2e-4)


# -- the padding and the operand images -----------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_column_block_images_are_the_blocks_images(dtype):
    """Past 256 outputs a slab's image is its column blocks' images one
    after another, so the kernels find block cb at cb times a 256-row
    image; the sizes ``tc_images`` builds are ``image_numels``' at the
    padded width, and ``check_images`` takes them."""
    packed, _, _ = full_width_weights("classic", 384)
    kp = tc_mlp.pad_packed(packed)
    w = kp["whh"][2].t()
    img = tc_mlp.operand_image_blocks(w, dtype)
    one = tc_mlp.operand_image(w[:256], dtype).numel()
    assert img.numel() == 2 * one
    assert torch.equal(img[one:], tc_mlp.operand_image(w[256:], dtype))
    fwd, bwd = tc_mlp.tc_images(packed, backward=True, dtype=dtype)
    assert (fwd.numel(), bwd.numel()) == tc_mlp.image_numels(packed, dtype)
    tc_mlp.check_images("k", packed, fwd, bwd, dtype)


def test_pad_packed_keeps_instantiated_widths_and_zero_pads_the_rest():
    packed, _, _ = full_width_weights("classic", 48)
    kp = tc_mlp.pad_packed(packed)
    assert tc_mlp.pad_packed(kp) is kp  # 64 is a tile's width
    assert kp["whh"].shape[1:] == (64, 64) and kp["w_col"].shape[0] == 64
    assert kp["b_col"] is packed["b_col"] or torch.equal(kp["b_col"], packed["b_col"])
    for k, v in packed.items():
        assert torch.equal(kp[k][tuple(slice(0, n) for n in v.shape)], v), k
    assert float(kp["g"][:, 48:].abs().sum()) == 0.0
    assert tc_mlp.unpad_grads(kp, packed).keys() == packed.keys()
    assert math.prod(tc_mlp.unpad_grads(kp, packed)["whh"].shape) == packed["whh"].numel()


# -- the card checks' references --------------------------------------------------


def test_plain_references_take_a_matmul_and_the_kernel_steps_fine_samples():
    """``chip_smoke.py`` phase 21's bf16 step references: the plain reuse
    step under ``testing.plain_versions(matmul)`` hands ``matmul`` to every
    plain version it runs (float64 sums agree with the default to 1e-5),
    and under ``chip_smoke.fixed_fine_samples(t)`` its fine stage takes
    ``t`` instead of resampling, restored after the block."""
    import chip_smoke
    from nerf_tpu_torch import ClassicNeRF
    from nerf_tpu_torch.ops import sampling
    from nerf_tpu_torch.testing import bf16_step_reference

    model = ClassicNeRF(ClassicNeRFConfig(hidden_size=48, color_outputs=COLORS),
                        generator=torch.Generator().manual_seed(0), device="cpu")
    render = RenderConfig(num_coarse_samples=8, num_fine_samples=12, near=2.0, far=6.0,
                          randomly_sample=True, density_noise_std=1.0,
                          reuse_coarse_in_fine=True)
    batch = {k: t(v) for k, v in batch_arrays(n=6, seed=3, colors=COLORS).items()}
    draws = sampling.draw_step(torch.Generator().manual_seed(3), render, 6, "cpu")
    calls = []

    def float64_sums(a, b):
        calls.append(a.shape)
        return (a.double() @ b.double()).float()

    loss, grads = bf16_step_reference(model, render, batch, draws)
    loss64, grads64 = bf16_step_reference(model, render, batch, draws, matmul=float64_sums)
    assert calls
    np.testing.assert_allclose(float(loss64), float(loss), rtol=1e-5)
    assert grads64.keys() == grads.keys()
    for k in grads:
        close_to_largest(grads64[k].numpy(), grads[k].numpy(), k, atol=1e-5)

    t_fine = torch.sort(torch.rand(6, 12, generator=torch.Generator().manual_seed(5)) * 4 + 2,
                        -1).values
    seen = []
    original = fine_stage_train.fine_stage_train_plain

    def spy(*args, **kwargs):
        seen.append(args[4])
        return original(*args, **kwargs)

    fine_stage_train.fine_stage_train_plain = spy
    try:
        with chip_smoke.fixed_fine_samples(t_fine):
            bf16_step_reference(model, render, batch, draws)
    finally:
        fine_stage_train.fine_stage_train_plain = original
    assert len(seen) == 1 and torch.equal(seen[0], t_fine)
    assert sampling.sample_pdf is not None and "lambda" not in sampling.sample_pdf.__name__
