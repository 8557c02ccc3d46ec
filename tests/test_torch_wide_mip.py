"""The mip kernels at the shapes past their old limits, held against the JAX
package on the CPU.

On the card K5-fwd, K5-bwd, K6 and K7 stream the IPE features through their
one tensor-core tile a k-chunk at a time (``csrc/tc_mlp.cuh``, note 9), so
every feature width runs it; the weight-gradient pass takes its products in
groups (any layer count), the head's input cotangent stages its outputs a
chunk at a time (any head width), and the per-ray passes keep a long ray's
scratch in device memory (any number of rows).  On the CPU the wrappers run
their plain versions, held here, with inputs from numpy seeds:

* at hidden 32 against the JAX package's Pallas kernels in interpret mode
  (exact two-pass LayerNorm statistics), as ``test_torch_mip_kernels.py``
  holds them (outputs and losses rtol 1e-5; gradients within 3e-5 of their
  largest entry, the JAX package's bound for its mip kernels): K5-fwd and
  K5-bwd, with and without the features' cotangent, against
  ``mip_mlp_pallas`` and its VJP at 144 and 600 features (``encoding_size``
  48 and 200), and at 12 hidden layers with a 300-wide head
  (``segmentation_outputs=296``); K6 and K7 against
  ``mip_train_grads_pallas`` and ``mip_eval_pallas`` at 600 features with
  the 300-wide head;
* at 1100 interval rows a ray, which JAX's K6 and K7 do not take (their
  tiles hold whole rays of at most 512 rows: ``_pick_tile``), K6's and
  K7's plain versions against the same objective and outputs composed from
  JAX's ``mip_mlp_pallas`` and its ``ops/compositing.py`` under
  ``jax.value_and_grad``;
* ``MipNeRF.render_rays`` (K7's plain version) and the fused mip step (K6's)
  at ``encoding_size=48`` (144 features) against JAX's with JAX's draws, as
  ``test_torch_mip_model.py`` holds them;
* at hidden 256 the card's tolerances, at 144 and 600 features, at 12
  layers with the 300-wide head, and at 1100 rows: the plain versions with
  their products emulated as 3xTF32 (``tc_mlp.tc_matmul``) against their
  float32 selves (K5-fwd and K7 rtol 1e-4, atol 1e-4; gradients within
  relative L2 1e-2 and 1e-4 of their largest entry; losses rtol 1e-4, as
  ``test_torch_mip_tc.py``), and with the bf16 products
  (``compute_dtype="bfloat16"``) against the same roundings summed in
  float64 (``testing.Bf16Float64Sums``) at the card's bf16 bounds (relative
  L2 1e-2 for outputs and losses, 2e-2 for gradients) and against float32
  at the JAX package's own bf16 bound (rtol 0.1, atol 0.15);
* the mip wrappers' checks refuse only a single layer (every hidden width
  runs since the hidden widths' slice), and no mip library exports a tile
  plan.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu import MipNeRF as JaxMipNeRF
from nerf_tpu import MipNeRFConfig as JaxMipConfig
from nerf_tpu import RenderConfig as JaxRender
from nerf_tpu.models import mlp as jmlp
from nerf_tpu.ops import compositing as jcomp
from nerf_tpu.ops import sampling as jsamp
from nerf_tpu.ops.pallas import fused_mip_mlp, fused_mip_train, fused_mlp
from nerf_tpu.ops.pallas import fused_train as jfused_train
from nerf_tpu_torch import MipNeRF, MipNeRFConfig, RenderConfig
from nerf_tpu_torch.models.mlp import MipMLP
from nerf_tpu_torch.ops import sampling
from nerf_tpu_torch.ops.kernels import _build, mip_mlp, mip_train, tc_mlp
from nerf_tpu_torch.ops.kernels.classic_mlp import route
from nerf_tpu_torch.testing import Bf16Float64Sums
from nerf_tpu_torch.train import make_fused_loss_and_grads
from nerf_tpu_torch.utils.pth_import import (
    jax_params_from_mip_state_dict,
    mip_state_dict_from_jax_params,
)
from test_torch_cuda import mip_rows_away_from_kinks
from test_torch_mip_kernels import assert_packed_close, ray_inputs, t

OUT_RTOL = 1e-5
GRAD_ATOL = 3e-5  # of the largest entry: the JAX package's bound for its mip kernels
CARD_TOL = dict(rtol=1e-4, atol=1e-4)  # K5-fwd's and K7's on the card
CARD_GRAD_REL_L2 = 1e-2
CARD_GRAD_ATOL = 1e-4  # of the largest entry
CARD_LOSS_RTOL = 1e-4
BF16_FWD, BF16_GRAD = 1e-2, 2e-2  # the card's bf16 bounds, relative L2
JAX_BF16 = dict(rtol=0.1, atol=0.15)
# The feature widths past the mip tensor-core tile's old 132 and the SIMT
# tile's old 588: encoding_size 48 and 200.
FEATURES = {144: 48, 600: 200}
# 12 hidden layers (13 weight products) and a 300-wide head (1 + 3 + 296).
DEEP_WIDE = dict(num_hidden_layers=12, segmentation_outputs=296)
LONG_ROWS = 1100


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


@functools.lru_cache(maxsize=None)
def small_model(seed=0, **overrides):
    """A hidden-32 mip MLP in both packages, the same weights (JAX's init
    from a seed, the LayerNorms drawn off the identity from a numpy seed):
    ``(config, JAX parameters, packed port weights)``."""
    kw = {**dict(hidden_size=32, num_hidden_layers=3, segmentation_outputs=5), **overrides}
    params = jax.tree_util.tree_map(
        np.asarray, jmlp.init_mip_mlp(jax.random.PRNGKey(seed), JaxMipConfig(**kw)))
    rng = np.random.default_rng(seed)
    for layer in params["layers"]:
        layer["ln"] = {"scale": rng.uniform(0.5, 1.5, size=32).astype(np.float32),
                       "bias": rng.uniform(-0.3, 0.3, size=32).astype(np.float32)}
    cfg = MipNeRFConfig(**kw)
    mlp = MipMLP(cfg, device="cpu")
    mlp.load_state_dict(mip_state_dict_from_jax_params(params))
    return cfg, params, mip_mlp.pack_mip_params(mlp.requires_grad_(False))


TRAIN_KEYS = ("features", "dists", "noise", "pixels", "labels")


# -- the plain versions against the Pallas kernels, hidden 32 ---------------


def check_k5(cfg, params, packed, seed):
    """K5-fwd, and K5-bwd with and without the features' cotangent, against
    ``mip_mlp_pallas`` and its VJP on 100 rows."""
    rng = np.random.default_rng(seed)
    feat = rng.normal(size=(100, cfg.feature_dim)).astype(np.float32)
    g_out = rng.normal(size=(100, cfg.num_outputs)).astype(np.float32)
    layers, c = cfg.num_hidden_layers, cfg.color_outputs

    def reference(p, x, g):
        out, vjp = jax.vjp(lambda p, x: fused_mip_mlp.mip_mlp_pallas(p, x, layers, c,
                                                                     interpret=True), p, x)
        return jnp.concatenate(out, -1), vjp((g[:, :1], g[:, 1:1 + c], g[:, 1 + c:]))

    ref, (gp, gx) = quick_jit(reference)(params, jnp.asarray(feat), jnp.asarray(g_out))
    before = dict(_build.launch_counts)
    out = mip_mlp.mip_mlp_fwd(packed, t(feat))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=OUT_RTOL, atol=1e-6)
    dfeat, d_packed = mip_mlp.mip_mlp_bwd(packed, t(feat), t(g_out))
    assert dict(_build.launch_counts) == before  # the plain versions launch nothing
    assert_packed_close(d_packed, gp)
    scale = np.abs(np.asarray(gx)).max()
    np.testing.assert_allclose(dfeat.numpy() / scale, np.asarray(gx) / scale, atol=GRAD_ATOL)
    dfeat, d_packed = mip_mlp.mip_mlp_bwd(packed, t(feat), t(g_out), input_grads=False)
    assert dfeat is None
    assert_packed_close(d_packed, gp)


def check_k6_k7(cfg, params, packed, seed):
    """K6 (seg weight 0.1) and K7 (noise, white background) against
    ``mip_train_grads_pallas`` and ``mip_eval_pallas`` on 8 rays of 15
    interval rows."""
    a = ray_inputs(cfg, 8, 15, seed=seed)
    layers, c = cfg.num_hidden_layers, cfg.color_outputs

    def reference(p, features, dists, noise, pixels, labels, t_mids):
        train = fused_mip_train.mip_train_grads_pallas(
            p, features, dists, noise, pixels, labels, layers, color_outputs=c,
            seg_weight=0.1, interpret=True)
        render = fused_mip_train.mip_eval_pallas(
            p, features, dists, t_mids, noise, layers, color_outputs=c, white_background=True,
            interpret=True)
        return train, render

    (rgb_r, seg_r, grads_r), render_r = quick_jit(reference)(
        params, *[jnp.asarray(a[k]) for k in TRAIN_KEYS], jnp.asarray(a["t_mids"]))
    rgb, seg, d_packed = mip_train.mip_train_grads(
        packed, *[t(a[k]) for k in TRAIN_KEYS], color_outputs=c, seg_weight=0.1)
    np.testing.assert_allclose(float(rgb), float(rgb_r), rtol=OUT_RTOL)
    np.testing.assert_allclose(float(seg), float(seg_r), rtol=OUT_RTOL)
    assert_packed_close(d_packed, grads_r)
    got = mip_train.mip_eval(packed, t(a["features"]), t(a["dists"]), t(a["t_mids"]),
                             t(a["noise"]), c, True)
    for name, g, r in zip(("rgb", "seg", "depth", "acc"), got, render_r):
        assert tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=OUT_RTOL, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("features", sorted(FEATURES))
def test_k5_plain_matches_pallas_and_its_vjp_at_wide_features(features):
    cfg, params, packed = small_model(features, encoding_size=FEATURES[features],
                                      num_hidden_layers=2)
    assert cfg.feature_dim == features
    check_k5(cfg, params, packed, seed=features)


def test_k6_k7_plain_match_pallas_at_600_features_and_a_300_wide_head():
    cfg, params, packed = small_model(6, encoding_size=FEATURES[600], num_hidden_layers=2,
                                      segmentation_outputs=DEEP_WIDE["segmentation_outputs"])
    assert (cfg.feature_dim, cfg.num_outputs) == (600, 300)
    check_k6_k7(cfg, params, packed, seed=6)


def test_k5_plain_matches_pallas_at_12_layers_and_a_300_wide_head():
    cfg, params, packed = small_model(12, **DEEP_WIDE)
    assert (cfg.num_hidden_layers, cfg.num_outputs) == (12, 300)
    check_k5(cfg, params, packed, seed=12)


def test_k6_k7_plain_match_jax_at_1100_rows():
    """Rays of 1100 interval rows: JAX's fused kernels refuse them (a tile
    holds whole rays of at most 512 rows), so the reference is JAX's K5
    (``mip_mlp_pallas``) with JAX's compositing, the objective under
    ``jax.value_and_grad`` as ``mip_train_grads_pallas`` defines it."""
    cfg, params, packed = small_model(2, num_hidden_layers=2)
    a = ray_inputs(cfg, 2, LONG_ROWS, seed=11)
    with pytest.raises(ValueError, match="cannot tile"):
        jfused_train._pick_tile(2 * LONG_ROWS, LONG_ROWS)
    layers, c = cfg.num_hidden_layers, cfg.color_outputs

    def outputs(p, features):
        return jnp.concatenate(
            fused_mip_mlp.mip_mlp_pallas(p, features, layers, c, interpret=True), -1)

    def reference(p, features, dists, noise, pixels, labels, t_mids):
        def objective(p):
            out = outputs(p, features)
            w = jcomp.weights_from_density(out[..., :1] + noise[..., None], dists)
            rgb = jcomp.composite_rgb(w, out[..., 1:1 + c])
            rgb_loss = jnp.mean((rgb - pixels) ** 2)
            seg = jcomp.composite_segmentation(w, out[..., 1 + c:])
            seg_loss = -jnp.mean(jnp.take_along_axis(seg, labels[:, None], axis=-1))
            return rgb_loss + 0.1 * seg_loss, (rgb_loss, seg_loss, out, w)

        (_, (rgb_loss, seg_loss, out, w)), grads = jax.value_and_grad(
            objective, has_aux=True)(p)
        render = (jcomp.composite_rgb(w, out[..., 1:1 + c]),
                  jcomp.composite_segmentation(w, out[..., 1 + c:]),
                  jcomp.composite_depth(w, t_mids), jcomp.composite_acc(w))
        return rgb_loss, seg_loss, grads, render

    rgb_r, seg_r, grads_r, render_r = quick_jit(reference)(
        params, *[jnp.asarray(a[k]) for k in TRAIN_KEYS], jnp.asarray(a["t_mids"]))
    rgb, seg, d_packed = mip_train.mip_train_grads(
        packed, *[t(a[k]) for k in TRAIN_KEYS], color_outputs=c, seg_weight=0.1)
    np.testing.assert_allclose(float(rgb), float(rgb_r), rtol=OUT_RTOL)
    np.testing.assert_allclose(float(seg), float(seg_r), rtol=OUT_RTOL)
    assert_packed_close(d_packed, grads_r)
    got = mip_train.mip_eval(packed, t(a["features"]), t(a["dists"]), t(a["t_mids"]),
                             t(a["noise"]), c)
    for name, g, r in zip(("rgb", "seg", "depth", "acc"), got, render_r):
        r = np.asarray(r).reshape(tuple(g.shape))
        np.testing.assert_allclose(g.numpy(), r, rtol=OUT_RTOL, atol=1e-5, err_msg=name)


# -- MipNeRF at 144 features against JAX ---------------------------------------

MODEL = dict(hidden_size=32, num_hidden_layers=3, encoding_size=FEATURES[144],
             segmentation_outputs=5)
RAYS, SAMPLES = 8, 16


def test_render_rays_and_fused_step_at_144_features_match_jax():
    """``render_rays(fused_eval=True)`` (K7's plain version) and
    ``make_fused_loss_and_grads`` with the seg CE (K6's) at 144 features
    against JAX's ``render_rays`` and ``mip_train_loss_and_grads``, JAX's
    t-values and noise fed to the port (rtol 1e-5, atol 1e-5; gradients
    within 3e-5 of their largest entry)."""
    jmodel = JaxMipNeRF(JaxMipConfig(**MODEL, use_pallas=True))
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(4)))
    model = MipNeRF(MipNeRFConfig(**MODEL, use_pallas=True), device="cpu")
    model.mlp.load_state_dict(mip_state_dict_from_jax_params(params))
    assert model.cfg.feature_dim == 144
    rng = np.random.default_rng(5)
    b = {"rays_o": rng.normal(size=(RAYS, 3)).astype(np.float32),
         "rays_d": rng.normal(size=(RAYS, 3)).astype(np.float32),
         "pixels": rng.uniform(size=(RAYS, 3)).astype(np.float32),
         "labels": rng.integers(0, MODEL["segmentation_outputs"], size=(RAYS,))}
    diag = model.cfg.bbox_diagonal

    render = RenderConfig(num_coarse_samples=SAMPLES, randomly_sample=False)
    j_render = JaxRender(**render.__dict__)
    ref = quick_jit(lambda p, o, d: JaxMipNeRF(JaxMipConfig(**MODEL)).render_rays(
        p, None, o, d, j_render))(params, b["rays_o"], b["rays_d"])
    t_vals = jsamp.sample_log_bbox(None, (RAYS,), SAMPLES, diag, randomly_sample=False)
    draws = sampling.StepDraws(t(np.array(t_vals)), torch.zeros(RAYS, SAMPLES - 1))
    with torch.no_grad():
        out = model.render_rays(t(b["rays_o"]), t(b["rays_d"]), render, fused_eval=True,
                                draws=draws)
    for name in ("rgb", "segmentation", "depth", "acc"):
        g, r = getattr(out, name), np.asarray(getattr(ref, name))
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-5, err_msg=name)

    train = RenderConfig(num_coarse_samples=SAMPLES, randomly_sample=True, density_noise_std=1.0)
    j_train = JaxRender(**train.__dict__)
    key = jax.random.PRNGKey(9)
    ref_loss, ref_grads, ref_aux = quick_jit(
        lambda p, bb, k: fused_mip_train.mip_train_loss_and_grads(jmodel, p, j_train, bb, k, 0.1))(
        params, {k: jnp.asarray(v) for k, v in b.items()}, key)
    k_strat, k_noise = jax.random.split(key)
    t_vals = jsamp.sample_log_bbox(k_strat, (RAYS,), SAMPLES, diag, randomly_sample=True)
    noise = jax.random.normal(k_noise, (RAYS, SAMPLES - 1))
    draws = sampling.StepDraws(t(np.array(t_vals)), t(np.array(noise)))
    loss, grads, aux = make_fused_loss_and_grads(model, train, 0.1)(
        {k: t(np.asarray(v)) for k, v in b.items()}, draws)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    for k in ref_aux:
        np.testing.assert_allclose(float(aux[k]), float(ref_aux[k]), rtol=1e-5, err_msg=k)
    got = jax_params_from_mip_state_dict({k[len("mlp."):]: v for k, v in grads.items()},
                                         model.cfg)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref_grads)):
        w = np.asarray(w)
        scale = np.abs(w).max() + 1e-12
        np.testing.assert_allclose(np.asarray(g).reshape(w.shape) / scale, w / scale, rtol=0,
                                   atol=GRAD_ATOL)


# -- the card's precision at full width, hidden 256 ---------------------------

# Full-width cases: (config overrides, rays, interval rows a ray).
CARD_CASES = {
    "features_144": (dict(encoding_size=FEATURES[144]), 2, 63),
    "features_600": (dict(encoding_size=FEATURES[600]), 2, 63),
    "layers_12_head_300": (DEEP_WIDE, 2, 63),
    "rows_1100": (dict(), 1, LONG_ROWS),
}


@functools.lru_cache(maxsize=None)
def full_width_case(case):
    """The full-width mip MLP of ``case`` (LayerNorms off the identity, from
    a numpy seed), its packed weights and the per-ray inputs, the features
    away from the ReLU kinks as the card tests draw them
    (``mip_rows_away_from_kinks``: nearer a kink, two float32-accurate
    evaluations can take different branches and move that row's whole
    gradient)."""
    overrides, rays, rows = CARD_CASES[case]
    cfg = MipNeRFConfig(**overrides)
    mlp = MipMLP(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(len(case))
    with torch.no_grad():
        for m in mlp.modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.weight.copy_(t(rng.uniform(0.5, 1.5, m.weight.shape).astype(np.float32)))
                m.bias.copy_(t(rng.uniform(-0.3, 0.3, m.bias.shape).astype(np.float32)))
    packed = mip_mlp.pack_mip_params(mlp.requires_grad_(False))
    a = {k: t(v) for k, v in ray_inputs(cfg, rays, rows, seed=3).items()}
    a["features"] = mip_rows_away_from_kinks(packed, torch.Generator().manual_seed(len(case)),
                                             rays, rows, cfg.feature_dim)
    return cfg, packed, a


def rel_l2(got, want) -> float:
    got, want = torch.as_tensor(got).double().ravel(), torch.as_tensor(want).double().ravel()
    return float((got - want).norm() / want.norm())


def assert_grads_within_card_bounds(got: dict, ref: dict):
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        assert rel_l2(got[k], r) <= CARD_GRAD_REL_L2, k
        scale = float(r.abs().max()) + 1e-12
        assert float((got[k] - r).abs().max()) <= CARD_GRAD_ATOL * scale, k


@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_3xtf32_products_meet_the_card_tolerance(case):
    """K5-fwd, K5-bwd (with the features' cotangent), K6 (seg weight 0.1) and
    K7 with their products emulated as 3xTF32, against their float32
    selves."""
    cfg, packed, a = full_width_case(case)
    x = a["features"].reshape(-1, cfg.feature_dim)
    ref = mip_mlp.mip_mlp_fwd_plain(packed, x)
    got = mip_mlp.mip_mlp_fwd_plain(packed, x, matmul=tc_mlp.tc_matmul)
    assert not torch.equal(got, ref)  # the emulation is not the float32 path
    torch.testing.assert_close(got, ref, **CARD_TOL)
    g_out = torch.cos(ref)
    rdx, ref = mip_mlp.mip_mlp_bwd_plain(packed, x, g_out)
    dx, got = mip_mlp.mip_mlp_bwd_plain(packed, x, g_out, matmul=tc_mlp.tc_matmul_autograd)
    assert_grads_within_card_bounds(got | {"dx": dx}, ref | {"dx": rdx})
    args = [a[k] for k in TRAIN_KEYS]
    r_rgb, r_seg, r_grads = mip_train.mip_train_grads_plain(packed, *args, seg_weight=0.1)
    rgb, seg, grads = mip_train.mip_train_grads_plain(packed, *args, seg_weight=0.1,
                                                      matmul=tc_mlp.tc_matmul_autograd)
    torch.testing.assert_close(rgb, r_rgb, rtol=CARD_LOSS_RTOL, atol=0)
    torch.testing.assert_close(seg, r_seg, rtol=CARD_LOSS_RTOL, atol=0)
    assert_grads_within_card_bounds(grads, r_grads)
    ev = (packed, a["features"], a["dists"], a["t_mids"], a["noise"])
    for g, r in zip(mip_train.mip_eval_plain(*ev, matmul=tc_mlp.tc_matmul),
                    mip_train.mip_eval_plain(*ev)):
        torch.testing.assert_close(g, r, **CARD_TOL)


@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_bf16_products_meet_the_card_bounds(case):
    """compute_dtype="bfloat16": the plain bf16 versions (every product's
    operands rounded to bfloat16, float32 sums), which the card holds its
    bf16 kernels to, against the same roundings summed in float64: K5-fwd's
    and K7's outputs (relative L2 1e-2), K5-bwd's gradients with the
    features' cotangent and K6's (2e-2), K6's loss (1e-2); K5-fwd's bf16
    outputs against float32 at the JAX package's own bf16 bound."""
    cfg, packed, a = full_width_case(case)
    f64 = Bf16Float64Sums.apply
    x = a["features"].reshape(-1, cfg.feature_dim)
    x16 = x.bfloat16()
    out = mip_mlp.mip_mlp_fwd_plain(packed, x16)
    wide = mip_mlp.mip_mlp_fwd_plain(packed, x16, matmul=f64)
    assert not torch.equal(out, wide)
    assert rel_l2(out, wide) <= BF16_FWD
    torch.testing.assert_close(out, mip_mlp.mip_mlp_fwd_plain(packed, x), **JAX_BF16)
    g_out = torch.cos(wide)
    dx, grads = mip_mlp.mip_mlp_bwd_plain(packed, x16, g_out)
    dx64, grads64 = mip_mlp.mip_mlp_bwd_plain(packed, x16, g_out, matmul=f64)
    assert dx.dtype == torch.bfloat16
    both = lambda d, g: torch.cat([d.float().ravel()] + [g[k].ravel() for k in grads64])  # noqa: E731
    assert rel_l2(both(dx, grads), both(dx64, grads64)) <= BF16_GRAD
    args = [a["features"].bfloat16()] + [a[k] for k in TRAIN_KEYS[1:]]
    rgb, seg, grads = mip_train.mip_train_grads_plain(packed, *args, seg_weight=0.1)
    rgb64, seg64, grads64 = mip_train.mip_train_grads_plain(packed, *args, seg_weight=0.1,
                                                            matmul=f64)
    assert rel_l2(rgb + 0.1 * seg, rgb64 + 0.1 * seg64) <= BF16_FWD
    assert rel_l2(torch.cat([grads[k].ravel() for k in grads64]),
                  torch.cat([grads64[k].ravel() for k in grads64])) <= BF16_GRAD
    ev = (packed, a["features"].bfloat16(), a["dists"], a["t_mids"], a["noise"])
    for g, r in zip(mip_train.mip_eval_plain(*ev), mip_train.mip_eval_plain(*ev, matmul=f64)):
        assert rel_l2(g, r) <= BF16_FWD


# -- the checks and the libraries ----------------------------------------------


def test_mip_kernel_shapes_raise_only_on_a_hidden_width():
    """``check_kernel_shapes`` (every mip wrapper's, before any launch)
    takes 600 features, 12 layers and a 300-wide head, and since the tiles
    run every hidden width (padded, or in column blocks past 256) the widths
    48 and 384 too: nothing is refused but a single layer, the rule JAX's
    ``supports_mip_config`` has too."""
    packed = mip_mlp.pack_mip_params(MipMLP(MipNeRFConfig(
        encoding_size=FEATURES[600], hidden_size=32, **DEEP_WIDE), device="cpu"))
    mip_mlp.check_kernel_shapes("mip", packed)
    for hidden in (48, 384):
        mip_mlp.check_kernel_shapes("mip", mip_mlp.pack_mip_params(
            MipMLP(MipNeRFConfig(hidden_size=hidden), device="cpu")))
    one_layer = {**packed, **{k: packed[k][:1] for k in ("b", "g", "beta")}}
    with pytest.raises(ValueError, match="layers"):
        mip_mlp.check_kernel_shapes("mip", one_layer)


@pytest.mark.parametrize("name", [mip_mlp.NAME, mip_mlp.BWD_NAME, mip_train.EVAL_NAME,
                                  mip_train.TRAIN_NAME])
def test_mip_kernels_have_no_plan(name):
    """The mip kernels' one tile takes the same bytes at every feature
    width, so no mip library exports a plan, no wrapper asks one, and the
    kernels record ``tc`` (``tc_bf16``) alone."""
    assert f"{name}_plan" not in _build.ARGTYPES
    assert f"{name}_plan" not in _build.FUNCTIONS[name]
    assert f'extern "C" int {name}_plan(' not in (_build.CSRC / f"{name}.cu").read_text()
    assert route(name, False) == (name, "tc")
    assert route(name, True) == (f"{name}_bf16", "tc_bf16")
