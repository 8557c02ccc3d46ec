"""``compute_dtype="bfloat16"`` for the mip family, held against the JAX
package on the CPU: K5-fwd, K5-bwd (with and without the features'
cotangent), K6 and K7, ``MipNeRF.render_rays`` through K5,
``render_image`` through K7, and the fused mip step.

On the CPU each wrapper given bfloat16 features runs its plain version with
the bf16 products emulated (``tc_mlp.bf16_matmul_autograd``: operands
rounded to bfloat16, float32 sums, the 54-wide head's products too); the
JAX side runs its Pallas kernels in interpret mode with
``compute_dtype=bfloat16`` and its default LayerNorm statistics, as its
users run them.  The CUDA kernels run only on a card
(``test_torch_cuda.py``).

The model is ``MipNeRFConfig()`` cut to hidden 64 (5 layers, 96 IPE
features, 3 + 50 outputs), its LayerNorms drawn off identity from a seed.
Tolerances, in relative L2 over a whole output or over all gradients
together (``rel_l2``): 5e-3, as ``test_torch_bf16.py``.  Each case also
holds bf16 against float32 at the JAX package's own bf16 bounds: outputs
within rtol 0.1, atol 0.15 (``test_pallas_mip.py::TestBfloat16Path``), the
loss within rtol 0.05 (``test_fused_mip_train.py::
test_bfloat16_compute_runs``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu import MipNeRF as JaxMipNeRF
from nerf_tpu import MipNeRFConfig as JaxMipConfig
from nerf_tpu import RenderConfig as JaxRender
from nerf_tpu.ops import sampling as jsamp
from nerf_tpu.ops.pallas import fused_mip_mlp, fused_mip_train
from nerf_tpu_torch import MipNeRF, MipNeRFConfig, RenderConfig
from nerf_tpu_torch.ops import compositing, sampling
from nerf_tpu_torch.ops.kernels import _build, mip_mlp, mip_train
from nerf_tpu_torch.train import make_fused_loss_and_grads
from nerf_tpu_torch.utils.pth_import import (
    jax_params_from_mip_state_dict,
    mip_state_dict_from_jax_params,
)

REL_L2 = 5e-3
BF16 = jnp.bfloat16
MID = dict(hidden_size=64)
LAYERS, COLORS = 5, 3
RAYS, SAMPLES = 8, 16


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def t(a, bf16=False):
    if a is None:
        return None
    out = torch.from_numpy(np.ascontiguousarray(a))
    return out.bfloat16() if bf16 else out


def flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(v, np.float64).ravel()
                           for v in jax.tree_util.tree_leaves(tree)])


def jax_packed(grads) -> dict:
    return {k: np.asarray(v) for k, v in fused_mip_mlp.pack_mip_params(grads).items()}


def assert_packed_close(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    err = rel_l2(np.concatenate([got[k].detach().numpy().ravel() for k in want]),
                 np.concatenate([want[k].ravel() for k in want]))
    assert err <= REL_L2, err


def assert_jax_bf16_bound(bf16, f32) -> None:
    np.testing.assert_allclose(np.asarray(bf16), np.asarray(f32), rtol=0.1, atol=0.15)


def jax_params(seed=0):
    """JAX mip parameters at ``MID``, the LayerNorms off identity so their
    gradients mean something."""
    params = jax.tree_util.tree_map(
        np.asarray, JaxMipNeRF(JaxMipConfig(**MID)).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for layer in params["layers"]:
        h = layer["ln"]["scale"].shape[0]
        layer["ln"] = {"scale": rng.uniform(0.5, 1.5, size=h).astype(np.float32),
                       "bias": rng.uniform(-0.3, 0.3, size=h).astype(np.float32)}
    return params


def setup_packed(seed=0):
    params = jax_params(seed)
    model = MipNeRF(MipNeRFConfig(**MID), device="cpu")
    model.mlp.load_state_dict(mip_state_dict_from_jax_params(params))
    return model.cfg, params, mip_mlp.pack_mip_params(model.mlp.requires_grad_(False))


def ray_inputs(cfg, rays=8, rows=15, noise=True, seed=0):
    rng = np.random.default_rng(seed)
    points = np.cumsum(rng.uniform(0.0, 1.0, size=(rays, rows, 3)), axis=1).astype(np.float32)
    return dict(
        features=rng.uniform(-1, 1, size=(rays, rows, cfg.feature_dim)).astype(np.float32),
        dists=compositing.distances_from_points(t(points)).numpy(),
        noise=(rng.normal(size=(rays, rows)) if noise else np.zeros((rays, rows)))
        .astype(np.float32),
        pixels=rng.uniform(size=(rays, COLORS)).astype(np.float32),
        labels=rng.integers(0, cfg.segmentation_outputs, size=(rays,)),
        t_mids=rng.uniform(0.1, 60.0, size=(rays, rows)).astype(np.float32),
    )


# -- K5 -----------------------------------------------------------------------


def test_k5_fwd_bf16_matches_jax():
    cfg, params, packed = setup_packed()
    feat = np.random.default_rng(1).uniform(-1, 1, size=(256, cfg.feature_dim)).astype(np.float32)
    ref = fused_mip_mlp.mip_mlp_pallas(params, feat, LAYERS, COLORS, compute_dtype=BF16,
                                       interpret=True)
    before = dict(_build.launch_counts)
    out = mip_mlp.mip_mlp_fwd(packed, t(feat, True))
    assert dict(_build.launch_counts) == before  # the plain version launches nothing
    assert out.dtype == torch.float32 and out.shape == (256, cfg.num_outputs)
    assert rel_l2(out.numpy(), np.concatenate([np.asarray(r) for r in ref], -1)) <= REL_L2
    assert_jax_bf16_bound(out.numpy(), mip_mlp.mip_mlp_fwd(packed, t(feat)).numpy())


def test_k5_fwd_bf16_rounds_the_head():
    """The head's product runs on rounded operands: the plain bf16 forward
    equals the rounded last layer times the rounded head, and differs from
    the float32 head on the same rows."""
    cfg, _, packed = setup_packed()
    feat = t(np.random.default_rng(2).uniform(-1, 1, size=(64, cfg.feature_dim))
             .astype(np.float32), True)
    r = mip_mlp.tc_mlp.bf16_round
    out = mip_mlp.mip_mlp_fwd(packed, feat)
    head_only = {**packed, "w_out": torch.eye(packed["w_out"].shape[0]),
                 "b_out": torch.zeros(packed["w_out"].shape[0])}
    h = mip_mlp.mip_mlp_fwd_plain(head_only, feat)  # the last layer, rounded by the identity head
    torch.testing.assert_close(out, h @ r(packed["w_out"]) + packed["b_out"], rtol=1e-6,
                               atol=1e-6)
    assert not torch.allclose(out, h @ packed["w_out"] + packed["b_out"], rtol=1e-6, atol=1e-6)


def test_k5_bwd_bf16_matches_jax():
    cfg, params, packed = setup_packed(1)
    rng = np.random.default_rng(2)
    feat = rng.uniform(-1, 1, size=(256, cfg.feature_dim)).astype(np.float32)
    g_out = rng.normal(size=(256, cfg.num_outputs)).astype(np.float32)
    fb = jnp.asarray(feat).astype(BF16)
    _, vjp = jax.vjp(lambda p, x: fused_mip_mlp.mip_mlp_pallas(
        p, x, LAYERS, COLORS, compute_dtype=BF16, interpret=True), params, fb)
    gp, gx = vjp((g_out[:, :1], g_out[:, 1:1 + COLORS], g_out[:, 1 + COLORS:]))
    dfeat, d_packed = mip_mlp.mip_mlp_bwd(packed, t(feat, True), t(g_out))
    # The features' cotangent takes the features' dtype, as JAX's VJP's.
    assert dfeat.dtype == torch.bfloat16 and gx.dtype == BF16
    assert rel_l2(dfeat.float().numpy(), np.asarray(gx, np.float32)) <= REL_L2
    assert_packed_close(d_packed, jax_packed(gp))
    dfeat, d_packed = mip_mlp.mip_mlp_bwd(packed, t(feat, True), t(g_out), input_grads=False)
    assert dfeat is None
    assert_packed_close(d_packed, jax_packed(gp))
    # Under autograd, through MipMLPFunction, the features' cotangent too.
    leaves = {k: v.clone().requires_grad_(True) for k, v in packed.items()}
    x = t(feat, True).requires_grad_(True)
    grads = torch.autograd.grad(mip_mlp.mip_mlp_fwd(leaves, x), [x, *leaves.values()],
                                t(g_out))
    assert grads[0].dtype == torch.bfloat16
    assert rel_l2(grads[0].float().numpy(), np.asarray(gx, np.float32)) <= REL_L2
    assert_packed_close(dict(zip(leaves, grads[1:])), jax_packed(gp))


# -- K6 and K7 ----------------------------------------------------------------


@pytest.mark.parametrize("seg_weight,white", [(0.0, False), (0.1, False), (0.0, True),
                                              (0.1, True)])
def test_k6_bf16_matches_jax(seg_weight, white):
    cfg, params, packed = setup_packed(2)
    a = ray_inputs(cfg, seed=3)
    keys = ("features", "dists", "noise", "pixels", "labels")
    jin = [jnp.asarray(a[k]) for k in keys]
    rgb_r, seg_r, grads_r = fused_mip_train.mip_train_grads_pallas(
        params, *jin, LAYERS, color_outputs=COLORS, seg_weight=seg_weight,
        white_background=white, compute_dtype=BF16, interpret=True)
    args = [t(a[k], k == "features") for k in keys]
    rgb, seg, d_packed = mip_train.mip_train_grads(
        packed, *args, color_outputs=COLORS, seg_weight=seg_weight, white_background=white)
    assert rel_l2(float(rgb), float(rgb_r)) <= REL_L2
    if seg_weight:
        assert rel_l2(float(seg), float(seg_r)) <= REL_L2
    else:
        assert float(seg) == 0.0
    assert_packed_close(d_packed, jax_packed(grads_r))
    rgb32, seg32, _ = mip_train.mip_train_grads(
        packed, *[t(a[k]) for k in keys], color_outputs=COLORS, seg_weight=seg_weight,
        white_background=white)
    np.testing.assert_allclose(float(rgb + seg_weight * seg),
                               float(rgb32 + seg_weight * seg32), rtol=0.05)


@pytest.mark.parametrize("noise,white", [(False, False), (True, True)])
def test_k7_bf16_matches_jax(noise, white):
    cfg, params, packed = setup_packed(3)
    a = ray_inputs(cfg, noise=noise, seed=4)
    ref = fused_mip_train.mip_eval_pallas(
        params, jnp.asarray(a["features"]), jnp.asarray(a["dists"]), jnp.asarray(a["t_mids"]),
        jnp.asarray(a["noise"]) if noise else None, LAYERS, color_outputs=COLORS,
        white_background=white, compute_dtype=BF16, interpret=True)
    rest = (t(a["dists"]), t(a["t_mids"]), t(a["noise"]) if noise else None, COLORS, white)
    got = mip_train.mip_eval(packed, t(a["features"], True), *rest)
    f32 = mip_train.mip_eval(packed, t(a["features"]), *rest)
    for name, g, r, f in zip(("rgb", "seg", "depth", "acc"), got, ref, f32):
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape, name
        assert rel_l2(g.numpy(), r) <= REL_L2, name
        assert_jax_bf16_bound(g.numpy(), f.numpy())


# -- the slice end to end -----------------------------------------------------


def make_models(**cfg_kwargs):
    """The JAX and the port's MipNeRF at ``MID`` with the same weights."""
    params = jax_params(4)
    jmodel = JaxMipNeRF(JaxMipConfig(**MID, **cfg_kwargs))
    model = MipNeRF(MipNeRFConfig(**MID, **cfg_kwargs), device="cpu")
    model.mlp.load_state_dict(mip_state_dict_from_jax_params(params))
    return jmodel, params, model


def rays_np(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "rays_o": rng.normal(size=(RAYS, 3)).astype(np.float32),
        "rays_d": rng.normal(size=(RAYS, 3)).astype(np.float32),
        "pixels": rng.uniform(size=(RAYS, COLORS)).astype(np.float32),
        "labels": rng.integers(0, 50, size=(RAYS,)),
    }


def jax_fenceposts(model, rays):
    """JAX's deterministic fenceposts (the port's differ by a few ulp)."""
    return torch.from_numpy(np.array(jsamp.sample_log_bbox(
        None, (rays,), SAMPLES, model.cfg.bbox_diagonal, randomly_sample=False)))


BF16_KERNELS = dict(use_pallas=True, compute_dtype="bfloat16")


@pytest.mark.parametrize("fused_eval", [False, True])
def test_render_rays_bf16_matches_jax(fused_eval):
    """8 rays of 16 fenceposts through K5 (autograd's path) or K7."""
    jmodel, params, model = make_models(**BF16_KERNELS)
    _, _, model32 = make_models(use_pallas=True)
    render = RenderConfig(num_coarse_samples=SAMPLES, randomly_sample=False,
                          white_background=True)
    b = rays_np(1)
    ref = jmodel.render_rays(params, None, jnp.asarray(b["rays_o"]), jnp.asarray(b["rays_d"]),
                             JaxRender(**render.__dict__), fused_eval=fused_eval)
    draws = sampling.StepDraws(jax_fenceposts(model, RAYS), torch.zeros(RAYS, SAMPLES - 1))
    with torch.no_grad():
        out, out32 = (m.render_rays(t(b["rays_o"]), t(b["rays_d"]), render,
                                    fused_eval=fused_eval, draws=draws) for m in (model, model32))
    for name in ("rgb", "segmentation", "depth", "acc"):
        got, want = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        assert got.shape == want.shape and np.isfinite(got).all(), name
        assert rel_l2(got, want) <= REL_L2, name
        assert_jax_bf16_bound(got, getattr(out32, name).numpy())


def test_render_image_bf16_matches_jax(monkeypatch):
    """A 5x4 image in tiles of 10 rays through K7 (JAX's kernel takes whole
    pairs of rays a slice), the weights imaged once."""
    jmodel, params, model = make_models(**BF16_KERNELS)
    render = RenderConfig(num_coarse_samples=SAMPLES, randomly_sample=False, rays_per_tile=10)
    pose_o = np.array([[0.5, -0.4, 2.0]], np.float32)
    pose_r = np.eye(3, dtype=np.float32)[None]
    ref_rgb, ref_seg = jmodel.render_image(params, None, pose_o, pose_r, 5, 4, 6.0,
                                           JaxRender(**render.__dict__))
    t_vals = jax_fenceposts(model, 1)[0]
    monkeypatch.setattr(sampling, "sample_log_bbox", lambda gen, batch_shape, n, *a, **k:
                        t_vals.expand(tuple(batch_shape) + (n,)))
    rgb, seg = model.render_image(t(pose_o), t(pose_r), 5, 4, 6.0, render)
    assert rgb.shape == (1, 5, 4, 3) and seg.shape == (1, 5, 4, 50)
    assert rel_l2(rgb.numpy(), ref_rgb) <= REL_L2
    assert rel_l2(seg.numpy(), ref_seg) <= REL_L2


@pytest.mark.parametrize("seg_weight", [0.0, 0.1])
def test_fused_step_bf16_matches_jax(seg_weight):
    """One fused mip step (K6) in bfloat16 with JAX's draws, against JAX's
    ``fused_mip_train.mip_train_loss_and_grads``; the loss within rtol 0.05
    of the float32 step's."""
    jmodel, params, model = make_models(**BF16_KERNELS)
    _, _, model32 = make_models(use_pallas=True)
    render = RenderConfig(num_coarse_samples=SAMPLES, randomly_sample=True, density_noise_std=1.0)
    b = rays_np(3)
    key = jax.random.PRNGKey(9)
    ref_loss, ref_grads, ref_aux = fused_mip_train.mip_train_loss_and_grads(
        jmodel, params, JaxRender(**render.__dict__), {k: jnp.asarray(v) for k, v in b.items()},
        key, seg_weight)
    k_strat, k_noise = jax.random.split(key)
    t_vals = jsamp.sample_log_bbox(k_strat, (RAYS,), SAMPLES, model.cfg.bbox_diagonal,
                                   randomly_sample=True)
    noise = jax.random.normal(k_noise, (RAYS, SAMPLES - 1))
    draws = sampling.StepDraws(torch.from_numpy(np.array(t_vals)), torch.from_numpy(np.array(noise)))
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    loss, grads, aux = make_fused_loss_and_grads(model, render, seg_weight)(batch, draws)
    assert set(aux) == set(ref_aux)
    for k in ref_aux:
        assert rel_l2(float(aux[k]), float(ref_aux[k])) <= REL_L2, k
    sd = {k[len("mlp."):]: v for k, v in grads.items()}
    got = jax_params_from_mip_state_dict(sd, model.cfg)
    assert rel_l2(flat(got), flat(ref_grads)) <= REL_L2
    loss32, _, _ = make_fused_loss_and_grads(model32, render, seg_weight)(batch, draws)
    np.testing.assert_allclose(float(loss), float(loss32), rtol=0.05)


def test_wrappers_refuse_mixed_mip_dtypes():
    cfg, _, packed = setup_packed()
    feat = torch.zeros(4, cfg.feature_dim)
    f32_image = mip_mlp.tc_mlp.tc_images(packed)[0]
    with pytest.raises(TypeError, match="tc_fwd must be bfloat16"):
        mip_mlp.mip_mlp_fwd(packed, feat.bfloat16(), tc_fwd=f32_image)
    with pytest.raises(TypeError, match="float32"):
        mip_mlp.mip_mlp_fwd(packed, feat.half())
    a = ray_inputs(cfg, rays=2, rows=3)
    with pytest.raises(TypeError, match="dists must be float32"):
        mip_train.mip_eval(packed, t(a["features"], True), t(a["dists"]).bfloat16(),
                           t(a["t_mids"]))
