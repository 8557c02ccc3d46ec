"""The port's MipNeRF and its train steps held against the JAX package on
the CPU: ``render_rays`` with ``fused_eval`` True (K7's plain version) and
False, a small ``render_image``, ``make_loss_fn`` with a segmentation
weight (the plain MLP and K5's plain versions under autograd),
``make_fused_loss_and_grads`` (K6's plain version) against JAX's
``mip_train_loss_and_grads`` given JAX's draws, and a few ``Trainer.fit``
steps of the mip model on a labelled synthetic scene.

The model is small (hidden 32, 3 layers, 24 IPE features, 5 classes), 8
rays of 16 fenceposts.  The port's own fenceposts differ from JAX's by up
to 7 ulp (``test_torch_mip_ops.py``), so every comparison feeds JAX's
t-values (through ``StepDraws``, or in place of ``sample_log_bbox``).
Tolerances: outputs and losses rtol 1e-5 (float32 sums in another order);
gradients normalised by their largest entry within 3e-5, the JAX
package's bound for its mip kernels.
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
from nerf_tpu.ops.pallas import fused_mip_train, fused_mlp
from nerf_tpu.train.loop import make_loss_fn as jax_make_loss_fn
from nerf_tpu_torch import MipNeRF, MipNeRFConfig, RenderConfig, TrainConfig
from nerf_tpu_torch.data import RayBank, synthesize_scene
from nerf_tpu_torch.ops import sampling
from nerf_tpu_torch.ops.kernels import mip_train
from nerf_tpu_torch.train import Trainer, evaluate, make_fused_loss_and_grads, make_loss_fn
from nerf_tpu_torch.utils.pth_import import (
    jax_params_from_mip_state_dict,
    mip_state_dict_from_jax_params,
)

SMALL = dict(hidden_size=32, num_hidden_layers=3, encoding_size=8, segmentation_outputs=5)
OUT = dict(rtol=1e-5, atol=1e-5)
GRAD_ATOL = 3e-5
RAYS, SAMPLES = 8, 16


@pytest.fixture(autouse=True)
def exact_ln_stats():
    prev = fused_mlp._LN_STATS
    fused_mlp._LN_STATS = "twopass"
    yield
    fused_mlp._LN_STATS = prev


def make_models(use_pallas=False, seed=0):
    jmodel = JaxMipNeRF(JaxMipConfig(**SMALL, use_pallas=use_pallas))
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    model = MipNeRF(MipNeRFConfig(**SMALL, use_pallas=use_pallas), device="cpu")
    model.mlp.load_state_dict(mip_state_dict_from_jax_params(params))
    return jmodel, params, model


def batch_np(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "rays_o": rng.normal(size=(RAYS, 3)).astype(np.float32),
        "rays_d": rng.normal(size=(RAYS, 3)).astype(np.float32),
        "pixels": rng.uniform(size=(RAYS, 3)).astype(np.float32),
        "labels": rng.integers(0, SMALL["segmentation_outputs"], size=(RAYS,)),
    }


def port_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def jax_draws(key, render, diag):
    """The t-values and noise JAX's mip render draws from ``key``
    (``render_rays``' split into a jitter key and a noise key)."""
    k_strat, k_noise = jax.random.split(key)
    t_vals = jsamp.sample_log_bbox(k_strat, (RAYS,), render.num_coarse_samples, diag,
                                   randomly_sample=render.randomly_sample)
    noise = render.density_noise_std * jax.random.normal(
        k_noise, (RAYS, render.num_coarse_samples - 1))
    return sampling.StepDraws(torch.from_numpy(np.array(t_vals)), torch.from_numpy(np.array(noise)))


def port_grads_as_jax(grads, cfg):
    """The port's gradients keyed by parameter name as a JAX mip pytree."""
    sd = {k[len("mlp."):]: v for k, v in grads.items()}
    return jax_params_from_mip_state_dict(sd, cfg)


def assert_tree_close(got, want):
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        w = np.asarray(w)
        scale = np.abs(w).max() + 1e-12
        np.testing.assert_allclose(np.asarray(g).reshape(w.shape) / scale, w / scale,
                                   rtol=0, atol=GRAD_ATOL)


@pytest.mark.parametrize("fused_eval", [True, False])
def test_render_rays_matches_jax(fused_eval):
    jmodel, params, model = make_models(use_pallas=fused_eval)
    render = RenderConfig(num_coarse_samples=SAMPLES, randomly_sample=False, white_background=True)
    b = batch_np(1)
    ref = JaxMipNeRF(JaxMipConfig(**SMALL)).render_rays(
        params, None, b["rays_o"], b["rays_d"], JaxRender(**render.__dict__))
    t_vals = jsamp.sample_log_bbox(None, (RAYS,), SAMPLES, model.cfg.bbox_diagonal,
                                   randomly_sample=False)
    draws = sampling.StepDraws(torch.from_numpy(np.array(t_vals)), torch.zeros(RAYS, SAMPLES - 1))
    with torch.no_grad():
        out = model.render_rays(torch.from_numpy(b["rays_o"]), torch.from_numpy(b["rays_d"]),
                                render, fused_eval=fused_eval, draws=draws)
    assert model._use_fused_eval(render, torch.zeros(RAYS, 3)) == fused_eval
    for name in ("rgb", "segmentation", "depth", "acc"):
        g, r = getattr(out, name), np.asarray(getattr(ref, name))
        assert tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.numpy(), r, err_msg=name, **OUT)


def test_render_image_matches_jax(monkeypatch):
    jmodel, params, model = make_models(use_pallas=True)
    render = RenderConfig(num_coarse_samples=SAMPLES, randomly_sample=False, rays_per_tile=7)
    pose_o = np.array([[0.5, -0.4, 2.0]], np.float32)
    pose_r = np.eye(3, dtype=np.float32)[None]
    ref_rgb, ref_seg = JaxMipNeRF(JaxMipConfig(**SMALL)).render_image(
        params, None, pose_o, pose_r, 5, 4, 6.0, JaxRender(**render.__dict__))
    jax_t = np.array(jsamp.sample_log_bbox(None, (1,), SAMPLES, model.cfg.bbox_diagonal,
                                             randomly_sample=False))[0]

    def jax_fenceposts(generator, batch_shape, num_samples, *args, **kwargs):
        return torch.from_numpy(jax_t).expand(tuple(batch_shape) + (num_samples,))

    monkeypatch.setattr(sampling, "sample_log_bbox", jax_fenceposts)
    rgb, seg = model.render_image(torch.from_numpy(pose_o), torch.from_numpy(pose_r), 5, 4, 6.0,
                                  render)
    assert rgb.shape == (1, 5, 4, 3) and seg.shape == (1, 5, 4, 5)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(ref_rgb), **OUT)
    np.testing.assert_allclose(seg.numpy(), np.asarray(ref_seg), **OUT)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_make_loss_fn_with_seg_weight_matches_jax(use_pallas):
    jmodel, params, model = make_models(use_pallas=use_pallas)
    render = RenderConfig(num_coarse_samples=SAMPLES, randomly_sample=True, density_noise_std=1.0)
    b = batch_np(2)
    key = jax.random.PRNGKey(5)
    (ref_loss, ref_aux), ref_grads = jax.value_and_grad(
        jax_make_loss_fn(JaxMipNeRF(JaxMipConfig(**SMALL)), JaxRender(**render.__dict__), 0.1),
        has_aux=True)(params, key, {k: jnp.asarray(v) for k, v in b.items()})
    draws = jax_draws(key, render, model.cfg.bbox_diagonal)
    with torch.enable_grad():
        loss, aux = make_loss_fn(model, render, 0.1)(port_batch(b), draws)
    names, ps = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, ps)))
    for k in ("loss", "rgb_loss", "fine_mse", "seg_loss"):
        np.testing.assert_allclose(float(aux[k].detach()), float(ref_aux[k]), rtol=1e-5, err_msg=k)
    assert_tree_close(port_grads_as_jax(grads, model.cfg), ref_grads)


@pytest.mark.parametrize("seg_weight", [0.0, 0.1])
def test_fused_loss_and_grads_matches_jax_mip_train(seg_weight):
    jmodel, params, model = make_models(use_pallas=True, seed=1)
    render = RenderConfig(num_coarse_samples=SAMPLES, randomly_sample=True, density_noise_std=1.0)
    b = batch_np(3)
    key = jax.random.PRNGKey(9)
    ref_loss, ref_grads, ref_aux = fused_mip_train.mip_train_loss_and_grads(
        jmodel, params, JaxRender(**render.__dict__), {k: jnp.asarray(v) for k, v in b.items()},
        key, seg_weight)
    draws = jax_draws(key, render, model.cfg.bbox_diagonal)
    loss, grads, aux = make_fused_loss_and_grads(model, render, seg_weight)(port_batch(b), draws)
    assert set(aux) == set(ref_aux)
    for k in ref_aux:
        np.testing.assert_allclose(float(aux[k]), float(ref_aux[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    assert_tree_close(port_grads_as_jax(grads, model.cfg), ref_grads)


def test_trainer_fits_the_mip_model_on_a_labelled_scene(monkeypatch):
    scene = synthesize_scene(num_views=2, image_hw=8, focal=10.0, num_samples=32,
                             with_labels=True, device="cpu")
    bank = RayBank.from_images(scene.images, scene.pose_o, scene.pose_r, scene.focal,
                               labels=scene.labels)
    model = MipNeRF(MipNeRFConfig(**SMALL, use_pallas=True), device="cpu")
    render = RenderConfig(num_coarse_samples=SAMPLES, randomly_sample=True, density_noise_std=1.0)
    calls = []
    fused = mip_train.mip_train_loss_and_grads
    monkeypatch.setattr(mip_train, "mip_train_loss_and_grads",
                        lambda *a, **k: calls.append(1) or fused(*a, **k))
    cfg = TrainConfig(batch_size=16, num_steps=4, log_interval=2, eval_interval=4,
                      checkpoint_interval=4, learning_rate=1e-3)
    trainer = Trainer(model, render, cfg, segmentation_loss_weight=0.1)
    state = trainer.fit(bank, eval_scene=scene)
    assert state.step == 4 and len(calls) == 4  # the fused mip step, seg CE included
    records = trainer.metrics.history
    assert [r["step"] for r in records] == [2, 4]
    assert all(np.isfinite(r["loss"]) for r in records) and np.isfinite(records[-1]["psnr"])
    image, psnr = evaluate(model, scene, render)
    assert image.shape == (1, 8, 8, 3) and np.isfinite(float(psnr))
