"""The port's data layer and trainer held against the JAX package on the
CPU: ``RayBank`` and ``synthesize_scene`` with the same indices, one Adam
step against ``optax.adam``, ``make_train_step`` over three steps with the
same batches and deterministic sampling, chained steps against single
steps (bitwise), the non-finite-loss guard, ``Trainer.fit`` and
``evaluate`` (the ``Trainer``'s checkpoints and resume:
``test_torch_checkpoint.py``).

Models are small (hidden 32), carry the JAX package's frequency constants
and have the density head biased to a positive density, as in
``test_torch_render.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_tpu import ClassicNeRF as JaxNeRF
from nerf_tpu import ClassicNeRFConfig as JaxConfig
from nerf_tpu import RenderConfig as JaxRender
from nerf_tpu.data import RayBank as JaxBank
from nerf_tpu.data import scenes as jscenes
from nerf_tpu.ops import encoding as jenc
from nerf_tpu.train import create_train_state as jax_create_state
from nerf_tpu.train import evaluate as jax_evaluate
from nerf_tpu.train import make_train_step as jax_make_train_step
from nerf_tpu.train import metrics as jmetrics
from nerf_tpu_torch import ClassicNeRF, ClassicNeRFConfig, RenderConfig, TrainConfig
from nerf_tpu_torch.data import RayBank, SceneData, scenes, synthesize_scene
from nerf_tpu_torch.ops import sampling
from nerf_tpu_torch.train import (
    TrainDivergedError,
    Trainer,
    create_train_state,
    evaluate,
    make_fused_multi_step_train_fn,
    make_multi_step_train_fn,
    make_sampling_train_step,
    make_train_step,
    metrics,
)
from nerf_tpu_torch.train.loop import _check_finite_losses, make_fused_train_step
from nerf_tpu_torch.utils.pth_import import classic_state_dict_from_jax_params

MODEL = dict(hidden_size=32, normalize_position=6.0)


@pytest.fixture(scope="module")
def jax_scene():
    return jscenes.synthesize_scene(num_views=3, image_hw=12, focal=15.0, num_samples=96)


def port_scene(js) -> SceneData:
    return SceneData(*(torch.from_numpy(np.array(v)) if hasattr(v, "shape") else v
                       for v in (js.images, js.pose_o, js.pose_r, js.focal)))


def make_models(**kwargs):
    kwargs = dict(MODEL, **kwargs)
    jmodel = JaxNeRF(JaxConfig(**kwargs))
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    # Mass in every coarse bin (see test_torch_render.py): an empty bin
    # turns a 1-ulp difference of the coarse weights into a shift of the
    # fine samples.
    params["density"] = {"w": params["density"]["w"] * np.float32(0.05),
                         "b": np.full_like(params["density"]["b"], 0.5)}
    cfg = ClassicNeRFConfig(**kwargs)
    model = ClassicNeRF(cfg, device="cpu")
    model.mlp.load_state_dict(classic_state_dict_from_jax_params(params))
    model.x_scales.copy_(torch.tensor(
        jenc.frequency_scales_np(cfg.x_positional_encoding_size, cfg.normalize_position)))
    model.d_scales.copy_(torch.tensor(
        jenc.frequency_scales_np(cfg.d_positional_encoding_size, cfg.direction_bound)))
    return jmodel, params, model


# -- data -------------------------------------------------------------------


def test_synthesize_scene_matches_jax(jax_scene):
    ours = synthesize_scene(num_views=3, image_hw=12, focal=15.0, num_samples=96, device="cpu")
    assert ours.images.shape == (3, 12, 12, 3) and ours.focal == 15.0
    np.testing.assert_allclose(ours.pose_o.numpy(), np.asarray(jax_scene.pose_o), atol=1e-6)
    np.testing.assert_allclose(ours.images.numpy(), np.asarray(jax_scene.images), atol=2e-5)


def test_scene_density_color_and_labels_match_jax():
    pts = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32) * 0.6
    want = jscenes.scene_density_color(jnp.asarray(pts), field_offset=(0.1, 0.0, -0.2))
    got = scenes.scene_density_color(torch.from_numpy(pts), field_offset=(0.1, 0.0, -0.2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    rng = np.random.default_rng(1)
    o = (rng.normal(size=(20, 3)) * 0.1 + [0, 0, 4]).astype(np.float32)
    d = rng.normal(size=(20, 3)).astype(np.float32) * 0.1 + np.float32([0, 0, -1])
    rgb_w, lab_w = jscenes.render_ground_truth(jnp.asarray(o), jnp.asarray(d), num_samples=64)
    rgb, lab = scenes.render_ground_truth(torch.from_numpy(o), torch.from_numpy(d), num_samples=64)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_w), atol=2e-5)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(lab_w))


def banks(jax_scene, latent=False):
    rng = np.random.default_rng(3)
    extra = {}
    if latent:
        extra = dict(states_x=rng.normal(size=(3, 2)).astype(np.float32),
                     states_d=rng.normal(size=(3, 1)).astype(np.float32))
    js = jax_scene
    jb = JaxBank.from_images(js.images, js.pose_o, js.pose_r, js.focal, **extra)
    pb = RayBank.from_images(np.asarray(js.images), np.asarray(js.pose_o), np.asarray(js.pose_r),
                             js.focal, device="cpu", **extra)
    return jb, pb


@pytest.mark.parametrize("latent", [False, True])
def test_ray_bank_gather_matches_jax(jax_scene, latent):
    jb, pb = banks(jax_scene, latent)
    assert pb.num_rays == jb.num_rays == 3 * 12 * 12 and pb.image_shape == jb.image_shape
    idx = np.random.default_rng(0).integers(0, pb.num_rays, size=40)
    want, got = jb.gather(jnp.asarray(idx)), pb.gather(idx)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6, err_msg=k)
    batch = pb.sample_batch(torch.Generator().manual_seed(0), 32)
    assert batch["rays_o"].shape == (32, 3) and batch["pixels"].shape == (32, 3)


def test_ray_bank_block_stratified_and_epoch_match_jax(jax_scene):
    jb, pb = banks(jax_scene)
    key = jax.random.PRNGKey(4)
    want = jb.sample_block_stratified(key, 1, 4, 4, 2)
    block_idx = np.asarray(jax.random.randint(key, (2, 16), 0, 3 * 3))  # the JAX draw
    got = pb.gather_block_stratified(block_idx, 1, 4, 4)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6, err_msg=k)
    drawn = pb.sample_block_stratified(torch.Generator().manual_seed(0), 1, 4, 4, 2)
    assert drawn["rays_o"].shape == (32, 3)
    assert int(drawn["image_hi"].max()) < 12 and int(drawn["image_wi"].max()) < 12
    for w, g in zip(jb.iter_epoch(5, 100), pb.iter_epoch(5, 100)):
        np.testing.assert_allclose(g["pixels"].numpy(), np.asarray(w["pixels"]), atol=0)
    assert len(list(pb.iter_epoch(5, 100))) == 4


# -- optimizer, metrics, guard ------------------------------------------------


def test_one_adam_step_matches_optax():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(5, 4)).astype(np.float32)
    grads = [rng.normal(size=(5, 4)).astype(np.float32) * s for s in (1.0, 1e-3)]
    opt = optax.adam(1e-2)
    params = jnp.asarray(w)
    state = opt.init(params)
    module = torch.nn.Linear(4, 5, bias=False)
    with torch.no_grad():
        module.weight.copy_(torch.from_numpy(w))
    ours = create_train_state(module, 1e-2)
    for g in grads:
        updates, state = opt.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
        module.weight.grad = torch.from_numpy(g)
        ours.optimizer.step()
    np.testing.assert_allclose(module.weight.detach().numpy(), np.asarray(params),
                               rtol=1e-6, atol=1e-7)


def test_psnr_and_metrics_logger(tmp_path):
    for mse in (0.01, 0.2):
        assert metrics.mse_to_psnr(mse) == pytest.approx(float(jmetrics.mse_to_psnr(mse)), rel=1e-6)
    assert float(metrics.psnr(torch.zeros(4), torch.full((4,), 0.1))) == pytest.approx(20.0, rel=1e-5)
    log = metrics.MetricsLogger(str(tmp_path))
    log.log(10, loss=torch.tensor(0.5), psnr=21.0)
    log.log(20, loss=0.25)
    log.save_npy_dumps()
    log.close()
    assert log.series("loss") == [0.5, 0.25]
    assert np.load(tmp_path / "psnrs.npy").tolist() == [21.0]
    assert (tmp_path / "metrics.jsonl").read_text().count("\n") == 2


def test_check_finite_losses_raises_at_the_bad_step():
    _check_finite_losses(np.asarray([0.3, 0.2]), 10)
    with pytest.raises(TrainDivergedError, match="step 12"):
        _check_finite_losses(np.asarray([0.3, 0.2, np.nan, 0.1]), 10)
    with pytest.raises(TrainDivergedError, match="inf"):
        _check_finite_losses(torch.tensor([float("inf")]).numpy(), 0)


# -- train steps --------------------------------------------------------------


def test_make_train_step_matches_jax_over_three_steps(jax_scene):
    jmodel, params, model = make_models()
    kw = dict(num_coarse_samples=8, num_fine_samples=8, near=2.0, far=6.0,
              randomly_sample=False, density_noise_std=0.0)
    jb, pb = banks(jax_scene)
    jstep = jax_make_train_step(jmodel, optax.adam(1e-3), JaxRender(**kw), donate=False)
    jstate = jax_create_state(jax.tree_util.tree_map(jnp.asarray, params), optax.adam(1e-3))
    step = make_train_step(model, RenderConfig(**kw))
    state = create_train_state(model, 1e-3)
    rng = np.random.default_rng(0)
    for _ in range(3):
        idx = rng.integers(0, pb.num_rays, size=24)
        jstate, jaux = jstep(jstate, jb.gather(jnp.asarray(idx)))
        batch = pb.gather(idx)
        aux = step(state, batch, sampling.draw_step(None, RenderConfig(**kw), 24, "cpu"))
        np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(aux["grad_norm"]), float(jaux["grad_norm"]), rtol=1e-3)
    assert state.step == 3
    sd = classic_state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, jstate.params))
    for k, want in sd.items():
        # Adam normalises each update: a gradient near 0 can take either sign
        # in the two packages, so a weight may differ by up to 2 lr per step.
        np.testing.assert_allclose(model.mlp.state_dict()[k].numpy(), want.numpy(),
                                   atol=6e-3, err_msg=k)


@pytest.mark.parametrize("fused", [False, True])
def test_chained_steps_equal_single_steps_bitwise(jax_scene, fused):
    _, pb = banks(jax_scene)
    render = RenderConfig(num_coarse_samples=8, num_fine_samples=8, density_noise_std=1.0)
    finals = []
    for chained in (True, False):
        model = ClassicNeRF(ClassicNeRFConfig(use_pallas=fused, **MODEL),
                            generator=torch.Generator().manual_seed(0), device="cpu")
        state = create_train_state(model, 1e-3, seed=3)
        if chained:
            maker = make_fused_multi_step_train_fn if fused else make_multi_step_train_fn
            state, aux = maker(model, render, pb, 16, 3)(state)
            losses = aux["loss"]
        else:
            if fused:
                inner = make_fused_train_step(model, render)
                one = lambda s: inner(s, *_batch_and_draws(s, pb, render))  # noqa: E731
            else:
                one = make_sampling_train_step(model, render, pb, 16)
            losses = torch.stack([one(state)["loss"] for _ in range(3)])
        finals.append((losses, [p.detach().clone() for p in model.parameters()]))
    torch.testing.assert_close(finals[0][0], finals[1][0], rtol=0, atol=0)
    for a, b in zip(finals[0][1], finals[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _batch_and_draws(state, bank, render):
    from nerf_tpu_torch.train.loop import _sample

    return _sample(state, bank, 16, render)


def test_trainer_fit_lowers_the_loss_and_evaluates(jax_scene):
    _, pb = banks(jax_scene)
    cfg = TrainConfig(batch_size=32, learning_rate=5e-3, log_interval=10, eval_interval=30,
                      checkpoint_interval=30, seed=1)
    model = ClassicNeRF(ClassicNeRFConfig(use_pallas=True, **MODEL), device="cpu")
    render = RenderConfig(num_coarse_samples=8, num_fine_samples=4, density_noise_std=0.5)
    trainer = Trainer(model, render, cfg)
    state = trainer.fit(pb, port_scene(jax_scene), num_steps=30)
    assert state.step == 30
    losses = trainer.metrics.series("loss")
    assert len(losses) == 3 and losses[-1] < losses[0]
    assert trainer.metrics.series("psnr") and np.isfinite(trainer.metrics.series("psnr")).all()


def test_evaluate_psnr_matches_jax(jax_scene):
    jmodel, params, model = make_models()
    kw = dict(num_coarse_samples=8, num_fine_samples=8, near=2.0, far=6.0, rays_per_tile=64)
    image_w, psnr_w = jax_evaluate(jmodel, jax.tree_util.tree_map(jnp.asarray, params),
                                   jax_scene, JaxRender(**kw), view_index=1)
    image, value = evaluate(model, port_scene(jax_scene), RenderConfig(**kw), view_index=1)
    assert image.shape == (1, 12, 12, 3)
    np.testing.assert_allclose(image.numpy(), np.asarray(image_w), atol=1e-4)
    np.testing.assert_allclose(float(value), float(psnr_w), rtol=1e-4)
