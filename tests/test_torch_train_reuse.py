"""The port's hierarchical-reuse train step
(``fine_stage_train.reuse_train_loss_and_grads``: K1-fwd, K3 and one
K1-bwd) held against the JAX package's ``fused_hier.
reuse_train_loss_and_grads`` on the CPU, with the JAX step's random draws
made from its key and handed to the port.

Tolerances and the two-pass LayerNorm fixture are those of
``test_torch_train_kernels.py``.  The JAX step runs eagerly, as the JAX
package's own reuse tests run it: under ``jax.jit`` XLA rounds the
resampler's sums otherwise, and the fine samples move with them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu import ClassicNeRF as JaxNeRF
from nerf_tpu import ClassicNeRFConfig as JaxConfig
from nerf_tpu import RenderConfig as JaxRender
from nerf_tpu.ops import encoding as jenc
from nerf_tpu.ops import sampling as jsampling
from nerf_tpu.ops.pallas import fused_hier, fused_mlp
from nerf_tpu_torch import ClassicNeRF, ClassicNeRFConfig, RenderConfig
from nerf_tpu_torch.ops import sampling
from nerf_tpu_torch.ops.kernels import fine_stage_train
from nerf_tpu_torch.utils.pth_import import classic_state_dict_from_jax_params

LOSS_RTOL = 1e-5
GRAD_ATOL = 2e-4


@pytest.fixture(autouse=True)
def exact_ln_stats():
    prev = fused_mlp._LN_STATS
    fused_mlp._LN_STATS = "twopass"
    yield
    fused_mlp._LN_STATS = prev


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_close_normalised(got, want, name):
    want = np.asarray(want)
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(np.asarray(got).reshape(want.shape) / scale, want / scale,
                               atol=GRAD_ATOL, err_msg=name)


# -- the reuse step ---------------------------------------------------------


def make_models(**kwargs):
    """JAX and port models with the same weights, the density head biased
    to a positive density (no empty coarse bin: see test_torch_render.py),
    and the JAX package's frequency constants in the port."""
    kwargs = dict(dict(hidden_size=64, normalize_position=6.0, use_pallas=True), **kwargs)
    jmodel = JaxNeRF(JaxConfig(**kwargs))
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    params["density"] = {"w": params["density"]["w"] * np.float32(0.05),
                         "b": np.full_like(params["density"]["b"], 0.5)}
    cfg = ClassicNeRFConfig(**kwargs)
    model = ClassicNeRF(cfg, device="cpu")
    model.mlp.load_state_dict(classic_state_dict_from_jax_params(params))
    model.x_scales.copy_(torch.tensor(
        jenc.frequency_scales_np(cfg.x_positional_encoding_size, cfg.normalize_position)))
    if cfg.use_viewdirs:
        model.d_scales.copy_(torch.tensor(
            jenc.frequency_scales_np(cfg.d_positional_encoding_size, cfg.direction_bound)))
    return jmodel, params, model


def jax_draws(key, render, n_rays):
    """The draws the JAX reuse step makes from ``key``
    (``fused_hier.py:844-902``), as a port ``StepDraws``."""
    k_strat, k_noise_c, k_pdf, k_noise_f = jax.random.split(key, 4)
    sc, sf, std = render.num_coarse_samples, render.num_fine_samples, render.density_noise_std
    t_coarse = jsampling.sample_linear(k_strat, (n_rays,), sc, render.near, render.far,
                                       randomly_sample=render.randomly_sample)
    u = jsampling.pdf_uniforms(k_pdf, (n_rays,), sf, randomly_sample=render.randomly_sample)
    noise_c = std * jax.random.normal(k_noise_c, (n_rays, sc))
    noise_f = std * jax.random.normal(k_noise_f, (n_rays, sf))
    return sampling.StepDraws(*(torch.from_numpy(np.array(v)) for v in
                                (t_coarse, noise_c, u, noise_f)))


def batch_arrays(n=16, seed=0, colors=3):
    rng = np.random.default_rng(seed)
    return dict(rays_o=(rng.normal(size=(n, 3)) * 0.3).astype(np.float32),
                rays_d=rng.normal(size=(n, 3)).astype(np.float32),
                pixels=rng.uniform(size=(n, colors)).astype(np.float32))


@pytest.mark.parametrize("sc,sf,white", [(8, 8, True), (7, 11, False)])
def test_reuse_train_loss_and_grads_matches_jax(sc, sf, white):
    jmodel, params, model = make_models()
    kw = dict(num_coarse_samples=sc, num_fine_samples=sf, near=2.0, far=6.0,
              randomly_sample=True, density_noise_std=1.0, white_background=white,
              reuse_coarse_in_fine=True)
    b = batch_arrays()
    key = jax.random.PRNGKey(7)
    loss_r, grads_r, aux_r = fused_hier.reuse_train_loss_and_grads(
        jmodel, params, JaxRender(**kw), {k: jnp.asarray(v) for k, v in b.items()}, key)
    loss, grads, aux = fine_stage_train.reuse_train_loss_and_grads(
        model, RenderConfig(**kw), {k: t(v) for k, v in b.items()},
        jax_draws(key, JaxRender(**kw), 16))
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux["fine_mse"]), float(aux_r["fine_mse"]), rtol=1e-4)
    sd = classic_state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, grads_r))
    assert set(grads) == {f"mlp.{k}" for k in sd}
    for k, want in sd.items():
        assert_close_normalised(grads[f"mlp.{k}"].numpy(), want.numpy(), k)
