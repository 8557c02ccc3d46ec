"""The port's mip-family ops held against the JAX package on the CPU: the
IPE encoders (every branch), ``sample_log_bbox``, the mip compositing
functions, ``MipMLP`` against ``apply_mip_mlp``, its parameter count and
the weight carry-across round trip.

Inputs come from numpy seeds and go through both packages.  Tolerances:
float32 elementwise math in another order (XLA fuses and may contract to
FMAs where PyTorch runs op by op) is held to rtol 1e-5 / atol 1e-6 on
values of order 1; the IPE features, whose arguments reach 2^11 times the
means, to atol 2e-4 (a 1-ulp difference of a mean near 30 is 4e-6 before
the scaling).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu import MipNeRF as JaxMipNeRF
from nerf_tpu import MipNeRFConfig as JaxMipConfig
from nerf_tpu.models import mlp as jmlp
from nerf_tpu.ops import compositing as jcomp
from nerf_tpu.ops import encoding as jenc
from nerf_tpu.ops import sampling as jsamp
from nerf_tpu_torch import MipNeRFConfig
from nerf_tpu_torch.models.mlp import MipMLP, count_params
from nerf_tpu_torch.ops import compositing as tcomp
from nerf_tpu_torch.ops import encoding as tenc
from nerf_tpu_torch.ops import sampling as tsamp
from nerf_tpu_torch.utils.pth_import import (
    jax_params_from_mip_state_dict,
    mip_state_dict_from_jax_params,
)

CLOSE = dict(rtol=1e-5, atol=1e-6)
SMALL = dict(hidden_size=32, num_hidden_layers=3, encoding_size=8, segmentation_outputs=5)


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def rays(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32))


def log_tvals(n, s, seed=0):
    rng = np.random.default_rng(seed)
    t_vals = np.sort(rng.uniform(0.1, 60.0, size=(n, s)), -1)
    return t_vals.astype(np.float32)


# -- encoding ---------------------------------------------------------------


def test_expected_sin_matches():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(50,)).astype(np.float32) * 5
    var = rng.uniform(0, 3, size=(50,)).astype(np.float32)
    for ours, ref in zip(tenc.expected_sin(t(x), t(var)), jenc.expected_sin(x, var)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **CLOSE)


@pytest.mark.parametrize("diag", [True, False])
def test_lift_gaussian_matches(diag):
    rng = np.random.default_rng(1)
    d = rng.normal(size=(4, 3)).astype(np.float32)
    t_mean = rng.uniform(1, 5, size=(4, 6)).astype(np.float32)
    t_var = rng.uniform(0, 1, size=(4, 6)).astype(np.float32)
    r_var = rng.uniform(0, 1, size=(4, 6)).astype(np.float32)
    ours = tenc.lift_gaussian(t(d), t(t_mean), t(t_var), t(r_var), diag)
    ref = jenc.lift_gaussian(d, t_mean, t_var, r_var, diag)
    for o, r in zip(ours, ref):
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **CLOSE)


@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("diag", [True, False])
def test_conical_frustum_matches(stable, diag):
    rng = np.random.default_rng(2)
    d = rng.normal(size=(3, 3)).astype(np.float32)
    t_vals = np.sort(rng.uniform(1, 4, size=(3, 9)), -1).astype(np.float32)
    args = (t_vals[:, :-1], t_vals[:, 1:], 0.003)
    ours = tenc.conical_frustum_to_gaussian(t(d), *map(t, args[:2]), args[2], diag, stable)
    ref = jenc.conical_frustum_to_gaussian(d, *args, diag=diag, stable=stable)
    # The unstable closed form's variance is E[t^2] - E[t]^2 of values near
    # 4: float32 cancellation leaves an absolute error of ~1e-4 in either
    # package, unrelated between them.
    tol = CLOSE if stable else dict(rtol=0, atol=3e-4)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **tol)


@pytest.mark.parametrize("diag", [True, False])
def test_cylinder_matches(diag):
    rng = np.random.default_rng(3)
    d = rng.normal(size=(3, 3)).astype(np.float32)
    t_vals = np.sort(rng.uniform(1, 4, size=(3, 9)), -1).astype(np.float32)
    ours = tenc.cylinder_to_gaussian(t(d), t(t_vals[:, :-1]), t(t_vals[:, 1:]), 0.01, diag)
    ref = jenc.cylinder_to_gaussian(d, t_vals[:, :-1], t_vals[:, 1:], 0.01, diag)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **CLOSE)


@pytest.mark.parametrize("ray_shape", ["cone", "cylinder"])
def test_cast_rays_matches(ray_shape):
    o, d = rays(5)
    t_vals = log_tvals(5, 12)
    ours = tenc.cast_rays(t(t_vals), t(o), t(d), 0.005, ray_shape)
    ref = jenc.cast_rays(t_vals, o, d, 0.005, ray_shape)
    for a, b in zip(ours, ref):
        assert a.shape == (5, 11, 3)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="ray_shape"):
        tenc.cast_rays(t(t_vals), t(o), t(d), 0.005, "sphere")


def test_integrated_pos_enc_matches_and_keeps_layout():
    rng = np.random.default_rng(4)
    means = rng.normal(size=(6, 7, 3)).astype(np.float32) * 3
    covs = rng.uniform(0, 0.01, size=(6, 7, 3)).astype(np.float32)
    ours = tenc.integrated_pos_enc(t(means), t(covs), -4, 12)
    ref = np.asarray(jenc.integrated_pos_enc(means, covs, -4, 12))
    assert ours.shape == ref.shape == (6, 7, 96)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=2e-4)
    # Scale outer, coordinate inner, sin block then cos block: feature 3 is
    # coordinate 0 at the second scale, and 48 + j is feature j's cosine.
    y = means[..., 0] * 2.0 ** -3
    np.testing.assert_allclose(ours[..., 3].numpy(),
                               np.exp(-0.5 * covs[..., 0] * 2.0 ** -6) * np.sin(y), atol=1e-5)
    np.testing.assert_allclose(ours[..., 48 + 3].numpy(),
                               np.exp(-0.5 * covs[..., 0] * 2.0 ** -6) * np.cos(y), atol=1e-5)


def test_mip_integrated_pe_matches():
    """``MipNeRF.integrated_pe``: cone radius from ``focal_length``, the
    degrees from ``encoding_size``."""
    from nerf_tpu_torch import MipNeRF

    cfg = MipNeRFConfig(**SMALL)
    o, d = rays(4, seed=5)
    t_vals = log_tvals(4, 10, seed=5)
    ours = MipNeRF(cfg, device="cpu").integrated_pe(t(o), t(d), t(t_vals))
    ref = JaxMipNeRF(JaxMipConfig(**SMALL)).integrated_pe(o, d, t_vals)
    for a, b, tol in zip(ours, ref, (1e-5, 1e-6, 2e-4)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=tol)


# -- sampling -----------------------------------------------------------------


@pytest.mark.parametrize("num_samples", [14, 64])
def test_sample_log_bbox_deterministic_within_ulps(num_samples):
    """The fenceposts carry the rounding of each package's linspace: the
    port's are within 7 ulp of the JAX package's (XLA's jnp.linspace and
    torch.linspace round the exponents differently, and 2^x magnifies
    that), hence the tests of the model feed the JAX t-values."""
    diag = MipNeRFConfig().bbox_diagonal
    ours = tsamp.sample_log_bbox(None, (2,), num_samples, diag, randomly_sample=False,
                                 device="cpu").numpy()
    ref = np.asarray(jsamp.sample_log_bbox(None, (2,), num_samples, diag,
                                           randomly_sample=False))
    assert tsamp.LOG_SAMPLING_MIN_EXPONENT == jsamp.LOG_SAMPLING_MIN_EXPONENT
    ulps = np.abs(ours.view(np.int32).astype(np.int64) - ref.view(np.int32).astype(np.int64))
    assert ulps.max() <= 7
    np.testing.assert_allclose(ours[:, 0], diag * 2.0 ** -9.43633744014, rtol=1e-6)
    np.testing.assert_allclose(ours[:, -1], diag, rtol=1e-6)


def test_sample_log_bbox_with_given_jitter():
    diag = MipNeRFConfig().bbox_diagonal
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jsamp.sample_log_bbox(key, (5,), 16, diag))
    u = np.asarray(jax.random.uniform(key, (5, 16)))
    ours = tsamp.sample_log_bbox(None, (5,), 16, diag, device="cpu", u=t(u)).numpy()
    # The jitter is the same; the fenceposts under it differ by ulps.
    np.testing.assert_allclose(ours, ref, rtol=2e-6, atol=0)
    assert np.all(np.diff(ours, axis=-1) >= 0)


def test_draw_step_makes_mip_draws():
    from nerf_tpu_torch import RenderConfig

    render = RenderConfig(num_coarse_samples=16, randomly_sample=True, density_noise_std=1.0)
    gen = torch.Generator().manual_seed(0)
    draws = tsamp.draw_step(gen, render, 8, "cpu", bbox_diagonal=MipNeRFConfig().bbox_diagonal)
    assert draws.t_coarse.shape == (8, 16) and draws.noise_c.shape == (8, 15)
    assert draws.u is None and draws.noise_f is None
    assert bool((draws.t_coarse[:, 0] >= 0.09).all())


# -- compositing --------------------------------------------------------------


def test_distances_from_points_matches():
    rng = np.random.default_rng(6)
    pts = rng.normal(size=(4, 9, 3)).astype(np.float32)
    ours = tcomp.distances_from_points(t(pts)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jcomp.distances_from_points(pts)), **CLOSE)
    assert np.all(ours[:, -1] == np.float32(1e10))


def test_compositing_weights_and_segmentation_match():
    rng = np.random.default_rng(7)
    pts = np.cumsum(rng.uniform(0, 1, size=(4, 9, 3)), axis=1).astype(np.float32)
    density = rng.normal(size=(4, 9, 1)).astype(np.float32) * 2
    seg = rng.normal(size=(4, 9, 5)).astype(np.float32) * 3
    w = tcomp.compositing_weights(t(pts), t(density))
    w_ref = np.asarray(jcomp.compositing_weights(pts, density))
    np.testing.assert_allclose(w.numpy(), w_ref, **CLOSE)
    ours = tcomp.composite_segmentation(w, t(seg)).numpy()
    ref = np.asarray(jcomp.composite_segmentation(w_ref, seg))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


# -- the MLP ------------------------------------------------------------------


def jax_mip_params(kwargs, seed=0):
    cfg = JaxMipConfig(**kwargs)
    return jax.tree_util.tree_map(np.asarray, jmlp.init_mip_mlp(jax.random.PRNGKey(seed), cfg))


def test_mip_mlp_matches_apply_mip_mlp():
    params = jax_mip_params(SMALL)
    mlp = MipMLP(MipNeRFConfig(**SMALL), device="cpu")
    mlp.load_state_dict(mip_state_dict_from_jax_params(params))
    feat = np.random.default_rng(8).normal(size=(6, 10, 24)).astype(np.float32)
    with torch.no_grad():
        ours = mlp(t(feat))
    ref = jmlp.apply_mip_mlp(params, JaxMipConfig(**SMALL), feat)
    for name, o, r in zip(("density", "color", "segmentation"), ours, ref):
        assert o.shape == r.shape, name
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5, err_msg=name)


def test_mip_mlp_parameter_count_and_init():
    mlp = MipMLP(MipNeRFConfig(), generator=torch.Generator().manual_seed(0), device="cpu")
    assert count_params(mlp) == 304_438 == jmlp.count_params(jax_mip_params({}))
    largest = float(mlp.prediction_heads[0].weight.detach().abs().max())
    assert 0.9 / math.sqrt(96) < largest <= 1.0 / math.sqrt(96)
    assert bool((mlp.prediction_heads[1].weight == 1).all())  # LayerNorm at identity
    again = MipMLP(MipNeRFConfig(), generator=torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(mlp.parameters(), again.parameters()))


def test_mip_weight_carry_across_round_trip():
    params = jax_mip_params(SMALL, seed=1)
    sd = mip_state_dict_from_jax_params(params)
    mlp = MipMLP(MipNeRFConfig(**SMALL), device="cpu")
    mlp.load_state_dict(sd)  # every key and shape of the module
    back = jax_params_from_mip_state_dict(mlp.state_dict(), MipNeRFConfig(**SMALL))
    flat_a, tree_a = jax.tree_util.tree_flatten(params)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert jnp.asarray(back["out"]["w"]).shape == (32, 9)
