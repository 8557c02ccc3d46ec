"""The PyTorch port's ops held against the JAX package on the CPU:
configs, the classic frequency encoding, cameras, samplers and the
compositing quadrature.  Inputs come from numpy seeds and go through both
packages; each tolerance is stated where it is used, with its reason.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu import config as jcfg
from nerf_tpu.ops import cameras as jcam
from nerf_tpu.ops import compositing as jcomp
from nerf_tpu.ops import encoding as jenc
from nerf_tpu.ops import sampling as jsamp
from nerf_tpu_torch import config as tcfg
from nerf_tpu_torch.ops import cameras as tcam
from nerf_tpu_torch.ops import compositing as tcomp
from nerf_tpu_torch.ops import encoding as tenc
from nerf_tpu_torch.ops import sampling as tsamp


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def npy(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- config ---------------------------------------------------------------

CONFIGS = [
    ("ClassicNeRFConfig", {}),
    ("ClassicNeRFConfig", dict(hidden_size=64, use_viewdirs=False,
                               normalize_position=6.0, use_pallas=True)),
    ("MipNeRFConfig", {}),
    ("RenderConfig", {}),
    ("RenderConfig", dict(num_fine_samples=128, randomly_sample=False)),
    ("TrainConfig", {}),
    ("MeshConfig", {}),
]


@pytest.mark.parametrize("name,kwargs", CONFIGS)
def test_config_to_json_identical(name, kwargs):
    ours = tcfg.config_to_json(getattr(tcfg, name)(**kwargs))
    ref = jcfg.config_to_json(getattr(jcfg, name)(**kwargs))
    assert ours == ref


def test_config_fields_and_properties_match():
    for name in ("ClassicNeRFConfig", "MipNeRFConfig", "RenderConfig",
                 "TrainConfig", "MeshConfig"):
        ours = [f.name for f in dataclasses.fields(getattr(tcfg, name))]
        ref = [f.name for f in dataclasses.fields(getattr(jcfg, name))]
        assert ours == ref, name
    c_ref, c_ours = jcfg.ClassicNeRFConfig(), tcfg.ClassicNeRFConfig()
    for prop in ("x_encoding_dim", "d_encoding_dim", "direction_bound"):
        assert getattr(c_ours, prop) == getattr(c_ref, prop)
    m_ref, m_ours = jcfg.MipNeRFConfig(), tcfg.MipNeRFConfig()
    for prop in ("min_deg", "max_deg", "feature_dim", "num_outputs",
                 "bbox_diagonal"):
        assert getattr(m_ours, prop) == getattr(m_ref, prop)


# -- encoding -------------------------------------------------------------


def _ulp_distance(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


@pytest.mark.parametrize("size", [12, 20])
@pytest.mark.parametrize("bound", [6.0, 20.0])
def test_frequency_scales_within_2_ulp(size, bound):
    # The JAX constants carry XLA's rounding of jnp.linspace, which torch
    # does not reproduce bitwise; 2 ulp is the agreed bound for serving.
    ours = tenc.frequency_scales_np(size, bound)
    ref = jenc.frequency_scales_np(size, bound)
    assert ours.dtype == np.float32 and ours.shape == ref.shape == (size // 2,)
    assert _ulp_distance(ours, ref).max() <= 2
    scales = tenc.bbox_frequency_scales(size, bound, device="cpu")
    np.testing.assert_array_equal(scales.numpy(), ours)


@pytest.mark.parametrize("dims", [3, 5])
def test_frequency_encoding_with_jax_constants(dims):
    # Given the same constants the encodings differ only by sin/cos
    # rounding of the two libraries (a few ulp of values in [-1, 1]).
    rng = np.random.default_rng(0)
    x = rng.uniform(-4, 4, size=(7, 11, dims)).astype(np.float32)
    scales = jenc.frequency_scales_np(20, 6.0)
    ref = jenc.frequency_encoding(jnp.asarray(x), jnp.asarray(scales))
    ours = tenc.frequency_encoding(t(x), t(scales))
    assert ours.shape == ref.shape == (7, 11, dims * 20)
    np.testing.assert_allclose(npy(ours), np.asarray(ref), rtol=0, atol=1e-6)


# -- cameras --------------------------------------------------------------


def test_generate_rays():
    ours = tcam.generate_rays(5, 7, 3.5, device="cpu")
    ref = jcam.generate_rays(5, 7, 3.5)
    np.testing.assert_allclose(npy(ours), np.asarray(ref), rtol=1e-6, atol=0)


def test_spherical_and_rotation():
    rng = np.random.default_rng(1)
    yaw = rng.uniform(0, 2 * np.pi, 9).astype(np.float32)
    el = rng.uniform(-1.2, 1.2, 9).astype(np.float32)
    eye_ref = jcam.spherical_to_cartesian(jnp.asarray(yaw), jnp.asarray(el))
    eye = tcam.spherical_to_cartesian(t(yaw), t(el))
    np.testing.assert_allclose(npy(eye), np.asarray(eye_ref), atol=1e-6)
    up = rng.normal(size=(9, 3)).astype(np.float32)
    np.testing.assert_allclose(
        npy(tcam.get_rotation_matrix(eye, t(up))),
        np.asarray(jcam.get_rotation_matrix(eye_ref, jnp.asarray(up))),
        atol=1e-6,
    )


def test_direction_to_rotation_matrix_with_degenerate_up():
    rng = np.random.default_rng(2)
    dirs = rng.normal(size=(8, 3)).astype(np.float32)
    dirs[0] = [0.0, 0.0, 3.0]  # straight up: falls back to +y
    dirs[1] = [0.0, 0.0, -1.0]
    ours = tcam.direction_to_rotation_matrix(t(dirs))
    ref = jcam.direction_to_rotation_matrix(jnp.asarray(dirs))
    np.testing.assert_allclose(npy(ours), np.asarray(ref), atol=1e-6)


def test_pose_to_rays():
    rng = np.random.default_rng(3)
    pose_o = rng.normal(size=(2, 3)).astype(np.float32) * 4
    pose_r = np.asarray(jcam.direction_to_rotation_matrix(jnp.asarray(-pose_o)))
    ro_ref, rd_ref = jcam.pose_to_rays(jnp.asarray(pose_o), jnp.asarray(pose_r), 6, 5, 4.0)
    ro, rd = tcam.pose_to_rays(t(pose_o), t(pose_r), 6, 5, 4.0)
    assert ro.shape == rd.shape == (2, 6, 5, 3)
    np.testing.assert_allclose(npy(ro), np.asarray(ro_ref), atol=0)
    np.testing.assert_allclose(npy(rd), np.asarray(rd_ref), atol=1e-6)


def test_ndc_rays():
    rng = np.random.default_rng(4)
    ro = rng.normal(size=(16, 3)).astype(np.float32) * 0.1
    rd = rng.normal(size=(16, 3)).astype(np.float32)
    rd[:, 2] = -np.abs(rd[:, 2]) - 0.5  # forward-facing, looking down -z
    o_ref, d_ref = jcam.ndc_rays(jnp.asarray(ro), jnp.asarray(rd), 24, 32, 30.0)
    o, d = tcam.ndc_rays(t(ro), t(rd), 24, 32, 30.0)
    np.testing.assert_allclose(npy(o), np.asarray(o_ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(npy(d), np.asarray(d_ref), rtol=1e-5, atol=1e-6)


# -- sampling -------------------------------------------------------------


def test_sample_linear_deterministic():
    ours = tsamp.sample_linear(None, (3, 2), 64, 2.0, 6.0, randomly_sample=False, device="cpu")
    ref = jsamp.sample_linear(None, (3, 2), 64, 2.0, 6.0, randomly_sample=False)
    assert ours.shape == (3, 2, 64)
    np.testing.assert_allclose(npy(ours), np.asarray(ref), rtol=0, atol=1e-6)


def test_sample_linear_jitter_stays_in_bins():
    gen = torch.Generator().manual_seed(0)
    det = tsamp.sample_linear(None, (512,), 16, 2.0, 6.0, randomly_sample=False, device="cpu")
    jit = tsamp.sample_linear(gen, (512,), 16, 2.0, 6.0, device="cpu")
    mids = 0.5 * (det[..., 1:] + det[..., :-1])
    lower = torch.cat([det[..., :1], mids], -1)
    upper = torch.cat([mids, det[..., -1:]], -1)
    assert torch.all(jit >= lower - 1e-6) and torch.all(jit <= upper + 1e-6)
    assert torch.all(jit[..., 1:] >= jit[..., :-1])
    with pytest.raises(ValueError):
        tsamp.sample_linear(None, (2,), 4, 2.0, 6.0, device="cpu")


def test_pdf_uniforms_deterministic():
    ours = tsamp.pdf_uniforms(None, (4,), 24, randomly_sample=False, device="cpu")
    ref = jsamp.pdf_uniforms(None, (4,), 24, randomly_sample=False)
    np.testing.assert_array_equal(npy(ours), np.asarray(ref))


def _pdf_inputs(seed=0):
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.uniform(2, 6, size=(64, 17)).astype(np.float32), -1)
    w = rng.exponential(size=(64, 16)).astype(np.float32)
    w[:5] = 0.0  # empty rays sample the eps-uniform pdf
    w[5:10, 3] = 50.0  # one dominant bin
    return bins, w


def test_sample_pdf_deterministic():
    # The cdf is summed in another order (torch.cumsum vs the JAX doubling
    # ladder).  A cdf ulp moves t by ulp * bin width / bin mass, so the few
    # low-mass bins beside the 50x bin amplify it to ~1e-5 of t in [2, 6].
    bins, w = _pdf_inputs()
    ref = jsamp.sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), 24, randomly_sample=False)
    ours = tsamp.sample_pdf(None, t(bins), t(w), 24, randomly_sample=False)
    assert ours.shape == (64, 24)
    np.testing.assert_allclose(npy(ours), np.asarray(ref), rtol=0, atol=1e-4)
    assert torch.all(ours[..., 1:] >= ours[..., :-1])


def test_sample_pdf_with_jax_uniforms():
    bins, w = _pdf_inputs(1)
    key = jax.random.PRNGKey(7)
    u = jsamp.pdf_uniforms(key, (64,), 32)
    ref = jsamp.sample_pdf(key, jnp.asarray(bins), jnp.asarray(w), 32)
    ours = tsamp.sample_pdf(None, t(bins), t(w), 32, u=t(u))
    # Same tolerance and reason as the deterministic case.
    np.testing.assert_allclose(npy(ours), np.asarray(ref), rtol=0, atol=1e-4)


def test_sample_pdf_closed_top_edge():
    # A uniform that rounds to exactly 1.0 lands in the last bin, not at 0.
    bins, w = _pdf_inputs(2)
    u = np.full((64, 1), 1.0, np.float32)
    ours = tsamp.sample_pdf(None, t(bins), t(w), 1, u=t(u))
    np.testing.assert_allclose(npy(ours)[:, 0], bins[:, -1], rtol=1e-6)


def test_merge_samples_keeps_ties():
    rng = np.random.default_rng(5)
    coarse = np.sort(rng.uniform(2, 6, size=(8, 16)).astype(np.float32), -1)
    fine = np.sort(rng.uniform(2, 6, size=(8, 24)).astype(np.float32), -1)
    fine[:, 3] = coarse[:, 5]
    fine = np.sort(fine, -1)
    ours = tsamp.merge_samples(t(coarse), t(fine))
    ref = jsamp.merge_samples(jnp.asarray(coarse), jnp.asarray(fine))
    np.testing.assert_array_equal(npy(ours), np.asarray(ref))


# -- compositing ----------------------------------------------------------


def _ray_inputs(seed=0, rays=16, sc=16, sf=24, tie=True):
    rng = np.random.default_rng(seed)
    t_c = np.sort(rng.uniform(2, 6, size=(rays, sc)).astype(np.float32), -1)
    t_f = np.sort(rng.uniform(2, 6, size=(rays, sf)).astype(np.float32), -1)
    if tie:
        # Fine samples exactly on coarse fenceposts (an inverse-CDF sample
        # landing on a bin edge): coarse sorts first.
        t_f[:, 4] = t_c[:, 7]
        t_f[0, :] = t_c[0, 3]
        t_f = np.sort(t_f, -1)
    rays_d = rng.normal(size=(rays, 3)).astype(np.float32)
    dens_c = (rng.normal(size=(rays, sc, 1)) * 3).astype(np.float32)
    dens_f = (rng.normal(size=(rays, sf, 1)) * 3).astype(np.float32)
    col = rng.normal(size=(rays, sc + sf, 3)).astype(np.float32)
    return t_c, t_f, rays_d, dens_c, dens_f, col


def test_distances_and_weights_from_density():
    t_c, _, rays_d, dens_c, _, col = _ray_inputs(tie=False)
    dists_ref = jcomp.distances_from_tvals(jnp.asarray(t_c), jnp.asarray(rays_d))
    dists = tcomp.distances_from_tvals(t(t_c), t(rays_d))
    np.testing.assert_allclose(npy(dists), np.asarray(dists_ref), rtol=1e-6)
    w_ref = jcomp.weights_from_density(jnp.asarray(dens_c), dists_ref)
    w = tcomp.weights_from_density(t(dens_c), dists)
    # cumprod vs the JAX doubling-ladder product: reassociation only.
    np.testing.assert_allclose(npy(w), np.asarray(w_ref), rtol=1e-5, atol=1e-7)
    col_c = col[:, :16]
    for bg in (None, 1.0):
        np.testing.assert_allclose(
            npy(tcomp.composite_rgb_with_background(w, t(col_c), bg)),
            np.asarray(jcomp.composite_rgb_with_background(w_ref, jnp.asarray(col_c), bg)),
            rtol=1e-5, atol=1e-6,
        )
    np.testing.assert_allclose(
        npy(tcomp.composite_depth(w, t(t_c))),
        np.asarray(jcomp.composite_depth(w_ref, jnp.asarray(t_c))), rtol=1e-5, atol=1e-6,
    )
    np.testing.assert_allclose(
        npy(tcomp.composite_acc(w)), np.asarray(jcomp.composite_acc(w_ref)),
        rtol=1e-5, atol=1e-6,
    )


@pytest.mark.parametrize("tie", [False, True])
def test_union_dists_sorted(tie):
    t_c, t_f, rays_d, *_ = _ray_inputs(tie=tie)
    dc_ref, df_ref = jcomp.union_dists_sorted(
        jnp.asarray(t_c), jnp.asarray(t_f), jnp.asarray(rays_d)
    )
    dc, df = tcomp.union_dists_sorted(t(t_c), t(t_f), t(rays_d))
    np.testing.assert_allclose(npy(dc), np.asarray(dc_ref), rtol=1e-6)
    np.testing.assert_allclose(npy(df), np.asarray(df_ref), rtol=1e-6)
    if tie:
        # The coarse sample tied with a fine one gets the zero interval.
        assert np.any(npy(dc) == 0.0)


@pytest.mark.parametrize("tie", [False, True])
def test_weights_from_union_sorted(tie):
    t_c, t_f, rays_d, dens_c, dens_f, _ = _ray_inputs(seed=6, tie=tie)
    ref = jcomp.weights_from_union_sorted(
        jnp.asarray(dens_c), jnp.asarray(dens_f), jnp.asarray(t_c),
        jnp.asarray(t_f), jnp.asarray(rays_d),
    )
    ours = tcomp.weights_from_union_sorted(t(dens_c), t(dens_f), t(t_c), t(t_f), t(rays_d))
    assert ours.shape == (16, 40, 1)
    # exp of summed logs, summed in another order: reassociation only.
    np.testing.assert_allclose(npy(ours), np.asarray(ref), rtol=1e-5, atol=1e-6)
    assert float(ours.sum(-2).max()) <= 1.0 + 1e-5
