"""The port's training kernels held against the JAX package on the CPU:
K1-bwd (``classic_mlp.classic_mlp_bwd``), K2
(``train_grads.classic_train_grads``), K3
(``fine_stage_train.fine_stage_train``); the reuse step is in
``test_torch_train_reuse.py``.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
its Pallas kernels in interpret mode.  Tolerances are the JAX package's own
gradient tests' (``tests/test_fused_train.py``): losses rtol 1e-5,
gradients normalised by their largest entry atol 2e-4.  Those tests pin the
exact two-pass LayerNorm statistics (``fused_mlp._LN_STATS``); so does the
fixture here, restoring the old value after each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu import ClassicNeRF as JaxNeRF
from nerf_tpu import ClassicNeRFConfig as JaxConfig
from nerf_tpu.ops.pallas import fused_hier, fused_mlp, fused_train
from nerf_tpu_torch import ClassicNeRFConfig
from nerf_tpu_torch.models.mlp import ClassicMLP
from nerf_tpu_torch.ops import compositing
from nerf_tpu_torch.ops.kernels import _build, classic_mlp, fine_stage_train, train_grads
from nerf_tpu_torch.utils.pth_import import classic_state_dict_from_jax_params

LOSS_RTOL = 1e-5
GRAD_ATOL = 2e-4

VARIANTS = {
    "view": dict(hidden_size=64),
    "no_view": dict(hidden_size=64, use_viewdirs=False),
    "latent": dict(hidden_size=32, density_inputs=5, color_inputs=4),
}


@pytest.fixture(autouse=True)
def exact_ln_stats():
    prev = fused_mlp._LN_STATS
    fused_mlp._LN_STATS = "twopass"
    yield
    fused_mlp._LN_STATS = prev


def setup_variant(variant):
    kwargs = VARIANTS[variant]
    params = jax.tree_util.tree_map(
        np.asarray, JaxNeRF(JaxConfig(**kwargs)).init(jax.random.PRNGKey(0)))
    cfg = ClassicNeRFConfig(**kwargs)
    mlp = ClassicMLP(cfg, device="cpu")
    mlp.load_state_dict(classic_state_dict_from_jax_params(params))
    return cfg, params, classic_mlp.pack_classic_params(mlp.requires_grad_(False))


def assert_packed_close(got, jax_grads):
    """Port gradients (packed) against a JAX gradient pytree, packed the
    same way (packing is linear, so it maps gradients like weights)."""
    want = {k: np.asarray(v) for k, v in fused_mlp.pack_classic_params(jax_grads).items()}
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].detach().numpy().reshape(w.shape)
        scale = np.abs(w).max() + 1e-12
        np.testing.assert_allclose(g / scale, w / scale, atol=GRAD_ATOL, err_msg=k)


def assert_close_normalised(got, want, name):
    want = np.asarray(want)
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(np.asarray(got).reshape(want.shape) / scale, want / scale,
                               atol=GRAD_ATOL, err_msg=name)


def t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


# -- K1-bwd -----------------------------------------------------------------


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_classic_mlp_bwd_plain_matches_pallas_vjp(variant):
    cfg, params, packed = setup_variant(variant)
    rng = np.random.default_rng(0)
    n = 100
    x = rng.normal(size=(n, cfg.x_encoding_dim)).astype(np.float32)
    d = rng.normal(size=(n, cfg.d_encoding_dim)).astype(np.float32) if cfg.use_viewdirs else None
    g_out = rng.normal(size=(n, 1 + cfg.color_outputs)).astype(np.float32)

    def f(p, x, d):
        return fused_mlp.classic_mlp_pallas(p, x, d, interpret=True)

    if d is None:
        _, vjp = jax.vjp(lambda p, x: f(p, x, None), params, jnp.asarray(x))
        gp, gx = vjp((jnp.asarray(g_out[:, :1]), jnp.asarray(g_out[:, 1:])))
        gd = None
    else:
        _, vjp = jax.vjp(f, params, jnp.asarray(x), jnp.asarray(d))
        gp, gx, gd = vjp((jnp.asarray(g_out[:, :1]), jnp.asarray(g_out[:, 1:])))
    before = dict(_build.launch_counts)
    dx, dd, d_packed = classic_mlp.classic_mlp_bwd(packed, t(x), t(d), t(g_out))
    assert dict(_build.launch_counts) == before  # the plain version launches nothing
    assert_packed_close(d_packed, gp)
    assert_close_normalised(dx.numpy(), gx, "dx")
    if d is not None:
        assert_close_normalised(dd.numpy(), gd, "dd")
    # Without the encodings' cotangents, as autograd asks when they need none.
    dx, dd, d_packed = classic_mlp.classic_mlp_bwd(packed, t(x), t(d), t(g_out),
                                                   input_grads=False)
    assert dx is None and dd is None
    assert_packed_close(d_packed, gp)


# -- K2 ---------------------------------------------------------------------


def train_inputs(cfg, rays=8, s=8, seed=0):
    rng = np.random.default_rng(seed)
    t_vals = np.sort(rng.uniform(2, 6, size=(rays, s)), -1).astype(np.float32)
    rays_d = rng.normal(size=(rays, 3)).astype(np.float32)
    dists = compositing.distances_from_tvals(t(t_vals), t(rays_d)).numpy()
    d_ray = rng.normal(size=(rays, 1, cfg.d_encoding_dim)).astype(np.float32)
    return dict(
        x_enc=rng.normal(size=(rays, s, cfg.x_encoding_dim)).astype(np.float32),
        d_enc=np.broadcast_to(d_ray, (rays, s, cfg.d_encoding_dim)).copy()
        if cfg.use_viewdirs else None,
        dists=dists,
        noise=rng.normal(size=(rays, s)).astype(np.float32),
        pixels=rng.uniform(size=(rays, cfg.color_outputs)).astype(np.float32),
    )


@pytest.mark.parametrize("variant,white,with_weights", [
    ("view", False, False), ("view", True, True), ("no_view", False, True), ("latent", False, False),
])
def test_classic_train_grads_plain_matches_pallas(variant, white, with_weights):
    cfg, params, packed = setup_variant(variant)
    a = train_inputs(cfg)
    ref = fused_train.classic_train_grads_pallas(
        params, *[None if v is None else jnp.asarray(v) for v in a.values()], 8,
        white_background=white, loss_weight=0.5, return_weights=with_weights, interpret=True,
    )
    got = train_grads.classic_train_grads(
        packed, **{k: t(v) for k, v in a.items()}, num_samples=8,
        white_background=white, loss_weight=0.5, return_weights=with_weights,
    )
    assert len(got) == len(ref) == (3 if with_weights else 2)
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=LOSS_RTOL)
    assert_packed_close(got[1], ref[1])
    if with_weights:
        np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-4, atol=1e-6)


# -- K3 ---------------------------------------------------------------------


def fine_inputs(cfg, rays=4, sc=8, sf=8, noise=True, seed=0):
    rng = np.random.default_rng(seed)
    t_c = np.sort(rng.uniform(2, 6, size=(rays, sc)), -1).astype(np.float32)
    t_f = rng.uniform(2, 6, size=(rays, sf)).astype(np.float32)
    t_f[:, 1] = t_c[:, min(3, sc - 1)]  # a tie: the coarse sample sorts first
    t_f = np.sort(t_f, -1)
    d_ray = rng.normal(size=(rays, 1, cfg.d_encoding_dim)).astype(np.float32)
    return dict(
        x_enc=rng.normal(size=(rays, sf, cfg.x_encoding_dim)).astype(np.float32),
        d_enc=np.broadcast_to(d_ray, (rays, sf, cfg.d_encoding_dim)).copy()
        if cfg.use_viewdirs else None,
        t_coarse=t_c, t_fine=t_f,
        dens_c=(rng.normal(size=(rays, sc, 1)) * 3).astype(np.float32),
        col_c=rng.normal(size=(rays, sc, cfg.color_outputs)).astype(np.float32),
        dnorm=rng.uniform(0.5, 2.0, size=(rays,)).astype(np.float32),
        noise_f=(rng.normal(size=(rays, sf)) if noise else np.zeros((rays, sf))).astype(np.float32),
        pixels=rng.uniform(size=(rays, cfg.color_outputs)).astype(np.float32),
    )


@pytest.mark.parametrize("variant,sc,sf,noise,white", [
    ("view", 8, 8, True, False), ("view", 8, 8, False, True), ("view", 7, 11, True, False),
    ("no_view", 8, 8, True, False), ("latent", 7, 11, True, True),
])
def test_fine_stage_train_plain_matches_pallas(variant, sc, sf, noise, white):
    cfg, params, packed = setup_variant(variant)
    a = fine_inputs(cfg, sc=sc, sf=sf, noise=noise)
    loss_r, grads_r, (gdc_r, gcc_r) = fused_hier.fine_stage_train_pallas(
        params, *[None if v is None else jnp.asarray(v) for v in a.values()],
        white_background=white, loss_weight=0.5, interpret=True,
    )
    loss, d_packed, (gdc, gcc) = fine_stage_train.fine_stage_train(
        packed, **{k: t(v) for k, v in a.items()}, white_background=white, loss_weight=0.5,
    )
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=LOSS_RTOL)
    assert_packed_close(d_packed, grads_r)
    assert_close_normalised(gdc.numpy(), gdc_r, "g_dens_c")
    assert_close_normalised(gcc.numpy(), gcc_r, "g_col_c")
