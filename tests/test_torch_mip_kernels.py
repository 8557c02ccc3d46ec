"""The port's mip kernels held against the JAX package's Pallas kernels on
the CPU: K5-fwd and K5-bwd (``mip_mlp.mip_mlp_fwd`` / ``mip_mlp_bwd``
against ``fused_mip_mlp.mip_mlp_pallas`` and its VJP), K6
(``mip_train.mip_train_grads`` against ``mip_train_grads_pallas``) and K7
(``mip_train.mip_eval`` against ``mip_eval_pallas``).

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
its Pallas kernels in interpret mode.  The model is small (hidden 32, 3
layers, 8-wide encoding so 24 features, 3 colours and 5 classes); rays have
15 or 13 interval rows (16 or 14 fenceposts).  Tolerances: outputs and
losses rtol 1e-5 (float32 sums in another order); gradients normalised by
their largest entry within 3e-5, the JAX package's own bound for its mip
kernels (``tests/test_fused_mip_train.py``).  Those tests pin the exact
two-pass LayerNorm statistics (``fused_mlp._LN_STATS``); so does the
fixture here, restoring the old value after each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu import MipNeRFConfig as JaxMipConfig
from nerf_tpu.models import mlp as jmlp
from nerf_tpu.ops.pallas import fused_mip_mlp, fused_mip_train, fused_mlp
from nerf_tpu_torch import MipNeRFConfig
from nerf_tpu_torch.models.mlp import MipMLP
from nerf_tpu_torch.ops import compositing
from nerf_tpu_torch.ops.kernels import _build, mip_mlp, mip_train
from nerf_tpu_torch.utils.pth_import import mip_state_dict_from_jax_params

SMALL = dict(hidden_size=32, num_hidden_layers=3, encoding_size=8, segmentation_outputs=5)
OUT_RTOL = 1e-5
GRAD_ATOL = 3e-5


@pytest.fixture(autouse=True)
def exact_ln_stats():
    prev = fused_mlp._LN_STATS
    fused_mlp._LN_STATS = "twopass"
    yield
    fused_mlp._LN_STATS = prev


def setup_model(seed=0):
    params = jax.tree_util.tree_map(
        np.asarray, jmlp.init_mip_mlp(jax.random.PRNGKey(seed), JaxMipConfig(**SMALL)))
    rng = np.random.default_rng(seed)
    for layer in params["layers"]:  # LayerNorms off identity, so their gradients mean something
        layer["ln"] = {"scale": rng.uniform(0.5, 1.5, size=32).astype(np.float32),
                       "bias": rng.uniform(-0.3, 0.3, size=32).astype(np.float32)}
    cfg = MipNeRFConfig(**SMALL)
    mlp = MipMLP(cfg, device="cpu")
    mlp.load_state_dict(mip_state_dict_from_jax_params(params))
    return cfg, params, mip_mlp.pack_mip_params(mlp.requires_grad_(False))


def t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def assert_packed_close(got, jax_grads):
    """Port gradients (packed) against a JAX gradient pytree, packed the
    same way (packing is linear, so it maps gradients like weights)."""
    want = {k: np.asarray(v) for k, v in fused_mip_mlp.pack_mip_params(jax_grads).items()}
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].detach().numpy().reshape(w.shape)
        scale = np.abs(w).max() + 1e-12
        np.testing.assert_allclose(g / scale, w / scale, rtol=0, atol=GRAD_ATOL, err_msg=k)


# -- K5 -----------------------------------------------------------------------


def test_mip_mlp_fwd_plain_matches_pallas():
    cfg, params, packed = setup_model()
    feat = np.random.default_rng(1).normal(size=(100, cfg.feature_dim)).astype(np.float32)
    ref = fused_mip_mlp.mip_mlp_pallas(params, feat, 3, 3, interpret=True)
    before = dict(_build.launch_counts)
    out = mip_mlp.mip_mlp_fwd(packed, t(feat)).numpy()
    assert dict(_build.launch_counts) == before  # the plain version launches nothing
    np.testing.assert_allclose(out, np.concatenate([np.asarray(r) for r in ref], -1),
                               rtol=OUT_RTOL, atol=1e-6)


def test_mip_mlp_bwd_plain_matches_pallas_vjp():
    cfg, params, packed = setup_model(1)
    rng = np.random.default_rng(2)
    feat = rng.normal(size=(100, cfg.feature_dim)).astype(np.float32)
    g_out = rng.normal(size=(100, cfg.num_outputs)).astype(np.float32)
    _, vjp = jax.vjp(lambda p, x: fused_mip_mlp.mip_mlp_pallas(p, x, 3, 3, interpret=True),
                     params, jnp.asarray(feat))
    gp, gx = vjp((g_out[:, :1], g_out[:, 1:4], g_out[:, 4:]))
    dfeat, d_packed = mip_mlp.mip_mlp_bwd(packed, t(feat), t(g_out))
    assert_packed_close(d_packed, gp)
    scale = np.abs(np.asarray(gx)).max()
    np.testing.assert_allclose(dfeat.numpy() / scale, np.asarray(gx) / scale, atol=GRAD_ATOL)
    # Without the features' cotangent, as autograd asks when they need none.
    dfeat, d_packed = mip_mlp.mip_mlp_bwd(packed, t(feat), t(g_out), input_grads=False)
    assert dfeat is None
    assert_packed_close(d_packed, gp)


# -- K6 and K7 ----------------------------------------------------------------


def ray_inputs(cfg, rays=8, rows=15, noise=True, seed=0):
    rng = np.random.default_rng(seed)
    points = np.cumsum(rng.uniform(0.0, 1.0, size=(rays, rows, 3)), axis=1).astype(np.float32)
    return dict(
        features=rng.uniform(-1, 1, size=(rays, rows, cfg.feature_dim)).astype(np.float32),
        dists=compositing.distances_from_points(t(points)).numpy(),
        noise=(rng.normal(size=(rays, rows)) if noise else np.zeros((rays, rows)))
        .astype(np.float32),
        pixels=rng.uniform(size=(rays, 3)).astype(np.float32),
        labels=rng.integers(0, cfg.segmentation_outputs, size=(rays,)),
        t_mids=rng.uniform(0.1, 60.0, size=(rays, rows)).astype(np.float32),
    )


@pytest.mark.parametrize("seg_weight,noise,white,rows", [
    (0.1, True, False, 15), (0.0, False, False, 15), (0.25, True, True, 13),
])
def test_mip_train_grads_plain_matches_pallas(seg_weight, noise, white, rows):
    cfg, params, packed = setup_model(2)
    a = ray_inputs(cfg, rows=rows, noise=noise, seed=3)
    keys = ("features", "dists", "noise", "pixels", "labels")
    rgb_r, seg_r, grads_r = fused_mip_train.mip_train_grads_pallas(
        params, *[jnp.asarray(a[k]) for k in keys], 3, color_outputs=3,
        seg_weight=seg_weight, white_background=white, interpret=True)
    rgb, seg, d_packed = mip_train.mip_train_grads(
        packed, *[t(a[k]) for k in keys], color_outputs=3, seg_weight=seg_weight,
        white_background=white)
    np.testing.assert_allclose(float(rgb), float(rgb_r), rtol=OUT_RTOL)
    np.testing.assert_allclose(float(seg), float(seg_r), rtol=OUT_RTOL)
    assert (float(seg) == 0.0) == (seg_weight == 0.0)
    assert_packed_close(d_packed, grads_r)


@pytest.mark.parametrize("noise,white,rows", [(False, False, 15), (True, True, 13)])
def test_mip_eval_plain_matches_pallas(noise, white, rows):
    cfg, params, packed = setup_model(3)
    a = ray_inputs(cfg, rows=rows, noise=noise, seed=4)
    ref = fused_mip_train.mip_eval_pallas(
        params, jnp.asarray(a["features"]), jnp.asarray(a["dists"]), jnp.asarray(a["t_mids"]),
        jnp.asarray(a["noise"]) if noise else None, 3, color_outputs=3,
        white_background=white, interpret=True)
    got = mip_train.mip_eval(packed, t(a["features"]), t(a["dists"]), t(a["t_mids"]),
                             t(a["noise"]) if noise else None, 3, white)
    for name, g, r in zip(("rgb", "seg", "depth", "acc"), got, ref):
        assert tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=OUT_RTOL, atol=1e-5,
                                   err_msg=name)
