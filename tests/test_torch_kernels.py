"""The port's two kernel wrappers, K1-fwd (``classic_mlp.classic_mlp_fwd``)
and K4 (``union_eval.union_eval``).

On the CPU a wrapper runs its plain PyTorch version; those are held against
the JAX package's Pallas kernels in interpret mode at the tolerances of the
JAX package's own kernel tests (``test_pallas.py``, ``test_fused_eval.py``).
The CUDA kernels themselves run only on a card: ``test_torch_cuda.py``
holds each against its plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu import ClassicNeRF as JaxNeRF
from nerf_tpu import ClassicNeRFConfig as JaxConfig
from nerf_tpu.ops.pallas import fused_hier, fused_mlp
from nerf_tpu_torch import ClassicNeRF, ClassicNeRFConfig, RenderConfig
from nerf_tpu_torch.models.mlp import ClassicMLP
from nerf_tpu_torch.ops.kernels import _build, classic_mlp, union_eval
from nerf_tpu_torch.utils.pth_import import classic_state_dict_from_jax_params

VARIANTS = {
    "view": dict(hidden_size=64),
    "no_view": dict(hidden_size=64, use_viewdirs=False),
    "latent": dict(hidden_size=32, density_inputs=5, color_inputs=4),
}


def setup_variant(variant):
    kwargs = VARIANTS[variant]
    params = JaxNeRF(JaxConfig(**kwargs)).init(jax.random.PRNGKey(0))
    mlp = ClassicMLP(ClassicNeRFConfig(**kwargs), device="cpu")
    mlp.load_state_dict(
        classic_state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    )
    mlp.requires_grad_(False)
    return ClassicNeRFConfig(**kwargs), params, mlp


def mlp_inputs(cfg, n=300, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, cfg.x_encoding_dim)).astype(np.float32)
    d = rng.normal(size=(n, cfg.d_encoding_dim)).astype(np.float32)
    return x, (d if cfg.use_viewdirs else None)


def union_inputs(cfg, rays=12, sc=16, sf=24, seed=0):
    """Sorted coarse and fine t-values with fine samples tied to coarse
    ones, raw coarse outputs, per-ray view encodings and ||d||."""
    rng = np.random.default_rng(seed)
    t_c = np.sort(rng.uniform(2, 6, size=(rays, sc)), -1).astype(np.float32)
    t_f = rng.uniform(2, 6, size=(rays, sf)).astype(np.float32)
    t_f[:, 5] = t_c[:, 9]
    t_f = np.sort(t_f, -1)
    return dict(
        x_enc=rng.normal(size=(rays, sf, cfg.x_encoding_dim)).astype(np.float32),
        d_enc=(rng.normal(size=(rays, cfg.d_encoding_dim)).astype(np.float32)
               if cfg.use_viewdirs else None),
        t_coarse=t_c,
        t_fine=t_f,
        dens_c=(rng.normal(size=(rays, sc, 1)) * 3).astype(np.float32),
        col_c=rng.normal(size=(rays, sc, 3)).astype(np.float32),
        dnorm=rng.uniform(0.5, 2.0, size=(rays,)).astype(np.float32),
    )


def to_torch(arrays, device="cpu"):
    return {k: None if v is None else torch.from_numpy(v).to(device) for k, v in arrays.items()}


# -- plain versions against the Pallas kernels (interpret mode) -----------


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_classic_mlp_fwd_cpu_matches_pallas(variant):
    cfg, params, mlp = setup_variant(variant)
    x, d = mlp_inputs(cfg)
    dens_ref, col_ref = fused_mlp.classic_mlp_pallas(
        params, jnp.asarray(x), None if d is None else jnp.asarray(d), interpret=True
    )
    packed = classic_mlp.pack_classic_params(mlp)
    before = dict(_build.launch_counts)
    out = classic_mlp.classic_mlp_fwd(
        packed, torch.from_numpy(x), None if d is None else torch.from_numpy(d)
    )
    assert out.shape == (300, 4)
    # The tolerance of the JAX package's own forward parity test.
    np.testing.assert_allclose(out[:, :1].numpy(), np.asarray(dens_ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out[:, 1:].numpy(), np.asarray(col_ref), rtol=1e-4, atol=1e-5)
    assert dict(_build.launch_counts) == before  # the plain version launches nothing


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_union_eval_cpu_matches_pallas(variant):
    cfg, params, mlp = setup_variant(variant)
    a = union_inputs(cfg)
    j = {k: None if v is None else jnp.asarray(v) for k, v in a.items()}
    rgb_ref, depth_ref, acc_ref = fused_hier.fine_union_eval_pallas(
        params, j["x_enc"], j["d_enc"], j["t_coarse"], j["t_fine"],
        j["dens_c"], j["col_c"], j["dnorm"], interpret=True,
    )
    rgb, depth, acc = union_eval.union_eval(classic_mlp.pack_classic_params(mlp), **to_torch(a))
    assert rgb.shape == (12, 3) and depth.shape == (12,) and acc.shape == (12,)
    # The tolerances of the JAX package's own fused-eval parity test: its
    # kernel sums the transmittance logs in another order.
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_ref), rtol=5e-4, atol=1e-4)
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_ref), rtol=5e-4, atol=1e-4)
    np.testing.assert_allclose(depth.numpy(), np.asarray(depth_ref), rtol=1e-3)


def test_pack_round_trips_through_plain_forward():
    cfg, _, mlp = setup_variant("view")
    x, d = mlp_inputs(cfg, n=50, seed=3)
    out = classic_mlp.classic_mlp_fwd_plain(
        classic_mlp.pack_classic_params(mlp), torch.from_numpy(x), torch.from_numpy(d)
    )
    dens, col = mlp(torch.from_numpy(x), torch.from_numpy(d))
    torch.testing.assert_close(out, torch.cat([dens, col], -1), rtol=1e-6, atol=1e-6)


# -- what the wrappers refuse ---------------------------------------------


def test_bfloat16_is_not_implemented():
    cfg, _, mlp = setup_variant("view")
    packed = classic_mlp.pack_classic_params(mlp)
    x, d = mlp_inputs(cfg, n=8)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        classic_mlp.classic_mlp_fwd(
            packed, torch.from_numpy(x).bfloat16(), torch.from_numpy(d).bfloat16()
        )
    a = to_torch(union_inputs(cfg, rays=2))
    a["x_enc"] = a["x_enc"].bfloat16()
    with pytest.raises(NotImplementedError, match="bfloat16"):
        union_eval.union_eval(packed, **a)
    model = ClassicNeRF(
        ClassicNeRFConfig(hidden_size=32, use_pallas=True, compute_dtype="bfloat16"),
        generator=torch.Generator().manual_seed(0), device="cpu",
    )
    render = RenderConfig(num_coarse_samples=4, randomly_sample=False)
    with torch.no_grad(), pytest.raises(NotImplementedError, match="bfloat16"):
        model.render_rays(torch.zeros(2, 3), torch.ones(2, 3), render)


def test_requires_grad_is_not_implemented():
    """K1 has a backward now: under autograd it returns the gradient of
    autograd through its plain version.  K4 is forward-only, as its JAX
    counterpart, and still refuses inputs that require grad."""
    cfg, _, mlp = setup_variant("view")
    mlp.requires_grad_(True)
    packed = classic_mlp.pack_classic_params(mlp)  # built with autograd on
    x, d = mlp_inputs(cfg, n=8)
    g_out = torch.from_numpy(np.random.default_rng(1).normal(size=(8, 4)).astype(np.float32))
    out = classic_mlp.classic_mlp_fwd(packed, torch.from_numpy(x), torch.from_numpy(d))
    got = torch.autograd.grad(out, list(mlp.parameters()), g_out)
    ref_out = classic_mlp.classic_mlp_fwd_plain(
        classic_mlp.pack_classic_params(mlp), torch.from_numpy(x), torch.from_numpy(d))
    ref = torch.autograd.grad(ref_out, list(mlp.parameters()), g_out)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)
    a = to_torch(union_inputs(cfg, rays=2))
    with pytest.raises(NotImplementedError, match="backward"):
        union_eval.union_eval(packed, **a)
    with torch.no_grad():  # the same call without a graph is fine
        union_eval.union_eval(classic_mlp.pack_classic_params(mlp), **a)


def test_shape_and_layout_errors():
    cfg, _, mlp = setup_variant("view")
    packed = classic_mlp.pack_classic_params(mlp)
    x, d = (torch.from_numpy(v) for v in mlp_inputs(cfg, n=8))
    with pytest.raises(ValueError, match="d_enc"):
        classic_mlp.classic_mlp_fwd(packed, x, None)
    with pytest.raises(ValueError, match="x_enc"):
        classic_mlp.classic_mlp_fwd(packed, x[:, :-1].contiguous(), d)
    with pytest.raises(ValueError, match="contiguous"):
        classic_mlp.classic_mlp_fwd(packed, x.t().contiguous().t(), d)
    with pytest.raises(TypeError, match="float32"):
        classic_mlp.classic_mlp_fwd(packed, x.double(), d)
    a = to_torch(union_inputs(cfg, rays=3))
    a["dens_c"] = a["dens_c"][..., 0].contiguous()
    with pytest.raises(ValueError, match="dens_c"):
        union_eval.union_eval(packed, **a)
