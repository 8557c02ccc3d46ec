"""The port's ``ClassicMLP`` and the weight carry-across, held against the
JAX package on the CPU.  Weights come from ``ClassicNeRF.init(PRNGKey(0))``
and cross over through ``classic_state_dict_from_jax_params``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu import ClassicNeRF as JaxNeRF
from nerf_tpu import ClassicNeRFConfig as JaxConfig
from nerf_tpu.models import mlp as jmlp
from nerf_tpu.utils import pth_import as jpth
from nerf_tpu.utils import profiling as jprof
from nerf_tpu_torch import ClassicNeRFConfig
from nerf_tpu_torch.models.mlp import ClassicMLP, count_params
from nerf_tpu_torch.utils import profiling, pth_import

# Narrow widths keep the CPU time small; "latent" widens both encodings the
# way a conditional NeRF does (density_inputs = 3 + state dim).
VARIANTS = {
    "view": dict(hidden_size=64),
    "no_view": dict(hidden_size=64, use_viewdirs=False),
    "latent": dict(hidden_size=32, density_inputs=5, color_inputs=4),
}


def jax_params(kwargs):
    params = JaxNeRF(JaxConfig(**kwargs)).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def port_mlp(kwargs, params):
    mlp = ClassicMLP(ClassicNeRFConfig(**kwargs), device="cpu")
    mlp.load_state_dict(pth_import.classic_state_dict_from_jax_params(params))
    return mlp


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_carry_across_round_trip(variant):
    kwargs = VARIANTS[variant]
    params = jax_params(kwargs)
    sd = pth_import.classic_state_dict_from_jax_params(params)
    # The keys are the reference .pth keys, the tensors the JAX exporter's.
    ref_sd = jpth.classic_params_to_state_dict(params)
    assert sorted(sd) == sorted(ref_sd)
    for k, v in ref_sd.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    back = pth_import.jax_params_from_classic_state_dict(sd, ClassicNeRFConfig(**kwargs))
    flat, tree = jax.tree_util.tree_flatten(params)
    flat_back, tree_back = jax.tree_util.tree_flatten(back)
    assert tree == tree_back
    for a, b in zip(flat, flat_back):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_classic_mlp_matches_apply_classic_mlp(variant):
    kwargs = VARIANTS[variant]
    cfg = ClassicNeRFConfig(**kwargs)
    params = jax_params(kwargs)
    mlp = port_mlp(kwargs, params)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 40, cfg.x_encoding_dim)).astype(np.float32)
    d = rng.normal(size=(5, 40, cfg.d_encoding_dim)).astype(np.float32)
    d_ref = jnp.asarray(d) if cfg.use_viewdirs else None
    dens_ref, col_ref = jmlp.apply_classic_mlp(params, JaxConfig(**kwargs), jnp.asarray(x), d_ref)
    with torch.no_grad():
        dens, col = mlp(torch.from_numpy(x), torch.from_numpy(d) if cfg.use_viewdirs else None)
    assert dens.shape == (5, 40, 1) and col.shape == (5, 40, 3)
    # Same float32 arithmetic in another matmul order: a few ulp.
    np.testing.assert_allclose(dens.numpy(), np.asarray(dens_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(col.numpy(), np.asarray(col_ref), rtol=1e-5, atol=1e-5)


def test_view_branch_needs_directions():
    mlp = ClassicMLP(ClassicNeRFConfig(hidden_size=32), device="cpu")
    with pytest.raises(ValueError):
        mlp(torch.zeros(2, 60))


def test_full_width_param_count_and_state_dict_keys():
    cfg = ClassicNeRFConfig()
    mlp = ClassicMLP(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    params = JaxNeRF(JaxConfig()).init(jax.random.PRNGKey(0))
    assert count_params(mlp) == jmlp.count_params(params) == 638_468
    # 44 tensors, the reference checkpoint's keys.
    assert sorted(mlp.state_dict()) == sorted(
        jpth.classic_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    )
    assert len(mlp.state_dict()) == 44
    assert profiling.classic_flops_per_point(cfg) == jprof.classic_flops_per_point(JaxConfig())
    assert profiling.classic_flops_per_point(cfg) == 2 * 630_784
    assert profiling.train_step_flops(cfg, 4096, 64) == jprof.train_step_flops(
        JaxConfig(), 4096, 64)


def test_init_is_torch_default_distribution_and_seeded():
    cfg = ClassicNeRFConfig(hidden_size=64)
    a = ClassicMLP(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    b = ClassicMLP(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0, msg=k)
    w = a.block_1[0].weight.detach()
    bound = 1.0 / np.sqrt(w.shape[1])
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
    assert torch.all(a.block_0[2].weight == 1.0) and torch.all(a.block_0[2].bias == 0.0)


def test_load_classic_checkpoint_matches_jax_loader(tmp_path):
    kwargs = VARIANTS["view"]
    params = jax_params(kwargs)
    path = str(tmp_path / "nerf.pth")
    torch.save(pth_import.classic_state_dict_from_jax_params(params), path)
    mlp = pth_import.load_classic_checkpoint(path, ClassicNeRFConfig(**kwargs), device="cpu")
    ref = jpth.load_classic_checkpoint(path, JaxConfig(**kwargs))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 60)).astype(np.float32)
    d = rng.normal(size=(64, 36)).astype(np.float32)
    dens_ref, col_ref = jmlp.apply_classic_mlp(ref, JaxConfig(**kwargs), jnp.asarray(x), jnp.asarray(d))
    with torch.no_grad():
        dens, col = mlp(torch.from_numpy(x), torch.from_numpy(d))
    np.testing.assert_allclose(dens.numpy(), np.asarray(dens_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(col.numpy(), np.asarray(col_ref), rtol=1e-5, atol=1e-5)
    with pytest.raises(RuntimeError):  # a checkpoint of another width
        pth_import.load_classic_checkpoint(path, ClassicNeRFConfig(hidden_size=32), device="cpu")
