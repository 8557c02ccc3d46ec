"""K8 (``point_mlp.classic_pointmlp``: the classic MLP on raw points and
directions, the encoding inside the kernel) and the classic helpers of its
slice (``attenuated_frequency_encoding``, the residual block), held against
the JAX package on the CPU.

On the CPU the K8 wrappers run their plain PyTorch versions; the JAX side
runs ``classic_pointmlp_pallas`` in interpret mode, its LayerNorm
statistics pinned to the exact two-pass form (``exact_ln_stats``, from
``test_torch_train_reuse.py``).  Tolerances:

* ``enc_consts``: bitwise; both build the constants in float64 numpy and
  round them once.
* K8's forward, rtol 1e-5 / atol 1e-5: the same sines of the same
  arguments (the placement's zeros make ``x @ S`` one exact product per
  lane), then float32 products summed in another order through ten
  LayerNorm'd layers (JAX's kernel against the port's at hidden 64 agree
  to about 1e-6).
* K8's gradients, normalised by each tensor's largest entry, atol 2e-4:
  the JAX package's own gradient tests' bound
  (``test_torch_train_kernels.py``); the raw inputs' gradients carry the
  top octave's frequency (about 134 at bound 6) times float32 rounding.
* The helpers, rtol 1e-5 / atol 1e-6: one elementwise formula each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.models import mlp as jmlp
from nerf_tpu.ops import encoding as jenc
from nerf_tpu.ops.pallas import fused_mlp
from nerf_tpu_torch.models import mlp
from nerf_tpu_torch.ops import encoding
from nerf_tpu_torch.ops.kernels import _build, classic_mlp, point_mlp
from nerf_tpu_torch.utils.pth_import import classic_state_dict_from_jax_params
from test_torch_train_reuse import exact_ln_stats, make_models  # noqa: F401  (autouse fixture)

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_ATOL = 2e-4


def raw_inputs(n=300, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-2, 2, size=(n, 3)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32))


def enc_args(cfg):
    return (cfg.x_positional_encoding_size, cfg.normalize_position,
            cfg.d_positional_encoding_size, cfg.direction_bound)


@pytest.mark.parametrize("size,bound", [(60, 6.0), (36, 1.0), (20, 6.0), (12, 6.0)])
def test_enc_consts_bitwise(size, bound):
    s, phase = encoding.enc_consts(size, bound)
    js, jphase = fused_mlp._enc_consts(size, bound)
    assert s.dtype == js.dtype == np.float32 and phase.dtype == jphase.dtype
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(phase, jphase)


def test_forward_matches_jax_kernel():
    jmodel, params, model = make_models(normalize_position=6.0)
    pts, dirs = raw_inputs()
    d_jax, c_jax = fused_mlp.classic_pointmlp_pallas(
        params, jnp.asarray(pts), jnp.asarray(dirs), *enc_args(jmodel.cfg), interpret=True)
    with torch.no_grad():
        density, color = point_mlp.classic_pointmlp(
            model, torch.from_numpy(pts), torch.from_numpy(dirs), *enc_args(model.cfg))
    np.testing.assert_allclose(density.numpy(), np.asarray(d_jax), **OUT_TOL)
    np.testing.assert_allclose(color.numpy(), np.asarray(c_jax), **OUT_TOL)
    # The plain forward is K1's on the encodings sin(x S + phase).
    packed = classic_mlp.pack_classic_params(model.mlp)
    consts = point_mlp.encoding_consts(*enc_args(model.cfg), "cpu")
    with torch.no_grad():
        x_enc = torch.sin(torch.from_numpy(pts) @ consts[0] + consts[1])
        d_enc = torch.sin(torch.from_numpy(dirs) @ consts[2] + consts[3])
        want = classic_mlp.classic_mlp_fwd_plain(packed, x_enc, d_enc)
    torch.testing.assert_close(torch.cat([density, color], -1), want, rtol=0, atol=0)


def test_gradients_match_jax_grad():
    jmodel, params, model = make_models(normalize_position=6.0)
    pts, dirs = raw_inputs(seed=4)

    def jax_loss(p, x, d):
        dens, col = fused_mlp.classic_pointmlp_pallas(p, x, d, *enc_args(jmodel.cfg),
                                                      interpret=True)
        return jnp.mean(col ** 2) + jnp.mean(dens ** 2)

    g_params, g_pts, g_dirs = jax.grad(jax_loss, argnums=(0, 1, 2))(
        params, jnp.asarray(pts), jnp.asarray(dirs))
    x = torch.from_numpy(pts).requires_grad_(True)
    d = torch.from_numpy(dirs).requires_grad_(True)
    dens, col = point_mlp.classic_pointmlp(model, x, d, *enc_args(model.cfg))
    loss = torch.mean(col ** 2) + torch.mean(dens ** 2)
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, [x, d, *leaves])
    want = {"points": np.asarray(g_pts), "dirs": np.asarray(g_dirs)}
    want.update({f"mlp.{k}": v.numpy() for k, v in classic_state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, g_params)).items()})
    got = dict(zip(["points", "dirs", *names], grads))
    assert set(got) == set(want)
    for k, w in want.items():
        scale = np.abs(w).max() + 1e-12
        np.testing.assert_allclose(got[k].numpy() / scale, w / scale, atol=GRAD_ATOL,
                                   rtol=0, err_msg=k)


def test_backward_plain_matches_autograd_and_skips_inputs():
    _, _, model = make_models(normalize_position=6.0)
    packed = classic_mlp.pack_classic_params(model.mlp.requires_grad_(False))
    consts = point_mlp.encoding_consts(*enc_args(model.cfg), "cpu")
    pts, dirs = (torch.from_numpy(a) for a in raw_inputs(n=50, seed=5))
    g_out = torch.from_numpy(np.random.default_rng(6).normal(size=(50, 4)).astype(np.float32))
    dp, dd, d_packed = point_mlp.classic_pointmlp_bwd(packed, pts, dirs, consts, g_out)
    none_p, none_d, d_packed2 = point_mlp.classic_pointmlp_bwd(packed, pts, dirs, consts,
                                                               g_out, input_grads=False)
    assert none_p is None and none_d is None
    for k in d_packed:
        torch.testing.assert_close(d_packed2[k], d_packed[k], rtol=0, atol=0)
    # The chain rule through the encoding by hand: dx_enc of K1's plain
    # backward times cos(x S + phase), contracted with S.
    x_enc = torch.sin(pts @ consts[0] + consts[1])
    d_enc = torch.sin(dirs @ consts[2] + consts[3])
    dx, ddir, k1_packed = classic_mlp.classic_mlp_bwd_plain(packed, x_enc, d_enc, g_out)
    torch.testing.assert_close(dp, (dx * torch.cos(pts @ consts[0] + consts[1])) @ consts[0].T,
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dd, (ddir * torch.cos(dirs @ consts[2] + consts[3])) @ consts[2].T,
                               rtol=1e-5, atol=1e-6)
    for k in k1_packed:
        torch.testing.assert_close(d_packed[k], k1_packed[k], rtol=1e-6, atol=1e-7)


def test_requires_view_branch_and_counts_no_launch_on_cpu():
    _, _, model = make_models(normalize_position=6.0, use_viewdirs=False)
    pts, dirs = (torch.from_numpy(a) for a in raw_inputs(n=4))
    with pytest.raises(ValueError, match="view"):
        point_mlp.classic_pointmlp(model, pts, dirs, *enc_args(model.cfg))
    _, _, model = make_models(normalize_position=6.0)
    before = dict(_build.launch_counts)
    with torch.no_grad():
        point_mlp.classic_pointmlp(model, pts, dirs, *enc_args(model.cfg))
    assert dict(_build.launch_counts) == before  # CPU tensors run the plain version


def test_attenuated_frequency_encoding_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.uniform(-3, 3, size=(17, 3)).astype(np.float32)
    var = rng.uniform(0, 0.01, size=(17, 3)).astype(np.float32)
    scales = jenc.frequency_scales_np(20, 6.0)
    want = jenc.attenuated_frequency_encoding(jnp.asarray(x), jnp.asarray(var),
                                              jnp.asarray(scales))
    got = encoding.attenuated_frequency_encoding(torch.from_numpy(x), torch.from_numpy(var),
                                                 torch.from_numpy(np.array(scales)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    # Zero variance is the plain encoding.
    plain = encoding.frequency_encoding(torch.from_numpy(x), torch.from_numpy(np.array(scales)))
    zero = encoding.attenuated_frequency_encoding(torch.from_numpy(x), torch.zeros(17, 3),
                                                  torch.from_numpy(np.array(scales)))
    torch.testing.assert_close(zero, plain, rtol=0, atol=0)


def test_residual_block_matches_jax():
    params = jax.tree_util.tree_map(np.array,
                                    jmlp.init_residual_block(jax.random.PRNGKey(0), 32, 64))
    block = mlp.init_residual_block(32, 64, generator=torch.Generator().manual_seed(0),
                                    device="cpu")
    assert set(block.state_dict()) == {
        "linear_one.weight", "linear_one.bias", "linear_two.weight", "linear_two.bias",
        "layer_norm.weight", "layer_norm.bias"}
    with torch.no_grad():
        block.linear_one.weight.copy_(torch.from_numpy(params["linear_one"]["w"].T.copy()))
        block.linear_one.bias.copy_(torch.from_numpy(params["linear_one"]["b"]))
        block.linear_two.weight.copy_(torch.from_numpy(params["linear_two"]["w"].T.copy()))
        block.linear_two.bias.copy_(torch.from_numpy(params["linear_two"]["b"]))
        block.layer_norm.weight.copy_(torch.from_numpy(params["ln"]["scale"]))
        block.layer_norm.bias.copy_(torch.from_numpy(params["ln"]["bias"]))
    x = np.random.default_rng(8).normal(size=(16, 32)).astype(np.float32)
    want = jmlp.apply_residual_block(params, jnp.asarray(x))
    with torch.no_grad():
        got = mlp.apply_residual_block(block, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
