"""``compute_dtype="bfloat16"`` on the classic main path, held against the
JAX package on the CPU: K1-fwd, K1-bwd, K2, K3 and K4, ``render_rays``
through K1-fwd and K4, the coarse-only and the reuse train steps.

On the CPU each wrapper given bfloat16 encodings runs its plain version
with the bf16 products emulated (``tc_mlp.bf16_matmul_autograd``: operands
rounded to bfloat16, float32 sums, the heads' products too); the JAX side
runs its Pallas kernels in interpret mode with ``compute_dtype=bfloat16``
and the JAX package's default LayerNorm statistics, as its users run them.
The CUDA kernels run only on a card (``test_torch_cuda.py``).

Tolerances, in relative L2 over a whole output or over all gradients
together (``rel_l2``): 5e-3 for both.  bf16 is sensitive to float32
rounding: two float32-accurate evaluations round some activations to the
other bf16 neighbour (1 part in 256), and the change travels through ten
LayerNorm'd layers, so element-wise float32 tolerances do not apply.
Measured at hidden 64: the forward within 8e-4 of JAX's, the gradients
within 1.1e-3.  Each case also holds bf16 against float32 at the JAX
package's own bf16 bounds (``test_pallas.py::TestBfloat16Path``: outputs
within rtol 0.1, atol 0.15; gradients' cosine above 0.98, at sizes where
JAX's bf16 kernels meet it too).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu import RenderConfig as JaxRender
from nerf_tpu.ops.pallas import fused_hier, fused_mlp, fused_train
from nerf_tpu.train import loop as jloop
from nerf_tpu_torch import ClassicNeRF, ClassicNeRFConfig, RenderConfig
from nerf_tpu_torch.ops import compositing, sampling
from nerf_tpu_torch.ops.kernels import (
    _build,
    classic_mlp,
    fine_stage_train,
    mega_train,
    point_mlp,
    tc_mlp,
    train_grads,
    union_eval,
)
from nerf_tpu_torch.train import loop
from test_torch_kernels import union_inputs
from test_torch_render import make_models
from test_torch_train_kernels import fine_inputs, setup_variant, train_inputs
from test_torch_train_reuse import batch_arrays, jax_draws

REL_L2 = 5e-3
BF16 = jnp.bfloat16


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def t(a, bf16=False):
    if a is None:
        return None
    out = torch.from_numpy(np.ascontiguousarray(a))
    return out.bfloat16() if bf16 else out


def bf16_encodings(a: dict) -> dict:
    """The arrays as torch tensors, the encodings bfloat16."""
    return {k: t(v, k in ("x_enc", "d_enc")) for k, v in a.items()}


def flat(packed: dict, keys) -> np.ndarray:
    return np.concatenate([np.asarray(packed[k], np.float64).ravel() for k in keys])


def jax_packed(grads) -> dict:
    return {k: np.asarray(v) for k, v in fused_mlp.pack_classic_params(grads).items()}


def assert_grads_close(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    err = rel_l2(flat({k: got[k].numpy() for k in want}, want), flat(want, want))
    assert err <= REL_L2, err


def assert_direction_kept(bf16: dict, f32: dict) -> None:
    """The JAX package's bound on bf16 gradients against float32."""
    a, b = flat(bf16, f32), flat(f32, f32)
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    assert cos > 0.98, cos


def assert_jax_bf16_bound(bf16, f32) -> None:
    np.testing.assert_allclose(np.asarray(bf16), np.asarray(f32), rtol=0.1, atol=0.15)


# -- the emulation and the images ------------------------------------------


def test_bf16_matmul_rounds_operands_and_cotangent():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(5, 7)).astype(np.float32)).requires_grad_(True)
    b = torch.from_numpy(rng.normal(size=(7, 3)).astype(np.float32)).requires_grad_(True)
    g = torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32))
    r = tc_mlp.bf16_round
    out = tc_mlp.bf16_matmul_autograd(a, b)
    torch.testing.assert_close(out, r(a) @ r(b), rtol=0, atol=0)
    da, db = torch.autograd.grad(out, (a, b), g)
    torch.testing.assert_close(da, r(g) @ r(b).t(), rtol=0, atol=0)
    torch.testing.assert_close(db, r(a).t() @ r(g), rtol=0, atol=0)
    # Round to nearest even, as torch's and JAX's casts and cvt.rn do.
    x = torch.tensor([1 + 2 ** -8, 1 + 3 * 2 ** -8, 1 + 2 ** -9])
    torch.testing.assert_close(r(x), torch.tensor([1.0, 1 + 2 ** -6, 1.0]), rtol=0, atol=0)
    np.testing.assert_array_equal(r(x).numpy(), np.asarray(jnp.asarray(x.numpy()).astype(BF16),
                                                           np.float32))


@pytest.mark.parametrize("n,k", [(64, 60), (256, 36), (32, 256), (8, 33)])
def test_bf16_operand_image_layout(n, k):
    """A bf16 image: chunks of 32 k-values, [N][32] each, the 16-byte
    group j (8 values) of row r at j ^ ((r // 2) % 4); K zero-padded."""
    b = torch.from_numpy(np.random.default_rng(1).normal(size=(2, n, k)).astype(np.float32))
    img = tc_mlp.operand_image(b, torch.bfloat16)
    kp = -(-k // 32) * 32
    assert img.dtype == torch.bfloat16 and img.shape == (2, n * kp)
    values, lo = tc_mlp.operand_image_unpack(img, n, k)
    assert lo is None
    torch.testing.assert_close(values[..., :k].float(), tc_mlp.bf16_round(b), rtol=0, atol=0)
    assert (values[..., k:] == 0).all()
    r, kk = n - 1, k - 1  # the last value, by the layout's formula
    c, j, e = kk // 32, (kk % 32) // 8, kk % 8
    at = c * n * 32 + r * 32 + (j ^ ((r // 2) % 4)) * 8 + e
    assert img[1, at].float() == tc_mlp.bf16_round(b[1, r, kk])


def test_bf16_images_sizes():
    cfg, _, packed = setup_variant("view")
    fwd, bwd = tc_mlp.tc_images(packed, backward=True, dtype=torch.bfloat16)
    assert fwd.dtype == bwd.dtype == torch.bfloat16
    assert (fwd.numel(), bwd.numel()) == tc_mlp.image_numels(packed, torch.bfloat16)
    h = cfg.hidden_size
    # w0, wx at 60 -> 64, wd_in at 36 -> 64, nine hidden slabs.
    assert fwd.numel() == h * (64 + 64 + 64) + 9 * h * h
    f32 = tc_mlp.tc_images(packed, backward=True)
    assert tuple(x.numel() for x in f32) == tc_mlp.image_numels(packed)
    with pytest.raises(ValueError, match="tc_fwd"):
        tc_mlp.check_images("k", packed, f32[0], dtype=torch.bfloat16)


def test_wrappers_refuse_mixed_and_other_dtypes():
    cfg, _, packed = setup_variant("view")
    a = union_inputs(cfg, rays=2)
    x = torch.from_numpy(a["x_enc"].reshape(-1, cfg.x_encoding_dim))
    d = torch.zeros(x.shape[0], cfg.d_encoding_dim)
    with pytest.raises(TypeError, match="bfloat16"):
        classic_mlp.classic_mlp_fwd(packed, x.bfloat16(), d)
    with pytest.raises(TypeError, match="float32"):
        classic_mlp.classic_mlp_fwd(packed, x.half(), d.half())
    ua = bf16_encodings(a)
    ua["dnorm"] = ua["dnorm"].bfloat16()
    with pytest.raises(TypeError, match="dnorm must be float32"):
        union_eval.union_eval(packed, **ua)
    f32_image = tc_mlp.tc_images(packed)[0]
    with pytest.raises(TypeError, match="tc_fwd must be bfloat16"):
        classic_mlp.classic_mlp_fwd(packed, x.bfloat16(), d.bfloat16(), tc_fwd=f32_image)


# -- the five kernels' plain versions against the Pallas kernels -----------


@pytest.mark.parametrize("variant", ["view", "no_view", "latent"])
def test_k1_fwd_bf16_matches_jax(variant):
    cfg, params, packed = setup_variant(variant)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(512, cfg.x_encoding_dim)).astype(np.float32)
    d = rng.normal(size=(512, cfg.d_encoding_dim)).astype(np.float32) if cfg.use_viewdirs else None
    dens, col = fused_mlp.classic_mlp_pallas(params, x, d, compute_dtype=BF16, interpret=True)
    before = dict(_build.launch_counts)
    out = classic_mlp.classic_mlp_fwd(packed, t(x, True), t(d, True))
    assert dict(_build.launch_counts) == before  # the plain version launches nothing
    assert out.dtype == torch.float32 and out.shape == (512, 1 + cfg.color_outputs)
    want = np.concatenate([np.asarray(dens), np.asarray(col)], -1)
    assert rel_l2(out.numpy(), want) <= REL_L2
    assert_jax_bf16_bound(out.numpy(), classic_mlp.classic_mlp_fwd(packed, t(x), t(d)).numpy())


@pytest.mark.parametrize("variant", ["view", "latent"])
def test_k1_grads_bf16_match_jax(variant):
    cfg, params, packed = setup_variant(variant)
    rng = np.random.default_rng(0)
    n = 512 if variant == "view" else 256
    x = rng.normal(size=(n, cfg.x_encoding_dim)).astype(np.float32)
    d = rng.normal(size=(n, cfg.d_encoding_dim)).astype(np.float32)
    g_out = rng.normal(size=(n, 1 + cfg.color_outputs)).astype(np.float32)
    xb, db = jnp.asarray(x).astype(BF16), jnp.asarray(d).astype(BF16)
    _, vjp = jax.vjp(lambda p, x, d: fused_mlp.classic_mlp_pallas(
        p, x, d, compute_dtype=BF16, interpret=True), params, xb, db)
    gp, gx, gd = vjp((jnp.asarray(g_out[:, :1]), jnp.asarray(g_out[:, 1:])))
    dx, dd, d_packed = classic_mlp.classic_mlp_bwd(packed, t(x, True), t(d, True), t(g_out))
    # The encodings' cotangents take the encodings' dtype, as JAX's VJP's.
    assert dx.dtype == dd.dtype == torch.bfloat16 and gx.dtype == BF16
    assert_grads_close(d_packed, jax_packed(gp))
    assert rel_l2(dx.float().numpy(), np.asarray(gx, np.float32)) <= REL_L2
    assert rel_l2(dd.float().numpy(), np.asarray(gd, np.float32)) <= REL_L2
    # Under autograd, through ClassicMLPFunction, without the cotangents.
    leaves = {k: v.clone().requires_grad_(True) for k, v in packed.items()}
    out = classic_mlp.classic_mlp_fwd(leaves, t(x, True), t(d, True))
    grads = torch.autograd.grad(out, list(leaves.values()), t(g_out))
    assert_grads_close(dict(zip(leaves, grads)), jax_packed(gp))
    # The JAX package's bound, on its own test's objective.
    assert_direction_kept(objective_grads(packed, t(x, True), t(d, True)),
                          objective_grads(packed, t(x), t(d)))


def objective_grads(packed, x, d) -> dict:
    """Gradients of ``test_pallas.py``'s bf16 objective, mean(density^2) +
    mean(sin(color)), through ``classic_mlp_fwd`` under autograd."""
    leaves = {k: v.clone().requires_grad_(True) for k, v in packed.items()}
    out = classic_mlp.classic_mlp_fwd(leaves, x, d)
    loss = out[:, :1].pow(2).mean() + torch.sin(out[:, 1:]).mean()
    return {k: g.numpy() for k, g in zip(leaves, torch.autograd.grad(loss, list(leaves.values())))}


@pytest.mark.parametrize("variant", ["view", "latent"])
def test_k2_bf16_matches_jax(variant):
    cfg, params, packed = setup_variant(variant)
    a = train_inputs(cfg, rays=8, s=16)
    loss_r, grads_r, w_r = fused_train.classic_train_grads_pallas(
        params, *[None if v is None else jnp.asarray(v) for v in a.values()], 16,
        loss_weight=0.5, compute_dtype=BF16, return_weights=True, interpret=True)
    loss, d_packed, weights = train_grads.classic_train_grads(
        packed, **bf16_encodings(a), num_samples=16, loss_weight=0.5, return_weights=True)
    assert rel_l2(float(loss), float(loss_r)) <= REL_L2
    assert rel_l2(weights.numpy(), w_r) <= REL_L2
    assert_grads_close(d_packed, jax_packed(grads_r))
    loss32, f32 = train_grads.classic_train_grads(
        packed, **{k: t(v) for k, v in a.items()}, num_samples=16, loss_weight=0.5)
    assert_jax_bf16_bound(float(loss), float(loss32))
    f32 = {k: v.numpy() for k, v in f32.items()}
    assert_direction_kept({k: v.numpy() for k, v in d_packed.items()}, f32)
    assert_direction_kept(jax_packed(grads_r), f32)


@pytest.mark.parametrize("variant", ["view", "latent"])
def test_k3_bf16_matches_jax(variant):
    """16 rays: at 4, JAX's own bf16 K3 keeps its gradients' cosine to
    float32 at 0.95 only (its bound is 0.98)."""
    cfg, params, packed = setup_variant(variant)
    a = fine_inputs(cfg, rays=16, sc=8, sf=8)
    loss_r, grads_r, (gdc_r, gcc_r) = fused_hier.fine_stage_train_pallas(
        params, *[None if v is None else jnp.asarray(v) for v in a.values()],
        loss_weight=0.5, compute_dtype=BF16, interpret=True)
    loss, d_packed, (gdc, gcc) = fine_stage_train.fine_stage_train(
        packed, **bf16_encodings(a), loss_weight=0.5)
    assert rel_l2(float(loss), float(loss_r)) <= REL_L2
    assert_grads_close(d_packed, jax_packed(grads_r))
    assert gdc.dtype == gcc.dtype == torch.float32
    assert rel_l2(gdc.numpy(), gdc_r) <= REL_L2
    assert rel_l2(gcc.numpy(), gcc_r) <= REL_L2
    loss32, f32, _ = fine_stage_train.fine_stage_train(
        packed, **{k: t(v) for k, v in a.items()}, loss_weight=0.5)
    assert_jax_bf16_bound(float(loss), float(loss32))
    f32 = {k: v.numpy() for k, v in f32.items()}
    assert_direction_kept({k: v.numpy() for k, v in d_packed.items()}, f32)
    assert_direction_kept(jax_packed(grads_r), f32)


@pytest.mark.parametrize("variant", ["view", "latent"])
def test_k4_bf16_matches_jax(variant):
    cfg, params, packed = setup_variant(variant)
    a = union_inputs(cfg, rays=8)
    j = {k: None if v is None else jnp.asarray(v) for k, v in a.items()}
    ref = fused_hier.fine_union_eval_pallas(
        params, j["x_enc"], j["d_enc"], j["t_coarse"], j["t_fine"], j["dens_c"], j["col_c"],
        j["dnorm"], compute_dtype=BF16, interpret=True)
    got = union_eval.union_eval(packed, **bf16_encodings(a))
    f32 = union_eval.union_eval(packed, **{k: t(v) for k, v in a.items()})
    for name, g, r, f in zip(("rgb", "depth", "acc"), got, ref, f32):
        assert g.dtype == torch.float32
        assert rel_l2(g.numpy(), r) <= REL_L2, name
        assert_jax_bf16_bound(g.numpy(), f.numpy())


# -- the slice end to end --------------------------------------------------


def test_render_rays_bf16_matches_jax():
    """8 rays at 16 + 16 samples through K1-fwd and K4 (fused_eval), on
    bfloat16 encodings in both packages."""
    jmodel, params, model = make_models(True, compute_dtype="bfloat16")
    _, _, model32 = make_models(True)
    rng = np.random.default_rng(0)
    o = (rng.normal(size=(8, 3)) * 0.5).astype(np.float32)
    d = rng.normal(size=(8, 3)).astype(np.float32)
    rkw = dict(num_coarse_samples=16, num_fine_samples=16, near=2.0, far=6.0,
               randomly_sample=False, density_noise_std=0.0)
    ref = jmodel.render_rays(params, None, jnp.asarray(o), jnp.asarray(d), JaxRender(**rkw),
                             fused_eval=True)
    with torch.no_grad():
        out = model.render_rays(t(o), t(d), RenderConfig(**rkw), fused_eval=True)
        out32 = model32.render_rays(t(o), t(d), RenderConfig(**rkw), fused_eval=True)
    for name in ("rgb", "depth", "acc"):
        got = getattr(out, name).numpy()
        assert np.isfinite(got).all()
        assert rel_l2(got, getattr(ref, name)) <= REL_L2, name
        assert_jax_bf16_bound(got, getattr(out32, name).numpy())


@pytest.mark.parametrize("white", [False, True])
def test_reuse_step_bf16_matches_jax(white):
    """One 2-stage reuse step (K1-fwd, K3, one K1-bwd) in bfloat16 with the
    JAX step's draws."""
    jmodel, params, model = make_models(True, compute_dtype="bfloat16")
    kw = dict(num_coarse_samples=8, num_fine_samples=8, near=2.0, far=6.0,
              randomly_sample=True, density_noise_std=1.0, white_background=white,
              reuse_coarse_in_fine=True)
    b = batch_arrays()
    key = jax.random.PRNGKey(7)
    loss_r, grads_r, _ = fused_hier.reuse_train_loss_and_grads(
        jmodel, params, JaxRender(**kw), {k: jnp.asarray(v) for k, v in b.items()}, key)
    draws = jax_draws(key, JaxRender(**kw), 16)
    loss, grads, _ = fine_stage_train.reuse_train_loss_and_grads(
        model, RenderConfig(**kw), {k: t(v) for k, v in b.items()}, draws)
    assert rel_l2(float(loss), float(loss_r)) <= REL_L2
    want = jax_packed(grads_r)
    got = classic_mlp.pack_classic_params(_module_with(model, grads))
    assert_grads_close({k: v.detach() for k, v in got.items()}, want)


def _module_with(model, grads):
    """model.mlp with its parameters replaced by ``grads`` (packing is
    linear, so it maps gradients like weights)."""
    mlp = type(model.mlp)(model.cfg, device="cpu")
    mlp.load_state_dict({k[len("mlp."):]: v for k, v in grads.items()})
    return mlp


def test_coarse_step_bf16_matches_jax():
    """The coarse-only fused step (one K2) in bfloat16: the trainer casts
    the encodings, as JAX's ``stage_inputs`` does, and hands K2 what a
    direct call with the encodings cast would get (K2 is held against
    JAX's at 5e-3 by ``test_k2_bf16_matches_jax``).  Against JAX's jitted
    step, on 32 rays (at 16, JAX's own bf16 step keeps its gradients'
    cosine to float32 at 0.977 only): the loss within 5e-3, and the
    gradients' cosine to JAX's float32 step above 0.98, JAX's own bound,
    as JAX's bf16 step's is.  Their relative L2 to JAX's bf16 gradients is
    no measure of the port here: JAX's own step run eagerly is 8.1e-3 to
    4.8e-2 from its jitted self on seeds 0-3
    (``scripts/torch_bf16_step_spread.py``), float32 summation order moving
    bf16 roundings."""
    jmodel, params, model = make_models(True, compute_dtype="bfloat16")
    jmodel32, _, _ = make_models(True)
    render_kw = dict(num_coarse_samples=16, near=2.0, far=6.0, randomly_sample=False,
                     density_noise_std=0.0)
    n = 32
    b = batch_arrays(n=n)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    loss_r, grads_r, _ = jloop.make_fused_loss_and_grads(jmodel, JaxRender(**render_kw))(
        params, jax.random.PRNGKey(0), jb)
    _, grads32, _ = jloop.make_fused_loss_and_grads(jmodel32, JaxRender(**render_kw))(
        params, jax.random.PRNGKey(0), jb)
    render = RenderConfig(**render_kw)
    t_coarse = sampling.sample_linear(None, (n,), 16, 2.0, 6.0, randomly_sample=False,
                                      device="cpu")
    draws = sampling.StepDraws(t_coarse, torch.zeros(n, 16), None, None)
    batch = {k: t(v) for k, v in b.items()}
    loss, grads, _ = loop.make_fused_loss_and_grads(model, render)(batch, draws)
    got = {k: v.detach() for k, v in classic_mlp.pack_classic_params(
        _module_with(model, grads)).items()}
    x_enc, d_enc = model.encode_inputs_flat(batch["rays_o"], batch["rays_d"], t_coarse)
    dists = compositing.distances_from_tvals(t_coarse, batch["rays_d"])
    loss_k2, direct = train_grads.classic_train_grads(
        {k: v.detach() for k, v in classic_mlp.pack_classic_params(model.mlp).items()},
        x_enc.bfloat16(), d_enc.bfloat16().contiguous(), dists, torch.zeros(n, 16),
        batch["pixels"], 16)
    assert float(loss) == float(loss_k2)
    for k, v in direct.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    assert rel_l2(float(loss), float(loss_r)) <= REL_L2
    f32 = jax_packed(grads32)
    assert_direction_kept({k: got[k].numpy() for k in f32}, f32)
    assert_direction_kept(jax_packed(grads_r), f32)


# -- K8 and K9 take bf16 too ---------------------------------------------------


def test_kernels_out_of_the_slice_refuse_bf16():
    """The kernels out of this slice, K8 and K9, take bfloat16 now: K8
    ``compute_dtype="bfloat16"`` as its own argument and K9 a bfloat16
    model (``test_torch_pointmlp_mega_bf16.py`` holds them against JAX).
    Both still refuse bfloat16 mixed with float32: bf16 images with float32
    compute, bfloat16 raw points, float32 view encodings beside bfloat16
    coarse ones."""
    _, _, model = make_models(True, compute_dtype="bfloat16")
    cfg = model.cfg
    args = (cfg.x_positional_encoding_size, cfg.normalize_position,
            cfg.d_positional_encoding_size, cfg.direction_bound)
    pts, dirs = torch.zeros(4, 3), torch.ones(4, 3)
    with torch.no_grad():
        density, color = point_mlp.classic_pointmlp(model, pts, dirs, *args,
                                                    compute_dtype="bfloat16")
    assert density.shape == (4, 1) and color.dtype == torch.float32
    with torch.no_grad():
        packed = classic_mlp.pack_classic_params(model.mlp)
    consts = point_mlp.encoding_consts(*args, "cpu")
    bf16_image = tc_mlp.tc_images(packed, dtype=torch.bfloat16)[0]
    with pytest.raises(TypeError, match="tc_fwd must be float32"):
        point_mlp.classic_pointmlp_fwd(packed, pts, dirs, consts, tc_fwd=bf16_image)
    with pytest.raises(TypeError, match="points must be float32"):
        point_mlp.classic_pointmlp_fwd(packed, pts.bfloat16(), dirs, consts,
                                       dtype=torch.bfloat16)
    render = RenderConfig(num_coarse_samples=8, num_fine_samples=8, randomly_sample=False)
    batch = {k: t(v) for k, v in batch_arrays(n=4).items()}
    t_c = sampling.sample_linear(None, (4,), 8, 2.0, 6.0, randomly_sample=False, device="cpu")
    draws = sampling.StepDraws(t_c, torch.zeros(4, 8), torch.rand(4, 8), torch.zeros(4, 8))
    loss, grads, _ = mega_train.mega_train_loss_and_grads(model, render, batch, draws)
    assert bool(torch.isfinite(loss)) and set(grads) == {k for k, _ in model.named_parameters()}
    inputs = list(mega_train.mega_inputs(model, batch, draws))
    inputs[1] = inputs[1].float()
    with pytest.raises(TypeError, match="d_ray must be bfloat16"):
        mega_train.mega_train(packed, *inputs)
