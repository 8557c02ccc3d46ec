"""K9 (``mega_train.mega_train_loss_and_grads``: the whole hierarchical
reuse step in one call) and the order-free compositing helpers of its
slice (``unsorted_dists``, ``weights_from_unsorted``), held against the
JAX package on the CPU.

On the CPU the K9 wrapper runs its plain PyTorch version; the JAX side runs
``fused_mega.mega_train_loss_and_grads`` in interpret mode (about 15-25 s
a call here, so three calls in all), its LayerNorm statistics pinned to the
exact two-pass form (``exact_ln_stats``).  The port is fed the JAX step's
draws (``jax_draws``) and the JAX package's frequency constants
(``make_models``), both from ``test_torch_train_reuse.py``.  Tolerances, the
JAX package's own bounds (``tests/test_fused_mega.py``):

* against the JAX kernel with its own t_fine held constant: loss rtol 1e-5,
  every gradient within 5e-5 of the largest entry of them all (float32
  products and sums in another order);
* the port's own resample against the JAX kernel's: t_fine within 1e-4
  (the cdf's sums in another order move a sample by a few ulp of t, more
  where a bin carries little mass);
* the port's whole step against the JAX kernel's, and against the port's
  reuse path (held against the JAX package's in
  ``test_torch_train_reuse.py``): loss rtol 1e-4, gradients within 5e-3 of
  the largest entry (the top encoding octave, about 134 at bound 6,
  magnifies the fine samples' shifts);
* the fine encoding, atol 2e-6: the same argument, float32 sin and cos of
  two libraries (XLA's and PyTorch's), up to about 800 in argument;
* the compositing helpers, rtol 1e-5 / atol 1e-7: one formula each, sums
  in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu import RenderConfig as JaxRender
from nerf_tpu.ops import compositing as jcomp
from nerf_tpu.ops import encoding as jenc
from nerf_tpu.ops import sampling as jsampling
from nerf_tpu.ops.pallas import fused_mega, fused_mlp
from nerf_tpu_torch import ClassicNeRF, ClassicNeRFConfig, RenderConfig
from nerf_tpu_torch.ops import compositing, encoding, sampling
from nerf_tpu_torch.ops.kernels import _build, classic_mlp, fine_stage_train, mega_train
from nerf_tpu_torch.utils.pth_import import classic_state_dict_from_jax_params
from test_torch_train_reuse import (  # noqa: F401  (exact_ln_stats: an autouse fixture)
    batch_arrays,
    exact_ln_stats,
    jax_draws,
    make_models,
    t,
)

N_RAYS = 8


def render_kwargs(**kw):
    return dict(dict(num_coarse_samples=8, num_fine_samples=16, near=2.0, far=6.0,
                     randomly_sample=True, density_noise_std=1.0, reuse_coarse_in_fine=True),
                **kw)


def flat_grads(by_name: dict, names) -> np.ndarray:
    return np.concatenate([np.asarray(by_name[k]).ravel() for k in names])


def assert_grads_within(got: dict, want: dict, rel: float):
    """Every gradient within ``rel`` of the largest entry of them all (the
    JAX package's ``ravel_pytree`` bound)."""
    assert set(got) == set(want)
    names = sorted(want)
    g, w = flat_grads(got, names), flat_grads(want, names)
    scale = np.abs(w).max()
    assert np.abs(g - w).max() < rel * scale, (np.abs(g - w).max(), scale)


def jax_grads_by_name(grads) -> dict:
    sd = classic_state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, grads))
    return {f"mlp.{k}": v.numpy() for k, v in sd.items()}


# -- the fine encoding and the supports rule ----------------------------------


@pytest.mark.parametrize("exact_trig", [True, False])
def test_encode_fine_plain_matches_jax(exact_trig):
    _, _, model = make_models()
    rng = np.random.default_rng(3)
    t_f = np.sort(rng.uniform(2.0, 6.0, size=(4, 16)), axis=-1).astype(np.float32)
    o3 = rng.normal(size=(4, 3)).astype(np.float32)
    d3 = rng.normal(size=(4, 3)).astype(np.float32)
    placement, is_cos = encoding.frequency_placement(model.x_scales)
    # The model holds the JAX package's scales, so the placements agree.
    enc_np, iscos_np = jenc.frequency_placement(20, 6.0)
    np.testing.assert_array_equal(placement.numpy(), enc_np)
    np.testing.assert_array_equal(is_cos.numpy(), iscos_np)
    want = fused_mega._encode_fine(jnp.asarray(t_f), jnp.asarray(o3), jnp.asarray(d3),
                                   jnp.asarray(enc_np), jnp.asarray(iscos_np), 4, 16,
                                   exact_trig=exact_trig)
    got = mega_train.encode_fine_plain(t(t_f), t(o3), t(d3), placement, is_cos, exact_trig)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)
    if exact_trig:  # the exact form is frequency_encoding's
        pts = torch.from_numpy(o3)[:, None] + torch.from_numpy(d3)[:, None] * t(t_f)[..., None]
        ref = encoding.frequency_encoding(pts.reshape(-1, 3), model.x_scales)
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_supports_mega_matches_jax():
    jmodel, _, model = make_models()
    _, _, no_view = make_models(use_viewdirs=False)
    batch = {k: t(v) for k, v in batch_arrays(n=4).items()}
    latent_x = dict(batch, states_x=torch.zeros(4, 2))
    latent_d = dict(batch, states_d=torch.zeros(4, 2))
    cases = [
        (render_kwargs(), batch),
        (render_kwargs(), None),
        (render_kwargs(num_fine_samples=0), batch),
        (render_kwargs(reuse_coarse_in_fine=False), batch),
        (render_kwargs(num_coarse_samples=3), batch),
        (render_kwargs(), latent_x),
        (render_kwargs(), latent_d),
    ]
    for kw, b in cases:
        jb = None if b is None else {k: jnp.asarray(v.numpy()) for k, v in b.items()}
        want = fused_mega.supports_mega(jmodel, JaxRender(**kw), jb)
        assert mega_train.supports_mega(model, RenderConfig(**kw), b) == want, kw
    assert mega_train.supports_mega(no_view, RenderConfig(**render_kwargs()), batch)
    assert not mega_train.supports_mega(
        ClassicNeRF(ClassicNeRFConfig(trunk_blocks=(3, 4)), device="cpu"),
        RenderConfig(**render_kwargs()))
    with pytest.raises(ValueError, match="reuse_coarse_in_fine"):
        mega_train.mega_train_loss_and_grads(model, RenderConfig(**render_kwargs(num_fine_samples=0)),
                                             batch, None)


def test_pdf_cdf_at_inverts_the_resample():
    """``pdf_cdf_at``, with which the card's tests compare K9's fine
    samples, takes the JAX resampler's t-values back to its uniforms, empty
    bins included (within 1e-6: float32 sums of the cdf)."""
    rng = np.random.default_rng(9)
    w = rng.uniform(0.0, 1.0, size=(6, 14)).astype(np.float32)
    w[:, 3:6] = 0.0  # empty bins hold only the 1e-5 floor
    # Stratified fenceposts, as the coarse t-values' midpoints are: where a
    # narrow bin holds much mass, one ulp of t is many ulp of mass.
    bins = (np.linspace(2.0, 6.0, 15) + rng.uniform(-0.1, 0.1, size=(6, 15))).astype(np.float32)
    key = jax.random.PRNGKey(4)  # sample_pdf draws pdf_uniforms' uniforms from it
    u = jsampling.pdf_uniforms(key, (6,), 32)
    t_jax = jsampling.sample_pdf(key, jnp.asarray(bins), jnp.asarray(w), 32)
    got = sampling.pdf_cdf_at(t(bins), t(w), t(np.asarray(t_jax)))
    np.testing.assert_allclose(got.numpy(), np.asarray(u), rtol=0, atol=1e-6)


# -- the order-free compositing helpers ----------------------------------------


def unsorted_inputs(seed=5):
    rng = np.random.default_rng(seed)
    t_vals = rng.uniform(2.0, 6.0, size=(6, 12)).astype(np.float32)
    t_vals[:, 7] = t_vals[:, 2]  # ties: the lower index comes first
    density = rng.uniform(-1.0, 3.0, size=(6, 12, 1)).astype(np.float32)
    rays_d = rng.normal(size=(6, 3)).astype(np.float32)
    return t_vals, density, rays_d


def test_unsorted_dists_and_weights_match_jax():
    t_vals, density, rays_d = unsorted_inputs()
    want_d = jcomp.unsorted_dists(jnp.asarray(t_vals), jnp.asarray(rays_d))
    want_w = jcomp.weights_from_unsorted(jnp.asarray(density), jnp.asarray(t_vals),
                                         jnp.asarray(rays_d))
    got_d = compositing.unsorted_dists(t(t_vals), t(rays_d))
    got_w = compositing.weights_from_unsorted(t(density), t(t_vals), t(rays_d))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-5, atol=1e-7)


def test_weights_from_unsorted_is_the_union_oracle():
    """The union weights of two sorted blocks (K3's, K4's and K9's
    compositing) are the order-free weights of their concatenation, a
    coarse sample tied with a fine one coming first."""
    rng = np.random.default_rng(6)
    t_c = np.sort(rng.uniform(2.0, 6.0, size=(5, 8)), -1).astype(np.float32)
    t_f = rng.uniform(2.0, 6.0, size=(5, 16)).astype(np.float32)
    t_f[:, 3] = t_c[:, 4]
    t_f = np.sort(t_f, -1)
    dens = rng.uniform(-1.0, 3.0, size=(5, 24, 1)).astype(np.float32)
    rays_d = rng.normal(size=(5, 3)).astype(np.float32)
    union = compositing.weights_from_union_sorted(t(dens[:, :8]), t(dens[:, 8:]), t(t_c),
                                                  t(t_f), t(rays_d))
    oracle = compositing.weights_from_unsorted(t(dens), t(np.concatenate([t_c, t_f], -1)),
                                               t(rays_d))
    torch.testing.assert_close(union, oracle, rtol=1e-5, atol=1e-7)


# -- the step against the JAX kernel ------------------------------------------

# (model kwargs, render kwargs, exact_trig); each case is one JAX K9 call.
CASES = {
    "view_exact": (dict(), dict(), True),
    "no_view_white_exact": (dict(use_viewdirs=False), dict(white_background=True), True),
    "view_phase": (dict(), dict(), False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mega_step_matches_jax_kernel(case):
    model_kw, kw, exact = CASES[case]
    jmodel, params, model = make_models(**model_kw)
    kw = render_kwargs(**kw)
    b = batch_arrays(n=N_RAYS)
    key = jax.random.PRNGKey(3)
    loss_j, grads_j, aux_j = fused_mega.mega_train_loss_and_grads(
        jmodel, params, JaxRender(**kw), {k: jnp.asarray(v) for k, v in b.items()}, key,
        interpret=True, emit_t_fine=True, exact_trig=exact)
    t_fine_j = np.asarray(aux_j["t_fine"])
    want = jax_grads_by_name(grads_j)
    batch = {k: t(v) for k, v in b.items()}
    draws = jax_draws(key, JaxRender(**kw), N_RAYS)
    render = RenderConfig(**kw)

    # The port's own step: its resample against the JAX kernel's.
    before = dict(_build.launch_counts)
    loss, grads, aux = mega_train.mega_train_loss_and_grads(
        model, render, batch, draws, emit_t_fine=True, exact_trig=exact)
    assert dict(_build.launch_counts) == before  # CPU tensors run the plain version
    assert set(aux) == {"loss", "rgb_loss", "fine_mse", "t_fine"}
    np.testing.assert_allclose(aux["t_fine"].numpy(), t_fine_j, rtol=0, atol=1e-4)

    # With the JAX kernel's t_fine held constant: the JAX package's tier-2
    # bound.
    inputs = mega_train.mega_inputs(model, batch, draws)
    with torch.no_grad():
        packed = classic_mlp.pack_classic_params(model.mlp)
    loss_c, loss_f, d_packed, t_held = mega_train.mega_train_plain(
        packed, *inputs, white_background=render.white_background, exact_trig=exact,
        t_fine=t(t_fine_j))
    np.testing.assert_array_equal(t_held.numpy(), t_fine_j)
    np.testing.assert_allclose(float(loss_c + loss_f), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(2.0 * float(loss_f), float(aux_j["fine_mse"]), rtol=1e-5)
    want_packed = {k: np.asarray(v) for k, v in fused_mlp.pack_classic_params(grads_j).items()}
    assert_grads_within({k: v.numpy() for k, v in d_packed.items()}, want_packed, 5e-5)

    # The port's own step against the JAX kernel, and against the reuse
    # path (the JAX package's tier-3 bound).
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-4)
    assert_grads_within({k: v.numpy() for k, v in grads.items()}, want, 5e-3)
    loss_r, grads_r, aux_r = fine_stage_train.reuse_train_loss_and_grads(
        model, render, batch, draws)
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=1e-4)
    np.testing.assert_allclose(float(aux["fine_mse"]), float(aux_r["fine_mse"]), rtol=1e-4)
    assert_grads_within({k: v.numpy() for k, v in grads.items()},
                        {k: v.numpy() for k, v in grads_r.items()}, 5e-3)
