"""The classic kernels at a latent-conditioned model's encoding widths,
held against the JAX package on the CPU.

The conditional trainer (``cli/train_conditional.py``) gives the density
branch 3 + s inputs, s the state's scalars, so its encodings are 20 (3 + s)
+ 36 wide: 200 + 36 for a 7-joint arm's angles, 700 + 36 for a 32-scalar
state.  On the card every classic kernel runs its tensor-core tile at those
widths (``csrc/tc_mlp.cuh``, note 9: the encodings stream through the tile a
k-chunk at a time); on the CPU the wrappers run their plain versions, held
here, with inputs from numpy seeds:

* at hidden 32 against the JAX package's Pallas kernels in interpret mode
  (exact two-pass LayerNorm statistics): K1-fwd against
  ``classic_mlp_pallas`` (rtol 1e-4, atol 1e-5, as
  ``test_torch_kernels.py``), K1-bwd against its VJP (losses rtol 1e-5,
  gradients within 2e-4 of their largest entry, as
  ``test_torch_train_kernels.py``), K4 against
  ``fine_union_eval_pallas`` (rgb and acc rtol 5e-4, atol 1e-4, depth rtol
  1e-3, as ``test_torch_kernels.py``);
* the conditional model's coarse-only fused step against JAX's, which is
  its encodings and one K2: the encodings to the last bit of a sine, the
  loss and gradients against JAX's K2 (``classic_train_grads_pallas``) on
  those encodings at K2's bounds;
* at hidden 256 on a few hundred rows, the card's tolerances: the plain
  versions with their products emulated as 3xTF32 (``tc_mlp.tc_matmul``)
  against their float32 selves (K1-fwd rtol 1e-4, atol 1e-4; gradients,
  the encodings' cotangents included, within relative L2 1e-2 and 1e-4 of
  their largest entry; K2's loss rtol 1e-4, as ``test_torch_tc.py``), and
  with the bf16 products emulated (``compute_dtype="bfloat16"``) against
  the same roundings summed in float64 at the card's bf16 bounds (relative
  L2 1e-2 for outputs and losses, 2e-2 for gradients) and against float32
  at the JAX package's own bf16 bound (outputs rtol 0.1, atol 0.15);
* the operand images of the encodings' slabs round-trip at K 200 and 700,
  TF32 and bf16, forward and backward.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nerf_tpu import ClassicNeRF as JaxNeRF
from nerf_tpu import ClassicNeRFConfig as JaxConfig
from nerf_tpu.ops import encoding as jenc
from nerf_tpu.ops.pallas import fused_hier, fused_mlp, fused_train
from nerf_tpu_torch import ClassicNeRF, ClassicNeRFConfig, RenderConfig
from nerf_tpu_torch.models.mlp import ClassicMLP
from nerf_tpu_torch.ops import compositing, sampling
from nerf_tpu_torch.ops.kernels import _build, classic_mlp, tc_mlp, train_grads, union_eval
from nerf_tpu_torch.testing import Bf16Float64Sums
from nerf_tpu_torch.train import loop
from nerf_tpu_torch.utils.pth_import import jax_params_from_classic_state_dict
from test_torch_kernels import union_inputs
from test_torch_train_kernels import assert_close_normalised, assert_packed_close, t
from test_torch_train_kernels import train_inputs

# State scalars of the conditional trainer's density inputs (3 + s): the
# encodings 200 + 36 and 700 + 36.
STATES = (7, 32)
K1_JAX_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-5
K1_CARD_TOL = dict(rtol=1e-4, atol=1e-4)
CARD_GRAD_REL_L2 = 1e-2
CARD_GRAD_ATOL = 1e-4  # of the largest entry
CARD_LOSS_RTOL = 1e-4
JAX_BF16 = dict(rtol=0.1, atol=0.15)
BF16_FWD, BF16_GRAD = 1e-2, 2e-2  # the card's bf16 bounds, relative L2


@pytest.fixture(autouse=True)
def exact_ln_stats():
    prev = fused_mlp._LN_STATS
    fused_mlp._LN_STATS = "twopass"
    yield
    fused_mlp._LN_STATS = prev


def quick_jit(fn):
    """``jax.jit`` with XLA's backend optimisation and LLVM's expensive
    passes off: each reference runs once on small shapes, so its compile
    time is its cost."""
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0,
                                         "xla_llvm_disable_expensive_passes": True})


@functools.lru_cache(maxsize=None)
def models(hidden, s):
    """The conditional model with an s-scalar state in both packages, the
    same weights (the port's, from a seed; the density head biased to a
    positive density, as ``test_torch_render.py``'s) and the JAX package's
    frequency constants: ``(JAX model, JAX parameters, port model)``, made
    once."""
    kw = dict(hidden_size=hidden, normalize_position=6.0, density_inputs=3 + s, use_pallas=True)
    model = ClassicNeRF(ClassicNeRFConfig(**kw), generator=torch.Generator().manual_seed(s),
                        device="cpu")
    cfg = model.cfg
    with torch.no_grad():
        model.mlp.density.weight.mul_(0.05)
        model.mlp.density.bias.fill_(0.5)
        model.x_scales.copy_(torch.tensor(
            jenc.frequency_scales_np(cfg.x_positional_encoding_size, cfg.normalize_position)))
        model.d_scales.copy_(torch.tensor(
            jenc.frequency_scales_np(cfg.d_positional_encoding_size, cfg.direction_bound)))
    params = jax_params_from_classic_state_dict(model.mlp.state_dict(), cfg)
    return JaxNeRF(JaxConfig(**kw)), params, model


def small_model(s):
    """The conditional model at hidden 32: its config, JAX parameters and
    packed port weights (the same values)."""
    _, params, model = models(32, s)
    packed = {k: v.detach() for k, v in classic_mlp.pack_classic_params(model.mlp).items()}
    return model.cfg, params, packed


def test_conditional_widths():
    assert [ClassicNeRFConfig(density_inputs=3 + s).x_encoding_dim for s in STATES] == [200, 700]
    assert ClassicNeRFConfig().d_encoding_dim == 36


# -- the plain versions against the Pallas kernels, hidden 32 ---------------


@pytest.mark.parametrize("s", STATES)
def test_k1_plain_matches_pallas_and_its_vjp(s):
    """K1-fwd against ``classic_mlp_pallas``, and K1-bwd with the encodings'
    cotangents (the call the card now serves on the tensor cores in float32
    too) and without, against its VJP, on 100 rows."""
    cfg, params, packed = small_model(s)
    rng = np.random.default_rng(s)
    n = 100
    x = rng.normal(size=(n, cfg.x_encoding_dim)).astype(np.float32)
    d = rng.normal(size=(n, cfg.d_encoding_dim)).astype(np.float32)
    g_out = rng.normal(size=(n, 1 + cfg.color_outputs)).astype(np.float32)
    def reference(p, x, d, g):
        out, vjp = jax.vjp(lambda p, x, d: fused_mlp.classic_mlp_pallas(p, x, d, interpret=True),
                           p, x, d)
        return out, vjp(g)

    (dens, col), (gp, gx, gd) = quick_jit(reference)(
        params, jnp.asarray(x), jnp.asarray(d),
        (jnp.asarray(g_out[:, :1]), jnp.asarray(g_out[:, 1:])))
    before = dict(_build.launch_counts)
    out = classic_mlp.classic_mlp_fwd(packed, t(x), t(d))
    np.testing.assert_allclose(out[:, :1].numpy(), np.asarray(dens), **K1_JAX_TOL)
    np.testing.assert_allclose(out[:, 1:].numpy(), np.asarray(col), **K1_JAX_TOL)
    dx, dd, d_packed = classic_mlp.classic_mlp_bwd(packed, t(x), t(d), t(g_out))
    assert dict(_build.launch_counts) == before  # the plain versions launch nothing
    assert_packed_close(d_packed, gp)
    assert_close_normalised(dx.numpy(), gx, "dx")
    assert_close_normalised(dd.numpy(), gd, "dd")
    dx, dd, d_packed = classic_mlp.classic_mlp_bwd(packed, t(x), t(d), t(g_out),
                                                   input_grads=False)
    assert dx is None and dd is None
    assert_packed_close(d_packed, gp)


@pytest.mark.parametrize("s", STATES)
def test_k4_plain_matches_pallas(s):
    cfg, params, packed = small_model(s)
    a = union_inputs(cfg, seed=s)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    rgb_r, depth_r, acc_r = quick_jit(
        lambda p, *a: fused_hier.fine_union_eval_pallas(p, *a, interpret=True))(
        params, j["x_enc"], j["d_enc"], j["t_coarse"], j["t_fine"], j["dens_c"], j["col_c"],
        j["dnorm"])
    rgb, depth, acc = union_eval.union_eval(packed, **{k: t(v) for k, v in a.items()})
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_r), rtol=5e-4, atol=1e-4)
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_r), rtol=5e-4, atol=1e-4)
    np.testing.assert_allclose(depth.numpy(), np.asarray(depth_r), rtol=1e-3)


@pytest.mark.parametrize("s", STATES)
def test_conditional_coarse_step_matches_jax(s):
    """The conditional trainer's step (coarse-only, per-ray states) through
    ``make_fused_loss_and_grads``, with evenly spaced samples and no density
    noise, against JAX's fused coarse-only step, which is its encodings
    (``encode_inputs_flat``) and one K2 (``classic_train_grads_pallas``;
    ``stage_inputs`` in ``nerf_tpu/train/loop.py``): the step's encodings
    against JAX's to the last bit of a sine (2^-23), and its loss and
    gradients against JAX's K2 on those encodings at K2's bounds.  (Held
    against JAX's whole step instead, the gradients also carry the sines'
    last-bit differences, which a sum over the rows can magnify past 2e-4
    where its terms cancel: ``b_dens`` at 7 scalars, 7.5e-4.)"""
    jmodel, params, model = models(32, s)
    rng = np.random.default_rng(10 + s)
    n, samples = 16, 16
    b = dict(rays_o=(rng.normal(size=(n, 3)) * 0.3).astype(np.float32),
             rays_d=rng.normal(size=(n, 3)).astype(np.float32),
             pixels=rng.uniform(size=(n, 3)).astype(np.float32),
             states_x=rng.normal(size=(n, s)).astype(np.float32))
    render_kw = dict(num_coarse_samples=samples, near=2.0, far=6.0, randomly_sample=False,
                     density_noise_std=0.0)
    t_coarse = sampling.sample_linear(None, (n,), samples, 2.0, 6.0, randomly_sample=False,
                                      device="cpu")
    draws = sampling.StepDraws(t_coarse, torch.zeros(n, samples), None, None)
    batch = {k: t(v) for k, v in b.items()}
    loss, grads, _ = loop.make_fused_loss_and_grads(model, RenderConfig(**render_kw))(
        batch, draws)
    x_enc, d_enc = model.encode_inputs_flat(batch["rays_o"], batch["rays_d"], t_coarse,
                                            batch["states_x"], None)
    x_j, d_j = quick_jit(lambda *a: jmodel.encode_inputs_flat(*a, None))(
        jnp.asarray(b["rays_o"]), jnp.asarray(b["rays_d"]), jnp.asarray(t_coarse.numpy()),
        jnp.asarray(b["states_x"]))
    np.testing.assert_allclose(x_enc.numpy(), np.asarray(x_j), rtol=0, atol=2.0 ** -23)
    np.testing.assert_allclose(d_enc.numpy(), np.asarray(d_j), rtol=0, atol=2.0 ** -23)
    dists = compositing.distances_from_tvals(t_coarse, batch["rays_d"])
    loss_k2, grads_k2 = quick_jit(lambda p, *a: fused_train.classic_train_grads_pallas(
        p, *a, samples, interpret=True))(
        params, jnp.asarray(x_enc.reshape(n, samples, -1).numpy()),
        jnp.asarray(d_enc.reshape(n, samples, -1).numpy()), jnp.asarray(dists.numpy()),
        jnp.zeros((n, samples)), jnp.asarray(b["pixels"]))
    np.testing.assert_allclose(float(loss), float(loss_k2), rtol=LOSS_RTOL)
    mlp = ClassicMLP(model.cfg, device="cpu")
    mlp.load_state_dict({k[len("mlp."):]: v for k, v in grads.items()})
    assert_packed_close(classic_mlp.pack_classic_params(mlp.requires_grad_(False)), grads_k2)


# -- the card's precision at full width, hidden 256 ---------------------------


def full_width_case(s, rows=256, seed=0):
    cfg = ClassicNeRFConfig(density_inputs=3 + s)
    mlp = ClassicMLP(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    packed = classic_mlp.pack_classic_params(mlp.requires_grad_(False))
    rng = np.random.default_rng(seed + s)
    x = t(rng.uniform(-1, 1, (rows, cfg.x_encoding_dim)).astype(np.float32))
    d = t(rng.uniform(-1, 1, (rows, cfg.d_encoding_dim)).astype(np.float32))
    g_out = t(rng.uniform(-1, 1, (rows, 1 + cfg.color_outputs)).astype(np.float32))
    return cfg, packed, x, d, g_out


def assert_grads_within_card_bounds(got: dict, ref: dict):
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        rel = float((got[k] - r).norm() / r.norm().clamp_min(1e-30))
        assert rel <= CARD_GRAD_REL_L2, (k, rel)
        scale = float(r.abs().max()) + 1e-12
        assert float((got[k] - r).abs().max()) <= CARD_GRAD_ATOL * scale, k


@pytest.mark.parametrize("s", STATES)
def test_3xtf32_products_meet_the_card_tolerance(s):
    """K1-fwd, K1-bwd (with the encodings' cotangents) and K2 at hidden 256
    with their products emulated as 3xTF32, against their float32 selves."""
    cfg, packed, x, d, g_out = full_width_case(s)
    ref = classic_mlp.classic_mlp_fwd_plain(packed, x, d)
    got = classic_mlp.classic_mlp_fwd_plain(packed, x, d, matmul=tc_mlp.tc_matmul)
    assert not torch.equal(got, ref)  # the emulation is not the float32 path
    torch.testing.assert_close(got, ref, **K1_CARD_TOL)
    rdx, rdd, ref = classic_mlp.classic_mlp_bwd_plain(packed, x, d, g_out)
    dx, dd, got = classic_mlp.classic_mlp_bwd_plain(packed, x, d, g_out,
                                                    matmul=tc_mlp.tc_matmul_autograd)
    assert_grads_within_card_bounds(got | {"dx": dx, "dd": dd}, ref | {"dx": rdx, "dd": rdd})
    a = {k: None if v is None else t(v) for k, v in train_inputs(cfg, rays=2, s=64,
                                                                 seed=s).items()}
    r_loss, r_grads = train_grads.classic_train_grads_plain(packed, **a, num_samples=64)
    e_loss, e_grads = train_grads.classic_train_grads_plain(packed, **a, num_samples=64,
                                                            matmul=tc_mlp.tc_matmul_autograd)
    torch.testing.assert_close(e_loss, r_loss, rtol=CARD_LOSS_RTOL, atol=0)
    assert_grads_within_card_bounds(e_grads, r_grads)


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("s", STATES)
def test_bf16_products_meet_the_card_bounds(s):
    """compute_dtype="bfloat16" at hidden 256: the plain bf16 versions (every
    product's operands rounded to bfloat16, float32 sums), which the card
    holds its bf16 kernels to, against the same roundings summed in float64
    (``Bf16Float64Sums``) within the card's bf16 bounds: K1-fwd's outputs
    on 256 rows (relative L2 1e-2) and K2's loss (1e-2) and gradients
    (2e-2) on 2 rays x 64 samples; and K1-fwd's bf16 outputs against
    float32 at the JAX package's own bf16 bound."""
    cfg, packed, x, d, _ = full_width_case(s)
    x16, d16 = x.bfloat16(), d.bfloat16()
    out = classic_mlp.classic_mlp_fwd_plain(packed, x16, d16)
    wide = classic_mlp.classic_mlp_fwd_plain(packed, x16, d16, matmul=Bf16Float64Sums.apply)
    assert not torch.equal(out, wide)
    assert rel_l2(out, wide) <= BF16_FWD
    torch.testing.assert_close(out, classic_mlp.classic_mlp_fwd_plain(packed, x, d), **JAX_BF16)
    a = {k: t(v) for k, v in train_inputs(cfg, rays=2, s=64, seed=s).items()}
    a["x_enc"], a["d_enc"] = a["x_enc"].bfloat16(), a["d_enc"].bfloat16()
    loss, grads = train_grads.classic_train_grads_plain(packed, **a, num_samples=64)
    loss64, grads64 = train_grads.classic_train_grads_plain(packed, **a, num_samples=64,
                                                            matmul=Bf16Float64Sums.apply)
    assert rel_l2(float(loss), float(loss64)) <= BF16_FWD
    assert rel_l2(np.concatenate([grads[k].numpy().ravel() for k in grads64]),
                  np.concatenate([grads64[k].numpy().ravel() for k in grads64])) <= BF16_GRAD


# -- the operand images --------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [200, 700])
def test_operand_images_round_trip_at_latent_widths(k, dtype):
    """w0's and wx's forward images ([H][K], K-major) at K 200 and 700
    unpack to the split (TF32) or rounded (bf16) slabs, zero past K; and the
    backward image of an input slab [K][H] holds its rows padded to 64,
    each 64-row pass one image."""
    hidden = 256
    w = t(np.random.default_rng(k).uniform(-1, 1, (2, hidden, k)).astype(np.float32))
    img = tc_mlp.operand_image(w, dtype)
    kp = tc_mlp.round_up_chunk(k, dtype)
    hi, lo = tc_mlp.operand_image_unpack(img, hidden, k)
    if dtype == torch.bfloat16:
        assert lo is None
        torch.testing.assert_close(hi[..., :k].float(), tc_mlp.bf16_round(w), rtol=0, atol=0)
        assert int((hi[..., k:] != 0).sum()) == 0
    else:
        want_hi, want_lo = tc_mlp.tf32_split(F.pad(w, (0, kp - k)))
        assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
    slab = w[0].t().contiguous()  # an input slab as packed, [K][H]
    back = tc_mlp.input_image(slab, dtype)
    rows = tc_mlp.round_up_input(k)
    passes = back.reshape(rows // 64, -1)
    for p in range(rows // 64):
        part, _ = tc_mlp.operand_image_unpack(passes[p], 64, hidden)
        want = F.pad(slab, (0, 0, 0, rows - k))[64 * p:64 * (p + 1)]
        if dtype == torch.bfloat16:
            torch.testing.assert_close(part.float(), tc_mlp.bf16_round(want), rtol=0, atol=0)
        else:
            assert torch.equal(part, tc_mlp.tf32_split(want)[0])
