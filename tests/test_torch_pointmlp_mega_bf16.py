"""``compute_dtype="bfloat16"`` for K8 (``point_mlp.classic_pointmlp``: the
classic MLP on raw points and directions, the encoding inside the kernel)
and K9 (``mega_train.mega_train_loss_and_grads``: the whole reuse step in
one call), held against the JAX package on the CPU.

On the CPU the wrappers run their plain versions with the bf16 products
emulated (``tc_mlp.bf16_matmul_autograd``: operands rounded to bfloat16,
float32 sums, the heads' products too); the JAX side runs
``classic_pointmlp_pallas(..., compute_dtype=bfloat16)`` and
``fused_mega.mega_train_loss_and_grads`` on a bfloat16 ``ClassicNeRF`` in
interpret mode, at the JAX package's default LayerNorm statistics, as its
users run them.  The CUDA kernels run only on a card
(``test_torch_cuda.py``).  The model is ``test_torch_train_reuse.py``'s
(hidden 64, encodings 60 + 36, the JAX package's frequency constants).

Tolerances, in relative L2 over a whole output or over all gradients
together: 5e-3, as ``test_torch_bf16.py``.  K9's fine t-values are
compared in probability (``sampling.pdf_cdf_at`` of the port's coarse
weights), as ``test_torch_mega.py`` compares them: the two packages' bf16
coarse weights differ by bf16's roundings, and a bin that holds little
mass turns that into a large shift in t.  Each case also holds bf16
against float32 at the JAX package's own bf16 bounds
(``test_pallas.py::TestBfloat16Path``): outputs within rtol 0.1, atol
0.15; gradients' cosine above 0.98.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu import RenderConfig as JaxRender
from nerf_tpu.ops.pallas import fused_mega, fused_mlp
from nerf_tpu_torch import RenderConfig
from nerf_tpu_torch.ops import sampling
from nerf_tpu_torch.ops.kernels import _build, classic_mlp, mega_train, point_mlp
from test_torch_train_reuse import batch_arrays, jax_draws, make_models

REL_L2 = 5e-3
BF16 = jnp.bfloat16
T_FINE_MASS = 5e-3  # the port's cdf at JAX's fine t-values against the uniforms
N_RAYS = 8


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def flat(packed: dict, keys) -> np.ndarray:
    return np.concatenate([np.asarray(packed[k], np.float64).ravel() for k in keys])


def jax_packed(grads) -> dict:
    return {k: np.asarray(v) for k, v in fused_mlp.pack_classic_params(grads).items()}


def assert_grads_close(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    err = rel_l2(flat({k: got[k].detach().numpy() for k in want}, want), flat(want, want))
    assert err <= REL_L2, err


def assert_direction_kept(bf16: dict, f32: dict) -> None:
    """The JAX package's bound on bf16 gradients against float32."""
    a, b = flat(bf16, f32), flat(f32, f32)
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    assert cos > 0.98, cos


def assert_jax_bf16_bound(bf16, f32) -> None:
    np.testing.assert_allclose(np.asarray(bf16), np.asarray(f32), rtol=0.1, atol=0.15)


def enc_args(cfg):
    return (cfg.x_positional_encoding_size, cfg.normalize_position,
            cfg.d_positional_encoding_size, cfg.direction_bound)


def raw_inputs(n=256, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-2, 2, size=(n, 3)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32))


def point_setup():
    jmodel, params, model = make_models()
    packed = classic_mlp.pack_classic_params(model.mlp.requires_grad_(False))
    consts = point_mlp.encoding_consts(*enc_args(model.cfg), "cpu")
    return jmodel, params, model, packed, consts


# -- K8 -----------------------------------------------------------------------


def test_k8_fwd_bf16_matches_jax():
    jmodel, params, model, packed, consts = point_setup()
    pts, dirs = raw_inputs()
    d_jax, c_jax = fused_mlp.classic_pointmlp_pallas(
        params, jnp.asarray(pts), jnp.asarray(dirs), *enc_args(jmodel.cfg), compute_dtype=BF16,
        interpret=True)
    before = dict(_build.launch_counts)
    with torch.no_grad():
        density, color = point_mlp.classic_pointmlp(
            model, t(pts), t(dirs), *enc_args(model.cfg), compute_dtype="bfloat16")
        dens32, col32 = point_mlp.classic_pointmlp(model, t(pts), t(dirs), *enc_args(model.cfg))
    assert dict(_build.launch_counts) == before  # the plain version launches nothing
    assert density.dtype == color.dtype == torch.float32
    got = torch.cat([density, color], -1).numpy()
    assert rel_l2(got, np.concatenate([np.asarray(d_jax), np.asarray(c_jax)], -1)) <= REL_L2
    assert_jax_bf16_bound(got, torch.cat([dens32, col32], -1).numpy())
    # The wrapper's call is the plain bf16 version.
    want = point_mlp.classic_pointmlp_fwd_plain(packed, t(pts), t(dirs), consts,
                                                dtype=torch.bfloat16)
    torch.testing.assert_close(torch.from_numpy(got), want, rtol=0, atol=0)


def test_k8_bf16_rounds_at_the_encodings():
    """The one new rounding point: the plain bf16 forward on the float32
    sines equals, bitwise, K1-fwd's plain bf16 forward on the encodings
    rounded to bfloat16 (``rounded_encodings``, what K8-bwd writes to its
    scratch), and differs from the float32 forward."""
    _, _, _, packed, consts = point_setup()
    pts, dirs = (t(a) for a in raw_inputs(n=64, seed=4))
    x_enc, d_enc = point_mlp.rounded_encodings(pts, dirs, consts, torch.bfloat16)
    assert x_enc.dtype == d_enc.dtype == torch.bfloat16
    x32, d32 = point_mlp.rounded_encodings(pts, dirs, consts)
    torch.testing.assert_close(x32, torch.sin(pts @ consts[0] + consts[1]), rtol=0, atol=0)
    torch.testing.assert_close(x_enc, x32.bfloat16(), rtol=0, atol=0)
    got = point_mlp.classic_pointmlp_fwd(packed, pts, dirs, consts, dtype=torch.bfloat16)
    torch.testing.assert_close(got, classic_mlp.classic_mlp_fwd_plain(packed, x_enc, d_enc),
                               rtol=0, atol=0)
    assert not torch.allclose(got, point_mlp.classic_pointmlp_fwd(packed, pts, dirs, consts),
                              rtol=1e-4, atol=1e-4)


def test_k8_bwd_bf16_matches_jax():
    """K8-bwd's raw-input and weight cotangents against the VJP of JAX's
    bf16 kernel on random output cotangents; the raw inputs' cotangents are
    float32 in both (the chain rule takes the encodings' float32
    cotangents)."""
    jmodel, params, model, packed, consts = point_setup()
    pts, dirs = raw_inputs(seed=5)
    g_out = np.random.default_rng(6).normal(size=(pts.shape[0], 4)).astype(np.float32)
    _, vjp = jax.vjp(lambda p, x, d: fused_mlp.classic_pointmlp_pallas(
        p, x, d, *enc_args(jmodel.cfg), compute_dtype=BF16, interpret=True),
        params, jnp.asarray(pts), jnp.asarray(dirs))
    gp, gx, gd = vjp((jnp.asarray(g_out[:, :1]), jnp.asarray(g_out[:, 1:])))
    assert gx.dtype == gd.dtype == jnp.float32
    dpts, ddirs, d_packed = point_mlp.classic_pointmlp_bwd(
        packed, t(pts), t(dirs), consts, t(g_out), dtype=torch.bfloat16)
    assert dpts.dtype == ddirs.dtype == torch.float32
    assert_grads_close(d_packed, jax_packed(gp))
    assert rel_l2(dpts.numpy(), gx) <= REL_L2
    assert rel_l2(ddirs.numpy(), gd) <= REL_L2
    # Without the raw inputs' cotangents, the same weight gradients.
    none_p, none_d, d_packed2 = point_mlp.classic_pointmlp_bwd(
        packed, t(pts), t(dirs), consts, t(g_out), input_grads=False, dtype=torch.bfloat16)
    assert none_p is None and none_d is None
    for k, v in d_packed.items():
        torch.testing.assert_close(d_packed2[k], v, rtol=0, atol=0)


def objective_grads(model, pts, dirs, compute_dtype) -> dict:
    """``test_pallas.py``'s bf16 objective, mean(density^2) +
    mean(sin(color)), through ``classic_pointmlp`` under autograd: the
    packed weights' gradients and the raw inputs'."""
    packed = classic_mlp.pack_classic_params(model.mlp)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in packed.items()}
    x, d = pts.clone().requires_grad_(True), dirs.clone().requires_grad_(True)
    dens, col = point_mlp.classic_pointmlp(leaves, x, d, *enc_args(model.cfg),
                                           compute_dtype=compute_dtype)
    loss = dens.pow(2).mean() + torch.sin(col).mean()
    grads = torch.autograd.grad(loss, [x, d, *leaves.values()])
    return dict(zip(["points", "dirs", *leaves], (g.numpy() for g in grads)))


def test_k8_autograd_bf16_matches_jax_grad():
    """Under autograd (``ClassicPointMLPFunction``, K8-fwd then K8-bwd in
    bf16) against ``jax.grad`` of the same objective through JAX's bf16
    kernel, and the weights' bf16 gradients against float32 at the JAX
    package's bound."""
    jmodel, params, model, _, _ = point_setup()
    pts, dirs = raw_inputs(seed=7)

    def jax_loss(p, x, d):
        dens, col = fused_mlp.classic_pointmlp_pallas(p, x, d, *enc_args(jmodel.cfg),
                                                      compute_dtype=BF16, interpret=True)
        return jnp.mean(dens ** 2) + jnp.mean(jnp.sin(col))

    gp, gx, gd = jax.grad(jax_loss, argnums=(0, 1, 2))(params, jnp.asarray(pts),
                                                        jnp.asarray(dirs))
    got = objective_grads(model, t(pts), t(dirs), "bfloat16")
    want = jax_packed(gp)
    assert_grads_close({k: torch.from_numpy(got[k]) for k in want}, want)
    assert rel_l2(got["points"], gx) <= REL_L2
    assert rel_l2(got["dirs"], gd) <= REL_L2
    # The JAX package's bound holds the weights' gradients (the raw inputs'
    # carry the top octave's frequency, about 134, times bf16's rounding).
    f32 = objective_grads(model, t(pts), t(dirs), "float32")
    assert_direction_kept({k: got[k] for k in want}, {k: f32[k] for k in want})


def test_k8_refuses_other_compute_dtypes():
    _, _, model, packed, consts = point_setup()
    pts, dirs = torch.zeros(4, 3), torch.ones(4, 3)
    with pytest.raises(ValueError, match="compute_dtype"):
        point_mlp.classic_pointmlp(model, pts, dirs, *enc_args(model.cfg), compute_dtype="float16")
    with pytest.raises(TypeError, match="compute dtype"):
        point_mlp.classic_pointmlp_fwd(packed, pts, dirs, consts, dtype=torch.float16)


# -- K9 -----------------------------------------------------------------------

# (white_background, exact_trig); each case is one JAX K9 call in bf16.
CASES = [(False, True), (True, False)]
# The port's own step against JAX's: its own resample moves the fine
# samples within T_FINE_MASS of JAX's in probability, and the top encoding
# octave (about 134 at bound 6) magnifies a shift in t.
OWN_STEP_REL_L2 = 1e-2


def render_kwargs(white):
    return dict(num_coarse_samples=8, num_fine_samples=16, near=2.0, far=6.0,
                randomly_sample=True, density_noise_std=1.0, reuse_coarse_in_fine=True,
                white_background=white)


def packed_grads(model, grads) -> dict:
    return {k: v.detach() for k, v in classic_mlp.pack_classic_params(
        _module_with(model, grads)).items()}


@pytest.mark.parametrize("white,exact", CASES)
def test_k9_step_bf16_matches_jax(white, exact):
    """One bf16 step against JAX's K9 in interpret mode with its draws:
    with JAX's fine t-values held, the loss and the gradients within 5e-3;
    the port's own resample in probability, and its own step."""
    jmodel, params, model = make_models(compute_dtype="bfloat16")
    _, _, model32 = make_models()
    kw = render_kwargs(white)
    b = batch_arrays(n=N_RAYS)
    key = jax.random.PRNGKey(0)
    loss_j, grads_j, aux_j = fused_mega.mega_train_loss_and_grads(
        jmodel, params, JaxRender(**kw), {k: jnp.asarray(v) for k, v in b.items()}, key,
        interpret=True, emit_t_fine=True, exact_trig=exact)
    t_fine_j = t(np.asarray(aux_j["t_fine"]))
    want = jax_packed(grads_j)
    batch = {k: t(v) for k, v in b.items()}
    draws = jax_draws(key, JaxRender(**kw), N_RAYS)
    render = RenderConfig(**kw)

    inputs = mega_train.mega_inputs(model, batch, draws)
    x_enc_c, d_ray = inputs[:2]
    assert x_enc_c.dtype == d_ray.dtype == torch.bfloat16
    assert all(a.dtype == torch.float32 for a in inputs[2:])
    with torch.no_grad():
        packed = classic_mlp.pack_classic_params(model.mlp)

    # With JAX's fine t-values held: the same function, within 5e-3.
    loss_c, loss_f, d_packed, _ = mega_train.mega_train_plain(
        packed, *inputs, white_background=white, exact_trig=exact, t_fine=t_fine_j)
    assert rel_l2(float(loss_c + loss_f), float(loss_j)) <= REL_L2
    assert rel_l2(2.0 * float(loss_f), float(aux_j["fine_mse"])) <= REL_L2
    assert_grads_close(d_packed, want)

    # The port's own step: its resample against JAX's in probability (the
    # port's coarse cdf at both sets of fine t-values against the uniforms),
    # its loss and gradients against JAX's.
    before = dict(_build.launch_counts)
    loss, grads, aux = mega_train.mega_train_loss_and_grads(
        model, render, batch, draws, emit_t_fine=True, exact_trig=exact)
    assert dict(_build.launch_counts) == before  # CPU tensors run the plain version
    t_c, noise_c, u = inputs[2:5]
    weights_c = mega_train.coarse_weights_plain(packed, x_enc_c, d_ray, t_c, noise_c,
                                                inputs[7])
    bins = 0.5 * (t_c[:, 1:] + t_c[:, :-1])
    for t_fine in (t_fine_j, aux["t_fine"]):
        mass = (sampling.pdf_cdf_at(bins, weights_c[:, 1:-1], t_fine) - u).abs().max()
        assert float(mass) <= T_FINE_MASS, float(mass)
    assert rel_l2(float(loss), float(loss_j)) <= REL_L2
    got = packed_grads(model, grads)
    err = rel_l2(flat(got, want), flat(want, want))
    assert err <= OWN_STEP_REL_L2, err

    # bf16 against float32: the loss at the JAX package's bound (the
    # gradients' direction: test_k9_bf16_keeps_the_float32_direction).
    loss32, _, _ = mega_train.mega_train_loss_and_grads(model32, render, batch, draws,
                                                        exact_trig=exact)
    assert_jax_bf16_bound(float(loss), float(loss32))


@pytest.mark.parametrize("white", [False, True])
def test_k9_bf16_keeps_the_float32_direction(white):
    """The bf16 step's gradients keep a cosine above 0.98 to the float32
    step's (the JAX package's bound) at 64 rays.  At 8 and 32 rays JAX's
    own K9 and the port sit at 0.974-0.980 alike
    (``scripts/torch_bf16_step_spread.py``)."""
    _, _, model = make_models(compute_dtype="bfloat16")
    _, _, model32 = make_models()
    kw = render_kwargs(white)
    batch = {k: t(v) for k, v in batch_arrays(n=64).items()}
    draws = jax_draws(jax.random.PRNGKey(0), JaxRender(**kw), 64)
    loss, grads, _ = mega_train.mega_train_loss_and_grads(model, RenderConfig(**kw), batch,
                                                          draws)
    loss32, grads32, _ = mega_train.mega_train_loss_and_grads(model32, RenderConfig(**kw),
                                                              batch, draws)
    assert_jax_bf16_bound(float(loss), float(loss32))
    f32 = {k: v.numpy() for k, v in packed_grads(model32, grads32).items()}
    assert_direction_kept({k: v.numpy() for k, v in packed_grads(model, grads).items()}, f32)


def _module_with(model, grads):
    """model.mlp with its parameters replaced by ``grads`` (packing is
    linear, so it maps gradients like weights)."""
    mlp = type(model.mlp)(model.cfg, device="cpu")
    mlp.load_state_dict({k[len("mlp."):]: v for k, v in grads.items()})
    return mlp


def test_k9_bf16_rounds_the_fine_encodings():
    """The one new rounding point of the step: the plain bf16 step's fine
    stage runs K1-fwd's plain bf16 forward on the fine encodings rounded to
    bfloat16 (the rows the kernel writes to its scratch, which its products
    would round to the same values)."""
    _, _, model = make_models(compute_dtype="bfloat16")
    b = {k: t(v) for k, v in batch_arrays(n=4).items()}
    draws = jax_draws(jax.random.PRNGKey(5), JaxRender(**render_kwargs(False)), 4)
    inputs = mega_train.mega_inputs(model, b, draws)
    packed = classic_mlp.pack_classic_params(model.mlp.requires_grad_(False))
    t_fine = torch.sort(torch.rand(4, 16, generator=torch.Generator().manual_seed(0)) * 4 + 2)[0]
    stages = []
    original = mega_train._stage_out

    def recording(w, x_enc, *args):
        stages.append((x_enc, original(w, x_enc, *args)))
        return stages[-1][1]

    mega_train._stage_out = recording
    try:
        mega_train.mega_train_plain(packed, *inputs, t_fine=t_fine)
    finally:
        mega_train._stage_out = original
    (x_c, _), (x_fine, out_fine) = stages
    x_f = mega_train.encode_fine_plain(t_fine, inputs[6], inputs[7], inputs[9], inputs[10])
    assert x_c.dtype == torch.bfloat16
    torch.testing.assert_close(x_fine, x_f.bfloat16(), rtol=0, atol=0)
    d = inputs[1][:, None].expand(4, 16, -1).reshape(64, -1)
    want = classic_mlp.classic_mlp_fwd_plain(packed, x_f.bfloat16(), d)
    torch.testing.assert_close(out_fine.detach().reshape(64, -1), want, rtol=0, atol=0)
    # The products round the float32 rows to the same values, and the
    # float32 forward differs.
    torch.testing.assert_close(classic_mlp.classic_mlp_fwd_plain(packed, x_f, d, bf16=True),
                               want, rtol=0, atol=0)
    assert not torch.allclose(classic_mlp.classic_mlp_fwd_plain(packed, x_f, d.float()), want,
                              rtol=1e-4, atol=1e-4)


# -- the C interfaces -----------------------------------------------------------


def c_parameter_count(function: str) -> int:
    """The parameters of ``extern "C" int <function>(...)`` in the library's
    source under ``csrc/``."""
    for src in _build.CSRC.glob("*.cu"):
        m = re.search(rf'extern "C" int {function}\(([^)]*)\)', src.read_text())
        if m:
            return len(m.group(1).split(","))
    raise AssertionError(f"no extern \"C\" {function} under {_build.CSRC}")


@pytest.mark.parametrize("name", ["classic_pointmlp_fwd", "classic_pointmlp_bwd", "mega_train"])
def test_bf16_entries_take_what_the_build_binds(name):
    """Each new ``<name>_bf16`` has its float32 twin's parameters, as
    ``_build`` binds it, and is loaded with the library."""
    assert c_parameter_count(f"{name}_bf16") == c_parameter_count(name)
    assert _build.ARGTYPES[f"{name}_bf16"] == _build.ARGTYPES[name]
    assert f"{name}_bf16" in _build.FUNCTIONS[name]
