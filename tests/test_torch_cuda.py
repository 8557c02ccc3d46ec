"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and ``nvcc`` and skips without one (the
kernels have no CPU mode).  The file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: K1 sums float32-accurate products in another order than
cuBLAS (TF32 off), through ten LayerNorm'd layers; K4 adds the transmittance summed in
merged order where the plain version sums two blocks and cross terms.  The
mip kernels (K5-K7) the same through five layers; K7's transmittance is
the exponential of a prefix sum of logs where the plain version takes a
cumulative product.  K8 adds the device's sine of the same arguments; K9
is held against its plain version with its own fine t-values (its resample
against the plain one separately), as the JAX package holds its kernel.

K1-fwd, K1-bwd (without the encodings' cotangents), K2, K3, K4, K5-fwd,
K5-bwd, K6, K7, K8-fwd, K8-bwd and K9 run their MLP products as 3xTF32 on
the tensor cores (``csrc/tc_mlp.cuh``; K5-bwd's and K8-bwd's inputs'
cotangents too), at the same tolerances: their cases cover every
hidden width, row counts that are not a multiple of 64, encoding widths
that are not a multiple of 8 (and mip heads of 54 and 9 outputs), runs
with and without the view branch, and two calls must agree bitwise.
Where a latent-conditioned model's encodings (a mip model's features) are
too wide for the tensor-core tile the kernels run the float32 SIMT tile
(``_build.tile_plan``): the ``latent_full_width`` cases (K8's and
K5's ``wide`` ones) check that the policy each call recorded is the
one its byte count predicts; past the
SIMT tile the wrappers raise before any launch.  The
products alone (``tc_linear``, ``tc_wgrad`` of ``csrc/tc_product.cu``) are
held against the CPU emulation of the same arithmetic
(``tc_mlp.tc_matmul``) and against the float64 product.
"""

import pytest
import torch
import torch.nn.functional as F

from nerf_tpu_torch import ClassicNeRF, ClassicNeRFConfig, MipNeRF, MipNeRFConfig, RenderConfig
from nerf_tpu_torch.models.mlp import ClassicMLP, MipMLP
from nerf_tpu_torch.ops import compositing, sampling
from nerf_tpu_torch.ops.kernels import (
    _build,
    classic_mlp,
    fine_stage_train,
    mega_train,
    mip_mlp,
    mip_train,
    point_mlp,
    tc_mlp,
    train_grads,
    union_eval,
)
from nerf_tpu_torch.testing import bf16_step_reference, mip_head_rounding, plain_versions

K1_TOL = dict(rtol=1e-4, atol=1e-4)
K4_TOL = dict(rtol=5e-4, atol=1e-4)

VARIANTS = {
    "full_width": dict(hidden_size=256),
    "h128": dict(hidden_size=128),
    "no_view": dict(hidden_size=64, use_viewdirs=False),
    "latent": dict(hidden_size=32, density_inputs=5, color_inputs=4),
}
# Encoding widths beside VARIANTS' 60 + 36 (and the small latent model's):
# a latent-conditioned full-width model (2 + 1 latent scalars: xe 100, de
# 48), past the tensor-core tiles at hidden 256; and encodings past every
# tile (xe 600 + de 36, past the float32 SIMT tiles' 588 and K4's 572).
WIDE_VARIANTS = {
    "latent_full_width": dict(hidden_size=256, density_inputs=5, color_inputs=4),
    "too_wide": dict(hidden_size=256, density_inputs=30),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def packed_weights(variant, device):
    cfg = ClassicNeRFConfig(**{**VARIANTS, **WIDE_VARIANTS}[variant])
    mlp = ClassicMLP(cfg, generator=torch.Generator().manual_seed(0), device=device)
    return cfg, classic_mlp.pack_classic_params(mlp.requires_grad_(False))


def rand(gen, *shape, lo=-1.0, hi=1.0):
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def union_args(cfg, packed, device, rays, sc, sf, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    t_c = torch.sort(rand(gen, rays, sc, lo=2.0, hi=6.0), -1).values
    t_f = rand(gen, rays, sf, lo=2.0, hi=6.0)
    t_f[:, 1] = t_c[:, min(3, sc - 1)]  # ties: coarse sorts first
    t_f = torch.sort(t_f, -1).values
    d_enc = rand(gen, rays, cfg.d_encoding_dim) if cfg.use_viewdirs else None
    return (packed, rand(gen, rays, sf, cfg.x_encoding_dim), d_enc, t_c, t_f,
            rand(gen, rays, sc, 1, lo=-3.0, hi=6.0), rand(gen, rays, sc, 3, lo=-3.0, hi=3.0),
            rand(gen, rays, lo=0.5, hi=2.0))


@pytest.mark.cuda
@pytest.mark.parametrize("points", [1, 1000])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_classic_mlp_fwd_kernel_matches_plain(cuda, variant, points):
    cfg, packed = packed_weights(variant, cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = rand(gen, points, cfg.x_encoding_dim)
    d = rand(gen, points, cfg.d_encoding_dim) if cfg.use_viewdirs else None
    before = _build.launch_counts[classic_mlp.NAME]
    out = classic_mlp.classic_mlp_fwd(packed, x, d)
    torch.cuda.synchronize()
    assert _build.launch_counts[classic_mlp.NAME] == before + 1
    torch.testing.assert_close(out, classic_mlp.classic_mlp_fwd_plain(packed, x, d), **K1_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("sc,sf", [(16, 24), (64, 128), (7, 256)])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_union_eval_kernel_matches_plain(cuda, variant, sc, sf):
    cfg, packed = packed_weights(variant, cuda)
    args = union_args(cfg, packed, cuda, rays=37, sc=sc, sf=sf)
    before = _build.launch_counts[union_eval.NAME]
    got = union_eval.union_eval(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts[union_eval.NAME] == before + 1
    for g, r in zip(got, union_eval.union_eval_plain(*args)):
        torch.testing.assert_close(g, r, **K4_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_union_eval_kernel_is_deterministic(cuda, variant):
    """Two K4 calls give bitwise the same outputs (a fixed order of
    tensor-core products; every width, with and without the view branch)."""
    cfg, packed = packed_weights(variant, cuda)
    args = union_args(cfg, packed, cuda, rays=37, sc=64, sf=128)
    first, second = union_eval.union_eval(*args), union_eval.union_eval(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_wrappers_raise_instead_of_falling_back(cuda):
    cfg, packed = packed_weights("no_view", cuda)
    with pytest.raises(ValueError, match="samples"):
        union_eval.union_eval(*union_args(cfg, packed, cuda, rays=2, sc=8, sf=257))
    x = torch.zeros(4, cfg.x_encoding_dim)  # on the CPU, weights on the card
    with pytest.raises(ValueError, match="cpu"):
        classic_mlp.classic_mlp_fwd(packed, x)
    mlp48 = ClassicMLP(ClassicNeRFConfig(hidden_size=48, use_viewdirs=False), device=cuda)
    packed48 = classic_mlp.pack_classic_params(mlp48.requires_grad_(False))
    with pytest.raises(ValueError, match="hidden width"):
        classic_mlp.classic_mlp_fwd(packed48, torch.zeros(4, cfg.x_encoding_dim, device=cuda))
    # The training kernels: a CPU tensor among card tensors, a width or a
    # sample count the kernel does not take.
    with pytest.raises(ValueError, match="cpu"):
        classic_mlp.classic_mlp_bwd(packed, torch.zeros(4, cfg.x_encoding_dim, device=cuda),
                                    None, torch.zeros(4, 4))
    with pytest.raises(ValueError, match="hidden width"):
        classic_mlp.classic_mlp_bwd(packed48, torch.zeros(4, cfg.x_encoding_dim, device=cuda),
                                    None, torch.zeros(4, 4, device=cuda))
    a = train_inputs(cfg, cuda, rays=1, s=train_grads.MAX_SAMPLES + 1)
    with pytest.raises(ValueError, match="samples"):
        train_grads.classic_train_grads(packed, **a, num_samples=train_grads.MAX_SAMPLES + 1)
    a = fine_inputs(cfg, cuda, rays=2, sc=8, sf=fine_stage_train.MAX_SAMPLES + 1)
    with pytest.raises(ValueError, match="samples"):
        fine_stage_train.fine_stage_train(packed, **a)
    a = fine_inputs(cfg, cuda, rays=2, sc=8, sf=8)
    a["pixels"] = a["pixels"].cpu()
    with pytest.raises(ValueError, match="cpu"):
        fine_stage_train.fine_stage_train(packed, **a)
    # Encodings past every tile's shared memory, the float32 SIMT tile's
    # too: each wrapper raises, naming the limit, before any launch.
    cfg, packed = packed_weights("too_wide", cuda)
    torch.cuda.synchronize()
    launches, policies = dict(_build.launch_counts), dict(_build.policy_counts)
    with pytest.raises(ValueError, match="limit"):
        union_eval.union_eval(*union_args(cfg, packed, cuda, rays=2, sc=8, sf=16))
    with pytest.raises(ValueError, match="limit"):
        train_grads.classic_train_grads(packed, **train_inputs(cfg, cuda, rays=1, s=8),
                                        num_samples=8)
    with pytest.raises(ValueError, match="limit"):
        fine_stage_train.fine_stage_train(packed, **fine_inputs(cfg, cuda, rays=2, sc=8, sf=8))
    x = torch.zeros(4, cfg.x_encoding_dim, device=cuda)
    d = torch.zeros(4, cfg.d_encoding_dim, device=cuda)
    with pytest.raises(ValueError, match="limit"):
        classic_mlp.classic_mlp_fwd(packed, x, d)
    for input_grads in (True, False):
        with pytest.raises(ValueError, match="limit"):
            classic_mlp.classic_mlp_bwd(packed, x, d, torch.zeros(4, 4, device=cuda),
                                        input_grads=input_grads)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == launches and dict(_build.policy_counts) == policies


@pytest.mark.cuda
def test_render_rays_fused_matches_plain_on_card(cuda):
    models = {}
    for use_pallas in (False, True):
        model = ClassicNeRF(ClassicNeRFConfig(hidden_size=64, normalize_position=6.0,
                                              use_pallas=use_pallas),
                            generator=torch.Generator().manual_seed(0), device=cuda)
        with torch.no_grad():  # mass in every bin (see chip_smoke.py)
            model.mlp.density.bias.fill_(0.5)
            model.mlp.density.weight.mul_(0.05)
        models[use_pallas] = model
    gen = torch.Generator(device=cuda).manual_seed(2)
    rays_o, rays_d = rand(gen, 300, 3, lo=-0.5, hi=0.5), rand(gen, 300, 3)
    render = RenderConfig(num_coarse_samples=32, num_fine_samples=64, randomly_sample=False)
    _build.launch_counts.clear()
    with torch.no_grad():
        got = models[True].render_rays(rays_o, rays_d, render, fused_eval=True)
        ref = models[False].render_rays(rays_o, rays_d, render, fused_eval=True)
    assert _build.launch_counts == {classic_mlp.NAME: 1, union_eval.NAME: 1}
    for g, r in zip((got.rgb, got.depth, got.acc), (ref.rgb, ref.depth, ref.acc)):
        torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-3)


# -- the training kernels: K1-bwd, K2, K3 ------------------------------------

# Losses: per-ray sums in another order than the plain version's mean.
# Gradients, normalised by their largest entry: float32 products summed over
# the points in split chunks where cuBLAS sums in one pass.  The row counts
# stay in the hundreds: a ReLU input within rounding of 0 takes the other
# branch in one of two float32 evaluations and moves its whole row's
# gradient; with a few hundred rows such a flip is rare.
LOSS_RTOL = 1e-4
GRAD_ATOL = 1e-4


def assert_grads_close(got: dict, ref: dict):
    assert got.keys() == ref.keys()
    for k in ref:
        scale = float(ref[k].abs().max()) + 1e-12
        torch.testing.assert_close(got[k] / scale, ref[k] / scale, rtol=0, atol=GRAD_ATOL,
                                   msg=lambda m, k=k: f"{k}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("points", [1, 200])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_classic_mlp_bwd_kernel_matches_plain(cuda, variant, points):
    """K1-bwd with the encodings' cotangents (float32 SIMT passes) and
    without (the tensor-core passes where the widths fit), on rows away
    from the ReLU kinks (``rows_away_from_kinks``, each row with its own
    view encoding): on plain random rows the tensor-core call of the
    full-width case met a kink (``scripts/torch_kink_rows.py``)."""
    cfg, packed = packed_weights(variant, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    d = rand(gen, points, cfg.d_encoding_dim) if cfg.use_viewdirs else None
    x = rows_away_from_kinks(packed, gen, points, 1, cfg.x_encoding_dim, d).reshape(points, -1)
    g_out = rand(gen, points, 1 + cfg.color_outputs)
    before = _build.launch_counts[classic_mlp.BWD_NAME]
    policies = dict(_build.policy_counts)
    dx, dd, d_packed = classic_mlp.classic_mlp_bwd(packed, x, d, g_out)
    torch.cuda.synchronize()
    assert _build.launch_counts[classic_mlp.BWD_NAME] == before + 1
    # The encodings' cotangents: the float32 SIMT passes.
    assert policy_moves(policies) == {(classic_mlp.BWD_NAME, "simt"): 1}
    rdx, rdd, r_packed = classic_mlp.classic_mlp_bwd_plain(packed, x, d, g_out)
    assert_grads_close(d_packed, r_packed)
    assert_grads_close({"dx": dx} | ({"dd": dd} if d is not None else {}),
                       {"dx": rdx} | ({"dd": rdd} if d is not None else {}))
    # As autograd calls it when the encodings need no gradient: the
    # tensor-core passes where the widths fit their fwd_store tile.
    policies = dict(_build.policy_counts)
    dx, dd, d_packed = classic_mlp.classic_mlp_bwd(packed, x, d, g_out, input_grads=False)
    torch.cuda.synchronize()
    assert dx is None and dd is None
    want = _build.tile_plan(classic_mlp.BWD_NAME, cfg.x_encoding_dim,
                            cfg.d_encoding_dim if cfg.use_viewdirs else 0, cfg.hidden_size).policy
    assert policy_moves(policies) == {(classic_mlp.BWD_NAME, want): 1}
    assert_grads_close(d_packed, r_packed)


def policy_moves(before: dict) -> dict:
    """The tile policies recorded since ``before`` (a copy of
    ``_build.policy_counts``), by how many calls."""
    return {k: v - before.get(k, 0) for k, v in _build.policy_counts.items()
            if v != before.get(k, 0)}


def rows_away_from_kinks(packed, gen, rays, s, xe, d_ray, matmul=torch.matmul):
    """``[rays, s, xe]`` encodings whose every row, with its ray's view
    encoding ``d_ray [rays, de]`` (``None`` without the view branch), has
    all its ReLU inputs farther than 1e-5 from 0: per ray the first ``s``
    of ``2 s + 8`` candidate rows drawn from ``gen`` (see
    ``away_from_kinks``: nearer the kink two float32-accurate evaluations,
    the kernel's and the plain one, can take different branches and move
    that row's whole gradient; ``matmul`` as in ``kink_margin``)."""
    m = 2 * s + 8
    cand = rand(gen, rays, m, xe)
    d = None if d_ray is None else d_ray[:, None].expand(rays, m, -1).reshape(rays * m, -1)
    with torch.no_grad():
        keep = (kink_margin(packed, cand.reshape(rays * m, xe), d, matmul) > 1e-5).reshape(rays, m)
    idx = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)[:, :s]
    assert bool(keep.gather(1, idx).all()), "too few candidate rows away from the kinks"
    return cand.gather(1, idx[..., None].expand(rays, s, xe)).contiguous()


def train_inputs(cfg, device, rays, s, seed=0, packed=None):
    """K2's inputs; with ``packed`` the encodings are drawn away from the
    ReLU kinks of those weights (``rows_away_from_kinks``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    t = torch.sort(rand(gen, rays, s, lo=2.0, hi=6.0), -1).values
    dists = compositing.distances_from_tvals(t, rand(gen, rays, 3))
    d_ray = rand(gen, rays, 1, cfg.d_encoding_dim)
    x_enc = rand(gen, rays, s, cfg.x_encoding_dim)
    if packed is not None:
        x_enc = rows_away_from_kinks(packed, gen, rays, s, cfg.x_encoding_dim,
                                     d_ray[:, 0] if cfg.use_viewdirs else None)
    return dict(
        x_enc=x_enc,
        d_enc=d_ray.expand(rays, s, -1).contiguous() if cfg.use_viewdirs else None,
        dists=dists.contiguous(), noise=rand(gen, rays, s),
        pixels=rand(gen, rays, cfg.color_outputs, lo=0.0, hi=1.0),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("white,with_weights", [(False, True), (True, False)])
@pytest.mark.parametrize("s", [7, 64])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_train_grads_kernel_matches_plain(cuda, variant, s, white, with_weights):
    cfg, packed = packed_weights(variant, cuda)
    a = train_inputs(cfg, cuda, rays=3, s=s, packed=packed)
    opts = dict(white_background=white, loss_weight=0.5, return_weights=with_weights)
    before = _build.launch_counts[train_grads.NAME]
    got = train_grads.classic_train_grads(packed, **a, num_samples=s, **opts)
    torch.cuda.synchronize()
    assert _build.launch_counts[train_grads.NAME] == before + 1
    ref = train_grads.classic_train_grads_plain(packed, **a, num_samples=s, **opts)
    torch.testing.assert_close(got[0], ref[0], rtol=LOSS_RTOL, atol=0)
    assert_grads_close(got[1], ref[1])
    if with_weights:
        torch.testing.assert_close(got[2], ref[2], rtol=1e-4, atol=1e-5)


def fine_inputs(cfg, device, rays, sc, sf, seed=0, packed=None):
    """K3's inputs; with ``packed`` the fine encodings are drawn away from
    the ReLU kinks of those weights (``rows_away_from_kinks``)."""
    args = union_args(cfg, None, device, rays, sc, sf, seed)
    _, x_enc, d_ray, t_c, t_f, dens_c, col_c, dnorm = args
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    if packed is not None:
        x_enc = rows_away_from_kinks(packed, gen, rays, sf, cfg.x_encoding_dim, d_ray)
    return dict(
        x_enc=x_enc,
        d_enc=d_ray[:, None, :].expand(rays, sf, -1).contiguous() if d_ray is not None else None,
        t_coarse=t_c, t_fine=t_f, dens_c=dens_c, col_c=col_c, dnorm=dnorm,
        noise_f=rand(gen, rays, sf), pixels=rand(gen, rays, 3, lo=0.0, hi=1.0),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("white", [False, True])
@pytest.mark.parametrize("sc,sf", [(7, 11), (64, 128)])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fine_stage_train_kernel_matches_plain(cuda, variant, sc, sf, white):
    cfg, packed = packed_weights(variant, cuda)
    a = fine_inputs(cfg, cuda, rays=3, sc=sc, sf=sf, packed=packed)
    before = _build.launch_counts[fine_stage_train.NAME]
    loss, d_packed, (gdc, gcc) = fine_stage_train.fine_stage_train(
        packed, **a, white_background=white, loss_weight=0.5)
    torch.cuda.synchronize()
    assert _build.launch_counts[fine_stage_train.NAME] == before + 1
    r_loss, r_packed, (rgdc, rgcc) = fine_stage_train.fine_stage_train_plain(
        packed, **a, white_background=white, loss_weight=0.5)
    torch.testing.assert_close(loss, r_loss, rtol=LOSS_RTOL, atol=0)
    assert_grads_close(d_packed | {"g_dens_c": gdc, "g_col_c": gcc},
                       r_packed | {"g_dens_c": rgdc, "g_col_c": rgcc})


def width_packed(device, hidden, view):
    cfg = ClassicNeRFConfig(hidden_size=hidden, use_viewdirs=view)
    mlp = ClassicMLP(cfg, generator=torch.Generator().manual_seed(0), device=device)
    return cfg, classic_mlp.pack_classic_params(mlp.requires_grad_(False))


@pytest.mark.cuda
@pytest.mark.parametrize("view", [True, False])
@pytest.mark.parametrize("hidden", classic_mlp.HIDDEN_WIDTHS)
def test_train_grads_kernel_matches_plain_at_every_width(cuda, hidden, view):
    """K2's tensor-core passes at every hidden width: 3 rays x 67 samples
    (201 rows, not a multiple of 64), encodings 60 + 36 (not multiples of
    8), rows away from the ReLU kinks, against plain at LOSS_RTOL and
    GRAD_ATOL; the call ran the tensor-core tile, and a second call gives
    bitwise the same loss, gradients and compositing weights (a fixed
    order of products, no atomics)."""
    cfg, packed = width_packed(cuda, hidden, view)
    a = train_inputs(cfg, cuda, rays=3, s=67, seed=hidden, packed=packed)
    opts = dict(num_samples=67, loss_weight=0.5, return_weights=True)
    before = _build.policy_counts[(train_grads.NAME, "tc")]
    first = train_grads.classic_train_grads(packed, **a, **opts)
    second = train_grads.classic_train_grads(packed, **a, **opts)
    torch.cuda.synchronize()
    assert _build.policy_counts[(train_grads.NAME, "tc")] == before + 2
    ref = train_grads.classic_train_grads_plain(packed, **a, **opts)
    torch.testing.assert_close(first[0], ref[0], rtol=LOSS_RTOL, atol=0)
    assert_grads_close(first[1], ref[1])
    torch.testing.assert_close(first[2], ref[2], rtol=1e-4, atol=1e-5)
    assert torch.equal(first[0], second[0]) and torch.equal(first[2], second[2])
    assert all(torch.equal(first[1][k], second[1][k]) for k in first[1])


@pytest.mark.cuda
@pytest.mark.parametrize("view", [True, False])
@pytest.mark.parametrize("hidden", classic_mlp.HIDDEN_WIDTHS)
def test_fine_stage_train_kernel_matches_plain_at_every_width(cuda, hidden, view):
    """K3's tensor-core passes at every hidden width: 3 rays x (7 + 67)
    (201 fine rows; wgrad reads the view encoding once per ray), encodings
    60 + 36, fine rows away from the ReLU kinks, against plain at LOSS_RTOL
    and GRAD_ATOL (the coarse cotangents too); the call ran the tensor-core
    tile, and a second call gives bitwise the same results."""
    cfg, packed = width_packed(cuda, hidden, view)
    a = fine_inputs(cfg, cuda, rays=3, sc=7, sf=67, seed=hidden, packed=packed)
    before = _build.policy_counts[(fine_stage_train.NAME, "tc")]
    first = fine_stage_train.fine_stage_train(packed, **a, loss_weight=0.5)
    second = fine_stage_train.fine_stage_train(packed, **a, loss_weight=0.5)
    torch.cuda.synchronize()
    assert _build.policy_counts[(fine_stage_train.NAME, "tc")] == before + 2
    ref = fine_stage_train.fine_stage_train_plain(packed, **a, loss_weight=0.5)
    torch.testing.assert_close(first[0], ref[0], rtol=LOSS_RTOL, atol=0)
    assert_grads_close(first[1] | {"g_dens_c": first[2][0], "g_col_c": first[2][1]},
                       ref[1] | {"g_dens_c": ref[2][0], "g_col_c": ref[2][1]})
    assert torch.equal(first[0], second[0])
    assert all(torch.equal(a_, b_) for a_, b_ in zip(first[2], second[2]))
    assert all(torch.equal(first[1][k], second[1][k]) for k in first[1])


def k1_inputs(cfg, packed, device, rays, s, seed=0):
    """K1's inputs: ``rays * s`` encoded rows away from the ReLU kinks of
    ``packed`` (``rows_away_from_kinks``), the view encoding constant along
    each ray as the reuse step gives it, and random output cotangents."""
    gen = torch.Generator(device=device).manual_seed(seed)
    d_ray = rand(gen, rays, cfg.d_encoding_dim) if cfg.use_viewdirs else None
    x = rows_away_from_kinks(packed, gen, rays, s, cfg.x_encoding_dim, d_ray)
    d = None if d_ray is None else d_ray[:, None].expand(rays, s, -1).reshape(rays * s, -1)
    return (x.reshape(rays * s, -1), None if d is None else d.contiguous(),
            rand(gen, rays * s, 1 + cfg.color_outputs))


@pytest.mark.cuda
@pytest.mark.parametrize("view", [True, False])
@pytest.mark.parametrize("hidden", classic_mlp.HIDDEN_WIDTHS)
def test_classic_mlp_kernels_match_plain_at_every_width(cuda, hidden, view):
    """K1-fwd and K1-bwd (as the reuse step calls it, no encoding
    cotangents) on the tensor cores at every hidden width: 3 rays x 67
    samples (201 rows, not a multiple of 64), encodings 60 + 36, rows away
    from the ReLU kinks, against plain at K1_TOL and GRAD_ATOL; every call
    ran the tensor-core tile, and a second call of each gives bitwise the
    same result (a fixed order of products, no atomics)."""
    cfg, packed = width_packed(cuda, hidden, view)
    x, d, g_out = k1_inputs(cfg, packed, cuda, rays=3, s=67, seed=hidden + 1)
    before = dict(_build.policy_counts)
    first, second = (classic_mlp.classic_mlp_fwd(packed, x, d) for _ in range(2))
    b_first, b_second = (classic_mlp.classic_mlp_bwd(packed, x, d, g_out, input_grads=False)
                         for _ in range(2))
    torch.cuda.synchronize()
    assert policy_moves(before) == {(classic_mlp.NAME, "tc"): 2, (classic_mlp.BWD_NAME, "tc"): 2}
    torch.testing.assert_close(first, classic_mlp.classic_mlp_fwd_plain(packed, x, d), **K1_TOL)
    _, _, ref = classic_mlp.classic_mlp_bwd_plain(packed, x, d, g_out, input_grads=False)
    assert b_first[0] is None and b_first[1] is None
    assert_grads_close(b_first[2], ref)
    assert torch.equal(first, second)
    assert all(torch.equal(b_first[2][k], b_second[2][k]) for k in ref)


def round_up4(n):
    return -(-n // 4) * 4


def predicted_tile_bytes(kernel, hidden, xe, de, colors, sc, sf):
    """(tensor-core, float32 SIMT) bytes of shared memory a block of the
    kernel's width-dependent tile takes, counted from the layouts of
    ``csrc/tc_mlp.cuh`` (K2's and K3's ``fwd_store``: four 16-value chunk
    buffers of hi and lo weights, the ``[64][H + 4]`` activation tile, the
    encoding tiles, 1024 bytes of alignment) and ``csrc/union_eval.cu``
    (K4's block: also the compositing scratch in the activation tile's
    place where larger, and the block's fine outputs); the SIMT tiles hold
    16 weight rows and a ``[64][H]`` activation tile."""
    enc = 64 * (round_up4(xe) + round_up4(de))
    ring, act_tc, act = 4 * 2 * hidden * 16, 64 * (hidden + 4), 64 * hidden
    if kernel != union_eval.NAME:
        return 4 * (ring + act_tc + enc) + 1024, 4 * (16 * hidden + act + enc)
    comp = 8 * 4 * (sc + sf)
    outs = (1 if sf >= 256 else 256 // sf) * sf * (1 + colors)
    return (4 * (ring + max(act_tc, comp) + enc + outs) + 1024,
            4 * (16 * hidden + max(act, comp) + enc + outs))


# The mip models of the tile-policy cases: the full-width MipNeRF (96
# features) and one with 144 (encoding_size 48), past the tensor-core tile.
MIP_TILE_CASES = {"full_width": dict(), "latent_full_width": dict(encoding_size=48)}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [union_eval.NAME, train_grads.NAME, fine_stage_train.NAME,
                                    classic_mlp.NAME, classic_mlp.BWD_NAME,
                                    mip_train.EVAL_NAME, mip_train.TRAIN_NAME])
@pytest.mark.parametrize("variant", ["full_width", "latent_full_width"])
def test_tile_policy_follows_the_byte_count(cuda, variant, kernel):
    """K4, K2, K3, K1-fwd and K1-bwd (no encoding cotangents) at full
    width with the default encodings (60 + 36) and a latent-conditioned
    model's (100 + 48), and K7 and K6 (seg weight 0.1) at full width with
    96 features and with 144 (``MIP_TILE_CASES``): the call matches plain
    at the kernel's tolerances (K1-bwd, K2, K3 and K6 on rows away from the
    ReLU kinks) and records the policy its byte count predicts, the tensor
    cores where their tile fits the device's opt-in shared memory a block,
    else the float32 SIMT tile (K1-fwd's tiles take ``fwd_store``'s bytes,
    K6's and K7's ``fwd_store``'s without view encodings).  On the H100
    (232,448 bytes) that is the tensor cores at 60 + 36 and 96, and the SIMT
    tile at 100 + 48 and 144, in all seven."""
    mip = kernel in (mip_train.EVAL_NAME, mip_train.TRAIN_NAME)
    if mip:
        cfg, packed = mip_packed("full_width", cuda, **MIP_TILE_CASES[variant])
        xe, de, colors, sc, sf = cfg.feature_dim, 0, cfg.color_outputs, 64, 128
    else:
        cfg, packed = packed_weights(variant, cuda)
        xe, de, colors, sc, sf = cfg.x_encoding_dim, cfg.d_encoding_dim, cfg.color_outputs, 64, 128
    tc_bytes, simt_bytes = predicted_tile_bytes(kernel, 256, xe, de, colors, sc, sf)
    plan = _build.tile_plan(kernel, xe, de, 256,
                            *((colors, sc, sf) if kernel == union_eval.NAME else ()))
    assert (plan.tc_bytes, plan.simt_bytes) == (tc_bytes, simt_bytes)
    limit = torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin
    assert plan.limit == limit
    want = "tc" if tc_bytes <= limit else "simt"
    assert plan.policy == want and simt_bytes <= limit
    assert want == ("tc" if variant == "full_width" else "simt")
    before = dict(_build.policy_counts)
    if kernel == union_eval.NAME:
        args = union_args(cfg, packed, cuda, rays=37, sc=sc, sf=sf)
        got = union_eval.union_eval(*args)
        torch.cuda.synchronize()
        for g, r in zip(got, union_eval.union_eval_plain(*args)):
            torch.testing.assert_close(g, r, **K4_TOL)
    elif kernel == classic_mlp.NAME:
        x, d, _ = k1_inputs(cfg, packed, cuda, rays=3, s=sc)
        got = classic_mlp.classic_mlp_fwd(packed, x, d)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, classic_mlp.classic_mlp_fwd_plain(packed, x, d), **K1_TOL)
    elif kernel == classic_mlp.BWD_NAME:
        x, d, g_out = k1_inputs(cfg, packed, cuda, rays=3, s=sc)
        got = classic_mlp.classic_mlp_bwd(packed, x, d, g_out, input_grads=False)
        torch.cuda.synchronize()
        ref = classic_mlp.classic_mlp_bwd_plain(packed, x, d, g_out, input_grads=False)
        assert_grads_close(got[2], ref[2])
    elif kernel == mip_train.EVAL_NAME:
        a = mip_inputs(cfg, cuda, rays=37, rows=sc - 1)
        args = (packed, a["features"], a["dists"], a["t_mids"])
        got = mip_train.mip_eval(*args)
        torch.cuda.synchronize()
        for g, r in zip(got, mip_train.mip_eval_plain(*args)):
            torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)
    elif kernel == mip_train.TRAIN_NAME:
        a = mip_inputs(cfg, cuda, rays=3, rows=sc - 1, packed=packed)
        args = (packed, a["features"], a["dists"], a["noise"], a["pixels"], a["labels"],
                cfg.color_outputs, 0.1)
        got = mip_train.mip_train_grads(*args)
        torch.cuda.synchronize()
        ref = mip_train.mip_train_grads_plain(*args)
        torch.testing.assert_close(got[0], ref[0], rtol=LOSS_RTOL, atol=0)
        torch.testing.assert_close(got[1], ref[1], rtol=LOSS_RTOL, atol=0)
        assert_grads_close(got[2], ref[2])
    elif kernel == train_grads.NAME:
        a = train_inputs(cfg, cuda, rays=3, s=sc, packed=packed)
        got = train_grads.classic_train_grads(packed, **a, num_samples=sc, loss_weight=0.5)
        torch.cuda.synchronize()
        ref = train_grads.classic_train_grads_plain(packed, **a, num_samples=sc, loss_weight=0.5)
        torch.testing.assert_close(got[0], ref[0], rtol=LOSS_RTOL, atol=0)
        assert_grads_close(got[1], ref[1])
    else:
        a = fine_inputs(cfg, cuda, rays=3, sc=sc, sf=sf, packed=packed)
        got = fine_stage_train.fine_stage_train(packed, **a, loss_weight=0.5)
        torch.cuda.synchronize()
        ref = fine_stage_train.fine_stage_train_plain(packed, **a, loss_weight=0.5)
        torch.testing.assert_close(got[0], ref[0], rtol=LOSS_RTOL, atol=0)
        assert_grads_close(got[1] | {"g_dens_c": got[2][0], "g_col_c": got[2][1]},
                           ref[1] | {"g_dens_c": ref[2][0], "g_col_c": ref[2][1]})
    assert policy_moves(before) == {(kernel, want): 1}


@pytest.mark.cuda
def test_classic_mlp_autograd_runs_both_kernels(cuda):
    cfg = ClassicNeRFConfig(hidden_size=64)
    mlp = ClassicMLP(cfg, generator=torch.Generator().manual_seed(0), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    x, d = rand(gen, 150, cfg.x_encoding_dim), rand(gen, 150, cfg.d_encoding_dim)
    g_out = rand(gen, 150, 4)
    _build.launch_counts.clear()
    out = classic_mlp.classic_mlp_fwd(classic_mlp.pack_classic_params(mlp), x, d)
    got = torch.autograd.grad(out, list(mlp.parameters()), g_out)
    assert _build.launch_counts == {classic_mlp.NAME: 1, classic_mlp.BWD_NAME: 1}
    out = classic_mlp.classic_mlp_fwd_plain(classic_mlp.pack_classic_params(mlp), x, d)
    ref = torch.autograd.grad(out, list(mlp.parameters()), g_out)
    assert_grads_close(dict(enumerate(got)), dict(enumerate(ref)))


# The fused step's kernel launches per branch of make_fused_loss_and_grads.
STEP_LAUNCHES = {
    "reuse": {classic_mlp.NAME: 1, classic_mlp.BWD_NAME: 1, fine_stage_train.NAME: 1},
    "coarse_only": {train_grads.NAME: 1},
    "reevaluate": {train_grads.NAME: 2},
}


@pytest.mark.cuda
@pytest.mark.parametrize("branch", sorted(STEP_LAUNCHES))
def test_fused_train_step_matches_plain_on_card(cuda, branch):
    from nerf_tpu_torch.ops import sampling
    from nerf_tpu_torch.train import make_fused_loss_and_grads, make_loss_fn

    models = {}
    for use_pallas in (False, True):
        model = ClassicNeRF(ClassicNeRFConfig(hidden_size=64, normalize_position=6.0,
                                              use_pallas=use_pallas),
                            generator=torch.Generator().manual_seed(0), device=cuda)
        with torch.no_grad():  # mass in every bin (see chip_smoke.py)
            model.mlp.density.bias.fill_(0.5)
            model.mlp.density.weight.mul_(0.05)
        models[use_pallas] = model
    render = RenderConfig(num_coarse_samples=16, num_fine_samples=0 if branch == "coarse_only" else 24,
                          randomly_sample=True, density_noise_std=1.0,
                          reuse_coarse_in_fine=branch == "reuse")
    gen = torch.Generator(device=cuda).manual_seed(5)
    batch = {"rays_o": rand(gen, 8, 3, lo=-0.5, hi=0.5), "rays_d": rand(gen, 8, 3),
             "pixels": rand(gen, 8, 3, lo=0.0, hi=1.0)}
    draws = sampling.draw_step(gen, render, 8, cuda)
    _build.launch_counts.clear()
    loss, grads, _ = make_fused_loss_and_grads(models[True], render)(batch, draws)
    torch.cuda.synchronize()
    assert _build.launch_counts == STEP_LAUNCHES[branch]
    with torch.enable_grad():
        ref_loss, _ = make_loss_fn(models[False], render)(batch, draws)
    names, params = zip(*models[False].named_parameters())
    ref = dict(zip(names, torch.autograd.grad(ref_loss, params)))
    torch.testing.assert_close(loss, ref_loss.detach(), rtol=LOSS_RTOL, atol=0)
    assert_grads_close(grads, ref)


# -- the mip kernels: K5-fwd, K5-bwd, K6, K7 ----------------------------------

MIP_VARIANTS = {
    "full_width": dict(),
    "small": dict(hidden_size=64, num_hidden_layers=3, encoding_size=8, segmentation_outputs=5),
}


def mip_packed(variant, device, **overrides):
    """A mip model's packed weights from seed 0, its LayerNorms drawn off
    identity (so their gradients mean something) from a seeded generator:
    the same weights in every process."""
    cfg = MipNeRFConfig(**{**MIP_VARIANTS[variant], **overrides})
    mlp = MipMLP(cfg, generator=torch.Generator().manual_seed(0), device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    with torch.no_grad():
        for m in mlp.modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.uniform_(-0.3, 0.3, generator=gen)
    return cfg, mip_mlp.pack_mip_params(mlp.requires_grad_(False))


@pytest.mark.cuda
@pytest.mark.parametrize("points", [1, 1000])
@pytest.mark.parametrize("variant", sorted(MIP_VARIANTS))
def test_mip_mlp_fwd_kernel_matches_plain(cuda, variant, points):
    cfg, packed = mip_packed(variant, cuda)
    x = rand(torch.Generator(device=cuda).manual_seed(1), points, cfg.feature_dim)
    before = _build.launch_counts[mip_mlp.NAME]
    policies = dict(_build.policy_counts)
    out = mip_mlp.mip_mlp_fwd(packed, x)
    torch.cuda.synchronize()
    assert _build.launch_counts[mip_mlp.NAME] == before + 1
    assert policy_moves(policies) == {(mip_mlp.NAME, "tc"): 1}
    torch.testing.assert_close(out, mip_mlp.mip_mlp_fwd_plain(packed, x), **K1_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("input_grads", [True, False])
@pytest.mark.parametrize("points", [1, 200])
@pytest.mark.parametrize("variant", sorted(MIP_VARIANTS))
def test_mip_mlp_bwd_kernel_matches_plain(cuda, variant, points, input_grads):
    """K5-bwd against plain on features away from the mip order's ReLU
    kinks (``mip_rows_away_from_kinks``), drawn after the cotangents: on
    plain random rows one run of the full-width case met a kink (``w_in``
    off by 1.76e-2 of its largest entry)."""
    cfg, packed = mip_packed(variant, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    x, g_out = rand(gen, points, cfg.feature_dim), rand(gen, points, cfg.num_outputs)
    x = mip_rows_away_from_kinks(packed, gen, 1, points, cfg.feature_dim)[0]
    before = _build.launch_counts[mip_mlp.BWD_NAME]
    policies = dict(_build.policy_counts)
    dx, d_packed = mip_mlp.mip_mlp_bwd(packed, x, g_out, input_grads=input_grads)
    torch.cuda.synchronize()
    assert _build.launch_counts[mip_mlp.BWD_NAME] == before + 1
    # The tensor-core passes, the features' cotangent included.
    assert policy_moves(policies) == {(mip_mlp.BWD_NAME, "tc"): 1}
    rdx, r_packed = mip_mlp.mip_mlp_bwd_plain(packed, x, g_out, input_grads=input_grads)
    assert (dx is None) == (not input_grads)
    assert_grads_close(d_packed | ({"dx": dx} if input_grads else {}),
                       r_packed | ({"dx": rdx} if input_grads else {}))


def mip_inputs(cfg, device, rays, rows, seed=0, packed=None):
    """K6's and K7's inputs; with ``packed`` the features are drawn, after
    the rest, away from the ReLU kinks of those weights
    (``mip_rows_away_from_kinks``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    points = torch.cumsum(rand(gen, rays, rows, 3, lo=0.0, hi=1.0), dim=1)
    a = dict(
        features=rand(gen, rays, rows, cfg.feature_dim),
        dists=compositing.distances_from_points(points).contiguous(),
        noise=rand(gen, rays, rows),
        pixels=rand(gen, rays, cfg.color_outputs, lo=0.0, hi=1.0),
        labels=torch.randint(0, cfg.segmentation_outputs, (rays,), generator=gen, device=device),
        t_mids=rand(gen, rays, rows, lo=0.1, hi=60.0),
    )
    if packed is not None:
        a["features"] = mip_rows_away_from_kinks(packed, gen, rays, rows, cfg.feature_dim)
    return a


def mip_kink_margin(packed, features, matmul=torch.matmul):
    """Per row, the smallest |ReLU input| of the plain mip forward: in the
    mip order the LayerNorm output ``xhat g + beta``
    (``mip_mlp_fwd_plain``'s layers; ``matmul`` its products)."""
    h, margins = features, []
    for i in range(packed["b"].shape[0]):
        z = matmul(h, packed["w_in"] if i == 0 else packed["whh"][i - 1]) + packed["b"][i]
        y = F.layer_norm(z, z.shape[-1:], packed["g"][i], packed["beta"][i], 1e-5)
        margins.append(y.abs().amin(-1))
        h = torch.relu(y)
    return torch.stack(margins).amin(0)


def mip_rows_away_from_kinks(packed, gen, rays, rows, n_feat, bf16=False):
    """``[rays, rows, n_feat]`` features whose every row has all its ReLU
    inputs farther than 1e-5 from 0: per ray the first ``rows`` of ``2 rows
    + 8`` candidates drawn from ``gen`` (``rows_away_from_kinks`` for the
    mip order: nearer the kink the kernel's and the plain evaluation can
    take different branches and move that row's whole gradient).  With
    ``bf16`` the candidates are rounded to bfloat16 (the returned float32
    rows convert exactly) and their margin is the bf16 forward's."""
    m = 2 * rows + 8
    cand = rand(gen, rays, m, n_feat)
    matmul = torch.matmul
    if bf16:
        cand, matmul = tc_mlp.bf16_round(cand), tc_mlp.bf16_matmul
    with torch.no_grad():
        keep = (mip_kink_margin(packed, cand.reshape(rays * m, n_feat), matmul)
                > 1e-5).reshape(rays, m)
    idx = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)[:, :rows]
    assert bool(keep.gather(1, idx).all()), "too few candidate rows away from the kinks"
    return cand.gather(1, idx[..., None].expand(rays, rows, n_feat)).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("white,noise", [(False, False), (True, True)])
@pytest.mark.parametrize("rows", [13, 63])
@pytest.mark.parametrize("variant", sorted(MIP_VARIANTS))
def test_mip_eval_kernel_matches_plain(cuda, variant, rows, white, noise):
    cfg, packed = mip_packed(variant, cuda)
    a = mip_inputs(cfg, cuda, rays=37, rows=rows)
    args = (packed, a["features"], a["dists"], a["t_mids"], a["noise"] if noise else None,
            cfg.color_outputs, white)
    before = _build.launch_counts[mip_train.EVAL_NAME]
    got = mip_train.mip_eval(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts[mip_train.EVAL_NAME] == before + 1
    for g, r in zip(got, mip_train.mip_eval_plain(*args)):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("seg_weight,white", [(0.0, False), (0.1, False), (0.25, True)])
@pytest.mark.parametrize("rows", [13, 63])
@pytest.mark.parametrize("variant", sorted(MIP_VARIANTS))
def test_mip_train_grads_kernel_matches_plain(cuda, variant, rows, seg_weight, white):
    """K6 against plain on features away from the mip order's ReLU kinks
    (``mip_rows_away_from_kinks``): ``mip_packed`` draws the LayerNorms
    from the global RNG, whose state differs between processes, and on
    plain random rows one run of the small case met a kink on the tensor
    cores (``w_in`` off by 2.95e-2 of its largest entry)."""
    cfg, packed = mip_packed(variant, cuda)
    a = mip_inputs(cfg, cuda, rays=3, rows=rows, packed=packed)
    args = (packed, a["features"], a["dists"], a["noise"], a["pixels"], a["labels"],
            cfg.color_outputs, seg_weight, white)
    before = _build.launch_counts[mip_train.TRAIN_NAME]
    rgb_loss, seg_loss, d_packed = mip_train.mip_train_grads(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts[mip_train.TRAIN_NAME] == before + 1
    r_rgb, r_seg, r_packed = mip_train.mip_train_grads_plain(*args)
    torch.testing.assert_close(rgb_loss, r_rgb, rtol=LOSS_RTOL, atol=0)
    torch.testing.assert_close(seg_loss, r_seg, rtol=LOSS_RTOL, atol=0)
    assert_grads_close(d_packed, r_packed)
    if seg_weight == 0.0:  # the segmentation head gets zero gradients, as in JAX
        assert not bool(d_packed["w_out"][:, 1 + cfg.color_outputs:].any())
        assert not bool(d_packed["b_out"][1 + cfg.color_outputs:].any())


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(MIP_VARIANTS))
@pytest.mark.parametrize("hidden", classic_mlp.HIDDEN_WIDTHS)
def test_mip_kernels_match_plain_at_every_width(cuda, hidden, variant):
    """K7 and K6 (seg weight 0.1) on the tensor cores at every hidden width
    of both mip variants (96 and 24 features; 54 and 9 outputs, so the
    head's tensor-core dW has N not a multiple of 4, odd in the small one):
    3 rays x 67 rows (201, not a multiple of 64), features away from the
    ReLU kinks, against plain at K7's 1e-4 and K6's LOSS_RTOL and
    GRAD_ATOL; every call ran the tensor-core tile, and a second call of
    each gives bitwise the same results (a fixed order of products, no
    atomics)."""
    cfg, packed = mip_packed(variant, cuda, hidden_size=hidden)
    a = mip_inputs(cfg, cuda, rays=3, rows=67, seed=hidden, packed=packed)
    e_args = (packed, a["features"], a["dists"], a["t_mids"], a["noise"], cfg.color_outputs)
    t_args = (packed, a["features"], a["dists"], a["noise"], a["pixels"], a["labels"],
              cfg.color_outputs, 0.1)
    before = dict(_build.policy_counts)
    e_first, e_second = (mip_train.mip_eval(*e_args) for _ in range(2))
    t_first, t_second = (mip_train.mip_train_grads(*t_args) for _ in range(2))
    torch.cuda.synchronize()
    assert policy_moves(before) == {(mip_train.EVAL_NAME, "tc"): 2,
                                    (mip_train.TRAIN_NAME, "tc"): 2}
    for g, r in zip(e_first, mip_train.mip_eval_plain(*e_args)):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)
    r_rgb, r_seg, r_packed = mip_train.mip_train_grads_plain(*t_args)
    torch.testing.assert_close(t_first[0], r_rgb, rtol=LOSS_RTOL, atol=0)
    torch.testing.assert_close(t_first[1], r_seg, rtol=LOSS_RTOL, atol=0)
    assert_grads_close(t_first[2], r_packed)
    assert all(torch.equal(x, y) for x, y in zip(e_first, e_second))
    assert torch.equal(t_first[0], t_second[0]) and torch.equal(t_first[1], t_second[1])
    assert all(torch.equal(t_first[2][k], t_second[2][k]) for k in r_packed)


@pytest.mark.cuda
def test_mip_wrappers_raise_past_every_tile(cuda):
    """Features past the float32 SIMT tile too (600 at hidden 256, past its
    588): K6 and K7 raise, naming the limit, with nothing launched or
    counted."""
    cfg, packed = mip_packed("full_width", cuda, encoding_size=200)
    a = mip_inputs(cfg, cuda, rays=2, rows=5)
    torch.cuda.synchronize()
    launches, policies = dict(_build.launch_counts), dict(_build.policy_counts)
    with pytest.raises(ValueError, match="limit"):
        mip_train.mip_eval(packed, a["features"], a["dists"], a["t_mids"])
    with pytest.raises(ValueError, match="limit"):
        mip_train.mip_train_grads(packed, a["features"], a["dists"], a["noise"], a["pixels"],
                                  a["labels"], seg_weight=0.1)
    assert dict(_build.launch_counts) == launches
    assert dict(_build.policy_counts) == policies


@pytest.mark.cuda
def test_mip_wrappers_raise_instead_of_falling_back(cuda):
    cfg, packed = mip_packed("small", cuda)
    with pytest.raises(ValueError, match="cpu"):
        mip_mlp.mip_mlp_fwd(packed, torch.zeros(4, cfg.feature_dim))
    # bfloat16 features with float32 images, or float16 features: raise
    # before any launch (never a cast, never the float32 kernel).
    features16 = torch.zeros(4, cfg.feature_dim, device=cuda, dtype=torch.bfloat16)
    f32_fwd, f32_bwd = tc_mlp.tc_images(packed, backward=True)
    before = dict(_build.launch_counts)
    with pytest.raises(TypeError, match="tc_fwd must be bfloat16"):
        mip_mlp.mip_mlp_fwd(packed, features16, tc_fwd=f32_fwd)
    with pytest.raises(TypeError, match="tc_bwd must be bfloat16"):
        mip_mlp.mip_mlp_bwd(packed, features16, torch.zeros(4, cfg.num_outputs, device=cuda),
                            tc_fwd=tc_mlp.tc_images(packed, dtype=torch.bfloat16)[0],
                            tc_bwd=f32_bwd)
    a16 = mip_inputs(cfg, cuda, rays=2, rows=7)
    with pytest.raises(TypeError, match="float32"):
        mip_train.mip_eval(packed, a16["features"].half(), a16["dists"], a16["t_mids"])
    with pytest.raises(TypeError, match="tc_fwd must be bfloat16"):
        mip_train.mip_train_grads(packed, a16["features"].bfloat16(), a16["dists"],
                                  a16["noise"], a16["pixels"], a16["labels"], seg_weight=0.1,
                                  tc_fwd=f32_fwd, tc_bwd=f32_bwd)
    assert dict(_build.launch_counts) == before
    packed48 = mip_mlp.pack_mip_params(
        MipMLP(MipNeRFConfig(hidden_size=48), device=cuda).requires_grad_(False))
    with pytest.raises(ValueError, match="hidden width"):
        mip_mlp.mip_mlp_bwd(packed48, torch.zeros(4, 96, device=cuda),
                            torch.zeros(4, 54, device=cuda))
    a = mip_inputs(cfg, cuda, rays=2, rows=mip_train.MAX_ROWS + 1)
    with pytest.raises(ValueError, match="rows"):
        mip_train.mip_eval(packed, a["features"], a["dists"], a["t_mids"])
    a = mip_inputs(cfg, cuda, rays=2, rows=7)
    with pytest.raises(ValueError, match="labels"):
        mip_train.mip_train_grads(packed, a["features"], a["dists"], a["noise"], a["pixels"],
                                  None, seg_weight=0.1)
    with pytest.raises(ValueError, match="cpu"):
        mip_train.mip_train_grads(packed, a["features"], a["dists"], a["noise"],
                                  a["pixels"].cpu(), a["labels"], seg_weight=0.1)


@pytest.mark.cuda
def test_mip_paths_launch_their_kernels_and_match_plain(cuda):
    from nerf_tpu_torch.train import loop

    models = {}
    for use_pallas in (False, True):
        cfg = MipNeRFConfig(**MIP_VARIANTS["small"], use_pallas=use_pallas)
        models[use_pallas] = MipNeRF(cfg, generator=torch.Generator().manual_seed(0), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(6)
    rays_o, rays_d = rand(gen, 300, 3, lo=-0.5, hi=0.5), rand(gen, 300, 3)
    render = RenderConfig(num_coarse_samples=16, randomly_sample=False)
    _build.launch_counts.clear()
    with torch.no_grad():
        got = models[True].render_rays(rays_o, rays_d, render, fused_eval=True)
        ref = models[False].render_rays(rays_o, rays_d, render, fused_eval=True)
    assert _build.launch_counts == {mip_train.EVAL_NAME: 1}
    for g, r in zip(got[:4], ref[:4]):
        torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-3)

    train_render = RenderConfig(num_coarse_samples=16, randomly_sample=True, density_noise_std=1.0)
    batch = {"rays_o": rays_o[:8], "rays_d": rays_d[:8], "pixels": rand(gen, 8, 3, lo=0.0, hi=1.0),
             "labels": torch.randint(0, 5, (8,), generator=gen, device=cuda)}
    draws = loop.draws_for_model(gen, models[True], train_render, 8, cuda)
    with torch.enable_grad():
        ref_loss, _ = loop.make_loss_fn(models[False], train_render, 0.1)(batch, draws)
    names, params = zip(*models[False].named_parameters())
    ref = dict(zip(names, torch.autograd.grad(ref_loss, params)))
    _build.launch_counts.clear()
    loss, grads, _ = loop.make_fused_loss_and_grads(models[True], train_render, 0.1)(batch, draws)
    torch.cuda.synchronize()
    assert _build.launch_counts == {mip_train.TRAIN_NAME: 1}
    torch.testing.assert_close(loss, ref_loss.detach(), rtol=LOSS_RTOL, atol=0)
    assert_grads_close(grads, ref)
    _build.launch_counts.clear()
    with torch.enable_grad():
        loss, _ = loop.make_loss_fn(models[True], train_render, 0.1)(batch, draws)
    names, params = zip(*models[True].named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    assert _build.launch_counts == {mip_mlp.NAME: 1, mip_mlp.BWD_NAME: 1}
    torch.testing.assert_close(loss.detach(), ref_loss.detach(), rtol=LOSS_RTOL, atol=0)
    assert_grads_close(grads, ref)


# -- K8 (the MLP on raw points) and K9 (the whole reuse step) ------------------

POINT_VARIANTS = ("full_width", "h128")  # K8 covers the view-conditioned 3-D inputs


def point_consts(cfg, device):
    return point_mlp.encoding_consts(cfg.x_positional_encoding_size, cfg.normalize_position,
                                     cfg.d_positional_encoding_size, cfg.direction_bound, device)


def raw_points(gen, n):
    return rand(gen, n, 3, lo=-2.0, hi=2.0), rand(gen, n, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("points", [1, 300])
@pytest.mark.parametrize("variant", POINT_VARIANTS)
def test_classic_pointmlp_fwd_kernel_matches_plain(cuda, variant, points):
    cfg, packed = packed_weights(variant, cuda)
    consts = point_consts(cfg, cuda)
    pts, dirs = raw_points(torch.Generator(device=cuda).manual_seed(11), points)
    before = _build.launch_counts[point_mlp.NAME]
    policies = dict(_build.policy_counts)
    out = point_mlp.classic_pointmlp_fwd(packed, pts, dirs, consts)
    torch.cuda.synchronize()
    assert _build.launch_counts[point_mlp.NAME] == before + 1
    assert policy_moves(policies) == {(point_mlp.NAME, "tc"): 1}
    torch.testing.assert_close(
        out, point_mlp.classic_pointmlp_fwd_plain(packed, pts, dirs, consts), **K1_TOL)
    # K1-fwd on the same encodings, made outside.
    x_enc = torch.sin(pts @ consts[0] + consts[1])
    d_enc = torch.sin(dirs @ consts[2] + consts[3])
    torch.testing.assert_close(out, classic_mlp.classic_mlp_fwd(packed, x_enc, d_enc), **K1_TOL)


def kink_margin(packed, x_enc, d_enc, matmul=torch.matmul):
    """Per row, the smallest |ReLU input| of the plain forward
    (``classic_mlp_fwd_plain``'s layers; ``matmul`` its products)."""
    whh, margins = packed["whh"], []

    def layer(i, pre):
        a = pre + packed["b"][i]
        margins.append(a.abs().amin(-1))
        return F.layer_norm(torch.relu(a), a.shape[-1:], packed["g"][i], packed["beta"][i], 1e-5)

    h = layer(0, matmul(x_enc, packed["w0"]))
    for i in (1, 2, 3):
        h = layer(i, matmul(h, whh[i - 1]))
    h = layer(4, matmul(h, whh[3]) + matmul(x_enc, packed["wx"]))
    for i in (5, 6, 7):
        h = layer(i, matmul(h, whh[i - 1]))
    if "wd_in" in packed:
        layer(9, matmul(layer(8, matmul(h, whh[7]) + matmul(d_enc, packed["wd_in"])), whh[8]))
    return torch.stack(margins).amin(0)


def away_from_kinks(packed, consts, gen, n, matmul=torch.matmul):
    """``n`` raw points and directions whose every ReLU input lies farther
    than 1e-5 from 0, the first of more candidates drawn from ``gen``: two
    float32 evaluations of a ReLU input differ by about 1e-6 (sums of a few
    hundred products in another order), so nearer the kink one of them can
    take the other branch and move that row's whole gradient.  The
    encodings of raw points put some ReLU inputs there (measured on the
    card: within 2e-7 at 200 points); a few % of the candidates are left
    out.  ``matmul`` as in ``kink_margin`` (``tc_mlp.bf16_matmul``: the
    bf16 forward's kinks)."""
    pts, dirs = raw_points(gen, 2 * n + 8)
    with torch.no_grad():
        keep = kink_margin(packed, torch.sin(pts @ consts[0] + consts[1]),
                           torch.sin(dirs @ consts[2] + consts[3]), matmul) > 1e-5
    idx = torch.nonzero(keep)[:n, 0]
    assert idx.numel() == n
    return pts[idx], dirs[idx]


@pytest.mark.cuda
@pytest.mark.parametrize("input_grads", [True, False])
@pytest.mark.parametrize("points", [1, 200])
@pytest.mark.parametrize("variant", POINT_VARIANTS)
def test_classic_pointmlp_bwd_kernel_matches_plain(cuda, variant, points, input_grads):
    """K8-bwd is K2's tensor-core passes on the encodings it computes, the
    encodings' cotangents included, then the chain rule to the raw inputs:
    on rows away from the ReLU's kink (``away_from_kinks``) its weight
    gradients are held against K1-bwd's tensor-core route on the same
    encodings (``input_grads=False``), the raw inputs' cotangents against
    the chain rule applied to the plain encodings' cotangents, and all of
    them against its plain version; every call runs the tensor-core
    tile."""
    cfg, packed = packed_weights(variant, cuda)
    consts = point_consts(cfg, cuda)
    gen = torch.Generator(device=cuda).manual_seed(12)
    pts, dirs = away_from_kinks(packed, consts, gen, points)
    g_out = rand(gen, points, 1 + cfg.color_outputs)
    before = _build.launch_counts[point_mlp.BWD_NAME]
    policies = dict(_build.policy_counts)
    dp, dd, d_packed = point_mlp.classic_pointmlp_bwd(packed, pts, dirs, consts, g_out,
                                                      input_grads=input_grads)
    torch.cuda.synchronize()
    assert _build.launch_counts[point_mlp.BWD_NAME] == before + 1
    assert policy_moves(policies) == {(point_mlp.BWD_NAME, "tc"): 1}
    x_arg, d_arg = pts @ consts[0] + consts[1], dirs @ consts[2] + consts[3]
    _, _, k1_packed = classic_mlp.classic_mlp_bwd(packed, torch.sin(x_arg), torch.sin(d_arg),
                                                  g_out, input_grads=False)
    assert_grads_close(d_packed, k1_packed)
    rdp, rdd, r_packed = point_mlp.classic_pointmlp_bwd_plain(packed, pts, dirs, consts, g_out,
                                                              input_grads)
    assert_grads_close(d_packed, r_packed)
    if not input_grads:
        assert dp is None and dd is None
        return
    dx, ddir, _ = classic_mlp.classic_mlp_bwd_plain(packed, torch.sin(x_arg), torch.sin(d_arg),
                                                    g_out)
    assert_grads_close({"dpoints": dp, "ddirs": dd},
                       {"dpoints": (dx * torch.cos(x_arg)) @ consts[0].T,
                        "ddirs": (ddir * torch.cos(d_arg)) @ consts[2].T})
    assert_grads_close({"dpoints": dp, "ddirs": dd}, {"dpoints": rdp, "ddirs": rdd})


# K8-bwd's and K5-bwd's models beside the full-width ones: encodings or
# features past the tensor-core tile at hidden 256 (x 102 + 36, 144; the
# wider x encoding also takes two 64-column passes of the input
# cotangent, the 144 features three), and past the float32 SIMT tile too
# (600).
INPUT_TC_WIDTHS = {
    point_mlp.BWD_NAME: {"wide": dict(x_positional_encoding_size=34),
                         "too_wide": dict(x_positional_encoding_size=200)},
    mip_mlp.BWD_NAME: {"wide": dict(encoding_size=48), "too_wide": dict(encoding_size=200)},
}


def input_tc_case(kernel, device, points, seed=0, **overrides):
    """A K8-bwd or K5-bwd call's arguments at full width (``overrides`` on
    the config), rows away from the ReLU kinks, and the function that
    calls the kernel (``kernel`` its wrapper's name) or, with
    ``plain=True``, its plain version."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if kernel == point_mlp.BWD_NAME:
        cfg = ClassicNeRFConfig(normalize_position=6.0, **{"hidden_size": 256, **overrides})
        mlp = ClassicMLP(cfg, generator=torch.Generator().manual_seed(0), device=device)
        packed = classic_mlp.pack_classic_params(mlp.requires_grad_(False))
        consts = point_consts(cfg, device)
        pts, dirs = away_from_kinks(packed, consts, gen, points)
        args = (packed, pts, dirs, consts, rand(gen, points, 1 + cfg.color_outputs))

        def call(plain=False):
            fn = point_mlp.classic_pointmlp_bwd_plain if plain else point_mlp.classic_pointmlp_bwd
            dp, dd, grads = fn(*args)
            return grads | {"dpoints": dp, "ddirs": dd}
        return cfg, (cfg.x_encoding_dim, cfg.d_encoding_dim), call
    cfg, packed = mip_packed("full_width", device, **overrides)
    x = mip_rows_away_from_kinks(packed, gen, 1, points, cfg.feature_dim)[0]
    args = (packed, x, rand(gen, points, cfg.num_outputs))

    def call(plain=False):
        dx, grads = (mip_mlp.mip_mlp_bwd_plain if plain else mip_mlp.mip_mlp_bwd)(*args)
        return grads | {"dfeat": dx}
    return cfg, (cfg.feature_dim, 0), call


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [point_mlp.BWD_NAME, mip_mlp.BWD_NAME])
@pytest.mark.parametrize("variant", ["full_width", "wide"])
def test_input_cotangent_kernels_follow_the_width_rule(cuda, variant, kernel):
    """K8-bwd and K5-bwd with the inputs' cotangents at full width, and with
    encodings (features) past the tensor-core forward tile
    (``INPUT_TC_WIDTHS``): the plan's bytes are those of ``fwd_store``'s
    tiles, the call records the policy they predict (the tensor cores at
    60 + 36 and 96 features, the float32 SIMT forward tile at 102 + 36 and
    144) and matches plain."""
    overrides = INPUT_TC_WIDTHS[kernel]["wide"] if variant == "wide" else {}
    cfg, (xe, de), call = input_tc_case(kernel, cuda, points=150, **overrides)
    tc_bytes, simt_bytes = predicted_tile_bytes(kernel, 256, xe, de, 0, 0, 0)
    plan = _build.tile_plan(kernel, xe, de, 256)
    assert (plan.tc_bytes, plan.simt_bytes) == (tc_bytes, simt_bytes)
    want = "tc" if variant == "full_width" else "simt"
    assert plan.policy == want
    before = dict(_build.policy_counts)
    got = call()
    torch.cuda.synchronize()
    assert policy_moves(before) == {(kernel, want): 1}
    assert_grads_close(got, call(plain=True))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [point_mlp.BWD_NAME, mip_mlp.BWD_NAME])
@pytest.mark.parametrize("hidden", classic_mlp.HIDDEN_WIDTHS)
def test_input_cotangent_kernels_match_plain_at_every_width(cuda, hidden, kernel):
    """K8-bwd (encodings 60 + 36) and K5-bwd (96 features) with the inputs'
    cotangents at every hidden width (below 64 the input cotangent's passes
    are H columns wide), 201 rows (not a multiple of 64) away from the ReLU
    kinks, on the tensor cores, against plain at GRAD_ATOL; a second call
    gives bitwise the same results."""
    _, _, call = input_tc_case(kernel, cuda, points=201, seed=hidden, hidden_size=hidden)
    before = dict(_build.policy_counts)
    first, second = call(), call()
    torch.cuda.synchronize()
    assert policy_moves(before) == {(kernel, "tc"): 2}
    assert_grads_close(first, call(plain=True))
    assert all(torch.equal(first[k], second[k]) for k in first)


@pytest.mark.cuda
def test_input_cotangent_autograd_builds_the_images_once(cuda, monkeypatch):
    """Under autograd K8 (``classic_pointmlp``) and K5 (``mip_mlp_fwd``)
    build their weights' operand images once, in the forward, and K8-fwd
    and K5-fwd run on its forward image, K8-bwd and K5-bwd on those very
    tensors, all on the tensor cores."""
    built, seen, seen_fwd = [], [], []
    images = tc_mlp.tc_images
    monkeypatch.setattr(tc_mlp, "tc_images",
                        lambda *a, **k: built.append(images(*a, **k)) or built[-1])
    for module, name in ((point_mlp, "classic_pointmlp_bwd"), (mip_mlp, "mip_mlp_bwd")):
        original = getattr(module, name)

        def recording(*args, _original=original, **kwargs):
            seen.append((kwargs["tc_fwd"], kwargs["tc_bwd"]))
            return _original(*args, **kwargs)

        monkeypatch.setattr(module, name, recording)
    for module, name in ((point_mlp, "classic_pointmlp_fwd"), (mip_mlp, "mip_mlp_fwd")):
        original = getattr(module, name)

        def recording(*args, _original=original, **kwargs):
            if "tc_fwd" in kwargs:
                seen_fwd.append(kwargs["tc_fwd"])
            return _original(*args, **kwargs)

        monkeypatch.setattr(module, name, recording)
    model = ClassicNeRF(ClassicNeRFConfig(hidden_size=64, normalize_position=6.0),
                        generator=torch.Generator().manual_seed(0), device=cuda)
    cfg = model.cfg
    pts, dirs = raw_points(torch.Generator(device=cuda).manual_seed(15), 100)
    policies = dict(_build.policy_counts)
    dens, col = point_mlp.classic_pointmlp(model, pts, dirs, cfg.x_positional_encoding_size,
                                           cfg.normalize_position, cfg.d_positional_encoding_size,
                                           cfg.direction_bound)
    torch.autograd.grad(col.sum() + dens.sum(), list(model.parameters()))
    mcfg, mpacked = mip_packed("small", cuda)
    leaves = {k: v.clone().requires_grad_(True) for k, v in mpacked.items()}
    x = rand(torch.Generator(device=cuda).manual_seed(16), 100, mcfg.feature_dim)
    torch.autograd.grad(mip_mlp.mip_mlp_fwd(leaves, x).sum(), list(leaves.values()))
    torch.cuda.synchronize()
    assert len(built) == 2 and len(seen) == 2 and len(seen_fwd) == 2
    assert all(s[0] is b[0] and s[1] is b[1] for s, b in zip(seen, built))
    assert all(f is b[0] for f, b in zip(seen_fwd, built))
    assert policy_moves(policies) == {(point_mlp.NAME, "tc"): 1, (point_mlp.BWD_NAME, "tc"): 1,
                                      (mip_mlp.NAME, "tc"): 1, (mip_mlp.BWD_NAME, "tc"): 1}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [point_mlp.BWD_NAME, mip_mlp.BWD_NAME])
def test_input_cotangent_wrappers_raise_past_every_tile(cuda, kernel):
    """Encodings (features) past the float32 SIMT tile too (600 + 36, 600
    at hidden 256, past its 588): K8-bwd and K5-bwd raise, naming the
    limit, with nothing launched or counted."""
    _, _, call = input_tc_case(kernel, cuda, points=5, **INPUT_TC_WIDTHS[kernel]["too_wide"])
    torch.cuda.synchronize()
    launches, policies = dict(_build.launch_counts), dict(_build.policy_counts)
    with pytest.raises(ValueError, match="limit"):
        call()
    assert dict(_build.launch_counts) == launches
    assert dict(_build.policy_counts) == policies


# K8-fwd's and K5-fwd's models beside the full-width ones: encodings or
# features past the tensor-core tile at hidden 256 (x 120 + 36 = 156,
# 144), and past the float32 SIMT tile too (600).
FORWARD_TC_WIDTHS = {
    point_mlp.NAME: {"wide": dict(x_positional_encoding_size=40),
                     "too_wide": dict(x_positional_encoding_size=200)},
    mip_mlp.NAME: {"wide": dict(encoding_size=48), "too_wide": dict(encoding_size=200)},
}


def forward_case(kernel, device, points, seed=0, **overrides):
    """A K8-fwd or K5-fwd call's arguments at full width (``overrides`` on
    the config): ``(xe, de)`` of its plan, and the function that calls the
    kernel with ``tc_fwd`` (``None``: the wrapper builds it) or, with
    ``plain=True``, its plain version."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if kernel == point_mlp.NAME:
        cfg = ClassicNeRFConfig(normalize_position=6.0, **{"hidden_size": 256, **overrides})
        mlp = ClassicMLP(cfg, generator=torch.Generator().manual_seed(0), device=device)
        packed = classic_mlp.pack_classic_params(mlp.requires_grad_(False))
        args = (packed, *raw_points(gen, points), point_consts(cfg, device))

        def call(tc_fwd=None, plain=False):
            if plain:
                return point_mlp.classic_pointmlp_fwd_plain(*args)
            return point_mlp.classic_pointmlp_fwd(*args, tc_fwd=tc_fwd)
        return packed, (cfg.x_encoding_dim, cfg.d_encoding_dim), call
    cfg, packed = mip_packed("full_width", device, **overrides)
    x = rand(gen, points, cfg.feature_dim)

    def call(tc_fwd=None, plain=False):
        if plain:
            return mip_mlp.mip_mlp_fwd_plain(packed, x)
        return mip_mlp.mip_mlp_fwd(packed, x, tc_fwd=tc_fwd)
    return packed, (cfg.feature_dim, 0), call


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [point_mlp.NAME, mip_mlp.NAME])
@pytest.mark.parametrize("variant", ["full_width", "wide"])
def test_forward_kernels_follow_the_width_rule(cuda, variant, kernel):
    """K8-fwd and K5-fwd at full width and with encodings (features) past
    the tensor-core tile (``FORWARD_TC_WIDTHS``): the plan's bytes are
    those of ``fwd_store``'s tiles, the call records the policy they
    predict (the tensor cores at 60 + 36 and 96 features, the float32 SIMT
    tile at 120 + 36 and 144) and matches plain at K1_TOL."""
    overrides = FORWARD_TC_WIDTHS[kernel]["wide"] if variant == "wide" else {}
    _, (xe, de), call = forward_case(kernel, cuda, points=301, **overrides)
    tc_bytes, simt_bytes = predicted_tile_bytes(kernel, 256, xe, de, 0, 0, 0)
    plan = _build.tile_plan(kernel, xe, de, 256)
    assert (plan.tc_bytes, plan.simt_bytes) == (tc_bytes, simt_bytes)
    want = "tc" if variant == "full_width" else "simt"
    assert plan.policy == want
    before = dict(_build.policy_counts)
    got = call()
    torch.cuda.synchronize()
    assert policy_moves(before) == {(kernel, want): 1}
    torch.testing.assert_close(got, call(plain=True), **K1_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [point_mlp.NAME, mip_mlp.NAME])
def test_forward_kernels_take_an_image_built_beforehand(cuda, kernel):
    """K8-fwd and K5-fwd given the forward image
    (``tc_mlp.tc_images(packed)[0]``) give bitwise what they give when
    they build it, on the tensor cores; an image of other weights raises
    before any launch."""
    packed, _, call = forward_case(kernel, cuda, points=200, seed=1)
    img = tc_mlp.tc_images(packed)[0]
    before = dict(_build.policy_counts)
    own, given = call(), call(tc_fwd=img)
    torch.cuda.synchronize()
    assert policy_moves(before) == {(kernel, "tc"): 2}
    assert torch.equal(own, given)
    launches = dict(_build.launch_counts)
    with pytest.raises(ValueError, match="tc_fwd"):
        call(tc_fwd=img[:-4])
    assert dict(_build.launch_counts) == launches


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [point_mlp.NAME, mip_mlp.NAME])
def test_forward_wrappers_raise_past_every_tile(cuda, kernel):
    """Encodings (features) past the float32 SIMT tile too (600 + 36, 600
    at hidden 256): K8-fwd and K5-fwd raise, naming the limit, with
    nothing launched or counted."""
    _, _, call = forward_case(kernel, cuda, points=5, **FORWARD_TC_WIDTHS[kernel]["too_wide"])
    torch.cuda.synchronize()
    launches, policies = dict(_build.launch_counts), dict(_build.policy_counts)
    with pytest.raises(ValueError, match="limit"):
        call()
    assert dict(_build.launch_counts) == launches
    assert dict(_build.policy_counts) == policies


@pytest.mark.cuda
def test_classic_pointmlp_autograd_runs_both_kernels(cuda):
    model = ClassicNeRF(ClassicNeRFConfig(hidden_size=64, normalize_position=6.0),
                        generator=torch.Generator().manual_seed(0), device=cuda)
    cfg = model.cfg
    args = (cfg.x_positional_encoding_size, cfg.normalize_position,
            cfg.d_positional_encoding_size, cfg.direction_bound)
    with torch.no_grad():
        pts, dirs = away_from_kinks(classic_mlp.pack_classic_params(model.mlp),
                                    point_consts(cfg, cuda),
                                    torch.Generator(device=cuda).manual_seed(13), 150)
    grads = {}
    for kernel in (True, False):
        x, d = pts.clone().requires_grad_(True), dirs.clone().requires_grad_(True)
        _build.launch_counts.clear()
        if kernel:
            dens, col = point_mlp.classic_pointmlp(model, x, d, *args)
        else:
            out = point_mlp.classic_pointmlp_fwd_plain(
                classic_mlp.pack_classic_params(model.mlp), x, d, point_consts(cfg, cuda))
            dens, col = out[:, :1], out[:, 1:]
        loss = torch.mean(col ** 2) + torch.mean(dens ** 2)
        names, params = zip(*model.named_parameters())
        grads[kernel] = dict(zip(["points", "dirs", *names],
                                 torch.autograd.grad(loss, [x, d, *params])))
        torch.cuda.synchronize()
        if kernel:
            assert _build.launch_counts == {point_mlp.NAME: 1, point_mlp.BWD_NAME: 1}
    assert_grads_close(grads[True], grads[False])


def mega_setup(device, view, sc, sf, white, rays=5, seed=14, hidden=64, **cfg):
    model = ClassicNeRF(ClassicNeRFConfig(hidden_size=hidden, normalize_position=6.0,
                                          use_viewdirs=view, use_pallas=True, **cfg),
                        generator=torch.Generator().manual_seed(0), device=device)
    with torch.no_grad():  # mass in every bin (see chip_smoke.py)
        model.mlp.density.bias.fill_(0.5)
        model.mlp.density.weight.mul_(0.05)
    render = RenderConfig(num_coarse_samples=sc, num_fine_samples=sf, randomly_sample=True,
                          density_noise_std=1.0, white_background=white,
                          reuse_coarse_in_fine=True)
    gen = torch.Generator(device=device).manual_seed(seed)
    batch = {"rays_o": rand(gen, rays, 3, lo=-0.5, hi=0.5), "rays_d": rand(gen, rays, 3),
             "pixels": rand(gen, rays, 3, lo=0.0, hi=1.0)}
    return model, render, batch, sampling.draw_step(gen, render, rays, device)


@pytest.mark.cuda
@pytest.mark.parametrize("white,exact", [(False, False), (True, True)])
@pytest.mark.parametrize("sc,sf", [(8, 16), (64, 128), (7, 33)])
@pytest.mark.parametrize("view", [True, False])
def test_mega_train_kernel_matches_plain(cuda, view, sc, sf, white, exact):
    check_mega_against_plain(*mega_setup(cuda, view, sc, sf, white), white, exact)


def check_mega_against_plain(model, render, batch, draws, white, exact):
    """One K9 call against its plain version; returns the call's outputs."""
    inputs = mega_train.mega_inputs(model, batch, draws)
    packed = classic_mlp.pack_classic_params(model.mlp.requires_grad_(False))
    before = _build.launch_counts[mega_train.NAME]
    loss_c, loss_f, d_packed, t_fine = mega_train.mega_train(packed, *inputs, white, exact)
    torch.cuda.synchronize()
    assert _build.launch_counts[mega_train.NAME] == before + 1
    # The resample against the plain one, in probability (see chip_smoke.py).
    x_enc_c, d_ray, t_c, noise_c, u, _, _, rays_d = inputs[:8]
    weights_c = mega_train.coarse_weights_plain(packed, x_enc_c, d_ray, t_c, noise_c, rays_d)
    bins, w = 0.5 * (t_c[:, 1:] + t_c[:, :-1]), weights_c[:, 1:-1]
    step = 4 * 2.0 ** -23 * t_fine.abs()  # 4 ulp of t, and the mass they carry
    slack = (sampling.pdf_cdf_at(bins, w, t_fine + step)
             - sampling.pdf_cdf_at(bins, w, t_fine - step)) / 2
    assert bool(((sampling.pdf_cdf_at(bins, w, t_fine) - u).abs() <= 2e-5 + slack).all())
    r_loss_c, *_ = mega_train.mega_train_plain(packed, *inputs, white, exact)
    torch.testing.assert_close(loss_c, r_loss_c, rtol=LOSS_RTOL, atol=0)
    # Everything downstream with the kernel's own fine t-values.
    r_loss_c, r_loss_f, r_packed, _ = mega_train.mega_train_plain(packed, *inputs, white, exact,
                                                                  t_fine=t_fine)
    torch.testing.assert_close(loss_c, r_loss_c, rtol=LOSS_RTOL, atol=0)
    torch.testing.assert_close(loss_f, r_loss_f, rtol=LOSS_RTOL, atol=0)
    assert_grads_close(d_packed, r_packed)
    return packed, inputs, (loss_c, loss_f, d_packed, t_fine)


def mega_setup_away_from_kinks(device, view, sc, sf, hidden, rays=5):
    """``mega_setup``'s step on the first ``rays`` of 4 rays + 8 candidates
    whose every coarse and fine row (at the plain resample's fine samples)
    has all its ReLU inputs farther than 1e-5 from 0: nearer the kink one
    of two float32-accurate evaluations can take the other branch and move
    that row's gradient (see ``away_from_kinks``; at hidden 256 one such
    input among 200 rows moved ``w0``'s gradient by up to 3.8e-4 of its
    largest entry on the card)."""
    model, render, batch, draws = mega_setup(device, view, sc, sf, False, rays=4 * rays + 8,
                                             hidden=hidden)
    inputs = mega_train.mega_inputs(model, batch, draws)
    x_c, d_ray, t_c, _, _, _, rays_o, rays_d, _, placement, is_cos = inputs
    packed = classic_mlp.pack_classic_params(model.mlp.requires_grad_(False))
    *_, t_fine = mega_train.mega_train_plain(packed, *inputs)
    n = t_c.shape[0]
    with torch.no_grad():
        x_f = mega_train.encode_fine_plain(t_fine, rays_o, rays_d, placement, is_cos)
        d_c = None if d_ray is None else d_ray.repeat_interleave(sc, 0)
        d_f = None if d_ray is None else d_ray.repeat_interleave(sf, 0)
        margin = torch.minimum(kink_margin(packed, x_c, d_c).reshape(n, sc).amin(1),
                               kink_margin(packed, x_f, d_f).reshape(n, sf).amin(1))
    keep = torch.nonzero(margin > 1e-5).flatten()[:rays]
    assert keep.numel() == rays, f"only {keep.numel()} of {n} rays are away from the kinks"
    model.mlp.requires_grad_(True)
    return (model, render, {k: v[keep] for k, v in batch.items()},
            sampling.StepDraws(*(None if t is None else t[keep] for t in draws)))


@pytest.mark.cuda
@pytest.mark.parametrize("view", [True, False])
@pytest.mark.parametrize("hidden", classic_mlp.HIDDEN_WIDTHS)
def test_mega_train_kernel_matches_plain_at_every_width(cuda, hidden, view):
    """K9's tensor-core passes at every hidden width, 5 rays x (7 + 33):
    200 rows (not a multiple of 64), encodings 60 + 36 (not multiples of
    8), rays away from the ReLU kinks; then a second call gives bitwise the
    same losses, gradients and fine samples (a fixed order of products, no
    atomics)."""
    packed, inputs, first = check_mega_against_plain(
        *mega_setup_away_from_kinks(cuda, view, 7, 33, hidden), False, False)
    second = mega_train.mega_train(packed, *inputs)
    torch.cuda.synchronize()
    for a, b in ((first[0], second[0]), (first[1], second[1]), (first[3], second[3])):
        assert torch.equal(a, b)
    assert first[2].keys() == second[2].keys()
    assert all(torch.equal(first[2][k], second[2][k]) for k in first[2])


def tc_product(name):
    return getattr(_build.load("tc_product"), name)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 100])
@pytest.mark.parametrize("k", [5, 36, 60, 256])
@pytest.mark.parametrize("hidden", classic_mlp.HIDDEN_WIDTHS)
def test_tc_linear_is_the_3xtf32_product(cuda, hidden, k, rows):
    """The row-tile product of K4 and K9's forward and bwd_rows
    (tc_gemm) alone: out = a @ w on an operand image of w^T, against the
    CPU emulation of the same arithmetic (the sums in another order: within
    1e-6 sqrt(k) of the largest entry) and within 1e-5 of the largest
    entry of the float64 product."""
    gen = torch.Generator(device=cuda).manual_seed(hidden + k + rows)
    a, w = rand(gen, rows, k), rand(gen, k, hidden)
    out = torch.empty((rows, hidden), device=cuda)
    img = tc_mlp.operand_image(w.t())
    err = tc_product("tc_linear")(a.data_ptr(), img.data_ptr(), out.data_ptr(), rows, k,
                                  hidden, torch.cuda.current_stream(cuda).cuda_stream)
    _build.check_launch("tc_linear", err)
    torch.cuda.synchronize()
    exact = a.double() @ w.double()
    scale = float(exact.abs().max())
    emulated = tc_mlp.tc_matmul(a.cpu(), w.cpu()).to(cuda)
    assert float((out - emulated).abs().max()) <= 1e-6 * scale * k ** 0.5
    assert float((out.double() - exact).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("points", [1, 100, 1000])
@pytest.mark.parametrize("m,n", [(60, 256), (256, 256), (36, 32), (256, 64)])
def test_tc_wgrad_is_the_3xtf32_product(cuda, m, n, points):
    """wgrad's product alone: out = a^T b over the points, both operands
    transposed and split while staged, against the CPU emulation and the
    float64 product."""
    gen = torch.Generator(device=cuda).manual_seed(m + n + points)
    a, b = rand(gen, points, m), rand(gen, points, n)
    out = torch.empty((m, n), device=cuda)
    err = tc_product("tc_wgrad")(a.data_ptr(), b.data_ptr(), out.data_ptr(), points, m, n,
                                 torch.cuda.current_stream(cuda).cuda_stream)
    _build.check_launch("tc_wgrad", err)
    torch.cuda.synchronize()
    exact = a.double().t() @ b.double()
    scale = float(exact.abs().max())
    emulated = tc_mlp.tc_matmul(a.cpu().t(), b.cpu()).to(cuda)
    assert float((out - emulated).abs().max()) <= 1e-6 * scale * points ** 0.5
    assert float((out.double() - exact).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
def test_mega_step_launches_one_kernel_and_tracks_reuse(cuda):
    model, render, batch, draws = mega_setup(cuda, True, 16, 24, False, rays=8)
    _build.launch_counts.clear()
    loss, grads, aux = mega_train.mega_train_loss_and_grads(model, render, batch, draws,
                                                            emit_t_fine=True)
    torch.cuda.synchronize()
    assert _build.launch_counts == {mega_train.NAME: 1}
    assert aux["t_fine"].shape == (8, 24)
    ref_loss, ref, _ = fine_stage_train.reuse_train_loss_and_grads(model, render, batch, draws)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-4, atol=0)
    flat = torch.cat([grads[k].ravel() for k in sorted(ref)])
    ref_flat = torch.cat([ref[k].ravel() for k in sorted(ref)])
    assert float((flat - ref_flat).abs().max()) < 5e-3 * float(ref_flat.abs().max())


@pytest.mark.cuda
def test_point_and_mega_wrappers_raise_instead_of_falling_back(cuda):
    cfg, packed = packed_weights("h128", cuda)
    consts = point_consts(cfg, cuda)
    with pytest.raises(ValueError, match="cpu"):
        point_mlp.classic_pointmlp_fwd(packed, torch.zeros(4, 3), torch.zeros(4, 3, device=cuda),
                                       consts)
    _, no_view = packed_weights("no_view", cuda)
    with pytest.raises(ValueError, match="view"):
        point_mlp.classic_pointmlp_fwd(no_view, torch.zeros(4, 3, device=cuda),
                                       torch.zeros(4, 3, device=cuda), consts)
    model, render, batch, draws = mega_setup(cuda, True, 8, mega_train.MAX_SAMPLES + 1, False)
    packed = classic_mlp.pack_classic_params(model.mlp.requires_grad_(False))
    inputs = mega_train.mega_inputs(model, batch, draws)
    with pytest.raises(ValueError, match="samples"):
        mega_train.mega_train(packed, *inputs)
    model, render, batch, draws = mega_setup(cuda, True, 8, 16, False)
    inputs = list(mega_train.mega_inputs(model, batch, draws))
    inputs[8] = inputs[8].cpu()  # the pixels
    with pytest.raises(ValueError, match="cpu"):
        mega_train.mega_train(packed, *inputs)
    # Encodings past every tile (xe 600 + de 36 at hidden 256): raises,
    # naming the limit, before any launch.
    model, render, batch, draws = mega_setup(cuda, True, 8, 16, False, hidden=256,
                                             x_positional_encoding_size=200)
    packed = classic_mlp.pack_classic_params(model.mlp.requires_grad_(False))
    inputs = mega_train.mega_inputs(model, batch, draws)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    with pytest.raises(ValueError, match="limit"):
        mega_train.mega_train(packed, *inputs)
    assert dict(_build.launch_counts) == launches


# -- compute_dtype="bfloat16": K1-fwd, K1-bwd, K2, K3 and K4 ---------------

# Relative L2 bounds of a bf16 kernel against its plain bf16 version (the
# same roundings, the products summed in another order, and by the tensor
# cores with truncation): outputs and losses 1e-2, gradients 2e-2, over
# each whole output or all gradients together (a single float32 rounding
# can move an activation to the other bf16 neighbour, so element-wise
# float32 tolerances do not apply).  K1-bwd runs on the cotangents of a
# loss over many rows (``loss_cotangent``), as a train step hands it: the
# weight gradients of random cotangents at a few hundred rows, sums of
# terms of either sign, move by 2e-2 to 6e-2 between two float32-accurate
# bf16 evaluations at hidden 128 and 256, and so do each row's input
# cotangents (``scripts/torch_bf16_sensitivity.py``).  The float32 kernel
# on the same inputs must fail the check (``assert_check_sees_float32``).
BF16_FWD = 1e-2
BF16_GRAD = 2e-2
BF16_ROWS = 16384


def rel_l2(got, ref) -> float:
    got, ref = got.double().ravel(), ref.double().ravel()
    return float((got - ref).norm() / ref.norm())


def packed_rel_l2(got: dict, ref: dict) -> float:
    assert got.keys() == ref.keys()
    return rel_l2(torch.cat([got[k].ravel() for k in ref]), torch.cat([ref[k].ravel() for k in ref]))


def assert_bf16_grads(got: dict, ref: dict) -> None:
    err = packed_rel_l2(got, ref)
    assert err <= BF16_GRAD, err


def assert_check_sees_float32(f32: dict, ref: dict) -> None:
    """The float32 kernel's gradients on a bf16 check's inputs fail it."""
    err = packed_rel_l2(f32, ref)
    assert err > BF16_GRAD, err


def loss_cotangent(packed, x, d) -> torch.Tensor:
    """K1's output cotangents under ``test_pallas.py``'s bf16 objective,
    mean(density^2) + mean(sin(color)), at the plain forward."""
    out = classic_mlp.classic_mlp_fwd_plain(packed, x, d)
    n, c = out.shape[0], out.shape[1] - 1
    return torch.cat([2 * out[:, :1] / n, torch.cos(out[:, 1:]) / (n * c)], -1)


def bf16(a: dict) -> dict:
    return {k: v.bfloat16() if k in ("x_enc", "d_enc") and v is not None else v
            for k, v in a.items()}


BF16_VARIANTS = ["full_width", "latent_full_width", "latent"]


def bf16_route(cfg, kernel, *shape):
    return _build.tile_plan(kernel, cfg.x_encoding_dim,
                            cfg.d_encoding_dim if cfg.use_viewdirs else 0, cfg.hidden_size,
                            *shape).policy + "_bf16"


@pytest.mark.cuda
@pytest.mark.parametrize("variant", BF16_VARIANTS)
def test_bf16_forward_kernels_match_plain(cuda, variant):
    """K1-fwd and K4 in bf16 against their plain bf16 versions: the
    tensor-core tile at full width (tc_bf16), the SIMT tile at a latent
    model's 100 + 48 (simt_bf16)."""
    cfg, packed = packed_weights(variant, cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = rand(gen, 1000, cfg.x_encoding_dim).bfloat16()
    d = rand(gen, 1000, cfg.d_encoding_dim).bfloat16()
    policies = dict(_build.policy_counts)
    out = classic_mlp.classic_mlp_fwd(packed, x, d)
    torch.cuda.synchronize()
    assert policy_moves(policies) == {(classic_mlp.NAME, bf16_route(cfg, classic_mlp.NAME)): 1}
    assert out.dtype == torch.float32
    assert rel_l2(out, classic_mlp.classic_mlp_fwd_plain(packed, x, d)) <= BF16_FWD
    args = list(union_args(cfg, packed, cuda, rays=37, sc=64, sf=128))
    args[1], args[2] = args[1].bfloat16(), args[2].bfloat16()
    policies = dict(_build.policy_counts)
    got = union_eval.union_eval(*args)
    torch.cuda.synchronize()
    want = bf16_route(cfg, union_eval.NAME, 3, 64, 128)
    assert policy_moves(policies) == {(union_eval.NAME, want): 1}
    for g, r in zip(got, union_eval.union_eval_plain(*args)):
        assert rel_l2(g, r) <= BF16_FWD


@pytest.mark.cuda
@pytest.mark.parametrize("input_grads", [False, True])
@pytest.mark.parametrize("variant", BF16_VARIANTS)
def test_bf16_classic_mlp_bwd_matches_plain(cuda, variant, input_grads):
    """K1-bwd in bf16, always on the tensor-core passes (fwd_store on its
    SIMT tile at the latent width), the encodings' cotangents bfloat16, on
    BF16_ROWS rows away from the kinks and a loss's cotangents; the float32
    kernel on the same inputs fails the check."""
    cfg, packed = packed_weights(variant, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    d = rand(gen, BF16_ROWS, cfg.d_encoding_dim)
    x = rows_away_from_kinks(packed, gen, BF16_ROWS, 1, cfg.x_encoding_dim, d,
                             tc_mlp.bf16_matmul).reshape(BF16_ROWS, -1).bfloat16()
    d = d.bfloat16()
    g_out = loss_cotangent(packed, x, d)
    policies = dict(_build.policy_counts)
    dx, dd, d_packed = classic_mlp.classic_mlp_bwd(packed, x, d, g_out, input_grads=input_grads)
    torch.cuda.synchronize()
    assert policy_moves(policies) == {
        (classic_mlp.BWD_NAME, bf16_route(cfg, classic_mlp.BWD_NAME)): 1}
    rdx, rdd, ref = classic_mlp.classic_mlp_bwd_plain(packed, x, d, g_out, input_grads)
    assert_bf16_grads(d_packed, ref)
    assert_check_sees_float32(
        classic_mlp.classic_mlp_bwd(packed, x.float(), d.float(), g_out, False)[2], ref)
    if input_grads:
        assert dx.dtype == dd.dtype == torch.bfloat16
        assert_bf16_grads({"dx": dx, "dd": dd}, {"dx": rdx, "dd": rdd})
    else:
        assert dx is None and dd is None


@pytest.mark.cuda
@pytest.mark.parametrize("variant", BF16_VARIANTS)
def test_bf16_train_kernels_match_plain(cuda, variant):
    """K2 and K3 in bf16 against their plain bf16 versions, bitwise
    repeatable."""
    cfg, packed = packed_weights(variant, cuda)
    a = bf16(train_inputs(cfg, cuda, rays=3, s=64))
    policies = dict(_build.policy_counts)
    loss, grads, weights = train_grads.classic_train_grads(packed, **a, num_samples=64,
                                                           loss_weight=0.5, return_weights=True)
    torch.cuda.synchronize()
    assert policy_moves(policies) == {(train_grads.NAME, bf16_route(cfg, train_grads.NAME)): 1}
    r_loss, ref, r_weights = train_grads.classic_train_grads_plain(
        packed, **a, num_samples=64, loss_weight=0.5, return_weights=True)
    assert rel_l2(loss, r_loss) <= BF16_FWD and rel_l2(weights, r_weights) <= BF16_FWD
    assert_bf16_grads(grads, ref)
    again = train_grads.classic_train_grads(packed, **a, num_samples=64, loss_weight=0.5)
    assert torch.equal(again[0], loss) and all(torch.equal(again[1][k], grads[k]) for k in grads)
    a = bf16(fine_inputs(cfg, cuda, rays=3, sc=64, sf=128))
    policies = dict(_build.policy_counts)
    loss, grads, (gdc, gcc) = fine_stage_train.fine_stage_train(packed, **a, loss_weight=0.5)
    torch.cuda.synchronize()
    assert policy_moves(policies) == {
        (fine_stage_train.NAME, bf16_route(cfg, fine_stage_train.NAME)): 1}
    r_loss, ref, (r_gdc, r_gcc) = fine_stage_train.fine_stage_train_plain(packed, **a,
                                                                          loss_weight=0.5)
    assert rel_l2(loss, r_loss) <= BF16_FWD
    assert_bf16_grads({**grads, "g_dens_c": gdc, "g_col_c": gcc},
                      {**ref, "g_dens_c": r_gdc, "g_col_c": r_gcc})


@pytest.mark.cuda
@pytest.mark.parametrize("view", [True, False])
@pytest.mark.parametrize("hidden", classic_mlp.HIDDEN_WIDTHS)
def test_bf16_kernels_match_plain_at_every_width(cuda, hidden, view):
    """Every hidden width's bf16 products (m64nNk16 for N / 2 = 16 .. 128,
    the input cotangents' passes of min(H, 64) columns), with and without
    the view branch: K1-fwd, K1-bwd with the encodings' cotangents (on
    BF16_ROWS rows away from the kinks and a loss's cotangents; the
    float32 kernel fails the check) and K2."""
    cfg, packed = width_packed(cuda, hidden, view)
    gen = torch.Generator(device=cuda).manual_seed(hidden)
    d = rand(gen, BF16_ROWS, cfg.d_encoding_dim) if view else None
    x = rows_away_from_kinks(packed, gen, BF16_ROWS, 1, cfg.x_encoding_dim, d,
                             tc_mlp.bf16_matmul).reshape(BF16_ROWS, -1).bfloat16()
    d = None if d is None else d.bfloat16()
    out = classic_mlp.classic_mlp_fwd(packed, x, d)
    assert rel_l2(out, classic_mlp.classic_mlp_fwd_plain(packed, x, d)) <= BF16_FWD
    g_out = loss_cotangent(packed, x, d)
    dx, dd, d_packed = classic_mlp.classic_mlp_bwd(packed, x, d, g_out)
    rdx, rdd, ref = classic_mlp.classic_mlp_bwd_plain(packed, x, d, g_out)
    assert_bf16_grads(d_packed, ref)
    assert_check_sees_float32(classic_mlp.classic_mlp_bwd(
        packed, x.float(), None if d is None else d.float(), g_out, False)[2], ref)
    assert_bf16_grads({"dx": dx, **({"dd": dd} if view else {})},
                      {"dx": rdx, **({"dd": rdd} if view else {})})
    a = bf16(train_inputs(cfg, cuda, rays=2, s=33))
    loss, grads = train_grads.classic_train_grads(packed, **a, num_samples=33)
    r_loss, ref = train_grads.classic_train_grads_plain(packed, **a, num_samples=33)
    torch.cuda.synchronize()
    assert rel_l2(loss, r_loss) <= BF16_FWD
    assert_bf16_grads(grads, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 100])
@pytest.mark.parametrize("k", [5, 36, 60, 256])
@pytest.mark.parametrize("hidden", classic_mlp.HIDDEN_WIDTHS)
def test_tc_linear_bf16_is_the_bf16_product(cuda, hidden, k, rows):
    """tc_gemm's bf16 product alone on a bf16 operand image: the float64
    product of the bf16-rounded operands within 1e-6 sqrt(k) of its largest
    entry (the tensor cores' truncating sums), and the emulation
    ``tc_mlp.bf16_matmul`` as close."""
    gen = torch.Generator(device=cuda).manual_seed(hidden + k + rows)
    a, w = rand(gen, rows, k), rand(gen, k, hidden)
    out = torch.empty((rows, hidden), device=cuda)
    img = tc_mlp.operand_image(w.t(), torch.bfloat16)
    err = tc_product("tc_linear_bf16")(a.data_ptr(), img.data_ptr(), out.data_ptr(), rows, k,
                                       hidden, torch.cuda.current_stream(cuda).cuda_stream)
    _build.check_launch("tc_linear_bf16", err)
    torch.cuda.synchronize()
    exact = tc_mlp.bf16_round(a).double() @ tc_mlp.bf16_round(w).double()
    scale = float(exact.abs().max())
    assert float((out.double() - exact).abs().max()) <= 1e-6 * scale * k ** 0.5
    assert float((out - tc_mlp.bf16_matmul(a, w)).abs().max()) <= 1e-6 * scale * k ** 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("points", [1, 100, 1000])
@pytest.mark.parametrize("m,n", [(60, 256), (256, 256), (36, 32), (256, 64)])
def test_tc_wgrad_bf16_is_the_bf16_product(cuda, m, n, points):
    """wgrad's bf16 product alone (B rounded as it is transposed, A as its
    fragments are built): the float64 product of the rounded operands."""
    gen = torch.Generator(device=cuda).manual_seed(m + n + points)
    a, b = rand(gen, points, m), rand(gen, points, n)
    out = torch.empty((m, n), device=cuda)
    err = tc_product("tc_wgrad_bf16")(a.data_ptr(), b.data_ptr(), out.data_ptr(), points, m, n,
                                      torch.cuda.current_stream(cuda).cuda_stream)
    _build.check_launch("tc_wgrad_bf16", err)
    torch.cuda.synchronize()
    exact = tc_mlp.bf16_round(a).double().t() @ tc_mlp.bf16_round(b).double()
    scale = float(exact.abs().max())
    assert float((out.double() - exact).abs().max()) <= 1e-6 * scale * points ** 0.5


@pytest.mark.cuda
def test_bf16_model_paths_launch_the_bf16_kernels(cuda):
    """A bf16 ClassicNeRF at full width: a frame tile through K1-fwd and K4,
    the reuse step (K1-fwd, K3, one K1-bwd) and the coarse-only step (K2),
    every call on tc_bf16, each within the bounds of its plain bf16 path
    (``bf16_step_reference``: the step with the five wrappers' plain
    versions).  The steps take the cells' batches, 2048 and 4096 rays: at
    64 rays a few rows' bf16 roundings move the gradients by 2e-2."""
    from nerf_tpu_torch.train import make_fused_loss_and_grads

    cfg = ClassicNeRFConfig(hidden_size=256, use_pallas=True, compute_dtype="bfloat16")
    model = ClassicNeRF(cfg, generator=torch.Generator().manual_seed(0), device=cuda)
    with torch.no_grad():  # mass in every bin (see chip_smoke.py)
        model.mlp.density.bias.fill_(0.5)
        model.mlp.density.weight.mul_(0.05)
    gen = torch.Generator(device=cuda).manual_seed(0)
    o, d = rand(gen, 64, 3) * 0.3, rand(gen, 64, 3)
    render = RenderConfig(num_coarse_samples=64, num_fine_samples=128, randomly_sample=False,
                          density_noise_std=0.0)
    _build.policy_counts.clear()
    with torch.no_grad():
        out = model.render_rays(o, d, render, fused_eval=True)
        torch.cuda.synchronize()
        assert dict(_build.policy_counts) == {(classic_mlp.NAME, "tc_bf16"): 1,
                                              (union_eval.NAME, "tc_bf16"): 1}
        with plain_versions():
            ref = model.render_rays(o, d, render, fused_eval=True)
    assert rel_l2(out.rgb[:, -1], ref.rgb[:, -1]) <= BF16_FWD
    for n_rays, render, launches in (
        (2048, RenderConfig(num_coarse_samples=64, num_fine_samples=128, density_noise_std=1.0),
         {classic_mlp.NAME: 1, fine_stage_train.NAME: 1, classic_mlp.BWD_NAME: 1}),
        (4096, RenderConfig(num_coarse_samples=64, density_noise_std=1.0), {train_grads.NAME: 1}),
    ):
        batch = dict(rays_o=rand(gen, n_rays, 3) * 0.3, rays_d=rand(gen, n_rays, 3),
                     pixels=rand(gen, n_rays, 3, lo=0.0, hi=1.0))
        draws = sampling.draw_step(torch.Generator(device=cuda).manual_seed(1), render, n_rays,
                                   cuda)
        _build.launch_counts.clear()
        _build.policy_counts.clear()
        loss, grads, _ = make_fused_loss_and_grads(model, render)(batch, draws)
        torch.cuda.synchronize()
        assert dict(_build.launch_counts) == launches
        assert set(_build.policy_counts) == {(k, "tc_bf16") for k in launches}
        r_loss, ref = bf16_step_reference(model, render, batch, draws)
        assert rel_l2(loss, r_loss) <= BF16_FWD
        assert_bf16_grads(grads, ref)


# -- compute_dtype="bfloat16": the mip family, K5-fwd, K5-bwd, K6 and K7 ----

# The classic bf16 kernels' bounds (BF16_FWD, BF16_GRAD) against the plain
# bf16 versions.  K5-bwd runs on BF16_ROWS rows away from the bf16
# forward's kinks and uniform random cotangents, where the float32 kernel
# on the same inputs fails the check (``assert_check_sees_float32``; on a
# loss's cotangents it would pass it, as it passes K6's: PERF.md); its
# features' cotangent is bfloat16.  The rounding of the 54-wide head, the
# one product outside the tensor-core tiles, is checked directly
# (``test_bf16_mip_head_rounds_its_operands``).
MIP_BF16_VARIANTS = {"full_width": dict(), "latent_full_width": dict(encoding_size=48)}


def mip_bf16_route(cfg, kernel):
    return _build.tile_plan(kernel, cfg.feature_dim, 0, cfg.hidden_size).policy + "_bf16"


def mip_bf16_inputs(cfg, packed, device, rays, rows, seed=0):
    """K6's and K7's inputs with bfloat16 features away from the bf16
    forward's kinks."""
    a = mip_inputs(cfg, device, rays, rows, seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    a["features"] = mip_rows_away_from_kinks(packed, gen, rays, rows, cfg.feature_dim,
                                             bf16=True).bfloat16()
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(MIP_BF16_VARIANTS))
def test_bf16_mip_forward_kernels_match_plain(cuda, variant):
    """K5-fwd and K7 in bf16 against their plain bf16 versions: the
    tensor-core tile at 96 features (tc_bf16), the SIMT tile at 144
    (simt_bf16)."""
    cfg, packed = mip_packed("full_width", cuda, **MIP_BF16_VARIANTS[variant])
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = rand(gen, 1000, cfg.feature_dim).bfloat16()
    policies = dict(_build.policy_counts)
    out = mip_mlp.mip_mlp_fwd(packed, x)
    torch.cuda.synchronize()
    assert policy_moves(policies) == {(mip_mlp.NAME, mip_bf16_route(cfg, mip_mlp.NAME)): 1}
    assert out.dtype == torch.float32
    assert rel_l2(out, mip_mlp.mip_mlp_fwd_plain(packed, x)) <= BF16_FWD
    a = mip_bf16_inputs(cfg, packed, cuda, rays=37, rows=63)
    args = (packed, a["features"], a["dists"], a["t_mids"], a["noise"], cfg.color_outputs, True)
    policies = dict(_build.policy_counts)
    got = mip_train.mip_eval(*args)
    torch.cuda.synchronize()
    assert policy_moves(policies) == {
        (mip_train.EVAL_NAME, mip_bf16_route(cfg, mip_train.EVAL_NAME)): 1}
    for g, r in zip(got, mip_train.mip_eval_plain(*args)):
        assert g.dtype == torch.float32 and rel_l2(g, r) <= BF16_FWD


@pytest.mark.cuda
@pytest.mark.parametrize("input_grads", [False, True])
@pytest.mark.parametrize("variant", sorted(MIP_BF16_VARIANTS))
def test_bf16_mip_mlp_bwd_matches_plain(cuda, variant, input_grads):
    """K5-bwd in bf16 (the forward recompute on the tile the width gives,
    the backward passes on the tensor cores), dfeat bfloat16, bitwise
    repeatable; the float32 kernel on the same inputs fails the check."""
    cfg, packed = mip_packed("full_width", cuda, **MIP_BF16_VARIANTS[variant])
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = mip_rows_away_from_kinks(packed, gen, 1, BF16_ROWS, cfg.feature_dim,
                                 bf16=True)[0].bfloat16()
    g_out = rand(gen, BF16_ROWS, cfg.num_outputs)
    policies = dict(_build.policy_counts)
    dx, d_packed = mip_mlp.mip_mlp_bwd(packed, x, g_out, input_grads=input_grads)
    torch.cuda.synchronize()
    assert policy_moves(policies) == {
        (mip_mlp.BWD_NAME, mip_bf16_route(cfg, mip_mlp.BWD_NAME)): 1}
    rdx, ref = mip_mlp.mip_mlp_bwd_plain(packed, x, g_out, input_grads)
    assert_bf16_grads(d_packed, ref)
    f32_dx, f32 = mip_mlp.mip_mlp_bwd(packed, x.float(), g_out, input_grads=input_grads)
    assert_check_sees_float32(f32, ref)
    if input_grads:
        assert dx.dtype == torch.bfloat16 and dx.shape == x.shape
        assert_bf16_grads({"dx": dx}, {"dx": rdx})
        assert_check_sees_float32({"dx": f32_dx}, {"dx": rdx})
    else:
        assert dx is None
    again = mip_mlp.mip_mlp_bwd(packed, x, g_out, input_grads=input_grads)
    assert all(torch.equal(again[1][k], d_packed[k]) for k in d_packed)


@pytest.mark.cuda
@pytest.mark.parametrize("seg_weight,white", [(0.0, False), (0.1, True)])
@pytest.mark.parametrize("variant", sorted(MIP_BF16_VARIANTS))
def test_bf16_mip_train_grads_matches_plain(cuda, variant, seg_weight, white):
    """K6 in bf16 against its plain bf16 version, bitwise repeatable."""
    cfg, packed = mip_packed("full_width", cuda, **MIP_BF16_VARIANTS[variant])
    a = mip_bf16_inputs(cfg, packed, cuda, rays=64, rows=63, seed=7)
    args = [a[k] for k in ("features", "dists", "noise", "pixels", "labels")]
    kw = dict(color_outputs=cfg.color_outputs, seg_weight=seg_weight, white_background=white)
    policies = dict(_build.policy_counts)
    rgb, seg, grads = mip_train.mip_train_grads(packed, *args, **kw)
    torch.cuda.synchronize()
    assert policy_moves(policies) == {
        (mip_train.TRAIN_NAME, mip_bf16_route(cfg, mip_train.TRAIN_NAME)): 1}
    r_rgb, r_seg, ref = mip_train.mip_train_grads_plain(packed, *args, **kw)
    assert rel_l2(rgb + seg_weight * seg, r_rgb + seg_weight * r_seg) <= BF16_FWD
    assert (float(seg) == 0.0) == (seg_weight == 0.0)
    assert_bf16_grads(grads, ref)
    again = mip_train.mip_train_grads(packed, *args, **kw)
    assert torch.equal(again[0], rgb) and all(torch.equal(again[2][k], grads[k]) for k in grads)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", classic_mlp.HIDDEN_WIDTHS)
def test_bf16_mip_kernels_match_plain_at_every_width(cuda, hidden):
    """Every hidden width's bf16 products (m64nNk16 for N / 2 = 16 .. 128,
    the features' cotangent in passes of min(H, 64) columns) and a 9-wide
    head: K5-fwd, K5-bwd with dfeat (the float32 kernel fails its check),
    K6 and K7, each on tc_bf16."""
    cfg, packed = mip_packed("small", cuda, hidden_size=hidden)
    gen = torch.Generator(device=cuda).manual_seed(hidden)
    x = mip_rows_away_from_kinks(packed, gen, 1, BF16_ROWS, cfg.feature_dim,
                                 bf16=True)[0].bfloat16()
    _build.policy_counts.clear()
    out = mip_mlp.mip_mlp_fwd(packed, x)
    assert rel_l2(out, mip_mlp.mip_mlp_fwd_plain(packed, x)) <= BF16_FWD
    g_out = rand(gen, BF16_ROWS, cfg.num_outputs)
    dx, d_packed = mip_mlp.mip_mlp_bwd(packed, x, g_out)
    rdx, ref = mip_mlp.mip_mlp_bwd_plain(packed, x, g_out)
    assert dx.dtype == torch.bfloat16
    assert_bf16_grads(d_packed, ref)
    assert_bf16_grads({"dx": dx}, {"dx": rdx})
    a = mip_bf16_inputs(cfg, packed, cuda, rays=9, rows=33, seed=hidden)
    args = [a[k] for k in ("features", "dists", "noise", "pixels", "labels")]
    rgb, seg, grads = mip_train.mip_train_grads(packed, *args, cfg.color_outputs, 0.1)
    r_rgb, r_seg, ref = mip_train.mip_train_grads_plain(packed, *args, cfg.color_outputs, 0.1)
    assert rel_l2(rgb + 0.1 * seg, r_rgb + 0.1 * r_seg) <= BF16_FWD
    assert_bf16_grads(grads, ref)
    ev = (packed, a["features"], a["dists"], a["t_mids"], None, cfg.color_outputs)
    for g, r in zip(mip_train.mip_eval(*ev), mip_train.mip_eval_plain(*ev)):
        assert rel_l2(g, r) <= BF16_FWD
    torch.cuda.synchronize()
    assert dict(_build.policy_counts) == {
        (k, "tc_bf16"): 1 for k in (mip_mlp.NAME, mip_mlp.BWD_NAME, mip_train.TRAIN_NAME,
                                    mip_train.EVAL_NAME)}
    f32_dx, f32 = mip_mlp.mip_mlp_bwd(packed, x.float(), g_out)
    assert_check_sees_float32({"dx": f32_dx, **f32}, {"dx": rdx, **ref})


@pytest.mark.cuda
def test_bf16_mip_head_rounds_its_operands(cuda):
    """The 54-wide head in bf16, held directly against the float64 products
    of the rounded operands on the same rows, and shown to differ from the
    unrounded ones (``testing.mip_head_rounding``): K5-fwd's head
    (head_wide), K5-bwd's head input cotangent (head_dh) and the head's dW
    (wgrad)."""
    cfg, packed = mip_packed("full_width", cuda)
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = mip_rows_away_from_kinks(packed, gen, 1, 4096, cfg.feature_dim, bf16=True)[0].bfloat16()
    checks = mip_head_rounding(packed, x, rand(gen, x.shape[0], cfg.num_outputs))
    assert checks.pop("h") == 0.0  # head_wide rounded the last layer's output
    for name, (err, err_unrounded) in checks.items():
        assert err <= 2e-5 and err_unrounded > 100 * err, (name, err, err_unrounded)


@pytest.mark.cuda
def test_bf16_mip_model_paths_launch_the_bf16_kernels(cuda):
    """A bf16 MipNeRF at full width: a frame tile through K7, the fused
    step (one K6, the seg CE on) and the general step (one K5-fwd, one
    K5-bwd), every call on tc_bf16, each within the bounds of its plain
    bf16 path (``plain_versions``: the four wrappers' plain versions)."""
    from nerf_tpu_torch.train import loop

    cfg = MipNeRFConfig(use_pallas=True, compute_dtype="bfloat16")
    model = MipNeRF(cfg, generator=torch.Generator().manual_seed(0), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    o, d = rand(gen, 400, 3, lo=-0.5, hi=0.5), rand(gen, 400, 3)
    render = RenderConfig(num_coarse_samples=64, randomly_sample=False)
    _build.policy_counts.clear()
    with torch.no_grad():
        out = model.render_rays(o, d, render, fused_eval=True)
        torch.cuda.synchronize()
        assert dict(_build.policy_counts) == {(mip_train.EVAL_NAME, "tc_bf16"): 1}
        with plain_versions():
            ref = model.render_rays(o, d, render, fused_eval=True)
    assert rel_l2(out.rgb, ref.rgb) <= BF16_FWD and rel_l2(out.acc, ref.acc) <= BF16_FWD
    train_render = RenderConfig(num_coarse_samples=64, randomly_sample=True,
                                density_noise_std=1.0)
    n_rays = 4096
    batch = dict(rays_o=rand(gen, n_rays, 3, lo=-0.5, hi=0.5), rays_d=rand(gen, n_rays, 3),
                 pixels=rand(gen, n_rays, 3, lo=0.0, hi=1.0),
                 labels=torch.randint(0, cfg.segmentation_outputs, (n_rays,), generator=gen,
                                      device=cuda))
    draws = loop.draws_for_model(torch.Generator(device=cuda).manual_seed(1), model,
                                 train_render, n_rays, cuda)
    _build.launch_counts.clear()
    _build.policy_counts.clear()
    loss, grads, _ = loop.make_fused_loss_and_grads(model, train_render, 0.1)(batch, draws)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {mip_train.TRAIN_NAME: 1}
    assert set(_build.policy_counts) == {(mip_train.TRAIN_NAME, "tc_bf16")}
    r_loss, ref = bf16_step_reference(model, train_render, batch, draws, 0.1)
    assert rel_l2(loss, r_loss) <= BF16_FWD
    assert_bf16_grads(grads, ref)
    _build.launch_counts.clear()
    _build.policy_counts.clear()
    with torch.enable_grad():
        loss, _ = loop.make_loss_fn(model, train_render, 0.1)(batch, draws)
        names, params = zip(*model.named_parameters())
        grads = dict(zip(names, torch.autograd.grad(loss, params)))
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {mip_mlp.NAME: 1, mip_mlp.BWD_NAME: 1}
    assert set(_build.policy_counts) == {(mip_mlp.NAME, "tc_bf16"), (mip_mlp.BWD_NAME, "tc_bf16")}
    with plain_versions(), torch.enable_grad():
        r_loss, _ = loop.make_loss_fn(model, train_render, 0.1)(batch, draws)
        ref = dict(zip(names, torch.autograd.grad(r_loss, params)))
    assert rel_l2(loss.detach(), r_loss.detach()) <= BF16_FWD
    assert_bf16_grads(grads, ref)


# -- compute_dtype="bfloat16": K8-fwd, K8-bwd and K9 --------------------------

# The classic bf16 kernels' bounds (BF16_FWD, BF16_GRAD) against the plain
# bf16 versions.  K8 takes float32 raw points and a ``dtype``: its sines
# stay float32 in the block and the products round them, and K8-bwd writes
# them to scratch rounded to bfloat16 (``rounded_encodings`` bitwise) and
# keeps the encodings' cotangents float32 before the chain rule.  K8-bwd
# runs on BF16_ROWS raw points away from the bf16 forward's kinks and a
# loss's cotangents (``point_loss_cotangent``), as K1-bwd's tests do: on
# uniform random cotangents its weight gradients, sums of terms of either
# sign, move by 2.2e-2 at hidden 256 between two float32-accurate bf16
# evaluations (``scripts/torch_bf16_sensitivity.py --family point``).  The
# float32 kernel on the same inputs fails the check: on the raw inputs'
# cotangents at every width, on the weights at hidden 256.  K9 runs on its
# own step's rows, its scratch encodings (coarse copied, fine written by
# the kernel) held bitwise against the plain version's rounded ones, and
# its fine t-values in probability, within BF16_FWD of the uniforms: the
# kernel's and the plain bf16 coarse weights differ by bf16's roundings.
# Its gradients' spread against plain bf16 shrinks with the rays summed
# (at hidden 256 and 64 + 128 samples: 1.9e-2 at 64 rays, 9.4e-3 at 2048;
# ``scripts/torch_bf16_sensitivity.py --family point``), so its checks
# take 512 rays and more at the cells' 64 + 128 samples.
POINT_BF16_VARIANTS = {"full_width": dict(), "wide": dict(x_positional_encoding_size=40)}


def point_bf16_case(device, rows, seed, **overrides):
    cfg = ClassicNeRFConfig(normalize_position=6.0, **{"hidden_size": 256, **overrides})
    mlp = ClassicMLP(cfg, generator=torch.Generator().manual_seed(0), device=device)
    packed = classic_mlp.pack_classic_params(mlp.requires_grad_(False))
    consts = point_consts(cfg, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    pts, dirs = away_from_kinks(packed, consts, gen, rows, tc_mlp.bf16_matmul)
    return cfg, packed, consts, pts, dirs


def point_loss_cotangent(packed, pts, dirs, consts) -> torch.Tensor:
    """K8's output cotangents under ``test_pallas.py``'s bf16 objective,
    mean(density^2) + mean(sin(color)), at the plain bf16 forward."""
    out = point_mlp.classic_pointmlp_fwd_plain(packed, pts, dirs, consts, dtype=torch.bfloat16)
    n, c = out.shape[0], out.shape[1] - 1
    return torch.cat([2 * out[:, :1] / n, torch.cos(out[:, 1:]) / (n * c)], -1)


def raw_cotangents(result) -> dict:
    return {"dpoints": result[0], "ddirs": result[1]}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(POINT_BF16_VARIANTS))
def test_bf16_pointmlp_fwd_matches_plain(cuda, variant):
    """K8-fwd in bf16 against its plain bf16 version and K1-fwd's bf16
    kernel on the rounded encodings: the tensor-core tile at full width
    (tc_bf16), the bf16-rounding SIMT tile at x encodings 120 + 36
    (simt_bf16)."""
    cfg, packed, consts, pts, dirs = point_bf16_case(cuda, 1000, 6,
                                                     **POINT_BF16_VARIANTS[variant])
    bf = torch.bfloat16
    policies = dict(_build.policy_counts)
    out = point_mlp.classic_pointmlp_fwd(packed, pts, dirs, consts, dtype=bf)
    torch.cuda.synchronize()
    route = _build.tile_plan(point_mlp.NAME, cfg.x_encoding_dim, cfg.d_encoding_dim,
                             256).policy + "_bf16"
    assert route == ("tc_bf16" if variant == "full_width" else "simt_bf16")
    assert policy_moves(policies) == {(point_mlp.NAME, route): 1}
    assert out.dtype == torch.float32
    assert rel_l2(out, point_mlp.classic_pointmlp_fwd_plain(packed, pts, dirs, consts,
                                                            dtype=bf)) <= BF16_FWD
    x_enc, d_enc = point_mlp.rounded_encodings(pts, dirs, consts, bf)
    assert rel_l2(out, classic_mlp.classic_mlp_fwd(packed, x_enc, d_enc)) <= BF16_FWD


@pytest.mark.cuda
@pytest.mark.parametrize("input_grads", [True, False])
@pytest.mark.parametrize("variant", sorted(POINT_BF16_VARIANTS))
def test_bf16_pointmlp_bwd_matches_plain(cuda, variant, input_grads):
    """K8-bwd in bf16 on BF16_ROWS raw points away from the bf16 forward's
    kinks and a loss's cotangents: the weight gradients and the raw inputs'
    cotangents (float32) against the plain bf16 version, the float32 kernel
    on the same inputs failing the check; its scratch encodings bitwise the
    plain rounded ones."""
    cfg, packed, consts, pts, dirs = point_bf16_case(cuda, BF16_ROWS, 7,
                                                     **POINT_BF16_VARIANTS[variant])
    g_out = point_loss_cotangent(packed, pts, dirs, consts)
    bf = torch.bfloat16
    policies = dict(_build.policy_counts)
    keep = {}
    got = point_mlp.classic_pointmlp_bwd(packed, pts, dirs, consts, g_out, input_grads,
                                         dtype=bf, keep=keep)
    torch.cuda.synchronize()
    route = _build.tile_plan(point_mlp.BWD_NAME, cfg.x_encoding_dim, cfg.d_encoding_dim,
                             256).policy + "_bf16"
    assert policy_moves(policies) == {(point_mlp.BWD_NAME, route): 1}
    for enc, want in zip((keep["x_enc"], keep["d_enc"]),
                         point_mlp.rounded_encodings(pts, dirs, consts, bf)):
        assert enc.dtype == bf and torch.equal(enc, want)
    ref = point_mlp.classic_pointmlp_bwd_plain(packed, pts, dirs, consts, g_out, input_grads,
                                               dtype=bf)
    f32 = point_mlp.classic_pointmlp_bwd(packed, pts, dirs, consts, g_out, input_grads)
    assert_bf16_grads(got[2], ref[2])
    if not input_grads:
        assert got[0] is None and got[1] is None
        assert_check_sees_float32(f32[2], ref[2])
        return
    assert got[0].dtype == got[1].dtype == torch.float32
    assert_bf16_grads(raw_cotangents(got), raw_cotangents(ref))
    assert_check_sees_float32(raw_cotangents(f32), raw_cotangents(ref))


def check_mega_bf16_against_plain(model, render, batch, draws, white, exact):
    """One bf16 K9 call against its plain bf16 version with its own fine
    t-values; its scratch encodings bitwise the plain rounded ones."""
    inputs = mega_train.mega_inputs(model, batch, draws)
    assert inputs[0].dtype == torch.bfloat16
    packed = classic_mlp.pack_classic_params(model.mlp.requires_grad_(False))
    policies = dict(_build.policy_counts)
    keep = {}
    loss_c, loss_f, d_packed, t_fine = mega_train.mega_train(packed, *inputs, white, exact,
                                                             keep=keep)
    torch.cuda.synchronize()
    assert policy_moves(policies) == {(mega_train.NAME, "tc_bf16"): 1}
    x_enc_c, d_ray, t_c, noise_c, u, _, rays_o, rays_d, _, placement, is_cos = inputs
    x_fine = mega_train.encode_fine_plain(t_fine, rays_o, rays_d, placement, is_cos, exact)
    assert torch.equal(keep["x_all"], torch.cat([x_enc_c, x_fine.bfloat16()]))
    weights_c = mega_train.coarse_weights_plain(packed, x_enc_c, d_ray, t_c, noise_c, rays_d)
    bins = 0.5 * (t_c[:, 1:] + t_c[:, :-1])
    mass = (sampling.pdf_cdf_at(bins, weights_c[:, 1:-1], t_fine) - u).abs().max()
    assert float(mass) <= BF16_FWD, float(mass)
    r_loss_c, r_loss_f, ref, _ = mega_train.mega_train_plain(packed, *inputs, white, exact,
                                                             t_fine=t_fine)
    assert rel_l2(torch.stack([loss_c, loss_f]), torch.stack([r_loss_c, r_loss_f])) <= BF16_FWD
    assert_bf16_grads(d_packed, ref)
    return packed, inputs, (loss_c, loss_f, d_packed, t_fine)


@pytest.mark.cuda
@pytest.mark.parametrize("white,exact", [(False, False), (True, True)])
@pytest.mark.parametrize("view", [True, False])
def test_bf16_mega_train_matches_plain(cuda, view, white, exact):
    """K9 in bf16 at full width on 512 rays x (64 + 128), with and without
    the view branch, both fine encodings' forms; bitwise repeatable."""
    packed, inputs, first = check_mega_bf16_against_plain(
        *mega_setup(cuda, view, 64, 128, white, rays=512, hidden=256,
                    compute_dtype="bfloat16"), white, exact)
    second = mega_train.mega_train(packed, *inputs, white, exact)
    torch.cuda.synchronize()
    for a, b in ((first[0], second[0]), (first[1], second[1]), (first[3], second[3])):
        assert torch.equal(a, b)
    assert all(torch.equal(first[2][k], second[2][k]) for k in first[2])


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", classic_mlp.HIDDEN_WIDTHS)
def test_bf16_point_and_mega_kernels_match_plain_at_every_width(cuda, hidden):
    """K8-fwd, K8-bwd (a loss's cotangents; the float32 kernel fails the
    raw inputs' check) and K9 (512 rays x (64 + 128), 98,304 rows) in bf16
    at every hidden width."""
    cfg, packed, consts, pts, dirs = point_bf16_case(cuda, BF16_ROWS, hidden,
                                                     hidden_size=hidden)
    bf = torch.bfloat16
    out = point_mlp.classic_pointmlp_fwd(packed, pts, dirs, consts, dtype=bf)
    assert rel_l2(out, point_mlp.classic_pointmlp_fwd_plain(packed, pts, dirs, consts,
                                                            dtype=bf)) <= BF16_FWD
    g_out = point_loss_cotangent(packed, pts, dirs, consts)
    got = point_mlp.classic_pointmlp_bwd(packed, pts, dirs, consts, g_out, dtype=bf)
    ref = point_mlp.classic_pointmlp_bwd_plain(packed, pts, dirs, consts, g_out, dtype=bf)
    assert_bf16_grads(got[2], ref[2])
    assert_bf16_grads(raw_cotangents(got), raw_cotangents(ref))
    assert_check_sees_float32(
        raw_cotangents(point_mlp.classic_pointmlp_bwd(packed, pts, dirs, consts, g_out)),
        raw_cotangents(ref))
    check_mega_bf16_against_plain(*mega_setup(cuda, True, 64, 128, False, rays=512,
                                              hidden=hidden, compute_dtype="bfloat16"),
                                  False, False)


@pytest.mark.cuda
def test_bf16_point_and_mega_model_paths(cuda):
    """``classic_pointmlp(..., compute_dtype="bfloat16")`` under autograd
    (one K8-fwd and one K8-bwd, both tc_bf16) against autograd through its
    plain bf16 version, and a bf16 model's K9 step at the cell's 2048 rays
    x (64 + 128) (one mega_train, tc_bf16) against the plain bf16 step and
    the bf16 reuse route."""
    cfg = ClassicNeRFConfig(hidden_size=256, normalize_position=6.0, use_pallas=True,
                            compute_dtype="bfloat16")
    model = ClassicNeRF(cfg, generator=torch.Generator().manual_seed(0), device=cuda)
    with torch.no_grad():  # mass in every bin (see chip_smoke.py)
        model.mlp.density.bias.fill_(0.5)
        model.mlp.density.weight.mul_(0.05)
    args = (cfg.x_positional_encoding_size, cfg.normalize_position,
            cfg.d_positional_encoding_size, cfg.direction_bound)
    gen = torch.Generator(device=cuda).manual_seed(3)
    pts, dirs = raw_points(gen, 4096)
    names, params = zip(*model.named_parameters())
    _build.launch_counts.clear()
    _build.policy_counts.clear()
    dens, col = point_mlp.classic_pointmlp(model, pts, dirs, *args, compute_dtype="bfloat16")
    loss = dens.pow(2).mean() + torch.sin(col).mean()
    grads = torch.autograd.grad(loss, params)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {point_mlp.NAME: 1, point_mlp.BWD_NAME: 1}
    assert dict(_build.policy_counts) == {(point_mlp.NAME, "tc_bf16"): 1,
                                          (point_mlp.BWD_NAME, "tc_bf16"): 1}
    packed = classic_mlp.pack_classic_params(model.mlp)
    out = point_mlp.classic_pointmlp_fwd_plain(
        packed, pts, dirs, point_consts(cfg, cuda), dtype=torch.bfloat16)
    r_loss = out[:, :1].pow(2).mean() + torch.sin(out[:, 1:]).mean()
    ref = torch.autograd.grad(r_loss, params)
    assert rel_l2(loss, r_loss) <= BF16_FWD
    assert_bf16_grads(dict(zip(names, grads)), dict(zip(names, ref)))

    render = RenderConfig(num_coarse_samples=64, num_fine_samples=128, density_noise_std=1.0,
                          reuse_coarse_in_fine=True)
    batch = dict(rays_o=rand(gen, 2048, 3) * 0.3, rays_d=rand(gen, 2048, 3),
                 pixels=rand(gen, 2048, 3, lo=0.0, hi=1.0))
    draws = sampling.draw_step(torch.Generator(device=cuda).manual_seed(1), render, 2048, cuda)
    _build.launch_counts.clear()
    _build.policy_counts.clear()
    loss, grads, _ = mega_train.mega_train_loss_and_grads(model, render, batch, draws)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {mega_train.NAME: 1}
    assert dict(_build.policy_counts) == {(mega_train.NAME, "tc_bf16"): 1}
    reuse_loss, reuse, _ = fine_stage_train.reuse_train_loss_and_grads(model, render, batch,
                                                                       draws)
    assert rel_l2(loss, reuse_loss) <= BF16_FWD
    assert_bf16_grads(grads, reuse)
    check_mega_bf16_against_plain(model, render, batch, draws, False, False)


@pytest.mark.cuda
def test_bf16_point_and_mega_wrappers_refuse_mixed_dtypes(cuda):
    """On the card too, before any launch: K8's images in another dtype
    than its compute dtype, K8's raw points in bfloat16, K9's view
    encodings in another dtype than its coarse ones."""
    cfg, packed = packed_weights("h128", cuda)
    consts = point_consts(cfg, cuda)
    pts, dirs = raw_points(torch.Generator(device=cuda).manual_seed(0), 8)
    launches = dict(_build.launch_counts)
    f32_image = tc_mlp.tc_images(packed)[0]
    with pytest.raises(TypeError, match="tc_fwd must be bfloat16"):
        point_mlp.classic_pointmlp_fwd(packed, pts, dirs, consts, tc_fwd=f32_image,
                                       dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="points must be float32"):
        point_mlp.classic_pointmlp_bwd(packed, pts.bfloat16(), dirs, consts,
                                       torch.zeros(8, 4, device=cuda), dtype=torch.bfloat16)
    model, render, batch, draws = mega_setup(cuda, True, 8, 16, False, rays=4,
                                             compute_dtype="bfloat16")
    inputs = list(mega_train.mega_inputs(model, batch, draws))
    inputs[1] = inputs[1].float()
    with pytest.raises(TypeError, match="d_ray must be bfloat16"):
        mega_train.mega_train(classic_mlp.pack_classic_params(model.mlp.requires_grad_(False)),
                              *inputs)
    assert dict(_build.launch_counts) == launches


# -- data parallelism (slice 15) -------------------------------------------------


@pytest.mark.cuda
def test_data_parallel_reuse_step_at_one_rank_is_the_step_without_a_mesh(cuda):
    # An NCCL group of one: three fused reuse steps at full width (2048 x
    # (64 + 128), K1-fwd, K3 and K1-bwd each) with the gradients averaged
    # over the mesh, bitwise the same steps without a mesh.
    from nerf_tpu_torch import parallel
    from nerf_tpu_torch.data import RayBank
    from nerf_tpu_torch.train import create_train_state, loop, make_fused_loss_and_grads

    render = RenderConfig(num_coarse_samples=64, num_fine_samples=128, density_noise_std=1.0)
    gen = torch.Generator(device=cuda).manual_seed(3)
    images = rand(gen, 2, 32, 32, 3, lo=0.0, hi=1.0)
    poses_r = torch.linalg.qr(rand(gen, 2, 3, 3))[0]
    bank = RayBank.from_images(images, rand(gen, 2, 3) * 4.0, poses_r, 40.0)

    def model():
        m = ClassicNeRF(ClassicNeRFConfig(normalize_position=6.0, use_pallas=True),
                        generator=torch.Generator().manual_seed(0), device=cuda)
        with torch.no_grad():  # mass in every bin (see chip_smoke.py)
            m.mlp.density.bias.fill_(0.5)
            m.mlp.density.weight.mul_(0.05)
        return m

    parallel.initialize(device=cuda, timeout_s=120.0)
    try:
        mesh = parallel.make_mesh()
        assert torch.distributed.get_backend() == "nccl" and mesh.size == 1
        single = create_train_state(model(), 1e-4, seed=2)
        sharded = parallel.prepare_parallel_state(create_train_state(model(), 1e-4, seed=2), mesh)
        one = make_fused_loss_and_grads(single.model, render)
        dp = parallel.make_parallel_loss_and_grads(sharded.model, render, mesh, fused=True)
        for _ in range(3):
            batch, draws = loop._sample(single, bank, 2048, render)
            loss, grads, aux = one(batch, draws)
            _build.launch_counts.clear()
            d_loss, d_grads, d_aux = dp(parallel.shard_batch(batch, mesh),
                                        parallel.shard_draws(draws, mesh))
            torch.cuda.synchronize()
            assert _build.launch_counts == STEP_LAUNCHES["reuse"]
            assert torch.equal(loss, d_loss)
            assert all(torch.equal(grads[k], d_grads[k]) for k in grads)
            loop._apply(single, grads, aux)
            loop._apply(sharded, d_grads, d_aux)
        assert all(torch.equal(p, q) for p, q in zip(single.model.parameters(),
                                                     sharded.model.parameters()))
    finally:
        parallel.shutdown()
