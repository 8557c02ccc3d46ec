"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and ``nvcc`` and skips without one (the
kernels have no CPU mode).  The file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: K1 sums float32 products in another order than cuBLAS (TF32
off), through ten LayerNorm'd layers; K4 adds the transmittance summed in
merged order where the plain version sums two blocks and cross terms.
"""

import pytest
import torch

from nerf_tpu_torch import ClassicNeRF, ClassicNeRFConfig, RenderConfig
from nerf_tpu_torch.models.mlp import ClassicMLP
from nerf_tpu_torch.ops import compositing
from nerf_tpu_torch.ops.kernels import _build, classic_mlp, fine_stage_train, train_grads, union_eval

K1_TOL = dict(rtol=1e-4, atol=1e-4)
K4_TOL = dict(rtol=5e-4, atol=1e-4)

VARIANTS = {
    "full_width": dict(hidden_size=256),
    "h128": dict(hidden_size=128),
    "no_view": dict(hidden_size=64, use_viewdirs=False),
    "latent": dict(hidden_size=32, density_inputs=5, color_inputs=4),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def packed_weights(variant, device):
    cfg = ClassicNeRFConfig(**VARIANTS[variant])
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
    cfg, packed = packed_weights(variant, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = rand(gen, points, cfg.x_encoding_dim)
    d = rand(gen, points, cfg.d_encoding_dim) if cfg.use_viewdirs else None
    g_out = rand(gen, points, 1 + cfg.color_outputs)
    before = _build.launch_counts[classic_mlp.BWD_NAME]
    dx, dd, d_packed = classic_mlp.classic_mlp_bwd(packed, x, d, g_out)
    torch.cuda.synchronize()
    assert _build.launch_counts[classic_mlp.BWD_NAME] == before + 1
    rdx, rdd, r_packed = classic_mlp.classic_mlp_bwd_plain(packed, x, d, g_out)
    assert_grads_close(d_packed, r_packed)
    assert_grads_close({"dx": dx} | ({"dd": dd} if d is not None else {}),
                       {"dx": rdx} | ({"dd": rdd} if d is not None else {}))
    # As autograd calls it when the encodings need no gradient.
    dx, dd, d_packed = classic_mlp.classic_mlp_bwd(packed, x, d, g_out, input_grads=False)
    assert dx is None and dd is None
    assert_grads_close(d_packed, r_packed)


def train_inputs(cfg, device, rays, s, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    t = torch.sort(rand(gen, rays, s, lo=2.0, hi=6.0), -1).values
    dists = compositing.distances_from_tvals(t, rand(gen, rays, 3))
    d_ray = rand(gen, rays, 1, cfg.d_encoding_dim)
    return dict(
        x_enc=rand(gen, rays, s, cfg.x_encoding_dim),
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
    a = train_inputs(cfg, cuda, rays=3, s=s)
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


def fine_inputs(cfg, device, rays, sc, sf, seed=0):
    args = union_args(cfg, None, device, rays, sc, sf, seed)
    _, x_enc, d_ray, t_c, t_f, dens_c, col_c, dnorm = args
    gen = torch.Generator(device=device).manual_seed(seed + 1)
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
    a = fine_inputs(cfg, cuda, rays=3, sc=sc, sf=sf)
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
