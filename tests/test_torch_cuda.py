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
from nerf_tpu_torch.ops.kernels import _build, classic_mlp, union_eval

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
