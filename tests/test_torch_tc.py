"""The tensor-core arithmetic of K1, K2, K3, K4 and K9 on the CPU: the
3xTF32 split, the operand images the wrappers build for ``wgmma``
(``ops/kernels/tc_mlp.py``), and the plain versions of the kernels run
with their products emulated as the kernels compute them, held against
their float32 selves at the tolerances the card holds the kernels to
(``chip_smoke.py``, ``tests/test_torch_cuda.py``):

* K1-fwd: rtol 1e-4, atol 1e-4;
* K1-bwd (without the encodings' cotangents, the call the tensor cores
  serve), K2 and K3: every gradient within a relative L2 error of 1e-2 and
  within 1e-4 of its largest entry (K2 and K3: and the loss within rtol
  1e-4);
* K4: rtol 5e-4, atol 1e-4;
* K9: loss rtol 1e-4, every gradient within a relative L2 error of 1e-2,
  the fine samples' plain cdf within 2e-5 of their uniforms (beyond the mass
  that 4 ulp of t carry);
That shows, before any card run, that the precision scheme meets the bounds.
Inputs come from numpy seeds; the models are the full-width ClassicNeRF
(hidden 256, encodings 60 + 36, view branch on) and its no-view variant.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nerf_tpu_torch import ClassicNeRF, ClassicNeRFConfig, RenderConfig
from nerf_tpu_torch.models.mlp import ClassicMLP
from nerf_tpu_torch.ops import sampling
from nerf_tpu_torch.ops import compositing
from nerf_tpu_torch.ops.kernels import (
    classic_mlp,
    fine_stage_train,
    mega_train,
    tc_mlp,
    train_grads,
    union_eval,
)

K1_TOL = dict(rtol=1e-4, atol=1e-4)
K4_TOL = dict(rtol=5e-4, atol=1e-4)
GRAD_REL_L2 = 1e-2
GRAD_ATOL = 1e-4  # of the largest entry, as the card tests hold K2 and K3
LOSS_RTOL = 1e-4
T_FINE_MASS = 2e-5


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def uniform(rng, *shape, lo=-1.0, hi=1.0):
    return t(rng.uniform(lo, hi, shape))


def test_tf32_split_keeps_about_21_bits():
    x = uniform(np.random.default_rng(0), 4096, lo=-1e3, hi=1e3)
    hi, lo = tc_mlp.tf32_split(x)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert bool((lo.abs() <= 2.0 ** -10 * x.abs()).all())
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -20 * x.abs().double()).all())


def test_tc_matmul_is_float32_accurate():
    rng = np.random.default_rng(1)
    a, b = uniform(rng, 64, 256), uniform(rng, 256, 256)
    exact = a.double() @ b.double()
    scale = float(exact.abs().max())
    assert float((tc_mlp.tc_matmul(a, b).double() - exact).abs().max()) < 1e-5 * scale
    # One TF32 product is not the same function.
    one = tc_mlp.tf32_split(a)[0] @ tc_mlp.tf32_split(b)[0]
    assert float((one.double() - exact).abs().max()) > 1e-4 * scale


def test_tc_matmul_autograd_emulates_both_backward_products():
    rng = np.random.default_rng(2)
    a = uniform(rng, 16, 40).requires_grad_(True)
    b = uniform(rng, 40, 32).requires_grad_(True)
    g = uniform(rng, 16, 32)
    ga, gb = torch.autograd.grad(tc_mlp.tc_matmul_autograd(a, b), (a, b), g)
    assert torch.equal(ga, tc_mlp.tc_matmul(g, b.detach().t()))
    assert torch.equal(gb, tc_mlp.tc_matmul(a.detach().t(), g))


@pytest.mark.parametrize("k", [5, 36, 60, 100, 256])
@pytest.mark.parametrize("n", classic_mlp.HIDDEN_WIDTHS)
def test_operand_image_round_trip_is_bitwise(n, k):
    b = uniform(np.random.default_rng(n + k), 3, n, k)
    img = tc_mlp.operand_image(b)
    kp = tc_mlp.round_up_chunk(k)
    assert img.shape == (3, 2 * n * kp)
    hi, lo = tc_mlp.operand_image_unpack(img, n, k)
    want_hi, want_lo = tc_mlp.tf32_split(F.pad(b, (0, kp - k)))
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
    assert int((hi[..., k:] != 0).sum() + (lo[..., k:] != 0).sum()) == 0


@pytest.mark.parametrize("n,k", [(256, 60), (256, 36), (32, 256), (64, 100)])
def test_operand_image_is_the_swizzled_order(n, k):
    """Element (n, k) sits where csrc/tc_mlp.cuh's 64-byte-swizzle
    descriptors read it: in chunk c = k // 16 at 2 N 16 c + 16 n + 4 (((k %
    16) // 4) ^ ((n // 2) % 4)) + k % 4, its lo part 16 N floats further."""
    b = uniform(np.random.default_rng(3), n, k)
    img = tc_mlp.operand_image(b)
    hi, lo = tc_mlp.tf32_split(b)
    for nn in range(0, n, 7):
        for kk in range(0, k, 5):
            c, kl = divmod(kk, tc_mlp.CHUNK)
            at = (2 * n * tc_mlp.CHUNK * c + tc_mlp.CHUNK * nn + 4 * ((kl // 4) ^ ((nn // 2) % 4))
                  + kl % 4)
            assert img[at] == hi[nn, kk] and img[at + n * tc_mlp.CHUNK] == lo[nn, kk]


def full_width_mlp(hidden=256, view=True):
    cfg = ClassicNeRFConfig(hidden_size=hidden, use_viewdirs=view)
    return ClassicMLP(cfg, generator=torch.Generator().manual_seed(0),
                     device="cpu").requires_grad_(False)


@pytest.mark.parametrize("hidden", classic_mlp.HIDDEN_WIDTHS)
def test_forward_slabs_are_the_linear_weights(hidden):
    mlp = full_width_mlp(hidden)
    packed = classic_mlp.pack_classic_params(mlp)
    slabs = tc_mlp.forward_slabs(packed)
    assert torch.equal(slabs["w0"], mlp.block_0[0].weight)
    assert torch.equal(slabs["wx"], mlp.block_1[0].weight[:, hidden:])
    assert torch.equal(slabs["wd_in"], mlp.block_2[0].weight[:, hidden:])
    assert torch.equal(slabs["whh"][0], mlp.block_0[3].weight)
    assert torch.equal(slabs["whh"][3], mlp.block_1[0].weight[:, :hidden])
    assert torch.equal(slabs["whh"][8], mlp.block_2[3].weight)


@pytest.mark.parametrize("view", [True, False])
def test_tc_images_hold_every_slab_in_order(view):
    packed = classic_mlp.pack_classic_params(full_width_mlp(256, view))
    fwd, bwd = tc_mlp.tc_images(packed, backward=True)
    h, xe = 256, 60
    slabs = tc_mlp.forward_slabs(packed)
    names = ["w0", "wx"] + (["wd_in"] if view else [])
    at = 0
    for name in names:
        k = slabs[name].shape[1]
        size = 2 * h * tc_mlp.round_up_chunk(k)
        hi, lo = tc_mlp.operand_image_unpack(fwd[at:at + size], h, k)
        assert hi.shape[1] == {60: 64, 36: 48}[k]  # the encodings padded
        assert torch.equal(hi[:, :k] + lo[:, :k], sum(tc_mlp.tf32_split(slabs[name])))
        at += size
    layers = 10 if view else 8
    whh = fwd[at:].reshape(layers - 1, -1)
    assert at == 2 * h * (2 * 64 + (48 if view else 0)) and whh.shape[1] == 2 * h * h
    assert torch.equal(tc_mlp.operand_image_unpack(whh, h, h)[0],
                       tc_mlp.tf32_split(slabs["whh"])[0])
    bwd_slabs = bwd[:(layers - 1) * 2 * h * h]  # the input slabs' images follow
    assert torch.equal(tc_mlp.operand_image_unpack(bwd_slabs.reshape(layers - 1, -1), h, h)[1],
                       tc_mlp.tf32_split(packed["whh"])[1])
    assert xe == packed["w0"].shape[0]


def union_inputs(packed, cfg, rays, sc, sf, seed=4):
    rng = np.random.default_rng(seed)
    t_c = torch.sort(uniform(rng, rays, sc, lo=2.0, hi=6.0), -1).values
    t_f = torch.sort(uniform(rng, rays, sf, lo=2.0, hi=6.0), -1).values
    d_enc = uniform(rng, rays, cfg.d_encoding_dim) if cfg.use_viewdirs else None
    return (packed, uniform(rng, rays, sf, cfg.x_encoding_dim), d_enc, t_c, t_f,
            uniform(rng, rays, sc, 1, lo=-3.0, hi=6.0), uniform(rng, rays, sc, 3, lo=-3.0, hi=3.0),
            uniform(rng, rays, lo=0.5, hi=2.0))


@pytest.mark.parametrize("view", [True, False])
def test_union_eval_with_3xtf32_products_meets_the_card_tolerance(view):
    cfg = ClassicNeRFConfig(use_viewdirs=view)
    packed = classic_mlp.pack_classic_params(full_width_mlp(256, view))
    args = union_inputs(packed, cfg, rays=3, sc=64, sf=128)
    ref = union_eval.union_eval_plain(*args)
    got = union_eval.union_eval_plain(*args, matmul=tc_mlp.tc_matmul)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, **K4_TOL)


def mega_case(view, rays=3, sc=64, sf=128, seed=5):
    model = ClassicNeRF(ClassicNeRFConfig(normalize_position=6.0, use_viewdirs=view),
                        generator=torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():  # mass in every bin (see chip_smoke.py)
        model.mlp.density.bias.fill_(0.5)
        model.mlp.density.weight.mul_(0.05)
    render = RenderConfig(num_coarse_samples=sc, num_fine_samples=sf, randomly_sample=True,
                          density_noise_std=1.0, reuse_coarse_in_fine=True)
    rng = np.random.default_rng(seed)
    batch = {"rays_o": uniform(rng, rays, 3, lo=-0.5, hi=0.5), "rays_d": uniform(rng, rays, 3),
             "pixels": uniform(rng, rays, 3, lo=0.0, hi=1.0)}
    draws = sampling.draw_step(torch.Generator().manual_seed(seed), render, rays, "cpu")
    inputs = mega_train.mega_inputs(model, batch, draws)
    return classic_mlp.pack_classic_params(model.mlp.requires_grad_(False)), inputs


@pytest.mark.parametrize("view", [True, False])
def test_mega_step_with_3xtf32_products_meets_the_card_tolerance(view):
    packed, inputs = mega_case(view)
    emulate = tc_mlp.tc_matmul_autograd
    loss_c, loss_f, _, t_fine = mega_train.mega_train_plain(packed, *inputs, matmul=emulate)
    # Everything downstream with the emulated step's own fine t-values.
    r_c, r_f, r_grads, _ = mega_train.mega_train_plain(packed, *inputs, t_fine=t_fine)
    e_c, e_f, e_grads, _ = mega_train.mega_train_plain(packed, *inputs, t_fine=t_fine,
                                                       matmul=emulate)
    torch.testing.assert_close(e_c, loss_c, rtol=0, atol=0)
    torch.testing.assert_close(e_c + e_f, r_c + r_f, rtol=LOSS_RTOL, atol=0)
    for k, r in r_grads.items():
        rel = float((e_grads[k] - r).norm() / r.norm().clamp_min(1e-30))
        assert rel <= GRAD_REL_L2, (k, rel)
    # The emulated resample against the float32 plain cdf, in probability.
    x_enc_c, d_ray, t_c, noise_c, u, _, _, rays_d = inputs[:8]
    weights_c = mega_train.coarse_weights_plain(packed, x_enc_c, d_ray, t_c, noise_c, rays_d)
    bins, w = 0.5 * (t_c[:, 1:] + t_c[:, :-1]), weights_c[:, 1:-1]
    step = 4 * 2.0 ** -23 * t_fine.abs()
    slack = (sampling.pdf_cdf_at(bins, w, t_fine + step)
             - sampling.pdf_cdf_at(bins, w, t_fine - step)) / 2
    assert bool(((sampling.pdf_cdf_at(bins, w, t_fine) - u).abs() <= T_FINE_MASS + slack).all())


def k2_case(view, rays=2, s=64, seed=6):
    """K2's inputs at full width (hidden 256, encodings 60 + 36), the view
    encoding constant along each ray as the trainer gives it."""
    cfg = ClassicNeRFConfig(use_viewdirs=view)
    packed = classic_mlp.pack_classic_params(full_width_mlp(256, view))
    rng = np.random.default_rng(seed)
    t_vals = torch.sort(uniform(rng, rays, s, lo=2.0, hi=6.0), -1).values
    d_ray = uniform(rng, rays, 1, cfg.d_encoding_dim)
    return packed, dict(
        x_enc=uniform(rng, rays, s, cfg.x_encoding_dim),
        d_enc=d_ray.expand(rays, s, -1).contiguous() if view else None,
        dists=compositing.distances_from_tvals(t_vals, uniform(rng, rays, 3)).contiguous(),
        noise=uniform(rng, rays, s), pixels=uniform(rng, rays, 3, lo=0.0, hi=1.0),
    )


def k3_case(view, rays=2, sc=64, sf=128, seed=7):
    cfg = ClassicNeRFConfig(use_viewdirs=view)
    packed = classic_mlp.pack_classic_params(full_width_mlp(256, view))
    _, x_enc, d_ray, t_c, t_f, dens_c, col_c, dnorm = union_inputs(packed, cfg, rays, sc, sf,
                                                                  seed)
    rng = np.random.default_rng(seed + 1)
    return packed, dict(
        x_enc=x_enc, d_enc=None if d_ray is None else d_ray[:, None].expand(rays, sf, -1),
        t_coarse=t_c, t_fine=t_f, dens_c=dens_c, col_c=col_c, dnorm=dnorm,
        noise_f=uniform(rng, rays, sf), pixels=uniform(rng, rays, 3, lo=0.0, hi=1.0),
    )


def assert_grads_within_card_bounds(got: dict, ref: dict):
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        rel = float((got[k] - r).norm() / r.norm().clamp_min(1e-30))
        assert rel <= GRAD_REL_L2, (k, rel)
        scale = float(r.abs().max()) + 1e-12
        assert float((got[k] - r).abs().max()) <= GRAD_ATOL * scale, k


@pytest.mark.parametrize("view", [True, False])
def test_train_grads_with_3xtf32_products_meets_the_card_tolerance(view):
    """K2's plain version at full width, 2 rays x 64 samples (128 rows),
    with the forward, ``dh`` and ``dW`` products emulated as 3xTF32."""
    packed, a = k2_case(view)
    opts = dict(num_samples=64, white_background=view, loss_weight=0.5, return_weights=True)
    r_loss, r_grads, r_weights = train_grads.classic_train_grads_plain(packed, **a, **opts)
    e_loss, e_grads, e_weights = train_grads.classic_train_grads_plain(
        packed, **a, **opts, matmul=tc_mlp.tc_matmul_autograd)
    torch.testing.assert_close(e_loss, r_loss, rtol=LOSS_RTOL, atol=0)
    assert_grads_within_card_bounds(e_grads, r_grads)
    torch.testing.assert_close(e_weights, r_weights, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("view", [True, False])
def test_fine_stage_train_with_3xtf32_products_meets_the_card_tolerance(view):
    """K3's plain version at full width, 2 rays x (64 + 128) (256 fine
    rows), with its products emulated as 3xTF32; the coarse cotangents
    too."""
    packed, a = k3_case(view)
    opts = dict(white_background=not view, loss_weight=0.5)
    r_loss, r_grads, (r_gd, r_gc) = fine_stage_train.fine_stage_train_plain(packed, **a, **opts)
    e_loss, e_grads, (e_gd, e_gc) = fine_stage_train.fine_stage_train_plain(
        packed, **a, **opts, matmul=tc_mlp.tc_matmul_autograd)
    torch.testing.assert_close(e_loss, r_loss, rtol=LOSS_RTOL, atol=0)
    assert_grads_within_card_bounds(e_grads | {"g_dens_c": e_gd, "g_col_c": e_gc},
                                    r_grads | {"g_dens_c": r_gd, "g_col_c": r_gc})


def test_k2_and_k3_plain_default_matmul_is_bitwise_unchanged():
    """The ``matmul`` argument leaves the default path as it was: the plain
    versions equal, bitwise, autograd through their objective written out
    with ``classic_mlp_fwd_plain``'s own products (hidden 64, one ray)."""
    mlp = full_width_mlp(64)
    packed = classic_mlp.pack_classic_params(mlp)
    _, a = k2_case(True, rays=1, s=16)
    loss, grads = train_grads.classic_train_grads_plain(packed, **a, num_samples=16)
    leaves = {k: v.detach().requires_grad_(True) for k, v in packed.items()}
    with torch.enable_grad():
        out = classic_mlp.classic_mlp_fwd_plain(
            leaves, a["x_enc"].reshape(16, -1), a["d_enc"].reshape(16, -1)).reshape(1, 16, -1)
        weights = compositing.weights_from_density(out[..., :1] + a["noise"][..., None],
                                                   a["dists"])
        rgb = compositing.composite_rgb_with_background(weights, out[..., 1:], None)
        ref_loss = torch.mean((rgb - a["pixels"]) ** 2)
        ref = dict(zip(leaves, torch.autograd.grad(ref_loss, list(leaves.values()))))
    assert torch.equal(loss, ref_loss.detach())
    assert all(torch.equal(grads[k], ref[k]) for k in ref)
    explicit = train_grads.classic_train_grads_plain(packed, **a, num_samples=16,
                                                     matmul=torch.matmul)
    assert torch.equal(explicit[0], loss)
    assert all(torch.equal(explicit[1][k], grads[k]) for k in grads)

    _, f = k3_case(True, rays=1, sc=8, sf=16)
    f_loss, f_grads, f_cot = fine_stage_train.fine_stage_train_plain(packed, **f)
    leaves = {k: v.detach().requires_grad_(True) for k, v in packed.items()}
    dens_c = f["dens_c"].clone().requires_grad_(True)
    col_c = f["col_c"].clone().requires_grad_(True)
    with torch.enable_grad():
        out = classic_mlp.classic_mlp_fwd_plain(
            leaves, f["x_enc"].reshape(16, -1), f["d_enc"].reshape(16, -1)).reshape(1, 16, -1)
        weights = compositing.weights_from_union_norm(
            dens_c, out[..., :1] + f["noise_f"][..., None], f["t_coarse"], f["t_fine"],
            f["dnorm"][:, None])
        rgb = compositing.composite_rgb_with_background(
            weights, torch.cat([col_c, out[..., 1:]], dim=-2), None)
        ref_loss = torch.mean((rgb - f["pixels"]) ** 2)
        wrt = [dens_c, col_c, *leaves.values()]
        g_dens, g_col, *g_w = torch.autograd.grad(ref_loss, wrt)
    assert torch.equal(f_loss, ref_loss.detach())
    assert torch.equal(f_cot[0], g_dens) and torch.equal(f_cot[1], g_col)
    assert all(torch.equal(f_grads[k], g) for k, g in zip(leaves, g_w))


def k1_case(view, rows=256, seed=8):
    """K1's inputs at full width: ``rows`` encoded points (60 + 36 wide)
    and output cotangents, from a numpy seed."""
    cfg = ClassicNeRFConfig(use_viewdirs=view)
    packed = classic_mlp.pack_classic_params(full_width_mlp(256, view))
    rng = np.random.default_rng(seed)
    x = uniform(rng, rows, cfg.x_encoding_dim)
    d = uniform(rng, rows, cfg.d_encoding_dim) if view else None
    return packed, x, d, uniform(rng, rows, 1 + cfg.color_outputs)


@pytest.mark.parametrize("view", [True, False])
def test_classic_mlp_fwd_with_3xtf32_products_meets_the_card_tolerance(view):
    """K1-fwd's plain version at full width on 256 rows with its products
    emulated as 3xTF32, against its float32 self at K1's card tolerance."""
    packed, x, d, _ = k1_case(view)
    ref = classic_mlp.classic_mlp_fwd_plain(packed, x, d)
    got = classic_mlp.classic_mlp_fwd_plain(packed, x, d, matmul=tc_mlp.tc_matmul)
    assert not torch.equal(got, ref)  # the emulation is not the float32 path
    torch.testing.assert_close(got, ref, **K1_TOL)


@pytest.mark.parametrize("view", [True, False])
def test_classic_mlp_bwd_with_3xtf32_products_meets_the_card_tolerance(view):
    """K1-bwd's plain version at full width on 256 rows, as the reuse step
    calls it (no encoding cotangents), with the forward, ``dh`` and ``dW``
    products emulated as 3xTF32, against its float32 self at the card's
    gradient bounds."""
    packed, x, d, g_out = k1_case(view)
    _, _, ref = classic_mlp.classic_mlp_bwd_plain(packed, x, d, g_out, input_grads=False)
    dx, dd, got = classic_mlp.classic_mlp_bwd_plain(packed, x, d, g_out, input_grads=False,
                                                    matmul=tc_mlp.tc_matmul_autograd)
    assert dx is None and dd is None
    assert_grads_within_card_bounds(got, ref)


def test_classic_mlp_bwd_plain_default_matmul_is_bitwise_unchanged():
    """``classic_mlp_bwd_plain``'s default path equals, bitwise, autograd
    through ``classic_mlp_fwd_plain`` with its own products, with and
    without the encodings' cotangents, and so does an explicit
    ``matmul=torch.matmul`` (hidden 64, 32 rows)."""
    cfg = ClassicNeRFConfig(hidden_size=64)
    packed = classic_mlp.pack_classic_params(full_width_mlp(64))
    rng = np.random.default_rng(9)
    x, d = uniform(rng, 32, cfg.x_encoding_dim), uniform(rng, 32, cfg.d_encoding_dim)
    g_out = uniform(rng, 32, 4)
    leaves = {k: v.detach().requires_grad_(True) for k, v in packed.items()}
    xs, ds = x.clone().requires_grad_(True), d.clone().requires_grad_(True)
    with torch.enable_grad():
        out = classic_mlp.classic_mlp_fwd_plain(leaves, xs, ds)
        rdx, rdd, *rw = torch.autograd.grad(out, [xs, ds, *leaves.values()], g_out)
    ref = dict(zip(leaves, rw))
    for kwargs in ({}, {"matmul": torch.matmul}):
        dx, dd, got = classic_mlp.classic_mlp_bwd_plain(packed, x, d, g_out, **kwargs)
        assert torch.equal(dx, rdx) and torch.equal(dd, rdd)
        assert got.keys() == ref.keys() and all(torch.equal(got[k], ref[k]) for k in ref)
        _, _, got = classic_mlp.classic_mlp_bwd_plain(packed, x, d, g_out, input_grads=False,
                                                      **kwargs)
        assert all(torch.equal(got[k], ref[k]) for k in ref)


def test_render_image_packs_the_weights_once_a_frame(monkeypatch):
    """On the kernel path ``render_image`` packs the weights once for the
    frame's kernel calls (here 4 tiles, each through K1-fwd and K4's plain
    versions on the CPU), and renders what the plain path renders."""
    cfg = dict(hidden_size=32, normalize_position=6.0)
    models = {p: ClassicNeRF(ClassicNeRFConfig(use_pallas=p, **cfg),
                             generator=torch.Generator().manual_seed(0), device="cpu")
              for p in (True, False)}
    for m in models.values():
        with torch.no_grad():  # mass in every bin (see chip_smoke.py)
            m.mlp.density.bias.fill_(0.5)
            m.mlp.density.weight.mul_(0.05)
    calls = []
    pack = classic_mlp.pack_classic_params
    monkeypatch.setattr(classic_mlp, "pack_classic_params",
                        lambda mlp: calls.append(1) or pack(mlp))
    render = RenderConfig(num_coarse_samples=8, num_fine_samples=16, randomly_sample=False,
                          rays_per_tile=16)
    pose_o = torch.tensor([[0.0, -4.0, 0.5]])
    pose_r = torch.eye(3)[None]
    images = {p: m.render_image(pose_o, pose_r, 8, 8, 10.0, render) for p, m in models.items()}
    assert len(calls) == 1
    torch.testing.assert_close(images[True], images[False], rtol=1e-4, atol=1e-5)
