"""The tensor-core arithmetic of K6 and K7 on the CPU: the mip operand
images the wrappers build for ``wgmma`` (``ops/kernels/tc_mlp.py``), and
the plain versions of the kernels run with their products emulated as the
kernels compute them (``matmul=tc_mlp.tc_matmul`` / ``tc_matmul_autograd``),
held against their float32 selves at the tolerances the card holds the
kernels to (``chip_smoke.py``, ``tests/test_torch_cuda.py``):

* K7: rtol 1e-4, atol 1e-4 on rgb, the segmentation log-probabilities,
  depth and acc;
* K6: the loss within rtol 1e-4, every gradient within a relative L2 error
  of 1e-2 and within 1e-4 of its largest entry.

That shows, before any card run, that the precision scheme meets the
bounds.  Inputs come from numpy seeds; the model is the full-width MipNeRF
(hidden 256, 96 IPE features, 5 layers, 3 + 50 outputs) with its
LayerNorms moved off the identity, as the card tests draw it.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nerf_tpu_torch import MipNeRF, MipNeRFConfig, RenderConfig
from nerf_tpu_torch.models.mlp import LAYER_NORM_EPS, MipMLP
from nerf_tpu_torch.ops import compositing
from nerf_tpu_torch.ops.kernels import classic_mlp, mip_mlp, mip_train, tc_mlp

K7_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_REL_L2 = 1e-2
GRAD_ATOL = 1e-4  # of the largest entry, as the card tests hold K6
LOSS_RTOL = 1e-4
SMALL = dict(hidden_size=64, num_hidden_layers=3, encoding_size=8, segmentation_outputs=5)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def uniform(rng, *shape, lo=-1.0, hi=1.0):
    return t(rng.uniform(lo, hi, shape))


def mip_case(seed=0, **cfg_kwargs):
    """A mip MLP's packed weights (LayerNorms off the identity, from a
    numpy seed) and its config."""
    cfg = MipNeRFConfig(**cfg_kwargs)
    mlp = MipMLP(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in mlp.modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.weight.copy_(uniform(rng, *m.weight.shape, lo=0.5, hi=1.5))
                m.bias.copy_(uniform(rng, *m.bias.shape, lo=-0.3, hi=0.3))
    return cfg, mip_mlp.pack_mip_params(mlp.requires_grad_(False))


def ray_inputs(cfg, rays, rows, seed=1):
    """The per-ray kernels' inputs: features, interval lengths from
    Gaussian means along each ray, midpoints, noise, pixels and labels."""
    rng = np.random.default_rng(seed)
    points = torch.cumsum(uniform(rng, rays, rows, 3, lo=0.0, hi=1.0), dim=1)
    return dict(
        features=uniform(rng, rays, rows, cfg.feature_dim),
        dists=compositing.distances_from_points(points).contiguous(),
        t_mids=torch.sort(uniform(rng, rays, rows, lo=0.1, hi=60.0), -1).values,
        noise=uniform(rng, rays, rows),
        pixels=uniform(rng, rays, cfg.color_outputs, lo=0.0, hi=1.0),
        labels=torch.from_numpy(rng.integers(0, cfg.segmentation_outputs, rays)),
    )


def assert_grads_within_card_bounds(got: dict, ref: dict):
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        rel = float((got[k] - r).norm() / r.norm().clamp_min(1e-30))
        assert rel <= GRAD_REL_L2, (k, rel)
        scale = float(r.abs().max()) + 1e-12
        assert float((got[k] - r).abs().max()) <= GRAD_ATOL * scale, k


@pytest.mark.parametrize("white,noise", [(False, False), (True, True)])
def test_mip_eval_with_3xtf32_products_meets_the_card_tolerance(white, noise):
    """K7's plain version at full width, 3 rays x 63 interval rows, with
    its hidden and feature products emulated as 3xTF32 (the head float32, as
    in the kernel), against its float32 self at K7's card tolerance."""
    cfg, packed = mip_case()
    a = ray_inputs(cfg, rays=3, rows=63)
    args = (packed, a["features"], a["dists"], a["t_mids"], a["noise"] if noise else None,
            cfg.color_outputs, white)
    ref = mip_train.mip_eval_plain(*args)
    got = mip_train.mip_eval_plain(*args, matmul=tc_mlp.tc_matmul)
    assert not torch.equal(got[1], ref[1])  # the emulation is not the float32 path
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, **K7_TOL)


@pytest.mark.parametrize("seg_weight,white", [(0.1, False), (0.0, True)])
def test_mip_train_grads_with_3xtf32_products_meets_the_card_tolerance(seg_weight, white):
    """K6's plain version at full width, 3 rays x 63 rows, with the
    forward, ``dh`` and ``dW`` products emulated as 3xTF32, against its
    float32 self: the losses within rtol 1e-4, every gradient within the
    card's bounds; with seg weight 0 the segmentation head gets no
    gradient in either."""
    cfg, packed = mip_case()
    a = ray_inputs(cfg, rays=3, rows=63)
    args = (packed, a["features"], a["dists"], a["noise"], a["pixels"], a["labels"],
            cfg.color_outputs, seg_weight, white)
    r_rgb, r_seg, r_grads = mip_train.mip_train_grads_plain(*args)
    e_rgb, e_seg, e_grads = mip_train.mip_train_grads_plain(
        *args, matmul=tc_mlp.tc_matmul_autograd)
    torch.testing.assert_close(e_rgb, r_rgb, rtol=LOSS_RTOL, atol=0)
    torch.testing.assert_close(e_seg, r_seg, rtol=LOSS_RTOL, atol=0)
    assert_grads_within_card_bounds(e_grads, r_grads)
    if seg_weight == 0.0:
        assert not bool(e_grads["w_out"][:, 1 + cfg.color_outputs:].any())


def test_mip_plain_default_matmul_is_bitwise_unchanged():
    """The ``matmul`` argument leaves the default paths as they were: the
    MLP, K7's and K6's plain versions equal, bitwise, the chain written out
    with ``@`` (and autograd through it), and so does an explicit
    ``matmul=torch.matmul`` (a small model, 2 rays x 13 rows)."""
    cfg, packed = mip_case(**SMALL)
    a = ray_inputs(cfg, rays=2, rows=13)

    def written_out(w, x):
        h = x
        for i in range(w["b"].shape[0]):
            z = h @ (w["w_in"] if i == 0 else w["whh"][i - 1]) + w["b"][i]
            h = torch.relu(F.layer_norm(z, z.shape[-1:], w["g"][i], w["beta"][i],
                                        LAYER_NORM_EPS))
        return h @ w["w_out"] + w["b_out"]

    x = a["features"].reshape(26, -1)
    out = written_out(packed, x)
    assert torch.equal(mip_mlp.mip_mlp_fwd_plain(packed, x), out)
    assert torch.equal(mip_mlp.mip_mlp_fwd_plain(packed, x, torch.matmul), out)

    args = (packed, a["features"], a["dists"], a["t_mids"], a["noise"], cfg.color_outputs)
    default = mip_train.mip_eval_plain(*args)
    explicit = mip_train.mip_eval_plain(*args, matmul=torch.matmul)
    rows = out.reshape(2, 13, -1)
    weights = compositing.weights_from_density(rows[..., :1] + a["noise"][..., None], a["dists"])
    seg = compositing.composite_segmentation(weights, rows[..., 1 + cfg.color_outputs:])
    assert torch.equal(default[1], seg)
    assert all(torch.equal(d, e) for d, e in zip(default, explicit))

    leaves = {k: v.detach().requires_grad_(True) for k, v in packed.items()}
    with torch.enable_grad():
        rows = written_out(leaves, x).reshape(2, 13, -1)
        weights = compositing.weights_from_density(rows[..., :1] + a["noise"][..., None],
                                                   a["dists"])
        rgb = compositing.composite_rgb_with_background(weights, rows[..., 1:4], None)
        seg = compositing.composite_segmentation(weights, rows[..., 4:])
        rgb_loss = torch.mean((rgb - a["pixels"]) ** 2)
        seg_loss = -torch.mean(torch.take_along_dim(seg, a["labels"][:, None], dim=-1))
        ref = dict(zip(leaves, torch.autograd.grad(rgb_loss + 0.1 * seg_loss,
                                                   list(leaves.values()))))
    targs = (packed, a["features"], a["dists"], a["noise"], a["pixels"], a["labels"],
             cfg.color_outputs, 0.1)
    for kwargs in ({}, {"matmul": torch.matmul}):
        got_rgb, got_seg, got = mip_train.mip_train_grads_plain(*targs, **kwargs)
        assert torch.equal(got_rgb, rgb_loss.detach()) and torch.equal(got_seg, seg_loss.detach())
        assert got.keys() == ref.keys() and all(torch.equal(got[k], ref[k]) for k in ref)


@pytest.mark.parametrize("hidden", classic_mlp.HIDDEN_WIDTHS)
def test_mip_tc_images_hold_w_in_and_every_slab_in_order(hidden):
    """The mip weights' operand images: the forward holds ``w_in`` as
    ``[H][F]`` (96 features, already a multiple of 16; 24 in the small
    model, padded to 32), then every hidden slab as ``[out][in]``; the
    backward every hidden slab as the packed ``[in][out]``; both the sizes
    ``image_numels`` counts, each slab's hi and lo parts bitwise."""
    for kwargs in ({}, SMALL):
        cfg, packed = mip_case(**{**kwargs, "hidden_size": hidden})
        fwd, bwd = tc_mlp.tc_images(packed, backward=True)
        assert (fwd.numel(), bwd.numel()) == tc_mlp.image_numels(packed)
        f, h, layers = cfg.feature_dim, hidden, cfg.num_hidden_layers
        size = 2 * h * tc_mlp.round_up_chunk(f)
        hi, lo = tc_mlp.operand_image_unpack(fwd[:size], h, f)
        want_hi, want_lo = tc_mlp.tf32_split(packed["w_in"].t())
        assert torch.equal(hi[:, :f], want_hi) and torch.equal(lo[:, :f], want_lo)
        assert int((hi[:, f:] != 0).sum() + (lo[:, f:] != 0).sum()) == 0
        slabs = fwd[size:].reshape(layers - 1, -1)
        assert slabs.shape[1] == 2 * h * h
        for i in range(layers - 1):
            hi, lo = tc_mlp.operand_image_unpack(slabs[i], h, h)
            want_hi, want_lo = tc_mlp.tf32_split(packed["whh"][i].t())
            assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
            bwd_slabs = bwd[:(layers - 1) * 2 * h * h]  # w_in's image follows
            hi, lo = tc_mlp.operand_image_unpack(bwd_slabs.reshape(layers - 1, -1)[i], h, h)
            want_hi, want_lo = tc_mlp.tf32_split(packed["whh"][i])
            assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)


def test_mip_wrappers_check_images_built_beforehand():
    """A wrapper given operand images of other weights raises before it
    reads them; ``prepare_weights`` on the CPU builds none."""
    cfg, packed = mip_case(**SMALL)
    _, wide = mip_case(**{**SMALL, "hidden_size": 32})
    a = ray_inputs(cfg, rays=2, rows=5)
    fwd, bwd = tc_mlp.tc_images(wide, backward=True)
    with pytest.raises(ValueError, match="tc_fwd"):
        mip_train.mip_eval(packed, a["features"], a["dists"], a["t_mids"], tc_fwd=fwd)
    with pytest.raises(ValueError, match="tc_bwd"):
        mip_train.mip_train_grads(packed, a["features"], a["dists"], a["noise"], a["pixels"],
                                  a["labels"], tc_bwd=bwd)
    mlp = MipMLP(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    prepared = mip_mlp.prepare_weights(mlp, backward=True)
    assert prepared.tc_fwd is None and prepared.tc_bwd is None
    assert all(torch.equal(prepared.packed[k], v)
               for k, v in mip_mlp.pack_mip_params(mlp).items())


def test_mip_render_image_packs_the_weights_once_a_frame(monkeypatch):
    """On K7's path ``MipNeRF.render_image`` packs the weights once for the
    frame's kernel calls (here 4 tiles, each through K7's plain version on
    the CPU), and renders what the plain path renders."""
    models = {p: MipNeRF(MipNeRFConfig(use_pallas=p, **SMALL),
                         generator=torch.Generator().manual_seed(0), device="cpu")
              for p in (True, False)}
    calls = []
    pack = mip_mlp.pack_mip_params
    monkeypatch.setattr(mip_mlp, "pack_mip_params", lambda mlp: calls.append(1) or pack(mlp))
    render = RenderConfig(num_coarse_samples=8, randomly_sample=False, rays_per_tile=16)
    pose_o = torch.tensor([[0.0, -4.0, 0.5]])
    pose_r = torch.eye(3)[None]
    images = {p: m.render_image(pose_o, pose_r, 8, 8, 10.0, render) for p, m in models.items()}
    assert len(calls) == 1
    for got, ref in zip(images[True], images[False]):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
