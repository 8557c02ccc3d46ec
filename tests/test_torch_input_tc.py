"""The tensor-core input cotangents of K8-bwd and K5-bwd on the CPU.

K8-bwd (``point_mlp.classic_pointmlp_bwd``) and K5-bwd
(``mip_mlp.mip_mlp_bwd``) run their MLP products as 3xTF32 on the
tensor cores, the encodings' and the features' cotangents ``dx = dpre
W^T`` included (``csrc/tc_mlp.cuh``'s ``tc_input_grad``, on the input
slabs' backward images ``tc_mlp.input_image``).  Here, before any card run:

* the plain versions with their products emulated as the kernels compute
  them (``matmul=tc_mlp.tc_matmul_autograd``) meet the card's bounds
  against their float32 selves: every weight gradient and input cotangent
  (``dpoints``, ``ddirs``, ``dfeat``) within a relative L2 error of 1e-2
  and within 1e-4 of its largest entry (``chip_smoke.py``,
  ``tests/test_torch_cuda.py``), at full width (hidden 256, encodings
  60 + 36; the mip model's 96 features), the LayerNorms moved off the
  identity;
* with the default ``matmul`` both plain versions are bitwise what they
  were: autograd through the float32 chain;
* the input slabs' images hold each slab bitwise, zero past its rows, in
  the swizzled order the kernels read;
* the emulated K5-bwd agrees with the JAX package's ``mip_mlp_pallas`` VJP
  run in interpret mode (small model, hidden 32): every gradient and
  ``dfeat`` within 1e-4 of its largest entry, the card tests' bound (the
  float32 plain version is within 3e-5, ``tests/test_torch_mip_kernels.py``;
  3xTF32 keeps about 21 bits of each product);
* the wrappers check images built beforehand, and the autograd functions
  hand the backward kernel the images their forward built (none on the
  CPU).

Inputs come from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nerf_tpu.ops.pallas import fused_mip_mlp
from nerf_tpu_torch import ClassicNeRFConfig, MipNeRFConfig
from nerf_tpu_torch.models.mlp import LAYER_NORM_EPS, ClassicMLP, MipMLP
from nerf_tpu_torch.ops.kernels import classic_mlp, mip_mlp, point_mlp, tc_mlp
from test_torch_mip_kernels import exact_ln_stats, setup_model  # noqa: F401  (autouse fixture)

GRAD_REL_L2 = 1e-2
GRAD_ATOL = 1e-4  # of the largest entry, as the card tests hold the kernels
EMULATED_VS_PALLAS = 1e-4  # of the largest entry


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def uniform(rng, *shape, lo=-1.0, hi=1.0):
    return t(rng.uniform(lo, hi, shape))


def off_identity(mlp: torch.nn.Module, rng) -> torch.nn.Module:
    """The MLP with its LayerNorms moved off the identity (scales in [0.5,
    1.5], biases in [-0.3, 0.3]), so their gradients mean something."""
    with torch.no_grad():
        for m in mlp.modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.weight.copy_(uniform(rng, *m.weight.shape, lo=0.5, hi=1.5))
                m.bias.copy_(uniform(rng, *m.bias.shape, lo=-0.3, hi=0.3))
    return mlp.requires_grad_(False)


def point_case(points=300, seed=0, **cfg_kwargs):
    """K8's packed weights (full width by default), encoding constants, raw
    points in [-2, 2], directions in [-1, 1] and output cotangents."""
    cfg = ClassicNeRFConfig(normalize_position=6.0, **cfg_kwargs)
    rng = np.random.default_rng(seed)
    mlp = off_identity(ClassicMLP(cfg, generator=torch.Generator().manual_seed(0), device="cpu"),
                       rng)
    consts = point_mlp.encoding_consts(cfg.x_positional_encoding_size, cfg.normalize_position,
                                       cfg.d_positional_encoding_size, cfg.direction_bound, "cpu")
    return (classic_mlp.pack_classic_params(mlp), uniform(rng, points, 3, lo=-2.0, hi=2.0),
            uniform(rng, points, 3), consts, uniform(rng, points, 1 + cfg.color_outputs))


def mip_case(rows=300, seed=1, **cfg_kwargs):
    """K5's packed weights (``MipNeRFConfig()`` by default), features in
    [-1, 1] and output cotangents."""
    cfg = MipNeRFConfig(**cfg_kwargs)
    rng = np.random.default_rng(seed)
    mlp = off_identity(MipMLP(cfg, generator=torch.Generator().manual_seed(0), device="cpu"), rng)
    return (mip_mlp.pack_mip_params(mlp), uniform(rng, rows, cfg.feature_dim),
            uniform(rng, rows, cfg.num_outputs))


def assert_grads_within_card_bounds(got: dict, ref: dict):
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        rel = float((got[k] - r).norm() / r.norm().clamp_min(1e-30))
        assert rel <= GRAD_REL_L2, (k, rel)
        scale = float(r.abs().max()) + 1e-12
        assert float((got[k] - r).abs().max()) <= GRAD_ATOL * scale, k


@pytest.mark.parametrize("input_grads", [True, False])
def test_pointmlp_bwd_with_3xtf32_products_meets_the_card_tolerance(input_grads):
    """K8-bwd's plain version at full width on 300 raw points, the
    forward, ``dh``, ``dW`` and the encodings' cotangents emulated as
    3xTF32, against its float32 self at the card's bounds; the raw inputs'
    cotangents through the chain rule of the encoding."""
    packed, pts, dirs, consts, g_out = point_case()
    rdp, rdd, ref = point_mlp.classic_pointmlp_bwd_plain(packed, pts, dirs, consts, g_out,
                                                         input_grads)
    edp, edd, got = point_mlp.classic_pointmlp_bwd_plain(packed, pts, dirs, consts, g_out,
                                                         input_grads,
                                                         matmul=tc_mlp.tc_matmul_autograd)
    assert not torch.equal(got["w0"], ref["w0"])  # the emulation is not the float32 path
    if input_grads:
        got |= {"dpoints": edp, "ddirs": edd}
        ref |= {"dpoints": rdp, "ddirs": rdd}
    else:
        assert edp is None and edd is None
    assert_grads_within_card_bounds(got, ref)


@pytest.mark.parametrize("input_grads", [True, False])
def test_mip_mlp_bwd_with_3xtf32_products_meets_the_card_tolerance(input_grads):
    """K5-bwd's plain version for ``MipNeRFConfig()`` (hidden 256, 96
    features, 5 layers, 54 outputs) on 300 rows, its products and the
    features' cotangent emulated as 3xTF32 (the head float32, as in the
    kernel), against its float32 self at the card's bounds."""
    packed, feat, g_out = mip_case()
    rdx, ref = mip_mlp.mip_mlp_bwd_plain(packed, feat, g_out, input_grads)
    edx, got = mip_mlp.mip_mlp_bwd_plain(packed, feat, g_out, input_grads,
                                         matmul=tc_mlp.tc_matmul_autograd)
    assert not torch.equal(got["w_in"], ref["w_in"])
    if input_grads:
        got, ref = got | {"dfeat": edx}, ref | {"dfeat": rdx}
    else:
        assert edx is None
    assert_grads_within_card_bounds(got, ref)


def test_pointmlp_bwd_plain_default_matmul_is_bitwise_unchanged():
    """``classic_pointmlp_bwd_plain``'s default path, and an explicit
    ``matmul=torch.matmul``, equal bitwise autograd through K1's float32
    plain forward on the encodings ``sin(x S + phase)`` (hidden 64, 20
    points), with and without the raw inputs' cotangents."""
    packed, pts, dirs, consts, g_out = point_case(points=20, hidden_size=64)
    leaves = {k: v.detach().requires_grad_(True) for k, v in packed.items()}
    p, d = pts.clone().requires_grad_(True), dirs.clone().requires_grad_(True)
    with torch.enable_grad():
        out = classic_mlp.classic_mlp_fwd_plain(leaves, torch.sin(p @ consts[0] + consts[1]),
                                                torch.sin(d @ consts[2] + consts[3]))
        rdp, rdd, *rw = torch.autograd.grad(out, [p, d, *leaves.values()], g_out)
    ref = dict(zip(leaves, rw))
    for kwargs in ({}, {"matmul": torch.matmul}):
        dp, dd, got = point_mlp.classic_pointmlp_bwd_plain(packed, pts, dirs, consts, g_out,
                                                           **kwargs)
        assert torch.equal(dp, rdp) and torch.equal(dd, rdd)
        assert got.keys() == ref.keys() and all(torch.equal(got[k], ref[k]) for k in ref)
        _, _, got = point_mlp.classic_pointmlp_bwd_plain(packed, pts, dirs, consts, g_out,
                                                         input_grads=False, **kwargs)
        assert all(torch.equal(got[k], ref[k]) for k in ref)


def test_mip_mlp_bwd_plain_default_matmul_is_bitwise_unchanged():
    """``mip_mlp_bwd_plain``'s default path, and an explicit
    ``matmul=torch.matmul``, equal bitwise autograd through the mip chain
    written out with ``@`` (a small model, 20 rows), with and without the
    features' cotangent."""
    packed, feat, g_out = mip_case(rows=20, hidden_size=64, num_hidden_layers=3,
                                   encoding_size=8, segmentation_outputs=5)

    def written_out(w, x):
        h = x
        for i in range(w["b"].shape[0]):
            z = h @ (w["w_in"] if i == 0 else w["whh"][i - 1]) + w["b"][i]
            h = torch.relu(F.layer_norm(z, z.shape[-1:], w["g"][i], w["beta"][i],
                                        LAYER_NORM_EPS))
        return h @ w["w_out"] + w["b_out"]

    leaves = {k: v.detach().requires_grad_(True) for k, v in packed.items()}
    x = feat.clone().requires_grad_(True)
    with torch.enable_grad():
        rdx, *rw = torch.autograd.grad(written_out(leaves, x), [x, *leaves.values()], g_out)
    ref = dict(zip(leaves, rw))
    for kwargs in ({}, {"matmul": torch.matmul}):
        dx, got = mip_mlp.mip_mlp_bwd_plain(packed, feat, g_out, **kwargs)
        assert torch.equal(dx, rdx)
        assert got.keys() == ref.keys() and all(torch.equal(got[k], ref[k]) for k in ref)
        _, got = mip_mlp.mip_mlp_bwd_plain(packed, feat, g_out, input_grads=False, **kwargs)
        assert all(torch.equal(got[k], ref[k]) for k in ref)


def input_slab_cases(hidden):
    """``(packed, layers)`` of the full-width classic model (xe 60, de 36),
    a classic one with wider encodings (xe 102, two 64-row passes at hidden
    >= 64) and the mip models with 96 and 24 features, at ``hidden``."""
    classic = [ClassicNeRFConfig(hidden_size=hidden),
               ClassicNeRFConfig(hidden_size=hidden, x_positional_encoding_size=34)]
    mip = [MipNeRFConfig(hidden_size=hidden),
           MipNeRFConfig(hidden_size=hidden, num_hidden_layers=3, encoding_size=8)]
    gen = torch.Generator().manual_seed(hidden)
    out = [(classic_mlp.pack_classic_params(ClassicMLP(c, generator=gen, device="cpu")), 10)
           for c in classic]
    out += [(mip_mlp.pack_mip_params(MipMLP(c, generator=gen, device="cpu")), c.num_hidden_layers)
            for c in mip]
    return out


@pytest.mark.parametrize("hidden", classic_mlp.HIDDEN_WIDTHS)
def test_input_images_round_trip_bitwise_with_zero_padding(hidden):
    """The backward images hold, after the hidden slabs, ``w0``, ``wx``,
    ``wd_in`` (or the mip ``w_in``) as packed, ``[in][out]``: each slab's
    hi and lo parts bitwise, zero rows up to a multiple of 64, each pass of
    ``min(H, 64)`` rows its own image, and every element where
    ``tc_gemm``'s 64-byte-swizzle descriptors read it; then, for the mip
    weights, the head's ``w_out [H, O]`` as it stands (the B operand of the
    head's input cotangent on the tensor cores), bitwise; the sizes are
    ``image_numels``'."""
    for packed, layers in input_slab_cases(hidden):
        with torch.no_grad():
            _, bwd = tc_mlp.tc_images(packed, backward=True)
        assert bwd.numel() == tc_mlp.image_numels(packed)[1]
        rows, at = min(hidden, tc_mlp.INPUT_PAD), (layers - 1) * 2 * hidden * hidden
        for name in [k for k in tc_mlp.INPUT_SLABS if k in packed]:
            w = packed[name]
            n, padded = w.shape[0], tc_mlp.round_up_input(w.shape[0])
            size = 2 * padded * hidden
            img = bwd[at:at + size]
            assert torch.equal(img, tc_mlp.input_image(w))
            hi, lo = tc_mlp.operand_image_unpack(img.reshape(padded // rows, -1), rows, hidden)
            hi, lo = hi.reshape(padded, hidden), lo.reshape(padded, hidden)
            want_hi, want_lo = tc_mlp.tf32_split(w)
            assert torch.equal(hi[:n], want_hi) and torch.equal(lo[:n], want_lo), name
            assert int((hi[n:] != 0).sum() + (lo[n:] != 0).sum()) == 0, name
            for nn in range(0, n, 5):
                p, r = divmod(nn, rows)
                for kk in range(0, hidden, 7):
                    c, kl = divmod(kk, tc_mlp.CHUNK)
                    off = (p * 2 * rows * hidden + 2 * rows * tc_mlp.CHUNK * c + tc_mlp.CHUNK * r
                           + 4 * ((kl // 4) ^ ((r // 2) % 4)) + kl % 4)
                    assert img[off] == want_hi[nn, kk] and img[off + rows * tc_mlp.CHUNK] == \
                        want_lo[nn, kk]
            at += size
        for name in [k for k in tc_mlp.HEAD_SLABS if k in packed]:
            img = tc_mlp.head_image(packed[name])
            assert torch.equal(bwd[at:at + img.numel()], img), name
            at += img.numel()
        assert at == bwd.numel()


def test_emulated_mip_mlp_bwd_matches_pallas_vjp():
    """The emulated K5-bwd (3xTF32 products, the features' cotangent too)
    against ``fused_mip_mlp.mip_mlp_pallas``'s VJP in interpret mode on the
    small model of ``tests/test_torch_mip_kernels.py`` (hidden 32, 3
    layers, 24 features, 3 + 5 outputs), 100 rows: every gradient and
    ``dfeat`` within 1e-4 of its largest entry."""
    cfg, params, packed = setup_model(1)
    rng = np.random.default_rng(2)
    feat = rng.normal(size=(100, cfg.feature_dim)).astype(np.float32)
    g_out = rng.normal(size=(100, cfg.num_outputs)).astype(np.float32)
    _, vjp = jax.vjp(lambda p, x: fused_mip_mlp.mip_mlp_pallas(p, x, 3, 3, interpret=True),
                     params, jnp.asarray(feat))
    gp, gx = vjp((g_out[:, :1], g_out[:, 1:4], g_out[:, 4:]))
    want = {k: np.asarray(v) for k, v in fused_mip_mlp.pack_mip_params(gp).items()}
    want["dfeat"] = np.asarray(gx)
    dfeat, got = mip_mlp.mip_mlp_bwd_plain(packed, t(feat), t(g_out),
                                           matmul=tc_mlp.tc_matmul_autograd)
    got["dfeat"] = dfeat
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy().reshape(w.shape)
        scale = np.abs(w).max() + 1e-12
        np.testing.assert_allclose(g / scale, w / scale, rtol=0, atol=EMULATED_VS_PALLAS,
                                   err_msg=k)


def test_input_cotangent_wrappers_check_images_built_beforehand():
    """K8-bwd and K5-bwd given operand images of other weights raise
    before they read them, naming the image."""
    packed, pts, dirs, consts, g_out = point_case(points=4, hidden_size=64)
    other = classic_mlp.pack_classic_params(
        ClassicMLP(ClassicNeRFConfig(hidden_size=32), device="cpu"))
    fwd, bwd = tc_mlp.tc_images(other, backward=True)
    with pytest.raises(ValueError, match="tc_bwd"):
        point_mlp.classic_pointmlp_bwd(packed, pts, dirs, consts, g_out, tc_bwd=bwd)
    with pytest.raises(ValueError, match="tc_fwd"):
        point_mlp.classic_pointmlp_bwd(packed, pts, dirs, consts, g_out, tc_fwd=fwd)
    mpacked, feat, mg = mip_case(rows=4, hidden_size=64)
    mfwd, mbwd = tc_mlp.tc_images(mip_case(rows=1, hidden_size=32)[0], backward=True)
    with pytest.raises(ValueError, match="tc_bwd"):
        mip_mlp.mip_mlp_bwd(mpacked, feat, mg, tc_bwd=mbwd)
    with pytest.raises(ValueError, match="tc_fwd"):
        mip_mlp.mip_mlp_bwd(mpacked, feat, mg, tc_fwd=mfwd)


def test_autograd_hands_the_backward_what_the_forward_built(monkeypatch):
    """Under autograd ``classic_pointmlp`` and ``mip_mlp_fwd`` hand K8-bwd
    and K5-bwd the operand images their forward built: on the card the
    images, once a step (``tests/test_torch_cuda.py``), on the CPU none, as
    the plain versions read none; the gradients are the plain path's."""
    seen = []
    for module, name in ((point_mlp, "classic_pointmlp_bwd"), (mip_mlp, "mip_mlp_bwd")):
        original = getattr(module, name)

        def recording(*args, _original=original, **kwargs):
            seen.append((kwargs["tc_fwd"], kwargs["tc_bwd"]))
            return _original(*args, **kwargs)

        monkeypatch.setattr(module, name, recording)
    cfg = ClassicNeRFConfig(hidden_size=32, normalize_position=6.0)
    packed, pts, dirs, consts, _ = point_case(points=6, hidden_size=32)
    leaves = {k: v.clone().requires_grad_(True) for k, v in packed.items()}
    dens, col = point_mlp.classic_pointmlp(
        leaves, pts, dirs, cfg.x_positional_encoding_size, cfg.normalize_position,
        cfg.d_positional_encoding_size, cfg.direction_bound)
    got = torch.autograd.grad(col.sum() + dens.sum(), list(leaves.values()))
    mpacked, feat, _ = mip_case(rows=6, hidden_size=32, num_hidden_layers=3, encoding_size=8)
    mleaves = {k: v.clone().requires_grad_(True) for k, v in mpacked.items()}
    mgot = torch.autograd.grad(mip_mlp.mip_mlp_fwd(mleaves, feat).sum(), list(mleaves.values()))
    assert seen == [(None, None), (None, None)]
    _, _, ref = point_mlp.classic_pointmlp_bwd_plain(packed, pts, dirs, consts,
                                                     torch.ones(6, 4), input_grads=False)
    assert all(torch.equal(g, ref[k]) for k, g in zip(leaves, got))
    _, mref = mip_mlp.mip_mlp_bwd_plain(mpacked, feat, torch.ones(6, mpacked["w_out"].shape[1]),
                                        input_grads=False)
    assert all(torch.equal(g, mref[k]) for k, g in zip(mleaves, mgot))
