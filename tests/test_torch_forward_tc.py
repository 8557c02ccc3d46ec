"""The tensor-core forwards of K8 and K5 on the CPU.

K8-fwd (``point_mlp.classic_pointmlp_fwd``: K1-fwd's tensor-core tile with
the encodings computed in the block) and K5-fwd (``mip_mlp.mip_mlp_fwd``:
K7's tile) run their MLP products as 3xTF32 on the tensor cores
(``csrc/tc_mlp.cuh``, ``csrc/mip_mlp.cuh``'s ``MipTc``), on the weights'
forward operand image.  Here, before any card run, with inputs from numpy
seeds and TF32 off:

* the plain versions with their products emulated as the kernels compute
  them (``matmul=tc_mlp.tc_matmul_autograd``) agree with the JAX
  package's Pallas kernels in interpret mode on small models (hidden 32):
  every output within 1e-4 of the largest entry, the card tests' bound
  (the float32 plain versions are within 1e-5, ``test_torch_pointmlp.py``
  and ``test_torch_mip_kernels.py``; 3xTF32 keeps about 21 bits of each
  product);
* at full width (hidden 256, encodings 60 + 36; the mip model's 96
  features, 5 layers, 54 outputs) the emulated forwards meet the card's
  tolerance against their float32 selves, rtol 1e-4 / atol 1e-4
  (``K1_TOL`` and ``TOL["mip_mlp_fwd"]`` of ``chip_smoke.py``), and the
  emulated K8-fwd is the emulated K1-fwd on the same encodings, bitwise;
* the wrappers check a ``tc_fwd`` given to them (a wrong-sized image
  raises ``ValueError``, nothing counted), and the autograd functions run
  the forward wrapper on the forward image their forward built and hand
  the backward the same one;
* each library's C interface takes as many arguments as ``_build`` binds.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.ops.pallas import fused_mip_mlp, fused_mlp
from nerf_tpu_torch import ClassicNeRFConfig
from nerf_tpu_torch.ops.kernels import _build, classic_mlp, mip_mlp, point_mlp, tc_mlp
from test_torch_input_tc import mip_case, point_case
from test_torch_mip_kernels import setup_model
from test_torch_train_reuse import exact_ln_stats, make_models  # noqa: F401  (autouse fixture)

EMULATED_VS_PALLAS = 1e-4  # of the largest entry
CARD_TOL = dict(rtol=1e-4, atol=1e-4)  # K1_TOL; chip_smoke.py's TOL["mip_mlp_fwd"]


@pytest.fixture(autouse=True)
def no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def assert_within_largest(got: torch.Tensor, want: np.ndarray, what: str):
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got.numpy() / scale, want / scale, rtol=0,
                               atol=EMULATED_VS_PALLAS, err_msg=what)


def test_emulated_pointmlp_fwd_matches_pallas():
    """The emulated K8-fwd against ``classic_pointmlp_pallas`` in
    interpret mode, hidden 32, 300 raw points."""
    jmodel, params, model = make_models(normalize_position=6.0, hidden_size=32)
    cfg = model.cfg
    args = (cfg.x_positional_encoding_size, cfg.normalize_position,
            cfg.d_positional_encoding_size, cfg.direction_bound)
    rng = np.random.default_rng(5)
    pts = rng.uniform(-2, 2, size=(300, 3)).astype(np.float32)
    dirs = rng.normal(size=(300, 3)).astype(np.float32)
    d_jax, c_jax = fused_mlp.classic_pointmlp_pallas(
        params, jnp.asarray(pts), jnp.asarray(dirs), *args, interpret=True)
    packed = classic_mlp.pack_classic_params(model.mlp.requires_grad_(False))
    got = point_mlp.classic_pointmlp_fwd_plain(
        packed, torch.from_numpy(pts), torch.from_numpy(dirs),
        point_mlp.encoding_consts(*args, "cpu"), matmul=tc_mlp.tc_matmul_autograd)
    assert_within_largest(got[:, :1], np.asarray(d_jax), "density")
    assert_within_largest(got[:, 1:], np.asarray(c_jax), "color")


def test_emulated_mip_mlp_fwd_matches_pallas():
    """The emulated K5-fwd against ``mip_mlp_pallas`` in interpret mode on
    the small model of ``test_torch_mip_kernels.py`` (hidden 32, 3 layers,
    24 features, 3 + 5 outputs), 100 rows."""
    cfg, params, packed = setup_model(1)
    feat = np.random.default_rng(6).normal(size=(100, cfg.feature_dim)).astype(np.float32)
    want = fused_mip_mlp.mip_mlp_pallas(params, jnp.asarray(feat), 3, 3, interpret=True)
    got = mip_mlp.mip_mlp_fwd_plain(packed, torch.from_numpy(feat),
                                    matmul=tc_mlp.tc_matmul_autograd)
    for what, w, (lo, hi) in zip(("density", "color", "segmentation"), want,
                                 ((0, 1), (1, 4), (4, cfg.num_outputs))):
        assert_within_largest(got[:, lo:hi], np.asarray(w), what)


def emulated_and_float32(kernel: str):
    """The kernel's plain version at full width on a few hundred rows, with
    the products emulated as 3xTF32 and in float32."""
    if kernel == point_mlp.NAME:
        packed, pts, dirs, consts, _ = point_case(points=300, seed=7)

        def run(matmul):
            return point_mlp.classic_pointmlp_fwd_plain(packed, pts, dirs, consts, matmul)
    else:
        packed, feat, _ = mip_case(rows=300, seed=8)

        def run(matmul):
            return mip_mlp.mip_mlp_fwd_plain(packed, feat, matmul)
    return run(tc_mlp.tc_matmul_autograd), run(torch.matmul)


@pytest.mark.parametrize("kernel", [point_mlp.NAME, mip_mlp.NAME])
def test_emulated_forward_meets_the_card_tolerance_at_full_width(kernel):
    got, ref = emulated_and_float32(kernel)
    assert not torch.equal(got, ref)  # the emulation is not the float32 path
    torch.testing.assert_close(got, ref, **CARD_TOL)


def test_emulated_pointmlp_fwd_is_k1_fwd_on_the_encodings():
    """K8-fwd runs K1-fwd's tile on the sines it computes: the emulated
    versions agree bitwise on the same encodings, at full width."""
    packed, pts, dirs, consts, _ = point_case(points=300, seed=7)
    got = point_mlp.classic_pointmlp_fwd_plain(packed, pts, dirs, consts,
                                               tc_mlp.tc_matmul_autograd)
    x_enc = torch.sin(pts @ consts[0] + consts[1])
    d_enc = torch.sin(dirs @ consts[2] + consts[3])
    assert torch.equal(got, classic_mlp.classic_mlp_fwd_plain(packed, x_enc, d_enc,
                                                              tc_mlp.tc_matmul_autograd))


def forward_call(kernel: str, hidden: int):
    """A K8-fwd or K5-fwd wrapper call on 4 CPU rows at ``hidden``, as a
    function of ``tc_fwd``, with the plain output it must give."""
    if kernel == point_mlp.NAME:
        packed, pts, dirs, consts, _ = point_case(points=4, hidden_size=hidden)
        return packed, (lambda img: point_mlp.classic_pointmlp_fwd(packed, pts, dirs, consts,
                                                                    tc_fwd=img),
                        point_mlp.classic_pointmlp_fwd_plain(packed, pts, dirs, consts))
    packed, feat, _ = mip_case(rows=4, hidden_size=hidden)
    return packed, (lambda img: mip_mlp.mip_mlp_fwd(packed, feat, tc_fwd=img),
                    mip_mlp.mip_mlp_fwd_plain(packed, feat))


@pytest.mark.parametrize("kernel", [point_mlp.NAME, mip_mlp.NAME])
def test_forward_wrappers_check_the_image_they_are_given(kernel):
    """A forward image of other weights (hidden 32 for hidden 64) raises a
    ``ValueError`` naming ``tc_fwd``, with nothing counted; the image of
    these weights is taken, and on the CPU the plain version runs."""
    packed, (call, want) = forward_call(kernel, hidden=64)
    other = forward_call(kernel, hidden=32)[0]
    launches, policies = dict(_build.launch_counts), dict(_build.policy_counts)
    with pytest.raises(ValueError, match="tc_fwd"):
        call(tc_mlp.tc_images(other)[0])
    with pytest.raises(ValueError, match="tc_fwd"):
        call(tc_mlp.tc_images(packed)[0][:-1])
    assert torch.equal(call(tc_mlp.tc_images(packed)[0]), want)
    assert dict(_build.launch_counts) == launches and dict(_build.policy_counts) == policies


def test_autograd_runs_the_forward_on_the_image_it_hands_the_backward(monkeypatch):
    """Under autograd ``classic_pointmlp`` and ``mip_mlp_fwd`` call K8-fwd
    and K5-fwd with ``tc_fwd`` set to the forward image their forward built
    and hand K8-bwd and K5-bwd that very tensor (on the CPU none is built,
    as the plain versions read none; on the card the images, once a step,
    ``tests/test_torch_cuda.py``); the outputs are the plain ones."""
    seen = {}
    for module, name in ((point_mlp, "classic_pointmlp_fwd"), (point_mlp, "classic_pointmlp_bwd"),
                         (mip_mlp, "mip_mlp_fwd"), (mip_mlp, "mip_mlp_bwd")):
        original = getattr(module, name)

        def recording(*args, _original=original, _name=name, **kwargs):
            if "tc_fwd" in kwargs:
                seen.setdefault(_name, []).append(kwargs["tc_fwd"])
            return _original(*args, **kwargs)

        monkeypatch.setattr(module, name, recording)
    cfg = ClassicNeRFConfig(hidden_size=32, normalize_position=6.0)
    packed, pts, dirs, consts, _ = point_case(points=6, hidden_size=32)
    leaves = {k: v.clone().requires_grad_(True) for k, v in packed.items()}
    dens, col = point_mlp.classic_pointmlp(
        leaves, pts, dirs, cfg.x_positional_encoding_size, cfg.normalize_position,
        cfg.d_positional_encoding_size, cfg.direction_bound)
    torch.autograd.grad(col.sum() + dens.sum(), list(leaves.values()))
    mpacked, feat, _ = mip_case(rows=6, hidden_size=32, num_hidden_layers=3, encoding_size=8)
    mleaves = {k: v.clone().requires_grad_(True) for k, v in mpacked.items()}
    out = mip_mlp.mip_mlp_fwd(mleaves, feat)
    torch.autograd.grad(out.sum(), list(mleaves.values()))
    assert {k: len(v) for k, v in seen.items()} == {
        "classic_pointmlp_fwd": 1, "classic_pointmlp_bwd": 1, "mip_mlp_fwd": 1, "mip_mlp_bwd": 1}
    assert seen["classic_pointmlp_fwd"][0] is seen["classic_pointmlp_bwd"][0]
    assert seen["mip_mlp_fwd"][0] is seen["mip_mlp_bwd"][0]
    assert torch.equal(torch.cat([dens, col], -1).detach(),
                       point_mlp.classic_pointmlp_fwd_plain(packed, pts, dirs, consts))
    assert torch.equal(out.detach(), mip_mlp.mip_mlp_fwd_plain(mpacked, feat))


def c_parameter_count(function: str) -> int:
    """The parameters of ``extern "C" int <function>(...)`` in the library's
    source under ``csrc/``."""
    for src in _build.CSRC.glob("*.cu"):
        m = re.search(rf'extern "C" int {function}\(([^)]*)\)', src.read_text())
        if m:
            return len(m.group(1).split(","))
    raise AssertionError(f"no extern \"C\" {function} under {_build.CSRC}")


@pytest.mark.parametrize("function", ["classic_pointmlp_fwd", "union_eval_blocks",
                                      "mip_mlp_fwd", "mip_eval",
                                      "classic_mlp_bwd", "train_grads", "fine_stage_train",
                                      "mip_mlp_bwd", "mip_train_grads", "classic_pointmlp_bwd",
                                      "mega_train"])
def test_c_interfaces_take_what_the_build_binds(function):
    """``_build`` binds each new or changed C function with as many
    argument types as its source declares (ctypes would pass a missing
    ``tc_fwd`` as the stream) and loads it, K4's block count
    (``union_eval_blocks``, which sizes its wide scratch) beside its
    kernel; no library exports a plan."""
    assert len(_build.ARGTYPES[function]) == c_parameter_count(function)
    name = function.removesuffix("_blocks")
    assert function in _build.FUNCTIONS[name]
    assert not any(fn.endswith("_plan") for fn in _build.FUNCTIONS[name])


CLASSIC_KERNELS = ("classic_mlp_fwd", "union_eval", "classic_mlp_bwd", "train_grads",
                   "fine_stage_train", "classic_pointmlp_fwd", "classic_pointmlp_bwd",
                   "mega_train")


@pytest.mark.parametrize("name", CLASSIC_KERNELS)
def test_classic_kernels_have_no_plan(name):
    """The classic kernels' one tile takes the same bytes at every encoding
    width, so no classic library exports a plan and no wrapper asks one."""
    assert f"{name}_plan" not in _build.ARGTYPES
    assert f"{name}_plan" not in _build.FUNCTIONS[name]
    assert f'extern "C" int {name}_plan(' not in (_build.CSRC / f"{name}.cu").read_text()
