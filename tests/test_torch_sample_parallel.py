"""The port's sample parallelism (``nerf_tpu_torch/parallel/sample_parallel.py``)
held against the JAX package's ``make_sample_parallel_render`` on
``make_mesh_2d`` and against the port's own single-process step.

Real processes over gloo on the CPU: two ranks (meshes 1x2 and 2x1, batch
x sample) and four (2x2) run ``torch_mesh_worker.py``, which imports no
JAX and writes ``.npz`` files; this process runs the JAX side on its 8
virtual CPU devices while they run, then compares:

* the renders of ``RENDERS`` (coarse-only and re-evaluate within rtol 1e-5,
  atol 1e-6; reuse with and without a white background within rtol 1e-4,
  atol 1e-5: ``tests/test_sample_parallel.py``'s tolerances), the JAX
  weights and frequency constants in the port's model;
* the sample-parallel loss and gradients of the reuse and re-evaluate
  steps (stratified draws, density noise 0.5, the kernels' plain versions)
  against the single-process autograd step on the same global batch and
  draws: the loss within rtol 1e-5 and each gradient within relative L2
  1e-4; and each gradient no farther from a float64 evaluation of that
  step (with the float32 step's fine samples) than the float32 step is,
  plus 1e-4.  The float32 step itself sits up to 1.5e-3 from float64 on
  these draws: its compositing's ``1 - exp(-sigma * delta)`` loses digits
  where the product is small (the MLP in float32 and the rest in float64
  lands within 2e-6 of float64), in both packages;
* every rank's weights bitwise equal after 3 Adam steps.

In one process, a gloo group of one: ``make_mesh_2d`` refusing a shape
that is not the group's, ``flat_collective`` along an axis and refusing
an unknown op before it packs anything, and the sample-parallel path
refusing a sample count that does not divide and a ``MipNeRF``.  Models are small (hidden
32).
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from nerf_tpu import ClassicNeRF as JaxNeRF
from nerf_tpu import ClassicNeRFConfig as JaxConfig
from nerf_tpu import RenderConfig as JaxRender
from nerf_tpu.data import RayBank as JaxBank
from nerf_tpu.data import synthesize_scene as jax_scene
from nerf_tpu.ops import encoding as jenc
from nerf_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from nerf_tpu.parallel import make_sample_parallel_render as jax_sp_render
from nerf_tpu_torch import ClassicNeRFConfig, MipNeRF, MipNeRFConfig, RenderConfig
from nerf_tpu_torch.ops import sampling
from nerf_tpu_torch.parallel import (
    Mesh,
    initialize,
    make_mesh_2d,
    make_sample_parallel_loss_and_grads,
    make_sample_parallel_render,
    shutdown,
)
from nerf_tpu_torch.parallel.mesh import Axis, flat_collective
from nerf_tpu_torch.train import make_loss_fn
from nerf_tpu_torch.utils.pth_import import classic_state_dict_from_jax_params
from torch_mesh_worker import MESHES, RENDERS, SP_STEPS, TINY, scene_bank, train_inputs, train_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_mesh_worker.py")
PHASES = {"sp2": 2, "sp4": 4}
MESH_TAGS = [f"{b}x{s}" for phase in PHASES for b, s in MESHES[phase]]
RENDER_TOL = {"coarse": dict(rtol=1e-5, atol=1e-6), "reevaluate": dict(rtol=1e-5, atol=1e-6),
              "reuse": dict(rtol=1e-4, atol=1e-5), "reuse_white": dict(rtol=1e-4, atol=1e-5)}


def jax_inputs():
    """JAX's tiny model (``tests/test_sample_parallel.py``'s), its weights
    with the density head biased positive, its frequency constants and 64
    rays."""
    model = JaxNeRF(JaxConfig(**TINY))
    params = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(0)))
    params["density"] = {"w": params["density"]["w"] * np.float32(0.05),
                         "b": np.full_like(params["density"]["b"], 0.5)}
    scene = jax_scene(num_views=3, image_hw=16, focal=20.0, num_samples=128)
    bank = JaxBank.from_images(scene.images, scene.pose_o, scene.pose_r, scene.focal)
    rays = {k: np.asarray(v) for k, v in bank.gather(np.arange(64)).items()}
    cfg = ClassicNeRFConfig(**TINY)
    inputs = dict(
        x_scales=jenc.frequency_scales_np(cfg.x_positional_encoding_size,
                                          cfg.normalize_position).astype(np.float32),
        d_scales=jenc.frequency_scales_np(cfg.d_positional_encoding_size,
                                          cfg.direction_bound).astype(np.float32),
        **rays,
    )
    inputs.update({f"sd/{k}": v.numpy()
                   for k, v in classic_state_dict_from_jax_params(params).items()})
    return model, params, rays, inputs


def start_ranks(work, phase, world):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    store = f"file://{work}/store_{phase}"
    return [subprocess.Popen([sys.executable, WORKER, str(r), str(world), store, str(work), phase],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
            for r in range(world)]


def finish_ranks(work, phase, procs):
    try:
        outs = [p.communicate(timeout=240)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} ({phase}):\n{out[-3000:]}"
    return [dict(np.load(work / f"rank{r}_{phase}.npz")) for r in range(len(procs))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("sp")
    model, params, rays, inputs = jax_inputs()
    np.savez(work / "inputs.npz", **inputs)
    procs = {phase: start_ranks(work, phase, world) for phase, world in PHASES.items()}
    try:
        # JAX's renders while the ranks run.
        want = {}
        for phase in PHASES:
            for b, s in MESHES[phase]:
                mesh = jax_make_mesh_2d(b, s)
                for case, kwargs in RENDERS.items():
                    want[f"{b}x{s}", case] = np.asarray(jax_sp_render(
                        model, JaxRender(**kwargs), mesh)(params, rays["rays_o"], rays["rays_d"]))
    finally:
        outs = {phase: finish_ranks(work, phase, p) for phase, p in procs.items()}
    by_mesh = {f"{b}x{s}": outs[phase] for phase in PHASES for b, s in MESHES[phase]}
    return dict(jax=want, ranks=by_mesh)


@pytest.mark.parametrize("case", sorted(RENDERS))
@pytest.mark.parametrize("tag", MESH_TAGS)
def test_sample_parallel_render_matches_jax(runs, tag, case):
    want = runs["jax"][tag, case]
    assert want.shape == (64, 3)
    outs = runs["ranks"][tag]
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[f"{tag}/render/{case}"], want, **RENDER_TOL[case],
                                   err_msg=f"rank {r}")
        np.testing.assert_array_equal(out[f"{tag}/render/{case}"], outs[0][f"{tag}/render/{case}"])


def rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def single_process(case, fine=None):
    """The single-process autograd step of ``case`` on the workers' global
    batch and draws: ``(loss, {name: gradient}, fine samples)``.  With
    ``fine``, the fine samples of the float32 step, in float64: the
    resample is a step function of the coarse weights' rounding, so the
    float64 evaluation keeps the float32 step's samples."""
    render = RenderConfig(**SP_STEPS[case])
    model = train_model("classic", use_pallas=fine is None)
    batch, draws = train_inputs(model, render, scene_bank())
    resampled = []
    sample_pdf = sampling.sample_pdf

    def recording(*args, **kwargs):
        resampled.append(sample_pdf(*args, **kwargs) if fine is None else fine.double())
        return resampled[-1]

    if fine is not None:
        model = model.double()
        batch = {k: v.double() for k, v in batch.items()}
        draws = sampling.StepDraws(*(None if d is None else d.double() for d in draws))
    names, params = zip(*model.named_parameters())
    sampling.sample_pdf = recording
    try:
        with torch.enable_grad():
            loss, _ = make_loss_fn(model, render)(batch, draws)
    finally:
        sampling.sample_pdf = sample_pdf
    grads = torch.autograd.grad(loss, params)
    return float(loss.detach()), {k: g.numpy() for k, g in zip(names, grads)}, resampled[0].detach()


@pytest.fixture(scope="module")
def references():
    out = {}
    for case in SP_STEPS:
        loss, grads, fine = single_process(case)
        out[case] = (loss, grads, single_process(case, fine)[1])
    return out


@pytest.mark.parametrize("case", sorted(SP_STEPS))
@pytest.mark.parametrize("tag", MESH_TAGS)
def test_sample_parallel_step_matches_single_process(runs, references, tag, case):
    loss, grads, grads64 = references[case]
    for r, out in enumerate(runs["ranks"][tag]):
        np.testing.assert_allclose(float(out[f"{tag}/{case}/loss"]), loss, rtol=1e-5,
                                   err_msg=f"rank {r}")
        for name, g in grads.items():
            got = out[f"{tag}/{case}/grad/{name}"]
            assert rel_l2(got, g) <= 1e-4, (r, name, rel_l2(got, g))
            to64 = rel_l2(got, grads64[name])
            assert to64 <= rel_l2(g, grads64[name]) + 1e-4, (r, name, "float64", to64)


@pytest.mark.parametrize("case", sorted(SP_STEPS))
@pytest.mark.parametrize("tag", MESH_TAGS)
def test_sample_parallel_ranks_stay_bitwise_equal(runs, tag, case):
    outs = runs["ranks"][tag]
    assert np.all(np.isfinite(outs[0][f"{tag}/{case}/losses"]))
    for out in outs[1:]:
        for key in (f"{tag}/{case}/losses", f"{tag}/{case}/weights"):
            np.testing.assert_array_equal(out[key], outs[0][key], err_msg=key)


# -- in one process -----------------------------------------------------------------


@pytest.fixture
def group_of_one(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    initialize(device="cpu", timeout_s=60.0)
    try:
        yield
    finally:
        shutdown()


def test_make_mesh_2d_refuses_a_shape_that_is_not_the_group(group_of_one):
    mesh = make_mesh_2d(1, 1)
    assert mesh.axis_names == ("batch", "sample") and mesh.shape == {"batch": 1, "sample": 1}
    assert make_mesh_2d(1, 1, second_axis="model").axis_names == ("batch", "model")
    for shape in ((2, 1), (1, 2), (0, 1)):
        with pytest.raises(ValueError, match="the group has 1"):
            make_mesh_2d(*shape)


def test_flat_collective_takes_an_axis_and_refuses_an_unknown_op_first(group_of_one):
    mesh = make_mesh_2d(1, 1)
    t = torch.arange(6.0).reshape(2, 3).t()  # a transposed tensor keeps its strides
    for axis in (None, "batch", "sample"):
        (got,) = flat_collective([t], mesh, "mean", axis=axis)
        assert torch.equal(got, t) and got.stride() == t.stride()
    with pytest.raises(ValueError, match="unknown collective 'max'"):
        flat_collective([None], mesh, "max")  # refused before any packing
    with pytest.raises(ValueError, match="no 'model' axis"):
        flat_collective([t], mesh, "sum", axis="model")


def test_sample_parallel_refuses_indivisible_counts_and_the_mip_family():
    # A 2 x 4 mesh as rank 5 sees it: the refusals come before any collective.
    mesh = Mesh(group=None, rank=5, size=8, device=torch.device("cpu"),
                grid=(Axis("batch", 2, 1, None), Axis("sample", 4, 1, None)))
    model = train_model("classic")
    for kwargs in (dict(num_coarse_samples=10), dict(num_coarse_samples=8, num_fine_samples=6),
                   dict(num_coarse_samples=8, num_fine_samples=6, reuse_coarse_in_fine=False)):
        with pytest.raises(ValueError, match="not divisible by 4 sample shards"):
            make_sample_parallel_render(model, RenderConfig(**kwargs), mesh)
    make_sample_parallel_loss_and_grads(model, RenderConfig(num_coarse_samples=8,
                                                            num_fine_samples=4), mesh)
    mip = MipNeRF(MipNeRFConfig(hidden_size=32, num_hidden_layers=3, encoding_size=8), device="cpu")
    with pytest.raises(TypeError, match="data-parallel"):
        make_sample_parallel_loss_and_grads(mip, RenderConfig(num_coarse_samples=8), mesh)
    with pytest.raises(ValueError, match="no 'sample' axis"):
        make_sample_parallel_render(model, RenderConfig(num_coarse_samples=8),
                                    Mesh(group=None, rank=0, size=1, device=torch.device("cpu")))
