"""The port's tensor parallelism (``nerf_tpu_torch/parallel/tensor_parallel.py``)
held against the JAX package's ``make_tp_render_rays`` and
``make_tp_train_step`` on ``make_mesh_2d(..., second_axis="model")`` and
against the port's own single-process step.

Real processes over gloo on the CPU: two ranks (a 1x2 batch x model mesh)
and four (2x2) run ``torch_mesh_worker.py``, which imports no JAX and
writes ``.npz`` files (a sharded tensor as its rank's slice); this process
runs the JAX side on its 8 virtual CPU devices while they run, then
compares:

* the renders of ``TP_RENDERS`` (classic, hierarchical, mip) within rtol
  1e-5, atol 1e-6 (``tests/test_tensor_parallel.py``'s tolerances), the
  JAX weights in the port's model;
* the loss and gradients of ``TP_STEPS`` (the classic reuse step and the
  mip step, stratified draws, density noise 0.5) against the
  single-process plain step on the same global batch and draws: the loss
  within rtol 1e-5, each gradient (the ranks' slices put together) within
  relative L2 1e-4, and the gradients' global norm;
* one SGD step (lr 0.1): the loss within rtol 1e-5 of JAX's and the update
  within relative L2 5e-3 of JAX's by tensor (JAX's own float32 gradients
  sit up to 1.9e-3 from float64 at these sizes).

In one process: the specs against JAX's (classic with and without the
view branch, mip), ``shard_params`` at one shard equal to the model, and
the refusals (a ``use_pallas`` model, an unsharded model in the step).
Models are small (hidden 32).
"""

import os

import jax
import numpy as np
import optax
import pytest
import torch

from nerf_tpu import ClassicNeRF as JaxNeRF
from nerf_tpu import ClassicNeRFConfig as JaxConfig
from nerf_tpu import MipNeRF as JaxMip
from nerf_tpu import MipNeRFConfig as JaxMipConfig
from nerf_tpu import RenderConfig as JaxRender
from nerf_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from nerf_tpu.parallel import shard_batch as jax_shard_batch
from nerf_tpu.parallel import tensor_parallel as jtp
from nerf_tpu.train import create_train_state as jax_create_state
from nerf_tpu_torch import ClassicNeRF, ClassicNeRFConfig, MipNeRF, MipNeRFConfig, RenderConfig
from nerf_tpu_torch.parallel import (
    classic_param_specs,
    initialize,
    make_mesh_2d,
    make_tp_render_rays,
    make_tp_train_step,
    mip_param_specs,
    param_specs_for,
    prepare_tp_state,
    shard_params,
    shutdown,
)
from nerf_tpu_torch.train import checkpoint, create_train_state, make_loss_fn
from nerf_tpu_torch.utils.pth_import import (
    classic_state_dict_from_jax_params,
    mip_state_dict_from_jax_params,
)
from test_torch_sample_parallel import finish_ranks, jax_inputs, rel_l2, start_ranks
from torch_mesh_worker import (
    LR,
    MESHES,
    MIP,
    TINY,
    TP_RENDERS,
    TP_SGD,
    TP_STEPS,
    scene_bank,
    train_inputs,
    train_model,
)

PHASES = {"tp2": 2, "tp4": 4}
SHAPES = [shape for phase in PHASES for shape in MESHES[phase]]


def tp_inputs():
    """The sample-parallel test's inputs, the JAX mip model's weights
    beside them."""
    model, params, rays, inputs = jax_inputs()
    mip = JaxMip(JaxMipConfig(**MIP))
    mip_params = jax.tree_util.tree_map(np.asarray, mip.init(jax.random.PRNGKey(0)))
    inputs.update({f"mip_sd/{k}": v.numpy()
                   for k, v in mip_state_dict_from_jax_params(mip_params).items()})
    return {"classic": (model, params), "mip": (mip, mip_params)}, rays, inputs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("tp")
    models, rays, inputs = tp_inputs()
    np.savez(work / "inputs.npz", **inputs)
    procs = {phase: start_ranks(work, phase, world) for phase, world in PHASES.items()}
    want = {}
    try:
        # JAX's renders and SGD steps while the ranks run.
        for b, m in SHAPES:
            mesh = jax_make_mesh_2d(b, m, second_axis="model")
            for case, (family, kwargs) in TP_RENDERS.items():
                model, params = models[family]
                want[f"{b}x{m}", case] = np.asarray(jtp.make_tp_render_rays(
                    model, JaxRender(**kwargs), mesh)(jtp.shard_params(params, model, mesh),
                                                      rays["rays_o"], rays["rays_d"]))
            model, params = models["classic"]
            opt = optax.sgd(LR)
            state = jtp.prepare_tp_state(jax_create_state(params, opt), model, mesh)
            new, aux = jtp.make_tp_train_step(model, opt, JaxRender(**TP_SGD), mesh, donate=False)(
                state, jax_shard_batch(rays, mesh))
            want[f"{b}x{m}", "sgd"] = (float(aux["loss"]), jax.device_get(new.params))
    finally:
        outs = {phase: finish_ranks(work, phase, p) for phase, p in procs.items()}
    ranks = {f"{b}x{m}": outs[phase] for phase in PHASES for b, m in MESHES[phase]}
    return dict(jax=want, ranks=ranks, params=models["classic"][1])


def put_together(outs, prefix, full: dict, model_size: int, batch_index: int = 0) -> dict:
    """The whole tensors from the ranks' slices (``prefix + name``) along
    one batch index: a slice is split along the one dim where its shape
    differs from the whole tensor's, over the model axis's ranks in order;
    a slice of the whole shape is replicated (every rank's must agree)."""
    ranks = outs[batch_index * model_size:(batch_index + 1) * model_size]
    got = {}
    for name, whole in full.items():
        parts = [out[prefix + name] for out in ranks]
        split = [d for d, (a, b) in enumerate(zip(parts[0].shape, whole.shape)) if a != b]
        if not split:
            for part in parts[1:]:
                np.testing.assert_array_equal(part, parts[0], err_msg=name)
            got[name] = parts[0]
        else:
            got[name] = np.concatenate(parts, axis=split[0])
        assert got[name].shape == tuple(whole.shape), name
    return got


@pytest.mark.parametrize("case", sorted(TP_RENDERS))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tensor_parallel_render_matches_jax(runs, shape, case):
    tag = f"{shape[0]}x{shape[1]}"
    want = runs["jax"][tag, case]
    assert want.shape == (64, 3)
    outs = runs["ranks"][tag]
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[f"{tag}/render/{case}"], want, rtol=1e-5, atol=1e-6,
                                   err_msg=f"rank {r}")


def single_process(case):
    family, kwargs = TP_STEPS[case]
    render = RenderConfig(**kwargs)
    model = train_model(family)
    batch, draws = train_inputs(model, render, scene_bank())
    names, params = zip(*model.mlp.named_parameters())
    with torch.enable_grad():
        loss, _ = make_loss_fn(model, render)(batch, draws)
    grads = torch.autograd.grad(loss, params)
    return float(loss.detach()), {k: g.numpy() for k, g in zip(names, grads)}


@pytest.mark.parametrize("case", sorted(TP_STEPS))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tensor_parallel_step_matches_single_process(runs, shape, case):
    tag = f"{shape[0]}x{shape[1]}"
    loss, grads = single_process(case)
    outs = runs["ranks"][tag]
    norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in grads.values()))
    for r, out in enumerate(outs):
        np.testing.assert_allclose(float(out[f"{tag}/{case}/loss"]), loss, rtol=1e-5,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(float(out[f"{tag}/{case}/grad_norm"]), norm, rtol=1e-4)
    for b in range(shape[0]):
        got = put_together(outs, f"{tag}/{case}/grad/mlp.", grads, shape[1], b)
        for name, g in grads.items():
            assert rel_l2(got[name], g) <= 1e-4, (b, name, rel_l2(got[name], g))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tensor_parallel_sgd_step_matches_jax(runs, shape):
    tag = f"{shape[0]}x{shape[1]}"
    jax_loss, jax_params = runs["jax"][tag, "sgd"]
    before = classic_state_dict_from_jax_params(runs["params"])
    after = classic_state_dict_from_jax_params(jax_params)
    outs = runs["ranks"][tag]
    for out in outs:
        np.testing.assert_allclose(float(out[f"{tag}/sgd/loss"]), jax_loss, rtol=1e-5)
    for b in range(shape[0]):
        got = put_together(outs, f"{tag}/sgd/weights/", before, shape[1], b)
        for name, w0 in before.items():
            update, jax_update = (w0.numpy() - got[name]) / LR, (w0 - after[name]).numpy() / LR
            assert rel_l2(update, jax_update) <= 5e-3, (b, name, rel_l2(update, jax_update))


# -- in one process -----------------------------------------------------------------


@pytest.fixture
def mesh(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    initialize(device="cpu", timeout_s=60.0)
    try:
        yield make_mesh_2d(1, 1, second_axis="model")
    finally:
        shutdown()


def leaves(tree):
    """``(path, leaf)`` pairs with the JAX package's specs as leaves."""
    return list(checkpoint._flatten(jax.tree_util.tree_map(
        tuple, tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))))


@pytest.mark.parametrize("family", ["classic", "classic_no_view", "mip"])
def test_specs_mirror_the_jax_tree(family):
    if family == "mip":
        cfg, jax_cfg = MipNeRFConfig(**MIP), JaxMipConfig(**MIP)
        got, want = mip_param_specs(cfg), jtp.mip_param_specs(jax_cfg)
        params = JaxMip(jax_cfg).init(jax.random.PRNGKey(0))
        model = MipNeRF(cfg, device="cpu")
    else:
        view = dict(use_viewdirs=family == "classic")
        cfg, jax_cfg = ClassicNeRFConfig(**TINY, **view), JaxConfig(**TINY, **view)
        got, want = classic_param_specs(cfg), jtp.classic_param_specs(jax_cfg)
        params = JaxNeRF(jax_cfg).init(jax.random.PRNGKey(0))
        model = ClassicNeRF(cfg, device="cpu")
    assert got == param_specs_for(model)
    assert [p for p, _ in checkpoint._flatten(got)] == [
        p for p, _ in checkpoint._flatten(jax.tree_util.tree_map(np.asarray, params))]
    assert leaves(want) == list(checkpoint._flatten(got))


@pytest.mark.parametrize("family", ["classic", "mip"])
def test_shard_params_at_one_shard_is_the_model(mesh, family):
    model = train_model(family)
    state = create_train_state(model, 1e-3)
    sharded = prepare_tp_state(state, mesh)
    assert sharded.model is not model and sharded.model.mlp is not model.mlp
    want, got = model.mlp.state_dict(), sharded.model.mlp.state_dict()
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    render = RenderConfig(num_coarse_samples=8, randomly_sample=False, density_noise_std=0.0)
    rays = scene_bank().gather(torch.arange(16))
    out = make_tp_render_rays(sharded.model, render, mesh)(rays["rays_o"], rays["rays_d"])
    plain = model.render_rays(rays["rays_o"], rays["rays_d"], render).rgb[..., -1, :]
    torch.testing.assert_close(out, plain, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(shard_params(model, mesh).mlp.state_dict(), got, rtol=0, atol=0)


def test_tensor_parallel_refuses_kernel_models_and_unsharded_steps(mesh):
    render = RenderConfig(num_coarse_samples=8)
    kernel = train_model("classic", use_pallas=True)
    for call in (lambda: shard_params(kernel, mesh),
                 lambda: make_tp_render_rays(kernel, render, mesh),
                 lambda: make_tp_train_step(kernel, render, mesh)):
        with pytest.raises(ValueError, match="use_pallas=False"):
            call()
    with pytest.raises(ValueError, match="prepare_tp_state"):
        make_tp_train_step(train_model("classic"), render, mesh)
    sharded = shard_params(train_model("classic"), mesh)
    with pytest.raises(ValueError, match="already tensor parallel"):
        shard_params(sharded, mesh)
    with pytest.raises(ValueError, match="no 'model' axis"):
        shard_params(train_model("classic"), make_mesh_2d(1, 1))
