"""The port's data parallelism (``nerf_tpu_torch/parallel``) in one process,
a gloo group of one on the CPU, held against the JAX package's helpers'
contracts (``tests/test_parallel.py``) and against the port's own
single-process path: ``initialize`` with and without torchrun's
environment, a missing GPU refused, ``make_mesh`` asked for too many
ranks, ``shard_batch`` and ``host_local_slice``, ``collective_barrier``;
the data-parallel steps at one rank (the general path, and the fused
reuse, coarse-only and mip steps on the kernels' plain versions) bitwise
the single-process steps; ``replicate`` at one rank changing no bit;
``Trainer(mesh=...)`` over 6 steps with a checkpoint at 3 bitwise
``Trainer()``; ``render_image_sharded`` at one rank against
``render_image``.

Two ranks, and the comparison with JAX's 2-device mesh:
``test_torch_multiprocess.py``.  Models are small (hidden 32; the mip
model hidden 32, 3 layers, 24 IPE features, 5 classes).
"""

import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from nerf_tpu_torch import (
    ClassicNeRF,
    ClassicNeRFConfig,
    MipNeRF,
    MipNeRFConfig,
    RenderConfig,
    TrainConfig,
)
from nerf_tpu_torch.data import RayBank, synthesize_scene
from nerf_tpu_torch.parallel import (
    Mesh,
    collective_barrier,
    distributed,
    host_local_slice,
    initialize,
    is_coordinator,
    make_mesh,
    make_parallel_multi_step_train_fn,
    make_parallel_train_step,
    prepare_parallel_state,
    render_image_sharded,
    shard_batch,
    shutdown,
)
from nerf_tpu_torch.train import Trainer, checkpoint, create_train_state, make_train_step
from nerf_tpu_torch.train.loop import make_fused_multi_step_train_fn, make_multi_step_train_fn

CLASSIC = dict(hidden_size=32, normalize_position=6.0)
MIP = dict(hidden_size=32, num_hidden_layers=3, encoding_size=8, segmentation_outputs=5)
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture
def no_torchrun_env(monkeypatch):
    for name in TORCHRUN_ENV:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture
def mesh(no_torchrun_env):
    initialize(device="cpu", timeout_s=60.0)
    try:
        yield make_mesh()
    finally:
        shutdown()


@pytest.fixture(scope="module")
def scene():
    return synthesize_scene(num_views=3, image_hw=12, focal=15.0, num_samples=96,
                            with_labels=True, device="cpu")


def bank_of(scene, labels=False):
    return RayBank.from_images(scene.images, scene.pose_o, scene.pose_r, scene.focal,
                               labels=scene.labels if labels else None)


def model_of(family, use_pallas=False, seed=0):
    gen = torch.Generator().manual_seed(seed)
    if family == "mip":
        return MipNeRF(MipNeRFConfig(**MIP, use_pallas=use_pallas), generator=gen, device="cpu")
    return ClassicNeRF(ClassicNeRFConfig(**CLASSIC, use_pallas=use_pallas), generator=gen,
                       device="cpu")


# -- process groups and the mesh ---------------------------------------------------


def test_initialize_without_torchrun_builds_a_group_of_one(no_torchrun_env):
    device = initialize(device="cpu", timeout_s=60.0)
    try:
        assert device == torch.device("cpu") and distributed.group_device() == device
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert is_coordinator()
        collective_barrier()
        with pytest.raises(RuntimeError, match="already initialized"):
            initialize(device="cpu")
    finally:
        shutdown()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        distributed.group_device()


def test_initialize_reads_torchrun_environment(monkeypatch):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port))
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    initialize(device="cpu", timeout_s=60.0)
    try:
        assert dist.get_rank() == 0 and dist.get_world_size() == 1
        collective_barrier()
    finally:
        shutdown()


def test_initialize_refuses_a_missing_gpu(no_torchrun_env):
    missing = f"cuda:{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
    with pytest.raises(RuntimeError, match="GPU"):
        initialize(device=missing)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="init_method"):
        initialize(device="cpu", world_size=2, rank=0)


def test_make_mesh_refuses_too_many_ranks(mesh):
    assert (mesh.rank, mesh.size, mesh.axis_name) == (0, 1, "batch")
    assert make_mesh(num_devices=1) == mesh
    with pytest.raises(ValueError, match="requested 64 ranks, the group has 1"):
        make_mesh(num_devices=64)


def test_shard_batch_and_host_local_slice(mesh):
    batch = {"rays_o": torch.arange(18.0).reshape(6, 3), "pixels": torch.zeros(6, 3)}
    assert all(torch.equal(v, batch[k]) for k, v in shard_batch(batch, mesh).items())
    third = Mesh(group=None, rank=1, size=3, device=torch.device("cpu"))
    assert torch.equal(shard_batch(batch, third)["rays_o"], batch["rays_o"][2:4])
    with pytest.raises(ValueError, match="divide"):
        shard_batch({k: v[:5] for k, v in batch.items()}, third)
    with pytest.raises(ValueError, match="disagree"):
        shard_batch({"rays_o": batch["rays_o"], "pixels": batch["pixels"][:3]}, third)
    assert host_local_slice(1000, 256) == slice(0, 256)


# -- the data-parallel steps at one rank -----------------------------------------

STEP_CASES = {
    "general": ("classic", False, RenderConfig(num_coarse_samples=8, num_fine_samples=8,
                                               density_noise_std=0.5), 0.0),
    "fused_reuse": ("classic", True, RenderConfig(num_coarse_samples=8, num_fine_samples=8,
                                                  density_noise_std=0.5), 0.0),
    "fused_coarse": ("classic", True, RenderConfig(num_coarse_samples=8,
                                                   density_noise_std=0.5), 0.0),
    "fused_mip": ("mip", True, RenderConfig(num_coarse_samples=8, density_noise_std=0.5), 0.1),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_parallel_steps_at_one_rank_are_the_single_process_steps(mesh, scene, case):
    family, fused, render, seg = STEP_CASES[case]
    bank = bank_of(scene, labels=family == "mip")
    single = create_train_state(model_of(family, fused), 1e-3, seed=3)
    sharded = prepare_parallel_state(create_train_state(model_of(family, fused), 1e-3, seed=3),
                                     mesh)
    maker = make_fused_multi_step_train_fn if fused else make_multi_step_train_fn
    _, want = maker(single.model, render, bank, 32, 3, seg)(single)
    _, got = make_parallel_multi_step_train_fn(sharded.model, render, bank, 32, mesh, 3, seg,
                                               fused=fused)(sharded)
    assert sharded.step == single.step == 3
    for key in want:
        assert torch.equal(got[key], want[key]), key
    for (name, p), q in zip(single.model.named_parameters(), sharded.model.parameters()):
        assert torch.equal(p, q), name
    for p, q in zip(single.model.parameters(), sharded.model.parameters()):
        a, b = single.optimizer.state[p], sharded.optimizer.state[q]
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"]) and int(a["step"]) == int(b["step"])


def test_parallel_train_step_on_a_sharded_batch(mesh, scene):
    # A given batch (shard_batch) and no draws: the global batch's draws
    # from step_generator, as make_train_step makes them.
    render = STEP_CASES["general"][2]
    batch = bank_of(scene).gather(torch.arange(40))
    single = create_train_state(model_of("classic"), 1e-3, seed=5)
    sharded = create_train_state(model_of("classic"), 1e-3, seed=5)
    want = make_train_step(single.model, render)(single, batch)
    got = make_parallel_train_step(sharded.model, render, mesh)(sharded, shard_batch(batch, mesh))
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert all(torch.equal(p, q) for p, q in zip(single.model.parameters(),
                                                 sharded.model.parameters()))


def test_replicate_at_one_rank_keeps_the_state(mesh, scene):
    # After two steps (Adam's moments and count set), replicating over a
    # mesh of one changes no bit, and the next step is the same.
    render = STEP_CASES["general"][2]
    bank = bank_of(scene)
    states = [create_train_state(model_of("classic"), 1e-3, seed=9) for _ in range(2)]
    for state in states:
        make_multi_step_train_fn(state.model, render, bank, 16, 2)(state)
    count, mu, nu = checkpoint.adam_state(states[1])
    assert prepare_parallel_state(states[1], mesh) is states[1]
    assert (states[1].step, states[1].seed) == (2, 9)
    got = checkpoint.adam_state(states[1])
    assert got[0] == count == 2
    assert all(torch.equal(got[1][k], mu[k]) and torch.equal(got[2][k], nu[k]) for k in mu)
    for state in states:
        make_multi_step_train_fn(state.model, render, bank, 16, 1)(state)
    assert all(torch.equal(p, q) for p, q in zip(states[0].model.parameters(),
                                                 states[1].model.parameters()))


def test_trainer_with_a_mesh_at_one_rank_is_the_plain_trainer(mesh, scene, tmp_path):
    render = RenderConfig(num_coarse_samples=8, num_fine_samples=8, density_noise_std=0.5)
    cfg = TrainConfig(batch_size=32, learning_rate=1e-3, num_steps=6, log_interval=3,
                      eval_interval=3, checkpoint_interval=3, seed=2)
    bank = bank_of(scene)
    runs = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        trainer = Trainer(model_of("classic", True), render, cfg,
                          logging_dir=str(tmp_path / name), mesh=m)
        trainer.fit(bank, eval_scene=scene)
        runs[name] = trainer
    for step in (3, 6):
        with np.load(tmp_path / "plain" / f"checkpoint_{step}.npz") as a, \
                np.load(tmp_path / "mesh" / f"checkpoint_{step}.npz") as b:
            assert a.files == b.files
            for key in a.files:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    strip = [{k: v for k, v in r.items() if k not in ("wall_s", "rays_per_s")}
             for r in runs["mesh"].metrics.history]
    assert strip == [{k: v for k, v in r.items() if k not in ("wall_s", "rays_per_s")}
                     for r in runs["plain"].metrics.history]
    assert [r["step"] for r in strip] == [3, 6] and "psnr" in strip[-1]
    assert os.path.exists(tmp_path / "mesh" / "heartbeats" / "proc_0.json")


@pytest.mark.parametrize("family", ["classic", "mip"])
def test_render_image_sharded_at_one_rank(mesh, scene, family):
    model = model_of(family)
    render = RenderConfig(num_coarse_samples=8, num_fine_samples=8 if family == "classic" else 0,
                          randomly_sample=False, density_noise_std=0.0, rays_per_tile=16)
    got = render_image_sharded(model, mesh, scene.pose_o[:1], scene.pose_r[:1], 7, 5,
                               scene.focal, render)
    want = model.render_image(scene.pose_o[:1], scene.pose_r[:1], 7, 5, scene.focal, render)
    if family == "mip":
        want = torch.cat(want, dim=-1)
    assert got.shape == want.shape == (1, 7, 5, want.shape[-1])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
