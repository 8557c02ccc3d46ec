"""The port's checkpoints (``nerf_tpu_torch/train/checkpoint.py``) held
against the JAX package's on the CPU: the round trip, a structure or
shape mismatch that fails loudly, retention, a resumed run that continues
the straight one, files of either package restored by the other for both
model families (names, dtypes, shapes and values equal), JAX's sharded
layout (replicated and split leaves) restored as its single-file layout
is, a sharded manifest with missing, uncovered or foreign leaves refused,
the ``.pth`` export bitwise the JAX one's, and the
``Trainer``'s checkpoints, metrics and resume.

Models are small (hidden 32; the mip model hidden 32, 3 layers, 24 IPE
features, 5 classes), except the full-width ``.pth`` export.  Resumed
runs are held to atol 1e-6, the bound ``tests/test_train.py`` holds JAX's
resume to; one step after a cross-package restore to
``test_torch_train.py::test_make_train_step_matches_jax_over_three_steps``'s
tolerances.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nerf_tpu import ClassicNeRF as JaxNeRF
from nerf_tpu import ClassicNeRFConfig as JaxConfig
from nerf_tpu import MipNeRF as JaxMipNeRF
from nerf_tpu import MipNeRFConfig as JaxMipConfig
from nerf_tpu import RenderConfig as JaxRender
from nerf_tpu.ops import encoding as jenc
from nerf_tpu.ops import sampling as jsamp
from nerf_tpu.train import checkpoint as jckpt
from nerf_tpu.train import create_train_state as jax_create_state
from nerf_tpu.train import make_train_step as jax_make_train_step
from nerf_tpu_torch import (
    ClassicNeRF,
    ClassicNeRFConfig,
    MipNeRF,
    MipNeRFConfig,
    RenderConfig,
    TrainConfig,
)
from nerf_tpu_torch.data import RayBank, synthesize_scene
from nerf_tpu_torch.ops import sampling
from nerf_tpu_torch.train import Trainer, checkpoint, create_train_state, make_sampling_train_step
from nerf_tpu_torch.train import make_train_step
from nerf_tpu_torch.utils import pth_import

CLASSIC = dict(hidden_size=32, normalize_position=6.0)
MIP = dict(hidden_size=32, num_hidden_layers=3, encoding_size=8, segmentation_outputs=5)
RAYS, SAMPLES = 24, 8
LR = 1e-3


def port_model(family, seed=0, **kwargs):
    gen = torch.Generator().manual_seed(seed)
    if family == "classic":
        return ClassicNeRF(ClassicNeRFConfig(**dict(CLASSIC, **kwargs)), generator=gen,
                           device="cpu")
    return MipNeRF(MipNeRFConfig(**dict(MIP, **kwargs)), generator=gen, device="cpu")


def jax_model(family):
    return JaxNeRF(JaxConfig(**CLASSIC)) if family == "classic" else JaxMipNeRF(JaxMipConfig(**MIP))


def to_jax_tree(model, named):
    return checkpoint._to_jax_tree(model, named)


def batch_np(seed):
    rng = np.random.default_rng(seed)
    return {
        "rays_o": (rng.normal(size=(RAYS, 3)) * 0.1 + [0.0, 0.0, 4.0]).astype(np.float32),
        "rays_d": (rng.normal(size=(RAYS, 3)) * 0.2 + [0.0, 0.0, -1.0]).astype(np.float32),
        "pixels": rng.uniform(size=(RAYS, 3)).astype(np.float32),
    }


def port_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def render_cfg():
    return dict(num_coarse_samples=SAMPLES, near=2.0, far=6.0, randomly_sample=False,
                density_noise_std=0.0)


def port_draws(family, model):
    """The deterministic draws, for the mip family JAX's fenceposts (the
    port's differ by a few ulp, ``test_torch_mip_ops.py``)."""
    render = RenderConfig(**render_cfg())
    if family == "classic":
        return sampling.draw_step(None, render, RAYS, "cpu")
    t = jsamp.sample_log_bbox(None, (RAYS,), SAMPLES, model.cfg.bbox_diagonal,
                              randomly_sample=False)
    return sampling.StepDraws(torch.from_numpy(np.array(t)), torch.zeros(RAYS, SAMPLES - 1))


def take_steps(state, family, n, seed=0):
    step = make_train_step(state.model, RenderConfig(**render_cfg()))
    for i in range(n):
        step(state, port_batch(batch_np(seed + i)), port_draws(family, state.model))
    return state


def adam_moments(state):
    """``{name: (exp_avg, exp_avg_sq, step)}`` of the model's parameters."""
    return {name: tuple(state.optimizer.state[p][k] for k in ("exp_avg", "exp_avg_sq", "step"))
            for name, p in state.model.mlp.named_parameters()}


def assert_states_close(a, b, atol):
    for (name, pa), pb in zip(a.model.mlp.named_parameters(), b.model.mlp.parameters()):
        torch.testing.assert_close(pa.detach(), pb.detach(), rtol=0, atol=atol, msg=name)
    ma, mb = adam_moments(a), adam_moments(b)
    for name in ma:
        for x, y in zip(ma[name], mb[name]):
            torch.testing.assert_close(x, y, rtol=0, atol=atol, msg=name)


# -- the port's own files ------------------------------------------------------


@pytest.mark.parametrize("family", ["classic", "mip"])
def test_save_restore_round_trip(tmp_path, family):
    state = take_steps(create_train_state(port_model(family, 3), LR, seed=2**33 + 7), family, 2)
    state.step = 42
    path = checkpoint.save_checkpoint(str(tmp_path), state)
    assert os.path.basename(path) == "checkpoint_42.npz"
    with np.load(path) as data:
        assert data[f"leaf_{len(data['leaf_names']) - 1:05d}"].tolist() == [2, 7]  # .key
    restored = create_train_state(port_model(family, 9), LR)
    assert checkpoint.restore_checkpoint(path, restored) is restored
    assert restored.step == 42 and restored.seed == 2**33 + 7
    assert_states_close(state, restored, atol=0)
    assert all(int(m[2]) == 2 for m in adam_moments(restored).values())


@pytest.mark.parametrize("other, match", [
    (dict(trunk_blocks=(1, 1)), "first differing path"),
    (dict(hidden_size=16), r"shape mismatch at \.params\['block_0'\]\[0\]\['linear'\]\['b'\]"),
])
def test_mismatch_fails_loudly(tmp_path, other, match):
    path = checkpoint.save_checkpoint(str(tmp_path), create_train_state(port_model("classic")))
    with pytest.raises(ValueError, match=match):
        checkpoint.restore_checkpoint(path, create_train_state(port_model("classic", **other)))


def test_retention(tmp_path):
    state = create_train_state(port_model("classic"))
    for s in range(6):
        state.step = s
        checkpoint.save_checkpoint(str(tmp_path), state, keep=3)
    assert checkpoint.all_checkpoints(str(tmp_path)) == [
        "checkpoint_3.npz", "checkpoint_4.npz", "checkpoint_5.npz"]
    assert checkpoint.latest_checkpoint(str(tmp_path)) == str(tmp_path / "checkpoint_5.npz")
    assert checkpoint.restore_latest(str(tmp_path / "empty"), state) is None


def test_save_refuses_disagreeing_adam_steps(tmp_path):
    state = take_steps(create_train_state(port_model("classic")), "classic", 1)
    first = next(state.model.mlp.parameters())
    state.optimizer.state[first]["step"] += 1
    with pytest.raises(ValueError, match="steps disagree"):
        checkpoint.save_checkpoint(str(tmp_path), state)


def test_sharded_manifest_is_refused(tmp_path):
    # A sharded manifest whose shard files are missing: refused loudly, as
    # JAX's restore refuses it, before any leaf is read.
    path = str(tmp_path / "checkpoint_4.npz")
    np.savez(path, leaf_names=np.asarray([".step"]), sharded=np.asarray(True),
             num_shard_files=np.asarray(2))
    with pytest.raises(FileNotFoundError, match=r"missing .*checkpoint_4\.shards0\.npz"):
        checkpoint.restore_checkpoint(path, create_train_state(port_model("classic")))


def jax_sharded_state(family, layout):
    """A JAX train state after 3 steps (Adam's moments not zero) on the
    8-virtual-device mesh: every leaf replicated, or (``split``) every leaf
    whose leading axis divides split over 2 devices along it, the rest
    replicated."""
    jmodel = jax_model(family)
    jstep = jax_make_train_step(jmodel, optax.adam(LR), JaxRender(**render_cfg()), donate=False)
    jstate = jax_create_state(jmodel.init(jax.random.PRNGKey(1)), optax.adam(LR), 5)
    for i in range(3):
        jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch_np(i).items()})
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("model", "batch"))

    def place(x):
        x = jnp.asarray(x)
        split = layout == "split" and x.ndim > 0 and x.shape[0] % 2 == 0
        return jax.device_put(x, NamedSharding(mesh, P("model") if split else P()))

    return jax.tree_util.tree_map(place, jstate)


def split_leaves(keys):
    """The ``leaf_<i>.s<j>.`` prefixes of the pieces of every leaf stored
    in more than one piece."""
    pieces = [k[:-len("data")] for k in keys if k.endswith(".data")]
    leaves = [p.split(".")[0] for p in pieces]
    return [p for p, leaf in zip(pieces, leaves) if leaves.count(leaf) > 1]


@pytest.mark.parametrize("layout", ["replicated", "split"])
@pytest.mark.parametrize("family", ["classic", "mip"])
def test_jax_sharded_checkpoint_restores_into_port(tmp_path, family, layout):
    # JAX's sharded layout (a manifest and checkpoint_<step>.shards0.npz of
    # pieces with their index bounds) restores exactly what JAX's
    # single-file layout of the same state restores.
    jstate = jax_sharded_state(family, layout)
    sharded = jckpt.save_checkpoint(str(tmp_path / "sharded"), jstate, sharded=True)
    assert sorted(os.listdir(tmp_path / "sharded")) == ["checkpoint_3.npz",
                                                        "checkpoint_3.shards0.npz"]
    if layout == "split":
        with np.load(tmp_path / "sharded" / "checkpoint_3.shards0.npz") as data:
            assert len(split_leaves(data.files)) > 0
    single = jckpt.save_checkpoint(str(tmp_path / "single"), jax.device_get(jstate))
    got = checkpoint.restore_checkpoint(sharded, create_train_state(port_model(family, 8), LR))
    want = checkpoint.restore_checkpoint(single, create_train_state(port_model(family, 9), LR))
    assert got.step == want.step == 3 and got.seed == want.seed == 5
    assert_states_close(got, want, atol=0)
    assert all(int(m[2]) == 3 for m in adam_moments(got).values())


def test_sharded_checkpoint_with_uncovered_or_foreign_leaves_is_refused(tmp_path):
    jstate = jax_sharded_state("classic", "split")
    path = jckpt.save_checkpoint(str(tmp_path), jstate, sharded=True)
    shards = str(tmp_path / "checkpoint_3.shards0.npz")
    with np.load(shards) as data:
        pieces = {k: data[k] for k in data.files}
    with pytest.raises(ValueError, match="first differing path"):
        checkpoint.restore_checkpoint(path, create_train_state(port_model("classic",
                                                                          trunk_blocks=(1, 1))))
    dropped = split_leaves(pieces)[0]  # one piece of a leaf in two
    np.savez(shards, **{k: v for k, v in pieces.items() if not k.startswith(dropped)})
    with pytest.raises(ValueError, match="uncovered elements"):
        checkpoint.restore_checkpoint(path, create_train_state(port_model("classic")))


@pytest.fixture(scope="module")
def bank():
    scene = synthesize_scene(num_views=3, image_hw=12, focal=15.0, num_samples=96, device="cpu")
    return scene, RayBank.from_images(scene.images, scene.pose_o, scene.pose_r, scene.focal)


def test_resume_continues_identically(bank, tmp_path):
    # 10 steps straight against 5, save, restore into a freshly seeded
    # model, 5 more: the draws are a function of (seed, step).
    _, pb = bank
    render = RenderConfig(num_coarse_samples=8, num_fine_samples=8, density_noise_std=0.5)

    def run(state, n):
        step = make_sampling_train_step(state.model, render, pb, 32)
        for _ in range(n):
            step(state)
        return state

    straight = run(create_train_state(port_model("classic"), LR, seed=4), 10)
    half = run(create_train_state(port_model("classic"), LR, seed=4), 5)
    path = checkpoint.save_checkpoint(str(tmp_path), half)
    resumed = checkpoint.restore_checkpoint(path, create_train_state(port_model("classic", 7), LR))
    assert resumed.step == 5 and resumed.seed == 4
    run(resumed, 5)
    assert_states_close(straight, resumed, atol=1e-6)


# -- across the two packages ---------------------------------------------------


def copy_jax_scales(model):
    cfg = model.cfg
    model.x_scales.copy_(torch.tensor(
        jenc.frequency_scales_np(cfg.x_positional_encoding_size, cfg.normalize_position)))
    model.d_scales.copy_(torch.tensor(
        jenc.frequency_scales_np(cfg.d_positional_encoding_size, cfg.direction_bound)))


@pytest.mark.parametrize("family", ["classic", "mip"])
def test_jax_checkpoint_restores_into_port_and_steps_alike(tmp_path, family):
    jmodel = jax_model(family)
    jstep = jax_make_train_step(jmodel, optax.adam(LR), JaxRender(**render_cfg()), donate=False)
    jstate = jax_create_state(jmodel.init(jax.random.PRNGKey(1)), optax.adam(LR), 5)
    for i in range(3):  # so the moments are not zero
        jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch_np(i).items()})
    path = jckpt.save_checkpoint(str(tmp_path), jstate)

    state = checkpoint.restore_checkpoint(path, create_train_state(port_model(family, 8), LR))
    assert state.step == 3 and state.seed == 5
    host = jax.tree_util.tree_map(np.asarray, jstate)
    adam = host.opt_state[0]
    want = {"weight": checkpoint._from_jax_tree(state.model, host.params),
            "exp_avg": checkpoint._from_jax_tree(state.model, adam.mu),
            "exp_avg_sq": checkpoint._from_jax_tree(state.model, adam.nu)}
    for name, p in state.model.mlp.named_parameters():
        assert torch.equal(p.detach(), want["weight"][name]), name
        st = state.optimizer.state[p]
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st[k], want[k][name]), (name, k)
        assert int(st["step"]) == int(adam.count) == 3

    # One more step in each package on the same batch.
    if family == "classic":
        copy_jax_scales(state.model)
    b = batch_np(7)
    jstate, jaux = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
    aux = make_train_step(state.model, RenderConfig(**render_cfg()))(
        state, port_batch(b), port_draws(family, state.model))
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(aux["grad_norm"]), float(jaux["grad_norm"]), rtol=1e-3)
    assert state.step == 4
    sd = checkpoint._from_jax_tree(state.model, jax.tree_util.tree_map(np.asarray, jstate.params))
    for k, w in sd.items():
        np.testing.assert_allclose(state.model.mlp.state_dict()[k].numpy(), w.numpy(),
                                   atol=6e-3, err_msg=k)


@pytest.mark.parametrize("family", ["classic", "mip"])
def test_port_checkpoint_restores_into_jax(tmp_path, family):
    state = take_steps(create_train_state(port_model(family, 2), LR, seed=11), family, 3)
    path = checkpoint.save_checkpoint(str(tmp_path), state)
    template = jax_create_state(jax_model(family).init(jax.random.PRNGKey(0)), optax.adam(LR))
    restored = jckpt.restore_checkpoint(path, template)
    names = jckpt._leaf_names(template)
    with np.load(path) as data:
        assert [str(n) for n in data["leaf_names"]] == names
        file_leaves = [data[f"leaf_{i:05d}"] for i in range(len(names))]
    for name, got, want, raw in zip(names, jax.tree_util.tree_leaves(restored),
                                    jax.tree_util.tree_leaves(template), file_leaves):
        assert got.dtype == want.dtype == raw.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(np.asarray(got), raw, err_msg=name)
    assert int(restored.step) == 3 and np.asarray(restored.key).tolist() == [0, 11]
    moments = adam_moments(state)
    named = {k: v for k, v in state.model.mlp.state_dict().items()}
    for tree, src in ((restored.params, named),
                      (restored.opt_state[0].mu, {k: m[0] for k, m in moments.items()}),
                      (restored.opt_state[0].nu, {k: m[1] for k, m in moments.items()})):
        for got, want in zip(jax.tree_util.tree_leaves(tree),
                             jax.tree_util.tree_leaves(to_jax_tree(state.model, src))):
            np.testing.assert_array_equal(np.asarray(got), want)
    assert int(restored.opt_state[0].count) == 3


def test_export_reference_pth_matches_jax(tmp_path):
    model = port_model("classic", 5, hidden_size=256)
    params = pth_import.jax_params_from_classic_state_dict(model.mlp.state_dict(), model.cfg)
    jckpt.export_reference_pth(str(tmp_path / "jax.pth"), params)
    checkpoint.export_reference_pth(str(tmp_path / "port.pth"), model)
    want = torch.load(tmp_path / "jax.pth", weights_only=True)
    got = torch.load(tmp_path / "port.pth", weights_only=True)
    assert sorted(got) == sorted(want) and len(got) == 44
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


# -- the Trainer ---------------------------------------------------------------


def test_trainer_logging_dir_checkpoints_and_resumes(bank, tmp_path):
    scene, pb = bank
    cfg = TrainConfig(batch_size=32, learning_rate=5e-3, log_interval=3, eval_interval=3,
                      checkpoint_interval=3, seed=1)
    render = RenderConfig(num_coarse_samples=8, num_fine_samples=4, density_noise_std=0.5)

    def trainer(logdir):
        return Trainer(port_model("classic", 0, use_pallas=True), render, cfg,
                       logging_dir=str(logdir))

    run = tmp_path / "run"
    first = trainer(run)
    state = first.fit(pb, scene, num_steps=6)
    assert state.step == 6
    names = set(os.listdir(run))
    assert {"checkpoint_3.npz", "checkpoint_6.npz", "metrics.jsonl", "psnrs.npy",
            "iternums.npy", "heartbeats"} <= names
    assert (run / "metrics.jsonl").read_text().count("\n") == 2
    assert np.load(run / "iternums.npy").tolist() == [3, 6]
    assert os.listdir(run / "heartbeats") == ["proc_0.json"]

    again = trainer(run)
    resumed = again.init_state(resume=True)
    assert resumed.step == 6
    resumed = again.fit(pb, scene, num_steps=9, state=resumed)
    straight = trainer(tmp_path / "straight")
    assert straight.init_state(resume=True).step == 0  # nothing to resume from
    full = straight.fit(pb, scene, num_steps=9)
    assert_states_close(full, resumed, atol=1e-6)
    assert checkpoint.all_checkpoints(str(run))[-1] == "checkpoint_9.npz"
