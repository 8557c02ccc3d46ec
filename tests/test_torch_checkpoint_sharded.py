"""The port's sharded checkpoint layout (``nerf_tpu_torch/train/checkpoint.py``,
``save_checkpoint(sharded=...)``) for tensor-parallel states, in both
directions with the JAX package (``tests/test_checkpoint_sharded.py`` and
``test_multiprocess.py``'s ``TestTwoProcessShardedCheckpoint``).

Two real processes over gloo on the CPU run ``torch_mesh_worker.py`` (no
JAX) on a 1x2 batch x model mesh: a tensor-parallel run of 6 Adam steps
saving the sharded layout at 3 and 6, a run stopped at step 3 (the run
that is killed) and, in new processes, that run resumed to 6, which must
equal the straight run bitwise on both ranks.  This process reads the
port's files with JAX's ``restore_checkpoint``, and writes a
tensor-parallel checkpoint with JAX on ``make_mesh_2d(2, 4, "model")``
(``sharded=True``) that the ranks restore onto their 1x2 mesh and that a
group of one restores onto 1x1.

In one process, a gloo group of one: a replicated state saves the single
file; a missing shard file and a leaf-structure mismatch fail loudly;
retention prunes the shard files; a state split across ranks is refused
the single file.  Models are small (hidden 32).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_tpu import ClassicNeRF as JaxNeRF
from nerf_tpu import ClassicNeRFConfig as JaxConfig
from nerf_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from nerf_tpu.parallel import tensor_parallel as jtp
from nerf_tpu.train import checkpoint as jckpt
from nerf_tpu.train import create_train_state as jax_create_state
from nerf_tpu_torch import ClassicNeRF, ClassicNeRFConfig
from nerf_tpu_torch.parallel import Mesh, initialize, make_mesh_2d, prepare_tp_state, shutdown
from nerf_tpu_torch.parallel.mesh import Axis
from nerf_tpu_torch.parallel.tensor_parallel import TensorParallelMLP
from nerf_tpu_torch.train import checkpoint, create_train_state
from nerf_tpu_torch.utils.pth_import import classic_state_dict_from_jax_params
from test_torch_sample_parallel import finish_ranks, start_ranks
from test_torch_tensor_parallel import put_together
from torch_mesh_worker import CKPT_STEPS, TRAIN, train_model

WORLD = 2
JAX_STEP, JAX_COUNT, JAX_SEED = 7, 5, 11


def jax_tp_state():
    """A JAX tensor-parallel train state on ``make_mesh_2d(2, 4, "model")``
    with random Adam moments, its step and count set."""
    model = JaxNeRF(JaxConfig(**TRAIN))
    state = jax_create_state(model.init(jax.random.PRNGKey(3)), optax.adam(1e-3), JAX_SEED)
    rng = np.random.default_rng(0)

    def noise(tree, scale):
        return jax.tree_util.tree_map(
            lambda x: jnp.asarray(np.abs(rng.normal(size=x.shape)) * scale, jnp.float32), tree)

    adam = state.opt_state[0]._replace(count=jnp.asarray(JAX_COUNT, jnp.int32),
                                       mu=noise(state.params, 1e-2), nu=noise(state.params, 1e-4))
    state = state._replace(step=jnp.asarray(JAX_STEP, jnp.int32),
                           opt_state=(adam,) + tuple(state.opt_state[1:]))
    return model, jtp.prepare_tp_state(state, model, jax_make_mesh_2d(2, 4, second_axis="model"))


def jax_leaves(state) -> dict:
    """A JAX state's weights and Adam moments keyed like the port's
    ``state_dict``, and its step, count and seed."""
    state = jax.device_get(state)
    adam = state.opt_state[0]
    out = {f"{part}/{k}": v.numpy() for part, tree in (("weights", state.params),
                                                        ("mu", adam.mu), ("nu", adam.nu))
           for k, v in classic_state_dict_from_jax_params(tree).items()}
    hi, lo = (int(v) for v in np.asarray(state.key))
    out["step_count_seed"] = (int(state.step), int(adam.count), (hi << 32) | lo)
    return out


def port_leaves(state) -> dict:
    count, mu, nu = checkpoint.adam_state(state)
    out = {f"weights/{k}": v.detach().numpy() for k, v in state.model.mlp.state_dict().items()}
    out.update({f"{part}/{k}": v.numpy() for part, tree in (("mu", mu), ("nu", nu))
                for k, v in tree.items()})
    out["step_count_seed"] = (state.step, count, state.seed)
    return out


def whole(outs, name) -> dict:
    """A worker record (``name``) with the two ranks' slices put together."""
    full = train_model("classic").mlp.state_dict()
    got = {}
    for part in ("weights", "mu", "nu"):
        got.update({f"{part}/{k}": v for k, v in
                    put_together(outs, f"{name}/{part}/", full, WORLD).items()})
    return got


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("ckpt")
    np.savez(work / "inputs.npz", rays_o=np.zeros((1, 3)), rays_d=np.zeros((1, 3)))
    procs = start_ranks(work, "ckpt", WORLD)
    try:  # JAX's checkpoint, for the resumed ranks, while the ranks run
        model, jstate = jax_tp_state()
        jckpt.save_checkpoint(str(work / "jax"), jstate, sharded=True)
    finally:
        first = finish_ranks(work, "ckpt", procs)
    listing = {d: sorted(os.listdir(work / d)) for d in ("straight", "restart")}
    resumed = finish_ranks(work, "resume", start_ranks(work, "resume", WORLD))
    return dict(work=work, first=first, resume=resumed, jax=jstate, jax_model=model,
                listing=listing)


def test_two_rank_restart_equals_the_straight_run(runs):
    assert [int(out["resumed_from"]) for out in runs["resume"]] == [3, 3]
    for r in range(WORLD):
        straight, restart = runs["first"][r], runs["resume"][r]
        keys = [k for k in straight if k.startswith("straight/")]
        assert len(keys) > 3
        for key in keys:
            np.testing.assert_array_equal(restart["restart" + key[len("straight"):]],
                                          straight[key], err_msg=f"rank {r} {key}")
    assert list(runs["first"][0]["straight/step_count"]) == [CKPT_STEPS, CKPT_STEPS]


def test_each_rank_writes_and_prunes_its_shard_file(runs):
    # keep=1: the save at 6 pruned step 3's manifest and both shard files.
    sharded = ["checkpoint_{0}.npz", "checkpoint_{0}.shards0.npz", "checkpoint_{0}.shards1.npz"]
    assert runs["listing"]["straight"] == [n.format(6) for n in sharded]
    assert runs["listing"]["restart"] == [n.format(3) for n in sharded]
    assert sorted(os.listdir(runs["work"] / "restart")) == [n.format(6) for n in sharded]
    with np.load(runs["work"] / "straight" / "checkpoint_6.npz") as manifest:
        assert bool(manifest["sharded"]) and int(manifest["num_shard_files"]) == WORLD
    for r in range(WORLD):
        with np.load(runs["work"] / "straight" / f"checkpoint_6.shards{r}.npz") as shard:
            blocks = [k for k in shard.files if k.endswith(".data")]
        # 44 leaves in each of the weights, mu and nu: rank 0 writes its
        # halves and the two replicated head biases, rank 1 its halves.
        assert len(blocks) == 3 * (44 - 2 * r), (r, len(blocks))


def test_jax_restores_the_port_sharded_checkpoint(runs):
    path = str(runs["work"] / "straight" / "checkpoint_6.npz")
    model = runs["jax_model"]
    template = jax_create_state(model.init(jax.random.PRNGKey(9)), optax.adam(1e-3))
    got = jax_leaves(jckpt.restore_checkpoint(path, template))
    want = whole(runs["first"], "straight")
    assert got.pop("step_count_seed") == (CKPT_STEPS, CKPT_STEPS, 2)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    # The port's own restore onto a whole model reads the same leaves.
    port = port_leaves(checkpoint.restore_checkpoint(path, create_train_state(train_model("classic"))))
    assert port.pop("step_count_seed") == (CKPT_STEPS, CKPT_STEPS, 2)
    for key, value in want.items():
        np.testing.assert_array_equal(port[key], value, err_msg=key)


def test_port_restores_the_jax_checkpoint_onto_two_ranks(runs):
    want = jax_leaves(runs["jax"])
    assert want.pop("step_count_seed") == (JAX_STEP, JAX_COUNT, JAX_SEED)
    got = whole(runs["resume"], "from_jax")
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert list(runs["resume"][1]["from_jax/step_count"]) == [JAX_STEP, JAX_COUNT]


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


def tp_state(mesh, step=7, seed=0):
    state = prepare_tp_state(create_train_state(train_model("classic", seed=seed), 1e-3), mesh)
    state.step = step
    return state


def test_port_restores_the_jax_checkpoint_onto_one_rank(runs, mesh):
    want = jax_leaves(runs["jax"])
    path = checkpoint.latest_checkpoint(str(runs["work"] / "jax"))
    for state in (tp_state(mesh), create_train_state(train_model("classic"), 1e-3)):
        got = port_leaves(checkpoint.restore_checkpoint(path, state))
        assert got.pop("step_count_seed") == want["step_count_seed"]
        for key, value in want.items():
            if key != "step_count_seed":
                np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_replicated_state_saves_the_single_file(mesh, tmp_path):
    for name, state in (("plain", create_train_state(train_model("classic"), 1e-3)),
                        ("tp", tp_state(mesh))):
        state.step = 7
        checkpoint.save_checkpoint(str(tmp_path / name), state)
        assert sorted(os.listdir(tmp_path / name)) == ["checkpoint_7.npz"]
        with np.load(tmp_path / name / "checkpoint_7.npz") as data:
            assert "sharded" not in data.files
        restored = checkpoint.restore_latest(str(tmp_path / name), tp_state(mesh, seed=1))
        want, got = port_leaves(state), port_leaves(restored)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_sharded_round_trip_and_loud_failures(mesh, tmp_path):
    state = tp_state(mesh)
    checkpoint.save_checkpoint(str(tmp_path), state, sharded=True)
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_7.npz", "checkpoint_7.shards0.npz"]
    restored = checkpoint.restore_latest(str(tmp_path), tp_state(mesh, seed=1))
    want, got = port_leaves(state), port_leaves(restored)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    no_view = ClassicNeRF(ClassicNeRFConfig(**TRAIN, use_viewdirs=False), device="cpu")
    other = prepare_tp_state(create_train_state(no_view, 1e-3), mesh)
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.restore_latest(str(tmp_path), other)
    os.remove(tmp_path / "checkpoint_7.shards0.npz")
    with pytest.raises(FileNotFoundError, match="missing"):
        checkpoint.restore_latest(str(tmp_path), tp_state(mesh, seed=1))


def test_retention_prunes_shard_files(mesh, tmp_path):
    for step in (1, 2, 3, 4):
        checkpoint.save_checkpoint(str(tmp_path), tp_state(mesh, step=step), keep=2, sharded=True)
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_3.npz", "checkpoint_3.shards0.npz",
                                            "checkpoint_4.npz", "checkpoint_4.shards0.npz"]


def test_a_split_state_is_refused_the_single_file(tmp_path):
    # Model index 1 of 2, as a rank sees it: building the slices needs no
    # collective.
    mesh = Mesh(group=None, rank=1, size=2, device=torch.device("cpu"),
                grid=(Axis("batch", 1, 0, None), Axis("model", 2, 1, None)))
    state = create_train_state(train_model("classic"), 1e-3)
    state.model.mlp = TensorParallelMLP(state.model, mesh)
    with pytest.raises(ValueError, match="sharded layout"):
        checkpoint.save_checkpoint(str(tmp_path), state, sharded=False)
    assert not os.listdir(tmp_path)
