"""The port's entry points held against the JAX package's on the CPU: the
three CLIs' parsers (every JAX flag with its default, plus ``--device``),
short runs of both training CLIs (mirroring ``tests/test_cli.py``) with
and without ``--use-pallas``, ``--data-parallel`` at one rank over gloo
(the same files as without it) and refused by name where its GPU is
missing,
``load_tiny_nerf`` on a small ``.npz``, the forward-facing scene, the
render CLI on a full-width port-written ``.npz`` against the JAX CLI's
PNGs of the same file, and ``utils.profiling``'s ``trace`` and
``step_timer``.

Tolerances: the forward-facing scene at ``test_synthesize_scene_matches_jax``'s
(poses atol 1e-6, images 2e-5); PNGs within one 8-bit level, as
``test_render_cli_on_cpu_matches_jax_cli``.
"""

import json
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.cli import render as jax_render_cli
from nerf_tpu.cli import train_conditional as jax_conditional
from nerf_tpu.cli import train_tiny_nerf as jax_tiny
from nerf_tpu.data import scenes as jscenes
from nerf_tpu_torch import ClassicNeRF, ClassicNeRFConfig
from nerf_tpu_torch.cli import render as port_render_cli
from nerf_tpu_torch.cli import train_conditional, train_tiny_nerf
from nerf_tpu_torch.data import load_tiny_nerf, scenes
from nerf_tpu_torch.train import checkpoint, create_train_state
from nerf_tpu_torch.utils import profiling
from test_torch_render import CLI_ARGS, read_png

CLIS = {"tiny": (jax_tiny, train_tiny_nerf), "conditional": (jax_conditional, train_conditional),
        "render": (jax_render_cli, port_render_cli)}


def defaults(parser):
    return {a.dest: a.default for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_parser_has_every_jax_flag_and_device(cli):
    jax_cli, port_cli = CLIS[cli]
    want, got = defaults(jax_cli.build_parser()), defaults(port_cli.build_parser())
    assert {k: got[k] for k in want if k in got} == want
    assert set(got) - set(want) == {"device"} and got["device"] == "cuda"


TINY_ARGS = ["--num-steps", "6", "--batch-size", "128", "--num-samples-per-ray", "8",
             "--log-interval", "3", "--synthetic-views", "3", "--synthetic-hw", "24",
             "--device", "cpu"]


@pytest.mark.parametrize("use_pallas", [False, True])
def test_tiny_nerf_short_training_run(tmp_path, use_pallas):
    logdir = tmp_path / "run"
    train_tiny_nerf.main(["--logging-dir", str(logdir), "--data", str(tmp_path / "missing.npz")]
                         + TINY_ARGS + (["--use-pallas"] if use_pallas else []))
    params = json.loads((logdir / "params.json").read_text())
    assert params["num_steps"] == 6 and params["device"] == "cpu"
    assert params["use_pallas"] == use_pallas
    names = set(os.listdir(logdir))
    assert {"nerf.pth", "checkpoint_3.npz", "checkpoint_6.npz", "metrics.jsonl",
            "psnrs.npy"} <= names
    records = [json.loads(line) for line in (logdir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [3, 6]
    assert all(np.isfinite([r["loss"], r["psnr"]]).all() for r in records)
    sd = torch.load(logdir / "nerf.pth", weights_only=True)
    assert len(sd) == 44 and sd["block_0.0.weight"].shape == (256, 60)


def conditional_data(tmp_path, b=3, hw=12):
    rng = np.random.default_rng(0)
    payload = {
        "images": rng.uniform(size=(b, hw, hw, 3)).astype(np.float32),
        "poses": np.concatenate([rng.normal(size=(b, 3)), rng.normal(size=(b, 3))],
                                -1).astype(np.float32),
        "states": rng.normal(size=(b, 4)).astype(np.float32),
    }
    data = tmp_path / "data_for_nerf.pkl"
    with open(data, "wb") as f:
        pickle.dump(payload, f)
    return data


@pytest.mark.parametrize("use_pallas", [False, True])
def test_conditional_short_training_run(tmp_path, use_pallas):
    logdir = tmp_path / "run"
    train_conditional.main([
        "--logging-dir", str(logdir), "--data", str(conditional_data(tmp_path)),
        "--epochs", "1", "--batch-size", "64", "--num-samples-per-ray", "8",
        "--near-plane", "2.0", "--far-plane", "6.0", "--log-interval", "2", "--device", "cpu",
    ] + (["--use-pallas"] if use_pallas else []))
    assert json.loads((logdir / "params.json").read_text())["epochs"] == 1
    # 2 training images of 12 x 12 in batches of 64: 4 steps an epoch.
    assert checkpoint.all_checkpoints(str(logdir)) == ["checkpoint_2.npz", "checkpoint_4.npz"]
    sd = torch.load(logdir / "model.pth", weights_only=True)
    assert sd["block_0.0.weight"].shape == (256, (3 + 4) * 20)  # density_inputs = 3 + 4
    with np.load(logdir / "checkpoint_4.npz") as data:
        assert int(data["leaf_00000"]) == 4


@pytest.mark.parametrize("cli", [train_tiny_nerf, train_conditional])
def test_data_parallel_exits_with_the_named_error(tmp_path, cli, monkeypatch):
    # --data-parallel on the card (the default --device) where no GPU is
    # visible: the process group's device is refused by name, before any
    # work, and no group is left behind.
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    logdir = tmp_path / "run"
    with pytest.raises(RuntimeError, match=r"wants cuda:0, but 0 GPU\(s\) are visible"):
        cli.main(["--data-parallel", "--logging-dir", str(logdir)])
    assert not logdir.exists()
    assert not torch.distributed.is_initialized()


def cli_args(cli, tmp_path, logdir):
    if cli is train_tiny_nerf:
        return (["--logging-dir", str(logdir), "--data", str(tmp_path / "missing.npz")]
                + TINY_ARGS + ["--num-steps", "4", "--batch-size", "32", "--log-interval", "2",
                               "--use-pallas"])
    return ["--logging-dir", str(logdir), "--data", str(conditional_data(tmp_path)),
            "--epochs", "1", "--batch-size", "72", "--num-samples-per-ray", "8",
            "--near-plane", "2.0", "--far-plane", "6.0", "--log-interval", "2", "--device", "cpu",
            "--use-pallas"]


@pytest.mark.parametrize("cli", [train_tiny_nerf, train_conditional])
def test_data_parallel_trains_at_one_rank_over_gloo(tmp_path, cli, monkeypatch):
    # --data-parallel --device cpu: a gloo group of one (no torchrun
    # environment); 4 steps, checkpoints at 2 and 4, the export, and the
    # same files, bit for bit, as the run without the flag.
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    runs = {}
    for flag in ([], ["--data-parallel"]):
        logdir = tmp_path / ("dp" if flag else "plain")
        cli.main(cli_args(cli, tmp_path, logdir) + flag)
        assert not torch.distributed.is_initialized()
        assert checkpoint.all_checkpoints(str(logdir)) == ["checkpoint_2.npz", "checkpoint_4.npz"]
        assert json.loads((logdir / "params.json").read_text())["data_parallel"] == bool(flag)
        export = "nerf.pth" if cli is train_tiny_nerf else "model.pth"
        runs[bool(flag)] = (np.load(logdir / "checkpoint_4.npz"),
                            torch.load(logdir / export, weights_only=True))
    (plain, plain_sd), (dp, dp_sd) = runs[False], runs[True]
    assert plain.files == dp.files and int(dp["leaf_00000"]) == 4
    for key in plain.files:
        np.testing.assert_array_equal(dp[key], plain[key], err_msg=key)
    assert all(torch.equal(dp_sd[k], plain_sd[k]) for k in plain_sd)


# -- data ------------------------------------------------------------------------


def test_load_tiny_nerf_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    poses = np.tile(np.eye(4), (2, 1, 1))
    poses[:, :3, :3] = np.linalg.qr(rng.normal(size=(2, 3, 3)))[0]
    poses[:, :3, 3] = rng.normal(size=(2, 3))
    path = tmp_path / "tiny_nerf_data.npz"
    np.savez(path, images=rng.uniform(size=(2, 5, 4, 3)), poses=poses, focal=np.float64(7.5))
    ours, want = load_tiny_nerf(str(path), device="cpu"), jscenes.load_tiny_nerf(str(path))
    assert ours.focal == want.focal == 7.5 and ours.images.dtype == torch.float32
    for name in ("images", "pose_o", "pose_r"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(want, name)))


def test_forward_facing_scene_matches_jax():
    pose_o, pose_r = scenes.forward_facing_poses(5, device="cpu")
    want_o, want_r = jscenes.forward_facing_poses(5)
    np.testing.assert_allclose(pose_o.numpy(), np.asarray(want_o), atol=1e-6)
    np.testing.assert_allclose(pose_r.numpy(), np.asarray(want_r), atol=1e-6)
    kw = dict(num_views=4, image_hw=8, focal=10.0, num_samples=96)
    ours, want = scenes.synthesize_forward_facing(device="cpu", **kw), \
        jscenes.synthesize_forward_facing(**kw)
    assert ours.images.shape == (4, 8, 8, 3) and ours.focal == 10.0
    np.testing.assert_allclose(ours.pose_o.numpy(), np.asarray(want.pose_o), atol=1e-6)
    np.testing.assert_allclose(ours.images.numpy(), np.asarray(want.images), atol=2e-5)
    assert float(jnp.std(want.images)) > 1e-3  # the blobs are in view


# -- the render CLI on a checkpoint ---------------------------------------------


@pytest.fixture(scope="module")
def npz_reference(tmp_path_factory):
    """A full-width port checkpoint, and the JAX CLI's renders of it (its
    plain XLA path)."""
    root = tmp_path_factory.mktemp("npz")
    model = ClassicNeRF(ClassicNeRFConfig(normalize_position=6.0),
                        generator=torch.Generator().manual_seed(0), device="cpu")
    state = create_train_state(model, seed=3)
    state.step = 7
    ckpt = checkpoint.save_checkpoint(str(root), state)
    jax_render_cli.main(["--checkpoint", ckpt, "--output-dir", str(root / "jax")] + CLI_ARGS)
    return ckpt, root / "jax"


@pytest.mark.parametrize("use_pallas", [False, True])
def test_render_cli_on_port_npz_matches_jax_cli(npz_reference, tmp_path, use_pallas):
    ckpt, jax_dir = npz_reference
    port_render_cli.main(["--checkpoint", ckpt, "--output-dir", str(tmp_path), "--device", "cpu"]
                         + CLI_ARGS + (["--use-pallas"] if use_pallas else []))
    for name in ("view_000.png", "view_001.png"):
        ours = read_png(tmp_path / name).astype(int)
        assert np.abs(ours - read_png(jax_dir / name).astype(int)).max() <= 1, name


# -- profiling ---------------------------------------------------------------------


def test_trace_writes_a_trace_file_and_step_timer_records(tmp_path, capsys):
    x = torch.ones(64, 64)
    with profiling.trace(str(tmp_path), create_perfetto_link=True):
        y = (x @ x).sum()
    (name,) = os.listdir(tmp_path)
    events = json.loads((tmp_path / name).read_text())["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    assert str(tmp_path / name) in capsys.readouterr().out
    with profiling.step_timer() as timer:
        elapsed = timer.sync({"loss": [y * 2, (y, torch.zeros(2))]})
    assert timer.elapsed == elapsed > 0.0
