"""The port's watchdog (``nerf_tpu_torch/parallel/watchdog.py``) on the CPU:
``tests/test_watchdog.py``'s ``TestHeartbeat`` against the port's copy,
the default process id (the ``torch.distributed`` rank, else 0), the
supervisor's clean run and its giving up after ``max_restarts``, and one
recovery: a worker running the port's ``train_tiny_nerf`` with
``--resume`` is SIGKILLed right after its first checkpoint, the
supervisor restarts it, and its final checkpoint equals an uninterrupted
run's.
"""

import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch.distributed as dist

from nerf_tpu_torch.parallel.watchdog import (
    Heartbeat,
    Supervisor,
    clear_heartbeats,
    read_heartbeats,
    stale_processes,
    stalled_processes,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestHeartbeat:
    def test_beat_and_read(self, tmp_path):
        hb = Heartbeat(str(tmp_path), process_id=3, interval=0.05)
        with hb:
            hb.update(17)
            recs = read_heartbeats(str(tmp_path))
        assert recs[3]["step"] == 17
        assert recs[3]["pid"] == os.getpid()
        assert abs(recs[3]["time"] - time.time()) < 5.0

    def test_background_thread_keeps_beating(self, tmp_path):
        with Heartbeat(str(tmp_path), process_id=0, interval=0.02):
            t0 = read_heartbeats(str(tmp_path))[0]["time"]
            time.sleep(0.2)
            t1 = read_heartbeats(str(tmp_path))[0]["time"]
        assert t1 > t0  # thread re-beat without any update() call

    def test_staleness_detection(self, tmp_path):
        hb = Heartbeat(str(tmp_path), process_id=1, interval=1000.0)
        hb.beat()  # one beat, no thread
        assert stale_processes(str(tmp_path), timeout=60.0) == []
        future = time.time() + 120.0
        assert stale_processes(str(tmp_path), timeout=60.0, now=future) == [1]
        assert stalled_processes(str(tmp_path), progress_timeout=60.0, now=future) == [1]

    def test_torn_file_is_treated_as_missing(self, tmp_path):
        hb_dir = tmp_path / "heartbeats"
        hb_dir.mkdir()
        (hb_dir / "proc_0.json").write_text('{"pid": 1, "proc')  # torn
        assert read_heartbeats(str(tmp_path)) == {}

    def test_clear(self, tmp_path):
        Heartbeat(str(tmp_path), process_id=0).beat()
        clear_heartbeats(str(tmp_path))
        assert read_heartbeats(str(tmp_path)) == {}

    def test_default_process_id_is_the_rank(self, tmp_path, monkeypatch):
        assert Heartbeat(str(tmp_path)).process_id == 0  # no process group
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_rank", lambda: 3)
        assert Heartbeat(str(tmp_path)).process_id == 3


class TestSupervisor:
    def test_clean_run_no_restarts(self, tmp_path):
        worker = tmp_path / "worker.py"
        worker.write_text(textwrap.dedent(f"""
            import sys
            sys.path.insert(0, {REPO!r})
            from nerf_tpu_torch.parallel.watchdog import Heartbeat
            with Heartbeat(sys.argv[1], process_id=int(sys.argv[2]), interval=0.05) as hb:
                for step in range(1, 4):
                    hb.update(step)
        """))
        sup = Supervisor(
            lambda rank, _a: [sys.executable, str(worker), str(tmp_path), str(rank)],
            num_processes=2, run_dir=str(tmp_path), heartbeat_timeout=30.0,
            poll_interval=0.05, max_restarts=2,
        )
        assert sup.run() == 0
        assert {r: rec["step"] for r, rec in read_heartbeats(str(tmp_path)).items()} == {0: 3, 1: 3}

    def test_gives_up_after_max_restarts(self, tmp_path):
        worker = tmp_path / "worker.py"
        worker.write_text("import sys; sys.exit(9)\n")
        sup = Supervisor(
            lambda rank, _a: [sys.executable, str(worker)],
            num_processes=1, run_dir=str(tmp_path), heartbeat_timeout=30.0,
            poll_interval=0.05, max_restarts=2,
        )
        with pytest.raises(RuntimeError, match="after 2 restarts"):
            sup.run()
        assert sup.restarts == 2  # three launches


# The port's tiny-NeRF trainer at full width on a small synthetic scene:
# 6 steps, a checkpoint every 3.  Killed (first attempt only) right after
# its first checkpoint is durable.
_TRAIN_WORKER = textwrap.dedent(
    """
    import os, signal, sys
    sys.path.insert(0, {repo!r})
    from nerf_tpu_torch.cli import train_tiny_nerf
    from nerf_tpu_torch.train import checkpoint

    logdir, kill = sys.argv[1], sys.argv[2] == "kill"
    os.makedirs(logdir, exist_ok=True)
    marker = os.path.join(logdir, "attempted")
    first_attempt = not os.path.exists(marker)
    open(marker, "w").close()
    if kill and first_attempt:
        save = checkpoint.save_checkpoint

        def save_then_die(*args, **kwargs):
            save(*args, **kwargs)
            os.kill(os.getpid(), signal.SIGKILL)

        checkpoint.save_checkpoint = save_then_die
    train_tiny_nerf.main([
        "--logging-dir", logdir, "--resume", "--device", "cpu", "--data", "missing.npz",
        "--num-steps", "6", "--log-interval", "3", "--batch-size", "64",
        "--num-samples-per-ray", "8", "--synthetic-views", "3", "--synthetic-hw", "16",
    ])
    """
)


def test_sigkilled_trainer_resumes_to_the_uninterrupted_result(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_TRAIN_WORKER.format(repo=REPO))
    # One thread a worker: both runs reduce in the same order.
    env = dict(os.environ, OMP_NUM_THREADS="1")
    killed, straight = tmp_path / "killed", tmp_path / "straight"
    sup = Supervisor(
        lambda rank, _a: [sys.executable, str(worker), str(killed), "kill"],
        num_processes=1, run_dir=str(killed), heartbeat_timeout=60.0,
        poll_interval=0.1, max_restarts=2, env=env,
    )
    assert sup.run() == 1
    subprocess.run([sys.executable, str(worker), str(straight), "straight"], env=env,
                   check=True, timeout=300, stdout=subprocess.DEVNULL)
    with np.load(killed / "checkpoint_6.npz") as got, \
            np.load(straight / "checkpoint_6.npz") as want:
        assert got.files == want.files
        for key in want.files:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    steps = [line for line in (killed / "metrics.jsonl").read_text().splitlines()]
    assert len(steps) == 2  # step 3 before the kill, step 6 after the resume
