"""Failure detection: per-process heartbeats + a restarting supervisor
(a copy of ``nerf_tpu/parallel/watchdog.py``; only ``Heartbeat``'s default
``process_id`` differs: the ``torch.distributed`` rank).

The reference's failure story is "crash = lose the run, mitigated by
periodic ``torch.save``" (``train_conditional_nerf.py:160-161``); here a
crashed or HUNG process (wedged collective, dead host, stuck device) is
detected and the run restarted from its latest checkpoint.

Design — deliberately out-of-band of the device:

* ``Heartbeat``: a daemon thread per process writes
  ``<run_dir>/heartbeats/proc_<id>.json`` (pid, step, wall-clock) every
  ``interval`` seconds, via atomic rename so readers never see a torn
  file.  The run dir is the filesystem the checkpoints already use — no
  extra comm channel.  The record carries TWO signals: ``time`` (the
  thread's last beat — liveness of the Python runtime; note the daemon
  thread keeps beating even while the main thread is blocked inside a
  wedged collective, since blocking CUDA and NCCL calls release the GIL)
  and ``progress_time`` (when ``update(step)`` last advanced the step —
  forward progress).  Hang detection must use ``progress_time``;
  ``time`` only catches crashed-without-exit states.
* ``stale_processes`` / ``stalled_processes``: the detection primitives —
  processes that stopped beating, and processes that stopped making
  forward progress.
* ``Supervisor``: the recovery loop for multi-process launches.  Spawns
  one worker per rank, polls child exits, heartbeat staleness, PROGRESS
  staleness (the wedged-collective case), and never-registered workers
  (hung before their first beat); on any failure it kills the whole gang
  (SPMD can't run degraded — a dead rank wedges every collective) and
  relaunches from scratch, which resumes from the latest durable
  checkpoint (``train/checkpoint.py`` writes atomically, so a kill
  mid-save never yields a torn restore point).  ``max_restarts`` bounds
  crash loops.

``Trainer.fit`` starts a ``Heartbeat`` automatically when it has a
logging dir, stepping it at every chunk boundary.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)

_HEARTBEAT_DIR = "heartbeats"


def _heartbeat_path(run_dir: str, process_id: int) -> str:
    return os.path.join(run_dir, _HEARTBEAT_DIR, f"proc_{process_id}.json")


class Heartbeat:
    """Background liveness + progress beacon for one process.

    ``start()`` launches a daemon thread that rewrites this process's
    heartbeat file every ``interval`` seconds; ``update(step)`` records
    forward progress (thread-safe, called from the train loop).  Use as a
    context manager to guarantee ``stop()``.
    """

    def __init__(
        self,
        run_dir: str,
        process_id: Optional[int] = None,
        interval: float = 5.0,
    ):
        if process_id is None:
            import torch.distributed as dist

            initialized = dist.is_available() and dist.is_initialized()
            process_id = dist.get_rank() if initialized else 0
        self.run_dir = run_dir
        self.process_id = process_id
        self.interval = interval
        self._step = 0
        self._progress_time = time.time()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        os.makedirs(os.path.join(run_dir, _HEARTBEAT_DIR), exist_ok=True)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "Heartbeat":
        if self._thread is not None:
            return self
        self.beat()  # registered synchronously: visible before first poll
        self._thread = threading.Thread(
            target=self._run, name="nerf-tpu-heartbeat", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval + 1.0)
            self._thread = None

    def __enter__(self) -> "Heartbeat":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- beating ------------------------------------------------------------

    def update(self, step: int) -> None:
        """Record forward progress (and beat immediately)."""
        step = int(step)
        if step != self._step:
            self._progress_time = time.time()
        self._step = step
        self.beat()

    def beat(self) -> None:
        path = _heartbeat_path(self.run_dir, self.process_id)
        record = {
            "pid": os.getpid(),
            "process_id": self.process_id,
            "step": self._step,
            "time": time.time(),
            "progress_time": self._progress_time,
        }
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(record, f)
            os.replace(tmp, path)  # atomic: readers never see a torn file
        except OSError:
            # A full/unavailable shared fs must not kill training; the
            # watchdog will see the beat as stale, which is the truth.
            if os.path.exists(tmp):
                os.unlink(tmp)

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.beat()


def read_heartbeats(run_dir: str) -> Dict[int, Dict]:
    """All registered heartbeat records, keyed by process id."""
    hb_dir = os.path.join(run_dir, _HEARTBEAT_DIR)
    if not os.path.isdir(hb_dir):
        return {}
    out: Dict[int, Dict] = {}
    for name in os.listdir(hb_dir):
        if not name.startswith("proc_") or not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(hb_dir, name)) as f:
                rec = json.load(f)
            out[int(rec["process_id"])] = rec
        except (OSError, ValueError, KeyError):
            continue  # torn/garbage file: treated as missing (=> stale)
    return out


def stale_processes(
    run_dir: str, timeout: float, now: Optional[float] = None
) -> List[int]:
    """Process ids whose last beat is older than ``timeout`` seconds.

    Catches crashed-without-exit states (the beating thread died with the
    process).  A process wedged inside a collective keeps beating — use
    ``stalled_processes`` for that case.
    """
    now = time.time() if now is None else now
    return sorted(
        pid
        for pid, rec in read_heartbeats(run_dir).items()
        if now - rec.get("time", 0.0) > timeout
    )


def stalled_processes(
    run_dir: str, progress_timeout: float, now: Optional[float] = None
) -> List[int]:
    """Process ids whose ``update(step)`` hasn't advanced within
    ``progress_timeout`` seconds — the wedged-collective / stuck-relay
    detector (the heartbeat thread keeps beating through those)."""
    now = time.time() if now is None else now
    return sorted(
        pid
        for pid, rec in read_heartbeats(run_dir).items()
        if now - rec.get("progress_time", rec.get("time", 0.0))
        > progress_timeout
    )


def clear_heartbeats(run_dir: str) -> None:
    """Remove stale registrations before a (re)launch."""
    hb_dir = os.path.join(run_dir, _HEARTBEAT_DIR)
    if not os.path.isdir(hb_dir):
        return
    for name in os.listdir(hb_dir):
        try:
            os.unlink(os.path.join(hb_dir, name))
        except OSError:
            pass


class Supervisor:
    """Gang launcher with crash AND hang recovery.

    ``command_for_rank(rank, attempt) -> argv`` builds each worker's
    command line (``attempt`` increments per relaunch — lets the caller
    rotate coordinator ports or endpoints that linger in TIME_WAIT);
    workers are expected to resume from the latest checkpoint in their run
    dir on startup (the pattern ``tests/test_multiprocess.py`` pins).  Any
    worker exiting non-zero, dying, or going heartbeat-stale triggers a
    full gang kill + relaunch — SPMD jobs cannot run degraded; a missing
    rank wedges every collective on the survivors.
    """

    def __init__(
        self,
        command_for_rank: Callable[[int, int], Sequence[str]],
        num_processes: int,
        run_dir: str,
        heartbeat_timeout: float = 60.0,
        progress_timeout: Optional[float] = None,
        startup_timeout: Optional[float] = None,
        poll_interval: float = 0.5,
        max_restarts: int = 3,
        env: Optional[Dict[str, str]] = None,
    ):
        """``heartbeat_timeout``: no beat for this long => crashed-without-
        exit.  ``progress_timeout``: ``update(step)`` hasn't advanced for
        this long => wedged collective / stuck device (set it to a
        generous multiple of the expected step/chunk time; ``None``
        disables — exit codes and beats still apply).  ``startup_timeout``
        (default 600 s — workers legitimately spend minutes in imports,
        distributed init and first compiles before their first beat): a
        rank that never registered a heartbeat within this long of launch
        => hung during startup."""
        self.command_for_rank = command_for_rank
        self.num_processes = num_processes
        self.run_dir = run_dir
        self.heartbeat_timeout = heartbeat_timeout
        self.progress_timeout = progress_timeout
        self.startup_timeout = (
            600.0 if startup_timeout is None else startup_timeout
        )
        self.poll_interval = poll_interval
        self.max_restarts = max_restarts
        self.env = env
        self.restarts = 0
        self._launch_time = 0.0

    # -- gang management ----------------------------------------------------

    def _launch(self) -> List[subprocess.Popen]:
        clear_heartbeats(self.run_dir)
        self._launch_time = time.time()
        return [
            subprocess.Popen(
                list(self.command_for_rank(rank, self.restarts)),
                env=self.env,
                stdout=subprocess.DEVNULL if rank else None,
                stderr=subprocess.STDOUT if rank else None,
            )
            for rank in range(self.num_processes)
        ]

    @staticmethod
    def _kill_gang(procs: List[subprocess.Popen]) -> None:
        for p in procs:
            if p.poll() is None:
                # Exact-PID kill of processes THIS supervisor spawned.
                p.send_signal(signal.SIGKILL)
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass

    def _failure(self, procs: List[subprocess.Popen]) -> Optional[str]:
        """A reason string if the gang is unhealthy, else None."""
        for rank, p in enumerate(procs):
            code = p.poll()
            if code is not None and code != 0:
                return f"rank {rank} exited with code {code}"
        # Staleness/stall apply only to STILL-RUNNING ranks: a worker that
        # exited 0 legitimately stops beating.
        running = {r for r, p in enumerate(procs) if p.poll() is None}
        stale = [
            r
            for r in stale_processes(self.run_dir, self.heartbeat_timeout)
            if r in running
        ]
        if stale:
            return f"heartbeat timeout on process(es) {stale}"
        if self.progress_timeout is not None:
            stalled = [
                r
                for r in stalled_processes(
                    self.run_dir, self.progress_timeout
                )
                if r in running
            ]
            if stalled:
                return f"progress timeout on process(es) {stalled}"
        # A rank that never registered a beat at all (hung during
        # startup — e.g. stuck in distributed init) after the grace
        # period.
        if time.time() - self._launch_time > self.startup_timeout:
            seen = set(read_heartbeats(self.run_dir))
            missing = sorted(running - seen)
            if missing:
                return (
                    f"process(es) {missing} never registered a heartbeat "
                    f"within {self.startup_timeout}s of launch"
                )
        return None

    def run(self) -> int:
        """Supervise until the whole gang exits 0.  Returns the number of
        restarts performed.  Raises ``RuntimeError`` once ``max_restarts``
        is exhausted."""
        while True:
            procs = self._launch()
            reason = None
            while True:
                if all(p.poll() == 0 for p in procs):
                    return self.restarts
                reason = self._failure(procs)
                if reason is not None:
                    break
                time.sleep(self.poll_interval)
            self._kill_gang(procs)
            if self.restarts >= self.max_restarts:
                raise RuntimeError(
                    f"giving up after {self.restarts} restarts; "
                    f"last failure: {reason}"
                )
            self.restarts += 1
            logger.warning(
                "gang failure (%s); killed %d workers, restart %d/%d",
                reason,
                self.num_processes,
                self.restarts,
                self.max_restarts,
            )


def main(argv: Optional[Sequence[str]] = None) -> None:
    """CLI: ``python -m nerf_tpu_torch.parallel.watchdog --num-processes N
    --run-dir DIR -- worker.py args...`` — each worker gets its rank
    appended as ``--process-id <r>``."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--heartbeat-timeout", type=float, default=60.0)
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("worker", nargs=argparse.REMAINDER,
                    help="worker command (prefix with --)")
    args = ap.parse_args(argv)
    worker = list(args.worker)
    if worker and worker[0] == "--":
        worker = worker[1:]  # drop only the leading separator
    if not worker:
        ap.error("no worker command given")

    sup = Supervisor(
        lambda r, _a: [sys.executable, *worker, "--process-id", str(r)],
        args.num_processes,
        args.run_dir,
        heartbeat_timeout=args.heartbeat_timeout,
        max_restarts=args.max_restarts,
    )
    restarts = sup.run()
    print(f"completed with {restarts} restart(s)")


if __name__ == "__main__":
    main()
