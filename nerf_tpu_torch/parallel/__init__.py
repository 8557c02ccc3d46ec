"""Parallel layer: so far the watchdog (heartbeats and the restarting
supervisor); the meshes, the data-parallel step and sharded checkpoints
are not ported yet."""
from nerf_tpu_torch.parallel.watchdog import (
    Heartbeat,
    Supervisor,
    clear_heartbeats,
    read_heartbeats,
    stale_processes,
    stalled_processes,
)
