"""Parallel layer: process groups, the data-parallel mesh, step and
render, and the watchdog (heartbeats and the restarting supervisor)."""
from nerf_tpu_torch.parallel import distributed
from nerf_tpu_torch.parallel.distributed import (
    collective_barrier,
    host_local_slice,
    initialize,
    is_coordinator,
    shutdown,
)
from nerf_tpu_torch.parallel.mesh import BATCH_AXIS, Mesh, make_mesh, replicate, shard_batch
from nerf_tpu_torch.parallel.train import (
    make_parallel_loss_and_grads,
    make_parallel_multi_step_train_fn,
    make_parallel_render,
    make_parallel_sampling_train_step,
    make_parallel_train_step,
    prepare_parallel_state,
    render_image_sharded,
    shard_draws,
)
from nerf_tpu_torch.parallel.watchdog import (
    Heartbeat,
    Supervisor,
    clear_heartbeats,
    read_heartbeats,
    stale_processes,
    stalled_processes,
)
