"""Parallel layer: process groups, meshes (1-D data parallel, 2-D with a
sample or model axis), the data-, sample- and tensor-parallel steps and
renders, and the watchdog (heartbeats and the restarting supervisor)."""
from nerf_tpu_torch.parallel import distributed
from nerf_tpu_torch.parallel.distributed import (
    collective_barrier,
    host_local_slice,
    initialize,
    is_coordinator,
    shutdown,
)
from nerf_tpu_torch.parallel.mesh import (
    BATCH_AXIS,
    MODEL_AXIS,
    SAMPLE_AXIS,
    Mesh,
    make_mesh,
    make_mesh_2d,
    replicate,
    shard_batch,
)
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
from nerf_tpu_torch.parallel.sample_parallel import (
    make_sample_parallel_loss_and_grads,
    make_sample_parallel_render,
    make_sample_parallel_train_step,
)
from nerf_tpu_torch.parallel.tensor_parallel import (
    classic_param_specs,
    make_tp_loss_and_grads,
    make_tp_render_rays,
    make_tp_train_step,
    mip_param_specs,
    param_specs_for,
    prepare_tp_state,
    shard_params,
)
from nerf_tpu_torch.parallel.watchdog import (
    Heartbeat,
    Supervisor,
    clear_heartbeats,
    read_heartbeats,
    stale_processes,
    stalled_processes,
)
