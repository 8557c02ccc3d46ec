"""Profiling hooks and analytic operation counts (counterpart of
``nerf_tpu/utils/profiling.py``).

* ``trace(logdir)``: a context manager around ``torch.profiler`` that
  writes a Chrome/Perfetto trace of everything inside it into ``logdir``.
* ``step_timer``: a wall-clock timer that forces completion by fetching a
  value to the host.
* ``classic_flops_per_point``, ``mip_flops_per_point``,
  ``train_step_flops``: the matmul operation counts of a forward and of a
  train step (the JAX package's model: three forwards);
  ``input_cotangent_flops`` and ``train_kernel_flops``: those a training
  kernel runs, for the kernels' bounds.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str, create_perfetto_link: bool = False) -> Iterator[None]:
    """Profile the enclosed block (CPU activity, and CUDA kernels when a
    card is present) and write its trace to
    ``logdir/trace_<pid>_<ns>.pt.trace.json``, which Perfetto and
    ``chrome://tracing`` open.  There is no link server: with
    ``create_perfetto_link`` the file's path is printed."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        if create_perfetto_link:
            print(f"trace written to {path}; open it in Perfetto")


def _fetch(value) -> None:
    """Copy every tensor of ``value`` (nested dicts, lists, tuples) to the
    host, which waits for the work that produces it."""
    if torch.is_tensor(value):
        value.cpu()
    elif isinstance(value, dict):
        for v in value.values():
            _fetch(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _fetch(v)


class step_timer:
    """Wall-clock timer that syncs by fetching a value from the device."""

    def __init__(self):
        self.start: Optional[float] = None
        self.elapsed: Optional[float] = None

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def sync(self, value) -> float:
        """Fetch ``value`` (forcing completion) and record elapsed time."""
        _fetch(value)
        self.elapsed = time.perf_counter() - self.start
        return self.elapsed

    def __exit__(self, *exc):
        if self.elapsed is None:
            self.elapsed = time.perf_counter() - self.start
        return False


def classic_flops_per_point(cfg) -> int:
    """Matmul FLOPs for one point through the classic MLP (forward only)."""
    h = cfg.hidden_size
    xe, de = cfg.x_encoding_dim, cfg.d_encoding_dim
    n0, n1 = cfg.trunk_blocks
    flops = 2 * xe * h  # L0
    flops += 2 * h * h * (n0 - 1)
    flops += 2 * (h + xe) * h  # skip layer
    flops += 2 * h * h * (n1 - 1)
    flops += 2 * h * 1  # density head
    if cfg.use_viewdirs:
        flops += 2 * (h + de) * h
        flops += 2 * h * h * (cfg.view_branch_depth - 1)
    flops += 2 * h * cfg.color_outputs
    return flops


def mip_flops_per_point(cfg) -> int:
    """Matmul FLOPs for one point through the HEAD (mip) MLP (forward only)."""
    h = cfg.hidden_size
    flops = 2 * cfg.feature_dim * h
    flops += 2 * h * h * (cfg.num_hidden_layers - 1)
    flops += 2 * h * cfg.num_outputs
    return flops


def train_step_flops(cfg, num_rays: int, num_samples: int, mip: bool = False) -> int:
    """Forward plus backward (about twice the forward) matmul FLOPs of one
    train step over ``num_rays * num_samples`` MLP points."""
    per_point = mip_flops_per_point(cfg) if mip else classic_flops_per_point(cfg)
    return 3 * per_point * num_rays * num_samples


def input_cotangent_flops(cfg, mip: bool = False) -> int:
    """Matmul FLOPs of one point's cotangents of the MLP's inputs: the
    encodings' (layer 0's and the skip layer's x columns, the view layer's
    d columns) or the mip features' (the input layer's)."""
    h = cfg.hidden_size
    if mip:
        return 2 * cfg.feature_dim * h
    return 2 * 2 * cfg.x_encoding_dim * h + (2 * cfg.d_encoding_dim * h if cfg.use_viewdirs else 0)


def train_kernel_flops(cfg, num_rays: int, num_samples: int, mip: bool = False,
                       input_grads: bool = False) -> int:
    """Matmul FLOPs a training kernel runs over ``num_rays * num_samples``
    MLP points: the forward (kept or recomputed), the weights' gradients
    (as many) and the activations' cotangents (as many, less the inputs'
    cotangents, ``input_cotangent_flops``, unless ``input_grads``)."""
    per_point = 3 * (mip_flops_per_point(cfg) if mip else classic_flops_per_point(cfg))
    if not input_grads:
        per_point -= input_cotangent_flops(cfg, mip)
    return per_point * num_rays * num_samples
