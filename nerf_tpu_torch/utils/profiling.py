"""Analytic operation counts (counterpart of ``classic_flops_per_point``,
``mip_flops_per_point`` and ``train_step_flops`` in
``nerf_tpu/utils/profiling.py``), used for the kernels' bounds."""

from __future__ import annotations


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
