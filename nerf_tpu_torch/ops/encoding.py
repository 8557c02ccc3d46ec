"""Classic NeRF frequency encoding (the v1.2-generation encoder).

PyTorch counterpart of the classic half of ``nerf_tpu/ops/encoding.py``:
``bbox_frequency_scales``, ``frequency_scales_np`` and
``frequency_encoding``, with the same ``[sin(x*f_0..f_{L-1}),
cos(x*f_0..f_{L-1})]`` per-scalar feature layout.

The scale constants are computed here (``torch.linspace`` exponents in
float32, ``torch.pow``) and cached per ``(size, bound)``.  They agree with
the JAX package's constants to within 2 ulp at the sizes and bounds the
classic models use ((12 or 20) x (6.0 or 20.0)), but not bitwise: the JAX
values carry XLA's rounding of ``jnp.linspace``, which neither
``torch.linspace`` nor a float64 linspace reproduces.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

_SCALES_CACHE: Dict[Tuple[int, float], np.ndarray] = {}


def frequency_scales_np(size: int, bbox_max_abs: float) -> np.ndarray:
    """The cached float32 scale constants of the classic encoder as numpy.

    The lowest frequency is ``pi / (2 * bbox_max_abs)`` so the coarsest
    sinusoid spans the scene bounding box; the ``size // 2`` frequencies are
    octaves above it (``size`` counts sin+cos features per scalar).
    """
    key = (int(size), float(bbox_max_abs))
    if key not in _SCALES_CACHE:
        start = -math.log2(bbox_max_abs)
        exponents = torch.linspace(
            start, start + size / 2.0 - 1.0, size // 2, dtype=torch.float32
        )
        scales = torch.pow(2.0, exponents) * (math.pi / 2.0)
        _SCALES_CACHE[key] = scales.numpy()
    return _SCALES_CACHE[key]


def bbox_frequency_scales(
    size: int, bbox_max_abs: float, device="cuda"
) -> torch.Tensor:
    """Frequency scales ``[size // 2]`` (float32) on ``device``."""
    return torch.as_tensor(frequency_scales_np(size, bbox_max_abs), device=device)


def frequency_encoding(x: torch.Tensor, frequency_scales: torch.Tensor) -> torch.Tensor:
    """Classic per-scalar sin/cos frequency encoding.

    Each scalar of the last axis expands to ``[sin(x*f), cos(x*f)]`` over the
    ``L`` scales and the per-scalar blocks are concatenated: output width
    ``x.shape[-1] * 2 * L``.
    """
    xf = x[..., :, None] * frequency_scales  # [..., D, L]
    emb = torch.cat([torch.sin(xf), torch.cos(xf)], dim=-1)  # [..., D, 2L]
    return emb.reshape(emb.shape[:-2] + (-1,))
