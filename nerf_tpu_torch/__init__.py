"""nerf_tpu_torch — the PyTorch/CUDA port of the nerf_tpu NeRF framework.

A second package beside the JAX reference ``nerf_tpu``, with the same module
and public function names.  The fused path (``use_pallas=True``) runs
hand-written CUDA kernels for Hopper (``csrc/``), built with ``nvcc`` at
first use; given CPU tensors the kernel wrappers run their plain PyTorch
versions.  This package imports neither JAX nor ``nerf_tpu``.
"""

from nerf_tpu_torch.config import (
    ClassicNeRFConfig,
    MeshConfig,
    MipNeRFConfig,
    RenderConfig,
    TrainConfig,
)
from nerf_tpu_torch.models.nerf import ClassicNeRF, RenderOutput

__version__ = "0.1.0"

__all__ = [
    "ClassicNeRF",
    "ClassicNeRFConfig",
    "MeshConfig",
    "MipNeRFConfig",
    "RenderConfig",
    "RenderOutput",
    "TrainConfig",
]
